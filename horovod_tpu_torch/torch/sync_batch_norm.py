"""Cross-rank synchronized batch normalization for torch.

The port of the JAX package's ``horovod_tpu/torch/sync_batch_norm.py``
(reference ``horovod/torch/sync_batch_norm.py``): a ``_BatchNorm`` whose
training statistics cover the global batch -- every rank's count, sums
and squared sums (fp64) gathered through the runtime's allgather and
summed in rank order -- and whose backward gathers the two weight-gradient
reductions alike, so the gradients are the single-process math's. The
exchange runs on the input's device (NCCL for CUDA tensors). One
difference: it runs at every world size while training, one rank
included, where the JAX package falls back to the local BatchNorm at one.
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from . import mpi_ops


class SyncBatchNorm(_BatchNorm):
    """Drop-in for ``nn.BatchNorm*d`` with cross-rank statistics.

    Statistics sync across all ranks of the runtime's world; in eval
    mode this is exactly the local BatchNorm.
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True):
        super().__init__(num_features, eps, momentum, affine, track_running_stats)

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)"
            )

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if not (self.training and mpi_ops.is_initialized()):
            return super().forward(input)
        return _SyncBatchNormFunction.apply(
            input, self.weight, self.bias, self.running_mean, self.running_var,
            self.eps, self.momentum,
        )


def _sum_over_ranks(packed: torch.Tensor, name: str) -> torch.Tensor:
    """Every rank's ``packed`` row gathered, then summed in rank order."""
    rows = mpi_ops.allgather(packed.reshape(1, -1), name=name)
    total = rows[0]
    for r in range(1, rows.shape[0]):
        total = total + rows[r]
    return total


class _SyncBatchNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var, eps, momentum):
        reduce_dims = [0] + list(range(2, input.dim()))
        count = torch.tensor(
            [float(input.numel() // input.size(1))], dtype=torch.float64,
            device=input.device,
        )
        local_sum = input.double().sum(dim=reduce_dims)
        local_sqsum = (input.double() ** 2).sum(dim=reduce_dims)
        packed = torch.cat([count, local_sum, local_sqsum])
        packed = _sum_over_ranks(packed, "syncbn.stats")
        c = packed[0]
        n_feat = input.size(1)
        mean = (packed[1 : 1 + n_feat] / c).to(input.dtype)
        sqmean = (packed[1 + n_feat :] / c).to(input.dtype)
        var = sqmean - mean * mean
        invstd = torch.rsqrt(var + eps)

        if running_mean is not None:
            with torch.no_grad():
                unbiased = var * (c / max(c - 1.0, 1.0))
                running_mean.mul_(1 - momentum).add_(mean.to(running_mean.dtype), alpha=momentum)
                running_var.mul_(1 - momentum).add_(unbiased.to(running_var.dtype), alpha=momentum)

        shape = [1, n_feat] + [1] * (input.dim() - 2)
        xhat = (input - mean.view(shape)) * invstd.view(shape)
        out = xhat
        if weight is not None:
            out = out * weight.view(shape)
        if bias is not None:
            out = out + bias.view(shape)
        ctx.save_for_backward(xhat, weight, invstd, c.to(input.dtype))
        return out

    @staticmethod
    def backward(ctx, grad_output):
        xhat, weight, invstd, count = ctx.saved_tensors
        reduce_dims = [0] + list(range(2, grad_output.dim()))
        n_feat = grad_output.size(1)
        shape = [1, n_feat] + [1] * (grad_output.dim() - 2)

        # Local weight/bias grads — the DistributedOptimizer averages them
        # like any other parameter grad (reference leaves these local).
        grad_weight = (grad_output * xhat).sum(dim=reduce_dims)
        grad_bias = grad_output.sum(dim=reduce_dims)

        # Global reductions feeding grad_input: every rank needs the
        # worldwide sum_dy / sum_dy_xhat over the global batch.
        packed = torch.cat([grad_weight, grad_bias])
        packed = _sum_over_ranks(packed, "syncbn.grad")
        mean_dy_xhat = (packed[:n_feat] / count).view(shape)
        mean_dy = (packed[n_feat:] / count).view(shape)

        g = grad_output
        if weight is not None:
            g = g * weight.view(shape)
            mean_dy = mean_dy * weight.view(shape)
            mean_dy_xhat = mean_dy_xhat * weight.view(shape)
        grad_input = invstd.view(shape) * (g - mean_dy - xhat * mean_dy_xhat)

        return (
            grad_input,
            grad_weight if ctx.needs_input_grad[1] else None,
            grad_bias if ctx.needs_input_grad[2] else None,
            None, None, None, None,
        )
