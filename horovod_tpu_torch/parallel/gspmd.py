"""GSPMD partitioning rules as DTensor placements.

The port of the JAX package's ``parallel/gspmd.py``: name-based sharding
rules for a transformer's parameters (the pjit face of the framework,
where the explicit collectives of :mod:`.tp` are the Horovod face). There
the XLA partitioner inserts the collectives; here each parameter becomes a
``torch.distributed.tensor.DTensor`` on a ``DeviceMesh`` and DTensor's
sharding propagation inserts them.

The rules are Megatron's, as in the reference: the attention's query, key
and value and the MLP's first ``Dense`` are column-parallel (their output
dimension, the heads, on ``tp``), ``attn.out`` and the MLP's second
``Dense`` row-parallel (their input dimension on ``tp``), so a block
needs exactly two all-reduces, and everything else is replicated, or with
``fsdp_axis`` sharded on the dimension the reference's ``P(fsdp, ...)``
shards. Three layout facts of the port shape them:

* a ``Dense`` weight is ``[out, in]`` where flax keeps ``[in, out]``:
  column-parallel is ``Shard(0)`` here, row-parallel ``Shard(1)``, and
  the fsdp dimension of a ``Dense`` weight (flax's dim 0, ``in``) is 1;
* the attention fuses query, key and value into one ``attn.qkv``
  (``[3*H*dh, D]``). Its placement views it as ``[3, H*dh, D]`` (the bias
  as ``[3, H*dh]``) sharded on dim 1, so every tp rank holds ``H/tp``
  heads of each of q, k and v -- a plain ``Shard(0)`` would hand rank 0
  all of the query;
* DTensor has no sharding rule for the port's attention kernels. The
  attention (``models.transformer.MultiHeadAttention``) takes the local
  heads of its head-sharded projection, runs ``flash_attention`` (or the
  plain version) on them, re-enters with ``DTensor.from_local(...,
  Shard(-1))``, and the row-parallel ``out`` product leaves a ``Partial``
  that DTensor all-reduces. Every row-parallel ``Dense`` (``attn.out``,
  ``mlp.proj``) all-reduces its ``Partial`` output to ``Replicate`` right
  away, as a Megatron row-parallel layer does (a forward hook
  :func:`shard_params` installs): left ``Partial``, the residual add and
  the LayerNorm after it would take it in, and DTensor would reduce there
  instead, more than once a block.

A sharded module's output is a DTensor (the logits replicated):
``model(tokens).full_tensor()`` is the plain tensor, differentiable.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

__all__ = [
    "ParamSpec",
    "shard_params",
    "transformer_param_specs",
]


class ParamSpec(NamedTuple):
    """The port's ``PartitionSpec`` of one parameter: ``dims`` pairs a mesh
    axis name with the tensor dimension it shards (the rest replicate);
    ``fused`` > 1 views the parameter as ``[fused, rows / fused, ...]``
    first (the fused query/key/value: 3), and ``dims`` index that view."""

    dims: Tuple[Tuple[str, int], ...] = ()
    fused: int = 1

    def placements(self, mesh):
        """The DTensor placements on ``mesh`` (one a mesh dimension)."""
        from torch.distributed.tensor import Replicate, Shard

        names = mesh.mesh_dim_names or ()
        dims = dict(self.dims)
        for axis in dims:
            if axis not in names:
                raise ValueError(
                    f"mesh axes {names} have no {axis!r} for spec {self}")
        return [Shard(dims[n]) if n in dims else Replicate() for n in names]

    def view(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in the layout the placements index."""
        if self.fused == 1:
            return t
        return t.reshape(self.fused, -1, *t.shape[1:])


def _dense_names(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> the role of its module's ``Dense`` (the 2-D
    parameters of a ``Dense``: its weight and its fp8 residuals)."""
    from ..models.transformer import Dense

    out = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, Dense):
            for pname, _ in mod.named_parameters():
                out[f"{mname}.{pname}" if mname else pname] = mname
    return out


def _spec_for(name: str, p: torch.Tensor, dense: Optional[str],
              tp: str, fsdp: Optional[str]) -> ParamSpec:
    leaf = name.rsplit(".", 1)[-1]
    mod = dense or ""
    # Column-parallel: the output (head) dimension on tp.
    if mod.endswith("attn.qkv") and leaf in ("weight", "bias"):
        return ParamSpec(((tp, 1),), fused=3)
    if mod.endswith("mlp.fc") and leaf in ("weight", "bias"):
        return ParamSpec(((tp, 0),))
    # Row-parallel: the input dimension on tp; the bias replicates.
    if mod.endswith(("attn.out", "mlp.proj")) and leaf == "weight":
        return ParamSpec(((tp, 1),))
    # Everything else: replicated, or fsdp-sharded on the dimension holding
    # flax's dim 0 -- a Dense weight's input dimension, 1 here.
    if fsdp and p.dim() >= 2:
        return ParamSpec(((fsdp, 1 if dense is not None else 0),))
    return ParamSpec()


def transformer_param_specs(model: nn.Module, *, tp_axis: str = "tp",
                            fsdp_axis: Optional[str] = None
                            ) -> Dict[str, ParamSpec]:
    """``{name: ParamSpec}`` over ``model.named_parameters()`` for a model
    of the ``models.transformer`` family (GPT-2, BERT, ViT blocks); see the
    module docstring for the rules."""
    dense = _dense_names(model)
    return {
        name: _spec_for(name, p, dense.get(name), tp_axis, fsdp_axis)
        for name, p in model.named_parameters()
    }


def shard_params(model: nn.Module, mesh, specs=None, **kw) -> nn.Module:
    """Put every parameter of ``model`` onto ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh`` with named dimensions) with
    ``distribute_tensor`` and the given (or derived, ``**kw`` to
    :func:`transformer_param_specs`) specs, in place; returns ``model``. A
    fused projection's parameter keeps its name and holds its view (the
    QKV weight ``[3, H*dh, D]``)."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.transformer import Dense

    if specs is None:
        specs = transformer_param_specs(model, **kw)
    for mname, mod in model.named_modules():
        spec = specs.get(f"{mname}.weight")
        if isinstance(mod, Dense) and spec is not None and any(
                dim == 1 for _, dim in spec.dims) and spec.fused == 1:
            mod.register_forward_hook(_replicate_partial)
    for name, p in list(model.named_parameters()):
        spec = specs[name]
        owner, leaf = model, name
        if "." in name:
            mname, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(mname)
        dt = distribute_tensor(spec.view(p.detach()), mesh,
                               spec.placements(mesh))
        owner._parameters[leaf] = nn.Parameter(
            dt, requires_grad=p.requires_grad)
    return model


def _replicate_partial(module, inputs, out):
    """A row-parallel layer's ``Partial`` output, all-reduced."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if isinstance(out, DTensor) and any(
            isinstance(p, Partial) for p in out.placements):
        return out.redistribute(out.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in out.placements])
    return out
