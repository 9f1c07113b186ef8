"""The explicitly parallel GPT: a dp x sp x tp (x ep) training step -- the
port of the JAX package's ``parallel/transformer.py``.

One process a rank of a named mesh (:mod:`.mesh`, built by
``init(mesh={"dp": ..., "sp": ..., "tp": ...}, world_axes=("dp", "sp"))``):

* ``dp``: the batch is sharded; the gradients of the dense leaves are
  summed over ``(dp, sp)`` by one :func:`..ops.fusion.fused_allreduce`.
* ``sp``: the sequence is sharded; attention is :func:`.sp.ring_attention`
  (the dense ring, as the reference's GPT runs it), and the loss fetches
  each shard's next label from its successor (a ``ppermute`` halo).
* ``tp``: Megatron tensor parallelism. The attention heads and the MLP's
  hidden units are sharded; the normed input of the attention projections
  and of the MLP's up-projection goes through
  :func:`..ops.diff_collectives.copy_to`, the out and down projections
  through :func:`..ops.diff_collectives.reduce_from`.
* ``ep`` (``moe_experts > 0``): every FFN is a top-1 Switch MoE
  (:func:`.ep.switch_moe_stacked`) with its experts sharded over ``dp``;
  the expert gradients come back whole through the all-to-all's backward
  and are summed over ``sp`` only.

The loss's sum and count are reduced over ``(dp, sp)`` with
:func:`..ops.diff_collectives.reduce_from`, so every rank holds the global
loss and keeps its own share of the gradient: after the step's Sum over
``(dp, sp)`` every gradient is the dense one, the tp-sharded leaves' shards
complete and the replicated leaves' equal on every tp rank -- the contract
the JAX package's docstring states. Its ``psum`` transposes to a ``psum``
under ``shard_map(check_vma=False)``, which scales its gradients by the
axis sizes; ROADMAP C9 gives the factors.

Parameters are a flat dict of tensors in the reference's layout, layer
dims stacked on axis 0 (:func:`init_params`; the reference's own weights
through :func:`..convert.parallel_gpt_params_from_jax`), sharded by
:func:`shard_params` along :func:`param_specs`. Each block runs under
:func:`..ops.remat.checkpoint_fn` with ``cfg.remat``. Master weights are
fp32 and cast to ``cfg.dtype`` at each use; the logits are fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import context as _context
from ..ops import collectives as _coll
from ..ops.collectives import Sum
from ..ops.diff_collectives import copy_to, pmean, reduce_from
from ..ops.fusion import fused_allreduce
from ..ops.remat import checkpoint_fn
from .ep import switch_moe_stacked
from .sp import ring_attention
from .tp import column_parallel, row_parallel

__all__ = [
    "ParallelGPTConfig",
    "forward",
    "forward_with_aux",
    "init_params",
    "loss_and_grads",
    "loss_fn",
    "make_parallel_train_step",
    "param_specs",
    "shard_init",
    "shard_params",
    "shard_state",
]

# The leaves that are not stacked per layer.
_GLOBAL_KEYS = ("wte", "wpe", "lnf_scale", "lnf_bias")


@dataclasses.dataclass(frozen=True)
class ParallelGPTConfig:
    vocab_size: int = 512
    max_len: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    dtype: torch.dtype = torch.bfloat16  # compute dtype; masters are fp32
    # Per-block remat (ops/remat.resolve_policy): False/'none', True/'full',
    # a named policy or a selective-checkpoint policy callable.
    remat: Any = True
    dp_axis: str = "dp"
    sp_axis: str = "sp"
    tp_axis: str = "tp"
    # > 0: every FFN is a top-1 MoE with this many experts sharded over dp.
    moe_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ep_axis(self) -> str:
        return self.dp_axis


def init_params(cfg: ParallelGPTConfig,
                generator: Optional[torch.Generator] = None, *,
                device=None) -> Dict[str, torch.Tensor]:
    """The full (unsharded) fp32 parameters, layer dims stacked on axis 0,
    in the reference's names and shapes: weights normal(0, 0.02) drawn
    from ``generator`` in the reference's key order, LayerNorm scales 1,
    biases 0. On ``device`` (default: this process's card)."""
    device = _context.resolve_device(device)
    gen_device = generator.device if generator is not None else "cpu"

    def init(*shape):
        return (torch.randn(shape, generator=generator, device=gen_device)
                * 0.02).to(device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    L, D, H, hd, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
                       cfg.d_ff)
    params = {
        "wte": init(cfg.vocab_size, D),
        "wpe": init(cfg.max_len, D),
        "ln1_scale": ones(L, D),
        "ln1_bias": zeros(L, D),
        "wq": init(L, D, H, hd),
        "wk": init(L, D, H, hd),
        "wv": init(L, D, H, hd),
        "wo": init(L, H, hd, D),
        "ln2_scale": ones(L, D),
        "ln2_bias": zeros(L, D),
        "lnf_scale": ones(D),
        "lnf_bias": zeros(D),
    }
    if cfg.moe_experts:
        E = cfg.moe_experts
        params.update(gate=init(L, D, E), moe_up=init(L, E, D, Fd),
                      moe_down=init(L, E, Fd, D))
    else:
        params.update(w_up=init(L, D, Fd), b_up=zeros(L, Fd),
                      w_down=init(L, Fd, D), b_down=zeros(L, D))
    return params


def param_specs(cfg: ParallelGPTConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each leaf's shard dims, as a ``PartitionSpec`` lists them: the mesh
    axis each leading dim is sharded over (None: replicated). Heads and
    ``d_ff`` over ``tp``, experts over ``ep`` (= ``dp``), the rest
    replicated (an empty spec)."""
    tp = cfg.tp_axis
    specs = {
        "wte": (), "wpe": (), "ln1_scale": (), "ln1_bias": (),
        "wq": (None, None, tp, None),
        "wk": (None, None, tp, None),
        "wv": (None, None, tp, None),
        "wo": (None, tp, None, None),
        "ln2_scale": (), "ln2_bias": (), "lnf_scale": (), "lnf_bias": (),
    }
    if cfg.moe_experts:
        ep = cfg.ep_axis
        specs.update(gate=(), moe_up=(None, ep, None, tp),
                     moe_down=(None, ep, tp, None))
    else:
        specs.update(w_up=(None, None, tp), b_up=(None, tp),
                     w_down=(None, tp, None), b_down=())
    return specs


def _mesh(mesh):
    return _context.mesh() if mesh is None else mesh


def _shard(t: torch.Tensor, spec, mesh, device) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.axis_size(ax)
        if t.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of a {tuple(t.shape)} leaf does not divide over "
                f"{ax} = {n}")
        t = t.chunk(n, dim)[mesh.axis_index(ax)]
    return t.to(device).contiguous().clone()


def _shard_tree(tree, specs, mesh, device, spec=()):
    """Every tensor of a nest sharded along the spec of the parameter name
    that keys it -- the optimizer's moments inherit their parameter's, as
    the reference derives its opt-state specs by path; the rest (a step
    count) replicated."""
    if isinstance(tree, dict):
        return {k: _shard_tree(v, specs, mesh, device, specs.get(k, spec))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_shard_tree(v, specs, mesh, device, spec)
                            for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shard_tree(v, specs, mesh, device, spec)
                          for v in tree)
    if isinstance(tree, torch.Tensor):
        return _shard(tree, spec, mesh, device)
    return tree


def shard_params(full: Dict[str, torch.Tensor], cfg: ParallelGPTConfig,
                 mesh=None, *, device=None) -> Dict[str, torch.Tensor]:
    """This rank's shards of the full parameters (new tensors on
    ``device``, default this process's card), along :func:`param_specs`
    and this process's coordinates in ``mesh`` (default: the world's)."""
    return _shard_tree(full, param_specs(cfg), _mesh(mesh),
                       _context.resolve_device(device))


def shard_init(cfg: ParallelGPTConfig, mesh, generator, optimizer, *,
               device=None):
    """This rank's parameter shards of :func:`init_params` and the
    optimizer state initialized on them."""
    device = _context.resolve_device(device)
    params = shard_params(init_params(cfg, generator, device=device), cfg,
                          mesh, device=device)
    return params, optimizer.init(params)


def shard_state(cfg: ParallelGPTConfig, mesh, params, opt_state, *,
                device=None):
    """Re-shard full (unsharded) parameters and optimizer state -- a host
    snapshot -- onto ``mesh`` for this rank, moments kept: the restore
    onto a new mesh after a world-size change. The state's moments are
    sharded as the parameters they follow (the reference's ``optimizer``
    argument, which names the state's structure there, is not needed)."""
    args = (param_specs(cfg), _mesh(mesh), _context.resolve_device(device))
    return _shard_tree(params, *args), _shard_tree(opt_state, *args)


def _ln(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _ffn_dense(h, lp, cfg):
    dt, tp = cfg.dtype, cfg.tp_axis
    up = _gelu(column_parallel(h, lp["w_up"].to(dt), lp["b_up"].to(dt),
                               axis=tp))
    down = row_parallel(up, lp["w_down"].to(dt), axis=tp,
                        bias=lp["b_down"].to(dt))
    return down, torch.zeros((), dtype=torch.float32, device=h.device)


def _ffn_moe(h, lp, cfg):
    dt, tp = cfg.dtype, cfg.tp_axis
    b, s, d = h.shape

    def expert_fn(ep_params, toks):
        # toks [e_local, G, D], replicated over tp; column-parallel up (F
        # sharded over tp), row-parallel down.
        up_w, down_w = ep_params
        hh = _gelu(torch.einsum("egd,edf->egf", copy_to(toks, tp),
                                up_w.to(dt)))
        return reduce_from(torch.einsum("egf,efd->egd", hh, down_w.to(dt)),
                           tp)

    out, aux = switch_moe_stacked(
        h.reshape(b * s, d), lp["gate"], expert_fn,
        (lp["moe_up"], lp["moe_down"]), axis=cfg.ep_axis,
        capacity_factor=cfg.capacity_factor)
    return out.reshape(b, s, d), aux


def _block(x, aux, lp, cfg):
    dt, tp = cfg.dtype, cfg.tp_axis
    h = copy_to(_ln(x, lp["ln1_scale"], lp["ln1_bias"]), tp)
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"].to(dt))
    a = ring_attention(q, k, v, axis=cfg.sp_axis, causal=True)
    # Row-parallel out projection: this rank's heads' partial sum.
    x = x + reduce_from(torch.einsum("bshk,hkd->bsd", a, lp["wo"].to(dt)),
                        tp)
    h = _ln(x, lp["ln2_scale"], lp["ln2_bias"])
    ff, aux_l = (_ffn_moe if cfg.moe_experts else _ffn_dense)(h, lp, cfg)
    return x + ff, aux + aux_l


def forward_with_aux(params, tokens: torch.Tensor, cfg: ParallelGPTConfig):
    """This rank's forward: ``tokens`` ``[B_local, S_local]`` (batch
    sharded over dp, sequence over sp), ``params`` this rank's shards.
    Returns ``(fp32 logits [B_local, S_local, vocab], aux_loss)``, the aux
    loss summed over the MoE layers (0 for a dense config)."""
    b, s = tokens.shape
    dt = cfg.dtype
    pos = _coll.world_rank(cfg.sp_axis) * s + torch.arange(
        s, device=tokens.device)
    x = params["wte"].to(dt)[tokens] + params["wpe"].to(dt)[pos]

    def block(x, aux, lp):
        return _block(x, aux, lp, cfg)

    blk = checkpoint_fn(block, cfg.remat)
    layers = {k: v for k, v in params.items() if k not in _GLOBAL_KEYS}
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        x, aux = blk(x, aux, {k: v[i] for k, v in layers.items()})
    x = _ln(x, params["lnf_scale"], params["lnf_bias"])
    logits = x.float() @ params["wte"].t().float()
    return logits, aux


def forward(params, tokens: torch.Tensor, cfg: ParallelGPTConfig):
    """The logits of :func:`forward_with_aux`."""
    return forward_with_aux(params, tokens, cfg)[0]


def loss_fn(params, tokens: torch.Tensor, cfg: ParallelGPTConfig):
    """Next-token cross-entropy, exact across the sp sharding: each shard
    fetches its successor's first token (the halo, one ``ppermute``); the
    last global position is masked. The sum and count are reduced over
    ``(dp, sp)`` with ``reduce_from``, so every rank returns the global
    mean and keeps its own share of the gradient. A MoE config adds the aux
    loss (already averaged over ep = dp) averaged over sp."""
    sp = cfg.sp_axis
    n_sp, r_sp = _coll.world_size(sp), _coll.world_rank(sp)
    b, s = tokens.shape
    logits, aux = forward_with_aux(params, tokens, cfg)
    nxt = _coll.ppermute(tokens[:, :1].contiguous(),
                         [(i, (i - 1) % n_sp) for i in range(n_sp)], axis=sp)
    labels = torch.cat([tokens[:, 1:], nxt], dim=1)
    pos = r_sp * s + torch.arange(s, device=tokens.device)
    valid = (pos < n_sp * s - 1).float()[None, :]
    ce = F.cross_entropy(logits.reshape(b * s, -1), labels.reshape(-1),
                         reduction="none").reshape(b, s)
    local = torch.stack([(ce * valid).sum(), valid.sum() * b])
    total = reduce_from(local, (cfg.dp_axis, sp))
    loss = total[0] / total[1]
    if cfg.moe_experts:
        loss = loss + cfg.aux_loss_weight * pmean(aux, sp)
    return loss


def loss_and_grads(params, tokens: torch.Tensor, cfg: ParallelGPTConfig):
    """``(loss, grads)`` of :func:`loss_fn` on this rank's shards, the
    gradients reduced as the step reduces them: the dense leaves summed
    over ``(dp, sp)`` in one :func:`..ops.fusion.fused_allreduce`, the
    expert leaves (sharded over ep = dp, whole from the all-to-all's
    backward) over ``sp`` only. Each is the dense gradient's shard."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, tokens, cfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    specs = param_specs(cfg)
    moe = [k for k in grads if cfg.ep_axis in specs[k]]
    reduced = fused_allreduce({k: g for k, g in grads.items() if k not in moe},
                              op=Sum, axis=(cfg.dp_axis, cfg.sp_axis))
    if moe:
        reduced.update(fused_allreduce({k: grads[k] for k in moe}, op=Sum,
                                       axis=(cfg.sp_axis,)))
    return loss.detach(), {k: reduced[k] for k in params}


def make_parallel_train_step(cfg: ParallelGPTConfig, optimizer, *,
                             device=None):
    """The 3-D train step ``step(params, opt_state, tokens) -> (params,
    opt_state, loss)`` on this rank's shards: :func:`loss_and_grads`, the
    optimizer's update (an optax-shaped :class:`~..optimizer.Optimizer`,
    e.g. ``adamw``) on the shards, applied to ``params`` in place.

    The step runs on the world's mesh (``init(mesh=..., world_axes=(dp,
    sp))``; the reference's ``mesh`` argument is not taken), which must
    have the ``(dp, sp)`` group; ``tokens`` is this rank's ``[B_local,
    S_local]`` block, moved to ``device`` (default: this process's
    card)."""
    device = _context.resolve_device(device)
    _context.mesh().group((cfg.dp_axis, cfg.sp_axis))  # unbuilt: raises

    def step(params, opt_state, tokens):
        loss, grads = loss_and_grads(params, tokens.to(device), cfg)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            for k, u in updates.items():
                params[k].add_(u)
        return params, opt_state, loss

    return step
