"""The port's side of the parallelism tests, one function a gloo world
(``context.spawn_gloo`` runs it on each rank), and the seeded inputs both
sides share. It imports no JAX: every rank of a world imports this module,
and the JAX side runs in the test process
(``test_torch_port_parallel.py``, ``test_torch_port_parallel_
transformer.py``).
"""

import os

import numpy as np
import torch

from horovod_tpu_torch import context, convert
from horovod_tpu_torch.ops import diff_collectives as dc
from horovod_tpu_torch.ops.collectives import Average, Max, Sum
from horovod_tpu_torch.optimizer import AdamState, adamw
from horovod_tpu_torch.parallel import ep, hierarchical, pp, sp, tp
from horovod_tpu_torch.parallel import transformer as ttr

# Parallelism blocks on a world of 4.
WORLD = 4
RING_CASES = [(impl, causal, d) for impl in ("dense", "flash")
              for causal in (False, True) for d in (16, 64)]


def qkv(h, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((2, 32, h, d)).astype(np.float32)
            for _ in range(4)]  # q, k, v and the cotangent of the output


def shard(x, r, n=WORLD, axis=1):
    return np.split(x, n, axis=axis)[r]


def attention_grads(fn, q, k, v, cot, r):
    """This rank's output shard and its q/k/v gradients, from
    ``sum(fn(q, k, v) * cot)``; inputs are this rank's sequence shards."""
    qt, kt, vt = (torch.from_numpy(shard(x, r)).requires_grad_()
                  for x in (q, k, v))
    out = fn(qt, kt, vt)
    (out * torch.from_numpy(shard(cot, r))).sum().backward()
    return [t.detach().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]


def mlp_inputs():
    rs = np.random.RandomState(0)
    d_model, d_ff = 16, 64
    return dict(x=rs.standard_normal((4, d_model)),
                w_up=rs.standard_normal((d_model, d_ff)),
                b_up=rs.standard_normal((d_ff,)),
                w_down=rs.standard_normal((d_ff, d_model)) * 0.3,
                b_down=rs.standard_normal((d_model,)),
                cot=rs.standard_normal((4, d_model)))


def mlp_shards(a, t, n=2):
    return (shard(a["w_up"], t, n, 1), shard(a["b_up"], t, n, 0),
            shard(a["w_down"], t, n, 0))


def pipe_inputs():
    rs = np.random.RandomState(1)
    return dict(mb=rs.standard_normal((3, 2, 8)),
                w=rs.standard_normal((WORLD, 8, 8)) * 0.4,
                b=rs.standard_normal((WORLD, 8)) * 0.1,
                cot=rs.standard_normal((3, 2, 8)))


def stage(params, x):
    """One pipeline stage: ``tanh(x @ w + b)``."""
    w, b = params
    return (x @ w + b).tanh()


def moe_inputs(t=16, d=8, e_local=2):
    rs = np.random.RandomState(0)
    e_total = WORLD * e_local
    return dict(x=rs.randn(WORLD * t, d).astype(np.float32),
                gate=rs.randn(d, e_total).astype(np.float32),
                w=(rs.randn(e_total, d, d) * 0.3).astype(np.float32),
                gate1=rs.randn(d, WORLD).astype(np.float32))


def grid(shape, seed):
    x = np.random.RandomState(seed).standard_normal(shape)
    return (np.round(np.clip(x, -7, 7) * 64) / 64).astype(np.float32)


def f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def parallel_world():
    """One rank of the world of 4: every case, each under its mesh."""
    rank = int(os.environ["RANK"])
    out = {}
    context.init(device="cpu", mesh={"sp": WORLD})
    r = context.rank("sp")
    out["ring"] = {}
    for impl, causal, d in RING_CASES:
        q, k, v, cot = qkv(2, d, seed=d + causal)
        out["ring"][(impl, causal, d)] = attention_grads(
            lambda a, b, c: sp.ring_attention(
                a, b, c, axis="sp", causal=causal, use_flash=impl == "flash",
                block_q=8, block_k=8), q, k, v, cot, r)
    out["ulysses"] = {}
    for causal in (False, True):
        q, k, v, cot = qkv(8, 16, seed=7 + causal)
        out["ulysses"][causal] = attention_grads(
            lambda a, b, c: sp.ulysses_attention(a, b, c, axis="sp",
                                                 causal=causal),
            q, k, v, cot, r)

    # Differentiable collectives over the ring axis.
    rs = np.random.RandomState(50)
    xs, cs = rs.standard_normal((2, WORLD, 4, 8, 6)).astype(np.float32)
    x, c = torch.from_numpy(xs[r]).requires_grad_(), torch.from_numpy(cs[r])
    perm = [(i, (i + 1) % WORLD) for i in range(WORLD)]
    diff = {}
    for name, fn in (
            ("ppermute", lambda t: dc.ppermute(t, perm, axis="sp")),
            ("all_to_all", lambda t: dc.all_to_all(t, 0, 2, axis="sp")),
            ("copy_to", lambda t: dc.copy_to(t, "sp")),
            ("reduce_from", lambda t: dc.reduce_from(t, "sp"))):
        x.grad = None
        y = fn(x)
        cot = torch.from_numpy(a2a_cot(cs, r)) if name == "all_to_all" else c
        (y * cot).sum().backward()
        diff[name] = (y.detach().numpy(), x.grad.numpy().copy())
    out["diff"] = diff

    # Tensor parallelism on a dp 2 x tp 2 mesh.
    context.init(device="cpu", mesh={"dp": 2, "tp": 2})
    a = mlp_inputs()
    wu, bu, wd = (f32(s).requires_grad_()
                  for s in mlp_shards(a, context.rank("tp")))
    xt, bd = f32(a["x"]).requires_grad_(), f32(a["b_down"]).requires_grad_()
    y = tp.tp_mlp(xt, wu, bu, wd, bd, axis="tp")
    (y * f32(a["cot"])).sum().backward()
    out["tp_mlp"] = [y.detach().numpy()] + [
        t.grad.numpy() for t in (xt, wu, bu, wd, bd)]

    # Pipeline over 4 stages.
    context.init(device="cpu", mesh={"pp": WORLD})
    s = context.rank("pp")
    a = pipe_inputs()
    w, b = f32(a["w"][s]).requires_grad_(), f32(a["b"][s]).requires_grad_()
    mb = f32(a["mb"]).requires_grad_()
    y = pp.pipeline(stage, (w, b), mb, axis="pp")
    (y * f32(a["cot"])).sum().backward()
    out["pipeline"] = [y.detach().numpy(), w.grad.numpy(), b.grad.numpy(),
                       mb.grad.numpy()]

    # Expert parallelism over the world axis.
    context.init(device="cpu")
    a = moe_inputs()
    xs = torch.from_numpy(shard(a["x"], rank, axis=0))
    wl = torch.from_numpy(shard(a["w"], rank, axis=0))
    o, aux = ep.switch_moe_stacked(
        xs, torch.from_numpy(a["gate"]),
        lambda p, toks: torch.einsum("egd,edk->egk", toks.tanh(), p), wl,
        axis="hvd", capacity_factor=2.0)
    o1, aux1 = ep.switch_moe(
        xs, torch.from_numpy(a["gate1"]), lambda p, toks: toks * p,
        torch.tensor(rank + 1.0), axis="hvd", capacity_factor=8.0)
    out["moe"] = [o.numpy(), float(aux), o1.numpy(), float(aux1)]

    # The hierarchical all-reduce on the (cross, local) world.
    os.environ.update(LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(rank % 2))
    context.init(device="cpu", hierarchical=True)
    f = torch.from_numpy(grid((13,), 70 + rank))
    i = torch.from_numpy(np.arange(5, dtype=np.int32) * 3 + rank)
    out["hier"] = {
        (op_name, kind): hierarchical.hierarchical_allreduce(x, op=op).numpy()
        for op_name, op in (("sum", Sum), ("average", Average))
        for kind, x in (("f32", f), ("i32", i))}
    try:
        hierarchical.hierarchical_allreduce(f, op=Max)
    except ValueError:
        out["hier_max_raises"] = True
    return out


def a2a_cot(cs, r):
    """A cotangent for rank ``r``'s all_to_all(x, 0, 2) output ``[1, 8,
    24]``, made from its own ``[4, 8, 6]`` slice of ``cs``."""
    return np.ascontiguousarray(cs[r].transpose(1, 0, 2).reshape(1, 8, 24))


def a2a(xs):
    """all_to_all(x, split 0, concat 2) of every rank's ``[4, 8, 6]``,
    tiled: rank r receives chunk r of each source, concatenated on dim 2
    in source order."""
    return [np.concatenate([xs[src][r:r + 1] for src in range(WORLD)], 2)
            for r in range(WORLD)]

# The 3-D GPT: tests/test_parallel_transformer.py's configuration.
BASE = dict(vocab_size=64, max_len=64, d_model=32, n_heads=4, n_layers=2,
            d_ff=64, remat=False)
LEAVES = ("wte", "wpe", "ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
          "ln2_scale", "ln2_bias", "lnf_scale", "lnf_bias", "w_up", "b_up",
          "w_down", "b_down")
TP_SHARDED = ("wq", "wk", "wv", "wo", "w_up", "b_up", "w_down")
MESH = {"dp": 2, "sp": 2, "tp": 2}
LR = 1e-3


def tcfg(**kw):
    return ttr.ParallelGPTConfig(**{**BASE, "dtype": torch.float32, **kw})


def token_batch(seed):
    return np.random.RandomState(seed).randint(0, 64, (4, 32)).astype(
        np.int64)


def block(tokens, dp, sp, n_dp, n_sp):
    b, s = tokens.shape[0] // n_dp, tokens.shape[1] // n_sp
    return tokens[dp * b:(dp + 1) * b, sp * s:(sp + 1) * s]


def slice_shard(x, spec, coords, sizes):
    """The shard of ``x`` at mesh ``coords`` along ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            x = np.split(x, sizes[ax], axis=dim)[coords[ax]]
    return x


def to_np(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def gpt_world(np_params, tokens, full_state):
    """One rank of the world of 8: forward, loss, reduced gradients, and
    shard_state of the one-device run's state with one step from it."""
    context.init(device="cpu", mesh=MESH, world_axes=("dp", "sp"))
    cfg = tcfg()
    coords = {a: context.rank(a) for a in MESH}
    shards = ttr.shard_params(
        convert.parallel_gpt_params_from_jax(np_params, device="cpu"), cfg,
        device="cpu")
    tok = torch.from_numpy(block(tokens, coords["dp"], coords["sp"], 2, 2))
    with torch.no_grad():
        logits = ttr.forward(shards, tok, cfg)
    loss, grads = ttr.loss_and_grads(shards, tok, cfg)
    # Restore the one-device run's state onto this mesh and step it.
    opt = adamw(LR)
    params, count, mu, nu, tokens_run = full_state
    state = AdamState(torch.tensor(count, dtype=torch.int32),
                      {k: torch.from_numpy(v) for k, v in mu.items()},
                      {k: torch.from_numpy(v) for k, v in nu.items()})
    p4, s4 = ttr.shard_state(cfg, None, {k: torch.from_numpy(v) for k, v in
                                         params.items()}, state,
                             device="cpu")
    resharded = (to_np(p4), int(s4.count), to_np(s4.mu), to_np(s4.nu))
    step = ttr.make_parallel_train_step(cfg, opt, device="cpu")
    _, _, loss4 = step(p4, s4, torch.from_numpy(
        block(tokens_run, coords["dp"], coords["sp"], 2, 2)))
    return dict(coords=coords, logits=logits.numpy(), loss=float(loss),
                grads=to_np(grads), resharded=resharded, loss4=float(loss4))


def moe_world(np_params, tokens):
    context.init(device="cpu", mesh={"dp": 2, "sp": 1, "tp": 2},
                 world_axes=("dp", "sp"))
    cfg = tcfg(moe_experts=4)
    shards = ttr.shard_params(
        convert.parallel_gpt_params_from_jax(np_params, device="cpu"), cfg,
        device="cpu")
    tok = torch.from_numpy(block(tokens, context.rank("dp"), 0, 2, 1))
    with torch.no_grad():
        return float(ttr.loss_fn(shards, tok, cfg))
