"""Worlds of the dynamic-enqueue runtime's parity tests.

``tests/test_torch_port_native.py`` and ``test_torch_port_torch_api.py``
run the same cases on the port's runtime and frontend
(:mod:`horovod_tpu_torch.native`, :mod:`horovod_tpu_torch.torch`) and on
the JAX package's (``horovod_tpu.native``, ``horovod_tpu.torch``), each
world a set of worker processes started here, each rank running a whole
suite of cases in one world and writing its results to a file. This
module imports no JAX and nothing of the JAX package at import time: a
port rank imports torch alone; a reference rank imports the JAX package
when it starts (:func:`_rank_main`).

Run a rank by hand: ``python tests/torch_eager_ranks.py SIDE SUITE RANK
SIZE PORT OUT`` (``SIDE`` ``port`` or ``ref``).
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SUM, AVERAGE, MIN, MAX, PRODUCT, ADASUM = range(6)
FUSION_THRESHOLD = 512 * 1024  # multi-bucket partitions in the join case


def _rng(rank, salt):
    return np.random.default_rng(1000 * salt + rank)


# ---------------------------------------------------------------------------
# The runtime's API as numpy in, numpy out, for both sides.
# ---------------------------------------------------------------------------


class PortNative:
    """The port's runtime behind the JAX package's numpy surface."""

    def __init__(self):
        import torch

        from horovod_tpu_torch import native

        self.torch, self.n = torch, native
        self._live = {}

    def _t(self, x):
        return self.torch.from_numpy(np.ascontiguousarray(x))

    def allreduce_async(self, name, x, op=SUM, prescale=1.0, postscale=1.0,
                        group_name="", group_size=0):
        t = self._t(x)
        h = self.n.allreduce_async(name, t, op=op, prescale=prescale,
                                   postscale=postscale,
                                   group_name=group_name,
                                   group_size=group_size)
        self._live[h] = t
        return h

    def synchronize(self, h):
        self._live.pop(h, None)
        return self.n.synchronize(h).numpy()

    def allreduce(self, x, op=SUM, name="allreduce", **kw):
        return self.synchronize(self.allreduce_async(name, x, op, **kw))

    def allgather(self, x, name="allgather"):
        return self.n.allgather(self._t(x), name=name).numpy()

    def broadcast(self, x, root_rank=0, name="broadcast"):
        return self.n.broadcast(self._t(x), root_rank, name=name).numpy()

    def alltoall(self, x, splits=None, name="alltoall"):
        out, sp = self.n.alltoall(self._t(x), splits, name=name)
        return out.numpy(), sp.numpy()

    def reducescatter(self, x, op=SUM, name="reducescatter"):
        return self.n.reducescatter(self._t(x), op=op, name=name).numpy()

    def join(self):
        return self.n.join()

    def barrier(self):
        self.n.barrier()

    def counters(self):
        return self.n.metrics_counters()

    def package_join(self):
        import horovod_tpu_torch as hvt

        return hvt.join()


class RefNative:
    """The JAX package's runtime (its own numpy surface)."""

    def __init__(self):
        from horovod_tpu import native

        self.n = native

    def __getattr__(self, name):
        return getattr(self.n, name)

    def counters(self):
        return self.n.metrics_counters()

    def package_join(self):
        import horovod_tpu as hvd

        return hvd.join()


def _error(fn):
    try:
        fn()
    except Exception as e:  # the case records the message it raised
        return str(e)
    return "no error"


# ---------------------------------------------------------------------------
# Runtime cases: fn(nv, rank, size) -> {key: value}
# ---------------------------------------------------------------------------


def c_collectives(nv, rank, size):
    """``test_collectives_4ranks`` and every op on one tensor."""
    x = np.full((4,), float(rank + 1), np.float32)
    return {op: nv.allreduce(x, op=code, name=f"c.{op}")
            for op, code in (("sum", SUM), ("avg", AVERAGE), ("min", MIN),
                             ("max", MAX), ("prod", PRODUCT))}


def c_random_fp32(nv, rank, size):
    """Seeded fp32 values: Sum, Average, prescale and postscale."""
    x = _rng(rank, 1).standard_normal(1000).astype(np.float32)
    return {
        "sum": nv.allreduce(x, name="r.sum"),
        "avg": nv.allreduce(x, op=AVERAGE, name="r.avg"),
        "scaled": nv.allreduce(x, name="r.scaled", prescale=0.5,
                               postscale=1.0 / 3.0),
        "f64": nv.allreduce(x.astype(np.float64), op=AVERAGE,
                            name="r.f64"),
    }


def c_fp16(nv, rank, size):
    x = (_rng(rank, 2).standard_normal(257) * 4).astype(np.float16)
    return {"sum": nv.allreduce(x, name="h.sum"),
            "max": nv.allreduce(x, op=MAX, name="h.max"),
            "scaled": nv.allreduce(x, name="h.scaled", postscale=0.25)}


def c_ints(nv, rank, size):
    """Integers are exact: sums, floor averages of non-negative values,
    products, min/max, and scales truncated toward zero."""
    out = {}
    for dt in (np.int32, np.int64, np.uint8, np.int8, np.int16):
        x = _rng(rank, 3).integers(0, 9, 64).astype(dt)
        k = np.dtype(dt).name
        out[f"{k}.sum"] = nv.allreduce(x, name=f"i.{k}.sum")
        out[f"{k}.avg"] = nv.allreduce(x, op=AVERAGE, name=f"i.{k}.avg")
        out[f"{k}.min"] = nv.allreduce(x, op=MIN, name=f"i.{k}.min")
        out[f"{k}.scaled"] = nv.allreduce(x, name=f"i.{k}.sc",
                                          postscale=0.3)
    b = _rng(rank, 4).integers(0, 2, 32).astype(np.bool_)
    out["bool.sum"] = nv.allreduce(b, name="b.sum")
    out["bool.min"] = nv.allreduce(b, op=MIN, name="b.min")
    return out


def c_adasum(nv, rank, size):
    """Adasum in the runtime's own tree, one fused pair of tensors and a
    single one."""
    g = _rng(rank, 5)
    a = g.standard_normal(100).astype(np.float32)
    b = g.standard_normal((3, 7)).astype(np.float32)
    ha = nv.allreduce_async("ada.a", a, op=ADASUM)
    hb = nv.allreduce_async("ada.b", b, op=ADASUM)
    return {"a": nv.synchronize(ha), "b": nv.synchronize(hb),
            "one": nv.allreduce(g.standard_normal(9), op=ADASUM,
                                name="ada.one")}


def c_fusion_cache(nv, rank, size):
    """``test_fusion_and_cache_steady_state``, with the cache counters:
    step 1 negotiates 40 names, steps 2-4 ride the cache's bits."""
    c0 = nv.counters()
    out = {}
    for step in range(4):
        hs = [nv.allreduce_async(
            f"fuse.{i}", np.full((8,), float(i + step), np.float32))
            for i in range(40)]
        out[f"step{step}"] = np.stack([nv.synchronize(h) for h in hs])
    c1 = nv.counters()
    out["cache_hits"] = c1["cache_hits"] - c0["cache_hits"]
    out["cache_misses"] = c1["cache_misses"] - c0["cache_misses"]
    return out


def c_reducescatter(nv, rank, size):
    x = np.arange(size * 6, dtype=np.float32).reshape(size * 2, 3) + rank
    return {"sum": nv.reducescatter(x, name="rs"),
            "avg": nv.reducescatter(x, op=AVERAGE, name="rs.avg")}


def c_allgather_uneven(nv, rank, size):
    return {"g": nv.allgather(np.full((rank + 1, 2), rank, np.int32),
                              name="ag"),
            "f": nv.allgather(_rng(rank, 6).standard_normal(
                (2 * rank + 1, 3)).astype(np.float32), name="ag.f")}


def c_broadcast_root(nv, rank, size):
    return {"b": nv.broadcast(np.full((3,), float(rank), np.float32),
                              root_rank=size - 1, name="bc"),
            "i": nv.broadcast(np.arange(5, dtype=np.int64) * (rank + 1),
                              root_rank=1, name="bc.i")}


def c_alltoall_uneven(nv, rank, size):
    rows, splits = [], []
    for j in range(size):
        rows += [rank * 10 + j] * (j + 1)
        splits.append(j + 1)
    out, sp = nv.alltoall(np.asarray(rows, np.int64), splits, name="a2a")
    return {"out": out, "splits": sp}


def c_barrier(nv, rank, size):
    nv.barrier()
    return {"ok": True}


def c_mismatch_shape(nv, rank, size):
    h = nv.allreduce_async("bad", np.zeros((rank + 1,), np.float32))
    return {"error": _error(lambda: nv.synchronize(h))}


def c_mismatch_dtype(nv, rank, size):
    dt = np.float32 if rank == 0 else np.float64
    h = nv.allreduce_async("bad_dt", np.zeros((2,), dt))
    return {"error": _error(lambda: nv.synchronize(h))}


def c_grouped(nv, rank, size):
    hs = [nv.allreduce_async(f"g.{i}", np.full((4,), float(i), np.float32),
                             group_name="g", group_size=3)
          for i in range(3)]
    return {"g": np.stack([nv.synchronize(h) for h in hs])}


def c_grouped_repeated(nv, rank, size):
    out = {}
    c0 = nv.counters()
    for step in range(3):
        hs = [nv.allreduce_async(
            f"gr.{i}", np.full((4,), float(i + step), np.float32),
            group_name="gr", group_size=3) for i in range(3)]
        out[f"step{step}"] = np.stack([nv.synchronize(h) for h in hs])
    out["cache_hits"] = nv.counters()["cache_hits"] - c0["cache_hits"]
    return out


def c_join_cached(nv, rank, size):
    """``test_join_with_cached_tensor``: a cached full-world tensor
    renegotiates with participants once a rank joined."""
    ones = np.ones((4,), np.float32)
    out = {"full": nv.allreduce(ones, name="t"),
           "cached": nv.allreduce(ones, name="t")}
    if rank != size - 1:
        out["subset"] = np.stack([nv.allreduce(ones, name="t")
                                  for _ in range(2)])
    out["last"] = nv.join()
    return out


def c_join_rank0(nv, rank, size):
    out = {}
    if rank != 0:
        out["steps"] = np.stack([nv.allreduce(
            np.ones((4,), np.float32) * (rank + 1), name="t0")
            for _ in range(3)])
    out["last"] = nv.join()
    return out


def c_join_fusion_partition(nv, rank, size):
    """Two ~1.2 MB tensors over a 512 KiB threshold while rank 0 joined."""
    out = {}
    if rank != 0:
        hs = [nv.allreduce_async(
            f"big.{i}", np.full((300000,), float(i + 1), np.float32))
            for i in range(2)]
        out["big"] = np.stack([nv.synchronize(h)[:4] for h in hs])
    out["last"] = nv.join()
    return out


def c_join_uneven(nv, rank, size):
    out = {}
    if rank == 0:
        out["last_op"] = nv.allreduce(np.ones((4,), np.float32), name="last")
    out["last"] = nv.join()
    return out


def c_broadcast_root_joined(nv, rank, size):
    if rank == 1:
        return {"last": nv.join()}
    err = _error(lambda: nv.broadcast(np.ones(3, np.float32), root_rank=1,
                                      name="bj"))
    return {"error": err, "last": nv.join()}


def c_package_join(nv, rank, size):
    if rank != 1:
        nv.allreduce(np.ones((2,), np.float32), name="pj")
    return {"last": nv.package_join()}


def c_autotune(nv, rank, size):
    """``test_autotune_smoke`` (``tests/test_native_core.py:426``) on the
    port's runtime, armed by the world's ``HVT_AUTOTUNE*`` env: the sums,
    the ParameterManager's answer, and the knobs each rank applied at each
    negotiation, read after the shutdown (the last negotiation is every
    rank's)."""
    rt = nv.n.get_runtime()
    sums = []
    for step in range(30):
        hs = [nv.allreduce_async(f"t.{i}", np.ones((64,), np.float32))
              for i in range(10)]
        sums.append(np.stack([nv.synchronize(h) for h in hs]))
    best = nv.n.autotune_best()
    nv.n.shutdown()
    return {"sums": np.stack(sums), "best": np.asarray(best),
            "applied": np.asarray(rt.applied_knobs, np.int64),
            "samples": np.asarray(rt.autotune.samples, np.float64)}


NATIVE_SUITES = {
    4: [c_collectives, c_random_fp32, c_ints, c_adasum, c_fusion_cache,
        c_reducescatter, c_barrier],
    3: [c_allgather_uneven, c_broadcast_root, c_alltoall_uneven,
        c_reducescatter, c_random_fp32, c_adasum, c_barrier, c_join_cached,
        c_join_rank0, c_join_fusion_partition],
    2: [c_collectives, c_random_fp32, c_fp16, c_ints, c_adasum,
        c_mismatch_shape, c_mismatch_dtype, c_grouped, c_grouped_repeated,
        c_fusion_cache, c_join_uneven, c_broadcast_root_joined,
        c_package_join, c_allgather_uneven, c_alltoall_uneven],
    "autotune": [c_autotune],  # the port's side only
}


# ---------------------------------------------------------------------------
# Frontend cases: fn(hvd, rank, size) -> {key: value}; the same code runs
# on horovod_tpu.torch and horovod_tpu_torch.torch.
# ---------------------------------------------------------------------------


def _data(rank, salt, shape):
    import torch

    return torch.from_numpy(
        _rng(rank, salt).standard_normal(shape).astype(np.float32))


def t_collectives(hvd, rank, size):
    import torch

    out = {}
    out["avg"] = hvd.allreduce(torch.full((4,), float(rank + 1)), name="ar")
    t = torch.full((2, 3), float(rank + 1))
    ret = hvd.allreduce_(t, name="ar_", op=hvd.Sum)
    out["inplace"], out["inplace_is_t"] = t.clone(), ret is t
    out["ag"] = hvd.allgather(torch.arange(
        (rank + 1) * 2, dtype=torch.float32).reshape(rank + 1, 2), name="ag")
    out["bc"] = hvd.broadcast(torch.full((3,), float(rank)), root_rank=1,
                              name="bc")
    b = torch.full((3,), float(rank))
    hvd.broadcast_(b, root_rank=1, name="bc_")
    out["bc_"] = b
    a2a, sp = hvd.alltoall(torch.arange(4, dtype=torch.float32) + 10 * rank,
                           name="a2a")
    out["a2a"], out["a2a_splits"] = a2a, sp
    outs = hvd.grouped_allreduce(
        [torch.full((3,), float(rank + 1)),
         torch.full((2,), 2.0 * (rank + 1))], name="grp", op=hvd.Sum)
    out["grp0"], out["grp1"] = outs
    out["rs"] = hvd.reducescatter(_data(rank, 7, (4, 3)), name="rs")
    out["scalar_shape"] = tuple(hvd.allreduce(torch.tensor(2.0),
                                              name="sc").shape)
    out["bf16"] = hvd.allreduce(torch.ones(5, dtype=torch.bfloat16) *
                                (rank + 1), name="bf").float()
    h = hvd.allreduce_async(_data(rank, 8, (6,)), name="poll")
    while not hvd.poll(h):
        time.sleep(0.001)
    out["poll"] = hvd.synchronize(h)
    return out


def _linear(torch, seed, i, o, bias=False):
    torch.manual_seed(seed)
    return torch.nn.Linear(i, o, bias=bias)


def t_optimizer_sgd(hvd, rank, size):
    import torch

    model = _linear(torch, 42, 4, 1)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters())
    for i in range(5):
        x = _data(rank, 10 + i, (8, 4))
        opt.zero_grad()
        model(x).pow(2).mean().backward()
        opt.step()
    return {"w": model.weight.detach().clone()}


def t_optimizer_adamw(hvd, rank, size):
    import torch

    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 2))
    torch.manual_seed(5)
    for p in model.parameters():
        p.data.copy_(torch.randn_like(p) * 0.5)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2),
        named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    losses = []
    for i in range(6):
        x = _data(rank, 20 + i, (8, 6))
        opt.zero_grad()
        loss = model(x).pow(2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return {"params": [p.detach().clone() for p in model.parameters()],
            "losses": losses}


def t_backward_passes(hvd, rank, size):
    import torch

    model = _linear(torch, 0, 3, 1)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    for i in range(2):
        model(_data(rank, 30 + i, (4, 3))).pow(2).mean().backward()
    opt.step()
    return {"w": model.weight.detach().clone()}


def t_sync_batch_norm(hvd, rank, size):
    import torch

    full = _data(0, 40, (8, 3, 4, 4))
    x = full[rank * 4:(rank + 1) * 4].clone().requires_grad_(True)
    sbn = hvd.SyncBatchNorm(3)
    sbn.train()
    out = sbn(x)
    (out * _data(0, 41, tuple(out.shape))).sum().backward()
    return {"out": out.detach(), "dx": x.grad, "dw": sbn.weight.grad,
            "db": sbn.bias.grad, "running_mean": sbn.running_mean.clone(),
            "running_var": sbn.running_var.clone()}


def t_broadcast_optimizer_state(hvd, rank, size):
    import torch

    model = torch.nn.Linear(2, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.01 * (rank + 1))
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    return {"lrs": hvd.allgather_object(opt.param_groups[0]["lr"]),
            "obj": hvd.broadcast_object({"r": rank, "v": [1, 2]}, 1)}


def t_torch_state_sync(hvd, rank, size):
    import torch

    el = hvd.elastic
    model = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.fill_(float(rank + 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = el.TorchState(model=model, optimizer=opt, epoch=rank, batch=0)
    state.sync()
    return {"w": model.weight.detach().clone(),
            "epochs": hvd.allgather_object(state.epoch)}


def t_join_uneven(hvd, rank, size):
    import torch

    steps = 3 if rank == 0 else 1
    outs = [hvd.allreduce(torch.ones(2) * (rank + 1), name=f"step{i}",
                          op=hvd.Sum) for i in range(steps)]
    return {"outs": torch.stack(outs), "last": hvd.join()}


def t_adasum(hvd, rank, size):
    import torch

    model = _linear(torch, 3, 3, 1)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    for i in range(2):
        opt.zero_grad()
        model(_data(rank, 50 + i, (4, 3))).pow(2).mean().backward()
        opt.step()
    return {"w": model.weight.detach().clone()}


def t_elastic_sampler(hvd, rank, size):
    s = hvd.elastic.ElasticSampler(list(range(10)), shuffle=True, seed=3)
    first = list(s)
    s.record_indices(first[:2])
    s.reset()
    return {"first": first, "second": list(s), "n": len(s)}


TORCH_SUITE = [t_collectives, t_optimizer_sgd, t_optimizer_adamw,
               t_backward_passes, t_sync_batch_norm,
               t_broadcast_optimizer_state, t_torch_state_sync,
               t_join_uneven, t_adasum, t_elastic_sampler]


# ---------------------------------------------------------------------------
# ops/eager on a gloo world (context.spawn_gloo imports this by name).
# ---------------------------------------------------------------------------


def eager_inputs(rank):
    g = _rng(rank, 60)
    return {"x": g.standard_normal(16).astype(np.float32),
            "xi": g.integers(-9, 9, 8).astype(np.int32),
            "x64": g.standard_normal(12)}


def eager_world():
    """Every eager collective of one rank of the world, on seeded inputs."""
    import torch

    from horovod_tpu_torch import context
    from horovod_tpu_torch.ops import eager as E

    rank, size = context.rank(), context.size()
    inp = {k: torch.from_numpy(v) for k, v in eager_inputs(rank).items()}
    x, xi = inp["x"], inp["xi"]
    out = {
        "sum": E.allreduce(x, E.Sum), "avg": E.allreduce(x, E.Average),
        "min": E.allreduce(x, E.Min), "max": E.allreduce(x, E.Max),
        "prod": E.allreduce(x, E.Product),
        "avg_int": E.allreduce(xi, E.Average),
        "sum_int": E.allreduce(xi, E.Sum),
        "scaled": E.allreduce(x, E.Sum, prescale=2.0, postscale=0.5),
        "scaled_int": E.allreduce(xi, E.Sum, prescale=0.5),
        "adasum": E.allreduce(inp["x64"], E.Adasum),
        "ag": E.allgather(torch.full((rank + 1, 2), rank)),
        "bc": E.broadcast(torch.full((3,), float(rank)), root_rank=size - 1),
        "rs": E.reducescatter(torch.arange(size * 2, dtype=torch.int64)
                              + rank, E.Average),
    }
    splits = [j + 1 for j in range(size)]
    rows = torch.tensor(sum(([rank * 10 + j] * (j + 1)
                             for j in range(size)), []))
    out["a2a"], out["a2a_splits"] = E.alltoall(rows, splits)
    E.barrier()
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# One rank's main, and the world runner.
# ---------------------------------------------------------------------------


def _numpy(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], torch.Tensor):
        return [_numpy(x) for x in v]
    return v


def _rank_main(side, suite, rank, size, port, out):
    import torch

    torch.set_num_threads(1)
    os.environ.update(HVT_RANK=str(rank), HVT_SIZE=str(size),
                      HVT_COORD_PORT=str(port))
    if suite == "torch":
        if side == "port":
            import horovod_tpu_torch as hvt
            import horovod_tpu_torch.torch as hvd

            # The frontend borrows the store of a world already formed.
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                              RANK=str(rank), WORLD_SIZE=str(size))
            hvt.init(device="cpu", backend="gloo")
            hvd.init(device="cpu")
        else:
            import horovod_tpu.torch as hvd

            hvd.init()
        api, cases = hvd, TORCH_SUITE
    else:
        if side == "port":
            from horovod_tpu_torch import native

            native.init(rank, size, "127.0.0.1", port, device="cpu")
            api = PortNative()
        else:
            from horovod_tpu import native

            native.init(rank, size, "127.0.0.1", port)
            api = RefNative()
        cases = NATIVE_SUITES[int(suite) if suite.isdigit() else suite]
    results = {}
    for case in cases:
        t0 = time.perf_counter()
        res = case(api, rank, size)
        results[case.__name__] = {k: _numpy(v) for k, v in res.items()}
        results[case.__name__]["_seconds"] = time.perf_counter() - t0
    if suite == "torch":
        hvd.shutdown()
        if side == "port":
            hvt.shutdown()
    else:
        api.n.shutdown()
    with open(out, "wb") as f:
        pickle.dump(results, f)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(side: str, suite, size: int, timeout: float = 150.0,
              extra_env=None):
    """Run ``suite`` on a world of ``size`` worker processes of ``side``;
    returns each rank's ``{case: {key: value}}`` in rank order."""
    tmp = tempfile.mkdtemp(prefix=f"hvt-eager-{side}-")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
               HVT_FUSION_THRESHOLD=str(FUSION_THRESHOLD),
               HVT_DATA_TIMEOUT_SECS="60")
    env.pop("JAX_PLATFORMS", None)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    if extra_env:
        env.update(extra_env)
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), side, str(suite), str(r),
         str(size), str(port), outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    logs = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0].decode())
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"{side} world {suite} x {size} failed: {rcs}\n"
                           + "\n".join(logs))
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def shared(tmp_path_factory, key: str, fn):
    """``fn()``'s result, computed once a test session: the xdist workers
    of one run share it through a file under their common temp root
    (under a lock), so a world runs once however its tests spread."""
    from filelock import FileLock

    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID", str(os.getpid()))
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"hvt_eager_{uid}_{key}.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            try:
                result = ("ok", fn())
            except Exception as e:  # every test of the world sees it once
                result = ("error", f"{type(e).__name__}: {e}")
            with open(path, "wb") as f:
                pickle.dump(result, f)
        with open(path, "rb") as f:
            status, result = pickle.load(f)
    if status != "ok":
        raise RuntimeError(f"world {key} failed (first run): {result}")
    return result


def reference_build() -> None:
    """Build the JAX package's native library once, before its worlds
    start (its ranks would otherwise each run make)."""
    from horovod_tpu import native

    native.build()


if __name__ == "__main__":
    side, suite, rank, size, port, out = sys.argv[1:7]
    _rank_main(side, suite, int(rank), int(size), int(port), out)
