"""The port's overlap pipeline held against the JAX package's
(``tests/test_overlap.py``) and against its own step without overlap.

* Twins of the reference's cases, on a gloo world of 2 CPU processes
  (``context.spawn_gloo``) against the JAX step on 2 CPU devices: the
  microbatched step under ``overlap=True, accum_steps=4`` (replicated and
  ZeRO-1) and the ``stagger`` keyword cases, four and two steps of a small
  regression (``w [4, 3]``, ``b [3]``, ``c [7]``; rank r takes rows
  ``[16 r, 16 r + 16)`` of each global batch of 32). Tolerance: the
  reference's own, rtol 2e-5 and atol 1e-6 on the parameters, 1e-5
  relative on the losses (the two frameworks round the fp32 gradients in
  other places: ulps). ``stagger`` is numerically the identity (bit for bit
  in the port; the reference's rtol 1e-5 against JAX); buckets keep the
  reverse-layer order; the env defaults are the reference's.
* The port's own, on gloo worlds of 2: overlap on equals overlap off **bit
  for bit** -- parameters, optimizer state and EF residuals after every
  step -- replicated, ZeRO-1 (fused AdamW), the int8 wire with error
  feedback (replicated and ZeRO-1) and the fp16 wire (whose prescale needs
  every leaf, so its buckets go out after the backward), at
  ``accum_steps`` 1 and 4, with a fusion threshold that makes one bucket
  of each leaf; each bucket is reduced exactly once a step, from inside
  the backward (the hooks fire under ``torch.autograd.grad``); a tied
  leaf fires its hook once; a leaf without a gradient is still reduced
  (zeros); buckets go out in the scheduler's order, pack order in the
  first step and then the order rank 0's became whole, which every rank
  takes; a leaf unused on one rank only does not hang the world (a 60 s
  watchdog in each rank, well below the suite's 300 s alarm).
* ``record_overlap_pair`` and ``ring_allreduce_ms``: the reference's
  accounting exactly; the H100's NVLink rate known, one rank 0 ms, an
  unknown card (the CPU) null.
"""

import faulthandler

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd
from horovod_tpu.obs import overlap as jov
from horovod_tpu.ops.fusion import fused_allreduce as jfused_allreduce
from horovod_tpu.parallel import dp as jdp
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch import context
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.obs import overlap as tov
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.ops.batching import pack, unpack
from horovod_tpu_torch.ops.compression import Compression as TComp
from horovod_tpu_torch.ops.layout import BucketScheduler
from horovod_tpu_torch.parallel import dp as tdp
from horovod_tpu_torch.utils import env as tenv

WORLD = 2
LR = 1e-2
THRESHOLD = 16  # bytes: one bucket of each leaf (w, b, c)
BLOCK = 8
RUNS = {
    "replicated": dict(),
    "zero1": dict(sharded=True, fused_update=True),
    "int8_ef": dict(compression=TComp.int8.with_block(BLOCK)),
    "zero1_int8_ef": dict(sharded=True,
                          compression=TComp.int8.with_block(BLOCK)),
    # The fp16 wire's prescale needs every leaf: its buckets go out after
    # the backward, overlap or not.
    "fp16": dict(compression=TComp.fp16),
}
STAGGER = {
    "overlap-no-stagger": dict(overlap=True, stagger=False),
    "stagger-only": dict(stagger=True),
}


def _params():
    rs = np.random.RandomState(0)
    return {
        "w": rs.standard_normal((4, 3)).astype(np.float32),
        "b": np.zeros((3,), np.float32),
        "c": rs.standard_normal(7).astype(np.float32),
    }


def _batch(seed, n=32):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((n, 4)).astype(np.float32),
            rs.standard_normal((n, 3)).astype(np.float32))


def _tloss(p, batch):
    x, y = batch
    pred = x @ p["w"] + p["b"]
    return ((pred - y) ** 2).mean() + 0.1 * (p["c"] ** 2).sum()


def _jloss(p, batch):
    x, y = batch
    pred = x @ p["w"] + p["b"]
    return jnp.mean((pred - y) ** 2) + 0.1 * jnp.sum(p["c"] ** 2)


def _tparams():
    return {k: torch.from_numpy(v) for k, v in _params().items()}


def _tensors(tree):
    """Every tensor of an optimizer state, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach().clone()]
    if isinstance(tree, tfusion.FlatBuckets):
        return [b.detach().clone() for b in tree.buffers]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


class _Spy:
    """Counts bucket reductions (which bucket, inside a backward or not)."""

    def __init__(self, monkey_target=tfusion):
        self.calls = []
        self._orig = monkey_target.reduce_bucket
        self._target = monkey_target

        def spy(leaves, **kw):
            self.calls.append(torch._C._current_graph_task_id() >= 0)
            return self._orig(leaves, **kw)

        monkey_target.reduce_bucket = spy

    def close(self):
        self._target.reduce_bucket = self._orig


def _train(kw, steps, accum_steps, rank, batch_rows=16):
    spy = _Spy()
    try:
        step, wopt = tdp.make_train_step(
            _tloss, topt.fused_adamw(LR) if kw.get("fused_update")
            else topt.adamw(LR), device="cpu", threshold_bytes=THRESHOLD,
            accum_steps=accum_steps, **kw)
        state = tdp.init_state(_tparams(), wopt)
        out = {"losses": [], "params": [], "state": [], "calls": []}
        for i in range(steps):
            x, y = _batch(i)
            rows = slice(batch_rows * rank, batch_rows * (rank + 1))
            spy.calls.clear()
            state, loss = step(state, (torch.from_numpy(x[rows]),
                                       torch.from_numpy(y[rows])))
            out["losses"].append(float(loss))
            out["params"].append({k: v.detach().clone()
                                  for k, v in state.params.items()})
            out["state"].append(_tensors(state.opt_state))
            out["calls"].append(list(spy.calls))
        return out
    finally:
        spy.close()


def _port_worlds():
    rank = context.rank()
    out = {}
    for name, kw in RUNS.items():
        for k in (1, 4):
            for overlap in (False, True):
                out[name, k, overlap] = _train(dict(kw, overlap=overlap), 3,
                                               k, rank)
    for name, kw in STAGGER.items():
        out[name] = _train(kw, 2, 1, rank)
    out["plain"] = _train({}, 2, 1, rank)
    out["twin", False] = _train(dict(overlap=True), 4, 4, rank)
    out["twin", True] = _train(dict(sharded=True, overlap=True), 4, 4, rank)
    return out


@pytest.fixture(scope="module")
def port_runs():
    return context.spawn_gloo(WORLD, _port_worlds)


@pytest.fixture(scope="module")
def jax_runs():
    hvd.init(devices=jax.devices("cpu")[:WORLD])
    try:
        out = {}

        def run(steps, **kw):
            step, wopt = jdp.make_train_step(
                _jloss, optax.adamw(LR, weight_decay=1e-4),
                threshold_bytes=THRESHOLD, **kw)
            state = jdp.init_state(jax.tree.map(jnp.asarray, _params()),
                                   wopt)
            losses = []
            for i in range(steps):
                x, y = _batch(i)
                state, loss = step(state, (jnp.asarray(x), jnp.asarray(y)))
                losses.append(float(loss))
            return {"losses": losses,
                    "params": jax.tree.map(np.asarray, state.params)}

        for sharded in (False, True):
            out["twin", sharded] = run(4, sharded=sharded, overlap=True,
                                       accum_steps=4)
        for name, kw in STAGGER.items():
            out[name] = run(2, **kw)
        return out
    finally:
        hvd.shutdown()


# -- twins of tests/test_overlap.py ------------------------------------------


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["replicated", "sharded"])
def test_overlap_accum_matches_the_reference(port_runs, jax_runs, sharded):
    got, want = port_runs[0]["twin", sharded], jax_runs["twin", sharded]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][-1][k].numpy(), w,
                                   rtol=2e-5, atol=1e-6)
    # ... and the port's own overlap-off step, bit for bit.
    r = port_runs[0][("zero1" if sharded else "replicated"), 4, False]
    assert r["losses"][0] == got["losses"][0]


@pytest.mark.parametrize("kind", list(STAGGER))
def test_overlap_stagger_kwarg_parity(port_runs, jax_runs, kind):
    got, want = port_runs[0][kind], jax_runs[kind]
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][-1][k].numpy(), w,
                                   rtol=2e-5, atol=1e-6)
    plain = port_runs[0]["plain"]
    for a, b in zip(got["params"], plain["params"]):
        for k in a:
            assert torch.equal(a[k], b[k]), (kind, k)
    # stagger alone issues after the backward; overlap inside it.
    flags = sum(got["calls"], [])
    assert len(flags) == 3 * 2
    assert all(flags) if kind == "overlap-no-stagger" else not any(flags)


def test_stagger_is_numerically_identity():
    rs = np.random.RandomState(2)
    tree = {k: rs.standard_normal(n).astype(np.float32)
            for k, n in (("a", 16), ("b", 8), ("c", 4))}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    plain = tfusion.fused_allreduce(ttree, threshold_bytes=64)
    chained = tfusion.fused_allreduce(ttree, threshold_bytes=64, stagger=True)
    for k in tree:
        assert torch.equal(plain[k], chained[k])
    for fn in (tfusion.fused_reducescatter,
               tfusion.quantized_fused_reducescatter):
        a, b = fn(ttree, threshold_bytes=64), fn(ttree, threshold_bytes=64,
                                                 stagger=True)
        for x, y in zip(a[0].buffers, b[0].buffers):
            assert torch.equal(x, y)
    a, _ = tfusion.quantized_fused_allreduce(ttree, threshold_bytes=64)
    b, _ = tfusion.quantized_fused_allreduce(ttree, threshold_bytes=64,
                                             stagger=True)
    for k in tree:
        assert torch.equal(a[k], b[k])
    # The reference's case: its chained Sum within rtol 1e-5 of ours.
    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        @hvd.spmd(out_specs=hvd.P())
        def f():
            return jfused_allreduce(jax.tree.map(jnp.asarray, tree),
                                    op=hvd.Sum, threshold_bytes=64,
                                    stagger=True)

        want = f()
    finally:
        hvd.shutdown()
    from horovod_tpu_torch.ops.collectives import Sum

    got = tfusion.fused_allreduce(ttree, op=Sum, threshold_bytes=64,
                                  stagger=True)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_bucketize_reverse_layer_order_roundtrip():
    leaves = [torch.arange(6, dtype=torch.float32) + i for i in range(5)]
    buffers, spec = pack(leaves, threshold_bytes=24)
    assert len(buffers) == 5
    assert [s.index for s in spec.buckets[0]] == [4]
    assert torch.equal(buffers[0], leaves[4])
    for a, b in zip(leaves, unpack(buffers, spec)):
        assert torch.equal(a, b)
    # The plan the scheduler drives walks the same order.
    plan = tfusion.BucketPlan(leaves, 24)
    assert plan.bucket_of() == [4, 3, 2, 1, 0]


def test_env_knob_defaults(monkeypatch):
    for var in ("HVDTPU_OVERLAP", "HVDTPU_OVERLAP_ACCUM_STEPS",
                "HVDTPU_PREFETCH_DEPTH", "HVDTPU_OVERLAP_STAGGER"):
        monkeypatch.delenv(var, raising=False)
    for env in (tenv, jenv):
        assert env.overlap_default() is False
        assert env.overlap_accum_steps() == 1
        assert env.overlap_stagger() is True
        assert env.prefetch_depth() == 2
    monkeypatch.setenv("HVDTPU_OVERLAP", "1")
    monkeypatch.setenv("HVDTPU_OVERLAP_ACCUM_STEPS", "4")
    monkeypatch.setenv("HVDTPU_PREFETCH_DEPTH", "3")
    monkeypatch.setenv("HVDTPU_OVERLAP_STAGGER", "0")
    for env in (tenv, jenv):
        assert env.overlap_default() is True
        assert env.overlap_accum_steps() == 4
        assert env.prefetch_depth() == 3
        assert env.overlap_stagger() is False


def test_record_overlap_pair_accounting():
    for ov in (tov, jov):
        out = ov.record_overlap_pair(85.0, 100.0, comm_ms_total=20.0)
        assert out["exposed_comm_ms"] == pytest.approx(5.0)
        assert out["overlap_efficiency"] == pytest.approx(0.75)
        assert out["speedup"] == pytest.approx(100.0 / 85.0)
    assert tov.record_overlap_pair(85.0, 100.0, comm_ms_total=20.0) == \
        jov.record_overlap_pair(85.0, 100.0, comm_ms_total=20.0)


def test_record_overlap_pair_unknown_chip_reports_null():
    out = tov.record_overlap_pair(9.0, 10.0, wire_bytes=1 << 20, n_chips=8,
                                  device="cpu")
    assert out["overlap_efficiency"] is None
    assert out["total_comm_ms"] is None
    assert out["speedup"] == pytest.approx(10.0 / 9.0)


def test_ring_allreduce_ms_known_chip_and_one_rank():
    name = "NVIDIA H100 80GB HBM3"
    ms = tov.ring_allreduce_ms(1 << 30, 8, name)
    assert ms == pytest.approx(2 * 7 / 8 * (1 << 30) / 900e9 * 1e3)
    assert tov.ring_allreduce_ms(1 << 30, 1, name) == 0.0
    # One rank: nothing on the wire, and no efficiency from a 0 ms total.
    out = tov.record_overlap_pair(9.0, 10.0, wire_bytes=1 << 30, n_chips=1,
                                  device=name)
    assert out["total_comm_ms"] == 0.0
    assert out["overlap_efficiency"] is None


# -- the port's own ----------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_overlap_on_is_overlap_off_bit_for_bit(port_runs, name, accum):
    for rank in range(WORLD):
        on = port_runs[rank][name, accum, True]
        off = port_runs[rank][name, accum, False]
        assert on["losses"] == off["losses"]
        for step in range(3):
            for k in off["params"][step]:
                assert torch.equal(on["params"][step][k],
                                   off["params"][step][k]), (step, k)
            assert len(on["state"][step]) == len(off["state"][step])
            for a, b in zip(on["state"][step], off["state"][step]):
                assert torch.equal(a, b), step
        # One reduction a bucket a step (3 buckets), from inside the
        # backward with overlap, after it without.
        for flags in on["calls"]:
            assert flags == [name != "fp16"] * 3
        for flags in off["calls"]:
            assert flags == [False] * 3
    if name in ("int8_ef", "zero1_int8_ef"):
        # The residuals are state: rank-local, and non-zero.
        r0 = port_runs[0][name, accum, True]["state"][-1]
        r1 = port_runs[1][name, accum, True]["state"][-1]
        assert any(not torch.equal(a, b) for a, b in zip(r0, r1))


def _twice_used(p, x):
    # A tied leaf: w is read twice; u is read by nothing.
    h = x @ p["w"]
    return ((h @ p["w"].t()) ** 2).mean() + p["b"].sum()


def test_hooks_fire_under_autograd_grad_once_per_tied_leaf():
    rs = np.random.RandomState(3)
    params = {"w": torch.from_numpy(rs.standard_normal((4, 3)).astype(
        np.float32)).requires_grad_(),
              "b": torch.zeros(3, requires_grad=True),
              "u": torch.ones(5, requires_grad=True)}
    x = torch.from_numpy(rs.standard_normal((6, 4)).astype(np.float32))
    plan = tfusion.BucketPlan(params, THRESHOLD)
    sched = BucketScheduler(plan)
    arrivals = []
    sched.finish = lambda i, g: (arrivals.append(
        (i, torch._C._current_graph_task_id() >= 0)), g)[1]
    loss, _, grads = tdp._accumulate(_twice_used, params, x, 1, False, sched)
    assert grads is None
    # Leaves in plan order: b, u, w (sorted names). w and b arrive inside
    # the backward, w once with the sum of its two uses; u (no gradient)
    # after it, as zeros, and its bucket is still reduced.
    order = {i: inside for i, inside in arrivals}
    assert sorted(order) == [0, 1, 2] and len(arrivals) == 3
    assert order[0] and order[2] and not order[1]
    out, res = sched.wait()
    assert res is None
    want = torch.autograd.grad(_twice_used(params, x),
                               [params["w"], params["b"]])
    assert torch.equal(out["w"], want[0]) and torch.equal(out["b"], want[1])
    assert torch.equal(out["u"], torch.zeros(5))


class _OrderSpy(BucketScheduler):
    """Records each step's scheduler: the order it issued in, and the order
    its buckets became whole."""

    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _OrderSpy.made.append(self)


def _one_rank_skips_a_leaf():
    faulthandler.dump_traceback_later(60, exit=True)  # a hang fails fast
    rank = context.rank()

    def loss(p, batch):
        x, y = batch
        pred = x @ p["w"] + p["b"]
        out = ((pred - y) ** 2).mean()
        # c reaches the loss on rank 0 only: rank 1's c hook never fires.
        return out + 0.1 * (p["c"] ** 2).sum() if rank == 0 else out

    res = {}
    tdp.BucketScheduler = _OrderSpy
    try:
        for overlap in (False, True):
            step, wopt = tdp.make_train_step(
                loss, topt.adamw(LR), device="cpu",
                threshold_bytes=THRESHOLD, overlap=overlap)
            state = tdp.init_state(_tparams(), wopt)
            for i in range(3):
                x, y = _batch(i)
                rows = slice(16 * rank, 16 * rank + 16)
                state, _ = step(state, (torch.from_numpy(x[rows]),
                                        torch.from_numpy(y[rows])))
            res[overlap] = {k: v.detach().clone()
                            for k, v in state.params.items()}
    finally:
        tdp.BucketScheduler = BucketScheduler
    faulthandler.cancel_dump_traceback_later()
    res["orders"] = [(s.order, s.ready_order) for s in _OrderSpy.made]
    return res


def test_a_leaf_unused_on_one_rank_does_not_hang_the_world():
    r0, r1 = context.spawn_gloo(WORLD, _one_rank_skips_a_leaf)
    for k in r0[True]:
        assert torch.equal(r0[True][k], r1[True][k]), k
        assert torch.equal(r0[True][k], r0[False][k]), k
    # Buckets in pack order: w, c, b. The first step issues in pack order;
    # the ranks' readiness differs (rank 1's c is whole only after its
    # backward), and both ranks then issue in rank 0's.
    (o0, _), (o1, _) = r0["orders"][0], r1["orders"][0]
    assert o0 == o1 == [0, 1, 2]
    ready0, ready1 = r0["orders"][0][1], r1["orders"][0][1]
    assert ready1[-1] == 1 and ready0 != ready1
    for later0, later1 in zip(r0["orders"][1:], r1["orders"][1:]):
        assert later0[0] == later1[0] == ready0


def test_scheduler_leaves_a_wire_that_needs_every_leaf_to_the_plan():
    # The fp16 wire's prescale reads every leaf before its first bucket:
    # no bucket of it can go out from a hook, and the step reduces it after
    # the backward (the "fp16" runs above).
    plan = tfusion.BucketPlan(_tparams(), THRESHOLD, compression=TComp.fp16)
    assert plan.needs_all_leaves
    with pytest.raises(ValueError, match="needs every leaf"):
        BucketScheduler(plan)
    assert not tfusion.BucketPlan(_tparams(), THRESHOLD).needs_all_leaves


def _input_side_last(p, x):
    # z scales the input, so its gradient is whole only when the backward
    # ends, and z is bucket 0 (the last sorted name).
    return ((((x * p["z"]) @ p["w"]) + p["b"]) ** 2).mean()


@pytest.mark.parametrize("agreed", [False, True], ids=["pack", "agreed"])
def test_scheduler_issues_in_its_order(agreed):
    rs = np.random.RandomState(5)
    params = {"z": torch.ones(4, requires_grad=True),
              "w": torch.from_numpy(rs.standard_normal((4, 3)).astype(
                  np.float32)).requires_grad_(),
              "b": torch.zeros(3, requires_grad=True)}
    x = torch.from_numpy(rs.standard_normal((6, 4)).astype(np.float32))
    plan = tfusion.BucketPlan(params, THRESHOLD)
    first = BucketScheduler(plan)
    tdp._accumulate(_input_side_last, params, x, 1, False, first)
    assert first.ready_order[-1] == 0 and sorted(first.ready_order) == \
        [0, 1, 2]
    assert first.agree_order() == first.ready_order  # one rank: its own
    sched = BucketScheduler(plan, order=first.ready_order if agreed else None)
    issued, reduce = [], plan.reduce

    def spy(b, leaves):
        issued.append((b, sum(g is not None for g in sched._grads)))
        return reduce(b, leaves)

    plan.reduce = spy
    tdp._accumulate(_input_side_last, params, x, 1, False, sched)
    out, _ = sched.wait()
    if agreed:
        # The first bucket whole goes out as soon as it is, the input
        # side's last.
        assert [b for b, _ in issued] == first.ready_order
        assert issued[0][1] < 3
    else:
        # Pack order: everything waits for bucket 0, whole last.
        assert [b for b, _ in issued] == [0, 1, 2]
        assert all(n == 3 for _, n in issued)
    want = torch.autograd.grad(_input_side_last(params, x),
                               [params[k] for k in ("z", "w", "b")])
    for k, w in zip(("z", "w", "b"), want):
        assert torch.equal(out[k], w), k
    with pytest.raises(ValueError, match="not an order"):
        BucketScheduler(plan, order=[0, 0, 1])
