"""The port's gradient guard, consistency audit and fail-silent chaos sites
(horovod_tpu_torch.guard) held against the JAX package's
(tests/test_guard.py's classes have twins here, on the CPU).

The screen is one fp32 sum of squares per leaf group (``_foreach_norm``
squared), so the sum and the norm are held within 1e-6 relative of the
reference's, the verdicts and counters exactly. Steps are held against the
reference's guarded ``make_train_step`` on the same seeded batches: the
skip pattern exactly, the parameters within fp32 summation noise. A skip
is held bit for bit on the port's own state (parameters, every optimizer
state tensor, EF residuals, ``step``) on the replicated path, ZeRO-1
(unfused, and fused through the AdamW kernel's plain version with the
skip flag), the int8 wire, the overlap pipeline with accumulation, fp8
compute, and on gloo worlds of 2 (a NaN on one rank skips both) and 3
(the audit localizes and resyncs a corrupted rank).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd
from horovod_tpu import chaos as jchaos
from horovod_tpu import guard as jguard
from horovod_tpu.guard import inject as jinject
from horovod_tpu.ops import guards as jguards
from horovod_tpu.parallel import dp as jdp
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch import chaos, checkpoint, context
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.exceptions import HorovodInternalError
from horovod_tpu_torch.guard import (
    ConsistencyAuditor,
    GuardConfig,
    check_gradients,
    fingerprint,
    fresh_state,
    majority_vote,
    resolve,
)
from horovod_tpu_torch.guard import inject
from horovod_tpu_torch.ops import fused_adamw as tfa
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.guards import finite_and_sumsq, per_bucket_stats
from horovod_tpu_torch.parallel import dp
from horovod_tpu_torch.utils import env as tenv
from jax.sharding import PartitionSpec as P

import torch_fault_ranks as ranks

from conftest import cpu_devices


@pytest.fixture(autouse=True)
def _chaos_clean():
    chaos._reset_for_tests()
    jchaos._reset_for_tests()
    yield
    chaos._reset_for_tests()
    jchaos._reset_for_tests()


# ---- config -------------------------------------------------------------


class TestGuardConfig:
    def test_defaults(self):
        cfg = GuardConfig()
        assert cfg.spike_sigma == 6.0
        assert cfg.max_skips == 8
        assert cfg.warmup == 20
        assert cfg.audit_every == 100
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jguard.GuardConfig())

    def test_validation(self):
        for kw in (dict(spike_sigma=0), dict(max_skips=0),
                   dict(ema_decay=1.0), dict(warmup=-1)):
            with pytest.raises(ValueError):
                GuardConfig(**kw)
            with pytest.raises(ValueError):
                jguard.GuardConfig(**kw)

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("HVDTPU_GUARD_SPIKE_SIGMA", "3.5")
        monkeypatch.setenv("HVDTPU_GUARD_MAX_SKIPS", "2")
        monkeypatch.setenv("HVDTPU_GUARD_AUDIT_EVERY", "7")
        monkeypatch.setenv("HVDTPU_GUARD_WARMUP", "4")
        monkeypatch.setenv("HVDTPU_GUARD_EMA_DECAY", "0.9")
        cfg = GuardConfig.from_env()
        assert cfg.spike_sigma == 3.5
        assert cfg.max_skips == 2
        assert cfg.audit_every == 7
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jguard.GuardConfig.from_env())

    def test_resolve(self, monkeypatch):
        assert resolve(False) is None
        assert isinstance(resolve(True), GuardConfig)
        cfg = GuardConfig(max_skips=3)
        assert resolve(cfg) is cfg
        monkeypatch.delenv("HVDTPU_GUARD", raising=False)
        assert resolve(None) is None  # env default off
        monkeypatch.setenv("HVDTPU_GUARD", "1")
        assert isinstance(resolve(None), GuardConfig)
        with pytest.raises(ValueError):
            resolve("yes")

    def test_env_knob_validation(self, monkeypatch):
        monkeypatch.setenv("HVDTPU_GUARD_SPIKE_SIGMA", "-1")
        with pytest.raises(ValueError):
            tenv.guard_spike_sigma()
        monkeypatch.setenv("HVDTPU_GUARD_EMA_DECAY", "1.5")
        with pytest.raises(ValueError):
            tenv.guard_ema_decay()
        for name, raw in (("GUARD_MAX_SKIPS", "0"), ("GUARD_WARMUP", "-3"),
                          ("GUARD_AUDIT_EVERY", "-1")):
            monkeypatch.setenv("HVDTPU_" + name, raw)
            fn = name.lower()
            assert getattr(tenv, fn)() == getattr(jenv, fn)()


# ---- the screen ---------------------------------------------------------


def _screen_trees():
    rs = np.random.RandomState(7)
    clean = {"a": rs.randn(4, 3).astype(np.float32),
             "b": rs.randn(5).astype(np.float32)}
    out = [clean]
    for bad in (np.nan, np.inf, -np.inf):
        t = {k: v.copy() for k, v in clean.items()}
        t["b"][2] = bad
        out.append(t)
    big = {k: v.copy() for k, v in clean.items()}
    big["a"][0, 0] = 3e38  # finite, but its square overflows fp32
    out.append(big)
    return out


class TestFusedChecks:
    def test_clean_tree(self):
        tree = {"a": torch.ones(4, 3), "b": torch.full((5,), 2.0)}
        finite, sumsq = finite_and_sumsq(tree)
        assert bool(finite)
        assert float(sumsq) == pytest.approx(12.0 + 20.0, rel=1e-6)

    def test_nan_and_inf_flagged(self):
        for bad in (np.nan, np.inf, -np.inf):
            tree = {"a": torch.tensor([1.0, bad, 3.0])}
            finite, _ = finite_and_sumsq(tree)
            assert not bool(finite)

    def test_int_leaves_ignored(self):
        tree = {"i": torch.arange(5), "f": torch.ones(2)}
        finite, sumsq = finite_and_sumsq(tree)
        assert bool(finite)
        assert float(sumsq) == pytest.approx(2.0, rel=1e-6)

    def test_per_bucket_stats(self):
        bufs = [torch.ones(8), torch.tensor([np.nan, 1.0])]
        stats = per_bucket_stats(bufs)
        assert bool(stats[0][0])
        assert float(stats[0][1]) == pytest.approx(8.0, rel=1e-6)
        assert not bool(stats[1][0])

    @pytest.mark.parametrize("case", range(5))
    def test_screen_matches_the_reference(self, case):
        tree = _screen_trees()[case]
        finite, sumsq = finite_and_sumsq(
            {k: torch.from_numpy(v) for k, v in tree.items()})
        jfinite, jsumsq = jguards.finite_and_sumsq(
            {k: jnp.asarray(v) for k, v in tree.items()})
        jsumsq = float(jsumsq)
        # The verdict the guard reads: finite flag and finite norm.
        assert (bool(finite) and np.isfinite(float(sumsq))) == (
            bool(jfinite) and np.isfinite(jsumsq))
        if np.isfinite(jsumsq):
            assert float(sumsq) == pytest.approx(jsumsq, rel=1e-6)

    def test_bf16_leaves_sum_in_fp32(self):
        x = torch.full((1000,), 3.0, dtype=torch.bfloat16)
        finite, sumsq = finite_and_sumsq([x])
        assert sumsq.dtype == torch.float32
        assert float(sumsq) == pytest.approx(9000.0, rel=1e-6)


# ---- check_gradients against the reference ------------------------------


def _jax_check(trees, cfg):
    """The reference's check_gradients over a sequence of gradient trees on
    a world of one device, threading its state."""
    hvd.init(devices=cpu_devices(1))
    try:
        fn = hvd.spmd(lambda g, s: jguard.check_gradients(g, s, cfg),
                      in_specs=(P(), P()), out_specs=P())
        s = jguard.fresh_state()
        out = []
        for t in trees:
            ok, norm, s = fn({k: jnp.asarray(v) for k, v in t.items()}, s)
            out.append((bool(ok), float(norm),
                        {k: float(v) for k, v in s._asdict().items()}))
        return out
    finally:
        hvd.shutdown()


def _grad_sequence():
    rs = np.random.RandomState(11)
    seq = []
    for i in range(8):
        t = {"w": rs.randn(6, 5).astype(np.float32),
             "b": rs.randn(5).astype(np.float32)}
        if i == 3:
            t["w"][1, 1] = np.nan
        if i == 5:
            t = {k: v * 1e4 for k, v in t.items()}  # a spike
        seq.append(t)
    return seq


@pytest.mark.parametrize("warmup", [0, 2])
def test_check_gradients_matches_the_reference(warmup):
    cfg_kw = dict(warmup=warmup, spike_sigma=3.0, ema_decay=0.9,
                  audit_every=0)
    seq = _grad_sequence()
    want = _jax_check(seq, jguard.GuardConfig(**cfg_kw))
    cfg = GuardConfig(**cfg_kw)
    s = fresh_state()
    oks = []
    for t, (jok, jnorm, jstate) in zip(seq, want):
        ok, norm, s = check_gradients(
            {k: torch.from_numpy(v) for k, v in t.items()}, s, cfg)
        assert bool(ok) == jok
        oks.append(bool(ok))
        if np.isfinite(jnorm):
            assert float(norm) == pytest.approx(jnorm, rel=1e-6)
        else:
            assert not np.isfinite(float(norm))
        for f in ("seen", "skipped", "consecutive"):
            assert int(getattr(s, f)) == int(jstate[f]), f
        for f in ("mean", "var", "last_norm"):
            assert float(getattr(s, f)) == pytest.approx(
                jstate[f], rel=1e-5, abs=1e-12), f
    assert not oks[3] and not oks[5] and oks[6]


def test_guard_state_fields_are_distinct_device_scalars():
    s = fresh_state("cpu")
    ptrs = {t.data_ptr() for t in s}
    assert len(ptrs) == len(s)
    assert all(t.dim() == 0 for t in s)
    assert [t.dtype for t in s] == [torch.float32, torch.float32,
                                    torch.int32, torch.int32, torch.int32,
                                    torch.float32]


# ---- the guarded step -----------------------------------------------------


def _mk(cfg, opt=None, **kw):
    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy(
        np.asarray(rng.randn(8, 4) * 0.1, np.float32))}

    def loss_fn(p, b):
        x, y = b
        return ((x @ p["w"] - y) ** 2).mean()

    step, wopt = dp.make_train_step(
        loss_fn, opt or topt.adamw(0.05, weight_decay=0.0), guard=cfg,
        device="cpu", **kw)
    return step, dp.init_state(params, wopt), rng


def _batch(rng, nan=False):
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    if nan:
        x[0, 0] = np.nan
    return (torch.from_numpy(x), torch.from_numpy(y))


def _snapshot(ts):
    return ([p.detach().clone() for p in ts.params.values()]
            + ranks.state_tensors(ts.opt_state) + [ts.step.clone()])


def _bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


PATHS = {
    "replicated": {},
    "int8_ef": dict(compression=Compression.int8.with_block(64)),
    "zero1": dict(sharded=True),
    "zero1_fused": dict(sharded=True, fused_update=True),
    "zero1_fused_int8": dict(sharded=True, fused_update=True,
                             compression=Compression.int8.with_block(64)),
    "overlap_accum": dict(overlap=True, accum_steps=2),
}


def _path_opt(name):
    return (topt.fused_adamw(0.05, weight_decay=0.0) if "fused" in name
            else topt.adamw(0.05, weight_decay=0.0))


class TestInGraphGuard:
    def test_clean_steps_commit_and_feed_the_baseline(self):
        step, ts, rng = _mk(GuardConfig(warmup=1, audit_every=0))
        assert ts.guard is None  # seeded lazily by the wrapper
        ts, _ = step(ts, _batch(rng))
        assert int(ts.step) == 1 and int(ts.guard.seen) == 1
        assert int(ts.guard.skipped) == 0 and float(ts.guard.mean) > 0
        ts, _ = step(ts, _batch(rng))
        assert int(ts.step) == 2 and int(ts.guard.seen) == 2

    @pytest.mark.parametrize("path", list(PATHS))
    def test_nan_step_skips_everything(self, path):
        step, ts, rng = _mk(GuardConfig(audit_every=0), _path_opt(path),
                            **PATHS[path])
        ts, _ = step(ts, _batch(rng))
        before = _snapshot(ts)
        ts2, _ = step(ts, _batch(rng, nan=True))
        # Step counter frozen; parameters and every optimizer-state tensor
        # (moments, counts, ZeRO-1 shards, EF residuals) bit for bit.
        assert _bitwise(before, _snapshot(ts2))
        assert int(ts2.guard.skipped) == 1
        assert int(ts2.guard.consecutive) == 1
        assert float(ts2.guard.last_norm) == -1.0  # host-safe sentinel
        # Recovery: a clean retry commits and clears the streak.
        ts3, _ = step(ts2, _batch(rng))
        assert int(ts3.step) == int(ts2.step) + 1
        assert int(ts3.guard.consecutive) == 0
        assert not _bitwise(before, _snapshot(ts3))

    def test_ef_residuals_pass_through_on_skip(self):
        step, ts, rng = _mk(GuardConfig(audit_every=0),
                            compression=Compression.int8.with_block(64))
        ts, _ = step(ts, _batch(rng))
        res = [b.clone() for b in ts.opt_state.residual.buffers]
        assert any(float(r.abs().sum()) > 0 for r in res)  # EF carries mass
        ts2, _ = step(ts, _batch(rng, nan=True))
        for a, b in zip(res, ts2.opt_state.residual.buffers):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("fused", [False, True])
    def test_sharded_state_passes_through_on_skip(self, fused):
        step, ts, rng = _mk(
            GuardConfig(audit_every=0),
            topt.fused_adamw(0.05, weight_decay=0.0) if fused else None,
            sharded=True, fused_update=fused)
        ts, _ = step(ts, _batch(rng))
        buckets = [b.clone() for b in ts.opt_state.inner.mu.buffers
                   + ts.opt_state.inner.nu.buffers]
        count = ts.opt_state.inner.count.clone()
        ts2, _ = step(ts, _batch(rng, nan=True))
        after = ts2.opt_state.inner.mu.buffers + ts2.opt_state.inner.nu.buffers
        assert buckets and all(torch.equal(a, b)
                               for a, b in zip(buckets, after))
        assert torch.equal(ts2.opt_state.inner.count, count)

    def test_fused_kernel_sees_the_skip_flag(self, monkeypatch):
        seen = []
        orig = tfa.fused_adamw_update

        def spy(p, m, v, g, count, spec, ok=None):
            seen.append(None if ok is None else int(ok))
            return orig(p, m, v, g, count, spec, ok)

        monkeypatch.setattr(topt, "fused_adamw_update", spy)
        step, ts, rng = _mk(GuardConfig(audit_every=0),
                            topt.fused_adamw(0.05), sharded=True,
                            fused_update=True)
        ts, _ = step(ts, _batch(rng))
        ts, _ = step(ts, _batch(rng, nan=True))
        assert seen == [1, 0]

    def test_norm_spike_is_skipped(self):
        # Gradient == mean(b, axis=0): the batch controls the gradient
        # exactly, so the spike is deterministic.
        params = {"w": torch.zeros(8)}
        step, opt = dp.make_train_step(
            lambda p, b: (p["w"] * b.mean(0)).sum(), _sgd(0.01),
            guard=GuardConfig(warmup=2, spike_sigma=6.0, audit_every=0),
            device="cpu")
        ts = dp.init_state(params, opt, guard=True)
        calm = torch.ones(8, 8)
        for _ in range(4):
            ts, _ = step(ts, calm)
        assert int(ts.guard.skipped) == 0
        w = ts.params["w"].detach().clone()
        ts2, _ = step(ts, calm * 1e6)  # flipped-exponent-bit scale
        assert int(ts2.guard.skipped) == 1
        assert int(ts2.step) == int(ts.step)
        assert torch.equal(ts2.params["w"], w)
        # The anomalous norm did NOT poison the EW baseline.
        assert float(ts2.guard.mean) == pytest.approx(float(ts.guard.mean))
        ts3, _ = step(ts2, calm)  # calm again: commits
        assert int(ts3.step) == int(ts2.step) + 1

    def test_escalation_raises_recoverable_error(self):
        step, ts, rng = _mk(GuardConfig(max_skips=2, audit_every=0))
        ts, _ = step(ts, _batch(rng))
        with pytest.raises(HorovodInternalError, match="consecutive"):
            for _ in range(5):
                ts, _ = step(ts, _batch(rng, nan=True))
        assert step.guard_runtime.escalations == 1

    def test_escalation_streak_resets_after_restore(self):
        step, ts0, rng = _mk(GuardConfig(max_skips=2, audit_every=0))
        ts0, _ = step(ts0, _batch(rng))
        # What an elastic restore would bring back: the state's tensors as
        # they were (the step trains the parameters in place).
        snap_params = {k: v.detach().clone() for k, v in ts0.params.items()}
        snapshot = dataclasses.replace(
            ts0, guard=type(ts0.guard)(*(t.clone() for t in ts0.guard)),
            step=ts0.step.clone())
        ts = ts0
        with pytest.raises(HorovodInternalError):
            for _ in range(5):
                ts, _ = step(ts, _batch(rng, nan=True))
        for k, v in snap_params.items():  # skips left the params alone
            assert torch.equal(ts0.params[k], v)
        # The restored snapshot (rewound skip counters) must not escalate
        # at once; a clean step commits normally.
        ts2, _ = step(snapshot, _batch(rng))
        assert int(ts2.step) == int(snapshot.step) + 1

    def test_unguarded_step_preserves_foreign_guard_state(self):
        stepg, ts, rng = _mk(GuardConfig(audit_every=0))
        ts, _ = stepg(ts, _batch(rng))
        stepu, _ = dp.make_train_step(
            lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(),
            topt.adamw(0.05), guard=False, device="cpu")
        ts2, _ = stepu(ts, _batch(rng))
        assert ts2.guard is not None
        assert int(ts2.guard.seen) == int(ts.guard.seen)
        assert stepu.guard_runtime is None

    def test_guarded_state_checkpoint_round_trip(self, tmp_path):
        step, ts, rng = _mk(GuardConfig(audit_every=0))
        ts, _ = step(ts, _batch(rng))
        ts, _ = step(ts, _batch(rng, nan=True))  # skip bookkeeping > 0
        checkpoint.save_checkpoint(str(tmp_path), ts, step=int(ts.step))
        _, target, _ = _mk(GuardConfig(audit_every=0))
        target = dataclasses.replace(target, guard=fresh_state("cpu"))
        restored = checkpoint.restore_checkpoint(str(tmp_path), target)
        assert int(restored.guard.skipped) == int(ts.guard.skipped)
        assert float(restored.guard.mean) == pytest.approx(
            float(ts.guard.mean))
        assert torch.equal(restored.params["w"], ts.params["w"])
        assert _bitwise(ranks.state_tensors(restored.opt_state),
                        ranks.state_tensors(ts.opt_state))

    def test_init_state_seeds_the_guard(self):
        _, ts, _ = _mk(GuardConfig(audit_every=0))
        assert ts.guard is None
        step, opt = dp.make_train_step(lambda p, b: p["w"].sum(),
                                       topt.adamw(0.1), guard=True,
                                       device="cpu")
        seeded = dp.init_state({"w": torch.ones(3)}, opt, guard=True)
        assert int(seeded.guard.seen) == 0 and seeded.guard.mean.dim() == 0

    def test_warmup_zero_does_not_livelock(self):
        step, ts, rng = _mk(GuardConfig(warmup=0, audit_every=0))
        for _ in range(3):
            ts, _ = step(ts, _batch(rng))
        assert int(ts.step) == 3 and int(ts.guard.skipped) == 0

    def test_guard_is_the_unguarded_step_on_clean_data(self):
        params = {}
        for guard in (False, GuardConfig(warmup=100, audit_every=0)):
            step, ts, rng = _mk(guard, sharded=True)
            for _ in range(3):
                ts, _ = step(ts, _batch(rng))
            params[bool(guard)] = ts.params["w"].detach().clone()
        assert torch.equal(params[True], params[False])


def _sgd(lr):
    def update(g, s, p=None):
        return {k: -lr * v for k, v in g.items()}, s

    return topt.Optimizer(lambda p: (), update)


class TestGuardPairings:
    """The guard combines with the step's other options as in the JAX
    package, which refuses none of these pairings."""

    def test_overlap_equals_no_overlap_through_a_skip(self):
        runs = []
        for overlap in (False, True):
            step, ts, rng = _mk(GuardConfig(audit_every=0), overlap=overlap,
                                threshold_bytes=64)
            for nan in (False, True, False):
                ts, _ = step(ts, _batch(rng, nan=nan))
            runs.append(_snapshot(ts) + list(ts.guard))
        assert _bitwise(*runs)

    def test_accum_steps_screens_the_microbatch_mean(self):
        step, ts, rng = _mk(GuardConfig(audit_every=0), accum_steps=4)
        ts, _ = step(ts, _batch(rng))
        before = _snapshot(ts)
        x, y = _batch(rng)
        x[15, 0] = float("nan")  # in the last microbatch only
        ts2, _ = step(ts, (x, y))
        assert _bitwise(before, _snapshot(ts2))
        assert int(ts2.guard.skipped) == 1

    def test_fp8_compute_state_stays_on_a_skip(self):
        from horovod_tpu_torch.models import GPT2Config, GPT2LMModel

        cfg = GPT2Config.tiny(compute_dtype="fp8", param_dtype=torch.float32,
                              dtype=torch.float32, use_flash=False)
        model = GPT2LMModel(cfg, device="cpu")

        def loss(p, b):
            tokens, wgt = b
            logits = torch.func.functional_call(model, p, (tokens[:, :-1],))
            ce = torch.nn.functional.cross_entropy(
                logits.flatten(0, 1), tokens[:, 1:].flatten(),
                reduction="none").view(tokens.shape[0], -1).mean(-1)
            return (ce * wgt).mean()

        step, opt = dp.make_train_step(loss, topt.adamw(1e-3),
                                       guard=GuardConfig(audit_every=0),
                                       compute_dtype="fp8", device="cpu")
        ts = dp.init_state(model, opt)
        rs = np.random.RandomState(0)
        tokens = torch.from_numpy(rs.randint(0, 512, (2, 17)))
        ts, _ = step(ts, (tokens, torch.ones(2)))
        before = _snapshot(ts)
        ts2, _ = step(ts, (tokens, torch.tensor([1.0, float("nan")])))
        assert _bitwise(before, _snapshot(ts2))
        hist = [k for k in ts2.params if k.endswith("fp8_x_amax_history")]
        assert hist


@pytest.fixture
def world1():
    ctx = hvd.init(devices=cpu_devices(1))
    yield ctx
    hvd.shutdown()


def test_guarded_trajectory_matches_the_reference(world1):
    """The same batches (one poisoned, one spiking) through the reference's
    guarded step and the port's, each a world of one (the guard's norm is
    over the ranks' local gradients, so the worlds must match): the same
    skips, the same baseline, parameters within fp32 noise."""
    cfg_kw = dict(warmup=2, spike_sigma=6.0, audit_every=0)
    jstep, jopt = jdp.make_train_step(
        lambda p, b: jnp.sum(p["w"] * jnp.mean(b, axis=0)), optax.sgd(0.01),
        guard=jguard.GuardConfig(**cfg_kw), donate=False)
    jts = jdp.init_state({"w": jnp.zeros((8,), jnp.float32)}, jopt)
    step, opt = dp.make_train_step(
        lambda p, b: (p["w"] * b.mean(0)).sum(), _sgd(0.01),
        guard=GuardConfig(**cfg_kw), device="cpu")
    ts = dp.init_state({"w": torch.zeros(8)}, opt)
    rs = np.random.RandomState(2)
    for i in range(7):
        b = (1.0 + 0.1 * rs.randn(8, 8)).astype(np.float32)
        if i == 3:
            b[0, 0] = np.nan
        if i == 5:
            b = b * 1e6
        jts, _ = jstep(jts, jnp.asarray(b))
        ts, _ = step(ts, torch.from_numpy(b))
        assert int(ts.step) == int(jts.step), i
        for f in ("seen", "skipped", "consecutive"):
            assert int(getattr(ts.guard, f)) == int(getattr(jts.guard, f))
        for f in ("mean", "var", "last_norm"):
            assert float(getattr(ts.guard, f)) == pytest.approx(
                float(getattr(jts.guard, f)), rel=1e-5, abs=1e-12), f
        np.testing.assert_allclose(ts.params["w"].detach().numpy(),
                                   np.asarray(jts.params["w"]), rtol=1e-5,
                                   atol=1e-7)
    assert int(ts.guard.skipped) == 2


@pytest.mark.parametrize("variant", list(ranks.GUARD_VARIANTS))
def test_nan_on_one_rank_skips_the_world(variant):
    out = context.spawn_gloo(2, ranks.guard_world2, variant)
    for r in out:
        assert r["skipped_bitwise"], variant
        assert r["skipped_at_2"] == 1 and r["skipped"] == 1
        assert r["step"] == 2
    for k in out[0]["params"]:
        np.testing.assert_array_equal(out[0]["params"][k],
                                      out[1]["params"][k])


# ---- audit --------------------------------------------------------------


def _tree(seed, poison=False):
    rng = np.random.RandomState(seed)
    t = {
        "w": rng.randn(4, 3).astype(np.float32),
        "b": rng.randn(3).astype(np.float32),
    }
    if poison:
        t["w"] = t["w"].copy()
        t["w"][0, 0] += 1e-6  # one ULP-ish of silent corruption
    return t


def _ttree(seed, poison=False):
    return {k: torch.from_numpy(v) for k, v in _tree(seed, poison).items()}


class TestFingerprint:
    def test_deterministic_and_sensitive(self):
        assert fingerprint(_ttree(0)) == fingerprint(_ttree(0))
        assert fingerprint(_ttree(0)) != fingerprint(_ttree(1))
        assert fingerprint(_ttree(0)) != fingerprint(_ttree(0, poison=True))

    def test_torch_and_numpy_leaves_agree(self):
        assert fingerprint(_tree(3)) == fingerprint(_ttree(3))

    @pytest.mark.parametrize("seed", [0, 3])
    def test_matches_the_reference(self, seed):
        t = _tree(seed)
        t["step"] = np.int32(7)
        t["nest"] = [np.arange(4, dtype=np.int64), np.float32(2.5)]
        tt = dict(t, w=torch.from_numpy(t["w"]), b=torch.from_numpy(t["b"]),
                  step=torch.tensor(7, dtype=torch.int32))
        assert fingerprint(tt) == jguard.fingerprint(t)

    def test_bf16_hashes_its_bytes(self):
        a = torch.randn(8).bfloat16()
        b = a.clone()
        b.view(torch.int16)[3] ^= 1
        assert fingerprint({"a": a}) != fingerprint({"a": b})
        assert fingerprint({"a": a}) == fingerprint({"a": a.clone()})

    def test_rank_local_buckets_are_left_out(self):
        from horovod_tpu_torch.ops.fusion import EFResiduals

        t = {"w": torch.ones(3)}
        assert fingerprint(dict(t, r=EFResiduals([torch.randn(4)]))) == \
            fingerprint(t)


class TestMajorityVote:
    def test_localizes_minority(self):
        assert majority_vote([7, 9, 7]) == (7, [1])
        assert majority_vote([7, 7, 7]) == (7, [])
        assert majority_vote([1, 2, 2, 2, 3]) == (2, [0, 4])

    def test_tie_has_no_majority(self):
        maj, minority = majority_vote([1, 2])
        assert maj is None and minority == []
        assert majority_vote([1, 1, 2, 2])[0] is None

    def test_matches_the_reference(self):
        rs = np.random.RandomState(0)
        for _ in range(50):
            votes = list(rs.randint(0, 3, rs.randint(1, 7)))
            assert majority_vote(votes) == jguard.majority_vote(votes)


class _FakeWorld:
    """An in-process world of ranks: rank trees registered up front,
    allgather/broadcast read them directly."""

    def __init__(self, trees, hosts):
        self.trees = trees
        self.hosts = hosts

    def auditor(self, rank, on_report=None):
        def allgather_object(obj):
            return [
                {"rank": r, "host": self.hosts[r],
                 "crc": fingerprint(self.trees[r])}
                for r in range(len(self.trees))
            ]

        def broadcast_leaf(t, root, name):
            i = int(name.rsplit(".", 1)[1])
            return [self.trees[root][k] for k in sorted(self.trees[root])][i]

        return ConsistencyAuditor(
            rank=rank, host_id=self.hosts[rank],
            allgather_object=allgather_object,
            broadcast_leaf=broadcast_leaf,
            on_report=on_report or (lambda host, count: None),
        )


class TestConsistencyAuditor:
    def test_clean_world_is_a_no_op(self):
        world = _FakeWorld([_ttree(0) for _ in range(3)], ["h0", "h1", "h2"])
        a = world.auditor(0)
        tree, report = a.audit(world.trees[0], step=5)
        assert not report.diverged and report.healed == ""
        assert tree is world.trees[0]
        assert a.last_verified_step == 5

    def test_minority_localized_and_resynced(self):
        trees = [_ttree(0), _ttree(0, poison=True), _ttree(0)]
        world = _FakeWorld(trees, ["h0", "h1", "h2"])
        reports = []
        a = world.auditor(1, on_report=lambda h, c: reports.append((h, c)))
        live = trees[1]["w"]
        healed, report = a.audit(trees[1], step=8)
        assert report.diverged and report.minority_ranks == [1]
        assert report.root_rank == 0 and report.healed == "resync"
        # The minority's tree now matches the majority bit for bit, healed
        # in place.
        for k in healed:
            assert torch.equal(healed[k], trees[0][k])
        assert healed["w"] is live
        assert reports == []  # the minority does not report itself
        assert report.as_record()["minority_hosts"] == ["h1"]

    def test_lowest_majority_rank_reports(self):
        trees = [_ttree(0), _ttree(0, poison=True), _ttree(0)]
        world = _FakeWorld(trees, ["h0", "h1", "h2"])
        reports = []
        a = world.auditor(0, on_report=lambda h, c: reports.append((h, c)))
        a.audit(trees[0], step=8)
        assert reports == [("h1", 1)]
        a.audit(trees[0], step=9)
        assert reports[-1] == ("h1", 2)  # repeat offense counted up

    def test_tie_escalates_to_walkback(self):
        trees = [_ttree(0), _ttree(0, poison=True)]
        world = _FakeWorld(trees, ["h0", "h1"])
        a = world.auditor(0)
        with pytest.raises(HorovodInternalError, match="no majority"):
            a.audit(trees[0], step=4)
        assert a.last_report.healed == "walkback"
        assert a.last_verified_step is None

    def test_sharded_state_escalates_to_walkback(self):
        trees = [_ttree(0), _ttree(0, poison=True), _ttree(0)]
        world = _FakeWorld(trees, ["h0", "h1", "h2"])
        a = world.auditor(2)
        with pytest.raises(HorovodInternalError, match="sharded"):
            a.audit(trees[2], step=4, has_sharded=True)


def test_audit_resyncs_a_corrupted_rank_on_a_world_of_3():
    out = context.spawn_gloo(3, ranks.audit_world3)
    for r in out:
        rep = r["reports"]
        assert [x["step"] for x in rep] == [1, 2, 3]
        assert not rep[0]["diverged"] and not rep[2]["diverged"]
        assert rep[1]["diverged"] and rep[1]["minority_ranks"] == [1]
        assert rep[1]["healed"] == "resync" and rep[1]["root_rank"] == 0
    for r in out[1:]:
        for k in out[0]["params"]:
            np.testing.assert_array_equal(r["params"][k],
                                          out[0]["params"][k])


# ---- fail-silent chaos sites --------------------------------------------


class TestFailSilentChaosSites:
    def test_sites_parse(self):
        plan = chaos.plan(
            "grad.nan:nan@step=2;n=1,"
            "grad.bitflip:bitflip@step=3;host=hostB,"
            "param.corrupt:corrupt@step=4;rank=1",
            seed=5,
        )
        assert len(plan.rules) == 3

    def test_bad_action_rejected(self):
        with pytest.raises(chaos.ChaosSpecError):
            chaos.plan("grad.bitflip:nan")

    def test_poison_batch_injects_one_nan(self):
        chaos.plan("grad.nan:nan@step=2;n=1", seed=3)
        batch = (torch.ones(4, 3), torch.ones(4))
        same = inject.maybe_poison_batch(batch, step=1, rank=0)
        assert not torch.isnan(same[0]).any()
        poisoned = inject.maybe_poison_batch(batch, step=2, rank=0)
        assert int(torch.isnan(poisoned[0]).sum()) == 1
        assert not torch.isnan(batch[0]).any()  # the input is left alone
        # n=1 spent: the retried attempt at the same step is clean.
        clean = inject.maybe_poison_batch(batch, step=2, rank=0)
        assert not torch.isnan(clean[0]).any()

    def test_bitflip_flips_exactly_one_bit(self):
        chaos.plan("grad.bitflip:bitflip@step=1", seed=11)
        params = {"w": torch.ones(8, 4), "i": torch.arange(3)}
        out = inject.maybe_corrupt_params(params, step=1, rank=0)
        before = params["w"].numpy().view(np.uint8).reshape(-1)
        after = out["w"].numpy().view(np.uint8).reshape(-1)
        assert int(np.unpackbits(before ^ after).sum()) == 1
        assert torch.equal(out["i"], params["i"])

    def test_bitflip_is_seeded_deterministic(self):
        outs = []
        for _ in range(2):
            chaos.plan("grad.bitflip:bitflip@step=1", seed=11)
            out = inject.maybe_corrupt_params({"w": torch.ones(8, 4)},
                                              step=1, rank=0)
            outs.append(out["w"].clone())
            chaos.clear()
        assert torch.equal(outs[0], outs[1])

    def test_param_corrupt_perturbs_a_span(self):
        chaos.plan("param.corrupt:corrupt@step=1", seed=4)
        params = {"w": torch.ones(16)}
        out = inject.maybe_corrupt_params(params, step=1, rank=0)
        changed = out["w"] != params["w"]
        assert 1 <= int(changed.sum()) <= 8

    def test_rank_condition_gates_the_fault(self):
        chaos.plan("param.corrupt:corrupt@rank=1", seed=4)
        params = {"w": torch.ones(4)}
        assert inject.maybe_corrupt_params(params, step=1, rank=0) is params
        assert inject.maybe_corrupt_params(params, step=1, rank=1) \
            is not params

    @pytest.mark.parametrize("site", ["grad.nan", "grad.bitflip",
                                      "param.corrupt"])
    @pytest.mark.parametrize("seed", [0, 5, 11])
    def test_same_plan_picks_what_the_reference_picks(self, site, seed):
        rs = np.random.RandomState(seed)
        tree = {"a": rs.randn(5, 3).astype(np.float32),
                "b": rs.randn(7).astype(np.float32),
                "c": np.arange(4, dtype=np.int32)}
        action = site.split(".")[1]
        spec = f"{site}:{action}@step=1"
        ttree = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        chaos.plan(spec, seed=seed)
        jchaos.plan(spec, seed=seed)
        if site == "grad.nan":
            got = inject.maybe_poison_batch(ttree, step=1, rank=0)
            want = jinject.maybe_poison_batch(tree, step=1, rank=0)
        else:
            got = inject.maybe_corrupt_params(ttree, step=1, rank=0)
            want = jinject.maybe_corrupt_params(tree, step=1, rank=0)
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    def test_guarded_step_skips_injected_nan(self):
        chaos.plan("grad.nan:nan@step=2;n=1", seed=0)
        step, ts, rng = _mk(GuardConfig(audit_every=0))
        ts, _ = step(ts, _batch(rng))
        assert int(ts.guard.skipped) == 0
        ts2, _ = step(ts, _batch(rng))  # attempt 2: poisoned
        assert int(ts2.guard.skipped) == 1
        assert int(ts2.step) == int(ts.step)
        ts3, _ = step(ts2, _batch(rng))  # retry: rule spent, commits
        assert int(ts3.step) == int(ts.step) + 1
        assert chaos.fired == {"grad.nan": 1}

    def test_param_corrupt_lands_in_the_live_parameters(self):
        chaos.plan("param.corrupt:corrupt@step=1", seed=4)
        step, ts, rng = _mk(GuardConfig(audit_every=0))
        live = ts.params["w"]
        ts, _ = step(ts, _batch(rng))
        assert ts.params["w"] is live
        assert chaos.fired == {"param.corrupt": 1}
