"""The runtime's ParameterManager (``horovod_tpu_torch.native.autotune``)
against the JAX package's native one (``csrc/parameter_manager.{h,cc}``).

* ``GpTuner1D`` against the JAX package's ``hvt_tuner_*`` C ABI: the same
  scripted scores, the proposals equal within a relative 1e-12 (they come
  out bit for bit: the candidates are the C++'s own ``std::mt19937``
  stream), the best equal.
* The manager's rules under an injected clock and scripted byte counts:
  warm-up windows thrown away, idle cycles not counted, the stops after
  10 windows without improvement and at 40, the best knobs current once
  done, the log rows, and the first proposals against ones computed here
  from numpy's MT19937 words and the reference's formulas.
* A twin of ``tests/test_native_core.py::test_autotune_smoke`` on a gloo
  world of 2 of the port's runtime (``tests/torch_eager_ranks.py``).
* ``ops.layout.autotune_threshold`` driven by the port's tuner.
"""

import logging
import math

import numpy as np
import pytest

import torch_eager_ranks as R
from horovod_tpu_torch import native
from horovod_tpu_torch.native import autotune as A
from horovod_tpu_torch.native.runtime import Knobs
from horovod_tpu_torch.tune.gp import GaussianProcess, expected_improvement


def _score_bowl(x):
    """A smooth function of log bytes, best near 2**24.3."""
    lg = math.log2(x)
    return -(lg - 24.3) ** 2 + 0.1 * math.sin(3.0 * lg)


def _score_ramp(x):
    return math.log(x) + 3.0 * math.exp(-((math.log2(x) - 27.0) ** 2))


@pytest.fixture(scope="module")
def reference_lib():
    from horovod_tpu import native as ref_native

    return ref_native._load()


@pytest.mark.parametrize("lo,hi,score", [
    (1 << 20, 512 << 20, _score_bowl),
    (1 << 20, 512 << 20, _score_ramp),
    (64 << 10, 64 << 20, _score_bowl),
])
def test_gp_tuner_1d_matches_the_reference_c_abi(reference_lib, lo, hi,
                                                 score):
    lib = reference_lib
    ref = lib.hvt_tuner_create(float(lo), float(hi))
    try:
        port = A.GpTuner1D(lo, hi)
        for i in range(12):
            want = lib.hvt_tuner_propose(ref)
            got = port.propose()
            assert got == pytest.approx(want, rel=1e-12, abs=0), (i, got,
                                                                  want)
            # Both record the C ABI's proposal, as autotune_threshold does.
            t = float(int(want))
            lib.hvt_tuner_record(ref, t, score(t))
            port.record(t, score(t))
        assert port.best() == lib.hvt_tuner_best(ref)
        assert port.samples == 12
    finally:
        lib.hvt_tuner_destroy(ref)


def test_candidate_stream_is_std_mt19937():
    # std::mt19937's default seed (5489) gives 3499211612 first.
    assert A.mt19937(5489).getrandbits(32) == 3499211612
    words = np.random.RandomState(12345).randint(
        0, 2 ** 32, size=16, dtype=np.uint64).tolist()
    rng = A.mt19937(12345)
    assert [rng.getrandbits(32) for _ in range(16)] == words
    rng = A.mt19937(12345)
    assert A.uniform01(rng) == 0.8901547132827379
    assert A.uniform01(rng) == 0.13070729405534817


def test_normalize_clamps_and_denormalize_truncates():
    assert A.normalize(A.Params(1 << 20, 99)) == [0.0, 0.0]
    assert A.normalize(A.Params(1 << 40, 10 ** 9)) == [1.0, 1.0]
    assert A.normalize(A.Params(1 << 10, 1))[0] == 0.0
    p = A.denormalize([0.5, 0.5])
    assert p == A.Params(int(2.0 ** 24.5), int(math.exp(4.605 + 0.5 * (
        10.82 - 4.605))))
    assert isinstance(p.fusion_threshold_bytes, int)
    assert A.denormalize([0.0, 0.0]) == A.Params(1 << 20, 99)  # e^4.605


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _manager(tmp_path=None, warmup=1, steps=2, fusion=64 << 20, cycle=2000):
    clock = _Clock()
    pm = A.ParameterManager(clock=clock)
    pm.initialize(fusion, cycle, str(tmp_path / "at.log") if tmp_path
                  else "", warmup, steps)
    return pm, clock


def _window(pm, clock, nbytes, steps, secs=1.0, idle=0):
    """One sample window: ``idle`` idle cycles, then ``steps`` busy ones of
    ``nbytes / steps`` bytes, ``secs`` seconds on the clock."""
    closed = []
    for _ in range(idle):
        closed.append(pm.update(0))
    clock.t += secs
    for _ in range(steps):
        closed.append(pm.update(nbytes // steps))
    return closed


def _expected_proposal(xs, ys, y_best, words):
    """The reference's ``Propose`` from first principles: fit, 256
    candidates from the MT19937 words (libstdc++'s canonical doubles, the
    first coordinate first), EI argmax, denormalize."""
    gp = GaussianProcess()
    gp.fit(xs, ys)
    it = iter(words)

    def unif():
        a, b = next(it), next(it)
        return (float(a) + float(b) * 2.0 ** 32) / 2.0 ** 64

    best_ei, best_x = -1.0, (0.5, 0.5)
    for _ in range(256):
        x = (unif(), unif())
        mu, sd = gp.predict(x)
        if sd < 1e-12:
            continue
        ei = expected_improvement(mu, sd, y_best)
        if ei > best_ei:
            best_ei, best_x = ei, x
    return (int(2.0 ** (20.0 + best_x[0] * 9.0)),
            int(math.exp(4.605 + best_x[1] * (10.82 - 4.605))))


def test_warmup_windows_are_thrown_away_and_idle_cycles_do_not_count():
    pm, clock = _manager(warmup=2, steps=3)
    start = pm.current
    for _ in range(2):  # two warm-up windows: no point, no proposal
        closed = _window(pm, clock, 3000, 3, idle=5)
        assert closed == [False] * 7 + [True]
        assert pm.xs == [] and pm.current == start
    # Idle cycles alone never close a window.
    assert not any(pm.update(0) for _ in range(50))
    assert pm.steps_in_sample == 0
    _window(pm, clock, 6000, 3, secs=2.0)
    assert pm.ys == [3000.0] and pm.best == start
    assert pm.samples == [(64 << 20, 2000, 3000.0)]
    assert pm.current != start  # the first proposal


def test_first_proposals_follow_the_reference_stream():
    pm, clock = _manager(warmup=1, steps=2)
    words = np.random.RandomState(12345).randint(
        0, 2 ** 32, size=3 * 1024, dtype=np.uint64).tolist()
    _window(pm, clock, 100, 2)  # warm-up
    xs, ys = [], []
    for k, score in enumerate((1000.0, 1500.0, 700.0)):
        xs.append(A.normalize(pm.current))
        ys.append(score)
        _window(pm, clock, int(score), 2)
        want = _expected_proposal(xs, ys, max(ys),
                                  words[1024 * k:1024 * (k + 1)])
        assert tuple(pm.current) == want, k
    assert pm.best_score == 1500.0


def test_stops_after_ten_windows_without_improvement(tmp_path, caplog):
    pm, clock = _manager(tmp_path, warmup=1, steps=2)
    _window(pm, clock, 10, 2)  # warm-up
    scores = [5000] + [4000 - 10 * i for i in range(10)]
    tried = []
    with caplog.at_level(logging.INFO, logger="horovod_tpu_torch.native"):
        for s in scores:
            assert not pm.done
            tried.append(pm.current)
            _window(pm, clock, s, 2)
    assert pm.done and len(pm.xs) == 11
    assert pm.best == tried[0] and pm.current == pm.best
    assert not pm.update(10 ** 6)  # done: no more windows
    rows = (tmp_path / "at.log").read_text().splitlines()
    assert rows == [f"{p.fusion_threshold_bytes}\t{p.cycle_time_us}\t"
                    f"{float(s):g}\t{5000.0:g}" for p, s in zip(tried,
                                                                 scores)]
    assert rows[0] == "67108864\t2000\t5000\t5000"
    assert any(r.getMessage() == f"autotune converged: fusion={64 << 20} "
               "cycle_us=2000 score=5000 B/s" for r in caplog.records)


def test_stops_at_forty_windows():
    pm, clock = _manager(warmup=0, steps=1)
    for i in range(40):
        assert not pm.done
        _window(pm, clock, 1000 + 100 * i, 1)
    assert pm.done and len(pm.xs) == 40
    assert pm.samples_without_improvement == 0
    assert pm.current == pm.best == A.Params(*pm.samples[-1][:2])


def test_log_rows_use_cxx_default_double_format(tmp_path):
    pm, clock = _manager(tmp_path, warmup=0, steps=1)
    _window(pm, clock, 123456789, 1, secs=0.5)
    _window(pm, clock, 3, 1, secs=3.0)
    rows = (tmp_path / "at.log").read_text().splitlines()
    assert rows[0] == "67108864\t2000\t2.46914e+08\t2.46914e+08"
    assert rows[1].endswith("\t1\t2.46914e+08")


def test_inactive_manager_ignores_updates():
    pm = A.ParameterManager()
    assert not pm.update(1 << 30) and pm.xs == []


def test_knobs_read_the_three_prefixes(monkeypatch):
    for pre in ("HVT_", "HVDTPU_", "HOROVOD_"):
        for name in ("AUTOTUNE", "AUTOTUNE_LOG", "AUTOTUNE_WARMUP_SAMPLES",
                     "AUTOTUNE_STEPS_PER_SAMPLE"):
            monkeypatch.delenv(pre + name, raising=False)
    k = Knobs.from_env()
    assert (k.autotune, k.autotune_log, k.autotune_warmup_samples,
            k.autotune_steps_per_sample) == (False, "", 3, 10)
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HVT_AUTOTUNE_LOG", "/x.log")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "5")
    monkeypatch.setenv("HVT_AUTOTUNE_STEPS_PER_SAMPLE", "7")
    k = Knobs.from_env()
    assert (k.autotune, k.autotune_log, k.autotune_warmup_samples,
            k.autotune_steps_per_sample) == (True, "/x.log", 5, 7)


def test_autotune_best_before_init_and_at_world_one(monkeypatch, tmp_path):
    assert native.autotune_best() == (-1, -1, -1)
    monkeypatch.setenv("HVT_AUTOTUNE", "1")
    monkeypatch.setenv("HVT_AUTOTUNE_WARMUP_SAMPLES", "0")
    monkeypatch.setenv("HVT_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    monkeypatch.setenv("HVT_AUTOTUNE_LOG", str(tmp_path / "w1.log"))
    monkeypatch.setenv("HVT_FUSION_THRESHOLD", str(8 << 20))
    native.init(0, 1, device="cpu")
    try:
        assert native.autotune_best() == (8 << 20, 1000, 0)
        rt = native.get_runtime()
        import torch

        for step in range(6):
            out = native.allreduce(torch.full((16,), float(step)),
                                   name="w1")
            assert torch.equal(out, torch.full((16,), float(step)))
        assert len(rt.autotune.samples) == 6
        best = native.autotune_best()
        assert best[2] == 0 and best[0] > 0 and best[1] > 0
        # The proposals reached the controller: the idle pause and the
        # fusion take the tuned knobs.
        assert (rt.controller.fusion_threshold,
                rt.controller.cycle_time_us) == tuple(rt.autotune.current)
    finally:
        native.shutdown()
    assert native.autotune_best() == (-1, -1, -1)
    assert len((tmp_path / "w1.log").read_text().splitlines()) == 6


@pytest.fixture(scope="module")
def autotune_world(tmp_path_factory):
    log = tmp_path_factory.mktemp("autotune") / "rows.log"
    world = R.shared(
        tmp_path_factory, "native_port_autotune",
        lambda: R.run_world("port", "autotune", 2, extra_env={
            "HVT_AUTOTUNE": "1", "HVT_AUTOTUNE_WARMUP_SAMPLES": "1",
            "HVT_AUTOTUNE_STEPS_PER_SAMPLE": "2",
            "HVT_AUTOTUNE_LOG": str(log)}))
    return world, log


def test_world_of_two_tunes_in_lockstep(autotune_world):
    world, log = autotune_world
    r0, r1 = (w["c_autotune"] for w in world)
    # It completes and the sums are right.
    for r in (r0, r1):
        np.testing.assert_array_equal(r["sums"], np.full((30, 10, 64), 2.0))
    # Both ranks applied the same knobs at the same negotiations, and the
    # manager moved them away from the starting ones.
    np.testing.assert_array_equal(r0["applied"], r1["applied"])
    assert tuple(r0["applied"][0][1:]) == (R.FUSION_THRESHOLD, 1000)
    assert len(r0["applied"]) > 1
    # Rank 0's manager answers; rank 1's holds the starting knobs.
    fusion, cycle, done = r0["best"].tolist()
    assert fusion > 0 and cycle > 0 and done in (0, 1)
    assert r1["best"].tolist() == [R.FUSION_THRESHOLD, 1000, 0]
    assert len(r0["samples"]) > 0 and len(r1["samples"]) == 0
    rows = open(log).read().splitlines()
    assert len(rows) == len(r0["samples"])
    for row, (f, c, score) in zip(rows, r0["samples"]):
        assert row.split("\t")[:3] == [str(int(f)), str(int(c)),
                                       f"{score:g}"]


def test_autotune_threshold_uses_the_port_tuner(reference_lib):
    from horovod_tpu.ops import layout as ref_layout
    from horovod_tpu_torch.ops.layout import autotune_threshold

    seen_port, seen_ref = [], []

    def measure(seen):
        def fn(t):
            seen.append(t)
            return _score_bowl(t)
        return fn

    got = autotune_threshold(measure(seen_port), max_samples=10)
    want = ref_layout.autotune_threshold(measure(seen_ref), max_samples=10)
    assert seen_port == seen_ref and got == want
