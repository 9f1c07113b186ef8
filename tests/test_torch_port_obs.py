"""The port's metrics plane held against the JAX package's, and the twins of
tests/test_obs.py.

Parity: the same observations give both registries the same histogram
summaries; both exporters write the same JSON-lines keys and Prometheus
names, and each package's ``hvdtpu_top`` reads the other's files. The
slice: GPT-2 tiny trained by the port's ``make_train_step(sharded=True,
fused_update=True)`` with the metrics, trace and goodput planes on, beside
the JAX package's instrumented step on the same weights and batches --
equal losses (the tolerance of test_torch_port_train.py), the same set of
metric names, equal step and token counts, a conserving ledger, and
parameters bit for bit those of the planes-off run; on a gloo world of 2
the rank-0 summary fires on the same step on both ranks. Serving: a
``ServePool`` and a ``DecodeEngine`` count every request, stream and token
with the metrics on and answer as with them off.

Not ported here (they wait for the eager path, ROADMAP A16): the eager
collectives' latency metrics, the stall inspector's gauges and warnings
and the native-runtime bridge (four tests of test_obs.py); the env-var
lint stays the JAX package's own test.
"""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.obs import export as jexport
from horovod_tpu.obs import goodput as jgoodput
from horovod_tpu.obs import registry as jreg
from horovod_tpu.obs import trace as jtrace
from horovod_tpu_torch import obs
from horovod_tpu_torch.obs import export as exp_mod
from horovod_tpu_torch.obs import goodput
from horovod_tpu_torch.obs import registry as reg_mod
from horovod_tpu_torch.obs import trace
from horovod_tpu_torch.tools import hvdtpu_top as top

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reset_all():
    for reg in (reg_mod, jreg):
        reg._registry.reset()
        reg._enabled = None
    for mod in (trace, jtrace, goodput, jgoodput):
        mod._reset_for_tests()


@pytest.fixture(autouse=True)
def _planes_reset(monkeypatch):
    """Every test starts and ends with both packages' planes off and a
    fresh reporter."""
    _reset_all()
    monkeypatch.setattr(exp_mod, "_reporter", None)
    monkeypatch.setattr(jexport, "_reporter", None)
    yield
    _reset_all()


@pytest.fixture
def metrics_env(tmp_path, monkeypatch):
    """Enable the metrics plane into a scratch dir."""
    monkeypatch.setenv("HVDTPU_METRICS", "1")
    monkeypatch.setenv("HVDTPU_METRICS_DIR", str(tmp_path))
    monkeypatch.setenv("HVDTPU_METRICS_INTERVAL", "0.01")
    yield tmp_path


def _sgd(lr):
    from horovod_tpu_torch.optimizer import Optimizer

    def update(g, s, p=None):
        return {k: -lr * v for k, v in g.items()}, s

    return Optimizer(lambda p: (), update)


def _mse(params, batch):
    x, y = batch
    return ((x @ params["w"] - y) ** 2).mean()


# ---- registry --------------------------------------------------------------


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("HVDTPU_METRICS", raising=False)
    assert not obs.enabled()
    c = obs.metrics().counter("never")
    c.inc(5)
    assert c.get() == 0.0
    assert "never" not in reg_mod._registry.snapshot()["counters"]


def test_counter_gauge_histogram(metrics_env):
    reg = obs.metrics()
    c = reg.counter("c")
    c.inc()
    c.inc(9)
    assert c.get() == 10
    g = reg.gauge("g")
    g.set(2.5)
    g.add(0.5)
    assert g.get() == 3.0
    h = reg.histogram("h")
    for v in range(1, 101):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 100
    assert (s["p50"], s["p95"], s["p99"], s["max"]) == (50.0, 95.0, 99.0,
                                                        100.0)
    assert abs(s["mean"] - 50.5) < 1e-9


def test_histogram_ring_bounds_memory(metrics_env):
    h = obs.metrics().histogram("ring", window=8)
    for v in range(1000):
        h.observe(float(v))
    assert len(h._buf) == 8
    s = h.summary()
    assert s["count"] == 1000
    assert s["p50"] >= 992.0


def test_registry_thread_safety(metrics_env):
    reg = obs.metrics()

    def work(k):
        for i in range(500):
            reg.counter(f"t.{k}").inc()
            reg.histogram("t.h").observe(i)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = reg.snapshot()
    assert all(snap["counters"][f"t.{k}"] == 500 for k in range(4))
    assert snap["histograms"]["t.h"]["count"] == 2000


@pytest.mark.parametrize("window", [8, 64, 512])
def test_histogram_percentiles_equal_the_reference(window):
    """The same seeded observations, past the ring's window: the same
    count, mean, percentiles and max in both registries."""
    rng = np.random.RandomState(window)
    vals = rng.lognormal(size=3 * window + 5)
    port = reg_mod.MetricsRegistry().histogram("h", window=window)
    ref = jreg.MetricsRegistry().histogram("h", window=window)
    for v in vals:
        port.observe(float(v))
        ref.observe(float(v))
    assert port.summary() == ref.summary()


# ---- exporters -------------------------------------------------------------


def test_jsonl_and_prom_export(metrics_env):
    reg = obs.metrics()
    reg.counter("exp.c").inc(7)
    reg.gauge("exp.g").set(1.25)
    reg.histogram("exp.h").observe(3.0)
    reg.event("exp.ev", detail="x")
    rep = exp_mod.MetricsReporter(directory=str(metrics_env))
    rec = rep.flush()
    lines = open(rep.jsonl_path()).read().splitlines()
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert parsed["counters"]["exp.c"] == 7
    assert parsed["gauges"]["exp.g"] == 1.25
    assert parsed["histograms"]["exp.h"]["count"] == 1
    assert parsed["events"][0]["kind"] == "exp.ev"
    assert {"ts", "rank", "world"} <= set(parsed)
    rec2 = rep.flush()
    assert rec2["events"] == []
    prom = open(rep.prom_path()).read()
    assert "# TYPE hvdtpu_exp_c counter" in prom
    assert 'hvdtpu_exp_c{rank="0"} 7' in prom
    assert 'hvdtpu_exp_g{rank="0"} 1.25' in prom
    assert 'hvdtpu_exp_h_p50{rank="0"}' in prom
    assert rec["ts"] <= rec2["ts"]


def test_jsonl_keys_and_prom_names_match_the_reference(tmp_path,
                                                       monkeypatch):
    """One set of instruments exported by each package's reporter: the
    same record keys, histogram fields and Prometheus lines (the values
    of the timestamp aside)."""
    monkeypatch.setenv("HVDTPU_METRICS", "1")
    outs = {}
    for name, reg, exp in (("port", reg_mod, exp_mod),
                           ("ref", jreg, jexport)):
        m = reg.metrics()
        m.counter("step.count").inc(3)
        m.gauge("serve.in_flight.w0").set(2.0)
        m.histogram("step.total_ms").observe(12.5)
        m.histogram("never.observed")
        m.event("elastic.rescale", round=1)
        d = tmp_path / name
        rep = exp.MetricsReporter(directory=str(d), role="job")
        rep.flush(summarize=False)
        rec = json.loads(open(rep.jsonl_path()).read().splitlines()[-1])
        prom = open(rep.prom_path()).read().splitlines()
        outs[name] = (rec, prom)
    (prec, pprom), (rrec, rprom) = outs["port"], outs["ref"]
    # Where either package's runtime ran in this process (a test before
    # this one started it), its exports carry the runtime's native.*
    # counters too (their names are held in test_torch_port_native.py).
    for rec in (prec, rrec):
        for sec in ("counters", "gauges"):
            rec[sec] = {k: v for k, v in rec[sec].items()
                        if not k.startswith("native.")}
    rprom = [line for line in rprom if "hvdtpu_native_" not in line]
    pprom = [line for line in pprom if "hvdtpu_native_" not in line]
    assert set(prec) == set(rrec)
    for sec in ("counters", "gauges", "histograms"):
        assert prec[sec] == rrec[sec], sec
    assert [set(e) for e in prec["events"]] == [set(e) for e in
                                                rrec["events"]]
    assert pprom == rprom


def test_each_package_top_reads_the_others_export(metrics_env):
    reg = obs.metrics()
    reg.counter("step.count").inc(10)
    reg.counter("step.tokens").inc(1000)
    reg.gauge("step.mfu").set(0.25)
    reg.histogram("step.total_ms").observe(100.0)
    exp_mod.MetricsReporter(directory=str(metrics_env)).flush()
    reg.counter("step.count").inc(10)
    reg.counter("step.tokens").inc(1000)
    exp_mod.MetricsReporter(directory=str(metrics_env)).flush()
    rows, _ = top.collect(str(metrics_env))
    ref_rows, _ = _reference_tool("hvdtpu_top").collect(str(metrics_env))
    # Equal but for "age", the seconds since the file was written.
    assert [dict(r, age=None) for r in rows] == [
        dict(r, age=None) for r in ref_rows]
    assert rows[0]["steps"] == 20 and rows[0]["mfu"] == 0.25


def test_reporter_role_stem(metrics_env):
    rep = exp_mod.MetricsReporter(directory=str(metrics_env), role="driver")
    rep.flush()
    assert os.path.exists(os.path.join(str(metrics_env), "driver.jsonl"))
    assert os.path.exists(os.path.join(str(metrics_env), "driver.prom"))


def test_flush_noop_when_disabled(tmp_path, monkeypatch):
    monkeypatch.delenv("HVDTPU_METRICS", raising=False)
    rep = exp_mod.MetricsReporter(directory=str(tmp_path))
    assert rep.flush() is None
    assert list(tmp_path.iterdir()) == []


def test_empty_histogram_exports_strict_json(metrics_env):
    obs.metrics().histogram("never.observed")
    rec = obs.flush()
    assert rec["histograms"]["never.observed"]["count"] == 0
    assert rec["histograms"]["never.observed"]["p50"] is None
    text = open(exp_mod.reporter().jsonl_path()).read()
    assert "NaN" not in text
    json.loads(text.splitlines()[-1])
    prom = open(exp_mod.reporter().prom_path()).read()
    assert 'hvdtpu_never_observed_p50{rank="0"} NaN' in prom


# ---- instrumented layers ---------------------------------------------------


def test_train_step_breakdown_and_fusion_gauges(metrics_env):
    step, opt = __import__("horovod_tpu_torch").make_train_step(
        _mse, _sgd(0.01), tokens_per_step=64, flops_per_step=1e6,
        device="cpu")
    from horovod_tpu_torch.parallel import dp

    state = dp.init_state({"w": torch.ones(4, 2)}, opt)
    batch = (torch.ones(8, 4), torch.zeros(8, 2))
    for _ in range(3):
        state, _loss = step(state, batch)
    snap = obs.metrics().snapshot()
    assert snap["counters"]["step.count"] == 3
    assert snap["counters"]["step.tokens"] == 192
    for h in ("step.total_ms", "step.host_dispatch_ms", "step.device_ms"):
        assert snap["histograms"][h]["count"] == 3
    assert snap["gauges"]["step.tokens_per_sec"] > 0
    # One fp32 bucket of 4*2 elements: 32 bytes a step.
    assert snap["gauges"]["fusion.allreduce.bytes_per_step"] == 32.0
    assert snap["gauges"]["fusion.allreduce.buckets"] == 1.0
    assert snap["gauges"]["optimizer.grad_bytes_per_step"] == 32.0
    # The CPU has no known peak: no MFU is claimed.
    assert "step.mfu" not in snap["gauges"]
    files = [f for f in os.listdir(str(metrics_env)) if f.endswith(".jsonl")]
    assert files


def test_enable_after_step_built(tmp_path, monkeypatch):
    monkeypatch.delenv("HVDTPU_METRICS", raising=False)
    monkeypatch.setenv("HVDTPU_METRICS_DIR", str(tmp_path))
    from horovod_tpu_torch.parallel import dp

    step, opt = dp.make_train_step(_mse, _sgd(0.01), device="cpu")
    state = dp.init_state({"w": torch.ones(4, 2)}, opt)
    batch = (torch.ones(8, 4), torch.zeros(8, 2))
    state, _ = step(state, batch)
    assert obs.metrics().snapshot()["counters"] == {}
    obs.enable()
    state, _ = step(state, batch)
    assert obs.metrics().snapshot()["counters"]["step.count"] == 1
    obs.disable()
    state, _ = step(state, batch)
    assert reg_mod._registry.snapshot()["counters"]["step.count"] == 1


def test_pack_unpack_timed(metrics_env):
    from horovod_tpu_torch.ops import fusion

    bufs, spec = fusion.pack({"a": torch.ones(8), "b": torch.ones(3)})
    fusion.unpack(bufs, spec)
    snap = obs.metrics().snapshot()
    assert snap["histograms"]["fusion.pack_ms"]["count"] == 1
    assert snap["histograms"]["fusion.unpack_ms"]["count"] == 1


def test_elastic_blacklist_event(metrics_env, monkeypatch):
    from horovod_tpu_torch.runner import elastic_driver
    from horovod_tpu_torch.runner.elastic_driver import (
        FixedHosts,
        HostManager,
    )

    monkeypatch.setattr(elastic_driver, "_driver_rep", None)
    hm = HostManager(FixedHosts({"a": 1, "b": 1}))
    hm.update_available_hosts()
    hm.blacklist("b")
    assert hm.current_hosts == {"a": 1}
    assert hm.blacklist_events == 1
    snap = obs.metrics().snapshot()
    assert snap["counters"]["elastic.blacklist_events"] == 1
    assert snap["gauges"]["elastic.blacklisted_hosts"] == 1.0
    rec = json.loads(
        open(os.path.join(str(metrics_env), "driver.jsonl")).read()
        .splitlines()[-1]
    )
    assert any(e["kind"] == "elastic.blacklist" and e["host"] == "b"
               for e in rec["events"])
    assert obs.metrics().drain_events() == []


def test_overlap_pair_sets_the_reference_gauges(monkeypatch):
    """``record_overlap_pair`` sets the same ``overlap.*`` gauges, to the
    same values, in either package."""
    from horovod_tpu.obs import overlap as joverlap
    from horovod_tpu_torch.obs import overlap

    monkeypatch.setenv("HVDTPU_METRICS", "1")
    got = overlap.record_overlap_pair(80.0, 100.0, comm_ms_total=30.0)
    want = joverlap.record_overlap_pair(80.0, 100.0, comm_ms_total=30.0)
    assert got == want
    pg = reg_mod.metrics().snapshot()["gauges"]
    rg = jreg.metrics().snapshot()["gauges"]
    # compute = 100 - 30, exposed = 80 - 70: 10 of 30 ms still exposed.
    assert pg == rg and pg["overlap.efficiency"] == pytest.approx(2 / 3)


def test_checkpoint_and_prefetch_feed_the_planes(metrics_env, tmp_path):
    from horovod_tpu_torch import checkpoint as ckptlib
    from horovod_tpu_torch.data import prefetch_to_device

    goodput.enable()
    trace.enable(directory=str(tmp_path / "trace"))
    ckptlib.save_checkpoint(str(tmp_path / "ck"), {"w": torch.ones(3)},
                            step=1, force=True)
    batches = list(prefetch_to_device(
        iter([np.ones(2, np.float32)] * 3), depth=2, device="cpu"))
    assert len(batches) == 3
    snap = obs.metrics().snapshot()
    assert snap["counters"]["ckpt.saves"] == 1
    assert snap["counters"]["prefetch.batches"] == 3
    assert snap["gauges"]["prefetch.depth"] == 2.0
    totals = goodput.ledger().totals()
    assert totals["checkpoint"] > 0 and totals["input_stall"] > 0
    fills = [e for e in trace.recorder()._ring if e["name"] == "prefetch.fill"]
    assert fills and fills[0]["args"]["stalled"] is True


def test_chaos_fire_counts_and_marks_the_trace(metrics_env, tmp_path):
    from horovod_tpu_torch import chaos

    trace.enable(directory=str(tmp_path))
    chaos._reset_for_tests()
    try:
        chaos.plan("worker.step:delay=0.001@n=1")
        chaos.act("worker.step", step=1)
        assert chaos.fired == {"worker.step": 1}
    finally:
        chaos._reset_for_tests()
    snap = obs.metrics().snapshot()
    assert snap["counters"]["chaos.fired.worker.step"] == 1
    assert any(e["name"] == "chaos.worker.step" for e in
               trace.recorder()._ring)


# ---- the timeline ----------------------------------------------------------


def test_timeline_stop_drains_queue(tmp_path):
    from horovod_tpu_torch.utils.timeline import Timeline

    path = str(tmp_path / "tl.json")
    tl = Timeline(path)
    tl.start(path)
    n = 500
    for i in range(n):
        tl.instant("tensor", f"ev{i}")
    tl.stop()
    data = json.loads(open(path).read())
    names = {r.get("name") for r in data}
    assert {f"ev{i}" for i in range(n)} <= names
    tl.stop()


def test_timeline_stop_without_start():
    from horovod_tpu_torch.utils.timeline import Timeline

    Timeline().stop()


def test_timeline_records_the_bucket_layout_and_the_torch_profiler(
        tmp_path, monkeypatch):
    """With the timeline on, a fused reduction leaves its FUSE_BUCKETS
    layout and one activity per bucket; the device half is a
    torch.profiler Chrome trace written beside it."""
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.utils import timeline as tlmod

    path = str(tmp_path / "tl.json")
    monkeypatch.setattr(tlmod, "_global_timeline", None)
    tlmod.start_timeline(path)
    tlmod.start_torch_profiler(tlmod.profiler_path(path))
    try:
        fusion.fused_allreduce({"a": torch.ones(8), "b": torch.ones(3)})
    finally:
        prof = tlmod.stop_torch_profiler()
        tlmod.stop_timeline()
        monkeypatch.setattr(tlmod, "_global_timeline", None)
    recs = json.loads(open(path).read())
    fuse = [r for r in recs if r.get("name") == "FUSE_BUCKETS"]
    assert fuse and fuse[0]["args"]["n_tensors"] == 2
    assert any(r.get("name") == tlmod.DIST_ALLREDUCE for r in recs)
    assert prof == path + ".torch.json"
    assert json.load(open(prof))["traceEvents"]


# ---- hvdtpu_top ------------------------------------------------------------


def _write_jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def test_hvdtpu_top_rates_and_render(tmp_path):
    base = {
        "world": 2,
        "gauges": {"step.mfu": 0.42, "stall.pending": 0.0,
                   "fusion.allreduce.bytes_per_step": 1048576.0},
        "histograms": {"step.total_ms": {"p50": 100.0, "p95": 120.0},
                       "step.host_dispatch_ms": {"p50": 2.0}},
        "events": [],
    }
    for rank in (0, 1):
        _write_jsonl(
            tmp_path / f"rank{rank}.jsonl",
            [
                {**base, "ts": 1000.0, "rank": rank,
                 "counters": {"step.count": 10, "step.tokens": 1000,
                              "eager.bytes": 0,
                              "native.cache_hits": 90,
                              "native.cache_misses": 10}},
                {**base, "ts": 1010.0, "rank": rank,
                 "counters": {"step.count": 110, "step.tokens": 11000,
                              "eager.bytes": 4096,
                              "native.cache_hits": 190,
                              "native.cache_misses": 10},
                 "events": [{"ts": 1009.0, "kind": "elastic.rescale",
                             "round": 1}]},
            ],
        )
    rows, events = top.collect(str(tmp_path))
    assert len(rows) == 2
    r0 = rows[0]
    assert r0["who"] == "rank0"
    assert r0["steps"] == 110
    assert r0["steps_s"] == pytest.approx(10.0)
    assert r0["tok_s"] == pytest.approx(1000.0)
    assert r0["mfu"] == 0.42
    assert r0["cache"] == pytest.approx(0.95)
    assert r0["eager_bs"] == pytest.approx(409.6)
    assert len(events) == 2
    out = top.render(rows, events, str(tmp_path))
    assert "rank0" in out and "rank1" in out
    assert "elastic.rescale" in out
    assert "0.420" in out
    assert top.main(["--dir", str(tmp_path), "--once"]) == 0
    assert top.main(["--dir", str(tmp_path / "empty"), "--once"]) == 1


def test_hvdtpu_top_tail_torn_line(tmp_path):
    p = tmp_path / "rank0.jsonl"
    with open(p, "w") as f:
        f.write(json.dumps({"ts": 1.0, "counters": {}, "gauges": {},
                            "histograms": {}}) + "\n")
        f.write('{"ts": 2.0, "counters": {"x"')
    recs = top._tail_records(str(p))
    assert len(recs) == 1 and recs[0]["ts"] == 1.0


# ---- the slice: GPT-2 tiny instrumented, against the reference ----------------


STEPS = 3
LR = 1e-2
TOKENS = 4 * 32


def _gpt2_data():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import gpt2 as jgpt2

    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, use_flash=False)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)
    params = jgpt2.GPT2LMModel(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:1, :32]))["params"]
    return jax.tree.map(np.asarray, params), tokens


def _port_gpt2(params, tokens, steps=STEPS):
    from horovod_tpu_torch import convert
    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
    from horovod_tpu_torch.parallel import dp

    cfg = GPT2Config.tiny(dtype=torch.float32, use_flash=False)
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax({"params": params}))

    def loss_fn(p, t):
        logits = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

    step, opt = dp.make_train_step(
        loss_fn, topt.fused_adamw(LR), sharded=True, fused_update=True,
        device="cpu", tokens_per_step=TOKENS, flops_per_step=1e9)
    state = dp.init_state(model, opt)
    batch = torch.from_numpy(tokens).long()
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    params_out = {k: v.detach().clone() for k, v in state.params.items()}
    return losses, params_out


def _reference_gpt2(params, tokens):
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd
    from horovod_tpu.models import gpt2 as jgpt2
    from horovod_tpu.optimizer import fused_adamw as jax_fused_adamw
    from horovod_tpu.parallel import dp as jdp

    hvd.init(devices=jax.devices("cpu")[:1])
    try:
        cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, use_flash=False)
        model = jgpt2.GPT2LMModel(cfg)

        def loss_fn(p, batch):
            (t,) = batch
            logits = model.apply({"params": p}, t[:, :-1])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, t[:, 1:]).mean()

        step, opt = jdp.make_train_step(
            loss_fn, jax_fused_adamw(LR), sharded=True, fused_update=True,
            tokens_per_step=TOKENS, flops_per_step=1e9)
        state = jdp.init_state(jax.tree.map(jnp.array, params), opt)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, (jnp.asarray(tokens),))
            losses.append(float(loss))
        return losses
    finally:
        hvd.shutdown()


def _arm_planes(monkeypatch, tmp_path):
    monkeypatch.setenv("HVDTPU_METRICS", "1")
    monkeypatch.setenv("HVDTPU_TRACE", "1")
    monkeypatch.setenv("HVDTPU_GOODPUT", "1")
    monkeypatch.setenv("HVDTPU_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("HVDTPU_TRACE_DIR", str(tmp_path / "trace"))


def test_instrumented_gpt2_tiny_matches_the_reference(tmp_path,
                                                      monkeypatch):
    params, tokens = _gpt2_data()
    _arm_planes(monkeypatch, tmp_path)
    want = _reference_gpt2(params, tokens)
    got, _ = _port_gpt2(params, tokens)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert got[-1] < got[0]
    ps, rs = reg_mod.metrics().snapshot(), jreg.metrics().snapshot()
    # The same names in every section. The trace counters differ in value
    # only: the JAX package counts traces (fusion.traces,
    # optimizer.reduce_traces), the eager port calls.
    for sec in ("counters", "gauges", "histograms"):
        assert set(ps[sec]) == set(rs[sec]), (
            sec, set(ps[sec]) ^ set(rs[sec]))
    for name in ("step.count", "step.tokens"):
        assert ps["counters"][name] == rs["counters"][name]
    assert ps["counters"]["step.count"] == STEPS
    assert ps["counters"]["step.tokens"] == STEPS * TOKENS
    for h in ("step.total_ms", "step.host_dispatch_ms", "step.device_ms"):
        assert ps["histograms"][h]["count"] == STEPS
    snap = goodput.ledger().snapshot()
    assert abs(sum(snap["totals"].values()) - snap["elapsed_s"]) < 1e-6
    assert snap["totals"]["host_dispatch"] > 0
    spans = [e["name"] for e in trace.recorder()._ring if e["cat"] == "train"]
    assert spans.count("step") == STEPS
    assert spans.count("step.host_dispatch") == STEPS
    assert spans.count("step.device") == STEPS


def test_planes_on_are_bit_for_bit_the_planes_off(tmp_path, monkeypatch):
    params, tokens = _gpt2_data()
    losses_off, off = _port_gpt2(params, tokens)
    assert reg_mod._registry.snapshot()["counters"] == {}
    _arm_planes(monkeypatch, tmp_path)
    _reset_all()
    losses_on, on = _port_gpt2(params, tokens)
    assert reg_mod.metrics().snapshot()["counters"]["step.count"] == STEPS
    assert losses_on == losses_off
    assert sorted(on) == sorted(off)
    for name in off:
        assert torch.equal(on[name], off[name]), name


def test_rank0_summary_fires_on_the_same_step_on_both_ranks(tmp_path,
                                                            monkeypatch):
    from horovod_tpu_torch import context

    import torch_obs_ranks

    monkeypatch.setenv("HVDTPU_METRICS", "1")
    monkeypatch.setenv("HVDTPU_METRICS_DIR", str(tmp_path))
    monkeypatch.setenv("HVDTPU_METRICS_SUMMARY_STEPS", "2")
    r0, r1 = context.spawn_gloo(2, torch_obs_ranks.summary_lockstep, 5)
    assert r0["enabled"] and r1["enabled"]
    assert r0["summary_steps"] == r1["summary_steps"] == [2, 4]
    assert r0["count"] == r1["count"] == 5
    assert torch.equal(r0["w"], r1["w"])
    assert sorted(os.listdir(tmp_path)) == [
        "rank0.jsonl", "rank0.prom", "rank1.jsonl", "rank1.prom"]


# ---- serving ---------------------------------------------------------------


def _gpt2_pool(**kw):
    from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
    from horovod_tpu_torch.serve import ServePool

    torch.manual_seed(0)
    model = GPT2LMModel(GPT2Config.tiny(dtype=torch.float32,
                                        use_flash=False), device="cpu")

    def infer(m, batch):
        return m(batch.long())[:, -1].argmax(-1)

    return ServePool(infer, model, workers=2, batch_size=4,
                     batch_timeout_ms=2.0, device="cpu", **kw).start()


def _serve(requests):
    pool = _gpt2_pool()
    try:
        futs = [pool.submit(r) for r in requests]
        return [int(f.result(timeout=60.0)) for f in futs]
    finally:
        pool.stop()


def test_serve_pool_metrics_count_every_request(metrics_env):
    rng = np.random.RandomState(0)
    requests = [torch.from_numpy(rng.randint(0, 256, 16)) for _ in range(16)]
    obs.disable()
    off = _serve(requests)
    obs.enable()
    on = _serve(requests)
    assert on == off
    snap = obs.metrics().snapshot()
    assert snap["counters"]["serve.requests"] == 16
    assert snap["counters"]["serve.responses"] == 16
    assert snap["histograms"]["serve.request_ms"]["count"] == 16
    assert snap["counters"]["serve.batches"] >= 4
    assert snap["gauges"]["serve.weight_bits"] == 0.0
    assert snap["gauges"]["serve.in_flight"] == 0.0


def test_decode_engine_metrics_count_streams_and_tokens(metrics_env):
    from horovod_tpu_torch.serve import CacheLM, CacheLMConfig, DecodeEngine

    cfg = CacheLMConfig(vocab=32, n_layers=2, n_heads=2, head_dim=8,
                        max_positions=256)
    model = CacheLM(cfg, block_size=8)
    params = model.init_params(0, device="cpu")
    prompts = [[1 + i, 2, 3 + i % 5] for i in range(6)]

    def run():
        eng = DecodeEngine(model, params, device="cpu", workers=1, rows=2,
                           kv_blocks=32, kv_block_size=8, max_seq_len=64)
        eng.start()
        try:
            futs = [eng.submit(p, 5) for p in prompts]
            return [f.result(timeout=60.0) for f in futs]
        finally:
            eng.stop()

    obs.disable()
    off = run()
    obs.enable()
    on = run()
    assert on == off
    n_tokens = sum(len(t) for t in on)
    snap = obs.metrics().snapshot()
    assert snap["counters"]["serve.decode.streams"] == len(prompts)
    assert snap["counters"]["serve.decode.finished"] == len(prompts)
    # The decode rounds' tokens: each stream's first token comes from its
    # prefill, which the counter leaves out, as the JAX package's does.
    assert snap["counters"]["serve.decode.tokens"] == n_tokens - len(prompts)
    assert snap["histograms"]["serve.decode.ttft_ms"]["count"] == len(prompts)
    assert (snap["histograms"]["serve.decode.ttft_ms"]["count"]
            + snap["histograms"]["serve.decode.tpot_ms"]["count"]) == n_tokens
    assert "serve.decode.kv_occupancy" in snap["gauges"]
