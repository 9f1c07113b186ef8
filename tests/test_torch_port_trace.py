"""The port's trace plane and flight recorder held against the JAX
package's: the dumps of either package merge alike under either package's
``hvdtpu_trace`` (clock skew included), and the twins of tests/test_trace.py
hold the port's off-path guarantees, ring eviction, open-span dumps, schema,
merge, timeline mirror, atomic Prometheus publish, metric-name lint and the
seeded-hang evidence chain of the port's soak.

Not ported here: the stall inspector's shutdown-breach dump, which waits
for the eager path (ROADMAP A16).
"""

import importlib.util
import json
import os
import threading
import time

import pytest

from horovod_tpu_torch.obs import export as exp_mod
from horovod_tpu_torch.obs import registry as reg_mod
from horovod_tpu_torch.obs import trace as trace_mod
from horovod_tpu_torch.tools import check_metric_names as ml
from horovod_tpu_torch.tools import hvdtpu_trace as ht

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _planes_reset():
    """Every test starts and ends with the process-global planes off."""
    trace_mod._reset_for_tests()
    reg_mod._registry.reset()
    reg_mod._enabled = None
    yield
    trace_mod._reset_for_tests()
    reg_mod._registry.reset()
    reg_mod._enabled = None


@pytest.fixture
def trace_env(tmp_path):
    """Arm the trace plane into a scratch dir."""
    rec = trace_mod.enable(directory=str(tmp_path), capacity=64)
    yield trace_mod, rec, tmp_path


# ---- off-path guarantees -------------------------------------------------


def test_disabled_by_default_and_truly_noop(monkeypatch):
    trace = trace_mod
    monkeypatch.delenv("HVDTPU_TRACE", raising=False)
    trace._reset_for_tests()
    assert not trace.enabled()
    s1 = trace.span("a", "train", step=1)
    s2 = trace.span("b", "serve")
    assert s1 is s2 is trace._NULL_SPAN
    with s1:
        pass
    trace.instant("x", cat="chaos", args={"k": 1})
    trace.complete("y", "train", time.time(), 0.01)
    trace.clock_sync(123.0)
    assert trace.flight_dump("nope") is None
    assert trace._recorder is None


def test_env_arming(monkeypatch, tmp_path):
    trace = trace_mod
    monkeypatch.setenv("HVDTPU_TRACE", "1")
    monkeypatch.setenv("HVDTPU_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("HVDTPU_TRACE_BUFFER", "32")
    trace._reset_for_tests()
    assert trace.enabled()
    with trace.span("s", "train"):
        pass
    assert trace.recorder().capacity == 32
    path = trace.flight_dump("env")
    assert path is not None and path.startswith(str(tmp_path))


# ---- ring semantics ------------------------------------------------------


def test_ring_eviction_order(tmp_path):
    trace = trace_mod
    trace.enable(directory=str(tmp_path), capacity=8)
    for i in range(12):
        trace.instant(f"ev{i}", cat="app")
    path = trace.flight_dump("evict")
    events = json.load(open(path))["traceEvents"]
    names = [e["name"] for e in events if e["name"].startswith("ev")]
    assert names == [f"ev{i}" for i in range(4, 12)]


def test_open_span_dumped_as_begin_event(trace_env):
    trace, rec, tmp_path = trace_env
    span = trace.span("worker.step", cat="elastic", step=3)
    span.__enter__()
    path = trace.flight_dump("mid_hang")
    events = json.load(open(path))["traceEvents"]
    open_spans = [
        e for e in events if e["ph"] == "B" and e["name"] == "worker.step"
    ]
    assert len(open_spans) == 1
    assert open_spans[0]["args"]["step"] == 3
    span.__exit__(None, None, None)
    path = trace.flight_dump("after")
    events = json.load(open(path))["traceEvents"]
    assert not [e for e in events if e["ph"] == "B"]
    done = [
        e for e in events if e["ph"] == "X" and e["name"] == "worker.step"
    ]
    assert len(done) == 1 and done[0]["dur"] >= 0


def test_dump_schema_valid_and_reasons_accumulate(trace_env):
    trace, rec, tmp_path = trace_env
    with trace.span("step", "train", step=1):
        trace.instant("guard.skip", cat="guard")
    trace.clock_sync(1000.0, round=2)
    trace.complete("lease.expiry", "elastic", time.time() - 1.0, 1.0,
                   args={"host": "h"})
    p1 = trace.flight_dump("first")
    p2 = trace.flight_dump("second")
    assert p1 == p2
    doc = json.load(open(p2))
    assert ht.validate_events(doc["traceEvents"]) == []
    assert _reference_tool("hvdtpu_trace").validate_events(
        doc["traceEvents"]) == []
    assert doc["metadata"]["reasons"] == ["first", "second"]
    assert doc["displayTimeUnit"] == "ms"


def test_recorder_thread_safety(trace_env):
    trace, rec, tmp_path = trace_env

    def worker(k):
        for i in range(8):
            with trace.span(f"t{k}", cat="app", i=i):
                pass

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert rec.open_spans() == []
    names = {e["name"] for e in rec._ring}
    assert {f"t{k}" for k in range(8)} <= names


# ---- merge + clock alignment --------------------------------------------


def _us(seconds):
    return int(seconds * 1e6)


def _rank_doc(stem, skew_s, sync_delays_s, steps, jitter_s=0.0):
    events = []
    for k, delay in enumerate(sync_delays_s):
        driver_ts = 990.0 + k
        events.append({
            "ph": "i", "name": "clock_sync", "cat": "clock", "s": "t",
            "ts": _us(driver_ts + skew_s + delay), "tid": 1,
            "args": {"driver_ts": driver_ts, "round": k},
        })
    for k in steps:
        events.append({
            "ph": "X", "name": "worker.step", "cat": "elastic",
            "ts": _us(1000.0 + k + skew_s + jitter_s), "dur": _us(0.5),
            "tid": 1, "args": {"step": k},
        })
    return {"traceEvents": events, "metadata": {"stem": stem}}


def _driver_doc():
    return {
        "traceEvents": [
            {"ph": "X", "name": "round.publish", "cat": "elastic",
             "ts": _us(990.0), "dur": _us(0.01), "tid": 1,
             "args": {"round": 0}},
        ],
        "metadata": {"stem": "driver", "role": "driver"},
    }


def test_merge_recovers_injected_clock_skew():
    skew_a, skew_b = 3.7, -1.2
    rank_a = _rank_doc("hostA", skew_a, [0.005, 0.020, 0.015], [1, 2, 3])
    rank_b = _rank_doc("hostB", skew_b, [0.008, 0.006, 0.030], [1, 2, 3],
                       jitter_s=0.004)
    merged = ht.merge([_driver_doc(), rank_a, rank_b])
    offs = merged["metadata"]["clock_offsets_us"]
    assert offs["driver"] is None
    assert abs(offs["hostA"] - _us(skew_a)) <= _us(0.006)
    assert abs(offs["hostB"] - _us(skew_b)) <= _us(0.007)
    rep = ht.report(merged)
    assert rep["max_step_skew_ms"] <= 15.0
    markers = {
        e["name"] for e in merged["traceEvents"]
        if e.get("cat") == "correlation"
    }
    assert {"round 0", "step 1", "step 2", "step 3"} <= markers
    assert ht.validate_events(merged["traceEvents"]) == []


def test_report_phase_percentiles():
    events = [
        {"ph": "X", "name": "step", "cat": "train", "ts": _us(i),
         "dur": _us(0.001 * (i + 1)), "tid": 1, "args": {"step": i}}
        for i in range(10)
    ]
    rep = ht.report(ht.merge([
        {"traceEvents": events, "metadata": {"stem": "r0"}}
    ]))
    row = rep["phases"]["train:step"]
    assert row["count"] == 10
    assert row["p50_ms"] <= row["p95_ms"] <= row["max_ms"] == 10.0


def test_merge_dir_and_cli_roundtrip(trace_env):
    trace, rec, tmp_path = trace_env
    with trace.span("step", "train", step=1):
        pass
    trace.flight_dump("t")
    out = os.path.join(str(tmp_path), "merged.json")
    merged = ht.merge_dir(str(tmp_path), out=out)
    assert merged is not None and os.path.exists(out)
    assert ht.validate_events(json.load(open(out))["traceEvents"]) == []
    assert ht.merge_dir(os.path.join(str(tmp_path), "empty")) is None


def test_reference_merge_of_port_dumps_equals_the_port_merge(tmp_path):
    """Port dumps of two skewed 'hosts' and a driver, written through the
    recorder's own dump path: the JAX package's merge and the port's agree
    event for event, offsets included."""
    trace = trace_mod
    for doc in (_driver_doc(),
                _rank_doc("hostA", 2.5, [0.004, 0.012], [1, 2, 3]),
                _rank_doc("hostB", -0.8, [0.009, 0.003], [1, 2, 3],
                          jitter_s=0.002)):
        trace._reset_for_tests()
        rec = trace.enable(directory=str(tmp_path), capacity=64)
        rec.role = doc["metadata"]["stem"]
        for ev in doc["traceEvents"]:
            rec._emit(dict(ev))
        assert trace.flight_dump("parity")
    ref = _reference_tool("hvdtpu_trace")
    port_merged = ht.merge_dir(str(tmp_path))
    ref_merged = ref.merge_dir(str(tmp_path))
    assert port_merged["metadata"]["clock_offsets_us"] == \
        ref_merged["metadata"]["clock_offsets_us"]
    assert abs(port_merged["metadata"]["clock_offsets_us"]["hostA"]
               - _us(2.5)) <= _us(0.005)

    def key(e):
        return (e.get("ts"), e.get("name"), e.get("ph"), e.get("pid"))

    assert sorted(port_merged["traceEvents"], key=key) == sorted(
        ref_merged["traceEvents"], key=key)
    assert ht.report(port_merged) == ref.report(ref_merged)


# ---- the host timeline bridge -------------------------------------------


def test_timeline_mirrors_into_trace_ring(trace_env, tmp_path):
    trace, rec, _ = trace_env
    from horovod_tpu_torch.utils.timeline import Timeline

    path = os.path.join(str(tmp_path), "tl.json")
    tl = Timeline(path)
    tl.start()
    with tl.activity("grad_0", "NEGOTIATE_ALLREDUCE"):
        pass
    tl.instant("grad_0", "CYCLE")
    tl.stop()
    native = [e for e in rec._ring if e.get("cat") == "native"]
    phs = [e["ph"] for e in native]
    assert "B" in phs and "E" in phs and "i" in phs
    assert all(e["args"]["tensor"] == "grad_0" for e in native)
    doc = ht.load_trace(path)
    assert doc["metadata"].get("rebased_from_epoch")
    merged = ht.merge([doc])
    assert ht.validate_events(merged["traceEvents"]) == []


# ---- flight-dump trigger sites ------------------------------------------


def test_guard_escalation_dumps(trace_env):
    trace, rec, tmp_path = trace_env
    from horovod_tpu_torch.obs import guard as obs_guard

    obs_guard.record_escalation(5)
    path = os.path.join(
        str(tmp_path), os.path.basename(trace.flight_dump("probe"))
    )
    doc = json.load(open(path))
    assert "guard_escalation" in doc["metadata"]["reasons"]
    names = {e["name"] for e in doc["traceEvents"]}
    assert "guard.escalation" in names


# ---- atomic Prometheus publish ------------------------------------------


def test_prom_reader_never_sees_partial_file(tmp_path, monkeypatch):
    monkeypatch.setenv("HVDTPU_METRICS", "1")
    rep = exp_mod.MetricsReporter(directory=str(tmp_path), interval=0.0)
    reg = reg_mod.metrics()
    n_gauges = 200

    def publish(gen):
        for i in range(n_gauges):
            reg.gauge(f"atomic.g{i}").set(gen)
        rep.flush(summarize=False)

    publish(0)
    prom = rep.prom_path()
    stop = threading.Event()
    errors = []

    def writer():
        gen = 1
        while not stop.is_set():
            publish(gen)
            gen += 1

    def reader():
        while not stop.is_set():
            try:
                text = open(prom).read()
            except FileNotFoundError:
                errors.append("prom file vanished")
                break
            lines = [
                l for l in text.splitlines()
                if l.startswith("hvdtpu_atomic_g") and not l.startswith("#")
            ]
            if len(lines) != n_gauges:
                errors.append(f"torn read: {len(lines)} gauges")
                break
            gens = {l.rsplit(" ", 1)[1] for l in lines}
            if len(gens) != 1:
                errors.append(f"mixed generations in one read: {gens}")
                break
            if not text.endswith("\n"):
                errors.append("file does not end in newline")
                break

    w = threading.Thread(target=writer)
    r = threading.Thread(target=reader)
    w.start(), r.start()
    time.sleep(1.0)
    stop.set()
    w.join(5), r.join(5)
    assert not errors, errors


# ---- metric-name lint ----------------------------------------------------


def test_metric_names_lint_clean():
    """The port's sources pass both rules against the reference's docs."""
    assert ml.check_ownership() == []
    assert ml.check_docs() == []


def test_metric_names_lint_catches_drift(tmp_path, monkeypatch):
    pkg = tmp_path / "horovod_tpu_torch"
    pkg.mkdir()
    (pkg / "a.py").write_text('m.counter("dup.series").inc()\n')
    (pkg / "b.py").write_text(
        'm.counter("dup.series").inc()\n'
        'm.gauge(f"dyn.{host}").set(1)\n'
    )
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "api.md").write_text("`dyn.<host>` is documented here\n")
    monkeypatch.setattr(ml, "REPO", str(tmp_path))
    owned = ml.check_ownership()
    assert [name for name, _ in owned] == ["dup.series"]
    assert len(owned[0][1]) == 2
    assert ml.check_docs() == ["dup.series"]


# ---- end-to-end: a seeded hang ships a usable timeline ------------------


def _merged_trace(res):
    trace_dir = res["trace_dir"]
    merged = ht.merge_dir(trace_dir,
                          out=os.path.join(trace_dir, "merged.json"))
    assert merged is not None, f"no flight-recorder dumps in {trace_dir}"
    assert ht.validate_events(merged["traceEvents"]) == []
    return merged


def test_hang_scenario_flight_recorder_end_to_end():
    """The port's soak: a 2-worker elastic run with tracing armed and an
    injected ``worker.step:hang`` leaves dumps that merge into one valid
    timeline holding the chaos instant, the victim's open step span and
    the driver's lease-expiry span, in clock order."""
    from horovod_tpu_torch.tools import chaos_soak as soak

    res = soak.run_scenario("hang", steps=5, timeout=150.0)
    problems = soak.check_invariants(res, steps=5)
    assert not problems, problems
    merged = _merged_trace(res)
    stems = merged["metadata"]["merged_from"]
    assert "driver" in stems
    assert len([s for s in stems if s != "driver"]) >= 2, stems
    events = merged["traceEvents"]
    chaos_fires = [
        e for e in events
        if e["name"] == "chaos.worker.step"
        and e.get("args", {}).get("action") == "hang"
    ]
    assert chaos_fires, "chaos injection instant missing from the merge"
    open_steps = [
        e for e in events if e["ph"] == "B" and e["name"] == "worker.step"
    ]
    assert open_steps, "victim's open step span missing (flight dump)"
    expiries = [e for e in events if e["name"] == "lease.expiry"]
    assert expiries, "driver's lease-expiry span missing"
    fire_ts = min(e["ts"] for e in chaos_fires)
    expiry_end = max(e["ts"] + e["dur"] for e in expiries)
    assert fire_ts <= expiry_end
    assert min(e["ts"] for e in open_steps) <= fire_ts
    offs = merged["metadata"]["clock_offsets_us"]
    victim_offsets = [
        off for stem, off in offs.items()
        if stem != "driver" and off is not None
    ]
    assert victim_offsets, f"no clock_sync observations: {offs}"
    assert all(abs(off) < 2_000_000 for off in victim_offsets), offs


def test_deadline_diagnostics_attach_flight_recorder():
    """A scenario that blows its deadline carries the merged
    flight-recorder timeline in its diagnostics, on disk and parseable."""
    from horovod_tpu_torch.tools import chaos_soak as soak

    res = soak.run_scenario("hang", steps=5, timeout=6.0)
    assert res["timed_out"]
    fr = (res["diagnostics"] or {}).get("flight_recorder")
    assert fr, f"diagnostics carry no flight recorder: {res['diagnostics']}"
    assert "error" not in fr, fr
    assert os.path.exists(fr["merged"])
    doc = json.load(open(fr["merged"]))
    assert ht.validate_events(doc["traceEvents"]) == []
    assert fr["events"] > 0 and fr["files"]
