"""The port's goodput ledger held against the JAX package's: the same seeded
feeds give both ledgers the same category totals, and the twins of
tests/test_goodput.py hold the port's conservation, attribution, adoption,
feed plumbing and report tools.

Not ported here: the ``bench_regress`` tests (six), which wait for the
port's own benchmark.
"""

import json
import os
import random

import pytest

from horovod_tpu.obs import goodput as jgoodput
from horovod_tpu_torch.obs import goodput
from horovod_tpu_torch.obs import registry as reg_mod
from horovod_tpu_torch.obs.goodput import CATEGORIES, GoodputLedger
from horovod_tpu_torch.tools import check_metric_names as cm
from horovod_tpu_torch.tools import hvdtpu_goodput as gtool
from horovod_tpu_torch.tools import hvdtpu_top as top

TOL = 1e-6

FEEDABLE = [c for c in CATEGORIES if c != "other"]


@pytest.fixture(autouse=True)
def _planes_reset():
    """Every test starts and ends with the process-global planes off."""
    goodput._reset_for_tests()
    reg_mod._registry.reset()
    reg_mod._enabled = None
    yield
    goodput._reset_for_tests()
    reg_mod._registry.reset()
    reg_mod._enabled = None


@pytest.fixture
def goodput_env():
    """Arm the module plane with a metrics registry to publish into."""
    goodput.enable()
    yield reg_mod.enable()


def _assert_conserved(led):
    totals = led.totals()
    elapsed = led.elapsed_s()
    assert abs(sum(totals.values()) - elapsed) < TOL, (totals, elapsed)
    assert all(v >= -TOL for v in totals.values()), totals
    return totals, elapsed


# ---- parity with the JAX package's ledger ----------------------------------


def _random_feeds(seed):
    """A seeded stream of (op, args): overlapping, nested and out-of-order
    intervals, idle stretches, step brackets and guard skips."""
    rng = random.Random(seed)
    ops = []
    t = 1000.0
    for i in range(400):
        kind = rng.random()
        if kind < 0.7:
            start = t + rng.uniform(-5.0, 1.0)
            ops.append(("add", (rng.choice(FEEDABLE), start,
                                rng.uniform(0.0, 3.0))))
        elif kind < 0.9:
            dur = rng.uniform(0.1, 1.0)
            disp = dur * rng.uniform(0.0, 0.5)
            ops.append(("record_step", (t, dur, disp, dur - disp)))
        else:
            ops.append(("record_guard_skip", ()))
        t += rng.uniform(0.0, 1.5)
        if i % 7 == 0:
            ops.append(("touch", (t,)))
    return ops


def _feed(led, ops):
    for op, args in ops:
        getattr(led, op)(*args)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [16, 33, 512])
def test_category_totals_equal_the_reference_on_seeded_interleavings(
        seed, window):
    ops = _random_feeds(seed)
    port, ref = GoodputLedger(window=window), jgoodput.GoodputLedger(
        window=window)
    _feed(port, ops)
    _feed(ref, ops)
    pt, rt = port.totals(), ref.totals()
    assert set(pt) == set(rt)
    for c in CATEGORIES:
        assert abs(pt[c] - rt[c]) <= 1e-9, (c, pt[c], rt[c])
    assert abs(port.elapsed_s() - ref.elapsed_s()) <= 1e-9
    _assert_conserved(port)


def test_late_adds_and_an_adoption_chain_equal_the_reference():
    """Settling behind the watermark, a late checkpoint bracket, and two
    adoptions (one across a backwards clock): the same totals in both."""
    out = []
    for mod in (goodput, jgoodput):
        l1 = mod.GoodputLedger(window=16)
        for i in range(40):
            l1.add("compute", 100.0 + 10.0 * i, 1.0)
        l1.add("checkpoint", 101.5, 5.0)
        l2 = mod.GoodputLedger(window=16)
        sd = l1.state_dict()
        l2.load_state_dict(sd, now=sd["last_ts"] + 3.25)
        l2.add("rescale_downtime", 600.0, 2.0)
        l2.record_step(602.0, 1.0, 0.25, 0.75)
        l3 = mod.GoodputLedger(window=16)
        l3.load_state_dict(l2.state_dict(), now=10.0)  # behind: gap 0
        l3.add("compute", 10.0, 1.0)
        out.append((l3.totals(), l3.elapsed_s()))
    (pt, pe), (rt, re_) = out
    for c in CATEGORIES:
        assert abs(pt[c] - rt[c]) <= 1e-9, c
    assert abs(pe - re_) <= 1e-9
    assert abs(sum(pt.values()) - pe) < TOL


def test_state_dicts_cross_between_the_packages():
    """A driver of either package adopts the other's journaled ledger."""
    port = GoodputLedger(window=64)
    port.add("compute", 0.0, 3.0)
    ref = jgoodput.GoodputLedger(window=64)
    gap = ref.load_state_dict(port.state_dict(), now=4.0)
    assert gap == pytest.approx(1.0)
    back = GoodputLedger(window=64)
    sd = ref.state_dict()
    back.load_state_dict(sd, now=sd["last_ts"])
    assert back.totals()["compute"] == pytest.approx(3.0)
    assert back.totals()["adoption_gap"] == pytest.approx(1.0)


# ---- conservation property -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [16, 33, 512])
def test_conservation_random_interleavings(seed, window):
    rng = random.Random(seed)
    led = GoodputLedger(window=window)
    t = 1000.0
    for i in range(400):
        start = t + rng.uniform(-5.0, 1.0)
        dur = rng.uniform(0.0, 3.0)
        led.add(rng.choice(FEEDABLE), start, dur)
        t += rng.uniform(0.0, 1.5)
        if i % 7 == 0:
            led.touch(t)
        if i % 50 == 0:
            _assert_conserved(led)
    totals, elapsed = _assert_conserved(led)
    assert elapsed > 0


def test_conservation_late_add_behind_watermark():
    led = GoodputLedger(window=16)
    for i in range(40):
        led.add("compute", 100.0 + 10.0 * i, 1.0)
    _assert_conserved(led)
    assert led._settled_upto is not None
    before = led.totals()
    assert before["other"] > 50.0
    led.add("checkpoint", 101.5, 5.0)
    after, _ = _assert_conserved(led)
    assert after["checkpoint"] >= 5.0 - TOL
    assert after["other"] <= before["other"] - 5.0 + TOL


def test_conservation_across_adoption_chain():
    l1 = GoodputLedger(window=64)
    l1.add("compute", 0.0, 5.0)
    l1.add("checkpoint", 5.0, 1.0)
    state1 = l1.state_dict()
    l2 = GoodputLedger(window=64)
    gap1 = l2.load_state_dict(state1, now=10.0)
    assert gap1 == pytest.approx(4.0)
    l2.add("compute", 10.0, 2.0)
    _assert_conserved(l2)
    state2 = l2.state_dict()
    l3 = GoodputLedger(window=64)
    gap2 = l3.load_state_dict(state2, now=14.5)
    assert gap2 == pytest.approx(2.5)
    l3.add("rescale_downtime", 14.5, 0.5)
    totals, elapsed = _assert_conserved(l3)
    assert elapsed == pytest.approx(5.0 + 1.0 + 4.0 + 2.0 + 2.5 + 0.5)
    assert totals["adoption_gap"] == pytest.approx(4.0 + 2.5)
    assert totals["compute"] == pytest.approx(7.0)


def test_adoption_backwards_clock_clamps_gap():
    l1 = GoodputLedger(window=64)
    l1.add("compute", 100.0, 5.0)
    state = l1.state_dict()
    l2 = GoodputLedger(window=64)
    gap = l2.load_state_dict(state, now=90.0)
    assert gap == 0.0
    l2.add("compute", 90.0, 1.0)
    totals, elapsed = _assert_conserved(l2)
    assert totals["adoption_gap"] == 0.0
    assert elapsed == pytest.approx(6.0)


def test_load_state_dict_rejects_malformed():
    led = GoodputLedger(window=64)
    for bad in (None, [], {}, {"version": 2}, {"version": 1},
                {"version": 1, "totals": {}, "elapsed_s": "x",
                 "last_ts": 0.0}):
        with pytest.raises(ValueError):
            led.load_state_dict(bad, now=0.0)


# ---- attribution semantics -------------------------------------------------


def test_priority_overlap_resolution():
    led = GoodputLedger(window=64)
    led.add("compute", 0.0, 10.0)
    led.add("checkpoint", 4.0, 2.0)
    totals, _ = _assert_conserved(led)
    assert totals["checkpoint"] == pytest.approx(2.0)
    assert totals["compute"] == pytest.approx(8.0)


def test_uncovered_time_is_other():
    led = GoodputLedger(window=64)
    led.add("compute", 0.0, 1.0)
    led.touch(5.0)
    totals, elapsed = _assert_conserved(led)
    assert elapsed == pytest.approx(5.0)
    assert totals["other"] == pytest.approx(4.0)


def test_add_validates_category_and_duration():
    led = GoodputLedger(window=64)
    with pytest.raises(ValueError):
        led.add("nonsense", 0.0, 1.0)
    with pytest.raises(ValueError):
        led.add("other", 0.0, 1.0)
    led.add("compute", 0.0, 0.0)
    led.add("compute", 0.0, -1.0)
    assert led.elapsed_s() == 0.0


def test_record_step_splits_dispatch_and_compute():
    led = GoodputLedger(window=64)
    led.record_step(0.0, 1.0, 0.25, 0.75)
    totals, _ = _assert_conserved(led)
    assert totals["host_dispatch"] == pytest.approx(0.25)
    assert totals["compute"] == pytest.approx(0.75)
    assert totals["exposed_comm"] == 0.0


def test_exposed_comm_rolling_min_baseline():
    led = GoodputLedger(window=256)
    t = 0.0
    for _ in range(6):
        led.record_step(t, 1.0, 0.2, 0.8)
        t += 1.0
    base = led.totals()
    assert base["exposed_comm"] == pytest.approx(0.0, abs=TOL)
    led.record_step(t, 2.0, 0.2, 1.8)
    totals, _ = _assert_conserved(led)
    assert totals["exposed_comm"] == pytest.approx(1.0)
    assert totals["compute"] == pytest.approx(base["compute"] + 0.8)


def test_guard_skip_reclassifies_previous_step():
    led = GoodputLedger(window=64)
    led.record_step(0.0, 1.0, 0.2, 0.8)
    led.record_guard_skip()
    totals, _ = _assert_conserved(led)
    assert totals["guard_retry"] == pytest.approx(1.0)
    assert totals["compute"] == pytest.approx(0.0, abs=TOL)
    assert totals["host_dispatch"] == pytest.approx(0.0, abs=TOL)


# ---- module plane ----------------------------------------------------------


def test_disabled_feeds_are_noops(monkeypatch):
    monkeypatch.delenv("HVDTPU_GOODPUT", raising=False)
    goodput._reset_for_tests()
    assert not goodput.enabled()
    goodput.record_step(0.0, 1.0, 0.2, 0.8)
    goodput.record_serve("idle", 0.0, 1.0)
    goodput.record_rescale(0.0, 1.0)
    assert goodput._ledger is None


def test_serve_kinds_map_and_publish(goodput_env):
    reg = goodput_env
    goodput.record_serve("compute", 0.0, 2.0)
    goodput.record_serve("queue", 2.0, 1.0)
    goodput.record_serve("idle", 3.0, 0.5)
    goodput.record_serve("swap", 3.5, 0.5)
    snap = goodput.publish()
    assert snap["totals"]["compute"] == pytest.approx(2.0)
    assert snap["totals"]["serve_queue"] == pytest.approx(1.0)
    assert snap["totals"]["serve_idle"] == pytest.approx(0.5)
    assert snap["totals"]["serve_swap"] == pytest.approx(0.5)
    assert reg.gauge("goodput.elapsed_s").get() == pytest.approx(4.0)
    assert reg.gauge("goodput.fraction").get() == pytest.approx(0.5)
    assert reg.gauge("goodput.serve_queue_s").get() == pytest.approx(1.0)


def test_driver_ledger_rides_driver_state(goodput_env):
    """The port's elastic driver journals its own ledger in
    ``_driver_state()`` and an adopter restores it with the takeover gap
    booked as adoption_gap."""
    from horovod_tpu_torch.runner import elastic_driver as ed

    job = ed.ElasticJob.__new__(ed.ElasticJob)
    job._goodput = GoodputLedger(window=64)
    job._goodput.add("compute", 0.0, 3.0)
    state = job._goodput.state_dict()
    assert state["version"] == 1
    assert job.goodput_snapshot()["totals"]["compute"] == pytest.approx(3.0)
    adopted = GoodputLedger(window=64)
    gap = adopted.load_state_dict(state, now=state["last_ts"] + 1.25)
    assert gap == pytest.approx(1.25)
    snap = adopted.snapshot()
    assert snap["totals"]["adoption_gap"] == pytest.approx(1.25)
    assert snap["totals"]["compute"] == pytest.approx(3.0)
    assert snap["elapsed_s"] == pytest.approx(4.25)


def test_env_window_validation(monkeypatch):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as _env

    monkeypatch.setenv("HVDTPU_GOODPUT_WINDOW", "8")
    with pytest.raises(ValueError):
        _env.goodput_window()
    monkeypatch.setenv("HVDTPU_GOODPUT_WINDOW", "64")
    assert _env.goodput_window() == 64 == jenv.goodput_window()
    monkeypatch.delenv("HVDTPU_GOODPUT_WINDOW")
    assert _env.goodput_window() == _env.DEFAULT_GOODPUT_WINDOW
    assert _env.DEFAULT_GOODPUT_WINDOW == jenv.DEFAULT_GOODPUT_WINDOW


# ---- report tool -----------------------------------------------------------


def _write_export(path, rank, totals, elapsed):
    gauges = {f"goodput.{c}_s": totals.get(c, 0.0) for c in CATEGORIES}
    gauges["goodput.elapsed_s"] = elapsed
    gauges["goodput.fraction"] = totals.get("compute", 0.0) / elapsed
    rec = {"ts": 1.0, "rank": rank, "world": 2, "counters": {},
           "gauges": gauges, "histograms": {}, "events": []}
    with open(path, "w") as f:
        f.write("not json garbage\n")
        f.write(json.dumps(rec) + "\n")


def test_goodput_tool_collect_rollup(tmp_path, capsys):
    _write_export(tmp_path / "rank0.jsonl", 0,
                  {"compute": 6.0, "input_stall": 2.0}, 10.0)
    _write_export(tmp_path / "rank1.jsonl", 1,
                  {"compute": 4.0, "rescale_downtime": 4.0}, 10.0)
    (tmp_path / "empty.jsonl").write_text("")
    rows = gtool.collect(str(tmp_path))
    assert [r["rank"] for r in rows] == [0, 1]
    job = gtool.rollup(rows)
    assert job["elapsed_s"] == pytest.approx(20.0)
    assert job["fraction"] == pytest.approx(0.5)
    causes = {c["category"]: c for c in job["causes"]}
    assert causes["rescale_downtime"]["seconds"] == pytest.approx(4.0)
    assert causes["rescale_downtime"]["runbook"] == "goodput: rescale_downtime"
    assert gtool.main(["--dir", str(tmp_path), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["job"]["n_processes"] == 2


def test_goodput_tool_empty_dir_exits_1(tmp_path, capsys):
    assert gtool.main(["--dir", str(tmp_path)]) == 1


def _write_trace(path, spans):
    events = [
        {"ph": "X", "name": name, "ts": ts_us, "dur": dur_us,
         "pid": 1, "tid": 1, "args": args}
        for name, ts_us, dur_us, args in spans
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "metadata": {"host": "h", "rank": 0,
                                "clock_offset_us": 0}}, f)


def test_goodput_trace_crosscheck(tmp_path, capsys):
    mdir = tmp_path / "m"
    tdir = tmp_path / "t"
    mdir.mkdir()
    tdir.mkdir()
    _write_export(mdir / "rank0.jsonl", 0,
                  {"compute": 6.0, "input_stall": 2.0}, 10.0)
    _write_trace(tdir / "trace_h.json", [
        ("step.device", 0, 3_000_000, {}),
        ("step.device", 4_000_000, 3_000_000, {}),
        ("prefetch.fill", 0, 2_000_000, {"stalled": True}),
        ("prefetch.fill", 3_000_000, 9_000_000, {"stalled": False}),
    ])
    assert gtool.main(["--dir", str(mdir), "--trace", str(tdir),
                       "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    by_cat = {c["category"]: c for c in out["trace_checks"]}
    assert by_cat["compute"]["ok"]
    assert by_cat["input_stall"]["trace_s"] == pytest.approx(2.0)
    _write_export(mdir / "rank0.jsonl", 0,
                  {"compute": 60.0, "input_stall": 2.0}, 100.0)
    assert gtool.main(["--dir", str(mdir), "--trace", str(tdir)]) == 2


def test_top_json_mode_includes_goodput(tmp_path, capsys):
    _write_export(tmp_path / "rank0.jsonl", 0,
                  {"compute": 6.0, "checkpoint": 1.0}, 10.0)
    assert top.main(["--dir", str(tmp_path), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["dir"] == str(tmp_path)
    row = out["rows"][0]
    assert row["goodput"]["fraction"] == pytest.approx(0.6)
    assert row["goodput"]["elapsed"] == pytest.approx(10.0)
    top_cats = dict(row["goodput"]["top"])
    assert top_cats["checkpoint"] == pytest.approx(1.0)


def test_top_json_mode_empty_dir_exits_1(tmp_path, capsys):
    assert top.main(["--dir", str(tmp_path), "--json"]) == 1


# ---- lint gates ------------------------------------------------------------


def test_goodput_runbook_lint_clean():
    assert cm.check_goodput_runbook() == []


def test_goodput_runbook_lint_catches_missing(monkeypatch, tmp_path):
    """Renaming a category's triage row in the runbook trips the gate."""
    runbook = open(os.path.join(cm.REPO, "docs", "runbook.md")).read()
    docs = tmp_path / "docs"
    docs.mkdir()
    (tmp_path / "horovod_tpu_torch" / "obs").mkdir(parents=True)
    (docs / "runbook.md").write_text(
        runbook.replace("goodput: adoption_gap", "goodput: adoption gap")
    )
    src = open(os.path.join(cm.REPO, "horovod_tpu_torch", "obs",
                            "goodput.py")).read()
    (tmp_path / "horovod_tpu_torch" / "obs" / "goodput.py").write_text(src)
    monkeypatch.setattr(cm, "REPO", str(tmp_path))
    missing = cm.check_goodput_runbook()
    assert len(missing) == 1 and "adoption_gap" in missing[0]
