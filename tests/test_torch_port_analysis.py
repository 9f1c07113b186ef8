"""The port's analysis plane (``horovod_tpu_torch/analysis``) held against
the JAX package's (``horovod_tpu/analysis``).

* Rules and findings: the same hand-built collective sites, loop carries
  and plans go to both packages' rule passes; the findings must agree in
  rule, severity, message and provenance. The allowlist likewise.
* Records: the port's fake-tensor record of GPT-2 tiny's step at a
  simulated world of 8 gives the reference's cert entries (kind, axes,
  shapes, dtypes, bytes) for the sharded, sharded fused, int8-wire,
  accum_steps=2 and overlap builds; the reference runs on 8 virtual CPU
  devices under the ``jax.core`` shim of ``tests/torch_analysis_ref.py``.
* Seeded defects give the reference's rule ids; the replicated, guarded
  and quantized builds lint without errors.
* A record leaves the parameters, the RNG state and every launch counter
  as they were, and each ``hvt::*`` fake gives its plain version's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.analysis import findings as jfind
from horovod_tpu.analysis import rules as jrules
from horovod_tpu.analysis.jaxpr_walk import CollectiveSite as JSite
from horovod_tpu.analysis.jaxpr_walk import ControlFrame as JFrame
from horovod_tpu.analysis.jaxpr_walk import LoopCarry as JCarry
from horovod_tpu.analysis.jaxpr_walk import WalkResult as JWalk
from horovod_tpu_torch import analysis as tan
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.analysis import findings as tfind
from horovod_tpu_torch.analysis import harness as tharness
from horovod_tpu_torch.analysis import record as trec
from horovod_tpu_torch.analysis import rules as trules
from horovod_tpu_torch.parallel import dp as tdp

from torch_analysis_ref import jax_core_shim, reference_world, shim_state

def _avals(spec, port: bool):
    """The port's aval records, for both packages' sites: the reference's
    rules read ``shape``, ``dtype`` (its name, ``itemsize``) and ``str``,
    so both read one list."""
    del port
    return tuple(trec.Aval(tuple(shape), trec.dtype_of(getattr(torch, dt)))
                 for shape, dt in spec)


def _sites(rows, port: bool):
    """Both packages' CollectiveSites from one description: ``(kind, axes,
    ins, outs, frames)`` with ``frames`` ``[(kind, rank_dependent)]``."""
    site, frame = (trec.CollectiveSite, trec.ControlFrame) if port else (
        JSite, JFrame)
    out = []
    for i, (kind, axes, ins, outs, frames) in enumerate(rows):
        cf = tuple(frame(k, r) for k, r in frames)
        path = "/".join([k for k, _ in frames] + [f"{kind}[#{i + 1}]"])
        out.append(site(kind, tuple(axes), i + 1, path, _avals(ins, port),
                        _avals(outs, port), cf))
    return out


def _key(findings):
    return [(f.rule, str(f.severity), f.message, f.provenance)
            for f in findings]


def _both(fn_name, rows, *args, **kw):
    j = getattr(jrules, fn_name)(_sites(rows, False), *args, **kw)
    t = getattr(trules, fn_name)(_sites(rows, True), *args, **kw)
    return _key(j), _key(t)


F32 = "float32"
SITES = {
    "clean": [
        ("reduce_scatter", ["hvd"], [((1024,), F32)], [((128,), F32)], []),
        ("all_gather", ["hvd"], [((128,), F32)], [((1024,), F32)], []),
        ("psum", ["hvd"], [((), F32)], [((), F32)], []),
    ],
    "bad_axes": [
        ("psum", ["hvd"], [((8,), F32)], [((8,), F32)], []),
        ("psum", ["tp", "hvd"], [((8,), F32)], [((8,), F32)], []),
    ],
    "control_flow": [
        ("psum", ["hvd"], [((8,), F32)], [((8,), F32)], [("scan", False)]),
        ("all_gather", ["hvd"], [((8,), F32)], [((64,), F32)],
         [("scan", False), ("cond", True)]),
    ],
    "unpaired": [
        ("reduce_scatter", ["hvd"], [((1024,), F32)], [((128,), F32)], []),
        ("all_gather", ["hvd"], [((64,), F32)], [((512,), F32)], []),
        ("reduce_scatter", ["hvd"], [((512,), F32)], [((64,), F32)], []),
        ("all_gather", ["hvd"], [((32,), F32)], [((256,), F32)], []),
    ],
    "low_precision": [
        ("psum", ["hvd"], [((8,), "bfloat16")], [((8,), "bfloat16")], []),
        ("reduce_scatter", ["hvd"], [((64,), "float16")],
         [((8,), "float16")], []),
        ("all_gather", ["hvd"], [((8,), "bfloat16")],
         [((64,), "bfloat16")], []),
        ("pmax", ["hvd"], [((), "bfloat16"), ((), F32)],
         [((), "bfloat16"), ((), F32)], []),
    ],
}


@pytest.mark.parametrize("case", sorted(SITES))
def test_site_rules_match_the_reference(case):
    rows = SITES[case]
    for name, args, kw in (
        ("rule_axis_names", ({"hvd"},), {}),
        ("rule_axis_names", (None,), {}),
        ("rule_control_flow", (), {}),
        ("rule_rs_ag_pairing", (), {}),
        ("rule_precision_collectives", (), {}),
        ("rule_precision_collectives", (), {"allow_low_precision": True}),
    ):
        j, t = _both(name, rows, *args, **kw)
        assert t == j, (name, case)
    for world in (1, 8):
        assert trules.ring_wire_bytes(_sites(rows, True), world) == \
            jrules.ring_wire_bytes(_sites(rows, False), world)


def test_site_rules_fire_on_the_seeded_cases():
    rules = {c: {f[0] for f in _both("rule_axis_names", SITES[c], {"hvd"})[1]
                 + _both("rule_control_flow", SITES[c])[1]
                 + _both("rule_rs_ag_pairing", SITES[c])[1]
                 + _both("rule_precision_collectives", SITES[c])[1]}
             for c in SITES}
    assert rules["clean"] == set()
    assert rules["bad_axes"] == {"undeclared-axis"}
    assert rules["control_flow"] == {"collective-in-control-flow",
                                     "rank-dependent-collective"}
    assert rules["unpaired"] == {"rs-without-ag", "ag-without-rs"}
    assert rules["low_precision"] == {"low-precision-collective",
                                      "rs-without-ag", "ag-without-rs"}


@pytest.mark.parametrize("b_index", [None, 1, 3])
def test_order_divergence_matches_the_reference(b_index):
    a = SITES["clean"]
    b = list(a)
    if b_index == 1:
        b[1] = ("all_gather", ["hvd"], [((64,), F32)], [((512,), F32)], [])
    elif b_index == 3:
        b = b + [("psum", ["hvd"], [((4,), F32)], [((4,), F32)], [])]
    j = jrules.rule_order_divergence(_sites(a, False), _sites(b, False),
                                     label_a="k=1", label_b="k=2")
    t = trules.rule_order_divergence(_sites(a, True), _sites(b, True),
                                     label_a="k=1", label_b="k=2")
    assert _key(t) == _key(j)
    assert [f.details["index"] for f in t] == [f.details["index"] for f in j]
    assert bool(t) == (b_index is not None)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float32"),
                                    ("float16", "bfloat16")])
def test_accumulator_rule_matches_the_reference(dtypes):
    def walk(port):
        carry = trec.LoopCarry if port else JCarry
        result = trec.WalkResult if port else JWalk
        avals = _avals([((4, 3), dtypes[0]), ((7,), dtypes[1]),
                        ((2,), dtypes[0])], port)
        carries = [carry("scan", 0, avals[0], "scan", True),
                   carry("scan", 1, avals[1], "scan", True),
                   carry("while", 2, avals[2], "while", False)]
        return result([], carries)

    j = jrules.rule_precision_accumulators(walk(False))
    t = trules.rule_precision_accumulators(walk(True))
    assert _key(t) == _key(j)
    assert [f.details for f in t] == [f.details for f in j]


def _param_trees():
    rs = np.random.RandomState(0)
    shapes = {"a.w": ((64, 32), np.float32), "a.b": ((32,), np.float32),
              "c.w": ((48, 16), np.float32), "d.scale": ((16,), np.float32)}
    arrays = {k: rs.standard_normal(s).astype(d) for k, (s, d) in
              shapes.items()}
    jtree = {k: jnp.asarray(v) for k, v in arrays.items()}
    ttree = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return jtree, ttree


def _bucket_sites(layout, sharded, world, drop=None, dtype=F32):
    """Sites carrying each predicted bucket (``drop``: one left out)."""
    rows = []
    for i, (_, nbytes) in enumerate(layout):
        if i == drop:
            continue
        n = nbytes // 4
        if sharded:
            rows.append(("reduce_scatter", ["hvd"], [((n,), dtype)],
                         [((n // world,), dtype)], []))
            rows.append(("all_gather", ["hvd"], [((n // world,), dtype)],
                         [((n,), dtype)], []))
        else:
            rows.append(("psum", ["hvd"], [((n,), dtype)], [((n,), dtype)],
                         []))
    rows.append(("psum", ["hvd"], [((), F32)], [((), F32)], []))
    return rows


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("drop", [None, 0])
@pytest.mark.parametrize("threshold", [4096, 1 << 20])
def test_fusion_parity_matches_the_reference(sharded, drop, threshold):
    from horovod_tpu.ops.fusion import bucket_byte_layout as jlayout
    from horovod_tpu_torch.ops.fusion import bucket_byte_layout as tlayout

    jtree, ttree = _param_trees()
    world = 8
    pad = world if sharded else 1
    layout = tlayout(ttree, threshold, pad_multiple=pad)
    assert layout == jlayout(jtree, threshold, pad_multiple=pad)
    rows = _bucket_sites(layout, sharded, world, drop)
    kw = dict(threshold_bytes=threshold, world=world, sharded=sharded)
    j = jrules.rule_fusion_parity(_sites(rows, False), jtree, **kw)
    t = trules.rule_fusion_parity(_sites(rows, True), ttree, **kw)
    assert _key(t) == _key(j)
    assert bool(t) == (drop is not None)
    # A cast-compressed wire re-expresses the prediction in its dtype.
    jw = jrules.rule_fusion_parity(_sites(rows, False), jtree,
                                   wire_dtype=jnp.bfloat16, **kw)
    tw = trules.rule_fusion_parity(_sites(rows, True), ttree,
                                   wire_dtype=torch.bfloat16, **kw)
    assert _key(tw) == _key(jw) and tw
    # Replicated vs sharded byte parity.
    rep = _bucket_sites(tlayout(ttree, threshold), False, world)
    shard = _bucket_sites(tlayout(ttree, threshold, pad_multiple=world), True,
                          world, drop)
    for tol in (1.1, 0.5):
        j = jrules.rule_wire_parity(_sites(rep, False), _sites(shard, False),
                                    jtree, threshold_bytes=threshold,
                                    world=world, tolerance=tol)
        t = trules.rule_wire_parity(_sites(rep, True), _sites(shard, True),
                                    ttree, threshold_bytes=threshold,
                                    world=world, tolerance=tol)
        assert _key(t) == _key(j)


@pytest.mark.parametrize("drop", [None, "all_to_all", "all_gather"])
def test_quantized_fusion_parity_matches_the_reference(drop):
    from horovod_tpu.ops.compression import Compression as JC
    from horovod_tpu_torch.ops.compression import Compression as TC
    from horovod_tpu_torch.ops.fusion import quantized_bucket_layout

    jtree, ttree = _param_trees()
    world, threshold = 8, 4096
    tq = TC.int8.with_block(8)
    jq = JC.int8.with_block(8)
    rows = []
    for b in quantized_bucket_layout(ttree, threshold, world=world,
                                     compression=tq):
        n = b["elements"]
        if drop != "all_to_all":
            rows.append(("all_to_all", ["hvd"], [((world, n // world),
                                                  "int8")],
                         [((world, n // world), "int8")], []))
        if drop != "all_gather":
            rows.append(("all_gather", ["hvd"], [((n // world,), "int8")],
                         [((n,), "int8")], []))
    kw = dict(threshold_bytes=threshold, world=world, sharded=False)
    j = jrules.rule_fusion_parity(_sites(rows, False), jtree, quant=jq, **kw)
    t = trules.rule_fusion_parity(_sites(rows, True), ttree, quant=tq, **kw)
    assert _key(t) == _key(j)
    assert bool(t) == (drop is not None)


def _plans(peak, budget_case):
    from horovod_tpu.analysis.memory import MemoryPlan as JPlan

    common = dict(
        peak_bytes=peak,
        breakdown={"params": 400, "opt_state": 300, "activations": 250,
                   "wire": 40, "workspace": 10},
        resident_bytes=700, global_state_bytes=720, params_bytes=400,
        opt_state_bytes=300, batch_bytes=20, wire_bytes=40,
        activation_bytes=250, donation_saved_bytes=0,
        undonated_candidates=(
            {"label": "arg0.opt_state.mu", "class": "opt_state",
             "bytes": 150, "saving_bytes": 150},
            {"label": "arg0.opt_state.count", "class": "opt_state",
             "bytes": 4, "saving_bytes": 4}),
        world=8, n_eqns=10, n_buffers=12)
    return JPlan(**common), tan.MemoryPlan(**common)


@pytest.mark.parametrize("budget,baseline", [(None, None), (900, None),
                                             (2000, 900), (None, 990)])
def test_memory_rule_matches_the_reference(budget, baseline):
    jp, tp = _plans(1000, budget)
    kw = dict(budget_bytes=budget, baseline_bytes=baseline,
              baseline_key="gpt2/sharded")
    j = jrules.rule_memory(jp, **kw)
    t = trules.rule_memory(tp, **kw)
    assert _key(t) == _key(j)
    assert jp.fmt() == tp.fmt()
    from horovod_tpu.analysis.memory import (
        compare_to_measured as jcmp, project_sharding as jproj)

    assert tan.project_sharding(tp) == jproj(jp)
    for measured, source in ((1100, "device_peak"), (2000, "device_peak"),
                             (700, "live_arrays"), (1000, "live_arrays"),
                             (5, "device_peak_stale")):
        assert tan.compare_to_measured(tp, measured, source, 0.25) == \
            jcmp(jp, measured, source, 0.25)


def test_allowlist_and_severities_match_the_reference():
    def findings(mod):
        sev = mod.Severity
        return [
            mod.LintFinding("donation-dropped", sev.WARNING, "a", "p/x"),
            mod.LintFinding("low-precision-collective", sev.ERROR,
                            "reduces in loss", "psum[#3]"),
            mod.LintFinding("low-precision-collective", sev.ERROR, "grad",
                            "scan/psum[#9]"),
            mod.LintFinding("ag-without-rs", sev.INFO, "b"),
        ]

    for allow in ((), ("donation-dropped",), ("low-precision-collective:loss",),
                  ("low-precision-collective:scan", "ag-without-rs"),
                  ("fusion-parity",)):
        j = jfind.apply_allowlist(findings(jfind), allow)
        t = tfind.apply_allowlist(findings(tfind), allow)
        assert _key(t) == _key(j)
        assert [f.to_dict() for f in t] == [f.to_dict() for f in j]
        assert [str(f) for f in t] == [str(f) for f in j]
        assert str(tfind.max_severity(t)) == str(jfind.max_severity(j))
        assert _key(tfind.errors(t)) == _key(jfind.errors(j))
    err = tfind.LintError(findings(tfind)[1:3])
    assert str(err) == str(jfind.LintError(findings(jfind)[1:3]))
    from horovod_tpu_torch.exceptions import HorovodTpuError

    assert isinstance(err, HorovodTpuError)


# -- records of GPT-2 tiny ---------------------------------------------------


def _entries(cert):
    return [{k: e[k] for k in ("kind", "axes", "in", "out", "in_bytes",
                               "out_bytes", "reduces", "control_flow")}
            for e in cert.entries]


VARIANTS = {
    "sharded": {"sharded": True},
    "sharded_fused": {"sharded": True, "fused_update": True},
    "int8_wire": {"sharded": False, "quant": "int8"},
    "accum2": {"sharded": True, "accum_steps": 2},
    "overlap": {"sharded": True, "overlap": True, "accum_steps": 2},
}


@pytest.fixture(scope="module")
def reference_certs():
    with reference_world() as jh:
        return {name: _entries(jh.cert_model("gpt2", **var))
                for name, var in VARIANTS.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cert_entries_match_the_reference(variant, reference_certs):
    port = _entries(tharness.cert_model("gpt2", **VARIANTS[variant]))
    assert port == reference_certs[variant]


def test_sharded_cert_is_the_three_entry_schedule():
    cert = tharness.cert_model("gpt2", sharded=True)
    got = [(e["kind"], e["in"], e["out"]) for e in cert.entries]
    assert got == [
        ("reduce_scatter", ["float32[108032]"], ["float32[13504]"]),
        ("all_gather", ["float32[13504]"], ["float32[108032]"]),
        ("psum", ["float32[]"], ["float32[]"]),
    ]
    assert cert.world == 8 and cert.n_collectives == 3
    assert cert.wire == (["float32", 432128],)


def test_replicated_port_lints_clean_where_the_reference_errs():
    # The port fuses the replicated gradients into one all_reduce a
    # bucket, as its fusion policy predicts. The reference traced on jax
    # 0.9.0 holds one psum a leaf, which its own rule reports as the
    # 432128-byte bucket's missing group; on a jax that keeps its variadic
    # psum it is clean.
    port = tharness.lint_model("gpt2", sharded=False)
    assert port == ()
    with reference_world() as jh:
        ref = jh.lint_model("gpt2", sharded=False)
        n_psums = sum(e["kind"] == "psum" for e in jh.cert_model(
            "gpt2", sharded=False).entries)
    errs = [f.rule for f in jfind.errors(ref)]
    if n_psums > 2:  # one a leaf, plus the loss's
        assert errs == ["fusion-parity"]
        assert "predicted float32 bucket of 432128 bytes" in ref[0].message
    else:
        assert errs == []


@pytest.mark.parametrize("variant", ["sharded", "sharded_fused", "accum2",
                                     "overlap"])
def test_variants_lint_clean(variant):
    assert tharness.lint_model("gpt2", **VARIANTS[variant]) == ()


def test_int8_wire_lints_without_errors():
    # The quantized wire's error-feedback residuals are replaced by a
    # step, not updated in place (the guard's skip keeps the old ones), so
    # where the reference donates them the port reports the reuse it
    # misses; nothing else fires.
    findings = tharness.lint_model("gpt2", sharded=False, quant="int8")
    assert tfind.errors(findings) == ()
    assert {(f.rule, f.details["label"]) for f in findings} == {
        ("donation-missed-reuse", "arg0.opt_state.residual.buffers[0]")}


def test_static_parity_of_the_zoo_model():
    assert tharness.lint_parity("gpt2") == ()


# -- seeded defects ------------------------------------------------------------


def _regression(loss, **kw):
    rs = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rs.standard_normal((16, 8)).astype(
        np.float32)), "b": torch.zeros(8)}
    batch = {"x": torch.from_numpy(rs.standard_normal((4, 16)).astype(
        np.float32)), "y": torch.from_numpy(rs.standard_normal((4, 8)).astype(
            np.float32))}
    # ZeRO-1 with the fused update: the moments are updated in place, so
    # the memory pass reports no replaced state and each seeded defect
    # stands alone.
    with tan.simulated_world(8):
        step, opt = tdp.make_train_step(loss, topt.fused_adamw(1e-2),
                                        device="cpu", sharded=True,
                                        fused_update=True, **kw)
        state = tdp.init_state(params, opt)
    return step, state, batch


def _mse(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()


def _lint(step, state, batch, **kw):
    with tan.simulated_world(8):
        return step.lint(state, batch, **kw)


def test_a_split_bucket_is_a_fusion_parity_error():
    # The step fuses both leaves into one bucket and lints clean; built
    # at a threshold below the weight's bytes, its bucket goes out in two
    # collectives where the one-bucket policy predicts one.
    step, state, batch = _regression(_mse, threshold_bytes=1 << 20)
    assert _lint(step, state, batch) == ()
    step, state, batch = _regression(_mse, threshold_bytes=256)
    with tan.simulated_world(8):
        rec = step.trace(state, batch)
        found = tan.lint_traced(
            step._program, (state, batch), params=state.params, world=8,
            sharded=True, threshold_bytes=1 << 20, jaxpr=rec)
    assert {f.rule for f in found} == {"fusion-parity"}
    assert all(f.severity == tfind.Severity.ERROR for f in found)
    assert len([s for s in rec.collectives
                if s.kind == "reduce_scatter"]) == 2


def test_a_collective_on_rank_zero_only_is_rank_dependent():
    from horovod_tpu_torch import context
    from horovod_tpu_torch.ops.collectives import allreduce

    def loss(p, b):
        out = _mse(p, b)
        if context.rank() == 0:
            out = out + allreduce(p["b"]).sum() * 0
        return out

    step, state, batch = _regression(loss)
    found = _lint(step, state, batch)
    assert [f.rule for f in found] == ["rank-dependent-collective"]
    assert found[0].severity == tfind.Severity.ERROR
    assert "psum" in found[0].message


def test_a_bf16_microbatch_accumulator_is_a_precision_error():
    def loss(p, b):
        return _mse(p, b)

    step, state, batch = _regression(loss, accum_steps=2)
    assert _lint(step, state, batch) == ()
    # The same step with its fp32 accumulators made bf16.
    orig = torch.zeros_like

    def bf16_zeros(t, *a, dtype=None, **k):
        if dtype == torch.float32 and t.dim() > 0:
            dtype = torch.bfloat16
        return orig(t, *a, dtype=dtype, **k)

    torch.zeros_like = bf16_zeros
    try:
        found = _lint(step, state, batch)
    finally:
        torch.zeros_like = orig
    assert {f.rule for f in found} == {"low-precision-accumulator"}
    assert all("bfloat16" in f.message for f in found)


def test_an_fp8_step_without_its_scales_is_unverified():
    from horovod_tpu_torch.ops.quantization import fp8_cast, fp8_matmul

    hist = torch.ones(16)

    def loss(p, b):
        # A hand-rolled cast: no fp8_* state, no gradient through it.
        x = fp8_cast(b["x"], hist, torch.float8_e4m3fn, transposed=False)
        w = fp8_cast(p["w"].detach().t().contiguous(), hist,
                     torch.float8_e4m3fn, transposed=False)
        y = fp8_matmul(x.q, w.q.t(), x.scale, scale_b=w.scale)
        return ((y + p["b"] - b["y"]) ** 2).mean()

    step, state, batch = _regression(loss)
    found = _lint(step, state, batch)
    assert [f.rule for f in found] == ["low-precision-unverified"]
    assert found[0].details["dtypes"] == ["float8_e4m3fn"]


def test_a_host_read_in_the_step_is_a_finding_not_a_crash():
    def loss(p, b):
        if float(p["b"].detach().sum()) > 1e9:  # a host read
            return _mse(p, b) * 2
        return _mse(p, b)

    step, state, batch = _regression(loss)
    found = _lint(step, state, batch)
    assert [f.rule for f in found] == ["host-read-in-step"]
    assert "test_torch_port_analysis.py" in found[0].provenance


# -- the record changes nothing ------------------------------------------------


def test_a_record_leaves_params_rng_and_counters_as_they_were():
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import quantization as tq

    step, state, batch = tharness.build_step("gpt2", sharded=True,
                                             fused_update=True)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    moments = [t.clone() for t in state.opt_state.inner.mu.buffers]
    rng = torch.get_rng_state()
    counts = (fa.launches, fa.launches_dkdv, fa.launches_dq, fadam.launches,
              tq.launches_quant, tq.launches_dequant, tq.launches_fp8_matmul,
              tq.launches_fp8_cast, tq.launches_int8_matmul)
    with tan.simulated_world(8):
        rec = step.trace(state, batch)
    assert rec.n_eqns > 100 and len(rec.collectives) == 3
    assert all(torch.equal(before[k], v) for k, v in state.params.items())
    assert all(torch.equal(a, b) for a, b in
               zip(moments, state.opt_state.inner.mu.buffers))
    assert torch.equal(torch.get_rng_state(), rng)
    assert int(state.step) == 0
    assert counts == (fa.launches, fa.launches_dkdv, fa.launches_dq,
                      fadam.launches, tq.launches_quant, tq.launches_dequant,
                      tq.launches_fp8_matmul, tq.launches_fp8_cast,
                      tq.launches_int8_matmul)
    # The hvt ops ran as fakes inside the record.
    assert rec.op_counts.get("hvt::flash_fwd", 0) == 0 or \
        rec.op_counts["hvt::flash_fwd"] == 2
    assert rec.op_counts["hvt::fused_adamw"] == 1


def test_the_shim_restores_jax_core():
    before = shim_state()
    with jax_core_shim():
        assert all(shim_state().values())
    assert shim_state() == before


OPS = ["flash_fwd", "flash_bwd", "fused_adamw", "quantize_blockwise",
       "dequantize_blockwise", "fp8_cast", "fp8_matmul", "int8_matmul"]


def _op_case(name, device):
    """The op's wrapper call on ``device`` tensors (plain inputs)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import quantization as tq

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(device)

    if name == "flash_fwd":
        q, k, v = (rnd(2, 33, 2 * 64, dtype=torch.bfloat16)
                   for _ in range(3))
        return lambda: fa.flash_attention_with_lse(
            q, k, v, causal=True, layout="bsm", n_heads=2)
    if name == "flash_bwd":
        q, k, v, o, go = (rnd(2, 4, 33, 64, dtype=torch.bfloat16)
                          for _ in range(5))
        lse = rnd(2, 4, 33)
        return lambda: fa.flash_attention_bwd(q, k, v, o, lse, go,
                                              causal=True, layout="bhsd")
    if name == "fused_adamw":
        p, m, v, gr = rnd(100), rnd(100), rnd(100).abs(), rnd(100)
        count = torch.zeros((), dtype=torch.int32, device=device)
        spec = fadam.FusedAdamSpec(1e-3)
        return lambda: fadam.fused_adamw_update(p, m.clone(), v.clone(), gr,
                                                count, spec)
    if name == "quantize_blockwise":
        x = rnd(1000)
        return lambda: tq.quantize_blockwise(x, 256)
    if name == "dequantize_blockwise":
        q = torch.randint(-127, 127, (1000,), generator=g).to(
            torch.int8).to(device)
        s = rnd(4).abs()
        return lambda: tq.dequantize_blockwise(q, s, 256, torch.bfloat16)
    if name == "fp8_cast":
        x, r = rnd(24, 40, dtype=torch.bfloat16), rnd(24, 40)
        hist = rnd(16).abs()
        return lambda: tq.fp8_cast(x, hist, torch.float8_e4m3fn,
                                   residual=r)
    if name == "fp8_matmul":
        x = rnd(24, 40).to(torch.float8_e4m3fn)
        w = rnd(36, 40).to(torch.float8_e4m3fn)
        return lambda: tq.fp8_matmul(x, w.t(), torch.tensor(0.5).to(device),
                                     out_dtype=torch.bfloat16)
    x = rnd(5, 64, dtype=torch.bfloat16)
    w = tq.quantize_weight(rnd(64, 48))
    w = tq.QuantizedWeight(w.q.to(device), w.scales.to(device))
    return lambda: tq.int8_weight_matmul(x, w, rnd(48))


def _shapes(out):
    leaves = out if isinstance(out, (tuple, list)) else [out]
    return [None if t is None else (tuple(t.shape), t.dtype) for t in leaves]


@pytest.mark.parametrize("name", OPS)
def test_each_fake_gives_its_plain_versions_shapes(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    plain = _shapes(_op_case(name, "cpu")())
    mode = FakeTensorMode()
    with mode:
        fake = _op_case(name, "cpu")()
    assert _shapes(fake) == plain
    leaves = fake if isinstance(fake, (tuple, list)) else [fake]
    assert all(t is None or t.device.type == "cpu" for t in leaves)
    # The op the wrapper went through is the hvt op, and its fake ran.
    log = []

    class Log(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            log.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    with FakeTensorMode(), Log():
        _op_case(name, "cpu")()
    assert f"hvt::{name}" in log


# -- the step's wrappers -------------------------------------------------------


def _bf16_regression(**kw):
    """A step whose gradients reduce in bf16: a low-precision-collective
    ERROR for the lint."""
    rs = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rs.standard_normal((16, 8)).astype(
        np.float32)).to(torch.bfloat16)}
    batch = torch.from_numpy(rs.standard_normal((4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    step, opt = tdp.make_train_step(
        lambda p, b: (b @ p["w"]).float().square().mean(),
        topt.fused_adamw(1e-2), sharded=True, fused_update=True,
        device="cpu", **kw)
    return step, tdp.init_state(params, opt), batch


def test_lint_raise_aborts_before_dispatch_and_a_retry_lints_again():
    step, state, batch = _bf16_regression(lint="raise")
    w0 = state.params["w"].detach().clone()
    for _ in range(2):
        with pytest.raises(tfind.LintError,
                           match="low-precision-collective") as err:
            step(state, batch)
        assert torch.equal(state.params["w"], w0)
        assert int(state.step) == 0
        assert {f.rule for f in err.value.findings} == {
            "low-precision-collective"}
    # The allowlist lets it through; the lint then latches.
    step, state, batch = _bf16_regression(
        lint="raise", lint_allow=("low-precision-collective",))
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    assert int(state.step) == 2


def test_lint_warn_warns_once_and_runs():
    step, state, batch = _bf16_regression(lint="warn")
    with pytest.warns(UserWarning, match="hvdtpu lint: ERROR"):
        state, _ = step(state, batch)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state, _ = step(state, batch)
    assert int(state.step) == 2
    with pytest.raises(ValueError, match="lint must be one of"):
        _bf16_regression(lint="error")


def test_guarded_step_lints_clean():
    from horovod_tpu_torch.guard import GuardConfig, fresh_state

    step, state, batch = _regression(_mse, guard=GuardConfig(audit_every=0))
    assert state.guard is None  # the state a user naturally builds
    assert _lint(step, state, batch) == ()
    import dataclasses

    seeded = dataclasses.replace(state, guard=fresh_state(
        torch.device("cpu")))
    assert _lint(step, seeded, batch) == ()


def test_quant_sweep_variant_lints_without_errors():
    # The reference's twin asserts no findings; its step donates the EF
    # residuals and the moments, where the port's replaces them (ROADMAP
    # §C), so the port's memory pass reports that reuse and nothing else.
    findings = tharness.lint_model("mlp", quant="int8")
    assert tfind.errors(findings) == ()
    assert {f.rule for f in findings} == {"donation-missed-reuse"}
    assert {f.details["label"] for f in findings} == {
        "arg0.opt_state.inner.mu['hidden.0.weight']",
        "arg0.opt_state.inner.nu['hidden.0.weight']",
        "arg0.opt_state.residual.buffers[0]"}
    # and the broken case still fires: a quant prediction against an
    # unquantized build must produce fusion-parity findings.
    from horovod_tpu_torch.ops.compression import Compression

    step, state, batch = tharness.build_step("mlp")
    with tan.simulated_world(8):
        found = tan.lint_traced(step._program, (state, batch),
                                params=state.params, world=8,
                                quant=Compression.int8.with_block(8))
    assert any(f.rule == "fusion-parity" for f in found)
