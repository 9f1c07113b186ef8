"""The port's memory planner (``horovod_tpu_torch/analysis/memory.py``)
held against the JAX package's (``horovod_tpu/analysis/memory.py``).

The plan of GPT-2 tiny's ZeRO-1 step at a simulated world of 8 is held
against the reference's plan of the same step on 8 virtual CPU devices
(under the ``jax.core`` shim of ``tests/torch_analysis_ref.py``):

* params: equal bytes (432,128);
* opt_state: the reference's 108,052 bytes less 12: the reference keeps
  the ZeRO-1 layout recipe (threshold, world, block) as three int32
  device scalars, the port as Python ints (ROADMAP §C);
* activations within a factor of 1.5 either way of the reference's
  1,264,777: the reference prices a fully materialized XLA schedule from
  the jaxpr, the port the eager lifetimes of the record (autograd's saved
  tensors, temporaries freed as their last reference dies), so the two
  attribute the same program's bytes differently; 0.85x on this build.

On the CPU the measured side is the live state (``live_arrays``): the
plan's resident bytes must match what a real step leaves alive.
"""

import json

import numpy as np
import pytest
import torch

from horovod_tpu_torch import analysis as tan
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.analysis import harness as tharness
from horovod_tpu_torch.analysis import memory as tmem
from horovod_tpu_torch.parallel import dp as tdp

from torch_analysis_ref import reference_world

REF_PARAMS = 432128
REF_OPT_STATE = 108052
RECIPE_SCALARS = 3 * 4  # threshold, world, block as int32 device scalars
REF_ACTIVATIONS = 1264777
ACTIVATION_FACTOR = 1.5


@pytest.fixture(scope="module")
def reference_plan():
    with reference_world() as jh:
        return jh.memplan_model("gpt2", sharded=True).to_dict()


def test_plan_matches_the_reference(reference_plan):
    plan = tharness.memplan_model("gpt2", sharded=True)
    assert reference_plan["params_bytes"] == REF_PARAMS
    assert reference_plan["opt_state_bytes"] == REF_OPT_STATE
    assert plan.params_bytes == REF_PARAMS
    assert plan.opt_state_bytes + RECIPE_SCALARS == REF_OPT_STATE
    assert plan.breakdown["params"] == REF_PARAMS
    ratio = plan.breakdown["activations"] / REF_ACTIVATIONS
    assert 1 / ACTIVATION_FACTOR <= ratio <= ACTIVATION_FACTOR, ratio
    assert set(plan.breakdown) == set(reference_plan["breakdown"])
    assert set(plan.to_dict()) == set(reference_plan)
    assert sum(plan.breakdown.values()) == plan.peak_bytes
    assert plan.world == reference_plan["world"] == 8


def test_the_plan_orders_the_builds_as_the_reference_does():
    rep = tharness.memplan_model("gpt2")
    z1 = tharness.memplan_model("gpt2", sharded=True)
    fused = tharness.memplan_model("gpt2", sharded=True, fused_update=True)
    # ZeRO-1 holds 1/8 of the (padded) moments; the fused update adds no
    # moments of its own.
    assert z1.opt_state_bytes * 7 < rep.opt_state_bytes
    assert z1.peak_bytes < rep.peak_bytes
    assert fused.peak_bytes <= z1.peak_bytes
    proj = tan.project_sharding(z1)
    assert proj["zero3_peak_bytes"] < proj["zero2_peak_bytes"] < \
        proj["zero1_peak_bytes"] == z1.peak_bytes


def test_per_block_remat_lowers_the_planned_peak():
    from horovod_tpu_torch.models import GPT2Config, GPT2LMModel

    peaks = {}
    for remat in ("none", "full"):
        cfg = GPT2Config.tiny(param_dtype=torch.float32, remat=remat,
                              n_layers=4)
        with torch.random.fork_rng():
            torch.manual_seed(0)
            model = GPT2LMModel(cfg, device="cpu")
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (4, 129))).long()

        def loss(p, t, model=model):
            logits = torch.func.functional_call(model, p, (t[:, :-1],))
            return torch.nn.functional.cross_entropy(
                logits.float().flatten(0, 1), t[:, 1:].flatten())

        step, opt = tdp.make_train_step(loss, topt.fused_adamw(1e-3),
                                        sharded=True, fused_update=True,
                                        device="cpu")
        state = tdp.init_state(
            {k: v.detach().clone() for k, v in model.named_parameters()},
            opt)
        peaks[remat] = step.memplan(state, tokens).breakdown["activations"]
    assert peaks["full"] < peaks["none"]


def test_resident_bytes_match_a_real_step_on_the_cpu():
    rs = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rs.standard_normal((64, 32)).astype(
        np.float32)), "b": torch.zeros(32)}
    batch = {"x": torch.from_numpy(rs.standard_normal((16, 64)).astype(
        np.float32)), "y": torch.from_numpy(rs.standard_normal(
            (16, 32)).astype(np.float32))}

    def loss(p, b):
        return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()

    step, opt = tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu")
    state = tdp.init_state(params, opt)
    plan = step.memplan(state, batch)
    measured, source = tmem.measure_step_bytes(lambda: step(state, batch),
                                               inputs=(batch,))
    assert source == "live_arrays"
    gate = tan.compare_to_measured(plan, measured, source)
    assert gate["ok"], gate
    assert gate["ratio"] == 1.0
    # The planned peak holds the state, its replaced moments and the
    # step's temporaries: above the resident bytes.
    assert plan.peak_bytes > plan.global_state_bytes


def test_replaced_state_is_a_missed_reuse_finding():
    # The replicated AdamW replaces its moments each step: at this size
    # they are a large share of the peak, and the memory pass says so.
    rs = np.random.RandomState(1)
    params = {"w": torch.from_numpy(rs.standard_normal((256, 256)).astype(
        np.float32))}
    batch = torch.from_numpy(rs.standard_normal((4, 256)).astype(np.float32))
    step, opt = tdp.make_train_step(lambda p, b: (b @ p["w"]).square().mean(),
                                    topt.adamw(1e-2), device="cpu")
    state = tdp.init_state(params, opt)
    found = step.lint(state, batch)
    labels = sorted(f.details["label"] for f in found
                    if f.rule == "donation-missed-reuse")
    assert labels == ["arg0.opt_state.inner.mu['w']",
                      "arg0.opt_state.inner.nu['w']"]
    assert all(str(f.severity) == "WARNING" for f in found)
    # The fused ZeRO-1 update updates its moments in place: no finding.
    step, opt = tdp.make_train_step(lambda p, b: (b @ p["w"]).square().mean(),
                                    topt.fused_adamw(1e-2), sharded=True,
                                    fused_update=True, device="cpu")
    state = tdp.init_state({"w": params["w"].detach().clone()}, opt)
    assert step.lint(state, batch) == ()


def test_oom_risk_fires_over_the_env_budget(monkeypatch):
    step, state, batch = tharness.build_step("gpt2", sharded=True)
    monkeypatch.setenv("HVDTPU_HBM_BUDGET_GB", "0.001")
    with tan.simulated_world(8):
        found = step.lint(state, batch)
    assert [f.rule for f in found] == ["oom-risk"]
    assert found[0].details["budget_bytes"] == int(0.001 * (1 << 30))
    from horovod_tpu_torch.utils import env as tenv

    monkeypatch.setenv("HVDTPU_HBM_BUDGET_GB", "-1")
    with pytest.raises(ValueError, match="HBM_BUDGET_GB"):
        tenv.hbm_budget_bytes()


def test_memplan_publishes_the_peak_gauge():
    from horovod_tpu_torch.obs import registry

    registry._registry.reset()
    registry._enabled = None
    try:
        registry.enable()
        plan = tharness.memplan_model("gpt2", sharded=True)
        snap = registry.metrics().snapshot()
        assert snap["gauges"]["memplan.peak_bytes"] == plan.peak_bytes
    finally:
        registry._registry.reset()
        registry._enabled = None


def test_checked_in_baselines_cover_the_sweep_and_gate_regressions(tmp_path):
    from horovod_tpu_torch.tools import hvdtpu_memplan

    with open(hvdtpu_memplan.DEFAULT_BASELINES) as f:
        doc = json.load(f)
    assert doc["size"] == "tiny" and doc["world"] == 8
    keys = {f"{m}/{tharness.variant_label(v)}" for m in tharness.SWEEP_MODELS
            for v in tharness.SWEEP_VARIANTS}
    assert set(doc["peaks"]) == keys
    peak = tharness.memplan_model("gpt2", sharded=True).peak_bytes
    assert doc["peaks"]["gpt2/sharded"] == peak
    rows = tharness.memplan_sweep(["gpt2"], variants=[{"sharded": True}],
                                  baselines={"gpt2/sharded": peak // 2})
    assert [f.rule for f in rows["gpt2"]["sharded"]["findings"]] == [
        "peak-regression"]
    rows = tharness.memplan_sweep(["gpt2"], variants=[{"sharded": True}],
                                  baselines={})
    assert "no checked-in peak baseline" in \
        rows["gpt2"]["sharded"]["findings"][0].message


def test_memplan_tolerance_knob_matches_the_reference(monkeypatch):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as tenv

    for val in (None, "0.1", "1"):
        if val is None:
            monkeypatch.delenv("HVDTPU_MEMPLAN_TOLERANCE", raising=False)
        else:
            monkeypatch.setenv("HVDTPU_MEMPLAN_TOLERANCE", val)
        assert tenv.memplan_tolerance() == jenv.memplan_tolerance()
    monkeypatch.setenv("HVDTPU_MEMPLAN_TOLERANCE", "0")
    with pytest.raises(ValueError, match="MEMPLAN_TOLERANCE"):
        tenv.memplan_tolerance()
    monkeypatch.setenv("HVDTPU_MEMPLAN_BASELINES", "baselines.json")
    assert tenv.memplan_baselines_path() == jenv.memplan_baselines_path()
