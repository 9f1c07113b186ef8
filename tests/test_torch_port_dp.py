"""The port's train-step plumbing held against the JAX package's, on the
CPU: ``accumulate_gradients``, the training env knobs, the FLOP model,
``params_to_flax``, fp32 master weights, and the ``make_train_step`` knobs
that are not ported yet or that it refuses; ``op=Adasum`` equal to Average
at one process, ``axis=`` naming a mesh axis, and a user's
``DistributedOptimizer(backward_passes_per_step=2)`` whose skipped step
leaves the parameters bit for bit (a -0.0 among them) and whose syncing
step is AdamW on the summed gradients, bit for bit.

Tolerances: ``accumulate_gradients`` in fp32 within 1e-6 of the largest
value (the same sums, taken by XLA and by torch in other orders); the
fp32-master GPT-2 forward equal to the bf16-stored one bit for bit (a cast
at each op rounds the weight exactly as the cast at load does); the FLOP
model and the knobs exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.obs import flops as jflops
from horovod_tpu.parallel import dp as jdp
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch import convert
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.obs import flops as tflops
from horovod_tpu_torch.ops.collectives import ReduceOp
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel import dp as tdp
from horovod_tpu_torch.utils import env as tenv


def _problem(seed=0):
    rs = np.random.RandomState(seed)
    params = {"w": rs.standard_normal((4, 3)).astype(np.float32),
              "b": rs.standard_normal((3,)).astype(np.float32)}
    batch = {"x": rs.standard_normal((8, 4)).astype(np.float32),
             "y": rs.standard_normal((8, 3)).astype(np.float32)}
    return params, batch


@pytest.mark.parametrize("accum_steps", [1, 2, 4])
@pytest.mark.parametrize("has_aux", [False, True])
def test_accumulate_gradients_matches_the_reference(accum_steps, has_aux):
    params, batch = _problem()

    def jloss(p, b):
        err = b["x"] @ p["w"] + p["b"] - b["y"]
        loss = jnp.mean(err * err)
        return (loss, jnp.sum(b["x"])) if has_aux else loss

    def tloss(p, b):
        err = b["x"] @ p["w"] + p["b"] - b["y"]
        loss = (err * err).mean()
        return (loss, b["x"].sum()) if has_aux else loss

    jl, jaux, jg = jdp.accumulate_gradients(
        jloss, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch), accum_steps, has_aux=has_aux,
    )
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tl, taux, tg = tdp.accumulate_gradients(
        tloss, tp, jax.tree.map(torch.from_numpy, batch), accum_steps,
        has_aux=has_aux,
    )
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert not tl.requires_grad
    if has_aux:  # the last microbatch's aux
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    for k in params:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_accumulate_gradients_rejects_uneven_microbatches():
    params, batch = _problem()
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    with pytest.raises(ValueError, match="not divisible"):
        tdp.accumulate_gradients(lambda p, b: p["w"].sum(), tp,
                                 jax.tree.map(torch.from_numpy, batch), 3)


def test_training_knobs_share_the_reference_names_and_defaults(monkeypatch):
    knobs = ("fused_update_default", "overlap_accum_steps")
    for k in knobs:
        assert getattr(tenv, k)() == getattr(jenv, k)(), k
    assert tenv.FUSED_UPDATE == jenv.FUSED_UPDATE
    assert tenv.OVERLAP_ACCUM_STEPS == jenv.OVERLAP_ACCUM_STEPS
    monkeypatch.setenv("HVDTPU_FUSED_UPDATE", "yes")
    monkeypatch.setenv("HOROVOD_OVERLAP_ACCUM_STEPS", "0")
    for k in knobs:
        assert getattr(tenv, k)() == getattr(jenv, k)(), k
    assert tenv.fused_update_default() and tenv.overlap_accum_steps() == 1


def test_flop_model_matches_the_reference():
    for args in [(85_000_000, 12, 1024, 768), (1, 1, 1, 1)]:
        assert tflops.transformer_flops_per_token(*args) == (
            jflops.transformer_flops_per_token(*args))
    assert tflops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert np.isnan(tflops.peak_tflops("cpu"))
    assert tflops.mfu(1e5, 6e8, "cpu") is None
    assert tflops.mfu(1e5, 6e8, peak=100.0) == pytest.approx(0.6)
    assert tflops.mfu(1e5, 6e8, "NVIDIA H100 80GB HBM3") == pytest.approx(
        1e5 * 6e8 / 1e12 / 989.0)


def test_params_to_flax_inverts_params_from_flax():
    cfg = GPT2Config.tiny()
    sd = convert.init_params(cfg, seed=3)
    flax = convert.params_to_flax(sd, cfg.n_heads)
    back = convert.params_from_flax(flax)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_fp32_master_weights_compute_like_the_bf16_model():
    # param_dtype=fp32 stores fp32 weights and casts them to bf16 at each
    # op; the bf16-stored model cast them once at load: the same logits.
    cfg = GPT2Config.tiny(use_flash=True)
    sd = convert.init_params(cfg, seed=4)
    stored = GPT2LMModel(cfg, device="cpu")
    master = GPT2LMModel(dataclasses.replace(cfg, param_dtype=torch.float32),
                         device="cpu")
    stored.load_state_dict(sd)
    master.load_state_dict(sd)
    assert master.transformer.wte.weight.dtype == torch.float32
    assert stored.transformer.wte.weight.dtype == torch.bfloat16
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        assert torch.equal(master(tokens), stored(tokens))
    master(tokens).float().logsumexp(-1).mean().backward()
    for name, p in master.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name


@pytest.mark.parametrize("knob,value", [
    ("overlap", True), ("stagger", True), ("lint", "raise"), ("guard", True),
    ("autotune", True), ("publish", 2), ("remat", "full"),
    ("compute_dtype", "fp8"), ("act_quant", "int8"),
])
def test_unported_train_step_knobs_raise_naming_their_slice(knob, value):
    if knob == "remat":
        # Ported (test_torch_port_remat.py): it builds and runs a step that
        # checkpoints the loss, and a typo raises as in the JAX package.
        _remat_step_runs(value)
        from horovod_tpu.ops import remat as jremat

        # (the resolver the JAX make_train_step validates its knob with)
        with pytest.raises(ValueError, match="unknown remat policy"):
            jremat.resolve_policy("fulll")
        with pytest.raises(ValueError, match="unknown remat policy"):
            _port_build(remat="fulll")
    elif knob in ("overlap", "stagger"):
        # Ported (test_torch_port_overlap.py): the step reduces its buckets
        # from the gradient hooks (overlap) or after the backward (stagger
        # alone, the plain step), bit for bit the plain step.
        run = _knob_step_runs(**{knob: value})
        assert run["params"] == _knob_step_runs()["params"]
        assert run["inside"] == [knob == "overlap"]
    elif knob == "act_quant":
        # Ported (test_torch_port_actquant.py): the loss runs with the int8
        # boundaries armed, and a mode the JAX package does not know raises
        # as its resolve_mode does.
        from horovod_tpu.ops import actquant as jaq

        assert _knob_step_runs(act_quant=value)["modes"] == ["int8"]
        with pytest.raises(ValueError, match="not recognized"):
            jaq.resolve_mode("int4")
        with pytest.raises(ValueError, match="not recognized"):
            _port_build(act_quant="int4")
    elif knob == "guard":
        # Ported (test_torch_port_guard.py): the step screens its gradients
        # and keeps the guard's bookkeeping; on clean data it is the
        # unguarded step bit for bit.
        run = _knob_step_runs(**{knob: value})
        assert run["guarded"] == [True]
        assert run["params"] == _knob_step_runs()["params"]
    elif knob == "compute_dtype":
        # Ported: fp8 compute builds on the replicated path and refuses
        # ZeRO-1, as the JAX package does (test_torch_port_fp8_train.py).
        with pytest.raises(NotImplementedError, match="replicated-path only"):
            tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-3),
                                device="cpu", sharded=True, **{knob: value})
        tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-3), device="cpu",
                            **{knob: value})
    elif knob == "autotune":
        # Ported (test_torch_port_tune.py): the step runs inside the
        # closed-loop tuner's local search, bit for bit the plain step at
        # one process (the fusion threshold it tunes cannot change the
        # math of a one-rank reduction).
        run = _tuned_step_runs(value)
        assert run["tuned"] and run["params"] == _tuned_step_runs(False)[
            "params"]
    elif knob == "publish":
        # Ported (test_torch_port_stream.py): the step carries a weight
        # publisher on the given cadence, and a step publishes into its KV.
        run = _tuned_step_runs(False, publish=value)
        assert run["published"] == [2]
    else:
        with pytest.raises(NotImplementedError,
                           match="not ported yet.*arrives with"):
            tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-3),
                                device="cpu", **{knob: value})
    # Their off values build a step.
    # (act_quant's explicit off is "", as the JAX package's resolve_mode
    # takes it; "off" is an environment spelling only.)
    off = {"lint": "off", "remat": "none", "compute_dtype": None,
           "act_quant": "", "publish": 0}.get(knob, False)
    tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-3), device="cpu",
                        **{knob: off})


def test_train_step_argument_checks():
    # The quantized wire reduces with Average or Sum only, as in the JAX
    # package.
    with pytest.raises(ValueError, match="Average/Sum"):
        tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-3), device="cpu",
                            compression=Compression.int8, op=ReduceOp.ADASUM)
    with pytest.raises(ValueError, match="sharded=True"):
        tdp.make_train_step(lambda p, b: 0.0, topt.fused_adamw(1e-3),
                            device="cpu", fused_update=True)
    params, batch = _problem()
    step, opt = tdp.make_train_step(
        lambda p, b: ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean(),
        topt.adamw(1e-2), device="cpu", accum_steps=2,
    )
    state = tdp.init_state(
        {k: torch.from_numpy(v) for k, v in params.items()}, opt)
    state, loss = step(state, jax.tree.map(torch.from_numpy, batch))
    assert int(state.step) == 1 and loss.shape == ()
    meta = {"w": torch.empty((4, 3), device="meta")}
    with pytest.raises(ValueError, match="this step runs on cpu"):
        step(tdp.TrainState(meta, state.opt_state, state.step), batch)


def _port_build(**kw):
    return tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-3),
                               device="cpu", **kw)


def _knob_step_runs(**kw):
    """Two steps of a small regression (one bucket a leaf) through
    make_train_step(**kw) on one process: the parameters, the act-quant
    mode the loss ran under, whether a bucket was reduced inside the
    backward, and whether the state carries the guard's bookkeeping."""
    from horovod_tpu_torch.ops import actquant as taq
    from horovod_tpu_torch.ops import fusion as tfusion

    params, batch = _problem()
    modes, inside = [], []
    orig = tfusion.reduce_bucket

    def spy(leaves, **k):
        inside.append(torch._C._current_graph_task_id() >= 0)
        return orig(leaves, **k)

    def loss(p, b):
        modes.append(taq.active_mode())
        return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()

    tfusion.reduce_bucket = spy
    try:
        step, opt = tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu",
                                        threshold_bytes=8, **kw)
        state = tdp.init_state(
            {k: torch.from_numpy(v) for k, v in params.items()}, opt)
        for _ in range(2):
            state, _ = step(state, jax.tree.map(torch.from_numpy, batch))
    finally:
        tfusion.reduce_bucket = orig
    return {"params": {k: v.detach().numpy().tobytes()
                       for k, v in state.params.items()},
            "modes": sorted(set(modes)), "inside": sorted(set(inside)),
            "guarded": [state.guard is not None]}


class _DictKV:
    """An in-memory KV with the ``put``/``get`` surface of the elastic
    client, for the weight publisher."""

    def __init__(self):
        self.data = {}

    def put(self, scope, key, value):
        self.data[(scope, key)] = bytes(value)

    def get(self, scope, key):
        return self.data.get((scope, key))


def _tuned_step_runs(autotune, **kw):
    """Three steps of a small regression through make_train_step(
    autotune=..., **kw) on one process: the parameters, whether the step
    came back tuned, and the versions a publisher (if any) wrote."""
    from horovod_tpu_torch import tune as ttune
    from horovod_tpu_torch.stream import protocol as tproto

    if autotune is True:
        autotune = ttune.AutotuneConfig(window_steps=1, warmup_steps=0,
                                        max_trials=2, patience=2, seed=1)
    params, batch = _problem()

    def loss(p, b):
        return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()

    step, opt = tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu",
                                    autotune=autotune, **kw)
    kv = _DictKV()
    if getattr(step, "stream_publisher", None) is not None:
        step.stream_publisher.kv = kv
    state = tdp.init_state(
        {k: torch.from_numpy(v) for k, v in params.items()}, opt)
    for _ in range(3):
        state, _ = step(state, jax.tree.map(torch.from_numpy, batch))
    head = kv.get("stream", tproto.HEAD_KEY)
    return {
        "params": {k: v.detach().numpy().tobytes()
                   for k, v in state.params.items()},
        "tuned": hasattr(step, "autotune"),
        "published": ([] if head is None
                      else [tproto.unframe_manifest(head)["version"]]),
    }


def _remat_step_runs(remat=None):
    """One step of a small regression through make_train_step(remat=...);
    returns how many times the loss function ran (2: checkpointed)."""
    params, batch = _problem()
    calls = []

    def loss(p, b):
        calls.append(1)
        return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()

    kw = {} if remat is None else {"remat": remat}
    step, opt = tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu",
                                    **kw)
    state = tdp.init_state(
        {k: torch.from_numpy(v) for k, v in params.items()}, opt)
    state, out = step(state, jax.tree.map(torch.from_numpy, batch))
    assert np.isfinite(float(out))
    return len(calls)


# (env var, armed value, make_train_step argument, its explicit off value);
# None for the argument is the serving pool's knob.
_ENV_KNOBS = [
    ("HVDTPU_OVERLAP", "1", "overlap", False),
    ("HVDTPU_LINT", "raise", "lint", "off"),
    ("HVDTPU_REMAT", "full", "remat", "none"),
    ("HVDTPU_ACT_QUANT", "int8", "act_quant", ""),
    ("HVDTPU_GUARD", "yes", "guard", False),
    ("HVDTPU_PUBLISH_EVERY", "3", "publish", 0),
    ("HVDTPU_AUTOTUNE", "on", "autotune", False),
    ("HVDTPU_AUTOTUNE", "on", None, False),
]


@pytest.mark.parametrize("var,armed,knob,off", _ENV_KNOBS,
                         ids=[k or "serve_pool" for _, _, k, _ in _ENV_KNOBS])
def test_armed_env_default_raises_like_the_explicit_argument(
        monkeypatch, var, armed, knob, off):
    from horovod_tpu_torch.serve import ServePool

    def build(**kw):
        if knob is None:
            pool = ServePool(lambda p, b: b, {"w": torch.ones(1)},
                             device="cpu", **kw)
            pool.stop()
        else:
            tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-3),
                                device="cpu", **kw)

    # The reference reads the same variable and resolves the same value.
    accessor = {"HVDTPU_OVERLAP": "overlap_default", "HVDTPU_LINT": "lint_mode",
                "HVDTPU_REMAT": "remat_mode",
                "HVDTPU_ACT_QUANT": "act_quant_mode",
                "HVDTPU_GUARD": "guard_default",
                "HVDTPU_PUBLISH_EVERY": "publish_every",
                "HVDTPU_AUTOTUNE": "autotune_default"}[var]
    assert getattr(tenv, accessor)() == getattr(jenv, accessor)()
    build()  # unset: off
    monkeypatch.setenv(var, armed)
    assert getattr(tenv, accessor)() == getattr(jenv, accessor)()
    assert getattr(tenv, accessor)()
    if knob == "remat":
        # Ported: the armed default checkpoints the loss (its forward runs
        # again in the backward), as the explicit argument does, and an
        # explicit off value wins over the environment.
        assert _remat_step_runs() == 2
        assert _remat_step_runs(armed) == 2
        assert _remat_step_runs(off) == 1
        return
    if knob == "overlap":
        # Ported: the armed default reduces the buckets from inside the
        # backward, as overlap=True does, bit for bit the plain step; an
        # explicit False wins over the environment.
        on, off_run = _knob_step_runs(), _knob_step_runs(overlap=off)
        assert on["inside"] == [True] and off_run["inside"] == [False]
        assert on["params"] == off_run["params"]
        assert _knob_step_runs(overlap=True)["inside"] == [True]
        return
    if knob == "guard":
        # Ported: the armed default guards the step, as guard=True does,
        # and an explicit False wins over the environment.
        assert _knob_step_runs()["guarded"] == [True]
        assert _knob_step_runs(guard=True)["guarded"] == [True]
        assert _knob_step_runs(guard=off)["guarded"] == [False]
        return
    if knob == "act_quant":
        # Ported: the armed default runs the loss with the boundaries
        # armed, as the explicit argument does; an explicit "" wins.
        assert _knob_step_runs()["modes"] == ["int8"]
        assert _knob_step_runs(act_quant=armed)["modes"] == ["int8"]
        assert _knob_step_runs(act_quant=off)["modes"] == [""]
        return
    if knob is None:
        # Ported: the armed default starts the pool's serving tuner, as
        # autotune=True does; an explicit False wins over the environment.
        from horovod_tpu_torch.serve import ServePool

        for kw, tuned in (({}, True), ({"autotune": off}, False)):
            pool = ServePool(lambda p, b: b, {"w": torch.ones(1)},
                             device="cpu", **kw).start()
            try:
                assert (pool.tuner is not None) == tuned
            finally:
                pool.stop()
        return
    if knob == "autotune":
        # Ported: the armed default wraps the step in the tuner, as
        # autotune=True does; an explicit False wins over the environment.
        assert _tuned_step_runs(None)["tuned"]
        assert not _tuned_step_runs(off)["tuned"]
        return
    if knob == "publish":
        # Ported: the armed default publishes every 3 steps, as publish=3
        # does; an explicit 0 wins over the environment.
        assert _tuned_step_runs(False)["published"] == [3]
        assert _tuned_step_runs(False, publish=off)["published"] == []
        return
    match = "not ported yet.*arrives with"
    with pytest.raises(NotImplementedError, match=match):
        build()
    # The explicit argument raises the same way.
    with pytest.raises(NotImplementedError, match=match):
        tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-3),
                            device="cpu", **{knob: armed})
    # An explicit off value wins over the environment.
    build(**{knob: off})


# -- Adasum, axis= and a user's accumulating optimizer (one process) -------


def _regression_step(opt, **kw):
    params, batch = _problem()
    step, wopt = tdp.make_train_step(
        lambda p, b: ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean(), opt,
        device="cpu", **kw)
    state = tdp.init_state(
        {k: torch.from_numpy(v) for k, v in params.items()}, wopt)
    return step, wopt, state, jax.tree.map(torch.from_numpy, batch)


def test_adasum_step_is_the_average_step_at_one_process():
    # At one process both reductions are the identity: the same parameters
    # and AdamW state bit for bit (chip_smoke's [train-adasum] check 1).
    runs = {}
    for op in (ReduceOp.ADASUM, ReduceOp.AVERAGE):
        step, _, state, batch = _regression_step(topt.adamw(1e-2), op=op)
        for _ in range(2):
            state, loss = step(state, batch)
        runs[op] = state
    a, b = runs[ReduceOp.ADASUM], runs[ReduceOp.AVERAGE]
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
        assert torch.equal(a.opt_state.inner.mu[k], b.opt_state.inner.mu[k])
    with pytest.raises(ValueError, match="supports Average/Sum"):
        _regression_step(topt.adamw(1e-2), op=ReduceOp.ADASUM, sharded=True)


def test_train_step_axis_names_a_mesh_axis():
    from horovod_tpu_torch import context
    from horovod_tpu_torch.exceptions import HorovodTpuError

    context.init(device="cpu", mesh={"dp": 1, "tp": 1}, world_axes=["dp"])
    try:
        step, _, state, batch = _regression_step(topt.adamw(1e-2), axis="dp")
        state, loss = step(state, batch)
        assert int(state.step) == 1 and np.isfinite(float(loss))
        with pytest.raises(HorovodTpuError, match="unknown mesh axis"):
            _regression_step(topt.adamw(1e-2), axis="nope")
    finally:
        context.shutdown()


def test_user_accumulating_optimizer_skips_bit_for_bit():
    # distribute_optimizer=False with DistributedOptimizer(k=2): the first
    # step leaves parameters and AdamW state as they were, bit for bit; the
    # second equals one AdamW step on g1 + g2 computed on its own.
    inner = topt.adamw(1e-2)
    opt = topt.DistributedOptimizer(inner, backward_passes_per_step=2)
    step, _, state, batch = _regression_step(opt, distribute_optimizer=False)
    with torch.no_grad():  # a -0.0 parameter stays -0.0 through a skip
        state.params["b"][0] = -0.0
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    batch2 = {k: v * 0.5 for k, v in batch.items()}
    _, _, g1 = tdp.accumulate_gradients(
        lambda p, b: ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean(),
        state.params, batch, 1)
    state, _ = step(state, batch)
    for k in p0:
        assert torch.equal(state.params[k].view(torch.int32),
                           p0[k].view(torch.int32))
    assert torch.signbit(state.params["b"][0])
    assert int(state.opt_state.inner.count) == 0
    _, _, g2 = tdp.accumulate_gradients(
        lambda p, b: ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean(),
        state.params, batch2, 1)
    state, _ = step(state, batch2)
    want, _ = inner.update({k: g1[k] + g2[k] for k in g1}, inner.init(p0), p0)
    for k in p0:
        assert torch.equal(state.params[k], p0[k] + want[k]), k
    assert int(state.opt_state.inner.count) == 1
