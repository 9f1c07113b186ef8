"""The port's ``make_train_step(compute_dtype="fp8")`` held against the JAX
package's, on GPT-2 tiny.

* Three steps on a world of 2 -- a gloo world of 2 CPU processes for the
  port (``context.spawn_gloo``), the JAX step on 2 CPU devices -- from the
  same seeded flax parameters (fp32 compute, so that the comparison sees
  the algorithm and not bf16 rounding; plain attention on both sides) and
  the same global batch of 4 sequences, rank r rows ``[2r, 2r + 2)``, with
  ``adamw(1e-2)``. Tolerances, with their reasons (seen in brackets):
  losses within 1e-5 relative (fp32 sums in other orders; equal); each
  regular leaf's movement within 1e-3 of the reference's movement in L2
  (Adam turns fp32 noise on near-zero gradients into steps of up to lr, as
  in ``test_torch_port_train.py``; 2.8e-6; the key bias, whose exact
  gradient is 0, is held to the lr-per-step bound alone); the amax rings
  within 1e-5 relative, slot by slot (amaxes of activations and gradients
  that agree to fp32 noise; 7.5e-7); the weight-cast residuals within 1e-2
  of their norm in L2 (1.3e-5; an e4m3 rounding flipped by an ulp of its
  input moves one element of the 64x64 residual by a whole step, about
  1.5% of the norm). The two port ranks end with identical parameters and state
  (tolerance 0): the rings are averaged by the allreduce.
* The refusals (ZeRO-1, an op other than Average), arming through
  ``HVDTPU_COMPUTE_DTYPE``, and the state leaves staying out of the
  optimizer's moments.
* The configuration the README drives (bf16 compute, fp32 master weights):
  eight fp8 steps fill every ring, and the last loss lands within 0.15 of
  the bf16 run's, the JAX package's ``bench_fp8`` convergence bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu as hvd
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.parallel import dp as jdp
from horovod_tpu_torch import context, convert
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.ops import fp8 as tf8
from horovod_tpu_torch.ops.collectives import ReduceOp
from horovod_tpu_torch.parallel import dp as tdp

WORLD = 2
STEPS = 3
LR = 1e-2


def _data():
    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, compute_dtype="fp8",
                                use_flash=False)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2 * WORLD, 33)
    ).astype(np.int32)
    params = jgpt2.GPT2LMModel(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:1, :32])
    )["params"]
    return jax.tree.map(np.asarray, params), tokens


def _loss(model):
    def loss_fn(p, t):
        logits = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

    return loss_fn


def _port_train(params, tokens):
    """One rank of the gloo world."""
    rank = context.rank()
    rows = torch.from_numpy(tokens[2 * rank:2 * rank + 2]).long()
    cfg = GPT2Config.tiny(dtype=torch.float32, compute_dtype="fp8",
                          use_flash=False)
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax({"params": params}))
    step, wopt = tdp.make_train_step(_loss(model), topt.adamw(LR),
                                     device="cpu", compute_dtype="fp8")
    state = tdp.init_state(model, wopt)
    moments = sorted(state.opt_state.inner.mu)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, rows)
        losses.append(float(loss))
    return {"losses": losses, "moments": moments,
            "params": convert.params_to_flax(state.params,
                                             cfg.n_heads)["params"]}


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def port_runs(data):
    return context.spawn_gloo(WORLD, _port_train, *data)


@pytest.fixture(scope="module")
def jax_run(data):
    params, tokens = data
    hvd.init(devices=jax.devices("cpu")[:WORLD])
    try:
        cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, compute_dtype="fp8",
                                    use_flash=False)
        model = jgpt2.GPT2LMModel(cfg)

        def loss_fn(p, batch):
            (t,) = batch
            logits = model.apply({"params": p}, t[:, :-1])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, t[:, 1:]
            ).mean()

        step, wopt = jdp.make_train_step(
            loss_fn, optax.adamw(LR, weight_decay=1e-4), compute_dtype="fp8")
        state = jdp.init_state(jax.tree.map(jnp.array, params), wopt)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, (jnp.asarray(tokens),))
            losses.append(float(loss))
        return {"losses": losses,
                "params": jax.tree.map(np.asarray, state.params)}
    finally:
        hvd.shutdown()


def _leaves(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_fp8_train_steps_match_the_reference(data, port_runs, jax_run):
    got_run = port_runs[0]
    np.testing.assert_allclose(got_run["losses"], jax_run["losses"],
                               rtol=1e-5)
    assert got_run["losses"][-1] < got_run["losses"][0]
    p0, want, got = (_leaves(data[0]), _leaves(jax_run["params"]),
                     _leaves(got_run["params"]))
    assert sorted(got) == sorted(want) == sorted(p0)
    n_rings = n_residuals = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if "_amax_history" in name:
            n_rings += 1
            assert w[0] > 0 and np.count_nonzero(w) == STEPS, name
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=name)
        elif "fp8_k_residual" in name:
            n_residuals += 1
            assert np.linalg.norm(w) > 0, name
            assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), name
        else:
            assert np.abs(g - p0[name]).max() <= STEPS * LR * 1.01, name
            if "['key']['bias']" in name:
                continue
            moved = np.linalg.norm(w - p0[name])
            assert moved > 0, name
            err = np.linalg.norm((g - p0[name]) - (w - p0[name]))
            assert err <= 1e-3 * moved, (name, err, moved)
    layers = 2  # GPT-2 tiny: six fp8 projections a layer
    assert n_rings == 3 * 6 * layers and n_residuals == 6 * layers


def test_ranks_end_with_identical_parameters_and_state(port_runs):
    r0, r1 = port_runs
    assert r0["losses"] == r1["losses"]
    for a, b in zip(jax.tree.leaves(r0["params"]), jax.tree.leaves(r1["params"])):
        np.testing.assert_array_equal(a, b)


def test_state_leaves_get_no_moments(port_runs):
    moments = port_runs[0]["moments"]
    assert moments and not any(tf8.has_fp8_state({n: 0}) for n in moments)
    assert "transformer.blocks.0.mlp.fc.weight" in moments


def test_fp8_refuses_sharded_and_non_average():
    loss = lambda p, b: 0.0  # noqa: E731
    with pytest.raises(NotImplementedError, match="replicated-path only"):
        tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu",
                            sharded=True, compute_dtype="fp8")
    with pytest.raises(ValueError, match="op=Average"):
        tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu",
                            op=ReduceOp.SUM, compute_dtype="fp8")
    with pytest.raises(ValueError, match="not recognized"):
        tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu",
                            compute_dtype="fp16")


def _tiny_fp8_step(**kw):
    cfg = GPT2Config.tiny(compute_dtype="fp8", param_dtype=torch.float32)
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(convert.init_params(cfg, seed=0))
    step, opt = tdp.make_train_step(_loss(model), topt.adamw(1e-3),
                                    device="cpu", **kw)
    return model, step, tdp.init_state(model, opt)


def test_hvdtpu_compute_dtype_arms_the_step(monkeypatch):
    monkeypatch.setenv("HVDTPU_COMPUTE_DTYPE", "fp8")
    with pytest.raises(NotImplementedError, match="replicated-path only"):
        tdp.make_train_step(lambda p, b: 0.0, topt.adamw(1e-2), device="cpu",
                            sharded=True)
    _, step, state = _tiny_fp8_step()
    assert not any(tf8.has_fp8_state({n: 0}) for n in state.opt_state.inner.mu)
    tokens = torch.from_numpy(
        np.random.RandomState(1).randint(0, 512, (2, 17))).long()
    ring = state.params["transformer.blocks.1.attn.out.fp8_g_amax_history"]
    state, _ = step(state, tokens)
    # The ring was committed by overwrite: the new amax in slot 0.
    assert float(ring[0].detach()) > 0 and not ring[1:].any()
    # An explicit "" wins over the environment: no state wrapper, so the
    # moments cover every parameter, the rings included.
    _, _, plain = _tiny_fp8_step(compute_dtype="")
    assert any(tf8.has_fp8_state({n: 0}) for n in plain.opt_state.inner.mu)


def test_bf16_fp8_run_tracks_the_bf16_run():
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 512, (4, 33))).long()

    def run(compute_dtype):
        cfg = GPT2Config.tiny(compute_dtype=compute_dtype,
                              param_dtype=torch.float32)
        model = GPT2LMModel(cfg, device="cpu")
        model.load_state_dict(convert.init_params(cfg, seed=0))
        step, opt = tdp.make_train_step(_loss(model), topt.adamw(1e-3),
                                        device="cpu",
                                        compute_dtype=compute_dtype)
        state = tdp.init_state(model, opt)
        losses = []
        for _ in range(8):
            state, loss = step(state, tokens)
            losses.append(float(loss))
        return losses, state

    off, _ = run("")
    on, state = run("fp8")
    assert all(np.isfinite(on)) and on[-1] < on[0]
    assert abs(on[-1] - off[-1]) <= 0.15 * abs(off[-1])
    gauges = tf8.fp8_state_gauges(state.params)
    assert gauges["fp8.amax_max"] > 0 and gauges["fp8.cast_residual_norm"] > 0
    assert 0 < gauges["fp8.scale_min"] < 1
    rings = [v for n, v in state.params.items() if "_amax_history" in n]
    assert all(int((r > 0).sum()) == 8 for r in rings)
