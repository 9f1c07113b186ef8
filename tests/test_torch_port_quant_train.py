"""The quantized-wire train step of the port held against the JAX
package's, mirroring ``tests/test_quantization.py``'s train-step cases.

* Four steps of a small regression (``w [4, 3]``, ``b [3]``, ``c [7]``: 22
  elements, one bucket padded to ``world * block`` = 32) on a world of 2 --
  a gloo world of 2 CPU processes for the port (``context.spawn_gloo``),
  the JAX step on 2 CPU devices -- with ``Compression.int8.with_block(8)``
  and error feedback, in three variants: replicated AdamW, ZeRO-1 with the
  unfused update, ZeRO-1 with the fused AdamW update. Rank r takes rows
  ``[8r, 8r + 8)`` of each step's global batch of 16, made with numpy.
  Tolerances, with their reasons: losses within 1e-5 relative; each leaf's
  movement ``p - p0`` within 1e-4 of the reference's movement in L2; each
  rank's residual within 1e-6 of the reference rank's. The gradients come
  out of XLA and of torch with fp32 rounding in other places, and the JAX
  step's compiled quantizer multiplies by the reciprocal of ``qmax`` and
  fuses multiply-adds where the port divides and rounds each operation
  (see ``test_torch_port_quantization.py``): ulps of the O(1) gradients
  and parameters. An int8 value moved by a whole step (1/127 of its
  block's max) would break these bounds; none is on these inputs. The two
  port ranks end with identical parameters (tolerance 0).
* The EF residuals: one fp32 ``[padded]`` buffer per bucket on each rank,
  norm > 0 after training; ``error_feedback=False`` leaves ``residual``
  None; ``HVDTPU_QUANT=int8`` arms the step and an explicit
  ``Compression.none`` wins over it.
* Error feedback is load-bearing (``test_error_feedback_is_load_bearing``
  of the JAX package, at world 1): over 200 steps of an MLP whose ``c``
  gradient is ~1e-3 of the others and shares one quantization block with
  them, int8 with EF lands within 1% of the unquantized final loss and
  int8 without EF measurably worse. SGD with momentum is written here as a
  port ``Optimizer(init, update)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu as hvd
from horovod_tpu.ops.compression import Compression as JComp
from horovod_tpu.optimizer import fused_adamw as jax_fused_adamw
from horovod_tpu.parallel import dp as jdp
from horovod_tpu_torch import context
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.ops.compression import Compression as TComp
from horovod_tpu_torch.ops.fusion import EFResiduals
from horovod_tpu_torch.parallel import dp as tdp

WORLD = 2
STEPS = 4
LR = 1e-2
BLOCK = 8
PADDED = 32  # 22 elements padded to world * block
VARIANTS = ["replicated", "zero1", "zero1_fused"]
_KW = {
    "replicated": dict(sharded=False),
    "zero1": dict(sharded=True, fused_update=False),
    "zero1_fused": dict(sharded=True, fused_update=True),
}


def _params():
    rs = np.random.RandomState(0)
    return {
        "w": rs.standard_normal((4, 3)).astype(np.float32),
        "b": np.zeros((3,), np.float32),
        "c": rs.standard_normal(7).astype(np.float32),
    }


def _batch(seed, n=16):
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


def _port_train():
    """One rank of the gloo world: every variant from the same start."""
    rank = context.rank()
    out = {}
    for variant in VARIANTS:
        opt = (topt.fused_adamw(LR) if variant == "zero1_fused"
               else topt.adamw(LR))
        step, wopt = tdp.make_train_step(
            _tloss, opt, device="cpu",
            compression=TComp.int8.with_block(BLOCK), **_KW[variant])
        state = tdp.init_state(_tparams(), wopt)
        res = state.opt_state.residual
        shapes = [tuple(b.shape) for b in res.buffers]
        losses = []
        for i in range(STEPS):
            x, y = _batch(i)
            rows = slice(8 * rank, 8 * rank + 8)
            state, loss = step(state, (torch.from_numpy(x[rows]),
                                       torch.from_numpy(y[rows])))
            losses.append(float(loss))
        res = state.opt_state.residual
        out[variant] = {
            "losses": losses,
            "params": {k: v.detach().numpy() for k, v in state.params.items()},
            "residual": [b.numpy() for b in res.buffers],
            "shapes": shapes,
            "block": res.block,
            "state_block": getattr(state.opt_state, "block", None),
            "norm": topt.ef_residual_norm(state),
        }
    # The fp8 wire trains too.
    step, wopt = tdp.make_train_step(_tloss, topt.adamw(LR), device="cpu",
                                     compression=TComp.fp8.with_block(BLOCK))
    state = tdp.init_state(_tparams(), wopt)
    fp8 = []
    for i in range(STEPS):
        x, y = _batch(i)
        rows = slice(8 * rank, 8 * rank + 8)
        state, loss = step(state, (torch.from_numpy(x[rows]),
                                   torch.from_numpy(y[rows])))
        fp8.append(float(loss))
    out["fp8_losses"] = fp8
    return out


@pytest.fixture(scope="module")
def port_runs():
    return context.spawn_gloo(WORLD, _port_train)


@pytest.fixture(scope="module")
def jax_runs():
    hvd.init(devices=jax.devices("cpu")[:WORLD])
    try:
        out = {}
        for variant in VARIANTS:
            opt = (jax_fused_adamw(LR) if variant == "zero1_fused"
                   else optax.adamw(LR, weight_decay=1e-4))
            step, wopt = jdp.make_train_step(
                _jloss, opt, compression=JComp.int8.with_block(BLOCK),
                **_KW[variant])
            state = jdp.init_state(jax.tree.map(jnp.asarray, _params()), wopt)
            losses = []
            for i in range(STEPS):
                x, y = _batch(i)
                state, loss = step(state, (jnp.asarray(x), jnp.asarray(y)))
                losses.append(float(loss))
            out[variant] = {
                "losses": losses,
                "params": jax.tree.map(np.asarray, state.params),
                "residual": [np.asarray(b)
                             for b in state.opt_state.residual.buffers],
            }
        return out
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("variant", VARIANTS)
def test_quantized_train_steps_match_the_reference(port_runs, jax_runs,
                                                   variant):
    want, got = jax_runs[variant], port_runs[0][variant]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    p0 = _params()
    for name, w in want["params"].items():
        g = got["params"][name]
        assert g.shape == w.shape, name
        moved = np.linalg.norm(w - p0[name])
        assert moved > 0, name
        err = np.linalg.norm((g - p0[name]) - (w - p0[name]))
        assert err <= 1e-4 * moved, (name, err, moved)
    # The JAX residuals' global view is every rank's [padded] buffer.
    for rank in range(WORLD):
        want_res = np.split(want["residual"][0], WORLD)[rank]
        np.testing.assert_allclose(port_runs[rank][variant]["residual"][0],
                                   want_res, rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
def test_ranks_carry_their_own_residuals_and_equal_parameters(port_runs,
                                                              variant):
    r0, r1 = port_runs[0][variant], port_runs[1][variant]
    assert r0["losses"] == r1["losses"]
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])
    for r in (r0, r1):
        assert r["shapes"] == [(PADDED,)]
        assert r["block"] == BLOCK and r["norm"] > 0
        assert r["state_block"] == (None if variant == "replicated" else BLOCK)
    # Rank-local state: each rank's own quantization error.
    assert not np.array_equal(r0["residual"][0], r1["residual"][0])


def test_fp8_wire_trains(port_runs):
    for r in port_runs:
        losses = r["fp8_losses"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert port_runs[0]["fp8_losses"] == port_runs[1]["fp8_losses"]


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "zero1"])
def test_no_error_feedback_drops_residual_state(sharded):
    step, opt = tdp.make_train_step(
        _tloss, topt.adamw(LR), device="cpu", sharded=sharded,
        compression=TComp.int8.with_block(BLOCK), error_feedback=False)
    st = tdp.init_state(_tparams(), opt)
    assert st.opt_state.residual is None
    assert not topt.has_ef_residuals(st) and topt.ef_residual_norm(st) is None
    x, y = _batch(0)
    st, loss = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
    assert np.isfinite(float(loss)) and st.opt_state.residual is None


def test_hvdtpu_quant_env_arms_the_step_and_explicit_none_wins(monkeypatch):
    monkeypatch.setenv("HVDTPU_QUANT", "int8")
    monkeypatch.setenv("HVDTPU_QUANT_BLOCK", "8")
    step, opt = tdp.make_train_step(_tloss, topt.adamw(LR), device="cpu")
    st = tdp.init_state(_tparams(), opt)
    res = st.opt_state.residual
    assert isinstance(res, EFResiduals) and res.block == 8
    assert [tuple(b.shape) for b in res.buffers] == [(24,)]  # world 1
    # The block is pinned at build time: a later env change cannot desync
    # the residual layout.
    monkeypatch.setenv("HVDTPU_QUANT_BLOCK", "16")
    x, y = _batch(0)
    st, loss = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
    assert np.isfinite(float(loss)) and st.opt_state.residual.block == 8
    step, opt = tdp.make_train_step(_tloss, topt.adamw(LR), device="cpu",
                                    compression=TComp.none)
    assert tdp.init_state(_tparams(), opt).opt_state.residual is None
    monkeypatch.setenv("HVDTPU_QUANT", "int4")
    with pytest.raises(ValueError, match="int4"):
        tdp.make_train_step(_tloss, topt.adamw(LR), device="cpu")


def test_quant_matches_unquantized_trajectory_short():
    def run(compression):
        step, opt = tdp.make_train_step(_tloss, topt.adamw(LR), device="cpu",
                                        compression=compression)
        st = tdp.init_state(_tparams(), opt)
        for i in range(5):
            x, y = _batch(i)
            st, loss = step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        return float(loss)

    lf, lq = run(TComp.none), run(TComp.int8.with_block(BLOCK))
    assert abs(lf - lq) / abs(lf) < 0.05


def _sgd_momentum(lr, momentum):
    """optax.sgd(lr, momentum) as a port Optimizer."""
    def init(params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(grads, state, params=None):
        trace = {k: grads[k] + momentum * state[k] for k in grads}
        return {k: -lr * t for k, t in trace.items()}, trace

    return topt.Optimizer(init, update)


def test_error_feedback_is_load_bearing():
    rng = np.random.RandomState(0)
    w1, h, c, aux = 32, 64, 10, 32
    params = {
        "w1": (rng.standard_normal((w1, h)) * 0.3).astype(np.float32),
        "b1": np.zeros((h,), np.float32),
        "w2": (rng.standard_normal((h, c)) * 0.3).astype(np.float32),
        "b2": np.zeros((c,), np.float32),
        "c": np.zeros((aux,), np.float32),
    }

    def loss_fn(p, b):
        x, y = b
        hid = torch.relu(x @ p["w1"] + p["b1"])
        main = F.cross_entropy(hid @ p["w2"] + p["b2"], y)
        # The gradient of `c` is ~1e-3 of the main gradients: with ONE
        # scale across the whole bucket it rounds to zero every step
        # unless the error feeds back.
        return main + 1e-3 * ((p["c"] - 1.0) ** 2).sum()

    n = 512
    X = torch.from_numpy(rng.standard_normal((n, w1)).astype(np.float32))
    Y = torch.from_numpy(rng.randint(0, c, size=(n,)))

    def run(compression, ef=True, steps=200):
        step, opt = tdp.make_train_step(
            loss_fn, _sgd_momentum(0.2, 0.9), device="cpu",
            compression=compression, error_feedback=ef)
        st = tdp.init_state({k: torch.from_numpy(v.copy())
                             for k, v in params.items()}, opt)
        for i in range(steps):
            idx = (np.arange(64) + i * 64) % n
            st, loss = step(st, (X[idx], Y[idx]))
        return float(loss)

    coarse = TComp.int8.with_block(1 << 16)  # one scale per bucket
    final_none = run(TComp.none)
    final_ef = run(coarse, ef=True)
    final_noef = run(coarse, ef=False)
    rel_ef = abs(final_ef - final_none) / final_none
    rel_noef = abs(final_noef - final_none) / final_none
    assert rel_ef < 0.01, (final_none, final_ef)
    assert rel_noef > 0.02, (final_none, final_noef)
    assert rel_noef > 2.5 * rel_ef
