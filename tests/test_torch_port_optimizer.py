"""The port's AdamW -- fused (ops/fused_adamw.py, the plain version of the
CUDA kernel) and unfused (optimizer.adamw) -- held against the JAX
package's, on the CPU.

* The fused plain version against ``optimizer._fused_adamw_update_jax``
  (the JAX package's op-for-op twin of its Pallas kernel, run eagerly),
  over several step counts, with fp32 and bf16 parameters: bit for bit,
  since both round every fp32 operation as IEEE does, in the same order
  (tolerance 0). Against ``fused_adamw_update_pallas`` in interpret mode
  within 1e-6 of each buffer's largest value: XLA compiles the
  interpreted kernel with fused multiply-adds and its own ``pow``, a few
  fp32 ulps of the operands.
* The unfused AdamW against ``optax.adamw`` over 5 steps on a small tree:
  within 1e-6 relative to the parameters' scale (fp32, the same ops; XLA
  may fuse and reorder them).
* The wrapper updates ``m`` and ``v`` in place and counts no launch on
  the CPU; the distributed wrappers resolve ``fused_update`` as the JAX
  package does, and refuse what the JAX package refuses, in its words.
* ``backward_passes_per_step``, Adasum, ``grad`` and ``value_and_grad`` on
  a gloo world of 4 against the JAX package (see the section below), and
  a ``TrainState`` checkpoint saved mid-accumulation (and one written
  without ``acc``) restoring to the same run.
"""

import jax
from typing import NamedTuple
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import fused_adamw_update_pallas
from horovod_tpu.optimizer import FusedAdamSpec as JaxSpec
from horovod_tpu.optimizer import _fused_adamw_update_jax
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.exceptions import HorovodTpuError
from horovod_tpu_torch.ops import fused_adamw as tfa

SPEC = dict(learning_rate=3e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
            weight_decay=1e-4)


def _flat(seed, n, p_dtype):
    rs = np.random.RandomState(seed)
    p = rs.standard_normal(n).astype(np.float32)
    g = (rs.standard_normal(n) * 0.1).astype(np.float32)
    m = (rs.standard_normal(n) * 0.01).astype(np.float32)
    v = (rs.uniform(0, 1e-3, n)).astype(np.float32)
    if p_dtype == "bfloat16":
        p = np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
        g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return p, m, v, g


def _port(p, m, v, g, count, p_dtype, **spec):
    tdt = getattr(torch, p_dtype)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    u = tfa.fused_adamw_update(
        torch.tensor(p).to(tdt), tm, tv, torch.tensor(g).to(tdt),
        torch.tensor(count, dtype=torch.int32),
        tfa.FusedAdamSpec(**dict(SPEC, **spec)),
    )
    assert u.dtype == tdt
    return u.float().numpy(), tm.numpy(), tv.numpy()


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [0, 1, 7, 1000])
def test_fused_plain_version_is_the_jax_twin_bit_for_bit(count, p_dtype):
    p, m, v, g = _flat(count, 1031, p_dtype)
    jdt = getattr(jnp, p_dtype)
    ju, jm, jv = _fused_adamw_update_jax(
        jnp.asarray(p, jdt), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(g, jdt), jnp.int32(count), JaxSpec(**SPEC),
    )
    tu, tm, tv = _port(p, m, v, g, count, p_dtype)
    np.testing.assert_array_equal(tu, np.asarray(ju.astype(jnp.float32)))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    np.testing.assert_array_equal(tv, np.asarray(jv))


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [0, 5])
def test_fused_plain_version_matches_the_pallas_kernel(count, p_dtype):
    # Ragged length (not a multiple of the TPU kernel's 128 lanes) and
    # eps_root/weight decay off their defaults.
    p, m, v, g = _flat(10 + count, 333, p_dtype)
    spec = dict(eps_root=1e-12, weight_decay=0.05)
    jdt = getattr(jnp, p_dtype)
    s = dict(SPEC, **spec)
    ju, jm, jv = fused_adamw_update_pallas(
        jnp.asarray(p, jdt), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(g, jdt), jnp.int32(count), lr=s["learning_rate"],
        b1=s["b1"], b2=s["b2"], eps=s["eps"], eps_root=s["eps_root"],
        weight_decay=s["weight_decay"], interpret=True,
    )
    tu, tm, tv = _port(p, m, v, g, count, p_dtype, **spec)
    for got, want in ((tu, ju.astype(jnp.float32)), (tm, jm), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {
        "a": {"kernel": rs.standard_normal((8, 5)).astype(np.float32)},
        "b": rs.standard_normal((13,)).astype(np.float32),
        "c": {"scale": rs.standard_normal((3, 4)).astype(np.float32)},
    }


@pytest.mark.parametrize("make", ["adamw", "fused_adamw"])
def test_unfused_adamw_matches_optax_over_five_steps(make):
    params = _tree(0)
    jopt = optax.adamw(1e-2, weight_decay=1e-4)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt_ = getattr(topt, make)(1e-2)
    tp = jax.tree.map(torch.from_numpy, params)
    tstate = topt_.init(tp)
    for step in range(5):
        grads = _tree(100 + step)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt_.update(jax.tree.map(torch.from_numpy, grads),
                                  tstate, tp)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu)
    assert int(tstate.count) == 5
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(a)).max())


def test_fused_and_unfused_agree_on_a_flat_buffer():
    # The fused pass and the unfused optimizer compute the same function.
    p, m, v, g = _flat(3, 257, "float32")
    opt = topt.adamw(SPEC["learning_rate"])
    state = topt.AdamState(torch.tensor(4, dtype=torch.int32),
                           torch.from_numpy(m.copy()), torch.from_numpy(v.copy()))
    u, new = opt.update(torch.from_numpy(g), state, torch.from_numpy(p))
    fu, fm, fv = _port(p, m, v, g, 4, "float32")
    np.testing.assert_allclose(u.numpy(), fu, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(new.mu.numpy(), fm, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(new.nu.numpy(), fv, rtol=1e-6, atol=1e-12)
    assert int(new.count) == 5


def test_wrapper_updates_moments_in_place_and_counts_no_launch_on_cpu():
    p, m, v, g = (torch.from_numpy(x) for x in _flat(4, 64, "float32"))
    m0, v0 = m.clone(), v.clone()
    tfa.reset_launches()
    u = tfa.fused_adamw_update(p, m, v, g, torch.tensor(0, dtype=torch.int32),
                               tfa.FusedAdamSpec(1e-3))
    assert tfa.launches == 0 and u.shape == p.shape
    assert not torch.equal(m, m0) and not torch.equal(v, v0)
    with pytest.raises(ValueError, match="flat"):
        tfa.fused_adamw_update(p.reshape(8, 8), m, v, g,
                               torch.tensor(0, dtype=torch.int32),
                               tfa.FusedAdamSpec(1e-3))
    with pytest.raises(TypeError, match="count"):
        tfa.fused_adamw_update(p, m, v, g, 0, tfa.FusedAdamSpec(1e-3))


def test_fused_update_resolution(monkeypatch):
    # Explicit fused_update=True without a fused spec raises; the env
    # default degrades with a warning; the replicated path refuses it.
    with pytest.raises(HorovodTpuError, match="fused_adamw"):
        topt.ShardedDistributedOptimizer(topt.adamw(1e-3), fused_update=True)
    monkeypatch.setenv("HVDTPU_FUSED_UPDATE", "1")
    with pytest.warns(UserWarning, match="ignored"):
        topt.ShardedDistributedOptimizer(topt.adamw(1e-3))
    with pytest.warns(UserWarning, match="sharded"):
        topt.DistributedOptimizer(topt.fused_adamw(1e-3))
    with pytest.raises(NotImplementedError, match="sharded=True"):
        topt.DistributedOptimizer(topt.fused_adamw(1e-3), fused_update=True)
    with pytest.raises(ValueError, match="static"):
        topt.fused_adamw(lambda step: 1e-3)


# The refusals the replicated wrapper keeps, in the JAX package's words
# (horovod_tpu/optimizer.py): Adasum and backward_passes_per_step > 1 are
# ported (test_torch_port_adasum.py, test_backward_passes_per_step_*), so
# their two cases here gave way to the refusals that stay.
_REFUSALS = [
    (dict(sharded=True, backward_passes_per_step=2), NotImplementedError,
     "sharded=True does not support backward_passes_per_step > 1"),
    (dict(sharded=True, op=2), ValueError,
     "ShardedDistributedOptimizer supports Average/Sum"),
    (dict(compression="int8"), NotImplementedError, "quantized wire"),
    (dict(backward_passes_per_step=0), ValueError,
     "backward_passes_per_step must be >= 1"),
    (dict(compression="int8", op=2), ValueError,
     "quantized compression supports op=Average/Sum"),
]


@pytest.mark.parametrize(
    "kw,exc,match", _REFUSALS,
    ids=["sharded-bpps", "sharded-adasum", "kw2-quantized wire", "bpps0",
         "quantized-adasum"])
def test_unported_optimizer_options_raise(kw, exc, match):
    from horovod_tpu_torch.ops.compression import Compression

    if kw.get("compression") == "int8":
        # The quantized wire is ported; with backward_passes_per_step > 1
        # it raises, as in the JAX package, and so does it with Adasum.
        kw = dict(kw, compression=Compression.int8)
        kw.setdefault("backward_passes_per_step", 2 if "op" not in kw else 1)
    with pytest.raises(exc, match=match):
        topt.DistributedOptimizer(topt.adamw(1e-3), **kw)
    if kw.get("sharded") and kw.get("op") == 2:
        with pytest.raises(exc, match=match):
            topt.ShardedDistributedOptimizer(topt.adamw(1e-3), op=2)


# -- the rest of the wrapper on a gloo world of 4 ------------------------
#
# One gloo world of 4 CPU processes (context.spawn_gloo) runs every case
# below; the JAX package's side runs under shard_map on 4 CPU devices, from
# the same seeded numpy inputs per rank:
#
# * test_backward_passes_per_step's twin with a plain SGD(1.0): the skipped
#   pass's update 0, the synced one -mean(2 (rank + 1)) = -5, exact; and with
#   average_aggregated_gradients=True, -2.5;
# * AdamW over 5 passes at backward_passes_per_step=2 against the JAX
#   DistributedOptimizer under optax.adamw, at the tolerance of
#   test_unfused_adamw_matches_optax_over_five_steps (1e-6 of the largest
#   parameter); the inner count advances only on the synced passes;
# * op=Adasum through DistributedOptimizer (AdamW, 3 updates) and through
#   make_train_step (a regression, 3 steps) against the JAX optimizer and
#   the JAX make_train_step(op=Adasum): the parameters within 1e-5 of the
#   largest (Adasum's fp32 dots are summed in other orders, and Adam divides
#   by sqrt(v));
# * grad and value_and_grad (the twins of test_grad_allreduces and
#   test_value_and_grad_averages_loss, exact: sums of small integers).

import optax  # noqa: E402

import horovod_tpu as hvd  # noqa: E402
from horovod_tpu import _compat  # noqa: E402
from horovod_tpu.parallel import dp as jdp  # noqa: E402
from horovod_tpu_torch import context  # noqa: E402
from horovod_tpu_torch.ops.collectives import Adasum  # noqa: E402
from horovod_tpu_torch.parallel import dp as tdp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

WORLD4 = 4
ADASUM_LR = 1e-2


def _sgd(lr):
    """SGD without momentum, the shape of optax.sgd(lr)."""
    return topt.Optimizer(
        lambda params: (),
        lambda g, s, p=None: (jax.tree.map(lambda x: -lr * x, g), s))


def _rank_tree(seed, rank):
    return _tree(seed + 10 * rank)


def _regression(rank=None):
    rs = np.random.RandomState(5)
    params = {"w": rs.standard_normal((4, 3)).astype(np.float32),
              "b": rs.standard_normal((3,)).astype(np.float32)}
    x = rs.standard_normal((2 * WORLD4, 4)).astype(np.float32)
    y = rs.standard_normal((2 * WORLD4, 3)).astype(np.float32)
    if rank is not None:
        x, y = x[2 * rank:2 * rank + 2], y[2 * rank:2 * rank + 2]
    return params, x, y


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _port_world4():
    rank = context.rank()
    out = {}
    for avg in (False, True):
        d = topt.DistributedOptimizer(
            _sgd(1.0), backward_passes_per_step=2,
            average_aggregated_gradients=avg)
        p = {"w": torch.ones(2)}
        state = d.init(p)
        g = {"w": torch.full((2,), rank + 1.0)}
        u1, state = d.update(g, state, p)
        u2, state = d.update(g, state, p)
        out[f"bpps_avg{avg}"] = (u1["w"].numpy(), u2["w"].numpy())
    # AdamW over 5 passes at k = 2.
    d = topt.DistributedOptimizer(topt.adamw(1e-2), backward_passes_per_step=2)
    p = _t(_tree(0))
    state = d.init(p)
    counts = []
    for step in range(5):
        u, state = d.update(_t(_rank_tree(100 + step, rank)), state, p)
        p = jax.tree.map(lambda a, b: a + b, p, u)
        counts.append(int(state.inner.count))
    out["adamw_k2"] = (jax.tree.map(lambda t: t.numpy(), p), counts)
    # Adasum through the optimizer ...
    d = topt.DistributedOptimizer(topt.adamw(ADASUM_LR), op=Adasum)
    p = _t(_tree(0))
    state = d.init(p)
    for step in range(3):
        u, state = d.update(_t(_rank_tree(200 + step, rank)), state, p)
        p = jax.tree.map(lambda a, b: a + b, p, u)
    out["adasum_opt"] = jax.tree.map(lambda t: t.numpy(), p)
    # ... and through make_train_step.
    params, x, y = _regression(rank)
    step_fn, wopt = tdp.make_train_step(
        lambda q, b: ((b[0] @ q["w"] + q["b"] - b[1]) ** 2).mean(),
        topt.adamw(ADASUM_LR), op=Adasum, device="cpu")
    ts = tdp.init_state(_t(params), wopt)
    losses = []
    for _ in range(3):
        ts, loss = step_fn(ts, (torch.from_numpy(x), torch.from_numpy(y)))
        losses.append(float(loss))
    out["adasum_step"] = ({k: v.detach().numpy() for k, v in ts.params.items()},
                          losses)
    # grad / value_and_grad.
    r = float(rank)
    out["grad"] = topt.grad(lambda w: (w * w).sum() * (r + 1.0))(
        torch.ones(4)).numpy()
    loss, g = topt.value_and_grad(lambda w: w.sum() * (r + 1.0))(torch.ones(3))
    out["value_and_grad"] = (float(loss), g.numpy())
    (loss, aux), g = topt.value_and_grad(
        lambda w: (w.sum() * (r + 1.0), torch.tensor(r)), has_aux=True)(
            torch.ones(3))
    out["value_and_grad_aux"] = (float(loss), float(aux), g.numpy())
    return out


@pytest.fixture(scope="module")
def world4():
    return context.spawn_gloo(WORLD4, _port_world4)


@pytest.fixture(scope="module")
def jax_world4():
    ctx = hvd.init(devices=jax.devices("cpu")[:WORLD4])
    try:
        def spmd(body, *stacked):
            fn = jax.jit(_compat.shard_map(
                lambda *a: jax.tree.map(lambda t: t[None], body(
                    *jax.tree.map(lambda t: t[0], a))),
                mesh=ctx.mesh, in_specs=(P(hvd.WORLD_AXIS),) * len(stacked),
                out_specs=P(hvd.WORLD_AXIS), check_vma=False))
            return jax.tree.map(lambda t: np.asarray(t)[0], fn(*stacked))

        def stack(seed):
            return jax.tree.map(lambda *xs: jnp.stack(xs), *[
                _rank_tree(seed, r) for r in range(WORLD4)])

        out = {}
        grads = [stack(100 + s) for s in range(5)]

        def adamw_k2(*gs):
            d = hvd.DistributedOptimizer(optax.adamw(1e-2, weight_decay=1e-4),
                                         backward_passes_per_step=2)
            p = jax.tree.map(jnp.asarray, _tree(0))
            s = d.init(p)
            for g in gs:
                u, s = d.update(g, s, p)
                p = optax.apply_updates(p, u)
            return p

        out["adamw_k2"] = spmd(adamw_k2, *grads)
        grads = [stack(200 + s) for s in range(3)]

        def adasum_opt(*gs):
            d = hvd.DistributedOptimizer(
                optax.adamw(ADASUM_LR, weight_decay=1e-4), op=hvd.Adasum)
            p = jax.tree.map(jnp.asarray, _tree(0))
            s = d.init(p)
            for g in gs:
                u, s = d.update(g, s, p)
                p = optax.apply_updates(p, u)
            return p

        out["adasum_opt"] = spmd(adasum_opt, *grads)
        params, x, y = _regression()

        def loss_fn(q, b):
            return jnp.mean((b[0] @ q["w"] + q["b"] - b[1]) ** 2)

        step, wopt = jdp.make_train_step(
            loss_fn, optax.adamw(ADASUM_LR, weight_decay=1e-4), op=hvd.Adasum)
        st = jdp.init_state(jax.tree.map(jnp.asarray, params), wopt)
        losses = []
        for _ in range(3):
            st, loss = step(st, (jnp.asarray(x), jnp.asarray(y)))
            losses.append(float(loss))
        out["adasum_step"] = (jax.tree.map(np.asarray, st.params), losses)
        return out
    finally:
        hvd.shutdown()


def _within(got, want, tol):
    """Every leaf of ``got`` within ``tol`` of ``want``'s largest value."""
    top = max(float(np.abs(np.asarray(w)).max())
              for w in jax.tree.leaves(want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=tol * top)


@pytest.mark.parametrize("avg", [False, True])
def test_backward_passes_per_step_on_a_gloo_world(world4, avg):
    for r in range(WORLD4):
        u1, u2 = world4[r][f"bpps_avg{avg}"]
        np.testing.assert_array_equal(u1, 0.0)  # the skipped pass
        # Accumulated 2 (rank + 1); its mean over ranks 2 x 2.5 = 5.
        np.testing.assert_array_equal(u2, -2.5 if avg else -5.0)


def test_adamw_accumulating_two_passes_matches_the_reference(world4,
                                                             jax_world4):
    for r in range(WORLD4):
        params, counts = world4[r]["adamw_k2"]
        assert counts == [0, 1, 1, 2, 2]  # AdamW steps only when it syncs
        _within(params, jax_world4["adamw_k2"], 1e-6)


def test_adasum_optimizer_and_train_step_match_the_reference(world4,
                                                             jax_world4):
    for r in range(WORLD4):
        _within(world4[r]["adasum_opt"], jax_world4["adasum_opt"], 1e-5)
        params, losses = world4[r]["adasum_step"]
        want, want_losses = jax_world4["adasum_step"]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        assert losses[-1] < losses[0]
        _within(params, want, 1e-5)
        for k in params:  # every rank ends with the same parameters
            np.testing.assert_array_equal(params[k],
                                          world4[0]["adasum_step"][0][k])


def test_grad_and_value_and_grad_reduce_like_the_reference(world4):
    for r in range(WORLD4):
        # test_grad_allreduces: d/dw sum(w^2)(r + 1) averaged: 2 x 2.5.
        np.testing.assert_array_equal(world4[r]["grad"], 5.0)
        # test_value_and_grad_averages_loss: loss 3 x 2.5, grads 2.5.
        loss, g = world4[r]["value_and_grad"]
        assert loss == 7.5
        np.testing.assert_array_equal(g, 2.5)
        loss, aux, g = world4[r]["value_and_grad_aux"]
        assert loss == 7.5 and aux == float(r)  # aux stays this rank's
        np.testing.assert_array_equal(g, 2.5)


# -- backward_passes_per_step in a TrainState checkpoint -------------------


def _bpps_run(tmp_path, opt, interrupt_at=None):
    """3 steps of a regression through make_train_step with a user's
    DistributedOptimizer (distribute_optimizer=False); with
    ``interrupt_at``, the state is saved after that step and the rest runs
    from a restore into a fresh state."""
    from horovod_tpu_torch import checkpoint as tckpt

    params, x, y = _regression(0)
    batches = [(torch.from_numpy(x) * (1 + i), torch.from_numpy(y))
               for i in range(3)]
    step, _ = tdp.make_train_step(
        lambda q, b: ((b[0] @ q["w"] + q["b"] - b[1]) ** 2).mean(), opt,
        distribute_optimizer=False, device="cpu")
    state = tdp.init_state(_t(params), opt)
    for i, batch in enumerate(batches):
        state, _ = step(state, batch)
        if i == interrupt_at:
            tckpt.save_checkpoint(str(tmp_path), state, i + 1)
            fresh = tdp.init_state(_t(params), opt)
            state = tckpt.restore_checkpoint(str(tmp_path), fresh)
            assert int(state.opt_state.count) == i + 1
    return state


def test_checkpoint_mid_accumulation_resumes_bit_for_bit(tmp_path):
    opt = topt.DistributedOptimizer(topt.adamw(1e-2),
                                    backward_passes_per_step=2)
    whole = _bpps_run(tmp_path / "a", opt)
    resumed = _bpps_run(tmp_path / "b", opt, interrupt_at=0)  # acc is full
    for k in whole.params:
        assert torch.equal(whole.params[k], resumed.params[k]), k
    assert int(resumed.opt_state.inner.count) == 1


class _PrePRDistState(NamedTuple):
    """A replicated state as checkpoints stored it before ``acc`` existed."""

    inner: object
    count: torch.Tensor
    residual: object = None


def test_a_checkpoint_without_acc_restores_at_one_pass(tmp_path):
    from horovod_tpu_torch import checkpoint as tckpt

    opt = topt.DistributedOptimizer(topt.adamw(1e-2))
    params, x, y = _regression(0)
    step, _ = tdp.make_train_step(
        lambda q, b: ((b[0] @ q["w"] + q["b"] - b[1]) ** 2).mean(), opt,
        distribute_optimizer=False, device="cpu")
    state, _ = step(tdp.init_state(_t(params), opt),
                    (torch.from_numpy(x), torch.from_numpy(y)))
    old = tdp.TrainState(state.params, _PrePRDistState(
        state.opt_state.inner, state.opt_state.count), state.step)
    tckpt.save_checkpoint(str(tmp_path), old, 1)
    got = tckpt.restore_checkpoint(str(tmp_path),
                                   tdp.init_state(_t(params), opt))
    assert got.opt_state.acc is None and int(got.opt_state.count) == 1
    for a, b in zip(jax.tree.leaves(tuple(got.opt_state.inner)),
                    jax.tree.leaves(tuple(state.opt_state.inner))):
        assert torch.equal(a, b)
    for k in params:
        assert torch.equal(got.params[k], state.params[k])
