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
  package does.
"""

import jax
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


@pytest.mark.parametrize("kw,match", [
    (dict(op=2), "ADASUM"),
    (dict(backward_passes_per_step=2), "accum_steps"),
    (dict(compression="int8"), "quantized wire"),
])
def test_unported_optimizer_options_raise(kw, match):
    from horovod_tpu_torch.ops.compression import Compression

    if kw.get("compression") == "int8":
        # The quantized wire is ported; with backward_passes_per_step > 1
        # it raises, as in the JAX package.
        kw = dict(compression=Compression.int8, backward_passes_per_step=2)
    with pytest.raises(NotImplementedError, match=match):
        topt.DistributedOptimizer(topt.adamw(1e-3), **kw)
