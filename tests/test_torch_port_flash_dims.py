"""The flash kernels' domain: bf16 and fp32 at every head dim from 1 to
256, on two routes that ``horovod_tpu_torch.ops.flash_attention.
kernel_route`` picks from the dtype and the head dim alone (the wgmma
kernels for bf16 at 64 and 128, the general kernels of
``csrc/flash_general.cu`` at a compiled size ``d_pad`` for the rest).

The kernels themselves run only on the card (``tests/test_torch_port_
cuda.py`` holds them to the port's plain versions there). Here the plain
versions -- what both routes compute -- are held against the JAX
package's Pallas kernels at the head dims the general route takes, in
Pallas interpret mode (as ``tests/test_pallas_kernels.py`` runs them, with
16-row blocks; the reference skips its 64-aligned ``bsm`` rule under
interpret), in the three layouts, fp32 and bf16, causal and not: the
forward's ``(out, lse)`` and the gradients of a loss on both outputs, so
the ``lse`` cotangent reaches the backward. The same seeded numpy inputs go
to both. Tolerances are the existing tables': out and lse 2e-5 absolute in
fp32, 1e-2 / 1e-3 in bf16 (``test_torch_port_flash.py``); gradients 2e-5
(fp32) and 2e-2 (bf16) of the largest gradient of the case
(``test_torch_port_flash_bwd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import (
    flash_attention_with_lse as jax_flash_with_lse,
)
from horovod_tpu_torch.ops import flash_attention as fa

FWD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-3)}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 64, ("wgmma", 64)),
    (BF16, 128, ("wgmma", 128)),
    (BF16, 1, ("general", 16)),
    (BF16, 12, ("general", 16)),
    (BF16, 16, ("general", 16)),
    (BF16, 17, ("general", 32)),
    (BF16, 32, ("general", 32)),
    (BF16, 48, ("general", 64)),
    (BF16, 65, ("general", 128)),
    (BF16, 96, ("general", 128)),
    (BF16, 129, ("general", 256)),
    (BF16, 256, ("general", 256)),
    (F32, 1, ("general", 16)),
    (F32, 16, ("general", 16)),
    (F32, 64, ("general", 64)),
    (F32, 80, ("general", 128)),
    (F32, 128, ("general", 128)),
    (F32, 160, ("general", 256)),
    (F32, 256, ("general", 256)),
])
def test_kernel_route_maps_dtype_and_head_dim(dtype, d, want):
    assert fa.kernel_route(dtype, d) == want


def test_kernel_route_covers_every_head_dim_up_to_256():
    # bf16 at 64 and 128 takes the wgmma kernels; everything else the
    # general ones at the smallest compiled size that holds the head dim.
    sizes = fa.GENERAL_HEAD_DIMS
    for dtype in (BF16, F32):
        for d in range(1, fa.MAX_HEAD_DIM + 1):
            route, d_pad = fa.kernel_route(dtype, d)
            if dtype == BF16 and d in (64, 128):
                assert (route, d_pad) == ("wgmma", d)
                continue
            assert route == "general" and d_pad in sizes and d_pad >= d
            i = sizes.index(d_pad)
            assert i == 0 or sizes[i - 1] < d


@pytest.mark.parametrize("dtype,d,err,match", [
    (torch.float16, 64, TypeError, "take bfloat16 or float32, got "
                                   "torch.float16"),
    (torch.float64, 16, TypeError, "take bfloat16 or float32"),
    (BF16, 257, ValueError, "head dim 1 to 256, got 257"),
    (F32, 272, ValueError, "head dim 1 to 256, got 272"),
    (F32, 0, ValueError, "head dim 1 to 256, got 0"),
])
def test_kernel_route_raises_outside_the_domain(dtype, d, err, match):
    with pytest.raises(err, match=match):
        fa.kernel_route(dtype, d)


def test_general_strides_are_the_views_own():
    # The general kernels read any strided view: a column third of a fused
    # QKV output at head dim 12 (rows of 72 elements, not 16-byte aligned
    # in bf16) goes in as its own element strides, with no copy.
    fused = torch.zeros((2, 5, 3 * 3 * 12), dtype=BF16)
    q, k, v = fused.split(36, dim=-1)
    views = [fa._view4(x, "bsm", 3) for x in (q, k, v)]
    st = list(fa._strides(*views))
    assert st == [5 * 108, 108, 12] * 3
    assert not fa._rows_aligned(views[1])


def _inputs(seed, b, sq, skv, h, d):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rs.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rs.uniform(-1.0, 1.0, (b, skv, h, d)).astype(np.float32)
    w_out = rs.standard_normal((b, sq, h, d)).astype(np.float32)
    w_lse = rs.standard_normal((b, h, sq)).astype(np.float32)
    return q, k, v, w_out, w_lse


def _to_layout(x, layout):
    b, s, h, d = x.shape
    if layout == "bsm":
        return x.reshape(b, s, h * d)
    if layout == "bhsd":
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    return x


def _jax_run(q, k, v, w_out, w_lse, dtype, **kw):
    jdt = _DT[dtype][0]

    def loss(q, k, v):
        out, lse = jax_flash_with_lse(q, k, v, block_q=16, block_k=16, **kw)
        total = jnp.sum(out.astype(jnp.float32) * w_out)
        total += jnp.sum(jnp.where(jnp.isfinite(lse), lse, 0.0) * w_lse)
        return total, (out, lse)

    (_, (out, lse)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return (np.asarray(out.astype(jnp.float32)), np.asarray(lse),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port_run(q, k, v, w_out, w_lse, dtype, **kw):
    tdt = _DT[dtype][1]
    ts = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(*ts, **kw)
    assert out.dtype == tdt and lse.dtype == torch.float32
    total = (out.float() * torch.from_numpy(w_out)).sum()
    total = total + (torch.where(torch.isfinite(lse), lse, 0.0)
                     * torch.from_numpy(w_lse)).sum()
    total.backward()
    for t in ts:
        assert t.grad.dtype == tdt and t.grad.shape == t.shape
    return (out.detach().float().numpy(), lse.detach().numpy(),
            [t.grad.float().numpy() for t in ts])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [12, 24, 48, 80, 96, 160, 256])
@pytest.mark.parametrize("layout", ["bhsd", "bshd", "bsm"])
def test_plain_versions_match_jax_flash_at_head_dim(layout, d, dtype,
                                                    causal):
    # Skv = 40 is not a multiple of the JAX kernel's 16-key block.
    q, k, v, w_out, w_lse = _inputs(d, 1, 32, 40, 2, d)
    kw = dict(causal=causal, layout=layout,
              n_heads=2 if layout == "bsm" else 0)
    args = [_to_layout(x, layout) for x in (q, k, v, w_out)] + [w_lse]
    jo, jl, jg = _jax_run(*args, dtype, **kw)
    to, tl, tg = _port_run(*args, dtype, **kw)
    assert to.shape == jo.shape and tl.shape == jl.shape
    tol_o, tol_l = FWD_TOL[dtype]
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl[fin], jl[fin], atol=tol_l, rtol=0)
    np.testing.assert_allclose(to, jo, atol=tol_o, rtol=0)
    for name, g, w in zip("qkv", tg, jg):
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL[dtype] * scale, (name, err, scale)
