"""The forward's sm90 route: ``horovod_tpu_torch.ops.flash_attention.
fwd_route`` and the arithmetic of the fp32 kernel in
``csrc/flash_fwd_sm90_general.cu``.

The route is decided by the dtype and the head dim alone: bf16 at 64 and
128 on the wgmma kernel (as ``kernel_route``), the sizes of
``SM90_FWD_SIZES`` where a row is whole 16-byte units on the sm90 kernel,
the rest on the general one. The kernel itself runs only on the card
(``tests/test_torch_port_cuda.py``). Here its fp32 arithmetic -- the
online softmax over the kernel's own key tiles (64 keys, 32 from d_pad 64
on), on exp2 with the scale and log2(e) premultiplied, both products as
3xTF32 (every operand split into hi = rna(x) and lo = rna(x - hi), rna the
round to nearest, ties away from zero, on the 13 mantissa bits tf32 drops,
and C = A_lo B_hi + A_hi B_lo + A_hi B_hi in fp32) -- is emulated in torch
and held against the JAX package's ``flash_attention_with_lse`` in Pallas
interpret mode (as ``tests/test_pallas_kernels.py`` runs it), at
``chip_smoke.py``'s ``[flash-general]`` shape [2, 200 / 333, 3, d], causal
and not: out and lse within 2e-5 absolute (the fp32 tolerance of
``test_torch_port_flash_dims.py``). One product per matmul in tf32 alone
(1xTF32) misses that tolerance, which is why the kernel splits. The same
seeded numpy inputs go to both.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import (
    flash_attention_with_lse as jax_flash_with_lse,
)
from horovod_tpu_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32
FP32_TOL = 2e-5
SHAPE = dict(b=2, sq=200, skv=333, h=3)  # [flash-general]'s grid shape
LOG2E = 1.4426950408889634


def _fwd_want(dtype, d):
    """The route the sizes of SM90_FWD_SIZES give ``d``."""
    route, d_pad = fa.kernel_route(dtype, d)
    unit = 8 if dtype == BF16 else 4
    if route == "general" and d % unit == 0 and d_pad in fa.SM90_FWD_SIZES[
            dtype]:
        return "sm90", d_pad
    return route, d_pad


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 64, ("wgmma", 64)),
    (BF16, 128, ("wgmma", 128)),
    (BF16, 1, ("general", 16)),
    (BF16, 12, ("general", 16)),
    (BF16, 8, ("sm90", 16)),
    (BF16, 16, ("sm90", 16)),
    (BF16, 20, ("general", 32)),
    (BF16, 24, ("sm90", 32)),
    (BF16, 32, ("sm90", 32)),
    (BF16, 48, ("sm90", 64)),
    (BF16, 60, ("general", 64)),
    (BF16, 96, ("sm90", 128)),
    (BF16, 100, ("general", 128)),
    (BF16, 132, ("general", 256)),
    (BF16, 136, ("sm90", 256)),
    (BF16, 256, ("sm90", 256)),
    (F32, 1, ("general", 16)),
    (F32, 4, ("sm90", 16)),
    (F32, 12, ("sm90", 16)),
    (F32, 16, ("sm90", 16)),
    (F32, 30, ("general", 32)),
    (F32, 32, ("sm90", 32)),
    (F32, 64, ("sm90", 64)),
    (F32, 100, ("sm90", 128)),
    (F32, 128, ("sm90", 128)),
    (F32, 160, ("general", 256)),
    (F32, 256, ("general", 256)),
])
def test_fwd_route_maps_dtype_and_head_dim(dtype, d, want):
    assert fa.fwd_route(dtype, d) == want
    # The padded size is kernel_route's on every route.
    assert fa.kernel_route(dtype, d)[1] == want[1]


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fwd_route_covers_every_head_dim_up_to_256(dtype):
    # wgmma where kernel_route says so; sm90 exactly where the size is one
    # of SM90_FWD_SIZES and a row is whole 16-byte units; general for the
    # rest; the d_pad always kernel_route's and never below d.
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        route, pad = fa.fwd_route(dtype, d)
        assert (route, pad) == _fwd_want(dtype, d), d
        assert pad >= d and pad in fa.GENERAL_HEAD_DIMS, d
        assert (route == "wgmma") == (fa.kernel_route(dtype, d)[0]
                                      == "wgmma"), d


@pytest.mark.parametrize("dtype,d,err", [
    (torch.float16, 64, TypeError),
    (torch.float16, 16, TypeError),
    (BF16, 0, ValueError),
    (BF16, 257, ValueError),
    (F32, 0, ValueError),
    (F32, 257, ValueError),
])
def test_fwd_route_raises_outside_the_domain(dtype, d, err):
    with pytest.raises(err):
        fa.fwd_route(dtype, d)


def test_fwd_route_is_a_cached_pure_function():
    # The wrapper looks the route up once a launch: the same (dtype, d)
    # gives the same answer from the cache.
    first = fa.fwd_route(F32, 64)
    hits = fa.fwd_route.cache_info().hits
    assert fa.fwd_route(F32, 64) == first
    assert fa.fwd_route.cache_info().hits == hits + 1


def _rna(x):
    """fp32 -> tf32 as cvt.rna.tf32.f32 rounds: half an ulp of tf32 added
    to the magnitude (the bit pattern is sign and magnitude), then the 13
    dropped mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as 3xTF32: the small terms first, then hi hi."""
    ah, bh = _rna(a), _rna(b)
    al, bl = _rna(a - ah), _rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    return _rna(a) @ _rna(b)


def _inputs(seed, b, sq, skv, h, d):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rs.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rs.uniform(-1.0, 1.0, (b, skv, h, d)).astype(np.float32)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _jax_case(d, causal):
    """The seeded inputs and the JAX package's fp32 forward ``(out, lse)``
    in interpret mode."""
    q, k, v = _inputs(200 + d, SHAPE["b"], SHAPE["sq"], SHAPE["skv"],
                      SHAPE["h"], d)
    out, lse = jax_flash_with_lse(
        *(jnp.asarray(x, jnp.float32) for x in (q, k, v)), causal=causal,
        block_q=16, block_k=16)
    return (q, k, v), np.asarray(out), np.asarray(lse)


def _emulated_fwd(q, k, v, *, causal, mm):
    """The fp32 sm90 forward with both products through ``mm``, on ``[B,
    S, H, D]`` fp32 tensors: the kernel's key tiles in order, the scores
    times sm_scale * log2(e), masked to -inf, a running max that stays -inf
    until a row sees a key (exponentiated against 0 meanwhile), the row
    sums over the unrounded p, out = O / l and lse = (m + log2 l) ln 2."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sq, skv, d = qh.shape[2], kh.shape[2], qh.shape[3]
    d_pad = fa.kernel_route(F32, d)[1]
    bk = 32 if d_pad >= 64 else 64  # the kernel's keys a tile
    scale_log2 = (1.0 / math.sqrt(d)) * LOG2E
    rows = torch.arange(sq)[:, None]
    shape = qh.shape[:3] + (1,)
    m = torch.full(shape, -math.inf)
    l = torch.zeros(shape)
    o = torch.zeros(qh.shape)
    for k0 in range(0, skv, bk):
        cols = torch.arange(k0, min(k0 + bk, skv))[None, :]
        s = mm(qh, kh[:, :, k0:k0 + bk].transpose(-1, -2)) * scale_log2
        keep = (cols <= rows) if causal else torch.ones_like(cols <= rows)
        s = s.masked_fill(~keep, -math.inf)
        mt = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(torch.isneginf(mt), torch.zeros_like(mt), mt)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, vh[:, :, k0:k0 + bk])
        m = mt
    has = l > 0
    out = torch.where(has, o / torch.where(has, l, torch.ones_like(l)), 0.0)
    lse = torch.where(has, (m + torch.log2(torch.where(has, l, 1.0)))
                      * math.log(2.0), -math.inf)
    return out.transpose(1, 2), lse.squeeze(-1)


def _worst_error(d, causal, mm):
    (q, k, v), out, lse = _jax_case(d, causal)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got_out, got_lse = _emulated_fwd(t(q), t(k), t(v), causal=causal, mm=mm)
    assert got_out.shape == out.shape and got_lse.shape == lse.shape
    assert np.array_equal(np.isneginf(got_lse.numpy()), np.isneginf(lse))
    fin = np.isfinite(lse)
    return max(float(np.abs(got_out.numpy() - out).max()),
               float(np.abs(got_lse.numpy()[fin] - lse[fin]).max()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_3xtf32_forward_matches_the_jax_kernel(d, causal):
    err = _worst_error(d, causal, _mm3)
    assert err <= FP32_TOL, err


@pytest.mark.parametrize("d", [64, 128])
def test_1xtf32_forward_misses_the_fp32_tolerance(d):
    # One tf32 product a matmul keeps about three decimal digits: out and
    # lse move past the fp32 tolerance, so the kernel splits.
    err = _worst_error(d, True, _mm1)
    assert err > FP32_TOL, err
