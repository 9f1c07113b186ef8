"""The backward pair's sm90 route: ``horovod_tpu_torch.ops.flash_attention.
bwd_route`` and the arithmetic of the fp32 kernels in
``csrc/flash_bwd_sm90_general.cu``.

The route is decided by the dtype and the head dim alone: bf16 at 64 and
128 on the wgmma kernels (as ``kernel_route``), the sizes of
``SM90_BWD_SIZES`` where a row is whole 16-byte units on the sm90 kernels,
the rest on the general ones. The kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``). Here their fp32 arithmetic -- each of
the seven products as 3xTF32: every operand split into hi = rna(x) and lo
= rna(x - hi), rna the round to nearest, ties away from zero, on the 13
mantissa bits tf32 drops (what ``cvt.rna.tf32.f32`` does), and C = A_lo
B_hi + A_hi B_lo + A_hi B_hi in fp32 -- is emulated in torch and held
against the JAX package's ``_bwd_pallas`` in Pallas interpret mode (as
``tests/test_pallas_kernels.py`` runs it), at ``chip_smoke.py``'s
``[flash-general]`` shape [2, 200 / 333, 3, d], causal and not, with an
lse cotangent: the gradients within 2e-5 of the largest JAX gradient (the
fp32 tolerance of ``test_torch_port_flash_dims.py``). One product per
matmul in tf32 alone (1xTF32) misses that tolerance, which is why the
kernels split. The same seeded numpy inputs go to both.
"""

import functools

import jax
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
def test_bwd_route_maps_dtype_and_head_dim(dtype, d, want):
    assert fa.bwd_route(dtype, d) == want
    # The forward's route is kernel_route's, unchanged.
    assert fa.kernel_route(dtype, d)[1] == want[1]


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_bwd_route_covers_every_head_dim_up_to_256(dtype):
    # wgmma where kernel_route says so; sm90 exactly where the size is one
    # of SM90_BWD_SIZES and a row is whole 16-byte units; general for the
    # rest; the d_pad always kernel_route's.
    unit = 8 if dtype == BF16 else 4
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        fwd_route, d_pad = fa.kernel_route(dtype, d)
        route, pad = fa.bwd_route(dtype, d)
        assert pad == d_pad, d
        if fwd_route == "wgmma":
            assert route == "wgmma", d
        elif d % unit == 0 and d_pad in fa.SM90_BWD_SIZES[dtype]:
            assert route == "sm90", d
        else:
            assert route == "general", d


@pytest.mark.parametrize("dtype,d,err", [
    (torch.float16, 64, TypeError),
    (BF16, 257, ValueError),
    (F32, 0, ValueError),
])
def test_bwd_route_raises_outside_the_domain(dtype, d, err):
    with pytest.raises(err):
        fa.bwd_route(dtype, d)


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


def test_rna_rounds_half_away_from_zero_on_the_dropped_bits():
    one = 1.0
    ulp = 2.0 ** -10  # tf32's ulp at 1
    cases = [
        (one + ulp / 2, one + ulp),  # a tie rounds away from zero
        (-(one + ulp / 2), -(one + ulp)),
        (one + ulp / 2 - 2.0 ** -23, one),  # below the tie: down
        (one + 3 * ulp / 2, one + 2 * ulp),  # a tie, away again
        (one + ulp, one + ulp),  # already tf32
        (2.0 - ulp / 2, 2.0),  # the carry reaches the exponent
        (0.0, 0.0),
    ]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    assert torch.equal(_rna(x), want)
    # hi + lo carries 22 bits: the split of x holds x to 2^-22 relative.
    rs = np.random.RandomState(0)
    y = torch.from_numpy(rs.standard_normal(4096).astype(np.float32))
    hi = _rna(y)
    lo = _rna(y - hi)
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()


def _inputs(seed, b, sq, skv, h, d):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rs.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rs.uniform(-1.0, 1.0, (b, skv, h, d)).astype(np.float32)
    w_out = rs.standard_normal((b, sq, h, d)).astype(np.float32)
    w_lse = rs.standard_normal((b, h, sq)).astype(np.float32)
    return q, k, v, w_out, w_lse


@functools.lru_cache(maxsize=None)
def _jax_case(d, causal):
    """The seeded inputs, and the JAX package's fp32 forward ``(out, lse)``
    and gradients of sum(out * w_out) + sum(lse * w_lse): the custom_vjp
    backward, _bwd_pallas, in interpret mode."""
    q, k, v, w_out, w_lse = _inputs(100 + d, SHAPE["b"], SHAPE["sq"],
                                    SHAPE["skv"], SHAPE["h"], d)

    def loss(q, k, v):
        out, lse = jax_flash_with_lse(q, k, v, causal=causal, block_q=16,
                                      block_k=16)
        total = jnp.sum(out * w_out)
        total += jnp.sum(jnp.where(jnp.isfinite(lse), lse, 0.0) * w_lse)
        return total, (out, lse)

    (_, (out, lse)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x, jnp.float32) for x in (q, k, v)))
    return ((q, k, v, w_out, w_lse), np.asarray(out), np.asarray(lse),
            [np.asarray(g) for g in grads])


def _emulated_bwd(q, k, v, out, lse, g_out, g_lse, *, causal, mm):
    """The fp32 sm90 kernels' backward with every product through ``mm``:
    the dQ kernel (delta, S, dP, dQ) and the dK/dV kernel (its own S^T and
    dP^T, dV, dK), on ``[B, S, H, D]`` fp32 tensors."""
    qh, kh, vh, gh, oh = (x.transpose(1, 2) for x in (q, k, v, g_out, out))
    sq, skv, d = qh.shape[2], kh.shape[2], qh.shape[3]
    scale = 1.0 / float(np.sqrt(d))
    delta = (gh * oh).sum(-1, keepdim=True)  # [B, H, Sq, 1], fp32
    valid = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        valid = valid.tril()
    lse_r = lse[..., None]
    row_ok = torch.isfinite(lse_r)
    lse_safe = torch.where(row_ok, lse_r, torch.zeros_like(lse_r))
    glse = g_lse[..., None]

    def p_of(s, keep, l):
        return torch.where(keep, torch.exp(s * scale - l), 0.0)

    # dQ kernel.
    p = p_of(mm(qh, kh.transpose(-1, -2)), valid & row_ok, lse_safe)
    ds = p * (mm(gh, vh.transpose(-1, -2)) - delta) + glse * p
    dq = mm(ds, kh) * scale
    # dK/dV kernel: S^T and dP^T of its own.
    keep_t = (valid & row_ok).transpose(-1, -2)
    pt = p_of(mm(kh, qh.transpose(-1, -2)), keep_t,
              lse_safe.transpose(-1, -2))
    dpt = mm(vh, gh.transpose(-1, -2))
    dst = (pt * (dpt - delta.transpose(-1, -2))
           + glse.transpose(-1, -2) * pt)
    dv = mm(pt, gh)
    dk = mm(dst, qh) * scale
    return [x.transpose(1, 2) for x in (dq, dk, dv)]


def _worst_gradient_error(d, causal, mm):
    (q, k, v, w_out, w_lse), out, lse, jax_grads = _jax_case(d, causal)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    grads = _emulated_bwd(t(q), t(k), t(v), t(out), t(lse), t(w_out),
                          t(w_lse), causal=causal, mm=mm)
    errs = []
    for got, want in zip(grads, jax_grads):
        assert got.shape == want.shape
        scale = max(float(np.abs(want).max()), 1e-6)
        errs.append(float(np.abs(got.numpy() - want).max()) / scale)
    return max(errs)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_3xtf32_backward_matches_the_jax_kernels(d, causal):
    err = _worst_gradient_error(d, causal, _mm3)
    assert err <= FP32_TOL, err


@pytest.mark.parametrize("d", [64, 128])
def test_1xtf32_backward_misses_the_fp32_tolerance(d):
    # One tf32 product a matmul keeps about three decimal digits: the
    # gradients move past the fp32 tolerance, so the kernels split.
    err = _worst_gradient_error(d, True, _mm1)
    assert err > FP32_TOL, err
