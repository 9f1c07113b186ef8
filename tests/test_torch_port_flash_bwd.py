"""The port's flash-attention backward held against the JAX package's.

Gradients go through the port's ``FlashAttention`` autograd Function (on
the CPU its backward runs ``flash_attention_bwd_reference``, the plain
version of the two CUDA backward kernels) and through ``jax.grad`` of the
JAX package's ``flash_attention_with_lse``, whose ``custom_vjp`` backward
runs the Pallas kernels ``_bwd_kernel_dkdv`` / ``_bwd_kernel_dq`` in
interpret mode with ``block_q = block_k = 16``, as
``tests/test_pallas_kernels.py`` runs them. The same seeded numpy inputs
and cotangent weights go to both. The loss uses both outputs,
``sum(out * w_out) + sum(lse * w_lse)`` over the rows that have keys, so
the ``g_lse`` term of ``dS`` is exercised.

Tolerances, relative to the largest gradient of the case: fp32 2e-5
(summation order only); bf16 2e-2 (the gradients are bf16 outputs: one
bf16 ulp is 2^-8 of the value, and ``P`` / ``dS`` are rounded to bf16
before their products in both, with fp32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import (
    _bwd_pallas,
    flash_attention_with_lse as jax_flash_with_lse,
)
from horovod_tpu_torch.ops import flash_attention as fa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _jax_grads(q, k, v, w_out, w_lse, dtype, use_lse=True, **kw):
    jdt = _DT[dtype][0]

    def loss(q, k, v):
        out, lse = jax_flash_with_lse(q, k, v, block_q=16, block_k=16, **kw)
        total = jnp.sum(out.astype(jnp.float32) * w_out)
        if use_lse:
            total += jnp.sum(jnp.where(jnp.isfinite(lse), lse, 0.0) * w_lse)
        return total

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v))
    )
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, w_out, w_lse, dtype, use_lse=True, **kw):
    tdt = _DT[dtype][1]
    ts = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(*ts, **kw)
    total = (out.float() * torch.from_numpy(w_out)).sum()
    if use_lse:
        total = total + (torch.where(torch.isfinite(lse), lse, 0.0)
                         * torch.from_numpy(w_lse)).sum()
    total.backward()
    for t in ts:
        assert t.grad.dtype == tdt and t.grad.shape == t.shape
    return [t.grad.float().numpy() for t in ts]


def _check(q, k, v, w_out, w_lse, dtype, layout="bshd", use_lse=True, **kw):
    h = q.shape[2]
    kw = dict(kw, layout=layout, n_heads=h if layout == "bsm" else 0)
    args = [_to_layout(x, layout) for x in (q, k, v, w_out)] + [w_lse]
    want = _jax_grads(*args, dtype, use_lse=use_lse, **kw)
    got = _port_grads(*args, dtype, use_lse=use_lse, **kw)
    for name, g, w in zip("qkv", got, want):
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= TOL[dtype] * scale, (name, err, scale)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["bsm", "bhsd", "bshd"])
def test_grads_match_jax_flash_backward(layout, causal, dtype):
    _check(*_inputs(0, 2, 48, 48, 2, 16), dtype, layout=layout,
           causal=causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "q_offset,kv_offset", [(32, 0), (8, 0), (0, 5), (16, 40)]
)
def test_offsets_mask_the_backward_like_the_forward(q_offset, kv_offset,
                                                    dtype):
    _check(*_inputs(1, 1, 32, 32, 2, 16), dtype, causal=True,
           q_offset=q_offset, kv_offset=kv_offset)


def test_rows_without_keys_get_zero_gradient():
    # kv_offset=8: query rows 0..7 see no key (lse = -inf); their dq is
    # zero, and their cotangents reach no key.
    q, k, v, w_out, w_lse = _inputs(2, 1, 32, 32, 2, 16)
    dq, dk, dv = _check(q, k, v, w_out, w_lse, "float32", causal=True,
                        kv_offset=8)
    assert np.all(dq[:, :8] == 0.0) and np.any(dq[:, 8:] != 0.0)
    # Every key is at or after position 8, so rows 8.. see some of them.
    assert np.any(dk != 0.0) and np.any(dv != 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_uneven_kv_length(causal):
    # Skv = 40 is not a multiple of the JAX kernel's 16-key block.
    _check(*_inputs(3, 2, 32, 40, 2, 16), "float32", layout="bsm",
           causal=causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_on_out_only_takes_a_zero_lse_cotangent(dtype):
    # lse unused: its cotangent reaches the backward as None (zeros).
    _check(*_inputs(4, 2, 48, 48, 2, 16), dtype, causal=True, use_lse=False)


@pytest.mark.parametrize("causal", [False, True])
def test_kv_len_backward_equals_a_shorter_sequence(causal):
    # The port's kv_len against the JAX kernel on K/V cut to that length;
    # keys at or past kv_len get zero gradient.
    q, k, v, w_out, w_lse = _inputs(5, 2, 40, 48, 2, 16)
    want = _jax_grads(q, k[:, :37], v[:, :37], w_out, w_lse, "float32",
                      causal=causal)
    got = _port_grads(q, k, v, w_out, w_lse, "float32", causal=causal,
                      kv_len=37)
    for g, w in zip(got, want):
        n = w.shape[1]
        np.testing.assert_allclose(g[:, :n], w, atol=2e-5 * np.abs(w).max(),
                                   rtol=0)
        assert np.all(g[:, n:] == 0.0)


def test_bwd_reference_matches_autograd_of_the_forward():
    # The plain backward against torch autograd through the plain forward:
    # the formula itself. Both plain versions compute in fp32 whatever the
    # input dtype, so float64 inputs still differ by fp32 rounding only.
    q, k, v, w_out, w_lse = _inputs(6, 1, 24, 24, 2, 16)
    ts = [torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v)]
    out, lse = fa.flash_attention_reference(*ts, causal=True, q_offset=4)
    g_out = torch.from_numpy(w_out).double()
    g_lse = torch.from_numpy(w_lse).double()
    ((out * g_out).sum() + (lse * g_lse).sum()).backward()
    dq, dk, dv = fa.flash_attention_bwd_reference(
        *(t.detach() for t in ts), out.detach(), lse.detach(), g_out, g_lse,
        causal=True, q_offset=4,
    )
    for got, t in zip((dq, dk, dv), ts):
        torch.testing.assert_close(got, t.grad, rtol=0,
                                   atol=1e-5 * t.grad.abs().max().item())


def test_autograd_reaches_the_backward_and_counts_no_launch_on_cpu():
    calls = []
    orig = fa.flash_attention_bwd_reference

    def spy(*a, **kw):
        calls.append(kw.get("layout"))
        return orig(*a, **kw)

    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(7, 1, 16, 16, 2, 16)[:3])
    fa.reset_launches()
    try:
        fa.flash_attention_bwd_reference = spy
        fa.flash_attention(q, k, v, causal=True).sum().backward()
    finally:
        fa.flash_attention_bwd_reference = orig
    assert calls == ["bshd"] and q.grad is not None
    assert fa.launches == fa.launches_dkdv == fa.launches_dq == 0
    # Without autograd recording, no Function is built.
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None


def _rounding_sensitive_inputs(seed, b, s, h, d):
    """bf16 q/k/v (``[B, H, S, D]``) and the pieces of an fp32 cotangent of
    out whose bf16 rounding moves ``delta = rowsum(dO * out)`` by about as
    much as the gradient itself. v = u + w: u is one row per (batch, head)
    in the first half of D, entries +-{1, 1.25, 1.5, 1.75} (bf16-exact), w
    noise in the second half. The cotangent is c + e: c turns u pairwise,
    (u1, -u0, u3, -u2, ...), so c . v = 0 for every key and c . out is
    near 0; e is out's first half times 2^-10, below half a bf16 ulp of c,
    so c + e rounds to c and only the unrounded cotangent carries e . out."""
    rs = np.random.RandomState(seed)
    half = d // 2
    q = rs.standard_normal((b, h, s, d)).astype(np.float32)
    k = rs.standard_normal((b, h, s, d)).astype(np.float32)
    u = (rs.choice([1.0, 1.25, 1.5, 1.75], (b, h, 1, half))
         * rs.choice([-1.0, 1.0], (b, h, 1, half))).astype(np.float32)
    v = np.concatenate(
        [np.broadcast_to(u, (b, h, s, half)),
         rs.standard_normal((b, h, s, d - half)).astype(np.float32)], axis=-1)
    c = np.zeros((b, h, s, d), np.float32)
    c[..., 0:half:2] = u[..., 1::2]
    c[..., 1:half:2] = -u[..., 0::2]
    return q, k, v, c


@pytest.mark.parametrize("causal", [False, True])
def test_delta_comes_from_the_cotangent_as_given(causal):
    # An fp32 cotangent with bf16 q/k/v: the JAX backward computes delta
    # from it unrounded (only the kernels' dO operand is rounded), and so
    # must the port; rounding it first moves dq and dk far past the bf16
    # tolerance, so the case tells the two apart.
    q, k, v, c = _rounding_sensitive_inputs(8, 1, 32, 2, 16)
    ts = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    out, lse = fa.flash_attention_reference(*ts, causal=causal, layout="bhsd")
    half = q.shape[-1] // 2
    e = np.zeros_like(c)
    e[..., :half] = out.float().numpy()[..., :half] * 2.0 ** -10
    g = c + e
    assert np.array_equal(
        torch.from_numpy(g).to(torch.bfloat16).float().numpy(), c)
    got = fa.flash_attention_bwd(*ts, out, lse, torch.from_numpy(g), None,
                                 causal=causal, layout="bhsd")
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jout = jnp.asarray(out.float().numpy(), jnp.bfloat16)
    jlse = jnp.asarray(lse.numpy())

    def jax_bwd(g_out):
        grads = _bwd_pallas(
            jq, jk, jv, 0, 0, jout, jlse, g_out, None,
            sm_scale=1.0 / np.sqrt(q.shape[-1]), causal=causal, block_q=16,
            block_k=16, interpret=True,
        )
        return [np.asarray(x.astype(jnp.float32)) for x in grads]

    want = jax_bwd(jnp.asarray(g))
    rounded = jax_bwd(jnp.asarray(g, jnp.bfloat16))
    for name, x, w, r in zip("qkv", got, want, rounded):
        scale = float(np.abs(w).max())
        err = float(np.abs(x.float().numpy() - w).max())
        assert err <= TOL["bfloat16"] * scale, (name, err, scale)
        if name != "v":  # dv = P^T dO takes the rounded dO in both
            assert float(np.abs(r - w).max()) > 0.1 * scale, name
