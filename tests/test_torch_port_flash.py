"""The port's flash-attention forward (horovod_tpu_torch.ops.
flash_attention) held against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version and the JAX kernel
runs in Pallas interpret mode (as tests/test_pallas_kernels.py runs it);
the same seeded numpy inputs go to both. Tolerances: fp32 inputs 2e-5
absolute on out and lse (summation order only); bf16 inputs 1e-2 on out
(one bf16 ulp below 1.0, where v in [-1, 1] keeps every output) and 1e-3
on lse (fp32 statistics over bf16 scores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import (
    flash_attention_with_lse as jax_flash_with_lse,
)
from horovod_tpu_torch.ops import flash_attention as fa

TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-3)}


def _inputs(seed, b, sq, skv, h, d):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rs.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rs.uniform(-1.0, 1.0, (b, skv, h, d)).astype(np.float32)
    return q, k, v


def _to_layout(x, layout):
    b, s, h, d = x.shape
    if layout == "bsm":
        return x.reshape(b, s, h * d)
    if layout == "bhsd":
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    return x


def _run_both(q, k, v, layout, dtype, block=16, **kw):
    h = q.shape[2]
    n_heads = h if layout == "bsm" else 0
    args = [_to_layout(x, layout) for x in (q, k, v)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jo, jl = jax_flash_with_lse(
        *[jnp.asarray(a, jdt) for a in args], layout=layout,
        n_heads=n_heads, block_q=block, block_k=block, **kw,
    )
    to, tl = fa.flash_attention_with_lse(
        *[torch.from_numpy(a).to(tdt) for a in args], layout=layout,
        n_heads=n_heads, **kw,
    )
    assert to.dtype == tdt and tl.dtype == torch.float32
    assert tuple(to.shape) == tuple(jo.shape)
    assert tuple(tl.shape) == tuple(jl.shape)
    return (
        np.asarray(jo.astype(jnp.float32)), np.asarray(jl),
        to.float().numpy(), tl.numpy(),
    )


def _assert_close(jo, jl, to, tl, dtype):
    tol_o, tol_l = TOL[dtype]
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl[fin], jl[fin], atol=tol_l, rtol=0)
    np.testing.assert_allclose(to, jo, atol=tol_o, rtol=0)


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["bsm", "bhsd", "bshd"])
def test_plain_version_matches_jax_flash(layout, causal, dtype, block):
    q, k, v = _inputs(0, 2, 48, 48, 2, 16)
    _assert_close(
        *_run_both(q, k, v, layout, dtype, block=block, causal=causal), dtype
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_uneven_kv_length(causal, dtype):
    # Skv = 40 is not a multiple of the JAX kernel's 16-key block: its
    # padding mask and the port's kv_len mask must agree.
    q, k, v = _inputs(1, 2, 32, 40, 2, 16)
    _assert_close(*_run_both(q, k, v, "bsm", dtype, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "q_offset,kv_offset", [(32, 0), (8, 0), (0, 5), (0, 32), (16, 40)]
)
def test_offsets_shift_the_causal_mask(q_offset, kv_offset, dtype):
    q, k, v = _inputs(2, 1, 32, 32, 2, 16)
    jo, jl, to, tl = _run_both(
        q, k, v, "bshd", dtype, causal=True, q_offset=q_offset,
        kv_offset=kv_offset,
    )
    _assert_close(jo, jl, to, tl, dtype)
    if kv_offset > q_offset + 31:
        # Every key in the future of every row: out 0, lse -inf.
        assert np.all(to == 0.0) and np.all(np.isneginf(tl))


def test_rows_without_keys_give_zero_and_neg_inf():
    q, k, v = _inputs(3, 1, 32, 32, 2, 16)
    jo, jl, to, tl = _run_both(
        q, k, v, "bsm", "float32", causal=True, q_offset=0, kv_offset=8,
    )
    _assert_close(jo, jl, to, tl, "float32")
    # Rows 0..7 see no key (key j sits at global position 8 + j).
    assert np.all(np.isneginf(tl[:, :, :8])) and np.all(np.isfinite(tl[:, :, 8:]))
    assert np.all(to.reshape(1, 32, 2, 16)[:, :8] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_kv_len_masks_like_a_shorter_sequence(causal):
    # The port's kv_len (keys at or past it masked) equals the JAX kernel
    # on K/V cut to that length.
    q, k, v = _inputs(4, 2, 40, 48, 2, 16)
    jo, jl = jax_flash_with_lse(
        jnp.asarray(q), jnp.asarray(k[:, :37]), jnp.asarray(v[:, :37]),
        causal=causal, block_q=16, block_k=16,
    )
    to, tl = fa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_len=37,
    )
    _assert_close(
        np.asarray(jo), np.asarray(jl), to.numpy(), tl.numpy(), "float32"
    )


def test_sm_scale_and_flash_attention_output():
    q, k, v = _inputs(5, 1, 32, 32, 2, 16)
    jo, _ = jax_flash_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sm_scale=0.3, block_q=16, block_k=16,
    )
    to = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, sm_scale=0.3,
    )
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)


def test_packed_strided_views_need_no_copy():
    # q/k/v as column slices of one fused [B, S, 3*H*D] projection (the
    # port's attention layout) give the same answer as contiguous inputs.
    q, k, v = _inputs(6, 2, 32, 32, 2, 16)
    packed = [torch.from_numpy(x.reshape(2, 32, 32)) for x in (q, k, v)]
    fused = torch.cat(packed, dim=-1)
    views = fused.split(32, dim=-1)
    assert not views[1].is_contiguous()
    a = fa.flash_attention_with_lse(*views, causal=True, layout="bsm", n_heads=2)
    b = fa.flash_attention_with_lse(*packed, causal=True, layout="bsm", n_heads=2)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_cpu_tensors_never_count_a_launch():
    fa.reset_launches()
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, 1, 16, 16, 2, 16))
    fa.flash_attention_with_lse(q, k, v, causal=True)
    fa.flash_attention(q.to(torch.bfloat16), k.to(torch.bfloat16),
                       v.to(torch.bfloat16))
    assert fa.launches == 0


def test_launch_count_survives_concurrent_workers():
    # Serving workers launch from several threads at once: the count is a
    # read-modify-write under a lock, so no increment may be lost.
    import sys
    import threading

    fa.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [fa._count_launch()
                                             for _ in range(2000)])
            for _ in range(16)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fa.launches == 16 * 2000
    fa.reset_launches()


def test_argument_validation():
    x = torch.zeros((1, 16, 32))
    with pytest.raises(ValueError, match="n_heads"):
        fa.flash_attention(x, x, x, layout="bsm")
    with pytest.raises(ValueError, match="layout"):
        fa.flash_attention(x, x, x, layout="sbhd")
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention(x, x, x, layout="bsm", n_heads=2, mask=x > 0)
    y = torch.zeros((1, 16, 2, 16))
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attention_with_lse(y, y, y, kv_len=17)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_with_lse(y, y, torch.zeros((1, 8, 2, 16)))
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_with_lse(y, y.double(), y)


def test_build_names_every_kernel_source():
    from horovod_tpu_torch.ops import _build

    assert "flash_fwd" in _build.sources()
    lib = _build._library_path("flash_fwd")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libflash_fwd-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    # A kernel source includes csrc/*.cuh: an edited header must name a new
    # library, or a stale one would be loaded from _build/.
    import shutil

    from horovod_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    headers = sorted(src.glob("*.cuh"))
    assert [h.name for h in headers] == ["bind_device.cuh", "sm90_common.cuh"]
    before = _build._library_path("flash_fwd")
    assert _build._library_path("flash_fwd") == before
    seen = {before}
    for header in headers:
        header.write_bytes(header.read_bytes() + b"\n")
        after = _build._library_path("flash_fwd")
        assert after not in seen and after.name.startswith("libflash_fwd-")
        seen.add(after)
    (src / "extra.cuh").write_bytes(b"// another header\n")
    assert _build._library_path("flash_fwd") not in seen


@pytest.mark.parametrize("layout", ["bsm", "bhsd", "bshd"])
@pytest.mark.parametrize("b,sq", [(1, 5), (3, 1), (1, 1)])
def test_map_strides_give_length_one_dims_16_bytes(layout, b, sq):
    # The forward and the backward hand their tensor maps the same strides:
    # the view's own, except that a dimension of length 1 gets 16 bytes
    # (8 bf16 elements) whatever torch says its stride is.
    h, d = 2, 64
    x = torch.zeros(
        {"bsm": (b, sq, h * d), "bhsd": (b, h, sq, d), "bshd": (b, sq, h, d)}
        [layout], dtype=torch.bfloat16,
    )
    x4 = fa._view4(x, layout, h)
    got = fa._map_strides(x4)
    for s, n, want in zip(got, x4.shape[:3], x4.stride()[:3]):
        assert s == (want if n > 1 else 8)
    assert all(s % 8 == 0 and s > 0 for s in got)
    # A length-1 dimension with a stride no tensor map takes is not refused.
    odd = torch.zeros((1, sq, 2, 64), dtype=torch.bfloat16).as_strided(
        (1, sq, 2, 64), (3, 128, 64, 1))
    assert fa._map_strides(odd)[0] == 8
    fa._check_kernel_operands((("q", odd),), 64)
    assert fa._map_strides(x4.float())[0] == (4 if b == 1 else x4.stride(0))
    # The wrapper's check hands back the same strides it checked.
    assert fa._check_kernel_operands((("q", x4),), d) == [got]
