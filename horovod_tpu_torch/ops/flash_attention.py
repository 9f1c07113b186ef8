"""Flash attention: the CUDA kernels, their wrappers and their plain
versions, forward and backward.

The port of ``horovod_tpu/ops/pallas_kernels.py``'s flash attention: the
forward ``_fwd_kernel`` (through ``_fwd_pallas``, ``flash_attention_with_lse``
and ``flash_attention``) and the backward pair ``_bwd_kernel_dkdv`` /
``_bwd_kernel_dq`` (through ``_bwd_pallas``, the ``custom_vjp`` backward of
``_flash``). The kernels are ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``
-- hand-written CUDA C++ for sm_90a, built with nvcc at first use
(:mod:`._build`); their source notes say what bounds them on an H100 and
what their designs leave on the table. The backward launches the dQ
kernel first: it also computes ``delta`` and hands it to the dK/dV kernel
through an fp32 scratch buffer.

* :func:`flash_attention_with_lse` -- ``(out, lse)``: out in the input
  dtype, lse fp32 ``[B, H, Sq]``; causal masking on global positions
  ``q_offset``/``kv_offset``; keys at or past ``kv_len`` (default: all of
  them) are masked; rows with no valid key give out 0 and lse ``-inf``.
  When autograd records (grad mode on and an input requiring grad) the
  call goes through :class:`FlashAttention`, whose backward takes the
  cotangents of both ``out`` and ``lse``; under ``torch.no_grad()`` or
  ``torch.inference_mode()`` it is the forward alone.
* :func:`flash_attention` -- the output only.
* :func:`flash_attention_bwd` -- ``(dq, dk, dv)`` from the saved
  ``q, k, v, out, lse`` and the cotangents ``g_out``, ``g_lse`` (``None``
  means zeros), in the inputs' layout and dtype.
* :func:`combine_blocks` -- merges a partial ``(out, lse)`` into a running
  one (the ring attention's per-hop update); plain torch, not a kernel.
* :func:`flash_attention_reference` / :func:`flash_attention_bwd_reference`
  -- the plain PyTorch versions with the same signatures and outputs: fp32
  scores and softmax statistics, ``p`` rounded to V's dtype before the PV
  product; in the backward ``dO`` cast to the input dtype, ``p`` rounded
  before ``dV`` and ``dS`` before ``dK``/``dQ``, ``sm_scale`` applied to
  the fp32 products, ``delta = rowsum(dO * out)`` in fp32 from the
  cotangent as given (an fp32 ``g_out`` is not rounded for it).

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain versions, CUDA tensors launch the kernels or raise. Layouts are the
JAX package's: ``"bshd"`` ``[B, S, H, D]``, ``"bhsd"`` ``[B, H, S, D]`` and
the packed ``"bsm"`` ``[B, S, H*D]`` with ``n_heads`` given -- the
projection's native layout, which the kernels read in place through
strides (a strided view such as one third of a fused QKV output is read
without a copy). The kernels take bf16 with head dim 64 or 128.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build, _library

__all__ = [
    "FlashAttention",
    "combine_blocks",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_with_lse",
    "flash_attention_reference",
    "launches",
    "launches_dkdv",
    "launches_dq",
    "reset_launches",
]

KERNEL_SOURCE = "flash_fwd"
BWD_SOURCE = "flash_bwd"
HEAD_DIMS = (64, 128)

# Kernel launches since import (or the last reset_launches()), one count per
# kernel: each wrapper adds one where it launches its kernel and nowhere
# else, so a run can show that its main path went through the kernels.
launches = 0  # flash_fwd
launches_dkdv = 0  # flash_bwd: dK/dV
launches_dq = 0  # flash_bwd: dQ
_count_lock = threading.Lock()
_fn = None
_bwd_fns = None


def reset_launches() -> None:
    global launches, launches_dkdv, launches_dq
    with _count_lock:
        launches = launches_dkdv = launches_dq = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def _count_bwd_launch(kind: str) -> None:
    global launches_dkdv, launches_dq
    with _count_lock:
        if kind == "dkdv":
            launches_dkdv += 1
        else:
            launches_dq += 1


def _view4(x, layout: str, n_heads: int):
    """``[B, S, H, D]`` view of one tensor in ``layout`` (no copy)."""
    if layout == "bsm":
        if n_heads <= 0:
            raise ValueError("layout='bsm' requires n_heads")
        *lead, m = x.shape
        if m % n_heads:
            raise ValueError(
                f"packed width {m} is not a multiple of n_heads={n_heads}"
            )
        return x.view(*lead, n_heads, m // n_heads)
    if layout == "bshd":
        return x
    if layout == "bhsd":
        return x.transpose(1, 2)
    raise ValueError(
        f"layout must be 'bshd', 'bhsd' or 'bsm', got {layout!r}"
    )


def _views(q, k, v, layout: str, n_heads: int):
    """``[B, S, H, D]`` views of q/k/v (no copies)."""
    return tuple(_view4(x, layout, n_heads) for x in (q, k, v))


def _empty_out(b, sq, h, d, layout, like):
    """Output tensor in ``layout`` and its ``[B, Sq, H, D]`` view."""
    if layout == "bsm":
        out = torch.empty((b, sq, h * d), dtype=like.dtype, device=like.device)
        return out, out.view(b, sq, h, d)
    if layout == "bhsd":
        out = torch.empty((b, h, sq, d), dtype=like.dtype, device=like.device)
        return out, out.transpose(1, 2)
    out = torch.empty((b, sq, h, d), dtype=like.dtype, device=like.device)
    return out, out


def _check(q4, k4, v4, kv_len):
    if not (q4.dtype == k4.dtype == v4.dtype):
        raise TypeError(
            f"q/k/v dtypes differ: {q4.dtype}, {k4.dtype}, {v4.dtype}"
        )
    if not (q4.device == k4.device == v4.device):
        raise ValueError(
            f"q/k/v devices differ: {q4.device}, {k4.device}, {v4.device}"
        )
    b, sq, h, d = q4.shape
    if k4.shape[0] != b or k4.shape[2:] != (h, d) or v4.shape != k4.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q4.shape)}, k {tuple(k4.shape)}, "
            f"v {tuple(v4.shape)} (as [B, S, H, D])"
        )
    skv = k4.shape[1]
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len={kv_len} outside [0, {skv}]")
    return kv_len


def _scalar(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _valid_mask(sq, skv, kv_len, causal, q_offset, kv_offset, device):
    """``[Sq, Skv]`` bool: the keys each query row may attend to."""
    col = torch.arange(skv, device=device)
    valid = (col < kv_len).expand(sq, skv)
    if causal:
        q_pos = _scalar(q_offset) + torch.arange(sq, device=device)
        valid = valid & (q_pos[:, None] >= _scalar(kv_offset) + col[None, :])
    return valid


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset=0,
    kv_offset=0,
    sm_scale: Optional[float] = None,
    layout: str = "bshd",
    n_heads: int = 0,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the forward kernel (same signature,
    same outputs). Scores and softmax statistics are fp32; ``p`` is
    rounded to V's dtype before the PV product, which accumulates in
    fp32."""
    q4, k4, v4 = _views(q, k, v, layout, n_heads)
    kv_len = _check(q4, k4, v4, kv_len)
    b, sq, h, d = q4.shape
    skv = k4.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qh = q4.transpose(1, 2).float()  # [B, H, Sq, D]
    kh = k4.transpose(1, 2).float()
    vh = v4.transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale  # [B, H, Sq, Skv]
    valid = _valid_mask(sq, skv, kv_len, causal, q_offset, kv_offset, q.device)
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vh.float())
    has = l > 0
    o = torch.where(has, o / torch.where(has, l, torch.ones_like(l)), 0.0)
    lse = torch.where(has, m_safe + torch.log(l), float("-inf")).squeeze(-1)
    out, out4 = _empty_out(b, sq, h, d, layout, q)
    out4.copy_(o.transpose(1, 2))
    return out, lse


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL_SOURCE).hvt_flash_fwd_bf16
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = (
            [ptr] * 5 + [i32] * 5 + [ptr]
            + [i32, i32, i32, ctypes.c_float, i32, i32, ptr]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _map_strides(x):
    """Element strides (batch, seq, head) of a ``[B, S, H, D]`` view as the
    kernels take them: a dimension of length 1 is never stepped along, so
    its stride is given as 16 bytes, which a TMA tensor map takes whatever
    the view says (a size-1 dimension's stride is arbitrary in torch)."""
    st, n, unit = x.stride(), x.shape, 16 // x.element_size()
    return (st[0] if n[0] > 1 else unit, st[1] if n[1] > 1 else unit,
            st[2] if n[2] > 1 else unit)


def _check_kernel_operands(named, d):
    """What the CUDA kernels take: bf16, head dim 64/128, unit stride
    along D and 16-byte aligned rows. Returns each operand's
    :func:`_map_strides`."""
    for name, x in named:
        if x.dtype != torch.bfloat16:
            raise TypeError(
                f"the CUDA flash kernels take bfloat16, got {x.dtype} for "
                f"{name}"
            )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernels take head dim {HEAD_DIMS}, got {d}"
        )
    b, _, h, _ = named[0][1].shape
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid limit")
    strides = []
    for name, x in named:
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a unit stride along D")
        st = _map_strides(x)
        if st[0] % 8 or st[1] % 8 or st[2] % 8 or x.data_ptr() % 16:
            raise ValueError(
                f"{name} rows must be 16-byte aligned: strides "
                f"{tuple(x.stride())}, address {x.data_ptr():#x}"
            )
        strides.append(st)
    return strides


def _launch(q4, k4, v4, *, causal, q_offset, kv_offset, sm_scale, layout,
            kv_len):
    b, sq, h, d = q4.shape
    skv = k4.shape[1]
    st = _check_kernel_operands((("q", q4), ("k", k4), ("v", v4)), d)
    if 0 in st[0] or 0 in st[1] or 0 in st[2]:
        # A tensor map steps every dimension by a nonzero stride: an
        # expanded (stride 0) operand is copied first.
        q4, k4, v4 = (x.contiguous() if 0 in xs else x
                      for x, xs in zip((q4, k4, v4), st))
        st = _check_kernel_operands((("q", q4), ("k", k4), ("v", v4)), d)
    out, o4 = _empty_out(b, sq, h, d, layout, q4)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q4.device)
    if b == 0 or h == 0 or sq == 0:
        return out, lse
    fn = _kernel_fn()
    strides = (ctypes.c_longlong * 12)(*st[0], *st[1], *st[2],
                                        *_map_strides(o4))
    # The entry point launches on the tensors' device (and restores the
    # thread's current one), on torch's current stream there.
    dev = q4.get_device()
    rc = fn(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
        lse.data_ptr(), b, h, sq, skv, d, strides,
        kv_len, q_offset, kv_offset, float(sm_scale), int(bool(causal)),
        dev, torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed with cudaError_t {rc}"
        )
    _count_launch()
    return out, lse


def _fwd_impl(q, k, v, causal, q_offset, kv_offset, sm_scale, layout,
              n_heads, kv_len):
    """``hvt::flash_fwd``: the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            sm_scale=sm_scale, layout=layout, n_heads=n_heads, kv_len=kv_len,
        )
    q4, k4, v4 = _views(q, k, v, layout, n_heads)
    kv_len = _check(q4, k4, v4, kv_len)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q4.shape[-1])
    return _launch(
        q4, k4, v4, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
        sm_scale=sm_scale, layout=layout, kv_len=kv_len,
    )


def _fwd_fake(q, k, v, causal, q_offset, kv_offset, sm_scale, layout,
              n_heads, kv_len):
    _check(*_views(q, k, v, layout, n_heads), kv_len)
    b, sq, h, d = _view4(q, layout, n_heads).shape
    out, _ = _empty_out(b, sq, h, d, layout, q)
    return out, q.new_empty((b, h, sq), dtype=torch.float32)


_flash_fwd_op = _library.define(
    "flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, int q_offset, "
    "int kv_offset, float? sm_scale, str layout, int n_heads, int? kv_len)"
    " -> (Tensor, Tensor)", _fwd_impl, _fwd_fake)


def _forward(q, k, v, *, causal, q_offset, kv_offset, sm_scale, layout,
             n_heads, kv_len):
    """The forward alone, through ``hvt::flash_fwd``: the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    device = q.device.type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {device}")
    return _flash_fwd_op(q, k, v, bool(causal), _scalar(q_offset),
                         _scalar(kv_offset), sm_scale, layout, int(n_heads),
                         kv_len)


def flash_attention_bwd_reference(
    q, k, v, out, lse, g_out, g_lse=None, *,
    causal: bool = False,
    q_offset=0,
    kv_offset=0,
    sm_scale: Optional[float] = None,
    layout: str = "bshd",
    n_heads: int = 0,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward kernels: ``(dq, dk, dv)``
    in the inputs' layout and dtype (``_recompute_p_ds`` and the two
    ``_bwd_kernel_*`` of the JAX package, written out densely)."""
    q4, k4, v4 = _views(q, k, v, layout, n_heads)
    kv_len = _check(q4, k4, v4, kv_len)
    b, sq, h, d = q4.shape
    skv = k4.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dt = q4.dtype
    g4 = _view4(g_out, layout, n_heads)
    o4 = _view4(out, layout, n_heads)
    # delta from the cotangent as given, the kernels' dO in the input dtype.
    delta = torch.einsum("bqhd,bqhd->bhq", g4.float(), o4.float())
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q4, k4, v4))
    gh = g4.to(dt).transpose(1, 2).float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale  # [B, H, Sq, Skv]
    valid = _valid_mask(sq, skv, kv_len, causal, q_offset, kv_offset, q.device)
    lse_r = lse.float()[..., None]
    row_ok = ~torch.isneginf(lse_r)  # rows without keys contribute nothing
    p = torch.where(
        valid & row_ok,
        torch.exp(s - torch.where(row_ok, lse_r, torch.zeros_like(lse_r))),
        0.0,
    )
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    glse = (
        torch.zeros_like(lse_r) if g_lse is None else g_lse.float()[..., None]
    )
    ds = p * (dp - delta[..., None]) + glse * p
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dsr = ds.to(dt).float()
    dk = torch.matmul(dsr.transpose(-1, -2), qh) * sm_scale
    dq = torch.matmul(dsr, kh) * sm_scale
    grads = []
    for x, s_len in ((dq, sq), (dk, skv), (dv, skv)):
        buf, buf4 = _empty_out(b, s_len, h, d, layout, q4)
        buf4.copy_(x.transpose(1, 2))
        grads.append(buf)
    return tuple(grads)


def _bwd_kernel_fns():
    global _bwd_fns
    if _bwd_fns is None:
        lib = _build.load(BWD_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 5 + [ptr] + [i32] * 3 + [ctypes.c_float, i32, i32, ptr]
        dkdv = lib.hvt_flash_bwd_dkdv_bf16
        dkdv.argtypes = [ptr] * 9 + tail
        dkdv.restype = ctypes.c_int
        dq = lib.hvt_flash_bwd_dq_bf16
        dq.argtypes = [ptr] * 6 + [i32] + [ptr] * 4 + tail
        dq.restype = ctypes.c_int
        _bwd_fns = (dkdv, dq)
    return _bwd_fns


def _rows_aligned(x) -> bool:
    """Unit stride along D, and every other stride of a dimension longer
    than 1 a nonzero multiple of 16 bytes, from a 16-byte aligned base:
    what TMA and the kernels' 16-byte loads take."""
    unit = 16 // x.element_size()
    return x.stride(3) == 1 and x.data_ptr() % 16 == 0 and all(
        n == 1 or (s != 0 and s % unit == 0)
        for s, n in zip(x.stride()[:3], x.shape[:3])
    )


def _bwd_launch(q4, k4, v4, o4, g4, lse, g_lse, *, causal, q_offset,
                kv_offset, sm_scale, layout, kv_len):
    b, sq, h, d = q4.shape
    skv = k4.shape[1]
    # delta = rowsum(dO * out) comes from the cotangent as given (the dQ
    # kernel reads it in bf16 or fp32); the products take dO in the input
    # dtype.
    given = g4 if g4.dtype in (torch.bfloat16, torch.float32) else g4.float()
    if not _rows_aligned(given):
        given = given.contiguous()
    g_op = g4 if g4.dtype == q4.dtype else g4.to(q4.dtype)
    if not _rows_aligned(g_op):
        g_op = g_op.contiguous()
    if not _rows_aligned(o4):
        o4 = o4.contiguous()
    _check_kernel_operands(
        (("q", q4), ("k", k4), ("v", v4), ("dO", g_op), ("out", o4)), d
    )
    dq, dq4 = _empty_out(b, sq, h, d, layout, q4)
    dk, dk4 = _empty_out(b, skv, h, d, layout, q4)
    dv, dv4 = _empty_out(b, skv, h, d, layout, q4)
    if b == 0 or h == 0 or sq == 0 or skv == 0:
        for x in (dq, dk, dv):
            x.zero_()
        return dq, dk, dv
    lse = lse.float().contiguous()
    glse = None if g_lse is None else g_lse.float().contiguous()
    for name, x in (("lse", lse), ("g_lse", glse)):
        if x is not None and tuple(x.shape) != (b, h, sq):
            raise ValueError(
                f"{name} has shape {tuple(x.shape)}, expected {(b, h, sq)}"
            )
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q4.device)
    strides = (ctypes.c_longlong * 27)(*[
        s for x in (q4, k4, v4, g_op, dq4, dk4, dv4, o4, given)
        for s in _map_strides(x)
    ])
    tail = [b, h, sq, skv, d, strides, kv_len, q_offset, kv_offset,
            float(sm_scale), int(bool(causal))]
    glse_ptr = None if glse is None else glse.data_ptr()
    fn_dkdv, fn_dq = _bwd_kernel_fns()
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        # dQ first: it writes delta, which the dK/dV kernel reads after it
        # on the same stream.
        rc = fn_dq(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                   g_op.data_ptr(), o4.data_ptr(), given.data_ptr(),
                   int(given.dtype == torch.float32), lse.data_ptr(),
                   glse_ptr, delta.data_ptr(), dq4.data_ptr(), *tail,
                   q4.device.index, stream)
        if rc != 0:
            raise RuntimeError(
                f"flash_bwd dQ kernel launch failed with cudaError_t {rc}"
            )
        _count_bwd_launch("dq")
        rc = fn_dkdv(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                     g_op.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     glse_ptr, dk4.data_ptr(), dv4.data_ptr(), *tail,
                     q4.device.index, stream)
        if rc != 0:
            raise RuntimeError(
                f"flash_bwd dK/dV kernel launch failed with cudaError_t {rc}"
            )
        _count_bwd_launch("dkdv")
    return dq, dk, dv


def _bwd_impl(q, k, v, out, lse, g_out, g_lse, causal, q_offset, kv_offset,
              sm_scale, layout, n_heads, kv_len):
    """``hvt::flash_bwd``: the plain version for CPU tensors; for CUDA
    tensors the dQ kernel, then the dK/dV kernel on the same stream (they
    share the ``delta`` scratch the dQ kernel writes)."""
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              sm_scale=sm_scale, layout=layout, n_heads=n_heads,
              kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, g_out, g_lse,
                                             **kw)
    q4, k4, v4 = _views(q, k, v, layout, n_heads)
    kv_len = _check(q4, k4, v4, kv_len)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q4.shape[-1])
    return _bwd_launch(
        q4, k4, v4, _view4(out, layout, n_heads),
        _view4(g_out, layout, n_heads), lse, g_lse, causal=causal,
        q_offset=q_offset, kv_offset=kv_offset,
        sm_scale=sm_scale, layout=layout, kv_len=kv_len,
    )


def _bwd_fake(q, k, v, out, lse, g_out, g_lse, causal, q_offset, kv_offset,
              sm_scale, layout, n_heads, kv_len):
    _check(*_views(q, k, v, layout, n_heads), kv_len)
    b, sq, h, d = _view4(q, layout, n_heads).shape
    skv = _view4(k, layout, n_heads).shape[1]
    return tuple(_empty_out(b, s_len, h, d, layout, q)[0]
                 for s_len in (sq, skv, skv))


_flash_bwd_op = _library.define(
    "flash_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
    "Tensor g_out, Tensor? g_lse, bool causal, int q_offset, int kv_offset, "
    "float? sm_scale, str layout, int n_heads, int? kv_len) "
    "-> (Tensor, Tensor, Tensor)", _bwd_impl, _bwd_fake)


def flash_attention_bwd(
    q, k, v, out, lse, g_out, g_lse=None, *,
    causal: bool = False,
    q_offset=0,
    kv_offset=0,
    sm_scale: Optional[float] = None,
    layout: str = "bshd",
    n_heads: int = 0,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of flash attention from the forward's
    inputs and outputs and the cotangents of ``out`` and ``lse`` (``g_lse``
    ``None`` means zeros) -- the port of ``_bwd_pallas``, through
    ``hvt::flash_bwd``. CUDA tensors run the two backward kernels; CPU
    tensors run :func:`flash_attention_bwd_reference`."""
    device = q.device.type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {device}")
    return _flash_bwd_op(q, k, v, out, lse, g_out, g_lse, bool(causal),
                         _scalar(q_offset), _scalar(kv_offset), sm_scale,
                         layout, int(n_heads), kv_len)


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` with the flash backward -- the counterpart of the JAX
    package's ``_flash`` with its ``custom_vjp``. The forward saves ``q, k,
    v, out, lse``; the backward takes the cotangents of both outputs (a
    ``None`` cotangent of ``lse`` is zero) and calls
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_offset, sm_scale, layout,
                n_heads, kv_len):
        kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
                  sm_scale=sm_scale, layout=layout, n_heads=n_heads,
                  kv_len=kv_len)
        out, lse = _forward(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g_out, g_lse,
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset=0,
    kv_offset=0,
    sm_scale: Optional[float] = None,
    layout: str = "bshd",
    n_heads: int = 0,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise attention returning ``(out, lse)`` -- the port of the
    JAX package's ``flash_attention_with_lse``. CUDA tensors run the
    kernels; CPU tensors run the plain versions. Differentiable through
    :class:`FlashAttention` when autograd records."""
    kw = dict(causal=causal, q_offset=_scalar(q_offset),
              kv_offset=_scalar(kv_offset), sm_scale=sm_scale, layout=layout,
              n_heads=n_heads, kv_len=kv_len)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, *kw.values())
    return _forward(q, k, v, **kw)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask=None,
    sm_scale: Optional[float] = None,
    layout: str = "bshd",
    n_heads: int = 0,
) -> torch.Tensor:
    """Memory-efficient attention output (the port of the JAX package's
    ``flash_attention``). A dense ``mask`` is not supported by the
    blockwise kernel."""
    if mask is not None:
        raise ValueError(
            "flash_attention supports causal masking only; pass mask=None"
        )
    out, _ = flash_attention_with_lse(
        q, k, v, causal=causal, sm_scale=sm_scale, layout=layout,
        n_heads=n_heads,
    )
    return out


def combine_blocks(o_acc, lse_acc, o_i, lse_i):
    """Merge a partial attention ``(o_i, lse_i)`` into the running
    ``(o_acc, lse_acc)`` -- the port of the JAX package's
    ``combine_blocks``, the per-hop update of the flash ring
    (:mod:`..parallel.sp`). Both ``o`` are normalized outputs ``[B, S, H,
    D]``, both ``lse`` fp32 ``[B, H, S]``; the merged output is the
    lse-weighted convex combination, ``lse_new = logaddexp(lse_acc,
    lse_i)``. A row that is ``-inf`` on one side takes the other side
    whole; a row ``-inf`` on both stays ``-inf`` with output 0.

    Every ``exp`` and ``log`` takes an argument guarded by its own
    ``where``, so a row without keys passes a zero gradient, not NaN, to
    its ``lse`` (``torch.logaddexp(-inf, -inf)`` and ``exp(-inf - -inf)``
    have NaN gradients even in the branch a ``where`` discards)."""
    fa, fi = torch.isfinite(lse_acc), torch.isfinite(lse_i)
    both, any_ = fa & fi, fa | fi
    zero = torch.zeros_like(lse_acc)
    hi = torch.where(any_, torch.maximum(lse_acc, lse_i), zero)
    gap = torch.where(both, torch.minimum(lse_acc, lse_i) - hi, zero)
    lse_new = torch.where(
        any_, hi + torch.where(both, torch.log1p(torch.exp(gap)), zero),
        torch.full_like(lse_acc, float("-inf")))
    ref = torch.where(any_, lse_new, zero)
    w_acc = torch.where(fa, torch.exp(torch.where(fa, lse_acc, zero) - ref),
                        zero)
    w_i = torch.where(fi, torch.exp(torch.where(fi, lse_i, zero) - ref), zero)
    wa = w_acc.transpose(1, 2)[..., None].to(o_acc.dtype)
    wi = w_i.transpose(1, 2)[..., None].to(o_i.dtype)
    return o_acc * wa + o_i * wi, lse_new
