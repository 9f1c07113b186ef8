#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Card: the GPU's name and power limit (nvidia-smi), a sha256 over the
   port's sources and this script (source_fingerprint(), so a run can be
   matched to a commit), and the build of every kernel under
   horovod_tpu_torch/csrc/ with nvcc (all at once), with the libraries
   that _build/ already held before it.
2. Kernel vs plain: the flash-attention forward kernel against its plain
   PyTorch version on the card, at GPT-2 small's serving shape (packed
   [8, 1024, 768] bf16, causal) and on two ragged/offset cases; prints
   max |d out| (<= 1e-2) and max |d lse| (<= 1e-3), the kernel's and the
   plain version's times (CUDA events around runs of 10 back-to-back
   calls, median of 25 runs after warm-up),
   torch's scaled_dot_product_attention on the same inputs as a yardstick
   (timed here only; the port never calls it), and the least time the
   card could take (bytes over 3.35 TB/s, operations over 989 TFLOP/s).
3. Kernel vs plain, flash backward: the dQ and dK/dV kernels (one
   flash_attention_bwd call: dQ first, computing delta, then dK/dV)
   against flash_attention_bwd_reference at GPT-2 small's training shape
   (B=8, S=1024, H=12, D=64, causal; q/k/v column views of one [8, 1024,
   2304] bf16 tensor, out and lse from the kernel forward), at batch 16
   (the fp8 step's), two ragged/offset cases (non-causal with kv_len and
   q_offset; D=128 causal with q_offset > 0), two with an fp32 cotangent
   of out (delta from it as given, the products from it rounded to bf16)
   and three on ragged tile edges (Sq, Skv of 1, 63, 65, 127, 129, 1000
   with kv_len < Skv, D 64 and 128); both cotangents nonzero; max |d dq|,
   |d dk|, |d dv| <= 1e-2 x the plain version's largest gradient (bf16
   outputs, P and dS rounded to bf16 at other points of the sums), and a
   second call equal to the first bit for bit. At batch 8 and 16 the pair
   is timed with CUDA events, each kernel alone by its device time under
   torch.profiler; beside them the plain version and the backward of
   scaled_dot_product_attention(is_causal=True) as the yardstick, by
   events and by device time (every kernel of its call, by name), with
   TFLOP/s by each. The pair's bound counts the five products the gradient
   needs (S, dP, dV, dK, dQ); each kernel's, S, dP and its own products.
4. Kernel vs plain, fused AdamW: flat fp32 buffers of the trainer's bucket
   sizes (GPT-2 small, world 1, default fusion threshold); max |d| of the
   update and both moments <= 1e-6 x the largest value (every operation is
   IEEE-rounded in the plain version's order; powf of the bias corrections
   may differ from torch.pow by an ulp). Timed over all buckets with the
   plain version and torch.optim.AdamW(fused=True) on the same buffers as
   the yardstick (its decay order differs); bound 28 bytes an element.
5. Training: GPT-2 small at full width with fp32 master weights and bf16
   compute, from convert.init_params(seed=0), on a one-rank NCCL world
   (horovod_tpu_torch.init(backend="nccl")), through
   make_train_step(loss, fused_adamw(1e-4), sharded=True,
   fused_update=True), on one batch of 8 x 1024 tokens from a numpy seed
   used every step. From the same start, the gradients and one step of
   the plain path (use_flash=False, fused_update=False) are held against
   the kernel path: all gradients within 5e-2 in relative L2 norm, every
   parameter within 2 lr (1 + wd |p|) + 1e-6 of the plain step's, and at
   most 2% of the elements stepping the other way (Adam's first step
   moves every element by lr (sign g + wd p), so a gradient element within
   bf16 noise of zero can flip). Then 3 warm-up and 20 timed steps: each
   step's loss, the median step ms, tokens/s and MFU (obs/flops.py, H100
   SXM bf16 peak).
   Every loss must be finite and the last below the first; the launch
   counts, set to 0 just before the timed steps, must be 12 forward,
   12 dK/dV, 12 dQ and one AdamW per bucket per step. A torch.profiler
   window over one step gives device time by kernel category and the
   device's idle share.
6. Serving: GPT-2 small at full width from convert.init_params(seed=0),
   saved with the port's save_checkpoint and served by ServePool
   (2 workers, batch 8); 64 requests of 1024 tokens from a numpy seed,
   submitted all at once, in 5 rounds (each round's requests/s and p50/p95
   latency are printed, so the spread is seen within one run).
   The kernel's launch count is set to 0 just before the rounds and must
   equal 12 x batches served. The first 8 answers are recomputed with attention
   forced to the plain version: max |d logits| <= 0.05 max |logits| and
   the same argmax wherever the top-2 margin exceeds that bound. A
   torch.profiler window over 16 more served requests reports device
   time by kernel (flash, matmul, copies, other) and the device's idle
   share of the window's wall time (profiler overhead included). Then a
   step-2 checkpoint is published and the pool must roll onto it one
   worker at a time.
7. [quant] Kernel vs plain, blockwise quantize and dequantize: flat fp32
   buffers of the quantized trainer's bucket sizes (the 4 buckets above,
   padded to 256) and ragged cases (n = 1000 at block 256; blocks 8, 16 and
   65536; a buffer off a 16-byte boundary; an all-zero block and a block
   holding a NaN), int8 and fp8 e4m3. Payloads, scales and dequantized
   values must equal the plain version's bit for bit (every operation is
   IEEE-rounded in the same order), except the int8 value of a NaN element,
   undefined in both (an fp8 NaN may differ in its sign bit). Timed over
   the buckets with time_ms beside the plain versions and, for the int8
   dequantize, torch.mul of the payload rows by the scale column (one
   PyTorch call computing the same function; no single call computes the
   quantize); bound: 5 + 4/256 bytes an element over 3.35 TB/s.
8. [train-quant] The quantized wire on/off pair, the JAX package's
   bench_quant configuration: from the same convert.init_params(seed=0)
   start, make_train_step(loss, adamw(1e-4), compression=...) with
   Compression.none and then Compression.int8 (block 256, error
   feedback), each 3 warm-up and 20 timed steps on the training batch:
   step_ms_off, step_ms_on, tokens/s, and the gradient wire bytes
   (quantized_wire_bytes of the padded buckets against the fp32 and bf16
   gradient bytes). Losses finite and falling; the int8 run's last loss
   within 5% of the none run's. Launch counts, set to 0 just before the
   timed steps: 12 of each flash kernel a step in both, and in the int8 run
   exactly 2 quantize and 2 dequantize per bucket per step (the send and
   the gather; the EF residual's dequantize and the final one; the
   all-to-all sum is plain). One profiled int8 step gives device time by
   category.
9. [train-quant-zero1] make_train_step(loss, fused_adamw(1e-4),
   sharded=True, fused_update=True, compression=Compression.int8): 3
   warm-up and 10 timed steps; per bucket per step 2 quantize, 2
   dequantize (the quantized reduce-scatter and update all-gather) and 1
   fused AdamW; losses fall.
10. [train-quant-fp8] Three replicated steps on the fp8 wire: losses
   finite, 2 quantize and 2 dequantize per bucket per step.
   The serving phase (6.) runs after 11.-13., before 14. and 15.
11. [fp8] Kernel 8 (fp8 wgmma on K-major operands) vs its plain version
   (fp8_matmul_reference): the reference test's ragged cases (5, 300, 70),
   (16, 512, 128), (1, 257, 10) and (130, 129, 260) in the four pairings
   (e4m3 / e5m2 each side), fp32 and bf16 out, each once K-major and once
   with w as a row-major [K, N] tensor, which (like K not a multiple of 16)
   goes through the relayout copy; and every distinct call of a
   GPT-2-small fp8 training step at M = 16 x 1024 rows (forward x @ w.T, dX
   g @ w, dW g.T @ x, for the 768x768, fc and proj weights; bf16 out, dW in
   fp32 too), operands in the K-major layouts the path hands it (0
   relayouts). Largest difference relative to the largest plain value:
   <= 1e-4 (fp32), <= 8e-3 (bf16); the fp32 dW (K = 16,384) is printed as
   the promotion's error, and one k-step ([768, 32] x [32, 768], fp32) as
   the fp8 tensor cores' own rounding of a 32-product sum. Each call timed with time_ms beside the plain
   version and torch._scaled_mm on the same operands (a yardstick the port
   never calls), with its TFLOP/s and its bound: fp8 bytes in and bf16 out
   over 3.35 TB/s, or its operations over 1,979 TFLOP/s, the larger;
   summed over one step's 216 launches. Each call is also timed by its
   device time under torch.profiler, and so is torch._scaled_mm: the
   wrapper's host time exceeds the shorter calls' kernel time, and the
   event times then measure the host.
12. [fp8-cast] The fused cast-transpose-amax kernel vs fp8_cast_reference,
   bit for bit (a NaN payload may differ in its sign bit): at the step's
   shapes (activations and gradients 16,384 x 768 and 16,384 x 3072 bf16,
   e4m3 and e5m2; the weights 768 x 768, 3072 x 768 and 768 x 3072 in
   weight mode with their fp32 residual), on a tensor holding NaN, +-inf
   and values past qmax, with a fresh (all-zero) ring, and on ragged shapes
   with rows off 16-byte boundaries. Each step shape timed (CUDA events and
   device time) beside the plain composition, with its byte bound
   (activation: 2 bytes in, 2 out an element; weight: 6 in, 6 out), summed
   over one step's 216 launches.
13. [train-fp8] The JAX package's bench_fp8 pair at GPT-2 small: "" then
   "fp8", each from convert.init_params(seed=0), make_train_step(loss,
   adamw(1e-3), compute_dtype=...) on one batch of 16 x 1025 tokens from
   numpy.random.RandomState(0), 1 warm-up and 12 timed steps: step_ms_off,
   step_ms_on, speedup, tokens/s, first and last losses, converged (the
   fp8 loss finite, falling, within 0.15 relative of the off run's last),
   the three fp8_state_gauges. Launch counts, set to 0 just before the
   timed steps: 12 of each flash kernel a step, and 216 of kernel 8, 216
   casts and 0 relayouts in the fp8 run (0 of each in the off run). Then
   one Fp8Linear forward and backward at the first layer's fc (its real
   input and trained state) against the same math on fp8_matmul_reference
   (out, dx, dw within 8e-3; the four state gradients bit for bit; 3 casts,
   3 kernel-8 launches, 0 relayouts), and one profiled fp8 step (device
   time by category: elementwise, kernel 8, the cast kernel, the head's
   cuBLAS GEMMs, flash).
14. [int8] Kernel 7 vs its plain version (int8_weight_matmul_reference):
   the reference test's ragged cases (5, 300, 70), (16, 512, 128),
   (1, 64, 10), (130, 1000, 260) and (33, 17, 129) (K not a multiple of 16;
   rows off 16-byte boundaries) with fp32 and bf16 activations, and the four GPT-2-small serving products (768->2304,
   768->768, 768->3072, 3072->768; bf16, weights quantized on the card) at
   M = 8192 (a batch of 8 x 1024) and M = 8 (decode-sized). Largest
   difference relative to the largest plain value: <= 1e-5 (fp32),
   <= 8e-3 (bf16). Each product timed with time_ms beside the plain
   version, torch._weight_int8pack_mm where the build runs it on CUDA (a
   yardstick the port never calls; its scales in bf16), and F.linear of
   the bf16-dequantized weight (cuBLAS, the cost the int8 path replaces:
   "bf16_ms"), each also by its device time under torch.profiler (at
   M = 8 the events time the host's launches), with its bound: bf16 x and
   out, int8 weight and fp32 scales over 3.35 TB/s, or its operations over
   989 TFLOP/s, the larger; summed over one batch's 48 launches.
15. [serve-int8] GPT-2 small through ServePool(weight_dtype="int8") from a
   copy of the serving phase's step-1 fp32 checkpoint (2 workers, batch 8,
   5 rounds of 64 x 1024-token requests): after load every Dense holds an
   int8 payload and fp32 scales and no floating weight, kernel 4 ran 48
   times (one restore), layer 0's fc payload and scales equal the CPU plain
   quantize_weight of the checkpoint's fp32 tensor bit for bit; the model's
   weight bytes beside the bf16 pool's. Launch counts, set to 0 just before
   the rounds: kernel 7 = 48 x batches, flash forward = 12 x batches. The
   first 8 answers against a bf16 model holding the dequantized weights
   (cuBLAS): max |d logits| <= 0.05 max |logits| and the same argmax where
   the top-2 margin exceeds that bound; their relative L2 against the bf16
   pool's answers (the quantization's own error, no bound). One profiled
   window (kernel 7 its own category); then step 2 is published and the
   pool must roll onto it one worker at a time, int8 again (48 kernel-4
   launches a worker), with changed answers.
16. Output: a "kernels" JSON line (the nine TPU kernels' counterparts and
   the cast kernel; "launches" is the training run's count -- for the
   quantize pair the int8 [train-quant] run's, for kernel 8 and the cast
   kernel the fp8 [train-fp8] run's, for kernel 7 the
   [serve-int8] rounds' -- the forward kernel's serving count beside it as
   "launches_serve"), the card's name and power limit, and the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet peaks (at its full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
OUT_TOL, LSE_TOL = 1e-2, 1e-3
GRAD_TOL = 1e-2  # flash backward, relative to the largest plain gradient
ADAM_TOL = 1e-6  # fused AdamW, relative to the largest plain value
ADAM_OPS = 30  # fp32 operations per element of the AdamW update
STEP_GRAD_TOL, FLIP_TOL = 5e-2, 0.02  # kernel vs plain train step
TRAIN_LR, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 1e-4, 8, 3, 20
SERVE_ROUNDS = 5
QUANT_BLOCK = 256  # the default HVDTPU_QUANT_BLOCK
QUANT_OPS = 7  # fp32 operations an element: abs, max, divide, round, clip, cast
QUANT_LOSS_TOL = 0.05  # int8 last loss vs none's, relative
ZERO1_QUANT_STEPS, FP8_QUANT_STEPS = 10, 3
FP8_FLOPS_PER_S = 1979e12  # dense fp8 tensor cores
# Kernel 8 vs its plain version, relative to the largest plain value: exact
# products and fp32 sums in another order; bf16 adds one rounding.
FP8_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
FP8_BATCH, FP8_STEPS, FP8_LR, FP8_LOSS_RTOL = 16, 12, 1e-3, 0.15
# Kernel 7 vs its plain version, relative to the largest plain value: exact
# products, fp32 sums in another order; bf16 adds one rounding.
INT8_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
SERVE_REQUESTS, SERVE_BATCH = 64, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def source_fingerprint() -> str:
    """sha256 over this script and every .py/.cu file of the port (by
    relative path, build outputs left out): the same on any checkout of
    one commit."""
    root = Path(__file__).resolve().parent
    files = [root / "chip_smoke.py"] + sorted(
        f for pat in ("*.py", "*.cu")
        for f in (root / "horovod_tpu_torch").rglob(pat)
        if "_build" not in f.parts and "__pycache__" not in f.parts
    )
    h = hashlib.sha256()
    for f in files:
        h.update(f.relative_to(root).as_posix().encode() + b"\0")
        h.update(f.read_bytes() + b"\0")
    return h.hexdigest()


def time_ms(fn, samples: int = 25, per_sample: int = 10,
            warmup: int = 3) -> float:
    """Median over ``samples`` of the mean time of ``per_sample``
    back-to-back calls between two CUDA events: the launch queue stays
    ahead of the device, so the wrapper's host time is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_sample):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_sample)
    return float(np.median(times))


def valid_pairs(sq, kv_len, causal, q_offset, kv_offset) -> int:
    """(query, key) pairs the mask keeps for one (batch, head)."""
    if not causal:
        return sq * kv_len
    q_pos = q_offset + np.arange(sq)
    return int(np.clip(q_pos - kv_offset + 1, 0, kv_len).sum())


def flash_case(fa, gen, *, b, sq, skv, h, d, causal, q_offset=0,
               kv_offset=0, kv_len=None, timed=False):
    """Kernel vs plain version on one shape; returns the case's record."""
    dev = torch.device("cuda")
    q, k, v = (
        torch.randn((b, s, h * d), generator=gen, device=dev).to(torch.bfloat16)
        for s in (sq, skv, skv)
    )
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              layout="bsm", n_heads=h, kv_len=kv_len)
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err_out = (out.float() - ref_out.float()).abs().max().item()
    inf_k, inf_r = torch.isneginf(lse), torch.isneginf(ref_lse)
    if not torch.equal(inf_k, inf_r):
        raise AssertionError("kernel and plain version disagree on -inf rows")
    fin = ~inf_r
    err_lse = (lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0
    name = (f"B={b} Sq={sq} Skv={skv} H={h} D={d} causal={causal} "
            f"q_offset={q_offset} kv_offset={kv_offset} kv_len={kv_len}")
    log(f"[kernel] {name}: max|d out|={err_out:.3e} max|d lse|={err_lse:.3e}")
    if not (err_out <= OUT_TOL and err_lse <= LSE_TOL):
        raise AssertionError(
            f"flash kernel disagrees with its plain version on {name}: "
            f"out {err_out} (tol {OUT_TOL}), lse {err_lse} (tol {LSE_TOL})"
        )
    rec = {"err_out": err_out, "err_lse": err_lse}
    if timed:
        rec["ms"] = time_ms(lambda: fa.flash_attention_with_lse(q, k, v, **kw))
        rec["plain_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, **kw)
        )
        qh, kh, vh = (x.unflatten(-1, (h, d)).transpose(1, 2) for x in (q, k, v))
        rec["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal
            )
        )
        kvl = skv if kv_len is None else kv_len
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * skv * h * d) + 4 * b * h * sq
        flops = 4 * d * b * h * valid_pairs(sq, kvl, causal, q_offset, kv_offset)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernel] {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP: "
            f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"sdpa {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    return rec


def qkv_views(gen, b, sq, skv, h, d):
    """q, k, v as the model hands them to the kernels: column views of one
    fused projection (of q and a fused key/value one when Sq != Skv)."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if sq == skv:
        return rand(b, sq, 3 * h * d).split(h * d, dim=-1)
    k, v = rand(b, skv, 2 * h * d).split(h * d, dim=-1)
    return rand(b, sq, h * d), k, v


def bwd_case(fa, gen, *, b, sq, skv, h, d, causal, q_offset=0, kv_offset=0,
             kv_len=None, g_dtype=torch.bfloat16, timed=False):
    """The backward kernel pair vs its plain version on one shape, from the
    kernel forward's out and lse and two nonzero cotangents (the cotangent
    of out in ``g_dtype``: an fp32 one is rounded for the products only);
    a second call must give the same gradients bit for bit."""
    q, k, v = qkv_views(gen, b, sq, skv, h, d)
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              layout="bsm", n_heads=h, kv_len=kv_len)
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g_out = torch.randn((b, sq, h * d), generator=gen,
                        device="cuda").to(g_dtype)
    g_lse = torch.randn((b, h, sq), generator=gen, device="cuda")
    args = (q, k, v, out, lse, g_out, g_lse)
    got = fa.flash_attention_bwd(*args, **kw)
    ref = fa.flash_attention_bwd_reference(*args, **kw)
    again = fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    errs, rels = [], []
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"gradient {g.shape} {g.dtype} vs plain "
                                 f"{r.shape} {r.dtype}")
        err = (g.float() - r.float()).abs().max().item()
        scale = max(r.float().abs().max().item(), 1e-6)
        errs.append(err)
        rels.append(err / scale)
    bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
    name = (f"B={b} Sq={sq} Skv={skv} H={h} D={d} causal={causal} "
            f"q_offset={q_offset} kv_offset={kv_offset} kv_len={kv_len} "
            f"g_out {str(g_dtype).replace('torch.', '')}")
    log(f"[bwd] {name}: max|d dq|={errs[0]:.3e} max|d dk|={errs[1]:.3e} "
        f"max|d dv|={errs[2]:.3e}; relative {max(rels):.3e}; "
        f"bitwise again {bitwise}")
    if max(rels) > GRAD_TOL:
        raise AssertionError(
            f"flash backward kernels disagree with their plain version on "
            f"{name}: relative {rels} (tol {GRAD_TOL})"
        )
    if not bitwise:
        raise AssertionError(f"two calls of the backward pair on {name} "
                             f"gave different gradients")
    rec = {"err": max(errs), "rel_err": max(rels), "bitwise": bitwise}
    if timed:
        call = lambda: fa.flash_attention_bwd(*args, **kw)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["kernel_ms"] = kernel_ms(call, 10)
        rec["plain_ms"] = time_ms(
            lambda: fa.flash_attention_bwd_reference(*args, **kw)
        )
        qh, kh, vh = (x.unflatten(-1, (h, d)).transpose(1, 2).contiguous()
                      .requires_grad_(True) for x in (q, k, v))
        oh = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal
        )
        goh = g_out.unflatten(-1, (h, d)).transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(oh, (qh, kh, vh), goh,
                                       retain_graph=True)

        rec["library_ms"] = time_ms(sdpa_bwd)
        # Every kernel the call launches is the backward's (the graph is
        # kept, so no forward runs), summed by name: torch's vendored
        # flash kernels share names with this repository's.
        rec["library_device_ms"] = device_ms(sdpa_bwd)
        kvl = skv if kv_len is None else kv_len
        pairs = valid_pairs(sq, kvl, causal, q_offset, kv_offset)
        n_q, n_kv, n_row = b * sq * h * d, b * skv * h * d, b * h * sq
        product = 2 * d * b * h * pairs  # one QK^T-sized product, causal part
        # Bytes and operations of each function: the pair reads q, out, dO,
        # k, v, lse, g_lse and writes dq, dk, dv (delta is its own, from out
        # and dO) and needs five products (S, dP, dV, dK, dQ); each kernel
        # reads q, k, v, dO, lse, delta, g_lse, writes its gradients and
        # needs S, dP and its own products.
        work = {
            "pair": (2 * (4 * n_q + 4 * n_kv) + 4 * 2 * n_row, 5 * product),
            "flash_bwd_dkdv": (2 * (2 * n_q + 4 * n_kv) + 4 * 3 * n_row,
                               4 * product),
            "flash_bwd_dq": (2 * (3 * n_q + 2 * n_kv) + 4 * 3 * n_row,
                             3 * product),
        }
        for name, (nbytes, flops) in work.items():
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / BF16_FLOPS_PER_S
            rec[name] = {
                "bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
        pair = rec["pair"]
        pair_dev = sum(rec["kernel_ms"][n]
                       for n in ("flash_bwd_dkdv", "flash_bwd_dq"))
        tflops = lambda flops, ms: flops / ms / 1e9  # noqa: E731
        log(f"[bwd] B={b}: {pair['bytes'] / 1e6:.1f} MB, "
            f"{pair['flops'] / 1e9:.2f} GFLOP (5 products): kernel pair "
            f"{rec['ms']:.4f} ms by events ({tflops(pair['flops'], rec['ms']):.1f}"
            f" TFLOP/s), {pair_dev:.4f} ms device "
            f"({tflops(pair['flops'], pair_dev):.1f} TFLOP/s); plain "
            f"{rec['plain_ms']:.4f} ms; sdpa backward {rec['library_ms']:.4f}"
            f" ms by events, {rec['library_device_ms']:.4f} ms device "
            f"(pair / sdpa: {rec['ms'] / rec['library_ms']:.2f}x by events, "
            f"{pair_dev / rec['library_device_ms']:.2f}x device); bound "
            f"{pair['bound_ms']:.4f} ms ({pair['bound_by']})")
        for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
            ms = rec["kernel_ms"][name]
            log(f"[bwd] B={b} {name}: {ms:.4f} ms a launch (device), "
                f"{tflops(rec[name]['flops'], ms):.1f} TFLOP/s "
                f"({rec[name]['flops'] // product} products), bound "
                f"{rec[name]['bound_ms']:.4f} ms ({rec[name]['bound_by']})")
    return rec


def trainer_bucket_sizes(hvt, cfg):
    """Elements per fused bucket of the trainer's parameter dict (world 1,
    default fusion threshold), from shapes alone (a meta-device model)."""
    from horovod_tpu_torch.ops.fusion import bucket_byte_layout

    params = dict(hvt.GPT2LMModel(cfg, device="meta").named_parameters())
    return [nbytes // 4 for dt, nbytes in bucket_byte_layout(params)
            if dt == "float32"]


def adamw_case(fadam, gen, sizes):
    """The fused AdamW kernel vs its plain version on every bucket."""
    spec = fadam.FusedAdamSpec(TRAIN_LR)
    count = torch.tensor(3, dtype=torch.int32, device="cuda")

    def rand(n, s):
        return torch.randn((n,), generator=gen, device="cuda") * s

    bufs = [(rand(n, 1.0), rand(n, 0.01), rand(n, 0.03).abs() ** 2,
             rand(n, 0.1)) for n in sizes]
    err, rel, bitwise = 0.0, 0.0, True
    for p, m, v, g in bufs:
        mk, vk = m.clone(), v.clone()
        u = fadam.fused_adamw_update(p, mk, vk, g, count, spec)
        ref = fadam.fused_adamw_update_reference(p, m, v, g, count, spec)
        for a, r in zip((u, mk, vk), ref):
            d = (a - r).abs().max().item()
            err = max(err, d)
            rel = max(rel, d / max(r.abs().max().item(), 1e-30))
            bitwise = bitwise and torch.equal(a, r)
    n = sum(sizes)
    log(f"[adamw] buckets {sizes} ({n} elements): max|d| {err:.3e}, "
        f"relative {rel:.3e}, bit for bit {bitwise}")
    if rel > ADAM_TOL:
        raise AssertionError(
            f"fused AdamW kernel disagrees with its plain version: {rel} "
            f"(tol {ADAM_TOL})"
        )
    rec = {"err": err, "rel_err": rel, "bitwise": bitwise,
           "buckets": list(sizes)}
    rec["ms"] = time_ms(lambda: [
        fadam.fused_adamw_update(p, m, v, g, count, spec)
        for p, m, v, g in bufs
    ])
    rec["plain_ms"] = time_ms(lambda: [
        fadam.fused_adamw_update_reference(p, m, v, g, count, spec)
        for p, m, v, g in bufs
    ], samples=9, per_sample=3)
    for p, _, _, g in bufs:
        p.grad = g
    lib = torch.optim.AdamW([p for p, _, _, _ in bufs], lr=spec.learning_rate,
                            betas=(spec.b1, spec.b2), eps=spec.eps,
                            weight_decay=spec.weight_decay, fused=True)
    rec["library_ms"] = time_ms(lib.step)
    nbytes, flops = 28 * n, ADAM_OPS * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[adamw] {nbytes / 1e9:.3f} GB: kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, torch.optim.AdamW(fused=True) "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']})")
    return rec


def quant_bucket_sizes(hvt, cfg):
    """Elements per bucket of the quantized trainer (world 1, default
    fusion threshold, padded to the block), from shapes alone."""
    from horovod_tpu_torch.ops.fusion import quantized_bucket_layout

    params = dict(hvt.GPT2LMModel(cfg, device="meta").named_parameters())
    comp = hvt.Compression.int8.with_block(QUANT_BLOCK)
    return [b["elements"] for b in quantized_bucket_layout(
        params, world=1, compression=comp)]


def quant_compare(tq, x, block, spec):
    """The quantize and dequantize kernels vs their plain versions on one
    buffer: bit for bit, NaN elements aside (see the docstring). Returns
    the largest difference seen (0.0 when bit for bit)."""
    q, s = tq.quantize_blockwise(x, block, spec)
    rq, rs = tq.quantize_blockwise_reference(x, block, spec)
    d = tq.dequantize_blockwise(q, s, block)
    rd = tq.dequantize_blockwise_reference(q, s, block)
    torch.cuda.synchronize()
    qb, rqb = q.view(torch.uint8), rq.view(torch.uint8)
    keep = ~torch.isnan(x)
    if not spec.integer:
        keep = torch.ones_like(keep)
        keep &= ~(((qb & 0x7F) == 0x7F) & ((rqb & 0x7F) == 0x7F))
    fin = ~torch.isnan(rd)
    same = (q.shape == rq.shape and q.dtype == rq.dtype
            and torch.equal(s.view(torch.int32), rs.view(torch.int32))
            and torch.equal(qb[keep], rqb[keep])
            and torch.equal(torch.isnan(d), ~fin)
            and torch.equal(d[fin].view(torch.int32), rd[fin].view(torch.int32)))
    err_q = (q.float()[keep] - rq.float()[keep]).abs().max().item() if (
        keep.any()) else 0.0
    err = max(err_q, (s - rs).abs().max().item(),
              (d[fin] - rd[fin]).abs().max().item() if fin.any() else 0.0)
    if not same:
        raise AssertionError(
            f"quantize/dequantize kernels differ from their plain versions "
            f"({spec.name}, n={x.numel()}, block={block}): max |d| {err}"
        )
    return err


def quant_case(tq, gen, sizes):
    """Kernels 4 and 5 vs their plain versions at the trainer's buckets and
    on the ragged cases, then timed at the buckets."""
    def rand(n, offset=0):
        return (torch.randn((n + offset,), generator=gen, device="cuda")
                * 1e-3)[offset:]

    bufs = [rand(n) for n in sizes]
    special = rand(1_000_000)
    special[QUANT_BLOCK:2 * QUANT_BLOCK] = 0.0  # an all-zero block
    special[3 * QUANT_BLOCK + 17] = float("nan")  # a block holding a NaN
    ragged = [("n=1000", rand(1000), QUANT_BLOCK),
              ("block=8", rand(1_000_003), 8),
              ("block=16", rand(1_000_003), 16),
              ("block=65536", rand(1_000_003), 65536),
              ("unaligned", rand(1_000_001, offset=1), QUANT_BLOCK),
              ("zero+NaN blocks", special, QUANT_BLOCK)]
    err = 0.0
    for spec in (tq.INT8, tq.FP8):
        for b in bufs:
            err = max(err, quant_compare(tq, b, QUANT_BLOCK, spec))
        for name, x, block in ragged:
            err = max(err, quant_compare(tq, x, block, spec))
        _, s = tq.quantize_blockwise(special, QUANT_BLOCK, spec)
        if s[1].item() != 1.0 or s[3].item() != 1.0:
            raise AssertionError("an all-zero or NaN block's scale is not 1")
    n = sum(sizes)
    log(f"[quant] buckets {sizes} ({n} elements) and {len(ragged)} ragged "
        f"cases, int8 and fp8: kernels equal their plain versions bit for "
        f"bit (max |d| {err})")
    rec = {"buckets": list(sizes), "max_abs_err": err, "bitwise": True}
    for spec in (tq.INT8, tq.FP8):
        wires = [tq.quantize_blockwise(b, QUANT_BLOCK, spec) for b in bufs]
        key = "" if spec.integer else "_fp8"
        rec["quant_ms" + key] = time_ms(lambda: [
            tq.quantize_blockwise(b, QUANT_BLOCK, spec) for b in bufs])
        rec["dequant_ms" + key] = time_ms(lambda: [
            tq.dequantize_blockwise(q, sc, QUANT_BLOCK) for q, sc in wires])
        rec["quant_plain_ms" + key] = time_ms(lambda: [
            tq.quantize_blockwise_reference(b, QUANT_BLOCK, spec)
            for b in bufs], samples=9, per_sample=3)
        rec["dequant_plain_ms" + key] = time_ms(lambda: [
            tq.dequantize_blockwise_reference(q, sc, QUANT_BLOCK)
            for q, sc in wires], samples=9, per_sample=3)
        if spec.integer:
            # int8 x fp32 promotes to fp32 in one call: the same function.
            rows = [(q.view(-1, QUANT_BLOCK), sc[:, None]) for q, sc in wires]
            rec["dequant_library_ms"] = time_ms(lambda: [
                torch.mul(q, sc) for q, sc in rows])
        del wires
    n_blocks = sum(-(-m // QUANT_BLOCK) for m in sizes)
    nbytes = 5 * n + 4 * n_blocks  # fp32 in, one-byte payload + scales out
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = QUANT_OPS * n / FP32_FLOPS_PER_S
    rec["bytes"] = nbytes
    rec["bound_ms"] = max(t_bytes, t_ops) * 1e3  # the same for both passes
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[quant] {nbytes / 1e6:.1f} MB a pass: int8 quantize "
        f"{rec['quant_ms']:.4f} ms (plain {rec['quant_plain_ms']:.4f}), "
        f"dequantize {rec['dequant_ms']:.4f} ms (plain "
        f"{rec['dequant_plain_ms']:.4f}, torch.mul "
        f"{rec['dequant_library_ms']:.4f}); fp8 quantize "
        f"{rec['quant_ms_fp8']:.4f} ms, dequantize {rec['dequant_ms_fp8']:.4f} "
        f"ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    del bufs, special, ragged
    torch.cuda.empty_cache()
    return rec


def plain_attention(fa):
    def attn(q, k, v, *, causal, mask=None):
        return fa.flash_attention_reference(q, k, v, causal=causal)[0]

    return attn


def kernel_category(name: str) -> str:
    n = name.lower()
    # dequantize_blockwise before quantize_blockwise: the one name holds
    # the other.
    for kernel in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                   "fused_adamw", "dequantize_blockwise",
                   "quantize_blockwise", "fp8_matmul_reduce", "fp8_matmul",
                   "fp8_cast", "int8_matmul"):
        if kernel + "_kernel" in n:
            return kernel
    if "nccl" in n:
        return "nccl"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def device_ms_by_name(prof):
    """Device ms by kernel name, and by kernel category, from a finished
    torch.profiler window."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    by_cat = {}
    for name, ms in by_name.items():
        c = kernel_category(name)
        by_cat[c] = by_cat.get(c, 0.0) + ms
    return by_name, by_cat


def kernel_ms(fn, calls):
    """Device ms a call of each of this repository's kernels that ``fn``
    launches, from torch.profiler over ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    _, by_cat = device_ms_by_name(prof)
    return {c: ms / calls for c, ms in by_cat.items()
            if c.startswith(("flash", "fused", "quantize", "dequantize",
                             "fp8", "int8"))}


def device_ms(fn, calls=20, tries=3):
    """Device ms a call of ``fn``, which launches each of its kernels once a
    call, from torch.profiler over ``calls`` calls after a warm-up: for
    calls too short for time_ms, whose back-to-back events then time the
    host's launches. Each kernel's time is its mean over the launches the
    window recorded (the first launches of a window can go unrecorded). A
    window that recorded no device time at all is taken again, and after
    ``tries`` such windows the measurement fails: a launched kernel takes
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                total += us / 1e3 / e.count
        if total > 0:
            return total
    raise AssertionError(f"torch.profiler recorded no device time in {tries} "
                         f"windows of {calls} calls")


def host_calls(prof):
    """CUDA runtime calls of a finished torch.profiler window: ``{name:
    [count, host ms]}``, and the host's busiest ops by self time. A
    synchronizing call (cudaStreamSynchronize, cudaFree, a device-to-host
    copy) makes the host wait for the device, which exposes every launch
    after it."""
    from torch.autograd import DeviceType

    api, ops = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue
        ms = e.self_cpu_time_total / 1e3
        if e.key.startswith("cuda"):
            api[e.key] = [e.count, ms]
        else:
            ops.append((e.key, e.count, ms))
    ops.sort(key=lambda t: -t[2])
    return api, [[k[:60], c, ms] for k, c, ms in ops[:8]]


def device_breakdown(prof, wall_ms, extra):
    """Device time by kernel from a finished torch.profiler window."""
    by_name, by_cat = device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    api, host_top = host_calls(prof)
    rec = dict(extra, wall_ms=wall_ms, device_ms=device_ms,
               idle_share=1.0 - device_ms / wall_ms if wall_ms else None,
               by_category_ms=by_cat,
               top_kernels_ms=[[n[:80], ms] for n, ms in top],
               cuda_api=api, host_top_self_ms=host_top)
    log(f"[profile] {json.dumps(rec)}")
    return rec


def profile_window(fn, extra):
    """Run ``fn`` under torch.profiler; device time by kernel category and
    the idle share of the window's wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_breakdown(prof, wall_ms, extra)


def profile_serving(pool, tokens):
    """Device time by kernel over a window of served requests."""
    def run():
        futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
        for f in futs:
            f.result(timeout=600.0)

    return profile_window(run, {"requests": len(tokens)})


def train_loss(model):
    """Next-token cross entropy on the fp32 logits, through the parameter
    dict the step hands in."""
    import torch.nn.functional as F

    def loss_fn(params, tokens):
        logits = torch.func.functional_call(model, params, (tokens[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())

    return loss_fn


def train(hvt, fa, fadam, cfg, sizes):
    """GPT-2 small through make_train_step(sharded=True, fused_update=True)
    on a one-rank NCCL world, held against the plain path, then timed."""
    from horovod_tpu_torch.obs import flops
    from horovod_tpu_torch.parallel import dp

    hvt.init(backend="nccl")
    seq = cfg.max_len
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, seq + 1), dtype=np.int64
    )).cuda()
    n_matmul = sum(v.numel() for k, v in sd0.items()
                   if not k.startswith(("transformer.wte", "transformer.wpe")))
    tokens_per_step = TRAIN_BATCH * seq
    flops_per_step = tokens_per_step * flops.transformer_flops_per_token(
        n_matmul, cfg.n_layers, seq, cfg.d_model
    )

    def build(use_flash, fused):
        model = hvt.GPT2LMModel(dataclasses.replace(cfg, use_flash=use_flash))
        model.load_state_dict(sd0)
        step, opt = hvt.make_train_step(
            train_loss(model), hvt.fused_adamw(TRAIN_LR), sharded=True,
            fused_update=fused, tokens_per_step=tokens_per_step,
            flops_per_step=flops_per_step,
        )
        return model, step, dp.init_state(model, opt)

    model_k, step_k, state_k = build(None, True)
    model_p, step_p, state_p = build(False, False)
    got = [b.numel() for b in state_k.opt_state.inner.mu.buffers]
    if got != list(sizes):
        raise AssertionError(f"trainer buckets {got} != predicted {sizes}")

    # Gradients at the start: kernel path vs plain attention.
    _, _, g_k = dp.accumulate_gradients(train_loss(model_k), state_k.params,
                                        tokens, 1)
    _, _, g_p = dp.accumulate_gradients(train_loss(model_p), state_p.params,
                                        tokens, 1)
    num = sum(float((g_k[n] - g_p[n]).float().norm()) ** 2 for n in g_p)
    den = sum(float(g_p[n].float().norm()) ** 2 for n in g_p)
    grad_rel = (num / den) ** 0.5
    del g_k, g_p
    log(f"[train] gradients, kernel vs plain path: relative L2 {grad_rel:.3e} "
        f"(tol {STEP_GRAD_TOL})")
    if not grad_rel <= STEP_GRAD_TOL:
        raise AssertionError("kernel-path gradients disagree with the plain path")

    # One step each from the same start.
    p0 = {n: p.detach().clone() for n, p in state_k.params.items()}
    state_k, loss_k = step_k(state_k, tokens)
    state_p, loss_p = step_p(state_p, tokens)
    wd = hvt.fused_adamw(TRAIN_LR).fused_spec.weight_decay
    excess, flipped, total = -1.0, 0, 0
    with torch.no_grad():
        for n, p in p0.items():
            d = (state_k.params[n] - state_p.params[n]).abs()
            bound = 2 * TRAIN_LR * (1 + wd * p.abs()) + 1e-6
            excess = max(excess, float((d - bound).max()))
            flipped += int((d > TRAIN_LR).sum())
            total += d.numel()
    flip_share = flipped / total
    log(f"[train] one step, kernel vs plain path: loss {float(loss_k):.6f} vs "
        f"{float(loss_p):.6f}; largest excess over 2 lr (1 + wd |p|) + 1e-6: "
        f"{excess:.3e}; elements stepping the other way {flipped}/{total} "
        f"({flip_share:.3e}, tol {FLIP_TOL})")
    if excess > 0 or flip_share > FLIP_TOL:
        raise AssertionError("the kernel step's parameters disagree with the "
                             "plain step's")
    del model_p, step_p, state_p, p0
    torch.cuda.empty_cache()

    losses = [float(loss_k)]
    for _ in range(TRAIN_WARMUP - 1):
        state_k, loss = step_k(state_k, tokens)
        losses.append(float(loss))
    fa.reset_launches()
    fadam.reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_k, loss = step_k(state_k, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {"flash_fwd": fa.launches, "flash_bwd_dkdv": fa.launches_dkdv,
              "flash_bwd_dq": fa.launches_dq, "fused_adamw": fadam.launches}
    log(f"[train] losses {losses}")
    log(f"[train] launches over {TRAIN_STEPS} steps: {counts}")
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers, "fused_adamw": len(sizes)}
    for name, per_step in want.items():
        if counts[name] != per_step * TRAIN_STEPS:
            raise AssertionError(
                f"{name} launched {counts[name]} times in {TRAIN_STEPS} "
                f"steps, not {per_step} a step"
            )
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not reduce the loss: {losses}")
    if int(state_k.step) != TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError(f"state.step is {int(state_k.step)}")
    step_ms = float(np.median(times)) * 1e3
    tp = step_k.throughput(step_ms / 1e3)
    log(f"[train] step median {step_ms:.3f} ms (min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}); {tp['tokens_per_s']:.1f} tokens/s; "
        f"MFU {tp['mfu']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def one_step():
        nonlocal state_k
        state_k, _ = step_k(state_k, tokens)

    prof = profile_window(one_step, {"steps": 1})
    hvt.shutdown()
    del model_k, step_k, state_k
    torch.cuda.empty_cache()
    return {"launches": counts, "losses": losses, "step_ms": step_ms,
            "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": tp["tokens_per_s"], "mfu": tp["mfu"],
            "grad_rel_l2": grad_rel, "flip_share": flip_share,
            "param_excess": excess, "profile": prof}


def reset_counts(fa, fadam, tq):
    fa.reset_launches()
    fadam.reset_launches()
    tq.reset_launches()


def read_counts(fa, fadam, tq):
    return {"flash_fwd": fa.launches, "flash_bwd_dkdv": fa.launches_dkdv,
            "flash_bwd_dq": fa.launches_dq, "fused_adamw": fadam.launches,
            "quantize_blockwise": tq.launches_quant,
            "dequantize_blockwise": tq.launches_dequant,
            "fp8_matmul": tq.launches_fp8_matmul,
            "fp8_cast": tq.launches_fp8_cast,
            "fp8_relayout": tq.launches_fp8_relayout,
            "int8_matmul": tq.launches_int8_matmul}


def quant_train_run(hvt, kernels, cfg, sd0, tokens, compression, *, label,
                    sharded=False, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS,
                    n_buckets, bracket=None, profile=False):
    """One training run from ``sd0``: ``warmup`` steps, then ``steps``
    timed steps with every launch count set to 0 just before and read just
    after; checks the counts a step against the path's kernels."""
    from horovod_tpu_torch.optimizer import ef_residual_norm
    from horovod_tpu_torch.parallel import dp

    fa, fadam, tq = kernels
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(sd0)
    if sharded:
        opt, kw = hvt.fused_adamw(TRAIN_LR), dict(sharded=True,
                                                   fused_update=True)
    else:
        opt, kw = hvt.adamw(TRAIN_LR), {}
    step, wopt = hvt.make_train_step(train_loss(model), opt,
                                     compression=compression, **kw,
                                     **(bracket or {}))
    state = dp.init_state(model, wopt)
    losses = []
    for _ in range(warmup):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    reset_counts(fa, fadam, tq)
    times, enqueue = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        enqueue.append(time.perf_counter() - t0)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = read_counts(fa, fadam, tq)
    quantized = getattr(compression, "is_quantized", False)
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers,
            "fused_adamw": n_buckets if sharded else 0,
            "quantize_blockwise": 2 * n_buckets if quantized else 0,
            "dequantize_blockwise": 2 * n_buckets if quantized else 0,
            "fp8_matmul": 0}
    log(f"[{label}] losses {losses}")
    log(f"[{label}] launches over {steps} steps: {counts}")
    for name, per_step in want.items():
        if counts[name] != per_step * steps:
            raise AssertionError(
                f"[{label}] {name} launched {counts[name]} times in {steps} "
                f"steps, not {per_step} a step"
            )
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{label}] the loss did not fall: {losses}")
    step_ms = float(np.median(times)) * 1e3
    # Host time until the step function returns, before the loss is read:
    # near the step time when the host is what holds the device back.
    enqueue_ms = float(np.median(enqueue)) * 1e3
    rec = {"losses": losses, "launches": counts, "step_ms": step_ms,
           "step_ms_all": [t * 1e3 for t in times], "enqueue_ms": enqueue_ms}
    if bracket:
        rec.update(step.throughput(step_ms / 1e3))
    res = getattr(state.opt_state, "residual", None)
    if quantized and res is not None:
        rec["residual_norm"] = ef_residual_norm(state)
        if not rec["residual_norm"] > 0:
            raise AssertionError(f"[{label}] the EF residuals stayed zero")
    log(f"[{label}] step median {step_ms:.3f} ms (min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}), host enqueue {enqueue_ms:.3f} ms; "
        f"tokens/s {rec.get('tokens_per_s')}; "
        f"residual norm {rec.get('residual_norm')}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        def one_step():
            nonlocal state
            state, _ = step(state, tokens)

        rec["profile"] = profile_window(one_step, {"steps": 1, "run": label})
    del model, step, wopt, state
    torch.cuda.empty_cache()
    return rec


def train_quant(hvt, kernels, cfg, sizes, qsizes):
    """[train-quant], [train-quant-zero1] and [train-quant-fp8]."""
    from horovod_tpu_torch.obs import flops
    from horovod_tpu_torch.ops import quantization as tq

    hvt.init(backend="nccl")
    seq = cfg.max_len
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, seq + 1), dtype=np.int64
    )).cuda()
    n_matmul = sum(v.numel() for k, v in sd0.items()
                   if not k.startswith(("transformer.wte", "transformer.wpe")))
    bracket = {"tokens_per_step": TRAIN_BATCH * seq,
               "flops_per_step": TRAIN_BATCH * seq
               * flops.transformer_flops_per_token(n_matmul, cfg.n_layers,
                                                   seq, cfg.d_model)}
    int8 = hvt.Compression.int8.with_block(QUANT_BLOCK)
    run = dict(n_buckets=len(qsizes))
    off = quant_train_run(hvt, kernels, cfg, sd0, tokens, hvt.Compression.none,
                          label="train-quant off", bracket=bracket,
                          profile=True, **run)
    on = quant_train_run(hvt, kernels, cfg, sd0, tokens, int8,
                         label="train-quant on", bracket=bracket,
                         profile=True, **run)
    rel = abs(on["losses"][-1] - off["losses"][-1]) / abs(off["losses"][-1])
    n = sum(sizes)
    wire = {"gradient_wire_bytes_fp32": 4 * n,
            "gradient_wire_bytes_bf16": 2 * n,
            "gradient_wire_bytes_int8": sum(
                tq.quantized_wire_bytes(m, QUANT_BLOCK, tq.INT8)
                for m in qsizes)}
    wire["ratio_vs_fp32"] = wire["gradient_wire_bytes_int8"] / (4 * n)
    wire["ratio_vs_bf16"] = wire["gradient_wire_bytes_int8"] / (2 * n)
    pair = dict(wire, step_ms_off=off["step_ms"], step_ms_on=on["step_ms"],
                tokens_per_s_off=off["tokens_per_s"],
                tokens_per_s_on=on["tokens_per_s"],
                speedup=off["step_ms"] / on["step_ms"],
                last_loss_off=off["losses"][-1], last_loss_on=on["losses"][-1],
                last_loss_rel=rel, block=QUANT_BLOCK)
    log(f"[train-quant] {json.dumps(pair)}")
    if not rel < QUANT_LOSS_TOL:
        raise AssertionError(
            f"the int8 run's last loss is {rel:.3%} from the none run's "
            f"(tol {QUANT_LOSS_TOL:.0%})"
        )
    zero1 = quant_train_run(hvt, kernels, cfg, sd0, tokens, int8,
                            label="train-quant-zero1", sharded=True,
                            steps=ZERO1_QUANT_STEPS, **run)
    fp8 = quant_train_run(hvt, kernels, cfg, sd0, tokens,
                          hvt.Compression.fp8.with_block(QUANT_BLOCK),
                          label="train-quant-fp8", warmup=1,
                          steps=FP8_QUANT_STEPS, **run)
    hvt.shutdown()
    return {"pair": pair, "off": off, "on": on, "zero1": zero1, "fp8": fp8}


def fp8_step_shapes(cfg):
    """Kernel 8's distinct calls in one GPT-2 training step at FP8_BATCH x
    max_len tokens: ``(name, launches a step, kind, weight [N, K])``; kind
    fwd is x @ w.T, dx is g @ w, dw is g.T @ x."""
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    shapes = []
    for kind in ("fwd", "dx", "dw"):
        shapes += [(f"{kind} q/k/v/out", 4 * layers, kind, (d, d)),
                   (f"{kind} fc", layers, kind, (f, d)),
                   (f"{kind} proj", layers, kind, (d, f))]
    return shapes


def fp8_operands(gen, m, kind, w_shape):
    """The fp8 operands of one call as the path hands them, K-major: the
    casts write x [M, K], w [N, K] and g [M, N] row-major and transposed
    (x^T [K, M] and w^T [K, N] in e4m3, g^T [N, M] in e5m2). Returns (a, b)
    with out = a @ b, b the transposed view of a row-major payload."""
    n_w, k_w = w_shape

    def rand(rows, cols, dtype, s=4.0):
        return (torch.randn((rows, cols), generator=gen, device="cuda")
                * s).to(dtype)

    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    if kind == "fwd":  # x @ (w [N, K])^T
        return rand(m, k_w, e4), rand(n_w, k_w, e4).t()
    if kind == "dx":  # g @ w = g @ (w^T [K, N])^T
        return rand(m, n_w, e5), rand(k_w, n_w, e4).t()
    return rand(n_w, m, e5), rand(k_w, m, e4).t()  # g^T @ (x^T)^T


def fp8_compare(tq, a, b, out_dtype, scale):
    """Kernel 8 vs its plain version on one call: (max |d|, relative to
    the largest plain value)."""
    got = tq.fp8_matmul(a, b, scale, out_dtype=out_dtype)
    ref = tq.fp8_matmul_reference(a, b, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"fp8_matmul {got.shape} {got.dtype} vs plain "
                             f"{ref.shape} {ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not rel <= FP8_TOL[out_dtype]:
        raise AssertionError(
            f"fp8 matmul kernel disagrees with its plain version on "
            f"{tuple(a.shape)} x {tuple(b.shape)} {a.dtype} x {b.dtype} -> "
            f"{out_dtype}: {rel} (tol {FP8_TOL[out_dtype]})")
    return err, rel


def scaled_mm_ms(a, b, scale, out_dtype):
    """torch._scaled_mm on the same operands as the yardstick (the port
    never calls it): it takes a row-major and b column-major, so other
    layouts get copies made here, outside the timing. None where it
    refuses the case."""
    a_l = a if a.is_contiguous() else a.contiguous()
    b_l = b if b.t().is_contiguous() else b.t().contiguous().t()
    one = torch.ones((), device="cuda")

    def call():
        return torch._scaled_mm(a_l, b_l, scale_a=scale, scale_b=one,
                                out_dtype=out_dtype)

    try:
        call()
    except (RuntimeError, TypeError) as exc:
        log(f"[fp8] torch._scaled_mm refuses {a.dtype} x {b.dtype}: {exc}")
        return None
    return time_ms(call)


def fp8_case(tq, gen, cfg):
    """[fp8]: kernel 8 vs its plain version at the main path's calls (M =
    FP8_BATCH x max_len, K-major, no relayout) and on the reference test's
    ragged cases (K-major and through the relayout), then the main path's
    calls timed beside the plain version and torch._scaled_mm, each with
    its bound."""
    scale = torch.tensor(0.37, device="cuda")
    m = FP8_BATCH * cfg.max_len
    err = rel = 0.0
    rng = np.random.RandomState(11)
    f8 = (torch.float8_e4m3fn, torch.float8_e5m2)
    tq.reset_launches()
    ragged = 0
    for fx in f8:
        for fw in f8:
            for mm, kk, nn in ((5, 300, 70), (16, 512, 128), (1, 257, 10),
                               (130, 129, 260)):
                a = torch.from_numpy(rng.randn(mm, kk).astype(np.float32))
                b = torch.from_numpy(rng.randn(kk, nn).astype(np.float32))
                a = a.cuda().to(fx)
                b_rows = b.cuda().to(fw)  # [K, N] row-major: relayout
                b_kmaj = b_rows.t().contiguous().t()  # K-major
                for bb in (b_kmaj, b_rows):
                    for out_dtype in (torch.float32, torch.bfloat16):
                        e, r = fp8_compare(tq, a, bb, out_dtype, scale)
                        err, rel = max(err, e), max(rel, r)
                        ragged += 1
    relayouts = tq.launches_fp8_relayout
    log(f"[fp8] ragged cases, 4 pairings, K-major and row-major w, fp32 and "
        f"bf16 ({ragged} calls, {relayouts} relayouts): max |d| {err:.3e}, "
        f"relative {rel:.3e}")
    if relayouts == 0:
        raise AssertionError("the ragged cases never took the relayout")
    # One k-step (K = 32, one wgmma, nothing promoted): the tensor cores'
    # own rounding of a 32-product sum, relative to the largest output.
    a1, b1 = fp8_operands(gen, 768, "fwd", (768, 32))
    got = tq.fp8_matmul(a1, b1, scale)
    ref = tq.fp8_matmul_reference(a1, b1, scale)
    torch.cuda.synchronize()
    d = (got - ref).float()
    one_step = {"max_rel": (d.abs().max() / ref.abs().max()).item(),
                "rms_rel": (d.square().mean().sqrt()
                            / ref.square().mean().sqrt()).item()}
    log(f"[fp8] one k-step's rounding by the fp8 tensor cores ([768, 32] x "
        f"[32, 768], fp32 out): max {one_step['max_rel']:.3e}, rms "
        f"{one_step['rms_rel']:.3e} of the plain version's largest / rms")
    cases, step = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "t_bytes": 0.0, "t_ops": 0.0, "bound_ms": 0.0,
                       "flops": 0.0, "launches": 0}
    promotion = None
    for name, count, kind, w_shape in fp8_step_shapes(cfg):
        a, b = fp8_operands(gen, m, kind, w_shape)
        out_dtypes = ((torch.bfloat16, torch.float32) if kind == "dw"
                      else (torch.bfloat16,))
        r_case = {}
        tq.reset_launches()
        for out_dtype in out_dtypes:
            e, r = fp8_compare(tq, a, b, out_dtype, scale)
            err, rel = max(err, e), max(rel, r)
            r_case[str(out_dtype).replace("torch.", "")] = r
        if tq.launches_fp8_relayout:
            raise AssertionError(f"[fp8] {name}: the main path's layout took "
                                 f"{tq.launches_fp8_relayout} relayouts")
        mm, kk = a.shape
        nn = b.shape[1]
        if kind == "dw" and (promotion is None or r_case["float32"] > promotion):
            promotion = r_case["float32"]
        rec = {"name": name, "launches_per_step": count, "m": mm, "k": kk,
               "n": nn, "a": str(a.dtype), "b": str(b.dtype),
               "a_stride": list(a.stride()), "b_stride": list(b.stride()),
               "rel_err": r_case}
        rec["ms"] = time_ms(lambda: tq.fp8_matmul(a, b, scale,
                                                  out_dtype=torch.bfloat16))
        rec["device_ms"] = device_ms(lambda: tq.fp8_matmul(
            a, b, scale, out_dtype=torch.bfloat16))
        rec["plain_ms"] = time_ms(
            lambda: tq.fp8_matmul_reference(a, b, scale,
                                            out_dtype=torch.bfloat16),
            samples=5, per_sample=3)
        rec["library_ms"] = scaled_mm_ms(a, b, scale, torch.bfloat16)
        one = torch.ones((), device="cuda")
        rec["library_device_ms"] = (device_ms(lambda: torch._scaled_mm(
            a, b, scale_a=scale, scale_b=one, out_dtype=torch.bfloat16))
            if rec["library_ms"] else None)
        nbytes = mm * kk + kk * nn + 2 * mm * nn  # fp8 in, bf16 out
        flops = 2 * mm * nn * kk
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP8_FLOPS_PER_S
        rec.update(bytes=nbytes, flops=flops,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["library_tflops"] = (flops / rec["library_ms"] / 1e9
                                 if rec["library_ms"] else None)
        log(f"[fp8] {name}: [{mm}, {kk}] x [{kk}, {nn}] {a.dtype} x {b.dtype}"
            f" (strides {tuple(a.stride())}, {tuple(b.stride())}): kernel "
            f"{rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s; device "
            f"{rec['device_ms']:.4f}), plain {rec['plain_ms']:.4f} ms, "
            f"torch._scaled_mm {rec['library_ms']} ms ({rec['library_tflops']}"
            f" TFLOP/s; device {rec['library_device_ms']}), bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); relative error "
            f"{r_case}")
        cases.append(rec)
        for key in ("ms", "device_ms", "plain_ms", "bound_ms"):
            step[key] = step.get(key, 0.0) + count * rec[key]
        for key in ("library_ms", "library_device_ms"):
            step[key] = (None if step.get(key, 0.0) is None
                         or rec[key] is None
                         else step.get(key, 0.0) + count * rec[key])
        step["t_bytes"] += count * t_bytes * 1e3
        step["t_ops"] += count * t_ops * 1e3
        step["flops"] += count * flops
        step["launches"] += count
        del a, b
    step["bound_by"] = ("bytes" if step["t_bytes"] >= step["t_ops"]
                        else "operations")
    step["tflops"] = step["flops"] / step["ms"] / 1e9
    log(f"[fp8] one step's {step['launches']} launches: kernel "
        f"{step['ms']:.3f} ms ({step['tflops']:.1f} TFLOP/s; device "
        f"{step['device_ms']:.3f} ms), plain "
        f"{step['plain_ms']:.3f} ms, torch._scaled_mm {step['library_ms']} "
        f"ms (device {step['library_device_ms']} ms), bound "
        f"{step['bound_ms']:.3f} ms ({step['bound_by']}); max |d| "
        f"{err:.3e}, relative {rel:.3e}; promotion's error at K = {m}: "
        f"{promotion:.3e} (fp32 out, tol {FP8_TOL[torch.float32]})")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "max_rel_err": rel, "step": step,
            "promotion_rel_err": promotion, "one_k_step_rel_err": one_step,
            "ragged_relayouts": relayouts, "cases": cases}


def fp8_cast_shapes(cfg):
    """The cast kernel's distinct calls in one GPT-2 training step at
    FP8_BATCH x max_len tokens: ``(name, launches a step, rows, cols, wire,
    weight mode)``."""
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    m = FP8_BATCH * cfg.max_len
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    return [("x q/k/v/out/fc", 5 * layers, m, d, e4, False),
            ("x proj", layers, m, f, e4, False),
            ("g q/k/v/out/proj", 5 * layers, m, d, e5, False),
            ("g fc", layers, m, f, e5, False),
            ("w q/k/v/out", 4 * layers, d, d, e4, True),
            ("w fc", layers, f, d, e4, True),
            ("w proj", layers, d, f, e4, True)]


def cast_compare(tq, x, hist, wire, res=None, **kw):
    """The cast kernel vs its plain version, bit for bit except a NaN
    payload's sign bit; returns the largest |kernel - plain| over the
    non-NaN elements of every output (payloads, ring, scale, residual)."""
    got = tq.fp8_cast(x, hist, wire, residual=res, **kw)
    want = tq.fp8_cast_reference(x, hist, wire, residual=res, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(got._fields, got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"fp8_cast {name}: {a is None} vs plain "
                                 f"{b is None}")
        if a is None:
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"fp8_cast {name} {a.shape} {a.dtype} vs "
                                 f"plain {b.shape} {b.dtype}")
        nan = torch.isnan(b.float())
        view = {1: torch.uint8, 4: torch.int32}[a.element_size()]
        same = (torch.equal(torch.isnan(a.float()), nan) and torch.equal(
            a.contiguous().view(view)[~nan], b.contiguous().view(view)[~nan]))
        if not same:
            raise AssertionError(
                f"fp8_cast kernel disagrees with its plain version on {name} "
                f"of {tuple(x.shape)} {x.dtype} -> {wire}")
        af, bf = a.float(), b.float()
        d = torch.where(af == bf, 0.0, (af - bf).abs())[~nan]
        if d.numel():
            err = max(err, d.max().item())
    return err


def fp8_cast_case(tq, gen, cfg):
    """[fp8-cast]: the cast kernel bit for bit against its plain version at
    the step's shapes and on special values and ragged shapes, then the
    step's shapes timed beside the plain composition and the byte bound."""
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    checked, err = 0, 0.0
    # Special values, a fresh ring, ragged shapes, rows off 16-byte
    # boundaries, fp32 and bf16, both modes and formats.
    for rows, cols, pad in ((1000, 768, 0), (130, 70, 0), (33, 129, 3),
                            (1, 17, 0)):
        base = torch.randn((rows, cols + pad), generator=gen,
                           device="cuda")[:, :cols] * 3
        for i, v in enumerate((float("nan"), float("inf"), -float("inf"),
                               1e6, -1e6, 0.0, -0.0, 1e-30)):
            base[(7 * i) % rows, (13 * i) % cols] = v
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            for wire in (e4, e5):
                for fresh in (True, False):
                    hist = torch.rand((16,), generator=gen,
                                      device="cuda") * 40
                    if fresh:
                        hist.zero_()
                    res = torch.randn((rows, cols), generator=gen,
                                      device="cuda") * 1e-3
                    err = max(err, cast_compare(tq, x, hist, wire),
                              cast_compare(tq, x, hist, wire, res))
                    checked += 2
    log(f"[fp8-cast] special values (NaN, +-inf, past qmax, signed zeros), "
        f"fresh and filled rings, ragged and unaligned shapes, fp32 and bf16, "
        f"e4m3 and e5m2, activation and weight mode: {checked} casts bit for "
        f"bit (max |d| {err})")
    cases, step = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                       "bytes": 0.0, "elements": 0.0, "launches": 0}
    for name, count, rows, cols, wire, weight in fp8_cast_shapes(cfg):
        x = (torch.randn((rows, cols), generator=gen, device="cuda")
             * (0.05 if weight else 3.0)).to(torch.bfloat16)
        hist = torch.rand((16,), generator=gen, device="cuda") * 10
        res = (torch.randn((rows, cols), generator=gen, device="cuda") * 1e-4
               if weight else None)
        err = max(err, cast_compare(tq, x, hist, wire, res))
        rec = {"name": name, "launches_per_step": count, "rows": rows,
               "cols": cols, "wire": str(wire), "weight": weight}
        rec["ms"] = time_ms(lambda: tq.fp8_cast(x, hist, wire, residual=res))
        rec["device_ms"] = device_ms(
            lambda: tq.fp8_cast(x, hist, wire, residual=res))
        rec["plain_ms"] = time_ms(
            lambda: tq.fp8_cast_reference(x, hist, wire, residual=res),
            samples=5, per_sample=3)
        per = 12 if weight else 4  # bytes an element in and out
        rec["bytes"] = rows * cols * per
        rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        rec["gbps"] = rec["bytes"] / rec["ms"] / 1e6
        log(f"[fp8-cast] {name}: [{rows}, {cols}] bf16 -> {wire}"
            f"{' + residual' if weight else ''}: kernel {rec['ms']:.4f} ms "
            f"({rec['gbps']:.0f} GB/s; device {rec['device_ms']:.4f} ms), "
            f"plain {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms (bytes); bit for bit")
        cases.append(rec)
        for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bytes"):
            step[key] = step.get(key, 0.0) + count * rec[key]
        step["elements"] += count * rows * cols
        step["launches"] += count
        del x, res
    step["bound_by"] = "bytes"
    log(f"[fp8-cast] one step's {step['launches']} launches "
        f"({step['elements'] / 1e9:.3f} G elements, {step['bytes'] / 1e9:.2f} "
        f"GB): kernel {step['ms']:.3f} ms (device {step['device_ms']:.3f} "
        f"ms), plain {step['plain_ms']:.3f} ms, bound {step['bound_ms']:.3f} "
        f"ms; max |d| over every cast checked {err}")
    torch.cuda.empty_cache()
    return {"checked": checked, "max_abs_err": err, "step": step,
            "cases": cases}


def fp8_linear_plain(tq, x, w, kr, xh, kh, gh, g):
    """Fp8Linear's forward and backward written out with the plain matmul:
    (out, dx, dw, new kr, new xh, new kh, new gh)."""
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    sx = tq.fp8_scale_from_history(xh, tq.E4M3_MAX)
    sk = tq.fp8_scale_from_history(kh, tq.E4M3_MAX)
    kc = w.float() + kr
    qx = tq.fp8_saturating_cast(x, sx, e4, tq.E4M3_MAX).flatten(0, -2)
    qk = tq.fp8_saturating_cast(kc, sk, e4, tq.E4M3_MAX)
    out = tq.fp8_matmul_reference(qx, qk.t(), sx * sk, out_dtype=x.dtype)
    sg = tq.fp8_scale_from_history(gh, tq.E5M2_MAX)
    qg = tq.fp8_saturating_cast(g, sg, e5, tq.E5M2_MAX).flatten(0, -2)
    dx = tq.fp8_matmul_reference(qg, qk, sg * sk, out_dtype=x.dtype)
    dw = tq.fp8_matmul_reference(qg.t(), qx, sx * sg, out_dtype=x.dtype)
    return (out.reshape(g.shape), dx.reshape(x.shape), dw,
            kc - qk.float() * sk, tq.fp8_push_amax(xh, x),
            tq.fp8_push_amax(kh, kc), tq.fp8_push_amax(gh, g))


def fp8_linear_check(hvt, tq, gen, model, tokens):
    """One Fp8Linear forward and backward at the first layer's fc (its
    real input and trained state, a gradient of the ring's magnitude)
    against the same math on the plain matmul: out, dx, dw within the bf16
    tolerance, the four state gradients bit for bit."""
    fc = model.transformer.blocks[0].mlp.fc
    seen = {}

    def keep_input(mod, inp, out):
        seen["x"] = inp[0].detach()

    hook = fc.register_forward_hook(keep_input)
    with torch.no_grad():
        model(tokens[:, :-1])
    hook.remove()
    x = seen["x"]
    w = fc.weight.detach().to(x.dtype)
    state = [p.detach() for p in (fc.fp8_k_residual, fc.fp8_x_amax_history,
                                  fc.fp8_k_amax_history,
                                  fc.fp8_g_amax_history)]
    g = (torch.randn(x.shape[:-1] + (w.shape[0],), generator=gen,
                     device="cuda") * (state[3].max() / 4)).to(x.dtype)
    leaves = [t.clone().requires_grad_(True) for t in [x, w] + state]
    tq.reset_launches()
    out = hvt.Fp8Linear.apply(*leaves)
    got = (out.detach(),) + torch.autograd.grad(out, leaves, g)
    counts = {"fp8_matmul": tq.launches_fp8_matmul,
              "fp8_cast": tq.launches_fp8_cast,
              "fp8_relayout": tq.launches_fp8_relayout}
    want = fp8_linear_plain(tq, x, w, *state, g)
    torch.cuda.synchronize()
    rels = []
    for name, a, b in zip(("out", "dx", "dw"), got[:3], want[:3]):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"Fp8Linear {name} {a.shape} {a.dtype} vs "
                                 f"plain {b.shape} {b.dtype}")
        rels.append((a.float() - b.float()).abs().max().item()
                    / max(b.float().abs().max().item(), 1e-30))
    same = [torch.equal(a, b) for a, b in zip(got[3:], want[3:])]
    log(f"[train-fp8] Fp8Linear at the first fc, x {tuple(x.shape)}, w "
        f"{tuple(w.shape)}, kernel vs plain: relative out/dx/dw "
        f"{rels} (tol {FP8_TOL[torch.bfloat16]}); state gradients bit for "
        f"bit {same}; launches {counts}")
    if max(rels) > FP8_TOL[torch.bfloat16] or not all(same):
        raise AssertionError("Fp8Linear on the kernel disagrees with its "
                             "plain math")
    if counts != {"fp8_matmul": 3, "fp8_cast": 3, "fp8_relayout": 0}:
        raise AssertionError(f"Fp8Linear launched {counts}")
    return {"rel_err_out_dx_dw": rels, "state_bitwise": all(same),
            "launches": counts}


def train_fp8(hvt, kernels, cfg_base):
    """[train-fp8]: the JAX package's bench_fp8 pair at GPT-2 small, "" then
    "fp8", each from convert.init_params(seed=0), 1 warm-up and FP8_STEPS
    timed steps on one batch of FP8_BATCH x 1025 tokens."""
    from horovod_tpu_torch.parallel import dp

    fa, fadam, tq = kernels
    hvt.init(backend="nccl")
    seq = cfg_base.max_len
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg_base.vocab_size, size=(FP8_BATCH, seq + 1)).astype(np.int32)
    ).long().cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    runs = {}
    for mode in ("", "fp8"):
        label = f"train-fp8 {mode or 'off'}"
        cfg = dataclasses.replace(cfg_base, compute_dtype=mode)
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
        step, wopt = hvt.make_train_step(
            train_loss(model), hvt.adamw(FP8_LR), compute_dtype=mode,
            tokens_per_step=FP8_BATCH * seq)
        state = dp.init_state(model, wopt)
        torch.cuda.reset_peak_memory_stats()
        state, loss = step(state, tokens)
        losses = [float(loss)]
        reset_counts(fa, fadam, tq)
        times, enqueue = [], []
        for _ in range(FP8_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, tokens)
            enqueue.append(time.perf_counter() - t0)
            losses.append(float(loss))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = read_counts(fa, fadam, tq)
        want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "fused_adamw": 0,
                "quantize_blockwise": 0, "dequantize_blockwise": 0,
                "fp8_matmul": 18 * cfg.n_layers if mode else 0,
                "fp8_cast": 18 * cfg.n_layers if mode else 0,
                "fp8_relayout": 0}
        log(f"[{label}] losses {losses}")
        log(f"[{label}] launches over {FP8_STEPS} steps: {counts}")
        for name, per_step in want.items():
            if counts[name] != per_step * FP8_STEPS:
                raise AssertionError(
                    f"[{label}] {name} launched {counts[name]} times in "
                    f"{FP8_STEPS} steps, not {per_step} a step")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[{label}] non-finite loss: {losses}")
        step_ms = float(np.median(times)) * 1e3
        rec = {"losses": losses, "launches": counts, "step_ms": step_ms,
               "step_ms_all": [t * 1e3 for t in times],
               "enqueue_ms": float(np.median(enqueue)) * 1e3,
               "tokens_per_s": step.throughput(step_ms / 1e3)["tokens_per_s"],
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"[{label}] step median {step_ms:.3f} ms (min "
            f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), host "
            f"enqueue {rec['enqueue_ms']:.3f} ms; {rec['tokens_per_s']:.1f} "
            f"tokens/s; peak memory {rec['peak_memory_gib']:.2f} GiB")
        if mode:
            rec["gauges"] = hvt.fp8_state_gauges(state.params)
            log(f"[{label}] gauges {rec['gauges']}")
            rec["fp8_linear"] = fp8_linear_check(hvt, tq, gen, model, tokens)

            def one_step():
                nonlocal state
                state, _ = step(state, tokens)

            rec["profile"] = profile_window(one_step,
                                            {"steps": 1, "run": label})
        runs[mode or "off"] = rec
        del model, step, wopt, state
        torch.cuda.empty_cache()
    hvt.shutdown()
    off, on = runs["off"], runs["fp8"]
    converged = bool(
        np.isfinite(on["losses"][-1]) and on["losses"][-1] < on["losses"][0]
        and abs(on["losses"][-1] - off["losses"][-1])
        <= FP8_LOSS_RTOL * max(abs(off["losses"][-1]), 1e-9))
    pair = {"batch": FP8_BATCH, "seq_len": seq, "timing_steps": FP8_STEPS,
            "step_ms_off": off["step_ms"], "step_ms_on": on["step_ms"],
            "speedup": off["step_ms"] / on["step_ms"],
            "tokens_per_s_off": off["tokens_per_s"],
            "tokens_per_s_on": on["tokens_per_s"],
            "loss_off_first": off["losses"][0], "loss_off": off["losses"][-1],
            "loss_on_first": on["losses"][0], "loss_on": on["losses"][-1],
            "loss_rtol": FP8_LOSS_RTOL, "converged": converged,
            **on["gauges"]}
    log(f"[train-fp8] {json.dumps(pair)}")
    if not converged:
        raise AssertionError(f"the fp8 run did not converge: {pair}")
    return {"pair": pair, "off": off, "on": on}


def serve(hvt, fa, workdir):
    from horovod_tpu_torch.serve import ServePool

    cfg = hvt.GPT2Config.small()
    n_req, seq, batch = SERVE_REQUESTS, cfg.max_len, SERVE_BATCH
    t0 = time.perf_counter()
    params = hvt.convert.init_params(cfg, seed=0)
    hvt.save_checkpoint(workdir, params, step=1)
    log(f"[serve] GPT-2 small ({sum(p.numel() for p in params.values())} "
        f"params) made and saved in {time.perf_counter() - t0:.1f} s")
    # bf16 matmul/embedding weights: the fp32 checkpoint is cast once at
    # load (LayerNorm parameters stay fp32).
    template = hvt.GPT2LMModel(cfg, device="cuda")

    def infer(model, tokens):
        return model(tokens)[:, -1, :]

    pool = ServePool(
        infer, ckpt_dir=workdir, ckpt_target=template, workers=2,
        batch_size=batch, batch_timeout_ms=5.0, request_timeout_secs=600.0,
        ckpt_poll_secs=0.2, device="cuda",
    ).start()
    try:
        model = pool._init_params
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (n_req, seq), dtype=np.int64
        )
        with torch.inference_mode():  # warm-up (cuBLAS, allocator)
            infer(model, torch.from_numpy(tokens[:batch]).cuda())
        torch.cuda.synchronize()

        fa.reset_launches()
        batches0 = pool.dispatcher.n_batches
        rounds, answers = [], None
        for r in range(SERVE_ROUNDS):
            t0 = time.perf_counter()
            futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
            got = [f.result(timeout=600.0) for f in futs]
            wall = time.perf_counter() - t0
            lat = np.asarray(list(pool.dispatcher.latencies)[-n_req:])
            p50, p95 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 95))
            rounds.append({"req_per_s": n_req / wall,
                           "tokens_per_s": n_req * seq / wall,
                           "p50_ms": p50, "p95_ms": p95})
            log(f"[serve] round {r}: {n_req} requests in {wall:.4f} s: "
                f"{n_req / wall:.2f} req/s, {n_req * seq / wall:.1f} "
                f"tokens/s; latency p50 {p50:.2f} ms, p95 {p95:.2f} ms")
            answers = answers or got
        launches = fa.launches
        batches = pool.dispatcher.n_batches - batches0
        log(f"[serve] {SERVE_ROUNDS} x {n_req} requests in {batches} "
            f"batches; flash launches {launches}")
        if launches != cfg.n_layers * batches:
            raise AssertionError(
                f"flash launches {launches} != {cfg.n_layers} x {batches} "
                "batches: the main path did not run the kernel once per layer"
            )
        for a in answers:
            if a.shape != (cfg.vocab_size,) or a.dtype != torch.float32:
                raise AssertionError(f"bad answer {a.shape} {a.dtype}")
            if not torch.isfinite(a).all():
                raise AssertionError("non-finite logits")

        plain = hvt.GPT2LMModel(cfg, device="cuda",
                                attention_fn=plain_attention(fa))
        plain.load_state_dict(model.state_dict())
        with torch.inference_mode():
            ref = infer(plain, torch.from_numpy(tokens[:batch]).cuda()).cpu()
        got = torch.stack(answers[:batch])
        err = (got - ref).abs().max().item()
        bound = 0.05 * ref.abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > bound
        same = got.argmax(-1) == ref.argmax(-1)
        log(f"[serve] kernel vs plain logits: max|d|={err:.4e} "
            f"(bound {bound:.4e}); argmax agrees on "
            f"{int(same.sum())}/{batch} rows, {int(decided.sum())} decided")
        if err > bound or not bool(same[decided].all()):
            raise AssertionError("served logits disagree with the plain path")
        prof = profile_serving(pool, tokens[:16])

        hvt.save_checkpoint(workdir, hvt.convert.init_params(cfg, seed=2),
                            step=2)
        t0 = time.time()
        while len(pool.swap_log) < 2 and time.time() - t0 < 300.0:
            time.sleep(0.05)
        log(f"[serve] swap_log {pool.swap_log}")
        if sorted(w for w, _, _, _ in pool.swap_log) != ["w0", "w1"] or any(
            s != 2 for _, s, _, _ in pool.swap_log
        ):
            raise AssertionError("the pool did not roll onto step 2")
        ivals = sorted((a, b) for _, _, a, b in pool.swap_log)
        if any(end > start for (_, end), (start, _) in zip(ivals, ivals[1:])):
            raise AssertionError("hot-swap windows overlap")
        after = pool.submit(torch.from_numpy(tokens[0])).result(timeout=600.0)
        if not torch.isfinite(after).all() or torch.equal(after, answers[0]):
            raise AssertionError("step-2 weights are not being served")
    finally:
        pool.stop()
    return {"launches": launches, "batches": batches, "rounds": rounds,
            "req_per_s_median": float(np.median(
                [r["req_per_s"] for r in rounds])),
            "logit_err": err, "profile": prof,
            "answers8": torch.stack(answers[:batch])}


def int8_products(cfg):
    """Kernel 7's calls in one GPT-2 serving batch: ``(name, launches a
    batch, K, N)``."""
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    return [("qkv", layers, d, 3 * d), ("out", layers, d, d),
            ("fc", layers, d, f), ("proj", layers, f, d)]


def int8_compare(tq, x, qw):
    """Kernel 7 vs its plain version on one call: (max |d|, relative to the
    largest plain value)."""
    got = tq.int8_weight_matmul(x, qw)
    ref = tq.int8_weight_matmul_reference(x, qw)
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"int8_weight_matmul {got.shape} {got.dtype} vs "
                             f"plain {ref.shape} {ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not rel <= INT8_TOL[x.dtype]:
        raise AssertionError(
            f"int8 matmul kernel disagrees with its plain version on x "
            f"{tuple(x.shape)} {x.dtype} x w {tuple(qw.shape)}: {rel} "
            f"(tol {INT8_TOL[x.dtype]})")
    return err, rel


def int8pack_call(x2, qw):
    """torch._weight_int8pack_mm on the same operands, the yardstick (the
    port never calls it; it takes its scales in x's dtype), as a callable;
    None where the build does not run it on CUDA."""
    w_nk = qw.q.t()
    scales = qw.scales.to(x2.dtype)

    def call():
        return torch._weight_int8pack_mm(x2, w_nk, scales)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, AttributeError, NotImplementedError) as exc:
        log(f"[int8] torch._weight_int8pack_mm does not run here: "
            f"{str(exc).splitlines()[0][:160]}")
        return None
    return call


def _int8_times(rec):
    def ms(key):
        return "-" if rec[key] is None else f"{rec[key]:.4f}"

    return (f"ms by events / device: kernel {ms('ms')} / {ms('device_ms')}, "
            f"plain {ms('plain_ms')}, _weight_int8pack_mm {ms('library_ms')} / "
            f"{ms('device_library_ms')}, bf16 F.linear {ms('bf16_ms')} / "
            f"{ms('device_bf16_ms')}; bound {ms('bound_ms')} ({rec['bound_by']})")


def int8_case(tq, gen, cfg):
    """[int8]: kernel 7 vs its plain version on ragged cases and at one
    serving batch's products (M = 8192) and decode-sized ones (M = 8), the
    latter two timed beside the plain version, the library call and the
    bf16 cuBLAS product of the dequantized weight, each with its bound."""
    import torch.nn.functional as F

    err = rel = 0.0
    rng = np.random.RandomState(6)
    for mm, kk, nn in ((5, 300, 70), (16, 512, 128), (1, 64, 10),
                       (130, 1000, 260), (33, 17, 129)):
        w = torch.from_numpy(rng.randn(kk, nn).astype(np.float32)).cuda()
        x = torch.from_numpy(rng.randn(mm, kk).astype(np.float32)).cuda()
        qw = tq.quantize_weight(w)
        for dtype in (torch.float32, torch.bfloat16):
            e, r = int8_compare(tq, x.to(dtype), qw)
            err, rel = max(err, e), max(rel, r)
    log(f"[int8] ragged cases, fp32 and bf16: max |d| {err:.3e}, relative "
        f"{rel:.3e}")
    cases, sums = [], {}
    timed = ("ms", "plain_ms", "library_ms", "bf16_ms")
    for m, label in ((SERVE_BATCH * cfg.max_len, "batch"),
                     (SERVE_BATCH, "decode")):
        tot = {"bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0, "launches": 0,
               "m": m}
        for key in timed:
            tot[key] = tot["device_" + key] = 0.0
        for name, count, kk, nn in int8_products(cfg):
            rows = (SERVE_BATCH, m // SERVE_BATCH)  # [B, S, K] as the model
            x = torch.randn((*rows, kk), generator=gen,
                            device="cuda").to(torch.bfloat16)
            qw = tq.quantize_weight(
                torch.randn((kk, nn), generator=gen, device="cuda") * 0.02)
            e, r = int8_compare(tq, x, qw)
            err, rel = max(err, e), max(rel, r)
            x2 = x.reshape(m, kk)
            w_bf16 = tq.dequantize_weight(qw).t().contiguous().to(
                torch.bfloat16)
            rec = {"name": name, "launches_per_batch": count, "m": m,
                   "k": kk, "n": nn, "rel_err": r}
            fns = {"ms": lambda: tq.int8_weight_matmul(x, qw),
                   "plain_ms": lambda: tq.int8_weight_matmul_reference(x, qw),
                   "library_ms": int8pack_call(x2, qw),
                   "bf16_ms": lambda: F.linear(x2, w_bf16)}
            # Event times; at M = 8 they time the host's launches, so each
            # call's device time (torch.profiler) stands beside them -- not
            # the plain version's, which launches a kernel many times a call.
            for key, fn in fns.items():
                slow = key in ("plain_ms", "library_ms")
                rec[key] = None if fn is None else time_ms(
                    fn, **(dict(samples=5, per_sample=3) if slow else {}))
                rec["device_" + key] = (
                    None if fn is None or key == "plain_ms"
                    else device_ms(fn, calls=5 if slow else 20))
            nbytes = 2 * m * kk + kk * nn + 4 * nn + 2 * m * nn
            flops = 2 * m * nn * kk
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / BF16_FLOPS_PER_S
            rec.update(bytes=nbytes, flops=flops,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            # Rates from the kernel's device time.
            rec["tflops"] = flops / rec["device_ms"] / 1e9
            rec["gbytes_per_s"] = nbytes / rec["device_ms"] / 1e6
            log(f"[int8] {label} {name}: [{m}, {kk}] x [{kk}, {nn}] bf16 x "
                f"int8 ({rec['tflops']:.1f} TFLOP/s, "
                f"{rec['gbytes_per_s']:.0f} GB/s), {_int8_times(rec)}; "
                f"relative error {r:.3e}")
            cases.append(rec)
            for key in [*timed, *("device_" + k for k in timed), "bound_ms"]:
                tot[key] = (None if tot[key] is None or rec[key] is None
                            else tot[key] + count * rec[key])
            tot["t_bytes"] += count * t_bytes * 1e3
            tot["t_ops"] += count * t_ops * 1e3
            tot["launches"] += count
            del x, x2, qw, w_bf16, fns
        tot["bound_by"] = ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                           else "operations")
        log(f"[int8] one {label}'s {tot['launches']} launches (M = {m}), "
            f"{_int8_times(tot)}")
        sums[label] = tot
    log(f"[int8] max |d| {err:.3e}, relative {rel:.3e}")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "max_rel_err": rel, "batch": sums["batch"],
            "decode": sums["decode"], "cases": cases}


def _dense_layers(model):
    from horovod_tpu_torch.models.transformer import Dense

    return [m for m in model.modules() if isinstance(m, Dense)]


def check_int8_model(model, where):
    """Every Dense holds an int8 payload and fp32 scales, no floating
    weight."""
    dense = _dense_layers(model)
    bad = [i for i, m in enumerate(dense)
           if not m.quantized or "weight" in m._parameters
           or m.weight_q.dtype != torch.int8
           or m.weight_scales.dtype != torch.float32]
    if not dense or bad:
        raise AssertionError(f"{where}: Dense layers {bad} of {len(dense)} "
                             "are not int8")


def weight_bytes(model):
    """(all parameter and buffer bytes, the projections' bytes)."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    total = nbytes(list(model.parameters()) + list(model.buffers()))
    proj = sum(nbytes([m.weight_q, m.weight_scales]) if m.quantized
               else nbytes([m.weight]) for m in _dense_layers(model))
    return total, proj


def serve_int8(hvt, fa, tq, workdir, bf16_answers):
    """[serve-int8]: GPT-2 small through ServePool(weight_dtype="int8")."""
    from horovod_tpu_torch.serve import ServePool

    cfg = hvt.GPT2Config.small()
    n_req, seq, batch = SERVE_REQUESTS, cfg.max_len, SERVE_BATCH
    per_restore = 4 * cfg.n_layers
    ckdir = Path(workdir) / "int8"
    shutil.copytree(Path(workdir) / "step_1", ckdir / "step_1")
    ckdir = str(ckdir)
    fc_name = "transformer.blocks.0.mlp.fc.weight"
    fc32 = hvt.restore_checkpoint(
        ckdir, {fc_name: torch.zeros((cfg.d_ff, cfg.d_model))})[fc_name]
    template = hvt.GPT2LMModel(cfg, device="cuda")

    def infer(model, tokens):
        return model(tokens)[:, -1, :]

    tq.reset_launches()
    t0 = time.perf_counter()
    pool = ServePool(
        infer, ckpt_dir=ckdir, ckpt_target=template, workers=2,
        batch_size=batch, batch_timeout_ms=5.0, request_timeout_secs=600.0,
        ckpt_poll_secs=0.2, device="cuda", weight_dtype="int8",
    ).start()
    try:
        load_s = time.perf_counter() - t0
        quant_load = tq.launches_quant
        model = pool._init_params
        check_int8_model(model, "after load")
        if quant_load != per_restore:
            raise AssertionError(f"kernel 4 launched {quant_load} times at "
                                 f"load, not {per_restore}")
        want = tq.quantize_weight(fc32.t())  # the plain version, on the CPU
        fc = model.transformer.blocks[0].mlp.fc
        same_fc = (torch.equal(fc.quantized_weight().q.cpu(), want.q)
                   and torch.equal(fc.weight_scales.cpu().view(torch.int32),
                                   want.scales.view(torch.int32)))
        if not same_fc:
            raise AssertionError("layer 0's fc payload differs from the plain "
                                 "quantize_weight of the fp32 checkpoint")
        total, proj = weight_bytes(model)
        total16, proj16 = weight_bytes(template)
        log(f"[serve-int8] loaded in {load_s:.1f} s; kernel 4 launches "
            f"{quant_load}; every Dense int8; layer 0 fc bit for bit with the "
            f"CPU plain quantize_weight; weight bytes {total} (projections "
            f"{proj}) vs the bf16 pool's {total16} ({proj16})")
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (n_req, seq), dtype=np.int64)
        with torch.inference_mode():  # warm-up
            infer(model, torch.from_numpy(tokens[:batch]).cuda())
        torch.cuda.synchronize()

        fa.reset_launches()
        tq.reset_launches()
        batches0 = pool.dispatcher.n_batches
        rounds, answers = [], None
        for r in range(SERVE_ROUNDS):
            t0 = time.perf_counter()
            futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
            got = [f.result(timeout=600.0) for f in futs]
            wall = time.perf_counter() - t0
            lat = np.asarray(list(pool.dispatcher.latencies)[-n_req:])
            p50, p95 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 95))
            rounds.append({"req_per_s": n_req / wall,
                           "tokens_per_s": n_req * seq / wall,
                           "p50_ms": p50, "p95_ms": p95})
            log(f"[serve-int8] round {r}: {n_req} requests in {wall:.4f} s: "
                f"{n_req / wall:.2f} req/s, {n_req * seq / wall:.1f} "
                f"tokens/s; latency p50 {p50:.2f} ms, p95 {p95:.2f} ms")
            answers = answers or got
        launches = {"int8_matmul": tq.launches_int8_matmul,
                    "flash_fwd": fa.launches}
        batches = pool.dispatcher.n_batches - batches0
        log(f"[serve-int8] {SERVE_ROUNDS} x {n_req} requests in {batches} "
            f"batches; launches {launches}")
        if launches != {"int8_matmul": per_restore * batches,
                        "flash_fwd": cfg.n_layers * batches}:
            raise AssertionError(
                f"launches {launches} in {batches} batches: the main path "
                f"did not run kernel 7 once a projection and the flash "
                f"kernel once a layer")
        for a in answers:
            if a.shape != (cfg.vocab_size,) or a.dtype != torch.float32:
                raise AssertionError(f"bad answer {a.shape} {a.dtype}")
            if not torch.isfinite(a).all():
                raise AssertionError("non-finite logits")

        # A bf16 model holding the dequantized weights, on cuBLAS.
        deq = hvt.GPT2LMModel(cfg, device="cuda")
        sd = {}
        for name, t in model.state_dict().items():
            if name.endswith(".weight_scales"):
                continue
            if name.endswith(".weight_q"):
                pre = name[:-len("weight_q")]
                qw = tq.QuantizedWeight(t.t(), model.state_dict()[
                    pre + "weight_scales"], "float32")
                sd[pre + "weight"] = tq.dequantize_weight(qw).t()
            else:
                sd[name] = t
        deq.load_state_dict(sd)
        with torch.inference_mode():
            ref = infer(deq, torch.from_numpy(tokens[:batch]).cuda()).cpu()
        del deq, sd
        got = torch.stack(answers[:batch])
        err = (got - ref).abs().max().item()
        bound = 0.05 * ref.abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > bound
        same = got.argmax(-1) == ref.argmax(-1)
        rel_l2 = float((got - bf16_answers).norm() / bf16_answers.norm())
        argmax_bf16 = int((got.argmax(-1) == bf16_answers.argmax(-1)).sum())
        log(f"[serve-int8] kernel 7 vs the dequantized bf16 model (cuBLAS): "
            f"max|d|={err:.4e} (bound {bound:.4e}); argmax agrees on "
            f"{int(same.sum())}/{batch} rows, {int(decided.sum())} decided; "
            f"relative L2 against the bf16 pool's answers {rel_l2:.4e} "
            f"(argmax agrees on {argmax_bf16}/{batch})")
        if err > bound or not bool(same[decided].all()):
            raise AssertionError("int8 answers disagree with the dequantized "
                                 "bf16 model")
        prof = profile_serving(pool, tokens[:16])

        tq.reset_launches()
        hvt.save_checkpoint(ckdir, hvt.convert.init_params(cfg, seed=2),
                            step=2)
        t0 = time.time()
        while len(pool.swap_log) < 2 and time.time() - t0 < 300.0:
            time.sleep(0.05)
        log(f"[serve-int8] swap_log {pool.swap_log}; kernel 4 launches "
            f"{tq.launches_quant}")
        if sorted(w for w, _, _, _ in pool.swap_log) != ["w0", "w1"] or any(
            s != 2 for _, s, _, _ in pool.swap_log
        ):
            raise AssertionError("the int8 pool did not roll onto step 2")
        ivals = sorted((a, b) for _, _, a, b in pool.swap_log)
        if any(end > start for (_, end), (start, _) in zip(ivals, ivals[1:])):
            raise AssertionError("hot-swap windows overlap")
        for w in pool._workers.values():
            check_int8_model(w.params, f"worker {w.name} after the swap")
        if tq.launches_quant != 2 * per_restore:
            raise AssertionError(f"kernel 4 launched {tq.launches_quant} "
                                 f"times in the swap, not 2 x {per_restore}")
        after = pool.submit(torch.from_numpy(tokens[0])).result(timeout=600.0)
        if not torch.isfinite(after).all() or torch.equal(after, answers[0]):
            raise AssertionError("step-2 weights are not being served")
    finally:
        pool.stop()
        shutil.rmtree(ckdir, ignore_errors=True)
    return {"launches": launches["int8_matmul"],
            "launches_flash_fwd": launches["flash_fwd"], "batches": batches,
            "rounds": rounds, "req_per_s_median": float(np.median(
                [r["req_per_s"] for r in rounds])),
            "quant_launches_per_restore": quant_load,
            "weight_bytes": total, "projection_bytes": proj,
            "weight_bytes_bf16": total16, "projection_bytes_bf16": proj16,
            "load_s": load_s, "logit_err": err, "logit_bound": bound,
            "rel_l2_vs_bf16_pool": rel_l2, "argmax_vs_bf16_pool": argmax_bf16,
            "profile": prof}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import quantization as tq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[card] sources sha256 {source_fingerprint()}")
    before = sorted(p.name for p in _build.BUILD_DIR.glob("lib*.so"))
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[card] built {built} in {time.perf_counter() - t0:.1f} s "
        f"(libraries in _build/ before: {before or 'none'})")

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_case = flash_case(fa, gen, b=8, sq=1024, skv=1024, h=12, d=64,
                           causal=True, timed=True)
    cases = [
        main_case,
        flash_case(fa, gen, b=2, sq=333, skv=1000, h=12, d=64, causal=False,
                   q_offset=40, kv_len=937),
        flash_case(fa, gen, b=2, sq=200, skv=520, h=4, d=128, causal=True,
                   q_offset=300, kv_offset=0, kv_len=517),
    ]
    bwd_main = bwd_case(fa, gen, b=8, sq=1024, skv=1024, h=12, d=64,
                        causal=True, timed=True)
    # The fp8 step's shape (batch 16), timed only to price the pair there.
    bwd_b16 = bwd_case(fa, gen, b=16, sq=1024, skv=1024, h=12, d=64,
                       causal=True, timed=True)
    f32 = torch.float32
    bwd_cases = [
        bwd_main,
        bwd_b16,
        bwd_case(fa, gen, b=2, sq=333, skv=1000, h=12, d=64, causal=False,
                 q_offset=40, kv_len=937),
        bwd_case(fa, gen, b=2, sq=200, skv=520, h=4, d=128, causal=True,
                 q_offset=300, kv_len=517),
        # An fp32 cotangent (delta from it as given) and ragged tile edges.
        bwd_case(fa, gen, b=2, sq=1024, skv=1024, h=12, d=64, causal=True,
                 g_dtype=f32),
        bwd_case(fa, gen, b=2, sq=129, skv=1000, h=4, d=128, causal=False,
                 kv_len=999, g_dtype=f32),
        bwd_case(fa, gen, b=1, sq=65, skv=127, h=2, d=64, causal=True,
                 q_offset=62, kv_len=100),
        bwd_case(fa, gen, b=1, sq=1, skv=129, h=2, d=128, causal=True,
                 q_offset=128),
        bwd_case(fa, gen, b=1, sq=1000, skv=63, h=2, d=128, causal=False,
                 kv_len=60, g_dtype=f32),
    ]
    train_cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sizes = trainer_bucket_sizes(hvt, train_cfg)
    adam = adamw_case(fadam, gen, sizes)
    torch.cuda.empty_cache()
    trained = train(hvt, fa, fadam, train_cfg, sizes)
    qsizes = quant_bucket_sizes(hvt, train_cfg)
    quant = quant_case(tq, gen, qsizes)
    quant_trained = train_quant(hvt, (fa, fadam, tq), train_cfg, sizes,
                                qsizes)
    fp8 = fp8_case(tq, gen, train_cfg)
    fp8_cast = fp8_cast_case(tq, gen, train_cfg)
    fp8_trained = train_fp8(hvt, (fa, fadam, tq), train_cfg)

    workdir = tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_DIR)
    try:
        served = serve(hvt, fa, workdir)
        int8 = int8_case(tq, gen, hvt.GPT2Config.small())
        served_int8 = serve_int8(hvt, fa, tq, workdir,
                                 served.pop("answers8"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    src = "horovod_tpu_torch/csrc/"
    ref = "horovod_tpu/ops/pallas_kernels.py:"
    launches = trained["launches"]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": ref + "125",
        "launches": launches["flash_fwd"],
        "launches_serve": served["launches"],
        "max_abs_err": max(c["err_out"] for c in cases),
        "max_abs_err_lse": max(c["err_lse"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    # The two backward kernels run as one pair (flash_attention_bwd): "ms"
    # is the pair's CUDA-event time, as for every row, "device_ms" each
    # kernel's own profiled time; the plain version and the yardstick (SDPA's
    # backward, by events and by device time) compute the pair's function.
    # "b16" holds the same at batch 16, the fp8 step's shape.
    for name, line in (("flash_bwd_dkdv", "480"), ("flash_bwd_dq", "541")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": ref + line,
            "launches": launches[name],
            "max_abs_err": max(c["err"] for c in bwd_cases),
            "max_rel_err": max(c["rel_err"] for c in bwd_cases),
            "bitwise_repeat": all(c["bitwise"] for c in bwd_cases),
            "ms": bwd_main["ms"],
            "device_ms": bwd_main["kernel_ms"][name],
            "plain_ms": bwd_main["plain_ms"],
            "bound_ms": bwd_main[name]["bound_ms"],
            "bound_by": bwd_main[name]["bound_by"],
            "pair_bound_ms": bwd_main["pair"]["bound_ms"],
            "library_ms": bwd_main["library_ms"],
            "library_device_ms": bwd_main["library_device_ms"],
            "b16": {
                "ms": bwd_b16["ms"],
                "device_ms": bwd_b16["kernel_ms"][name],
                "bound_ms": bwd_b16[name]["bound_ms"],
                "pair_bound_ms": bwd_b16["pair"]["bound_ms"],
                "library_ms": bwd_b16["library_ms"],
                "library_device_ms": bwd_b16["library_device_ms"],
            },
        })
    kernels.append({
        "name": "fused_adamw",
        "route": "cuda",
        "source": src + "fused_adamw.cu",
        "replaces": ref + "1064",
        "launches": launches["fused_adamw"],
        "max_abs_err": adam["err"],
        "max_rel_err": adam["rel_err"],
        "bitwise": adam["bitwise"],
        "ms": adam["ms"],
        "plain_ms": adam["plain_ms"],
        "bound_ms": adam["bound_ms"],
        "bound_by": adam["bound_by"],
        "library_ms": adam["library_ms"],
    })
    qlaunch = {r: quant_trained[r]["launches"] for r in ("on", "zero1", "fp8")}
    for name, line, pre in (("quantize_blockwise", "963", "quant"),
                            ("dequantize_blockwise", "978", "dequant")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "quant_blockwise.cu",
            "replaces": ref + line,
            "launches": qlaunch["on"][name],
            "launches_zero1": qlaunch["zero1"][name],
            "launches_fp8": qlaunch["fp8"][name],
            "max_abs_err": quant["max_abs_err"],
            "bitwise": quant["bitwise"],
            "ms": quant[pre + "_ms"],
            "ms_fp8": quant[pre + "_ms_fp8"],
            "plain_ms": quant[pre + "_plain_ms"],
            "plain_ms_fp8": quant[pre + "_plain_ms_fp8"],
            "bound_ms": quant["bound_ms"],
            "bound_by": quant["bound_by"],
            "library_ms": quant.get(pre + "_library_ms"),
        })
    # Kernel 8: "ms", "plain_ms", "library_ms" and "bound_ms" are one
    # training step's 216 launches (each shape's time times its launches a
    # step); "cases" holds each shape's own. "ms" and "library_ms" are the
    # CUDA-event times of back-to-back calls, as for every other kernel
    # (they include the host's time where a wrapper takes longer than its
    # kernel); "device_ms" and "library_device_ms" the device times under
    # torch.profiler (the kernel's and torch._scaled_mm's own).
    step8 = fp8["step"]
    kernels.append({
        "name": "fp8_matmul",
        "route": "cuda",
        "source": src + "fp8_matmul.cu",
        "replaces": ref + "1268",
        "launches": fp8_trained["on"]["launches"]["fp8_matmul"],
        "launches_per_step": step8["launches"],
        "launches_relayout": fp8_trained["on"]["launches"]["fp8_relayout"],
        "max_abs_err": fp8["max_abs_err"],
        "max_rel_err": fp8["max_rel_err"],
        "promotion_rel_err": fp8["promotion_rel_err"],
        "ms": step8["ms"],
        "device_ms": step8["device_ms"],
        "plain_ms": step8["plain_ms"],
        "bound_ms": step8["bound_ms"],
        "bound_by": step8["bound_by"],
        "library_ms": step8["library_ms"],
        "library_device_ms": step8["library_device_ms"],
    })
    # The cast kernel (not a TPU kernel: the port's counterpart of XLA's
    # fusion of the jnp cast and amax in horovod_tpu/ops/fp8.py): "ms",
    # "plain_ms" and "bound_ms" are one training step's 216 launches, "ms"
    # the CUDA-event time and "device_ms" the device time, as for kernel 8.
    step_c = fp8_cast["step"]
    kernels.append({
        "name": "fp8_cast",
        "route": "cuda",
        "source": src + "fp8_cast.cu",
        "replaces": "horovod_tpu/ops/fp8.py:136",
        "launches": fp8_trained["on"]["launches"]["fp8_cast"],
        "launches_per_step": step_c["launches"],
        "max_abs_err": fp8_cast["max_abs_err"],
        "bitwise": True,
        "ms": step_c["ms"],
        "device_ms": step_c["device_ms"],
        "plain_ms": step_c["plain_ms"],
        "bound_ms": step_c["bound_ms"],
        "bound_by": step_c["bound_by"],
        "library_ms": None,
    })
    # Kernel 7: "ms", "plain_ms", "library_ms", "bf16_ms" and "bound_ms" are
    # one serving batch's 48 launches at M = 8192 ("device_ms" the kernel's
    # profiled device time); "decode" the same at M = 8, where the event
    # times are the host's and the device_* times the card's.
    batch7, decode7 = int8["batch"], int8["decode"]
    kernels.append({
        "name": "int8_matmul",
        "route": "cuda",
        "source": src + "int8_matmul.cu",
        "replaces": ref + "1162",
        "launches": served_int8["launches"],
        "launches_per_batch": batch7["launches"],
        "max_abs_err": int8["max_abs_err"],
        "max_rel_err": int8["max_rel_err"],
        "ms": batch7["ms"],
        "plain_ms": batch7["plain_ms"],
        "bound_ms": batch7["bound_ms"],
        "bound_by": batch7["bound_by"],
        "library_ms": batch7["library_ms"],
        "bf16_ms": batch7["bf16_ms"],
        "device_ms": batch7["device_ms"],
        "decode": {k: v for k, v in decode7.items()
                   if k not in ("t_bytes", "t_ops")},
    })
    print(json.dumps({"kernels": kernels, "train": trained, "quant": quant,
                      "train_quant": quant_trained, "fp8": fp8,
                      "fp8_cast": fp8_cast,
                      "train_fp8": fp8_trained, "serve": served,
                      "int8": int8, "serve_int8": served_int8}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
