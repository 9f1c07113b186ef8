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
3. Serving: GPT-2 small at full width from convert.init_params(seed=0),
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
4. Output: a "kernels" JSON line, the card's name and power limit, and
   the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
OUT_TOL, LSE_TOL = 1e-2, 1e-3
SERVE_ROUNDS = 5


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


def plain_attention(fa):
    def attn(q, k, v, *, causal, mask=None):
        return fa.flash_attention_reference(q, k, v, causal=causal)[0]

    return attn


def kernel_category(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash_fwd"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def profile_serving(pool, tokens):
    """Device time by kernel over a window of served requests."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
        for f in futs:
            f.result(timeout=600.0)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    device_ms = sum(by_name.values())
    by_cat = {}
    for name, ms in by_name.items():
        c = kernel_category(name)
        by_cat[c] = by_cat.get(c, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    rec = {"requests": len(tokens), "wall_ms": wall_ms,
           "device_ms": device_ms,
           "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
           "by_category_ms": by_cat,
           "top_kernels_ms": [[n[:80], ms] for n, ms in top]}
    log(f"[profile] {json.dumps(rec)}")
    return rec


def serve(hvt, fa, workdir):
    from horovod_tpu_torch.serve import ServePool

    cfg = hvt.GPT2Config.small()
    n_req, seq, batch = 64, cfg.max_len, 8
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
            "logit_err": err, "profile": prof}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

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

    workdir = tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_DIR)
    try:
        served = serve(hvt, fa, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "horovod_tpu/ops/pallas_kernels.py:125",
        "launches": served["launches"],
        "max_abs_err": max(c["err_out"] for c in cases),
        "max_abs_err_lse": max(c["err_lse"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    print(json.dumps({"kernels": kernels, "serve": served}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
