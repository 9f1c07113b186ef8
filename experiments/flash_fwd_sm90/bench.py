"""Times design variants of the sm90 flash forward at the exp-bound head
dims on one card, in turns.

    python3 experiments/flash_fwd_sm90/bench.py    # from the repository root

Builds, with the package's nvcc flags, into horovod_tpu_torch/_build/,
copies of horovod_tpu_torch/csrc/flash_fwd_sm90_general.cu with one
choice changed at bf16 d_pad 16 and 32 -- one block an SM with 128-key
tiles (the first design), one block an SM with 64-key tiles, and the
package's two blocks an SM with the row max and row sum each split into
four partial chains -- beside the package's own library. Each is held
against the plain version (out 1e-2, lse 1e-3) at bf16 head dims 8-48
on fused-QKV views (plain, causal, kv_len < Skv, a ring hop's wholly
masked block, sm_scale < 0, Sq = 1030), then timed by device time under
torch.profiler at [8, 1024, 48, 16] and [8, 1024, 24, 32] causal, three
rounds, the order reversed every round. Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = ROOT / "horovod_tpu_torch/csrc" / f"{fa.SM90_FWD_SOURCE}.cu"
TILES = "static constexpr int kBN = D == 256 || D <= 32 ? 64 : 128;"
BLOCKS = "static constexpr int kBlocks = D <= 32 ? 2 : 1;"
MAX = """  float mx[2] = {kFold ? -INFINITY : m[0], kFold ? -INFINITY : m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
"""
MAX_CHAINS = """  constexpr int kC = N >= 16 ? 4 : 1;
  float mc[2][kC];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) mc[r][c] = (c == 0 && !kFold) ? m[r] : -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mc[(i >> 1) & 1][(i >> 2) % kC] =
      fmaxf(mc[(i >> 1) & 1][(i >> 2) % kC], s[i]);
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = mc[r][0];
#pragma unroll
    for (int c = 1; c < kC; ++c) mx[r] = fmaxf(mx[r], mc[r][c]);
  }
"""
SUM = """#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(kFold ? fmaf(s[i], scale, -m_use[r]) : s[i] - m_use[r]);
    l[r] += s[i];
  }
"""
SUM_CHAINS = """  float lc[2][kC];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) lc[r][c] = c == 0 ? l[r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(kFold ? fmaf(s[i], scale, -m_use[r]) : s[i] - m_use[r]);
    lc[r][(i >> 2) % kC] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = lc[r][0];
#pragma unroll
    for (int c = 1; c < kC; ++c) l[r] += lc[r][c];
  }
"""
# Each variant: the package source's text with these (old, new) pairs.
VARIANTS = {
    "one_block_128_keys": [
        (TILES, "static constexpr int kBN = D == 256 ? 64 : 128;"),
        (BLOCKS, "static constexpr int kBlocks = 1;")],
    "one_block_64_keys": [(BLOCKS, "static constexpr int kBlocks = 1;")],
    "two_blocks_split_chains": [(MAX, MAX_CHAINS), (SUM, SUM_CHAINS)],
}


def build(name: str, edits) -> Path:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{SOURCE.name} no longer holds {old!r}")
        text = text.replace(old, new)
    text = text.replace('#include "sm90_common.cuh"',
                        f'#include "{SOURCE.parent / "sm90_common.cuh"}"')
    src = _build.BUILD_DIR / f"fwd_sm90_variant_{name}.cu"
    src.write_text(text)
    out = _build.BUILD_DIR / f"libfwd_sm90_variant_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = {n: ex.submit(build, n, e) for n, e in VARIANTS.items()}
        fns = {"two_blocks (the package)": fa._sm90_fwd_kernel_fn()}
        for name, lib in built.items():
            fn = ctypes.CDLL(str(lib.result())).hvt_flash_fwd_sm90
            fn.argtypes, fn.restype = fa._FWD_ARGTYPES, ctypes.c_int
            fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = ((dict(), 2, 150, 300), (dict(causal=True), 2, 333, 333),
             (dict(kv_len=250), 2, 150, 300),
             (dict(causal=True, kv_offset=100), 1, 70, 70),
             (dict(causal=True, sm_scale=-0.1, kv_len=290), 1, 150, 300),
             (dict(causal=True), 1, 1030, 1030))
    for name, fn in fns.items():
        fa._sm90_fwd_fn = fn
        for d in (8, 16, 24, 32, 48):
            for kw, b, sq, skv in cases:
                q, k, v = cs.qkv_views(gen, b, sq, skv, 3, d)
                kw = dict(kw, layout="bsm", n_heads=3)
                with torch.no_grad():
                    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
                    ref_o, ref_l = fa.flash_attention_reference(q, k, v, **kw)
                torch.cuda.synchronize()
                fin = ~torch.isneginf(ref_l)
                err_o = (out.float() - ref_o.float()).abs().max().item()
                err_l = ((lse[fin] - ref_l[fin]).abs().max().item()
                         if fin.any() else 0.0)
                if not (err_o <= cs.OUT_TOL and err_l <= cs.LSE_TOL
                        and torch.equal(torch.isneginf(lse),
                                        torch.isneginf(ref_l))):
                    raise AssertionError(f"{name} d={d} {kw}: out {err_o}, "
                                         f"lse {err_l}")
        print(f"[variant] {name}: every case within out {cs.OUT_TOL}, lse "
              f"{cs.LSE_TOL} of the plain version", flush=True)
    for d in (16, 32):
        h = 768 // d
        q, k, v = cs.qkv_views(gen, 8, 1024, 1024, h, d)
        q4, k4, v4 = fa._views(q, k, v, "bsm", h)
        kw = dict(causal=True, q_offset=0, kv_offset=0,
                  sm_scale=1.0 / math.sqrt(d), layout="bsm", kv_len=1024)
        call = lambda: fa._fwd_launch("sm90", q4, k4, v4, d, **kw)  # noqa: E731
        times = {n: [] for n in fns}
        for r in range(3):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                fa._sm90_fwd_fn = fns[name]
                times[name].append(cs.kernel_ms(call, 20)["flash_fwd_sm90"])
        print(f"[variant] bf16 [8, 1024, {h}, {d}] causal, device ms by "
              f"round: {json.dumps(times)}", flush=True)
    fa._sm90_fwd_fn = None
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
