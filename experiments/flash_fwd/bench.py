"""Times the flash forward's design variants on one card, in turns.

    python3 experiments/flash_fwd/bench.py    # from the repository root

Builds, with the package's nvcc flags, into horovod_tpu_torch/_build/:
the non-persistent variants of experiments/flash_fwd/variants.cu (intra-
warpgroup overlap alone, ping-pong, the folded scale, both), the package's
persistent kernel with the folded scale switched off (a copy of
horovod_tpu_torch/csrc/flash_fwd.cu with its choice set to false), and the
package's own library. Each is called through its C entry point on the
same inputs (GPT-2 small's attention, B=8 and 16, S=1024, H=12, D=64,
causal; q/k/v column views of one fused projection), held against the
plain version (out 1e-2, lse 1e-3), and timed by CUDA events and, three
times, by device time under torch.profiler, in the order listed and then
in reverse. SDPA's forward (the yardstick) and the package's wrapper
(events and host microseconds a call) are timed beside them. Needs a card
and nvcc.
"""

from __future__ import annotations

import ctypes
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

HERE = Path(__file__).resolve().parent
VARIANTS = {
    "one_block_a_tile": ["-DPP=0", "-DFOLD=0"],
    "one_block_a_tile_pingpong": ["-DPP=1", "-DFOLD=0"],
    "one_block_a_tile_fold": ["-DPP=0", "-DFOLD=1"],
    "one_block_a_tile_pingpong_fold": ["-DPP=1", "-DFOLD=1"],
}


def build(name: str, flags, source: Path) -> Path:
    out = _build.BUILD_DIR / f"libfwd_variant_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                           str(out), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return out


def persistent_without_fold() -> Path:
    text = (ROOT / "horovod_tpu_torch/csrc/flash_fwd.cu").read_text()
    choice = "const bool fold = p.scale_log2 > 0.f;"
    if choice not in text:
        raise RuntimeError("flash_fwd.cu no longer picks the fold there")
    text = text.replace(choice, "const bool fold = false;").replace(
        '#include "sm90_common.cuh"',
        f'#include "{ROOT / "horovod_tpu_torch/csrc/sm90_common.cuh"}"')
    src = _build.BUILD_DIR / "fwd_variant_persistent_nofold.cu"
    src.write_text(text)
    return build("persistent_nofold", [], src)


def entry(path: Path, with_device: bool):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(str(path)).hvt_flash_fwd_bf16
    fn.argtypes = ([ptr] * 5 + [i32] * 5 + [ptr]
                   + [i32, i32, i32, ctypes.c_float, i32]
                   + ([i32] if with_device else []) + [ptr])
    fn.restype = i32
    return fn, with_device


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as ex:
        built = {n: ex.submit(build, n, f, HERE / "variants.cu")
                 for n, f in VARIANTS.items()}
        nofold = ex.submit(persistent_without_fold)
        _build.build_all([fa.KERNEL_SOURCE])
        fns = {n: entry(b.result(), False) for n, b in built.items()}
    fns["persistent_pingpong"] = entry(nofold.result(), True)
    fns["persistent_pingpong_fold (the package)"] = entry(
        _build._library_path(fa.KERNEL_SOURCE), True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, d, s = 12, 64, 1024
    for b in (8, 16):
        q, k, v = cs.qkv_views(gen, b, s, s, h, d)
        kw = dict(causal=True, layout="bsm", n_heads=h)
        ref_o, ref_l = fa.flash_attention_reference(q, k, v, **kw)
        q4, k4, v4 = fa._views(q, k, v, "bsm", h)
        out = torch.empty((b, s, h * d), dtype=torch.bfloat16, device="cuda")
        o4 = out.view(b, s, h, d)
        lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        strides = (ctypes.c_longlong * 12)(
            *[x for t in (q4, k4, v4, o4) for x in fa._map_strides(t)])
        stream = torch.cuda.current_stream().cuda_stream
        args = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
                lse.data_ptr(), b, h, s, s, d, strides, s, 0, 0,
                1.0 / d ** 0.5, 1)
        for name in list(fns) + list(fns)[::-1]:
            fn, with_device = fns[name]
            full = args + ((0, stream) if with_device else (stream,))
            call = lambda: fn(*full)  # noqa: E731
            if call() != 0:
                raise RuntimeError(f"{name} failed to launch")
            torch.cuda.synchronize()
            err_o = (out.float() - ref_o.float()).abs().max().item()
            err_l = (lse - ref_l).abs().max().item()
            if not (err_o <= cs.OUT_TOL and err_l <= cs.LSE_TOL):
                raise AssertionError(f"{name}: out {err_o}, lse {err_l}")
            ev = cs.time_ms(call)
            dev = [cs.kernel_ms(call, 20)["flash_fwd"] for _ in range(3)]
            print(f"[variant] B={b} {name}: events {ev:.4f} ms, device "
                  f"{', '.join(f'{x:.4f}' for x in dev)} ms; max|d out| "
                  f"{err_o:.2e}, max|d lse| {err_l:.2e}", flush=True)
        qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=True)
        print(f"[variant] B={b} sdpa: events {cs.time_ms(sdpa):.4f} ms, device "
              f"{cs.device_ms(sdpa):.4f} ms", flush=True)
        wrapper = lambda: fa.flash_attention_with_lse(q, k, v, **kw)  # noqa: E731
        print(f"[variant] B={b} the package's wrapper: events "
              f"{cs.time_ms(wrapper):.4f} ms, host {cs.host_us(wrapper):.1f} "
              f"us a call", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
