"""Times kernel 7 against the kernel it replaced on one card, in turns.

    python3 experiments/int8_matmul/bench.py PARENT.cu   # from the repo root

PARENT.cu is a kernel-7 source with the C interface it had before the
Hopper redesign (``hvt_int8_matmul(x, w, scales, out, m, n, k, rows_inner,
x_so, x_si, ldw, x_bf16, stream)``), e.g. an earlier commit's
``horovod_tpu_torch/csrc/int8_matmul.cu`` written out to an ignored
directory. It is built with the package's nvcc flags into
horovod_tpu_torch/_build/; the package's own kernel runs through its
wrapper.

At GPT-2 small's four serving products (768 -> 2304, 768 -> 768, 768 ->
3072, 3072 -> 768; bf16 x as the model's [B, S, K]) at M = 8192 and M = 8,
each kernel is held against the plain version (8e-3 of the largest value)
and timed by device time under torch.profiler and by CUDA events, in the
order parent, package, package, parent; the bf16 ``F.linear`` of the
dequantized weight (cuBLAS) beside them. Prints one JSON line a product
(every timing) and one a batch (each product's fastest timing times its 12
launches). Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import quantization as tq  # noqa: E402

PRODUCTS = (("qkv", 768, 2304), ("out", 768, 768), ("fc", 768, 3072),
            ("proj", 3072, 768))
LAYERS = 12


def build(name: str, source: Path) -> ctypes.CDLL:
    out = _build.BUILD_DIR / f"libint8_matmul_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           "-I", str(_build.SRC_DIR), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def parent_call(lib, x, qw):
    """The parent's kernel on x [B, S, K] (contiguous) and qw."""
    fn = lib.hvt_int8_matmul
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [ptr] * 4 + [i32] * 4 + [i64] * 3 + [i32, ptr]
    fn.restype = ctypes.c_int
    k, n = qw.q.shape
    m = x.numel() // k
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)

    def call():
        rc = fn(x.data_ptr(), qw.q.data_ptr(), qw.scales.data_ptr(),
                out.data_ptr(), m, n, k, m, 0, k, qw.q.stride(1), 1,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent kernel refused: {rc}")
        return out

    return call


def check(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    if not rel <= 8e-3:
        raise AssertionError(f"relative error {rel}")
    return rel


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    parent = build("parent", Path(sys.argv[1]))
    order = ["parent", "this", "this", "parent", "flinear"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m in (8192, 8):
        tot = {}
        for name, k, n in PRODUCTS:
            x = torch.randn((8, m // 8, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            qw = tq.quantize_weight(
                torch.randn((k, n), generator=gen, device="cuda") * 0.02)
            w16 = tq.dequantize_weight(qw).t().contiguous().to(torch.bfloat16)
            x2 = x.reshape(m, k)
            ref = tq.int8_weight_matmul_reference(x, qw).reshape(m, n)
            rec = {"m": m, "product": name, "k": k, "n": n}
            fns = {"parent": parent_call(parent, x, qw),
                   "this": lambda: tq.int8_weight_matmul(x, qw),
                   "flinear": lambda: F.linear(x2, w16)}
            for key in ("parent", "this"):
                rec[f"rel_err_{key}"] = check(fns[key]().reshape(m, n), ref)
            for key in order:
                rec.setdefault(f"{key}_device_ms", []).append(
                    cs.device_ms(fns[key], calls=20))
                rec.setdefault(f"{key}_ms", []).append(cs.time_ms(fns[key]))
            for key in fns:
                for kind in ("device_ms", "ms"):
                    tot[f"{key}_{kind}"] = (tot.get(f"{key}_{kind}", 0.0)
                                            + LAYERS * min(rec[f"{key}_{kind}"]))
            print(json.dumps(rec), flush=True)
        tot.update(m=m, launches=LAYERS * len(PRODUCTS))
        for key in ("this", "flinear"):
            tot[f"{key}_over_parent_device"] = (tot[f"{key}_device_ms"]
                                                / tot["parent_device_ms"])
        print(json.dumps({"batch_sum": tot}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
