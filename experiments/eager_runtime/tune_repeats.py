"""How much the runtime's ParameterManager's pick varies, on the card.

Runs ``chip_smoke.py``'s ``[hvd-torch-tune]`` phase (GPT-2 small, seed-0
weights, 8 x 1024 tokens under ``hvd.DistributedOptimizer(AdamW)`` on a
runtime started with ``HVT_AUTOTUNE=1``, then the wrapped step at the
tuned and the default knobs in turns) ``--repeats`` times in one process
for each window length in ``--steps-per-sample`` (busy cycles a window,
``HVT_AUTOTUNE_STEPS_PER_SAMPLE``). Each phase starts a fresh runtime and
manager, so each repeat is a whole tuning run. Prints one JSON line: the
card, and each run's tuned knobs, scored windows, steps to converge, and
the default and tuned step medians.

    python3 experiments/eager_runtime/tune_repeats.py [--repeats 3]
        [--steps-per-sample 10 40]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps-per-sample", type=int, nargs="+", default=[10])
    args = ap.parse_args()
    import torch

    import chip_smoke
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import quantization as tq

    if not torch.cuda.is_available():
        print("tune_repeats: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    out = {"card": chip_smoke.card_line(), "runs": []}
    for sps in args.steps_per_sample:
        os.environ["HVT_AUTOTUNE_STEPS_PER_SAMPLE"] = str(sps)
        for i in range(args.repeats):
            rec = chip_smoke.hvd_tune_phase(hvt, (fa, fadam, tq))
            out["runs"].append({
                "steps_per_sample": sps, "repeat": i,
                "converged": rec["converged"],
                "tune_steps": rec["tune_steps"],
                "windows": len(rec["samples"]), "tuned": rec["tuned"],
                "step_ms": rec["step_ms"],
                "fused_batches_median": {
                    k: float(sorted(v)[len(v) // 2])
                    for k, v in rec["fused_batches"].items()},
                "idle_share": {k: rec["profile"][k]["idle_share"]
                               for k in rec["profile"]}})
    os.environ.pop("HVT_AUTOTUNE_STEPS_PER_SAMPLE")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
