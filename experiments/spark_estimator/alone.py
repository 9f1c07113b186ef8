"""chip_smoke.py's [spark-estimator] phase alone, repeated, on the card.

Builds the kernels and runs ``chip_smoke.spark_estimator_phase`` (GPT-2
small, seed-0 weights, fitted by ``horovod_tpu_torch.spark.ParamsEstimator``
at 8 x 1024 for 2 epochs of 3 steps, every gate of the phase) ``--repeats``
times in one process, to set the phase's step time in a fresh process
beside the one it reads at the end of the whole script. Prints one JSON
line: each repeat's step median, steps, checkpoint writes, fit seconds,
the fit's peak allocated bytes and wall seconds, and the card's name and
power limit.

    python3 experiments/spark_estimator/alone.py [--repeats 3]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import quantization as tq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    runs = [cs.spark_estimator_phase(hvt, (fa, fadam, tq))
            for _ in range(args.repeats)]
    keep = ("step_ms", "step_ms_all", "ckpt_write_s", "fit_s",
            "fit_peak_bytes", "seconds", "losses")
    print(json.dumps({"card": cs.card_line(),
                      "runs": [{k: r[k] for k in keep} for r in runs]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
