"""Times the training step of two checkouts of this repository on one card,
in turns.

    python3 experiments/train_step/ab.py OTHER_DIR [--phase step|remat]
        [--rounds R]

OTHER_DIR is another checkout (e.g. the parent commit unpacked with ``git
archive`` into an ignored directory). Each run is a fresh process that
imports the package of one tree and builds its kernels; the trees run in
the order other, this, other, this, this, other, R times over (default 1).

``--phase step`` (default): chip_smoke.py's ``[train]`` configuration --
GPT-2 small, fp32 masters, bf16 compute, one seeded 8 x 1025 batch,
``make_train_step(fused_adamw(1e-4), sharded=True, fused_update=True)`` on
a one-rank NCCL world -- 3 warm-up and 40 timed steps: the median step ms
(host clock around the step and a synchronize), its quartiles, and the
median host enqueue ms (until the step returns). ``--phase remat``: that
tree's own ``chip_smoke.train_remat`` (GPT-2 small at 32 x 1024 under
each remat form): each form's peak GiB and step ms. Prints one line a run.
Needs a card and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ORDER = ("other", "this", "other", "this", "this", "other")


def run_step():
    import numpy as np
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.parallel import dp

    _build.build_all()
    hvt.init(backend="nccl")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(hvt.convert.init_params(cfg, seed=0))

    def loss_fn(p, t):
        logits = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

    step, opt = hvt.make_train_step(loss_fn, hvt.fused_adamw(1e-4),
                                    sharded=True, fused_update=True)
    state = dp.init_state(model, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, cfg.max_len + 1))).cuda()
    for _ in range(3):
        state, _ = step(state, tokens)
    enqueue, total = [], []
    for _ in range(40):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, tokens)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
    hvt.shutdown()
    return (f"step median {np.median(total):.3f} ms (quartiles "
            f"{np.percentile(total, 25):.3f}, {np.percentile(total, 75):.3f})"
            f"; enqueue median {np.median(enqueue):.3f} ms")


def run_remat():
    import torch

    import chip_smoke
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import quantization as tq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    out = chip_smoke.train_remat(hvt, (fa, fadam, tq))
    return "; ".join(f"{k} {r['peak_gib']:.3f} GiB {r['step_ms']:.2f} ms"
                     for k, r in out["runs"].items())


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        root, phase, label = argv[1:4]
        sys.path.insert(0, root)
        os.chdir(root)
        line = run_step() if phase == "step" else run_remat()
        print(f"[ab] {label}: {line}", flush=True)
        os._exit(0)
    other = os.path.abspath(argv[0])
    phase = argv[argv.index("--phase") + 1] if "--phase" in argv else "step"
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv \
        else 1
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rc = 0
    for label in ORDER * rounds:
        root = other if label == "other" else this
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__),
                               "--child", root, phase, label])
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
