"""Times chip_smoke.py's ``[train-overlap]`` step on one card under three
settings, each in a fresh process, in turns.

    python3 experiments/train_step/overlap_order.py [--rounds R]

The settings: ``off`` (``overlap=False``), ``agreed`` (``overlap=True``:
pack order in the first step, then the order the buckets became whole in
it) and ``pack`` (``overlap=True`` with the issue order held at pack
order, by replacing ``BucketScheduler.agree_order``). The configuration is
``[train-overlap]``'s: GPT-2 small, fp32 masters, bf16 compute, per-block
``dots_saveable``, 32 x 1024 tokens in 4 microbatches, replicated
``adamw(1e-4)``, the batch fed by ``prefetch_to_device(depth=2)`` on a
one-rank NCCL world; 2 warm-up and 12 timed steps. Each run prints the
median step ms (between synchronizations, the loss read inside), its
quartiles, the median host ms until the step returns, and the median host
ms a step spends issuing buckets (``BucketScheduler._issue``). The
settings run in the order agreed, pack, off, off, pack, agreed, R times
over (default 1). Needs a card and nvcc.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import subprocess
import sys
import time

ORDER = ("agreed", "pack", "off", "off", "pack", "agreed")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(setting: str) -> str:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _build, layout
    from horovod_tpu_torch.parallel import dp

    if setting == "pack":
        layout.BucketScheduler.agree_order = (
            lambda self: list(range(self.plan.n_buckets)))
    issuing = [0.0]
    issue = layout.BucketScheduler._issue

    def timed_issue(self, b):
        t = time.perf_counter()
        issue(self, b)
        issuing[0] += time.perf_counter() - t

    layout.BucketScheduler._issue = timed_issue
    _build.build_all()
    hvt.init(backend="nccl")
    cfg0 = hvt.GPT2Config.small(param_dtype=torch.float32)
    model = hvt.GPT2LMModel(dataclasses.replace(cfg0, remat="dots_saveable"))
    model.load_state_dict(hvt.convert.init_params(cfg0, seed=0))
    tokens = np.random.default_rng(13).integers(
        0, cfg0.vocab_size, (32, cfg0.max_len + 1), dtype=np.int64)
    step, opt = hvt.make_train_step(chip_smoke.train_loss(model),
                                    hvt.adamw(1e-4), accum_steps=4,
                                    overlap=setting != "off")
    state = dp.init_state({n: p.detach().clone()
                           for n, p in model.named_parameters()}, opt)
    feed = hvt.prefetch_to_device(itertools.repeat(tokens, 14), depth=2)
    enqueue, total, issued = [], [], []
    for i in range(14):
        torch.cuda.synchronize()
        issuing[0] = 0.0
        t0 = time.perf_counter()
        state, loss = step(state, next(feed))
        t1 = time.perf_counter()
        float(loss)
        torch.cuda.synchronize()
        if i >= 2:
            enqueue.append((t1 - t0) * 1e3)
            total.append((time.perf_counter() - t0) * 1e3)
            issued.append(issuing[0] * 1e3)
    hvt.shutdown()
    return (f"step median {np.median(total):.3f} ms (quartiles "
            f"{np.percentile(total, 25):.3f}, {np.percentile(total, 75):.3f})"
            f"; enqueue median {np.median(enqueue):.3f} ms; issuing median "
            f"{np.median(issued):.3f} ms")


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        os.chdir(ROOT)
        print(f"[order] {argv[1]}: {run(argv[1])}", flush=True)
        os._exit(0)
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv \
        else 1
    rc = 0
    for setting in ORDER * rounds:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__),
                               "--child", setting])
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
