"""Where a DistributedOptimizer step's extra host time goes, on the card.

Trains GPT-2 small (seed-0 weights, 8 x 1024 tokens) with
``hvd.DistributedOptimizer(torch.optim.AdamW)`` on a one-rank world and
times, per step (median of --steps after 3 warm-up steps), the step, and
the parts of the runtime's background thread: its cycles, the negotiation,
the fusion pass, ``_perform`` and inside it the NCCL allreduce calls and
the fused copies, and the hooks' enqueues; the same model unwrapped is
timed in the same process for the plain step. Then one NCCL allreduce of
4 bytes on the runtime's own group, alone and with a second Python thread
busy, in microseconds a call.

    python3 experiments/eager_runtime/step_parts.py [--no-flight-recorder]

``--no-flight-recorder`` sets ``TORCH_NCCL_TRACE_BUFFER_SIZE=0`` before
the NCCL group exists: the group's flight recorder then gathers no Python
traceback (which takes the GIL) at each collective. Prints one JSON line.
"""

import argparse
import collections
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-flight-recorder", action="store_true")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if args.no_flight_recorder:
        os.environ["TORCH_NCCL_TRACE_BUFFER_SIZE"] = "0"
    import numpy as np
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvt
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import native
    from horovod_tpu_torch.native import runtime as rtm
    from horovod_tpu_torch.ops import _build

    _build.build_all()
    spent = collections.defaultdict(float)
    calls = collections.defaultdict(int)

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
        return wrapper

    for name in ("_cycle", "_perform", "_reduce"):
        setattr(rtm.Runtime, name, timed(name, getattr(rtm.Runtime, name)))
    rtm.LocalController.negotiate = timed(
        "negotiate", rtm.LocalController.negotiate)
    rtm.fuse_responses = timed("fuse", rtm.fuse_responses)
    native.allreduce_async = timed("hook_enqueue", native.allreduce_async)
    foreach_copy = torch._foreach_copy_

    def copies(*a, **k):
        if threading.current_thread().name != "hvt-runtime":
            return foreach_copy(*a, **k)
        return timed("fused_copies", foreach_copy)(*a, **k)

    torch._foreach_copy_ = copies
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, cfg.max_len + 1), dtype=np.int64)).cuda()

    def step(model, opt):
        opt.zero_grad()
        logits = model(tokens[:, :-1])
        F.cross_entropy(logits.flatten(0, 1),
                        tokens[:, 1:].flatten()).backward()
        opt.step()

    hvd.init()
    out = {"card": os.popen("nvidia-smi --query-gpu=name,power.limit "
                            "--format=csv,noheader").read().strip(),
           "flight_recorder": not args.no_flight_recorder}
    for wrap in (False, True):
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(sd0)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
        if wrap:
            opt = hvd.DistributedOptimizer(
                opt, named_parameters=model.named_parameters())
        for _ in range(3):
            step(model, opt)
        torch.cuda.synchronize()
        spent.clear()
        calls.clear()
        times = []
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, opt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        key = "wrapped" if wrap else "plain"
        out[key] = {"step_ms": float(np.median(times)), "step_ms_all": times}
        if wrap:
            out[key]["parts_ms_a_step"] = {
                k: v / args.steps * 1e3 for k, v in spent.items()}
            out[key]["calls_a_step"] = {
                k: v / args.steps for k, v in calls.items()}
        del model, opt
        torch.cuda.empty_cache()
    # One NCCL allreduce on the runtime's own group, alone and beside a
    # busy Python thread.
    rt = native.get_runtime()
    x = torch.ones(1, device="cuda")

    def per_call(n):
        with torch.cuda.stream(rt.stream):
            rt._reduce(rt.nccl, x, native.SUM)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                rt._reduce(rt.nccl, x, native.SUM)
            dt = (time.perf_counter() - t0) / n * 1e6
            torch.cuda.synchronize()
        return dt

    out["nccl_4B_us"] = per_call(200)
    stop = threading.Event()

    def busy():
        n = 0
        while not stop.is_set():
            n += 1

    th = threading.Thread(target=busy)
    th.start()
    out["nccl_4B_us_beside_a_busy_thread"] = per_call(20)
    stop.set()
    th.join()
    hvd.shutdown()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
