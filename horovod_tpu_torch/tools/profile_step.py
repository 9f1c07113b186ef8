"""Device-trace profiler for the benchmark training steps.

The port of the JAX package's ``tools/profile_step.py``: it builds the
ResNet-50 (128 images of 224 x 224 a rank, bf16 compute, SGD with momentum
0.9) or BERT-base (32 x 512, full-logit MLM loss, AdamW 1e-4) training step
through :func:`~..parallel.dp.make_train_step`, warms it up, and records
five steps with ``torch.profiler`` (CPU and CUDA activities). It prints the
category rollup and the top-K kernels by self device time, and -- what the
JAX package's tool cannot give -- the **idle share** of the window: the
part of the five steps' wall time (the ``profile_step.window`` range,
closed by a ``torch.cuda.synchronize``) in which no kernel, copy or memset
ran on the card.

The JAX package converts an xplane through TensorFlow's converter and
raises ``ConverterUnavailable`` without it; ``torch.profiler`` reads the
device trace itself (CUPTI), so there is no converter and no such error
here. :func:`categorize` is the JAX package's, with the port's own kernels
and the CUDA libraries' kernel names in front of its patterns.

It also attributes device time to **scopes** of the model, forward and
backward: ResNet-50's ``BatchNorm`` modules, BERT's ``mlm_decoder`` and
each model's loss. A scope's forward runs inside a ``record_function``
range (forward hooks on its modules); a backward kernel belongs to the
scope whose forward op recorded its autograd node, matched by the
profiler's sequence numbers. A kernel counts where the profiler links it
to the operator that launched it; ``linked_us`` is the device time so
linked, beside the device total.

Usage::

    python -m horovod_tpu_torch.tools.profile_step --model bert [--top 40]
        [--json rows.json]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

STEPS = 5
WINDOW = "profile_step.window"
SCOPE = "profile_step.scope."

# The modules whose device time the rollup attributes, by model: a
# module's scope label, or None.
SCOPED_MODULES = {
    "resnet50": lambda name, mod: ("batchnorm"
                                   if type(mod).__name__ == "BatchNorm"
                                   else None),
    "bert": lambda name, mod: ("mlm_decoder" if name == "mlm_decoder"
                               else None),
}

# Order matters: the first match wins. The port's own kernels and the
# library GEMM/convolution kernels come first, then the JAX package's
# patterns (collectives before the bare "reduce" of its BN bucket).
CATEGORIES = (
    ("flash", re.compile(r"flash_(fwd|bwd_dq|bwd_dkdv)_kernel", re.I)),
    ("fused_adamw", re.compile(r"fused_adamw_kernel", re.I)),
    ("quant", re.compile(r"quantize_blockwise|fp8_cast_kernel", re.I)),
    ("int8/fp8 matmul", re.compile(r"(int8|fp8)_matmul", re.I)),
    ("allreduce", re.compile(
        r"all-reduce|allreduce|all-gather|allgather|reduce-scatter|"
        r"reducescatter|nccl", re.I)),
    ("conv", re.compile(
        r"convolution|conv|fprop|dgrad|wgrad|implicit_gemm|"
        r"implicit_convolve", re.I)),
    ("gemm", re.compile(r"gemm|gemv|xmma|cutlass|cublas|nvjet|matmul",
                        re.I)),
    ("bn_reduce", re.compile(r"reduce|batch_norm|bn_fw|bn_bw|welford",
                             re.I)),
    ("copy/transpose", re.compile(r"copy|transpose|memcpy|memset|cat",
                                  re.I)),
    ("elementwise", re.compile(
        r"fusion|add|multiply|select|maximum|elementwise", re.I)),
)


def categorize(name: str, category_hint: str = "") -> str:
    blob = f"{name} {category_hint}"
    for label, pat in CATEGORIES:
        if pat.search(blob):
            return label
    return "other"


def _on_device(e) -> bool:
    """An event (or a per-name average) the card ran: a kernel, copy or
    memset. A ``record_function`` range is mirrored on the device timeline
    as a user annotation spanning its kernels: not device work."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key != WINDOW)


def _device_events(prof):
    """``(name, start_us, end_us)`` of every event the card ran in the
    profile."""
    out = []
    for e in prof.events():
        if _on_device(e) and e.time_range.elapsed_us() > 0:
            out.append((e.name, float(e.time_range.start),
                        float(e.time_range.end)))
    return out


def scope_labeller(cpu_events):
    """``scope(event)``: the scope label of a host event, or None. A
    forward op belongs to the scope range around it; a backward op to the
    scope of the forward op whose autograd node it runs under (the node's
    ``fwd_thread`` and ``sequence_nr`` are the forward op's thread and
    ``sequence_nr``). An op records the sequence number the next node will
    take, whether it makes that node or not; the op that makes it is the
    last to start of those that recorded the number."""
    recorded = {}  # (forward thread, sequence_nr) -> scope label or None

    def scope(e):
        while e is not None:
            if e.name.startswith(SCOPE):
                return e.name[len(SCOPE):]
            if e.fwd_thread and (e.fwd_thread, e.sequence_nr) in recorded:
                return recorded[(e.fwd_thread, e.sequence_nr)]
            e = e.cpu_parent
        return None

    for e in sorted(cpu_events, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and not e.fwd_thread:
            recorded[(e.thread, e.sequence_nr)] = scope(e)
    return scope


def _scoped_device_us(prof) -> Tuple[Dict[str, List], float]:
    """``({label: [us, kernels]}, linked_us)``: the device time of each
    scope, forward and backward, and the device time the profiler links to
    any operator at all. The profiler appends a launch's kernels to every
    host event of its correlation id, its own overhead events (a full
    command buffer) included: each id's kernels count once, under the scope
    of any of its events."""
    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    scope = scope_labeller(cpu)
    launches: Dict[int, List] = {}  # correlation id -> its host events
    for e in cpu:
        if e.kernels:
            launches.setdefault(e.id, []).append(e)
    scopes: Dict[str, List] = {}
    linked = 0.0
    for events in launches.values():
        kernels = events[0].kernels
        us = float(sum(k.duration for k in kernels))
        linked += us
        label = next((x for x in map(scope, events) if x is not None), None)
        if label is not None:
            row = scopes.setdefault(label, [0.0, 0])
            row[0] += us
            row[1] += len(kernels)
    return scopes, linked


def _window(prof) -> Optional[Tuple[float, float]]:
    """The window's host range (its CPU-side ``record_function`` event)."""
    from torch.autograd import DeviceType

    for e in prof.events():
        if e.name == WINDOW and e.device_type == DeviceType.CPU:
            return float(e.time_range.start), float(e.time_range.end)
    return None


def _busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``intervals`` (streams may overlap)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(prof, steps: int = STEPS) -> Dict:
    """The rollup of a profile: per-kernel self device time, categories,
    the window's busy and idle shares, and the profiler's own total
    (``key_averages``' self device time) to hold the categories against."""
    events = _device_events(prof)
    win = _window(prof)
    per_name: Dict[str, List[float]] = {}
    for name, s, e in events:
        per_name.setdefault(name, []).append(e - s)
    kernels = sorted(((sum(ts), len(ts), n) for n, ts in per_name.items()),
                     reverse=True)
    cats: Dict[str, List] = {}
    for t, count, name in kernels:
        c = cats.setdefault(categorize(name), [0.0, 0])
        c[0] += t
        c[1] += count
    # The profiler's own total: its per-name averages of the device rows.
    device_us = 0.0
    for e in prof.key_averages():
        if _on_device(e):
            device_us += float(getattr(e, "self_device_time_total", 0.0) or
                               getattr(e, "self_cuda_time_total", 0.0) or 0.0)
    scopes, linked_us = _scoped_device_us(prof)
    out = {
        "steps": steps,
        "kernels": [{"name": n, "us": t, "count": c}
                    for t, c, n in kernels],
        "categories": {k: {"us": v[0], "count": v[1]}
                       for k, v in sorted(cats.items(),
                                          key=lambda kv: -kv[1][0])},
        "category_us": sum(v[0] for v in cats.values()),
        "device_us": device_us,
        "scopes": {k: {"us": v[0], "count": v[1]}
                   for k, v in sorted(scopes.items(),
                                      key=lambda kv: -kv[1][0])},
        "linked_us": linked_us,
        "window_us": None, "busy_us": None, "idle_share": None,
    }
    if win is not None and events:
        lo, hi = win
        clipped = [(max(s, lo), min(e, hi)) for _, s, e in events
                   if e > lo and s < hi]
        busy = _busy_us(clipped)
        out["window_us"] = hi - lo
        out["busy_us"] = busy
        out["idle_share"] = 1.0 - busy / (hi - lo) if hi > lo else None
    return out


def build(model_name: str, device="cuda"):
    """``(step, state, batch, model)`` of the model's training step on
    ``device``, at the JAX package's tool's shapes. Each loss runs inside
    the ``loss`` scope."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import record_function

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.parallel import dp

    rng = np.random.default_rng(0)
    if model_name == "resnet50":
        model = hvt.ResNet50(num_classes=1000, device=device)
        model.load_state_dict(hvt.convert.init_resnet_params(model, seed=0))
        images = torch.from_numpy(rng.standard_normal(
            (128, 3, 224, 224)).astype(np.float32)).to(device)
        labels = torch.from_numpy(rng.integers(0, 1000, (128,))).to(device)

        def loss_fn(p, b):
            logits = torch.func.functional_call(model, p, (b[0],))
            with record_function(SCOPE + "loss"):
                return F.cross_entropy(logits.float(), b[1])

        opt = hvt.sgd(0.1, momentum=0.9)
        batch = (images, labels)
    elif model_name == "bert":
        cfg = hvt.BertConfig.base(param_dtype=torch.float32)
        model = hvt.BertModel(cfg, device=device)
        model.load_state_dict(hvt.convert.init_bert_params(cfg, seed=0))
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (32, 512))).to(device)
        targets = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (32, 512))).to(device)

        def loss_fn(p, batch):
            logits = torch.func.functional_call(model, p, (batch[0],))
            with record_function(SCOPE + "loss"):
                return F.cross_entropy(logits.flatten(0, 1).float(),
                                       batch[1].flatten())

        opt = hvt.adamw(1e-4)
        batch = (tokens, targets)
    else:
        raise SystemExit(f"unknown model {model_name}")
    step, wrapped = dp.make_train_step(loss_fn, opt, device=device)
    state = dp.init_state(model, wrapped)
    return step, state, batch, model


def scope_modules(model, label_of) -> int:
    """Run the forward of every module ``label_of(name, module)`` labels
    inside a ``record_function`` range of its scope; returns how many."""
    from torch.profiler import record_function

    def enter(mod, args):
        mod._profile_scope = record_function(SCOPE + mod._profile_label)
        mod._profile_scope.__enter__()

    def leave(mod, args, out):
        mod._profile_scope.__exit__(None, None, None)

    n = 0
    for name, mod in model.named_modules():
        label = label_of(name, mod)
        if label is not None:
            mod._profile_label = label
            mod.register_forward_pre_hook(enter)
            mod.register_forward_hook(leave)
            n += 1
    return n


def profile(model_name: str, steps: int = STEPS):
    """Build the step (:func:`build`), scope its modules, warm it up, then
    record ``steps`` steps; returns ``(summary, losses, flash_launches)``
    where ``flash_launches`` counts the port's flash kernels launched
    inside the window. The step runs where :func:`build` put its batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    from horovod_tpu_torch.ops import flash_attention as fa

    step, state, batch, model = build(model_name)
    scope_modules(model, SCOPED_MODULES.get(model_name, lambda n, m: None))
    dev = batch[0].device
    on_card = dev.type == "cuda"
    for _ in range(2):  # first calls: allocator, cuDNN plans, kernel loads
        state, loss = step(state, batch)
    if on_card:
        torch.cuda.synchronize(dev)
    fa.reset_launches()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    losses = []
    with tprofile(activities=activities) as prof:
        with record_function(WINDOW):
            for _ in range(steps):
                state, loss = step(state, batch)
                losses.append(loss)
            if on_card:
                torch.cuda.synchronize(dev)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dkdv": fa.launches_dkdv,
                "flash_bwd_dq": fa.launches_dq}
    return summarize(prof, steps), [float(x) for x in losses], launches


def report(summary: Dict, top: int = 40) -> str:
    lines = []
    total = summary["device_us"]
    lines.append(f"total self device time: {total / 1e3:.3f} ms over "
                 f"{len(summary['kernels'])} kernels ({summary['steps']} "
                 "steps)")
    if summary["idle_share"] is not None:
        lines.append(
            f"window {summary['window_us'] / 1e3:.3f} ms, device busy "
            f"{summary['busy_us'] / 1e3:.3f} ms, idle share "
            f"{summary['idle_share']:.4f}")
    if summary["scopes"] or summary["linked_us"]:
        lines.append(
            f"scopes, forward and backward (linked to an operator "
            f"{summary['linked_us'] / 1e3:.3f} ms of the device time):")
        for k, v in summary["scopes"].items():
            lines.append(f"  {k:16s} {v['us'] / 1e3:9.3f} ms  "
                         f"({v['us'] / (total or 1.0) * 100:5.1f}%)  "
                         f"[{v['count']} launches]")
    lines.append("category rollup:")
    cat_total = summary["category_us"] or 1.0
    for k, v in summary["categories"].items():
        lines.append(f"  {k:16s} {v['us'] / 1e3:9.3f} ms  "
                     f"({v['us'] / cat_total * 100:5.1f}%)  "
                     f"[{v['count']} launches]")
    lines.append(f"top {top} kernels by self device time:")
    for k in summary["kernels"][:top]:
        lines.append(f"  {k['us'] / 1e3:8.3f} ms  x{k['count']:<5d} "
                     f"[{categorize(k['name']):16s}] {k['name'][:140]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.profile_step")
    ap.add_argument("--model", default="resnet50",
                    choices=("resnet50", "bert"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--json", help="write the summary (all kernels) here")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    summary, losses, launches = profile(args.model)
    summary["losses"] = losses
    summary["flash_launches"] = launches
    summary["model"] = args.model
    print(report(summary, args.top))
    print(f"losses {losses}; flash launches in the window {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f)
        print(f"summary written to {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
