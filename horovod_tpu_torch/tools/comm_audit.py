"""Communication audit of the port's data-parallel step.

The port of the per-step half of the JAX package's ``tools/comm_audit.py``:
what the framework puts on the wire for each benched model's training
step at a simulated world of 8 ranks — bytes per step, collective count,
bucket layout — read from a fake-tensor record of the exact step
``parallel.dp.make_train_step`` builds (:mod:`horovod_tpu_torch.analysis.
record`): nothing executes, no process group exists, and a full-size model
costs its parameters' host memory and seconds of recording.

* :func:`lint_audit` (``--lint``) — the static fusion-parity audit: the
  predicted buckets (:func:`..ops.fusion.bucket_byte_layout`, or
  :func:`..ops.fusion.quantized_bucket_layout` on a quantized wire), the
  recorded collectives, their ring-wire bytes and the analysis plane's
  findings (``parity_ok``: no ``fusion-parity`` finding; ``clean``: none
  at all).
* :func:`audit` (default) — the same record plus the timeline's
  ``FUSE_BUCKETS`` layout, where the JAX package scans compiled HLO: the
  collectives by kind, their result bytes and the ring-wire model
  (:func:`_ring_wire_bytes`).
* ``--parity`` (ZeRO-1 against replicated ring-wire bytes, <= 1.1x) and
  ``--microbatch-parity`` (the same wire bytes at ``accum`` 1 and K);
  ``--quant int8|fp8`` audits the step on the quantized wire.

Each call builds and records the step afresh, so a full-size model's host
memory goes with the call. Inside :func:`shared_recordings` a
configuration is built and recorded once and both rows come from that one
record.

Run::

    python -m horovod_tpu_torch.tools.comm_audit --model gpt2 --lint --sharded
    python -m horovod_tpu_torch.tools.comm_audit --model gpt2 --parity
    python -m horovod_tpu_torch.tools.comm_audit --model gpt2 --microbatch-parity

The JAX tool's topology parts — ``ici_specs``, ``audit_topology``
(``--topology``), ``model_scaling`` and ``--write-scaling-json`` — model a
TPU torus and its ICI links; they are not ported here.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import tempfile
from typing import Optional

# Benched model key -> (zoo model, harness size). The harness's "small"
# shapes are the benchmark's: GPT-2 small 16 x 1024, BERT-base MLM 32 x
# 512, ResNet-50 128 x 224, each rank 1/8 of the global batch (the
# harness's world of 8, the audit's default).
MODELS = {
    "bert_base_mlm_32x512": ("bert", "small"),
    "gpt2_small_16x1024": ("gpt2", "small"),
    "resnet50_128x224": ("resnet50", "small"),
}
N_DEVICES = 8

# The record's collective kinds under the HLO names the ring model reads.
_HLO_KIND = {
    "psum": "all-reduce", "psum_invariant": "all-reduce",
    "pmax": "all-reduce", "pmin": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "all_gather": "all-gather", "all_gather_invariant": "all-gather",
    "all_to_all": "all-to-all", "ppermute": "collective-permute",
}


def _resolve_compression(name):
    from horovod_tpu_torch.ops.compression import Compression

    return Compression.by_name(name) if name else Compression.none


def _base_kind(kind):
    return kind[:-6] if kind.endswith("-start") else kind


def _bytes_by_kind(ops):
    """RESULT bytes per collective kind (async -start halves folded).

    Each op's bytes are its result's: full payload for all-reduce and
    all-gather, the 1/N shard for reduce-scatter."""
    out = {}
    for o in ops:
        k = _base_kind(o["kind"])
        out[k] = out.get(k, 0) + o["bytes"]
    return out


def _ring_wire_bytes(ops, n):
    """Ring-schedule bytes over the slowest link, summed over collectives.

    Raw result byte counts are biased when comparing the fused-psum path
    against the sharded reduce-scatter+all-gather path (a reduce-
    scatter's result is only the 1/N shard), so byte-parity claims use
    the ring wire model over the RESULT bytes b: all-reduce 2(n-1)/n*b,
    reduce-scatter (n-1)*b (its full input is n*b), all-gather (n-1)/n*b
    (its result is the full gathered payload), all-to-all (n-1)/n*b,
    collective-permute b. With this model reduce-scatter + all-gather of
    the same payload sums to exactly one ring allreduce.
    """
    total = 0.0
    for o in ops:
        k = _base_kind(o["kind"])
        b = o["bytes"]
        if k == "all-reduce":
            total += 2 * (n - 1) / n * b
        elif k == "reduce-scatter":
            total += (n - 1) * b
        elif k == "all-gather":
            total += (n - 1) / n * b
        elif k == "all-to-all":
            total += (n - 1) / n * b
        else:
            total += b
    return int(total)


def _build(model_key, n_devices, *, sharded=False, accum=1,
           compression=None):
    """``(step, state, batch)``: the model's DP step and its state in the
    simulated world (the harness's build, uncached so a full-size model's
    host memory goes with the audit). At ``accum`` K the batch is K
    microbatches of the rank's batch, so any K goes (the JAX tool splits
    the rank's batch and clamps K to its divisors)."""
    import torch

    from horovod_tpu_torch import optimizer as _opt
    from horovod_tpu_torch.analysis import harness
    from horovod_tpu_torch.analysis.record import simulated_world
    from horovod_tpu_torch.parallel import dp

    name, size = MODELS[model_key]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        spec = harness.BUILDERS[name](size)
    with simulated_world(n_devices):
        step, opt = dp.make_train_step(
            spec.loss_fn, _opt.adamw(1e-4), sharded=sharded,
            accum_steps=accum, lint=False,
            compression=_resolve_compression(compression),
            autotune=False, publish=0, guard=False, device="cpu")
        params = {k: v.detach().clone()
                  for k, v in spec.model.named_parameters()}
        state = dp.init_state(params, opt)
    batch = spec.batch if accum == 1 else harness._repeat(spec.batch, accum)
    return step, state, batch


def _record(step, state, batch, n_devices):
    """The step's fake-tensor record with the timeline on, and the
    ``FUSE_BUCKETS`` layouts the timeline wrote."""
    from horovod_tpu_torch.analysis.record import simulated_world
    from horovod_tpu_torch.utils import timeline as tl

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "timeline.json")
        tl.start_timeline(path)
        try:
            with simulated_world(n_devices):
                rec = step.trace(state, batch)
        finally:
            tl.stop_timeline()
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    buckets = [
        e["args"] for e in events
        if isinstance(e, dict) and e.get("name") == "FUSE_BUCKETS"
    ]
    return rec, buckets


def _ops(rec):
    return [{"kind": _HLO_KIND.get(s.kind, s.kind), "bytes": s.out_bytes}
            for s in rec.collectives]


# Rows by configuration while a shared_recordings() scope is open.
_SHARED: Optional[dict] = None


@contextlib.contextmanager
def shared_recordings():
    """Within this scope each configuration (model, world, ``sharded``,
    ``accum``, compression) is built and recorded once: :func:`audit` and
    :func:`lint_audit` both read that one record, and later calls reuse
    the rows. Only the rows are kept, not the model or its record."""
    global _SHARED
    outer, _SHARED = _SHARED, {} if _SHARED is None else _SHARED
    try:
        yield
    finally:
        _SHARED = outer


def _rows(want, model_key, n_devices, sharded, accum, compression):
    """Row ``want`` (``"audit"`` or ``"lint"``) of one configuration:
    built and recorded here, or taken from the open shared scope."""
    key = (model_key, n_devices, sharded, accum, compression)
    if _SHARED is not None and key in _SHARED:
        return copy.deepcopy(_SHARED[key][want])
    step, state, batch = _build(model_key, n_devices, sharded=sharded,
                                accum=accum, compression=compression)
    rec, buckets = _record(step, state, batch, n_devices)
    kinds = ("audit", "lint") if _SHARED is not None else (want,)
    rows = {k: _ROW[k](key, state, rec, buckets) for k in kinds}
    if _SHARED is not None:
        _SHARED[key] = copy.deepcopy(rows)
    return rows[want]


def audit(model_key, n_devices=N_DEVICES, sharded=False, accum=1,
          compression=None):
    """Record the DP step at a simulated world of ``n_devices``; report
    the fusion layout from the timeline and the collectives from the
    record (the JAX tool reads the compiled HLO).

    ``sharded=True`` audits the ZeRO-1 sharded-update step; the
    reduce-scatter/all-gather bytes land in ``collective_bytes_by_kind``
    and the ring-wire model in ``ring_wire_bytes`` (the parity metric
    against the psum path — see ``--parity``). ``accum>1`` audits the
    microbatched step — see ``--microbatch-parity``."""
    return _rows("audit", model_key, n_devices, sharded, accum, compression)


def _audit_row(key, state, rec, buckets):
    model_key, n_devices, sharded, accum, compression = key
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in state.params.values())
    ops = _ops(rec)
    return {
        "model": model_key,
        "n_devices": n_devices,
        "sharded_update": sharded,
        "accum_steps": accum,
        "compression": compression,
        "gradient_bytes_per_step": grad_bytes,
        "fusion_buckets": buckets,
        "collective_ops": len(ops),
        "collective_bytes": sum(o["bytes"] for o in ops),
        "collective_bytes_by_kind": _bytes_by_kind(ops),
        "ring_wire_bytes": _ring_wire_bytes(ops, n_devices),
        "collective_kinds": sorted({o["kind"] for o in ops}),
        "note": (
            "fake-tensor record of the step (horovod_tpu_torch.analysis."
            "record) at a simulated world: the collectives the framework "
            "issues, each bucket one call, before any backend touches "
            "them; the timeline's FUSE_BUCKETS is the layout it asked for."
        ),
    }


def lint_audit(model_key, n_devices=N_DEVICES, sharded=False, accum=1,
               compression=None):
    """Static fusion-parity audit (``--lint``): record the DP step and
    check its fused collective groups against the bucket policy via
    :mod:`horovod_tpu_torch.analysis` — byte parity checkable on any CPU.
    Reports the predicted buckets, the recorded collectives, their
    ring-wire bytes, the findings, ``parity_ok`` and ``clean``."""
    return _rows("lint", model_key, n_devices, sharded, accum, compression)


def _lint_row(key, state, rec, buckets):
    from horovod_tpu_torch import analysis, context
    from horovod_tpu_torch.ops.compression import is_quantized
    from horovod_tpu_torch.ops.fusion import (
        bucket_byte_layout,
        quantized_bucket_layout,
    )

    del buckets
    model_key, n_devices, sharded, accum, compression = key
    comp = _resolve_compression(compression) if compression else None
    quant = comp is not None and is_quantized(comp)
    params = state.params
    wire = getattr(comp, "wire_dtype", None)
    findings = analysis.lint_traced(
        None, (state, None),
        declared_axes={context.WORLD_AXIS},
        params=params,
        sharded=sharded,
        world=n_devices,
        jaxpr=rec,
        allow_low_precision_collectives=comp is not None,
        quant=comp if quant else None,
        wire_dtype=wire,
        gather_wire_dtype=wire if sharded else None,
    )
    predicted = (
        quantized_bucket_layout(params, world=n_devices, compression=comp)
        if quant
        else [{"dtype": d, "bytes": b} for d, b in bucket_byte_layout(
            params, pad_multiple=n_devices if sharded else 1)]
    )
    return {
        "metric": "static_fusion_parity",
        "model": model_key,
        "n_devices": n_devices,
        "sharded_update": sharded,
        "accum_steps": accum,
        "compression": compression,
        "predicted_buckets": predicted,
        "recorded_collectives": [
            {"kind": s.kind, "in_bytes": s.in_bytes,
             "out_bytes": s.out_bytes}
            for s in rec.collectives
        ],
        "ring_wire_bytes": analysis.ring_wire_bytes(rec.collectives,
                                                    n_devices),
        "findings": [f.to_dict() for f in findings],
        "parity_ok": not any(f.rule == "fusion-parity" for f in findings),
        "clean": not findings,
        "note": (
            "fake-tensor record audit (horovod_tpu_torch.analysis): "
            "nothing executes — the collective groups the framework "
            "issues, checked against the bucket policy."
        ),
    }


_ROW = {"audit": _audit_row, "lint": _lint_row}


def microbatch_parity(model_key, sharded=False, k=4):
    """Wire bytes at ``accum`` 1 and K: microbatching must not multiply
    comm."""
    base = audit(model_key, sharded=sharded)
    micro = audit(model_key, sharded=sharded, accum=k)
    return {
        "metric": "microbatch_wire_parity",
        "model": model_key,
        "sharded_update": sharded,
        "accum_steps": k,
        "wire_bytes_accum1": base["ring_wire_bytes"],
        f"wire_bytes_accum{k}": micro["ring_wire_bytes"],
        "bytes_by_kind_accum1": base["collective_bytes_by_kind"],
        f"bytes_by_kind_accum{k}": micro["collective_bytes_by_kind"],
        "wire_bytes_unchanged": (base["ring_wire_bytes"]
                                 == micro["ring_wire_bytes"]),
    }


def byte_parity(model_key):
    """ZeRO-1 against replicated ring-wire bytes (<= 1.1x)."""
    base = audit(model_key)
    shard = audit(model_key, sharded=True)
    ratio = shard["ring_wire_bytes"] / max(1, base["ring_wire_bytes"])
    return {
        "metric": "collective_byte_parity",
        "model": model_key,
        "replicated_wire_bytes": base["ring_wire_bytes"],
        "sharded_wire_bytes": shard["ring_wire_bytes"],
        "replicated_bytes_by_kind": base["collective_bytes_by_kind"],
        "sharded_bytes_by_kind": shard["collective_bytes_by_kind"],
        "wire_ratio_sharded_over_psum": round(ratio, 4),
        "parity_within_1p1x": ratio <= 1.1,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    aliases = {k.split("_")[0]: k for k in MODELS}
    ap.add_argument("--model", default="all",
                    choices=["all"] + list(MODELS) + sorted(aliases),
                    help="benchmark model key, or its short alias "
                    f"({', '.join(sorted(aliases))})")
    ap.add_argument("--sharded", action="store_true",
                    help="audit the ZeRO-1 sharded weight update "
                    "(reduce-scatter + all-gather) instead of the "
                    "replicated fused allreduce")
    ap.add_argument("--parity", action="store_true",
                    help="audit both optimizer paths for --model and "
                    "report the sharded/replicated ring-wire ratio (<= 1.1x)")
    ap.add_argument("--microbatch", type=int, default=1, metavar="K",
                    help="audit the step microbatched into K "
                    "gradient-accumulation passes")
    ap.add_argument("--microbatch-parity", action="store_true",
                    help="audit --model at accum 1 and K (4; --microbatch "
                    "overrides) and check the wire bytes are identical")
    ap.add_argument("--quant", choices=["int8", "fp8"], default=None,
                    help="audit the step on the quantized wire")
    ap.add_argument("--lint", action="store_true",
                    help="run the static fusion-parity audit (exits 2 "
                    "unless every row is clean)")
    args = ap.parse_args(argv)
    args.model = aliases.get(args.model, args.model)
    keys = list(MODELS) if args.model == "all" else [args.model]
    if (args.parity or args.microbatch_parity) and args.model == "all":
        raise SystemExit("--parity and --microbatch-parity need one --model")

    if args.lint:
        rows = [lint_audit(key, sharded=args.sharded, accum=args.microbatch,
                           compression=args.quant)
                for key in keys]
        print(json.dumps(rows if len(rows) > 1 else rows[0], indent=1))
        return 0 if all(r["clean"] for r in rows) else 2
    if args.microbatch_parity:
        row = microbatch_parity(
            args.model, sharded=args.sharded,
            k=args.microbatch if args.microbatch > 1 else 4)
        print(json.dumps(row), flush=True)
        return 0 if row["wire_bytes_unchanged"] else 2
    if args.parity:
        row = byte_parity(args.model)
        print(json.dumps(row), flush=True)
        return 0 if row["parity_within_1p1x"] else 2
    rows = [audit(key, sharded=args.sharded, accum=args.microbatch,
                  compression=args.quant)
            for key in keys]
    print(json.dumps(rows if len(rows) > 1 else rows[0], indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
