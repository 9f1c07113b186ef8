"""Environment knobs of the serving and training slices.

Read from ``HVDTPU_<NAME>`` with ``HOROVOD_<NAME>`` as the compatibility
alias, under the same names and defaults as the JAX package's
``utils/env.py`` (kept as a copy: this package imports nothing of it), so
one deployment's environment configures either package the same way.
"""

from __future__ import annotations

import os
from typing import Optional

FUSION_THRESHOLD = "FUSION_THRESHOLD"  # bytes per fused pack() buffer
SERVE_BATCH_SIZE = "SERVE_BATCH_SIZE"  # fixed device batch rows
SERVE_BATCH_TIMEOUT_MS = "SERVE_BATCH_TIMEOUT_MS"  # batch-fill wait window
SERVE_WORKERS = "SERVE_WORKERS"  # initial pool size
SERVE_MAX_WORKERS = "SERVE_MAX_WORKERS"  # autoscale ceiling
SERVE_QUEUE_HIGH = "SERVE_QUEUE_HIGH"  # per-worker backlog -> scale up
SERVE_QUEUE_LOW = "SERVE_QUEUE_LOW"  # per-worker backlog -> scale down
SERVE_SCALE_COOLDOWN_SECS = "SERVE_SCALE_COOLDOWN_SECS"  # between rescales
SERVE_REQUEST_TIMEOUT_SECS = "SERVE_REQUEST_TIMEOUT_SECS"  # lease expiry
SERVE_CKPT_POLL_SECS = "SERVE_CKPT_POLL_SECS"  # hot-swap watch period
SERVE_WEIGHT_DTYPE = "SERVE_WEIGHT_DTYPE"  # serving weight storage: off|int8
SERVE_KV_BLOCKS = "SERVE_KV_BLOCKS"  # paged KV pool capacity, blocks
SERVE_KV_BLOCK_SIZE = "SERVE_KV_BLOCK_SIZE"  # tokens per KV block
SERVE_KV_DTYPE = "SERVE_KV_DTYPE"  # KV-cache storage: off(=fp)|int8
SERVE_DECODE_ROWS = "SERVE_DECODE_ROWS"  # fixed decode batch rows/worker
SERVE_MAX_SEQ_LEN = "SERVE_MAX_SEQ_LEN"  # prompt+generation token ceiling
SERVE_SPEC_K = "SERVE_SPEC_K"  # draft proposals per speculative round
FUSED_UPDATE = "FUSED_UPDATE"  # fused ZeRO-1 optimizer-update kernel
OVERLAP_ACCUM_STEPS = "OVERLAP_ACCUM_STEPS"  # default accum_steps (>=1)
OVERLAP_STAGGER = "OVERLAP_STAGGER"  # chain the overlap's bucket work
QUANT = "QUANT"  # quantized collective wire format: off|int8|fp8
QUANT_BLOCK = "QUANT_BLOCK"  # elements per blockwise quantization scale
COMPUTE_DTYPE = "COMPUTE_DTYPE"  # training matmul precision: off|fp8
FP8_AMAX_HISTORY = "FP8_AMAX_HISTORY"  # delayed-scaling amax ring length
REMAT = "REMAT"  # default remat policy for make_train_step(remat=...)
PREFETCH_DEPTH = "PREFETCH_DEPTH"  # prefetch_to_device buffer depth
OVERLAP = "OVERLAP"  # default for make_train_step(overlap=...)
ACT_QUANT = "ACT_QUANT"  # int8 storage of remat'd activations: off|int8
# Fail-silent fault defense (guard/) and the chaos plane (chaos/).
GUARD = "GUARD"  # arm the in-graph gradient guard by default
GUARD_SPIKE_SIGMA = "GUARD_SPIKE_SIGMA"  # z-score above the norm EMA
GUARD_MAX_SKIPS = "GUARD_MAX_SKIPS"  # consecutive skips before escalation
GUARD_WARMUP = "GUARD_WARMUP"  # ok-steps before spike detection arms
GUARD_EMA_DECAY = "GUARD_EMA_DECAY"  # norm EMA decay (0, 1)
GUARD_AUDIT_EVERY = "GUARD_AUDIT_EVERY"  # consistency-audit cadence (0=off)
CHAOS = "CHAOS"  # fault-injection schedule (horovod_tpu_torch.chaos)
CHAOS_SEED = "CHAOS_SEED"  # seed for probabilistic chaos rules
GUARD_BLACKLIST_AFTER = "GUARD_BLACKLIST_AFTER"  # divergence reports -> kill
# The launcher and the elastic control plane (runner/, elastic/worker.py).
KV_RETRIES = "KV_RETRIES"  # RendezvousClient transient-failure attempts
HEARTBEAT_SECS = "HEARTBEAT_SECS"  # elastic worker lease period (0 = off)
HEARTBEAT_TIMEOUT_SECS = "HEARTBEAT_TIMEOUT_SECS"  # driver lease expiry
BLACKLIST_COOLDOWN = "BLACKLIST_COOLDOWN"  # secs; 0 = permanent exile
JOURNAL_DIR = "JOURNAL_DIR"  # durable control-plane journal directory
JOURNAL_COMPACT_BYTES = "JOURNAL_COMPACT_BYTES"  # WAL size -> snapshot
PREEMPT_COOLDOWN_SECS = "PREEMPT_COOLDOWN_SECS"  # drain-mark expiry
# The data plane's timeout, under the JAX package's native runtime's name
# (read as is, with no HVDTPU_/HOROVOD_ prefix).
DATA_TIMEOUT_ENV = "HVT_DATA_TIMEOUT_SECS"  # torch.distributed timeout
# The telemetry planes (obs/): metrics registry and its exporters, the
# span recorder, the goodput ledger, and the host timeline.
METRICS = "METRICS"  # enable the metrics plane (horovod_tpu_torch.obs)
METRICS_DIR = "METRICS_DIR"  # export directory (JSONL + Prometheus)
METRICS_INTERVAL = "METRICS_INTERVAL"  # flush period, seconds
METRICS_SUMMARY_STEPS = "METRICS_SUMMARY_STEPS"  # rank-0 summary cadence
TRACE = "TRACE"  # enable the span recorder / flight recorder
TRACE_DIR = "TRACE_DIR"  # per-rank trace dump directory
TRACE_BUFFER = "TRACE_BUFFER"  # ring capacity, events (bounded memory)
GOODPUT = "GOODPUT"  # enable the goodput accounting ledger
GOODPUT_WINDOW = "GOODPUT_WINDOW"  # pending-interval window (bounded memory)
TIMELINE = "TIMELINE"  # path of the chrome-trace host timeline
TIMELINE_MARK_CYCLES = "TIMELINE_MARK_CYCLES"  # cycle marks in the timeline
# The analysis plane (horovod_tpu_torch.analysis): the step's first-call
# lint, the cross-rank certification preflight and the memory planner.
LINT = "LINT"  # default for make_train_step(lint=...): off|warn|raise
CERT = "CERT"  # SPMD cert preflight gate: off|warn|raise (default warn)
CERT_TIMEOUT_SECS = "CERT_TIMEOUT_SECS"  # cross-rank cert exchange wait
HBM_BUDGET_GB = "HBM_BUDGET_GB"  # per-device memory budget the memplan gates
MEMPLAN_BASELINES = "MEMPLAN_BASELINES"  # peak-regression baseline JSON path
MEMPLAN_TOLERANCE = "MEMPLAN_TOLERANCE"  # predicted-vs-measured drift gate
# Closed-loop autotuner (horovod_tpu_torch.tune): the telemetry-driven knob
# search. HVDTPU_AUTOTUNE=1 is the default of make_train_step(autotune=...),
# ServePool(autotune=...) and the elastic driver's rollout coordinator. In
# the JAX package the same flag also arms the native ParameterManager inside
# the C++ runtime's background loop; that half rides the native runtime,
# which this package does not have yet (ROADMAP A16), and the flag arms the
# Python plane alone here.
AUTOTUNE = "AUTOTUNE"  # closed-loop autotuner, trainer and serving pool
AUTOTUNE_LOG = "AUTOTUNE_LOG"  # launcher --autotune-log-file
AUTOTUNE_WINDOW_STEPS = "AUTOTUNE_WINDOW_STEPS"  # scored steps per trial
AUTOTUNE_WARMUP_STEPS = "AUTOTUNE_WARMUP_STEPS"  # discarded per switch
AUTOTUNE_MAX_TRIALS = "AUTOTUNE_MAX_TRIALS"  # hard trial budget
AUTOTUNE_PATIENCE = "AUTOTUNE_PATIENCE"  # no-improvement trials -> done
AUTOTUNE_SEED = "AUTOTUNE_SEED"  # candidate-draw seed (determinism)
AUTOTUNE_KNOBS = "AUTOTUNE_KNOBS"  # CSV subset of the search space
COLLECTIVE_LAYOUT = "COLLECTIVE_LAYOUT"  # auto|flat|hierarchical
# Live weight streaming, trainer -> decode fleet (horovod_tpu_torch.stream).
PUBLISH_EVERY = "PUBLISH_EVERY"  # publish a delta every N commits; 0=off
STREAM = "STREAM"  # arm the streamed hot-swap mode on serving
STREAM_STALENESS_SECS = "STREAM_STALENESS_SECS"  # watchdog -> ckpt fallback
STREAM_MAX_PENDING = "STREAM_MAX_PENDING"  # audit-gated deltas held, max

DEFAULT_FUSION_THRESHOLD = 128 * 1024 * 1024
DEFAULT_CERT_TIMEOUT_SECS = 30.0  # bounded: the gate degrades, never hangs
DEFAULT_MEMPLAN_TOLERANCE = 0.25
DEFAULT_SERVE_BATCH_SIZE = 8
DEFAULT_SERVE_BATCH_TIMEOUT_MS = 2.0
DEFAULT_SERVE_WORKERS = 1
DEFAULT_SERVE_MAX_WORKERS = 4
DEFAULT_SERVE_QUEUE_HIGH = 4.0
DEFAULT_SERVE_QUEUE_LOW = 0.5
DEFAULT_SERVE_SCALE_COOLDOWN_SECS = 5.0
DEFAULT_SERVE_REQUEST_TIMEOUT_SECS = 30.0
DEFAULT_SERVE_CKPT_POLL_SECS = 1.0
DEFAULT_SERVE_KV_BLOCKS = 64
DEFAULT_SERVE_KV_BLOCK_SIZE = 16
DEFAULT_SERVE_DECODE_ROWS = 4
DEFAULT_SERVE_MAX_SEQ_LEN = 256
DEFAULT_SERVE_SPEC_K = 0
DEFAULT_QUANT_BLOCK = 256  # 4/256 = 1.6% fp32-scale overhead on the wire
DEFAULT_FP8_AMAX_HISTORY = 16  # steps of amax memory behind each scale
DEFAULT_GUARD_SPIKE_SIGMA = 6.0
DEFAULT_GUARD_MAX_SKIPS = 8
DEFAULT_GUARD_WARMUP = 20
DEFAULT_GUARD_EMA_DECAY = 0.99
DEFAULT_GUARD_AUDIT_EVERY = 100
DEFAULT_GUARD_BLACKLIST_AFTER = 2
DEFAULT_KV_RETRIES = 4
DEFAULT_HEARTBEAT_SECS = 2.0
DEFAULT_HEARTBEAT_TIMEOUT_SECS = 30.0
DEFAULT_JOURNAL_COMPACT_BYTES = 1 << 20  # 1 MiB of WAL between snapshots
DEFAULT_PREEMPT_COOLDOWN_SECS = 60.0
DEFAULT_DATA_TIMEOUT_SECS = 300.0  # the native runtime's default
DEFAULT_PUBLISH_EVERY = 0  # weight streaming is opt-in
DEFAULT_PREFETCH_DEPTH = 2  # double-buffered host-to-device staging
DEFAULT_GOODPUT_WINDOW = 512  # pending intervals before the ledger settles
# Autotuner defaults: the native ParameterManager's sampling and convergence
# constants (steps_per_sample 10, 10 samples without improvement or 40
# samples => done) and its candidate-draw seed, as the JAX package has them.
DEFAULT_AUTOTUNE_WINDOW_STEPS = 10
DEFAULT_AUTOTUNE_WARMUP_STEPS = 3
DEFAULT_AUTOTUNE_MAX_TRIALS = 40
DEFAULT_AUTOTUNE_PATIENCE = 10
DEFAULT_AUTOTUNE_SEED = 20240731
DEFAULT_STREAM_STALENESS_SECS = 30.0
DEFAULT_STREAM_MAX_PENDING = 4


def _lookup(name: str) -> Optional[str]:
    for prefix in ("HVDTPU_", "HOROVOD_"):
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return None


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    val = _lookup(name)
    return default if val is None else val


def get_int(name: str, default: int) -> int:
    val = _lookup(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        return default


def get_bool(name: str, default: bool = False) -> bool:
    val = _lookup(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def get_float(name: str, default: float) -> float:
    val = _lookup(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        return default


def fusion_threshold_bytes() -> int:
    """Default bucket size of :func:`horovod_tpu_torch.ops.batching.pack`."""
    return get_int(FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD)


def serve_batch_size() -> int:
    """Fixed device batch rows for the serve dispatcher (>= 1): the ONE
    shape the inference step sees."""
    size = get_int(SERVE_BATCH_SIZE, DEFAULT_SERVE_BATCH_SIZE)
    if size < 1:
        raise ValueError(f"HVDTPU_SERVE_BATCH_SIZE must be >= 1, got {size}")
    return size


def serve_batch_timeout_ms() -> float:
    """Continuous-batching window: how long a partial batch waits for
    more requests before dispatching underfilled (0 = never wait)."""
    return max(0.0, get_float(
        SERVE_BATCH_TIMEOUT_MS, DEFAULT_SERVE_BATCH_TIMEOUT_MS
    ))


def serve_workers() -> int:
    """Initial serving-pool size (>= 1)."""
    return max(1, get_int(SERVE_WORKERS, DEFAULT_SERVE_WORKERS))


def serve_max_workers() -> int:
    """Autoscale ceiling for the serving pool (>= 1)."""
    return max(1, get_int(SERVE_MAX_WORKERS, DEFAULT_SERVE_MAX_WORKERS))


def serve_queue_high() -> float:
    """Per-worker queue backlog above which the scale policy adds a
    worker."""
    return get_float(SERVE_QUEUE_HIGH, DEFAULT_SERVE_QUEUE_HIGH)


def serve_queue_low() -> float:
    """Per-worker queue backlog below which the scale policy drains a
    worker (never below the policy's ``min_workers``)."""
    return get_float(SERVE_QUEUE_LOW, DEFAULT_SERVE_QUEUE_LOW)


def serve_scale_cooldown_secs() -> float:
    """Minimum seconds between scale decisions (hysteresis)."""
    return max(0.0, get_float(
        SERVE_SCALE_COOLDOWN_SECS, DEFAULT_SERVE_SCALE_COOLDOWN_SECS
    ))


def serve_request_timeout_secs() -> float:
    """Age past which a leased (in-flight) batch is presumed lost and
    its requests are re-queued to another worker. Clamped to >= 0.1 s:
    a zero/negative value would make the lease reaper tear every batch
    off healthy workers mid-infer."""
    return max(0.1, get_float(
        SERVE_REQUEST_TIMEOUT_SECS, DEFAULT_SERVE_REQUEST_TIMEOUT_SECS
    ))


def serve_ckpt_poll_secs() -> float:
    """How often serving workers poll for a newly published checkpoint
    step (the rolling hot-swap trigger)."""
    return max(0.05, get_float(
        SERVE_CKPT_POLL_SECS, DEFAULT_SERVE_CKPT_POLL_SECS
    ))


def serve_weight_dtype() -> str:
    """Default for ``ServePool(weight_dtype=...)``: ``""`` (serve the
    checkpoint's own dtypes) or ``"int8"`` (quantize the matmul weights once
    per checkpoint load; inference runs the int8 matmul with its scales in
    the epilogue). Anything else raises -- a typo must not silently serve
    full-precision."""
    val = (get_str(SERVE_WEIGHT_DTYPE, "") or "").strip().lower()
    if val in ("", "0", "off", "false", "no", "none"):
        return ""
    if val == "int8":
        return val
    raise ValueError(
        f"HVDTPU_SERVE_WEIGHT_DTYPE={val!r} is not recognized; use off|int8"
    )


def serve_kv_blocks() -> int:
    """Paged KV-cache pool capacity in blocks per decode worker (>= 1):
    the admission ceiling of the token-level engine."""
    n = get_int(SERVE_KV_BLOCKS, DEFAULT_SERVE_KV_BLOCKS)
    if n < 1:
        raise ValueError(f"HVDTPU_SERVE_KV_BLOCKS must be >= 1, got {n}")
    return n


def serve_kv_block_size() -> int:
    """Tokens per KV-cache block (>= 1). Smaller blocks waste fewer slots
    on short tails but cost more block-table entries."""
    n = get_int(SERVE_KV_BLOCK_SIZE, DEFAULT_SERVE_KV_BLOCK_SIZE)
    if n < 1:
        raise ValueError(
            f"HVDTPU_SERVE_KV_BLOCK_SIZE must be >= 1, got {n}"
        )
    return n


def serve_kv_dtype() -> str:
    """KV-cache storage dtype: ``""`` (the model's own float dtype) or
    ``"int8"`` (per-token-per-head max-abs scales, the blockwise codec with
    block = head_dim). A typo must not silently serve fp."""
    val = (get_str(SERVE_KV_DTYPE, "") or "").strip().lower()
    if val in ("", "0", "off", "false", "no", "none"):
        return ""
    if val == "int8":
        return val
    raise ValueError(
        f"HVDTPU_SERVE_KV_DTYPE={val!r} is not recognized; use off|int8"
    )


def serve_decode_rows() -> int:
    """Fixed decode batch width per worker (>= 1): the one decode shape;
    sequences join and leave rows between steps."""
    n = get_int(SERVE_DECODE_ROWS, DEFAULT_SERVE_DECODE_ROWS)
    if n < 1:
        raise ValueError(f"HVDTPU_SERVE_DECODE_ROWS must be >= 1, got {n}")
    return n


def serve_max_seq_len() -> int:
    """Per-sequence token ceiling (prompt + generation, >= 2): sizes the
    prefill bucket and the per-sequence block-table width."""
    n = get_int(SERVE_MAX_SEQ_LEN, DEFAULT_SERVE_MAX_SEQ_LEN)
    if n < 2:
        raise ValueError(f"HVDTPU_SERVE_MAX_SEQ_LEN must be >= 2, got {n}")
    return n


def serve_spec_k() -> int:
    """Draft proposals per speculative-decoding round (0 disables the
    draft tier; a draft model is then required on the engine)."""
    n = get_int(SERVE_SPEC_K, DEFAULT_SERVE_SPEC_K)
    if n < 0:
        raise ValueError(f"HVDTPU_SERVE_SPEC_K must be >= 0, got {n}")
    return n


def fused_update_default() -> bool:
    """Default for ``ShardedDistributedOptimizer(fused_update=...)`` /
    ``make_train_step(sharded=True, fused_update=...)``: run the ZeRO-1
    weight update as one fused kernel pass per shard bucket. Needs an
    optimizer built by ``fused_adamw`` (else the env default degrades to
    unfused with a warning)."""
    return get_bool(FUSED_UPDATE, False)


def overlap_accum_steps() -> int:
    """Default microbatch count for ``make_train_step(accum_steps=...)``."""
    return max(1, get_int(OVERLAP_ACCUM_STEPS, 1))


def quant_mode() -> str:
    """Default wire quantization for ``make_train_step(compression=...)``:
    ``""`` (off), ``"int8"`` or ``"fp8"``. Anything else raises -- a typo
    (``HVDTPU_QUANT=int4``) must not silently train unquantized."""
    val = (get_str(QUANT, "") or "").strip().lower()
    if val in ("", "0", "off", "false", "no", "none"):
        return ""
    if val in ("int8", "fp8"):
        return val
    raise ValueError(
        f"HVDTPU_QUANT={val!r} is not recognized; use off|int8|fp8"
    )


def quant_block() -> int:
    """Blockwise quantization granularity (elements per scale), >= 1: an
    fp32 scale per block costs 4/block of the payload."""
    block = get_int(QUANT_BLOCK, DEFAULT_QUANT_BLOCK)
    if block < 1:
        raise ValueError(f"HVDTPU_QUANT_BLOCK must be >= 1, got {block}")
    return block


def compute_dtype_mode() -> str:
    """Default for ``make_train_step(compute_dtype=...)`` and a model
    config's ``compute_dtype=None``: ``""`` (the model's own dtype) or
    ``"fp8"`` (e4m3 forward / e5m2 gradient matmuls with per-tensor delayed
    scaling; fp32 master weights stay in the parameters). Anything else
    raises -- a typo must not silently train full-precision."""
    val = (get_str(COMPUTE_DTYPE, "") or "").strip().lower()
    if val in ("", "0", "off", "false", "no", "none"):
        return ""
    if val == "fp8":
        return val
    raise ValueError(
        f"HVDTPU_COMPUTE_DTYPE={val!r} is not recognized; use off|fp8"
    )


def fp8_amax_history() -> int:
    """Length of the per-tensor amax history ring behind each delayed fp8
    scale (>= 1). Longer rings react slower to dynamic-range drops but
    resist transient under-scaling; 1 degenerates to just-in-time scaling
    of the previous step."""
    n = get_int(FP8_AMAX_HISTORY, DEFAULT_FP8_AMAX_HISTORY)
    if n < 1:
        raise ValueError(f"HVDTPU_FP8_AMAX_HISTORY must be >= 1, got {n}")
    return n


def overlap_default() -> bool:
    """Default for ``make_train_step(overlap=...)`` when not passed."""
    return get_bool(OVERLAP, False)


def overlap_stagger() -> bool:
    """Chained bucket work under the overlap pipeline (on by default when
    the pipeline is on; this knob turns it off)."""
    return get_bool(OVERLAP_STAGGER, True)


def lint_mode() -> str:
    """Default for ``make_train_step(lint=...)``: ``""`` (off), ``"warn"``
    or ``"raise"``. ``1/true/yes/on`` are accepted as ``warn``. Anything
    else raises: silently coercing a typo (``HVDTPU_LINT=error``) to the
    weaker ``warn`` would quietly downgrade a gating control."""
    val = (get_str(LINT, "") or "").strip().lower()
    if val in ("", "0", "off", "false", "no", "none"):
        return ""
    if val == "raise":
        return "raise"
    if val in ("warn", "1", "true", "yes", "on"):
        return "warn"
    raise ValueError(
        f"HVDTPU_LINT={val!r} is not recognized; use off|warn|raise"
    )


def cert_mode() -> str:
    """SPMD certification preflight mode (:mod:`horovod_tpu_torch.analysis.
    certify`): ``""`` (off), ``"warn"`` or ``"raise"``. Default is
    **warn** — the gate is a no-op outside an elastic KV world, and
    where one exists a silent hang is strictly worse than a warning.
    ``1/true/yes/on`` are accepted as ``warn``; anything else raises — a
    typo (``HVDTPU_CERT=error``) must not silently downgrade the gate."""
    val = (get_str(CERT, "warn") or "").strip().lower()
    if val in ("", "0", "off", "false", "no", "none"):
        return ""
    if val == "raise":
        return "raise"
    if val in ("warn", "1", "true", "yes", "on"):
        return "warn"
    raise ValueError(
        f"HVDTPU_CERT={val!r} is not recognized; use off|warn|raise"
    )


def cert_timeout_secs() -> float:
    """How long the cert preflight waits for every rank's fingerprint
    to appear in the KV before declaring the exchange incomplete. Must
    be positive — zero would fail every gate before peers publish."""
    t = get_float(CERT_TIMEOUT_SECS, DEFAULT_CERT_TIMEOUT_SECS)
    if t <= 0:
        raise ValueError(f"HVDTPU_CERT_TIMEOUT_SECS must be > 0, got {t}")
    return t


def hbm_budget_bytes() -> Optional[int]:
    """Per-device memory budget (GiB) the memory planner's ``oom-risk``
    rule gates against; unset/``0`` disables the rule. Negative values
    raise — a budget must not silently invert."""
    gb = get_float(HBM_BUDGET_GB, 0.0)
    if gb < 0:
        raise ValueError(f"HVDTPU_HBM_BUDGET_GB must be >= 0, got {gb}")
    return int(gb * (1 << 30)) or None


def memplan_baselines_path() -> str:
    """Path of the checked-in peak-bytes baseline JSON the
    ``peak-regression`` rule reads (the port's
    ``horovod_tpu_torch/tools/memplan_baselines.json`` by default)."""
    return get_str(MEMPLAN_BASELINES, "") or ""


def memplan_tolerance() -> float:
    """Relative error allowed between the memory planner's prediction and
    the measured bytes before :func:`~horovod_tpu_torch.analysis.memory.
    compare_to_measured` reports drift. Must lie in (0, 1]."""
    tol = get_float(MEMPLAN_TOLERANCE, DEFAULT_MEMPLAN_TOLERANCE)
    if not 0.0 < tol <= 1.0:
        raise ValueError(
            f"HVDTPU_MEMPLAN_TOLERANCE must be in (0, 1], got {tol}"
        )
    return tol


def remat_mode() -> str:
    """Default for ``make_train_step(remat=...)``: ``""`` (off), ``"full"``
    or a named policy (``"dots_saveable"``). Validation happens in
    :func:`..ops.remat.resolve_policy`: a typo raises there."""
    val = (get_str(REMAT, "") or "").strip().lower()
    if val in ("", "0", "off", "false", "no", "none"):
        return ""
    return val


def act_quant_mode() -> str:
    """Default for ``make_train_step(act_quant=...)``: ``""`` (residuals
    saved for backward keep the model dtype) or ``"int8"``. A typo must not
    silently store full-precision residuals."""
    val = (get_str(ACT_QUANT, "") or "").strip().lower()
    if val in ("", "0", "off", "false", "no", "none"):
        return ""
    if val == "int8":
        return val
    raise ValueError(
        f"HVDTPU_ACT_QUANT={val!r} is not recognized; use off|int8"
    )


def guard_default() -> bool:
    """Default for ``make_train_step(guard=...)`` when not passed."""
    return get_bool(GUARD, False)


def guard_spike_sigma() -> float:
    """Gradient-norm z-score (vs the EMA baseline) above which a step is
    treated as a spike and skipped. Must be positive."""
    sigma = get_float(GUARD_SPIKE_SIGMA, DEFAULT_GUARD_SPIKE_SIGMA)
    if sigma <= 0:
        raise ValueError(
            f"HVDTPU_GUARD_SPIKE_SIGMA must be > 0, got {sigma}"
        )
    return sigma


def guard_max_skips() -> int:
    """Consecutive guard-skipped steps before the step wrapper escalates
    to a recoverable ``HorovodInternalError`` (>= 1)."""
    return max(1, get_int(GUARD_MAX_SKIPS, DEFAULT_GUARD_MAX_SKIPS))


def guard_warmup() -> int:
    """Committed steps observed before spike detection arms (NaN/Inf
    screening is active from step 0 regardless)."""
    return max(0, get_int(GUARD_WARMUP, DEFAULT_GUARD_WARMUP))


def guard_ema_decay() -> float:
    """Decay of the gradient-norm EMA baseline; must lie in (0, 1)."""
    d = get_float(GUARD_EMA_DECAY, DEFAULT_GUARD_EMA_DECAY)
    if not 0.0 < d < 1.0:
        raise ValueError(
            f"HVDTPU_GUARD_EMA_DECAY must be in (0, 1), got {d}"
        )
    return d


def guard_audit_every() -> int:
    """Cross-replica consistency-audit cadence in committed steps
    (0 disables; the audit only runs in a world of more than one
    process)."""
    return max(0, get_int(GUARD_AUDIT_EVERY, DEFAULT_GUARD_AUDIT_EVERY))


def publish_every() -> int:
    """Committed-step cadence of live weight publishes (0 disables
    streaming): the default of ``make_train_step(publish=...)``."""
    return max(0, get_int(PUBLISH_EVERY, DEFAULT_PUBLISH_EVERY))


def stream_enabled() -> bool:
    """Master switch of the weight stream on the serving side. The
    publisher is governed by :func:`publish_every` alone, so a trainer can
    publish for fleets that opt in on their own."""
    return get_bool(STREAM, False)


def stream_staleness_secs() -> float:
    """Seconds without a freshly applied stream version before the
    subscriber falls back to the checkpoint watcher (>= 0.1 s: a zero
    threshold would restore on every poll)."""
    return max(0.1, get_float(
        STREAM_STALENESS_SECS, DEFAULT_STREAM_STALENESS_SECS))


def stream_max_pending() -> int:
    """Guard-gated publishes held while they wait for the audit (>= 1).
    When the queue is full the oldest capture is dropped: the next
    verified publish supersedes it anyway."""
    n = get_int(STREAM_MAX_PENDING, DEFAULT_STREAM_MAX_PENDING)
    if n < 1:
        raise ValueError(f"HVDTPU_STREAM_MAX_PENDING must be >= 1, got {n}")
    return n


def autotune_default() -> bool:
    """Default for ``make_train_step(autotune=...)``,
    ``ServePool(autotune=...)`` and the elastic driver's rollout
    coordinator. (The JAX package's flag also arms its native
    ParameterManager; see :data:`AUTOTUNE`.)"""
    return get_bool(AUTOTUNE, False)


def autotune_window_steps() -> int:
    """Scored steps per autotune trial window (>= 1)."""
    return max(1, get_int(AUTOTUNE_WINDOW_STEPS,
                          DEFAULT_AUTOTUNE_WINDOW_STEPS))


def autotune_warmup_steps() -> int:
    """Steps discarded after every knob switch before the scoring window
    opens (cold caches, a rebuilt step)."""
    return max(0, get_int(AUTOTUNE_WARMUP_STEPS,
                          DEFAULT_AUTOTUNE_WARMUP_STEPS))


def autotune_max_trials() -> int:
    """Hard trial budget before the search settles on its best (>= 1)."""
    return max(1, get_int(AUTOTUNE_MAX_TRIALS, DEFAULT_AUTOTUNE_MAX_TRIALS))


def autotune_patience() -> int:
    """Consecutive no-improvement trials before convergence (>= 1)."""
    return max(1, get_int(AUTOTUNE_PATIENCE, DEFAULT_AUTOTUNE_PATIENCE))


def autotune_seed() -> int:
    """Seed of the candidate draws: proposals are a pure function of
    ``(seed, trial index, history)``, so a search resumed from journaled
    history proposes what the fault-free one would."""
    return get_int(AUTOTUNE_SEED, DEFAULT_AUTOTUNE_SEED)


def autotune_knobs() -> tuple:
    """Optional CSV subset of the search space (knob constant names,
    e.g. ``FUSION_THRESHOLD,OVERLAP_STAGGER``); empty = the default space
    of the plane being tuned."""
    raw = (get_str(AUTOTUNE_KNOBS, "") or "").strip()
    if not raw:
        return ()
    return tuple(k.strip().upper() for k in raw.split(",") if k.strip())


def collective_layout() -> str:
    """Collective layout preference: ``"auto"`` (the topology heuristic
    and the tuner's categorical arm decide), ``"flat"`` or
    ``"hierarchical"``. A typo raises."""
    val = (get_str(COLLECTIVE_LAYOUT, "auto") or "auto").strip().lower()
    if val in ("", "auto"):
        return "auto"
    if val in ("flat", "hierarchical"):
        return val
    raise ValueError(
        f"HVDTPU_COLLECTIVE_LAYOUT={val!r} is not recognized; use "
        "auto|flat|hierarchical")


def declared_env_vars() -> set:
    """Every ``HVDTPU_*`` knob this module declares (its constants,
    prefixed): the tuner refuses to write any other variable."""
    return {
        "HVDTPU_" + v
        for k, v in globals().items()
        if k.isupper() and isinstance(v, str) and v.isupper()
        and not k.startswith("DEFAULT_") and not v.startswith("HVT_")
    }


def prefetch_depth() -> int:
    """Default buffer depth for :func:`..data.prefetch_to_device`."""
    return max(1, get_int(PREFETCH_DEPTH, DEFAULT_PREFETCH_DEPTH))


def guard_blacklist_after() -> int:
    """Divergence reports against one host before the elastic driver
    kills and blacklists it (>= 1); below this, reports only add health
    strikes (probation bookkeeping)."""
    return max(1, get_int(
        GUARD_BLACKLIST_AFTER, DEFAULT_GUARD_BLACKLIST_AFTER
    ))


def kv_retries() -> int:
    """Total attempts for one ``RendezvousClient`` request (>= 1)."""
    return max(1, get_int(KV_RETRIES, DEFAULT_KV_RETRIES))


def heartbeat_secs() -> float:
    """Elastic worker heartbeat-lease period; <= 0 disables the lease."""
    return get_float(HEARTBEAT_SECS, DEFAULT_HEARTBEAT_SECS)


def heartbeat_timeout_secs() -> float:
    """Lease age past which the driver treats a worker as hung;
    <= 0 disables driver-side expiry."""
    return get_float(HEARTBEAT_TIMEOUT_SECS, DEFAULT_HEARTBEAT_TIMEOUT_SECS)


def journal_compact_bytes() -> int:
    """Journal size past which the driver takes a compacted snapshot
    and truncates the WAL (>= 4 KiB; compaction also fires on every
    round advance regardless)."""
    return max(4096, get_int(JOURNAL_COMPACT_BYTES,
                             DEFAULT_JOURNAL_COMPACT_BYTES))


def preempt_cooldown_secs() -> float:
    """How long a preemption-drained host stays excluded from round
    selection after its SIGTERM flag was consumed."""
    return max(1.0, get_float(PREEMPT_COOLDOWN_SECS,
                              DEFAULT_PREEMPT_COOLDOWN_SECS))


def blacklist_cooldown() -> float:
    """Seconds a blacklisted host sits out before probation re-admits
    it to discovery (doubling per repeat offense); 0 = permanent."""
    return max(0.0, get_float(BLACKLIST_COOLDOWN, 0.0))


def data_timeout_secs() -> float:
    """Timeout of every ``torch.distributed`` call of the world
    (``HVT_DATA_TIMEOUT_SECS``, the JAX package's native-runtime knob;
    default 300 s): a dead peer fails the survivors' collectives after
    this long instead of gloo's 30 minutes."""
    val = os.environ.get(DATA_TIMEOUT_ENV)
    try:
        secs = float(val) if val is not None else DEFAULT_DATA_TIMEOUT_SECS
    except ValueError:
        secs = DEFAULT_DATA_TIMEOUT_SECS
    return secs if secs > 0 else DEFAULT_DATA_TIMEOUT_SECS


def goodput_default() -> bool:
    """Default enablement of the goodput ledger (:mod:`..obs.goodput`)."""
    return get_bool(GOODPUT, False)


def goodput_window() -> int:
    """Pending-interval window of the goodput ledger: intervals held
    before the oldest half is settled into totals (bounded memory). Must
    be >= 16: a smaller window settles mid-step brackets, and late
    reclassifications (guard skips, exposed-comm carve-outs) then degrade
    into ``other`` residue."""
    win = get_int(GOODPUT_WINDOW, DEFAULT_GOODPUT_WINDOW)
    if win < 16:
        raise ValueError(f"HVDTPU_GOODPUT_WINDOW must be >= 16, got {win}")
    return win


def launcher_rank_world() -> tuple:
    """The launcher-injected ``(rank, world)``, resolved as the JAX
    package resolves it (``HVT_*`` before ``HVDTPU_PROCESS_ID`` /
    ``HVDTPU_NUM_PROCESSES``), then ``torch.distributed``'s ``RANK`` /
    ``WORLD_SIZE``; a standalone process is ``(0, 1)``. The exporters and
    the flight recorder stamp their files with it."""
    env = os.environ
    rank = env.get("HVT_RANK", env.get("HVDTPU_PROCESS_ID",
                                       env.get("RANK", "0")))
    world = env.get("HVT_SIZE", env.get("HVDTPU_NUM_PROCESSES",
                                        env.get("WORLD_SIZE", "1")))
    return int(rank), int(world)
