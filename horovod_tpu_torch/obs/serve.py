"""Serving-plane instruments: one home for every ``serve.*`` metric name.

The dispatcher, pool, and policy all record through these helpers so the
metric names the exporters serialize (and ``horovod_tpu_torch/tools/hvdtpu_top.py``'s
serve panel parses) cannot drift per call site. Naming:

=================================  =====================================
``serve.queue_depth``       gauge  requests waiting, unleased
``serve.in_flight``         gauge  requests leased to workers
``serve.in_flight.<w>``     gauge  per-worker in-flight (removed when
                                   the worker leaves the pool)
``serve.workers``           gauge  live serving workers
``serve.batch_fill``        gauge  last batch's fill fraction (0..1)
``serve.ckpt_step``         gauge  checkpoint step currently served
``serve.request_ms``        histo  submit→response latency (p50/95/99)
``serve.batch_fill_pct``    histo  fill distribution over recent batches
``serve.requests``          count  accepted submissions
``serve.responses``         count  resolved responses
``serve.requeued``          count  in-flight requests re-queued (worker
                                   death / dispatch failure / timeout)
``serve.dropped``           count  ingress rejections (chaos drop)
``serve.batches``           count  batches dispatched
``serve.hotswaps``          count  completed per-worker checkpoint swaps
``serve.rollbacks``         count  corrupt hot-swap targets rolled back
``serve.ckpt_staleness_s``  gauge  seconds since the checkpoint watcher
                                   last saw a NEW step advance
``serve.weight_bits``       gauge  quantized weight width being served
                                   (8 = int8 matmul path; 0 = the
                                   checkpoint's own dtypes)
=================================  =====================================

Token-level decode engine (``serve/engine.py`` + ``serve/kvcache.py``):

==================================  ====================================
``serve.decode.tokens``      count  committed (streamed) tokens
``serve.decode.steps``       count  decode rounds executed
``serve.decode.streams``     count  accepted stream submissions
``serve.decode.finished``    count  streams resolved
``serve.decode.requeued``    count  in-flight streams re-queued after a
                                    worker death (resume-from-committed)
``serve.decode.preempted``   count  streams preempted for KV pressure
``serve.decode.tokens_per_s`` gauge decode throughput (rolling window)
``serve.decode.row_fill``    gauge  active rows / decode batch width
``serve.decode.ttft_ms``     histo  submit → first token (p50/p95/p99)
``serve.decode.tpot_ms``     histo  per-output-token latency
``serve.decode.kv_blocks_used`` gauge paged-pool blocks in use
``serve.decode.kv_occupancy`` gauge used blocks / pool blocks (0..1)
``serve.decode.kv_fragmentation`` gauge allocated-but-empty slot
                                    fraction (0..1)
``serve.decode.kv_defrags``  count  pool compactions performed
``serve.decode.accept_rate`` gauge  draft proposals accepted last round
``serve.decode.draft_proposed`` count speculative proposals offered
``serve.decode.draft_accepted`` count speculative proposals accepted
==================================  ====================================
"""

from __future__ import annotations

from . import registry as _obs


def record_submit() -> None:
    _obs.metrics().counter("serve.requests").inc()


def record_drop() -> None:
    _obs.metrics().counter("serve.dropped").inc()


def record_response(latency_ms: float) -> None:
    reg = _obs.metrics()
    reg.counter("serve.responses").inc()
    reg.histogram("serve.request_ms").observe(latency_ms)


def record_batch(fill: float) -> None:
    reg = _obs.metrics()
    reg.counter("serve.batches").inc()
    reg.gauge("serve.batch_fill").set(fill)
    reg.histogram("serve.batch_fill_pct").observe(fill * 100.0)


def record_requeued(n: int) -> None:
    _obs.metrics().counter("serve.requeued").inc(n)


def set_queue_depth(depth: int) -> None:
    _obs.metrics().gauge("serve.queue_depth").set(depth)


def set_in_flight(total: int) -> None:
    _obs.metrics().gauge("serve.in_flight").set(total)


def set_worker_in_flight(worker: str, n: int) -> None:
    _obs.metrics().gauge(f"serve.in_flight.{worker}").set(n)


def drop_worker_gauges(worker: str) -> None:
    """A departed worker's per-entity gauge must not linger (the same
    bounded-registry rule the stall gauges follow)."""
    _obs.metrics().remove_gauge(f"serve.in_flight.{worker}")


def set_workers(n: int) -> None:
    _obs.metrics().gauge("serve.workers").set(n)


def set_ckpt_step(step: int) -> None:
    _obs.metrics().gauge("serve.ckpt_step").set(step)


def set_ckpt_staleness(secs: float) -> None:
    _obs.metrics().gauge("serve.ckpt_staleness_s").set(secs)


def record_hotswap() -> None:
    _obs.metrics().counter("serve.hotswaps").inc()


def record_rollback() -> None:
    _obs.metrics().counter("serve.rollbacks").inc()


def set_weight_bits(bits: int) -> None:
    _obs.metrics().gauge("serve.weight_bits").set(bits)


# -- token-level decode engine --------------------------------------------


def record_stream_submit() -> None:
    _obs.metrics().counter("serve.decode.streams").inc()


def record_stream_finished() -> None:
    _obs.metrics().counter("serve.decode.finished").inc()


def record_decode_round(n_tokens: int, fill: float) -> None:
    reg = _obs.metrics()
    reg.counter("serve.decode.steps").inc()
    if n_tokens:
        reg.counter("serve.decode.tokens").inc(n_tokens)
    reg.gauge("serve.decode.row_fill").set(fill)


def set_decode_tokens_per_s(rate: float) -> None:
    _obs.metrics().gauge("serve.decode.tokens_per_s").set(rate)


def record_ttft(ms: float) -> None:
    _obs.metrics().histogram("serve.decode.ttft_ms").observe(ms)


def record_tpot(ms: float) -> None:
    _obs.metrics().histogram("serve.decode.tpot_ms").observe(ms)


def record_stream_requeued(n: int) -> None:
    _obs.metrics().counter("serve.decode.requeued").inc(n)


def record_stream_preempted(n: int) -> None:
    _obs.metrics().counter("serve.decode.preempted").inc(n)


def set_kv_blocks(used: int, occupancy: float, fragmentation: float) -> None:
    reg = _obs.metrics()
    reg.gauge("serve.decode.kv_blocks_used").set(used)
    reg.gauge("serve.decode.kv_occupancy").set(occupancy)
    reg.gauge("serve.decode.kv_fragmentation").set(fragmentation)


def record_kv_defrag() -> None:
    _obs.metrics().counter("serve.decode.kv_defrags").inc()


def record_speculation(proposed: int, accepted: int) -> None:
    reg = _obs.metrics()
    if proposed:
        reg.counter("serve.decode.draft_proposed").inc(proposed)
        reg.counter("serve.decode.draft_accepted").inc(accepted)
        reg.gauge("serve.decode.accept_rate").set(accepted / proposed)
