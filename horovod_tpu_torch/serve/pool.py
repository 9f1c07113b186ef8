"""Replicated inference pool on the card -- the port of the JAX package's
``serve/pool.py``.

:class:`ServePool` runs N serving workers (threads) over one shared
:class:`~horovod_tpu_torch.serve.dispatcher.Dispatcher`. Each worker:

* holds its own reference to the weights, loaded from a
  manifest-verified checkpoint when ``ckpt_dir`` is given -- a corrupt
  latest step walks back to the newest intact one;
* loops ``lease -> infer -> complete`` under ``torch.inference_mode()``
  (set inside the worker thread: the mode is per thread); the packed
  batch moves to the pool's device, the outputs come back to the host, so
  a response is a CPU tensor and the request latency includes the
  device's work; a failed batch is re-queued, a killed worker's in-flight
  batches are re-queued -- requests are never dropped;
* takes part in the **rolling hot-swap**: when the checkpoint watcher
  sees a newly published step, workers swap ONE AT A TIME while the
  others keep serving; a corrupt target is quarantined and rolled back
  through the walk-back restore, and no further worker attempts it.

``params`` (or what a restore of ``ckpt_target`` gives) is handed to
``infer_fn(params, batch)`` as it is: a nest of tensors, or an
``nn.Module`` -- a restore into a module template loads a fresh copy of
the module, so workers never share a module being swapped. All workers
launch on the device's current stream.

``weight_dtype="int8"`` (default: ``HVDTPU_SERVE_WEIGHT_DTYPE``) quantizes
the weights once per restore -- the initial load, each worker's hot-swap
restore, and the adoption of a step with no live worker -- on the pool's
device (kernel 4 on the card), before any worker sees them, with
:func:`~horovod_tpu_torch.ops.quantization.quantize_params`: a nest's big
2-D floating tensors become ``QuantizedWeight`` leaves for an ``infer_fn``
that routes its matmuls through ``qmatmul``; a model's ``Dense`` layers
keep int8 payloads and run kernel 7. A module target is restored into an
fp32 copy of itself, so the scales come from the checkpoint's fp32 values
(as the JAX package quantizes its restored fp32 tree), and its other
weights are then stored in the template's dtypes again.

``autoscale=True`` drives the pool off its queue depth through
:class:`~horovod_tpu_torch.elastic.scale.QueueDepthPolicy`: scale-up
spawns a worker, scale-down drains one (it finishes its in-flight batch,
then leaves).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import chaos as _chaos
from .. import checkpoint as _ckpt
from ..context import resolve_device
from ..elastic.scale import QueueDepthPolicy
from ..obs import serve as _sobs
from ..obs import trace as _trace
from ..ops.batching import tree_map
from ..ops.quantization import QuantizedWeight, quantize_params
from ..utils import env as _env
from .dispatcher import Dispatcher, ServeFuture

log = logging.getLogger("horovod_tpu_torch.serve")

_OFF = ("", "off", "none", "0", "false", "no")


def _move(x: Any, device) -> Any:
    """A tensor or a whole ``QuantizedWeight`` on ``device``; else ``x``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    if isinstance(x, QuantizedWeight):
        return x.to(device)
    return x


def _place(state: Any, device: torch.device) -> Any:
    """``state`` on ``device`` (a module moves in place)."""
    if isinstance(state, torch.nn.Module):
        return state.to(device)
    return tree_map(lambda x: _move(x, device), state)


def _to_host(outputs: Any) -> Any:
    return tree_map(lambda x: _move(x, "cpu"), outputs)


def _resolve_weight_dtype(weight_dtype: Optional[str]) -> str:
    if weight_dtype is None:
        return _env.serve_weight_dtype()
    wd = str(weight_dtype).strip().lower()
    if wd in _OFF:
        return ""
    if wd != "int8":
        raise ValueError(f"weight_dtype must be off|int8, got {weight_dtype!r}")
    return wd


class ServingWorker:
    """One serving replica: a thread looping lease -> infer -> complete."""

    def __init__(self, pool: "ServePool", name: str, params: Any,
                 ckpt_step: Optional[int]):
        self.pool = pool
        self.name = name
        self.params = params
        self.ckpt_step = ckpt_step
        # Held by the swapper while this worker's weights are replaced
        # and by the worker while it picks them up: a batch never runs on
        # half-swapped state.
        self.swap_lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"hvdtpu-serve-{name}", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        device = self.pool.device
        on_card = (
            torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext()
        )
        with on_card, torch.inference_mode():
            self._serve()
        self._draining.set()

    def _serve(self) -> None:
        d = self.pool.dispatcher
        while not self._stop.is_set():
            if self._draining.is_set():
                break  # drained: in-flight work finished, lease no more
            lease = d.lease(self.name, timeout=0.05)
            if lease is None:
                continue
            try:
                if _chaos.enabled():
                    fault = _chaos.act("serve.dispatch", worker=self.name)
                    if fault is not None:
                        if fault.kind == "timeout":
                            # Abandon the lease: the reaper re-queues it
                            # (the hung-worker path).
                            continue
                        if fault.kind == "error":
                            raise RuntimeError(
                                "chaos: injected serve dispatch error")
                with self.swap_lock:
                    params = self.params
                with _trace.span(
                    "serve.infer", cat="serve", worker=self.name,
                    lease=lease.lease_id, n=len(lease.requests),
                ):
                    batch = _place(lease.batch, self.pool.device)
                    outputs = _to_host(self.pool._infer(params, batch))
                d.complete(lease, outputs)
            except Exception as e:  # noqa: BLE001 - any infer failure
                log.warning(
                    "serving worker %s failed a batch (%s); re-queueing",
                    self.name, e,
                )
                d.fail(lease)

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful exit: stop leasing, let the in-flight batch finish."""
        self._draining.set()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def kill(self, join_timeout: float = 0.5) -> None:
        """Simulated crash: the thread is told to stop and whatever it
        held in flight is re-queued. The join is best-effort -- a worker
        wedged inside infer is the case the re-queue exists for, and a
        late answer from it is idempotent."""
        self._stop.set()
        self._thread.join(timeout=join_timeout)
        self.pool.dispatcher.requeue_worker(self.name)


class ServePool:
    """In-process replicated serving pool on one device (default: this
    process's card; raises without CUDA unless ``device="cpu"``)."""

    def __init__(
        self,
        infer_fn: Callable[[Any, Any], Any],
        params: Any = None,
        *,
        ckpt_dir: Optional[str] = None,
        ckpt_target: Any = None,
        workers: Optional[int] = None,
        batch_size: Optional[int] = None,
        batch_timeout_ms: Optional[float] = None,
        request_timeout_secs: Optional[float] = None,
        policy: Optional[QueueDepthPolicy] = None,
        autoscale: bool = False,
        ckpt_poll_secs: Optional[float] = None,
        weight_dtype: Optional[str] = None,
        autotune=None,
        device=None,
    ):
        if params is None and ckpt_dir is None:
            raise ValueError("need initial params or ckpt_dir")
        self.weight_dtype = _resolve_weight_dtype(weight_dtype)
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.ckpt_target = ckpt_target if ckpt_target is not None else params
        # What a restore loads into: with int8 weights a module template is
        # restored as an fp32 copy, then stored in its own dtypes again.
        self._restore_target = self.ckpt_target
        self._storage_dtypes: Optional[Dict[str, torch.dtype]] = None
        if (self.weight_dtype == "int8" and ckpt_dir is not None
                and isinstance(self.ckpt_target, torch.nn.Module)):
            self._storage_dtypes = {
                n: p.dtype for n, p in self.ckpt_target.named_parameters()}
            self._restore_target = copy.deepcopy(self.ckpt_target).float()
        self._infer = infer_fn
        self.dispatcher = Dispatcher(
            batch_size=batch_size,
            batch_timeout_ms=batch_timeout_ms,
            request_timeout_secs=request_timeout_secs,
        )
        self.n_workers_init = (
            workers if workers is not None else _env.serve_workers()
        )
        self.policy = policy
        self.autoscale = autoscale
        if autoscale and policy is None:
            self.policy = QueueDepthPolicy()
        self._ckpt_poll = (
            ckpt_poll_secs if ckpt_poll_secs is not None
            else _env.serve_ckpt_poll_secs()
        )
        self._init_params = params
        self._init_step: Optional[int] = None
        self._workers: Dict[str, ServingWorker] = {}
        self._next_worker = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._watcher: Optional[_ckpt.CheckpointWatcher] = None
        # The serving twin of the closed-loop autotuner (HVDTPU_AUTOTUNE=1
        # or autotune=True/AutotuneConfig): it tunes the dispatcher's fill
        # window and the autoscaler's watermarks against the p95 of
        # serve.request_ms under live load, flipping them in place.
        from ..tune import resolve as _tune_resolve

        self._tune_cfg = _tune_resolve(autotune)
        self.tuner = None
        # (worker, step, t_start, t_end) per completed swap -- the
        # one-at-a-time evidence.
        self.swap_log: List[Tuple[str, int, float, float]] = []
        self.started = False

    # -- lifecycle ---------------------------------------------------------

    def _prepare(self, state: Any) -> Any:
        """The once-per-restore transform: onto the pool's device, then with
        int8 weights quantized there (before any worker sees them)."""
        state = _place(state, self.device)
        if self.weight_dtype != "int8":
            return state
        state = quantize_params(state)
        if self._storage_dtypes is not None:
            for name, p in state.named_parameters():
                want = self._storage_dtypes.get(name)
                if want is not None and p.dtype != want:
                    p.data = p.data.to(want)
        return state

    def _restore(self, step: Optional[int] = None):
        """``(state, step, rolled_back)``; ``state`` is prepared unless the
        restore rolled back."""
        state, got, rolled_back = _ckpt.hot_swap_restore(
            self.ckpt_dir, self._restore_target, step=step
        )
        if rolled_back:
            return None, got, True
        return self._prepare(state), got, False

    def start(self) -> "ServePool":
        if self.started:
            return self
        self.started = True
        _sobs.set_weight_bits(8 if self.weight_dtype == "int8" else 0)
        if self.ckpt_dir is not None:
            params, step, _ = self._restore()
            _sobs.set_ckpt_step(step if step is not None else -1)
        else:
            params = self._init_params
            if self.weight_dtype == "int8" and isinstance(
                    params, torch.nn.Module):
                params = copy.deepcopy(params)  # quantized in place
            params, step = self._prepare(params), None
        self._init_params, self._init_step = params, step
        if self.ckpt_dir is not None:
            self._watcher = _ckpt.CheckpointWatcher(
                self.ckpt_dir, initial=step
            )
        for _ in range(self.n_workers_init):
            self._spawn_worker()
        loops = [(self._reaper, "serve-reaper")]
        if self._watcher is not None:
            loops.append((self._swap_watch, "serve-swap"))
        if self.autoscale:
            loops.append((self._autoscale_loop, "serve-autoscale"))
        if self._tune_cfg is not None:
            from ..tune.serve import ServeTuner

            self.tuner = ServeTuner(self, self._tune_cfg).start()
        for target, name in loops:
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, drain: bool = True) -> None:
        if self.tuner is not None:
            self.tuner.stop()
        self._stop.set()
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if drain:
                w.drain()
            else:
                w.kill()
        self.dispatcher.close()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- client API --------------------------------------------------------

    def submit(self, payload: Any) -> ServeFuture:
        return self.dispatcher.submit(payload)

    @property
    def n_workers(self) -> int:
        with self._lock:
            return len(self._workers)

    # -- elasticity --------------------------------------------------------

    def _spawn_worker(self) -> str:
        with self._lock:
            name = f"w{self._next_worker}"
            self._next_worker += 1
            w = ServingWorker(self, name, self._init_params, self._init_step)
            self._workers[name] = w
            n = len(self._workers)
        w.start()
        _sobs.set_workers(n)
        log.info("serving worker %s joined the pool (%d live)", name, n)
        return name

    def _retire_worker(self) -> Optional[str]:
        """Scale-down: drain the newest worker."""
        with self._lock:
            if not self._workers:
                return None
            name = sorted(
                self._workers,
                key=lambda n: int(n[1:]) if n[1:].isdigit() else 0,
            )[-1]
            w = self._workers.pop(name)
            n = len(self._workers)
        w.drain()
        _sobs.drop_worker_gauges(name)
        _sobs.set_workers(n)
        log.info("serving worker %s drained out of the pool (%d live)", name, n)
        return name

    def scale_to(self, target: int) -> None:
        target = max(1, int(target))
        while self.n_workers < target:
            self._spawn_worker()
        while self.n_workers > target:
            self._retire_worker()

    def kill_worker(self, name: str) -> bool:
        """Hard-kill one worker: its in-flight requests are re-queued to
        the survivors."""
        with self._lock:
            w = self._workers.pop(name, None)
            n = len(self._workers)
        if w is None:
            return False
        w.kill()
        _sobs.drop_worker_gauges(name)
        _sobs.set_workers(n)
        return True

    def _autoscale_loop(self) -> None:
        while not self._stop.wait(0.1):
            d = self.dispatcher
            target = self.policy.decide(
                queue_depth=d.queue_depth,
                in_flight=d.in_flight,
                workers=self.n_workers,
            )
            if target != self.n_workers:
                self.scale_to(target)

    def _reaper(self) -> None:
        period = max(0.05, self.dispatcher.request_timeout_secs / 4.0)
        while not self._stop.wait(min(period, 1.0)):
            self.dispatcher.reap_expired()

    # -- rolling hot-swap --------------------------------------------------

    def _swap_watch(self) -> None:
        while not self._stop.wait(self._ckpt_poll):
            step = self._watcher.poll()
            if step is not None:
                try:
                    self.hot_swap(step)
                except Exception as e:  # noqa: BLE001 - keep serving
                    # Transient failure, not a corrupt target (that path
                    # returns False after quarantine): re-offer the step.
                    log.warning("hot-swap to step %s failed: %s", step, e)
                    self._watcher.rewind(step)

    def hot_swap(self, step: int) -> bool:
        """Roll the pool onto checkpoint ``step``, one worker at a time.

        Every worker restores from disk independently, under its swap lock,
        while the other workers keep serving. A corrupt target rolls back:
        the walk-back restore quarantines it, this worker keeps its
        weights, and no further worker attempts the bad step. Returns True
        when the pool finished the roll on ``step``."""
        n_swapped = 0
        # Loop until no live worker is left on an older step: a worker the
        # autoscaler spawns mid-roll would otherwise serve stale weights.
        while True:
            with self._lock:
                pending = [
                    self._workers[n]
                    for n in sorted(self._workers)
                    if self._workers[n].ckpt_step != step
                ]
            if not pending:
                break
            for w in pending:
                t0 = time.time()
                with _trace.span("serve.hotswap", cat="serve",
                                 worker=w.name, step=step):
                    state, got, rolled_back = self._restore(step)
                if rolled_back:
                    _sobs.record_rollback()
                    log.warning(
                        "hot-swap target step %d was corrupt; pool stays "
                        "on step %s (walk-back rollback)", step, w.ckpt_step,
                    )
                    return False
                if n_swapped == 0:
                    # Workers spawned from here on load the NEW weights.
                    self._init_params, self._init_step = state, got
                with w.swap_lock:
                    w.params = state
                    w.ckpt_step = got
                self.swap_log.append((w.name, got, t0, time.time()))
                _sobs.record_hotswap()
                n_swapped += 1
        if n_swapped == 0:
            # No live workers: validate and adopt the step for future
            # spawns.
            state, got, rolled_back = self._restore(step)
            if rolled_back:
                _sobs.record_rollback()
                return False
            self._init_params, self._init_step = state, got
        _sobs.set_ckpt_step(step)
        log.info(
            "pool rolled onto checkpoint step %d (%d swaps)", step, n_swapped
        )
        return True
