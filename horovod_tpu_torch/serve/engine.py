"""Token-level decode engine: continuous batching at decode granularity.

The port of the JAX package's ``serve/engine.py``. Where
:class:`~.pool.ServePool` is request-level (one pack, one forward, one
unpack), this engine is autoregressive: streams join and leave the fixed
decode batch between decode steps.

* **Admission** happens between rounds: free rows pull queued prompts, the
  prompts are packed into the one prefill shape with
  :func:`~..ops.batching.pack_prompts` (its ``BatchSpec`` maps prefill
  rows back to streams), their K/V are written into the worker's paged pool
  (:mod:`.kvcache`), and the first token streams back at once (TTFT).
* **Decode** is one fixed-shape step over all active rows: a gather through
  the block tables, one ``extend`` call, one scatter of the new K/V, one
  committed token a row.
* **Speculative decoding** (``spec_k > 0`` and draft params): the draft
  proposes ``spec_k`` tokens from its own paged cache, the target scores the
  window in one ``spec_k + 1``-wide verify pass, the longest agreeing
  prefix plus the target's own next token commit, and both tables roll back
  past the rejected tail. Greedy speculative decoding is output-invariant.

Zero drops: the engine keeps an assignment ledger, and a worker that dies
mid-sequence has its streams re-queued at the front and resumed from prompt
+ committed tokens on a survivor (a re-prefill rebuilds the cache; tokens
already streamed are never emitted again, and commits are epoch-guarded so
a late write from the dead worker is refused). Under KV pressure the
youngest row is preempted (re-queued, its blocks freed), never dropped.

Each worker is a thread that runs ``model.extend`` eagerly under
``torch.inference_mode()`` (where the JAX package jits it) on the engine's
device, default this process's card. The ``serve.decode`` chaos site
kills or stalls a worker mid-round, its streams resuming on a survivor. Not
ported yet: the goodput ledger, trace spans, ``serve.*`` gauges and
streamed weight versions (A14); :meth:`DecodeEngine.attach_stream`
raises.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import chaos as _chaos
from ..context import resolve_device
from ..elastic.scale import QueueDepthPolicy
from ..ops.batching import pack_prompts, tree_map
from ..utils import env as _env
from .dispatcher import ServeFuture, ServeRequestDropped
from .kvcache import KVBlockPool, OutOfBlocks

__all__ = ["DecodeEngine", "DecodeWorker", "StreamFuture"]

log = logging.getLogger("horovod_tpu_torch.serve")


class StreamFuture(ServeFuture):
    """Client handle for one decode stream. ``result()`` returns the full
    generated token list; :meth:`tokens_so_far` reads the stream as it
    grows (each token once, in order, across a worker death and resume)."""

    def __init__(self, request_id: int):
        super().__init__(request_id)
        self.submit_t = time.time()
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self._stream_tokens: List[int] = []
        self._token_times: List[float] = []

    def tokens_so_far(self) -> List[int]:
        with self._lock:
            return list(self._stream_tokens)

    def token_times(self) -> List[float]:
        """Wall-clock commit time of every streamed token (per-output-token
        latencies come from these)."""
        with self._lock:
            return list(self._token_times)

    def _append_token(self, tok: int, now: float) -> None:
        with self._lock:
            self._stream_tokens.append(tok)
            self._token_times.append(now)
            if self.first_token_t is None:
                self.first_token_t = now
            self.last_token_t = now


class _Stream:
    """Prompt + committed tokens: everything a fresh worker needs to pick
    the sequence back up."""

    __slots__ = ("id", "prompt", "max_new", "eos", "future", "committed",
                 "epoch", "attempts", "admit_seq")

    def __init__(self, sid: int, prompt: np.ndarray, max_new: int,
                 eos: Optional[int]):
        self.id = sid
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.future = StreamFuture(sid)
        self.committed: List[int] = []
        self.epoch = 0
        self.attempts = 0
        self.admit_seq = -1

    def prefill_tokens(self) -> np.ndarray:
        """The tokens whose K/V must be cached before the next decode feed:
        prompt + committed[:-1] (the last committed token is the next
        feed)."""
        if not self.committed:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.committed[:-1], np.int32)])


class _Row:
    __slots__ = ("stream", "epoch", "table", "draft_table")

    def __init__(self, stream: _Stream, epoch: int, table, draft_table):
        self.stream = stream
        self.epoch = epoch
        self.table = table
        self.draft_table = draft_table


class _InjectedCrash(Exception):
    """The chaos ``serve.decode:crash`` kill of a decode worker's thread."""


class DecodeWorker:
    """One decode replica: its paged KV pool(s) and a thread running the
    admit -> step loop over ``rows`` fixed decode lanes.

    Chaos site ``serve.decode`` (context: the worker's name and its round
    count as ``step``): ``crash`` kills the worker's thread mid-round --
    its streams are requeued and resume elsewhere from prompt plus
    committed tokens -- and ``delay`` stalls one round."""

    def __init__(self, engine: "DecodeEngine", name: str):
        self.engine = engine
        self.name = name
        e = engine
        self.rows: List[Optional[_Row]] = [None] * e.rows_n
        self.pool = KVBlockPool(
            e.kv_blocks, e.kv_block_size, n_layers=e.model.n_layers,
            n_heads=e.model.n_heads, head_dim=e.model.head_dim,
            kv_dtype=e.kv_dtype, device=e.device,
        )
        self.draft_pool = None
        if e.spec_k:
            self.draft_pool = KVBlockPool(
                e.kv_blocks, e.kv_block_size,
                n_layers=e.draft_model.n_layers,
                n_heads=e.draft_model.n_heads,
                head_dim=e.draft_model.head_dim, kv_dtype=e.kv_dtype,
                device=e.device,
            )
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._round = 0
        self._thread = threading.Thread(
            target=self._run, name=f"hvt-decode-{name}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def n_active(self) -> int:
        return sum(1 for r in self.rows if r is not None)

    def drain(self, timeout: float = 30.0) -> bool:
        self._draining.set()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def kill(self, join_timeout: float = 0.5) -> None:
        self._stop.set()
        self._thread.join(timeout=join_timeout)

    # -- loop --------------------------------------------------------------

    def _run(self) -> None:
        eng = self.engine
        try:
            with torch.inference_mode():
                while not self._stop.is_set():
                    if not self._draining.is_set():
                        self._admit()
                    if self.n_active == 0:
                        if self._draining.is_set():
                            break
                        with eng._cond:
                            if not eng._queue and not self._stop.is_set():
                                eng._cond.wait(0.02)
                        continue
                    self._round += 1
                    if _chaos.enabled():
                        fault = _chaos.action(
                            "serve.decode", worker=self.name,
                            step=self._round)
                        if fault is not None:
                            if fault.kind == "crash":
                                raise _InjectedCrash()
                            if fault.kind == "delay":
                                time.sleep(float(fault.value or 0.01))
                    if eng.spec_k:
                        self._spec_round()
                    else:
                        self._decode_round()
                    eng._note_round(self.n_active)
        except _InjectedCrash:
            log.warning("decode worker %s killed by chaos mid-round",
                        self.name)
            eng._worker_died(self)
            return
        except Exception:  # noqa: BLE001 - any failed round: zero drops
            log.exception(
                "decode worker %s failed a round; re-queueing its streams",
                self.name)
            eng._worker_died(self)
            return
        eng._worker_left(self)

    def _extend(self, target: bool, toks, pos0, block_rows, seq_lens):
        """One ``extend`` call of the target (or draft) on this worker's
        pool: the host arrays onto the device; returns (greedy tokens
        ``[R, W]`` on the host, k_new, v_new)."""
        eng = self.engine
        model, params, pool = ((eng.model, eng.params, self.pool) if target
                               else (eng.draft_model, eng.draft_params,
                                     self.draft_pool))
        dev = eng.device

        def put(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        logits, k_new, v_new = model.extend(
            params, put(toks), put(pos0), put(block_rows), put(seq_lens),
            *pool.device_args())
        # The greedy pick on the device (first maximum, as numpy's argmax);
        # only the [R, W] indices cross to the host.
        return logits.argmax(dim=-1).cpu().numpy(), k_new, v_new

    # -- admission ---------------------------------------------------------

    def _admit(self) -> int:
        eng = self.engine
        free = [i for i, r in enumerate(self.rows) if r is None]
        if not free:
            return 0
        slack = eng.round_width + 1
        taken: List[_Stream] = []
        # The draft pool is a separate full-size pool mirroring the
        # allocation: budget each pool against its own free count (a
        # doubled need against one pool would refuse large valid streams
        # forever and livelock the queue behind them).
        blocks_left = self.pool.n_free
        draft_left = self.draft_pool.n_free if self.draft_pool else 0
        bs = eng.kv_block_size
        with eng._cond:
            while len(taken) < len(free) and eng._queue:
                s = eng._queue[0]
                need = -(-(len(s.prefill_tokens()) + slack) // bs)
                if need > blocks_left or (
                        self.draft_pool is not None and need > draft_left):
                    break  # backpressure: the head stays queued
                eng._queue.popleft()
                blocks_left -= need
                draft_left -= need
                s.epoch += 1
                s.admit_seq = next(eng._admit_seq)
                eng._assigned[s.id] = (self.name, s)
                taken.append(s)
        if not taken:
            return 0
        self._prefill(taken, free)
        return len(taken)

    def _prefill(self, taken: List[_Stream], free_rows: List[int]) -> None:
        eng = self.engine
        s_len = eng.max_seq_len
        # The fixed prefill shape through the request batcher: the
        # BatchSpec's slot indices are the stream <-> row routing.
        batch, spec = pack_prompts([s.prefill_tokens() for s in taken],
                                   eng.rows_n, s_len)
        row_streams: List[Optional[_Stream]] = [None] * eng.rows_n
        for row, req_idx in enumerate(spec.row_to_request):
            row_streams[row] = taken[req_idx]
        zeros = np.zeros((eng.rows_n,), np.int32)
        scratch_rows = np.full((eng.rows_n, eng.max_blocks),
                               self.pool.n_blocks, np.int64)
        toks = batch["tokens"].numpy()
        preds, k_new, v_new = self._extend(True, toks, zeros, scratch_rows,
                                           zeros)
        if self.draft_pool is not None:
            _, dk, dv = self._extend(False, toks, zeros, scratch_rows, zeros)
        # Each stream's first `length` window positions go to its fresh
        # block table (pad rows and the padded tail to scratch).
        flat = np.full((eng.rows_n, s_len), self.pool.scratch_slot, np.int64)
        dflat = flat.copy() if self.draft_pool is not None else None
        assigned: Dict[int, _Row] = {}
        for row, s in enumerate(row_streams):
            if s is None:
                continue
            n = len(s.prefill_tokens())
            table = self.pool.new_table()
            table.ensure(n)
            table.length = n
            flat[row, :] = table.flat_slots(0, s_len)
            draft_table = None
            if self.draft_pool is not None:
                draft_table = self.draft_pool.new_table()
                draft_table.ensure(n)
                draft_table.length = n
                dflat[row, :] = draft_table.flat_slots(0, s_len)
            assigned[row] = _Row(s, s.epoch, table, draft_table)
        self.pool.write(flat, k_new, v_new)
        if self.draft_pool is not None:
            self.draft_pool.write(dflat, dk, dv)
        # Prefill rows into free decode lanes, streaming the first token of
        # every fresh stream (a resumed one holds it already).
        lanes = iter(free_rows)
        for row, prow in assigned.items():
            lane = next(lanes)
            self.rows[lane] = prow
            s = prow.stream
            if not s.committed:
                self._commit_lane(lane, int(preds[row, len(s.prompt) - 1]))

    # -- stepping ----------------------------------------------------------

    def _commit_lane(self, lane: int, tok: int) -> bool:
        """Commit one token for the stream on ``lane``; True while the lane
        keeps decoding (False: finished or stale, the lane freed)."""
        row = self.rows[lane]
        if self.engine._commit_token(row.stream, row.epoch, tok) == "ok":
            return True
        self._release_lane(lane)
        return False

    def _release_lane(self, lane: int) -> None:
        row = self.rows[lane]
        if row is None:
            return
        row.table.release()
        if row.draft_table is not None:
            row.draft_table.release()
        self.rows[lane] = None

    def _active_lanes(self) -> List[int]:
        return [i for i, r in enumerate(self.rows) if r is not None]

    def _ensure_capacity(self, lane: int, target_tokens: int,
                         draft_tokens: int) -> bool:
        """Grow this lane's table(s); under pool pressure preempt the
        youngest other lane (re-queued with its committed tokens: the
        resume path), and as a last resort this lane itself."""
        while True:
            row = self.rows[lane]
            try:
                row.table.ensure(target_tokens)
                if row.draft_table is not None:
                    row.draft_table.ensure(draft_tokens)
                return True
            except OutOfBlocks:
                victims = [i for i in self._active_lanes() if i != lane]
                if not victims:
                    self._preempt_lane(lane)
                    return False
                self._preempt_lane(max(
                    victims, key=lambda i: self.rows[i].stream.admit_seq))

    def _preempt_lane(self, lane: int) -> None:
        self.engine._requeue([self.rows[lane].stream], preempt=True)
        self._release_lane(lane)

    def _decode_round(self) -> int:
        eng = self.engine
        r, m = eng.rows_n, eng.max_blocks
        for lane in self._active_lanes():
            row = self.rows[lane]
            if row is None:  # preempted by an earlier lane's ensure
                continue
            self._ensure_capacity(lane, row.table.length + 1, 0)
        lanes = self._active_lanes()
        if not lanes:
            return 0
        toks = np.zeros((r, 1), np.int32)
        pos0 = np.zeros((r,), np.int32)
        seq = np.zeros((r,), np.int32)
        br = np.full((r, m), self.pool.n_blocks, np.int64)
        flat = np.full((r, 1), self.pool.scratch_slot, np.int64)
        for lane in lanes:
            row = self.rows[lane]
            toks[lane, 0] = row.stream.committed[-1]
            pos0[lane] = seq[lane] = row.table.length
            br[lane] = row.table.padded_blocks(m)
            flat[lane, 0] = row.table.flat_slots(row.table.length, 1)[0]
        preds, k_new, v_new = self._extend(True, toks, pos0, br, seq)
        self.pool.write(flat, k_new, v_new)
        for lane in lanes:
            self.rows[lane].table.length += 1
            self._commit_lane(lane, int(preds[lane, 0]))
        return len(lanes)

    def _spec_round(self) -> int:
        eng = self.engine
        j = eng.spec_k
        r, m = eng.rows_n, eng.max_blocks
        for lane in self._active_lanes():
            row = self.rows[lane]
            if row is None:  # preempted by an earlier lane's ensure
                continue
            # base + j covers the verify window (target) and the longest
            # post-round truncate (draft) in one reservation.
            base = len(row.stream.prompt) + len(row.stream.committed)
            self._ensure_capacity(lane, base + j, base + j)
        lanes = self._active_lanes()
        if not lanes:
            return 0
        # The draft: j + 1 one-token calls. Each lane first catches its
        # draft cache up to the committed stream (1 feed, 2 after a round
        # that accepted everything), then feeds its own proposals.
        full: Dict[int, np.ndarray] = {}
        pending: Dict[int, int] = {}
        proposals: Dict[int, List[int]] = {i: [] for i in lanes}
        for lane in lanes:
            row = self.rows[lane]
            full[lane] = np.concatenate([
                row.stream.prompt,
                np.asarray(row.stream.committed, np.int32)])
            pending[lane] = len(full[lane]) - row.draft_table.length
        d_len = {lane: self.rows[lane].draft_table.length for lane in lanes}
        for c in range(j + 1):
            toks = np.zeros((r, 1), np.int32)
            pos0 = np.zeros((r,), np.int32)
            seq = np.zeros((r,), np.int32)
            br = np.full((r, m), self.draft_pool.n_blocks, np.int64)
            flat = np.full((r, 1), self.draft_pool.scratch_slot, np.int64)
            for lane in lanes:
                row = self.rows[lane]
                if c < pending[lane]:
                    feed = int(full[lane][d_len[lane]])
                else:
                    feed = proposals[lane][c - pending[lane]]
                toks[lane, 0] = feed
                pos0[lane] = seq[lane] = d_len[lane]
                row.draft_table.ensure(d_len[lane] + 1)
                br[lane] = row.draft_table.padded_blocks(m)
                flat[lane, 0] = row.draft_table.flat_slots(d_len[lane], 1)[0]
            preds, dk, dv = self._extend(False, toks, pos0, br, seq)
            self.draft_pool.write(flat, dk, dv)
            for lane in lanes:
                d_len[lane] += 1
                self.rows[lane].draft_table.length = d_len[lane]
                if c >= pending[lane] - 1:
                    proposals[lane].append(int(preds[lane, 0]))
        # The target's verify: one (j + 1)-wide pass over [last committed
        # token, proposals...]; preds[:, i] follows window token i.
        win = np.zeros((r, j + 1), np.int32)
        pos0 = np.zeros((r,), np.int32)
        seq = np.zeros((r,), np.int32)
        br = np.full((r, m), self.pool.n_blocks, np.int64)
        flat = np.full((r, j + 1), self.pool.scratch_slot, np.int64)
        for lane in lanes:
            row = self.rows[lane]
            win[lane] = [row.stream.committed[-1]] + proposals[lane][:j]
            t_len = row.table.length
            pos0[lane] = seq[lane] = t_len
            br[lane] = row.table.padded_blocks(m)
            flat[lane] = row.table.flat_slots(t_len, j + 1)
        preds, k_new, v_new = self._extend(True, win, pos0, br, seq)
        self.pool.write(flat, k_new, v_new)
        n_committed = 0
        for lane in lanes:
            row = self.rows[lane]
            props = proposals[lane][:j]
            n_acc = 0
            while n_acc < j and props[n_acc] == int(preds[lane, n_acc]):
                n_acc += 1
            commits = props[:n_acc] + [int(preds[lane, n_acc])]
            eng._note_speculation(j, n_acc)
            base = len(full[lane])  # prompt + committed, before the round
            added = 0
            alive = True
            for tok in commits:
                added += 1
                n_committed += 1
                if not self._commit_lane(lane, tok):
                    alive = False
                    break
            if alive:
                # Roll back the rejected tail: both caches keep exactly
                # prompt + committed[:-1] tokens.
                required = base + added - 1
                row.table.truncate(required)
                row.draft_table.truncate(required)
        return n_committed


class DecodeEngine:
    """In-process token-level serving engine: N decode workers (each a
    fixed ``rows``-wide lane batch over its own paged KV pool) fed from one
    shared stream queue, on ``device`` (default: this process's card;
    raises without CUDA unless ``device="cpu"``). ``model`` is anything
    with :class:`~.model.CacheLM`'s ``extend`` contract and its
    ``n_layers``/``n_heads``/``head_dim``; the params go to ``device``."""

    def __init__(
        self,
        model,
        params,
        *,
        draft_model=None,
        draft_params=None,
        workers: int = 1,
        rows: Optional[int] = None,
        kv_blocks: Optional[int] = None,
        kv_block_size: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        max_seq_len: Optional[int] = None,
        spec_k: Optional[int] = None,
        eos_token: Optional[int] = None,
        max_attempts: int = 5,
        autoscale: bool = False,
        policy: Optional[QueueDepthPolicy] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.params = self._place(params)
        self.rows_n = rows if rows is not None else _env.serve_decode_rows()
        self.kv_blocks = (kv_blocks if kv_blocks is not None
                          else _env.serve_kv_blocks())
        self.kv_block_size = (kv_block_size if kv_block_size is not None
                              else _env.serve_kv_block_size())
        self.kv_dtype = kv_dtype
        self.max_seq_len = (max_seq_len if max_seq_len is not None
                            else _env.serve_max_seq_len())
        self.spec_k = spec_k if spec_k is not None else _env.serve_spec_k()
        if self.spec_k and draft_params is None:
            raise ValueError("spec_k > 0 needs draft_params")
        self.draft_model = draft_model if draft_model is not None else model
        self.draft_params = (self._place(draft_params)
                             if draft_params is not None else None)
        self.eos_token = eos_token
        self.max_attempts = max_attempts
        self.round_width = (self.spec_k + 1) if self.spec_k else 1
        self.max_blocks = -(-(self.max_seq_len + self.round_width)
                            // self.kv_block_size)
        self.n_workers_init = workers
        self.policy = policy
        self.autoscale = autoscale
        if autoscale and policy is None:
            self.policy = QueueDepthPolicy()
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._assigned: Dict[int, Tuple[str, _Stream]] = {}
        self._workers: Dict[str, DecodeWorker] = {}
        self._next_worker = 0
        self._stream_ids = itertools.count()
        self._admit_seq = itertools.count()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # Host counters (tests and chip_smoke.py read them).
        self.n_submitted = 0
        self.n_finished = 0
        self.n_requeued = 0
        self.n_preempted = 0
        self.n_tokens = 0
        self.n_rounds = 0
        self.fill_sum = 0.0
        self.n_proposed = 0
        self.n_accepted = 0
        self.n_hotswaps = 0
        self.started = False

    def _place(self, params):
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), params)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DecodeEngine":
        if self.started:
            return self
        self.started = True
        for _ in range(self.n_workers_init):
            self._spawn_worker()
        if self.autoscale:
            t = threading.Thread(target=self._autoscale_loop,
                                 name="hvt-decode-autoscale", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def attach_stream(self, subscriber) -> "DecodeEngine":
        raise NotImplementedError(
            "streamed weight delivery (horovod_tpu.stream) is not ported "
            "yet (ROADMAP A14); use hot_swap(params)"
        )

    def stop(self, drain: bool = True) -> None:
        self._stop.set()
        with self._cond:
            workers = list(self._workers.values())
            self._cond.notify_all()
        for w in workers:
            if drain:
                w.drain()
            else:
                w.kill()
                self._worker_died(w)
        # Reject what never got served: a queued stream with no worker left
        # must not hang its client.
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            pending.extend(s for _, s in self._assigned.values())
            self._assigned.clear()
        for s in pending:
            s.future._reject(ServeRequestDropped("decode engine shut down"))
        for t in self._threads:
            t.join(timeout=5.0)

    # -- client API --------------------------------------------------------

    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int, *,
               eos_token: Optional[int] = None) -> StreamFuture:
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new_tokens}) "
                f"exceeds max_seq_len={self.max_seq_len}"
            )
        worst = -(-(prompt.size + max_new_tokens + self.round_width)
                  // self.kv_block_size)
        if worst > self.kv_blocks:
            raise ValueError(
                f"sequence needs up to {worst} KV blocks, pool holds "
                f"{self.kv_blocks}"
            )
        eos = eos_token if eos_token is not None else self.eos_token
        with self._cond:
            if self._stop.is_set():
                raise ServeRequestDropped("decode engine is shut down")
            s = _Stream(next(self._stream_ids), prompt, max_new_tokens, eos)
            self._queue.append(s)
            self.n_submitted += 1
            self._cond.notify_all()
        return s.future

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def in_flight(self) -> int:
        with self._cond:
            return len(self._assigned)

    @property
    def n_workers(self) -> int:
        with self._cond:
            return len(self._workers)

    def worker_names(self) -> List[str]:
        with self._cond:
            return sorted(self._workers)

    def pools(self) -> List[KVBlockPool]:
        """Every live worker's target pool (for their stats and bytes)."""
        with self._cond:
            return [w.pool for w in self._workers.values()]

    def hot_swap(self, params, draft_params=None, *,
                 version: Optional[int] = None) -> None:
        """Swap the serving weights in place; workers pick the new params up
        at their next round (in-flight streams continue on the new weights
        over their existing cache). ``version`` belongs to streamed weight
        delivery, not ported yet (A14)."""
        if version is not None:
            raise NotImplementedError(
                "versioned hot swaps (streamed weight delivery) are not "
                "ported yet (ROADMAP A14)"
            )
        params = self._place(params)
        draft = self._place(draft_params) if draft_params is not None else None
        with self._cond:
            self.params = params
            if draft is not None:
                self.draft_params = draft
            self.n_hotswaps += 1

    # -- elasticity --------------------------------------------------------

    def _spawn_worker(self) -> str:
        with self._cond:
            name = f"w{self._next_worker}"
            self._next_worker += 1
            w = DecodeWorker(self, name)
            self._workers[name] = w
            n = len(self._workers)
        w.start()
        log.info("decode worker %s joined the engine (%d live)", name, n)
        return name

    def _retire_worker(self) -> Optional[str]:
        with self._cond:
            if len(self._workers) <= 1:
                return None
            name = max(self._workers, key=lambda n: int(n[1:]))
            w = self._workers.pop(name)
        w.drain()
        return name

    def scale_to(self, target: int) -> None:
        target = max(1, int(target))
        while self.n_workers < target:
            self._spawn_worker()
        while self.n_workers > target:
            if self._retire_worker() is None:
                break

    def kill_worker(self, name: str) -> bool:
        """Hard-kill one decode worker: every stream it held resumes on a
        survivor from prompt + committed tokens."""
        with self._cond:
            w = self._workers.pop(name, None)
        if w is None:
            return False
        w.kill()
        self._requeue_for_worker(name)
        return True

    def _autoscale_loop(self) -> None:
        while not self._stop.wait(0.1):
            target = self.policy.decide(
                queue_depth=self.queue_depth, in_flight=self.in_flight,
                workers=self.n_workers,
            )
            if target != self.n_workers:
                self.scale_to(target)

    # -- worker callbacks --------------------------------------------------

    def _worker_died(self, worker: DecodeWorker) -> None:
        with self._cond:
            self._workers.pop(worker.name, None)
        self._requeue_for_worker(worker.name)

    def _worker_left(self, worker: DecodeWorker) -> None:
        with self._cond:
            self._workers.pop(worker.name, None)

    def _requeue_for_worker(self, name: str) -> None:
        with self._cond:
            mine = sorted((s for w, s in self._assigned.values() if w == name),
                          key=lambda s: s.admit_seq)
            for s in mine:
                del self._assigned[s.id]
                # Only worker deaths spend the retry budget: a KV-pressure
                # preemption (_requeue) is ordinary backpressure.
                s.attempts += 1
            requeued = [s for s in mine if not s.future.done()
                        and s.attempts < self.max_attempts]
            for s in mine:
                if s not in requeued and not s.future.done():
                    s.future._reject(ServeRequestDropped(
                        f"stream {s.id} failed after {s.attempts} attempts"))
            for s in reversed(requeued):
                s.epoch += 1
                self._queue.appendleft(s)
            self.n_requeued += len(requeued)
            self._cond.notify_all()

    def _requeue(self, streams: List[_Stream], preempt: bool = False) -> None:
        with self._cond:
            for s in reversed(streams):
                self._assigned.pop(s.id, None)
                s.epoch += 1
                self._queue.appendleft(s)
            if preempt:
                self.n_preempted += len(streams)
            else:
                self.n_requeued += len(streams)
            self._cond.notify_all()

    def _commit_token(self, stream: _Stream, epoch: int, tok: int) -> str:
        """Append one token to a stream: the only commit path, epoch-guarded
        so a late write from a dead or retired worker never lands
        (``"stale"``). Returns ``"ok"``, ``"done"`` or ``"stale"``."""
        now = time.time()
        with self._cond:
            if stream.epoch != epoch or stream.future.done():
                return "stale"
            stream.committed.append(tok)
            stream.future._append_token(tok, now)
            finished = (len(stream.committed) >= stream.max_new
                        or (stream.eos is not None and tok == stream.eos))
            self.n_tokens += 1
            if finished:
                self._assigned.pop(stream.id, None)
                self.n_finished += 1
                stream.future._resolve(list(stream.committed))
        return "done" if finished else "ok"

    def _note_round(self, n_active: int) -> None:
        with self._cond:
            self.n_rounds += 1
            self.fill_sum += n_active / self.rows_n

    def _note_speculation(self, proposed: int, accepted: int) -> None:
        with self._cond:
            self.n_proposed += proposed
            self.n_accepted += accepted
