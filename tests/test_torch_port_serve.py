"""The port's serving tier (horovod_tpu_torch.serve) on the CPU,
mirroring tests/test_serve.py: the dispatcher's exactly-once ledger,
the queue-depth policy, the pool's requeue/drain/autoscale paths, the
rolling hot-swap (one worker at a time, corrupt-target rollback) -- and
the JAX package's ServePool and the port's answering the same tiny-GPT-2
requests with the same values."""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.serve import ServePool as JaxServePool
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.serve import (
    Dispatcher,
    QueueDepthPolicy,
    ServePool,
    ServeRequestDropped,
    ServeRequestFailed,
)


def _requests(n, d=3):
    return [
        {"x": torch.full((d,), float(i)), "n": torch.tensor(i, dtype=torch.int32)}
        for i in range(n)
    ]


def _echo(lease):
    return {"x": lease.batch["x"], "n": lease.batch["n"]}


class TestDispatcher:
    def test_lease_complete_resolves_futures(self):
        d = Dispatcher(batch_size=4, batch_timeout_ms=5.0,
                       request_timeout_secs=5.0)
        futs = [d.submit(r) for r in _requests(3)]
        lease = d.lease("w0", timeout=0.5)
        assert lease is not None and lease.spec.fill == pytest.approx(3 / 4)
        assert d.in_flight == 3 and d.queue_depth == 0
        d.complete(lease, _echo(lease))
        for i, f in enumerate(futs):
            assert float(f.result(timeout=1.0)["x"][0]) == float(i)
        assert d.in_flight == 0 and d.n_resolved == 3
        assert len(d.latencies) == 3

    def test_continuous_batching_window(self):
        d = Dispatcher(batch_size=4, batch_timeout_ms=200.0,
                       request_timeout_secs=5.0)
        d.submit(_requests(1)[0])
        t = threading.Thread(
            target=lambda: (time.sleep(0.03), d.submit(_requests(2)[1]))
        )
        t.start()
        lease = d.lease("w0", timeout=0.5)
        t.join()
        assert len(lease.requests) == 2

    def test_empty_lease_times_out(self):
        assert Dispatcher(batch_size=4).lease("w0", timeout=0.05) is None

    def test_fail_requeues_in_order(self):
        d = Dispatcher(batch_size=4, batch_timeout_ms=1.0,
                       request_timeout_secs=5.0)
        futs = [d.submit(r) for r in _requests(3)]
        lease = d.lease("w0", timeout=0.5)
        assert d.fail(lease) == 3
        assert d.queue_depth == 3 and d.in_flight == 0 and d.n_requeued == 3
        lease2 = d.lease("w1", timeout=0.5)
        assert [r.id for r in lease2.requests] == [0, 1, 2]
        d.complete(lease2, _echo(lease2))
        assert all(f.done() for f in futs)

    def test_max_attempts_rejects(self):
        d = Dispatcher(batch_size=1, batch_timeout_ms=0.0,
                       request_timeout_secs=5.0, max_attempts=2)
        fut = d.submit(_requests(1)[0])
        for _ in range(2):
            d.fail(d.lease("w0", timeout=0.5))
        with pytest.raises(ServeRequestFailed):
            fut.result(timeout=1.0)

    def test_reap_expired_requeues(self):
        d = Dispatcher(batch_size=2, batch_timeout_ms=1.0,
                       request_timeout_secs=0.05)
        d.submit(_requests(1)[0])
        assert d.lease("w0", timeout=0.5) is not None
        assert d.reap_expired(now=time.time() + 1.0) == 1
        assert d.queue_depth == 1 and d.in_flight == 0

    def test_requeue_worker_only_hits_that_worker(self):
        d = Dispatcher(batch_size=1, batch_timeout_ms=0.0,
                       request_timeout_secs=5.0)
        d.submit(_requests(2)[0])
        d.submit(_requests(2)[1])
        l0 = d.lease("w0", timeout=0.5)
        l1 = d.lease("w1", timeout=0.5)
        assert d.requeue_worker("w0") == 1 and d.queue_depth == 1
        d.complete(l1, _echo(l1))
        assert d.in_flight == 0 and not l0.requests[0].future.done()

    def test_late_answer_wins_and_duplicate_skipped(self):
        d = Dispatcher(batch_size=1, batch_timeout_ms=0.0,
                       request_timeout_secs=5.0)
        fut = d.submit(_requests(1)[0])
        lease = d.lease("w0", timeout=0.5)
        d.fail(lease)
        assert d.complete(lease, _echo(lease)) == 1 and fut.done()
        assert d.lease("w1", timeout=0.05) is None
        assert d.n_resolved == 1

    def test_resolution_is_counted_before_the_waiter_wakes(self):
        # Each future's event records the dispatcher's count at the moment
        # it is set: by then the resolution must already be counted.
        d = Dispatcher(batch_size=4, batch_timeout_ms=1.0,
                       request_timeout_secs=5.0)
        futs = [d.submit(r) for r in _requests(4)]
        seen = []
        for f in futs:
            event_set = f._event.set

            def set_and_record(event_set=event_set):
                seen.append((d.n_resolved, len(d.latencies)))
                event_set()

            f._event.set = set_and_record
        lease = d.lease("w0", timeout=0.5)
        assert d.complete(lease, _echo(lease)) == 4
        assert seen == [(n, n) for n in range(1, 5)]
        # A settle that loses (the future was already answered) counts
        # nothing.
        assert not d._resolve_request(lease.requests[0], None)
        assert d.n_resolved == 4 and len(d.latencies) == 4

    def test_close_rejects_pending(self):
        d = Dispatcher(batch_size=4)
        fut = d.submit(_requests(1)[0])
        d.close()
        with pytest.raises(ServeRequestDropped):
            fut.result(timeout=1.0)
        with pytest.raises(ServeRequestDropped):
            d.submit(_requests(1)[0])


class TestScalePolicy:
    def _p(self, cooldown=0.0):
        return QueueDepthPolicy(min_workers=1, max_workers=4, high=4.0,
                                low=0.5, cooldown_secs=cooldown)

    def test_scale_up_down_hold(self):
        p = self._p()
        assert p.decide(queue_depth=10, workers=2, now=0.0) == 3
        assert p.decide(queue_depth=100, workers=4, now=1.0) == 4
        assert p.decide(queue_depth=0, workers=3, in_flight=0, now=2.0) == 2
        assert p.decide(queue_depth=0, workers=3, in_flight=2, now=3.0) == 3
        assert p.decide(queue_depth=0, workers=1, in_flight=0, now=4.0) == 1
        assert p.decide(queue_depth=4, workers=2, now=5.0) == 2

    def test_cooldown_hysteresis(self):
        p = self._p(cooldown=10.0)
        assert p.decide(queue_depth=50, workers=1, now=100.0) == 2
        assert p.decide(queue_depth=50, workers=2, now=101.0) == 2
        assert p.decide(queue_depth=50, workers=2, now=111.0) == 3

    def test_validation(self):
        with pytest.raises(ValueError, match="max_workers"):
            QueueDepthPolicy(min_workers=4, max_workers=2)
        with pytest.raises(ValueError, match="watermark"):
            QueueDepthPolicy(high=1.0, low=2.0)


def _mk_pool(infer=None, params=None, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("batch_size", 4)
    kw.setdefault("batch_timeout_ms", 2.0)
    kw.setdefault("request_timeout_secs", 2.0)
    return ServePool(
        infer or (lambda p, batch: batch * p["scale"]),
        params if params is not None else {"scale": torch.tensor(2.0)},
        device="cpu", **kw,
    ).start()


class TestServePool:
    def test_exactly_once_answers(self):
        pool = _mk_pool()
        try:
            futs = [pool.submit(torch.full((3,), float(i))) for i in range(9)]
            for i, f in enumerate(futs):
                got = f.result(timeout=10.0)
                assert got.device.type == "cpu"
                torch.testing.assert_close(got, torch.full((3,), 2.0 * i))
            assert pool.dispatcher.n_resolved == 9
            assert pool.dispatcher.n_submitted == 9
        finally:
            pool.stop()

    def test_many_workers_answer_each_request_exactly_once(self):
        # More workers than cores and a short switch interval: a lost
        # update in the ledger or the resolution count would show here.
        import sys

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            pool = _mk_pool(workers=12, batch_size=3, batch_timeout_ms=0.5)
            try:
                futs = [pool.submit(torch.full((2,), float(i)))
                        for i in range(300)]
                for i, f in enumerate(futs):
                    assert float(f.result(timeout=30.0)[0]) == 2.0 * i
                assert pool.dispatcher.n_resolved == 300
                assert pool.dispatcher.in_flight == 0
            finally:
                pool.stop()
        finally:
            sys.setswitchinterval(old)

    def test_workers_run_under_inference_mode(self):
        seen = []

        def infer(p, batch):
            seen.append(torch.is_inference_mode_enabled())
            return batch

        pool = _mk_pool(infer, workers=1)
        try:
            pool.submit(torch.zeros(2)).result(timeout=10.0)
        finally:
            pool.stop()
        assert seen and all(seen)

    def test_killed_worker_requests_requeue_zero_dropped(self):
        gate, w0_busy = threading.Event(), threading.Event()

        def infer(p, batch):
            if threading.current_thread().name.endswith("w0"):
                w0_busy.set()
                gate.wait(timeout=10.0)
            else:
                # w1 answers only once w0 holds a batch, so a starved w0
                # thread on a loaded host cannot find the queue drained.
                w0_busy.wait(timeout=10.0)
            return batch * 2.0

        pool = _mk_pool(infer, workers=2, batch_size=2, batch_timeout_ms=1.0,
                        request_timeout_secs=1.0)
        try:
            futs = [pool.submit(torch.full((2,), float(i))) for i in range(8)]
            t0 = time.time()
            while (pool.dispatcher.in_flight_by_worker().get("w0", 0) == 0
                   and time.time() - t0 < 5.0):
                time.sleep(0.01)
            assert pool.kill_worker("w0")
            for i, f in enumerate(futs):
                torch.testing.assert_close(f.result(timeout=10.0),
                                           torch.full((2,), 2.0 * i))
            assert pool.dispatcher.n_requeued > 0 and pool.n_workers == 1
        finally:
            gate.set()
            pool.stop()

    def test_failed_batch_is_requeued(self):
        calls = {"n": 0}

        def infer(p, batch):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient device error")
            return batch + 1.0

        pool = _mk_pool(infer, workers=1)
        try:
            assert float(pool.submit(torch.zeros(1)).result(10.0)[0]) == 1.0
            assert pool.dispatcher.n_requeued == 1
        finally:
            pool.stop()

    def test_scale_down_drains_in_flight_first(self):
        started, release = threading.Event(), threading.Event()

        def infer(p, batch):
            if threading.current_thread().name.endswith("w1"):
                started.set()
                release.wait(timeout=10.0)
            else:
                # w0 answers only once w1 holds a request, so a starved w1
                # thread on a loaded host cannot find the queue drained.
                started.wait(timeout=10.0)
            return batch + 1.0

        pool = _mk_pool(infer, workers=2, batch_size=1, batch_timeout_ms=0.0,
                        request_timeout_secs=30.0)
        try:
            futs = [pool.submit(torch.zeros((1,))) for _ in range(6)]
            assert started.wait(timeout=5.0)
            done = threading.Event()
            t = threading.Thread(target=lambda: (pool.scale_to(1), done.set()))
            t.start()
            time.sleep(0.1)
            assert not done.is_set()
            release.set()
            t.join(timeout=10.0)
            assert done.is_set() and pool.n_workers == 1
            for f in futs:
                assert float(f.result(timeout=10.0)[0]) == 1.0
            assert pool.dispatcher.n_requeued == 0
        finally:
            release.set()
            pool.stop()

    def test_autoscale_up_under_load_then_down(self):
        policy = QueueDepthPolicy(min_workers=1, max_workers=3, high=2.0,
                                  low=0.5, cooldown_secs=0.0)

        def infer(p, batch):
            time.sleep(0.02)
            return batch

        pool = _mk_pool(infer, workers=1, batch_size=2, batch_timeout_ms=1.0,
                        request_timeout_secs=30.0, policy=policy,
                        autoscale=True)
        try:
            futs = [pool.submit(torch.zeros((1,))) for _ in range(60)]
            peak, t0 = 1, time.time()
            while time.time() - t0 < 15.0:
                peak = max(peak, pool.n_workers)
                if all(f.done() for f in futs):
                    break
                time.sleep(0.01)
            assert all(f.done() for f in futs) and peak > 1
            t0 = time.time()
            while pool.n_workers > 1 and time.time() - t0 < 10.0:
                time.sleep(0.05)
            assert pool.n_workers == 1
        finally:
            pool.stop()

    def test_unported_options_raise(self):
        # autotune= is ported (test_torch_port_tune.py): a value that is
        # neither a bool nor an AutotuneConfig raises, as in the JAX
        # package, and the tuner starts with the pool.
        with pytest.raises(ValueError, match="autotune"):
            ServePool(lambda p, b: b, {"w": torch.ones(1)}, device="cpu",
                      autotune="yes")
        tuned = ServePool(lambda p, b: b, {"w": torch.ones(1)}, device="cpu",
                          autotune=True)
        assert tuned.tuner is None and tuned._tune_cfg is not None
        with pytest.raises(ValueError, match="weight_dtype"):
            ServePool(lambda p, b: b, {"w": torch.ones(1)}, device="cpu",
                      weight_dtype="fp4")
        with pytest.raises(ValueError, match="ckpt_dir"):
            ServePool(lambda p, b: b, device="cpu")
        pool = ServePool(lambda p, b: b, {"w": torch.ones(1)}, device="cpu",
                         weight_dtype="off")
        assert pool.device == torch.device("cpu")


# ---- rolling hot-swap ---------------------------------------------------


def _save_scale(d, value, step):
    ckpt.save_checkpoint(d, {"scale": torch.tensor(value)}, step=step)


def _corrupt_step(d, step):
    p = os.path.join(d, f"step_{step}", ckpt.STATE_NAME)
    with open(p, "r+b") as fh:
        fh.seek(os.path.getsize(p) // 2)
        fh.write(b"\xff" * 8)


def _ckpt_pool(tmp_path, **kw):
    return ServePool(
        lambda p, batch: batch * p["scale"], ckpt_dir=str(tmp_path),
        ckpt_target={"scale": torch.zeros(())}, batch_size=4,
        batch_timeout_ms=1.0, request_timeout_secs=5.0, ckpt_poll_secs=0.05,
        device="cpu", **kw,
    ).start()


def _answer(pool):
    return float(pool.submit(torch.ones((2,))).result(10.0)[0])


class TestHotSwap:
    def test_initial_load_walks_back_past_corruption(self, tmp_path):
        _save_scale(tmp_path, 2.0, step=1)
        _save_scale(tmp_path, 9.0, step=2)
        _corrupt_step(tmp_path, 2)
        pool = _ckpt_pool(tmp_path, workers=1)
        try:
            assert _answer(pool) == 2.0
            assert any(".corrupt" in n for n in os.listdir(tmp_path))
        finally:
            pool.stop()

    def test_rolling_swap_one_worker_at_a_time(self, tmp_path):
        _save_scale(tmp_path, 2.0, step=1)
        pool = _ckpt_pool(tmp_path, workers=3)
        try:
            _save_scale(tmp_path, 3.0, step=2)
            t0 = time.time()
            while len(pool.swap_log) < 3 and time.time() - t0 < 10.0:
                time.sleep(0.02)
            assert len(pool.swap_log) == 3
            assert all(s == 2 for _, s, _, _ in pool.swap_log)
            assert sorted(w for w, _, _, _ in pool.swap_log) == ["w0", "w1", "w2"]
            ivals = sorted((a, b) for _, _, a, b in pool.swap_log)
            for (_, end), (start, _) in zip(ivals, ivals[1:]):
                assert end <= start + 1e-9
            assert _answer(pool) == 3.0
        finally:
            pool.stop()

    def test_corrupt_hot_swap_rolls_back_and_keeps_serving(self, tmp_path):
        _save_scale(tmp_path, 2.0, step=1)
        pool = _ckpt_pool(tmp_path, workers=2)
        try:
            _save_scale(tmp_path, 9.0, step=2)
            _corrupt_step(tmp_path, 2)
            t0 = time.time()
            while (not any(".corrupt" in n for n in os.listdir(tmp_path))
                   and time.time() - t0 < 10.0):
                time.sleep(0.02)
            time.sleep(0.2)
            assert any(".corrupt" in n for n in os.listdir(tmp_path))
            assert _answer(pool) == 2.0
            assert all(s != 2 for _, s, _, _ in pool.swap_log)
            _save_scale(tmp_path, 4.0, step=3)
            t0 = time.time()
            while len(pool.swap_log) < 2 and time.time() - t0 < 10.0:
                time.sleep(0.02)
            assert _answer(pool) == 4.0
        finally:
            pool.stop()

    def test_hot_swap_covers_workers_spawned_mid_roll(self, tmp_path):
        _save_scale(tmp_path, 2.0, step=1)
        pool = _ckpt_pool(tmp_path, workers=2)
        try:
            pool.scale_to(3)
            _save_scale(tmp_path, 5.0, step=2)
            t0 = time.time()
            while len(pool.swap_log) < 3 and time.time() - t0 < 10.0:
                time.sleep(0.02)
            with pool._lock:
                steps = {w.ckpt_step for w in pool._workers.values()}
            assert steps == {2}
            pool.scale_to(4)  # a later spawn starts on the new step
            assert pool._workers["w3"].ckpt_step == 2
        finally:
            pool.stop()


# ---- the two packages answer alike --------------------------------------


def test_gpt2_answers_match_the_jax_pool():
    """The JAX package's ServePool and the port's answer the same tiny
    GPT-2 requests (fp32, flash path) with the same last-token logits."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, use_flash=True,
                                 d_model=128, n_heads=2)
    jm = jgpt2.GPT2LMModel(jcfg)
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (10, 24)
    ).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))
    jpool = JaxServePool(
        lambda p, b: jm.apply(p, b)[:, -1, :], params, workers=2,
        batch_size=4, batch_timeout_ms=2.0, request_timeout_secs=60.0,
    ).start()
    try:
        want = [np.asarray(f.result(timeout=120.0)) for f in
                [jpool.submit(jnp.asarray(t)) for t in tokens]]
    finally:
        jpool.stop()

    cfg = GPT2Config.tiny(dtype=torch.float32, use_flash=True,
                          d_model=128, n_heads=2)
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(
        convert.params_from_flax(jax.tree.map(np.asarray, params))
    )
    fa.reset_launches()
    pool = ServePool(
        lambda m, b: m(b)[:, -1, :], model, workers=2, batch_size=4,
        batch_timeout_ms=2.0, request_timeout_secs=60.0, device="cpu",
    ).start()
    try:
        got = [f.result(timeout=120.0).numpy() for f in
               [pool.submit(torch.from_numpy(t)) for t in tokens]]
        assert pool.dispatcher.n_resolved == len(tokens)
    finally:
        pool.stop()
    assert fa.launches == 0  # CPU tensors: the plain version, no kernel
    for g, w in zip(got, want):
        assert g.shape == w.shape == (cfg.vocab_size,)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_gpt2_pool_serves_a_checkpointed_model(tmp_path):
    """The chip_smoke.py path at tiny size: save the seeded weights,
    serve them from the checkpoint into a bf16 module template, and match
    a direct forward pass."""
    cfg = GPT2Config.tiny(d_model=128, n_heads=2)
    sd = convert.init_params(cfg, seed=3)
    ckpt.save_checkpoint(str(tmp_path), sd, step=1)
    template = GPT2LMModel(cfg, device="cpu")
    pool = ServePool(
        lambda m, b: m(b)[:, -1, :], ckpt_dir=str(tmp_path),
        ckpt_target=template, workers=2, batch_size=4, batch_timeout_ms=2.0,
        device="cpu",
    ).start()
    tokens = torch.randint(0, cfg.vocab_size, (6, 32),
                           generator=torch.Generator().manual_seed(0))
    try:
        got = torch.stack([f.result(timeout=60.0) for f in
                           [pool.submit(t) for t in tokens]])
    finally:
        pool.stop()
    direct = GPT2LMModel(cfg, device="cpu")
    direct.load_state_dict(sd)
    with torch.inference_mode():
        want = direct(tokens)[:, -1, :]
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert template.transformer.wte.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32
               for p in template.transformer.ln_f.parameters())
