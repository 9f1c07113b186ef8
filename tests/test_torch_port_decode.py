"""The port's token-level decode tier (``horovod_tpu_torch.serve``:
``KVBlockPool``, ``BlockTable``, ``gather_kv``, ``CacheLM``,
``DecodeEngine``, ``pack_prompts``), twins of ``tests/test_decode.py``'s
``TestBlockPool``, ``TestPagedAdmission``, ``TestPrefillRouting``,
``TestDecodeEngine``, ``TestSpeculative`` and ``TestDecodeEnvKnobs`` on the
CPU (``device="cpu"``), and held against the JAX package directly:

* ``CacheLM.extend`` for a prefill, a decode and a verify window on the
  same parameters (``convert.cachelm_params_from_jax``) and pool state:
  logits, ``k_new`` and ``v_new`` within 1e-5 of each output's largest
  value (fp32; matmuls summed in another order);
* an int8 pool's ``write`` then ``gather_kv``: payloads, scales and the
  dequantized cache bit for bit against the JAX package's ``_scatter_q``
  and ``gather_kv`` run eagerly (the same IEEE operations in the same
  order), and within one ulp of a scale (one step of a payload) of the
  compiled ``_scatter_q``, whose division by ``qmax`` XLA turns into a
  multiply by its reciprocal;
* the greedy finals of the JAX ``DecodeEngine`` and the port's on the
  reference tests' config and prompts, with and without speculation:
  token-identical.

``TestDecodeChaos`` and ``TestDecodeSoak`` wait for the fault plane (A13).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.serve import CacheLM as JCacheLM
from horovod_tpu.serve import CacheLMConfig as JConfig
from horovod_tpu.serve import DecodeEngine as JEngine
from horovod_tpu.serve import KVBlockPool as JPool
from horovod_tpu.serve import perturbed_params as jperturbed
from horovod_tpu.serve.kvcache import gather_kv as jgather_kv
from horovod_tpu_torch import convert
from horovod_tpu_torch.ops import quantization as tq
from horovod_tpu_torch.ops.batching import pack_prompts
from horovod_tpu_torch.serve import (
    CacheLM,
    CacheLMConfig,
    DecodeEngine,
    KVBlockPool,
    OutOfBlocks,
    perturbed_params,
)
from horovod_tpu_torch.serve.dispatcher import ServeRequestDropped
from horovod_tpu_torch.serve.kvcache import gather_kv

CFG = CacheLMConfig(vocab=32, n_layers=2, n_heads=2, head_dim=8,
                    max_positions=256)
MODEL = CacheLM(CFG, block_size=8)
PARAMS = MODEL.init_params(0, device="cpu")


def _pool(n_blocks=8, block_size=4, **kw):
    kw.setdefault("n_layers", 2)
    kw.setdefault("n_heads", 2)
    kw.setdefault("head_dim", 4)
    return KVBlockPool(n_blocks, block_size, device="cpu", **kw)


def _engine(**kw):
    kw.setdefault("workers", 1)
    kw.setdefault("rows", 2)
    kw.setdefault("kv_blocks", 32)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("max_seq_len", 64)
    return DecodeEngine(MODEL, PARAMS, device="cpu", **kw)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---- paged pool ---------------------------------------------------------


class TestBlockPool:
    def test_alloc_free_reuse_round_trip(self):
        pool = _pool(n_blocks=4)
        t1, t2 = pool.new_table(), pool.new_table()
        t1.ensure(10)  # 3 blocks of 4
        t2.ensure(4)   # 1 block
        assert len(t1.blocks) == 3 and len(t2.blocks) == 1
        assert pool.n_free == 0
        with pytest.raises(OutOfBlocks):
            pool.new_table().ensure(1)
        t1.release()
        assert pool.n_free == 3
        t3 = pool.new_table()
        t3.ensure(12)
        # Freed blocks are reused (lowest id first).
        assert sorted(t3.blocks) == sorted(
            b for b in range(4) if b not in t2.blocks)

    def test_ensure_is_all_or_nothing(self):
        pool = _pool(n_blocks=2)
        t = pool.new_table()
        with pytest.raises(OutOfBlocks):
            t.ensure(100)
        assert pool.n_free == 2 and t.blocks == []

    def test_truncate_frees_tail_blocks(self):
        pool = _pool(n_blocks=8, block_size=4)
        t = pool.new_table()
        t.ensure(16)
        t.length = 16
        assert len(t.blocks) == 4
        t.truncate(5)  # needs 2 blocks
        assert len(t.blocks) == 2 and t.length == 5
        assert pool.n_free == 6

    def test_flat_slots_and_padding(self):
        pool = _pool(n_blocks=8, block_size=4)
        t = pool.new_table()
        t.ensure(6)
        slots = t.flat_slots(0, 8)
        b0, b1 = t.blocks
        assert list(slots[:4]) == [b0 * 4 + i for i in range(4)]
        assert list(slots[4:8]) == [b1 * 4 + i for i in range(4)]
        assert t.flat_slots(8, 2).tolist() == [pool.scratch_slot] * 2
        assert t.padded_blocks(5).tolist() == [b0, b1, 8, 8, 8]

    def test_write_gather_round_trip(self):
        pool = _pool(n_blocks=4, block_size=4, n_layers=1, n_heads=2,
                     head_dim=4)
        t = pool.new_table()
        t.ensure(6)
        rng = np.random.RandomState(0)
        k = rng.randn(6, 1, 2, 4).astype(np.float32)
        v = rng.randn(6, 1, 2, 4).astype(np.float32)
        pool.write(t.flat_slots(0, 6), _t(k), _t(v))
        kc, vc = gather_kv(*pool.device_args(), _t(t.padded_blocks(2)[None]), 4)
        np.testing.assert_array_equal(kc.numpy()[0, 0, :6], k[:, 0])
        np.testing.assert_array_equal(vc.numpy()[0, 0, :6], v[:, 0])

    def test_int8_kv_parity_within_codec_tolerance(self):
        fp = _pool(n_blocks=4, block_size=4, n_layers=2, n_heads=2,
                   head_dim=8)
        q8 = _pool(n_blocks=4, block_size=4, n_layers=2, n_heads=2,
                   head_dim=8, kv_dtype="int8")
        rng = np.random.RandomState(1)
        k = (rng.randn(8, 2, 2, 8) * 3).astype(np.float32)
        v = (rng.randn(8, 2, 2, 8) * 0.1).astype(np.float32)
        got = {}
        tq.reset_launches()
        for name, pool in (("fp", fp), ("q8", q8)):
            t = pool.new_table()
            t.ensure(8)
            pool.write(t.flat_slots(0, 8), _t(k), _t(v))
            got[name] = gather_kv(*pool.device_args(),
                                  _t(t.padded_blocks(2)[None]), 4)
        # Max-abs per-head scaling: the error is at most max|x| / 254.
        for i in (0, 1):
            a, b = got["fp"][i].numpy(), got["q8"][i].numpy()
            tol = np.abs(a).max(axis=-1, keepdims=True) / 127.0
            assert np.all(np.abs(a - b) <= tol + 1e-7)
        assert q8.k.dtype == torch.int8
        # CPU tensors take the plain versions and launch nothing.
        assert tq.launches_quant == tq.launches_dequant == 0

    def test_defrag_compacts_and_preserves_data(self):
        pool = _pool(n_blocks=8, block_size=4, n_layers=1, n_heads=1,
                     head_dim=4)
        a, b = pool.new_table(), pool.new_table()
        a.ensure(8)   # blocks 0, 1
        b.ensure(8)   # blocks 2, 3
        data = np.random.RandomState(2).randn(8, 1, 1, 4).astype(np.float32)
        pool.write(b.flat_slots(0, 8), _t(data), _t(data))
        b.length = 8
        a.release()  # b's blocks are no longer the lowest
        assert b.blocks == [2, 3]
        moved = pool.defrag()
        assert moved == 2 and b.blocks == [0, 1]
        assert sorted(pool._free_list) == list(range(2, 8))
        kc, _ = gather_kv(*pool.device_args(), _t(b.padded_blocks(2)[None]),
                          4)
        np.testing.assert_array_equal(kc.numpy()[0, 0, :8], data[:, 0])
        assert pool.stats()["defrags"] == 1

    def test_stats_occupancy_fragmentation(self):
        pool = _pool(n_blocks=8, block_size=4)
        t = pool.new_table()
        t.ensure(6)
        t.length = 5
        s = pool.stats()
        assert s["used_blocks"] == 2
        assert s["occupancy"] == pytest.approx(2 / 8)
        assert s["fragmentation"] == pytest.approx(1 - 5 / 8)

    def test_kv_dtype_validation(self):
        with pytest.raises(ValueError):
            _pool(kv_dtype="fp4")
        assert _pool(kv_dtype="off").kv_dtype == ""

    def test_bytes_per_token(self):
        # fp32: 4 bytes an element; int8: 1 + 4/head_dim.
        assert _pool(head_dim=8).bytes_per_token() == 2 * 2 * 8 * 2 * 4
        assert _pool(head_dim=8, kv_dtype="int8").bytes_per_token() == (
            2 * 2 * 8 * 2 * 1.5)

    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            KVBlockPool(2, 4, n_layers=1, n_heads=1, head_dim=4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MODEL.init_params(0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeEngine(MODEL, PARAMS)


# ---- paged-vs-naive admission ---------------------------------------------


class TestPagedAdmission:
    def test_paged_pool_admits_mix_naive_preallocation_cannot(self):
        # 16 blocks x 8 slots = 128 token slots; max_seq_len = 64: naive
        # max-length preallocation fits 2 sequences, the pool co-hosts 4.
        n_blocks, bs, max_len = 16, 8, 64
        naive_capacity = (n_blocks * bs) // max_len
        assert naive_capacity == 2
        eng = _engine(rows=4, kv_blocks=n_blocks, kv_block_size=bs,
                      max_seq_len=max_len).start()
        try:
            futs = [eng.submit([1 + i, 2, 3], 20) for i in range(4)]
            peak = 0
            deadline = time.time() + 30
            while time.time() < deadline:
                peak = max(peak, eng.in_flight)
                if all(f.done() for f in futs):
                    break
                time.sleep(0.001)
            outs = [f.result(timeout=10) for f in futs]
            assert all(len(o) == 20 for o in outs)
            assert peak == 4 > naive_capacity
            assert eng.n_preempted == 0
        finally:
            eng.stop()

    def test_out_of_blocks_backpressure_queues_not_crashes(self):
        # The pool fits about 2 active sequences; 6 submitted all finish.
        eng = _engine(rows=4, kv_blocks=6, kv_block_size=8,
                      max_seq_len=40).start()
        try:
            futs = [eng.submit([1 + i, 2], 20) for i in range(6)]
            outs = [f.result(timeout=60) for f in futs]
            assert all(len(o) == 20 for o in outs)
            assert eng.n_finished == 6
        finally:
            eng.stop()

    def test_oversized_request_rejected_at_submit(self):
        eng = _engine(kv_blocks=4, kv_block_size=4, max_seq_len=64)
        with pytest.raises(ValueError):
            eng.submit(list(range(10)), 30)  # needs more than 4 blocks
        with pytest.raises(ValueError):
            eng.submit([1], 64)  # prompt + max_new > max_seq_len
        with pytest.raises(ValueError):
            eng.submit([], 4)


# ---- prefill routing --------------------------------------------------------


class TestPrefillRouting:
    def test_pack_prompts_routing_round_trip(self):
        prompts = [[5, 9], [3, 1, 4], [7, 7, 7, 2]]
        batch, spec = pack_prompts(prompts, 4, bucket=8)
        assert tuple(batch["tokens"].shape) == (4, 8)
        assert tuple(batch["length"].shape) == (4,)
        assert batch["tokens"].dtype == batch["length"].dtype == torch.int32
        assert spec.n_valid == 3
        toks, lens = batch["tokens"].numpy(), batch["length"].numpy()
        seen = set()
        for row, req in enumerate(spec.row_to_request):
            want = prompts[req]
            assert lens[row] == len(want)
            assert toks[row, :len(want)].tolist() == want
            assert np.all(toks[row, len(want):] == 0)
            seen.add(req)
        assert seen == {0, 1, 2}
        for row in set(range(4)) - set(spec.row_to_request):
            assert lens[row] == 0
        with pytest.raises(ValueError):
            pack_prompts([[1] * 9], 4, bucket=8)

    def test_pack_prompts_matches_the_jax_package(self):
        from horovod_tpu.ops.batching import pack_prompts as jpack

        prompts = [[5, 9], [3, 1, 4], [7, 7, 7, 2]]
        batch, spec = pack_prompts(prompts, 4, bucket=8)
        jbatch, jspec = jpack(prompts, 4, bucket=8)
        assert spec.row_to_request == jspec.row_to_request
        for k in ("tokens", "length"):
            np.testing.assert_array_equal(batch[k].numpy(),
                                          np.asarray(jbatch[k]))

    def test_row_routing_via_packspec(self):
        # pack_requests puts the last request in row 0: the engine routes
        # prefill rows back through the BatchSpec, so distinct prompts get
        # their own streams. Each prompt alone is the ground truth.
        prompts = [[5, 9], [3, 1, 4], [7, 7, 7, 2]]
        solo = []
        for ptoks in prompts:
            eng = _engine(rows=1).start()
            solo.append(eng.submit(ptoks, 12).result(timeout=30))
            eng.stop()
        eng = _engine(rows=4).start()
        try:
            outs = [f.result(timeout=30)
                    for f in [eng.submit(p, 12) for p in prompts]]
        finally:
            eng.stop()
        assert outs == solo

    def test_incremental_decode_matches_full_recompute(self):
        # The paged cache is an optimization, not a semantic: the engine's
        # greedy tokens equal a from-scratch forward at every step.
        prompt = [5, 9, 2]
        eng = _engine(rows=1).start()
        try:
            got = eng.submit(prompt, 8).result(timeout=30)
        finally:
            eng.stop()
        pool = KVBlockPool(8, 8, n_layers=CFG.n_layers, n_heads=CFG.n_heads,
                           head_dim=CFG.head_dim, device="cpu")
        toks, want, s_len = list(prompt), [], 32
        zeros = torch.zeros((1,), dtype=torch.int32)
        scratch = torch.full((1, 4), pool.n_blocks, dtype=torch.int64)
        for _ in range(8):
            padded = torch.zeros((1, s_len), dtype=torch.int32)
            padded[0, :len(toks)] = torch.tensor(toks)
            logits, _, _ = MODEL.extend(PARAMS, padded, zeros, scratch, zeros,
                                        *pool.device_args())
            nxt = int(logits[0, len(toks) - 1].argmax())
            want.append(nxt)
            toks.append(nxt)
        assert got == want


# ---- engine behaviour -----------------------------------------------------


class TestDecodeEngine:
    def test_streaming_future_grows_in_order(self):
        eng = _engine().start()
        try:
            fut = eng.submit([5, 9], 16)
            seen = []
            deadline = time.time() + 30
            while not fut.done() and time.time() < deadline:
                cur = fut.tokens_so_far()
                assert cur[:len(seen)] == seen  # prefix-stable
                seen = cur
                time.sleep(0.001)
            final = fut.result(timeout=5)
            assert len(final) == 16 and final[:len(seen)] == seen
            assert fut.first_token_t is not None
            assert fut.first_token_t >= fut.submit_t
            assert len(fut.token_times()) == 16
        finally:
            eng.stop()

    def test_eos_stops_early(self):
        eng = _engine().start()
        try:
            full = eng.submit([5, 9], 10).result(timeout=30)
            eos = full[2]
            out = eng.submit([5, 9], 10, eos_token=eos).result(timeout=30)
            assert out == full[:3] and out[-1] == eos
        finally:
            eng.stop()

    def test_kill_worker_resumes_streams_token_identical(self):
        def run(kill):
            eng = _engine(workers=2).start()
            try:
                futs = [eng.submit([1 + i, 2, (3 * i) % 7], 24)
                        for i in range(6)]
                if kill:
                    deadline = time.time() + 20
                    while time.time() < deadline and not any(
                            len(f.tokens_so_far()) >= 3 for f in futs):
                        time.sleep(0.002)
                    assert eng.kill_worker(eng.worker_names()[0])
                return [f.result(timeout=60) for f in futs], eng.n_requeued
            finally:
                eng.stop()

        base, _ = run(False)
        faulted, requeued = run(True)
        assert requeued > 0  # the kill landed mid-stream
        assert faulted == base

    def test_stop_rejects_pending(self):
        eng = _engine().start()
        eng.submit([5], 4).result(timeout=30)
        eng.stop()
        with pytest.raises(ServeRequestDropped):
            eng.submit([5], 4)

    def test_hot_swap_applies_between_rounds(self):
        eng = _engine().start()
        try:
            before = eng.submit([5, 9], 8).result(timeout=30)
            eng.hot_swap(MODEL.init_params(7, device="cpu"))
            after = eng.submit([5, 9], 8).result(timeout=30)
            assert eng.n_hotswaps == 1
            assert before != after  # the new weights serve
            # The streamed mode (ported with the weight stream): a
            # versioned swap joins the engine's version log, and an
            # attached subscriber is stopped with the engine.
            eng.hot_swap(PARAMS, version=3)
            assert eng.stream_version == 3
            assert eng.stream_version_log == [3]
            stopped = []

            class Sub:
                def stop(self):
                    stopped.append(True)

            assert eng.attach_stream(Sub()) is eng
            eng.submit([5, 9], 8).result(timeout=30)
            assert 3 in sum((w.version_log for w in
                             eng._workers.values()), [])
        finally:
            eng.stop()
        assert stopped == [True]

    def test_scale_to_spawns_and_drains(self):
        eng = _engine(workers=1).start()
        try:
            eng.scale_to(3)
            assert eng.n_workers == 3
            eng.scale_to(1)
            assert eng.n_workers == 1
            assert len(eng.submit([5], 6).result(timeout=30)) == 6
        finally:
            eng.stop()

    def test_int8_kv_engine_end_to_end(self):
        # int8 KV is lossy: greedy tokens may leave fp32's near argmax ties.
        # The engine's contract is completion and determinism.
        def run(kv):
            eng = _engine(kv_dtype=kv).start()
            try:
                return eng.submit([5, 9, 2], 24).result(timeout=30)
            finally:
                eng.stop()

        q8a, q8b = run("int8"), run("int8")
        assert len(q8a) == 24 and q8a == q8b

    def test_counters_mirror_activity(self):
        eng = _engine().start()
        try:
            for i in range(3):
                eng.submit([1 + i], 5).result(timeout=30)
            assert eng.n_submitted == 3
            assert eng.n_finished == 3
            assert eng.n_tokens == 15
            assert eng.n_rounds > 0
            assert 0 < eng.fill_sum <= eng.n_rounds
        finally:
            eng.stop()


# ---- speculative decoding ---------------------------------------------------


def _plain(prompts, n=16):
    eng = _engine(rows=2).start()
    try:
        return [f.result(timeout=30)
                for f in [eng.submit(p, n) for p in prompts]]
    finally:
        eng.stop()


class TestSpeculative:
    def test_perfect_draft_accepts_everything(self):
        prompts = [[5, 9], [3, 1, 4]]
        plain = _plain(prompts)
        eng = _engine(rows=2, spec_k=3, draft_params=PARAMS).start()
        try:
            outs = [f.result(timeout=30)
                    for f in [eng.submit(p, 16) for p in prompts]]
            assert outs == plain
            assert eng.n_proposed > 0
            assert eng.n_accepted == eng.n_proposed
            assert eng.n_rounds < eng.n_tokens
        finally:
            eng.stop()

    @pytest.mark.parametrize("noise", [0.05, 1.0])
    def test_noisy_draft_is_output_invariant(self, noise):
        prompts = [[5, 9], [3, 1, 4], [7, 2], [11, 4, 1]]
        plain = _plain(prompts)
        eng = _engine(rows=2, spec_k=3,
                      draft_params=perturbed_params(PARAMS, noise)).start()
        try:
            outs = [f.result(timeout=30)
                    for f in [eng.submit(p, 16) for p in prompts]]
            assert outs == plain, f"noise={noise}"
            assert eng.n_accepted < eng.n_proposed
        finally:
            eng.stop()

    def test_spec_admission_budgets_pools_separately(self):
        # A stream needing more than half of one pool is still admissible.
        eng = _engine(rows=2, kv_blocks=12, max_seq_len=80, spec_k=3,
                      draft_params=PARAMS).start()
        try:
            prompt = list(np.random.RandomState(0).randint(1, 32, 50))
            assert len(eng.submit(prompt, 8).result(timeout=30)) == 8
        finally:
            eng.stop()

    def test_spec_requires_draft_params(self):
        with pytest.raises(ValueError):
            _engine(spec_k=2)

    def test_spec_kill_resume_token_identical(self):
        prompts = [[1 + i, 2] for i in range(4)]
        plain = _plain(prompts, n=20)
        eng = _engine(workers=2, spec_k=3,
                      draft_params=perturbed_params(PARAMS, 0.05)).start()
        try:
            futs = [eng.submit(p, 20) for p in prompts]
            deadline = time.time() + 20
            while time.time() < deadline and not any(
                    len(f.tokens_so_far()) >= 3 for f in futs):
                time.sleep(0.002)
            eng.kill_worker(eng.worker_names()[0])
            assert [f.result(timeout=60) for f in futs] == plain
            assert eng.n_requeued > 0
        finally:
            eng.stop()


# ---- env knobs ----------------------------------------------------------------


class TestDecodeEnvKnobs:
    def test_accessor_validation(self, monkeypatch):
        from horovod_tpu_torch.utils import env

        monkeypatch.setenv("HVDTPU_SERVE_KV_BLOCKS", "0")
        with pytest.raises(ValueError):
            env.serve_kv_blocks()
        monkeypatch.setenv("HVDTPU_SERVE_KV_DTYPE", "fp4")
        with pytest.raises(ValueError):
            env.serve_kv_dtype()
        monkeypatch.setenv("HVDTPU_SERVE_KV_DTYPE", "int8")
        assert env.serve_kv_dtype() == "int8"
        monkeypatch.setenv("HVDTPU_SERVE_MAX_SEQ_LEN", "1")
        with pytest.raises(ValueError):
            env.serve_max_seq_len()
        monkeypatch.setenv("HVDTPU_SERVE_SPEC_K", "-1")
        with pytest.raises(ValueError):
            env.serve_spec_k()

    def test_engine_reads_env_defaults(self, monkeypatch):
        from horovod_tpu_torch.utils import env

        monkeypatch.setenv("HVDTPU_SERVE_DECODE_ROWS", "3")
        monkeypatch.setenv("HVDTPU_SERVE_KV_BLOCKS", "17")
        monkeypatch.setenv("HVDTPU_SERVE_KV_BLOCK_SIZE", "4")
        monkeypatch.setenv("HVDTPU_SERVE_MAX_SEQ_LEN", "48")
        eng = DecodeEngine(MODEL, PARAMS, device="cpu")
        assert eng.rows_n == 3
        assert eng.kv_blocks == 17
        assert eng.kv_block_size == 4
        assert eng.max_seq_len == 48
        assert env.serve_decode_rows() == 3

    def test_defaults_match_the_jax_package(self, monkeypatch):
        from horovod_tpu.utils import env as jenv
        from horovod_tpu_torch.utils import env

        for name in ("serve_kv_blocks", "serve_kv_block_size",
                     "serve_kv_dtype", "serve_decode_rows",
                     "serve_max_seq_len", "serve_spec_k"):
            assert getattr(env, name)() == getattr(jenv, name)(), name


# ---- against the JAX package ---------------------------------------------------


JMODEL = JCacheLM(JConfig(vocab=32, n_layers=2, n_heads=2, head_dim=8,
                          max_positions=256), block_size=8)


def test_init_and_perturbed_params_are_the_jax_packages():
    jp = JMODEL.init_params(0)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), PARAMS))):
        np.testing.assert_array_equal(np.asarray(a), b)
    jd = jperturbed(jp, 0.05)
    td = perturbed_params(PARAMS, 0.05)
    for a, b in zip(jax.tree.leaves(jd), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), td))):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("window", ["prefill", "decode", "verify"])
def test_extend_matches_the_jax_package(window):
    jp = JMODEL.init_params(3)
    tp = convert.cachelm_params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    rng = np.random.RandomState(4)
    r, m, bs = 3, 6, 8
    jpool = JPool(16, bs, n_layers=2, n_heads=2, head_dim=8)
    tpool = KVBlockPool(16, bs, n_layers=2, n_heads=2, head_dim=8,
                        device="cpu")
    # The same cache contents in both pools: 3 rows of 20, 9 and 0 tokens.
    lens = np.array([20, 9, 0], np.int32)
    rows = np.full((r, m), 16, np.int32)
    for i, n in enumerate(lens):
        jt, tt = jpool.new_table(), tpool.new_table()
        jt.ensure(int(n))
        tt.ensure(int(n))
        rows[i, :len(jt.blocks)] = jt.blocks
        kv = [(rng.randn(int(n), 2, 2, 8)).astype(np.float32)
              for _ in range(2)]
        if n:
            jpool.write(jt.flat_slots(0, int(n)), *map(jnp.asarray, kv))
            tpool.write(tt.flat_slots(0, int(n)), *map(_t, kv))
    w = {"prefill": 16, "decode": 1, "verify": 4}[window]
    toks = rng.randint(0, 32, (r, w)).astype(np.int32)
    if window == "prefill":
        pos0 = seq = np.zeros((r,), np.int32)
        rows = np.full((r, m), 16, np.int32)
    else:
        pos0 = seq = lens
    want = JMODEL.extend(jp, jnp.asarray(toks), jnp.asarray(pos0),
                         jnp.asarray(rows), jnp.asarray(seq),
                         *jpool.device_args())
    got = MODEL.extend(tp, _t(toks), _t(pos0), _t(rows), _t(seq),
                       *tpool.device_args())
    for name, a, b in zip(("logits", "k_new", "v_new"), want, got):
        a = np.asarray(a)
        assert b.shape == a.shape, name
        err = np.abs(b.numpy() - a).max()
        assert err <= 1e-5 * np.abs(a).max(), (name, err)


def _int8_pools(jit):
    rng = np.random.RandomState(5)
    jpool = JPool(6, 4, n_layers=2, n_heads=3, head_dim=16, kv_dtype="int8")
    tpool = KVBlockPool(6, 4, n_layers=2, n_heads=3, head_dim=16,
                        kv_dtype="int8", device="cpu")
    jt, tt = jpool.new_table(), tpool.new_table()
    jt.ensure(13)
    tt.ensure(13)
    k = (rng.randn(13, 2, 3, 16) * 3).astype(np.float32)
    v = (rng.randn(13, 2, 3, 16) * 0.01).astype(np.float32)
    k[4, 1, 2] = 0.0  # an all-zero head: scale 1
    if jit:
        jpool.write(jt.flat_slots(0, 13), jnp.asarray(k), jnp.asarray(v))
    else:
        with jax.disable_jit():
            jpool.write(jt.flat_slots(0, 13), jnp.asarray(k), jnp.asarray(v))
    tpool.write(tt.flat_slots(0, 13), _t(k), _t(v))
    assert tpool.k_scales[:, int(tt.flat_slots(4, 1)[0])].numpy()[1, 2] == 1
    return jpool, tpool, np.array([jt.padded_blocks(5)], np.int32)


def test_int8_write_and_gather_are_the_jax_packages_bit_for_bit():
    # _scatter_q and gather_kv run eagerly: the same IEEE operations in the
    # same order as the port's plain versions (and its kernels).
    jpool, tpool, rows = _int8_pools(jit=False)
    for name in ("k", "v", "k_scales", "v_scales"):
        np.testing.assert_array_equal(getattr(tpool, name).numpy(),
                                      np.asarray(getattr(jpool, name)), name)
    with jax.disable_jit():
        want = jgather_kv(*jpool.device_args(), jnp.asarray(rows), 4)
    got = gather_kv(*tpool.device_args(), _t(rows), 4)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_int8_write_is_within_an_ulp_of_the_compiled_jax_write():
    # Compiled, XLA turns _scatter_q's division by qmax into a multiply by
    # its reciprocal (ROADMAP C, "Differences of the reference on the
    # CPU"): a scale one ulp off, and a payload one step off where that
    # moves a rounding.
    jpool, tpool, _ = _int8_pools(jit=True)
    for name in ("k_scales", "v_scales"):
        a, b = np.asarray(getattr(jpool, name)), getattr(tpool, name).numpy()
        assert np.all(np.abs(a.view(np.int32) - b.view(np.int32)) <= 1), name
    for name in ("k", "v"):
        a, b = np.asarray(getattr(jpool, name)), getattr(tpool, name).numpy()
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def _finals(make, prompts, **kw):
    eng = make(**kw).start()
    try:
        return [f.result(timeout=60)
                for f in [eng.submit(p, 16) for p in prompts]]
    finally:
        eng.stop()


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_greedy_finals_match_the_jax_engine(spec):
    prompts = [[5, 9], [3, 1, 4], [7, 2], [11, 4, 1]]
    jp = JMODEL.init_params(0)
    kw = dict(workers=1, rows=2, kv_blocks=32, kv_block_size=8,
              max_seq_len=64)
    jkw, tkw = dict(kw), dict(kw)
    if spec:
        jkw.update(spec_k=3, draft_params=jperturbed(jp, 0.05))
        tkw.update(spec_k=3, draft_params=perturbed_params(PARAMS, 0.05))
    want = _finals(lambda **a: JEngine(JMODEL, jp, **a), prompts, **jkw)
    got = _finals(lambda **a: DecodeEngine(MODEL, PARAMS, device="cpu", **a),
                  prompts, **tkw)
    assert got == want
