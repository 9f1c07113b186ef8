"""The port's input path (horovod_tpu_torch.data) held against the JAX
package's ``data.py`` on the CPU: the twins of ``tests/test_data.py``.

The sampler and the batcher are numpy logic: each case runs the same
arguments through both packages and requires the same index streams
exactly, besides the reference test's own assertions. ``prefetch_to_device``
runs with ``device="cpu"`` here (the pinned-memory copy stream needs the
card; ``tests/test_torch_port_cuda.py`` holds it there).
"""

import numpy as np
import pytest
import torch

from horovod_tpu import data as jdata
from horovod_tpu_torch import context
from horovod_tpu_torch.data import (ShardedBatches, ShardedIndexSampler,
                                    prefetch_to_device)


def _pair(*args, **kw):
    return ShardedIndexSampler(*args, **kw), jdata.ShardedIndexSampler(
        *args, **kw)


class TestShardedIndexSampler:
    def test_shards_cover_everything_once(self):
        samplers = [ShardedIndexSampler(12, shuffle=False, rank=r,
                                        world_size=4) for r in range(4)]
        seen = [i for s in samplers for i in s]
        assert sorted(seen) == list(range(12))
        assert all(len(s) == 3 for s in samplers)
        for r, s in enumerate(samplers):
            assert list(s) == list(jdata.ShardedIndexSampler(
                12, shuffle=False, rank=r, world_size=4))

    def test_shuffle_deterministic_per_epoch(self):
        a, ja = _pair(32, seed=1, rank=0, world_size=1)
        b = ShardedIndexSampler(32, seed=1, rank=0, world_size=1)
        assert list(a) == list(b) == list(ja)
        first = list(a)
        a.set_epoch(1)
        ja.set_epoch(1)
        assert list(a) != first and list(a) == list(ja)
        assert sorted(a) == sorted(first)

    def test_mid_epoch_resume_excludes_processed(self):
        s, js = _pair(10, shuffle=False, rank=0, world_size=1)
        first4 = list(s)[:4]
        for x in (s, js):
            x.record(first4)
            x.reset()
        assert sorted(s) == sorted(set(range(10)) - set(first4))
        assert list(s) == list(js)

    def test_short_tail_pads_by_cycling(self):
        shards = [_pair(4, shuffle=False, rank=r, world_size=4)
                  for r in range(4)]
        for pair in shards:
            for sh in pair:
                sh.record([0, 1, 2])
                sh.reset()
        assert all(len(list(sh)) == 1 for sh, _ in shards)
        assert all(i == 3 for sh, _ in shards for i in sh)
        assert all(list(a) == list(b) for a, b in shards)

    def test_world_resize_resharding(self):
        # 2 ranks process half an epoch; restart as 3 ranks: the union of
        # the new shards is exactly the unprocessed remainder.
        processed = list(range(0, 6))
        new = [_pair(12, shuffle=False, rank=r, world_size=3)
               for r in range(3)]
        for pair in new:
            for s in pair:
                s.record(processed)
                s.reset()
        assert sorted(i for s, _ in new for i in s) == list(range(6, 12))
        assert all(list(a) == list(b) for a, b in new)

    def test_state_dict_roundtrip(self):
        s = ShardedIndexSampler(20, seed=3, rank=0, world_size=2)
        s.set_epoch(2)
        s.record([1, 5, 7])
        t = ShardedIndexSampler(20, seed=0, rank=0, world_size=2)
        t.load_state_dict(s.state_dict())
        s.reset()
        assert (t.epoch, t.seed, t.processed) == (2, 3, {1, 5, 7})
        assert list(t) == list(s)
        # The state dicts are interchangeable with the JAX package's.
        j = jdata.ShardedIndexSampler(20, seed=0, rank=0, world_size=2)
        j.load_state_dict(s.state_dict())
        assert s.state_dict() == j.state_dict() and list(j) == list(s)


class TestWorldIntegration:
    def test_sampler_reads_live_world(self, monkeypatch):
        # With an initialized world of 8, the sampler shards by the
        # context's rank and size.
        monkeypatch.setenv("WORLD_SIZE", "8")
        monkeypatch.setenv("RANK", "3")
        monkeypatch.setenv("LOCAL_RANK", "0")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
        context.init(device="cpu")
        try:
            s = ShardedIndexSampler(16, shuffle=False)
            assert (s.rank, s.world_size) == (3, 8)
            assert len(s) == 2 and list(s) == [3, 11]
        finally:
            context.shutdown()
        assert ShardedIndexSampler(16, shuffle=False).world_size == 1


class TestShardedBatches:
    def test_batches_and_record_loop(self):
        x = np.arange(40).reshape(20, 2)
        y = np.arange(20)
        batches = ShardedBatches(
            [x, y], batch_size=4,
            sampler=ShardedIndexSampler(20, shuffle=False, rank=0,
                                        world_size=1))
        assert len(batches) == 5
        seen = []
        for bx, by, idx in batches:
            assert bx.shape == (4, 2)
            np.testing.assert_array_equal(bx[:, 0] // 2, by)
            seen.extend(idx.tolist())
        assert sorted(seen) == list(range(20))

    def test_length_mismatch_rejected(self):
        with pytest.raises(ValueError, match="length"):
            ShardedBatches([np.zeros(3), np.zeros(4)], batch_size=2)

    def test_ragged_tail_dropped(self):
        batches = ShardedBatches(
            [np.zeros((10, 1))], batch_size=4,
            sampler=ShardedIndexSampler(10, shuffle=False, rank=0,
                                        world_size=1))
        assert sum(1 for _ in batches) == 2

    @pytest.mark.parametrize("drop", [True, False])
    def test_same_batches_as_the_jax_package(self, drop):
        x = np.arange(26).reshape(13, 2)
        for r in range(3):
            kw = dict(shuffle=True, seed=5, rank=r, world_size=3)
            got = list(ShardedBatches([x], 3, ShardedIndexSampler(13, **kw),
                                      drop_remainder=drop))
            want = list(jdata.ShardedBatches(
                [x], 3, jdata.ShardedIndexSampler(13, **kw),
                drop_remainder=drop))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_array_equal(g[1], w[1])

    def test_drop_remainder_false_pads_by_cycling(self):
        x = np.arange(10).reshape(10, 1)
        batches = ShardedBatches(
            [x], batch_size=4, drop_remainder=False,
            sampler=ShardedIndexSampler(10, shuffle=False, rank=0,
                                        world_size=1))
        assert len(batches) == 3
        got = list(batches)
        assert len(got) == 3
        assert all(b[0].shape == (4, 1) for b in got)
        consumed = [i for b in got for i in b[-1].tolist()]
        assert sorted(set(consumed)) == list(range(10))
        assert consumed[8:] == [8, 9, 0, 1]


class TestEpochBoundaryWithPrefetch:
    """num_items % world != 0 composed with a prefetch wrapper pulling
    ``depth`` ahead leaves every rank with the same batch count, and with
    drop_remainder=False every real sample is consumed each epoch."""

    def _rank_batches(self, rank, world, num_items, batch_size, **kw):
        x = np.arange(num_items).reshape(num_items, 1)
        return ShardedBatches(
            [x], batch_size=batch_size,
            sampler=ShardedIndexSampler(num_items, shuffle=False, rank=rank,
                                        world_size=world), **kw)

    @pytest.mark.parametrize("num_items,world,batch_size", [
        (10, 4, 2), (13, 4, 2), (7, 4, 3),
    ])
    def test_equal_counts_through_prefetch(self, num_items, world,
                                           batch_size):
        counts = []
        for r in range(world):
            batches = self._rank_batches(r, world, num_items, batch_size)
            out = list(prefetch_to_device(iter(batches), depth=2,
                                          device="cpu"))
            counts.append(len(out))
        assert len(set(counts)) == 1, counts

    def test_full_coverage_with_pad_choice(self):
        seen, counts = set(), []
        for r in range(4):
            batches = self._rank_batches(r, 4, 10, 2, drop_remainder=False)
            out = list(prefetch_to_device(iter(batches), depth=3,
                                          device="cpu"))
            counts.append(len(out))
            for b in out:
                assert isinstance(b[-1], torch.Tensor)
                seen.update(int(i) for i in np.asarray(b[-1]))
        assert len(set(counts)) == 1, counts
        assert seen == set(range(10))

    def test_order_values_and_depth_validation(self, monkeypatch):
        batches = list(self._rank_batches(0, 1, 9, 3))
        out = list(prefetch_to_device(iter(batches), device="cpu"))
        assert len(out) == len(batches)
        for (x, i), (tx, ti) in zip(batches, out):
            np.testing.assert_array_equal(tx.numpy(), x)
            np.testing.assert_array_equal(ti.numpy(), i)
        with pytest.raises(ValueError, match="depth"):
            prefetch_to_device(iter(batches), depth=0, device="cpu")
        monkeypatch.setenv("HVDTPU_PREFETCH_DEPTH", "0")
        from horovod_tpu.utils import env as jenv
        from horovod_tpu_torch.utils import env as tenv

        assert tenv.prefetch_depth() == jenv.prefetch_depth() == 1

    def test_the_default_device_is_the_card(self):
        if torch.cuda.is_available():
            assert list(prefetch_to_device(iter([]))) == []
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                prefetch_to_device(iter([]))
