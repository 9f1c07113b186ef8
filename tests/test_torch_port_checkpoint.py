"""The port's checkpoints (horovod_tpu_torch.checkpoint), mirroring
tests/test_checkpoint.py: round-trip, retention, the per-file manifest
(size and crc32), walk-back past corrupt steps, the ``.corrupt``
quarantine, a pinned corrupt ``step=`` raising, and the retried write.
The walk-back decisions are also held against the JAX package's on the
same damage."""

import json
import os

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as jckpt
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.exceptions import CheckpointCorruptError


def _state(step):
    return {
        "params": {"w": torch.full((4, 2), float(step)), "b": torch.zeros(2)},
        "step": np.int64(step),
    }


def _damage_a_leaf(step_dir, mode="corrupt"):
    victims = [
        os.path.join(root, n)
        for root, _, names in os.walk(step_dir) for n in names
        if n != ckpt.MANIFEST_NAME
    ]
    victim = max(victims, key=os.path.getsize)
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        if mode == "truncate":
            f.truncate(size // 2)
        else:
            f.seek(size // 2)
            span = f.read(32)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in span))


class TestSaveRestore:
    def test_roundtrip_latest(self, tmp_path):
        d = str(tmp_path)
        ckpt.save_checkpoint(d, _state(1), step=1)
        ckpt.save_checkpoint(d, _state(5), step=5)
        assert ckpt.latest_step(d) == 5
        restored = ckpt.restore_checkpoint(d, _state(0))
        torch.testing.assert_close(restored["params"]["w"], torch.full((4, 2), 5.0))
        assert isinstance(restored["step"], np.int64) and restored["step"] == 5

    def test_restore_specific_step(self, tmp_path):
        d = str(tmp_path)
        for s in (1, 2):
            ckpt.save_checkpoint(d, _state(s), step=s)
        restored = ckpt.restore_checkpoint(d, _state(0), step=1)
        assert float(restored["params"]["w"][0, 0]) == 1.0

    def test_retention(self, tmp_path):
        d = str(tmp_path)
        for s in range(6):
            ckpt.save_checkpoint(d, _state(s), step=s, keep=3)
        assert ckpt.all_steps(d) == [3, 4, 5]

    def test_rollback_save_survives_retention(self, tmp_path):
        d = str(tmp_path)
        for s in (5, 6, 7):
            ckpt.save_checkpoint(d, _state(s), step=s, keep=3)
        path = ckpt.save_checkpoint(d, _state(2), step=2, keep=3)
        assert os.path.isdir(path)
        restored = ckpt.restore_checkpoint(d, _state(0), step=2)
        assert float(restored["params"]["w"][0, 0]) == 2.0

    def test_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            ckpt.restore_checkpoint(str(tmp_path), _state(0))

    def test_restore_takes_target_dtypes(self, tmp_path):
        d = str(tmp_path)
        ckpt.save_checkpoint(d, {"w": torch.arange(6.0), "n": 3}, step=0)
        out = ckpt.restore_checkpoint(
            d, {"w": torch.zeros(6, dtype=torch.bfloat16), "n": 0}
        )
        assert out["w"].dtype == torch.bfloat16 and out["n"] == 3
        torch.testing.assert_close(out["w"].float(), torch.arange(6.0))

    def test_module_state_roundtrip_leaves_template_untouched(self, tmp_path):
        src = torch.nn.Linear(4, 3)
        d = str(tmp_path)
        ckpt.save_checkpoint(d, src, step=1)
        template = torch.nn.Linear(4, 3).to(torch.bfloat16)
        before = template.weight.clone()
        got = ckpt.restore_checkpoint(d, template)
        assert got is not template and got.weight.dtype == torch.bfloat16
        torch.testing.assert_close(got.weight.float(),
                                   src.weight.detach().to(torch.bfloat16).float())
        assert torch.equal(template.weight, before)

    def test_manifest_records_size_and_crc(self, tmp_path):
        path = ckpt.save_checkpoint(str(tmp_path), _state(3), step=3)
        with open(os.path.join(path, ckpt.MANIFEST_NAME)) as f:
            files = json.load(f)["files"]
        assert set(files) == {ckpt.STATE_NAME}
        p = os.path.join(path, ckpt.STATE_NAME)
        assert files[ckpt.STATE_NAME] == {
            "size": os.path.getsize(p), "crc32": ckpt._file_crc(p)
        }
        assert ckpt.verify_step_dir(path) == []

    def test_non_writer_rank_skips_the_write(self, tmp_path, monkeypatch):
        monkeypatch.setenv("RANK", "1")
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert ckpt.save_checkpoint(str(tmp_path), _state(1), step=1) is None
        assert ckpt.save_checkpoint(str(tmp_path), _state(1), step=1,
                                    force=True) is not None


class TestIntegrityFallback:
    @pytest.mark.parametrize("mode", ["corrupt", "truncate"])
    def test_damaged_latest_falls_back_and_quarantines(self, tmp_path, mode):
        d = str(tmp_path)
        for s in (1, 2, 3):
            ckpt.save_checkpoint(d, _state(s), step=s)
        _damage_a_leaf(os.path.join(d, "step_3"), mode)
        problems = ckpt.verify_step_dir(os.path.join(d, "step_3"))
        assert problems and ("crc32" in problems[0] or "size" in problems[0])
        restored = ckpt.restore_checkpoint(d, _state(0))
        assert restored["step"] == 2
        assert os.path.isdir(os.path.join(d, "step_3.corrupt"))
        assert ckpt.all_steps(d) == [1, 2]

    def test_multiple_corrupt_steps_walk_back(self, tmp_path):
        d = str(tmp_path)
        for s in (1, 2, 3):
            ckpt.save_checkpoint(d, _state(s), step=s)
        _damage_a_leaf(os.path.join(d, "step_2"), "corrupt")
        _damage_a_leaf(os.path.join(d, "step_3"), "truncate")
        assert ckpt.restore_checkpoint(d, _state(0))["step"] == 1

    def test_all_corrupt_raises_not_found(self, tmp_path):
        d = str(tmp_path)
        ckpt.save_checkpoint(d, _state(1), step=1)
        _damage_a_leaf(os.path.join(d, "step_1"))
        with pytest.raises(FileNotFoundError):
            ckpt.restore_checkpoint(d, _state(0))

    def test_pinned_corrupt_step_raises_and_is_kept(self, tmp_path):
        d = str(tmp_path)
        for s in (1, 2):
            ckpt.save_checkpoint(d, _state(s), step=s)
        _damage_a_leaf(os.path.join(d, "step_2"))
        with pytest.raises(CheckpointCorruptError) as ei:
            ckpt.restore_checkpoint(d, _state(0), step=2)
        assert ei.value.problems and ei.value.path.endswith("step_2")
        assert os.path.isdir(os.path.join(d, "step_2"))

    def test_verify_false_skips_checks(self, tmp_path):
        d = str(tmp_path)
        ckpt.save_checkpoint(d, _state(1), step=1)
        mpath = os.path.join(d, "step_1", ckpt.MANIFEST_NAME)
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["files"][ckpt.STATE_NAME]["crc32"] ^= 0xFFFF
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        assert ckpt.verify_step_dir(os.path.join(d, "step_1"))
        restored = ckpt.restore_checkpoint(d, _state(0), step=1, verify=False)
        assert restored["step"] == 1

    def test_quarantine_name_collision(self, tmp_path):
        d = str(tmp_path)
        for _ in range(2):
            ckpt.save_checkpoint(d, _state(1), step=1)
            _damage_a_leaf(os.path.join(d, "step_1"))
            with pytest.raises(FileNotFoundError):
                ckpt.restore_checkpoint(d, _state(0))
        assert sorted(n for n in os.listdir(d) if ".corrupt" in n) == [
            "step_1.corrupt", "step_1.corrupt.1",
        ]

    def test_walk_back_matches_the_jax_package(self, tmp_path):
        # Same damage pattern on both packages' checkpoints: the same
        # step is restored and the same directories are quarantined.
        picks = {}
        for name, lib, state in (
            ("port", ckpt, lambda s: _state(s)),
            ("jax", jckpt, lambda s: {
                "params": {"w": np.full((4, 2), float(s)), "b": np.zeros(2)},
                "step": np.int64(s),
            }),
        ):
            d = str(tmp_path / name)
            for s in (1, 2, 3, 4):
                lib.save_checkpoint(d, state(s), step=s, keep=5, force=True)
            _damage_a_leaf(os.path.join(d, "step_4"), "corrupt")
            _damage_a_leaf(os.path.join(d, "step_3"), "truncate")
            restored = lib.restore_checkpoint(d, state(0))
            picks[name] = (
                int(restored["step"]), lib.all_steps(d),
                sorted(n for n in os.listdir(d) if ".corrupt" in n),
            )
        assert picks["port"] == picks["jax"] == (
            2, [1, 2], ["step_3.corrupt", "step_4.corrupt"]
        )


class TestHotSwapHelpers:
    def test_hot_swap_restore_rolls_back(self, tmp_path):
        d = str(tmp_path)
        for s, v in ((1, 2.0), (2, 3.0)):
            ckpt.save_checkpoint(d, {"scale": torch.tensor(v)}, step=s)
        tgt = {"scale": torch.zeros(())}
        state, step, rb = ckpt.hot_swap_restore(d, tgt, step=2)
        assert (float(state["scale"]), step, rb) == (3.0, 2, False)
        ckpt.save_checkpoint(d, {"scale": torch.tensor(9.0)}, step=3)
        _damage_a_leaf(os.path.join(d, "step_3"))
        state, step, rb = ckpt.hot_swap_restore(d, tgt, step=3)
        assert rb is True and step == 2 and float(state["scale"]) == 3.0
        assert os.path.isdir(os.path.join(d, "step_3.corrupt"))

    def test_watcher_offers_each_step_once_and_rewinds(self, tmp_path):
        w = ckpt.CheckpointWatcher(str(tmp_path))
        assert w.poll() is None
        ckpt.save_checkpoint(str(tmp_path), {"x": torch.ones(1)}, step=3)
        assert w.poll() == 3 and w.poll() is None
        w.rewind(3)
        assert w.poll() == 3
        w.rewind(1)  # older than last seen: no-op
        assert w.poll() is None


class TestSaveRetry:
    def test_transient_write_failure_is_retried(self, tmp_path, monkeypatch):
        real = ckpt._write_tree
        fails = {"n": 1}

        def tearing(path, state):
            if fails["n"]:
                fails["n"] -= 1
                with open(os.path.join(path, "torn.partial"), "wb") as f:
                    f.write(b"half")
                raise OSError("injected EIO")
            return real(path, state)

        monkeypatch.setattr(ckpt, "_write_tree", tearing)
        out = ckpt.save_checkpoint(str(tmp_path), {"w": torch.arange(4.0)}, step=1)
        assert not os.path.exists(os.path.join(out, "torn.partial"))
        assert ckpt.verify_step_dir(out) == []

    def test_persistent_failure_raises_and_cleans_tmp(self, tmp_path,
                                                      monkeypatch):
        def dead(path, state):
            raise OSError("dead disk")

        monkeypatch.setattr(ckpt, "_write_tree", dead)
        monkeypatch.setattr("horovod_tpu_torch.utils.retry.time.sleep",
                            lambda s: None)
        with pytest.raises(OSError, match="dead disk"):
            ckpt.save_checkpoint(str(tmp_path), {"w": torch.ones(2)}, step=3)
        assert not [n for n in os.listdir(tmp_path) if n.startswith("step_")]


# -- training state (port twins of tests/test_sharded_optimizer.py::
# test_replicated_checkpoint_roundtrip_unchanged, with the quantized wire's
# error-feedback residuals) --------------------------------------------------


def _train_problem():
    rs = np.random.RandomState(5)
    params = {"w": rs.standard_normal((6, 4)).astype(np.float32),
              "b": np.zeros(4, np.float32),
              "c": (rs.standard_normal(9) * 0.1).astype(np.float32)}
    batches = [{"x": rs.standard_normal((8, 6)).astype(np.float32),
                "y": rs.standard_normal((8, 4)).astype(np.float32)}
               for _ in range(4)]
    return params, batches


def _train_loss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean() + (
        p["c"] ** 2).sum()


def _train_step(variant):
    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.parallel import dp as tdp

    comp = Compression.int8.with_block(8)
    if variant == "replicated":
        return tdp.make_train_step(_train_loss, topt.adamw(1e-2),
                                   compression=comp, device="cpu")
    return tdp.make_train_step(_train_loss, topt.fused_adamw(1e-2),
                               compression=comp, sharded=True,
                               fused_update=True, device="cpu")


@pytest.mark.parametrize("variant", ["replicated", "zero1"])
def test_train_state_roundtrip_resumes_bit_for_bit(tmp_path, variant):
    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.ops.fusion import EFResiduals, FlatBuckets
    from horovod_tpu_torch.parallel import dp as tdp

    params, batches = _train_problem()
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]

    def fresh():
        return {k: torch.from_numpy(v.copy()) for k, v in params.items()}

    step, opt = _train_step(variant)
    state = tdp.init_state(fresh(), opt)
    for b in tb[:2]:
        state, _ = step(state, b)
    assert topt.ef_residual_norm(state) > 0
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, state, step=2)
    snapshot = ckpt._flat_state(state)

    target = tdp.init_state(fresh(), opt)
    restored = ckpt.restore_checkpoint(d, target)
    # The target's own types, every leaf equal to the saved one.
    assert type(restored) is tdp.TrainState
    assert type(restored.opt_state) is type(state.opt_state)
    assert type(restored.opt_state.residual) is EFResiduals
    assert restored.opt_state.residual.block == 8
    if variant == "zero1":
        assert restored.opt_state.world == 1
        assert type(restored.opt_state.inner.mu) is FlatBuckets
    assert restored.extra is None
    for name, p in restored.params.items():
        assert p.requires_grad, name
    again = ckpt._flat_state(restored)
    assert sorted(again) == sorted(snapshot)
    for k, v in snapshot.items():
        assert torch.equal(again[k], v), k

    # The next steps from the restored state equal the uninterrupted run's.
    for b in tb[2:]:
        state, loss = step(state, b)
        restored, loss_r = step(restored, b)
        assert torch.equal(loss, loss_r)
    for k in params:
        assert torch.equal(state.params[k], restored.params[k]), k
    a, b = ckpt._flat_state(state), ckpt._flat_state(restored)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_state_nests_of_tuples_namedtuples_and_none(tmp_path):
    from horovod_tpu_torch.optimizer import AdamState

    state = {"t": (torch.arange(3.0), [np.float32(2.5), None]),
             "adam": AdamState(torch.tensor(4, dtype=torch.int32),
                               {"w": torch.ones(2)}, {"w": torch.zeros(2)}),
             "n": None}
    ckpt.save_checkpoint(str(tmp_path), state, step=1)
    target = {"t": (torch.zeros(3), [np.float32(0), None]),
              "adam": AdamState(torch.tensor(0, dtype=torch.int32),
                                {"w": torch.zeros(2)}, {"w": torch.ones(2)}),
              "n": None}
    got = ckpt.restore_checkpoint(str(tmp_path), target)
    assert isinstance(got["t"], tuple) and isinstance(got["t"][1], list)
    assert torch.equal(got["t"][0], torch.arange(3.0))
    assert got["t"][1][0] == np.float32(2.5) and got["t"][1][1] is None
    assert type(got["adam"]) is AdamState and int(got["adam"].count) == 4
    assert torch.equal(got["adam"].mu["w"], torch.ones(2))
    assert got["n"] is None
    # A template asking for a leaf the checkpoint lacks raises.
    with pytest.raises(ValueError, match="no entry"):
        ckpt.restore_checkpoint(str(tmp_path), {"n": torch.zeros(1)})
