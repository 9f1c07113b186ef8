"""World-size-portable training checkpoints of the port (gather on save,
reshard on restore), twins of the JAX package's
``tests/test_sharded_optimizer.py::test_checkpoint_roundtrip_across_world_sizes``,
``test_checkpoint_restore_across_thresholds`` and
``test_replicated_checkpoint_roundtrip_unchanged``, and of
``tests/test_quantization.py::test_residuals_roundtrip_checkpoint_and_reshard``
(replicated and ZeRO-1) and ``test_ef_off_sharded_quant_checkpoints``.

The same small regression as those tests (``w [4, 3]``, ``b [3]``,
``c [7]``: one 22-element fp32 bucket; a global batch of 16 rows, rank r of
a world of W taking rows ``[16r/W, 16(r+1)/W)``). Where the JAX tests
resize a world of 8 devices to 4, the port resizes a gloo world of 4 CPU
processes to 2 (``context.spawn_gloo``): one world of 4 saves every
portable checkpoint, one world of 2 restores them and runs the cases that
stay at one world size. Tolerances are the JAX tests': the continued
trajectory within ``rtol=2e-5, atol=1e-6`` of the uninterrupted one (the
same data, reduced over 2 ranks in place of 4: fp32 sums in another order),
the restored residual within ``rtol=1e-6`` of the old world's mean (one
fp32 all-reduce and division), the replicated round trip within
``rtol=1e-6``.

C7: the EF residuals of non-fp32 parameters (bf16, and bf16 mixed with
fp32) pack by the parameters' own bucket layout after a restore, as the
quantized collectives pack them (``_init_residuals``), where the JAX
package's ``_reshard_residuals`` packs the fp32 canonical tree by its own
bytes (``horovod_tpu/optimizer.py:949-969``; a documented difference, the
reference is not edited). On a gloo world of 2 whose ranks take the same
batch (so every rank's residual is the mean-equivalent one), a quantized
step after the restore equals the uninterrupted run's bit for bit.

One case holds the canonical form against the JAX package's directly: the
port's ``unshard_opt_state`` of a ZeRO-1 state on the int8 wire after 2
steps (a world of 2) against ``horovod_tpu.unshard_opt_state`` of the JAX
step's (2 CPU devices), leaf by leaf, within the port's quantized
train-parity tolerances (``test_torch_port_quant_train.py``): the moments
within 1e-4 of each leaf's largest value in L2, the mean residual within
1e-6 absolute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd
from horovod_tpu.ops.compression import Compression as JComp
from horovod_tpu.parallel import dp as jdp
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch import context
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.ops.collectives import barrier
from horovod_tpu_torch.ops.compression import Compression as TComp
from horovod_tpu_torch.ops.fusion import FlatBuckets
from horovod_tpu_torch.parallel import dp as tdp

OLD, NEW = 4, 2  # world sizes
BLOCK = 8
LR = 1e-2
PAYLOAD = 22  # elements of the one fp32 bucket


def _params():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": np.zeros((3,), np.float32),
            "c": rng.randn(7).astype(np.float32)}


def _batch(seed=1, n=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 4).astype(np.float32),
            rng.randn(n, 3).astype(np.float32))


def _loss(p, batch):
    x, y = batch
    return ((x @ p["w"] + p["b"] - y) ** 2).mean() + 0.1 * (p["c"] ** 2).sum()


def _jloss(p, batch):
    x, y = batch
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2) + 0.1 * jnp.sum(
        p["c"] ** 2)


def _fresh():
    return {k: torch.from_numpy(v.copy()) for k, v in _params().items()}


def _shard(batch):
    """This rank's rows of a global batch."""
    world, rank = context.size(), context.rank()
    n = batch[0].shape[0] // world
    return tuple(torch.from_numpy(a[rank * n:(rank + 1) * n]) for a in batch)


def _step(**kw):
    return tdp.make_train_step(_loss, topt.adamw(LR), device="cpu", **kw)


def _numpy(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _flat_buckets(state):
    return [n for n in topt._nodes(state.opt_state.inner,
                                   lambda n: isinstance(n, FlatBuckets))]


def _int8():
    return TComp.int8.with_block(BLOCK)


def _save_old_world(root):
    """A world of OLD ranks: save every portable checkpoint."""
    out = {}
    batch = _batch()
    # ZeRO-1: one step, save, one more step (the uninterrupted reference).
    step, opt = _step(sharded=True)
    state = tdp.init_state(_fresh(), opt)
    state, _ = step(state, _shard(batch))
    out["zero1_shards"] = [b.shape[0] for fb in _flat_buckets(state)
                           for b in fb.buffers]
    ckpt.save_checkpoint(os.path.join(root, "zero1"), state, step=1)
    state, _ = step(state, _shard(batch))
    out["zero1_ref"] = _numpy(state.params)
    # The quantized wire's residuals, replicated and ZeRO-1: 3 steps, save.
    for name, sharded in (("replicated", False), ("zero1", True)):
        step, opt = _step(sharded=sharded, compression=_int8())
        state = tdp.init_state(_fresh(), opt)
        for i in range(3):
            state, _ = step(state, _shard(_batch(seed=i)))
        out["res_" + name] = [b.numpy().copy()
                              for b in state.opt_state.residual.buffers]
        ckpt.save_checkpoint(os.path.join(root, "res_" + name), state,
                             step=3)
    return out


def _restore_new_world(root):
    """A world of NEW ranks: restore the OLD world's checkpoints, and run
    the cases that stay at one world size."""
    out = {}
    batch = _batch()
    step, opt = _step(sharded=True)
    restored = ckpt.restore_checkpoint(os.path.join(root, "zero1"),
                                       tdp.init_state(_fresh(), opt))
    out["zero1_step"] = int(restored.step)
    out["zero1_world"] = restored.opt_state.world
    out["zero1_shards"] = [b.shape[0] for fb in _flat_buckets(restored)
                           for b in fb.buffers]
    restored, _ = step(restored, _shard(batch))
    out["zero1_got"] = _numpy(restored.params)

    for name, sharded in (("replicated", False), ("zero1", True)):
        step, opt = _step(sharded=sharded, compression=_int8())
        restored = ckpt.restore_checkpoint(os.path.join(root, "res_" + name),
                                           tdp.init_state(_fresh(), opt))
        res = restored.opt_state.residual
        out["res_" + name] = {
            "type": type(res).__name__, "block": res.block,
            "buffers": [b.numpy().copy() for b in res.buffers],
            "step": int(restored.step),
        }
        restored, loss = step(restored, _shard(batch))
        out["res_" + name]["loss"] = float(loss)

    # Across thresholds: a 64-byte threshold splits the bucket in several;
    # the restore repacks at the target's (default) threshold.
    d = os.path.join(root, "thr")
    step_a, opt_a = _step(sharded=True, threshold_bytes=64)
    sa = tdp.init_state(_fresh(), opt_a)
    sa, _ = step_a(sa, _shard(batch))
    out["thr_saved_buckets"] = len(_flat_buckets(sa)[0].buffers)
    ckpt.save_checkpoint(d, sa, step=1)
    barrier()  # rank 0 has written it before anyone reads it
    ref, _ = step_a(sa, _shard(batch))
    out["thr_ref"] = _numpy(ref.params)
    step_b, opt_b = _step(sharded=True)
    restored = ckpt.restore_checkpoint(d, tdp.init_state(_fresh(), opt_b))
    out["thr_threshold"] = restored.opt_state.threshold
    out["thr_restored_buckets"] = len(_flat_buckets(restored)[0].buffers)
    sb, _ = step_b(restored, _shard(batch))
    out["thr_got"] = _numpy(sb.params)

    # The replicated path without residuals is written as it is.
    d = os.path.join(root, "rep")
    step, opt = _step()
    st, _ = step(tdp.init_state(_fresh(), opt), _shard(batch))
    ckpt.save_checkpoint(d, st, step=1)
    barrier()
    out["rep_canonical"] = topt.has_sharded_state(st)
    restored = ckpt.restore_checkpoint(d, tdp.init_state(_fresh(), opt))
    a, b = ckpt._flat_state(st), ckpt._flat_state(restored)
    out["rep_keys"] = sorted(a) == sorted(b)
    out["rep_max_rel"] = max(
        float(((a[k].double() - b[k].double()).abs()
               / b[k].double().abs().clamp_min(1e-30)).max())
        for k in a if a[k].is_floating_point())

    # ZeRO-1 on the quantized wire without error feedback: the recorded
    # block (not the absent residuals) drives the canonical transforms.
    d = os.path.join(root, "ef_off")
    step, opt = _step(sharded=True, compression=_int8(),
                      error_feedback=False)
    st, _ = step(tdp.init_state(_fresh(), opt), _shard(batch))
    out["ef_off_residual"] = st.opt_state.residual
    out["ef_off_block"] = st.opt_state.block
    ckpt.save_checkpoint(d, st, step=1)
    barrier()
    restored = ckpt.restore_checkpoint(d, tdp.init_state(_fresh(), opt))
    out["ef_off_restored_block"] = restored.opt_state.block
    st2, loss = step(restored, _shard(_batch()))
    out["ef_off_loss"] = float(loss)

    # The canonical form held against the JAX package's: ZeRO-1 on the
    # int8 wire, 2 steps.
    step, opt = _step(sharded=True, compression=_int8())
    st = tdp.init_state(_fresh(), opt)
    for i in range(2):
        st, _ = step(st, _shard(_batch(seed=i)))
    canon = topt.unshard_opt_state(st.opt_state, st.params)
    out["canon"] = {
        "count": int(canon.count),
        "mu": _numpy(canon.inner.mu.tree),
        "nu": _numpy(canon.inner.nu.tree),
        "residual": _numpy(canon.residual.tree),
        "block": canon.block,
        "threshold": canon.threshold,
    }
    return out


C7_THRESHOLD = 600  # bytes: splits the bf16 leaves unlike their fp32 copy
C7_DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
             "mixed": (torch.bfloat16, torch.float32, torch.bfloat16)}


def _c7_params(kind):
    rng = np.random.RandomState(3)
    dw, dv, dc = C7_DTYPES[kind]
    return {"w": torch.from_numpy(rng.randn(16, 16).astype(np.float32)).to(dw),
            "v": torch.from_numpy(rng.randn(16, 8).astype(np.float32)).to(dv),
            "c": torch.from_numpy(rng.randn(40).astype(np.float32)).to(dc)}


def _c7_loss(p, batch):
    x, y = batch
    h = torch.tanh(x.to(p["w"].dtype) @ p["w"]).float()
    pred = h.to(p["v"].dtype) @ p["v"]
    return ((pred.float() - y) ** 2).mean() + 0.1 * (p["c"].float() ** 2).sum()


def _c7_batch(seed):
    """The same 8 rows on every rank."""
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(8, 16).astype(np.float32)),
            torch.from_numpy(rng.randn(8, 8).astype(np.float32)))


def _c7_world(root):
    """A world of 2 on the same batch: for each parameter mix and path, 2
    quantized steps, save, 1 more (the reference); restore into a fresh
    target and take that step again."""
    out = {}
    for kind in C7_DTYPES:
        for path, sharded in (("replicated", False), ("zero1", True)):
            name = f"{kind}_{path}"
            d = os.path.join(root, "c7_" + name)
            step, opt = tdp.make_train_step(
                _c7_loss, topt.adamw(LR), device="cpu", sharded=sharded,
                compression=_int8(), threshold_bytes=C7_THRESHOLD)
            st = tdp.init_state(_c7_params(kind), opt)
            for i in range(2):
                st, _ = step(st, _c7_batch(10 + i))
            saved = [b.clone() for b in st.opt_state.residual.buffers]
            ckpt.save_checkpoint(d, st, step=2)
            barrier()
            batch = _c7_batch(20)
            ref, ref_loss = step(st, batch)
            ref = {k: v.detach().clone() for k, v in ref.params.items()}
            restored = ckpt.restore_checkpoint(
                d, tdp.init_state(_c7_params(kind), opt))
            runtime = topt._init_residuals(_c7_params(kind), C7_THRESHOLD,
                                           BLOCK)
            fp32_tree = {k: v.float() for k, v in _c7_params(kind).items()}
            fp32_layout = topt._layout(fp32_tree, C7_THRESHOLD,
                                       context.size() * BLOCK)
            res = restored.opt_state.residual
            got, loss = step(restored, batch)
            out[name] = {
                "restored_sizes": [b.numel() for b in res.buffers],
                "init_sizes": [b.numel() for b in runtime.buffers],
                "fp32_sizes": list(fp32_layout.padded_sizes()),
                "residual_equal": len(saved) == len(res.buffers) and all(
                    torch.equal(a, b) for a, b in zip(saved, res.buffers)),
                "residual_nonzero": any(bool(b.any()) for b in saved),
                "dtypes": {k: str(v.dtype) for k, v in got.params.items()},
                "params_equal": all(torch.equal(got.params[k], ref[k])
                                    for k in ref),
                "loss_equal": float(loss) == float(ref_loss),
            }
    return out


@pytest.fixture(scope="module")
def c7_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("c7"))
    return context.spawn_gloo(2, _c7_world, root)


@pytest.mark.parametrize("path", ["replicated", "zero1"])
@pytest.mark.parametrize("kind", sorted(C7_DTYPES))
def test_non_fp32_residuals_restore_in_the_runtime_layout(c7_runs, kind,
                                                          path):
    for got in (r[f"{kind}_{path}"] for r in c7_runs):
        # The restored buffers are the layout the quantized collectives
        # pack (the params' own dtypes), not the fp32 tree's.
        assert got["restored_sizes"] == got["init_sizes"]
        assert got["fp32_sizes"] != got["init_sizes"]
        assert got["residual_nonzero"] and got["residual_equal"]
        want = [str(d) for d in C7_DTYPES[kind]]
        assert [got["dtypes"][k] for k in ("w", "v", "c")] == want
        # The quantized step after the restore is the uninterrupted one.
        assert got["params_equal"] and got["loss_equal"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ck"))
    old = context.spawn_gloo(OLD, _save_old_world, root)
    new = context.spawn_gloo(NEW, _restore_new_world, root)
    return old, new


def _assert_trajectory(want, got):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6)


def test_checkpoint_roundtrip_across_world_sizes(runs):
    old, new = runs
    # The 22-element bucket: 24 padded at world 4 (6 a shard), 22 at 2.
    assert old[0]["zero1_shards"] == [6, 6]  # mu and nu
    for r in range(NEW):
        assert new[r]["zero1_step"] == 1 and new[r]["zero1_world"] == NEW
        assert new[r]["zero1_shards"] == [PAYLOAD // NEW] * 2
        _assert_trajectory(old[0]["zero1_ref"], new[r]["zero1_got"])


def test_checkpoint_restore_across_thresholds(runs):
    _, new = runs
    for r in range(NEW):
        got = new[r]
        assert got["thr_saved_buckets"] > 1
        assert got["thr_threshold"] != 64  # the target's layout wins
        assert got["thr_restored_buckets"] == 1
        _assert_trajectory(got["thr_ref"], got["thr_got"])


def test_replicated_checkpoint_roundtrip_unchanged(runs):
    _, new = runs
    for r in range(NEW):
        assert new[r]["rep_canonical"] is False
        assert new[r]["rep_keys"]
        assert new[r]["rep_max_rel"] <= 1e-6


@pytest.mark.parametrize("sharded", ["replicated", "zero1"])
def test_residuals_roundtrip_checkpoint_and_reshard(runs, sharded):
    old, new = runs
    res_old = [old[r]["res_" + sharded] for r in range(OLD)]
    mean_old = [sum(res[i] for res in res_old) / OLD
                for i in range(len(res_old[0]))]
    assert any(np.abs(m).max() > 0 for m in mean_old)
    for r in range(NEW):
        got = new[r]["res_" + sharded]
        assert got["type"] == "EFResiduals" and got["block"] == BLOCK
        assert got["step"] == 3
        # Every new rank carries the mean-equivalent payload.
        for buf, mean in zip(got["buffers"], mean_old):
            assert buf.shape == (16 * -(-PAYLOAD // 16),)  # 22 -> 32
            np.testing.assert_allclose(buf[:PAYLOAD], mean[:PAYLOAD],
                                       rtol=1e-6)
            assert not buf[PAYLOAD:].any()
        assert np.isfinite(got["loss"])


def test_ef_off_sharded_quant_checkpoints(runs):
    _, new = runs
    for r in range(NEW):
        got = new[r]
        assert got["ef_off_residual"] is None
        assert got["ef_off_block"] == BLOCK
        assert got["ef_off_restored_block"] == BLOCK
        assert np.isfinite(got["ef_off_loss"])


@pytest.fixture(scope="module")
def jax_canonical():
    from horovod_tpu.optimizer import CanonicalBuckets

    hvd.init(devices=jax.devices("cpu")[:NEW])
    try:
        step, opt = jdp.make_train_step(
            _jloss, optax.adamw(LR, weight_decay=1e-4), sharded=True,
            compression=JComp.int8.with_block(BLOCK))
        state = jdp.init_state(jax.tree.map(jnp.asarray, _params()), opt)
        for i in range(2):
            x, y = _batch(seed=i)
            state, _ = step(state, (jnp.asarray(x), jnp.asarray(y)))
        canon = hvd.unshard_opt_state(state.opt_state, state.params)
        adam = [n for n in jax.tree.leaves(
            canon.inner, is_leaf=lambda n: isinstance(n, CanonicalBuckets))
            if isinstance(n, CanonicalBuckets)]
        mu, nu = adam
        return {
            "count": int(canon.count),
            "mu": jax.tree.map(np.asarray, mu.tree),
            "nu": jax.tree.map(np.asarray, nu.tree),
            "residual": jax.tree.map(np.asarray, canon.residual.tree),
            "block": int(canon.block),
        }
    finally:
        hvd.shutdown()


def test_canonical_form_matches_the_jax_package(runs, jax_canonical):
    _, new = runs
    want = jax_canonical
    for r in range(NEW):
        got = new[r]["canon"]
        assert got["count"] == want["count"] == 2
        assert got["block"] == want["block"] == BLOCK
        for leaf in ("mu", "nu"):
            assert sorted(got[leaf]) == sorted(want[leaf]) == ["b", "c", "w"]
            for name, w in want[leaf].items():
                g = got[leaf][name]
                assert g.shape == w.shape, (leaf, name)
                assert np.linalg.norm(g - w) <= 1e-4 * np.abs(w).max(), (
                    leaf, name)
        for name, w in want["residual"].items():
            np.testing.assert_allclose(got["residual"][name], w, rtol=0,
                                       atol=1e-6)
