"""The port's Spark integration (horovod_tpu_torch.spark) held against the
JAX package's (horovod_tpu.spark), on the CPU.

Twins of ``tests/test_spark.py``: the store layout and IO, the params, the
reference's split and materialization semantics -- with the parquet shard
files byte for byte the JAX package's on the same pandas frame -- the
estimators against the JAX package's on the same data, ``spark.run`` under
the same fake pyspark, and a two-rank fit on a gloo world. Tolerances:
the parameter-dict estimator against ``FlaxEstimator`` (the same Flax
weights carried across, optax-equivalent AdamW/SGD) 1e-5 on every epoch
loss and 1e-5 on the final fp32 parameters of the MLP (summation order
only); GPT-2 tiny's losses 1e-5 relative and each leaf's movement to 1e-3
of its L2 -- Adam turns fp32 noise on the key bias, whose exact gradient
is 0, into +-lr steps, so that third of ``qkv.bias`` is left out; the
TorchEstimator bit for bit (the same torch ops); Keras within 1e-6 (the
same TensorFlow ops, in spawned processes).
"""

import os
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu.spark as jspark
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.models.mlp import MLP as JMLP
from horovod_tpu.spark import util as jutil
from horovod_tpu_torch import context, convert
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch import spark as tspark
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.models.mlp import MLP as TMLP
from horovod_tpu_torch.spark import util as tutil

import torch_spark_ranks as R

TESTS = os.path.dirname(os.path.abspath(__file__))
FEATS = R.FEATURES


def _df(n=256, seed=0):
    return R.features_df(n, seed)


def _xor(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.int64)
    return x, y


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _shard_bytes(store, path):
    if not store.exists(path):
        return {}
    return {os.path.basename(p): store.read(p)
            for p in store.listdir(path) if p.endswith(".parquet")}


# ---------------------------------------------------------------------------
# Store and params


class TestStore:
    def test_layout_is_the_references(self, tmp_path):
        s = tspark.FilesystemStore(str(tmp_path))
        r = jspark.FilesystemStore(str(tmp_path))
        for name in ("get_train_data_path", "get_val_data_path",
                     "get_test_data_path"):
            for idx in (None, 2, "run1"):
                assert getattr(s, name)(idx) == getattr(r, name)(idx)
        for name in ("get_runs_path",):
            assert getattr(s, name)() == getattr(r, name)()
        for name in ("get_run_path", "get_checkpoint_path", "get_logs_path"):
            assert getattr(s, name)("r1") == getattr(r, name)("r1")
        assert (s.get_epoch_checkpoint_path("r1", 3)
                == r.get_epoch_checkpoint_path("r1", 3))
        assert s.get_checkpoint_path("r1") == str(
            tmp_path / "runs" / "r1" / "checkpoint.msgpack")
        assert s.get_logs_path("r1") == str(tmp_path / "runs" / "r1" / "logs")

    def test_io_roundtrip(self, tmp_path):
        s = tspark.FilesystemStore(str(tmp_path))
        p = s.get_checkpoint_path("r1")
        assert not s.exists(p)
        s.write(p, b"hello")
        assert s.exists(p)
        assert s.read(p) == b"hello"
        with s.open(p) as f:
            assert f.read() == b"hello"
        assert p in s.listdir(str(tmp_path / "runs" / "r1"))
        s.delete(s.get_run_path("r1"))
        assert not s.exists(p)

    def test_create_dispatch(self, tmp_path):
        assert isinstance(tspark.Store.create(str(tmp_path)),
                          tspark.FilesystemStore)
        assert issubclass(tspark.LocalStore, tspark.FilesystemStore)
        assert tspark.Store(str(tmp_path)).open is not None


class TestParams:
    def test_fluent_setters(self):
        p = tspark.EstimatorParams()
        p.setBatchSize(16).setEpochs(3).setFeatureCols(["x"])._set(
            device="cpu")
        assert (p.batch_size, p.epochs, p.feature_cols, p.device) == (
            16, 3, ["x"], "cpu")
        with pytest.raises(AttributeError):
            p._set(bogus=1)

    def test_defaults_and_validation_are_the_references(self):
        p, r = tspark.EstimatorParams(), jspark.EstimatorParams()
        for k, v in vars(r).items():
            assert getattr(p, k) == v, k
        for est in (p, r):
            with pytest.raises(ValueError, match="model"):
                est._validate()
        with pytest.raises(ValueError, match=">= 1"):
            tspark.EstimatorParams(model=1, optimizer=1, loss=1,
                                   epochs=0)._validate()


# ---------------------------------------------------------------------------
# Materialization: the reference's split semantics, the same shard files


def _both_prepared(tmp_path, df, **kw):
    ts = tspark.FilesystemStore(str(tmp_path / "port"))
    rs = jspark.FilesystemStore(str(tmp_path / "ref"))
    got = tutil.prepare_data(ts, df, **kw)
    want = jutil.prepare_data(rs, df, **kw)
    return ts, rs, got, want


@pytest.mark.parametrize("validation", [None, 0.2, "val_int", "val_bool"])
def test_prepare_data_writes_the_references_shards(tmp_path, validation):
    """The split by ratio or by an integer/boolean column (reference
    test_spark.py:1194,1209,1224) and every shard file, byte for byte."""
    df = _df(101)
    rng = np.random.RandomState(3)
    df["val_int"] = (rng.rand(len(df)) < 0.3).astype(np.int64)
    df["val_bool"] = rng.rand(len(df)) < 0.25
    ts, rs, got, want = _both_prepared(
        tmp_path, df, feature_cols=FEATS, label_cols=["label"],
        num_shards=4, validation=validation)
    assert got == want
    for path in ("get_train_data_path", "get_val_data_path"):
        a = _shard_bytes(ts, getattr(ts, path)())
        b = _shard_bytes(rs, getattr(rs, path)())
        assert a == b and (a or path == "get_val_data_path")
    if validation is None:
        assert got == (101, 0)
    elif validation == 0.2:
        assert got == (81, 20)
    else:
        assert got == (101 - int(df[validation].sum()),
                       int(df[validation].sum()))


def test_split_column_is_not_materialized(tmp_path):
    import pandas as pd

    store = tspark.FilesystemStore(str(tmp_path))
    df = pd.DataFrame({"data": [1.0, 1.0, 1.0, 1.0, 1.0],
                       "val": [0, 0, 0, 0, 1]})
    assert tutil.prepare_data(store, df, feature_cols=["data"], label_cols=[],
                              num_shards=2, validation="val") == (4, 1)
    feats, _ = tutil.read_shard(store, store.get_train_data_path(), rank=0,
                                num_ranks=1, feature_cols=["data"],
                                label_cols=[])
    assert feats.shape[0] == 4


def test_materialization_preserves_rows_exactly(tmp_path):
    """3 ranks over 4 shard files: disjoint, exhaustive, and each rank's
    arrays the reference's read of the reference's shards."""
    df = _df(101)
    ts, rs, _, _ = _both_prepared(tmp_path, df, feature_cols=FEATS,
                                  label_cols=["label"], num_shards=4)
    seen = []
    for rank in range(3):
        kw = dict(rank=rank, num_ranks=3, feature_cols=FEATS,
                  label_cols=["label"])
        fx, fy = tutil.read_shard(ts, ts.get_train_data_path(), **kw)
        gx, gy = jutil.read_shard(rs, rs.get_train_data_path(), **kw)
        np.testing.assert_array_equal(fx, gx)
        np.testing.assert_array_equal(fy, gy)
        seen.append(fx)
    allrows = np.concatenate(seen)
    assert allrows.shape == (101, 4)
    np.testing.assert_array_equal(np.sort(allrows[:, 0]),
                                  np.sort(df["f0"].to_numpy()))


def test_prepare_and_read_shards_idempotent(tmp_path):
    store = tspark.FilesystemStore(str(tmp_path))
    df = _df(100)
    kw = dict(feature_cols=FEATS, label_cols=["label"], num_shards=4,
              validation=0.2)
    assert tutil.prepare_data(store, df, **kw) == (80, 20)
    assert len(_shard_bytes(store, store.get_train_data_path())) == 4
    parts = [tutil.read_shard(store, store.get_train_data_path(), rank=r,
                              num_ranks=2, feature_cols=FEATS,
                              label_cols=["label"]) for r in range(2)]
    assert sum(p[0].shape[0] for p in parts) == 80
    assert all(p[0].shape[1] == 4 for p in parts)
    assert tutil.prepare_data(store, df, **kw) == (80, 20)


def test_missing_feature_column_errors(tmp_path):
    store = tspark.FilesystemStore(str(tmp_path))
    with pytest.raises(ValueError, match="nope"):
        tutil.prepare_data(store, _df(10), feature_cols=["nope"],
                           label_cols=["label"], num_shards=1)


def test_streaming_reads_are_the_references(tmp_path):
    """iter_shard_batches, shard_row_count and shard_label_dtype on the
    same shards as the reference's (TestStreamingShards)."""
    df = _df(400)
    ts, rs, _, _ = _both_prepared(tmp_path, df, feature_cols=FEATS,
                                  label_cols=["label"], num_shards=4)
    tp, rp = ts.get_train_data_path(), rs.get_train_data_path()
    for rank, n in ((0, 1), (1, 2)):
        assert (tutil.shard_row_count(ts, tp, rank=rank, num_ranks=n)
                == jutil.shard_row_count(rs, rp, rank=rank, num_ranks=n))
    kw = dict(rank=0, num_ranks=1, feature_cols=FEATS, label_cols=["label"],
              batch_rows=64)
    got = list(tutil.iter_shard_batches(ts, tp, **kw))
    want = list(jutil.iter_shard_batches(rs, rp, **kw))
    assert len(got) == len(want) and all(len(bx) <= 64 for bx, _ in got)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert np.concatenate([bx for bx, _ in got]).shape == (400, 4)
    assert (tutil.shard_label_dtype(ts, tp, ["label"])
            == jutil.shard_label_dtype(rs, rp, ["label"]))


# ---------------------------------------------------------------------------
# The parameter-dict estimator against FlaxEstimator


def _mlp_pair(x, features=(32,), classes=2):
    """The JAX package's MLP, its PRNGKey(0) init (what FlaxEstimator
    trains from) carried into the port's MLP."""
    jm = JMLP(features=features, num_classes=classes)
    flax_params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:4]))
    tm = TMLP(features=features, num_classes=classes,
              in_features=x.shape[1], device="cpu")
    return jm, tm, convert.mlp_params_from_flax(_tree_np(flax_params))


OPTIMIZERS = {
    "adamw": (lambda: optax.adamw(1e-2), lambda: topt.adamw(1e-2)),
    "sgd_momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                     lambda: topt.sgd(0.05, momentum=0.9)),
    "fused_adamw": (lambda: optax.adamw(1e-2),
                    lambda: topt.fused_adamw(1e-2)),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_params_estimator_matches_flax_estimator(tmp_path, opt):
    x, y = _xor()
    jm, tm, sd = _mlp_pair(x)
    jopt, topt_ = OPTIMIZERS[opt]
    common = dict(loss="auto", batch_size=64, epochs=10, run_id="m1")
    want = jspark.FlaxEstimator(
        model=jm, optimizer=jopt(),
        store=jspark.FilesystemStore(str(tmp_path / "ref")),
        **common).fit_arrays(x, y)
    store = tspark.FilesystemStore(str(tmp_path / "port"))
    got = tspark.ParamsEstimator(model=tm, params=sd, optimizer=topt_(),
                                 store=store, device="cpu",
                                 **common).fit_arrays(x, y)
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=1e-5, atol=1e-5)
    assert len(got.history["step_loss"]) == 10 * 4
    ref = convert.mlp_params_from_flax(_tree_np(want.params))
    assert sorted(got.params) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got.params[k].detach().numpy(), v.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    # The checkpoint reloads bit for bit, and its transform is the model's.
    assert store.exists(store.get_checkpoint_path("m1"))
    again = tspark.ParamsModel.load(store, "m1", model=tm, device="cpu")
    for k, v in got.params.items():
        assert torch.equal(again.params[k], v.detach())
    np.testing.assert_array_equal(again.transform_arrays(x[:8]),
                                  got.transform_arrays(x[:8]))
    assert tspark.FlaxEstimator is tspark.ParamsEstimator
    assert tspark.FlaxModel is tspark.ParamsModel


def test_params_estimator_leaves_the_module_where_it_is(tmp_path):
    """The trained dict is the one copy of the weights the estimator puts
    on its device: the module is never moved. A module on ``meta`` fits,
    transforms and reloads bit for bit as one built on the CPU, and stays
    on ``meta``."""
    x, y = _xor()
    _, _, sd = _mlp_pair(x)
    out = {}
    for dev in ("cpu", "meta"):
        tm = TMLP(features=(32,), num_classes=2, in_features=2, device=dev)
        store = tspark.FilesystemStore(str(tmp_path / dev))
        got = tspark.ParamsEstimator(
            model=tm, params=sd, optimizer=topt.adamw(1e-2), loss="auto",
            batch_size=64, epochs=3, store=store, run_id="m", device="cpu",
        ).fit_arrays(x, y, validation=(x[:32], y[:32]))
        again = tspark.ParamsModel.load(store, "m", model=tm, device="cpu")
        assert all(p.device.type == dev for p in tm.parameters())
        out[dev] = (got.history["step_loss"], got.transform_arrays(x[:8]),
                    again.transform_arrays(x[:8]))
    assert out["meta"][0] == out["cpu"][0]
    for a, b in zip(out["meta"][1:], out["cpu"][1:]):
        np.testing.assert_array_equal(a, b)


def test_params_estimator_learns_xor(tmp_path):
    """The reference's TestFlaxEstimator outcome on the port alone: 30
    epochs of Adam solve XOR (> 90%), and the loss falls."""
    x, y = _xor()
    _, tm, sd = _mlp_pair(x)
    model = tspark.ParamsEstimator(
        model=tm, params=sd, optimizer=topt.adamw(1e-2), loss="auto",
        batch_size=64, epochs=30, device="cpu").fit_arrays(x, y)
    assert model.history["loss"][-1] < model.history["loss"][0]
    assert (model.transform_arrays(x).argmax(-1) == y).mean() > 0.9


def test_gpt2_tiny_integer_sequence_labels_take_the_auto_loss(tmp_path):
    """[B, T] integer labels against [B, T, V] logits: mean cross-entropy
    over every position (optax's leading dimensions), the losses and the
    trained parameters FlaxEstimator's."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    tcfg = GPT2Config.tiny(dtype=torch.float32, param_dtype=torch.float32)
    tok = np.random.RandomState(0).randint(0, jcfg.vocab_size,
                                           (8, 17)).astype(np.int64)
    x, y = tok[:, :-1], tok[:, 1:]
    jm = jgpt2.GPT2LMModel(jcfg)
    sd = convert.params_from_flax(_tree_np(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:4]))))
    common = dict(loss="auto", batch_size=4, epochs=2, run_id="g")
    want = jspark.FlaxEstimator(
        model=jm, optimizer=optax.adamw(1e-3),
        store=jspark.FilesystemStore(str(tmp_path / "ref")),
        **common).fit_arrays(x, y)
    got = tspark.ParamsEstimator(
        model=GPT2LMModel(tcfg, device="cpu"), params=sd,
        optimizer=topt.adamw(1e-3), device="cpu",
        store=tspark.FilesystemStore(str(tmp_path / "port")),
        **common).fit_arrays(x, y)
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=1e-5)
    assert got.history["loss"][0] > np.log(jcfg.vocab_size) - 0.5
    ref = convert.params_from_flax(_tree_np(want.params))
    for k, v in ref.items():
        a, b, p0 = (got.params[k].detach().numpy(), v.numpy(),
                    sd[k].numpy())
        if k.endswith("attn.qkv.bias"):  # the key bias's third moves on noise
            a, b, p0 = (np.delete(t.reshape(3, -1), 1, 0) for t in (a, b, p0))
        moved = np.linalg.norm(b - p0)
        assert np.linalg.norm(a - b) <= 1e-3 * moved + 1e-7, k


@pytest.mark.parametrize("labels", ["int_bt", "int_b", "float"])
def test_auto_loss_is_the_references(labels):
    rs = np.random.RandomState(1)
    if labels == "int_bt":
        logits, y = rs.randn(3, 5, 7), rs.randint(0, 7, (3, 5))
        want = optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(logits, jnp.float32), jnp.asarray(y)).mean()
    elif labels == "int_b":
        logits, y = rs.randn(6, 4), rs.randint(0, 4, (6,))
        want = optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(logits, jnp.float32), jnp.asarray(y)).mean()
    else:
        logits, y = rs.randn(6, 2), rs.randn(6, 2)
        want = jnp.mean((jnp.asarray(logits, jnp.float32)
                         - jnp.asarray(y, jnp.float32)) ** 2)
    fn = tspark.estimator.auto_loss(np.asarray(y).dtype)
    got = fn(torch.tensor(logits, dtype=torch.float32),
             tspark.estimator.as_batch(y, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_validate_enforced():
    with pytest.raises(ValueError, match="optimizer"):
        tspark.ParamsEstimator(model=object(), device="cpu").fit_arrays(
            np.zeros((4, 2)), np.zeros(4))


def test_entry_points_default_to_the_card():
    """Without device='cpu' the estimator asks for the card, and raises
    where there is none (the card test drives it there)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: covered by the cuda tests")
    x, y = _xor(8)
    _, tm, sd = _mlp_pair(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        tspark.ParamsEstimator(model=tm, params=sd,
                               optimizer=topt.adamw(1e-2),
                               loss="auto").fit_arrays(x, y)


# ---------------------------------------------------------------------------
# fit(df): the shard path, streaming, best reload


def _fit_df_pair(tmp_path, df, **kw):
    x = df[FEATS].to_numpy()
    jm, tm, sd = _mlp_pair(x)
    common = dict(loss="auto", feature_cols=FEATS, label_cols=["label"], **kw)
    want = jspark.FlaxEstimator(
        model=jm, optimizer=optax.adam(1e-2),
        store=jspark.FilesystemStore(str(tmp_path / "ref")),
        **common).fit(df)
    store = tspark.FilesystemStore(str(tmp_path / "port"))
    got = tspark.ParamsEstimator(
        model=tm, params=sd, optimizer=topt.adamw(1e-2, weight_decay=0.0),
        store=store, device="cpu", **common).fit(df)
    return store, got, want


def test_fit_df_best_reload_matches_flax(tmp_path):
    store, got, want = _fit_df_pair(tmp_path, _df(400), batch_size=32,
                                    epochs=8, run_id="dfrun",
                                    validation=0.25)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(got.history[key], want.history[key],
                                   rtol=1e-5, atol=1e-6)
    assert store.exists(f"{store.get_train_data_path('dfrun')}/_SUCCESS")
    assert len(got.history["val_loss"]) == 8
    for epoch in (0, 7):
        assert store.exists(store.get_epoch_checkpoint_path("dfrun", epoch))
    best = int(np.argmin(got.history["val_loss"]))
    assert store.read(store.get_checkpoint_path("dfrun")) == store.read(
        store.get_epoch_checkpoint_path("dfrun", best))
    assert got.transform_arrays(np.zeros((50, 4), np.float32)).shape == (
        50, 2)


def test_fit_stream_matches_flax(tmp_path):
    """A shard of 400 rows over max_rows_in_memory=64 takes the streaming
    path on both sides; the same losses, falling."""
    calls = {}
    orig = tspark.ParamsEstimator.fit_stream

    def spy(self, *a, **k):
        calls["stream"] = True
        return orig(self, *a, **k)

    df = _df(400, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tspark.ParamsEstimator, "fit_stream", spy)
        _, got, want = _fit_df_pair(tmp_path, df, batch_size=32, epochs=4,
                                    run_id="stream1", max_rows_in_memory=64)
    assert calls.get("stream")
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=1e-5, atol=1e-6)
    assert got.history["loss"][-1] < got.history["loss"][0]


def test_streaming_not_triggered_below_threshold(tmp_path):
    est = tspark.ParamsEstimator(
        model=TMLP(features=(), num_classes=2, in_features=4, device="cpu"),
        optimizer=topt.adamw(1e-2), loss="auto", feature_cols=FEATS,
        label_cols=["label"], batch_size=16, epochs=1, run_id="stream2",
        store=tspark.FilesystemStore(str(tmp_path)), device="cpu",
        max_rows_in_memory=10_000)
    called = {"stream": False}
    orig = est.fit_stream
    est.fit_stream = lambda *a, **k: called.__setitem__(
        "stream", True) or orig(*a, **k)
    est.fit(_df(64, seed=2))
    assert not called["stream"]


def test_transform_pandas_appends_predictions(tmp_path):
    import pandas as pd

    rng = np.random.RandomState(0)
    df = pd.DataFrame({"a": rng.randn(64), "b": rng.randn(64),
                       "y": rng.randint(0, 2, 64)})
    model = tspark.ParamsEstimator(
        model=TMLP(features=(), num_classes=2, in_features=2, device="cpu"),
        optimizer=topt.sgd(1e-2), loss="auto", feature_cols=["a", "b"],
        label_cols=["y"], batch_size=16, epochs=1, run_id="tr",
        store=tspark.FilesystemStore(str(tmp_path)), device="cpu").fit(df)
    out = model.transform(df)
    assert "prediction" in out.columns and len(out) == 64
    feats = np.stack([df["a"].values, df["b"].values], axis=1)
    np.testing.assert_array_equal(np.stack(out["prediction"].values),
                                  model.transform_arrays(feats))


def test_transform_requires_feature_cols_and_fit_a_store():
    with pytest.raises(ValueError, match="feature_cols"):
        tspark.TorchModel(model=None, run_id="x").transform(object())
    est = tspark.ParamsEstimator(model=object(), optimizer=object(),
                                 loss="auto")
    with pytest.raises(ValueError, match="store"):
        est.fit(df=None)


# ---------------------------------------------------------------------------
# TorchEstimator and KerasEstimator


def _net(seed, width=32, inputs=2):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(inputs, width),
                               torch.nn.ReLU(), torch.nn.Linear(width, 2))


def test_torch_estimator_bit_for_bit_the_references(tmp_path):
    x, y = _xor(seed=1)
    out = {}
    for side, mod in (("ref", jspark), ("port", tspark)):
        net = _net(0)
        kw = {"device": "cpu"} if side == "port" else {}
        store = mod.FilesystemStore(str(tmp_path / side))
        model = mod.TorchEstimator(
            model=net, optimizer=torch.optim.Adam(net.parameters(), lr=1e-2),
            loss="auto", batch_size=64, epochs=6, store=store,
            run_id="torch1", **kw).fit_arrays(x, y)
        out[side] = (model, store)
    got, want = out["port"][0], out["ref"][0]
    assert got.history["loss"] == want.history["loss"]
    for (k, a), (_, b) in zip(got.model.state_dict().items(),
                              want.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert got.history["loss"][-1] < got.history["loss"][0]
    again = tspark.TorchModel.load(out["port"][1], "torch1", model=_net(5))
    np.testing.assert_array_equal(again.transform_arrays(x[:8]),
                                  got.transform_arrays(x[:8]))


def test_torch_fit_df_best_reload_the_references(tmp_path):
    df = _df(300)
    out = {}
    for side, mod in (("ref", jspark), ("port", tspark)):
        kw = {"device": "cpu"} if side == "port" else {}
        store = mod.FilesystemStore(str(tmp_path / side))
        est = mod.TorchEstimator(
            model=_net(1, 16, 4), optimizer=None, loss="auto",
            feature_cols=FEATS, label_cols=["label"], batch_size=32,
            epochs=5, store=store, run_id="trun", validation=0.25, **kw)
        est.optimizer = torch.optim.Adam(est.model.parameters(), lr=1e-2)
        out[side] = (est.fit(df), store)
    got, store = out["port"]
    for key in ("loss", "val_loss"):
        assert got.history[key] == out["ref"][0].history[key]
    assert store.exists(store.get_epoch_checkpoint_path("trun", 4))
    best = int(np.argmin(got.history["val_loss"]))
    ckpt = torch.load(store.get_checkpoint_path("trun"))
    epoch = torch.load(store.get_epoch_checkpoint_path("trun", best))
    assert all(torch.equal(ckpt[k], epoch[k]) for k in ckpt)
    x = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    assert got.transform_arrays(x).shape == (10, 2)


def test_keras_estimator_matches_the_references_in_spawned_processes(
        tmp_path):
    """The reference's TestKerasEstimator (arrays, reload, fit(df) with
    best reload) on both sides, each in a process of its own (TensorFlow
    is never imported by a test worker)."""
    import json

    env = dict(os.environ, JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="3",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([R.REPO, TESTS]))
    procs = {side: subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_spark_ranks.py"),
         "keras_fit", side, str(tmp_path), str(tmp_path / f"{side}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for side in ("ref", "port")}
    outs = {side: p.communicate(timeout=240)[0].decode(errors="replace")
            for side, p in procs.items()}
    for side, p in procs.items():
        assert p.returncode == 0, outs[side][-3000:]
    got, want = (json.loads((tmp_path / f"{s}.json").read_text())
                 for s in ("port", "ref"))
    for key in ("loss", "df_loss", "df_val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["preds"], want["preds"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["reloaded"], got["preds"], rtol=1e-5,
                               atol=1e-6)
    assert got["loss"][-1] < got["loss"][0]
    assert got["best_reloaded"] and want["best_reloaded"]


# ---------------------------------------------------------------------------
# Distributed: a two-rank fit on a gloo world


def _ref_two_rank_world(kind, workdir):
    """The JAX package's two-rank fit (``R.ref_two_rank_fit``) on its own
    native world of 2, one process a rank, started and not waited for."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               HVT_SIZE="2", HVT_COORD_PORT=str(port),
               PYTHONPATH=os.pathsep.join([R.REPO, TESTS]))
    outs = [os.path.join(workdir, f"rank{r}.pkl") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_spark_ranks.py"),
         "ref_two_rank_fit", kind, workdir, outs[r]],
        env=dict(env, HVT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    return procs, outs


@pytest.mark.parametrize("kind", ["torch", "params"])
def test_two_rank_fit_reads_disjoint_shards(tmp_path, kind):
    """Twin of TestDistributedShardFit: each rank reads its own shard
    files, the replicas start from rank 0's broadcast, the gradients are
    averaged over the runtime and the best epoch is chosen from the
    ranks' mean validation loss; the replicas end identical (bit for
    bit). Held against the JAX package's estimator on its own native
    world of 2 with the same frame, seeds, shards and optimizer, at the
    tolerances of world 1: the TorchEstimator bit for bit, the
    parameter-dict estimator against ``FlaxEstimator`` (the same Flax
    init carried across) 1e-5 on every epoch loss and on the final
    parameters."""
    import pickle

    start = None
    if kind == "params":
        init = JMLP(features=(8,), num_classes=2).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.float32))
        start = convert.mlp_params_from_flax(_tree_np(init))
    procs, paths = _ref_two_rank_world(kind, str(tmp_path / "ref"))
    try:
        a, b = context.spawn_gloo(2, R.two_rank_fit, str(tmp_path / "port"),
                                  kind, start)
    finally:
        logs = [p.communicate(timeout=240)[0].decode(errors="replace")
                for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert (a["rank"], b["rank"]) == (0, 1)
    assert a["rows"] + b["rows"] == 150 and a["rows"] > 0 and b["rows"] > 0
    seen = [a["f0"], b["f0"], a["val_f0"], b["val_f0"]]
    assert sum(map(len, seen)) == len(set().union(*seen)) == 200
    np.testing.assert_array_equal(np.sort(sum(seen, [])),
                                  np.sort(R.features_df()["f0"].to_numpy()))
    assert sorted(a["params"]) == sorted(b["params"])
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    assert len(a["history"]["loss"]) == len(b["history"]["loss"]) == 6
    assert a["history"]["loss"] != b["history"]["loss"]  # each its shard's

    for got, path in zip((a, b), paths):
        with open(path, "rb") as f:
            want = pickle.load(f)
        assert want["rank"] == got["rank"]
        for key in ("loss", "val_loss"):
            if kind == "torch":
                assert got["history"][key] == want["history"][key], key
            else:
                np.testing.assert_allclose(
                    got["history"][key], want["history"][key], rtol=1e-5,
                    atol=1e-6, err_msg=key)
        ref = (want["params"] if kind == "torch"
               else convert.mlp_params_from_flax(want["params"]))
        assert sorted(ref) == sorted(got["params"])
        for k, v in ref.items():
            if kind == "torch":
                assert torch.equal(got["params"][k], torch.from_numpy(v)), k
            else:
                np.testing.assert_allclose(got["params"][k].numpy(),
                                           np.asarray(v), atol=1e-5, rtol=0,
                                           err_msg=k)


# ---------------------------------------------------------------------------
# spark.run under a fake pyspark (the reference's test_spark.py:331-426)


def _install_fake_pyspark(monkeypatch, num_tasks=2):
    """A minimal pyspark with Spark's documented barrier-mode semantics:
    every barrier task runs concurrently, ``allGather`` exchanges across
    ALL tasks, and any task failure aborts the stage."""
    barrier = threading.Barrier(num_tasks)
    gathered = {}
    tls = threading.local()

    class FakeBarrierTaskContext:
        def __init__(self, idx):
            self._idx = idx

        @staticmethod
        def get():
            return tls.ctx

        def partitionId(self):  # noqa: N802 (pyspark casing)
            return self._idx

        def allGather(self, value):  # noqa: N802
            gathered[self._idx] = value
            barrier.wait(timeout=30)
            out = [gathered[i] for i in range(num_tasks)]
            barrier.wait(timeout=30)
            return out

        def barrier(self):
            barrier.wait(timeout=30)

    class _Broadcast:
        def __init__(self, v):
            self.value = v

    class _Stage:
        def __init__(self, n):
            self._n = n
            self._fn = None

        def barrier(self):
            return self

        def mapPartitions(self, fn):  # noqa: N802
            self._fn = fn
            return self

        def collect(self):
            results, errors = [], []

            def _run(i):
                tls.ctx = FakeBarrierTaskContext(i)
                try:
                    results.extend(self._fn(iter([i])))
                except BaseException as exc:  # noqa: BLE001
                    errors.append(exc)
                    barrier.abort()

            threads = [threading.Thread(target=_run, args=(i,))
                       for i in range(self._n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            if errors:
                raise RuntimeError("barrier stage failed") from errors[0]
            return results

    class FakeSparkContext:
        defaultParallelism = num_tasks

        @staticmethod
        def getOrCreate():
            return FakeSparkContext()

        def broadcast(self, v):
            return _Broadcast(v)

        def parallelize(self, rng, n):
            return _Stage(n)

    mod = types.ModuleType("pyspark")
    mod.BarrierTaskContext = FakeBarrierTaskContext
    mod.SparkContext = FakeSparkContext
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    return mod


@pytest.fixture
def saved_environ():
    # The fake runs every task in this process: roll its env updates back.
    saved = os.environ.copy()
    yield
    os.environ.clear()
    os.environ.update(saved)


def test_run_barrier_contract(monkeypatch, saved_environ):
    """run() derives each task's launcher env from the barrier allGather
    and returns rank-ordered results (reference :450); the env is the
    port launcher's slot block, the JAX package's HVT_* for its twin."""
    _install_fake_pyspark(monkeypatch, num_tasks=2)

    def fn():
        e = os.environ
        return (int(e["WORLD_SIZE"]), int(e["LOCAL_WORLD_SIZE"]),
                int(e["HVDTPU_NUM_PROCESSES"]), e["HVDTPU_RENDEZVOUS_PORT"])

    results = tspark.run(fn, num_proc=2)
    assert len(results) == 2
    assert all(r[:3] == (2, 2, 2) and int(r[3]) > 0 for r in results)
    want = jspark.run(lambda: int(os.environ["HVT_SIZE"]), num_proc=2)
    assert [r[0] for r in results] == want


def test_run_barrier_failure_propagates(monkeypatch, saved_environ):
    _install_fake_pyspark(monkeypatch, num_tasks=2)
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("task exploded")
        return "ok"

    with pytest.raises(RuntimeError, match="barrier stage failed"):
        tspark.run(fn, num_proc=2)


def test_run_requires_pyspark():
    try:
        import pyspark  # noqa: F401

        pytest.skip("pyspark installed")
    except ImportError:
        pass
    for run in (tspark.run, tspark.run_elastic):
        with pytest.raises(ImportError, match="pyspark"):
            run(lambda: 0)


# ---------------------------------------------------------------------------
# The new packages import bare


BLOCKED = ("jax", "jaxlib", "flax", "optax", "horovod_tpu", "pyspark", "ray",
           "mxnet", "pandas", "pyarrow", "fsspec", "tensorflow", "keras")


def test_modules_import_without_jax_or_optional_packages():
    """In a fresh interpreter where JAX, the JAX package and every
    optional package are unimportable, the new modules import and pull
    none of them in."""
    code = f"""
import sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import horovod_tpu_torch.spark, horovod_tpu_torch.spark.util
import horovod_tpu_torch.spark.estimator, horovod_tpu_torch.spark.runner
import horovod_tpu_torch.ray, horovod_tpu_torch.mxnet
import horovod_tpu_torch.tools.comm_audit
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=R.REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]


def test_the_rank_module_imports_no_jax():
    """A spawned rank imports the module its function lives in: the rank
    module must not pull JAX (or the JAX package) into every rank."""
    code = ("import sys; import torch_spark_ranks; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu')]; "
            "assert not bad, bad; print('OK')")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([R.REPO, TESTS]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]
