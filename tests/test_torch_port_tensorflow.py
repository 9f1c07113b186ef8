"""The port's TensorFlow frontend (``horovod_tpu_torch.tensorflow``, on the
port's runtime) against the JAX package's (``horovod_tpu.tensorflow``, on
its native runtime).

Twins of ``tests/test_tensorflow.py`` and ``tests/test_frontends.py``.
Every scenario runs on both sides with the same seeded inputs, in the
worlds of ``tests/torch_tf_ranks.py`` (one of 1 and one of 2 processes a
side, started once a session for this file and
``test_torch_port_keras.py`` together: importing TF takes ~15 s a
process). The outputs are held equal bit for bit -- values, dtypes and
shapes -- at both world sizes: the bridges are the same numpy round trip,
and a sum of two fp32 values or a scale by 0.5 rounds alike on gloo and on
the JAX package's ring. The reference's own expectations (the sync batch
norm against numpy within 1e-4, the ranks' weights alike) are checked on
the port's side too. Without TensorFlow the world tests skip; the gating
tests run in subprocesses that block TF and Keras.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_eager_ranks as E
import torch_tf_ranks as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tf_worlds(tmp_path_factory):
    pytest.importorskip("tensorflow")
    pytest.importorskip("keras")
    return E.shared(tmp_path_factory, "tf_worlds", lambda: T.run_worlds(
        [("port", 1), ("ref", 1), ("port", 2), ("ref", 2)]))


def assert_same(port, ref, where):
    """Equal bit for bit: arrays by dtype, shape and value (NaN in the same
    places), containers element by element, anything else by ``==``."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (where, set(port) ^ set(ref))
        for k in ref:
            if k != "_seconds":
                assert_same(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref), where
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_same(p, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), where
        assert (port.dtype, port.shape) == (ref.dtype, ref.shape), (
            where, port.dtype, ref.dtype, port.shape, ref.shape)
        np.testing.assert_array_equal(port, ref, err_msg=where)
    else:
        assert port == ref, (where, port, ref)


def _case(worlds, size, case):
    return [(w[case], r[case]) for w, r in zip(worlds[("port", size)],
                                               worlds[("ref", size)])]


TF_CASES_1 = ["w_eager_dtypes", "w_compression_and_groups", "w_graph_mode",
              "w_tape_and_optimizer", "w_objects", "w_sync_bn"]
TF_CASES_2 = ["x_collectives", "x_train_step", "x_sync_bn"]


@pytest.mark.parametrize("case", TF_CASES_1)
def test_world_of_one_matches_the_reference(tf_worlds, case):
    [(port, ref)] = _case(tf_worlds, 1, case)
    assert_same(port, ref, case)


@pytest.mark.parametrize("case", TF_CASES_2)
def test_world_of_two_matches_the_reference(tf_worlds, case):
    for rank, (port, ref) in enumerate(_case(tf_worlds, 2, case)):
        assert_same(port, ref, f"rank {rank} {case}")


def _port(worlds, size, case):
    return [w[case] for w in worlds[("port", size)]]


def test_eager_collectives_keep_dtypes_and_values(tf_worlds):
    [r] = _port(tf_worlds, 1, "w_eager_dtypes")
    for dt in T.DTYPES:
        x = T._values(0, dt, salt=1)
        assert r[f"{dt}.dtype"] == dt
        np.testing.assert_allclose(r[f"{dt}.avg"], x.astype(dt),
                                   rtol=1e-2 if dt in ("float16", "bfloat16")
                                   else 0)
        assert r[f"{dt}.gather"].shape == (3, 4)
    assert r["scalar.shape"] == ()


def test_tape_optimizer_and_variables(tf_worlds):
    [r] = _port(tf_worlds, 1, "w_tape_and_optimizer")
    np.testing.assert_array_equal(r["gx"], [3.0, 6.0])
    assert r["gu_none"]
    np.testing.assert_array_equal(r["var"], [0.5, 0.0])
    np.testing.assert_array_equal(r["var2"], [2.0])
    assert r["opt_class"] == "DistributedSGD"
    assert r["scalar_var"] == ((), 3)


def test_graph_mode_alltoall_and_scalar_ops(tf_worlds):
    [r] = _port(tf_worlds, 1, "w_graph_mode")
    np.testing.assert_array_equal(r["a2a"], [1.0, 2.0, 3.0])
    assert r["recv"].tolist() == [3] and r["recv_split"].tolist() == [3]
    np.testing.assert_array_equal(r["ar"], [2.0, 4.0, 6.0])
    assert r["ops"] == 1 and r["local"] == (1, 0)


def test_objects_at_world_one(tf_worlds):
    [r] = _port(tf_worlds, 1, "w_objects")
    assert r["bcast"]["epoch"] == 3 and r["bcast"]["names"] == ["a", "b"]
    np.testing.assert_array_equal(r["bcast"]["arr"], np.arange(4))
    assert r["fn"] == 42 and r["gather"] == [{"rank": 0}]
    assert r["rank_size"] == (0, 1, 0, 1) and r["initialized"]
    assert r["timeline"] and r["join"] == 0


def test_world_of_two_collectives(tf_worlds):
    r0, r1 = _port(tf_worlds, 2, "x_collectives")
    for r in (r0, r1):
        np.testing.assert_array_equal(r["avg"], np.full(4, 1.5, np.float32))
        np.testing.assert_array_equal(r["bcast"], [1.0, 1.0])
        assert r["gather"].tolist() == [[0, 0], [1, 1], [1, 1]]
        assert r["objects"] == [{"rank": 0}, {"rank": 1}]
        assert r["bobj"] == {"from": 1} and r["join_in_world"]
    np.testing.assert_array_equal(r0["random_avg"], r1["random_avg"])
    assert r0["a2a"].tolist() == [0, 10, 11] and r0["a2a_recv"].tolist() \
        == [1, 2]
    assert r1["a2a"].tolist() == [1, 2, 12] and r1["a2a_recv"].tolist() \
        == [2, 1]


def test_tf_function_training_keeps_the_ranks_alike(tf_worlds):
    r0, r1 = _port(tf_worlds, 2, "x_train_step")
    for w0, w1 in zip(r0["weights"], r1["weights"]):
        np.testing.assert_array_equal(w0, w1)
    assert r0["losses"][-1] < r0["losses"][0]
    assert r0["losses"] != r1["losses"]  # each rank's own data


def test_sync_batch_norm_uses_global_moments(tf_worlds):
    x_all = np.arange(16, dtype=np.float32).reshape(8, 2)
    mean, var = x_all.mean(axis=0), x_all.var(axis=0)
    for rank, r in enumerate(_port(tf_worlds, 2, "x_sync_bn")):
        mine = x_all[rank * 4:(rank + 1) * 4]
        np.testing.assert_allclose(r["y"], (mine - mean) / np.sqrt(var + 1e-3),
                                   atol=1e-4)
        np.testing.assert_allclose(r["moving_mean"], 0.5 * mean, atol=1e-4)
        assert r["grad"].shape == (4, 3) and np.all(np.isfinite(r["grad"]))
    [w1] = _port(tf_worlds, 1, "w_sync_bn")
    np.testing.assert_array_equal(w1["sync"], w1["plain"])


_BLOCKED = (
    "import sys\n"
    "for m in ('tensorflow', 'keras'):\n"
    "    sys.modules[m] = None\n"
)


def _blocked(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKED + code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.strip().splitlines()


def test_modules_import_without_tensorflow_or_keras():
    lines = _blocked(
        "import horovod_tpu_torch.tensorflow as t\n"
        "import horovod_tpu_torch.tensorflow.elastic\n"
        "import horovod_tpu_torch.tensorflow.sync_batch_norm\n"
        "import horovod_tpu_torch.keras as k\n"
        "import horovod_tpu_torch.keras.callbacks\n"
        "import horovod_tpu_torch.keras.elastic\n"
        "print(sorted(m for m in sys.modules if m.startswith(('jax', "
        "'horovod_tpu.'))) or 'clean')\n"
        "print(k.WarmupSchedule(2, steps_per_epoch=10, world_size=8)"
        ".multiplier(1, 5))\n")
    assert lines == ["clean", str(0.125 * (0.75 * 7 + 1))]


def test_gating_messages_match_the_reference():
    code = (
        "import numpy as np\n"
        "def msg(fn):\n"
        "    try:\n"
        "        fn()\n"
        "    except ImportError as e:\n"
        "        return str(e)\n"
        "    return 'no error'\n"
        "for pkg in ('horovod_tpu_torch', 'horovod_tpu'):\n"
        "    import importlib\n"
        "    t = importlib.import_module(pkg + '.tensorflow')\n"
        "    k = importlib.import_module(pkg + '.keras')\n"
        "    print(msg(lambda: t.allreduce(np.ones(3))).replace(pkg, 'P'))\n"
        "    print(msg(lambda: k.MetricAverageCallback()))\n"
        "    print(msg(lambda: t.SyncBatchNormalization).replace(pkg, 'P'))\n"
        "    print(msg(lambda: importlib.import_module(\n"
        "        pkg + '.keras.elastic').CommitStateCallback))\n")
    lines = _blocked(code)
    port, ref = lines[:4], lines[4:]
    assert port[0].startswith(
        "P.tensorflow requires the 'tensorflow' package; ")
    assert ref[0].startswith(
        "P.tensorflow requires the 'tensorflow' package; ")
    assert port[1:] == ref[1:], (port, ref)
    assert port[2] == "P.tensorflow.SyncBatchNormalization requires keras"


def test_process_api_requires_init():
    from horovod_tpu_torch import tensorflow as hvd_tf
    from horovod_tpu_torch.exceptions import HorovodInternalError

    if not hvd_tf.is_initialized():
        with pytest.raises(HorovodInternalError):
            hvd_tf.rank()
        with pytest.raises(HorovodInternalError):
            hvd_tf.size()


def test_local_rank_and_size_read_the_launcher_env(monkeypatch):
    from horovod_tpu_torch import tensorflow as hvd_tf

    monkeypatch.setenv("HVT_LOCAL_RANK", "3")
    monkeypatch.setenv("HVT_LOCAL_SIZE", "4")
    assert (hvd_tf.local_rank(), hvd_tf.local_size()) == (3, 4)
