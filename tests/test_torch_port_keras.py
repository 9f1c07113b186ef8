"""The port's Keras frontend (``horovod_tpu_torch.keras``) against the JAX
package's (``horovod_tpu.keras``): ``DistributedOptimizer`` training,
``load_model``, the callbacks, the schedules, the metric average, and the
elastic state and callbacks (twins of the Keras parts of
``tests/test_tensorflow.py`` and of ``tests/test_frontends.py``).

The Keras scenarios run in the TF worlds of ``tests/torch_tf_ranks.py``
(shared with ``test_torch_port_tensorflow.py``); their results are held
equal to the reference's bit for bit: a Keras ``fit`` through the
frontends' ``tf.numpy_function`` bridge sees the same values on both
sides, at one rank and at two. The schedules and the metric average need
no Keras and run here.
"""

import numpy as np
import pytest

from test_torch_port_tensorflow import (  # noqa: F401  (tf_worlds: fixture)
    _case, _port, assert_same, tf_worlds,
)

KERAS_CASES_1 = ["w_keras_fit", "w_lr_callbacks", "w_elastic",
                 "w_load_model"]
KERAS_CASES_2 = ["x_keras_fit", "x_state"]


@pytest.mark.parametrize("case", KERAS_CASES_1)
def test_world_of_one_matches_the_reference(tf_worlds, case):
    [(port, ref)] = _case(tf_worlds, 1, case)
    assert_same(port, ref, case)


@pytest.mark.parametrize("case", KERAS_CASES_2)
def test_world_of_two_matches_the_reference(tf_worlds, case):
    for rank, (port, ref) in enumerate(_case(tf_worlds, 2, case)):
        assert_same(port, ref, f"rank {rank} {case}")


def test_distributed_optimizer_trains(tf_worlds):
    [r] = _port(tf_worlds, 1, "w_keras_fit")
    assert r["opt_class"] == "DistributedAdam"
    assert r["loss"][-1] < r["loss"][0]
    [r] = _port(tf_worlds, 1, "w_load_model")
    assert "Distributed" in r["opt_class"]


def test_warmup_and_schedule_callbacks_set_the_lr(tf_worlds):
    [r] = _port(tf_worlds, 1, "w_lr_callbacks")
    warm = r["warmup"]
    assert len(warm) == 12 and warm[0] == pytest.approx(0.1)
    assert all(a < b for a, b in zip(warm[:8], warm[1:8]))
    assert warm[8:] == [pytest.approx(0.8)] * 4
    assert r["schedule"] == [pytest.approx(v) for v in
                             [1.0] * 2 + [0.1] * 2 + [0.01] * 2]
    assert r["piecewise"] == [1.0, 1.0, 0.1, 0.01]
    assert r["metrics"] == {"loss": 2.0, "acc": 0.5, "name": "not-a-number"}
    assert r["metric_cb"] == {"loss": 4.0}


def test_elastic_state_and_callbacks(tf_worlds):
    [r] = _port(tf_worlds, 1, "w_elastic")
    for a, b in zip(r["restored"], r["saved"]):
        np.testing.assert_array_equal(a, b)
    assert r["epoch"] == 10
    assert r["commits"] == [2, 3]
    assert r["trims"] == [70, 31, 35, 0, 100]
    assert r["epoch_cb"] == 5


def test_state_sync_takes_rank_zeros(tf_worlds):
    r0, r1 = _port(tf_worlds, 2, "x_state")
    for r in (r0, r1):
        assert all(np.all(w == 1.0) for w in r["synced"])
        assert all(np.all(w == 1.0) for w in r["restored"])
        assert r["epoch"] == 10 and r["restored_epoch"] == 10
    for a, b in zip(r0["opt_vars"], r1["opt_vars"]):
        np.testing.assert_array_equal(a, b)


def test_keras_fit_at_two_keeps_the_ranks_alike(tf_worlds):
    r0, r1 = _port(tf_worlds, 2, "x_keras_fit")
    for a, b in zip(r0["weights"], r1["weights"]):
        np.testing.assert_array_equal(a, b)
    # MetricAverageCallback: both ranks log the mean of their losses.
    assert r0["loss"] == r1["loss"]


def test_schedules_match_the_reference():
    from horovod_tpu.keras import callbacks as ref
    from horovod_tpu_torch.keras import callbacks as port

    for kw in ({"warmup_epochs": 2, "steps_per_epoch": 10, "world_size": 8},
               {"warmup_epochs": 0, "world_size": 4},
               {"warmup_epochs": 3, "world_size": 2}):
        p, r = port.WarmupSchedule(**kw), ref.WarmupSchedule(**kw)
        assert [p.multiplier(e, b) for e in range(5) for b in range(12)] == \
            [r.multiplier(e, b) for e in range(5) for b in range(12)]
    table = [(0, 1.0), (30, 0.1), (60, 0.01)]
    assert [port.PiecewiseSchedule(table).multiplier(e) for e in range(90)] \
        == [ref.PiecewiseSchedule(table).multiplier(e) for e in range(90)]


def test_average_metrics_on_the_runtime_matches_the_reference():
    from horovod_tpu import native as ref_native
    from horovod_tpu.keras import average_metrics as ref_avg
    from horovod_tpu_torch import native
    from horovod_tpu_torch.keras import average_metrics

    logs = {"loss": 2.0, "acc": np.float32(0.5), "n": 3, "name": "x"}
    native.init(0, 1, device="cpu")
    try:
        port = average_metrics(logs, prefix="p.")
    finally:
        native.shutdown()
    ref_native.init(0, 1)
    try:
        ref = ref_avg(logs, prefix="p.")
    finally:
        ref_native.shutdown()
    assert port == ref == {"loss": 2.0, "acc": 0.5, "n": 3.0, "name": "x"}
