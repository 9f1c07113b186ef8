"""Synchronous batch normalization for the TF / Keras frontend.

The port of the JAX package's ``tensorflow/sync_batch_norm.py`` (parity:
``horovod/tensorflow/sync_batch_norm.py:22``): ``SyncBatchNormalization``
averages the batch statistics across every rank each step, so the layer
normalizes as if the global batch were on one device.

Keras 3's ``BatchNormalization`` computes the local moments in
``_moments``; the subclass averages E[x] and E[x^2] there across ranks
(equal batches a rank, as the reference assumes) and rebuilds the
variance. The allreduce is the frontend's differentiable one, so
gradients flow across ranks in eager tapes and ``tf.function`` alike.

Keras is imported when the class is first asked for (this module's
``__getattr__``), never at import.
"""

from __future__ import annotations

_classes: dict = {}


def _keras_bn():
    try:
        import keras

        return keras.layers.BatchNormalization
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.tensorflow.SyncBatchNormalization requires "
            "keras"
        ) from e


def _build():
    from . import Average, allreduce, size

    class SyncBatchNormalization(_keras_bn()):
        """Drop-in ``BatchNormalization`` with cross-rank batch
        statistics."""

        def _moments(self, inputs, mask):
            mean, variance = super()._moments(inputs, mask)
            if size() <= 1:
                return mean, variance
            # var = E[x^2] - E[x]^2, both expectations averaged globally.
            mean_sq = variance + mean * mean
            global_mean = allreduce(
                mean, op=Average, name=f"syncbn.{self.name}.mean")
            global_mean_sq = allreduce(
                mean_sq, op=Average, name=f"syncbn.{self.name}.meansq")
            return global_mean, global_mean_sq - global_mean * global_mean

    SyncBatchNormalization.__module__ = __name__
    return SyncBatchNormalization


def __getattr__(name):
    if name == "SyncBatchNormalization":
        if name not in _classes:
            _classes[name] = _build()
        return _classes[name]
    raise AttributeError(name)
