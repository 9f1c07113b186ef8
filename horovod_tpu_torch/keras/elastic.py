"""Keras elastic-training callbacks.

The port of the JAX package's ``horovod_tpu/keras/elastic.py`` (parity:
``horovod/_keras/elastic.py``, ``horovod/tensorflow/keras/elastic.py``):
the three callbacks a ``model.fit`` inside an ``@hvd.elastic.run``
function takes, so Keras training commits its state and resumes mid-epoch
after a world change:

* ``CommitStateCallback`` -- ``state.commit()`` every
  ``batches_per_commit`` batches and at every epoch's end (where
  ``HostsUpdatedInterrupt`` fires under the elastic launcher);
* ``UpdateBatchStateCallback`` -- tracks ``state.batch`` and trims a
  resumed epoch to the steps it has left;
* ``UpdateEpochStateCallback`` -- tracks ``state.epoch``, so a restart
  resumes at the right epoch.

Written against Keras 3's ``keras.callbacks.Callback``; each class is
built when first asked for (this module's ``__getattr__``), so the module
imports without Keras.
"""

from __future__ import annotations

_classes: dict = {}


def _callback_base():
    try:
        import keras

        return keras.callbacks.Callback
    except ImportError as e:
        raise ImportError("keras elastic callbacks require keras") from e


def _build_commit(Base):
    class CommitStateCallback(Base):
        """Commit the elastic state periodically (reference
        ``CommitStateCallbackImpl``)."""

        def __init__(self, state, batches_per_commit: int = 1):
            super().__init__()
            self.state = state
            self.batches_per_commit = batches_per_commit
            self.batches_remaining = batches_per_commit

        def on_train_begin(self, logs=None):
            # Reset on every (re)start, so the ranks' commits line up.
            self.batches_remaining = self.batches_per_commit

        def on_train_batch_end(self, batch, logs=None):
            self.batches_remaining -= 1
            if self.batches_remaining == 0:
                self.state.commit()
                self.batches_remaining = self.batches_per_commit

        def on_epoch_end(self, epoch, logs=None):
            self.state.commit()

    return CommitStateCallback


def _build_batch(Base):
    class UpdateBatchStateCallback(Base):
        """Track ``state.batch``; resume a restarted epoch at the right
        step (reference ``UpdateBatchStateCallbackImpl``)."""

        def __init__(self, state):
            super().__init__()
            self.state = state
            self.steps_per_epoch = None
            self._resume_offset = 0

        def on_train_begin(self, logs=None):
            self.steps_per_epoch = None

        def on_epoch_begin(self, epoch, logs=None):
            # Keras numbers a resumed epoch's batches from 0, so the
            # committed progress becomes an offset: without it a second
            # interruption in the same epoch would replay trained batches.
            self._resume_offset = self.state.batch
            if self.params and self.params.get("steps"):
                if self.steps_per_epoch is None:
                    self.steps_per_epoch = self.params.get("steps")
                # Trim the resumed epoch to the batches not yet trained.
                self.params["steps"] = self.steps_per_epoch - self.state.batch

        def on_train_batch_end(self, batch, logs=None):
            # batch counts from 0: batch + 1 batches of this run are done.
            self.state.batch = self._resume_offset + batch + 1

        def on_epoch_end(self, epoch, logs=None):
            self.state.batch = 0
            self._resume_offset = 0
            if (self.params and self.params.get("steps")
                    and self.steps_per_epoch is not None):
                self.params["steps"] = self.steps_per_epoch

    return UpdateBatchStateCallback


def _build_epoch(Base):
    class UpdateEpochStateCallback(Base):
        """Track ``state.epoch`` across restarts (reference
        ``UpdateEpochStateCallbackImpl``)."""

        def __init__(self, state):
            super().__init__()
            self.state = state

        def on_epoch_end(self, epoch, logs=None):
            self.state.epoch = epoch + 1

    return UpdateEpochStateCallback


_BUILDERS = {
    "CommitStateCallback": _build_commit,
    "UpdateBatchStateCallback": _build_batch,
    "UpdateEpochStateCallback": _build_epoch,
}


def __getattr__(name):
    build = _BUILDERS.get(name)
    if build is None:
        raise AttributeError(name)
    if name not in _classes:
        cls = build(_callback_base())
        cls.__module__ = __name__
        _classes[name] = cls
    return _classes[name]
