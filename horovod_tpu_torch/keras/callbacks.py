"""Keras training callbacks (parity: ``horovod/_keras/callbacks.py``).

The port of the JAX package's ``horovod_tpu/keras/callbacks.py``. The
schedule math (the warmup ramp, epoch-indexed multipliers) needs no
framework, so it is testable without Keras; the metric average rides the
runtime (:mod:`horovod_tpu_torch.native`) as a CPU tensor; the callback
classes bind to ``keras.callbacks.Callback`` when built.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native


class WarmupSchedule:
    """The warmup multiplier (reference ``LearningRateWarmupCallbackImpl``,
    ``callbacks.py:172``): ramp the LR from ``initial_lr / size`` to
    ``initial_lr`` over ``warmup_epochs``, interpolating by batch."""

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 world_size: Optional[int] = None):
        self.warmup_epochs = warmup_epochs
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.world_size = (world_size if world_size is not None
                           else max(native.size(), 1))

    def multiplier(self, epoch: int, batch: int) -> float:
        if self.warmup_epochs <= 0 or epoch >= self.warmup_epochs:
            return 1.0
        spe = self.steps_per_epoch or 1
        progress = (epoch * spe + min(batch, spe)) / float(
            self.warmup_epochs * spe
        )
        # Linear from 1/size to 1 (Goyal et al.'s warmup, in the
        # reference's 1/size * (progress * (size - 1) + 1) form).
        return (progress * (self.world_size - 1) + 1.0) / self.world_size


class PiecewiseSchedule:
    """Epoch -> multiplier table (reference
    ``LearningRateScheduleCallbackImpl``, ``callbacks.py:89``)."""

    def __init__(self, schedule: List[Tuple[int, float]],
                 staircase: bool = True):
        # schedule: [(start_epoch, multiplier)], sorted here
        self.schedule = sorted(schedule)
        self.staircase = staircase

    def multiplier(self, epoch: int) -> float:
        mult = 1.0
        for start, m in self.schedule:
            if epoch >= start:
                mult = m
        return mult


def average_metrics(logs: Dict[str, float],
                    prefix: str = "") -> Dict[str, float]:
    """Average scalar metrics across ranks with the runtime's allreduce
    (reference ``MetricAverageCallbackImpl``, ``callbacks.py:48``)."""
    out = dict(logs)
    for k in sorted(logs):
        v = logs[k]
        if isinstance(v, (int, float, np.floating, np.integer)):
            red = native.allreduce(
                torch.tensor([float(v)], dtype=torch.float64),
                op=native.SUM, name=f"metric.{prefix}{k}")
            out[k] = float(red[0]) / max(native.size(), 1)
    return out


def _keras_callback_base():
    try:
        import keras

        return keras.callbacks.Callback
    except ImportError:
        try:
            from tensorflow import keras  # type: ignore

            return keras.callbacks.Callback
        except ImportError as e:
            raise ImportError(
                "keras callbacks require the 'keras' or 'tensorflow' package"
            ) from e


def BroadcastGlobalVariablesCallback(root_rank: int = 0):
    """Broadcast the model's and the optimizer's variables from
    ``root_rank`` after the first batch (reference ``callbacks.py:22``)."""
    Base = _keras_callback_base()

    class _Callback(Base):
        def __init__(self):
            super().__init__()
            self.root_rank = root_rank
            self.broadcast_done = False

        def on_batch_end(self, batch, logs=None):
            if self.broadcast_done:
                return
            from ..tensorflow import broadcast_variables

            broadcast_variables(self.model.variables, self.root_rank)
            if getattr(self.model, "optimizer", None) is not None:
                broadcast_variables(
                    self.model.optimizer.variables, self.root_rank
                )
            self.broadcast_done = True

    return _Callback()


def MetricAverageCallback():
    """Average the epoch's metrics across ranks (reference
    ``callbacks.py:48``)."""
    Base = _keras_callback_base()

    class _Callback(Base):
        def on_epoch_end(self, epoch, logs=None):
            if logs:
                logs.update(average_metrics(logs, prefix=f"ep{epoch}."))

    return _Callback()


def LearningRateWarmupCallback(initial_lr: float, warmup_epochs: int = 5,
                               steps_per_epoch: Optional[int] = None,
                               verbose: int = 0):
    """The LR warmup, batch by batch (reference ``callbacks.py:172``)."""
    Base = _keras_callback_base()

    class _Callback(Base):
        def __init__(self):
            super().__init__()
            self.schedule = WarmupSchedule(
                warmup_epochs=warmup_epochs, steps_per_epoch=steps_per_epoch
            )
            self.current_epoch = 0

        def on_epoch_begin(self, epoch, logs=None):
            self.current_epoch = epoch
            if self.schedule.steps_per_epoch is None and self.params:
                self.schedule.steps_per_epoch = self.params.get("steps")

        def on_batch_begin(self, batch, logs=None):
            m = self.schedule.multiplier(self.current_epoch, batch)
            self.model.optimizer.learning_rate.assign(initial_lr * m)

    return _Callback()


def LearningRateScheduleCallback(initial_lr: float,
                                 schedule: List[Tuple[int, float]],
                                 staircase: bool = True):
    """Epoch-indexed LR multipliers (reference ``callbacks.py:89``)."""
    Base = _keras_callback_base()
    table = PiecewiseSchedule(schedule, staircase=staircase)

    class _Callback(Base):
        def on_epoch_begin(self, epoch, logs=None):
            self.model.optimizer.learning_rate.assign(
                initial_lr * table.multiplier(epoch)
            )

    return _Callback()
