"""Rank functions of the telemetry tests' gloo worlds (spawned processes
import this module by name; it imports no JAX, so a world starts fast)."""

import torch

from horovod_tpu_torch import context
from horovod_tpu_torch.obs import export as _export
from horovod_tpu_torch.obs import registry as _obs
from horovod_tpu_torch.parallel import dp


def summary_lockstep(steps: int):
    """An instrumented step on a world of 2 (the metrics plane armed by the
    parent's environment): the step counts at which this rank joined the
    rank-0 summary, and its registry's step count."""
    torch.manual_seed(0)
    w = torch.randn(4, 2)

    def loss_fn(p, batch):
        x, y = batch
        return ((x @ p["w"] - y) ** 2).mean()

    def sgd(lr):
        from horovod_tpu_torch.optimizer import Optimizer

        def update(g, s, p=None):
            return {k: -lr * v for k, v in g.items()}, s
        return Optimizer(lambda p: (), update)

    step, opt = dp.make_train_step(loss_fn, sgd(0.01), device="cpu",
                                   tokens_per_step=16)
    state = dp.init_state({"w": w.clone()}, opt)
    rank = context.rank()
    batch = (torch.ones(8, 4) * (rank + 1), torch.zeros(8, 2))
    for _ in range(steps):
        state, _ = step(state, batch)
    snap = _obs.metrics().snapshot()
    return {
        "enabled": _obs.enabled(),
        "summary_steps": list(_export.reporter().summary_steps),
        "count": snap["counters"].get("step.count"),
        "w": state.params["w"].detach().clone(),
    }
