"""Run port jobs on Spark executors.

The port of the JAX package's ``horovod_tpu/spark/runner.py``. Parity:
``horovod/spark/runner.py`` — ``run`` (``:195``) executes a training
function on ``num_proc`` Spark tasks that together form one world, each
task one port rank; ``run_elastic`` (``:303``) wraps it in the elastic
restart loop. The reference's mechanics (barrier-stage mapPartitions,
driver-side rendezvous service, rank assignment from task placement) are
kept; each task's environment is the one the port's launcher gives a slot
(``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` and the
``HVDTPU_*`` block, from :meth:`..ray.runner.Coordinator.
finalize_registration`), so ``horovod_tpu_torch.init`` and
``native.init`` form the world over the driver's rendezvous KV.

Everything Spark-specific is inside ``run``/``run_elastic`` so the module
imports without pyspark (estimators/stores are independent).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

from ..ray.runner import Coordinator  # cluster-neutral rank/rendezvous logic

log = logging.getLogger(__name__)


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark.run requires the 'pyspark' package"
        ) from e


def run(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[Dict] = None,
    num_proc: Optional[int] = None,
    extra_env: Optional[Dict[str, str]] = None,
    verbose: int = 1,
) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` as a port world on Spark executors;
    returns per-rank results in rank order (reference
    ``runner.py:195-301``)."""
    _require_pyspark()
    from pyspark import BarrierTaskContext, SparkContext

    sc = SparkContext.getOrCreate()
    if num_proc is None:
        num_proc = sc.defaultParallelism
    kwargs = kwargs or {}

    # The driver only hosts the rendezvous KV; rank topology is derived
    # INSIDE the barrier stage from the actual task placements
    # (``BarrierTaskContext.allGather`` of hostnames), so env always
    # matches where the training tasks really run — the reference gets
    # the same guarantee from its task-service registration
    # (``_notify_and_register_task_addresses``, ``runner.py:162-193``).
    coordinator = Coordinator()
    rendezvous_env = coordinator.establish_rendezvous()
    base_env = sc.broadcast({**(extra_env or {}), **rendezvous_env})

    def _task(iterator):
        import os
        import socket as pysocket

        from horovod_tpu_torch.ray.runner import Coordinator as TaskCoordinator

        ctx = BarrierTaskContext.get()
        index = ctx.partitionId()
        hostnames = ctx.allGather(pysocket.gethostname())
        local = TaskCoordinator()
        for r, h in enumerate(hostnames):
            local.register(h, r)
        env = local.finalize_registration()[index]
        os.environ.update(base_env.value)
        os.environ.update(env)
        ctx.barrier()
        result = fn(*args, **kwargs)
        # Keyed by the assigned RANK, not the partition index:
        # finalize_registration groups ranks by host, so the two differ
        # when task placement interleaves hosts.
        yield (int(env["RANK"]), result)

    try:
        results = (
            sc.parallelize(range(num_proc), num_proc)
            .barrier()
            .mapPartitions(_task)
            .collect()
        )
    finally:
        coordinator.shutdown()
    return [r for _, r in sorted(results)]


def run_elastic(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[Dict] = None,
    num_proc: Optional[int] = None,
    min_np: int = 1,
    max_np: Optional[int] = None,
    reset_limit: Optional[int] = None,
    **run_kwargs,
) -> List[Any]:
    """Elastic variant (reference ``runner.py:303``): retry ``run`` with
    refreshed executor membership on failure, bounded by ``reset_limit``."""
    _require_pyspark()
    resets = 0
    while True:
        try:
            return run(fn, args, kwargs, num_proc=num_proc, **run_kwargs)
        except Exception as e:
            resets += 1
            log.warning("elastic spark generation failed: %s", e)
            if reset_limit is not None and resets >= reset_limit:
                raise
