"""Elastic training state: commit, restore, sync.

The port of the JAX package's ``elastic/state.py`` (after Horovod's
``State``, ``ObjectState`` and ``TorchState``): ``commit`` saves a
known-good snapshot and checks for host updates; after a failure
:func:`~.run.run` restores the last commit, and before every (re)start it
syncs the state from rank 0.

* :class:`State` -- the base: ``commit`` (with the chaos ``worker.step``
  site), ``check_host_updates`` (one object broadcast of rank 0's latest
  update timestamp, so every rank raises at the same commit),
  ``register_reset_callbacks`` and ``on_reset``. Its object broadcasts
  ride the dynamic-enqueue runtime when that runs a world of several
  processes (a worker that started only ``native.init()`` or a frontend's
  ``init()``), else the ``torch.distributed`` world's collectives.
* :class:`ObjectState` -- picklable attributes, deep-copied on save.
* :class:`TrainState` -- ``params`` and ``opt_state`` (and any other
  attributes) of a training loop. ``save`` snapshots every tensor to the
  host; a ZeRO-1 or EF-residual optimizer state is snapshotted in its
  canonical, world-size-portable form
  (:func:`~..optimizer.canonicalize_sharded_states`, a collective), and
  ``restore`` repacks it for the world of the moment
  (:func:`~..optimizer.reshard_sharded_states`), so a state committed at
  N ranks restores at M. ``restore`` writes the parameters back into the
  live tensors, so a module trained in place keeps its parameters.
  ``sync`` broadcasts the tensors from rank 0 (a sharded optimizer state
  through its canonical form: each rank then keeps its own shards) and
  the rest by pickle.

Under an elastic launcher ``reset`` re-forms the world after a membership
change or a failed collective (the reference's ``shutdown`` + ``init``):
:func:`~.worker.rejoin_world` tears it down, joins the driver's current
round and initializes it again with the previous mesh's axes, the
runtime included. In a plain
process ``reset`` keeps the live world, which an in-process restart -- a
guard escalation, a failed step -- needs unchanged. ``commit`` also
honours a pending preemption notice (the priority checkpoint) and carries
the chaos ``worker.preempt`` site.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict

import torch

from ..checkpoint import map_tensors
from ..exceptions import HostsUpdatedInterrupt
from ..functions import broadcast_object
from ..ops.collectives import broadcast
from .worker import (
    in_elastic_world,
    notification_manager,
    preempt_requested,
    run_preempt_checkpoint,
)

__all__ = ["ObjectState", "State", "TrainState"]


def _rank():
    from .. import context as _ctx
    from .. import native

    if _ctx.is_initialized():
        return _ctx.rank()
    return native.rank() if native.is_initialized() else None


def _bcast_object(obj, root_rank: int = 0, name: str = "elastic"):
    """``root_rank``'s object over whichever plane is live: the runtime's
    when it runs a world of several processes, else the ``torch.distributed``
    world's (the JAX package's ``elastic.state._bcast_object``)."""
    from .. import native

    if native.is_initialized() and native.size() > 1:
        from ..native.objects import broadcast_object as impl

        return impl(obj, root_rank=root_rank, name=name)
    return broadcast_object(obj, root_rank=root_rank)


class State:
    """Base elastic state. Subclasses implement ``save``, ``restore`` and
    ``sync``; ``commit()`` saves and checks for host updates, raising
    :class:`~..exceptions.HostsUpdatedInterrupt` when the world changed."""

    def __init__(self):
        self._host_messages: list = []
        self._reset_callbacks: list = []
        self._last_updated_timestamp = 0.0
        # Commit index: the chaos worker.step occurrence.
        self._commit_count = 0
        # Under an elastic launcher the watcher delivers the launcher's
        # membership changes to on_hosts_updated; outside one there is
        # nothing to watch.
        if notification_manager.init():
            notification_manager.register_listener(self)

    def register_reset_callbacks(self, callbacks):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp, update_res):
        self._host_messages.append((timestamp, update_res))

    def commit(self):
        """Save and check for topology updates. The chaos ``worker.step``
        site fires first: crash, hang or slow this worker at commit K, the
        boundary where a real failure costs most; ``worker.preempt``
        delivers a real SIGTERM to this process, whose grace handler owns
        the drain from there. A pending preemption notice runs the
        registered priority checkpoint after the save, before the
        host-update check can walk this worker out of the world."""
        from .. import chaos as _chaos
        from ..obs import trace as _trace

        self._commit_count += 1
        # The span a flight dump shows open when a worker dies or freezes
        # mid-commit: the chaos site (and a real wedge in save or check)
        # fires inside it.
        with _trace.span("worker.step", cat="elastic",
                         step=self._commit_count):
            if _chaos.enabled():
                rank = _rank()
                _chaos.act("worker.step", step=self._commit_count, rank=rank)
                fault = _chaos.act("worker.preempt",
                                   step=self._commit_count, rank=rank)
                if fault is not None and fault.kind == "sigterm":
                    import signal as _signal

                    os.kill(os.getpid(), _signal.SIGTERM)
                    time.sleep(0.05)  # let the handler run before the check
            self.save()
            # Live weight streaming rides the commit path: only a saved
            # state is published. Disabled, this is one module-global read.
            from ..stream import publisher as _spub

            if _spub.enabled():
                _spub.on_commit(self, self._commit_count)
            if preempt_requested():
                run_preempt_checkpoint()
            self.check_host_updates()

    def check_host_updates(self):
        """Raise :class:`HostsUpdatedInterrupt` on every rank at once when
        rank 0 has heard of a newer membership change (one object
        broadcast of its latest timestamp)."""
        from .worker import joined_ts

        local_ts = self._host_messages[-1][0] if self._host_messages else 0.0
        self._host_messages.clear()
        ts = _bcast_object(local_ts, root_rank=0, name="elastic.hosts")
        # A change no newer than the round this world already joined (a
        # rejoin after a failure lands in it) is not news; every rank of
        # the round holds the same round timestamp.
        if ts > max(self._last_updated_timestamp, joined_ts()):
            self._last_updated_timestamp = ts
            raise HostsUpdatedInterrupt(skip_sync=False)

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        """Re-form the world after a topology change or a failed
        collective: under an elastic launcher, tear it down and rejoin the
        driver's current round (possibly with a new rank and size,
        possibly exiting cleanly when this host was scaled away); in a
        plain process the live world stays."""
        if in_elastic_world():
            from .worker import rejoin_world

            rejoin_world()


class ObjectState(State):
    """Elastic state for picklable attributes: those given to the
    constructor are tracked, deep-copied on save and broadcast from rank 0
    on sync."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved_state: Dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._known_attrs = list(kwargs.keys())
        self.save()

    def save(self):
        self._saved_state = {
            k: copy.deepcopy(getattr(self, k)) for k in self._known_attrs
        }

    def restore(self):
        for k, v in self._saved_state.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self):
        payload = {k: getattr(self, k) for k in self._known_attrs}
        synced = _bcast_object(payload, root_rank=0, name="elastic.state")
        for k, v in synced.items():
            setattr(self, k, v)
        self.save()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True).requires_grad_(t.requires_grad)


def _device_of(tree):
    found = []

    def note(t):
        found.append(t.device)
        return t

    map_tensors(note, tree)
    return found[0] if found else None


def _values_from(tree, snap):
    """``tree`` with its tensors' values taken from ``snap``, a host
    snapshot of the same structure."""
    leaves = []
    map_tensors(lambda t: leaves.append(t) or t, snap)
    it = iter(leaves)
    return map_tensors(lambda t: next(it).to(t.device, t.dtype), tree)


def _same_layout(live, new) -> bool:
    return (isinstance(live, dict) and isinstance(new, dict)
            and live.keys() == new.keys()
            and all(isinstance(live[k], torch.Tensor)
                    and isinstance(new[k], torch.Tensor)
                    and live[k].shape == new[k].shape
                    and live[k].dtype == new[k].dtype
                    and live[k].device == new[k].device for k in new))


class TrainState(ObjectState):
    """Elastic state of a training loop: ``params`` and ``opt_state``
    (nests of tensors, as :func:`~..parallel.dp.init_state` builds them)
    and any other attributes. See the module docstring."""

    def __init__(self, params=None, opt_state=None, **kwargs):
        # Under an elastic launcher a respawned worker builds its state
        # while its peers are mid-rejoin: the first snapshot (a collective
        # for ZeRO-1 state) waits for run()'s sync, which every rank
        # enters together.
        self._snapshot_at_sync = in_elastic_world()
        super().__init__(params=params, opt_state=opt_state, **kwargs)

    def _params(self):
        return getattr(self, "params", None)

    def reset(self):
        """Rejoin as :meth:`State.reset` does; then, in an elastic world,
        repack the last commit for the new world: the live ZeRO-1 shards
        (and EF residuals) belong to the old world's rank and size. The
        commit is the live state on both ways here -- ``run`` restored it
        after a failure, and a host update is raised by ``commit`` right
        after its save."""
        super().reset()
        if in_elastic_world() and self._saved_state:
            self.restore()

    def save(self):
        from ..optimizer import canonicalize_sharded_states, has_sharded_state

        if self._snapshot_at_sync:
            return
        params = self._params()
        snap, devices = {}, {}
        for k in self._known_attrs:
            val = getattr(self, k)
            if params is not None and has_sharded_state(val):
                val = canonicalize_sharded_states(val, params)
            devices[k] = _device_of(val)
            snap[k] = map_tensors(_to_host, val)
        self._saved_state = snap
        self._devices = devices

    def restore(self):
        from ..optimizer import has_canonical_state, reshard_sharded_states

        restored = {}
        for k, v in self._saved_state.items():
            dev = self._devices[k]
            restored[k] = map_tensors(
                lambda t: t.to(dev, copy=True).requires_grad_(
                    t.requires_grad), v)
        params = restored.get("params")
        for k, v in restored.items():
            if params is not None and has_canonical_state(v):
                v = reshard_sharded_states(v, params)
            live = getattr(self, k)
            if k == "params" and _same_layout(live, v):
                # Back into the live tensors: a module trained in place
                # keeps its parameters.
                with torch.no_grad():
                    for name, t in v.items():
                        live[name].copy_(t)
                continue
            setattr(self, k, v)

    def sync(self):
        """Rank 0's state on every rank: tensors by broadcast (a sharded
        optimizer state through its canonical form), the rest by pickle;
        then a fresh commit snapshot.

        A sharded state's canonical form is gathered from every rank's
        shards, and a worker that just joined holds fresh ones: rank 0
        broadcasts the canonical form of its last commit instead (the live
        state whenever ``run`` syncs: the construction, a commit, or the
        commit ``run`` restored)."""
        from ..optimizer import (
            canonicalize_sharded_states,
            has_sharded_state,
            reshard_sharded_states,
        )

        def bcast(t):
            out = broadcast(t.detach(), 0)
            if t.requires_grad:
                with torch.no_grad():
                    t.copy_(out)
                return t
            return out

        for k in self._known_attrs:
            val = getattr(self, k)
            params = self._params()
            has_tensors = _device_of(val) is not None
            if params is not None and has_sharded_state(val):
                canonical = canonicalize_sharded_states(val, params)
                snap = self._saved_state.get(k)
                if snap is not None and _rank() in (None, 0):
                    canonical = _values_from(canonical, snap)
                canonical = map_tensors(bcast, canonical)
                setattr(self, k, reshard_sharded_states(canonical, params))
            elif has_tensors:
                setattr(self, k, map_tensors(bcast, val))
            else:
                setattr(self, k, broadcast_object(val, root_rank=0))
        self._snapshot_at_sync = False
        self.save()
