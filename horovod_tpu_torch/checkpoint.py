"""Durable, integrity-checked checkpoints for the port.

The port of the JAX package's ``checkpoint.py`` (its manifest, walk-back,
quarantine, watcher and hot-swap restore), with the port's own on-disk
tree: one ``torch.save`` of a flat name -> CPU tensor dict per step
(``state.pt``), since orbax cannot be read without JAX.

* step-numbered directories ``step_<N>`` written atomically (tmpdir +
  rename) by rank 0 only, with ``keep``-latest retention;
* a ``manifest.json`` of size and crc32 per file, verified on restore: a
  corrupt latest step is quarantined as ``step_<N>.corrupt`` and the
  restore walks back to the newest intact step; a pinned corrupt
  ``step=`` raises :class:`~horovod_tpu_torch.exceptions.
  CheckpointCorruptError` instead;
* the write retries transient filesystem failures (``utils/retry.py``);
* :class:`CheckpointWatcher` and :func:`hot_swap_restore` drive the
  serving pool's rolling hot-swap.

A state is an ``nn.Module`` (its ``state_dict``) or a nest of dicts,
dataclasses (``TrainState``), NamedTuples (the optimizer states), lists,
tuples, the fused optimizer buffers (``FlatBuckets``, ``EFResiduals``) and
the canonical optimizer forms (``CanonicalBuckets``,
``CanonicalResiduals``) over tensors, numpy arrays, Python scalars and
``None``, flattened to ``"a/b"`` names by key, field name or index
(``None`` writes nothing). Restoring into a template gives the template's
structure, types, dtypes and devices (a tensor keeps its
``requires_grad``); a module template is copied and loaded, never
modified.

World-size-portable training state (gather on save, reshard on restore):
inside every ``TrainState``, a ZeRO-1 optimizer state and a replicated one
carrying EF residuals are written in their canonical form
(:func:`~horovod_tpu_torch.optimizer.unshard_opt_state`: parameter-shaped
leaves keyed by parameter name, the padding stripped, the residuals'
mean), and a restore reads them into the canonicalized target and repacks
them for the live optimizer: this world's size, and the target's fusion
threshold and quantization block. So a checkpoint saved at N ranks, or
under one fusion threshold, restores at M ranks or under another. The
canonicalization is a collective: every rank calls
:func:`save_checkpoint` and :func:`restore_checkpoint` (only rank 0
writes).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import re
import shutil
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import context as _ctx
from . import optimizer as _opt
from .exceptions import CheckpointCorruptError
from .obs import control as _ctl
from .obs import goodput as _goodput
from .obs import registry as _obs
from .obs import serve as _serve_obs
from .ops.fusion import EFResiduals, FlatBuckets

log = logging.getLogger("horovod_tpu_torch.checkpoint")

_STEP_RE = re.compile(r"^step_(\d+)$")
MANIFEST_NAME = "manifest.json"
STATE_NAME = "state.pt"


def _is_writer() -> bool:
    """Rank-0-only writes, the reference's convention (the global rank:
    on a mesh, ``rank()`` is the index along the world axes)."""
    if _ctx.is_initialized():
        return _ctx.context().rank == 0
    return _ctx.launcher_rank() == 0


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


# -- integrity ----------------------------------------------------------


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _manifest_entries(root: str) -> Dict[str, Dict[str, int]]:
    entries: Dict[str, Dict[str, int]] = {}
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            if rel == MANIFEST_NAME or not os.path.isfile(p):
                continue
            entries[rel] = {"size": os.path.getsize(p), "crc32": _file_crc(p)}
    return entries


def _write_manifest(root: str) -> None:
    manifest = {"version": 1, "algo": "crc32", "files": _manifest_entries(root)}
    with open(os.path.join(root, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=0, sort_keys=True)


def verify_step_dir(path: str) -> List[str]:
    """Integrity problems for one step directory ([] = intact).

    A directory without a manifest verifies clean (legacy checkpoints stay
    restorable); an unreadable manifest is itself a problem."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return []
    try:
        with open(mpath) as f:
            files = json.load(f)["files"]
    except (OSError, ValueError, KeyError) as e:
        return [f"unreadable manifest: {e}"]
    problems = []
    for rel, want in sorted(files.items()):
        p = os.path.join(path, rel)
        if not os.path.isfile(p):
            problems.append(f"missing leaf file {rel}")
            continue
        size = os.path.getsize(p)
        if size != want["size"]:
            problems.append(f"size mismatch {rel}: {size} != {want['size']}")
            continue
        if _file_crc(p) != want["crc32"]:
            problems.append(f"crc32 mismatch {rel}")
    return problems


def _quarantine(path: str) -> str:
    """Move a corrupt step dir aside as ``<dir>.corrupt`` (numbered on
    collision); losing the rename to a concurrent restorer counts as
    quarantined."""
    dest = path + ".corrupt"
    i = 1
    while os.path.exists(dest):
        dest = f"{path}.corrupt.{i}"
        i += 1
    try:
        os.rename(path, dest)
    except FileNotFoundError:
        return dest  # a peer quarantined it first
    reg = _obs.metrics()
    reg.counter("recovery.ckpt_quarantined").inc()
    reg.event("ckpt.quarantined", path=dest)
    return dest


# -- serialization ------------------------------------------------------


def _children(node: Any):
    """``(key, child)`` pairs of an inner node of a state, or None for a
    leaf: dict keys, dataclass and NamedTuple field names, list and tuple
    indices, a fused buffer list's indices (and an EF residual's layout
    recipe), a canonical form's tree. A canonical form's layout recipe
    (``threshold``, ``block``) is not written: a restore takes it from the
    target, the live optimizer's."""
    if isinstance(node, _opt.CanonicalOptState):
        return [("inner", node.inner), ("count", node.count),
                ("residual", node.residual)]
    if isinstance(node, (_opt.CanonicalBuckets, _opt.CanonicalResiduals)):
        return [("tree", node.tree)]
    if isinstance(node, dict):
        return list(node.items())
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node) if f.init]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if isinstance(node, EFResiduals):
        return [("buffers", node.buffers), ("threshold", node.threshold),
                ("block", node.block)]
    if isinstance(node, FlatBuckets):
        return [("buffers", node.buffers)]
    return None


def _rebuild(node: Any, values: list) -> Any:
    """An inner node of ``node``'s own type from its children's values, in
    :func:`_children`'s order (a canonical form's layout recipe from
    ``node``)."""
    if isinstance(node, _opt.CanonicalOptState):
        inner, count, residual = values
        return node._replace(inner=inner, count=count, residual=residual)
    if isinstance(node, _opt.CanonicalBuckets):
        return _opt.CanonicalBuckets(values[0])
    if isinstance(node, _opt.CanonicalResiduals):
        return _opt.CanonicalResiduals(values[0], node.threshold, node.block)
    if isinstance(node, dict):
        return type(node)(zip(node.keys(), values))
    if dataclasses.is_dataclass(node):
        names = [f.name for f in dataclasses.fields(node) if f.init]
        return type(node)(**dict(zip(names, values)))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*values)
    if isinstance(node, (list, tuple)):
        return type(node)(values)
    if isinstance(node, EFResiduals):
        return EFResiduals(*values)
    return type(node)(*values)  # FlatBuckets


def map_tensors(fn, state: Any) -> Any:
    """``fn`` on every tensor of ``state`` (the nests this module walks:
    dicts, dataclasses, NamedTuples, lists, tuples, the fused and canonical
    optimizer buffers), rebuilt in the state's own types; other leaves pass
    through."""
    kids = _children(state)
    if kids is not None:
        return _rebuild(state, [map_tensors(fn, v) for _, v in kids])
    if isinstance(state, torch.Tensor):
        return fn(state)
    return state


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _flat_state(state: Any) -> Dict[str, torch.Tensor]:
    """Flat name -> CPU tensor dict of a state (see the module docstring)."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    out: Dict[str, torch.Tensor] = {}

    def rec(prefix: str, node: Any) -> None:
        kids = _children(node)
        if kids is not None:
            for k, v in kids:
                rec(_join(prefix, k), v)
        elif node is None:
            pass
        elif isinstance(node, torch.Tensor):
            # A private CPU copy: torch.save of a view would write its
            # whole storage.
            out[prefix] = node.detach().to("cpu", copy=True).contiguous()
        elif isinstance(node, (np.ndarray, np.generic, bool, int, float)):
            out[prefix] = torch.as_tensor(np.asarray(node)).clone()
        else:
            raise TypeError(
                f"checkpoint leaf {prefix!r} has unsupported type "
                f"{type(node).__name__}"
            )

    rec("", state)
    return out


def _map_train_states(state: Any, fix) -> Any:
    """``fix`` applied to every ``parallel.dp.TrainState`` in ``state`` (a
    bare ``TrainState`` root included)."""
    from .parallel.dp import TrainState

    return _opt._map_nodes(fix, state, lambda n: isinstance(n, TrainState))


def _canonicalize_sharded(state: Any) -> Any:
    """Gather on save: the optimizer states inside every ``TrainState``
    rewritten into their canonical, world-size-portable form (a collective
    across the world that built them)."""
    def fix(node):
        if not _opt.has_sharded_state(node.opt_state):
            return node
        canonical = _opt.canonicalize_sharded_states(node.opt_state,
                                                     node.params)
        return dataclasses.replace(node, opt_state=canonical)

    return _map_train_states(state, fix)


def _reshard_canonical(state: Any) -> Any:
    """Reshard on restore: the inverse of :func:`_canonicalize_sharded` for
    this world, at the layout the structural restore took from the target
    (its threshold and block)."""
    def fix(node):
        if not _opt.has_canonical_state(node.opt_state):
            return node
        runtime = _opt.reshard_sharded_states(node.opt_state, node.params)
        return dataclasses.replace(node, opt_state=runtime)

    return _map_train_states(state, fix)


def _write_tree(path: str, state: Any) -> None:
    torch.save(_flat_state(state), os.path.join(path, STATE_NAME))


def _read_tree(path: str, target: Any) -> Any:
    flat = torch.load(
        os.path.join(path, STATE_NAME), map_location="cpu", weights_only=True
    )
    if isinstance(target, torch.nn.Module):
        missing = [k for k in target.state_dict() if k not in flat]
        if missing:
            raise ValueError(f"checkpoint lacks {missing[:3]} of the target")
        restored = copy.deepcopy(target)
        restored.load_state_dict(
            {k: flat[k] for k in target.state_dict()}, strict=True
        )
        return restored

    def rec(prefix: str, node: Any) -> Any:
        kids = _children(node)
        if kids is not None:
            return _rebuild(node, [rec(_join(prefix, k), v) for k, v in kids])
        if node is None:
            return None
        if prefix not in flat:
            raise ValueError(f"checkpoint has no entry {prefix!r}")
        r = flat[prefix]
        if isinstance(node, torch.Tensor):
            t = r.to(device=node.device, dtype=node.dtype)
            if isinstance(node, torch.nn.Parameter):
                return torch.nn.Parameter(t, requires_grad=node.requires_grad)
            return t.requires_grad_(node.requires_grad)
        if isinstance(node, np.generic):
            return node.dtype.type(r.item())
        if isinstance(node, np.ndarray):
            return np.asarray(r.float().numpy() if r.dtype == torch.bfloat16
                              else r.numpy(), dtype=node.dtype)
        return type(node)(r.item())

    return rec("", target)


def _write_tree_with_retry(tmp: str, state: Any) -> None:
    """Serialize and write the manifest, retrying transient filesystem
    failures with capped backoff; each retry starts from an emptied
    ``tmp`` so a half-written attempt never leaks into the manifest."""
    from .utils.retry import retry_call

    def attempt():
        _write_tree(tmp, state)
        _write_manifest(tmp)

    def on_retry(exc, attempt_no):
        _obs.metrics().counter("recovery.ckpt_write_retries").inc()
        log.warning(
            "checkpoint write attempt %d failed (%s); clearing %s and "
            "retrying", attempt_no, exc, tmp,
        )
        for name in os.listdir(tmp):
            p = os.path.join(tmp, name)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)

    retry_call(
        attempt, attempts=4, retry_on=(OSError,), base=0.1, cap=2.0,
        on_retry=on_retry,
    )


def _apply_ckpt_fault(tmp: str, fault) -> None:
    """Damage one written file in ``tmp`` (the chaos ``ckpt.write`` site):
    ``corrupt`` flips a 64-byte span in its middle (bit-rot), ``truncate``
    cuts it in half (a torn write). The victim is picked from the fault
    rule's seeded stream among the larger half of the files, so a failing
    run replays exactly."""
    candidates = [
        (rel, meta["size"])
        for rel, meta in sorted(_manifest_entries(tmp).items())
        if meta["size"] > 0
    ]
    if not candidates:
        return
    candidates.sort(key=lambda kv: kv[1], reverse=True)
    top = [rel for rel, _ in candidates[: max(1, len(candidates) // 2)]]
    victim = os.path.join(tmp, fault.rng.choice(top))
    size = os.path.getsize(victim)
    if fault.kind == "truncate":
        with open(victim, "r+b") as f:
            f.truncate(size // 2)
    else:
        with open(victim, "r+b") as f:
            f.seek(max(0, size // 2 - 32))
            span = f.read(64)
            f.seek(max(0, size // 2 - 32))
            f.write(bytes(b ^ 0xFF for b in span))
    log.warning("chaos: %s checkpoint file %s", fault.kind, victim)


def save_checkpoint(directory: str, state: Any, step: int,
                    keep: int = 3, force: bool = False) -> Optional[str]:
    """Write ``state`` under ``directory/step_<step>``.

    Only rank 0 writes (returns None elsewhere unless ``force``), but every
    rank calls it: a ``TrainState``'s optimizer state is gathered into its
    canonical form first (see the module docstring). The write is atomic
    (tmpdir + rename); checkpoints older than the newest ``keep`` are
    deleted, never the one just written. The whole save, gather included,
    is booked as ``checkpoint`` time in the goodput ledger."""
    ckpt_w0 = time.time()
    state = _canonicalize_sharded(state)
    if not _is_writer() and not force:
        _goodput.record_checkpoint(ckpt_w0, time.time() - ckpt_w0)
        return None
    directory = os.path.abspath(directory)
    final = _step_dir(directory, step)
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"step_{step}.tmp", dir=directory)
    try:
        _write_tree_with_retry(tmp, state)
        from . import chaos as _chaos

        if _chaos.enabled():
            # The ckpt.write site: bit-rot or truncate the written tree
            # AFTER the manifest, so the damage is what restore-time
            # verification must catch.
            fault = _chaos.act("ckpt.write", step=step)
            if fault is not None and fault.kind in ("corrupt", "truncate"):
                _apply_ckpt_fault(tmp, fault)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _obs.metrics().counter("ckpt.saves").inc()
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in all_steps(directory)[:-keep] if keep else []:
        if old != step:
            shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    _goodput.record_checkpoint(ckpt_w0, time.time() - ckpt_w0)
    return final


def restore_checkpoint(directory: str, target: Any,
                       step: Optional[int] = None,
                       verify: bool = True) -> Any:
    """Restore ``target``'s structure, dtypes and devices from
    ``directory`` (latest intact step unless ``step`` given). Raises
    FileNotFoundError when no checkpoint exists.

    Restoring the latest step, a corrupt dir is quarantined as
    ``step_<N>.corrupt`` and the walk falls back to the newest intact
    step. A pinned ``step=`` that fails verification raises
    :class:`CheckpointCorruptError`. ``verify=False`` skips the checks.

    A ``TrainState``'s optimizer state is read in its canonical form and
    repacked for this world and the target optimizer's layout (see the
    module docstring); every rank of the world calls this."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = all_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        for s in reversed(steps):
            path = _step_dir(directory, s)
            problems = verify_step_dir(path) if verify else []
            if not problems:
                step = s
                break
            quarantined = _quarantine(path)
            _obs.metrics().counter("recovery.ckpt_fallback").inc()
            log.warning(
                "checkpoint step %d is corrupt (%s); quarantined as %s, "
                "falling back to the previous step",
                s, "; ".join(problems[:3]), quarantined,
            )
        else:
            raise FileNotFoundError(
                f"no intact checkpoints under {directory} "
                "(all steps quarantined as corrupt)"
            )
        path = _step_dir(directory, step)
    else:
        path = _step_dir(directory, step)
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        if verify:
            problems = verify_step_dir(path)
            if problems:
                raise CheckpointCorruptError(path, problems)
    return _reshard_canonical(_read_tree(path, _canonicalize_sharded(target)))


def priority_checkpoint(directory: str, state: Any, step: int,
                        keep: int = 3) -> Optional[str]:
    """Eviction-grace checkpoint: what a preempted worker writes in its
    SIGTERM window (``elastic.worker.register_preempt_callback``).

    The same manifest-verified atomic writer as :func:`save_checkpoint`
    (per-tensor CRC manifest, retry-wrapped serialization, tmpdir +
    rename), with ``force=True``: the evicted host may be any rank, and
    ITS state must reach disk whoever the designated writer is. Counted in
    :data:`priority_checkpoints` and in ``recovery.preempt_ckpts``, with a
    ``ckpt.preempt`` event."""
    global priority_checkpoints
    path = save_checkpoint(directory, state, step=step, keep=keep, force=True)
    priority_checkpoints += 1
    _ctl.preempt_checkpointed()
    _obs.metrics().event("ckpt.preempt", step=step, path=path)
    log.info("priority checkpoint of step %d written to %s", step, path)
    return path


priority_checkpoints = 0


# -- hot-swap (serving) --------------------------------------------------


class CheckpointWatcher:
    """Tracks a checkpoint directory for newly published steps -- the
    rolling hot-swap trigger of the serving pool. :meth:`poll` returns a
    step at most once; the watcher only moves forward, so a step
    quarantined after being offered is never re-offered. Every poll sets
    the ``serve.ckpt_staleness_s`` gauge (:attr:`staleness_s`)."""

    def __init__(self, directory: str, initial: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self._last = (
            initial if initial is not None else latest_step(self.directory)
        )
        self._advanced_t = time.time()  # last time poll() saw a new step

    @property
    def staleness_s(self) -> float:
        """Seconds since the newest-step watermark last advanced."""
        return max(0.0, time.time() - self._advanced_t)

    def poll(self) -> Optional[int]:
        """The newest step if it advanced past everything seen, else
        None."""
        cur = latest_step(self.directory)
        if cur is not None and (self._last is None or cur > self._last):
            self._last = cur
            self._advanced_t = time.time()
            _serve_obs.set_ckpt_staleness(0.0)
            return cur
        _serve_obs.set_ckpt_staleness(self.staleness_s)
        return None

    def rewind(self, step: int) -> None:
        """Un-see ``step`` so the next :meth:`poll` re-offers it, for a
        swap that failed transiently. Only the most recently seen step
        can be rewound."""
        if self._last is not None and self._last == step:
            self._last = step - 1


def hot_swap_restore(directory: str, target: Any,
                     step: Optional[int] = None,
                     verify: bool = True):
    """Restore for a rolling hot-swap: ``(state, restored_step,
    rolled_back)``. A corrupt pinned ``step`` is quarantined and the
    restore walks back to the newest intact step (``rolled_back=True``)."""
    directory = os.path.abspath(directory)
    rolled_back = False
    if step is not None:
        try:
            state = restore_checkpoint(
                directory, target, step=step, verify=verify
            )
            return state, step, False
        except CheckpointCorruptError as e:
            _quarantine(_step_dir(directory, step))
            _obs.metrics().counter("recovery.ckpt_rollback").inc()
            log.warning(
                "hot-swap checkpoint step %d is corrupt (%s); quarantined "
                "-- rolling back to the newest intact step",
                step, "; ".join(e.problems[:3]),
            )
            rolled_back = True
    state = restore_checkpoint(directory, target, verify=verify)
    return state, latest_step(directory), rolled_back
