"""The port's side of the fault-plane and DTensor tests on gloo worlds, one
function a world (``context.spawn_gloo`` runs it on each rank), and the
seeded inputs both sides share. It imports no JAX: every rank of a world
imports this module, and the JAX side runs in the test process
(``test_torch_port_guard.py``, ``test_torch_port_elastic.py``,
``test_torch_port_gspmd.py``).
"""

import os

import numpy as np
import torch

from horovod_tpu_torch import chaos, context, convert, elastic
from horovod_tpu_torch.guard import GuardConfig
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.fusion import FlatBuckets
from horovod_tpu_torch.optimizer import adamw, fused_adamw, unshard_opt_state
from horovod_tpu_torch.parallel import dp, gspmd

# -- a small regression both packages train ------------------------------


def regression_params():
    rng = np.random.RandomState(0)
    return {"w": (rng.randn(8, 4) * 0.1).astype(np.float32)}


def regression_batches(n, rows=16, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, 8).astype(np.float32),
             rng.randn(rows, 4).astype(np.float32)) for _ in range(n)]


def regression_loss(p, b):
    x, y = b
    return ((x @ p["w"] - y) ** 2).mean()


def state_tensors(tree):
    """Every tensor of an optimizer state, in walk order (clones)."""
    out = []

    def rec(t):
        if isinstance(t, torch.Tensor):
            out.append(t.detach().clone())
        elif isinstance(t, FlatBuckets):
            rec(t.buffers)
        elif isinstance(t, dict):
            for k in sorted(t):
                rec(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                rec(v)

    rec(tree)
    return out


GUARD_VARIANTS = {
    "replicated": (lambda: adamw(0.05), {}),
    "int8_ef": (lambda: adamw(0.05),
                dict(compression=Compression.int8.with_block(64))),
    "zero1_fused_int8": (lambda: fused_adamw(0.05), dict(
        sharded=True, fused_update=True,
        compression=Compression.int8.with_block(64))),
    "overlap_accum": (lambda: adamw(0.05), dict(overlap=True,
                                                accum_steps=2)),
}


def guard_world2(variant):
    """Three guarded steps on a gloo world of 2; step 2's batch carries a
    NaN on rank 1 only. Both ranks must skip it (the verdict is
    replica-uniform) with everything bit for bit, then commit step 3."""
    r, n = context.rank(), context.size()
    make_opt, kw = GUARD_VARIANTS[variant]
    step, opt = dp.make_train_step(
        regression_loss, make_opt(), guard=GuardConfig(audit_every=0),
        device="cpu", **kw)
    ts = dp.init_state({k: torch.from_numpy(v)
                        for k, v in regression_params().items()}, opt)
    rows = slice(16 // n * r, 16 // n * (r + 1))
    out = {"skipped_bitwise": True}
    for i, (x, y) in enumerate(regression_batches(3)):
        x = x[rows].copy()
        if i == 1 and r == 1:
            x[0, 0] = np.nan
        before = ([p.detach().clone() for p in ts.params.values()]
                  + state_tensors(ts.opt_state) + [ts.step.clone()])
        ts, _ = step(ts, (torch.from_numpy(x), torch.from_numpy(y[rows])))
        after = ([p.detach().clone() for p in ts.params.values()]
                 + state_tensors(ts.opt_state) + [ts.step.clone()])
        if i == 1:
            out["skipped_bitwise"] = (len(before) == len(after) and all(
                torch.equal(a, b) for a, b in zip(before, after)))
            out["skipped_at_2"] = int(ts.guard.skipped)
    out["step"] = int(ts.step)
    out["skipped"] = int(ts.guard.skipped)
    out["params"] = {k: v.detach().numpy().copy()
                     for k, v in ts.params.items()}
    return out


def audit_world3():
    """Guarded steps with an audit every step on a gloo world of 3; after
    step 2 rank 1's parameters are corrupted (``param.corrupt``). The audit
    must localize rank 1 and resync it from rank 0."""
    chaos.plan("param.corrupt:corrupt@step=2;rank=1", seed=4)
    step, opt = dp.make_train_step(
        regression_loss, adamw(0.05), guard=GuardConfig(audit_every=1),
        device="cpu")
    ts = dp.init_state({k: torch.from_numpy(v)
                        for k, v in regression_params().items()}, opt)
    reports = []
    for x, y in regression_batches(3):
        ts, _ = step(ts, (torch.from_numpy(x), torch.from_numpy(y)))
        reports.append(step.guard_runtime.last_report.as_record())
    chaos.clear()
    return {"reports": reports,
            "params": {k: v.detach().numpy().copy()
                       for k, v in ts.params.items()}}


# -- elastic state across a world resize ------------------------------------


def elastic_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(5, 3).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "c": rng.randn(4, 4).astype(np.float32)}


def elastic_loss(p, b):
    return ((b @ p["c"]).sum(-1) * p["b"][:4].sum() + p["a"].square().sum()
            ).mean()


def _canonical_numpy(opt_state, params):
    canon = unshard_opt_state(opt_state, params)
    return [t.numpy().copy() for t in state_tensors(
        [canon.inner.mu.tree, canon.inner.nu.tree, canon.inner.count])]


def _zero1_step():
    return dp.make_train_step(elastic_loss, fused_adamw(1e-2), sharded=True,
                              fused_update=True, device="cpu",
                              threshold_bytes=64)


def elastic_resize(store2):
    """ZeRO-1 state committed in an elastic ``TrainState`` on a world of 4;
    ranks 2 and 3 leave, ranks 0 and 1 form a world of 2 and restore the
    commit, repacked for the new world."""
    r = context.rank()
    step, opt = _zero1_step()
    ts = dp.init_state({k: torch.from_numpy(v)
                        for k, v in elastic_params().items()}, opt)
    rng = np.random.RandomState(3)
    for _ in range(2):
        x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
        ts, _ = step(ts, x[2 * r:2 * r + 2])
    est = elastic.TrainState(params=ts.params, opt_state=ts.opt_state,
                             step=ts.step)
    canon4 = _canonical_numpy(ts.opt_state, ts.params)
    committed = {k: v.detach().numpy().copy() for k, v in ts.params.items()}
    # An uncommitted step the restore must undo.
    ts, _ = step(ts, torch.ones(2, 4))
    context.shutdown()
    if r >= 2:
        return {"left": True}
    os.environ.update(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                      LOCAL_WORLD_SIZE="2")
    context.init(device="cpu", backend="gloo",
                 init_method="file://" + store2)
    est.restore()
    out = {"world": est.opt_state.world,
           "canon_equal": all(np.array_equal(a, b) for a, b in zip(
               canon4, _canonical_numpy(est.opt_state, est.params))),
           "params_equal": all(np.array_equal(committed[k],
                                              est.params[k].detach().numpy())
                               for k in committed),
           "params_are_live": all(est.params[k] is ts.params[k]
                                  for k in committed)}
    step2, _ = _zero1_step()
    ts2 = dp.TrainState(est.params, est.opt_state, est.step)
    ts2, loss = step2(ts2, torch.ones(4, 4)[2 * r:2 * r + 2])
    out["stepped"] = int(ts2.step)
    out["loss_finite"] = bool(torch.isfinite(loss))
    return out


def elastic_sync():
    """``sync`` on a gloo world of 2: rank 1 starts from other parameters
    and a perturbed replicated state; after ``sync`` both hold rank 0's.
    The ZeRO-1 state syncs through its canonical form."""
    r = context.rank()
    params = {k: torch.from_numpy(v)
              for k, v in elastic_params(seed=r).items()}
    step, opt = _zero1_step()
    ts = dp.init_state(params, opt)
    ts, _ = step(ts, torch.ones(1, 4) * (r + 1))
    est = elastic.TrainState(params=ts.params, opt_state=ts.opt_state,
                             epoch=10 + r, step=ts.step)
    est.sync()
    return {"params": {k: v.detach().numpy().copy()
                       for k, v in est.params.items()},
            "params_are_live": all(est.params[k] is ts.params[k]
                                   for k in params),
            "epoch": est.epoch,
            "canon": _canonical_numpy(est.opt_state, est.params)}


# -- GSPMD placements as DTensor ---------------------------------------------


def gspmd_cfg(**kw):
    return GPT2Config.tiny(dtype=torch.float32, use_flash=False, **kw)


def gspmd_tokens():
    return np.random.RandomState(5).randint(0, 512, (2, 16)).astype(np.int64)


def _gspmd_model(seed=0):
    cfg = gspmd_cfg()
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(convert.init_params(cfg, seed=seed))
    return model


def gspmd_mesh_2x2():
    """Every parameter's local shard on a 2 x 2 (fsdp, tp) mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", np.arange(4).reshape(2, 2),
                      mesh_dim_names=("fsdp", "tp"))
    model = gspmd.shard_params(_gspmd_model(), mesh, tp_axis="tp",
                               fsdp_axis="fsdp")
    return {name: p.to_local().detach().numpy().copy()
            for name, p in model.named_parameters()}


def gspmd_tp2():
    """The tp-2 forward and backward on a one-dimensional mesh: logits,
    the collectives of the forward, and the full gradients."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode

    mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("tp",))
    model = gspmd.shard_params(_gspmd_model(), mesh)
    tokens = torch.from_numpy(gspmd_tokens())
    with CommDebugMode() as comm:
        logits = model(tokens).full_tensor()
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    logits.logsumexp(-1).mean().backward()
    grads = {name: p.grad.full_tensor().reshape(-1).numpy().copy()
             for name, p in model.named_parameters()}
    return {"logits": logits.detach().numpy().copy(), "comm": counts,
            "grads": grads}
