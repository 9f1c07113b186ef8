"""The port's 3-D parallel GPT (``parallel/transformer.py``) held against
the JAX package's, at ``tests/test_parallel_transformer.py``'s
configuration (vocab 64, d 32, 4 heads, 2 layers, d_ff 64, fp32, no remat;
tokens ``[4, 32]`` from a numpy seed), the weights the reference's
``init_params`` made, carried over by ``convert.parallel_gpt_params_from_
jax``.

* One gloo world of 8 (dp 2 x sp 2 x tp 2, ``context.spawn_gloo`` of
  ``torch_parallel_ranks.gpt_world``): each
  rank's logits within 2e-4 of the reference's ``shard_map`` forward on a
  (2, 2, 2) mesh of the conftest's CPU devices, the loss within 2e-4
  (relative) of its loss; every leaf's gradient after the step's reduction
  (``loss_and_grads``: Sum over (dp, sp)) within 1e-4 (of the leaf's
  largest) of this rank's shard of ``jax.grad`` of the dense loss, and the
  replicated leaves' gradients equal on the two tp ranks; ``shard_state``
  of a full state (parameters and AdamW moments after three one-device
  steps) gives each rank exactly its slices, and a step from it has the
  one-device run's fourth loss.
* The MoE config (4 experts) on a world of 4 (dp 2 x tp 2): the loss
  within 2e-4 of the reference's.
* Three steps on a one-device mesh under ``adamw(1e-3)``: the losses and
  parameters within 1e-5 of the reference's ``make_parallel_train_step``.
* ROADMAP C9: the reference's own step does not produce the dense gradient
  on a mesh of more than one device. Its gradients after the Sum over
  (dp, sp), one copy a device, are 8x dense on the tp-sharded leaves and
  4x on ``lnf_scale`` at dp 2 x sp 2 x tp 2, between the two on ``wte``
  and ``ln1_scale``, and ``wte``'s differs between the two tp ranks; the
  port's are dense on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from horovod_tpu import _compat
from horovod_tpu.models.transformer import dot_product_attention as jattn
from horovod_tpu.ops.collectives import Sum as JSum
from horovod_tpu.ops.fusion import fused_allreduce as jfused_allreduce
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch import context, convert
from horovod_tpu_torch.optimizer import adamw
from horovod_tpu_torch.parallel import transformer as ttr

import torch_parallel_ranks as ranks
from torch_parallel_ranks import LEAVES, LR, MESH, TP_SHARDED


def _jcfg(**kw):
    return jtr.ParallelGPTConfig(**{**ranks.BASE, "dtype": jnp.float32, **kw})


def _np_params(cfg, seed):
    return {k: np.asarray(v)
            for k, v in jtr.init_params(cfg, jax.random.PRNGKey(seed)).items()}


def _jmesh(shape):
    devs = np.asarray(jax.devices("cpu")[:int(np.prod(shape))])
    return JMesh(devs.reshape(shape), ("dp", "sp", "tp"))


def _smap(fn, mesh, in_specs, out_specs):
    return jax.jit(_compat.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))


def _reference_forward(params, tokens, cfg):
    """``tests/test_parallel_transformer.py``'s single-device dense
    reference of the same math."""
    x = params["wte"][tokens] + params["wpe"][jnp.arange(tokens.shape[1])]
    L = cfg.n_layers
    for i in range(L):
        lp = {k: v[i] for k, v in params.items() if v.ndim and v.shape[0] == L}
        h = jtr._ln(x, lp["ln1_scale"], lp["ln1_bias"])
        q = jnp.einsum("bsd,dhk->bshk", h, lp["wq"])
        k = jnp.einsum("bsd,dhk->bshk", h, lp["wk"])
        v = jnp.einsum("bsd,dhk->bshk", h, lp["wv"])
        a = jattn(q, k, v, causal=True)
        x = x + jnp.einsum("bshk,hkd->bsd", a, lp["wo"])
        h = jtr._ln(x, lp["ln2_scale"], lp["ln2_bias"])
        up = jax.nn.gelu(jnp.einsum("bsd,df->bsf", h, lp["w_up"]) + lp["b_up"])
        x = x + jnp.einsum("bsf,fd->bsd", up, lp["w_down"]) + lp["b_down"]
    x = jtr._ln(x, params["lnf_scale"], params["lnf_bias"])
    return x @ params["wte"].T


def _dense_loss(params, tokens, cfg):
    logits = _reference_forward(params, tokens, cfg)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1], tokens[:, 1:]).mean()


@pytest.fixture(scope="module")
def one_device():
    """Three steps of the reference's and the port's step on a one-device
    mesh from the same weights; the port's state after them and its fourth
    step's loss, which the world of 8 continues from."""
    cfg = _jcfg()
    np_params = _np_params(cfg, 0)
    runs = [ranks.token_batch(10 + i) for i in range(4)]
    mesh = _jmesh((1, 1, 1))
    jopt = optax.adamw(LR)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    jstate = jopt.init(jparams)
    jstep = jtr.make_parallel_train_step(cfg, jopt, mesh, donate=False)
    jlosses = []
    for t in runs[:3]:
        jparams, jstate, loss = jstep(jparams, jstate, jnp.asarray(t))
        jlosses.append(float(loss))
    context.init(device="cpu", mesh={"dp": 1, "sp": 1, "tp": 1},
                 world_axes=("dp", "sp"))
    try:
        tcfg = ranks.tcfg()
        params = ttr.shard_params(
            convert.parallel_gpt_params_from_jax(np_params, device="cpu"),
            tcfg, device="cpu")
        opt = adamw(LR)
        state = opt.init(params)
        step = ttr.make_parallel_train_step(tcfg, opt, device="cpu")
        tlosses, snaps = [], []
        for t in runs:
            snaps.append((ranks.to_np(params), int(state.count),
                          ranks.to_np(state.mu), ranks.to_np(state.nu)))
            params, state, loss = step(params, state, torch.from_numpy(t))
            tlosses.append(float(loss))
    finally:
        context.shutdown()
    return dict(runs=runs, jlosses=jlosses,
                jparams={k: np.asarray(v) for k, v in jparams.items()},
                tlosses=tlosses, snap3=snaps[3])


@pytest.fixture(scope="module")
def world(one_device):
    np_params = _np_params(_jcfg(), 1)
    tokens = ranks.token_batch(1)
    full_state = (*one_device["snap3"], one_device["runs"][3])
    per_rank = context.spawn_gloo(8, ranks.gpt_world, np_params, tokens,
                                  full_state)
    return dict(np_params=np_params, tokens=tokens, ranks=per_rank)


@pytest.fixture(scope="module")
def references(world):
    cfg = _jcfg()
    mesh = _jmesh((2, 2, 2))
    specs = jtr.param_specs(cfg)
    params = {k: jnp.asarray(v) for k, v in world["np_params"].items()}
    tokens = jnp.asarray(world["tokens"], jnp.int32)
    with jax.default_matmul_precision("highest"):
        logits = _smap(lambda p, t: jtr.forward(p, t, cfg), mesh,
                       (specs, P("dp", "sp")), P("dp", "sp"))(params, tokens)
        loss = _smap(lambda p, t: jtr.loss_fn(p, t, cfg), mesh,
                     (specs, P("dp", "sp")), P())(params, tokens)
        dense = jax.grad(_dense_loss)(params, tokens, cfg)

        def per_device(p, t):
            g = jax.grad(jtr.loss_fn)(p, t, cfg)
            g = jfused_allreduce(g, op=JSum, axis=("dp", "sp"))
            return jax.tree.map(lambda x: x[None], g)

        ref_grads = _smap(per_device, mesh, (specs, P("dp", "sp")),
                          {k: P(("dp", "sp", "tp")) for k in specs})(
                              params, tokens)
    return dict(logits=np.asarray(logits), loss=float(loss),
                dense={k: np.asarray(v) for k, v in dense.items()},
                ref_grads={k: np.asarray(v) for k, v in ref_grads.items()})


def test_forward_matches_the_reference(world, references):
    for r in world["ranks"]:
        c = r["coords"]
        want = ranks.block(references["logits"], c["dp"], c["sp"], 2, 2)
        np.testing.assert_allclose(r["logits"], want, atol=2e-4, rtol=0)


def test_loss_matches_the_reference(world, references):
    for r in world["ranks"]:
        np.testing.assert_allclose(r["loss"], references["loss"], rtol=2e-4)


@pytest.mark.parametrize("leaf", LEAVES)
def test_reduced_gradient_is_the_dense_gradient(world, references, leaf):
    spec = ttr.param_specs(ranks.tcfg())[leaf]
    dense = references["dense"][leaf]
    scale = float(np.abs(dense).max())
    for r in world["ranks"]:
        want = ranks.slice_shard(dense, spec, r["coords"], MESH)
        err = float(np.abs(r["grads"][leaf] - want).max())
        assert err <= 1e-4 * scale, (leaf, r["coords"], err, scale)


def test_replicated_leaves_agree_on_the_tp_ranks(world):
    by = {(r["coords"]["dp"], r["coords"]["sp"], r["coords"]["tp"]): r
          for r in world["ranks"]}
    for leaf in LEAVES:
        if leaf in TP_SHARDED:
            continue
        for dp in range(2):
            for sp in range(2):
                np.testing.assert_array_equal(by[(dp, sp, 0)]["grads"][leaf],
                                              by[(dp, sp, 1)]["grads"][leaf])


def test_c9_reference_gradients_scale_with_the_mesh(world, references):
    """ROADMAP C9: the reference's step is off the dense gradient by
    factors of the mesh; the port's is on it."""
    dense, ref = references["dense"], references["ref_grads"]
    specs = ttr.param_specs(ranks.tcfg())

    def ratio(leaf, grads_of):
        # Each device's copy against its shard of the dense gradient.
        num = den = 0.0
        for d in range(8):
            coords = dict(zip(("dp", "sp", "tp"), np.unravel_index(d,
                                                                   (2, 2, 2))))
            want = ranks.slice_shard(dense[leaf], specs[leaf], coords, MESH)
            num += float(np.linalg.norm(grads_of(d, coords)))
            den += float(np.linalg.norm(want))
        return num / den

    def ref_of(leaf):
        return lambda d, c: ref[leaf][d]

    by = {tuple(r["coords"][a] for a in ("dp", "sp", "tp")): r
          for r in world["ranks"]}

    def port_of(leaf):
        return lambda d, c: by[(int(c["dp"]), int(c["sp"]),
                                int(c["tp"]))]["grads"][leaf]

    for leaf in TP_SHARDED:
        assert abs(ratio(leaf, ref_of(leaf)) - 8.0) < 1e-3, leaf
    assert abs(ratio("lnf_scale", ref_of("lnf_scale")) - 4.0) < 1e-3
    for leaf in ("wte", "ln1_scale"):
        assert 4.0 + 1e-3 < ratio(leaf, ref_of(leaf)) < 8.0 - 1e-3, leaf
    # The reference's replicated wte gradient differs between tp ranks
    # (devices 0 and 1: dp 0, sp 0, tp 0 and 1); the port's does not.
    assert float(np.abs(ref["wte"][0] - ref["wte"][1]).max()) > 1e-3 * float(
        np.abs(ref["wte"][0]).max())
    for leaf in LEAVES:
        assert abs(ratio(leaf, port_of(leaf)) - 1.0) < 1e-4, leaf


def test_moe_loss_matches_the_reference():
    cfg = _jcfg(moe_experts=4)
    np_params = _np_params(cfg, 2)
    tokens = ranks.token_batch(2)
    got = context.spawn_gloo(4, ranks.moe_world, np_params, tokens)
    mesh = _jmesh((2, 1, 2))
    with jax.default_matmul_precision("highest"):
        want = float(_smap(lambda p, t: jtr.loss_fn(p, t, cfg), mesh,
                           (jtr.param_specs(cfg), P("dp", "sp")), P())(
            {k: jnp.asarray(v) for k, v in np_params.items()},
            jnp.asarray(tokens, jnp.int32)))
    for loss in got:
        np.testing.assert_allclose(loss, want, rtol=2e-4)


def test_shard_state_gives_every_rank_its_slices(world, one_device):
    params, count, mu, nu = one_device["snap3"]
    specs = ttr.param_specs(ranks.tcfg())
    for r in world["ranks"]:
        p, c, m, v = r["resharded"]
        assert c == count
        for full, got in ((params, p), (mu, m), (nu, v)):
            for k, x in full.items():
                np.testing.assert_array_equal(
                    got[k], ranks.slice_shard(x, specs[k], r["coords"], MESH))


def test_resharded_step_continues_the_one_device_run(world, one_device):
    want = one_device["tlosses"][3]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["loss4"], want, rtol=2e-4)


def test_three_steps_on_one_device_match_the_reference(one_device):
    np.testing.assert_allclose(one_device["tlosses"][:3],
                               one_device["jlosses"], rtol=1e-5, atol=1e-5)
    params = one_device["snap3"][0]  # the port's after three steps
    for k, want in one_device["jparams"].items():
        np.testing.assert_allclose(params[k], want, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_entry_points_resolve_to_the_card(monkeypatch):
    """Without ``device=`` the 3-D GPT's entry points take the card (raising
    where there is none); after ``init(device="cpu")``, the process's
    device."""
    from horovod_tpu_torch.parallel.mesh import build_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ranks.tcfg()
    mesh = build_mesh({"dp": 1, "sp": 1, "tp": 1})
    full = ttr.init_params(cfg, device="cpu")
    for call in (lambda: ttr.init_params(cfg),
                 lambda: convert.parallel_gpt_params_from_jax(
                     {k: v.numpy() for k, v in full.items()}),
                 lambda: ttr.shard_params(full, cfg, mesh),
                 lambda: ttr.shard_init(cfg, mesh, None, adamw(LR))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    context.init(device="cpu", mesh={"dp": 1, "sp": 1, "tp": 1},
                 world_axes=("dp", "sp"))
    try:
        params, _ = ttr.shard_init(cfg, None, None, adamw(LR))
        assert all(v.device.type == "cpu" for v in params.values())
        ttr.make_parallel_train_step(cfg, adamw(LR))
    finally:
        context.shutdown()
