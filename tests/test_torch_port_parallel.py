"""The port's parallelism library (``parallel/{sp,tp,pp,ep,hierarchical}.
py``, ``ops/diff_collectives.py``, ``combine_blocks``) held against the JAX
package's.

One gloo world of 4 CPU processes (``context.spawn_gloo``) runs every
multi-rank case (``torch_parallel_ranks.parallel_world``), re-initialized
with the mesh each case needs; the JAX side
runs the same functions under ``shard_map`` over the conftest's virtual CPU
devices (the flash ring's Pallas kernels in interpret mode, as
``tests/test_parallel.py`` runs them), from the same seeded numpy inputs.

* ``combine_blocks`` against the reference's, with rows that are ``-inf``
  on one side and on both: the merge within 1e-6, and the port's
  gradients finite everywhere and equal to ``jax.grad``'s (1e-5) where the
  reference's are finite.
* The dense and the flash ring at sp 4 (causal and not, head dims 16 and
  64) and Ulysses at 8 heads: the forward within 2e-5 of the reference's
  under ``shard_map``, and each rank's gradients of q, k and v within 1e-4
  (of the largest) of ``jax.grad`` of dense attention over the whole
  sequence.
* ``tp_mlp`` at tp 2 (on a dp 2 x tp 2 mesh): the forward against the
  reference's; the gradients against ``jax.grad`` of the dense MLP -- the
  weights' shards, and the input's gradient whole on every rank (the
  port's ``copy_to``).
* ``pipeline`` at 4 stages: the forward against the reference's; each
  stage's parameter gradient against ``jax.grad`` of the sequential
  composition, the microbatches' gradient on stage 0 (zero elsewhere).
* ``switch_moe_stacked`` at 4 ranks x 2 experts against
  ``tests/test_parallel_transformer.py::test_switch_moe_stacked_matches_
  dense_routing``'s oracle (1e-4) and the aux loss against the
  reference's; ``switch_moe`` against the routing arithmetic of
  ``test_switch_moe_routes_and_preserves_shape``.
* The differentiable collectives' backward: ``ppermute`` returns the
  cotangent along the inverse permutation, ``all_to_all`` swaps its axes,
  ``copy_to`` sums the cotangent, ``reduce_from`` passes it through.
* ``hierarchical_allreduce`` on a (cross 2, local 2) world from
  ``init(hierarchical=True)`` against the flat sum and average, fp32 on a
  1/64 grid (exact in any order) and int32 (floor division), with a size
  that needs padding; another op raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from horovod_tpu import _compat
from horovod_tpu.models.transformer import dot_product_attention as jattn
from horovod_tpu.ops.pallas_kernels import combine_blocks as jcombine
from horovod_tpu.parallel import ep as jep
from horovod_tpu.parallel import pp as jpp
from horovod_tpu.parallel import sp as jsp
from horovod_tpu.parallel import tp as jtp
from horovod_tpu_torch import context
from horovod_tpu_torch.ops.flash_attention import combine_blocks

import torch_parallel_ranks as ranks
from torch_parallel_ranks import RING_CASES, WORLD

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _ring_id(case):
    impl, causal, d = case
    return f"{impl}-{'causal' if causal else 'full'}-d{d}"


def _stage(params, x):
    """``torch_parallel_ranks.stage`` in JAX."""
    w, b = params
    return jnp.tanh(x @ w + b)

@pytest.fixture(scope="module")
def port():
    return context.spawn_gloo(WORLD, ranks.parallel_world)


def _jmesh(names, shape):
    devs = np.asarray(jax.devices("cpu")[:int(np.prod(shape))])
    return JMesh(devs.reshape(shape), names)


def _smap(fn, mesh, in_specs, out_specs):
    return jax.jit(_compat.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


# ---------------------------------------------------------------- combine


def _combine_inputs(case):
    rs = np.random.RandomState(3)
    b, s, h, d = 2, 5, 3, 4
    oa, oi = rs.standard_normal((2, b, s, h, d)).astype(np.float32)
    la, li = rs.standard_normal((2, b, h, s)).astype(np.float32) * 3
    cot_o = rs.standard_normal((b, s, h, d)).astype(np.float32)
    cot_l = rs.standard_normal((b, h, s)).astype(np.float32)
    if case in ("acc", "both"):
        la[:, :, 1:3] = -np.inf
    if case in ("hop", "both"):
        li[:, :, 2:4] = -np.inf
    return oa, la, oi, li, cot_o, cot_l


@pytest.mark.parametrize("case", ["finite", "acc", "hop", "both"])
def test_combine_blocks_matches_the_reference(case):
    oa, la, oi, li, cot_o, cot_l = _combine_inputs(case)
    want_o, want_l = jcombine(*(jnp.asarray(x) for x in (oa, la, oi, li)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (oa, la, oi, li)]
    got_o, got_l = combine_blocks(*ts)
    np.testing.assert_allclose(got_o.detach().numpy(), want_o, atol=1e-6)
    np.testing.assert_array_equal(np.isneginf(got_l.detach().numpy()),
                                  np.isneginf(want_l))
    fin = np.isfinite(np.asarray(want_l))
    np.testing.assert_allclose(got_l.detach().numpy()[fin],
                               np.asarray(want_l)[fin], atol=1e-6)
    # The gradient of out and of the finite lse rows.
    cl = np.where(fin, cot_l, 0).astype(np.float32)
    (got_o * torch.from_numpy(cot_o)).sum().add(
        (torch.where(got_l.isfinite(), got_l, 0) * torch.from_numpy(cl))
        .sum()).backward()
    grads = [t.grad.numpy() for t in ts]
    assert all(np.isfinite(g).all() for g in grads)

    def loss(*xs):
        o, l = jcombine(*xs)
        return jnp.sum(o * cot_o) + jnp.sum(jnp.where(fin, l, 0) * cl)

    want_g = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (oa, la, oi, li)))
    for g, w in zip(grads, want_g):
        w = np.asarray(w)
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], atol=1e-5)
        # Where the reference's gradient is NaN, the row has no keys on
        # that side: the port passes zero.
        assert not (g[~ok] != 0).any()


# ------------------------------------------------------------------ rings


@pytest.fixture(scope="module")
def ring_refs():
    mesh = _jmesh(("sp",), (WORLD,))
    spec = P(None, "sp")
    refs = {}
    for case in RING_CASES:
        impl, causal, d = case
        q, k, v, cot = ranks.qkv(2, d, seed=d + causal)
        fn = _smap(lambda a, b, c: jsp.ring_attention(
            a, b, c, axis="sp", causal=causal, use_flash=impl == "flash",
            block_q=8, block_k=8), mesh, (spec,) * 3, spec)
        refs[case] = (np.asarray(fn(q, k, v)), _dense_grads(q, k, v, cot,
                                                             causal))
    for causal in (False, True):
        q, k, v, cot = ranks.qkv(8, 16, seed=7 + causal)
        fn = _smap(lambda a, b, c: jsp.ulysses_attention(
            a, b, c, axis="sp", causal=causal), mesh, (spec,) * 3, spec)
        refs[("ulysses", causal)] = (np.asarray(fn(q, k, v)),
                                     _dense_grads(q, k, v, cot, causal))
    return refs


def _dense_grads(q, k, v, cot, causal):
    def loss(a, b, c):
        return jnp.sum(jattn(a, b, c, causal=causal) * cot)

    with jax.default_matmul_precision("highest"):
        return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            q, k, v)]


def _gathered(port, key, sub, i):
    return np.concatenate([p[key][sub][i] for p in port], axis=1)


@pytest.mark.parametrize("case", RING_CASES, ids=_ring_id)
def test_ring_attention_forward_matches_the_reference(port, ring_refs, case):
    got = _gathered(port, "ring", case, 0)
    np.testing.assert_allclose(got, ring_refs[case][0], atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("case", RING_CASES, ids=_ring_id)
def test_ring_attention_gradients_match_dense(port, ring_refs, case):
    for i, want in enumerate(ring_refs[case][1], start=1):
        _close(_gathered(port, "ring", case, i), want, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_forward_matches_the_reference(port, ring_refs, causal):
    got = _gathered(port, "ulysses", causal, 0)
    np.testing.assert_allclose(got, ring_refs[("ulysses", causal)][0],
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_gradients_match_dense(port, ring_refs, causal):
    for i, want in enumerate(ring_refs[("ulysses", causal)][1], start=1):
        _close(_gathered(port, "ulysses", causal, i), want, GRAD_TOL)


# ----------------------------------------------------- diff collectives


def test_ppermute_backward_is_the_inverse_permutation(port):
    rs = np.random.RandomState(50)
    xs, cs = rs.standard_normal((2, WORLD, 4, 8, 6)).astype(np.float32)
    for r, p in enumerate(port):
        y, gx = p["diff"]["ppermute"]
        np.testing.assert_array_equal(y, xs[(r - 1) % WORLD])
        np.testing.assert_array_equal(gx, cs[(r + 1) % WORLD])


def test_all_to_all_backward_swaps_its_axes(port):
    rs = np.random.RandomState(50)
    xs, cs = rs.standard_normal((2, WORLD, 4, 8, 6)).astype(np.float32)
    want_y = ranks.a2a(xs)
    cots = [ranks.a2a_cot(cs, r) for r in range(WORLD)]
    for r, p in enumerate(port):
        y, gx = p["diff"]["all_to_all"]
        np.testing.assert_array_equal(y, want_y[r])
        # x's chunk j went to rank j, at columns [6r, 6r + 6) of its output.
        want_g = np.concatenate(
            [cots[j][:, :, 6 * r:6 * r + 6] for j in range(WORLD)], 0)
        np.testing.assert_array_equal(gx, want_g)


def test_copy_to_sums_and_reduce_from_passes_the_cotangent(port):
    rs = np.random.RandomState(50)
    xs, cs = rs.standard_normal((2, WORLD, 4, 8, 6)).astype(np.float32)
    for r, p in enumerate(port):
        y, gx = p["diff"]["copy_to"]
        np.testing.assert_array_equal(y, xs[r])
        np.testing.assert_allclose(gx, cs.sum(0), rtol=1e-6, atol=1e-6)
        y, gx = p["diff"]["reduce_from"]
        np.testing.assert_allclose(y, xs.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(gx, cs[r])


# ------------------------------------------------------ tensor parallel


def test_tp_mlp_forward_matches_the_reference(port):
    a = {k: np.asarray(v, np.float32) for k, v in ranks.mlp_inputs().items()}
    fn = _smap(lambda x, wu, bu, wd, bd: jtp.tp_mlp(x, wu, bu, wd, bd,
                                                    axis="tp"),
               _jmesh(("tp",), (2,)),
               (P(), P(None, "tp"), P("tp"), P("tp"), P()), P())
    want = np.asarray(fn(a["x"], a["w_up"], a["b_up"], a["w_down"],
                         a["b_down"]))
    for p in port:
        np.testing.assert_allclose(p["tp_mlp"][0], want, rtol=2e-5,
                                   atol=2e-5)


def test_tp_mlp_gradients_match_dense(port):
    a = {k: np.asarray(v, np.float32) for k, v in ranks.mlp_inputs().items()}

    def loss(x, wu, bu, wd, bd):
        h = jnp.maximum(x @ wu + bu, 0)
        return jnp.sum((h @ wd + bd) * a["cot"])

    with jax.default_matmul_precision("highest"):
        gx, gwu, gbu, gwd, gbd = (np.asarray(g) for g in jax.grad(
            loss, argnums=tuple(range(5)))(a["x"], a["w_up"], a["b_up"],
                                           a["w_down"], a["b_down"]))
    for rank, p in enumerate(port):
        t = rank % 2  # the tp coordinate on the dp 2 x tp 2 mesh
        _, px, pwu, pbu, pwd, pbd = p["tp_mlp"]
        _close(px, gx, 1e-5)  # whole on every rank: copy_to's sum
        for got, want in zip((pwu, pbu, pwd),
                             ranks.mlp_shards(dict(w_up=gwu, b_up=gbu,
                                              w_down=gwd), t)):
            _close(got, want, 1e-5)
        _close(pbd, gbd, 1e-5)


# --------------------------------------------------------------- pipeline


def test_pipeline_forward_matches_the_reference(port):
    a = {k: np.asarray(v, np.float32) for k, v in ranks.pipe_inputs().items()}
    fn = _smap(lambda w, b, mb: jpp.pipeline(_stage, (w[0], b[0]), mb,
                                             axis="pp"),
               _jmesh(("pp",), (WORLD,)), (P("pp"), P("pp"), P()), P())
    want = np.asarray(fn(a["w"], a["b"], a["mb"]))
    for p in port:
        np.testing.assert_allclose(p["pipeline"][0], want, rtol=1e-5,
                                   atol=1e-6)


def test_pipeline_gradients_match_the_sequential_composition(port):
    a = {k: np.asarray(v, np.float32) for k, v in ranks.pipe_inputs().items()}

    def loss(w, b, mb):
        x = mb
        for s in range(WORLD):
            x = _stage((w[s], b[s]), x)
        return jnp.sum(x * a["cot"])

    with jax.default_matmul_precision("highest"):
        gw, gb, gmb = (np.asarray(g) for g in jax.grad(
            loss, argnums=(0, 1, 2))(a["w"], a["b"], a["mb"]))
    for s, p in enumerate(port):
        _, pw, pb, pmb = p["pipeline"]
        _close(pw, gw[s], 1e-5)
        _close(pb, gb[s], 1e-5)
        if s == 0:
            _close(pmb, gmb, 1e-5)
        else:
            assert not pmb.any()


# ----------------------------------------------------------------- experts


def test_switch_moe_stacked_matches_the_dense_routing_oracle(port):
    a = ranks.moe_inputs()
    n, t, d, e_local = WORLD, 16, 8, 2
    e_total = n * e_local
    x, gate, w = a["x"], a["gate"], a["w"]
    # tests/test_parallel_transformer.py's oracle at 4 ranks.
    capacity = int(np.ceil(t / e_total * 2.0))
    expected = np.zeros((n * t, d), np.float32)
    disp, comb = [], []
    for s in range(n):
        ds, cs, _ = jep.top1_dispatch(x[s * t:(s + 1) * t] @ gate, capacity)
        disp.append(np.asarray(ds))
        comb.append(np.asarray(cs))
    for e in range(e_total):
        inp = np.concatenate([np.einsum("tc,td->cd", disp[s][:, e, :],
                                        x[s * t:(s + 1) * t])
                              for s in range(n)])
        out_e = np.einsum("gd,dk->gk", np.tanh(inp), w[e]).reshape(
            n, capacity, d)
        for s in range(n):
            expected[s * t:(s + 1) * t] += np.einsum(
                "tc,cd->td", comb[s][:, e, :], out_e[s])
    got = np.concatenate([p["moe"][0] for p in port])
    np.testing.assert_allclose(got, expected, atol=1e-4)
    # The aux loss: the reference's, averaged over the axis.
    fn = _smap(lambda xs, ws: jep.switch_moe_stacked(
        xs, gate, lambda wl, toks: jnp.einsum("egd,edk->egk", jnp.tanh(toks),
                                              wl), ws, axis="ep",
        capacity_factor=2.0)[1], _jmesh(("ep",), (WORLD,)),
        (P("ep"), P("ep")), P())
    want_aux = float(fn(x, w))
    for p in port:
        np.testing.assert_allclose(p["moe"][1], want_aux, rtol=1e-6)


def test_switch_moe_one_expert_a_rank_routes_by_the_gate(port):
    a = ranks.moe_inputs()
    x, gate = a["x"], a["gate1"]
    logits = x @ gate
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    e, pmax = probs.argmax(-1), probs.max(-1)
    expected = x * (pmax * (e + 1))[:, None]  # capacity 8.0: no drops
    got = np.concatenate([p["moe"][2] for p in port])
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)
    assert all(p["moe"][3] > 0 for p in port)


# ------------------------------------------------------------ hierarchical


@pytest.mark.parametrize("op", ["sum", "average"])
def test_hierarchical_allreduce_matches_the_flat_reduction(port, op):
    f = np.stack([ranks.grid((13,), 70 + r) for r in range(WORLD)])
    i = np.stack([np.arange(5, dtype=np.int32) * 3 + r
                  for r in range(WORLD)])
    want_f = f.sum(0) if op == "sum" else f.sum(0) / WORLD
    want_i = i.sum(0) if op == "sum" else i.sum(0) // WORLD
    for p in port:
        np.testing.assert_array_equal(p["hier"][(op, "f32")], want_f)
        got_i = p["hier"][(op, "i32")]
        assert got_i.dtype == np.int32
        np.testing.assert_array_equal(got_i, want_i)
    assert all(p.get("hier_max_raises") for p in port)
