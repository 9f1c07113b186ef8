"""Three train steps of GPT-2 tiny through the port's ``make_train_step``
held against the JAX package's, on a world of 2.

Both sides start from the same seeded flax parameters (fp32, attention
through the flash path: the JAX side runs its Pallas kernels in interpret
mode, the port its ``FlashAttention`` Function, whose CPU forward and
backward are the kernels' plain versions) and take the same global batch of
4 sequences, rank r rows ``[2r, 2r + 2)``. The port runs on a gloo world of
2 CPU processes (``context.spawn_gloo``); the JAX package's step is one
SPMD program on 2 CPU devices (``hvd.init(devices=...)``). Three variants:
replicated AdamW (one fused allreduce), ZeRO-1 sharded with the unfused
update, and ZeRO-1 with the fused AdamW update (the kernel's plain version
on the port's side, ``_fused_adamw_update_jax`` on the JAX side).

Tolerances, with their reasons:

* losses: 2e-5 relative -- fp32 on both sides, summed in other orders;
* parameters: each leaf's movement ``p - p0`` within 1e-2 of the
  reference's movement in L2 norm. Adam divides by ``sqrt(v)``, so a
  gradient element near zero turns fp32 summation noise into a step of up
  to ``lr``: elementwise bounds would have to allow the whole step. The
  key-projection bias is left out of this check: its exact gradient is
  zero (a constant added to every key of a row cancels in the softmax),
  so both sides move it by noise alone; it is held to the ``lr``-per-step
  bound every parameter obeys;
* the two port ranks end with identical parameters (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu as hvd
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.optimizer import fused_adamw as jax_fused_adamw
from horovod_tpu.parallel import dp as jdp
from horovod_tpu_torch import context, convert
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.parallel import dp as tdp

WORLD = 2
STEPS = 3
LR = 1e-2
VARIANTS = ["replicated", "sharded", "sharded_fused"]
_KW = {
    "replicated": dict(sharded=False),
    "sharded": dict(sharded=True, fused_update=False),
    "sharded_fused": dict(sharded=True, fused_update=True),
}


def _data():
    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2 * WORLD, 33)
    ).astype(np.int32)
    params = jgpt2.GPT2LMModel(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:1, :32])
    )["params"]
    return jax.tree.map(np.asarray, params), tokens


def _port_train(params, tokens):
    """One rank of the gloo world: every variant, from the same start."""
    rank = context.rank()
    rows = torch.from_numpy(tokens[2 * rank:2 * rank + 2]).long()
    out = {}
    for variant in VARIANTS:
        cfg = GPT2Config.tiny(dtype=torch.float32, use_flash=True)
        model = GPT2LMModel(cfg, device="cpu")
        model.load_state_dict(convert.params_from_flax({"params": params}))

        def loss_fn(p, t, model=model):
            logits = torch.func.functional_call(model, p, (t[:, :-1],))
            return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

        opt = (topt.adamw(LR) if variant == "replicated"
               else topt.fused_adamw(LR))
        step, wopt = tdp.make_train_step(loss_fn, opt, device="cpu",
                                         **_KW[variant])
        state = tdp.init_state(model, wopt)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, rows)
            losses.append(float(loss))
        assert int(state.step) == STEPS
        out[variant] = (
            losses, convert.params_to_flax(state.params, cfg.n_heads)["params"]
        )
    return out


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def port_runs(data):
    return context.spawn_gloo(WORLD, _port_train, *data)


@pytest.fixture(scope="module")
def jax_runs(data):
    params, tokens = data
    hvd.init(devices=jax.devices("cpu")[:WORLD])
    try:
        cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, use_flash=True)
        model = jgpt2.GPT2LMModel(cfg)

        def loss_fn(p, batch):
            (t,) = batch
            logits = model.apply({"params": p}, t[:, :-1])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, t[:, 1:]
            ).mean()

        out = {}
        for variant in VARIANTS:
            opt = (optax.adamw(LR, weight_decay=1e-4)
                   if variant == "replicated" else jax_fused_adamw(LR))
            step, wopt = jdp.make_train_step(loss_fn, opt, **_KW[variant])
            state = jdp.init_state(jax.tree.map(jnp.array, params), wopt)
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, (jnp.asarray(tokens),))
                losses.append(float(loss))
            out[variant] = (losses, jax.tree.map(np.asarray, state.params))
        return out
    finally:
        hvd.shutdown()


def _leaves(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_steps_match_the_reference(data, port_runs, jax_runs, variant):
    p0 = _leaves(data[0])
    want_losses, want = jax_runs[variant]
    got_losses, got = port_runs[0][variant]
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-5)
    assert got_losses[-1] < got_losses[0]
    want, got = _leaves(want), _leaves(got)
    assert sorted(got) == sorted(want) == sorted(p0)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        # Every parameter moves at most lr (1 + wd |p|) per step.
        assert np.abs(g - p0[name]).max() <= STEPS * LR * 1.01, name
        if "['key']['bias']" in name:
            continue
        moved = np.linalg.norm(w - p0[name])
        assert moved > 0, name
        err = np.linalg.norm((g - p0[name]) - (w - p0[name]))
        assert err <= 1e-2 * moved, (name, err, moved)


@pytest.mark.parametrize("variant", VARIANTS)
def test_ranks_end_with_identical_parameters(port_runs, variant):
    losses0, p0 = port_runs[0][variant]
    losses1, p1 = port_runs[1][variant]
    assert losses0 == losses1
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
        np.testing.assert_array_equal(a, b)
