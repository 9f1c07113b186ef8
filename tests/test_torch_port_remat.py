"""The port's selective rematerialization (horovod_tpu_torch.ops.remat) held
against the JAX package's ``ops/remat.py`` on the CPU: the twins of
``tests/test_remat.py`` that need no overlap (the resolver, the
``make_train_step(remat=)`` knob, the model-config plumbing, the
``HVDTPU_REMAT`` default).

Remat changes when intermediates are computed, never what: on the port,
every policy's gradients and trajectory equal ``remat="none"``'s bit for
bit. Against the JAX package the port's ``none`` trajectory is held to the
JAX ``remat="none"`` one (whose remat cases are red under the installed
jax, its analysis plane failing to import): Adam steps of fp32 gradients
taken in another summation order, within 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.ops import remat as jremat
from horovod_tpu.parallel import dp as jdp
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch import convert
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.models import (GPT2Config, GPT2LMModel, MoEConfig,
                                      SwitchTransformerLM)
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops import remat as tremat
from horovod_tpu_torch.parallel import dp as tdp
from horovod_tpu_torch.utils import env as tenv

POLICIES = ("full", "dots_saveable", "dots_with_no_batch_dims_saveable",
            "everything_saveable", "nothing_saveable")


# -- resolver -------------------------------------------------------------


def test_resolve_policy_mapping():
    assert tremat.POLICY_NAMES == jremat.POLICY_NAMES
    for off in (None, False, "none", "", "off"):
        assert tremat.resolve_policy(off) == (False, None)
        assert jremat.resolve_policy(off) == (False, None)
    for full in (True, "full"):
        assert tremat.resolve_policy(full) == (True, None)
    for name in tremat.POLICY_NAMES:
        enabled, pol = tremat.resolve_policy(name)
        assert enabled and callable(pol)
        assert jremat.resolve_policy(name)[0]
    custom = tremat.resolve_policy("dots_saveable")[1]
    assert tremat.resolve_policy(custom) == (True, custom)


@pytest.mark.parametrize("bad,err", [("dots_savable", ValueError),
                                     ("dots", ValueError),
                                     (3.14, TypeError)])
def test_resolve_policy_rejects_typos_like_the_reference(bad, err):
    with pytest.raises(err):
        jremat.resolve_policy(bad)
    with pytest.raises(err):
        tremat.resolve_policy(bad)


def test_env_default(monkeypatch):
    monkeypatch.delenv("HVDTPU_REMAT", raising=False)
    assert tenv.remat_mode() == jenv.remat_mode() == ""
    for val in ("off", "dots_saveable", "FULL"):
        monkeypatch.setenv("HVDTPU_REMAT", val)
        assert tenv.remat_mode() == jenv.remat_mode()


# -- train-step knob ------------------------------------------------------


def _params():
    rng = np.random.RandomState(0)
    return {"w1": rng.randn(4, 8).astype(np.float32),
            "w2": rng.randn(8, 3).astype(np.float32)}


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(16, 4).astype(np.float32),
            rng.randn(16, 3).astype(np.float32))


def _loss(params, batch):
    x, y = batch
    pred = torch.tanh(x @ params["w1"]) @ params["w2"]
    return torch.mean((pred - y) ** 2)


def _jloss(params, batch):
    x, y = batch
    pred = jnp.tanh(x @ params["w1"]) @ params["w2"]
    return jnp.mean((pred - y) ** 2)


def _port_run(remat, sharded, steps=3, **kw):
    step, opt = tdp.make_train_step(_loss, topt.adamw(1e-2), device="cpu",
                                    sharded=sharded, remat=remat, **kw)
    st = tdp.init_state({k: torch.from_numpy(v.copy())
                         for k, v in _params().items()}, opt)
    for i in range(steps):
        st, loss = step(st, tuple(torch.from_numpy(a)
                                  for a in _batch(seed=i)))
        assert np.isfinite(float(loss))
    return {k: v.detach().numpy().copy() for k, v in st.params.items()}


@pytest.fixture(scope="module")
def jax_none_trajectory():
    import horovod_tpu as hvd

    hvd.init(devices=jax.devices("cpu")[:8])
    try:
        step, opt = jdp.make_train_step(_jloss, optax.adamw(1e-2),
                                        remat="none")
        st = jdp.init_state(jax.tree.map(jnp.asarray, _params()), opt)
        for i in range(3):
            st, _ = step(st, tuple(jnp.asarray(a) for a in _batch(seed=i)))
        return jax.tree.map(np.asarray, st.params)
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "zero1"])
def test_remat_policies_keep_the_trajectory(sharded, jax_none_trajectory):
    """Every policy reproduces the remat-off parameters exactly; the off
    run matches the JAX package's remat="none" world of 8."""
    finals = {pol: _port_run(pol, sharded) for pol in ("none",) + POLICIES}
    for pol in POLICIES:
        for k, want in finals["none"].items():
            np.testing.assert_array_equal(finals[pol][k], want, err_msg=pol)
    for k, want in jax_none_trajectory.items():
        np.testing.assert_allclose(finals["none"][k], want, atol=1e-6,
                                   rtol=0)


def test_remat_env_arms_train_step(monkeypatch):
    """HVDTPU_REMAT=dots_saveable with remat unset checkpoints the loss:
    its forward runs again in the backward; an explicit "none" wins."""
    calls = []

    def loss(params, batch):
        calls.append(1)
        return _loss(params, batch)

    def run(**kw):
        calls.clear()
        step, opt = tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu",
                                        **kw)
        st = tdp.init_state({k: torch.from_numpy(v.copy())
                             for k, v in _params().items()}, opt)
        st, l_ = step(st, tuple(torch.from_numpy(a) for a in _batch()))
        assert np.isfinite(float(l_))
        return len(calls)

    monkeypatch.delenv("HVDTPU_REMAT", raising=False)
    assert run() == 1
    monkeypatch.setenv("HVDTPU_REMAT", "dots_saveable")
    assert run() == 2
    assert run(remat="none") == 1
    monkeypatch.setenv("HVDTPU_REMAT", "dots_savable")
    with pytest.raises(ValueError):
        run()


def test_remat_typo_raises_at_build():
    with pytest.raises(ValueError):
        tdp.make_train_step(_loss, topt.adamw(1e-2), device="cpu",
                            remat="dots")


def test_remat_composes_with_accum():
    for sharded in (False, True):
        want = _port_run("none", sharded, accum_steps=2)
        got = _port_run("dots_saveable", sharded, accum_steps=2)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# -- model-zoo plumbing ---------------------------------------------------


def _gpt2_grads(remat, **kw):
    cfg = GPT2Config.tiny(remat=remat, param_dtype=torch.float32, **kw)
    m = GPT2LMModel(cfg, device="cpu")
    m.load_state_dict(convert.init_params(cfg, seed=0))
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 16)))
    logits = m(toks)
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(logits.float().sum(), list(m.parameters()))
    return logits.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("pol", [True, "dots_saveable", "nothing_saveable"])
def test_transformer_config_remat_policies(pol):
    """Per-block remat: the forward and every gradient equal remat off's
    bit for bit (bf16 compute, fp32 master weights)."""
    want_l, want_g = _gpt2_grads(False)
    got_l, got_g = _gpt2_grads(pol)
    assert torch.equal(got_l, want_l)
    for name, g in want_g.items():
        assert torch.isfinite(g.float()).all()
        assert torch.equal(got_g[name], g), name


def test_per_block_remat_recomputes_each_block():
    cfg = GPT2Config.tiny(remat="dots_saveable", use_flash=True)
    m = GPT2LMModel(cfg, device="cpu")
    assert type(m.transformer.blocks[0]).__name__ == "RematBlock"
    assert isinstance(m.transformer.blocks[0], ttr.Block)
    assert list(m.state_dict()) == list(
        GPT2LMModel(GPT2Config.tiny(), device="cpu").state_dict())
    from horovod_tpu_torch.ops import flash_attention as fa

    calls = []
    orig = fa.flash_attention_reference

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    fa.flash_attention_reference = spy
    try:
        m(torch.zeros((1, 8), dtype=torch.long)).float().sum().backward()
    finally:
        fa.flash_attention_reference = orig
    # the forward, then each block's recompute in the backward
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    with torch.no_grad():  # no recompute without a backward
        m(torch.zeros((1, 8), dtype=torch.long))


def test_fp8_compute_under_remat_matches_remat_off():
    """fp8 compute: the fp8 state's gradients (the new amax rings and the
    weight residual) come out once and equal remat off's, as does every
    other gradient."""
    want_l, want_g = _gpt2_grads(False, compute_dtype="fp8")
    got_l, got_g = _gpt2_grads("dots_saveable", compute_dtype="fp8")
    assert torch.equal(got_l, want_l)
    fp8 = [n for n in want_g if ".fp8_" in n]
    assert fp8
    for name, g in want_g.items():
        assert torch.equal(got_g[name], g), name


def test_transformer_remat_matches_forward():
    cfg = GPT2Config.tiny(dtype=torch.float32)
    sd = convert.init_params(cfg, seed=1)
    m = GPT2LMModel(cfg, device="cpu")
    mr = GPT2LMModel(GPT2Config.tiny(dtype=torch.float32, remat=True),
                     device="cpu")
    m.load_state_dict(sd)
    mr.load_state_dict(sd)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with torch.no_grad():
        np.testing.assert_allclose(m(toks).numpy(), mr(toks).numpy(),
                                   atol=1e-5)


def test_moe_config_remat_policy():
    cfg = MoEConfig(vocab_size=64, max_len=32, d_model=32, n_heads=2,
                    n_layers=2, d_ff=64, num_experts=2,
                    remat="dots_saveable", use_flash=False)
    m = SwitchTransformerLM(cfg, device="cpu")
    m.load_state_dict(convert.init_moe_params(cfg, seed=0))
    logits, aux = m(torch.zeros((2, 8), dtype=torch.long))
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


def test_remat_typo_raises_in_the_model_config():
    with pytest.raises(ValueError):
        GPT2LMModel(GPT2Config.tiny(remat="dots"), device="cpu")


# -- the train step on parameters that are not the module's ---------------


def _gpt2_step_run(remat, tmp_path, steps=3, resumed=2):
    """``steps`` train steps of a per-block-remat GPT-2 on a parameter dict
    that is not the module's own (scaled copies), a checkpoint round trip
    (whose restored parameters are new tensors again), then ``resumed``
    more steps. Returns the parameters after each phase."""
    cfg = GPT2Config.tiny(remat=remat, param_dtype=torch.float32)
    m = GPT2LMModel(cfg, device="cpu")
    m.load_state_dict(convert.init_params(cfg, seed=0))
    params = {k: (v.detach() * 1.25).clone()
              for k, v in m.named_parameters()}
    rng = np.random.RandomState(3)

    def loss(p, toks):
        logits = torch.func.functional_call(m, p, (toks[:, :-1],))
        return torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            toks[:, 1:].reshape(-1))

    step, opt = tdp.make_train_step(loss, topt.adamw(1e-2), device="cpu")
    st = tdp.init_state(params, opt)
    batches = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 17)))
               for _ in range(steps + resumed)]
    for b in batches[:steps]:
        st, _ = step(st, b)
    before = {k: v.detach().clone() for k, v in st.params.items()}
    d = str(tmp_path / f"ckpt_{remat}")
    from horovod_tpu_torch import checkpoint as tckpt

    tckpt.save_checkpoint(d, st, step=steps)
    st = tckpt.restore_checkpoint(d, st)
    for b in batches[steps:]:
        st, _ = step(st, b)
    return before, {k: v.detach().clone() for k, v in st.params.items()}


@pytest.mark.parametrize("pol", [True, "dots_saveable"])
def test_per_block_remat_trains_the_state_params_not_the_modules(
        pol, tmp_path):
    """A remat block's recompute runs after functional_call has put the
    module's own parameters back: it must read the state's, before and
    after a checkpoint restore, or the gradients differ. Bit for bit
    against remat off over every step."""
    want = _gpt2_step_run(False, tmp_path)
    got = _gpt2_step_run(pol, tmp_path)
    for w, g in zip(want, got):
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_loss_level_remat_updates_batchnorm_statistics_once():
    """A whole-loss checkpoint runs the ResNet forward again in the
    backward; the running statistics take one momentum update a step, as
    the reference's functional batch_stats do, and every policy leaves the
    buffers and parameters of remat off bit for bit."""
    from horovod_tpu_torch.models import ResNet18

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(
        np.float32))
    y = torch.from_numpy(rng.randint(0, 4, (4,)))

    def run(remat):
        torch.manual_seed(0)
        m = ResNet18(num_classes=4, dtype=torch.float32, device="cpu")
        m.load_state_dict(convert.init_resnet_params(m, seed=0))
        m.train()

        def loss(p, batch):
            return torch.nn.functional.cross_entropy(
                torch.func.functional_call(m, p, (batch[0],)), batch[1])

        step, opt = tdp.make_train_step(loss, topt.adamw(1e-3),
                                        device="cpu", remat=remat)
        st = tdp.init_state({k: v.detach().clone()
                             for k, v in m.named_parameters()}, opt)
        start = {k: v.clone() for k, v in m.named_buffers()}
        st, _ = step(st, (x, y))
        return m, st, start

    m0, st0, start = run("none")
    # one update: ra = 0.9 ra + 0.1 batch, the batch statistics of the
    # first step's forward
    fresh = ResNet18(num_classes=4, dtype=torch.float32, device="cpu")
    fresh.load_state_dict(convert.init_resnet_params(fresh, seed=0))
    fresh.train()
    with torch.no_grad():
        fresh(x)
    for k, v in m0.named_buffers():
        assert torch.equal(v, dict(fresh.named_buffers())[k]), k
        assert not torch.equal(v, start[k]) or k.endswith("var"), k
    for pol in ("full", "dots_saveable"):
        m, st, _ = run(pol)
        for k, v in m0.named_buffers():
            assert torch.equal(dict(m.named_buffers())[k], v), (pol, k)
        for k, v in st0.params.items():
            assert torch.equal(st.params[k], v), (pol, k)
