"""The port's int8 activation storage (``ops/actquant.py``) held against
the JAX package's (``tests/test_act_quant.py``), on the CPU.

* The twins: ``boundary`` is the identity when off (and for integer
  inputs), rounds within the int8 block bound, keeps bf16, passes the
  gradient straight through; ``resolve_mode``; the backward holds int8
  payload and fp32 scales at every boundary; ``make_train_step(act_quant=
  "int8")`` trains, alone and with a base remat policy.
* ``boundary`` is bit for bit the reference's eager ``boundary`` (block
  256; fp32 and bf16, lengths with and without a ragged last block), and
  ResNet's ``[B, C, H, W]`` ``channels_last`` boundary bit for bit the
  reference's NHWC one: it quantizes in NHWC order.
* Gradients: the reference's own act-quant bound (5% of the plain
  gradient's norm) does not hold for its MLP on the CPU with jax 0.9
  (``test_act_quant_gradients_track_plain``: 0.01079 against 0.00870), so
  the port is held against the reference's act-quant gradients,
  ``jax.grad(actquant.checkpoint_fn(armed, "", "int8"))``: within 1e-5 of
  each leaf's largest gradient (fp32; both sides round the same
  activations to the same int8 values, and the products around them
  differ in fp32 rounding only).
* Tiny GPT-2, BERT, ViT, the Switch MoE, ResNet-18 and the MLP under
  ``activate("int8")``: each forward against the reference's under its
  ``activate("int8")``, at the models' parity tolerances
  (``test_torch_port_models.py``: 1e-4 absolute on fp32 logits of order
  one) -- ResNet-18 within 5e-2 relative L2: of its ~2e5 rounded
  activations, the two frameworks' fp32 noise flips a few int8 roundings
  by one step, and the convolutions carry such a step to the logits of its
  image (the NHWC boundary itself is held bit for bit above). The
  segmented backward (each segment recomputed from its held int8 input)
  gives the unsegmented act-quant backward's gradients bit for bit.
* Launch counts of the quantize and dequantize a step (the card's
  counts, here by a spy): L boundaries quantize L times; the forward
  dequantizes L times, and the backward once for every saved use of a
  boundary output (a segment's input, and what follows the last
  boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import bert as jbert
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.models import mlp as jmlp
from horovod_tpu.models import moe as jmoe
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models import vit as jvit
from horovod_tpu.ops import actquant as jaq
from horovod_tpu_torch import convert
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.models import (MLP, BertConfig, BertModel, GPT2Config,
                                      GPT2LMModel, MoEConfig, ResNet18,
                                      SwitchTransformerLM, ViT, ViTConfig)
from horovod_tpu_torch.ops import actquant as aq
from horovod_tpu_torch.parallel import dp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- boundary mechanics ------------------------------------------------------


def test_boundary_identity_when_off():
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 8).astype(
        np.float32))
    assert aq.active_mode() == ""
    assert aq.boundary(x) is x


def test_boundary_rounds_within_int8_block_bound():
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 32).astype(
        np.float32))
    with aq.activate("int8"):
        y = aq.boundary(x)
    assert y.dtype == x.dtype
    err = float((y - x).abs().max())
    assert 0 < err < float(x.abs().max()) / 127.0
    ids = torch.arange(5)
    with aq.activate("int8"):
        assert aq.boundary(ids) is ids


def test_boundary_preserves_bf16_dtype():
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 16).astype(
        np.float32)).bfloat16()
    with aq.activate("int8"):
        y = aq.boundary(x)
    assert y.dtype == torch.bfloat16


def test_ste_gradient_is_straight_through():
    x = torch.from_numpy(np.random.RandomState(3).randn(64).astype(
        np.float32)).requires_grad_()
    with aq.activate("int8"):
        deq = aq.boundary(x)
        (g,) = torch.autograd.grad((deq ** 2).sum(), [x])
    torch.testing.assert_close(g, 2 * deq.detach(), rtol=1e-5, atol=0)


def test_resolve_mode(monkeypatch):
    assert aq.resolve_mode("") == "" == jaq.resolve_mode("")
    assert aq.resolve_mode("int8") == "int8" == jaq.resolve_mode("int8")
    with pytest.raises(ValueError):
        aq.resolve_mode("int4")
    monkeypatch.setenv("HVDTPU_ACT_QUANT", "int8")
    assert aq.resolve_mode(None) == "int8" == jaq.resolve_mode(None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 50)],
                         ids=["whole-blocks", "ragged"])
def test_boundary_is_the_reference_eager_boundary_bit_for_bit(dtype, shape):
    x = (np.random.RandomState(4).standard_normal(shape) * 3).astype(
        np.float32)
    x[0, 0] = 0.0
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    with jaq.activate("int8"):
        want = np.asarray(jaq.boundary(jnp.asarray(x, jdt)).astype(
            jnp.float32))
    with aq.activate("int8"):
        got = aq.boundary(_t(x).to(tdt)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_resnet_boundary_quantizes_in_nhwc_order():
    x = np.random.RandomState(5).standard_normal((2, 6, 5, 16)).astype(
        np.float32)  # NHWC: 480 elements, two ragged 256-blocks
    x[1] *= 40.0  # blocks of another scale, so the order shows
    with jaq.activate("int8"):
        want = np.asarray(jaq.boundary(jnp.asarray(x)))
    nchw = _t(x.transpose(0, 3, 1, 2)).contiguous(
        memory_format=torch.channels_last)
    with aq.activate("int8"):
        got = aq.boundary(nchw, nhwc=True)
        flat_nchw = aq.boundary(nchw.contiguous())
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    # Flattening the logical NCHW tensor puts other elements in a block.
    assert not np.array_equal(flat_nchw.numpy().transpose(0, 2, 3, 1), want)


# -- held tensors and training ------------------------------------------------


def _mlp_setup(features=(32, 32), batch=16, dim=16, seed=0):
    jm = jmlp.MLP(features=features, num_classes=4)
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, dim).astype(np.float32)
    y = rng.randint(0, 4, size=(batch,)).astype(np.int32)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))["params"]

    def jloss(p, b):
        xs, ys = b
        logits = jm.apply({"params": p}, xs)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, ys).mean()

    tm = MLP(features=features, num_classes=4, in_features=dim, device="cpu")
    tm.load_state_dict(convert.mlp_params_from_flax(
        _np({"params": jparams})))

    def tloss(p, b):
        xs, ys = b
        return F.cross_entropy(torch.func.functional_call(tm, p, (xs,)), ys)

    return (jparams, (jnp.asarray(x), jnp.asarray(y)), jloss,
            tm, (_t(x), _t(y).long()), tloss)


def test_saved_activations_are_int8_payload_plus_scales(monkeypatch):
    *_, tm, batch, tloss = _mlp_setup()
    params = dict(tm.named_parameters())
    packed = []
    pack = aq._pack

    def spy(t):
        out = pack(t)
        packed.append((t, out))
        return out

    monkeypatch.setattr(aq, "_pack", spy)
    loss = aq.checkpoint_fn(tloss, "", "int8")(params, batch)
    held = [out for _, out in packed if isinstance(out, aq._Held)]
    # Boundary 0 (the second segment's input) and boundary 1 (the head's
    # input): int8 payload and fp32 scale vectors, one scale a block.
    assert len(held) == 2
    for h in held:
        assert h.q.dtype == torch.int8 and h.q.shape == (16 * 32,)
        assert h.s.dtype == torch.float32 and h.s.dim() == 1
        assert h.s.shape == (-(-16 * 32 // 256),)
    # No other full-precision [batch, features] activation is kept but the
    # network's input (the first segment's argument, as the reference's
    # residuals leave out its arguments).
    kept = [t for t, out in packed if isinstance(out, torch.Tensor)
            and t.shape == (16, 32) and t.dtype == torch.float32
            and not t.requires_grad]
    assert kept == []
    loss.backward()


def test_act_quant_step_trains():
    *_, tm, batch, tloss = _mlp_setup()
    step, opt = dp.make_train_step(tloss, topt.adamw(1e-2), device="cpu",
                                   act_quant="int8")
    state = dp.init_state(tm, opt)
    losses = []
    for _ in range(6):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_act_quant_gradients_hold_to_the_reference_act_quant_gradients():
    jparams, jbatch, jloss, tm, batch, tloss = _mlp_setup()

    def jarmed(p, b):
        with jaq.activate("int8"):
            return jloss(p, b)

    want = _np(jax.grad(jaq.checkpoint_fn(jarmed, "", "int8"))(jparams,
                                                                jbatch))
    params = dict(tm.named_parameters())
    _, _, got = dp.accumulate_gradients(
        aq.checkpoint_fn(tloss, "", "int8"), params, batch, 1)
    flat = convert.mlp_params_from_flax({"params": want})
    for name, w in flat.items():
        tol = 1e-5 * float(w.abs().max())
        torch.testing.assert_close(got[name], w, rtol=0, atol=tol)
    # The rounding is real: the plain gradients differ.
    _, _, plain = dp.accumulate_gradients(tloss, params, batch, 1)
    assert any(not torch.equal(plain[n], got[n]) for n in got)


def test_checkpoint_fn_composes_with_base_policy():
    *_, tm, batch, tloss = _mlp_setup()
    params = dict(tm.named_parameters())
    _, _, alone = dp.accumulate_gradients(
        aq.checkpoint_fn(tloss, "", "int8"), params, batch, 1)
    for remat in ("dots_saveable", "full"):
        _, _, both = dp.accumulate_gradients(
            aq.checkpoint_fn(tloss, remat, "int8"), params, batch, 1)
        for n in alone:
            assert torch.equal(alone[n], both[n]), (remat, n)
    step, opt = dp.make_train_step(tloss, topt.adamw(1e-2), device="cpu",
                                   act_quant="int8", remat="dots_saveable")
    state = dp.init_state(tm, opt)
    losses = []
    for _ in range(4):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


def test_launch_counts_follow_the_boundaries(monkeypatch):
    """bf16 GPT-2 tiny (2 blocks): 2 quantizes and 2 + 1 dequantizes a
    microbatch (the last boundary feeds an fp32 cast, which keeps no
    int8); fp32 MLP with 3 hidden layers: 3 quantizes, 3 + 2 + 1 (the
    head's saved input) dequantizes."""
    counts = {"quant": 0, "dequant": 0}
    q0, d0 = aq.quantize_blockwise, aq.dequantize_blockwise

    def q(*a, **k):
        counts["quant"] += 1
        return q0(*a, **k)

    def d(*a, **k):
        counts["dequant"] += 1
        return d0(*a, **k)

    monkeypatch.setattr(aq, "quantize_blockwise", q)
    monkeypatch.setattr(aq, "dequantize_blockwise", d)
    cfg = GPT2Config.tiny(dtype=torch.bfloat16, param_dtype=torch.float32)
    m = GPT2LMModel(cfg, device="cpu")
    m.load_state_dict(convert.init_params(cfg, seed=0))
    toks = _t(np.random.RandomState(6).randint(0, cfg.vocab_size, (4, 17)))

    def loss(p, t):
        lg = torch.func.functional_call(m, p, (t[:, :-1],))
        return F.cross_entropy(lg.flatten(0, 1), t[:, 1:].flatten())

    dp.accumulate_gradients(aq.checkpoint_fn(loss, "", "int8"),
                            dict(m.named_parameters()), toks, 2)
    assert counts == {"quant": 2 * 2, "dequant": 2 * (2 + 1)}
    counts.update(quant=0, dequant=0)
    *_, tm, batch, tloss = _mlp_setup(features=(32, 32, 32))
    dp.accumulate_gradients(aq.checkpoint_fn(tloss, "", "int8"),
                            dict(tm.named_parameters()), batch, 1)
    assert counts == {"quant": 3, "dequant": 3 + 2 + 1}


# -- the zoo under act-quant, against the reference ----------------------------


def _gpt2():
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, use_flash=False)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 16))
    jm = jgpt2.GPT2LMModel(jcfg)
    params = _np(jm.init(jax.random.PRNGKey(7), jnp.asarray(toks)))
    tm = GPT2LMModel(GPT2Config.tiny(dtype=torch.float32, use_flash=False),
                     device="cpu")
    tm.load_state_dict(convert.params_from_flax(params))
    return (lambda: jm.apply(params, jnp.asarray(toks)), tm,
            (_t(toks).long(),), {})


def _bert():
    jcfg = jbert.BertConfig.tiny(dtype=jnp.float32, use_flash=False)
    toks = np.random.RandomState(8).randint(0, jcfg.vocab_size, (2, 16))
    types = (np.arange(16)[None, :] >= 8).astype(np.int32).repeat(2, 0)
    jm = jbert.BertModel(jcfg)
    params = _np(jm.init(jax.random.PRNGKey(8), jnp.asarray(toks),
                         token_types=jnp.asarray(types)))
    tm = BertModel(BertConfig.tiny(dtype=torch.float32, use_flash=False),
                   device="cpu")
    tm.load_state_dict(convert.bert_params_from_flax(params))
    return (lambda: jm.apply(params, jnp.asarray(toks),
                             token_types=jnp.asarray(types)), tm,
            (_t(toks).long(),), {"token_types": _t(types).long()})


def _vit():
    cfg = jvit.ViTConfig.tiny(dtype=jnp.float32, use_flash=False)
    imgs = np.random.RandomState(9).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = jvit.ViT(cfg)
    params = _np(jm.init(jax.random.PRNGKey(9), jnp.asarray(imgs)))
    tm = ViT(ViTConfig.tiny(dtype=torch.float32, use_flash=False),
             device="cpu")
    tm.load_state_dict(convert.vit_params_from_flax(params))
    return (lambda: jm.apply(params, jnp.asarray(imgs)), tm,
            (_t(imgs.transpose(0, 3, 1, 2)),), {})


def _moe():
    base = dict(vocab_size=128, max_len=32, d_model=32, n_heads=2, n_layers=2,
                d_ff=64, num_experts=4)
    toks = np.random.RandomState(10).randint(0, 128, (2, 32))
    jm = jmoe.SwitchTransformerLM(jmoe.MoEConfig(dtype=jnp.float32,
                                                 use_flash=False, **base))
    params = _np(jm.init(jax.random.PRNGKey(10), jnp.asarray(toks)))
    tm = SwitchTransformerLM(MoEConfig(dtype=torch.float32, use_flash=False,
                                       **base), device="cpu")
    tm.load_state_dict(convert.moe_params_from_flax(params))
    return (lambda: jm.apply(params, jnp.asarray(toks))[0], tm,
            (_t(toks).long(),), {})


def _resnet():
    x = np.random.RandomState(11).standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    jm = jresnet.ResNet18(num_classes=10, dtype=jnp.float32)
    variables = _np(jm.init(jax.random.PRNGKey(11), jnp.asarray(x),
                            train=True))
    rs = np.random.RandomState(12)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "scale":
                tree[k] = (1 + 0.2 * rs.standard_normal(v.shape)).astype(
                    np.float32)
    fill(variables["params"])
    tm = ResNet18(num_classes=10, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.resnet_params_from_flax(tm, variables))
    tm.eval()
    return (lambda: jm.apply(variables, jnp.asarray(x), train=False), tm,
            (_t(x.transpose(0, 3, 1, 2)),), {})


def _mlp():
    x = np.random.RandomState(13).standard_normal((8, 20)).astype(np.float32)
    jm = jmlp.MLP(features=(32, 32), num_classes=10)
    params = _np(jm.init(jax.random.PRNGKey(13), jnp.asarray(x)))
    tm = MLP(features=(32, 32), num_classes=10, in_features=20, device="cpu")
    tm.load_state_dict(convert.mlp_params_from_flax(params))
    return lambda: jm.apply(params, jnp.asarray(x)), tm, (_t(x),), {}


ZOO = {"gpt2": _gpt2, "bert": _bert, "vit": _vit, "moe": _moe,
       "resnet": _resnet, "mlp": _mlp}


def _out(y):
    return y[0] if isinstance(y, tuple) else y


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_act_quant_matches_the_reference(name):
    jfwd, tm, args, kw = ZOO[name]()
    with jaq.activate("int8"):
        want = np.asarray(jfwd())
    plain = np.asarray(jfwd())
    params = dict(tm.named_parameters())
    with aq.activate("int8"):
        got = _out(torch.func.functional_call(tm, params, args, kw))
    got = got.detach().numpy()
    if name == "resnet":
        # ~2e5 rounded activations: the frameworks' fp32 noise flips a few
        # int8 roundings by one step (1/127 of a block's max), which the
        # convolutions carry to the logits of one image.
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 5e-2, rel
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert not np.array_equal(want, plain)  # the boundaries round
    # The segmented backward (int8 inputs rebuilt for each recompute)
    # gives the unsegmented act-quant backward's gradients bit for bit.
    leaves = list(params.values())
    with aq.activate("int8"):
        seg = torch.autograd.grad(_out(torch.func.functional_call(
            tm, params, args, kw)).square().mean(), leaves, allow_unused=True)
    aq_segment = aq.segment
    try:
        aq.segment = lambda m, *a, call=None, **k: (
            m(*a, **k) if call is None else call(*a, **k))
        with aq.activate("int8"):
            ref = torch.autograd.grad(_out(torch.func.functional_call(
                tm, params, args, kw)).square().mean(), leaves,
                allow_unused=True)
    finally:
        aq.segment = aq_segment
    for a, b in zip(seg, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name


def test_fp8_compute_with_act_quant_commits_each_amax_once():
    """compute_dtype="fp8" and act_quant="int8" together, as the JAX
    package composes them: the fp8 state rides the gradient, so a
    segment's recompute pushes no second amax -- after 3 steps every ring
    holds exactly 3 -- and the loss falls."""
    from horovod_tpu_torch.ops import fp8 as tf8

    cfg = GPT2Config.tiny(compute_dtype="fp8", param_dtype=torch.float32)
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(convert.init_params(cfg, seed=0))

    def loss(p, t):
        lg = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(lg.flatten(0, 1), t[:, 1:].flatten())

    step, opt = dp.make_train_step(loss, topt.adamw(1e-3), device="cpu",
                                   compute_dtype="fp8", act_quant="int8")
    state = dp.init_state(model, opt)
    tokens = _t(np.random.RandomState(14).randint(0, 512, (4, 33))).long()
    losses = []
    for _ in range(3):
        state, out = step(state, tokens)
        losses.append(float(out))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    rings = [v for n, v in state.params.items() if "_amax_history" in n]
    assert rings and all(int((r > 0).sum()) == 3 for r in rings)
    assert tf8.fp8_state_gauges(state.params)["fp8.amax_max"] > 0
