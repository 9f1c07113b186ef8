"""The port's model zoo (horovod_tpu_torch.models: MLP, BERT, ViT, ResNet,
the Switch MoE, and ``parallel.ep.top1_dispatch``) held against the JAX
package's, on the CPU: the twins of ``tests/test_models.py``.

Flax parameters from the JAX model's ``init`` reach the port through
``convert.*_params_from_flax``; the same numpy-seeded inputs go to both.
The JAX side runs plain attention (``use_flash=False``), as its CPU tests
do; the flash routing is held by a spy on the port's plain flash version
(``TestFlashAttentionRouting``). Tolerances, all fp32: 1e-4 absolute on
logits of order one (summation order only; ResNet at 64 x 64, where
its last BatchNorm still sees 16 positions a channel), 1e-5 on the
running statistics and on ``top1_dispatch``'s tensors; the SyncBN
gradients 1e-4 relative to each leaf's largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import bert as jbert
from horovod_tpu.models import mlp as jmlp
from horovod_tpu.models import moe as jmoe
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models import vit as jvit
from horovod_tpu.parallel import ep as jep
from horovod_tpu_torch import context, convert
from horovod_tpu_torch.models import (MLP, BertConfig, BertModel, GPT2Config,
                                      GPT2LMModel, MoEConfig, ResNet18,
                                      SwitchTransformerLM, ViT, ViTConfig)
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.models import vit as tvit
from horovod_tpu_torch.ops import conv as tconv
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel.ep import top1_dispatch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- MLP ------------------------------------------------------------------


def test_mlp_forward_matches_jax():
    x = np.random.RandomState(0).standard_normal((4, 28, 28)).astype(
        np.float32)
    jm = jmlp.MLP(features=(32,), num_classes=10)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = MLP(features=(32,), num_classes=10, in_features=28 * 28,
             device="cpu")
    tm.load_state_dict(convert.mlp_params_from_flax(_np(params)))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_make_train_step_mlp_converges():
    import torch.nn.functional as F

    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.parallel import dp

    m = MLP(features=(32,), num_classes=4, in_features=8, device="cpu")
    m.load_state_dict(convert.init_mlp_params(m, seed=0))
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x @ rng.randn(8, 4)).argmax(-1)

    def loss_fn(params, batch):
        xb, yb = batch
        logits = torch.func.functional_call(m, params, (xb,))
        return F.cross_entropy(logits, yb)

    step, opt = dp.make_train_step(loss_fn, topt.adamw(0.03, weight_decay=0.0),
                                   device="cpu")
    state = dp.init_state(m, opt)
    batch = (_t(x), _t(y).long())
    first = None
    for _ in range(40):
        state, loss = step(state, batch)
        first = float(loss) if first is None else first
    assert float(loss) < first / 3


# -- BERT -----------------------------------------------------------------


def _bert_pair(seed=0, num_labels=None, dtype="float32", **kw):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jbert.BertConfig.tiny(dtype=jdt, use_flash=False, **kw)
    toks = _tokens(seed, 2, 16, jcfg.vocab_size)
    types = (np.arange(16)[None, :] >= 8).astype(np.int32).repeat(2, 0)
    jm = jbert.BertModel(jcfg, num_labels=num_labels)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(toks),
                     token_types=jnp.asarray(types))
    tm = BertModel(BertConfig.tiny(dtype=tdt, use_flash=False, **kw),
                   num_labels=num_labels, device="cpu")
    tm.load_state_dict(convert.bert_params_from_flax(_np(params)))
    return jm, params, tm, toks, types


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_bert_mlm_matches_jax(masked):
    jm, params, tm, toks, types = _bert_pair(seed=1)
    mask = np.ones((2, 16), np.int32)
    mask[0, 11:] = 0
    mask[1, 5:] = 0
    kw = dict(attention_mask=mask) if masked else {}
    want = np.asarray(jm.apply(params, jnp.asarray(toks),
                               token_types=jnp.asarray(types),
                               **{k: jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        got = tm(_t(toks).long(), token_types=_t(types).long(),
                 **{k: _t(v) for k, v in kw.items()}).numpy()
    assert got.shape == (2, 16, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bert_classifier_matches_jax_and_the_mask_has_effect():
    jm, params, tm, toks, types = _bert_pair(seed=2, num_labels=3)
    half = np.asarray([[1] * 8 + [0] * 8, [1] * 16], np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(toks),
                               attention_mask=jnp.asarray(half)))
    with torch.no_grad():
        got = tm(_t(toks).long(), attention_mask=_t(half)).numpy()
        full = tm(_t(toks).long(),
                  attention_mask=torch.ones((2, 16), dtype=torch.int32))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # test_bert_attention_mask_effect: masking keys changes the answer.
    assert not np.allclose(full.numpy()[0], got[0])


def test_bert_bf16_within_the_serving_bound():
    jm, params, tm, toks, types = _bert_pair(seed=3, dtype="bfloat16")
    want = np.asarray(jm.apply(params, jnp.asarray(toks)), np.float32)
    with torch.no_grad():
        got = tm(_t(toks).long()).float().numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


# -- ViT ------------------------------------------------------------------


def test_vit_matches_jax():
    cfg = jvit.ViTConfig.tiny(dtype=jnp.float32, use_flash=False)
    imgs = np.random.RandomState(4).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = jvit.ViT(cfg)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(imgs))
    # pos_embed and cls are nonzero here so the test sees their layout.
    params = jax.tree.map(np.asarray, params)
    rs = np.random.RandomState(5)
    params["params"]["cls"] = rs.standard_normal((1, 1, 64)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(imgs)))
    tm = ViT(ViTConfig.tiny(dtype=torch.float32, use_flash=False),
             device="cpu")
    tm.load_state_dict(convert.vit_params_from_flax(params))
    with torch.no_grad():
        got = tm(_t(imgs.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vit_patch_padding_is_computed():
    # 30 / 8: flax SAME pads the patch conv (2 -> (1, 1)); 32 / 8 pads 0.
    assert tconv.same_padding(32, 8, 8) == (0, 0)
    assert tconv.same_padding(224, 16, 16) == (0, 0)
    assert tconv.same_padding(30, 8, 8) == (1, 1)
    cfg = jvit.ViTConfig.tiny(dtype=jnp.float32, use_flash=False,
                              image_size=30)
    imgs = np.random.RandomState(6).standard_normal((1, 30, 30, 3)).astype(
        np.float32)
    jm = jvit.ViT(cfg)
    params = _np(jm.init(jax.random.PRNGKey(6), jnp.asarray(imgs)))
    tm = ViT(ViTConfig.tiny(dtype=torch.float32, use_flash=False,
                            image_size=30), device="cpu")
    tm.load_state_dict(convert.vit_params_from_flax(params))
    with torch.no_grad():
        got = tm(_t(imgs.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, imgs)),
                               atol=1e-4, rtol=0)


# -- ResNet ---------------------------------------------------------------


def _resnet_pair(seed, x, **kw):
    jm = jresnet.ResNet18(num_classes=10, dtype=jnp.float32, **kw)
    variables = _np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                            train=True))
    tm = ResNet18(num_classes=10, dtype=torch.float32, device="cpu", **kw)
    return jm, variables, tm


def _nonzero_scales(variables, seed):
    """Every BatchNorm scale drawn away from its init (the zero-initialised
    ones would hide a residual branch)."""
    rs = np.random.RandomState(seed)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "scale":
                tree[k] = (1 + 0.2 * rs.standard_normal(v.shape)).astype(
                    np.float32)
    fill(variables["params"])
    return variables


@pytest.mark.parametrize("s2d", [False, True], ids=["stem7x7", "s2d"])
def test_resnet18_train_mode_matches_jax_with_batch_stats(s2d):
    # 4 images of 64 x 64: the last stage normalizes over 16 positions (a
    # batch of 2 at 32 x 32 leaves 2, where the statistics amplify fp32
    # rounding past any fixed bound).
    x = np.random.RandomState(7).standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    jm, variables, tm = _resnet_pair(7, x, conv0_space_to_depth=s2d)
    variables = _nonzero_scales(variables, 8)
    want, updates = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    tm.load_state_dict(convert.resnet_params_from_flax(tm, variables))
    tm.train()
    xt = _t(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        got = tm(xt).numpy()
    assert got.shape == (4, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    # batch_stats after the train-mode forward: the port's buffers.
    new = convert.resnet_params_from_flax(
        tm, {"params": variables["params"],
             "batch_stats": _np(updates["batch_stats"])})
    sd = tm.state_dict()
    for k in new:
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    # Eval mode normalizes with the running statistics and mutates none.
    variables["batch_stats"] = _np(updates["batch_stats"])
    want_eval = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm.eval()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        got_eval = tm(xt).numpy()
    np.testing.assert_allclose(got_eval, want_eval, atol=1e-4, rtol=0)
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())
    if s2d:
        assert tm.conv_init.weight.shape == (64, 12, 4, 4)


def test_resnet_conv0_space_to_depth_equivalent():
    """The s2d stem (4x4 s1 conv on 2x2-blocked input) computes exactly the
    7x7-s2 stem when its weights are the re-blocked 7x7 kernel, in the
    port's NCHW layout; and the port's space_to_depth is the JAX one's."""
    from jax import lax

    from horovod_tpu.models.resnet import space_to_depth as jstd

    rs = np.random.RandomState(9)
    x = rs.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w7 = rs.standard_normal((7, 7, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tresnet.space_to_depth(_t(x.transpose(0, 3, 1, 2))).numpy(),
        np.asarray(jstd(jnp.asarray(x), 2)).transpose(0, 3, 1, 2))
    y_ref = np.asarray(lax.conv_general_dilated(
        x, w7, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    w8 = np.pad(w7, ((0, 1), (0, 1), (0, 0), (0, 0)))
    w4 = w8.reshape(4, 2, 4, 2, 3, 8).transpose(0, 2, 1, 3, 4, 5).reshape(
        4, 4, 12, 8)
    conv = tresnet.Conv(12, 8, 4, 1, dtype=torch.float32, device="cpu",
                        padding=((1, 2), (1, 2)))
    with torch.no_grad():
        conv.weight.copy_(_t(w4.transpose(3, 2, 0, 1)))
        y = conv(tresnet.space_to_depth(_t(x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), y_ref,
                               atol=1e-4)


def test_same_padding_is_asymmetric_at_224():
    """flax SAME at 224: the 7x7/2 stem pads (2, 3), a 3x3/2 conv at 56
    (0, 1), the 3x3/2 max-pool at 112 (0, 1) with -inf; the port's stem
    conv and max-pool equal JAX's at 224."""
    from jax import lax

    assert tconv.same_padding(224, 7, 2) == (2, 3)
    assert tconv.same_padding(56, 3, 2) == (0, 1)
    assert tconv.same_padding(112, 3, 2) == (0, 1)
    assert tconv.same_padding(56, 1, 2) == (0, 0)
    assert tconv.same_padding(56, 3, 1) == (1, 1)
    rs = np.random.RandomState(10)
    x = rs.standard_normal((1, 224, 224, 3)).astype(np.float32)
    w = rs.standard_normal((7, 7, 3, 4)).astype(np.float32)
    want = lax.conv_general_dilated(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want_pool = np.asarray(jax.numpy.asarray(
        __import__("flax.linen", fromlist=["max_pool"]).max_pool(
            want, (3, 3), strides=(2, 2), padding="SAME")))
    conv = tresnet.Conv(3, 4, 7, 2, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(_t(w.transpose(3, 2, 0, 1)))
        y = conv(_t(x.transpose(0, 3, 1, 2)))
        pooled = tconv.max_pool_same(y)
    assert y.shape == (1, 4, 112, 112) and pooled.shape == (1, 4, 56, 56)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(pooled.numpy().transpose(0, 2, 3, 1),
                               want_pool, atol=1e-4)
    # A symmetric padding=k//2 would shift the stem by one pixel.
    sym = torch.nn.functional.conv2d(_t(x.transpose(0, 3, 1, 2)),
                                     conv.weight, stride=2, padding=3)
    assert not np.allclose(sym.detach().numpy().transpose(0, 2, 3, 1),
                           np.asarray(want), atol=1e-2)


SYNC_X = np.random.RandomState(11).standard_normal((4, 64, 64, 3)).astype(
    np.float32)
SYNC_Y = np.asarray([1, 4, 7, 2])


def _syncbn_rank(variables):
    """One rank of a 2-rank gloo world: ResNet18 with a cross-replica
    BatchNorm on this rank's half of the batch; returns the logits, the
    running statistics and the gradients of this rank's mean loss."""
    import torch.nn.functional as F

    rank = context.rank()
    m = ResNet18(num_classes=10, dtype=torch.float32, axis_name="batch",
                 device="cpu")
    m.load_state_dict(convert.resnet_params_from_flax(m, variables))
    m.train()
    x = _t(SYNC_X[2 * rank:2 * rank + 2].transpose(0, 3, 1, 2))
    logits = m(x)
    loss = F.cross_entropy(logits, _t(SYNC_Y[2 * rank:2 * rank + 2]))
    loss.backward()
    return {"logits": logits.detach().numpy(),
            "buffers": {k: v.numpy() for k, v in m.named_buffers()},
            "grads": {k: p.grad.numpy() for k, p in m.named_parameters()}}


def test_syncbn_on_two_ranks_equals_the_full_batch():
    """SyncBN on a 2-rank gloo world with half the batch each equals the
    JAX ResNet18 on the full batch: logits, running statistics, and the
    mean over ranks of each rank's gradient the full-batch gradient."""
    import optax

    jm = jresnet.ResNet18(num_classes=10, dtype=jnp.float32)
    variables = _np(jm.init(jax.random.PRNGKey(12), jnp.asarray(SYNC_X),
                            train=True))
    variables = _nonzero_scales(variables, 13)

    def loss_fn(params):
        logits, upd = jm.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(SYNC_X), train=True,
                               mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(SYNC_Y)).mean()
        return loss, (logits, upd)

    (_, (want, upd)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    ranks = context.spawn_gloo(2, _syncbn_rank, variables)
    got = np.concatenate([r["logits"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    tm = ResNet18(num_classes=10, dtype=torch.float32, device="cpu")
    want_sd = convert.resnet_params_from_flax(
        tm, {"params": _np(jgrads), "batch_stats": _np(upd["batch_stats"])})
    for r in ranks:
        for k, v in r["buffers"].items():
            np.testing.assert_allclose(v, want_sd[k].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    for k in ranks[0]["grads"]:
        mean = (ranks[0]["grads"][k] + ranks[1]["grads"][k]) / 2
        w = want_sd[k].numpy()
        assert np.abs(mean - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-3), k


# -- Switch MoE -----------------------------------------------------------


def _moe_cfgs(**kw):
    base = dict(vocab_size=128, max_len=32, d_model=32, n_heads=2, n_layers=2,
                d_ff=64, num_experts=4)
    base.update(kw)
    return (jmoe.MoEConfig(dtype=jnp.float32, use_flash=False, **base),
            MoEConfig(dtype=torch.float32, use_flash=False, **base))


def test_top1_dispatch_matches_jax_and_breaks_ties_to_the_first():
    rs = np.random.RandomState(14)
    logits = rs.standard_normal((40, 4)).astype(np.float32)
    logits[3] = [1.0, 2.0, 2.0, 0.5]  # a tie between experts 1 and 2
    logits[7] = [3.0, 3.0, 3.0, 3.0]
    want = [np.asarray(a) for a in jep.top1_dispatch(jnp.asarray(logits), 8)]
    got = [a.numpy() for a in top1_dispatch(_t(logits), 8)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    assert got[0][3].sum(-1).argmax() == 1 and got[0][7].sum(-1).argmax() == 0
    # Past the capacity a token is dropped on both sides.
    assert got[0].sum() < 40 and got[0].sum() == want[0].sum()


def test_moe_forward_matches_jax_shapes_and_aux():
    jcfg, tcfg = _moe_cfgs()
    toks = _tokens(15, 2, 32, 128)
    jm = jmoe.SwitchTransformerLM(jcfg)
    params = _np(jm.init(jax.random.PRNGKey(15), jnp.asarray(toks)))
    jl, ja = jm.apply(params, jnp.asarray(toks))
    tm = SwitchTransformerLM(tcfg, device="cpu")
    tm.load_state_dict(convert.moe_params_from_flax(params))
    with torch.no_grad():
        tl, ta = tm(_t(toks).long())
    assert tl.shape == (2, 32, 128) and float(ta) > 0
    assert tm.blocks[1].moe.expert_in.shape == (4, 32, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-5)


def test_moe_trains():
    import torch.nn.functional as F

    _, tcfg = _moe_cfgs()
    tm = SwitchTransformerLM(tcfg, device="cpu")
    tm.load_state_dict(convert.init_moe_params(tcfg, seed=3))
    tokens = _t(_tokens(16, 4, 32, 128)).long()
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    losses = []
    for _ in range(30):
        logits, aux = tm(tokens)
        nll = F.cross_entropy(logits.flatten(0, 1),
                              torch.roll(tokens, -1, 1).flatten())
        loss = nll + tcfg.aux_loss_weight * aux
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] / 2, (losses[0], losses[-1])


def test_moe_every_one_is_all_moe_and_remat_matches():
    _, tcfg = _moe_cfgs(moe_every=1)
    tm = SwitchTransformerLM(tcfg, device="cpu")
    assert all(hasattr(b, "moe") for b in tm.blocks)
    sd = convert.init_moe_params(tcfg, seed=4)
    tm.load_state_dict(sd)
    _, rcfg = _moe_cfgs(moe_every=1, remat=True)
    rm = SwitchTransformerLM(rcfg, device="cpu")
    rm.load_state_dict(sd)
    toks = _t(_tokens(17, 2, 32, 128)).long()
    l1, a1 = tm(toks)
    l2, a2 = rm(toks)
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    g1 = torch.autograd.grad(l1.sum() + a1, list(tm.parameters()))
    g2 = torch.autograd.grad(l2.sum() + a2, list(rm.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


# -- flash routing --------------------------------------------------------


class TestFlashAttentionRouting:
    """Every transformer-family model of the port reaches the flash path
    through ``MultiHeadAttention`` (on the CPU its plain version, spied
    here); a dense attention mask takes plain attention instead, as in the
    JAX package."""

    @staticmethod
    def _count(monkeypatch):
        calls = {"n": 0}
        orig = fa.flash_attention_reference

        def spy(*a, **k):
            calls["n"] += 1
            return orig(*a, **k)

        monkeypatch.setattr(fa, "flash_attention_reference", spy)
        return calls

    def test_gpt2_routes_to_flash(self, monkeypatch):
        calls = self._count(monkeypatch)
        cfg = GPT2Config.tiny(use_flash=True)
        with torch.no_grad():
            GPT2LMModel(cfg, device="cpu")(torch.zeros((2, 16),
                                                       dtype=torch.long))
        assert calls["n"] == cfg.n_layers

    def test_bert_routes_to_flash_without_mask(self, monkeypatch):
        calls = self._count(monkeypatch)
        cfg = BertConfig.tiny(use_flash=True)
        with torch.no_grad():
            BertModel(cfg, device="cpu")(torch.zeros((2, 16),
                                                     dtype=torch.long))
        assert calls["n"] == cfg.n_layers

    def test_bert_dense_mask_takes_plain_attention(self, monkeypatch):
        cfg = BertConfig.tiny(use_flash=True)
        m = BertModel(cfg, device="cpu")
        m.load_state_dict(convert.init_bert_params(cfg, seed=1))
        calls = self._count(monkeypatch)
        with torch.no_grad():
            out = m(torch.zeros((2, 16), dtype=torch.long),
                    attention_mask=torch.ones((2, 16), dtype=torch.int32))
        assert calls["n"] == 0 and fa.launches == 0
        assert torch.isfinite(out.float()).all()

    def test_vit_routes_to_flash(self, monkeypatch):
        calls = self._count(monkeypatch)
        cfg = ViTConfig.tiny(use_flash=True)
        with torch.no_grad():
            ViT(cfg, device="cpu")(torch.zeros((2, 3, 32, 32)))
        assert calls["n"] == cfg.n_layers

    def test_moe_routes_to_flash(self, monkeypatch):
        calls = self._count(monkeypatch)
        cfg = MoEConfig(vocab_size=64, max_len=32, d_model=64, n_heads=4,
                        n_layers=2, d_ff=128, num_experts=2, use_flash=True)
        with torch.no_grad():
            SwitchTransformerLM(cfg, device="cpu")(
                torch.zeros((2, 8), dtype=torch.long))
        assert calls["n"] == cfg.n_layers


_EXPORTED = {
    "MLP": lambda device: MLP(in_features=4, device=device),
    "BertModel": lambda device: BertModel(BertConfig.tiny(), device=device),
    "ViT": lambda device: ViT(ViTConfig.tiny(), device=device),
    "ResNet18": lambda device: ResNet18(num_classes=4, device=device),
    "SwitchTransformerLM": lambda device: SwitchTransformerLM(
        MoEConfig(vocab_size=64, max_len=16, d_model=32, n_heads=2,
                  n_layers=2, d_ff=64, num_experts=2), device=device),
}


@pytest.mark.parametrize("name", sorted(_EXPORTED))
def test_zoo_modules_resolve_their_device(name):
    build = _EXPORTED[name]
    if torch.cuda.is_available():
        assert next(build(None).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(None)
    assert {p.device.type for p in build("cpu").parameters()} == {"cpu"}
