"""The port's chunked cross-entropy (horovod_tpu_torch.ops.losses) held
against the JAX package's ``ops/losses.py`` on the CPU: the twins of
``tests/test_losses.py``.

The same numpy-seeded inputs go through ``fused_cross_entropy`` and
``cross_entropy_logits_reference`` on both sides. Tolerances: the loss
within 1e-5 relative (fp32 sums in another order), gradients within
``rtol=2e-4, atol=1e-6`` (the JAX test's own bound between its chunked and
full paths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import losses as jl
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import (BertConfig, BertModel, GPT2Config,
                                      GPT2LMModel)
from horovod_tpu_torch.ops import losses as tl


def _problem(n=100, m=32, v=77, seed=0, use_weights=True, use_bias=True):
    rs = np.random.RandomState(seed)
    h = rs.standard_normal((n, m)).astype(np.float32)
    w = (rs.standard_normal((m, v)) * 0.2).astype(np.float32)
    t = rs.randint(0, v, (n,)).astype(np.int32)
    wt = ((rs.uniform(size=(n,)) > 0.3).astype(np.float32)
          if use_weights else None)
    b = ((rs.standard_normal((v,)) * 0.1).astype(np.float32)
         if use_bias else None)
    return h, w, t, wt, b


def _torch_value_and_grad(fn, h, w, t, wt, b, **kw):
    ht = torch.tensor(h, requires_grad=True)
    wt_ = torch.tensor(w, requires_grad=True)
    loss = fn(ht, wt_, torch.from_numpy(t),
              bias=None if b is None else torch.from_numpy(b),
              weights=None if wt is None else torch.from_numpy(wt), **kw)
    gh, gw = torch.autograd.grad(loss, (ht, wt_))
    return float(loss.detach()), gh.numpy(), gw.numpy()


@pytest.mark.parametrize("use_weights", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
def test_fused_ce_matches_the_jax_package(use_weights, use_bias):
    # N % chunk != 0 exercises the row padding.
    h, w, t, wt, b = _problem(use_weights=use_weights, use_bias=use_bias)
    jb = None if b is None else jnp.asarray(b)
    jw = None if wt is None else jnp.asarray(wt)
    lj, gj = jax.value_and_grad(
        lambda h_, w_: jl.fused_cross_entropy(
            h_, w_, jnp.asarray(t), bias=jb, weights=jw, chunk_rows=16),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    lf, ghf, gwf = _torch_value_and_grad(tl.fused_cross_entropy, h, w, t, wt,
                                         b, chunk_rows=16)
    lr, ghr, gwr = _torch_value_and_grad(tl.cross_entropy_logits_reference,
                                         h, w, t, wt, b)
    np.testing.assert_allclose(lf, float(lj), rtol=1e-5)
    np.testing.assert_allclose(lf, lr, rtol=1e-5)
    for got, ref, want in ((ghf, ghr, gj[0]), (gwf, gwr, gj[1])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6)


def test_reference_matches_the_jax_reference():
    h, w, t, wt, b = _problem(seed=1)
    want = jl.cross_entropy_logits_reference(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(t), bias=jnp.asarray(b),
        weights=jnp.asarray(wt))
    got = tl.cross_entropy_logits_reference(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t),
        bias=torch.from_numpy(b), weights=torch.from_numpy(wt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_all_masked_is_zero_and_fractional_weights_divide():
    h, w, t, _, b = _problem(n=20, seed=2)
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t))
    zero = torch.zeros((20,))
    assert float(tl.fused_cross_entropy(*args, weights=zero,
                                        chunk_rows=8)) == 0.0
    frac = torch.full((20,), 0.01)  # weight sum 0.2 < 1 still divides
    for fn in (tl.fused_cross_entropy, tl.cross_entropy_logits_reference):
        got = float(fn(*args, weights=frac))
        want = float(jl.fused_cross_entropy(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
            weights=jnp.full((20,), 0.01), chunk_rows=8))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bf16_operands_accumulate_in_fp32():
    """bf16 h and w give the logits of an fp32 product of the bf16 values
    (preferred_element_type=float32), not a bf16 product cast after."""
    h, w, t, _, _ = _problem(n=64, m=256, v=50, seed=3, use_weights=False,
                             use_bias=False)
    hb = torch.from_numpy(h).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    got = float(tl.fused_cross_entropy(hb, wb, torch.from_numpy(t),
                                       chunk_rows=16))
    exact = float(tl.cross_entropy_logits_reference(
        hb.float(), wb.float(), torch.from_numpy(t)))
    want = float(jl.fused_cross_entropy(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(t), chunk_rows=16))
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fused_ce_leading_shape_and_tied_head():
    """``[B, S, M]`` hidden states and ``wte.T`` -- the GPT-2 tied-head
    idiom (``return_hidden=True``)."""
    import torch.nn.functional as F

    cfg = GPT2Config.tiny(use_flash=False, dtype=torch.float32)
    m = GPT2LMModel(cfg, device="cpu")
    m.load_state_dict(convert.init_params(cfg, seed=6))
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        logits = m(tokens)
        base = F.cross_entropy(logits.flatten(0, 1), tokens.flatten())
        h = m(tokens, return_hidden=True)
        fused = tl.fused_cross_entropy(h, m.transformer.wte.weight.t(),
                                       tokens, chunk_rows=8)
    np.testing.assert_allclose(float(fused), float(base), rtol=1e-5)


def test_bert_return_hidden_matches_decoder():
    cfg = BertConfig.tiny(use_flash=False, dtype=torch.float32)
    m = BertModel(cfg, device="cpu")
    m.load_state_dict(convert.init_bert_params(cfg, seed=8))
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        logits = m(tokens)
        h = m(tokens, return_hidden=True)
        manual = h @ m.mlm_decoder.weight.t() + m.mlm_decoder.bias
    np.testing.assert_allclose(logits.numpy(), manual.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_chunks_recompute_in_the_backward():
    """Each chunk is checkpointed: the backward reruns every chunk's
    logits product, so no chunk's [chunk, V] logits outlive its forward."""
    h, w, t, wt, b = _problem(n=64, seed=9)
    calls = []
    orig = tl._logits

    def spy(*a):
        calls.append(a[0].shape[0])
        return orig(*a)

    tl._logits = spy
    try:
        _torch_value_and_grad(tl.fused_cross_entropy, h, w, t, wt, b,
                              chunk_rows=16)
    finally:
        tl._logits = orig
    assert calls == [16] * 8  # 4 chunks forward, 4 recomputed
