"""The port's GPT-2 (horovod_tpu_torch.models) held against the JAX
package's, on the CPU.

Flax parameters from the JAX model's init go through
``convert.params_from_flax``; the same seeded tokens go to both. The JAX
side runs its Pallas flash kernel in interpret mode (``use_flash=True``);
the port's CPU path runs the kernel's plain version. Tolerances: fp32
logits 1e-4 absolute (summation order only); bf16 logits the serving
bound -- max |d| <= 0.05 max |logits|, the same argmax wherever the top-2
margin exceeds that bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops import flash_attention as fa

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def _both(dtype, use_flash=True, seed=0, seq=32, **kw):
    jdt, tdt = _DT[dtype]
    jcfg = jgpt2.GPT2Config.tiny(dtype=jdt, use_flash=use_flash, **kw)
    tcfg = GPT2Config.tiny(dtype=tdt, use_flash=use_flash, **kw)
    tokens = _tokens(seed, 2, seq, jcfg.vocab_size)
    jm = jgpt2.GPT2LMModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    jl = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    tm = GPT2LMModel(tcfg, device="cpu")
    tm.load_state_dict(convert.params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        tl = tm(torch.from_numpy(tokens)).numpy()
    return jl, tl


def _serving_bound(got, ref):
    bound = 0.05 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > bound
    assert np.array_equal(
        got.argmax(-1)[decided], ref.argmax(-1)[decided]
    )


# d_model=64, n_heads=4: head dim 16 takes the JAX head-major flash
# branch; d_model=128, n_heads=2: head dim 64 takes its packed "bsm" one.
SHAPES = [dict(), dict(d_model=128, n_heads=2)]


@pytest.mark.parametrize("shape", SHAPES, ids=["hd16", "hd64"])
def test_fp32_logits_match(shape):
    jl, tl = _both("float32", **shape)
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=["hd16", "hd64"])
def test_bf16_logits_within_serving_bound(shape):
    jl, tl = _both("bfloat16", seed=1, **shape)
    _serving_bound(tl, jl)


def test_plain_attention_path_matches():
    jl, tl = _both("float32", use_flash=False, seed=2)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_params_from_flax_layouts():
    cfg = jgpt2.GPT2Config.tiny()
    params = jax.tree.map(np.asarray, jgpt2.GPT2LMModel(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32)
    ))
    sd = convert.params_from_flax(params)
    m = GPT2LMModel(GPT2Config.tiny(), device="cpu")
    m.load_state_dict(sd)  # strict: every name present, no extras
    mha = params["params"]["transformer"]["block_1"]["MultiHeadAttention_0"]
    d = cfg.d_model
    qkv = sd["transformer.blocks.1.attn.qkv.weight"].numpy()
    # Row j of the key block is head j // dh, lane j % dh of DenseGeneral.
    np.testing.assert_array_equal(
        qkv[d:2 * d], mha["key"]["kernel"].reshape(d, d).T
    )
    np.testing.assert_array_equal(
        sd["transformer.blocks.1.attn.out.weight"].numpy(),
        mha["out"]["kernel"].reshape(d, d).T,
    )
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_init_params_is_seeded_and_complete():
    cfg = GPT2Config.tiny()
    a, b = convert.init_params(cfg, seed=5), convert.init_params(cfg, seed=5)
    c = convert.init_params(cfg, seed=6)
    m = GPT2LMModel(cfg, device="cpu")
    m.load_state_dict(a)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["transformer.wte.weight"],
                           c["transformer.wte.weight"])
    assert torch.equal(a["transformer.ln_f.scale"], torch.ones(cfg.d_model))


def test_layernorm_matches_flax_eps_and_fp32_stats():
    import flax.linen as nn

    x = np.random.RandomState(4).standard_normal((2, 5, 64)).astype(np.float32)
    x = x * 3.0 + 1.0
    ln = nn.LayerNorm(dtype=jnp.bfloat16)
    p = ln.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(ln.apply(p, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tln = ttr.LayerNorm(64, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        got = tln(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and ttr.LN_EPS == 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)
    # Rows whose variance is near the epsilon: flax's 1e-6 and torch's
    # default 1e-5 give visibly different answers; the port gives flax's.
    small = torch.from_numpy(
        (np.random.RandomState(5).standard_normal((4, 64)) * 3e-3)
        .astype(np.float32)
    )
    with torch.no_grad():
        ours = ttr.LayerNorm(64, dtype=torch.float32, device="cpu")(small)
    flax_like = np.asarray(nn.LayerNorm().apply(
        {"params": {"scale": jnp.ones(64), "bias": jnp.zeros(64)}},
        jnp.asarray(small.numpy()),
    ))
    np.testing.assert_allclose(ours.numpy(), flax_like, atol=1e-4, rtol=0)
    torch_default = torch.nn.functional.layer_norm(small, (64,))
    assert (torch_default - ours).abs().max().item() > 1e-2


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.array(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    cfg = GPT2Config.tiny(dtype=torch.float32)
    mlp = ttr.MlpBlock(cfg, device="cpu")
    with torch.no_grad():
        mlp.fc.weight.copy_(torch.eye(cfg.d_ff, cfg.d_model))
        mlp.proj.weight.copy_(torch.eye(cfg.d_model, cfg.d_ff))
    h = torch.from_numpy(x[:64]).reshape(1, 64)
    torch.testing.assert_close(
        mlp(h), torch.from_numpy(want[:64]).reshape(1, 64), atol=1e-6, rtol=0
    )


def test_residual_stream_and_tied_head_round_to_bf16():
    cfg = GPT2Config.tiny()
    m = GPT2LMModel(cfg, device="cpu")
    m.load_state_dict(convert.init_params(cfg, seed=7))
    tokens = torch.from_numpy(_tokens(7, 2, 16, cfg.vocab_size))
    seen = []
    for blk in m.transformer.blocks:
        blk.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    with torch.inference_mode():
        hidden = m(tokens, return_hidden=True)
        logits = m(tokens)
    # The embeddings come out in bf16, so every block's residual input is.
    assert seen == [torch.bfloat16] * (2 * cfg.n_layers)
    assert hidden.dtype == torch.bfloat16
    assert logits.dtype == torch.float32
    # The head runs in bf16 and only then casts: every logit is a bf16 value.
    torch.testing.assert_close(logits, logits.to(torch.bfloat16).float(),
                               atol=0, rtol=0)


def test_bf16_weights_cast_once_at_load_round_like_per_op_casts():
    import flax.linen as nn

    cfg = GPT2Config.tiny(d_model=128, n_heads=2)
    sd = convert.init_params(cfg, seed=8)
    m = GPT2LMModel(cfg, device="cpu")
    m.load_state_dict(sd)
    # The fp32 checkpoint is rounded to bf16 once at load; LayerNorm stays
    # fp32.
    for name, p in m.state_dict().items():
        if ".ln_" in name:
            assert p.dtype == torch.float32 and torch.equal(p, sd[name])
        else:
            assert p.dtype == torch.bfloat16, name
            assert torch.equal(p, sd[name].to(torch.bfloat16)), name
    # One projection against flax's nn.Dense(dtype=bf16), which keeps the
    # fp32 kernel and casts it at the op: the same rounding. (The bias is
    # init's zero, so flax's separate bf16 bias add rounds nothing.)
    d = cfg.d_model
    x = np.random.RandomState(8).standard_normal((3, d)).astype(np.float32)
    w = sd["transformer.blocks.0.attn.qkv.weight"].numpy()
    b = sd["transformer.blocks.0.attn.qkv.bias"].numpy()
    assert not b.any()
    want = nn.Dense(3 * d, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}},
        jnp.asarray(x, jnp.bfloat16),
    )
    with torch.no_grad():
        got = m.transformer.blocks[0].attn.qkv(
            torch.from_numpy(x).to(torch.bfloat16)
        )
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # Within one bf16 rounding step (fp32 sums in another order).
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_flash_path_runs_the_plain_version_on_cpu():
    cfg = GPT2Config.tiny(d_model=128, n_heads=2, use_flash=True)
    m = GPT2LMModel(cfg, device="cpu")
    m.load_state_dict(convert.init_params(cfg, seed=9))
    calls = []
    orig = fa.flash_attention_reference

    def spy(*a, **k):
        calls.append(k.get("layout"))
        return orig(*a, **k)

    fa.reset_launches()
    try:
        fa.flash_attention_reference = spy
        with torch.inference_mode():
            m(torch.zeros((1, 8), dtype=torch.long))
    finally:
        fa.flash_attention_reference = orig
    assert calls == ["bsm"] * cfg.n_layers and fa.launches == 0


@pytest.mark.parametrize("kw,match", [
    (dict(remat="dots_savable"), "remat"),
    (dict(compute_dtype="fp16"), "compute_dtype"),
])
def test_unported_options_raise(kw, match):
    # remat and compute_dtype="fp8" are ported (test_torch_port_remat.py,
    # test_torch_port_fp8.py); a remat typo and another compute dtype are
    # refused as the JAX package refuses them.
    with pytest.raises(ValueError, match=match):
        jgpt2.GPT2LMModel(jgpt2.GPT2Config.tiny(**kw)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    with pytest.raises(ValueError, match=match):
        GPT2LMModel(GPT2Config.tiny(**kw), device="cpu")


def test_act_quant_and_dense_mask_raise():
    # The model takes no act_quant keyword: as in the JAX package, only
    # make_train_step(act_quant=) arms the int8 boundaries
    # (test_torch_port_actquant.py). The dense mask is ported and now
    # matches the JAX package (the name is kept from the cases it replaced).
    with pytest.raises(TypeError, match="act_quant"):
        GPT2LMModel(GPT2Config.tiny(), device="cpu", act_quant="int8")
    with pytest.raises(TypeError, match="act_quant"):
        jgpt2.GPT2LMModel(jgpt2.GPT2Config.tiny(), act_quant="int8")
    # A dense [B, 1, 1, S] mask on top of the causal one, through the
    # attention of a fp32 block: plain attention on both sides, 1e-5.
    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, use_flash=True)
    rs = np.random.RandomState(12)
    x = rs.standard_normal((2, 8, 64)).astype(np.float32)
    mask = np.ones((2, 1, 1, 8), bool)
    mask[0, ..., 5:] = False
    mask[1, ..., 2] = False
    jm = jtr.MultiHeadAttention(cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    tm = GPT2LMModel(GPT2Config.tiny(dtype=torch.float32, use_flash=True),
                     device="cpu")
    wrapped = {"params": {"transformer": {"block_0": {
        "MultiHeadAttention_0": jax.tree.map(np.asarray, params["params"]),
        "LayerNorm_0": {"scale": np.ones(64), "bias": np.zeros(64)},
        "LayerNorm_1": {"scale": np.ones(64), "bias": np.zeros(64)}}}}}
    sd = {k[len("transformer.blocks.0."):]: v for k, v in
          convert.params_from_flax({"params": {"transformer": {
              **wrapped["params"]["transformer"],
              "wte": {"embedding": np.zeros((1, 64))},
              "wpe": {"embedding": np.zeros((1, 64))},
              "ln_f": {"scale": np.ones(64), "bias": np.zeros(64)}}}}).items()
          if k.startswith("transformer.blocks.0.attn.")}
    attn = tm.transformer.blocks[0].attn
    attn.load_state_dict({k[len("attn."):]: v for k, v in sd.items()})
    fa.reset_launches()
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert fa.launches == 0


def test_dot_product_attention_matches_jax():
    rs = np.random.RandomState(10)
    q, k, v = (rs.standard_normal((2, 12, 3, 8)).astype(np.float32)
               for _ in range(3))
    for causal in (False, True):
        want = np.asarray(jtr.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal
        ))
        got = ttr.dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal,
        )
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


_EXPORTED = {
    "Transformer": lambda cfg, device: ttr.Transformer(cfg, device=device),
    "Block": lambda cfg, device: ttr.Block(cfg, device=device),
    "MlpBlock": lambda cfg, device: ttr.MlpBlock(cfg, device=device),
    "MultiHeadAttention": lambda cfg, device: ttr.MultiHeadAttention(
        cfg, device=device),
}


@pytest.mark.parametrize("name", sorted(_EXPORTED))
def test_exported_modules_resolve_their_device(name, monkeypatch):
    # An entry point runs on the card unless the caller asks for the CPU,
    # as GPT2LMModel does: device=None resolves through resolve_device.
    from horovod_tpu_torch import context

    build = _EXPORTED[name]
    cfg = GPT2Config.tiny()
    if torch.cuda.is_available():
        assert next(build(cfg, None).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(cfg, None)
    assert {p.device.type for p in build(cfg, "cpu").parameters()} == {"cpu"}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    context.init(device="cpu", backend="gloo")
    try:
        assert {p.device.type for p in build(cfg, None).parameters()} == {
            "cpu"}
    finally:
        context.shutdown()
