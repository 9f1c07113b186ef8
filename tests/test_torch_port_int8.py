"""The port's int8 serving weights held against the JAX package's, on the CPU.

``quantize_weight`` / ``dequantize_weight`` bit for bit with the JAX
package's (eager ``impl="jax"`` codec); ``int8_weight_matmul``'s plain
version against both JAX impls under ``jit`` (the Pallas kernel in interpret
mode, as ``tests/test_quantization.py`` runs it): fp32 within 1e-5 of the
largest value (fp32 sums in another order), bf16 within one bf16 ulp of the
largest value (one rounding of nearly equal fp32 sums); GPT-2 tiny with
int8 projections against the flax model applied to the dequantized
projection kernels: fp32 logits to 1e-4 (the port scales the fp32 sum, flax
sums products with the scaled weight), bf16 within the serving bound; and
``ServePool(weight_dtype="int8")`` on the JAX package's MLP configuration
and on a GPT-2 tiny module. Inputs come from numpy seeds.
"""

import copy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.ops import quantization as jq
from horovod_tpu.serve import ServePool as JaxServePool
from horovod_tpu_torch import convert
from horovod_tpu_torch.checkpoint import save_checkpoint
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.models.transformer import Dense
from horovod_tpu_torch.ops import quantization as tq
from horovod_tpu_torch.serve import ServePool
from horovod_tpu_torch.utils import env as tenv

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RAGGED = [(5, 300, 70), (16, 512, 128), (1, 64, 10)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_payload(port, jax_qw):
    assert port.q.dtype == torch.int8 and port.q.shape == tuple(jax_qw.q.shape)
    assert np.array_equal(port.q.numpy(), np.asarray(jax_qw.q))
    assert np.array_equal(_bits(port.scales.numpy()), _bits(jax_qw.scales))
    assert port.dtype_name == jax_qw.dtype_name


# -- quantize / dequantize ----------------------------------------------------


@pytest.mark.parametrize("shape", [(300, 70), (64, 128)],
                         ids=["ragged", "gpt2-tiny-fc"])
def test_quantize_weight_bit_for_bit_with_jax(shape):
    w = np.random.RandomState(5).randn(*shape).astype(np.float32) * 0.1
    jw = jq.quantize_weight(jnp.asarray(w))
    pw = tq.quantize_weight(torch.from_numpy(w))
    _assert_same_payload(pw, jw)
    # The payload is the transposed view of [N, K] storage: kernel 7's layout.
    assert pw.q.t().is_contiguous()
    d = tq.dequantize_weight(pw)
    assert d.dtype == torch.float32
    assert np.array_equal(_bits(d.numpy()), _bits(jq.dequantize_weight(jw)))


def test_quantize_weight_keeps_the_storage_dtype_name():
    w = torch.from_numpy(np.random.RandomState(1).randn(64, 80).astype(
        np.float32)).to(torch.bfloat16)
    qw = tq.quantize_weight(w)
    assert qw.dtype_name == "bfloat16"
    assert tq.dequantize_weight(qw).dtype == torch.bfloat16
    jw = jq.quantize_weight(jnp.asarray(w.float().numpy(), jnp.bfloat16))
    _assert_same_payload(qw, jw)
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize_weight(w.reshape(-1))


def test_converted_jax_payload_is_the_port_layout():
    w = np.random.RandomState(2).randn(96, 40).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    cw = convert.quantized_weight_from_jax(jw)
    _assert_same_payload(cw, jw)
    assert cw.q.t().is_contiguous()
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 96).astype(
        np.float32))
    assert torch.equal(tq.int8_weight_matmul(x, cw),
                       tq.int8_weight_matmul(x, tq.quantize_weight(
                           torch.from_numpy(w))))


# -- the matmul ------------------------------------------------------------------


def _ulp_bf16(x):
    """One bf16 ulp of |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("impl", ["jax", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", RAGGED)
def test_int8_weight_matmul_plain_matches_both_jax_impls(m, k, n, dtype, impl):
    jdt, tdt = _DT[dtype]
    rng = np.random.RandomState(6)
    w = rng.randn(k, n).astype(np.float32)
    x = jnp.asarray(rng.randn(m, k).astype(np.float32), jdt)
    jw = jq.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax.jit(
        lambda x, jw=jw: jq.int8_weight_matmul(x, jw, impl=impl))(x)
    ).astype(np.float32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    got = tq.int8_weight_matmul(xt, tq.quantize_weight(torch.from_numpy(w)))
    assert got.dtype == tdt and got.shape == (m, n)
    err = np.abs(got.float().numpy() - want).max()
    top = np.abs(want).max()
    if dtype == "float32":
        assert err <= 1e-5 * top, err
    else:
        assert err <= _ulp_bf16(top), err


def test_plain_version_follows_the_blocked_order():
    # The K tiles are summed in order: an explicit 256-wide tiling of the
    # same products equals the plain version bit for bit.
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(7, 600).astype(np.float32))
    qw = tq.quantize_weight(torch.from_numpy(rng.randn(600, 33).astype(
        np.float32)))
    acc = torch.zeros((7, 33))
    for k0 in range(0, 600, 256):
        acc += x[:, k0:k0 + 256] @ qw.q[k0:k0 + 256].float()
    assert torch.equal(tq.int8_weight_matmul_reference(x, qw),
                       acc * qw.scales)


def test_qmatmul_transparent_and_batched():
    rng = np.random.RandomState(7)
    w = rng.randn(64, 32).astype(np.float32)
    x = rng.randn(3, 5, 64).astype(np.float32)  # leading batch dims
    plain = tq.qmatmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(plain.numpy(), x @ w, rtol=1e-6)
    q = tq.qmatmul(torch.from_numpy(x), tq.quantize_weight(torch.from_numpy(w)))
    assert q.shape == plain.shape == (3, 5, 32)
    assert (q - plain).abs().max().item() < 0.3
    jwant = np.asarray(jq.qmatmul(jnp.asarray(x), jq.quantize_weight(
        jnp.asarray(w))))
    np.testing.assert_allclose(q.numpy(), jwant, rtol=0,
                               atol=1e-5 * np.abs(jwant).max())
    # A non-contiguous x (a column slice) flattens through its strides.
    wide = torch.from_numpy(rng.randn(3, 5, 128).astype(np.float32))
    sl = wide[..., 32:96]
    assert torch.equal(tq.qmatmul(sl, tq.quantize_weight(torch.from_numpy(w))),
                       tq.qmatmul(sl.contiguous(),
                                  tq.quantize_weight(torch.from_numpy(w))))


def test_int8_weight_matmul_checks_its_operands():
    qw = tq.quantize_weight(torch.ones((64, 16)))
    with pytest.raises(ValueError, match="disagree"):
        tq.int8_weight_matmul(torch.ones((2, 63)), qw)
    with pytest.raises(TypeError, match="QuantizedWeight"):
        tq.int8_weight_matmul(torch.ones((2, 64)), torch.ones((64, 16)))
    bad = tq.QuantizedWeight(qw.q, qw.scales[:8])
    with pytest.raises(ValueError, match="scales"):
        tq.int8_weight_matmul(torch.ones((2, 64)), bad)
    with pytest.raises(ValueError, match="on meta"):
        tq.int8_weight_matmul(torch.ones((2, 64)), qw.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", RAGGED)
def test_bias_is_the_separate_add_bit_for_bit(m, k, n, dtype):
    _, tdt = _DT[dtype]
    rng = np.random.RandomState(9)
    qw = tq.quantize_weight(torch.from_numpy(rng.randn(k, n).astype(
        np.float32)))
    x = torch.from_numpy(rng.randn(3, m, k).astype(np.float32)).to(tdt)
    b = torch.from_numpy(rng.randn(n).astype(np.float32))  # cast to x's dtype
    want = tq.int8_weight_matmul_reference(x, qw) + b.to(tdt)
    for got in (tq.int8_weight_matmul_reference(x, qw, bias=b),
                tq.int8_weight_matmul(x, qw, b)):
        assert got.dtype == tdt and got.shape == (3, m, n)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="bias"):
        tq.int8_weight_matmul(x, qw, b[:-1])
    with pytest.raises(ValueError, match="bias is on meta"):
        tq.int8_weight_matmul(x, qw, b.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dense_output_is_unchanged_by_the_fused_bias(dtype):
    # Dense.forward hands its bias to int8_weight_matmul; the output equals
    # the former qmatmul(x, w) + bias in the compute dtype, bit for bit.
    _, tdt = _DT[dtype]
    rng = np.random.RandomState(10)
    dense = Dense(96, 80, dtype=tdt, device="cpu", param_dtype=torch.float32)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(rng.randn(80, 96).astype(
            np.float32)))
        dense.bias.copy_(torch.from_numpy(rng.randn(80).astype(np.float32)))
    dense.quantize_()
    x = torch.from_numpy(rng.randn(2, 7, 96).astype(np.float32))
    with torch.no_grad():
        got = dense(x)
    want = tq.qmatmul(x.to(tdt), dense.quantized_weight()) + dense.bias.to(tdt)
    assert got.dtype == tdt and torch.equal(got, want)


@pytest.mark.parametrize("tiles,k,want", [
    (18, 768, (6, 2)),     # GPT-2 small at M = 8: qkv
    (6, 768, (6, 2)),      # out
    (24, 768, (4, 3)),     # fc
    (6, 3072, (16, 3)),    # proj
    (384, 768, (1, 12)),   # M = 8192: a few rounds already
    (1152, 768, (1, 12)),
    (384, 3072, (1, 48)),
    (6, 192, (1, 3)),      # fewer than 4 k tiles
    (60, 3072, (2, 24)),   # two splits fill one round
    (100, 3072, (1, 48)),  # two splits would need two rounds: no gain
])
def test_int8_split_plan(tiles, k, want, monkeypatch):
    # The wrapper's host-side plan for kernel 7 on a card of 132 SMs.
    monkeypatch.setitem(tq._sm_counts, "card132", 132)
    assert tq._int8_splits(tiles, k, "card132") == want


@pytest.mark.parametrize("shape,strides,want", [
    ((4, 6, 8), (48, 8, 1), (24, 0, 8)),       # contiguous: one row dim
    ((4, 6, 8), (144, 24, 1), (24, 0, 24)),    # column slice of a wider row
    ((4, 6, 8), (8, 32, 1), (6, 8, 32)),       # batch-transposed: two dims
    ((1, 1, 8), (8, 8, 1), (1, 0, 0)),         # one row
    ((8,), (1,), (1, 0, 0)),                   # a vector
])
def test_rows_layout_of_the_kernel_wrapper(shape, strides, want):
    x = torch.empty_strided(shape, strides)
    assert tq._rows_layout(x) == want


def test_rows_layout_refuses_three_unmergeable_row_dims():
    x = torch.empty((2, 3, 4, 8)).permute(1, 0, 2, 3)[:, :, ::2]
    with pytest.raises(ValueError, match="two row dims"):
        tq._rows_layout(x)


# -- quantize_params --------------------------------------------------------------


def test_quantize_params_same_selection_as_jax():
    rng = np.random.RandomState(8)
    tree = {
        "big": rng.randn(128, 64).astype(np.float32),  # 8192 elements
        "edge": rng.randn(64, 64).astype(np.float32),  # exactly 4096
        "small": rng.randn(8, 8).astype(np.float32),
        "bias": np.zeros((128,), np.float32),
        "nest": [rng.randn(100, 50).astype(np.float32)],
    }
    jout = jq.quantize_params(jax.tree.map(jnp.asarray, tree))
    ints = torch.zeros((128, 64), dtype=torch.int32)
    tout = tq.quantize_params(dict(
        jax.tree.map(torch.from_numpy, tree), ints=ints))
    for key in ("big", "edge"):
        _assert_same_payload(tout[key], jout[key])
    _assert_same_payload(tout["nest"][0], jout["nest"][0])
    for key in ("small", "bias"):
        assert isinstance(tout[key], torch.Tensor)
        assert not isinstance(jout[key], jq.QuantizedWeight)
    assert tout["ints"] is ints


def _tiny(dtype=torch.float32, **kw):
    cfg = GPT2Config.tiny(dtype=dtype, param_dtype=torch.float32, **kw)
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(convert.init_params(cfg, seed=0))
    return cfg, model


def test_quantize_params_on_a_module_leaves_no_floating_weight():
    cfg, model = _tiny()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = tq.quantize_params(model)
    assert out is model
    dense = [m for m in model.modules() if isinstance(m, Dense)]
    assert len(dense) == 4 * cfg.n_layers
    for m in dense:
        assert m.quantized and "weight" not in dict(m.named_parameters())
        assert m.weight_q.dtype == torch.int8 and m.weight_q.is_contiguous()
        assert m.weight_scales.dtype == torch.float32
    sd = model.state_dict()
    assert not any(k.endswith(("qkv.weight", "out.weight", "fc.weight",
                               "proj.weight")) for k in sd)
    # The fc payload is quantize_weight of the fp32 kernel, bit for bit.
    fc = model.transformer.blocks[1].mlp.fc
    want = tq.quantize_weight(sd0["transformer.blocks.1.mlp.fc.weight"].t())
    assert torch.equal(fc.quantized_weight().q, want.q)
    assert torch.equal(fc.weight_scales, want.scales)
    # Embeddings, LayerNorms and biases stay floating; buffers travel.
    assert torch.equal(sd["transformer.wte.weight"],
                       sd0["transformer.wte.weight"])
    clone = copy.deepcopy(model).to("cpu")
    assert torch.equal(clone.transformer.blocks[0].attn.qkv.weight_q,
                       model.transformer.blocks[0].attn.qkv.weight_q)


def test_quantize_params_min_size_and_fp8_refusal():
    cfg, model = _tiny()
    tq.quantize_params(model, min_size=64 * 64 + 1)  # all but out
    blk = model.transformer.blocks[0]
    assert blk.attn.qkv.quantized and blk.mlp.fc.quantized
    assert not blk.attn.out.quantized  # 64 x 64
    tq.quantize_params(model)  # quantizes the rest, leaves the done ones
    assert blk.attn.out.quantized
    fp8 = GPT2LMModel(GPT2Config.tiny(compute_dtype="fp8"), device="cpu")
    with pytest.raises(ValueError, match="fp8"):
        tq.quantize_params(fp8)
    assert not any(m.quantized for m in fp8.modules() if isinstance(m, Dense))


# -- GPT-2 tiny against the flax model ------------------------------------------


def _dequantized_flax(params):
    """The flax params with every projection kernel replaced by
    dequantize_weight(quantize_weight(kernel as 2-D)), reshaped back."""
    def dq(k, rows):
        k = np.asarray(k)
        w2 = jnp.asarray(k.reshape(rows, -1))
        return np.asarray(jq.dequantize_weight(jq.quantize_weight(w2))).reshape(
            k.shape)

    def thaw(t):
        if hasattr(t, "items"):
            return {k: thaw(v) for k, v in t.items()}
        return np.asarray(t)

    p = thaw(params)
    tr = p["params"]["transformer"]
    for name, blk in tr.items():
        if not name.startswith("block_"):
            continue
        mha = blk["MultiHeadAttention_0"]
        for n in ("query", "key", "value"):
            mha[n]["kernel"] = dq(mha[n]["kernel"], mha[n]["kernel"].shape[0])
        out = mha["out"]["kernel"]
        mha["out"]["kernel"] = dq(out, out.shape[0] * out.shape[1])
        for d in ("Dense_0", "Dense_1"):
            kern = blk["MlpBlock_0"][d]["kernel"]
            blk["MlpBlock_0"][d]["kernel"] = dq(kern, kern.shape[0])
    return p


def _int8_both(dtype, seed=0, **kw):
    jdt, tdt = _DT[dtype]
    jcfg = jgpt2.GPT2Config.tiny(dtype=jdt, use_flash=True, **kw)
    tcfg = GPT2Config.tiny(dtype=tdt, use_flash=True,
                           param_dtype=torch.float32, **kw)
    tokens = np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jm = jgpt2.GPT2LMModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    jl = np.asarray(jm.apply(_dequantized_flax(params), jnp.asarray(tokens)))
    tm = GPT2LMModel(tcfg, device="cpu")
    tm.load_state_dict(convert.params_from_flax(jax.tree.map(np.asarray,
                                                             params)))
    tq.quantize_params(tm)
    with torch.inference_mode():
        tl = tm(torch.from_numpy(tokens)).numpy()
    return jl, tl, params, tm


SHAPES = [dict(), dict(d_model=128, n_heads=2)]


@pytest.mark.parametrize("shape", SHAPES, ids=["hd16", "hd64"])
def test_gpt2_tiny_int8_fp32_logits_match_flax(shape):
    jl, tl, params, tm = _int8_both("float32", **shape)
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    # The module holds exactly the JAX package's payload for the MLP's fc.
    kern = params["params"]["transformer"]["block_0"]["MlpBlock_0"][
        "Dense_0"]["kernel"]
    jw = jq.quantize_weight(jnp.asarray(kern))
    _assert_same_payload(tm.transformer.blocks[0].mlp.fc.quantized_weight(),
                         jw)


@pytest.mark.parametrize("shape", SHAPES, ids=["hd16", "hd64"])
def test_gpt2_tiny_int8_bf16_logits_within_serving_bound(shape):
    jl, tl, _, _ = _int8_both("bfloat16", seed=1, **shape)
    bound = 0.05 * np.abs(jl).max()
    assert np.abs(tl - jl).max() <= bound
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > bound
    assert np.array_equal(tl.argmax(-1)[decided], jl.argmax(-1)[decided])


# -- ServePool(weight_dtype="int8") ------------------------------------------------


def _mlp_numpy(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(64, 128) * 0.1).astype(np.float32),
            "b1": np.zeros((128,), np.float32),
            "w2": (rng.randn(128, 16) * 0.1).astype(np.float32),
            "b2": np.zeros((16,), np.float32)}


def _mlp_params(seed=0):
    return {k: torch.from_numpy(v) for k, v in _mlp_numpy(seed).items()}


def _infer(p, x):
    h = torch.relu(tq.qmatmul(x, p["w1"]) + p["b1"])
    return tq.qmatmul(h, p["w2"]) + p["b2"]


def _jax_infer(p, x):
    h = jax.nn.relu(jq.qmatmul(x, p["w1"]) + p["b1"])
    return jq.qmatmul(h, p["w2"]) + p["b2"]


class TestInt8Weights:
    """The JAX package's ``TestInt8Weights`` cases on the port's pool."""

    def test_int8_pool_answers_close_to_float(self):
        x = np.random.RandomState(1).randn(64).astype(np.float32)
        outs = {}
        for wd in ("", "int8"):
            pool = ServePool(_infer, _mlp_params(), workers=1, batch_size=4,
                             batch_timeout_ms=1.0, weight_dtype=wd,
                             device="cpu").start()
            try:
                outs[wd] = pool.submit(torch.from_numpy(x)).result(
                    timeout=30.0).numpy()
                if wd == "int8":
                    assert isinstance(pool._init_params["w1"],
                                      tq.QuantizedWeight)
                    # 128 x 16 < 4096 elements: stays floating, as in JAX.
                    assert isinstance(pool._init_params["w2"], torch.Tensor)
            finally:
                pool.stop()
        assert np.abs(outs[""] - outs["int8"]).max() < 0.05
        # The JAX pool on the same configuration: the same payload, and
        # answers within fp32 summation order.
        jpool = JaxServePool(_jax_infer, jax.tree.map(jnp.asarray,
                                                      _mlp_numpy()),
                             workers=1, batch_size=4, batch_timeout_ms=1.0,
                             weight_dtype="int8").start()
        try:
            jout = np.asarray(jpool.submit(jnp.asarray(x)).result(30.0))
            jw1 = jpool._init_params["w1"]
        finally:
            jpool.stop()
        _assert_same_payload(tq.quantize_weight(_mlp_params()["w1"]), jw1)
        np.testing.assert_allclose(outs["int8"], jout, rtol=0,
                                   atol=1e-5 * np.abs(jout).max())

    def test_env_knob_and_validation(self, monkeypatch):
        monkeypatch.setenv("HVDTPU_SERVE_WEIGHT_DTYPE", "int8")
        pool = ServePool(_infer, _mlp_params(), workers=1, device="cpu")
        assert pool.weight_dtype == "int8"
        pool.start()
        try:  # the environment arms the pool
            assert isinstance(pool._init_params["w1"], tq.QuantizedWeight)
        finally:
            pool.stop()
        pool_off = ServePool(_infer, _mlp_params(), weight_dtype="off",
                             device="cpu")
        assert pool_off.weight_dtype == ""
        with pytest.raises(ValueError, match="weight_dtype"):
            ServePool(_infer, _mlp_params(), weight_dtype="int4",
                      device="cpu")
        monkeypatch.setenv("HVDTPU_SERVE_WEIGHT_DTYPE", "fp16")
        with pytest.raises(ValueError, match="HVDTPU_SERVE_WEIGHT_DTYPE"):
            tenv.serve_weight_dtype()
        with pytest.raises(ValueError, match="HVDTPU_SERVE_WEIGHT_DTYPE"):
            ServePool(_infer, _mlp_params(), device="cpu")
        for alias in ("off", "none", "0", "false", "no", ""):
            monkeypatch.setenv("HVDTPU_SERVE_WEIGHT_DTYPE", alias)
            assert tenv.serve_weight_dtype() == ""

    def test_hot_swap_requantizes(self, tmp_path):
        d = str(tmp_path)
        target = {"w": torch.zeros((64, 128)), "b": torch.zeros((128,))}

        def save(value, step):
            save_checkpoint(d, {"w": torch.full((64, 128), value),
                                "b": torch.zeros((128,))}, step=step)

        def infer(p, x):
            return tq.qmatmul(x, p["w"]) + p["b"]

        save(0.5, step=1)
        pool = ServePool(infer, ckpt_dir=d, ckpt_target=target, workers=2,
                         batch_size=4, batch_timeout_ms=1.0,
                         ckpt_poll_secs=0.05, weight_dtype="int8",
                         device="cpu").start()
        try:
            x = torch.ones((64,))
            out = pool.submit(x).result(timeout=30.0).numpy()
            np.testing.assert_allclose(out, 64 * 0.5, rtol=2e-2)
            save(1.0, step=2)
            t0 = time.time()
            while len(pool.swap_log) < 2 and time.time() - t0 < 10.0:
                time.sleep(0.02)
            assert len(pool.swap_log) == 2
            assert isinstance(pool._init_params["w"], tq.QuantizedWeight)
            out = pool.submit(x).result(timeout=30.0).numpy()
            np.testing.assert_allclose(out, 64 * 1.0, rtol=2e-2)
        finally:
            pool.stop()


def _gpt2_int8_reference(sd, cfg, tokens):
    """The int8 model built by hand: fp32 weights, quantized, computing in
    ``cfg.dtype``."""
    import dataclasses

    model = GPT2LMModel(dataclasses.replace(cfg, param_dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(sd)
    tq.quantize_params(model)
    with torch.inference_mode():
        return model(tokens)[:, -1, :]


def test_gpt2_tiny_module_pool_is_int8_after_load_and_after_a_swap(tmp_path):
    d = str(tmp_path)
    cfg = GPT2Config.tiny()  # bf16 compute and storage
    sd1 = convert.init_params(cfg, seed=0)
    save_checkpoint(d, sd1, step=1)
    template = GPT2LMModel(cfg, device="cpu")

    def infer(model, tokens):
        return model(tokens)[:, -1, :]

    pool = ServePool(infer, ckpt_dir=d, ckpt_target=template, workers=2,
                     batch_size=4, batch_timeout_ms=1.0, ckpt_poll_secs=0.05,
                     weight_dtype="int8", device="cpu").start()
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 16)))

    def check_int8(model):
        dense = [m for m in model.modules() if isinstance(m, Dense)]
        assert dense and all(m.quantized for m in dense)
        assert not any(n.endswith(".weight") and "blocks" in n
                       for n, _ in model.named_parameters())
        # The rest is stored as the bf16 template stores it.
        for n, p in model.named_parameters():
            assert p.dtype == dict(template.named_parameters())[n].dtype, n

    try:
        model = pool._init_params
        check_int8(model)
        # Scales from the checkpoint's fp32 values, not bf16-rounded ones.
        want = tq.quantize_weight(sd1["transformer.blocks.0.mlp.fc.weight"].t())
        fc = model.transformer.blocks[0].mlp.fc
        assert torch.equal(fc.quantized_weight().q, want.q)
        assert torch.equal(fc.weight_scales, want.scales)
        assert template.transformer.blocks[0].mlp.fc.weight.dtype == \
            torch.bfloat16  # the template itself is untouched
        futs = [pool.submit(t) for t in tokens]
        got = torch.stack([f.result(timeout=60.0) for f in futs])
        ref = _gpt2_int8_reference(sd1, cfg, tokens)
        assert torch.equal(got, ref)
        sd2 = convert.init_params(cfg, seed=2)
        save_checkpoint(d, sd2, step=2)
        t0 = time.time()
        while len(pool.swap_log) < 2 and time.time() - t0 < 30.0:
            time.sleep(0.02)
        assert sorted(w for w, s, _, _ in pool.swap_log) == ["w0", "w1"]
        for w in pool._workers.values():
            check_int8(w.params)
        after = pool.submit(tokens[0]).result(timeout=60.0)
        assert not torch.equal(after, got[0])
        assert torch.equal(after, _gpt2_int8_reference(sd2, cfg, tokens)[0])
    finally:
        pool.stop()
