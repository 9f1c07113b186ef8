"""The port's fp8 training compute held against the JAX package's, on the
CPU: the delayed-scaling helpers, ``fp8_matmul``'s plain version, the
``Fp8Linear`` autograd Function against ``fp8_dot_general``'s
``custom_vjp``, the state optimizer and gauges, the ``convert`` round trip
of the fp8 state and GPT-2 tiny's fp8 logits.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances, with their reasons:

* the helpers (scale, push, saturating cast) are bit for bit with eager
  jax: the same IEEE operations in the same order;
* ``fp8_matmul_reference`` against ``fp8_matmul`` (``impl="jax"`` and the
  Pallas interpreter): the products are exact and only the order of the
  fp32 sums differs, so within 1e-6 of the largest output (fp32) and one
  bf16 rounding, 4e-3 of the largest output (bf16);
* ``Fp8Linear`` against the ``custom_vjp``: out, dx and dw as the matmul
  (the casts feeding them are bit for bit); the four state cotangents bit
  for bit;
* GPT-2 tiny's logits: fp32 within 1e-5 of the largest logit (3e-7
  seen: the order of the fp32 sums); bf16 within 6e-2 in relative L2 norm
  and 0.1 of the largest logit, the same argmax wherever the top-2 margin
  exceeds that bound. The two frameworks round to bf16 at other places
  (0.65% in relative L2 without fp8), and a bf16 ulp flips an e4m3 rounding
  (an eighth of a value) for about one element in 32; seen 2.5-3.2%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.ops import fp8 as jf8
from horovod_tpu.ops import quantization as jq
from horovod_tpu_torch import convert
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.ops import fp8 as tf8
from horovod_tpu_torch.ops import quantization as tq

_FP8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, 448.0),
        "e5m2": (jnp.float8_e5m2, torch.float8_e5m2, 57344.0)}


def _to_torch(a) -> torch.Tensor:
    """A jax or numpy array as a torch tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2):
        dt = torch.float8_e4m3fn if a.dtype == jnp.float8_e4m3fn else (
            torch.float8_e5m2)
        return torch.from_numpy(a.view(np.uint8).copy()).view(dt)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(view).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


# -- the delayed-scaling helpers -------------------------------------------


def _rings(seed):
    rs = np.random.RandomState(seed)
    return {
        "fresh": np.zeros(16, np.float32),
        "filled": np.abs(rs.standard_normal(16) * 37).astype(np.float32),
        "one_slot": np.concatenate(
            [[np.float32(3.1)], np.zeros(15, np.float32)]).astype(np.float32),
        "tiny": np.abs(rs.standard_normal(16) * 1e-30).astype(np.float32),
    }


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("ring", ["fresh", "filled", "one_slot", "tiny"])
def test_scale_from_history_bit_for_bit(fmt, ring):
    _, _, qmax = _FP8[fmt]
    hist = _rings(0)[ring]
    want = jq.fp8_scale_from_history(jnp.asarray(hist), qmax)
    got = tq.fp8_scale_from_history(torch.from_numpy(hist), qmax)
    assert got.dtype == torch.float32 and got.shape == ()
    assert _bits(got.reshape(1)) == _jbits(np.asarray(want).reshape(1))
    if ring == "fresh":
        assert float(got) == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_push_amax_bit_for_bit(dtype):
    rs = np.random.RandomState(1)
    hist = _rings(1)["filled"]
    x = (rs.standard_normal((3, 40)) * 5).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jq.fp8_push_amax(jnp.asarray(hist), jx))
    got = tq.fp8_push_amax(torch.from_numpy(hist), _to_torch(jx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == np.abs(np.asarray(jx, np.float32)).max()
    np.testing.assert_array_equal(got[1:].numpy(), hist[:-1])
    # A NaN anywhere in x lands in slot 0, as jnp.max propagates it.
    x[1, 7] = np.nan
    got = tq.fp8_push_amax(torch.from_numpy(hist), torch.from_numpy(x))
    assert np.isnan(float(got[0]))
    assert np.isnan(np.asarray(jq.fp8_push_amax(jnp.asarray(hist),
                                                jnp.asarray(x)))[0])


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("scale", [1.0, 0.0123, 3.7e-4])
def test_saturating_cast_bit_for_bit(fmt, scale):
    jdt, tdt, qmax = _FP8[fmt]
    rs = np.random.RandomState(2)
    x = (rs.standard_normal(4096) * 3).astype(np.float32)
    x[:6] = [1e6, -1e6, 0.0, -0.0, np.nan, qmax * float(scale) * 1.01]
    s = np.float32(scale)
    want = jq.fp8_saturating_cast(jnp.asarray(x), jnp.float32(s), jdt, qmax)
    got = tq.fp8_saturating_cast(torch.from_numpy(x), torch.tensor(s), tdt,
                                 qmax)
    assert got.dtype == tdt and got.shape == x.shape
    gf, wf = got.float().numpy(), np.asarray(want, np.float32)
    nan = np.isnan(wf)
    np.testing.assert_array_equal(np.isnan(gf), nan)
    # NaN payloads may differ in their sign bit; every other byte is equal.
    np.testing.assert_array_equal(_bits(got)[~nan], _jbits(want)[~nan])
    # +-1e6 saturates to +-qmax, never inf or NaN.
    assert gf[0] == qmax and gf[1] == -qmax and np.isnan(gf[4])
    assert np.isfinite(gf[~nan]).all()


# -- the fused cast (fp8_cast) -----------------------------------------------


def _cast_input(dtype, seed=4, shape=(37, 52)):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal(shape) * 3).astype(np.float32)
    # Saturation both ways, signed zeros and an element past every scale.
    x[0, :4] = [1e6, -1e6, 0.0, -0.0]
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", ["fresh", "filled", "tiny"])
def test_fp8_cast_reference_matches_jax_bit_for_bit(fmt, dtype, ring):
    """fp8_cast_reference is the JAX package's scale, saturating cast and
    amax push, with the payload in both orientations."""
    jdt, tdt, qmax = _FP8[fmt]
    jx = _cast_input(dtype)
    hist = _rings(5)[ring]
    scale = jq.fp8_scale_from_history(jnp.asarray(hist), qmax)
    want_q = jq.fp8_saturating_cast(jx, scale, jdt, qmax)
    want_h = jq.fp8_push_amax(jnp.asarray(hist), jx)
    got = tq.fp8_cast_reference(_to_torch(jx), torch.from_numpy(hist), tdt)
    assert got.q.dtype == got.qt.dtype == tdt and got.residual is None
    assert got.q.shape == jx.shape and got.qt.shape == jx.shape[::-1]
    np.testing.assert_array_equal(_bits(got.q), _jbits(want_q))
    np.testing.assert_array_equal(_bits(got.qt), _jbits(want_q).T)
    np.testing.assert_array_equal(got.history.numpy(), np.asarray(want_h))
    assert _bits(got.scale.reshape(1)) == _jbits(np.asarray(scale).reshape(1))
    # The transpose is optional.
    only_q = tq.fp8_cast_reference(_to_torch(jx), torch.from_numpy(hist), tdt,
                                   transposed=False)
    assert only_q.qt is None and torch.equal(_bits_t(only_q.q), _bits_t(got.q))


def _bits_t(t):
    return torch.from_numpy(_bits(t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cast_reference_weight_mode_matches_the_custom_vjp_state(dtype):
    """Weight mode: the error-feedback sum, its cast, amax push and new
    residual, bit for bit the JAX package's forward (ops/fp8.py:136-161)."""
    x, kern, kr, xh, kh, gh, g = _linear_inputs(dtype)
    dn = (((x.ndim - 1,), (0,)), ((), ()))
    _, res = jf8._fp8_dot_fwd(x, kern, jnp.asarray(kr), jnp.asarray(xh),
                              jnp.asarray(kh), jnp.asarray(gh), dn, dtype)
    _, jqk, _, jsk, _, _, jkh, jkr = res
    # The port's weight is [N, K]: the JAX kernel [K, N] transposed.
    w = _to_torch(kern).t().contiguous()
    got = tq.fp8_cast_reference(w, torch.from_numpy(kh), torch.float8_e4m3fn,
                                residual=torch.from_numpy(kr.T.copy()))
    np.testing.assert_array_equal(_bits(got.q), _jbits(jqk).T)
    np.testing.assert_array_equal(_bits(got.qt), _jbits(jqk))
    np.testing.assert_array_equal(got.residual.numpy().T, np.asarray(jkr))
    np.testing.assert_array_equal(got.history.numpy(), np.asarray(jkh))
    assert float(got.scale) == float(jsk)


def test_fp8_cast_on_cpu_is_the_plain_version():
    jx = _cast_input("bfloat16", seed=6)
    x = _to_torch(jx)
    hist = torch.from_numpy(_rings(6)["filled"])
    tq.reset_launches()
    got = tq.fp8_cast(x, hist, torch.float8_e5m2)
    want = tq.fp8_cast_reference(x, hist, torch.float8_e5m2)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(_bits_t(a), _bits_t(b))
    assert tq.launches_fp8_cast == 0  # a CPU tensor never launches
    # A NaN lands in slot 0 of the ring and in the payload.
    xn = x.clone()
    xn[3, 4] = float("nan")
    got = tq.fp8_cast(xn, hist, torch.float8_e4m3fn)
    assert torch.isnan(got.history[0]) and torch.isnan(got.q.float()[3, 4])
    assert torch.isnan(got.qt.float()[4, 3])
    with pytest.raises(ValueError, match="2-D"):
        tq.fp8_cast(x.reshape(-1), hist, torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="residual"):
        tq.fp8_cast(x, hist, torch.float8_e4m3fn, residual=torch.zeros(3))
    with pytest.raises(TypeError, match="float8"):
        tq.fp8_cast(x, hist, torch.float16)


# -- fp8_matmul -------------------------------------------------------------

# The reference test's pairings (tests/test_fp8_compute.py:74-78) and the
# weight-gradient one of the port's backward, e5m2 x e4m3 read transposed.
PAIRINGS = [("e4m3", "e4m3", "float32"), ("e5m2", "e4m3", "float32"),
            ("e4m3", "e4m3", "bfloat16"), ("e4m3", "e5m2", "float32"),
            ("e5m2", "e4m3", "bfloat16")]
SHAPES = [(5, 300, 70), (16, 512, 128), (1, 257, 10)]


def _fp8_operands(rs, m, k, n, fx, fw):
    xq = jnp.asarray(rs.randn(m, k), jnp.float32).astype(_FP8[fx][0])
    wq = jnp.asarray(rs.randn(k, n), jnp.float32).astype(_FP8[fw][0])
    return xq, wq


def _assert_matmul_close(got: np.ndarray, want: np.ndarray, out_dtype):
    assert got.shape == want.shape
    tol = 1e-6 if out_dtype == "float32" else 4e-3
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("impl", ["jax", "pallas"])
@pytest.mark.parametrize("fx,fw,out_dtype", PAIRINGS)
def test_fp8_matmul_reference_matches_jax(impl, fx, fw, out_dtype):
    rs = np.random.RandomState(11)
    for m, k, n in SHAPES:
        xq, wq = _fp8_operands(rs, m, k, n, fx, fw)
        want = jq.fp8_matmul(xq, wq, jnp.float32(0.37), impl=impl,
                             out_dtype=getattr(jnp, out_dtype))
        got = tq.fp8_matmul_reference(_to_torch(xq), _to_torch(wq),
                                      torch.tensor(0.37),
                                      out_dtype=getattr(torch, out_dtype))
        assert got.dtype == getattr(torch, out_dtype)
        _assert_matmul_close(got.float().numpy(), np.asarray(want, np.float32),
                             out_dtype)


def test_fp8_matmul_on_cpu_is_the_plain_version_for_any_layout():
    rs = np.random.RandomState(12)
    xq, wq = _fp8_operands(rs, 24, 40, 33, "e5m2", "e4m3")
    x, w = _to_torch(xq), _to_torch(wq)
    scale = torch.tensor(0.5)
    want = tq.fp8_matmul_reference(x, w, scale)
    tq.reset_launches()
    # Transposed views of both operands, as the backward pass hands them.
    xt = x.t().contiguous().t()
    wt = w.t().contiguous().t()
    for a, b in ((x, w), (xt, w), (x, wt), (xt, wt)):
        torch.testing.assert_close(tq.fp8_matmul(a, b, scale), want,
                                   rtol=0, atol=0)
    assert tq.launches_fp8_matmul == 0  # a CPU tensor never launches
    with pytest.raises(ValueError, match="disagree"):
        tq.fp8_matmul(x, w[:-1], scale)
    with pytest.raises(TypeError, match="float8"):
        tq.fp8_matmul(x.float(), w, scale)
    with pytest.raises(ValueError, match="one scale"):
        tq.fp8_matmul(x, w, torch.ones(2))


# -- Fp8Linear against fp8_dot_general's custom_vjp --------------------------


def _linear_inputs(dtype, seed=3, m=(2, 12), k=48, n=40, hlen=16):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((*m, k)) * 2).astype(np.float32)
    kern = (rs.standard_normal((k, n)) * 0.05).astype(np.float32)
    kr = (rs.standard_normal((k, n)) * 1e-4).astype(np.float32)
    # Non-zero rings, so every scale is != 1.
    xh, kh, gh = (np.abs(rs.standard_normal(hlen) * s).astype(np.float32)
                  for s in (6.0, 0.2, 0.03))
    g = (rs.standard_normal((*m, n)) * 0.01).astype(np.float32)
    jdt = getattr(jnp, dtype)
    return (jnp.asarray(x).astype(jdt), jnp.asarray(kern).astype(jdt), kr,
            xh, kh, gh, jnp.asarray(g).astype(jdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_linear_matches_the_custom_vjp(dtype):
    x, kern, kr, xh, kh, gh, g = _linear_inputs(dtype)
    dn = (((x.ndim - 1,), (0,)), ((), ()))

    def f(x, k, kr, xh, kh, gh):
        return jf8.fp8_dot_general(x, k, kr, xh, kh, gh, dn, dtype)

    jout, vjp = jax.vjp(f, x, kern, *(jnp.asarray(a) for a in (kr, xh, kh, gh)))
    jdx, jdk, jkr, jxh, jkh, jgh = vjp(g)

    leaves = [_to_torch(x), _to_torch(kern).t().contiguous(),
              torch.from_numpy(kr.T.copy()), torch.from_numpy(xh),
              torch.from_numpy(kh), torch.from_numpy(gh)]
    leaves = [t.requires_grad_(True) for t in leaves]
    out = tf8.Fp8Linear.apply(*leaves)
    grads = torch.autograd.grad(out, leaves, _to_torch(g))
    tdx, tdw, tkr, txh, tkh, tgh = grads

    assert out.dtype == leaves[0].dtype and out.shape == jout.shape
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    _assert_matmul_close(out.detach().float().numpy(), f32(jout), dtype)
    _assert_matmul_close(tdx.float().numpy(), f32(jdx), dtype)
    _assert_matmul_close(tdw.float().numpy().T, f32(jdk), dtype)
    assert tdx.dtype == tdw.dtype == leaves[0].dtype
    # The new state, bit for bit: the residual (port layout [N, K]) and the
    # three pushed rings.
    np.testing.assert_array_equal(tkr.numpy().T, np.asarray(jkr))
    for t, j in ((txh, jxh), (tkh, jkh), (tgh, jgh)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(txh[0]) > 0 and float(tgh[0]) > 0
    assert np.abs(tkr.numpy()).max() > 0


def test_fp8_linear_forward_alone_leaves_the_state():
    x, kern, kr, xh, kh, gh, _ = _linear_inputs("float32")
    state = [torch.from_numpy(a.copy()) for a in (kr.T, xh, kh, gh)]
    before = [s.clone() for s in state]
    with torch.no_grad():
        out = tf8.Fp8Linear.apply(_to_torch(x), _to_torch(kern).t(), *state)
    assert out.shape == (2, 12, 40)
    assert all(torch.equal(a, b) for a, b in zip(state, before))


# -- state plumbing ----------------------------------------------------------


def _state_params():
    return {"dense.weight": torch.tensor([1.0, 2.0, 3.0]),
            "dense.fp8_x_amax_history": torch.zeros(4)}


def test_fp8_state_optimizer_overwrites_state_and_masks_moments():
    params = _state_params()
    assert tf8.has_fp8_state(params)
    assert not tf8.has_fp8_state({"dense.weight": torch.zeros(3)})
    opt = tf8.fp8_state_optimizer(topt.adamw(1e-2))
    st = opt.init(params)
    new_ring = torch.tensor([5.0, 0.0, 0.0, 0.0])
    grads = {"dense.weight": torch.ones(3),
             "dense.fp8_x_amax_history": new_ring}
    updates, st = opt.update(grads, st, params)
    new = {k: params[k] + updates[k] for k in params}
    # The state leaf lands exactly on the gradient-carried value.
    assert torch.equal(new["dense.fp8_x_amax_history"], new_ring)
    # The regular leaf saw AdamW: the JAX package's masked optax.adamw.
    jopt = jf8.fp8_state_optimizer(optax.adamw(1e-2, weight_decay=1e-4))
    jparams = {"dense": {"kernel": jnp.asarray([1.0, 2.0, 3.0]),
                         "fp8_x_amax_history": jnp.zeros(4)}}
    jst = jopt.init(jparams)
    jup, _ = jopt.update({"dense": {"kernel": jnp.ones(3),
                                    "fp8_x_amax_history": jnp.asarray(
                                        new_ring.numpy())}}, jst, jparams)
    np.testing.assert_allclose(updates["dense.weight"].numpy(),
                               np.asarray(jup["dense"]["kernel"]), rtol=1e-6)
    # No moments were made for the ring: the inner state holds the regular
    # leaf only.
    assert set(st.mu) == set(st.nu) == {"dense.weight"}
    with pytest.raises(ValueError, match="needs params"):
        opt.update(grads, st)


def test_fp8_state_optimizer_is_harmless_without_state():
    params = {"w": torch.tensor([1.0, -2.0])}
    grads = {"w": torch.tensor([0.5, 0.25])}
    plain, wrapped = topt.adamw(1e-2), tf8.fp8_state_optimizer(topt.adamw(1e-2))
    u0, _ = plain.update(grads, plain.init(params), params)
    u1, _ = wrapped.update(grads, wrapped.init(params), params)
    assert torch.equal(u0["w"], u1["w"])


def test_has_fp8_state_and_gauges_match_the_reference():
    assert tf8.fp8_state_gauges({"w": torch.ones(2)}) == {}
    params = {"fp8_x_amax_history": torch.tensor([2.0, 1.0]),
              "fp8_k_residual": torch.full((3,), 2.0)}
    g = tf8.fp8_state_gauges(params)
    assert g["fp8.amax_max"] == 2.0
    np.testing.assert_allclose(g["fp8.scale_min"], 2.0 / 448.0, rtol=1e-6)
    np.testing.assert_allclose(g["fp8.cast_residual_norm"], np.sqrt(12.0),
                               rtol=1e-6)
    # On a whole GPT-2 tiny with random state, the three gauges equal the
    # JAX package's on the same values.
    flax, _ = _flax_fp8_params(seed=7)
    model = GPT2LMModel(GPT2Config.tiny(compute_dtype="fp8"), device="cpu")
    model.load_state_dict(convert.params_from_flax(flax))
    params = dict(model.named_parameters())
    assert tf8.has_fp8_state(params) and jf8.has_fp8_state(flax)
    want = jf8.fp8_state_gauges(jax.tree.map(jnp.asarray, flax))
    got = tf8.fp8_state_gauges(params)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


# -- convert and the model ----------------------------------------------------


def _flax_fp8_params(seed=0, dtype=jnp.bfloat16, tokens=None):
    """GPT-2 tiny's fp8 parameters from the JAX model's init, with random
    non-zero rings and residuals (so every scale is != 1)."""
    cfg = jgpt2.GPT2Config.tiny(dtype=dtype, compute_dtype="fp8")
    if tokens is None:
        tokens = np.zeros((1, 8), np.int32)
    params = jgpt2.GPT2LMModel(cfg).init(
        jax.random.PRNGKey(seed), jnp.asarray(tokens))
    params = jax.tree.map(np.asarray, params)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        key = str(getattr(path[-1], "key", ""))
        if key.endswith("_amax_history"):
            scale = {"fp8_x": 4.0, "fp8_k": 0.1, "fp8_g": 0.02}[key[:5]]
            return np.abs(rs.standard_normal(leaf.shape) * scale).astype(
                np.float32)
        if key == "fp8_k_residual":
            return (rs.standard_normal(leaf.shape) * 1e-3).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, params), cfg


def test_convert_round_trip_carries_the_fp8_state():
    flax, cfg = _flax_fp8_params(seed=4)
    sd = convert.params_from_flax(flax)
    model = GPT2LMModel(GPT2Config.tiny(compute_dtype="fp8",
                                        param_dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(sd)  # strict: every fp8 leaf present, no extras
    mha = flax["params"]["transformer"]["block_1"]["MultiHeadAttention_0"]
    d = cfg.d_model
    # The residual takes its kernel's reshape and transpose.
    np.testing.assert_array_equal(
        sd["transformer.blocks.1.attn.qkv.value.fp8_k_residual"].numpy(),
        mha["value"]["Fp8DotGeneral_0"]["fp8_k_residual"].reshape(d, d).T)
    np.testing.assert_array_equal(
        sd["transformer.blocks.1.attn.out.fp8_k_residual"].numpy(),
        mha["out"]["Fp8DotGeneral_0"]["fp8_k_residual"].reshape(d, d).T)
    np.testing.assert_array_equal(
        sd["transformer.blocks.1.attn.qkv.key.fp8_g_amax_history"].numpy(),
        mha["key"]["Fp8DotGeneral_0"]["fp8_g_amax_history"])
    back = convert.params_to_flax(dict(model.named_parameters()), cfg.n_heads)
    flat_a = jax.tree_util.tree_flatten_with_path(flax)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_init_params_gives_zero_fp8_state():
    cfg = GPT2Config.tiny(compute_dtype="fp8", param_dtype=torch.float32)
    sd = convert.init_params(cfg, seed=0)
    plain = convert.init_params(GPT2Config.tiny(), seed=0)
    state = {k: v for k, v in sd.items() if tf8.has_fp8_state({k: v})}
    assert len(state) == cfg.n_layers * 6 * 4
    assert all(not v.any() for v in state.values())
    assert sd["transformer.blocks.0.attn.qkv.query.fp8_k_residual"].shape == (
        cfg.d_model, cfg.d_model)
    assert sd["transformer.blocks.0.mlp.fc.fp8_k_residual"].shape == (
        cfg.d_ff, cfg.d_model)
    # The regular parameters are those of the bf16 model from the same seed.
    assert {k: v for k, v in sd.items() if k not in state}.keys() == plain.keys()
    assert all(torch.equal(sd[k], plain[k]) for k in plain)
    GPT2LMModel(cfg, device="cpu").load_state_dict(sd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt2_tiny_fp8_logits_match_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tokens = np.random.RandomState(5).randint(0, 512, (2, 32)).astype(np.int32)
    flax, cfg = _flax_fp8_params(seed=5, dtype=jdt, tokens=tokens)
    want = np.asarray(jgpt2.GPT2LMModel(cfg).apply(flax, jnp.asarray(tokens)))
    model = GPT2LMModel(GPT2Config.tiny(dtype=tdt, compute_dtype="fp8"),
                        device="cpu")
    model.load_state_dict(convert.params_from_flax(flax))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        bound = 0.1 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound
        assert np.linalg.norm(got - want) <= 6e-2 * np.linalg.norm(want)
        top2 = np.sort(want, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > bound
        np.testing.assert_array_equal(got.argmax(-1)[decided],
                                      want.argmax(-1)[decided])


def test_compute_dtype_env_arms_the_model(monkeypatch):
    monkeypatch.setenv("HVDTPU_COMPUTE_DTYPE", "fp8")
    monkeypatch.setenv("HVDTPU_FP8_AMAX_HISTORY", "4")
    model = GPT2LMModel(GPT2Config.tiny(), device="cpu")
    params = dict(model.named_parameters())
    assert tf8.has_fp8_state(params)
    assert params["transformer.blocks.0.mlp.proj.fp8_g_amax_history"].shape == (4,)
    # An explicit "" wins over the environment.
    assert not tf8.has_fp8_state(dict(
        GPT2LMModel(GPT2Config.tiny(compute_dtype=""),
                    device="cpu").named_parameters()))
    monkeypatch.setenv("HVDTPU_COMPUTE_DTYPE", "fp4")
    with pytest.raises(ValueError, match="fp4"):
        GPT2LMModel(GPT2Config.tiny(), device="cpu")
    with pytest.raises(ValueError, match="not recognized"):
        GPT2LMModel(GPT2Config.tiny(compute_dtype="int8"), device="cpu")
