"""The port's CUDA kernels against their plain versions, on the card: the
flash-attention forward, the backward pair (dK/dV, dQ), the fused AdamW
update, the blockwise quantize/dequantize, the fused fp8 cast, the fp8 matmul
and the int8-weight matmul. Every test here needs an NVIDIA GPU with nvcc (the kernels have no
CPU mode) and skips without one. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which the card's
machine does not need). Tolerances as chip_smoke.py's: out 1e-2, lse 1e-3;
gradients 1e-2 of the largest plain gradient (bf16 outputs, P and dS
rounded to bf16 at other points of the sums); AdamW 1e-6 of the largest
plain value (every operation IEEE-rounded in the plain version's order,
only powf of the bias corrections may differ by an ulp); quantize and
dequantize bit for bit (every operation IEEE-rounded in the plain version's
order), except the int8 value of a NaN element, which is undefined in both;
the fp8 matmul 1e-4 of the largest plain output in fp32 and 8e-3 in bf16
(exact products; sums of 128 products rounded by the fp8 tensor cores, then
added in fp32 in another order; one bf16 rounding), also at K = 16,384; the
fused fp8 cast bit for bit (the same IEEE operations in the same order; a
NaN payload may differ in its sign bit), and so the fp8 state its Function
returns; the
int8-weight matmul 1e-5 of the largest plain output with fp32 activations
and 8e-3 with bf16 (exact products, fp32 sums in another order, one
rounding).
"""

import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import fused_adamw as fadam
from horovod_tpu_torch.ops import quantization as tq

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _compare(q, k, v, **kw):
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref_out.shape and out.dtype == ref_out.dtype
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert (out.float() - ref_out.float()).abs().max().item() <= 1e-2
    if fin.any():
        assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-3
    return out, lse


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["bsm", "bhsd", "bshd"])
def test_kernel_matches_plain(gen, layout, causal, d):
    b, s, h = 2, 200, 3
    shape = {"bsm": (b, s, h * d), "bhsd": (b, h, s, d), "bshd": (b, s, h, d)}
    q, k, v = (_rand(gen, shape[layout]) for _ in range(3))
    _compare(q, k, v, causal=causal, layout=layout,
             n_heads=h if layout == "bsm" else 0)


@pytest.mark.parametrize(
    "sq,skv,q_offset,kv_offset,kv_len",
    [(64, 64, 0, 0, 64), (1, 130, 129, 0, 130), (100, 300, 7, 3, 251),
     (64, 64, 0, 64, 64), (90, 90, 0, 30, 77)],
)
def test_ragged_offsets_and_empty_rows(gen, sq, skv, q_offset, kv_offset,
                                       kv_len):
    q = _rand(gen, (2, sq, 4, 64))
    k, v = _rand(gen, (2, skv, 4, 64)), _rand(gen, (2, skv, 4, 64))
    out, lse = _compare(q, k, v, causal=True, q_offset=q_offset,
                        kv_offset=kv_offset, kv_len=kv_len)
    if kv_offset > q_offset + sq - 1:
        assert torch.all(out == 0) and torch.all(torch.isneginf(lse))


def test_fused_qkv_strided_views_and_counter(gen):
    fused = _rand(gen, (2, 256, 3 * 768))
    q, k, v = fused.split(768, dim=-1)
    fa.reset_launches()
    out, _ = _compare(q, k, v, causal=True, layout="bsm", n_heads=12)
    assert fa.launches == 1 and out.is_contiguous()


def test_kernel_rejects_what_it_does_not_take(gen):
    x = _rand(gen, (1, 64, 2, 64))
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(x.float(), x.float(), x.float())
    y = _rand(gen, (1, 64, 2, 32))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(y, y, y)
    z = _rand(gen, (1, 64, 2 * 64 + 4))[..., :128].unflatten(-1, (2, 64))
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(z, z, z)


def test_gpt2_on_the_card_matches_plain_attention(gen):
    import horovod_tpu_torch as hvt

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2)
    sd = hvt.convert.init_params(cfg, seed=0)
    flash = hvt.GPT2LMModel(cfg, device="cuda")
    plain = hvt.GPT2LMModel(cfg, device="cuda", attention_fn=(
        lambda q, k, v, *, causal, mask=None:
        fa.flash_attention_reference(q, k, v, causal=causal)[0]
    ))
    flash.load_state_dict(sd)
    plain.load_state_dict(sd)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), device="cuda",
                           generator=gen)
    fa.reset_launches()
    with torch.inference_mode():
        a, b = flash(tokens), plain(tokens)
    assert fa.launches == cfg.n_layers
    assert (a - b).abs().max().item() <= 0.05 * b.abs().max().item()


@pytest.mark.parametrize("kw,err,match", [
    (dict(d_model=128, n_heads=2, dtype=torch.float32), TypeError, "bfloat16"),
    (dict(), ValueError, "head dim"),  # tiny: head dim 16
])
def test_default_attention_on_the_card_is_the_kernel_or_raises(gen, kw, err,
                                                                match):
    # use_flash=None takes the kernel for every CUDA tensor; inputs it does
    # not take raise. Plain attention runs only when asked for.
    import horovod_tpu_torch as hvt

    cfg = hvt.GPT2Config.tiny(**kw)
    m = hvt.GPT2LMModel(cfg, device="cuda")
    m.load_state_dict(hvt.convert.init_params(cfg, seed=1))
    tokens = torch.zeros((1, 16), dtype=torch.long, device="cuda")
    fa.reset_launches()
    with torch.inference_mode(), pytest.raises(err, match=match):
        m(tokens)
    plain = hvt.GPT2LMModel(dataclasses.replace(cfg, use_flash=False),
                            device="cuda")
    plain.load_state_dict(m.state_dict())
    with torch.inference_mode():
        out = plain(tokens)
    assert fa.launches == 0 and torch.isfinite(out).all()


def _bwd_compare(q, k, v, g_lse=True, **kw):
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    gen = torch.Generator(device="cuda").manual_seed(1)
    g_out = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    glse = (torch.randn(lse.shape, generator=gen, device="cuda")
            if g_lse else None)
    args = (q, k, v, out, lse, g_out, glse)
    got = fa.flash_attention_bwd(*args, **kw)
    ref = fa.flash_attention_bwd_reference(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        scale = max(r.float().abs().max().item(), 1e-6)
        assert (g.float() - r.float()).abs().max().item() <= 1e-2 * scale
    return got


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["bsm", "bhsd", "bshd"])
def test_backward_kernels_match_plain(gen, layout, causal, d):
    b, s, h = 2, 200, 3
    shape = {"bsm": (b, s, h * d), "bhsd": (b, h, s, d), "bshd": (b, s, h, d)}
    q, k, v = (_rand(gen, shape[layout]) for _ in range(3))
    _bwd_compare(q, k, v, causal=causal, layout=layout,
                 n_heads=h if layout == "bsm" else 0)


@pytest.mark.parametrize(
    "sq,skv,q_offset,kv_offset,kv_len,g_lse",
    [(64, 64, 0, 0, 64, False), (1, 130, 129, 0, 130, True),
     (100, 300, 7, 3, 251, True), (90, 90, 0, 30, 77, True)],
)
def test_backward_ragged_offsets_and_masked_rows(gen, sq, skv, q_offset,
                                                 kv_offset, kv_len, g_lse):
    q = _rand(gen, (2, sq, 4, 64))
    k, v = _rand(gen, (2, skv, 4, 64)), _rand(gen, (2, skv, 4, 64))
    dq, dk, dv = _bwd_compare(q, k, v, g_lse=g_lse, causal=True,
                              q_offset=q_offset, kv_offset=kv_offset,
                              kv_len=kv_len)
    assert torch.all(dk[:, kv_len:] == 0) and torch.all(dv[:, kv_len:] == 0)


def _rounding_sensitive_inputs(d, causal):
    """bf16 q/k/v ``[B, S, H, D]``, the kernel forward's out and lse, and an
    fp32 cotangent of out whose bf16 rounding moves ``delta = rowsum(dO *
    out)`` by about as much as the gradient itself. v = u + w: u is one row
    per (batch, head) in the first half of D, entries +-{1, 1.25, 1.5,
    1.75} (bf16-exact), w noise in the second half. The cotangent is c + e:
    c turns u pairwise, (u1, -u0, u3, -u2, ...), so c . v = 0 for every key
    and c . out is near 0; e is out's first half times 2^-10, below half a
    bf16 ulp of c, so c + e rounds to c and only the unrounded cotangent
    carries e . out."""
    b, s, h, half = 2, 200, 3, d // 2
    rs = np.random.RandomState(11)
    q = rs.standard_normal((b, s, h, d))
    k = rs.standard_normal((b, s, h, d))
    u = (rs.choice([1.0, 1.25, 1.5, 1.75], (b, 1, h, half))
         * rs.choice([-1.0, 1.0], (b, 1, h, half)))
    v = np.concatenate([np.broadcast_to(u, (b, s, h, half)),
                        rs.standard_normal((b, s, h, d - half))], axis=-1)
    c = np.zeros((b, s, h, d))
    c[..., 0:half:2] = u[..., 1::2]
    c[..., 1:half:2] = -u[..., 0::2]
    q, k, v = (torch.from_numpy(x).float().cuda().to(torch.bfloat16)
               for x in (q, k, v))
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    c = torch.from_numpy(c).float().cuda()
    e = torch.zeros_like(c)
    e[..., :half] = out[..., :half].float() * 2.0 ** -10
    g = c + e
    assert torch.equal(g.to(torch.bfloat16).float(), c)
    return q, k, v, out, lse, g


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_delta_from_the_cotangent_as_given(gen, causal, d):
    # bf16 q/k/v with an fp32 cotangent: delta comes from the cotangent as
    # given, as in _bwd_pallas and the plain version; only the products'
    # dO is rounded. Rounding it for delta too moves dq and dk far past the
    # tolerance, which the plain version on the rounded cotangent shows.
    q, k, v, out, lse, g = _rounding_sensitive_inputs(d, causal)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                            causal=causal)
    rounded = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, g.to(torch.bfloat16), causal=causal)
    torch.cuda.synchronize()
    for name, x, w, r in zip("qkv", got, want, rounded):
        scale = w.float().abs().max().item()
        assert (x.float() - w.float()).abs().max().item() <= 1e-2 * scale
        if name != "v":  # dv = P^T dO takes the rounded dO in both
            assert (r.float() - w.float()).abs().max().item() > 0.1 * scale


def test_backward_pair_is_bitwise_repeatable(gen):
    # Two kernels, no atomics: each gradient is one sum in a fixed order,
    # so two calls on the same inputs agree bit for bit.
    q, k, v = _rand(gen, (4, 1024, 3 * 768)).split(768, dim=-1)
    kw = dict(causal=True, layout="bsm", n_heads=12)
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g_out = _rand(gen, out.shape)
    g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
    first = fa.flash_attention_bwd(q, k, v, out, lse, g_out, g_lse, **kw)
    second = fa.flash_attention_bwd(q, k, v, out, lse, g_out, g_lse, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


_EDGES = [1, 63, 64, 65, 127, 128, 129, 1000]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("skv", _EDGES)
@pytest.mark.parametrize("sq", _EDGES)
def test_backward_ragged_tile_edges(gen, sq, skv, causal, d):
    # Every length around the kernels' tiles (64-key and 32/64-query
    # streams, 128-row blocks), with keys masked past kv_len < Skv; dk and
    # dv are exactly 0 there.
    kv_len = skv * 3 // 4
    q = _rand(gen, (1, sq, 2, d))
    k, v = _rand(gen, (1, skv, 2, d)), _rand(gen, (1, skv, 2, d))
    dq, dk, dv = _bwd_compare(q, k, v, causal=causal, kv_len=kv_len,
                              q_offset=max(skv - sq, 0) if causal else 0)
    assert torch.all(dk[:, kv_len:] == 0) and torch.all(dv[:, kv_len:] == 0)


def test_autograd_on_the_card_reaches_the_backward_kernels(gen, monkeypatch):
    # A CUDA tensor with grad goes through FlashAttention into the kernel
    # pair, never the plain backward.
    def refuse(*a, **kw):
        raise AssertionError("the plain backward ran for CUDA tensors")

    monkeypatch.setattr(fa, "flash_attention_bwd_reference", refuse)
    fused = _rand(gen, (2, 128, 3 * 768)).requires_grad_(True)
    q, k, v = fused.split(768, dim=-1)
    fa.reset_launches()
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True, layout="bsm",
                                           n_heads=12)
    (out.float().square().sum() + lse.sum()).backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_dkdv, fa.launches_dq) == (1, 1, 1)
    assert fused.grad is not None and torch.isfinite(fused.grad.float()).all()


@pytest.mark.parametrize("p_dtype,m_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
])
@pytest.mark.parametrize("n,offset", [(1_000_003, 0), (4099, 1), (7, 0)])
@pytest.mark.parametrize("count", [0, 3])
def test_fused_adamw_kernel_matches_plain(gen, p_dtype, m_dtype, n, offset,
                                          count):
    # offset: buffers that start off a 16-byte boundary take the scalar path.
    def rand(scale, dtype):
        x = torch.randn((n + offset,), generator=gen, device="cuda") * scale
        return x.to(dtype)[offset:]

    p, g = rand(1.0, p_dtype), rand(0.1, p_dtype)
    m, v = rand(0.01, m_dtype), rand(0.03, m_dtype).square()
    c = torch.tensor(count, dtype=torch.int32, device="cuda")
    spec = fadam.FusedAdamSpec(3e-3, weight_decay=0.05)
    want = fadam.fused_adamw_update_reference(p, m, v, g, c, spec)
    fadam.reset_launches()
    u = fadam.fused_adamw_update(p, m, v, g, c, spec)  # m, v in place
    torch.cuda.synchronize()
    assert fadam.launches == 1
    for got, ref in zip((u, m, v), want):
        assert got.dtype == ref.dtype
        scale = max(ref.float().abs().max().item(), 1e-30)
        assert (got.float() - ref.float()).abs().max().item() <= 1e-6 * scale


def test_fused_adamw_kernel_rejects_what_it_does_not_take(gen):
    x = torch.zeros((16,), device="cuda")
    c = torch.zeros((), dtype=torch.int32, device="cuda")
    spec = fadam.FusedAdamSpec(1e-3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fadam.fused_adamw_update(x.half(), x, x, x.half(), c, spec)
    with pytest.raises(TypeError, match="int32"):
        fadam.fused_adamw_update(x, x.clone(), x.clone(), x, c.long(), spec)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros((32,), device="cuda")[::2]
        fadam.fused_adamw_update(y, x.clone(), x.clone(), x, c, spec)


def test_sharded_fused_train_step_on_the_card(gen):
    # GPT-2 tiny at head dim 64 through make_train_step(sharded=True,
    # fused_update=True) on a one-rank NCCL world: every kernel launches
    # once per layer / bucket per step, and the loss falls.
    import horovod_tpu_torch as hvt
    import torch.nn.functional as F

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2,
                              param_dtype=torch.float32)
    hvt.init(backend="nccl")
    try:
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(hvt.convert.init_params(cfg, seed=0))

        def loss_fn(p, t):
            logits = torch.func.functional_call(model, p, (t[:, :-1],))
            return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

        step, opt = hvt.make_train_step(loss_fn, hvt.fused_adamw(1e-3),
                                        sharded=True, fused_update=True)
        state = hvt.init_state(model, opt)
        tokens = torch.randint(0, cfg.vocab_size, (4, 65), device="cuda",
                               generator=gen)
        fa.reset_launches()
        fadam.reset_launches()
        losses = []
        for _ in range(3):
            state, loss = step(state, tokens)
            losses.append(float(loss))
        n_buckets = len(state.opt_state.inner.mu.buffers)
        assert fa.launches == fa.launches_dkdv == fa.launches_dq == 3 * 2
        assert fadam.launches == 3 * n_buckets
        assert losses[-1] < losses[0]
        assert all(p.dtype == torch.float32 for p in state.params.values())
    finally:
        hvt.shutdown()


def _quant_input(gen, n, offset=0, zero_block=None, nan_at=None, block=256):
    x = torch.randn((n + offset,), generator=gen, device="cuda")[offset:] * 7
    if zero_block is not None:
        x[zero_block * block:(zero_block + 1) * block] = 0
    if nan_at is not None:
        x[nan_at] = float("nan")
    return x


def _quant_compare(x, block, spec):
    """Kernel vs plain on one input; returns the kernel's (q, scales)."""
    q, s = tq.quantize_blockwise(x, block, spec)
    rq, rs = tq.quantize_blockwise_reference(x, block, spec)
    d = tq.dequantize_blockwise(q, s, block)
    rd = tq.dequantize_blockwise_reference(q, s, block)
    torch.cuda.synchronize()
    assert q.dtype == rq.dtype and q.shape == rq.shape == x.shape
    assert s.shape == rs.shape and s.dtype == torch.float32
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
    keep = ~torch.isnan(x) if spec.integer else torch.ones_like(x, dtype=torch.bool)
    qb, rqb = q.view(torch.uint8), rq.view(torch.uint8)
    if not spec.integer:  # an fp8 NaN may differ from torch's in its sign bit
        both_nan = ((qb & 0x7F) == 0x7F) & ((rqb & 0x7F) == 0x7F)
        keep = keep & ~both_nan
    assert torch.equal(qb[keep], rqb[keep])
    fin = ~torch.isnan(rd)
    assert torch.equal(torch.isnan(d), ~fin)
    assert torch.equal(d[fin].view(torch.int32), rd[fin].view(torch.int32))
    return q, s


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("n,block,offset", [
    (1_000_000, 256, 0), (1000, 256, 0), (100_003, 8, 0), (100_003, 16, 0),
    (300_001, 65536, 0), (4099, 256, 1), (5000, 1000, 0), (70_001, 1025, 3),
])
def test_quantize_kernels_match_plain(gen, name, n, block, offset):
    # offset: a buffer off a 16-byte boundary takes the scalar path; blocks
    # of 1000 and 1025 the non-vector ones; 65536 and 1025 one CTA a block.
    spec = tq.INT8 if name == "int8" else tq.FP8
    x = _quant_input(gen, n, offset, zero_block=1 if n >= 2 * block else None,
                     block=block)
    tq.reset_launches()
    _, s = _quant_compare(x, block, spec)
    assert tq.launches_quant == tq.launches_dequant == 1
    if n >= 2 * block:
        assert s[1].item() == 1.0


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quantize_kernel_nan_block_gets_scale_one(gen, name):
    spec = tq.INT8 if name == "int8" else tq.FP8
    x = _quant_input(gen, 4096, nan_at=300)
    _, s = _quant_compare(x, 256, spec)
    assert s[1].item() == 1.0 and s[0].item() != 1.0


def test_quantize_kernels_reject_what_they_do_not_take(gen):
    x = torch.randn((64,), generator=gen, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        tq.quantize_blockwise(x.half(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        tq.quantize_blockwise(torch.randn((128,), device="cuda")[::2], 16)
    q, s = tq.quantize_blockwise(x, 16)
    with pytest.raises(ValueError, match="on cpu"):
        tq.dequantize_blockwise(q, s.cpu(), 16)
    with pytest.raises(TypeError, match="int8 or float8_e4m3fn"):
        tq.dequantize_blockwise(q.view(torch.uint8), s, 16)
    with pytest.raises(TypeError, match="float32"):
        tq.dequantize_blockwise(q, s.double(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        qq = torch.zeros((128,), dtype=torch.int8, device="cuda")[::2]
        tq.dequantize_blockwise(qq, s, 16)


def _tiny_quant_step(compression, **kw):
    import horovod_tpu_torch as hvt

    params = {"w": torch.randn((64, 33), device="cuda"),
              "b": torch.zeros((33,), device="cuda")}

    def loss_fn(p, batch):
        x, y = batch
        return ((x @ p["w"] + p["b"] - y) ** 2).mean()

    step, opt = hvt.make_train_step(loss_fn, hvt.fused_adamw(1e-3),
                                    compression=compression, **kw)
    return step, hvt.init_state(params, opt)


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "zero1"])
def test_quantized_train_step_on_the_card_launches_the_kernels(gen, sharded):
    from horovod_tpu_torch.ops.compression import Compression

    kw = dict(sharded=True, fused_update=True) if sharded else {}
    step, state = _tiny_quant_step(Compression.int8, **kw)
    batch = (torch.randn((16, 64), generator=gen, device="cuda"),
             torch.randn((16, 33), generator=gen, device="cuda"))
    tq.reset_launches()
    fadam.reset_launches()
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(float(loss))
    # One bucket: 2 quantize and 2 dequantize a step (the send and the
    # gather; the EF residual's dequantize and the final one).
    assert tq.launches_quant == tq.launches_dequant == 2 * 3
    assert fadam.launches == (3 if sharded else 0)
    assert losses[-1] < losses[0]
    assert state.opt_state.residual.buffers[0].device.type == "cuda"


def test_a_kernel_build_failure_propagates_out_of_the_train_step(gen,
                                                                 monkeypatch):
    # No fallback: a CUDA tensor whose kernel cannot be built raises.
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.compression import Compression

    def refuse(name):
        raise RuntimeError(f"nvcc failed to build {name}.cu (test)")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tq, "_fns", {})
    step, state = _tiny_quant_step(Compression.int8)
    batch = (torch.randn((16, 64), generator=gen, device="cuda"),
             torch.randn((16, 33), generator=gen, device="cuda"))
    tq.reset_launches()
    with pytest.raises(RuntimeError, match="quant_blockwise"):
        step(state, batch)
    assert tq.launches_quant == 0


# -- kernel 8: the fp8 matmul -------------------------------------------------

_F8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def _fp8_operand(gen, rows, cols, dtype, contiguous_dim):
    """A [rows, cols] fp8 operand with the given dim contiguous (a
    transposed view when it is dim 0)."""
    if contiguous_dim == 1:
        x = torch.randn((rows, cols), generator=gen, device="cuda")
    else:
        x = torch.randn((cols, rows), generator=gen, device="cuda").t()
    x = (x * 4).to(dtype)
    assert x.stride(contiguous_dim) == 1
    return x


def _fp8_check(x, w, out_dtype, scale=0.37):
    s = torch.tensor(scale, device="cuda")
    got = tq.fp8_matmul(x, w, s, out_dtype=out_dtype)
    ref = tq.fp8_matmul_reference(x, w, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype == out_dtype
    tol = 1e-4 if out_dtype == torch.float32 else 8e-3
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(ref.float().abs().max().item(), 1e-30), err
    return got


def _relayouts(x, w):
    """Operands kernel 8 cannot read as they lie: not K-major, or rows off
    16-byte boundaries."""
    n = 0
    for t, kd in ((x, 1), (w, 0)):
        rows = t.shape[1 - kd]
        kmaj = t.stride(kd) == 1 or t.shape[kd] == 1
        ld = t.stride(1 - kd)
        n += not (kmaj and (rows == 1 or ld % 16 == 0)
                  and t.data_ptr() % 16 == 0)
    return n


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("pair", ["e4m3-e4m3", "e5m2-e4m3", "e4m3-e5m2",
                                  "e5m2-e5m2"])
@pytest.mark.parametrize("layout", ["kk", "kn", "mk", "mn"])
@pytest.mark.parametrize("m,k,n", [(5, 300, 70), (16, 512, 128),
                                   (1, 257, 10), (130, 129, 260),
                                   (256, 8192, 192), (200, 384, 136)])
def test_fp8_matmul_kernel_matches_plain(gen, m, k, n, layout, pair,
                                         out_dtype):
    # layout: which dim of x [M, K] and of w [K, N] is contiguous. "kk" is
    # K-major, the layout kernel 8 reads; an m- or n-contiguous operand, or
    # K-major rows off 16-byte boundaries (K = 300, 257, 129), take one
    # relayout copy first. (256, 8192, 192) splits the contraction.
    fx, fw = (_F8[f] for f in pair.split("-"))
    x = _fp8_operand(gen, m, k, fx, 1 if layout[0] == "k" else 0)
    w = _fp8_operand(gen, k, n, fw, 0 if layout[1] == "k" else 1)
    tq.reset_launches()
    _fp8_check(x, w, out_dtype)
    assert tq.launches_fp8_matmul == 1
    assert tq.launches_fp8_relayout == _relayouts(x, w)
    assert tq.launches_fp8_cast == 0


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fp8_matmul_long_contraction_error(gen, out_dtype):
    # The weight gradient's contraction over a GPT-2-small step's 16,384
    # rows, K-major as the fp8 path hands it: the periodic promotion of the
    # tensor cores' partial sums to fp32 holds it to the plain version's
    # tolerance.
    g = _fp8_operand(gen, 768, 16384, torch.float8_e5m2, 1)
    x = _fp8_operand(gen, 16384, 768, torch.float8_e4m3fn, 0)
    tq.reset_launches()
    _fp8_check(g, x, out_dtype)
    assert tq.launches_fp8_relayout == 0


def test_fp8_matmul_kernel_unaligned_and_edge_operands(gen):
    # Operands off a 16-byte boundary take byte loads; K = 0 gives zeros.
    buf = (torch.randn((70 * 300 + 1,), generator=gen, device="cuda") * 4).to(
        torch.float8_e4m3fn)
    x = buf[1:].view(70, 300)
    w = _fp8_operand(gen, 300, 48, torch.float8_e4m3fn, 0)
    _fp8_check(x, w, torch.float32)
    empty = tq.fp8_matmul(x[:, :0], w[:0], torch.tensor(1.0, device="cuda"))
    assert empty.shape == (70, 48) and not empty.any()
    # NaN and saturated values go through the products as the plain
    # version's do.
    yf = x.float()
    yf[3, 5] = float("nan")
    got = tq.fp8_matmul(yf.to(torch.float8_e4m3fn), w,
                        torch.tensor(1.0, device="cuda"))
    assert torch.isnan(got[3]).all() and torch.isfinite(got[4]).all()


def test_fp8_matmul_kernel_rejects_what_it_does_not_take(gen):
    x = _fp8_operand(gen, 32, 64, torch.float8_e4m3fn, 1)
    w = _fp8_operand(gen, 64, 16, torch.float8_e4m3fn, 1)
    s = torch.tensor(1.0, device="cuda")
    with pytest.raises(ValueError, match="unit stride"):
        tq.fp8_matmul(x[:, ::2], w[::2], s)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tq.fp8_matmul(x, w, s, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="on cpu"):
        tq.fp8_matmul(x, w.cpu(), s)


def _cast_input(gen, rows, cols, dtype, specials=True, stride_pad=0):
    x = torch.randn((rows, cols + stride_pad), generator=gen, device="cuda")
    x = (x * 3)[:, :cols]
    if specials:
        flat = [float("nan"), float("inf"), -float("inf"), 1e6, -1e6, 0.0,
                -0.0, 1e-30]
        for i, v in enumerate(flat):
            x[(7 * i) % rows, (13 * i) % cols] = v
    return x.to(dtype)


def _cast_equal(got, want):
    """Bit for bit, except the sign bit of a NaN payload."""
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    gf, wf = got.float(), want.float()
    nan = torch.isnan(wf)
    assert torch.equal(torch.isnan(gf), nan)
    view = {1: torch.uint8, 4: torch.int32}[got.element_size()]
    gb = got.contiguous().view(view)
    wb = want.contiguous().view(view)
    assert torch.equal(gb[~nan], wb[~nan])


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["activation", "weight"])
@pytest.mark.parametrize("rows,cols,pad,ring", [
    (1024, 768, 0, "filled"), (96, 3072, 0, "fresh"), (130, 70, 0, "filled"),
    (33, 129, 3, "filled"), (1, 17, 0, "fresh"), (257, 64, 8, "nan")])
def test_fp8_cast_kernel_matches_plain(gen, fmt, dtype, mode, rows, cols, pad,
                                       ring):
    # Activation and weight mode, both formats, NaN, +-inf, values past
    # qmax and signed zeros in x, a fresh (all-zero) ring and one holding a
    # NaN, ragged shapes and rows off 16-byte boundaries (pad).
    wire = _F8[fmt]
    x = _cast_input(gen, rows, cols, dtype, stride_pad=pad)
    hist = torch.rand((16,), generator=gen, device="cuda") * 50
    if ring == "fresh":
        hist.zero_()
    elif ring == "nan":
        hist[3] = float("nan")
    res = None
    if mode == "weight":
        res = torch.randn((rows, cols), generator=gen, device="cuda") * 1e-3
    tq.reset_launches()
    got = tq.fp8_cast(x, hist, wire, residual=res)
    assert tq.launches_fp8_cast == 1
    want = tq.fp8_cast_reference(x, hist, wire, residual=res)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _cast_equal(a, b)
    assert got.q.stride(0) % 16 == 0 and got.qt.stride(0) % 16 == 0
    # The row-major payload alone, twice in a row (the workspace is
    # re-zeroed).
    for _ in range(2):
        only = tq.fp8_cast(x, hist, wire, transposed=False, residual=res)
        assert only.qt is None
        _cast_equal(only.q, want.q)
        _cast_equal(only.history, want.history)


def test_fp8_cast_kernel_rejects_what_it_does_not_take(gen):
    x = _cast_input(gen, 64, 64, torch.bfloat16, specials=False)
    hist = torch.ones((4,), device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tq.fp8_cast(x.half(), hist, torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="unit inner stride"):
        tq.fp8_cast(x.t(), hist, torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="on cpu"):
        tq.fp8_cast(x, hist.cpu(), torch.float8_e4m3fn)


def _fp8_linear_plain(x, w, kr, xh, kh, gh, g):
    """Fp8Linear's forward and backward written out with the plain
    matmul."""
    from horovod_tpu_torch.ops.quantization import (
        E4M3_MAX, E5M2_MAX, fp8_push_amax, fp8_saturating_cast,
        fp8_scale_from_history)

    sx = fp8_scale_from_history(xh, E4M3_MAX)
    sk = fp8_scale_from_history(kh, E4M3_MAX)
    kc = w.float() + kr
    qx = fp8_saturating_cast(x, sx, torch.float8_e4m3fn, E4M3_MAX).flatten(0, -2)
    qk = fp8_saturating_cast(kc, sk, torch.float8_e4m3fn, E4M3_MAX)
    out = tq.fp8_matmul_reference(qx, qk.t(), sx * sk, out_dtype=x.dtype)
    sg = fp8_scale_from_history(gh, E5M2_MAX)
    qg = fp8_saturating_cast(g, sg, torch.float8_e5m2, E5M2_MAX).flatten(0, -2)
    dx = tq.fp8_matmul_reference(qg, qk, sg * sk, out_dtype=x.dtype)
    dw = tq.fp8_matmul_reference(qg.t(), qx, sx * sg, out_dtype=x.dtype)
    return (out.reshape(g.shape), dx.reshape(x.shape), dw,
            (kc - qk.float() * sk), fp8_push_amax(xh, x),
            fp8_push_amax(kh, kc), fp8_push_amax(gh, g))


def test_fp8_linear_on_the_card_matches_the_plain_math(gen):
    from horovod_tpu_torch.ops.fp8 import Fp8Linear

    def rand(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    x = rand(2, 96, 256, s=2.0).to(torch.bfloat16)
    w = rand(384, 256, s=0.05).to(torch.bfloat16)
    kr = rand(384, 256, s=1e-4)
    xh, kh, gh = (rand(16, s=sc).abs() for sc in (6.0, 0.2, 0.03))
    g = rand(2, 96, 384, s=0.01).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, kr, xh, kh, gh)]
    tq.reset_launches()
    out = Fp8Linear.apply(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    assert tq.launches_fp8_matmul == 3  # forward, dX, dW
    assert tq.launches_fp8_cast == 3  # x and w forward, g backward
    assert tq.launches_fp8_relayout == 0  # the casts hand K-major payloads
    want = _fp8_linear_plain(x, w, kr, xh, kh, gh, g)
    for got, ref in zip((out.detach(),) + grads[:2], want[:3]):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 8e-3 * ref.float().abs().max().item()
    for got, ref in zip(grads[2:], want[3:]):
        assert torch.equal(got, ref)


def test_fp8_train_step_on_the_card_launches_the_kernel(gen):
    # GPT-2 tiny (head dim 64) with compute_dtype="fp8" on a one-rank NCCL
    # world: 18 fp8 matmuls a layer a step (6 forward, 6 dX, 6 dW), the
    # flash kernels once a layer, and the loss falls.
    import horovod_tpu_torch as hvt
    import torch.nn.functional as F

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2, compute_dtype="fp8",
                              param_dtype=torch.float32)
    hvt.init(backend="nccl")
    try:
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(hvt.convert.init_params(cfg, seed=0))

        def loss_fn(p, t):
            logits = torch.func.functional_call(model, p, (t[:, :-1],))
            return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

        step, opt = hvt.make_train_step(loss_fn, hvt.adamw(1e-3),
                                        compute_dtype="fp8")
        state = hvt.init_state(model, opt)
        tokens = torch.randint(0, cfg.vocab_size, (4, 65), device="cuda",
                               generator=gen)
        tq.reset_launches()
        fa.reset_launches()
        losses = []
        for _ in range(3):
            state, loss = step(state, tokens)
            losses.append(float(loss))
        assert tq.launches_fp8_matmul == 3 * 18 * cfg.n_layers
        assert tq.launches_fp8_cast == 3 * 18 * cfg.n_layers
        assert tq.launches_fp8_relayout == 0
        assert fa.launches == fa.launches_dkdv == fa.launches_dq == 3 * 2
        assert losses[-1] < losses[0]
        gauges = hvt.fp8_state_gauges(state.params)
        assert gauges["fp8.amax_max"] > 0
    finally:
        hvt.shutdown()


# -- kernel 7: the int8-weight matmul -------------------------------------------


def _int8_check(x, qw):
    got = tq.int8_weight_matmul(x, qw)
    ref = tq.int8_weight_matmul_reference(x, qw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype == x.dtype
    tol = 1e-5 if x.dtype == torch.float32 else 8e-3
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(ref.float().abs().max().item(), 1e-30), err
    return got


def _int8_weight(gen, k, n, scale=0.05):
    return tq.quantize_weight(
        torch.randn((k, n), generator=gen, device="cuda") * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(5, 300, 70), (16, 512, 128), (1, 64, 10),
                                   (130, 1000, 260), (8, 768, 2304),
                                   (300, 3072, 768), (33, 17, 129)])
def test_int8_matmul_kernel_matches_plain(gen, m, k, n, dtype):
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    qw = _int8_weight(gen, k, n)
    tq.reset_launches()
    _int8_check(x, qw)
    assert tq.launches_int8_matmul == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_int8_matmul_kernel_reads_x_through_its_strides(gen, dtype):
    qw = _int8_weight(gen, 256, 96)
    wide = torch.randn((2, 50, 3 * 256), generator=gen, device="cuda").to(dtype)
    for x in (wide[..., 256:512],                      # a fused-QKV column view
              wide[..., :256].transpose(0, 1),         # batch-transposed
              wide.reshape(-1)[1:1 + 2 * 50 * 256].view(2, 50, 256)):  # unaligned
        got = _int8_check(x, qw)
        assert got.shape == (*x.shape[:-1], 96)
        assert torch.equal(got, tq.int8_weight_matmul(x.contiguous(), qw))


def test_int8_matmul_kernel_edges_and_refusals(gen):
    qw = _int8_weight(gen, 64, 16)
    empty = tq.int8_weight_matmul(torch.zeros((0, 64), device="cuda"), qw)
    assert empty.shape == (0, 16)
    zero_k = tq.QuantizedWeight(qw.q[:0], qw.scales)
    out = tq.int8_weight_matmul(torch.ones((3, 0), device="cuda"), zero_k)
    assert out.shape == (3, 16) and not out.any()
    x = torch.randn((4, 64), generator=gen, device="cuda")
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tq.int8_weight_matmul(x.half(), qw)
    with pytest.raises(ValueError, match="on cpu"):
        tq.int8_weight_matmul(x, qw.to("cpu"))
    n_major = tq.QuantizedWeight(qw.q.contiguous(), qw.scales)
    with pytest.raises(ValueError, match="k contiguous"):
        tq.int8_weight_matmul(x, n_major)
    with pytest.raises(ValueError, match="k contiguous"):
        tq.int8_weight_matmul(torch.randn((64, 4), device="cuda").t(), qw)


def test_quantize_weight_on_the_card_is_the_cpu_payload(gen):
    w = torch.randn((768, 2304), generator=gen, device="cuda") * 0.02
    tq.reset_launches()
    on_card = tq.quantize_weight(w)
    assert tq.launches_quant == 1  # kernel 4, block = K
    on_cpu = tq.quantize_weight(w.cpu())
    assert torch.equal(on_card.q.cpu(), on_cpu.q)
    assert torch.equal(on_card.scales.cpu().view(torch.int32),
                       on_cpu.scales.view(torch.int32))
    assert on_card.q.t().is_contiguous()


def test_gpt2_int8_on_the_card_runs_kernel_7_once_a_projection(gen):
    import horovod_tpu_torch as hvt

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2,
                              param_dtype=torch.float32)
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
    tq.reset_launches()
    hvt.quantize_params(model)
    assert tq.launches_quant == 4 * cfg.n_layers
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                           generator=gen)
    tq.reset_launches()
    fa.reset_launches()
    with torch.inference_mode():
        got = model(tokens)
    assert tq.launches_int8_matmul == 4 * cfg.n_layers
    assert fa.launches == cfg.n_layers
    with torch.inference_mode():
        ref = model.to("cpu")(tokens.cpu())
    err = (got.cpu() - ref).abs().max().item()
    assert err <= 0.05 * ref.abs().max().item()


def test_int8_serve_pool_on_the_card(gen, tmp_path):
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.serve import ServePool

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2)
    hvt.save_checkpoint(str(tmp_path), hvt.convert.init_params(cfg, seed=0),
                        step=1)
    tq.reset_launches()
    pool = ServePool(lambda m, t: m(t)[:, -1, :], ckpt_dir=str(tmp_path),
                     ckpt_target=hvt.GPT2LMModel(cfg), workers=1,
                     batch_size=4, weight_dtype="int8").start()
    try:
        assert tq.launches_quant == 4 * cfg.n_layers  # one restore
        tq.reset_launches()
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                               device="cuda").cpu()
        futs = [pool.submit(t) for t in tokens]
        outs = [f.result(timeout=120.0) for f in futs]
        batches = pool.dispatcher.n_batches
        assert tq.launches_int8_matmul == 4 * cfg.n_layers * batches
        assert all(o.shape == (cfg.vocab_size,) and torch.isfinite(o).all()
                   for o in outs)
    finally:
        pool.stop()
