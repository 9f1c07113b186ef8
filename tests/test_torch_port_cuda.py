"""The port's CUDA kernels against their plain versions, on the card: the
flash-attention forward (ragged tile edges, query tiles without keys and a
bitwise repeat included), the backward pair (dK/dV, dQ), the fused AdamW
update, the blockwise quantize/dequantize, the fused fp8 cast, the fp8 matmul
and the int8-weight matmul; and the paths of the zoo that reach them (a
head-dim-64 BERT through the kernels, per-block remat bit for bit, ResNet's
SAME padding and BatchNorm against the CPU, ``prefetch_to_device``), and
Adasum's fp32 schedule over stacked CUDA tensors against the fp64 fold with
the object and state helpers on a one-rank NCCL world; the overlap
pipeline on it (overlap on bit for bit overlap off, ZeRO-1 fused and the
int8 wire; the bucket work and kernels 4 and 5 on a side stream, by the
profiler's stream ids) and int8 activation storage (a boundary's kernel
path bit for bit its plain path, a ``channels_last`` boundary bit for bit
the NHWC plain one); the backward pair on a flash-ring hop whose key
block lies wholly after its query block (zeros, no NaN). Every
test here needs an NVIDIA GPU with nvcc (the kernels have no
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
rounding); Adasum's fp32 schedule 1e-5 relative L2 of the fp64 fold a leaf
(fp32 products and row sums against fp64 sums).
"""

import dataclasses
import threading

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


_FWD_EDGES = [1, 63, 65, 127, 129, 1000]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("skv", _FWD_EDGES)
@pytest.mark.parametrize("sq", _FWD_EDGES)
def test_forward_ragged_tile_edges(gen, sq, skv, causal, d):
    # Every length around the forward's 128-row query and key tiles (most of
    # a TMA box zero-filled), keys masked past kv_len < Skv, causal with
    # q_offset > 0; a second call equals the first bit for bit.
    q = _rand(gen, (1, sq, 2, d))
    k, v = _rand(gen, (1, skv, 2, d)), _rand(gen, (1, skv, 2, d))
    kw = dict(causal=causal, kv_len=max(skv * 3 // 4, 1),
              q_offset=max(skv - sq, 1) if causal else 0)
    out, lse = _compare(q, k, v, **kw)
    again = fa.flash_attention_with_lse(q, k, v, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["bsm", "bhsd", "bshd"])
def test_forward_query_tiles_without_keys(gen, layout, d):
    # kv_offset = 150 puts the first 150 queries before every key: their
    # rows (a whole 128-row tile among them) give zeros and -inf, not NaN.
    b, s, h = 2, 300, 2
    shape = {"bsm": (b, s, h * d), "bhsd": (b, h, s, d), "bshd": (b, s, h, d)}
    q, k, v = (_rand(gen, shape[layout]) for _ in range(3))
    out, lse = _compare(q, k, v, causal=True, kv_offset=150, layout=layout,
                        n_heads=h if layout == "bsm" else 0)
    o4 = fa._view4(out, layout, h)
    assert torch.all(o4[:, :150] == 0) and torch.isfinite(o4).all()
    assert torch.all(torch.isneginf(lse[..., :150]))
    assert torch.isfinite(lse[..., 150:]).all()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sm_scale", [0.3, 0.0, -0.2])
def test_forward_any_sign_of_sm_scale(gen, sm_scale, d):
    # sm_scale > 0 takes the instantiation that maxes the raw scores and
    # folds the scale into exp2's FMA; zero and negative scales the one
    # that scales first. Both compute the plain version's function.
    q = _rand(gen, (2, 200, 2, d))
    k, v = _rand(gen, (2, 300, 2, d)), _rand(gen, (2, 300, 2, d))
    _compare(q, k, v, causal=True, q_offset=100, kv_len=290,
             sm_scale=sm_scale)


def test_forward_is_bitwise_repeatable(gen):
    q, k, v = _rand(gen, (4, 1024, 3 * 768)).split(768, dim=-1)
    kw = dict(causal=True, layout="bsm", n_heads=12)
    first = fa.flash_attention_with_lse(q, k, v, **kw)
    second = fa.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_forward_copies_an_expanded_operand(gen):
    # A stride-0 dimension (one key head shared by both heads) is no tensor
    # map's: the wrapper copies it, and the kernel runs.
    q = _rand(gen, (1, 130, 2, 64))
    k = _rand(gen, (1, 130, 1, 64)).expand(1, 130, 2, 64)
    v = _rand(gen, (1, 130, 2, 64))
    fa.reset_launches()
    _compare(q, k, v, causal=True)
    assert fa.launches == 1


def test_kernel_rejects_what_it_does_not_take(gen):
    # The kernels take bf16 and fp32 at head dims 1 to 256: fp16 and a head
    # dim of 272 raise, and a bf16 head-dim-64 view off 16-byte rows (the
    # wgmma route's) still raises rather than taking the general kernels.
    x = _rand(gen, (1, 64, 2, 64))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(x.half(), x.half(), x.half())
    y = _rand(gen, (1, 64, 2, 272))
    with pytest.raises(ValueError, match="head dim 1 to 256"):
        fa.flash_attention(y, y, y)
    z = _rand(gen, (1, 64, 2 * 64 + 4))[..., :128].unflatten(-1, (2, 64))
    fa.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(z, z, z)
    assert fa.launches == fa.launches_general == 0


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


@pytest.mark.parametrize("kw,tol", [
    (dict(d_model=128, n_heads=2, dtype=torch.float32), 1e-4),  # head dim 64
    (dict(), 0.05),  # tiny: bf16, head dim 16
    (dict(dtype=torch.float32), 1e-4),  # tiny in fp32, head dim 16
    (dict(dtype=torch.float16), None),  # no kernel takes fp16: it raises
])
def test_default_attention_on_the_card_is_the_kernel_or_raises(gen, kw, tol):
    # use_flash=None takes a kernel for every CUDA tensor: the fp32 model and
    # the tiny head-dim-16 one run the forward on fwd_route's route (the
    # sm90 kernel), held to their plain twins (bf16 to the tolerance of the
    # head-dim-64 model above, fp32 to 1e-4 of the largest logit); fp16,
    # which no kernel takes, raises. Plain attention runs only when asked
    # for.
    import horovod_tpu_torch as hvt

    cfg = hvt.GPT2Config.tiny(**kw)
    m = hvt.GPT2LMModel(cfg, device="cuda")
    m.load_state_dict(hvt.convert.init_params(cfg, seed=1))
    plain = hvt.GPT2LMModel(dataclasses.replace(cfg, use_flash=False),
                            device="cuda")
    plain.load_state_dict(m.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), device="cuda",
                           generator=gen)
    fa.reset_launches()
    if tol is None:
        with torch.inference_mode(), pytest.raises(
                TypeError, match="bfloat16 or float32"):
            m(tokens)
    with torch.inference_mode():
        out = plain(tokens)
        assert fa.launches == 0 and torch.isfinite(out).all()
        if tol is not None:
            got = m(tokens)
            route = fa.fwd_route(cfg.dtype, cfg.d_model // cfg.n_heads)[0]
            assert fa.launches == cfg.n_layers
            assert (fa.launches_general, fa.launches_sm90_fwd) == (
                (cfg.n_layers, 0) if route == "general"
                else (0, cfg.n_layers))
            err = (got - out).abs().max().item()
            assert err <= tol * out.abs().max().item()


# The general kernels (csrc/flash_general.cu) at a few of chip_smoke.py's
# [flash-general] shapes, against their plain versions: bf16 to the
# tolerances above, fp32 to 2e-5 (out and lse absolute, gradients of the
# largest plain gradient; the fp32 plain version's matmuls in full fp32,
# torch's default allow_tf32 = False).
_GENERAL_TOL = {torch.bfloat16: (1e-2, 1e-3, 1e-2),
                torch.float32: (2e-5, 2e-5, 2e-5)}


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_len=250), dict(causal=True, kv_offset=100),
    dict(causal=True, sm_scale=-0.1, kv_len=290), dict(g_lse=False),
])
@pytest.mark.parametrize("d", [12, 16, 48, 96, 160, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_general_kernels_match_plain(gen, dtype, d, kw):
    kw = dict(kw)
    g_lse = kw.pop("g_lse", True)
    b, sq, skv, h = 2, 150, 300, 3
    q = torch.randn((b, sq, h * d), generator=gen, device="cuda").to(dtype)
    k, v = torch.randn((b, skv, 2 * h * d), generator=gen,
                       device="cuda").to(dtype).split(h * d, dim=-1)
    kw.update(layout="bsm", n_heads=h)
    fa.reset_launches()
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    gl = (torch.randn(lse.shape, generator=gen, device="cuda") if g_lse
          else None)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, gl, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, gl, **kw)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, gl, **kw)
    torch.cuda.synchronize()
    # The forward on the route fwd_route picks, the backward pair on the
    # route bwd_route picks (the sm90 kernels where they take the head dim).
    sm90_fwd = fa.fwd_route(dtype, d)[0] == "sm90"
    sm90 = fa.bwd_route(dtype, d)[0] == "sm90"
    assert (fa.launches_general, fa.launches_sm90_fwd) == (
        (0, 1) if sm90_fwd else (1, 0))
    assert (fa.launches_general_dq, fa.launches_general_dkdv) == (
        (0, 0) if sm90 else (2, 2))
    assert (fa.launches_sm90_dq, fa.launches_sm90_dkdv) == (
        (2, 2) if sm90 else (0, 0))
    assert (fa.launches, fa.launches_dq, fa.launches_dkdv) == (1, 2, 2)
    tol_o, tol_l, tol_g = _GENERAL_TOL[dtype]
    assert out.dtype == dtype and out.shape == ref_out.shape
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_o
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= tol_l
    for x, y, r in zip(got, again, ref):
        assert x.dtype == dtype and torch.equal(x, y)
        scale = max(r.float().abs().max().item(), 1e-6)
        assert (x.float() - r.float()).abs().max().item() <= tol_g * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_general_kernels_take_a_ring_hops_future_block(gen, dtype):
    # Every key after every query (a flash-ring hop's future block): out 0,
    # lse -inf, zero gradients and no NaN, at a head dim off the compiled
    # sizes.
    q, k, v = torch.randn((1, 70, 3 * 2 * 40), generator=gen,
                          device="cuda").to(dtype).split(80, dim=-1)
    kw = dict(causal=True, kv_offset=100, layout="bsm", n_heads=2)
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, torch.ones_like(lse),
                                   **kw)
    torch.cuda.synchronize()
    assert torch.all(out == 0) and torch.all(torch.isneginf(lse))
    assert all(torch.all(x == 0) for x in grads)


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


@pytest.mark.parametrize("d", [64, 128])
def test_backward_of_a_hop_wholly_in_the_future_is_zero(gen, d):
    """A flash-ring hop whose key block lies wholly after its query block
    (parallel/sp.py at kv_rank > r): every row's lse is -inf and out 0, and
    kernels 2 and 3 give zero gradients, no NaN, for nonzero cotangents of
    both outputs; through combine_blocks beside the diagonal hop the
    gradients are finite and the diagonal hop's alone."""
    b, s, h = 2, 300, 3
    q, k, v = (_rand(gen, (b, s, h, d)) for _ in range(3))
    future = dict(causal=True, q_offset=0, kv_offset=s)
    out, lse = fa.flash_attention_with_lse(q, k, v, **future)
    assert torch.isneginf(lse).all() and not out.any()
    g_out = _rand(gen, out.shape)
    g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g_out, g_lse, **future)
    torch.cuda.synchronize()
    for x in grads:
        assert not torch.isnan(x).any() and not x.any()

    def ring_grads(with_future):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o, l = fa.flash_attention_with_lse(*xs, causal=True)
        if with_future:
            o_f, l_f = fa.flash_attention_with_lse(*xs, **future)
            o, l = fa.combine_blocks(o.float(), l, o_f.float(), l_f)
        ((o.float() * g_out.float()).sum() + (l * g_lse).sum()).backward()
        return [x.grad for x in xs]

    merged, alone = ring_grads(True), ring_grads(False)
    for m, a in zip(merged, alone):
        assert torch.isfinite(m).all()
        scale = max(a.float().abs().max().item(), 1e-6)
        assert (m.float() - a.float()).abs().max().item() <= 1e-2 * scale


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


# The sm90 backward pair (csrc/flash_bwd_sm90_general.cu: bf16 on wgmma fed
# by TMA, fp32 on the tensor cores as 3xTF32) against its plain version,
# flash_attention_bwd_reference, at the general kernels' tolerances above:
# fused-QKV views, kv_len < Skv, a ring hop partly and wholly masked, an
# lse cotangent or none, sm_scale < 0, Sq = 1 and Skv = 1; at every
# (dtype, d_pad) of SM90_BWD_SIZES, head dims on and off the compiled size.
_SM90_DIMS = [(torch.bfloat16, d)
              for d in (8, 16, 24, 32, 40, 48, 96, 120, 160, 256)] + [
    (torch.float32, d) for d in (4, 12, 16, 32, 48, 64, 80, 128)]
_SM90_CASES = {
    "plain": dict(b=2, sq=150, skv=300, kw=dict()),
    "kv_len": dict(b=2, sq=150, skv=300, kw=dict(kv_len=250)),
    "ring_hop": dict(b=1, sq=150, skv=300, kw=dict(causal=True,
                                                   kv_offset=100)),
    "future_hop": dict(b=1, sq=70, skv=70, kw=dict(causal=True,
                                                   kv_offset=100)),
    "neg_scale": dict(b=1, sq=150, skv=300, kw=dict(
        causal=True, kv_len=290, sm_scale=-0.1)),
    "no_g_lse": dict(b=1, sq=130, skv=130, kw=dict(causal=True), g_lse=False),
    "sq1": dict(b=2, sq=1, skv=70, kw=dict(causal=True, q_offset=69)),
    "skv1": dict(b=1, sq=70, skv=1, kw=dict()),
}


def _sm90_operands(gen, dtype, b, sq, skv, h, d):
    """q, k, v as column views of fused projections (k and v of one)."""
    q = torch.randn((b, sq, h * d), generator=gen, device="cuda").to(dtype)
    k, v = torch.randn((b, skv, 2 * h * d), generator=gen,
                       device="cuda").to(dtype).split(h * d, dim=-1)
    return q, k, v


def _sm90_pair(gen, dtype, d, case, h=3, g_dtype=None):
    c = _SM90_CASES[case]
    q, k, v = _sm90_operands(gen, dtype, c["b"], c["sq"], c["skv"], h, d)
    kw = dict(c["kw"], layout="bsm", n_heads=h)
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(
        g_dtype or dtype)
    gl = (torch.randn(lse.shape, generator=gen, device="cuda")
          if c.get("g_lse", True) else None)
    return (q, k, v, out, lse, g, gl), kw


def _sm90_check(args, kw, dtype):
    fa.reset_launches()
    got = fa.flash_attention_bwd(*args, **kw)
    ref = fa.flash_attention_bwd_reference(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.launches_sm90_dq, fa.launches_sm90_dkdv) == (1, 1)
    assert (fa.launches_dq, fa.launches_dkdv) == (1, 1)
    assert (fa.launches_general_dq, fa.launches_general_dkdv) == (0, 0)
    tol = _GENERAL_TOL[dtype][2]
    for x, r in zip(got, ref):
        assert x.dtype == dtype and x.shape == r.shape
        assert torch.isfinite(x.float()).all()
        scale = max(r.float().abs().max().item(), 1e-6)
        assert (x.float() - r.float()).abs().max().item() <= tol * scale
    return got


@pytest.mark.parametrize("case", sorted(_SM90_CASES))
@pytest.mark.parametrize("dtype,d", _SM90_DIMS)
def test_sm90_backward_pair_matches_plain(gen, dtype, d, case):
    assert fa.bwd_route(dtype, d)[0] == "sm90"
    args, kw = _sm90_pair(gen, dtype, d, case)
    dq, dk, dv = _sm90_check(args, kw, dtype)
    if case == "future_hop":
        assert not dq.any() and not dk.any() and not dv.any()
    if case == "kv_len":
        h, d_ = kw["n_heads"], dk.shape[-1] // kw["n_heads"]
        tail = dk.unflatten(-1, (h, d_))[:, 250:]
        assert not tail.any() and not dv.unflatten(-1, (h, d_))[:, 250:].any()


@pytest.mark.parametrize("d", [16, 48, 96])
def test_sm90_backward_delta_from_an_fp32_cotangent(gen, d):
    # bf16 q/k/v with an fp32 cotangent: delta from the cotangent as given,
    # the products' dO rounded to bf16, as the plain version does.
    args, kw = _sm90_pair(gen, torch.bfloat16, d, "ring_hop",
                          g_dtype=torch.float32)
    _sm90_check(args, kw, torch.bfloat16)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 16),
                                     (torch.bfloat16, 96),
                                     (torch.float32, 64),
                                     (torch.float32, 16)])
def test_sm90_backward_pair_is_bitwise_repeatable(gen, dtype, d):
    # No atomics: two calls on the same inputs agree bit for bit, at the
    # shapes of [train-fp32] and [zoo-tiny] (cut in batch).
    h = 768 // d if d < 64 else 12
    q, k, v = torch.randn((2, 1024, 3 * h * d), generator=gen,
                          device="cuda").to(dtype).split(h * d, dim=-1)
    kw = dict(causal=True, layout="bsm", n_heads=h)
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    gl = torch.randn(lse.shape, generator=gen, device="cuda")
    first = fa.flash_attention_bwd(q, k, v, out, lse, g, gl, **kw)
    second = fa.flash_attention_bwd(q, k, v, out, lse, g, gl, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, gl, **kw)
    for x, r in zip(first, ref):
        scale = r.float().abs().max().item()
        tol = _GENERAL_TOL[dtype][2]
        assert (x.float() - r.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 48),
                                     (torch.float32, 64)])
def test_sm90_backward_launches_from_a_fresh_thread(gen, dtype, d):
    # A thread that has made no CUDA call has no context bound: the entry
    # binds the tensors' device before it encodes its tensor maps.
    args, kw = _sm90_pair(gen, dtype, d, "kv_len")
    want = fa.flash_attention_bwd_reference(*args, **kw)
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(fa.flash_attention_bwd(*args, **kw))
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    for x, r in zip(got[0], want):
        scale = r.float().abs().max().item()
        tol = _GENERAL_TOL[dtype][2]
        assert (x.float() - r.float()).abs().max().item() <= tol * scale


def test_sm90_backward_counts_launches_by_route(gen):
    # launches_dq / launches_dkdv count every route; launches_sm90_* and
    # launches_general_* their own; reset_launches zeroes them all.
    fa.reset_launches()
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 48),
                     (torch.float32, 64), (torch.bfloat16, 12),
                     (torch.float32, 160)):
        args, kw = _sm90_pair(gen, dtype, d, "plain", h=2)
        fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkdv) == (5, 5)
    assert (fa.launches_sm90_dq, fa.launches_sm90_dkdv) == (2, 2)
    assert (fa.launches_general_dq, fa.launches_general_dkdv) == (2, 2)
    fa.reset_launches()
    assert (fa.launches_dq, fa.launches_sm90_dq, fa.launches_sm90_dkdv,
            fa.launches_general_dq) == (0, 0, 0, 0)


def test_sm90_backward_raises_on_a_view_tma_cannot_describe(gen):
    # bf16 head dim 48 takes the sm90 route; q/k/v whose rows are not
    # 16-byte aligned raise, with no launch and no fallback to the general
    # kernels.
    fused = torch.randn((1, 64, 2 * 48 + 4), generator=gen,
                        device="cuda").to(torch.bfloat16)
    x = fused[..., 2:98].unflatten(-1, (2, 48))
    assert not fa._rows_aligned(x)
    out = torch.zeros_like(x)
    lse = torch.zeros((1, 2, 64), device="cuda")
    fa.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bwd(x, x, x, out, lse, torch.ones_like(x))
    assert (fa.launches_dq, fa.launches_dkdv) == (0, 0)


# The sm90 forward (csrc/flash_fwd_sm90_general.cu: bf16 on wgmma fed by
# TMA, fp32 on the tensor cores as 3xTF32) against its plain version at
# the general kernels' tolerances above, at test_general_kernels_match_
# plain's head dims and keyword cases and a few more sizes, wherever
# fwd_route picks it (every (dtype, d_pad) of SM90_FWD_SIZES, head dims on
# and off the compiled size), on fused-QKV views, with Sq = 1, Skv = 1 and
# a ring hop's wholly masked block besides.
_SM90_FWD_DIMS = [
    (dtype, d)
    for dtype, dims in ((torch.bfloat16, (8, 16, 24, 40, 48, 96, 120, 160,
                                          256)),
                        (torch.float32, (4, 12, 16, 32, 48, 64, 80, 96, 128,
                                         160, 256)))
    for d in dims if fa.fwd_route(dtype, d)[0] == "sm90"]
_SM90_FWD_CASES = {
    "plain": dict(b=2, sq=150, skv=300, kw=dict()),
    "kv_len": dict(b=2, sq=150, skv=300, kw=dict(kv_len=250)),
    "ring_hop": dict(b=1, sq=150, skv=300, kw=dict(causal=True,
                                                   kv_offset=100)),
    "future_hop": dict(b=1, sq=70, skv=70, kw=dict(causal=True,
                                                   kv_offset=100)),
    "neg_scale": dict(b=1, sq=150, skv=300, kw=dict(
        causal=True, kv_len=290, sm_scale=-0.1)),
    "causal_long": dict(b=1, sq=1030, skv=1030, kw=dict(causal=True)),
    "sq1": dict(b=2, sq=1, skv=70, kw=dict(causal=True, q_offset=69)),
    "skv1": dict(b=1, sq=70, skv=1, kw=dict()),
}


def _sm90_fwd_check(q, k, v, kw, dtype):
    fa.reset_launches()
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_sm90_fwd, fa.launches_general) == (
        1, 1, 0)
    tol_o, tol_l, _ = _GENERAL_TOL[dtype]
    assert out.dtype == dtype and out.shape == ref_out.shape
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_o
    if fin.any():
        assert (lse[fin] - ref_lse[fin]).abs().max().item() <= tol_l
    return out, lse


@pytest.mark.parametrize("case", sorted(_SM90_FWD_CASES))
@pytest.mark.parametrize("dtype,d", _SM90_FWD_DIMS)
def test_sm90_forward_matches_plain(gen, dtype, d, case):
    c = _SM90_FWD_CASES[case]
    q, k, v = _sm90_operands(gen, dtype, c["b"], c["sq"], c["skv"], 3, d)
    out, lse = _sm90_fwd_check(q, k, v, dict(c["kw"], layout="bsm",
                                             n_heads=3), dtype)
    if case == "future_hop":
        assert not out.any() and torch.isneginf(lse).all()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 16),
                                     (torch.bfloat16, 96),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64),
                                     (torch.float32, 16)])
def test_sm90_forward_is_bitwise_repeatable(gen, dtype, d):
    # The persistent grid deals items to blocks in a fixed order and each
    # row is one block's sums in a fixed order: two calls agree bit for bit,
    # at the shapes of [train-fp32] and [zoo-tiny] (cut in batch).
    assert fa.fwd_route(dtype, d)[0] == "sm90"
    h = 768 // d if d < 64 else 12
    q, k, v = torch.randn((2, 1024, 3 * h * d), generator=gen,
                          device="cuda").to(dtype).split(h * d, dim=-1)
    kw = dict(causal=True, layout="bsm", n_heads=h)
    first = _sm90_fwd_check(q, k, v, kw, dtype)
    second = fa.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 48),
                                     (torch.float32, 64)])
def test_sm90_forward_launches_from_a_fresh_thread(gen, dtype, d):
    # A thread that has made no CUDA call has no context bound: the entry
    # binds the tensors' device before it encodes its tensor maps.
    q, k, v = _sm90_operands(gen, dtype, 2, 150, 300, 3, d)
    kw = dict(kv_len=250, layout="bsm", n_heads=3)
    want = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            with torch.no_grad():
                got.append(fa.flash_attention_with_lse(q, k, v, **kw))
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    tol_o, tol_l, _ = _GENERAL_TOL[dtype]
    assert (got[0][0].float() - want[0].float()).abs().max().item() <= tol_o
    assert (got[0][1] - want[1]).abs().max().item() <= tol_l


def test_sm90_forward_counts_launches_by_route(gen):
    # launches counts every route; launches_sm90_fwd and launches_general
    # their own; reset_launches zeroes them all.
    fa.reset_launches()
    with torch.no_grad():
        for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 48),
                         (torch.float32, 64), (torch.bfloat16, 12),
                         (torch.float32, 160)):
            q, k, v = _sm90_operands(gen, dtype, 2, 150, 300, 2, d)
            fa.flash_attention_with_lse(q, k, v, layout="bsm", n_heads=2)
    torch.cuda.synchronize()
    assert fa.launches == 5
    assert (fa.launches_sm90_fwd, fa.launches_general) == (2, 2)
    fa.reset_launches()
    assert (fa.launches, fa.launches_sm90_fwd, fa.launches_general) == (
        0, 0, 0)


def test_sm90_forward_raises_on_a_view_tma_cannot_describe(gen):
    # bf16 head dim 48 takes the sm90 forward; a q view whose rows are not
    # 16-byte aligned raises, with no launch and no fallback to the general
    # kernel.
    fused = torch.randn((1, 64, 2 * 48 + 4), generator=gen,
                        device="cuda").to(torch.bfloat16)
    x = fused[..., 2:98].unflatten(-1, (2, 48))
    y = torch.randn((1, 64, 2, 48), generator=gen,
                    device="cuda").to(torch.bfloat16)
    assert not fa._rows_aligned(x) and fa._rows_aligned(y)
    fa.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_with_lse(x, y, y)
    assert (fa.launches, fa.launches_sm90_fwd, fa.launches_general) == (
        0, 0, 0)


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


_GPT2_PRODUCTS = {"qkv": (768, 2304), "out": (768, 768), "fc": (768, 3072),
                  "proj": (3072, 768)}


@pytest.mark.parametrize("m", [8192, 8], ids=["batch", "decode"])
@pytest.mark.parametrize("name", sorted(_GPT2_PRODUCTS))
def test_int8_matmul_kernel_at_gpt2_small_products(gen, name, m):
    # The serving batch (8 x 1024 rows, read as the model's [B, S, K]) and a
    # decode-sized one (8 rows, a split contraction): within INT8_TOL, and a
    # second call equal to the first bit for bit.
    k, n = _GPT2_PRODUCTS[name]
    x = torch.randn((8, m // 8, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    qw = _int8_weight(gen, k, n, scale=0.02)
    tq.reset_launches()
    got = _int8_check(x, qw)
    assert tq.launches_int8_matmul == 1 and tq.launches_int8_relayout == 0
    assert tq.launches_int8_matmul_reduce == (1 if m == 8 else 0)
    assert torch.equal(got, tq.int8_weight_matmul(x, qw))


@pytest.mark.parametrize("m,k,n", [(8192, 768, 768), (8, 3072, 768),
                                   (8, 768, 2304), (33, 300, 129),
                                   (130, 1000, 260)],
                         ids=["unsplit", "split16", "split6", "ragged",
                              "ragged-wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_int8_matmul_kernel_fuses_the_bias_bit_for_bit(gen, m, k, n, dtype):
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    qw = _int8_weight(gen, k, n)
    b = torch.randn((n,), generator=gen, device="cuda")
    tq.reset_launches()
    fused = tq.int8_weight_matmul(x, qw, b)
    unfused = _int8_check(x, qw) + b.to(dtype)  # held against the plain
    torch.cuda.synchronize()
    assert tq.launches_int8_matmul == 2
    assert torch.equal(fused, unfused)


def _in_fresh_thread(fn):
    """``fn()`` in a new thread, one that has made no CUDA call yet (no
    context bound); its exception is raised here."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as exc:  # raised in the caller
            box["exc"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "exc" in box:
        raise box["exc"]
    return box["out"]


@pytest.mark.parametrize("kernel",
                         ["int8_matmul", "flash_fwd", "flash_bwd", "fp8_matmul"])
def test_tma_kernels_launch_from_a_fresh_thread(gen, kernel):
    # The C entries bind the card's context before they encode tensor maps,
    # which cuTensorMapEncodeTiled refuses in a thread with none bound.
    q = _rand(gen, (2, 256, 2, 64))
    if kernel == "int8_matmul":
        x = _rand(gen, (64, 256))
        warm, qw = _int8_weight(gen, 256, 96), _int8_weight(gen, 256, 96)
        tq.int8_weight_matmul(x, warm)  # the allocator's blocks, not qw's map

        def fn():
            return tq.int8_weight_matmul(x, qw)
    elif kernel == "flash_fwd":
        def fn():
            return fa.flash_attention_with_lse(q, q, q, causal=True)[0]
    elif kernel == "flash_bwd":
        out, lse = fa.flash_attention_with_lse(q, q, q, causal=True)
        g_out = _rand(gen, tuple(out.shape))

        def fn():
            return fa.flash_attention_bwd(q, q, q, out, lse, g_out,
                                          causal=True)[0]
    else:
        x_q = torch.randn((256, 512), generator=gen, device="cuda").to(
            torch.float8_e4m3fn)
        w_q = torch.randn((512, 256), generator=gen, device="cuda").to(
            torch.float8_e4m3fn)
        scale = torch.ones((), device="cuda")

        def fn():
            return tq.fp8_matmul(x_q, w_q, scale)
    if kernel != "int8_matmul":
        fn()
    torch.cuda.synchronize()
    got = _in_fresh_thread(fn)
    torch.cuda.synchronize()
    assert torch.equal(got, fn())


def test_fp8_matmul_entry_binds_the_context_in_a_fresh_thread(gen):
    # hvt_fp8_matmul called through ctypes from a thread that has made no
    # CUDA call, with no torch call in it first: the entry itself must bind
    # the card's context before cuTensorMapEncodeTiled encodes its maps.
    # (fp8_cast.cu, the fp8 path's other entry, encodes no tensor map: its
    # loads and stores are plain global accesses, so it needs no binding.)
    m, n, k = 256, 256, 512
    x_q = torch.randn((m, k), generator=gen, device="cuda").to(
        torch.float8_e4m3fn)
    w_nk = torch.randn((n, k), generator=gen, device="cuda").to(
        torch.float8_e4m3fn)
    scale = torch.ones((), device="cuda")
    out = torch.zeros((m, n), dtype=torch.float32, device="cuda")
    entry = tq._kernel("hvt_fp8_matmul")
    args = (x_q.data_ptr(), w_nk.data_ptr(), out.data_ptr(), None,
            scale.data_ptr(), None, m, n, k, k, k, n, 0, 0, 0, 1,
            out.device.index, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    rc = _in_fresh_thread(lambda: entry(*args))
    torch.cuda.synchronize()
    assert rc == 0, f"cudaError_t {rc}"
    want = tq.fp8_matmul_reference(x_q, w_nk.t(), scale)
    assert (out - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_int8_matmul_split_calls_from_two_threads_on_one_stream(gen):
    # ServePool's workers are threads launching on one stream: two threads
    # calling split products (M = 8) of different sizes at once, each call
    # bit for bit its single-threaded result, held against the plain version.
    cases = []
    for k, n in ((3072, 768), (768, 2304)):
        x = _rand(gen, (8, k))
        qw = _int8_weight(gen, k, n)
        b = _rand(gen, (n,))
        tq.reset_launches()
        want = _int8_check(x, qw) + b
        assert tq.launches_int8_matmul_reduce == 1
        cases.append((x, qw, b, want))
    start = threading.Barrier(len(cases))
    outs = [[] for _ in cases]

    def run(i):
        x, qw, b, _ = cases[i]
        start.wait()
        for _ in range(200):
            outs[i].append(tq.int8_weight_matmul(x, qw, b))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for (_, _, _, want), got in zip(cases, outs):
        assert len(got) == 200
        assert all(torch.equal(g, want) for g in got)


def test_int8_matmul_kernel_relayout_counts(gen):
    qw = _int8_weight(gen, 256, 96)
    wide = _rand(gen, (2, 50, 3 * 256))
    tq.reset_launches()
    for x in (wide[..., :256].contiguous(),            # aligned [B, S, K]
              wide[..., 256:512],                      # a fused-QKV column view
              wide[..., :256].transpose(0, 1)):        # batch-transposed
        _int8_check(x, qw)
    assert tq.launches_int8_relayout == 0 and tq.launches_int8_matmul == 3
    x = _rand(gen, (5, 300))  # rows of 600 bytes, weight rows of 300
    _int8_check(x, _int8_weight(gen, 300, 70))
    assert tq.launches_int8_relayout == 1 and tq.launches_int8_matmul == 4


def test_gpt2_int8_forward_fuses_every_bias(gen):
    import horovod_tpu_torch as hvt

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2,
                              param_dtype=torch.float32)
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
    for m in model.modules():  # nonzero biases, so the add shows
        if isinstance(m, hvt.models.transformer.Dense):
            with torch.no_grad():
                m.bias.normal_(generator=gen)
    hvt.quantize_params(model)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                           generator=gen)
    fc = model.transformer.blocks[0].mlp.fc
    seen = []
    fc.register_forward_hook(lambda mod, inp, out: seen.append((inp[0], out)))
    tq.reset_launches()
    with torch.inference_mode():
        model(tokens)
    assert tq.launches_int8_matmul == 4 * cfg.n_layers
    assert tq.launches_int8_relayout == 0
    x, out = seen[0]
    want = (tq.int8_weight_matmul(x, fc.quantized_weight())
            + fc.bias.to(torch.bfloat16))
    assert torch.equal(out, want)


@pytest.mark.parametrize("head_dim", [8, 16, 64])
def test_kv_heads_kernels_match_plain_bit_for_bit(gen, head_dim):
    # The int8 KV cache's codec: kernels 4 and 5 at block = head_dim, one
    # launch each, bit for bit the plain versions; an all-zero head gets
    # scale 1. The input starts 4 bytes past a 16-byte boundary (and at
    # head_dim 8 every other row of the payload is off one).
    shape = (2, 5, 3, head_dim)
    n = int(np.prod(shape))
    x = (torch.randn((n + 1,), generator=gen, device="cuda") * 3)[1:]
    x = x.reshape(shape)
    x[1, 2, 0] = 0.0
    tq.reset_launches()
    q, s = tq.quantize_kv_heads(x)
    rq, rs = tq.quantize_kv_heads_reference(x)
    assert tq.launches_quant == 1
    assert q.dtype == torch.int8 and tuple(s.shape) == shape[:-1]
    assert torch.equal(q, rq)
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
    assert s[1, 2, 0].item() == 1.0
    off = torch.empty((n + 1,), dtype=torch.int8, device="cuda")[1:]
    off.copy_(q.reshape(-1))
    for payload in (q, off.reshape(shape)):
        d = tq.dequantize_kv_heads(payload, s)
        rd = tq.dequantize_kv_heads_reference(payload, s)
        assert torch.equal(d.view(torch.int32), rd.view(torch.int32))
    assert tq.launches_dequant == 2


class _CountingModel:
    """A model's ``extend`` calls, counted."""

    def __init__(self, model):
        self.model, self.calls = model, 0
        self.n_layers = model.n_layers
        self.n_heads, self.head_dim = model.n_heads, model.head_dim

    def extend(self, *args):
        self.calls += 1
        return self.model.extend(*args)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_decode_engine_int8_kv_on_the_card_matches_the_cpu(gen, spec):
    from horovod_tpu_torch.serve import (CacheLM, CacheLMConfig,
                                         DecodeEngine, perturbed_params)

    cfg = CacheLMConfig(vocab=32, n_layers=2, n_heads=2, head_dim=8,
                        max_positions=256)
    prompts = [[5, 9], [3, 1, 4], [7, 2], [11, 4, 1]]
    outs = {}
    for device in ("cpu", "cuda"):
        model = _CountingModel(CacheLM(cfg, block_size=8))
        params = model.model.init_params(0, device=device)
        kw = dict(spec_k=3, draft_params=perturbed_params(params, 0.05),
                  draft_model=model) if spec else {}
        eng = DecodeEngine(model, params, workers=1, rows=2, kv_blocks=32,
                           kv_block_size=8, max_seq_len=64, kv_dtype="int8",
                           device=device, **kw).start()
        tq.reset_launches()
        try:
            outs[device] = [f.result(timeout=60)
                            for f in [eng.submit(p, 16) for p in prompts]]
        finally:
            eng.stop()
        # Every extend gathers k and v (2 dequantizes) and its write
        # quantizes them (2 quantizes); the CPU launches nothing.
        want = 2 * model.calls if device == "cuda" else 0
        assert tq.launches_quant == tq.launches_dequant == want
    assert outs["cuda"] == outs["cpu"]


# -- the zoo, remat and the input path on the card -------------------------------


def _grad_rel(a, b):
    num = sum(float((a[n].float() - b[n].float()).norm()) ** 2 for n in b)
    den = sum(float(b[n].float().norm()) ** 2 for n in b)
    return (num / den) ** 0.5


def test_bert_head_dim_64_through_the_kernels_matches_plain_attention(gen):
    # BERT with head dim 64 (d 128, 2 heads, 2 layers), non-causal: the
    # kernel path (1 forward, 1 dK/dV, 1 dQ launch a layer) against plain
    # attention on the card; logits within 0.05 of the largest, gradients
    # within 5e-2 relative L2 (chip_smoke's [train] bound). A padding mask
    # takes plain attention: no launch.
    import horovod_tpu_torch as hvt

    cfg = hvt.BertConfig.tiny(d_model=128, n_heads=2,
                              param_dtype=torch.float32)
    sd = hvt.convert.init_bert_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda",
                           generator=gen)
    out = {}
    for use_flash in (None, False):
        m = hvt.BertModel(dataclasses.replace(cfg, use_flash=use_flash))
        m.load_state_dict(sd)
        fa.reset_launches()
        logits = m(tokens)
        names, params = zip(*m.named_parameters())
        grads = torch.autograd.grad(logits.float().square().mean(), params,
                                    allow_unused=True)  # wtt: no types
        out[use_flash] = (logits.detach(), {
            n: g for n, g in zip(names, grads) if g is not None},
            (fa.launches, fa.launches_dkdv, fa.launches_dq))
    assert out[None][2] == (2, 2, 2) and out[False][2] == (0, 0, 0)
    ref = out[False][0].float()
    err = (out[None][0].float() - ref).abs().max().item()
    assert err <= 0.05 * ref.abs().max().item(), err
    assert _grad_rel(out[None][1], out[False][1]) <= 5e-2
    fa.reset_launches()
    m(tokens, attention_mask=torch.ones_like(tokens))
    assert fa.launches == 0


@pytest.mark.parametrize("compute_dtype", ["", "fp8"])
def test_remat_dots_saveable_gradients_bit_for_bit_on_the_card(
        gen, compute_dtype):
    # Per-block dots_saveable remat against remat off on the card: the
    # kernels are deterministic, so every gradient -- with fp8 compute the
    # new amax rings and weight residual too -- equals bit for bit, and the
    # forward kernel runs twice a layer (forward and recompute).
    import horovod_tpu_torch as hvt

    tokens = torch.randint(0, 512, (4, 128), device="cuda", generator=gen)
    grads, counts = {}, {}
    for remat in ("none", "dots_saveable"):
        cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2, remat=remat,
                                  compute_dtype=compute_dtype,
                                  param_dtype=torch.float32)
        m = hvt.GPT2LMModel(cfg)
        m.load_state_dict(hvt.convert.init_params(cfg, seed=1))
        fa.reset_launches()
        tq.reset_launches()
        loss = m(tokens).float().logsumexp(-1).mean()
        gs = torch.autograd.grad(loss, list(m.parameters()))
        grads[remat] = dict(zip([n for n, _ in m.named_parameters()], gs))
        counts[remat] = (fa.launches, fa.launches_dkdv, fa.launches_dq,
                         tq.launches_fp8_matmul)
    assert counts["none"][:3] == (2, 2, 2)
    assert counts["dots_saveable"][:3] == (4, 2, 2)
    if compute_dtype == "fp8":
        assert any(".fp8_" in n for n in grads["none"])
        assert counts["none"][3] == 18 * 2
        # the six forward products of each layer run again in the recompute
        assert counts["dots_saveable"][3] == 24 * 2
    for n, g in grads["none"].items():
        assert torch.equal(grads["dots_saveable"][n], g), n


def test_resnet18_same_padding_and_batchnorm_on_the_card_match_the_cpu(gen):
    # fp32 with TF32 off: logits and the updated running statistics of a
    # train-mode forward at 64 x 64 (the stem pads (2, 3) at odd totals),
    # channels_last on the card, within 1e-4 of the CPU.
    import horovod_tpu_torch as hvt

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = torch.randn((4, 3, 64, 64), generator=gen, device="cuda")
        cpu = hvt.ResNet18(num_classes=10, dtype=torch.float32, device="cpu")
        sd = hvt.convert.init_resnet_params(cpu, seed=0)
        cpu.load_state_dict(sd)
        card = hvt.ResNet18(num_classes=10, dtype=torch.float32)
        card.load_state_dict(sd)
        with torch.no_grad():
            want = cpu(x.cpu())
            got = card(x)
        assert (got.cpu() - want).abs().max().item() <= 1e-4
        for (name, a), (_, b) in zip(card.named_buffers(),
                                     cpu.named_buffers()):
            assert (a.cpu() - b).abs().max().item() <= 1e-5, name
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def test_prefetch_to_device_batches_equal_the_hosts(gen):
    import horovod_tpu_torch as hvt

    x = np.random.RandomState(0).standard_normal((40, 3, 8, 8)).astype(
        np.float32)
    y = np.arange(40)
    batches = hvt.ShardedBatches([x, y], 8, hvt.ShardedIndexSampler(
        40, seed=1, rank=0, world_size=1))
    host = list(batches)
    staged = list(hvt.prefetch_to_device(iter(batches), depth=3))
    assert len(staged) == len(host) == 5
    for (hx, hy, hi), (dx, dy, di) in zip(host, staged):
        assert dx.device.type == "cuda" and dx.dtype == torch.float32
        assert torch.equal(dx.cpu(), torch.from_numpy(hx))
        assert torch.equal(dy.cpu(), torch.from_numpy(hy))
        assert torch.equal(di.cpu(), torch.from_numpy(hi))


# -- Adasum's arithmetic and the object helpers on the card ----------------


def _rel_l2(a, b):
    return float((a.double() - b).norm() / b.norm())


@pytest.mark.parametrize("n", [3, 4])
def test_adasum_schedule_on_the_card_matches_the_fp64_fold(gen, n):
    # The fp32 VHDD schedule over n virtual ranks (stacked CUDA tensors),
    # per leaf, against the fp64 fold, which pairs alike at 3 and 4 ranks:
    # every leaf within 1e-5 relative L2 (chip_smoke's [train-adasum] 4.).
    from horovod_tpu_torch.ops import adasum

    shapes = {"w": (300, 70), "b": (70,), "z": (5,), "h": (2048,)}
    trees = [{k: torch.randn(s, generator=gen, device="cuda") * (1 + i)
              for k, s in shapes.items()} for i in range(n)]
    for t in trees:
        t["z"].zero_()
    got = adasum.adasum_stacked(trees)
    for k in shapes:
        want = adasum.adasum_fold(torch.stack([t[k] for t in trees]))
        assert got[k].device.type == "cuda" and got[k].dtype == torch.float32
        if k == "z":
            assert torch.equal(got[k], torch.zeros_like(got[k]))
        else:
            assert _rel_l2(got[k], want) <= 1e-5, k


def test_object_helpers_on_a_one_rank_nccl_world(gen):
    import horovod_tpu_torch as hvt

    hvt.init(backend="nccl")
    try:
        obj = {"s": "text", "i": 7, "a": np.arange(5, dtype=np.float32)}
        got = hvt.broadcast_object(obj)
        assert got["s"] == "text" and got["i"] == 7
        np.testing.assert_array_equal(got["a"], obj["a"])
        assert hvt.allgather_object(obj)[0]["i"] == 7
        params = {"w": torch.randn((33, 7), generator=gen, device="cuda"),
                  "h": torch.randn((9,), generator=gen,
                                   device="cuda").to(torch.bfloat16)}
        out = hvt.broadcast_parameters(params)
        assert all(torch.equal(out[k], params[k]) for k in params)
        opt = hvt.adamw(1e-3)
        state = opt.init(params)
        st = hvt.broadcast_optimizer_state({"opt": state, "name": "adam"})
        assert st["name"] == "adam" and torch.equal(st["opt"].count,
                                                    state.count)
        x = torch.arange(6.0, device="cuda").reshape(3, 2)
        assert torch.equal(hvt.allgather(x), x)
        y, recv = hvt.alltoall(x, splits=[3])
        assert torch.equal(y, x) and recv.tolist() == [3]
    finally:
        hvt.shutdown()


# -- the overlap pipeline and int8 activation storage ---------------------------


def _overlap_run(gen, overlap, **kw):
    """Two steps of GPT-2 tiny (head dim 64, bf16 compute, fp32 masters) at
    accum_steps=2 on the one-rank NCCL world, a threshold that makes several
    buckets; the parameters and every optimizer-state tensor after each."""
    import horovod_tpu_torch as hvt
    import torch.nn.functional as F

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2,
                              param_dtype=torch.float32)
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(hvt.convert.init_params(cfg, seed=0))

    def loss_fn(p, t):
        logits = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

    step, opt = hvt.make_train_step(loss_fn, kw.pop("opt"), accum_steps=2,
                                    threshold_bytes=1 << 18, overlap=overlap,
                                    **kw)
    state = hvt.init_state({n: p.detach().clone()
                            for n, p in model.named_parameters()}, opt)
    tokens = torch.randint(0, cfg.vocab_size, (4, 65), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    out = []
    for _ in range(2):
        state, loss = step(state, tokens)
        out.append(({n: p.detach().clone() for n, p in state.params.items()},
                    [t.clone() for t in _state_tensors(state.opt_state)],
                    float(loss)))
    return out


def _state_tensors(tree):
    from horovod_tpu_torch.ops.fusion import FlatBuckets

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, FlatBuckets):
        return list(tree.buffers)
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _state_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _state_tensors(x)]
    return []


@pytest.mark.parametrize("variant", ["zero1-fused", "int8-wire"])
def test_overlap_on_equals_off_bit_for_bit_on_one_rank_nccl(gen, variant):
    import horovod_tpu_torch as hvt

    kw = ({"opt": hvt.fused_adamw(1e-3), "sharded": True,
           "fused_update": True} if variant == "zero1-fused" else
          {"opt": hvt.adamw(1e-3), "compression": hvt.Compression.int8})
    hvt.init(backend="nccl")
    try:
        off = _overlap_run(gen, False, **dict(kw))
        on = _overlap_run(gen, True, **dict(kw))
    finally:
        hvt.shutdown()
    for (p0, s0, l0), (p1, s1, l1) in zip(off, on):
        assert l0 == l1
        assert all(torch.equal(p0[n], p1[n]) for n in p0)
        assert len(s0) == len(s1) and all(
            torch.equal(a, b) for a, b in zip(s0, s1))


def _kernel_streams(prof):
    """(name, stream id) of every CUDA kernel a profile recorded."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append((e.name(), e.device_resource_id()))
    return out


def test_overlap_bucket_work_and_kernels_4_5_run_on_a_side_stream(gen):
    import horovod_tpu_torch as hvt
    from torch.profiler import ProfilerActivity, profile

    hvt.init(backend="nccl")
    try:
        _overlap_run(gen, True, opt=hvt.adamw(1e-3),
                     compression=hvt.Compression.int8)  # warm
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _overlap_run(gen, True, opt=hvt.adamw(1e-3),
                         compression=hvt.Compression.int8)
            torch.cuda.synchronize()
    finally:
        hvt.shutdown()
    ks = _kernel_streams(prof)
    backward = {s for n, s in ks if "flash_bwd" in n}
    quant = {s for n, s in ks if "quantize_blockwise" in n}
    assert backward and quant
    # Every quantize and dequantize ran on a side stream: none on the
    # stream the backward ran on (the default stream here).
    assert not quant & backward, (quant, backward)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_boundary_kernel_path_is_its_plain_path(gen, dtype):
    from horovod_tpu_torch.ops import actquant as aq

    x = (torch.randn((3, 1000, 77), generator=gen, device="cuda") * 4).to(
        dtype)
    tq.reset_launches()
    with aq.activate("int8"):
        got = aq.boundary(x)
        want = aq.boundary(x.cpu())
    torch.cuda.synchronize()
    assert tq.launches_quant == 1 and tq.launches_dequant == 1
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


def test_channels_last_boundary_is_the_nhwc_plain_one(gen):
    from horovod_tpu_torch.ops import actquant as aq

    x = torch.randn((4, 96, 14, 14), generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with aq.activate("int8"):
        got = aq.boundary(x, nhwc=True)
        # The plain boundary of the NHWC tensor, flattened in its order.
        want = aq.boundary(x.permute(0, 2, 3, 1).contiguous().cpu())
    torch.cuda.synchronize()
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.permute(0, 2, 3, 1).cpu(), want)


# -- the gradient guard's skip flag in kernel 6 ------------------------------


@pytest.mark.parametrize("p_dtype,m_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
])
@pytest.mark.parametrize("n,offset", [(1_000_003, 0), (4099, 1), (7, 0)])
def test_fused_adamw_skip_flag(gen, p_dtype, m_dtype, n, offset):
    # ok = 0: every update element -0.0 and the moments untouched, in place
    # or out of place; ok = 1: bit for bit the flagless kernel.
    def rand(scale, dtype):
        x = torch.randn((n + offset,), generator=gen, device="cuda") * scale
        return x.to(dtype)[offset:]

    p, g = rand(1.0, p_dtype), rand(0.1, p_dtype)
    g[0] = float("nan")
    m, v = rand(0.01, m_dtype), rand(0.03, m_dtype).square()
    c = torch.tensor(3, dtype=torch.int32, device="cuda")
    spec = fadam.FusedAdamSpec(3e-3, weight_decay=0.05)
    for ok_value in (0, 1):
        ok = torch.tensor(ok_value, dtype=torch.int32, device="cuda")
        mk, vk = m.clone(), v.clone()
        fadam.reset_launches()
        u = fadam.fused_adamw_update(p, mk, vk, g, c, spec, ok)
        torch.cuda.synchronize()
        assert fadam.launches == 1
        want = fadam.fused_adamw_update_reference(p, m, v, g, c, spec, ok)
        if ok_value == 0:
            assert torch.equal(mk, m) and torch.equal(vk, v)
            assert (u == 0).all() and torch.signbit(u.float()).all()
            assert torch.equal(p + u, p)
            for got, ref in zip((u, mk, vk), want):
                assert torch.equal(got, ref)
        else:
            mf, vf = m.clone(), v.clone()
            uf = fadam.fused_adamw_update(p, mf, vf, g, c, spec)
            assert torch.equal(u[1:], uf[1:]) and torch.equal(mk[1:], mf[1:])
            assert torch.equal(vk[1:], vf[1:])


def test_fused_adamw_skip_flag_rejects_a_bool_or_cpu_flag(gen):
    x = torch.zeros((16,), device="cuda")
    c = torch.zeros((), dtype=torch.int32, device="cuda")
    spec = fadam.FusedAdamSpec(1e-3)
    with pytest.raises(TypeError, match="ok must be an int32"):
        fadam.fused_adamw_update(x, x.clone(), x.clone(), x, c, spec,
                                 torch.tensor(True, device="cuda"))
    with pytest.raises(TypeError, match="ok must be an int32"):
        fadam.fused_adamw_update(x, x.clone(), x.clone(), x, c, spec,
                                 torch.tensor(1, dtype=torch.int32))


@pytest.mark.parametrize("int8_wire", [False, True])
def test_guarded_zero1_step_skips_a_nan_step_on_the_card(gen, int8_wire):
    # GPT-2 tiny at head dim 64, ZeRO-1 with the fused kernel (and the int8
    # wire): a NaN batch weight skips the step, leaving the parameters,
    # moments, count, EF residuals and step bit for bit; the kernel launches
    # once a bucket with the flag down; the next clean step commits.
    import horovod_tpu_torch as hvt
    import torch.nn.functional as F
    from horovod_tpu_torch.guard import GuardConfig

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2,
                              param_dtype=torch.float32)
    hvt.init(backend="nccl")
    try:
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(hvt.convert.init_params(cfg, seed=0))

        def loss_fn(p, b):
            t, wgt = b
            logits = torch.func.functional_call(model, p, (t[:, :-1],))
            ce = F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten(),
                                 reduction="none").view(t.shape[0], -1)
            return (ce.mean(-1) * wgt).mean()

        kw = dict(compression=hvt.Compression.int8) if int8_wire else {}
        step, opt = hvt.make_train_step(
            loss_fn, hvt.fused_adamw(1e-3), sharded=True, fused_update=True,
            guard=GuardConfig(warmup=3, max_skips=2, audit_every=0), **kw)
        state = hvt.init_state(model, opt)
        tokens = torch.randint(0, cfg.vocab_size, (4, 65), device="cuda",
                               generator=gen)
        ones = torch.ones(4, device="cuda")
        poison = ones.clone()
        poison[2] = float("nan")
        for _ in range(2):
            state, _ = step(state, (tokens, ones))

        def snap(s):
            t = [p.detach().clone() for p in s.params.values()]
            t += [b.clone() for b in s.opt_state.inner.mu.buffers
                  + s.opt_state.inner.nu.buffers]
            t += [s.opt_state.inner.count.clone(), s.opt_state.count.clone(),
                  s.step.clone()]
            if s.opt_state.residual is not None:
                t += [b.clone() for b in s.opt_state.residual.buffers]
            return t

        before = snap(state)
        n_buckets = len(state.opt_state.inner.mu.buffers)
        fadam.reset_launches()
        tq.reset_launches()
        state, loss = step(state, (tokens, poison))
        torch.cuda.synchronize()
        assert fadam.launches == n_buckets
        if int8_wire:
            assert tq.launches_quant == tq.launches_dequant == 2 * n_buckets
        assert all(torch.equal(a, b) for a, b in zip(before, snap(state)))
        assert int(state.guard.skipped) == 1 and int(state.step) == 2
        state, _ = step(state, (tokens, ones))
        assert int(state.step) == 3 and int(state.guard.consecutive) == 0
    finally:
        hvt.shutdown()


def test_gspmd_one_rank_mesh_runs_the_kernels_on_the_card(gen):
    # GPT-2 tiny at head dim 64 placed as DTensors on a one-rank mesh: the
    # forward and backward reach kernels 1-3 once a layer each, and the
    # logits and gradients agree with the dense module's.
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.parallel import gspmd
    from torch.distributed.device_mesh import DeviceMesh

    cfg = hvt.GPT2Config.tiny(d_model=128, n_heads=2)
    hvt.init(backend="nccl")
    try:
        sd = hvt.convert.init_params(cfg, seed=0)
        dense, sharded = hvt.GPT2LMModel(cfg), hvt.GPT2LMModel(cfg)
        dense.load_state_dict(sd)
        sharded.load_state_dict(sd)
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("tp",))
        gspmd.shard_params(sharded, mesh)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                               generator=gen)
        fa.reset_launches()
        logits = sharded(tokens).full_tensor()
        logits.float().logsumexp(-1).mean().backward()
        torch.cuda.synchronize()
        assert (fa.launches, fa.launches_dkdv, fa.launches_dq) == (2, 2, 2)
        want = dense(tokens)
        want.float().logsumexp(-1).mean().backward()
        # bf16: [train]'s bound (DTensor may order an op's work otherwise).
        assert (logits - want).abs().max() <= 1e-2 * want.abs().max()
        ref = dict(dense.named_parameters())
        for name, p in sharded.named_parameters():
            g = p.grad.full_tensor().reshape(ref[name].shape).float()
            r = ref[name].grad.float()
            assert (g - r).abs().max() <= 1e-2 * r.abs().max() + 1e-6, name
    finally:
        hvt.shutdown()


# -- the hvt ops and the analysis plane on the card ---------------------------


def _hvt_cases(gen):
    """Each hvt op's wrapper call and its plain version on one set of card
    tensors: ``name -> (call, plain, tolerance)`` with tolerance None for
    bit for bit, else the bound relative to the largest plain value."""
    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = (rnd(2, 300, 4 * 64, dtype=torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, layout="bsm", n_heads=4)
    out, lse = fa.flash_attention_reference(q, k, v, **kw)
    g = rnd(2, 300, 4 * 64, dtype=torch.bfloat16)
    p, m, vv, gr = rnd(4099), rnd(4099), rnd(4099).abs(), rnd(4099)
    count = torch.full((), 3, dtype=torch.int32, device="cuda")
    spec = fadam.FusedAdamSpec(1e-3)
    x = rnd(5000)
    qx, sx = tq.quantize_blockwise_reference(x, 256)
    a, hist, res = rnd(96, 200, dtype=torch.bfloat16), rnd(16).abs(), \
        rnd(96, 200)
    ca = tq.fp8_cast_reference(a, hist, torch.float8_e4m3fn)
    wk = rnd(64, 200)
    cw = tq.fp8_cast_reference(wk, hist, torch.float8_e4m3fn)
    xi = rnd(37, 256)
    wq = tq.quantize_weight(rnd(256, 96))
    bias = rnd(96)
    return {
        "flash_fwd": (lambda: fa.flash_attention_with_lse(q, k, v, **kw),
                      lambda: (out, lse), 1e-2),
        "flash_bwd": (lambda: fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                     **kw),
                      lambda: fa.flash_attention_bwd_reference(
                          q, k, v, out, lse, g, **kw), 1e-2),
        "fused_adamw": (lambda: fadam.fused_adamw_update(
                            p, m.clone(), vv.clone(), gr, count, spec),
                        lambda: fadam.fused_adamw_update_reference(
                            p, m, vv, gr, count, spec)[0], 1e-6),
        "quantize_blockwise": (lambda: tq.quantize_blockwise(x, 256),
                               lambda: (qx, sx), None),
        "dequantize_blockwise": (lambda: tq.dequantize_blockwise(qx, sx, 256),
                                 lambda: tq.dequantize_blockwise_reference(
                                     qx, sx, 256), None),
        "fp8_cast": (lambda: tq.fp8_cast(a, hist, torch.float8_e4m3fn,
                                         residual=res)[:4],
                     lambda: tq.fp8_cast_reference(
                         a, hist, torch.float8_e4m3fn, residual=res)[:4],
                     None),
        "fp8_matmul": (lambda: tq.fp8_matmul(ca.q, cw.q.t(), ca.scale,
                                             scale_b=cw.scale),
                       lambda: tq.fp8_matmul_reference(ca.q, cw.q.t(),
                                                       ca.scale,
                                                       scale_b=cw.scale),
                       1e-4),
        "int8_matmul": (lambda: tq.int8_weight_matmul(xi, wq, bias),
                        lambda: tq.int8_weight_matmul_reference(xi, wq, bias),
                        1e-5),
    }


def _leaves(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if t is not None]


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd", "fused_adamw",
                                  "quantize_blockwise",
                                  "dequantize_blockwise", "fp8_cast",
                                  "fp8_matmul", "int8_matmul"])
def test_each_hvt_op_on_the_card_matches_its_plain_version(gen, name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    call, plain, tol = _hvt_cases(gen)[name]
    seen = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    fa.reset_launches()
    fadam.reset_launches()
    tq.reset_launches()
    with Log():
        got = call()
    torch.cuda.synchronize()
    assert f"hvt::{name}" in seen
    launched = (fa.launches + fa.launches_dkdv + fa.launches_dq
                + fadam.launches + tq.launches_quant + tq.launches_dequant
                + tq.launches_fp8_cast + tq.launches_fp8_matmul
                + tq.launches_int8_matmul)
    assert launched >= 1
    want = plain()
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if tol is None:
            if a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
                a, b = a.float(), b.float()
            assert torch.equal(a.nan_to_num(), b.nan_to_num()), name
        else:
            scale = b.float().abs().max().item() or 1.0
            assert (a.float() - b.float()).abs().max().item() <= tol * scale
    # Its fake gives the kernel's outputs: shapes, dtypes and strides.
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = call()
    for a, f in zip(_leaves(got), _leaves(fake)):
        assert (f.shape, f.dtype, f.stride(), f.device) == \
            (a.shape, a.dtype, a.stride(), a.device)


def _gpt2_card_step(gen, batch=4, seq=256, remat="none"):
    import torch.nn.functional as F

    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
    from horovod_tpu_torch.parallel import dp as tdp

    # Head dim 64: the flash kernels take 64 or 128.
    cfg = GPT2Config.tiny(param_dtype=torch.float32, dtype=torch.bfloat16,
                          max_len=seq, remat=remat, d_model=128, n_heads=2)
    torch.manual_seed(0)
    model = GPT2LMModel(cfg, device="cuda")

    def loss(p, t):
        logits = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(logits.float().flatten(0, 1),
                               t[:, 1:].flatten())

    step, opt = tdp.make_train_step(loss, topt.fused_adamw(1e-3),
                                    sharded=True, fused_update=True,
                                    device="cuda")
    state = tdp.init_state(model, opt)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device="cuda")
    return step, state, tokens


def test_a_record_on_the_card_launches_and_allocates_nothing(gen):
    import gc

    step, state, tokens = _gpt2_card_step(gen)
    w0 = {k: v.detach().clone() for k, v in state.params.items()}
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fa.reset_launches()
    fadam.reset_launches()
    gc.disable()  # no collection of others' cycles inside the window
    try:
        rec = step.trace(state, tokens)
        findings = step.lint(state, tokens, jaxpr=rec)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - before
    finally:
        gc.enable()
    assert allocated == 0
    assert (fa.launches, fa.launches_dkdv, fa.launches_dq,
            fadam.launches) == (0, 0, 0, 0)
    assert rec.op_counts["hvt::flash_fwd"] == 2  # n_layers, no remat
    assert rec.op_counts["hvt::flash_bwd"] == 2
    assert rec.op_counts["hvt::fused_adamw"] == 1
    assert [s.kind for s in rec.collectives] == ["reduce_scatter",
                                                 "all_gather", "psum"]
    assert findings == ()
    assert all(torch.equal(w0[k], v) for k, v in state.params.items())
    state, loss = step(state, tokens)
    assert torch.isfinite(loss) and (fa.launches, fadam.launches) == (2, 1)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_memplan_bounds_the_measured_peak_on_the_card(gen, remat):
    from horovod_tpu_torch import analysis as tan

    step, state, tokens = _gpt2_card_step(gen, batch=8, seq=512, remat=remat)
    state, _ = step(state, tokens)  # the state's own first allocations
    plan = step.memplan(state, tokens)
    measured, source = tan.measure_step_bytes(lambda: step(state, tokens),
                                              device="cuda")
    gate = tan.compare_to_measured(plan, measured, source)
    assert source == "device_peak" and gate["ok"], gate


# ---- the dynamic-enqueue runtime on the card --------------------------------


def test_runtime_orders_a_side_stream_producer_and_consumer(gen):
    """A tensor enqueued right after a producer kernel on a side stream
    (held back by a spin), its in-place result consumed on another stream
    with no host synchronization: the runtime's stream waits for the
    producer's values, and the consumer's stream for the result."""
    import horovod_tpu_torch.torch as hvd

    hvd.init()
    try:
        producer, consumer = torch.cuda.Stream(), torch.cuda.Stream()
        t = torch.zeros(1 << 22, device="cuda")
        torch.cuda.synchronize()
        with torch.cuda.stream(producer):
            torch.cuda._sleep(100_000_000)  # ~50 ms before the fill runs
            t.fill_(3.0)
            h = hvd.allreduce_async_(t, name="ordered", op=hvd.Sum,
                                     prescale_factor=2.0)
        with torch.cuda.stream(consumer):
            hvd.synchronize(h)
            out = t + 1.0
        torch.cuda.synchronize()
        assert torch.equal(out, torch.full_like(t, 7.0))
        assert torch.equal(t, torch.full_like(t, 6.0))
    finally:
        hvd.shutdown()


def test_a_cuda_tensor_on_a_cpu_runtime_raises(gen):
    from horovod_tpu_torch import native
    from horovod_tpu_torch.exceptions import HorovodTpuError

    native.init(0, 1, device="cpu")
    try:
        with pytest.raises(HorovodTpuError, match="initialized for the CPU"):
            native.allreduce_async("x", torch.ones(2, device="cuda"))
    finally:
        native.shutdown()


def test_params_estimator_fits_gpt2_through_the_flash_kernels(gen):
    """The Spark workers' path (ParamsEstimator.fit_arrays) on the card:
    a GPT-2 of tiny depth at head dim 64 (bf16 compute, fp32 parameters)
    trains through kernels 1-3 -- one forward a layer a step and a
    validation pass, one backward pair a layer a step -- and reloads from
    its store bit for bit."""
    import tempfile

    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.convert import init_params
    from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
    from horovod_tpu_torch.spark import FilesystemStore, ParamsEstimator, ParamsModel

    cfg = GPT2Config.tiny(d_model=128, n_heads=2, dtype=torch.bfloat16,
                          param_dtype=torch.float32)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (12, 65))
    x, y = tok[:8, :-1], tok[:8, 1:]
    model = GPT2LMModel(cfg)
    with tempfile.TemporaryDirectory() as d:
        store = FilesystemStore(d)
        fa.reset_launches()
        fitted = ParamsEstimator(
            model=model, params=init_params(cfg, seed=0),
            optimizer=topt.adamw(1e-3), loss="auto", batch_size=4, epochs=2,
            store=store, run_id="g").fit_arrays(
                x, y, validation=(tok[8:, :-1], tok[8:, 1:]))
        steps = 2 * 2
        assert fa.launches == cfg.n_layers * (steps + 2)
        assert fa.launches_dkdv == fa.launches_dq == cfg.n_layers * steps
        losses = fitted.history["step_loss"]
        assert len(losses) == steps and np.isfinite(losses).all()
        assert all(p.is_cuda for p in fitted.params.values())
        loaded = ParamsModel.load(store, "g", model=model)
        for k, v in fitted.params.items():
            assert torch.equal(loaded.params[k], v.detach()), k
        out = loaded.transform_arrays(x[:2])
        assert out.shape == (2, 64, cfg.vocab_size) and np.isfinite(out).all()
