"""The port's CUDA flash-attention kernel against its plain version, on
the card. Every test here needs an NVIDIA GPU with nvcc (the kernel has no
CPU mode) and skips without one. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which the card's
machine does not need). Tolerances as chip_smoke.py's: out 1e-2, lse 1e-3.
"""

import dataclasses

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

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
