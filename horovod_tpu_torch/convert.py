"""GPT-2 weights for the port: from the JAX package's flax parameters, or
made from a seed.

:func:`params_from_flax` owns every reshape and transpose between the
two layouts, and :func:`params_to_flax` undoes them:

* flax ``DenseGeneral`` query/key/value kernels are ``[D, H, dh]`` with
  ``[H, dh]`` biases; the port fuses them into one ``qkv`` projection
  whose ``weight`` is ``[3*H*dh, D]`` (rows: query, key, value);
* the flax ``out`` kernel is ``[H, dh, D]``; the port's is ``[D, H*dh]``;
* flax ``Dense`` kernels are ``[in, out]``; ``nn.Linear``-style weights
  are ``[out, in]``;
* embeddings and LayerNorm parameters keep their shapes;
* the fp8 state of a ``compute_dtype="fp8"`` model
  (``<Dense>/Fp8DotGeneral_0/fp8_{x,k,g}_amax_history`` and
  ``fp8_k_residual``) lands on ``<dense>.fp8_*`` -- for query, key and
  value on ``attn.qkv.{query,key,value}.fp8_*`` -- the rings as they are,
  the residual with its kernel's reshape and transpose.

:func:`quantized_weight_from_jax` carries the JAX package's
``QuantizedWeight`` (its ``q`` ``[K, N]`` and ``scales`` as numpy arrays)
into the port's layout, ``[N, K]`` row-major storage read as its ``[K, N]``
transposed view.

:func:`cachelm_params_from_jax` carries the JAX package's ``CacheLM``
parameters (a nest of numpy arrays: ``emb``, ``pos`` and the ``layers``
list; the port's ``CacheLM`` keeps the same layout) onto a device.

:func:`init_params` makes GPT-2 weights on the port's side from a numpy
seed, drawn as flax initializes them (truncated-normal fan-in kernels,
normal ``1/sqrt(D)`` embeddings, zero biases, unit LayerNorm scales, zero
fp8 state when ``cfg`` computes in fp8), in the flax layout and converted
by :func:`params_from_flax`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .context import resolve_device
from .models.transformer import TransformerConfig
from .ops.batching import tree_map
from .ops.fp8 import STATE_NAMES
from .ops.quantization import QuantizedWeight
from .utils import env as _env

FP8_SCOPE = "Fp8DotGeneral_0"  # the flax scope of a Dense's fp8 state


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _fp8_from_flax(sd, prefix: str, dense, kernel_to_port) -> None:
    """A flax Dense's fp8 state onto ``prefix + "fp8_*"``, the residual
    reshaped and transposed as ``kernel_to_port`` does its kernel."""
    st = dense.get(FP8_SCOPE)
    if st is None:
        return
    for name in STATE_NAMES[:3]:
        sd[prefix + name] = _t(st[name])
    sd[prefix + "fp8_k_residual"] = _t(
        kernel_to_port(np.asarray(st["fp8_k_residual"], np.float32)))


def _fp8_to_flax(a, state_dict, prefix: str, port_to_kernel):
    if prefix + "fp8_k_residual" not in state_dict:
        return {}
    st = {name: a(prefix + name) for name in STATE_NAMES[:3]}
    st["fp8_k_residual"] = port_to_kernel(a(prefix + "fp8_k_residual"))
    return {FP8_SCOPE: st}


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``GPT2LMModel`` state dict (fp32, CPU) from the JAX package's
    ``GPT2LMModel`` parameters as numpy arrays (with or without the outer
    ``{"params": ...}``)."""
    p = flax_params.get("params", flax_params)
    tr = p["transformer"]
    sd: Dict[str, torch.Tensor] = {
        "transformer.wte.weight": _t(tr["wte"]["embedding"]),
        "transformer.wpe.weight": _t(tr["wpe"]["embedding"]),
        "transformer.ln_f.scale": _t(tr["ln_f"]["scale"]),
        "transformer.ln_f.bias": _t(tr["ln_f"]["bias"]),
    }
    if "wtt" in tr:
        sd["transformer.wtt.weight"] = _t(tr["wtt"]["embedding"])
    n_layers = sum(1 for k in tr if k.startswith("block_"))
    for i in range(n_layers):
        blk = tr[f"block_{i}"]
        pre = f"transformer.blocks.{i}."
        mha = blk["MultiHeadAttention_0"]
        d_model = np.asarray(mha["query"]["kernel"]).shape[0]
        qkv_w = [
            np.asarray(mha[n]["kernel"], np.float32).reshape(d_model, -1).T
            for n in ("query", "key", "value")
        ]
        qkv_b = [
            np.asarray(mha[n]["bias"], np.float32).reshape(-1)
            for n in ("query", "key", "value")
        ]
        out_k = np.asarray(mha["out"]["kernel"], np.float32)
        mlp = blk["MlpBlock_0"]
        for n in ("query", "key", "value"):
            _fp8_from_flax(sd, f"{pre}attn.qkv.{n}.", mha[n],
                           lambda k, d=d_model: k.reshape(d, -1).T)
        _fp8_from_flax(sd, pre + "attn.out.", mha["out"],
                       lambda k: k.reshape(-1, k.shape[-1]).T)
        _fp8_from_flax(sd, pre + "mlp.fc.", mlp["Dense_0"], lambda k: k.T)
        _fp8_from_flax(sd, pre + "mlp.proj.", mlp["Dense_1"], lambda k: k.T)
        sd.update({
            pre + "ln_1.scale": _t(blk["LayerNorm_0"]["scale"]),
            pre + "ln_1.bias": _t(blk["LayerNorm_0"]["bias"]),
            pre + "attn.qkv.weight": _t(np.concatenate(qkv_w, 0)),
            pre + "attn.qkv.bias": _t(np.concatenate(qkv_b, 0)),
            pre + "attn.out.weight": _t(out_k.reshape(-1, out_k.shape[-1]).T),
            pre + "attn.out.bias": _t(mha["out"]["bias"]),
            pre + "ln_2.scale": _t(blk["LayerNorm_1"]["scale"]),
            pre + "ln_2.bias": _t(blk["LayerNorm_1"]["bias"]),
            pre + "mlp.fc.weight": _t(np.asarray(mlp["Dense_0"]["kernel"]).T),
            pre + "mlp.fc.bias": _t(mlp["Dense_0"]["bias"]),
            pre + "mlp.proj.weight": _t(np.asarray(mlp["Dense_1"]["kernel"]).T),
            pre + "mlp.proj.bias": _t(mlp["Dense_1"]["bias"]),
        })
    return sd


def params_to_flax(state_dict: Mapping[str, Any], n_heads: int) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: the JAX package's
    ``GPT2LMModel`` parameters (``{"params": {"transformer": ...}}``,
    fp32 numpy arrays, with the fp8 state where the port's has it) from a
    port state dict or parameter dict (any dtype, any device). ``n_heads``
    splits the fused projections."""

    def a(name):
        return state_dict[name].detach().float().cpu().numpy()

    tr: Dict[str, Any] = {
        "wte": {"embedding": a("transformer.wte.weight")},
        "wpe": {"embedding": a("transformer.wpe.weight")},
        "ln_f": {"scale": a("transformer.ln_f.scale"),
                 "bias": a("transformer.ln_f.bias")},
    }
    if "transformer.wtt.weight" in state_dict:
        tr["wtt"] = {"embedding": a("transformer.wtt.weight")}
    n_layers = 1 + max(
        (int(k.split(".")[2]) for k in state_dict
         if k.startswith("transformer.blocks.")), default=-1,
    )
    for i in range(n_layers):
        pre = f"transformer.blocks.{i}."
        qkv_w, qkv_b = a(pre + "attn.qkv.weight"), a(pre + "attn.qkv.bias")
        d_model = qkv_w.shape[1]
        dh = d_model // n_heads
        mha = {}
        for j, n in enumerate(("query", "key", "value")):
            rows = slice(j * d_model, (j + 1) * d_model)
            mha[n] = {
                "kernel": qkv_w[rows].T.reshape(d_model, n_heads, dh),
                "bias": qkv_b[rows].reshape(n_heads, dh),
                **_fp8_to_flax(a, state_dict, f"{pre}attn.qkv.{n}.",
                               lambda r: r.T.reshape(d_model, n_heads, dh)),
            }
        mha["out"] = {
            "kernel": a(pre + "attn.out.weight").T.reshape(n_heads, dh, d_model),
            "bias": a(pre + "attn.out.bias"),
            **_fp8_to_flax(a, state_dict, pre + "attn.out.",
                           lambda r: r.T.reshape(n_heads, dh, d_model)),
        }
        tr[f"block_{i}"] = {
            "LayerNorm_0": {"scale": a(pre + "ln_1.scale"),
                            "bias": a(pre + "ln_1.bias")},
            "MultiHeadAttention_0": mha,
            "LayerNorm_1": {"scale": a(pre + "ln_2.scale"),
                            "bias": a(pre + "ln_2.bias")},
            "MlpBlock_0": {
                "Dense_0": {"kernel": a(pre + "mlp.fc.weight").T,
                            "bias": a(pre + "mlp.fc.bias"),
                            **_fp8_to_flax(a, state_dict, pre + "mlp.fc.",
                                           lambda r: r.T)},
                "Dense_1": {"kernel": a(pre + "mlp.proj.weight").T,
                            "bias": a(pre + "mlp.proj.bias"),
                            **_fp8_to_flax(a, state_dict, pre + "mlp.proj.",
                                           lambda r: r.T)},
            },
        }
    tr = {k: _contiguous(v) for k, v in tr.items()}
    return {"params": {"transformer": tr}}


def quantized_weight_from_jax(qw) -> QuantizedWeight:
    """The port's :class:`~.ops.quantization.QuantizedWeight` (on the CPU)
    holding exactly the payload of the JAX package's: ``qw.q`` int8
    ``[K, N]``, ``qw.scales`` fp32 ``[N]`` (anything numpy converts) and
    ``qw.dtype_name``."""
    storage = np.ascontiguousarray(np.asarray(qw.q, dtype=np.int8).T)
    scales = np.array(qw.scales, dtype=np.float32)
    return QuantizedWeight(torch.from_numpy(storage).t(),
                           torch.from_numpy(scales),
                           str(getattr(qw, "dtype_name", "float32")))


def cachelm_params_from_jax(params, device=None):
    """The JAX package's ``CacheLM`` parameters (numpy arrays in its nest:
    ``{"emb", "pos", "layers": [{"wq", "wk", "wv", "wo"}, ...]}``) as the
    port's ``CacheLM`` takes them: the same nest of fp32 tensors on
    ``device`` (default: this process's card)."""
    device = resolve_device(device)
    return tree_map(
        lambda a: torch.as_tensor(np.array(a, np.float32), device=device),
        params)


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree)


def _flax_like_params(cfg: TransformerConfig, rng: np.random.Generator):
    """GPT-2 parameters in the flax layout, drawn as flax initializes."""
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_ff

    def kernel(shape, fan_in):
        # lecun_normal: truncated normal, stddev sqrt(1/fan_in) after the
        # truncation's correction; truncation at two standard deviations.
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        x = rng.standard_normal(shape, dtype=np.float32)
        return np.clip(x, -2.0, 2.0) * np.float32(std)

    def embed(n):
        return rng.standard_normal((n, d), dtype=np.float32) * np.float32(
            1.0 / np.sqrt(d)
        )

    def ln():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    hlen = _env.fp8_amax_history() if cfg.fp8 else 0

    def dense(kernel_, bias):
        out = {"kernel": kernel_, "bias": bias}
        if hlen:
            ring = np.zeros(hlen, np.float32)
            out[FP8_SCOPE] = {
                "fp8_x_amax_history": ring, "fp8_k_amax_history": ring.copy(),
                "fp8_g_amax_history": ring.copy(),
                "fp8_k_residual": np.zeros(kernel_.shape, np.float32),
            }
        return out

    tr: Dict[str, Any] = {"wte": {"embedding": embed(cfg.vocab_size)},
                          "wpe": {"embedding": embed(cfg.max_len)}}
    if cfg.type_vocab_size:
        tr["wtt"] = {"embedding": embed(cfg.type_vocab_size)}
    for i in range(cfg.n_layers):
        mha = {
            n: dense(kernel((d, h, dh), d), np.zeros((h, dh), np.float32))
            for n in ("query", "key", "value")
        }
        mha["out"] = dense(kernel((h, dh, d), h * dh), np.zeros(d, np.float32))
        tr[f"block_{i}"] = {
            "LayerNorm_0": ln(),
            "MultiHeadAttention_0": mha,
            "LayerNorm_1": ln(),
            "MlpBlock_0": {
                "Dense_0": dense(kernel((d, f), d), np.zeros(f, np.float32)),
                "Dense_1": dense(kernel((f, d), f), np.zeros(d, np.float32)),
            },
        }
    tr["ln_f"] = ln()
    return {"params": {"transformer": tr}}


def init_params(cfg: TransformerConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """``GPT2LMModel`` state dict (fp32, CPU) made from a numpy seed."""
    return params_from_flax(_flax_like_params(cfg, np.random.default_rng(seed)))
