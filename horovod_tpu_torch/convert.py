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

:func:`parallel_gpt_params_from_jax` carries the JAX package's 3-D GPT
parameters (a flat dict of arrays, layer dims stacked) onto a device.

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


def _block_from_flax(sd, blk, pre: str, *, mha: str = "MultiHeadAttention_0",
                     mlp: str = "MlpBlock_0") -> None:
    """One flax ``Block`` (or MoE block: ``mha="attn"``, ``mlp="mlp"``)
    onto the port's ``pre + {ln_1, attn.qkv, attn.out, ln_2, mlp.fc,
    mlp.proj}`` (the MLP only where ``blk`` has ``mlp``)."""
    attn = blk[mha]
    d_model = np.asarray(attn["query"]["kernel"]).shape[0]
    qkv_w = [
        np.asarray(attn[n]["kernel"], np.float32).reshape(d_model, -1).T
        for n in ("query", "key", "value")
    ]
    qkv_b = [
        np.asarray(attn[n]["bias"], np.float32).reshape(-1)
        for n in ("query", "key", "value")
    ]
    out_k = np.asarray(attn["out"]["kernel"], np.float32)
    for n in ("query", "key", "value"):
        _fp8_from_flax(sd, f"{pre}attn.qkv.{n}.", attn[n],
                       lambda k, d=d_model: k.reshape(d, -1).T)
    _fp8_from_flax(sd, pre + "attn.out.", attn["out"],
                   lambda k: k.reshape(-1, k.shape[-1]).T)
    sd.update({
        pre + "ln_1.scale": _t(blk["LayerNorm_0"]["scale"]),
        pre + "ln_1.bias": _t(blk["LayerNorm_0"]["bias"]),
        pre + "attn.qkv.weight": _t(np.concatenate(qkv_w, 0)),
        pre + "attn.qkv.bias": _t(np.concatenate(qkv_b, 0)),
        pre + "attn.out.weight": _t(out_k.reshape(-1, out_k.shape[-1]).T),
        pre + "attn.out.bias": _t(attn["out"]["bias"]),
        pre + "ln_2.scale": _t(blk["LayerNorm_1"]["scale"]),
        pre + "ln_2.bias": _t(blk["LayerNorm_1"]["bias"]),
    })
    if mlp in blk:
        m = blk[mlp]
        _fp8_from_flax(sd, pre + "mlp.fc.", m["Dense_0"], lambda k: k.T)
        _fp8_from_flax(sd, pre + "mlp.proj.", m["Dense_1"], lambda k: k.T)
        _dense_from_flax(sd, pre + "mlp.fc.", m["Dense_0"])
        _dense_from_flax(sd, pre + "mlp.proj.", m["Dense_1"])


def _dense_from_flax(sd, pre: str, dense) -> None:
    """A flax ``Dense`` (``kernel [in, out]``) onto ``pre + {weight, bias}``
    (``[out, in]``)."""
    sd[pre + "weight"] = _t(np.asarray(dense["kernel"]).T)
    sd[pre + "bias"] = _t(dense["bias"])


def _ln_from_flax(sd, pre: str, ln) -> None:
    sd[pre + "scale"] = _t(ln["scale"])
    sd[pre + "bias"] = _t(ln["bias"])


def _transformer_from_flax(sd, tr, pre: str) -> None:
    """A flax ``Transformer`` (embeddings, ``block_i``, ``ln_f``) onto the
    port's ``pre + ...``."""
    sd[pre + "wte.weight"] = _t(tr["wte"]["embedding"])
    sd[pre + "wpe.weight"] = _t(tr["wpe"]["embedding"])
    if "wtt" in tr:
        sd[pre + "wtt.weight"] = _t(tr["wtt"]["embedding"])
    _ln_from_flax(sd, pre + "ln_f.", tr["ln_f"])
    n_layers = sum(1 for k in tr if k.startswith("block_"))
    for i in range(n_layers):
        _block_from_flax(sd, tr[f"block_{i}"], f"{pre}blocks.{i}.")


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``GPT2LMModel`` state dict (fp32, CPU) from the JAX package's
    ``GPT2LMModel`` parameters as numpy arrays (with or without the outer
    ``{"params": ...}``)."""
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    _transformer_from_flax(sd, p["transformer"], "transformer.")
    return sd


def bert_params_from_flax(flax_params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """``BertModel`` state dict (fp32, CPU) from the JAX package's
    ``BertModel`` parameters (MLM head or classifier, whichever they hold;
    ``encoder.wtt`` only where flax made it, i.e. ``init`` saw
    ``token_types``)."""
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    _transformer_from_flax(sd, p["encoder"], "encoder.")
    if "classifier" in p:
        _dense_from_flax(sd, "pooler.", p["pooler"])
        _dense_from_flax(sd, "classifier.", p["classifier"])
    else:
        _dense_from_flax(sd, "mlm_dense.", p["mlm_dense"])
        _ln_from_flax(sd, "mlm_ln.", p["mlm_ln"])
        _dense_from_flax(sd, "mlm_decoder.", p["mlm_decoder"])
    return sd


def vit_params_from_flax(flax_params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """``ViT`` state dict (fp32, CPU) from the JAX package's ``ViT``
    parameters: the ``[p, p, C, D]`` (HWIO) patch kernel becomes
    ``[D, C, p, p]`` (OIHW)."""
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {
        "patch_weight": _t(np.asarray(p["patch_embed"]["kernel"]).transpose(
            3, 2, 0, 1)),
        "patch_bias": _t(p["patch_embed"]["bias"]),
        "cls": _t(p["cls"]),
        "pos_embed": _t(p["pos_embed"]),
    }
    n_layers = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_layers):
        _block_from_flax(sd, p[f"block_{i}"], f"blocks.{i}.")
    _ln_from_flax(sd, "ln_f.", p["ln_f"])
    _dense_from_flax(sd, "head.", p["head"])
    return sd


def mlp_params_from_flax(flax_params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """``MLP`` state dict (fp32, CPU) from the JAX package's ``MLP``
    parameters (``Dense_0 .. Dense_n``, the last the head)."""
    p = flax_params.get("params", flax_params)
    n = sum(1 for k in p if k.startswith("Dense_"))
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n - 1):
        _dense_from_flax(sd, f"hidden.{i}.", p[f"Dense_{i}"])
    _dense_from_flax(sd, "head.", p[f"Dense_{n - 1}"])
    return sd


def moe_params_from_flax(flax_params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """``SwitchTransformerLM`` state dict (fp32, CPU) from the JAX
    package's parameters: the stacked experts keep their ``[E, D, F]`` and
    ``[E, F, D]`` shapes, the gate its ``[D, E]``."""
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {"wte": _t(p["wte"]), "wpe": _t(p["wpe"])}
    n_layers = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_layers):
        blk, pre = p[f"block_{i}"], f"blocks.{i}."
        _block_from_flax(sd, blk, pre, mha="attn", mlp="mlp")
        if "moe" in blk:
            for name in ("gate", "expert_in", "expert_out"):
                sd[f"{pre}moe.{name}"] = _t(blk["moe"][name])
    _ln_from_flax(sd, "ln_f.", p["LayerNorm_0"])
    return sd


def _resnet_names(model):
    """``(flax path, port prefix)`` of every conv, norm and the head of a
    port ``ResNet``, in flax's auto-naming (``BottleneckBlock_i`` /
    ``BasicBlock_i`` blocks holding ``Conv_k``, ``BatchNorm_k``,
    ``conv_proj``, ``norm_proj``; the head ``Dense_0``)."""
    convs = [(("conv_init",), "conv_init.")]
    norms = [(("bn_init",), "bn_init.")]
    for i, blk in enumerate(model.blocks):
        scope = f"{type(blk).__name__}_{i}"
        n = 3 if hasattr(blk, "conv2") else 2
        for k in range(n):
            convs.append(((scope, f"Conv_{k}"), f"blocks.{i}.conv{k}."))
            norms.append(((scope, f"BatchNorm_{k}"), f"blocks.{i}.norm{k}."))
        if blk.proj:
            convs.append(((scope, "conv_proj"), f"blocks.{i}.conv_proj."))
            norms.append(((scope, "norm_proj"), f"blocks.{i}.norm_proj."))
    return convs, norms


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def resnet_params_from_flax(model, variables: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """State dict (fp32, CPU) of the port ``ResNet`` ``model`` from the
    JAX package's ``ResNet`` variables (``{"params", "batch_stats"}``):
    HWIO conv kernels become OIHW, ``batch_stats`` the norms' ``mean`` and
    ``var`` buffers. ``model`` gives the block structure."""
    params, stats = variables["params"], variables["batch_stats"]
    convs, norms = _resnet_names(model)
    sd: Dict[str, torch.Tensor] = {}
    for path, pre in convs:
        sd[pre + "weight"] = _t(np.asarray(_get(params, path)["kernel"])
                                .transpose(3, 2, 0, 1))
    for path, pre in norms:
        _ln_from_flax(sd, pre, _get(params, path))
        sd[pre + "mean"] = _t(_get(stats, path)["mean"])
        sd[pre + "var"] = _t(_get(stats, path)["var"])
    _dense_from_flax(sd, "head.", params["Dense_0"])
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


def parallel_gpt_params_from_jax(np_params: Mapping[str, Any], device=None
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX package's 3-D GPT parameters (``parallel/transformer.py``'s
    flat dict, layer dims stacked on axis 0; anything numpy converts) as the
    port's :mod:`.parallel.transformer` takes them: the same names and
    shapes, fp32 tensors on ``device`` (default: this process's card).
    :func:`.parallel.transformer.shard_params` then gives any rank its
    shards of the same weights."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in np_params.items()}


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree)


class _FlaxInit:
    """Draws parameters in the flax layout from a numpy generator, as flax
    initializes them: ``lecun_normal`` kernels (a normal truncated at two
    standard deviations, stddev sqrt(1/fan_in) after the truncation's
    correction), normal ``1/sqrt(D)`` embeddings, zero biases, unit
    LayerNorm scales, and zero fp8 state when ``fp8_history``."""

    def __init__(self, rng: np.random.Generator, fp8_history: int = 0):
        self.rng = rng
        self.hlen = fp8_history

    def kernel(self, shape, fan_in):
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        x = self.rng.standard_normal(shape, dtype=np.float32)
        return np.clip(x, -2.0, 2.0) * np.float32(std)

    def normal(self, shape, std):
        return self.rng.standard_normal(shape, dtype=np.float32) * np.float32(
            std)

    @staticmethod
    def ln(d):
        return {"scale": np.ones(d, np.float32),
                "bias": np.zeros(d, np.float32)}

    def dense(self, kernel_, bias, fp8=True):
        out = {"kernel": kernel_, "bias": bias}
        if self.hlen and fp8:
            ring = np.zeros(self.hlen, np.float32)
            out[FP8_SCOPE] = {
                "fp8_x_amax_history": ring, "fp8_k_amax_history": ring.copy(),
                "fp8_g_amax_history": ring.copy(),
                "fp8_k_residual": np.zeros(kernel_.shape, np.float32),
            }
        return out

    def plain_dense(self, d_in, d_out):
        """A flax ``Dense`` outside the blocks (never fp8)."""
        return self.dense(self.kernel((d_in, d_out), d_in),
                          np.zeros(d_out, np.float32), fp8=False)

    def attention(self, cfg):
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        mha = {
            n: self.dense(self.kernel((d, h, dh), d),
                          np.zeros((h, dh), np.float32))
            for n in ("query", "key", "value")
        }
        mha["out"] = self.dense(self.kernel((h, dh, d), h * dh),
                                np.zeros(d, np.float32))
        return mha

    def mlp(self, cfg):
        d, f = cfg.d_model, cfg.d_ff
        return {
            "Dense_0": self.dense(self.kernel((d, f), d),
                                  np.zeros(f, np.float32)),
            "Dense_1": self.dense(self.kernel((f, d), f),
                                  np.zeros(d, np.float32)),
        }

    def block(self, cfg):
        return {"LayerNorm_0": self.ln(cfg.d_model),
                "MultiHeadAttention_0": self.attention(cfg),
                "LayerNorm_1": self.ln(cfg.d_model),
                "MlpBlock_0": self.mlp(cfg)}

    def transformer(self, cfg):
        d = cfg.d_model
        emb = np.float32(1.0 / np.sqrt(d))
        tr: Dict[str, Any] = {
            "wte": {"embedding": self.normal((cfg.vocab_size, d), emb)},
            "wpe": {"embedding": self.normal((cfg.max_len, d), emb)}}
        if cfg.type_vocab_size:
            tr["wtt"] = {"embedding": self.normal((cfg.type_vocab_size, d),
                                                  emb)}
        for i in range(cfg.n_layers):
            tr[f"block_{i}"] = self.block(cfg)
        tr["ln_f"] = self.ln(d)
        return tr


def _init(cfg, seed) -> _FlaxInit:
    rng = np.random.default_rng(seed)
    return _FlaxInit(rng, _env.fp8_amax_history() if cfg.fp8 else 0)


def init_params(cfg: TransformerConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """``GPT2LMModel`` state dict (fp32, CPU) made from a numpy seed."""
    return params_from_flax(
        {"params": {"transformer": _init(cfg, seed).transformer(cfg)}})


def init_bert_params(cfg, seed: int = 0, num_labels=None
                     ) -> Dict[str, torch.Tensor]:
    """``BertModel(cfg, num_labels)`` state dict (fp32, CPU) made from a
    numpy seed, drawn in the flax layout (``wtt`` included)."""
    init = _init(cfg, seed)
    p: Dict[str, Any] = {"encoder": init.transformer(cfg)}
    d = cfg.d_model
    if num_labels is not None:
        p["pooler"] = init.plain_dense(d, d)
        p["classifier"] = init.plain_dense(d, num_labels)
    else:
        p["mlm_dense"] = init.plain_dense(d, d)
        p["mlm_ln"] = init.ln(d)
        p["mlm_decoder"] = init.plain_dense(d, cfg.vocab_size)
    return bert_params_from_flax({"params": p})


def init_vit_params(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """``ViT(cfg)`` state dict (fp32, CPU) made from a numpy seed, drawn in
    the flax layout (a zero ``cls``, a normal(0.02) ``pos_embed``)."""
    init = _init(cfg, seed)
    ps, c, d = cfg.patch_size, cfg.in_channels, cfg.d_model
    n = (-(-cfg.image_size // ps)) ** 2
    p: Dict[str, Any] = {
        "patch_embed": {"kernel": init.kernel((ps, ps, c, d), ps * ps * c),
                        "bias": np.zeros(d, np.float32)},
        "cls": np.zeros((1, 1, d), np.float32),
        "pos_embed": init.normal((1, n + 1, d), 0.02),
    }
    for i in range(cfg.n_layers):
        p[f"block_{i}"] = init.block(cfg)
    p["ln_f"] = init.ln(d)
    p["head"] = init.plain_dense(d, cfg.num_classes)
    return vit_params_from_flax({"params": p})


def init_moe_params(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """``SwitchTransformerLM(cfg)`` state dict (fp32, CPU) made from a numpy
    seed, drawn in the flax layout (normal(0.02) ``wte`` and ``wpe``,
    ``lecun_normal`` gate and stacked experts with fan-in D and F)."""
    from .models.moe import SwitchTransformerLM

    init = _init(cfg, seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p: Dict[str, Any] = {"wte": init.normal((cfg.vocab_size, d), 0.02),
                         "wpe": init.normal((cfg.max_len, d), 0.02)}
    for i in range(cfg.n_layers):
        blk = {"LayerNorm_0": init.ln(d), "attn": init.attention(cfg),
               "LayerNorm_1": init.ln(d)}
        if SwitchTransformerLM.uses_moe(cfg, i):
            blk["moe"] = {"gate": init.kernel((d, e), d),
                          "expert_in": init.kernel((e, d, f), d),
                          "expert_out": init.kernel((e, f, d), f)}
        else:
            blk["mlp"] = init.mlp(cfg)
        p[f"block_{i}"] = blk
    p["LayerNorm_0"] = init.ln(d)
    return moe_params_from_flax({"params": p})


def init_mlp_params(model, seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict (fp32, CPU) of the port ``MLP`` ``model`` made from a
    numpy seed, drawn in the flax layout."""
    init = _FlaxInit(np.random.default_rng(seed))
    denses = [*model.hidden, model.head]
    p = {f"Dense_{i}": init.plain_dense(dn.weight.shape[1],
                                         dn.weight.shape[0])
         for i, dn in enumerate(denses)}
    return mlp_params_from_flax({"params": p})


def init_resnet_params(model, seed: int = 0) -> Dict[str, torch.Tensor]:
    """State dict (fp32, CPU) of the port ``ResNet`` ``model`` made from a
    numpy seed, drawn in the flax layout: ``lecun_normal`` HWIO kernels
    (fan-in kh x kw x in), unit BatchNorm scales (zero for the last norm
    of each residual branch), zero biases, zero running means and unit
    running variances."""
    init = _FlaxInit(np.random.default_rng(seed))
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    convs, norms = _resnet_names(model)
    for path, pre in convs:
        o, i, kh, kw = _get_module(model, pre).weight.shape
        put(params, path, {"kernel": init.kernel((kh, kw, i, o),
                                                 kh * kw * i)})
    for path, pre in norms:
        bn = _get_module(model, pre)
        c = bn.scale.shape[0]
        scale = np.zeros(c, np.float32) if bn.zero_scale else np.ones(
            c, np.float32)
        put(params, path, {"scale": scale, "bias": np.zeros(c, np.float32)})
        put(stats, path, {"mean": np.zeros(c, np.float32),
                          "var": np.ones(c, np.float32)})
    params["Dense_0"] = init.plain_dense(model.head.weight.shape[1],
                                         model.head.weight.shape[0])
    return resnet_params_from_flax(model, {"params": params,
                                           "batch_stats": stats})


def _get_module(model, prefix: str):
    return model.get_submodule(prefix.rstrip("."))
