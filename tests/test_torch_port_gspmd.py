"""The port's GSPMD placements (horovod_tpu_torch.parallel.gspmd, DTensor)
held against the JAX package's ``parallel/gspmd.py`` PartitionSpecs.

* Every parameter of a tiny GPT-2 gets the placement the reference's rule
  gives its flax leaf, through the layout differences (``[out, in]``
  weights, the fused QKV viewed as ``[3, H*dh, D]``), with and without
  ``fsdp_axis``.
* On a gloo world of 4 (a 2 x 2 ``(fsdp, tp)`` ``DeviceMesh``, spawned)
  every rank's local shard equals, bit for bit, the reference's
  addressable shard on the matching device of a 2 x 2 CPU ``Mesh``,
  converted to the port's layout by ``convert.params_from_flax``.
* On a gloo world of 2 (tp 2) the forward is within 1e-5 of the dense
  module's and of the reference's jitted forward on its sharded
  parameters (fp32, plain attention), with 2 all-reduces a block
  (``CommDebugMode``), and the gradients within 1e-5 of the dense ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.parallel import gspmd as jgspmd
from horovod_tpu_torch import context, convert
from horovod_tpu_torch.parallel import gspmd

import torch_fault_ranks as ranks

from conftest import cpu_devices


def _port_model():
    return ranks._gspmd_model()


def _flax_params(model):
    cfg = ranks.gspmd_cfg()
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    return jax.tree.map(jnp.asarray, convert.params_to_flax(sd, cfg.n_heads))


def _jmodel():
    return jgpt2.GPT2LMModel(jgpt2.GPT2Config.tiny(dtype=jnp.float32,
                                                   use_flash=False))


def _flax_name(port_name):
    """The reference's path of the flax leaf (or, for the fused QKV, one of
    the three) a port parameter comes from."""
    parts = port_name.split(".")
    leaf = parts[-1]
    if parts[1] == "blocks":
        blk = f"transformer/block_{parts[2]}"
        mod = ".".join(parts[3:-1])
        kind = {"weight": "kernel", "bias": "bias", "scale": "scale"}[leaf]
        return {
            "ln_1": f"{blk}/LayerNorm_0/{leaf}",
            "ln_2": f"{blk}/LayerNorm_1/{leaf}",
            "attn.qkv": f"{blk}/MultiHeadAttention_0/query/{kind}",
            "attn.out": f"{blk}/MultiHeadAttention_0/out/{kind}",
            "mlp.fc": f"{blk}/MlpBlock_0/Dense_0/{kind}",
            "mlp.proj": f"{blk}/MlpBlock_0/Dense_1/{kind}",
        }[mod]
    if parts[1] == "ln_f":
        return f"transformer/ln_f/{leaf}"
    return f"transformer/{parts[1]}/embedding"


def _reference_specs(flax_params, **kw):
    specs = jgspmd.transformer_param_specs(flax_params, **kw)
    flat = {}

    def visit(path, spec):
        flat["/".join(str(getattr(k, "key", k)) for k in path)] = spec

    jax.tree_util.tree_map_with_path(
        visit, specs, is_leaf=lambda x: isinstance(x, P))
    return {k.removeprefix("params/"): v for k, v in flat.items()}


def _port_view_dims(name, jspec, jshape):
    """The reference's PartitionSpec of a flax leaf, moved onto the port's
    layout: ``{axis: port dim}`` of the tensor (or the QKV view)."""
    axes = list(jspec) + [None] * (len(jshape) - len(jspec))
    mod = name.rsplit(".", 2)[-2] if "blocks" in name else ""
    leaf = name.rsplit(".", 1)[-1]
    out = {}
    for d, axis in enumerate(axes):
        if axis is None:
            continue
        if mod == "qkv" and leaf == "weight":
            port = {0: 2, 1: 1, 2: 1}[d]  # [D, H, dh] -> [3, H*dh, D]
        elif mod == "qkv":
            port = 1  # [H, dh] -> [3, H*dh]
        elif mod == "out" and leaf == "weight":
            port = {0: 1, 1: 1, 2: 0}[d]  # [H, dh, D] -> [D, H*dh]
        elif leaf == "weight" and mod in ("fc", "proj"):
            port = 1 - d  # [in, out] -> [out, in]
        else:
            port = d
        out[axis] = port
    return out


@pytest.mark.parametrize("fsdp", [None, "fsdp"])
def test_every_placement_is_the_reference_spec(fsdp):
    model = _port_model()
    jspecs = _reference_specs(_flax_params(model), tp_axis="tp",
                              fsdp_axis=fsdp)
    jshapes = {}
    jax.tree_util.tree_map_with_path(
        lambda path, x: jshapes.__setitem__(
            "/".join(str(getattr(k, "key", k)) for k in path)
            .removeprefix("params/"), x.shape),
        _flax_params(model))
    specs = gspmd.transformer_param_specs(model, tp_axis="tp",
                                          fsdp_axis=fsdp)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    for name, spec in specs.items():
        fname = _flax_name(name)
        want = _port_view_dims(name, jspecs[fname], jshapes[fname])
        assert dict(spec.dims) == want, (name, spec, jspecs[fname])
        assert spec.fused == (3 if ".attn.qkv." in name else 1)


def test_qkv_view_gives_each_rank_heads_of_q_k_and_v():
    model = _port_model()
    spec = gspmd.transformer_param_specs(model)[
        "transformer.blocks.0.attn.qkv.weight"]
    w = model.transformer.blocks[0].attn.qkv.weight.detach()
    view = spec.view(w)
    d = w.shape[1]
    assert view.shape == (3, d, d)
    rank1 = view.chunk(2, dim=1)[1]  # what Shard(1) hands tp rank 1
    half = d // 2
    for i in range(3):
        assert torch.equal(rank1[i], w[i * d + half:(i + 1) * d])


def test_placements_follow_the_mesh_axes():
    spec = gspmd.ParamSpec((("tp", 1),), fused=3)

    class _Mesh:
        mesh_dim_names = ("fsdp", "tp")

    from torch.distributed.tensor import Replicate, Shard

    assert spec.placements(_Mesh()) == [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="no 'sp'"):
        gspmd.ParamSpec((("sp", 0),)).placements(_Mesh())


@pytest.fixture(scope="module")
def mesh_2x2_shards():
    return context.spawn_gloo(4, ranks.gspmd_mesh_2x2)


def test_local_shards_match_the_reference_on_a_2x2_mesh(mesh_2x2_shards):
    model = _port_model()
    mesh = Mesh(np.array(cpu_devices(4)).reshape(2, 2), ("fsdp", "tp"))
    sharded = jgspmd.shard_params(_flax_params(model), mesh, tp_axis="tp",
                                  fsdp_axis="fsdp")
    for i in range(2):
        for j in range(2):
            dev = mesh.devices[i, j]
            tree = jax.tree.map(
                lambda x: next(np.asarray(s.data) for s in x.addressable_shards
                               if s.device == dev), sharded)
            want = convert.params_from_flax(tree)
            got = mesh_2x2_shards[2 * i + j]
            for name, local in got.items():
                w = want[name].numpy()
                if ".attn.qkv." in name:
                    w = w.reshape(3, -1, *w.shape[1:])
                np.testing.assert_array_equal(local, w, err_msg=name)


@pytest.fixture(scope="module")
def tp2():
    return context.spawn_gloo(2, ranks.gspmd_tp2)


def _dense():
    model = _port_model()
    tokens = torch.from_numpy(ranks.gspmd_tokens())
    logits = model(tokens)
    logits.logsumexp(-1).mean().backward()
    return logits.detach().numpy(), {
        n: p.grad.reshape(-1).numpy() for n, p in model.named_parameters()}


def test_tp2_forward_matches_the_dense_module(tp2):
    logits, _ = _dense()
    for r in tp2:
        np.testing.assert_allclose(r["logits"], logits, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tp2[0]["logits"], tp2[1]["logits"])


def test_tp2_forward_matches_the_references_jitted_forward(tp2):
    model = _port_model()
    mesh = Mesh(np.array(cpu_devices(2)), ("tp",))
    sharded = jgspmd.shard_params(_flax_params(model), mesh, tp_axis="tp")
    jm = _jmodel()
    tokens = jnp.asarray(ranks.gspmd_tokens().astype(np.int32))
    want = np.asarray(jax.jit(jm.apply)(sharded, tokens))
    np.testing.assert_allclose(tp2[0]["logits"], want, rtol=0, atol=1e-5)


def test_tp2_takes_two_all_reduces_a_block(tp2):
    n_layers = ranks.gspmd_cfg().n_layers
    for r in tp2:
        reduces = {k: v for k, v in r["comm"].items() if "all_reduce" in k}
        assert sum(reduces.values()) == 2 * n_layers, r["comm"]
        assert sum(r["comm"].values()) == 2 * n_layers, r["comm"]


def test_tp2_gradients_match_the_dense_module(tp2):
    _, grads = _dense()
    for r in tp2:
        for name, g in grads.items():
            np.testing.assert_allclose(r["grads"][name], g, rtol=0,
                                       atol=1e-5, err_msg=name)
