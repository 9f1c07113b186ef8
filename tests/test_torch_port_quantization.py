"""The port's quantized wire held against the JAX package's, on the CPU.

* The plain blockwise quantize/dequantize (``ops/quantization.py``, the
  kernels' plain versions) against the JAX ``impl="jax"`` path -- the one
  the JAX package takes everywhere but on a TPU -- for int8 and fp8, blocks
  8/16/128/256/65536, ragged tails and an all-zero block: payloads, scales
  and dequantized values bit for bit (tolerance 0: the same IEEE-rounded
  operations in the same order, round half to even on both sides).
* Against ``impl="pallas"`` in interpret mode: the interpreter computes the
  scale as ``amax * (1 / qmax)``, a multiply by the rounded reciprocal,
  where the jax path and the port divide. The two differ by one ulp in a
  few blocks (42 of 1024 blocks for int8 on this input), so scales are held
  within 1 ulp; payloads bit for bit where the scales agree (every int8
  payload here agrees; an e4m3 value can sit on a rounding boundary that a
  one-ulp scale moves, so a differing block may differ by one e4m3 step).
* ``quantized_wire_bytes``, ``quantized_bucket_layout``, the
  ``QuantCompressor`` round trip, ``Compression.by_name`` and the env
  knobs: equal to the JAX package's.
* The quantized collectives on a gloo world of 2 CPU processes
  (``context.spawn_gloo``) against the JAX functions under ``shard_map`` on
  2 CPU devices: ``quantized_fused_allreduce`` with and without residuals,
  Average and Sum, ``quantized_fused_reducescatter``, and the quantized
  all-gather (after a quantized and after an unquantized reduce-scatter),
  int8 and fp8. With two ranks the fp32 sum has one order, but these are
  not bit for bit: compiled by XLA on the CPU, the JAX functions (a)
  multiply by the reciprocal of ``qmax`` where they divide eagerly (the
  same one-ulp scale drift as the Pallas interpreter) and (b) contract the
  dequantize-and-sum and the EF residual ``x - q * s`` into fused
  multiply-adds; the port rounds every operation, as its kernels do. Each
  moves a value by an ulp or two of the largest magnitude involved, so
  reduced values are held within ``2**-20`` of the tree's largest output
  and residuals within ``2**-21`` of the largest input. A payload moved by
  a whole wire step (1/127 of a block's max for int8) would break either
  bound; none does on these inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import _compat
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.ops import quantization as jq
from horovod_tpu.ops.compression import Compression as JComp
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch import context
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.ops import quantization as tq
from horovod_tpu_torch.ops.compression import Compression as TComp
from horovod_tpu_torch.utils import env as tenv

SPECS = ["int8", "fp8"]
BLOCKS = [8, 16, 128, 256, 65536]


def _spec(name):
    return (jq.INT8, tq.INT8) if name == "int8" else (jq.FP8, tq.FP8)


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _input(n, block, seed):
    x = (np.random.RandomState(seed).standard_normal(n) * 7).astype(np.float32)
    x[block:2 * block] = 0.0  # an all-zero block (where n reaches one)
    return x


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", SPECS)
def test_plain_versions_are_the_jax_path_bit_for_bit(name, block):
    jspec, tspec = _spec(name)
    for n in (1000, 3 * block + 5, 140_001):
        x = _input(n, block, seed=block + n)
        qj, sj = jq.quantize_blockwise(jnp.asarray(x), block, jspec,
                                       impl="jax")
        qt, st = tq.quantize_blockwise(torch.from_numpy(x), block, tspec)
        assert qt.dtype == tspec.wire_dtype and qt.shape == (n,)
        assert st.dtype == torch.float32 and st.shape == (-(-n // block),)
        np.testing.assert_array_equal(_bits(qt.view(torch.uint8).numpy()),
                                      _bits(qj))
        np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
        dj = jq.dequantize_blockwise(qj, sj, block, impl="jax")
        dt = tq.dequantize_blockwise(qt, st, block)
        np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))
        if n >= 2 * block:  # the all-zero block: scale 1, exact zeros
            assert st[1] == 1.0 and not dt[block:2 * block].any()


@pytest.mark.parametrize("name", SPECS)
def test_plain_versions_against_the_pallas_interpreter(name):
    jspec, tspec = _spec(name)
    x = (np.random.RandomState(2).standard_normal(262_144) * 7).astype(
        np.float32)
    qp, sp = jq.quantize_blockwise(jnp.asarray(x), 256, jspec, impl="pallas")
    qt, st = tq.quantize_blockwise(torch.from_numpy(x), 256, tspec)
    ulps = np.abs(_bits(st.numpy()).astype(np.int64) - _bits(sp).astype(np.int64))
    assert ulps.max() <= 1 and ulps.sum() > 0  # the reciprocal's ulp
    same = np.repeat(ulps == 0, 256)
    tq_bits = _bits(qt.view(torch.uint8).numpy())
    np.testing.assert_array_equal(tq_bits[same], _bits(qp)[same])
    if name == "int8":
        np.testing.assert_array_equal(tq_bits, _bits(qp))
    else:
        step = np.abs(tq_bits.astype(np.int16) - _bits(qp).astype(np.int16))
        assert step.max() <= 1  # one e4m3 step, same sign
    dp = jq.dequantize_blockwise(jnp.asarray(qp), jnp.asarray(sp), 256,
                                 impl="pallas")
    dt = tq.dequantize_blockwise(
        torch.from_numpy(np.array(qp).view(np.uint8)).view(tspec.wire_dtype),
        torch.from_numpy(np.array(sp)), 256)
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dp))


def test_nan_block_gets_scale_one_and_the_wrapper_counts_no_cpu_launch():
    x = np.random.RandomState(5).standard_normal(64).astype(np.float32)
    x[20] = np.nan
    # Scale 1 leaves 1000 past e4m3's range: NaN in jax's cast, where
    # torch's CPU cast would saturate to 448; int8 clips it to 127.
    x[21] = 1000.0
    tq.reset_launches()
    for name in SPECS:
        jspec, tspec = _spec(name)
        qt, st = tq.quantize_blockwise(torch.from_numpy(x), 16, tspec)
        qj, sj = jq.quantize_blockwise(jnp.asarray(x), 16, jspec, impl="jax")
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert st[1] == 1.0
        keep = np.ones(64, bool)
        keep[20] = False  # a NaN's int8 value is undefined in both
        np.testing.assert_array_equal(
            _bits(qt.view(torch.uint8).numpy())[keep], _bits(qj)[keep])
        if name == "fp8":
            assert torch.isnan(qt[21].float())
        tq.dequantize_blockwise(qt, st, 16)
    assert tq.launches_quant == tq.launches_dequant == 0


def test_wrappers_check_their_inputs():
    x = torch.ones(10)
    with pytest.raises(ValueError, match="flat"):
        tq.quantize_blockwise(x.reshape(2, 5), 4)
    with pytest.raises(ValueError, match="block"):
        tq.quantize_blockwise(x, 0)
    q, s = tq.quantize_blockwise(x, 4)
    with pytest.raises(ValueError, match="scales"):
        tq.dequantize_blockwise(q, s[:2], 4)
    with pytest.raises(ValueError, match="meta"):
        tq.quantize_blockwise(x.to("meta"), 4)
    assert tq.dequantize_blockwise(q, s, 4, out_dtype=torch.bfloat16).dtype == (
        torch.bfloat16)


@pytest.mark.parametrize("name", SPECS)
def test_quantized_wire_bytes_match_the_reference(name):
    jspec, tspec = _spec(name)
    for n, block in ((256, 256), (300, 256), (1 << 20, 256), (1000, 8),
                     (7, 65536)):
        assert tq.quantized_wire_bytes(n, block, tspec) == (
            jq.quantized_wire_bytes(n, block, jspec))
    assert tq.quantized_wire_bytes(1 << 20, 256, tspec) / (2 << 20) <= 0.55


@functools.lru_cache(maxsize=1)
def _flax_shapes():
    cfg = jgpt2.GPT2Config.small()
    return jax.eval_shape(
        jgpt2.GPT2LMModel(cfg).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 8), jnp.int32),
    )["params"]


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("block", [8, 256])
@pytest.mark.parametrize("name", SPECS)
def test_quantized_bucket_layout_matches_the_reference(name, block, world):
    shapes = _flax_shapes()
    meta = jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        shapes,
    )
    want = jfusion.quantized_bucket_layout(
        shapes, 64 << 20, world=world,
        compression=getattr(JComp, name).with_block(block))
    got = tfusion.quantized_bucket_layout(
        meta, 64 << 20, world=world,
        compression=getattr(TComp, name).with_block(block))
    assert got == want and len(got) > 1
    for row in got:
        assert row["elements"] % (world * block) == 0


@pytest.mark.parametrize("name", SPECS)
def test_quant_compressor_round_trip_matches_the_reference(name):
    x = np.random.RandomState(3).standard_normal((8, 6)).astype(np.float32)
    tc, jc = getattr(TComp, name).with_block(32), getattr(JComp, name).with_block(32)
    assert tc.block_size() == 32 and repr(tc) == repr(jc)
    wire, ctx = tc.compress(torch.from_numpy(x))
    jwire, jctx = jc.compress(jnp.asarray(x))
    assert wire.dtype == tc.spec.wire_dtype
    np.testing.assert_array_equal(_bits(wire.view(torch.uint8).numpy()),
                                  _bits(jwire))
    out = tc.decompress(wire, ctx)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jc.decompress(jwire, jctx)))
    assert TComp.int8.block is None and TComp.int8.with_block(8).block == 8


def test_by_name_and_is_quantized_match_the_reference():
    from horovod_tpu.ops.compression import is_quantized as jis
    from horovod_tpu_torch.ops.compression import is_quantized as tis

    for name in ("none", "fp16", "bf16", "int8", "fp8"):
        t, j = TComp.by_name(name), JComp.by_name(name)
        assert tis(t) == jis(j)
        assert t is getattr(TComp, name)
    with pytest.raises(ValueError, match="int4"):
        TComp.by_name("int4")


def test_quant_env_knobs_share_the_reference_names_and_defaults(monkeypatch):
    assert (tenv.QUANT, tenv.QUANT_BLOCK, tenv.DEFAULT_QUANT_BLOCK) == (
        jenv.QUANT, jenv.QUANT_BLOCK, jenv.DEFAULT_QUANT_BLOCK)
    for value in (None, "int8", "FP8", "off", "none", "0"):
        if value is None:
            monkeypatch.delenv("HVDTPU_QUANT", raising=False)
        else:
            monkeypatch.setenv("HVDTPU_QUANT", value)
        assert tenv.quant_mode() == jenv.quant_mode()
    monkeypatch.setenv("HVDTPU_QUANT", "int4")
    with pytest.raises(ValueError, match="int4"):
        tenv.quant_mode()
    monkeypatch.delenv("HVDTPU_QUANT")
    assert tenv.quant_block() == jenv.quant_block() == 256
    monkeypatch.setenv("HOROVOD_QUANT_BLOCK", "128")
    assert tenv.quant_block() == jenv.quant_block() == 128
    assert tq.default_block() == 128
    monkeypatch.setenv("HVDTPU_QUANT_BLOCK", "0")
    with pytest.raises(ValueError):
        tenv.quant_block()


# -- the quantized collectives on world 2 ---------------------------------

WORLD = 2
THRESHOLD = 256  # bytes: several buckets
BLOCK = 8


def _tree(rank):
    rs = np.random.RandomState(rank)
    w = rs.standard_normal((5, 7)).astype(np.float32)
    w[1] *= 1e-3  # scale-disparate values sharing blocks
    return {
        "w": w,
        "b": rs.standard_normal((13,)).astype(np.float32),
        "z": {"k": rs.standard_normal((3, 11)).astype(np.float32)},
        "h": rs.standard_normal((4, 9)).astype(np.float32),
    }


def _residuals(rank, name):
    comp = getattr(JComp, name).with_block(BLOCK)
    layout = jfusion.quantized_bucket_layout(
        _tree(0), THRESHOLD, world=WORLD, compression=comp)
    rs = np.random.RandomState(100 + rank)
    return [(rs.standard_normal(r["elements"]) * 0.01).astype(np.float32)
            for r in layout]


def _np_tree(t):
    return jax.tree.map(lambda x: x.numpy(), t)


def _port_quantized():
    """One rank of the gloo world: every quantized collective, each wire."""
    rank = context.rank()
    tree = jax.tree.map(torch.from_numpy, _tree(rank))
    out = {}
    for name in SPECS:
        comp = getattr(TComp, name).with_block(BLOCK)
        res = tfusion.EFResiduals(
            [torch.from_numpy(r) for r in _residuals(rank, name)],
            threshold=THRESHOLD, block=BLOCK)
        rec = {}
        for op in ("Average", "Sum"):
            red, new = tfusion.quantized_fused_allreduce(
                tree, res, op=getattr(tfusion, op), threshold_bytes=THRESHOLD,
                compression=comp)
            rec[f"ar_ef_{op}"] = (_np_tree(red), [b.numpy() for b in new.buffers])
            red, none = tfusion.quantized_fused_allreduce(
                tree, None, op=getattr(tfusion, op), threshold_bytes=THRESHOLD,
                compression=comp)
            assert none is None
            rec[f"ar_{op}"] = _np_tree(red)
        shards, spec, new = tfusion.quantized_fused_reducescatter(
            tree, res, threshold_bytes=THRESHOLD, compression=comp)
        rec["rs"] = ([s.numpy() for s in shards.buffers],
                     [b.numpy() for b in new.buffers])
        rec["ag"] = _np_tree(tfusion.fused_allgather(shards, spec,
                                                     compression=comp))
        plain, pspec = tfusion.fused_reducescatter(tree,
                                                   threshold_bytes=THRESHOLD)
        rec["ag_after_plain_rs"] = _np_tree(
            tfusion.fused_allgather(plain, pspec, compression=comp))
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def port_world():
    return context.spawn_gloo(WORLD, _port_quantized)


@pytest.fixture(scope="module")
def jax_world():
    ctx = hvd.init(devices=jax.devices("cpu")[:WORLD])
    try:
        yield {name: _jax_quantized(ctx, name) for name in SPECS}
    finally:
        hvd.shutdown()


def _jax_quantized(ctx, name):
    comp = getattr(JComp, name).with_block(BLOCK)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[_tree(r) for r in range(WORLD)])
    res = [jnp.concatenate(bufs) for bufs in
           zip(*[_residuals(r, name) for r in range(WORLD)])]
    ax = hvd.WORLD_AXIS

    def body(t, res_bufs):
        t = jax.tree.map(lambda x: x[0], t)
        res = jfusion.EFResiduals(list(res_bufs), threshold=THRESHOLD,
                                  block=BLOCK)
        out = {}
        for op in ("Average", "Sum"):
            red, new = jfusion.quantized_fused_allreduce(
                t, res, op=getattr(hvd, op), threshold_bytes=THRESHOLD,
                compression=comp)
            out[f"ar_ef_{op}"] = (red, new.buffers)
            red, _ = jfusion.quantized_fused_allreduce(
                t, None, op=getattr(hvd, op), threshold_bytes=THRESHOLD,
                compression=comp)
            out[f"ar_{op}"] = red
        shards, spec, new = jfusion.quantized_fused_reducescatter(
            t, res, threshold_bytes=THRESHOLD, compression=comp)
        out["rs"] = (shards.buffers, new.buffers)
        out["ag"] = jfusion.fused_allgather(shards, spec, compression=comp)
        plain, pspec = jfusion.fused_reducescatter(t, threshold_bytes=THRESHOLD)
        out["ag_after_plain_rs"] = jfusion.fused_allgather(
            plain, pspec, compression=comp)
        return out

    specs = {}
    for k in ("ar_ef_Average", "ar_ef_Sum"):
        specs[k] = (P(), P(ax))
    for k in ("ar_Average", "ar_Sum", "ag", "ag_after_plain_rs"):
        specs[k] = P()
    specs["rs"] = (P(ax), P(ax))
    fn = jax.jit(_compat.shard_map(
        body, mesh=ctx.mesh, in_specs=(P(ax), P(ax)), out_specs=specs,
        check_vma=False,
    ))
    return jax.tree.map(np.asarray, fn(stacked, tuple(res)))


def _close(a, b, scale=None):
    """Every leaf of ``a`` within ``2**-20`` of ``b``'s largest magnitude
    (or ``2**-21 * scale``); see the module docstring."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) > 0
    atol = (2.0 ** -20 * max(float(np.abs(y).max()) for y in lb)
            if scale is None else 2.0 ** -21 * scale)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _ranks_agree(trees):
    """Every rank ends with the same reduced values (tolerance 0)."""
    for leaves in zip(*(jax.tree.leaves(t) for t in trees)):
        for x in leaves[1:]:
            np.testing.assert_array_equal(x, leaves[0])


def _input_max(name):
    """Largest |x + residual| any rank quantizes on its send side."""
    return max(
        max(float(np.abs(v).max()) for v in jax.tree.leaves(_tree(r)))
        + max(float(np.abs(v).max()) for v in _residuals(r, name))
        for r in range(WORLD)
    )


def _per_rank(full_bufs, rank):
    """Rank ``rank``'s chunk of buffers concatenated over the world axis."""
    return [np.split(b, WORLD)[rank] for b in full_bufs]


@pytest.mark.parametrize("op", ["Average", "Sum"])
@pytest.mark.parametrize("name", SPECS)
def test_quantized_allreduce_matches_the_reference(port_world, jax_world,
                                                   name, op):
    want = jax_world[name]
    for rank in range(WORLD):
        got = port_world[rank][name]
        _close(got[f"ar_{op}"], want[f"ar_{op}"])
        red, res = got[f"ar_ef_{op}"]
        _close(red, want[f"ar_ef_{op}"][0])
        _close(res, _per_rank(want[f"ar_ef_{op}"][1], rank), _input_max(name))
        assert any(np.abs(r).max() > 0 for r in res)
    _ranks_agree([port_world[r][name][f"ar_{op}"] for r in range(WORLD)])
    _ranks_agree([port_world[r][name][f"ar_ef_{op}"][0] for r in range(WORLD)])


@pytest.mark.parametrize("name", SPECS)
def test_quantized_reducescatter_matches_the_reference(port_world, jax_world,
                                                       name):
    want_shards, want_res = jax_world[name]["rs"]
    for rank in range(WORLD):
        shards, res = port_world[rank][name]["rs"]
        _close(shards, _per_rank(want_shards, rank))
        _close(res, _per_rank(want_res, rank), _input_max(name))
        for s in shards:
            assert s.shape[0] % BLOCK == 0


@pytest.mark.parametrize("leg", ["ag", "ag_after_plain_rs"])
@pytest.mark.parametrize("name", SPECS)
def test_quantized_allgather_matches_the_reference(port_world, jax_world,
                                                   name, leg):
    want = jax_world[name][leg]
    for rank in range(WORLD):
        _close(port_world[rank][name][leg], want)
    _ranks_agree([port_world[r][name][leg] for r in range(WORLD)])


# ---- the quant soak (A13c) -------------------------------------------------


def test_chaos_crash_restore_preserves_ef_state():
    """The twin of tests/test_quantization.py::
    test_chaos_crash_restore_preserves_ef_state on the port's soak: int8
    and error-feedback training through the elastic launcher is crashed
    mid-run; the respawn restores the whole TrainState, EF residuals
    included (non-zero at the restore), and ends on the fault-free run's
    final parameters bit for bit."""
    from horovod_tpu_torch.tools import chaos_soak

    res = chaos_soak.run_scenario("quant", steps=5, timeout=120)
    problems = chaos_soak.check_invariants(res, steps=5)
    assert not problems, problems
