"""The port's communication audit (horovod_tpu_torch/tools/comm_audit.py)
held against the JAX package's bucket policy, on the CPU.

The audit records the port's GPT-2-small (16 x 1024) data-parallel step
under fake tensors at a simulated world of 8. Its predicted buckets must
equal the JAX package's ``bucket_byte_layout`` (fp32, ZeRO-1 padding) and
``quantized_bucket_layout`` (int8) exactly on the same shapes -- the
port's parameters as a dict of ``ShapeDtypeStruct`` (the flax tree splits
the fused QKV and orders its leaves otherwise, so its buckets split at
other leaves) -- the
recorded collectives must match them (parity clean, no finding), and the
ring-wire bytes must be the same at ``accum`` 1 and 4. The ring model and
the by-kind sums are the JAX tool's, held exactly on the same op lists. The
reference's own ``lint_audit`` is not run: its jaxpr walk fails on this
jax (ROADMAP C).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import pytest

import torch

from horovod_tpu.ops import compression as jcomp
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch.models import GPT2Config, GPT2LMModel
from horovod_tpu_torch.tools import comm_audit as ca

GPT2 = "gpt2_small_16x1024"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_comm_audit", os.path.join(REPO, "tools", "comm_audit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_params():
    """GPT-2 small's parameter shapes (built on the meta device) for the
    JAX package's layout functions."""
    model = GPT2LMModel(GPT2Config.small(param_dtype=torch.float32),
                        device="meta")
    return {k: jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
            for k, p in model.named_parameters()}


@pytest.fixture(scope="module", autouse=True)
def _one_record_a_configuration():
    """GPT-2 small is built and recorded once a configuration for the
    module's cases (about 6 s and 2.4 GB of host memory a record), the
    lint and audit rows both from that record."""
    with ca.shared_recordings():
        yield


def _kinds(row):
    return [c["kind"] for c in row["recorded_collectives"]]


def test_lint_audit_gpt2_small_zero1_predicts_the_references_buckets():
    row = ca.lint_audit(GPT2, sharded=True)
    want = [{"dtype": d, "bytes": b} for d, b in
            jfusion.bucket_byte_layout(_ref_params(), pad_multiple=8)]
    assert row["predicted_buckets"] == want
    assert len(want) > 1
    assert row["parity_ok"] and row["clean"], row["findings"]
    kinds = _kinds(row)
    n = len(want)
    assert kinds[:2 * n] == ["reduce_scatter"] * n + ["all_gather"] * n
    scatters = row["recorded_collectives"][:n]
    assert [c["in_bytes"] for c in scatters] == [b["bytes"] for b in want]
    assert row["ring_wire_bytes"] > 0 and row["n_devices"] == 8


def test_lint_audit_gpt2_small_int8_predicts_the_references_buckets():
    row = ca.lint_audit(GPT2, sharded=True, compression="int8")
    want = jfusion.quantized_bucket_layout(
        _ref_params(), world=8, compression=jcomp.Compression.int8)
    assert row["predicted_buckets"] == [dict(b) for b in want]
    assert row["parity_ok"] and row["clean"], row["findings"]
    assert row["compression"] == "int8"


def test_microbatch_parity_cli_accum_1_and_4(capsys):
    rc = ca.main(["--model", "gpt2", "--sharded", "--microbatch-parity"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["wire_bytes_unchanged"]
    assert out["accum_steps"] == 4
    assert out["wire_bytes_accum1"] == out["wire_bytes_accum4"] > 0
    assert out["bytes_by_kind_accum1"] == out["bytes_by_kind_accum4"]


def test_audit_replicated_against_zero1_byte_parity():
    """The fused allreduce's ring bytes against ZeRO-1's reduce-scatter
    plus all-gather of the same payload: within 1.1x (padding), and the
    timeline's FUSE_BUCKETS layout is the predicted one."""
    row = ca.byte_parity(GPT2)
    assert row["parity_within_1p1x"], row
    assert 1.0 <= row["wire_ratio_sharded_over_psum"] <= 1.1
    assert set(row["sharded_bytes_by_kind"]) >= {"reduce-scatter",
                                                 "all-gather"}
    rep = ca.audit(GPT2)
    fused = [e for e in rep["fusion_buckets"] if e["mode"] == "allreduce"]
    assert fused and fused[0]["bucket_bytes"] == [
        b for _, b in jfusion.bucket_byte_layout(_ref_params())]
    assert not any(fused[0]["pad_elements"])
    assert rep["collective_kinds"] == ["all-reduce"]
    assert rep["gradient_bytes_per_step"] == sum(fused[0]["bucket_bytes"])
    # The buckets' all-reduces and the loss's: the result bytes.
    assert rep["collective_bytes"] == rep["gradient_bytes_per_step"] + 4


@pytest.mark.parametrize("case", ["allreduce", "sharded", "mixed"])
def test_ring_model_is_the_reference_tools(case):
    ops = {
        "allreduce": [{"kind": "all-reduce", "bytes": 4096},
                      {"kind": "all-reduce-start", "bytes": 1000}],
        "sharded": [{"kind": "reduce-scatter", "bytes": 512},
                    {"kind": "all-gather", "bytes": 4096}],
        "mixed": [{"kind": "all-to-all", "bytes": 800},
                  {"kind": "collective-permute", "bytes": 64},
                  {"kind": "all-reduce", "bytes": 8}],
    }[case]
    ref = _ref_tool()
    for n in (2, 8):
        assert ca._ring_wire_bytes(ops, n) == ref._ring_wire_bytes(ops, n)
    assert ca._bytes_by_kind(ops) == ref._bytes_by_kind(ops)


def test_shared_recordings_record_a_configuration_once(monkeypatch):
    """Outside a shared scope every row builds and records its step;
    inside one, a configuration's audit and lint rows come from one
    record, and the scope's rows are copies the caller may change."""
    built = []
    monkeypatch.setattr(ca, "_build",
                        lambda *a, **k: built.append((a, k)) or (0, 0, 0))
    monkeypatch.setattr(ca, "_record", lambda *a: ("rec", ["buckets"]))
    monkeypatch.setattr(ca, "_ROW", {
        "audit": lambda key, state, rec, b: {"audit": key, "b": list(b)},
        "lint": lambda key, state, rec, b: {"lint": key}})
    monkeypatch.setattr(ca, "_SHARED", None)
    ca.audit("m")
    ca.lint_audit("m")
    assert len(built) == 2
    built.clear()
    with ca.shared_recordings():
        row = ca.audit("m", sharded=True)
        assert ca.lint_audit("m", sharded=True) == {
            "lint": ("m", ca.N_DEVICES, True, 1, None)}
        row["b"].append("changed")
        assert ca.audit("m", sharded=True)["b"] == ["buckets"]
        ca.audit("m", accum=4)
    assert len(built) == 2 and ca._SHARED is None
