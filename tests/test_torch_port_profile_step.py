"""The port's ``tools/profile_step.py`` (``horovod_tpu_torch.tools.
profile_step``), the twin of ``tests/test_profile_step.py``.

The JAX package's tool needs TensorFlow's xplane converter and raises
``ConverterUnavailable`` without it; the port's reads ``torch.profiler``'s
own device trace, so its twins check that nothing of TensorFlow is needed,
that :func:`categorize` sorts the JAX package's op names as the JAX
package's does (and the port's kernels into their own rows), and that the
rollup's arithmetic -- categories against the profiler's total, the busy
union and the idle share of the window -- is right on a synthetic trace
(exact) and on a real CPU profile of BERT and ResNet at tiny sizes, built by
a small builder put in place of the tool's :func:`build`, and that the
scopes label a BatchNorm's forward ops and its backward nodes.
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import pytest

from horovod_tpu_torch.tools import profile_step as ps


def _tiny_build(model_name, device="cpu"):
    """The tool's ``build`` at tiny sizes on the CPU: ResNet-18 on 2
    images of 64 x 64, BERT tiny (plain attention) on 2 x 32 tokens."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import record_function

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.parallel import dp

    rng = np.random.default_rng(0)
    if model_name == "resnet50":
        model = hvt.ResNet18(num_classes=10, dtype=torch.float32,
                             device=device)
        model.load_state_dict(hvt.convert.init_resnet_params(model, seed=0))
        x = torch.from_numpy(rng.standard_normal(
            (2, 3, 64, 64)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, (2,)))
        opt = hvt.sgd(0.1, momentum=0.9)
    else:
        cfg = hvt.BertConfig.tiny(dtype=torch.float32, use_flash=False)
        model = hvt.BertModel(cfg, device=device)
        model.load_state_dict(hvt.convert.init_bert_params(cfg, seed=0))
        x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
        y = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
        opt = hvt.adamw(1e-4)

    def loss_fn(p, b):
        logits = torch.func.functional_call(model, p, (b[0],))
        with record_function(ps.SCOPE + "loss"):
            return F.cross_entropy(logits.flatten(0, -2).float(),
                                   b[1].flatten())

    step, wrapped = dp.make_train_step(loss_fn, opt, device=device)
    return step, dp.init_state(model, wrapped), (x, y), model


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(ps, "build", _tiny_build)


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "ref_profile_step",
        os.path.join(os.path.dirname(__file__), "..", "tools",
                     "profile_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_converter_absent_is_actionable(monkeypatch, tiny):
    """No converter to be absent: with TensorFlow hidden the tool profiles
    a step and rolls it up (the JAX package's raises ConverterUnavailable
    with an install hint)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for name in list(sys.modules):
        if name.startswith("tensorflow."):
            monkeypatch.setitem(sys.modules, name, None)
    assert not hasattr(ps, "ConverterUnavailable")
    summary, losses, launches = ps.profile("bert", steps=2)
    assert len(losses) == 2 and all(x == x for x in losses)
    assert summary["steps"] == 2
    # The CPU has no device trace: nothing to roll up, no idle share.
    assert summary["kernels"] == [] and summary["idle_share"] is None
    assert summary["scopes"] == {} and summary["linked_us"] == 0.0
    assert launches == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                        "flash_bwd_dq": 0}


@pytest.mark.parametrize("model", ["bert", "resnet50"])
def test_cli_end_to_end_on_the_cpu(model, tmp_path, capsys, tiny):
    """The command line end to end on the CPU (tiny shapes): it exits 0,
    prints the rollup and writes the JSON summary."""
    out = tmp_path / "s.json"
    assert ps.main(["--model", model, "--top", "3", "--json",
                    str(out)]) == 0
    text = capsys.readouterr().out
    assert "category rollup:" in text and "top 3 kernels" in text
    summary = json.loads(out.read_text())
    assert summary["model"] == model and len(summary["losses"]) == 5


def test_categorize_unchanged():
    ref = _load_reference()
    assert ps.categorize("fused_all-reduce.1") == "allreduce"
    assert ps.categorize("convolution.3") == "conv"
    assert ps.categorize("reduce.7") == "bn_reduce"
    assert ps.categorize("weird_op") == "other"
    # The JAX package's op names land where its categorize puts them.
    for name in ("fused_all-reduce.1", "all-gather.2", "reduce-scatter",
                 "convolution.3", "reduce.7", "copy.4", "transpose.1",
                 "fusion.12", "add.3", "multiply", "select.1", "maximum",
                 "weird_op"):
        assert ps.categorize(name) == ref.categorize(name), name
    # The port's kernels and the CUDA libraries' get rows of their own.
    assert ps.categorize("void flash_fwd_kernel<64, true>(Params)") == "flash"
    assert ps.categorize("flash_bwd_dkdv_kernel") == "flash"
    assert ps.categorize("fused_adamw_kernel") == "fused_adamw"
    assert ps.categorize("quantize_blockwise_kernel_warp") == "quant"
    assert ps.categorize("int8_matmul_kernel") == "int8/fp8 matmul"
    assert ps.categorize("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert ps.categorize(
        "sm90_xmma_fprop_implicit_gemm_bf16bf16") == "conv"
    assert ps.categorize("ncclDevKernel_AllReduce_Sum_f32") == "allreduce"
    assert ps.categorize("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT") == "gemm"


def _event(name, start, end, cuda=True, annotation=False, parent=None,
           seq=-1, fwd_thread=0, kernels=(), corr=None):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, key=name, is_user_annotation=annotation,
        id=corr if corr is not None else (name, start),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start),
        cpu_parent=parent, thread=1, fwd_thread=fwd_thread,
        sequence_nr=seq,
        kernels=[SimpleNamespace(duration=d) for d in kernels])


def _avg(name, us, cuda=True, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        key=name, is_user_annotation=annotation, self_device_time_total=us,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_summary_of_a_synthetic_trace():
    """Overlapping kernels on two streams count once in the busy union;
    the idle share is the rest of the window; the categories sum to the
    profiler's total; a scope holds its forward and backward kernels, each
    launch's once. The window's range, mirrored on the device as a
    user annotation, and the CPU ops' device times are no device work."""
    win = _event("profile_step.window", 0.0, 100.0, cuda=False)
    loss = _event("profile_step.scope.loss", 1.0, 3.0, cuda=False,
                  parent=win)
    node = _event("MmBackward0", 4.0, 6.0, cuda=False, seq=7,
                  fwd_thread=1)
    events = [
        win,
        _event("profile_step.window", 9.0, 99.0, annotation=True),
        loss,
        # The forward op in the loss scope launches the flash kernel, the
        # backward op under its autograd node the GEMM; the AdamW kernel's
        # op is in no scope, and the copy is linked to no operator.
        _event("aten::mm", 1.0, 2.0, cuda=False, parent=loss, seq=7,
               kernels=(20.0,), corr=41),
        # The profiler's own event on the same launch carries its kernels
        # again: they count once.
        _event("Command Buffer Full", 1.5, 1.6, cuda=False,
               kernels=(20.0,), corr=41),
        _event("aten::mm", 4.5, 5.5, cuda=False, parent=node,
               kernels=(20.0,)),
        _event("aten::_foreach_add_", 7.0, 8.0, cuda=False, parent=win,
               kernels=(10.0,)),
        node,
        _event("flash_fwd_kernel", 10.0, 30.0),
        _event("sm90_xmma_gemm_bf16", 20.0, 40.0),  # overlaps the flash
        _event("fused_adamw_kernel", 60.0, 70.0),
        _event("Memcpy HtoD", 95.0, 110.0),  # runs past the window's end
    ]
    totals = [_avg("profile_step.window", 90.0, annotation=True),
              _avg("aten::mm", 20.0, cuda=False)] + [
        _avg(n, t) for n, t in (("flash_fwd_kernel", 20.0),
                                ("sm90_xmma_gemm_bf16", 20.0),
                                ("fused_adamw_kernel", 10.0),
                                ("Memcpy HtoD", 15.0))]
    prof = SimpleNamespace(events=lambda: events,
                           key_averages=lambda: totals)
    s = ps.summarize(prof, steps=5)
    assert s["window_us"] == 100.0
    assert s["busy_us"] == 20.0 + 10.0 + 10.0 + 5.0  # [10,40] [60,70] [95,100]
    assert s["idle_share"] == pytest.approx(0.55, abs=1e-12)
    assert s["category_us"] == s["device_us"] == 65.0
    assert s["scopes"] == {"loss": {"us": 40.0, "count": 2}}
    assert s["linked_us"] == 50.0
    assert set(s["categories"]) == {"flash", "gemm", "fused_adamw",
                                    "copy/transpose"}
    assert [k["name"] for k in s["kernels"]][0] in ("flash_fwd_kernel",
                                                    "sm90_xmma_gemm_bf16")


def test_scopes_label_forward_ops_and_backward_nodes(tiny):
    """On a CPU profile of the tiny ResNet step: a BatchNorm's forward ops
    and the autograd nodes they recorded carry its scope, the loss's
    carry ``loss``, and a convolution's carry none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, state, batch, model = ps.build("resnet50")
    n = ps.scope_modules(model, ps.SCOPED_MODULES["resnet50"])
    assert n == sum(type(m).__name__ == "BatchNorm"
                    for m in model.modules()) > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    scope = ps.scope_labeller(cpu)
    fwd = {}
    bwd = {}
    for e in cpu:
        if e.fwd_thread and e.name.endswith("Backward0"):
            bwd.setdefault(e.name, set()).add(scope(e))
        elif e.name.startswith("aten::") and e.sequence_nr >= 0:
            fwd.setdefault(e.name, set()).add(scope(e))
    assert "batchnorm" in fwd["aten::rsqrt"]
    assert fwd["aten::conv2d"] == {None}
    assert bwd["RsqrtBackward0"] == {"batchnorm"}
    assert bwd["ConvolutionBackward0"] == {None}
    assert bwd["NllLossBackward0"] == {"loss"}
    # A node's backward ops inherit its scope.
    assert any(scope(e) == "batchnorm" for e in cpu
               if e.name == "aten::mul" and not e.fwd_thread
               and e.sequence_nr < 0 and e.cpu_parent is not None
               and e.cpu_parent.name == "MulBackward0")
    del torch
