"""The port stands alone: ``horovod_tpu_torch`` imports neither JAX nor
any module of ``horovod_tpu``, its entry points default to the card and
raise without one, and CPU tensors never launch (or count) a kernel."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "horovod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "horovod_tpu")


def test_import_pulls_in_no_jax_and_no_reference_module():
    code = (
        "import sys, horovod_tpu_torch, horovod_tpu_torch.serve, "
        "horovod_tpu_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.strip().splitlines()[-1]
    assert out == "[]"


def test_sources_import_nothing_of_jax_or_the_reference():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(REPO)}: {n}")
    assert offenders == []
    assert (PKG / "csrc" / "flash_fwd.cu").is_file()
    assert (REPO / "chip_smoke.py").is_file()
    smoke = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in ast.walk(smoke):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""])
            assert all(m.split(".")[0] not in FORBIDDEN for m in mods)


def test_default_device_raises_without_cuda(monkeypatch):
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.serve import ServePool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hvt.GPT2LMModel(hvt.GPT2Config.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServePool(lambda p, b: b, {"w": torch.ones(1)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hvt.resolve_device("cuda:0")
    assert hvt.resolve_device("cpu") == torch.device("cpu")


def test_context_reads_the_launcher_environment(monkeypatch):
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.exceptions import NotInitializedError

    hvt.shutdown()
    with pytest.raises(NotInitializedError):
        hvt.rank()
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    try:
        ctx = hvt.init(device="cpu")
        assert (hvt.rank(), hvt.size(), hvt.local_rank()) == (0, 1, 0)
        assert hvt.device() == torch.device("cpu") and ctx.size == 1
        monkeypatch.setenv("HOROVOD_RANK", "2")
        monkeypatch.setenv("HOROVOD_SIZE", "4")
        monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
        hvt.init(device="cpu")
        assert (hvt.rank(), hvt.size(), hvt.local_rank()) == (2, 4, 1)
        monkeypatch.setenv("RANK", "5")
        monkeypatch.setenv("WORLD_SIZE", "4")
        with pytest.raises(ValueError, match="outside"):
            hvt.init(device="cpu")
        # After init, entry points default to the context's device.
        assert hvt.resolve_device() == torch.device("cpu")
    finally:
        hvt.shutdown()


def test_serve_knobs_share_the_reference_names_and_defaults(monkeypatch):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as tenv

    knobs = ("serve_batch_size", "serve_batch_timeout_ms", "serve_workers",
             "serve_max_workers", "serve_queue_high", "serve_queue_low",
             "serve_scale_cooldown_secs", "serve_request_timeout_secs",
             "serve_ckpt_poll_secs", "fusion_threshold_bytes")
    for k in knobs:
        assert getattr(tenv, k)() == getattr(jenv, k)(), k
    monkeypatch.setenv("HVDTPU_SERVE_BATCH_SIZE", "5")
    monkeypatch.setenv("HOROVOD_SERVE_QUEUE_HIGH", "7.5")
    monkeypatch.setenv("HVDTPU_SERVE_REQUEST_TIMEOUT_SECS", "0")
    for k in knobs:
        assert getattr(tenv, k)() == getattr(jenv, k)(), k
    assert tenv.serve_batch_size() == 5 and tenv.serve_queue_high() == 7.5
    assert tenv.serve_request_timeout_secs() == 0.1


def test_retry_call_retries_then_raises():
    from horovod_tpu_torch.utils.retry import Backoff, retry_call

    calls, seen = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    assert retry_call(flaky, attempts=4, base=0.0, cap=0.0,
                      on_retry=lambda e, n: seen.append(n)) == "ok"
    assert seen == [1, 2]
    with pytest.raises(OSError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("x")), attempts=2,
                   base=0.0, cap=0.0)
    with pytest.raises(ValueError):
        retry_call(lambda: (_ for _ in ()).throw(ValueError("no")))
    b = Backoff(base=0.1, cap=0.4, jitter=0.0)
    assert [b.next_delay() for _ in range(4)] == [0.1, 0.2, 0.4, 0.4]
