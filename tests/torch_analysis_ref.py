"""The JAX package's analysis plane as the port's analysis tests run it.

Every walk in ``horovod_tpu/analysis`` reads ``jax.core.ClosedJaxpr`` and
``jax.core.Jaxpr``, which jax 0.9.0 moved to ``jax.extend.core``.
:func:`jax_core_shim` puts the two attributes back on ``jax.core`` for the
duration of a ``with`` block, where they are missing, and takes them away
after it, so the reference's own lint, cert and plan run in the port's
tests without a change to the JAX package and without leaking into any
other test.
"""

from __future__ import annotations

import contextlib

import jax
import pytest

_NAMES = ("ClosedJaxpr", "Jaxpr")


@contextlib.contextmanager
def jax_core_shim():
    """``jax.core.ClosedJaxpr`` and ``jax.core.Jaxpr`` for the block: from
    ``jax.extend.core`` where this jax lacks them, untouched where it has
    them."""
    with pytest.MonkeyPatch.context() as mp:
        missing = [n for n in _NAMES if not hasattr(jax.core, n)]
        if missing:
            from jax.extend import core as xcore

            for name in missing:
                mp.setattr(jax.core, name, getattr(xcore, name),
                           raising=False)
        yield


def shim_state():
    """Which of the shimmed names ``jax.core`` holds now."""
    return {name: hasattr(jax.core, name) for name in _NAMES}


@contextlib.contextmanager
def reference_world(n: int = 8):
    """The reference's harness world: ``n`` virtual CPU devices under the
    shim, its caches dropped and the world shut down after."""
    import horovod_tpu as hvd
    from horovod_tpu.analysis import harness

    with jax_core_shim():
        hvd.init(devices=jax.devices("cpu")[:n])
        try:
            yield harness
        finally:
            harness.clear_caches()
            hvd.shutdown()
