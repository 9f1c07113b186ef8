"""Worker entry for the programmatic multi-slot ``run``.

The port of the JAX package's ``runner/task_fn.py``. Parity:
``horovod/runner/task_fn.py`` -- the process each slot executes when the
user calls :func:`horovod_tpu_torch.runner.api.run` with several slots.
The function rides the launcher's rendezvous KV:

  GET  program/func      -> pickle (func, args, kwargs)
  GET  program/device    -> "" (this slot's card) or "cpu"
  PUT  result/<rank>     <- pickle result

The world is initialized from the launcher's per-slot env before the
function runs: NCCL on the slot's card, or a gloo world of CPU processes
when the caller asked for ``device="cpu"``.
"""

from __future__ import annotations

import pickle
import sys


def main() -> int:
    from .. import context
    from .api import kv_client

    client = kv_client()
    func, args, kwargs = pickle.loads(
        client.wait("program", "func", deadline=60.0)
    )
    device = client.wait("program", "device", deadline=60.0).decode() or None
    backend = "gloo" if device == "cpu" else "nccl"
    context.init(device, backend=backend)
    try:
        result = func(*args, **kwargs)
        client.put("result", str(context.rank()), pickle.dumps(result))
    finally:
        context.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
