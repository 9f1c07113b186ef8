"""Inference serving on the card -- the port of ``horovod_tpu.serve``'s
request-level and token-level tiers.

* :class:`Dispatcher` -- continuous batching into the ONE fixed batch
  shape, with an in-flight ledger so a dead worker's requests re-queue
  instead of dropping;
* :class:`ServePool` -- the replicated worker pool: manifest-verified
  checkpoint loads (CRC walk-back on corruption), queue-depth autoscaling
  (:class:`QueueDepthPolicy`), and rolling checkpoint hot-swap one worker
  at a time with automatic walk-back rollback;
* :class:`DecodeEngine` -- the token-level tier: continuous batching at
  decode granularity over a paged KV-cache pool (:mod:`.kvcache`, int8 with
  ``kv_dtype="int8"``), streaming futures, speculative decoding with a
  draft tier, and the zero-drop ledger at sequence granularity (a killed
  worker's streams resume from prompt + committed tokens); :class:`CacheLM`
  is the model it drives.

Quickstart (GPT-2 small on the card)::

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.serve import ServePool

    cfg = hvt.GPT2Config.small()
    hvt.save_checkpoint("/ckpts", hvt.convert.init_params(cfg, seed=0), 1)
    template = hvt.GPT2LMModel(cfg)   # bf16 weights, on the card
    pool = ServePool(lambda m, toks: m(toks)[:, -1, :],
                     ckpt_dir="/ckpts", ckpt_target=template).start()
    logits = pool.submit(tokens).result(timeout=10.0)   # [50257] fp32
"""

from ..elastic.scale import QueueDepthPolicy  # noqa: F401
from ..ops.batching import (  # noqa: F401
    BatchSpec,
    pack_prompts,
    pack_requests,
    unpack_requests,
    unpack_responses,
)
from .dispatcher import (  # noqa: F401
    BatchLease,
    Dispatcher,
    ServeError,
    ServeFuture,
    ServeRequestDropped,
    ServeRequestFailed,
)
from .pool import ServePool, ServingWorker  # noqa: F401
from .engine import DecodeEngine, DecodeWorker, StreamFuture  # noqa: F401
from .kvcache import BlockTable, KVBlockPool, OutOfBlocks  # noqa: F401
from .model import CacheLM, CacheLMConfig, perturbed_params  # noqa: F401
