"""Control-plane messages of the dynamic-enqueue runtime.

The port of the JAX package's native wire types (``csrc/message.h``,
``csrc/common.h``; the codes of ``horovod_tpu/native/__init__.py:32-51``):
a rank's :class:`Request` that one named tensor is ready, its per-cycle
:class:`RequestList` (new requests, cache bits and its shutdown flag),
the coordinator's :class:`Response` that tensors are globally ready, and
the :class:`ResponseList` every rank executes. The codes are the JAX
package's: a dtype code, a reduce-op code and a request type mean the same
in both.

The lists cross the wire pickled (:func:`encode` / :func:`decode`) in one
exchange a cycle on the runtime's gloo group; the reference's hand-rolled
little-endian codec has no reader here. One field is the port's own: the
device class of the tensor (``"cpu"`` or ``"cuda"``), which picks the data
plane (gloo or NCCL) and keeps tensors of the two apart in fusion.
"""

from __future__ import annotations

import dataclasses
import enum
import pickle
from typing import List, Tuple

import torch

# Stable dtype codes (csrc/common.h DataType).
U8, I8, U16, I16, I32, I64, F16, BF16, F32, F64, BOOL = range(11)

DTYPE_CODES = {
    torch.uint8: U8,
    torch.int8: I8,
    torch.int16: I16,
    torch.int32: I32,
    torch.int64: I64,
    torch.float16: F16,
    torch.bfloat16: BF16,
    torch.float32: F32,
    torch.float64: F64,
    torch.bool: BOOL,
}
if hasattr(torch, "uint16"):
    DTYPE_CODES[torch.uint16] = U16
DTYPES = {code: dt for dt, code in DTYPE_CODES.items()}

DTYPE_NAMES = {
    U8: "uint8", I8: "int8", U16: "uint16", I16: "int16", I32: "int32",
    I64: "int64", F16: "float16", BF16: "bfloat16", F32: "float32",
    F64: "float64", BOOL: "bool",
}

# ReduceOp codes (csrc/common.h).
SUM, AVERAGE, MIN, MAX, PRODUCT, ADASUM = 0, 1, 2, 3, 4, 5


class RequestType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ALLTOALL = 3
    REDUCESCATTER = 4
    JOIN = 5
    BARRIER = 6


class ResponseType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ALLTOALL = 3
    REDUCESCATTER = 4
    JOIN = 5
    BARRIER = 6
    ERROR = 7


JOIN_NAME = "__hvt_join__"
BARRIER_NAME = "__hvt_barrier__"


def dtype_code(dtype: torch.dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        from ..exceptions import HorovodTpuError

        raise HorovodTpuError(
            f"unsupported dtype {dtype} for the runtime's collectives")
    return code


def shape_string(shape) -> str:
    """``TensorShape::DebugString``: ``[2, 3]``."""
    return "[" + ", ".join(str(int(d)) for d in shape) + "]"


@dataclasses.dataclass
class Request:
    """One rank's announcement that the tensor ``name`` is locally ready."""

    rank: int = 0
    type: RequestType = RequestType.ALLREDUCE
    name: str = ""
    dtype: int = F32
    shape: Tuple[int, ...] = ()
    reduce_op: int = SUM
    prescale: float = 1.0
    postscale: float = 1.0
    root_rank: int = 0
    splits: Tuple[int, ...] = ()
    group_name: str = ""
    # Members of the explicit group (0 = ungrouped): the coordinator holds
    # the group until this many distinct members are globally ready.
    group_size: int = 0
    device: str = "cpu"

    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    def byte_size(self) -> int:
        return self.num_elements() * element_size(self.dtype)


@dataclasses.dataclass
class RequestList:
    """One rank's per-cycle delta: new requests (a join among them), cache
    bits (64-bit words over the cache's slots) and its shutdown flag."""

    requests: List[Request] = dataclasses.field(default_factory=list)
    cache_bits: List[int] = dataclasses.field(default_factory=list)
    shutdown: bool = False


@dataclasses.dataclass
class Response:
    """The coordinator's verdict: these tensors are globally ready."""

    type: ResponseType = ResponseType.ALLREDUCE
    names: List[str] = dataclasses.field(default_factory=list)
    error_message: str = ""
    dtype: int = F32
    reduce_op: int = SUM
    prescale: float = 1.0
    postscale: float = 1.0
    root_rank: int = 0
    # Allgather: per-participant dim-0 sizes; alltoall: the [n x n] split
    # matrix in rank order, rows the senders; reducescatter: dim 0.
    sizes: List[int] = dataclasses.field(default_factory=list)
    last_joined_rank: int = -1
    # Ranks taking part; empty = every rank. A strict subset once some
    # ranks joined (Join semantics, operations.cc:1166-1190).
    participants: List[int] = dataclasses.field(default_factory=list)
    # The payload's bytes and group, known to every rank (a joined rank
    # has no local entry, and still partitions fused responses alike).
    fusion_bytes: int = 0
    group_name: str = ""
    device: str = "cpu"
    # Trailing shape of the tensor (allgather, alltoall, reducescatter):
    # a joined rank sizes its share of the exchange from it.
    shape: Tuple[int, ...] = ()


@dataclasses.dataclass
class ResponseList:
    responses: List[Response] = dataclasses.field(default_factory=list)
    cache_hit_bits: List[int] = dataclasses.field(default_factory=list)
    shutdown: bool = False
    active_ranks: int = 0  # ranks not yet joined this cycle
    # Coordinator-synchronized knobs: every rank fuses with the same ones.
    fusion_threshold_bytes: int = 0
    cycle_time_us: int = 0


_ELEMENT_SIZE = {U8: 1, I8: 1, BOOL: 1, U16: 2, I16: 2, F16: 2, BF16: 2,
                 I32: 4, F32: 4, I64: 8, F64: 8}


def element_size(code: int) -> int:
    return _ELEMENT_SIZE[code]


def encode(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode(data: bytes):
    return pickle.loads(data)
