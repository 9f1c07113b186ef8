"""Host parsing and slot assignment.

The port of the JAX package's ``runner/hosts.py``. Parity:
``horovod/runner/common/util/hosts.py`` -- ``parse_hosts`` (``:54``) and
``get_host_assignments`` (``:100``), which turn ``host1:4,host2:4`` into
per-process ``SlotInfo(rank, local_rank, cross_rank, size, local_size,
cross_size)``.

A slot is one card and one process (the port drives one card a process);
rank numbering is host-major exactly like the reference, so ``local`` is
the intra-host axis and ``cross`` the inter-host one. Without ``-H`` or a
hostfile, :func:`discover_local_hosts` counts this machine's cards.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(spec: str) -> "HostInfo":
        spec = spec.strip()
        if ":" in spec:
            host, slots = spec.rsplit(":", 1)
            return HostInfo(host, int(slots))
        return HostInfo(spec, 1)


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_response_string(self) -> str:
        return ":".join(
            str(x)
            for x in (
                self.rank, self.local_rank, self.cross_rank,
                self.size, self.local_size, self.cross_size,
            )
        )


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """``"a:4,b:4"`` → HostInfo list (reference ``hosts.py:54``)."""
    return [HostInfo.from_string(s) for s in hosts_string.split(",") if s.strip()]


def get_host_assignments(
    hosts: List[HostInfo], min_np: int, max_np: Optional[int] = None
) -> List[SlotInfo]:
    """Assign global/local/cross ranks host-major.

    Mirrors the reference's assignment semantics (``hosts.py:100``):
    ranks are dense host-by-host; ``cross_rank`` is the host index among
    hosts that own the same local slot; raises when fewer than ``min_np``
    total slots exist; caps at ``max_np`` when given.
    """
    total = sum(h.slots for h in hosts)
    if total < min_np:
        raise ValueError(
            f"requested at least {min_np} processes but hosts provide {total}"
        )
    np_ = min(total, max_np) if max_np else total

    assignments: List[SlotInfo] = []
    rank = 0
    for h in hosts:
        for local_rank in range(h.slots):
            if rank >= np_:
                break
            assignments.append(
                SlotInfo(
                    hostname=h.hostname,
                    rank=rank,
                    local_rank=local_rank,
                    cross_rank=0,  # filled below
                    size=np_,
                    local_size=min(h.slots, np_ - (rank - local_rank)),
                    cross_size=0,  # filled below
                )
            )
            rank += 1

    # cross rank/size: computed among the hosts that actually own this
    # local slot index (reference hosts.py:127-142) — with heterogeneous
    # slot counts the absolute host index would exceed cross_size.
    by_local: dict = {}
    for slot in assignments:
        by_local.setdefault(slot.local_rank, []).append(slot)
    for slots_for_local in by_local.values():
        for i, slot in enumerate(slots_for_local):
            slot.cross_rank = i
            slot.cross_size = len(slots_for_local)
    return assignments


def discover_local_hosts() -> List[HostInfo]:
    """This machine as the one host, one slot per visible card
    (``torch.cuda.device_count()``). Raises without a card: the JAX
    package reads a TPU pod slice's hosts from its environment, and the
    port has no such source -- name the hosts with ``-H`` or
    ``--hostfile`` (a CPU world passes ``-H localhost:N``)."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 1:
        raise RuntimeError(
            "no card visible to discover slots from; pass -H host:slots "
            "or --hostfile"
        )
    return [HostInfo("localhost", n)]
