"""Overlap accounting: exposed against total communication time.

The port of the JAX package's ``obs/overlap.py``: an overlap-on/off pair of
step times (``chip_smoke.py``'s ``[train-overlap]`` makes one) becomes

* ``total_comm_ms`` -- what the step's collectives cost on the wire, from
  the ring model over the gradient bytes (``2 (n - 1) / n`` of them cross
  the slowest link), unless measured and given;
* ``exposed_comm_ms`` -- the part of it still on the critical path with
  overlap on: ``step_on - compute``, where ``compute = step_off -
  total_comm`` (the overlap-off step is the serial baseline);
* ``overlap_efficiency`` -- ``1 - exposed / total``, clamped to [0, 1].

The reference's table of TPU interconnect rates is replaced by the H100's
NVLink: 900 GB/s a card, both directions together (NVIDIA H100 Tensor Core
GPU datasheet, SXM form factor) -- the rate one bidirectional ring sees,
as the reference's per-link one-way rate times its two ring links is. A
card the table does not know gives None, and so does everything derived
from it: no efficiency is made up from an unknown denominator. One rank
moves nothing: 0 ms on the wire, and the efficiency is None as well.

:func:`record_overlap_pair` returns the accounting as a dict and, with
the metrics plane on, sets the ``overlap.*`` gauges as the reference does.
"""

from __future__ import annotations

from typing import Optional

from . import registry as _obs

__all__ = ["NVLINK_GBPS", "record_overlap_pair", "ring_allreduce_ms",
           "ring_gbps"]

# Ring bandwidth a card sees, GB/s (both directions together), by a
# substring of its device name.
NVLINK_GBPS = {
    "h100": 900.0,  # NVLink 4, H100 SXM datasheet
}


def _device_name(device) -> str:
    if device is None:
        import torch

        if not torch.cuda.is_available():
            return ""
        return torch.cuda.get_device_name()
    if isinstance(device, str) and device not in ("cpu", "cuda"):
        return device
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


def ring_gbps(device=None) -> Optional[float]:
    """The ring bandwidth of ``device`` (a ``torch.device``, ``"cpu"``,
    ``"cuda[:i]"`` or a device name; default the current card), or None
    when unknown."""
    name = _device_name(device).lower()
    for key, gbps in NVLINK_GBPS.items():
        if key in name:
            return gbps
    return None


def ring_allreduce_ms(wire_bytes: int, n_chips: int,
                      device=None) -> Optional[float]:
    """Ring-allreduce time for ``wire_bytes`` of gradients over ``n_chips``
    cards: the slowest link moves ``2 (n - 1) / n`` of the bytes. 0 at one
    card (nothing on the wire); None when the card is unknown."""
    if n_chips < 2:
        return 0.0
    bw = ring_gbps(device)
    if bw is None:
        return None
    return (2 * (n_chips - 1) / n_chips) * wire_bytes / (bw * 1e9) * 1e3


def record_overlap_pair(
    step_ms_on: float,
    step_ms_off: float,
    *,
    comm_ms_total: Optional[float] = None,
    wire_bytes: Optional[int] = None,
    n_chips: Optional[int] = None,
    device=None,
) -> dict:
    """Fold an overlap-on/off step-time pair into the overlap accounting.
    ``comm_ms_total`` is a measured total, or None to take it from the
    ring model over ``wire_bytes`` and ``n_chips``. None fields where the
    model has no answer; the gauges are set only with the metrics plane
    on, the values returned either way."""
    if comm_ms_total is None and wire_bytes is not None and n_chips:
        comm_ms_total = ring_allreduce_ms(wire_bytes, n_chips, device)
    exposed = efficiency = None
    if comm_ms_total is not None and comm_ms_total > 0:
        compute_ms = max(step_ms_off - comm_ms_total, 0.0)
        exposed = min(max(step_ms_on - compute_ms, 0.0), comm_ms_total)
        efficiency = min(max(1.0 - exposed / comm_ms_total, 0.0), 1.0)
    speedup = step_ms_off / step_ms_on if step_ms_on > 0 else None
    if _obs.enabled():
        reg = _obs.metrics()
        reg.gauge("overlap.step_ms_on").set(step_ms_on)
        reg.gauge("overlap.step_ms_off").set(step_ms_off)
        if speedup is not None:
            reg.gauge("overlap.speedup").set(speedup)
        if comm_ms_total is not None:
            reg.gauge("overlap.total_comm_ms").set(comm_ms_total)
        if exposed is not None:
            reg.gauge("overlap.exposed_comm_ms").set(exposed)
        if efficiency is not None:
            reg.gauge("overlap.efficiency").set(efficiency)
    return {
        "step_ms_overlap_on": step_ms_on,
        "step_ms_overlap_off": step_ms_off,
        "speedup": speedup,
        "total_comm_ms": comm_ms_total,
        "exposed_comm_ms": exposed,
        "overlap_efficiency": efficiency,
    }
