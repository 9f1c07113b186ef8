"""Topology-aware seeding for the collective-layout arm (the JAX
package's ``tune/topology.py``).

TACCL (arXiv:2111.04867) and the reference's hierarchical allreduce both
make the same argument: the right collective *shape* is a function of
the interconnect topology, not a hand-set flag. A flat ring treats every
link as equal; on a two-level fabric (ICI within a slice, DCN across
slices) the cross-level leg is ~10x slower, so reduce-locally-then-
exchange wins as soon as a meaningful fraction of ring traffic would
cross the slow boundary.

This module turns that argument into the **seed** of the autotuner's
categorical layout arm: :func:`choose_layout` picks the prior from the
mesh shape and the measured ``cross_bytes_fraction`` (``bench_scaling``
already computes it — the fraction of ring bytes that crosses the
slice boundary), and the search keeps the arm only as long as the data
agrees. ``HVDTPU_COLLECTIVE_LAYOUT=flat|hierarchical`` pins the choice
and removes the arm entirely.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..utils import env as _env

# Below this fraction of cross-boundary ring bytes a hierarchical
# schedule has nothing to save: the extra local phase costs more than
# the few slow-leg bytes it avoids. 2/world is the single-slice ring's
# own floor; 0.15 is where the two-level schedule's byte model
# (reduce-local + one shard per group over the boundary) breaks even at
# a 10x bandwidth gap.
CROSS_FRACTION_BREAKEVEN = 0.15


def mesh_levels(mesh_shape: Dict[str, int],
                cross_axes: Sequence[str] = ()) -> int:
    """How many interconnect levels the mesh spans: axes named as
    cross-level (``cross_axes``, the ``hvd.init(cross_axes=...)``
    declaration) each add a level; a single unnamed axis is one ring."""
    crosses = [a for a in cross_axes if mesh_shape.get(a, 1) > 1]
    return 1 + len(crosses)


def choose_layout(mesh_shape: Dict[str, int],
                  cross_axes: Sequence[str] = (),
                  cross_bytes_fraction: Optional[float] = None) -> str:
    """Seed for the layout arm: ``"flat"`` or ``"hierarchical"``.

    ``HVDTPU_COLLECTIVE_LAYOUT`` (when not ``auto``) wins outright.
    Otherwise: hierarchical only when the mesh actually has a second
    level AND the measured (or implied) cross-boundary traffic fraction
    clears the break-even.
    """
    pinned = _env.collective_layout()
    if pinned != "auto":
        return pinned
    if mesh_levels(mesh_shape, cross_axes) < 2:
        return "flat"
    if cross_bytes_fraction is None:
        # No measurement: a multi-level mesh's ring crosses the boundary
        # for 1/local_size of its bytes per cross step — estimate from
        # the shape the way bench_scaling derives it.
        local = 1
        for a, n in mesh_shape.items():
            if a not in cross_axes:
                local *= max(1, n)
        cross_bytes_fraction = 1.0 / max(1, local)
    return (
        "hierarchical"
        if cross_bytes_fraction >= CROSS_FRACTION_BREAKEVEN
        else "flat"
    )
