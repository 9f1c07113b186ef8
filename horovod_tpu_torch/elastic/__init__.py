"""Elastic scaling policy of the serving pool."""

from .scale import QueueDepthPolicy  # noqa: F401
