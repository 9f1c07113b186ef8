"""Observability of the port: so far the analytic FLOP model
(:mod:`.flops`)."""
