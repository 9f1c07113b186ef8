"""Helpers shared by the port: environment knobs and retry/backoff."""
