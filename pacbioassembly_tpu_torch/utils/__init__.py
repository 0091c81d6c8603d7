"""Metrics log, spans and profiler context (the JAX package's utils/,
without its JAX compile cache)."""

from .metrics import MetricsLogger, profiled, recording, span

__all__ = ["MetricsLogger", "profiled", "recording", "span"]
