"""Metrics log and profiler context (the JAX package's utils/, without its
JAX compile cache)."""

from .metrics import MetricsLogger, profiled

__all__ = ["MetricsLogger", "profiled"]
