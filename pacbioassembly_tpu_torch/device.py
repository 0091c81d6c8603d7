"""Explicit device resolution.

The engine runs where it is told to. Asking for a CUDA device on a machine
without one raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(spec: str | torch.device) -> torch.device:
    """`cuda`, `cuda:N` or `cpu` -> torch.device, checked against the
    machine."""
    dev = torch.device(spec)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r} (use cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False"
        )
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(dev)!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) exist"
        )
    return torch.device("cuda", index)
