"""Batch assembly engine on PyTorch (device gather + round loop)."""
