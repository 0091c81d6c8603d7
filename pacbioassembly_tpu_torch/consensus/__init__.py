"""Vote merge on PyTorch."""
