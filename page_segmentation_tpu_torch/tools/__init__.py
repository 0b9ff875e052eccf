"""tools of the PyTorch/CUDA port (mirrors tools/; run as ``python -m``)."""
