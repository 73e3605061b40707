"""Kernels of the port: each wrapper launches its hand-written Hopper
kernel on CUDA tensors and computes its plain PyTorch version on CPU
tensors. Sources live in ``../csrc`` and build lazily (``_build``)."""
