"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the wrapper that launches its kernel on CUDA tensors, the
plain PyTorch version that serves CPU tensors and the comparisons, and a
``launches`` counter. ``_lib`` builds and loads ``supernet_tpu_torch/csrc``.
"""
