"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers, and
their plain PyTorch versions (``ref``). ``ops`` is the dispatch seam."""
