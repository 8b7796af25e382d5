"""PyTorch/CUDA port of the disaggregated prefill/decode serving system.

The package mirrors the JAX package ``repro`` module for module
(``configs/``, ``kernels/``, ``models/``, ``core/``, ``serving/``) and is
held against it by the ``tests/test_torch_*.py`` suite. It imports
``torch`` and never ``jax``. Its entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a CUDA tensor every attention and
re-page step launches a hand-written kernel from ``kernels/csrc/``.
"""
