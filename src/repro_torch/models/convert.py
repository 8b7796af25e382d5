"""Carry parameters produced by the JAX package's ``init_params`` across to
the port, through numpy.

bfloat16 arrays arrive as ``ml_dtypes`` bfloat16, which torch cannot read
directly: their bits are viewed as uint16 and reinterpreted as
``torch.bfloat16``. Everything else converts as is, so an MoE router,
and an RG-LRU block's ``lam`` and gate biases (``lru_a_b``,
``lru_in_b``), float32 whatever the parameter dtype, stay float32. The tree structure
(dicts, tuples of group positions, MoE and dense groups) is kept, and
with it every leaf by name: an MLA layer's ``wq``, ``w_dkv``,
``kv_norm``, ``w_ukv`` and ``wo`` cross like any other, and so do an
enc-dec model's ``enc_groups`` and ``enc_norm`` and each decoder layer's
``cross`` and ``norm_x``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as _dev


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")     # writable, owned by torch
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        t = torch.from_numpy(a.view(np.uint8)).view(getattr(torch,
                                                            a.dtype.name))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device: _dev.DeviceLike = None) -> Any:
    """Nested dict/tuple/list of numpy arrays → the same tree of tensors."""
    dev = _dev.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return tensor_from_numpy(np.asarray(x), dev)

    return conv(tree)
