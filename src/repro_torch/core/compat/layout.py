"""VRAM-management alignment component (paper §III-B-2, Fig. 3) — PyTorch
port of ``repro.core.compat.layout``.

Different vendors page their KV with different block sizes and tensor
layouts. The paper's general method: convert to a one-dimensional tensor
before transmission (erasing layout), then re-materialize in the target
instance's layout after transmission.

``extract_canonical`` / ``materialize`` do exactly that against the paged
pools of ``repro_torch.serving.paged_cache``; ``convert`` is the pure
layout x block size x dtype bridge (the Fig. 3 conversion). The pages move
through the gather and scatter kernels on the card and through their
plain versions on the CPU (``kernels.ops``); the results are bit-identical
to the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.serving.paged_cache import (KVPageSpec, gather_sequence,
                                             init_pool, scatter_sequence)


def extract_canonical(spec: KVPageSpec, pool: torch.Tensor,
                      block_ids: torch.Tensor, seq_len: int) -> torch.Tensor:
    """P-side: pages → canonical 1-D wire tensor (the paper's flatten step).

    Returns (seq_len * kv * hd,) flat rows (layout fully erased)."""
    return gather_sequence(spec, pool, block_ids, seq_len).reshape(-1)


def materialize(spec: KVPageSpec, pool: torch.Tensor,
                block_ids: torch.Tensor, flat: torch.Tensor,
                seq_len: int) -> torch.Tensor:
    """D-side: canonical 1-D wire tensor → pages in the D instance's layout
    (in place, returns ``pool``)."""
    kv = flat.reshape(seq_len, spec.kv_heads, spec.head_dim)
    return scatter_sequence(spec, pool, block_ids, kv)


def convert(src: KVPageSpec, dst: KVPageSpec, src_pages: torch.Tensor,
            seq_len: int) -> torch.Tensor:
    """Pure conversion: src-layout pages of one sequence → new dst-layout
    pages.

    src_pages: (nb_src, *src.page_shape()). Returns (nb_dst,
    *dst.page_shape()). Head geometry must match (same kv_heads x
    head_dim); block size, axis layout and dtype may differ — this is the
    Fig. 3 conversion."""
    assert src.kv_heads == dst.kv_heads and src.head_dim == dst.head_dim, \
        "head geometry mismatch is handled by parallel_align, not layout"
    dev = src_pages.device
    ids = torch.arange(src_pages.shape[0], dtype=torch.int32, device=dev)
    canon = ops.gather_pages(src, src_pages[None], ids, out_dtype=dst.tdtype)
    flat = canon.reshape(-1, src.kv_heads, src.head_dim)[:seq_len]
    nb_dst = dst.blocks_for(seq_len)
    out = init_pool(dst, nb_dst, device=dev)
    return materialize(dst, out, torch.arange(nb_dst, dtype=torch.int32,
                                              device=dev),
                       flat.reshape(-1), seq_len)


def transfer_shapes(src: KVPageSpec, dst: KVPageSpec,
                    seq_len: int) -> Tuple[int, int, int]:
    """(flat_elements, src_blocks, dst_blocks) for planning/accounting."""
    flat = seq_len * src.kv_heads * src.head_dim
    return flat, src.blocks_for(seq_len), dst.blocks_for(seq_len)
