"""Wrappers for the CUDA page gather / scatter kernels
(``csrc/kv_repack.cu``) and the ``repack`` built from them.

Counterparts of ``repro.kernels.kv_repack``: ``gather_pages``,
``scatter_pages``, ``scatter_pages_overlay`` and ``repack``. The port's
kernels take a leading layer axis — pools are (L, N, *page) — so one
launch moves every layer of a pool, where the reference vmaps a
per-layer kernel.

``repack`` (paper Fig. 3) is the composition the reference writes: the
gather kernel into the destination dtype, then plain tensor ops on the
canonical buffer (flatten to ``seq_len`` rows, zero-pad to the
destination block size, re-block), then the scatter kernel. Its canonical
buffer is written once and read once between the two launches; a fused
kernel would skip that round trip and move half the bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.serving.paged_cache import _FROM_CANON, KVPageSpec

# kernel launches, by kernel name (repack counts its composed launch pair)
LAUNCHES = {"scatter_pages_overlay": 0, "gather_pages": 0,
            "scatter_pages": 0, "repack": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fns = {}


def _kernel(name: str, argtypes):
    f = _fns.get(name)
    if f is None:
        f = getattr(_build.load(), name)
        f.restype = ctypes.c_int
        f.argtypes = argtypes
        _fns[name] = f
    return f


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OVERLAY_ARGS = [_P] * 3 + [_I] * 8 + [_L] * 8 + [_I] * 6 + [_P]
_SCATTER_ARGS = [_P] * 3 + [_I] * 8 + [_L] * 7 + [_I, _P]
_LAYOUT_CODE = {"nbhd": 0, "nhbd": 1, "nhdb": 2}
_GATHER_ARGS = [_P] * 3 + [_I] * 7 + [_L] * 7 + [_I, _P]


def _check_inputs(op: str, spec: KVPageSpec, pool: torch.Tensor,
                  block_ids: torch.Tensor, other: torch.Tensor) -> None:
    for name, t in (("pool", pool), ("canon", other),
                    ("block_ids", block_ids)):
        if not t.is_cuda or t.device != pool.device:
            raise ValueError(f"{op}: {name} must be on {pool.device} (CUDA), "
                             f"got {t.device}")
    if pool.dtype not in DTYPES or other.dtype not in DTYPES:
        raise TypeError(f"{op}: pool/canon dtype {pool.dtype}/{other.dtype};"
                        " takes float32/bfloat16")
    if (block_ids.dtype != torch.int32 or not block_ids.is_contiguous()
            or block_ids.dim() != 1):
        raise TypeError(f"{op}: block_ids are a contiguous 1-D int32 tensor")
    if pool.dim() != 5 or tuple(pool.shape[2:]) != spec.page_shape():
        raise ValueError(f"{op}: pool{tuple(pool.shape)} is not (L, N, "
                         f"*{spec.page_shape()}) for {spec}")


def vector_width(cap: int, *offsets: int) -> int:
    """The largest power of two up to ``cap`` that divides every offset
    (in elements): how many elements one access of a kernel may move."""
    vec = cap
    while vec > 1 and any(o % vec for o in offsets):
        vec //= 2
    return vec


def scatter_vector_width(spec: KVPageSpec, pool: torch.Tensor,
                         canon: torch.Tensor) -> int:
    """Elements per access of ``scatter_pages``: 16 bytes of the wider of
    the two dtypes (8 bf16 or 4 f32) where every offset the kernel forms
    allows it, fewer where a base pointer or a stride does not, 1 where
    hd is not canon's unit-stride axis. The canon offsets are its base
    and the strides of its axes longer than 1 (hd last, whatever its
    rank); the pool's are its base and hd (pages are whole multiples of
    hd). nhdb pages, whose innermost axis is the token, are written one
    element at a time, so only canon counts there."""
    hd = spec.head_dim
    if hd > 1 and canon.stride(-1) != 1:
        return 1
    cap = 16 // max(pool.element_size(), canon.element_size())
    offsets = [hd, canon.data_ptr() // canon.element_size()]
    offsets += [st for n, st in zip(canon.shape[:-1], canon.stride()[:-1])
                if n > 1]
    if spec.layout != "nhdb":
        offsets.append(pool.data_ptr() // pool.element_size())
    return vector_width(cap, *offsets)


def overlay_vector_width(spec: KVPageSpec, pool: torch.Tensor,
                         canon: torch.Tensor, canon_off: int) -> int:
    """Elements per access of ``scatter_pages_overlay``: what
    ``scatter_vector_width`` allows for its canon (whole pages or the
    stream's rows alone), cut to divide ``canon_off`` too, the page
    origin's offset in canon (``-front`` rows for the stream's rows)."""
    return vector_width(scatter_vector_width(spec, pool, canon), canon_off)


CHUNK_BYTES = 16 * 1024     # pool bytes per block of the overlay (csrc)
TILE_TOKENS = 32            # nhdb token tile of the overlay (csrc TT)


def overlay_plan(spec: KVPageSpec, itemsize: int, front: int,
                 seq_len: int):
    """The overlay kernel's grid: each page is cut into chunks of ``t``
    whole tokens (about CHUNK_BYTES of pool of ``itemsize``-byte elements,
    or the TILE_TOKENS tile in nhdb), numbered page by page; the chunks
    that hold a row of ``[front, front + seq_len)`` are ``count`` in a
    row from ``first``. Returns (t, first, count)."""
    bs = spec.block_size
    if spec.layout == "nhdb":
        t = min(TILE_TOKENS, bs)
    else:
        row = spec.kv_heads * spec.head_dim * itemsize
        t = min(bs, max(1, CHUNK_BYTES // row))
    if seq_len <= 0:
        return t, 0, 0
    n_c = -(-bs // t)

    def chunk(r):
        return r // bs * n_c + r % bs // t

    first = chunk(front)
    return t, first, chunk(front + seq_len - 1) - first + 1


def overlay_chunks(spec: KVPageSpec, itemsize: int, front: int,
                   seq_len: int):
    """(page, first token, end token) of each chunk the overlay kernel
    launches, in launch order (``overlay_plan``)."""
    t, first, count = overlay_plan(spec, itemsize, front, seq_len)
    n_c = -(-spec.block_size // t)
    return [(g // n_c, g % n_c * t, min(g % n_c * t + t, spec.block_size))
            for g in range(first, first + count)]


def _page_strides(spec: KVPageSpec, pool: torch.Tensor):
    """(token, head, dim) strides of a (L, N, *page) pool's pages: page
    axis a holds canonical axis perm[a]."""
    perm = _FROM_CANON[spec.layout]
    axis = {c: a + 2 for a, c in enumerate(perm)}
    return tuple(pool.stride(axis[c]) for c in range(3))


def gather_vector_width(spec: KVPageSpec, pool: torch.Tensor,
                        out: torch.Tensor) -> int:
    """Elements per access of ``gather_pages``: 16 bytes of the wider of
    the two dtypes (8 bf16 or 4 f32) where every offset the kernel forms
    allows it, fewer where a base pointer or a stride does not. Where hd is
    the pool page's unit-stride axis the pool's offsets count (its base and
    the strides of its axes longer than 1) beside the output's (its base
    and hd: the output is contiguous); elsewhere (nhdb) the pool is read
    one element at a time along the token, so only the output counts."""
    hd = spec.head_dim
    cap = 16 // max(pool.element_size(), out.element_size())
    offsets = [hd, out.data_ptr() // out.element_size()]
    if _page_strides(spec, pool)[2] == 1:
        offsets.append(pool.data_ptr() // pool.element_size())
        offsets += [st for n, st in zip(pool.shape[:4], pool.stride()[:4])
                    if n > 1]
    return vector_width(cap, *offsets)


def gather_pages(spec: KVPageSpec, pool: torch.Tensor,
                 block_ids: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """pool: (L, N, *page) in ``spec.layout``, any strides; block_ids (nb,)
    int32. Returns new canonical pages (L, nb, bs, kv, hd) in
    ``out_dtype`` (default the pool's), contiguous. Accesses are 16 bytes
    wide where the alignments allow (``gather_vector_width``)."""
    out_dtype = out_dtype or pool.dtype
    n_layers, nb = pool.shape[0], block_ids.shape[0]
    bs, kv, hd = spec.block_size, spec.kv_heads, spec.head_dim
    out = torch.empty((n_layers, nb, bs, kv, hd), dtype=out_dtype,
                      device=pool.device)
    _check_inputs("gather_pages", spec, pool, block_ids, out)
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = _kernel("rt_gather_pages", _GATHER_ARGS)(
        out.data_ptr(), pool.data_ptr(), block_ids.data_ptr(),
        DTYPES[out_dtype], DTYPES[pool.dtype], n_layers, nb, bs, kv, hd,
        pool.stride(0), pool.stride(1), *_page_strides(spec, pool),
        out.stride(0), out.stride(1),
        gather_vector_width(spec, pool, out), stream)
    _build.check(err, "gather_pages")
    LAUNCHES["gather_pages"] += 1
    return out


def scatter_pages(spec: KVPageSpec, pool: torch.Tensor,
                  block_ids: torch.Tensor, canon: torch.Tensor
                  ) -> torch.Tensor:
    """canon: (L, nb, bs, kv, hd) float32 or bfloat16, any strides; pool
    (L, N, *page) contiguous. Writes every row of pages ``block_ids`` in
    place, cast to the pool dtype. Returns ``pool``. Accesses are 16
    bytes wide where canon's and the pool's alignment allow
    (``scatter_vector_width``), narrower otherwise."""
    n_layers, nb = canon.shape[0], block_ids.shape[0]
    _check_inputs("scatter_pages", spec, pool, block_ids, canon)
    want = (n_layers, nb, spec.block_size, spec.kv_heads, spec.head_dim)
    if not pool.is_contiguous() or pool.shape[0] != n_layers \
            or tuple(canon.shape) != want:
        raise ValueError(f"scatter_pages: pool{tuple(pool.shape)} "
                         f"canon{tuple(canon.shape)} ids{tuple(block_ids.shape)}"
                         f" do not match {spec}")
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = _kernel("rt_scatter_pages", _SCATTER_ARGS)(
        pool.data_ptr(), canon.data_ptr(), block_ids.data_ptr(),
        DTYPES[pool.dtype], DTYPES[canon.dtype], n_layers, nb,
        spec.block_size, spec.kv_heads, spec.head_dim,
        _LAYOUT_CODE[spec.layout], pool.stride(0), pool.stride(1),
        *canon.stride()[2:], canon.stride(0), canon.stride(1),
        scatter_vector_width(spec, pool, canon), stream)
    _build.check(err, "scatter_pages")
    LAUNCHES["scatter_pages"] += 1
    return pool


def repack(src: KVPageSpec, dst: KVPageSpec, src_pool: torch.Tensor,
           src_blocks: torch.Tensor, dst_pool: torch.Tensor,
           dst_blocks: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Vendor alignment (paper Fig. 3): ``seq_len`` tokens of the src
    pool's pages ``src_blocks`` (src layout, block size, dtype) into the
    dst pool's pages ``dst_blocks`` (dst's), every layer; the tail of the
    last dst page is zero. Pools (L, N, *page); the two may be one tensor
    (the gather's buffer is separate). Returns ``dst_pool``."""
    if not 0 < seq_len <= src_blocks.shape[0] * src.block_size:
        raise ValueError(f"repack: seq_len {seq_len} outside the "
                         f"{src_blocks.shape[0]} src pages of "
                         f"{src.block_size}")
    canon = gather_pages(src, src_pool, src_blocks, out_dtype=dst.tdtype)
    n_layers = canon.shape[0]
    kv, hd, bs = dst.kv_heads, dst.head_dim, dst.block_size
    flat = canon.view(n_layers, -1, kv, hd)[:, :seq_len]
    nb_d = dst.blocks_for(seq_len)
    if nb_d * bs != seq_len:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, 0, 0,
                                              nb_d * bs - seq_len))
    scatter_pages(dst, dst_pool, dst_blocks[:nb_d],
                  flat.view(n_layers, nb_d, bs, kv, hd))
    LAUNCHES["repack"] += 1
    return dst_pool


def scatter_pages_overlay(spec: KVPageSpec, pool: torch.Tensor,
                          block_ids: torch.Tensor, canon: torch.Tensor, *,
                          front: int, seq_len: int) -> torch.Tensor:
    """pool: (L, N, *page) contiguous, in ``spec.layout`` and dtype;
    block_ids: (nb,) int32; canon float32 or bfloat16, any strides, either
    whole pages (L, nb, bs, kv, hd) whose flat rows ``[front, front +
    seq_len)`` hold the stream, or the stream's rows alone (L, seq_len, kv,
    hd), landing at flat row ``front``. Writes those rows into the pool
    pages in place, cast to the pool dtype; every other row keeps its
    contents. Returns ``pool``."""
    n_layers, nb, bs = canon.shape[0], block_ids.shape[0], spec.block_size
    _check_inputs("scatter_pages_overlay", spec, pool, block_ids, canon)
    rows = (spec.kv_heads, spec.head_dim)
    stream_rows = canon.dim() == 4       # row r of canon is flat row front+r
    want = (seq_len,) + rows if stream_rows else (nb, bs) + rows
    if (not pool.is_contiguous() or pool.shape[0] != n_layers
            or tuple(canon.shape[1:]) != want):
        raise ValueError(f"scatter_pages_overlay: pool{tuple(pool.shape)} "
                         f"canon{tuple(canon.shape)} ids{tuple(block_ids.shape)}"
                         f" front={front} seq_len={seq_len} do not match "
                         f"{spec}")
    if not (0 <= front and front + seq_len <= nb * bs):
        raise ValueError(f"scatter_pages_overlay: rows [{front}, "
                         f"{front + seq_len}) outside {nb} pages of {bs}")
    if stream_rows:
        c_st, c_sh, c_sd = canon.stride()[1:]
        page_stride, canon_off = bs * c_st, -front * c_st
    else:
        c_st, c_sh, c_sd = canon.stride()[2:]
        page_stride, canon_off = canon.stride(1), 0
    t, first, count = overlay_plan(spec, pool.element_size(), front, seq_len)
    if count == 0:
        return pool
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = _kernel("rt_scatter_pages_overlay", _OVERLAY_ARGS)(
        pool.data_ptr(), canon.data_ptr(), block_ids.data_ptr(),
        DTYPES[pool.dtype], DTYPES[canon.dtype], n_layers, nb, bs,
        spec.kv_heads, spec.head_dim, _LAYOUT_CODE[spec.layout],
        pool.stride(0), pool.stride(1), c_st, c_sh, c_sd, canon.stride(0),
        page_stride, canon_off, int(front), int(seq_len), t, first, count,
        overlay_vector_width(spec, pool, canon, canon_off), stream)
    _build.check(err, "scatter_pages_overlay")
    LAUNCHES["scatter_pages_overlay"] += 1
    return pool
