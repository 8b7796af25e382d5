"""The port's kernels' plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode) and oracles. The CUDA kernels themselves
are held against these plain versions in tests/test_torch_cuda.py.

Tolerances are those of tests/test_kernels.py: 2e-5 in float32 and 2e-2 in
bfloat16 (the two sides sum in different orders). The re-page must be
bit-identical."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import kv_repack as jkr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.serving import paged_cache as JPC
from repro_torch.kernels import ops, ref
from repro_torch.serving.paged_cache import KVPageSpec, pages_from_canonical

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

FLASH_SHAPES = [
    (1, 4, 4, 16, 16, 32),       # MHA, square
    (2, 8, 2, 24, 48, 64),       # GQA, rectangular, non-multiple of block
    (1, 4, 1, 7, 133, 32),       # MQA, ragged
]
PAGED_SHAPES = [(2, 4, 4, 32, 8, 4), (3, 8, 2, 64, 16, 3), (1, 4, 1, 32, 4, 7)]
LAYOUTS = ["nbhd", "nhbd", "nhdb"]


def _np(x):
    return np.asarray(x, np.float32)



def _pair(a: np.ndarray, dtype: str, device="cpu"):
    """The same values as a JAX array and a torch tensor (same bf16 cast)."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]).to(device))


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 9), (False, 0)])
def test_flash_ref_matches_pallas(b, h, kv, sq, skv, d, dtype, causal, window):
    if not causal and sq != skv:
        pytest.skip("non-causal used for encoder (square) only")
    rng = np.random.default_rng(b * 100 + sq)
    qa, ka, va = (rng.standard_normal(s).astype(np.float32) for s in
                  ((b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d)))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qa, ka, va))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=16, block_k=16, force_interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(_np(got.float()), _np(pallas), atol=ATOL[dtype])
    np.testing.assert_allclose(_np(got.float()), _np(oracle), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_offset,sq,skv,window", [(5, 7, 16, 0),
                                                    (24, 9, 40, 0),
                                                    (20, 12, 32, 6)])
def test_flash_q_offset_matches_causal_mask_sdpa(q_offset, sq, skv, window,
                                                 dtype):
    """A chunk at absolute offset c0 against a cache: the reference's
    causal_mask(q_offset) + sdpa, which is what the chunked prefill runs."""
    b, h, kv, d = 1, 4, 2, 16
    rng = np.random.default_rng(q_offset)
    qa = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    ka = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    va = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qa, ka, va))
    mask = JL.causal_mask(sq, skv, q_offset, window)
    want = JL.sdpa(jq, jk, jv, mask)                          # (B,Sq,H,d)
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=True, window=window,
                              q_offset=q_offset, kv_len=skv).transpose(1, 2)
    np.testing.assert_allclose(_np(got.float()), _np(want), atol=ATOL[dtype])


# --------------------------------------------------------------------------- #
# paged attention
# --------------------------------------------------------------------------- #
def _paged_inputs(b, h, kv, d, bs, pages, seed=0):
    n_blocks = b * pages + 1
    rng = np.random.default_rng(seed + b * 10 + h)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((n_blocks, bs, kv, d)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, kv, d)).astype(np.float32)
    table = (rng.permutation(n_blocks - 1)[:b * pages].reshape(b, pages)
             + 1).astype(np.int32)
    lens = rng.integers(1, bs * pages + 1, b).astype(np.int32)
    return q, k, v, table, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,d,bs,pages", PAGED_SHAPES)
@pytest.mark.parametrize("window", [0, 11])
def test_paged_ref_matches_pallas(b, h, kv, d, bs, pages, dtype, window):
    q, k, v, table, lens = _paged_inputs(b, h, kv, d, bs, pages)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    got = ref.paged_attention_ref(tq, tk, tv, torch.from_numpy(table),
                                  torch.from_numpy(lens), layout="nbhd",
                                  window=window)
    pallas = jops.paged_attention(jq, jk, jv, jnp.asarray(table),
                                  jnp.asarray(lens), window=window,
                                  force_interpret=True)
    oracle = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(table),
                                      jnp.asarray(lens), window=window)
    np.testing.assert_allclose(_np(got.float()), _np(pallas), atol=ATOL[dtype])
    np.testing.assert_allclose(_np(got.float()), _np(oracle), atol=ATOL[dtype])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("window", [0, 11])
def test_paged_ref_every_layout_matches_serving_ref(layout, window):
    """Pools in each vendor layout against the reference's serving-path
    paged_cache.paged_attention_ref on the same pools."""
    b, h, kv, d, bs, pages = 3, 8, 2, 16, 8, 3
    q, k, v, table, lens = _paged_inputs(b, h, kv, d, bs, pages, seed=7)
    spec = KVPageSpec(bs, layout, "float32", kv, d)
    jspec = JPC.KVPageSpec(bs, layout, "float32", kv, d)
    kl = pages_from_canonical(spec, torch.from_numpy(k)).contiguous()
    vl = pages_from_canonical(spec, torch.from_numpy(v)).contiguous()
    got = ref.paged_attention_ref(torch.from_numpy(q), kl, vl,
                                  torch.from_numpy(table),
                                  torch.from_numpy(lens), layout=layout,
                                  window=window)
    want = JPC.paged_attention_ref(jnp.asarray(q)[:, None], jnp.asarray(
        kl.numpy()), jnp.asarray(vl.numpy()), jnp.asarray(table),
        jnp.asarray(lens), jspec, window=window)[:, 0]
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


# --------------------------------------------------------------------------- #
# overlay re-page: bit-identical
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("front,seq_len", [(0, 19), (3, 13)])
def test_overlay_ref_bit_identical_to_pallas(layout, dtype, front, seq_len):
    bs, kv, hd, n_blocks, layers = 8, 2, 16, 9, 2
    spec = KVPageSpec(bs, layout, dtype, kv, hd)
    jspec = JPC.KVPageSpec(bs, layout, dtype, kv, hd)
    nb = -(-(front + seq_len) // bs)
    rng = np.random.default_rng(nb + front)
    pool = rng.standard_normal((layers,) + spec.pool_shape(n_blocks)).astype(
        np.float32)
    canon = rng.standard_normal((layers, nb, bs, kv, hd)).astype(np.float32)
    ids = np.asarray([5, 2, 7][:nb], np.int32)
    jpool, tpool = _pair(pool, dtype)
    jcanon, tcanon = _pair(canon, dtype)
    ops.scatter_pages_overlay(spec, tpool, torch.from_numpy(ids), tcanon,
                              front=front, seq_len=seq_len)
    for li in range(layers):
        want = jkr.scatter_pages_overlay(jspec, jpool[li], jnp.asarray(ids),
                                         jcanon[li], front, seq_len,
                                         interpret=True)
        got = tpool[li]
        if dtype == "bfloat16":
            assert np.array_equal(got.view(torch.uint16).numpy(),
                                  np.asarray(want).view(np.uint16))
        else:
            assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,canon_dt", [("float32", "float32"),
                                              ("bfloat16", "bfloat16"),
                                              ("bfloat16", "float32")])
@pytest.mark.parametrize("front,seq_len", [(0, 19), (3, 13), (5, 2)])
def test_overlay_ref_stream_rows_bit_identical_to_pallas(
        layout, pool_dt, canon_dt, front, seq_len):
    """The stream's rows alone (L, seq_len, kv, hd), as the streamed
    re-page hands them over, against the Pallas kernel fed zero-padded
    whole pages."""
    bs, kv, hd, n_blocks, layers = 8, 2, 16, 9, 2
    spec = KVPageSpec(bs, layout, pool_dt, kv, hd)
    jspec = JPC.KVPageSpec(bs, layout, pool_dt, kv, hd)
    nb = -(-(front + seq_len) // bs)
    rng = np.random.default_rng(7 * nb + front)
    pool = rng.standard_normal((layers,) + spec.pool_shape(n_blocks)).astype(
        np.float32)
    rows = rng.standard_normal((layers, seq_len, kv, hd)).astype(np.float32)
    padded = np.zeros((layers, nb * bs, kv, hd), np.float32)
    padded[:, front:front + seq_len] = rows
    ids = np.asarray([5, 2, 7][:nb], np.int32)
    jpool, tpool = _pair(pool, pool_dt)
    jpages, _ = _pair(padded.reshape(layers, nb, bs, kv, hd), canon_dt)
    _, trows = _pair(rows, canon_dt)
    ops.scatter_pages_overlay(spec, tpool, torch.from_numpy(ids), trows,
                              front=front, seq_len=seq_len)
    for li in range(layers):
        want = jkr.scatter_pages_overlay(jspec, jpool[li], jnp.asarray(ids),
                                         jpages[li], front, seq_len,
                                         interpret=True)
        assert np.array_equal(tpool[li].float().numpy(), _np(want))


def test_overlay_ref_casts_like_the_reference():
    """float32 canon into a bfloat16 pool: the in-kernel cast rounds as
    the reference's astype does."""
    spec = KVPageSpec(4, "nhdb", "bfloat16", 2, 8)
    jspec = JPC.KVPageSpec(4, "nhdb", "bfloat16", 2, 8)
    rng = np.random.default_rng(3)
    pool = np.zeros((1,) + spec.pool_shape(5), np.float32)
    canon = rng.standard_normal((1, 2, 4, 2, 8)).astype(np.float32)
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    ops.scatter_pages_overlay(spec, tpool, torch.tensor([3, 1], dtype=torch.int32),
                              torch.from_numpy(canon), front=1, seq_len=6)
    want = jkr.scatter_pages_overlay(
        jspec, jnp.asarray(pool[0]).astype(jnp.bfloat16),
        jnp.asarray([3, 1], jnp.int32), jnp.asarray(canon[0]), 1, 6,
        interpret=True)
    assert np.array_equal(tpool[0].view(torch.uint16).numpy(),
                          np.asarray(want).view(np.uint16))


# --------------------------------------------------------------------------- #
# gather / scatter / repack: bit-identical, layer by layer
# --------------------------------------------------------------------------- #
def _bits_equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        return np.array_equal(got.view(torch.uint16).numpy(),
                              want.view(np.uint16))
    return np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_scatter_refs_bit_identical_to_pallas(layout, dtype):
    """tests/test_kernels.py's sweep (block 8, 4 KV heads, head dim 16,
    ids [3, 1, 7] of 10 pages) with a leading axis of 3 layers: each layer
    of the port's plain versions against the Pallas kernels in interpret
    mode and against the JAX oracles."""
    layers = 3
    spec = KVPageSpec(8, layout, dtype, 4, 16)
    jspec = JPC.KVPageSpec(8, layout, dtype, 4, 16)
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((layers,) + spec.pool_shape(10)).astype(
        np.float32)
    canon = rng.standard_normal((layers, 3, 8, 4, 16)).astype(np.float32)
    ids = np.asarray([3, 1, 7], np.int32)
    jpool, tpool = _pair(pool, dtype)
    tpool = tpool.clone()        # scattered in place; jpool may share `pool`
    jcanon, tcanon = _pair(canon, dtype)
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)
    got = ops.gather_pages(spec, tpool, tids)
    assert got.shape == (layers, 3, 8, 4, 16) and got.is_contiguous()
    got_f32 = ops.gather_pages(spec, tpool, tids, out_dtype=torch.float32)
    ops.scatter_pages(spec, tpool, tids, tcanon)
    for li in range(layers):
        for want in (jops.gather_pages(jspec, jpool[li], jids,
                                       force_interpret=True),
                     jref.gather_pages_ref(jspec, jpool[li], jids)):
            assert _bits_equal(got[li], want)
        assert _bits_equal(got_f32[li], jkr.gather_pages(
            jspec, jpool[li], jids, out_dtype=jnp.float32, interpret=True))
        for want in (jops.scatter_pages(jspec, jpool[li], jids, jcanon[li],
                                        force_interpret=True),
                     jref.scatter_pages_ref(jspec, jpool[li], jids,
                                            jcanon[li])):
            assert _bits_equal(tpool[li], want)


@pytest.mark.parametrize("src_layout,dst_layout,src_bs,dst_bs,src_dt,dst_dt", [
    ("nbhd", "nhbd", 8, 4, "float32", "float32"),
    ("nhdb", "nbhd", 4, 16, "float32", "bfloat16"),
    ("nhbd", "nhdb", 16, 8, "bfloat16", "float32"),
])
def test_repack_ref_bit_identical_to_pallas(src_layout, dst_layout, src_bs,
                                            dst_bs, src_dt, dst_dt):
    """tests/test_kernels.py's Fig. 3 sweep (27 tokens, 2 KV heads, head
    dim 16) with 2 layers, held layer by layer against the Pallas repack
    in interpret mode and the JAX oracle; the dst pool starts non-zero so
    the zero tail of the last page shows."""
    layers, kv, hd, seq = 2, 2, 16, 27
    src = KVPageSpec(src_bs, src_layout, src_dt, kv, hd)
    dst = KVPageSpec(dst_bs, dst_layout, dst_dt, kv, hd)
    jsrc = JPC.KVPageSpec(src_bs, src_layout, src_dt, kv, hd)
    jdst = JPC.KVPageSpec(dst_bs, dst_layout, dst_dt, kv, hd)
    nb_s, nb_d = src.blocks_for(seq), dst.blocks_for(seq)
    rng = np.random.default_rng(src_bs + dst_bs)
    src_pool = rng.standard_normal((layers,) + src.pool_shape(nb_s + 2)
                                   ).astype(np.float32)
    dst_pool = rng.standard_normal((layers,) + dst.pool_shape(nb_d + 2)
                                   ).astype(np.float32)
    src_blocks = np.arange(nb_s, 0, -1, dtype=np.int32)     # not sorted
    dst_blocks = np.concatenate([[nb_d + 1], np.arange(1, nb_d)]).astype(
        np.int32)
    jsp, tsp = _pair(src_pool, src_dt)
    jdp, tdp = _pair(dst_pool, dst_dt)
    tdp = tdp.clone()            # repacked in place; jdp may share dst_pool
    ops.repack(src, dst, tsp, torch.from_numpy(src_blocks), tdp,
               torch.from_numpy(dst_blocks), seq)
    for li in range(layers):
        args = (jsp[li], jnp.asarray(src_blocks), jdp[li],
                jnp.asarray(dst_blocks), seq)
        assert _bits_equal(tdp[li], jops.repack(jsrc, jdst, *args,
                                                force_interpret=True))
        assert _bits_equal(tdp[li], jref.repack_ref(jsrc, jdst, *args))


def test_cpu_calls_count_no_launch():
    """Launches are counted per kernel name, and only where a kernel
    launches: every op on CPU tensors leaves every count at 0."""
    ops.reset_launch_counts()
    spec = KVPageSpec(4, "nhbd", "float32", 2, 8)
    pool = torch.randn((2,) + spec.pool_shape(6))
    ids = torch.tensor([4, 1], dtype=torch.int32)
    canon = ops.gather_pages(spec, pool, ids)
    ops.scatter_pages(spec, pool, ids, canon)
    ops.repack(spec, spec, pool, ids[:1], pool, ids[1:], 4)
    ops.scatter_pages_overlay(spec, pool, ids, canon, front=1, seq_len=5)
    q = torch.randn(1, 2, 8, 8)
    ops.flash_attention(q, q[:, :1], q[:, :1])
    ops.paged_attention(torch.randn(1, 2, 8), pool[0], pool[1],
                        ids[None], torch.tensor([5], dtype=torch.int32),
                        layout="nhbd")
    ops.cache_attention(q.transpose(1, 2), q[:, :1].transpose(1, 2),
                        q[:, :1].transpose(1, 2),
                        torch.arange(8, dtype=torch.int32)[None],
                        q_offset=7, window=4)
    acc, ml = ops.cache_attention_partial(
        q.transpose(1, 2), q[:, :1].transpose(1, 2), q[:, :1].transpose(1, 2),
        torch.arange(8, dtype=torch.int32)[None], q_offset=7)
    ops.cache_attention_combine(acc, ml, torch.float32)
    assert ops.launch_counts() == {
        "flash_attention": 0, "flash_decode": 0, "flash_decode_partial": 0,
        "decode_combine": 0, "paged_attention": 0,
        "scatter_pages_overlay": 0, "gather_pages": 0, "scatter_pages": 0,
        "repack": 0}


# --------------------------------------------------------------------------- #
# launch plans of the card kernels (their Python side)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sq,kv_len,causal,window,q_offset,block", [
    (500, 2000, True, 0, 1500, 128),     # the main path's chunk
    (2048, 2048, True, 0, 0, 128),       # a monolithic prefill
    (260, 260, True, 100, 0, 128),       # a window across key tiles
    (130, 250, True, 70, 200, 128),      # rows past kv_len see no key
    (7, 133, True, 9, 0, 4),
    (37, 61, True, 0, 11, 8),
    (37, 61, False, 0, 0, 8),
    (37, 61, False, 5, 3, 8),
    (64, 20, True, 4, 40, 8),            # window entirely past kv_len
    (16, 40, True, 1, 0, 4),
    (33, 0, True, 0, 0, 8),              # no key at all
    (100, 300, True, 0, 200, 16),
    (500, 8192, True, 2048, 7692, 64),   # RecurrentGemma's last chunk
])
def test_flash_tile_plan_covers_exactly_the_visible_pairs(
        sq, kv_len, causal, window, q_offset, block):
    """The key tiles each query tile visits (the bf16 kernel's plan) hold
    every visible (query, key) pair of the tile's rows, and every tile
    visited holds one: brute force over the masks. Query tiles go
    heaviest first."""
    from repro_torch.kernels.flash_attention import tile_plan
    pos = np.arange(sq)[:, None] + q_offset
    key = np.arange(kv_len)[None, :]
    ok = np.broadcast_to(key < kv_len, (sq, kv_len))
    if causal:
        ok = ok & (key <= pos)
    if window > 0:
        ok = ok & (pos - key < window)
    plan = tile_plan(sq, kv_len, causal=causal, window=window,
                     q_offset=q_offset, block_m=block, block_n=block)
    n_q = -(-sq // block)
    assert [qt for qt, _ in plan] == list(reversed(range(n_q)))
    for qt, tiles in plan:
        rows = ok[qt * block:(qt + 1) * block]
        want = [t for t in range(-(-kv_len // block))
                if rows[:, t * block:(t + 1) * block].any()]
        assert list(tiles) == want, (qt, tiles, want)


@pytest.mark.parametrize("cap,offsets,want", [
    (8, (128, 4096, 0), 8), (8, (128, 3), 1), (8, (12, 64), 4),
    (4, (6, 8), 2), (4, (128, 256), 4), (8, (), 8)])
def test_vector_width_is_the_largest_that_divides(cap, offsets, want):
    """The widest access (a power of two up to cap) that every offset the
    kernel forms allows."""
    from repro_torch.kernels.kv_repack import vector_width
    got = vector_width(cap, *offsets)
    assert got == want
    assert all(o % got == 0 for o in offsets)
    wider = 2 * got
    assert wider > cap or any(o % wider for o in offsets)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,canon_dt,cap", [
    ("bfloat16", "bfloat16", 8), ("float32", "float32", 4),
    ("bfloat16", "float32", 4), ("float32", "bfloat16", 4)])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_scatter_vector_width_from_the_alignments(layout, pool_dt, canon_dt,
                                                  cap, offset):
    """scatter_pages' width from canon's base pointer and strides: a canon
    sliced at an element offset inside a wider buffer gets the largest
    width that divides the offset (16 bytes of the wider dtype at 0), a
    canon whose hd is not the unit-stride axis gets 1."""
    from repro_torch.kernels.kv_repack import scatter_vector_width
    spec = KVPageSpec(16, layout, pool_dt, 2, 32)
    pool = torch.zeros((3,) + spec.pool_shape(5), dtype=TDT[pool_dt])
    wide = torch.zeros((3, 2, 16, 2, 40), dtype=TDT[canon_dt])
    canon = wide[..., offset:offset + 32]
    want = min(cap, offset) if offset else cap
    assert scatter_vector_width(spec, pool, canon) == want
    assert scatter_vector_width(spec, pool, canon.transpose(3, 4)
                                .contiguous().transpose(3, 4)) == 1


def _low_bit(x: int, cap: int) -> int:
    """The largest power of two that divides x (cap for 0)."""
    return x & -x if x else cap


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,canon_dt,cap", [
    ("bfloat16", "bfloat16", 8), ("float32", "float32", 4),
    ("bfloat16", "float32", 4), ("float32", "bfloat16", 4)])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("stream_rows", [False, True])
def test_overlay_vector_width_from_the_alignments(layout, pool_dt, canon_dt,
                                                  cap, offset, stream_rows):
    """scatter_pages_overlay's width, for canon as whole pages or as the
    stream's rows alone: a canon sliced at an element offset inside a wider
    buffer gets the largest width that divides the offset (16 bytes of the
    wider dtype at 0); ``canon_off`` (-front rows) caps it the same way; a
    canon whose hd is not the unit-stride axis gets 1; a pool whose base
    is one element off 16 bytes gets 1 where hd is its unit-stride axis
    (nbhd, nhbd), and nhdb, whose pool is written along the token, does
    not care."""
    from repro_torch.kernels.kv_repack import overlay_vector_width
    spec = KVPageSpec(16, layout, pool_dt, 2, 32)
    pool = torch.zeros((3,) + spec.pool_shape(5), dtype=TDT[pool_dt])
    lead = (3, 20) if stream_rows else (3, 2, 16)
    canon = torch.zeros(lead + (2, 40), dtype=TDT[canon_dt])[..., offset:
                                                             offset + 32]
    want = min(cap, _low_bit(offset, cap))
    assert overlay_vector_width(spec, pool, canon, 0) == want
    for canon_off in (-80 * 7, -1, -2, -4, -6):    # front rows of stride 80
        assert overlay_vector_width(spec, pool, canon, canon_off) == min(
            want, _low_bit(canon_off, cap))
    assert overlay_vector_width(spec, pool, canon.transpose(-1, -2)
                                .contiguous().transpose(-1, -2), 0) == 1
    off_pool = torch.zeros(pool.numel() + 1, dtype=pool.dtype)[1:].view(
        pool.shape)
    assert overlay_vector_width(spec, off_pool, canon, 0) == (
        want if layout == "nhdb" else 1)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bs,kv,hd,itemsize", [
    (4, 2, 16, 4), (16, 8, 128, 2), (32, 32, 128, 2), (48, 8, 128, 4),
    (16, 64, 128, 4), (32, 1, 8, 2)])
def test_overlay_plan_covers_every_row_once(layout, bs, kv, hd, itemsize):
    """The overlay kernel's grid, over fronts 0..2·bs and spans from one
    row to several pages: chunks of whole tokens, at most 16 KiB of pool
    (one token where a token is larger) or the nhdb tile; every row of the
    span lies in exactly one launched chunk, every launched chunk holds a
    row of the span and lies in the span's pages, in launch order."""
    from repro_torch.kernels.kv_repack import (CHUNK_BYTES, TILE_TOKENS,
                                               overlay_chunks, overlay_plan)
    spec = KVPageSpec(bs, layout, "float32", kv, hd)
    t = overlay_plan(spec, itemsize, 0, 1)[0]
    if layout == "nhdb":
        assert t == min(TILE_TOKENS, bs)
    else:
        row = kv * hd * itemsize
        assert t == bs or t * row <= CHUNK_BYTES < (t + 1) * row or (
            t == 1 and row > CHUNK_BYTES)
    for front in range(2 * bs + 1):
        for seq_len in sorted({1, 2, max(1, t - 1), t, t + 1, bs - 1, bs,
                               bs + 1, 3 * bs + 5} - {0}):
            end = front + seq_len
            chunks = overlay_chunks(spec, itemsize, front, seq_len)
            assert chunks == sorted(set(chunks))
            rows = [p * bs + r for p, lo, hi in chunks for r in range(lo, hi)
                    if front <= p * bs + r < end]
            assert rows == list(range(front, end)), (front, seq_len)
            for p, lo, hi in chunks:
                assert 0 <= lo < hi <= bs and hi - lo <= t and lo % t == 0
                assert p * bs + lo < end and p * bs + hi > front
                assert p < -(-end // bs)


def test_overlay_plan_at_the_main_path_shape():
    """llama2-7b's D pool (block 32, 32 KV heads, hd 128): in bf16 a chunk
    is 2 tokens (16 KiB), 16 a page, and a 500-row stream chunk landing at
    row 20 launches the 250 chunks that hold its rows (8000 blocks over 32
    layers, where one block per page and layer made 544); the monolithic
    form, 17 whole pages, all 272. A float32 pool takes one token (16 KiB)
    a chunk; nhdb one 32-token tile a page."""
    from repro_torch.kernels.kv_repack import overlay_plan
    spec = KVPageSpec(32, "nbhd", "bfloat16", 32, 128)
    assert overlay_plan(spec, 2, 20, 500) == (2, 10, 250)
    assert overlay_plan(spec, 2, 0, 17 * 32) == (2, 0, 272)
    assert overlay_plan(spec, 4, 20, 500) == (1, 20, 500)
    nhdb = KVPageSpec(32, "nhdb", "bfloat16", 32, 128)
    assert overlay_plan(nhdb, 2, 20, 500) == (32, 0, 17)


@pytest.mark.parametrize("what,match", [("pointer", "base pointer"),
                                        ("stride", "seq stride"),
                                        ("length_one", None)])
def test_flash_tma_strides(what, match):
    """The bf16 kernel's TMA strides: a base pointer or a stride that is not
    a multiple of 16 bytes raises ValueError naming the cause; an axis of
    length 1, never stepped, takes a stride TMA accepts whatever torch
    reports."""
    from repro_torch.kernels.flash_attention import _tma_strides
    wide = torch.zeros((1, 2, 16, 72), dtype=torch.bfloat16)
    if what == "pointer":
        with pytest.raises(ValueError, match=match):
            _tma_strides("q", wide[..., 1:65])
    elif what == "stride":
        with pytest.raises(ValueError, match=match):
            _tma_strides("q", torch.zeros((1, 2, 16, 65),
                                          dtype=torch.bfloat16)[..., :64])
    else:
        t = torch.zeros((3, 1, 16, 64), dtype=torch.bfloat16)[:1]
        t = t.as_strided(t.shape, (5, 3, 64, 1))
        assert _tma_strides("q", wide[..., :64]) == [8, 1152, 72]
        assert _tma_strides("k", t) == [8, 8, 64]


# --------------------------------------------------------------------------- #
# paged attention's split across blocks (the card kernel's plan and merge)
# --------------------------------------------------------------------------- #
SPLIT_WIDTHS = list(range(1, 17)) + [31, 32, 33, 63, 64, 65, 100, 127, 128]


@pytest.mark.parametrize("width", SPLIT_WIDTHS)
def test_paged_split_plan_covers_every_page_once(width):
    """For a block table ``width`` pages wide, batches 1-8 and KV heads 1
    and 32: the splits tile the table's pages, and for any sequence length
    and window the splits the kernel keeps hold every page it must read
    exactly once, in order, and no split past its last page is kept."""
    from repro_torch.kernels.paged_attention import split_plan, split_ranges
    bs = 4
    lens = sorted(n for n in {1, 2, bs, bs + 1, width * bs // 2 + 1,
                              width * bs - 1, width * bs}
                  if 1 <= n <= width * bs)
    for batch in range(1, 9):
        for kvh in (1, 32):
            n_splits, pps = split_plan(width, batch, kvh)
            assert 1 <= n_splits <= width and pps >= 1
            assert (n_splits - 1) * pps < width <= n_splits * pps
            for window in (0, 1, 5, 3 * bs + 1):
                for n in lens:
                    n_pages = -(-n // bs)
                    p0 = max(0, n - window) // bs if window else 0
                    got = split_ranges(n, bs, width, pps, window)
                    pages = [p for _, pa, pb in got for p in range(pa, pb)]
                    assert pages == list(range(p0, n_pages))
                    assert all(s < n_splits for s, _, _ in got)
                    assert all(s * pps <= pa < pb <= (s + 1) * pps
                               for s, pa, pb in got)


@pytest.mark.parametrize("batch,kvh,width,want", [
    (8, 32, 65, (9, 8)),          # the main path's decode batch
    (1, 32, 64, (16, 4)),         # one 2048-token sequence: 4 pages a split
    (8, 32, 1, (1, 1)),
    (8, 32, 3, (1, 3)),           # fewer pages than the minimum split
    (264, 32, 65, (1, 65)),       # a batch that fills the card alone
])
def test_paged_split_plan_fills_the_card(batch, kvh, width, want):
    """Enough splits that the grid has about 16 blocks per SM of 132, at
    least 4 pages each where the table has them."""
    from repro_torch.kernels.paged_attention import split_plan
    assert split_plan(width, batch, kvh, 132) == want


@pytest.mark.parametrize("h,kv,d,bs,es,cb,want", [
    (32, 32, 128, 32, 2, 16, dict(head_dim=128, pitch=128, stages=3)),
    (32, 32, 128, 32, 4, 16, dict(head_dim=128, pitch=128, stages=3)),
    (32, 32, 128, 32, 2, 0, dict(head_dim=128, pitch=132, stages=3)),
    (32, 8, 128, 16, 2, 16, dict(head_dim=128, pitch=128, stages=3)),
    (8, 2, 80, 16, 2, 8, dict(head_dim=128, pitch=80, stages=3)),
    (4, 1, 20, 4, 4, 16, dict(head_dim=32, pitch=20, stages=3)),
    (4, 4, 128, 64, 4, 16, dict(head_dim=128, pitch=128, stages=3)),
    (4, 4, 128, 128, 4, 16, dict(head_dim=128, pitch=128, stages=1)),
    (16, 1, 256, 32, 2, 16, dict(head_dim=256, head_split=2, pitch=256,
                                 stages=3)),
    (32, 1, 128, 16, 2, 16, dict(head_dim=128, head_split=2)),
    (16, 2, 256, 32, 2, 0, dict(head_dim=256, head_split=1, pitch=260)),
    (64, 1, 128, 16, 2, 16, dict(head_dim=128, head_split=4)),
    (9, 1, 256, 32, 2, 16, dict(head_dim=256, head_split=3)),
])
def test_paged_launch_plan(h, kv, d, bs, es, cb, want):
    """Padded head dim, staged row pitch (16-byte rows for cp.async, padded
    rows for the register path), ring depth within shared memory; a group
    of more than 2048 (query heads x padded head dim) split over the
    fewest blocks that share its heads evenly."""
    from repro_torch.kernels.paged_attention import SMEM_LIMIT, launch_plan
    plan = launch_plan(h, kv, d, bs, es, cb)
    assert {k: plan[k] for k in want} == want
    assert plan["pitch"] % 4 == 0 and plan["smem"] <= SMEM_LIMIT
    if cb:
        assert plan["pitch"] * es % 16 == 0


@pytest.mark.parametrize("h,kv,d,bs", [(65536, 65536, 32, 8),
                                       (4, 4, 300, 8), (4, 4, 256, 256),
                                       (3, 2, 64, 8)])
def test_paged_launch_plan_refuses(h, kv, d, bs):
    """More (KV head, head split) blocks than the grid's y axis takes, a
    head dim past 256, a page whose ring does not fit in shared memory,
    uneven groups."""
    from repro_torch.kernels.paged_attention import launch_plan
    with pytest.raises(ValueError, match="paged_attention"):
        launch_plan(h, kv, d, bs, 4, 16)


# flash_decode's plans at the main path's shapes and the sweep's edges:
# (query heads, KV heads, head dim, K/V element bytes) -> plan. Element
# bytes 4 is the float32 scalar kernel, 2 and 1 the tensor-core kernel
# under a bfloat16 q (bf16 and float8 e4m3 K/V).
@pytest.mark.parametrize("h,kv,d,es,want", [
    (32, 8, 128, 2, dict(head_dim=128, tile=64, head_split=1, m_tiles=1,
                         pitch_k=136, pitch_v=136, stages=2,
                         smem=2 * (64 * 272 * 2 + 256))),   # Mixtral, Qwen3-4B
    (16, 1, 256, 2, dict(head_dim=256, tile=32, head_split=1, m_tiles=1,
                         pitch_k=264, pitch_v=264, stages=3,
                         smem=3 * (32 * 528 * 2 + 128))),   # RG
    (40, 40, 128, 1, dict(head_dim=128, tile=64, head_split=1, m_tiles=1,
                          pitch_k=144, pitch_v=160, stages=3,
                          smem=3 * (64 * 304 + 256))),     # e4m3
    (2, 2, 64, 4, dict(head_dim=64, tile=32, head_split=1, pitch_k=64,
                       pitch_v=64, stages=3)),
    (64, 1, 256, 4, dict(head_dim=256, tile=32, head_split=8, pitch_k=256,
                         smem=3 * (2 * 32 * 256 * 4 + 128))),
    (64, 1, 256, 2, dict(head_dim=256, head_split=1, m_tiles=4)),
    (8, 2, 20, 1, dict(head_dim=64, tile=64, pitch_k=80, pitch_v=96,
                       stages=4)),
    (8, 2, 20, 2, dict(head_dim=64, tile=64, pitch_k=72, pitch_v=72,
                       stages=4)),
    (12, 1, 256, 1, dict(head_dim=256, tile=32, m_tiles=1, pitch_k=272,
                         pitch_v=288)),
    (9, 1, 256, 4, dict(head_dim=256, head_split=3)),
    (33, 1, 128, 2, dict(head_split=1, m_tiles=3)),
])
def test_flash_decode_launch_plan(h, kv, d, es, want):
    """Padded head dim; on the float32 kernel the head split (the fewest
    blocks sharing a KV head's group evenly, each at most 2048 query heads
    x padded head dim), 16-byte staged rows and its 3-stage ring; on the
    tensor-core kernel 16-row head tiles in a loop (no head split), tiles
    of 16 slots a warp's group (two warps a group at head dim 256), row
    pitches that keep the fragment loads off each other's banks, and the
    most stages (2-4) that leave an SM as many blocks as the kernel's
    registers allow; shared memory for the ring or the warps' merge
    buffer, whichever is larger, within the card's."""
    from repro_torch.kernels.flash_decode import (MMA_ROWS, REG_BLOCKS,
                                                  launch_plan, ring_budget)
    from repro_torch.kernels.paged_attention import SMEM_LIMIT, WARPS
    plan = launch_plan(h, kv, d, es)
    assert {k: plan[k] for k in want} == want
    hd, tile = plan["head_dim"], plan["tile"]
    stage = tile * (plan["pitch_k"] + plan["pitch_v"]) * es + 4 * tile
    assert min(plan["pitch_k"], plan["pitch_v"]) >= d
    assert plan["pitch_k"] * es % 16 == plan["pitch_v"] * es % 16 == 0
    if es == 4:
        grp = h // kv // plan["head_split"]
        assert grp * hd <= 2048 and plan["m_tiles"] == 1
        merge = 4 * WARPS * (2 * grp + grp * hd)
    else:
        groups = tile // MMA_ROWS
        assert groups == (2 if hd == 256 else WARPS)
        assert plan["m_tiles"] * MMA_ROWS >= h // kv > \
            (plan["m_tiles"] - 1) * MMA_ROWS
        assert min(plan["pitch_k"], plan["pitch_v"]) >= hd
        assert plan["pitch_k"] * es % 32 == 16            # K: 2 rows a phase
        if es == 2:                                       # ldmatrix: 8 rows
            assert plan["pitch_v"] * es // 16 % 2 == 1
        else:                                             # 4 rows a load
            assert plan["pitch_v"] % 128 in (32, 96)
        budget = ring_budget(hd)
        assert 2 <= plan["stages"] <= 4
        assert plan["stages"] * stage <= budget or plan["stages"] == 2
        assert (plan["stages"] + 1) * stage > budget or plan["stages"] == 4
        assert plan["resident"] == min(REG_BLOCKS[hd], (228 * 1024)
                                       // (plan["smem"] + 1024))
        merge = 4 * groups * MMA_ROWS * (2 + hd)
    assert plan["smem"] == max(plan["stages"] * stage, merge) <= SMEM_LIMIT


@pytest.mark.parametrize("h,kv,d", [(4, 4, 300), (3, 2, 64), (4, 0, 64),
                                    (65536 * 2, 65536, 256)])
@pytest.mark.parametrize("es", [4, 2])
def test_flash_decode_launch_plan_refuses(h, kv, d, es):
    """A head dim past 256, uneven groups, no KV head, more (KV head, head
    split) blocks than the grid's y axis takes, on either kernel."""
    from repro_torch.kernels.flash_decode import launch_plan
    with pytest.raises(ValueError, match="flash_decode"):
        launch_plan(h, kv, d, es)


@pytest.mark.parametrize("h,kv,d,dv,es,want", [
    (16, 16, 192, 128, 2, dict(head_dim=256, head_dim_v=128, tile=64,
                               pitch_k=264, pitch_v=136, stages=2)),  # MLA
    (16, 16, 192, 128, 1, dict(head_dim=256, head_dim_v=128, tile=64,
                               pitch_k=272, pitch_v=160)),
    (8, 2, 128, 64, 2, dict(head_dim=128, head_dim_v=64, tile=64,
                            pitch_k=136, pitch_v=72)),
    (16, 1, 256, 256, 2, dict(head_dim=256, head_dim_v=256, tile=32)),
    (8, 2, 48, 32, 4, dict(head_dim=64, head_dim_v=64, tile=32,
                           pitch_k=48, pitch_v=48, stages=3)),
])
def test_flash_decode_launch_plan_v_narrower_than_k(h, kv, d, dv, es,
                                                    want):
    """V narrower than K (MLA's expanded latent: 192 / 128): K's padded
    head dim sets the K pitch and the blocks an SM holds, V's the V pitch,
    the slot groups a tile (two warps share a group only when V is 256
    wide) and the warps' merge buffer; the float32 kernel stages V at K's
    pitch. A V wider than K is refused."""
    from repro_torch.kernels.flash_decode import (MMA_ROWS, REG_BLOCKS,
                                                  launch_plan, ring_budget)
    from repro_torch.kernels.paged_attention import SMEM_LIMIT, WARPS
    plan = launch_plan(h, kv, d, es, dv)
    assert {k: plan[k] for k in want} == want
    assert plan["pitch_k"] >= d and plan["pitch_v"] >= dv
    if es != 4:
        hd, hdv = plan["head_dim"], plan["head_dim_v"]
        groups = plan["tile"] // MMA_ROWS
        assert groups == (2 if hdv == 256 else WARPS)
        assert plan["pitch_k"] >= hd and plan["pitch_v"] >= hdv
        stage = plan["tile"] * (plan["pitch_k"] + plan["pitch_v"]) * es \
            + 4 * plan["tile"]
        assert plan["stages"] * stage <= ring_budget(hd) \
            or plan["stages"] == 2
        merge = 4 * groups * MMA_ROWS * (2 + hdv)
        assert plan["smem"] == max(plan["stages"] * stage, merge) \
            <= SMEM_LIMIT
        assert plan["resident"] == min(REG_BLOCKS[hd], (228 * 1024)
                                       // (plan["smem"] + 1024))
    assert launch_plan(h, kv, d, es) == launch_plan(h, kv, d, es, d)
    with pytest.raises(ValueError, match="flash_decode"):
        launch_plan(h, kv, d, es, d + 1)


# the main path's flash_decode calls, batch 2, one row: (query heads, KV
# heads, head dim, K/V element bytes, capacity) -> (splits, tiles a split)
@pytest.mark.parametrize("h,kv,d,es,cap,want", [
    (32, 8, 128, 2, 4096, (22, 3)),         # Mixtral's ring (15b, 15d)
    (16, 1, 256, 2, 2048, (64, 1)),         # RecurrentGemma's ring (15c)
    (40, 40, 128, 1, 32_896, (14, 37)),     # Qwen1.5-32B's e4m3 cache (15a)
    (32, 8, 128, 2, 32_896, (24, 22)),      # Qwen3-4B's dense cache (14a)
    (32, 8, 128, 2, 64, (1, 1)),
    (16, 1, 256, 2, 48, (2, 1)),
    (8, 2, 64, 4, 524_288, None),
])
def test_flash_decode_split_plan(h, kv, d, es, cap, want):
    """The splits of each (sequence x row, KV head) at the main path's
    shapes on 132 SMs: the grid holds at least 2 blocks an SM where the
    cache has that many tiles (else one block a tile), the splits cover
    the tiles with none empty, and RecurrentGemma's ring gets one tile a
    split."""
    from repro_torch.kernels.flash_decode import (MAX_GRID_X, launch_plan,
                                                  split_plan)
    from repro_torch.kernels.paged_attention import SMEM_LIMIT
    plan = launch_plan(h, kv, d, es)
    n_tiles = -(-cap // plan["tile"])
    pairs = 2 * kv * plan["head_split"]
    splits, tps = split_plan(n_tiles, pairs, 132, plan["resident"])
    if want is not None:
        assert (splits, tps) == want
    assert pairs * splits >= min(2 * 132, pairs * n_tiles)
    assert splits * tps >= n_tiles > (splits - 1) * tps
    assert splits <= MAX_GRID_X and plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_paged_stage_copy_bytes(layout, dtype, offset):
    """cp.async width from the pools' bases and strides: 16 bytes for
    contiguous rows, less for pools sliced at an element offset inside a
    wider buffer, 0 (register staging) for token-innermost pages or
    2-byte alignment."""
    from repro_torch.kernels.paged_attention import (pool_strides,
                                                     stage_copy_bytes)
    spec = KVPageSpec(8, layout, dtype, 2, 32)
    page = spec.page_shape()
    wide = torch.zeros((5,) + page[:-1] + (page[-1] + 8,), dtype=TDT[dtype])
    pool = wide[..., offset:offset + page[-1]]
    es = pool.element_size()
    got = stage_copy_bytes(pool, pool, pool_strides(pool, layout), 32)
    if layout == "nhdb":
        assert got == 0
    else:
        want = 16 if offset == 0 else es * offset
        assert got == (want if want >= 4 else 0)


def _split_merge(q, kp, vp, table, lens, layout, window, pps):
    """Plain float32 flash-decoding: each split's max, sum and
    unnormalised P.V over its pages, merged as the card kernel merges them
    (rescale by exp(m_s - max m), divide by the merged sum once)."""
    from repro_torch.kernels.paged_attention import split_ranges
    from repro_torch.serving.paged_cache import _to_canon_perm
    perm = (0,) + tuple(i + 1 for i in _to_canon_perm(layout))
    kc, vc = kp.permute(perm).float(), vp.permute(perm).float()
    _, bs, kv, d = kc.shape
    b, h, _ = q.shape
    grp, scale = h // kv, 1.0 / np.sqrt(d)
    out = torch.zeros(b, h, d)
    for i in range(b):
        n = int(lens[i])
        parts = []
        for _, pa, pb in split_ranges(n, bs, table.shape[1], pps, window):
            ids = table[i, pa:pb].long()
            k = kc[ids].reshape(-1, kv, d)
            v = vc[ids].reshape(-1, kv, d)
            pos = torch.arange(pa * bs, pb * bs)
            ok = (pos < n) & ((pos >= n - window) if window > 0 else True)
            qg = q[i].float().reshape(kv, grp, d)
            s = torch.einsum("kgd,tkd->kgt", qg, k) * scale
            s = torch.where(ok, s, torch.full_like(s, -float("inf")))
            m = s.max(-1).values
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, v)))
        big = torch.stack([m for m, _, _ in parts]).max(0).values
        num = sum(a * torch.exp(m - big)[..., None] for m, _, a in parts)
        den = sum(l * torch.exp(m - big) for m, l, _ in parts)
        out[i] = (num / den.clamp_min(1e-30)[..., None]).reshape(h, d)
    return out


@pytest.mark.parametrize("b,h,kv,d,bs,pages", PAGED_SHAPES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pps", [1, 2, 3])
@pytest.mark.parametrize("window", [0, 11, 5])
def test_paged_split_merge_matches_ref(b, h, kv, d, bs, pages, layout, pps,
                                       window):
    """Per-split partials merged with the kernel's combine formula equal
    paged_attention_ref in float32 within 2e-5 at the JAX sweep shapes,
    with splits of 1-3 pages whose edges the window start crosses."""
    q, k, v, table, lens = _paged_inputs(b, h, kv, d, bs, pages, seed=3)
    spec = KVPageSpec(bs, layout, "float32", kv, d)
    kp = pages_from_canonical(spec, torch.from_numpy(k)).contiguous()
    vp = pages_from_canonical(spec, torch.from_numpy(v)).contiguous()
    tq, tt, tl = (torch.from_numpy(a) for a in (q, table, lens))
    want = ref.paged_attention_ref(tq, kp, vp, tt, tl, layout=layout,
                                   window=window)
    got = _split_merge(tq, kp, vp, tt, tl, layout, window, pps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,out_dt,cap", [
    ("bfloat16", "bfloat16", 8), ("float32", "float32", 4),
    ("bfloat16", "float32", 4), ("float32", "bfloat16", 4)])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_gather_vector_width_from_the_alignments(layout, pool_dt, out_dt,
                                                 cap, offset):
    """gather_pages' width from the pool's base pointer and strides: a pool
    sliced at an element offset inside a wider buffer (along its innermost
    axis) gets the largest width that divides the offset where hd is that
    axis; a token-innermost (nhdb) pool is read one element at a time, so
    only the contiguous output counts there."""
    from repro_torch.kernels.kv_repack import gather_vector_width
    spec = KVPageSpec(16, layout, pool_dt, 2, 32)
    page = spec.page_shape()
    wide = torch.zeros((3, 5) + page[:-1] + (page[-1] + 8,),
                       dtype=TDT[pool_dt])
    pool = wide[..., offset:offset + page[-1]]
    out = torch.zeros((3, 2, 16, 2, 32), dtype=TDT[out_dt])
    want = cap if layout == "nhdb" or offset == 0 else min(cap, offset)
    assert gather_vector_width(spec, pool, out) == want
    assert gather_vector_width(spec, pool, out[..., 1:17]) == 1
