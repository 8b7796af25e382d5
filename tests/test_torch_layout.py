"""The port's VRAM-layout alignment component (``core/compat/layout.py``,
the paper's §III-B-2 and Fig. 3) and the paged cache's ``init_pool`` and
``gather_sequence`` against the JAX package's, on the CPU.

Every result is held bit-identical to the reference's: the functions only
move, pad and cast rows, so no tolerance applies. Parametrised over the
three page layouts, block sizes and dtypes (float32 and bfloat16 pools,
and a cast between them in ``convert``). Mirrors
tests/test_compat.py::test_flatten_to_1d_transfer_preserves_tokens and
the ``init_pool`` cases of tests/test_paged_cache.py
(test_append_token_every_layout, test_paged_attention_ref_matches_dense).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compat import layout as JLay
from repro.models import layers as JL
from repro.serving import paged_cache as JPC
from repro_torch.core.compat import layout as TLay
from repro_torch.models import layers as TL
from repro_torch.serving import paged_cache as TPC

LAYOUTS = ("nbhd", "nhbd", "nhdb")
DTYPES = ("float32", "bfloat16")
KV, HD = 2, 8


def _bits(x) -> np.ndarray:
    """The raw bits of a tensor or array (bf16 as 16-bit, else 32-bit)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16 if x.element_size() == 2
                      else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _specs(bs, layout, dtype):
    return (TPC.KVPageSpec(bs, layout, dtype, KV, HD),
            JPC.KVPageSpec(bs, layout, dtype, KV, HD))


def _rows(n, seed, dtype):
    """(n, KV, HD) rows, the same values on both sides (bf16 rounded once
    in numpy's float32 → the target dtype by each package)."""
    a = np.random.default_rng(seed).standard_normal((n, KV, HD)).astype(
        np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(dtype))


def _pool(spec_t, spec_j, nb, seed):
    """A pool of ``nb`` pages of random rows (not zeros), both sides."""
    t, j = _rows(nb * spec_t.block_size, seed, spec_t.dtype)
    shape = (nb, spec_t.block_size, KV, HD)
    return (TPC.pages_from_canonical(spec_t, t.reshape(shape)).contiguous(),
            JPC.pages_from_canonical(spec_j, j.reshape(shape)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bs", [4, 16])
def test_init_pool_matches_reference(bs, layout, dtype):
    """Shape, dtype and zeros of a fresh pool, as the reference makes it."""
    t_spec, j_spec = _specs(bs, layout, dtype)
    got, want = TPC.init_pool(t_spec, 5), JPC.init_pool(j_spec, 5)
    assert tuple(got.shape) == want.shape == t_spec.pool_shape(5)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype) == dtype
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bs,seq", [(4, 9), (8, 8), (16, 5)])
def test_gather_sequence_and_extract_canonical_match_reference(
        bs, seq, layout, dtype):
    """One sequence's rows out of unsorted pages of a random pool: the
    canonical (seq, kv, hd) rows and the flat wire tensor."""
    t_spec, j_spec = _specs(bs, layout, dtype)
    tp, jp = _pool(t_spec, j_spec, 6, seed=bs + seq)
    nb = t_spec.blocks_for(seq)
    ids = np.random.default_rng(seq).permutation(6)[:nb].astype(np.int32)
    got = TPC.gather_sequence(t_spec, tp, torch.from_numpy(ids), seq)
    want = JPC.gather_sequence(j_spec, jp, jnp.asarray(ids), seq)
    assert tuple(got.shape) == want.shape == (seq, KV, HD)
    assert np.array_equal(_bits(got), _bits(want))
    flat = TLay.extract_canonical(t_spec, tp, torch.from_numpy(ids), seq)
    jflat = JLay.extract_canonical(j_spec, jp, jnp.asarray(ids), seq)
    assert flat.shape == (seq * KV * HD,)
    assert np.array_equal(_bits(flat), _bits(jflat))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bs,seq", [(4, 9), (8, 8), (16, 5)])
def test_materialize_matches_reference(bs, seq, layout, dtype):
    """The flat wire rows into unsorted pages of a random pool (float32
    rows cast to the pool's dtype): the touched pages, their zeroed tail
    and the untouched pages equal the reference's pool, bit for bit."""
    t_spec, j_spec = _specs(bs, layout, dtype)
    tp, jp = _pool(t_spec, j_spec, 6, seed=3)
    nb = t_spec.blocks_for(seq)
    ids = np.random.default_rng(seq + 1).permutation(6)[:nb].astype(np.int32)
    t_rows, j_rows = _rows(seq, 7, "float32")
    got = TLay.materialize(t_spec, tp, torch.from_numpy(ids),
                           t_rows.reshape(-1), seq)
    want = JLay.materialize(j_spec, jp, jnp.asarray(ids),
                            j_rows.reshape(-1), seq)
    assert got is tp
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("src_dtype,dst_dtype",
                         [("float32", "float32"), ("bfloat16", "bfloat16"),
                          ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("src_layout,dst_layout",
                         [("nhbd", "nbhd"), ("nbhd", "nhdb"),
                          ("nhdb", "nhbd"), ("nbhd", "nbhd")])
@pytest.mark.parametrize("src_bs,dst_bs,seq", [(16, 32, 37), (8, 4, 13)])
def test_convert_matches_reference(src_bs, dst_bs, seq, src_layout,
                                   dst_layout, src_dtype, dst_dtype):
    """Fig. 3: one sequence's src-layout pages → dst-layout pages at
    another block size and dtype, bit-identical to the reference's
    (including the zeroed tail of the last dst page)."""
    src_t, src_j = (TPC.KVPageSpec(src_bs, src_layout, src_dtype, KV, HD),
                    JPC.KVPageSpec(src_bs, src_layout, src_dtype, KV, HD))
    dst_t, dst_j = (TPC.KVPageSpec(dst_bs, dst_layout, dst_dtype, KV, HD),
                    JPC.KVPageSpec(dst_bs, dst_layout, dst_dtype, KV, HD))
    tp, jp = _pool(src_t, src_j, src_t.blocks_for(seq), seed=seq)
    got = TLay.convert(src_t, dst_t, tp, seq)
    want = JLay.convert(src_j, dst_j, jp, seq)
    assert tuple(got.shape) == want.shape == dst_t.pool_shape(
        dst_t.blocks_for(seq))
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("src_layout", LAYOUTS)
@pytest.mark.parametrize("dst_layout", LAYOUTS)
@pytest.mark.parametrize("src_bs,dst_bs,seq", [(4, 16, 1), (16, 8, 40),
                                               (8, 8, 17)])
def test_flatten_to_1d_transfer_preserves_tokens(src_bs, dst_bs, seq,
                                                 src_layout, dst_layout):
    """The paper's general method (tests/test_compat.py): rows into a src
    pool, flattened to the 1-D wire, re-materialized in the dst layout and
    gathered back are the rows, bit for bit; each step's pool is the
    reference's."""
    src_t, src_j = (TPC.KVPageSpec(src_bs, src_layout, "float32", KV, HD),
                    JPC.KVPageSpec(src_bs, src_layout, "float32", KV, HD))
    dst_t, dst_j = (TPC.KVPageSpec(dst_bs, dst_layout, "float32", KV, HD),
                    JPC.KVPageSpec(dst_bs, dst_layout, "float32", KV, HD))
    t_rows, j_rows = _rows(seq, 1, "float32")
    ns, nd = src_t.blocks_for(seq), dst_t.blocks_for(seq)
    sp = TLay.materialize(src_t, TPC.init_pool(src_t, ns),
                          torch.arange(ns), t_rows.reshape(-1), seq)
    jsp = JPC.scatter_sequence(src_j, JPC.init_pool(src_j, ns),
                               jnp.arange(ns), j_rows)
    assert np.array_equal(_bits(sp), _bits(jsp))
    wire = TLay.extract_canonical(src_t, sp, torch.arange(ns), seq)
    dp = TLay.materialize(dst_t, TPC.init_pool(dst_t, nd), torch.arange(nd),
                          wire, seq)
    jwire = JPC.gather_sequence(src_j, jsp, jnp.arange(ns), seq)
    jdp = JPC.scatter_sequence(dst_j, JPC.init_pool(dst_j, nd),
                               jnp.arange(nd), jwire)
    assert np.array_equal(_bits(dp), _bits(jdp))
    got = TPC.gather_sequence(dst_t, dp, torch.arange(nd), seq)
    assert np.array_equal(_bits(got), _bits(t_rows))


@pytest.mark.parametrize("seq", [1, 16, 37])
def test_transfer_shapes_match_reference(seq):
    src_t, src_j = _specs(16, "nhbd", "bfloat16")
    dst_t, dst_j = _specs(32, "nbhd", "bfloat16")
    assert TLay.transfer_shapes(src_t, dst_t, seq) == \
        JLay.transfer_shapes(src_j, dst_j, seq) == \
        (seq * KV * HD, -(-seq // 16), -(-seq // 32))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_append_token_into_init_pool(layout):
    """tests/test_paged_cache.py's append into a fresh pool: three tokens
    at (block, slot) (1, 0), (2, 3), (5, 2) land where the reference puts
    them, every other row stays zero."""
    t_spec, j_spec = _specs(4, layout, "float32")
    tok_t, tok_j = _rows(3, 0, "float32")
    blocks, slots = np.asarray([1, 2, 5], np.int32), np.asarray([0, 3, 2],
                                                                 np.int32)
    got = TPC.append_token(t_spec, TPC.init_pool(t_spec, 6),
                           torch.from_numpy(blocks), torch.from_numpy(slots),
                           tok_t)
    want = JPC.append_token(j_spec, JPC.init_pool(j_spec, 6),
                            jnp.asarray(blocks), jnp.asarray(slots), tok_j)
    assert np.array_equal(_bits(got), _bits(want))


def test_paged_attention_ref_over_init_pools_matches_dense():
    """tests/test_paged_cache.py's paged reference over sequences laid into
    fresh pools through ``layout.materialize``: the dense masked ``sdpa``
    (1e-5), and the reference's pools bit for bit."""
    b, h, bs, pages = 2, 4, 4, 3
    t_spec, j_spec = _specs(bs, "nbhd", "float32")
    rng = np.random.default_rng(1)
    seq_lens = np.asarray([7, 11], np.int32)
    k = rng.normal(size=(b, bs * pages, KV, HD)).astype(np.float32)
    v = rng.normal(size=(b, bs * pages, KV, HD)).astype(np.float32)
    q = rng.normal(size=(b, 1, h, HD)).astype(np.float32)
    table = np.arange(1, b * pages + 1, dtype=np.int32).reshape(b, pages)
    pools = [TPC.init_pool(t_spec, b * pages + 1) for _ in range(2)]
    jpools = [JPC.init_pool(j_spec, b * pages + 1) for _ in range(2)]
    for i in range(b):
        for j, src in enumerate((k, v)):
            TLay.materialize(t_spec, pools[j], torch.from_numpy(table[i]),
                             torch.from_numpy(src[i]).reshape(-1),
                             bs * pages)
            jpools[j] = JPC.scatter_sequence(j_spec, jpools[j],
                                             jnp.asarray(table[i]),
                                             jnp.asarray(src[i]))
    for got, want in zip(pools, jpools):
        assert np.array_equal(_bits(got), _bits(want))
    out = TPC.paged_attention_ref(torch.from_numpy(q), *pools,
                                  torch.from_numpy(table),
                                  torch.from_numpy(seq_lens), t_spec)
    mask = TL.length_mask(torch.from_numpy(seq_lens), bs * pages)
    dense = TL.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), mask)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-5)
    jdense = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     JL.length_mask(jnp.asarray(seq_lens), bs * pages))
    np.testing.assert_allclose(out.numpy(), np.asarray(jdense), atol=1e-5)
