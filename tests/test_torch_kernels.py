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
