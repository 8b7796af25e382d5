"""On an NVIDIA GPU: each CUDA kernel against its plain PyTorch version,
the dense model's kernel route against its plain route, and the whole
serving path on the card against the same path on the CPU.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16 (tests/test_kernels.py);
the re-page, gather, scatter and repack must be bit-identical.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import Engine, VendorProfile
from repro_torch.serving.paged_cache import KVPageSpec, pages_from_canonical
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import GlobalScheduler
from repro_torch.serving.server import Server

pytestmark = pytest.mark.cuda

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [(1, 4, 4, 16, 16, 32), (2, 8, 2, 24, 48, 64),
                (1, 4, 1, 7, 133, 32), (1, 2, 2, 130, 200, 128)]
LAYOUTS = ["nbhd", "nhbd", "nhdb"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        TDT[dtype]).to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window,q_offset",
                         [(True, 0, 0), (True, 9, 0), (True, 0, 3),
                          (False, 0, 0)])
def test_flash_kernel(cuda, b, h, kv, sq, skv, d, dtype, causal, window,
                      q_offset):
    rng = np.random.default_rng(sq)
    q = _rand(rng, (b, h, sq, d), dtype, cuda)
    k = _rand(rng, (b, kv, skv, d), dtype, cuda)
    v = _rand(rng, (b, kv, skv, d), dtype, cuda)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


# (b, h, kv, sq, cap, d, q_offset, kv_len, window): GQA 4 and 8 query heads
# per KV head, Sq not a multiple of the 128-row tile, a chunk at q_offset
# over a longer full-capacity cache, a window crossing a key tile's edge,
# kv_len < Skv binding rows past it (the last case's rows from 319 on see
# no key and give zeros)
FLASH_CASES = [(1, 16, 4, 128, 128, 128, 0, 128, 0),
               (2, 32, 4, 200, 200, 128, 0, 200, 0),
               (1, 8, 8, 300, 300, 128, 0, 300, 0),
               (1, 8, 2, 157, 1000, 128, 600, 1000, 0),
               (1, 4, 4, 260, 260, 128, 0, 260, 100),
               (1, 4, 2, 200, 500, 128, 200, 333, 0),
               (2, 4, 4, 130, 400, 64, 200, 250, 70)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,cap,d,q_offset,kv_len,window",
                         FLASH_CASES)
def test_flash_kernel_tiles(cuda, dtype, b, h, kv, sq, cap, d, q_offset,
                            kv_len, window):
    """The kernel's tiles, masks and strides: q and k/v are (B, S, H, d)
    activations and a (B, cap, KV, d) cache passed transposed, as the
    model passes them, with no copy."""
    rng = np.random.default_rng(sq + cap)
    q = _rand(rng, (b, sq, h, d), dtype, cuda).transpose(1, 2)
    k = _rand(rng, (b, cap, kv, d), dtype, cuda).transpose(1, 2)
    v = _rand(rng, (b, cap, kv, d), dtype, cuda).transpose(1, 2)
    args = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention(q, k, v, **args)
    want = ref.flash_attention_ref(q, k, v, **args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


# (b, h, kv, sq, cap, kv_len), non-causal at head dim 64 (the bf16 kernel
# pads Q/K and V/O to 128 columns): Whisper's encoder (q = k, 1500 keys)
# and P's cross-attention (a 64-row chunk over 1500 memory rows in a
# 1536-row cache), then kv_len below the cache and not a multiple of 128
CROSS_CASES = [(1, 20, 20, 1500, 1500, 1500), (1, 20, 20, 64, 1536, 1500),
               (1, 20, 20, 37, 1500, 1300), (2, 4, 4, 130, 400, 333),
               (1, 4, 2, 1, 200, 77)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,cap,kv_len", CROSS_CASES)
def test_flash_kernel_non_causal_head_dim_64(cuda, dtype, b, h, kv, sq, cap,
                                             kv_len):
    """Non-causal flash over the first ``kv_len`` rows of a (B, cap, KV,
    64) cache passed transposed, as the encoder and the cross-attention
    pass them: every query row sees exactly those keys."""
    rng = np.random.default_rng(sq + kv_len)
    q = _rand(rng, (b, sq, h, 64), dtype, cuda).transpose(1, 2)
    k = _rand(rng, (b, cap, kv, 64), dtype, cuda).transpose(1, 2)
    v = _rand(rng, (b, cap, kv, 64), dtype, cuda).transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    want = ref.flash_attention_ref(q, k, v, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1500, 64, 1])
def test_flash_non_causal_on_a_rank_of_whisper(cuda, dtype, sq):
    """Non-causal flash as a rank of the (1, 2) mesh runs Whisper: 10 query
    heads at 64 over its 10 KV heads of the 20, a view of K/V gathered on
    head_dim, over 1,500 rows — the encoder (q = k), and the decoder's
    cross-attention over the memory for a chunk and for one decode row."""
    rng = np.random.default_rng(sq)
    q = _rand(rng, (1, sq, 10, 64), dtype, cuda)
    kv = _rand(rng, (2, 1, 1500, 20, 64), dtype, cuda)
    k, v = (t[:, :, 10:] for t in kv.unbind(0))      # rank 1's heads
    args = dict(causal=False, kv_len=1500)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), **args)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **args)
    torch.cuda.synchronize()
    assert got.shape == (1, 10, sq, 64)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


@pytest.mark.parametrize("what", ["pointer", "stride", "head_dim"])
def test_flash_kernel_refuses_what_tma_cannot_take(cuda, what):
    """bf16 goes through TMA: a base pointer or a stride that is not 16-byte
    aligned, or a head dim that is not a multiple of 16, raises
    ValueError naming the cause, and nothing is launched."""
    rng = np.random.default_rng(0)
    d = 40 if what == "head_dim" else 64
    wide = _rand(rng, (1, 2, 16, d + 8), "bfloat16", cuda)
    if what == "pointer":
        q = wide[..., 1:1 + d]                   # 2 bytes past an edge
    elif what == "stride":
        q = _rand(rng, (1, 2, 16, d + 1), "bfloat16", cuda)[..., :d]
    else:
        q = wide[..., :d]
    kv = _rand(rng, (1, 2, 16, d), "bfloat16", cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match={"pointer": "base pointer",
                                          "stride": "stride",
                                          "head_dim": "multiple of 16"}[what]):
        ops.flash_attention(q, kv, kv)
    assert ops.launch_counts()["flash_attention"] == 0


# (b, h, kv, sq, skv, dk, dv, q_offset, kv_len, window): a value head dim
# below the key head dim, as MLA's prefill has it (dk 192 = 128 nope + 64
# rope, dv 128): the two instances of the bf16 kernel (dk padded to 128
# and to 192), GQA, a chunk at q_offset over a longer cache, kv_len < Skv,
# a window across a key tile's edge, and the last 500-token chunk of a
# long prompt at DeepSeek-V2-Lite's 16 heads
FLASH_DV_CASES = [(1, 4, 4, 16, 16, 32, 16, 0, 16, 0),
                  (2, 8, 2, 24, 48, 64, 32, 0, 48, 0),
                  (1, 8, 2, 157, 1000, 160, 128, 600, 1000, 0),
                  (1, 16, 16, 130, 400, 192, 128, 200, 330, 0),
                  (1, 4, 4, 260, 260, 192, 128, 0, 260, 100),
                  (1, 16, 16, 500, 2000, 192, 128, 1500, 2000, 0),
                  (2, 4, 4, 200, 200, 192, 64, 0, 200, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,dk,dv,q_offset,kv_len,window",
                         FLASH_DV_CASES)
def test_flash_kernel_value_head_dim(cuda, dtype, b, h, kv, sq, skv, dk, dv,
                                     q_offset, kv_len, window):
    """v narrower than q and k, all passed transposed from (B, S, H, d)
    tensors as the model passes them; the output takes v's head dim."""
    rng = np.random.default_rng(sq + dk + dv)
    q = _rand(rng, (b, sq, h, dk), dtype, cuda).transpose(1, 2)
    k = _rand(rng, (b, skv, kv, dk), dtype, cuda).transpose(1, 2)
    v = _rand(rng, (b, skv, kv, dv), dtype, cuda).transpose(1, 2)
    args = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len,
                scale=1.0 / np.sqrt(dk))
    got = ops.flash_attention(q, k, v, **args)
    want = ref.flash_attention_ref(q, k, v, **args)
    torch.cuda.synchronize()
    assert got.shape == (b, h, sq, dv)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


# (b, h, kv, sq, skv, dk, dv, q_offset, kv_len, window): head dims above
# 192 / 128, the bf16 kernel's instance of 64-row tiles: RecurrentGemma's
# 16 query heads on one KV head at 256 / 256 with its 2048-token window
# over the last 500-token chunk of an 8192-token prompt, a short prefill,
# GQA with a window across a 64-key tile's edge and kv_len < Skv, and
# narrower head dims that this instance covers (dk 208 / dv 160, dk 192 /
# dv 144, dk 256 / dv 128)
FLASH_WIDE_CASES = [(1, 16, 1, 500, 8192, 256, 256, 7692, 8192, 2048),
                    (1, 16, 1, 70, 70, 256, 256, 0, 70, 0),
                    (2, 4, 2, 130, 300, 256, 256, 100, 230, 50),
                    (1, 4, 4, 65, 200, 208, 160, 0, 200, 0),
                    (1, 8, 2, 64, 64, 192, 144, 0, 64, 0),
                    (1, 2, 2, 200, 200, 256, 128, 0, 200, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,dk,dv,q_offset,kv_len,window",
                         FLASH_WIDE_CASES)
def test_flash_kernel_head_dim_256(cuda, dtype, b, h, kv, sq, skv, dk, dv,
                                   q_offset, kv_len, window):
    """Head dims up to 256, passed transposed from (B, S, H, d) tensors
    as the model passes them."""
    rng = np.random.default_rng(sq + dk + dv)
    q = _rand(rng, (b, sq, h, dk), dtype, cuda).transpose(1, 2)
    k = _rand(rng, (b, skv, kv, dk), dtype, cuda).transpose(1, 2)
    v = _rand(rng, (b, skv, kv, dv), dtype, cuda).transpose(1, 2)
    args = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention(q, k, v, **args)
    want = ref.flash_attention_ref(q, k, v, **args)
    torch.cuda.synchronize()
    assert got.shape == (b, h, sq, dv)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


@pytest.mark.parametrize("dk,dv", [(24, 16), (40, 24), (192, 100)])
def test_flash_kernel_value_head_dim_float32_any_width(cuda, dk, dv):
    """float32 takes head dims that are not multiples of 16: the tiny MLA
    config's 24 / 16 among them."""
    rng = np.random.default_rng(dk)
    q = _rand(rng, (1, 4, 37, dk), "float32", cuda)
    k = _rand(rng, (1, 4, 90, dk), "float32", cuda)
    v = _rand(rng, (1, 4, 90, dv), "float32", cuda)
    got = ops.flash_attention(q, k, v, q_offset=53)
    want = ref.flash_attention_ref(q, k, v, q_offset=53)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_mla_operands(cuda, dtype):
    """The operands as ``mla_block`` builds them: K = k_nope ‖ kpe
    broadcast over heads (contiguous, 192 wide), V a strided slice of the
    expanded latent (B, S, H, 256)[..., 128:], scale 1/sqrt(192)."""
    rng = np.random.default_rng(3)
    b, s, h = 1, 300, 16
    ukv = _rand(rng, (b, s, h, 256), dtype, cuda)
    kpe = _rand(rng, (b, s, 64), dtype, cuda)
    q = _rand(rng, (b, s, h, 192), dtype, cuda)
    k = torch.cat([ukv[..., :128], kpe[:, :, None].expand(b, s, h, 64)], -1)
    v = ukv[..., 128:]
    args = dict(causal=True, scale=1.0 / np.sqrt(192))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), **args)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


def _paged(rng, b, h, kv, d, bs, pages, dtype, layout, device):
    n = b * pages + 1
    spec = KVPageSpec(bs, layout, dtype, kv, d)
    q = _rand(rng, (b, h, d), dtype, device)
    k, v = (pages_from_canonical(spec, _rand(rng, (n, bs, kv, d), dtype,
                                             device)).contiguous()
            for _ in range(2))
    table = torch.from_numpy((rng.permutation(n - 1)[:b * pages]
                              .reshape(b, pages) + 1).astype(np.int32))
    lens = torch.from_numpy(rng.integers(1, bs * pages + 1, b).astype(np.int32))
    return q, k, v, table.to(device), lens.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b,h,kv,d,bs,pages", [(2, 4, 4, 32, 8, 4),
                                               (3, 8, 2, 64, 16, 3),
                                               (1, 4, 1, 32, 4, 7),
                                               (2, 4, 4, 128, 32, 5)])
@pytest.mark.parametrize("window", [0, 11])
def test_paged_kernel(cuda, dtype, layout, b, h, kv, d, bs, pages, window):
    rng = np.random.default_rng(b + bs)
    q, k, v, table, lens = _paged(rng, b, h, kv, d, bs, pages, dtype, layout,
                                  cuda)
    got = ops.paged_attention(q, k, v, table, lens, layout=layout,
                              window=window)
    want = ref.paged_attention_ref(q, k, v, table, lens, layout=layout,
                                   window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


def _paged_lens(rng, h, kv, d, bs, lens, dtype, layout, device, idle=()):
    """Pools and a table for sequences of the given lengths; the slots in
    ``idle`` point every page at block 0 (the engine's scratch block) with
    seq_len 1, as idle decode slots do."""
    b, pages = len(lens), max(-(-n // bs) for n in lens)
    n = b * pages + 1
    spec = KVPageSpec(bs, layout, dtype, kv, d)
    q = _rand(rng, (b, h, d), dtype, device)
    k, v = (pages_from_canonical(spec, _rand(rng, (n, bs, kv, d), dtype,
                                             device)).contiguous()
            for _ in range(2))
    table = rng.permutation(n - 1)[:b * pages].reshape(b, pages) + 1
    lens = np.asarray(lens)
    for i in idle:
        table[i], lens[i] = 0, 1
    return (q, k, v, torch.from_numpy(table.astype(np.int32)).to(device),
            torch.from_numpy(lens.astype(np.int32)).to(device))


# (h, kv, d, bs, lens); "split" is a length of exactly one split's pages
PAGED_SPLIT_CASES = [
    (4, 4, 128, 32, [1, 32, 2081, 2048]),
    (32, 32, 128, 32, [1, 2048]),
    (32, 32, 128, 32, [1, "split", 2081, 1800, 1900, 2000, 64, 33]),
    (32, 8, 128, 16, [1, 700, "split", 2081]),
    (40, 8, 128, 16, [300, 17, "split"]),
    (4, 2, 80, 8, [1, 99, 250]),
    (8, 1, 16, 4, [5, 37, "split"]),
    (4, 2, 128, 96, [1, 500]),           # f32: a ring of 2 stages
    (4, 2, 128, 128, [1, 300, "split"]),  # f32: one stage, nothing in flight
    (16, 1, 256, 32, [1, 2081, "split"]),  # a group of 4096: two blocks
    (32, 1, 128, 16, [300, 17, 2048]),    # the same split at head dim 128
    (64, 1, 128, 16, [300, 17, 2048]),    # four blocks of 16 heads
    (9, 1, 256, 32, [1, 700, "split"]),   # three blocks of 3 heads
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("h,kv,d,bs,lens", PAGED_SPLIT_CASES)
@pytest.mark.parametrize("window", [0, 100])
def test_paged_kernel_split_lengths(cuda, dtype, layout, h, kv, d, bs, lens,
                                    window):
    """Lengths that cross the split boundaries of the kernel's plan: 1, a
    multiple of the block, exactly one split, 2081, a batch mixing 1 with
    2048; GQA groups of 4, 5 and 8; head dims padded to the lanes (80, 16);
    pages too large for 3 stages in float32; a window of 100 that starts
    inside a split; groups wider than 2048 (query heads x head dim) on one
    KV head, served by two, three or four blocks sharing the heads."""
    from repro_torch.kernels.paged_attention import (launch_plan, sm_count,
                                                     split_plan)
    rng = np.random.default_rng(bs + d + len(lens))
    width = max(-(-n // bs) for n in lens if n != "split")
    hs = launch_plan(h, kv, d, bs, 4, 16)["head_split"]
    _, pps = split_plan(width, len(lens), kv * hs, sm_count(cuda))
    lens = [pps * bs if n == "split" else n for n in lens]
    args = _paged_lens(rng, h, kv, d, bs, lens, dtype, layout, cuda)
    got = ops.paged_attention(*args, layout=layout, window=window)
    want = ref.paged_attention_ref(*args, layout=layout, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_kernel_idle_slots(cuda, dtype, layout):
    """Idle decode slots (every page the scratch block, seq_len 1) beside
    live ones; one wrapper call counts one launch, combine included."""
    rng = np.random.default_rng(5)
    args = _paged_lens(rng, 32, 32, 128, 32, [1700, 900, 2048, 300], dtype,
                       layout, cuda, idle=(1, 3))
    ops.reset_launch_counts()
    got = ops.paged_attention(*args, layout=layout)
    assert ops.launch_counts()["paged_attention"] == 1
    want = ref.paged_attention_ref(*args, layout=layout)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


# Mixtral's windowed shapes (chip_smoke.py phase 6): 32 query heads over 8
# KV heads, head dim 128, window 4096; the eight prompt lengths
MIXTRAL_LENS = [8192, 7000, 6100, 5000, 4600, 4097, 3000, 2048]
# RecurrentGemma-9B's decode (chip_smoke.py phase 8): 16 query heads on
# one KV head of 256, window 2048, the same eight prompts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_window_at_serving_shape(cuda, dtype):
    """A 500-token chunk at q_offset 7500 over the 8500-slot full-capacity
    cache of an 8192-token prompt, window 4096: the kernel skips the key
    tiles below the window, and the first tile it visits is partly
    outside it (the window edge inside a tile)."""
    rng = np.random.default_rng(7500)
    q = _rand(rng, (1, 500, 32, 128), dtype, cuda).transpose(1, 2)
    k = _rand(rng, (1, 8500, 8, 128), dtype, cuda).transpose(1, 2)
    v = _rand(rng, (1, 8500, 8, 128), dtype, cuda).transpose(1, 2)
    args = dict(causal=True, window=4096, q_offset=7500, kv_len=8500)
    got = ops.flash_attention(q, k, v, **args)
    want = ref.flash_attention_ref(q, k, v, **args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL[dtype])


def _stale_nan(args, bs, layout, window):
    """Copies of the pools with NaN in every row of each sequence below
    its window floor (``len - window``), as stale rows of earlier
    sequences may hold anything: whole pages, and the floor page's rows
    below a floor inside it."""
    q, k, v, table, lens = args
    blks, rows = [], []
    for b, n in enumerate(lens.tolist()):
        t = np.arange(max(0, n - window))
        blks.append(table[b].cpu().numpy()[t // bs])
        rows.append(t % bs)
    blks = torch.from_numpy(np.concatenate(blks)).long().to(k.device)
    rows = torch.from_numpy(np.concatenate(rows)).long().to(k.device)
    kn, vn = k.clone(), v.clone()
    for pool in (kn, vn):
        if layout == "nbhd":
            pool[blks, rows] = float("nan")
        elif layout == "nhbd":
            pool[blks, :, rows] = float("nan")
        else:                                           # nhdb
            pool[blks, :, :, rows] = float("nan")
    return q, kn, vn, table, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("h,kv,d,bs,lens,window", [
    (4, 2, 64, 8, [37, 20, 9], 11),              # floors 26 (row 2), 9, 0
    (32, 8, 128, 32, [n + 32 for n in MIXTRAL_LENS], 4096),
    (16, 1, 256, 32, [n + 32 for n in MIXTRAL_LENS], 2048),
])
def test_paged_kernel_window_with_nan_below_the_floor(cuda, dtype, layout, h,
                                                      kv, d, bs, lens,
                                                      window):
    """NaN in every row below each sequence's window floor, a floor inside
    a page among them: the output is finite and bit-identical to the
    kernel's on the finite pools (the window is applied as a select, not
    an add), and matches the plain version; the window changes the
    output."""
    rng = np.random.default_rng(len(lens) + bs)
    args = _paged_lens(rng, h, kv, d, bs, lens, dtype, layout, cuda)
    stale = _stale_nan(args, bs, layout, window)
    assert bool(torch.isnan(stale[1]).any())
    got = ops.paged_attention(*stale, layout=layout, window=window)
    fin = ops.paged_attention(*args, layout=layout, window=window)
    want = ref.paged_attention_ref(*args, layout=layout, window=window)
    full = ref.paged_attention_ref(*args, layout=layout)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, fin)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATOL[dtype]
    assert (want.float() - full.float()).abs().max().item() >= 10 * err


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,canon_dt", [("float32", "float32"),
                                              ("bfloat16", "bfloat16"),
                                              ("bfloat16", "float32"),
                                              ("float32", "bfloat16")])
@pytest.mark.parametrize("front,seq_len", [(0, 24), (3, 17), (0, 5), (5, 2)])
@pytest.mark.parametrize("stream_rows", [False, True])
def test_overlay_kernel(cuda, layout, pool_dt, canon_dt, front, seq_len,
                        stream_rows):
    """Whole pages, or the stream's rows alone read where they lie: a
    strided slice of a wider buffer, as the TP realignment may leave it."""
    spec = KVPageSpec(8, layout, pool_dt, 2, 16)
    rng = np.random.default_rng(front + seq_len)
    nb = -(-(front + seq_len) // 8)
    pool = _rand(rng, (2,) + spec.pool_shape(9), pool_dt, cuda)
    if stream_rows:
        canon = _rand(rng, (2, seq_len, 4, 16), canon_dt, cuda)[:, :, 1:3]
    else:
        canon = _rand(rng, (2, nb, 8, 2, 16), canon_dt, cuda)
    ids = torch.tensor([5, 2, 7][:nb], dtype=torch.int32, device=cuda)
    want = ref.scatter_pages_overlay_ref(spec, pool.clone(), ids, canon,
                                         front=front, seq_len=seq_len)
    got = ops.scatter_pages_overlay(spec, pool, ids, canon, front=front,
                                    seq_len=seq_len)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


DTYPE_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
               ("bfloat16", "float32"), ("float32", "bfloat16")]

# (bs, front, seq_len) at hd 128, kv 8: front 0; mid-page with a span that
# ends mid-page; one row before a chunk edge (chunks of 8 tokens in bf16, 4
# in f32, 32 in nhdb); bs 16 and 48 (partial nhdb token tiles)
OVERLAY_WIDE_CASES = [(16, 0, 40), (32, 13, 50), (32, 7, 100), (32, 3, 61),
                      (32, 31, 90), (16, 5, 60), (48, 31, 70)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,canon_dt", DTYPE_PAIRS)
@pytest.mark.parametrize("bs,front,seq_len", OVERLAY_WIDE_CASES)
@pytest.mark.parametrize("stream_rows", [False, True])
@pytest.mark.parametrize("offset", [0, 2])
def test_overlay_kernel_vector_and_tile_paths(cuda, layout, pool_dt,
                                              canon_dt, bs, front, seq_len,
                                              stream_rows, offset):
    """hd 128 reaches the 16-byte accesses (nbhd, nhbd) and the shared-
    memory tile (nhdb); a canon 2 elements off 16 bytes takes 2-element
    accesses. Unsorted pages; rows outside the span and other pages keep
    their bits."""
    from repro_torch.kernels.kv_repack import overlay_vector_width
    spec = KVPageSpec(bs, layout, pool_dt, 8, 128)
    rng = np.random.default_rng(bs + front + seq_len + offset)
    nb = -(-(front + seq_len) // bs)
    pool, ids = _pool_and_ids(rng, spec, 2, 2 * nb + 3, nb, cuda)
    lead = (2, seq_len) if stream_rows else (2, nb, bs)
    canon = _rand(rng, lead + (8, 136), canon_dt, cuda)[..., offset:
                                                        offset + 128]
    canon_off = -front * canon.stride(1) if stream_rows else 0
    cap = 8 if pool_dt == canon_dt == "bfloat16" else 4
    assert overlay_vector_width(spec, pool, canon, canon_off) == (
        2 if offset else cap)
    want = ref.scatter_pages_overlay_ref(spec, pool.clone(), ids, canon,
                                         front=front, seq_len=seq_len)
    ops.reset_launch_counts()
    got = ops.scatter_pages_overlay(spec, pool, ids, canon, front=front,
                                    seq_len=seq_len)
    assert ops.launch_counts()["scatter_pages_overlay"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _pool_and_ids(rng, spec, layers, n_blocks, nb, device):
    """A random pool and ``nb`` distinct, unsorted, non-adjacent ids."""
    pool = _rand(rng, (layers,) + spec.pool_shape(n_blocks), spec.dtype,
                 device)
    ids = rng.permutation(np.arange(1, n_blocks, 2))[:nb].astype(np.int32)
    return pool, torch.from_numpy(ids).to(device)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("hd", [512, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_latent_pool_gather_overlay_repack(cuda, layout, hd, dtype):
    """MLA's latent pools: one KV "head" of width 512 (ckv) or 64 (kpe),
    block 32, 3 layers. The decode step's gather of a block table (with a
    repeated scratch page), the D-side overlay of a 70-row chunk landing
    at row 20 of a page, and the prefix cache's in-place page copy, each
    bit-identical to the plain version; other pages keep their bits."""
    spec = KVPageSpec(32, layout, dtype, 1, hd)
    rng = np.random.default_rng(hd)
    pool, ids = _pool_and_ids(rng, spec, 3, 23, 6, cuda)
    table = torch.cat([ids, ids[:1].new_zeros(2)])     # + the scratch page
    got = ops.gather_pages(spec, pool, table)
    want = ref.gather_pages_ref(spec, pool, table)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    before = pool.clone()
    rows = _rand(rng, (3, 70, 1, hd), dtype, cuda)
    want = ref.scatter_pages_overlay_ref(spec, pool.clone(), ids[:3], rows,
                                         front=20, seq_len=70)
    got = ops.scatter_pages_overlay(spec, pool, ids[:3], rows, front=20,
                                    seq_len=70)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    keep = [i for i in range(23) if i not in ids[:3].tolist()]
    assert torch.equal(pool[:, keep], before[:, keep])
    pair = ids[3:5].clone()
    want = ref.repack_ref(spec, spec, pool.clone(), pair[:1], pool.clone(),
                          pair[1:], 32)
    got = ops.repack(spec, spec, pool, pair[:1], pool, pair[1:], 32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bs", [4, 16, 32])
@pytest.mark.parametrize("pool_dt,out_dt", DTYPE_PAIRS)
@pytest.mark.parametrize("layers", [1, 32])
def test_gather_kernel(cuda, layout, bs, pool_dt, out_dt, layers):
    spec = KVPageSpec(bs, layout, pool_dt, 2, 16)
    rng = np.random.default_rng(bs + layers)
    pool, ids = _pool_and_ids(rng, spec, layers, 13, 4, cuda)
    got = ops.gather_pages(spec, pool, ids, out_dtype=TDT[out_dt])
    want = ref.gather_pages_ref(spec, pool, ids, out_dtype=TDT[out_dt])
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bs", [4, 16, 32])
@pytest.mark.parametrize("pool_dt,canon_dt", DTYPE_PAIRS)
@pytest.mark.parametrize("layers", [1, 32])
def test_scatter_kernel(cuda, layout, bs, pool_dt, canon_dt, layers):
    """Canonical pages read through strides (a slice of a wider buffer)
    into unsorted pages; every other page keeps its bits."""
    spec = KVPageSpec(bs, layout, pool_dt, 2, 16)
    rng = np.random.default_rng(2 * bs + layers)
    pool, ids = _pool_and_ids(rng, spec, layers, 13, 4, cuda)
    canon = _rand(rng, (layers, 4, bs, 3, 16), canon_dt, cuda)[:, :, :, 1:]
    want = ref.scatter_pages_ref(spec, pool.clone(), ids, canon)
    got = ops.scatter_pages(spec, pool, ids, canon)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout,bs,hd", [("nbhd", 32, 128),
                                          ("nhdb", 32, 128)])
def test_scatter_kernel_cow_page(cuda, layout, bs, hd):
    """The copy-on-write shape: one page of each of 32 layers (llama2-7b
    widths), and nhdb at block 32 with d 128, where the kernel transposes
    through shared memory; every other page keeps its bits."""
    spec = KVPageSpec(bs, layout, "bfloat16", 32, hd)
    rng = np.random.default_rng(bs)
    pool = _rand(rng, (32,) + spec.pool_shape(9), "bfloat16", cuda)
    before = pool.clone()
    canon = _rand(rng, (32, 1, bs, 32, hd), "bfloat16", cuda)
    ids = torch.tensor([6], dtype=torch.int32, device=cuda)
    want = ref.scatter_pages_ref(spec, pool.clone(), ids, canon)
    got = ops.scatter_pages(spec, pool, ids, canon)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    keep = [i for i in range(9) if i != 6]
    assert torch.equal(pool[:, keep], before[:, keep])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,canon_dt", DTYPE_PAIRS)
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_scatter_kernel_vector_widths(cuda, layout, pool_dt, canon_dt,
                                      offset):
    """Canon sliced at an element offset inside a wider buffer forces each
    vector width (offset 0: 16 bytes; 1, 2, 4 elements: that many); every
    width writes the plain version's bits and leaves other pages alone."""
    from repro_torch.kernels.kv_repack import scatter_vector_width
    spec = KVPageSpec(16, layout, pool_dt, 2, 32)
    rng = np.random.default_rng(offset)
    pool, ids = _pool_and_ids(rng, spec, 3, 13, 4, cuda)
    before = pool.clone()
    canon = _rand(rng, (3, 4, 16, 2, 40), canon_dt, cuda)[..., offset:
                                                          offset + 32]
    cap = 8 if pool_dt == canon_dt == "bfloat16" else 4
    assert scatter_vector_width(spec, pool, canon) == (
        min(cap, offset) if offset else cap)
    want = ref.scatter_pages_ref(spec, pool.clone(), ids, canon)
    got = ops.scatter_pages(spec, pool, ids, canon)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    keep = [i for i in range(13) if i not in ids.tolist()]
    assert torch.equal(pool[:, keep], before[:, keep])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,out_dt", DTYPE_PAIRS)
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_gather_kernel_vector_widths(cuda, layout, pool_dt, out_dt, offset):
    """A pool sliced at an element offset along its innermost axis inside
    a wider buffer forces each vector width where hd is that axis (offset
    0: 16 bytes; 1, 2, 4 elements: that many); nhdb pools go through the
    tile. Every width gives the plain version's bits."""
    from repro_torch.kernels.kv_repack import gather_vector_width
    spec = KVPageSpec(16, layout, pool_dt, 2, 32)
    rng = np.random.default_rng(offset + 7)
    page = spec.page_shape()
    wide = _rand(rng, (3, 13) + page[:-1] + (page[-1] + 8,), pool_dt, cuda)
    pool = wide[..., offset:offset + page[-1]]
    ids = torch.from_numpy(rng.permutation(np.arange(1, 13, 2))[:4]
                           .astype(np.int32)).to(cuda)
    cap = 8 if pool_dt == out_dt == "bfloat16" else 4
    out = torch.empty((3, 4, 16, 2, 32), dtype=TDT[out_dt], device=cuda)
    assert gather_vector_width(spec, pool, out) == (
        cap if layout == "nhdb" or offset == 0 else min(cap, offset))
    got = ops.gather_pages(spec, pool, ids, out_dtype=TDT[out_dt])
    want = ref.gather_pages_ref(spec, pool, ids, out_dtype=TDT[out_dt])
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pool_dt,out_dt", DTYPE_PAIRS)
def test_gather_kernel_any_strides(cuda, layout, pool_dt, out_dt):
    """A pool whose page axes lie in memory in the reverse of the layout's
    order (a permuted view), so hd is never the unit-stride axis: read
    through the tile path, bit-identical."""
    spec = KVPageSpec(32, layout, pool_dt, 4, 128)
    rng = np.random.default_rng(11)
    page = spec.page_shape()
    base = _rand(rng, (2, 9) + page[::-1], pool_dt, cuda)
    pool = base.permute(0, 1, 4, 3, 2)
    ids = torch.tensor([6, 1, 3], dtype=torch.int32, device=cuda)
    got = ops.gather_pages(spec, pool, ids, out_dtype=TDT[out_dt])
    want = ref.gather_pages_ref(spec, pool, ids, out_dtype=TDT[out_dt])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gather_kernel_cow_page(cuda, layout):
    """The copy-on-write shape: one page of each of 32 layers at llama2-7b
    widths (block 32, 32 heads, d 128), bf16."""
    spec = KVPageSpec(32, layout, "bfloat16", 32, 128)
    rng = np.random.default_rng(32)
    pool = _rand(rng, (32,) + spec.pool_shape(9), "bfloat16", cuda)
    ids = torch.tensor([6], dtype=torch.int32, device=cuda)
    got = ops.gather_pages(spec, pool, ids)
    want = ref.gather_pages_ref(spec, pool, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("src_layout,dst_layout", [("nhbd", "nbhd"),
                                                   ("nbhd", "nhdb"),
                                                   ("nhdb", "nhbd")])
@pytest.mark.parametrize("src_bs,dst_bs,seq", [(16, 32, 90), (32, 4, 61),
                                               (4, 16, 32)])
@pytest.mark.parametrize("src_dt,dst_dt", DTYPE_PAIRS)
@pytest.mark.parametrize("layers", [1, 32])
def test_repack_kernel(cuda, src_layout, dst_layout, src_bs, dst_bs, seq,
                       src_dt, dst_dt, layers):
    """Paper Fig. 3 across layouts, block sizes and dtypes, the last dst
    page's tail zeroed, through the gather and scatter kernels."""
    src = KVPageSpec(src_bs, src_layout, src_dt, 2, 16)
    dst = KVPageSpec(dst_bs, dst_layout, dst_dt, 2, 16)
    rng = np.random.default_rng(seq + layers)
    nb_s, nb_d = src.blocks_for(seq), dst.blocks_for(seq)
    src_pool, src_ids = _pool_and_ids(rng, src, layers, 2 * nb_s + 2, nb_s,
                                      cuda)
    dst_pool, dst_ids = _pool_and_ids(rng, dst, layers, 2 * nb_d + 2, nb_d,
                                      cuda)
    want = ref.repack_ref(src, dst, src_pool, src_ids, dst_pool.clone(),
                          dst_ids, seq)
    ops.reset_launch_counts()
    got = ops.repack(src, dst, src_pool, src_ids, dst_pool, dst_ids, seq)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (counts["gather_pages"], counts["scatter_pages"],
            counts["repack"]) == (1, 1, 1)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 32])
def test_cow_copy_in_place(cuda, layout, dtype, layers):
    """The prefix cache's copy-on-write: one page of a pool onto another
    page of the same pool; the source and every other page are untouched."""
    spec = KVPageSpec(32, layout, dtype, 4, 32)
    rng = np.random.default_rng(layers)
    pool = _rand(rng, (layers,) + spec.pool_shape(9), dtype, cuda)
    before = pool.clone()
    ids = torch.tensor([6, 2], dtype=torch.int32, device=cuda)
    ops.repack(spec, spec, pool, ids[:1], pool, ids[1:], 32)
    torch.cuda.synchronize()
    assert torch.equal(pool[:, 2], before[:, 6])
    keep = [i for i in range(9) if i != 2]
    assert torch.equal(pool[:, keep], before[:, keep])


@pytest.mark.parametrize("qk", [False, True])
def test_model_kernel_route_matches_plain_route(cuda, monkeypatch, qk):
    """Prefill, a chunk at an offset, and paged decode of a small dense
    model: kernels on the card against the plain route on the card."""
    cfg = config_from_dict(dict(
        name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        param_dtype="float32", compute_dtype="float32", qk_norm=qk,
        qkv_bias=qk))
    params = TM.init_params(cfg, seed=1, device=cuda)
    toks = torch.arange(3, 23, dtype=torch.int32, device=cuda)[None] % 128

    def run():
        caches = TM.init_caches(cfg, 1, 20, device=cuda)
        last, _ = TM.prefill(params, cfg, {"tokens": toks}, caches)
        dense = TM.init_caches(cfg, 1, 24, full_capacity=True, device=cuda)
        TM.decode_step(params, cfg, toks[:, :12],
                       torch.arange(12, device=cuda)[None], dense, q_offset=0)
        chunk, _ = TM.decode_step(params, cfg, toks[:, 12:],
                                  torch.arange(12, 20, device=cuda)[None],
                                  dense, q_offset=12)
        return last, chunk

    got = run()
    monkeypatch.setattr(TL, "kernel_route", lambda x: False)
    want = run()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=1e-4)


@pytest.mark.parametrize("chunk,wire", [(None, ("raw", "float32")),
                                        (7, ("raw", "bfloat16")),
                                        (7, ("int8", "bfloat16"))])
def test_serving_on_card_matches_cpu(cuda, chunk, wire):
    """The whole disaggregated path on the card (kernels) against the same
    path on the CPU (plain versions): a float32 model, heterogeneous P/D
    vendors, monolithic and misaligned streamed handoffs. Greedy tokens
    must be identical."""
    cfg = config_from_dict(dict(
        name="t", family="dense", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32"))
    params = TM.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (11, 16, 23)]

    def serve(dev, p):
        kw = dict(num_blocks=64, max_batch=4, max_seq_len=64, device=dev)
        pe = Engine("P0", cfg, p, VendorProfile("b", block_size=8,
                                                 layout="nhbd", tp=2),
                    role="prefill", **kw)
        de = Engine("D0", cfg, p, VendorProfile("a", block_size=4,
                                                 layout="nhdb", tp=1),
                    role="decode", **kw)
        sched = GlobalScheduler(DisaggPipeline(TransferEngine(),
                                               WireFormat(*wire)),
                                prefill_chunk=chunk, device=dev)
        sched.add_instance(pe)
        sched.add_instance(de)
        reqs = [Request(f"r{i}", pr, 6) for i, pr in enumerate(prompts)]
        Server(sched).serve(reqs)
        return [r.output_tokens for r in reqs]

    ops.reset_launch_counts()
    got = serve(cuda, params)
    counts = ops.launch_counts()
    want = serve(torch.device("cpu"), _to_cpu(params))
    assert got == want and all(len(t) == 6 for t in got)
    # this path (no prefix cache) runs exactly the attention kernels and
    # the overlay re-page
    launched = {k for k, n in counts.items() if n > 0}
    assert launched == {"flash_attention", "paged_attention",
                        "scatter_pages_overlay"}, counts


def test_cached_serving_on_card_matches_cold(cuda):
    """The prefix cache on the card: requests sharing a prefix that ends
    inside a D block, served one at a time with the cache and without it,
    give identical tokens; the cached run skipped the wire for the shared
    tokens and copied the divergence page with the repack kernel."""
    cfg = config_from_dict(dict(
        name="t", family="dense", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32"))
    params = TM.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(5)
    head = rng.integers(0, 256, 42).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, 256, n).astype(np.int32)])
               for n in (9, 5, 3)]

    def serve(prefix_cache):
        kw = dict(num_blocks=64, max_batch=4, max_seq_len=96, device=cuda,
                  prefix_cache=prefix_cache)
        pe = Engine("P0", cfg, params, VendorProfile("b", block_size=8,
                                                      layout="nhbd", tp=2),
                    role="prefill", **kw)
        de = Engine("D0", cfg, params, VendorProfile("a", block_size=16,
                                                      layout="nhdb", tp=1),
                    role="decode", **kw)
        pipe = DisaggPipeline(TransferEngine(), WireFormat("raw", "float32"))
        sched = GlobalScheduler(pipe, prefill_chunk=14, device=cuda)
        sched.add_instance(pe)
        sched.add_instance(de)
        reqs = [Request(f"r{i}", pr, 6) for i, pr in enumerate(prompts)]
        for r in reqs:                         # one at a time
            sched.submit(r)
            for _ in range(500):
                if r.state.value == "finished":
                    break
                sched.step()
        return [r.output_tokens for r in reqs], pipe.transfer.stats, pe.stats

    cold, _, _ = serve(False)
    ops.reset_launch_counts()
    got, wire, p_stats = serve(True)
    counts = ops.launch_counts()
    assert got == cold and all(len(t) == 6 for t in got)
    assert wire.prefix_hit_tokens == 2 * 42          # 2 full blocks + 10 COW
    assert p_stats.prefix_cached_tokens >= 2 * 40
    assert counts["repack"] == counts["gather_pages"] == \
        counts["scatter_pages"] == 2 * 2             # k, v per cached request
    assert counts.pop("flash_decode") == 0          # dense decode caches only
    assert all(n > 0 for n in counts.values()), counts


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_cpu(v) for v in tree)
    return tree.cpu()


MLA_TINY = dict(name="mla-t", family="dense", num_layers=3, d_model=64,
                num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                vocab_size=256, attention_kind="mla",
                mla=dict(kv_lora_rank=32, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16),
                param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("chunk,wire,prefix_cache", [
    (None, ("raw", "float32"), False), (7, ("raw", "bfloat16"), False),
    (7, ("int8", "bfloat16"), False), (8, ("raw", "float32"), True)])
def test_mla_serving_on_card_matches_cpu(cuda, moe, chunk, wire,
                                         prefix_cache):
    """MLA (tiny: q/k 24, v 16 wide, latent 32 + 8, float32, so the
    float32 flash kernel; with ``moe`` a DeepSeek-shaped MoE of 4 experts
    top 2, one shared, a dense first layer) disaggregated on the card
    against the same path on the CPU: greedy tokens identical; exactly
    flash, the overlay and gather launch (and with the prefix cache the
    copy-on-write page copy's gather, scatter and repack)."""
    kw = dict(MLA_TINY)
    if moe:
        kw.update(family="moe", moe=dict(num_experts=4, num_shared_experts=1,
                                         top_k=2, d_ff_expert=32,
                                         first_dense_layers=1))
    cfg = config_from_dict(kw)
    params = TM.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(12)
    head = rng.integers(0, 256, 18).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, 256, n).astype(np.int32)])
               if prefix_cache else rng.integers(0, 256, 11 + n)
               .astype(np.int32) for n in (3, 7, 12)]

    def serve(dev, p):
        ekw = dict(num_blocks=64, max_batch=4, max_seq_len=64, device=dev,
                   prefix_cache=prefix_cache)
        pe = Engine("P0", cfg, p, VendorProfile("b", block_size=8,
                                                 layout="nhbd", tp=2),
                    role="prefill", **ekw)
        de = Engine("D0", cfg, p, VendorProfile("a", block_size=4,
                                                 layout="nhdb", tp=1),
                    role="decode", **ekw)
        sched = GlobalScheduler(DisaggPipeline(TransferEngine(),
                                               WireFormat(*wire)),
                                prefill_chunk=chunk, device=dev)
        sched.add_instance(pe)
        sched.add_instance(de)
        out = []
        for i, pr in enumerate(prompts):     # one by one: the cache hits
            req = Request(f"r{i}", pr, 6)
            sched.submit(req)
            for _ in range(400):
                if req.done:
                    break
                sched.step()
            out.append(req.output_tokens)
        return out

    ops.reset_launch_counts()
    got = serve(cuda, params)
    counts = ops.launch_counts()
    want = serve(torch.device("cpu"), _to_cpu(params))
    assert got == want and all(len(t) == 6 for t in got)
    launched = {k for k, n in counts.items() if n > 0}
    expect = {"flash_attention", "gather_pages", "scatter_pages_overlay"}
    if prefix_cache:
        expect |= {"scatter_pages", "repack"}
    assert launched == expect, counts


HYBRID_TINY = dict(name="hy-t", family="hybrid", num_layers=5, d_model=64,
                   num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
                   vocab_size=256, attention_kind="sliding", sliding_window=8,
                   recurrent=dict(lru_width=48, d_conv=4,
                                  block_pattern=("rglru", "rglru", "attn")),
                   param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("chunk,wire", [(None, ("raw", "float32")),
                                        (7, ("raw", "bfloat16")),
                                        (4, ("int8", "bfloat16"))])
def test_hybrid_serving_on_card_matches_cpu(cuda, chunk, wire):
    """The hybrid RG-LRU family (tiny: (rglru, rglru, attn) then (rglru,
    rglru), 4 query heads on one KV head, window 8, float32) disaggregated
    on the card against the same path on the CPU: the recurrent states
    carried across chunks and shipped as the stream's tail, greedy tokens
    identical; exactly flash, paged and the overlay launch."""
    cfg = config_from_dict(HYBRID_TINY)
    params = TM.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (11, 23, 30)]

    def serve(dev, p):
        kw = dict(num_blocks=64, max_batch=4, max_seq_len=64, device=dev)
        pe = Engine("P0", cfg, p, VendorProfile("b", block_size=8,
                                                 layout="nhbd", tp=1),
                    role="prefill", **kw)
        de = Engine("D0", cfg, p, VendorProfile("a", block_size=4,
                                                 layout="nhdb", tp=1),
                    role="decode", **kw)
        sched = GlobalScheduler(DisaggPipeline(TransferEngine(),
                                               WireFormat(*wire)),
                                prefill_chunk=chunk, device=dev)
        sched.add_instance(pe)
        sched.add_instance(de)
        reqs = [Request(f"r{i}", pr, 6) for i, pr in enumerate(prompts)]
        Server(sched).serve(reqs)
        return [r.output_tokens for r in reqs]

    ops.reset_launch_counts()
    got = serve(cuda, params)
    counts = ops.launch_counts()
    want = serve(torch.device("cpu"), _to_cpu(params))
    assert got == want and all(len(t) == 6 for t in got)
    launched = {k for k, n in counts.items() if n > 0}
    assert launched == {"flash_attention", "paged_attention",
                        "scatter_pages_overlay"}, counts


def _one_row_kernels(lens, chunk):
    """{"flash_decode"} when a prefill stream of one of ``lens`` positions
    in ``chunk``-position chunks (incremental when chunk < its length)
    ends in a chunk of exactly one row: ``attention_decode`` sends one
    query row to flash_decode. Else nothing."""
    one_row = chunk is not None and any(n > chunk and n % chunk == 1
                                        for n in lens)
    return {"flash_decode"} if one_row else set()


def _family_serving(cuda, cfg, prompts, chunk, wire, p_tp=2, mem_len=0,
                    extra=None):
    """A tiny float32 family disaggregated on the card (kernels) and on
    the CPU (plain versions) behind the scheduler, P (8, nhbd, ``p_tp``)
    and D (4, nhdb): the greedy tokens must be identical. ``extra(req,
    i)`` adds a request's patches or frames. Returns the kernels the card
    run launched."""
    params = TM.init_params(cfg, seed=0, device=cuda)

    def serve(dev, p):
        kw = dict(num_blocks=64, max_batch=4, max_seq_len=64,
                  mem_len=mem_len, device=dev)
        pe = Engine("P0", cfg, p, VendorProfile("b", block_size=8,
                                                 layout="nhbd", tp=p_tp),
                    role="prefill", **kw)
        de = Engine("D0", cfg, p, VendorProfile("a", block_size=4,
                                                 layout="nhdb", tp=1),
                    role="decode", **kw)
        sched = GlobalScheduler(DisaggPipeline(TransferEngine(),
                                               WireFormat(*wire)),
                                prefill_chunk=chunk, device=dev)
        sched.add_instance(pe)
        sched.add_instance(de)
        reqs = [Request(f"r{i}", pr, 6) for i, pr in enumerate(prompts)]
        for i, r in enumerate(reqs):
            if extra is not None:
                extra(r, i)
        Server(sched).serve(reqs)
        return [r.output_tokens for r in reqs]

    ops.reset_launch_counts()
    got = serve(cuda, params)
    counts = ops.launch_counts()
    want = serve(torch.device("cpu"), _to_cpu(params))
    assert got == want and all(len(t) == 6 for t in got)
    return {k for k, n in counts.items() if n > 0}


SSM_TINY = dict(name="ssm-t", family="ssm", num_layers=3, d_model=64,
                num_heads=8, num_kv_heads=0, head_dim=16, d_ff=0,
                vocab_size=256, attention_kind="none",
                ssm=dict(d_state=16, head_dim=16, expand=2, d_conv=4,
                         chunk_size=4),
                param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("chunk,wire", [(None, ("raw", "float32")),
                                        (7, ("raw", "bfloat16")),
                                        (4, ("int8", "bfloat16"))])
def test_ssm_serving_on_card_matches_cpu(cuda, chunk, wire):
    """The Mamba-2 SSD family (tiny: 3 SSD layers, 8 heads of 16, d_state
    16, chunk 4, float32) disaggregated on the card against the CPU: the
    states carried across chunks and shipped as the tail, no KV on the
    wire, greedy tokens identical; no kernel launches."""
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (11, 23, 30)]
    assert _family_serving(cuda, config_from_dict(SSM_TINY), prompts, chunk,
                           wire, p_tp=1) == set()


VLM_TINY = dict(name="vlm-t", family="vlm", num_layers=3, d_model=64,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=256, frontend=dict(kind="vision", num_patches=4),
                param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("chunk,wire", [(None, ("raw", "float32")),
                                        (6, ("raw", "bfloat16")),
                                        (3, ("int8", "bfloat16"))])
def test_vlm_serving_on_card_matches_cpu(cuda, chunk, wire):
    """The vision frontend (tiny: 4 patches before each prompt, 4 heads on
    2 KV heads, float32) disaggregated on the card against the CPU: P's
    chunks slice the merged sequence and one of them spans the patch/text
    boundary (6: positions 0-5; 3: positions 3-5), greedy tokens
    identical; exactly flash, paged and the overlay launch, and
    flash_decode where a stream ends in a one-row chunk (13 and 25
    positions in chunks of 6 or 3)."""
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 14, 21)]
    patches = [rng.standard_normal((4, 64)).astype(np.float32)
               for _ in prompts]

    def extra(req, i):
        req.patches = patches[i]

    assert _family_serving(cuda, config_from_dict(VLM_TINY), prompts, chunk,
                           wire, extra=extra) == {
        "flash_attention", "paged_attention", "scatter_pages_overlay",
        *_one_row_kernels([4 + len(p) for p in prompts], chunk)}


ENCDEC_TINY = dict(name="encdec-t", family="audio", num_layers=3,
                   encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                   head_dim=16, d_ff=128, vocab_size=256,
                   frontend=dict(kind="audio"),
                   param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("chunk,wire", [(None, ("raw", "float32")),
                                        (4, ("raw", "bfloat16")),
                                        (7, ("int8", "bfloat16"))])
def test_encdec_serving_on_card_matches_cpu(cuda, chunk, wire):
    """The encoder-decoder family (tiny: 2 encoder + 3 decoder layers, 10
    frames a request in 12 memory rows, float32) disaggregated on the
    card against the CPU: the encoder through flash non-causal, each
    chunk's cross-attention through flash at kv_len 10, the memory rows
    shipped as the tail and D's per-slot cross-attention in plain ops;
    greedy tokens identical; exactly flash, paged and the overlay
    launch, and flash_decode for the self-attention of a one-row chunk
    (9 and 21 positions in chunks of 4)."""
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 14, 21)]
    frames = [rng.standard_normal((10, 64)).astype(np.float32)
              for _ in prompts]

    def extra(req, i):
        req.frames = frames[i]

    assert _family_serving(cuda, config_from_dict(ENCDEC_TINY), prompts,
                           chunk, wire, mem_len=12, extra=extra) == {
        "flash_attention", "paged_attention", "scatter_pages_overlay",
        *_one_row_kernels([len(p) for p in prompts], chunk)}


# --------------------------------------------------------------------------- #
# Training on the card: the plain attention route, no kernel
# --------------------------------------------------------------------------- #
_TINY = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
             head_dim=16, d_ff=128, vocab_size=128, param_dtype="float32",
             compute_dtype="float32")
# tests/conftest.py's TINY_FAMILIES, as dicts (that file imports JAX)
TRAIN_FAMILIES = {
    "dense": dict(family="dense"),
    "dense-bias-qknorm": dict(family="dense", qkv_bias=True, qk_norm=True,
                              num_kv_heads=2),
    "sliding": dict(family="dense", attention_kind="sliding",
                    sliding_window=8),
    "mla": dict(family="dense", attention_kind="mla",
                mla=dict(kv_lora_rank=32, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16)),
    "moe": dict(family="moe", moe=dict(num_experts=4, num_shared_experts=1,
                                       top_k=2, d_ff_expert=32,
                                       first_dense_layers=1)),
    "hybrid": dict(family="hybrid", attention_kind="sliding",
                   sliding_window=8, num_layers=5,
                   recurrent=dict(lru_width=64, d_conv=4,
                                  block_pattern=("rglru", "rglru", "attn"))),
    "ssm": dict(family="ssm", attention_kind="none", num_kv_heads=0, d_ff=0,
                num_heads=8, ssm=dict(d_state=16, head_dim=16, expand=2,
                                      d_conv=4, chunk_size=4)),
    "encdec": dict(family="audio", encoder_layers=2,
                   frontend=dict(kind="audio")),
    "vlm": dict(family="vlm", num_kv_heads=2,
                frontend=dict(kind="vision", num_patches=4)),
}


@pytest.mark.parametrize("family", sorted(TRAIN_FAMILIES))
def test_train_step_on_card_matches_cpu(cuda, family):
    """One float32 train step of each tiny family on the card against the
    same step on the CPU: loss within rtol 1e-5, every leaf's gradient
    within rtol 1e-4 and an atol of 1e-5 times its largest element (at
    least 1e-5: the tiny families' gradients reach 5, and float32 sums in
    another order differ by a few ulps of the leaf's scale), parameters
    after the step within atol 5e-3 at lr 1e-3 (tests/test_training.py's
    bound); no kernel launches."""
    from repro_torch.training import optim as TO
    from repro_torch.training import train_step as TT
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.tree import leaves
    cfg = config_from_dict(dict(_TINY, name=family, **TRAIN_FAMILIES[family]))
    host = next(iter(SyntheticTokens(cfg, DataConfig(batch_size=2,
                                                     seq_len=16, seed=0))))
    opt = TO.AdamWConfig(lr=1e-3, warmup_steps=0)

    def run(dev):
        state = TT.train_state_init(cfg, seed=0, device="cpu")
        state = TT.TrainState(*(_to_dev(t, dev) for t in (state.params,
                                                         state.opt)))
        batch = TT.device_batch(host, dev)
        _, grads = TT.loss_and_grads(cfg, state.params, batch)
        state, m = TT.make_train_step(cfg, opt)(state, batch)
        return (float(m["loss"]), [g.cpu() for g in leaves(grads)],
                [p.cpu() for p in leaves(state.params)])

    ops.reset_launch_counts()
    loss, grads, params = run(cuda)
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    loss0, grads0, params0 = run(torch.device("cpu"))
    np.testing.assert_allclose(loss, loss0, rtol=1e-5)
    for g, g0 in zip(grads, grads0):
        scale = max(1.0, float(g0.abs().max()))
        np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale)
    for p, p0 in zip(params, params0):
        np.testing.assert_allclose(p.numpy(), p0.numpy(), atol=5e-3)


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_dev(v, dev) for v in tree)
    return tree.to(dev)


def _grad_inputs(cuda):
    """One small call of each ``ops`` wrapper: (name, fn(grad_input))."""
    rng = np.random.default_rng(40)
    spec = KVPageSpec(4, "nbhd", "float32", 2, 16)
    pool, ids = _pool_and_ids(rng, spec, 1, 8, 2, cuda)
    canon = _rand(rng, (1, 2, 4, 2, 16), "float32", cuda)
    q4 = _rand(rng, (1, 2, 8, 16), "float32", cuda)
    q3 = _rand(rng, (2, 2, 16), "float32", cuda)
    table = torch.tensor([[1, 3], [5, 7]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([6, 8], dtype=torch.int32, device=cuda)
    ring_pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    return [
        ("flash_attention", q4, lambda x: ops.flash_attention(x, q4, q4)),
        ("flash_decode", q4,
         lambda x: ops.cache_attention(
             x[:, :, :1].transpose(1, 2), q4.transpose(1, 2),
             q4.transpose(1, 2), ring_pos, q_offset=7, window=4)),
        ("paged_attention", pool[0],
         lambda x: ops.paged_attention(q3, x, pool[0], table, lens)),
        ("scatter_pages_overlay", canon,
         lambda x: ops.scatter_pages_overlay(spec, pool.clone(), ids, x,
                                             front=0, seq_len=8)),
        ("gather_pages", pool, lambda x: ops.gather_pages(spec, x, ids)),
        ("scatter_pages", canon,
         lambda x: ops.scatter_pages(spec, pool.clone(), ids, x)),
        ("repack", pool,
         lambda x: ops.repack(spec, spec, x, ids, pool.clone(), ids, 8)),
    ]


@pytest.mark.parametrize("op", ["flash_attention", "flash_decode",
                                "paged_attention", "scatter_pages_overlay",
                                "gather_pages", "scatter_pages", "repack"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda, op):
    """The kernels have no backward pass: a CUDA input that requires grad
    raises while grad mode is on (the output would carry no gradient), and
    launches under ``torch.no_grad()``."""
    name, x, call = next(c for c in _grad_inputs(cuda) if c[0] == op)
    live = x.detach().clone().requires_grad_()
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward pass"):
        call(live)
    assert ops.launch_counts()[name] == 0
    with torch.no_grad():
        call(live)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == 1


def test_attention_block_serving_route_still_launches_flash(cuda):
    """``attention_block`` on a CUDA tensor launches flash once (the serving
    route); ``plain=True`` launches nothing and agrees within 1e-5; the
    kernel route refuses parameters that require grad."""
    cfg = config_from_dict(dict(_TINY, name="t", family="dense",
                                num_kv_heads=2, qk_norm=True))
    params = TM.init_params(cfg, seed=3, device=cuda)
    p = params["groups"][0][0]["attn"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((2, 24, 64), generator=torch.Generator(device=cuda)
                    .manual_seed(0), device=cuda)
    pos = torch.arange(24, device=cuda)[None].expand(2, 24)
    ops.reset_launch_counts()
    got, _ = TL.attention_block(p, cfg, x, pos)
    assert ops.launch_counts()["flash_attention"] == 1
    want, _ = TL.attention_block(p, cfg, x, pos, plain=True)
    assert ops.launch_counts()["flash_attention"] == 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5)
    live = {k: v.detach().requires_grad_() for k, v in p.items()}
    with pytest.raises(RuntimeError, match="no backward pass"):
        TL.attention_block(live, cfg, x, pos)


# --------------------------------------------------------------------------- #
# The launch layer (step builders, the capacity MoE, flash at 32k keys)
# --------------------------------------------------------------------------- #
# Flash over 32k keys averages thousands of V rows, so its outputs are
# near 0.01 for unit normal inputs: an absolute bf16 tolerance would pass
# a kernel that drops keys. Its error is held relative to the output's
# size instead: max error at most 2**-5 of the largest |output|, mean
# error at most 2**-7 of the mean |output|. Rounding P to bf16 (what
# flash does) gives about 0.3 % and 0.2 % at these shapes; dropping half
# the keys gives about 100 %.
FLASH_32K_MAX, FLASH_32K_MEAN = 2.0 ** -5, 2.0 ** -7


def _close_to_size(got, want):
    err = (got.float() - want).abs()
    size = want.abs()
    assert float(err.max()) <= FLASH_32K_MAX * float(size.max()), \
        (float(err.max()), float(size.max()))
    assert float(err.mean()) <= FLASH_32K_MEAN * float(size.mean()), \
        (float(err.mean()), float(size.mean()))


def test_flash_at_32k_keys_against_plain_rows(cuda):
    """Flash at 32,768 causal keys in bf16 (the launch prefill's length):
    the last 256 query rows against the float32 plain version of those
    rows (the plain version cannot hold all of them), and one query row at
    q_offset 32,768 over a 32,896-slot cache given as the decode step
    gives it (sequence-major, transposed), within FLASH_32K_MAX and
    FLASH_32K_MEAN of the output's size."""
    rng = np.random.default_rng(32)
    s, rows = 32768, 256
    q = _rand(rng, (1, 4, s, 128), "bfloat16", cuda)
    k = _rand(rng, (1, 2, s, 128), "bfloat16", cuda)
    v = _rand(rng, (1, 2, s, 128), "bfloat16", cuda)
    got = ops.flash_attention(q, k, v, causal=True)[:, :, s - rows:]
    want = ref.flash_attention_ref(q[:, :, s - rows:].float(), k.float(),
                                   v.float(), causal=True, q_offset=s - rows)
    torch.cuda.synchronize()
    _close_to_size(got, want)
    cap = s + 128
    cache = _rand(rng, (1, cap, 2, 128), "bfloat16", cuda)
    q1 = _rand(rng, (1, 4, 1, 128), "bfloat16", cuda)
    kt = cache.transpose(1, 2)
    got = ops.flash_attention(q1, kt, kt, causal=True, q_offset=s,
                              kv_len=cap)
    want = ref.flash_attention_ref(q1.float(), kt.float(), kt.float(),
                                   causal=True, q_offset=s, kv_len=cap)
    torch.cuda.synchronize()
    _close_to_size(got, want)


def test_flash_refuses_float8_kv(cuda):
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 2, 8, 64), device=cuda).to(torch.float8_e4m3fn)
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="ops.cache_attention"):
        ops.flash_attention(q, k, k)
    assert ops.launch_counts()["flash_attention"] == 0


def test_fp8_cast_on_card_equals_cpu(cuda):
    """The handoff's float8 cast: the card's bits equal the CPU's over
    every bf16 value (saturation past ±448 included)."""
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    x = x[torch.isfinite(x)]
    got = x.to(cuda).to(torch.float8_e4m3fn).view(torch.uint8).cpu()
    want = x.to(torch.float8_e4m3fn).view(torch.uint8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_moe_on_card_matches_cpu(cuda, dtype):
    """``_moe_mlp_capacity`` (the launch layer's MoE) on the card against
    the CPU on the same inputs: float32 within 1e-5, bf16 within 2e-2;
    two runs on the card give the same bits (the combine has no atomics)."""
    cfg = config_from_dict(dict(_TINY, name="moe", param_dtype=dtype,
                                compute_dtype=dtype,
                                **TRAIN_FAMILIES["moe"]))
    p = TM.init_params(cfg, seed=1, device="cpu")["groups"][1][0]["mlp"]
    p = {k: (v[0] if isinstance(v, torch.Tensor)
             else {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    x = _rand(np.random.default_rng(5), (2, 40, 64), dtype, "cpu")
    want = TL._moe_mlp_capacity(p, cfg, x, capacity_factor=1.0)
    pc = {k: (v.to(cuda) if isinstance(v, torch.Tensor)
              else {kk: vv.to(cuda) for kk, vv in v.items()})
          for k, v in p.items()}
    got = TL._moe_mlp_capacity(pc, cfg, x.to(cuda), capacity_factor=1.0)
    again = TL._moe_mlp_capacity(pc, cfg, x.to(cuda), capacity_factor=1.0)
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(),
                               atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("family", ["dense-bias-qknorm", "mla", "moe"])
def test_launch_steps_on_card_match_cpu(cuda, family, monkeypatch):
    """The launch prefill → handoff → serve step of a tiny float32 family
    (batch 2 x 24) on the one-card mesh against the CPU's: logits within
    1e-4 (the float32 flash kernel against the plain route), D's caches
    within 1e-5; flash launches on the card only."""
    import dataclasses
    from repro_torch.launch import cells as TC
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import named_leaves
    cfg = config_from_dict(dict(_TINY, name=family, **TRAIN_FAMILIES[family]))
    cells = {s: dataclasses.replace(TC.get_cell("qwen3-4b", s), batch=2,
                                    seq_len=24, cache_dtype="float32")
             for s in ("prefill_32k", "decode_32k")}
    monkeypatch.setattr(TS, "get_config", lambda arch: cfg)
    monkeypatch.setattr(TS, "get_cell", lambda arch, shape: cells[shape])
    params = TM.init_params(cfg, seed=2, device="cpu")

    def run(dev):
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        pre = TS.make_prefill_artifacts(cells["prefill_32k"], mesh)
        srv = TS.make_serve_artifacts(cells["decode_32k"], mesh)
        ho = TS.make_handoff_artifacts("qwen3-4b", mesh, batch=2)
        inputs = TS.random_inputs(pre.abstract_args[1], cfg.vocab_size, 0,
                                  mesh.device)
        p = _to_dev(params, mesh.device)
        with torch.no_grad():
            last, caches = pre.fn(p, inputs)
            caches = ho.fn(caches)
            tok = last.argmax(-1).to(torch.int32)[:, None]
            io = {"tokens": tok, "positions": torch.full_like(tok, 24)}
            logits, caches = srv.fn(p, caches, io)
        return (last.cpu(), logits.cpu(),
                [x.cpu() for _, x in named_leaves(caches)])

    ops.reset_launch_counts()
    got = run(cuda)
    assert ops.launch_counts()["flash_attention"] > 0
    want = run(torch.device("cpu"))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   atol=1e-5)


def _launch_serve(cfg, cells, params, dev, steps, monkeypatch,
                  plain_decode=False):
    """The launch prefill → handoff → ``steps`` serve steps on the one-card
    mesh of ``dev`` (tokens after the first fixed, so two runs decode the
    same inputs): (the steps' logits on the CPU, D's caches after them).
    ``plain_decode``: the serve steps on the plain route."""
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import make_mesh
    monkeypatch.setattr(TS, "get_config", lambda arch: cfg)
    monkeypatch.setattr(TS, "get_cell", lambda arch, shape: cells[shape])
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    pre = TS.make_prefill_artifacts(cells["prefill_32k"], mesh)
    srv = TS.make_serve_artifacts(cells["decode_32k"], mesh)
    ho = TS.make_handoff_artifacts("qwen3-4b", mesh, batch=2)
    inputs = TS.random_inputs(pre.abstract_args[1], cfg.vocab_size, 0, dev)
    p = _to_dev(params, dev)
    s = cells["prefill_32k"].seq_len
    out = []
    with torch.no_grad():
        last, caches = pre.fn(p, inputs)
        caches = ho.fn(caches)
        tok = last.argmax(-1).to(torch.int32)[:, None]
        with monkeypatch.context() as m:
            if plain_decode:
                m.setattr(TL, "kernel_route", lambda x: False)
            for i in range(steps):
                io = {"tokens": tok, "positions": torch.full_like(tok, s + i)}
                logits, caches = srv.fn(p, caches, io, q_offset=s + i)
                out.append(logits.float().cpu())
                tok = torch.full_like(tok, 5 + i)
    return out, caches


def _tiny_cells(cache_p, cache_d):
    import dataclasses
    from repro_torch.launch import cells as TC
    return {"prefill_32k": dataclasses.replace(
                TC.get_cell("qwen3-4b", "prefill_32k"), batch=2, seq_len=24,
                cache_dtype=cache_p),
            "decode_32k": dataclasses.replace(
                TC.get_cell("qwen3-4b", "decode_32k"), batch=2, seq_len=24,
                cache_dtype=cache_d)}


def _attending(cfg):
    return sum(g.count * sum(k == TM.ATTN for k in g.kinds)
               for g in TM.block_groups(cfg))


@pytest.mark.parametrize("family", ["sliding", "hybrid"])
def test_launch_serve_step_on_ring_caches_matches_cpu(cuda, family,
                                                      monkeypatch):
    """A tiny float32 family whose D caches are rings of its window
    (sliding, hybrid): the launch prefill → handoff → 3 serve steps on the
    card against the CPU; one flash_decode launch a layer that attends and
    step; logits within 1e-4, D's caches (rings and states) within 1e-5."""
    from repro_torch.launch.sharding import named_leaves
    cfg = config_from_dict(dict(_TINY, name=family, **TRAIN_FAMILIES[family]))
    cells = _tiny_cells("float32", "float32")
    params = TM.init_params(cfg, seed=2, device="cpu")
    ops.reset_launch_counts()
    got, gc = _launch_serve(cfg, cells, params, cuda, 3, monkeypatch)
    assert ops.launch_counts()["flash_decode"] == _attending(cfg) * 3
    want, wc = _launch_serve(cfg, cells, params, torch.device("cpu"), 3,
                             monkeypatch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4)
    for (_, g), (_, w) in zip(named_leaves(gc), named_leaves(wc)):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().numpy(), atol=1e-5)


def test_launch_serve_step_on_float8_caches_matches_plain_route(cuda,
                                                                monkeypatch):
    """The tiny dense family in bfloat16 with a float8 D cache (the
    handoff's cast): from one handoff on the card, 3 serve steps through
    flash_decode (one launch a layer and step) against the same steps on
    the plain route (``sdpa`` over the float8 cache widened to float32);
    logits within 2e-2."""
    cfg = config_from_dict(dict(_TINY, name="dense", family="dense",
                                param_dtype="bfloat16",
                                compute_dtype="bfloat16"))
    cells = _tiny_cells("bfloat16", "float8_e4m3fn")
    params = TM.init_params(cfg, seed=2, device="cpu")
    ops.reset_launch_counts()
    got, caches = _launch_serve(cfg, cells, params, cuda, 3, monkeypatch)
    assert ops.launch_counts()["flash_decode"] == cfg.num_layers * 3
    assert all(c.k.dtype == torch.float8_e4m3fn for g in caches for c in g)
    want, _ = _launch_serve(cfg, cells, params, cuda, 3, monkeypatch,
                            plain_decode=True)
    assert ops.launch_counts()["flash_decode"] == cfg.num_layers * 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-2)


# --------------------------------------------------------------------------- #
# flash_decode: decode attention over rings and float8 caches
# --------------------------------------------------------------------------- #
# (capacity, positions written) as tests/test_torch_cache_attention.py: a
# ring filled to an unaligned length (starting mid-buffer), a partly filled
# ring (pos -1), a full-capacity cache with room left
DECODE_FILLS = {"ring": (16, 37), "ring_partial": (16, 10),
                "full": (48, 37)}
DECODE_GROUPS = [(2, 2, 64), (2, 8, 128), (1, 16, 256)]
# the main path's sizes, batch 2, one row: (name, capacity, positions
# written, KV heads, query heads, head dim, window, K/V dtype)
DECODE_MAIN = [
    ("mixtral", 4096, 34_000, 8, 32, 128, 4096, torch.bfloat16),
    ("recurrentgemma", 2048, 34_000, 1, 16, 256, 2048, torch.bfloat16),
    ("qwen1.5-32b", 32_896, 32_769, 40, 40, 128, 0, torch.float8_e4m3fn),
    ("qwen3-4b", 32_896, 32_769, 8, 32, 128, 0, torch.bfloat16)]


def _decode_cache(rng, b, cap, n, kvh, hd, kv_dtype, device):
    """K/V (b, cap, kvh, hd) of unit normals cast to ``kv_dtype`` and pos
    tags of positions 0..n-1 at slot position % cap (-1 where none)."""
    k = torch.from_numpy(rng.standard_normal((b, cap, kvh, hd))
                         .astype(np.float32)).to(device)
    v = torch.from_numpy(rng.standard_normal((b, cap, kvh, hd))
                         .astype(np.float32)).to(device)
    pos = torch.full((cap,), -1, dtype=torch.int32)
    held = torch.arange(max(0, n - cap), n, dtype=torch.int32)
    pos[held.long() % cap] = held
    return (k.to(kv_dtype), v.to(kv_dtype),
            pos[None].expand(b, cap).contiguous().to(device))


@pytest.mark.parametrize("dtypes", ["float32", "bfloat16", "bf16-e4m3"])
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("kvh,h,hd", DECODE_GROUPS)
@pytest.mark.parametrize("fill", sorted(DECODE_FILLS))
def test_flash_decode_kernel(cuda, fill, kvh, h, hd, window, sq, dtypes):
    """The kernel against its plain version on the same CUDA tensors:
    float32 within 2e-5, bfloat16 (and float8 K/V under a bf16 q, widened
    exactly on both sides) within 2e-2; one launch a call."""
    cap, n = DECODE_FILLS[fill]
    q_dt = torch.float32 if dtypes == "float32" else torch.bfloat16
    kv_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "bf16-e4m3": torch.float8_e4m3fn}[dtypes]
    rng = np.random.default_rng(cap + hd + window + sq)
    k, v, pos = _decode_cache(rng, 2, cap, n, kvh, hd, kv_dt, cuda)
    q = torch.from_numpy(rng.standard_normal((2, sq, h, hd))
                         .astype(np.float32)).to(cuda, q_dt)
    ops.reset_launch_counts()
    got = ops.cache_attention(q, k, v, pos, q_offset=n - sq, window=window)
    assert ops.launch_counts()["flash_decode"] == 1
    want = ref.cache_attention_ref(q, k, v, pos, q_offset=n - sq,
                                   window=window)
    torch.cuda.synchronize()
    assert got.dtype == q_dt and got.shape == (2, sq, h, hd)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=2e-5 if dtypes == "float32" else 2e-2)


@pytest.mark.parametrize("name,cap,n,kvh,h,hd,window,kv_dt", DECODE_MAIN)
def test_flash_decode_kernel_at_the_main_path_sizes(cuda, name, cap, n, kvh,
                                                    h, hd, window, kv_dt):
    """The rings of Mixtral (start at slot 1232) and RecurrentGemma (a
    group of 16 x 256 on one KV head), Qwen1.5-32B's float8 cache of
    32,896 slots (128 empty) and Qwen3-4B's bf16 one (the one-row dense
    decode's shape), many splits combined: bf16 against the float32
    plain version within FLASH_32K_MAX
    and FLASH_32K_MEAN of the output's size (a weighted mean over
    thousands of slots, about 0.01-0.04 for unit normals, so a flat
    tolerance would pass a kernel that drops tiles of slots; one 32-slot
    tile dropped puts the mean error several times past the bound)."""
    rng = np.random.default_rng(cap + h)
    k, v, pos = _decode_cache(rng, 2, cap, n, kvh, hd, kv_dt, cuda)
    q = torch.from_numpy(rng.standard_normal((2, 1, h, hd))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    got = ops.cache_attention(q, k, v, pos, q_offset=n - 1, window=window)
    want = ref.cache_attention_ref(q.float(), k.float(), v.float(), pos,
                                   q_offset=n - 1, window=window)
    torch.cuda.synchronize()
    _close_to_size(got, want)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_decode_widens_every_e4m3_code_exactly(cuda, hd):
    """Every e4m3 byte in V's rows under one visible slot (its softmax
    weight exactly 1, so each output element is the widened value
    rounded once to bf16, which changes nothing): the kernel's widening
    equals torch's ``.to(torch.bfloat16)`` on all 254 finite codes (the
    same bits, but +0 for -0), and the two NaN codes stay NaN. The 256
    codes fill 256 / hd rows four times over, rolled, so each code meets
    several lane and byte positions."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    rows = torch.cat([codes.roll(17 * r).view(256 // hd, hd)
                      for r in range(4)])
    kvh = rows.shape[0]
    v = torch.zeros((1, 8, kvh, hd), dtype=torch.uint8)
    v[0, 3] = rows
    v = v.view(torch.float8_e4m3fn).to(cuda)
    k = torch.zeros_like(v)
    pos = torch.full((1, 8), -1, dtype=torch.int32)
    pos[0, 3] = 5
    q = torch.ones((1, 1, 2 * kvh, hd), dtype=torch.bfloat16, device=cuda)
    got = ops.cache_attention(q, k, v, pos.to(cuda), q_offset=5)[0, 0]
    torch.cuda.synchronize()
    want = v[0, 3].to(torch.bfloat16).repeat_interleave(2, 0)
    nan = torch.isnan(want)
    assert int(nan.sum()) == 2 * 2 * 4                # 2 codes, 4 rolls, 2 heads
    assert bool(torch.isnan(got[nan]).all())
    # equal values are equal bits, but for the sign of zero: the output
    # is a sum over the slots, whose masked ones add +0 to code 0x80's -0
    assert torch.equal(got[~nan].float(), want[~nan].float())
    assert v[0, 3].view(torch.uint8)[~torch.isnan(
        v[0, 3].to(torch.bfloat16))].unique().numel() == 254


def test_flash_decode_widens_every_e4m3_key_code_exactly(cuda):
    """Every finite e4m3 byte as the one nonzero element of a key, under a
    query of a power of two (exact in bf16) that scales its score to
    1-2 in magnitude, beside a zero key whose V row is 1: each output is
    1 / (1 + exp(score)), which the kernel gives within 4e-3 of the plain
    version's (exact float32 widening) for all 254 codes, zeros and
    subnormals included; a key widened one mantissa step off moves it by
    1e-2 or more."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    codes = codes[(codes & 0x7f) != 0x7f]                # the 254 finite
    n, d = codes.numel(), 64
    vals = codes.view(torch.float8_e4m3fn).float()
    k = torch.zeros((1, 2, n, d), dtype=torch.uint8)
    k[0, 0, :, 5] = codes
    v = torch.zeros((1, 2, n, d), dtype=torch.uint8)
    v[0, 1] = 0x38                                       # e4m3 1.0
    q = torch.zeros((1, 1, n, d))
    e = torch.floor(torch.log2(vals.abs().clamp(min=2.0 ** -9)))
    q[0, 0, :, 5] = torch.exp2(3.0 - e)                  # |score| in [1, 2)
    k, v = (t.view(torch.float8_e4m3fn).to(cuda) for t in (k, v))
    q = q.to(cuda, torch.bfloat16)
    pos = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    got = ops.cache_attention(q, k, v, pos, q_offset=1)
    want = ref.cache_attention_ref(q.float(), k.float(), v.float(), pos,
                                   q_offset=1)
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 4e-3


def test_flash_decode_masks_stale_slots_and_empty_rows(cuda):
    """Slots the mask drops may hold anything (NaN): the output stays equal
    to that over finite values; a row that sees no slot gives zeros."""
    rng = np.random.default_rng(7)
    k, v, pos = _decode_cache(rng, 2, 64, 40, 2, 128, torch.bfloat16, cuda)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 128))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    want = ops.cache_attention(q, k, v, pos, q_offset=39, window=10)
    stale = (pos < 30)[:, :, None, None]
    kn = k.masked_fill(stale, float("nan"))
    vn = v.masked_fill(stale, float("nan"))
    got = ops.cache_attention(q, kn, vn, pos, q_offset=39, window=10)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    empty = ops.cache_attention(q, k, v, torch.full_like(pos, -1),
                                q_offset=39)
    torch.cuda.synchronize()
    assert bool((empty == 0).all())


def test_flash_decode_refuses_misaligned_and_strided_inputs(cuda):
    """K/V whose head dim is not unit-stride, or whose rows are not 4-byte
    aligned, pos not int32, a dtype pair the kernel does not take, or
    mismatched shapes raise before any launch."""
    rng = np.random.default_rng(8)
    k, v, pos = _decode_cache(rng, 1, 32, 32, 2, 64, torch.bfloat16, cuda)
    q = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16, device=cuda)
    ops.reset_launch_counts()
    strided = k.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match="unit-stride"):
        ops.cache_attention(q, strided, strided, pos, q_offset=31)
    wide = torch.zeros((1, 32, 2, 65), dtype=torch.bfloat16, device=cuda)
    odd = wide[..., 1:]                      # rows 2 bytes off 4
    with pytest.raises(ValueError, match="aligned"):
        ops.cache_attention(q, odd, odd, pos, q_offset=31)
    with pytest.raises(TypeError, match="int32"):
        ops.cache_attention(q, k, v, pos.long(), q_offset=31)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        ops.cache_attention(q.float(), k.to(torch.float8_e4m3fn),
                            v.to(torch.float8_e4m3fn), pos, q_offset=31)
    with pytest.raises(TypeError):
        ops.cache_attention(q, k.to(torch.float8_e5m2),
                            v.to(torch.float8_e5m2), pos, q_offset=31)
    with pytest.raises(ValueError, match="shapes"):
        ops.cache_attention(q, k, v, pos[:, :16].contiguous(), q_offset=31)
    assert ops.launch_counts()["flash_decode"] == 0


@pytest.mark.parametrize("name,cap,n,kvh,h,hd,window,kv_dt",
                         [c for c in DECODE_MAIN if c[0] in
                          ("mixtral", "recurrentgemma", "qwen3-4b")])
def test_flash_decode_partial_and_combine_over_two_halves(cuda, name, cap, n,
                                                          kvh, h, hd, window,
                                                          kv_dt):
    """A cache cut into two slot halves, as two ranks hold a capacity-
    sharded decode cache (row 1q's Qwen3-4B cache; row 1r's rings): the
    split kernel stopped at its partials on each half, then the combine
    kernel over both halves' splits, against the float32 plain version of
    the whole cache (``_close_to_size``) and against the plain partial and
    combine on the same halves; one launch of each entry a call."""
    rng = np.random.default_rng(cap + h + 1)
    k, v, pos = _decode_cache(rng, 2, cap, n, kvh, hd, kv_dt, cuda)
    q = torch.from_numpy(rng.standard_normal((2, 1, h, hd))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    half = cap // 2
    cuts = [(k[:, s:s + half], v[:, s:s + half], pos[:, s:s + half])
            for s in (0, half)]
    args = dict(q_offset=n - 1, window=window)
    ops.reset_launch_counts()
    parts = [ops.cache_attention_partial(q, *c, **args) for c in cuts]
    acc = torch.cat([a for a, _ in parts], 2)
    ml = torch.cat([m for _, m in parts], 2)
    got = ops.cache_attention_combine(acc, ml, torch.bfloat16)
    counts = ops.launch_counts()
    assert (counts["flash_decode_partial"], counts["decode_combine"],
            counts["flash_decode"]) == (2, 1, 0)
    assert acc.dtype == ml.dtype == torch.float32
    assert ml.shape == acc.shape[:4] + (2,) and acc.shape[2] >= 2
    want = ref.cache_attention_ref(q.float(), k.float(), v.float(), pos,
                                   **args)
    torch.cuda.synchronize()
    _close_to_size(got, want)
    plain = [ref.cache_attention_partial_ref(q, *c, **args) for c in cuts]
    pl = ref.decode_combine_ref(torch.cat([a for a, _ in plain], 2),
                                torch.cat([m for _, m in plain], 2),
                                torch.bfloat16)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               pl.float().cpu().numpy(), atol=2e-2)


@pytest.mark.parametrize("dtypes", ["float32", "bfloat16"])
def test_flash_decode_partial_one_split_and_empty_half(cuda, dtypes):
    """Partials out at a size whose plan has one split (the call still
    writes its partials), a half that no row sees (m -1e30, l 0: it weighs
    nothing), and the combine in float32: equal to the whole-cache plain
    version (2e-5 / 2e-2)."""
    q_dt = torch.float32 if dtypes == "float32" else torch.bfloat16
    rng = np.random.default_rng(3)
    k, v, pos = _decode_cache(rng, 2, 64, 30, 2, 64, q_dt, cuda)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64))
                         .astype(np.float32)).to(cuda, q_dt)
    parts = [ops.cache_attention_partial(q, k[:, s:s + 32], v[:, s:s + 32],
                                         pos[:, s:s + 32], q_offset=29)
             for s in (0, 32)]
    assert float(parts[1][1][..., 1].abs().max()) == 0.0
    got = ops.cache_attention_combine(torch.cat([a for a, _ in parts], 2),
                                      torch.cat([m for _, m in parts], 2),
                                      q_dt)
    want = ref.cache_attention_ref(q, k, v, pos, q_offset=29)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=2e-5 if dtypes == "float32" else 2e-2)


# (K head dim, V head dim) pairs with V narrower, one per tensor-core
# instance that takes them: MLA's expanded latent is 192 / 128
DECODE_DV = [(128, 64), (192, 128), (256, 128), (256, 64), (48, 32)]


@pytest.mark.parametrize("dtypes", ["float32", "bfloat16", "bf16-e4m3"])
@pytest.mark.parametrize("dk,dv", DECODE_DV)
@pytest.mark.parametrize("fill", ["ring", "full"])
def test_flash_decode_kernel_with_v_narrower_than_k(cuda, fill, dk, dv,
                                                    dtypes):
    """flash_decode with V narrower than K (dv < dk), V a view of a wider
    buffer as MLA's split of the expanded latent gives it: the whole-cache
    call and the partials of two slot halves merged by the combine,
    against the plain version (2e-5 in float32, 2e-2 in bf16 and over
    float8 K/V); output (and partials) dv wide."""
    cap, n = DECODE_FILLS[fill]
    q_dt = torch.float32 if dtypes == "float32" else torch.bfloat16
    kv_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "bf16-e4m3": torch.float8_e4m3fn}[dtypes]
    rng = np.random.default_rng(dk + dv + cap)
    k, _, pos = _decode_cache(rng, 2, cap, n, 4, dk, kv_dt, cuda)
    wide = torch.from_numpy(rng.standard_normal((2, cap, 4, dk + dv))
                            .astype(np.float32)).to(cuda, kv_dt)
    v = wide[..., dk:]
    q = torch.from_numpy(rng.standard_normal((2, 2, 8, dk))
                         .astype(np.float32)).to(cuda, q_dt)
    args = dict(q_offset=n - 2, window=6 if fill == "ring" else 0)
    tol = 2e-5 if dtypes == "float32" else 2e-2
    ops.reset_launch_counts()
    got = ops.cache_attention(q, k, v, pos, **args)
    half = cap // 2
    parts = [ops.cache_attention_partial(q, k[:, s:s + half],
                                         v[:, s:s + half],
                                         pos[:, s:s + half], **args)
             for s in (0, half)]
    assert all(a.shape[-1] == dv for a, _ in parts)
    merged = ops.cache_attention_combine(torch.cat([a for a, _ in parts], 2),
                                         torch.cat([m for _, m in parts], 2),
                                         q_dt)
    counts = ops.launch_counts()
    assert (counts["flash_decode"], counts["flash_decode_partial"],
            counts["decode_combine"]) == (1, 2, 1)
    want = ref.cache_attention_ref(q, k, v, pos, **args)
    torch.cuda.synchronize()
    assert got.shape == merged.shape == (2, 2, 8, dv) and got.dtype == q_dt
    for out in (got, merged):
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=tol)


# the partials the (1, 2) mesh's decode runs a rank, batch 2 (19d: 1), one
# row: (name, slots of the whole cache, positions written, KV heads, query
# heads, K head dim, V head dim, window, K/V dtype)
DECODE_HALVES = [
    ("qwen1.5-32b e4m3", 32_896, 32_769, 40, 40, 128, 128, 0,
     torch.float8_e4m3fn),
    ("mixtral ring", 4096, 34_000, 8, 32, 128, 128, 4096, torch.bfloat16),
    ("recurrentgemma ring", 2048, 34_000, 1, 16, 256, 256, 2048,
     torch.bfloat16),
    ("deepseek expanded latent", 32_896, 32_769, 16, 16, 192, 128, 0,
     torch.bfloat16),
    ("whisper decoder", 32_896, 32_769, 20, 20, 64, 64, 0, torch.bfloat16),
    ("internvl2", 32_896, 32_769, 8, 16, 128, 128, 0, torch.bfloat16)]


@pytest.mark.parametrize("name,cap,n,kvh,h,dk,dv,window,kv_dt",
                         DECODE_HALVES)
def test_flash_decode_halves_at_the_mesh_shapes(cuda, name, cap, n, kvh, h,
                                                dk, dv, window, kv_dt):
    """A rank's half of each decode cache that the (1, 2) mesh serves —
    Qwen1.5-32B's e4m3 cache (16,448 slots a rank), the rings of Mixtral
    (2,048 a rank) and RecurrentGemma (1,024 a rank, 16 heads on one KV
    head at 256), DeepSeek-V2-Lite's latent expanded to every head (K
    192, V 128, V a view of the expansion), Whisper's decoder cache (20
    heads on 20 KV heads x 64: a group of one) and InternVL2's (16 heads
    on 8 KV heads x 128): the partials of both halves merged by the
    combine, against the float32 plain version of the whole cache within
    ``_close_to_size``."""
    b = 1 if dv < dk else 2
    rng = np.random.default_rng(cap + h + dk)
    k, _, pos = _decode_cache(rng, b, cap, n, kvh, dk, kv_dt, cuda)
    wide = torch.from_numpy(rng.standard_normal((b, cap, kvh, dk + dv))
                            .astype(np.float32)).to(cuda, kv_dt)
    v = wide[..., dk:]
    q = torch.from_numpy(rng.standard_normal((b, 1, h, dk))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    args = dict(q_offset=n - 1, window=window)
    half = cap // 2
    parts = [ops.cache_attention_partial(q, k[:, s:s + half],
                                         v[:, s:s + half],
                                         pos[:, s:s + half], **args)
             for s in (0, half)]
    got = ops.cache_attention_combine(torch.cat([a for a, _ in parts], 2),
                                      torch.cat([m for _, m in parts], 2),
                                      torch.bfloat16)
    want = ref.cache_attention_ref(q.float(), k.float(), v.float(), pos,
                                   **args)
    torch.cuda.synchronize()
    assert got.shape == (b, 1, h, dv)
    _close_to_size(got, want)


def _mesh_vs_one_card(cfg_dict, monkeypatch, check_layers):
    """The launcher's rank program on a (1, 2) world of two ranks sharing
    the card, against the one-card launcher, for a tiny float32 config:
    prefill → handoff → 2 greedy steps. Returns (mesh record, one-card
    record)."""
    import dataclasses
    import torch_mesh_ranks as R
    from repro_torch.launch import cells as TC
    from repro_torch.launch import ranks, serve
    from repro_torch.launch import steps as TS
    cfg = config_from_dict(cfg_dict)
    cells = {s: dataclasses.replace(TC.get_cell("qwen3-4b", s), batch=2,
                                    seq_len=64, cache_dtype="float32")
             for s in ("prefill_32k", "decode_32k")}
    monkeypatch.setattr(TS, "get_config", lambda arch: cfg)
    monkeypatch.setattr(TS, "get_cell", lambda arch, s: cells[s])
    monkeypatch.setattr(TC, "get_cell", lambda arch, s: cells[s])
    one = serve.run_programs("qwen3-4b", batch=2, steps=2, keep_logits=True)
    with ranks.start(2, timeout_s=600) as world:
        recs = world.run(R.programs_on_rank, cfg_dict, cells, "qwen3-4b",
                         "decode_32k", 2, 2, None, 0, (1, 2), check_layers,
                         True)
    rec = serve.mesh_record(recs, world.backend)
    for got, want in zip([rec["prefill_logits"]] + rec["step_logits"],
                         [one["prefill_logits"]] + one["step_logits"]):
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())
    assert rec["tokens"] == one["tokens"]
    assert rec["handoff_held_all_ranks"]
    for r in rec["ranks"]:
        for what, (have, predicted) in r["bytes"].items():
            assert have == predicted > 0, what
    return rec, one


def test_collectives_through_the_shared_card_equal_gloo_on_the_host(cuda):
    """Two ranks sharing the card: ``psum`` of bfloat16 and float32,
    ``all_gather`` and ``exchange`` of e4m3 blocks through the ranks'
    shared device buffers give the bits that gloo gives for the same
    operands on the host, at 1,000 elements and at 9 Mi (past the
    buffers' first 32 MiB, so they grow)."""
    import torch_mesh_ranks as R
    from repro_torch.launch import ranks
    if torch.cuda.device_count() >= 2:
        pytest.skip("ranks share a card only where there is one")
    with ranks.start(2, timeout_s=300) as world:
        outs = world.run(R.shared_card_collectives_on_rank)
    for r, out in enumerate(outs):
        assert out["transport"] == "card"
        for card, host in zip(out["card"], out["host"]):
            for key in ("psum_bf16", "psum_f32", "gather"):
                assert card[key].dtype == host[key].dtype
                assert torch.equal(card[key].view(torch.uint8),
                                   host[key].view(torch.uint8)), key
            for a, b in zip(card["exchange"], host["exchange"]):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_autograd_collectives_through_the_shared_card_equal_gloo(cuda):
    """Two ranks sharing the card: the gradients through ``column_entry``,
    ``psum``, ``all_gather`` (split and replicated consumers) and
    ``gather_weights`` (the owner's broadcast) equal, bit for bit, the
    same function's on the host over gloo, in bfloat16 and float32; the
    owner alone gets the gathered weight's gradient."""
    import torch_mesh_train_ranks as R
    from repro_torch.launch import ranks
    if torch.cuda.device_count() >= 2:
        pytest.skip("ranks share a card only where there is one")
    with ranks.start(2, timeout_s=300) as world:
        outs = world.run(R.autograd_collectives_on_rank)
    for r, out in enumerate(outs):
        assert out["transport"] == "card"
        for card, host in zip(out["card"], out["host"]):
            for key in ("x", "w", "d"):
                if host[key] is None:
                    assert r != 0 and card[key] is None, key
                    continue
                assert card[key].dtype == host[key].dtype
                assert torch.equal(card[key].view(torch.uint8),
                                   host[key].view(torch.uint8)), key


def test_two_ranks_on_one_card_train_a_tiny_moe(cuda, monkeypatch):
    """A tiny float32 MoE (a dense first layer, then 2 MoE layers of 4
    experts and a shared one) trained on a (1, 2) world of two ranks
    sharing the card: the expert-TP backward — the tokens entering the
    rank's d_ff_expert columns, the gate weights' (the router's) sum
    over the model axis — through the card's collectives. The loss within
    rtol 1e-5 and every gradient leaf's rank slice within 1e-4 of its
    largest element of one card's step over the same batch (the capacity
    factor 4: no pair drops on either)."""
    import dataclasses
    import torch_mesh_train_ranks as R
    from repro_torch.launch import cells as TC
    from repro_torch.launch import ranks
    from repro_torch.launch import sharding as TSH
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import train_step as TT
    cfg_dict = dict(name="tiny-moe", family="moe", num_layers=3,
                    d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
                    d_ff=256, vocab_size=256,
                    moe=dict(num_experts=4, num_shared_experts=1, top_k=2,
                             d_ff_expert=64, first_dense_layers=1),
                    param_dtype="float32", compute_dtype="float32")
    cfg = config_from_dict(cfg_dict)
    ctx = {"moe_capacity_factor": 4.0}
    cell = dataclasses.replace(TC.get_cell("qwen3-4b", "train_4k"), batch=2,
                               seq_len=64, n_micro=1)
    state = TT.train_state_init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (2, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    batch["labels"][1, 40:] = -1
    dctx = TS._dctx
    monkeypatch.setattr(TS, "get_config", lambda arch: cfg)
    monkeypatch.setattr(TS, "_dctx", lambda *a, **k: dataclasses.replace(
        dctx(*a, **k), **ctx))
    one = TS.make_train_artifacts(cell, make_mesh((1, 1), ("data", "model"),
                                                  cuda))
    loss, grads = one.fn.grads(state, batch)
    want = {".params" + p: x.cpu() for p, x in TSH.named_leaves(grads)}
    with ranks.start(2, timeout_s=600) as world:
        outs = world.run(R.grads_on_rank, cfg_dict, cell, (1, 2), state,
                         batch, (), ctx, True)
    for r, o in enumerate(outs):
        assert o["loss"] == pytest.approx(float(loss), rel=1e-5)
        assert o["collectives"]["psum"]["calls"] > 0
        assert sorted(o["grads"]) == sorted(want)
        for p, x in o["grads"].items():
            w = want[p]
            cut = TSH.rank_slice(w, o["specs"][p], _two_rank_mesh(r))
            assert float((x - cut).abs().max()) \
                <= 1e-4 * float(w.abs().max()), p


def _two_rank_mesh(r):
    """Rank r's (1, 2) mesh as the parent sees it (for cutting whole
    leaves to its slices)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.collectives import AxisShard
    return Mesh((1, 2), ("data", "model"), torch.device("cpu"), (0, r),
                (None, AxisShard(r, 2, None, ())))


def test_two_ranks_on_one_card_serve_a_tiny_hybrid(cuda, monkeypatch):
    """One tiny RG-LRU hybrid (R, R, local attention over a ring of 16
    slots, 8 a rank) on two ranks sharing the card: the RG-LRU on each
    rank's half of the width, its conv's output gathered; the logits of
    the prefill and of both steps within 1e-5 of the largest one-card
    logit, the same tokens, the states and the ring resharded bit for
    bit, bytes equal to ``per_chip_bytes``; per rank one flash launch
    (windowed) and 2 of each of the partial and the combine."""
    from repro_torch.configs.base import ATTN, RECURRENT
    rec, _ = _mesh_vs_one_card(dict(
        name="tiny-hybrid", family="hybrid", num_layers=3, d_model=128,
        num_heads=4, num_kv_heads=1, head_dim=64, d_ff=256, vocab_size=256,
        attention_kind="sliding", sliding_window=16,
        recurrent=dict(lru_width=128, d_conv=4,
                       block_pattern=(RECURRENT, RECURRENT, ATTN)),
        param_dtype="float32", compute_dtype="float32"), monkeypatch,
        (0, 1, 2))
    for r in rec["ranks"]:
        assert r["launches"]["flash_attention"] == 1
        assert r["launches"]["flash_decode_partial"] == 2
        assert r["launches"]["decode_combine"] == 2
        assert r["collectives"]["all_gather"]["calls"] > 0


def test_two_ranks_on_one_card_serve_a_tiny_mla_step(cuda, monkeypatch):
    """One tiny MLA layer on two ranks sharing the card: the prefill on
    each rank's heads, the latent handed off in capacity halves, the
    decode steps over each rank's half expanded through every head's
    ``w_ukv`` (gathered) into flash_decode's partials at dk 48 / dv 32;
    the logits within 1e-5 of the largest one-card logit, the same
    tokens, the latent halves bit for bit, bytes equal to
    ``per_chip_bytes``; per rank one flash launch and 2 of each of the
    partial and the combine."""
    rec, _ = _mesh_vs_one_card(dict(
        name="tiny-mla", family="dense", num_layers=1, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=256,
        attention_kind="mla",
        mla=dict(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                 v_head_dim=32),
        param_dtype="float32", compute_dtype="float32"), monkeypatch, (0,))
    for r in rec["ranks"]:
        assert r["launches"]["flash_attention"] == 1
        assert r["launches"]["flash_decode_partial"] == 2
        assert r["launches"]["decode_combine"] == 2


def test_two_ranks_on_one_card_serve_a_tiny_layer(cuda, monkeypatch):
    """A (1, 2) world of two gloo ranks sharing the card
    (``launch.ranks``) runs the launcher's rank program on one tiny
    float32 layer: prefill → handoff → 2 greedy steps. The gathered
    prefill logits within 1e-5 of the largest of the one-card launcher's
    on the card (in float32 the two orders of summing differ by far
    less; in bfloat16 each rank's partial is rounded before the psum, as
    the reference's are, and phase 18 of ``chip_smoke.py`` holds that
    against float32 witnesses), the same tokens, the reshard held bit for
    bit, bytes equal to ``per_chip_bytes``, and per rank one flash launch
    and 2 of each of the partial and the combine."""
    import dataclasses
    import torch_mesh_ranks as R
    from repro_torch.launch import cells as TC
    from repro_torch.launch import ranks, serve
    from repro_torch.launch import steps as TS
    cfg_dict = dict(name="tiny-layer", family="dense", num_layers=1,
                    d_model=128, num_heads=4, num_kv_heads=2, head_dim=64,
                    d_ff=256, vocab_size=256, qk_norm=True,
                    param_dtype="float32", compute_dtype="float32")
    cfg = config_from_dict(cfg_dict)
    cells = {s: dataclasses.replace(TC.get_cell("qwen3-4b", s), batch=2,
                                    seq_len=64, cache_dtype="float32")
             for s in ("prefill_32k", "decode_32k")}
    monkeypatch.setattr(TS, "get_config", lambda arch: cfg)
    monkeypatch.setattr(TS, "get_cell", lambda arch, s: cells[s])
    monkeypatch.setattr(TC, "get_cell", lambda arch, s: cells[s])
    one = serve.run_programs("qwen3-4b", batch=2, steps=2, keep_logits=True)
    with ranks.start(2, timeout_s=600) as world:
        assert world.backend == ("nccl" if torch.cuda.device_count() >= 2
                                 else "gloo")
        recs = world.run(R.programs_on_rank, cfg_dict, cells, "qwen3-4b",
                         "decode_32k", 2, 2, None, 0, (1, 2), (0,), True)
    rec = serve.mesh_record(recs, world.backend)
    want = one["prefill_logits"]
    assert float((rec["prefill_logits"] - want).abs().max()) \
        <= 1e-5 * float(want.abs().max())
    assert rec["tokens"] == one["tokens"]
    assert rec["handoff_held_all_ranks"]
    for r in rec["ranks"]:
        assert r["launches"]["flash_attention"] == 1
        assert r["launches"]["flash_decode_partial"] == 2
        assert r["launches"]["decode_combine"] == 2
        assert r["launches"]["flash_decode"] == 0
        for what, (have, predicted) in r["bytes"].items():
            assert have == predicted > 0, what
