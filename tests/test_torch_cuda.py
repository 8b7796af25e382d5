"""On an NVIDIA GPU: each CUDA kernel against its plain PyTorch version,
the dense model's kernel route against its plain route, and the whole
serving path on the card against the same path on the CPU.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16 (tests/test_kernels.py);
the re-page must be bit-identical.
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
    assert all(n > 0 for n in counts.values()), counts


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_cpu(v) for v in tree)
    return tree.cpu()
