#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then runs four phases, each printing one JSON line:

  0. card: name and power limit (``nvidia-smi``), kernel build time;
  1. every kernel against its plain PyTorch version on the card, over the
     JAX test-suite sweep shapes and the main path's llama2-7b shapes
     (float32 within 2e-5; bfloat16 within 2e-2 at the sweep shapes and
     within one rounding step per element at the main path's; the
     re-page bit for bit), then each kernel's time, its plain version's
     time, a library
     call's time where one computes the same function, and the least time
     the card could take (bytes over 3.35 TB/s or operations over the
     dense peak of the dtype, whichever is larger);
  2. path parity: llama2-7b at full width with 2 layers in float32 (TF32
     off), one 300-token request through prefill, chunked prefill and 8
     paged decode steps on the card through the kernels and on the CPU
     through the plain versions — logits within 1e-3, the 9 greedy tokens
     identical;
  3. the main path: llama2-7b, 32 layers, bfloat16, random weights from a
     seed, one P engine (block 16, nhbd, TP 2) and one D engine (block 32,
     nbhd, TP 1) on the card behind GlobalScheduler with 500-token
     streamed prefill chunks over a raw bf16 wire; 8 requests with
     prompts of 256-2048 tokens and 32 greedy output tokens each. Every
     kernel must have launched during this phase (counts reset just
     before it), and each request's last token must agree with a
     monolithic prefill of its prompt and output.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero. Without a CUDA device, or without
the repository's ``src/repro_torch`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3
SEED = 0
# kernels against their plain versions: tests/test_kernels.py's tolerances
# at the sweep shapes. At the main path's shapes bfloat16 is held tighter:
# both sides compute in float32 and round once, so an element may differ
# by one bfloat16 step (BF16_STEP of its size, above a floor for values
# near 0) where the two float32 results straddle a rounding boundary, and
# on average by far less than BF16_MEAN of the output's size. A product
# summed in bfloat16 or a store that truncates breaks one or the other.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_FLOOR, BF16_STEP, BF16_MEAN = 1e-4, 2.0 ** -7, 2.0 ** -12

MODEL = "llama2-7b"
# phase 2: path parity at full width, cut to 2 layers, float32
PARITY_LAYERS, PARITY_PROMPT, PARITY_STEPS, PARITY_CHUNK = 2, 300, 8, 128
PARITY_ATOL = 1e-3
# phase 3: the main path
N_REQUESTS, PROMPT_RANGE, MAX_NEW, PREFILL_CHUNK = 8, (256, 2048), 32, 500
P_VENDOR = dict(name="vendorP", block_size=16, layout="nhbd",
                kv_dtype="bfloat16", tp=2)
D_VENDOR = dict(name="vendorD", block_size=32, layout="nbhd",
                kv_dtype="bfloat16", tp=1)
LOGIT_SLACK = 0.25    # bf16 noise between the decoded and prefilled logits


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phase 0: card and build
# --------------------------------------------------------------------------- #
def phase0():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    emit({"phase": 0, "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "library": lib.name,
          "build_s": round(time.perf_counter() - t0, 3),
          "built_here": _build.build_seconds is not None})
    return smi


# --------------------------------------------------------------------------- #
# phase 1: kernels against their plain versions, then timings
# --------------------------------------------------------------------------- #
def _rand(gen, shape, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _check(what, got, want, dtype, main):
    """Max abs error of ``got`` against ``want``; raises past the
    tolerance (see ATOL and BF16_* above)."""
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    size = want.float().abs()
    if main and dtype == "bfloat16":
        step = float((err / (BF16_FLOOR + BF16_STEP * size)).max())
        mean = float(err.mean() / size.mean())
        ok = step <= 1.0 and mean <= BF16_MEAN
        limit = f"{step} steps, mean {mean} (limits 1, {BF16_MEAN})"
    else:
        ok = float(err.max()) <= ATOL[dtype]
        limit = f"atol {ATOL[dtype]}"
    if not ok:
        raise AssertionError(f"{what}: max error {float(err.max())}, {limit}")
    return float(err.max())


def _flash_case(gen, dev, dtype, b, h, kv, sq, skv, d, window, q_offset,
                main=False):
    import torch
    from repro_torch.kernels import ops, ref
    dt = getattr(torch, dtype)
    q = _rand(gen, (b, h, sq, d), dt, dev)
    k = _rand(gen, (b, kv, skv, d), dt, dev)
    v = _rand(gen, (b, kv, skv, d), dt, dev)
    got = ops.flash_attention(q, k, v, window=window, q_offset=q_offset)
    want = ref.flash_attention_ref(q, k, v, window=window, q_offset=q_offset)
    err = _check(f"flash {dtype} {(b, h, kv, sq, skv, d)} window={window} "
                 f"q_offset={q_offset}", got, want, dtype, main)
    return err, (q, k, v)


def _paged_inputs(gen, dev, dtype, layout, b, h, kv, d, bs, lens):
    import torch
    from repro_torch.serving.paged_cache import KVPageSpec, pages_from_canonical
    dt = getattr(torch, dtype)
    pages = max(-(-int(n) // bs) for n in lens)
    n = b * pages + 1
    spec = KVPageSpec(bs, layout, dtype, kv, d)
    q = _rand(gen, (b, h, d), dt, dev)
    kp, vp = (pages_from_canonical(spec, _rand(gen, (n, bs, kv, d), dt, dev))
              .contiguous() for _ in range(2))
    perm = torch.randperm(n - 1, generator=gen, device=dev)[:b * pages] + 1
    table = perm.reshape(b, pages).to(torch.int32)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, table, seq_lens


def _paged_case(gen, dev, dtype, layout, b, h, kv, d, bs, lens, window,
                main=False):
    from repro_torch.kernels import ops, ref
    args = _paged_inputs(gen, dev, dtype, layout, b, h, kv, d, bs, lens)
    got = ops.paged_attention(*args, layout=layout, window=window)
    want = ref.paged_attention_ref(*args, layout=layout, window=window)
    err = _check(f"paged {dtype} {layout} {(b, h, kv, d, bs)} "
                 f"window={window}", got, want, dtype, main)
    return err, args


def _overlay_case(gen, dev, layout, pool_dt, canon_dt, layers, bs, kv, hd,
                  front, seq_len, stream_rows):
    """``stream_rows``: canon is the rows alone (the streamed re-page),
    else zero-padded whole pages (the monolithic one)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    spec = KVPageSpec(bs, layout, pool_dt, kv, hd)
    nb = -(-(front + seq_len) // bs)
    n_blocks = 2 * nb + 3
    pool = _rand(gen, (layers,) + spec.pool_shape(n_blocks),
                 getattr(torch, pool_dt), dev)
    shape = (seq_len,) if stream_rows else (nb, bs)
    canon = _rand(gen, (layers,) + shape + (kv, hd), getattr(torch, canon_dt),
                  dev)
    ids = (torch.randperm(n_blocks - 1, generator=gen, device=dev)[:nb]
           + 1).to(torch.int32)
    want = ref.scatter_pages_overlay_ref(spec, pool.clone(), ids, canon,
                                         front=front, seq_len=seq_len)
    got = ops.scatter_pages_overlay(spec, pool, ids, canon, front=front,
                                    seq_len=seq_len)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"overlay {layout} {pool_dt}<-{canon_dt} "
                             f"front={front} seq_len={seq_len} "
                             f"stream_rows={stream_rows}: pools differ")
    return 0.0, (spec, pool, ids, canon)


def phase1(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    counts = {"flash": 0, "paged": 0, "overlay": 0}
    main_err = {"flash": 0.0, "paged": 0.0}     # main-path shapes, bfloat16

    # flash: the JAX sweep shapes, a chunk at an offset, llama2-7b prefill
    for dtype in ("float32", "bfloat16"):
        for b, h, kv, sq, skv, d, q_off in [(1, 4, 4, 16, 16, 32, 0),
                                            (2, 8, 2, 24, 48, 64, 0),
                                            (1, 4, 1, 7, 133, 32, 0),
                                            (1, 8, 8, 100, 300, 128, 200),
                                            (1, 32, 32, 2048, 2048, 128, 0)]:
            main = sq == 2048
            for window in (0, 9):
                err, _ = _flash_case(gen, dev, dtype, b, h, kv, sq, skv, d,
                                     window, q_off, main)
                counts["flash"] += 1
                if main and dtype == "bfloat16":
                    main_err["flash"] = max(main_err["flash"], err)
    # paged: the JAX sweep shapes in every layout, llama2-7b decode
    decode_lens = [int(x) for x in torch.randint(
        1800, 2081, (8,), generator=torch.Generator().manual_seed(SEED))]
    for dtype in ("float32", "bfloat16"):
        for layout in ("nbhd", "nhbd", "nhdb"):
            for b, h, kv, d, bs, pages in [(2, 4, 4, 32, 8, 4),
                                           (3, 8, 2, 64, 16, 3),
                                           (1, 4, 1, 32, 4, 7)]:
                lens = [int(x) for x in torch.randint(
                    1, bs * pages + 1, (b,),
                    generator=torch.Generator().manual_seed(b))]
                for window in (0, 11):
                    _paged_case(gen, dev, dtype, layout, b, h, kv, d, bs,
                                lens, window)
                    counts["paged"] += 1
            err, _ = _paged_case(gen, dev, dtype, layout, 8, 32, 32, 128, 32,
                                 decode_lens, 0, main=True)
            counts["paged"] += 1
            if dtype == "bfloat16":
                main_err["paged"] = max(main_err["paged"], err)
    # overlay: every layout and dtype pair, the rows alone and whole pages,
    # front at 0 and inside a page, a partial tail, and the main path's
    # 500-token chunk over 32 layers
    for layout in ("nbhd", "nhbd", "nhdb"):
        for pool_dt, canon_dt in (("float32", "float32"),
                                  ("bfloat16", "bfloat16"),
                                  ("bfloat16", "float32"),
                                  ("float32", "bfloat16")):
            for front, seq_len in ((0, 24), (3, 17), (0, 5), (5, 3)):
                for stream_rows in (True, False):
                    _overlay_case(gen, dev, layout, pool_dt, canon_dt, 2, 8,
                                  2, 16, front, seq_len, stream_rows)
                    counts["overlay"] += 1
        _overlay_case(gen, dev, layout, "bfloat16", "bfloat16", 32, 32, 32,
                      128, 20, 500, True)
        counts["overlay"] += 1
    emit({"phase": 1, "checks": counts, "atol": ATOL,
          "main_bf16": {"floor": BF16_FLOOR, "step": BF16_STEP,
                        "mean": BF16_MEAN, "max_abs_err": main_err},
          "overlay": "bit-identical"})

    # timings at the main path's shapes (bfloat16)
    timings = {}
    # flash: a 500-token prefill chunk at offset 1500 against a 2000-slot
    # full-capacity cache (kv_len = capacity, as attention_decode calls it)
    c0, sq, cap, h, d = 1500, 500, 2000, 32, 128
    err, (q, k, v) = _flash_case(gen, dev, "bfloat16", 1, h, h, sq, cap, d,
                                 0, c0, main=True)
    mask = (torch.arange(cap, device=dev)[None, :]
            <= torch.arange(c0, c0 + sq, device=dev)[:, None])
    pairs = sq * c0 + sq * (sq + 1) // 2
    flops = 4.0 * d * pairs * h
    nbytes = 2.0 * (2 * sq * h * d + 2 * (c0 + sq) * h * d)
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    timings["flash_attention"] = dict(
        shape=f"q(1,{h},{sq},{d}) q_offset={c0} kv(1,{h},{cap},{d}) bf16",
        max_abs_err=err,
        ms=time_ms(lambda: ops.flash_attention(q, k, v, q_offset=c0)),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                         q_offset=c0), 5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by)
    # the monolithic 2048-token prefill, for reference
    _, (q2, k2, v2) = _flash_case(gen, dev, "bfloat16", 1, 32, 32, 2048,
                                  2048, 128, 0, 0, main=True)
    f2 = 4.0 * 128 * 32 * (2048 * 2049 // 2)
    b2, by2 = bound(f2, 2.0 * 4 * 2048 * 32 * 128, "bfloat16")
    emit({"phase": 1, "extra": "flash_attention monolithic prefill",
          "shape": "q,k,v (1,32,2048,128) causal bf16",
          "ms": time_ms(lambda: ops.flash_attention(q2, k2, v2)),
          "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
              q2, k2, v2, is_causal=True)),
          "bound_ms": b2, "bound_by": by2})
    del q2, k2, v2
    # paged: 8 sequences of ~2k tokens, block 32, nbhd (the D vendor)
    err, args = _paged_case(gen, dev, "bfloat16", "nbhd", 8, 32, 32, 128, 32,
                            decode_lens, 0, main=True)
    tokens = sum(decode_lens)
    flops = 4.0 * 128 * 32 * tokens
    nbytes = 2.0 * 2 * tokens * 32 * 128 + 2.0 * 2 * 8 * 32 * 128
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    timings["paged_attention"] = dict(
        shape=f"q(8,32,128) pools nbhd bs32 bf16, seq_lens {decode_lens}",
        max_abs_err=err,
        ms=time_ms(lambda: ops.paged_attention(*args, layout="nbhd")),
        plain_ms=time_ms(lambda: ref.paged_attention_ref(*args,
                                                         layout="nbhd"), 5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    # overlay: one 500-token chunk's rows landing 20 rows into a page, 32
    # layers, as the streamed re-page hands them over
    err, (spec, pool, ids, canon) = _overlay_case(
        gen, dev, "nbhd", "bfloat16", "bfloat16", 32, 32, 32, 128, 20, 500,
        True)
    nbytes = 2.0 * 2 * 32 * 500 * 32 * 128 + 4 * 17
    b_ms, b_by = bound(0.0, nbytes, "bfloat16")
    timings["scatter_pages_overlay"] = dict(
        shape="rows (32,500,32,128) into pool (32,N,32,32,128) nbhd bf16, "
              "17 pages, front 20",
        max_abs_err=err,
        ms=time_ms(lambda: ops.scatter_pages_overlay(
            spec, pool, ids, canon, front=20, seq_len=500)),
        plain_ms=time_ms(lambda: ref.scatter_pages_overlay_ref(
            spec, pool, ids, canon, front=20, seq_len=500), 5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    for name, t in timings.items():
        emit({"phase": 1, "timing": name, **t})
    return timings


# --------------------------------------------------------------------------- #
# phase 2: path parity, card (kernels) against CPU (plain versions)
# --------------------------------------------------------------------------- #
def run_path(cfg, params, dev, prompt):
    """Prefill, chunked prefill and PARITY_STEPS greedy paged decode steps
    of one request. Returns (list of logits rows as float32 CPU tensors,
    greedy tokens)."""
    import torch
    from repro_torch.core.disagg import _repage_pool
    from repro_torch.models import model as M
    from repro_torch.serving.paged_cache import KVPageSpec
    s = len(prompt)
    toks = torch.tensor(prompt, dtype=torch.int32, device=dev)[None]
    last, caches = M.prefill(params, cfg, {"tokens": toks},
                             M.init_caches(cfg, 1, s, device=dev))
    rows = [last[0].float().cpu()]
    steps, chunk = PARITY_STEPS, PARITY_CHUNK
    cap = -(-s // chunk) * chunk
    dense = M.init_caches(cfg, 1, cap, full_capacity=True, device=dev)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        logits, dense = M.decode_step(
            params, cfg, toks[:, c0:c1],
            torch.arange(c0, c1, device=dev)[None], dense, q_offset=c0)
    rows.append(logits[0, -1].float().cpu())
    bs = 32
    spec = KVPageSpec(bs, "nbhd", cfg.compute_dtype, cfg.num_kv_heads, cfg.hd)
    nb = -(-(s + steps) // bs)
    pools = M.init_paged_caches(cfg, {"kv": spec}, nb + 2, device=dev)
    blocks = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)
    for name, src in (("k_pool", caches[0][0].k), ("v_pool", caches[0][0].v)):
        _repage_pool(spec, pools[0][0][name], blocks, src[:, 0, :s], 0,
                     front=0, rmw=False)
    tok = int(torch.argmax(rows[0]))
    out = [tok]
    for step in range(steps):
        pos = s + step
        lens = torch.tensor([pos], dtype=torch.int32, device=dev)
        logits, pools = M.decode_step_paged(
            params, cfg, torch.tensor([[tok]], dtype=torch.int32, device=dev),
            lens, blocks[None], blocks[pos // bs:pos // bs + 1],
            torch.tensor([pos % bs], dtype=torch.int32, device=dev), pools,
            {"kv": spec})
        rows.append(logits[0, 0].float().cpu())
        tok = int(torch.argmax(rows[-1]))
        out.append(tok)
    return rows, out


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.to(dev)


def phase2(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False      # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MODEL).with_(num_layers=PARITY_LAYERS,
                                  param_dtype="float32",
                                  compute_dtype="float32")
    params = M.init_params(cfg, seed=SEED, device=dev)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, PARITY_PROMPT).astype(np.int32).tolist()
    t0 = time.perf_counter()
    rows_dev, toks_dev = run_path(cfg, params, dev, prompt)
    t_dev = time.perf_counter() - t0
    cpu_params = tree_to(params, "cpu")
    del params
    t0 = time.perf_counter()
    rows_cpu, toks_cpu = run_path(cfg, cpu_params, torch.device("cpu"),
                                  prompt)
    t_cpu = time.perf_counter() - t0
    err = max((a - b).abs().max().item() for a, b in zip(rows_dev, rows_cpu))
    finite = all(bool(torch.isfinite(r).all()) for r in rows_dev)
    result = {"phase": 2, "model": f"{cfg.name} x{cfg.num_layers} layers "
              f"{cfg.compute_dtype}", "prompt": PARITY_PROMPT,
              "logits_max_abs_err": err, "atol": PARITY_ATOL, "tf32": False,
              "tokens_device": toks_dev, "tokens_cpu": toks_cpu,
              "device_s": round(t_dev, 3), "cpu_s": round(t_cpu, 3)}
    emit(result)
    if not finite or not err <= PARITY_ATOL:
        raise AssertionError(f"path parity: logits differ by {err} > "
                             f"{PARITY_ATOL}")
    if toks_dev != toks_cpu or len(toks_dev) != PARITY_STEPS + 1:
        raise AssertionError(f"path parity: tokens {toks_dev} != {toks_cpu}")
    return result


# --------------------------------------------------------------------------- #
# phase 3: the main path at full width
# --------------------------------------------------------------------------- #
def phase3(dev, around_serve=contextlib.nullcontext):
    """``around_serve``: a context manager entered around the serving loop
    only (a profiler, say), not around set-up or the checks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.core.disagg import DisaggPipeline
    from repro_torch.core.kv_transfer import TransferEngine
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, VendorProfile
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import GlobalScheduler
    from repro_torch.serving.server import Server

    cfg = get_config(MODEL)
    p_vendor, d_vendor = VendorProfile(**P_VENDOR), VendorProfile(**D_VENDOR)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    max_seq = PROMPT_RANGE[1] + MAX_NEW
    d_blocks = N_REQUESTS * -(-max_seq // d_vendor.block_size) + 1
    p_eng = Engine("P0", cfg, params, p_vendor, num_blocks=2, max_batch=1,
                   max_seq_len=max_seq, role="prefill", device=dev)
    d_eng = Engine("D0", cfg, params, d_vendor, num_blocks=d_blocks,
                   max_batch=N_REQUESTS, max_seq_len=max_seq, role="decode",
                   device=dev)
    pipe = DisaggPipeline(TransferEngine(), WireFormat("raw", "bfloat16"))
    sched = GlobalScheduler(pipe, prefill_chunk=PREFILL_CHUNK, device=dev)
    sched.add_instance(p_eng)
    sched.add_instance(d_eng)
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), MAX_NEW) for i, n in enumerate(lens)]
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                      # count the main path only
    with around_serve():
        result = Server(sched).serve(reqs, max_ticks=100_000)
    launches = ops.launch_counts()

    for r in reqs:
        if len(r.output_tokens) != MAX_NEW or r.state.value != "finished":
            raise AssertionError(f"{r.req_id}: {len(r.output_tokens)} tokens, "
                                 f"state {r.state}")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"{r.req_id}: token out of range")
    if dev.type == "cuda":
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")
    # each request's last token against a monolithic prefill of
    # prompt + output[:-1]: the decoded token must be (within bf16 noise)
    # the prefill's top choice, and the logits finite
    worst = 0.0
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.output_tokens[:-1],
                                                   np.int32)])
        toks = torch.as_tensor(seq, device=dev)[None]
        last, _ = M.prefill(params, cfg, {"tokens": toks},
                            M.init_caches(cfg, 1, len(seq), device=dev))
        last = last[0].float()
        if not bool(torch.isfinite(last).all()):
            raise AssertionError(f"{r.req_id}: non-finite logits")
        gap = float(last.max() - last[r.output_tokens[-1]])
        worst = max(worst, gap)
        if gap > LOGIT_SLACK:
            raise AssertionError(f"{r.req_id}: decoded token {r.output_tokens[-1]}"
                                 f" is {gap} below the prefill's best logit")
    ttft = result.ttft()
    tpot = result.tpot()
    out = {"phase": 3, "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "requests": N_REQUESTS,
           "prompt_lens": [int(x) for x in lens], "max_new_tokens": MAX_NEW,
           "prefill_chunk": PREFILL_CHUNK,
           "p_vendor": dataclasses.asdict(p_vendor),
           "d_vendor": dataclasses.asdict(d_vendor),
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_max_s": float(ttft.max()),
           "tpot_p50_s": float(np.percentile(tpot, 50)),
           "output_tok_s": result.throughput_tok_s(),
           "wall_s": result.wall_seconds, "setup_s": setup_s,
           "launches": launches,
           "prefill_tokens": p_eng.stats.prefill_tokens,
           "prefill_s": p_eng.stats.prefill_seconds,
           "decode_steps": d_eng.stats.decode_steps,
           "decode_s": d_eng.stats.decode_seconds,
           "wire_handoff_s": pipe.transfer.stats.wall_handoff_seconds,
           "chunks_streamed": sched.stats.chunks_streamed,
           "wire_bytes": pipe.transfer.stats.bytes_moved,
           "last_token_logit_gap_max": worst}
    if dev.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(out)
    return out


KERNELS = [
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:78"),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:81"),
    ("scatter_pages_overlay", "src/repro_torch/kernels/csrc/kv_repack.cu",
     "src/repro/kernels/kv_repack.py:115"),
]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    smi = phase0()
    timings = phase1(dev)
    phase2(dev)
    torch.cuda.empty_cache()
    main_path = phase3(dev)

    rows = []
    for name, source, replaces in KERNELS:
        t = timings[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": main_path["launches"][name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(smi, flush=True)
    emit({"total_s": round(time.perf_counter() - t_start, 3)})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
