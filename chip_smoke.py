#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then runs six phases, each printing JSON lines:

  0. card: name and power limit (``nvidia-smi``), kernel build time, and
     the count of HGMMA (wgmma), UTMALDG (TMA load), SYNCS (mbarrier),
     LDGSTS (cp.async) and LDG.E.128 (16-byte load) instructions in each
     kernel of the built library (``cuobjdump -sass``), and each kernel's
     registers, spill bytes and whether ptxas serialized its wgmma
     instructions (the build's ``-Xptxas=-v`` output); the bf16 flash
     kernel must have HGMMA and UTMALDG, every paged split kernel LDGSTS,
     and every overlay page kernel whose canon load is 16 bytes LDG.E.128;
  1. every kernel against its plain PyTorch version on the card, over the
     JAX test-suite sweep shapes and the main path's llama2-7b shapes
     (float32 within 2e-5; bfloat16 within 2e-2 at the sweep shapes; at
     the main path's shapes paged attention within one rounding step per
     element, and flash within twice the max and mean error that
     ``scaled_dot_product_attention`` makes on the same bf16 inputs, both
     against the float32 plain version; the re-page, gather, scatter and
     repack bit for bit, the re-page also at hd 128 on its 16-byte and
     tile paths and against ``index_copy_`` at its timing shape, the last
     three also at the prefix cache's copy-on-write shape and the
     full-width Fig. 3 shape), then each kernel's time (paged also at one
     2048-token sequence, at phase 3's lengths and in the nhbd and nhdb
     layouts; the re-page also in nhbd and nhdb, as whole pages and from
     float32 rows; gather, scatter and repack also at the Fig. 3 shape),
     its plain version's time, a library
     call's time where one computes the same function, and the least time
     the card could take (bytes over 3.35 TB/s or operations over the
     dense peak of the dtype, whichever is larger). ``ms`` times
     back-to-back calls with CUDA events (the host's enqueue included
     where it is the longer);
     ``device_ms`` times a CUDA-graph replay of the same calls (device
     time only), for the kernels and the library calls alike;
     ``host_us`` is the wrapper's host cost per call;
  2. path parity: llama2-7b at full width with 2 layers in float32 (TF32
     off), one 300-token request through prefill, chunked prefill and 8
     paged decode steps on the card through the kernels and on the CPU
     through the plain versions — logits within 1e-3, the 9 greedy tokens
     identical;
  3. the main path: llama2-7b, 32 layers, bfloat16, random weights from a
     seed, one P engine (block 16, nhbd, TP 2) and one D engine (block 32,
     nbhd, TP 1) on the card behind GlobalScheduler with 500-token
     streamed prefill chunks over a raw bf16 wire; 8 requests with
     prompts of 256-2048 tokens and 32 greedy output tokens each. The
     flash, paged and overlay kernels must have launched during this
     phase, and each request's last token must agree with a monolithic
     prefill of its prompt and output; each request's first token must be,
     within LOGIT_SLACK, the top choice of a float32 prefill of its prompt
     (params upcast, the float32 flash kernel), a yardstick that does not
     depend on bf16 summation order; a digest of all output tokens is
     printed;
  4. the prefix-cache path: the same model and vendors with the cache on
     both engines; a 1000-token system prompt shared by 8 requests with
     unique 64-512-token tails, request 0 served alone, then the other 7
     together. Each cached request skips the 1000 tokens on the wire, P
     replays them from its host store, and D copies the divergence page
     with the repack kernel (gather then scatter). Checks as in phase 3,
     plus the hit counts and >= 14 launches each of gather_pages,
     scatter_pages and repack; then the same schedule cold, for the
     comparison it prints;
  5. the cross-process runtime: phase 3's eight requests served through
     ``TwoProcessRuntime`` — P and D engines in two spawned worker
     processes, each with its own CUDA context and its own weights (the
     same seed), KV over shared-memory segments. Every request must
     finish with no stream failure and no crash, the workers must have
     launched exactly phase 3's kernels, the last-token and first-token
     checks of phase 3 must hold, and no segment the run created may
     survive its shutdown. It prints TTFT, TPOT and tok/s beside the
     spawn-to-hello time, the merged wire counters and the worker pids.

Each phase requires launches of exactly the kernels its path runs (counts
reset just before its serving loop; phase 5 sums the counts its worker
processes report at shutdown).

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero. Without a CUDA device, or without
the repository's ``src/repro_torch`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import os
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
# at the sweep shapes. At the main path's shapes bfloat16 is held tighter.
# Paged attention: both sides compute in float32 and round once, so an
# element may differ by one bfloat16 step (BF16_STEP of its size, above a
# floor for values near 0) where the two float32 results straddle a
# rounding boundary, and on average by far less than BF16_MEAN of the
# output's size. A product summed in bfloat16 or a store that truncates
# breaks one or the other. Flash rounds P to bfloat16 before P·V, as
# every tensor-core flash attention does, so it is held to a yardstick:
# its max and mean error against the float32 plain version at most
# FLASH_VS_SDPA times those of scaled_dot_product_attention on the same
# bfloat16 inputs.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_FLOOR, BF16_STEP, BF16_MEAN = 1e-4, 2.0 ** -7, 2.0 ** -12
FLASH_VS_SDPA = 2.0

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
# phase 4: the prefix-cache path. 1000 = 2 chunks, so cached and cold runs
# cut the same chunks; 1000 = 31*32 + 8 on D and 62*16 + 8 on P, so every
# hit ends in a copy-on-write of an 8-row page
PREFIX_LEN, TAIL_RANGE = 1000, (64, 512)
HOST_STORE_BYTES = 4 << 30   # P's host prefix store (host memory)


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


def device_ms(fn, iters: int = 20, reps: int = 3):
    """Device time of one call of ``fn``: CUDA events around replays of a
    CUDA graph that holds ``iters`` calls, so the host's enqueue is out of
    the time. Returns (ms, method). Where a capture fails, the kernels'
    own time from ``torch.profiler`` instead, and the method says so."""
    import torch
    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages())
        return us / 1e3 / iters, "profiler"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters), "cuda_graph"


def host_us(fn, iters: int = 20) -> float:
    """Host time of one call of ``fn`` (its enqueue: Python wrapper and
    launch), on the host clock, with the device idle at the start."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def time_all(fn, plain=None, library=None, iters: int = 20,
             plain_iters: int = 5):
    """Every time the kernel table reports for one kernel: ``ms`` (events
    around back-to-back calls), ``device_ms`` (graph replay), ``host_us``,
    and the plain version's and the library call's times."""
    out = {"ms": time_ms(fn, iters)}
    out["device_ms"], out["device_method"] = device_ms(fn, iters)
    out["host_us"] = host_us(fn)
    out["plain_ms"] = (time_ms(plain, plain_iters) if plain is not None
                       else None)
    out["library_ms"] = out["library_device_ms"] = None
    if library is not None:
        out["library_ms"] = time_ms(library, iters)
        out["library_device_ms"], _ = device_ms(library, iters)
    return out


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
    cuda_bin = Path(_build._nvcc()).parent
    sass = sass_counts(lib, cuda_bin)
    emit({"phase": 0, "sass": sass})
    log = _build.build_dir() / "build.log"
    if log.exists():
        emit({"phase": 0, "ptxas": ptxas_report(log.read_text(), cuda_bin)})
    flash = [c for name, c in sass.items()
             if name.startswith("flash_fwd_kernel_wgmma")]
    if not flash or not all(c["HGMMA"] and c["UTMALDG"] for c in flash):
        raise AssertionError(f"phase 0: the bf16 flash kernel has no "
                             f"HGMMA/UTMALDG instructions: {flash}")
    wide = {name: {op: c[op] for op in ("LDGSTS", "LDG.E.128")}
            for name, c in sass.items()
            if name.startswith(("paged_split_kernel", "page_gather_kernel",
                                "page_overlay_kernel"))}
    emit({"phase": 0, "wide_loads": wide})
    if not wide or not all(c["LDGSTS"] for name, c in wide.items()
                           if name.startswith("paged_split_kernel")):
        raise AssertionError(f"phase 0: a paged split kernel has no "
                             f"cp.async (LDGSTS) instructions: {wide}")
    overlay16 = {name: c["LDG.E.128"] for name, c in wide.items()
                 if name.startswith("page_overlay_kernel")
                 and canon_load_bytes(name) == 16}
    if not overlay16 or not all(overlay16.values()):
        raise AssertionError(f"phase 0: an overlay kernel whose canon load "
                             f"is 16 bytes has no LDG.E.128: {overlay16}")
    return smi


def canon_load_bytes(name: str) -> int:
    """Bytes of one canon load of ``page_overlay_kernel<Tp, Tc, VEC>``:
    VEC elements of Tc (``(int)8`` as cu++filt writes the width)."""
    _, tc, vec = name[name.index("<") + 1:-1].split(", ")
    return (2 if "bfloat16" in tc else 4) * int(vec.removeprefix("(int)"))


SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "LDGSTS", "LDG.E.128")


def sass_counts(lib: Path, cuda_bin: Path):
    """Instructions of each of SASS_OPS in each kernel of the library
    (``cuobjdump -sass``), by kernel name without its namespace and
    parameters (template arguments kept)."""
    text = subprocess.run([str(cuda_bin / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, mangled, fn = {}, [], None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            mangled.append(fn)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                if op in line:
                    counts[fn][op] += 1
    return {name: counts[m]
            for m, name in zip(mangled, kernel_names(mangled, cuda_bin))}


def ptxas_report(log: str, cuda_bin: Path):
    """Per kernel of the build's ``-Xptxas=-v`` output: registers, spill
    bytes (stores), and whether ptxas serialized its wgmma instructions
    (C7512)."""
    out, fn, serialized = {}, None, set()
    for line in log.splitlines():
        if "C7512" in line:
            serialized.add(line.rsplit("'", 2)[-2])
        elif "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = {"registers": None, "spill_bytes": 0}
        elif fn and "spill stores" in line:
            out[fn]["spill_bytes"] = int(line.split("bytes spill stores")[0]
                                         .rsplit(",", 1)[-1])
        elif fn and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(line.split("Used")[1].split()[0])
    for fn in out:
        out[fn]["wgmma_serialized"] = fn in serialized
    return {name: out[m] for m, name in zip(out, kernel_names(out, cuda_bin))}


def kernel_names(mangled, cuda_bin: Path):
    """Short names of mangled kernel symbols (``cu++filt``, where the
    toolkit has it): ``void ns::f<A, (int)8>(A*, int)`` -> ``f<A, (int)8>``,
    the name with its template arguments, without return type, namespace
    or parameters."""
    mangled = list(mangled)
    filt = cuda_bin / "cu++filt"
    if not filt.exists():
        return mangled
    names = subprocess.run([str(filt)], input="\n".join(mangled),
                           capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    return [_short_name(n) for n in names]


def _short_name(demangled: str) -> str:
    name = demangled.removeprefix("void ")
    for anon in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(anon, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.split("<", 1)[0].split("::")[-1] + (
        "<" + name.split("<", 1)[1] if "<" in name else "")


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
    """flash against its plain version; at a main-path shape in bfloat16,
    against the yardstick (see FLASH_VS_SDPA). Returns (max abs error,
    inputs, the yardstick's numbers or None)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dt = getattr(torch, dtype)
    q = _rand(gen, (b, h, sq, d), dt, dev)
    k = _rand(gen, (b, kv, skv, d), dt, dev)
    v = _rand(gen, (b, kv, skv, d), dt, dev)
    what = (f"flash {dtype} {(b, h, kv, sq, skv, d)} window={window} "
            f"q_offset={q_offset}")
    got = ops.flash_attention(q, k, v, window=window, q_offset=q_offset)
    if not (main and dtype == "bfloat16"):
        want = ref.flash_attention_ref(q, k, v, window=window,
                                       q_offset=q_offset)
        return _check(what, got, want, dtype, False), (q, k, v), None
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   window=window, q_offset=q_offset)
    lib = F.scaled_dot_product_attention(
        q, k, v, attn_mask=flash_mask(sq, skv, q_offset, window, dev))
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    lib_err = (lib.float() - want).abs()
    yard = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "sdpa_max_abs_err": float(lib_err.max()),
            "sdpa_mean_abs_err": float(lib_err.mean())}
    if not (yard["max_abs_err"] <= FLASH_VS_SDPA * yard["sdpa_max_abs_err"]
            and yard["mean_abs_err"]
            <= FLASH_VS_SDPA * yard["sdpa_mean_abs_err"]):
        raise AssertionError(f"{what}: errors against the float32 plain "
                             f"version exceed {FLASH_VS_SDPA}x "
                             f"scaled_dot_product_attention's: {yard}")
    return yard["max_abs_err"], (q, k, v), yard


def flash_mask(sq, skv, q_offset, window, dev):
    """The causal (and window) mask of query rows at q_offset + i over
    keys 0..skv-1, True where a key is visible."""
    import torch
    qi = torch.arange(q_offset, q_offset + sq, device=dev)[:, None]
    kj = torch.arange(skv, device=dev)[None, :]
    ok = kj <= qi
    return ok & (qi - kj < window) if window > 0 else ok


def _paged_inputs(gen, dev, dtype, layout, b, h, kv, d, bs, lens,
                  width=None):
    """q, pools, a block table ``width`` pages wide (default: the longest
    sequence's pages) and seq_lens."""
    import torch
    from repro_torch.serving.paged_cache import KVPageSpec, pages_from_canonical
    dt = getattr(torch, dtype)
    pages = width or max(-(-int(n) // bs) for n in lens)
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
                main=False, width=None):
    from repro_torch.kernels import ops, ref
    args = _paged_inputs(gen, dev, dtype, layout, b, h, kv, d, bs, lens,
                         width)
    got = ops.paged_attention(*args, layout=layout, window=window)
    want = ref.paged_attention_ref(*args, layout=layout, window=window)
    err = _check(f"paged {dtype} {layout} {(b, h, kv, d, bs)} "
                 f"window={window}", got, want, dtype, main)
    return err, args


def _overlay_case(gen, dev, layout, pool_dt, canon_dt, layers, bs, kv, hd,
                  front, seq_len, stream_rows, offset=0):
    """``stream_rows``: canon is the rows alone (the streamed re-page),
    else zero-padded whole pages (the monolithic one). ``offset``: canon
    starts that many elements into each row of a wider buffer."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    spec = KVPageSpec(bs, layout, pool_dt, kv, hd)
    nb = -(-(front + seq_len) // bs)
    n_blocks = 2 * nb + 3
    pool = _rand(gen, (layers,) + spec.pool_shape(n_blocks),
                 getattr(torch, pool_dt), dev)
    shape = (seq_len,) if stream_rows else (nb, bs)
    pad = 8 if offset else 0
    canon = _rand(gen, (layers,) + shape + (kv, hd + pad),
                  getattr(torch, canon_dt), dev)[..., offset:offset + hd]
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


def _pages_case(gen, dev, kind, layout, pool_dt, other_dt, layers, bs, kv,
                hd, n_blocks, ids):
    """gather_pages (``other_dt`` is the output dtype) or scatter_pages
    (``other_dt`` is the canonical input's) against its plain version,
    bit for bit. Returns the inputs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    spec = KVPageSpec(bs, layout, pool_dt, kv, hd)
    pool = _rand(gen, (layers,) + spec.pool_shape(n_blocks),
                 getattr(torch, pool_dt), dev)
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    if kind == "gather":
        dt = getattr(torch, other_dt)
        got = ops.gather_pages(spec, pool, ids, out_dtype=dt)
        want = ref.gather_pages_ref(spec, pool, ids, out_dtype=dt)
        args = (spec, pool, ids, dt)
    else:
        canon = _rand(gen, (layers, len(ids), bs, kv, hd),
                      getattr(torch, other_dt), dev)
        want = ref.scatter_pages_ref(spec, pool.clone(), ids, canon)
        got = ops.scatter_pages(spec, pool, ids, canon)
        args = (spec, pool, ids, canon)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{kind}_pages {layout} pool {pool_dt} "
                             f"other {other_dt} {layers} layers bs {bs}: "
                             "differs from its plain version")
    return args


def _repack_case(gen, dev, src_layout, dst_layout, src_bs, dst_bs, src_dt,
                 dst_dt, layers, kv, hd, seq):
    """repack against its plain version, bit for bit, over unsorted pages
    of a dst pool that starts non-zero. Returns the inputs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    src = KVPageSpec(src_bs, src_layout, src_dt, kv, hd)
    dst = KVPageSpec(dst_bs, dst_layout, dst_dt, kv, hd)
    nb_s, nb_d = src.blocks_for(seq), dst.blocks_for(seq)
    src_pool = _rand(gen, (layers,) + src.pool_shape(nb_s + 2),
                     src.tdtype, dev)
    dst_pool = _rand(gen, (layers,) + dst.pool_shape(nb_d + 2),
                     dst.tdtype, dev)
    src_ids = (torch.randperm(nb_s + 1, generator=gen, device=dev)[:nb_s]
               + 1).to(torch.int32)
    dst_ids = (torch.randperm(nb_d + 1, generator=gen, device=dev)[:nb_d]
               + 1).to(torch.int32)
    want = ref.repack_ref(src, dst, src_pool, src_ids, dst_pool.clone(),
                          dst_ids, seq)
    got = ops.repack(src, dst, src_pool, src_ids, dst_pool, dst_ids, seq)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"repack {src_layout}/{src_bs}/{src_dt} -> "
                             f"{dst_layout}/{dst_bs}/{dst_dt} {layers} layers "
                             f"seq {seq}: differs from its plain version")
    return src, dst, src_pool, src_ids, dst_pool, dst_ids


DTYPE_PAIRS = (("float32", "float32"), ("bfloat16", "bfloat16"),
               ("bfloat16", "float32"), ("float32", "bfloat16"))
# overlay at hd 128, kv 8 (bs, front, seq_len): front 0; mid-page with a
# span ending mid-page; one row before a chunk edge (chunks of 8 tokens in
# bf16, 4 in f32, 32 in nhdb); bs 16 and 48, partial nhdb token tiles
OVERLAY_WIDE_CASES = ((16, 0, 40), (32, 13, 50), (32, 7, 100), (32, 3, 61),
                      (32, 31, 90), (16, 5, 60), (48, 31, 70))


def phase1_pages(gen, dev, cfg):
    """gather_pages, scatter_pages and repack against their plain
    versions (bit for bit): tests/test_kernels.py's sweep shapes with a
    layer axis and every dtype pair, the prefix cache's copy-on-write
    shape (one page of llama2-7b's pool, 32 layers, block 32, nbhd, bf16)
    and the full-width Fig. 3 shape (2048 tokens, 32 layers, nhbd block 16
    -> nbhd block 32, bf16). Then each kernel's timings at the COW shape
    (the main path's), and repack's at the Fig. 3 shape."""
    import torch
    from repro_torch.kernels import ops, ref
    counts = {"gather_pages": 0, "scatter_pages": 0, "repack": 0}
    for layout in ("nbhd", "nhbd", "nhdb"):
        for pool_dt, other_dt in DTYPE_PAIRS:
            for kind in ("gather", "scatter"):
                _pages_case(gen, dev, kind, layout, pool_dt, other_dt, 2, 8,
                            4, 16, 10, [3, 1, 7])
                counts[f"{kind}_pages"] += 1
    for src_l, dst_l, src_bs, dst_bs in (("nbhd", "nhbd", 8, 4),
                                         ("nhdb", "nbhd", 4, 16),
                                         ("nhbd", "nhdb", 16, 8)):
        for src_dt, dst_dt in DTYPE_PAIRS:
            _repack_case(gen, dev, src_l, dst_l, src_bs, dst_bs, src_dt,
                         dst_dt, 2, 2, 16, 27)
            counts["repack"] += 1
    layers, kv, hd, bs = cfg.num_layers, cfg.num_kv_heads, cfg.hd, 32
    cow = {}
    for kind in ("gather", "scatter"):
        cow[kind] = _pages_case(gen, dev, kind, "nbhd", "bfloat16",
                                "bfloat16", layers, bs, kv, hd, 9, [6])
        counts[f"{kind}_pages"] += 1
    spec, pool, _, _ = cow["scatter"]
    ids = torch.tensor([6, 2], dtype=torch.int32, device=dev)
    want = ref.repack_ref(spec, spec, pool, ids[:1], pool.clone(), ids[1:],
                          bs)
    ops.repack(spec, spec, pool, ids[:1], pool, ids[1:], bs)
    torch.cuda.synchronize()
    if not torch.equal(pool, want):
        raise AssertionError("repack at the COW shape differs from its "
                             "plain version")
    counts["repack"] += 1
    fig3 = _repack_case(gen, dev, "nhbd", "nbhd", 16, 32, "bfloat16",
                        "bfloat16", layers, kv, hd, 2048)
    counts["repack"] += 1

    # timings at the COW shape: one 32-row page of every layer
    page_bytes = 2.0 * layers * bs * kv * hd          # one pool page, bf16
    b_ms, b_by = bound(0.0, 2 * page_bytes, "bfloat16")
    timings = {}
    g_spec, g_pool, g_ids, g_dt = cow["gather"]
    timings["gather_pages"] = dict(
        shape=f"1 page of pool ({layers},9,{bs},{kv},{hd}) nbhd bf16 -> "
              f"canon ({layers},1,{bs},{kv},{hd})",
        max_abs_err=0.0,
        **time_all(lambda: ops.gather_pages(g_spec, g_pool, g_ids, g_dt),
                   plain=lambda: ref.gather_pages_ref(g_spec, g_pool, g_ids,
                                                      g_dt),
                   library=lambda: g_pool.index_select(1, g_ids.long())
                   .contiguous(), plain_iters=20),
        bound_ms=b_ms, bound_by=b_by)
    s_spec, s_pool, s_ids, s_canon = cow["scatter"]
    s_long = s_ids.long()
    timings["scatter_pages"] = dict(
        shape=f"canon ({layers},1,{bs},{kv},{hd}) -> 1 page of pool "
              f"({layers},9,{bs},{kv},{hd}) nbhd bf16",
        max_abs_err=0.0,
        **time_all(lambda: ops.scatter_pages(s_spec, s_pool, s_ids, s_canon),
                   plain=lambda: ref.scatter_pages_ref(s_spec, s_pool, s_ids,
                                                       s_canon),
                   library=lambda: s_pool.index_copy_(1, s_long, s_canon),
                   plain_iters=20),
        bound_ms=b_ms, bound_by=b_by)
    src_l, dst_l = ids[:1].long(), ids[1:].long()
    timings["repack"] = dict(
        shape=f"COW: page 6 -> page 2 of pool ({layers},9,{bs},{kv},{hd}) "
              "nbhd bf16, in place",
        max_abs_err=0.0,
        **time_all(lambda: ops.repack(spec, spec, pool, ids[:1], pool,
                                      ids[1:], bs),
                   plain=lambda: ref.repack_ref(spec, spec, pool, ids[:1],
                                                pool, ids[1:], bs),
                   library=lambda: pool.index_copy_(
                       1, dst_l, pool.index_select(1, src_l)),
                   plain_iters=20),
        bound_ms=b_ms, bound_by=b_by)
    # the paper's Fig. 3 at full width: 512 MiB in and out per pool
    src, dst, src_pool, src_ids, dst_pool, dst_ids = fig3
    nbytes = 2.0 * 2 * layers * 2048 * kv * hd
    f_ms, f_by = bound(0.0, nbytes, "bfloat16")
    perm = (0, 1, 3, 2, 4)          # nhbd page (kv, bs, hd) -> (bs, kv, hd)

    def fig3_library():
        canon = src_pool.index_select(1, src_ids.long()).permute(
            perm).contiguous().view(layers, -1, 32, kv, hd)
        dst_pool.index_copy_(1, dst_ids.long(), canon)

    emit({"phase": 1, "extra": "repack at the Fig. 3 shape",
          "shape": f"2048 tokens, {layers} layers, nhbd bs16 -> nbhd bs32, "
                   "bf16",
          **time_all(lambda: ops.repack(src, dst, src_pool, src_ids,
                                        dst_pool, dst_ids, 2048),
                     plain=lambda: ref.repack_ref(src, dst, src_pool, src_ids,
                                                  dst_pool, dst_ids, 2048),
                     library=fig3_library, iters=5),
          "bound_ms": f_ms, "bound_by": f_by})
    del fig3, src_pool, dst_pool
    # its scatter half: the canonical 2048 tokens into 64 unsorted dst pages
    n_pg = 2048 // bs
    order = torch.randperm(n_pg, generator=torch.Generator().manual_seed(SEED))
    f_spec, f_pool, f_ids, f_canon = _pages_case(
        gen, dev, "scatter", "nbhd", "bfloat16", "bfloat16", layers, bs, kv,
        hd, n_pg + 2, (order + 1).tolist())
    counts["scatter_pages"] += 1
    f_long = f_ids.long()
    emit({"phase": 1, "extra": "scatter_pages at the Fig. 3 shape",
          "shape": f"canon ({layers},{n_pg},{bs},{kv},{hd}) -> {n_pg} pages "
                   f"of pool ({layers},{n_pg + 2},{bs},{kv},{hd}) nbhd bf16",
          "bit_identical": True,
          **time_all(lambda: ops.scatter_pages(f_spec, f_pool, f_ids,
                                               f_canon),
                     plain=lambda: ref.scatter_pages_ref(f_spec, f_pool,
                                                         f_ids, f_canon),
                     library=lambda: f_pool.index_copy_(1, f_long, f_canon),
                     iters=10),
          "bound_ms": f_ms, "bound_by": f_by})
    del f_pool, f_canon
    # the gather half: 128 unsorted nhbd pages of block 16 -> canonical
    n_pg = 2048 // 16
    order = torch.randperm(n_pg,
                           generator=torch.Generator().manual_seed(SEED))
    g_spec, g_pool, g_ids, g_dt = _pages_case(
        gen, dev, "gather", "nhbd", "bfloat16", "bfloat16", layers, 16, kv,
        hd, n_pg + 2, (order + 1).tolist())
    counts["gather_pages"] += 1
    g_long = g_ids.long()
    emit({"phase": 1, "extra": "gather_pages at the Fig. 3 shape",
          "shape": f"{n_pg} pages of pool ({layers},{n_pg + 2},{kv},16,"
                   f"{hd}) nhbd bf16 -> canon ({layers},{n_pg},16,{kv},{hd})",
          "bit_identical": True,
          **time_all(lambda: ops.gather_pages(g_spec, g_pool, g_ids, g_dt),
                     plain=lambda: ref.gather_pages_ref(g_spec, g_pool,
                                                        g_ids, g_dt),
                     library=lambda: g_pool.index_select(1, g_long).permute(
                         perm).contiguous(),
                     iters=10),
          "bound_ms": f_ms, "bound_by": f_by})
    del g_pool
    emit({"phase": 1, "pages_checks": counts, "pages": "bit-identical"})
    return timings


def phase1_overlay(gen, dev):
    """The overlay's timings: one 500-token chunk's rows landing 20 rows
    into a page, 32 layers, as the streamed re-page hands them over (the
    main path's shape), beside ``index_copy_`` of the same rows, which must
    give the same bits; then, as extra lines, the same rows into nhbd and
    nhdb pools, the monolithic form (whole zero-padded pages, front 0) and
    float32 rows (an int8 wire decodes to float32) into the bf16 pool."""
    import torch
    from repro_torch.kernels import ops, ref
    layers, bs, kv, hd, front, s = 32, 32, 32, 128, 20, 500
    nb = -(-(front + s) // bs)

    def rows_bytes(canon_dt, n_rows):
        return ((torch.finfo(getattr(torch, canon_dt)).bits // 8 + 2)
                * layers * n_rows * kv * hd + 4 * nb)

    def library_rows(ids, n_rows, at):
        """index_copy_'s row index: flat row at+i of the block list."""
        r = torch.arange(at, at + n_rows, device=dev)
        return ids.long()[r // bs] * bs + r % bs

    err, (spec, pool, ids, canon) = _overlay_case(
        gen, dev, "nbhd", "bfloat16", "bfloat16", layers, bs, kv, hd, front, s,
        True)
    rows = library_rows(ids, s, front)
    flat = pool.view(layers, -1, kv * hd)
    src = canon.view(layers, s, kv * hd)
    fresh = _rand(gen, tuple(pool.shape), pool.dtype, dev)
    got = ops.scatter_pages_overlay(spec, fresh.clone(), ids, canon,
                                    front=front, seq_len=s)
    lib = fresh.view(layers, -1, kv * hd).index_copy_(1, rows, src)
    torch.cuda.synchronize()
    if not torch.equal(got.view(layers, -1, kv * hd), lib):
        raise AssertionError("overlay at the timing shape differs from "
                             "index_copy_ of the same rows")
    del fresh, got, lib
    b_ms, b_by = bound(0.0, rows_bytes("bfloat16", s), "bfloat16")
    timing = dict(
        shape=f"rows ({layers},{s},{kv},{hd}) into pool ({layers},N,{bs},"
              f"{kv},{hd}) nbhd bf16, {nb} pages, front {front}",
        max_abs_err=err, library_bit_identical=True,
        **time_all(lambda: ops.scatter_pages_overlay(
                       spec, pool, ids, canon, front=front, seq_len=s),
                   plain=lambda: ref.scatter_pages_overlay_ref(
                       spec, pool, ids, canon, front=front, seq_len=s),
                   library=lambda: flat.index_copy_(1, rows, src)),
        bound_ms=b_ms, bound_by=b_by)
    del pool, canon, flat, src
    # (what, layout, canon dtype, stream rows, front, rows covered)
    for what, layout, canon_dt, stream_rows, f0, n in (
            ("nhbd", "nhbd", "bfloat16", True, front, s),
            ("nhdb", "nhdb", "bfloat16", True, front, s),
            ("whole pages, front 0 (monolithic)", "nbhd", "bfloat16", False,
             0, nb * bs),
            ("float32 rows into the bf16 pool (int8 wire)", "nbhd",
             "float32", True, front, s)):
        _, (x_spec, x_pool, x_ids, x_canon) = _overlay_case(
            gen, dev, layout, "bfloat16", canon_dt, layers, bs, kv, hd, f0, n,
            stream_rows)
        library = None
        if layout == "nbhd" and canon_dt == "bfloat16":
            library = functools.partial(
                x_pool.view(layers, -1, kv * hd).index_copy_, 1,
                library_rows(x_ids, n, f0), x_canon.view(layers, n, kv * hd))
        x_ms, x_by = bound(0.0, rows_bytes(canon_dt, n), "bfloat16")
        emit({"phase": 1, "extra": f"scatter_pages_overlay, {what}",
              "shape": f"canon {tuple(x_canon.shape)} {canon_dt} into "
                       f"{layout} bf16 pool, {nb} pages, front {f0}, "
                       f"{n} rows",
              "bit_identical": True,
              **time_all(lambda: ops.scatter_pages_overlay(
                             x_spec, x_pool, x_ids, x_canon, front=f0,
                             seq_len=n),
                         plain=lambda: ref.scatter_pages_overlay_ref(
                             x_spec, x_pool, x_ids, x_canon, front=f0,
                             seq_len=n),
                         library=library),
              "bound_ms": x_ms, "bound_by": x_by})
    return timing


def phase1(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    counts = {"flash": 0, "paged": 0, "overlay": 0}
    main_err = {"paged": 0.0}                   # main-path shapes, bfloat16
    yardstick = []                              # flash at main-path shapes

    # flash: the JAX sweep shapes, a chunk at an offset, llama2-7b prefill
    for dtype in ("float32", "bfloat16"):
        for b, h, kv, sq, skv, d, q_off in [(1, 4, 4, 16, 16, 32, 0),
                                            (2, 8, 2, 24, 48, 64, 0),
                                            (1, 4, 1, 7, 133, 32, 0),
                                            (1, 8, 8, 100, 300, 128, 200),
                                            (1, 32, 32, 2048, 2048, 128, 0)]:
            main = sq == 2048
            for window in (0, 9):
                _, _, yard = _flash_case(gen, dev, dtype, b, h, kv, sq, skv,
                                         d, window, q_off, main)
                counts["flash"] += 1
                if yard is not None:
                    yardstick.append({"shape": (b, h, kv, sq, skv, d),
                                      "window": window, **yard})
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
        # the 16-byte and tile paths: hd 128, kv 8, chunk edges, partial
        # token tiles, a canon 2 elements off 16 bytes
        for pool_dt, canon_dt in DTYPE_PAIRS:
            for bs, front, seq_len in OVERLAY_WIDE_CASES:
                for stream_rows in (True, False):
                    for offset in (0, 2):
                        _overlay_case(gen, dev, layout, pool_dt, canon_dt, 2,
                                      bs, 8, 128, front, seq_len, stream_rows,
                                      offset)
                        counts["overlay"] += 1
    emit({"phase": 1, "checks": counts, "atol": ATOL,
          "main_bf16": {"floor": BF16_FLOOR, "step": BF16_STEP,
                        "mean": BF16_MEAN, "max_abs_err": main_err},
          "flash_vs_sdpa": {"limit": FLASH_VS_SDPA, "cases": yardstick},
          "overlay": "bit-identical"})

    # timings at the main path's shapes (bfloat16)
    timings = {}
    # flash: a 500-token prefill chunk at offset 1500 against a 2000-slot
    # full-capacity cache (kv_len = capacity, as attention_decode calls it)
    c0, sq, cap, h, d = 1500, 500, 2000, 32, 128
    err, (q, k, v), yard = _flash_case(gen, dev, "bfloat16", 1, h, h, sq,
                                       cap, d, 0, c0, main=True)
    mask = flash_mask(sq, cap, c0, 0, dev)
    pairs = sq * c0 + sq * (sq + 1) // 2
    flops = 4.0 * d * pairs * h
    nbytes = 2.0 * (2 * sq * h * d + 2 * (c0 + sq) * h * d)
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    timings["flash_attention"] = dict(
        shape=f"q(1,{h},{sq},{d}) q_offset={c0} kv(1,{h},{cap},{d}) bf16",
        max_abs_err=err, yardstick=yard,
        **time_all(lambda: ops.flash_attention(q, k, v, q_offset=c0),
                   plain=lambda: ref.flash_attention_ref(q, k, v,
                                                         q_offset=c0),
                   library=lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by)
    # the monolithic 2048-token prefill, for reference
    _, (q2, k2, v2), yard2 = _flash_case(gen, dev, "bfloat16", 1, 32, 32,
                                         2048, 2048, 128, 0, 0, main=True)
    f2 = 4.0 * 128 * 32 * (2048 * 2049 // 2)
    b2, by2 = bound(f2, 2.0 * 4 * 2048 * 32 * 128, "bfloat16")
    emit({"phase": 1, "extra": "flash_attention monolithic prefill",
          "shape": "q,k,v (1,32,2048,128) causal bf16", "yardstick": yard2,
          **time_all(lambda: ops.flash_attention(q2, k2, v2),
                     library=lambda: F.scaled_dot_product_attention(
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
        **time_all(lambda: ops.paged_attention(*args, layout="nbhd"),
                   plain=lambda: ref.paged_attention_ref(*args,
                                                         layout="nbhd")),
        bound_ms=b_ms, bound_by=b_by)
    # paged beyond the timing shape: one 2048-token sequence (the grid of
    # one sequence), phase 3's mixed lengths at its last decode step in its
    # 65-page table, and the main shape in the two other layouts
    prompts = np.random.default_rng(SEED).integers(
        PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    width = -(-(PROMPT_RANGE[1] + MAX_NEW) // 32)
    for what, lay, lens, wd in (
            ("one sequence", "nbhd", [2048], None),
            ("phase 3's lengths", "nbhd",
             [int(n) + MAX_NEW for n in prompts], width),
            ("timing shape", "nhbd", decode_lens, None),
            ("timing shape", "nhdb", decode_lens, None)):
        err, a = _paged_case(gen, dev, "bfloat16", lay, len(lens), 32, 32,
                             128, 32, lens, 0, main=True, width=wd)
        tok = sum(lens)
        p_ms, p_by = bound(4.0 * 128 * 32 * tok, 2.0 * 2 * tok * 32 * 128
                           + 2.0 * 2 * len(lens) * 32 * 128, "bfloat16")
        emit({"phase": 1, "extra": f"paged_attention, {what}, {lay}",
              "shape": f"q({len(lens)},32,128) pools {lay} bs32 bf16, "
                       f"table {a[3].shape[1]} pages, seq_lens {lens}",
              "max_abs_err": err,
              **time_all(lambda: ops.paged_attention(*a, layout=lay),
                         plain=lambda: ref.paged_attention_ref(*a,
                                                               layout=lay)),
              "bound_ms": p_ms, "bound_by": p_by})
        del a
    timings["scatter_pages_overlay"] = phase1_overlay(gen, dev)
    from repro_torch.configs import get_config
    timings.update(phase1_pages(gen, dev, get_config(MODEL)))
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
PHASE3_KERNELS = {"flash_attention", "paged_attention",
                  "scatter_pages_overlay"}
PHASE4_KERNELS = PHASE3_KERNELS | {"gather_pages", "scatter_pages", "repack"}


def check_launched(phase: int, launches, expected) -> None:
    """The path launched exactly the kernels it runs, each at least once."""
    launched = {k for k, n in launches.items() if n > 0}
    if launched != set(expected):
        raise AssertionError(f"phase {phase}: kernels launched {launched}, "
                             f"the path runs {set(expected)}")


def last_token_gap(cfg, params, dev, reqs) -> float:
    """Each request's last token against a monolithic prefill of prompt +
    output[:-1]: the decoded token must be (within bf16 noise) the
    prefill's top choice, and the logits finite. Returns the worst gap."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
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
    return worst


def first_token_yardstick(cfg, params, dev, prompts, reqs):
    """Each request's served first token against a float32 prefill of its
    prompt (params upcast with ``.float()``, which takes the float32 flash
    kernel): its float32 logit must be within LOGIT_SLACK of the float32
    maximum, whatever order bf16 summed in. Returns the worst gap and the
    largest |bf16 - f32| of the last-position logits of ``M.prefill`` in
    bf16. The float32 copy of the weights (27 GB at llama2-7b) is freed
    before the return."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    params32 = tree_to(params, torch.float32)
    gap_max = err_max = 0.0
    for prompt, r in zip(prompts, reqs):
        toks = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
        l16, _ = M.prefill(params, cfg, {"tokens": toks},
                           M.init_caches(cfg, 1, len(prompt), device=dev))
        l32, _ = M.prefill(params32, cfg32, {"tokens": toks},
                           M.init_caches(cfg32, 1, len(prompt), device=dev))
        l16, l32 = l16[0].float(), l32[0].float()
        if not bool(torch.isfinite(l32).all()):
            raise AssertionError(f"{r.req_id}: non-finite float32 logits")
        gap = float(l32.max() - l32[r.output_tokens[0]])
        gap_max = max(gap_max, gap)
        err_max = max(err_max, float((l16 - l32).abs().max()))
        if gap > LOGIT_SLACK:
            raise AssertionError(f"{r.req_id}: first token {r.output_tokens[0]}"
                                 f" is {gap} below the float32 prefill's "
                                 "best logit")
    del params32
    torch.cuda.empty_cache()
    return gap_max, err_max


def tokens_digest(reqs) -> str:
    """sha256 of every request's output tokens, in request order: two runs
    gave the same tokens where their digests agree."""
    h = hashlib.sha256()
    for r in reqs:
        h.update(repr([int(t) for t in r.output_tokens]).encode())
    return h.hexdigest()[:16]


def check_outputs(cfg, reqs) -> None:
    for r in reqs:
        if len(r.output_tokens) != MAX_NEW or r.state.value != "finished":
            raise AssertionError(f"{r.req_id}: {len(r.output_tokens)} tokens, "
                                 f"state {r.state}")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"{r.req_id}: token out of range")


def phase3(dev, around_serve=contextlib.nullcontext, params=None):
    """``around_serve``: a context manager entered around the serving loop
    only (a profiler, say), not around set-up or the checks. ``params``:
    llama2-7b's weights, made from SEED when not given."""
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
    if params is None:
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
    prompts = [r.prompt for r in reqs]
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                      # count the main path only
    with around_serve():
        result = Server(sched).serve(reqs, max_ticks=100_000)
    launches = ops.launch_counts()

    check_outputs(cfg, reqs)
    if dev.type == "cuda":
        check_launched(3, launches, PHASE3_KERNELS)
    worst = last_token_gap(cfg, params, dev, reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else None
    gap32, err16 = first_token_yardstick(cfg, params, dev, prompts, reqs)
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
           "tokens_sha256": tokens_digest(reqs),
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": gap32,
           "last_logits_bf16_vs_f32_max_abs": err16}
    if peak is not None:
        out["peak_mem_gib"] = peak
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 4: the prefix-cache path at full width
# --------------------------------------------------------------------------- #
def serve_prefix_schedule(cfg, params, dev, prompts, prefix_cache: bool):
    """Serve request 0 alone, then the rest together, on fresh P and D
    engines (phase 3's vendors), with or without the prefix cache. Each
    batch gets its own GlobalScheduler over the same engines and pipeline
    (``Server.serve`` waits on its scheduler's running total of finished
    requests). Returns the requests, metrics and the launches counted
    over both batches."""
    import numpy as np
    import torch
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.core.disagg import DisaggPipeline
    from repro_torch.core.kv_transfer import TransferEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, VendorProfile
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import GlobalScheduler
    from repro_torch.serving.server import ServeResult, Server

    max_seq = max(len(p) for p in prompts) + MAX_NEW
    d_vendor = VendorProfile(**D_VENDOR)
    d_blocks = len(prompts) * -(-max_seq // d_vendor.block_size) + 1
    p_eng = Engine("P0", cfg, params, VendorProfile(**P_VENDOR), num_blocks=2,
                   max_batch=1, max_seq_len=max_seq, role="prefill",
                   prefix_cache=prefix_cache, device=dev)
    d_eng = Engine("D0", cfg, params, d_vendor, num_blocks=d_blocks,
                   max_batch=len(prompts), max_seq_len=max_seq,
                   role="decode", prefix_cache=prefix_cache, device=dev)
    copies = {"host_insert_s": 0.0, "cow_copies": 0, "cow_s": 0.0}
    host = p_eng.host_prefix_store
    if host is not None:
        # the default 256 MiB holds 32 P blocks (512 tokens) at llama2-7b
        # width: LRU would evict the prompt's own head blocks
        host.capacity_bytes = HOST_STORE_BYTES
        insert = host.insert_prompt

        def timed_insert(*args):                  # device -> host copies
            torch.cuda.synchronize()              # not the queued prefill
            t = time.perf_counter()
            n = insert(*args)
            copies["host_insert_s"] += time.perf_counter() - t
            return n

        host.insert_prompt = timed_insert
        copy_block = d_eng._copy_block

        def timed_copy(src, dst):                 # the COW repack pair
            torch.cuda.synchronize()
            t = time.perf_counter()
            copy_block(src, dst)
            torch.cuda.synchronize()
            copies["cow_s"] += time.perf_counter() - t
            copies["cow_copies"] += 1

        d_eng._copy_block = timed_copy
    pipe = DisaggPipeline(TransferEngine(), WireFormat("raw", "bfloat16"))
    reqs = [Request(f"req{i}", p, MAX_NEW) for i, p in enumerate(prompts)]
    walls = []
    ops.reset_launch_counts()
    for batch in (reqs[:1], reqs[1:]):
        sched = GlobalScheduler(pipe, prefill_chunk=PREFILL_CHUNK, device=dev)
        sched.add_instance(p_eng)
        sched.add_instance(d_eng)
        walls.append(Server(sched).serve(batch, max_ticks=100_000)
                     .wall_seconds)
    launches = ops.launch_counts()
    result = ServeResult(reqs, sum(walls))
    ttft, tpot = result.ttft(), result.tpot()
    tr = pipe.transfer.stats
    out = {"ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_max_s": float(ttft.max()),
           "tpot_p50_s": float(np.percentile(tpot, 50)),
           "output_tok_s": result.throughput_tok_s(),
           "wall_s": result.wall_seconds, "wire_bytes": tr.bytes_moved,
           "prefill_tokens": p_eng.stats.prefill_tokens,
           "prefill_s": p_eng.stats.prefill_seconds,
           "decode_s": d_eng.stats.decode_seconds,
           "prefix_hit_tokens": tr.prefix_hit_tokens,
           "bytes_saved": tr.bytes_saved,
           "prefix_cached_tokens": p_eng.stats.prefix_cached_tokens,
           "host_store_bytes": host.nbytes if host is not None else 0,
           "d_store_hit_tokens": (d_eng.prefix_store.hit_tokens
                                  if d_eng.prefix_store is not None else 0),
           **copies}
    if host is not None and copies["host_insert_s"] > 0:
        out["host_insert_gb_s"] = host.nbytes / copies["host_insert_s"] / 1e9
    return reqs, out, launches


def phase4(dev, params):
    """llama2-7b at full width with the prefix cache on both engines: one
    PREFIX_LEN-token system prompt shared by N_REQUESTS requests with
    unique tails, cached against cold."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(MODEL)
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN).astype(np.int32)
    tails = rng.integers(TAIL_RANGE[0], TAIL_RANGE[1] + 1, N_REQUESTS)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, int(n))
                               .astype(np.int32)]) for n in tails]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs, cached, launches = serve_prefix_schedule(cfg, params, dev, prompts,
                                                   True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_outputs(cfg, reqs)
    check_launched(4, launches, PHASE4_KERNELS)
    hits = N_REQUESTS - 1
    want = {"prefix_hit_tokens": hits * PREFIX_LEN,
            "d_store_hit_tokens": hits * PREFIX_LEN,
            "prefix_cached_tokens": hits * (PREFIX_LEN // P_VENDOR[
                "block_size"] * P_VENDOR["block_size"])}
    for key, least in want.items():
        if cached[key] < least:
            raise AssertionError(f"phase 4: {key} {cached[key]} < {least}")
    for name in ("gather_pages", "scatter_pages", "repack"):
        if launches[name] < 2 * hits:          # one COW per pool per request
            raise AssertionError(f"phase 4: {name} launched "
                                 f"{launches[name]} < {2 * hits} times")
    worst = last_token_gap(cfg, params, dev, reqs)
    torch.cuda.empty_cache()
    cold_reqs, cold, _ = serve_prefix_schedule(cfg, params, dev, prompts,
                                               False)
    check_outputs(cfg, cold_reqs)
    same = sum(a.output_tokens == b.output_tokens
               for a, b in zip(reqs, cold_reqs))
    out = {"phase": 4, "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "prefix_len": PREFIX_LEN,
           "tail_lens": [int(x) for x in tails], "max_new_tokens": MAX_NEW,
           "prefill_chunk": PREFILL_CHUNK, "cached": cached, "cold": cold,
           "launches": launches, "tokens_identical_to_cold": same,
           "tokens_sha256": {"cached": tokens_digest(reqs),
                             "cold": tokens_digest(cold_reqs)},
           "last_token_logit_gap_max": worst, "peak_mem_gib": peak}
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 5: the cross-process runtime at full width
# --------------------------------------------------------------------------- #
def segments_left(names) -> list:
    """The shared-memory segments of ``names`` that are still linked."""
    return sorted(n for n in names if Path("/dev/shm", n).exists())


def phase5(dev, params):
    """Phase 3's requests through ``TwoProcessRuntime``: P and D engines
    in spawned worker processes on the card, each building its own
    weights from SEED, the KV over shm segments. ``params``: the parent's
    copy of the same weights, for the checks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.serving.engine import VendorProfile
    from repro_torch.serving.multiproc import EngineSpec, TwoProcessRuntime
    from repro_torch.serving.request import Request
    from repro_torch.serving.server import ServeResult

    cfg = get_config(MODEL)
    p_vendor, d_vendor = VendorProfile(**P_VENDOR), VendorProfile(**D_VENDOR)
    rng = np.random.default_rng(SEED)                 # phase 3's draws
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    max_seq = PROMPT_RANGE[1] + MAX_NEW
    d_blocks = N_REQUESTS * -(-max_seq // d_vendor.block_size) + 1
    on = None if dev.type == "cuda" else "cpu"   # None: the card
    p_spec = EngineSpec("P0", cfg, p_vendor, params_seed=SEED, num_blocks=2,
                        max_batch=1, max_seq_len=max_seq, role="prefill",
                        device=on)
    d_spec = EngineSpec("D0", cfg, d_vendor, params_seed=SEED,
                        num_blocks=d_blocks, max_batch=N_REQUESTS,
                        max_seq_len=max_seq, role="decode", device=on)
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), MAX_NEW) for i, n in enumerate(lens)]
    prompts = [r.prompt.copy() for r in reqs]
    rt = TwoProcessRuntime(p_spec, d_spec, wire=WireFormat("raw", "bfloat16"),
                           prefill_chunk=PREFILL_CHUNK)
    try:
        t0 = time.perf_counter()
        rt.start(spawn_timeout_s=300.0)
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.serve(reqs, max_wall_s=600.0)
        wall = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left = segments_left(rt.segments_seen)
    launches = {}
    for counts in rt.worker_launches.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    check_outputs(cfg, reqs)
    # a P-side failure (PrefillFailed) is requeued and may be retried to a
    # good end: requeues and failures count as faults here too
    if (rt.stream_failures or sum(rt.crashes.values())
            or rt.stats.requeues or rt.stats.failed):
        raise AssertionError(f"phase 5: stream failures {rt.stream_failures},"
                             f" crashes {rt.crashes}, requeues "
                             f"{rt.stats.requeues}, failed {rt.stats.failed}")
    if set(rt.worker_launches) != {"P0", "D0"}:
        raise AssertionError(f"phase 5: launch counts from "
                             f"{sorted(rt.worker_launches)}, not P0 and D0")
    if dev.type == "cuda":
        check_launched(5, launches, PHASE3_KERNELS)
    if not rt.segments_seen or left:
        raise AssertionError(f"phase 5: {len(rt.segments_seen)} segments "
                             f"seen, {left} left after shutdown")
    worst = last_token_gap(cfg, params, dev, reqs)
    gap32, err16 = first_token_yardstick(cfg, params, dev, prompts, reqs)
    result = ServeResult(reqs, wall)
    ttft, tpot = result.ttft(), result.tpot()
    tr = rt.transfer_stats
    out = {"phase": 5, "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "runtime": "TwoProcessRuntime",
           "connector": "shm", "requests": N_REQUESTS,
           "prompt_lens": [int(x) for x in lens], "max_new_tokens": MAX_NEW,
           "prefill_chunk": PREFILL_CHUNK,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_max_s": float(ttft.max()),
           "tpot_p50_s": float(np.percentile(tpot, 50)),
           "output_tok_s": result.throughput_tok_s(),
           "wall_s": wall, "spawn_to_hello_s": spawn_s,
           "worker_pids": rt.worker_pids, "parent_pid": os.getpid(),
           "launches": launches, "worker_launches": rt.worker_launches,
           "wire_bytes": tr.bytes_moved, "wire_transfers": tr.transfers,
           "chunks_streamed": rt.stats.chunks_streamed,
           "requeues": rt.stats.requeues, "failed": rt.stats.failed,
           "wall_handoff_s": tr.wall_handoff_seconds,
           "wall_overlap_s": tr.wall_overlap_seconds,
           "segments_seen": len(rt.segments_seen),
           "segments_left": len(left),
           "prefill_s": rt.worker_stats["P0"]["prefill_seconds"],
           "decode_steps": rt.worker_stats["D0"]["decode_steps"],
           "decode_s": rt.worker_stats["D0"]["decode_seconds"],
           "tokens_sha256": tokens_digest(reqs),
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": gap32,
           "last_logits_bf16_vs_f32_max_abs": err16}
    emit(out)
    return out


KERNELS = [
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
     "src/repro/kernels/flash_attention.py:78", 3),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:81", 3),
    ("scatter_pages_overlay", "src/repro_torch/kernels/csrc/kv_repack.cu",
     "src/repro/kernels/kv_repack.py:115", 3),
    ("gather_pages", "src/repro_torch/kernels/csrc/kv_repack.cu",
     "src/repro/kernels/kv_repack.py:45", 4),
    ("scatter_pages", "src/repro_torch/kernels/csrc/kv_repack.cu",
     "src/repro/kernels/kv_repack.py:75", 4),
    ("repack", "src/repro_torch/kernels/kv_repack.py",
     "src/repro/kernels/kv_repack.py:154", 4),
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

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    smi = phase0()
    timings = phase1(dev)
    phase2(dev)
    torch.cuda.empty_cache()
    params = M.init_params(get_config(MODEL), seed=SEED, device=dev)
    paths = {3: phase3(dev, params=params)}
    torch.cuda.empty_cache()
    paths[4] = phase4(dev, params)
    torch.cuda.empty_cache()             # the workers need the memory back
    paths[5] = phase5(dev, params)

    rows = []
    for name, source, replaces, phase in KERNELS:
        t = timings[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": paths[phase]["launches"][name],
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "device_ms": t["device_ms"],
               "library_device_ms": t["library_device_ms"],
               "device_method": t["device_method"], "host_us": t["host_us"]}
        if name == "repack":
            row["composition"] = "gather_pages + scatter_pages"
        rows.append(row)
    print(smi, flush=True)
    emit({"total_s": round(time.perf_counter() - t_start, 3)})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
