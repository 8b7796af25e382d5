"""Decode attention over dense position-tagged caches — ring buffers and
float8 caches — against the JAX package, on the CPU.

  * ``ref.cache_attention_ref`` (the flash_decode kernel's plain version)
    equals the reference's ``cache_attention_mask`` + ``sdpa`` on caches
    the reference's ``kv_cache_write`` filled, within atol 1e-5 in float32:
    rings filled to unaligned lengths (the ring starting mid-buffer),
    partly filled rings (pos -1), full-capacity caches; windows 0 and > 0;
    groups 1, 4 and 16 at head dims 64, 128 and 256; one and three query
    rows;
  * float8 e4m3 K/V: torch's widening of every finite e4m3 value equals
    jnp's cast bit for bit (all lie within +-448), the cast of the same
    float32 values gives the same bytes, and the attention over the float8
    caches equals the reference's within 1e-5;
  * ``ops.cache_attention`` on CPU tensors is the plain version and
    launches nothing;
  * the route: on ``meta`` under ``ops.count_as_card`` a one-row decode
    over any dense cache, and a chunk of rows over a ring or a float8
    cache, call ``ops.cache_attention`` (tallying each row's visible
    slots); a chunk over a full-capacity bfloat16 cache calls flash;
  * the serve step of the tiny sliding and hybrid families on rings, and
    of the tiny dense family from a float8 D cache, on the kernel route
    (``layers.kernel_route`` patched to True: ``ops`` runs the plain
    versions on CPU tensors) equals the reference's builders on an
    Auto-typed 1x1 mesh (``tests/test_torch_launch_steps.py``'s oracle).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.launch import cells as RC
from repro.launch import steps as RS
from repro.models import layers as JL
from repro_torch.configs.base import config_from_dict
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy

from conftest import TINY_FAMILIES
from test_torch_launch_steps import (ATOL, SEQ, _INIT, _close_tree, _inputs,
                                     _j, _to_port, jmesh, tmesh)  # noqa: F401
from test_torch_launch_steps import _cell as _launch_cell

# (kv heads, query heads, head dim): groups 1, 4 and 16
GROUPS = [(2, 2, 64), (2, 8, 128), (1, 16, 256)]
# (capacity, positions written): a ring filled to an unaligned length (37
# into 16: slot 5 holds the oldest), a ring partly filled (pos -1 in 6
# slots), a full-capacity cache with room left
FILLS = {"ring": (16, 37), "ring_partial": (16, 10), "full": (48, 37)}


def _write_ref_cache(rng, cap, n, kvh, hd, dtype=jnp.float32, b=2):
    """The reference's cache of ``n`` positions written by its
    ``kv_cache_write``, 5 positions a call (a chunk, then decode steps)."""
    cache = JL.kv_cache_init(b, cap, kvh, hd, dtype)
    for s in range(0, n, 5):
        e = min(n, s + 5)
        k = rng.standard_normal((b, e - s, kvh, hd)).astype(np.float32)
        v = rng.standard_normal((b, e - s, kvh, hd)).astype(np.float32)
        pos = np.broadcast_to(np.arange(s, e, dtype=np.int32), (b, e - s))
        cache = JL.kv_cache_write(cache, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos))
    return cache


def _ref_attention(q, cache, q_offset, window):
    sq = q.shape[1]
    qpos = jnp.broadcast_to(jnp.arange(q_offset, q_offset + sq,
                                       dtype=jnp.int32), (q.shape[0], sq))
    mask = JL.cache_attention_mask(cache, qpos, window)
    return np.asarray(JL.sdpa(jnp.asarray(q), cache.k, cache.v, mask))


def _port_attention(q, cache, q_offset, window, kv_dtype=torch.float32):
    k, v = (_f8(x) if kv_dtype == torch.float8_e4m3fn else
            torch.from_numpy(np.array(x, np.float32)).to(kv_dtype)
            for x in (cache.k, cache.v))
    pos = torch.from_numpy(np.asarray(cache.pos))
    return ref.cache_attention_ref(torch.from_numpy(q), k, v, pos,
                                   q_offset=q_offset, window=window).numpy()


def _f8(x):
    """A jnp float8 array as a torch float8 tensor, through its bytes."""
    return torch.from_numpy(np.asarray(x).view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("kvh,h,hd", GROUPS)
@pytest.mark.parametrize("fill", sorted(FILLS))
def test_cache_attention_ref_matches_reference(fill, kvh, h, hd, window, sq):
    cap, n = FILLS[fill]
    rng = np.random.default_rng(cap * n + hd + window + sq)
    cache = _write_ref_cache(rng, cap, n, kvh, hd)
    q = rng.standard_normal((2, sq, h, hd)).astype(np.float32)
    q_offset = n - sq          # the rows are the last positions written
    want = _ref_attention(q, cache, q_offset, window)
    got = _port_attention(q, cache, q_offset, window)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_e4m3_widening_equals_jnp_bit_for_bit():
    """Every finite e4m3 value (all within +-448) widens to the same
    float32 bits in torch as in jnp; NaN stays NaN."""
    bits = np.arange(256, dtype=np.uint8)
    want = bits.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    want_j = np.asarray(jnp.asarray(bits.view(ml_dtypes.float8_e4m3fn))
                        .astype(jnp.float32))
    got = torch.from_numpy(bits).view(torch.float8_e4m3fn).float().numpy()
    finite = np.isfinite(want)
    assert finite.sum() == 254 and np.abs(want[finite]).max() == 448.0
    np.testing.assert_array_equal(got[finite].view(np.uint32),
                                  want_j[finite].view(np.uint32))
    assert np.isnan(got[~finite]).all() and np.isnan(want_j[~finite]).all()


@pytest.mark.parametrize("kvh,h,hd", GROUPS)
@pytest.mark.parametrize("fill", ["ring", "full"])
def test_cache_attention_ref_on_e4m3_caches_matches_reference(fill, kvh, h,
                                                              hd):
    """The reference's float8 cache (its cast on write) and the port's
    bytes of it: the same bytes as torch's cast of the same values, and
    attention over them within 1e-5 (both widen to float32, no scale)."""
    cap, n = FILLS[fill]
    rng = np.random.default_rng(hd + n)
    cache = _write_ref_cache(rng, cap, n, kvh, hd, jnp.float8_e4m3fn)
    k32 = torch.from_numpy(rng.standard_normal((2, n, kvh, hd))
                           .astype(np.float32) * 100).clamp(-448, 448)
    assert torch.equal(
        k32.to(torch.float8_e4m3fn).view(torch.uint8),
        _f8(jnp.asarray(k32.numpy()).astype(jnp.float8_e4m3fn))
        .view(torch.uint8))
    q = rng.standard_normal((2, 1, h, hd)).astype(np.float32)
    for window in (0, 6):
        want = _ref_attention(q, cache, n - 1, window)
        got = _port_attention(q, cache, n - 1, window, torch.float8_e4m3fn)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_cache_attention_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64))
                         .astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 64))
                             .astype(np.float32)).to(torch.float8_e4m3fn)
            for _ in range(2))
    pos = torch.arange(21, 37, dtype=torch.int32).roll(5).expand(2, 16)
    ops.reset_launch_counts()
    got = ops.cache_attention(q, k, v, pos.contiguous(), q_offset=36,
                              window=16)
    want = ref.cache_attention_ref(q, k, v, pos, q_offset=36, window=16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("cap,window,q_offset,sq",
                         [(16, 16, 40, 1), (16, 16, 3, 1), (16, 16, 3, 4),
                          (64, 0, 40, 1), (64, 0, 40, 4), (64, 10, 40, 1),
                          (64, 10, 40, 4)])
def test_visible_slots_equal_the_plain_mask(cap, window, q_offset, sq):
    """``ops.cache_visible_slots`` is the count of (row, slot) pairs the
    plain version's mask lets through on a cache that holds every position
    up to the last row's (a ring's last ``cap``, wrapped)."""
    last = q_offset + sq - 1
    pos = torch.full((cap,), -1, dtype=torch.int64)
    held = torch.arange(max(0, last + 1 - cap), last + 1)
    pos[held % cap] = held
    qp = torch.arange(q_offset, q_offset + sq)[:, None]
    ok = (pos >= 0) & (pos <= qp)
    if window:
        ok &= (qp - pos) < window
    assert ops.cache_visible_slots(sq, cap, window=window,
                                   q_offset=q_offset) == int(ok.sum())


# (cache, K/V dtype, window) → the op the kernel route calls for a chunk of
# several rows; one row takes ``cache_attention`` on every cache
ROUTES = [("ring", torch.bfloat16, 8, "cache_attention"),
          ("full", torch.float8_e4m3fn, 0, "cache_attention"),
          ("ring", torch.float8_e4m3fn, 8, "cache_attention"),
          ("full", torch.bfloat16, 0, "flash_attention"),
          ("full", torch.bfloat16, 8, "flash_attention")]


@pytest.mark.parametrize("kind,kv_dtype,window,op", ROUTES)
def test_decode_route_on_meta(kind, kv_dtype, window, op, monkeypatch):
    """``attention_decode`` on ``meta`` as the card runs it: one query row
    goes to ``ops.cache_attention`` on every cache, whose tally is the
    row's visible slots; a chunk of 3 rows over a ring or a float8 cache
    too (each row's visible slots), and over a full-capacity bfloat16
    cache to flash."""
    cfg = config_from_dict(dict(
        dataclasses.asdict(TINY_FAMILIES["dense-bias-qknorm"]),
        param_dtype="bfloat16", compute_dtype="bfloat16"))
    gen = torch.Generator().manual_seed(0)
    p = {k: t.to("meta") for k, t in
         TL.init_attention(gen, cfg, torch.device("cpu")).items()}
    b, q_offset = 2, 40
    cap = window if kind == "ring" else 64
    calls = {"cache_attention": 0, "flash_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    for sq, want_op in ((1, "cache_attention"), (3, op)):
        cache = TL.kv_cache_init(b, cap, cfg.num_kv_heads, cfg.hd, kv_dtype,
                                 torch.device("meta"),
                                 full_capacity=kind == "full").layer(0)
        x = torch.empty((b, sq, cfg.d_model), dtype=torch.bfloat16,
                        device="meta")
        positions = torch.empty((b, sq), dtype=torch.int32, device="meta")
        for name in calls:
            calls[name] = 0
        with ops.count_as_card() as tally:
            out, _ = TL.attention_decode(p, cfg, x, positions, cache,
                                         window=window, q_offset=q_offset)
        assert out.shape == (b, sq, cfg.d_model)
        assert calls == {o: int(o == want_op) for o in calls}
        if want_op == "cache_attention":
            seen = sum(min(q_offset + i + 1, cap, window or cap)
                       for i in range(sq))
            assert tally == {"flash_decode": 2.0 * b * cfg.num_heads * seen
                             * 2 * cfg.hd}
        else:
            assert set(tally) == {"flash_attention"}


@pytest.fixture(params=["sliding", "hybrid", "dense-f8"])
def ring_fam(request, monkeypatch):
    """A tiny family whose serve step takes ``ops.cache_attention``: the
    sliding and hybrid families on rings, the dense family from a float8
    D cache; cells as ``tests/test_torch_launch_steps.py``'s."""
    name = request.param.removesuffix("-f8")
    jcfg = TINY_FAMILIES[name]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    d_dtype = "float8_e4m3fn" if request.param.endswith("-f8") \
        else "float32"
    cells = {"prefill_32k": _launch_cell("prefill_32k",
                                         cache_dtype="float32"),
             "decode_32k": _launch_cell("decode_32k", cache_dtype=d_dtype)}
    monkeypatch.setattr(RS, "get_config", lambda arch: jcfg)
    monkeypatch.setattr(TS, "get_config", lambda arch: tcfg)
    monkeypatch.setattr(RC, "get_cell", lambda arch, shape: cells[shape])
    monkeypatch.setattr(TS, "get_cell", lambda arch, shape: cells[shape])
    jp = _INIT(jax.random.key(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, cells=cells,
                tp=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def test_serve_step_on_the_kernel_route_matches_reference(ring_fam, jmesh,
                                                          tmesh, monkeypatch):
    """The reference's prefill → handoff → serve step against the port's
    serve step on the handed-off caches, the port on the kernel route: one
    ``ops.cache_attention`` call a layer that attends (rings of the window,
    or float8 K/V), logits and caches within 1e-5."""
    fam = ring_fam
    art = RS.make_prefill_artifacts(fam["cells"]["prefill_32k"], jmesh)
    batch = _inputs(art.abstract_args[1], fam["jcfg"])
    jlast, jcaches = art.fn(fam["jp"], _j(batch, art.abstract_args[1]))
    jcaches = RS.make_handoff_artifacts("qwen3-4b", jmesh).fn(jcaches)
    jart = RS.make_serve_artifacts(fam["cells"]["decode_32k"], jmesh)
    tart = TS.make_serve_artifacts(fam["cells"]["decode_32k"], tmesh)
    tok = np.asarray(jnp.argmax(jlast, -1), np.int32)[:, None]
    io = {"tokens": tok, "positions": np.full_like(tok, SEQ)}
    caches = _to_port(jcaches, tart.abstract_args[1])
    jlog, jcaches = jart.fn(fam["jp"], jcaches,
                            {k: jnp.asarray(v) for k, v in io.items()})
    calls = []
    real = ops.cache_attention

    def spy(q, k, v, pos, **kw):
        calls.append((tuple(k.shape), k.dtype, kw))
        return real(q, k, v, pos, **kw)

    monkeypatch.setattr(ops, "cache_attention", spy)
    monkeypatch.setattr(TL, "kernel_route", lambda x: True)
    with torch.no_grad():
        log, caches = tart.fn(fam["tp"], caches,
                              {k: torch.from_numpy(v) for k, v in io.items()})
    cfg = tart.cfg
    attending = sum(g.count * sum(k == TM.ATTN for k in g.kinds)
                    for g in TM.block_groups(cfg))
    assert len(calls) == attending > 0
    for shape, dtype, kw in calls:
        assert kw["q_offset"] == SEQ
        if dtype == torch.float8_e4m3fn:
            assert shape[1] == fam["cells"]["decode_32k"].decode_capacity()
        else:
            assert shape[1] == cfg.sliding_window == kw["window"]
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    _close_tree(caches, jcaches)
