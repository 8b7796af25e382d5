"""The port's dense model against the JAX package's, on the CPU in float32.

Parameters come from the JAX ``init_params`` and cross through numpy
(``params_from_numpy``). Logits agree within atol 1e-4: XLA's CPU einsum
and torch's matmul sum in different orders. Greedy tokens must be
identical. The kernel route's plumbing (transposes, q_offset, kv_len,
pool layouts) is checked on the CPU by sending it through the kernels'
plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.serving import paged_cache as JPC
from repro_torch.configs.base import config_from_dict
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import paged_cache as TPC

from conftest import TINY_FAMILIES

ATOL = 1e-4
FAMILIES = ["dense", "dense-bias-qknorm"]
PROMPT = 13


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    jcfg = TINY_FAMILIES[request.param]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(0), jcfg)
    if jcfg.qkv_bias:          # the reference initialises biases to zero:
        rng = np.random.default_rng(5)     # give them values to carry
        attn = jp["groups"][0][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.standard_normal(attn[name].shape),
                                     jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (1, n)).astype(np.int32)


def test_params_carry_across(pair):
    jcfg, tcfg, jp, tp = pair
    assert len(jax.tree_util.tree_leaves(jp)) == len(
        jax.tree_util.tree_leaves(jax.tree.map(lambda t: t.numpy(), tp)))
    np.testing.assert_array_equal(
        np.asarray(jp["groups"][0][0]["attn"]["wq"]),
        tp["groups"][0][0]["attn"]["wq"].numpy())
    assert tp["groups"][0][0]["mlp"]["w_up"].shape == \
        (jcfg.num_layers, jcfg.d_model, jcfg.d_ff)


def test_prefill_logits_and_cache(pair):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, PROMPT)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JM.init_caches(jcfg, 1, PROMPT))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        TM.init_caches(tcfg, 1, PROMPT, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tc[0][0].k.numpy(), np.asarray(jc[0][0].k),
                               atol=ATOL)
    np.testing.assert_array_equal(tc[0][0].pos.numpy(),
                                  np.asarray(jc[0][0].pos))


def test_chunked_decode_step_logits(pair):
    """Incremental prefill: chunks of 5 through decode_step over a
    full-capacity dense cache (what PrefillStream runs)."""
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, PROMPT, seed=1)
    cap = 15
    jc = JM.init_caches(jcfg, 1, cap, full_capacity=True)
    tc = TM.init_caches(tcfg, 1, cap, full_capacity=True, device="cpu")
    for c0 in range(0, PROMPT, 5):
        c1 = min(c0 + 5, PROMPT)
        pos = np.arange(c0, c1, dtype=np.int32)[None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, c0:c1]),
                                jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, c0:c1]),
                                torch.from_numpy(pos), tc, q_offset=c0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def _paged_setup(jcfg, tcfg, layout, bs=4, nblocks=16):
    spec_t = TPC.KVPageSpec(bs, layout, "float32", jcfg.num_kv_heads, jcfg.hd)
    spec_j = JPC.KVPageSpec(bs, layout, "float32", jcfg.num_kv_heads, jcfg.hd)
    return ({"kv": spec_j}, JM.init_paged_caches(jcfg, {"kv": spec_j}, nblocks),
            {"kv": spec_t}, TM.init_paged_caches(tcfg, {"kv": spec_t}, nblocks,
                                                 device="cpu"))


def _greedy(pair, layout, steps):
    """Prefill, scatter the prompt KV into paged pools, then greedy paged
    decode — in both packages. Returns per-step logits and tokens."""
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, PROMPT, seed=2)
    bs = 4
    js, jpool, ts, tpool = _paged_setup(jcfg, tcfg, layout, bs)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JM.init_caches(jcfg, 1, PROMPT))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        TM.init_caches(tcfg, 1, PROMPT, device="cpu"))
    blocks = np.arange(1, 9, dtype=np.int32)          # block 0 = scratch
    nb = -(-PROMPT // bs)
    for name, jname in (("k_pool", "k"), ("v_pool", "v")):
        for li in range(jcfg.num_layers):
            src = np.array(getattr(jc[0][0], jname)[li, 0])
            jpool[0][0][name] = jpool[0][0][name].at[li].set(
                JPC.scatter_sequence(js["kv"], jpool[0][0][name][li],
                                     jnp.asarray(blocks[:nb]),
                                     jnp.asarray(src)))
            TPC.scatter_sequence(ts["kv"], tpool[0][0][name][li],
                                 torch.from_numpy(blocks[:nb]),
                                 torch.from_numpy(src))
    table = blocks[None]
    jdecode = jax.jit(lambda p, *a: JM.decode_step_paged(p, jcfg, *a, js))
    jtok = int(np.argmax(np.asarray(jl)[0]))
    ttok = int(np.argmax(tl.numpy()[0]))
    out = [(np.asarray(jl), tl.numpy(), jtok, ttok)]
    for step in range(steps):
        sl = np.asarray([PROMPT + step], np.int32)
        wb = blocks[sl // bs]
        ws = (sl % bs).astype(np.int32)
        jl, jpool = jdecode(
            jp, jnp.asarray([[jtok]], jnp.int32), jnp.asarray(sl),
            jnp.asarray(table), jnp.asarray(wb), jnp.asarray(ws), jpool)
        tl, tpool = TM.decode_step_paged(
            tp, tcfg, torch.tensor([[ttok]], dtype=torch.int32),
            torch.from_numpy(sl), torch.from_numpy(table),
            torch.from_numpy(wb), torch.from_numpy(ws), tpool, ts)
        jtok = int(np.argmax(np.asarray(jl)[0, 0]))
        ttok = int(np.argmax(tl.numpy()[0, 0]))
        out.append((np.asarray(jl)[:, 0], tl.numpy()[:, 0], jtok, ttok))
    return out


@pytest.mark.parametrize("layout", ["nbhd", "nhdb"])
def test_paged_decode_logits_and_16_greedy_tokens(pair, layout):
    steps = _greedy(pair, layout, steps=15)
    for jl, tl, _, _ in steps:
        np.testing.assert_allclose(tl, jl, atol=ATOL)
    assert [s[2] for s in steps] == [s[3] for s in steps]
    assert len(steps) == 16


@pytest.mark.parametrize("layout", ["nbhd", "nhbd", "nhdb"])
def test_kernel_route_matches_plain_route(pair, layout, monkeypatch):
    """The CUDA route's argument plumbing, run through the kernels' plain
    versions on the CPU: flash with q_offset/kv_len over a full-capacity
    cache, paged attention over every pool layout."""
    _, tcfg, _, tp = pair
    toks = torch.from_numpy(_tokens(tcfg, PROMPT, seed=3))

    def run():
        tl, tc = TM.prefill(tp, tcfg, {"tokens": toks},
                            TM.init_caches(tcfg, 1, PROMPT, device="cpu"))
        dense = TM.init_caches(tcfg, 1, 16, full_capacity=True, device="cpu")
        TM.decode_step(tp, tcfg, toks[:, :8], torch.arange(8)[None], dense,
                       q_offset=0)
        cl, _ = TM.decode_step(tp, tcfg, toks[:, 8:], torch.arange(8, 13)[None],
                               dense, q_offset=8)
        spec = TPC.KVPageSpec(4, layout, "float32", tcfg.num_kv_heads, tcfg.hd)
        pools = TM.init_paged_caches(tcfg, {"kv": spec}, 8, device="cpu")
        ids = torch.arange(1, 5, dtype=torch.int32)
        for name, src in (("k_pool", tc[0][0].k), ("v_pool", tc[0][0].v)):
            for li in range(tcfg.num_layers):
                TPC.scatter_sequence(spec, pools[0][0][name][li], ids,
                                     src[li, 0])
        dl, _ = TM.decode_step_paged(
            tp, tcfg, toks[:, :1], torch.tensor([PROMPT], dtype=torch.int32),
            torch.arange(1, 6, dtype=torch.int32)[None],
            torch.tensor([4], dtype=torch.int32),
            torch.tensor([PROMPT % 4], dtype=torch.int32), pools,
            {"kv": spec})
        return tl, cl, dl

    plain = run()
    monkeypatch.setattr(TL, "kernel_route", lambda x: True)
    kernel = run()
    for p, k in zip(plain, kernel):
        np.testing.assert_allclose(k.numpy(), p.numpy(), atol=ATOL)


def test_flash_route_refuses_a_cache_without_slot_equals_position(pair,
                                                                 monkeypatch):
    _, tcfg, _, tp = pair
    monkeypatch.setattr(TL, "kernel_route", lambda x: True)
    toks = torch.from_numpy(_tokens(tcfg, 4))
    with pytest.raises(AssertionError, match="full-capacity"):
        TM.decode_step(tp, tcfg, toks, torch.arange(4)[None],
                       TM.init_caches(tcfg, 1, 8, device="cpu"), q_offset=0)
