"""The port's roofline (``roofline/analysis.py``) on the CPU.

  * The copied functions pass the reference's own cases of
    tests/test_roofline.py — MoE active parameters, seconds and dominant
    term with ``V5E`` — and ``model_flops`` and ``useful_ratio`` agree
    with the reference's on every ``ASSIGNED`` arch.
  * ``H100_SXM`` is the planner's nominal ``h100-sxm`` spec.
  * ``ops.flash_visible_keys`` equals the number of pairs the plain
    version's mask lets through.
  * ``analyze_step`` on a tiny dense prefill and serve step on ``meta``
    equals a hand count of its products and bytes (exactly: integers):
    attention's products are the causal pairs only, and the caches that
    the serve step updates in place are counted once.
  * For every ``ASSIGNED`` arch at narrow widths and its full depth, the
    prefill and serve steps counted as the card runs them: one flash call
    a layer that attends (a serve step's one-row self-attention: one
    ``cache_attention`` call, the flash_decode kernel), their products the
    pairs the plain versions' masks let through, and the outputs that
    update an argument in place
    (every cache of a serve step) not counted again; a train step's count
    is linear in depth.
"""
import dataclasses

import pytest
import torch

from repro.configs import ASSIGNED
from repro.roofline import analysis as JRA
from repro_torch.configs.base import get_config
from repro_torch.core.planner import hardware as HWS
from repro_torch.kernels import ops
from repro_torch.launch import cells as TC
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.roofline import analysis as RA


def test_terms_seconds_and_dominant_with_v5e():
    t = RA.RooflineTerms(flops=197e12, hbm_bytes=819e9 * 3,
                         wire_bytes=50e9 * 0.5, convert_bytes=819e9)
    s = t.seconds(RA.V5E)
    assert s["compute"] == pytest.approx(1.0)
    assert s["memory"] == pytest.approx(2.0)       # corrected: 3-1
    assert s["memory_raw"] == pytest.approx(3.0)
    assert s["collective"] == pytest.approx(0.5)
    assert t.dominant(RA.V5E) == "memory"
    assert t.step_time(RA.V5E) == pytest.approx(2.0)
    assert dataclasses.asdict(RA.V5E) == dataclasses.asdict(JRA.V5E)


def test_h100_constants_are_the_planners_nominal_spec():
    spec = HWS.get("h100-sxm")
    assert RA.H100_SXM.peak_flops == spec.tflops * 1e12 == 989.4e12
    assert RA.H100_SXM.hbm_bw == 3350e9 and RA.H100_SXM.link_bw == 450e9
    t = RA.RooflineTerms(flops=989.4e12, hbm_bytes=3350e9 * 2)
    assert t.seconds() == t.seconds(RA.H100_SXM)       # the default
    assert t.dominant() == "memory" and t.step_time() == pytest.approx(2.0)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_and_useful_ratio_match_the_reference(arch):
    for mode in ("train", "prefill", "decode"):
        assert RA.model_flops(arch, mode, 1000) == \
            JRA.model_flops(arch, mode, 1000)
        assert RA.useful_ratio(arch, mode, 10, 1e15) == \
            JRA.useful_ratio(arch, mode, 10, 1e15)


def test_model_flops_moe_uses_active_params():
    dense = RA.model_flops("qwen3-4b", "train", 1000)
    assert dense == pytest.approx(6.0 * get_config("qwen3-4b").param_count()
                                  * 1000)
    moe_cfg = get_config("mixtral-8x7b")
    moe = RA.model_flops("mixtral-8x7b", "decode", 10)
    assert moe == pytest.approx(2.0 * moe_cfg.active_param_count() * 10)
    assert moe_cfg.active_param_count() < 0.4 * moe_cfg.param_count()
    assert RA.useful_ratio("qwen3-4b", "train", 10, 0.0) == 0.0


def _mask_pairs(sq, skv, *, causal, window, q_offset, kv_len):
    """The pairs ``flash_attention_ref``'s mask lets through."""
    qi = torch.arange(sq)[:, None] + q_offset
    kj = torch.arange(skv)[None, :]
    ok = (kj < kv_len).expand(sq, skv)
    if causal:
        ok = ok & (kj <= qi)
    if window > 0:
        ok = ok & ((qi - kj) < window)
    return int(ok.sum())


@pytest.mark.parametrize("sq,skv,causal,window,q_offset,kv_len", [
    (32, 32, True, 0, 0, 32), (32, 32, True, 8, 0, 32),
    (1, 40, True, 0, 35, 40), (5, 40, True, 0, 30, 33),
    (7, 16, False, 0, 0, 11), (6, 24, True, 4, 18, 24),
    (3, 8, True, 0, 20, 8), (16, 16, False, 5, 0, 16),
])
def test_flash_visible_keys_equal_the_plain_mask(sq, skv, causal, window,
                                                 q_offset, kv_len):
    assert ops.flash_visible_keys(sq, kv_len, causal=causal, window=window,
                                  q_offset=q_offset) == \
        _mask_pairs(sq, skv, causal=causal, window=window,
                    q_offset=q_offset, kv_len=kv_len)


# --------------------------------------------------------------------- #
# counting on meta
# --------------------------------------------------------------------- #
META = make_mesh((1, 1), ("data", "model"), device="meta")


def _narrow(arch):
    """``arch`` at narrow widths, its depth and layer pattern kept."""
    cfg = get_config(arch)
    kw = dict(d_model=64, num_heads=4, head_dim=16, d_ff=128,
              vocab_size=256, num_kv_heads=min(cfg.num_kv_heads, 2),
              max_source_len=16)
    if cfg.is_moe:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                        d_ff_expert=32)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, kv_lora_rank=32,
                                        qk_nope_head_dim=16,
                                        qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm is not None:
        kw.update(num_heads=8, d_ff=0, num_kv_heads=0,
                  ssm=dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                          chunk_size=8))
    if cfg.recurrent is not None:
        kw["recurrent"] = dataclasses.replace(cfg.recurrent, lru_width=64)
        kw["sliding_window"] = 8
    if cfg.attention_kind == "sliding":
        kw["sliding_window"] = 8
    if cfg.frontend.kind == "vision":
        kw["frontend"] = dataclasses.replace(cfg.frontend, num_patches=4)
    return cfg.with_(**kw)


def _count(mode, override=None, batch=1, seq=32):
    shape = {"prefill": "prefill_32k", "decode": "decode_32k",
             "train": "train_4k"}[mode]
    cell = dataclasses.replace(TC.get_cell("qwen3-4b", shape), batch=batch,
                               seq_len=seq, n_micro=1)
    art = TS.make_artifacts(cell, META, layer_override=override)
    return RA.analyze_step(art.fn, *art.abstract_args)


def test_analyze_step_counts_a_tiny_prefill_by_hand(monkeypatch):
    cfg = get_config("qwen3-4b").with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256)
    monkeypatch.setattr(TS, "get_config", lambda arch: cfg)
    b, s, d, h, kv, hd, f, v = 2, 12, 64, 4, 2, 16, 128, 256
    causal = s * (s + 1) // 2                         # (query, key) pairs
    per_layer = (2 * b * s * d * (h + 2 * kv) * hd    # q, k, v projections
                 + 2 * b * h * causal * 2 * hd        # scores and P·V
                 + 2 * b * s * h * hd * d             # output projection
                 + 3 * 2 * b * s * d * f)             # gate, up, down
    head = 2 * b * d * v                               # last position only
    terms = _count("prefill", batch=b, seq=s)
    assert terms.flops == 2 * per_layer + head
    assert terms.flash_flops == 2 * 2 * b * h * causal * 2 * hd
    assert terms.wire_bytes == 0
    # arguments (bf16 params, int32 tokens) and outputs (bf16 logits,
    # caches: bf16 K/V, int32 pos), once each
    params = (v * d * 2 + d + 2 * (d * (h + 2 * kv) * hd + h * hd * d
                                   + 3 * d * f + 2 * d + 2 * hd)) * 2
    caches = 2 * (2 * b * s * kv * hd * 2 + b * s * 4)
    assert terms.hbm_bytes == params + b * s * 4 + b * v * 2 + caches


def test_analyze_step_counts_a_tiny_serve_step_by_hand(monkeypatch):
    """One decode token at position s over a dense cache of 144 slots
    (s + 128 rounded up to a multiple of 16): the flash call's products are its s + 1 visible keys; the
    caches, updated in place, are counted once, as arguments."""
    cfg = get_config("qwen3-4b").with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256)
    monkeypatch.setattr(TS, "get_config", lambda arch: cfg)
    b, s, d, h, kv, hd, f, v = 2, 12, 64, 4, 2, 16, 128, 256
    cap = 144                  # decode_capacity: s + 128, to a 16 multiple
    per_layer = (2 * b * d * (h + 2 * kv) * hd + 2 * b * h * (s + 1) * 2 * hd
                 + 2 * b * h * hd * d + 3 * 2 * b * d * f)
    terms = _count("decode", batch=b, seq=s)
    assert terms.flops == 2 * per_layer + 2 * b * d * v
    params = (v * d * 2 + d + 2 * (d * (h + 2 * kv) * hd + h * hd * d
                                   + 3 * d * f + 2 * d + 2 * hd)) * 2
    caches = 2 * (2 * b * cap * kv * hd * 2 + b * cap * 4)
    io = 2 * b * 4
    assert terms.hbm_bytes == params + caches + io + b * v * 2


def _attending_layers(cfg, mode):
    """Flash calls a step makes: one a layer that attends, one more a
    decoder layer's cross-attention, and the encoder's in a prefill."""
    n = sum(g.count * sum(k == M.ATTN for k in g.kinds) * (1 + g.cross)
            for g in M.block_groups(cfg))
    return n + (cfg.encoder_layers if cfg.is_enc_dec and mode == "prefill"
                else 0)


def _ring_pairs(sq, cap, *, window, q_offset):
    """The pairs ``cache_attention_ref``'s mask lets through on a decode
    step's cache: every position up to the last row's written at slot
    position % cap (a ring keeps the last ``cap``)."""
    last = q_offset + sq - 1
    pos = torch.full((cap,), -1, dtype=torch.int64)
    held = torch.arange(max(0, last + 1 - cap), last + 1)
    pos[held % cap] = held
    qp = torch.arange(q_offset, q_offset + sq)[:, None]
    ok = (pos >= 0) & (pos <= qp)
    if window > 0:
        ok = ok & ((qp - pos) < window)
    return int(ok.sum())


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_arch_is_counted_as_the_card_runs_it(arch, mode, monkeypatch):
    """Full depth at narrow widths: one attention kernel call a layer that
    attends — flash, or for a serve step's one-row self-attention on any
    dense cache flash_decode through ``ops.cache_attention`` (MLA's latent
    attention and cross-attention stay on flash) —, their products those
    of the pairs the plain versions' masks let through, and of the outputs
    only those that are not an argument updated in place counted as bytes
    (a serve step: the logits alone)."""
    cfg = _narrow(arch)
    monkeypatch.setattr(TS, "get_config", lambda a: cfg)
    calls, ring_calls = [], []
    real, real_ring = ops.flash_attention, ops.cache_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape, k.shape, v.shape, kw))
        return real(q, k, v, **kw)

    def spy_ring(q, k, v, pos, **kw):
        ring_calls.append((q.shape, k.shape, v.shape, kw))
        return real_ring(q, k, v, pos, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    monkeypatch.setattr(ops, "cache_attention", spy_ring)
    cell = dataclasses.replace(
        TC.get_cell("qwen3-4b", {"prefill": "prefill_32k",
                                 "decode": "decode_32k"}[mode]),
        batch=1, seq_len=32, n_micro=1)
    art = TS.make_artifacts(cell, META)
    flops, flash, out = RA.count_flops(art.fn, *art.abstract_args)
    assert flops > flash >= 0
    assert len(calls) + len(ring_calls) == _attending_layers(cfg, mode)
    # a serve step's one-row self-attention takes flash_decode on every
    # dense cache; MLA's latent attention and cross-attention stay on flash
    self_attn = sum(g.count * sum(k == M.ATTN for k in g.kinds)
                    for g in M.block_groups(cfg))
    assert len(ring_calls) == (self_attn if mode == "decode"
                               and cfg.mla is None else 0)
    assert all(q[1] == 1 for q, *_ in ring_calls)
    want = 0
    for (b, h, sq, dk), (_, _, skv, _), (*_, dv), kw in calls:
        kv_len = kw.get("kv_len") or skv
        want += 2 * b * h * (dk + dv) * _mask_pairs(
            sq, skv, causal=kw.get("causal", True),
            window=kw.get("window", 0), q_offset=kw.get("q_offset", 0),
            kv_len=kv_len)
    for (b, sq, h, dk), (_, cap, _, _), (*_, dv), kw in ring_calls:
        want += 2 * b * h * (dk + dv) * _ring_pairs(
            sq, cap, window=kw["window"], q_offset=kw["q_offset"])
    assert flash == want
    fresh = out[0] if mode == "decode" else out
    assert RA.fresh_bytes(out, art.abstract_args) == RA.tree_bytes(fresh)


def test_train_count_is_linear_in_depth(monkeypatch):
    cfg = _narrow("qwen3-4b")
    monkeypatch.setattr(TS, "get_config", lambda a: cfg)
    f1, f2, f5 = (_count("train", {"num_layers": n}, batch=2, seq=16).flops
                  for n in (1, 2, 5))
    assert f5 == pytest.approx(f1 + 4 * (f2 - f1), rel=1e-12)
