"""The launch layer's serving steps on a (1, 2) mesh of ranks — tensor
parallelism on the model axis — against the JAX package's step builders
on an Auto-typed 1x1 mesh (its own mesh gives Explicit axes, which its
sharding constraints reject: ROADMAP queue 3 C1), on the CPU, in float32,
for the tiny ``dense-bias-qknorm``, ``moe``, ``mla``, ``sliding`` (a ring
of 8 slots), ``hybrid`` (RG-LRU blocks beside rings), ``ssm`` (the SSD
replicated, its conv tail on the channels), ``vlm`` (4 patches before
the prompt) and ``encdec`` (2 encoder layers over 1,500 frames, cross
rows on head_dim) configs of ``tests/conftest.py`` and the tiny vlm at
an odd vocab of 127 (``pad_vocab`` adds a row on the mesh), at batch 2 x
24 tokens.

One world of two gloo ranks is started for the module
(``launch/ranks.py``); the ranks run ``tests/torch_mesh_ranks.py``,
which imports no JAX. Parameters come from the reference's
``init_params`` through ``params_from_numpy``, whole, and each rank keeps
its shards (``sharding.shard_params``). Held, per family:

  * the prefill's last logits, assembled from the ranks' vocab shards,
    within atol 1e-5 of the reference's;
  * each rank's prefill cache and state shard equal to the spec's slice
    of the reference's caches within 1e-5 (head_dim-sharded K/V, ``pos``
    whole; MLA's latent whole; the RG-LRU's ``h`` and ``conv`` on the
    width; the SSM's ``h`` whole and its conv tail on the channels; the
    cross rows on head_dim, ``mem_len`` whole);
  * the handoff of the reference's P caches (each rank given its
    shards): D's shards bit for bit the capacity slices of the
    reference's handoff (a ring's slot halves with their tags, MLA's
    latent halves, the RG-LRU and SSM states and the cross rows as they
    were), into float32 and bfloat16 caches and, for the dense family,
    float8 e4m3 ones;
  * the serve step over the reference's D caches: the assembled logits
    (a padded vocab's pad column 0) and every rank's cache shard within
    1e-5 (float32 D caches, and the dense family's e4m3 ones);
  * each rank's bytes of parameters and caches equal to
    ``per_chip_bytes`` at {"data": 1, "model": 2}.

Also: ``serve.programs_on_rank`` (the ``--mesh 1x2`` launcher's rank
program) on the tiny dense config against the one-card launcher's
tokens, its handoff check and its record; flash_decode's plain partial
and combine over two slot halves against the whole-cache plain version
(1e-6), V as wide as K and narrower (MLA's dv < dk); a float8 exchange
and gather between the ranks bit for bit; long_500k's serve step
(q_offset 524,288) of the tiny sliding, hybrid and ssm families against
the reference's; a data axis splitting the prefill's batch (training
every family on a rank's mesh: tests/test_torch_mesh_train.py and
tests/test_torch_mesh_train_families*.py); a rank that raises surfacing
in the parent with its traceback, and no rank left running.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_mesh_ranks as R
from repro.launch import cells as RC
from repro.launch import steps as RS
from repro.models import model as JM
from repro_torch.configs.base import config_from_dict
from repro_torch.kernels import ref as KR
from repro_torch.launch import ranks
from repro_torch.launch import serve
from repro_torch.launch import sharding as TSH
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import Mesh
from repro_torch.models.collectives import AxisShard
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

from conftest import TINY_FAMILIES
from test_torch_launch_steps import _inputs, _ref_leaves, _to_port

SEQ, BATCH = 24, 2
ATOL = 1e-5
_GET_CELL = RC.get_cell         # the fixtures patch the module's
ODD_VOCAB = "vlm-odd-vocab"     # the tiny vlm at a vocab the axis pads
FAMILIES = ("dense-bias-qknorm", "moe", "mla", "sliding", "hybrid", "ssm",
            "vlm", "encdec", ODD_VOCAB)
CONFIGS = {**TINY_FAMILIES, ODD_VOCAB: dataclasses.replace(
    TINY_FAMILIES["vlm"], name=ODD_VOCAB, vocab_size=127)}
LONG = ("sliding", "hybrid", "ssm")    # the tiny families of long_500k
LONG_Q = 524_288                        # long_500k's q_offset
DENSE = "dense-bias-qknorm"
F8 = "float8_e4m3fn"


@pytest.fixture(scope="module")
def world():
    w = ranks.start(2, device="cpu", timeout_s=300)
    yield w
    w.close()


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _rank_mesh(r: int) -> Mesh:
    """Rank r's (1, 2) mesh as the parent sees it: for cutting the
    reference's whole tensors to that rank's slices."""
    return Mesh((1, 2), ("data", "model"), torch.device("cpu"), (0, r),
                (None, AxisShard(r, 2, None, (0, 1))))


def _cells(**kw):
    return {s: dataclasses.replace(_GET_CELL("qwen3-4b", s), batch=BATCH,
                                   seq_len=SEQ, cache_dtype="float32", **kw)
            for s in ("prefill_32k", "decode_32k")}


def _close(got: torch.Tensor, want, atol=ATOL, exact=False, what=""):
    """``got`` within ``atol`` of ``want`` (a tensor or an array), or, with
    ``exact``, bit for bit once ``want`` is in ``got``'s dtype."""
    want = want if isinstance(want, torch.Tensor) else \
        tensor_from_numpy(np.asarray(want), torch.device("cpu"))
    if exact:
        np.testing.assert_array_equal(
            got.contiguous().view(torch.uint8).numpy(),
            want.to(got.dtype).contiguous().view(torch.uint8).numpy(),
            err_msg=what)
    else:
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=atol, rtol=0, err_msg=what)


def _held_to_slices(outs, key, ref_tree, specs, atol=ATOL, exact=False):
    """Every rank's tree ``outs[r][key]`` equals the rank's spec slices of
    the reference's whole tree."""
    ref = _ref_leaves(ref_tree)
    for r, out in enumerate(outs):
        mine = dict(TSH.named_leaves(out[key] if isinstance(key, str)
                                     else key(out)))
        assert sorted(mine) == sorted(ref)
        for p, x in mine.items():
            assert str(x.dtype) == f"torch.{ref[p].dtype.name}", p
            want = TSH.rank_slice(tensor_from_numpy(ref[p],
                                                    torch.device("cpu")),
                                  specs[p], _rank_mesh(r))
            _close(x, want, atol, exact, f"rank {r} {p}")


def _padded_params(params, tcfg):
    """The reference's whole parameters at the vocab the (1, 2) mesh
    deploys (``pad_vocab``): the embedding's pad rows and the head's pad
    columns zero, so that a pad logit is exactly 0."""
    v = TSH.pad_vocab(tcfg, 2).vocab_size
    out = dict(params)
    pad = v - params["embed"].shape[0]
    if pad:
        out["embed"] = torch.nn.functional.pad(params["embed"], (0, 0, 0, pad))
        if "lm_head" in params:
            out["lm_head"] = torch.nn.functional.pad(params["lm_head"],
                                                     (0, pad))
    return out


_REFS = {}


def _reference(name, jmesh):
    """The reference's prefill, handoffs and serve steps of the tiny
    family ``name`` on the Auto 1x1 mesh (once a family): its params, the
    inputs and results as numpy-backed arrays, and the port's P and D
    caches made from them."""
    if name in _REFS:
        return _REFS[name]
    jcfg = CONFIGS[name]
    cfg_dict = dataclasses.asdict(jcfg)
    cells = _cells()
    mp = pytest.MonkeyPatch()
    mp.setattr(RS, "get_config", lambda arch: jcfg)
    mp.setattr(RC, "get_cell", lambda arch, shape: cells[shape])
    try:
        jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(0),
                                                       jcfg)
        part = RS.make_prefill_artifacts(cells["prefill_32k"], jmesh)
        batch = _inputs(part.abstract_args[1], jcfg)
        jlast, jcaches_p = part.fn(jp, {k: jnp.asarray(v) for k, v in
                                        batch.items()})
        tcfg = config_from_dict(cfg_dict)
        mp.setattr(TS, "get_config", lambda arch: tcfg)
        mp.setattr(TS, "get_cell", lambda arch, shape: cells[shape])
        one = Mesh((1, 1), ("data", "model"), torch.device("cpu"))
        tho = TS.make_handoff_artifacts("qwen3-4b", one, batch=BATCH)
        caches_p = _to_port(jcaches_p, tho.abstract_args[0])
        d_dtypes = ("float32", "bfloat16") + ((F8,) if name == DENSE else ())
        serve_dtypes = ("float32",) + ((F8,) if name == DENSE else ())
        tok = np.asarray(jnp.argmax(jlast, -1), np.int32)[:, None]
        io = {"tokens": tok, "positions": np.full_like(tok, SEQ)}
        handoffs, jserve, caches_d = {}, {}, {}
        for dt in d_dtypes:
            cells_dt = _with_d_dtype(cells, dt)
            mp.setattr(RC, "get_cell", lambda arch, shape: cells_dt[shape])
            mp.setattr(TS, "get_cell", lambda arch, shape: cells_dt[shape])
            handoffs[dt] = RS.make_handoff_artifacts(
                "qwen3-4b", jmesh).fn(jax.tree.map(jnp.copy, jcaches_p))
            if dt not in serve_dtypes:
                continue
            jart = RS.make_serve_artifacts(cells_dt["decode_32k"], jmesh)
            tsrv = TS.make_serve_artifacts(cells_dt["decode_32k"], one)
            caches_d[dt] = _to_port(handoffs[dt], tsrv.abstract_args[1])
            # a copy: the reference's serve step donates its caches
            jserve[dt] = jart.fn(jp, jax.tree.map(jnp.copy, handoffs[dt]),
                                 {k: jnp.asarray(v) for k, v in io.items()})
    finally:
        mp.undo()
    params = _padded_params(params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"), tcfg)
    _REFS[name] = dict(
        name=name, jcfg=jcfg, cfg_dict=cfg_dict, tcfg=tcfg, cells=cells,
        jp=jp, params=params, batch=batch, jlast=jlast, jcaches_p=jcaches_p,
        caches_p=caches_p, d_dtypes=d_dtypes, io=io, handoffs=handoffs,
        jserve=jserve, caches_d=caches_d)
    return _REFS[name]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, world, jmesh):
    """The reference's prefill, handoff and serve step of a tiny family
    and the ranks' steps on the same inputs, run once a family."""
    ref = _reference(request.param, jmesh)
    io = {k: torch.tensor(v) for k, v in ref["io"].items()}
    outs = world.run(R.steps_on_rank, ref["cfg_dict"], ref["cells"],
                     ref["params"],
                     {k: torch.from_numpy(v) for k, v in ref["batch"].items()},
                     ref["caches_p"], ref["caches_d"], io, ref["d_dtypes"])
    return dict(ref, outs=outs)


def _with_d_dtype(cells, dt):
    return dict(cells, decode_32k=dataclasses.replace(cells["decode_32k"],
                                                      cache_dtype=dt))


def _specs(fam, kind, dt="float32"):
    """The port's specs on the (1, 2) mesh: params, P's caches, D's."""
    cells = _with_d_dtype(fam["cells"], dt)
    mp = pytest.MonkeyPatch()
    mp.setattr(TS, "get_config", lambda arch: fam["tcfg"])
    mp.setattr(TS, "get_cell", lambda arch, shape: cells[shape])
    try:
        abstract = Mesh((1, 2), ("data", "model"), torch.device("meta"))
        if kind == "handoff":
            return TS.make_handoff_artifacts("qwen3-4b", abstract,
                                             batch=BATCH).out_shardings
        pre = TS.make_prefill_artifacts(cells["prefill_32k"], abstract)
        if kind == "params":
            return pre.in_shardings[0]
        if kind == "caches_p":
            return pre.out_shardings[1]
        return TS.make_serve_artifacts(cells["decode_32k"],
                                       abstract).in_shardings[1]
    finally:
        mp.undo()


def test_backend_is_gloo_on_the_cpu(world, family):
    assert world.backend == "gloo"
    assert [o["backend"] for o in family["outs"]] == ["gloo", "gloo"]


def test_prefill_logits_from_vocab_shards(family):
    """The gathered logits keep the pad column of a padded vocab (the
    tiny odd-vocab vlm's 127 → 128), as the reference's do: 0 there, from
    the zero pad weights."""
    outs = family["outs"]
    shards = [o["prefill"][0] for o in outs]
    v = family["jcfg"].vocab_size
    v2 = TSH.pad_vocab(family["tcfg"], 2).vocab_size
    assert v2 == (v + 1 if family["name"] == ODD_VOCAB else v)
    assert [tuple(s.shape) for s in shards] == [(BATCH, v2 // 2)] * 2
    got = torch.cat(shards, -1)
    _close(got[:, :v], family["jlast"])
    assert (got[:, v:] == 0).all()


def test_prefill_cache_shards_are_the_specs_slices(family):
    _held_to_slices(family["outs"], lambda o: o["prefill"][1],
                    family["jcaches_p"], _specs(family, "caches_p"))


def test_handoff_shards_bit_equal_slices_of_the_reference(family):
    want_dtypes = {"float32", "bfloat16"} | (
        {F8} if family["name"] == DENSE else set())
    assert set(family["handoffs"]) == want_dtypes
    for dt, want in family["handoffs"].items():
        _held_to_slices(family["outs"],
                        lambda o, dt=dt: o["handoff"][dt], want,
                        _specs(family, "handoff", dt), exact=True)


def test_serve_step_logits_and_cache_shards(family):
    outs = family["outs"]
    assert set(family["jserve"]) == {"float32"} | (
        {F8} if family["name"] == DENSE else set())
    v = family["jcfg"].vocab_size
    for dt, (jlog, jcaches) in family["jserve"].items():
        got = torch.cat([o["serve"][dt][0] for o in outs], -1)
        _close(got[..., :v], jlog, what=dt)
        assert (got[..., v:] == 0).all()
        _held_to_slices(outs, lambda o, dt=dt: o["serve"][dt][1], jcaches,
                        _specs(family, "caches_d", dt))


def test_rank_bytes_equal_per_chip_bytes(family):
    for out in family["outs"]:
        for what, (have, predicted) in out["bytes"].items():
            assert have == predicted > 0, what


def test_rank_programs_match_the_one_card_launcher(world, monkeypatch):
    """``serve.programs_on_rank`` on the tiny dense config at (1, 2):
    the same tokens as the one-card launcher, the handoff check true on
    both ranks for every layer, bytes equal to ``per_chip_bytes``,
    collectives counted, one world's record."""
    jcfg = TINY_FAMILIES["dense-bias-qknorm"]
    cfg_dict = dataclasses.asdict(jcfg)
    cells = _cells()
    tcfg = config_from_dict(cfg_dict)
    for mod in (TS,):
        monkeypatch.setattr(mod, "get_config", lambda arch: tcfg)
        monkeypatch.setattr(mod, "get_cell", lambda arch, s: cells[s])
    from repro_torch.launch import cells as TC
    monkeypatch.setattr(TC, "get_cell", lambda arch, s: cells[s])
    one = serve.run_programs("qwen3-4b", batch=BATCH, steps=3, device="cpu")
    recs = world.run(R.programs_on_rank, cfg_dict, cells, "qwen3-4b",
                     "decode_32k", BATCH, 3, None, 0, (1, 2),
                     (0, jcfg.num_layers - 1), True)
    rec = serve.mesh_record(recs, world.backend)
    assert rec["tokens"] == one["tokens"]
    assert rec["handoff_held"] == {0: True, jcfg.num_layers - 1: True}
    assert rec["handoff_held_all_ranks"]
    assert rec["prefill_logits"].shape == (BATCH, jcfg.vocab_size)
    for r in rec["ranks"]:
        for what, (have, predicted) in r["bytes"].items():
            assert have == predicted > 0, what
        c = r["collectives"]
        assert c["psum"]["calls"] > 0 and c["all_gather"]["calls"] > 0
        assert c["exchange"]["calls"] > 0
    assert set(rec["seconds"]) == {"prefill", "handoff", "decode"}


@pytest.mark.parametrize("dv", [16, 8])
def test_partial_and_combine_over_two_halves_equal_the_whole(dv):
    """V as wide as K, and narrower (dv < dk, as MLA's expanded latent:
    192 / 128 on the card)."""
    gen = torch.Generator().manual_seed(0)
    b, cap, kvh, h, d = 2, 40, 2, 8, 16
    k = torch.randn((b, cap, kvh, d), generator=gen)
    v = torch.randn((b, cap, kvh, dv), generator=gen)
    pos = torch.full((b, cap), -1, dtype=torch.int32)
    pos[0, :33] = torch.arange(33)
    pos[1, :7] = torch.arange(7)              # the second half empty
    for sq, window in ((1, 0), (3, 0), (1, 6)):
        q = torch.randn((b, sq, h, d), generator=gen)
        qo = 33 - sq
        whole = KR.cache_attention_ref(q, k, v, pos, q_offset=qo,
                                       window=window)
        parts = [KR.cache_attention_partial_ref(
            q, k[:, s:s + cap // 2], v[:, s:s + cap // 2],
            pos[:, s:s + cap // 2], q_offset=qo, window=window)
            for s in (0, cap // 2)]
        got = KR.decode_combine_ref(torch.cat([a for a, _ in parts], 2),
                                    torch.cat([m for _, m in parts], 2),
                                    torch.float32)
        assert got.shape == (b, sq, h, dv)
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)


def test_float8_exchange_and_gather_are_bit_exact(world):
    """e4m3 tensors — every byte code, NaN and ±448 included — cross the
    ranks through ``exchange`` and ``all_gather`` (as their bytes) bit for
    bit: each rank gets every other rank's block and the gathered whole."""
    outs = world.run(R.float8_collectives_on_rank)
    for r, out in enumerate(outs):
        for j, got in enumerate(out["exchanged"]):
            want = R.float8_block(j, r)
            assert got.dtype == torch.float8_e4m3fn
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        want = torch.cat([R.float8_block(j, j) for j in range(2)], 1)
        assert torch.equal(out["gathered"].view(torch.uint8),
                           want.view(torch.uint8))


@pytest.fixture(scope="module", params=LONG)
def long_step(request, world, jmesh):
    """long_500k's serve step (q_offset 524,288) of a tiny family over the
    reference's float32 D caches of the decode_32k handoff with every tag
    shifted by 524,288 - SEQ (a multiple of the ring, so each entry keeps
    its slot; the SSM's states carry no position), by the reference and
    by the ranks on the same caches. The reference's step runs op by op
    (``jax.disable_jit``): fused under ``jit``, XLA's CPU sin and cos of
    angles near 524,288 rad err by ~2e-3, which the unfused ops do not
    (``test_rope_near_524288_against_float64``)."""
    ref = _reference(request.param, jmesh)
    cell = dataclasses.replace(_GET_CELL("mixtral-8x7b", "long_500k"),
                               batch=BATCH, cache_dtype="float32")
    shift = cell.seq_len - SEQ
    jcaches = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.where(x >= 0, x + shift, x)
        if jax.tree_util.keystr(p).rstrip("']").endswith("pos")
        else jnp.copy(x),
        ref["handoffs"]["float32"])
    io = {k: v + (shift if k == "positions" else 0)
          for k, v in ref["io"].items()}
    mp = pytest.MonkeyPatch()
    mp.setattr(RS, "get_config", lambda arch: ref["jcfg"])
    mp.setattr(TS, "get_config", lambda arch: ref["tcfg"])
    try:
        jart = RS.make_serve_artifacts(cell, jmesh)
        one = Mesh((1, 1), ("data", "model"), torch.device("cpu"))
        caches = _to_port(jcaches, TS.make_serve_artifacts(
            cell, one).abstract_args[1])
        with jax.disable_jit():
            want = jart.fn(ref["jp"], jax.tree.map(jnp.copy, jcaches),
                           {k: jnp.asarray(v) for k, v in io.items()})
    finally:
        mp.undo()
    outs = world.run(R.long_step_on_rank, ref["cfg_dict"], cell,
                     ref["params"], caches,
                     {k: torch.tensor(v) for k, v in io.items()})
    return dict(ref, cell=cell, shift=shift, caches=caches, want=want,
                outs=outs)


def test_long_500k_serve_step_on_the_rank_mesh(long_step):
    """The rings' slot halves (8 → 2 x 4), the hybrid's RG-LRU width
    halves beside them and the SSM's conv-tail channel halves at
    q_offset 524,288: the assembled logits and every rank's cache shard
    within 1e-5 of the reference's long_500k serve step."""
    outs, (jlog, jcaches) = long_step["outs"], long_step["want"]
    assert long_step["cell"].seq_len == LONG_Q
    assert LONG_Q % 8 == 0 and long_step["shift"] % 8 == 0
    pos = [x for p, x in TSH.named_leaves(long_step["caches"])
           if p.endswith(".pos")]
    assert (long_step["name"] == "ssm") == (not pos)
    for x in pos:                          # the window full, before q
        assert int(x.max()) == LONG_Q - 1 and x.shape[-1] == 8
    _close(torch.cat([o["logits"] for o in outs], -1), jlog)
    _held_to_slices(outs, "caches", jcaches, outs[0]["specs"])
    for o in outs:
        for what, (have, predicted) in o["bytes"].items():
            assert have == predicted > 0, what


@pytest.mark.parametrize("pos", [LONG_Q - 1, LONG_Q])
def test_rope_near_524288_against_float64(pos):
    """The port's RoPE at long_500k's positions within 1e-6 of float64
    rotations of the same float32 angles; the reference's, run op by op,
    gives the same bits (under ``jit`` its fused sin/cos do not)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    x = np.random.default_rng(0).standard_normal((1, 1, 2, 16)) \
        .astype(np.float32)
    p = np.array([[pos]], np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(p),
                        10_000.0).numpy()
    ang = (np.float32(pos) * TL.rope_frequencies(16, 10_000.0, "cpu")
           .numpy()).astype(np.float64)
    x1, x2 = x[..., :8].astype(np.float64), x[..., 8:].astype(np.float64)
    truth = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                            x1 * np.sin(ang) + x2 * np.cos(ang)], -1)
    np.testing.assert_allclose(got, truth, atol=1e-6, rtol=0)
    with jax.disable_jit():
        ref = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(p),
                                       10_000.0))
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("name", ["ssm", "vlm", "encdec"])
@pytest.mark.parametrize("what", ["data axis"])
def test_training_and_a_data_axis_still_raise_on_the_rank_mesh(
        name, what, monkeypatch):
    """A data axis above 1 does not raise: the prefill's inputs and logits
    are split on it. (Training these families on a world of ranks no
    longer raises either: tests/test_torch_mesh_train_families*.py hold
    it.)"""
    tcfg = config_from_dict(dataclasses.asdict(TINY_FAMILIES[name]))
    cells = _cells()
    monkeypatch.setattr(TS, "get_config", lambda arch: tcfg)
    mesh = Mesh((2, 1), ("data", "model"), torch.device("cpu"),
                (1, 0), (AxisShard(1, 2, None, (0, 1)), None))
    pre = TS.make_prefill_artifacts(cells["prefill_32k"], mesh)
    assert all(s[0] == "data" for s in pre.in_shardings[1].values())
    assert pre.out_shardings[0] == ("data", "model")


def test_a_rank_that_raises_surfaces_and_no_rank_is_left():
    w = ranks.start(2, device="cpu", timeout_s=120)
    pids = w.pids
    with pytest.raises(ranks.RankError, match="rank one fails on purpose"):
        w.run(R.raise_on_rank_one)
    for pid in pids:                       # killed and reaped
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    with pytest.raises(ranks.RankError, match="closed"):
        w.run(R.raise_on_rank_one)


def test_a_world_and_the_mesh_launcher_need_the_card_unless_asked():
    """Without a card, ``ranks.start`` and ``serve --mesh 1x2`` raise
    rather than run on the CPU, which is asked for by name
    (``device="cpu"``, as the tests above)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ranks.start(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-4b", "--mesh", "1x2", "--layers", "1"])
    assert ranks.choose_backend(2, "cpu") == "gloo"
