"""The port's launch layer against the JAX package's, on the CPU: the cell
grid, the deploy transforms, every sharding rule, every cell's abstract
arguments, the handoff's float8 cast, the dry run and the launchers.

  * ``make_cells()`` equals the reference's field for field.
  * ``pad_heads``, ``pad_vocab`` and ``deploy_config`` equal the
    reference's for every ``ASSIGNED`` arch x mode x axis in {1, 16}.
  * ``param_pspecs``, ``opt_pspecs``, ``cache_pspecs`` and
    ``batch_pspecs`` equal the reference's PartitionSpecs (as tuples),
    leaf for leaf in the same order (an enc-dec cache's leaves matched by
    name: the reference nests them as {"self", "cross_k", ...}), for every
    ``ASSIGNED`` arch x mode on the (16, 16) and (2, 16, 16) meshes. The
    reference's trees come from ``jax.eval_shape``, the port's from
    ``meta``.
  * Every non-skipped cell's abstract arguments at full size: the same
    shapes and dtypes as the reference's ``ShapeDtypeStruct``s.
  * The handoff's float8 cast equals ``jnp.astype(float8_e4m3fn)`` bit for
    bit over ties, subnormals and everything within ±448; past it the
    difference is recorded (torch saturates to ±448, the reference gives
    NaN from 464 on).
  * ``dryrun.run_cell`` gives the stated keys on three cells, and counts
    the five decode cells on rings or float8 caches as the card runs them
    (``ops.cache_attention``: at long_500k the window's slots a row);
    ``dryrun.run_handoffs`` gives the reference's keys, P's bytes and D's
    (the reference's own handoff dry run, in a process of its own);
    qwen3-4b@decode_32k's per-chip argument bytes equal a hand count; the
    launchers' ``main`` runs with ``--help``; the serve and train
    launchers run a tiny config on the CPU; a program on more than one
    device raises, naming the ROADMAP item.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, PartitionSpec as P

from repro.configs import ASSIGNED
from repro.configs.base import get_config as jget_config
from repro.launch import cells as RC
from repro.launch import sharding as RSH
from repro.launch import steps as RS
from repro.models import model as JM
from repro.training import train_step as JT
from repro_torch.configs.base import config_from_dict, get_config
from repro_torch.kernels import ops
from repro_torch.launch import cells as TC
from repro_torch.launch import dryrun, serve, train
from repro_torch.launch import sharding as TSH
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     shape_only)
from repro_torch.models import model as TM
from repro_torch.training import train_step as TT

MODES = ["train", "prefill", "decode"]
MESHES = {"single": (("data",), 16), "multi": (("pod", "data"), 32)}


def _spec_tuples(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(k), tuple(s)) for k, s in flat]


def _norm(path):
    """An enc-dec cache leaf's reference path in the port's spelling:
    {"self": KVCache, "cross_k": ...} is one CrossKVCache there."""
    for name in ("cross_k", "cross_v", "mem_len"):
        path = path.replace(f"['{name}']", f".{name}")
    return path.replace("['self']", "")


def _compare(got: dict, want: list, by_name: bool = False):
    want = [(_norm(p), s) for p, s in want]
    if by_name:
        assert got == dict(want)
    else:
        assert list(got.items()) == want


# --------------------------------------------------------------------- #
# cells and deploy configs
# --------------------------------------------------------------------- #
def test_cells_equal_reference_field_for_field():
    got = [dataclasses.asdict(c) for c in TC.make_cells()]
    want = [dataclasses.asdict(c) for c in RC.make_cells()]
    assert got == want and len(got) == 40
    assert sum(c["skip"] is not None for c in got) == 7
    assert TC.get_cell("qwen1.5-32b", "decode_32k").cache_dtype == \
        "float8_e4m3fn"
    assert TC.get_cell("qwen3-4b", "decode_32k").decode_capacity() == \
        RC.get_cell("qwen3-4b", "decode_32k").decode_capacity() == 32896


@pytest.mark.parametrize("axis", [1, 16])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_deploy_transforms_equal_reference(arch, axis):
    tcfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(TSH.pad_vocab(tcfg, axis)) == \
        dataclasses.asdict(RSH.pad_vocab(jcfg, axis))
    assert dataclasses.asdict(TSH.pad_heads(tcfg, axis)) == \
        dataclasses.asdict(RSH.pad_heads(jcfg, axis))
    for mode in MODES:
        assert dataclasses.asdict(TSH.deploy_config(tcfg, axis, mode)) == \
            dataclasses.asdict(RSH.deploy_config(jcfg, axis, mode))


# --------------------------------------------------------------------- #
# sharding rules
# --------------------------------------------------------------------- #
_REF_CACHE = {}


def _ref_abstract(arch, mode):
    """The reference's abstract train state, caches and inputs of an arch
    deployed at axis 16 (memoised: eval_shape at full size)."""
    key = (arch, mode)
    if key not in _REF_CACHE:
        cfg = RSH.deploy_config(jget_config(arch), 16, mode)
        shape = {"train": "train_4k", "prefill": "prefill_32k",
                 "decode": "decode_32k"}[mode]
        cell = RC.get_cell(arch, shape)
        out = {"cfg": cfg, "cell": cell,
               "state": JT.abstract_train_state(cfg),
               "inputs": RS._input_structs(cfg, cell)}
        if mode != "train":
            cap = cell.seq_len if mode == "prefill" else \
                cell.decode_capacity()
            mem = cfg.max_source_len if cfg.is_enc_dec else 0
            out["caches"] = JM.abstract_caches(
                cfg, cell.batch, cap, jnp.dtype(cell.cache_dtype), mem)
        _REF_CACHE[key] = out
    return _REF_CACHE[key]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_spec_rules_equal_reference(arch, mode, mesh):
    dp, dp_size = MESHES[mesh]
    ref = _ref_abstract(arch, mode)
    jcfg, cell = ref["cfg"], ref["cell"]
    tcfg = TSH.deploy_config(get_config(arch), 16, mode)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tstate = TT.abstract_train_state(tcfg)

    jp = RSH.param_pspecs(ref["state"].params, jcfg, "model", 16)
    tp = TSH.param_pspecs(tstate.params, tcfg, "model", 16)
    _compare(tp, _spec_tuples(jp))
    if mode == "train":
        _compare(TSH.opt_pspecs(tstate.opt, tp, dp, dp_size),
                 _spec_tuples(RSH.opt_pspecs(ref["state"].opt, jp, dp,
                                             dp_size)))
        z3 = jax.tree.map(lambda sd, sp: RSH.zero1_pspec(sp, sd.shape, dp,
                                                         dp_size),
                          ref["state"].params, jp,
                          is_leaf=lambda x: isinstance(x, P))
        _compare(TSH.zero1_pspecs(tstate.params, tp, dp, dp_size),
                 _spec_tuples(z3))
    else:
        cap = cell.seq_len if mode == "prefill" else cell.decode_capacity()
        mem = tcfg.max_source_len if tcfg.is_enc_dec else 0
        tcache = TM.abstract_caches(tcfg, cell.batch, cap,
                                    getattr(torch, cell.cache_dtype),
                                    mem_len=mem)
        jspec = RSH.cache_pspecs(ref["caches"], jcfg, cell.batch, dp,
                                 dp_size, "model", 16, mode=mode)
        _compare(TSH.cache_pspecs(tcache, tcfg, cell.batch, dp, dp_size,
                                  "model", 16, mode=mode),
                 _spec_tuples(jspec), by_name=tcfg.is_enc_dec)
    tin = TS._input_structs(tcfg, TC.get_cell(arch, cell.shape))
    _compare(TSH.batch_pspecs(tin, dp, dp_size),
             _spec_tuples(RSH.batch_pspecs(ref["inputs"], dp, dp_size)))


def test_zero1_and_batch_specs_on_the_reference_cases():
    """tests/test_sharding.py's own cases, as tuples."""
    sp = TSH.zero1_pspec((None, "model"), (1024, 512), ("data",), 16)
    assert sp == ("data", "model")
    assert TSH.zero1_pspec(sp, (1024, 512), ("data",), 16) == sp
    assert TSH.zero1_pspec((None,), (7,), ("data",), 16) == (None,)
    abs_b = {"tokens": torch.empty((7, 128), dtype=torch.int32,
                                   device="meta"),
             "labels": torch.empty((32, 128), dtype=torch.int32,
                                   device="meta")}
    specs = TSH.batch_pspecs(abs_b, ("data",), 16)
    assert specs["['tokens']"] == (None, None)
    assert specs["['labels']"] == ("data", None)


# --------------------------------------------------------------------- #
# abstract arguments of every cell
# --------------------------------------------------------------------- #
def _shapes(tree, torch_side):
    if torch_side:
        return {_norm(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for p, x in TSH.named_leaves(tree)}
    return {_norm(jax.tree_util.keystr(k)): (tuple(x.shape), str(x.dtype))
            for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_every_cell_has_the_reference_abstract_arguments():
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    tmesh = make_mesh((1, 1), ("data", "model"), device="meta")
    n = 0
    for tcell, jcell in zip(TC.make_cells(), RC.make_cells()):
        if tcell.skip:
            continue
        want = RS.make_artifacts(jcell, jmesh).abstract_args
        got = TS.make_artifacts(tcell, tmesh).abstract_args
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _shapes(g, True) == _shapes(w, False), tcell.name
            assert all(x.device.type == "meta"
                       for _, x in TSH.named_leaves(g))
        n += 1
    assert n == 33


# --------------------------------------------------------------------- #
# the handoff's cast, meshes, placement
# --------------------------------------------------------------------- #
def _fp8_inputs():
    e4m3 = jnp.float8_e4m3fn
    # every e4m3 value, the midpoints between neighbours (ties), values
    # just off them, subnormals and zero of both signs, in float32
    grid = np.asarray(jnp.arange(256, dtype=jnp.uint8).view(e4m3)
                      .astype(jnp.float32))
    grid = np.sort(grid[np.isfinite(grid)])
    mids = (grid[1:] + grid[:-1]) / 2
    near = np.concatenate([mids * (1 + 1e-6), mids * (1 - 1e-6)])
    small = np.array([2.0 ** -10, 2.0 ** -9, 3 * 2.0 ** -11, 2.0 ** -12,
                      -2.0 ** -10, 0.0, -0.0], np.float32)
    return np.concatenate([grid, mids, near, small]).astype(np.float32)


def test_fp8_cast_matches_reference_within_range():
    x = _fp8_inputs()
    assert np.abs(x).max() <= 448
    for src in (np.float32, "bfloat16"):
        t = torch.from_numpy(x)
        j = jnp.asarray(x)
        if src == "bfloat16":                  # P's caches are bf16
            t, j = t.bfloat16(), j.astype(jnp.bfloat16)
        got = t.to(torch.float8_e4m3fn).view(torch.uint8).numpy()
        want = np.asarray(j.astype(jnp.float8_e4m3fn).view(jnp.uint8))
        np.testing.assert_array_equal(got, want)


def test_fp8_cast_past_the_range():
    """Past ±448 (e4m3's largest finite) the packages differ, recorded
    here: up to 464 (the rounding boundary) both give ±448; from there
    the reference gives NaN (e4m3fn has no infinity) and torch saturates
    to ±448. Real K/V lies well within range."""
    x = np.array([448.0, 460.0, 463.9, 464.0, 480.0, 1e4, -500.0, 1e30],
                 np.float32)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).float().numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got, np.sign(x) * 448)
    np.testing.assert_array_equal(want[:4], got[:4])
    assert np.isnan(want[4:]).all()


def test_meshes_and_placement():
    prod = make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.device is None
    multi = make_production_mesh(multi_pod=True)
    assert multi.size == 512 and multi.axis_names == ("pod", "data", "model")
    one = make_mesh((1, 1), ("data", "model"), device="cpu")
    t = {"a": torch.ones(2)}
    assert TSH.to_shardings(one, t)["a"] is t["a"]
    assert TSH.to_shardings(shape_only(one), t)["a"].device.type == "meta"
    with pytest.raises(ValueError, match="abstract mesh"):
        TSH.to_shardings(prod, t)
    with pytest.raises(NotImplementedError, match="in a world of as many "
                       "ranks"):
        TSH.to_shardings(make_mesh((2, 1), ("data", "model"), "cpu"), t)


def test_a_program_over_more_than_one_device_raises():
    """Outside a world of ranks a mesh of more than one device runs only
    on ``meta``: a data axis and a model axis alike."""
    cell = dataclasses.replace(TC.get_cell("qwen3-4b", "decode_32k"),
                               batch=2)
    for shape in ((1, 2), (2, 1)):
        art = TS.make_serve_artifacts(
            cell, make_mesh(shape, ("data", "model"), device="cpu"),
            layer_override={"num_layers": 1})
        with pytest.raises(NotImplementedError, match="in a world of as "
                           "many ranks"):
            art.fn(*art.abstract_args)


# --------------------------------------------------------------------- #
# the dry run and the launchers
# --------------------------------------------------------------------- #
KEYS = {"arch", "shape", "mode", "mesh", "seq_len", "batch", "n_micro",
        "cache_dtype", "ok", "seconds", "memory_analysis", "roofline"}
ROOF_KEYS = {"flops_per_chip", "hbm_bytes_per_chip", "wire_bytes_per_chip",
             "seconds", "dominant", "model_flops_global", "useful_ratio",
             "hw"}


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen3-4b", "decode_32k", "single"),
    ("mamba2-370m", "long_500k", "multi"),
    ("qwen1.5-32b", "prefill_32k", "single"),
])
def test_dryrun_records(arch, shape, mesh):
    rec = dryrun.run_cell(TC.get_cell(arch, shape), mesh, verbose=False)
    assert set(rec) == KEYS and rec["ok"] is True
    assert set(rec["roofline"]) == ROOF_KEYS
    ma = rec["memory_analysis"]
    assert set(ma) == {"argument_size_in_bytes", "output_size_in_bytes",
                       "alias_size_in_bytes"}
    assert 0 <= ma["alias_size_in_bytes"] <= ma["output_size_in_bytes"]
    assert rec["roofline"]["hbm_bytes_per_chip"] == \
        ma["argument_size_in_bytes"] + ma["output_size_in_bytes"] \
        - ma["alias_size_in_bytes"]
    r = rec["roofline"]
    assert r["flops_per_chip"] > 0 and r["wire_bytes_per_chip"] == 0
    assert r["hw"] == "h100-sxm (nominal)"
    assert r["seconds"]["compute"] == pytest.approx(
        r["flops_per_chip"] / 989.4e12)
    skip = dryrun.run_cell(TC.get_cell("qwen3-4b", "long_500k"), "single",
                           verbose=False)
    assert skip["ok"] is None and "skip" in skip


@pytest.mark.parametrize("arch,shape", [
    ("qwen1.5-32b", "decode_32k"), ("mixtral-8x7b", "decode_32k"),
    ("mixtral-8x7b", "long_500k"), ("recurrentgemma-9b", "decode_32k"),
    ("recurrentgemma-9b", "long_500k")])
def test_dryrun_counts_the_cells_that_had_no_card_route(arch, shape,
                                                        monkeypatch):
    """The five decode cells whose D caches are rings (a window) or float8
    are counted as the card runs them: an ok record with a positive FLOP
    count, every attending layer through ``ops.cache_attention``; at
    long_500k each row sees exactly the window's slots."""
    calls = []
    real = ops.cache_attention

    def spy(q, k, v, pos, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), k.dtype, kw))
        return real(q, k, v, pos, **kw)

    monkeypatch.setattr(ops, "cache_attention", spy)
    cell = TC.get_cell(arch, shape)
    rec = dryrun.run_cell(cell, "single", verbose=False)
    assert rec["ok"] is True and rec["roofline"]["flops_per_chip"] > 0
    cfg = get_config(arch)
    attending = sum(g.count * sum(k == TM.ATTN for k in g.kinds)
                    for g in TM.block_groups(cfg))
    assert len(calls) == attending
    window = cfg.sliding_window if cfg.attention_kind == "sliding" else 0
    for (b, sq, _, _), (_, cap, _, _), dtype, kw in calls:
        assert sq == 1 and kw["q_offset"] == cell.seq_len
        assert kw["window"] == window
        assert dtype == (torch.float8_e4m3fn if arch == "qwen1.5-32b"
                         else torch.bfloat16)
        if shape == "long_500k":
            assert cap == window
            assert ops.cache_visible_slots(1, cap, window=window,
                                           q_offset=cell.seq_len) == window


# The reference's handoff dry run in a process of its own: its dryrun
# module sets XLA_FLAGS (512 host devices) before JAX starts, which this
# process's JAX has done already. D's bytes from jax.eval_shape.
_REF_HANDOFFS = """
import json, sys
from repro.launch import dryrun as D
import jax
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import make_handoff_artifacts
D.run_handoffs(None, sys.argv[1])
recs = [json.loads(line) for line in open(sys.argv[1])]
for r in recs:
    art = make_handoff_artifacts(r["arch"], make_production_mesh())
    out = jax.eval_shape(art.fn, *art.abstract_args)
    r["d_bytes_global"] = sum(x.size * x.dtype.itemsize
                              for x in jax.tree.leaves(out))
json.dump(recs, open(sys.argv[1], "w"))
"""


def test_dryrun_handoff_records_match_reference(tmp_path):
    """``dryrun.run_handoffs``: one ok record an arch with the reference's
    keys; P's bytes (the prefill cell's 32 sequences) and D's (capacity
    pad, rings, the float8 cast) equal the reference's, which runs its own
    ``run_handoffs`` on its production mesh. The port has no collective
    program: wire 0, no breakdown (ROADMAP B12)."""
    import os
    import subprocess
    import sys
    out = tmp_path / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(sys.path))
    subprocess.run([sys.executable, "-c", _REF_HANDOFFS, str(out)],
                   check=True, env=env, capture_output=True, timeout=600)
    want = {r["arch"]: r for r in json.loads(out.read_text())}
    got = {r["arch"]: r for r in dryrun.run_handoffs(None, verbose=False)}
    assert sorted(got) == sorted(want) == sorted(ASSIGNED)
    for arch, w in want.items():
        g = got[arch]
        assert w["ok"] and g["ok"], (arch, g)
        assert set(w) <= set(g), arch
        assert g["kv_bytes_global"] == w["kv_bytes_global"], arch
        assert g["d_bytes_global"] == w["d_bytes_global"], arch
        assert g["wire_bytes_per_chip"] == 0.0 and g["by_kind"] == {}
        ma = g["memory_analysis"]
        assert 0 < ma["output_size_in_bytes"] <= g["d_bytes_global"]
    assert got["qwen1.5-32b"]["d_bytes_global"] < \
        got["qwen1.5-32b"]["kv_bytes_global"] / 2   # float8, no pad heads


def test_decode_argument_bytes_per_chip_by_hand():
    """qwen3-4b@decode_32k on (16, 16): every weight matrix split 16 ways
    on the model axis (vocab 151,936 and d_ff 9,728 divide), the norms
    whole; K/V and pos split 256 ways (batch 128 on data, capacity 32,896
    on model); tokens and positions 16 ways on data."""
    cfg = get_config("qwen3-4b")
    L, d, h, kv, hd, f, v = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                             cfg.num_kv_heads, cfg.hd, cfg.d_ff,
                             cfg.vocab_size)
    bf16 = 2
    sharded = (2 * v * d + L * (d * h * hd * 2 + d * kv * hd * 2
                                + 3 * d * f)) * bf16 // 16
    whole = (d + L * (2 * d + 2 * hd)) * bf16       # norms, q/k-norms
    b, cap = 128, 32896
    caches = L * (2 * b * cap * kv * hd * bf16 + b * cap * 4) // 256
    io = 2 * b * 4 // 16
    rec = dryrun.run_cell(TC.get_cell("qwen3-4b", "decode_32k"), "single",
                          verbose=False)
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == sharded + whole + caches + io
    # the caches come back updated in place; the logits are new
    logits = b * v * bf16 // 256           # batch on data, vocab on model
    assert ma["alias_size_in_bytes"] == caches
    assert ma["output_size_in_bytes"] == caches + logits


@pytest.mark.parametrize("mod", [serve, train, dryrun])
def test_launcher_help(mod, capsys):
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    assert "--arch" in capsys.readouterr().out


TINY = dict(name="tiny-qwen", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=128, qk_norm=True, param_dtype="float32",
            compute_dtype="float32")


def _tiny_cells(monkeypatch, seq=16):
    cfg = config_from_dict(dict(TINY))
    monkeypatch.setattr(TS, "get_config", lambda arch: cfg)
    real = TC.get_cell

    def cell(arch, shape):
        return dataclasses.replace(real("qwen3-4b", shape), seq_len=seq)

    for mod in (TS, TC):
        monkeypatch.setattr(mod, "get_cell", cell)
    return cfg


def test_serve_and_train_launchers_on_the_cpu(monkeypatch):
    from repro_torch.roofline import analysis as RA
    _tiny_cells(monkeypatch)
    rec = serve.run_programs("qwen3-4b", batch=2, steps=3, device="cpu")
    assert rec["device"] == "cpu" and len(rec["tokens"][0]) == 4
    assert set(rec["seconds"]) == {"prefill", "handoff", "decode"}
    out = train.run_steps("qwen3-4b", batch=2, n_micro=2, steps=2,
                          device="cpu")
    assert len(out["steps"]) == 2
    for s in out["steps"]:
        assert s["grad_norm"] > 0
        assert s["mfu"] == pytest.approx(
            RA.model_flops("qwen3-4b", "train", 2 * 16) / s["s"] / 989.4e12)
    # --multi-pod: a pod axis of 2 in front of --mesh, for both launchers
    seen = []
    monkeypatch.setattr(serve, "run_programs",
                        lambda *a, **kw: seen.append(kw["mesh"]) or {})
    monkeypatch.setattr(train, "run_steps",
                        lambda *a: seen.append(a[-1]) or {})
    serve.main(["--multi-pod", "--mesh", "1x2", "--device", "cpu"])
    train.main(["--multi-pod", "--mesh", "2x1", "--device", "cpu"])
    serve.main(["--mesh", "2x1", "--device", "cpu"])
    assert seen == [(2, 1, 2), (2, 2, 1), (2, 1)]
    with pytest.raises(ValueError, match="data x model"):
        serve.parse_mesh("2", False)
