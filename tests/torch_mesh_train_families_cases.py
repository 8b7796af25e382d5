"""What the tests of training every family other than the dense ones on
a mesh of ranks share (``tests/test_torch_mesh_train_families*.py``):
the tiny configs and their depths, the batches, the reference's oracles
— ``value_and_grad`` of its loss on an Auto-typed 1x1 mesh (ROADMAP
queue 3 C1), the per-shard oracle of the MoE, its ``make_train_artifacts``
steps —, the worlds of gloo ranks (``launch/ranks.py``; the ranks run
``tests/torch_mesh_train_ranks.py``, which imports no JAX) and each
test's body, a ``check_*`` function that the test files parametrize over
their families (four files, so that each stays within its time on one
xdist worker).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_mesh_train_ranks as R
from repro.launch import cells as RC
from repro.launch import steps as RS
from repro.models import dist as JD
from repro.models import model as JM
from repro.training import train_step as JT
from repro.training.optim import adamw_init as j_adamw_init
from repro_torch.configs.base import config_from_dict
from repro_torch.launch import cells as TC
from repro_torch.launch import ranks
from repro_torch.launch import sharding as TSH
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.training import train_step as TT
from repro_torch.training.optim import adamw_init

from conftest import TINY_FAMILIES
from test_torch_families import DEEPSEEK_TINY
from test_torch_launch_steps import _ref_leaves
from test_torch_mesh_train import OPT, _rank_mesh

ATOL = 1e-5
B, S = 4, 16
MEM = 8                                  # the tiny enc-dec's frames
MESHES = [(2, 1), (1, 2), (2, 2), (2, 1, 2)]
DATA_MESHES = [(2, 1), (2, 2), (2, 1, 2)]
NAMES = ["moe", "mla", "sliding", "hybrid", "ssm", "vlm", "encdec",
         "deepseek"]
# the families of each pair of test files: MoE, RG-LRU and enc-dec; the
# rest
GROUPS = (("moe", "deepseek", "hybrid", "encdec"),
          ("mla", "sliding", "ssm", "vlm"))
BASE = dict(TINY_FAMILIES, deepseek=DEEPSEEK_TINY)
# (layer axes the data plane of 2 leaves whole, layer axes it splits);
# one depth that holds both kinds of group where there is one
DEPTHS = {
    "moe": ({"num_layers": 3},),                       # groups of 1 and 2
    "deepseek": ({"num_layers": 3},),
    "encdec": ({"num_layers": 3, "encoder_layers": 2},),
    "hybrid": ({"num_layers": 5}, {"num_layers": 6}),  # (RRA)+(RR) / (RRA)x2
}
# (ZeRO-3, depth) of each family's gradient cases
VARIANTS = [(name, zero3, split) for name in NAMES
            for zero3, split in ((False, 0), (True, 0), (True, 1))
            if not (split and len(DEPTHS.get(name, (0, 0))) == 1)]
MOE = ("moe", "deepseek")
# the capacity factor under which no pair drops: every expert's window
# holds every routed pair (``moe_capacity``: T*k)
NO_DROP = {"moe_capacity_factor": 4.0}
SKEW_IDS = 4             # the per-shard test's tokens: ids 0-3 alone
# each adjoint's control: (mesh, skipped sums, leaves it is judged on)
CONTROLS = [
    ("moe", (1, 2), "moe.router", "['router']"),
    ("deepseek", (1, 2), "moe.router", "['router']"),
    ("deepseek", (1, 2), "mla.latent", "['w_dkv']"),
    ("mla", (1, 2), "mla.latent", "['kv_norm']"),
    ("hybrid", (1, 2), "rglru.xb", "['w_x']"),
    ("ssm", (2, 1), "data_grads:ssd", "['ssd']"),
    ("vlm", (2, 1), "data_grads", "['embed']"),
    ("encdec", (1, 2), "cross.kv", "['cross']['wk']"),
    ("sliding", (2, 2), "column_entry", "['wq']"),
]
_INIT = jax.jit(JM.init_params, static_argnums=1)
_GET_CELL = RC.get_cell
_CACHE = {}


@pytest.fixture(scope="module")
def worlds():
    w2 = ranks.start(2, device="cpu", timeout_s=300)
    w4 = ranks.start(4, device="cpu", timeout_s=300)
    yield {2: w2, 4: w4}
    w2.close()
    w4.close()


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _cfg(name, split):
    cfg = BASE[name]
    if cfg.is_enc_dec:
        cfg = dataclasses.replace(cfg, max_source_len=MEM)
    depths = DEPTHS.get(name, ({"num_layers": 3}, {"num_layers": 4}))
    return dataclasses.replace(cfg, **depths[min(split, len(depths) - 1)])


def _ctx(name, factor=NO_DROP):
    return factor if name in MOE else None


def _cells(n_micro=1, zero3=False):
    kw = dict(batch=B, seq_len=S, n_micro=n_micro, zero3=zero3)
    return (dataclasses.replace(_GET_CELL("qwen3-4b", "train_4k"), **kw),
            dataclasses.replace(TC.get_cell("qwen3-4b", "train_4k"), **kw))


def _batch(cfg, seed=1, ids=None):
    """Tokens and labels (B, S less a vision model's patches), patches or
    frames; label -1 on the last positions of rows 1 and 3 (unequal
    counts, so that the data shards' counts differ). ``ids``: the tokens
    drawn from the first ``ids`` ids alone (repetitive text, whose
    routing crowds a few experts)."""
    rng = np.random.default_rng(seed)
    toks = S - (cfg.frontend.num_patches
                if cfg.frontend.kind == "vision" else 0)
    v = cfg.vocab_size
    out = {"tokens": rng.integers(0, ids or v, (B, toks)).astype(np.int32),
           "labels": rng.integers(0, v, (B, toks)).astype(np.int32)}
    out["labels"][1, 5:] = -1
    out["labels"][3, toks - 4:] = -1
    if cfg.frontend.kind == "vision":
        out["patches"] = rng.standard_normal(
            (B, cfg.frontend.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal(
            (B, MEM, cfg.d_model)).astype(np.float32)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jctx(jmesh, **kw):
    return JD.DistContext(mesh=jmesh, dp_axes=("data",), model_axis="model",
                          chunk_kv=8192, moe_shard_map=True, **kw)


def _start(name, split):
    """The tiny ``name`` at the depth ``split`` picks: the reference's
    config and params, and the port's whole train state from them."""
    key = ("start", name, min(split, len(DEPTHS.get(name, (0, 0))) - 1))
    if key not in _CACHE:
        jcfg = _cfg(name, split)
        jp = _INIT(jax.random.key(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _CACHE[key] = dict(
            jcfg=jcfg, cfg_dict=dataclasses.asdict(jcfg), jp=jp,
            state=TT.TrainState(params=tp, opt=adamw_init(tp)))
    return _CACHE[key]


def _ref(name, split, jmesh=None, shards=False, ids=None):
    """``_start``'s model with the reference's loss and gradients over
    ``_batch(cfg, ids=ids)`` — over the whole batch (no drop: the MoE's
    exact route), or with ``shards`` the per-shard oracle of the MoE at
    the default capacity factor."""
    key = (name, split, shards, ids)
    if key in _CACHE:
        return _CACHE[key]
    start = _start(name, split)
    jcfg, jp = start["jcfg"], start["jp"]
    batch = _batch(jcfg, ids=ids)
    if shards:
        rows = (slice(0, B // 2), slice(B // 2, B))
        counts = [int((batch["labels"][r] >= 0).sum()) for r in rows]

        def loss(p):
            with JD.use(_jctx(jmesh)):
                num = sum(JM.loss_fn(p, jcfg, _jb({k: v[r] for k, v in
                                                   batch.items()}),
                                     remat=True) * c
                          for r, c in zip(rows, counts))
            return num / sum(counts)
    else:
        def loss(p):
            return JM.loss_fn(p, jcfg, _jb(batch), remat=True)
    value, grads = jax.jit(jax.value_and_grad(loss))(jp)
    _CACHE[key] = dict(start, batch=batch, loss=float(value),
                       grads=_ref_leaves(grads))
    return _CACHE[key]


def _gaps(outs, shape, ref, key="grads", want=None, only=""):
    """The worst gap of each rank's leaves (whose path holds ``only``)
    from the rank's slices of ``want`` (the reference's gradients)."""
    want = ref["grads"] if want is None else want
    worst = 0.0
    for r, o in enumerate(outs):
        got = o[key]
        assert sorted(got) == sorted((".params" + p if key == "grads"
                                      else p) for p in want)
        for p, x in got.items():
            if only not in p:
                continue
            w = want[p[len(".params"):]] if key == "grads" else want[p]
            cut = TSH.rank_slice(tensor_from_numpy(np.asarray(w), "cpu"),
                                 o["specs"][p], _rank_mesh(shape, r))
            assert tuple(x.shape) == tuple(cut.shape), (r, p)
            worst = max(worst, float((x.float() - cut.float()).abs().max()))
    return worst


def _run_grads(worlds, name, split, shape, zero3, shards=False, skip=(),
               jmesh=None, ids=None):
    ref = _ref(name, split, jmesh, shards, ids)
    _, cell = _cells(zero3=zero3)
    ctx = _ctx(name, None if shards else NO_DROP)
    outs = worlds[int(np.prod(shape))].run(
        R.grads_on_rank, ref["cfg_dict"], cell, shape, ref["state"],
        _tb(ref["batch"]), tuple(skip), ctx)
    return ref, outs


def _ref_steps(name, split, n_micro, jmesh, monkeypatch):
    """The reference's two train steps (AdamW at ``OPT``; the MoE at the
    no-drop factor)."""
    key = ("steps", name, split, n_micro)
    if key in _CACHE:
        return _CACHE[key]
    ref = _start(name, split)
    jcell, _ = _cells(n_micro)
    monkeypatch.setattr(RS, "get_config", lambda arch: ref["jcfg"])
    monkeypatch.setattr(RS, "AdamWConfig",
                        functools.partial(RS.AdamWConfig, **OPT))
    if name in MOE:
        dctx = RS._dctx
        monkeypatch.setattr(RS, "_dctx", lambda *a, **k: dataclasses.replace(
            dctx(*a, **k), **NO_DROP))
    jart = RS.make_train_artifacts(jcell, jmesh)
    batches = [_batch(ref["jcfg"], seed) for seed in (1, 2)]
    state = JT.TrainState(params=ref["jp"], opt=j_adamw_init(ref["jp"]))
    metrics = []
    for b in batches:
        state, m = jart.fn(jax.tree.map(jnp.copy, state), _jb(b))
        metrics.append({k: float(v) for k, v in m.items()})
    want = {f".{field}{p}": v for field in ("params", "opt")
            for p, v in _ref_leaves(getattr(state, field)).items()}
    start = _ref_leaves(ref["jp"])
    moved = max(float(np.abs(np.asarray(want[".params" + p])
                             - np.asarray(x)).max())
                for p, x in start.items())
    _CACHE[key] = dict(batches=batches, metrics=metrics, want=want,
                       moved=moved)
    return _CACHE[key]


def _steps_equal(outs, shape, want, keys=("loss", "grad_norm", "lr")):
    for o in outs:
        for got, w in zip(o["metrics"], want["metrics"]):
            for k in keys:
                assert got[k] == pytest.approx(w[k], rel=1e-5), k
    assert want["moved"] > 100 * ATOL


def check_rank_gradients_equal_the_whole_batch_gradient(worlds, name, shape,
                                                        zero3, split):
    ref, outs = _run_grads(worlds, name, split, shape, zero3)
    for o in outs:
        assert o["loss"] == pytest.approx(ref["loss"], rel=1e-6, abs=ATOL)
    assert _gaps(outs, shape, ref) <= ATOL
    calls = outs[0]["collectives"]
    if zero3 and shape[0] > 1:            # a layer gathered / broadcast
        kinds = ("all_gather", "broadcast") \
            if len(DEPTHS.get(name, (0, 0))) == 1 else \
            (("broadcast",) if split else ("all_gather",))
        assert all(calls[k]["calls"] > 0 for k in kinds)
    if shape[-1] > 1:
        assert calls["psum"]["calls"] > 0


def check_moe_on_a_data_axis_equals_the_per_shard_oracle(worlds, jmesh,
                                                         name, shape):
    """The default capacity factor: each data rank routes its own tokens
    with its shard's capacity, over repetitive text (``SKEW_IDS`` ids).
    The per-shard oracle is met, and the same ranks at the no-drop factor
    (the whole-batch gradient, as the test above holds) are more than
    100x the tolerance away: pairs drop."""
    ref, outs = _run_grads(worlds, name, 0, shape, zero3=True, shards=True,
                           jmesh=jmesh, ids=SKEW_IDS)
    for o in outs:
        assert o["loss"] == pytest.approx(ref["loss"], rel=1e-6, abs=ATOL)
    assert _gaps(outs, shape, ref) <= ATOL
    kept = worlds[int(np.prod(shape))].run(
        R.grads_on_rank, ref["cfg_dict"], _cells(zero3=True)[1], shape,
        ref["state"], _tb(ref["batch"]), (), NO_DROP)
    assert max(float((o["grads"][p] - k["grads"][p]).abs().max())
               for o, k in zip(outs, kept) for p in o["grads"]) > 100 * ATOL


def check_controls_miss_the_gradients(worlds, name, shape, skip, leaves):
    """An adjoint left out: the gradients of the leaves it touches miss by
    more than 100x the tolerance."""
    ref, outs = _run_grads(worlds, name, 0, shape, zero3=False, skip=(skip,))
    assert _gaps(outs, shape, ref, only=leaves) > 100 * ATOL


def check_the_sliding_window_bites_and_chunks(worlds):
    """At window 8 over 16 positions the window masks keys (the gradients
    differ from full attention's), and with ``chunk_kv`` at the sequence
    length the plain route takes ``chunked_sdpa`` (chunks of 4 keys) on
    (2, 2), within the tolerance of the whole-batch gradient."""
    ref = _ref("sliding", 0)
    full = dict(ref["cfg_dict"], attention_kind="full")
    _, cell = _cells()
    state = ref["state"]
    outs = worlds[4].run(R.grads_on_rank, full, cell, (2, 2), state,
                         _tb(ref["batch"]))
    assert _gaps(outs, (2, 2), ref) > 100 * ATOL
    outs = worlds[4].run(R.grads_on_rank, ref["cfg_dict"], cell, (2, 2),
                         state, _tb(ref["batch"]), (),
                         {"chunk_kv": S, "chunk_size": 4})
    assert _gaps(outs, (2, 2), ref) <= ATOL


def check_two_adamw_steps_equal_the_reference(worlds, jmesh, name, shape,
                                              zero3, monkeypatch):
    ref = _start(name, 1)
    want = _ref_steps(name, 1, 1, jmesh, monkeypatch)
    _, cell = _cells(zero3=zero3)
    outs = worlds[4].run(R.steps_on_rank, ref["cfg_dict"], cell, shape,
                         ref["state"], [_tb(b) for b in want["batches"]],
                         OPT, (), _ctx(name))
    _steps_equal(outs, shape, want)
    assert _gaps(outs, shape, None, "state", want["want"]) <= ATOL


def check_micro_batches_equal_the_reference(worlds, jmesh, name,
                                            monkeypatch):
    """n_micro 2 on (2, 2) (the bf16 accumulator): loss and grad norm
    within rtol 1e-5, the first moments within two bf16 steps of each
    leaf's largest element."""
    ref = _start(name, 1)
    want = _ref_steps(name, 1, 2, jmesh, monkeypatch)
    _, cell = _cells(n_micro=2)
    outs = worlds[4].run(R.steps_on_rank, ref["cfg_dict"], cell, (2, 2),
                         ref["state"], [_tb(b) for b in want["batches"]],
                         OPT, (), _ctx(name))
    _steps_equal(outs, (2, 2), want, ("loss", "grad_norm"))
    for r, o in enumerate(outs):
        for p, w in want["want"].items():
            if not p.startswith(".opt['mu']"):
                continue
            cut = TSH.rank_slice(tensor_from_numpy(np.asarray(w), "cpu"),
                                 o["specs"][p], _rank_mesh((2, 2), r))
            limit = 2.0 ** -7 * float(np.abs(np.asarray(w)).max())
            assert float((o["state"][p] - cut).abs().max()) <= limit, p


def check_train_launcher_on_rank_bytes_and_draw(worlds, name):
    """``launch.train``'s rank program on (pod 2, data 1, model 2) with
    ZeRO-3 weights, the batch carrying patches or frames where the model
    takes them: each rank's bytes of parameters and moments equal
    ``per_chip_bytes``; the parameters it draws a layer at a time are the
    specs' slices of the whole draw."""
    from repro_torch.models import model as TM
    cfg_dict = dataclasses.asdict(_cfg(name, 1))
    cells = {"train_4k": dataclasses.replace(
        TC.get_cell("qwen3-4b", "train_4k"), batch=B, seq_len=S,
        zero3=True)}
    shape = (2, 1, 2)
    outs = worlds[4].run(R.launcher_on_rank, cfg_dict, cells, B, 1, shape,
                         _ctx(name))
    whole = TM.init_params(config_from_dict(cfg_dict), seed=0, device="cpu")
    want = dict(TSH.named_leaves(whole))
    for r, o in enumerate(outs):
        for what, (have, predicted) in o["bytes"].items():
            assert have == predicted > 0, what
        assert len(o["steps"]) == 1 and o["steps"][0]["grad_norm"] > 0
        for p, x in o["params"].items():
            cut = TSH.rank_slice(want[p], o["pspecs"][p],
                                 _rank_mesh(shape, r))
            assert torch.equal(x, cut), p
