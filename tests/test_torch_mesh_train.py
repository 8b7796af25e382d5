"""Training on a mesh of ranks, and the serving steps on a data axis,
against the JAX package's builders on an Auto-typed 1x1 mesh (its own
mesh gives Explicit axes, which its sharding constraints reject: ROADMAP
queue 3 C1), on the CPU, in float32, for the tiny ``dense-bias-qknorm``
config of ``tests/conftest.py`` (at 3 layers, and at 4, whose layer axis
the data axes of 2 split under ZeRO-3) and, for serving, every tiny
family.

One world of two gloo ranks and one of four are started for the module
(``launch/ranks.py``); the ranks run ``tests/torch_mesh_train_ranks.py``,
which imports no JAX. Held, at atol 1e-5 unless stated:

  * on (data, model) = (2, 1), (1, 2), (2, 2) and (pod, data, model) =
    (2, 1, 2), with ZeRO-3 weights and without: each rank's loss and each
    gradient leaf's rank slice (the data-reduced gradient, or under
    ZeRO-3 the owner's slice) equal to the reference's whole-batch
    ``value_and_grad``, the data shards holding different counts of
    labels >= 0 (the loss is the whole batch's mean);
  * after two AdamW steps, each rank's parameters, ZeRO-1 moment slices
    and ``step`` equal to the reference's ``make_train_artifacts`` step's
    slices, loss and grad norm within rtol 1e-5 — both packages' steps
    at ``OPT``'s learning rate from the first step on, which moves every
    weight by more than 100x the tolerance (the default's warm-up would
    move them by less than it);
  * n_micro 2 within ``test_microbatched_step_matches_full_batch_and_
    reference``'s tolerances (loss and grad norm rtol 1e-5, the first
    moments within two bf16 steps of each leaf's largest element), the
    mesh's micro-batches the reference's (each rank's share of the whole
    batch's j-th block of rows);
  * three controls — the data reduction left out, the column-parallel
    entries' psum left out — miss the gradients by more than 100x the
    tolerance, and ZeRO-1's gather of the updated slices left out misses
    the parameters by as much;
  * the serving steps of every tiny family on a (2, 1) world against the
    reference's steps run on each rank's batch row alone (for the MoE
    that is the shard_map's local capacity): logits and cache shards
    within 1e-5, the handoff bit for bit, bytes equal to
    ``per_chip_bytes``;
  * ``launch.train``'s rank program on (2, 1) and (2, 1, 2) (ZeRO-3):
    each rank's bytes of parameters and moments equal to
    ``per_chip_bytes``, its parameters as drawn the specs' slices of the
    whole draw;
  * ``compressed_psum`` / ``hierarchical_psum`` on the (pod 2, data 2)
    world's lines, bit for bit the reference's ``quantize_int8`` /
    ``dequantize_int8`` of each participant's operand summed in axis
    order;
  * a plane of axes: each rank's index, size and members.

Every other family trains on a rank's mesh too:
tests/test_torch_mesh_train_families*.py.
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
from repro.models import model as JM
from repro.training import compression as JZ
from repro.training import train_step as JT
from repro.training.optim import adamw_init as j_adamw_init
from repro_torch.configs.base import config_from_dict
from repro_torch.launch import cells as TC
from repro_torch.launch import ranks
from repro_torch.launch import sharding as TSH
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import Mesh
from repro_torch.models.collectives import AxisShard
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.training import train_step as TT
from repro_torch.training.optim import adamw_init

from conftest import TINY_FAMILIES
from test_torch_launch_steps import _ref_leaves, _to_port

ATOL = 1e-5
B, S = 4, 16
DENSE = "dense-bias-qknorm"
CFGS = {n: dataclasses.replace(TINY_FAMILIES[DENSE], num_layers=n)
        for n in (3, 4)}
MESHES = [(2, 1), (1, 2), (2, 2), (2, 1, 2)]
_GET_CELL = RC.get_cell
# AdamW for both packages' steps: at its peak learning rate from step 1
# (the default warms up over 100 steps, so that step 1 moves a weight by
# ~3e-6, under ATOL), a step of ~1e-3 a weight; eps 1e-5, under 99 % of
# the tiny model's gradient elements in magnitude (median 6e-3): at the
# default 1e-8 an element whose gradient lies within ~1e-8 of zero turns
# the float32 rounding of its gradient into an update 3e-5 off the
# reference's on one device already, with no mesh
OPT = {"lr": 1e-3, "warmup_steps": 1, "eps": 1e-5}
_INIT = jax.jit(JM.init_params, static_argnums=1)
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


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _rank_mesh(shape, r) -> Mesh:
    """Rank r's mesh of ``shape`` as the parent sees it: for cutting the
    reference's whole tensors to that rank's slices."""
    coords, rest = [], r
    for s in reversed(shape):
        coords.append(rest % s)
        rest //= s
    coords = tuple(reversed(coords))
    return Mesh(tuple(shape), _axes(shape), torch.device("cpu"), coords,
                tuple(AxisShard(c, s, None, ()) if s > 1 else None
                      for c, s in zip(coords, shape)))


def _cells(n_micro=1, zero3=False):
    """The train cell for both packages (the port's is the one the ranks
    get: the reference's would import the JAX package there)."""
    kw = dict(batch=B, seq_len=S, n_micro=n_micro, zero3=zero3)
    return (dataclasses.replace(_GET_CELL("qwen3-4b", "train_4k"), **kw),
            dataclasses.replace(TC.get_cell("qwen3-4b", "train_4k"), **kw))


def _batch(seed=1, all_labels=False):
    """Tokens and labels (B, S); unless ``all_labels``, label -1 on the
    last 11 positions of row 1 and the last 4 of row 3, so that the data
    shards of (2, ...) meshes (rows 0-1, 2-3) hold 21 and 28 labels."""
    rng = np.random.default_rng(seed)
    v = CFGS[3].vocab_size
    out = {"tokens": rng.integers(0, v, (B, S)).astype(np.int32),
           "labels": rng.integers(0, v, (B, S)).astype(np.int32)}
    if not all_labels:
        out["labels"][1, 5:] = -1
        out["labels"][3, 12:] = -1
    return out


def _ref(layers):
    """The reference's params, whole-batch loss and gradients at
    ``layers`` layers, and the port's whole train state from them."""
    if layers in _CACHE:
        return _CACHE[layers]
    jcfg = CFGS[layers]
    jp = _INIT(jax.random.key(0), jcfg)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jb, remat=True)))(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    _CACHE[layers] = dict(
        jcfg=jcfg, cfg_dict=dataclasses.asdict(jcfg), jp=jp, batch=batch,
        loss=float(loss), grads=_ref_leaves(grads),
        state=TT.TrainState(params=tp, opt=adamw_init(tp)))
    return _CACHE[layers]


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _slices_equal(outs, shape, want, specs_key, atol=ATOL, prefix=""):
    """Each rank's leaves ``outs[r][specs_key]`` ({path: tensor}) equal to
    the rank's spec slices of ``want`` ({path: array}); returns the worst
    gap."""
    worst = 0.0
    for r, out in enumerate(outs):
        got = out[specs_key]
        assert sorted(got) == sorted(prefix + p for p in want)
        for p, w in want.items():
            cut = TSH.rank_slice(tensor_from_numpy(np.asarray(w), "cpu"),
                                 out["specs"][prefix + p],
                                 _rank_mesh(shape, r))
            x = got[prefix + p]
            assert tuple(x.shape) == tuple(cut.shape), (r, p)
            gap = float((x.float() - cut.float()).abs().max())
            worst = max(worst, gap)
            assert gap <= atol, f"rank {r} {p}: {gap}"
    return worst


def _grad_gap(outs, shape, ref):
    return max(float((x - TSH.rank_slice(
        tensor_from_numpy(ref["grads"][p[len(".params"):]], "cpu"),
        o["specs"][p], _rank_mesh(shape, r))).abs().max())
        for r, o in enumerate(outs) for p, x in o["grads"].items())


# --------------------------------------------------------------------- #
# gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("zero3,layers", [(False, 3), (True, 4), (True, 3)])
def test_rank_gradients_equal_the_whole_batch_gradient(worlds, shape,
                                                       zero3, layers):
    """ZeRO-3 at 4 layers splits the layer axis on the data axes of 2 (a
    layer's weights broadcast by the rank that holds it); at 3 layers a
    dim inside the layer (gathered)."""
    ref = _ref(layers)
    _, cell = _cells(zero3=zero3)
    outs = worlds[int(np.prod(shape))].run(
        R.grads_on_rank, ref["cfg_dict"], cell, shape, ref["state"],
        _tb(ref["batch"]))
    counts = [int((ref["batch"]["labels"][rows] >= 0).sum())
              for rows in (slice(0, 2), slice(2, 4))]
    assert counts[0] != counts[1]
    for o in outs:
        assert o["loss"] == pytest.approx(ref["loss"], rel=1e-6, abs=ATOL)
    _slices_equal(outs, shape, ref["grads"], "grads", prefix=".params")
    calls = outs[0]["collectives"]
    if zero3 and shape[0] * (shape[1] if len(shape) == 3 else 1) > 1:
        key = "broadcast" if layers == 4 else "all_gather"
        assert calls[key]["calls"] > 0


@pytest.mark.parametrize("shape,skip", [((2, 1), "data_grads"),
                                        ((1, 2), "column_entry"),
                                        ((2, 1, 2), "data_grads")])
def test_controls_miss_the_gradients(worlds, shape, skip):
    """The data-axis reduction left out (on (2, 1, 2) that is the pod's),
    or the column-parallel entries' backward psum: the gradients miss by
    more than 100x the tolerance."""
    ref = _ref(3)
    _, cell = _cells()
    outs = worlds[int(np.prod(shape))].run(
        R.grads_on_rank, ref["cfg_dict"], cell, shape, ref["state"],
        _tb(ref["batch"]), (skip,))
    assert _grad_gap(outs, shape, ref) > 100 * ATOL


# --------------------------------------------------------------------- #
# AdamW steps
# --------------------------------------------------------------------- #
def _ref_steps(layers, n_micro, zero3, jmesh, monkeypatch):
    """The reference's two train steps (AdamW at ``OPT``)."""
    key = ("steps", layers, n_micro, zero3)
    if key in _CACHE:
        return _CACHE[key]
    ref = _ref(layers)
    jcell, _ = _cells(n_micro, zero3)
    monkeypatch.setattr(RS, "get_config", lambda arch: ref["jcfg"])
    monkeypatch.setattr(RS, "AdamWConfig",
                        functools.partial(RS.AdamWConfig, **OPT))
    jart = RS.make_train_artifacts(jcell, jmesh)
    batches = [_batch(seed) for seed in (1, 2)]
    state = JT.TrainState(params=ref["jp"], opt=j_adamw_init(ref["jp"]))
    metrics = []
    for b in batches:
        state, m = jart.fn(jax.tree.map(jnp.copy, state),
                           {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    want = {f".{field}{p}": v for field in ("params", "opt")
            for p, v in _ref_leaves(getattr(state, field)).items()}
    _CACHE[key] = dict(batches=batches, metrics=metrics, want=want)
    return _CACHE[key]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("zero3", [False, True])
def test_two_adamw_steps_equal_the_reference(worlds, jmesh, shape, zero3,
                                             monkeypatch):
    layers = 4 if zero3 else 3
    ref = _ref(layers)
    want = _ref_steps(layers, 1, zero3, jmesh, monkeypatch)
    _, cell = _cells(zero3=zero3)
    outs = worlds[int(np.prod(shape))].run(
        R.steps_on_rank, ref["cfg_dict"], cell, shape, ref["state"],
        [_tb(b) for b in want["batches"]], OPT)
    for o in outs:
        for got, w in zip(o["metrics"], want["metrics"]):
            for k in ("loss", "grad_norm", "lr"):
                assert got[k] == pytest.approx(w[k], rel=1e-5), k
    assert _moved(layers, want) > 100 * ATOL
    _slices_equal(outs, shape, want["want"], "state")
    if shape[0] > 1:                     # ZeRO-1: the moments are slices
        for o in outs:
            sliced = [p for p, s in o["specs"].items()
                      if p.startswith(".opt['mu']") and TSH.spec_ways(
                          s, dict(zip(_axes(shape), shape))) > 1]
            assert sliced and all(o["state"][p].numel()
                                  < np.asarray(want["want"][p]).size
                                  for p in sliced)


def _moved(layers, want):
    """The reference's largest parameter change over its steps."""
    start = _ref_leaves(_ref(layers)["jp"])
    return max(float(np.abs(np.asarray(want["want"][".params" + p])
                            - np.asarray(x)).max())
               for p, x in start.items())


@pytest.mark.parametrize("shape", [(2, 1), (2, 1, 2)])
def test_control_without_the_gather_back_misses_the_params(worlds, jmesh,
                                                           shape,
                                                           monkeypatch):
    """ZeRO-1's gather of the updated slices left out: the parameters
    whose moments the data axes split keep the other ranks' slices as
    they were, and miss the reference's by more than 100x the
    tolerance."""
    ref = _ref(3)
    want = _ref_steps(3, 1, False, jmesh, monkeypatch)
    _, cell = _cells()
    outs = worlds[int(np.prod(shape))].run(
        R.steps_on_rank, ref["cfg_dict"], cell, shape, ref["state"],
        [_tb(b) for b in want["batches"]], OPT, ("gather_back",))
    with pytest.raises(AssertionError):
        _slices_equal(outs, shape, want["want"], "state")
    assert _slices_equal(outs, shape, want["want"], "state",
                         atol=np.inf) > 100 * ATOL


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_micro_batches_equal_the_reference(worlds, jmesh, shape,
                                           monkeypatch):
    """n_micro 2 (the bf16 accumulator), the label counts unequal across
    the micro-batches and their data shards. A rank's micro-batch j is
    its share of the whole batch's j-th block of rows, as the
    reference's is."""
    ref = _ref(3)
    want = _ref_steps(3, 2, False, jmesh, monkeypatch)
    _, cell = _cells(n_micro=2)
    outs = worlds[int(np.prod(shape))].run(
        R.steps_on_rank, ref["cfg_dict"], cell, shape, ref["state"],
        [_tb(b) for b in want["batches"]], OPT)
    for o in outs:
        for got, w in zip(o["metrics"], want["metrics"]):
            for k in ("loss", "grad_norm"):
                assert got[k] == pytest.approx(w[k], rel=1e-5), k
    mu = {p: w for p, w in want["want"].items() if p.startswith(".opt['mu']")}
    for r, o in enumerate(outs):
        for p, w in mu.items():
            cut = TSH.rank_slice(tensor_from_numpy(np.asarray(w), "cpu"),
                                 o["specs"][p], _rank_mesh(shape, r))
            limit = 2.0 ** -7 * float(np.abs(np.asarray(w)).max())
            assert float((o["state"][p] - cut).abs().max()) <= limit, p


# --------------------------------------------------------------------- #
# serving on a data axis
# --------------------------------------------------------------------- #
SEQ = 24


def _serve_cells(cell_mod, batch):
    return {s: dataclasses.replace(cell_mod.get_cell("qwen3-4b", s),
                                   batch=batch, seq_len=SEQ,
                                   cache_dtype="float32")
            for s in ("prefill_32k", "decode_32k")}


def _cat(trees):
    """Cache trees of one batch row each → one tree, each (count, B, ...)
    leaf concatenated on its batch dim."""
    flat = [jax.tree_util.tree_flatten(t) for t in trees]
    leaves = [jnp.concatenate(xs, axis=1)
              for xs in zip(*(f[0] for f in flat))]
    return jax.tree_util.tree_unflatten(flat[0][1], leaves)


@pytest.fixture(scope="module", params=sorted(TINY_FAMILIES))
def serving(request, worlds, jmesh):
    """The reference's prefill → handoff → serve step of a tiny family run
    on each batch row alone (batch 1), and the (2, 1) world's steps on the
    same whole inputs."""
    jcfg = TINY_FAMILIES[request.param]
    cfg_dict = dataclasses.asdict(jcfg)
    jcells, tcells = _serve_cells(RC, 1), _serve_cells(TC, 2)
    mp = pytest.MonkeyPatch()
    mp.setattr(RS, "get_config", lambda arch: jcfg)
    mp.setattr(RC, "get_cell", lambda arch, shape: jcells[shape])
    try:
        jp = _INIT(jax.random.key(0), jcfg)
        pre = RS.make_prefill_artifacts(jcells["prefill_32k"], jmesh)
        ho = RS.make_handoff_artifacts("qwen3-4b", jmesh)
        srv = RS.make_serve_artifacts(jcells["decode_32k"], jmesh)
        rng = np.random.default_rng(3)
        inputs, rows = {}, []
        for k, a in pre.abstract_args[1].items():
            shape = (2,) + tuple(a.shape[1:])
            inputs[k] = (rng.integers(0, jcfg.vocab_size, shape)
                         .astype(np.int32) if k == "tokens" else
                         rng.standard_normal(shape).astype(np.float32))
        for r in range(2):
            one = {k: jnp.asarray(v[r:r + 1]) for k, v in inputs.items()}
            last, cp = pre.fn(jp, one)
            cd = ho.fn(jax.tree.map(jnp.copy, cp))
            tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
            io = {"tokens": tok, "positions": jnp.full_like(tok, SEQ)}
            logits, cd2 = srv.fn(jp, jax.tree.map(jnp.copy, cd), io)
            rows.append(dict(last=last, cp=cp, cd=cd, io=io, logits=logits,
                             cd2=cd2))
    finally:
        mp.undo()
    tcfg = config_from_dict(cfg_dict)
    mp = pytest.MonkeyPatch()
    mp.setattr(TS, "get_config", lambda arch: tcfg)
    mp.setattr(TS, "get_cell", lambda arch, shape: tcells[shape])
    try:
        one = Mesh((1, 1), ("data", "model"), torch.device("cpu"))
        tho = TS.make_handoff_artifacts("qwen3-4b", one, batch=2)
        tsrv = TS.make_serve_artifacts(tcells["decode_32k"], one)
        caches_p = _to_port(_cat([x["cp"] for x in rows]),
                            tho.abstract_args[0])
        caches_d = _to_port(_cat([x["cd"] for x in rows]),
                            tsrv.abstract_args[1])
    finally:
        mp.undo()
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    io = {k: torch.from_numpy(np.concatenate([np.asarray(x["io"][k])
                                              for x in rows]))
          for k in ("tokens", "positions")}
    outs = worlds[2].run(R.serve_on_rank, cfg_dict, tcells, params,
                         {k: torch.from_numpy(v) for k, v in inputs.items()},
                         caches_p, caches_d, io)
    return dict(name=request.param, rows=rows, outs=outs)


def _rank_tree_equal(got, want_tree, exact=False):
    want = _ref_leaves(want_tree)
    mine = dict(TSH.named_leaves(got))
    assert sorted(mine) == sorted(want)
    for p, x in mine.items():
        w = tensor_from_numpy(want[p], "cpu")
        assert x.dtype == w.dtype and x.shape == w.shape, p
        if exact:
            assert torch.equal(x.contiguous().view(torch.uint8),
                               w.contiguous().view(torch.uint8)), p
        else:
            torch.testing.assert_close(x, w, atol=ATOL, rtol=0, msg=p)


def test_prefill_on_a_data_axis_equals_each_rows_reference(serving):
    for out, row in zip(serving["outs"], serving["rows"]):
        last, caches = out["prefill"]
        torch.testing.assert_close(
            last, tensor_from_numpy(np.asarray(row["last"]), "cpu"),
            atol=ATOL, rtol=0)
        _rank_tree_equal(caches, row["cp"])


def test_handoff_on_a_data_axis_is_each_rows_bit_for_bit(serving):
    for out, row in zip(serving["outs"], serving["rows"]):
        _rank_tree_equal(out["handoff"], row["cd"], exact=True)


def test_serve_step_on_a_data_axis_equals_each_rows_reference(serving):
    for out, row in zip(serving["outs"], serving["rows"]):
        logits, caches = out["serve"]
        torch.testing.assert_close(
            logits, tensor_from_numpy(np.asarray(row["logits"]), "cpu"),
            atol=ATOL, rtol=0)
        _rank_tree_equal(caches, row["cd2"])


def test_serving_bytes_on_a_data_axis_equal_per_chip_bytes(serving):
    for out in serving["outs"]:
        for what, (have, predicted) in out["bytes"].items():
            assert have == predicted > 0, what
        for spec in out["specs"]["caches_d"].values():
            assert spec[1] == "data"           # (count, B, ...): the rows


# --------------------------------------------------------------------- #
# the launcher, the compressed psums, planes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,zero3", [((2, 1), False), ((2, 1, 2), True)])
def test_train_launcher_on_rank_bytes_and_draw(worlds, shape, zero3):
    """``launch.train``'s rank program (``--mesh 2x1``; ``--mesh 1x2
    --multi-pod`` with ZeRO-3 weights): each rank's bytes of parameters
    and moments equal ``per_chip_bytes``; the parameters it draws a layer
    at a time are the specs' slices of the whole draw."""
    from repro_torch.models import model as TM
    jcfg = CFGS[4]
    cfg_dict = dataclasses.asdict(jcfg)
    cells = {"train_4k": dataclasses.replace(
        TC.get_cell("qwen3-4b", "train_4k"), batch=B, seq_len=S,
        zero3=zero3)}
    outs = worlds[int(np.prod(shape))].run(R.launcher_on_rank, cfg_dict,
                                           cells, B, 1, shape)
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
    if zero3:                         # the pod splits every leaf too
        for o in outs:
            assert 2 * o["bytes"]["params"][0] <= TSH.local_bytes(whole)


@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_compressed_psums_on_the_meshs_lines(worlds, wire):
    """On the (pod 2, data 2) world: ``compressed_psum`` over the pod line
    and ``hierarchical_psum`` (data inner, pod outer) bit for bit the
    reference's quantizers applied to each participant's operand, summed
    in axis order."""
    outs = worlds[4].run(R.compressed_on_rank, wire)
    xs = [np.asarray(R.operand(r).numpy()) for r in range(4)]

    def wired(v):
        v = jnp.asarray(v)
        if wire == "bf16":
            return v.astype(jnp.bfloat16)
        if wire == "int8":
            return JZ.dequantize_int8(*JZ.quantize_int8(v), jnp.float32)
        return v

    def total(parts):
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return np.asarray(acc.astype(jnp.float32))

    for r, o in enumerate(outs):
        pod, data = o["pod"], o["data"]
        assert r in pod and r in data and len(pod) == len(data) == 2
        np.testing.assert_array_equal(
            o["compressed"].numpy(), total([wired(xs[i]) for i in pod]))
        inner = {i: np.asarray(sum(jnp.asarray(xs[j]) for j in
                                   outs[i]["data"]), np.float32)
                 for i in pod}
        np.testing.assert_array_equal(
            o["hierarchical"].numpy(),
            total([wired(inner[i]) for i in pod]))


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2)])
def test_planes_of_axes(worlds, shape):
    """A tuple of axes is the plane of the ranks that share the other
    coordinates, indexed row-major over it; its psum spans it."""
    outs = worlds[4].run(R.planes_on_rank, shape)
    for r, o in enumerate(outs):
        assert o["coords"] == _rank_mesh(shape, r).coords
        assert o["all"] == (r, 4, (0, 1, 2, 3))
        assert o["psum"] == 6.0
        data = o["data"]
        if len(shape) == 2:
            assert data == o["axes"]["data"]
        else:                           # (pod, data): data is 1
            assert data == o["axes"]["pod"]
        model = o["axes"]["model"]
        assert model[1] == 2 and r in model[2]
