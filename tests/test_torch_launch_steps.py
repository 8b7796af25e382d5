"""The port's step builders against the JAX package's, value for value, on
the CPU, for each of the nine tiny families of ``tests/conftest.py``.

``get_config`` is patched in both packages' step modules to the tiny
config and the cells are the qwen3-4b cells cut to batch 2 x 24 tokens
with float32 caches, as the tiny configs compute (the handoff's cells
likewise; its D cells in bf16 and float8), the enc-dec's memory cut to 16
frames (the builders feed ``max_source_len`` frames); the reference runs on an Auto-typed 1x1
mesh that the test builds (its own ``launch/mesh.py`` gives Explicit axes,
which its sharding constraints reject: ROADMAP queue 3 C1). Parameters
come from the reference's ``init_params`` through ``params_from_numpy``;
each builder gets the same inputs on both sides (the serve step and the
handoff take the reference's own caches, carried across).

  * prefill: the last logits and every cache leaf within atol 1e-5;
  * serve step: the logits and the caches within atol 1e-5;
  * train step (n_micro 2): loss and grad_norm within rtol 1e-5, the
    parameters within atol 5e-3 (tests/test_training.py:56's bound), the
    first moments within two bf16 steps of each leaf's largest element
    (the bf16 accumulator, as tests/test_torch_training.py holds them);
  * handoff: D's caches bit for bit, also into a float8 D cache; and, at a
    deployed model axis of 16 (heads padded), the head slice equals a
    direct slice of P's caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.launch import cells as RC
from repro.launch import steps as RS
from repro.models import model as JM
from repro.training import train_step as JT
from repro.training.optim import adamw_init as j_adamw_init
from repro_torch.configs.base import config_from_dict
from repro_torch.launch import sharding as TSH
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.training import train_step as TT
from repro_torch.training.optim import adamw_init
from repro_torch.training.tree import leaves, leaves_with_paths, unflatten

from conftest import TINY_FAMILIES
from test_torch_launch import _norm

FAMILIES = sorted(TINY_FAMILIES)
SEQ, BATCH = 24, 2
ATOL = 1e-5
_INIT = jax.jit(JM.init_params, static_argnums=1)
_PREFILLS = {}


_GET_CELL = RC.get_cell


def _cell(shape, **kw):
    return dataclasses.replace(_GET_CELL("qwen3-4b", shape), batch=BATCH,
                               seq_len=SEQ, **kw)


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.fixture(params=FAMILIES)
def fam(request, monkeypatch):
    jcfg = TINY_FAMILIES[request.param]
    if jcfg.is_enc_dec:            # 16 frames of memory, not Whisper's 1500
        jcfg = dataclasses.replace(jcfg, max_source_len=16)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    monkeypatch.setattr(RS, "get_config", lambda arch: jcfg)
    monkeypatch.setattr(TS, "get_config", lambda arch: tcfg)
    cells = {s: _cell(s, cache_dtype="float32")
             for s in ("prefill_32k", "decode_32k")}

    def get_cell(arch, shape):
        return cells[shape]

    monkeypatch.setattr(RC, "get_cell", get_cell)
    monkeypatch.setattr(TS, "get_cell", get_cell)
    jp = _INIT(jax.random.key(0), jcfg)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jp=jp, cells=cells,
                tp=lambda: params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu"))


def _inputs(abstract, cfg, seed=0):
    """numpy inputs for a builder's abstract input dict."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, a in abstract.items():
        if jnp.issubdtype(a.dtype, jnp.integer):
            out[k] = rng.integers(0, cfg.vocab_size, a.shape).astype(np.int32)
        else:
            out[k] = rng.standard_normal(a.shape).astype(np.float32)
    return out


def _j(batch, abstract):
    return {k: jnp.asarray(v, abstract[k].dtype) for k, v in batch.items()}


def _t(batch, abstract):
    return {k: torch.from_numpy(v).to(abstract[k].dtype)
            for k, v in batch.items()}


def _ref_leaves(tree):
    return {_norm(jax.tree_util.keystr(k)): np.asarray(x)
            for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_port(ref_tree, like):
    """The reference's cache tree as the port's (``like`` gives the tree,
    e.g. a builder's abstract caches)."""
    ref = _ref_leaves(ref_tree)
    flat = [tensor_from_numpy(ref[p], torch.device("cpu"))
            if isinstance(x, torch.Tensor) else x
            for p, x in leaves_with_paths(like)]
    return unflatten(like, flat)


def _close_tree(got, want, atol=ATOL, exact=False):
    ref = _ref_leaves(want)
    mine = dict(TSH.named_leaves(got))
    assert sorted(mine) == sorted(ref)
    for p, x in mine.items():
        w = ref[p]
        assert str(x.dtype).replace("torch.", "") == w.dtype.name, p
        if exact:
            np.testing.assert_array_equal(
                x.view(torch.uint8).numpy() if x.dtype.itemsize == 1
                else x.float().numpy() if x.dtype == torch.bfloat16
                else x.numpy(),
                w.view(np.uint8) if x.dtype.itemsize == 1
                else w.astype(np.float32), err_msg=p)
        else:
            np.testing.assert_allclose(x.float().numpy(),
                                       w.astype(np.float32), atol=atol,
                                       rtol=0, err_msg=p)


def _ref_prefill(fam, jmesh):
    """The reference's prefill of a family's inputs (once a family)."""
    if fam["name"] not in _PREFILLS:
        art = RS.make_prefill_artifacts(fam["cells"]["prefill_32k"], jmesh)
        batch = _inputs(art.abstract_args[1], fam["jcfg"])
        last, caches = art.fn(fam["jp"], _j(batch, art.abstract_args[1]))
        _PREFILLS[fam["name"]] = batch, last, caches
    batch, last, caches = _PREFILLS[fam["name"]]
    # a copy: the reference's handoff donates the caches it is given
    return batch, last, jax.tree.map(jnp.copy, caches)


def test_prefill_step_matches_reference(fam, jmesh, tmesh):
    batch, jlast, jcaches = _ref_prefill(fam, jmesh)
    art = TS.make_prefill_artifacts(fam["cells"]["prefill_32k"], tmesh)
    with torch.no_grad():
        last, caches = art.fn(fam["tp"](), _t(batch, art.abstract_args[1]))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL,
                               rtol=0)
    _close_tree(caches, jcaches)


def test_serve_step_matches_reference(fam, jmesh, tmesh):
    _, jlast, jcaches = _ref_prefill(fam, jmesh)
    jcaches = RS.make_handoff_artifacts("qwen3-4b", jmesh).fn(jcaches)
    jart = RS.make_serve_artifacts(fam["cells"]["decode_32k"], jmesh)
    tart = TS.make_serve_artifacts(fam["cells"]["decode_32k"], tmesh)
    tok = np.asarray(jnp.argmax(jlast, -1), np.int32)[:, None]
    io = {"tokens": tok, "positions": np.full_like(tok, SEQ)}
    caches = _to_port(jcaches, tart.abstract_args[1])
    jlog, jcaches = jart.fn(fam["jp"], jcaches,
                            {k: jnp.asarray(v) for k, v in io.items()})
    with torch.no_grad():
        log, caches = tart.fn(fam["tp"](), caches,
                              {k: torch.from_numpy(v) for k, v in io.items()})
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    _close_tree(caches, jcaches)


def test_train_step_matches_reference(fam, jmesh, tmesh):
    cell = dataclasses.replace(_cell("train_4k"), n_micro=2)
    jart = RS.make_train_artifacts(cell, jmesh)
    tart = TS.make_train_artifacts(cell, tmesh)
    batch = _inputs(jart.abstract_args[1], fam["jcfg"], seed=1)
    for k, a in tart.abstract_args[1].items():
        assert batch[k].shape == tuple(a.shape)
    jstate = JT.TrainState(params=fam["jp"], opt=j_adamw_init(fam["jp"]))
    tp = fam["tp"]()
    tstate = TT.TrainState(params=tp, opt=adamw_init(tp))
    js, jm = jart.fn(jstate, _j(batch, jart.abstract_args[1]))
    ts, tm = tart.fn(tstate, _t(batch, tart.abstract_args[1]))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for w, g in zip(jax.tree.leaves(js.params), leaves(ts.params)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=5e-3)
    for w, g in zip(jax.tree.leaves(js.opt["mu"]), leaves(ts.opt["mu"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2.0 ** -7 * np.abs(w).max())


@pytest.mark.parametrize("d_dtype", ["bfloat16", "float8_e4m3fn"])
def test_handoff_matches_reference_bit_for_bit(fam, jmesh, tmesh, d_dtype,
                                               monkeypatch):
    cells = dict(fam["cells"])
    cells["decode_32k"] = dataclasses.replace(cells["decode_32k"],
                                              cache_dtype=d_dtype)
    monkeypatch.setattr(RC, "get_cell", lambda arch, shape: cells[shape])
    monkeypatch.setattr(TS, "get_cell", lambda arch, shape: cells[shape])
    _, _, jcaches = _ref_prefill(fam, jmesh)
    art = TS.make_handoff_artifacts("qwen3-4b", tmesh, batch=BATCH)
    caches_p = _to_port(jcaches, art.abstract_args[0])
    want = RS.make_handoff_artifacts("qwen3-4b", jmesh).fn(jcaches)
    got = art.fn(caches_p)
    _close_tree(got, want, exact=True)
    cfg = art.cfg
    full = not (cfg.attention_kind == "sliding" and cfg.sliding_window)
    for _, pos in [(p, x) for p, x in TSH.named_leaves(got)
                   if p.endswith(".pos")]:
        assert pos.shape[-1] == (cells["decode_32k"].decode_capacity()
                                 if full else cfg.sliding_window)
    for c in (c for g in got for c in g if hasattr(c, "full_capacity")):
        assert c.full_capacity == full


def test_handoff_drops_the_pad_heads_at_a_deployed_axis_of_16():
    """qwen-like heads that a 16-way model axis pads (12 heads on 3 KV
    heads → 16 on 4): the handoff's K/V are P's first 3 KV heads, cut
    directly, padded to D's capacity; pos -1 in the pad slots."""
    cfg = config_from_dict(dict(
        name="pad", family="dense", num_layers=2, d_model=48, num_heads=12,
        num_kv_heads=3, head_dim=16, d_ff=64, vocab_size=64,
        param_dtype="float32", compute_dtype="float32"))
    cfg_p = TSH.deploy_config(cfg, 16, "prefill")
    cfg_d = TSH.deploy_config(cfg, 16, "decode")
    assert (cfg_p.num_heads, cfg_p.num_kv_heads) == (16, 4)
    assert cfg_d.num_kv_heads == 3
    gen = torch.Generator().manual_seed(0)
    caches_p = TM.init_caches(cfg_p, 2, 10, device="cpu")
    for c in (c for g in caches_p for c in g):
        c.k.copy_(torch.randn(c.k.shape, generator=gen))
        c.v.copy_(torch.randn(c.v.shape, generator=gen))
        c.pos.copy_(torch.arange(10, dtype=torch.int32))
    caches_d = TM.abstract_caches(cfg_d, 2, 32, torch.bfloat16,
                                  full_capacity=True)
    got = TS.realign_caches(caches_p, caches_d)
    for cp, cd in zip((c for g in caches_p for c in g),
                      (c for g in got for c in g)):
        assert cd.k.shape == (2, 2, 32, 3, 16) and cd.full_capacity
        torch.testing.assert_close(cd.k[:, :, :10],
                                   cp.k[:, :, :, :3].bfloat16(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(cd.v[:, :, :10],
                                   cp.v[:, :, :, :3].bfloat16(), rtol=0,
                                   atol=0)
        assert (cd.k[:, :, 10:] == 0).all()
        assert (cd.pos[:, :, 10:] == -1).all()
        assert torch.equal(cd.pos[:, :, :10], cp.pos)
