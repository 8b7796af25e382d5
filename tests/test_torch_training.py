"""The port's training substrate against ``repro.training`` on the CPU:
AdamW (its schedule, clipping and one update from equal inputs), the
train step (one step, micro-batches, 30 steps of falling loss), the
synthetic data, checkpoints (round trip, GC, meta, resume, and the files
and manifests of both packages for the same state), and gradient
compression (int8 quantization, error feedback, the psums over a
world-size-1 gloo group).

Tolerances: ``adamw_update`` from equal inputs within rtol 1e-6 of each
leaf's largest element (XLA fuses b1·mu + (1-b1)·g into one FMA, so where
the two terms cancel, an element differs by their rounding); one
train step's loss within rtol 1e-5 and its parameters within atol 5e-3 at
lr 1e-3 (``tests/test_training.py``'s bound: the first AdamW step moves a
parameter by about lr · sign(g), so a gradient near zero that differs by
rounding can flip it); data, checkpoints and compression bit for bit."""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
pytest.importorskip("hypothesis")
from hypothesis import given, strategies as st

import jax
import jax.numpy as jnp
import torch
import torch.distributed as tdist
from jax.sharding import Mesh, PartitionSpec as P

from repro.training import checkpoint as JC
from repro.training import compression as JZ
from repro.training import data as JD
from repro.training import optim as JO
from repro.training import train_step as JT
from repro_torch.configs.base import config_from_dict
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import checkpoint as TC
from repro_torch.training import compression as TZ
from repro_torch.training import data as TD
from repro_torch.training import optim as TO
from repro_torch.training import train_step as TT
from repro_torch.training.tree import leaves, leaves_with_paths

from conftest import TINY_FAMILIES, tiny

JCFG = tiny("train", num_layers=2, vocab_size=256)
TCFG = config_from_dict(dataclasses.asdict(JCFG))
J_OPT = JO.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
T_OPT = TO.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)


def _np_batches(n, bs=8, seq=32, seed=1, cfg=JCFG):
    it = iter(JD.SyntheticTokens(cfg, JD.DataConfig(batch_size=bs,
                                                    seq_len=seq, seed=seed)))
    return [next(it) for _ in range(n)]


def _port_state(jstate) -> TT.TrainState:
    """The reference's train state, converted through numpy."""
    tree = params_from_numpy(jax.tree.map(np.asarray, {
        "params": jstate.params, "opt": jstate.opt}), "cpu")
    return TT.TrainState(params=tree["params"], opt=tree["opt"])


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if \
        np.asarray(a).dtype.name == "bfloat16" else np.asarray(a)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def _opt_inputs(grad_dtype):
    """Parameters of every rank (a stacked (3, 4, 8) leaf, stacked norm
    vectors (3, 8) that take weight decay, a vector, a bf16 matrix), the
    reference's state after two steps, and a third step's gradients."""
    rng = np.random.default_rng(3)

    def arr(shape, dt=jnp.float32, s=1.0):
        return jnp.asarray(rng.standard_normal(shape) * s, dt)
    params = {"stack": arr((3, 4, 8)), "norms": arr((3, 8)), "b": arr((8,)),
              "h": arr((5, 6), jnp.bfloat16)}

    def grads(s):
        return jax.tree.map(lambda p: arr(p.shape, grad_dtype, s), params)
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    state = JO.adamw_init(params)
    for s in (0.5, 2.0):
        params, state, _ = JO.adamw_update(cfg, params, grads(s), state)
    return params, grads(3.0), state


@pytest.mark.parametrize("grad_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_reference(grad_dtype, grad_clip):
    jp, jg, jstate = _opt_inputs(grad_dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=grad_clip)
    jp2, jst2, jm = JO.adamw_update(JO.AdamWConfig(**kw), jp, jg, jstate)
    tree = params_from_numpy(jax.tree.map(np.asarray, {
        "p": jp, "g": jg, "s": jstate}), "cpu")
    tp2, tst2, tm = TO.adamw_update(TO.AdamWConfig(**kw), tree["p"],
                                    tree["g"], tree["s"])
    assert tp2 is tree["p"] and int(tst2["step"]) == int(jst2["step"]) == 3
    for want, got in ((jp2, tp2), (jst2["mu"], tst2["mu"]),
                      (jst2["nu"], tst2["nu"])):
        for w, g in zip(jax.tree.leaves(want), leaves(got)):
            assert g.dtype == params_from_numpy(np.asarray(w), "cpu").dtype
            w = _f32(w)
            np.testing.assert_allclose(_np(g), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_schedule_matches_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(JO.schedule(JO.AdamWConfig(**kw), jnp.asarray(step)))
    got = float(TO.schedule(TO.AdamWConfig(**kw),
                            torch.tensor(step, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_warmup_and_decay():
    cfg = TO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1)
    for step, lr in ((5, 0.5), (10, 1.0), (100, 0.1)):
        assert float(TO.schedule(cfg, torch.tensor(step))) == \
            pytest.approx(lr)


def test_adamw_moves_against_gradient():
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([1.0, -1.0, 0.0])}
    before = params["w"].clone()
    cfg = TO.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0,
                         grad_clip=0.0)
    p2, st2, _ = TO.adamw_update(cfg, params, grads, TO.adamw_init(params))
    assert p2["w"][0] < before[0] and p2["w"][1] > before[1]
    assert p2["w"][2] == before[2]
    assert st2["step"].dtype == torch.int32 and int(st2["step"]) == 1


def test_grad_clip_bounds_update():
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 1e6)}
    cfg = TO.AdamWConfig(lr=0.1, warmup_steps=0, grad_clip=1.0,
                         weight_decay=0.0)
    p2, _, m = TO.adamw_update(cfg, params, grads, TO.adamw_init(params))
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    # clipped to norm 1: the first step still moves by about lr
    np.testing.assert_allclose(p2["w"].numpy(), 0.9, rtol=1e-5)


def test_update_slices_give_the_unsliced_result(monkeypatch):
    """A leaf updated in slices along its first axis equals the whole-leaf
    update, bit for bit (the slicing only bounds the temporaries)."""
    rng = np.random.default_rng(4)
    p0 = torch.from_numpy(rng.standard_normal((6, 5, 4)).astype(np.float32))
    g = {"w": torch.from_numpy(rng.standard_normal((6, 5, 4))
                               .astype(np.float32))}
    out = []
    for elems in (TO.SLICE_ELEMS, 20):        # whole leaf, one layer a slice
        monkeypatch.setattr(TO, "SLICE_ELEMS", elems)
        p = {"w": p0.clone()}
        TO.adamw_update(T_OPT, p, g, TO.adamw_init(p))
        out.append(p["w"])
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], p0)


# --------------------------------------------------------------------------- #
# The train step
# --------------------------------------------------------------------------- #
def test_one_train_step_matches_reference():
    jstate = JT.train_state_init(jax.random.key(0), JCFG)
    state = _port_state(jstate)
    batch = _np_batches(1)[0]
    js2, jm = jax.jit(JT.make_train_step(JCFG, J_OPT))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ts2, tm = TT.make_train_step(TCFG, T_OPT)(
        state, TT.device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for w, g in zip(jax.tree.leaves(js2.params), leaves(ts2.params)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-3)
    assert int(ts2.opt["step"]) == 1


def test_loss_decreases_over_30_steps():
    state = TT.train_state_init(TCFG, seed=0, device="cpu")
    step = TT.make_train_step(TCFG, T_OPT)
    losses = []
    for batch in _np_batches(30):
        state, m = step(state, TT.device_batch(batch, "cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])
    assert all(np.isfinite(losses))


def test_microbatched_step_matches_full_batch_and_reference():
    """n_micro=4 (bf16 accumulator) tracks n_micro=1 as in the reference,
    and its loss, grad_norm and first moments equal the reference's
    n_micro=4 step's. After one step mu is (1-b1)·clip·g_acc, so mu holds
    the accumulated gradient itself; each leaf within two bf16 steps of its
    largest element (2^-7·max|mu|: the micro-batches' float32 gradients
    differ by rounding, and a bf16 add can round the other way)."""
    jstate = JT.train_state_init(jax.random.key(0), JCFG)
    batch = _np_batches(1, bs=8)[0]
    tb = TT.device_batch(batch, "cpu")
    s1, m1 = TT.make_train_step(TCFG, T_OPT)(_port_state(jstate), tb)
    s4, m4 = TT.make_train_step(TCFG, T_OPT, n_micro=4)(_port_state(jstate),
                                                         tb)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-2)
    for a, b in zip(leaves(s1.params), leaves(s4.params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-3)
    js4, jm4 = jax.jit(JT.make_train_step(JCFG, J_OPT, n_micro=4))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m4["loss"]), float(jm4["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m4["grad_norm"]),
                               float(jm4["grad_norm"]), rtol=1e-5)
    for w, g in zip(jax.tree.leaves(js4.opt["mu"]), leaves(s4.opt["mu"])):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=2.0 ** -7 * np.abs(w).max())


def test_microbatch_accumulator_is_bfloat16(monkeypatch):
    """AdamW receives bf16 gradients from an accumulated step, whatever
    the parameter dtype."""
    seen = []
    real = TT.adamw_update

    def spy(cfg, params, grads, state):
        seen.extend(g.dtype for g in leaves(grads))
        return real(cfg, params, grads, state)
    monkeypatch.setattr(TT, "adamw_update", spy)
    state = TT.train_state_init(TCFG, seed=0, device="cpu")
    TT.make_train_step(TCFG, T_OPT, n_micro=2)(
        state, TT.device_batch(_np_batches(1, bs=4)[0], "cpu"))
    assert seen and set(seen) == {torch.bfloat16}


def test_abstract_train_state_matches_real():
    real = TT.train_state_init(TCFG, seed=0, device="cpu")
    abstract = TT.abstract_train_state(TCFG)
    got = leaves_with_paths(abstract)
    want = leaves_with_paths(real)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, r) in zip(got, want):
        assert a.device.type == "meta"
        assert a.shape == r.shape and a.dtype == r.dtype


# --------------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", ["dense", "vlm", "encdec"])
def test_synthetic_tokens_bit_identical_to_reference(family):
    jcfg = TINY_FAMILIES[family]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    dc = dict(batch_size=3, seq_len=17, seed=5)
    j = iter(JD.SyntheticTokens(jcfg, JD.DataConfig(**dc)))
    t = iter(TD.SyntheticTokens(tcfg, TD.DataConfig(**dc)))
    for _ in range(3):
        a, b = next(j), next(t)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ("frames" in b) == jcfg.is_enc_dec
    assert ("patches" in b) == (jcfg.frontend.kind == "vision")


def test_data_pipeline_determinism_and_learnability():
    a = list(zip(range(3), TD.SyntheticTokens(TCFG, TD.DataConfig(seed=3))))
    b = list(zip(range(3), TD.SyntheticTokens(TCFG, TD.DataConfig(seed=3))))
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["labels"], y["labels"])
    assert x["tokens"].max() < TCFG.vocab_size


# --------------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip_gc_and_meta(tmp_path):
    state = TT.train_state_init(TCFG, seed=0, device="cpu")
    mgr = TC.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state, meta={"step": s})
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    restored = mgr.restore(3, like=TT.abstract_train_state(TCFG),
                           device="cpu")
    assert isinstance(restored, TT.TrainState)
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert mgr.restore_meta(3) == {"step": 3}
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_async_writer_raises_at_wait(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path))

    def boom():
        raise OSError("disk full")
    mgr.writer.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_async_save_is_a_snapshot(tmp_path, dtype):
    """A step taken right after an async ``save`` (it updates the state in
    place) does not reach the files: the writer is held until the step
    has run, and the restored state is the state as it was at ``save``."""
    cfg = config_from_dict(dataclasses.asdict(tiny(
        "snap", num_layers=2, vocab_size=256, param_dtype=dtype,
        compute_dtype=dtype)))
    state = TT.train_state_init(cfg, seed=0, device="cpu")
    step = TT.make_train_step(cfg, T_OPT)
    batches = [TT.device_batch(b, "cpu") for b in _np_batches(2)]
    state, _ = step(state, batches[0])
    before = [t.clone() for t in leaves(state)]
    mgr = TC.CheckpointManager(str(tmp_path))
    gate = threading.Event()
    mgr.writer.submit(gate.wait)
    mgr.save(1, state)
    state, _ = step(state, batches[1])
    gate.set()
    mgr.wait()
    assert not all(torch.equal(a, b) for a, b in zip(before, leaves(state)))
    restored = mgr.restore(1, like=TT.abstract_train_state(cfg),
                           device="cpu")
    for a, b in zip(before, leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_resume_training_continues(tmp_path):
    state = TT.train_state_init(TCFG, seed=0, device="cpu")
    step = TT.make_train_step(TCFG, T_OPT)
    batches = [TT.device_batch(b, "cpu") for b in _np_batches(14)]
    for b in batches[:10]:
        state, _ = step(state, b)
    mgr = TC.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(10, state)
    fresh = mgr.restore(10, like=TT.abstract_train_state(TCFG), device="cpu")
    l_cont, l_restored = [], []
    for b in batches[10:]:
        state, m1 = step(state, b)
        fresh, m2 = step(fresh, b)
        l_cont.append(float(m1["loss"]))
        l_restored.append(float(m2["loss"]))
    np.testing.assert_allclose(l_cont, l_restored, rtol=1e-6)


def _both_saved(tmp_path, dtype):
    jcfg = tiny("ckpt", num_layers=2, vocab_size=64, param_dtype=dtype,
                compute_dtype=dtype, qk_norm=True)
    jstate = JT.train_state_init(jax.random.key(1), jcfg)
    state = _port_state(jstate)
    jd, td = tmp_path / "ref", tmp_path / "port"
    JC.CheckpointManager(str(jd), async_write=False).save(4, jstate,
                                                          meta={"a": 1})
    TC.CheckpointManager(str(td), async_write=False).save(4, state,
                                                          meta={"a": 1})
    return jcfg, jstate, state, jd, td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_files_equal_between_packages(tmp_path, dtype):
    """The same state gives the same manifest (paths, shapes, dtypes) and
    the same bytes in every leaf file from both packages (bf16 as |V2)."""
    _, jstate, _, jd, td = _both_saved(tmp_path, dtype)
    step_dir = "step_00000004"
    jm = json.loads((jd / step_dir / "MANIFEST.json").read_text())
    tm = json.loads((td / step_dir / "MANIFEST.json").read_text())
    assert jm == tm
    assert len(tm["leaves"]) == len(jax.tree.leaves(jstate))
    assert {e["dtype"] for e in tm["leaves"]} == {dtype, "float32", "int32"}
    for e in tm["leaves"]:
        assert (jd / step_dir / e["file"]).read_bytes() == \
            (td / step_dir / e["file"]).read_bytes(), e["path"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    jcfg, _, state, jd, _ = _both_saved(tmp_path, dtype)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    mgr = TC.CheckpointManager(str(jd), async_write=False)
    restored = mgr.restore(4, like=TT.abstract_train_state(tcfg),
                           device="cpu")
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert mgr.restore_meta(4) == {"a": 1}


def test_port_checkpoint_restores_in_reference(tmp_path):
    """float32: the reference restores the port's files bit for bit. (It
    cannot restore a bfloat16 leaf from its own files either: ``np.load``
    gives ``|V2``, which ``jnp.asarray`` cannot cast; the bf16 files are
    held byte-equal above.)"""
    jcfg, jstate, _, _, td = _both_saved(tmp_path, "float32")
    restored = JC.CheckpointManager(str(td), async_write=False).restore(
        4, like=jax.eval_shape(lambda: jstate))
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# Compression
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.5, 1e3])
def test_quantize_dequantize_bit_identical(scale):
    x = np.random.default_rng(0).normal(size=(257,)).astype(np.float32) \
        * np.float32(scale)
    jq, js = JZ.quantize_int8(jnp.asarray(x))
    tq, ts = TZ.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TZ.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JZ.dequantize_int8(jq, js)))


def test_error_feedback_50_iterations_bit_identical():
    rng = np.random.default_rng(5)
    jr, tr = jnp.zeros(32), torch.zeros(32)
    true_sum = np.zeros(32, np.float32)
    ef_sum = np.zeros(32, np.float32)
    for _ in range(50):
        g = rng.normal(size=32).astype(np.float32)
        true_sum += g
        jq, js, jr = JZ.error_feedback_compress(jnp.asarray(g), jr)
        tq, ts, tr = TZ.error_feedback_compress(torch.from_numpy(g), tr)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        ef_sum += TZ.dequantize_int8(tq, ts).numpy()
    assert np.abs(ef_sum + tr.numpy() - true_sum).max() < 1e-3


@given(scale=st.floats(1e-3, 1e3))
def test_int8_quantize_bound(scale):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64,))
                         .astype(np.float32)) * scale
    q, s = TZ.quantize_int8(x)
    err = (TZ.dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5001 + 1e-9


@pytest.fixture
def gloo(tmp_path):
    """A world-size-1 gloo group (a file store under ``tmp_path``)."""
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                             world_size=1, rank=0)
    try:
        yield tdist.group.WORLD
    finally:
        tdist.destroy_process_group()


def _ref_psum(fn, x):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("pod", "data"))
    f = jax.shard_map(fn, mesh=mesh, in_specs=P("pod"), out_specs=P("pod"))
    return np.asarray(f(jnp.asarray(x[None])))[0]


@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_compressed_and_hierarchical_psum_match_reference(gloo, wire):
    x = np.random.default_rng(6).normal(size=(96,)).astype(np.float32)
    tx = torch.from_numpy(x)
    got = TZ.compressed_psum(tx, gloo, wire)
    want = _ref_psum(lambda v: JZ.compressed_psum(v, "pod", wire), x)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got_h = TZ.hierarchical_psum(tx, gloo, gloo, wire)
    want_h = _ref_psum(lambda v: JZ.hierarchical_psum(v, "data", "pod",
                                                      wire), x)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    assert torch.equal(tx, torch.from_numpy(x))       # input untouched
    with pytest.raises(ValueError, match="unknown wire"):
        TZ.compressed_psum(tx, gloo, "fp4")
