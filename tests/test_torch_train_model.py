"""The port's training entry points (``train_forward``, ``loss_fn``) against
the JAX package's on the CPU for every tiny family, with parameters from
the reference's ``init_params`` carried across through numpy, and against
``jax.value_and_grad`` of the reference's ``loss_fn`` for the gradients.

Tolerances: logits within rtol 1e-5 (atol 1e-5 for logits near zero), the
loss within rtol 1e-5, each leaf's gradient within atol 1e-5 + rtol 1e-4
(every family, SSD's float32 scan included); remat changes nothing (rtol
1e-6, the reference's bound). Also: a batch's ``lengths`` padding (positions
-1, masked keys), negative labels, the VLM's -1 label prefix, enc-dec
``frame_lengths`` on the encoder's keys and the cross-attention memory,
the Switch auxiliary loss, ``abstract_params``, and one train step of
every family."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.base import config_from_dict
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import optim as TO
from repro_torch.training import train_step as TT
from repro_torch.training.tree import leaves, leaves_with_paths

from conftest import TINY_FAMILIES

FAMILIES = sorted(TINY_FAMILIES)


def _np_batch(cfg, seed=0, b=2, s=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if cfg.is_enc_dec:
        batch["frames"] = rng.normal(size=(b, 10, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.frontend.kind == "vision":
        batch["patches"] = rng.normal(
            size=(b, cfg.frontend.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _ref(jcfg, jp, batch):
    """The reference's (loss, grads, logits), jitted."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def run(p, b):
        loss, grads = jax.value_and_grad(
            lambda q: JM.loss_fn(q, jcfg, b, remat=False))(p)
        return loss, grads, JM.train_forward(p, jcfg, b, remat=False)
    return run(jp, jb)


def _port(tcfg, tp, batch, remat=False):
    """The port's (loss, grads as a list in tree order, logits)."""
    tb = TT.device_batch(batch, "cpu")
    loss, grads = TT.loss_and_grads(tcfg, tp, tb, remat=remat)
    with torch.no_grad():
        logits = TM.train_forward(tp, tcfg, tb, remat=remat)
    return loss, leaves(grads), logits


def _check(ref, port, jp):
    (jl, jg, jlog), (tl, tg, tlog) = ref, port
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert len(paths) == len(tg) == len(jax.tree.leaves(jg))
    for path, w, g in zip(paths, jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=path)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    jcfg = TINY_FAMILIES[request.param]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _np_batch(jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, batch=batch,
                ref=_ref(jcfg, jp, batch),
                port=_port(tcfg, tp, batch, remat=True))


def test_logits_loss_and_gradients_match_reference(fam):
    tcfg, batch = fam["tcfg"], fam["batch"]
    _, _, tlog = fam["port"]
    s = batch["tokens"].shape[1] + (tcfg.frontend.num_patches
                                    if tcfg.frontend.kind == "vision" else 0)
    assert tlog.shape == (2, s, tcfg.vocab_size)
    _check(fam["ref"], fam["port"], fam["jp"])


def test_chunked_loss_matches_reference(fam, monkeypatch):
    """The float32 log-softmax taken in chunks of 3 rows under checkpoint
    (``model._nll_sum`` at a ``LOSS_CHUNK_ELEMS`` of 3 rows; a last chunk
    shorter): the same loss, gradients and logits as the reference's."""
    monkeypatch.setattr(TM, "LOSS_CHUNK_ELEMS", 3 * fam["tcfg"].vocab_size)
    _check(fam["ref"], _port(fam["tcfg"], fam["tp"], fam["batch"],
                             remat=True), fam["jp"])


def test_leaf_paths_are_the_reference_order(fam):
    """The port's tree flattens in ``jax.tree_util``'s order, path for path
    (``keystr``), so gradients and checkpoint leaves line up."""
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(fam["jp"])[0]]
    assert [p for p, _ in leaves_with_paths(fam["tp"])] == want


def test_remat_gives_the_same_loss_and_gradients(fam):
    tl, tg, _ = fam["port"]                  # remat=True
    l0, g0, _ = _port(fam["tcfg"], fam["tp"], fam["batch"], remat=False)
    np.testing.assert_allclose(float(tl), float(l0), rtol=1e-6)
    for a, b in zip(tg, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-12)


def test_every_leaf_gets_a_gradient(fam):
    """No leaf is left out of the graph: each gradient is finite and some
    element of it is nonzero (the attention projections and qk-norms
    included)."""
    _, tg, _ = fam["port"]
    for (path, _), g in zip(leaves_with_paths(fam["tp"]), tg):
        assert torch.isfinite(g).all() and g.abs().max() > 0, path


def test_abstract_params_match_real(fam):
    got = leaves_with_paths(TM.abstract_params(fam["tcfg"]))
    want = leaves_with_paths(fam["tp"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, r) in zip(got, want):
        assert a.device.type == "meta"
        assert a.shape == r.shape and a.dtype == r.dtype


def test_one_train_step_per_family(fam):
    """make_train_step trains every family: a finite loss, and every
    parameter leaf moves."""
    params = params_from_numpy(jax.tree.map(np.asarray, fam["jp"]), "cpu")
    state = TT.TrainState(params=params, opt=TO.adamw_init(params))
    before = [p.clone() for p in leaves(state.params)]
    step = TT.make_train_step(fam["tcfg"], TO.AdamWConfig(
        lr=1e-3, warmup_steps=0))
    state, m = step(state, TT.device_batch(fam["batch"], "cpu"))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for (path, p), b in zip(leaves_with_paths(state.params), before):
        assert not torch.equal(p, b), path


@pytest.mark.parametrize("family", ["dense-bias-qknorm", "sliding", "mla",
                                    "vlm"])
def test_lengths_padding_matches_reference(family):
    """A batch with per-sequence lengths: positions past a length are -1
    and its keys are masked (the VLM's lengths count its patches); the
    padding's labels are -1."""
    jcfg = TINY_FAMILIES[family]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _np_batch(jcfg, seed=3)
    batch["lengths"] = np.array([12, 7], np.int32)
    batch["labels"][1, 7:] = -1
    _check(_ref(jcfg, jp, batch), _port(tcfg, tp, batch), jp)


def test_encdec_frame_lengths_match_reference():
    """Frames past a sequence's ``frame_lengths`` are masked as the
    encoder's keys and as the decoder's cross-attention memory."""
    jcfg = TINY_FAMILIES["encdec"]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(2), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _np_batch(jcfg, seed=4)
    batch["frame_lengths"] = np.array([10, 6], np.int32)
    port = _port(tcfg, tp, batch)
    _check(_ref(jcfg, jp, batch), port, jp)
    del batch["frame_lengths"]
    assert not np.isclose(float(port[0]), float(_port(tcfg, tp, batch)[0]))


def test_loss_ignores_negative_labels():
    """Mirror of the reference's test: labels of -1 leave the loss, which
    equals the mean NLL over the remaining positions and the reference's
    masked loss."""
    jcfg = TINY_FAMILIES["dense"]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    full = _np_batch(jcfg, seed=5)
    masked = dict(full, labels=full["labels"].copy())
    masked["labels"][:, 8:] = -1
    with torch.no_grad():
        l_full = float(TM.loss_fn(tp, tcfg, TT.device_batch(full, "cpu")))
        l_mask = float(TM.loss_fn(tp, tcfg, TT.device_batch(masked, "cpu")))
        lp = torch.log_softmax(TM.train_forward(
            tp, tcfg, TT.device_batch(masked, "cpu")).float(), dim=-1)
    assert l_full != pytest.approx(l_mask)
    nll = -np.take_along_axis(lp[:, :8].numpy(),
                              full["labels"][:, :8, None], axis=-1).mean()
    np.testing.assert_allclose(l_mask, nll, rtol=1e-5)
    want = JM.loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in masked.items()},
                      remat=False)
    np.testing.assert_allclose(l_mask, float(want), rtol=1e-5)


def test_vlm_patch_positions_take_no_loss():
    """The VLM's loss runs over the text positions only: -1 labels stand in
    front for the patches."""
    cfg = config_from_dict(dataclasses.asdict(TINY_FAMILIES["vlm"]))
    tp = TM.init_params(cfg, seed=0, device="cpu")
    batch = TT.device_batch(_np_batch(cfg, seed=6), "cpu")
    n = cfg.frontend.num_patches
    with torch.no_grad():
        loss = float(TM.loss_fn(tp, cfg, batch))
        lp = torch.log_softmax(TM.train_forward(tp, cfg, batch).float(), -1)
    text = lp[:, n:]
    nll = -torch.gather(text, -1, batch["labels"].long()[..., None]).mean()
    np.testing.assert_allclose(loss, float(nll), rtol=1e-6)


def test_moe_load_balance_loss_matches_reference():
    jcfg = TINY_FAMILIES["moe"]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(0), jcfg)
    router = np.array(jp["groups"][1][0]["mlp"]["router"][0])
    x = np.random.default_rng(7).normal(size=(2, 9, jcfg.d_model)
                                        ).astype(np.float32)
    want = JL.moe_load_balance_loss({"router": jnp.asarray(router)}, jcfg,
                                    jnp.asarray(x))
    got = TL.moe_load_balance_loss({"router": torch.from_numpy(router)},
                                   tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
