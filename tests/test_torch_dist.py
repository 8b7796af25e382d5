"""The port's distribution context and the model code that reads it,
against the JAX package's, on the CPU in float32.

  * ``models/dist.py``: ``DistContext``'s fields and defaults equal the
    reference's; ``use`` restores the previous context on exit.
  * ``chunked_sdpa`` and ``_chunked_mla_sdpa`` equal the reference's within
    atol 2e-5 over windows {0, 8}, chunks {4, 8, 16}, causal and not, key
    positions padded past a length, ``attn_p_bf16`` on and off, and a row
    with no valid key (on both sides the mean of V — rounded to bf16 under
    ``attn_p_bf16`` — over the key axis padded to whole chunks).
  * ``attention_block`` and ``mla_block`` on the plain route under
    ``dist.use(DistContext(chunk_kv=16, chunk_size=8))`` equal the
    reference's under the same context (atol 2e-5), with and without
    ``lengths``.
  * ``_moe_mlp_capacity`` equals the reference's at capacity factors
    {1.0, 1.25, 8.0}: the same group sizes and dropped pairs, outputs
    within atol 1e-6; ``moe_mlp`` under a one-card mesh context equals the
    reference's shard_map route on an Auto-typed 1x1 mesh (atol 1e-6).
  * ``device.resolve`` takes "meta" when asked for by name and never
    defaults to it; ``ops`` sends a meta tensor to the plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.models import dist as JD
from repro.models import layers as JL
from repro_torch import device as tdev
from repro_torch.configs.base import config_from_dict
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import dist as TD
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy

from conftest import TINY_FAMILIES

ATOL = 2e-5
MOE_ATOL = 1e-6


def _cfgs(name):
    jcfg = TINY_FAMILIES[name]
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _across(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# --------------------------------------------------------------------- #
# the context
# --------------------------------------------------------------------- #
def test_dist_context_fields_and_defaults_equal_reference():
    want = [(f.name, f.default) for f in dataclasses.fields(JD.DistContext)]
    got = [(f.name, f.default) for f in dataclasses.fields(TD.DistContext)]
    assert got == want
    assert TD.ctx() == TD.DistContext()


def test_use_restores_the_previous_context():
    outer = TD.DistContext(chunk_kv=16)
    inner = TD.DistContext(chunk_kv=32, attn_p_bf16=True)
    with TD.use(outer):
        with pytest.raises(KeyError):
            with TD.use(inner) as c:
                assert TD.ctx() is c is inner
                raise KeyError
        assert TD.ctx() is outer
    assert TD.ctx() == TD.DistContext()


# --------------------------------------------------------------------- #
# chunked attention
# --------------------------------------------------------------------- #
def _kpos(kind, pos):
    """Key positions: all valid, padded past lengths (7, 13), or a second
    sequence with none valid."""
    if kind == "full":
        return pos
    lengths = np.array([13, 7 if kind == "padded" else 0])
    return np.where(np.arange(pos.shape[1])[None] < lengths[:, None], pos,
                    -1).astype(np.int32)


@pytest.mark.parametrize("p_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("window", [0, 8])
def test_chunked_sdpa_matches_reference(window, chunk, causal, p_bf16):
    rng = np.random.default_rng(window * 100 + chunk)
    b, s, h, kv, hd = 2, 13, 4, 2, 8
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    for kind in ("full", "padded", "empty_row"):
        kpos = _kpos(kind, pos)
        kw = dict(causal=causal, window=window, chunk=chunk)
        with JD.use(JD.DistContext(attn_p_bf16=p_bf16)):
            want = JL.chunked_sdpa(*map(jnp.asarray, (q, k, v, pos, kpos)),
                                   **kw)
        with TD.use(TD.DistContext(attn_p_bf16=p_bf16)):
            got = TL.chunked_sdpa(*map(torch.from_numpy, (q, k, v, pos,
                                                          kpos)), **kw)
        _close(got, want)
        if kind == "empty_row":
            # no valid key: every column of every chunk weighs exp(0) = 1,
            # so the mean of V over the padded key axis (pad rows 0)
            padded = -(-s // chunk) * chunk
            vv = torch.from_numpy(v[1])
            vv = (vv.bfloat16().float() if p_bf16 else vv).numpy()
            mean = np.repeat(vv.sum(0) / padded, h // kv, axis=0)
            _close(got[1], np.broadcast_to(mean, (s, h, hd)))


@pytest.mark.parametrize("kind", ["full", "padded", "empty_row"])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_mla_sdpa_matches_reference(chunk, kind):
    rng = np.random.default_rng(chunk)
    b, s, h, dn, dr, dv = 2, 13, 4, 16, 8, 16
    qn, qp, kn, vv = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((b, s, h, dn), (b, s, h, dr),
                                    (b, s, h, dn), (b, s, h, dv)))
    kp = rng.standard_normal((b, s, dr)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kpos = _kpos(kind, pos)
    args = (qn, qp, kn, kp, vv, pos, kpos)
    want = JL._chunked_mla_sdpa(*map(jnp.asarray, args), scale=0.2,
                                chunk=chunk)
    got = TL._chunked_mla_sdpa(*map(torch.from_numpy, args), scale=0.2,
                               chunk=chunk)
    assert got.dtype == torch.float32
    _close(got, want)


def _block_case(name, s=20, seed=0):
    jcfg, tcfg = _cfgs(name)
    key = jax.random.key(seed)
    jp = (JL.init_mla if jcfg.attention_kind == "mla"
          else JL.init_attention)(key, jcfg)
    x = np.random.default_rng(seed).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    return jcfg, tcfg, jp, _across(jp), x, pos


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("name", ["dense-bias-qknorm", "sliding", "mla"])
def test_blocks_take_the_chunked_route_under_a_context(name, with_lengths):
    """S = 20 >= chunk_kv = 16: both packages take the chunked route (8
    keys a chunk); the output and the cache rows equal the reference's."""
    jcfg, tcfg, jp, tp, x, pos = _block_case(name)
    lengths = np.array([20, 11], np.int32) if with_lengths else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    ctx = dict(chunk_kv=16, chunk_size=8)
    if name == "mla":
        with JD.use(JD.DistContext(**ctx)):
            want, wrows = JL.mla_block(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(pos), jl)
        with TD.use(TD.DistContext(**ctx)):
            got, grows = TL.mla_block(tp, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos), tl)
    else:
        win = jcfg.sliding_window if jcfg.attention_kind == "sliding" else 0
        with JD.use(JD.DistContext(**ctx)):
            want, wrows = JL.attention_block(jp, jcfg, jnp.asarray(x),
                                             jnp.asarray(pos), lengths=jl,
                                             window=win)
        with TD.use(TD.DistContext(**ctx)):
            got, grows = TL.attention_block(tp, tcfg, torch.from_numpy(x),
                                            torch.from_numpy(pos),
                                            lengths=tl, window=win)
    _close(got, want)
    for g, w in zip(grows, wrows):
        _close(g, w)
    if lengths is not None:
        return      # rows with no valid key differ between the two routes
    # below chunk_kv the same call takes the plain masked route
    with TD.use(TD.DistContext(chunk_kv=64, chunk_size=8)):
        fn = TL.mla_block if name == "mla" else TL.attention_block
        kw = {} if name == "mla" else dict(
            window=tcfg.sliding_window if name == "sliding" else 0)
        plain, _ = fn(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                      **kw)
    _close(plain, want, atol=1e-4)


# --------------------------------------------------------------------- #
# the capacity MoE
# --------------------------------------------------------------------- #
def _moe_case(seed=0, s=13):
    jcfg, tcfg = _cfgs("moe")
    jp = JL.init_moe(jax.random.key(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, _across(jp), x


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_moe_capacity_matches_reference(cf):
    jcfg, tcfg, jp, tp, x = _moe_case()
    want = JL._moe_mlp_capacity(jp, jcfg, jnp.asarray(x),
                                capacity_factor=cf)
    got = TL._moe_mlp_capacity(tp, tcfg, torch.from_numpy(x),
                               capacity_factor=cf)
    _close(got, want, MOE_ATOL)
    # the same routing, so the same pairs dropped
    _, jidx = JL.moe_route(jp, jcfg, jnp.asarray(x.reshape(-1, 64)))
    _, tidx = TL.moe_route(tp, tcfg, torch.from_numpy(x.reshape(-1, 64)))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    sizes = np.bincount(np.asarray(jidx).reshape(-1), minlength=4)
    t = x.shape[0] * x.shape[1]
    cap = TL.moe_capacity(tcfg, t, cf)
    tk = t * jcfg.moe.top_k
    assert cap == min(tk, max(8, int(np.ceil(tk / 4 * cf / 8) * 8)))
    dropped = TL.moe_capacity_drops(sizes, cap)
    kept = sum(min(n, cap) if off <= tk - cap else n
               for n, off in zip(sizes, np.cumsum(sizes) - sizes))
    assert dropped == tk - kept
    assert (dropped > 0) == (cf == 1.0)      # this input drops at 1.0 only
    if dropped == 0:                         # nothing dropped: the exact MoE
        _close(got, TL.moe_mlp(tp, tcfg, torch.from_numpy(x)), 1e-5)


def test_moe_capacity_runs_on_meta():
    _, tcfg, _, tp, x = _moe_case()
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor)
                else {kk: vv.to("meta") for kk, vv in v.items()})
            for k, v in tp.items()}
    out = TL._moe_mlp_capacity(meta, tcfg,
                               torch.from_numpy(x).to("meta"))
    assert out.device.type == "meta" and out.shape == x.shape


def test_moe_mlp_under_one_card_mesh_matches_reference_shard_map():
    jcfg, tcfg, jp, tp, x = _moe_case(seed=1, s=11)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    with JD.use(JD.DistContext(mesh=jmesh, dp_axes=("data",),
                               model_axis="model", moe_shard_map=True)):
        want = jax.jit(lambda p, xx: JL.moe_mlp(p, jcfg, xx))(
            jp, jnp.asarray(x))
    tmesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    with TD.use(TD.DistContext(mesh=tmesh, dp_axes=("data",),
                               model_axis="model", moe_shard_map=True)):
        got = TL.moe_mlp(tp, tcfg, torch.from_numpy(x))
    _close(got, want, MOE_ATOL)
    # without a mesh the context keeps the exact route
    with TD.use(TD.DistContext(moe_shard_map=True)):
        exact = TL.moe_mlp(tp, tcfg, torch.from_numpy(x))
    _close(exact, JL.moe_mlp(jp, jcfg, jnp.asarray(x)), 1e-5)


def test_moe_over_more_than_one_device_raises():
    """Outside a world of ranks, on a model axis and on a data axis alike
    (a rank of a world routes its own rows: tests/test_torch_mesh_train.py)."""
    _, tcfg, _, tp, x = _moe_case()
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        with TD.use(TD.DistContext(mesh=mesh, dp_axes=("data",),
                                   model_axis="model", moe_shard_map=True)):
            with pytest.raises(NotImplementedError,
                               match="in a world of as many ranks"):
                TL.moe_mlp(tp, tcfg, torch.from_numpy(x))


def test_moe_dist_specs_equal_reference():
    jcfg, tcfg = _cfgs("moe")
    want = jax.tree.map(tuple, JL.moe_mlp_dist_specs(jcfg, "model"),
                        is_leaf=lambda s: isinstance(
                            s, jax.sharding.PartitionSpec))
    assert TL.moe_mlp_dist_specs(tcfg, "model") == want


# --------------------------------------------------------------------- #
# devices
# --------------------------------------------------------------------- #
def test_resolve_takes_meta_by_name_and_never_defaults_to_it():
    assert tdev.resolve("meta").type == "meta"
    assert tdev.resolve(torch.device("meta")).type == "meta"
    if torch.cuda.is_available():
        assert tdev.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdev.resolve(None)
    with pytest.raises(ValueError):
        tdev.resolve("mps")


def test_ops_send_meta_tensors_to_the_plain_version():
    ops.reset_launch_counts()
    q = torch.empty((1, 4, 5, 16), device="meta")
    k = torch.empty((1, 2, 9, 16), device="meta")
    out = ops.flash_attention(q, k, k, q_offset=4)
    assert out.device.type == "meta" and out.shape == (1, 4, 5, 16)
    assert sum(ops.launch_counts().values()) == 0
