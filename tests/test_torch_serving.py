"""The port's disaggregated serving path against the JAX package's.

* End to end: the quickstart's heterogeneous pair (P nhbd / block 8 /
  TP 2 → D nbhd / block 4 / TP 1) behind GlobalScheduler, streamed in
  misaligned 7-token chunks or handed off monolithically, over raw-f32,
  raw-bf16 and int8 wires: the generated tokens equal the JAX
  scheduler's on the same parameters and requests.
* The handoff itself: fed the same KV, both pipelines leave bit-identical
  D pools, for every D layout and wire, streamed (read-merge-write of
  partial pages) and monolithic (zero-filled page tails).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.core.compat.precision import WireFormat as JWire
from repro.core.disagg import DisaggPipeline as JPipe
from repro.core.kv_transfer import TransferEngine as JTransfer
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat as TWire
from repro_torch.core.disagg import DisaggPipeline as TPipe
from repro_torch.core.kv_transfer import TransferEngine as TTransfer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import VendorProfile as TVendor
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.scheduler import GlobalScheduler as TSched
from repro_torch.serving.server import Server as TServer

QUICKSTART = JCfg(name="tiny", family="dense", num_layers=3, d_model=64,
                  num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=256, param_dtype="float32",
                  compute_dtype="float32")
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
PROMPTS = (11, 16, 23)
MAX_NEW = 6


@pytest.fixture(scope="module")
def engines():
    """One P/D pair per package, reused across cases: the reference's
    engines compile per shape, and every case leaves them idle again."""
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(0),
                                                   QUICKSTART)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = config_from_dict(dataclasses.asdict(QUICKSTART))
    kw = dict(num_blocks=64, max_batch=4, max_seq_len=64)
    return ((JEngine("P0", QUICKSTART, jp, JVendor("vB", **P_VENDOR),
                     role="prefill", **kw),
             JEngine("D0", QUICKSTART, jp, JVendor("vA", **D_VENDOR),
                     role="decode", **kw)),
            (TEngine("P0", tcfg, tp, TVendor("vB", **P_VENDOR),
                     role="prefill", device="cpu", **kw),
             TEngine("D0", tcfg, tp, TVendor("vA", **D_VENDOR),
                     role="decode", device="cpu", **kw)))


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, QUICKSTART.vocab_size, n).astype(np.int32)
            for n in PROMPTS]


def _serve_jax(p, d, wire, chunk):
    sched = JSched(JPipe(JTransfer(), JWire(*wire)), prefill_chunk=chunk)
    sched.add_instance(p)
    sched.add_instance(d)
    reqs = [JRequest(f"r{i}", pr, MAX_NEW) for i, pr in enumerate(_prompts())]
    sched.run(reqs)
    return [r.output_tokens for r in reqs]


def _serve_torch(p, d, wire, chunk):
    pipe = TPipe(TTransfer(), TWire(*wire))
    sched = TSched(pipe, prefill_chunk=chunk, device="cpu")
    sched.add_instance(p)
    sched.add_instance(d)
    reqs = [TRequest(f"r{i}", pr, MAX_NEW) for i, pr in enumerate(_prompts())]
    result = TServer(sched).serve(reqs)
    assert result.summary()["requests"] == len(PROMPTS)
    assert pipe.transfer.stats.bytes_moved > 0
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("wire,chunk", [(("raw", "float32"), 7),
                                        (("raw", "bfloat16"), 7),
                                        (("int8", "bfloat16"), 7),
                                        (("raw", "float32"), None)])
def test_tokens_identical_to_reference_scheduler(engines, wire, chunk):
    (jp, jd), (tp, td) = engines
    want = _serve_jax(jp, jd, wire, chunk)
    got = _serve_torch(tp, td, wire, chunk)
    assert all(len(t) == MAX_NEW for t in got)
    assert got == want


# --------------------------------------------------------------------------- #
# the handoff on identical KV: bit-identical D pools
# --------------------------------------------------------------------------- #
HCFG = dataclasses.replace(QUICKSTART, num_kv_heads=4)
SEQ = 23


def _engines(layout, kv_dtype):
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(1), HCFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = config_from_dict(dataclasses.asdict(HCFG))
    pv = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
    dv = dict(block_size=4, layout=layout, kv_dtype=kv_dtype, tp=1)
    kw = dict(num_blocks=24, max_batch=2, max_seq_len=40)
    return ((JEngine("P", HCFG, jp, JVendor("p", **pv), role="prefill", **kw),
             JEngine("D", HCFG, jp, JVendor("d", **dv), role="decode", **kw)),
            (TEngine("P", tcfg, tp, TVendor("p", **pv), role="prefill",
                     device="cpu", **kw),
             TEngine("D", tcfg, tp, TVendor("d", **dv), role="decode",
                     device="cpu", **kw)))


def _kv():
    rng = np.random.default_rng(4)
    shape = (HCFG.num_layers, SEQ, HCFG.num_kv_heads, HCFG.hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _as_torch(ent):
    return {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for n, a in ent.items()}


def _stream(pipe, req, p, d, k, v, chunk):
    h = pipe.begin_handoff(req, p, d, SEQ)
    for c0 in range(0, SEQ, chunk):
        c1 = min(c0 + chunk, SEQ)
        ent = {"k": k[:, c0:c1], "v": v[:, c0:c1], "start": c0}
        if isinstance(pipe, TPipe):
            ent = _as_torch(ent)
        h.send_chunk({"kv": [("kv", 0, 0, ent)], "start": c0,
                      "length": c1 - c0})
        h.poll_reads()
    h.finalize(1, {"states": [], "cross": []})


def _monolithic(pipe, req, p, d, k, v):
    ent = {"k": k, "v": v}
    if isinstance(pipe, TPipe):
        ent = _as_torch(ent)
    package = {"kv": [("kv", 0, 0, ent)], "states": [], "cross": [],
               "first_token": 1, "seq_len": SEQ}
    p.prefill = lambda _req: package           # the same KV on both sides
    pipe.handoff(req, p, d)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("layout,wire,mode,kv_dtype", [
    *[(lay, w, "stream", "float32") for lay in ("nbhd", "nhbd", "nhdb")
      for w in (("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16"))],
    *[(lay, ("raw", "float32"), "monolithic", "float32")
      for lay in ("nbhd", "nhbd", "nhdb")],
    ("nhdb", ("int8", "bfloat16"), "monolithic", "float32"),
    ("nhbd", ("raw", "bfloat16"), "stream", "bfloat16"),
])
def test_d_pools_bit_identical_after_handoff(layout, wire, mode, kv_dtype):
    (jp_, jd), (tp_, td) = _engines(layout, kv_dtype)
    k, v = _kv()
    jpipe, tpipe = JPipe(JTransfer(), JWire(*wire)), TPipe(TTransfer(),
                                                            TWire(*wire))
    for pipe, p, d, req_cls in ((jpipe, jp_, jd, JRequest),
                                (tpipe, tp_, td, TRequest)):
        # a first request occupies blocks, so the handoff lands elsewhere
        d.reserve_sequence(req_cls("other", np.zeros(5, np.int32), 3), 5)
        req = req_cls("r", np.zeros(SEQ, np.int32), 4)
        if mode == "stream":
            _stream(pipe, req, p, d, k, v, chunk=7)
        else:
            _monolithic(pipe, req, p, d, k, v)
    for name in ("k_pool", "v_pool"):
        want = _bits(np.asarray(jd.caches[0][0][name]))
        got = td.caches[0][0][name]
        got = got.view(torch.uint16).numpy() if got.dtype == torch.bfloat16 \
            else _bits(got.numpy())
        assert np.array_equal(got, want), name
    assert td.slot_ready == jd.slot_ready
    assert list(td.seq_lens) == list(jd.seq_lens)


def test_d_failure_requeues_and_finishes_with_the_same_tokens(engines):
    """A D instance that dies mid-decode loses its KV; the scheduler
    re-prefills each of its requests with the generated prefix appended,
    and greedy decoding continues where it stopped."""
    (_, _), (tp, td) = engines
    want = _serve_torch(tp, td, ("raw", "float32"), 7)
    pipe = TPipe(TTransfer(), TWire("raw", "float32"))
    sched = TSched(pipe, prefill_chunk=7, device="cpu")
    sched.add_instance(tp)
    sched.add_instance(td)
    reqs = [TRequest(f"f{i}", pr, MAX_NEW) for i, pr in enumerate(_prompts())]
    for r in reqs:
        sched.submit(r)
    while not any(len(r.output_tokens) >= 3 for r in reqs):
        sched.step()
    td.fail()
    for _ in range(500):
        if sched.stats.finished == len(reqs):
            break
        sched.step()
    assert sched.stats.requeues > 0 and pipe.transfer.stats.retries > 0
    assert [r.output_tokens for r in reqs] == want
