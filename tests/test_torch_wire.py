"""The port's fixed-layout KV wire is byte-identical to the JAX package's,
and its TP shard realignment gives the same shards."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compat import parallel_align as JPA
from repro.core.compat.precision import WireFormat as JWire
from repro.core.transport.wirefmt import WireChunk as JChunk
from repro_torch.core.compat import parallel_align as TPA
from repro_torch.core.compat import precision as TP
from repro_torch.core.transport.wirefmt import WireChunk as TChunk

WIRES = [("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16")]


def _entries(seed, count=2, s=9, kv=4, hd=8, start=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((count, s, kv, hd)).astype(dtype)
    v = rng.standard_normal((count, s, kv, hd)).astype(dtype)
    return k, v, start


def _bytes(chunk) -> bytes:
    buf = bytearray(chunk.nbytes)
    chunk.write_into(buf)
    return bytes(buf)


@pytest.mark.parametrize("kind,dtype", WIRES)
@pytest.mark.parametrize("tp_p", [1, 2])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_segment_bytes_identical(kind, dtype, tp_p, src):
    k, v, start = _entries(tp_p)
    jk, jv = (jnp.asarray(a).astype(src) for a in (k, v))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, src)) for a in (k, v))
    jc = JChunk.from_entries(
        [("kv", 0, 0, {"k": np.asarray(jk), "v": np.asarray(jv),
                       "start": start}),
         ("kv", 1, 0, {"k": np.asarray(jv), "v": np.asarray(jk),
                       "start": start})],
        JWire(kind, dtype), tp_p, seq_len=9)
    tc = TChunk.from_entries(
        [("kv", 0, 0, {"k": tk, "v": tv, "start": start}),
         ("kv", 1, 0, {"k": tv, "v": tk, "start": start})],
        TP.WireFormat(kind, dtype), tp_p, seq_len=9)
    assert tc.nbytes == jc.nbytes and tc.payload_nbytes == jc.payload_nbytes
    assert _bytes(tc) == _bytes(jc)


@pytest.mark.parametrize("kind,dtype", WIRES)
def test_bound_chunk_round_trip(kind, dtype):
    """A segment parsed on the D side decodes back to the source KV (exact
    on a raw float32 wire, within the format's bound otherwise)."""
    k, v, start = _entries(3)
    wire = TP.WireFormat(kind, dtype)
    planned = TChunk.from_entries(
        [("kv", 0, 0, {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
                       "start": start})], wire, 2, seq_len=9)
    bound = TChunk.from_buffer(bytearray(_bytes(planned)))
    assert bound.wire == wire and bound.tp_p == 2 and bound.seq_len == 9
    (e,) = bound.entries()
    assert (e["start"], e["count"], e["seq"]) == (start, 2, 9)
    pay = TP.host_tensor(np.array(e["payload"]), e["dtype"])
    sc = None if e["scales"] is None else torch.from_numpy(
        np.array(e["scales"])).reshape(tuple(pay.shape[:-1]) + (1,))
    dec = TP.decode_wire(pay, sc, wire, torch.float32)
    k_back = torch.cat(list(dec[:2]), dim=2)       # shards → all heads
    tol = TP.cast_error_bound(torch.float32, wire) * 4
    np.testing.assert_allclose(k_back.numpy(), k, atol=tol, rtol=tol)
    bound.release()


@pytest.mark.parametrize("kv_heads,tp_p,tp_d", [(8, 2, 1), (8, 1, 2),
                                                (8, 4, 2), (8, 2, 4),
                                                (4, 4, 1)])
def test_realign_shards_same_as_reference(kv_heads, tp_p, tp_d):
    assert TPA.plan_realign(kv_heads, tp_p, tp_d) == [
        TPA.ShardPlan(p.d_rank, p.reads)
        for p in JPA.plan_realign(kv_heads, tp_p, tp_d)]
    rng = np.random.default_rng(kv_heads + tp_p)
    shards = [rng.standard_normal((5, kv_heads // tp_p, 3)).astype(np.float32)
              for _ in range(tp_p)]
    want = JPA.realign_shards([jnp.asarray(s) for s in shards], tp_d)
    got = TPA.realign_shards([torch.from_numpy(s) for s in shards], tp_d)
    assert len(got) == len(want) == tp_d
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind,dtype", WIRES)
def test_encode_wire_same_as_reference(kind, dtype):
    from repro.core.compat import precision as JP
    x = np.random.default_rng(0).standard_normal((6, 2, 8)).astype(np.float32)
    x[1] = 0.0                                      # an all-zero row
    jp, js = JP.encode_wire(jnp.asarray(x), JWire(kind, dtype))
    tp, ts = TP.encode_wire(torch.from_numpy(x), TP.WireFormat(kind, dtype))
    np.testing.assert_array_equal(tp.float().numpy(),
                                  np.asarray(jp, np.float32))
    if js is not None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert TP.WireFormat(kind, dtype).bytes_per_element() == \
        JWire(kind, dtype).bytes_per_element()
