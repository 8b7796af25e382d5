"""Fixed-layout KV wire format — PyTorch port of
``repro.core.transport.wirefmt`` (fixed codec only).

The segment itself is the wire representation, byte for byte the JAX
package's layout:

    prelude  magic · version · wire kind/dtype · tp_p · n_entries
             · seq_len · payload_bytes · total_bytes
    entry records  kind · gi · pi · start · count · seq · parts
      part records  dtype · shape · payload_off · scales_off
    slab 0  contiguous KV payload (64-byte aligned), shard-major
            (2·tp_p, count, S, kv/tp_p, hd)
    slab 0' fp32 scales (int8 wire only)
    …

An ``"mla"`` entry (the latent cache, replicated across TP ranks, so
only rank 0's copy ships) has two parts, ``ckv`` then ``kpe``, each a
slab of (count·S, 1, dim) rows with its own scales under int8.

A *planned* chunk (P side) holds the source KV tensors, which may live on
the card; ``write_into(buf)`` casts or quantizes them in torch and copies
them device→host straight into the buffer through typed views. A *bound*
chunk (D side, ``from_buffer``) parses the header; ``entries()`` gives
numpy views over the slabs (bfloat16 slabs as uint16 bits). The wire
stays in host memory, as in the reference.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.compat import precision
from repro_torch.core.compat.precision import WireFormat

MAGIC = b"RKVWIRE1"
VERSION = 1
_ALIGN = 64
_NO_SCALES = 0xFFFFFFFFFFFFFFFF

# magic(8) version(H) wire_kind(B) wire_dtype(B) tp_p(H) n_entries(H)
# seq_len(I) payload_bytes(Q) total_bytes(Q)
_PRELUDE = struct.Struct("<8sHBBHHIQQ")
# kind(B) n_parts(B) gi(H) pi(H) start(I) count(I) seq(I)
_ENTRY = struct.Struct("<BBHHIII")
# dtype(B) ndim(B) shape[5](I) payload_off(Q) scales_off(Q)
_PART = struct.Struct("<BB5IQQ")

_WIRE_KINDS = ("raw", "int8")
_ENTRY_KINDS = ("kv", "mla")
_DTYPES = ("float32", "bfloat16", "float16", "int8")


def _align(off: int) -> int:
    return (off + _ALIGN - 1) // _ALIGN * _ALIGN


def nominal_header_bytes(n_entries: int = 1, parts_per_entry: int = 1) -> int:
    """Planner-facing estimate of the fixed per-chunk wire overhead."""
    return _align(_PRELUDE.size
                  + n_entries * (_ENTRY.size + parts_per_entry * _PART.size))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Part:
    __slots__ = ("name", "shape", "payload_off", "scales_off")

    def __init__(self, name: str, shape: Tuple[int, ...], payload_off: int,
                 scales_off: int):
        assert name in _DTYPES, name
        self.name = name
        self.shape = shape
        self.payload_off = payload_off
        self.scales_off = scales_off

    @property
    def storage(self) -> np.dtype:
        return precision.storage_dtype(self.name)

    @property
    def payload_nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.storage.itemsize

    @property
    def scales_count(self) -> int:
        # one fp32 scale per (token, head) row: payload elems / last axis
        return int(np.prod(self.shape)) // self.shape[-1]


class _Entry:
    __slots__ = ("kind", "gi", "pi", "start", "count", "seq", "parts", "src")

    def __init__(self, kind: str, gi: int, pi: int, start: int, count: int,
                 seq: int, parts: List[_Part],
                 src: Optional[Dict[str, torch.Tensor]] = None):
        self.kind = kind
        self.gi = gi
        self.pi = pi
        self.start = start
        self.count = count
        self.seq = seq
        self.parts = parts
        self.src = src                      # planned state only


class WireChunk:
    """One staged KV chunk in the fixed wire layout."""

    def __init__(self, wire: WireFormat, tp_p: int, seq_len: int,
                 entries: List[_Entry], header: bytes, payload_bytes: int,
                 total_bytes: int, buf: Optional[memoryview] = None):
        self.wire = wire
        self.tp_p = tp_p
        self.seq_len = seq_len
        self._entries = entries
        self._header = header
        self._payload_bytes = payload_bytes
        self._total_bytes = total_bytes
        self._buf = buf                     # bound state: backing buffer
        self._local: Optional[bytearray] = None   # planned, read in-process

    # -- construction: planned (P side) -------------------------------- #
    @classmethod
    def from_entries(cls, chunk_entries: Sequence[Tuple[str, int, int,
                                                        Dict[str, Any]]],
                     wire: WireFormat, tp_p: int,
                     seq_len: int = 0) -> "WireChunk":
        """Normalized chunk entries ``(kind, gi, pi, ent)`` → planned
        chunk: ``"kv"`` entries carry ``k``/``v`` tensors of (count, S,
        kv_heads, hd), ``"mla"`` entries ``ckv``/``kpe`` of (count, S,
        dim). The slab plan is computed here; no KV bytes move until
        ``write_into``."""
        pname = precision.payload_name(wire)
        int8 = wire.kind == "int8"
        entries: List[_Entry] = []
        payload_bytes = 0
        n_parts = sum(2 if kind == "mla" else 1
                      for kind, _gi, _pi, _ent in chunk_entries)
        off = _align(_PRELUDE.size + len(chunk_entries) * _ENTRY.size
                     + n_parts * _PART.size)

        def plan(shape) -> _Part:
            nonlocal off
            p = _Part(pname, shape, off, _NO_SCALES)
            off = _align(off + p.payload_nbytes)
            if int8:
                p.scales_off = off
                off = _align(off + p.scales_count * 4)
            return p

        for kind, gi, pi, ent in chunk_entries:
            if kind == "mla":
                ckv, kpe = ent["ckv"], ent["kpe"]
                count, s = ckv.shape[0], ckv.shape[1]
                payload_bytes += _nbytes(ckv) + _nbytes(kpe)
                parts = [plan((count * s, 1, t.shape[-1])) for t in (ckv, kpe)]
                entries.append(_Entry("mla", gi, pi, ent["start"], count, s,
                                      parts, {"ckv": ckv, "kpe": kpe}))
                continue
            if kind != "kv":
                raise NotImplementedError(f"wire entry kind {kind!r}")
            k, v = ent["k"], ent["v"]
            count, s, kv_heads, hd = k.shape
            assert kv_heads % tp_p == 0, (kv_heads, tp_p)
            payload_bytes += _nbytes(k) + _nbytes(v)
            p = plan((2 * tp_p, count, s, kv_heads // tp_p, hd))
            entries.append(_Entry("kv", gi, pi, ent["start"], count, s,
                                  [p], {"k": k, "v": v}))
        header = cls._pack_header(wire, tp_p, seq_len, entries,
                                  payload_bytes, off)
        return cls(wire, tp_p, seq_len, entries, header, payload_bytes,
                   off, buf=None)

    @staticmethod
    def _pack_header(wire: WireFormat, tp_p: int, seq_len: int,
                     entries: List[_Entry], payload_bytes: int,
                     total: int) -> bytes:
        out = [_PRELUDE.pack(MAGIC, VERSION, _WIRE_KINDS.index(wire.kind),
                             _DTYPES.index(precision.payload_name(wire)),
                             tp_p, len(entries), seq_len,
                             payload_bytes, total)]
        for e in entries:
            out.append(_ENTRY.pack(_ENTRY_KINDS.index(e.kind), len(e.parts),
                                   e.gi, e.pi, e.start, e.count, e.seq))
            for p in e.parts:
                shape5 = tuple(p.shape) + (1,) * (5 - len(p.shape))
                out.append(_PART.pack(_DTYPES.index(p.name), len(p.shape),
                                      *shape5, p.payload_off, p.scales_off))
        return b"".join(out)

    # -- construction: bound (D side, zero-copy) ------------------------ #
    @classmethod
    def from_buffer(cls, buf) -> "WireChunk":
        """Parse the fixed header of a wire segment; slabs stay in place."""
        mv = memoryview(buf)
        (magic, version, kind_c, dtype_c, tp_p, n_entries, seq_len,
         payload_bytes, total) = _PRELUDE.unpack_from(mv, 0)
        if magic != MAGIC:
            raise ValueError("not a fixed-layout wire segment")
        if version != VERSION:
            raise ValueError(f"wire format version {version} != {VERSION}")
        wire = WireFormat(_WIRE_KINDS[kind_c], _DTYPES[dtype_c]
                          if _WIRE_KINDS[kind_c] == "raw" else "bfloat16")
        off = _PRELUDE.size
        entries: List[_Entry] = []
        for _ in range(n_entries):
            ek, n_parts, gi, pi, start, count, seq = \
                _ENTRY.unpack_from(mv, off)
            off += _ENTRY.size
            parts = []
            for _p in range(n_parts):
                rec = _PART.unpack_from(mv, off)
                off += _PART.size
                dt_c, ndim = rec[0], rec[1]
                parts.append(_Part(_DTYPES[dt_c], tuple(rec[2:2 + ndim]),
                                   rec[7], rec[8]))
            entries.append(_Entry(_ENTRY_KINDS[ek], gi, pi, start, count,
                                  seq, parts))
        header = bytes(mv[:_PRELUDE.size])
        return cls(wire, tp_p, seq_len, entries, header, payload_bytes,
                   total, buf=mv)

    # -- sizes / meta ---------------------------------------------------- #
    @property
    def nbytes(self) -> int:
        """Wire footprint (header + slabs) — what the segment occupies."""
        return self._total_bytes

    @property
    def payload_nbytes(self) -> int:
        """Raw canonical KV bytes this chunk represents (pre-encode)."""
        return self._payload_bytes

    @property
    def header_nbytes(self) -> int:
        """Wire bytes that are not slab payload or scales: the header and
        the 64-byte alignment padding."""
        return self._total_bytes - sum(
            p.payload_nbytes + (0 if p.scales_off == _NO_SCALES
                                else p.scales_count * 4)
            for e in self._entries for p in e.parts)

    def meta(self) -> Dict[str, Any]:
        """The reader-side meta of a bound chunk (what the P side staged
        it with)."""
        return {"wire": self.wire, "tp_p": self.tp_p,
                "seq_len": self.seq_len}

    # -- P side: encode straight into the destination buffer ------------- #
    def write_into(self, buf) -> None:
        """Execute the slab plan: cast/quantize every source tensor (on its
        own device) and copy it into ``buf`` through typed views."""
        assert all(e.src is not None for e in self._entries), \
            "write_into on a bound chunk"
        mv = memoryview(buf)
        mv[:len(self._header)] = self._header
        for e in self._entries:
            if e.kind == "mla":
                for p, name in zip(e.parts, ("ckv", "kpe")):
                    self._encode_part(mv, p, e.src[name].reshape(p.shape))
                continue
            (p,) = e.parts
            n_sh, count, s, kvs, hd = p.shape
            tp = n_sh // 2
            # (count, S, tp·kvs, hd) → shard-major (tp, count, S, kvs, hd):
            # the same contiguous head split np.split(axis=2) produces
            k = e.src["k"].reshape(count, s, tp, kvs, hd).movedim(2, 0)
            v = e.src["v"].reshape(count, s, tp, kvs, hd).movedim(2, 0)
            if self.wire.kind == "raw":
                dst = precision.host_tensor(self._np_view(mv, p), p.name)
                dst[:tp].copy_(k)
                dst[tp:].copy_(v)
            else:
                self._encode_part(mv, p, torch.cat([k, v], dim=0))

    def _encode_part(self, mv: memoryview, p: _Part,
                     src: torch.Tensor) -> None:
        """Cast or quantize ``src`` (p.shape, on any device) into part
        ``p``'s slab (and its scales under int8)."""
        dst = precision.host_tensor(self._np_view(mv, p), p.name)
        if self.wire.kind == "raw":
            dst.copy_(src)
            return
        scales = torch.from_numpy(np.frombuffer(
            mv, dtype=np.float32, count=p.scales_count,
            offset=p.scales_off))
        precision.encode_wire_into(src, self.wire, dst,
                                   scales.reshape(p.shape[:-1] + (1,)))

    @staticmethod
    def _np_view(mv: memoryview, p: _Part) -> np.ndarray:
        return np.frombuffer(mv, dtype=p.storage, count=int(np.prod(p.shape)),
                             offset=p.payload_off).reshape(p.shape)

    # -- in-process read path -------------------------------------------- #
    def _backing(self) -> memoryview:
        """Bound buffer, or a lazily encoded local one (in-process reads
        decode the exact same bits a cross-process reader would see)."""
        if self._buf is not None:
            return self._buf
        if self._local is None:
            self._local = bytearray(self._total_bytes)
            self.write_into(self._local)
        return memoryview(self._local)

    # -- D side: zero-copy entry views ------------------------------------ #
    def entries(self) -> List[Dict[str, Any]]:
        """Entry descriptors with numpy views over the backing buffer (no
        copies; bfloat16 payloads as uint16 bits, named by ``dtype``). A
        ``"kv"`` entry has ``payload``/``scales``, an ``"mla"`` entry
        ``payloads``/``scales`` lists (ckv, kpe), as in the reference."""
        mv = self._backing()
        out = []
        for e in self._entries:
            d: Dict[str, Any] = {"kind": e.kind, "gi": e.gi, "pi": e.pi,
                                 "start": e.start, "count": e.count,
                                 "seq": e.seq, "tp_p": self.tp_p,
                                 "dtype": e.parts[0].name}
            views = [self._view(mv, p) for p in e.parts]
            if e.kind == "mla":
                d["payloads"] = [pay for pay, _ in views]
                d["scales"] = [sc for _, sc in views]
            else:
                d["payload"], d["scales"] = views[0]
            out.append(d)
        return out

    @classmethod
    def _view(cls, mv: memoryview, p: _Part
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        pay = cls._np_view(mv, p)
        if p.scales_off == _NO_SCALES:
            return pay, None
        return pay, np.frombuffer(mv, dtype=np.float32, count=p.scales_count,
                                  offset=p.scales_off)

    def release(self) -> None:
        """Drop buffer references so the backing segment can be closed."""
        if self._buf is not None:
            try:
                self._buf.release()
            except BufferError:
                pass                        # a view still pins it; GC closes
            self._buf = None
        self._local = None
