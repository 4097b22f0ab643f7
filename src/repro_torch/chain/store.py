"""``repro_torch.chain.store`` — the durable chain journal (crash-fault
layer). The port of ``repro/chain/store.py``: plain Python and numpy, and
the journal's bytes are the reference's, byte for byte, so either
package's ``Node.recover`` replays the other's journal.

A ``ChainStore`` is an append-only journal of everything a ``Node``
commits: one ``COMMIT`` record per block (header + full payload
evidence, canonically encoded) and one ``TRUNCATE`` record per
fork-choice rebuild (the journal itself is never rewritten in place —
a reorg appends ``TRUNCATE(fork_point)`` and then re-appends the
adopted tail, so a crash at any byte leaves a readable prefix).

Layout::

    magic "PNPJRNL1"
    record*            u8 rectype | u32 body_len (LE) | body | sha256(body)[:16]

``rectype`` 1 is ``COMMIT`` (encoded ``Block`` + ``BlockPayload``),
``rectype`` 2 is ``TRUNCATE`` (u64 height).  Every record carries its
own checksum, so a torn tail or a flipped bit is detected at read time
and the journal is **truncated at the first damaged record instead of
crashing** — ``Node.recover`` then replays the surviving prefix through
the ordinary verify path and resyncs the lost tail from peers.

The canonical byte encoding (little-endian scalars, length-prefixed
strings/bytes, dtype-tagged C-order arrays) covers every payload
family the chain mines — ``certificate`` bytes and ``FullResult``
evidence arrays included — and is bit-exact under round trip:
``encode_payload(decode_payload(b)) == b``.  It is the stepping stone
to the ROADMAP's cross-process wire format.

One thing cannot be serialized: a jash's ``fn`` (a live callable).
Decoding rebuilds the ``Jash`` from its name + meta (enough for
``source_id`` and for every workload that re-derives its instance
locally — SAT, GAN inversion, docking, classic via the registry) and
attaches the function from a ``jash_fns`` registry keyed by jash name;
unresolved functions become a sentinel that raises ``ChainError`` if
actually called, which makes the affected block fail re-verification
and be truncated rather than crash the reader.

The port's ``FullResult`` also carries the device it was mined on; that
is not part of the evidence and is not journaled, so a decoded
``FullResult`` has ``device=None`` and whoever re-verifies it names its
own device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.executor import FullResult
from repro_torch.core.jash import Jash, JashMeta
from repro_torch.core.ledger import Block
from repro_torch.chain.workload import BlockPayload, ChainError

__all__ = [
    "ChainStore",
    "JournalReadResult",
    "collect_jash_fns",
    "decode_block",
    "decode_payload",
    "encode_block",
    "encode_payload",
    "payload_checksum",
]

MAGIC = b"PNPJRNL1"
REC_COMMIT = 1
REC_TRUNCATE = 2
_CHECKSUM_LEN = 16
_HEAD = struct.Struct("<BI")            # rectype, body_len

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


class _Corrupt(ChainError):
    """Internal: the journal (or one record body) failed to parse."""


class _UnresolvedFn:
    """Placeholder for a jash function the decoder could not resolve.
    ``source_id`` never calls the function, so decoded payloads still
    cross-check their committed ``jash_id``; any workload that actually
    needs to *execute* the jash fails verification cleanly instead."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __call__(self, *args, **kwargs):
        raise ChainError(
            f"jash function {self.name!r} is not available in this "
            "process — pass jash_fns={...} to Node.recover / "
            "ChainStore.read_chain to re-verify its blocks")

    def __repr__(self) -> str:
        return f"<unresolved jash fn {self.name!r}>"


# ---------------------------------------------------------------------------
# canonical encoding primitives
# ---------------------------------------------------------------------------


class _W:
    """Append-only canonical writer."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def u8(self, v: int) -> None:
        self.buf += _U8.pack(v)

    def u32(self, v: int) -> None:
        self.buf += _U32.pack(v)

    def u64(self, v: int) -> None:
        self.buf += _U64.pack(v)

    def i64(self, v: int) -> None:
        self.buf += _I64.pack(v)

    def f64(self, v: float) -> None:
        self.buf += _F64.pack(v)

    def bstr(self, b: bytes) -> None:
        self.u32(len(b))
        self.buf += b

    def s(self, v: str) -> None:
        self.bstr(v.encode("utf-8"))

    def opt(self, v, enc: Callable) -> None:
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            enc(v)

    def arr(self, a: np.ndarray) -> None:
        a = np.ascontiguousarray(a)
        self.s(a.dtype.str)
        self.u8(a.ndim)
        for d in a.shape:
            self.u64(d)
        self.bstr(a.tobytes(order="C"))


class _R:
    """Bounds-checked canonical reader (raises ``_Corrupt`` on overrun
    or malformed content — the caller truncates, never crashes)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Corrupt("journal record body overruns its frame")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return _U8.unpack(self._take(1))[0]

    def u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self._take(8))[0]

    def i64(self) -> int:
        return _I64.unpack(self._take(8))[0]

    def f64(self) -> float:
        return _F64.unpack(self._take(8))[0]

    def bstr(self) -> bytes:
        return self._take(self.u32())

    def s(self) -> str:
        try:
            return self.bstr().decode("utf-8")
        except UnicodeDecodeError as e:
            raise _Corrupt(f"invalid utf-8 in journal record: {e}")

    def opt(self, dec: Callable):
        flag = self.u8()
        if flag == 0:
            return None
        if flag != 1:
            raise _Corrupt(f"invalid presence flag {flag}")
        return dec()

    def arr(self) -> np.ndarray:
        dtype = np.dtype(self.s())
        ndim = self.u8()
        shape = tuple(self.u64() for _ in range(ndim))
        raw = self.bstr()
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if n * dtype.itemsize != len(raw):
            raise _Corrupt("array byte length does not match its shape")
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()

    def done(self) -> None:
        if self.pos != len(self.data):
            raise _Corrupt(
                f"{len(self.data) - self.pos} trailing bytes in record")


def _enc_block(w: _W, blk: Block) -> None:
    # every header field except the timestamp — block_hash is
    # timestamp-free by design, so the decoded block re-hashes
    # identically (timestamp decodes as 0.0)
    w.u64(blk.height)
    w.s(blk.prev_hash)
    w.s(blk.jash_id)
    w.s(blk.mode)
    w.s(blk.merkle_root)
    w.opt(blk.winner, w.i64)
    w.opt(blk.best_res, w.s)
    w.u64(blk.n_results)
    w.s(blk.state_digest)


def _dec_block(r: _R) -> Block:
    return Block(height=r.u64(), prev_hash=r.s(), jash_id=r.s(),
                 mode=r.s(), merkle_root=r.s(),
                 winner=r.opt(r.i64), best_res=r.opt(r.s),
                 n_results=r.u64(), state_digest=r.s(), timestamp=0.0)


def _enc_jash(w: _W, jash: Jash) -> None:
    m = jash.meta
    w.s(jash.name)
    w.u32(m.arg_bits)
    w.u32(m.res_bits)
    w.opt(m.max_arg, w.u64)
    w.s(m.data_checksum)
    w.s(m.data_acquisition)
    w.f64(m.importance)
    w.s(m.description)


def _dec_jash(r: _R, jash_fns: Dict[str, Callable]) -> Jash:
    name = r.s()
    meta = JashMeta(arg_bits=r.u32(), res_bits=r.u32(),
                    max_arg=r.opt(r.u64), data_checksum=r.s(),
                    data_acquisition=r.s(), importance=r.f64(),
                    description=r.s())
    fn = jash_fns.get(name) or _UnresolvedFn(name)
    return Jash(name, fn, meta)


def _enc_full(w: _W, full: FullResult) -> None:
    w.arr(full.args)
    w.arr(full.results)
    w.arr(full.hashes)
    w.arr(full.miner_of)
    w.arr(full.leaf_digests)


def _dec_full(r: _R) -> FullResult:
    return FullResult(args=r.arr(), results=r.arr(), hashes=r.arr(),
                      miner_of=r.arr(), leaf_digests=r.arr())


def _enc_payload(w: _W, p: BlockPayload) -> None:
    w.s(p.workload)
    w.s(p.jash_id)
    w.s(p.merkle_root)
    w.u64(p.n_results)
    w.opt(p.winner, w.i64)
    w.opt(p.best_res, w.s)
    w.s(p.state_digest)
    w.i64(p.origin)
    w.f64(p.block_reward)
    w.opt(p.jash, lambda j: _enc_jash(w, j))
    w.opt(p.full, lambda f: _enc_full(w, f))
    w.opt(p.best_arg, w.i64)
    w.opt(p.loss, w.f64)
    w.opt(p.train_height, w.i64)
    w.u64(p.n_miners)
    w.opt(p.certificate, w.bstr)
    w.opt(p.micro_proof, w.arr)


def _dec_payload(r: _R, jash_fns: Dict[str, Callable]) -> BlockPayload:
    return BlockPayload(
        workload=r.s(), jash_id=r.s(), merkle_root=r.s(),
        n_results=r.u64(), winner=r.opt(r.i64), best_res=r.opt(r.s),
        state_digest=r.s(), origin=r.i64(), block_reward=r.f64(),
        jash=r.opt(lambda: _dec_jash(r, jash_fns)),
        full=r.opt(lambda: _dec_full(r)),
        best_arg=r.opt(r.i64), loss=r.opt(r.f64),
        train_height=r.opt(r.i64), n_miners=r.u64(),
        certificate=r.opt(r.bstr), micro_proof=r.opt(r.arr))


def encode_block(blk: Block) -> bytes:
    """Canonical bytes of a ledger ``Block`` header (timestamp-free, so
    the decoded block's content hash is bit-identical)."""
    w = _W()
    _enc_block(w, blk)
    return bytes(w.buf)


def decode_block(data: bytes) -> Block:
    r = _R(data)
    blk = _dec_block(r)
    r.done()
    return blk


def encode_payload(payload: BlockPayload) -> bytes:
    """Canonical bytes of a ``BlockPayload`` — committed fields plus the
    full evidence (``jash`` name/meta, ``FullResult`` arrays,
    ``certificate`` bytes).  Bit-exact under round trip for every
    payload family."""
    w = _W()
    _enc_payload(w, payload)
    return bytes(w.buf)


def decode_payload(data: bytes,
                   jash_fns: Optional[Dict[str, Callable]] = None
                   ) -> BlockPayload:
    r = _R(data)
    p = _dec_payload(r, jash_fns or {})
    r.done()
    return p


def payload_checksum(payload: BlockPayload) -> bytes:
    """The 16-byte content address of a payload: truncated SHA-256 of
    its canonical encoding.  This is the id compact block relay
    announces and fetches bodies by (the reference's ``chain/net``, not
    ported yet), the same truncation the journal uses per record — two
    payloads share a checksum iff their canonical bytes are identical."""
    return hashlib.sha256(encode_payload(payload)).digest()[:_CHECKSUM_LEN]


def collect_jash_fns(workloads: Dict[str, object],
                     extra: Optional[Dict[str, Callable]] = None
                     ) -> Dict[str, Callable]:
    """The jash-function registry a decoder needs: every registered
    workload's ``journal_jash_fns`` hook (the classic fallback
    publishes its base jash here), overlaid with caller-supplied
    ``extra`` entries (full/optimal researcher jashes).  Shared by
    ``Node.recover`` (journal replay) and, once ported, the wire layer's
    ``PeerNode`` (wire decode) — one resolution rule for disk and wire."""
    fns: Dict[str, Callable] = {}
    for wl in workloads.values():
        hook = getattr(wl, "journal_jash_fns", None)
        if hook is not None:
            fns.update(hook())
    if extra:
        fns.update(extra)
    return fns


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JournalReadResult:
    """What ``ChainStore.read_chain`` recovered.  ``blocks``/``payloads``
    are the journal's surviving chain (``COMMIT``/``TRUNCATE`` records
    folded in order); ``truncated_records`` counts damaged-tail events
    (0 or 1 per read — everything at and after the first torn or
    checksum-failing record is discarded); ``clean`` is True iff the
    journal parsed end-to-end undamaged."""
    blocks: List[Block]
    payloads: List[BlockPayload]
    records_read: int
    truncated_records: int
    clean: bool


class ChainStore:
    """Append-only, per-record-checksummed journal of one node's chain.

    ``path=None`` keeps the journal in memory (what the simulator's
    crash/restart faults use as the surviving "disk"); a real path
    appends to that file.  The write API is exactly what ``Node`` emits:
    ``append_commit`` on every committed block, ``append_truncate`` at
    each fork-choice rebuild.  ``read_chain`` never raises on damaged
    input — it returns the longest undamaged prefix and flags the
    truncation."""

    def __init__(self, path: Optional[object] = None) -> None:
        self.path = Path(path) if path is not None else None
        self._buf: Optional[bytearray] = None
        if self.path is None:
            self._buf = bytearray(MAGIC)
        elif not self.path.exists() or self.path.stat().st_size == 0:
            self.path.write_bytes(MAGIC)

    # -- raw byte access ----------------------------------------------
    @property
    def size(self) -> int:
        return (len(self._buf) if self._buf is not None
                else self.path.stat().st_size)

    def is_empty(self) -> bool:
        """True iff the journal holds no records (header only, or a
        header too damaged to hold any)."""
        return self.size <= len(MAGIC)

    def to_bytes(self) -> bytes:
        """The journal's raw bytes (what a disk image of it would hold
        — the torn-write tests snapshot this and damage copies)."""
        return self._read_all()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ChainStore":
        """An in-memory journal initialized from raw bytes (damaged
        input is fine — ``read_chain`` truncates, never raises)."""
        store = cls()
        store._buf[:] = data
        return store

    def _read_all(self) -> bytes:
        return (bytes(self._buf) if self._buf is not None
                else self.path.read_bytes())

    def _write_all(self, data: bytes) -> None:
        if self._buf is not None:
            self._buf[:] = data
        else:
            self.path.write_bytes(data)

    def _append(self, data: bytes) -> None:
        if self._buf is not None:
            self._buf += data
        else:
            with open(self.path, "ab") as f:
                f.write(data)

    # -- write side (what Node emits) ---------------------------------
    @staticmethod
    def _frame(rectype: int, body: bytes) -> bytes:
        return (_HEAD.pack(rectype, len(body)) + body
                + hashlib.sha256(body).digest()[:_CHECKSUM_LEN])

    def append_commit(self, block: Block, payload: BlockPayload) -> None:
        """Journal one committed block (header + payload evidence)."""
        w = _W()
        _enc_block(w, block)
        _enc_payload(w, payload)
        self._append(self._frame(REC_COMMIT, bytes(w.buf)))

    def append_truncate(self, height: int) -> None:
        """Journal a fork-choice truncation: the chain now ends at
        ``height`` and the adopted tail follows as ordinary commits."""
        self._append(self._frame(REC_TRUNCATE, _U64.pack(height)))

    def rewrite(self, blocks: Sequence[Block],
                payloads: Sequence[BlockPayload]) -> None:
        """Compact the journal to exactly this chain (one ``COMMIT`` per
        block, damaged tail and historical ``TRUNCATE`` records dropped)
        — what ``Node.recover`` does after adopting a truncated prefix."""
        out = bytearray(MAGIC)
        for blk, payload in zip(blocks, payloads):
            w = _W()
            _enc_block(w, blk)
            _enc_payload(w, payload)
            out += self._frame(REC_COMMIT, bytes(w.buf))
        self._write_all(bytes(out))

    # -- read side (what Node.recover replays) ------------------------
    def _record_spans(self) -> List[Tuple[int, int]]:
        """Byte spans ``[start, end)`` of every well-framed record (used
        by the fault injectors to aim corruption at the tail)."""
        data = self._read_all()
        spans: List[Tuple[int, int]] = []
        pos = len(MAGIC)
        while pos + _HEAD.size <= len(data):
            _, body_len = _HEAD.unpack_from(data, pos)
            end = pos + _HEAD.size + body_len + _CHECKSUM_LEN
            if end > len(data):
                break
            spans.append((pos, end))
            pos = end
        return spans

    def read_chain(self, jash_fns: Optional[Dict[str, Callable]] = None
                   ) -> JournalReadResult:
        """Fold the journal into its final chain.  Damage — bad magic, a
        torn tail, a checksum mismatch, an undecodable body, or a record
        that contradicts the chain built so far — truncates the read at
        that point (``clean=False``); everything before it survives."""
        fns = jash_fns or {}
        data = self._read_all()
        blocks: List[Block] = []
        payloads: List[BlockPayload] = []
        records = 0
        if data[:len(MAGIC)] != MAGIC:
            return JournalReadResult([], [], 0, 1, clean=False)
        pos = len(MAGIC)
        clean = True
        while pos < len(data):
            if pos + _HEAD.size > len(data):
                clean = False
                break
            rectype, body_len = _HEAD.unpack_from(data, pos)
            body_start = pos + _HEAD.size
            body_end = body_start + body_len
            if body_end + _CHECKSUM_LEN > len(data):
                clean = False                      # torn tail
                break
            body = data[body_start:body_end]
            check = data[body_end:body_end + _CHECKSUM_LEN]
            if hashlib.sha256(body).digest()[:_CHECKSUM_LEN] != check:
                clean = False                      # flipped bits
                break
            try:
                if rectype == REC_COMMIT:
                    r = _R(body)
                    blk = _dec_block(r)
                    payload = _dec_payload(r, fns)
                    r.done()
                    if blk.height != len(blocks):
                        raise _Corrupt(
                            f"commit at height {blk.height} does not "
                            f"extend the journal chain ({len(blocks)})")
                    blocks.append(blk)
                    payloads.append(payload)
                elif rectype == REC_TRUNCATE:
                    (height,) = _U64.unpack(body)
                    if height > len(blocks):
                        raise _Corrupt(
                            f"truncate to {height} beyond journal "
                            f"chain ({len(blocks)})")
                    del blocks[height:]
                    del payloads[height:]
                else:
                    raise _Corrupt(f"unknown record type {rectype}")
            except (_Corrupt, ChainError, ValueError, TypeError,
                    struct.error):
                clean = False
                break
            records += 1
            pos = body_end + _CHECKSUM_LEN
        return JournalReadResult(blocks, payloads, records,
                                 0 if clean else 1, clean=clean)

    # -- fault injection (chaos scenarios + torn-write tests) ---------
    def corrupt_tail(self, rng, mode: str = "bitflip") -> str:
        """Deterministically damage the journal's last record (the
        simulator's ``corrupt_store_at`` fault).  ``mode="bitflip"``
        flips one random bit inside the record; ``"torn"`` truncates the
        journal mid-record, as an interrupted write would.  Returns a
        short description of what was damaged (empty if the journal has
        no records to damage)."""
        spans = self._record_spans()
        data = bytearray(self._read_all())
        if not spans:
            # no well-framed record — tear whatever trailing bytes exist
            if len(data) > len(MAGIC):
                self._write_all(bytes(data[:len(MAGIC)]))
                return "tore unframed tail"
            return ""
        start, end = spans[-1]
        if mode == "torn":
            cut = rng.randrange(start + 1, end)
            self._write_all(bytes(data[:cut]))
            return f"tore last record at byte {cut - start}/{end - start}"
        if mode != "bitflip":
            raise ValueError(f"unknown corruption mode {mode!r}")
        off = rng.randrange(start, end)
        bit = rng.randrange(8)
        data[off] ^= 1 << bit
        self._write_all(bytes(data))
        return f"flipped bit {bit} of byte {off - start}/{end - start}"

    def flip_bit(self, offset: int, bit: int = 0) -> None:
        """Low-level fault helper: flip one bit at an absolute byte
        offset (the torn-write property tests sweep every offset)."""
        data = bytearray(self._read_all())
        data[offset] ^= 1 << bit
        self._write_all(bytes(data))

    def truncate_bytes(self, n: int) -> None:
        """Low-level fault helper: keep only the first ``n`` bytes, as a
        crash mid-write would."""
        self._write_all(self._read_all()[:n])
