"""Columnar frame reassembler for the mixed-path slow lane.

In the reference, the mixed-path slow lane spent its time in per-entry
host Python: `feed` (per-entry buffer
append), frame extraction (per-entry `bytes.find` loops), `settle_entry`
(per-entry op emission) and per-entry response assembly.  This module
replaces that per-ENTRY work with a handful of array passes per ROUND
(the Libra / receive-side-dispatching shape from PAPERS.md: move
per-message byte shuffling into batched, layout-aware bulk operations):

- **Byte arena.**  Per-connection carry state (the partial frame a read
  left behind) lives in ONE contiguous numpy buffer with per-conn
  (offset, length) slots — not a Python ``bytearray`` per flow.  Slots
  are bump-allocated and compacted; per-conn totals stay bounded by the
  existing ``max_flow_buffer`` cap (overflow is the same typed
  DROP+ERROR contract as the scalar engines).
- **Vectorized ingest.**  A whole round's DataBatch payloads are
  appended to their conns' carries in one ragged scatter (carry bytes
  and payload bytes gathered into a round-local stream).
- **Vectorized framing.**  Frame boundaries are found with one scan
  over the stream — CRLF for r2d2/memcached-class protocols,
  length-prefixed (kafka/cassandra-class) via a per-frame-rank
  vectorized walk — with hits that straddle entry boundaries rejected
  columnar.
- **Columnar emission.**  Frame splitting and response-op assembly
  produce (entry, frame_offset, frame_len, verdict-slot) arrays that
  feed the service's single issued-not-read-back model call directly,
  and the finish half renders ops/injects/flow-records as array
  scatters.

The scalar engine path (`feed`/`feed_extract`/`settle_entry` in
runtime/batch.py) survives unchanged as the oracle/fallback rung: the
service routes anything the columnar path cannot prove safe (reply
direction, end_stream, demoted/stale conns, duplicate conns in one
round, non-CRLF engines) through it, and parity tests assert the two
paths are byte-identical in ops, injects and flow records.
"""

from __future__ import annotations

import numpy as np

from ..proxylib.types import DROP, ERROR, MORE, PASS, OpError

OP_PASS = int(PASS)
OP_DROP = int(DROP)
OP_MORE = int(MORE)
OP_ERROR = int(ERROR)
ERR_FRAME_LEN = int(OpError.ERROR_INVALID_FRAME_LENGTH)

# Framing kinds of the columnar feed contract (engine.reasm_spec()).
# Kinds with a registered Framing in ``FRAMINGS`` (bottom of module)
# ride the columnar lane; anything else serves scalar.
FRAMING_CRLF = "crlf"
FRAMING_DNS = "dns"
FRAMING_LENGTH_PREFIX = "length_prefix"


# --- ragged gather/scatter primitives ------------------------------------

def ragged_indices(starts, lens) -> np.ndarray:
    """Flat gather indices for segments ``(starts[i], lens[i])`` — the
    vectorized equivalent of concatenating ``arange(s, s+l)`` per
    segment, built with two cumsum passes instead of a Python loop.
    Zero-length segments are allowed (they contribute nothing)."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    nz = lens > 0
    if not nz.all():
        starts = starts[nz]
        lens = lens[nz]
    if len(lens) == 0:
        return np.empty(0, np.int64)
    total = int(lens.sum())
    step = np.ones(total, np.int64)
    ends = np.cumsum(lens)
    step[0] = starts[0]
    if len(lens) > 1:
        step[ends[:-1]] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
    return np.cumsum(step)


def gather_segments(src, starts, lens, out=None, dst_starts=None):
    """Bulk-copy segments out of ``src``: contiguous into a fresh (or
    provided) buffer when ``dst_starts`` is None, else scattered to the
    given destination offsets.  A few array passes total, independent
    of the segment count."""
    src = np.asarray(src)
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    si = ragged_indices(starts, lens)
    if dst_starts is None:
        if out is None:
            out = np.empty(total, src.dtype)
        out[:total] = src[si]
        return out
    out[ragged_indices(dst_starts, lens)] = src[si]
    return out


# --- frame-boundary scanners ---------------------------------------------

def segments_end_crlf(blob: np.ndarray, starts: np.ndarray,
                      lengths: np.ndarray) -> np.ndarray:
    """[n] bool — each segment is >= 2 bytes and its LAST two bytes are
    CRLF.  The verdict cache's frame-alignment gate (service Phase-A
    mask and the shim's pre-push check): a short-circuit must only ever
    cover whole frames, so an epoch flip or disarm at ANY point leaves
    the flow parseable from a frame boundary.  Like rows_end_crlf, the
    blob bound is part of the gate: a malformed start/length must read
    as a miss, never fancy-index past the blob."""
    n = len(lengths)
    if n == 0 or len(blob) < 2:
        return np.zeros(n, bool)
    li = np.asarray(lengths, np.int64)
    st = np.asarray(starts, np.int64)
    ok = (li >= 2) & (st >= 0) & (st + li <= len(blob))
    ends = np.where(ok, st + li, 2)
    return ok & (blob[ends - 2] == 13) & (blob[ends - 1] == 10)


def rows_end_crlf(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[n] bool — each padded row's payload is >= 2 bytes, fits the row
    width, and ends with CRLF.  The matrix-batch twin of
    segments_end_crlf, and like it THE frame-alignment gate definition
    for the verdict cache: the width bound is part of the gate (a
    malformed length must read as a miss, never fancy-index past the
    row)."""
    n = len(lengths)
    if n == 0 or rows.shape[1] < 2:
        return np.zeros(n, bool)
    li = np.asarray(lengths, np.int64)
    ok = (li >= 2) & (li <= rows.shape[1])
    le = np.where(ok, li, 2)
    ar = np.arange(n)
    return ok & (rows[ar, le - 2] == 13) & (rows[ar, le - 1] == 10)


def scan_crlf(stream: np.ndarray, ends: np.ndarray):
    """All CRLF positions ``p`` (``stream[p]==13 and stream[p+1]==10``)
    that lie wholly inside one entry.  Entries are contiguous:
    entry ``i`` spans ``[ends[i-1], ends[i])``.  A CR that is an
    entry's last byte must NOT pair with the next entry's leading LF —
    those straddling hits are rejected columnar (the scalar path never
    sees them because it scans per-conn buffers).  Returns
    ``(hits, entry_of_hit)``, both ascending."""
    ends = np.asarray(ends, np.int64)
    if len(stream) < 2:
        z = np.empty(0, np.int64)
        return z, z
    hits = np.flatnonzero((stream[:-1] == 13) & (stream[1:] == 10))
    if len(hits) == 0:
        return hits, hits
    e = np.searchsorted(ends, hits, side="right")
    keep = hits + 1 < ends[e]
    return hits[keep], e[keep]


def scan_length_prefixed(stream, offs, ends, frame_len_fn):
    """Frame boundaries for length-prefixed protocols (kafka/cassandra
    class).  Each pass computes the next boundary of EVERY still-active
    entry at once, so the Python loop runs max-frames-per-entry times,
    not once per frame.  ``frame_len_fn(stream, pos, avail)`` returns
    the total frame length (header included) per position, or -1 while
    the header is incomplete.  Returns ``(f_entry, f_start, f_len)``
    sorted by entry then stream order."""
    offs = np.asarray(offs, np.int64)
    ends = np.asarray(ends, np.int64)
    pos = offs.copy()
    alive = np.flatnonzero(ends > offs)
    out_e: list = []
    out_s: list = []
    out_l: list = []
    while len(alive):
        avail = ends[alive] - pos[alive]
        fl = np.asarray(frame_len_fn(stream, pos[alive], avail), np.int64)
        # A non-positive frame length (a malformed header a custom
        # reader maps to <= 0 — attacker-controllable bytes) means no
        # forward progress is possible for that entry: it simply stops
        # completing frames this round and its bytes stay as residue,
        # where the per-conn cap turns a wedged stream into the typed
        # overflow DROP+ERROR.  The scanner itself must stay TOTAL —
        # an exception here would abort the whole columnar round and
        # leak every other entry's answer (lint R15).
        done = (fl > 0) & (fl <= avail)
        if not done.any():
            break
        idx = alive[done]
        out_e.append(idx)  # lint: disable=R7 -- per frame-RANK (max frames per entry), never per entry: each pass is one vectorized step over every active entry
        out_s.append(pos[idx].copy())  # lint: disable=R7 -- see above: per-pass accumulator, not per-entry work
        out_l.append(fl[done])  # lint: disable=R7 -- see above: per-pass accumulator, not per-entry work
        pos[idx] += fl[done]
        alive = idx[pos[idx] < ends[idx]]
    if not out_e:
        z = np.empty(0, np.int64)
        return z, z, z
    f_entry = np.concatenate(out_e)
    f_start = np.concatenate(out_s)
    f_len = np.concatenate(out_l)
    order = np.lexsort((f_start, f_entry))
    return f_entry[order], f_start[order], f_len[order]


def length_prefix_reader(header_bytes: int, length_offset: int,
                         length_size: int = 4, big_endian: bool = True,
                         extra: int = 0):
    """``frame_len_fn`` factory for the common length-prefix layouts:
    total frame length = ``header_bytes`` + the ``length_size``-byte
    integer at ``length_offset`` (+ ``extra``).  Covers the cassandra
    v3/v4 frame (9-byte header, u32 body length at offset 5) and the
    kafka wire frame (4-byte big-endian size prefix)."""

    def fn(stream, pos, avail):
        out = np.full(len(pos), -1, np.int64)
        have = avail >= header_bytes
        if have.any():
            p = pos[have] + length_offset
            val = np.zeros(len(p), np.int64)
            for k in range(length_size):
                shift = (
                    (length_size - 1 - k) if big_endian else k
                ) * 8
                val |= stream[p + k].astype(np.int64) << shift
            out[have] = header_bytes + val + extra
        return out

    return fn


# --- per-framing dispatch -------------------------------------------------
#
# PR 10 gated the columnar lane on ``reasm_spec() == "crlf"``; this
# table lifts that gate into a per-framing dispatch: each Framing packs
# the scanner (ingest), the whole-frame alignment gates (the verdict
# cache's frame-boundary contract, per tier: round segments, matrix
# rows, single host payloads) and the per-denied-frame reply inject.
# Every future length-prefixed engine (HTTP/2-gRPC 9-byte headers,
# cassandra, kafka) lands by registering a Framing here and declaring
# its kind from ``reasm_spec()`` — no new service code.

class Framing:
    """One framing kind of the columnar feed contract."""

    kind = ""
    err_inject = b""  # reply bytes per denied frame (engine DENY_INJECT)

    def scan(self, stream, offs, ends):
        """Complete frames wholly inside entries: ``(f_entry, f_start,
        f_len)`` sorted by entry then stream order, frames contiguous
        from each entry's offset."""
        raise NotImplementedError

    def segments_aligned(self, blob, starts, lengths):
        """[n] bool — each segment is >= 1 whole frame ending exactly
        at the segment end (the cache tiers' frame-alignment gate: a
        short-circuit must only ever cover whole frames)."""
        raise NotImplementedError

    def rows_aligned(self, rows, lengths):
        """Matrix-row twin of segments_aligned (width bound included:
        a malformed length reads as a miss, never out of the row)."""
        n, w = rows.shape
        li = np.asarray(lengths, np.int64)
        ok = (li >= 1) & (li <= w)
        starts = np.arange(n, dtype=np.int64) * w
        return ok & self.segments_aligned(
            rows.reshape(-1), starts, np.where(ok, li, 0)
        )

    def payload_aligned(self, data: bytes) -> bool:
        """Single-payload (host bytes) twin of segments_aligned — the
        scalar classifier's per-entry cache gate."""
        raise NotImplementedError

    def payload_single_frame(self, data: bytes) -> bool:
        """Exactly ONE whole frame — the vectorized fast lane's
        per-entry gate."""
        raise NotImplementedError

    def segments_single_frame(self, blob, offs, lengths):
        """[n] bool — each segment is exactly one whole frame (the
        whole-batch vec-eligibility gate)."""
        raise NotImplementedError

    def rows_single_frame(self, rows, lengths):
        """Matrix-row twin of segments_single_frame."""
        n, w = rows.shape
        li = np.asarray(lengths, np.int64)
        ok = (li >= 1) & (li <= w)
        starts = np.arange(n, dtype=np.int64) * w
        return ok & self.segments_single_frame(
            rows.reshape(-1), starts, np.where(ok, li, 0)
        )


class CrlfFraming(Framing):
    """CRLF-delimited lines (r2d2, text memcached class)."""

    kind = FRAMING_CRLF
    err_inject = b"ERROR\r\n"

    def scan(self, stream, offs, ends):
        offs = np.asarray(offs, np.int64)
        hits, e_of = scan_crlf(stream, ends)
        nf = len(hits)
        first = np.ones(nf, bool)
        prev = np.zeros(nf, np.int64)
        if nf:
            first[1:] = e_of[1:] != e_of[:-1]
            prev[1:] = hits[:-1]
        f_start = np.where(first, offs[e_of], prev + 2)
        return e_of, f_start, hits + 2 - f_start

    def segments_aligned(self, blob, starts, lengths):
        return segments_end_crlf(blob, starts, lengths)

    def rows_aligned(self, rows, lengths):
        return rows_end_crlf(rows, lengths)

    def payload_aligned(self, data: bytes) -> bool:
        return len(data) >= 2 and data.endswith(b"\r\n")

    def payload_single_frame(self, data: bytes) -> bool:
        return (
            len(data) >= 2
            and data.endswith(b"\r\n")
            and data.find(b"\r\n") == len(data) - 2
        )

    def segments_single_frame(self, blob, offs, lengths):
        offs = np.asarray(offs, np.int64)
        li = np.asarray(lengths, np.int64)
        aligned = segments_end_crlf(blob, offs, li)
        if not aligned.any():
            return aligned
        # Exactly one CR per entry => exactly one frame, ending at the
        # entry boundary.
        ends = offs + li
        crs = np.add.reduceat(
            (blob == 13).astype(np.int32), offs,
        ) if len(blob) else np.zeros(len(offs), np.int32)
        # reduceat sums to the NEXT start; the last segment sums to the
        # blob end — only exact for contiguous segments, so recompute
        # defensively for non-contiguous callers.
        contiguous = bool(
            len(offs) and (offs[1:] == ends[:-1]).all()
            and ends[-1] == len(blob) and offs[0] == 0
        )
        if not contiguous:
            crs = np.array(
                [int((blob[o : o + n] == 13).sum())
                 for o, n in zip(offs, li)],
                np.int32,
            )
        return aligned & (crs == 1)

    def rows_single_frame(self, rows, lengths):
        ok = rows_end_crlf(rows, lengths)
        return ok & ((rows == 13).sum(axis=1) == 1)


class LengthPrefixFraming(Framing):
    """Length-prefixed frames: total length = header + the integer at
    ``length_offset`` (+ extra).  DNS-over-TCP is header_bytes=2 with a
    2-byte big-endian prefix at offset 0; the cassandra v3/v4 frame is
    (9, 5) and kafka (4, 0) — registered once their engines' parser
    state goes arena-portable."""

    def __init__(self, kind: str, header_bytes: int, length_offset: int,
                 length_size: int = 4, big_endian: bool = True,
                 extra: int = 0, err_inject: bytes = b""):
        self.kind = kind
        self.header = int(header_bytes)
        self.err_inject = err_inject
        self._lo, self._ls = int(length_offset), int(length_size)
        self._be, self._extra = bool(big_endian), int(extra)
        self._reader = length_prefix_reader(
            header_bytes, length_offset, length_size, big_endian, extra
        )

    def frame_len_of(self, buf) -> int:
        """First frame's total length from host bytes, or -1 while the
        header is incomplete."""
        if len(buf) < self.header:
            return -1
        val = 0
        for k in range(self._ls):
            shift = (self._ls - 1 - k if self._be else k) * 8
            val |= buf[self._lo + k] << shift
        return self.header + val + self._extra

    def scan(self, stream, offs, ends):
        return scan_length_prefixed(stream, offs, ends, self._reader)

    def segments_aligned(self, blob, starts, lengths):
        starts = np.asarray(starts, np.int64)
        li = np.asarray(lengths, np.int64)
        n = len(li)
        ok = (li > 0) & (starts >= 0) & (starts + li <= len(blob))
        fe, _fs, fl = self.scan(
            blob, starts, starts + np.where(ok, li, 0)
        )
        consumed = np.zeros(n, np.int64)
        np.add.at(consumed, fe, fl)
        return ok & (consumed == li)

    def payload_aligned(self, data: bytes) -> bool:
        pos, n = 0, len(data)
        while pos < n:
            fl = self.frame_len_of(
                memoryview(data)[pos : pos + self.header]
            )
            if fl < 0 or pos + fl > n:
                return False
            pos += fl
        return n > 0

    def payload_single_frame(self, data: bytes) -> bool:
        return len(data) >= self.header and (
            self.frame_len_of(data) == len(data)
        )

    def segments_single_frame(self, blob, offs, lengths):
        offs = np.asarray(offs, np.int64)
        li = np.asarray(lengths, np.int64)
        ok = (li >= self.header) & (offs >= 0) & (offs + li <= len(blob))
        fl = self._reader(blob, np.where(ok, offs, 0),
                          np.where(ok, li, 0))
        return ok & (fl == li)


# The columnar lane's framing registry (see module docstring): kinds an
# engine may declare from ``reasm_spec()`` and actually ride the lane.
FRAMINGS: dict[str, Framing] = {
    FRAMING_CRLF: CrlfFraming(),
    FRAMING_DNS: LengthPrefixFraming(
        FRAMING_DNS, header_bytes=2, length_offset=0, length_size=2,
        err_inject=b"",  # DNS denies DROP with no inject
    ),
}


# --- the byte arena ------------------------------------------------------

class ByteArena:
    """One contiguous byte pool holding every reassembly carry.

    Per-conn state is three parallel slot columns (offset, length,
    dead) plus a direct-index conn→slot map; allocation is a bump
    pointer with gather-based compaction when the tail reaches the
    capacity (growing geometrically when the live set itself outgrows
    the pool).  Everything round-scale is vectorized; per-conn Python
    only happens at lane transitions (release/adopt) and close."""

    # Conn-id ceiling for the direct-index map (mirrors the service's
    # _TAB_MAX): larger ids simply never enter the columnar lane.
    MAP_MAX = 1 << 22

    def __init__(self, capacity: int = 1 << 20):
        self.buf = np.zeros(max(int(capacity), 1024), np.uint8)
        self._map = np.full(1024, -1, np.int32)
        n0 = 256
        self.s_off = np.zeros(n0, np.int64)
        self.s_len = np.zeros(n0, np.int64)
        self.s_conn = np.full(n0, -1, np.int64)
        self.s_dead = np.zeros(n0, np.uint8)
        self._n_slots = 0
        self._free: list[int] = []
        self._tail = 0
        self._live = 0
        self.compactions = 0
        self.grows = 0

    # -- conn→slot map ----------------------------------------------------

    def _ensure_map(self, max_cid: int) -> None:
        if max_cid < len(self._map):
            return
        size = len(self._map)
        while size <= max_cid:
            size *= 2
        grown = np.full(size, -1, np.int32)
        grown[: len(self._map)] = self._map
        self._map = grown

    def slots_for(self, cids: np.ndarray) -> np.ndarray:
        """Slot index per conn id (-1 = no slot).  Ids beyond MAP_MAX
        are reported slotless (they never enter the lane)."""
        cids = np.asarray(cids, np.int64)
        out = np.full(len(cids), -1, np.int32)
        ok = (cids >= 0) & (cids < len(self._map))
        out[ok] = self._map[cids[ok]]
        return out

    def has_slot(self, cids: np.ndarray) -> np.ndarray:
        return self.slots_for(cids) >= 0

    def _grow_slots(self, need: int) -> None:
        size = len(self.s_off)
        if self._n_slots + need <= size:
            return
        while size < self._n_slots + need:
            size *= 2
        for name, fill, dt in (("s_off", 0, np.int64),
                               ("s_len", 0, np.int64),
                               ("s_conn", -1, np.int64),
                               ("s_dead", 0, np.uint8)):
            arr = np.full(size, fill, dt)
            arr[: len(getattr(self, name))] = getattr(self, name)
            setattr(self, name, arr)

    def ensure_slots(self, cids: np.ndarray) -> np.ndarray:
        """Slot per conn, creating empty slots for new conns (one
        vectorized map scatter; the free list is consumed first)."""
        cids = np.asarray(cids, np.int64)
        if len(cids) and int(cids.max()) >= self.MAP_MAX:
            raise ValueError("conn id beyond arena map ceiling")
        if len(cids):
            self._ensure_map(int(cids.max()))
        slots = self._map[cids].astype(np.int32)
        missing = np.flatnonzero(slots < 0)
        if len(missing):
            new_ids = np.empty(len(missing), np.int32)
            n_free = min(len(self._free), len(missing))
            for k in range(n_free):  # free list is tiny; ids reused LIFO
                new_ids[k] = self._free.pop()
            fresh = len(missing) - n_free
            if fresh:
                self._grow_slots(fresh)
                new_ids[n_free:] = np.arange(
                    self._n_slots, self._n_slots + fresh, dtype=np.int32
                )
                self._n_slots += fresh
            mcids = cids[missing]
            self.s_off[new_ids] = 0
            self.s_len[new_ids] = 0
            self.s_conn[new_ids] = mcids
            self.s_dead[new_ids] = 0
            self._map[mcids] = new_ids
            slots[missing] = new_ids
        return slots

    # -- round-scale carry ops --------------------------------------------

    def carry(self, slots: np.ndarray):
        """(offsets, lengths) of the given slots' carries."""
        return self.s_off[slots], self.s_len[slots]

    def consume(self, slots: np.ndarray) -> None:
        """Mark the given slots' carries consumed (their bytes were
        gathered into a round stream)."""
        self._live -= int(self.s_len[slots].sum())
        self.s_len[slots] = 0

    def mark_dead(self, slots: np.ndarray) -> None:
        self.consume(slots)
        self.s_dead[slots] = 1

    def store(self, slots: np.ndarray, src, src_starts, lens) -> None:
        """Replace the given slots' carries with segments of ``src``
        (one ragged scatter into the pool)."""
        lens = np.asarray(lens, np.int64)
        total = int(lens.sum())
        if self._tail + total > len(self.buf):
            self._compact(total)
        dst = self._tail + np.concatenate(
            ([0], np.cumsum(lens))
        )[:-1].astype(np.int64)
        gather_segments(src, src_starts, lens, out=self.buf,
                        dst_starts=dst)
        self.s_off[slots] = dst
        # Replacement semantics: any un-consumed previous carry in
        # these slots stops being live (ingest consumes first; direct
        # replacement must not double-count).
        self._live -= int(self.s_len[slots].sum())
        self.s_len[slots] = lens
        self._tail += total
        self._live += total

    def _compact(self, need: int) -> None:
        used = np.flatnonzero(
            (self.s_conn[: self._n_slots] >= 0)
            & (self.s_len[: self._n_slots] > 0)
        )
        lens = self.s_len[used]
        live = int(lens.sum())
        cap = len(self.buf)
        while live + need > cap:
            cap *= 2
        data = self.buf[ragged_indices(self.s_off[used], lens)]
        if cap != len(self.buf):
            self.buf = np.zeros(cap, np.uint8)
            self.grows += 1
        self.buf[:live] = data
        self.s_off[used] = np.concatenate(
            ([0], np.cumsum(lens))
        )[:-1].astype(np.int64)
        self._tail = live
        self._live = live
        self.compactions += 1

    # -- lane transitions (per-conn; rare by design) ----------------------

    def release(self, conn_id: int) -> tuple[bytes, bool]:
        """Pull one conn out of the arena: (carry bytes, dead).  Used
        when a conn leaves the columnar lane (scalar routing, oracle
        demotion) — the bytes move into the scalar carry location."""
        if not (0 <= conn_id < len(self._map)):
            return b"", False
        slot = int(self._map[conn_id])
        if slot < 0:
            return b"", False
        off, ln = int(self.s_off[slot]), int(self.s_len[slot])
        dead = bool(self.s_dead[slot])
        data = self.buf[off : off + ln].tobytes()
        self._live -= ln
        self._map[conn_id] = -1
        self.s_conn[slot] = -1
        self.s_len[slot] = 0
        self.s_dead[slot] = 0
        self._free.append(slot)
        return data, dead

    def drop(self, conn_id: int) -> None:
        self.release(conn_id)

    def peek(self, conn_id: int) -> bytes:
        """Non-destructive read of a conn's columnar carry bytes.  The
        restart-handoff snapshot serializes residue IN PLACE: the conn
        must keep serving unchanged if the handoff is refused or the
        predecessor outlives the surrender attempt."""
        if not (0 <= conn_id < len(self._map)):
            return b""
        slot = int(self._map[conn_id])
        if slot < 0:
            return b""
        off, ln = int(self.s_off[slot]), int(self.s_len[slot])
        return self.buf[off : off + ln].tobytes()

    def has_residue(self, conn_id: int) -> bool:
        """True when this conn holds columnar carry state (bytes or the
        dead/overflowed latch) — the arena's contribution to the
        service's residual-dirty predicate."""
        if not (0 <= conn_id < len(self._map)):
            return False
        slot = int(self._map[conn_id])
        return slot >= 0 and (
            self.s_len[slot] > 0 or bool(self.s_dead[slot])
        )

    def status(self) -> dict:
        return {
            "capacity": len(self.buf),
            "tail": self._tail,
            "live_bytes": self._live,
            "slots": int(self._n_slots - len(self._free)),
            "compactions": self.compactions,
            "grows": self.grows,
        }


# --- one round's reassembly ----------------------------------------------

class ReasmRound:
    """Columnar result of one ingest: per-entry masks/offsets, the
    frame table, and the residue bookkeeping the finish half needs."""

    __slots__ = ("n", "conn_ids", "slots", "dead", "over", "live",
                 "over_total", "stream", "entry_off", "entry_end",
                 "f_entry", "f_start", "f_len", "n_frames", "res_len",
                 "more", "framing", "_gb", "_ge")

    def frame_count(self) -> int:
        return len(self.f_entry)


class Reassembler:
    """Round-scale reassembly over a :class:`ByteArena`, one framing
    per round group (``FRAMINGS``): CRLF for the r2d2/text-memcached
    class, length-prefixed for the DNS class — the service groups each
    round's entries by engine and hands every group its engine's
    declared framing."""

    def __init__(self, cap_per_conn: int = 1 << 20,
                 err_inject: bytes = b"ERROR\r\n",
                 inject_capacity: int = 1024,
                 arena_capacity: int = 1 << 20):
        self.arena = ByteArena(arena_capacity)
        self.cap = int(cap_per_conn)
        # Per-framing deny injects (``err_inject`` keeps the historic
        # ctor override for the CRLF lane's template).
        self._err = {k: f.err_inject for k, f in FRAMINGS.items()}
        self._err[FRAMING_CRLF] = bytes(err_inject)
        self.inject_capacity = int(inject_capacity)
        # Truncation templates per framing: enough repeats to cover the
        # per-entry inject cap, sliced per entry (matches the scalar
        # engine's byte-exact mid-pattern truncation at the capacity).
        self._err_tpls: dict[str, np.ndarray] = {}
        self.rounds = 0
        self.entries = 0
        self.frames = 0
        self.overflows = 0
        # Lane engagement per framing kind — the status surface the
        # non-CRLF smoke gates on (a silent scalar fallback reads 0).
        self.rounds_by_framing: dict[str, int] = {}

    def _tpl_for(self, kind: str) -> np.ndarray:
        tpl = self._err_tpls.get(kind)
        if tpl is None:
            err = np.frombuffer(self._err.get(kind, b""), np.uint8)
            reps = self.inject_capacity // max(len(err), 1) + 1
            tpl = np.tile(err, max(reps, 1)) if len(err) else err
            self._err_tpls[kind] = tpl
        return tpl

    def ingest(self, conn_ids, data_starts, data_lens,
               blob: np.ndarray,
               framing: Framing | None = None) -> ReasmRound:
        """Append one round's payloads to their conns' carries, find
        every completed frame under ``framing`` (default CRLF), and
        persist the residues — all as array passes.  ``conn_ids`` must
        be unique within the round (the service taints duplicate conns
        to the scalar lane)."""
        framing = framing or FRAMINGS[FRAMING_CRLF]
        conn_ids = np.asarray(conn_ids, np.int64)
        data_starts = np.asarray(data_starts, np.int64)
        data_lens = np.asarray(data_lens, np.int64)
        n = len(conn_ids)
        rnd = ReasmRound()
        rnd.n = n
        rnd.conn_ids = conn_ids
        arena = self.arena
        slots = arena.ensure_slots(conn_ids)
        rnd.slots = slots
        dead = arena.s_dead[slots].astype(bool)
        carry_off, carry_len = arena.carry(slots)
        carry_len = carry_len.copy()
        total = carry_len + data_lens
        over = (~dead) & (total > self.cap) if self.cap else (
            np.zeros(n, bool)
        )
        live = ~(dead | over)
        rnd.dead = dead
        rnd.over = over
        rnd.live = live
        rnd.over_total = np.where(over, total, 0)
        if over.any():
            arena.mark_dead(slots[over])
            self.overflows += int(over.sum())
        # Round stream = [carry_i][payload_i] per live entry.
        l_cl = np.where(live, carry_len, 0)
        l_dl = np.where(live, data_lens, 0)
        tot = l_cl + l_dl
        entry_end = np.cumsum(tot)
        entry_off = entry_end - tot
        stream = np.empty(int(entry_end[-1]) if n else 0, np.uint8)
        gather_segments(arena.buf, carry_off, l_cl, out=stream,
                        dst_starts=entry_off)
        gather_segments(blob, data_starts, l_dl, out=stream,
                        dst_starts=entry_off + l_cl)
        rnd.stream = stream
        rnd.entry_off = entry_off
        rnd.entry_end = entry_end
        rnd.framing = framing
        # Frame boundaries + per-entry residue, columnar.  The framing
        # contract (Framing.scan): frames sorted by entry then stream
        # order and contiguous from each entry's offset, so the residue
        # of a framed entry starts where its LAST frame ends.
        e_of, f_start, f_len = framing.scan(stream, entry_off, entry_end)
        nf = len(e_of)
        first = np.ones(nf, bool)
        if nf:
            first[1:] = e_of[1:] != e_of[:-1]
        rnd.f_entry = e_of
        rnd.f_start = f_start
        rnd.f_len = f_len
        rnd.n_frames = np.bincount(e_of, minlength=n).astype(np.int64)
        res_start = entry_off.copy()
        gb = np.flatnonzero(first)
        ge = np.concatenate((gb[1:], [nf])) - 1 if nf else gb
        rnd._gb = gb
        rnd._ge = ge
        if nf:
            res_start[e_of[gb]] = f_start[ge] + f_len[ge]
        res_len = entry_end - res_start
        rnd.res_len = res_len
        rnd.more = (rnd.n_frames > 0) | (res_len > 0)
        # TRANSACTIONAL commit point: everything above (including the
        # framing scan, the raise-capable pluggable hook) ran on the
        # round-local stream without touching the live carries, so a
        # scan crash leaves every carry intact and the service can
        # exit the whole group to the scalar rung with zero byte
        # loss.  Only now are the consumed carries retired and the
        # residues stored back.
        arena.consume(slots[live])
        arena.store(slots[live], stream, res_start[live], res_len[live])
        self.rounds += 1
        self.entries += n
        self.frames += nf
        self.rounds_by_framing[framing.kind] = (
            self.rounds_by_framing.get(framing.kind, 0) + 1
        )
        return rnd

    # -- device-batch packing ---------------------------------------------

    def pack_buckets(self, rnd: ReasmRound, base_width: int,
                     min_bucket: int, remotes_entry: np.ndarray) -> list:
        """Group the round's frames into the SAME power-of-two
        (bucket, width) shapes the scalar async path uses, packed with
        ragged scatters.  Returns ``[(frame_idx, data, lengths,
        remotes)]`` with widths ascending and frames in stream order —
        bit-identical model inputs to the scalar `_issue_slow_async`."""
        msg_len = rnd.f_len
        nf = len(msg_len)
        if nf == 0:
            return []
        ratio = msg_len / float(base_width)
        exps = np.ceil(np.log2(np.maximum(ratio, 1.0))).astype(np.int64)
        widths = base_width << exps
        out = []
        for wv in np.unique(widths):
            fi = np.flatnonzero(widths == wv)
            nb = len(fi)
            f_pad = min_bucket
            while f_pad < nb:
                f_pad *= 2
            data = np.zeros((f_pad, int(wv)), np.uint8)
            dst = np.arange(nb, dtype=np.int64) * int(wv)
            gather_segments(rnd.stream, rnd.f_start[fi], msg_len[fi],
                            out=data.reshape(-1), dst_starts=dst)
            lengths = np.zeros(f_pad, np.int32)
            lengths[:nb] = msg_len[fi]
            remotes = np.zeros(f_pad, np.int32)
            remotes[:nb] = remotes_entry[rnd.f_entry[fi]]
            out.append((fi, data, lengths, remotes))  # lint: disable=R7 -- per width BUCKET (a handful per round), not per entry
        return out

    # -- finish half: columnar ops / injects / records --------------------

    def assemble(self, rnd: ReasmRound, allow_frame: np.ndarray):
        """Render the round's per-entry ops + reply injects as columnar
        arrays, op-for-op identical to the scalar
        ``settle_entry``/``_overflow`` contract:

        - judged frame → ``(PASS msg_len)`` or ``(DROP msg_len)`` with
          the framing's deny inject (``ERROR\\r\\n`` for CRLF, nothing
          for DNS) appended to the reply inject (truncated at the
          per-entry inject capacity);
        - trailing ``(MORE 1)`` when the entry completed frames or left
          residue;
        - cap overflow → ``(DROP carried+incoming), (ERROR code)``,
          flow dead;
        - entry on a dead flow → ``(ERROR code)``.

        Returns ``(op_counts i64[n], ops FILTER_OP[sum], inj_reply_lens
        i64[n], inj_blob u8[sum], n_denied i64[n])``."""
        from . import wire

        n = rnd.n
        op_counts = np.zeros(n, np.int64)
        op_counts[rnd.live] = (
            rnd.n_frames[rnd.live] + rnd.more[rnd.live]
        )
        op_counts[rnd.over] = 2
        op_counts[rnd.dead] = 1
        total_ops = int(op_counts.sum())
        op_off = np.concatenate(
            ([0], np.cumsum(op_counts))
        )[:-1].astype(np.int64)
        ops = np.zeros(total_ops, wire.FILTER_OP)
        nf = len(rnd.f_entry)
        if nf:
            counts = np.diff(np.concatenate((rnd._gb, [nf])))
            ordinal = np.arange(nf, dtype=np.int64) - np.repeat(
                rnd._gb, counts
            )
            fpos = op_off[rnd.f_entry] + ordinal
            ops["op"][fpos] = np.where(allow_frame, OP_PASS, OP_DROP)
            ops["n_bytes"][fpos] = rnd.f_len
        m_idx = np.flatnonzero(rnd.live & rnd.more)
        if len(m_idx):
            mpos = op_off[m_idx] + rnd.n_frames[m_idx]
            ops["op"][mpos] = OP_MORE
            ops["n_bytes"][mpos] = 1
        o_idx = np.flatnonzero(rnd.over)
        if len(o_idx):
            ops["op"][op_off[o_idx]] = OP_DROP
            ops["n_bytes"][op_off[o_idx]] = rnd.over_total[o_idx]
            ops["op"][op_off[o_idx] + 1] = OP_ERROR
            ops["n_bytes"][op_off[o_idx] + 1] = ERR_FRAME_LEN
        d_idx = np.flatnonzero(rnd.dead)
        if len(d_idx):
            ops["op"][op_off[d_idx]] = OP_ERROR
            ops["n_bytes"][op_off[d_idx]] = ERR_FRAME_LEN
        # Reply injects: one framing deny-inject per denied frame,
        # byte-exact truncation at the per-entry capacity.
        n_denied = np.bincount(
            rnd.f_entry[~allow_frame] if nf else np.empty(0, np.int64),
            minlength=n,
        ).astype(np.int64)
        kind = getattr(rnd.framing, "kind", FRAMING_CRLF)
        err_tpl = self._tpl_for(kind)
        err_n = len(self._err.get(kind, b""))
        inj_len = np.minimum(n_denied * err_n, self.inject_capacity)
        total_inj = int(inj_len.sum())
        inj_blob = np.empty(total_inj, np.uint8)
        inj_off = np.concatenate(
            ([0], np.cumsum(inj_len))
        )[:-1].astype(np.int64)
        gather_segments(err_tpl, np.zeros(n, np.int64), inj_len,
                        out=inj_blob, dst_starts=inj_off)
        return op_counts, ops, inj_len, inj_blob, n_denied

    def last_rules(self, rnd: ReasmRound,
                   rule_frame: np.ndarray) -> np.ndarray:
        """Per-entry rule of the LAST judged frame (-1 where the entry
        completed no frame) — the columnar analog of the scalar
        ``FlowState.last_rule_id`` stamp `_engine_rule_kind` reads."""
        out = np.full(rnd.n, -1, np.int32)
        nf = len(rnd.f_entry)
        if nf:
            out[rnd.f_entry[rnd._gb]] = rule_frame[rnd._ge]
        return out

    def entry_ops(self, rnd: ReasmRound, op_counts, ops, inj_len,
                  inj_blob, i: int):
        """Materialize ONE entry's response tuple (scalar-shape
        fallback for op-capacity splitting and mixed-lane merges)."""
        off = int(np.sum(op_counts[:i]))
        cnt = int(op_counts[i])
        io = int(np.sum(inj_len[:i]))
        il = int(inj_len[i])
        return (
            [(int(o["op"]), int(o["n_bytes"]))
             for o in ops[off : off + cnt]],
            inj_blob[io : io + il].tobytes(),
        )

    def status(self) -> dict:
        return {
            "rounds": self.rounds,
            "rounds_by_framing": dict(self.rounds_by_framing),
            "entries": self.entries,
            "frames": self.frames,
            "overflows": self.overflows,
            "arena": self.arena.status(),
        }
