"""Connection-tracking table with TCP state and garbage collection.

A copy of ``cilium_tpu/maps/ctmap.py`` (it has no JAX in it).

reference: bpf/lib/conntrack.h (5-tuple CT with per-direction TCP flag
tracking, lifetime refresh) + pkg/maps/ctmap (dump/GC runner).  The table
is host-authoritative; the batched device lookup answers "is this flow
established" for replay/analysis workloads in one [F, N] sweep.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

import numpy as np

# Tuple flags (reference: pkg/maps/ctmap/ctmap.go:74-78).
TUPLE_F_OUT = 0
TUPLE_F_IN = 1
TUPLE_F_RELATED = 2
TUPLE_F_SERVICE = 4

# Lifetimes in seconds (reference: bpf/lib/conntrack.h:31-50).
CT_STATE_UNKNOWN = 0  # flowlog ct_state codes (flowlog/record.CT_NAMES)
CT_STATE_NEW = 1
CT_STATE_ESTABLISHED = 2

CT_DEFAULT_LIFETIME = 21600  # TCP, 6 hours
CT_DEFAULT_LIFETIME_NONTCP = 60
TCP_CLOSING_LIFETIME = 10  # CT_DEFAULT_CLOSE_TIMEOUT

PROTO_TCP = 6
PROTO_UDP = 17

# Packed tuple layout (reference: bpf/lib/common.h:359-367 ipv4_ct_tuple).
_TUPLE4_FMT = "<IIHHBB"
TUPLE4_SIZE = struct.calcsize(_TUPLE4_FMT)  # 14 (packed)

# reference: bpf/lib/common.h ipv6_ct_tuple (two 16-byte addresses).
_TUPLE6_FMT = "<16s16sHHBB"
TUPLE6_SIZE = struct.calcsize(_TUPLE6_FMT)  # 38 (packed)


@dataclass(frozen=True)
class CtKey4:
    """IPv4 CT tuple (reference: common.h ipv4_ct_tuple)."""

    daddr: int
    saddr: int
    dport: int
    sport: int
    nexthdr: int
    flags: int = TUPLE_F_OUT

    def pack(self) -> bytes:
        return struct.pack(
            _TUPLE4_FMT, self.daddr, self.saddr, self.dport, self.sport,
            self.nexthdr, self.flags,
        )


@dataclass(frozen=True)
class CtKey6:
    """IPv6 CT tuple (reference: common.h ipv6_ct_tuple).  Addresses
    are 128-bit ints; the device table splits them into four 32-bit
    words with the same word order as ops/lpm.ipv6_to_words."""

    daddr: int
    saddr: int
    dport: int
    sport: int
    nexthdr: int
    flags: int = TUPLE_F_OUT

    def pack(self) -> bytes:
        return struct.pack(
            _TUPLE6_FMT,
            self.daddr.to_bytes(16, "big"), self.saddr.to_bytes(16, "big"),
            self.dport, self.sport, self.nexthdr, self.flags,
        )

    @staticmethod
    def words(addr: int) -> tuple[int, int, int, int]:
        return tuple(
            (addr >> (128 - 32 * (w + 1))) & 0xFFFFFFFF for w in range(4)
        )


@dataclass
class CtEntry:
    """reference: bpf/lib/common.h:380-401 ct_entry."""

    rx_packets: int = 0
    rx_bytes: int = 0
    tx_packets: int = 0
    tx_bytes: int = 0
    lifetime: int = 0  # absolute expiry, seconds
    rx_closing: bool = False
    tx_closing: bool = False
    seen_non_syn: bool = False
    rev_nat_index: int = 0
    slave: int = 0
    tx_flags_seen: int = 0
    rx_flags_seen: int = 0
    src_sec_id: int = 0

    @property
    def closing(self) -> bool:
        return self.rx_closing or self.tx_closing


# TCP flag bits
TCP_FIN = 0x01
TCP_SYN = 0x02
TCP_RST = 0x04
TCP_ACK = 0x10


class CtMap:
    """Host conntrack table (reference: pkg/maps/ctmap + lib/conntrack.h)."""

    def __init__(self, max_entries: int = 65536, clock=time.monotonic) -> None:
        self.entries: dict[CtKey4, CtEntry] = {}
        self.max_entries = max_entries
        self.clock = clock

    def _lifetime_for(self, proto: int, closing: bool) -> int:
        if closing:
            return TCP_CLOSING_LIFETIME
        return CT_DEFAULT_LIFETIME if proto == PROTO_TCP else (
            CT_DEFAULT_LIFETIME_NONTCP
        )

    def create(self, key: CtKey4, src_sec_id: int = 0,
               rev_nat_index: int = 0, slave: int = 0) -> CtEntry:
        """reference: conntrack.h ct_create4."""
        if key in self.entries:
            # Re-establishing an existing flow needs no new slot.
            pass
        elif len(self.entries) >= self.max_entries:
            # Emergency GC then retry once (reference agent behavior).
            self.gc()
            if len(self.entries) >= self.max_entries:
                raise OverflowError("CT table full")
        e = CtEntry(
            lifetime=int(self.clock()) + self._lifetime_for(key.nexthdr, False),
            src_sec_id=src_sec_id,
            rev_nat_index=rev_nat_index,
            slave=slave,
        )
        self.entries[key] = e
        return e

    def lookup(self, key: CtKey4, tcp_flags: int = 0,
               is_reply: bool = False) -> CtEntry | None:
        """Lookup + lifetime refresh + TCP state update
        (reference: conntrack.h ct_lookup4/__ct_lookup)."""
        e = self.entries.get(key)
        if e is None:
            return None
        now = int(self.clock())
        if e.lifetime < now:
            del self.entries[key]
            return None
        if key.nexthdr == PROTO_TCP:
            if tcp_flags & (TCP_FIN | TCP_RST):
                if is_reply:
                    e.rx_closing = True
                else:
                    e.tx_closing = True
            if not (tcp_flags & TCP_SYN):
                e.seen_non_syn = True
            if is_reply:
                e.rx_flags_seen |= tcp_flags
            else:
                e.tx_flags_seen |= tcp_flags
        if is_reply:
            e.rx_packets += 1
        else:
            e.tx_packets += 1
        e.lifetime = now + self._lifetime_for(key.nexthdr, e.closing)
        return e

    def gc(self, filter_fn=None) -> int:
        """Remove expired entries (+ entries matching filter_fn); returns
        number deleted (reference: ctmap.go doGC4)."""
        now = int(self.clock())
        dead = [
            k for k, e in self.entries.items()
            if e.lifetime < now or (filter_fn is not None and filter_fn(k, e))
        ]
        for k in dead:
            del self.entries[k]
        return len(dead)

    def flush(self) -> int:
        n = len(self.entries)
        self.entries.clear()
        return n

    def dump(self) -> list[tuple[CtKey4, CtEntry]]:
        """Human-ordered dump (reference: ctmap.go:240 DumpToSlice)."""
        return sorted(
            self.entries.items(),
            key=lambda kv: (kv[0].daddr, kv[0].saddr, kv[0].dport, kv[0].sport),
        )

    @staticmethod
    def state_codes(established) -> np.ndarray:
        """[F] int8 flowlog ct_state codes from a pipeline batch's
        ``established`` column: the CT half of a flow record (a verdict
        on an established flow was admitted at connect time, reference:
        handle_ipv4 CT_ESTABLISHED path)."""
        est = np.asarray(established)
        return np.where(
            est, CT_STATE_ESTABLISHED, CT_STATE_NEW
        ).astype(np.int8)

    def to_device_arrays(self):
        """Export tuples as column arrays for batched established-checks."""
        n = max(len(self.entries), 1)
        cols = np.zeros((5, n), np.int64)
        valid = np.zeros((n,), bool)
        for i, k in enumerate(self.entries):
            cols[:, i] = (k.daddr, k.saddr, k.dport, k.sport, k.nexthdr)
            valid[i] = True
        return cols, valid
