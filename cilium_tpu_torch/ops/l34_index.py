"""Hashed indexes of the L3/L4 tables that K12-K15 probe.

The reference compares every packet with every table row (an [F, N]
broadcast compare, a TPU choice: ``cilium_tpu/ops/maplookup.py:1-12``).
On the card K12 (``csrc/lpm.cu``), K13 (``csrc/l34_tables.cu``), K14
(``csrc/datapath.cu``) and K15 (``csrc/ingress.cu``) probe these indexes
instead (``csrc/l34_index.cuh``): a lookup reads one bucket's bounds and
the rows of that bucket, not every row.

Every index is bucketed (CSR): a valid row's key hashes (``hash32``, the
same arithmetic as the kernels') to bucket ``h & (B - 1)``, with B the
least power of two of at least twice the table's N rows; the rows are
ordered by a stable sort on the bucket, so a bucket keeps its rows in
table order (duplicate keys included: exact lookups sum every matched
row, the LB takes the first); ``bounds[b]`` is bucket b's (first, end)
slot, one 8-byte load; a slot is one row's key with what the kernel
reads beside it, row-major and padded to 4, 8 or 16 words so that a
probe reads whole 16-byte chunks.  The M indexed rows' slots come first,
then N + 1 - M zero slots (the rows not indexed, and one more), so a
kernel may load a bucket's first slot before it knows the bucket is not
empty.

- ``exact_index``: key columns, ``nv`` value columns, the row id.
- ``lb_index``: the service key (VIP words, port) and the row id.
- ``lpm_index``: rows grouped by their mask tuple (``lpm_from_arrays``
  takes masks and prefix lengths apart, so a group is not a prefix
  length); the key is (group, masked words), the slot (group, words,
  score, value) with score = plen + 1 wrapped in int32.  ``groups`` lists
  each group's best score and masks, best first, and is zero past the
  last group (N + 2 rows, so at least two zero rows end it).  Rows that can never be selected are left out: invalid ones, ones
  whose word has bits outside its mask, and ones whose score is <= 0.

Indexes are built with torch ops on the table's device when the table is
made (``DeviceTable`` / ``DeviceLpm`` / ``_DeviceLb.__post_init__``; a
snapshot of several tables gathers theirs), never at a launch: a
CUDA-graph capture must not meet a build.  No step
of a build waits for the device (every size comes from N, none from a
count on the device), so a table rebuilt on the card costs its launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import kernels

M32 = 0xFFFFFFFF
GROUP_WORDS = 8  # a group row: best score, four masks, padding


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c, with no
    product past 2^49 (int64 never overflows)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def hash32(words) -> torch.Tensor:
    """MurmurHash3 (x86, 32 bits, seed 0) of each row's key words: the
    little-endian bytes of ``words`` (a sequence of K equal-shaped int
    tensors, int32 bit patterns).  Returns int64 values in [0, 2^32);
    ``csrc/l34_index.cuh`` ``hash_key`` computes the same in uint32."""
    k = torch.stack([w.to(torch.int64) for w in words]) & M32
    k = _mul32(_rotl(_mul32(k, 0xCC9E2D51), 15), 0x1B873593)  # every word's block at once
    h = None
    for i in range(len(words)):
        h = k[i] if h is None else h ^ k[i]
        h = (_rotl(h, 13) * 5 + 0xE6546B64) & M32
    h = h ^ (4 * len(words))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


SLOT_MAX = 16  # the widest slot, in words


def slot_words(used: int) -> int:
    """Words of a slot holding ``used`` words: 4, 8 or 16 (whole 16-byte
    loads; ``l34_index.cuh`` ``slot_words``)."""
    for s in (4, 8, SLOT_MAX):
        if used <= s:
            return s
    raise ValueError(f"a slot of {used} words is wider than 16")


def buckets_for(n: int) -> int:
    """B: the least power of two of at least 2n (1 for an empty index)."""
    return 1 if n == 0 else 1 << (2 * n - 1).bit_length()


class HashIx(ctypes.Structure):
    """``struct HashIx`` of ``csrc/l34_index.cuh``."""

    _fields_ = [("bounds", ctypes.c_void_p), ("slots", ctypes.c_void_p),
                ("mask", ctypes.c_int), ("width", ctypes.c_int)]


class LpmIx(ctypes.Structure):
    """``struct LpmIx`` of ``csrc/l34_index.cuh``."""

    _fields_ = [("h", HashIx), ("groups", ctypes.c_void_p)]


@dataclass
class HashIndex:
    """bounds [B, 2] int32 (first, end slot of each bucket), slots [N + 1,
    S] int32 (the M indexed rows, then zeros)."""

    bounds: torch.Tensor
    slots: torch.Tensor

    @property
    def buckets(self) -> int:
        return self.bounds.shape[0]

    @property
    def m(self) -> int:
        """Rows indexed (read from the device)."""
        return int(self.bounds[-1, 1])

    @property
    def width(self) -> int:
        return self.slots.shape[1]

    def abi(self) -> HashIx:
        return HashIx(kernels.p(self.bounds), kernels.p(self.slots), self.buckets - 1, self.width)


@dataclass
class LpmIndex:
    """groups [N + 2, 8] int32 (best score, masks; best first; zero past
    the last group) and the hashed (group, masked words) rows."""

    groups: torch.Tensor
    table: HashIndex

    @property
    def n_groups(self) -> int:
        """Mask groups (read from the device)."""
        return int((self.groups[:, 0] > 0).sum())

    def abi(self) -> LpmIx:
        return LpmIx(self.table.abi(), kernels.p(self.groups))


def nbytes(obj) -> int:
    """Bytes of every tensor an index (or a set of them) holds."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return sum(nbytes(v) for v in vars(obj).values())


def _csr(keep: torch.Tensor, h: torch.Tensor, payload: torch.Tensor, width: int) -> HashIndex:
    """The bucketed index of the rows where ``keep`` ([N] bool), hashed ``h``
    [N], with ``payload`` [N, P] int32 (P <= width) as their slots.  No
    step waits for the device: B is sized from N, the rows not indexed sort
    past the last bucket (bucket B) and their slots are zeroed."""
    n = keep.numel()
    b = buckets_for(n)
    bucket = torch.where(keep, h & (b - 1), b)
    bucket, order = torch.sort(bucket, stable=True)
    cut = torch.searchsorted(bucket, torch.arange(b + 1, device=keep.device))  # bucket starts; cut[B] = M
    slots = torch.zeros((n + 1, width), dtype=torch.int32, device=keep.device)
    slots[:n, :payload.shape[1]] = torch.where(keep[order, None], payload[order], 0)
    return HashIndex(bounds=torch.stack([cut[:-1], cut[1:]], 1).to(torch.int32).contiguous(), slots=slots)


def exact_index(table, nv: int) -> HashIndex:
    """The index of an exact-match ``DeviceTable``: slots (key columns,
    value columns [0, nv), row id)."""
    keys = table.keys
    k, n = keys.shape
    ids = torch.arange(n, dtype=torch.int32, device=keys.device)[:, None]
    payload = torch.cat([keys.t(), table.values[:, :nv], ids], 1)
    return _csr(table.valid, hash32(list(keys)), payload, slot_words(k + nv + 1))


def lb_index(lb) -> HashIndex:
    """The index of a service table (``_DeviceLb``) keyed by (VIP words,
    port): slots (VIP words, port, row id)."""
    cols = [*lb.vip_words, lb.ports]
    s = lb.ports.shape[0]
    ids = torch.arange(s, dtype=torch.int32, device=lb.ports.device)
    payload = torch.stack([*cols, ids], 1)
    return _csr(lb.valid, hash32(cols), payload, slot_words(len(cols) + 1))


def lpm_index(lpm) -> LpmIndex:
    """The index of a prefix table (``DeviceLpm``) grouped by mask tuple.

    The kept rows are grouped with no step that waits for the device: a
    stable sort of the rows on their mask words (last word first) and then
    on kept-first puts each group's rows together, a group starts where the
    masks change, and its best score is a scatter-max; the groups are
    ranked by best score (ties in mask order).  There are at most N groups,
    so the list has N + 2 rows, zero past the last group."""
    device = lpm.device
    w, n = lpm.words.shape
    score = (((lpm.plen.to(torch.int64) + 1 + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)
    clean = ((lpm.words & ~lpm.masks) == 0).all(dim=0)
    keep = lpm.valid & clean & (score > 0)
    order = torch.arange(n, device=device)
    for c in range(w - 1, -1, -1):
        order = order[torch.sort(lpm.masks[c, order], stable=True).indices]
    order = order[torch.sort((~keep[order]).to(torch.int32), stable=True).indices]
    ms, ks = lpm.masks[:, order], keep[order]
    new = ks.clone()
    new[1:] &= (ms[:, 1:] != ms[:, :-1]).any(dim=0)
    lex = torch.where(ks, torch.cumsum(new.to(torch.int64), 0) - 1, n)  # group in mask order; n: not kept
    best = torch.zeros((n + 1,), dtype=torch.int64, device=device).scatter_reduce(
        0, lex, score[order].to(torch.int64), "amax")[:n]
    gmask = torch.zeros((n + 1, w), dtype=torch.int32, device=device)
    gmask[torch.where(new, lex, n)] = ms.t()  # each group's first row; the rest go to spare row n
    rank_order = torch.sort(-best, stable=True).indices  # best first; ids past the last group last
    rank = torch.empty_like(rank_order)
    rank[rank_order] = torch.arange(n, device=device)
    gid = torch.empty((n,), dtype=torch.int32, device=device)
    gid[order] = torch.where(ks, rank[torch.where(ks, lex, 0)], -1).to(torch.int32)
    groups = torch.zeros((n + 2, GROUP_WORDS), dtype=torch.int32, device=device)
    groups[:n, 0] = best[rank_order].to(torch.int32)
    groups[:n, 1:1 + w] = gmask[rank_order]
    payload = torch.cat([gid[:, None], lpm.words.t(), score[:, None], lpm.values[:, None]], 1)
    table = _csr(keep, hash32([gid, *lpm.words]), payload, slot_words(w + 3))
    return LpmIndex(groups=groups, table=table)
