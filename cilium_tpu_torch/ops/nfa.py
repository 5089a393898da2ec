"""Batched multi-pattern NFA search: kernel K3 and its plain version.

Counterpart of ``cilium_tpu/ops/nfa.py``, the fallback automaton when a
pattern's DFA exceeds the 128-state guard.  The union NFA's transition
relation is uploaded as state bitsets: ``delta_bits[c, s]`` holds the W =
ceil(S/32) words of states reachable from state ``s`` on byte class ``c``;
K3 reads those rows up to 256 states and, past that, their near form
(``near_rows``) with the sparse one (``sparse_rows``), built beside them.  On a CUDA tensor
``nfa_search_spans`` launches ``csrc/nfa_scan.cu``, on a CPU tensor it
runs ``nfa_scan_plain``, and on anything else it raises.  An NFA of more
states than one thread's registers hold (MAX_STATES) is cut into parts
(``split_parts``), one launch a part; a block that no cut brings down to
MAX_STATES is a part of its own, which K3 scans in its wide form (a warp a
flow, up to WIDE_STATES).  The plain scan walks any state count.
"""

from __future__ import annotations

import bisect
import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..regex.tables import NfaTables

# K3's one-thread-a-flow forms keep the state set in at most 32 registers
# of 32 bits (csrc/nfa_scan.cu kMaxWords); its wide form, a warp a flow,
# up to 128 words (kWideWords): the reference's regex.nfa.MAX_STATES.
MAX_STATES = 32 * 32
WIDE_STATES = 128 * 32

_NFA_SCAN = kernels.CudaKernel(
    "nfa_scan", "nfa_scan",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)


@dataclass
class DeviceNfa:
    """Packed NFA tables resident on one device; every ``*_bits`` tensor
    holds state sets as int32 words (bit s%32 of word s//32)."""

    classmap: torch.Tensor  # [256] uint8
    delta_bits: torch.Tensor  # [C, S, W] int32
    start_bits: torch.Tensor  # [W] int32
    accept_bits: torch.Tensor  # [R, W] int32 — sticky accept
    accept_final_bits: torch.Tensor  # [R, W] int32 — accept | via END
    n_classes: int
    n_states: int
    n_patterns: int
    # K3's other forms of delta_bits (``near_rows``, ``sparse_rows``; the
    # kernel walks them where the dense rows are too large for shared
    # memory) and the union of the accept sets, built here, so every
    # builder and every copy to another device has them.
    scan_near: torch.Tensor = field(init=False, repr=False)  # [C*S, 2] int32
    scan_far: torch.Tensor = field(init=False, repr=False)  # [C, W] int32
    scan_rows: torch.Tensor = field(init=False, repr=False)  # [C*S, 2] int32
    scan_targets: torch.Tensor = field(init=False, repr=False)  # [E + 1] int16
    scan_has: torch.Tensor = field(init=False, repr=False)  # [C, W] int32
    scan_any: torch.Tensor = field(init=False, repr=False)  # [2, W] int32
    # Past MAX_STATES states, K3's launches: (part, pattern columns) pairs
    # (``split_parts``); empty where one launch takes the whole NFA.
    scan_parts: list = field(init=False, repr=False)

    def __post_init__(self):
        self.scan_near, self.scan_far = near_rows(self.delta_bits, self.n_states)
        self.scan_rows, self.scan_targets, self.scan_has = sparse_rows(
            self.delta_bits, self.n_states)
        # the union of every pattern's accept (row 0) and accept_final (row 1)
        w = 32 * self.delta_bits.shape[2]
        self.scan_any = _words(torch.stack([
            unpack_bits(self.accept_bits, w).any(0),
            unpack_bits(self.accept_final_bits, w).any(0),
        ]))
        self.scan_parts = split_parts(self) if self.n_states > MAX_STATES else []

    @property
    def device(self) -> torch.device:
        return self.delta_bits.device


def _words(bits: torch.Tensor) -> torch.Tensor:
    """Bool [..., 32 W] -> int32 words [..., W] (bit s % 32 of word s // 32)."""
    w = bits.reshape(*bits.shape[:-1], -1, 32).long()
    v = (w << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """Bool [..., S] -> int32 words [..., ceil(S/32)]."""
    pad = -bits.shape[-1] % 32
    if pad:
        bits = torch.cat([bits, bits.new_zeros((*bits.shape[:-1], pad))], -1)
    return _words(bits)


def split_parts(nfa: DeviceNfa) -> list:
    """K3's launches for an NFA of more than MAX_STATES states: (part,
    columns) pairs, each part the NFA on a range of states that no edge
    and no pattern's accept set crosses, with the patterns that accept in
    that range as its columns of the [F, R] result (a pattern that accepts
    nowhere goes to the first part; a range where none accepts is left
    out).  Cut so, a part's state set is the whole one's on its range at
    every step, so its launch gives those columns exactly.  The union of
    separately compiled patterns (``regex.tables.compile_patterns``) cuts
    between any two of them.  Parts hold at most MAX_STATES states where
    a cut allows it; a block of more that no cut divides (one long
    bounded repetition) is a part of its own, which K3 scans in its wide
    form.  Empty where that block holds every pattern that accepts: the
    whole NFA is then one launch of the wide form."""
    s, r, dev = nfa.n_states, nfa.n_patterns, nfa.device
    delta = unpack_bits(nfa.delta_bits, s).cpu()  # [C, S, S]
    acc = (unpack_bits(nfa.accept_bits, s) | unpack_bits(nfa.accept_final_bits, s)).cpu()
    src, dst = torch.nonzero(delta.any(0), as_tuple=True)
    has = acc.any(1)
    first = acc.to(torch.int8).argmax(1)
    last = s - 1 - acc.flip(1).to(torch.int8).argmax(1)
    # a cut k (states < k | states >= k) is crossed by a pair (lo, hi)
    # where lo < k <= hi
    lo = torch.cat([torch.minimum(src, dst), first[has]])
    hi = torch.cat([torch.maximum(src, dst), last[has]])
    cross = torch.zeros(s + 2, dtype=torch.int64)
    cross.index_add_(0, lo + 1, torch.ones_like(lo))
    cross.index_add_(0, hi + 1, -torch.ones_like(hi))
    cuts = torch.nonzero(torch.cumsum(cross, 0)[: s + 1] == 0).flatten().tolist()
    bounds, a = [], 0
    while a < s:
        b = cuts[bisect.bisect_right(cuts, a + MAX_STATES) - 1]
        if b <= a:  # no cut within MAX_STATES: the block up to the next cut
            b = cuts[bisect.bisect_right(cuts, a)]
        bounds.append((a, b))
        a = b
    starts = [lo_ for lo_, _ in bounds]
    owner = [bisect.bisect_right(starts, int(first[p])) - 1 if has[p] else 0 for p in range(r)]
    start = unpack_bits(nfa.start_bits, s).cpu()
    acc_s = unpack_bits(nfa.accept_bits, s).cpu()
    fin_s = unpack_bits(nfa.accept_final_bits, s).cpu()
    plan = [(a, b, cols) for i, (a, b) in enumerate(bounds)
            if (cols := [p for p in range(r) if owner[p] == i])]
    if len(plan) == 1 and plan[0][1] - plan[0][0] > MAX_STATES and s <= WIDE_STATES:
        return []  # one block in the wide form: the whole NFA is the launch
    parts = []
    for a, b, cols in plan:
        idx = torch.tensor(cols)
        part = DeviceNfa(
            classmap=nfa.classmap,
            delta_bits=_pack_words(delta[:, a:b, a:b]).to(dev),
            start_bits=_pack_words(start[a:b]).to(dev),
            accept_bits=_pack_words(acc_s[idx, a:b]).to(dev),
            accept_final_bits=_pack_words(fin_s[idx, a:b]).to(dev),
            n_classes=nfa.n_classes,
            n_states=b - a,
            n_patterns=len(cols),
        )
        parts.append((part, idx.to(dev)))
    return parts


def near_rows(delta_bits: torch.Tensor, s: int):
    """K3's near form of the transition relation, on delta_bits' device.

    near [C*S, 2] int32: row (c, s)'s words j and j + 1 (j = s // 32; the
    second zero past the last word); far [C, W] int32: bit s of row c set
    where state s has a target on class c in any other word (the kernel
    walks those through ``sparse_rows``)."""
    c, _, w = delta_bits.shape
    dev = delta_bits.device
    rows = delta_bits[:, :s]  # [C, S, W]
    j = torch.arange(s, device=dev) // 32
    nxt = torch.cat([rows, rows.new_zeros((c, s, 1))], dim=2)  # word W reads zero
    lo = torch.gather(nxt, 2, j.expand(c, s)[..., None])[..., 0]
    hi = torch.gather(nxt, 2, (j + 1).expand(c, s)[..., None])[..., 0]
    k = torch.arange(w, device=dev)
    other = (k[None, :] != j[:, None]) & (k[None, :] != j[:, None] + 1)  # [S, W]
    far = torch.zeros((c, 32 * w), dtype=torch.bool, device=dev)
    far[:, :s] = ((rows != 0) & other[None]).any(2)
    return torch.stack([lo, hi], 2).reshape(c * s, 2).contiguous(), _words(far)


def sparse_rows(delta_bits: torch.Tensor, s: int):
    """K3's form of the transition relation, on delta_bits' device.

    rows [C*S, 2] int32: for row (c, s), the offset of its targets in
    ``targets`` and (count | first target << 16), so a row with one
    target needs no second read; targets [E + 1] int16, each row's in
    ascending order, then a zero; has [C, W] int32: bit s of row c set
    where state s has a target on class c.  Exactly the relation of
    delta_bits."""
    c, _, w = delta_bits.shape
    dense = unpack_bits(delta_bits, s).reshape(c * s, s)
    count = dense.sum(1).to(torch.int64)
    begin = torch.cumsum(count, 0) - count
    # one zero past the last target: begin == E for trailing empty rows
    tgt = torch.cat([torch.nonzero(dense)[:, 1], count.new_zeros(1)])
    first = torch.where(count > 0, tgt[begin], 0)
    rows = torch.stack([begin, count | (first << 16)], 1).to(torch.int32)
    has = torch.zeros((c, 32 * w), dtype=torch.bool, device=delta_bits.device)
    has[:, :s] = (count > 0).reshape(c, s)
    return rows, tgt.to(torch.int16), _words(has)


def pack_bits(sets: np.ndarray) -> np.ndarray:
    """Bool [..., S] -> int32 words [..., ceil(S/32)]."""
    sets = np.asarray(sets, bool)
    s = sets.shape[-1]
    w = max(1, (s + 31) // 32)
    padded = np.zeros(sets.shape[:-1] + (w * 32,), bool)
    padded[..., :s] = sets
    return np.packbits(
        padded.reshape(sets.shape[:-1] + (w, 32)), axis=-1, bitorder="little"
    ).view("<u4")[..., 0].view(np.int32)


def unpack_bits(words: torch.Tensor, s: int) -> torch.Tensor:
    """int32 words [..., W] -> bool [..., S]."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :s].bool()


def nfa_from_dense(classmap, delta, start, accept, accept_final, device=None) -> DeviceNfa:
    """Upload dense numpy tables: classmap [256], delta [C, S, S] 0/1,
    start [S], accept and accept_final [R, S]; ``device=None`` is the
    card."""
    device = resolve_device(device)
    c, s, s2 = delta.shape
    if s != s2:
        raise ValueError("delta must be [C, S, S]")
    classmap = np.asarray(classmap)
    if classmap.shape != (256,) or classmap.min() < 0 or classmap.max() >= c:
        raise ValueError("classmap must map 256 bytes to classes < C")
    accept = np.asarray(accept, bool)

    def up(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return DeviceNfa(
        classmap=up(classmap, np.uint8),
        delta_bits=up(pack_bits(np.asarray(delta) != 0), np.int32),
        start_bits=up(pack_bits(start), np.int32),
        accept_bits=up(pack_bits(accept), np.int32),
        accept_final_bits=up(pack_bits(accept_final), np.int32),
        n_classes=c,
        n_states=s,
        n_patterns=accept.shape[0],
    )


def device_nfa(tables: NfaTables, device=None) -> DeviceNfa:
    """Upload packed host tables to ``device``."""
    return nfa_from_dense(
        tables.classmap, tables.delta, tables.start, tables.accept,
        tables.accept_final, device,
    )


def nfa_scan_plain(nfa: DeviceNfa, data, span_start, span_end) -> torch.Tensor:
    """Plain PyTorch version of K3: [F, R] bool.  One boolean matrix
    product per (byte position, class present)."""
    f, l = data.shape
    s = nfa.n_states
    delta = unpack_bits(nfa.delta_bits, s).float()  # [C, S, S]
    state = unpack_bits(nfa.start_bits, s)[None, :].expand(f, -1).clone()
    seen = state.clone()
    cls = nfa.classmap.long()[data.long()]  # [F, L]
    t_end = min(l, int(span_end.max())) if f else 0
    for t in range(t_end):
        active = (t >= span_start) & (t < span_end)
        nxt = torch.zeros_like(state)
        for c in torch.unique(cls[active, t]).tolist():
            rows = torch.nonzero(active & (cls[:, t] == c)).squeeze(1)
            nxt[rows] = (state[rows].float() @ delta[c]) > 0
        state = torch.where(active[:, None], nxt, state)
        seen |= state
    accept = unpack_bits(nfa.accept_bits, s).float()
    accept_final = unpack_bits(nfa.accept_final_bits, s).float()
    return ((seen.float() @ accept.T) > 0) | ((state.float() @ accept_final.T) > 0)


def nfa_search_spans(nfa: DeviceNfa, data, span_start, span_end) -> torch.Tensor:
    """Search each pattern within ``data[f, span_start[f]:span_end[f]]``.

    data: [F, L] uint8; span bounds: [F] int32; all on the tables' device.
    Returns [F, R] bool.  Empty spans (start >= end) match the patterns
    that match the empty string."""
    device = nfa.device
    kernels.check(data, "data", torch.uint8, (None, None), device)
    f, l = data.shape
    kernels.check(span_start, "span_start", torch.int32, (f,), device)
    kernels.check(span_end, "span_end", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return nfa_scan_plain(nfa, data, span_start, span_end)
    r = nfa.n_patterns
    out = torch.empty((f, r), dtype=torch.bool, device=device)
    if f == 0 or r == 0:
        return out
    if nfa.scan_parts:
        for part, cols in nfa.scan_parts:
            out.index_copy_(1, cols, nfa_search_spans(part, data, span_start, span_end))
        return out
    p = kernels.p
    _NFA_SCAN.launch(
        device, p(data), p(span_start), p(span_end), p(nfa.classmap), p(nfa.delta_bits),
        p(nfa.scan_near), p(nfa.scan_far), p(nfa.scan_rows), p(nfa.scan_targets),
        p(nfa.scan_has), p(nfa.start_bits), p(nfa.accept_bits), p(nfa.accept_final_bits),
        p(nfa.scan_any), f, l, r, nfa.n_states, nfa.n_classes, p(out),
    )
    return out


def nfa_search_batch(nfa: DeviceNfa, data, lengths) -> torch.Tensor:
    """Search each pattern in ``data[f, :lengths[f]]``; [F, R] bool."""
    return nfa_search_spans(nfa, data, torch.zeros_like(lengths), lengths)
