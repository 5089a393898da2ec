"""Batched per-pattern DFA search: kernel K2 and its plain version.

Counterpart of ``cilium_tpu/ops/dfa.py``.  Tables are a plain dataclass of
tensors; on a CUDA tensor ``dfa_search_spans`` launches the hand-written
kernel ``csrc/dfa_scan.cu``, on a CPU tensor it runs ``dfa_scan_plain``,
and on anything else it raises.

Semantics (bit-identical to the reference): accepted starts as
accept(start); a step applies only for ``span_start <= t < span_end``;
accept is sticky after each step; the result is
``accepted | accept_final(state)``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..regex.dfa import DfaBlowupError, DfaTables

# The reference's int8 state ids stop here (cilium_tpu/ops/dfa.py:86);
# keeping the guard keeps the DFA/NFA choice, and match_kinds, equal (K2
# checks it too).
MAX_DFA_DEVICE_STATES = 128

# K2 stages one pattern tile's table in a block's shared memory beside a
# 1 KB class table (csrc/dfa_scan.cu kSmemBudget) and runs at most
# SCAN_KT_MAX patterns a lane.
SCAN_SMEM = 200 * 1024 - 1024
SCAN_KT_MAX = 8

_DFA_SCAN = kernels.CudaKernel(
    "dfa_scan", "dfa_scan",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)


def scan_geometry(r: int, s: int, c: int) -> tuple[int, int, int, int, int]:
    """K2's layout for R patterns of S states and C classes, from the
    shape alone: (g, kt, nc, es, tiles).

    A flow is walked by g lanes of a warp (a power of two, 32 / g flows a
    warp); lane q of the g holds patterns q, q + g, ... (kt of them) of a
    tile of g * kt patterns, and the grid's y index walks the tiles (one
    tile whenever the whole table fits).  Each lane reads its own column
    of nc (a power of two, g <= nc <= 32) interleaved columns: lanes q and
    q + nc share one, so with nc = 32 no two lanes of a warp meet in a
    bank.  An entry is es bytes: 1 while the tile's kt * S rows number at
    most 256, else 2; a state's row in a column is C entries and a flag
    entry (``scan_table``), ceil((C + 1) * es / 4) words."""

    def es(k):
        return 1 if k * s <= 256 else 2

    def fits(cols, k):
        return cols * k * s * -(-(c + 1) * es(k) // 4) * 4 <= SCAN_SMEM

    g = min(32, 1 << max(r - 1, 0).bit_length())
    while g > 1 and not fits(g, 1):
        g //= 2
    kt = min(SCAN_KT_MAX, max(1, -(-r // g)))
    while kt > 1 and not fits(g, kt):
        kt -= 1
    nc = 32
    while nc > g and not fits(nc, kt):
        nc //= 2
    return g, kt, nc, es(kt), -(-r // (g * kt))


def scan_table(delta, accept, accept_final, geom) -> torch.Tensor:
    """K2's tables as one uint8 tensor on delta's device.  Per tile: rows
    of kt * S states (state s of slot j is row j * S + s), each row cq =
    ceil((C + 1) * es / 4) groups of nc columns of one word, the tile
    padded to a multiple of 16 bytes.  Entry [row, c] of a column is the
    target's row, j * S + t, with t = delta[r, s, c], except that an
    accepting s keeps t = s: absorbing accept states make the sticky
    accept a property of the last state (as K18's tables do), with the
    same result for every input.  Entry [row, C] is accept | accept_final
    << 1.  Patterns past R are zero."""
    r, s, c = delta.shape
    g, kt, nc, es, tiles = geom
    epw = 4 // es  # entries a word
    cq = -(-(c + 1) // epw)
    dev = delta.device
    states = torch.arange(s, device=dev)
    tgt = torch.where(accept[:, :, None], states[None, :, None], delta.long())
    rp = tiles * g * kt
    slot = (torch.arange(r, device=dev) // g) % kt  # each pattern's j in its tile
    ent = torch.zeros((rp, s, cq * epw), dtype=torch.int64, device=dev)
    ent[:r, :, :c] = slot[:, None, None] * s + tgt
    ent[:r, :, c] = accept.long() | (accept_final.long() << 1)
    # [tiles, kt, g, S, cq, epw] -> [tiles, kt, S, cq, g, epw], then nc columns
    ent = ent.reshape(tiles, kt, g, s, cq, epw).permute(0, 1, 3, 4, 2, 5)
    ent = ent.reshape(tiles, kt * s * cq, g, epw)[:, :, torch.arange(nc, device=dev) % g]
    # little-endian bytes of each entry
    ent = ent.reshape(tiles, -1, 1) >> (8 * torch.arange(es, device=dev))
    ent = (ent & 0xFF).reshape(tiles, -1)
    ent = torch.cat([ent, ent.new_zeros((tiles, -ent.shape[1] % 16))], dim=1)
    return ent.to(torch.uint8).reshape(-1).contiguous()


@dataclass
class DeviceDfa:
    """Packed per-pattern DFA tables resident on one device."""

    classmap: torch.Tensor  # [256] uint8 — byte -> shared class
    delta: torch.Tensor  # [R, S, C] uint8 — next-state id per (state, class)
    start: torch.Tensor  # [R] uint8
    accept: torch.Tensor  # [R, S] bool — sticky accept states
    accept_final: torch.Tensor  # [R, S] bool — accept | accept-via-END
    n_states: int
    n_classes: int
    n_patterns: int
    # K2's layout and tables (scan_geometry, scan_table), built here, so
    # every builder and every copy to another device has them.
    scan_geom: tuple = field(init=False, repr=False)
    scan_tab: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.scan_geom = scan_geometry(self.n_patterns, self.n_states, self.n_classes)
        self.scan_tab = scan_table(self.delta, self.accept, self.accept_final, self.scan_geom)

    @property
    def device(self) -> torch.device:
        return self.delta.device


def dfa_from_arrays(classmap, delta, start, accept, accept_final, device=None) -> DeviceDfa:
    """Upload numpy tables: classmap [256], delta [R, S, C], start [R],
    accept and accept_final [R, S]; ``device=None`` is the card."""
    device = resolve_device(device)
    r, s, c = delta.shape
    if s > MAX_DFA_DEVICE_STATES:
        # DfaBlowupError (not ValueError) so compile_automaton's 'auto'
        # path falls back to the NFA instead of failing the build.
        raise DfaBlowupError(
            f"DFA state id must fit 7 bits (got {s} states)"
        )
    classmap = np.asarray(classmap)
    delta = np.asarray(delta)
    start = np.asarray(start)
    if classmap.shape != (256,) or classmap.min() < 0 or classmap.max() >= c:
        raise ValueError("classmap must map 256 bytes to classes < C")
    if delta.size and (delta.min() < 0 or delta.max() >= s):
        raise ValueError("delta targets must be state ids < S")
    if start.shape != (r,) or (r and (start.min() < 0 or start.max() >= s)):
        raise ValueError("start must be one state id < S per pattern")

    def up(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return DeviceDfa(
        classmap=up(classmap, np.uint8),
        delta=up(delta, np.uint8),
        start=up(start, np.uint8),
        accept=up(accept, bool),
        accept_final=up(accept_final, bool),
        n_states=s,
        n_classes=c,
        n_patterns=r,
    )


def device_dfa(tables: DfaTables, device=None) -> DeviceDfa:
    """Upload packed host tables to ``device``; raises DfaBlowupError above
    MAX_DFA_DEVICE_STATES states."""
    return dfa_from_arrays(
        tables.classmap, tables.delta, tables.start, tables.accept,
        tables.accept_final, device,
    )


def dfa_scan_plain(dfa: DeviceDfa, data, span_start, span_end) -> torch.Tensor:
    """Plain PyTorch version of K2: [F, R] bool."""
    f, l = data.shape
    ridx = torch.arange(dfa.n_patterns, device=data.device)[None, :]
    state = dfa.start.long()[None, :].expand(f, -1)
    accepted = dfa.accept[ridx, state]
    if f == 0 or dfa.n_patterns == 0:
        return accepted | dfa.accept_final[ridx, state]
    cls = dfa.classmap.long()[data.long()]  # [F, L]
    delta = dfa.delta.long()
    # Steps past the last span end change nothing.
    t_end = min(l, int(span_end.max()))
    for t in range(t_end):
        active = (t >= span_start) & (t < span_end)
        nxt = delta[ridx, state, cls[:, t : t + 1]]
        state = torch.where(active[:, None], nxt, state)
        accepted = accepted | dfa.accept[ridx, state]
    return accepted | dfa.accept_final[ridx, state]


def dfa_search_spans(dfa: DeviceDfa, data, span_start, span_end) -> torch.Tensor:
    """Search each pattern within ``data[f, span_start[f]:span_end[f]]``.

    data: [F, L] uint8; span bounds: [F] int32; all on the tables' device.
    Returns [F, R] bool.  Empty spans (start >= end) match the patterns
    that match the empty string."""
    device = dfa.device
    kernels.check(data, "data", torch.uint8, (None, None), device)
    f, l = data.shape
    kernels.check(span_start, "span_start", torch.int32, (f,), device)
    kernels.check(span_end, "span_end", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return dfa_scan_plain(dfa, data, span_start, span_end)
    r, s, c = dfa.n_patterns, dfa.n_states, dfa.n_classes
    out = torch.empty((f, r), dtype=torch.bool, device=device)
    if f == 0 or r == 0:
        return out
    g, kt, nc, es, tiles = dfa.scan_geom
    p = kernels.p
    _DFA_SCAN.launch(
        device, p(data), p(span_start), p(span_end), p(dfa.classmap),
        p(dfa.scan_tab), p(dfa.start), f, l, r, s, c, g, kt, nc, es, tiles, p(out),
    )
    return out


def dfa_search_batch(dfa: DeviceDfa, data, lengths) -> torch.Tensor:
    """Search each pattern in ``data[f, :lengths[f]]``; [F, R] bool."""
    return dfa_search_spans(dfa, data, torch.zeros_like(lengths), lengths)
