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
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..regex.dfa import DfaBlowupError, DfaTables

# State ids are 7 bits in the kernel (bit 7 carries "target accepts"), and
# the reference's int8 ids stop at the same bound (cilium_tpu/ops/dfa.py:86);
# keeping the guard keeps the DFA/NFA choice, and match_kinds, equal.
MAX_DFA_DEVICE_STATES = 128

_DFA_SCAN = kernels.CudaKernel(
    "dfa_scan", "dfa_scan",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)


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
    p = kernels.p
    _DFA_SCAN.launch(
        device, p(data), p(span_start), p(span_end), p(dfa.classmap),
        p(dfa.delta), p(dfa.start), p(dfa.accept), p(dfa.accept_final),
        f, l, r, s, c, p(out),
    )
    return out


def dfa_search_batch(dfa: DeviceDfa, data, lengths) -> torch.Tensor:
    """Search each pattern in ``data[f, :lengths[f]]``; [F, R] bool."""
    return dfa_search_spans(dfa, data, torch.zeros_like(lengths), lengths)
