"""Long-frame DFA search by chunk folding: kernel K18 and its plain version.

Counterpart of ``cilium_tpu/ops/seqdfa.py`` on one device.  A very wide
frame (a 32 KB HTTP head is the widest the in-process engine takes) puts
the serial scan (``ops/dfa.py``, K2) through tens of thousands of
dependent steps per (flow, pattern).  Chunk folding replaces that chain:

1. **Absorbing accepts.**  Accept states become self-loops on every byte
   class (``make_absorbing``), so sticky acceptance ("some prefix reached
   an accept state") is a property of the final state alone, and the
   whole span is one function of the start state.
2. **Chunk folding.**  The width splits into ``n_chunks`` equal chunks;
   each folds to a state map S -> S, the state each start state reaches
   over the chunk's bytes.  Positions outside ``[0, lengths)`` are the
   identity.
3. **Composition.**  The maps compose in chunk order, and the pattern's
   start state goes through them to an ``accept_final`` test.

The reference carries each map as an [S, S] one-hot int8 matrix and
composes by matmul.  A state map is a function, so here it is the target
of each start state, ``maps [F, R, K, S]`` uint8: K18 ``seqdfa_fold``
writes it and K18 ``seqdfa_apply`` walks ``s = maps[f, r, k, s]`` over k
and tests ``accept_final``: one thread a (flow, pattern) reading global
memory for a few chunks, else a block stages its pairs' map bytes in
shared memory and walks them there (``apply_variant``).  The fold
cuts each chunk into segments (``fold_segment``); each (flow, pattern,
segment) group walks all S start states over the first ``FOLD_PROBE``
bytes only, merges the states that coincide (a DFA step is a function)
and walks the distinct ones over the rest, at most ``FOLD_DMAX`` of them
(the fast branch) or, where more stay apart, every live start state (the
slow branch); sinks (``sink_states``) are never walked.  The kernel then
composes the segment maps in order (``csrc/seqdfa.cu``).  The result is
bit-identical for every ``n_chunks`` and equal to K2 ``dfa_search_batch``
on the non-absorbing tables.  The sequence-sharded form
(``seqdfa_search_sharded``) runs one chunk on each slot of a ("seq",)
mesh and gathers the maps in chunk order for one apply: no kernel of its
own.
"""

from __future__ import annotations

import ctypes
from dataclasses import replace

import numpy as np
import torch

from .. import kernels
from ..regex.dfa import DfaTables
from .dfa import DeviceDfa, device_dfa

SEQ_AXIS = "seq"
# K18 fold's segment bytes (multiples of 16, tried longest first), the
# (flow, segment) pieces a batch must keep to take a longer segment, the
# bytes every start state walks before the merge, and the distinct states
# a fast group walks (fixed in csrc/seqdfa.cu: one packed word).
FOLD_SEGS = (1024, 512, 256)
FOLD_MIN_PIECES = 16384
FOLD_PROBE = 2
FOLD_DMAX = 4

_SEQDFA_FOLD = kernels.CudaKernel(
    "seqdfa", "seqdfa_fold",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2,
)
_SEQDFA_APPLY = kernels.CudaKernel(
    "seqdfa", "seqdfa_apply",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)
_SEQDFA_APPLY_FORCED = kernels.CudaKernel(
    "seqdfa", "seqdfa_apply_forced",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int],
)
# K18 apply's paths (csrc/seqdfa.cu ApplyPath); "pick" is the launcher's choice.
APPLY_PATHS = {"pick": 0, "walk": 1, "staged": 2}


def make_absorbing(tables: DfaTables) -> DfaTables:
    """Accept states become self-loops on every byte class, so sticky
    acceptance reduces to final-state acceptance (step 1 above)."""
    delta = tables.delta.copy()
    ri, si = np.nonzero(tables.accept)
    delta[ri, si, :] = si[:, None]
    return replace(tables, delta=delta)


def device_dfa_absorbing(tables: DfaTables, device=None) -> DeviceDfa:
    """``make_absorbing`` tables on ``device`` (``None``: the card, and
    raises without one); raises DfaBlowupError above 128 states, as
    ``device_dfa`` does."""
    return device_dfa(make_absorbing(tables), device)


def _check_fold(dfa: DeviceDfa, data, lengths, n_chunks: int) -> None:
    device = dfa.device
    kernels.check(data, "data", torch.uint8, (None, None), device)
    f, width = data.shape
    kernels.check(lengths, "lengths", torch.int32, (f,), device)
    if n_chunks < 1 or width % n_chunks != 0:
        raise ValueError(f"width {width} is not a multiple of n_chunks {n_chunks}")


def seqdfa_fold_plain(dfa: DeviceDfa, data, lengths, n_chunks: int) -> torch.Tensor:
    """Plain PyTorch version of K18's fold: maps [F, R, K, S] uint8,
    maps[f, r, k, s0] = the state pattern r reaches from s0 over chunk k
    of data[f] (``cilium_tpu/ops/seqdfa.py:68`` ``_fold_chunk``)."""
    f, width = data.shape
    r, s = dfa.n_patterns, dfa.n_states
    k = n_chunks
    lc = width // k
    state = torch.arange(s, device=data.device).expand(f, r, k, s).clone()
    if f == 0 or r == 0:
        return state.to(torch.uint8)
    cls = dfa.classmap.long()[data.long()].view(f, k, lc)  # [F, K, Lc]
    delta = dfa.delta.long()
    ridx = torch.arange(r, device=data.device)[None, :, None, None]
    t0 = torch.arange(k, device=data.device) * lc  # [K]
    # Steps past the last active position change nothing.
    steps = min(lc, max(0, int(lengths.max())))
    for j in range(steps):
        active = (t0 + j)[None, :] < lengths[:, None]  # [F, K]
        nxt = delta[ridx, state, cls[:, None, :, j : j + 1]]
        state = torch.where(active[:, None, :, None], nxt, state)
    return state.to(torch.uint8)


def seqdfa_apply_plain(dfa: DeviceDfa, maps) -> torch.Tensor:
    """Plain PyTorch version of K18's apply: [F, R] bool — the start state
    through the chunk maps in order, then ``accept_final``
    (``cilium_tpu/ops/seqdfa.py:113`` ``_compose`` and ``:121``
    ``_apply_start_accept``)."""
    f, r, k, _ = maps.shape
    state = dfa.start.long()[None, :].expand(f, r)
    for c in range(k):
        state = maps[:, :, c, :].long().gather(2, state[:, :, None])[:, :, 0]
    ridx = torch.arange(r, device=maps.device)[None, :]
    return dfa.accept_final[ridx, state]


def seqdfa_search_batch_plain(dfa: DeviceDfa, data, lengths, n_chunks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K18 (fold, then apply): [F, R] bool."""
    _check_fold(dfa, data, lengths, n_chunks)
    return seqdfa_apply_plain(dfa, seqdfa_fold_plain(dfa, data, lengths, n_chunks))


def apply_variant(f: int, r: int, s: int, k: int, path: str = "pick") -> tuple[str, int, int]:
    """(path, pairs a block, chunks a tile) that K18 apply's launcher takes
    for ``f`` x ``r`` pairs of ``k`` maps of ``s`` states on ``path``
    ("pick": its own choice): ``csrc/seqdfa.cu`` ``apply_plan`` with that
    file's constants, for the CPU tests (on the card,
    ``kernels.seqdfa_apply_variant`` asks the library).  The walk below
    ``kApplyStageMinK`` chunks, else staged; a block holds as many pairs as
    its threads and ``kApplyStageBytes`` of regions allow (each an odd
    number of 16-byte words), cut to keep ``kApplyMinBlocks`` blocks;
    chunks past the budget are staged in tiles."""
    c = kernels.cu_constants("seqdfa")
    if path == "pick":
        path = "staged" if k >= c["kApplyStageMinK"] else "walk"
    if path == "walk":
        return path, 1, 0
    kt = max(1, min(k, (c["kApplyStageBytes"] - 48) // s))
    words = ((kt * s + 15) // 16 + 1) | 1
    most = max(1, min(c["kApplyThreads"], c["kApplyStageBytes"] // (16 * words)))
    even = -(-f * r // c["kApplyMinBlocks"])
    return path, max(1, min(most, even)), kt


def apply_staged_bytes(maps: torch.Tensor, kt: int) -> int:
    """The bytes K18 apply's staged path loads for ``maps``
    [F, R, K, S] in tiles of ``kt`` chunks: every aligned 16-byte word that
    holds a byte of a pair's tile, once for each (pair, tile)."""
    f, r, k, s = maps.shape
    q = np.arange(f * r, dtype=np.int64)[:, None]
    k0 = np.arange(0, k, kt, dtype=np.int64)[None, :]
    a = maps.data_ptr() + (q * k + k0) * s
    end = a + np.minimum(kt, k - k0) * s
    return int(16 * ((end + 15) // 16 - a // 16).sum())


def fold_segment(n_flows: int, width: int) -> int:
    """K18 fold's segment bytes for an [n_flows, width] batch: the longest
    of FOLD_SEGS that still cuts it into FOLD_MIN_PIECES (flow, segment)
    pieces (longer segments merge and compose less often; shorter ones keep
    a small batch's warps busy), else the shortest."""
    for seg in FOLD_SEGS:
        if n_flows * -(-width // seg) >= FOLD_MIN_PIECES:
            return seg
    return FOLD_SEGS[-1]


def sink_states(dfa: DeviceDfa) -> torch.Tensor:
    """[R, S] bool: the states that step to themselves on every class (an
    absorbing accept, a dead state).  K18's fold never walks them."""
    s = dfa.n_states
    own = torch.arange(s, device=dfa.delta.device)[None, :, None]
    return (dfa.delta.long() == own).all(dim=2)


def seqdfa_fold_branches_plain(dfa: DeviceDfa, data, lengths, n_chunks: int,
                               seg: int | None = None, probe: int | None = None) -> torch.Tensor:
    """What K18's fold adds to its ``debug`` counters for this call, from
    the same segments: [3] int64 — the (flow, pattern, segment) groups with
    active bytes; the chains walked past the probe (a fast group's distinct
    live states, a slow group's live start states); the slow groups (more
    than ``FOLD_DMAX`` distinct live states after the probe).  A state is
    live unless it is a sink or the probe reached the segment's end."""
    _check_fold(dfa, data, lengths, n_chunks)
    dev = data.device
    f, width = data.shape
    seg = fold_segment(f, width) if seg is None else seg
    probe = FOLD_PROBE if probe is None else probe
    r, s = dfa.n_patterns, dfa.n_states
    lc = width // n_chunks
    sl = min(seg, max(lc, 1))
    spc = -(-lc // sl) if lc else 1
    i = torch.arange(spc, device=dev)
    starts = (torch.arange(n_chunks, device=dev)[:, None] * lc + i[None, :] * sl).reshape(-1)
    nominal = (lc - i * sl).clamp(max=sl).repeat(n_chunks)
    seg_len = (lengths.long().clamp(0, width)[:, None] - starts[None, :]).clamp(min=0)
    seg_len = torch.minimum(seg_len, nominal[None, :])  # [F, NS]
    cls = dfa.classmap.long()[data.long()]
    delta = dfa.delta.long()
    ridx = torch.arange(r, device=dev)[None, None, :, None]
    state = torch.arange(s, device=dev).expand(f, len(starts), r, s).clone()
    for j in range(min(probe, sl) if width else 0):
        c = cls[:, (starts + j).clamp(max=width - 1)]
        nxt = delta[ridx, state, c[:, :, None, None]]
        state = torch.where((j < seg_len)[:, :, None, None], nxt, state)
    live = ~(sink_states(dfa)[ridx, state] | (seg_len <= probe)[:, :, None, None])
    v = torch.where(live, state, s).sort(dim=3).values
    distinct = ((v[..., 1:] != v[..., :-1]) & (v[..., 1:] < s)).sum(dim=3) + (v[..., 0] < s)
    is_slow = distinct > FOLD_DMAX
    chains = torch.where(is_slow, live.sum(dim=3), distinct)
    active = (seg_len > 0)[:, :, None].expand(f, len(starts), r)
    return torch.stack([active.sum(), chains[active].sum(), is_slow[active].sum()]).to(torch.int64)


def seqdfa_fold(dfa: DeviceDfa, data, lengths, n_chunks: int, debug=None) -> torch.Tensor:
    """K18 fold: maps [F, R, K, S] uint8 of ``data[f, :lengths[f]]`` cut
    into ``n_chunks`` chunks of equal width; all on the tables' device.
    ``debug``, a [3] int64 tensor there, gets this call's branch counts
    added (``seqdfa_fold_branches_plain``); nothing is read back."""
    _check_fold(dfa, data, lengths, n_chunks)
    device = dfa.device
    if debug is not None:
        kernels.check(debug, "debug", torch.int64, (3,), device)
    if kernels.on_cpu(device):
        if debug is not None:
            debug += seqdfa_fold_branches_plain(dfa, data, lengths, n_chunks)
        return seqdfa_fold_plain(dfa, data, lengths, n_chunks)
    f, width = data.shape
    r, s, c = dfa.n_patterns, dfa.n_states, dfa.n_classes
    maps = torch.empty((f, r, n_chunks, s), dtype=torch.uint8, device=device)
    if maps.numel():
        p = kernels.p
        _SEQDFA_FOLD.launch(
            device, p(data), p(lengths), p(dfa.classmap), p(dfa.delta),
            f, width, r, s, c, n_chunks, fold_segment(f, width), FOLD_PROBE, p(maps),
            ctypes.c_void_p(None) if debug is None else p(debug),
        )
    return maps


def seqdfa_apply(dfa: DeviceDfa, maps, path: str | None = None) -> torch.Tensor:
    """K18 apply: [F, R] bool from the fold's maps.  ``path`` (a key of
    APPLY_PATHS) forces the launcher's path (``seqdfa_apply_forced``); by
    default the launcher picks from the shapes (``apply_variant``)."""
    device = dfa.device
    r, s = dfa.n_patterns, dfa.n_states
    kernels.check(maps, "maps", torch.uint8, (None, r, None, s), device)
    if path is not None and path not in APPLY_PATHS:
        raise ValueError(f"path: expected one of {sorted(APPLY_PATHS)}, got {path!r}")
    if kernels.on_cpu(device):
        return seqdfa_apply_plain(dfa, maps)
    f, _, k, _ = maps.shape
    if k < 1:
        raise ValueError("maps: expected at least one chunk")
    out = torch.empty((f, r), dtype=torch.bool, device=device)
    if out.numel():
        p = kernels.p
        args = (p(maps), p(dfa.start), p(dfa.accept_final), f, r, s, k, p(out))
        if path is None:
            _SEQDFA_APPLY.launch(device, *args)
        else:
            _SEQDFA_APPLY_FORCED.launch(device, *args, APPLY_PATHS[path])
    return out


def seqdfa_search_batch(dfa_abs: DeviceDfa, data, lengths, n_chunks: int = 1) -> torch.Tensor:
    """Search each pattern of the absorbing tables ``dfa_abs`` in
    ``data[f, :lengths[f]]`` by folding ``n_chunks`` chunks, composing and
    accepting: [F, R] bool.  Raises unless the width is a multiple of
    ``n_chunks``."""
    return seqdfa_apply(dfa_abs, seqdfa_fold(dfa_abs, data, lengths, n_chunks))


def seqdfa_search_sharded(dfa_abs: DeviceDfa, data, lengths, mesh) -> torch.Tensor:
    """Sequence-sharded search over ``mesh``'s SEQ_AXIS (K slots): slot
    k folds its byte slice ``data[:, k*lc:(k+1)*lc]`` with K18's fold
    (``n_chunks=1``), the [F, R, 1, S] maps are gathered in k order onto
    the first slot as [F, R, K, S] (the reference's all_gather; no copy
    on a virtual mesh), and K18's apply composes and accepts.  Slot k's
    lengths are ``clamp(lengths - k*lc, 0, lc)``, which folds exactly the
    positions ``t0 = k*lc`` selects in the reference's ``_fold_chunk``.
    Returns [F, R] bool on the first slot (the reference's slot k emits
    flow block k; the blocks concatenate to the same array).  ``data`` is
    [F, W] with W and F divisible by the seq axis size."""
    from ..device import as_tensor
    from ..parallel.mesh import moved, to_slot

    n_seq = mesh.shape[SEQ_AXIS]
    f, width = data.shape
    if width % n_seq != 0:
        raise ValueError(f"width {width} not divisible by seq axis {n_seq}")
    lc = width // n_seq
    if f % n_seq != 0:
        raise ValueError(f"flow count {f} not divisible by seq axis {n_seq}")
    slots = list(mesh.devices.flat)
    first = slots[0].device
    if not isinstance(data, torch.Tensor):
        data = as_tensor(data, torch.uint8, first)
    if not isinstance(lengths, torch.Tensor):
        lengths = as_tensor(lengths, torch.int32, first)
    tables = {}
    maps = []
    for k, slot in enumerate(slots):
        dev = slot.device
        if dev not in tables:
            tables[dev] = moved(dfa_abs, dev)
        tab = tables[dev]
        d = to_slot(data[:, k * lc:(k + 1) * lc], dev).contiguous()
        ln = (to_slot(lengths, dev) - k * lc).clamp(0, lc).to(torch.int32)
        maps.append(seqdfa_fold(tab, d, ln, 1))
    gathered = torch.cat([to_slot(m, first) for m in maps], dim=2)
    return seqdfa_apply(tables[first], gathered)

