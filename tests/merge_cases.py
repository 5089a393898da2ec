"""Boundary cases for K18's apply (``seqdfa_apply``) and K22
``kafka_shard_combine`` (no JAX: the card tests and ``chip_smoke.py``
import it too).

``apply_case(rng, f, r, k, s)`` is a table of R patterns over S states
(``dfa_from_arrays``' arguments) and maps [F, R, K, S] uint8: random
targets, and a share of pairs whose every map sends all states to one
state, so that a warp's walkers sit in one state (the bank pattern the
staged path pads its regions against).  ``APPLY_SHAPES`` puts K = 1,
K * S not a multiple of 16, S = 1, odd S, S at the 128-state limit, F * R
not a multiple of any block's pairs and a pair's maps past one block's
staging budget (tiles).

``combine_case(rng, r, f, t)`` is K22's inputs as uint8 arrays with any
nonzero byte for true (a bool tensor holding 2 or 255 is true to the
plain version): topic counts -1, 0, T and T + 1 first, then random.
``COMBINE_OFFSETS`` are byte offsets of the four inputs' storage that
leave every vector path allowed, or none.

``at_offset(a, offset, device)`` holds a numpy array ``offset`` bytes into
a fresh allocation: a contiguous view at that byte alignment.
"""

from __future__ import annotations

import numpy as np
import torch

# (name, F, R, K, S)
APPLY_SHAPES = (
    ("k1-s19", 257, 9, 1, 19),
    ("k8-s19", 257, 9, 8, 19),
    ("k64-s19", 129, 9, 64, 19),
    ("k64-s16", 1027, 2, 64, 16),
    ("k7-s128", 33, 3, 7, 128),
    ("k64-s127", 17, 2, 64, 127),
    ("k13-s33", 1031, 3, 13, 33),
    ("k3-s1", 5, 1, 3, 1),
    ("k2000-s19", 3, 2, 2000, 19),
)
APPLY_OFFSETS = (0, 1, 7)

COMBINE_T = (1, 3, 8, 13)
COMBINE_F = (1, 3, 4099, 4100)
# (simple, cover, topic_count, overflow) byte offsets: all aligned; every
# base off its vector width (cover off even its 8 bytes)
COMBINE_OFFSETS = ((0, 0, 0, 0), (1, 1, 4, 1))


def apply_case(rng, f: int, r: int, k: int, s: int):
    """(classmap, delta, start, accept, accept_final, maps)."""
    c = 2
    classmap = (np.arange(256) % c).astype(np.uint8)
    delta = rng.integers(0, s, (r, s, c)).astype(np.uint8)
    start = rng.integers(0, s, r).astype(np.uint8)
    accept = rng.random((r, s)) < 0.3
    accept_final = accept | (rng.random((r, s)) < 0.2)
    maps = rng.integers(0, s, (f, r, k, s)).astype(np.uint8)
    flat = rng.random((f, r)) < 0.4  # these pairs' maps send every state to one state
    maps[flat] = rng.integers(0, s, (int(flat.sum()), k, 1)).astype(np.uint8)
    return classmap, delta, start, accept, accept_final, maps


def combine_case(rng, r: int, f: int, t: int):
    """(simple [R, F], cover [R, F, T], topic_count [F] int32, overflow [F]),
    uint8 but topic_count, any nonzero byte true."""
    def bits(shape, p):
        return np.where(rng.random(shape) < p, rng.integers(1, 256, shape), 0).astype(np.uint8)

    simple = bits((r, f), 0.1)
    cover = bits((r, f, t), 0.75)
    tc = rng.integers(-1, t + 3, f).astype(np.int32)
    edge = [-1, 0, t, t + 1][: min(f, 4)]
    tc[: len(edge)] = edge
    return simple, cover, tc, bits((f,), 0.1)


def at_offset(a: np.ndarray, offset: int, device, dtype=None) -> torch.Tensor:
    """``a`` as a contiguous tensor (of ``dtype``, by default ``a``'s own)
    on ``device`` whose data starts ``offset`` bytes past a 16-byte
    boundary."""
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    buf = torch.zeros(raw.size + offset + 16, dtype=torch.uint8, device=device)
    lead = (-buf.data_ptr()) % 16 + offset
    buf[lead:lead + raw.size] = torch.from_numpy(raw).to(device)
    out = buf[lead:lead + raw.size]
    dtype = dtype or torch.from_numpy(np.ascontiguousarray(a[:0])).dtype
    return out.view(dtype).view(a.shape)
