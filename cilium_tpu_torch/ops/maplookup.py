"""Batched exact-match lookup into packed key tables.

Counterpart of ``cilium_tpu/ops/maplookup.py``: F flows look up N table
entries (the reference's per-packet BPF hash-map probes, reference:
bpf/lib/policy.h:47 map_lookup_elem on POLICY_MAP).  Keys are column
arrays, one per key field; the table is padded to a fixed size, padding
rows invalid.

On the card ``exact_lookup`` is kernel K13's ``exact_lookup`` launcher
(``csrc/l34_tables.cu``): one thread a query probes the hashed index that
every ``DeviceTable`` builds when it is made (``ops/l34_index.py``), so a
lookup reads one bucket, not every row.  The reference extracted the
matched row with an int8 one-hot matmul, so the values of every matched
row are SUMMED (int32, wrapping); the builds keep keys unique, but the
kernel and the plain version sum all the same.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from .l34_index import SLOT_MAX, HashIndex, HashIx, exact_index

MAX_KEY_COLS = 11  # the v6 CT key: four daddr words, four saddr words, dport, sport, proto


def u32_to_i32(a):
    """uint32 bit pattern -> int32 lanes.  Device tables carry
    addresses and other full-range uint32 values as int32 bit patterns
    so entries >= 2^31 compare bit-exact; every pack/oracle site must
    use this one conversion."""
    arr = np.asarray(a, np.int64)
    return (arr & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor with two's-complement wraparound."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def chunk_rows(n_cols: int, budget: int = 1 << 22) -> int:
    """Queries per chunk so that a plain [chunk, n_cols] compare stays
    near ``budget`` elements."""
    return max(1, budget // max(n_cols, 1))


def slot_values(k: int, v: int) -> int:
    """Value columns the index slots of a K-column table with V value
    columns hold: all V where the key, the values and the row id fit a
    slot, else none (the kernel then reads a matched row's values from the
    table)."""
    return v if k + v + 1 <= SLOT_MAX else 0


class ExactTab(ctypes.Structure):
    """``struct ExactTab`` of ``csrc/l34.cuh``."""

    _fields_ = [
        ("keys", ctypes.c_void_p), ("values", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("n", ctypes.c_int),
        ("k", ctypes.c_int), ("v", ctypes.c_int),
    ]


@dataclass
class DeviceTable:
    """Packed column-oriented lookup table on one device.

    keys:   [K, N] int32 — one row per key field (``cols`` are its rows).
    values: [N, V] int32 value columns.
    valid:  [N] bool — padding rows are invalid.
    index:  the hashed index K13-K15 probe (``ops/l34_index.py``), built
            here from the other fields, so every constructor has it.
    """

    keys: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor
    index: HashIndex = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        device = self.device
        kernels.check(self.keys, "keys", torch.int32, (None, None), device)
        k, n = self.keys.shape
        if not 1 <= k <= MAX_KEY_COLS or n < 1:
            raise ValueError(f"keys: expected [K <= {MAX_KEY_COLS}, N >= 1], got {tuple(self.keys.shape)}")
        kernels.check(self.values, "values", torch.int32, (n, None), device)
        kernels.check(self.valid, "valid", torch.bool, (n,), device)
        self.index = exact_index(self, slot_values(k, self.values.shape[1]))

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def cols(self) -> tuple:
        return tuple(self.keys)

    @property
    def n(self) -> int:
        return self.keys.shape[1]

    def abi(self) -> ExactTab:
        p = kernels.p
        return ExactTab(p(self.keys), p(self.values), p(self.valid), self.n,
                        self.keys.shape[0], self.values.shape[1])


def pack_table(keys: np.ndarray, values: np.ndarray, pad_to: int | None = None,
               device=None) -> DeviceTable:
    """Build a DeviceTable on ``device`` (None: the CUDA card) from [N, K]
    int key rows and [N, V] int values."""
    device = resolve_device(device)
    keys = np.asarray(keys, dtype=np.int32)
    values = np.asarray(values, dtype=np.int32)
    if keys.ndim != 2:
        raise ValueError("keys must be [N, K]")
    n, k = keys.shape
    size = pad_to if pad_to is not None else max(n, 1)
    if size < n:
        raise ValueError(f"pad_to {size} < table size {n}")
    pk = np.zeros((size, k), dtype=np.int32)
    pv = np.zeros((size, values.shape[1] if values.ndim == 2 else 1), np.int32)
    valid = np.zeros((size,), dtype=bool)
    pk[:n] = keys
    if n:
        pv[:n] = values.reshape(n, -1)
    valid[:n] = True
    return DeviceTable(
        keys=torch.from_numpy(np.ascontiguousarray(pk.T)).to(device),
        values=torch.from_numpy(pv).to(device),
        valid=torch.from_numpy(valid).to(device),
    )


def table_from_arrays(cols, values, valid, device=None) -> DeviceTable:
    """A DeviceTable from its column, value and valid arrays (numpy or
    tensors), e.g. a JAX table's leaves."""
    device = resolve_device(device)
    return DeviceTable(
        keys=as_tensor(np.stack([np.asarray(c) for c in cols]), torch.int32, device),
        values=as_tensor(values, torch.int32, device),
        valid=as_tensor(valid, torch.bool, device),
    )


# --- kernel K13: exact_lookup -------------------------------------------------

_EXACT = kernels.CudaKernel("l34_tables", "exact_lookup", [ctypes.c_void_p])


class ExactArgs(ctypes.Structure):
    _fields_ = [
        ("t", ExactTab), ("q", ctypes.c_void_p * MAX_KEY_COLS),
        ("f", ctypes.c_int), ("found", ctypes.c_void_p), ("vals", ctypes.c_void_p),
        ("ix", HashIx),
    ]


def table_matches(table: DeviceTable, query_cols, lo: int, hi: int) -> torch.Tensor:
    """[hi - lo, N] bool: row n is valid and equals query f on every key."""
    m = table.valid[None, :].expand(hi - lo, -1)
    for col, q in zip(table.cols, query_cols):
        m = m & (col[None, :] == q[lo:hi, None])
    return m


def exact_lookup_plain(table: DeviceTable, *query_cols):
    """Plain PyTorch version of K13 ``exact_lookup``: (found [F] bool,
    values [F, V] int32, the int32-wrapped sum of every matched row),
    over chunks of F so the [F, N] compare stays small."""
    f = query_cols[0].shape[0]
    v = table.values.shape[1]
    found = torch.zeros((f,), dtype=torch.bool, device=table.device)
    vals = torch.zeros((f, v), dtype=torch.int32, device=table.device)
    wide = table.values.to(torch.int64)
    step = chunk_rows(table.n)
    for lo in range(0, f, step):
        hi = min(f, lo + step)
        m = table_matches(table, query_cols, lo, hi)
        found[lo:hi] = m.any(dim=1)
        mi = m.to(torch.int64)
        for c in range(v):
            vals[lo:hi, c] = wrap32((mi * wide[None, :, c]).sum(dim=1))
    return found, vals


def _query(table: DeviceTable, query_cols) -> list:
    if len(query_cols) != table.keys.shape[0]:
        raise ValueError(
            f"query has {len(query_cols)} columns, table has "
            f"{table.keys.shape[0]} — every key field must be matched"
        )
    q0 = kernels.arg(query_cols[0], "query_cols[0]", torch.int32, (None,), table.device)
    return [q0] + [kernels.arg(q, f"query_cols[{i}]", torch.int32, q0.shape, table.device)
                   for i, q in enumerate(query_cols[1:], 1)]


def exact_lookup(table: DeviceTable, *query_cols):
    """Look up F queries (one [F] int32 array per key field).

    Returns (found [F] bool, values [F, V] int32; zeros when not found,
    the sum of the matched rows otherwise).  On a CUDA table this is K13."""
    qs = _query(table, query_cols)
    device = table.device
    if kernels.on_cpu(device):
        return exact_lookup_plain(table, *qs)
    f = qs[0].shape[0]
    found = torch.empty((f,), dtype=torch.bool, device=device)
    vals = torch.empty((f, table.values.shape[1]), dtype=torch.int32, device=device)
    if f:
        q = (ctypes.c_void_p * MAX_KEY_COLS)(*[t.data_ptr() for t in qs])
        args = ExactArgs(table.abi(), q, f, found.data_ptr(), vals.data_ptr(), table.index.abi())
        _EXACT.launch(device, ctypes.addressof(args))
    return found, vals
