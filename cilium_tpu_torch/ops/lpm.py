"""Batched longest-prefix match over packed prefix arrays.

Counterpart of ``cilium_tpu/ops/lpm.py``: the XDP prefilter's LPM trie +
/32 hash pair (reference: bpf/bpf_xdp.c:44-90), the cidrmap emulation
(reference: pkg/maps/cidrmap) and the ipcache LPM (reference:
pkg/maps/ipcache) as one masked compare: ``matched[f, n] = (addr[f] &
mask[n]) == net[n]`` on every word, and the matched row with the longest
prefix wins.  Among matches of equal best length the value is the
largest; on a miss the value is 0 and the prefix length -1.  A /0 prefix
matches everything.

IPv4 addresses are one int32 word; IPv6 four, most significant first.
On the card ``lpm_lookup`` is kernel K12 (``csrc/lpm.cu``): one thread an
address probes the hashed index every ``DeviceLpm`` builds when it is made
(``ops/l34_index.py`` ``lpm_index``: the prefixes grouped by mask, one
exact probe a group, best group first, several groups a round), and walks
the rows instead where the table has few rows for its groups.
"""

from __future__ import annotations

import ctypes
import ipaddress
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from .l34_index import LpmIndex, LpmIx, lpm_index
from .maplookup import chunk_rows

INT32_MIN = -(1 << 31)


def _mask32(prefix_len: np.ndarray, word: int, v6: bool) -> np.ndarray:
    """Per-word network mask for word index ``word`` given prefix lengths."""
    base = prefix_len - 32 * word
    bits = np.clip(base, 0, 32)
    # (0xFFFFFFFF << (32-bits)) & 0xFFFFFFFF, with bits==0 -> 0
    full = np.uint64(0xFFFFFFFF)
    m = (full << (np.uint64(32) - bits.astype(np.uint64))) & full
    m = np.where(bits == 0, np.uint64(0), m)
    return m.astype(np.uint32)


class LpmTab(ctypes.Structure):
    """``struct LpmTab`` of ``csrc/l34.cuh``."""

    _fields_ = [
        ("words", ctypes.c_void_p), ("masks", ctypes.c_void_p),
        ("plen", ctypes.c_void_p), ("values", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("n", ctypes.c_int), ("w", ctypes.c_int),
    ]


@dataclass
class DeviceLpm:
    """Packed prefix table on one device.

    words:  [W, N] int32 — network address words (W=1 for v4, 4 for v6),
            already masked.
    masks:  [W, N] int32 — per-word masks.
    plen:   [N] int32 — prefix lengths (winner = max among matches).
    values: [N] int32 — value per prefix (identity, tunnel endpoint, ...).
    valid:  [N] bool.
    index:  the hashed index K12, K14 and K15 probe (``ops/l34_index.py``
            ``lpm_index``), built here, so every constructor has it.
    """

    words: torch.Tensor
    masks: torch.Tensor
    plen: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor
    index: LpmIndex = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        device = self.device
        kernels.check(self.words, "words", torch.int32, (None, None), device)
        w, n = self.words.shape
        if w not in (1, 4) or n < 1:
            raise ValueError(f"words: expected [1 or 4, N >= 1], got {tuple(self.words.shape)}")
        kernels.check(self.masks, "masks", torch.int32, (w, n), device)
        kernels.check(self.plen, "plen", torch.int32, (n,), device)
        kernels.check(self.values, "values", torch.int32, (n,), device)
        kernels.check(self.valid, "valid", torch.bool, (n,), device)
        self.index = lpm_index(self)

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def n(self) -> int:
        return self.words.shape[1]

    @property
    def w(self) -> int:
        return self.words.shape[0]

    def abi(self) -> LpmTab:
        p = kernels.p
        return LpmTab(p(self.words), p(self.masks), p(self.plen), p(self.values),
                      p(self.valid), self.n, self.w)


def _ip_words(net: ipaddress._BaseNetwork, n_words: int) -> list[int]:
    x = int(net.network_address)
    total_bits = 32 * n_words
    return [(x >> (total_bits - 32 * (w + 1))) & 0xFFFFFFFF for w in range(n_words)]


def build_lpm(
    prefixes: list[tuple[str, int]], v6: bool = False, pad_to: int | None = None,
    device=None,
) -> DeviceLpm:
    """Build an LPM table on ``device`` (None: the CUDA card) from
    (cidr_string, value) pairs.  Host bits are cleared."""
    device = resolve_device(device)
    n_words = 4 if v6 else 1
    nets = []
    vals = []
    for cidr, value in prefixes:
        net = ipaddress.ip_network(cidr, strict=False)
        if (net.version == 6) != v6:
            raise ValueError(f"address family mismatch for {cidr}")
        nets.append(net)
        vals.append(value)
    n = len(nets)
    size = pad_to if pad_to is not None else max(n, 1)
    if size < n:
        raise ValueError(f"pad_to {size} < table size {n}")
    plen = np.zeros((size,), np.int64)
    values = np.zeros((size,), np.int32)
    valid = np.zeros((size,), bool)
    words = np.zeros((n_words, size), np.uint32)
    for i, net in enumerate(nets):
        plen[i] = net.prefixlen
        values[i] = vals[i]
        valid[i] = True
        for w, word in enumerate(_ip_words(net, n_words)):
            words[w, i] = word
    masks = np.stack([_mask32(plen, w, v6) for w in range(n_words)])
    words = words & masks  # normalize: host bits cleared
    return lpm_from_arrays(words.view(np.int32), masks.view(np.int32),
                           plen.astype(np.int32), values, valid, device)


def lpm_from_arrays(words, masks, plen, values, valid, device=None) -> DeviceLpm:
    """A DeviceLpm from [W, N] word and mask arrays and [N] plen, value
    and valid arrays (numpy or tensors), e.g. a JAX table's leaves."""
    device = resolve_device(device)
    return DeviceLpm(
        words=as_tensor(words, torch.int32, device),
        masks=as_tensor(masks, torch.int32, device),
        plen=as_tensor(plen, torch.int32, device),
        values=as_tensor(values, torch.int32, device),
        valid=as_tensor(valid, torch.bool, device),
    )


# --- kernel K12: lpm_lookup ---------------------------------------------------

_LPM = kernels.CudaKernel("lpm", "lpm_lookup", [ctypes.c_void_p])


class LpmArgs(ctypes.Structure):
    _fields_ = [
        ("t", LpmTab), ("addr", ctypes.c_void_p * 4), ("f", ctypes.c_int),
        ("found", ctypes.c_void_p), ("value", ctypes.c_void_p), ("plen", ctypes.c_void_p),
        ("ix", LpmIx),
    ]


def lpm_lookup_plain(lpm: DeviceLpm, *addr_words):
    """Plain PyTorch version of K12 (``cilium_tpu/ops/lpm.py:109``), over
    chunks of F."""
    f = addr_words[0].shape[0]
    device = lpm.device
    found = torch.zeros((f,), dtype=torch.bool, device=device)
    value = torch.zeros((f,), dtype=torch.int32, device=device)
    plen = torch.full((f,), -1, dtype=torch.int32, device=device)
    step = chunk_rows(lpm.n)
    for lo in range(0, f, step):
        hi = min(f, lo + step)
        matched = lpm.valid[None, :].expand(hi - lo, -1)
        for w, aw in enumerate(addr_words):
            masked = aw[lo:hi, None] & lpm.masks[w][None, :]
            matched = matched & (masked == lpm.words[w][None, :])
        score = torch.where(matched, lpm.plen[None, :] + 1, 0)
        best = score.max(dim=1).values
        hit = best > 0
        at_best = matched & (score == best[:, None])
        val = torch.where(at_best, lpm.values[None, :], INT32_MIN).max(dim=1).values
        found[lo:hi] = hit
        value[lo:hi] = torch.where(hit, val, 0)
        plen[lo:hi] = torch.where(hit, best - 1, -1)
    return found, value, plen


def _addr(lpm: DeviceLpm, addr_words) -> list:
    if len(addr_words) != lpm.w:
        raise ValueError(f"expected {lpm.w} address word arrays, got {len(addr_words)}")
    a0 = kernels.arg(addr_words[0], "addr_words[0]", torch.int32, (None,), lpm.device)
    return [a0] + [kernels.arg(a, f"addr_words[{i}]", torch.int32, a0.shape, lpm.device)
                   for i, a in enumerate(addr_words[1:], 1)]


def lpm_lookup(lpm: DeviceLpm, *addr_words):
    """Longest-prefix match for F addresses given as W [F] int32 word arrays.

    Returns (found [F] bool, value [F] int32, prefix_len [F] int32).  On a
    CUDA table this is K12."""
    ws = _addr(lpm, addr_words)
    device = lpm.device
    if kernels.on_cpu(device):
        return lpm_lookup_plain(lpm, *ws)
    f = ws[0].shape[0]
    found = torch.empty((f,), dtype=torch.bool, device=device)
    value = torch.empty((f,), dtype=torch.int32, device=device)
    plen = torch.empty((f,), dtype=torch.int32, device=device)
    if f:
        addr = (ctypes.c_void_p * 4)(*[a.data_ptr() for a in ws])
        args = LpmArgs(lpm.abi(), addr, f, found.data_ptr(), value.data_ptr(), plen.data_ptr(),
                       lpm.index.abi())
        _LPM.launch(device, ctypes.addressof(args))
    return found, value, plen


def ipv4_to_words(ips) -> tuple[np.ndarray]:
    """Host helper: array/list of IPv4 strings or ints -> ([F] int32,)."""
    out = np.zeros((len(ips),), np.uint32)
    for i, ip in enumerate(ips):
        if isinstance(ip, str):
            ip = int(ipaddress.IPv4Address(ip))
        out[i] = ip
    return (out.view(np.int32),)


def ipv6_to_words(ips) -> tuple[np.ndarray, ...]:
    """Host helper: array/list of IPv6 strings or ints -> 4x [F] int32."""
    words = np.zeros((4, len(ips)), np.uint32)
    for i, ip in enumerate(ips):
        if isinstance(ip, str):
            ip = int(ipaddress.IPv6Address(ip))
        for w in range(4):
            words[w, i] = (ip >> (128 - 32 * (w + 1))) & 0xFFFFFFFF
    return tuple(words[w].view(np.int32) for w in range(4))


def prefilter_check_batch(lpm: DeviceLpm, *addr_words) -> torch.Tensor:
    """XDP prefilter verdict: True = drop (source address in a deny prefix)
    (reference: bpf/bpf_xdp.c:97-121 check_v4)."""
    found, _, _ = lpm_lookup(lpm, *addr_words)
    return found
