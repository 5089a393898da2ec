"""Shared verdict-model plumbing: remote-ID sets and first-match.

Counterpart of ``cilium_tpu/models/base.py``.  The device formula for one
compiled port rule set (reference semantics:
proxylib/proxylib/policymap.go:91-171):

    allow[f] = OR_r ( remote_ok[f, r] AND l7_match[f, r] )

with the degenerate cases (no L7 rules anywhere / empty rule list) folding
to a constant at build time.  ``remote_ok`` and ``first_match`` are plain
PyTorch: on the card the r2d2 model computes both inside kernel K4
(``models/r2d2.py``), and these are its plain version.  ``SeamProbe`` is
the seam benchmark's model; on the card it runs kernel K19
``seam_probe`` (``csrc/seam.cu``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device

MAX_REMOTES = 32

_SEAM_PROBE = kernels.CudaKernel(
    "seam", "seam_probe",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3,
)


@dataclass
class ConstVerdict:
    """A rule set whose outcome doesn't depend on the payload."""

    allow: bool

    def __call__(self, *_args, **_kwargs):
        return self.allow


class VerdictModel:
    """Base for device-backed batch verdict models.  ``reads_rows``: the
    model reads the [F, W] payload rows, so the blob lane builds them
    (K16) before calling it; a model that reads only the lengths says
    False."""

    n_rules: int = 0
    reads_rows: bool = True


def seam_probe_plain(lengths: torch.Tensor, attr: bool = False):
    """Plain PyTorch version of K19: (ok bool [F], msg_len int32 [F], ok),
    plus rule int32 [F] zeros when ``attr``."""
    ok = lengths >= 0
    msg_len = lengths.clone()
    if attr:
        return ok, msg_len, ok, torch.zeros_like(lengths)
    return ok, msg_len, ok


def seam_probe(lengths, attr: bool = False, device=None):
    """K19: the seam probe's all-allow verdict of ``lengths`` (int32 [F];
    numpy is copied to ``device``, None: the card; a tensor must already
    lie there).  ``msg_len`` is a copy of its own, never ``lengths``
    itself."""
    if device is None and isinstance(lengths, torch.Tensor):
        device = lengths.device
    device = resolve_device(device)
    lengths = kernels.arg(lengths, "lengths", torch.int32, (None,), device)
    if kernels.on_cpu(device):
        return seam_probe_plain(lengths, attr)
    f = lengths.shape[0]
    ok = torch.empty(f, dtype=torch.bool, device=device)
    msg_len = torch.empty(f, dtype=torch.int32, device=device)
    rule = torch.empty(f, dtype=torch.int32, device=device) if attr else None
    if f:
        p = kernels.p
        _SEAM_PROBE.launch(
            device, p(lengths), f, p(ok), p(msg_len),
            p(rule) if attr else ctypes.c_void_p(None),
        )
    if attr:
        return ok, msg_len, ok, rule
    return ok, msg_len, ok


class SeamProbe(VerdictModel):
    """Diagnostic model for ``DaemonConfig.seam_probe``: a minimal real
    device op (all frames complete, all allowed) that keeps the full
    dispatch -> device call -> readback path alive while removing the
    verdict-compute term, so latbench can measure what the sidecar seam
    itself adds.  Matches the (complete, msg_len, allow) batch model
    contract; ``verdicts_attr`` adds rule row 0.  ``device=None`` is the
    card, and raises without one.  It reads no payload rows
    (``reads_rows``), so the blob lane builds none for it."""

    match_kinds: tuple = ("probe",)
    reads_rows: bool = False

    def __init__(self, device=None):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            # the index the inputs' tensors will carry
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    def __call__(self, data, lengths, remotes):
        return seam_probe(lengths, device=self.device)

    def verdicts_attr(self, data, lengths, remotes):
        return seam_probe(lengths, attr=True, device=self.device)


def first_match(hits: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
    """[F] int32 index of the FIRST matching rule row per flow, -1 where
    nothing allowed.  Row order is the host oracle's walk order, so the
    first true row IS the host's first-match semantics (torch's argmax
    takes no bool, hence the cast; it returns the first maximum)."""
    first = torch.argmax(hits.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(allow, first, torch.full_like(first, -1))


def pack_remote_sets(remote_sets: list[frozenset[int]]) -> tuple[np.ndarray, np.ndarray]:
    """Pack per-rule allowed-remote sets into [R, MAX_REMOTES] int32 plus a
    per-rule 'empty set allows any remote' flag (reference:
    policymap.go:92-98)."""
    r = len(remote_sets)
    ids = np.zeros((r, MAX_REMOTES), dtype=np.int32)
    any_remote = np.zeros((r,), dtype=bool)
    for i, s in enumerate(remote_sets):
        if not s:
            any_remote[i] = True
            continue
        if len(s) > MAX_REMOTES:
            raise ValueError(
                f"rule allows {len(s)} remotes (max {MAX_REMOTES}); "
                "shard the rule or raise MAX_REMOTES"
            )
        ids[i, : len(s)] = sorted(s)
        # pad with the first id so padding never matches a real remote 0
        ids[i, len(s):] = ids[i, 0]
    return ids, any_remote


def remote_ok(
    remote_ids: torch.Tensor,  # [F] int32
    packed_ids: torch.Tensor,  # [R, MAX_REMOTES] int32
    any_remote: torch.Tensor,  # [R] bool
) -> torch.Tensor:
    """[F, R] bool: flow f's remote is allowed by rule r."""
    hit = (remote_ids[:, None, None] == packed_ids[None, :, :]).any(dim=2)
    return hit | any_remote[None, :]
