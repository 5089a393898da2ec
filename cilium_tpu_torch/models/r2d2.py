"""r2d2 batch verdict model — the port's first end-to-end slice.

Counterpart of ``cilium_tpu/models/r2d2.py``.  Replaces the reference's
per-request parse+match (reference: proxylib/r2d2/r2d2parser.go:151-214 +
proxylib/proxylib/policymap.go rule walk) with one device pass over a
[flows, bytes] batch, three kernel launches on the card:

  1. frame + tokenize (K1 ``r2d2_frame``): first CRLF, first space, and the
     file span when the message has exactly one space (msg.split(" "))
  2. match (K2 ``dfa_scan`` or K3 ``nfa_scan``): each row's file regex
     over the file span
  3. reduce (K4 ``r2d2_hits``): cmd exact compare, remote-ID set, AND
     with the file match, first matching row

Build is a pure function ``PolicyInstance -> tensors on one device``.  On
the CPU every kernel runs its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from ..ops.bytescan import count_byte, first_occurrence, first_subsequence2, spans_equal_prefix
from ..ops.rxsearch import DeviceDfa, DeviceNfa, automaton_search_spans, compile_automaton
from ..policy.invariance import reduce_r2d2_rows
from ..proxylib.parsers.r2d2 import R2d2Rule
from ..proxylib.policy import CompiledPortRules, PolicyInstance
from .base import (
    MAX_REMOTES,
    ConstVerdict,
    VerdictModel,
    first_match,
    pack_remote_sets,
    remote_ok,
)

MAX_CMD = 8  # longest r2d2 command is "RESET" (5); csrc/r2d2_hits.cu kMaxCmd

_R2D2_FRAME = kernels.CudaKernel(
    "r2d2_frame", "r2d2_frame",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6,
)
_R2D2_HITS = kernels.CudaKernel(
    "r2d2_hits", "r2d2_hits",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
)


@dataclass
class R2d2BatchModel(VerdictModel):
    nfa: "DeviceDfa | DeviceNfa"  # file-regex automaton, one pattern per row
    cmd_needle: torch.Tensor  # [R, MAX_CMD] uint8
    cmd_len: torch.Tensor  # [R] int32
    cmd_any: torch.Tensor  # [R] bool
    remote_ids: torch.Tensor  # [R, MAX_REMOTES] int32
    any_remote: torch.Tensor  # [R] bool
    # Per-row compiled match kind (literal|regex|nfa) — attribution
    # labeling only, never device data.
    match_kinds: tuple = ()
    # Per-row (remote_set_or_None, byte_free) reduction for the verdict
    # cache's byte-invariance analysis (policy/invariance.py); None makes
    # no claim (a model built without its rule rows).
    invariant_rows: tuple | None = None

    def __post_init__(self):
        # K4 reads these tables as they are: check them once, here, and
        # only the per-call data in r2d2_hits.
        device = self.device
        kernels.check(self.cmd_len, "cmd_len", torch.int32, (None,), device)
        r = self.cmd_len.shape[0]
        kernels.check(self.cmd_needle, "cmd_needle", torch.uint8, (r, MAX_CMD), device)
        kernels.check(self.cmd_any, "cmd_any", torch.bool, (r,), device)
        kernels.check(self.remote_ids, "remote_ids", torch.int32, (r, MAX_REMOTES), device)
        kernels.check(self.any_remote, "any_remote", torch.bool, (r,), device)

    @property
    def device(self) -> torch.device:
        return self.cmd_needle.device

    def __call__(self, data, lengths, remotes):
        return r2d2_verdicts(self, data, lengths, remotes)

    def verdicts_attr(self, data, lengths, remotes):
        return r2d2_verdicts_attr(self, data, lengths, remotes)

    def dispatch_bare(self) -> "R2d2BatchModel":
        """Marker the sidecar service reads: models exposing this have a
        table-shape signature (``_model_shape_key``, the tensors of the
        model's dataclass fields), so a same-bucketed churn rebuild is
        recognised as such in its ledger and prewarm books.  The model
        is its own bare form."""
        return self


def _collect_rows(rules: CompiledPortRules):
    """Flatten (rule, matcher) pairs into device rows.  A rule with no L7
    matchers contributes one always-match row (remote check only)."""
    rows = []  # (remote_set, cmd_exact, file_pattern)
    for rule in rules.rules:
        matchers = rule.l7_matchers or [None]
        for m in matchers:
            if m is None:
                rows.append((rule.allowed_remotes, "", ""))
            else:
                if not isinstance(m, R2d2Rule):
                    raise TypeError(f"not an r2d2 rule: {m!r}")
                rows.append((rule.allowed_remotes, m.cmd_exact, m.file_regex))
    return rows


def collect_policy_rows(
    policy: PolicyInstance | None, ingress: bool, port: int
) -> ConstVerdict | list[tuple[frozenset, str, str]]:
    """Resolve the effective (remote_set, cmd, file_regex) rows for
    (policy, direction, port), applying the reference's port cascade:
    exact-port rules OR wildcard-port rules; missing policy or no
    matching port entry -> constant deny (reference: policymap.go:208-236,
    instance.go:157-165)."""
    if policy is None:
        return ConstVerdict(False)
    side = policy.ingress if ingress else policy.egress
    rows = []
    for key in (port, 0):
        rules = side.by_port.get(key)
        if rules is None:
            continue
        if not rules.have_l7_rules or not rules.rules:
            # Whole set allows any payload from anyone on this port.
            return ConstVerdict(True)
        rows.extend(_collect_rows(rules))
    if not rows:
        return ConstVerdict(False)
    return rows


# Rule-row bucket floor (build_r2d2_model pads the flattened row count up
# to the next power of two >= this), so a policy update that stays within
# the bucket keeps every table shape.
MIN_RULE_BUCKET = 8


def _rule_bucket(n: int) -> int:
    b = MIN_RULE_BUCKET
    while b < n:
        b *= 2
    return b


def build_r2d2_model(
    policy: PolicyInstance | None, ingress: bool, port: int, device=None
) -> ConstVerdict | R2d2BatchModel:
    """Compile the effective rule set for (policy, direction, port) into a
    batch model on ``device`` (None: the CUDA card).  Rule rows are padded
    to the shape bucket (see MIN_RULE_BUCKET)."""
    device = resolve_device(device)
    rows = collect_policy_rows(policy, ingress, port)
    if isinstance(rows, ConstVerdict):
        return rows
    return build_r2d2_model_from_rows(rows, bucket=True, device=device)


def build_r2d2_model_from_rows(
    rows: list[tuple[frozenset, str, str]],
    bucket: bool = False,
    device=None,
) -> R2d2BatchModel:
    """Compile (remote_set, cmd, file_regex) rows into tensors on
    ``device`` (None: the CUDA card).

    ``bucket=True`` pads the row axis to the next power-of-two bucket
    with rows that can never match (remote set {-1}: identities are
    non-negative, so rem_ok is identically False and a padding row can
    never be the first match either) and pattern "".  ``match_kinds``
    covers REAL rows only — an attributed rule id never points at
    padding."""
    device = resolve_device(device)
    remote_sets = [r[0] for r in rows]
    packed_ids, any_remote = pack_remote_sets(remote_sets)

    n = len(rows)
    n_pad = _rule_bucket(n) if bucket else n
    cmd_needle = np.zeros((n_pad, MAX_CMD), dtype=np.uint8)
    cmd_len = np.zeros((n_pad,), dtype=np.int32)
    cmd_any = np.zeros((n_pad,), dtype=bool)
    for i, (_, cmd, _f) in enumerate(rows):
        b = cmd.encode()
        cmd_needle[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        cmd_len[i] = len(b)
        cmd_any[i] = len(b) == 0
    if n_pad > n:
        ids = np.full((n_pad, packed_ids.shape[1]), -1, dtype=np.int32)
        ids[:n] = packed_ids
        packed_ids = ids
        ar = np.zeros((n_pad,), dtype=bool)
        ar[:n] = any_remote
        any_remote = ar

    nfa = compile_automaton([r[2] for r in rows] + [""] * (n_pad - n), device)
    kinds = tuple(
        "literal" if not file_rx
        else ("nfa" if isinstance(nfa, DeviceNfa) else "regex")
        for _, _, file_rx in rows
    )
    return R2d2BatchModel(
        nfa=nfa,
        cmd_needle=torch.from_numpy(cmd_needle).to(device),
        cmd_len=torch.from_numpy(cmd_len).to(device),
        cmd_any=torch.from_numpy(cmd_any).to(device),
        remote_ids=torch.from_numpy(packed_ids).to(device),
        any_remote=torch.from_numpy(any_remote).to(device),
        match_kinds=kinds,
        invariant_rows=reduce_r2d2_rows(rows),
    )


# --- kernel K1: frame + tokenize -------------------------------------------


class Frame(NamedTuple):
    """Per-flow framing of the first message; every field is [F]."""

    crlf: torch.Tensor  # int32 — first CRLF, else the length
    complete: torch.Tensor  # bool — crlf < length
    msg_len: torch.Tensor  # int32 — crlf + 2
    sp: torch.Tensor  # int32 — first space before crlf, else crlf
    file_start: torch.Tensor  # int32 — sp + 1 with exactly one space, else 0
    file_end: torch.Tensor  # int32 — crlf with exactly one space, else 0


def r2d2_frame_plain(data: torch.Tensor, lengths: torch.Tensor) -> Frame:
    """Plain PyTorch version of K1 (the reference's bytescan formulas)."""
    crlf = first_subsequence2(data, lengths, 0x0D, 0x0A)
    sp = first_occurrence(data, crlf, 0x20)  # first space within msg
    one_space = count_byte(data, crlf, 0x20) == 1
    zero = torch.zeros_like(crlf)
    return Frame(
        crlf=crlf,
        complete=crlf < lengths,
        msg_len=crlf + 2,
        sp=sp,
        file_start=torch.where(one_space, sp + 1, zero),
        file_end=torch.where(one_space, crlf, zero),
    )


def r2d2_frame(data: torch.Tensor, lengths: torch.Tensor) -> Frame:
    """K1: frame and tokenize one message per row.  data [F, L] uint8,
    lengths [F] int32, on one device."""
    device = data.device
    kernels.check(data, "data", torch.uint8, (None, None), device)
    f, l = data.shape
    kernels.check(lengths, "lengths", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return r2d2_frame_plain(data, lengths)
    i32 = [torch.empty((f,), dtype=torch.int32, device=device) for _ in range(5)]
    complete = torch.empty((f,), dtype=torch.bool, device=device)
    crlf, msg_len, sp, file_start, file_end = i32
    if f:
        p = kernels.p
        _R2D2_FRAME.launch(
            device, p(data), p(lengths), f, l, p(crlf), p(complete),
            p(msg_len), p(sp), p(file_start), p(file_end),
        )
    return Frame(crlf, complete, msg_len, sp, file_start, file_end)


# --- kernel K4: rule-row walk ------------------------------------------------


def r2d2_hits_plain(model: R2d2BatchModel, data, sp, file_ok, remotes):
    """Plain PyTorch version of K4: (allow [F] bool, rule [F] int32)."""
    cmd_ok = (
        spans_equal_prefix(
            data, torch.zeros_like(sp), sp, model.cmd_needle, model.cmd_len
        )
        | model.cmd_any[None, :]
    )  # [F, R]
    rem_ok = remote_ok(remotes, model.remote_ids, model.any_remote)  # [F, R]
    hits = cmd_ok & file_ok & rem_ok
    allow = hits.any(dim=1)
    return allow, first_match(hits, allow)


def r2d2_hits(model: R2d2BatchModel, data, sp, file_ok, remotes):
    """K4: (allow [F] bool, rule [F] int32) — the first rule row whose
    command, file match and remote set all hold, -1 where none does."""
    device = model.device
    kernels.check(data, "data", torch.uint8, (None, None), device)
    f, l = data.shape
    r = model.cmd_len.shape[0]
    kernels.check(sp, "sp", torch.int32, (f,), device)
    kernels.check(file_ok, "file_ok", torch.bool, (f, r), device)
    kernels.check(remotes, "remotes", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return r2d2_hits_plain(model, data, sp, file_ok, remotes)
    allow = torch.empty((f,), dtype=torch.bool, device=device)
    rule = torch.empty((f,), dtype=torch.int32, device=device)
    if f:
        p = kernels.p
        _R2D2_HITS.launch(
            device, p(data), p(sp), p(file_ok), p(remotes),
            p(model.cmd_needle), p(model.cmd_len), p(model.cmd_any),
            p(model.remote_ids), p(model.any_remote), f, l, r,
            p(allow), p(rule),
        )
    return allow, rule


# --- the verdict pass --------------------------------------------------------


def _inputs(model: R2d2BatchModel, data, lengths, remotes):
    device = model.device
    return (
        as_tensor(data, torch.uint8, device),
        as_tensor(lengths, torch.int32, device),
        as_tensor(remotes, torch.int32, device),
    )


def _verdict_pass(model: R2d2BatchModel, data, lengths, remotes):
    data, lengths, remotes = _inputs(model, data, lengths, remotes)
    frame = r2d2_frame(data, lengths)
    file_ok = automaton_search_spans(
        model.nfa, data, frame.file_start, frame.file_end
    )  # [F, R]
    allow, rule = r2d2_hits(model, data, frame.sp, file_ok, remotes)
    return frame.complete, frame.msg_len, allow, rule


def r2d2_verdicts(model: R2d2BatchModel, data, lengths, remotes):
    """Returns (complete [F] bool, msg_len [F] int32, allow [F] bool) as
    tensors on the model's device; inputs may be numpy arrays or tensors.

    msg_len counts the CRLF (the oracle's PASS/DROP byte count,
    reference: r2d2parser.go:166).  allow is meaningful only where
    complete.
    """
    complete, msg_len, allow, _ = _verdict_pass(model, data, lengths, remotes)
    return complete, msg_len, allow


def r2d2_verdicts_attr(model: R2d2BatchModel, data, lengths, remotes):
    """r2d2_verdicts plus the deciding rule row: (complete, msg_len,
    allow, rule [F] int32).  ``rule`` is the FIRST matching flattened
    (rule, matcher) row — the host oracle's first-match walk order —
    or -1 where not allowed."""
    return _verdict_pass(model, data, lengths, remotes)
