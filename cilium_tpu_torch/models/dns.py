"""DNS name-policy batch verdict model on one device.

Counterpart of ``cilium_tpu/models/dns.py``.  Replaces the reference's
per-request dnsproxy name walk (reference: pkg/fqdn + the proxylib-style
per-rule regex loop) with one device pass over a [flows, bytes] batch of
DNS-over-TCP query frames (2-byte length prefix + 12-byte header + QNAME
label sequence + QTYPE/QCLASS), two to three kernel launches on the card:

  1. frame + name (K8 ``dns_name``): msg_len from the length prefix,
     complete = the frame fits; a bounded label walk (MAX_LABELS steps)
     finds and validates the QNAME span (no compression pointers, labels
     <= 63, question section complete) and rewrites the row to the
     DOTTED, 0x20-folded name: interior length bytes become '.', A-Z fold
     to a-z
  2. match (K2 ``dfa_scan`` or K3 ``nfa_scan``, unchanged): the
     wildcard/regex rows over the dotted span, only when the model has
     such rows
  3. reduce (K9 ``dns_hits``): exact-name compare, the automaton hit,
     the QNAME validity gate and the remote-ID set per rule row, first
     matching row

The host compile (row collection, needle packing, the churn bucket) is a
copy of the reference's; on the CPU every kernel runs its plain PyTorch
version, which follows the reference's jnp formulation.  Bit-identical to
the streaming oracle (``proxylib/parsers/dns.py``); the structural bounds
(MAX_LABELS etc.) are shared constants so the two cannot drift.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from ..ops.bytescan import spans_equal_prefix
from ..ops.rxsearch import DeviceDfa, DeviceNfa, automaton_search_spans, compile_automaton
from ..policy.invariance import reduce_dns_rows
from ..proxylib.parsers.dns import (
    DNS_HEADER_LEN,
    DNS_PREFIX_LEN,
    MAX_LABEL,
    MAX_LABELS,
    DnsRule,
)
from ..proxylib.policy import CompiledPortRules, PolicyInstance
from .base import (
    MAX_REMOTES,
    ConstVerdict,
    VerdictModel,
    first_match,
    pack_remote_sets,
    remote_ok,
)
from .r2d2 import _rule_bucket

# Smallest well-formed query frame: prefix + header + root name + Q.
DNS_MIN_FRAME = DNS_PREFIX_LEN + DNS_HEADER_LEN + 1 + 4
_QNAME_OFF = DNS_PREFIX_LEN + DNS_HEADER_LEN  # first length byte

_DNS_NAME = kernels.CudaKernel(
    "dns_name", "dns_name",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6,
)
_DNS_HITS = kernels.CudaKernel(
    "dns_hits", "dns_hits",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
)


@dataclass
class DnsBatchModel(VerdictModel):
    nfa: "DeviceDfa | DeviceNfa | None"  # pattern/regex rows; None: no such row
    name_needle: torch.Tensor  # [R, W] uint8 — exact names, dotted+folded
    name_len: torch.Tensor  # [R] int32 (-1 = row matches via automaton/any)
    name_any: torch.Tensor  # [R] bool — byte-free always-match rows
    use_rx: torch.Tensor  # [R] bool — row decided by the automaton tier
    remote_ids: torch.Tensor  # [R, MAX_REMOTES] int32
    any_remote: torch.Tensor  # [R] bool
    # Per-row compiled match kind (literal|regex|nfa) — attribution
    # labels only, never device data.
    match_kinds: tuple = ()
    # Per-row (remote_set_or_None, byte_free) reduction for the verdict
    # cache's byte-invariance analysis (policy/invariance.py); None makes
    # no claim (a model built without its rule rows).
    invariant_rows: tuple | None = None

    def __post_init__(self):
        # K9 reads these tables as they are: check them once, here, and
        # only the per-call data in dns_hits.
        device = self.device
        chk = kernels.check
        chk(self.name_needle, "name_needle", torch.uint8, (None, None), device)
        r = self.name_needle.shape[0]
        chk(self.name_len, "name_len", torch.int32, (r,), device)
        chk(self.name_any, "name_any", torch.bool, (r,), device)
        chk(self.use_rx, "use_rx", torch.bool, (r,), device)
        chk(self.remote_ids, "remote_ids", torch.int32, (r, MAX_REMOTES), device)
        chk(self.any_remote, "any_remote", torch.bool, (r,), device)
        if self.nfa is not None and (
            self.nfa.device != device or self.nfa.n_patterns != r
        ):
            raise ValueError("nfa: expected one pattern per rule row on the model's device")

    @property
    def device(self) -> torch.device:
        return self.name_needle.device

    @property
    def n_rules(self) -> int:
        return self.name_needle.shape[0]

    def __call__(self, data, lengths, remotes):
        return dns_verdicts(self, data, lengths, remotes)

    def verdicts_attr(self, data, lengths, remotes):
        return dns_verdicts_attr(self, data, lengths, remotes)

    def dispatch_bare(self) -> "DnsBatchModel":
        """Table-shape signature marker (see R2d2BatchModel)."""
        return self


def _collect_rows(rules: CompiledPortRules):
    rows = []  # (remote_set, DnsRule | None)
    for rule in rules.rules:
        matchers = rule.l7_matchers or [None]
        for m in matchers:
            if m is not None and not isinstance(m, DnsRule):
                raise TypeError(f"not a dns rule: {m!r}")
            rows.append((rule.allowed_remotes, m))
    return rows


def collect_dns_policy_rows(
    policy: PolicyInstance | None, ingress: bool, port: int
) -> ConstVerdict | list:
    """Effective (remote_set, DnsRule|None) rows for (policy,
    direction, port) under the reference port cascade — the same
    flattened first-match row order the host ``matches_at`` walks
    (models/r2d2.collect_policy_rows is the template)."""
    if policy is None:
        return ConstVerdict(False)
    side = policy.ingress if ingress else policy.egress
    rows = []
    for key in (port, 0):
        rules = side.by_port.get(key)
        if rules is None:
            continue
        if not rules.have_l7_rules or not rules.rules:
            return ConstVerdict(True)
        rows.extend(_collect_rows(rules))
    if not rows:
        return ConstVerdict(False)
    return rows


def build_dns_model(
    policy: PolicyInstance | None, ingress: bool, port: int, device=None
) -> ConstVerdict | DnsBatchModel:
    """Compile the effective DNS rule rows for (policy, direction, port)
    onto ``device`` (None: the CUDA card), padded to the churn bucket."""
    device = resolve_device(device)
    rows = collect_dns_policy_rows(policy, ingress, port)
    if isinstance(rows, ConstVerdict):
        return rows
    return build_dns_model_from_rows(rows, bucket=True, device=device)


def dns_row_arrays(rows: list, n_pad: int, width: int | None = None):
    """Host arrays for (remote_set, DnsRule|None) rows padded to
    ``n_pad`` (padding rows are dead: remote set {-1}, needle_len -1,
    never-accepting automaton slot).  Shared by the single-card build
    and the rule-sharded build (which passes one ``width`` for every
    shard) so the two cannot drift.  Returns (needle, n_len, n_any,
    use_rx, packed_ids, any_remote, patterns)."""
    exact = [
        (r.name.encode("latin-1", "replace") if r is not None else b"")
        for _, r in rows
    ]
    if width is None:
        # The needle must hold the WHOLE longest exact name (bounded by
        # the MAX_LABELS walk at ~2.5KB): truncating here would make the
        # exact compare a prefix compare — a device over-allow the host
        # oracle never produces.
        width = max((len(b) for b in exact), default=0)
        width = max(8, (width + 7) // 8 * 8)
    elif any(len(b) > width for b in exact):
        raise ValueError(f"needle width {width} does not cover every name")
    needle = np.zeros((n_pad, width), np.uint8)
    n_len = np.full((n_pad,), -1, np.int32)
    n_any = np.zeros((n_pad,), bool)
    use_rx = np.zeros((n_pad,), bool)
    patterns = []
    for i, (_, rule) in enumerate(rows):
        if rule is None or not (rule.name or rule.pattern or rule.regex):
            n_any[i] = True
            patterns.append("")
            continue
        if rule.name:
            b = exact[i]
            needle[i, : len(b)] = np.frombuffer(b, np.uint8)
            n_len[i] = len(b)
            patterns.append("")
            continue
        use_rx[i] = True
        patterns.append(rule.device_pattern())
    packed_ids, any_remote = pack_remote_sets([r[0] for r in rows])
    n = len(rows)
    if n_pad > n:
        ids = np.full((n_pad, packed_ids.shape[1]), -1, np.int32)
        ids[:n] = packed_ids
        packed_ids = ids
        ar = np.zeros((n_pad,), bool)
        ar[:n] = any_remote
        any_remote = ar
    patterns += [""] * (n_pad - n)
    return needle, n_len, n_any, use_rx, packed_ids, any_remote, patterns


def build_dns_model_from_rows(
    rows: list, bucket: bool = False, device=None
) -> DnsBatchModel:
    """Compile (remote_set, DnsRule|None) rows onto ``device`` (None: the
    CUDA card); ``bucket=True`` pads the row axis to the power-of-two
    churn bucket (models/r2d2.MIN_RULE_BUCKET semantics).  The automaton
    is compiled only when some row has a pattern or regex; the reference
    compiles one for every model, but a row without one never reads it."""
    device = resolve_device(device)
    n = len(rows)
    n_pad = _rule_bucket(n) if bucket else n
    (needle, n_len, n_any, use_rx, packed_ids, any_remote,
     patterns) = dns_row_arrays(rows, n_pad)
    nfa = compile_automaton(patterns, device) if use_rx.any() else None
    kinds = tuple(
        "literal" if not (r is not None and (r.pattern or r.regex))
        else ("nfa" if isinstance(nfa, DeviceNfa) else "regex")
        for _, r in rows
    )

    def up(a):
        return torch.from_numpy(a).to(device)

    return DnsBatchModel(
        nfa=nfa,
        name_needle=up(needle),
        name_len=up(n_len),
        name_any=up(n_any),
        use_rx=up(use_rx),
        remote_ids=up(packed_ids),
        any_remote=up(any_remote),
        match_kinds=kinds,
        invariant_rows=reduce_dns_rows(rows),
    )


# --- kernel K8: frame + QNAME walk + dotted rewrite ---------------------------


class DnsName(NamedTuple):
    """Frame and QNAME structure of each row's first prefixed frame."""

    complete: torch.Tensor  # [F] bool — the prefixed frame fits in lengths
    msg_len: torch.Tensor  # [F] int32 — prefix value + 2
    valid: torch.Tensor  # [F] bool — the question is well-formed
    span_start: torch.Tensor  # [F] int32 — always the first label byte (15)
    span_end: torch.Tensor  # [F] int32 — the terminal zero where valid, else 15
    dotted: torch.Tensor  # [F, L] uint8 — the row folded, '.' at separators


def dns_name_plain(data: torch.Tensor, lengths: torch.Tensor) -> DnsName:
    """Plain PyTorch version of K8: the reference's column scan
    (``cilium_tpu/models/dns.py:223-288``), one step per byte column."""
    f, l = data.shape
    if l < DNS_MIN_FRAME:
        z = torch.zeros((f,), dtype=torch.int32, device=data.device)
        no = torch.zeros((f,), dtype=torch.bool, device=data.device)
        return DnsName(no, z, no.clone(), z, z.clone(), data.clone())
    d32 = data.to(torch.int32)
    msg_len = ((d32[:, 0] << 8) | d32[:, 1]) + DNS_PREFIX_LEN
    complete = (lengths >= DNS_PREFIX_LEN) & (msg_len <= lengths)
    qd = (d32[:, 6] << 8) | d32[:, 7]
    limit = torch.minimum(msg_len, torch.full_like(msg_len, l))
    invalid = ~complete | (msg_len < DNS_MIN_FRAME) | (qd < 1)
    pos = torch.full((f,), _QNAME_OFF, dtype=torch.int32, device=data.device)
    done = torch.zeros((f,), dtype=torch.bool, device=data.device)
    nlab = torch.zeros((f,), dtype=torch.int32, device=data.device)
    is_sep = torch.zeros((f, l), dtype=torch.bool, device=data.device)
    for c in range(l):
        lb = d32[:, c]
        at = (pos == c) & ~done & ~invalid
        readable = c < limit
        invalid = invalid | (at & ~readable)
        act = at & readable
        terminal = act & (lb == 0)
        done = done | terminal
        step = act & ~terminal
        # Compression pointer / oversized label / too many labels.
        bad = (lb > MAX_LABEL) | (nlab >= MAX_LABELS)
        invalid = invalid | (step & bad)
        step = step & ~bad
        pos = torch.where(step, pos + 1 + lb, pos)
        nlab = nlab + step.to(torch.int32)
        is_sep[:, c] = step
    # Never terminated (chain left the row / too deep) or a question
    # section that cannot hold QTYPE+QCLASS: invalid.
    invalid = invalid | ~done | (pos + 5 > msg_len)
    valid = ~invalid
    span_start = torch.full((f,), _QNAME_OFF + 1, dtype=torch.int32, device=data.device)
    span_end = torch.where(valid, pos, span_start)
    upper = (data >= 0x41) & (data <= 0x5A)
    folded = torch.where(upper, data + 0x20, data)
    dotted = torch.where(is_sep, torch.full_like(data, 0x2E), folded)
    return DnsName(complete, msg_len, valid, span_start, span_end, dotted)


def dns_name(data: torch.Tensor, lengths: torch.Tensor) -> DnsName:
    """K8: frame each row's first prefixed DNS frame, walk its QNAME and
    rewrite the row to the dotted, folded name.  data [F, L] uint8,
    lengths [F] int32, on one device."""
    device = data.device
    kernels.check(data, "data", torch.uint8, (None, None), device)
    f, l = data.shape
    kernels.check(lengths, "lengths", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return dns_name_plain(data, lengths)
    complete = torch.empty((f,), dtype=torch.bool, device=device)
    valid = torch.empty((f,), dtype=torch.bool, device=device)
    msg_len, span_start, span_end = (
        torch.empty((f,), dtype=torch.int32, device=device) for _ in range(3)
    )
    dotted = torch.empty_like(data)
    if f:
        p = kernels.p
        _DNS_NAME.launch(
            device, p(data), p(lengths), f, l, p(complete), p(msg_len),
            p(valid), p(span_start), p(span_end), p(dotted),
        )
    return DnsName(complete, msg_len, valid, span_start, span_end, dotted)


# --- kernel K9: rule-row walk ---------------------------------------------------


def dns_hits_plain(model: DnsBatchModel, name: DnsName, rx, remotes):
    """Plain PyTorch version of K9: (allow [F] bool, rule [F] int32)
    (``cilium_tpu/models/dns.py:291-342`` after the automaton tier)."""
    s, e, dotted = name.span_start, name.span_end, name.dotted
    exact_ok = spans_equal_prefix(dotted, s, e, model.name_needle, model.name_len)
    matched = exact_ok
    if rx is not None:
        matched = matched | (model.use_rx[None, :] & rx)
    # The QNAME validity gate masks name-CONSTRAINED rows only: a
    # malformed question can never satisfy a name rule, but a byte-free
    # "allow these peers' DNS" row admits any complete frame — the
    # invariance contract the verdict cache's byte-free claim rests on
    # (policy/invariance.reduce_dns_rows).
    name_ok = model.name_any[None, :] | (matched & name.valid[:, None])
    hits = name_ok & remote_ok(remotes, model.remote_ids, model.any_remote)
    allow = hits.any(dim=1)
    return allow, first_match(hits, allow)


def dns_hits(model: DnsBatchModel, name: DnsName, rx, remotes):
    """K9: (allow [F] bool, rule [F] int32) — the first rule row whose
    name test (exact needle, the automaton hit ``rx`` [F, R] bool on the
    dotted span where the row uses it, or none) and remote set both hold,
    -1 where none does.  ``rx`` is None when the model has no automaton."""
    device = model.device
    kernels.check(name.dotted, "dotted", torch.uint8, (None, None), device)
    f, l = name.dotted.shape
    r, w = model.name_needle.shape
    kernels.check(name.valid, "valid", torch.bool, (f,), device)
    kernels.check(name.span_start, "span_start", torch.int32, (f,), device)
    kernels.check(name.span_end, "span_end", torch.int32, (f,), device)
    if (rx is None) != (model.nfa is None):
        raise ValueError("rx: expected the automaton's hits exactly when the model has one")
    if rx is not None:
        kernels.check(rx, "rx", torch.bool, (f, r), device)
    kernels.check(remotes, "remotes", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return dns_hits_plain(model, name, rx, remotes)
    allow = torch.empty((f,), dtype=torch.bool, device=device)
    rule = torch.empty((f,), dtype=torch.int32, device=device)
    if f:
        p = kernels.p
        _DNS_HITS.launch(
            device, p(name.dotted), p(name.valid), p(name.span_start),
            p(name.span_end), ctypes.c_void_p(None) if rx is None else p(rx),
            p(remotes), p(model.name_needle), p(model.name_len),
            p(model.name_any), p(model.use_rx), p(model.remote_ids),
            p(model.any_remote), f, l, r, w, p(allow), p(rule),
        )
    return allow, rule


# --- the verdict pass --------------------------------------------------------


def _verdict_pass(model: DnsBatchModel, data, lengths, remotes):
    device = model.device
    data = as_tensor(data, torch.uint8, device)
    lengths = as_tensor(lengths, torch.int32, device)
    remotes = as_tensor(remotes, torch.int32, device)
    name = dns_name(data, lengths)
    rx = None
    if model.nfa is not None:
        rx = automaton_search_spans(
            model.nfa, name.dotted, name.span_start, name.span_end
        )  # [F, R]
    allow, rule = dns_hits(model, name, rx, remotes)
    return name.complete, name.msg_len, allow, rule


def dns_verdicts(model: DnsBatchModel, data, lengths, remotes):
    """(complete [F] bool, msg_len [F] int32, allow [F] bool) as tensors
    on the model's device — msg_len is the whole prefixed frame; allow
    meaningful only where complete.  A structurally invalid query matches
    no name-constrained rule.  Inputs may be numpy arrays or tensors."""
    complete, msg_len, allow, _ = _verdict_pass(model, data, lengths, remotes)
    return complete, msg_len, allow


def dns_verdicts_attr(model: DnsBatchModel, data, lengths, remotes):
    """dns_verdicts plus the deciding rule row (the first matching
    flattened row — the host ``matches_at`` walk order — or -1)."""
    return _verdict_pass(model, data, lengths, remotes)
