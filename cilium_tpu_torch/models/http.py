"""HTTP batch verdict model: request-line + header policy on one device.

Counterpart of ``cilium_tpu/models/http.py``.  Replaces the reference's
per-request std::regex walk in the Envoy filter (reference:
envoy/cilium_l7policy.cc:51 + cilium_network_policy.h:50-76
HttpNetworkPolicyRule: anchored regex on path/method/host, exact header
presence) with one device pass over a [flows, bytes] batch of request
heads, three to six kernel launches on the card:

  1. frame + tokenize (K5 ``http_frame``): the first CRLFCRLF (head end),
     the request line's CRLF, its two spaces (method span [0, sp1), path
     span [sp1 + 1, sp2)) and the last LF inside each span
  2. literal tier (K6 ``http_lit``): omitted fields allow everything,
     literal and literal-prefix patterns ("GET", "GET|HEAD",
     "/api/v1/.*") match by byte compares, scattered onto their rules
  3. regex tier (K2 ``dfa_scan`` or K3 ``nfa_scan``, unchanged): the
     leftover anchored patterns over the method and path spans, and the
     CRLF-framed host/header patterns over the header block
     [line_end, head_len - 2)
  4. combine (K7 ``http_hits``): per rule, method AND path AND every head
     pattern AND the remote set; a request is allowed iff some rule
     holds, and the first such rule row is the attribution.

The tiers are bit-identical to the pure-regex path: literal analysis is
done on the parsed AST (so escapes and alternation mirror the compiler),
and literal-prefix rows carry the regex ``.*``-excludes-newline guard.
The host compile (pattern analysis, table packing) is a copy of the
reference's; on the CPU every kernel runs its plain PyTorch version, which
follows the reference's jnp formulation.

Deny maps to a 403 response injected by the runtime engine
(``runtime/engines.py``; reference: cilium_l7policy.cc 403 body).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from ..ops.bytescan import first_occurrence, first_subsequence2, spans_equal_prefix, spans_start_with
from ..ops.rxsearch import DeviceDfa, DeviceNfa, automaton_search_spans, compile_automaton
from ..policy.api import PortRuleHTTP
from ..policy.invariance import reduce_http_rows
from ..regex.parse import DOT_BYTES, ParseError, parse
from .base import (
    MAX_REMOTES,
    ConstVerdict,
    VerdictModel,
    first_match,
    pack_remote_sets,
    remote_ok,
)

_RE_META = set("\\^$.[]|()*+?{}")

LIT_W = 64  # max literal needle bytes; longer literals fall to regex

_HTTP_FRAME = kernels.CudaKernel(
    "http_frame", "http_frame",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8,
)
_HTTP_LIT = kernels.CudaKernel(
    "http_lit", "http_lit",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 2,
)
_HTTP_HITS = kernels.CudaKernel(
    "http_hits", "http_hits",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int]
    + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2,
)


def re_escape(s: str) -> str:
    """Escape a literal for the POSIX-extended regex compiler."""
    return "".join("\\" + c if c in _RE_META else c for c in s)


def _ci_literal(s: str) -> str:
    """Case-insensitive regex for a literal (header field names are
    case-insensitive, RFC 9110)."""
    out = []
    for c in s:
        if c.isalpha():
            out.append(f"[{c.upper()}{c.lower()}]")
        elif c in _RE_META:
            out.append("\\" + c)
        else:
            out.append(c)
    return "".join(out)


def _header_pattern(header: str) -> str:
    """'Name: value' -> CRLF-framed pattern with case-insensitive name and
    optional OWS around the value (matching the Host handling and the
    reference's case-insensitive header lookup)."""
    name, sep, value = header.partition(":")
    if not sep:
        return "\r\n" + re_escape(header) + "\r\n"
    return (
        "\r\n" + _ci_literal(name) + ":[ \t]*"
        + re_escape(value.strip()) + "[ \t]*\r\n"
    )


# --- literal-tier analysis ------------------------------------------------

def _ast_literal(node) -> bytes | None:
    """Bytes of a pure single-byte-literal concatenation, else None."""
    kind = node[0]
    if kind == "empty":
        return b""
    if kind == "lit":
        s = node[1]
        return bytes([next(iter(s))]) if len(s) == 1 else None
    if kind == "cat":
        parts = [_ast_literal(x) for x in node[1]]
        if any(p is None for p in parts):
            return None
        return b"".join(parts)
    return None


def _ast_dotstar(node) -> bool:
    return node[0] == "star" and node[1][0] == "lit" and node[1][1] == DOT_BYTES


def analyze_literal(pattern: str):
    """Classify a rule field pattern for the literal tier.

    Returns ("any", None) — omitted field, no constraint;
            ("lits", [bytes, ...]) — full match any of the literals;
            ("prefix", bytes) — literal then ``.*`` (newline-guarded);
            None — general regex (tier 2).
    The analysis runs on the parsed AST so escaping/alternation exactly
    mirror the regex compiler's reading of the pattern."""
    if pattern == "":
        return ("any", None)
    try:
        ast = parse(pattern)
    except ParseError:
        return None  # surface the error via the regex compiler
    lit = _ast_literal(ast)
    if lit is not None:
        return ("lits", [lit]) if len(lit) <= LIT_W else None
    if _ast_dotstar(ast):
        return ("prefix", b"")
    if ast[0] == "cat" and len(ast[1]) >= 2 and _ast_dotstar(ast[1][-1]):
        head = (
            ast[1][0] if len(ast[1]) == 2 else ("cat", ast[1][:-1])
        )
        lit = _ast_literal(head)
        if lit is not None and len(lit) <= LIT_W:
            return ("prefix", lit)
    if ast[0] == "alt":
        outs = [_ast_literal(b) for b in ast[1]]
        if all(o is not None and len(o) <= LIT_W for o in outs):
            return ("lits", outs)
    return None


def analyze_rules(
    rules_with_remotes: list, tiers_on: bool = True
) -> tuple:
    """Classify every rule's method/path into the literal or regex tier
    and collect host/header patterns."""
    r = len(rules_with_remotes)
    m_rows: list[tuple[bytes, bool, int]] = []  # (needle, prefix, rule)
    p_rows: list[tuple[bytes, bool, int]] = []
    line_patterns: list[str] = []
    line_rule: list[int] = []
    line_slot: list[int] = []
    method_any = np.zeros((r,), bool)
    path_any = np.zeros((r,), bool)
    head_patterns: list[str] = []
    head_rule: list[int] = []
    head_count: list[int] = []

    for i, (_, h) in enumerate(rules_with_remotes):
        for slot, field_ in ((0, h.method), (1, h.path)):
            kind = analyze_literal(field_) if tiers_on else (
                ("any", None) if field_ == "" else None
            )
            if kind is None:
                # Anchored full matches (Envoy regex_match semantics,
                # cilium_network_policy.h:50).
                line_patterns.append(f"^({field_})$" if field_ else "^.*$")
                line_rule.append(i)
                line_slot.append(slot)
            elif kind[0] == "any":
                (method_any if slot == 0 else path_any)[i] = True
            elif kind[0] == "lits":
                rows = m_rows if slot == 0 else p_rows
                for lit in kind[1]:
                    rows.append((lit, False, i))
            else:  # prefix
                rows = m_rows if slot == 0 else p_rows
                rows.append((kind[1], True, i))
        n_head = 0
        if h.host:
            # Field names are case-insensitive and OWS after ':' is
            # optional (RFC 9110); match any casing and whitespace run.
            head_patterns.append(
                f"\r\n[Hh][Oo][Ss][Tt]:[ \t]*({h.host})[ \t]*\r\n"
            )
            head_rule.append(i)
            n_head += 1
        for header in h.headers:
            head_patterns.append(_header_pattern(header))
            head_rule.append(i)
            n_head += 1
        head_count.append(n_head)
    return (m_rows, p_rows, line_patterns, line_rule, line_slot,
            method_any, path_any, head_patterns, head_rule, head_count)


def lit_arrays(rows: list, n_pad: int | None = None,
               width: int | None = None):
    """Pack (needle, prefix, rule) literal rows into numpy arrays, padded
    to ``n_pad`` rows (dead rows have live=False; a slot with no rows
    gets one dead row).  The needle width is trimmed to the longest
    actual needle (rounded up to 8, min 8); pass ``width`` to fix it."""
    n = max(len(rows), 1) if n_pad is None else n_pad
    if width is None:
        max_len = max((len(lit) for lit, _, _ in rows), default=0)
        width = min(LIT_W, max(8, (max_len + 7) // 8 * 8))
    w = width
    needle = np.zeros((n, w), np.uint8)
    nlen = np.zeros((n,), np.int32)
    prefix = np.zeros((n,), bool)
    rule = np.zeros((n,), np.int32)
    live = np.zeros((n,), bool)
    for k, (lit, pfx, ri) in enumerate(rows):
        needle[k, : len(lit)] = np.frombuffer(lit, np.uint8)
        nlen[k] = len(lit)
        prefix[k] = pfx
        rule[k] = ri
        live[k] = True
    return needle, nlen, prefix, rule, live


def _csr(owner: torch.Tensor, n_rules: int, keep: torch.Tensor | None = None):
    """(ptr [R + 1] int32, idx [n] int32): the row indices each rule owns
    (those ``keep`` selects), in row order: rule r's rows are
    idx[ptr[r]:ptr[r + 1]], for K6's and K7's per-rule walks."""
    owner = owner.cpu().long()
    sel = torch.arange(owner.shape[0])
    if keep is not None:
        sel = sel[keep.cpu()]
    owner = owner[sel]
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n_rules)
    ptr = torch.zeros((n_rules + 1,), dtype=torch.int32)
    ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return ptr, sel[order].to(torch.int32)


@dataclass
class HttpBatchModel(VerdictModel):
    # tier 1: literal method (slot m) / path (slot p) rows
    m_needle: torch.Tensor  # [Nm, W] uint8, W a multiple of 8, <= LIT_W
    m_len: torch.Tensor  # [Nm] int32
    m_prefix: torch.Tensor  # [Nm] bool
    m_rule: torch.Tensor  # [Nm] int32
    m_live: torch.Tensor  # [Nm] bool (False = padding row)
    p_needle: torch.Tensor  # [Np, W'] uint8
    p_len: torch.Tensor  # [Np] int32
    p_prefix: torch.Tensor  # [Np] bool
    p_rule: torch.Tensor  # [Np] int32
    p_live: torch.Tensor  # [Np] bool
    method_any: torch.Tensor  # [R] bool — field omitted
    path_any: torch.Tensor  # [R] bool
    # tier 2: general regex line patterns (anchored), slot-tagged
    line_nfa: "DeviceNfa | DeviceDfa | None"
    line_rule: torch.Tensor  # [PL] int32
    line_slot: torch.Tensor  # [PL] int32 — 0 method, 1 path
    # host/header patterns over the request head
    head_nfa: "DeviceNfa | DeviceDfa | None"
    head_rule: torch.Tensor  # [P] int32 — owning rule row
    head_count: torch.Tensor  # [R] int32 — head patterns per rule
    remote_ids: torch.Tensor  # [R, MAX_REMOTES] int32
    any_remote: torch.Tensor  # [R] bool
    n_rules: int = 0
    # Which spans the regex tier searches: an all-path pattern set skips
    # the method-span automaton pass entirely.
    has_method_rx: bool = False
    has_path_rx: bool = False
    # Per-rule compiled match kind (literal|regex|nfa) — attribution
    # labels only, never device data.
    match_kinds: tuple = ()
    # Per-rule (remote_set_or_None, byte_free) reduction for the verdict
    # cache's byte-invariance analysis (policy/invariance.py); None makes
    # no claim (a model built without its rule rows).
    invariant_rows: tuple | None = None
    # K7's per-rule pattern lists, derived from line_rule/line_slot and
    # head_rule once, here.
    csr: dict = field(init=False, repr=False)
    # K6's per-rule lists of the live literal rows of each slot
    # (m_ptr, m_idx, p_ptr, p_idx), derived from m_rule/m_live and
    # p_rule/p_live once, here.
    lit_csr: dict = field(init=False, repr=False)

    def __post_init__(self):
        # The kernels read these tables as they are: check them once,
        # here, and only the per-call data in each wrapper.
        device = self.device
        r = self.n_rules
        if r < 1:
            raise ValueError("an HttpBatchModel needs at least one rule row")
        chk = kernels.check
        for slot in ("m", "p"):
            needle = getattr(self, f"{slot}_needle")
            chk(needle, f"{slot}_needle", torch.uint8, (None, None), device)
            n, w = needle.shape
            if n < 1 or w % 8 or not 8 <= w <= LIT_W:
                raise ValueError(
                    f"{slot}_needle: expected [N >= 1, W] with W a multiple "
                    f"of 8 in [8, {LIT_W}], got {tuple(needle.shape)}"
                )
            chk(getattr(self, f"{slot}_len"), f"{slot}_len", torch.int32, (n,), device)
            chk(getattr(self, f"{slot}_prefix"), f"{slot}_prefix", torch.bool, (n,), device)
            chk(getattr(self, f"{slot}_rule"), f"{slot}_rule", torch.int32, (n,), device)
            chk(getattr(self, f"{slot}_live"), f"{slot}_live", torch.bool, (n,), device)
        chk(self.method_any, "method_any", torch.bool, (r,), device)
        chk(self.path_any, "path_any", torch.bool, (r,), device)
        chk(self.line_rule, "line_rule", torch.int32, (None,), device)
        pl = self.line_rule.shape[0]
        chk(self.line_slot, "line_slot", torch.int32, (pl,), device)
        chk(self.head_rule, "head_rule", torch.int32, (None,), device)
        chk(self.head_count, "head_count", torch.int32, (r,), device)
        chk(self.remote_ids, "remote_ids", torch.int32, (r, MAX_REMOTES), device)
        chk(self.any_remote, "any_remote", torch.bool, (r,), device)
        for name, tab, n in (("line_nfa", self.line_nfa, pl),
                             ("head_nfa", self.head_nfa, self.head_rule.shape[0])):
            if tab is not None and (tab.device != device or tab.n_patterns != n):
                raise ValueError(f"{name}: expected {n} patterns on {device}")
        # K6 and K7 index outputs and hit columns with these: a value out
        # of range would be an access out of bounds on the card.
        for name, hi in (("m_rule", r), ("p_rule", r), ("line_rule", r), ("head_rule", r),
                         ("m_len", self.m_needle.shape[1] + 1),
                         ("p_len", self.p_needle.shape[1] + 1), ("line_slot", 2)):
            t = getattr(self, name)
            if t.numel() and (int(t.min()) < 0 or int(t.max()) >= hi):
                raise ValueError(f"{name}: values must lie in [0, {hi})")

        def on_device(parts):
            return {
                f"{k}_{name}": t.to(device)
                for k, pair in parts.items() for name, t in zip(("ptr", "idx"), pair)
            }

        is_m = self.line_slot == 0
        self.csr = on_device({
            "m": _csr(self.line_rule, r, is_m),
            "p": _csr(self.line_rule, r, ~is_m),
            "h": _csr(self.head_rule, r),
        })
        self.lit_csr = on_device({
            slot: _csr(getattr(self, f"{slot}_rule"), r, getattr(self, f"{slot}_live"))
            for slot in ("m", "p")
        })

    @property
    def device(self) -> torch.device:
        return self.m_needle.device

    def __call__(self, data, lengths, remotes):
        return http_verdicts(self, data, lengths, remotes)

    def verdicts_attr(self, data, lengths, remotes):
        return http_verdicts_attr(self, data, lengths, remotes)


def build_http_model(
    rules_with_remotes: list[tuple[frozenset, PortRuleHTTP]],
    backend: str = "auto",
    device=None,
) -> HttpBatchModel | ConstVerdict:
    """Compile (allowed_remote_set, PortRuleHTTP) rows into tables on
    ``device`` (None: the CUDA card).

    Empty fields wildcard (reference: http.go — omitted fields allow all).
    ``backend`` governs the REGEX tier only: "nfa" (bitset NFA), "dfa"
    (per-pattern DFA), "auto" (DFA first, NFA fallback on determinization
    blowup or above the 128-state guard), or "regex-only" (disable the
    literal tier — every pattern through the automaton; used by parity
    tests)."""
    device = resolve_device(device)
    if not rules_with_remotes:
        return ConstVerdict(False)

    r = len(rules_with_remotes)
    rx_backend = "auto" if backend == "regex-only" else backend
    rows = analyze_rules(rules_with_remotes, tiers_on=backend != "regex-only")
    (m_rows, p_rows, line_patterns, line_rule, line_slot, method_any,
     path_any, head_patterns, head_rule, head_count) = rows

    packed_ids, any_remote = pack_remote_sets(
        [rs for rs, _ in rules_with_remotes]
    )

    mn, ml, mp, mr, mlive = lit_arrays(m_rows)
    pn, pl_, pp, pr, plive = lit_arrays(p_rows)

    line_tab = compile_automaton(line_patterns, device, rx_backend)
    head_tab = compile_automaton(head_patterns, device, rx_backend)

    def _tier(tab) -> str:
        return "nfa" if isinstance(tab, DeviceNfa) else "regex"

    # Per-rule match kind for attribution: a rule is "literal" when its
    # method/path resolved to tier 0/1 and it carries no head patterns;
    # any automaton involvement labels it by that automaton's backend
    # ("nfa" / "regex" per-pattern DFA), nfa winning when a rule touches
    # both tables.
    kinds = ["literal"] * r
    for i in line_rule:
        kinds[i] = _tier(line_tab)
    for i in head_rule:
        if kinds[i] != "nfa":
            kinds[i] = _tier(head_tab)

    def up(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype).copy()).to(device)

    return HttpBatchModel(
        m_needle=up(mn, np.uint8),
        m_len=up(ml, np.int32),
        m_prefix=up(mp, bool),
        m_rule=up(mr, np.int32),
        m_live=up(mlive, bool),
        p_needle=up(pn, np.uint8),
        p_len=up(pl_, np.int32),
        p_prefix=up(pp, bool),
        p_rule=up(pr, np.int32),
        p_live=up(plive, bool),
        method_any=up(method_any, bool),
        path_any=up(path_any, bool),
        line_nfa=line_tab,
        line_rule=up(line_rule, np.int32).reshape(-1),
        line_slot=up(line_slot, np.int32).reshape(-1),
        head_nfa=head_tab,
        head_rule=up(head_rule, np.int32).reshape(-1),
        head_count=up(head_count, np.int32),
        remote_ids=up(packed_ids, np.int32),
        any_remote=up(any_remote, bool),
        n_rules=r,
        has_method_rx=any(s == 0 for s in line_slot),
        has_path_rx=any(s == 1 for s in line_slot),
        match_kinds=tuple(kinds),
        invariant_rows=reduce_http_rows(rules_with_remotes),
    )


# --- kernel K5: head framing + request-line tokenize -------------------------


class HttpFrame(NamedTuple):
    """Per-flow framing of one request head; every field is [F]."""

    crlf2: torch.Tensor  # int32 — first CRLFCRLF with pos + 3 < len, else len
    complete: torch.Tensor  # bool — crlf2 < len
    head_len: torch.Tensor  # int32 — crlf2 + 4
    line_end: torch.Tensor  # int32 — first CRLF with pos + 1 < len, else len
    sp1: torch.Tensor  # int32 — first space in [0, line_end), else line_end
    sp2: torch.Tensor  # int32 — first space in (sp1, line_end), else line_end
    last_nl_m: torch.Tensor  # int32 — last LF in [0, sp1), else -1
    last_nl_p: torch.Tensor  # int32 — last LF in [sp1 + 1, sp2), else -1

    @property
    def p_start(self) -> torch.Tensor:
        """sp1 + 1, the path span's start."""
        return self.sp1 + 1

    @property
    def h_end(self) -> torch.Tensor:
        """head_len - 2, the header block's end."""
        return self.head_len - 2


def _positions(data: torch.Tensor) -> torch.Tensor:
    return torch.arange(data.shape[1], dtype=torch.int32, device=data.device)[None, :]


def _first_crlfcrlf(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """First CRLFCRLF at pos with pos + 3 < len, else len."""
    f, l = data.shape
    pos = _positions(data)

    def shifted(k):
        return torch.cat(
            [data[:, k:], torch.zeros((f, min(k, l)), dtype=data.dtype, device=data.device)],
            dim=1,
        )

    hit = (
        (data == 0x0D)
        & (shifted(1) == 0x0A)
        & (shifted(2) == 0x0D)
        & (shifted(3) == 0x0A)
        & ((pos + 3) < lengths[:, None])
    )
    return torch.where(hit, pos, lengths[:, None]).amin(dim=1)


def _first_occurrence_after(data, start, end, byte):
    """First ``byte`` at position > start and < end, else end."""
    pos = _positions(data)
    valid = (pos > start[:, None]) & (pos < end[:, None])
    hit = (data == byte) & valid
    return torch.where(hit, pos, end[:, None]).amin(dim=1)


def _last_in_span(data, start, end, byte):
    """Last ``byte`` at position >= start and < end, else -1."""
    pos = _positions(data)
    valid = (pos >= start[:, None]) & (pos < end[:, None])
    hit = (data == byte) & valid
    return torch.where(hit, pos, torch.full_like(pos, -1)).amax(dim=1)


def http_frame_plain(data: torch.Tensor, lengths: torch.Tensor) -> HttpFrame:
    """Plain PyTorch version of K5 (the reference's jnp formulas,
    ``cilium_tpu/models/http.py:440-449``)."""
    crlf2 = _first_crlfcrlf(data, lengths)
    line_end = first_subsequence2(data, lengths, 0x0D, 0x0A)
    sp1 = first_occurrence(data, line_end, 0x20)
    sp2 = _first_occurrence_after(data, sp1, line_end, 0x20)
    p_start = sp1 + 1
    head_len = crlf2 + 4
    return HttpFrame(
        crlf2=crlf2,
        complete=crlf2 < lengths,
        head_len=head_len,
        line_end=line_end,
        sp1=sp1,
        sp2=sp2,
        last_nl_m=_last_in_span(data, torch.zeros_like(sp1), sp1, 0x0A),
        last_nl_p=_last_in_span(data, p_start, sp2, 0x0A),
    )


def http_frame(data: torch.Tensor, lengths: torch.Tensor) -> HttpFrame:
    """K5: frame one request head per row and tokenize its request line.
    data [F, L] uint8, lengths [F] int32, on one device."""
    device = data.device
    kernels.check(data, "data", torch.uint8, (None, None), device)
    f, l = data.shape
    kernels.check(lengths, "lengths", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return http_frame_plain(data, lengths)
    outs = {
        name: torch.empty(
            (f,), dtype=torch.bool if name == "complete" else torch.int32, device=device
        )
        for name in HttpFrame._fields
    }
    if f:
        p = kernels.p
        _HTTP_FRAME.launch(
            device, p(data), p(lengths), f, l, *(p(outs[n]) for n in HttpFrame._fields)
        )
    return HttpFrame(**outs)


# --- kernel K6: literal tier --------------------------------------------------


def _lit_hits(data, start, end, last_nl, needle, nlen, prefix, live):
    """[F, N] literal-row hits on the span: exact rows need span == lit,
    prefix rows need span startswith lit AND no newline in the ``.*``
    remainder (regex ``.`` excludes \\n).  "No newline in the remainder"
    is exactly "the LAST span newline, if any, lies inside the needle
    bytes" — needle-internal newlines were matched literally."""
    exact = spans_equal_prefix(data, start, end, needle, nlen)
    starts = spans_start_with(data, start, end, needle, nlen)
    no_nl_after = last_nl[:, None] < start[:, None] + nlen[None, :]
    hit = torch.where(prefix[None, :], starts & no_nl_after, exact)
    return hit & live[None, :]


def _scatter_or(hits: torch.Tensor, rule_idx: torch.Tensor, n_rules: int) -> torch.Tensor:
    """[F, N] bool hits keyed by rule -> [F, R] bool any-hit.  Several
    rows may share a rule, so the rows are summed (``index_add_``, as the
    reference's ``.at[].add``), never written (which would drop all but
    one duplicate)."""
    counts = torch.zeros((hits.shape[0], n_rules), dtype=torch.int32, device=hits.device)
    counts.index_add_(1, rule_idx.long(), hits.to(torch.int32))
    return counts > 0


def http_lit_plain(model: HttpBatchModel, data, frame: HttpFrame):
    """Plain PyTorch version of K6: (method_ok, path_ok), [F, R] bool."""
    r = model.n_rules
    zero = torch.zeros_like(frame.sp1)
    method_ok = model.method_any[None, :] | _scatter_or(
        _lit_hits(data, zero, frame.sp1, frame.last_nl_m, model.m_needle,
                  model.m_len, model.m_prefix, model.m_live),
        model.m_rule, r,
    )
    path_ok = model.path_any[None, :] | _scatter_or(
        _lit_hits(data, frame.p_start, frame.sp2, frame.last_nl_p, model.p_needle,
                  model.p_len, model.p_prefix, model.p_live),
        model.p_rule, r,
    )
    return method_ok, path_ok


def http_lit(model: HttpBatchModel, data, frame: HttpFrame):
    """K6: the literal tier, (method_ok, path_ok) [F, R] bool — the
    wildcard flags OR the literal rows hit on each span, by rule."""
    device = model.device
    kernels.check(data, "data", torch.uint8, (None, None), device)
    f, l = data.shape
    for name in ("sp1", "sp2", "last_nl_m", "last_nl_p"):
        kernels.check(getattr(frame, name), name, torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return http_lit_plain(model, data, frame)
    r = model.n_rules
    method_ok = torch.empty((f, r), dtype=torch.bool, device=device)
    path_ok = torch.empty((f, r), dtype=torch.bool, device=device)
    if f:
        p = kernels.p
        c = model.lit_csr
        _HTTP_LIT.launch(
            device, p(data), p(frame.sp1), p(frame.sp2),
            p(frame.last_nl_m), p(frame.last_nl_p),
            p(model.m_needle), p(model.m_len), p(model.m_prefix),
            p(c["m_ptr"]), p(c["m_idx"]), model.m_needle.shape[1],
            p(model.p_needle), p(model.p_len), p(model.p_prefix),
            p(c["p_ptr"]), p(c["p_idx"]), model.p_needle.shape[1],
            p(model.method_any), p(model.path_any), f, l, r,
            p(method_ok), p(path_ok),
        )
    return method_ok, path_ok


# --- kernel K7: combine -------------------------------------------------------


def http_hits_plain(model: HttpBatchModel, complete, method_ok, path_ok,
                    rx_m, rx_p, head_hits, remotes):
    """Plain PyTorch version of K7: (allow [F] bool, rule [F] int32), the
    reference's scatter-by-slot, head-pattern count, remote test, any and
    first match (``cilium_tpu/models/http.py:466-536``)."""
    r = model.n_rules
    is_m = model.line_slot == 0
    if rx_m is not None:
        method_ok = method_ok | _scatter_or(rx_m & is_m[None, :], model.line_rule, r)
    if rx_p is not None:
        path_ok = path_ok | _scatter_or(rx_p & ~is_m[None, :], model.line_rule, r)
    if head_hits is not None:
        # all-of per rule: the patterns hit, counted per rule, reach
        # head_count (patterns, not bytes)
        per_rule = torch.zeros(
            (head_hits.shape[0], r), dtype=torch.int32, device=head_hits.device
        )
        per_rule.index_add_(1, model.head_rule.long(), head_hits.to(torch.int32))
        head_ok = per_rule >= model.head_count[None, :]
    else:
        head_ok = torch.ones_like(method_ok)
    rok = remote_ok(remotes, model.remote_ids, model.any_remote)
    hits = method_ok & path_ok & head_ok & rok
    allow = hits.any(dim=1) & complete
    return allow, first_match(hits, allow)


def http_hits(model: HttpBatchModel, complete, method_ok, path_ok,
              rx_m, rx_p, head_hits, remotes):
    """K7: (allow [F] bool, rule [F] int32) — the first rule row whose
    method, path, head patterns and remote set all hold on a complete
    head, -1 where none does.  ``rx_m`` / ``rx_p`` ([F, PL] bool) are the
    line automaton's hits on the method / path span and ``head_hits``
    ([F, P] bool) the head automaton's; each is None where the model has
    no such pass."""
    device = model.device
    kernels.check(complete, "complete", torch.bool, (None,), device)
    f = complete.shape[0]
    r = model.n_rules
    pl = model.line_rule.shape[0]
    pn = model.head_rule.shape[0]
    kernels.check(method_ok, "method_ok", torch.bool, (f, r), device)
    kernels.check(path_ok, "path_ok", torch.bool, (f, r), device)
    for name, t, n in (("rx_m", rx_m, pl), ("rx_p", rx_p, pl), ("head_hits", head_hits, pn)):
        if t is not None:
            kernels.check(t, name, torch.bool, (f, n), device)
    kernels.check(remotes, "remotes", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return http_hits_plain(model, complete, method_ok, path_ok, rx_m, rx_p, head_hits, remotes)
    allow = torch.empty((f,), dtype=torch.bool, device=device)
    rule = torch.empty((f,), dtype=torch.int32, device=device)
    if f:
        p = kernels.p

        def opt(t):
            return ctypes.c_void_p(None) if t is None else p(t)

        c = model.csr
        _HTTP_HITS.launch(
            device, p(complete), p(method_ok), p(path_ok), opt(rx_m), opt(rx_p), pl,
            opt(head_hits), pn, p(remotes),
            p(c["m_ptr"]), p(c["m_idx"]), p(c["p_ptr"]), p(c["p_idx"]),
            p(c["h_ptr"]), p(c["h_idx"]), p(model.head_count),
            p(model.remote_ids), p(model.any_remote), f, r,
            p(allow), p(rule),
        )
    return allow, rule


# --- the verdict pass --------------------------------------------------------


def _inputs(model: HttpBatchModel, data, lengths, remotes):
    device = model.device
    return (
        as_tensor(data, torch.uint8, device),
        as_tensor(lengths, torch.int32, device),
        as_tensor(remotes, torch.int32, device),
    )


def _verdict_pass(model: HttpBatchModel, data, lengths, remotes):
    data, lengths, remotes = _inputs(model, data, lengths, remotes)
    frame = http_frame(data, lengths)
    method_ok, path_ok = http_lit(model, data, frame)
    # Regex tier: the leftover anchored patterns, searched on the spans
    # the model's slots use, exactly where the reference calls search
    # (cilium_tpu/models/http.py:467-499).
    rx_m = rx_p = head_hits = None
    if model.line_nfa is not None:
        if model.has_method_rx:
            rx_m = automaton_search_spans(
                model.line_nfa, data, torch.zeros_like(frame.sp1), frame.sp1
            )
        if model.has_path_rx:
            rx_p = automaton_search_spans(model.line_nfa, data, frame.p_start, frame.sp2)
    # Host/header patterns over the head from the request line's CRLF,
    # so every header line is CRLF-framed.
    if model.head_nfa is not None:
        head_hits = automaton_search_spans(model.head_nfa, data, frame.line_end, frame.h_end)
    allow, rule = http_hits(
        model, frame.complete, method_ok, path_ok, rx_m, rx_p, head_hits, remotes
    )
    return frame.complete, frame.head_len, allow, rule


def http_verdicts(model: HttpBatchModel, data, lengths, remotes):
    """Returns (complete [F] bool, head_len [F] int32, allow [F] bool) as
    tensors on the model's device; inputs may be numpy arrays or tensors
    (data [F, L] uint8 request heads, lengths [F] int32 head length
    including the final CRLFCRLF, remotes [F] int32)."""
    complete, head_len, allow, _ = _verdict_pass(model, data, lengths, remotes)
    return complete, head_len, allow


def http_verdicts_attr(model: HttpBatchModel, data, lengths, remotes):
    """http_verdicts plus the deciding rule row: (complete, head_len,
    allow, rule [F] int32).  ``rule`` is the FIRST matching rule row in
    the host oracle's walk order (exact-port rules then wildcard, one
    row per (rule, matcher) — build_http_model_for_port's flattening),
    or -1 where not allowed."""
    return _verdict_pass(model, data, lengths, remotes)


def collect_http_rows(policy, ingress: bool, port: int):
    """Resolve the effective (remote_set, PortRuleHTTP) rows for
    (policy, direction, port), applying the reference's port cascade
    (exact port OR wildcard 0) — the HTTP twin of
    models/r2d2.collect_policy_rows.  Returns a ConstVerdict for the
    degenerate cases."""
    from ..proxylib.parsers.http import HttpRule

    if policy is None:
        return ConstVerdict(False)
    side = policy.ingress if ingress else policy.egress
    rows: list[tuple[frozenset, PortRuleHTTP]] = []
    for key in (port, 0):
        rules = side.by_port.get(key)
        if rules is None:
            continue
        if not rules.have_l7_rules or not rules.rules:
            return ConstVerdict(True)
        for rule in rules.rules:
            matchers = rule.l7_matchers or [None]
            for m in matchers:
                if m is None:
                    rows.append((rule.allowed_remotes, PortRuleHTTP()))
                else:
                    if not isinstance(m, HttpRule):
                        raise TypeError(f"not an http rule: {m!r}")
                    rows.append(
                        (
                            rule.allowed_remotes,
                            PortRuleHTTP(
                                method=m.method_src, path=m.path_src,
                                host=m.host_src, headers=list(m.headers),
                            ),
                        )
                    )
    if not rows:
        return ConstVerdict(False)
    return rows


def build_http_model_for_port(policy, ingress: bool, port: int,
                              backend: str = "auto", device=None):
    """Compile the effective HTTP rule rows for (policy, direction, port)
    from a proxylib PolicyInstance onto ``device`` (None: the CUDA card;
    see collect_http_rows for the cascade semantics)."""
    device = resolve_device(device)
    rows = collect_http_rows(policy, ingress, port)
    if isinstance(rows, ConstVerdict):
        return rows
    return build_http_model(rows, backend=backend, device=device)
