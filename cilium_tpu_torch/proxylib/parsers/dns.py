"""DNS-over-TCP name-policy parser — the streaming oracle of the DNS
engine family (models/dns.py is the device twin).

A copy of ``cilium_tpu/proxylib/parsers/dns.py``: its ``DnsRule`` is the
host oracle the port's DNS verdicts are held against
(``PolicyInstance.matches_at``), and ``frame_len`` is the framing
``runtime/dnsengine.py`` splits frames on.

Wire format (RFC 1035 §4.2.2): each message rides a 2-byte big-endian
length prefix; the message itself is a 12-byte header followed by the
question section — a QNAME label sequence (length-prefixed labels,
terminated by a zero byte) plus QTYPE/QCLASS.  This parser frames
requests on the length prefix, extracts the FIRST question's name, and
matches it against compiled name rules:

- ``matchName``   — exact name, case-insensitive (0x20-folded), trailing
                    dot stripped;
- ``matchPattern``— wildcard name: a leading ``*.`` matches one or MORE
                    whole labels; ``*`` anywhere else matches a run of
                    zero or more non-dot bytes; everything else literal.
                    Lowered onto the shared regex automaton;
- ``matchRegex``  — raw regex over the dotted, 0x20-folded name
                    (search semantics, like the r2d2 ``file`` rule).

Name canonicalization is deliberately byte-exact with the device model:
only bytes 0x41-0x5A fold (+0x20); labels join with ``.``; no trailing
dot; the root name is the empty string.  Queries the engine cannot
prove well-formed (compression pointers in QNAME, label > 63 bytes,
more than MAX_LABELS labels, truncated question, QDCOUNT == 0) can
never satisfy a name-CONSTRAINED rule, but a byte-free always-match
row ("allow these peers' DNS") still admits them — host and device
alike.  That asymmetry is load-bearing: it is what makes a byte-free
row genuinely byte-INVARIANT, so DNS flows ride the verdict
cache (policy/invariance.reduce_dns_rows).

Deny semantics: DROP the frame with NO reply inject (unlike r2d2's
``ERROR\\r\\n``): a synthesized DNS response would need the query id and
question echoed per frame, which the batched/columnar tiers cannot do
from a fixed template; the reference dnsproxy's REFUSED synthesis is
future work and noted in README.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...regex import CompiledPattern, compile_pattern, py_search
from ...regex.parse import ParseError as RegexParseError
from ..accesslog import EntryType
from ..parser import parse_error, register_l7_rule_parser, register_parser_factory
from ..types import DROP, MORE, PASS

# Structural bounds shared with the device model (models/dns.py): a
# name outside them is INVALID — it matches nothing, on both rungs.
DNS_HEADER_LEN = 12  # id, flags, qd/an/ns/ar counts
DNS_PREFIX_LEN = 2  # the TCP length prefix
DNS_QNAME_OFF = DNS_PREFIX_LEN + DNS_HEADER_LEN  # first label-length byte
MAX_LABEL = 63  # RFC 1035 label bound; >=64 means pointer/garbage
MAX_LABELS = 40  # engine bound (device walk iterations); legal names
#                  rarely exceed ~10 labels — deeper ones deny typed

_RX_ESCAPE = set(".\\+*?()[]{}|^$")


def fold_name_bytes(raw: bytes) -> bytes:
    """0x20-fold ASCII A-Z only — BYTE-EXACT with the device model's
    fold (str.lower would also fold latin-1 0xC0-0xDE)."""
    return bytes(b + 0x20 if 0x41 <= b <= 0x5A else b for b in raw)


def pattern_to_regex(pattern: str) -> str:
    """Lower a ``matchPattern`` wildcard onto the shared regex dialect,
    anchored: leading ``*.`` -> one or more whole labels; other ``*`` ->
    zero or more non-dot bytes; literals escaped."""
    body = pattern
    head = ""
    if body.startswith("*."):
        head = "([^.]+[.])+"
        body = body[2:]
    out = []
    for ch in body:
        if ch == "*":
            out.append("[^.]*")
        elif ch in _RX_ESCAPE:
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "^" + head + "".join(out) + "$"


@dataclass
class DnsRequestData:
    name: str  # dotted, 0x20-folded, no trailing dot ("" = root)
    # False = the engine could not prove the question well-formed:
    # name-CONSTRAINED rules can never match, but byte-free
    # always-match rules still do — the invariance contract the
    # verdict cache's byte-free claim rests on (see
    # policy/invariance.reduce_dns_rows and the device twin's gate).
    valid: bool = True


class DnsRule:
    """One compiled name matcher.  At most one of (name, pattern,
    regex) is set; none set = always-match (the byte-free row the
    verdict cache's invariance claim keys on)."""

    def __init__(self, name: str = "", pattern: str = "", regex: str = ""):
        self.name = name.rstrip(".").lower()
        self.pattern = pattern.rstrip(".").lower()
        self.regex = regex
        rx = None
        if self.pattern:
            rx = pattern_to_regex(self.pattern)
        elif regex:
            rx = regex
        self.compiled: CompiledPattern | None = (
            compile_pattern(rx) if rx is not None else None
        )

    def device_pattern(self) -> str:
        """The regex this row contributes to the device automaton
        ("" for exact/always rows — their automaton slot is dead)."""
        if self.pattern:
            return pattern_to_regex(self.pattern)
        return self.regex

    def matches(self, data) -> bool:
        if not isinstance(data, DnsRequestData):
            return False
        if self.name:
            return data.valid and data.name == self.name
        if self.compiled is not None:
            return data.valid and py_search(
                self.compiled, data.name.encode("latin-1", "replace")
            )
        return True  # byte-free row: any complete frame


def dns_rule_parser(rule_config):
    """Compile ``l7_rules`` kv dicts ({matchName|matchPattern|
    matchRegex: value}; empty dict = always-match) into DnsRule rows."""
    rules = []
    for kv in rule_config.l7_rules or []:
        name, pattern, regex = "", "", ""
        for k, v in kv.items():
            if k == "matchName":
                name = v
            elif k == "matchPattern":
                pattern = v
            elif k == "matchRegex":
                regex = v
            else:
                parse_error(f"Unsupported key: {k}", rule_config)
        if sum(1 for v in (name, pattern, regex) if v) > 1:
            parse_error(
                "DNS rule takes at most one of matchName/matchPattern/"
                "matchRegex", rule_config,
            )
        try:
            rules.append(DnsRule(name, pattern, regex))
        except RegexParseError as e:
            parse_error(f"invalid DNS regex: {e}", rule_config)
    return rules


def encode_dns_query(name: str, qtype: int = 1, qid: int = 0,
                     qdcount: int = 1) -> bytes:
    """One prefixed DNS-over-TCP query frame for ``name`` (probe grids,
    benches and tests share this single encoder)."""
    labels = [l for l in name.encode("latin-1", "replace").split(b".") if l]
    qn = b"".join(bytes([len(l)]) + l for l in labels) + b"\x00"
    msg = (
        qid.to_bytes(2, "big") + b"\x01\x00"
        + qdcount.to_bytes(2, "big") + b"\x00" * 6
        + qn + qtype.to_bytes(2, "big") + b"\x00\x01"
    )
    return len(msg).to_bytes(2, "big") + msg


def frame_len(buf: bytes) -> int:
    """Total length (prefix included) of the first DNS-over-TCP frame
    in ``buf``, or -1 while the 2-byte prefix is incomplete."""
    if len(buf) < DNS_PREFIX_LEN:
        return -1
    return DNS_PREFIX_LEN + ((buf[0] << 8) | buf[1])


def parse_dns_query(frame: bytes) -> str | None:
    """First-question name of one COMPLETE prefixed frame (dotted,
    0x20-folded, no trailing dot), or None when the engine cannot
    prove the question well-formed.  Walk order and every structural
    bound here are mirrored by the device model's label scan — parity
    tests pin the two bit-identical."""
    if len(frame) < DNS_PREFIX_LEN + DNS_HEADER_LEN + 1 + 4:
        return None
    end = frame_len(frame)
    if end > len(frame):
        return None
    qdcount = (frame[6] << 8) | frame[7]
    if qdcount < 1:
        return None
    pos = DNS_PREFIX_LEN + DNS_HEADER_LEN
    labels: list[bytes] = []
    for _ in range(MAX_LABELS + 1):
        if pos >= end:
            return None
        lb = frame[pos]
        if lb == 0:
            if pos + 5 > end:  # QTYPE + QCLASS must fit
                return None
            return fold_name_bytes(b".".join(labels)).decode("latin-1")
        if lb > MAX_LABEL or len(labels) >= MAX_LABELS:
            return None  # compression pointer / oversized / too deep
        if pos + 1 + lb > end:
            return None
        labels.append(frame[pos + 1 : pos + 1 + lb])
        pos += 1 + lb
    return None


class DnsParser:
    """Streaming oracle: frame on the length prefix, judge the query
    name, PASS/DROP whole frames (replies always pass — response
    policy is out of scope, like the r2d2 reply direction)."""

    def __init__(self, connection):
        self.connection = connection

    def on_data(self, reply, end_stream, data):
        joined = b"".join(data)
        need = frame_len(joined)
        if need < 0 or len(joined) < need:
            return MORE, 1
        if reply:
            return PASS, need

        name = parse_dns_query(joined[:need])
        req = DnsRequestData(
            name=name if name is not None else "",
            valid=name is not None,
        )
        matches = self.connection.matches(req)
        self.connection.log(
            EntryType.Request if matches else EntryType.Denied,
            proto="dns",
            fields={"query": req.name if name is not None else "<invalid>"},
        )
        if not matches:
            return DROP, need  # no inject (see module docstring)
        return PASS, need


class DnsParserFactory:
    def create(self, connection):
        return DnsParser(connection)


register_parser_factory("dns", DnsParserFactory())
register_l7_rule_parser("dns", dns_rule_parser)
