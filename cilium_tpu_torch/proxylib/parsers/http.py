"""HTTP/1.x request-policy parser — the cilium.l7policy filter analog.

A copy of ``cilium_tpu/proxylib/parsers/http.py``: its ``HttpRule`` is the
host oracle the port's HTTP verdicts are held against
(``PolicyInstance.matches_at``), and ``head_and_body_len`` is the framing
the port's ``HttpBatchEngine`` shares with the streaming ``HttpParser``.

Reference: envoy/cilium_l7policy.cc:51 (per-request allow/deny in the
HTTP filter) + envoy/cilium_network_policy.h:50-76 (anchored regex on
path/method/host, exact header presence).  The reference serves HTTP
inside Envoy rather than proxylib; this build routes it through the
same parser seam as every other protocol so HTTP rides the sidecar
verdict service too (device model: models/http.py).

Framing: a request frame is the head (through CRLFCRLF) plus a
Content-Length body; the verdict covers the whole frame.  Denials
inject the reference's 403 response (envoy/cilium_l7policy.cc
AccessDenied body) and DROP the frame.  The reply direction passes
untouched — the reference's filter polices requests only.

Rule dialect: path/method/host are ANCHORED regexes evaluated with
Python ``re`` — deliberately mirroring the Envoy ``std::regex`` side of
the reference (the agent's POSIX dialect is the device compiler's
domain; the fuzz tests in tests/test_http_model.py pin the two
together on the shared corpus).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..accesslog import EntryType
from ..parser import parse_error, register_l7_rule_parser, register_parser_factory
from ..types import DROP, MORE, PASS

# The exact denial body the reference injects
# (envoy/cilium_l7policy.cc:91 denied_403_body_ = "Access denied").
HTTP_403 = (
    b"HTTP/1.1 403 Forbidden\r\ncontent-type: text/plain\r\n"
    b"content-length: 13\r\n\r\nAccess denied"
)
MAX_HEAD = 1 << 15  # heads beyond this are denied (engines.py MAX_WIDTH)


@dataclass
class HttpRequestData:
    method: str
    path: str
    host: str
    headers: list[str] = field(default_factory=list)


class HttpRule:
    """One PortRuleHTTP-shaped matcher (reference:
    cilium_network_policy.h HttpNetworkPolicyRule::Matches)."""

    def __init__(self, method="", path="", host="", headers=()):
        # Pattern sources are kept so the device model compiles from
        # the same strings (models/http.build_http_model_for_port).
        self.method_src = method
        self.path_src = path
        self.host_src = host
        self.method = re.compile(method) if method else None
        self.path = re.compile(path) if path else None
        self.host = re.compile(host) if host else None
        self.headers = list(headers)

    def matches(self, data) -> bool:
        if not isinstance(data, HttpRequestData):
            return False
        if self.method is not None and not self.method.fullmatch(data.method):
            return False
        if self.path is not None and not self.path.fullmatch(data.path):
            return False
        if self.host is not None and not self.host.fullmatch(data.host):
            return False
        return all(self._header_present(h, data.headers) for h in self.headers)

    @staticmethod
    def _header_present(rule_header: str, headers: list[str]) -> bool:
        """Case-insensitive name + OWS-stripped value equality — the
        same semantics the device model compiles
        (models/http.py _header_pattern)."""
        name, sep, value = rule_header.partition(":")
        if not sep:
            return rule_header in headers
        want = (name.lower(), value.strip())
        for h in headers:
            hn, hsep, hv = h.partition(":")
            if hsep and (hn.lower(), hv.strip(" \t")) == want:
                return True
        return False


def http_rule_parser(rule_config):
    """Compile the typed http_rules list (reference:
    pkg/envoy/server.go:336 getHTTPRule translation target)."""
    rules = []
    for rd in rule_config.http_rules or []:
        bad = set(rd) - {"method", "path", "host", "headers"}
        if bad:
            parse_error(f"Unsupported http rule keys: {sorted(bad)}",
                        rule_config)
        try:
            rules.append(
                HttpRule(
                    method=rd.get("method", ""),
                    path=rd.get("path", ""),
                    host=rd.get("host", ""),
                    headers=rd.get("headers", ()),
                )
            )
        except re.error as e:
            parse_error(f"invalid http rule regex: {e}", rule_config)
    return rules


def head_and_body_len(buf: bytes) -> tuple[int, int] | None:
    """(head_len, body_len) once the full frame is buffered, else None
    (the same framing as runtime/engines.py HttpBatchEngine)."""
    end = buf.find(b"\r\n\r\n")
    if end < 0:
        return None
    head_len = end + 4
    body_len = 0
    lower = buf[:head_len].lower()
    idx = lower.find(b"\r\ncontent-length:")
    if idx >= 0:
        line_end = lower.find(b"\r\n", idx + 2)
        try:
            # Clamp: a negative Content-Length must never shrink the
            # frame span (it would walk framing offsets backwards).
            body_len = max(0, int(lower[idx + 17:line_end].strip()))
        except ValueError:
            body_len = 0
    if len(buf) < head_len + body_len:
        return None
    return head_len, body_len


def parse_head(head: bytes) -> HttpRequestData | None:
    lines = head.decode("utf-8", "surrogateescape").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 3:
        return None
    headers = [h for h in lines[1:] if h]
    # Host lookup mirrors the device model's pattern
    # (models/http.py: case-insensitive name, OWS-stripped value).
    host = ""
    for h in headers:
        name, sep, value = h.partition(":")
        if sep and name.lower() == "host":
            host = value.strip(" \t")
    return HttpRequestData(
        method=parts[0], path=parts[1], host=host, headers=headers
    )


class HttpParser:
    def __init__(self, connection):
        self.connection = connection

    def on_data(self, reply, end_stream, data):
        joined = b"".join(data)
        if reply:
            # Responses pass untouched (the reference's HTTP filter
            # polices the request path only).
            return (PASS, len(joined)) if joined else (MORE, 1)

        framed = head_and_body_len(joined)
        if framed is None:
            if len(joined) > MAX_HEAD:
                # Pathological unterminated head: deny what's buffered.
                self.connection.inject(True, HTTP_403)
                return DROP, len(joined)
            return MORE, 1
        head_len, body_len = framed
        req = parse_head(joined[:head_len])
        matches = req is not None and self.connection.matches(req)
        self.connection.log(
            EntryType.Request if matches else EntryType.Denied,
            proto="http",
            fields={
                "method": req.method if req else "",
                "url": req.path if req else "",
                "status": "200" if matches else "403",
            },
        )
        if not matches:
            self.connection.inject(True, HTTP_403)
            return DROP, head_len + body_len
        return PASS, head_len + body_len


class HttpParserFactory:
    def create(self, connection):
        return HttpParser(connection)


register_parser_factory("http", HttpParserFactory())
register_l7_rule_parser("http", http_rule_parser)
