"""Per-connection OnData dispatch loop.

A copy of ``cilium_tpu/proxylib/connection.py`` (``Connection`` and
``InjectBuf``); ``runtime/l7engine.py`` drives the streaming parsers
through it.  Reference: proxylib/proxylib/connection.go.  The loop
semantics are the op/byte-exact oracle every device batch path is
validated against:

- loop until the op list reaches capacity or the parser yields NOP/MORE
- a zero byte count from the parser is a parser error
- PASS/DROP advance the input chunk list; INJECT does not
- stop after INJECT if the inject buffer filled up
- parser exceptions produce a Denied access-log entry and PARSER_ERROR
  (reference: connection.go:119-135)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import logging

from ..utils import flowdebug
from .accesslog import EntryType, LogEntry
from .types import DROP, ERROR, INJECT, MORE, NOP, PASS, FilterResult, OpType

_flow_log = logging.getLogger("cilium_tpu_torch.proxylib.flow")

# Default op-list capacity, matching the Envoy-side caller's array
# (reference: envoy/cilium_proxylib.cc:201 — max 16 ops per OnIO call).
FILTER_OPS_CAPACITY = 16


class InjectBuf:
    """Fixed-capacity inject buffer (the caller-owned C buffer analog,
    reference: connection.go:36-44,190-209)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.data = bytearray()

    def inject(self, data: bytes) -> int:
        n = min(len(data), self.capacity - len(self.data))
        self.data += data[:n]
        return n

    def is_full(self) -> bool:
        return len(self.data) >= self.capacity

    def take(self) -> bytes:
        out = bytes(self.data)
        self.data.clear()
        return out


def advance_input(chunks: list[bytes], nbytes: int) -> list[bytes]:
    """Skip ``nbytes`` over a chunk list (reference: connection.go:104-116)."""
    chunks = list(chunks)
    while nbytes > 0 and chunks:
        if nbytes < len(chunks[0]):
            chunks[0] = chunks[0][nbytes:]
            nbytes = 0
        else:
            nbytes -= len(chunks[0])
            chunks.pop(0)
    return chunks


@dataclass
class Connection:
    instance: Any  # Instance (duck-typed to avoid circular import)
    conn_id: int
    ingress: bool
    src_id: int
    dst_id: int
    src_addr: str
    dst_addr: str
    policy_name: str
    port: int
    parser_name: str = ""
    parser: Any = None
    orig_buf: InjectBuf = field(default_factory=lambda: InjectBuf(1024))
    reply_buf: InjectBuf = field(default_factory=lambda: InjectBuf(1024))
    # Rule attribution of the most recent policy decision on this
    # connection (flattened first-match row, -1 = denied/unattributed):
    # stamped by matches() below and by the device-assisted engines'
    # precomputed-verdict hook, read by the flow-record emission.
    last_rule_id: int = -1

    def on_data(
        self,
        reply: bool,
        end_stream: bool,
        data: list[bytes],
        ops: list[tuple[OpType, int]],
        ops_capacity: int = FILTER_OPS_CAPACITY,
    ) -> FilterResult:
        try:
            input_ = list(data)
            while len(ops) < ops_capacity:
                op, nbytes = self.parser.on_data(reply, end_stream, input_)
                if op == NOP:
                    break
                if nbytes == 0:
                    return FilterResult.PARSER_ERROR
                # Per-flow op tracing rides the flowdebug gate so the
                # hot loop pays one boolean when disabled (reference:
                # pkg/flowdebug consumers in pkg/proxy).
                flowdebug.log(
                    _flow_log, "conn %d %s %s op=%s n=%d",
                    self.conn_id, self.parser_name,
                    "reply" if reply else "orig", op.name, nbytes,
                )
                ops.append((op, nbytes))
                if op == MORE:
                    break
                if op in (PASS, DROP):
                    input_ = advance_input(input_, nbytes)
                    # loop back even with no data left: parser may inject
                    # frames at the end of the input
                if op == INJECT and self.inject_buf(reply).is_full():
                    break
            return FilterResult.OK
        except Exception as exc:  # parser "panic" recovery
            self.log(
                EntryType.Denied,
                proto=self.parser_name,
                fields={"status": f"Panic: {exc}"},
            )
            return FilterResult.PARSER_ERROR

    def matches(self, l7_data) -> bool:
        at = getattr(self.instance, "policy_matches_at", None)
        if at is not None:
            ok, rule = at(
                self.policy_name, self.ingress, self.port, self.src_id,
                l7_data,
            )
            self.last_rule_id = rule
            return ok
        return self.instance.policy_matches(
            self.policy_name, self.ingress, self.port, self.src_id, l7_data
        )

    def inject_buf(self, reply: bool) -> InjectBuf:
        return self.reply_buf if reply else self.orig_buf

    def inject(self, reply: bool, data: bytes) -> int:
        return self.inject_buf(reply).inject(data)

    def log(self, entry_type: EntryType, proto: str = "", fields: dict | None = None) -> None:
        self.instance.log(
            LogEntry(
                is_ingress=self.ingress,
                entry_type=entry_type,
                policy_name=self.policy_name,
                source_security_id=self.src_id,
                destination_security_id=self.dst_id,
                source_address=self.src_addr,
                destination_address=self.dst_addr,
                proto=proto or self.parser_name,
                fields=dict(fields or {}),
            )
        )
