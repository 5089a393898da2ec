"""Human-readable event formatting for the monitor CLI.

reference: pkg/monitor/{format,dissect}.go + cilium/cmd/monitor.go output.
"""

from __future__ import annotations

import time

from .monitor import (
    MSG_TYPE_ACCESS_LOG,
    MSG_TYPE_AGENT,
    MSG_TYPE_DEBUG,
    MSG_TYPE_DROP,
    MSG_TYPE_POLICY_VERDICT,
    MSG_TYPE_POSTMORTEM,
    MSG_TYPE_TRACE,
    MonitorEvent,
)

_PROTO = {6: "tcp", 17: "udp", 0: "any"}


def _rule_attribution(p: dict) -> str:
    """Render the deciding-rule fields a flow-record-fed event carries
    (flowlog/ring.py): ` rule=<row> (<match kind>) policy=<name>` —
    THE one rendering shared by the DROP and POLICY-VERDICT lines (an
    operator correlates one against the other)."""
    if "rule_id" not in p:
        return ""
    rule = p.get("rule_id", -1)
    out = ""
    if rule is not None and rule >= 0:
        kind = p.get("match_kind") or "?"
        out = f" rule={rule} ({kind})"
    if p.get("policy"):
        out += f" policy={p['policy']}"
    return out


def format_event(ev: MonitorEvent) -> str:
    ts = time.strftime("%H:%M:%S", time.localtime(ev.timestamp))
    p = ev.payload
    if ev.type == MSG_TYPE_DROP:
        return (
            f"{ts} DROP: identity {p.get('src_identity')} -> "
            f"{p.get('dst_identity')} dport {p.get('dport')}"
            f"/{_PROTO.get(p.get('proto'), p.get('proto'))}"
            + (f" ({p['l7']})" if p.get("l7") else "")
            + _rule_attribution(p)
        )
    if ev.type == MSG_TYPE_POLICY_VERDICT:
        redirect = (
            f" redirect :{p['proxy_port']}" if p.get("proxy_port") else ""
        )
        word = "ALLOW" if p.get("allowed", True) else "DENY"
        return (
            f"{ts} POLICY-VERDICT: {word} identity "
            f"{p.get('src_identity')} -> "
            f"{p.get('dst_identity')} dport {p.get('dport')}"
            f"/{_PROTO.get(p.get('proto'), p.get('proto'))}{redirect}"
            + (f" ({p['l7']})" if p.get("l7") else "")
            + _rule_attribution(p)
        )
    if ev.type == MSG_TYPE_AGENT:
        return f"{ts} AGENT: {p.get('text', '')}"
    if ev.type == MSG_TYPE_ACCESS_LOG:
        return (
            f"{ts} L7: {p.get('verdict', '?')} "
            f"{p.get('l7_protocol', '?')} {p.get('info', '')}"
        )
    if ev.type == MSG_TYPE_TRACE:
        sv = p.get("slow_verdict") if isinstance(p, dict) else None
        if sv:
            # Slow-verdict exemplar from the sidecar latency tracer
            # (sidecar/trace.py): name the request and where its time
            # went, largest stage first.
            from ..sidecar.trace import format_stages_us

            stages = format_stages_us(sv.get("stages_us", {}))
            reason = f" reason={sv['reason']}" if sv.get("reason") else ""
            return (
                f"{ts} SLOW-VERDICT: path={sv.get('path', '?')} "
                f"seq={sv.get('seq')} conn={sv.get('conn_id')} "
                f"n={sv.get('entries')} "
                f"e2e={sv.get('e2e_us', 0) / 1e3:.2f}ms{reason} {stages}"
            )
        return f"{ts} TRACE: {p}"
    if ev.type == MSG_TYPE_POSTMORTEM:
        # Flight-recorder bundle (sidecar/blackbox.py): the fail-closed
        # edge that fired it, how deep the captured ring is, and where
        # the full bundle landed (if a bundle_dir was configured).
        reason = f" reason={p['reason']}" if p.get("reason") else ""
        path = f" bundle={p['path']}" if p.get("path") else ""
        return (
            f"{ts} POSTMORTEM: trigger={p.get('trigger', '?')} "
            f"seq={p.get('seq')} events={p.get('events')}{reason}{path}"
        )
    if ev.type == MSG_TYPE_DEBUG:
        return f"{ts} DEBUG: {p}"
    return f"{ts} UNKNOWN({ev.type}): {p}"
