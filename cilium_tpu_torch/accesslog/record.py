"""Canonical L7 access log record (reference: pkg/proxy/accesslog/record.go)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field, asdict
from typing import Optional

# Flow types (reference: record.go FlowType).
FLOW_TYPE_REQUEST = "Request"
FLOW_TYPE_RESPONSE = "Response"
FLOW_TYPE_SAMPLE = "Sample"

# Verdicts (reference: record.go FlowVerdict).
VERDICT_FORWARDED = "Forwarded"
VERDICT_DENIED = "Denied"
VERDICT_ERROR = "Error"

# Observation points (reference: record.go ObservationPoint).
OBS_POINT_INGRESS = "Ingress"
OBS_POINT_EGRESS = "Egress"


@dataclass
class EndpointInfo:
    """reference: record.go EndpointInfo."""

    id: int = 0
    identity: int = 0
    labels: list[str] = field(default_factory=list)
    ipv4: str = ""
    port: int = 0


@dataclass
class HttpLogEntry:
    """reference: record.go LogRecordHTTP."""

    code: int = 0
    method: str = ""
    url: str = ""
    protocol: str = "HTTP/1.1"
    headers: list[str] = field(default_factory=list)


@dataclass
class KafkaLogEntry:
    """reference: record.go LogRecordKafka."""

    error_code: int = 0
    api_version: int = 0
    api_key: str = ""
    correlation_id: int = 0
    topics: list[str] = field(default_factory=list)


@dataclass
class L7LogEntry:
    """Generic L7 entry (reference: record.go LogRecordL7)."""

    proto: str = ""
    fields: dict = field(default_factory=dict)


@dataclass
class LatencyInfo:
    """Verdict-path latency breakdown attached to slow-verdict
    exemplars by the sidecar tracer (sidecar/trace.py): end-to-end
    microseconds, the serving path (vec|oracle|host|shed), and the
    per-stage decomposition (queue/batch_form/device_submit/device/
    drain/send)."""

    total_us: float = 0.0
    path: str = ""
    stages_us: dict = field(default_factory=dict)


@dataclass
class LogRecord:
    """reference: record.go:140 LogRecord."""

    type: str = FLOW_TYPE_REQUEST
    timestamp: str = ""
    observation_point: str = OBS_POINT_INGRESS
    source: EndpointInfo = field(default_factory=EndpointInfo)
    destination: EndpointInfo = field(default_factory=EndpointInfo)
    verdict: str = VERDICT_FORWARDED
    info: str = ""
    transport_protocol: int = 6
    http: Optional[HttpLogEntry] = None
    kafka: Optional[KafkaLogEntry] = None
    l7: Optional[L7LogEntry] = None
    latency: Optional[LatencyInfo] = None

    def __post_init__(self) -> None:
        if not self.timestamp:
            self.timestamp = time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            )

    def to_dict(self) -> dict:
        d = asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @staticmethod
    def from_dict(d: dict) -> "LogRecord":
        rec = LogRecord(
            type=d.get("type", FLOW_TYPE_REQUEST),
            timestamp=d.get("timestamp", ""),
            observation_point=d.get("observation_point", OBS_POINT_INGRESS),
            verdict=d.get("verdict", VERDICT_FORWARDED),
            info=d.get("info", ""),
            transport_protocol=d.get("transport_protocol", 6),
        )
        if "source" in d:
            rec.source = EndpointInfo(**d["source"])
        if "destination" in d:
            rec.destination = EndpointInfo(**d["destination"])
        if d.get("http"):
            rec.http = HttpLogEntry(**d["http"])
        if d.get("kafka"):
            rec.kafka = KafkaLogEntry(**d["kafka"])
        if d.get("l7"):
            rec.l7 = L7LogEntry(**d["l7"])
        if d.get("latency"):
            rec.latency = LatencyInfo(**d["latency"])
        return rec
