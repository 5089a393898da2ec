"""Access log records and the agent-side log server.

reference: pkg/proxy/accesslog/record.go (the canonical LogRecord with
HTTP/Kafka/L7 variants) + pkg/envoy/accesslog_server.go (unix-socket server
receiving per-request records from proxies, feeding the monitor and the
structured log file) + proxylib/accesslog/client.go (the sender side).
"""

from .record import (
    FLOW_TYPE_REQUEST,
    FLOW_TYPE_RESPONSE,
    FLOW_TYPE_SAMPLE,
    OBS_POINT_INGRESS,
    OBS_POINT_EGRESS,
    VERDICT_DENIED,
    VERDICT_ERROR,
    VERDICT_FORWARDED,
    EndpointInfo,
    HttpLogEntry,
    KafkaLogEntry,
    L7LogEntry,
    LogRecord,
)
from .server import AccessLogClient, AccessLogServer
from .logger import AccessLogger

__all__ = [
    "AccessLogClient",
    "AccessLogServer",
    "AccessLogger",
    "EndpointInfo",
    "FLOW_TYPE_REQUEST",
    "FLOW_TYPE_RESPONSE",
    "FLOW_TYPE_SAMPLE",
    "HttpLogEntry",
    "KafkaLogEntry",
    "L7LogEntry",
    "LogRecord",
    "OBS_POINT_EGRESS",
    "OBS_POINT_INGRESS",
    "VERDICT_DENIED",
    "VERDICT_ERROR",
    "VERDICT_FORWARDED",
]
