"""Access log records, copied from ``cilium_tpu/accesslog/record.py``
(reference: pkg/proxy/accesslog/record.go).  The HTTP and Kafka engines
fill one ``LogRecord`` per judged request; the log server and logger are not part
of the port yet."""

from .record import (
    VERDICT_DENIED,
    VERDICT_FORWARDED,
    HttpLogEntry,
    KafkaLogEntry,
    LogRecord,
)

__all__ = ["HttpLogEntry", "KafkaLogEntry", "LogRecord", "VERDICT_DENIED", "VERDICT_FORWARDED"]
