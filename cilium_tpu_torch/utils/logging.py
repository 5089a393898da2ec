"""Structured logging with per-subsystem fields.

reference: pkg/logging + pkg/logging/logfields — logrus-style structured
entries with a ``subsys`` field per package, runtime level flipping, and
optional hooks receiving every record (the logstash/fluentd seam).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Any, Callable

_root = logging.getLogger("cilium_tpu_torch")
_root.setLevel(logging.INFO)
_handler: logging.Handler | None = None
_hooks: list[Callable[[dict], None]] = []
_mutex = threading.Lock()

# Common field names (reference: pkg/logging/logfields/logfields.go).
ENDPOINT_ID = "endpointID"
IDENTITY = "identity"
POLICY_REVISION = "policyRevision"
L7_PROTOCOL = "l7Protocol"


class _StructuredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        fields = getattr(record, "structured_fields", {})
        base = (
            f"{self.formatTime(record, '%Y-%m-%dT%H:%M:%S')} "
            f"{record.levelname.lower():7s} {record.getMessage()}"
        )
        if fields:
            extras = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
            return f"{base} {extras}"
        return base


def _ensure_handler() -> None:
    global _handler
    with _mutex:
        if _handler is None:
            _handler = logging.StreamHandler(sys.stderr)
            _handler.setFormatter(_StructuredFormatter())
            _root.addHandler(_handler)


class FieldLogger:
    """Logger carrying bound structured fields (logrus Entry analog)."""

    def __init__(self, fields: dict[str, Any] | None = None) -> None:
        self.fields = fields or {}

    def with_field(self, key: str, value: Any) -> "FieldLogger":
        return FieldLogger({**self.fields, key: value})

    def with_fields(self, **kwargs: Any) -> "FieldLogger":
        return FieldLogger({**self.fields, **kwargs})

    def _log(self, level: int, msg: str) -> None:
        _ensure_handler()
        record_fields = dict(self.fields)
        _root.log(level, msg, extra={"structured_fields": record_fields})
        entry = {
            "ts": time.time(),
            "level": logging.getLevelName(level).lower(),
            "msg": msg,
            **record_fields,
        }
        for hook in list(_hooks):
            try:
                hook(entry)
            except Exception:  # noqa: BLE001 — hooks never break logging
                pass

    def debug(self, msg: str) -> None:
        self._log(logging.DEBUG, msg)

    def info(self, msg: str) -> None:
        self._log(logging.INFO, msg)

    def warning(self, msg: str) -> None:
        self._log(logging.WARNING, msg)

    def error(self, msg: str) -> None:
        self._log(logging.ERROR, msg)

    def to_json(self) -> str:
        return json.dumps(self.fields)


default_logger = FieldLogger()


def get_logger(subsys: str) -> FieldLogger:
    """Per-subsystem logger (reference: logfields.LogSubsys)."""
    return default_logger.with_field("subsys", subsys)


def set_log_level(level: str) -> None:
    """Runtime level flip (reference: logging.SetLogLevel)."""
    _root.setLevel(getattr(logging, level.upper()))


def add_hook(hook: Callable[[dict], None]) -> None:
    """Register a hook receiving every structured record
    (reference: logging hooks / logstash export)."""
    _hooks.append(hook)


def remove_hook(hook: Callable[[dict], None]) -> None:
    try:
        _hooks.remove(hook)
    except ValueError:
        pass
