"""Access log plumbing: endpoint enrichment + fan-out.

reference: pkg/proxy/logger/logger.go:84 — fills in endpoint/identity
info on each record, then sends it to the monitor stream and the
structured log file (daemon/daemon.go:1653).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

from ..utils.metrics import ProxyVerdicts
from .record import LogRecord, VERDICT_FORWARDED


class AccessLogger:
    def __init__(
        self,
        endpoint_lookup: Callable[[int], object] | None = None,
        notify: Callable[[LogRecord], None] | None = None,
        logfile_path: str = "",
    ) -> None:
        self.endpoint_lookup = endpoint_lookup
        self.notify = notify
        self.logfile_path = logfile_path
        self._mutex = threading.Lock()

    def log(self, rec: LogRecord) -> None:
        """Enrich + fan out (reference: logger.go Log)."""
        self._fill_endpoint_info(rec)
        proto = (
            "http" if rec.http else "kafka" if rec.kafka
            else (rec.l7.proto if rec.l7 else "unknown")
        )
        verdict = (
            "forwarded" if rec.verdict == VERDICT_FORWARDED else "denied"
        )
        ProxyVerdicts.inc(proto, verdict)
        if self.notify is not None:
            self.notify(rec)
        if self.logfile_path:
            with self._mutex, open(self.logfile_path, "a") as f:
                f.write(json.dumps(rec.to_dict()) + "\n")

    def _fill_endpoint_info(self, rec: LogRecord) -> None:
        """reference: logger.go fillEndpointInfo."""
        if self.endpoint_lookup is None:
            return
        for info in (rec.source, rec.destination):
            if info.id and not info.labels:
                ep = self.endpoint_lookup(info.id)
                if ep is not None and getattr(ep, "security_identity", None):
                    info.identity = ep.security_identity.id
                    info.labels = ep.security_identity.labels.get_model()
                    info.ipv4 = getattr(ep, "ipv4", "")
