"""Access log unix-socket server + client.

reference: pkg/envoy/accesslog_server.go:45 (server accepting protobuf
LogEntry frames from proxies over a unix socket, converting to
accesslog.LogRecord and feeding monitor + logger) and
proxylib/accesslog/client.go (sender).  Framing: 4-byte big-endian length
+ JSON record.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Callable

from ..utils.logging import get_logger
from ..utils.sockutil import shutdown_close
from .record import LogRecord

log = get_logger("accesslog")


class AccessLogServer:
    """reference: accesslog_server.go:45 StartAccessLogServer."""

    def __init__(
        self,
        path: str,
        on_record: Callable[[LogRecord], None] | None = None,
    ) -> None:
        self.path = path
        self.on_record = on_record
        self.records: list[LogRecord] = []
        self._mutex = threading.Lock()
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(16)
        self._stop = threading.Event()
        threading.Thread(
            target=self._accept_loop, name="accesslog-server", daemon=True
        ).start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(None)
            while True:
                hdr = b""
                while len(hdr) < 4:
                    chunk = conn.recv(4 - len(hdr))
                    if not chunk:
                        return
                    hdr += chunk
                (n,) = struct.unpack(">I", hdr)
                if n > 16 * 1024 * 1024:
                    log.with_field("size", n).warning(
                        "oversized access log frame; closing"
                    )
                    return
                body = b""
                while len(body) < n:
                    chunk = conn.recv(n - len(body))
                    if not chunk:
                        return
                    body += chunk
                try:
                    rec = LogRecord.from_dict(json.loads(body.decode()))
                except (ValueError, TypeError) as e:
                    log.with_field("error", str(e)).warning(
                        "bad access log record"
                    )
                    continue
                self._handle(rec)
        except OSError:
            pass
        finally:
            shutdown_close(conn)

    def _handle(self, rec: LogRecord) -> None:
        with self._mutex:
            self.records.append(rec)
            if len(self.records) > 65536:
                self.records = self.records[-32768:]
        if self.on_record is not None:
            try:
                self.on_record(rec)
            except Exception:  # noqa: BLE001 — consumers never break intake
                pass

    def drain(self) -> list[LogRecord]:
        with self._mutex:
            out = self.records
            self.records = []
            return out

    def close(self) -> None:
        self._stop.set()
        # shutdown wakes the accept thread parked on the listener so
        # the fd tears down now, not at its next timeout tick.
        try:
            shutdown_close(self._sock)
        finally:
            if os.path.exists(self.path):
                os.unlink(self.path)


class AccessLogClient:
    """Sender side (reference: proxylib/accesslog/client.go).

    ``timeout`` bounds connect and sendall: access logging is
    best-effort by contract (a failed log() returns False and the
    verdict still flows), so a wedged collector — bound but not
    accepting, or accepting but never reading until the socket buffer
    fills — must cost ONE bounded wait, not hang the datapath caller
    under the client mutex forever."""

    def __init__(self, path: str, timeout: float = 5.0) -> None:
        self.path = path
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._mutex = threading.Lock()

    def _connect(self) -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self.path)
        return s

    def log(self, rec: LogRecord) -> bool:
        """Send one record; reconnects once on failure (reference:
        client.go Log with reconnect)."""
        data = json.dumps(rec.to_dict()).encode()
        frame = struct.pack(">I", len(data)) + data
        with self._mutex:
            for _ in range(2):
                try:
                    if self._sock is None:
                        # lint: disable=R2 -- connect is bounded by the constructor timeout; dialing under the mutex is the one-socket serialization this client is built on
                        self._sock = self._connect()
                    # One socket serialized by design; the sendall is
                    # bounded by the constructor timeout, so a wedged
                    # collector fails this log() instead of wedging it.
                    self._sock.sendall(frame)  # lint: disable=R2 -- bounded by settimeout; serializing the shared socket is the point
                    return True
                except OSError:
                    shutdown_close(self._sock)
                    self._sock = None
        return False

    def close(self) -> None:
        with self._mutex:
            if self._sock is not None:
                shutdown_close(self._sock)
                self._sock = None
