"""Unix-socket transport for distribution streams.

The out-of-process seam: where the reference speaks gRPC xDS over a unix
socket to Envoy (reference: pkg/envoy/server.go:67 XDSServer socket), this
speaks length-prefixed JSON frames over a unix socket to native sidecars
(the C++ runtime shim).  Protocol:

  client -> server: {"subscribe": {"node": ..., "type_url": ...}}
                    {"ack": {"version": N, "nack": false}}
  server -> client: {"version": N, "type_url": ..., "resources": {...}}

Each frame is a 4-byte big-endian length followed by UTF-8 JSON.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading

from ..utils.logging import get_logger
from ..utils.sockutil import shutdown_close
from .server import DistributionServer

log = get_logger("distribution-sock")


def send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def recv_frame(sock: socket.socket) -> dict | None:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    if n > 64 * 1024 * 1024:
        raise ValueError(f"frame too large: {n}")
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body.decode())


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class SocketDistributionServer:
    """Accepts sidecar subscriptions over a unix socket."""

    def __init__(self, server: DistributionServer, path: str) -> None:
        self.server = server
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(16)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, name="dist-sock", daemon=True
        )
        self._thread.start()

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
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        sub = None
        try:
            conn.settimeout(None)
            msg = recv_frame(conn)
            if not msg or "subscribe" not in msg:
                return
            sub = self.server.subscribe(
                msg["subscribe"]["node"], msg["subscribe"]["type_url"]
            )
            sender = threading.Thread(
                target=self._send_loop, args=(conn, sub), daemon=True
            )
            sender.start()
            while True:
                msg = recv_frame(conn)
                if msg is None:
                    return
                if "ack" in msg:
                    self.server.ack(
                        sub,
                        msg["ack"].get("version", 0),
                        nack=msg["ack"].get("nack", False),
                    )
        except (OSError, ValueError) as e:
            log.with_field("error", str(e)).debug("sidecar stream closed")
        finally:
            if sub is not None:
                self.server.unsubscribe(sub)
            # shutdown first: the per-subscriber _send_loop thread may
            # be inside send_frame on this socket — a bare close would
            # defer the teardown until its next write.
            shutdown_close(conn)

    def _send_loop(self, conn: socket.socket, sub) -> None:
        try:
            while not self._stop.is_set():
                vr = sub.next(timeout=0.2)
                if vr is None:
                    continue
                send_frame(conn, {
                    "version": vr.version,
                    "type_url": vr.type_url,
                    "resources": vr.resources,
                })
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        # Wake the acceptor parked on the listener; see R3.
        try:
            shutdown_close(self._sock)
        finally:
            if os.path.exists(self.path):
                os.unlink(self.path)
