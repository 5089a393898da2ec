"""Monitor unix-socket pub/sub, both listener protocol versions.

reference: monitor/listener1_2.go + listener1_0.go — the node monitor
serves BOTH protocol generations simultaneously on sibling sockets so
old and new consumers coexist across upgrades:

- **1.2** (``<path>``): 4-byte big-endian length + JSON event — the
  payload framing (reference: listener1_2.go gob payload.Payload).
- **1.0** (``<path>.1_0``): newline-delimited JSON, one event per line
  — the legacy framing analog (reference: listener1_0.go raw encoding).

Slow subscribers drop events rather than stalling the stream on either
version.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import struct
import threading
from typing import Callable, Optional

from ..utils.logging import get_logger
from ..utils.sockutil import shutdown_close
from .monitor import Monitor, MonitorEvent

log = get_logger("monitor-server")


class _Subscriber:
    def __init__(self, conn: socket.socket, version: str = "1.2") -> None:
        self.conn = conn
        self.version = version
        self.queue: "queue.Queue[MonitorEvent]" = queue.Queue(maxsize=4096)
        self.lost = 0


class MonitorServer:
    """reference: monitor/monitor.go serve loop + listener registry."""

    def __init__(self, monitor: Monitor, path: str) -> None:
        self.monitor = monitor
        self.path = path
        self.path_1_0 = path + ".1_0"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._socks: dict[str, socket.socket] = {}
        for p, version in ((path, "1.2"), (self.path_1_0, "1.0")):
            if os.path.exists(p):
                os.unlink(p)
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.bind(p)
            s.listen(16)
            self._socks[version] = s
        self._subs: list[_Subscriber] = []
        self._mutex = threading.Lock()
        self._stop = threading.Event()
        # Direct (unqueued) delivery: _fan_out only put_nowaits into
        # per-subscriber bounded queues, so the per-listener queue layer
        # would just double-buffer and hide subscriber loss accounting.
        monitor.add_listener(self._fan_out, queued=False)
        for version, s in self._socks.items():
            threading.Thread(
                target=self._accept_loop, args=(s, version),
                name=f"monitor-server-{version}", daemon=True,
            ).start()

    def _fan_out(self, ev: MonitorEvent) -> None:
        with self._mutex:
            subs = list(self._subs)
        for s in subs:
            try:
                s.queue.put_nowait(ev)
            except queue.Full:
                s.lost += 1  # slow subscriber: drop, don't stall

    def _accept_loop(self, sock: socket.socket, version: str) -> None:
        while not self._stop.is_set():
            try:
                sock.settimeout(0.2)
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sub = _Subscriber(conn, version=version)
            with self._mutex:
                self._subs.append(sub)
            threading.Thread(
                target=self._send_loop, args=(sub,), daemon=True
            ).start()

    def _send_loop(self, sub: _Subscriber) -> None:
        try:
            while not self._stop.is_set():
                try:
                    ev = sub.queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                data = json.dumps(ev.to_dict()).encode()
                if sub.version == "1.0":
                    sub.conn.sendall(data + b"\n")
                else:
                    sub.conn.sendall(struct.pack(">I", len(data)) + data)
        except OSError:
            pass
        finally:
            with self._mutex:
                try:
                    self._subs.remove(sub)
                except ValueError:
                    pass
            shutdown_close(sub.conn)

    def subscriber_count(self) -> int:
        with self._mutex:
            return len(self._subs)

    def close(self) -> None:
        self._stop.set()
        # shutdown-then-close: a bare close while an accept thread
        # holds the fd defers the kernel teardown, and the listener
        # keeps accepting into a dead server until the thread's next
        # timeout tick (a zombie service).
        for s in self._socks.values():
            shutdown_close(s)
        for p in (self.path, self.path_1_0):
            if os.path.exists(p):
                os.unlink(p)


class MonitorClient:
    """Subscriber side (the `monitor` CLI command's transport).

    ``version="1.0"`` dials the legacy line-framed socket (the path the
    server exposes as ``<path>.1_0``); default is the 1.2 payload
    framing."""

    def __init__(self, path: str, version: str = "1.2") -> None:
        self.version = version
        if version == "1.0" and not path.endswith(".1_0"):
            path = path + ".1_0"
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(path)
        self._linebuf = b""

    def next_event(self, timeout: float | None = None) -> Optional[MonitorEvent]:
        self._sock.settimeout(timeout)
        try:
            if self.version == "1.0":
                while b"\n" not in self._linebuf:
                    chunk = self._sock.recv(65536)
                    if not chunk:
                        return None
                    self._linebuf += chunk
                line, self._linebuf = self._linebuf.split(b"\n", 1)
                return MonitorEvent.from_dict(json.loads(line.decode()))
            hdr = self._recv_exact(4)
            if hdr is None:
                return None
            (n,) = struct.unpack(">I", hdr)
            body = self._recv_exact(n)
            if body is None:
                return None
            return MonitorEvent.from_dict(json.loads(body.decode()))
        except socket.timeout:
            return None

    def _recv_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def close(self) -> None:
        # shutdown first: a consumer thread blocked in next_event's
        # recv holds the fd, so a bare close would never wake it — the
        # reader would linger to process exit (as the sidecar client's
        # once did).  After shutdown the recv
        # returns b"" and next_event reports end-of-stream with None.
        shutdown_close(self._sock)
