"""Monitor core: bounded event ring with subscriber fan-out.

reference: monitor/monitor.go:106 (Monitor owning the perf reader and the
listener set) + pkg/monitor message types (messages.go MessageType*).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from ..utils import defaults

# Message types (reference: pkg/monitor/messages.go).
MSG_TYPE_DROP = 1
MSG_TYPE_DEBUG = 2
MSG_TYPE_CAPTURE = 3
MSG_TYPE_TRACE = 4
MSG_TYPE_POLICY_VERDICT = 5
MSG_TYPE_ACCESS_LOG = 6
MSG_TYPE_AGENT = 7
# Flight-recorder postmortem bundle (sidecar/blackbox.py): emitted on a
# fail-closed typestate transition so `cilium monitor` surfaces the
# incident without polling the timeline RPC.
MSG_TYPE_POSTMORTEM = 8

# Agent notification codes (reference: pkg/monitor AgentNotify*).
AGENT_NOTIFY_START = 2
AGENT_NOTIFY_ENDPOINT_REGENERATE_SUCCESS = 3
AGENT_NOTIFY_ENDPOINT_REGENERATE_FAIL = 4
AGENT_NOTIFY_POLICY_UPDATED = 5
AGENT_NOTIFY_POLICY_DELETED = 6
# Cluster-store degradation (fenced/unreachable kvstore): the agent
# keeps serving on cached identities and announces both edges.
AGENT_NOTIFY_KVSTORE_DEGRADED = 7
AGENT_NOTIFY_KVSTORE_RESTORED = 8


@dataclass
class MonitorEvent:
    type: int
    payload: dict
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "timestamp": self.timestamp,
            "payload": self.payload,
        }

    @staticmethod
    def from_dict(d: dict) -> "MonitorEvent":
        return MonitorEvent(
            type=d.get("type", 0),
            payload=d.get("payload", {}),
            timestamp=d.get("timestamp", 0.0),
        )


class _ListenerQueue:
    """Per-listener bounded queue + delivery thread: a slow or blocking
    listener loses ITS OWN events (counted) instead of stalling the
    publishing thread (reference: the per-CPU perf rings feeding each
    consumer independently, pkg/bpf/perf.go:341, and listener queues in
    monitor/listener1_2.go)."""

    def __init__(self, callback, maxlen: int) -> None:
        from collections import deque

        self.callback = callback
        self.lost = 0
        self._q: deque = deque()
        self.maxlen = maxlen
        self._cond = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="monitor-listener"
        )
        self._thread.start()

    def put(self, event: "MonitorEvent") -> None:
        with self._cond:
            if len(self._q) >= self.maxlen:
                self._q.popleft()
                self.lost += 1
            self._q.append(event)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stopped:
                    self._cond.wait(timeout=0.5)
                if self._stopped and not self._q:
                    return
                event = self._q.popleft()
            try:
                self.callback(event)
            except Exception:  # noqa: BLE001 — a bad listener never
                pass  # stalls the stream

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()


class Monitor:
    """Bounded ring + per-listener queued fan-out
    (reference: monitor/monitor.go).

    Lost events are counted, not blocked on — the perf-ring overflow
    behavior (monitor.go lost-event accounting); each listener has its
    own bounded queue so backpressure is per-consumer.
    """

    def __init__(self, queue_size: int = defaults.MONITOR_QUEUE_SIZE) -> None:
        self.queue_size = queue_size
        self._ring: list[MonitorEvent] = []
        # (callback, queue-or-None) pairs; removal is by == so bound
        # methods (a fresh object per attribute access) still match.
        self._listeners: list = []
        self._mutex = threading.RLock()
        self.events_seen = 0
        self.events_lost = 0

    def add_listener(self, listener: Callable[[MonitorEvent], None],
                     queued: bool = True) -> None:
        """``queued=False`` delivers synchronously on the publishing
        thread — for listeners that are already non-blocking (e.g. a
        put_nowait fan-out with its own per-subscriber queues)."""
        lq = _ListenerQueue(listener, self.queue_size) if queued else None
        with self._mutex:
            self._listeners.append((listener, lq))

    def remove_listener(self, listener) -> None:
        with self._mutex:
            lq = None
            for i, (cb, q) in enumerate(self._listeners):
                if cb == listener:
                    del self._listeners[i]
                    lq = q
                    break
            if lq is not None:
                # Keep the cumulative loss counter monotonic.
                self.events_lost += lq.lost
        if lq is not None:
            lq.stop()

    def notify(self, event: MonitorEvent) -> None:
        with self._mutex:
            self.events_seen += 1
            self._ring.append(event)
            if len(self._ring) > self.queue_size:
                overflow = len(self._ring) - self.queue_size
                self._ring = self._ring[overflow:]
                self.events_lost += overflow
            listeners = list(self._listeners)
        for cb, lq in listeners:
            if lq is not None:
                lq.put(event)
            else:
                try:
                    cb(event)
                except Exception:  # noqa: BLE001 — a bad listener never
                    pass  # stalls the stream

    # Convenience emitters -------------------------------------------------

    def send_agent_notification(self, code: int, text: str, **payload) -> None:
        """reference: daemon/daemon.go:1647 SendNotification."""
        self.notify(
            MonitorEvent(
                MSG_TYPE_AGENT, {"code": code, "text": text, **payload}
            )
        )

    def send_verdict(
        self, *, src_identity: int, dst_identity: int, dport: int, proto: int,
        allowed: bool, proxy_port: int = 0, l7: dict | None = None,
    ) -> None:
        """Policy verdict event from the datapath ops/batch engines."""
        self.notify(
            MonitorEvent(
                MSG_TYPE_POLICY_VERDICT if allowed else MSG_TYPE_DROP,
                {
                    "src_identity": src_identity,
                    "dst_identity": dst_identity,
                    "dport": dport,
                    "proto": proto,
                    "allowed": allowed,
                    "proxy_port": proxy_port,
                    **({"l7": l7} if l7 else {}),
                },
            )
        )

    def recent(self, n: int = 100) -> list[MonitorEvent]:
        with self._mutex:
            return self._ring[-n:]

    def status(self) -> dict:
        with self._mutex:
            return {
                "seen": self.events_seen,
                "lost": self.events_lost
                + sum(lq.lost for _, lq in self._listeners if lq is not None),
                "listeners": len(self._listeners),
                "queued": len(self._ring),
            }
