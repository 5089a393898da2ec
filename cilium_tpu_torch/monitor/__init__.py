"""Monitor: the event stream for datapath and agent notifications.

reference: monitor/ + pkg/monitor — BPF trace/drop/debug events flow
through per-CPU perf rings into the cilium-node-monitor process, which
fans them out to unix-socket subscribers; agent events (policy updates,
endpoint regenerations, access logs) are pushed into the same stream
(daemon/daemon.go:1647 SendNotification).  Here the datapath events come
from the batch engines' verdict paths instead of a kernel perf ring: a
bounded in-process ring buffer feeds unix-socket subscribers with
length-prefixed JSON payloads (the 1.2 payload protocol analog,
monitor/listener1_2.go).
"""

from .monitor import (
    AGENT_NOTIFY_ENDPOINT_REGENERATE_SUCCESS,
    AGENT_NOTIFY_KVSTORE_DEGRADED,
    AGENT_NOTIFY_KVSTORE_RESTORED,
    AGENT_NOTIFY_POLICY_UPDATED,
    AGENT_NOTIFY_START,
    MSG_TYPE_ACCESS_LOG,
    MSG_TYPE_AGENT,
    MSG_TYPE_DEBUG,
    MSG_TYPE_DROP,
    MSG_TYPE_POLICY_VERDICT,
    MSG_TYPE_TRACE,
    Monitor,
    MonitorEvent,
)
from .server import MonitorClient, MonitorServer
from .format import format_event

__all__ = [
    "AGENT_NOTIFY_ENDPOINT_REGENERATE_SUCCESS",
    "AGENT_NOTIFY_KVSTORE_DEGRADED",
    "AGENT_NOTIFY_KVSTORE_RESTORED",
    "AGENT_NOTIFY_POLICY_UPDATED",
    "AGENT_NOTIFY_START",
    "MSG_TYPE_ACCESS_LOG",
    "MSG_TYPE_AGENT",
    "MSG_TYPE_DEBUG",
    "MSG_TYPE_DROP",
    "MSG_TYPE_POLICY_VERDICT",
    "MSG_TYPE_TRACE",
    "Monitor",
    "MonitorClient",
    "MonitorEvent",
    "MonitorServer",
    "format_event",
]
