"""Workload event watcher: runtime events -> endpoint label sync.

reference: pkg/workloads/watcher_state.go + docker.go processEvent/
handleCreateWorkload — container start/delete events are serialized
PER CONTAINER (one handler queue each, so a start/delete pair for one
container can never race, while different containers proceed in
parallel), correlated with the endpoint the CNI/plugin created, and the
runtime's labels become the endpoint's identity labels.  A periodic
sync lists running workloads and enqueues start events for any the
watcher has not seen (reference: watcher_state.go syncWithRuntime),
catching containers started while the listener was down.
"""

from __future__ import annotations

import enum
import logging
import queue
import threading
import time
from dataclasses import dataclass

from ..utils.controller import ControllerManager, ControllerParams
from .runtime import WorkloadRuntime

log = logging.getLogger(__name__)

# reference: docker.go EndpointCorrelationMaxRetries and the backoff
# sleep between correlation attempts.
CORRELATION_MAX_RETRIES = 3
CORRELATION_SLEEP = 0.05
PERIODIC_SYNC_INTERVAL = 30.0  # reference: defaults.go periodicSyncRate


class EventType(enum.Enum):
    START = "start"  # reference: watcher_state.go EventTypeStart
    DELETE = "delete"  # EventTypeDelete


@dataclass
class EventMessage:
    workload_id: str
    event_type: EventType


class WorkloadWatcher:
    """Drives daemon endpoint state from a WorkloadRuntime's events."""

    def __init__(
        self,
        daemon,
        runtime: WorkloadRuntime,
        max_retries: int = CORRELATION_MAX_RETRIES,
        sync_interval: float = PERIODIC_SYNC_INTERVAL,
        controllers: ControllerManager | None = None,
    ) -> None:
        self.daemon = daemon
        self.runtime = runtime
        self.max_retries = max_retries
        self.sync_interval = sync_interval
        self._mutex = threading.Lock()
        self._queues: dict[str, queue.Queue] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._controllers = controllers or ControllerManager()
        self._own_controllers = controllers is None
        self._started = False
        self.events_handled = 0

    # -- event intake ------------------------------------------------------

    def start(self) -> "WorkloadWatcher":
        """Begin periodic runtime sync (event feeds call enqueue)."""
        if not self._started:
            self._started = True
            self._controllers.update_controller(
                "workload-sync",
                ControllerParams(
                    do_func=self.sync_with_runtime,
                    run_interval=self.sync_interval,
                ),
            )
        return self

    def enqueue(self, workload_id: str, event_type: EventType) -> None:
        """Serialized per container (reference: enqueueByContainerID)."""
        with self._mutex:
            q = self._queues.get(workload_id)
            if q is None:
                q = queue.Queue(maxsize=256)
                self._queues[workload_id] = q
                t = threading.Thread(
                    target=self._handler, args=(workload_id, q),
                    name=f"workload-{workload_id[:12]}", daemon=True,
                )
                self._threads[workload_id] = t
                t.start()
        q.put(EventMessage(workload_id, event_type))

    def _handler(self, workload_id: str, q: queue.Queue) -> None:
        while True:
            msg = q.get()
            if msg is None:
                return
            try:
                self._process_event(msg)
            except Exception:  # noqa: BLE001 — one event must not kill
                log.exception("workload event failed: %s", msg)
            finally:
                self.events_handled += 1

    # -- event handling ----------------------------------------------------

    def _process_event(self, msg: EventMessage) -> None:
        if msg.event_type is EventType.START:
            self._handle_create(msg.workload_id)
        elif msg.event_type is EventType.DELETE:
            ep = self.daemon.endpoint_manager.lookup_container(
                msg.workload_id
            )
            if ep is not None:
                self.daemon.endpoint_delete(ep.id)

    def _handle_create(self, workload_id: str) -> None:
        """Correlate the endpoint and apply the runtime's labels
        (reference: docker.go handleCreateWorkload retry loop)."""
        for attempt in range(1, self.max_retries + 1):
            if attempt > 1:
                time.sleep(CORRELATION_SLEEP * attempt)
            w = self.runtime.inspect(workload_id)
            if w is None or not w.running:
                return  # died before correlation — nothing to label
            ep = self.daemon.endpoint_manager.lookup_container(workload_id)
            if ep is None and w.ipv4:
                ep = self.daemon.endpoint_manager.lookup_ipv4(w.ipv4)
            if ep is None:
                continue  # endpoint not created yet; retry
            self.daemon.endpoint_update_labels(ep.id, w.identity_labels())
            return
        log.warning(
            "no endpoint for workload %s after %d tries",
            workload_id[:12], self.max_retries,
        )

    # -- periodic sync -----------------------------------------------------

    def sync_with_runtime(self) -> None:
        """Enqueue START for running workloads without a handler yet
        (reference: watcher_state.go syncWithRuntime)."""
        try:
            ids = self.runtime.list_workloads()
        except Exception:  # noqa: BLE001 — runtime down; retry next tick
            log.debug("workload runtime unreachable during sync")
            return
        with self._mutex:
            unknown = [i for i in ids if i not in self._queues]
        for workload_id in unknown:
            self.enqueue(workload_id, EventType.START)

    def flush(self, timeout: float = 5.0) -> None:
        """Wait until all queued events are handled (tests)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mutex:
                empty = all(q.empty() for q in self._queues.values())
            if empty:
                # Settle OUTSIDE the mutex: in-flight handlers need it
                # to drain, so sleeping while holding it stalled the
                # very completion this poll is waiting for (lint R2).
                time.sleep(0.02)
                with self._mutex:
                    if all(q.empty() for q in self._queues.values()):
                        return
            else:
                time.sleep(0.01)

    def close(self) -> None:
        if self._own_controllers:
            self._controllers.remove_all()
        else:
            self._controllers.remove_controller("workload-sync")
        with self._mutex:
            for q in self._queues.values():
                q.put(None)
