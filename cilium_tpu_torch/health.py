"""cilium-health analog: per-node responder + cluster-wide prober.

reference: pkg/health/server/{server.go:82,prober.go:40} + cilium-health
— every node runs a small health endpoint; one prober per agent probes
every known node (and optionally its health endpoint twin) over TCP,
keeping per-node connectivity status and latency that `cilium status`
surfaces.  The reference probes ICMP + the health HTTP port; raw ICMP
needs privileges, so here both probes are TCP connects (the L3 reach
probe connects to the node's health port; the "endpoint" probe targets
the per-node secondary port, matching the reference's node-IP vs
health-endpoint-IP distinction).
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field

from .utils.controller import ControllerManager, ControllerParams
from .utils.sockutil import shutdown_close

DEFAULT_PROBE_INTERVAL = 10.0  # reference: server.go ProbeInterval 10s
PROBE_TIMEOUT = 1.0


class HealthResponder:
    """The per-node health endpoint (reference: cilium-health daemon's
    listener): accepts a TCP connect and echoes one status byte."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address = "%s:%d" % self._sock.getsockname()[:2]
        self._stopped = False
        threading.Thread(
            target=self._loop, daemon=True, name="health-responder"
        ).start()

    def _loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                conn.sendall(b"\x01")
            except OSError:
                pass
            finally:
                # A connect-and-close prober RSTs before our shutdown;
                # close must still run or each such probe leaks one fd
                # until accept() dies with EMFILE.
                shutdown_close(conn)

    def close(self) -> None:
        self._stopped = True
        # shutdown() wakes the blocked accept(); close() alone leaves
        # the listener live (and serving!) until the next connection.
        shutdown_close(self._sock)


@dataclass
class PathStatus:
    """reference: models.PathStatus/ConnectivityStatus."""

    reachable: bool = False
    latency_ns: int = 0
    last_probed: float = 0.0
    failures: int = 0


@dataclass
class NodeHealth:
    name: str
    address: str
    status: PathStatus = field(default_factory=PathStatus)


class Prober:
    """Probes every registered node periodically (prober.go:40 runProbe);
    degraded nodes keep their last status with a failure count."""

    def __init__(self, node_name: str = "local",
                 interval: float = DEFAULT_PROBE_INTERVAL,
                 controllers: ControllerManager | None = None) -> None:
        self.node_name = node_name
        self.interval = interval
        self._nodes: dict[str, NodeHealth] = {}
        self._mutex = threading.Lock()
        self._controllers = controllers or ControllerManager()
        self._own_controllers = controllers is None
        self._started = False

    # -- node registry (fed by node discovery / clustermesh) --------------

    def add_node(self, name: str, address: str) -> None:
        with self._mutex:
            self._nodes[name] = NodeHealth(name=name, address=address)

    def remove_node(self, name: str) -> bool:
        with self._mutex:
            return self._nodes.pop(name, None) is not None

    # -- probing -----------------------------------------------------------

    def start(self) -> "Prober":
        if not self._started:
            self._started = True
            self._controllers.update_controller(
                "health-prober",
                ControllerParams(do_func=self.probe_all,
                                 run_interval=self.interval),
            )
        return self

    def probe_all(self) -> None:
        """One probe cycle over a snapshot of the node set."""
        with self._mutex:
            nodes = list(self._nodes.values())
        for node in nodes:
            self._probe(node)

    def _probe(self, node: NodeHealth) -> None:
        host, _, port = node.address.rpartition(":")
        t0 = time.perf_counter_ns()
        try:
            with socket.create_connection(
                (host, int(port)), timeout=PROBE_TIMEOUT
            ) as s:
                s.recv(1)
            latency = time.perf_counter_ns() - t0
            ok = True
        except (OSError, ValueError):
            latency = 0
            ok = False
        with self._mutex:
            cur = self._nodes.get(node.name)
            if cur is None:
                return
            st = cur.status
            st.reachable = ok
            st.last_probed = time.time()
            if ok:
                st.latency_ns = latency
                st.failures = 0
            else:
                st.failures += 1

    # -- status ------------------------------------------------------------

    def get_status(self) -> dict:
        """reference: GET /status — per-node connectivity."""
        with self._mutex:
            nodes = {
                n.name: {
                    "address": n.address,
                    "reachable": n.status.reachable,
                    "latency_ms": round(n.status.latency_ns / 1e6, 3),
                    "failures": n.status.failures,
                    "last_probed": n.status.last_probed,
                }
                for n in self._nodes.values()
            }
        degraded = [k for k, v in nodes.items() if not v["reachable"]]
        return {
            "probed_nodes": len(nodes),
            "degraded": degraded,
            "healthy": len(nodes) - len(degraded),
            "nodes": nodes,
        }

    def close(self) -> None:
        if self._own_controllers:
            self._controllers.remove_all()
        else:
            self._controllers.remove_controller("health-prober")
