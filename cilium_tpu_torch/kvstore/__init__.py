"""Key-value store client layer — the distributed state backbone.

reference: pkg/kvstore — identity allocation, node discovery, ipcache and
service propagation all converge through a kvstore (etcd/consul in the
reference) via BackendOperations (backend.go:86): Get/Set/CAS primitives,
path locks, leases, and prefix watchers feeding event channels.

Backends here: ``LocalBackend`` (in-process, threadsafe, full watch/lease
semantics — the default for single-host and tests), ``FileBackend``
(JSON-file persisted, surviving restarts), and ``NetBackend`` (TCP client
to a ``KvstoreServer`` — the networked store giving multiple daemons one
shared cluster state with session leases, CAS, and live watch; see
net.py).  The consumer layers (allocator, store, ipcache) only use
BackendOperations.
"""

from .backend import (
    Backend,
    CAP_CREATE_IF_EXISTS,
    EpochFencedError,
    EventType,
    KeyValueEvent,
    KvstoreError,
    LockError,
    NotPrimaryError,
    Watcher,
)
from .chaos import ChaosProxy
from .local import FileBackend, LocalBackend
from .net import EPOCH_KEY, KvstoreFollower, KvstoreServer, NetBackend

_default_client: Backend | None = None


def setup_client(backend: Backend) -> Backend:
    """Install the process-global client (reference: kvstore.Client())."""
    global _default_client
    _default_client = backend
    return backend


def client() -> Backend:
    global _default_client
    if _default_client is None:
        _default_client = LocalBackend()
    return _default_client


def close_client() -> None:
    global _default_client
    if _default_client is not None:
        _default_client.close()
        _default_client = None


__all__ = [
    "Backend",
    "CAP_CREATE_IF_EXISTS",
    "ChaosProxy",
    "EPOCH_KEY",
    "EpochFencedError",
    "EventType",
    "FileBackend",
    "KeyValueEvent",
    "KvstoreError",
    "KvstoreFollower",
    "KvstoreServer",
    "LocalBackend",
    "LockError",
    "NetBackend",
    "NotPrimaryError",
    "Watcher",
    "client",
    "close_client",
    "setup_client",
]
