"""In-process and file-persisted kvstore backends.

reference: the etcd/consul modules (pkg/kvstore/{etcd,consul}.go) provide
these semantics against external stores; single-host deployments and tests
use these local equivalents behind the same Backend interface.  Leases are
emulated: lease-attached keys die with the session (close()), matching the
reference's lease-per-client keepalive model (pkg/kvstore/etcd.go leases,
keepalive.go).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .backend import (
    Backend,
    EventType,
    KeyValueEvent,
    KvstoreError,
    LockError,
    Watcher,
)


class _PathLock:
    def __init__(self, backend: "LocalBackend", path: str) -> None:
        self._backend = backend
        self._path = path
        self._held = True

    def unlock(self) -> None:
        # Idempotent: a second unlock (e.g. explicit + context-manager
        # exit) must not release a lock since acquired by another thread.
        if self._held:
            self._held = False
            self._backend._unlock_path(self._path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.unlock()


class LocalBackend(Backend):
    """Thread-safe in-memory backend with watch + lease emulation."""

    def __init__(self) -> None:
        self._data: dict[str, bytes] = {}
        self._leased: set[str] = set()
        self._locks: dict[str, threading.Lock] = {}
        self._mutex = threading.RLock()
        self._watchers: list[Watcher] = []
        self._closed = False

    # -- status ------------------------------------------------------------

    def status(self) -> str:
        return "local: connected" if not self._closed else "local: closed"

    # -- locks -------------------------------------------------------------

    def lock_path(self, path: str, timeout: float | None = 10.0) -> _PathLock:
        with self._mutex:
            lock = self._locks.setdefault(path, threading.Lock())
        if not lock.acquire(timeout=timeout if timeout is not None else -1):
            raise LockError(f"timeout locking {path}")
        return _PathLock(self, path)

    def _unlock_path(self, path: str) -> None:
        with self._mutex:
            lock = self._locks.get(path)
        if lock is not None and lock.locked():
            lock.release()

    # -- CRUD --------------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        with self._mutex:
            return self._data.get(key)

    def get_prefix(self, prefix: str) -> Optional[bytes]:
        with self._mutex:
            for k in sorted(self._data):
                if k.startswith(prefix):
                    return self._data[k]
        return None

    def set(self, key: str, value: bytes, lease: bool = False) -> None:
        # Mutation and event emission are atomic under the mutex so watcher
        # event order always matches mutation order.
        with self._mutex:
            existed = key in self._data
            self._data[key] = value
            if lease:
                self._leased.add(key)
            else:
                # A non-leased overwrite downgrades the key BEFORE the
                # emit persists (etcd: the latest PUT's lease — or
                # absence of one — wins).
                self._leased.discard(key)
            self._emit(
                KeyValueEvent(
                    EventType.MODIFY if existed else EventType.CREATE,
                    key, value, lease=lease,
                )
            )

    def delete(self, key: str) -> None:
        with self._mutex:
            existed = self._data.pop(key, None) is not None
            self._leased.discard(key)
            if existed:
                self._emit(KeyValueEvent(EventType.DELETE, key))

    def delete_prefix(self, prefix: str) -> None:
        with self._mutex:
            dead = [k for k in self._data if k.startswith(prefix)]
            for k in dead:
                del self._data[k]
                self._leased.discard(k)
                self._emit(KeyValueEvent(EventType.DELETE, k))

    def create_only(self, key: str, value: bytes, lease: bool = False) -> bool:
        """Atomic create; False if the key already exists
        (reference: backend.go CreateOnly)."""
        with self._mutex:
            if key in self._data:
                return False
            self._data[key] = value
            if lease:
                self._leased.add(key)
            self._emit(
                KeyValueEvent(EventType.CREATE, key, value, lease=lease)
            )
        return True

    def compare_and_swap(self, key: str, expected: bytes | None,
                         value: bytes, lease: bool = False) -> bool:
        """Atomic CAS: write value iff the key currently holds exactly
        ``expected`` (None = key absent).  The epoch-claim primitive of
        the fenced failover (net.py): a promoting follower claims epoch
        N+1 against the last epoch it replicated, so a concurrent
        mutation of the epoch key can never be silently overwritten.
        Emits like set(), so a durable backend persists the claim
        atomically with the mutation."""
        with self._mutex:
            if self._data.get(key) != expected:
                return False
            self.set(key, value, lease=lease)
        return True

    def create_if_exists(self, cond_key: str, key: str, value: bytes,
                         lease: bool = False) -> bool:
        with self._mutex:
            if cond_key not in self._data or key in self._data:
                return False
            self._data[key] = value
            if lease:
                self._leased.add(key)
            self._emit(
                KeyValueEvent(EventType.CREATE, key, value, lease=lease)
            )
        return True

    def list_prefix(self, prefix: str) -> dict[str, bytes]:
        with self._mutex:
            return {
                k: v for k, v in self._data.items() if k.startswith(prefix)
            }

    # -- watch -------------------------------------------------------------

    def list_and_watch(self, name: str, prefix: str) -> Watcher:
        """reference: backend.go:139 — list current keys as CREATE events,
        then a LIST_DONE marker, then live events."""
        w = Watcher(name, prefix)
        with self._mutex:
            # Snapshot replay and registration are atomic with mutations so
            # no live event can precede (and be overwritten by) the snapshot.
            for k, v in sorted(self._data.items()):
                if k.startswith(prefix):
                    w.events.put(KeyValueEvent(
                        EventType.CREATE, k, v,
                        lease=k in self._leased,
                    ))
            w.events.put(KeyValueEvent(EventType.LIST_DONE))
            self._watchers.append(w)
        return w

    def _emit(self, ev: KeyValueEvent) -> None:
        with self._mutex:
            watchers = [
                w for w in self._watchers
                if not w.stopped and ev.key.startswith(w.prefix)
            ]
            self._watchers = [w for w in self._watchers if not w.stopped]
        for w in watchers:
            try:
                w.events.put_nowait(ev)
            except Exception:  # noqa: BLE001 — full queue: drop, like a
                pass  # slow watcher losing events under backpressure

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Session end revokes leases (reference: lease expiry semantics)."""
        with self._mutex:
            leased = list(self._leased)
        for k in leased:
            self.delete(k)
        self._closed = True


class FileBackend(LocalBackend):
    """LocalBackend persisted to a JSON file — state survives restarts
    (the role etcd's disk plays for the reference's agent restarts)."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self._path = path
        self._load()

    def _load(self) -> None:
        if os.path.exists(self._path):
            try:
                with open(self._path) as f:
                    raw = json.load(f)
                with self._mutex:
                    self._data = {
                        k: bytes.fromhex(v) for k, v in raw.items()
                    }
            except (ValueError, OSError) as e:
                raise KvstoreError(f"corrupt kvstore file {self._path}: {e}")

    def _persist(self) -> None:
        tmp = self._path + ".tmp"
        with self._mutex:
            raw = {k: v.hex() for k, v in self._data.items()
                   if k not in self._leased}
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(raw, f)
        os.replace(tmp, self._path)

    def _emit(self, ev) -> None:
        super()._emit(ev)
        self._persist()
