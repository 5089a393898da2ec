"""Backend interface and watcher events (reference: pkg/kvstore/backend.go
BackendOperations, events.go KeyValueEvent)."""

from __future__ import annotations

import abc
import enum
import queue
from dataclasses import dataclass
from typing import Iterator, Optional


class KvstoreError(RuntimeError):
    pass


class LockError(KvstoreError):
    pass


class EpochFencedError(KvstoreError):
    """A write reached a server whose fencing epoch is below the
    cluster's: a newer primary exists (EPOCH_FENCED).  The rejection
    happens BEFORE any mutation, so retrying against the current
    primary is always safe; callers that cache state derived from the
    stale server must re-resolve against the new primary instead of
    trusting their caches (see kvstore/net.py state machine)."""

    def __init__(self, msg: str, epoch: int = 0) -> None:
        super().__init__(msg)
        self.epoch = epoch  # the fencing (higher) epoch, if known


class NotPrimaryError(KvstoreError):
    """A write reached a still-replicating follower.  Transient by
    design: the follower either promotes (claiming the next epoch) or
    the primary returns — the write was rejected before any mutation,
    so backing off and retrying is always safe."""

    def __init__(self, msg: str, epoch: int = 0) -> None:
        super().__init__(msg)
        self.epoch = epoch


class EventType(enum.Enum):
    """reference: pkg/kvstore/events.go."""

    CREATE = "create"
    MODIFY = "modify"
    DELETE = "delete"
    LIST_DONE = "listDone"
    # Client-local marker (never sent on the wire): the connection was
    # re-established and a fresh snapshot replay follows.  Delivered
    # only to watchers that opted in via ``mark_resync`` — ordinary
    # consumers never see it.
    RESYNC = "resync"


@dataclass
class KeyValueEvent:
    typ: EventType
    key: str = ""
    value: bytes = b""
    # True when the key is lease-owned by a live session at emit time
    # (annotated by the networked server's watch pump; replicas use it
    # to keep leased keys out of their durable snapshots).
    lease: bool = False


class Watcher:
    """Prefix watcher with an event queue (reference: kvstore.Watcher)."""

    def __init__(self, name: str, prefix: str) -> None:
        # Unbounded queue: the snapshot replay in list_and_watch runs under
        # the backend mutex before any consumer exists, so a bounded queue
        # would deadlock the whole backend on large prefixes.
        self.name = name
        self.prefix = prefix
        self.events: "queue.Queue[KeyValueEvent]" = queue.Queue(maxsize=0)
        self._stopped = False
        # Opt-in: receive a RESYNC marker event when the transport
        # reconnects, BEFORE the fresh snapshot replay — consumers that
        # reconcile against replays (the kvstore follower) need the
        # boundary; everyone else stays oblivious.
        self.mark_resync = False

    def stop(self) -> None:
        self._stopped = True

    @property
    def stopped(self) -> bool:
        return self._stopped

    def next_event(self, timeout: float | None = None) -> Optional[KeyValueEvent]:
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            return None

    def __iter__(self) -> Iterator[KeyValueEvent]:
        while not self._stopped:
            ev = self.next_event(timeout=0.2)
            if ev is not None:
                yield ev


CAP_CREATE_IF_EXISTS = 1


class Backend(abc.ABC):
    """reference: backend.go:86 BackendOperations."""

    @abc.abstractmethod
    def status(self) -> str: ...

    @abc.abstractmethod
    def lock_path(self, path: str, timeout: float | None = None): ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def get_prefix(self, prefix: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def set(self, key: str, value: bytes, lease: bool = False) -> None: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def delete_prefix(self, prefix: str) -> None: ...

    @abc.abstractmethod
    def create_only(self, key: str, value: bytes, lease: bool = False) -> bool: ...

    @abc.abstractmethod
    def create_if_exists(self, cond_key: str, key: str, value: bytes,
                         lease: bool = False) -> bool: ...

    @abc.abstractmethod
    def list_prefix(self, prefix: str) -> dict[str, bytes]: ...

    @abc.abstractmethod
    def list_and_watch(self, name: str, prefix: str) -> Watcher: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    def get_capabilities(self) -> int:
        return CAP_CREATE_IF_EXISTS

    def encode(self, data: bytes) -> str:
        # URL-safe: standard base64 contains '/', which would let one
        # encoded key alias another's '/'-delimited kvstore subtree.
        import base64

        return base64.urlsafe_b64encode(data).decode()

    def decode(self, s: str) -> bytes:
        import base64

        return base64.urlsafe_b64decode(s)
