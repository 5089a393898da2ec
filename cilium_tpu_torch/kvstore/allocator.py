"""Cluster-wide ID allocator over the kvstore.

reference: pkg/kvstore/allocator/allocator.go:136 — allocates small numeric
IDs for arbitrary keys (label sets) cluster-wide:

  <prefix>/id/<numericID>          -> key string        (master key)
  <prefix>/value/<key>/<nodename>  -> numericID         (per-node use ref)

Allocation first reuses an existing master key for the value (so all nodes
converge on one ID per key), otherwise claims a free ID with an atomic
create.  Node value keys are lease-attached: a dying node's references
disappear, and GC removes master keys with no remaining references.
A watcher keeps a local id->key cache in sync with remote allocations.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from .backend import (
    Backend,
    EpochFencedError,
    EventType,
    KvstoreError,
    Watcher,
)


class AllocatorError(KvstoreError):
    pass


class IdPool:
    """Pool of allocatable IDs (reference: pkg/kvstore/allocator/idpool.go)."""

    def __init__(self, start: int, end: int) -> None:
        self.start = start
        self.end = end
        self._free: set[int] = set(range(start, end + 1))
        self._mutex = threading.Lock()

    def lease_random(self) -> Optional[int]:
        with self._mutex:
            if not self._free:
                return None
            val = random.choice(tuple(self._free))
            self._free.discard(val)
            return val

    def remove(self, id_: int) -> None:
        with self._mutex:
            self._free.discard(id_)

    def insert(self, id_: int) -> None:
        with self._mutex:
            if self.start <= id_ <= self.end:
                self._free.add(id_)


@dataclass
class AllocatorEvent:
    typ: EventType
    id: int
    key: str


class Allocator:
    """reference: allocator.go:136 Allocator."""

    def __init__(
        self,
        backend: Backend,
        base_path: str,
        suffix: str,
        min_id: int = 256,
        max_id: int = 65535,
        events: Callable[[AllocatorEvent], None] | None = None,
    ) -> None:
        self.backend = backend
        self.base_path = base_path.rstrip("/")
        self.suffix = suffix  # this node's name
        self.id_pool = IdPool(min_id, max_id)
        self.events = events
        # local cache: key -> (id, refcount) (reference: localkeys.go)
        self._local: dict[str, list[int]] = {}
        # remote cache: id -> key (reference: allocator cache.go)
        self.cache: dict[int, str] = {}
        # value-ref deletes that failed against a fenced/unreachable
        # store: retried by run_gc so a degraded-mode release cannot
        # leak the identity cluster-wide for the agent's lifetime.
        self._pending_unref: set[str] = set()
        # local references taken WITHOUT a remote value-ref
        # (retain_cached in degraded mode): republished by allocate()
        # and run_gc once the store returns, so cluster-wide GC sees
        # this node's use before it can reap the master key.
        self._pending_ref: set[str] = set()
        self._mutex = threading.RLock()
        self._watcher: Watcher | None = None
        self._sync_from_store()

    # -- paths -------------------------------------------------------------

    def _id_path(self, id_: int) -> str:
        return f"{self.base_path}/id/{id_}"

    def _value_prefix(self, key: str) -> str:
        return f"{self.base_path}/value/{self.backend.encode(key.encode())}"

    def _value_path(self, key: str) -> str:
        return f"{self._value_prefix(key)}/{self.suffix}"

    # -- init --------------------------------------------------------------

    def _fire_event(self, ev: AllocatorEvent) -> None:
        """Direct event dispatch, used only while no watcher runs — once
        start_watch is active the watcher delivers every master-key change
        and a direct callback would double-fire."""
        if self.events and self._watcher is None:
            self.events(ev)

    def _sync_from_store(self) -> None:
        for k, v in self.backend.list_prefix(f"{self.base_path}/id/").items():
            try:
                id_ = int(k.rsplit("/", 1)[1])
            except ValueError:
                continue
            self.id_pool.remove(id_)
            self.cache[id_] = v.decode()

    # -- allocation --------------------------------------------------------

    def allocate(self, key: str) -> tuple[int, bool]:
        """Allocate or reuse the cluster-wide ID for key; returns
        (id, is_new) (reference: allocator.go:240 Allocate).

        Epoch-aware: an EPOCH_FENCED rejection means the server our
        caches were derived from is stale (a failover happened
        mid-allocation).  The client has already redialed toward the
        newer primary — re-resolve against IT (drop the remote cache,
        re-list the master keys) and re-run the allocation once, so
        two nodes can never silently converge on divergent IDs from
        different sides of a partition."""
        for attempt in (0, 1):
            try:
                return self._allocate(key)
            except EpochFencedError as e:
                if attempt:
                    raise AllocatorError(
                        f"allocation of {key!r} fenced twice: {e}"
                    ) from e
                self._resync_after_fence()
        raise AssertionError("unreachable")

    def _resync_after_fence(self) -> None:
        """Remote state re-resolution after a fenced write: the id->key
        cache came from the stale primary; rebuild it from the store
        the client failed over to.  Node-local refcounts survive (the
        lease replay re-registers our value refs on the new session);
        GC reconciles any master key the new primary never saw.

        The fresh mapping is built OUTSIDE the mutex (it does kvstore
        I/O) and swapped in atomically: watch threads iterate
        self.cache under the mutex, and a concurrent clear+repopulate
        would blow up their iteration mid-failover."""
        fresh: dict[int, str] = {}
        for k, v in self.backend.list_prefix(f"{self.base_path}/id/").items():
            try:
                id_ = int(k.rsplit("/", 1)[1])
            except ValueError:
                continue
            fresh[id_] = v.decode()
        with self._mutex:
            in_use = {entry[0] for entry in self._local.values()}
            stale = set(self.cache) - set(fresh) - in_use
            # Locally-referenced identities the new primary never saw
            # (replication lag) must keep resolving — already-serving
            # endpoints depend on lookup_by_id — so merge them back
            # where the fresh view has no competing claim.
            for key, entry in self._local.items():
                fresh.setdefault(entry[0], key)
            self.cache.clear()
            self.cache.update(fresh)
        for id_ in fresh:
            self.id_pool.remove(id_)
        for id_ in stale:
            # Gone from the surviving store and not locally referenced:
            # allocatable again.
            self.id_pool.insert(id_)

    def _allocate(self, key: str) -> tuple[int, bool]:
        with self._mutex:
            entry = self._local.get(key)
            if entry is not None:
                entry[1] += 1
                id_, needs_ref = entry[0], key in self._pending_ref
                if not needs_ref:
                    return id_, False
        if entry is not None:
            # The entry came from a degraded-mode retain_cached and
            # has no durable value-ref yet: this allocate is the first
            # store contact since — publish the ref now (best-effort;
            # still degraded keeps it pending for run_gc to retry).
            try:
                self.backend.set(self._value_path(key),
                                 str(id_).encode(), lease=True)
                with self._mutex:
                    self._pending_ref.discard(key)
            except KvstoreError:
                pass
            return id_, False

        lock = self.backend.lock_path(f"{self.base_path}/locks/{key}")
        try:
            # Re-check under the lock: another same-node thread may have
            # allocated while we waited; bump its refcount instead of
            # resetting it to 1 (which would release prematurely).
            with self._mutex:
                entry = self._local.get(key)
                if entry is not None:
                    entry[1] += 1
                    return entry[0], False

            existing = self._lookup_key(key)
            if existing is not None:
                # Reuse the cluster-wide ID; register our reference.
                self.backend.set(self._value_path(key), str(existing).encode(),
                                 lease=True)
                self.id_pool.remove(existing)
                with self._mutex:
                    self._local[key] = [existing, 1]
                    self.cache[existing] = key
                return existing, False

            for _ in range(32):  # bounded retries on races
                id_ = self.id_pool.lease_random()
                if id_ is None:
                    raise AllocatorError("ID space exhausted")
                if self.backend.create_only(self._id_path(id_), key.encode()):
                    self.backend.set(self._value_path(key),
                                     str(id_).encode(), lease=True)
                    with self._mutex:
                        self._local[key] = [id_, 1]
                        self.cache[id_] = key
                    self._fire_event(AllocatorEvent(EventType.CREATE, id_, key))
                    return id_, True
                # Another node claimed this ID concurrently.
            raise AllocatorError(f"unable to allocate ID for key {key!r}")
        finally:
            lock.unlock()

    def _lookup_key(self, key: str) -> Optional[int]:
        """Find an existing master ID for key (reference: GetNoCache path)."""
        for k, v in self.backend.list_prefix(f"{self.base_path}/id/").items():
            if v.decode() == key:
                try:
                    return int(k.rsplit("/", 1)[1])
                except ValueError:
                    continue
        return None

    def get(self, key: str) -> Optional[int]:
        """ID for key from cache, if any (reference: allocator.Get)."""
        with self._mutex:
            entry = self._local.get(key)
            if entry is not None:
                return entry[0]
            for id_, k in self.cache.items():
                if k == key:
                    return id_
        return None

    def retain_cached(self, key: str) -> Optional[int]:
        """Take a LOCAL reference on an identity already known from the
        cache, with zero kvstore I/O — the degraded-mode path: the
        store is fenced/unreachable, but an ID this node (or the
        watch) already resolved keeps serving.  The reference is
        refcounted like allocate()'s, so a later release() balances
        instead of underflowing another endpoint's reference.  Caveat
        (documented degraded guarantee): no remote value-ref is
        written, so cluster-wide GC may not see this node's use until
        the next real allocate() after the store returns."""
        with self._mutex:
            entry = self._local.get(key)
            if entry is not None:
                entry[1] += 1
                return entry[0]
            for id_, k in self.cache.items():
                if k == key:
                    self._local[key] = [id_, 1]
                    # No remote value-ref was written: mark it owed so
                    # allocate()/run_gc republish once the store is
                    # back — until then another node's GC could still
                    # reap the master key (the documented degraded
                    # window).
                    self._pending_ref.add(key)
                    return id_
        return None

    def get_by_id(self, id_: int) -> Optional[str]:
        with self._mutex:
            return self.cache.get(id_)

    def release(self, key: str) -> bool:
        """Drop one local reference; removes our value key at zero
        (reference: allocator.go Release)."""
        with self._mutex:
            entry = self._local.get(key)
            if entry is None:
                return False
            entry[1] -= 1
            if entry[1] > 0:
                return True
        # Zero references: serialize the value-ref delete against
        # allocate() on the same key so we can't destroy a reference a
        # concurrent allocate just re-created.
        try:
            lock = self.backend.lock_path(f"{self.base_path}/locks/{key}")
        except KvstoreError:
            # Could not even reach the store for the lock: settle the
            # local side and defer the remote unref (same contract as
            # a failed delete below).
            with self._mutex:
                entry = self._local.get(key)
                if entry is not None and entry[1] <= 0:
                    del self._local[key]
                    self._pending_ref.discard(key)
                    self._pending_unref.add(key)
            raise
        try:
            with self._mutex:
                entry = self._local.get(key)
                if entry is None or entry[1] > 0:
                    return True  # re-acquired while we waited
                del self._local[key]
                self._pending_ref.discard(key)
            try:
                self.backend.delete(self._value_path(key))
            except KvstoreError:
                # Store fenced/unreachable: the local refcount is
                # already settled — record the remote unref as pending
                # so run_gc retries it, instead of leaking our value
                # key (which would block cluster-wide GC of this
                # identity until the agent restarts).
                with self._mutex:
                    self._pending_unref.add(key)
                raise
        finally:
            lock.unlock()
        return True

    def flush_pending_unrefs(self) -> int:
        """Retry value-ref deletes that failed while the store was
        degraded; returns how many cleared.  Keys re-allocated since
        are live again and simply dropped from the pending set."""
        with self._mutex:
            pending = list(self._pending_unref)
        cleared = 0
        for key in pending:
            with self._mutex:
                if key in self._local:
                    self._pending_unref.discard(key)
                    continue
            try:
                self.backend.delete(self._value_path(key))
            except KvstoreError:
                continue  # still degraded; next pass retries
            with self._mutex:
                self._pending_unref.discard(key)
            cleared += 1
        return cleared

    def flush_pending_refs(self) -> int:
        """Publish value-refs owed by degraded-mode retain_cached
        calls; returns how many landed.  Runs BEFORE the gc scan so
        our in-use identities are visible to every node's gc first."""
        with self._mutex:
            pending = [
                (key, self._local[key][0])
                for key in self._pending_ref
                if key in self._local
            ]
            # Entries released in the meantime owe nothing.
            self._pending_ref &= set(self._local)
        published = 0
        for key, id_ in pending:
            try:
                self.backend.set(self._value_path(key),
                                 str(id_).encode(), lease=True)
            except KvstoreError:
                continue  # still degraded; next pass retries
            with self._mutex:
                self._pending_ref.discard(key)
            published += 1
        return published

    def run_gc(self) -> int:
        """Remove master keys with no value references; returns count
        (reference: allocator.go RunGC)."""
        self.flush_pending_refs()
        self.flush_pending_unrefs()
        return self._run_gc()

    def _run_gc(self) -> int:
        removed = 0
        for k, v in list(
            self.backend.list_prefix(f"{self.base_path}/id/").items()
        ):
            key = v.decode()
            # Serialize against allocate() on the same key: without the
            # lock, GC could delete a master key between another node's
            # reuse-lookup and its value-ref write, causing ID reuse for a
            # different key.
            lock = self.backend.lock_path(f"{self.base_path}/locks/{key}")
            try:
                if self.backend.get(k) is None:
                    continue  # already removed while we waited
                if self.backend.list_prefix(self._value_prefix(key) + "/"):
                    continue  # referenced again
                self.backend.delete(k)
                try:
                    id_ = int(k.rsplit("/", 1)[1])
                except ValueError:
                    continue
                self.id_pool.insert(id_)
                with self._mutex:
                    self.cache.pop(id_, None)
                self._fire_event(AllocatorEvent(EventType.DELETE, id_, key))
                removed += 1
            finally:
                lock.unlock()
        return removed

    # -- watch -------------------------------------------------------------

    def start_watch(self) -> Watcher:
        """Watch master keys, keeping the remote cache in sync and firing
        the events callback (reference: allocator cache.go watcher)."""
        w = self.backend.list_and_watch("allocator", f"{self.base_path}/id/")
        self._watcher = w

        def run() -> None:
            for ev in w:
                if ev.typ == EventType.LIST_DONE:
                    continue
                try:
                    id_ = int(ev.key.rsplit("/", 1)[1])
                except (ValueError, IndexError):
                    continue
                with self._mutex:
                    if ev.typ == EventType.DELETE:
                        key = self.cache.pop(id_, "")
                        self.id_pool.insert(id_)
                    else:
                        key = ev.value.decode()
                        self.cache[id_] = key
                        self.id_pool.remove(id_)
                if self.events:
                    try:
                        self.events(AllocatorEvent(ev.typ, id_, key))
                    except Exception:  # noqa: BLE001 — a bad callback must
                        pass  # not kill the watch loop

        t = threading.Thread(target=run, name="allocator-watch", daemon=True)
        t.start()
        return w

    def stop_watch(self) -> None:
        if self._watcher is not None:
            self._watcher.stop()
