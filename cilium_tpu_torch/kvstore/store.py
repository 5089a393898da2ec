"""Shared key collection over the kvstore.

reference: pkg/kvstore/store/store.go — a generic collection of keys shared
across nodes: each node owns and keeps alive its local keys (lease +
periodic sync), a watcher mirrors all remote keys into a local map, and
observers are notified on updates/deletes.  Node discovery and service
propagation ride on this.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from .backend import Backend, EventType, KvstoreError

log = logging.getLogger(__name__)


class SharedStore:
    """reference: store.go SharedStore."""

    def __init__(
        self,
        backend: Backend,
        prefix: str,
        node_name: str,
        on_update: Callable[[str, dict], None] | None = None,
        on_delete: Callable[[str], None] | None = None,
    ) -> None:
        self.backend = backend
        self.prefix = prefix.rstrip("/")
        self.node_name = node_name
        self.on_update = on_update
        self.on_delete = on_delete
        self._local: dict[str, dict] = {}
        self._shared: dict[str, dict] = {}
        self._mutex = threading.RLock()
        self._watcher = None
        # True while the last publish/keepalive could not reach the
        # store (fenced or unreachable) — local keys keep serving and
        # are republished by the self-healing resync loop below.
        self.degraded = False
        self._closed = False
        self._resync_active = False
        # Set by any failed publish; the resync loop clears it before
        # a pass and re-checks after — a failure that lands WHILE a
        # pass is in flight (and thus missed it) forces another pass
        # instead of being stranded by the pass's success.
        self._dirty = False
        self._start_watch()

    def _key_path(self, name: str) -> str:
        return f"{self.prefix}/{name}"

    def update_local_key_sync(self, name: str, value: dict) -> None:
        """Publish/refresh one of our keys (reference:
        store.go UpdateLocalKeySync).  The local copy is recorded
        FIRST: if the store is fenced or unreachable the publish is
        deferred — the value is not lost, the periodic
        sync_local_keys keepalive republishes it once the store
        returns (degraded mode: local state keeps serving, cross-node
        propagation pauses)."""
        with self._mutex:
            self._local[name] = value
        try:
            self.backend.set(
                self._key_path(name), json.dumps(value).encode(), lease=True
            )
            self.degraded = False
        except KvstoreError as e:
            with self._mutex:
                self.degraded = True
                self._dirty = True
            log.warning(
                "store %s: publish of %s deferred (kvstore degraded): %s",
                self.prefix, name, e,
            )
            # Nothing else republishes on its own (no consumer runs a
            # periodic keepalive today) — the deferral claim is only
            # true if WE retry until the store takes the keys again.
            self._kick_resync()

    def delete_local_key(self, name: str) -> None:
        with self._mutex:
            self._local.pop(name, None)
        self.backend.delete(self._key_path(name))

    def get_shared_keys(self) -> dict[str, dict]:
        with self._mutex:
            return dict(self._shared)

    def get(self, name: str) -> Optional[dict]:
        with self._mutex:
            return self._shared.get(name)

    def sync_local_keys(self) -> None:
        """Re-publish all local keys (periodic keepalive refresh,
        reference: store.go syncLocalKeys).  Best-effort per key: one
        fenced/unreachable write must not strand the keys behind it —
        the next keepalive tick retries them all; ``degraded`` tracks
        whether the last full pass published everything."""
        with self._mutex:
            local = dict(self._local)
        failed = 0
        for name, value in local.items():
            try:
                self.backend.set(
                    self._key_path(name), json.dumps(value).encode(),
                    lease=True,
                )
            except KvstoreError as e:
                failed += 1
                log.warning("store %s: keepalive of %s failed: %s",
                            self.prefix, name, e)
        with self._mutex:
            self.degraded = failed > 0
            if failed:
                self._dirty = True
        if failed:
            self._kick_resync()

    def _kick_resync(self) -> None:
        """Start (at most one) background republisher that retries
        sync_local_keys with backoff until every local key landed —
        the recovery half of degraded mode."""
        with self._mutex:
            if self._resync_active or self._closed:
                return
            self._resync_active = True
        threading.Thread(
            target=self._resync_loop, daemon=True,
            name=f"store-resync-{self.prefix}",
        ).start()

    def _resync_loop(self) -> None:
        from ..utils.backoff import Exponential

        boff = Exponential(min_duration=1.0, max_duration=15.0,
                           name=f"store-resync-{self.prefix}")
        try:
            while True:
                boff.wait()
                with self._mutex:
                    if self._closed:
                        return
                    self._dirty = False
                    local = dict(self._local)
                ok = True
                for name, value in local.items():
                    try:
                        self.backend.set(
                            self._key_path(name),
                            json.dumps(value).encode(), lease=True,
                        )
                    except KvstoreError:
                        ok = False
                        break
                if ok:
                    with self._mutex:
                        if self._dirty:
                            continue  # a publish failed mid-pass
                        self.degraded = False
                    log.info("store %s: deferred keys republished",
                             self.prefix)
                    return
        finally:
            with self._mutex:
                self._resync_active = False
                # A publish that failed while we were exiting saw
                # _resync_active=True and declined to start a thread:
                # re-kick for it or its key would strand unpublished.
                redo = self._dirty and not self._closed
            if redo:
                self._kick_resync()

    def _start_watch(self) -> None:
        w = self.backend.list_and_watch(f"store-{self.prefix}", self.prefix + "/")
        self._watcher = w

        def run() -> None:
            for ev in w:
                if ev.typ == EventType.LIST_DONE:
                    continue
                name = ev.key[len(self.prefix) + 1:]
                # Own keys loop back through the prefix watch; the
                # shared view holds REMOTE state only (reference:
                # store.go onUpdate isLocal filter) — a node must not
                # discover itself as a peer.
                with self._mutex:
                    own = name in self._local or name == self.node_name
                if own:
                    continue
                if ev.typ == EventType.DELETE:
                    with self._mutex:
                        self._shared.pop(name, None)
                    if self.on_delete:
                        self.on_delete(name)
                else:
                    try:
                        value = json.loads(ev.value.decode())
                    except ValueError:
                        continue
                    with self._mutex:
                        self._shared[name] = value
                    if self.on_update:
                        self.on_update(name, value)

        threading.Thread(
            target=run, name=f"store-watch-{self.prefix}", daemon=True
        ).start()

    def close(self) -> None:
        with self._mutex:
            self._closed = True
        if self._watcher is not None:
            self._watcher.stop()
        for name in list(self._local):
            # Best-effort: on a dead/closing kvstore connection the
            # server-side lease revocation removes the key anyway
            # (session death = lease expiry) — teardown must not raise.
            try:
                self.delete_local_key(name)
            except KvstoreError as e:
                log.debug("store close: delete %s skipped: %s", name, e)
