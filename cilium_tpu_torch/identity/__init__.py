"""Security identities: labels -> cluster-wide numeric IDs.

reference: pkg/identity — NumericIdentity with reserved values (host=1,
world=2, unmanaged=3, health=4, init=5; user IDs >= 256,
numericidentity.go), Identity{ID, Labels, SHA} (identity.go:27), and the
kvstore-backed allocator (allocator.go:73,124) whose watcher feeds a local
identity cache; the cache owner is notified to trigger policy
recalculation.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from ..kvstore import Backend, client as kvstore_client
from ..kvstore.allocator import Allocator, AllocatorEvent
from ..kvstore.backend import EventType
from ..labels import (
    ID_NAME_HEALTH,
    ID_NAME_HOST,
    ID_NAME_INIT,
    ID_NAME_UNMANAGED,
    ID_NAME_WORLD,
    SOURCE_RESERVED,
    Label,
    Labels,
)

# Reserved numeric identities (reference: numericidentity.go).
IDENTITY_UNKNOWN = 0
RESERVED_HOST = 1
RESERVED_WORLD = 2
RESERVED_UNMANAGED = 3
RESERVED_HEALTH = 4
RESERVED_INIT = 5

MIN_USER_IDENTITY = 256
MAX_IDENTITY = 65535

RESERVED_IDENTITIES = {
    ID_NAME_HOST: RESERVED_HOST,
    ID_NAME_WORLD: RESERVED_WORLD,
    ID_NAME_UNMANAGED: RESERVED_UNMANAGED,
    ID_NAME_HEALTH: RESERVED_HEALTH,
    ID_NAME_INIT: RESERVED_INIT,
}
RESERVED_IDENTITY_NAMES = {v: k for k, v in RESERVED_IDENTITIES.items()}

# Identity allocation kvstore path (reference: allocator.go IdentitiesPath).
IDENTITIES_PATH = "cilium/state/identities/v1"


@dataclass(frozen=True)
class Identity:
    """reference: pkg/identity/identity.go:27."""

    id: int
    labels: Labels

    @property
    def sha256(self) -> str:
        return self.labels.sha256_sum()

    def is_reserved(self) -> bool:
        return self.id in RESERVED_IDENTITY_NAMES

    def label_array(self):
        return self.labels.to_array()


def new_reserved_identity(name: str) -> Identity:
    lbls = Labels()
    lbls.upsert(Label(key=name, source=SOURCE_RESERVED))
    return Identity(id=RESERVED_IDENTITIES[name], labels=lbls)


ReservedIdentities = {
    name: new_reserved_identity(name) for name in RESERVED_IDENTITIES
}


def look_up_reserved_identity(numeric: int) -> Optional[Identity]:
    name = RESERVED_IDENTITY_NAMES.get(numeric)
    return ReservedIdentities[name] if name else None


def _labels_key(lbls: Labels) -> str:
    """Canonical allocator key for a label set (the reference uses the
    sorted label list as the allocator key, allocator.go GetID)."""
    return lbls.sorted_list().decode()


def _is_label_part(part: str) -> bool:
    """A serialized label is ``source:key=value`` — ':' before '='."""
    c = part.find(":")
    e = part.find("=")
    return c > 0 and e > c


def _key_labels(key: str) -> Labels:
    out = Labels()
    last: Label | None = None
    for part in key.split(";"):
        if not part:
            continue
        if not _is_label_part(part):
            # Fragment of a value that itself contained ';' — re-join onto
            # the previous label rather than crashing the watch thread.
            if last is not None:
                last = Label(key=last.key, value=last.value + ";" + part,
                             source=last.source)
                out.upsert(last)
            continue
        src, rest = part.split(":", 1)
        k, v = rest.split("=", 1)
        last = Label(key=k, value=v, source=src)
        out.upsert(last)
    return out


class IdentityAllocator:
    """Cluster identity allocation + local cache
    (reference: pkg/identity/allocator.go + cache.go)."""

    def __init__(
        self,
        owner_notify: Callable[[], None] | None = None,
        backend: Backend | None = None,
        node_name: str = "local",
        events: Callable[["IdentityChange"], None] | None = None,
    ) -> None:
        self.owner_notify = owner_notify
        self.events = events
        self._mutex = threading.RLock()
        self.allocator = Allocator(
            backend or kvstore_client(),
            IDENTITIES_PATH,
            suffix=node_name,
            min_id=MIN_USER_IDENTITY,
            max_id=MAX_IDENTITY,
            events=self._on_allocator_event,
        )
        self.allocator.start_watch()

    def _on_allocator_event(self, ev: AllocatorEvent) -> None:
        if self.events:
            self.events(
                IdentityChange(
                    kind="upsert" if ev.typ != EventType.DELETE else "delete",
                    id=ev.id,
                    labels=_key_labels(ev.key) if ev.key else Labels(),
                )
            )
        # Remote allocation changes can affect policy: notify the owner
        # (reference: identityWatcher triggering policy recalc).
        if self.owner_notify:
            self.owner_notify()

    def allocate(self, lbls: Labels) -> tuple[Identity, bool]:
        """reference: allocator.go:124 AllocateIdentity."""
        reserved = lbls.get_from_source(SOURCE_RESERVED)
        if len(reserved) == len(lbls) and len(reserved) == 1:
            name = next(iter(reserved))
            if name in RESERVED_IDENTITIES:
                return ReservedIdentities[name], False
        id_, is_new = self.allocator.allocate(_labels_key(lbls))
        return Identity(id=id_, labels=lbls), is_new

    def release(self, identity: Identity) -> bool:
        if identity.is_reserved():
            return False
        return self.allocator.release(_labels_key(identity.labels))

    def retain_cached(self, lbls: Labels) -> Optional[Identity]:
        """Degraded-mode allocation: take a refcounted LOCAL reference
        on an identity already resolved for these labels, without any
        kvstore I/O (see Allocator.retain_cached).  None if the labels
        were never resolved — a truly new identity needs the store."""
        reserved = lbls.get_from_source(SOURCE_RESERVED)
        if len(reserved) == len(lbls) and len(reserved) == 1:
            name = next(iter(reserved))
            if name in RESERVED_IDENTITIES:
                return ReservedIdentities[name]
        id_ = self.allocator.retain_cached(_labels_key(lbls))
        if id_ is None:
            return None
        return Identity(id=id_, labels=lbls)

    def lookup_by_id(self, numeric: int) -> Optional[Identity]:
        """reference: cache.go LookupIdentityByID."""
        reserved = look_up_reserved_identity(numeric)
        if reserved is not None:
            return reserved
        key = self.allocator.get_by_id(numeric)
        if key is None:
            return None
        return Identity(id=numeric, labels=_key_labels(key))

    def lookup(self, lbls: Labels) -> Optional[Identity]:
        """reference: cache.go LookupIdentity."""
        reserved = lbls.get_from_source(SOURCE_RESERVED)
        if len(reserved) == len(lbls) and len(reserved) == 1:
            name = next(iter(reserved))
            if name in RESERVED_IDENTITIES:
                return ReservedIdentities[name]
        id_ = self.allocator.get(_labels_key(lbls))
        if id_ is None:
            return None
        return Identity(id=id_, labels=lbls)

    def get_identity_cache(self) -> dict[int, Labels]:
        """reference: cache.go GetIdentityCache."""
        out: dict[int, Labels] = {
            ident.id: ident.labels for ident in ReservedIdentities.values()
        }
        with self.allocator._mutex:
            cache = dict(self.allocator.cache)
        for id_, key in cache.items():
            out[id_] = _key_labels(key)
        return out

    def gc(self) -> int:
        return self.allocator.run_gc()

    def close(self) -> None:
        self.allocator.stop_watch()


@dataclass
class IdentityChange:
    kind: str  # upsert | delete
    id: int
    labels: Labels
