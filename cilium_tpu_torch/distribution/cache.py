"""Versioned resource cache (reference: pkg/envoy/xds/cache.go).

Holds the most recent version of each named resource per type URL; every
transaction bumps the cache version and records, per resource, the version
it last changed in — so a subscriber at version V receives exactly the
resources modified since V.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class VersionedResources:
    """reference: xds/stream.go VersionedResources."""

    version: int
    type_url: str
    resources: dict[str, Any]  # name -> resource (full current set)
    removed: list[str] = field(default_factory=list)


class Cache:
    """reference: xds/cache.go:34 Cache."""

    def __init__(self) -> None:
        # type_url -> name -> (resource, last_modified_version)
        self._resources: dict[str, dict[str, tuple[Any, int]]] = {}
        self.version = 1
        self._mutex = threading.RLock()
        self._observers: list[Callable[[str, int], None]] = []

    def add_observer(self, observer: Callable[[str, int], None]) -> None:
        """observer(type_url, new_version) on every change."""
        self._observers.append(observer)

    def tx(
        self,
        type_url: str,
        upserted: dict[str, Any],
        deleted: list[str] | None = None,
        force: bool = False,
    ) -> tuple[int, bool, Optional[Callable[[], None]]]:
        """Atomic transaction (reference: cache.go:79): returns
        (version, updated, revert)."""
        deleted = deleted or []
        with self._mutex:
            table = self._resources.setdefault(type_url, {})
            new_version = self.version + 1

            # Determine effective changes.
            revert_upserts: dict[str, tuple[Any, int]] = {}
            revert_deletes: dict[str, tuple[Any, int]] = {}
            changed = False
            for name, res in upserted.items():
                old = table.get(name)
                if old is not None and old[0] == res and not force:
                    continue
                if old is not None:
                    revert_upserts[name] = old
                else:
                    revert_upserts[name] = (None, 0)
                table[name] = (res, new_version)
                changed = True
            for name in deleted:
                old = table.pop(name, None)
                if old is not None:
                    revert_deletes[name] = old
                    changed = True

            if not changed and not force:
                return self.version, False, None
            self.version = new_version
            observers = list(self._observers)

            def revert() -> None:
                with self._mutex:
                    t = self._resources.setdefault(type_url, {})
                    rv = self.version + 1
                    for name, (res, _) in revert_upserts.items():
                        if res is None:
                            t.pop(name, None)
                        else:
                            t[name] = (res, rv)
                    for name, (res, _) in revert_deletes.items():
                        t[name] = (res, rv)
                    self.version = rv
                    obs = list(self._observers)
                for o in obs:
                    o(type_url, rv)

        for o in observers:
            o(type_url, new_version)
        return new_version, True, revert

    def upsert(self, type_url: str, name: str, resource: Any,
               force: bool = False):
        """reference: cache.go:175 Upsert."""
        return self.tx(type_url, {name: resource}, force=force)

    def delete(self, type_url: str, name: str):
        return self.tx(type_url, {}, [name])

    def clear(self, type_url: str):
        with self._mutex:
            names = list(self._resources.get(type_url, {}))
        return self.tx(type_url, {}, names)

    def lookup(self, type_url: str, name: str) -> Optional[Any]:
        with self._mutex:
            entry = self._resources.get(type_url, {}).get(name)
            return entry[0] if entry else None

    def get_resources(
        self, type_url: str, since_version: int = 0,
        names: list[str] | None = None,
    ) -> Optional[VersionedResources]:
        """Current resources if anything changed after since_version, else
        None (reference: cache.go GetResources)."""
        with self._mutex:
            table = self._resources.get(type_url, {})
            if names is not None:
                table = {n: table[n] for n in names if n in table}
            if not table and since_version == 0:
                # Nothing ever published: no initial delivery.
                return None
            newest = max((v for _, v in table.values()), default=self.version)
            if newest <= since_version:
                return None
            return VersionedResources(
                version=self.version,
                type_url=type_url,
                resources={n: r for n, (r, _) in table.items()},
            )
