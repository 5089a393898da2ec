"""Services / load-balancer control plane.

reference: pkg/service/id_kvstore.go (cluster-wide service-ID
allocation over the kvstore), daemon/loadbalancer.go:34 addSVC2BPFMap
/ :56 SVCAdd / svcAdd / svcDelete (frontend+backends -> LB map
programming with RevNAT), pkg/loadbalancer/loadbalancer.go (L3n4Addr
and LBSVC models).

The ServiceManager is the daemon-side owner of the LbMap: every
frontend gets a cluster-wide numeric service ID from the kvstore (used
as the RevNAT index, as in the reference), backends land in the slave
slots, and the service model is queryable by ID for the REST/CLI
surface.  The k8s watcher drives it from Service+Endpoints objects;
the REST API drives it directly (PUT/GET/DELETE /v1/service).
"""

from __future__ import annotations

import ipaddress
import json
import threading
from dataclasses import dataclass, field

from ..kvstore.backend import Backend, EpochFencedError, KvstoreError

# reference: common/const.go FirstFreeServiceID = 1
FIRST_FREE_SERVICE_ID = 1
MAX_SERVICE_ID = 0xFFFF  # RevNAT indices are u16 in the BPF maps

SERVICE_ID_PATH = "cilium/state/services/v1"


class ServiceError(RuntimeError):
    pass


@dataclass(frozen=True)
class L3n4Addr:
    """Frontend/backend address (reference: pkg/loadbalancer L3n4Addr)."""

    ip: str
    port: int
    protocol: str = "TCP"

    @property
    def family(self) -> int:
        return ipaddress.ip_address(self.ip).version

    @property
    def ip_int(self) -> int:
        return int(ipaddress.ip_address(self.ip))

    def key(self) -> str:
        """Canonical identity string (the reference's SHA256Sum role:
        one ID per distinct frontend)."""
        return f"{ipaddress.ip_address(self.ip)}:{self.port}/{self.protocol.upper()}"

    def to_dict(self) -> dict:
        return {"ip": self.ip, "port": self.port, "protocol": self.protocol}

    @classmethod
    def from_dict(cls, d: dict) -> "L3n4Addr":
        try:
            ip = str(ipaddress.ip_address(d["ip"]))
            port = int(d["port"])
        except (KeyError, ValueError, TypeError) as e:
            raise ServiceError(f"invalid address {d!r}: {e}") from e
        if not 0 < port <= 0xFFFF:
            raise ServiceError(f"invalid port {port}")
        return cls(ip=ip, port=port, protocol=d.get("protocol", "TCP").upper())


class ServiceIDAllocator:
    """Cluster-wide service-ID allocation (reference:
    pkg/service/id_kvstore.go AcquireID/GetID/DeleteID).

    Layout: ``<base>/id/<n>`` -> frontend JSON, ``<base>/next`` -> the
    free-ID hint the reference keeps in its FreeID key.  All mutation
    happens under a kvstore lock so concurrent agents converge on one
    ID per frontend.
    """

    def __init__(self, backend: Backend, base_path: str = SERVICE_ID_PATH):
        self.backend = backend
        self.base = base_path.rstrip("/")

    def _id_key(self, id_: int) -> str:
        return f"{self.base}/id/{id_}"

    def _find_by_frontend(self, fe_key: str) -> tuple[int, dict] | None:
        for k, v in self.backend.list_prefix(f"{self.base}/id/").items():
            try:
                data = json.loads(v.decode())
                id_ = int(k.rsplit("/", 1)[1])
            except (ValueError, KeyError):
                continue
            if data.get("key") == fe_key:
                return id_, data
        return None

    def acquire_id(self, frontend: L3n4Addr, desired: int = 0) -> int:
        """Allocate (or reuse) the cluster-wide ID for a frontend
        (reference: id_kvstore.go acquireGlobalID).  With ``desired``
        nonzero, bind exactly that ID or fail — the SVCAdd contract
        (daemon/loadbalancer.go:56): a frontend already registered
        under a different ID, or an ID bound to a different frontend,
        is an error surfaced to the caller.

        Epoch-aware: an EPOCH_FENCED rejection mid-sequence means the
        store failed over.  Every fenced op was rejected before being
        applied, so the whole lock + find + CAS sequence re-runs
        cleanly against the new primary (which re-resolves the
        frontend->ID binding from ITS key space)."""
        try:
            return self._acquire_id(frontend, desired)
        except EpochFencedError:
            return self._acquire_id(frontend, desired)

    def _acquire_id(self, frontend: L3n4Addr, desired: int = 0) -> int:
        if desired and not 0 < desired <= MAX_SERVICE_ID:
            raise ServiceError(
                f"service ID {desired} outside [1, {MAX_SERVICE_ID}] "
                f"(RevNAT indices are u16)"
            )
        fe_key = frontend.key()
        lock = self.backend.lock_path(f"{self.base}/lock")
        try:
            existing = self._find_by_frontend(fe_key)
            if existing is not None:
                id_, _ = existing
                if desired and id_ != desired:
                    raise ServiceError(
                        f"frontend {fe_key} already registered with ID "
                        f"{id_}, requested {desired}"
                    )
                return id_
            value = json.dumps(
                {"key": fe_key, "frontend": frontend.to_dict()}
            ).encode()
            if desired:
                if self.backend.get(self._id_key(desired)) is not None:
                    raise ServiceError(
                        f"service ID {desired} is already registered to a "
                        f"different frontend"
                    )
                self.backend.set(self._id_key(desired), value)
                self._bump_next(desired + 1)
                return desired
            next_id = self._read_next()
            for _ in range(MAX_SERVICE_ID):
                if next_id > MAX_SERVICE_ID:
                    next_id = FIRST_FREE_SERVICE_ID
                if self.backend.create_only(self._id_key(next_id), value):
                    self._bump_next(next_id + 1)
                    return next_id
                next_id += 1
            raise ServiceError("service ID space exhausted")
        finally:
            lock.unlock()

    def _read_next(self) -> int:
        raw = self.backend.get(f"{self.base}/next")
        if raw is None:
            return FIRST_FREE_SERVICE_ID
        try:
            return max(FIRST_FREE_SERVICE_ID, int(raw.decode()))
        except ValueError:
            return FIRST_FREE_SERVICE_ID

    def _bump_next(self, value: int) -> None:
        # Hint only (reference: setMaxID) — correctness comes from the
        # atomic create_only on the id key.  Only ever raised: moving it
        # backwards would make auto-allocation re-scan taken IDs.
        if value > self._read_next():
            self.backend.set(f"{self.base}/next", str(value).encode())

    def get_id(self, id_: int) -> L3n4Addr | None:
        """reference: id_kvstore.go GetID."""
        raw = self.backend.get(self._id_key(id_))
        if raw is None:
            return None
        try:
            return L3n4Addr.from_dict(json.loads(raw.decode())["frontend"])
        except (ValueError, KeyError, ServiceError):
            return None

    def delete_id(self, id_: int) -> bool:
        """reference: id_kvstore.go DeleteID.  Same fenced-retry
        contract as acquire_id: rejected-before-apply, so the lock +
        delete re-runs whole against the post-failover primary."""
        try:
            return self._delete_id(id_)
        except EpochFencedError:
            return self._delete_id(id_)

    def _delete_id(self, id_: int) -> bool:
        lock = self.backend.lock_path(f"{self.base}/lock")
        try:
            if self.backend.get(self._id_key(id_)) is None:
                return False
            self.backend.delete(self._id_key(id_))
            return True
        finally:
            lock.unlock()


@dataclass
class LBService:
    """Stored service model (reference: pkg/loadbalancer LBSVC)."""

    id: int
    frontend: L3n4Addr
    backends: list[L3n4Addr] = field(default_factory=list)

    def to_model(self) -> dict:
        """REST model (reference: api/v1 Service/ServiceSpec)."""
        return {
            "id": self.id,
            "frontend-address": self.frontend.to_dict(),
            "backend-addresses": [b.to_dict() for b in self.backends],
        }


class ServiceManager:
    """Owner of the LB maps (reference: daemon/loadbalancer.go's
    d.loadBalancer + addSVC2BPFMap).  All map programming for services
    funnels through here so the REST, CLI, and k8s paths share one
    bookkeeping surface."""

    def __init__(self, lb_map, backend: Backend) -> None:
        self.lb_map = lb_map
        self.id_allocator = ServiceIDAllocator(backend)
        # id -> LBSVC and frontend-key -> id (reference: SVCMapID + SVCMap)
        self._services: dict[int, LBService] = {}
        self._by_frontend: dict[str, int] = {}
        # (ip_int, port, family) -> protocol, for the O(1) map-slot
        # collision check (the LB map key carries no protocol).
        self._slot_proto: dict[tuple, str] = {}
        self._mutex = threading.RLock()  # reference: BPFMapMU

    # -- core add/delete (reference: SVCAdd / svcAdd / svcDelete) ---------

    def upsert(
        self,
        frontend: L3n4Addr,
        backends: list[L3n4Addr],
        id: int = 0,
    ) -> tuple[int, bool]:
        """Install or update a service; returns (service_id, created).
        The service ID doubles as the RevNAT index, exactly as the
        reference programs RevNAT with feCilium.ID
        (daemon/loadbalancer.go:34)."""
        for be in backends:
            if be.family != frontend.family:
                raise ServiceError(
                    f"backend {be.key()} address family does not match "
                    f"frontend {frontend.key()}"
                )
        with self._mutex:
            # The datapath service key is (vip, port) without protocol —
            # same as the reference's lb4_key (bpf/lib/common.h:427),
            # where two services differing only in protocol would
            # silently share one map slot.  Reject that instead of
            # desyncing the manager from the map.
            slot = (frontend.ip_int, frontend.port, frontend.family)
            other_proto = self._slot_proto.get(slot)
            if other_proto is not None and other_proto != frontend.protocol:
                raise ServiceError(
                    f"frontend {frontend.key()} collides with an "
                    f"existing {other_proto} service on the same "
                    f"VIP:port: the LB map key has no protocol"
                )
            # Local cache first (reference: SVCMap in front of the
            # kvstore): the k8s endpoint-churn hot path must not pay a
            # kvstore lock + scan for a frontend whose ID is known.
            known = self._by_frontend.get(frontend.key())
            if known is not None and id in (0, known):
                svc_id = known
            else:
                svc_id = self.id_allocator.acquire_id(frontend, desired=id)
            created = svc_id not in self._services
            pairs = [(b.ip_int, b.port) for b in backends]
            if frontend.family == 4:
                self.lb_map.upsert_service(
                    frontend.ip_int, frontend.port, pairs,
                    rev_nat_index=svc_id,
                )
            else:
                self.lb_map.upsert_service6(
                    frontend.ip_int, frontend.port, pairs,
                    rev_nat_index=svc_id,
                )
            self._services[svc_id] = LBService(
                id=svc_id, frontend=frontend, backends=list(backends)
            )
            self._by_frontend[frontend.key()] = svc_id
            self._slot_proto[slot] = frontend.protocol
            return svc_id, created

    def delete_by_id(self, id_: int) -> bool:
        """reference: DELETE /service/{id} handler
        (daemon/loadbalancer.go:183) — drops the kvstore ID, the map
        entries, and the model."""
        with self._mutex:
            svc = self._services.pop(id_, None)
            if svc is None:
                return False
            self._by_frontend.pop(svc.frontend.key(), None)
            self._slot_proto.pop(
                (svc.frontend.ip_int, svc.frontend.port,
                 svc.frontend.family), None,
            )
            self.id_allocator.delete_id(id_)
            self._delete_from_map(svc.frontend)
            return True

    def delete_by_frontend(self, frontend: L3n4Addr) -> bool:
        """reference: svcDeleteByFrontend (k8s teardown path)."""
        with self._mutex:
            id_ = self._by_frontend.get(frontend.key())
            if id_ is None:
                return False
            return self.delete_by_id(id_)

    def _delete_from_map(self, frontend: L3n4Addr) -> None:
        if frontend.family == 4:
            self.lb_map.delete_service(frontend.ip_int, frontend.port)
        else:
            self.lb_map.delete_service6(frontend.ip_int, frontend.port)

    def resync(self, desired: list[tuple[L3n4Addr, list[L3n4Addr]]]) -> dict:
        """Converge the LB maps onto the FULL desired frontend set —
        the k8s relist path under churn (reference: the watcher's
        replaceCiliumService resync after an apiserver reconnect).
        Upserts every desired service and prunes frontends that
        vanished from the desired set, so a burst of missed
        add/update/delete events cannot leave stale map slots serving
        dead backends.  Returns {"upserted", "created", "pruned"}."""
        created = 0
        keep: set[str] = set()
        for frontend, backends in desired:
            keep.add(frontend.key())
            _, was_created = self.upsert(frontend, backends)
            if was_created:
                created += 1
        pruned = 0
        with self._mutex:
            stale = [
                svc.frontend for svc in self._services.values()
                if svc.frontend.key() not in keep
            ]
            for frontend in stale:
                if self.delete_by_frontend(frontend):
                    pruned += 1
        return {
            "upserted": len(desired),
            "created": created,
            "pruned": pruned,
        }

    # -- queries (reference: GET /service, GET /service/{id}) -------------

    def get(self, id_: int) -> LBService | None:
        with self._mutex:
            return self._services.get(id_)

    def get_by_frontend(self, frontend: L3n4Addr) -> LBService | None:
        with self._mutex:
            id_ = self._by_frontend.get(frontend.key())
            return self._services.get(id_) if id_ is not None else None

    def list(self) -> list[LBService]:
        with self._mutex:
            return [self._services[i] for i in sorted(self._services)]

    def __len__(self) -> int:
        return len(self._services)
