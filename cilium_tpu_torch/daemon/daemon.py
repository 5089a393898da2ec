"""Daemon core (reference: daemon/daemon.go NewDaemon + daemon/policy.go).

Construction order mirrors the reference's bootstrap (daemon.go:1090):
struct-alignment check, kvstore client, policy repository, endpoint
builders, identity allocator (owner callback -> policy recalc trigger),
ipcache watcher feeding the datapath map, proxy support, distribution
server, monitor, access log, status controllers, endpoint restore.

A copy of ``cilium_tpu/daemon/daemon.py``.  The daemon runs on one
device, resolved once from ``config.verdict_device`` before anything else
(``"cpu"``: the CPU; ``"default"``: the CUDA card, raising without one):
its endpoints export their policy maps there, its prefilter compiles
there, and its proxy engines build there (``runtime/engines.py``
``_daemon_device`` reads the same field).  There is no host-only mode.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import torch

from ..accesslog import AccessLogger
from ..alignchecker import check_struct_alignments
from ..datapath import PreFilter
from ..device import config_device, resolve_device
from ..distribution import (
    AckingMutator,
    Cache,
    DistributionServer,
    TYPE_NETWORK_POLICY,
    TYPE_NETWORK_POLICY_HOSTS,
)
from ..endpoint import BuildQueue, Endpoint, EndpointManager, EndpointState
from ..identity import IdentityAllocator
from ..ipcache import (
    IPIdentityCache,
    IPIdentityPair,
    KvstoreIPSync,
    datapath_listener,
)
from ..kvstore import (
    FileBackend,
    KvstoreError,
    LocalBackend,
    LockError,
    NetBackend,
    setup_client,
)
from ..kvstore.allocator import AllocatorError
from ..labels import Labels, LabelArray
from ..maps import CtMap, IpcacheMap, LbMap, MetricsMap
from ..monitor import (
    AGENT_NOTIFY_KVSTORE_DEGRADED,
    AGENT_NOTIFY_KVSTORE_RESTORED,
    AGENT_NOTIFY_POLICY_UPDATED,
    AGENT_NOTIFY_START,
    Monitor,
)
from ..policy import Repository, Rule, SearchContext, Tracing, init_entities
from ..proxy import ProxyManager
from ..sidecar import blackbox
from ..utils import defaults
from ..utils.controller import ControllerManager, ControllerParams
from ..utils.logging import get_logger
from ..utils.metrics import (
    EndpointCount,
    KvstoreDegraded,
    KvstoreDegradedEvents,
    PolicyCount,
    PolicyImportErrors,
    PolicyRevision,
    registry as metrics_registry,
)
from ..utils import option as option_mod
from ..utils.option import DaemonConfig
from ..utils.trigger import Trigger

log = get_logger("daemon")


class Daemon:
    """reference: daemon/daemon.go Daemon."""

    def __init__(self, config: DaemonConfig | None = None,
                 node_name: str = "local") -> None:
        self.config = config or DaemonConfig()
        self.config.validate()
        # The daemon's one device, resolved before any socket, thread or
        # process-global setting exists, so a daemon that cannot start
        # leaks nothing.
        self.device = resolve_device(config_device(self.config))
        # Install as the process-global config: endpoints and other
        # subsystems consult option.config (reference: option.Config
        # singleton populated from flags).
        option_mod.config = self.config
        check_struct_alignments()  # reference: daemon bootstrap align check
        init_entities(self.config.cluster_name)

        self.node_name = node_name
        self.controllers = ControllerManager()

        # kvstore (reference: kvstore.Client setup; "tcp" is the
        # networked backend — the etcd-module analog)
        if self.config.kvstore == "file":
            path = self.config.kvstore_opts.get(
                "path", os.path.join(self.config.run_dir, "kvstore.json")
            )
            self.kvstore = FileBackend(path)
        elif self.config.kvstore == "tcp":
            self.kvstore = NetBackend(self.config.kvstore_opts["address"])
        else:
            self.kvstore = LocalBackend()
        setup_client(self.kvstore)
        # Degraded-mode latch (reference: the agent keeps the datapath
        # up on cached state when etcd flaps — kvstore connectivity is
        # a status condition, not a crash): endpoint regeneration and
        # verdict serving continue on cached identities while the
        # store is fenced or unreachable.
        self._kvstore_degraded = False
        self._kv_degraded_lock = threading.Lock()

        # Policy repository (reference: policy.NewPolicyRepository)
        self.policy = Repository()
        self._cidr_identities: dict[str, object] = {}

        # Endpoint management + builders (reference: daemon.go:238)
        self.endpoint_manager = EndpointManager(device=self.device)
        workers = max(defaults.MIN_ENDPOINT_BUILDERS, os.cpu_count() or 1)
        self.build_queue = BuildQueue(
            self._build_endpoint, workers=workers
        )

        # Regeneration trigger folding policy events (reference:
        # TriggerPolicyUpdates + pkg/trigger)
        self.policy_trigger = Trigger(
            self._trigger_policy_updates_now,
            min_interval=0.05,
            name="policy-regen",
        )

        # Identity allocation (reference: identity.InitIdentityAllocator)
        self.identity_allocator = IdentityAllocator(
            owner_notify=self.policy_trigger.trigger,
            backend=self.kvstore,
            node_name=node_name,
        )

        # ipcache + datapath map (reference: ipcache.InitIPIdentityWatcher)
        self.ipcache = IPIdentityCache(self.config.cluster_name)
        self.ipcache_map = IpcacheMap()
        self.ipcache.add_listener(datapath_listener(self.ipcache_map))
        self.ipcache_sync = KvstoreIPSync(self.ipcache, backend=self.kvstore)
        self.ipcache_sync.start_watcher()

        # Node registry: publish the local node, track peers (reference:
        # node.AutoComplete + the pkg/node kvstore store; remote nodes
        # are what the overlay encaps toward and what the health prober
        # probes).  Health attrs exist BEFORE the watch starts: node
        # events fire from the watcher thread immediately.
        self.health_responder = None
        self.health_prober = None
        from ..node import Node, NodeDiscovery

        self.node_discovery = NodeDiscovery(
            Node(
                name=node_name,
                cluster=self.config.cluster_name,
                ipv4_address=self.config.node_ipv4,
            ),
            backend=self.kvstore,
            on_node_update=self._on_remote_node,
            on_node_delete=self._on_remote_node_gone,
        )

        # Other datapath maps
        self.ct_map = CtMap()
        self.lb_map = LbMap()
        self.metrics_map = MetricsMap()
        self.prefilter = PreFilter(device=self.device)

        # Services / load-balancer control plane: programs the LbMap
        # from the REST API and the k8s watcher, with RevNAT ids
        # allocated cluster-wide through the kvstore (reference:
        # daemon/loadbalancer.go + pkg/service/id_kvstore.go).
        from ..service import ServiceManager

        self.service_manager = ServiceManager(self.lb_map, self.kvstore)

        # Proxy + runtime engines (reference: proxy.StartProxySupport)
        self.proxy_manager = ProxyManager(
            self.config.proxy_port_min,
            self.config.proxy_port_max,
            create_backend=self._create_proxy_backend,
        )

        # Policy distribution (reference: envoy.StartXDSServer)
        self.dist_cache = Cache()
        self.dist_server = DistributionServer(self.dist_cache)
        self.acking_mutator = AckingMutator(self.dist_cache, self.dist_server)

        # Monitor + access log
        self.monitor = Monitor(self.config.monitor_queue_size)
        # Flow-record ring (flowlog/): the datapath accounting pass and
        # the daemon-side L7 engines feed it; POLICY-VERDICT monitor
        # events ride the PolicyVerdictNotification runtime option.
        from ..flowlog import FlowLog

        self.flowlog = (
            FlowLog(
                capacity=self.config.flowlog_ring,
                opts=self.config.opts,
                monitor=self.monitor,
            )
            if self.config.flow_observe else None
        )
        self.access_logger = AccessLogger(
            endpoint_lookup=self.endpoint_manager.lookup,
            notify=lambda rec: self.monitor.notify(
                _accesslog_event(rec)
            ),
        )

        # cilium-health: per-node responder + cluster prober
        # (reference: daemon/main.go:926-968 health endpoint launch)
        if self.config.enable_health:
            from ..health import HealthResponder, Prober

            self.health_responder = HealthResponder()
            self.health_prober = Prober(
                node_name=node_name, controllers=self.controllers
            )
            self.health_prober.add_node(
                node_name, self.health_responder.address
            )
            self.health_prober.start()
            # Advertise the responder address cluster-wide and probe
            # every peer already discovered (reference: the health IP
            # travels in the Node object, prober.go probes all nodes).
            self.node_discovery.update_local(
                ipv4_health_ip=self.health_responder.address
            )
            for n in self.node_discovery.get_nodes().values():
                self._on_remote_node(n)

        # DNS poller slot for toFQDNs rules (started on demand with a
        # resolver via start_dns_poller; reference: daemon.go:1334
        # fqdn.StartDNSPoller)
        self.dns_poller = None

        # NPDS push target (attach_verdict_service connects it;
        # reference: the agent-embedded xDS server's policy stream)
        self.npds_pusher = None

        # Opt-in profiling + per-flow debug gates (reference: --pprof
        # -> pkg/pprof.Enable, pkg/flowdebug.Enable from initEnv)
        self.pprof_server = None
        if self.config.pprof:
            from ..utils import pprofserve

            self.pprof_server = pprofserve.enable(
                ("127.0.0.1", self.config.pprof_port)
            )
        if self.config.per_flow_debug:
            from ..utils import flowdebug

            flowdebug.enable()

        # Controllers (reference: pkg/controller usage across the daemon)
        self.controllers.update_controller(
            "metrics-sync",
            ControllerParams(do_func=self._sync_metrics, run_interval=5.0),
        )
        self.controllers.update_controller(
            "ct-gc",
            ControllerParams(do_func=lambda: self.ct_map.gc(),
                             run_interval=30.0),
        )
        self.controllers.update_controller(
            "identity-gc",
            ControllerParams(do_func=lambda: self.identity_allocator.gc(),
                             run_interval=300.0),
        )
        # Retry endpoints stranded not-ready by a failed proxy-ACK gate
        # (transient NPDS NACK/timeout with the service still attached)
        # — the reference's endpoint regeneration controller role.
        self.controllers.update_controller(
            "endpoint-regen-retry",
            ControllerParams(do_func=self._retry_not_ready_endpoints,
                             run_interval=15.0),
        )
        # Store liveness probe driving the degraded-mode latch both
        # ways (a flapless exit path: no endpoint churn is needed to
        # notice the store came back).
        self.controllers.update_controller(
            "kvstore-health",
            ControllerParams(do_func=self._check_kvstore_health,
                             run_interval=5.0),
        )

        # Touch the device once, on this thread, before the build-queue
        # workers race to first-touch it (each export launches from a
        # worker thread; the CUDA context is made on first use).
        torch.zeros(1, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log.with_field("device", str(self.device)).info("device backend ready")

        self._started = time.time()
        self.monitor.send_agent_notification(
            AGENT_NOTIFY_START, f"cilium-tpu agent started on {node_name}"
        )

        if self.config.restore_state:
            self.restore_endpoints()

    # -- EndpointOwner protocol -------------------------------------------

    def get_policy_repository(self) -> Repository:
        return self.policy

    def get_identity_cache(self):
        return self.identity_allocator.get_identity_cache()

    def get_proxy_manager(self) -> ProxyManager:
        return self.proxy_manager

    def update_network_policy(self, ep: Endpoint) -> bool:
        """ACK-gated proxy policy push, called from inside
        Endpoint.regenerate (reference: pkg/endpoint/policy.go:402 →
        envoy.UpdateNetworkPolicy, blocking on the xDS ACK completion,
        bpf.go:555).  No verdict service attached = vacuous ACK (the
        reference likewise skips the wait with no proxy redirects).
        Returns False on push failure, NACK, or timeout — the endpoint
        then reverts and reports not-ready."""
        if self.npds_pusher is None:
            return True
        try:
            return self.npds_pusher.upsert(
                ep, self.identity_allocator.get_identity_cache()
            )
        except (OSError, TimeoutError):
            log.with_field("ep", ep.id).warning(
                "NPDS push failed; verdict service unreachable — "
                "regeneration will revert"
            )
            return False

    # -- kvstore degraded mode ---------------------------------------------

    def _enter_kvstore_degraded(self, reason: str) -> None:
        with self._kv_degraded_lock:
            if self._kvstore_degraded:
                return
            self._kvstore_degraded = True
        KvstoreDegraded.set(1)
        KvstoreDegradedEvents.inc()
        # Fail-closed marker: lands in every installed flight recorder
        # (the daemon has no recorder of its own — a co-hosted verdict
        # service's ring is where the incident timeline lives).
        blackbox.broadcast_mark("kvstore_degraded", reason=reason)
        log.with_field("reason", reason).warning(
            "kvstore degraded: continuing on cached identities"
        )
        self.monitor.send_agent_notification(
            AGENT_NOTIFY_KVSTORE_DEGRADED,
            f"kvstore degraded ({reason}); serving cached identities",
        )

    def _exit_kvstore_degraded(self) -> None:
        with self._kv_degraded_lock:
            if not self._kvstore_degraded:
                return
            self._kvstore_degraded = False
        KvstoreDegraded.set(0)
        blackbox.broadcast_mark("kvstore_restored")
        log.info("kvstore connectivity restored")
        self.monitor.send_agent_notification(
            AGENT_NOTIFY_KVSTORE_RESTORED, "kvstore connectivity restored"
        )

    def _check_kvstore_health(self) -> None:
        """The only path OUT of degraded mode.  Reachability is not
        enough: a fenced or still-replicating server answers pings and
        reads while rejecting every write — the probe must check
        WRITABILITY (role + fencing state), or the latch would flap
        'restored' while allocations still fail."""
        b = self.kvstore
        ping = getattr(b, "ping", None)
        if not callable(ping):
            return  # local/file backends cannot flap
        if not ping():
            self._enter_kvstore_degraded("store unreachable")
            return
        info_fn = getattr(b, "server_info", None)
        if callable(info_fn):
            try:
                info = info_fn()
            except KvstoreError as e:
                self._enter_kvstore_degraded(f"status probe: {e}")
                return
            if info.get("fenced") or info.get("role") != "primary":
                self._enter_kvstore_degraded(
                    f"store {info.get('address')} not writable "
                    f"(role={info.get('role')}, "
                    f"fenced={info.get('fenced')})"
                )
                return
        self._exit_kvstore_degraded()

    def _allocate_identity(self, lbls: Labels):
        """Identity allocation with graceful degradation: a fenced or
        unreachable store must not stop endpoint regeneration — labels
        already resolved keep their cached identity (cluster-unique by
        construction when it was allocated), with a LOCAL refcounted
        reference so the eventual release balances; only a truly NEW
        label set fails while degraded.  Exiting degraded mode is the
        health probe's job — a cache-served allocation proves nothing
        about connectivity."""
        try:
            return self.identity_allocator.allocate(lbls)
        except (LockError, AllocatorError):
            # KvstoreError subclasses that do NOT mean the store is
            # down (lock contention, ID-space exhaustion): latching
            # degraded mode for them would flap the gauge and spam
            # monitor notifications while the store is healthy.
            raise
        except KvstoreError as e:
            cached = self.identity_allocator.retain_cached(lbls)
            self._enter_kvstore_degraded(f"identity allocation: {e}")
            if cached is None:
                raise
            return cached, False

    def _kvstore_publish(self, desc: str, fn) -> None:
        """Best-effort kvstore propagation (ipcache pairs etc.): local
        datapath state is already updated by the caller; a degraded
        store defers only the CROSS-NODE announcement.  Lock
        contention and allocator-domain errors are not connectivity
        loss — they propagate instead of latching degraded mode."""
        try:
            fn()
        except (LockError, AllocatorError):
            raise
        except KvstoreError as e:
            self._enter_kvstore_degraded(f"{desc}: {e}")

    # -- proxy backends ----------------------------------------------------

    def _create_proxy_backend(self, redirect):
        """Instantiate the runtime batch engine for a redirect; wired to
        the per-protocol model builders (reference dispatch:
        pkg/proxy/proxy.go:229-236)."""
        from ..runtime.engines import create_engine_for_redirect

        return create_engine_for_redirect(self, redirect)

    # -- endpoint lifecycle ------------------------------------------------

    def _build_endpoint(self, ep: Endpoint) -> None:
        ok = ep.regenerate(self, "policy update")
        if ok:
            self._push_endpoint_policy(ep)
            if not self.config.dry_mode:
                ep.write_state(self._state_dir())

    def _local_pair(self, ipv4: str, identity_id: int) -> IPIdentityPair:
        """The kvstore pair for a local endpoint IP: carries this node's
        underlay address so remote nodes learn where to encap
        (reference: pkg/ipcache/kvstore.go hostIP marshalling;
        consumed by the overlay path, bpf/lib/encap.h)."""
        import ipaddress

        tunnel = 0
        if self.config.node_ipv4:
            tunnel = int(ipaddress.IPv4Address(self.config.node_ipv4))
        return IPIdentityPair(
            ipv4, identity_id,
            tunnel_endpoint=tunnel, host_ip=self.config.node_ipv4,
        )

    def _on_remote_node(self, node) -> None:
        """Node discovery -> health prober feed (reference: the prober
        walks the discovered node set, pkg/health/server/prober.go:40)."""
        if self.health_prober is not None and node.ipv4_health_ip:
            self.health_prober.add_node(node.fullname(), node.ipv4_health_ip)

    def _on_remote_node_gone(self, name: str) -> None:
        if self.health_prober is not None:
            self.health_prober.remove_node(name)

    def _retry_not_ready_endpoints(self) -> None:
        """Re-enqueue endpoints that failed their last regeneration
        (e.g. proxy-ACK timeout) so policy converges without waiting
        for an unrelated policy event (reference: controller-driven
        endpoint regeneration retries with backoff)."""
        for ep in self.endpoint_manager.get_endpoints():
            if ep.state == EndpointState.NOT_READY:
                ep.set_state(
                    EndpointState.WAITING_TO_REGENERATE, "regen retry"
                )
                self.build_queue.enqueue(ep, key=ep.id)

    def attach_verdict_service(self, socket_path: str):
        """Connect the NPDS push to a live verdict service and sync the
        current endpoint policies (reference: daemon.go:1327
        StartProxySupport → envoy.StartXDSServer; here the daemon dials
        the service's socket instead of serving gRPC)."""
        from ..proxy.npds_push import NpdsPusher

        if self.npds_pusher is not None:
            self.npds_pusher.close()
        self.npds_pusher = NpdsPusher(
            socket_path, ack_timeout=self.config.proxy_ack_timeout_s
        )
        cache = self.identity_allocator.get_identity_cache()
        for ep in self.endpoint_manager.get_endpoints():
            if ep.desired_l4_policy is not None:
                self.npds_pusher.upsert(ep, cache)
        # Recovery: endpoints that failed their ACK gate while the
        # service was down regenerate now that it is back (reference:
        # the endpoint regeneration controller retries after proxy
        # completion timeouts).
        for ep in self.endpoint_manager.get_endpoints():
            if ep.state == EndpointState.NOT_READY:
                ep.set_state(
                    EndpointState.WAITING_TO_REGENERATE,
                    "verdict service restored",
                )
                self.build_queue.enqueue(ep, key=ep.id)
        return self.npds_pusher

    def _push_endpoint_policy(self, ep: Endpoint) -> None:
        """Publish the endpoint's resolved policy to the distribution
        cache (reference: pkg/envoy/server.go:628 UpdateNetworkPolicy).
        The verdict-service NPDS push itself happens ACK-gated INSIDE
        regeneration (update_network_policy above) — by the time an
        endpoint reaches ready, the service has acknowledged."""
        if ep.desired_l4_policy is None:
            return
        resource = {
            "endpoint_id": ep.id,
            "policy_revision": ep.policy_revision,
            "ingress_enforced": ep.ingress_policy_enabled,
            "egress_enforced": ep.egress_policy_enabled,
            "redirects": dict(ep.realized_redirects),
        }
        self.dist_cache.upsert(
            TYPE_NETWORK_POLICY, str(ep.id), resource, force=False
        )

    def endpoint_create(
        self, endpoint_id: int, ipv4: str = "",
        labels: list[str] | None = None, container_name: str = "",
    ) -> Endpoint:
        """reference: daemon/endpoint.go createEndpoint."""
        if self.endpoint_manager.lookup(endpoint_id) is not None:
            raise ValueError(f"endpoint {endpoint_id} already exists")
        ep = Endpoint(
            endpoint_id, ipv4=ipv4, container_name=container_name,
            labels=Labels.from_model(labels or []), device=self.device,
        )
        ep.set_state(EndpointState.WAITING_FOR_IDENTITY, "created")
        identity, _ = self._allocate_identity(
            ep.labels if ep.labels else Labels.from_model(["reserved:init"])
        )
        ep.set_identity(identity)
        self.endpoint_manager.insert(ep)
        EndpointCount.set(len(self.endpoint_manager))
        if ipv4:
            self.ipcache.upsert(ipv4, identity.id)
            self._kvstore_publish(
                "ipcache upsert",
                lambda: self.ipcache_sync.upsert_to_kvstore(
                    self._local_pair(ipv4, identity.id)
                ),
            )
        ep.set_state(EndpointState.WAITING_TO_REGENERATE, "identity ready")
        self.build_queue.enqueue(ep, key=ep.id)
        return ep

    def endpoint_delete(self, endpoint_id: int) -> bool:
        """reference: daemon/endpoint.go deleteEndpoint."""
        ep = self.endpoint_manager.lookup(endpoint_id)
        if ep is None:
            return False
        ep.set_state(EndpointState.DISCONNECTING, "delete")
        self.proxy_manager.remove_endpoint_redirects(endpoint_id)
        if ep.ipv4:
            self.ipcache.delete(ep.ipv4)
            self._kvstore_publish(
                "ipcache delete",
                lambda: self.ipcache_sync.delete_from_kvstore(ep.ipv4),
            )
        if ep.security_identity is not None:
            self._kvstore_publish(
                "identity release",
                lambda: self.identity_allocator.release(
                    ep.security_identity
                ),
            )
        self.endpoint_manager.remove(ep)
        self.dist_cache.delete(TYPE_NETWORK_POLICY, str(endpoint_id))
        if self.npds_pusher is not None:
            try:
                self.npds_pusher.remove(ep)
            except OSError:
                log.warning("NPDS prune failed; verdict service unreachable")
        ep.set_state(EndpointState.DISCONNECTED, "deleted")
        EndpointCount.set(len(self.endpoint_manager))
        # remove persisted state
        ep_dir = os.path.join(self._state_dir(), str(endpoint_id))
        cfg = os.path.join(ep_dir, "ep_config.json")
        if os.path.isfile(cfg):
            os.unlink(cfg)
            try:
                os.rmdir(ep_dir)
            except OSError:
                pass
        return True

    def endpoint_update_labels(
        self, endpoint_id: int, labels: list[str]
    ) -> bool:
        """Replace an endpoint's identity labels: reallocate the
        identity, resync the ipcache, and regenerate (reference:
        pkg/endpoint UpdateLabels/replaceIdentityLabels — the workload
        watcher's correlation path lands here)."""
        ep = self.endpoint_manager.lookup(endpoint_id)
        if ep is None:
            return False
        new = Labels.from_model(labels)
        if ep.labels == new:
            return True
        old_identity = ep.security_identity
        identity, _ = self._allocate_identity(new)
        ep.labels = new
        ep.set_identity(identity)
        if old_identity is not None:
            self._kvstore_publish(
                "identity release",
                lambda: self.identity_allocator.release(old_identity),
            )
        if ep.ipv4:
            self.ipcache.upsert(ep.ipv4, identity.id)
            self._kvstore_publish(
                "ipcache upsert",
                lambda: self.ipcache_sync.upsert_to_kvstore(
                    self._local_pair(ep.ipv4, identity.id)
                ),
            )
        ep.force_policy_compute = True
        ep.set_state(EndpointState.WAITING_TO_REGENERATE, "labels changed")
        self.build_queue.enqueue(ep, key=ep.id)
        return True

    def endpoint_regenerate(self, endpoint_id: int) -> bool:
        ep = self.endpoint_manager.lookup(endpoint_id)
        if ep is None:
            return False
        ep.force_policy_compute = True
        ep.set_state(EndpointState.WAITING_TO_REGENERATE, "api request")
        self.build_queue.enqueue(ep, key=ep.id)
        return True

    def restore_endpoints(self) -> int:
        """reference: daemon restoreOldEndpoints + regenerateRestored."""
        restored = Endpoint.restore_from_dir(
            self._state_dir(), device=self.device
        )
        for ep in restored:
            if self.endpoint_manager.lookup(ep.id) is not None:
                continue
            self.endpoint_manager.insert(ep)
            if ep.security_identity is not None and ep.labels:
                # Re-allocate to re-register this node's reference.
                identity, _ = self._allocate_identity(
                    ep.security_identity.labels
                )
                ep.set_identity(identity)
            if ep.ipv4 and ep.security_identity is not None:
                self.ipcache.upsert(ep.ipv4, ep.security_identity.id)
            ep.set_state(EndpointState.WAITING_TO_REGENERATE, "restored")
            self.build_queue.enqueue(ep, key=ep.id)
        EndpointCount.set(len(self.endpoint_manager))
        return len(restored)

    def _state_dir(self) -> str:
        d = os.path.join(self.config.run_dir, self.config.state_dir)
        os.makedirs(d, exist_ok=True)
        return d

    # -- policy ------------------------------------------------------------

    def policy_add(self, rules: list[Rule]) -> int:
        """reference: daemon/policy.go:171 PolicyAdd."""
        for r in rules:
            try:
                r.sanitize()
            except Exception:
                PolicyImportErrors.inc()
                raise
        with self.policy.mutex:
            rev = self.policy.add_list(rules)
            prefixes = []
            for r in rules:
                prefixes.extend(r.get_cidr_prefixes())
        # Every policy CIDR prefix gets a local identity + ipcache entry
        # so the datapath can classify CIDR traffic (reference:
        # daemon/policy.go:201 ipcache.AllocateCIDRs).
        self._allocate_cidr_identities(prefixes)
        PolicyRevision.set(rev)
        PolicyCount.set(self.policy.num_rules())
        self.monitor.send_agent_notification(
            AGENT_NOTIFY_POLICY_UPDATED,
            f"policy updated to revision {rev} ({len(rules)} rules)",
            revision=rev,
        )
        self.trigger_policy_updates()
        return rev

    def _allocate_cidr_identities(self, prefixes: list[str]) -> None:
        """reference: pkg/ipcache AllocateCIDRs — allocate an identity
        carrying the cidr label per prefix and publish it to the ipcache."""
        from ..labels.cidr import ip_string_to_label

        for prefix in prefixes:
            lbl = ip_string_to_label(prefix)
            if lbl is None:
                continue
            lbls = Labels()
            lbls.upsert(lbl)
            ident, _ = self._allocate_identity(lbls)
            self._cidr_identities[prefix] = ident
            self.ipcache.upsert(prefix, ident.id)

    def _release_unused_cidr_identities(self) -> None:
        """Release CIDR identities no longer referenced by any rule
        (reference: daemon/policy.go removedPrefixes refcounting)."""
        live = set()
        for r in self.policy.rules:
            live.update(r.get_cidr_prefixes())
        for prefix in list(self._cidr_identities):
            if prefix not in live:
                ident = self._cidr_identities.pop(prefix)
                self.ipcache.delete(prefix)
                # Same degraded contract as endpoint releases: the
                # policy deletion already happened; a fenced store must
                # not abort it half-applied (the allocator's pending-
                # unref ledger retries the remote side via run_gc).
                self._kvstore_publish(
                    "cidr identity release",
                    lambda: self.identity_allocator.release(ident),
                )

    def policy_delete(self, labels: LabelArray) -> tuple[int, int]:
        """reference: daemon/policy.go PolicyDelete."""
        rev, deleted = self.policy.delete_by_labels(labels)
        if deleted:
            self._release_unused_cidr_identities()
            PolicyRevision.set(rev)
            PolicyCount.set(self.policy.num_rules())
            self.monitor.send_agent_notification(
                AGENT_NOTIFY_POLICY_UPDATED,
                f"policy revision {rev}: {deleted} rules deleted",
                revision=rev,
            )
            self.trigger_policy_updates()
        return rev, deleted

    def policy_get(self) -> str:
        return self.policy.get_json()

    def policy_trace(self, from_labels, to_labels, dports=None) -> tuple[str, str]:
        """reference: cilium policy trace / daemon trace API."""
        import io

        ctx = SearchContext(
            from_labels=from_labels, to_labels=to_labels, dports=dports or []
        )
        ctx.trace = Tracing.ENABLED
        ctx.logging = io.StringIO()
        verdict = self.policy.allows_ingress(ctx)
        return str(verdict), ctx.logging.getvalue()

    def trigger_policy_updates(self) -> None:
        self.policy_trigger.trigger()

    def _trigger_policy_updates_now(self) -> None:
        self.endpoint_manager.trigger_policy_updates(
            lambda ep: self.build_queue.enqueue(ep, key=ep.id)
        )

    # -- status ------------------------------------------------------------

    def _sync_metrics(self) -> None:
        EndpointCount.set(len(self.endpoint_manager))
        PolicyRevision.set(self.policy.get_revision())
        PolicyCount.set(self.policy.num_rules())

    def status(self) -> dict:
        """reference: daemon/status.go getStatus."""
        return {
            "cilium": {"state": "Ok", "uptime_s": round(
                time.time() - self._started, 1)},
            "kvstore": {
                "state": "Degraded" if self._kvstore_degraded else "Ok",
                "status": self.kvstore.status(),
                "degraded": self._kvstore_degraded,
                # Fencing epoch the client has observed (None for
                # local/file backends, which cannot fail over).
                "epoch": getattr(self.kvstore, "epoch", None),
                # Client-side failure counters (reference: kvstore
                # errors surfacing via controller failure counts).
                "counters": (
                    self.kvstore.counters.snapshot()
                    if hasattr(self.kvstore, "counters")
                    else {}
                ),
            },
            "node": self.node_name,
            "cluster": self.config.cluster_name,
            "policy": {
                "revision": self.policy.get_revision(),
                "rules": self.policy.num_rules(),
            },
            "endpoints": {
                "total": len(self.endpoint_manager),
                "by_state": self._endpoints_by_state(),
            },
            "identity": {
                "allocated": len(self.identity_allocator.get_identity_cache()),
            },
            "ipcache": {"entries": len(self.ipcache.dump())},
            "proxy": {
                "redirects": len(self.proxy_manager.redirects),
                "port_range": (
                    f"{self.config.proxy_port_min}-"
                    f"{self.config.proxy_port_max}"
                ),
            },
            "monitor": self.monitor.status(),
            "verdict_service": self._verdict_service_status(),
            "controllers": [
                {
                    "name": s.name,
                    "success": s.success_count,
                    "failure": s.failure_count,
                    "last_error": s.last_error,
                }
                for s in self.controllers.statuses()
            ],
        }

    def _verdict_service_status(self):
        """Counters from the attached verdict service (reference: the
        agent's Envoy admin scrape feeding `cilium status`)."""
        if self.npds_pusher is None:
            return None
        try:
            st = self.npds_pusher.client.status()
        except Exception:  # noqa: BLE001 — service may be down
            return {"state": "unreachable"}
        st["state"] = "Ok"
        st["npds_pushes"] = self.npds_pusher.pushes
        st["npds_nacks"] = self.npds_pusher.nacks
        return st

    def _endpoints_by_state(self) -> dict:
        out: dict[str, int] = {}
        for ep in self.endpoint_manager.get_endpoints():
            out[ep.state.value] = out.get(ep.state.value, 0) + 1
        return out

    def metrics_text(self) -> str:
        return metrics_registry.expose()

    # -- shutdown ----------------------------------------------------------

    def start_dns_poller(self, resolver, interval: float | None = None):
        """Start the ToFQDNs DNS poller with the given resolver
        (reference: fqdn.StartDNSPoller from daemon bootstrap)."""
        from ..fqdn import DnsPoller

        kwargs = {} if interval is None else {"interval": interval}
        self.dns_poller = DnsPoller(
            self.policy,
            resolver,
            on_change=self.trigger_policy_updates,
            controllers=self.controllers,
            **kwargs,
        ).start()
        return self.dns_poller

    def close(self) -> None:
        self.policy_trigger.shutdown()
        self.build_queue.stop()
        self.controllers.remove_all()
        self.ipcache_sync.stop()
        self.node_discovery.close()
        self.identity_allocator.close()
        if self.health_responder is not None:
            self.health_responder.close()
        if self.npds_pusher is not None:
            self.npds_pusher.close()
        if self.pprof_server is not None:
            self.pprof_server.shutdown()
            self.pprof_server.server_close()  # release the listening fd
        self.kvstore.close()


def _accesslog_event(rec):
    from ..monitor.monitor import MSG_TYPE_ACCESS_LOG, MonitorEvent

    proto = (
        "http" if rec.http else "kafka" if rec.kafka
        else (rec.l7.proto if rec.l7 else "?")
    )
    info = ""
    if rec.http:
        info = f"{rec.http.method} {rec.http.url} -> {rec.http.code}"
    elif rec.kafka:
        info = f"{rec.kafka.api_key} topics={rec.kafka.topics}"
    elif rec.l7:
        info = str(rec.l7.fields)
    return MonitorEvent(
        MSG_TYPE_ACCESS_LOG,
        {"verdict": rec.verdict, "l7_protocol": proto, "info": info},
    )
