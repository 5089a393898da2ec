"""The Endpoint object and its regeneration pipeline.

reference: pkg/endpoint/{endpoint,policy,bpf,restore}.go.  See package
docstring for the mapping onto the array-native datapath.

A copy of ``cilium_tpu/endpoint/endpoint.py``; the policy map is exported
to ``Endpoint.device`` (the card unless "cpu" is asked for).
"""

from __future__ import annotations

import enum
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Optional, Protocol

from ..device import resolve_device
from ..identity import (
    Identity,
    RESERVED_HOST,
    RESERVED_WORLD,
)
from ..labels import Labels
from ..maps.policymap import (
    DIR_EGRESS,
    DIR_INGRESS,
    DevicePolicyMap,
    PolicyKey,
    PolicyMap,
)
from ..policy import (
    ALWAYS_ENFORCE,
    Decision,
    L4Filter,
    L4Policy,
    NEVER_ENFORCE,
    Repository,
    SearchContext,
    get_policy_enabled,
    proxy_id as make_proxy_id,
)
from ..policy.l3 import CIDRPolicy
from ..utils.logging import get_logger
from ..utils.metrics import (
    EndpointRegenerationCount,
    EndpointRegenerationTime,
)
from ..utils import option
from ..utils.option import OptionMap
from ..utils.spanstat import SpanStats

log = get_logger("endpoint")

# Keys always consulted for localhost/world legacy allows
# (reference: pkg/endpoint/policy.go localHostKey/worldKey).
LOCALHOST_KEY = PolicyKey(RESERVED_HOST, 0, 0, DIR_INGRESS)
WORLD_KEY = PolicyKey(RESERVED_WORLD, 0, 0, DIR_INGRESS)


class EndpointState(str, enum.Enum):
    """reference: pkg/endpoint/endpoint.go state strings."""

    CREATING = "creating"
    WAITING_FOR_IDENTITY = "waiting-for-identity"
    READY = "ready"
    WAITING_TO_REGENERATE = "waiting-to-regenerate"
    REGENERATING = "regenerating"
    RESTORING = "restoring"
    DISCONNECTING = "disconnecting"
    DISCONNECTED = "disconnected"
    NOT_READY = "not-ready"


# Allowed transitions (reference: endpoint.go SetStateLocked switch).
_TRANSITIONS: dict[EndpointState, set[EndpointState]] = {
    EndpointState.CREATING: {
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.DISCONNECTING,
    },
    EndpointState.WAITING_FOR_IDENTITY: {
        EndpointState.READY,
        EndpointState.WAITING_TO_REGENERATE,
        EndpointState.DISCONNECTING,
    },
    EndpointState.READY: {
        EndpointState.WAITING_TO_REGENERATE,
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.DISCONNECTING,
        EndpointState.NOT_READY,
    },
    EndpointState.WAITING_TO_REGENERATE: {
        EndpointState.REGENERATING,
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.DISCONNECTING,
    },
    EndpointState.REGENERATING: {
        EndpointState.READY,
        EndpointState.NOT_READY,
        EndpointState.WAITING_TO_REGENERATE,
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.DISCONNECTING,
    },
    EndpointState.RESTORING: {
        EndpointState.WAITING_TO_REGENERATE,
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.DISCONNECTING,
    },
    EndpointState.NOT_READY: {
        EndpointState.WAITING_TO_REGENERATE,
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.DISCONNECTING,
    },
    EndpointState.DISCONNECTING: {EndpointState.DISCONNECTED},
    EndpointState.DISCONNECTED: set(),
}


@dataclass
class PolicyMapStateEntry:
    """reference: pkg/endpoint/policy.go PolicyMapStateEntry."""

    proxy_port: int = 0


class EndpointOwner(Protocol):
    """What an endpoint needs from its daemon
    (reference: pkg/endpoint Owner interface)."""

    def get_policy_repository(self) -> Repository: ...

    def get_identity_cache(self) -> dict[int, "Labels"]: ...

    def get_proxy_manager(self): ...

    def update_network_policy(self, ep: "Endpoint") -> bool:
        """Push the endpoint's resolved policy to the proxy layer and
        block until it is acknowledged; False fails the regeneration
        (reference: pkg/endpoint/policy.go:402 updateNetworkPolicy →
        envoy server push, ACK-gated via completion.WaitGroup at
        pkg/endpoint/bpf.go:555)."""
        ...


class Endpoint:
    """reference: pkg/endpoint/endpoint.go Endpoint."""

    def __init__(
        self,
        endpoint_id: int,
        ipv4: str = "",
        ipv6: str = "",
        container_name: str = "",
        labels: Optional[Labels] = None,
        device=None,
    ) -> None:
        # where the policy map is exported: None is the CUDA card (raises
        # without one), "cpu" the plain versions' tables
        self.device = resolve_device(device)
        self.id = endpoint_id
        self.ipv4 = ipv4
        self.ipv6 = ipv6
        self.container_name = container_name
        self.labels = labels or Labels()
        self.security_identity: Optional[Identity] = None
        self.state = EndpointState.CREATING
        self.mutex = threading.RLock()

        # Policy state
        self.policy_map = PolicyMap(endpoint_id)
        self.device_policy_map: Optional[DevicePolicyMap] = None
        self.desired_l4_policy: Optional[L4Policy] = None
        self.l3_policy: Optional[CIDRPolicy] = None
        self.desired_map_state: dict[PolicyKey, PolicyMapStateEntry] = {}
        self.realized_map_state: dict[PolicyKey, PolicyMapStateEntry] = {}
        self.realized_redirects: dict[str, int] = {}  # proxyID -> port
        self.policy_revision = 0
        self.next_policy_revision = 0
        self.force_policy_compute = False
        self.ingress_policy_enabled = False
        self.egress_policy_enabled = False
        self._stale_redirects: list[str] = []
        self._prev_identity_cache: Optional[dict[int, object]] = None

        # Per-endpoint option overlay (reference: pkg/option/endpoint.go).
        self.opts = OptionMap(parent=option.config.opts)
        self.stats = SpanStats()

    # -- state machine -----------------------------------------------------

    def set_state(self, new: EndpointState, reason: str = "") -> bool:
        """Validated transition; False if not allowed
        (reference: endpoint.go SetStateLocked)."""
        with self.mutex:
            if new == self.state:
                return False
            if new not in _TRANSITIONS.get(self.state, set()):
                log.with_fields(
                    endpointID=self.id, frm=self.state.value, to=new.value
                ).debug("invalid state transition")
                return False
            self.state = new
        if reason:
            log.with_fields(endpointID=self.id, state=new.value,
                            reason=reason).debug("state transition")
        return True

    def is_disconnecting(self) -> bool:
        return self.state in (
            EndpointState.DISCONNECTING, EndpointState.DISCONNECTED
        )

    # -- identity ----------------------------------------------------------

    def set_identity(self, identity: Identity) -> None:
        with self.mutex:
            self.security_identity = identity

    def security_label_array(self):
        return self.security_identity.labels.to_array()

    # -- policy computation (reference: policy.go:482 regeneratePolicy) ----

    def compute_policy_enforcement(self, repo: Repository) -> tuple[bool, bool]:
        """Whether ingress/egress policy applies (reference:
        pkg/endpoint/policy.go ComputePolicyEnforcement): default mode
        enforces a direction iff some rule selects the endpoint there."""
        mode = get_policy_enabled()
        if mode == NEVER_ENFORCE:
            return False, False
        if mode == ALWAYS_ENFORCE:
            return True, True
        return repo.get_rules_matching(self.security_label_array())

    def _convert_l4_filter_to_keys(
        self, f: L4Filter, direction: int, identity_cache: dict
    ) -> list[PolicyKey]:
        """reference: policy.go:111 convertL4FilterToPolicyMapKeys."""
        keys = []
        for sel in f.endpoints:
            for numeric_id, lbls in identity_cache.items():
                if sel.is_wildcard() or sel.matches(lbls.to_array()):
                    keys.append(
                        PolicyKey(numeric_id, f.port, f.u8_proto, direction)
                    )
        return keys

    def _lookup_redirect_port(self, f: L4Filter) -> int:
        """reference: policy.go:134 lookupRedirectPort."""
        if not f.is_redirect():
            return 0
        return self.realized_redirects.get(self.proxy_id(f), 0)

    def proxy_id(self, f: L4Filter) -> str:
        return make_proxy_id(self.id, f.ingress, f.protocol, f.port)

    def _compute_desired_l4_entries(self, desired, identity_cache) -> None:
        """reference: policy.go:144 computeDesiredL4PolicyMapEntries."""
        if self.desired_l4_policy is None:
            return
        for l4map, direction in (
            (self.desired_l4_policy.ingress, DIR_INGRESS),
            (self.desired_l4_policy.egress, DIR_EGRESS),
        ):
            for f in l4map.values():
                proxy_port = 0
                if f.is_redirect():
                    proxy_port = self._lookup_redirect_port(f)
                    if proxy_port == 0:
                        # New redirect without an allocated port yet —
                        # added once the port exists (policy.go:160-166).
                        continue
                for key in self._convert_l4_filter_to_keys(
                    f, direction, identity_cache
                ):
                    desired[key] = PolicyMapStateEntry(proxy_port=proxy_port)

    def _determine_allow_localhost(self, desired) -> None:
        """reference: policy.go:262 determineAllowLocalhost."""
        if option.config.always_allow_localhost() or (
            self.desired_l4_policy is not None
            and self.desired_l4_policy.has_redirect()
        ):
            desired[LOCALHOST_KEY] = PolicyMapStateEntry()

    def _determine_allow_world(self, desired) -> None:
        """reference: policy.go:281 determineAllowFromWorld (legacy)."""
        if option.config.host_allows_world and LOCALHOST_KEY in desired:
            desired[WORLD_KEY] = PolicyMapStateEntry()

    def _compute_desired_l3_entries(self, repo, desired, identity_cache) -> None:
        """Per-identity L3 verdict walk (reference: policy.go:297)."""
        my_labels = self.security_label_array()
        for numeric_id, lbls in identity_cache.items():
            remote = lbls.to_array()
            if self.ingress_policy_enabled:
                ctx = SearchContext(from_labels=remote, to_labels=my_labels)
                allowed = (
                    repo.allows_ingress(ctx) == Decision.ALLOWED
                    if repo.num_rules()
                    else False
                )
            else:
                allowed = True
            if allowed:
                desired[PolicyKey(numeric_id, 0, 0, DIR_INGRESS)] = (
                    PolicyMapStateEntry()
                )
            if self.egress_policy_enabled:
                ctx = SearchContext(from_labels=my_labels, to_labels=remote)
                allowed = (
                    repo.allows_egress(ctx) == Decision.ALLOWED
                    if repo.num_rules()
                    else False
                )
            else:
                allowed = True
            if allowed:
                desired[PolicyKey(numeric_id, 0, 0, DIR_EGRESS)] = (
                    PolicyMapStateEntry()
                )

    def regenerate_policy(self, owner: EndpointOwner) -> bool:
        """Recompute desired policy; returns whether anything may have
        changed (reference: policy.go:482 regeneratePolicy)."""
        if self.security_identity is None:
            log.with_field("endpointID", self.id).warning(
                "endpoint lacks identity, skipping policy calculation"
            )
            return False

        identity_cache = owner.get_identity_cache()
        repo = owner.get_policy_repository()
        revision = repo.get_revision()

        # Skip if already computed for this revision with the same cache
        # (reference: policy.go:513-525).
        if (
            not self.force_policy_compute
            and self.next_policy_revision >= revision
            and self._prev_identity_cache == identity_cache
        ):
            return False
        self._prev_identity_cache = identity_cache

        self.ingress_policy_enabled, self.egress_policy_enabled = (
            self.compute_policy_enforcement(repo)
        )

        ingress_ctx = SearchContext(to_labels=self.security_label_array())
        egress_ctx = SearchContext(from_labels=self.security_label_array())

        new_l4 = L4Policy(revision=revision)
        if self.ingress_policy_enabled:
            new_l4.ingress = repo.resolve_l4_ingress_policy(ingress_ctx)
        if self.egress_policy_enabled:
            new_l4.egress = repo.resolve_l4_egress_policy(egress_ctx)
        self.desired_l4_policy = new_l4

        l3 = repo.resolve_cidr_policy(
            SearchContext(to_labels=self.security_label_array())
        )
        l3.validate()
        self.l3_policy = l3

        desired: dict[PolicyKey, PolicyMapStateEntry] = {}
        self._compute_desired_l4_entries(desired, identity_cache)
        self._determine_allow_localhost(desired)
        self._determine_allow_world(desired)
        self._compute_desired_l3_entries(repo, desired, identity_cache)
        self.desired_map_state = desired

        self.force_policy_compute = False
        self.next_policy_revision = revision
        return True

    # -- datapath sync (reference: bpf.go regenerateBPF/syncPolicyMap) -----

    def _add_new_redirects(self, owner: EndpointOwner, identity_cache) -> None:
        """Create redirects for redirect filters and patch their proxy
        ports into the desired state (reference: bpf.go:356
        addNewRedirects + addNewRedirectsFromMap)."""
        proxy = owner.get_proxy_manager()
        if proxy is None or self.desired_l4_policy is None:
            return
        active: set[str] = set()
        for l4map, direction in (
            (self.desired_l4_policy.ingress, DIR_INGRESS),
            (self.desired_l4_policy.egress, DIR_EGRESS),
        ):
            for f in l4map.values():
                if not f.is_redirect():
                    continue
                pid = self.proxy_id(f)
                redirect = proxy.create_or_update_redirect(f, pid, self.id)
                self.realized_redirects[pid] = redirect.proxy_port
                active.add(pid)
                for key in self._convert_l4_filter_to_keys(
                    f, direction, identity_cache
                ):
                    self.desired_map_state[key] = PolicyMapStateEntry(
                        proxy_port=redirect.proxy_port
                    )
        # Stale-redirect removal is DEFERRED to after the proxy-ACK
        # gate (reference: removeOldRedirects runs in the finalize
        # stage, bpf.go:446): tearing a redirect down before the ACK
        # would leave a reverted map pointing at a dead proxy port.
        self._stale_redirects = [
            pid for pid in self.realized_redirects if pid not in active
        ]

    def _remove_old_redirects(self, owner: EndpointOwner) -> None:
        """Finalize stage: drop redirects the new (ACKed) policy no
        longer references (reference: bpf.go removeOldRedirects)."""
        proxy = owner.get_proxy_manager()
        for pid in getattr(self, "_stale_redirects", ()):  # set by add
            if proxy is not None:
                proxy.remove_redirect(pid)
            self.realized_redirects.pop(pid, None)
        self._stale_redirects = []

    def sync_policy_map(self) -> tuple[int, int]:
        """Diff desired vs realized into the policy map; returns
        (added, deleted) (reference: bpf.go syncPolicyMap +
        pkg/maps/policymap Allow/DeleteKey)."""
        added = deleted = 0
        for key, entry in self.desired_map_state.items():
            realized = self.realized_map_state.get(key)
            if realized is None or realized.proxy_port != entry.proxy_port:
                self.policy_map.allow(
                    key.identity, key.dest_port, key.proto, key.direction,
                    proxy_port=entry.proxy_port,
                )
                added += 1
        for key in list(self.realized_map_state):
            if key not in self.desired_map_state:
                self.policy_map.delete(
                    key.identity, key.dest_port, key.proto, key.direction
                )
                deleted += 1
        self.realized_map_state = {
            k: PolicyMapStateEntry(v.proxy_port)
            for k, v in self.desired_map_state.items()
        }
        return added, deleted

    def regenerate(self, owner: EndpointOwner, reason: str = "") -> bool:
        """Full regeneration (reference: policy.go:812 Regenerate +
        :642 regenerate): policy recompute -> redirects -> map sync ->
        device export."""
        if self.security_identity is None:
            # No identity yet: policy cannot be computed; stay in the
            # identity wait (reference: regeneratePolicy identity gate).
            return False
        # READY/NOT_READY endpoints pass through WAITING_TO_REGENERATE
        # first (reference: the build queue sets waiting-to-regenerate on
        # enqueue, regenerating on pickup).
        if self.state not in (
            EndpointState.WAITING_TO_REGENERATE, EndpointState.REGENERATING
        ):
            self.set_state(EndpointState.WAITING_TO_REGENERATE, reason)
        if not self.set_state(EndpointState.REGENERATING, reason):
            # Disconnecting/disconnected endpoints must not regenerate:
            # doing so would recreate redirects torn down by the daemon.
            return False
        # Fresh spans per regeneration so the histogram observes this
        # run's duration, not the endpoint's lifetime accumulation.
        self.stats = SpanStats()
        stats = self.stats
        ok = False
        # Revert checkpoint (reference: pkg/revert stack built through
        # regenerateBPF, bpf.go:561-584): enough state to roll the
        # datapath back if the proxy layer never ACKs the new policy.
        prev_desired = dict(self.desired_map_state)
        prev_revision = self.policy_revision
        try:
            stats.span("policy").start()
            self.regenerate_policy(owner)
            stats.span("policy").end()

            identity_cache = owner.get_identity_cache()
            stats.span("proxy").start()
            self._add_new_redirects(owner, identity_cache)
            stats.span("proxy").end()

            stats.span("mapSync").start()
            self.sync_policy_map()
            stats.span("mapSync").end()

            # Proxy ACK gate: regeneration blocks until the verdict
            # service acknowledges the pushed policy; no ACK -> the
            # endpoint must NOT report ready with a datapath enforcing a
            # policy the L7 layer never received (reference:
            # pkg/endpoint/bpf.go:555 completion wait on the xDS ACK,
            # pkg/envoy/xds/ack.go:138).
            stats.span("proxyAck").start()
            acked = owner.update_network_policy(self)
            stats.span("proxyAck").end()
            if not acked:
                # Revert the map to its pre-regeneration state
                # (reference: revert stack unwind, bpf.go:561-584).
                # Old redirects were NOT torn down yet (deferred to the
                # finalize stage below), so the restored entries still
                # point at live proxy ports.
                self.desired_map_state = prev_desired
                self.sync_policy_map()
                if not option.config.dry_mode:
                    self.device_policy_map = self.policy_map.to_device(device=self.device)
                self.policy_revision = prev_revision
                # The retry must recompute policy from scratch — the
                # skip check in regenerate_policy would otherwise see
                # next_policy_revision already current and promote the
                # reverted OLD map as the NEW revision.
                self.force_policy_compute = True
                return False

            # Finalize: now that the proxy ACKed, tear down redirects
            # the new policy no longer references.
            self._remove_old_redirects(owner)

            # "Compile": pack the policy map into device arrays (the BPF
            # compile+attach analog, skipped in DryMode like the
            # reference's bpf.go:510).
            if not option.config.dry_mode:
                stats.span("deviceExport").start()
                self.device_policy_map = self.policy_map.to_device(device=self.device)
                stats.span("deviceExport").end()

            self.policy_revision = self.next_policy_revision
            ok = True
        finally:
            outcome = "success" if ok else "fail"
            EndpointRegenerationCount.inc(outcome)
            EndpointRegenerationTime.observe(
                sum(stats.report().values())
            )
            self.set_state(
                EndpointState.READY if ok else EndpointState.NOT_READY,
                "regeneration " + outcome,
            )
        return ok

    # -- serialization / restore (reference: restore.go) -------------------

    def to_serialized(self) -> dict:
        return {
            "id": self.id,
            "ipv4": self.ipv4,
            "ipv6": self.ipv6,
            "container_name": self.container_name,
            "labels": self.labels.get_model(),
            "identity": (
                self.security_identity.id if self.security_identity else 0
            ),
            "identity_labels": (
                self.security_identity.labels.get_model()
                if self.security_identity
                else []
            ),
            "policy_revision": self.policy_revision,
            "state": self.state.value,
            "options": self.opts.snapshot(),
        }

    def write_state(self, state_dir: str) -> str:
        """Persist to <state_dir>/<id>/ep_config.json (the header-file
        analog, reference: pkg/endpoint/bpf.go:88 writeHeaderfile)."""
        ep_dir = os.path.join(state_dir, str(self.id))
        os.makedirs(ep_dir, exist_ok=True)
        path = os.path.join(ep_dir, "ep_config.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_serialized(), f, indent=2)
        os.replace(tmp, path)
        return path

    @staticmethod
    def from_serialized(data: dict, device=None) -> "Endpoint":
        ep = Endpoint(
            endpoint_id=data["id"],
            ipv4=data.get("ipv4", ""),
            ipv6=data.get("ipv6", ""),
            container_name=data.get("container_name", ""),
            labels=Labels.from_model(data.get("labels", [])),
            device=device,
        )
        if data.get("identity"):
            ep.security_identity = Identity(
                id=data["identity"],
                labels=Labels.from_model(data.get("identity_labels", [])),
            )
        ep.policy_revision = data.get("policy_revision", 0)
        ep.state = EndpointState.RESTORING
        return ep

    @staticmethod
    def restore_from_dir(state_dir: str, device=None) -> list["Endpoint"]:
        """reference: restore.go + daemon restoreOldEndpoints."""
        out: list[Endpoint] = []
        if not os.path.isdir(state_dir):
            return out
        for name in sorted(os.listdir(state_dir)):
            path = os.path.join(state_dir, name, "ep_config.json")
            if not os.path.isfile(path):
                continue
            try:
                with open(path) as f:
                    out.append(Endpoint.from_serialized(json.load(f), device))
            except (ValueError, KeyError) as e:
                log.with_fields(path=path, error=str(e)).warning(
                    "skipping corrupt endpoint state"
                )
        return out
