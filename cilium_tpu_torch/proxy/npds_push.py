"""NPDS policy translation + push to the verdict service.

reference: pkg/envoy/server.go:607 getNetworkPolicy (an endpoint's
resolved L4Policy rendered as a ``cilium.NetworkPolicy``) and :628
UpdateNetworkPolicy (the versioned push to subscribed proxies).  Here
the proxy is the port's verdict service: the daemon translates every
endpoint's resolved policy into the proxylib ``NetworkPolicy`` shape
and ships the FULL set over the sidecar wire on every change —
``Instance.policy_update`` swaps the whole policy map atomically, the
same full-state semantics as the reference's NPDS versioned cache.

Kafka filters are deliberately NOT translated: the reference serves
Kafka from the standalone Go proxy, not Envoy/NPDS (pkg/proxy/
proxy.go:229-236 dispatch), and this build mirrors that split — the
in-process Kafka batch engine owns those rules.
"""

from __future__ import annotations

import logging
import threading

from ..models.builder import expand_selector_remotes
from ..policy.l4 import PARSER_TYPE_HTTP, PARSER_TYPE_KAFKA, PARSER_TYPE_NONE
from ..proxylib.npds import (
    NetworkPolicy,
    PortNetworkPolicy,
    PortNetworkPolicyRule,
)

log = logging.getLogger(__name__)


def endpoint_policy_name(ep) -> str:
    """The reference keys NPDS policies by endpoint IP (server.go:607);
    endpoints without one fall back to their id."""
    return ep.ipv4 or f"ep-{ep.id}"


def network_policy_for_endpoint(ep, identity_cache: dict) -> NetworkPolicy:
    """Render one endpoint's resolved ingress policy as the NPDS shape,
    expanding selectors against the identity cache exactly like the
    device-model builder (models/builder.py)."""
    port_policies: list[PortNetworkPolicy] = []
    l4 = ep.desired_l4_policy
    ingress_map = l4.ingress if l4 is not None else {}
    for f in ingress_map.values():
        if f.l7_parser == PARSER_TYPE_KAFKA:
            continue  # served by the in-process Kafka engine (see above)
        rules: list[PortNetworkPolicyRule] = []
        for sel, l7 in f.l7_rules_per_ep.items():
            remotes = expand_selector_remotes(sel, identity_cache)
            if remotes is not None and not remotes:
                # Selector currently matches NO identity: fail closed.
                continue
            rule = PortNetworkPolicyRule(
                remote_policies=sorted(remotes) if remotes else []
            )
            if f.l7_parser == PARSER_TYPE_HTTP:
                rule.http_rules = [
                    {
                        "method": h.method, "path": h.path, "host": h.host,
                        "headers": list(h.headers),
                    }
                    for h in l7.http
                ]
            elif f.l7_parser != PARSER_TYPE_NONE:
                rule.l7_proto = l7.l7proto or f.l7_parser
                rule.l7_rules = [dict(r) for r in l7.l7]
            rules.append(rule)
        port_policies.append(
            PortNetworkPolicy(
                port=int(f.port), protocol=f.protocol or "TCP", rules=rules
            )
        )
    return NetworkPolicy(
        name=endpoint_policy_name(ep),
        policy=ep.security_identity.id if ep.security_identity else 0,
        ingress_per_port_policies=port_policies,
    )


class NpdsPusher:
    """Keeps a verdict service's policy map in sync with the daemon's
    endpoint policies (reference: XDSServer.UpdateNetworkPolicy)."""

    def __init__(self, socket_path: str, ack_timeout: float = 5.0):
        from ..sidecar.client import SidecarClient

        # The client timeout IS the ACK deadline: policy_update blocks
        # until the service replies MSG_ACK or the deadline passes
        # (reference: completion deadline, pkg/endpoint/bpf.go:555).
        self.client = SidecarClient(socket_path, timeout=ack_timeout)
        self.module = self.client.open_module([])
        if self.module == 0:
            raise ConnectionError(f"verdict service at {socket_path}")
        self._policies: dict[str, NetworkPolicy] = {}
        # Serializes map mutation + full-state send: endpoint builds run
        # on several worker threads, and interleaved snapshot/send pairs
        # could deliver a stale final state to the service.
        self._mutex = threading.Lock()
        self.pushes = 0
        self.nacks = 0

    def upsert(self, ep, identity_cache: dict) -> bool:
        with self._mutex:
            self._policies[endpoint_policy_name(ep)] = (
                network_policy_for_endpoint(ep, identity_cache)
            )
            return self._push_locked()

    def remove(self, ep) -> bool:
        with self._mutex:
            if self._policies.pop(endpoint_policy_name(ep), None) is None:
                return True
            return self._push_locked()

    def _push_locked(self) -> bool:
        """Full-state push; NACK leaves the service's active map
        untouched (reference: xds/ack.go NACK handling)."""
        from ..proxylib.types import FilterResult

        res = self.client.policy_update(
            self.module, list(self._policies.values())
        )
        self.pushes += 1
        if res != int(FilterResult.OK):
            self.nacks += 1
            log.warning("NPDS push NACKed: %s", res)
            return False
        return True

    def close(self) -> None:
        self.client.close()
