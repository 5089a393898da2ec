"""Policy distribution: versioned resource cache with ACK-tracked pushes.

reference: pkg/envoy/xds — the agent embeds an xDS-protocol server over a
unix socket pushing NPDS (per-endpoint NetworkPolicy) and NPHDS
(IP->identity) resources to proxies; a versioned Cache (xds/cache.go:34)
holds the latest resources, subscription streams deliver updates, and an
ACK-tracking mutator (xds/ack.go:86) completes Completions only when every
targeted proxy has acknowledged the version — policy application blocks on
this (pkg/endpoint/bpf.go:555).

Here the proxies are the in-process batch engines and the native
runtime shim; streams are in-process queues, with a unix-socket JSON
framing for out-of-process subscribers (``distribution/sock.py``).
"""

from .cache import Cache, VersionedResources
from .ack import AckingMutator
from .server import DistributionServer, Subscription

# Cilium resource type URLs (reference: pkg/envoy/server.go typeURLs).
TYPE_NETWORK_POLICY = "type.googleapis.com/cilium.NetworkPolicy"
TYPE_NETWORK_POLICY_HOSTS = "type.googleapis.com/cilium.NetworkPolicyHosts"

__all__ = [
    "AckingMutator",
    "Cache",
    "DistributionServer",
    "Subscription",
    "TYPE_NETWORK_POLICY",
    "TYPE_NETWORK_POLICY_HOSTS",
    "VersionedResources",
]
