"""Kubernetes integration: NetworkPolicy/CNP translation, watch loop,
IPAM, and the CNI command surface.

reference: pkg/k8s (translation), daemon/k8s_watcher.go (informers ->
PolicyAdd/Delete), pkg/ipam + plugins/cilium-cni (pod plumbing).  The
apiserver client is replaced by a fake in-process apiserver fixture
(k8s/apiserver.py) with the same list+watch contract, so the watcher
logic is identical whether events come from a test or a real stream.
"""

from .apiserver import FakeApiServer, WatchEvent
from .cni import CniPlugin
from .cnp import parse_cnp
from .ipam import IpamAllocator
from .network_policy import parse_network_policy
from .rule_translate import translate_to_services
from .watcher import K8sWatcher

__all__ = [
    "CniPlugin",
    "FakeApiServer",
    "IpamAllocator",
    "K8sWatcher",
    "WatchEvent",
    "parse_cnp",
    "parse_network_policy",
    "translate_to_services",
]
