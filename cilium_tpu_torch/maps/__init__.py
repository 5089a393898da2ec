"""Typed datapath maps — the array-native equivalent of pkg/maps/*.

Counterpart of ``cilium_tpu/maps``: each map keeps an authoritative
host-side table (copied from the reference) plus a ``to_device()`` export
packing entries into tensors for batched lookups on the card
(``cilium_tpu_torch.ops.maplookup`` / ``lpm``).  ``ProxyMap`` is host-only:
the native shim reads its ``save()`` snapshot.
"""

from .policymap import (
    DIR_EGRESS,
    DIR_INGRESS,
    DevicePolicyMap,
    PolicyEntry,
    PolicyKey,
    PolicyMap,
    policy_can_access_batch,
)
from .ctmap import CtEntry, CtKey4, CtMap, TCP_CLOSING_LIFETIME, CT_DEFAULT_LIFETIME
from .lbmap import (
    DeviceLbMap,
    LbBackend,
    LbMap,
    lb4_select_backend_batch,
)
from .ipcache import IpcacheMap
from .lxcmap import EndpointInfo, LxcMap
from .metricsmap import MetricsMap
from .proxymap import ProxyMap

__all__ = [
    "CT_DEFAULT_LIFETIME",
    "CtEntry",
    "CtKey4",
    "CtMap",
    "DIR_EGRESS",
    "DIR_INGRESS",
    "DeviceLbMap",
    "DevicePolicyMap",
    "EndpointInfo",
    "IpcacheMap",
    "LbBackend",
    "LbMap",
    "LxcMap",
    "MetricsMap",
    "PolicyEntry",
    "PolicyKey",
    "PolicyMap",
    "ProxyMap",
    "TCP_CLOSING_LIFETIME",
    "lb4_select_backend_batch",
    "policy_can_access_batch",
]
