"""L7 proxy redirect management.

reference: pkg/proxy/proxy.go:59-236 — allocates proxy ports from the
configured range, tracks Redirect lifecycles keyed by proxy ID, and
dispatches by parser type.  In the reference, HTTP and proxylib protocols
go to Envoy and Kafka to the in-agent Go proxy; here every parser type maps
to a batch engine registered for that L7 protocol
(cilium_tpu_torch.runtime), all sharing the card's verdict path.
"""

from .manager import ProxyManager, Redirect

__all__ = ["ProxyManager", "Redirect"]
