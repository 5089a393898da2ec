"""Datapath management: the array-native stand-in for BPF program loading.

Counterpart of ``cilium_tpu/datapath``: the composed egress passes
(``pipeline``, ``pipeline6``; kernel K14), the node-ingress programs
(``ingress``; K15), the XDP prefilter (``prefilter``; K12) and the
verdict accounting (``notify``), all over tables packed from the host
maps in ``cilium_tpu_torch.maps``.
"""

from .prefilter import PreFilter

__all__ = ["PreFilter"]
