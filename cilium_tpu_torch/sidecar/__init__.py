"""Sidecar verdict-service seam — the native ingestion boundary.

The reference's L7 hot path crosses a process/language seam between the
Envoy datapath and the verdict library: ``GoFilter::Instance::OnIO``
(reference: envoy/cilium_proxylib.cc:125-214) calls the cgo exports in
``proxylib/libcilium.h`` and applies the returned ``FilterOp`` list
(PASS/DROP/INJECT/MORE, max 16 ops per call) to its byte buffers.

This package, a copy of ``cilium_tpu/sidecar`` whose ``service`` runs the
port's engines on the CUDA card, is the equivalent of that seam:

- ``wire``     — a columnar binary protocol for per-connection byte batches
                 and FilterOp verdict batches over a unix socket (the ABI
                 analog of libcilium.h, shaped for numpy/device dispatch)
- ``dispatch`` — the adaptive fill-vs-deadline batch dispatcher (consumes
                 ``batch_timeout_ms``; bounds added latency while filling
                 device batches)
- ``service``  — the verdict service: module/policy registry + batched
                 device models behind the wire protocol
- ``client``   — a Python datapath shim (per-connection buffering, the
                 OnIO byte-accounting contract) used by tests and benches
- ``trace``    — verdict-path latency decomposition: per-round stage
                 histograms, sampled spans, slow-verdict exemplars
- ``shm``      — lock-free SPSC shared-memory rings (the zero-copy data
                 fast path between shim and service)
- ``transport``— the transport seam: socket control channel + shm data
                 rung, fallback reasons, per-session telemetry

The native C++ shim implementing the same client contract lives in
``native/`` (built to ``libcilium_tpu_shim.so``).
"""

from .client import ShimConnection, SidecarClient, SidecarUnavailable
from .dispatch import BatchDispatcher
from .guard import DeviceGuard, DeviceStall
from .service import VerdictService
from .shm import RingError, ShmRing, TornSlot
from .trace import RoundTrace, VerdictTracer
from .transport import TRANSPORT_SHM, TRANSPORT_SOCKET, ShmPeer, ShmSession

__all__ = [
    "BatchDispatcher",
    "DeviceGuard",
    "DeviceStall",
    "RingError",
    "RoundTrace",
    "ShimConnection",
    "ShmPeer",
    "ShmRing",
    "ShmSession",
    "SidecarClient",
    "SidecarUnavailable",
    "TornSlot",
    "TRANSPORT_SHM",
    "TRANSPORT_SOCKET",
    "VerdictService",
    "VerdictTracer",
]
