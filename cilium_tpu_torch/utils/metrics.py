"""Metrics registry with Prometheus text exposition.

reference: pkg/metrics/metrics.go:51-430 — counters/gauges/histograms for
endpoint counts, regeneration times, policy revision, drop/forward counts,
proxy redirects; exported in Prometheus text format.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Iterable

NAMESPACE = "cilium_tpu"


def _fmt_labels(label_names, label_values) -> str:
    if not label_names:
        return ""
    inner = ",".join(
        f'{k}="{v}"' for k, v in zip(label_names, label_values)
    )
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str, label_names: tuple = ()) -> None:
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple, float] = {}
        self._mutex = threading.Lock()

    def inc(self, *label_values, amount: float = 1.0) -> None:
        with self._mutex:
            self._values[label_values] = self._values.get(label_values, 0.0) + amount

    def get(self, *label_values) -> float:
        return self._values.get(label_values, 0.0)

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        if not self._values and not self.label_names:
            yield f"{self.name} 0"
        for lv, v in sorted(self._values.items()):
            yield f"{self.name}{_fmt_labels(self.label_names, lv)} {v:g}"


class Gauge:
    def __init__(self, name: str, help_: str, label_names: tuple = ()) -> None:
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple, float] = {}
        self._mutex = threading.Lock()

    def set(self, value: float, *label_values) -> None:
        with self._mutex:
            self._values[label_values] = value

    def inc(self, *label_values, amount: float = 1.0) -> None:
        with self._mutex:
            self._values[label_values] = self._values.get(label_values, 0.0) + amount

    def dec(self, *label_values) -> None:
        self.inc(*label_values, amount=-1.0)

    def get(self, *label_values) -> float:
        return self._values.get(label_values, 0.0)

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        if not self._values and not self.label_names:
            yield f"{self.name} 0"
        for lv, v in sorted(self._values.items()):
            yield f"{self.name}{_fmt_labels(self.label_names, lv)} {v:g}"


DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10
)

# Microsecond-scale buckets (seconds) for the verdict-path stage
# histograms: DEFAULT_BUCKETS starts at 5ms, which is useless against a
# <1ms p99 target — every observation would land in the first bucket.
# 1µs resolution at the bottom, 100ms at the top (anything slower is a
# stall, not a latency distribution).
MICRO_BUCKETS = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1,
)

# Sub-millisecond-to-seconds buckets for end-to-end verdict latency:
# the budgeted region (<1ms) keeps 50µs resolution; the tail out to
# 10s exists to see shed/stall behavior, not to be lived in.
SUBMS_BUCKETS = (
    5e-5, 1e-4, 2.5e-4, 5e-4, 7.5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)


class Histogram:
    """Prometheus-style histogram.  ``observe`` is O(1) — one bisect
    plus one bucket increment under the mutex (it sits on the verdict
    hot path, once per stage per ROUND); the cumulative-bucket
    semantics the text format requires are computed at collect time."""

    def __init__(
        self, name: str, help_: str, label_names: tuple = (),
        buckets: tuple = DEFAULT_BUCKETS,
    ) -> None:
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.buckets = tuple(sorted(buckets))
        # Per-bucket (NON-cumulative) counts; overflow (> last bound)
        # lives only in _totals (the +Inf bucket).
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        self._mutex = threading.Lock()

    def observe(self, value: float, *label_values) -> None:
        j = bisect_left(self.buckets, value)
        with self._mutex:
            counts = self._counts.get(label_values)
            if counts is None:
                counts = self._counts[label_values] = [0] * len(self.buckets)
            if j < len(counts):
                counts[j] += 1
            self._sums[label_values] = self._sums.get(label_values, 0.0) + value
            self._totals[label_values] = self._totals.get(label_values, 0) + 1

    def get_count(self, *label_values) -> int:
        return self._totals.get(label_values, 0)

    def get_sum(self, *label_values) -> float:
        return self._sums.get(label_values, 0.0)

    def quantile(self, q: float, *label_values) -> float | None:
        """Upper bucket bound at quantile ``q`` (conservative — the true
        value is <= the returned bound unless it overflowed the last
        bucket, in which case the last bound is returned).  None when
        nothing was observed."""
        with self._mutex:
            total = self._totals.get(label_values, 0)
            if not total:
                return None
            counts = list(self._counts.get(label_values, ()))
        target = q * total
        running = 0
        for j, b in enumerate(self.buckets):
            running += counts[j] if j < len(counts) else 0
            if running >= target:
                return b
        return self.buckets[-1] if self.buckets else None

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._mutex:
            snap = {
                lv: (list(self._counts.get(lv, ())), self._sums.get(lv, 0.0),
                     self._totals[lv])
                for lv in self._totals
            }
        for lv in sorted(snap):
            counts, sum_, total = snap[lv]
            running = 0
            for j, b in enumerate(self.buckets):
                # Cumulative buckets: le is inclusive, every bucket
                # counts all observations <= its bound.
                running += counts[j] if j < len(counts) else 0
                labels = _fmt_labels(
                    self.label_names + ("le",), lv + (f"{b:g}",)
                )
                yield f"{self.name}_bucket{labels} {running}"
            labels_inf = _fmt_labels(self.label_names + ("le",), lv + ("+Inf",))
            yield f"{self.name}_bucket{labels_inf} {total}"
            yield (
                f"{self.name}_sum{_fmt_labels(self.label_names, lv)} "
                f"{sum_:g}"
            )
            yield (
                f"{self.name}_count{_fmt_labels(self.label_names, lv)} "
                f"{total}"
            )


class Registry:
    def __init__(self) -> None:
        self._collectors: list = []
        self._mutex = threading.Lock()

    def register(self, collector):
        with self._mutex:
            self._collectors.append(collector)
        return collector

    def counter(self, name, help_, label_names=()):
        return self.register(Counter(f"{NAMESPACE}_{name}", help_, label_names))

    def gauge(self, name, help_, label_names=()):
        return self.register(Gauge(f"{NAMESPACE}_{name}", help_, label_names))

    def histogram(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS):
        return self.register(
            Histogram(f"{NAMESPACE}_{name}", help_, label_names, buckets)
        )

    def expose(self) -> str:
        """Prometheus text format."""
        lines: list[str] = []
        with self._mutex:
            collectors = list(self._collectors)
        for c in collectors:
            lines.extend(c.collect())
        return "\n".join(lines) + "\n"


# Global registry + the reference's core metric set
# (reference: pkg/metrics/metrics.go:51-430).
registry = Registry()

EndpointCount = registry.gauge("endpoint_count", "Number of endpoints managed")
EndpointRegenerationCount = registry.counter(
    "endpoint_regenerations_total",
    "Count of all endpoint regenerations",
    ("outcome",),
)
EndpointRegenerationTime = registry.histogram(
    "endpoint_regeneration_seconds",
    "Endpoint regeneration time",
)
PolicyRevision = registry.gauge("policy_max_revision", "Highest policy revision")
PolicyCount = registry.gauge("policy_count", "Number of policy rules loaded")
PolicyImportErrors = registry.counter(
    "policy_import_errors_total", "Number of policy imports that failed"
)
DropCount = registry.counter(
    "drop_count_total", "Dropped packets/requests", ("reason", "direction")
)
ForwardCount = registry.counter(
    "forward_count_total", "Forwarded packets/requests", ("direction",)
)
ProxyVerdicts = registry.counter(
    "proxy_verdicts_total", "L7 proxy verdicts", ("l7_protocol", "verdict")
)
ProxyBatches = registry.counter(
    "proxy_batches_total", "Device verdict batches dispatched"
)
KvstoreDegraded = registry.gauge(
    "kvstore_degraded",
    "1 while the cluster store is fenced/unreachable and the agent "
    "serves from cached identities (reference: kvstore connectivity "
    "in `cilium status`)",
)
KvstoreDegradedEvents = registry.counter(
    "kvstore_degraded_events_total",
    "Transitions into kvstore degraded mode",
)

# Sidecar verdict-path overload & fault containment.  The degradation
# ladder is device -> quarantine -> host fallback -> shed; every rung
# is observable here and in `cilium sidecar status`.
SidecarShedTotal = registry.counter(
    "sidecar_shed_total",
    "Verdict entries shed with a typed SHED response "
    "(queue_full | deadline | stall | session_quota | "
    "session_quarantined)",
    ("reason",),
)
SidecarBatchCrashes = registry.counter(
    "sidecar_batch_crashes_total",
    "Dispatch rounds that crashed; every in-flight entry received a "
    "typed error verdict",
)
SidecarRefusedEntries = registry.counter(
    "sidecar_refused_entries_total",
    "Entries of device-engine connections answered with a typed error "
    "verdict because no device could judge them (quarantine: the guard "
    "holds the device out; unbound: the connection's engine is still "
    "building)",
    ("reason",),
)
DeviceStalls = registry.counter(
    "device_stalls_total",
    "Device calls that exceeded the watchdog deadline",
)
DeviceQuarantined = registry.gauge(
    "device_quarantined",
    "1 while the verdict device/engine is quarantined and verdicts flow "
    "through the host fallback",
)
DeviceQuarantineEvents = registry.counter(
    "device_quarantine_events_total",
    "Transitions into device quarantine",
)
SidecarQueueDepth = registry.gauge(
    "sidecar_queue_depth",
    "Verdict admission-queue depth (entries) sampled per dispatch round",
)
SidecarClientReconnects = registry.counter(
    "sidecar_client_reconnects_total",
    "Successful shim-client reconnects to the verdict service",
)
SidecarTransportFallback = registry.counter(
    "sidecar_transport_fallback_total",
    "Shared-memory transport work served on the socket rung instead "
    "(per-batch: ring_full | oversize | verdict_ring_full; session "
    "demotions: torn_slot | generation_mismatch | attach_rejected | "
    "disabled | peer_death | oversize_spree)",
    ("reason",),
)
# Multi-tenant fan-in (N shims, one sidecar): every containment action
# is SESSION-scoped and typed — the operator can attribute a shed or a
# quarantine to one pod.  The session label is the shim's announced
# identity, stable across its reconnects, drawn from a BOUNDED
# vocabulary (the service caps distinct label values; identities past
# the cap report as 'other', unnamed sessions as 'unnamed' — the full
# identity is always in status rows), so a shim cycling names cannot
# grow cardinality without bound.
SidecarSessionShed = registry.counter(
    "sidecar_session_shed_total",
    "Verdict entries shed with a typed response, attributed to the "
    "session that submitted them (session_quota | session_quarantined "
    "| queue_full | deadline | stall | error)",
    ("session", "reason"),
)
SidecarSessionQuarantines = registry.counter(
    "sidecar_session_quarantines_total",
    "Session-scoped quarantine latches (flood | reconnect_storm): the "
    "named session's data plane is answered typed-SHED for a cooldown "
    "while every other session keeps serving",
    ("session", "reason"),
)
SidecarSessionDeaths = registry.counter(
    "sidecar_session_deaths_total",
    "Shim sessions torn down, by how they died (closed | abrupt | "
    "send_timeout | write_failed)",
    ("reason",),
)
SidecarSessionsActive = registry.gauge(
    "sidecar_sessions_active",
    "Live shim sessions currently attached to the verdict service",
)
SidecarShmReclaims = registry.counter(
    "sidecar_shm_segments_reclaimed_total",
    "Orphaned shared-memory segments unlinked by the service after "
    "lease expiry (a shim died without MSG_SHM_DETACH; the creator "
    "would otherwise leak the /dev/shm files until reboot)",
)
SidecarStaleSegmentsSwept = registry.counter(
    "sidecar_shm_stale_segments_swept_total",
    "Dead-owner /dev/shm segments force-unlinked by the STARTUP sweep "
    "(a crashed predecessor's orphans, past lease — the in-service "
    "lease timers died with it, so the successor reclaims at boot)",
)
# Hitless restart (sidecar/service.py handoff): generation is the
# fencing token — a surrendered predecessor is a zombie whose late
# writes are rejected typed, never silently dropped.
SidecarRestartGeneration = registry.gauge(
    "sidecar_restart_generation",
    "This service's restart generation (monotonic across graceful "
    "handoffs; 1 = cold boot with no adopted snapshot)",
)
SidecarHandoffSurrenders = registry.counter(
    "sidecar_handoff_surrenders_total",
    "Handoff snapshots surrendered to a successor (this process "
    "fenced itself, quiesced in-flight rounds and released the "
    "socket path)",
)
SidecarFenceRejects = registry.counter(
    "sidecar_fence_rejects_total",
    "Late writes rejected typed by a fenced zombie predecessor "
    "(policy_update | data | new_connection)",
    ("kind",),
)
SidecarSurvivalHits = registry.counter(
    "sidecar_client_survival_hits_total",
    "Frames answered from the shim-local grant table while the "
    "sidecar was away (restart survival window open: grants served "
    "until replay revalidates or the grace deadline revokes them)",
)
# Policy-table epoch churn (sidecar/service.py): each successful
# compile-then-swap bumps the epoch gauge; failures are typed and the
# OLD epoch keeps serving (fail-closed — a failed recompile is never a
# policy outage).
PolicySwapsTotal = registry.counter(
    "policy_swaps_total",
    "Successful policy-table epoch swaps (staged build committed by "
    "one pointer flip under the round-snapshot lock)",
)
PolicySwapFailures = registry.counter(
    "policy_swap_failures_total",
    "Policy updates rejected fail-closed with the old epoch still "
    "serving (parse | host-compile | device-build | parity | "
    "ack-timeout | shutdown)",
    ("reason",),
)
PolicySwapSeconds = registry.histogram(
    "policy_swap_seconds",
    "Duration of the swap pointer flip (lock hold; the off-path "
    "staged build is NOT included)",
    buckets=MICRO_BUCKETS,
)
PolicyEpochGauge = registry.gauge(
    "policy_table_epoch",
    "Committed policy-table epoch (monotonic; bumped per swap)",
)
# Multi-chip sharded serving (parallel/rulesharding.py + sidecar
# service mesh rung): a lost/erroring mesh device demotes the whole
# service to the single-chip fallback executables — typed, counted,
# and bit-identical by the sharding parity contract.
MeshDemotions = registry.counter(
    "mesh_demotions_total",
    "Sharded (multi-chip) serving demoted to the single-chip fallback "
    "executables (device-call | device-stall), typed by reason; the "
    "service keeps serving, never a wedged round",
    ("reason",),
)
MeshActive = registry.gauge(
    "mesh_active",
    "1 while the (flows, rules) device mesh serves verdicts, 0 when "
    "off or demoted",
)
MeshRebindRebuilds = registry.counter(
    "mesh_rebind_rebuilds_total",
    "Demotion-era engines (built single-chip while the mesh rung was "
    "demoted) re-sharded by the heal's queued off-path rebuilds "
    "(ROADMAP 1c: the re-promotion flip queues a rebind per stranded "
    "engine instead of waiting for the next epoch swap)",
)
MeshRepromotions = registry.counter(
    "mesh_repromotions_total",
    "Demoted sharded serving re-promoted after a timed off-path "
    "re-probe (one sharded executable rebuilt, parity-probed against "
    "the single-chip fallback, then one pointer flip back)",
)
MeshReshapes = registry.counter(
    "mesh_reshapes_total",
    "Width-ladder reshapes: sharded serving rebuilt over the "
    "surviving device subset at a reduced bucketable width after a "
    "partial device loss (the fallback rung covers only the rebuild "
    "window, not until restart)",
)
MeshCapacity = registry.gauge(
    "mesh_capacity_fraction",
    "Serving capacity of the current mesh rung as a fraction of the "
    "full mesh (1.0 full, width ratio reshaped, 1/width fallback); "
    "admission (shed queue depth, DRR credit windows) scales by it so "
    "a degraded mesh sheds typed at its actual capacity",
)
MeshLostDevices = registry.gauge(
    "mesh_lost_devices",
    "Devices currently attributed lost by the per-device health table "
    "(readback error, stall, or vanishing from the backend device set)",
)
# Established-flow verdict cache (sidecar service Phase-A mask +
# _classify_entry, shim client pre-push short-circuit, engine judge
# steps).  Every hit is a device round, a wire round-trip, and a
# reassembly pass that never happens; every cached verdict is
# attributed to the ORIGINAL rule row under the epoch it was derived
# at (flowlog path label "cached").
VerdictCacheHits = registry.counter(
    "verdict_cache_hits_total",
    "Frames short-circuited by the established-flow verdict cache, by "
    "site (shim = bytes never pushed across the transport, service = "
    "sidecar Phase-A/entry mask, engine = judge-step host answer)",
    ("site",),
)
VerdictCacheMisses = registry.counter(
    "verdict_cache_misses_total",
    "Request-direction entries that reached the device path with the "
    "verdict cache enabled (no byte-invariance claim, stale epoch, or "
    "residue kept the flow off the cache tier)",
)
VerdictCacheInvalidations = registry.counter(
    "verdict_cache_invalidations_total",
    "Cache rows killed wholesale: epoch pointer-flips (the epoch key "
    "makes stale hits structurally impossible; this counts the armed "
    "rows each flip retired) and quarantine/close disarms",
    ("reason",),
)
VerdictCacheEvictions = registry.counter(
    "verdict_cache_evictions_total",
    "Armed rows evicted LRU-by-last-hit at the flow_cache_entries "
    "cap (capacity management, not invalidation: the victim's claim "
    "stays true for its epoch, so delivered shim grants need no "
    "revoke)",
)
FlowBufferOverflows = registry.counter(
    "flow_buffer_overflow_total",
    "Flows dropped for exceeding the retained-bytes cap without a "
    "frame boundary (typed protocol-error DROP + close)",
    ("proto",),
)

# Verdict-path latency decomposition (sidecar/trace.py).  Stage
# histograms are observed once per STAGE per dispatch ROUND (amortized
# — never per entry), labeled by serving path:
#   vec    — vectorized device path (matrix/vec rounds)
#   oracle — entrywise slow path (engines + in-process parsers)
#   host   — quarantine host-fallback rounds
#   shed   — typed SHED (queue_full / deadline / stall)
VerdictStageSeconds = registry.histogram(
    "verdict_stage_seconds",
    "Per-round verdict latency by stage: queue (admit->pop), "
    "batch_form, device_submit (host-side dispatch), device (fenced "
    "readback), drain, send",
    ("stage", "path"),
    buckets=MICRO_BUCKETS,
)
VerdictE2ESeconds = registry.histogram(
    "verdict_e2e_seconds",
    "End-to-end verdict latency (wire ingress -> verdict frame "
    "written), one observation per wire batch",
    ("path",),
    buckets=SUBMS_BUCKETS,
)
VerdictBatchOccupancy = registry.gauge(
    "verdict_batch_occupancy",
    "Entries in the last dispatch round / configured batch capacity",
)
DeviceBusyFraction = registry.gauge(
    "verdict_device_busy_fraction",
    "Fraction of wall-clock spent in the device stage (fenced "
    "submit->complete), windowed over the last ~1s of rounds",
)
VerdictTraceSpans = registry.counter(
    "verdict_trace_spans_total",
    "Per-entry verdict spans captured by the trace ring "
    "(sample = 1-in-N, slow = exceeded the slow threshold, "
    "shed = typed SHED exemplar)",
    ("kind",),
)

# Flow-level verdict observability (flowlog/): one increment per
# distinct (verdict, path, match_kind) tuple per ROUND — the counter
# twin of the flow-record ring, so dashboards see verdict mix by
# serving path and by how the deciding rule was compiled.
FlowVerdictsTotal = registry.counter(
    "flow_verdicts_total",
    "Flow verdict records by verdict, serving path, and the deciding "
    "rule's compiled match kind (literal|regex|nfa|l3|l4)",
    ("verdict", "path", "match_kind"),
)

# Kvstore traffic/fencing counters bridged from KvstoreCounters
# (kvstore/net.py): every named event increments here too, so the
# store's failure/fencing behavior shows up in /metrics instead of
# only in status RPCs.
KvstoreEvents = registry.counter(
    "kvstore_events_total",
    "Kvstore server/client event counters (fencing, replication, "
    "transport failures) bridged from kvstore/net.py KvstoreCounters",
    ("scope", "event"),
)

# Flight-recorder surface (sidecar/blackbox.py).  ServingTier unifies
# the per-subsystem degradation ladders into ONE scrapeable gauge —
# 0 is the full-speed rung, higher is narrower (mesh: full/reshaped/
# fallback = 0/1/2; guard: serving/quarantined = 0/1; cache: armed/
# disarmed = 0/1; transport: shm/socket = 0/1) — fed from the same
# typestate-observer hook that feeds the incident timeline.  Set only
# on tier CHANGE (control-plane transitions), never per entry.
ServingTier = registry.gauge(
    "serving_tier",
    "Current degradation-ladder rung per subsystem (0 = full speed, "
    "higher = narrower serving tier), unified across mesh, device "
    "guard, flow cache, and shm transport",
    ("subsystem",),
)
SidecarPostmortems = registry.counter(
    "sidecar_postmortem_bundles_total",
    "Postmortem bundles written by the flight recorder on fail-closed "
    "transitions, labeled by the triggering typestate table (or "
    "'mark' for non-typestate markers)",
    ("trigger",),
)

# Device-economics ledger (sidecar/ledger.py).  Two halves: the
# compile ledger answers "why did a compile happen" (cause taxonomy:
# cold / prewarm / churn-new-shape / churn-vocab / mesh-reshape /
# repromotion / heal-rebind) and the formation half answers "why was
# a batch issued" (trigger taxonomy: size-full / flush / deadline /
# idle-greedy / cut-through).  Compile metrics fire per COMPILE
# (control-plane rate); formation metrics fire once per ROUND, never
# per entry.
DeviceCompilesTotal = registry.counter(
    "device_compiles_total",
    "Executable-producing traces/compiles recorded by the device "
    "ledger, by cause (cold|prewarm|churn-new-shape|churn-vocab|"
    "mesh-reshape|repromotion|heal-rebind) and engine family",
    ("cause", "family"),
)
DeviceCompileSeconds = registry.histogram(
    "device_compile_seconds",
    "Wall seconds per recorded trace/compile, by cause",
    ("cause",),
    buckets=DEFAULT_BUCKETS,
)
ExecutablesResident = registry.gauge(
    "device_executables_resident",
    "Shape-keyed executables currently resident in the serving "
    "caches — the single definition shared by prewarm bookkeeping "
    "and the SHAPE_CACHE_MAX eviction path",
)
BatchFormationRounds = registry.counter(
    "batch_formation_rounds_total",
    "Dispatch rounds by formation trigger (size-full|flush|deadline|"
    "idle-greedy|cut-through) — one increment per round",
    ("trigger",),
)
BatchFormationAge = registry.histogram(
    "batch_formation_oldest_age_seconds",
    "Oldest-entry queue age at pop per dispatch round, by formation "
    "trigger — one observation per round",
    ("trigger",),
    buckets=MICRO_BUCKETS,
)
DrrOutstandingBytes = registry.gauge(
    "drr_outstanding_bytes",
    "Byte-weighted outstanding work across per-session DRR windows "
    "(payload bytes admitted to the dispatcher and not yet popped)",
)
