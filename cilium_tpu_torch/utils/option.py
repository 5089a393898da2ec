"""Daemon configuration and runtime-mutable options.

reference: pkg/option — a typed config snapshot (config.go:168
daemonConfig) populated from flags, plus a runtime-mutable option map with
per-option verify/parse and change hooks (option.go), overlayable
per-endpoint (endpoint.go).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from . import defaults

# Boolean runtime options (reference: pkg/option/option.go option lib).
OPTION_DEBUG = "Debug"
OPTION_DROP_NOTIFY = "DropNotification"
OPTION_TRACE_NOTIFY = "TraceNotification"
OPTION_POLICY_VERDICT_NOTIFY = "PolicyVerdictNotification"
OPTION_CONNTRACK = "Conntrack"
OPTION_POLICY_ENABLED = "Policy"


@dataclass
class OptionSpec:
    name: str
    description: str = ""
    immutable: bool = False
    # parse raw string -> canonical value; default accepts true/false
    parse: Optional[Callable[[str], Any]] = None


def _parse_bool(v: str) -> bool:
    s = str(v).lower()
    if s in ("true", "enabled", "on", "1"):
        return True
    if s in ("false", "disabled", "off", "0"):
        return False
    raise ValueError(f"invalid option value {v!r}")


AVAILABLE_OPTIONS: dict[str, OptionSpec] = {
    OPTION_DEBUG: OptionSpec(OPTION_DEBUG, "Enable debugging"),
    OPTION_DROP_NOTIFY: OptionSpec(OPTION_DROP_NOTIFY, "Drop notifications"),
    OPTION_TRACE_NOTIFY: OptionSpec(OPTION_TRACE_NOTIFY, "Trace notifications"),
    OPTION_POLICY_VERDICT_NOTIFY: OptionSpec(
        OPTION_POLICY_VERDICT_NOTIFY, "Policy verdict notifications"
    ),
    OPTION_CONNTRACK: OptionSpec(OPTION_CONNTRACK, "Connection tracking"),
    OPTION_POLICY_ENABLED: OptionSpec(OPTION_POLICY_ENABLED, "Policy enforcement"),
}


class OptionMap:
    """Mutable option set with change hooks (reference: option.go
    BoolOptions + changedOption at daemon/daemon.go:1440)."""

    def __init__(self, parent: "OptionMap | None" = None) -> None:
        self._values: dict[str, bool] = {}
        self._parent = parent
        self._hooks: list[Callable[[str, bool], None]] = []
        self._mutex = threading.RLock()

    def get(self, name: str) -> bool:
        with self._mutex:
            if name in self._values:
                return self._values[name]
        if self._parent is not None:
            return self._parent.get(name)
        return False

    def set(self, name: str, value) -> bool:
        """Set; returns True if the effective value changed."""
        spec = AVAILABLE_OPTIONS.get(name)
        if spec is None:
            raise KeyError(f"unknown option {name!r}")
        if spec.immutable:
            raise PermissionError(f"option {name!r} is immutable")
        parse = spec.parse or _parse_bool
        v = parse(value) if isinstance(value, str) else bool(value)
        with self._mutex:
            old = self.get(name)
            self._values[name] = v
            changed = old != v
            hooks = list(self._hooks)
        if changed:
            for h in hooks:
                h(name, v)
        return changed

    def delete(self, name: str) -> None:
        """Remove the local override (per-endpoint overlay semantics)."""
        with self._mutex:
            self._values.pop(name, None)

    def add_change_hook(self, hook: Callable[[str, bool], None]) -> None:
        self._hooks.append(hook)

    def snapshot(self) -> dict[str, bool]:
        with self._mutex:
            out = dict(self._parent.snapshot()) if self._parent else {}
            out.update(self._values)
            return out


@dataclass
class DaemonConfig:
    """Typed config snapshot (reference: pkg/option/config.go:168)."""

    # Paths
    run_dir: str = defaults.RUNTIME_PATH
    state_dir: str = defaults.STATE_DIR
    socket_path: str = defaults.SOCK_PATH
    monitor_socket_path: str = defaults.MONITOR_SOCK_PATH
    access_log_path: str = ""

    # Cluster
    cluster_name: str = defaults.CLUSTER_NAME
    cluster_id: int = 0

    # Policy
    enable_policy: str = "default"  # default | always | never
    allow_localhost: str = "auto"  # auto | always | policy
    host_allows_world: bool = False

    # Proxy
    proxy_port_min: int = defaults.PROXY_PORT_MIN
    proxy_port_max: int = defaults.PROXY_PORT_MAX
    # How long a regeneration blocks waiting for the verdict service to
    # ACK an NPDS policy push before failing and reverting (reference:
    # the completion.WaitGroup context deadline at pkg/endpoint/bpf.go:555).
    proxy_ack_timeout_s: float = 5.0
    # This node's underlay IPv4 (the VXLAN tunnel endpoint peers encap
    # to).  Published as HostIP/TunnelEndpoint with every local
    # endpoint's ipcache pair (reference: pkg/ipcache/kvstore.go
    # marshals hostIP; bpf/lib/encap.h uses the learned tunnel endpoint).
    node_ipv4: str = ""

    # Device batching (TPU runtime)
    batch_flows: int = defaults.BATCH_FLOWS
    batch_width: int = defaults.BATCH_WIDTH
    batch_timeout_ms: float = defaults.BATCH_TIMEOUT_MS
    # Device dispatch: 'eager' pipelines per-op async dispatch (wins on
    # high-latency device links), 'jit' compiles one executable launch
    # per batch (wins co-located), 'auto' measures both at prewarm and
    # keeps the faster.
    dispatch_mode: str = "auto"  # auto | eager | jit
    # 'cpu' routes verdict models to the host CPU backend (removes the
    # device-link term; used by the co-located latency proof).
    verdict_device: str = "default"  # default | cpu
    # DIAGNOSTIC: replace verdict compute with a trivial all-allow
    # device op so the sidecar seam itself (batch fill -> wire ->
    # dispatch -> device call -> readback -> wire back) can be measured
    # with the verdict-compute term removed.  Never a production config.
    seam_probe: bool = False

    # Overload & fault containment (sidecar verdict path).  The
    # contract is bounded-latency degradation, never availability loss:
    # a stuck device call quarantines the device (verdicts continue
    # through the bit-identical host/oracle fallback), and a burst past
    # capacity sheds with a typed SHED verdict instead of queueing
    # unboundedly or hanging the caller.
    #
    # Upper bound on one device round (model call / readback) before
    # the watchdog deposes the dispatch worker and quarantines the
    # device.  Must comfortably exceed worst-case XLA compile times on
    # the deployment's device link; 0 disables the watchdog.
    device_call_timeout_s: float = 10.0
    # While quarantined, how often traffic re-probes the device for
    # automatic un-quarantine.
    device_reprobe_interval_s: float = 1.0
    # Consecutive crashed dispatch rounds before the device/engine is
    # treated as poisoned and quarantined (0 disables).
    device_fail_threshold: int = 3
    # Admission-queue watermarks: pending entries beyond this are shed
    # at submit (0 = unbounded), and queued entries older than this are
    # shed at dispatch (0 = no age bound).  Entries may also carry an
    # explicit per-entry deadline from the shim (wire DATA_BATCH_DL),
    # which takes precedence over the age watermark.
    shed_queue_entries: int = 1 << 17
    shed_queue_age_ms: float = 5000.0
    # Per-flow retained-bytes cap (engine flow buffers, the columnar
    # reassembly arena, and the service's oracle buffer mirror): a flow
    # that buffers more than this without a frame boundary gets a typed
    # protocol-error DROP and is closed, matching the reference's
    # bounded retained-data contract.
    max_flow_buffer: int = 1 << 20
    # Columnar reassembly lane (sidecar/reasm.py): serve the CRLF slow
    # lane with array passes per ROUND instead of feed/settle Python
    # per ENTRY.  Pipelined (batch_timeout_ms > 0) services only —
    # greedy rounds are 1-2 small messages and the columnar fixed cost
    # loses.  False keeps every round on the scalar engine/oracle rung.
    reasm: bool = True
    # Rounds with fewer lane-eligible entries than this fall back to
    # the scalar path (below it the per-round numpy fixed cost exceeds
    # the per-entry Python it replaces).
    reasm_min_entries: int = 4
    # Initial byte-arena capacity (grows geometrically; per-conn totals
    # stay bounded by max_flow_buffer regardless).
    reasm_arena_bytes: int = 1 << 20
    # Shared-memory transport (sidecar/shm.py): whether the service
    # accepts MSG_SHM_ATTACH ring negotiation.  False rejects attaches
    # typed — every session serves on the socket rung (the client's
    # transport preference degrades, it never fails).  Ring geometry is
    # client-owned (SidecarClient shm_* kwargs): the shim creates the
    # segments and the service only maps what was negotiated.
    shm_transport: bool = True
    # Ring-segment lease (seconds): how long the service waits after a
    # session dies WITHOUT MSG_SHM_DETACH before unlinking its shared-
    # memory segments.  The creator (shim) owns the unlink on every
    # orderly path; after an abrupt shim death this lease is the only
    # thing standing between the node and a /dev/shm leak per crash.
    shm_lease_s: float = 30.0
    # Verdict-ring oversize spree: this many CONSECUTIVE oversize
    # fallbacks demote the session's shm rung typed (oversize_spree) —
    # a session whose every frame misses the ring pays the fit check
    # for nothing.  The same threshold drives the client-side data-ring
    # spree.  0 disables.
    shm_oversize_spree: int = 32

    # Multi-tenant fan-in (N shim sessions, one dispatcher).  Deficit-
    # round-robin credit windows: a session may hold at most
    # max(shed_queue_entries / (sessions + 1), session_share_min)
    # OUTSTANDING entries (submitted and not yet answered — the window
    # covers the dispatcher queue AND the issued-not-answered
    # completion pipeline); excess submissions are shed typed
    # `session_quota` for THAT session only.  Credits return as
    # answers are written, so a flood's buffering lands on the
    # flooder while a session under its share is never refused.
    session_share_min: int = 64
    # Flood containment: this many over-quota sheds inside the strike
    # window escalate to a session quarantine (typed `flood`) for
    # session_quarantine_s — the flooding pod's data plane is answered
    # typed-SHED immediately instead of being classified per batch.
    # 0 disables escalation.
    session_flood_strikes: int = 200
    session_strike_window_s: float = 2.0
    session_quarantine_s: float = 5.0
    # Crash-loop containment: a shim identity that reconnects more
    # than this many times inside the reconnect window starts its next
    # session QUARANTINED (typed `reconnect_storm`) for
    # session_quarantine_s — control plane (replay) still serves, so a
    # healed pod exits the latch by just staying up.  0 disables.
    session_reconnect_storm: int = 8
    session_reconnect_window_s: float = 10.0

    # Multi-card sharded verdict serving (parallel/rulesharding.py).
    # 'auto' builds a (flows, rules) device mesh at first engine bind
    # when the host has two or more distinct CUDA cards (never on the
    # CPU, and never as virtual slots of one card — those share one
    # card's SMs and a cross-shard reduce only adds work); 'on' forces
    # the mesh at any device count (how the CPU tests and the card's
    # virtual-slot smoke run); 'off' keeps the single-card models.
    mesh: str = "auto"  # auto | on | off
    # RULE_AXIS extent: rule tables split-balanced and padded across
    # this many shards (HBM capacity for 100k+-rule tables; per-shard
    # NFA delta shrinks ~quadratically).  0 = 1 (no rule sharding).
    mesh_rule_shards: int = 0
    # FLOW_AXIS extent: batch axes shard across this many devices for
    # throughput.  0 = devices // rule_shards, floored to a power of
    # two (so every power-of-two dispatch bucket divides it) and
    # capped at the smallest bucket.  An EXPLICIT value may exceed the
    # smallest dispatch bucket: the service grows its
    # minimum bucket to the flow extent so >32-device pods shard the
    # flow axis fully.
    mesh_flow_shards: int = 0
    # Width-ladder reshape: after a partial device loss the policy
    # builder thread rebuilds the sharded wrappers over the surviving
    # devices at the next bucketable width (fallback covers only the
    # rebuild window).  False keeps a binary ladder:
    # any mesh fault demotes straight to the single-card fallback.
    mesh_reshape: bool = True
    # Guarded mesh re-promotion: after a mesh demotion, the policy
    # builder thread re-probes the mesh off-path at most once per this
    # interval (rebuild one sharded executable, parity-probe it against
    # the single-card fallback, re-promote typed on success).  0 keeps
    # a demotion sticky until restart.
    mesh_reprobe_interval_s: float = 5.0

    # Established-flow verdict cache (sidecar/service.py + client.py +
    # policy/invariance.py): per-flow decisions keyed (conn, direction,
    # policy epoch) that short-circuit byte-invariant flows — in the
    # shim before bytes cross the transport, and in the sidecar's
    # vectorized eligibility mask before any device round.  OFF by
    # default: the cache coalesces per-frame ops into stream-level
    # PASS ops (byte-equivalent forwarded output, not op-identical),
    # so the strict op-parity suites run against the true baseline;
    # every short-circuit site is gated on this knob (like
    # flow_observe).
    flow_cache: bool = False
    # Cap on service-side armed cache rows (beyond it, new flows stop
    # arming but existing rows keep serving).
    flow_cache_entries: int = 1 << 20

    # Hitless restart (sidecar/service.py handoff).  A starting
    # service that finds a live predecessor on its socket path pulls a
    # state handoff over the side channel (MSG_HANDOFF) before binding:
    # sessions, conns, grants, policy epoch and flow-buffer residue
    # carry over, and the predecessor is fenced (its late writes are
    # rejected typed).  False boots cold unconditionally — the crash-
    # restart path, which is always correct, just not warm.
    restart_handoff: bool = True
    # Bound on the whole handoff pull: the predecessor's quiesce
    # (in-flight rounds answered by the OLD process) and the snapshot
    # reply must land within this window, else the successor cold-
    # boots.  Also the successor's dial/read socket timeout.
    handoff_deadline_s: float = 5.0

    # Policy churn (sidecar/service.py epoch swap).  How long a
    # MSG_POLICY_UPDATE handler waits for the builder thread's staged
    # compile-then-swap to commit before acking UNKNOWN_ERROR (the
    # build keeps running and swaps when done; the old epoch serves
    # throughout).  Must comfortably exceed worst-case XLA compile
    # times on the deployment's device link.
    policy_swap_timeout_s: float = 120.0
    # Re-assert device-model vs host-oracle bit-identity on every new
    # epoch before it is committed (a small deterministic probe batch
    # per rebuilt engine; a mismatch fails the swap typed and the old
    # epoch keeps serving).
    policy_epoch_parity: bool = True

    # Verdict-path latency decomposition (sidecar/trace.py).
    # Always-on per-round stage histograms + occupancy/busy gauges
    # (False removes the metric observes; the bench's instrumentation-
    # disabled baseline — stamps themselves are ~ns and stay on).
    trace_stage_metrics: bool = True
    # 1-in-N per-entry span sampling into the trace ring (0 disables
    # sampling; slow exemplars are captured regardless).
    trace_sample_every: int = 4096
    # End-to-end latency above which a wire batch becomes a slow
    # exemplar (monitor event + accesslog annotation + ring).  0 makes
    # EVERY batch an exemplar — the e2e-test/forensics setting.
    trace_slow_ms: float = 50.0
    # Span ring capacity (bounded; oldest spans are evicted).
    trace_ring: int = 512

    # Flight recorder (sidecar/blackbox.py).  Always-on incident
    # timeline: every mediated typestate transition + overload markers
    # land in a bounded ring; fail-closed edges trigger automatic
    # postmortem bundles.  timeline_ring is the event ring capacity.
    timeline_ring: int = 512
    # Directory postmortem bundles are serialized to as JSON files
    # ("" keeps bundles in-memory only — they still ride the monitor
    # stream and the MSG_TIMELINE reply).
    timeline_bundle_dir: str = ""
    # True drops routine declared-silent edges (outcome None, not
    # fail-closed) from the ring — the low-noise setting; fail-closed
    # edges and counted transitions are always recorded.
    timeline_slow_only: bool = False

    # Flow-level verdict observability (flowlog/): per-flow records
    # with device-side rule attribution, populated per ROUND from all
    # decision layers and queryable via `cilium observe`/MSG_OBSERVE.
    # False removes record emission AND the attributed device call —
    # the flow_observe_overhead bench's disabled baseline.
    flow_observe: bool = True
    # Flow-record ring capacity in RECORDS (oldest rounds evicted whole).
    flowlog_ring: int = 8192

    # Modes
    dry_mode: bool = False  # reference: DryMode, pkg/endpoint/bpf.go:510
    restore_state: bool = True
    enable_health: bool = True  # reference: cilium-health launch
    pprof: bool = False  # reference: --pprof -> pkg/pprof Enable
    pprof_port: int = 6060  # reference: pprof.go apiAddress (0 = ephemeral)
    per_flow_debug: bool = False  # reference: pkg/flowdebug

    # kvstore
    kvstore: str = "local"  # local | file | tcp
    kvstore_opts: dict = field(default_factory=dict)

    # Monitor
    monitor_queue_size: int = defaults.MONITOR_QUEUE_SIZE

    # Runtime options
    opts: OptionMap = field(default_factory=OptionMap)

    def always_allow_localhost(self) -> bool:
        """reference: config.go AlwaysAllowLocalhost."""
        return self.allow_localhost == "always"

    def validate(self) -> None:
        """reference: config.go:338 Validate."""
        if self.enable_policy not in ("default", "always", "never"):
            raise ValueError(f"invalid enable_policy {self.enable_policy!r}")
        if not 0 < self.proxy_port_min < self.proxy_port_max <= 65535:
            raise ValueError("invalid proxy port range")
        if self.batch_flows <= 0 or self.batch_width <= 0:
            raise ValueError("batch dimensions must be positive")
        if self.dispatch_mode not in ("auto", "eager", "jit"):
            raise ValueError(f"invalid dispatch_mode {self.dispatch_mode!r}")
        if self.verdict_device not in ("default", "cpu"):
            raise ValueError(f"invalid verdict_device {self.verdict_device!r}")
        if self.cluster_id < 0 or self.cluster_id > 255:
            raise ValueError("cluster-id must be in [0, 255]")
        if (
            self.device_call_timeout_s < 0
            or self.device_reprobe_interval_s < 0
            or self.device_fail_threshold < 0
            or self.shed_queue_entries < 0
            or self.shed_queue_age_ms < 0
            or self.max_flow_buffer < 0
        ):
            raise ValueError("containment thresholds must be non-negative")
        if (
            self.session_share_min < 0
            or self.session_flood_strikes < 0
            or self.session_strike_window_s < 0
            or self.session_quarantine_s < 0
            or self.session_reconnect_storm < 0
            or self.session_reconnect_window_s < 0
            or self.shm_lease_s < 0
            or self.shm_oversize_spree < 0
        ):
            raise ValueError(
                "session fairness/containment thresholds must be "
                "non-negative"
            )
        if (
            self.trace_sample_every < 0
            or self.trace_slow_ms < 0
            or self.trace_ring <= 0
        ):
            raise ValueError(
                "trace knobs must be non-negative (ring positive)"
            )
        if self.flowlog_ring <= 0:
            raise ValueError("flowlog_ring must be positive")
        if self.timeline_ring <= 0:
            raise ValueError("timeline_ring must be positive")
        if self.mesh not in ("auto", "on", "off"):
            raise ValueError(f"invalid mesh {self.mesh!r}")
        if self.mesh_rule_shards < 0 or self.mesh_flow_shards < 0:
            raise ValueError("mesh shard counts must be non-negative")
        if self.mesh_reprobe_interval_s < 0:
            raise ValueError("mesh_reprobe_interval_s must be >= 0")
        if self.flow_cache_entries < 0:
            raise ValueError("flow_cache_entries must be >= 0")
        if self.handoff_deadline_s < 0:
            raise ValueError("handoff_deadline_s must be >= 0")


# Global config (reference: option.Config singleton).
config = DaemonConfig()
