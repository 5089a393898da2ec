"""Transport seam abstraction for the shim ⇄ verdict-service boundary.

Two rungs, selected per session and re-negotiated on every reconnect:

- ``socket`` — the original unix-socket byte path.  Always attached;
  carries ALL control traffic in both modes and is the fail-closed
  fallback rung for the data plane.
- ``shm``    — the zero-copy fast path (:mod:`sidecar.shm`): data
  batches ride a shared-memory ring shim→service, verdict frames ride
  a second ring back, and the socket carries only batched
  ``MSG_SHM_DOORBELL``/``MSG_SHM_CREDIT`` nudges.

This module owns the shared session-state shapes so both ends count
and report the SAME degradation ladder dimension
(``transport=shm|socket``): a ring fault is typed, counted under one
of the ``REASON_*`` constants below, demotes the session to the socket
rung, and shows up identically in ``cilium sidecar status`` and the
``sidecar_transport_fallback_total{reason}`` metric — never a hang,
never silent loss.
"""

from __future__ import annotations

import threading
import time

from ..analysis.protocols import (
    SESSION_ACTIVE,
    SESSION_DEAD,
    SESSION_PROTOCOL,
    SESSION_QUARANTINED,
)
from ..utils import metrics
from . import blackbox
from .shm import ShmRing

TRANSPORT_SOCKET = "socket"
TRANSPORT_SHM = "shm"

# Degradation/fallback reasons (the label set of
# sidecar_transport_fallback_total).  Per-batch reasons route ONE batch
# to the socket; session reasons demote the whole session.
REASON_RING_FULL = "ring_full"            # per-batch: data ring full
REASON_OVERSIZE = "oversize"              # per-batch: frame > slot
REASON_VERDICT_RING_FULL = "verdict_ring_full"  # per-frame, service side
REASON_TORN_SLOT = "torn_slot"            # session: quarantined ring
REASON_GENERATION = "generation_mismatch"  # session: stale segment
REASON_ATTACH_REJECTED = "attach_rejected"  # session: negotiation failed
REASON_DISABLED = "disabled"              # session: service knob off
REASON_PEER_DEATH = "peer_death"          # session: peer vanished
REASON_OVERSIZE_SPREE = "oversize_spree"  # session: every frame oversized

# MSG_SHM_CREDIT flag bits.
CREDIT_FLAG_QUARANTINED = 1

# --- fan-in session containment (N shims, one sidecar) ---------------------
#
# The unit of fault isolation on the fan-in seam is the SESSION (one
# shim process's socket + optional ring pair).  Every containment
# action is scoped to exactly one session and typed with one of the
# reasons below — a misbehaving pod can be quarantined, demoted or
# shed without its neighbors losing a byte.

# SESSION_ACTIVE / SESSION_QUARANTINED / SESSION_DEAD and the declared
# transition table live in analysis/protocols.py (one definition: the
# R18 lint pass and this runtime consume the SAME edges) and are
# re-exported here for the historical import surface.

# Session-scoped shed reasons (sidecar_session_shed_total labels,
# alongside the global queue_full/deadline/stall reasons).
SHED_SESSION_QUOTA = "session_quota"          # DRR share exceeded
SHED_SESSION_QUARANTINED = "session_quarantined"  # quarantine window
SHED_FENCED = "fenced"          # zombie predecessor after handoff
SHED_RESTARTING = "restarting"  # shim-side survival window overflow

# Session quarantine reasons (sidecar_session_quarantines_total).
QUARANTINE_FLOOD = "flood"                    # sustained over-quota push
QUARANTINE_RECONNECT_STORM = "reconnect_storm"  # crash-looping shim

# Session death reasons (sidecar_session_deaths_total).
DEATH_CLOSED = "closed"            # orderly EOF (shim closed/detached)
DEATH_ABRUPT = "abrupt"            # EOF with the shm rung still live
DEATH_SEND_TIMEOUT = "send_timeout"  # shim stopped reading; write killed
DEATH_WRITE_FAILED = "write_failed"  # reply write failed mid-frame

class SessionState:
    """Per-shim-session admission, fairness and containment state —
    one instance per accepted connection, owned by its handler.

    Counter contract (the fan-in half of the exactly-once invariant):
    ``submitted`` counts entries admitted off this session's socket or
    rings; ``answered`` counts entries whose typed reply THIS session's
    handler wrote (real verdicts, SHED and error verdicts alike — the
    marking site under the handler write lock is the single counting
    point, so a stood-down racing reply never double-books); ``shed``
    breaks out the fail-closed subset by reason.  After a session
    quiesces, submitted == answered — anything else is a lost or
    double-answered entry.  All bumps are single integer ops on the
    hot path (GIL-atomic; reads are status-only)."""

    # Identities are wire-supplied: bound their length, and keep the
    # PROMETHEUS label under a separate bounded vocabulary
    # (metric_identity, assigned by the service's hello handler) so a
    # shim cycling names cannot grow label cardinality without bound.
    IDENTITY_MAX = 64

    def __init__(self, session_id: int, identity: str = ""):
        self.id = session_id
        self.identity = (
            identity[: self.IDENTITY_MAX] or f"sess-{session_id}"
        )
        self.named = bool(identity)
        self.metric_identity = "unnamed"
        self.born = time.monotonic()
        self.state = SESSION_ACTIVE
        self.death_reason: str | None = None
        self.quarantine_reason: str | None = None
        self.quarantined_until = 0.0
        self.quarantines: dict[str, int] = {}
        self.submitted = 0
        self.answered = 0
        self.shed: dict[str, int] = {}
        # DRR queue share: weight currently queued in the dispatcher on
        # this session's behalf.  Incremented at admission under the
        # dispatcher condition, zeroed wholesale when a round pops the
        # queue (the pop takes everything, so every session's unused
        # share replenishes at once — deficit-round-robin over queue
        # slots, paced by service progress).
        self.q_weight = 0
        # Byte-weighted twin of q_weight (PR 15 remainder): payload
        # bytes queued on this session's behalf, charged/drained on
        # the same dispatcher lock trips — entry count ≠ cost for
        # mixed frame sizes, so heavy-frame tenants are visible.
        self.q_bytes = 0
        # Flood strikes: over-quota sheds inside the strike window.
        self.strikes = 0
        self.strike_window_start = 0.0

    # -- containment -------------------------------------------------------

    def set_identity(self, identity: str) -> None:
        """First hello wins: a later hello on the same session is
        ignored — one connection must not cycle identities through the
        quota/metric/storm tables."""
        if identity and not self.named:
            self.identity = identity[: self.IDENTITY_MAX]
            self.named = True

    def quarantine(self, reason: str, cooldown_s: float) -> None:
        """Latch this session (and only this session) off the data
        plane for ``cooldown_s``: its submissions are answered with
        typed SHED immediately, its control plane keeps serving, and
        the latch self-heals when the window passes.  A dead session
        stays dead — quarantining a corpse is not a declared edge."""
        if self.state == SESSION_DEAD:
            return
        with blackbox.annotate(reason=reason, session=self.id):
            self.state = SESSION_PROTOCOL.advance(
                self.state, SESSION_QUARANTINED
            )
        self.quarantine_reason = reason
        self.quarantined_until = time.monotonic() + cooldown_s
        self.quarantines[reason] = self.quarantines.get(reason, 0) + 1
        metrics.SidecarSessionQuarantines.inc(self.metric_identity, reason)

    def quarantined_now(self) -> bool:
        """Lazy-heal check: True while the quarantine window is open;
        the first call past the deadline flips the session back to
        active (no timer thread — traffic drives the heal, like the
        DeviceGuard re-probe)."""
        if self.state != SESSION_QUARANTINED:
            return False
        if time.monotonic() >= self.quarantined_until:
            # Declared-silent lazy heal (protocols.py: the quarantine
            # OPEN was the counted event; the close is traffic-driven).
            with blackbox.annotate(reason="window-expired",
                                   session=self.id):
                self.state = SESSION_PROTOCOL.advance(
                    self.state, SESSION_ACTIVE
                )
            self.quarantine_reason = None
            return False
        return True

    def mark_dead(self, reason: str, counted: bool = True) -> None:
        """Terminal edge.  ``counted=False`` records the death without
        bumping the typed metric — the control-plane-session arm (a
        session that never carried data is not an operator-facing
        death), while still routing the transition through the ONE
        declared-edge mediation point."""
        if self.state != SESSION_DEAD:
            with blackbox.annotate(reason=reason, session=self.id):
                self.state = SESSION_PROTOCOL.advance(
                    self.state, SESSION_DEAD
                )
            self.death_reason = reason
            if counted:
                metrics.SidecarSessionDeaths.inc(reason)

    # -- accounting --------------------------------------------------------

    def count_shed(self, reason: str, n: int) -> None:
        self.shed[reason] = self.shed.get(reason, 0) + n
        metrics.SidecarSessionShed.inc(
            self.metric_identity, reason, amount=n
        )

    def status(self) -> dict:
        shed_total = sum(self.shed.values())
        out = {
            "session": self.id,
            "identity": self.identity,
            "state": self.state,
            "submitted": self.submitted,
            "answered": self.answered,
            "served": self.answered - shed_total,
            "shed": dict(self.shed),
            "q_weight": self.q_weight,
            "q_bytes": self.q_bytes,
        }
        if self.state == SESSION_QUARANTINED:
            out["quarantine_reason"] = self.quarantine_reason
            out["quarantine_remaining_s"] = round(
                max(self.quarantined_until - time.monotonic(), 0.0), 3
            )
        if self.quarantines:
            out["quarantines"] = dict(self.quarantines)
        if self.death_reason is not None:
            out["death_reason"] = self.death_reason
        return out


class _Counters:
    """Fallback/doorbell accounting shared by both ends (one lock-free
    integer bump per event; reads are status-path only)."""

    def __init__(self) -> None:
        self.fallbacks: dict[str, int] = {}
        self.doorbells = 0
        self.doorbell_items = 0
        self.credits = 0
        self.data_frames = 0
        self.verdict_frames = 0
        # Credit-piggybacked verdict polling (client side): drains of
        # the verdict ring driven by the post-commit tail MIRROR at a
        # natural boundary (a data push) instead of by a credit frame —
        # the elided doorbell RTTs.  Never a spin: polls happen only on
        # events the client was already performing.
        self.mirror_drains = 0
        self.mirror_frames = 0

    def fallback(self, reason: str, n: int = 1) -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + n
        metrics.SidecarTransportFallback.inc(reason, amount=n)

    def doorbell(self, items: int) -> None:
        self.doorbells += 1
        self.doorbell_items += items

    def status(self) -> dict:
        return {
            "fallbacks": dict(self.fallbacks),
            "doorbells": self.doorbells,
            "doorbell_batch_mean": round(
                self.doorbell_items / self.doorbells, 2
            ) if self.doorbells else 0.0,
            "credits": self.credits,
            "data_frames": self.data_frames,
            "verdict_frames": self.verdict_frames,
            "mirror_drains": self.mirror_drains,
            "mirror_frames": self.mirror_frames,
        }


class ShmSession:
    """Client-side shm session: data-ring producer + verdict-ring
    consumer, plus the doorbell/credit state machine.

    Push/doorbell calls are serialized by the client's write lock (the
    SPSC producer guarantee); the credit/drain side runs on the
    client's reader thread (the SPSC consumer guarantee)."""

    def __init__(self, data: ShmRing, verdict: ShmRing, generation: int):
        self.data = data
        self.verdict = verdict
        self.generation = generation
        self.active = True
        self.counters = _Counters()
        # Producer-side doorbell state (under the client write lock):
        # last doorbelled data tail, and the service's last credited
        # consume head (slots below it are free).
        self.db_tail = 0
        self.credit_head = 0
        # Verdict-ring consumer cursor and the head value last
        # piggybacked to the service.  Historically reader-thread-only
        # (SPSC); the mirror-poll path (client.poll_shm_verdicts) makes
        # the logical consumer a LOCK-SERIALIZED pair of threads —
        # every drain runs under drain_lock, so slot reads, v_head
        # advances and set_head stores never interleave.  RLock: a
        # verdict callback may push (and therefore poll) reentrantly.
        self.v_head = 0
        self.v_head_sent = 0
        self.drain_lock = threading.RLock()
        # Ring in-flight bookkeeping for zero-silent-loss demotion:
        # seq -> (ring position, conn_ids) for every data frame pushed
        # to the ring whose verdict has not come back.  GIL-atomic
        # per-key dict ops; writer = producer, eraser = reader thread.
        self.inflight: dict[int, tuple[int, object]] = {}
        # Consecutive data-ring oversize fallbacks (client half of the
        # oversize-spree demotion; reset on any successful push).
        self.oversize_run = 0
        # Lease granted by the service at attach (seconds a survivor
        # waits after abrupt peer death before unlinking the segments).
        self.lease_s = 0.0

    @classmethod
    def create(cls, generation: int, data_slots: int, data_slot_bytes: int,
               verdict_slots: int, verdict_slot_bytes: int) -> "ShmSession":
        data = ShmRing.create("data", generation, data_slots,
                              data_slot_bytes)
        try:
            verdict = ShmRing.create("verdict", generation, verdict_slots,
                                     verdict_slot_bytes)
        except Exception:
            data.close()
            data.unlink()
            raise
        return cls(data, verdict, generation)

    def attach_request(self) -> dict:
        """The MSG_SHM_ATTACH JSON payload."""
        return {
            "generation": self.generation,
            "data": self.data.seg.name,
            "verdict": self.verdict.seg.name,
        }

    def destroy(self) -> None:
        self.active = False
        for ring in (self.data, self.verdict):
            ring.close()
            ring.unlink()

    def status(self) -> dict:
        return {
            "mode": TRANSPORT_SHM if self.active else TRANSPORT_SOCKET,
            "generation": self.generation,
            "data": self.data.status(),
            "verdict": self.verdict.status(),
            "inflight": len(self.inflight),
            **self.counters.status(),
        }


class ShmPeer:
    """Service-side shm session: data-ring consumer + verdict-ring
    producer for one client handler.

    Drains run on the handler's reader thread (SPSC consumer); verdict
    pushes are serialized under the handler's write lock (SPSC
    producer).  ``_state_lock`` only guards the active/demotion latch —
    never held across blocking work."""

    def __init__(self, data: ShmRing, verdict: ShmRing, generation: int):
        self.data = data
        self.verdict = verdict
        self.generation = generation
        self.active = True
        self.counters = _Counters()
        self.head = 0            # data-ring consume cursor (reader)
        self.v_credit_head = 0   # client's last piggybacked verdict head
        self._state_lock = threading.Lock()
        self.quarantine_reason: str | None = None
        # Consecutive verdict-ring oversize fallbacks (reset on any
        # successful ring push): a spree means every frame this session
        # produces misses the ring and the per-frame fit check is pure
        # overhead — the session is demoted typed instead.
        self.oversize_run = 0
        self.attached_at = time.monotonic()

    @classmethod
    def attach(cls, req: dict) -> "ShmPeer":
        generation = int(req["generation"])
        data = ShmRing.attach(str(req["data"]), generation)
        try:
            verdict = ShmRing.attach(str(req["verdict"]), generation)
        except Exception:
            data.close()
            raise
        return cls(data, verdict, generation)

    def quarantine(self, reason: str) -> bool:
        """Latch the session off the shm rung (idempotent); True only
        for the transition so exactly one quarantined credit is sent."""
        with self._state_lock:
            if not self.active:
                return False
            self.active = False
            self.quarantine_reason = reason
        self.counters.fallback(reason)
        return True

    def close(self) -> None:
        self.active = False
        self.data.close()
        self.verdict.close()

    def reclaim(self) -> bool:
        """Survivor-side segment release: unlink BOTH segments of a
        session whose creator died without MSG_SHM_DETACH.  The creator
        owns the unlink in every orderly path; after an abrupt shim
        death nobody else ever will, and the /dev/shm files leak until
        reboot.  Safe against a shim that is actually alive behind a
        half-open socket: its own mappings stay valid (POSIX unlink
        semantics) and it reconnects with FRESH segments (generation
        bump) — its own later unlink of these names is a no-op.
        Returns True when at least one segment was actually removed."""
        a = self.data.force_unlink()
        b = self.verdict.force_unlink()
        return a or b

    def status(self) -> dict:
        return {
            "mode": TRANSPORT_SHM if self.active else TRANSPORT_SOCKET,
            "generation": self.generation,
            "quarantine_reason": self.quarantine_reason,
            "data": self.data.status(),
            "verdict": self.verdict.status(),
            **self.counters.status(),
        }
