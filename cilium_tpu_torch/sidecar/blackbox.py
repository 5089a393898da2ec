"""Flight recorder: the declared-edge incident timeline.

PR 18 declared every lifecycle invariant as data (`analysis/protocols.py`
typestate tables) and routed every transition through ONE choke point —
``Typestate.advance``/``guard``/``require_edges``.  This module hooks
that choke point so an operator reconstructing a degradation cascade
gets an ORDERED, CORRELATED record of which declared edges fired, in
what sequence, with what reasons — instead of scattered counters:

- **Timeline ring.**  Every mediated transition lands in a bounded
  ``deque(maxlen=timeline_ring)`` as ``(monotonic seq, wall time,
  table, edge, outcome)`` plus whatever correlation ids the transition
  site annotated (session / conn / epoch / round / device / reason).
  Appends are GIL-atomic; transitions are control-plane events (session
  containment, policy swaps, mesh rungs, cache arm/disarm), never the
  per-entry verdict loop, so the always-on cost is the ``is None``
  observer test in ``protocols.py`` — nothing else (BENCH_NOTES
  ``timeline_overhead``).
- **Overload markers.**  Shed bursts, DRR window clips and dispatch
  stalls are coalesced per kind into one ring event per 0.25s window
  (the event's ``n`` keeps accumulating in place), so a 50k-entry shed
  storm costs one dict mutation per entry-batch, not 50k ring events.
- **Occupancy series.**  ``sample_round`` (called once per dispatch
  round from ``VerdictTracer.finish_round``) folds device-busy
  seconds, batch occupancy, queue depth and admission headroom into
  1-second buckets — the time-series ROADMAP item 4's occupancy-aware
  tier switch consumes.
- **Postmortem bundles.**  Any edge in ``protocols.FAIL_CLOSED``
  (quarantine, mesh descent, shm demotion, session death, swap
  failure, kvstore degraded) snapshots the ring SYNCHRONOUSLY (the
  triggering edge is the snapshot's last event) and hands enrichment —
  stage-latency snapshot, relevant ``status()`` sections, JSON file
  write, monitor fan-out — to a daemon thread.  The enrichment MUST
  be asynchronous: fail-closed advances fire under ``service._lock``
  and a synchronous ``status()`` call would self-deadlock.  A global
  armed-latch (re-armed when any fail-closed table returns to its
  initial state, i.e. on heal) plus a time floor keeps it to one
  bundle per descent, not one per edge of the cascade.

Multiple services can coexist in one process (the hitless-handoff
tests run old+new side by side), so recorders register in a module
tuple and the single ``protocols`` observer fans out to all of them.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

from ..analysis import protocols
from ..utils import metrics

# One ring event per overload kind per this many seconds — the window
# an in-place ``n`` accumulates over.
OVERLOAD_WINDOW_S = 0.25

# Occupancy bucket width (matches VerdictTracer.BUSY_WINDOW_S).
BUCKET_S = 1.0

# Minimum spacing between postmortem bundles while the latch is down
# (a heal re-arms immediately; this floor only bounds a cascade that
# never heals).
FAIL_CLOSED_DEBOUNCE_S = 10.0

# ``(table, to)`` pairs that mean the subsystem returned to its
# protocol's INITIAL (healthy) state — these re-arm the postmortem
# latch, so the NEXT descent gets its own bundle.
_REARM_EDGES = frozenset({
    ("session", protocols.SESSION_ACTIVE),
    ("device_guard", protocols.GUARD_SERVING),
    ("mesh_device", protocols.DEVICE_OK),
    ("mesh_ladder", protocols.MESH_FULL),
    ("epoch_swap", protocols.SWAP_COMMITTED),
})

# Marker tokens that signal recovery rather than failure (they re-arm
# the latch and reset the transport tier instead of triggering).
_REARM_MARKS = frozenset({"shm_attach", "kvstore_restored"})

# ``(table, to)`` -> (subsystem, tier) for the unified serving-tier
# gauge: 0 is the full-speed rung, higher is narrower.  Transport tier
# moves via marks (shm_demotion / shm_attach) — it has no typestate.
_TIER_EDGES = {
    ("mesh_ladder", protocols.MESH_FULL): ("mesh", 0),
    ("mesh_ladder", protocols.MESH_RESHAPED): ("mesh", 1),
    ("mesh_ladder", protocols.MESH_FALLBACK): ("mesh", 2),
    ("device_guard", protocols.GUARD_SERVING): ("guard", 0),
    ("device_guard", protocols.GUARD_QUARANTINED): ("guard", 1),
    ("flow_cache", protocols.CACHE_ARMED): ("cache", 0),
    ("flow_cache", protocols.CACHE_UNARMED): ("cache", 1),
}

SUBSYSTEMS = ("mesh", "guard", "cache", "transport")


# -- transition-site annotations (thread-local) ---------------------------
#
# A transition site knows WHY it is advancing (reason string) and WHO
# it is advancing for (session / conn / epoch / device ids); the
# protocols observer only sees (table, frm, to, outcome).  Sites wrap
# the advance in ``with blackbox.annotate(reason=..., session=...)``
# and the recorder folds the stack into the event.  Thread-local, so
# concurrent handler threads never cross-label each other's edges.

_ANNOT = threading.local()


class annotate:
    """Context manager attaching correlation ids to every transition
    recorded on this thread while the block is live.  Nestable; inner
    keys win."""

    __slots__ = ("ids",)

    def __init__(self, **ids):
        self.ids = ids

    def __enter__(self):
        stack = getattr(_ANNOT, "stack", None)
        if stack is None:
            stack = _ANNOT.stack = []
        stack.append(self.ids)
        return self

    def __exit__(self, *exc):
        _ANNOT.stack.pop()
        return False


def _annotations() -> dict | None:
    stack = getattr(_ANNOT, "stack", None)
    if not stack:
        return None
    if len(stack) == 1:
        return stack[0]
    merged: dict = {}
    for d in stack:
        merged.update(d)
    return merged


# -- process-wide registry ------------------------------------------------

_REG_LOCK = threading.Lock()
_RECORDERS: tuple = ()


def _dispatch(table, frm, to, outcome) -> None:
    """The ONE callback installed as the protocols transition observer
    (containment lives in ``protocols._observe``)."""
    for rec in _RECORDERS:
        rec._on_transition(table, frm, to, outcome)


def broadcast_mark(token: str, **ids) -> None:
    """Record a non-typestate marker on every installed recorder — the
    entry point for code that has no service handle (the daemon's
    kvstore-degraded latch).  No-op when nothing is installed."""
    for rec in _RECORDERS:
        try:
            rec.record_mark(token, **ids)
        except Exception:  # noqa: BLE001 -- a marker must never fail its caller
            pass


class FlightRecorder:
    """Always-on, bounded, lock-light incident recorder for one
    service (see module docstring for the design contract)."""

    def __init__(self, *, ring: int = 512, bundle_dir: str = "",
                 slow_only: bool = False):
        self.ring: deque = deque(maxlen=max(int(ring), 1))
        self.bundle_dir = bundle_dir or ""
        self.slow_only = bool(slow_only)
        self._seq = itertools.count(1)
        self.debounce_s = FAIL_CLOSED_DEBOUNCE_S
        # Enrichment providers, attached externally by the service
        # (same pattern as VerdictTracer.monitor/access_logger).
        self.monitor = None           # monitor.Monitor (notify())
        self.stage_provider = None    # () -> per-path stage snapshot
        self.status_provider = None   # () -> relevant status() sections
        self.occupancy_probe = None   # () -> (queue_depth, headroom)
        # Postmortem latch (one bundle per descent).
        self._plock = threading.Lock()
        self._armed = True
        self._last_bundle_mono = -1e9
        self.postmortems: deque = deque(maxlen=8)
        self.bundles_written = 0
        self.bundles_suppressed = 0
        self.fail_closed_events = 0
        # Overload coalescing: kind -> (window_start_mono, ring event).
        self._over: dict = {}
        # Occupancy buckets: closed buckets ride a deque; the open
        # bucket is mutated under a short per-round lock.
        self._olock = threading.Lock()
        self._obuckets: deque = deque(maxlen=64)
        self._ocur: dict | None = None
        # Unified serving-tier gauge state (last value per subsystem).
        self._tiers: dict = {}

    # -- install / uninstall ----------------------------------------------

    def install(self) -> "FlightRecorder":
        """Register with the process-wide observer and zero the
        serving-tier gauge for every subsystem (a scrape before the
        first transition must show the full-speed rung)."""
        global _RECORDERS
        with _REG_LOCK:
            if self not in _RECORDERS:
                _RECORDERS = _RECORDERS + (self,)
            protocols.set_transition_observer(_dispatch)
        for sub in SUBSYSTEMS:
            self._set_tier(sub, 0)
        return self

    def uninstall(self) -> None:
        global _RECORDERS
        with _REG_LOCK:
            _RECORDERS = tuple(r for r in _RECORDERS if r is not self)
            if not _RECORDERS:
                protocols.set_transition_observer(None)

    # -- the transition sink ----------------------------------------------

    def _on_transition(self, table, frm, to, outcome) -> None:
        fail = (table, frm, to) in protocols.FAIL_CLOSED_EDGES
        ev = None
        if fail or not (self.slow_only and outcome is None):
            ev = {"seq": next(self._seq), "t": time.time(),
                  "table": table, "edge": [frm, to], "outcome": outcome}
            ann = _annotations()
            if ann:
                ev.update(ann)
            if fail:
                ev["fail_closed"] = True
            self.ring.append(ev)
        tier = _TIER_EDGES.get((table, to))
        if tier is not None:
            self._set_tier(tier[0], tier[1])
        if fail:
            self.fail_closed_events += 1
            self._fail_closed(ev)
        elif (table, to) in _REARM_EDGES:
            self._rearm()

    # -- markers / overload -----------------------------------------------

    def record_mark(self, token: str, **ids) -> None:
        """A non-typestate lifecycle marker (shm transport demotion,
        kvstore degradation, and their recovery twins)."""
        ev = {"seq": next(self._seq), "t": time.time(), "table": "mark",
              "edge": ["-", token], "outcome": None}
        if ids:
            ev.update(ids)
        fail = token in protocols.FAIL_CLOSED_MARKERS
        if fail:
            ev["fail_closed"] = True
        self.ring.append(ev)
        if token == "shm_demotion":
            self._set_tier("transport", 1)
        elif token == "shm_attach":
            self._set_tier("transport", 0)
        if fail:
            self.fail_closed_events += 1
            self._fail_closed(ev)
        elif token in _REARM_MARKS:
            self._rearm()

    def record_overload(self, kind: str, n: int = 1) -> None:
        """Coalesced overload marker (shed burst, DRR window clip,
        queue high-water, dispatch stall): ONE ring event per kind per
        window; its ``n`` accumulates in place."""
        now = time.monotonic()
        cur = self._over.get(kind)
        if cur is not None and now - cur[0] < OVERLOAD_WINDOW_S:
            cur[1]["n"] += n
            return
        ev = {"seq": next(self._seq), "t": time.time(),
              "table": "overload", "edge": ["-", kind],
              "outcome": None, "n": n}
        self._over[kind] = (now, ev)
        self.ring.append(ev)

    # -- occupancy series -------------------------------------------------

    def sample_round(self, n: int, capacity: int, device_s: float,
                     now: float | None = None) -> None:
        """Fold one dispatch round into the open occupancy bucket.
        Called from ``VerdictTracer.finish_round`` — once per ROUND,
        never per entry (the same cadence contract as the tracer's own
        accumulators)."""
        if now is None:
            now = time.monotonic()
        queue = headroom = None
        probe = self.occupancy_probe
        if probe is not None:
            try:
                queue, headroom = probe()
            except Exception:  # noqa: BLE001 -- probe faults must not cost the round
                pass
        with self._olock:
            b = self._ocur
            if b is None or now - b["t0"] >= BUCKET_S:
                if b is not None:
                    self._obuckets.append(self._close_bucket(b))
                b = self._ocur = {
                    "t0": now, "t": time.time(), "rounds": 0,
                    "items": 0, "cap": 0, "device_s": 0.0,
                    "queue_max": 0, "headroom_min": None,
                }
            b["rounds"] += 1
            b["items"] += int(n)
            b["cap"] += max(int(capacity), 1)
            b["device_s"] += float(device_s)
            if queue is not None and queue > b["queue_max"]:
                b["queue_max"] = queue
            if headroom is not None and (b["headroom_min"] is None
                                         or headroom < b["headroom_min"]):
                b["headroom_min"] = headroom

    @staticmethod
    def _close_bucket(b: dict) -> dict:
        return {
            "t": round(b["t"], 3),
            "rounds": b["rounds"],
            "items": b["items"],
            "busy": round(min(b["device_s"] / BUCKET_S, 1.0), 4),
            "occupancy": round(b["items"] / b["cap"], 4) if b["cap"] else 0.0,
            "queue_max": b["queue_max"],
            "headroom_min": b["headroom_min"],
        }

    # -- serving-tier gauge -----------------------------------------------

    def _set_tier(self, subsystem: str, tier: int) -> None:
        if self._tiers.get(subsystem) == tier:
            return
        self._tiers[subsystem] = tier
        metrics.ServingTier.set(tier, subsystem)

    # -- postmortem latch -------------------------------------------------

    def _rearm(self) -> None:
        self._armed = True

    def _fail_closed(self, ev: dict) -> None:
        now = time.monotonic()
        with self._plock:
            if (not self._armed
                    and now - self._last_bundle_mono < self.debounce_s):
                self.bundles_suppressed += 1
                return
            self._armed = False
            self._last_bundle_mono = now
            # Snapshot NOW, under the latch: the triggering edge is the
            # ring's newest entry, so it lands LAST in the bundle and a
            # racing cascade edge cannot leak in ahead of the write.
            events = list(self.ring)
        trigger = f"{ev['table']}:{ev['edge'][0]}->{ev['edge'][1]}"
        t = threading.Thread(
            target=self._build_bundle, args=(trigger, ev, events),
            name="blackbox-postmortem", daemon=True,
        )
        t.start()

    def _build_bundle(self, trigger: str, ev: dict, events: list) -> None:
        """Enrich + persist + fan out one postmortem bundle.  Runs on
        its own daemon thread: fail-closed edges fire under service
        locks, and the status/stage providers take those same locks —
        a synchronous call here would self-deadlock.  Every sink is
        contained; a broken provider still yields a bundle."""
        bundle = {
            "trigger": trigger,
            "seq": ev.get("seq"),
            "t": ev.get("t"),
            "reason": ev.get("reason"),
            "events": events,
        }
        stage = self.stage_provider
        if stage is not None:
            try:
                bundle["stages"] = stage()
            except Exception:  # noqa: BLE001 -- enrichment is best-effort
                bundle["stages"] = None
        status = self.status_provider
        if status is not None:
            try:
                bundle["status"] = status()
            except Exception:  # noqa: BLE001 -- enrichment is best-effort
                bundle["status"] = None
        path = None
        if self.bundle_dir:
            try:
                os.makedirs(self.bundle_dir, exist_ok=True)
                fname = "postmortem_%06d_%s.json" % (
                    ev.get("seq") or 0,
                    "".join(c if c.isalnum() else "_" for c in trigger),
                )
                path = os.path.join(self.bundle_dir, fname)
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(bundle, f, indent=1, default=str)
                os.replace(tmp, path)
            except OSError:
                path = None
        summary = {
            "trigger": trigger,
            "seq": ev.get("seq"),
            "t": ev.get("t"),
            "reason": ev.get("reason"),
            "events": len(events),
            "path": path,
        }
        self.postmortems.append(summary)
        self.bundles_written += 1
        metrics.SidecarPostmortems.inc(ev.get("table", "mark"))
        mon = self.monitor
        if mon is not None:
            try:
                from ..monitor.monitor import (
                    MSG_TYPE_POSTMORTEM,
                    MonitorEvent,
                )

                mon.notify(MonitorEvent(MSG_TYPE_POSTMORTEM, summary))
            except Exception:  # noqa: BLE001 — sink must not poison path
                pass

    # -- read side ---------------------------------------------------------

    def events(self, n: int = 100, since: int = 0,
               table: str | None = None) -> list[dict]:
        """Oldest-first snapshot of the timeline, filtered by minimum
        seq and/or table — the MSG_TIMELINE read path."""
        out = [e for e in list(self.ring)
               if e["seq"] > since
               and (table is None or e["table"] == table)]
        return out[-max(int(n), 0):]

    def occupancy(self) -> list[dict]:
        """Closed occupancy buckets, oldest first, plus the open one."""
        with self._olock:
            out = list(self._obuckets)
            if self._ocur is not None:
                out.append(self._close_bucket(self._ocur))
        return out

    def status(self) -> dict:
        try:
            last_seq = self.ring[-1]["seq"]
        except IndexError:
            last_seq = 0
        last_pm = None
        try:
            last_pm = self.postmortems[-1]
        except IndexError:
            pass
        return {
            "events": len(self.ring),
            "ring": self.ring.maxlen,
            "seq": last_seq,
            "fail_closed_events": self.fail_closed_events,
            "postmortems": self.bundles_written,
            "postmortems_suppressed": self.bundles_suppressed,
            "last_postmortem": last_pm,
            "armed": self._armed,
            "tiers": dict(self._tiers),
            "slow_only": self.slow_only,
        }

    def dump(self, n: int = 100, since: int = 0,
             table: str | None = None) -> dict:
        """The full MSG_TIMELINE_REPLY payload."""
        return {
            "events": self.events(n=n, since=since, table=table),
            "occupancy": self.occupancy(),
            "postmortems": list(self.postmortems),
            "timeline": self.status(),
        }
