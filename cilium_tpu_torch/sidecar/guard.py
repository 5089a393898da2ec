"""Device quarantine state machine for the verdict hot path.

Per-packet-ML dataplanes treat bounded-latency degradation — not
availability loss — as the contract when the accelerator path stalls
(Taurus, arXiv:2002.08987; the kernel L7-offload line makes the same
call).  This module owns the state machine that enforces it for the
sidecar:

- a device call that exceeds the watchdog deadline (TPU stall, compile
  storm) **quarantines** the device: subsequent rounds bypass the
  device entirely and render verdicts through the bit-identical host
  fallback (the proxylib oracle / the device-assisted engines' host
  ``policy.matches`` path);
- repeated crashed rounds (a poisoned engine) quarantine the same way
  via ``record_failure``;
- while quarantined, traffic-driven **re-probes** run a real device
  call on a disposable executor under the same deadline; the first
  probe that completes heals the quarantine, so recovery is automatic
  and requires no operator action.

A stuck probe/worker thread cannot be cancelled in Python — it is
abandoned (daemon, bounded by one per probe interval) and its executor
discarded; the number of leaked threads is bounded by the number of
distinct stalls, not by traffic.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..analysis.protocols import (
    DEVICE_GUARD_PROTOCOL,
    DEVICE_LOST,
    DEVICE_OK,
    GUARD_QUARANTINED,
    GUARD_SERVING,
    MESH_DEVICE_PROTOCOL,
)
from . import blackbox

log = logging.getLogger(__name__)


class DeviceStall(Exception):
    """A device call exceeded the watchdog deadline."""


class DeviceGuard:
    """Quarantine latch + automatic re-probe.

    ``timeout_s`` bounds one device round (and one probe);
    ``reprobe_interval_s`` paces traffic-driven probes while
    quarantined; ``fail_threshold`` consecutive crashed rounds trip the
    quarantine without a stall (0 disables that trigger).
    ``on_change(quarantined: bool)`` fires on every transition (metrics
    / monitor hookup).
    """

    def __init__(
        self,
        timeout_s: float = 10.0,
        reprobe_interval_s: float = 1.0,
        fail_threshold: int = 3,
        on_change=None,
    ):
        self.timeout_s = timeout_s
        self.reprobe_interval_s = reprobe_interval_s
        self.fail_threshold = fail_threshold
        self.on_change = on_change
        self._lock = threading.Lock()
        # The quarantine latch is a DECLARED typestate (protocols.py):
        # every flip routes through DEVICE_GUARD_PROTOCOL.advance, and
        # the public ``quarantined`` bool is a read-only view.
        self._latch = GUARD_SERVING
        self.reason = ""
        self.stalls = 0
        self.quarantine_events = 0
        self.probes = 0
        self._crash_streak = 0
        # Set by record_failure, consumed by record_ok, cleared at
        # round_start (round-local): a round that CONTAINED a failure
        # (typed errors, host fallback) still completes, and its
        # record_ok must not reset the streak — only a genuinely clean
        # round does.
        self._tainted = False
        # Sticky variant for DEFERRED failures (a round's async
        # completion crashing on the send-loop thread, possibly in the
        # gap between dispatcher rounds): round_start must NOT erase it
        # — otherwise the next round's clean record_ok resets the
        # streak and an engine whose every deferred completion crashes
        # never reaches fail_threshold.  Consumed (without a reset) by
        # the next record_ok, like the original taint.
        self._sticky_taint = False
        # deferred_scope marks the calling thread so record_failure
        # picks sticky semantics without plumbing flags through every
        # engine hook / pump call site.
        self._tls = threading.local()
        self._probe_inflight = False
        self._last_probe = 0.0
        self._quarantined_at = 0.0
        # Per-device health table (the mesh width ladder's fault
        # attribution surface): one row per mesh device that ever
        # raised, stalled, or vanished from the backend's device set —
        # keyed by the stringified device id (JSON-safe for the
        # restart handoff).  "lost" rows are the devices the off-path
        # reshape holds out of the serving mesh; fault counters are
        # lifetime (a healed device keeps its history so a flapping
        # chip is visible to the operator).
        self._devices: dict[str, dict] = {}
        # Cumulative seconds spent quarantined (closed intervals; the
        # live interval is added in status()) — the "how long were we
        # on the host fallback" device-telemetry number.
        self._quarantined_total_s = 0.0

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    @property
    def quarantined(self) -> bool:
        return self._latch == GUARD_QUARANTINED

    # -- transitions ------------------------------------------------------

    def quarantine(self, reason: str) -> None:
        with self._lock:
            if self._latch == GUARD_QUARANTINED:
                return
            with blackbox.annotate(reason=reason):
                self._latch = DEVICE_GUARD_PROTOCOL.advance(
                    self._latch, GUARD_QUARANTINED
                )
            self.reason = reason
            self.quarantine_events += 1
            self._quarantined_at = time.monotonic()
            # The next probe may fire immediately.
            self._last_probe = 0.0
        log.warning("device quarantined: %s", reason)
        if self.on_change is not None:
            try:
                self.on_change(True)
            except Exception:  # noqa: BLE001 — hook must not poison state
                log.exception("quarantine on_change hook failed")

    def record_stall(self, reason: str = "device-stall") -> None:
        with self._lock:
            self.stalls += 1
        self.quarantine(reason)

    def record_failure(self, reason: str = "model-error",
                       sticky: bool = False) -> None:
        """One crashed/contained-failed dispatch round; quarantine on a
        streak of them.  ``sticky`` (or a surrounding deferred_scope)
        marks a deferred-completion failure whose taint must survive
        the next round_start."""
        with self._lock:
            self._crash_streak += 1
            if sticky or getattr(self._tls, "sticky", False):
                self._sticky_taint = True
            else:
                self._tainted = True
            trip = (
                self.fail_threshold
                and self._crash_streak >= self.fail_threshold
            )
        if trip:
            self.quarantine(f"{reason} x{self._crash_streak}")

    def deferred_scope(self, fn, *args, **kwargs):
        """Run ``fn`` with record_failure in STICKY mode: the send loop
        uses this around deferred round completions (entry2 finishes),
        whose pump/judge crashes land outside any dispatcher round and
        would otherwise be erased by the next round_start."""
        self._tls.sticky = True
        try:
            return fn(*args, **kwargs)
        finally:
            self._tls.sticky = False

    def round_start(self) -> None:
        """A new dispatch round begins: the ROUND-LOCAL taint is
        cleared.  A round that CRASHES never reaches record_ok, so its
        taint would otherwise survive and swallow the NEXT clean
        round's record_ok without resetting the streak — alternating
        crash/clean rounds would still accumulate to fail_threshold,
        contradicting the 'consecutive crashed rounds' semantics.  The
        sticky (deferred-failure) taint is deliberately NOT cleared
        here — it belongs to no dispatcher round and is consumed by
        the next record_ok instead."""
        with self._lock:
            self._tainted = False

    def record_ok(self) -> None:
        """End of a completed round: resets the streak ONLY if the
        round recorded no contained failure (a pump/judge crash that
        was answered with typed errors still counts toward the
        poisoned-engine streak)."""
        with self._lock:
            if self._tainted or self._sticky_taint:
                self._tainted = False
                self._sticky_taint = False
                return
            self._crash_streak = 0

    def _heal(self) -> None:
        with self._lock:
            if self._latch != GUARD_QUARANTINED:
                return
            with blackbox.annotate(reason="probe-heal"):
                self._latch = DEVICE_GUARD_PROTOCOL.advance(
                    self._latch, GUARD_SERVING
                )
            self.reason = ""
            self._crash_streak = 0
            self._tainted = False
            self._sticky_taint = False
            self._quarantined_total_s += (
                time.monotonic() - self._quarantined_at
            )
        log.warning("device un-quarantined (probe succeeded)")
        if self.on_change is not None:
            try:
                self.on_change(False)
            except Exception:  # noqa: BLE001
                log.exception("quarantine on_change hook failed")

    # -- per-device health (mesh width ladder) ----------------------------

    def record_device_fault(self, device, reason: str) -> None:
        """Attribute one mesh fault (readback error, stall, vanish) to
        a SPECIFIC device: the row flips to "lost" and the typed fault
        counter bumps.  The reshape/re-promotion ladder reads the lost
        set; the operator reads the lifetime counters."""
        key = str(device)
        with self._lock:
            row = self._devices.setdefault(
                key, {"state": DEVICE_OK, "faults": {}, "heals": 0}
            )
            with blackbox.annotate(reason=reason, device=key):
                row["state"] = MESH_DEVICE_PROTOCOL.advance(
                    row["state"], DEVICE_LOST
                )
            row["faults"][reason] = row["faults"].get(reason, 0) + 1
        log.warning("mesh device %s marked lost: %s", key, reason)

    def mark_device_ok(self, device) -> None:
        """A previously-lost device answered its probe: the row heals
        (state "ok", heal counter bumps) — fault history is kept."""
        key = str(device)
        with self._lock:
            row = self._devices.get(key)
            if row is None or row["state"] == DEVICE_OK:
                return
            with blackbox.annotate(reason="probe-heal", device=key):
                row["state"] = MESH_DEVICE_PROTOCOL.advance(
                    row["state"], DEVICE_OK
                )
            row["heals"] = row.get("heals", 0) + 1
        log.warning("mesh device %s healed (probe succeeded)", key)

    def lost_devices(self) -> list[str]:
        with self._lock:
            return sorted(
                k for k, r in self._devices.items()
                if r["state"] == DEVICE_LOST
            )

    def device_table(self) -> dict:
        """JSON-safe copy of the health table (status surface + the
        restart handoff snapshot)."""
        with self._lock:
            return {
                k: {
                    "state": r["state"],
                    "faults": dict(r["faults"]),
                    "heals": int(r.get("heals", 0)),
                }
                for k, r in sorted(self._devices.items())
            }

    # -- re-probe ---------------------------------------------------------

    def maybe_reprobe(self, probe_fn) -> None:
        """Traffic-driven: called once per dispatch round.  At most one
        probe in flight; paced by ``reprobe_interval_s``.  The probe
        runs ``probe_fn`` on a fresh single-thread executor bounded by
        ``timeout_s`` — a probe that hangs is abandoned with its
        executor and quarantine holds."""
        if not self.quarantined:
            return
        now = time.monotonic()
        with self._lock:
            if self._probe_inflight:
                return
            if now - self._last_probe < self.reprobe_interval_s:
                return
            self._probe_inflight = True
            self._last_probe = now
            self.probes += 1

        def run() -> None:
            ex = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="device-probe"
            )
            try:
                fut = ex.submit(probe_fn)
                fut.result(self.timeout_s or 5.0)
            except Exception:  # noqa: BLE001 — timeout or device error
                log.debug("device re-probe failed; quarantine holds")
            else:
                self._heal()
            finally:
                ex.shutdown(wait=False)
                with self._lock:
                    self._probe_inflight = False

        threading.Thread(
            target=run, daemon=True, name="device-reprobe"
        ).start()

    # -- restart handoff --------------------------------------------------

    def snapshot_state(self) -> dict:
        """Serialize the latch + lifetime counters for the service's
        restart handoff snapshot: a successor must inherit an open
        quarantine (the device did not heal just because the proxy
        restarted), and the operator's event counters must not reset
        to zero mid-incident.  Every field here is consumed by
        ``restore_state`` (lint R17 audits the pair)."""
        with self._lock:
            return {
                "quarantined": self.quarantined,
                "reason": self.reason,
                "stalls": self.stalls,
                "quarantine_events": self.quarantine_events,
                "probes": self.probes,
                "quarantined_total_s": self._quarantined_total_s,
                "devices": {
                    k: {
                        "state": r["state"],
                        "faults": dict(r["faults"]),
                        "heals": int(r.get("heals", 0)),
                    }
                    for k, r in self._devices.items()
                },
            }

    def restore_state(self, snap: dict) -> None:
        """Successor half: adopt the predecessor's latch.  Malformed or
        empty input restores nothing (cold guard state is fail-open
        toward the device, which is correct — the first stall re-trips
        the latch).  Restoring an OPEN quarantine re-arms the probe
        pacer so traffic heals it exactly as it would have in the
        predecessor — including a restart racing the heal probe: the
        in-flight probe died with the old process, the successor just
        probes again."""
        try:
            quarantined = snap["quarantined"]
            if not isinstance(quarantined, bool):
                # A JSON snapshot writes a real bool; anything else is
                # corruption — refuse the row whole (bool("garbage")
                # would silently restore an OPEN quarantine).
                return
            reason = str(snap.get("reason", ""))
            stalls = int(snap.get("stalls", 0))
            events = int(snap.get("quarantine_events", 0))
            probes = int(snap.get("probes", 0))
            total_s = float(snap.get("quarantined_total_s", 0.0))
        except (KeyError, TypeError, ValueError):
            return
        # Versioned-in per-device health table (.get: absent in
        # pre-PR-17 snapshots).  Rows are type-checked individually —
        # a malformed row is dropped, never half-restored (a wrongly
        # "lost" device would keep a healthy chip out of the mesh).
        devices: dict = {}
        for k, r in (snap.get("devices") or {}).items():
            if not isinstance(r, dict):
                continue
            state = r.get("state")
            if state not in (DEVICE_OK, DEVICE_LOST):
                continue
            try:
                faults = {
                    str(fk): int(fv)
                    for fk, fv in (r.get("faults") or {}).items()
                }
                heals = int(r.get("heals", 0))
            except (TypeError, ValueError):
                continue
            devices[str(k)] = {
                "state": state, "faults": faults, "heals": heals,
            }
        with self._lock:
            self.stalls = stalls
            self.quarantine_events = events
            self.probes = probes
            self._quarantined_total_s = total_s
            if devices:
                self._devices = devices
            if quarantined and self._latch != GUARD_QUARANTINED:
                with blackbox.annotate(reason=reason or "restored"):
                    self._latch = DEVICE_GUARD_PROTOCOL.advance(
                        self._latch, GUARD_QUARANTINED
                    )
                self.reason = reason or "restored"
                self._quarantined_at = time.monotonic()
                self._last_probe = 0.0  # probe may fire immediately

    # -- observability ----------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            total = self._quarantined_total_s
            if self.quarantined:
                total += time.monotonic() - self._quarantined_at
            out = {
                "quarantined": self.quarantined,
                "reason": self.reason,
                "stalls": self.stalls,
                "quarantine_events": self.quarantine_events,
                "probes": self.probes,
                "quarantined_total_s": round(total, 3),
            }
            if self.quarantined:
                out["quarantined_for_s"] = round(
                    time.monotonic() - self._quarantined_at, 3
                )
            if self._devices:
                out["devices"] = {
                    k: {
                        "state": r["state"],
                        "faults": dict(r["faults"]),
                        "heals": int(r.get("heals", 0)),
                    }
                    for k, r in sorted(self._devices.items())
                }
            return out
