"""Device-economics ledger: compile accounting + batch-formation provenance.

The flight recorder (PR 19) answers *what incident happened*; the
stage traces (PR 4) answer *where a round spent its time*.  This
module answers the two remaining economic questions that gate ROADMAP
items 4 and 5:

- **Why did a compile happen?**  Every executable-producing site —
  the kernels' nvcc build, the service's CUDA-graph caches
  (``_jit_for`` / ``_model_call`` / ``_model_call_attr`` /
  ``_gathered_call``),
  prewarm, the policy-builder's swap/rebind/mesh-reshape/re-promotion
  rebuilds, and the daemon-side engine builders — routes through ONE
  choke point, :meth:`DeviceLedger.record_compile`, which stamps the
  event with a **cause** from a closed taxonomy (:data:`CAUSES`), the
  shape signature, rule bucket, mesh layout, engine family, wall
  seconds, epoch, and an on-dispatch-path flag.  Events land in a
  bounded ring plus ``device_compiles_total{cause,family}`` /
  ``device_compile_seconds`` histograms and an executables-resident
  gauge.  Two folklore claims become *asserted invariants*: warm
  churn performs ZERO compiles (the churn soak asserts the churn-*
  cause counters stay flat across a warm window) and no compile ever
  lands on the dispatch path (``dispatch_path_compiles`` stays 0).

- **Why was a batch issued?**  Every dispatch round is stamped with
  its formation **trigger** (:data:`TRIGGERS`), occupancy fraction,
  queue depth, oldest-entry age at pop, and bytes at issue — one
  stamp per ROUND, never per entry, riding the existing
  ``VerdictTracer.finish_round`` cadence next to the blackbox
  occupancy sample.  Per-trigger µs-bucket histograms plus a small
  per-trigger accumulator make item 4's tier-switching policy
  decidable from recorded data.

Causes are communicated to the choke point through a thread-local
scope stack (:class:`cause_scope`), mirroring ``blackbox.annotate``:
the policy builder wraps a swap rebuild in
``with ledger.cause_scope("churn-new-shape", epoch=...)`` and every
compile recorded on that thread inside the block inherits the cause.
A compile recorded with no scope and no explicit cause is ``cold`` —
the safe default that makes an unlabeled site visible rather than
silently miscounted.  The dispatch-path flag needs no site
cooperation: the dispatcher already brands its worker thread with
``_disp_round`` for the round's lifetime, so the ledger reads it.

Multiple services coexist in one process (hitless-handoff tests), so
ledgers register in a module tuple like the flight recorders;
:func:`broadcast_compile` is the entry point for code with no service
handle (the daemon-side engine builder).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from ..utils import metrics

# Closed cause taxonomy — every recorded compile carries exactly one.
CAUSE_COLD = "cold"                      # first build of an engine/shape
CAUSE_PREWARM = "prewarm"                # off-path warm at build/swap
CAUSE_CHURN_NEW_SHAPE = "churn-new-shape"  # policy churn grew a new bucket
CAUSE_CHURN_VOCAB = "churn-vocab"        # same bucket, new automaton vocab
CAUSE_MESH_RESHAPE = "mesh-reshape"      # degraded-mesh rebuild
CAUSE_REPROMOTION = "repromotion"        # heal walking back up the ladder
CAUSE_HEAL_REBIND = "heal-rebind"        # kvstore/daemon rebind rebuild

CAUSES = (
    CAUSE_COLD, CAUSE_PREWARM, CAUSE_CHURN_NEW_SHAPE, CAUSE_CHURN_VOCAB,
    CAUSE_MESH_RESHAPE, CAUSE_REPROMOTION, CAUSE_HEAL_REBIND,
)

# What produced an executable (the ``kind`` field of a compile event):
# the CUDA kernels are built by one nvcc per source, once per process; a
# jit-mode dispatch captures one CUDA graph per model and bucket shape;
# an engine build compiles its host automata and uploads its tables.
KIND_NVCC_BUILD = "nvcc-build"
KIND_GRAPH_CAPTURE = "cuda-graph-capture"
KIND_ENGINE_BUILD = "engine-build"

KINDS = (KIND_NVCC_BUILD, KIND_GRAPH_CAPTURE, KIND_ENGINE_BUILD)

# Closed formation-trigger taxonomy — every dispatch round carries
# exactly one (the dispatcher classifies at pop).
TRIGGER_SIZE_FULL = "size-full"      # pending weight reached max_batch
TRIGGER_FLUSH = "flush"              # stop()/drain pop
TRIGGER_DEADLINE = "deadline"        # batch window expired with a partial
TRIGGER_IDLE_GREEDY = "idle-greedy"  # timeout<=0 greedy issue on idle
TRIGGER_CUT_THROUGH = "cut-through"  # inline round, queue bypassed

TRIGGERS = (
    TRIGGER_SIZE_FULL, TRIGGER_FLUSH, TRIGGER_DEADLINE,
    TRIGGER_IDLE_GREEDY, TRIGGER_CUT_THROUGH,
)

# The churn-cause subset the "warm churn performs zero compiles"
# invariant is asserted over.
CHURN_CAUSES = frozenset({CAUSE_CHURN_NEW_SHAPE, CAUSE_CHURN_VOCAB})


# -- thread-local cause scopes --------------------------------------------

_SCOPE = threading.local()


class cause_scope:
    """Attach a compile cause (plus correlation ids) to every compile
    recorded on this thread while the block is live.  Nestable; the
    innermost scope wins — a mesh-reshape rebuild that calls the
    common prewarm helper still records ``prewarm`` for the inner
    warms only if the helper opens its own scope."""

    __slots__ = ("ids",)

    def __init__(self, cause: str, **ids):
        self.ids = dict(ids)
        self.ids["cause"] = cause

    def __enter__(self):
        stack = getattr(_SCOPE, "stack", None)
        if stack is None:
            stack = _SCOPE.stack = []
        stack.append(self.ids)
        return self

    def __exit__(self, *exc):
        _SCOPE.stack.pop()
        return False


def current_scope() -> dict | None:
    stack = getattr(_SCOPE, "stack", None)
    if not stack:
        return None
    if len(stack) == 1:
        return stack[0]
    merged: dict = {}
    for d in stack:
        merged.update(d)
    return merged


def _on_dispatch_path() -> bool:
    """True when the calling thread is inside a dispatch round — the
    dispatcher brands its worker thread with ``_disp_round`` for the
    round's lifetime (and the cut-through path brands the caller
    thread the same way), so no site cooperation is needed."""
    return getattr(threading.current_thread(), "_disp_round", None) is not None


# -- process-wide registry ------------------------------------------------

_REG_LOCK = threading.Lock()
_LEDGERS: tuple = ()


def broadcast_compile(family: str, seconds: float, **fields) -> None:
    """Record a compile on every installed ledger — the entry point
    for code with no service handle (the daemon-side engine builder).
    No-op when nothing is installed."""
    for led in _LEDGERS:
        try:
            led.record_compile(family, seconds, **fields)
        except Exception:  # noqa: BLE001 -- accounting must never fail its caller
            pass


class DeviceLedger:
    """Always-on, bounded, lock-light compile/formation ledger for one
    service (see module docstring for the design contract)."""

    def __init__(self, *, ring: int = 256):
        self.ring: deque = deque(maxlen=max(int(ring), 1))
        self._seq = itertools.count(1)
        # Compile-side totals.  Mutated under _clock: compiles are
        # control-plane rate (builder threads, never per entry), so a
        # short lock keeps cross-thread counts exact for the asserted
        # invariants.
        self._clock = threading.Lock()
        self.compiles_total = 0
        self.compile_seconds = 0.0
        self.by_cause: dict = {c: 0 for c in CAUSES}
        self.dispatch_path_compiles = 0
        # One definition of "executable resident": shape keys counted
        # in on first cache insert, counted out by SHAPE_CACHE_MAX
        # eviction and epoch retirement.  The set (not a bare int)
        # also answers "is this shape already resident" — the signal
        # that splits churn-new-shape from churn-vocab.
        self._resident: set = set()
        # Previously-resident keys (bounded, insertion-ordered): the
        # evict-then-reuse signal — a re-trace of a key found here is
        # churn cost (churn-new-shape), not a cold start.
        self._evicted: dict = {}
        # Formation side: per-trigger accumulators, one short lock
        # trip per ROUND (same cadence contract as the blackbox
        # occupancy sample — never per entry).
        self._flock = threading.Lock()
        self._formation: dict = {}
        self.rounds_total = 0

    # -- install / uninstall ----------------------------------------------

    def install(self) -> "DeviceLedger":
        global _LEDGERS
        with _REG_LOCK:
            if self not in _LEDGERS:
                _LEDGERS = _LEDGERS + (self,)
        return self

    def uninstall(self) -> None:
        global _LEDGERS
        with _REG_LOCK:
            _LEDGERS = tuple(x for x in _LEDGERS if x is not self)

    # -- compile ledger (the choke point) ----------------------------------

    def record_compile(self, family: str, seconds: float, *,
                       cause: str | None = None, shape=None, rules=None,
                       mesh=None, epoch=None, **ids) -> dict:
        """THE executable-producing choke point.  Every jit trace,
        automaton compile, or engine build in the serving tree calls
        this exactly once per produced executable (lint R23 proves
        it).  Cause resolution: explicit argument, else the innermost
        thread-local :class:`cause_scope`, else ``cold``."""
        scope = current_scope()
        if cause is None:
            cause = (scope or {}).get("cause", CAUSE_COLD)
        on_path = _on_dispatch_path()
        ev = {
            "seq": next(self._seq),
            "t": time.time(),
            "cause": cause,
            "family": str(family),
            "seconds": round(float(seconds), 6),
            "on_dispatch_path": on_path,
        }
        if shape is not None:
            ev["shape"] = self._sig(shape)
        if rules is not None:
            ev["rules"] = rules
        if mesh is not None:
            ev["mesh"] = mesh
        if scope:
            for k, v in scope.items():
                if k != "cause":
                    ev.setdefault(k, v)
        if epoch is not None:
            ev["epoch"] = epoch
        if ids:
            ev.update(ids)
        with self._clock:
            self.compiles_total += 1
            self.compile_seconds += float(seconds)
            self.by_cause[cause] = self.by_cause.get(cause, 0) + 1
            if on_path:
                self.dispatch_path_compiles += 1
            self.ring.append(ev)
        metrics.DeviceCompilesTotal.inc(cause, str(family))
        metrics.DeviceCompileSeconds.observe(float(seconds), cause)
        return ev

    @staticmethod
    def _sig(shape) -> str:
        """Stable, JSON-safe rendering of a shape key/signature."""
        try:
            return repr(shape)
        except Exception:  # noqa: BLE001 -- a weird key must not fail the record
            return "<unrenderable>"

    # -- resident-executables gauge ----------------------------------------

    def executable_resident(self, key) -> bool:
        """Count a shape-keyed executable in.  Returns True when the
        key was ALREADY resident — the evict-then-reuse signal that
        makes a re-trace ``churn-new-shape``/``churn-vocab`` rather
        than ``cold`` in the caller's bookkeeping."""
        with self._clock:
            known = key in self._resident
            self._resident.add(key)
            self._evicted.pop(key, None)
            n = len(self._resident)
        metrics.ExecutablesResident.set(n)
        return known

    def executable_evicted(self, key) -> None:
        """Count a shape-keyed executable out (SHAPE_CACHE_MAX
        eviction, epoch retirement) — the single decrement site the
        prewarm bookkeeping dedupes against."""
        with self._clock:
            if key in self._resident:
                self._resident.discard(key)
                self._evicted[key] = True
                while len(self._evicted) > 1024:
                    self._evicted.pop(next(iter(self._evicted)))
            n = len(self._resident)
        metrics.ExecutablesResident.set(n)

    def is_resident(self, key) -> bool:
        with self._clock:
            return key in self._resident

    def was_evicted(self, key) -> bool:
        with self._clock:
            return key in self._evicted

    @property
    def executables_resident(self) -> int:
        with self._clock:
            return len(self._resident)

    # -- batch-formation provenance ----------------------------------------

    def stamp_round(self, trigger: str, n: int, capacity: int,
                    depth: int = 0, age_s: float = 0.0,
                    bytes_at_issue: int = 0) -> None:
        """Fold one dispatch round's formation stamp into the
        per-trigger accumulator.  Called from
        ``VerdictTracer.finish_round`` — once per ROUND, never per
        entry."""
        cap = max(int(capacity), 1)
        occ = min(int(n) / cap, 1.0)
        with self._flock:
            self.rounds_total += 1
            acc = self._formation.get(trigger)
            if acc is None:
                acc = self._formation[trigger] = {
                    "rounds": 0, "items": 0, "occ_sum": 0.0,
                    "age_sum": 0.0, "age_max": 0.0,
                    "depth_max": 0, "bytes": 0,
                }
            acc["rounds"] += 1
            acc["items"] += int(n)
            acc["occ_sum"] += occ
            acc["age_sum"] += float(age_s)
            if age_s > acc["age_max"]:
                acc["age_max"] = float(age_s)
            if depth > acc["depth_max"]:
                acc["depth_max"] = int(depth)
            acc["bytes"] += int(bytes_at_issue)
        metrics.BatchFormationRounds.inc(trigger)
        metrics.BatchFormationAge.observe(max(float(age_s), 0.0), trigger)

    # -- read side ---------------------------------------------------------

    def events(self, n: int = 100, since: int = 0,
               cause: str | None = None) -> list[dict]:
        """Oldest-first snapshot of the compile ring, filtered by
        minimum seq and/or cause — the MSG_LEDGER read path."""
        with self._clock:
            snap = list(self.ring)
        out = [e for e in snap
               if e["seq"] > since
               and (cause is None or e["cause"] == cause)]
        return out[-max(int(n), 0):]

    def formation(self) -> dict:
        """Per-trigger formation summary with derived means."""
        with self._flock:
            snap = {k: dict(v) for k, v in self._formation.items()}
        for acc in snap.values():
            r = acc["rounds"] or 1
            acc["occ_mean"] = round(acc.pop("occ_sum") / r, 4)
            acc["age_mean_s"] = round(acc.pop("age_sum") / r, 6)
            acc["age_max_s"] = round(acc.pop("age_max"), 6)
        return snap

    def status(self) -> dict:
        with self._clock:
            last_seq = self.ring[-1]["seq"] if self.ring else 0
            by_cause = {c: n for c, n in self.by_cause.items() if n}
            return {
                "compiles": self.compiles_total,
                "compile_seconds": round(self.compile_seconds, 6),
                "by_cause": by_cause,
                "churn_compiles": sum(
                    n for c, n in self.by_cause.items()
                    if c in CHURN_CAUSES),
                "dispatch_path_compiles": self.dispatch_path_compiles,
                "executables_resident": len(self._resident),
                "rounds": self.rounds_total,
                "seq": last_seq,
                "ring": self.ring.maxlen,
            }

    def dump(self, n: int = 100, since: int = 0,
             cause: str | None = None) -> dict:
        """The full MSG_LEDGER_REPLY payload."""
        return {
            "compiles": self.events(n=n, since=since, cause=cause),
            "formation": self.formation(),
            "ledger": self.status(),
        }
