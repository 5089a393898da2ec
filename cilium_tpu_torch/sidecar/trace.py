"""Latency decomposition for the verdict hot path.

The north star is ≥1M L7 verdicts/sec/chip at <1ms added p99, but a
number like that is only actionable when the serving path can say WHERE
a verdict's millisecond goes.  This module owns that decomposition:

- **Stage stamps, per round.**  The service stamps each dispatch round
  at its stage boundaries (admit → queue-pop → batch-form →
  device-submit → device-complete → drain → send) and a
  :class:`RoundTrace` turns consecutive stamps into stage durations.
  Everything is recorded per ROUND (one ``Histogram.observe`` per stage
  per round, one e2e observe per wire batch) — never per entry — so the
  always-on cost is O(rounds), not O(verdicts).  The device stage ends
  at a **fenced readback** (the service's ``_to_host`` of the output,
  behind its CUDA event), not at the launch's return, which comes before
  the kernels run and would book device time as zero and host dispatch
  as compute.
- **Sampled spans + slow exemplars.**  A lock-light ring buffer keeps
  1-in-N full per-entry spans plus an exemplar for every wire batch
  whose end-to-end latency exceeds ``slow_ms`` — so a specific slow
  request can be NAMED (seq, conn, path, stage breakdown), the way the
  reference pairs always-on counters with a proxy accesslog.  Slow
  exemplars optionally fan out to the monitor stream and to an access
  logger (``LogRecord.latency``).
- **Device telemetry.**  Batch-occupancy and device-busy-fraction
  gauges, fed from the same round stamps.

Timebase: ``time.monotonic()`` throughout, matching the wire batches'
``arrival``/deadline bookkeeping.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils import metrics

# Serving-path labels (the degradation ladder, fastest first).
PATH_CACHED = "cached"    # established-flow verdict cache (no device)
PATH_VEC = "vec"          # vectorized device path (matrix/vec rounds)
PATH_ORACLE = "oracle"    # entrywise slow path (engines + parsers)
PATH_HOST = "host"        # quarantine host-fallback rounds
PATH_SHED = "shed"        # typed SHED (queue_full / deadline / stall)

# Stage names, in pipeline order.  Each is the duration between two
# consecutive stamp boundaries of a round.
STAGE_RING = "ring"                # shm slot commit -> doorbell drain
STAGE_QUEUE = "queue"              # admit (wire ingress) -> queue pop
STAGE_SWAP = "table_swap"          # round blocked behind an epoch swap
STAGE_REASM = "reasm"              # columnar reassembly (arena ingest +
#                                    frame scan + bucket pack) — carved
#                                    out of batch_form like table_swap
STAGE_CACHE = "cache"              # verdict-cache mask + hit rendering
#                                    (established-flow short-circuit) —
#                                    carved out of batch_form the same
#                                    way; a cached round's only real
#                                    work shows up here
STAGE_FORM = "batch_form"          # pop -> device batch assembled
STAGE_SUBMIT = "device_submit"     # assembled -> device calls issued
STAGE_DEVICE = "device"            # issued -> fenced readback complete
STAGE_DRAIN = "drain"              # complete -> responses built
STAGE_SEND = "send"                # built -> verdict frames written

STAGES = (STAGE_RING, STAGE_QUEUE, STAGE_SWAP, STAGE_REASM, STAGE_CACHE,
          STAGE_FORM, STAGE_SUBMIT, STAGE_DEVICE, STAGE_DRAIN, STAGE_SEND)


class RoundTrace:
    """Stamp carrier for one dispatch round (one path group).

    Created at queue-pop, stamped at each boundary, finished once the
    round's verdict frames are on the wire.  Stamps are idempotent
    (first writer wins) so paths that skip a boundary inherit the
    previous one and the stage reads as zero instead of negative.
    """

    __slots__ = ("path", "n", "t_admit", "t_pop", "t_form", "t_submit",
                 "t_complete", "t_drain", "t_send", "ring_s", "swap_s",
                 "reasm_s", "cache_s", "formation")

    def __init__(self, path: str, n: int, t_admit: float, t_pop: float,
                 ring_s: float = 0.0, swap_s: float = 0.0):
        self.path = path
        self.n = n
        # t_admit is the OLDEST covered wire batch's ingress stamp, so
        # the queue stage reports the round's worst queue wait.
        self.t_admit = t_admit or t_pop
        self.t_pop = t_pop
        self.t_form = 0.0
        self.t_submit = 0.0
        self.t_complete = 0.0
        self.t_drain = 0.0
        self.t_send = 0.0
        # Shared-memory transport: worst slot-commit → doorbell-drain
        # wait across the round's batches.  Carved OUT of the queue
        # stage (arrival is the slot-commit stamp for ring batches) so
        # the decomposition shows what the copy elimination bought.
        self.ring_s = ring_s
        # Time this round spent blocked behind a policy-epoch table
        # swap (the pointer flip holds the round-snapshot lock).
        # Carved OUT of batch_form so a swap stall is visible as its
        # own stage instead of reading as batch-assembly cost.
        self.swap_s = swap_s
        # Columnar-reassembly work (arena ingest + frame scan + bucket
        # pack, sidecar/reasm.py) — carved out of batch_form the same
        # way, so the mixed-path decomposition names the reassembler's
        # cost instead of folding it into batch assembly.
        self.reasm_s = 0.0
        # Verdict-cache work (vectorized hit mask + cached-frame
        # rendering) — carved out of batch_form like reasm; for a
        # fully-cached round this IS the round's host cost.
        self.cache_s = 0.0
        # Batch-formation provenance (sidecar/ledger.py): the
        # dispatcher's per-round pop stamp — trigger, queue depth,
        # oldest-entry age and bytes at issue — captured at
        # begin_round from the popping thread.  None when the round
        # was begun off the dispatch path (no stamp, no guess).
        self.formation = None

    def formed(self) -> None:
        if not self.t_form:
            self.t_form = time.monotonic()

    def submitted(self) -> None:
        if not self.t_submit:
            self.t_submit = time.monotonic()

    def completed(self) -> None:
        if not self.t_complete:
            self.t_complete = time.monotonic()

    def drained(self) -> None:
        if not self.t_drain:
            self.t_drain = time.monotonic()

    def stages(self) -> dict[str, float]:
        """Stage durations in seconds (>= 0; skipped boundaries fall
        back to the previous stamp, reading as a zero-length stage)."""
        t_pop = self.t_pop
        t_form = self.t_form or t_pop
        t_submit = self.t_submit or t_form
        t_complete = self.t_complete or t_submit
        t_drain = self.t_drain or t_complete
        t_send = self.t_send or t_drain
        wait = max(t_pop - self.t_admit, 0.0)
        ring = min(max(self.ring_s, 0.0), wait)
        form = max(t_form - t_pop, 0.0)
        swap = min(max(self.swap_s, 0.0), form)
        reasm = min(max(self.reasm_s, 0.0), form - swap)
        cache = min(max(self.cache_s, 0.0), form - swap - reasm)
        return {
            STAGE_RING: ring,
            STAGE_QUEUE: wait - ring,
            STAGE_SWAP: swap,
            STAGE_REASM: reasm,
            STAGE_CACHE: cache,
            STAGE_FORM: form - swap - reasm - cache,
            STAGE_SUBMIT: max(t_submit - t_form, 0.0),
            STAGE_DEVICE: max(t_complete - t_submit, 0.0),
            STAGE_DRAIN: max(t_drain - t_complete, 0.0),
            STAGE_SEND: max(t_send - t_drain, 0.0),
        }


class VerdictTracer:
    """Per-service latency tracer: stage histograms, a bounded span
    ring, slow exemplars, occupancy/busy gauges.

    Lock-light by design: the ring is a ``deque(maxlen=...)`` (GIL-
    atomic appends), the per-stage accumulators take ONE short lock per
    round, and the sampled-span decision is a counter compare.  Nothing
    here is per-entry.
    """

    # Device-busy gauge window (seconds of wall clock per update).
    BUSY_WINDOW_S = 1.0

    def __init__(self, *, sample_every: int = 4096, slow_ms: float = 50.0,
                 ring: int = 512, stage_metrics: bool = True,
                 batch_capacity: int = 1):
        self.sample_every = max(int(sample_every), 0)
        self.slow_s = slow_ms / 1e3
        self.stage_metrics = stage_metrics
        self.batch_capacity = max(int(batch_capacity), 1)
        self._ring: deque = deque(maxlen=max(int(ring), 1))
        self._lock = threading.Lock()
        # (stage, path) -> [rounds, total_seconds] — the status()
        # aggregate (the registry histograms are process-global; these
        # are THIS service's numbers).
        self._acc: dict[tuple[str, str], list] = {}
        self.rounds = 0
        self.entries = 0
        self.spans_sampled = 0
        self.slow_exemplars = 0
        self.shed_spans = 0
        self._sample_credit = 0
        # Device-busy window accounting.
        self._win_start = time.monotonic()
        self._win_device_s = 0.0
        # Optional fan-out for slow exemplars.
        self.monitor = None          # monitor.Monitor (notify())
        self.access_logger = None    # accesslog.logger.AccessLogger (log())
        # Optional flight recorder (blackbox.FlightRecorder): fed the
        # same per-round numbers the busy gauge uses, so the occupancy
        # time-series costs no extra stamps.
        self.recorder = None
        # Optional device ledger (ledger.DeviceLedger): fed the
        # formation stamp the dispatcher left on the popping thread —
        # one stamp_round per round, riding this same close.
        self.ledger = None

    # -- round lifecycle --------------------------------------------------

    def begin_round(self, path: str, n: int, t_admit: float,
                    t_pop: float | None = None,
                    ring_s: float = 0.0,
                    swap_s: float = 0.0) -> RoundTrace:
        rt = RoundTrace(path, n, t_admit, t_pop or time.monotonic(),
                        ring_s, swap_s)
        # The dispatcher stamps formation provenance on the thread that
        # popped (or inlined) the round; begin_round runs on that same
        # thread, so the capture is a plain attribute read.
        rt.formation = getattr(
            threading.current_thread(), "_disp_pop", None
        )
        return rt

    def finish_round(self, rt: RoundTrace, batches=()) -> None:
        """Close a round: observe each stage once, the e2e histogram
        once per covered wire batch, refresh the gauges, and capture
        sampled/slow spans.  ``batches`` is an iterable of
        ``(seq, n, arrival, conn0)`` describing the wire batches the
        round answered."""
        now = time.monotonic()
        if not rt.t_send:
            rt.t_send = now
        stages = rt.stages()
        path = rt.path
        if self.stage_metrics:
            h = metrics.VerdictStageSeconds
            if stages[STAGE_RING]:
                # Socket rounds have no ring stage; observing a
                # permanent zero would just pad the histogram.
                h.observe(stages[STAGE_RING], STAGE_RING, path)
            if stages[STAGE_SWAP]:
                # Only rounds that actually blocked behind an epoch
                # swap carry the stage (same rationale as ring).
                h.observe(stages[STAGE_SWAP], STAGE_SWAP, path)
            if stages[STAGE_REASM]:
                # Only columnar-reassembly rounds carry the stage
                # (same rationale as ring/table_swap).
                h.observe(stages[STAGE_REASM], STAGE_REASM, path)
            h.observe(stages[STAGE_QUEUE], STAGE_QUEUE, path)
            h.observe(stages[STAGE_FORM], STAGE_FORM, path)
            h.observe(stages[STAGE_SUBMIT], STAGE_SUBMIT, path)
            h.observe(stages[STAGE_DEVICE], STAGE_DEVICE, path)
            h.observe(stages[STAGE_DRAIN], STAGE_DRAIN, path)
            h.observe(stages[STAGE_SEND], STAGE_SEND, path)
            metrics.VerdictBatchOccupancy.set(
                min(rt.n / self.batch_capacity, 1.0)
            )
        with self._lock:
            self.rounds += 1
            self.entries += rt.n
            for stage in STAGES:
                rec = self._acc.get((stage, path))
                if rec is None:
                    rec = self._acc[(stage, path)] = [0, 0.0]
                rec[0] += 1
                rec[1] += stages[stage]
            # Device-busy fraction, windowed.
            self._win_device_s += stages[STAGE_DEVICE]
            span = now - self._win_start
            if span >= self.BUSY_WINDOW_S:
                if self.stage_metrics:
                    metrics.DeviceBusyFraction.set(
                        min(self._win_device_s / span, 1.0)
                    )
                self._win_start = now
                self._win_device_s = 0.0
            sample = False
            if self.sample_every:
                self._sample_credit += rt.n
                if self._sample_credit >= self.sample_every:
                    self._sample_credit %= self.sample_every
                    sample = True
        for desc in batches:
            # Descs are (seq, n, arrival, conn0[, session]) — the
            # session id rides along where the fan-in seam knows it, so
            # an exemplar can be attributed to one shim (pod).
            seq, n, arrival, conn0 = desc[0], desc[1], desc[2], desc[3]
            session = desc[4] if len(desc) > 4 else 0
            e2e = max(rt.t_send - (arrival or rt.t_admit), 0.0)
            if self.stage_metrics:
                metrics.VerdictE2ESeconds.observe(e2e, path)
            slow = e2e >= self.slow_s
            if sample or slow:
                self._span(
                    "slow" if slow else "sample", path, seq, n, conn0,
                    e2e, stages, session=session,
                )
                sample = False  # one sampled span per round
        rec = self.recorder
        if rec is not None:
            try:
                rec.sample_round(rt.n, self.batch_capacity,
                                 stages[STAGE_DEVICE], now)
            except Exception:  # noqa: BLE001 — recorder must not cost the round
                pass
        led = self.ledger
        form = rt.formation
        if led is not None and form is not None:
            try:
                led.stamp_round(
                    form.get("trigger", "idle-greedy"), rt.n,
                    self.batch_capacity,
                    depth=form.get("depth", 0),
                    age_s=form.get("age_s", 0.0),
                    bytes_at_issue=form.get("bytes", 0),
                )
            except Exception:  # noqa: BLE001 — ledger must not cost the round
                pass

    def record_shed(self, seq: int, n: int, arrival: float, conn0: int,
                    reason: str, session: int = 0) -> None:
        """A typed SHED answered this wire batch: record its e2e under
        the shed path (its only real stage is queue wait) and keep an
        exemplar — shed entries are the tail the decomposition exists
        to explain."""
        now = time.monotonic()
        e2e = max(now - arrival, 0.0) if arrival else 0.0
        if self.stage_metrics:
            metrics.VerdictE2ESeconds.observe(e2e, PATH_SHED)
            metrics.VerdictStageSeconds.observe(e2e, STAGE_QUEUE, PATH_SHED)
        with self._lock:
            self.shed_spans += 1
            rec = self._acc.get((STAGE_QUEUE, PATH_SHED))
            if rec is None:
                rec = self._acc[(STAGE_QUEUE, PATH_SHED)] = [0, 0.0]
            rec[0] += 1
            rec[1] += e2e
        self._span("shed", PATH_SHED, seq, n, conn0, e2e,
                   {STAGE_QUEUE: e2e}, reason=reason, session=session)

    # -- spans / exemplars ------------------------------------------------

    def _span(self, kind: str, path: str, seq: int, n: int, conn0: int,
              e2e: float, stages: dict, reason: str = "",
              session: int = 0) -> None:
        span = {
            "kind": kind,
            "path": path,
            "seq": int(seq),
            "entries": int(n),
            "conn_id": int(conn0),
            "e2e_us": round(e2e * 1e6, 1),
            "stages_us": {
                k: round(v * 1e6, 1) for k, v in stages.items()
            },
            "ts": time.time(),
        }
        if session:
            span["session"] = int(session)
        if reason:
            span["reason"] = reason
        self._ring.append(span)
        metrics.VerdictTraceSpans.inc(kind)
        if kind == "sample":
            with self._lock:
                self.spans_sampled += 1
            return
        if kind == "slow":
            # Shed spans are counted in record_shed (shed_spans) only:
            # booking them here too would read as a latency-threshold
            # breach that never happened under pure overload.
            with self._lock:
                self.slow_exemplars += 1
        self._emit_slow(span)

    def _emit_slow(self, span: dict) -> None:
        """Fan a slow/shed exemplar out to the monitor stream and the
        access log (both optional, both contained — an exemplar sink
        failure never touches the serving path)."""
        mon = self.monitor
        if mon is not None:
            try:
                from ..monitor.monitor import MSG_TYPE_TRACE, MonitorEvent

                mon.notify(
                    MonitorEvent(MSG_TYPE_TRACE, {"slow_verdict": span})
                )
            except Exception:  # noqa: BLE001 — sink must not poison path
                pass
        logger = self.access_logger
        if logger is not None:
            try:
                logger.log(accesslog_record_for_span(span))
            except Exception:  # noqa: BLE001
                pass

    def spans(self, n: int = 100, kind: str | None = None,
              session: int | None = None) -> list[dict]:
        """Most-recent-first snapshot of the span ring.  ``session``
        filters to spans attributed to one fan-in session (`cilium
        sidecar trace --session`)."""
        out = [s for s in reversed(list(self._ring))
               if (kind is None or s["kind"] == kind)
               and (session is None or s.get("session") == session)]
        return out[: max(int(n), 0)]

    # -- status -----------------------------------------------------------

    def status(self) -> dict:
        """Per-stage means (µs) by path for `cilium sidecar status`,
        plus the span/exemplar counters.  p99 column comes from the
        process-global stage histogram (bucket upper bound)."""
        with self._lock:
            acc = {k: list(v) for k, v in self._acc.items()}
            out = {
                "rounds": self.rounds,
                "entries": self.entries,
                "spans_sampled": self.spans_sampled,
                "slow_exemplars": self.slow_exemplars,
                "shed_spans": self.shed_spans,
                "sample_every": self.sample_every,
                "slow_threshold_ms": round(self.slow_s * 1e3, 3),
            }
        stages: dict[str, dict] = {}
        for (stage, path), (count, total) in sorted(acc.items()):
            p99 = metrics.VerdictStageSeconds.quantile(0.99, stage, path)
            stages.setdefault(path, {})[stage] = {
                "rounds": count,
                "mean_us": round(total / count * 1e6, 1) if count else 0.0,
                "p99_us": round(p99 * 1e6, 1) if p99 is not None else None,
            }
        out["stages"] = stages
        return out


def format_stages_us(stages_us: dict) -> str:
    """Render a span's stage breakdown for humans, largest stage first,
    sub-µs noise dropped — THE one definition shared by the monitor
    stream's SLOW-VERDICT line and `cilium sidecar trace` (they must
    never drift: an operator correlates one against the other)."""
    return " ".join(
        f"{k}={v:.0f}us"
        for k, v in sorted(stages_us.items(), key=lambda kv: -kv[1])
        if v >= 1.0
    )


def accesslog_record_for_span(span: dict):
    """Annotate a slow-verdict exemplar onto a canonical access-log
    record (the accesslog analog of the monitor event): a Sample-type
    LogRecord whose ``latency`` field carries the stage breakdown."""
    from ..accesslog.record import (
        FLOW_TYPE_SAMPLE,
        LatencyInfo,
        LogRecord,
        L7LogEntry,
    )

    return LogRecord(
        type=FLOW_TYPE_SAMPLE,
        info=(
            f"slow verdict: path={span['path']} seq={span['seq']} "
            f"conn={span['conn_id']} e2e={span['e2e_us']:.0f}us"
        ),
        l7=L7LogEntry(proto="verdict-trace", fields={
            "kind": span["kind"],
            **({"reason": span["reason"]} if span.get("reason") else {}),
        }),
        latency=LatencyInfo(
            total_us=span["e2e_us"],
            path=span["path"],
            stages_us=dict(span["stages_us"]),
        ),
    )
