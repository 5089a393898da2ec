"""Per-node bounded flow-record ring, populated per ROUND.

Emission contract (the R7 rule that keeps observability off the hot
path): decision layers hand the log ONE columnar batch per dispatch
round — numpy arrays of conn ids / verdict codes / rule ids — never a
per-entry append under the lock.  Per-record dicts are materialized
lazily at QUERY time (`cilium observe`, MSG_OBSERVE), so the serving
path pays O(rounds) lock trips and a few vectorized aggregations, like
sidecar/trace.py's span ring.

Side effects per round, all aggregated:

- ``flow_verdicts_total{verdict,path,match_kind}`` counter increments,
  one per distinct label tuple in the round (numpy bincount, not a
  Python loop over entries);
- bounded POLICY-VERDICT monitor events, gated by the
  ``PolicyVerdictNotification`` runtime option (the previously-dead
  ``OPTION_POLICY_VERDICT_NOTIFY``) — the reference's policy-verdict
  perf events under the same rate-limit philosophy as
  datapath/notify.py's drop sample.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

import numpy as np

from ..utils import metrics
from ..utils.option import OPTION_POLICY_VERDICT_NOTIFY
from .record import (
    CODE_DENIED,
    CODE_FORWARDED,
    CODE_NAMES,
    CT_NAMES,
    MATCH_NONE,
    materialize,
)

# Per-round cap on monitor policy-verdict events (the perf-ring analog
# cap, mirroring datapath/notify.MAX_DROP_NOTIFICATIONS).
MAX_VERDICT_NOTIFICATIONS = 64


class _RoundBatch:
    """One round's worth of flow records, columnar."""

    __slots__ = ("seq0", "ts", "path", "conn_ids", "codes", "rules",
                 "kinds", "reason", "cols", "epoch")

    def __init__(self, seq0, ts, path, conn_ids, codes, rules, kinds,
                 reason, cols, epoch=-1):
        self.seq0 = seq0
        self.ts = ts
        self.path = path
        self.conn_ids = conn_ids    # [n] int64
        self.codes = codes          # [n] int8 (CODE_*)
        self.rules = rules          # [n] int32 (-1 = unattributed)
        self.kinds = kinds          # tuple[str, ...] per-rule legend
        self.reason = reason
        self.cols = cols            # extra columnar fields or None
        # Policy-table epoch the round's verdicts were decided against
        # (-1 = pre-epoch layer).  Round-wide: one serving model per
        # round batch; entrywise rounds carry a per-entry "epoch" col
        # instead, which overrides at materialize time.
        self.epoch = epoch

    @property
    def count(self) -> int:
        return len(self.conn_ids)


class FlowLog:
    """Bounded per-node flow-record ring with per-round emission.

    ``capacity`` bounds the total RECORD count (oldest rounds evicted
    whole).  ``opts`` is the runtime OptionMap consulted for the
    policy-verdict monitor gate; ``monitor`` the event sink.  Both are
    optional and may be attached after construction (the service wires
    the ring first, the daemon/test wires the sinks)."""

    def __init__(self, capacity: int = 8192, opts=None, monitor=None):
        self.capacity = max(int(capacity), 1)
        self.opts = opts
        self.monitor = monitor
        self._lock = threading.Lock()
        self._rounds: deque[_RoundBatch] = deque()
        self._records = 0  # records currently held across rounds
        self._seq = 0      # next record seq (monotonic, never reused)
        self.rounds_total = 0
        self.records_total = 0
        # conn metadata registry: conn_id -> meta tuple (record.py
        # materialize docstring).  Live conns in _meta; closed conns
        # keep their last-known meta in a bounded LRU so records
        # emitted before the close still materialize with context.
        self._meta: dict[int, tuple] = {}
        self._stale_meta: OrderedDict[int, tuple] = OrderedDict()
        self._stale_cap = 4096

    # -- conn metadata ----------------------------------------------------

    def register_conn(self, conn_id: int, policy_name: str, ingress: bool,
                      src_id: int, dst_id: int, src_addr: str,
                      dst_addr: str, proto: str, port: int,
                      session: int = 0) -> None:
        with self._lock:
            self._meta[int(conn_id)] = (
                policy_name, bool(ingress), int(src_id), int(dst_id),
                src_addr, dst_addr, proto, int(port), int(session),
            )

    def forget_conn(self, conn_id: int) -> None:
        with self._lock:
            meta = self._meta.pop(int(conn_id), None)
            if meta is not None:
                self._stale_meta[int(conn_id)] = meta
                self._stale_meta.move_to_end(int(conn_id))
                while len(self._stale_meta) > self._stale_cap:
                    self._stale_meta.popitem(last=False)

    def _meta_for(self, conn_id: int) -> tuple | None:
        return self._meta.get(conn_id) or self._stale_meta.get(conn_id)

    # -- emission (per ROUND — never per entry) ---------------------------

    def add_round(self, path: str, conn_ids, codes, rules=None,
                  kinds: tuple = (), reason: str = "",
                  cols: dict | None = None, epoch: int = -1) -> None:
        """Record one round's decisions.  ``conn_ids``/``codes`` are
        parallel arrays; ``rules`` the per-entry deciding-rule row
        (-1 = unattributed) and ``kinds`` the per-RULE match-kind
        legend of the serving model.  ``cols`` carries optional extra
        columnar fields (datapath identity/ct columns).  ``epoch`` is
        the policy-table epoch the round's verdicts were decided
        against — captured WITH the kinds legend at decision time, so a
        rule id is never resolved against a table it did not index
        (per-entry cols["epoch"] overrides for mixed rounds)."""
        conn_ids = np.asarray(conn_ids, np.int64)
        n = len(conn_ids)
        if n == 0:
            return
        codes = np.asarray(codes, np.int8)
        rules = (
            np.full(n, -1, np.int32) if rules is None
            else np.asarray(rules, np.int32)
        )
        ts = time.time()
        batch = _RoundBatch(
            0, ts, path, conn_ids, codes, rules, tuple(kinds), reason,
            cols, epoch=int(epoch),
        )
        self._count_metrics(path, codes, rules, batch.kinds, cols)
        with self._lock:
            batch.seq0 = self._seq
            self._seq += n
            self._rounds.append(batch)
            self._records += n
            self.rounds_total += 1
            self.records_total += n
            while self._records > self.capacity and len(self._rounds) > 1:
                self._records -= self._rounds.popleft().count
        # Monitor fan-out OUTSIDE the ring lock: notify() takes its own
        # mutex and must never be able to invert against ours.
        self._notify_verdicts(batch)

    def add_entries(self, path: str, entries: list, kinds: tuple = (),
                    reason: str = "") -> None:
        """Entrywise-round convenience: ``entries`` is a per-round list
        of (conn_id, code, rule) built by the caller; converted to one
        columnar batch (ONE add_round — the hot loop builds a plain
        list, the lock is taken once)."""
        if not entries:
            return
        self.add_round(
            path,
            np.fromiter((e[0] for e in entries), np.int64, len(entries)),
            np.fromiter((e[1] for e in entries), np.int8, len(entries)),
            np.fromiter((e[2] for e in entries), np.int32, len(entries)),
            kinds=kinds,
            reason=reason,
        )

    def _count_metrics(self, path, codes, rules, kinds, cols) -> None:
        """Aggregate flow_verdicts_total{verdict,path,match_kind} for
        the round: one counter inc per DISTINCT label tuple (numpy
        throughout — never a Python loop over entries)."""
        r = len(kinds)
        # Map each entry to a kind index: rule row -> its kind, -1 (or
        # out-of-range) -> the "none" slot r.  Packet-layer rounds with
        # a match_kind column override per entry.
        kind_legend = list(kinds) + [MATCH_NONE]
        if cols and "match_kind" in cols:
            legend_arr, kind_idx = np.unique(
                np.asarray(cols["match_kind"]), return_inverse=True
            )
            kind_legend = [str(k) for k in legend_arr]
        else:
            rr = np.asarray(rules, np.int64)
            kind_idx = np.where((rr >= 0) & (rr < r), rr, r)
        nk = len(kind_legend)
        flat = np.asarray(codes, np.int64) * nk + kind_idx
        counts = np.bincount(flat, minlength=len(CODE_NAMES) * nk)
        for key in np.flatnonzero(counts):
            code, ki = divmod(int(key), nk)
            metrics.FlowVerdictsTotal.inc(
                CODE_NAMES[code], path, kind_legend[ki],
                amount=int(counts[key]),
            )

    def _notify_verdicts(self, batch: _RoundBatch) -> None:
        mon = self.monitor
        opts = self.opts
        if mon is None or opts is None:
            return
        if not opts.get(OPTION_POLICY_VERDICT_NOTIFY):
            return
        try:
            from ..monitor.monitor import (
                MSG_TYPE_POLICY_VERDICT,
                MonitorEvent,
            )

            idx = np.flatnonzero(
                (batch.codes == CODE_FORWARDED) | (batch.codes == CODE_DENIED)
            )[:MAX_VERDICT_NOTIFICATIONS]
            for i in idx:
                rec = self._materialize(batch, int(i))
                allowed = batch.codes[i] == CODE_FORWARDED
                # Deny verdicts are POLICY-VERDICT events too (the
                # reference's send_policy_verdict_notify covers both
                # directions); emitting MSG_TYPE_DROP here would
                # double-count against the feeding layer's own drop
                # sample when both share a monitor.
                mon.notify(
                    MonitorEvent(
                        MSG_TYPE_POLICY_VERDICT,
                        {
                            "src_identity": rec.get("src_identity", 0),
                            "dst_identity": rec.get("dst_identity", 0),
                            "dport": rec.get("dport", 0),
                            "proto": rec.get("proto", 0),
                            "allowed": bool(allowed),
                            "verdict": rec["verdict"],
                            "path": rec["path"],
                            "rule_id": rec["rule_id"],
                            "match_kind": rec["match_kind"],
                            "policy": rec.get("policy", ""),
                        },
                    )
                )
        except Exception:  # noqa: BLE001 — sink must not poison the path
            pass

    # -- query ------------------------------------------------------------

    def _materialize(self, b: _RoundBatch, i: int) -> dict:
        rule = int(b.rules[i])
        kind = (
            b.kinds[rule] if 0 <= rule < len(b.kinds) else MATCH_NONE
        )
        extra = None
        epoch = b.epoch
        if b.cols:
            extra = {}
            for name, col in b.cols.items():
                v = col[i]
                if name == "ct_state":
                    v = CT_NAMES[int(v)] if 0 <= int(v) < len(CT_NAMES) else ""
                elif isinstance(v, np.generic):
                    v = v.item()
                extra[name] = v
            kind = extra.pop("match_kind", kind)
            epoch = int(extra.pop("epoch", epoch))
        if epoch >= 0:
            extra = dict(extra or {})
            extra["epoch"] = epoch
        return materialize(
            b.seq0 + i, b.ts, b.path, b.conn_ids[i], int(b.codes[i]),
            rule, kind, self._meta_for(int(b.conn_ids[i])),
            reason=b.reason, extra=extra,
        )

    def query(self, n: int = 100, verdict: str | None = None,
              path: str | None = None, rule: int | None = None,
              conn: int | None = None, since: int | None = None,
              epoch: int | None = None,
              session: int | None = None) -> list[dict]:
        """Filtered record dicts.  Without ``since``: the newest ``n``
        matches, newest first.  With ``since``: records with
        seq > since in ASCENDING order (the `--follow` cursor
        contract).  ``session`` filters on the fan-in shim session the
        record's conn registered through (joined via the conn-metadata
        registry at query time — the serving path stores bare conn
        ids)."""
        n = max(int(n), 0)
        if session is not None:
            session = int(session)
        if verdict is not None and verdict not in CODE_NAMES:
            # Unknown verdict name (MSG_OBSERVE is raw JSON): nothing
            # can match — returning unfiltered records here would read
            # as "everything was <verdict>".
            return []
        with self._lock:
            rounds = list(self._rounds)
        want_code = (
            CODE_NAMES.index(verdict) if verdict is not None else None
        )
        out: list[dict] = []
        it = rounds if since is not None else reversed(rounds)
        for b in it:
            if since is not None and b.seq0 + b.count <= since + 1:
                continue
            if path is not None and b.path != path:
                continue
            sel = np.arange(b.count)
            if epoch is not None:
                if b.cols is not None and "epoch" in b.cols:
                    sel = sel[
                        np.asarray(b.cols["epoch"])[sel] == epoch
                    ]
                elif b.epoch != epoch:
                    continue
            if want_code is not None:
                sel = sel[b.codes[sel] == want_code]
            if rule is not None:
                sel = sel[b.rules[sel] == rule]
            if conn is not None:
                sel = sel[b.conn_ids[sel] == conn]
            if session is not None and len(sel):
                # Query-path-only join: resolve each candidate conn's
                # registered session (cold path — the hot path never
                # touches the meta registry).
                keep = []
                for i in sel:
                    meta = self._meta_for(int(b.conn_ids[i]))
                    sid = meta[8] if meta is not None and len(meta) > 8 \
                        else 0
                    if sid == session:
                        keep.append(i)
                sel = np.asarray(keep, sel.dtype)
            if since is not None:
                sel = sel[b.seq0 + sel > since]
            idxs = sel if since is not None else sel[::-1]
            for i in idxs:
                out.append(self._materialize(b, int(i)))
                if len(out) >= n:
                    return out
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "records": self._records,
                "rounds": len(self._rounds),
                "records_total": self.records_total,
                "rounds_total": self.rounds_total,
                "next_seq": self._seq,
            }
