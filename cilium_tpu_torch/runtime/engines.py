"""Per-protocol runtime batch engines: the HTTP and Kafka engines.

Counterpart of ``cilium_tpu/runtime/engines.py`` (``EngineFlow``,
``BaseBatchEngine``, ``HttpBatchEngine`` and ``KafkaBatchEngine``) with a
port model inside: one device-to-host copy per batch (per width bucket
for HTTP) brings back every verdict array.  The runtime analog of the
reference's proxy dispatch (reference: pkg/proxy/proxy.go:229-236 — HTTP
to Envoy, Kafka to the Go proxy): the engine buffers flow bytes, frames
complete requests, runs the batched verdict model, and converts verdicts
into filter ops (PASS/DROP + inject), preserving the OnIO contract
(reference: envoy/cilium_proxylib.cc:125).  The engines dispatch through
the mesh rung (``_judge_dispatch``): a raising sharded model
(``parallel.rulesharding``) flips the engine to its single-card fallback.
``_daemon_mesh`` resolves a daemon's verdict mesh from its config, and
``create_engine_for_redirect`` is the redirect -> engine factory that
``proxy.ProxyManager`` calls: it compiles the redirect's resolved
``L4Filter`` (``models.builder``) on the daemon's verdict device.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..accesslog import (
    HttpLogEntry,
    KafkaLogEntry,
    LogRecord,
    VERDICT_DENIED,
    VERDICT_FORWARDED,
)
from ..device import config_device
from ..kafka import matches_rule, parse_request
from ..kafka.request import KafkaParseError, frame_length
from ..models.base import ConstVerdict
from ..models.builder import build_model_for_filter
from ..models.kafka import encode_requests
from ..policy.api import KAFKA_REVERSE_API_KEY_MAP
from ..policy.invariance import InvariantClaimEngine
from ..policy.l4 import PARSER_TYPE_HTTP, PARSER_TYPE_KAFKA
from ..proxylib.parsers.http import HTTP_403, head_and_body_len
from ..proxylib.types import DROP, MORE, PASS, OpType
from ..utils import flowdebug, metrics

log = logging.getLogger(__name__)

# Per-flow debug stream, flowdebug-gated (one boolean when disabled).
_flow_log = logging.getLogger("cilium_tpu_torch.runtime.flow")


@dataclass
class EngineFlow:
    flow_id: int
    remote_id: int
    dst_id: int = 0
    ingress: bool = True
    buffer: bytearray = field(default_factory=bytearray)
    ops: list[tuple[OpType, int]] = field(default_factory=list)
    reply_inject: bytearray = field(default_factory=bytearray)
    inject_capacity: int = 4096
    # Set when the engine decides the connection must die (unparseable
    # framing); every subsequent byte drops without re-parsing
    # (reference: the kafka proxy closes the connection on parse errors,
    # pkg/proxy/kafka.go handleRequest error path).
    closed: bool = False


class BaseBatchEngine(InvariantClaimEngine):
    """Shared flow/buffer management (the OnIO byte accounting)."""

    proto = ""

    def __init__(self, capacity: int = 2048, logger=None, monitor=None,
                 flowlog=None):
        self.capacity = capacity
        self.logger = logger
        self.monitor = monitor
        # Flow-record sink (flowlog/ring.py): subclasses emit ONE
        # columnar round per _step — never per-request appends.
        self.flowlog = flowlog
        self.flows: dict[int, EngineFlow] = {}

    def flow(self, flow_id: int, remote_id: int = 0, **kw) -> EngineFlow:
        st = self.flows.get(flow_id)
        if st is None:
            st = EngineFlow(flow_id=flow_id, remote_id=remote_id, **kw)
            self.flows[flow_id] = st
        return st

    def _judge_dispatch(self, call):
        """Mesh rung for the daemon-side engines (the sidecar service
        has its own in _mesh_guarded): a raising SHARDED dispatch
        flips this engine to the wrapper's single-card fallback —
        typed mesh_demotions_total{engine-judge} — and reissues the
        round on it, never a crashed step.  Single-card models have
        no fallback and re-raise unchanged."""
        try:
            return call(self.model)
        except Exception:
            fb = getattr(self.model, "fallback", None)
            if fb is None:
                raise
            log.exception(
                "sharded judge failed; engine demoted to single-card"
            )
            metrics.MeshDemotions.inc("engine-judge")
            self.model = fb
            return call(fb)

    def feed(self, flow_id: int, data: bytes, remote_id: int = 0, **kw) -> None:
        self.flow(flow_id, remote_id, **kw).buffer += data

    def close_flow(self, flow_id: int) -> None:
        self.flows.pop(flow_id, None)

    def take_ops(self, flow_id: int):
        st = self.flows[flow_id]
        ops, inject = st.ops, bytes(st.reply_inject)
        st.ops = []
        st.reply_inject = bytearray()
        return ops, inject

    def pump(self) -> None:
        while self._step():
            pass
        for st in self.flows.values():
            if st.buffer and (not st.ops or st.ops[-1][0] != MORE):
                st.ops.append((MORE, 1))

    def _step(self) -> bool:
        raise NotImplementedError

    def _record_round(self, entries: list, kinds: tuple = ()) -> None:
        """One flow-record batch per engine step; ``entries`` is
        [(flow_id, allow, rule)] built by the step's hot loop."""
        if self.flowlog is None or not entries:
            return
        from ..flowlog import CODE_DENIED, CODE_FORWARDED, PATH_ENGINE

        self.flowlog.add_entries(
            PATH_ENGINE,
            [
                (fid, CODE_FORWARDED if allow else CODE_DENIED, rule)
                for fid, allow, rule in entries
            ],
            kinds=kinds,
        )

    def _emit(self, st: EngineFlow, allow: bool, n: int,
              inject: bytes = b"", record: LogRecord | None = None) -> None:
        flowdebug.log(
            _flow_log, "flow %d %s %s n=%d",
            st.flow_id, self.proto or type(self).__name__,
            "PASS" if allow else "DROP", n,
        )
        if allow:
            st.ops.append((PASS, n))
        else:
            room = st.inject_capacity - len(st.reply_inject)
            st.reply_inject += inject[: max(room, 0)]
            st.ops.append((DROP, n))
        del st.buffer[:n]
        if record is not None and self.logger is not None:
            record.verdict = VERDICT_FORWARDED if allow else VERDICT_DENIED
            record.source.identity = st.remote_id
            record.destination.identity = st.dst_id
            self.logger.log(record)


class HttpBatchEngine(BaseBatchEngine):
    """HTTP request-head framing + device verdicts + 403 injection
    (reference: envoy/cilium_l7policy.cc request path)."""

    proto = "http"

    # Fixed width/row buckets: padded shapes are drawn from these sets,
    # so one oversized head does not widen the whole batch.
    MIN_WIDTH = 512
    MAX_WIDTH = 1 << 15  # heads beyond this are judged as DENY (absurd)
    MIN_ROWS = 64

    def __init__(self, model, cache_enabled: bool = False, **kw):
        super().__init__(**kw)
        self.model = model
        # Verdict-cache offload tier (gated — cache-off is the true
        # baseline): heads of an identity whose claim is byte-invariant
        # are judged host-side with the claimed rule row, never encoded
        # into the device batch.
        self.cache_enabled = cache_enabled

    def _width_bucket(self, head_len: int) -> int:
        w = self.MIN_WIDTH
        while w < head_len:
            w *= 2
        return w

    def prewarm(self) -> None:
        """Build and load the kernels and run one pass at the two smallest
        bucket widths up front, so first requests never pay a build."""
        if isinstance(self.model, ConstVerdict):
            return
        for w in (self.MIN_WIDTH, 2 * self.MIN_WIDTH):
            out = self.model(
                np.zeros((self.MIN_ROWS, w), np.uint8),
                np.zeros((self.MIN_ROWS,), np.int32),
                np.zeros((self.MIN_ROWS,), np.int32),
            )
            out[-1].cpu()

    def _step(self) -> bool:
        active: list[tuple[EngineFlow, int, int]] = []
        for st in self.flows.values():
            # One framing implementation for both HTTP paths (streaming
            # parser + this engine) so fixes cannot diverge.
            r = head_and_body_len(bytes(st.buffer))
            if r is not None:
                active.append((st, r[0], r[1]))
        if not active:
            return False
        active = active[: self.capacity]

        if isinstance(self.model, ConstVerdict):
            for st, head_len, body_len in active:
                self._emit_http(st, bool(self.model.allow), head_len, body_len)
            self._record_round(
                [(st.flow_id, bool(self.model.allow), -1)
                 for st, _, _ in active]
            )
            return True

        recs: list[tuple[int, bool, int]] = []
        # Group flows into per-width buckets so one oversized head does
        # not force a wide scan for everyone.
        buckets: dict[int, list[tuple[EngineFlow, int, int]]] = {}
        cache_hits = 0
        for st, head_len, body_len in active:
            if head_len > self.MAX_WIDTH:
                # Pathological request head: deny without a device pass.
                self._emit_http(st, False, head_len, body_len)
                recs.append((st.flow_id, False, -1))
                continue
            if self.cache_enabled:
                claim = self.verdict_invariant(st.remote_id)
                if claim is not None and claim[0]:
                    # Byte-invariant allow: the verdict AND the
                    # first-match row are independent of the head's
                    # bytes — judged host-side, no device row (deny
                    # claims keep the normal path so per-frame 403
                    # injection framing is never skipped).
                    self._emit_http(st, True, head_len, body_len)
                    recs.append((st.flow_id, True, claim[1]))
                    cache_hits += 1
                    continue
            buckets.setdefault(
                self._width_bucket(head_len), []
            ).append((st, head_len, body_len))
        for width, group in sorted(buckets.items()):
            f_pad = self.MIN_ROWS
            while f_pad < len(group):
                f_pad *= 2
            data = np.zeros((f_pad, width), np.uint8)
            lengths = np.zeros((f_pad,), np.int32)
            remotes = np.zeros((f_pad,), np.int32)
            for i, (st, head_len, _) in enumerate(group):
                data[i, :head_len] = np.frombuffer(
                    bytes(st.buffer[:head_len]), np.uint8
                )
                lengths[i] = head_len
                remotes[i] = st.remote_id
            # Attribution only when a record sink is wired: without a
            # flowlog the rule index would be computed, read back, and
            # dropped.
            if self.flowlog is not None:
                outs = self._judge_dispatch(
                    lambda m: m.verdicts_attr(data, lengths, remotes)
                )
            else:
                outs = self._judge_dispatch(
                    lambda m: m(data, lengths, remotes)
                )
            # One device-to-host copy for every verdict array of the bucket.
            host = torch.stack([t.to(torch.int32) for t in outs]).cpu().numpy()
            allow = host[2] != 0
            rule = host[3] if self.flowlog is not None else None
            for i, (st, head_len, body_len) in enumerate(group):
                self._emit_http(st, bool(allow[i]), head_len, body_len)
                recs.append((
                    st.flow_id, bool(allow[i]),
                    int(rule[i]) if rule is not None else -1,
                ))
        if cache_hits:  # one batched inc per step, never per entry
            metrics.VerdictCacheHits.inc("engine", amount=cache_hits)
        self._record_round(recs, getattr(self.model, "match_kinds", ()))
        return True

    def _emit_http(self, st: EngineFlow, allow: bool, head_len: int,
                   body_len: int) -> None:
        head = bytes(st.buffer[:head_len])
        line = head.split(b"\r\n", 1)[0].decode("utf-8", "replace")
        parts = line.split(" ")
        method = parts[0] if parts else ""
        url = parts[1] if len(parts) > 1 else ""
        rec = LogRecord(
            http=HttpLogEntry(
                code=200 if allow else 403, method=method, url=url
            )
        )
        self._emit(st, allow, head_len + body_len, HTTP_403, rec)


class KafkaBatchEngine(BaseBatchEngine):
    """Kafka frame parse + device topic-ACL verdicts + error injection
    (reference: pkg/proxy/kafka.go:233 handleRequest)."""

    proto = "kafka"

    def __init__(self, model, host_rows=None, **kw):
        super().__init__(**kw)
        self.model = model
        # (remotes, PortRuleKafka) rows for host fallback on overflow.
        self.host_rows = host_rows or []

    def _host_allow(self, req, remote_id: int) -> bool:
        rules = [
            rule for remotes, rule in self.host_rows
            if not remotes or remote_id in remotes
        ]
        return matches_rule(req, rules)

    def _step(self) -> bool:
        active = []
        for st in self.flows.values():
            if st.closed:
                # Connection condemned by an earlier framing error: every
                # byte drops unparsed until the datapath tears it down.
                if st.buffer:
                    self._emit(st, False, len(st.buffer))
                continue
            buf = bytes(st.buffer)
            try:
                n = frame_length(buf)
            except KafkaParseError:
                # Unparseable framing: drop the buffer AND condemn the
                # connection (reference: the kafka proxy closes the
                # connection on parse errors, kafka.go handleRequest) —
                # subsequent bytes are misframed garbage.
                st.closed = True
                self._emit(st, False, len(buf))
                continue
            if n is None or len(buf) < n:
                continue
            try:
                req = parse_request(buf[:n])
            except KafkaParseError:
                self._emit(st, False, n)
                continue
            active.append((st, n, req))
        if not active:
            return False
        active = active[: self.capacity]

        if isinstance(self.model, ConstVerdict):
            for st, n, req in active:
                self._emit_kafka(st, bool(self.model.allow), n, req)
            return True

        batch = encode_requests([req for _, _, req in active])
        remotes = np.asarray(
            [st.remote_id for st, _, _ in active], np.int32
        )
        # One explicit device-to-host copy: np.asarray of a CUDA tensor
        # raises.
        allow = self._judge_dispatch(
            lambda m: m(batch, remotes)
        ).cpu().numpy()
        recs = []
        for i, (st, n, req) in enumerate(active):
            a = bool(allow[i])
            if batch.overflow[i]:
                # Device refused to judge: exact host-oracle decision.
                a = self._host_allow(req, st.remote_id)
            self._emit_kafka(st, a, n, req)
            recs.append((st.flow_id, a, -1))
        self._record_round(recs)
        return True

    def _emit_kafka(self, st: EngineFlow, allow: bool, n: int, req) -> None:
        rec = LogRecord(
            kafka=KafkaLogEntry(
                error_code=0 if allow else 29,
                api_version=req.api_version,
                api_key=KAFKA_REVERSE_API_KEY_MAP.get(
                    req.api_key, str(req.api_key)
                ),
                correlation_id=req.correlation_id,
                topics=list(req.topics),
            )
        )
        inject = b"" if allow else req.create_response().raw
        self._emit(st, allow, n, inject, rec)


def _daemon_device(daemon):
    """The daemon's verdict device: ``"cpu"`` when its config asks for
    the CPU (``verdict_device="cpu"``), else None (the card)."""
    return config_device(getattr(daemon, "config", None))


def _daemon_mesh(daemon):
    """The daemon's (flows, rules) verdict mesh: honors a pre-set
    ``daemon.verdict_mesh`` (tests/embedders), otherwise resolves
    ONCE from the daemon's DaemonConfig mesh knobs (same resolution
    as the sidecar service — parallel/mesh.serving_mesh) and caches
    the answer on the daemon.  The slots are the config's verdict
    device's (``local_devices``: every card, or one CPU slot).  None =
    single-card builds."""
    mesh = getattr(daemon, "verdict_mesh", None)
    if mesh is not None or getattr(daemon, "_verdict_mesh_resolved",
                                   False):
        return mesh
    cfg = getattr(daemon, "config", None)
    if cfg is not None and getattr(cfg, "mesh", "off") != "off":
        from ..parallel import mesh as mesh_mod

        try:
            mesh = mesh_mod.serving_mesh(
                cfg.mesh, getattr(cfg, "mesh_rule_shards", 0),
                getattr(cfg, "mesh_flow_shards", 0),
                devices=mesh_mod.local_devices(_daemon_device(daemon)),
            )
        except Exception:  # noqa: BLE001 — fail to single-card, typed
            log.exception("verdict mesh resolution failed; "
                          "single-card builds")
            mesh = None
    try:
        daemon.verdict_mesh = mesh
        daemon._verdict_mesh_resolved = True
    except Exception:  # noqa: BLE001 — slotted/frozen daemon doubles
        pass
    return mesh


def create_engine_for_redirect(daemon, redirect):
    """Factory wired into ProxyManager (reference dispatch:
    pkg/proxy/proxy.go:229-236).  The model lands on the daemon's mesh
    when it has one, else on its verdict device (``_daemon_device``)."""
    f = redirect.l4_filter
    if f is None:
        return None
    identity_cache = daemon.get_identity_cache()
    t0 = time.perf_counter()
    model = build_model_for_filter(
        f, identity_cache, mesh=_daemon_mesh(daemon),
        device=_daemon_device(daemon),
    )
    # Daemon-side engine builds land in any installed device ledger by
    # broadcast (the daemon holds no service handle); cause rides the
    # enclosing scope, cold by default.
    try:
        from ..sidecar import ledger as _ledger

        _ledger.broadcast_compile(
            str(f.l7_parser or "l7"), time.perf_counter() - t0,
            kind="engine-build",
        )
    except Exception:  # noqa: BLE001 — ledger must not cost the build
        pass
    common = dict(
        logger=daemon.access_logger,
        monitor=daemon.monitor,
        flowlog=getattr(daemon, "flowlog", None),
    )
    if f.l7_parser == PARSER_TYPE_HTTP:
        return HttpBatchEngine(
            model,
            cache_enabled=getattr(
                getattr(daemon, "config", None), "flow_cache", False
            ),
            **common,
        )
    if f.l7_parser == PARSER_TYPE_KAFKA:
        from .engines_util import kafka_host_rows

        return KafkaBatchEngine(
            model, host_rows=kafka_host_rows(f, identity_cache), **common
        )
    # Generic L7 (r2d2/cassandra/memcached/...): served by the proxylib
    # pipeline (cilium_tpu_torch.proxylib + runtime.batch for r2d2).
    return None
