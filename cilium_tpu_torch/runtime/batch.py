"""Flow-batching engine: buffered streams -> device batches -> filter ops.

Counterpart of ``cilium_tpu/runtime/batch.py`` with a port model inside:
one device-to-host copy per chunk brings back every verdict array.

Maps the streaming OnData contract (reference: proxylib/proxylib/
connection.go:118-174) onto fixed-shape device dispatch:

- each flow keeps a byte buffer (the datapath's retained-data buffer in the
  reference, see parserfactory.go:34-40)
- one engine step packs the first unconsumed frame of every active flow
  into a [F, L] batch, runs the model once, and converts per-flow verdicts
  into (PASS n | DROP n + inject) ops, consuming the frame
- flows whose buffer holds no complete frame get MORE (retain bytes)
- steps repeat until no flow has a complete frame (multi-frame buffers
  drain across steps, preserving per-flow op order)

Verdict-op mapping is the r2d2 parser's (reference: r2d2parser.go:188-213):
allow -> PASS msg_len; deny -> inject b"ERROR\\r\\n" into the reply
direction + DROP msg_len; reply direction always passes.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.base import ConstVerdict
from ..policy.invariance import InvariantClaimEngine
from ..proxylib.accesslog import EntryType, LogEntry
from ..proxylib.types import DROP, ERROR, MORE, PASS, OpError, OpType
from ..utils import flowdebug

# Per-flow debug stream, flowdebug-gated (one boolean when disabled).
_flow_log = logging.getLogger("cilium_tpu_torch.runtime.flow")


@dataclass
class FlowState:
    flow_id: int
    remote_id: int
    policy_name: str = ""
    ingress: bool = True
    dst_id: int = 0
    src_addr: str = ""
    dst_addr: str = ""
    buffer: bytearray = field(default_factory=bytearray)
    ops: list[tuple[OpType, int]] = field(default_factory=list)
    reply_inject: bytearray = field(default_factory=bytearray)
    # Mirrors the streaming path's caller-owned inject buffer capacity
    # (reference: connection.go:190-209): injected bytes beyond this are
    # truncated, never buffered unboundedly.
    inject_capacity: int = 1024
    # Set when the flow exceeded the retained-bytes cap: the buffer was
    # dropped with a typed protocol-error op sequence and the flow is
    # dead (the caller closes the connection on the ERROR result).
    overflowed: bool = False
    # Rule attribution of the most recent device verdict on this flow
    # (flattened first-match row, -1 = denied/unattributed) — read by
    # the service's flow-record emission for pump-path entries.
    last_rule_id: int = -1


class R2d2BatchEngine(InvariantClaimEngine):
    """Batch engine for the r2d2 model (the flagship end-to-end slice).

    Framing is parameterized through four class hooks so length-
    prefixed families (runtime/dnsengine.DnsBatchEngine) reuse the
    whole feed/feed_extract/settle_entry/pump machinery:
    ``_frame_split`` (first complete frame length), ``_frame_msg``
    (the judged/logged message slice), ``frame_row`` (the device-row
    bytes the async slow path reconstructs from a settled message),
    and ``DENY_INJECT`` (the per-denied-frame reply inject)."""

    proto = "r2d2"

    # Columnar feed contract (sidecar/reasm.py): the service's
    # reassembler may own this engine's carry state in its byte arena
    # and judge whole rounds of frames columnar — the scalar
    # feed/feed_extract/settle_entry path below stays the oracle/
    # fallback rung and must never drift from it.
    reasm_columnar = True

    @staticmethod
    def reasm_spec() -> str:
        """Framing kind of the columnar feed contract
        (reasm.FRAMINGS): r2d2 frames on the first CRLF."""
        return "crlf"

    # Reply bytes injected per denied frame (byte-exact with the
    # streaming oracle; reference: r2d2parser.go:211).
    DENY_INJECT = b"ERROR\r\n"

    @staticmethod
    def _frame_split(buf) -> int:
        """Length of the first COMPLETE frame in ``buf`` (delimiter/
        header included), or -1."""
        idx = buf.find(b"\r\n")
        return -1 if idx < 0 else idx + 2

    @staticmethod
    def _frame_msg(buf, msg_len: int) -> bytes:
        """The message slice judged/logged for one complete frame
        (r2d2: the line without its CRLF)."""
        return bytes(buf[: msg_len - 2])

    @staticmethod
    def frame_row(msg: bytes) -> bytes:
        """Reconstruct the device-row bytes from a ``feed_extract``
        message (the async slow path packs judged frames from these)."""
        return msg + b"\r\n"

    def __init__(self, model, capacity: int = 2048, width: int = 256,
                 logger=None, max_buffer: int = 1 << 20):
        self.model = model
        self.capacity = capacity
        self.width = width
        self.logger = logger
        # Per-flow retained-bytes cap: a flow that buffers more than
        # this without a frame delimiter is dropped with a typed
        # protocol-error (bounded retained-data contract; the streaming
        # reference bounds its buffer the same way).  0 = unbounded.
        self.max_buffer = max_buffer
        self.buffer_overflows = 0
        self.flows: dict[int, FlowState] = {}

    def flow(
        self,
        flow_id: int,
        remote_id: int,
        policy_name: str = "",
        ingress: bool = True,
        dst_id: int = 0,
        src_addr: str = "",
        dst_addr: str = "",
    ) -> FlowState:
        st = self.flows.get(flow_id)
        if st is None:
            st = FlowState(
                flow_id=flow_id,
                remote_id=remote_id,
                policy_name=policy_name,
                ingress=ingress,
                dst_id=dst_id,
                src_addr=src_addr,
                dst_addr=dst_addr,
            )
            self.flows[flow_id] = st
        return st

    def _overflow(self, st: FlowState, incoming: int) -> None:
        """Enforce the retained-bytes cap: drop everything buffered plus
        the incoming bytes with a typed protocol-error op pair — the
        shim consumes the DROP then surfaces PARSER_ERROR on the ERROR
        op and closes the connection.  Nothing is silently retained."""
        dropped = len(st.buffer) + incoming
        st.buffer.clear()
        st.overflowed = True
        self.buffer_overflows += 1
        st.ops.append((DROP, dropped))
        st.ops.append((ERROR, int(OpError.ERROR_INVALID_FRAME_LENGTH)))

    def feed(self, flow_id: int, data: bytes, remote_id: int = 0, policy_name: str = "", **flow_kwargs) -> None:
        st = self.flow(flow_id, remote_id, policy_name, **flow_kwargs)
        if st.overflowed:
            if not st.ops:  # dead flow: every further feed errors out
                st.ops.append(
                    (ERROR, int(OpError.ERROR_INVALID_FRAME_LENGTH))
                )
            return
        if self.max_buffer and len(st.buffer) + len(data) > self.max_buffer:
            self._overflow(st, len(data))
            return
        st.buffer += data

    # -- async round API (one readback per round) --------------------------
    #
    # CRLF framing is host-knowable, so frame extraction never needs the
    # device — only the per-frame allow verdict does.  The service feeds
    # every slow entry of a round through feed_extract, judges ALL
    # extracted frames in one model call, and emits ops at completion
    # time, so the wave path's one readback per pump becomes one
    # readback per round.

    def feed_extract(
        self, flow_id: int, data: bytes, remote_id: int = 0,
        policy_name: str = "", **flow_kwargs,
    ) -> list[tuple[bytes, int]]:
        """Append data and drain every now-complete frame host-side.
        Returns [(msg_bytes, msg_len)] completed by THIS feed, in
        stream order.  Ops are NOT emitted here — the caller judges the
        frames (batched across flows) and settles each entry with
        settle_entry, which keeps MORE parity with pump()."""
        st = self.flows.get(flow_id)  # fast path: metadata kwargs only
        if st is None:  # matter at creation
            st = self.flow(flow_id, remote_id, policy_name, **flow_kwargs)
        if st.overflowed:
            if not st.ops:
                st.ops.append(
                    (ERROR, int(OpError.ERROR_INVALID_FRAME_LENGTH))
                )
            return []
        if self.max_buffer and len(st.buffer) + len(data) > self.max_buffer:
            self._overflow(st, len(data))
            return []
        st.buffer += data
        frames: list[tuple[bytes, int]] = []
        while True:
            msg_len = self._frame_split(st.buffer)
            if msg_len < 0:
                break
            frames.append((self._frame_msg(st.buffer, msg_len), msg_len))
            del st.buffer[:msg_len]
        return frames

    def adopt_residue(self, flow_id: int, data: bytes, overflowed: bool,
                      remote_id: int = 0, policy_name: str = "",
                      **flow_kwargs) -> None:
        """Lane-exit half of the columnar feed contract: the service's
        reassembler hands back a conn's arena carry (and its
        dead/overflowed latch) when the conn leaves the columnar lane,
        so the scalar feed/pump path resumes from exactly the retained
        bytes — no byte lost or replayed across the transition."""
        st = self.flow(flow_id, remote_id, policy_name, **flow_kwargs)
        if data:
            st.buffer = bytearray(data) + st.buffer
        st.overflowed = st.overflowed or overflowed

    def settle_entry(self, flow_id: int, frames: list, more: bool):
        """The finish half of one async entry in ONE dict lookup (the
        per-entry hot path — three separate emit/finish/take calls
        measured ~10µs/entry): emit ops for the entry's judged frames,
        append the trailing MORE, and drain.  ``frames`` is
        [(msg, msg_len, allow)]; ``more`` is the caller's decision
        CAPTURED AT FEED TIME (frames completed or residue left), so a
        later round draining the buffer cannot retroactively change
        this entry's ops.  Returns (ops, inject) exactly as take_ops
        would."""
        st = self.flows[flow_id]
        for frame in frames:
            # (msg, msg_len, allow) or (msg, msg_len, allow, rule) —
            # the attributed variant stamps the deciding rule row.
            msg, msg_len, allow = frame[0], frame[1], frame[2]
            st.last_rule_id = frame[3] if len(frame) > 3 else -1
            self._emit(st, msg, allow, msg_len, drain=False)
        if more and (not st.ops or st.ops[-1][0] != MORE):
            st.ops.append((MORE, 1))
        ops, inject = st.ops, bytes(st.reply_inject)
        st.ops = []
        st.reply_inject = bytearray()
        return ops, inject

    def pump(self) -> None:
        """Run device steps until no flow has a complete frame; appends ops
        to each flow's op list."""
        ops_before = {fid: len(st.ops) for fid, st in self.flows.items()}
        while self._step():
            pass
        # The streaming parser is re-invoked on the remainder after every
        # PASS/DROP and answers MORE 1 when no CRLF is left (reference:
        # r2d2parser.go:158-161) — flows that saw activity or still hold
        # bytes end the round with MORE 1 for op-sequence parity.
        for fid, st in self.flows.items():
            if st.overflowed:
                continue  # ops already end in the typed error pair
            grew = len(st.ops) > ops_before.get(fid, 0)
            if (st.buffer or grew) and (not st.ops or st.ops[-1][0] != MORE):
                st.ops.append((MORE, 1))

    def _step(self) -> bool:
        # Group flows with a complete frame by the batch width needed to
        # hold it (power-of-two buckets >= the configured width), so frames
        # longer than the default width still get verdicts instead of
        # buffering forever — the streaming parser sees its whole buffer
        # (reference: r2d2parser.go:154 joins all buffered data).
        buckets: dict[int, list[FlowState]] = {}
        for st in self.flows.values():
            msg_len = self._frame_split(st.buffer)
            if msg_len < 0:
                continue
            w = self.width
            while msg_len > w:
                w *= 2
            buckets.setdefault(w, []).append(st)
        if not buckets:
            return False
        any_work = False
        for w, active in sorted(buckets.items()):
            for chunk_start in range(0, len(active), self.capacity):
                chunk = active[chunk_start : chunk_start + self.capacity]
                any_work |= self._run_chunk(chunk, w)
        return any_work

    def _run_chunk(self, chunk: list[FlowState], width: int | None = None) -> bool:
        width = width or self.width
        f = len(chunk)
        if isinstance(self.model, ConstVerdict):
            for st in chunk:
                msg_len = self._frame_split(st.buffer)
                self._emit(
                    st, self._frame_msg(st.buffer, msg_len),
                    bool(self.model.allow), msg_len,
                )
            return True

        # Pad the flow axis to a power of two (a small fixed set of batch
        # shapes); padding rows have length 0 -> incomplete -> ignored.
        f_pad = 1
        while f_pad < f:
            f_pad *= 2
        data = np.zeros((f_pad, width), dtype=np.uint8)
        lengths = np.zeros((f_pad,), dtype=np.int32)
        remotes = np.zeros((f_pad,), dtype=np.int32)
        for i, st in enumerate(chunk):
            n = min(len(st.buffer), width)
            data[i, :n] = np.frombuffer(bytes(st.buffer[:n]), dtype=np.uint8)
            lengths[i] = n
            remotes[i] = st.remote_id

        # The rule row comes from the same kernel pass as the verdict
        # (K4), so the engine always takes the attributed call.
        outs = self.model.verdicts_attr(data, lengths, remotes)
        # One device-to-host copy for every verdict array of the chunk.
        host = torch.stack([t.to(torch.int32) for t in outs]).cpu().numpy()
        complete, msg_len, allow, rule = host[0] != 0, host[1], host[2] != 0, host[3]

        for i, st in enumerate(chunk):
            if not complete[i]:
                continue
            n = int(msg_len[i])
            st.last_rule_id = int(rule[i])
            self._emit(st, self._frame_msg(st.buffer, n), bool(allow[i]), n)
        return True

    def _log_frame(self, st: FlowState, msg: bytes, allow: bool) -> None:
        """Access-log hook for one judged frame (protocol-specific
        field extraction; overridden by non-r2d2 subclasses)."""
        fields = msg.decode("utf-8", "surrogateescape").split(" ")
        file_ = fields[1] if len(fields) == 2 else ""
        self.logger.log(
            LogEntry(
                is_ingress=st.ingress,
                entry_type=EntryType.Request if allow else EntryType.Denied,
                policy_name=st.policy_name,
                source_security_id=st.remote_id,
                destination_security_id=st.dst_id,
                source_address=st.src_addr,
                destination_address=st.dst_addr,
                proto=self.proto,
                fields={"cmd": fields[0] if fields else "", "file": file_},
            )
        )

    def _emit(self, st: FlowState, msg: bytes, allow: bool, msg_len: int,
              drain: bool = True) -> None:
        flowdebug.log(
            _flow_log, "flow %d %s %s n=%d rule=%d",
            st.flow_id, self.proto, "PASS" if allow else "DROP", msg_len,
            st.last_rule_id,
        )
        if self.logger is not None:
            self._log_frame(st, msg, allow)
        if allow:
            st.ops.append((PASS, msg_len))
        else:
            room = st.inject_capacity - len(st.reply_inject)
            st.reply_inject += self.DENY_INJECT[: max(room, 0)]
            st.ops.append((DROP, msg_len))
        if drain:
            del st.buffer[:msg_len]

    def take_ops(self, flow_id: int) -> tuple[list[tuple[OpType, int]], bytes]:
        st = self.flows[flow_id]
        ops, inject = st.ops, bytes(st.reply_inject)
        st.ops = []
        st.reply_inject = bytearray()
        return ops, inject

    def close_flow(self, flow_id: int) -> None:
        """Drop a closed connection's flow state (same contract as the
        l7/device-assisted engines — close_connection calls this on
        whichever engine is bound, and a conn churned onto an r2d2
        engine must not crash the round that closes it)."""
        self.flows.pop(flow_id, None)
