"""Datapath-side shim: per-connection buffering + the OnIO contract.

The Python twin of the native C++ shim (``native/shim.cc``): connects to
the verdict service, registers connections, ships byte batches, and
applies returned FilterOps to its buffers with the exact byte-accounting
semantics of the reference's Envoy-side consumer
(reference: envoy/cilium_proxylib.cc:125-214 GoFilter::Instance::OnIO —
pre-pass/pre-drop counters, need_bytes gating, reverse-direction inject
output, INJECT from the per-direction inject slice, ≤16 ops applied per
round with continuation).

Used by tests (op/byte parity against the in-process oracle) and by the
latency bench (batched async mode).

Fault containment (the fail-closed contract):

- A dead socket surfaces a typed ``SidecarUnavailable`` immediately —
  never a raw OSError, never a hang until the RPC timeout.
- ``ShimConnection.on_io`` NEVER raises and NEVER hangs on service
  loss: it drops the direction's retained bytes (fail-closed — nothing
  passes unverdicted) and returns ``SERVICE_UNAVAILABLE``.
- With ``auto_reconnect=True`` the client redials with jittered
  exponential backoff and REPLAYS its session (modules, policies,
  registered connections) so verdicts resume without caller
  involvement.  Retry classification follows the kvstore client
  (utils/backoff, PR 1): control RPCs (open_module, policy_update,
  new_connection, status) are idempotent at the service and retried
  once after a reconnect; data RPCs are NEVER retried — their bytes
  were dropped fail-closed, and a replay could double-apply ops.
- ``deadline_ms`` stamps every data RPC with a wire deadline budget
  (MSG_DATA_BATCH_DL) so the service sheds — typed — rather than serve
  a verdict the datapath has already given up on.
"""

from __future__ import annotations

import itertools
import json
import logging
import socket
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field

import numpy as np

from ..analysis.protocols import (
    GRANT_ARMED,
    GRANT_NONE,
    GRANT_PROTOCOL,
)
from ..proxylib.types import DROP, ERROR, INJECT, MORE, PASS, FilterResult
from ..utils import metrics
from ..utils.backoff import Exponential
from ..utils.sockutil import shutdown_close as _teardown
from . import wire
from .reasm import FRAMING_CRLF, FRAMINGS, rows_end_crlf, segments_end_crlf
from .shm import RingError
from .transport import (
    CREDIT_FLAG_QUARANTINED,
    REASON_ATTACH_REJECTED,
    REASON_OVERSIZE,
    REASON_OVERSIZE_SPREE,
    REASON_RING_FULL,
    REASON_TORN_SLOT,
    TRANSPORT_SHM,
    TRANSPORT_SOCKET,
    ShmSession,
)

log = logging.getLogger(__name__)

# Per-framing shim grants (ROADMAP 3c): the wire carries each grant's
# framing KIND string; the hot path indexes these compact code tables.
# Sorted so both ends derive the same coding independently of insertion
# order; -1 in the per-conn code array means "no grant".
_FRAMING_KINDS = sorted(FRAMINGS)
_FRAMING_CODES = {k: i for i, k in enumerate(_FRAMING_KINDS)}
_FRAMING_BY_CODE = [FRAMINGS[k] for k in _FRAMING_KINDS]
_CODE_CRLF = _FRAMING_CODES[FRAMING_CRLF]


def _join(payload) -> bytes:
    """Materialize a scatter-gather payload for the socket path (the
    ring path writes the parts into the slot without this copy)."""
    if isinstance(payload, (list, tuple)):
        return b"".join(payload)
    return payload


class SidecarUnavailable(wire.WireError):
    """The verdict service is unreachable (typed, raised immediately —
    callers decide between fail-closed verdicts and retry-after-
    reconnect; see the module docstring's classification)."""


class SidecarRestarting(SidecarUnavailable):
    """The service is down but this client's restart survival window
    is open (``restart_grace_s``): granted flows keep serving locally,
    and non-granted work is queued bounded or shed typed RESTARTING —
    the bounded, typed flavor of unavailability."""


@dataclass
class _Direction:
    """Byte accounting for one direction of one connection."""

    buffer: bytearray = field(default_factory=bytearray)  # retained input
    pass_bytes: int = 0
    drop_bytes: int = 0
    need_bytes: int = 0
    inject: bytearray = field(default_factory=bytearray)  # inject slice


class ShimConnection:
    """Client-side connection state + the OnIO application loop."""

    def __init__(self, client: "SidecarClient", conn_id: int):
        self.client = client
        self.conn_id = conn_id
        self.dirs = {False: _Direction(), True: _Direction()}
        self.closed = False
        # True while the retained buffers provably mirror the
        # service's per-conn parse state: every round so far answered
        # OK (or was served by the grant tier, which keeps both sides
        # empty).  Any typed failure, shed, deny or parser error
        # breaks the mirror — the service consumed (or never saw)
        # bytes this side still holds — and the restart replay must
        # then NOT claim RETAINED for this conn.  _reset_fail_closed
        # re-arms it: an emptied shim against a memoryless service is
        # aligned again by construction.
        self.mirror_ok = True

    def on_io(self, reply: bool, data: bytes, end_stream: bool = False,
              deadline_ms: float | None = None) -> tuple[int, bytes]:
        """Feed new input bytes for one direction; returns
        (FilterResult, output bytes to forward downstream).

        Wire contract: every input byte is shipped to the service exactly
        once (the service mirrors the retained buffer and consumes
        already-verdicted overshoot itself); ops returned by the service
        refer to the retained buffer AFTER overshoot consumption, which
        this side reproduces with the pass/drop counters below.

        ``deadline_ms`` (default: the client's configured deadline)
        rides the wire so queue time past it sheds typed instead of
        hanging.  Service loss is fail-closed: retained bytes are
        dropped and SERVICE_UNAVAILABLE returned — never an exception,
        never a hang."""
        d = self.dirs[reply]
        output = bytearray()
        incoming = bytes(data)
        # Captured BEFORE any mutation below: the verdict cache only
        # short-circuits a push that arrived on a fully clean
        # direction (nothing retained, no overshoot counters) so the
        # granted claim covers exactly this payload's whole frames.
        clean_entry = (
            not d.buffer and d.pass_bytes == 0 and d.drop_bytes == 0
        )

        # Apply pre-pass / pre-drop from an earlier verdict that exceeded
        # the then-available input (reference: cilium_proxylib.cc:130-166).
        rest = incoming
        if d.pass_bytes > 0:
            take = min(d.pass_bytes, len(rest))
            output += rest[:take]
            d.pass_bytes -= take
            rest = rest[take:]
        elif d.drop_bytes > 0:
            take = min(d.drop_bytes, len(rest))
            d.drop_bytes -= take
            rest = rest[take:]
        d.buffer += rest

        # Reverse-injected frames go out first, at a frame boundary
        # (reference: cilium_proxylib.cc:186-192).
        if d.inject:
            output += d.inject
            d.inject.clear()

        # Established-flow verdict cache: a granted conn's frame-
        # aligned request push is answered HERE — the bytes never
        # reach the transport (Libra-style: only bytes that NEED
        # inspection cross the seam).  Strictly gated: the direction
        # was fully clean at entry (clean_entry), request direction,
        # and the payload ends at a frame boundary per the GRANT'S OWN
        # framing (CRLF tail, DNS length-prefix walk, ...) — so a
        # revoke at any point leaves the stream parseable from a
        # boundary.  This tier also serves through the restart
        # survival window (the service is down; _grant_valid keeps
        # grants live for restart_grace_s).
        if (
            clean_entry
            and not reply
            and not end_stream
            and incoming
            and self.client._grant_valid(self.conn_id)
            and self.client._grant_frame_aligned(self.conn_id, incoming)
        ):
            del d.buffer[:]  # holds exactly this push (clean_entry)
            output += incoming
            self.client._count_cache_hits(1, len(incoming))
            return int(FilterResult.OK), bytes(output)

        try:
            result, entries = self.client._on_data_rpc(
                self.conn_id, reply, end_stream, incoming,
                deadline_ms=deadline_ms,
            )
        except SidecarRestarting:
            # Fail-closed like SERVICE_UNAVAILABLE below, but typed to
            # the survival window: the caller knows the blackout is
            # bounded by restart_grace_s and retries are cheap.
            d.buffer.clear()
            self.mirror_ok = False
            return int(FilterResult.RESTARTING), bytes(output)
        except (SidecarUnavailable, TimeoutError):
            # Fail-closed: nothing buffered may pass unverdicted while
            # the service is down OR unresponsive past the RPC timeout.
            # (Output assembled so far was authorized by earlier
            # verdicts and still goes out.)
            d.buffer.clear()
            self.mirror_ok = False
            return int(FilterResult.SERVICE_UNAVAILABLE), bytes(output)
        # Queue every entry's ops and inject bytes BEFORE applying any op
        # (mirrors native/shim.cc on_data_rpc): the service splits >16-op
        # verdict lists into continuation entries with all inject bytes
        # attached to the LAST chunk, so an INJECT op in an early chunk
        # must be able to see inject bytes carried by a later one.
        all_ops = []
        for _, res, ops, inj_orig, inj_reply in entries:
            if res != int(FilterResult.OK):
                self.mirror_ok = False
                return res, bytes(output)
            self.dirs[False].inject += inj_orig
            self.dirs[True].inject += inj_reply
            all_ops.extend(ops)
        for op, n in all_ops:
            if n <= 0 and op != MORE:
                self.mirror_ok = False
                return int(FilterResult.PARSER_ERROR), bytes(output)
            if op == MORE:
                d.need_bytes = len(d.buffer) + n
            elif op == PASS:
                take = min(n, len(d.buffer))
                output += d.buffer[:take]
                del d.buffer[:take]
                if n > take:
                    d.pass_bytes = n - take
            elif op == DROP:
                take = min(n, len(d.buffer))
                del d.buffer[:take]
                if n > take:
                    d.drop_bytes = n - take
            elif op == INJECT:
                if n > len(d.inject):
                    self.mirror_ok = False
                    return int(FilterResult.PARSER_ERROR), bytes(output)
                output += d.inject[:n]
                del d.inject[:n]
            elif op == ERROR:
                self.mirror_ok = False
                return int(FilterResult.PARSER_ERROR), bytes(output)
        if result != int(FilterResult.OK):
            self.mirror_ok = False
        return int(result), bytes(output)

    def _reset_fail_closed(self) -> None:
        """After a reconnect the service has no memory of this conn's
        retained bytes; drop them (fail-closed — never forward
        unverdicted residue) and clear the overshoot counters."""
        for d in self.dirs.values():
            d.buffer.clear()
            d.inject.clear()
            d.pass_bytes = d.drop_bytes = d.need_bytes = 0
        # Empty shim vs a service with no memory of the conn: the
        # mirror holds again by construction.
        self.mirror_ok = True

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.client.close_connection(self.conn_id)


class SidecarClient:
    """Wire client: one socket, a reader thread routing replies.

    ``deadline_ms`` > 0 stamps data RPCs with a wire deadline budget;
    ``auto_reconnect`` turns on redial-with-backoff + session replay
    (see module docstring)."""

    def __init__(self, socket_path: str, timeout: float = 10.0,
                 deadline_ms: float = 0.0, auto_reconnect: bool = False,
                 transport: str = TRANSPORT_SOCKET,
                 shm_data_slots: int = 64, shm_slot_bytes: int = 1 << 20,
                 shm_verdict_slots: int = 64,
                 shm_verdict_slot_bytes: int = 1 << 18,
                 flow_cache: bool = True,
                 identity: str = "",
                 shm_oversize_spree: int = 32,
                 restart_grace_s: float = 0.0,
                 restart_queue_frames: int = 0):
        self.socket_path = socket_path
        self.timeout = timeout
        self.deadline_ms = deadline_ms
        self.auto_reconnect = auto_reconnect
        # Fan-in session identity (MSG_SESSION_HELLO): the pod/workload
        # name the service keys admission quotas and per-session
        # shed/quarantine metrics on.  Empty = anonymous (the service
        # quotas under a synthetic per-session name; crash-loop
        # detection needs a stable identity to see the loop).
        self.identity = identity
        # Consecutive data-ring oversize fallbacks before this client
        # demotes its OWN shm rung typed (every frame missing the ring
        # means the fit check is pure overhead).  0 disables.
        self.shm_oversize_spree = shm_oversize_spree
        # Restart survival window (the shim half of hitless restart):
        # on disconnect, instead of tearing the grant table down,
        # shim-local grants keep serving for up to restart_grace_s —
        # the epoch stamp makes this safe (the reconnected service
        # revalidates or revokes every grant during replay).  0 keeps
        # the exact pre-restart behavior (grants die with the socket).
        self.restart_grace_s = restart_grace_s
        # Bound on NON-granted async frames held through the window to
        # be resent (same seq) after replay; past it — or at 0 — such
        # frames are answered immediately with typed RESTARTING sheds.
        self.restart_queue_frames = restart_queue_frames
        self._survival_until = 0.0  # monotonic deadline; 0 = closed
        self.survival_windows = 0
        # Granted-flow pushes answered locally WHILE the service was
        # down — the bench/soak's "traffic served through the
        # blackout" counter (strictly increasing during a restart).
        self.survival_hits = 0
        self.survival_hit_bytes = 0
        self._restart_q: deque = deque()  # (msg_type, parts, seq, ids)
        self._rq_frames = 0
        self._rq_lock = threading.Lock()
        self.restart_shed_frames = 0
        # Cross-restart exactly-once tripwire: delivered-seq ring — a
        # second delivery of a seq still in the ring is counted and
        # SUPPRESSED (never reaches the waiter/callback twice).
        self.double_replies = 0
        self._answered_ring = np.full(1 << 16, -1, np.int64)
        # Cross-session misrouting tripwire: verdict entries delivered
        # to this client for conn ids it NEVER registered.  Asserted 0
        # by the fan-in bench/suites — a nonzero value means a
        # coalesced round's completion fan-out crossed sessions.
        self.misrouted_verdicts = 0
        self._known_conns = np.zeros(0, bool)
        # Established-flow verdict cache, shim half: when True the
        # client opts in (MSG_CACHE_ENABLE) and honors MSG_CACHE_GRANT
        # frames — frame-aligned request pushes for granted conns are
        # answered LOCALLY with the service's own all-allow verdict
        # shape, so uninspected bytes never cross the ring or socket
        # (Libra-style selective copying).  The service only sends
        # grants with its own flow_cache knob on, so service-off is
        # the true baseline regardless of this flag.
        self.flow_cache = flow_cache
        # Grant table: conn-id-indexed epoch/rule arrays (vectorized
        # hit mask for batched sends; grown on demand, -1 = no grant).
        # A grant is live iff its epoch equals the latest service
        # epoch this client has seen (grant/revoke/policy-ack frames
        # all advance it) — the structural invalidation's client half.
        self._grant_epoch = np.empty(0, np.int64)
        self._grant_rule = np.empty(0, np.int32)
        # Per-conn framing code (_FRAMING_CODES; -1 = none): keys the
        # grant's frame-alignment check — CRLF tail vs length-prefix
        # walk — so non-CRLF conns get the local tier too.
        self._grant_framing = np.empty(0, np.int8)
        # Grant-table WRITE lock (reader thread grants/revokes vs the
        # caller-thread close sweep vs the reconnect-loop reset; R19's
        # declared owner for the _grant_* columns).  Reads stay
        # deliberately lock-free: the epoch-equality liveness gate
        # makes a torn READ at worst a missed short-circuit, and the
        # row's data columns are published BEFORE the epoch (the gate)
        # in _on_cache_grant, so a reader that passes _grant_valid
        # never sees another grant's rule/framing.
        self._glock = threading.Lock()
        self._service_epoch = 0
        self.cache_hits = 0
        self.cache_hit_bytes = 0
        # Data-plane bytes actually pushed across the transport (ring
        # or socket) — the flow_cache bench's byte-level proof that
        # cached bytes never crossed the seam.
        self.bytes_pushed = 0
        # Transport preference: "shm" negotiates a pair of lock-free
        # shared-memory rings at session setup (and again after every
        # auto_reconnect replay); ANY negotiation or ring fault falls
        # back to the socket rung typed — the session always serves.
        self.transport_pref = transport
        self._shm_cfg = (shm_data_slots, shm_slot_bytes,
                         shm_verdict_slots, shm_verdict_slot_bytes)
        self._shm: ShmSession | None = None
        self._shm_generation = 0
        self.transport_fallbacks: dict[str, int] = {}
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(socket_path)
        self._seq = itertools.count(1)
        self._wlock = threading.Lock()
        self._pending: dict[int, threading.Event] = {}
        self._verdicts: dict[int, wire.VerdictBatch] = {}
        # Async data rounds sent but not yet answered (seq set), plus
        # the local-answer delivery FIFO: a synthesized cache verdict
        # must never overtake an earlier in-flight round's verdicts
        # for the same conns (the client-side twin of the service
        # tier's completion-FIFO ordering rule).  The bytes still
        # never cross the transport — only the DELIVERY of the local
        # answer waits, queued behind the rounds that were in flight
        # when it was synthesized.
        # seq -> conn_ids: the value is what the disconnect sweep needs
        # to answer a round that died in flight with a typed shed (the
        # cross-restart exactly-once contract's "typed local SHED" arm).
        self._rounds_out: dict[int, np.ndarray | None] = {}
        self._local_q: deque[tuple[set, wire.VerdictBatch]] = deque()
        self._localq_lock = threading.Lock()
        self._control: list[tuple[int, bytes]] = []
        self._control_evt = threading.Event()
        self._clock = threading.Lock()  # serialize control round trips
        self._alive = True
        self._closed = False
        self._down_once = threading.Lock()  # one disconnect hook per drop
        self._down_handled = False
        # Reconnect-loop ownership (guarded by _down_once): exactly one
        # loop may drive recovery at a time.  A disconnect observed
        # while a loop is active (its own replay socket dying, or a
        # just-resumed socket dying before the loop hands off) sets
        # ``pending`` to request another cycle instead of spawning a
        # second loop that would race the first over self.sock.
        self._reconnect_active = False
        self._reconnect_pending = False
        self._reconnected = threading.Event()
        self._reconnected.set()
        self.reconnects = 0
        # Session record for replay: caller-visible module id ->
        # {params, debug, policies payload}; the wire-side id may differ
        # after a service restart, so calls translate through _mod_map.
        self._session_lock = threading.Lock()
        self._modules: dict[int, dict] = {}
        self._mod_map: dict[int, int] = {}
        self._conn_args: dict[int, tuple] = {}
        self._shims: dict[int, ShimConnection] = {}
        # Policy-table epoch from the most recent policy_update ack
        # (-1 before the first update / against a pre-epoch service):
        # the control-plane's handle for "which table generation my
        # rules are serving on" — flowlog records carry the same epoch.
        self.last_policy_epoch = -1
        self._reader = threading.Thread(
            target=self._read_loop, args=(self.sock,), daemon=True
        )
        self._reader.start()
        self.verdict_callback = None  # async mode: called with VerdictBatch
        self._send_hello()
        if transport == TRANSPORT_SHM:
            self._shm_negotiate()
        if flow_cache:
            self._cache_enable()

    def _send_hello(self) -> None:
        """Announce the session identity (fire-and-forget — a legacy
        peer ignores the frame; losing it only costs named metrics and
        crash-loop detection, never serving)."""
        if not self.identity:
            return
        try:
            self._send(
                wire.MSG_SESSION_HELLO,
                wire.pack_session_hello(self.identity),
            )
        except (SidecarUnavailable, OSError):
            pass

    # -- plumbing ---------------------------------------------------------

    @property
    def connected(self) -> bool:
        return self._alive

    def _read_loop(self, sock: socket.socket) -> None:
        # The socket is passed in, never re-read from self.sock: the
        # reader must bind to the socket its spawner owned — by first
        # bytecode a later reconnect cycle may already have swapped
        # self.sock, and two readers on one socket would race frames.
        try:
            reader = wire.BufferedReader(sock)
            while True:
                msg_type, payload = reader.recv_msg()
                if msg_type == wire.MSG_VERDICT_BATCH:
                    self._deliver_verdict(wire.unpack_verdict_batch(payload))
                elif msg_type == wire.MSG_VERDICT_MULTI:
                    for vb in wire.unpack_verdict_multi(payload):
                        self._deliver_verdict(vb)
                elif msg_type == wire.MSG_SHM_CREDIT:
                    self._on_shm_credit(payload)
                elif msg_type == wire.MSG_CACHE_GRANT:
                    self._on_cache_grant(payload)
                elif msg_type == wire.MSG_CACHE_REVOKE:
                    self._on_cache_revoke(payload)
                elif msg_type == wire.MSG_CONN_RESULT:
                    # Reader-ordered stale-grant retirement for conn-id
                    # reuse: grants the service wrote BEFORE this
                    # registration reply were applied above, and the
                    # fresh registration grant is sent AFTER the reply
                    # — dropping the row here (same thread, socket
                    # order) retires exactly the stale ones.
                    if len(payload) >= 8:
                        self._grant_drop(
                            int(np.frombuffer(payload[:8], "<u8", 1)[0])
                        )
                    self._control.append((msg_type, payload))
                    self._control_evt.set()
                elif msg_type in (wire.MSG_HANDOFF,
                                  wire.MSG_HANDOFF_REPLY):
                    # Restart handoff is a service-to-service side
                    # channel (a successor dials its predecessor); a
                    # shim session must never see either half.  Dropped
                    # typed here — routing one into the control slot
                    # would hand an RPC waiter a reply it never asked
                    # for.
                    log.warning(
                        "unexpected handoff frame %d on a shim "
                        "session; dropped", msg_type,
                    )
                else:
                    self._control.append((msg_type, payload))
                    self._control_evt.set()
        except (wire.ConnectionClosed, OSError):
            pass
        finally:
            self._on_disconnect(sock)

    def _on_disconnect(self, sock: socket.socket | None = None) -> None:
        """Socket died: fail every waiter typed-and-immediately, then
        (optionally) start the reconnect loop.  ``sock`` identifies the
        DYING socket: a reader whose socket is no longer self.sock is
        reporting a replay attempt that was already torn down and
        superseded — a delayed callback from it must be a no-op, or it
        would mark a healthy reconnected client down, fail its waiters,
        and spawn a rival reconnect loop that replays the session again
        and orphans the healthy socket with a live reader."""
        with self._down_once:
            # Identity checked UNDER the latch lock: _resume performs
            # its swap + down-state reset atomically under this same
            # lock, so a stale callback preempted between an outside
            # check and the latch could otherwise interleave with a
            # successful replay and mark the fresh session down.
            if sock is not None and sock is not self.sock:
                return
            if self._down_handled:
                return
            self._down_handled = True
            self._alive = False
        self._reconnected.clear()
        # Restart survival window: with a grace budget and a reconnect
        # loop to revalidate behind it, grants OUTLIVE the socket —
        # granted flows keep serving locally through the blackout.
        # The epoch stamp makes this safe: the reconnected service
        # re-grants (or silently does not) every replayed conn, and
        # the MSG_CONN_RESULT handler drops each conn's row at replay,
        # so a stale grant can never outlive its revalidation.
        # Without the window, grants die with the session exactly as
        # before (the service has no successor-memory of them).
        if self.restart_grace_s > 0 and self.auto_reconnect and (
            not self._closed
        ):
            self._survival_until = (
                time.monotonic() + self.restart_grace_s
            )
            self.survival_windows += 1
        else:
            self._reset_grants()
        # Frames held for a resend die with this (second) disconnect:
        # clear the queue FIRST — their seqs are still registered in
        # _rounds_out and the sweep below answers each exactly once
        # (typed); leaving them queued would resend them after a later
        # replay and double-reply.
        with self._rq_lock:
            self._restart_q.clear()
            self._rq_frames = 0
        # The shm session dies with the socket (a fresh one is
        # negotiated after replay): deactivate FIRST so no new pushes
        # land, then wake the waiters — ring in-flight RPCs share the
        # same _pending sweep and fail typed like socket in-flights.
        sess = self._shm
        if sess is not None:
            self._shm = None
            sess.active = False
        # Wake data waiters WITHOUT a verdict: they observe the missing
        # entry and raise SidecarUnavailable instead of sleeping out
        # their full RPC timeout.
        for seq, evt in list(self._pending.items()):
            self._pending.pop(seq, None)
            evt.set()
        # Async rounds lost with the socket will never be answered by
        # the service — answer each HERE with a typed SHED batch (the
        # exactly-once contract: every seq in flight at death gets
        # exactly one answer — old process, new process, or this typed
        # local shed; silence is never an option).  Then flush the
        # ordering FIFO: queued local answers were decided under
        # grants that were live at synthesis, and the rounds they
        # waited on are now answered, so they deliver in synthesis
        # order.
        with self._localq_lock:
            dead_rounds = sorted(self._rounds_out.items())
            self._rounds_out.clear()
        for seq, cids in dead_rounds:
            self._deliver_verdict(self._shed_batch(seq, cids))
        with self._localq_lock:
            flushed = [lvb for _, lvb in self._local_q]
            self._local_q.clear()
        for lvb in flushed:
            self._deliver_verdict(lvb)
        self._control_evt.set()
        if sess is not None:
            try:
                sess.destroy()
            except Exception:  # noqa: BLE001 — release is best-effort
                log.exception("shm teardown on disconnect failed")
        if self.auto_reconnect and not self._closed:
            with self._down_once:
                if self._reconnect_active:
                    # A loop is already driving recovery: this is its
                    # own replay socket dying (service restarted again
                    # mid-replay) or a just-resumed socket dying before
                    # the loop exited.  Request another cycle — a
                    # second loop would race the first over self.sock,
                    # replaying the session twice and orphaning the
                    # loser's socket with a live reader.
                    self._reconnect_pending = True
                    return
                self._reconnect_active = True
            try:
                threading.Thread(
                    target=self._reconnect_loop,
                    daemon=True,
                    name="sidecar-reconnect",
                ).start()
            except RuntimeError:  # can't start new thread
                # Un-register, or auto-reconnect is latched off for the
                # life of the process: every later disconnect would see
                # an "active" loop that never existed and just set
                # pending.
                log.exception("failed to spawn sidecar reconnect loop")
                with self._down_once:
                    self._reconnect_active = False

    def _raise_down(self) -> None:
        """Typed dead-service raise: RESTARTING while the survival
        window is open (bounded blackout), plain unavailability else."""
        if self._survival_open():
            raise SidecarRestarting(
                f"verdict service at {self.socket_path} is restarting"
            )
        raise SidecarUnavailable(
            f"verdict service at {self.socket_path} is down"
        )

    def _send(self, msg_type: int, payload: bytes) -> None:
        if not self._alive:
            self._raise_down()
        with self._wlock:
            sock = self.sock
            try:
                # lint: disable=R2 -- _wlock exists to serialize frame writes; the OSError path runs _teardown so a wedged peer cannot hold the lock past the write timeout
                wire.send_msg(sock, msg_type, payload)
            except OSError as e:
                # Tear down only the socket we actually wrote to:
                # _resume may have swapped in a fresh one concurrently,
                # and killing it would throw away the just-replayed
                # session.  A write error need not coincide with a FIN
                # reaching the reader (ETIMEDOUT against a wedged-but-
                # open peer), so a bare close would leave the reader
                # parked in recv — no _on_disconnect, no reconnect loop,
                # client wedged forever.
                if sock is self.sock:
                    _teardown(sock)  # force the reader out of recv
                raise SidecarUnavailable(str(e)) from e

    # -- shm transport (sidecar/shm.py, sidecar/transport.py) -------------

    @property
    def transport_mode(self) -> str:
        sess = self._shm
        return (
            TRANSPORT_SHM if sess is not None and sess.active
            else TRANSPORT_SOCKET
        )

    def _transport_fallback(self, reason: str, n: int = 1) -> None:
        self.transport_fallbacks[reason] = (
            self.transport_fallbacks.get(reason, 0) + n
        )
        metrics.SidecarTransportFallback.inc(reason, amount=n)

    def transport_status(self) -> dict:
        """Client-side transport telemetry (the shim half of
        `cilium sidecar status`'s transport section)."""
        sess = self._shm
        out = {
            "mode": self.transport_mode,
            "preference": self.transport_pref,
            "fallbacks": dict(self.transport_fallbacks),
            "bytes_pushed": self.bytes_pushed,
            # Shim half of the verdict cache: locally answered pushes
            # and the bytes that never crossed the seam because of
            # them.
            "cache": {
                "enabled": self.flow_cache,
                "hits": self.cache_hits,
                "hit_bytes": self.cache_hit_bytes,
                "service_epoch": self._service_epoch,
            },
            # Restart survival window: shim-local serving while the
            # sidecar is away, plus the exactly-once tripwires.
            "restart": {
                "grace_s": self.restart_grace_s,
                "windows": self.survival_windows,
                "window_open": self._survival_open_peek(),
                "survival_hits": self.survival_hits,
                "survival_hit_bytes": self.survival_hit_bytes,
                "queued_frames": self._rq_frames,
                "shed_frames": self.restart_shed_frames,
                "double_replies": self.double_replies,
            },
        }
        if sess is not None:
            out["session"] = sess.status()
        return out

    def _shm_negotiate(self) -> bool:
        """Create a fresh ring pair and offer it to the service
        (MSG_SHM_ATTACH).  Every failure is contained: the session
        stays on the socket rung, typed and counted — never raises."""
        self._shm_generation += 1
        ds, db, vs, vb = self._shm_cfg
        try:
            sess = ShmSession.create(self._shm_generation, ds, db, vs, vb)
        except Exception:  # noqa: BLE001 — no /dev/shm, quota, ...
            log.exception("shm ring creation failed; socket transport")
            self._transport_fallback(REASON_ATTACH_REJECTED)
            return False
        req = sess.attach_request()
        try:
            got = self._control_rpc(
                lambda: (wire.MSG_SHM_ATTACH, json.dumps(req).encode()),
                wire.MSG_SHM_ATTACH_REPLY,
                retry=False,
            )
            rep = json.loads(got.decode())
            status = int(rep.get("status", -1))
            if status != int(FilterResult.OK):
                raise wire.WireError(
                    rep.get("error") or f"attach status {status}"
                )
        except Exception:  # noqa: BLE001 — old service, reject, timeout
            log.warning(
                "shm attach rejected; serving on the socket transport",
                exc_info=True,
            )
            sess.destroy()
            self._transport_fallback(REASON_ATTACH_REJECTED)
            return False
        self._shm = sess
        # Segment lease the service granted: after an abrupt death the
        # survivor unlinks this session's segments once it expires.
        try:
            sess.lease_s = float(rep.get("lease_s") or 0.0)
        except (TypeError, ValueError):
            sess.lease_s = 0.0
        log.info(
            "shm transport attached (generation %s, %dx%dB data slots, "
            "lease %.1fs)", rep.get("generation"), ds, db, sess.lease_s,
        )
        return True

    # -- verdict cache, shim half (policy/invariance.py contract) ----------

    _GRANT_MAX = 1 << 22  # conn ids beyond this keep the normal path

    def _cache_enable(self) -> None:
        """One-time opt-in (fire-and-forget): tells the service this
        shim understands MSG_CACHE_GRANT/REVOKE frames.  Best-effort —
        a lost enable only costs the local short-circuit."""
        try:
            self._send(wire.MSG_CACHE_ENABLE, wire.pack_cache_enable())
        except (SidecarUnavailable, OSError):
            pass

    def _grant_ensure(self, conn_id: int) -> bool:
        if conn_id >= self._GRANT_MAX:
            return False
        n = len(self._grant_epoch)
        if conn_id >= n:
            new = max(4096, n)
            while new <= conn_id:
                new *= 2
            ge = np.full(new, -1, np.int64)
            ge[:n] = self._grant_epoch
            gr = np.full(new, -1, np.int32)
            gr[:n] = self._grant_rule
            gf = np.full(new, -1, np.int8)
            gf[:n] = self._grant_framing
            self._grant_epoch = ge
            self._grant_rule = gr
            self._grant_framing = gf
        return True

    def _on_cache_grant(self, payload: bytes) -> None:
        conn_id, epoch, rule, flags, framing = wire.unpack_cache_grant(
            payload
        )
        if not self.flow_cache or not flags & wire.CACHE_FLAG_ALLOW:
            return
        code = _FRAMING_CODES.get(framing)
        if code is None:
            # A framing this shim build does not know: ignore the
            # grant (the normal path serves — forward compatible).
            return
        if epoch > self._service_epoch:
            self._service_epoch = epoch
        with self._glock:
            if self._grant_ensure(conn_id):
                # Publish order matters for the lock-free readers: the
                # data columns (rule, framing) land BEFORE the epoch —
                # the epoch-equality check in _grant_valid is the
                # liveness gate, so a reader must never pass the gate
                # and then read a previous grant's rule/framing.
                self._grant_rule[conn_id] = rule
                self._grant_framing[conn_id] = code
                self._grant_epoch[conn_id] = GRANT_PROTOCOL.guard(
                    GRANT_NONE, GRANT_ARMED, epoch
                )

    def _on_cache_revoke(self, payload: bytes) -> None:
        epoch = wire.unpack_cache_revoke(payload)
        if epoch > self._service_epoch:
            # Every grant under an older epoch is now structurally
            # dead (the hit mask compares equality) — no sweep needed.
            self._service_epoch = epoch

    def _grant_drop(self, conn_id: int) -> None:
        with self._glock:
            if conn_id < len(self._grant_epoch):
                # Tombstone the gate FIRST, then the data columns: the
                # reverse of the grant publish order, so a concurrent
                # lock-free reader never passes the epoch gate on a
                # half-dropped row.
                self._grant_epoch[conn_id] = GRANT_PROTOCOL.require_edges(
                    (GRANT_ARMED, GRANT_NONE), GRANT_NONE
                )
                self._grant_rule[conn_id] = -1
                self._grant_framing[conn_id] = -1

    def _reset_grants(self) -> None:
        """A (re)connected service has no memory of this session's
        grants; drop them all (fail-safe: the normal path serves)."""
        with self._glock:
            self._grant_epoch.fill(
                GRANT_PROTOCOL.require_edges(
                    (GRANT_ARMED, GRANT_NONE), GRANT_NONE
                )
            )
            self._grant_rule.fill(-1)
            self._grant_framing.fill(-1)

    def _count_cache_hits(self, n: int, nbytes: int) -> None:
        self.cache_hits += n
        self.cache_hit_bytes += nbytes
        if not self._alive:
            # Served locally THROUGH a blackout: the hitless-restart
            # proof counter (strictly increasing while the service is
            # down, asserted by the soak and the restart bench).
            self.survival_hits += n
            self.survival_hit_bytes += nbytes
            metrics.SidecarSurvivalHits.inc(amount=n)
        metrics.VerdictCacheHits.inc("shim", amount=n)

    # -- restart survival window ------------------------------------------

    def _survival_open(self) -> bool:
        """True while the restart survival window is open.  The FIRST
        check past the deadline closes it lazily: grants reset and any
        held frames shed typed — traffic drives the expiry, no timer
        thread (same idiom as the session-quarantine lazy heal)."""
        until = self._survival_until
        if until == 0.0:
            return False
        if time.monotonic() < until:
            return True
        self._survival_until = 0.0
        self._reset_grants()
        self._shed_restart_queue()
        return False

    def _survival_open_peek(self) -> bool:
        """Side-effect-free read for status surfaces."""
        return (
            self._survival_until > 0.0
            and time.monotonic() < self._survival_until
        )

    def _restart_enqueue(self, msg_type: int, parts, seq: int,
                         ids) -> bool:
        """Hold one non-granted async round through the window for a
        same-seq resend after replay.  False = no room (the caller
        owes the round a typed RESTARTING shed)."""
        n = len(ids) if ids is not None else 1
        with self._rq_lock:
            if self._rq_frames + n > self.restart_queue_frames:
                return False
            self._restart_q.append((msg_type, parts, seq, ids))
            self._rq_frames += n
        return True

    def _shed_restart_queue(self) -> None:
        """Answer every held round with a typed RESTARTING shed (window
        expired, or replay superseded) — never silently dropped."""
        with self._rq_lock:
            items = list(self._restart_q)
            self._restart_q.clear()
            self._rq_frames = 0
        for _mt, _parts, seq, ids in items:
            self.restart_shed_frames += len(ids) if ids is not None else 1
            self._deliver_verdict(
                self._shed_batch(seq, ids, int(FilterResult.RESTARTING))
            )

    def _flush_restart_queue(self) -> None:
        """Replay completed: resend every held round with its ORIGINAL
        seq (the resumed service answers it once — the exactly-once
        contract's "new process" arm).  A send that fails here sheds
        typed; the round never goes unanswered."""
        with self._rq_lock:
            items = list(self._restart_q)
            self._restart_q.clear()
            self._rq_frames = 0
        for msg_type, parts, seq, ids in items:
            try:
                self._transport_send(
                    msg_type, parts, seq=seq, conn_ids=ids
                )
            except SidecarUnavailable:
                self.restart_shed_frames += (
                    len(ids) if ids is not None else 1
                )
                self._deliver_verdict(
                    self._shed_batch(
                        seq, ids, int(FilterResult.RESTARTING)
                    )
                )

    def _grant_valid(self, conn_id: int) -> bool:
        return (
            self.flow_cache
            and (self._alive or self._survival_open())
            and conn_id < len(self._grant_epoch)
            and self._grant_epoch[conn_id] == self._service_epoch
            and self._service_epoch >= 0
        )

    def _grant_frame_aligned(self, conn_id: int, data: bytes) -> bool:
        """Whole-frame check under the grant's own framing (the caller
        verified _grant_valid, so the row and its framing code are
        live)."""
        if conn_id >= len(self._grant_framing):
            return False
        code = int(self._grant_framing[conn_id])
        if code < 0:
            return False
        return _FRAMING_BY_CODE[code].payload_aligned(data)

    def _cached_batch(self, seq: int, ids: np.ndarray,
                      lengths) -> wire.VerdictBatch:
        """A locally synthesized all-allow verdict batch — byte-for-
        byte the service's `_verdict_body` shape for an all-allow
        round: per entry (PASS frame_len, MORE 1), result OK, no
        inject."""
        n = len(ids)
        ops = np.zeros(2 * n, wire.FILTER_OP)
        ops["op"][0::2] = int(PASS)
        ops["n_bytes"][0::2] = np.asarray(lengths, np.int64)
        ops["op"][1::2] = int(MORE)
        ops["n_bytes"][1::2] = 1
        zeros = np.zeros(n, "<u4")
        return wire.VerdictBatch(
            seq,
            np.ascontiguousarray(ids, "<u8"),
            np.full(n, int(FilterResult.OK), "<u4"),
            np.full(n, 2, "<u4"),
            zeros,
            zeros,
            ops,
            b"",
        )

    def _cache_try_local(self, seq: int, ids: np.ndarray, lengths,
                         tail_ok) -> bool:
        """Answer one whole batch locally when EVERY entry is granted
        under the live epoch and frame-aligned — the bytes never cross
        the transport.  Partial hits keep the normal path (the
        service's Phase-A mask owns per-entry splitting).  ``tail_ok``
        is a thunk taking the int64 conn ids and returning the
        per-entry frame-alignment mask (keyed per entry on the grant's
        own framing), evaluated only after every cheap grant-table
        check has passed — the common no-grants case (cache off
        service-side) never pays the O(payload) scan."""
        if not self.flow_cache or not len(ids):
            return False
        if not self._alive and not self._survival_open():
            # Dead service, window closed (or just lazily expired —
            # _survival_open reset the grants): the normal path owes
            # the caller its typed failure.
            return False
        # Range-check the RAW u64 ids before the int64 view: a wire id
        # >= 2^63 would wrap negative and fancy-index the wrong grant
        # rows (same guard as the service's conn-table lanes).
        if int(ids.max()) >= len(self._grant_epoch):
            return False
        cids = ids.astype(np.int64)
        if not (self._grant_epoch[cids] == self._service_epoch).all():
            return False
        if not tail_ok(cids).all():
            return False
        nbytes = int(np.asarray(lengths, np.int64).sum())
        self._count_cache_hits(len(ids), nbytes)
        vb = self._cached_batch(seq, ids, lengths)
        # Ordering: a synthesized answer must never overtake a round
        # still in flight (its verdicts could carry ops for the same
        # conns).  The bytes never cross either way; when anything is
        # outstanding — or the FIFO already holds an earlier local
        # answer — the delivery queues behind it and _round_settled
        # releases it in synthesis order.
        with self._localq_lock:
            waits = set(self._rounds_out)
            waits.update(self._pending)
            queued = bool(waits or self._local_q)
            if queued:
                self._local_q.append((waits, vb))
        if not queued:
            self._deliver_verdict(vb)
        return True

    def _blob_tail_ok(self, blob: bytes, lens: np.ndarray,
                      cids: np.ndarray) -> np.ndarray:
        """Frame-alignment mask for a packed blob batch — the service's
        `_cache_item_hits` gate: a blob inconsistent with its lengths
        reads as a miss (never indexes past the buffer), else every
        segment must end at a frame boundary under ITS OWN grant's
        framing.  The all-CRLF batch (the overwhelmingly common case)
        keeps the single vectorized scan."""
        if len(blob) != int(lens.sum()):
            return np.zeros(len(lens), bool)
        u8 = np.frombuffer(blob, np.uint8)
        starts = np.concatenate(([0], np.cumsum(lens)))[:-1]
        codes = self._grant_framing[cids]
        if (codes == _CODE_CRLF).all():
            return segments_end_crlf(u8, starts, lens)
        out = np.zeros(len(lens), bool)
        for code in np.unique(codes):
            if code < 0:
                continue  # no framing on record: miss
            m = codes == code
            out[m] = _FRAMING_BY_CODE[int(code)].segments_aligned(
                u8, starts[m], lens[m]
            )
        return out

    def _rows_aligned(self, rows: np.ndarray, lens: np.ndarray,
                      cids: np.ndarray) -> np.ndarray:
        """Per-framing twin of _blob_tail_ok for the fixed-width
        matrix layout."""
        codes = self._grant_framing[cids]
        if (codes == _CODE_CRLF).all():
            return rows_end_crlf(rows, lens)
        out = np.zeros(len(lens), bool)
        for code in np.unique(codes):
            if code < 0:
                continue
            m = codes == code
            out[m] = _FRAMING_BY_CODE[int(code)].rows_aligned(
                rows[m], lens[m]
            )
        return out

    def detach_shm(self) -> None:
        """Gracefully return the session to the socket transport (call
        when quiescent: in-flight ring verdicts should have drained).
        Fault paths demote without this round trip."""
        sess = self._shm
        if sess is None:
            return
        with self._wlock:
            if self._shm is not sess:
                return
            sess.active = False
            self._shm = None
        try:
            self._control_rpc(
                lambda: (
                    wire.MSG_SHM_DETACH,
                    wire.pack_shm_detach(sess.generation),
                ),
                wire.MSG_ACK,
                retry=False,
            )
        except (SidecarUnavailable, TimeoutError, wire.WireError):
            pass  # socket teardown releases the mappings anyway
        try:
            sess.destroy()
        except Exception:  # noqa: BLE001
            log.exception("shm teardown on detach failed")

    def _transport_send(self, msg_type: int, payload,
                        seq: int | None = None, conn_ids=None) -> None:
        """Data-plane send: ride the shm data ring when attached (one
        scatter-gather slot write + at most one doorbell frame), fall
        back to a full socket frame per-batch when the ring is full or
        the frame oversized — never blocks on ring space, never spins.

        ``payload`` may be a list of buffers: the ring path writes them
        straight into the slot (the bulk rows/blob part is never
        re-materialized); only the socket fallback joins them."""
        if self._alive and not self._reconnected.is_set():
            # Session replay in progress on the fresh socket: the
            # successor adopts handed-off conns lazily as the replay
            # re-registers them, so a data frame racing the replay
            # would surface UNKNOWN_CONNECTION for a conn the caller
            # legitimately holds.  Typed-restarting instead: the
            # caller's round is held for a same-seq resend after the
            # replay (or shed typed RESTARTING) — never misanswered.
            raise SidecarRestarting(
                f"verdict service at {self.socket_path} is replaying"
            )
        nbytes = (
            sum(len(p) for p in payload)
            if isinstance(payload, (list, tuple)) else len(payload)
        )
        # Transport byte accounting (ring or socket, before any
        # fallback split): the flow_cache bench's byte-level proof —
        # a cache-on run must push strictly fewer bytes than its
        # cache-off control.
        self.bytes_pushed += nbytes
        sess = self._shm
        if sess is None or not sess.active:
            self._send(msg_type, _join(payload))
            return
        if not self._alive:
            self._raise_down()
        reason = None
        pushed = False
        spree = False
        with self._wlock:
            if sess.active and self._shm is sess:
                if not sess.data.fits(nbytes):
                    reason = REASON_OVERSIZE
                    sess.oversize_run += 1
                    spree = bool(
                        self.shm_oversize_spree
                        and sess.oversize_run >= self.shm_oversize_spree
                    )
                else:
                    pos = sess.data.tail
                    if sess.data.try_push(msg_type, payload,
                                          sess.credit_head):
                        if seq is not None:
                            sess.inflight[seq] = (pos, conn_ids)
                        sess.counters.data_frames += 1
                        sess.oversize_run = 0
                        # lint: disable=R2 -- the doorbell frame must publish under the same lock as the ring push (SPSC + ordering); SO_SNDTIMEO/_teardown bound a wedged peer exactly as in _send
                        self._shm_doorbell_locked(sess)
                        pushed = True
                    else:
                        reason = REASON_RING_FULL
        if pushed:
            # Credit-piggybacked verdict polling: a data push is the
            # natural boundary to sweep verdicts the service already
            # committed to the ring — elides the credit-frame RTT from
            # the verdict path at small batches (outside the write
            # lock: delivery callbacks may send, which retakes it).
            # Contained: the push already succeeded, and an embedder
            # callback raising out of the sweep must not surface as a
            # failed send (a retry would double-submit the seq).
            try:
                self.poll_shm_verdicts()
            except Exception:  # noqa: BLE001 — delivery error only
                log.exception("piggyback verdict sweep failed")
            return
        if reason is not None:
            self._transport_fallback(reason)
        if spree:
            # Every frame this session pushes misses the ring: stop
            # paying the fit check and serve on the socket rung, typed.
            # served_through uses the same freshest lower bound as the
            # mirror-poll demotion (admitted frames keep their promised
            # verdicts; never-admitted ones are answered typed SHED).
            self._demote_shm(
                REASON_OVERSIZE_SPREE,
                served_through=max(sess.credit_head, sess.data.head),
            )
        self._send(msg_type, _join(payload))

    def _shm_doorbell_locked(self, sess: ShmSession) -> None:
        """Doorbell (write lock held): ring the bell for any un-belled
        tail.  The service also rechecks the ring's tail mirror after
        every drain, so a doorbell is a wakeup, never load-bearing —
        under backlog many frames coalesce into one drain (the batched
        half), while an idle service is woken immediately (suppressing
        the bell until the next credit would add a bubble to the
        tail)."""
        tail = sess.data.tail
        if tail <= sess.db_tail:
            return
        self._doorbell_send(sess, tail)

    def _doorbell_send(self, sess: ShmSession, tail: int) -> None:
        payload = wire.pack_shm_doorbell(
            sess.generation, tail, sess.v_head
        )
        sess.counters.doorbell(tail - sess.db_tail)
        sess.db_tail = tail
        sess.v_head_sent = sess.v_head
        sock = self.sock
        try:
            wire.send_msg(sock, wire.MSG_SHM_DOORBELL, payload)
        except OSError as e:
            # Same teardown contract as _send: only kill the socket we
            # wrote to, and force the reader out of recv.
            if sock is self.sock:
                _teardown(sock)
            raise SidecarUnavailable(str(e)) from e

    def _deliver_verdict(self, vb: wire.VerdictBatch,
                         sess: "ShmSession | None" = None) -> None:
        """Route one verdict batch (socket frame, verdict ring, or a
        demotion-synthesized SHED) to its waiter or the async
        callback — THE one delivery path for every transport.
        ``sess`` names the session whose ring produced this verdict:
        a ring drain must pop ITS OWN session's inflight entry (the
        exactly-once claim the demotion sweep checks), never a re-read
        self._shm that a concurrent demotion may already have
        cleared."""
        if sess is None:
            sess = self._shm
        if sess is not None:
            sess.inflight.pop(vb.seq, None)
        # Cross-restart exactly-once tripwire: a seq must be answered
        # ONCE — by the old process, the new process, or a typed local
        # shed.  A second delivery (e.g. a shed raced by a late real
        # verdict across the restart boundary) is counted and
        # suppressed so the waiter/callback never observes it.
        slot = vb.seq & (len(self._answered_ring) - 1)
        if self._answered_ring[slot] == vb.seq:
            self.double_replies += 1
            log.error(
                "double reply suppressed for seq %d (%d entries)",
                vb.seq, vb.count,
            )
            return
        self._answered_ring[slot] = vb.seq
        self._check_misroute(vb)
        cb = self.verdict_callback
        evt = self._pending.pop(vb.seq, None)
        if evt is not None:
            self._verdicts[vb.seq] = vb
            evt.set()
        elif cb is not None:
            cb(vb)
        # AFTER this round's own delivery: release any queued local
        # cache answers it was holding back (they were synthesized
        # later, so they must land later).
        self._round_settled(vb.seq)

    _KNOWN_MAX = 1 << 22  # tripwire coverage cap (mirrors _GRANT_MAX)

    def _mark_known_conn(self, conn_id: int) -> None:
        """Session-lifetime record of every conn id this client ever
        registered — the cross-session misrouting tripwire's ground
        truth (closed conns STAY marked so a verdict in flight at close
        never reads as a misroute)."""
        if conn_id >= self._KNOWN_MAX:
            return
        n = len(self._known_conns)
        if conn_id >= n:
            new = max(4096, n)
            while new <= conn_id:
                new *= 2
            arr = np.zeros(new, bool)
            arr[:n] = self._known_conns
            self._known_conns = arr
        self._known_conns[conn_id] = True

    def _check_misroute(self, vb: wire.VerdictBatch) -> None:
        """Count verdict entries for conn ids this session NEVER
        registered: one vectorized mask per delivered batch.  Zero is
        the fan-in contract (a coalesced device round's completion
        fan-out must route every slice back to its own session);
        asserted in-bench and by the fault suites.  A session with NO
        registered conns still counts (a fully-misrouted slice to a
        fresh session must not read as zero), and a shim that sends
        data for conns it never registered trips this too — both sides
        of the register-before-send contract are violations."""
        if not vb.count:
            return
        kn = self._known_conns
        ids = vb.conn_ids
        small = ids[ids < self._KNOWN_MAX].astype(np.int64)
        if not len(small):
            return
        oob = small >= len(kn)
        bad = int(oob.sum()) + int((~kn[small[~oob]]).sum())
        if bad:
            self.misrouted_verdicts += bad
            log.error(
                "cross-session misroute: %d verdict entries for conn "
                "ids this session never registered (seq %d)",
                bad, vb.seq,
            )

    def _round_settled(self, seq: int | None) -> None:
        """One round stopped being in flight (verdict delivered, RPC
        timeout, failed send).  Retire its seq from the ordering FIFO
        and deliver — in synthesis order — any queued local cache
        answers that no longer wait on anything."""
        release: list[wire.VerdictBatch] = []
        with self._localq_lock:
            if seq is not None:
                self._rounds_out.pop(seq, None)
                for waits, _ in self._local_q:
                    waits.discard(seq)
            while self._local_q and not self._local_q[0][0]:
                release.append(self._local_q.popleft()[1])
        for lvb in release:
            self._deliver_verdict(lvb)

    def _shm_forget(self, seq: int) -> None:
        sess = self._shm
        if sess is not None:
            sess.inflight.pop(seq, None)

    @staticmethod
    def _shed_batch(seq: int, conn_ids,
                    result: int = int(FilterResult.SHED)
                    ) -> wire.VerdictBatch:
        """A synthesized typed verdict batch (SHED by default,
        RESTARTING for survival-window sheds) — byte-for-byte the
        entry shape the service's shed path produces, used when frames
        the service never admitted must be answered locally (zero
        silent loss on demotion, disconnect, or window expiry)."""
        cids = np.ascontiguousarray(
            conn_ids if conn_ids is not None else [], "<u8"
        )
        n = len(cids)
        zeros = np.zeros(n, "<u4")
        return wire.VerdictBatch(
            seq,
            cids,
            np.full(n, result, "<u4"),
            zeros,
            zeros,
            zeros,
            np.zeros(0, wire.FILTER_OP),
            b"",
        )

    def _on_shm_credit(self, payload: bytes) -> None:
        """Reader-thread half of the shm protocol: drain the verdict
        ring through the credited tail, absorb data-ring credit, honor
        a quarantine demotion, and re-bell coalesced pushes."""
        sess = self._shm
        if sess is None:
            return
        generation, flags, data_head, v_tail = wire.unpack_shm_credit(
            payload
        )
        if generation != sess.generation:
            return  # stale credit from a superseded session
        sess.counters.credits += 1
        try:
            self._drain_verdict_ring(sess, v_tail)
        except RingError:
            log.exception("verdict ring corrupt; demoting to socket")
            # The service keeps consuming between this credit's
            # data_head and now — the data ring's head mirror is the
            # fresher lower bound (see poll_shm_verdicts).
            self._demote_shm(
                REASON_TORN_SLOT,
                served_through=max(data_head, sess.data.head),
            )
            return
        sess.credit_head = data_head
        if flags & CREDIT_FLAG_QUARANTINED:
            self._demote_shm(REASON_TORN_SLOT, served_through=data_head)
            return
        with self._wlock:
            if sess.active and self._shm is sess:
                if sess.data.tail > sess.db_tail:
                    # Pushes landed while the service drained: re-bell.
                    # lint: disable=R2 -- the re-bell must pair with the cursor state it publishes under this lock; SO_SNDTIMEO bounds a wedge (same contract as _send)
                    self._doorbell_send(sess, sess.data.tail)
                elif (
                    sess.v_head - sess.v_head_sent
                    >= sess.verdict.slots // 2
                ):
                    # Refresh the service's verdict-ring credit before
                    # its producer view saturates.
                    # lint: disable=R2 -- see the re-bell above; a pure credit refresh rides the same bounded doorbell write
                    self._doorbell_send(sess, sess.db_tail)

    def _drain_verdict_ring(self, sess: ShmSession, v_tail: int) -> int:
        """Consume committed verdict frames through ``v_tail`` — THE
        one drain loop, shared by the credit handler (reader thread)
        and the mirror poll below; ``drain_lock`` serializes them so
        the ring keeps a single logical consumer.  Raises RingError on
        a torn slot (caller owns the demotion)."""
        drained = 0
        with sess.drain_lock:
            if not sess.active:
                # A demotion completed its SHED sweep (which runs
                # under this same lock) between our session capture
                # and here: the ring may already be destroyed and
                # every undelivered seq was answered typed — draining
                # now would double-reply and read freed memory.
                return 0
            while sess.v_head < v_tail:
                msg_type, frame, _t = sess.verdict.read(sess.v_head)
                sess.v_head += 1
                sess.verdict.set_head(sess.v_head)
                sess.counters.verdict_frames += 1
                drained += 1
                if msg_type == wire.MSG_VERDICT_BATCH:
                    self._deliver_verdict(
                        wire.unpack_verdict_batch(frame), sess=sess
                    )
                elif msg_type == wire.MSG_VERDICT_MULTI:
                    for vb in wire.unpack_verdict_multi(frame):
                        self._deliver_verdict(vb, sess=sess)
                else:
                    raise RingError(
                        f"unexpected verdict-ring frame type {msg_type}"
                    )
        return drained

    def poll_shm_verdicts(self) -> int:
        """Credit-piggybacked verdict polling: drain any verdict
        frames ALREADY COMMITTED to the shm ring, discovered through
        the post-commit tail mirror, without waiting for the service's
        MSG_SHM_CREDIT socket frame.  At small batches the credit hop
        dominated the verdict RTT (ROADMAP item 3); a pipelined shim
        calling this at its natural boundaries — every data push does
        it automatically — takes verdicts off the ring the moment they
        are committed, so the credit frame degrades to a no-op wakeup
        exactly like the doorbell on the service side.  Never a spin:
        this is one mirror read at an event that was happening anyway
        (lint R2.2 stays clean — no loop waits on the mirror to move).
        The mirror is safe to act on because the producer stores it
        strictly AFTER the slot commit word (shm.ShmRing.try_push), and
        every slot is still commit-word-validated on read.  Returns the
        number of frames drained."""
        sess = self._shm
        if sess is None or not sess.active:
            return 0
        tail = sess.verdict.tail
        if tail <= sess.v_head:
            return 0
        sess.counters.mirror_drains += 1
        try:
            drained = self._drain_verdict_ring(sess, tail)
        except RingError:
            log.exception("verdict ring corrupt (mirror poll); demoting")
            # served_through must be the freshest lower bound on the
            # service's data-ring consumption or admitted frames get
            # BOTH a synthesized SHED and their promised post-detach
            # socket verdict.  Mirror polling means credit frames (and
            # their data_head) can lag arbitrarily, but the service
            # stores the data ring's head MIRROR after every frame it
            # copies out — strictly fresher, same trust domain as the
            # tail mirror this poll just consumed.
            self._demote_shm(
                REASON_TORN_SLOT,
                served_through=max(sess.credit_head, sess.data.head),
            )
            return 0
        sess.counters.mirror_frames += drained
        return drained

    def _demote_shm(self, reason: str,
                    served_through: int | None = None) -> None:
        """Demote the session to the socket transport, typed: ring
        frames the service never admitted (position >=
        ``served_through``) are answered here with synthesized SHED
        batches — zero silent loss; admitted frames keep their real
        verdicts, which now arrive as socket frames."""
        sess = self._shm
        if sess is None:
            return
        with self._wlock:
            if self._shm is not sess:
                return
            sess.active = False
            self._shm = None
            # Tell the service to latch off the rings NOW (fire-and-
            # forget: this runs on the reader thread, which cannot wait
            # a control round trip, hence the no-ack flag).  Without
            # it, a CLIENT-detected fault (torn verdict slot) leaves
            # the service's peer active, writing verdicts into a ring
            # nobody drains — every admitted in-flight RPC would time
            # out instead of getting its promised socket verdict.
            try:
                # lint: disable=R2 -- one bounded fire-and-forget frame under the write lock, same contract as the doorbell sends
                wire.send_msg(
                    self.sock, wire.MSG_SHM_DETACH,
                    wire.pack_shm_detach(
                        sess.generation, wire.DETACH_FLAG_NO_ACK
                    ),
                )
            except OSError:
                pass  # socket death tears the mappings down anyway
        self._transport_fallback(reason)
        log.warning(
            "shm transport demoted to socket (%s); %d ring frames "
            "in flight", reason, len(sess.inflight),
        )
        # The SHED sweep serializes with the verdict-ring drains: the
        # mirror poll made the drain a second-thread affair, so a
        # concurrent drain could deliver seq X's real verdict while
        # this sweep still holds X in its snapshot — a double reply.
        # Under drain_lock (taken WITHOUT _wlock — the session is
        # already detached above, so no new drain can start) any
        # in-progress drain finishes its deliveries first, and each
        # seq is then CLAIMED by an atomic pop: whoever pops delivers,
        # exactly once.
        with sess.drain_lock:
            pending = sorted(sess.inflight.keys())
            for seq in pending:
                ent = sess.inflight.pop(seq, None)
                if ent is None:
                    continue  # a racing drain already delivered it
                pos, cids = ent
                if served_through is not None and pos < served_through:
                    continue  # admitted: its verdict arrives on the socket
                self._deliver_verdict(self._shed_batch(seq, cids))
        try:
            sess.destroy()
        except Exception:  # noqa: BLE001 — release is best-effort
            log.exception("shm teardown on demotion failed")

    # -- reconnect --------------------------------------------------------

    def _reconnect_loop(self) -> None:
        try:
            self._reconnect_cycles()
        except Exception:  # noqa: BLE001 — never die still registered
            # The loop owns _reconnect_active; dying with it set would
            # latch auto-reconnect off for the life of the process
            # (every later disconnect would just set pending).  Clear
            # it so the next disconnect can spawn a fresh loop.
            log.exception("sidecar reconnect loop died")
            with self._down_once:
                self._reconnect_active = False

    def _reconnect_cycles(self) -> None:
        backoff = Exponential(
            min_duration=0.05, max_duration=2.0, name="sidecar-reconnect"
        )
        while not self._closed:
            with self._down_once:
                # A disconnect latched during the previous cycle is
                # consumed by this fresh attempt.
                self._reconnect_pending = False
            try:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(self.socket_path)
            except OSError:
                backoff.wait()
                continue
            try:
                self._resume(sock)
            except Exception:  # noqa: BLE001 — service mid-restart
                log.exception("sidecar session replay failed; retrying")
                self._alive = False
                # Tear the attempt down; the reader _resume started (if
                # it got that far) dies on the shut socket and its
                # _on_disconnect fails waiters typed-and-immediately —
                # it cannot spawn a rival loop (this one is still
                # registered active; the disconnect just sets
                # _reconnect_pending, cleared at the top of the retry).
                # A replay socket that died MID-replay already ran the
                # same _on_disconnect before the RPC failure landed us
                # here.
                _teardown(sock)
                backoff.wait()
                continue
            with self._down_once:
                pending = self._reconnect_pending
                if not pending:
                    self._reconnect_active = False
            if pending:
                # The just-resumed socket already died (its reader
                # latched a disconnect between replay completion and
                # this handoff): run another cycle rather than exiting
                # with nobody driving recovery — but back off first
                # like the other failure paths, or a flapping service
                # gets hammered with back-to-back full session replays.
                backoff.wait()
                continue
            return
        with self._down_once:
            self._reconnect_active = False

    def _resume(self, sock: socket.socket) -> None:
        """Swap in the fresh socket and replay the session: modules,
        their last-acked policies, then registered connections.  Shim
        buffers reset fail-closed (the service has no memory of them)."""
        with self._wlock:
            if self._closed:
                # close() raced the reconnect: never leave a "closed"
                # client holding a live session.
                _teardown(sock)
                raise wire.WireError("client closed during reconnect")
            # Swap + down-state reset as ONE atomic unit under the
            # disconnect latch lock: _on_disconnect validates its dying
            # socket's identity under the same lock, so a stale
            # callback observes either the old socket (and latches the
            # old session down, correctly) or the new one (and no-ops)
            # — never a half-applied swap that lets it mark the fresh
            # session dead.  (_wlock -> _down_once nesting occurs only
            # here; _down_once holders never take _wlock.)
            with self._down_once:
                self.sock = sock
                self._alive = True
                self._down_handled = False
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock,), daemon=True
        )
        self._reader.start()
        # Re-announce identity FIRST: the replayed session's quotas,
        # metrics and reconnect-storm accounting must key on the same
        # pod name as the original (this hello is also what lets the
        # service SEE a crash loop).
        self._send_hello()
        if self.flow_cache:
            # Opt back in BEFORE the conn replay so the restarted
            # service grants replayed conns as they register (old
            # grants were dropped at disconnect).
            self._cache_enable()
        with self._session_lock:
            modules = dict(self._modules)
            conn_args = dict(self._conn_args)
            shims = dict(self._shims)
        for caller_id, rec in modules.items():
            wire_id = self._raw_open_module(rec["params"], rec["debug"])
            self._mod_map[caller_id] = wire_id
            if rec["policies"] is not None:
                status = self._raw_policy_update(wire_id, rec["policies"])
                if status != int(FilterResult.OK):
                    raise wire.WireError(
                        f"policy replay rejected: {status}"
                    )
        restored: set[int] = set()
        for conn_id, args in conn_args.items():
            # RETAINED claim: this shim's retained-buffer mirror
            # survived the blackout intact (no round failed typed on
            # it), so a warm successor may adopt the predecessor's
            # mid-frame residue for the conn — the two sides then
            # resume the identical parse state.
            shim = shims.get(conn_id)
            cflags = (
                wire.CONN_FLAG_RETAINED
                if shim is not None and shim.mirror_ok
                else 0
            )
            res, rflags = self._raw_new_connection(conn_id, args, cflags)
            if res != int(FilterResult.OK):
                log.warning(
                    "conn %d replay rejected: %d", conn_id, res
                )
            elif rflags & wire.CONN_RESULT_FLAG_RESIDUE_ADOPTED:
                restored.add(conn_id)
        for conn_id, shim in shims.items():
            # A conn whose residue the successor ADOPTED keeps its
            # retained buffer and overshoot counters: the service
            # mirror matches them byte for byte, so a frame split
            # across the restart reassembles instead of being dropped.
            # Every other conn resets fail-closed exactly as before —
            # empty shim, empty (or discarded) service state, aligned.
            if conn_id not in restored:
                shim._reset_fail_closed()
        if self._closed:
            # close() raced the replay AFTER the initial check passed:
            # it may have shut the OLD socket just before the swap, so
            # the session we just replayed would outlive the "closed"
            # client (live reader thread until process exit).  Tear the
            # fresh socket down here; the reader exits on the closed
            # socket.  (close() runs lock-free by design — taking
            # _wlock there could deadlock behind a sendall wedged on a
            # stuck peer, the very thing close() must break.)
            _teardown(self.sock)
            raise wire.WireError("client closed during reconnect")
        if self.transport_pref == TRANSPORT_SHM:
            # Fresh rings for the fresh session: the restarted service
            # has no memory of the old segments (and must never attach
            # a stale one — generation bumps every negotiation).  A
            # failed negotiation leaves the session serving on the
            # socket rung; _shm_negotiate never raises.
            self._shm_negotiate()
        # Restart survival window closes on a completed replay: the
        # grants the replay re-armed are live again (a conn whose replay
        # was rejected already had its grant row dropped by the
        # MSG_CONN_RESULT handler).  Epoch sync is downgrade-safe for
        # the same reason.  Held restart-window frames resend LAST,
        # after every conn exists service-side, under their ORIGINAL
        # seqs — exactly-once from the caller's view.
        self._survival_until = 0.0
        if self.last_policy_epoch >= 0:
            self._service_epoch = self.last_policy_epoch
        # Un-gate the data plane BEFORE the flush: _transport_send
        # holds mid-replay rounds typed while _reconnected is clear,
        # and the flush's own same-seq resends must pass it.
        self._reconnected.set()
        self._flush_restart_queue()
        self.reconnects += 1
        metrics.SidecarClientReconnects.inc()
        log.info(
            "sidecar client reconnected to %s (%d modules, %d conns, "
            "transport=%s)",
            self.socket_path, len(modules), len(conn_args),
            self.transport_mode,
        )

    def _wire_mod(self, module_id: int) -> int:
        return self._mod_map.get(module_id, module_id)

    def _control_rpc(self, build, want: int, retry: bool = True) -> bytes:
        """One control round trip.  ``build()`` produces (msg_type,
        payload) — re-invoked on retry so module ids re-translate after
        a replay.  Control RPCs are idempotent at the service, so ONE
        retry after an auto-reconnect is safe (transport errors on
        non-idempotent ops would never be blindly retried — the data
        plane fails closed instead)."""
        for attempt in (0, 1):
            try:
                with self._clock:
                    self._control_evt.clear()
                    msg_type, payload = build()
                    # lint: disable=R2 -- _clock serializes the control request/response pairing (one outstanding RPC by design); _send fails typed+fast on a dead socket and its own _wlock wedge handling is bounded
                    self._send(msg_type, payload)
                    if not self._control_evt.wait(self.timeout):
                        if not self._alive:
                            raise SidecarUnavailable("connection lost")
                        raise TimeoutError("no control reply")
                    if not self._control:
                        # Woken by _on_disconnect, not by a reply.
                        raise SidecarUnavailable("connection lost")
                    got_type, got = self._control.pop(0)
                    if got_type != want:
                        raise wire.WireError(
                            f"expected {want}, got {got_type}"
                        )
                    return got
            except SidecarUnavailable:
                if not (
                    retry
                    and self.auto_reconnect
                    and attempt == 0
                    and not self._closed
                ):
                    raise
                if not self._reconnected.wait(self.timeout):
                    raise
        raise SidecarUnavailable("unreachable")  # not reached

    # -- module / policy surface (the libcilium.h analog) -----------------

    def _raw_open_module(self, params, debug: bool) -> int:
        got = self._control_rpc(
            lambda: (
                wire.MSG_OPEN_MODULE,
                wire.pack_open_module(params or [], debug),
            ),
            wire.MSG_MODULE_ID,
            retry=False,
        )
        return int(np.frombuffer(got, "<u8", 1)[0])

    def open_module(self, params: list[tuple[str, str]] | None = None,
                    debug: bool = False) -> int:
        got = self._control_rpc(
            lambda: (
                wire.MSG_OPEN_MODULE,
                wire.pack_open_module(params or [], debug),
            ),
            wire.MSG_MODULE_ID,
        )
        mod = int(np.frombuffer(got, "<u8", 1)[0])
        with self._session_lock:
            self._modules[mod] = {
                "params": list(params or []), "debug": debug,
                "policies": None,
            }
            self._mod_map[mod] = mod
        return mod

    def status(self) -> dict:
        """Service counters (MSG_STATUS round trip)."""
        got = self._control_rpc(
            lambda: (wire.MSG_STATUS, b""), wire.MSG_STATUS_REPLY
        )
        return json.loads(got.decode())

    def trace(self, n: int = 100, kind: str | None = None,
              session: int | None = None) -> dict:
        """Latency-trace dump (MSG_TRACE round trip): the service's
        most recent sampled spans / slow exemplars plus its per-stage
        latency aggregate — the `cilium sidecar trace` surface.
        ``session`` filters spans to one fan-in session."""
        req: dict = {"n": int(n)}
        if kind:
            req["kind"] = kind
        if session is not None:
            req["session"] = int(session)
        got = self._control_rpc(
            lambda: (wire.MSG_TRACE, json.dumps(req).encode()),
            wire.MSG_TRACE_REPLY,
        )
        return json.loads(got.decode())

    def timeline(self, n: int = 100, since: int = 0,
                 table: str | None = None) -> dict:
        """Flight-recorder dump (MSG_TIMELINE round trip): the declared-
        edge incident timeline, occupancy buckets, and postmortem
        summaries — the `cilium sidecar timeline` surface.  ``since``
        filters to events with seq strictly greater (incremental tail);
        ``table`` pins one typestate table."""
        req: dict = {"n": int(n), "since": int(since)}
        if table:
            req["table"] = table
        got = self._control_rpc(
            lambda: (wire.MSG_TIMELINE, json.dumps(req).encode()),
            wire.MSG_TIMELINE_REPLY,
        )
        return json.loads(got.decode())

    def ledger(self, n: int = 100, since: int = 0,
               cause: str | None = None) -> dict:
        """Device-economics dump (MSG_LEDGER round trip): the compile
        ledger (per-cause trace/compile events), batch-formation
        provenance, and the resident-executable census — the `cilium
        sidecar ledger` surface.  ``since`` filters to events with seq
        strictly greater (incremental tail); ``cause`` pins one compile
        cause (cold/prewarm/churn-new-shape/...)."""
        req: dict = {"n": int(n), "since": int(since)}
        if cause:
            req["cause"] = cause
        got = self._control_rpc(
            lambda: (wire.MSG_LEDGER, json.dumps(req).encode()),
            wire.MSG_LEDGER_REPLY,
        )
        return json.loads(got.decode())

    def observe(self, n: int = 100, verdict: str | None = None,
                path: str | None = None, rule: int | None = None,
                conn: int | None = None,
                since: int | None = None,
                epoch: int | None = None,
                session: int | None = None) -> dict:
        """Flow-record query (MSG_OBSERVE round trip): the service's
        per-flow verdict records with device-side rule attribution —
        the `cilium observe` surface.  ``since`` is the follow cursor
        (records with seq > since, ascending); ``epoch`` filters on the
        policy-table epoch the verdict was decided against; ``session``
        on the fan-in shim session the conn registered through."""
        req: dict = {"n": int(n)}
        if verdict is not None:
            req["verdict"] = verdict
        if path is not None:
            req["path"] = path
        if rule is not None:
            req["rule"] = int(rule)
        if conn is not None:
            req["conn"] = int(conn)
        if since is not None:
            req["since"] = int(since)
        if epoch is not None:
            req["epoch"] = int(epoch)
        if session is not None:
            req["session"] = int(session)
        got = self._control_rpc(
            lambda: (wire.MSG_OBSERVE, json.dumps(req).encode()),
            wire.MSG_OBSERVE_REPLY,
        )
        return json.loads(got.decode())

    def _raw_policy_update(self, wire_mod: int, payload: bytes) -> int:
        got = self._control_rpc(
            lambda: (
                wire.MSG_POLICY_UPDATE,
                wire.pack_policy_update(wire_mod, payload),
            ),
            wire.MSG_ACK,
            retry=False,
        )
        status, epoch = wire.unpack_ack_epoch(got)
        if status == int(FilterResult.OK) and epoch >= 0:
            self.last_policy_epoch = epoch
            if epoch > self._service_epoch:
                self._service_epoch = epoch
        return status

    def policy_update(self, module_id: int, policies) -> int:
        payload = json.dumps([asdict(p) for p in policies]).encode()
        got = self._control_rpc(
            lambda: (
                wire.MSG_POLICY_UPDATE,
                wire.pack_policy_update(self._wire_mod(module_id), payload),
            ),
            wire.MSG_ACK,
        )
        status, epoch = wire.unpack_ack_epoch(got)
        if status == int(FilterResult.OK):
            if epoch >= 0:
                self.last_policy_epoch = epoch
                if epoch > self._service_epoch:
                    self._service_epoch = epoch
            with self._session_lock:
                if module_id in self._modules:
                    self._modules[module_id]["policies"] = payload
        return status

    def _raw_new_connection(
        self, conn_id: int, args: tuple, flags: int = 0,
    ) -> tuple[int, int]:
        """Replay-path registration; returns ``(result,
        result_flags)``.  ``flags`` carries the RETAINED claim; the
        reply's trailing flags word (absent on an old service — treated
        as 0) reports whether handoff residue was adopted."""
        (module_id, proto, ingress, src_id, dst_id,
         src_addr, dst_addr, policy_name) = args
        got = self._control_rpc(
            lambda: (
                wire.MSG_NEW_CONNECTION,
                wire.pack_new_connection(
                    self._wire_mod(module_id), conn_id, ingress, src_id,
                    dst_id, proto, src_addr, dst_addr, policy_name,
                    flags,
                ),
            ),
            wire.MSG_CONN_RESULT,
            retry=False,
        )
        res = int(np.frombuffer(got[8:12], "<u4", 1)[0])
        rflags = (
            int(np.frombuffer(got[12:16], "<u4", 1)[0])
            if len(got) >= 16 else 0
        )
        return res, rflags

    def new_connection(
        self,
        module_id: int,
        proto: str,
        conn_id: int,
        ingress: bool,
        src_id: int,
        dst_id: int,
        src_addr: str,
        dst_addr: str,
        policy_name: str,
    ) -> tuple[int, ShimConnection | None]:
        args = (module_id, proto, ingress, src_id, dst_id,
                src_addr, dst_addr, policy_name)
        got = self._control_rpc(
            lambda: (
                wire.MSG_NEW_CONNECTION,
                wire.pack_new_connection(
                    self._wire_mod(module_id), conn_id, ingress, src_id,
                    dst_id, proto, src_addr, dst_addr, policy_name,
                ),
            ),
            wire.MSG_CONN_RESULT,
        )
        res = int(np.frombuffer(got[8:], "<u4", 1)[0])
        if res != int(FilterResult.OK):
            return res, None
        shim = ShimConnection(self, conn_id)
        with self._session_lock:
            self._conn_args[conn_id] = args
            self._shims[conn_id] = shim
        self._mark_known_conn(conn_id)
        return res, shim

    def close_connection(self, conn_id: int) -> None:
        with self._session_lock:
            self._conn_args.pop(conn_id, None)
            self._shims.pop(conn_id, None)
        self._grant_drop(conn_id)
        try:
            self._send(wire.MSG_CLOSE, wire.pack_close(conn_id))
        except SidecarUnavailable:
            pass  # the restart already forgot the conn

    def close(self) -> None:
        self._closed = True
        # Capture the socket OBJECT once: _resume swaps self.sock on
        # reconnect, and a re-read between shutdown and close could
        # shutdown the old socket but bare-close the new one —
        # recreating the lingering-reader leak for the fresh reader.
        # (_resume checks _closed after the swap and tears the fresh
        # socket down the same way.)
        _teardown(self.sock)
        sess = self._shm
        self._shm = None
        if sess is not None:
            sess.active = False
            try:
                sess.destroy()
            except Exception:  # noqa: BLE001 — release is best-effort
                log.exception("shm teardown on close failed")

    # -- data plane -------------------------------------------------------

    def _on_data_rpc(self, conn_id: int, reply: bool, end_stream: bool,
                     data: bytes, deadline_ms: float | None = None):
        """Synchronous single-entry round trip (the OnData ABI call).
        NEVER retried across a reconnect (see retry classification);
        raises SidecarUnavailable immediately on a dead service."""
        seq = next(self._seq)
        flags = (wire.FLAG_REPLY if reply else 0) | (
            wire.FLAG_END_STREAM if end_stream else 0
        )
        evt = threading.Event()
        self._pending[seq] = evt
        budget_ms = self.deadline_ms if deadline_ms is None else deadline_ms
        if budget_ms and budget_ms > 0:
            payload = wire.pack_data_batch_dl(
                int(budget_ms * 1000.0), seq, [conn_id], [flags],
                [len(data)], data,
            )
            msg = wire.MSG_DATA_BATCH_DL
        else:
            payload = wire.pack_data_batch(
                seq, [conn_id], [flags], [len(data)], data
            )
            msg = wire.MSG_DATA_BATCH
        try:
            self._transport_send(
                msg, payload, seq=seq,
                conn_ids=np.asarray([conn_id], np.uint64),
            )
        except SidecarUnavailable:
            self._pending.pop(seq, None)
            self._shm_forget(seq)
            self._round_settled(seq)
            raise
        if not evt.wait(self.timeout):
            self._pending.pop(seq, None)
            self._shm_forget(seq)
            # A timed-out RPC will never deliver: local answers queued
            # behind it must not wait forever.
            self._round_settled(seq)
            raise TimeoutError("no verdict reply")
        vb = self._verdicts.pop(seq, None)
        if vb is None:
            # Woken by _on_disconnect: the service died mid-flight.
            raise SidecarUnavailable("connection lost awaiting verdict")
        entries = [vb.entry(i) for i in range(vb.count)]
        result = entries[-1][1] if entries else int(FilterResult.OK)
        return result, entries

    def _send_round(self, msg_type: int, parts, seq: int,
                    ids: np.ndarray) -> None:
        """Send one async data round with its seq registered in
        ``_rounds_out`` BEFORE any bytes move — the cache tier's
        ordering gate must see the round in flight from the instant it
        can be answered.  A failed send retires the seq (no verdict
        will ever come to retire it) — EXCEPT inside the restart
        survival window, where the round is either held bounded for a
        same-seq resend after replay or answered right here with a
        typed RESTARTING shed; the caller sees success either way (the
        answer arrives through the normal delivery path, exactly
        once)."""
        with self._localq_lock:
            self._rounds_out[seq] = ids
        try:
            self._transport_send(msg_type, parts, seq=seq, conn_ids=ids)
        except SidecarRestarting:
            if self._restart_enqueue(msg_type, parts, seq, ids):
                return  # held: resent (same seq) after the replay
            self.restart_shed_frames += len(ids)
            self._deliver_verdict(
                self._shed_batch(seq, ids, int(FilterResult.RESTARTING))
            )
        except BaseException:
            self._round_settled(seq)
            raise

    def send_batch(self, seq: int, conn_ids, flags, lengths, blob: bytes) -> None:
        """Async batched mode (latency bench): fire a DATA batch; replies
        arrive on verdict_callback.  A batch whose every entry is
        request-direction, frame-aligned, and cache-granted is answered
        locally — nothing crosses the transport."""
        ids = np.ascontiguousarray(conn_ids, "<u8")
        if self.flow_cache:
            fl = np.asarray(flags, np.uint8)
            lens = np.asarray(lengths, np.int64)
            if not fl.any() and self._cache_try_local(
                seq, ids, lens,
                lambda cids: self._blob_tail_ok(blob, lens, cids),
            ):
                return
        parts = wire.pack_data_batch_parts(seq, ids, flags, lengths, blob)
        self._send_round(wire.MSG_DATA_BATCH, parts, seq, ids)

    def send_matrix(self, seq: int, width: int, conn_ids, lengths,
                    rows_bytes: bytes, complete: bool = False) -> None:
        """Fixed-width pre-padded batch (request direction): the service
        reshapes straight into the device layout.  ``complete=True``
        declares every row is exactly one whole frame (the edge owns
        framing), letting the service skip its per-row content scan.
        A fully cache-granted, frame-aligned matrix is answered
        locally — the rows never cross the transport."""
        ids = np.ascontiguousarray(conn_ids, "<u8")
        if self.flow_cache and len(ids):
            li = np.asarray(lengths, np.int64)

            def _tail_ok(cids, n=len(ids)):
                # The framing's rows_aligned owns the width bound (a
                # malformed length reads as a miss); a rows buffer
                # inconsistent with (n, width) reads as a miss too.
                if width < 1 or len(rows_bytes) != n * width:
                    return np.zeros(n, bool)
                rows = np.frombuffer(rows_bytes, np.uint8).reshape(n, width)
                return self._rows_aligned(rows, li, cids)

            if self._cache_try_local(seq, ids, li, _tail_ok):
                return
        # Scatter-gather parts (wire.py owns the layout): the rows
        # buffer (the bulk) goes into the ring slot (or one sendall)
        # without an intermediate join.
        parts = wire.pack_data_matrix_parts(
            seq, width, ids, lengths, rows_bytes,
            wire.MAT_FLAG_COMPLETE if complete else 0,
        )
        self._send_round(wire.MSG_DATA_MATRIX, parts, seq, ids)

    def send_blob(self, seq: int, conn_ids, lengths, blob: bytes) -> None:
        """Compact request-direction batch: exact payload bytes only
        (the service builds the device row view with an on-device
        gather).  Preferred over send_matrix when the device link is
        bandwidth-limited — the wire and uplink carry no padding.
        Fully cache-granted frame-aligned batches are answered locally
        (see send_batch)."""
        ids = np.ascontiguousarray(conn_ids, "<u8")
        if self.flow_cache and len(ids):
            lens = np.asarray(lengths, np.int64)
            if self._cache_try_local(
                seq, ids, lens,
                lambda cids: self._blob_tail_ok(blob, lens, cids),
            ):
                return
        # Scatter-gather parts (wire.py owns the layout — see
        # send_matrix): the blob rides into the slot without a join.
        parts = wire.pack_data_batch_parts(
            seq, ids, np.zeros(len(ids), np.uint8), lengths, blob
        )
        self._send_round(wire.MSG_DATA_BATCH, parts, seq, ids)
