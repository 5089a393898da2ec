"""Networked kvstore: TCP server + client Backend.

The distributed-state backbone crossing a real process/machine boundary
— the role etcd plays for the reference (reference: pkg/kvstore/etcd.go:
143 etcd module: leases, CAS transactions, prefix watch; keepalive.go
session liveness).  One KvstoreServer owns the authoritative store (a
LocalBackend); any number of NetBackend clients connect over TCP and
speak a length-prefixed JSON protocol:

  - CRUD + the CAS primitives (create_only / create_if_exists) execute
    atomically inside the server.
  - lease=True keys belong to the client's SESSION (one session per
    connection); session end — clean close or TCP death — deletes them,
    emitting DELETE events to every other client's watchers.  This is
    the etcd lease-expiry model: a dying node's identity references and
    ipcache entries vanish cluster-wide.
  - Locks are server-side with session ownership and auto-release on
    session end (reference: etcd.go LockPath via concurrency.Mutex).
  - list_and_watch replays the snapshot + LIST_DONE, then streams live
    events; the client assigns watch ids so no event can outrun its
    watcher registration.

Wire frame: 4-byte big-endian length + UTF-8 JSON.  Values travel hex.

Fencing epochs — the split-brain arbitration the snapshot-shipping
follower lacked (reference analog: etcd raft terms / consul sessions,
pkg/kvstore/etcd.go:143, consul.go:119).  State machine:

  - The PRIMARY owns a monotonically increasing epoch N, stored in the
    key space under ``EPOCH_KEY`` (so it replicates to followers and
    persists in durable snapshots like any other non-leased key).
  - A FOLLOWER serves reads and watches from the start but REJECTS
    writes with ``not_primary`` while its replication stream lives:
    a write it accepted could be silently pruned at the next
    LIST_DONE resync, so it refuses to accept what it cannot keep.
  - When the follower's replication stream dies and its reconnect
    budget is exhausted, it waits ``failover_grace`` and then PROMOTES:
    it CAS-claims epoch N+1 against the last epoch it replicated
    (durably — the claim lands in its snapshot before any write is
    accepted) and becomes writable.  A promoted follower never
    resubscribes to the old primary, so its accepted writes can never
    be pruned.
  - Every client request carries the highest epoch the client has
    observed; every response carries the server's epoch.  A server
    that sees a request epoch above its own has proof a newer primary
    exists and FENCES itself: all subsequent writes are rejected with
    ``epoch_fenced`` (EPOCH_FENCED) — a partitioned-but-alive old
    primary can never accept writes from any client that has touched
    the new primary.  The promoted follower also dials the old
    primary's address in the background and fences it explicitly the
    moment the partition heals.
  - Clients treat both rejection kinds as rejected-before-apply (safe
    to retry even for CAS creates): ``not_primary`` backs off and
    retries in place (the follower is about to promote or the primary
    is back); ``epoch_fenced`` redials FORWARD along the failover
    list toward the higher epoch, then retries.

Failover ordering contract: promotion strictly follows replication
death (the repl watcher is only stopped after its reconnect budget is
spent — or after the replication HEARTBEAT declares a silent
partition dead), and writability strictly follows the durable epoch
claim.  Exactly two loss windows remain, both documented and asserted
(tests/test_kvstore_partition.py), neither silent:

  1. Replication lag at the cut: replication is asynchronous, so a
     write acked by the primary in the instant before the partition
     may not have reached the follower — it survives on the fenced
     old primary, visible to degraded reads, never merged.
  2. The LWW window: writes acknowledged by the old primary between
     the follower's promotion and the first fencing contact (fencer
     thread on heal, or epoch gossip from any client) — same fate.

Two followers of one primary promoting concurrently would claim the
same epoch (ordered failover lists, one follower per chain, is the
supported topology).

Degraded mode (daemon/daemon.py): when the store is fenced or
unreachable, endpoint regeneration and verdict serving continue on
cached identities (kvstore_degraded metric + monitor notification);
degraded mode guarantees datapath continuity for already-resolved
state, and guarantees nothing for NEW identities or cross-node
propagation until the store returns.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import struct
import threading
import time
from typing import Optional

from .backend import (
    Backend,
    EpochFencedError,
    EventType,
    KeyValueEvent,
    KvstoreError,
    LockError,
    NotPrimaryError,
    Watcher,
)
from .local import LocalBackend
from ..utils import metrics
from ..utils.backoff import Exponential
from ..utils.sockutil import shutdown_close

log = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
MAX_FRAME = 16 << 20

# The fencing epoch lives in the ordinary key space: it replicates to
# followers through the same watch stream as everything else and lands
# in durable snapshots with no special-casing.
EPOCH_KEY = "cilium/.cluster/epoch"
# The highest epoch this server was fenced BY, persisted the same way:
# a snapshot-backed old primary that restarts comes back still fenced
# instead of silently writable at its stale epoch.  (A memory-only
# server restarts empty — data and fencing alike — which is the
# documented fail-back hazard of running without a snapshot_path.)
FENCED_KEY = "cilium/.cluster/fenced"

# Ops that mutate the store (or grant exclusion tokens derived from
# it): these are what fencing rejects.  Reads and watches stay served
# by fenced/replicating servers — degraded reads keep the datapath up.
WRITE_OPS = frozenset({
    "set", "delete", "delete_prefix", "create_only", "create_if_exists",
    "reclaim", "lock",
})


class KvstoreCounters:
    """Failure/event counters for the swallowed-error paths (reference:
    kvstore errors surface through controller failure counts,
    pkg/kvstore/events.go).  Surfaced through server/client status and
    the daemon status section — a malformed frame or revoke failure
    increments here instead of vanishing.  Every increment is ALSO
    bridged into the global Prometheus registry
    (``cilium_tpu_kvstore_events_total{scope,event}``) so fencing and
    traffic counters appear in ``/metrics``, not only in status RPCs;
    ``scope`` names the owning end (server|client)."""

    def __init__(self, scope: str = "kvstore") -> None:
        self._scope = scope
        self._mutex = threading.Lock()
        self._counts: dict[str, int] = {}

    def inc(self, name: str) -> None:
        with self._mutex:
            self._counts[name] = self._counts.get(name, 0) + 1
        metrics.KvstoreEvents.inc(self._scope, name)

    def snapshot(self) -> dict[str, int]:
        with self._mutex:
            return dict(self._counts)


def _send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("kvstore peer closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> dict:
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > MAX_FRAME:
        raise KvstoreError(f"kvstore frame too large ({n})")
    return json.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# Server

class _Session:
    """Per-connection state: leased keys, held locks, active watches."""

    def __init__(self, server: "KvstoreServer", sock: socket.socket,
                 peer: str) -> None:
        self.server = server
        self.sock = sock
        self.peer = peer
        self.wlock = threading.Lock()
        self.leased: set[str] = set()
        self.locks: dict[str, object] = {}
        self.watches: dict[int, tuple[Watcher, threading.Thread]] = {}
        self._dead = False

    def send(self, obj: dict) -> None:
        with self.wlock:
            try:
                # Bounded by SO_SNDTIMEO (set at accept): a wedged-but-
                # alive subscriber that stops reading costs ONE bounded
                # wait here, never a forever-parked pump thread.
                # lint: disable=R2 -- wlock exists to serialize frame writes on this socket; the sendall is deadline-bounded and a timeout tears the session down below
                _send_frame(self.sock, obj)
            except OSError as e:
                # A dead peer's reader cleans up on its own; a TIMED
                # OUT send means a wedged-alive peer (or a partial
                # write that desynced the framing) — the reader would
                # never notice either, so tear the session down here:
                # shutdown wakes the serve() recv, whose cleanup stops
                # watches, releases locks, and revokes leases.
                self.server.counters.inc("server_send_failed")
                log.debug("kvstore session %s send failed: %s", self.peer, e)
                shutdown_close(self.sock)

    def serve(self) -> None:
        try:
            while True:
                req = _recv_frame(self.sock)
                op = req.get("op", "")
                if op == "lock":
                    # Lock acquisition blocks; its own thread keeps this
                    # session's other requests flowing.
                    threading.Thread(
                        target=self._handle_safe, args=(req,), daemon=True
                    ).start()
                else:
                    self._handle_safe(req)
        except (ConnectionError, OSError) as e:
            log.debug("kvstore session %s ended: %s", self.peer, e)
        except ValueError as e:
            # Malformed frame: a protocol bug, not a disconnect — count
            # and log it loudly before dropping the session.
            self.server.counters.inc("server_malformed_frame")
            log.warning("kvstore session %s malformed frame: %s",
                        self.peer, e)
        finally:
            self.cleanup()

    def _handle_safe(self, req: dict) -> None:
        rid = req.get("id")
        try:
            epoch = self.server._epoch_gate(req)
            result = self._handle(req)
            # The promotion-CAS is the only epoch mutation a request
            # can cause, and requests never trigger it — the gate-time
            # read is current for the response.
            self.send({"id": rid, "ok": True,
                       "epoch": epoch, **(result or {})})
        except EpochFencedError as e:
            self.send({"id": rid, "ok": False, "error": str(e),
                       "kind": "epoch_fenced",
                       "epoch": self.server.fenced_by or self.server.epoch})
        except NotPrimaryError as e:
            self.send({"id": rid, "ok": False, "error": str(e),
                       "kind": "not_primary", "epoch": self.server.epoch})
        except LockError as e:
            self.send({"id": rid, "ok": False, "error": str(e),
                       "kind": "lock", "epoch": self.server.epoch})
        except Exception as e:  # noqa: BLE001 — surface to the client
            self.send({"id": rid, "ok": False, "error": str(e),
                       "epoch": self.server.epoch})

    def _handle(self, req: dict) -> dict | None:
        b = self.server.backend
        op = req["op"]
        key = req.get("key", "")
        val = bytes.fromhex(req["value"]) if "value" in req else b""
        lease = bool(req.get("lease"))
        if op == "ping":
            return {}
        if op == "fence":
            # Explicit fencing (the promoted follower's heal-time
            # notification; also the CLI's arbitration probe).  The
            # epoch gate above already fences on the carried request
            # epoch; this op additionally accepts an explicit value so
            # a fencer need not fake client state.
            fenced = self.server.fence(int(req.get("fence_epoch", 0) or 0))
            return {"fenced": bool(self.server.fenced_by),
                    "fenced_now": fenced}
        if op == "status":
            return {
                "status": b.status(),
                "counters": self.server.counters.snapshot(),
                "role": self.server.role,
                "fenced": self.server.fenced,
                "fenced_by": self.server.fenced_by,
                "replicating": bool(
                    getattr(self.server, "replicating", False)
                ),
            }
        if op == "get":
            v = b.get(key)
            return {"found": v is not None,
                    "value": v.hex() if v is not None else ""}
        if op == "get_prefix":
            v = b.get_prefix(key)
            return {"found": v is not None,
                    "value": v.hex() if v is not None else ""}
        if op == "set":
            # lease-ness travels into the backend so a durable backend
            # excludes the key from its snapshot ATOMICALLY with the
            # write (persistence happens on the mutation's emit).  The
            # server mutex spans write + ownership record so 'reclaim'
            # cannot interleave between them and double-assign a lease.
            with self.server._mutex:
                b.set(key, val, lease=lease)
                self._claim_locked(key, lease)
            return {}
        if op == "delete":
            with self.server._mutex:
                b.delete(key)
                self.server._lease_owner.pop(key, None)
            self.leased.discard(key)
            return {}
        if op == "delete_prefix":
            b.delete_prefix(key)
            with self.server._mutex:
                for k in [
                    k for k in self.server._lease_owner
                    if k.startswith(key)
                ]:
                    self.server._lease_owner.pop(k)
            self.leased = {k for k in self.leased if not k.startswith(key)}
            return {}
        if op == "create_only":
            with self.server._mutex:
                ok = b.create_only(key, val, lease=lease)
                if ok:
                    self._claim_locked(key, lease)
            return {"created": ok}
        if op == "create_if_exists":
            with self.server._mutex:
                ok = b.create_if_exists(
                    req["cond_key"], key, val, lease=lease
                )
                if ok:
                    self._claim_locked(key, lease)
            return {"created": ok}
        if op == "reclaim":
            # Post-failover lease re-adoption: succeed only if the key
            # still holds OUR bit-identical value AND no live session
            # owns it (the replicated-ghost case).  The owner check and
            # re-claim happen under the server mutex, so another
            # session's create_only/_claim cannot be stolen from.
            # Self-owned keys re-take trivially: the client's replay
            # retries after a not_primary rejection, and a second pass
            # over an already-adopted key must stay a success, not get
            # misread as "claimed elsewhere".
            with self.server._mutex:
                owner = self.server._lease_owner.get(key)
                if owner is not None and owner is not self:
                    return {"taken": False}
                cur = b.get(key)
                if cur != val:
                    return {"taken": False}
                b.set(key, val, lease=True)
                self.server._lease_owner[key] = self
                self.leased.add(key)
            return {"taken": True}
        if op == "list_prefix":
            return {
                "items": {k: v.hex() for k, v in b.list_prefix(key).items()}
            }
        if op == "lock":
            path = req["path"]
            lock = b.lock_path(path, timeout=req.get("timeout"))
            self.locks[path] = lock
            return {}
        if op == "unlock":
            lock = self.locks.pop(req["path"], None)
            if lock is not None:
                lock.unlock()
            return {}
        if op == "watch":
            wid = int(req["wid"])
            w = b.list_and_watch(req.get("name", self.peer), key)
            t = threading.Thread(
                target=self._pump_watch, args=(wid, w), daemon=True,
                name=f"kvstore-watch-{wid}",
            )
            self.watches[wid] = (w, t)
            t.start()
            return {}
        if op == "watch_stop":
            rec = self.watches.pop(int(req["wid"]), None)
            if rec is not None:
                rec[0].stop()
            return {}
        raise KvstoreError(f"unknown kvstore op {op!r}")

    def _claim_locked(self, key: str, lease: bool) -> None:
        """Record lease ownership — CALLER HOLDS server._mutex (the
        claim must be atomic with the backend write or 'reclaim' can
        interleave and double-assign).  A later write by ANY session
        (leased or not) re-associates the key, so an older session's
        death no longer deletes it (etcd semantics: the latest PUT's
        lease — or absence of one — wins).  Lease-ness is mirrored into
        the backend's leased set so a durable backend excludes leased
        keys from its snapshot (they die with their sessions)."""
        if lease:
            self.server._lease_owner[key] = self
            self.leased.add(key)
        else:
            self.server._lease_owner.pop(key, None)

    def _pump_watch(self, wid: int, w: Watcher) -> None:
        while not w.stopped and not self._dead:
            ev = w.next_event(timeout=0.2)
            if ev is None:
                continue
            # ev.lease was stamped ATOMICALLY with the mutation by the
            # backend (a pump-time ownership lookup would race _claim).
            self.send({
                "event": {
                    "wid": wid,
                    "type": ev.typ.value,
                    "key": ev.key,
                    "value": ev.value.hex(),
                    "lease": ev.lease,
                }
            })

    def cleanup(self) -> None:
        """Session death: stop watches, release locks, revoke leases —
        the etcd lease-expiry analog; other clients see DELETE events."""
        if self._dead:
            return
        self._dead = True
        for w, _ in self.watches.values():
            w.stop()
        self.watches.clear()
        for lock in self.locks.values():
            try:
                lock.unlock()
            except Exception as e:  # noqa: BLE001
                self.server.counters.inc("server_unlock_failed")
                log.warning("session %s lock release failed: %s",
                            self.peer, e)
        self.locks.clear()
        for k in sorted(self.leased):
            # Only revoke keys THIS session still owns: a newer session
            # (e.g. the restarted daemon) may have re-registered the key.
            with self.server._mutex:
                owned = self.server._lease_owner.get(k) is self
                if owned:
                    self.server._lease_owner.pop(k)
            if not owned:
                continue
            try:
                self.server.backend.delete(k)
            except Exception as e:  # noqa: BLE001
                self.server.counters.inc("server_lease_revoke_failed")
                log.warning("lease revoke of %s failed: %s", k, e)
        self.leased.clear()
        shutdown_close(self.sock)
        self.server._drop_session(self)


class KvstoreServer:
    """TCP front for a LocalBackend — the cluster's shared store.

    ``snapshot_path`` makes the store durable: every mutation persists
    to disk (lease-owned keys excluded — they die with their sessions,
    exactly like etcd leases) and a restarted server restores from the
    snapshot, so identities and other non-leased cluster state survive
    a store restart (reference: etcd's WAL/snapshot durability that
    pkg/kvstore assumes)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backend: Backend | None = None,
                 snapshot_path: str | None = None,
                 role: str = "primary",
                 send_timeout: float = 5.0) -> None:
        from .local import FileBackend

        # Slow-consumer containment: session sends are bounded (the
        # interprocedural lint's blocking-through-helper finding — a
        # subscriber that stops reading used to park _pump_watch in
        # sendall forever under the session wlock, with the session's
        # watches/locks/leases pinned alive).  SO_SNDTIMEO over
        # settimeout() so the serve loop's recv stays unbounded: idle
        # sessions are normal, wedged WRITES are not.
        self.send_timeout = send_timeout
        if backend is None:
            backend = (
                FileBackend(snapshot_path) if snapshot_path
                else LocalBackend()
            )
        self.backend = backend
        self.counters = KvstoreCounters("server")
        # Fencing state.  The role is fixed BEFORE the listener starts:
        # a session racing construction must never see a follower as
        # writable (the write it sneaked in would be pruned at the
        # first LIST_DONE — the exact loss fencing exists to prevent).
        self.role = role
        self.fenced_by = 0  # higher epoch this server was fenced by
        raw_fenced = self.backend.get(FENCED_KEY)
        if raw_fenced:
            # Restored from a snapshot taken after this server was
            # fenced: stay fenced — a restart must not reopen the
            # split-brain the fence closed.
            try:
                self.fenced_by = int(raw_fenced.decode())
            except ValueError:
                pass
        if role == "primary":
            # Durable restores keep their snapshot epoch; fresh stores
            # start at 1.  Followers do NOT seed: replication delivers
            # the primary's epoch with the first snapshot replay.
            self.backend.create_only(EPOCH_KEY, b"1")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.address = "%s:%d" % self._listener.getsockname()[:2]
        self._sessions: list[_Session] = []
        self._lease_owner: dict[str, _Session] = {}
        self._mutex = threading.Lock()
        self._stopped = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="kvstore-accept"
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.send_timeout:
                sec = int(self.send_timeout)
                usec = int((self.send_timeout - sec) * 1_000_000)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                                struct.pack("ll", sec, usec))
            sess = _Session(self, sock, f"{addr[0]}:{addr[1]}")
            with self._mutex:
                self._sessions.append(sess)
            threading.Thread(
                target=sess.serve, daemon=True, name="kvstore-session"
            ).start()

    def _drop_session(self, sess: _Session) -> None:
        with self._mutex:
            if sess in self._sessions:
                self._sessions.remove(sess)

    # -- fencing -----------------------------------------------------------

    @property
    def epoch(self) -> int:
        """This server's fencing epoch (read from the key space so a
        follower's replicated epoch and a promoted epoch need no
        separate bookkeeping)."""
        raw = self.backend.get(EPOCH_KEY)
        if not raw:
            return 0
        try:
            return int(raw.decode())
        except ValueError:
            return 0

    @property
    def fenced(self) -> bool:
        """Fencing is RELATIVE to the current epoch: a replicating
        follower that briefly trailed a client's observed epoch stops
        being fenced once replication (or promotion) catches its epoch
        up; a stale primary can never raise its epoch and stays fenced
        forever."""
        return self.fenced_by > self.epoch

    @property
    def writable(self) -> bool:
        return self.role == "primary" and not self.fenced

    def fence(self, epoch: int) -> bool:
        """Record proof that a primacy at ``epoch`` exists.  Above our
        own epoch, this server is fenced: every subsequent write is
        rejected with EPOCH_FENCED until (if ever) our own epoch
        catches up.  Idempotent; returns True on the transition."""
        if epoch <= self.epoch:
            return False
        with self._mutex:
            if self.fenced_by >= epoch:
                return False
            first = self.fenced_by <= self.epoch
            self.fenced_by = epoch
        # Durability before visibility: a snapshot-backed server must
        # restart still-fenced (the fencer thread stops after one ack,
        # trusting this persists).
        try:
            self.backend.set(FENCED_KEY, str(epoch).encode())
        except Exception as e:  # noqa: BLE001 — fencing still holds
            self.counters.inc("server_fence_persist_failed")  # in memory
            log.warning("could not persist fence marker: %s", e)
        if first:
            self.counters.inc("server_fenced")
            log.warning(
                "kvstore %s (epoch %d) fenced by epoch %d: rejecting "
                "writes", getattr(self, "address", "?"), self.epoch, epoch,
            )
        return first

    def _epoch_gate(self, req: dict) -> int:
        """Per-request fencing check (runs before dispatch); returns
        the server epoch (read ONCE — the property walks the backend)
        for the response.  The client-carried epoch doubles as a
        gossip channel: any client that has touched a newer primary
        fences this server on contact, even while the promoted
        follower cannot reach it."""
        epoch = self.epoch
        observed = int(req.get("epoch", 0) or 0)
        if observed > epoch:
            self.fence(observed)
        if req.get("op", "") not in WRITE_OPS:
            return epoch
        if self.fenced_by > epoch:
            self.counters.inc("server_write_rejected_fenced")
            raise EpochFencedError(
                f"EPOCH_FENCED: server epoch {epoch} fenced by "
                f"epoch {self.fenced_by}", epoch=self.fenced_by,
            )
        if self.role != "primary":
            self.counters.inc("server_write_rejected_not_primary")
            raise NotPrimaryError(
                f"replicating follower (epoch {epoch}) does not "
                f"accept writes", epoch=epoch,
            )
        return epoch

    def close(self) -> None:
        self._stopped = True
        # shutdown() first: it wakes the accept loop so the listening
        # fd actually releases (close() alone leaves the thread parked
        # in accept() holding the socket, and the port stays bound).
        shutdown_close(self._listener)
        with self._mutex:
            sessions = list(self._sessions)
        for s in sessions:
            s.cleanup()


class KvstoreFollower(KvstoreServer):
    """Snapshot-shipping replica with fenced failover: a full
    KvstoreServer whose store is kept in sync from a primary over the
    primary's own watch protocol (list_and_watch("") replays the
    complete snapshot, then streams every mutation).  Clients list the
    follower after the primary in their failover list; when the
    primary dies they redial here and find the replicated state,
    re-claiming their leased keys on fresh sessions (reference role:
    the second interchangeable networked backend behind
    BackendOperations, pkg/kvstore/backend.go:86).

    While replicating, the follower serves reads and watches but
    REJECTS writes (not_primary): anything it accepted could be pruned
    at the next LIST_DONE resync — the silent-loss path fencing
    removes.  When the replication stream dies for good (reconnect
    budget ``repl_timeout`` exhausted) and ``failover_grace`` passes,
    the follower PROMOTES: it durably CAS-claims epoch N+1 in its own
    store, becomes the writable primary, never resubscribes to the old
    primary (so no accepted write can ever be pruned), and keeps
    dialing the old primary's address in the background to fence it
    the moment a partition heals.  See the module docstring for the
    full epoch state machine and the documented LWW window."""

    def __init__(self, primary_address: str, host: str = "127.0.0.1",
                 port: int = 0, backend: Backend | None = None,
                 snapshot_path: str | None = None,
                 repl_timeout: float = 5.0,
                 failover_grace: float = 0.25,
                 auto_promote: bool = True) -> None:
        # Dial the primary BEFORE binding our own listener: a follower
        # pointed at a dead/wrong primary must fail its constructor
        # without leaking a live listening socket + accept thread.
        self.primary_address = primary_address
        self.synced = threading.Event()
        self.promoted = threading.Event()
        self.replicating = True
        self.failover_grace = failover_grace
        self.auto_promote = auto_promote
        self._closing = False
        self._promote_lock = threading.Lock()
        self._repl_client = NetBackend(primary_address, timeout=repl_timeout)
        try:
            self._repl_watch = self._repl_client.list_and_watch(
                "replica", ""
            )
            # Reconnect boundaries must be visible: the prune-at-
            # LIST_DONE reconciliation needs to know where a fresh
            # snapshot replay starts.
            self._repl_watch.mark_resync = True
            super().__init__(host, port, backend=backend,
                             snapshot_path=snapshot_path, role="follower")
        except Exception:
            self._repl_client.close()
            raise
        self._repl_thread = threading.Thread(
            target=self._replicate, daemon=True, name="kvstore-replica"
        )
        self._repl_thread.start()
        # Heartbeat against the primary: a SILENT partition (TCP
        # session up, bytes blackholed) produces no stream error at
        # all — without an end-to-end probe the follower would wait
        # forever and never fail over (reference: etcd keepalives /
        # consul session TTLs detect exactly this).
        self._hb_interval = max(repl_timeout / 2.0, 0.25)
        threading.Thread(
            target=self._heartbeat, daemon=True, name="kvstore-replica-hb"
        ).start()

    def _heartbeat(self) -> None:
        misses = 0
        while not self._closing and self.replicating:
            time.sleep(self._hb_interval)
            if self._closing or not self.replicating:
                return
            if self._repl_client.ping():
                misses = 0
                continue
            misses += 1
            if misses < 2:  # one miss can be a blip mid-reconnect
                continue
            self.counters.inc("replica_heartbeat_dead")
            log.warning(
                "kvstore follower %s: replication heartbeat to %s lost; "
                "declaring the primary dead", self.address,
                self.primary_address,
            )
            # Stopping the watch ends the _replicate loop, whose exit
            # path runs the grace + promotion sequence.
            try:
                self._repl_watch.stop()
            except Exception:  # noqa: BLE001
                pass
            try:
                self._repl_client.close()
            except Exception:  # noqa: BLE001
                pass
            return

    def _replicate(self) -> None:
        # Every snapshot replay (initial sync AND post-reconnect
        # resubscription) ends in LIST_DONE; at that barrier the local
        # store is pruned to the replayed key set, so deletions that
        # happened while the stream was down — or stale keys restored
        # from this follower's own snapshot file — cannot survive as
        # resurrected state.  A key written directly to this follower
        # inside a primary-blip window is pruned too: while the primary
        # lives, it is authoritative (last-write-wins toward primary;
        # no arbitration — see class docstring).
        seen: set[str] = set()
        try:
            for ev in self._repl_watch:
                if ev.typ == EventType.RESYNC:
                    # Stream re-established: the marker was enqueued
                    # BEFORE the fresh replay, so stale pre-blip events
                    # are already behind us — restart the seen set.
                    seen = set()
                    continue
                try:
                    if ev.typ == EventType.LIST_DONE:
                        for k in list(self.backend.list_prefix("")):
                            if k not in seen:
                                self.backend.delete(k)
                        self.synced.set()
                    elif ev.typ == EventType.DELETE:
                        self.backend.delete(ev.key)
                        seen.discard(ev.key)
                    else:  # CREATE / MODIFY
                        # lease-ness travels with the event: leased keys
                        # stay out of a durable follower's snapshot file
                        # (they die with their sessions; the owner
                        # re-claims them after failover via 'reclaim').
                        self.backend.set(ev.key, ev.value, lease=ev.lease)
                        seen.add(ev.key)
                except Exception:  # noqa: BLE001 — one bad apply must
                    self.counters.inc("replica_apply_failed")  # not kill
                    log.exception("replica apply failed: %s", ev.key)
        except Exception:  # noqa: BLE001 — replica must not die noisily
            self.counters.inc("replica_stream_failed")
        finally:
            # Stream ended for good: primary gone (or follower
            # closing).  This store IS the surviving copy — claim the
            # next epoch and take over, or (auto_promote=False) keep
            # serving reads and wait for an operator.
            self.replicating = False
            if self.auto_promote and not self._closing:
                if self.failover_grace:
                    time.sleep(self.failover_grace)
                if not self._closing:
                    self.promote()

    def promote(self) -> bool:
        """Durable epoch claim + role flip, in that order: the epoch
        N+1 claim lands in this store's snapshot BEFORE any write is
        accepted, so a restart of the new primary can never come back
        believing it is still at the old epoch.  CAS against the last
        replicated epoch: a concurrent external epoch mutation fails
        the claim instead of being silently overwritten.

        Callable by an operator (auto_promote=False planned failover)
        as well as the auto path — so it severs a still-live
        replication stream FIRST: a promoted server must never apply
        another snapshot replay, or the LIST_DONE prune would eat the
        writes it acknowledged."""
        with self._promote_lock:
            return self._promote_locked()

    def _promote_locked(self) -> bool:
        if self.promoted.is_set():
            return True
        if self.replicating:
            # Operator-initiated promotion with the stream still up:
            # cut it.  The closed repl client can never resubscribe,
            # so no replay (and no prune) can follow the claim; the
            # _replicate thread's own exit path re-enters promote()
            # and no-ops on the promoted event.
            try:
                self._repl_watch.stop()
            except Exception:  # noqa: BLE001
                pass
            try:
                self._repl_client.close()
            except Exception:  # noqa: BLE001
                pass
            self.replicating = False
        if self.epoch <= 0 and self.fenced_by <= 0:
            # Initial sync never delivered the primary's epoch: we do
            # not know what epoch the primary owns, so any claim we
            # made could COLLIDE with it (claiming 1 against a seed-1
            # primary makes fencing permanently inert — both sides
            # writable at the same epoch, the exact split-brain this
            # machinery prevents).  An unsynced follower has nothing
            # worth serving as primary anyway: stay read-only.
            self.counters.inc("follower_promote_refused_unsynced")
            log.warning(
                "kvstore follower %s refusing promotion: initial sync "
                "never completed (unknown primary epoch)", self.address,
            )
            return False
        cur_raw = self.backend.get(EPOCH_KEY)
        # Claim above everything we have seen: the replicated epoch
        # AND any higher epoch we were fenced by.
        new = max(self.epoch, self.fenced_by) + 1
        if not self.backend.compare_and_swap(
            EPOCH_KEY, cur_raw, str(new).encode()
        ):
            self.counters.inc("follower_promote_cas_failed")
            log.warning("kvstore follower promotion CAS failed")
            return False
        self.role = "primary"
        self.promoted.set()
        self.counters.inc("follower_promoted")
        log.warning(
            "kvstore follower %s promoted to primary at epoch %d "
            "(old primary %s will be fenced)",
            self.address, new, self.primary_address,
        )
        threading.Thread(
            target=self._fence_old_primary, args=(new,), daemon=True,
            name="kvstore-fencer",
        ).start()
        return True

    def _fence_old_primary(self, epoch: int) -> None:
        """Keep dialing the old primary until it acknowledges the
        fence: during a partition the dial fails and backs off; the
        moment the partition heals, the old primary learns a newer
        epoch exists and rejects writes from then on.  (Clients that
        touched the new primary fence it on contact too — this thread
        just closes the no-client-crosses-over gap.)"""
        boff = Exponential(min_duration=0.2, max_duration=2.0,
                           name="kvstore-fence")
        while not self._closing:
            try:
                c = NetBackend(self.primary_address, timeout=2.0)
                try:
                    r = c._request({"op": "fence", "fence_epoch": epoch})
                    if r.get("fenced"):
                        self.counters.inc("old_primary_fenced")
                        log.info("old primary %s fenced at epoch %d",
                                 self.primary_address, epoch)
                        return
                finally:
                    c.close()
            except (KvstoreError, OSError):
                pass
            boff.wait()

    def close(self) -> None:
        self._closing = True
        try:
            self._repl_watch.stop()
        except Exception:  # noqa: BLE001
            pass
        try:
            self._repl_client.close()
        except Exception:  # noqa: BLE001
            pass
        super().close()


# ---------------------------------------------------------------------------
# Client

class _NetLock:
    def __init__(self, backend: "NetBackend", path: str) -> None:
        self._backend = backend
        self._path = path
        self._held = True
        self.lost = False  # session died: the server released this lock

    def unlock(self) -> None:
        if self.lost:
            # Surface the mutual-exclusion violation instead of
            # pretending the critical section was protected
            # (reference: etcd session loss fails the lock holder).
            self._held = False
            raise LockError(f"lock {self._path} lost on session reconnect")
        if self._held:
            self._held = False
            with self._backend._mutex:
                try:
                    self._backend._locks.remove(self)
                except ValueError:
                    pass
            self._backend._request(
                {"op": "unlock", "path": self._path}, retryable=False
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.unlock()


class NetBackend(Backend):
    """Client Backend speaking to a KvstoreServer over TCP.

    One socket per backend; a reader thread routes responses to waiting
    callers and watch events to their Watcher queues (so watches stay
    live while requests block).

    ``address`` may be a comma-separated failover list
    ("host1:port1,host2:port2"): the client connects to the first
    reachable server and, on connection loss, walks the list in order
    during reconnect — a primary + KvstoreFollower pair gives the
    cluster store a survivable failure mode (reference: the etcd
    client's endpoint list, pkg/kvstore/etcd.go config)."""

    def __init__(self, address: str, timeout: float = 10.0) -> None:
        self.addresses = [a.strip() for a in address.split(",") if a.strip()]
        if not self.addresses:
            raise KvstoreError("no kvstore address given")
        self.address = self.addresses[0]
        self.timeout = timeout
        self.counters = KvstoreCounters("client")
        # Highest fencing epoch observed on any response: carried on
        # every request (the gossip that fences stale primaries) and
        # surfaced through daemon status / `cilium kvstore status`.
        self.epoch = 0
        self.sock = self._dial_any(first=True)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._mutex = threading.Lock()
        self._seq = 0
        self._pending: dict[int, queue.Queue] = {}
        self._watchers: dict[int, Watcher] = {}
        self._closed = False
        # Reconnect state (reference: pkg/kvstore reconnect with
        # pkg/backoff + lease keepalive): session-owned leased keys are
        # replayed on a fresh session, active watches re-subscribed.
        self._leased: dict[str, bytes] = {}
        self._watch_specs: dict[int, tuple[str, str]] = {}
        self._reconnect_lock = threading.Lock()
        self._generation = 0
        # Session-rebuild gate: cleared while a reconnect has swapped
        # the socket but not yet finished replaying leased keys and
        # watches; _request waits on it so no caller can observe a
        # half-rebuilt session as healthy (see _request).
        self._ready = threading.Event()
        self._ready.set()
        self._conn_dead = False  # reader saw EOF; requests must redial
        self._locks: list[_NetLock] = []  # held locks (loss marking)
        self.reconnects = 0
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="kvstore-client-read"
        )
        self._reader.start()

    # -- plumbing ----------------------------------------------------------

    def _dial_any(self, first: bool = False) -> socket.socket:
        """Connect to the first reachable address, starting from the
        CURRENT one: after a failover, a blip must not silently fail
        back to a restarted (possibly empty) primary while other
        clients remain on the follower — sticking to the current
        server keeps the fleet convergent (fail-back is an operator
        action: restart clients with the primary first).  Records the
        connected address in self.address."""
        ordered = [self.address] + [
            a for a in self.addresses if a != self.address
        ]
        last_err: Exception | None = None
        for addr in ordered:
            host, _, port = addr.rpartition(":")
            try:
                sock = socket.create_connection(
                    (host, int(port)), timeout=10.0 if first else 2.0
                )
            except OSError as e:
                last_err = e
                continue
            if addr != self.address:
                self.counters.inc("client_failover")
                log.warning("kvstore failover: %s -> %s", self.address, addr)
            self.address = addr
            return sock
        raise KvstoreError(f"no kvstore server reachable: {last_err}")

    def _read_loop(self) -> None:
        # Capture this thread's session: a stale reader (superseded by a
        # reconnect) must neither recv from the NEW socket nor mark the
        # new session dead.
        with self._mutex:
            gen = self._generation
            sock = self.sock
        try:
            while True:
                msg = _recv_frame(sock)
                if "event" in msg:
                    ev = msg["event"]
                    w = self._watchers.get(int(ev["wid"]))
                    if w is not None and not w.stopped:
                        w.events.put(KeyValueEvent(
                            EventType(ev["type"]), ev["key"],
                            bytes.fromhex(ev["value"]),
                            lease=bool(ev.get("lease")),
                        ))
                    continue
                with self._mutex:
                    q = self._pending.pop(msg.get("id"), None)
                if q is not None:
                    q.put(msg)
        except (ConnectionError, OSError) as e:
            self.counters.inc("client_conn_lost")
            log.debug("kvstore client connection lost: %s", e)
        except ValueError as e:
            self.counters.inc("client_malformed_frame")
            log.warning("kvstore client malformed frame: %s", e)
        finally:
            with self._mutex:
                stale = self._generation != gen
            if not stale:
                self._conn_dead = True
                self._fail_pending()
                # Watch-only clients make no requests, so nothing would
                # ever trigger the reconnect path for them: recover (or
                # signal loss) in the background.
                if not self._closed:
                    threading.Thread(
                        target=self._background_reconnect, args=(gen,),
                        name="kvstore-reconnect", daemon=True,
                    ).start()

    def _background_reconnect(self, gen: int) -> None:
        if not self._reconnect(gen) and not self._closed:
            # Could not rebuild the session within the backoff budget:
            # stop the watchers so consumers SEE the loss instead of
            # waiting forever on a silent stream.
            with self._mutex:
                watchers = list(self._watchers.values())
                self._watchers.clear()
                self._watch_specs.clear()
            for w in watchers:
                w.stop()

    def _fail_pending(self) -> None:
        with self._mutex:
            pending = list(self._pending.values())
            self._pending.clear()
            # Watchers are only torn down on a clean close; an abnormal
            # connection loss keeps them registered so _reconnect can
            # re-subscribe them (they see a fresh snapshot replay).
            watchers = list(self._watchers.values()) if self._closed else []
            if self._closed:
                self._watchers.clear()
        for q in pending:
            q.put({"ok": False, "error": "kvstore connection lost"})
        for w in watchers:
            w.stop()

    def _reconnect(self, observed_gen: int) -> bool:
        """Dial a fresh session and rebuild session state: replay
        leased keys (the keepalive re-registration analog) and
        re-subscribe active watches.  Backoff-bounded; only one caller
        reconnects per generation."""
        with self._reconnect_lock:
            if self._closed:
                return False
            if self._generation != observed_gen:
                return True  # someone else already reconnected
            boff = Exponential(min_duration=0.05, max_duration=1.0,
                               name="kvstore-reconnect")
            deadline = time.monotonic() + self.timeout
            while True:
                try:
                    # Walks the failover list: a dead primary falls
                    # through to the follower.
                    # lint: disable=R2 -- one reconnect per generation holds _reconnect_lock across the dial by design; contenders need this attempt's outcome and each dial leg is settimeout-bounded
                    sock = self._dial_any()
                    break
                except KvstoreError:
                    delay = boff.duration()
                    if time.monotonic() + delay > deadline:
                        return False
                    # lint: disable=R2 -- one reconnect per generation serializes the whole walk by design; contenders need this attempt's outcome and would only dial in parallel
                    time.sleep(delay)
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Close the ready gate for the duration of the rebuild: the
            # fresh socket becomes visible to _request_once NOW, but the
            # session is not healthy until the replay lands (see the
            # _request docstring note) — reopened in the finally below
            # whatever the outcome.
            self._ready.clear()
            # shutdown-then-close: the old generation's reader may be
            # parked in recv on this socket (a writer detected the
            # death first) — wake it so it exits instead of holding
            # the dead fd to process exit.
            shutdown_close(self.sock)
            with self._mutex:
                self.sock = sock
                self._generation += 1
                self._conn_dead = False
                self.reconnects += 1
                # Server-side session death released every lock this
                # client held: mark them lost so holders find out.
                locks = list(self._locks)
                self._locks.clear()
            for lk in locks:
                lk.lost = True
            reader = threading.Thread(
                target=self._read_loop, name="kvstore-net-reader", daemon=True
            )
            self._reader = reader
            reader.start()
            # Replay session-owned state on the fresh session.
            try:
                # lint: disable=R2 -- replay must finish before any contender sees the fresh generation; its sleeps/sends are backoff- and timeout-bounded
                self._replay_session()
            except KvstoreError as e:
                if isinstance(e, (EpochFencedError, NotPrimaryError)):
                    # Rebuilt onto a stale server (fenced) or a
                    # follower that is not promoting (replicating from
                    # a live primary we blipped off): rotate the
                    # address forward so the NEXT attempt dials toward
                    # the writable server instead of re-poisoning here.
                    self._rotate_address()
                # Half-rebuilt sessions are poison: tear the connection
                # down again so the next attempt replays from scratch.
                self._conn_dead = True
                try:
                    sock.close()
                except OSError:
                    pass
                return False
            finally:
                # Reopen the ready gate WHATEVER the outcome: success
                # lets waiters proceed on the healthy session; failure
                # lets them observe the dead one and drive their own
                # reconnect instead of parking forever.
                self._ready.set()
            return True

    def _replay_session(self) -> None:
        """Rebuild session state on a fresh connection: replay leased
        keys (the keepalive re-registration analog), then re-subscribe
        watches.  Each step is IDEMPOTENT (create_only falls through
        to the self-tolerant server-side reclaim; watch registration
        happens once per wid), so a not_primary rejection from a
        follower that has not promoted yet backs off and resumes where
        it left — the normal post-failover path while the follower
        claims its epoch."""
        with self._mutex:
            leased = dict(self._leased)
            specs = dict(self._watch_specs)
        # RESYNC markers land BEFORE the re-subscriptions, so
        # everything behind the marker in an opted-in watcher's
        # queue is pre-blip and everything after it is the
        # fresh snapshot replay — the follower's prune depends
        # on this ordering.
        for wid in specs:
            w = self._watchers.get(wid)
            if w is not None and w.mark_resync and not w.stopped:
                w.events.put(KeyValueEvent(EventType.RESYNC))
        boff = Exponential(min_duration=0.05, max_duration=0.5,
                           name="kvstore-replay")
        deadline = time.monotonic() + self.timeout
        pending_leases = dict(leased)
        pending_watches = dict(specs)
        while pending_leases or pending_watches:
            try:
                while pending_leases:
                    key, value = next(iter(pending_leases.items()))
                    # create_only: the old session's lease revocation
                    # may have let another client legitimately claim
                    # the key — never clobber it, drop our stale claim
                    # instead.
                    r = self._request_once(
                        {"op": "create_only", "key": key,
                         "value": value.hex(), "lease": True}
                    )
                    if not r["created"]:
                        # On a FOLLOWER after failover the key exists
                        # as our own replicated ghost (no owning
                        # session).  The server-side reclaim atomically
                        # re-takes lease ownership iff the value is
                        # bit-identical AND no other live session owns
                        # the key; anything else means another client
                        # genuinely claimed it — drop our stale claim.
                        rr = self._request_once(
                            {"op": "reclaim", "key": key,
                             "value": value.hex()}
                        )
                        if not rr.get("taken"):
                            log.warning(
                                "leased key %s re-claimed elsewhere; "
                                "dropping local claim", key,
                            )
                            with self._mutex:
                                self._leased.pop(key, None)
                    pending_leases.pop(key)
                while pending_watches:
                    wid, (name, prefix) = next(
                        iter(pending_watches.items())
                    )
                    self._request_once(
                        {"op": "watch", "wid": wid, "key": prefix,
                         "name": name}
                    )
                    pending_watches.pop(wid)
            except NotPrimaryError:
                self.counters.inc("client_not_primary_retry")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise
                time.sleep(min(boff.duration(), max(remaining, 0.0)))

    def _request(self, req: dict, timeout: float | None = None,
                 retryable: bool = True) -> dict:
        """One round trip with typed retry classification:

        - TRANSPORT loss: reconnect (walking the failover list) and
          retry, backing off until self.timeout — idempotent ops only.
          Non-idempotent ops (CAS creates, locks) are NEVER blindly
          retried: the first attempt may have been applied with its
          response lost, and a retry would mis-report the outcome —
          callers re-run their own logic instead (reference: etcd
          client retry semantics for non-idempotent mutations).
        - NOT_PRIMARY: the follower rejected BEFORE applying, so every
          op — CAS creates included — retries safely; back off
          (jittered exponential, utils.backoff) until the follower
          promotes or the primary returns, bounded by self.timeout.
        - EPOCH_FENCED: the server is stale; redial FORWARD along the
          failover list toward the newer primary and retry (again
          rejected-before-apply, so always safe).  With nowhere
          forward to go, the typed error surfaces to the caller.
        """
        boff = Exponential(min_duration=0.05, max_duration=0.5,
                           name="kvstore-request")
        deadline = time.monotonic() + self.timeout
        np_retries = 0
        while True:
            # Half-rebuilt sessions are poison for CALLERS too: a
            # reconnect swaps the fresh socket in before replaying
            # leased keys/watches, and a request slipping through on it
            # (a ping served by a still-replicating follower) reports
            # the session healthy while the replay is still owed — a
            # caller that then close()s aborts the replay and strands
            # its leased keys as unowned ghosts on the follower,
            # unrevokable forever.  Wait out the rebuild (bounded by
            # this request's own deadline; the reconnect path sets the
            # gate in a finally, so a failed rebuild releases waiters
            # to observe the dead session and retry themselves).
            if not self._ready.wait(max(deadline - time.monotonic(), 0.0)):
                raise KvstoreError("kvstore session rebuild timed out")
            gen = self._generation
            try:
                return self._request_once(req, timeout)
            except NotPrimaryError:
                self.counters.inc("client_not_primary_retry")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise
                np_retries += 1
                if np_retries % 4 == 0 and len(self.addresses) > 1:
                    # We may have landed on a follower during a mere
                    # primary BLIP: the follower keeps replicating from
                    # the live primary and will never promote, so
                    # waiting here would wedge until the deadline.
                    # Probe around the ring — if the primary is back,
                    # the write lands there; if not, the dial falls
                    # through the failover list right back here.
                    self._redial_forward(gen)
                    continue
                time.sleep(min(boff.duration(), max(remaining, 0.0)))
            except EpochFencedError:
                self.counters.inc("client_fenced")
                if time.monotonic() >= deadline:
                    raise
                if not self._redial_forward(gen):
                    raise
            except KvstoreError as e:
                transport = (
                    "connection lost" in str(e) or "send failed" in str(e)
                )
                if self._closed or not transport:
                    raise
                if not retryable:
                    # Still rebuild the session for later calls.
                    self._reconnect(gen)
                    raise
                if time.monotonic() >= deadline:
                    raise
                if not self._reconnect(gen):
                    # _reconnect spent its own dial budget; one more
                    # pass through the loop only if time remains.
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise
                    time.sleep(min(boff.duration(), max(remaining, 0.0)))

    def _rotate_address(self) -> bool:
        """Advance self.address to the next entry of the failover
        list; False with nowhere to go."""
        with self._mutex:
            if len(self.addresses) <= 1:
                return False
            cur = self.address
            try:
                i = self.addresses.index(cur)
            except ValueError:
                i = -1
            nxt = self.addresses[(i + 1) % len(self.addresses)]
            if nxt == cur:
                return False
            self.address = nxt
        log.warning("kvstore %s not writable; redialing forward to %s",
                    cur, nxt)
        return True

    def _redial_forward(self, observed_gen: int) -> bool:
        """Rotate to the next address in the failover list and rebuild
        the session there — the reaction to EPOCH_FENCED: the newer
        primary is FORWARD in the list, and sticking to the fenced
        server would strand every write."""
        if not self._rotate_address():
            return False
        self.counters.inc("client_fence_redial")
        # Sever the old session; _reconnect (generation-guarded against
        # the reader's own background redial) rebuilds it against the
        # rotated address.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        return self._reconnect(observed_gen)

    def _request_once(self, req: dict, timeout: float | None = None) -> dict:
        if self._closed:
            raise KvstoreError("kvstore client closed")
        if self._conn_dead:
            # Fail fast into the reconnect path instead of sending into
            # a dead socket and waiting out the timeout.
            raise KvstoreError("kvstore connection lost")
        req["epoch"] = self.epoch
        with self._mutex:
            self._seq += 1
            rid = self._seq
            q: queue.Queue = queue.Queue(maxsize=1)
            self._pending[rid] = q
        req["id"] = rid
        with self._wlock:
            try:
                # lint: disable=R2 -- _wlock exists to serialize frame writes on the shared socket; a dead peer raises immediately and a wedged one is bounded by the reader's liveness teardown
                _send_frame(self.sock, req)
            except OSError as e:
                with self._mutex:
                    self._pending.pop(rid, None)
                raise KvstoreError(f"kvstore send failed: {e}")
        try:
            resp = q.get(timeout=timeout if timeout is not None else self.timeout)
        except queue.Empty:
            with self._mutex:
                self._pending.pop(rid, None)
            raise KvstoreError(f"kvstore request timed out: {req['op']}")
        self._observe_epoch(resp)
        if not resp.get("ok"):
            kind = resp.get("kind")
            if kind == "lock":
                raise LockError(resp.get("error", "lock failed"))
            if kind == "epoch_fenced":
                raise EpochFencedError(
                    resp.get("error", "EPOCH_FENCED"),
                    epoch=int(resp.get("epoch", 0) or 0),
                )
            if kind == "not_primary":
                raise NotPrimaryError(
                    resp.get("error", "not primary"),
                    epoch=int(resp.get("epoch", 0) or 0),
                )
            raise KvstoreError(resp.get("error", "kvstore error"))
        return resp

    def _observe_epoch(self, resp: dict) -> None:
        try:
            e = int(resp.get("epoch", 0) or 0)
        except (TypeError, ValueError):
            return
        if e > self.epoch:
            self.epoch = e

    # -- Backend interface -------------------------------------------------

    def status(self) -> str:
        try:
            r = self._request({"op": "status"})
            role = r.get("role", "?")
            fenced = " FENCED" if r.get("fenced") else ""
            return (
                f"tcp {self.address}: connected ({r['status']}; "
                f"role={role} epoch={self.epoch}{fenced})"
            )
        except KvstoreError as e:
            return f"tcp {self.address}: failure - {e}"

    def server_info(self) -> dict:
        """Structured store status for `cilium kvstore status` and the
        daemon status section: role, fencing epoch, replication state,
        server+client counters."""
        r = self._request({"op": "status"})
        return {
            "address": self.address,
            "addresses": list(self.addresses),
            "role": r.get("role", "?"),
            "epoch": self.epoch,
            "fenced": bool(r.get("fenced")),
            "fenced_by": int(r.get("fenced_by", 0) or 0),
            "replicating": bool(r.get("replicating")),
            "backend": r.get("status", ""),
            "server_counters": r.get("counters", {}),
            "client_counters": self.counters.snapshot(),
            "reconnects": self.reconnects,
        }

    def lock_path(self, path: str, timeout: float | None = 10.0) -> _NetLock:
        t = timeout if timeout is not None else 60.0
        # Transport-retry IS safe for locks, uniquely among the
        # non-idempotent ops: a grant is bound to the SESSION, and a
        # transport loss kills the session — whatever the lost first
        # attempt acquired is released by server-side session cleanup,
        # so the retry (on a fresh session) can block briefly but
        # never double-acquire.  This is what lets the allocator ride
        # through a failover instead of surfacing every blip.
        self._request(
            {"op": "lock", "path": path, "timeout": t}, timeout=t + 5.0,
        )
        lock = _NetLock(self, path)
        with self._mutex:
            self._locks.append(lock)
        return lock

    def get(self, key: str) -> Optional[bytes]:
        r = self._request({"op": "get", "key": key})
        return bytes.fromhex(r["value"]) if r["found"] else None

    def get_prefix(self, prefix: str) -> Optional[bytes]:
        r = self._request({"op": "get_prefix", "key": prefix})
        return bytes.fromhex(r["value"]) if r["found"] else None

    def set(self, key: str, value: bytes, lease: bool = False) -> None:
        self._request(
            {"op": "set", "key": key, "value": value.hex(), "lease": lease}
        )
        with self._mutex:
            if lease:
                self._leased[key] = value
            else:
                self._leased.pop(key, None)

    def delete(self, key: str) -> None:
        self._request({"op": "delete", "key": key})
        with self._mutex:
            self._leased.pop(key, None)

    def delete_prefix(self, prefix: str) -> None:
        self._request({"op": "delete_prefix", "key": prefix})
        with self._mutex:
            for k in [k for k in self._leased if k.startswith(prefix)]:
                del self._leased[k]

    def create_only(self, key: str, value: bytes, lease: bool = False) -> bool:
        r = self._request({
            "op": "create_only", "key": key, "value": value.hex(),
            "lease": lease,
        }, retryable=False)
        if r["created"] and lease:
            with self._mutex:
                self._leased[key] = value
        return bool(r["created"])

    def create_if_exists(self, cond_key: str, key: str, value: bytes,
                         lease: bool = False) -> bool:
        r = self._request({
            "op": "create_if_exists", "cond_key": cond_key, "key": key,
            "value": value.hex(), "lease": lease,
        }, retryable=False)
        if r["created"] and lease:
            with self._mutex:
                self._leased[key] = value
        return bool(r["created"])

    def list_prefix(self, prefix: str) -> dict[str, bytes]:
        r = self._request({"op": "list_prefix", "key": prefix})
        return {k: bytes.fromhex(v) for k, v in r["items"].items()}

    def list_and_watch(self, name: str, prefix: str) -> Watcher:
        with self._mutex:
            self._seq += 1
            wid = self._seq
        w = _NetWatcher(self, wid, name, prefix)
        # Register BEFORE the request: the server's snapshot replay can
        # arrive before the watch response.
        self._watchers[wid] = w
        with self._mutex:
            self._watch_specs[wid] = (name, prefix)
        try:
            self._request(
                {"op": "watch", "wid": wid, "key": prefix, "name": name}
            )
        except KvstoreError:
            self._watchers.pop(wid, None)
            with self._mutex:
                self._watch_specs.pop(wid, None)
            raise
        return w

    def ping(self) -> bool:
        try:
            self._request({"op": "ping"})
            return True
        except KvstoreError:
            return False

    def _stop_watch(self, wid: int) -> None:
        self._watchers.pop(wid, None)
        with self._mutex:
            self._watch_specs.pop(wid, None)
        if not self._closed:
            try:
                self._request({"op": "watch_stop", "wid": wid})
            except KvstoreError:
                pass

    def close(self) -> None:
        """Clean session end: the server revokes this session's leases
        (reference: lease expiry on client shutdown)."""
        if self._closed:
            return
        self._closed = True
        # Release any request parked on the session-rebuild gate: the
        # client is terminal, so waiters must fail fast (_request_once
        # raises on _closed) instead of waiting out their deadline.
        self._ready.set()
        # shutdown() first: close() alone does not send FIN while the
        # reader thread is blocked in recv on the same fd, so the server
        # would never see the session die (and leases would leak).
        shutdown_close(self.sock)
        self._fail_pending()


class _NetWatcher(Watcher):
    def __init__(self, backend: NetBackend, wid: int, name: str,
                 prefix: str) -> None:
        super().__init__(name, prefix)
        self._backend = backend
        self._wid = wid

    def stop(self) -> None:
        if not self.stopped:
            super().stop()
            self._backend._stop_watch(self._wid)
