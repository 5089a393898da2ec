"""TCP fault-injection proxy for the cluster-state plane.

Sits between any kvstore client (or replicating follower) and a
server, forwarding the length-prefixed frame stream byte-for-byte
while injecting the failure modes the fenced-failover machinery must
survive (reference role: the toxiproxy-style harnesses cilium's etcd
upgrade/partition CI uses; here in-process so tests and bench.py can
script partitions deterministically):

  - partition(direction): blackhole bytes in one or both directions —
    live connections stay open and silent (a true partition: no FIN,
    no RST), and while fully partitioned NEW connections are accepted
    and immediately dropped, so a dialing client sees the same
    dead-network behavior the established ones do.
  - set_delay(seconds): hold every chunk before forwarding (one-way
    latency).
  - set_drop_rate(p): drop a random fraction of forwarded chunks —
    mid-stream loss that corrupts frame alignment, exercising the
    malformed-frame counters and session teardown.
  - set_trickle(bytes_per_sec): forward in 64-byte slices at a
    bounded rate — the slow-network mode that stretches snapshot
    replays across many scheduler quanta.
  - reset_all(): RST every live connection (SO_LINGER 0) — the blip
    that triggers client reconnects without a partition.

All switches are live (no restart); heal() clears partition state.
Counters expose forwarded/dropped volume for bench assertions.
"""

from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import time

from ..utils.sockutil import shutdown_close

log = logging.getLogger(__name__)


class ChaosProxy:
    def __init__(self, target: str, host: str = "127.0.0.1",
                 port: int = 0, seed: int = 0xC1A05) -> None:
        h, _, p = target.rpartition(":")
        self._target = (h, int(p))
        self._rng = random.Random(seed)
        self._mutex = threading.Lock()
        self._partitioned: set[str] = set()  # subset of {"c2s", "s2c"}
        self._delay = 0.0
        self._drop_rate = 0.0
        self._trickle_bps = 0  # 0 = unlimited
        self._conns: list[tuple[socket.socket, socket.socket]] = []
        self._stopped = False
        self.counters = {
            "connections": 0, "refused": 0,
            "bytes_c2s": 0, "bytes_s2c": 0, "chunks_dropped": 0,
        }
        self._listener: socket.socket | None = None
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(64)
        self._host, self._port = listener.getsockname()[:2]
        self.address = f"{self._host}:{self._port}"
        self._start_listener(listener)

    def _start_listener(self, listener: socket.socket) -> None:
        self._listener = listener
        threading.Thread(target=self._accept_loop, args=(listener,),
                         daemon=True, name="chaos-accept").start()

    def _close_listener(self) -> None:
        with self._mutex:
            listener, self._listener = self._listener, None
        if listener is not None:
            # shutdown first: it wakes the accept thread parked in
            # accept(), without which close() defers the fd teardown
            # and the port stays bound — heal()'s rebind would fail.
            shutdown_close(listener)

    def _ensure_listener(self) -> None:
        with self._mutex:
            if self._listener is not None or self._stopped:
                return
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self._host, self._port))
        listener.listen(64)
        self._start_listener(listener)

    # -- fault switches ----------------------------------------------------

    def partition(self, direction: str = "both",
                  reset_existing: bool = False) -> None:
        """Blackhole one or both directions.  ``reset_existing`` RSTs
        live connections first — partition-after-blip, the shape that
        forces clients into their failover walk immediately instead
        of timing out on silent sockets."""
        dirs = {"c2s", "s2c"} if direction == "both" else {direction}
        if not dirs <= {"c2s", "s2c"}:
            raise ValueError(f"bad partition direction {direction!r}")
        with self._mutex:
            self._partitioned |= dirs
            full = self._partitioned == {"c2s", "s2c"}
        if full:
            # A full partition drops SYNs too: close the listener so a
            # dialing client fails fast and walks its failover list —
            # the dead-network shape, not a half-open accept.
            self._close_listener()
        if reset_existing:
            self.reset_all()

    def heal(self) -> None:
        with self._mutex:
            self._partitioned.clear()
        self._ensure_listener()

    @property
    def partitioned(self) -> bool:
        return bool(self._partitioned)

    def set_delay(self, seconds: float) -> None:
        self._delay = max(0.0, seconds)

    def set_drop_rate(self, p: float) -> None:
        self._drop_rate = min(1.0, max(0.0, p))

    def set_trickle(self, bytes_per_sec: int) -> None:
        self._trickle_bps = max(0, int(bytes_per_sec))

    def reset_all(self) -> None:
        """RST every live proxied connection (both legs)."""
        with self._mutex:
            conns = list(self._conns)
            self._conns.clear()
        for a, b in conns:
            self._reset_conn(a, b)

    @staticmethod
    def _reset_conn(*socks: socket.socket) -> None:
        for s in socks:
            try:
                s.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0),
                )
            except OSError:
                pass
            # shutdown BEFORE close: a pump thread blocked in recv
            # on this socket holds the kernel object alive, and a
            # bare close() would defer the teardown (and the
            # RST/FIN to the peers) until that recv returns —
            # which it never would.
            shutdown_close(s)

    # -- plumbing ----------------------------------------------------------

    def _accept_loop(self, listener: socket.socket) -> None:
        # One thread per listener incarnation: partition/heal swap the
        # listener, and each thread dies with its own socket.
        while not self._stopped:
            try:
                client, _ = listener.accept()
            except OSError:
                return
            if "c2s" in self._partitioned and "s2c" in self._partitioned:
                # Fully partitioned: the network beyond this hop does
                # not exist — drop the fresh connection on the floor.
                self.counters["refused"] += 1
                # Same linger-0 + shutdown-then-close teardown as
                # reset_all: RST semantics, and no deferred fd.
                self._reset_conn(client)
                continue
            try:
                server = socket.create_connection(self._target, timeout=5.0)
            except OSError as e:
                log.debug("chaos: target %s unreachable: %s",
                          self._target, e)
                shutdown_close(client)
                continue
            for s in (client, server):
                try:
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            self.counters["connections"] += 1
            with self._mutex:
                self._conns.append((client, server))
                # Re-check under the registration mutex: a partition()
                # that raced this accept (flags set + reset_all drained
                # the list before this conn was registered) must not
                # leave a silently-blackholed survivor behind.
                full = self._partitioned == {"c2s", "s2c"}
            if full:
                with self._mutex:
                    if (client, server) in self._conns:
                        self._conns.remove((client, server))
                self._reset_conn(client, server)
                continue
            threading.Thread(
                target=self._pump, args=(client, server, "c2s"),
                daemon=True, name="chaos-c2s",
            ).start()
            threading.Thread(
                target=self._pump, args=(server, client, "s2c"),
                daemon=True, name="chaos-s2c",
            ).start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        try:
            while not self._stopped:
                chunk = src.recv(4096)
                if not chunk:
                    break
                if direction in self._partitioned:
                    # Blackhole: the bytes left the sender (it got its
                    # TCP ACK from us) and never arrive — exactly what
                    # an acknowledged-then-lost write looks like.
                    self.counters["chunks_dropped"] += 1
                    continue
                if self._drop_rate and self._rng.random() < self._drop_rate:
                    self.counters["chunks_dropped"] += 1
                    continue
                if self._delay:
                    time.sleep(self._delay)
                if self._trickle_bps:
                    for i in range(0, len(chunk), 64):
                        dst.sendall(chunk[i:i + 64])
                        time.sleep(64.0 / self._trickle_bps)
                else:
                    dst.sendall(chunk)
                self.counters["bytes_" + direction] += len(chunk)
        except OSError:
            pass
        finally:
            # shutdown BEFORE close, both legs: when this pump exits
            # (its src saw EOF/error) the SIBLING pump is still parked
            # in recv on the other socket — a bare close from this
            # thread defers that fd's teardown and the sibling (plus
            # both kernel objects) leaks until process exit if the
            # remaining peer stays silent.  shutdown wakes it now.
            for s in (src, dst):
                shutdown_close(s)

    def close(self) -> None:
        self._stopped = True
        self._close_listener()
        self.reset_all()
