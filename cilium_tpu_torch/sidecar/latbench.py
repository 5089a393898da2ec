"""Added-latency benchmark for the sidecar seam.

Measures what the north star actually demands (<1ms added
p99): the latency a request experiences crossing the full seam —
client-side batch fill wait → wire hop → service dispatcher
(fill-vs-deadline) → device verdict → wire hop back — under open-loop
Poisson arrivals at configurable offered rates, versus the per-request
in-process oracle (the ported proxylib parser, the reference's
in-process cost).

Open loop: arrival timestamps are drawn ahead of time from an
exponential inter-arrival distribution and requests are released on
schedule regardless of completions, so queueing delay under overload
shows up honestly in the percentiles.  If the generator itself cannot
keep up with the offered rate, the run is flagged ``gen_saturated`` and
the achieved rate is reported.

Everything runs in one process (one process drives the card); the
service's device dispatch happens on the dispatcher thread, the
generator and reader on their own threads.

Counterpart of ``cilium_tpu/sidecar/latbench.py``.  Its device points
run on the CUDA card: the round-trip probe is kernel K20 ``rtt_tick``
(``csrc/seam.cu``) with a blocking readback, the uplink probe a timed
copy to the card, and the colocated runs keep ``verdict_device`` at the
card (the seam probe then runs kernel K19 there).
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..proxylib import instance as pl
from ..proxylib.types import FilterResult
from ..utils.option import DaemonConfig
from ..utils.sockutil import shutdown_close
from . import wire
from .client import SidecarClient
from .service import VerdictService

CONN_POOL = 4096


class NullVerdictServer:
    """The null-seam control: same unix socket, same wire framing, same
    reader-thread structure as VerdictService — but the verdict is an
    immediate constant written from the reader thread.  No dispatcher,
    no batching windows, no device.  Under the identical open-loop
    generator, this server's latency percentiles ARE the environmental
    floor (socket + framing + host scheduler); the seam's
    architecture-attributable added latency is seam_p99 − null_p99."""

    dispatch_mode_chosen = "null"

    class _Zero:
        batches = entries = fill_dispatches = deadline_dispatches = 0

    def __init__(self, socket_path: str) -> None:
        self.socket_path = socket_path
        self.dispatcher = self._Zero()
        self.inline_batches = 0
        self.vec_batches = 0
        self.vec_entries = 0
        self.seam_stages: dict = {}
        self._stopped = False
        try:
            os.unlink(socket_path)
        except OSError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(socket_path)
        self._listener.listen(8)
        self._threads: list[threading.Thread] = []

    def start(self) -> "NullVerdictServer":
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve, args=(sock,), daemon=True
            )
            t.start()
            self._threads.append(t)

    @staticmethod
    def _const_verdict(seq: int, conn_ids: np.ndarray) -> bytes:
        n = len(conn_ids)
        zeros = np.zeros(n, "<u4").tobytes()
        return (
            struct.pack("<QI", seq, n)
            + np.ascontiguousarray(conn_ids, "<u8").tobytes()
            + zeros  # results: all OK
            + zeros  # op_counts: none
            + zeros + zeros  # inject lens
        )

    def _serve(self, sock: socket.socket) -> None:
        reader = wire.BufferedReader(sock)
        try:
            while True:
                msg_type, payload = reader.recv_msg()
                if msg_type == wire.MSG_DATA_MATRIX:
                    seq, n = struct.unpack_from("<QI", payload, 0)
                    conn_ids = np.frombuffer(payload, "<u8", n, 17)
                    wire.send_msg(
                        sock, wire.MSG_VERDICT_BATCH,
                        self._const_verdict(seq, conn_ids),
                    )
                elif msg_type == wire.MSG_DATA_BATCH:
                    seq, n = struct.unpack_from("<QI", payload, 0)
                    conn_ids = np.frombuffer(payload, "<u8", n, 12)
                    wire.send_msg(
                        sock, wire.MSG_VERDICT_BATCH,
                        self._const_verdict(seq, conn_ids),
                    )
                elif msg_type == wire.MSG_NEW_CONNECTION:
                    args = wire.unpack_new_connection(payload)
                    wire.send_msg(
                        sock, wire.MSG_CONN_RESULT,
                        np.array([args[1]], "<u8").tobytes()
                        + np.array([int(FilterResult.OK)], "<u4").tobytes(),
                    )
                elif msg_type == wire.MSG_OPEN_MODULE:
                    wire.send_msg(
                        sock, wire.MSG_MODULE_ID,
                        np.array([1], "<u8").tobytes(),
                    )
                elif msg_type == wire.MSG_POLICY_UPDATE:
                    wire.send_msg(
                        sock, wire.MSG_ACK,
                        wire.pack_ack(int(FilterResult.OK)),
                    )
                elif msg_type == wire.MSG_STATUS:
                    wire.send_msg(sock, wire.MSG_STATUS_REPLY, b"{}")
                elif msg_type == wire.MSG_SHM_ATTACH:
                    # The null control is socket-only by design: reject
                    # typed so a shm-preferring client falls back fast
                    # instead of timing out its attach RPC.
                    wire.send_msg(
                        sock, wire.MSG_SHM_ATTACH_REPLY,
                        b'{"status": 7, "generation": 0,'
                        b' "error": "null server: socket only"}',
                    )
                # MSG_CLOSE and anything else: ignored
        except (wire.ConnectionClosed, OSError):
            pass
        finally:
            shutdown_close(sock)

    def stop(self) -> None:
        self._stopped = True
        # shutdown wakes the acceptor so the listener dies NOW — a
        # bare close deferred the teardown behind the blocked accept
        # and the port kept accepting into a stopped server (R3).
        shutdown_close(self._listener)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


def _corpus(pool: int, seed: int = 7):
    """Mixed allow/deny r2d2 messages, one per pooled connection."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(pool):
        roll = rng.random()
        if roll < 0.35:
            msgs.append(f"READ /public/file{i % 997}.txt\r\n".encode())
        elif roll < 0.5:
            msgs.append(b"HALT\r\n")
        elif roll < 0.75:
            msgs.append(f"READ /private/file{i % 997}\r\n".encode())
        else:
            msgs.append(f"WRITE /public/f{i % 997}\r\n".encode())
    lengths = np.array([len(m) for m in msgs], np.uint32)
    blob = b"".join(msgs)
    offsets = np.concatenate(([0], np.cumsum(lengths.astype(np.int64))))
    return msgs, lengths, blob, offsets


@dataclass
class RateResult:
    offered_rate: float
    achieved_rate: float
    requests: int
    p50_ms: float
    p90_ms: float
    p99_ms: float
    max_ms: float
    gen_saturated: bool
    added_p50_ms: float
    added_p99_ms: float
    # Release lateness: how far behind schedule the open-loop generator
    # was when it actually shipped each request (diagnoses how much of
    # the measured latency is generator-side scheduling vs the seam).
    release_late_p50_ms: float = 0.0
    release_late_p99_ms: float = 0.0


class LatencyBench:
    def __init__(
        self,
        socket_path: str,
        batch_flows: int = 2048,
        batch_timeout_ms: float = 0.25,
        client_batch: int = 1024,
        client_timeout_ms: float = 0.2,
        policy=None,
        verdict_device: str = "default",
        dispatch_mode: str = "auto",
        seam_probe: bool = False,
        wire_mode: str = "matrix",  # matrix (pre-padded) | blob (compact)
        null_seam: bool = False,
        transport: str = "socket",  # socket | shm (client-side rings)
    ):
        from ..proxylib import (
            NetworkPolicy,
            PortNetworkPolicy,
            PortNetworkPolicyRule,
        )

        self.policy = policy or NetworkPolicy(
            name="latbench",
            policy=2,
            ingress_per_port_policies=[
                PortNetworkPolicy(
                    port=80,
                    rules=[
                        PortNetworkPolicyRule(
                            l7_proto="r2d2",
                            l7_rules=[
                                {"cmd": "READ", "file": "/public/.*"},
                                {"cmd": "HALT"},
                            ],
                        )
                    ],
                )
            ],
        )
        self.client_batch = client_batch
        self.client_timeout_s = client_timeout_ms / 1000.0
        self.wire_mode = wire_mode
        if null_seam:
            self.service = NullVerdictServer(socket_path).start()
        else:
            cfg = DaemonConfig(
                batch_flows=batch_flows,
                batch_timeout_ms=batch_timeout_ms,
                batch_width=64,
                verdict_device=verdict_device,
                dispatch_mode=dispatch_mode,
                seam_probe=seam_probe,
            )
            self.service = VerdictService(socket_path, cfg).start()
        # First new_connection triggers the engine build and its
        # per-bucket prewarm (graph captures in jit mode) — generous
        # timeout.
        # transport="shm" negotiates the shared-memory rings; slots are
        # sized so a full client_batch matrix (2048 x 64B rows + the
        # columnar headers) fits one slot with headroom.
        self.client = SidecarClient(
            socket_path, timeout=600.0, transport=transport,
            shm_data_slots=64, shm_slot_bytes=1 << 20,
            shm_verdict_slots=64, shm_verdict_slot_bytes=1 << 19,
        )
        self.module = self.client.open_module([])
        assert self.module != 0
        assert self.client.policy_update(self.module, [self.policy]) == int(
            FilterResult.OK
        )
        self.msgs, self.pool_lengths, self.pool_blob, self.pool_offsets = _corpus(
            CONN_POOL
        )
        self.pool_conn_ids = np.arange(1, CONN_POOL + 1, dtype=np.uint64)
        # Pre-padded device-layout rows (the MSG_DATA_MATRIX pool): the
        # datapath edge pays the padding cost once, off the hot path.
        self.width = 64
        self.pool_rows = np.zeros((CONN_POOL, self.width), np.uint8)
        for i, m in enumerate(self.msgs):
            self.pool_rows[i, : len(m)] = np.frombuffer(m, np.uint8)
        self._next_seq = 1
        self._register_conns()

    def _register_conns(self) -> None:
        for cid in self.pool_conn_ids:
            res, _ = self.client.new_connection(
                self.module, "r2d2", int(cid), True, 1, 2,
                "1.1.1.1:1", "2.2.2.2:80", "latbench",
            )
            assert res == int(FilterResult.OK), res
        # One warm-up full batch so no first-use cost lands in the timing.
        n = self.client_batch
        self._send_range(10**9, 0, min(n, CONN_POOL))
        time.sleep(0.5)

    def _send_range(self, seq: int, a: int, b: int) -> None:
        """Ship pool entries [a, b) (indices mod CONN_POOL, a/b absolute
        with b-a <= CONN_POOL) as one batch: pre-padded matrix rows, or
        the compact payload blob (wire_mode='blob' — the uplink-lean
        path for bandwidth-limited device links)."""
        ai, bi = a % CONN_POOL, (b - 1) % CONN_POOL + 1
        off = self.pool_offsets
        if ai < bi:
            ids = self.pool_conn_ids[ai:bi]
            lens = self.pool_lengths[ai:bi]
            if self.wire_mode == "blob":
                self.client.send_blob(
                    seq, ids, lens, self.pool_blob[off[ai]:off[bi]]
                )
                return
            rows = self.pool_rows[ai:bi].tobytes()
        else:  # wraps the pool
            ids = np.concatenate(
                (self.pool_conn_ids[ai:], self.pool_conn_ids[:bi])
            )
            lens = np.concatenate(
                (self.pool_lengths[ai:], self.pool_lengths[:bi])
            )
            if self.wire_mode == "blob":
                self.client.send_blob(
                    seq, ids, lens,
                    self.pool_blob[off[ai]:] + self.pool_blob[:off[bi]],
                )
                return
            rows = (
                self.pool_rows[ai:].tobytes() + self.pool_rows[:bi].tobytes()
            )
        # complete=True: the pool rows are built as single whole frames,
        # so the edge declares framing and the service skips its scan.
        self.client.send_matrix(seq, self.width, ids, lens, rows, complete=True)

    def run_rate(self, rate: float, n_requests: int, seed: int = 3) -> RateResult:
        import gc

        # A cyclic-GC pass mid-run is a multi-ms stop-the-world pause —
        # pure measurement noise in the tail percentiles.  Refcounting
        # still reclaims everything the hot path allocates.
        gc.collect()
        gc.disable()
        try:
            return self._run_rate(rate, n_requests, seed)
        finally:
            gc.enable()

    @staticmethod
    def _tighten_timer_slack() -> None:
        """Best-effort per-thread timer slack reduction (the default 50µs
        stretches a 100µs pacing sleep, which lands directly in release
        lateness; 1µs slack keeps it close to what was asked)."""
        try:
            import ctypes

            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            libc.prctl(29, 1000, 0, 0, 0)  # PR_SET_TIMERSLACK = 29, 1µs
        except Exception:  # noqa: BLE001 — diagnostics only
            pass

    def _run_rate(self, rate: float, n_requests: int, seed: int) -> RateResult:
        self._tighten_timer_slack()
        rng = np.random.default_rng(seed)
        inter = rng.exponential(1.0 / rate, n_requests)
        sched = np.cumsum(inter)  # scheduled arrival times (s from start)

        recv: list[tuple[int, float]] = []  # (seq, t_recv)
        sent: dict[int, tuple[int, int, float]] = {}  # seq -> (a, b, t_sent)
        done = threading.Event()
        expected_final = n_requests

        got_counter = {"n": 0}

        def on_verdict(vb):
            t = time.perf_counter()
            recv.append((vb.seq, t))
            a, b, _ = sent.get(vb.seq, (0, 0, 0.0))
            got_counter["n"] += b - a
            if got_counter["n"] >= expected_final:
                done.set()

        self.client.verdict_callback = on_verdict

        t0 = time.perf_counter()
        i = 0
        gen_behind = False
        release_late = np.empty(n_requests)
        while i < n_requests:
            now = time.perf_counter() - t0
            j = int(np.searchsorted(sched, now))
            j = min(j, n_requests)
            if j > i and now - sched[i] > max(0.005, 3 * self.client_timeout_s):
                gen_behind = True
            if (
                j - i >= self.client_batch
                or (j > i and now - sched[i] >= self.client_timeout_s)
                or (j >= n_requests and j > i)  # tail flush
            ):
                while i < j:
                    b = min(j, i + self.client_batch, i + CONN_POOL)
                    # Globally monotonic seqs: stragglers from an
                    # overloaded previous run can never collide with
                    # this run's sent map.
                    seq = self._next_seq
                    self._next_seq += 1
                    sent[seq] = (i, b, time.perf_counter())
                    release_late[i:b] = (
                        time.perf_counter() - t0
                    ) - sched[i:b]
                    self._send_range(seq, i, b)
                    i = b
            else:
                # Pace without starving the service threads of the GIL.
                time.sleep(0.0001)
        gen_elapsed = time.perf_counter() - t0
        done.wait(10.0)
        self.client.verdict_callback = None

        lat = []
        for sq, t_recv in recv:
            rec = sent.get(sq)
            if rec is None:
                continue
            a, b, _ = rec
            lat.append((t_recv - t0) - sched[a:b])
        lat = np.concatenate(lat) if lat else np.array([0.0])
        lat_ms = lat * 1000.0
        achieved = len(lat) / gen_elapsed
        return RateResult(
            offered_rate=rate,
            achieved_rate=achieved,
            requests=len(lat),
            p50_ms=float(np.percentile(lat_ms, 50)),
            p90_ms=float(np.percentile(lat_ms, 90)),
            p99_ms=float(np.percentile(lat_ms, 99)),
            max_ms=float(lat_ms.max()),
            # Saturated = the generator fell behind schedule OR it
            # delivered materially less than offered — a run that only
            # achieves <98% of its offered rate must not present its
            # (fill-vs-deadline flattered) percentiles as that rate's.
            gen_saturated=gen_behind or achieved / rate < 0.98,
            added_p50_ms=0.0,  # filled by caller after oracle measure
            added_p99_ms=0.0,
            release_late_p50_ms=float(
                np.percentile(release_late * 1000.0, 50)
            ),
            release_late_p99_ms=float(
                np.percentile(release_late * 1000.0, 99)
            ),
        )

    def oracle_latency_ms(self, n: int = 20000) -> tuple[float, float]:
        """Per-request latency of the ported in-process proxylib parser
        (the reference's in-process cost this seam is compared against)."""
        mod = pl.open_module([], True)
        ins = pl.find_instance(mod)
        ins.policy_update([self.policy])
        res, conn = pl.on_new_connection(
            mod, "r2d2", 999999999, True, 1, 2, "1.1.1.1:1", "2.2.2.2:80",
            "latbench",
        )
        assert res == FilterResult.OK
        times = np.empty(n)
        for k in range(n):
            m = self.msgs[k % len(self.msgs)]
            t0 = time.perf_counter()
            ops: list = []
            conn.on_data(False, False, [m], ops)
            times[k] = time.perf_counter() - t0
            conn.reply_buf.take()
        pl.close_module(mod)
        ms = times * 1000.0
        return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))

    def close(self) -> None:
        self.client.close()
        self.service.stop()


def run_paired_colocated(
    socket_path: str, n_requests: int = 100_000, reps: int = 9,
    transport: str = "socket", **kw
) -> dict:
    """The colocated latency experiment with its control, PAIRED: each
    seam run executes adjacent in time to a null-seam run, and the
    architecture-attributable added p99 is the median of the per-pair
    (seam − null) deltas.  Running the blocks minutes apart lets the
    shared host's drifting stall rate land asymmetrically on one side;
    pairing cancels the drift the way the null server cancels the
    constant floor.  The seam service runs on the card unless the caller
    passes ``verdict_device="cpu"``."""
    seam_kw = dict(kw)
    # ``transport`` applies to the SEAM client only; the null control
    # stays on the socket (same framing floor for every config), so
    # (seam − null) deltas are comparable between the socket and shm
    # configs and the difference between the two IS the copy
    # elimination.
    seam_kw["transport"] = transport
    seam_kw.setdefault("seam_probe", True)
    seam_kw.setdefault("batch_timeout_ms", 0.0)
    seam_kw.setdefault("client_timeout_ms", 0.3)
    seam_kw.setdefault("batch_flows", 8192)
    seam_kw.setdefault("client_batch", 2048)
    null_kw = {
        "null_seam": True,
        "client_timeout_ms": seam_kw["client_timeout_ms"],
        "client_batch": seam_kw["client_batch"],
    }
    seam = LatencyBench(socket_path, **seam_kw)
    null = LatencyBench(socket_path + "_null", **null_kw)
    try:
        os_noise = measure_os_noise()
        oracle_p50, oracle_p99 = seam.oracle_latency_ms()
        # Short runs keep each pair tight in time (the whole point);
        # many pairs let the median reject stall-struck ones.
        n = min(n_requests, 30_000)
        pairs = []
        for k in range(reps):
            rn = null.run_rate(100_000, n, seed=3 + k)
            rs = seam.run_rate(100_000, n, seed=3 + k)
            pairs.append((rn, rs))
        # Half a second of offered load at 1M/s (the run() formula's
        # rate*0.5 with the rate inlined).
        n1 = min(n_requests, 500_000)
        r1m_null = null.run_rate(1_000_000, n1, seed=11)
        r1m_seam = seam.run_rate(1_000_000, n1, seed=11)
        # Captured BEFORE close (close releases the ring session).
        transport_stats = seam.client.transport_status()
    finally:
        seam.close()
        null.close()
    deltas = sorted(rs.p99_ms - rn.p99_ms for rn, rs in pairs)
    seam_sorted = sorted(pairs, key=lambda p: p[1].p99_ms)
    seam_med = seam_sorted[len(pairs) // 2][1]
    null_med = sorted(
        (p[0] for p in pairs), key=lambda r: r.p99_ms
    )[len(pairs) // 2]
    seam_med.added_p50_ms = max(seam_med.p50_ms - oracle_p50, 0.0)
    seam_med.added_p99_ms = max(seam_med.p99_ms - oracle_p50, 0.0)
    r1m_seam.added_p99_ms = max(r1m_seam.p99_ms - oracle_p50, 0.0)
    return {
        "oracle_p50_ms": oracle_p50,
        "oracle_p99_ms": oracle_p99,
        "os_noise": os_noise,
        "dispatch_mode": seam.service.dispatch_mode_chosen,
        # What the seam client actually rode (mode + ring/doorbell/
        # fallback counters) — a result claiming "shm" with a session
        # that silently demoted to the socket must be readable as such.
        "seam_transport": transport_stats,
        "seam_100k": seam_med,
        "null_100k": null_med,
        "pair_deltas_ms": [round(d, 3) for d in deltas],
        "delta_p99_ms": deltas[len(deltas) // 2],
        "seam_p99_runs": [round(p[1].p99_ms, 3) for p in pairs],
        "null_p99_runs": [round(p[0].p99_ms, 3) for p in pairs],
        "seam_1m": r1m_seam,
        "null_1m": r1m_null,
        "seam_stages_us": {
            k: round(v[1] / max(v[0], 1) * 1e6, 1)
            for k, v in seam.service.seam_stages.items()
        },
    }


def measure_uplink_mbps(n: int = 6, size: int = 512 * 1024,
                        device=None) -> float:
    """Serialized host→device transfer rate: ``n`` copies of a pageable
    numpy array of ``size`` bytes to the card, each followed by a
    synchronize (the host-to-card link that wire-fed verdict throughput
    rides on).  Reported alongside latency so results can be read
    against the link they were taken on.  ``device=None`` is the card,
    and raises without one."""
    dev = resolve_device(device)
    x = np.zeros((size,), np.uint8)

    def put() -> None:
        torch.from_numpy(x).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    put()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        put()
    dt = time.perf_counter() - t0
    return n * size / dt / 1e6


def measure_os_noise(window_s: float = 2.0) -> dict:
    """Scheduler-noise floor of the host: gaps observed by a tight
    single-thread loop with nothing else runnable in-process.  On a
    shared host, hypervisor/cotenant stalls of milliseconds are an
    external additive term every latency percentile here inherits.
    Reported alongside the percentiles so they can be read against the
    host."""
    gaps = []
    t_prev = time.perf_counter()
    t_end = t_prev + window_s
    while True:
        t = time.perf_counter()
        if t - t_prev > 0.0003:
            gaps.append(t - t_prev)
        t_prev = t
        if t > t_end:
            break
    g = np.array(gaps) if gaps else np.zeros(1)
    return {
        "window_s": window_s,
        "gaps_over_0p3ms": len(gaps),
        "gap_max_ms": round(float(g.max()) * 1e3, 2),
        "gap_sum_ms": round(float(g.sum()) * 1e3, 1),
        "stall_fraction": round(float(g.sum()) / window_s, 4),
    }


_RTT_TICK = kernels.CudaKernel(
    "seam", "rtt_tick", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)


def rtt_tick_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K20: ``x + 1`` (int32, wrapping)."""
    return x + 1


def rtt_tick(x) -> torch.Tensor:
    """K20: ``x + 1`` of an int32 [n] tensor (two's-complement wrap) on
    its device; the plain version on the CPU."""
    device = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    x = kernels.arg(x, "x", torch.int32, (None,), device)
    if kernels.on_cpu(device):
        return rtt_tick_plain(x)
    y = torch.empty_like(x)
    if x.shape[0]:
        _RTT_TICK.launch(device, kernels.p(x), x.shape[0], kernels.p(y))
    return y


def measure_device_rtt_ms(n: int = 12, device=None,
                          samples: list | None = None) -> float:
    """Median host→device→host blocking round trip of one tiny device
    call: K20 ``rtt_tick`` on an [8] int32 tensor on the card, then a
    blocking ``.cpu()`` readback; one warm call first (the first launch
    loads the kernel).  ``samples``, when given, receives the ``n``
    round trips in ms.  ``device=None`` is the card, and raises without
    one; ``device="cpu"`` runs the plain ``x + 1``."""
    dev = resolve_device(device)
    x = torch.zeros((8,), dtype=torch.int32, device=dev)
    rtt_tick(x).cpu()  # warm
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        rtt_tick(x).cpu()
        times.append(time.perf_counter() - t0)
    if samples is not None:
        samples.extend(t * 1000.0 for t in times)
    return float(np.median(times) * 1000.0)


def run(
    socket_path: str,
    rates=(100_000, 1_000_000, 5_000_000),
    n_requests: int = 100_000,
    colocated: bool = False,
    null_seam: bool = False,
    **kw,
) -> dict:
    if null_seam:
        # The control experiment: generator + wire + constant-verdict
        # echo.  Client-side batching windows match the colocated seam
        # config so the generator behaves identically; everything
        # server-side is removed.
        # Caller options (wire_mode, client windows, ...) pass through
        # so a customized seam run can be paired with an identically
        # configured control; server-side options are ignored by the
        # null server.  Same client hold window default as the
        # colocated seam run: the generator must release identically
        # for (seam − null) to isolate the seam.
        kw = dict(kw)
        kw["null_seam"] = True
        kw.setdefault("client_timeout_ms", 0.3)
        colocated = True  # median-of-5 + no device RTT measurement
        rtt_ms = 0.0
        uplink_mbps = 0.0
    elif colocated:
        # Verdict compute removed: the seam-probe model (a trivial
        # all-allow device op, K19 on the card, which sits on this host)
        # keeps the full client fill -> wire -> dispatcher -> device
        # call -> readback -> wire back path alive while removing the
        # verdict-compute term, so the measured latency is the seam
        # architecture itself.  The real model's compute term is
        # measured by the non-colocated run and the throughput benches.
        # Windows stay at their sub-ms defaults.
        kw.setdefault("seam_probe", True)
        # Greedy dispatch: with the device local there is no transport
        # cost worth amortizing, so the worker takes whatever is
        # pending the moment it frees up (arrivals self-coalesce while
        # a round is in flight).
        kw.setdefault("batch_timeout_ms", 0.0)
        # A small client hold window beats ship-on-wakeup on a small
        # host: wakeup-quantum batches of a few entries keep the host at
        # full duty on per-round fixed cost, and the resulting GIL
        # queueing costs more than the hold.
        kw.setdefault("client_timeout_ms", 0.3)
        rtt_ms = 0.0
        uplink_mbps = 0.0
    else:
        # Deadlines well under the link RTT: with the slotted completion
        # pipeline overlapping readbacks, extra batching wait no longer
        # buys anything — it only delays the first dispatch.  The probes
        # run on the verdict device: the card unless the caller asked
        # for the CPU.
        probe_dev = "cpu" if kw.get("verdict_device") == "cpu" else None
        rtt_ms = measure_device_rtt_ms(device=probe_dev)
        uplink_mbps = measure_uplink_mbps(device=probe_dev)
        kw.setdefault("batch_timeout_ms", max(0.25, rtt_ms / 16))
        kw.setdefault("client_timeout_ms", max(0.2, rtt_ms / 32))
        # Compact payload batches: on a bandwidth-limited device link the
        # uplink is the binding constraint, so ship exact payload bytes
        # and let the device build the padded row view (K16).
        kw.setdefault("wire_mode", "blob")
    # Deep rounds: the cap only binds under backlog, where amortizing
    # the per-round fixed cost over more entries is what keeps the 1M/s
    # point stable.
    kw.setdefault("batch_flows", 8192)
    kw.setdefault("client_batch", 2048)
    bench = LatencyBench(socket_path, **kw)
    try:
        os_noise = measure_os_noise()
        oracle_p50, oracle_p99 = bench.oracle_latency_ms()
        results = []
        p99_runs: dict[float, list] = {}
        for rate in rates:
            n = min(n_requests, max(20_000, int(rate * 0.5)))
            # A shared host suffers external multi-ms scheduler stalls
            # (see measure_os_noise), enough to set p99 single-handedly
            # in an unlucky window.
            # The colocated seam metric takes the median-of-5 run so
            # the architecture, not one hypervisor stall, is measured;
            # every run's p99 is reported alongside.
            reps = 5 if (colocated and rate <= 100_000) else 1
            runs = [bench.run_rate(rate, n, seed=3 + k) for k in range(reps)]
            runs.sort(key=lambda rr: rr.p99_ms)
            p99_runs[rate] = [round(rr.p99_ms, 3) for rr in runs]
            r = runs[len(runs) // 2]
            # Raw added latency vs the in-process oracle.
            r.added_p50_ms = max(r.p50_ms - oracle_p50, 0.0)
            r.added_p99_ms = max(r.p99_ms - oracle_p50, 0.0)
            results.append(r)
        return {
            "oracle_p50_ms": oracle_p50,
            "oracle_p99_ms": oracle_p99,
            "device_rtt_ms": rtt_ms,
            "uplink_mbps": uplink_mbps,
            "colocated": colocated,
            "dispatch_mode": bench.service.dispatch_mode_chosen,
            "os_noise": os_noise,
            "p99_runs": p99_runs,
            "rates": results,
            "dispatcher": {
                "batches": bench.service.dispatcher.batches,
                "fill": bench.service.dispatcher.fill_dispatches,
                "deadline": bench.service.dispatcher.deadline_dispatches,
                "inline": bench.service.inline_batches,
                "vec_batches": bench.service.vec_batches,
                "vec_entries": bench.service.vec_entries,
            },
            # Published seam breakdown (seam_probe runs): per-stage
            # thread-CPU of the group fast path, µs per round.
            "seam_stages_us": {
                k: round(v[1] / max(v[0], 1) * 1e6, 1)
                for k, v in bench.service.seam_stages.items()
            },
        }
    finally:
        bench.close()
