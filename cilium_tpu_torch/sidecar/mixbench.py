"""Mixed-path throughput benchmark: the slow/oracle paths under a
realistic traffic mix.

The headline throughput configs exercise only the vectorized fast path
(single complete request-direction frames).  Real proxy traffic also
carries partial frames (a frame split across reads — carried state),
pipelined frames (several frames in one read), and reply-direction
bytes — all of which the reference's in-process parser handles in the
same code path (proxylib/proxylib/connection.go:118) but which this
architecture routes through the batch engines' wave path and the
in-process oracle.  This bench measures steady-state verdicts/s for a
configurable mix and reports the per-path split, so a regression in
the non-fast paths cannot hide behind the fast-path headline.

Closed loop: W rounds in flight; each round is one DataBatch over the
connection pool with the mix applied per-connection:
  - fast conns:      one complete frame per round (entrywise fast path,
                     one bucketed device call per round)
  - partial conns:   frames split across two rounds (engine buffering,
                     wave path; a verdict every second round)
  - pipelined conns: two complete frames in one entry (wave path, two
                     verdicts per round)
  - reply conns:     request frame + reply-direction bytes (oracle /
                     engine reply handling)

Counterpart of ``cilium_tpu/sidecar/mixbench.py``; ``verdict_device``
"default" is the CUDA card (the service raises without one), "cpu" the
plain versions.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..proxylib.types import FilterResult
from ..utils.option import DaemonConfig
from . import wire
from .client import SidecarClient
from .service import VerdictService


class MixBench:
    def __init__(
        self,
        socket_path: str,
        pool: int = 8192,
        frac_partial: float = 0.10,
        frac_pipelined: float = 0.05,
        frac_reply: float = 0.05,
        batch_flows: int = 8192,
        verdict_device: str = "default",
    ) -> None:
        from ..proxylib import (
            NetworkPolicy,
            PortNetworkPolicy,
            PortNetworkPolicyRule,
        )

        self.pool = pool
        n_partial = int(pool * frac_partial)
        n_pipe = int(pool * frac_pipelined)
        n_reply = int(pool * frac_reply)
        n_fast = pool - n_partial - n_pipe - n_reply
        # Conn-id layout: [fast | partial | pipelined | reply]
        self.n_fast, self.n_partial, self.n_pipe, self.n_reply = (
            n_fast, n_partial, n_pipe, n_reply,
        )

        policy = NetworkPolicy(
            name="mixbench",
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
        # batch_timeout_ms > 0 selects the completion-pipeline mode
        # (overlapped readbacks) — the right mode for a high-RTT device
        # link; greedy/inline mode would serialize one readback per
        # round.
        cfg = DaemonConfig(
            batch_flows=batch_flows,
            batch_timeout_ms=0.25,
            batch_width=64,
            verdict_device=verdict_device,
        )
        self._policy = policy
        self.service = VerdictService(socket_path, cfg).start()
        self.client = SidecarClient(socket_path, timeout=600.0)
        self.module = self.client.open_module([])
        assert self.client.policy_update(self.module, [policy]) == int(
            FilterResult.OK
        )
        for cid in range(1, pool + 1):
            res, _ = self.client.new_connection(
                self.module, "r2d2", cid, True, 1, 2,
                "1.1.1.1:1", "2.2.2.2:80", "mixbench",
            )
            assert res == int(FilterResult.OK), res

        # Frame corpus (mixed allow/deny), pre-padded to device rows so
        # the per-round matrix build is numpy indexing, not Python.
        rng = np.random.default_rng(11)
        self.frames = []
        for i in range(pool):
            roll = rng.random()
            if roll < 0.4:
                self.frames.append(f"READ /public/f{i % 997}.txt\r\n".encode())  # lint: disable=R7 -- one-time corpus setup, never inside a timed window
            elif roll < 0.55:
                self.frames.append(b"HALT\r\n")  # lint: disable=R7 -- one-time corpus setup, never inside a timed window
            else:
                self.frames.append(f"READ /private/f{i % 997}\r\n".encode())  # lint: disable=R7 -- one-time corpus setup, never inside a timed window
        self.pool_rows = np.zeros((pool, 64), np.uint8)
        self.pool_lens = np.zeros((pool,), np.uint32)
        for i, f in enumerate(self.frames):
            self.pool_rows[i, : len(f)] = np.frombuffer(f, np.uint8)
            self.pool_lens[i] = len(f)
        # Columnar round-build state (the generator must measure the
        # SERVICE, not per-entry dict/list churn on the harness side):
        # the conn-id layout is constant across rounds, frame bytes are
        # gathered from the flat pool with sidecar/reasm.py's ragged
        # scatter helpers, and the reply tail is one constant tile.
        self._pool_flat = self.pool_rows.reshape(-1)
        self._pool_lens64 = self.pool_lens.astype(np.int64)
        self._p_cids = np.arange(
            n_fast + 1, n_fast + n_partial + 1, dtype=np.int64
        )
        self._pi_cids = np.arange(
            n_fast + n_partial + 1, n_fast + n_partial + n_pipe + 1,
            dtype=np.int64,
        )
        n_re0 = n_fast + n_partial + n_pipe
        self._re_cids = np.arange(
            n_re0 + 1, n_re0 + n_reply + 1, dtype=np.int64
        )
        self._data_cids = np.concatenate(
            (self._p_cids, self._pi_cids, self._re_cids)
        ).astype(np.uint64)
        self._data_flags = np.concatenate((
            np.zeros(n_partial + n_pipe, np.uint8),
            np.full(n_reply, wire.FLAG_REPLY, np.uint8),
        ))
        self._reply_tail = np.tile(
            np.frombuffer(b"OK\r\n", np.uint8), n_reply
        )

    def _build_round(self, round_idx: int):
        """One round = one complete-flag MATRIX batch (the fast conns —
        the C++ edge owns framing and ships frames it completed as
        kMsgDataMatrix complete=1, so they ride the vec path) plus one
        DataBatch carrying everything the edge could NOT frame: partial
        reads, pipelined reads, reply-direction bytes.  Pure columnar:
        per-category segment (start, len) arrays into the flat frame
        pool, one ragged gather for the blob — no per-entry Python
        (the bench measures the service, not the harness).  Returns
        (matrix, data_batch, n_verdict_frames, split)."""
        from .reasm import gather_segments

        # fast conns -> matrix rows (pure numpy: pool indexing)
        m_ids = np.arange(1, self.n_fast + 1, dtype=np.uint64)
        sel = (np.arange(1, self.n_fast + 1) + round_idx) % self.pool
        m_rows = self.pool_rows[sel]
        m_lens = self.pool_lens[sel]

        # partial: half a frame per round (verdict lands on odd rounds)
        p_sel = (self._p_cids + round_idx // 2) % self.pool
        p_flen = self._pool_lens64[p_sel]
        p_half = p_flen // 2
        if round_idx % 2 == 0:
            p_start = p_sel * 64
            p_len = p_half
            partial_done = 0
        else:
            p_start = p_sel * 64 + p_half
            p_len = p_flen - p_half
            partial_done = self.n_partial
        # pipelined: two complete frames in one entry (two segments)
        s1 = (self._pi_cids + round_idx) % self.pool
        s2 = (self._pi_cids + round_idx + 1) % self.pool
        l1 = self._pool_lens64[s1]
        l2 = self._pool_lens64[s2]
        pi_len = l1 + l2
        lengths = np.concatenate((
            p_len, pi_len, np.full(self.n_reply, 4, np.int64),
        ))
        offs = np.concatenate(
            ([0], np.cumsum(lengths))
        ).astype(np.int64)
        blob = np.empty(int(offs[-1]), np.uint8)
        # One ragged gather covers the partial halves and both
        # pipelined segments; the constant reply tail is a block copy.
        seg_starts = np.empty(self.n_partial + 2 * self.n_pipe, np.int64)
        seg_lens = np.empty_like(seg_starts)
        seg_dst = np.empty_like(seg_starts)
        np_, npi = self.n_partial, self.n_pipe
        seg_starts[:np_] = p_start
        seg_lens[:np_] = p_len
        seg_dst[:np_] = offs[:np_]
        seg_starts[np_ : np_ + 2 * npi : 2] = s1 * 64
        seg_starts[np_ + 1 : np_ + 2 * npi : 2] = s2 * 64
        seg_lens[np_ : np_ + 2 * npi : 2] = l1
        seg_lens[np_ + 1 : np_ + 2 * npi : 2] = l2
        seg_dst[np_ : np_ + 2 * npi : 2] = offs[np_ : np_ + npi]
        seg_dst[np_ + 1 : np_ + 2 * npi : 2] = offs[np_ : np_ + npi] + l1
        gather_segments(self._pool_flat, seg_starts, seg_lens,
                        out=blob, dst_starts=seg_dst)
        blob[int(offs[np_ + npi]) :] = self._reply_tail

        frames_done = (
            self.n_fast + partial_done + 2 * self.n_pipe + self.n_reply
        )
        split = {
            "fast": self.n_fast,
            "partial": partial_done,
            "pipelined": 2 * self.n_pipe,
            "reply": self.n_reply,
        }
        matrix = (m_ids, m_lens, m_rows.tobytes())
        data = (
            self._data_cids, self._data_flags,
            lengths.astype(np.uint32), blob.tobytes(),
        )
        return matrix, data, frames_done, split

    def _send_round(self, seq: int, round_idx: int):
        """Ship one round as (matrix seq, data seq+1); returns
        (frames, split)."""
        matrix, data, nf, split = self._build_round(round_idx)
        m_ids, m_lens, m_rows = matrix
        self.client.send_matrix(seq, 64, m_ids, m_lens, m_rows,
                                complete=True)
        ids, fl, lens, blob = data
        self.client.send_batch(seq + 1, ids, fl, lens, blob)
        return nf, split

    def run(self, duration_s: float = 12.0, warmup_rounds: int = 4) -> dict:
        recv_seqs: dict[int, float] = {}
        evt = threading.Event()

        def on_verdict(vb):
            recv_seqs[vb.seq] = time.perf_counter()
            evt.set()

        self.client.verdict_callback = on_verdict

        # Warmup (compiles every bucket the mix touches).
        seq = 1
        for r in range(warmup_rounds):
            self._send_round(seq, r)
            deadline = time.monotonic() + 600
            while seq + 1 not in recv_seqs and time.monotonic() < deadline:
                evt.wait(1.0)
                evt.clear()
            assert seq + 1 in recv_seqs, "warmup round lost"
            seq += 2

        # Timed closed loop, two rounds in flight (a round completes
        # when BOTH its seqs answered).
        t0 = time.perf_counter()
        last_progress = time.monotonic()
        frames_total = 0
        split_total = {"fast": 0, "partial": 0, "pipelined": 0, "reply": 0}
        inflight: dict[int, int] = {}  # matrix seq -> frame count
        round_idx = warmup_rounds
        rounds = 0
        while time.perf_counter() - t0 < duration_s or inflight:
            while (
                len(inflight) < 2
                and time.perf_counter() - t0 < duration_s
            ):
                nf, split = self._send_round(seq, round_idx)
                inflight[seq] = nf
                for k, v in split.items():
                    split_total[k] += v
                seq += 2
                round_idx += 1
                rounds += 1
            done = [
                s for s in inflight
                if s in recv_seqs and s + 1 in recv_seqs
            ]
            for s in done:
                frames_total += inflight.pop(s)
                last_progress = time.monotonic()
            if not done:
                evt.wait(0.05)
                evt.clear()
                if time.monotonic() - last_progress > 120:
                    raise TimeoutError(
                        f"mixbench stalled: rounds {sorted(inflight)} "
                        f"never answered"
                    )
        elapsed = time.perf_counter() - t0
        self.client.verdict_callback = None
        slow_frames = (
            split_total["partial"] + split_total["pipelined"]
            + split_total["reply"]
        )
        # Columnar-reassembler engagement (sidecar/reasm.py): the bench
        # reports it so the floor assertion can prove the slow lane was
        # actually served columnar, not silently falling back scalar.
        reasm = self.service.status().get("reasm") or {}
        return {
            "verdicts_per_sec": frames_total / elapsed,
            "frames": frames_total,
            "rounds": rounds,
            "elapsed_s": elapsed,
            "split": split_total,
            "slow_fraction": slow_frames / max(
                slow_frames + split_total["fast"], 1
            ),
            "reasm_rounds": int(reasm.get("rounds", 0)),
            "reasm_frames": int(reasm.get("frames", 0)),
            "reasm_fallbacks": dict(reasm.get("fallbacks", {})),
        }

    def oracle_rate(self, rounds: int = 6) -> float:
        """The reference-architecture comparison point: the SAME mixed
        entry stream fed through the ported in-process streaming parser
        (reference: proxylib/proxylib/connection.go:118 handles
        complete, partial, pipelined, and reply data in one code
        path).  Frames/s on this host, single-threaded."""
        from ..proxylib import instance as pl

        mod = pl.open_module([], True)
        ins = pl.find_instance(mod)
        ins.policy_update([self._policy])
        conns = {}
        for cid in range(1, self.pool + 1):
            res, conn = pl.on_new_connection(
                mod, "r2d2", 1_000_000 + cid, True, 1, 2,
                "1.1.1.1:1", "2.2.2.2:80", "mixbench",
            )
            conns[cid] = conn
        frames_total = 0
        t0 = time.perf_counter()
        for r in range(rounds):
            matrix, data, nf, _split = self._build_round(r)
            m_ids, m_lens, m_rows = matrix
            rows = np.frombuffer(m_rows, np.uint8).reshape(-1, 64)
            for k in range(len(m_ids)):
                ops: list = []
                c = conns[int(m_ids[k])]
                c.on_data(
                    False, False, [rows[k, : m_lens[k]].tobytes()], ops
                )
                c.reply_buf.take()
            ids, fl, lens, blob = data
            offs = np.concatenate(([0], np.cumsum(lens.astype(np.int64))))
            for k in range(len(ids)):
                ops = []
                c = conns[int(ids[k])]
                c.on_data(
                    bool(fl[k] & wire.FLAG_REPLY), False,
                    [blob[offs[k]:offs[k + 1]]], ops,
                )
                c.reply_buf.take()
            frames_total += nf
        elapsed = time.perf_counter() - t0
        pl.close_module(mod)
        return frames_total / elapsed

    def close(self) -> None:
        self.client.close()
        self.service.stop()


class FlowCacheBench:
    """Long-lived-flow traffic shape for the established-flow verdict
    cache: a pool of conns that each ship one whole frame per
    round for the run's whole duration — the steady state the cache is
    built for.  ``cacheable_frac`` of the pool carries identity 1,
    admitted by a byte-FREE rule row (pure "allow these peers" —
    invariant-allow, armed at registration); the rest carry identity 2,
    admitted only by byte-constrained rows (no claim — every frame
    needs the device).  Each round ships the two groups as separate
    complete-flag matrix batches so the shim's whole-batch tier can
    answer the cacheable group locally (bytes never cross the
    transport) while the control group exercises the full device path.

    Run cache-on vs cache-off (both knobs) over identical traffic: the
    delta IS the cache, and ``bytes_pushed`` proves the shim-side
    short-circuit at the byte level."""

    def __init__(
        self,
        socket_path: str,
        pool: int = 4096,
        cacheable_frac: float = 0.8,
        flow_cache: bool = True,
        batch_flows: int = 8192,
        verdict_device: str = "default",
    ) -> None:
        from ..proxylib import (
            NetworkPolicy,
            PortNetworkPolicy,
            PortNetworkPolicyRule,
        )

        self.pool = pool
        self.n_cacheable = int(pool * cacheable_frac)
        self.n_control = pool - self.n_cacheable
        policy = NetworkPolicy(
            name="flowcache",
            policy=2,
            ingress_per_port_policies=[
                PortNetworkPolicy(
                    port=80,
                    rules=[
                        # Byte-free row: identity 1 is allowed whatever
                        # it sends — the invariant-allow class (pure
                        # L3/L4 admission expressed as an L7 rule set).
                        PortNetworkPolicyRule(
                            remote_policies=[1], l7_proto="r2d2",
                            l7_rules=[{}],
                        ),
                        # Byte-constrained rows: identity 2 must be
                        # inspected per frame.
                        PortNetworkPolicyRule(
                            remote_policies=[2], l7_proto="r2d2",
                            l7_rules=[
                                {"cmd": "READ", "file": "/public/.*"},
                                {"cmd": "HALT"},
                            ],
                        ),
                    ],
                )
            ],
        )
        cfg = DaemonConfig(
            batch_flows=batch_flows,
            batch_timeout_ms=0.25,
            batch_width=64,
            verdict_device=verdict_device,
            flow_cache=flow_cache,
        )
        self.flow_cache = flow_cache
        self.service = VerdictService(socket_path, cfg).start()
        self.client = SidecarClient(
            socket_path, timeout=600.0, flow_cache=flow_cache
        )
        self.module = self.client.open_module([])
        assert self.client.policy_update(self.module, [policy]) == int(
            FilterResult.OK
        )
        for cid in range(1, pool + 1):
            remote = 1 if cid <= self.n_cacheable else 2
            res, _ = self.client.new_connection(
                self.module, "r2d2", cid, True, remote, 2,
                "1.1.1.1:1", "2.2.2.2:80", "flowcache",
            )
            assert res == int(FilterResult.OK), res
        # One whole frame per conn per round, pre-padded (columnar
        # round build like MixBench — the bench measures the seam).
        rng = np.random.default_rng(12)
        self.pool_rows = np.zeros((pool, 64), np.uint8)
        self.pool_lens = np.zeros((pool,), np.uint32)
        for i in range(pool):
            if i < self.n_cacheable:
                f = f"READ /lived/f{i % 997}.txt\r\n".encode()
            elif rng.random() < 0.6:
                f = f"READ /public/f{i % 997}.txt\r\n".encode()
            else:
                f = b"HALT\r\n"
            self.pool_rows[i, : len(f)] = np.frombuffer(f, np.uint8)
            self.pool_lens[i] = len(f)
        self._a_ids = np.arange(
            1, self.n_cacheable + 1, dtype=np.uint64
        )
        self._b_ids = np.arange(
            self.n_cacheable + 1, pool + 1, dtype=np.uint64
        )

    def _send_round(self, seq: int) -> int:
        a, b = self.n_cacheable, self.n_control
        if a:
            self.client.send_matrix(
                seq, 64, self._a_ids, self.pool_lens[:a],
                self.pool_rows[:a].tobytes(), complete=True,
            )
        if b:
            self.client.send_matrix(
                seq + 1, 64, self._b_ids, self.pool_lens[a:],
                self.pool_rows[a:].tobytes(), complete=True,
            )
        return a + b

    def run(self, duration_s: float = 8.0, warmup_rounds: int = 3) -> dict:
        recv: dict[int, float] = {}
        evt = threading.Event()

        def on_verdict(vb):
            recv[vb.seq] = time.perf_counter()
            evt.set()

        self.client.verdict_callback = on_verdict

        def expected(s: int) -> tuple:
            # Only the seqs _send_round actually ships: an all-cacheable
            # (or all-control) pool sends one batch per round, and
            # waiting on the phantom twin would wedge the whole run.
            return tuple(
                x for x, n in ((s, self.n_cacheable),
                               (s + 1, self.n_control)) if n
            )

        seq = 1
        for _ in range(warmup_rounds):
            self._send_round(seq)
            deadline = time.monotonic() + 600
            while (
                any(s not in recv for s in expected(seq))
                and time.monotonic() < deadline
            ):
                evt.wait(1.0)
                evt.clear()
            assert all(s in recv for s in expected(seq)), \
                "warmup round lost"
            seq += 2
        bytes0 = self.client.bytes_pushed
        hits0 = self.client.cache_hits
        t0 = time.perf_counter()
        frames_total = 0
        inflight: dict[int, int] = {}
        last_progress = time.monotonic()
        while time.perf_counter() - t0 < duration_s or inflight:
            while (
                len(inflight) < 2
                and time.perf_counter() - t0 < duration_s
            ):
                nf = self._send_round(seq)
                inflight[seq] = nf
                seq += 2
            done = [
                s for s in inflight
                if all(x in recv for x in expected(s))
            ]
            for s in done:
                frames_total += inflight.pop(s)
                last_progress = time.monotonic()
            if not done:
                evt.wait(0.05)
                evt.clear()
                if time.monotonic() - last_progress > 120:
                    raise TimeoutError(
                        f"flow_cache bench stalled: {sorted(inflight)}"
                    )
        elapsed = time.perf_counter() - t0
        self.client.verdict_callback = None
        shim_hits = self.client.cache_hits - hits0
        svc = self.service.status().get("flow_cache") or {}
        svc_hits = int(svc.get("hits", 0))
        svc_miss = int(svc.get("misses", 0))
        hits = shim_hits + svc_hits
        return {
            "verdicts_per_sec": frames_total / elapsed,
            "frames": frames_total,
            "elapsed_s": elapsed,
            "hit_rate": hits / max(hits + svc_miss, 1),
            "shim_hits": shim_hits,
            "service_hits": svc_hits,
            "bytes_pushed": self.client.bytes_pushed - bytes0,
            "armed": int(svc.get("armed", 0)),
            "invalidations": int(svc.get("invalidations", 0)),
        }

    def close(self) -> None:
        self.client.close()
        self.service.stop()
