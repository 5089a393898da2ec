"""Multi-tenant fan-in, N shim sessions into one port service: the twins of
tests/test_fanin.py.

Each test drives the port's ``VerdictService`` (``verdict_device="cpu"``)
with the port's ``SidecarClient`` exactly as its reference test drives the
reference's, with the reference's parameters and bounds, and asserts what
the reference test asserts; outputs are held to the reference's
single-session oracle (tests/test_sidecar.py ``oracle_ops``).  The contract:
the session is the unit of fault isolation, and deficit-round-robin quotas
keep a flooding session from starving its neighbors.
"""

from __future__ import annotations

import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from cilium_tpu_torch.proxylib import (
    FilterResult,
    NetworkPolicy,
    PortNetworkPolicy,
    PortNetworkPolicyRule,
)
from cilium_tpu_torch.proxylib import instance as inst
from cilium_tpu_torch.sidecar import SidecarClient, VerdictService, wire
from cilium_tpu_torch.sidecar.transport import (
    REASON_OVERSIZE_SPREE,
    REASON_TORN_SLOT,
    TRANSPORT_SHM,
    TRANSPORT_SOCKET,
)
from cilium_tpu_torch.utils.option import DaemonConfig

from test_sidecar import CORPUS, assert_parity, oracle_ops
from test_sidecar import r2d2_policy as ref_r2d2_policy

REPO = Path(__file__).resolve().parent.parent


def r2d2_policy(name="sidecar-pol"):
    """tests/test_sidecar.py's r2d2 policy in the port's NPDS types."""
    return NetworkPolicy(name=name, policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
            remote_policies=[1, 3], l7_proto="r2d2",
            l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])])])


def _open_conn(client, conn_id, policies=None):
    mod = client.open_module([])
    assert client.policy_update(mod, policies or [r2d2_policy()]) == int(FilterResult.OK)
    res, shim = client.new_connection(
        mod, "r2d2", conn_id, True, 1, 2, "1.1.1.1:1", "2.2.2.2:80", "sidecar-pol",
    )
    assert res == int(FilterResult.OK)
    return mod, shim


def _shim_run(client, shim, msgs):
    out = []
    for m in msgs:
        result, entries = client._on_data_rpc(shim.conn_id, False, False, m)
        ops, inj = [], b""
        for _, r, eops, _io, ir in entries:
            assert r == int(FilterResult.OK)
            ops.extend(eops)
            inj += ir
        out.append((ops, inj))
    return out


def _wait(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


SHM_KW = dict(
    transport=TRANSPORT_SHM,
    shm_data_slots=16,
    shm_slot_bytes=1 << 16,
    shm_verdict_slots=16,
    shm_verdict_slot_bytes=1 << 16,
)


def _service(tmp_path, name, **cfg_kw):
    inst.reset_module_registry()
    defaults = dict(
        batch_timeout_ms=2.0,
        batch_flows=256,
        dispatch_mode="eager",
        verdict_device="cpu",
    )
    defaults.update(cfg_kw)
    cfg = DaemonConfig(**defaults)
    return VerdictService(str(tmp_path / f"{name}.sock"), cfg).start()


def _session_rows(svc) -> dict:
    return {
        row["identity"]: row
        for row in svc.status()["sessions"]["live"]
    }


# Distinct per-session traffic slices so a cross-session mixup is
# visible in the OUTPUT, not just the counters.
def _slice(i: int) -> list[bytes]:
    return CORPUS + [
        f"READ /public/pod{i}.txt\r\n".encode(),
        f"WRITE /tmp/pod{i}\r\n".encode(),
        b"HALT\r\n",
    ]


# --- coalesced fan-in parity vs the single-session oracle ------------------


def test_fanin_parity_and_exactly_once_accounting(tmp_path):
    """4 concurrent identity-named sessions drive disjoint traffic
    through ONE dispatcher (rounds coalesce across sessions); every
    session's op/inject outputs are bit-identical to its
    single-session oracle run, the completion fan-out misroutes
    nothing, and each session's exactly-once surface balances
    (submitted == answered) after quiesce."""
    svc = _service(tmp_path, "fanin_par")
    clients = []
    try:
        for i in range(4):
            clients.append(
                SidecarClient(
                    svc.socket_path, timeout=30.0,
                    identity=f"pod-{i}", **SHM_KW,
                )
            )
        shims = [_open_conn(c, 5000 + i)[1]
                 for i, c in enumerate(clients)]
        outs: dict[int, list] = {}
        errs: list = []

        def run(i):
            try:
                outs[i] = _shim_run(clients[i], shims[i], _slice(i))
            except Exception as exc:  # noqa: BLE001
                errs.append(exc)

        threads = [
            threading.Thread(target=run, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs, errs
        for i in range(4):
            assert_parity(outs[i], oracle_ops(ref_r2d2_policy(), _slice(i)))
        rows = _session_rows(svc)
        assert set(rows) == {f"pod-{i}" for i in range(4)}
        for ident, row in rows.items():
            assert row["state"] == "active", row
            assert row["submitted"] == len(_slice(0)), row
            assert row["submitted"] == row["answered"], row
            assert row["shed"] == {}, row
        for c in clients:
            assert c.misrouted_verdicts == 0
    finally:
        for c in clients:
            c.close()
        svc.stop()
        inst.reset_module_registry()


# --- per-session fault isolation -------------------------------------------


def test_torn_ring_quarantines_one_session_others_bit_identical(tmp_path):
    """A torn data-ring slot on session 0 demotes session 0 only
    (typed torn_slot, synthesized SHED for the never-admitted frame);
    sessions 1..3 stay on the shm rung and their outputs remain
    bit-identical to the single-session oracle."""
    svc = _service(tmp_path, "fanin_torn")
    clients = [
        SidecarClient(svc.socket_path, timeout=30.0,
                      identity=f"pod-{i}", **SHM_KW)
        for i in range(4)
    ]
    try:
        shims = [_open_conn(c, 5100 + i)[1]
                 for i, c in enumerate(clients)]
        for i, c in enumerate(clients):
            _shim_run(c, shims[i], [b"HALT\r\n"])  # shm path warm
        victim = clients[0]
        sess = victim._shm
        assert sess is not None and sess.active

        got: dict[int, wire.VerdictBatch] = {}
        victim.verdict_callback = lambda vb: got.setdefault(vb.seq, vb)
        with victim._wlock:
            pos = sess.data.tail
            payload = wire.pack_data_batch(
                991, [shims[0].conn_id], [0], [6], b"HALT\r\n"
            )
            assert sess.data.try_push(
                wire.MSG_DATA_BATCH, payload, sess.credit_head
            )
            sess.inflight[991] = (
                pos, np.array([shims[0].conn_id], np.uint64)
            )
            off = 64 + (pos % sess.data.slots) * sess.data.slot_bytes
            struct.pack_into("<Q", sess.data.seg.buf, off, 0)
            victim._doorbell_send(sess, sess.data.tail)

        _wait(lambda: victim.transport_mode == TRANSPORT_SOCKET,
              10.0, "victim demotion to socket")
        _wait(lambda: 991 in got, 5.0, "typed SHED for the torn frame")
        assert list(got[991].results) == [int(FilterResult.SHED)]
        victim.verdict_callback = None

        # Healthy sessions: still shm, outputs bit-identical, zero
        # fallbacks; the victim keeps serving over the socket.
        outs = {}
        for i, c in enumerate(clients):
            outs[i] = _shim_run(c, shims[i], _slice(i))
        for i in range(4):
            assert_parity(outs[i], oracle_ops(ref_r2d2_policy(), _slice(i)))
        for c in clients[1:]:
            assert c.transport_mode == TRANSPORT_SHM
            assert c.transport_fallbacks == {}
            assert c.misrouted_verdicts == 0
        by_sess = {
            s["identity"]: s
            for s in svc.status()["transport"]["sessions"]
        }
        assert by_sess["pod-0"]["mode"] == TRANSPORT_SOCKET
        assert by_sess["pod-0"]["quarantine_reason"] == REASON_TORN_SLOT
        for i in range(1, 4):
            assert by_sess[f"pod-{i}"]["mode"] == TRANSPORT_SHM
    finally:
        for c in clients:
            c.verdict_callback = None
            c.close()
        svc.stop()
        inst.reset_module_registry()


def test_oversize_spree_demotes_one_session_typed(tmp_path):
    """A session whose every frame misses the ring (oversize) demotes
    ITS shm rung typed after the spree threshold — it keeps serving on
    the socket bit-identically — while a well-sized neighbor stays on
    the shm rung."""
    svc = _service(tmp_path, "fanin_spree")
    victim = SidecarClient(
        svc.socket_path, timeout=30.0, identity="pod-big",
        transport=TRANSPORT_SHM, shm_data_slots=4,
        shm_slot_bytes=32 + 64,  # SLOT_HEADER_BYTES + 64
        shm_oversize_spree=4,
    )
    healthy = SidecarClient(svc.socket_path, timeout=30.0,
                            identity="pod-ok", **SHM_KW)
    try:
        _, vshim = _open_conn(victim, 5200)
        _, hshim = _open_conn(healthy, 5201)
        big = b"READ /public/" + b"a" * 200 + b"\r\n"
        msgs = [big] * 6
        got = _shim_run(victim, vshim, msgs)
        assert_parity(got, oracle_ops(ref_r2d2_policy(), msgs))
        assert victim.transport_mode == TRANSPORT_SOCKET
        assert victim.transport_fallbacks.get(
            REASON_OVERSIZE_SPREE, 0) >= 1
        # The neighbor's rung is untouched.
        got_h = _shim_run(healthy, hshim, CORPUS)
        assert_parity(got_h, oracle_ops(ref_r2d2_policy(), CORPUS))
        assert healthy.transport_mode == TRANSPORT_SHM
    finally:
        victim.close()
        healthy.close()
        svc.stop()
        inst.reset_module_registry()


def test_stalled_reader_kills_one_session_only(tmp_path):
    """A shim that stops READING wedges the service's reply writes for
    its socket only: the bounded send times out, THAT session is
    killed typed (send_timeout) and retired to the dead ring, and the
    healthy session never notices."""
    svc = _service(tmp_path, "fanin_stall", device_call_timeout_s=1.0)
    healthy = SidecarClient(svc.socket_path, timeout=30.0,
                            identity="pod-ok")
    raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    raw.connect(svc.socket_path)
    try:
        _, hshim = _open_conn(healthy, 5300)
        # Name the wedged session, then request a flood of status
        # replies without ever reading one: the kernel buffer fills,
        # the service's bounded sendall fires, the session dies typed.
        wire.send_msg(raw, wire.MSG_SESSION_HELLO,
                      wire.pack_session_hello("pod-wedged"))
        stop = threading.Event()

        def flood():
            try:
                while not stop.is_set():
                    wire.send_msg(raw, wire.MSG_STATUS, b"")
            except OSError:
                pass  # service killed the socket — expected

        t = threading.Thread(target=flood, daemon=True)
        t.start()

        def wedged_dead():
            dead = svc.status()["sessions"]["dead"]
            return any(
                d["identity"] == "pod-wedged"
                and d.get("death_reason") == "send_timeout"
                for d in dead
            )

        # Healthy traffic keeps flowing while the wedge times out.
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and not wedged_dead():
            got = _shim_run(healthy, hshim, [b"HALT\r\n"])
            assert_parity(got, oracle_ops(ref_r2d2_policy(), [b"HALT\r\n"]))
            time.sleep(0.1)
        stop.set()
        assert wedged_dead(), svc.status()["sessions"]
        rows = _session_rows(svc)
        assert "pod-ok" in rows and rows["pod-ok"]["state"] == "active"
        got = _shim_run(healthy, hshim, CORPUS)
        assert_parity(got, oracle_ops(ref_r2d2_policy(), CORPUS))
    finally:
        stop.set()
        raw.close()
        healthy.close()
        svc.stop()
        inst.reset_module_registry()


# --- credit fairness (DRR quotas) ------------------------------------------


def test_flood_sheds_typed_per_session_zero_silent_loss(tmp_path):
    """A flooding session is shed typed under ITS quota (session_quota
    on its own row) with every one of its seqs answered exactly once —
    zero silent loss — while a neighbor's synchronous RPCs keep
    serving bit-identically throughout."""
    svc = _service(
        tmp_path, "fanin_flood",
        shed_queue_entries=512,  # share = 512/3 = 170-entry window
        session_share_min=64,
        session_flood_strikes=0,  # pure quota behavior (no escalation)
    )
    hot = SidecarClient(svc.socket_path, timeout=30.0, identity="pod-hot")
    cool = SidecarClient(svc.socket_path, timeout=30.0, identity="pod-cool")
    try:
        _, hot_shim = _open_conn(hot, 5400)
        _, cool_shim = _open_conn(cool, 5401)
        _shim_run(hot, hot_shim, [b"HALT\r\n"])  # engines warm

        answered: dict[int, int] = {}
        lock = threading.Lock()

        def cb(vb):
            with lock:
                answered[vb.seq] = (
                    int(vb.results[0]) if vb.count else -1
                )

        hot.verdict_callback = cb
        msg = b"READ /public/flood.txt\r\n"
        ids = np.full(16, hot_shim.conn_id, np.uint64)
        lens = np.full(16, len(msg), np.uint32)
        blob = msg * 16
        sent = 0
        stop = threading.Event()

        def flood():
            nonlocal sent
            seq = 10_000
            while not stop.is_set():
                seq += 1
                try:
                    hot.send_batch(seq, ids, [0] * 16, lens, blob)
                except Exception:  # noqa: BLE001 — service gone = fail
                    break
                sent += 1

        ft = threading.Thread(target=flood, daemon=True)
        ft.start()
        # The neighbor's synchronous RPCs serve through the flood.
        t_end = time.monotonic() + 2.0
        while time.monotonic() < t_end:
            got = _shim_run(cool, cool_shim, [b"HALT\r\n"])
            assert_parity(got, oracle_ops(ref_r2d2_policy(), [b"HALT\r\n"]))
        stop.set()
        ft.join(10)
        _wait(lambda: len(answered) >= sent, 30.0,
              "every flooded seq answered (zero silent loss)")
        with lock:
            results = set(answered.values())
        assert results <= {int(FilterResult.OK),
                           int(FilterResult.SHED)}, results
        rows = _session_rows(svc)
        hot_row = rows["pod-hot"]
        assert hot_row["shed"].get("session_quota", 0) > 0, hot_row
        assert hot_row["submitted"] == hot_row["answered"], hot_row
        cool_row = rows["pod-cool"]
        assert cool_row["shed"] == {}, cool_row
        assert cool_row["submitted"] == cool_row["answered"], cool_row
        assert hot.misrouted_verdicts == 0
        assert cool.misrouted_verdicts == 0
    finally:
        hot.verdict_callback = None
        stop.set()
        hot.close()
        cool.close()
        svc.stop()
        inst.reset_module_registry()


def test_credit_starvation_neighbor_p99_bounded(tmp_path):
    """The starvation scenario: one session pushing far over fair
    share while 15 idle-ish sessions each keep serving — every light
    session's p99 stays within a bounded multiple of the no-flood
    baseline (DRR quotas cap the flooder's queue share, so the queue a
    light entry waits behind is bounded by the share, not by the
    flooder's appetite)."""
    svc = _service(
        tmp_path, "fanin_starve",
        # share = max(4096/17, 128) = 240: the flooder may hold at
        # most ~240 OUTSTANDING entries (queue + completion pipeline),
        # so the work a light entry waits behind is bounded by the
        # share, not by the flooder's appetite.
        shed_queue_entries=4096,
        session_share_min=128,
        session_flood_strikes=0,
    )
    hot = SidecarClient(svc.socket_path, timeout=60.0, identity="pod-hot")
    lights = [
        SidecarClient(svc.socket_path, timeout=60.0,
                      identity=f"pod-light-{i}")
        for i in range(15)
    ]
    try:
        # 64 distinct flood conns (one pod, many flows): same-conn
        # duplicate batches would fall off the vectorized path and
        # measure entrywise slowness, not fairness.
        hot_mod, hot_shim = _open_conn(hot, 5500)
        hot_ids = [5500] + list(range(5501, 5564))
        for cid in hot_ids[1:]:
            res, _ = hot.new_connection(
                hot_mod, "r2d2", cid, True, 1, 2,
                f"1.1.1.9:{cid}", "2.2.2.2:80", "sidecar-pol",
            )
            assert res == int(FilterResult.OK)
        light_shims = [
            _open_conn(c, 5600 + i)[1] for i, c in enumerate(lights)
        ]
        frame = b"HALT\r\n"
        for c, s in zip(lights, light_shims):
            _shim_run(c, s, [frame])  # warm

        # Prewarm the FLOOD-sized round shapes too: the first round at
        # a new power-of-two dispatch bucket pays a cold XLA compile
        # (seconds on the CPU backend) — cold-start cost, not fairness
        # behavior, and it must not land inside a measured window.
        msg = b"READ /public/flood.txt\r\n"
        warm_done: set[int] = set()
        hot.verdict_callback = lambda vb: warm_done.add(vb.seq)
        ids = np.array(hot_ids, np.uint64)
        lens = np.full(len(ids), len(msg), np.uint32)
        blob = msg * len(ids)
        for w in range(12):
            hot.send_batch(90_000 + w, ids, [0] * len(ids), lens, blob)
        _wait(lambda: len(warm_done) >= 12, 60.0, "flood-shape prewarm")

        def light_p99(window_s: float) -> float:
            lats: list[float] = []
            t_end = time.monotonic() + window_s
            k = 0
            while time.monotonic() < t_end:
                c, s = lights[k % 15], light_shims[k % 15]
                t0 = time.monotonic()
                res, _ = c._on_data_rpc(s.conn_id, False, False, frame)
                assert res == int(FilterResult.OK)
                lats.append(time.monotonic() - t0)
                k += 1
                time.sleep(0.005)
            lats.sort()
            return lats[min(int(len(lats) * 0.99), len(lats) - 1)]

        baseline = light_p99(1.0)

        hot.verdict_callback = lambda vb: None
        stop = threading.Event()

        def flood():
            seq = 50_000
            while not stop.is_set():
                seq += 1
                try:
                    hot.send_batch(
                        seq, ids, [0] * len(ids), lens, blob
                    )
                except Exception:  # noqa: BLE001
                    break

        ft = threading.Thread(target=flood, daemon=True)
        ft.start()
        time.sleep(0.3)  # let the flood reach its quota ceiling
        flooded = light_p99(2.0)
        stop.set()
        ft.join(10)
        hot_row = _session_rows(svc)["pod-hot"]
        assert hot_row["shed"].get("session_quota", 0) > 0, (
            "the flood never hit its quota — the scenario didn't bind"
        )
        # Bounded-multiple assertion (generous for CI noise: the
        # UNBOUNDED failure mode is the flooder owning the whole
        # 32k-entry queue, i.e. seconds of queueing delay).
        bound = max(25.0 * baseline, 1.0)
        assert flooded <= bound, (
            f"light-session p99 {flooded * 1e3:.1f}ms exceeds "
            f"{bound * 1e3:.1f}ms (baseline {baseline * 1e3:.1f}ms) — "
            f"the flooding session starved its neighbors"
        )
    finally:
        stop.set()
        hot.verdict_callback = None
        hot.close()
        for c in lights:
            c.close()
        svc.stop()
        inst.reset_module_registry()


# --- flood escalation & crash-loop quarantine ------------------------------


def test_flood_escalates_to_session_quarantine_and_heals(tmp_path):
    """Sustained over-quota pushing escalates to a session-scoped
    quarantine (typed `flood`): the flooder's data plane is answered
    typed-SHED immediately for the cooldown, its control plane and its
    neighbors keep serving, and the latch self-heals."""
    svc = _service(
        tmp_path, "fanin_esc",
        shed_queue_entries=512,  # share = 170: the window binds fast
        session_share_min=32,
        session_flood_strikes=5,
        session_quarantine_s=1.0,
    )
    hot = SidecarClient(svc.socket_path, timeout=30.0, identity="pod-hot")
    cool = SidecarClient(svc.socket_path, timeout=30.0, identity="pod-cool")
    try:
        _, hot_shim = _open_conn(hot, 5600)
        _, cool_shim = _open_conn(cool, 5601)
        _shim_run(hot, hot_shim, [b"HALT\r\n"])

        answered: dict[int, int] = {}
        hot.verdict_callback = lambda vb: answered.setdefault(
            vb.seq, int(vb.results[0]) if vb.count else -1
        )
        msg = b"READ /public/x.txt\r\n"
        ids = np.full(64, hot_shim.conn_id, np.uint64)
        lens = np.full(64, len(msg), np.uint32)
        blob = msg * 64
        sent = 0
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            sent += 1
            hot.send_batch(9000 + sent, ids, [0] * 64, lens, blob)
            row = _session_rows(svc).get("pod-hot", {})
            if row.get("state") == "quarantined":
                break
        row = _session_rows(svc)["pod-hot"]
        assert row["state"] == "quarantined", row
        assert row["quarantine_reason"] == "flood", row
        assert row["quarantines"].get("flood", 0) >= 1, row
        # Data plane answered typed SHED immediately while latched.
        hot.send_batch(99_999, ids, [0] * 64, lens, blob)
        _wait(lambda: 99_999 in answered, 10.0, "quarantine-window SHED")
        assert answered[99_999] == int(FilterResult.SHED)
        row = _session_rows(svc)["pod-hot"]
        assert row["shed"].get("session_quarantined", 0) >= 1, row
        # Control plane still serves for the quarantined session...
        assert hot.status()["sessions"]["live"]
        # ...and the neighbor is untouched.
        got = _shim_run(cool, cool_shim, CORPUS)
        assert_parity(got, oracle_ops(ref_r2d2_policy(), CORPUS))
        # Every flooded seq answered — zero silent loss through the
        # quota sheds AND the quarantine window.
        _wait(lambda: len(answered) >= sent + 1, 30.0,
              "all flooded seqs answered")
        # The latch self-heals after the cooldown: keep offering
        # traffic until a submission comes back OK (the heal is lazy —
        # traffic drives it).
        hot.verdict_callback = None
        deadline = time.monotonic() + 15.0
        healed = False
        while time.monotonic() < deadline and not healed:
            res, _e = hot._on_data_rpc(
                hot_shim.conn_id, False, False, b"HALT\r\n"
            )
            healed = res == int(FilterResult.OK)
            if not healed:
                time.sleep(0.1)
        assert healed, "quarantine never healed"
        assert _session_rows(svc)["pod-hot"]["state"] == "active"
    finally:
        hot.verdict_callback = None
        hot.close()
        cool.close()
        svc.stop()
        inst.reset_module_registry()


def test_crash_loop_reconnect_quarantined_typed_then_heals(tmp_path):
    """An identity that reconnects past the storm threshold starts its
    next session QUARANTINED (typed reconnect_storm): its data plane is
    answered typed SHED, its control plane still serves (so a healed
    pod exits the latch by staying up), and a different identity is
    untouched throughout."""
    svc = _service(
        tmp_path, "fanin_storm",
        session_reconnect_storm=3,
        session_reconnect_window_s=30.0,
        session_quarantine_s=1.2,
    )
    steady = SidecarClient(svc.socket_path, timeout=30.0,
                           identity="pod-steady")
    flappy = None
    try:
        _, steady_shim = _open_conn(steady, 5700)
        # Crash loop: connect/die 4 times inside the window.
        for _ in range(4):
            SidecarClient(
                svc.socket_path, timeout=30.0, identity="pod-flappy"
            ).close()
        flappy = SidecarClient(svc.socket_path, timeout=30.0,
                               identity="pod-flappy")
        _wait(
            lambda: _session_rows(svc).get(
                "pod-flappy", {}).get("state") == "quarantined",
            5.0, "storm quarantine latch",
        )
        row = _session_rows(svc)["pod-flappy"]
        assert row["quarantine_reason"] == "reconnect_storm", row
        # Control plane serves: the quarantined pod can re-register.
        _, flappy_shim = _open_conn(flappy, 5701)
        # Data plane: typed SHED while latched (on_io surfaces the
        # typed non-OK result; the shim fails closed).
        res, _entries = flappy._on_data_rpc(
            flappy_shim.conn_id, False, False, b"HALT\r\n"
        )
        assert res == int(FilterResult.SHED)
        # The steady identity never notices.
        got = _shim_run(steady, steady_shim, CORPUS)
        assert_parity(got, oracle_ops(ref_r2d2_policy(), CORPUS))
        # Cooldown passes -> the latch heals, the pod serves again.
        time.sleep(1.3)
        got = _shim_run(flappy, flappy_shim, [b"HALT\r\n"])
        assert_parity(got, oracle_ops(ref_r2d2_policy(), [b"HALT\r\n"]))
        assert _session_rows(svc)["pod-flappy"]["state"] == "active"
    finally:
        steady.close()
        if flappy is not None:
            flappy.close()
        svc.stop()
        inst.reset_module_registry()


# --- abrupt shim death: segment reclaim + live-session isolation -----------

_SHIM_SCRIPT = r"""
import os, sys, time
from multiprocessing import resource_tracker

from cilium_tpu_torch.sidecar import SidecarClient
from cilium_tpu_torch.sidecar.transport import TRANSPORT_SHM

client = SidecarClient(
    sys.argv[1], timeout=30.0, transport=TRANSPORT_SHM,
    shm_data_slots=8, shm_slot_bytes=1 << 14,
    shm_verdict_slots=8, shm_verdict_slot_bytes=1 << 14,
    identity="pod-doomed",
)
sess = client._shm
assert sess is not None and sess.active, "shm attach failed"
# Model the native shim: its segments have no Python resource tracker,
# so nothing cleans them up when the process is SIGKILLed.  (Without
# this, the tracker daemon would mask the very leak under test.)
for ring in (sess.data, sess.verdict):
    try:
        resource_tracker.unregister(ring.seg._name, "shared_memory")
    except Exception:
        pass
mod = client.open_module([])
print("SEGS", sess.data.seg.name, sess.verdict.seg.name, flush=True)
time.sleep(60)
"""


def test_abrupt_shim_death_reclaims_segments_spares_live(tmp_path):
    """kill -9 a real shim process holding attached rings: the service
    detects the death (EOF), types it (abrupt), and — because no
    MSG_SHM_DETACH ever arrived — unlinks the orphaned segments after
    the lease expires.  The conftest leak guard only sees in-process
    leaks; this is the cross-process regression.  A live neighbor
    session is untouched throughout."""
    svc = _service(tmp_path, "fanin_kill", shm_lease_s=0.5)
    healthy = SidecarClient(svc.socket_path, timeout=30.0,
                            identity="pod-ok", **SHM_KW)
    proc = None
    try:
        _, hshim = _open_conn(healthy, 5800)
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.Popen(
            [sys.executable, "-c", _SHIM_SCRIPT, svc.socket_path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=REPO, text=True,
        )
        line = ""
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line.startswith("SEGS "):
                break
            if proc.poll() is not None:
                raise AssertionError(
                    f"shim subprocess died early: {proc.stderr.read()}"
                )
        assert line.startswith("SEGS "), "shim never attached"
        seg_names = line.split()[1:]
        assert len(seg_names) == 2
        from multiprocessing import shared_memory

        def seg_exists(name: str) -> bool:
            try:
                h = shared_memory.SharedMemory(name=name, create=False)
            except FileNotFoundError:
                return False
            h.close()
            return True

        assert all(seg_exists(n) for n in seg_names)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(10)
        # Death detected + typed; segments reclaimed after the lease.
        _wait(
            lambda: any(
                d["identity"] == "pod-doomed"
                and d.get("death_reason") == "abrupt"
                for d in svc.status()["sessions"]["dead"]
            ),
            10.0, "abrupt session death typed",
        )
        _wait(lambda: not any(seg_exists(n) for n in seg_names),
              10.0, "orphaned segments unlinked after lease expiry")
        assert svc.shm_reclaims >= 1
        assert svc.status()["transport"]["shm_reclaims"] >= 1
        # The live session never noticed.
        got = _shim_run(healthy, hshim, CORPUS)
        assert_parity(got, oracle_ops(ref_r2d2_policy(), CORPUS))
        assert healthy.transport_mode == TRANSPORT_SHM
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        healthy.close()
        svc.stop()
        inst.reset_module_registry()


# --- observability surfaces ------------------------------------------------


def test_session_observability_rows_filters_and_metrics(tmp_path):
    """`status()["sessions"]` rows, `observe --session`, and
    `trace --session` all attribute work to the right session."""
    svc = _service(tmp_path, "fanin_obs", trace_sample_every=1)
    a = SidecarClient(svc.socket_path, timeout=30.0, identity="pod-a")
    b = SidecarClient(svc.socket_path, timeout=30.0, identity="pod-b")
    try:
        _, ashim = _open_conn(a, 5900)
        _, bshim = _open_conn(b, 5901)
        _shim_run(a, ashim, [b"HALT\r\n", b"READ /public/a\r\n"])
        _shim_run(b, bshim, [b"HALT\r\n"])
        rows = _session_rows(svc)
        sid_a = rows["pod-a"]["session"]
        sid_b = rows["pod-b"]["session"]
        assert sid_a != sid_b
        assert rows["pod-a"]["submitted"] == 2
        assert rows["pod-b"]["submitted"] == 1

        # observe --session: records join the session through the
        # conn-metadata registry.  (Record/span emission may lag the
        # verdict reply by a beat — vec-round records append on the
        # send thread AFTER the frame is written — so poll first.)
        _wait(
            lambda: a.observe(n=100, session=sid_a)["records"]
            and a.observe(n=100, session=sid_b)["records"]
            and a.trace(n=100, session=sid_a)["spans"],
            5.0, "per-session records and spans",
        )
        recs_a = a.observe(n=100, session=sid_a)["records"]
        assert recs_a and all(
            r["conn_id"] == ashim.conn_id and r["session"] == sid_a
            for r in recs_a
        )
        recs_b = a.observe(n=100, session=sid_b)["records"]
        assert recs_b and all(
            r["conn_id"] == bshim.conn_id for r in recs_b
        )

        # trace --session: spans carry the owning session id.
        spans_a = a.trace(n=100, session=sid_a)["spans"]
        assert spans_a and all(
            s.get("session") == sid_a for s in spans_a
        )
        assert all(
            s.get("session") != sid_b
            for s in a.trace(n=100, session=sid_a)["spans"]
        )

        # Session metrics exported (identity-labeled).
        from cilium_tpu_torch.utils.metrics import registry
        text = registry.expose()
        assert "sidecar_sessions_active" in text
        assert "sidecar_session_shed_total" in text
    finally:
        a.close()
        b.close()
        svc.stop()
        inst.reset_module_registry()


def test_wire_session_hello_roundtrip():
    assert wire.unpack_session_hello(
        wire.pack_session_hello("pod-x")
    ) == "pod-x"
    assert wire.unpack_session_hello(b"") == ""
    assert wire.unpack_session_hello(b"\xff{not json") == ""
    assert wire.unpack_session_hello(b'{"identity": null}') == ""
