"""The native C++ shim into the port's verdict service: the twins of
tests/test_native_shim.py, then the two packages' services side by side.

The shim (``native/shim.cc``) is built from the checkout into a directory
of this module's own (``nativeshim.build_shim``), loaded with ctypes and
driven against the port's ``VerdictService`` at ``verdict_device="cpu"``,
with the port's access-log server and map snapshots; each twin asserts
what its reference test asserts.  The parity test drives the same seeded
traffic of all five protocols through the shim into each package's
service and holds ops, forwarded bytes, injects and access-log records
equal (tolerance 0), and to the reference oracle; the two-process test
runs the shim as two processes of its own (``nativeshim.py`` as a script).
"""

from __future__ import annotations

import ctypes
import ipaddress
import json
import random
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path

import pytest

from cilium_tpu_torch.accesslog.server import AccessLogServer
from cilium_tpu_torch.maps.ipcache import IpcacheMap
from cilium_tpu_torch.maps.proxymap import ProxyKey4, ProxyMap
from cilium_tpu_torch.proxylib import NetworkPolicy, PortNetworkPolicy, PortNetworkPolicyRule
from cilium_tpu_torch.proxylib import instance as inst
from cilium_tpu_torch.sidecar import VerdictService, nativeshim
from cilium_tpu_torch.utils.option import DaemonConfig

import cilium_tpu.proxylib as ref_pl
from cilium_tpu.accesslog.server import AccessLogServer as RefAccessLogServer
from cilium_tpu.proxylib import instance as ref_inst
from cilium_tpu.sidecar import VerdictService as RefVerdictService
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig
from test_torch_sidecar import NAMES, PORTS, TRAFFIC, oracle_rounds, policies

OK = 0
UNKNOWN_PARSER = 3

FilterOp = nativeshim.FilterOp


@pytest.fixture(scope="module")
def shim_so(tmp_path_factory):
    return nativeshim.build_shim(build_dir=tmp_path_factory.mktemp("shim-build"))


@pytest.fixture(scope="module")
def shim(shim_so):
    lib = ctypes.CDLL(str(shim_so))
    lib.cilium_tpu_open.restype = ctypes.c_uint64
    lib.cilium_tpu_open.argtypes = [ctypes.c_char_p, ctypes.c_uint8]
    lib.cilium_tpu_policy_update_json.restype = ctypes.c_uint32
    lib.cilium_tpu_on_new_connection.restype = ctypes.c_uint32
    lib.cilium_tpu_on_io.restype = ctypes.c_uint32
    lib.cilium_tpu_on_data.restype = ctypes.c_uint32
    return lib


def _cfg(**kw):
    return DaemonConfig(batch_timeout_ms=2.0, verdict_device="cpu", **kw)


@pytest.fixture
def service(tmp_path):
    inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "v.sock"), _cfg()).start()
    yield svc
    svc.stop()
    inst.reset_module_registry()


def policy():
    return NetworkPolicy(
        name="native-pol",
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


def open_module(shim, service):
    mod = shim.cilium_tpu_open(service.socket_path.encode(), 1)
    assert mod != 0
    pj = json.dumps([asdict(policy())]).encode()
    assert shim.cilium_tpu_policy_update_json(mod, pj, len(pj)) == OK
    return mod


def new_conn(shim, mod, conn_id, proto=b"r2d2", src_id=1):
    return shim.cilium_tpu_on_new_connection(
        mod, proto, conn_id, 1, src_id, 2,
        b"1.1.1.1:1", b"2.2.2.2:80", b"native-pol",
    )


def on_io(shim, mod, conn_id, reply, data: bytes):
    out = ctypes.create_string_buffer(65536)
    out_len = ctypes.c_int64(0)
    res = shim.cilium_tpu_on_io(
        mod, conn_id, int(reply), 0, data, len(data),
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), 65536,
        ctypes.byref(out_len),
    )
    return res, out.raw[: out_len.value]


def _wait_records(srv, n, timeout_s=10.0):
    t0 = time.monotonic()
    while len(srv.records) < n and time.monotonic() - t0 < timeout_s:
        time.sleep(0.02)


# --- the reference tests' twins --------------------------------------------------------


def test_native_allow_deny_flow(shim, service):
    mod = open_module(shim, service)
    assert new_conn(shim, mod, 1) == OK

    res, out = on_io(shim, mod, 1, False, b"READ /public/a.txt\r\n")
    assert res == OK and out == b"READ /public/a.txt\r\n"

    res, out = on_io(shim, mod, 1, False, b"READ /private/x\r\n")
    assert res == OK and out == b""  # denied: dropped

    # Error reply injected ahead of real reply traffic.
    res, out = on_io(shim, mod, 1, True, b"SERVED\r\n")
    assert res == OK and out == b"ERROR\r\nSERVED\r\n"

    shim.cilium_tpu_close_connection(mod, 1)
    shim.cilium_tpu_close_module(mod)


def test_native_partial_frames(shim, service):
    mod = open_module(shim, service)
    assert new_conn(shim, mod, 2) == OK
    res, out = on_io(shim, mod, 2, False, b"READ /pub")
    assert res == OK and out == b""  # retained, no verdict yet
    res, out = on_io(shim, mod, 2, False, b"lic/a.txt\r\nHALT\r\n")
    assert res == OK and out == b"READ /public/a.txt\r\nHALT\r\n"
    shim.cilium_tpu_close_module(mod)


def test_native_pipelined_mixed(shim, service):
    mod = open_module(shim, service)
    assert new_conn(shim, mod, 3) == OK
    res, out = on_io(
        shim, mod, 3, False,
        b"HALT\r\nREAD /private/no\r\nREAD /public/yes\r\n",
    )
    assert res == OK and out == b"HALT\r\nREAD /public/yes\r\n"
    shim.cilium_tpu_close_module(mod)


def test_native_unknown_parser(shim, service):
    mod = shim.cilium_tpu_open(service.socket_path.encode(), 0)
    assert mod != 0
    assert new_conn(shim, mod, 4, proto=b"nope") == UNKNOWN_PARSER
    shim.cilium_tpu_close_module(mod)


def test_native_on_data_op_surface(shim, service):
    """The raw OnData ABI: ops array + caller-owned inject buffers."""
    mod = open_module(shim, service)
    assert new_conn(shim, mod, 5) == OK
    ops = (FilterOp * 16)()
    n_ops = ctypes.c_int32(16)
    inj_o = ctypes.create_string_buffer(1024)
    inj_o_len = ctypes.c_int64(1024)
    inj_r = ctypes.create_string_buffer(1024)
    inj_r_len = ctypes.c_int64(1024)
    data = b"READ /private/x\r\n"
    res = shim.cilium_tpu_on_data(
        mod, 5, 0, 0, data, len(data),
        ops, ctypes.byref(n_ops),
        ctypes.cast(inj_o, ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(inj_o_len),
        ctypes.cast(inj_r, ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(inj_r_len),
    )
    assert res == OK
    got = [(ops[i].op, ops[i].n_bytes) for i in range(n_ops.value)]
    assert got == [(2, len(data)), (0, 1)]  # DROP frame, MORE 1
    assert inj_r.raw[: inj_r_len.value] == b"ERROR\r\n"
    assert inj_o_len.value == 0
    shim.cilium_tpu_close_module(mod)


def test_native_accesslog_client(shim, tmp_path):
    path = str(tmp_path / "al.sock")
    srv = AccessLogServer(path)
    try:
        shim.cilium_tpu_accesslog_open.restype = ctypes.c_uint64
        shim.cilium_tpu_accesslog_log_verdict.restype = ctypes.c_uint32
        al = shim.cilium_tpu_accesslog_open(path.encode())
        assert al != 0
        ok = shim.cilium_tpu_accesslog_log_verdict(
            al, 1, 1, 100, 200, b"1.2.3.4:55", b"5.6.7.8:80", b"r2d2",
            b'say "hi"\\path',
        )
        assert ok == 1
        _wait_records(srv, 1, 5.0)
        assert srv.records, "record not received"
        rec = srv.records[0]
        assert rec.verdict == "Denied"
        assert rec.observation_point == "Ingress"
        assert rec.source.identity == 100
        assert rec.destination.identity == 200
        assert rec.source.ipv4 == "1.2.3.4:55"
        assert rec.info == 'say "hi"\\path'  # JSON escaping survived
        assert rec.l7 is not None and rec.l7.proto == "r2d2"
        shim.cilium_tpu_accesslog_close(al)
    finally:
        srv.close()


def test_native_on_io_emits_access_logs(shim, service, tmp_path):
    """With an access log attached, the shim logs one record per applied
    PASS/DROP op group with the connection's identities."""
    path = str(tmp_path / "al2.sock")
    srv = AccessLogServer(path)
    try:
        shim.cilium_tpu_accesslog_open.restype = ctypes.c_uint64
        mod = open_module(shim, service)
        al = shim.cilium_tpu_accesslog_open(path.encode())
        shim.cilium_tpu_set_accesslog(mod, al)
        assert new_conn(shim, mod, 71) == OK
        res, out = on_io(
            shim, mod, 71, False,
            b"READ /public/ok\r\nREAD /private/no\r\n",
        )
        assert res == OK
        _wait_records(srv, 2, 5.0)
        verdicts = sorted(r.verdict for r in srv.records)
        assert verdicts == ["Denied", "Forwarded"]
        assert all(r.source.identity == 1 for r in srv.records)
        shim.cilium_tpu_accesslog_close(al)
        shim.cilium_tpu_close_module(mod)
    finally:
        srv.close()


def test_native_proxymap_lookup_and_refresh(shim, tmp_path):
    """The port's ``ProxyMap.save`` snapshot, read by the shim."""
    pm = ProxyMap()
    key = ProxyKey4(saddr=0x0A000001, daddr=0x0A000002, sport=40000,
                    dport=15000, nexthdr=6)
    pm.create(key, orig_daddr=0xC0A80107, orig_dport=80, identity=7777)
    path = str(tmp_path / "proxymap.bin")
    assert pm.save(path) == 1

    shim.cilium_tpu_proxymap_open.restype = ctypes.c_uint64
    shim.cilium_tpu_proxymap_refresh.restype = ctypes.c_int64
    shim.cilium_tpu_proxymap_lookup.restype = ctypes.c_uint32
    h = shim.cilium_tpu_proxymap_open(path.encode())
    assert h != 0

    od = ctypes.c_uint32()
    op = ctypes.c_uint32()
    ident = ctypes.c_uint32()
    hit = shim.cilium_tpu_proxymap_lookup(
        h, ctypes.c_uint32(0x0A000001), ctypes.c_uint32(0x0A000002),
        ctypes.c_uint16(40000), ctypes.c_uint16(15000), ctypes.c_uint8(6),
        ctypes.byref(od), ctypes.byref(op), ctypes.byref(ident),
    )
    assert hit == 1
    assert od.value == 0xC0A80107 and op.value == 80 and ident.value == 7777

    # miss on a different tuple
    miss = shim.cilium_tpu_proxymap_lookup(
        h, ctypes.c_uint32(0x0A000001), ctypes.c_uint32(0x0A000002),
        ctypes.c_uint16(40001), ctypes.c_uint16(15000), ctypes.c_uint8(6),
        ctypes.byref(od), ctypes.byref(op), ctypes.byref(ident),
    )
    assert miss == 0

    # datapath adds an entry + re-snapshots; refresh picks it up
    key2 = ProxyKey4(saddr=0x0A000001, daddr=0x0A000002, sport=40001,
                     dport=15000, nexthdr=6)
    pm.create(key2, orig_daddr=0xC0A80108, orig_dport=443, identity=8888)
    assert pm.save(path) == 2
    assert shim.cilium_tpu_proxymap_refresh(h) == 2
    hit2 = shim.cilium_tpu_proxymap_lookup(
        h, ctypes.c_uint32(0x0A000001), ctypes.c_uint32(0x0A000002),
        ctypes.c_uint16(40001), ctypes.c_uint16(15000), ctypes.c_uint8(6),
        ctypes.byref(od), ctypes.byref(op), ctypes.byref(ident),
    )
    assert hit2 == 1 and od.value == 0xC0A80108 and ident.value == 8888
    shim.cilium_tpu_proxymap_close(h)


def test_native_hostmap_lpm(shim, tmp_path):
    """The port's ``IpcacheMap.save`` snapshot: the shim's longest-prefix
    match equals the port's host-side LPM."""
    ipc = IpcacheMap()
    ipc.upsert("10.0.0.0/16", sec_label=500)
    ipc.upsert("10.0.3.0/24", sec_label=103)
    ipc.upsert("10.0.3.7/32", sec_label=777, tunnel_endpoint=0xC0A80102)
    ipc.upsert("0.0.0.0/0", sec_label=2)  # world default
    path = str(tmp_path / "hostmap.bin")
    assert ipc.save(path) == 4

    shim.cilium_tpu_hostmap_open.restype = ctypes.c_uint64
    shim.cilium_tpu_hostmap_refresh.restype = ctypes.c_int64
    shim.cilium_tpu_hostmap_lookup.restype = ctypes.c_uint32
    h = shim.cilium_tpu_hostmap_open(path.encode())
    assert h != 0

    ident = ctypes.c_uint32()
    tun = ctypes.c_uint32()

    def lookup(ip):
        r = shim.cilium_tpu_hostmap_lookup(
            h, ctypes.c_uint32(int(ipaddress.IPv4Address(ip))),
            ctypes.byref(ident), ctypes.byref(tun),
        )
        return r, ident.value, tun.value

    # longest prefix wins at each level
    assert lookup("10.0.3.7") == (33, 777, 0xC0A80102)
    assert lookup("10.0.3.9")[:2] == (25, 103)
    assert lookup("10.0.9.9")[:2] == (17, 500)
    assert lookup("8.8.8.8")[:2] == (1, 2)  # default route

    # fuzz parity with the host-side LPM
    rng = random.Random(21)
    for _ in range(200):
        ip = str(ipaddress.IPv4Address(rng.getrandbits(32)))
        want = ipc.lookup(ip)
        r, got_id, _ = lookup(ip)
        assert (r > 0) == (want is not None)
        if want is not None:
            assert got_id == want.sec_label, ip

    # update + refresh
    ipc.upsert("10.0.4.0/24", sec_label=104)
    assert ipc.save(path) == 5
    assert shim.cilium_tpu_hostmap_refresh(h) == 5
    assert lookup("10.0.4.1")[:2] == (25, 104)
    shim.cilium_tpu_hostmap_close(h)


def test_native_accept_recovers_origdst_and_identities(shim, service, tmp_path):
    """One cilium_tpu_accept call recovers orig-dst from the proxymap,
    resolves identities from the host map, and registers the connection
    so traffic flows end-to-end under the module's policy."""
    ipi = lambda s: int(ipaddress.IPv4Address(s))

    # Datapath state: client 10.1.0.5 was redirected to proxy port
    # 15000 while connecting to 10.2.0.9:80.
    pmap = ProxyMap()
    pmap.create(
        ProxyKey4(saddr=ipi("10.1.0.5"), daddr=ipi("10.0.0.1"),
                  sport=41000, dport=15000, nexthdr=6),
        orig_daddr=ipi("10.2.0.9"), orig_dport=80, identity=1,
    )
    pm_path = str(tmp_path / "pm.bin")
    pmap.save(pm_path)

    ipc = IpcacheMap()
    ipc.upsert("10.1.0.0/16", sec_label=1)
    ipc.upsert("10.2.0.9/32", sec_label=2)
    hm_path = str(tmp_path / "hm.bin")
    ipc.save(hm_path)

    shim.cilium_tpu_proxymap_open.restype = ctypes.c_uint64
    shim.cilium_tpu_hostmap_open.restype = ctypes.c_uint64
    shim.cilium_tpu_accept.restype = ctypes.c_uint32
    pm = shim.cilium_tpu_proxymap_open(pm_path.encode())
    hm = shim.cilium_tpu_hostmap_open(hm_path.encode())
    assert pm and hm

    mod = open_module(shim, service)
    od = ctypes.c_uint32()
    op = ctypes.c_uint32()
    sid = ctypes.c_uint32()
    did = ctypes.c_uint32()
    res = shim.cilium_tpu_accept(
        mod, pm, hm, b"r2d2", 91, 1,
        ctypes.c_uint32(ipi("10.1.0.5")), ctypes.c_uint32(ipi("10.0.0.1")),
        ctypes.c_uint16(41000), ctypes.c_uint16(15000), ctypes.c_uint8(6),
        b"native-pol",
        ctypes.byref(od), ctypes.byref(op), ctypes.byref(sid),
        ctypes.byref(did),
    )
    assert res == OK
    assert od.value == ipi("10.2.0.9") and op.value == 80
    assert sid.value == 1 and did.value == 2  # proxymap + hostmap

    # The registered connection enforces the module's policy.
    r, out = on_io(shim, mod, 91, False, b"READ /public/a\r\n")
    assert r == OK and out == b"READ /public/a\r\n"

    # A non-redirected tuple (proxymap miss): falls back to the host
    # map for the source; an unknown source resolves to world (2),
    # which the policy denies.
    res2 = shim.cilium_tpu_accept(
        mod, pm, hm, b"r2d2", 92, 1,
        ctypes.c_uint32(ipi("203.0.113.7")), ctypes.c_uint32(ipi("10.2.0.9")),
        ctypes.c_uint16(5555), ctypes.c_uint16(80), ctypes.c_uint8(6),
        b"native-pol",
        ctypes.byref(od), ctypes.byref(op), ctypes.byref(sid),
        ctypes.byref(did),
    )
    assert res2 == OK
    assert od.value == ipi("10.2.0.9") and op.value == 80  # unchanged
    assert sid.value == 2  # world
    r2, out2 = on_io(shim, mod, 92, False, b"READ /private/x\r\n")
    assert r2 == OK and out2 == b""  # denied by the file rule

    shim.cilium_tpu_proxymap_close(pm)
    shim.cilium_tpu_hostmap_close(hm)
    shim.cilium_tpu_close_module(mod)


def test_native_shim_survives_service_restart(shim, tmp_path):
    """Stop the port's service mid-stream and start a fresh one on the
    same socket: the shim reconnects, replays policy + connections, and
    resyncs its retained buffer — a frame split across the restart is
    verdicted correctly with zero caller-visible errors."""
    inst.reset_module_registry()
    sock_path = str(tmp_path / "restart.sock")
    svc1 = VerdictService(sock_path, _cfg()).start()
    try:
        mod = shim.cilium_tpu_open(sock_path.encode(), 1)
        assert mod != 0
        pj = json.dumps([asdict(policy())]).encode()
        assert shim.cilium_tpu_policy_update_json(mod, pj, len(pj)) == OK
        assert new_conn(shim, mod, 81) == OK

        # Normal traffic, then HALF a frame before the restart.
        res, out = on_io(shim, mod, 81, False, b"READ /public/a\r\n")
        assert res == OK and out == b"READ /public/a\r\n"
        res, out = on_io(shim, mod, 81, False, b"READ /pub")
        assert res == OK and out == b""  # buffered, no verdict yet

        svc1.stop()
        inst.reset_module_registry()
        svc2 = VerdictService(sock_path, _cfg()).start()
        try:
            # The remainder of the split frame arrives after the
            # restart: the shim reconnects, replays the policy and the
            # connection, resends the retained 9 bytes + the new ones.
            res, out = on_io(shim, mod, 81, False, b"lic/b\r\n")
            assert res == OK and out == b"READ /public/b\r\n"
            # And enforcement still works post-restart.
            res, out = on_io(shim, mod, 81, False, b"READ /private/x\r\n")
            assert res == OK and out == b""
            res, out = on_io(shim, mod, 81, True, b"")  # drain inject
            assert res == OK and out == b"ERROR\r\n"
        finally:
            svc2.stop()
        shim.cilium_tpu_close_module(mod)
    finally:
        try:
            svc1.stop()
        except Exception:
            pass
        inst.reset_module_registry()


# --- the two packages' services through the shim ---------------------------------------

_RNG_SEED = 91


def _traffic():
    return {proto: make(random.Random(_RNG_SEED + k)) for k, (proto, make) in enumerate(TRAFFIC.items())}


def _src(proto, fid):
    return f"10.{list(PORTS).index(proto) + 1}.{fid // 256}.{fid % 256}:{1000 + fid}"


def _shim_drive(nshim, socket_path, al_path, traffic):
    """Every protocol's rounds through the shim, twice on fresh conns: once
    with ``on_data`` ({proto: rounds of {fid: (ops, orig inject, reply
    inject)}}) and once with ``on_io`` and an access log attached ({proto:
    rounds of {fid: (result, forwarded bytes)}})."""
    pj = json.dumps([asdict(p) for p in policies(ref_pl)]).encode()
    mod = nshim.open(socket_path, pj)
    al = nshim.accesslog_open(al_path)
    nshim.set_accesslog(mod, al)  # on_io logs; on_data does not
    try:
        data_out, io_out = {}, {}
        for k, (proto, rounds) in enumerate(traffic.items()):
            data_base, io_base = 100_000 * (k + 1), 100_000 * (k + 1) + 50_000
            remotes = {fid: remote for rnd in rounds for fid, _, remote, _ in rnd}
            for fid, remote in remotes.items():
                for base, src in ((data_base, "1.1.1.1:1"), (io_base, _src(proto, fid))):
                    assert nshim.new_connection(mod, proto, base + fid, remote, 2, src,
                                                f"2.2.2.2:{PORTS[proto]}", NAMES[proto]) == OK
            d_rounds, io_rounds = [], []
            for rnd in rounds:
                d, io = {}, {}
                for fid, chunk, _, reply in rnd:
                    res, ops, io_inj, ir_inj = nshim.on_data(mod, data_base + fid, reply, chunk)
                    assert res == OK, (proto, fid, res)
                    d[fid] = ([(int(o), int(n)) for o, n in ops], io_inj, ir_inj)
                    io[fid] = nshim.on_io(mod, io_base + fid, reply, chunk)
                d_rounds.append(d)
                io_rounds.append(io)
            data_out[proto], io_out[proto] = d_rounds, io_rounds
            for fid in remotes:
                nshim.close_connection(mod, data_base + fid)
                nshim.close_connection(mod, io_base + fid)
        return data_out, io_out
    finally:
        nshim.close(mod)
        nshim.accesslog_close(al)


def _records(srv, n):
    _wait_records(srv, n)
    out = {}
    for r in list(srv.records):
        out.setdefault(r.source.ipv4, []).append(
            (r.verdict, r.observation_point, r.source.identity, r.destination.identity,
             r.destination.ipv4, r.l7.proto))
    return out


def _expected(traffic, oracle):
    """From the oracle's ops and injects: {proto: rounds of {fid: (OK,
    forwarded bytes)}} through ``OnIoMirror``, and the access-log records
    by source address."""
    io_exp, recs = {}, {}
    for proto, rounds in traffic.items():
        mirrors, out = {}, []
        for rnd, exp in zip(rounds, oracle[proto]):
            got = {}
            for fid, chunk, remote, reply in rnd:
                ops, io_inj, ir_inj = exp[fid]
                fwd, passed, dropped = mirrors.setdefault(fid, nativeshim.OnIoMirror()).call(
                    reply, chunk, ops, io_inj, ir_inj)
                got[fid] = (OK, fwd)
                rec = ("Ingress", remote, 2, f"2.2.2.2:{PORTS[proto]}", proto)
                recs.setdefault(_src(proto, fid), []).extend(
                    [("Forwarded", *rec)] * passed + [("Denied", *rec)] * dropped)
            out.append(got)
        io_exp[proto] = out
    return io_exp, recs


def test_native_shim_parity_port_and_reference_services(shim_so, tmp_path):
    """The same seeded traffic of all five protocols through the native
    shim into the port's service and into the reference's: equal ops,
    injects, forwarded bytes and access-log records (tolerance 0), and
    equal to the reference oracle's."""
    traffic = _traffic()
    oracle = {p: oracle_rounds(ref_inst, ref_pl, p, rounds) for p, rounds in traffic.items()}
    io_exp, rec_exp = _expected(traffic, oracle)
    nshim = nativeshim.Shim(shim_so)
    got = {}
    for name, (mod_inst, svc_cls, cfg, srv_cls) in {
        "port": (inst, VerdictService, _cfg(), AccessLogServer),
        "ref": (ref_inst, RefVerdictService, RefDaemonConfig(batch_timeout_ms=2.0), RefAccessLogServer),
    }.items():
        mod_inst.reset_module_registry()
        srv = srv_cls(str(tmp_path / f"{name}-al.sock"))
        svc = svc_cls(str(tmp_path / f"{name}.sock"), cfg).start()
        try:
            data_out, io_out = _shim_drive(nshim, svc.socket_path, srv.path, traffic)
            got[name] = (data_out, io_out, _records(srv, sum(map(len, rec_exp.values()))))
        finally:
            svc.stop()
            srv.close()
            mod_inst.reset_module_registry()
    assert got["port"] == got["ref"]
    data_out, io_out, recs = got["port"]
    # An empty read makes no OnData round trip: no ops, no injects.
    data_exp = {p: [{fid: ([], b"", b"") if not chunk else exp[fid] for fid, chunk, _, _ in rnd}
                    for rnd, exp in zip(traffic[p], oracle[p])] for p in traffic}
    assert data_out == data_exp
    assert io_out == io_exp
    assert recs == rec_exp
    assert sum(map(len, recs.values())) > 100


def _job(tmp_path, name, **job):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({"kind": "drive", **job}))
    return str(path)


def test_native_shim_two_processes(shim_so, service, tmp_path):
    """Two shim processes (``nativeshim.py`` as a script), 4 r2d2 conns
    each, into one port service: every call's forwarded bytes equal the
    reference oracle's through ``OnIoMirror``."""
    rounds = TRAFFIC["r2d2"](random.Random(7))
    rounds = [[e for e in rnd if e[0] < 8] for rnd in rounds]
    oracle = oracle_rounds(ref_inst, ref_pl, "r2d2", rounds)
    pj = json.dumps([asdict(p) for p in policies(ref_pl)])
    script = Path(nativeshim.__file__)
    procs, jobs = [], []
    try:
        for k in range(2):
            fids = [fid for fid in range(8) if fid % 2 == k]
            remotes = {e[0]: e[2] for rnd in rounds for e in rnd}
            calls = [[r, 30_000 + fid, reply, nativeshim.b64(chunk)]
                     for r, rnd in enumerate(rounds) for fid, chunk, _, reply in rnd if fid in fids]
            jobs.append(_job(tmp_path, f"pod{k}", library=str(shim_so), socket=service.socket_path,
                             policy=pj, calls=calls,
                             conns=[["r2d2", 30_000 + fid, remotes[fid], "1.1.1.1:1", "2.2.2.2:80",
                                     NAMES["r2d2"]] for fid in fids]))
            procs.append(subprocess.Popen([sys.executable, str(script)], stdin=subprocess.PIPE,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for p, j in zip(procs, jobs):
            p.stdin.write(j + "\n")
            p.stdin.flush()
        for p, j in zip(procs, jobs):
            line = p.stdout.readline().strip()
            assert line == f"done {j}", (line, p.stderr.read() if p.poll() is not None else "")
        mirrors = {}
        for j in jobs:
            res = json.loads(Path(j + ".out").read_text())
            job = json.loads(Path(j).read_text())
            assert res["conn_results"] == [] and set(res["results"]) == {OK}
            for (r, cid, reply, chunk), fwd in zip(job["calls"], res["outs"]):
                ops, io_inj, ir_inj = oracle[r][cid - 30_000]
                want, _, _ = mirrors.setdefault(cid, nativeshim.OnIoMirror()).call(
                    reply, nativeshim.unb64(chunk), ops, io_inj, ir_inj)
                assert nativeshim.unb64(fwd) == want, (r, cid)
        assert len(mirrors) == 8
    finally:
        for p in procs:
            if p.poll() is None:
                p.stdin.close()
                p.wait(30)
