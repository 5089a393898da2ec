"""The port's sidecar verdict service at verdict_device="cpu" against the
JAX package's.

The wire encodings must be byte-identical; the port's row build
(``ops.gather.gather_rows``, the plain version of kernel K16) must equal
the rows of the reference's ``_gather_model``; and the port's
``VerdictService``, driven by the port's ``SidecarClient`` and by the
reference's, must reproduce the reference's in-process proxylib oracle op
for op (and inject for inject) on tests/test_sidecar.py's r2d2 corpus and
on seeded HTTP, DNS (columnar reassembly lane), Cassandra and memcached
streams, and agree with the reference service on the same traffic
(tolerance 0: ops, byte counts and injects are integers and bytes).  The
plain PyTorch versions run here; the card's K16 and the CUDA-graph
dispatch are held against them in tests/test_torch_cuda.py and
chip_smoke.py.  Every service (and with it its flight recorder and ledger)
is stopped by the fixture or test that started it.
"""

from __future__ import annotations

import random
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cilium_tpu.proxylib as ref_pl
import cilium_tpu_torch.proxylib as port_pl
from cilium_tpu.proxylib import instance as ref_inst
from cilium_tpu.sidecar import SidecarClient as RefSidecarClient
from cilium_tpu.sidecar import VerdictService as RefVerdictService
from cilium_tpu.sidecar import service as ref_service
from cilium_tpu.sidecar import wire as ref_wire
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig
from cilium_tpu_torch.models import dns as port_dns
from cilium_tpu_torch.models import http as port_http
from cilium_tpu_torch.models import r2d2 as port_r2d2
from cilium_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from cilium_tpu_torch.proxylib import instance as port_inst
from cilium_tpu_torch.proxylib.parsers.dns import DNS_QNAME_OFF, encode_dns_query
from cilium_tpu_torch.proxylib.types import DROP, PASS, FilterResult
from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
from cilium_tpu_torch.sidecar import wire
from cilium_tpu_torch.sidecar import service as port_service_mod
from cilium_tpu_torch.utils.option import DaemonConfig

# --- (a) wire encodings ------------------------------------------------------


def _wire_cases(w):
    ops = np.zeros(5, w.FILTER_OP)
    ops["op"] = [PASS, DROP, 0, PASS, 3]
    ops["n_bytes"] = [10, 4, 1, 7, 2]
    body = w.pack_verdict_body(
        [7, 8], [0, 0], [2, 3], [0, 1], [0, 7], ops, b"IERROR\r\n"
    )
    return [
        w.pack_data_batch(7, [1, 2, 3], [0, 1, 2], [5, 5, 2], b"helloworldxy"),
        w.pack_data_batch(2**40, [], [], [], b""),
        w.pack_data_batch_dl(1500, 9, [4], [w.FLAG_REPLY], [3], b"abc"),
        w.pack_data_matrix(11, 8, [5, 6], [3, 8], bytes(range(16))),
        w.pack_verdict_batch(
            9, [5, 6], [0, 0], [2, 1], [1, 0], [3, 2], ops[:3], b"XabcYZ"
        ),
        body,
        w.pack_verdict_multi([21, 22], [1, 1], 2, body),
    ]


def test_wire_encodings_are_byte_identical():
    ref, port = _wire_cases(ref_wire), _wire_cases(wire)
    assert len(ref) == len(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert bytes(r) == bytes(p), i
    assert port[0] == ref[0] and wire.unpack_data_batch(port[0]).entry(1) == (
        ref_wire.unpack_data_batch(ref[0]).entry(1)
    )
    vb, rvb = wire.unpack_verdict_multi(port[-1]), ref_wire.unpack_verdict_multi(ref[-1])
    assert [v.entry(0) for v in vb] == [v.entry(0) for v in rvb]


# --- (b) the row build -------------------------------------------------------


class _Rows:
    """A model that hands back the rows it was given: the reference's
    ``_gather_model`` then returns exactly its row build."""

    def __call__(self, rows, lens, remotes):
        return rows


def _gather_case(rng, n, blob_len, width):
    blob = rng.integers(0, 256, blob_len, dtype=np.uint8)
    offs = rng.integers(0, blob_len, n).astype(np.int32)
    lens = rng.integers(0, width + 9, n).astype(np.int32)
    edges = [
        (blob_len - 1, width),  # past the end: the clip repeats blob[B-1]
        (blob_len - 1, 1),
        (0, 0),
        (3, width),
        (5, width + 40),  # longer than the row
        (blob_len - 4, width),
        (-2, 3),  # a negative offset clips to 0
        (7, -1),  # a negative length gives zeros
    ]
    for i, (o, ln) in enumerate(edges[: n]):
        offs[i], lens[i] = o, ln
    return blob, offs, lens


@pytest.mark.parametrize("n", [1, 2, 7, 64, 256, 512, 2048])
def test_gather_rows_equals_reference_gather(n):
    rng = np.random.default_rng(100 + n)
    for blob_len, width in ((65536, 256), (300, 64), (1, 16), (4096, 40)):
        blob, offs, lens = _gather_case(rng, n, blob_len, width)
        want = np.asarray(ref_service._gather_model(
            _Rows(), jnp.asarray(blob), jnp.asarray(offs), jnp.asarray(lens),
            None, width,
        ))
        got = gather_rows(torch.from_numpy(blob), torch.from_numpy(offs),
                          torch.from_numpy(lens), width)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (n, width)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            gather_rows_plain(torch.from_numpy(blob), torch.from_numpy(offs),
                              torch.from_numpy(lens), width).numpy(), want)


def test_gather_rows_checks_its_inputs():
    blob = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="blob"):
        gather_rows(torch.zeros(0, dtype=torch.uint8), np.zeros(1, np.int32),
                    np.zeros(1, np.int32), 4)
    with pytest.raises(TypeError, match="offs"):
        gather_rows(blob, torch.zeros(2, dtype=torch.int64),
                    torch.zeros(2, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="lens"):
        gather_rows(blob, torch.zeros(2, dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32), 4)
    # numpy inputs are copied to the blob's device
    rows = gather_rows(blob + 1, np.array([6], np.int32), np.array([4], np.int32), 4)
    assert rows.tolist() == [[1, 1, 1, 1]]


# --- policies and traffic ----------------------------------------------------

R2D2, HTTP, DNS, CASS, MC = "sidecar-pol", "http-graft", "dns-bench", "cass-bench", "mc-bench"
PORTS = {"r2d2": 80, "http": 80, "dns": 53, "cassandra": 9042, "memcache": 11211}
NAMES = {"r2d2": R2D2, "http": HTTP, "dns": DNS, "cassandra": CASS, "memcache": MC}


def policies(pl, r2d2_rules=None):
    """tests/test_sidecar.py's r2d2 policy and bench.py's HTTP, DNS,
    Cassandra and memcached policies, in ``pl``'s NPDS types."""

    def one(name, port, rule):
        return pl.NetworkPolicy(name=name, policy=2, ingress_per_port_policies=[
            pl.PortNetworkPolicy(port=port, rules=[rule])])

    rule = pl.PortNetworkPolicyRule
    return [
        one(R2D2, 80, rule(remote_policies=[1, 3], l7_proto="r2d2", l7_rules=r2d2_rules or [
            {"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])),
        one(HTTP, 80, rule(http_rules=[{"method": "GET", "path": "/public/.*"}])),
        one(DNS, 53, rule(l7_proto="dns", l7_rules=[
            {"matchName": "api.example.com"},
            {"matchPattern": "*.svc.cluster.local"},
            {"matchRegex": "^cdn[0-9]+[.]edge[.]net$"}])),
        one(CASS, 9042, rule(l7_proto="cassandra", l7_rules=[
            {"query_action": "select", "query_table": "^public\\."},
            {"query_action": "insert", "query_table": "^public\\."}])),
        one(MC, 11211, rule(l7_proto="memcache", l7_rules=[
            {"command": "get", "keyPrefix": "user:"},
            {"command": "set", "keyRegex": "^sess:[0-9]+$"},
            {"command": "delete", "keyExact": "the-key"}])),
    ]


CORPUS = [
    b"READ /public/a.txt\r\n",
    b"READ /private/x\r\n",
    b"HALT\r\n",
    b"WRITE /public/b\r\n",
    b"RESET\r\n",
    b"READ /public/deep/path/c.dat\r\n",
]


def _cut(rng, stream, parts=3):
    cuts = sorted(rng.randrange(0, len(stream) + 1) for _ in range(parts - 1))
    bounds = [0, *cuts, len(stream)]
    return [stream[a:b] for a, b in zip(bounds, bounds[1:])]


def r2d2_rounds(rng, n_conns, n_rounds=3):
    """bench_mixed's mix per conn: whole frames (the vec lane), frames
    split across rounds, pipelined pairs, and reply-direction bytes; remote
    9 (denied by the policy) on every 7th conn."""
    rounds = [[] for _ in range(n_rounds)]
    for fid in range(n_conns):
        remote = 9 if fid % 7 == 6 else (1 if fid % 2 else 3)
        kind = fid % 20
        for rnd in range(n_rounds):
            f = CORPUS[rng.randrange(len(CORPUS))]
            if kind < 16:
                rounds[rnd].append((fid, f, remote, False))
            elif kind < 18:
                half = rng.randrange(1, len(f))
                chunk = f[:half] if rnd % 2 == 0 else f[half:]
                rounds[rnd].append((fid, chunk, remote, False))
            elif kind < 19:
                rounds[rnd].append((fid, f + CORPUS[rng.randrange(len(CORPUS))], remote, False))
            else:
                rounds[rnd].append((fid, b"OK data %d\r\n" % rnd if rnd else f, remote, rnd > 0))
    return rounds


def http_rounds(rng, n_conns):
    streams = []
    for fid in range(n_conns):
        s = b""
        for _ in range(rng.randrange(1, 4)):
            path = f"/public/a{rng.randrange(99)}" if rng.random() < 0.5 else f"/private/b{rng.randrange(99)}"
            method = "GET" if rng.random() < 0.8 else "POST"
            body = b""
            head = "Host: svc.local\r\nUser-Agent: t\r\n"
            if rng.random() < 0.25:
                body = bytes(rng.randrange(97, 123) for _ in range(rng.randrange(40)))
                head += f"Content-Length: {len(body)}\r\n"
            s += f"{method} {path} HTTP/1.1\r\n{head}\r\n".encode() + body
        streams.append(s)
    return _rounds_of(rng, streams, remote=lambda fid: 1 if fid % 5 else 2)


def dns_frames(rng, n):
    names = ["api.example.com", "pod%d.svc.cluster.local", "cdn%d.edge.net", "evil%d.test",
             "API.Example.COM", "a.b.svc.cluster.local"]
    out = []
    for i in range(n):
        nm = names[rng.randrange(len(names))]
        out.append(encode_dns_query(nm % rng.randrange(50) if "%d" in nm else nm))
    bad = bytearray(encode_dns_query("bad.svc.cluster.local"))
    bad[DNS_QNAME_OFF] = 0xC0
    out[n // 2] = bytes(bad)
    return out


def dns_rounds(rng, n_conns, n_rounds=4):
    """bench.py:664-705's DNS lane mix: whole frames, frames split
    mid-QNAME across round pairs, pipelined pairs."""
    msgs = dns_frames(rng, 32)
    rounds = [[] for _ in range(n_rounds)]
    for rnd in range(n_rounds):
        for fid in range(n_conns):
            f = msgs[(fid + rnd) % len(msgs)]
            if fid % 3 == 0:
                fs = msgs[(fid + rnd // 2) % len(msgs)]
                half = len(fs) // 2
                chunk = fs[:half] if rnd % 2 == 0 else fs[half:]
            elif fid % 3 == 1:
                chunk = f + msgs[(fid + rnd + 1) % len(msgs)]
            else:
                chunk = f
            rounds[rnd].append((fid, chunk, 1, False))
    return rounds


def _cass_query(cql, stream=0):
    q = cql.encode()
    body = struct.pack(">I", len(q)) + q + b"\x00\x01\x00"
    return bytes([4, 0]) + struct.pack(">HB", stream, 0x07) + struct.pack(">I", len(body)) + body


def cass_rounds(rng, n_conns):
    streams = []
    for fid in range(n_conns):
        frames = []
        for k in range(rng.randrange(1, 4)):
            ks = "public" if rng.random() < 0.5 else "secret"
            roll = rng.random()
            if roll < 0.4:
                frames.append(_cass_query(f"SELECT * FROM {ks}.t{rng.randrange(9)}", k))
            elif roll < 0.7:
                frames.append(_cass_query(f"INSERT INTO {ks}.t (a) VALUES (1)", k))
            elif roll < 0.85:
                frames.append(_cass_query(f"DELETE FROM {ks}.z WHERE a=1", k))
            else:
                frames.append(_cass_query("USE public", k))
                frames.append(_cass_query(f"SELECT * FROM t{rng.randrange(9)}", k + 1))
        if fid % 9 == 0:
            frames.append(_cass_query("SELECT * FROM public." + "t" * 120, 7))
        streams.append(b"".join(frames))
    return _rounds_of(rng, streams)


def _mc_bin(opcode, key=b"", extras=b"", value=b""):
    body = extras + key + value
    return (bytes([0x80, opcode]) + struct.pack(">H", len(key)) + bytes([len(extras), 0])
            + b"\x00\x00" + struct.pack(">I", len(body)) + b"\x00" * 12 + body)


def mc_rounds(rng, n_conns):
    streams = []
    for fid in range(n_conns):
        frames = []
        for _ in range(rng.randrange(1, 4)):
            n = rng.randrange(99)
            roll = rng.random()
            if fid % 3 == 0:
                if roll < 0.5:
                    frames.append(_mc_bin(0, key=b"user:%d" % n))
                elif roll < 0.8:
                    frames.append(_mc_bin(1, key=b"sess:%d" % n, extras=b"\x00" * 8, value=b"v"))
                else:
                    frames.append(_mc_bin(4, key=b"the-key"))
            elif roll < 0.4:
                frames.append(b"get user:%d\r\n" % n)
            elif roll < 0.6:
                frames.append(b"get admin:%d\r\n" % n)
            elif roll < 0.8:
                frames.append(b"set sess:%d 0 0 2\r\nhi\r\n" % n)
            else:
                frames.append(b"delete the-key\r\n")
        if fid % 3 and fid % 8 == 1:
            frames.append(b"get user:1 user:2\r\n")
        streams.append(b"".join(frames))
    return _rounds_of(rng, streams)


def _rounds_of(rng, streams, remote=lambda fid: 1):
    rounds = [[], [], []]
    for fid, s in enumerate(streams):
        for rnd, chunk in zip(rounds, _cut(rng, s)):
            rnd.append((fid, chunk, remote(fid), False))
    return rounds


# Which DATA batch of a round a conn rides: the whole-frame conns apart
# (the blob lane takes a batch whose every entry is one whole frame on a
# clean conn), as a shim that frames its reads sends them.
GROUPS = {
    "r2d2": lambda fid: int(fid % 20 >= 16),
    "dns": lambda fid: int(fid % 3 != 2),
}

TRAFFIC = {
    "r2d2": lambda rng: r2d2_rounds(rng, 40),
    "http": lambda rng: http_rounds(rng, 24),
    "dns": lambda rng: dns_rounds(rng, 24),
    "cassandra": lambda rng: cass_rounds(rng, 24),
    "memcache": lambda rng: mc_rounds(rng, 24),
}

# --- the oracle and the service drivers --------------------------------------


def oracle_rounds(inst, pl, proto, rounds, pols=None):
    """Each round's per-conn (ops, orig inject, reply inject) from the
    in-process proxylib oracle of ``inst``, fed as the service's buffer
    mirror feeds it: new bytes appended per direction, the unconsumed
    buffer re-offered, bytes a PASS/DROP covered beyond the buffer skipped
    on arrival."""
    inst.reset_module_registry()
    mod = inst.open_module([], True)
    inst.find_instance(mod).policy_update(pols or policies(pl))
    conns, out = {}, []
    for rnd in rounds:
        got = {}
        for fid, chunk, remote, reply in rnd:
            if fid not in conns:
                res, conn = inst.on_new_connection(
                    mod, proto, 10_000 + fid, True, remote, 2, "1.1.1.1:1",
                    f"2.2.2.2:{PORTS[proto]}", NAMES[proto],
                    orig_buf_capacity=1 << 16, reply_buf_capacity=1 << 16,
                )
                assert res == FilterResult.OK
                conns[fid] = [conn, {False: bytearray(), True: bytearray()}, {False: 0, True: 0}]
            conn, bufs, skip = conns[fid]
            take = min(skip[reply], len(chunk))
            skip[reply] -= take
            bufs[reply].extend(chunk[take:])
            ops = []
            if bufs[reply]:
                conn.on_data(reply, False, [bytes(bufs[reply])], ops)
            consumed = 0
            for op, n in ops:
                if op in (PASS, DROP):
                    t = min(n, len(bufs[reply]) - consumed)
                    consumed += t
                    skip[reply] += n - t
            del bufs[reply][:consumed]
            got[fid] = ([(int(o), int(n)) for o, n in ops], conn.orig_buf.take(),
                        conn.reply_buf.take())
        out.append(got)
    inst.close_module(mod)
    inst.reset_module_registry()
    return out


def open_with_policies(client, pl, pols=None):
    mod = client.open_module([])
    assert mod != 0
    assert client.policy_update(mod, pols or policies(pl)) == int(FilterResult.OK)
    return mod


def service_rounds(client, mod, proto, rounds, base, group=None):
    """Each round's per-conn (ops, orig inject, reply inject) from the
    service: one DATA batch a round for each ``group(fid)`` (every conn
    in one by default; the batches of a round are in flight together),
    through ``send_batch`` (the socket or the shm rings)."""
    group = group or GROUPS.get(proto, lambda fid: 0)
    fids = {}
    for rnd in rounds:
        for fid, _, remote, _ in rnd:
            fids.setdefault(fid, remote)
    for fid, remote in fids.items():
        res, _ = client.new_connection(
            mod, proto, base + fid, True, remote, 2, "1.1.1.1:1",
            f"2.2.2.2:{PORTS[proto]}", NAMES[proto],
        )
        assert res == int(FilterResult.OK)
    got, evt = {}, threading.Event()

    def cb(vb):
        got[vb.seq] = vb
        evt.set()

    client.verdict_callback = cb
    out = []
    try:
        for rnd in rounds:
            batches = {}
            for e in rnd:
                batches.setdefault(group(e[0]), []).append(e)
            seqs = []
            for ents in batches.values():
                seq = next(client._seq)  # the client's own sequence: no reuse
                seqs.append(seq)
                ids = np.array([base + fid for fid, *_ in ents], np.uint64)
                flags = np.array([wire.FLAG_REPLY if r else 0 for *_, r in ents], np.uint8)
                lens = np.array([len(c) for _, c, _, _ in ents], np.uint32)
                client.send_batch(seq, ids, flags, lens, b"".join(c for _, c, _, _ in ents))
            deadline = time.monotonic() + 60
            while not all(q in got for q in seqs) and time.monotonic() < deadline:
                evt.wait(0.05)
                evt.clear()
            per = {}
            for q in seqs:
                vb = got.pop(q)
                for j in range(vb.count):
                    cid, res, ops, io, ir = vb.entry(j)
                    assert res == int(FilterResult.OK), (cid, res)
                    o, a, b = per.setdefault(int(cid) - base, ([], b"", b""))
                    per[int(cid) - base] = (o + [(int(x), int(n)) for x, n in ops],
                                            a + io, b + ir)
            out.append(per)
    finally:
        client.verdict_callback = None
        for fid in fids:
            client.close_connection(base + fid)
    return out


def port_cfg(**kw):
    kw.setdefault("batch_timeout_ms", 2.0)
    kw.setdefault("batch_flows", 256)
    kw.setdefault("verdict_device", "cpu")
    kw.setdefault("reasm_min_entries", 1)
    return DaemonConfig(**kw)


@pytest.fixture(scope="module")
def port_service(tmp_path_factory):
    port_inst.reset_module_registry()
    svc = VerdictService(str(tmp_path_factory.mktemp("ps") / "v.sock"), port_cfg()).start()
    yield svc
    svc.stop()
    port_inst.reset_module_registry()


@pytest.fixture(scope="module")
def ref_service_(tmp_path_factory):
    ref_inst.reset_module_registry()
    cfg = RefDaemonConfig(batch_timeout_ms=2.0, batch_flows=256, dispatch_mode="eager",
                          reasm_min_entries=1)
    svc = RefVerdictService(str(tmp_path_factory.mktemp("rs") / "v.sock"), cfg).start()
    yield svc
    svc.stop()
    ref_inst.reset_module_registry()


@pytest.fixture(params=["port", "ref"])
def client(request, port_service):
    cls = SidecarClient if request.param == "port" else RefSidecarClient
    c = cls(port_service.socket_path, timeout=60.0)
    yield c
    c.close()


_BASES = iter(range(100_000, 10**9, 10_000))


def assert_rounds_equal(got, exp):
    assert len(got) == len(exp)
    for i, (g, e) in enumerate(zip(got, exp)):
        assert sorted(g) == sorted(e), i
        for fid in e:
            assert g[fid] == e[fid], (i, fid, g[fid], e[fid])


# --- (c) the port service against the reference oracle ------------------------


def shim_ops(client, mod, msgs, remote_id=1, reply_flags=None, conn_id=None):
    conn_id = conn_id or next(_BASES)
    res, shim = client.new_connection(mod, "r2d2", conn_id, True, remote_id, 2, "1.1.1.1:1",
                                      "2.2.2.2:80", R2D2)
    assert res == int(FilterResult.OK)
    out = []
    for i, m in enumerate(msgs):
        reply = bool(reply_flags[i]) if reply_flags else False
        _, entries = client._on_data_rpc(shim.conn_id, reply, False, m)
        ops, inj = [], b""
        for _, r, eops, _io, ir in entries:
            assert r == int(FilterResult.OK)
            ops.extend((int(o), int(n)) for o, n in eops)
            inj += ir
        out.append((ops, inj))
    shim.close()
    return out


def ref_oracle_ops(msgs, remote_id=1, reply_flags=None, r2d2_rules=None):
    rounds = [[(0, m, remote_id, bool(reply_flags[i]) if reply_flags else False)]
              for i, m in enumerate(msgs)]
    exp = oracle_rounds(ref_inst, ref_pl, "r2d2", rounds,
                        pols=policies(ref_pl, r2d2_rules) if r2d2_rules else None)
    return [(e[0][0], e[0][2]) for e in exp]


def _fuzz_msgs():
    rng = random.Random(42)
    raw = b"".join(CORPUS[rng.randrange(len(CORPUS))] for _ in range(60))
    msgs, i = [], 0
    while i < len(raw):
        n = rng.randrange(1, 40)
        msgs.append(raw[i: i + n])
        i += n
    return msgs


R2D2_CASES = {
    "single-frames": (CORPUS, 1, None),
    "denied-remote": (CORPUS, 9, None),
    "split-and-pipelined": ([b"READ /pub", b"lic/a.txt\r\nHALT\r\nREAD /private/x\r\n",
                             b"WRI", b"TE /public/b\r\n"], 1, None),
    "reply-direction": ([b"READ /public/a.txt\r\n", b"OK data\r\n", b"HALT\r\n"], 1, [0, 1, 0]),
    "fuzz": (_fuzz_msgs(), 1, None),
}


@pytest.mark.parametrize("case", sorted(R2D2_CASES))
def test_r2d2_corpus_matches_reference_oracle(client, case):
    msgs, remote, flags = R2D2_CASES[case]
    mod = open_with_policies(client, port_pl)
    assert shim_ops(client, mod, msgs, remote, flags) == ref_oracle_ops(msgs, remote, flags)


def test_policy_swap_matches_reference_oracle(tmp_path):
    port_inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "swap.sock"), port_cfg()).start()
    c = SidecarClient(svc.socket_path, timeout=60.0)
    try:
        mod = open_with_policies(c, port_pl)
        res, shim = c.new_connection(mod, "r2d2", 3000, True, 1, 2, "1.1.1.1:1",
                                     "2.2.2.2:80", R2D2)
        assert res == int(FilterResult.OK)
        assert shim.on_io(False, b"READ /public/a.txt\r\n")[1] == b"READ /public/a.txt\r\n"
        swapped = [{"cmd": "RESET"}]
        assert c.policy_update(mod, policies(port_pl, swapped)) == int(FilterResult.OK)
        msgs = [b"READ /public/a.txt\r\n", b"RESET\r\n"]
        assert shim_ops(c, mod, msgs) == ref_oracle_ops(msgs, r2d2_rules=swapped)
        assert shim.on_io(False, b"READ /public/a.txt\r\n")[1] == b""
        shim.close()
        assert svc.status()["policy"]["swaps"] >= 1
    finally:
        c.close()
        svc.stop()
        port_inst.reset_module_registry()


@pytest.mark.parametrize("proto", ["r2d2", "http", "dns", "cassandra", "memcache"])
def test_seeded_streams_match_reference_oracle(client, port_service, proto):
    rounds = TRAFFIC[proto](random.Random(f"{proto}-7"))
    exp = oracle_rounds(ref_inst, ref_pl, proto, rounds)
    mod = open_with_policies(client, port_pl)
    before = (port_service.status()["reasm"] or {}).get("rounds_by_framing", {}).get("dns", 0)
    got = service_rounds(client, mod, proto, rounds, next(_BASES))
    assert_rounds_equal(got, exp)
    st = port_service.status()
    if proto == "dns":
        assert st["reasm"]["rounds_by_framing"]["dns"] > before
    assert st["device"]["device"] == "cpu"
    cont = st["containment"]
    assert cont["quarantined"] is False and cont["refused_entries"] == {}
    assert cont["readback_failures"] == 0


def test_port_oracle_equals_reference_oracle():
    """The port's copy of the in-process oracle (``proxylib.instance``)
    gives the reference's ops on every seeded stream."""
    for proto, make in TRAFFIC.items():
        rounds = make(random.Random(f"{proto}-3"))
        assert oracle_rounds(port_inst, port_pl, proto, rounds) == oracle_rounds(
            ref_inst, ref_pl, proto, rounds), proto


# --- (d) the port service against the reference service ----------------------


@pytest.mark.parametrize("proto", ["r2d2", "dns"])
def test_port_service_equals_reference_service(port_service, ref_service_, proto):
    rounds = TRAFFIC[proto](random.Random(f"{proto}-11"))
    outs, counts = [], []
    for svc, cls, pl in ((port_service, SidecarClient, port_pl),
                         (ref_service_, RefSidecarClient, ref_pl)):
        c = cls(svc.socket_path, timeout=120.0)
        try:
            mod = open_with_policies(c, pl)
            requests0 = svc.fast_log.requests
            reasm0 = dict(svc.status()["reasm"]["rounds_by_framing"])
            outs.append(service_rounds(c, mod, proto, rounds, 900_000))
            reasm = svc.status()["reasm"]["rounds_by_framing"]
            counts.append((svc.fast_log.requests - requests0,
                           {k: v - reasm0.get(k, 0) for k, v in reasm.items()
                            if v != reasm0.get(k, 0)}))
        finally:
            c.close()
    assert_rounds_equal(outs[0], outs[1])
    assert counts[0] == counts[1]
    assert counts[0][1].get("dns" if proto == "dns" else "crlf", 0) > 0


# --- (e) dispatch modes --------------------------------------------------------


def test_dispatch_modes_give_identical_ops(tmp_path):
    """On the CPU every mode calls the model directly (nothing is
    captured), so each reports "eager"; the ops agree with each other and
    with the reference oracle."""
    rounds = r2d2_rounds(random.Random(5), 24)
    exp = oracle_rounds(ref_inst, ref_pl, "r2d2", rounds)
    for mode in ("eager", "jit", "auto"):
        port_inst.reset_module_registry()
        svc = VerdictService(str(tmp_path / f"{mode}.sock"), port_cfg(dispatch_mode=mode)).start()
        c = SidecarClient(svc.socket_path, timeout=60.0)
        try:
            got = service_rounds(c, open_with_policies(c, port_pl), "r2d2", rounds, 5000)
            assert_rounds_equal(got, exp)
            assert svc.dispatch_mode_chosen == "eager"
            assert svc.status()["device"]["graphs"] == {"captures": 0, "replays": 0}
        finally:
            c.close()
            svc.stop()
            port_inst.reset_module_registry()


# --- (f) the readback audit ---------------------------------------------------


class _NoHostTensor(torch.Tensor):
    """A model output that refuses every host conversion but ``.cpu()``:
    ``np.asarray`` on a CUDA tensor raises, and this makes the CPU run
    raise the same way."""

    def __array__(self, *args, **kwargs):
        raise AssertionError("np.asarray on a model output")

    def numpy(self, *args, **kwargs):
        raise AssertionError(".numpy() on a model output")

    def tolist(self):
        raise AssertionError(".tolist() on a model output")

    def item(self):
        raise AssertionError(".item() on a model output")

    def cpu(self, *args, **kwargs):
        return torch.Tensor.cpu(self, *args, **kwargs).as_subclass(torch.Tensor)


class _Audited:
    """A model whose calls return ``_NoHostTensor``s; everything else is
    the model's own."""

    def __init__(self, model):
        self.__dict__["_model"] = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    @staticmethod
    def _wrap(outs):
        return tuple(t.as_subclass(_NoHostTensor) for t in outs)

    def __call__(self, *args):
        return self._wrap(self._model(*args))

    def verdicts_attr(self, *args):
        return self._wrap(self._model.verdicts_attr(*args))


def test_every_readback_goes_through_to_host(tmp_path, monkeypatch):
    from cilium_tpu_torch.models.base import ConstVerdict

    for mod_, name in ((port_r2d2, "build_r2d2_model"), (port_dns, "build_dns_model"),
                       (port_http, "build_http_model_for_port")):
        real = getattr(mod_, name)

        def audited(*args, _real=real, **kwargs):
            m = _real(*args, **kwargs)
            return m if isinstance(m, ConstVerdict) else _Audited(m)

        monkeypatch.setattr(mod_, name, audited)
    port_inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "audit.sock"), port_cfg()).start()
    c = SidecarClient(svc.socket_path, timeout=60.0)
    try:
        mod = open_with_policies(c, port_pl)
        for i, proto in enumerate(("r2d2", "dns", "http")):
            rounds = TRAFFIC[proto](random.Random(f"audit-{proto}"))
            got = service_rounds(c, mod, proto, rounds, 70_000 + 10_000 * i)
            assert_rounds_equal(got, oracle_rounds(ref_inst, ref_pl, proto, rounds))
        audited = [e for e in svc._engines.values() if isinstance(e.model, _Audited)]
        assert len(audited) == 3
        assert svc.fast_log.requests > 0 and svc.status()["device"]["blob_chunks"] > 0
        cont = svc.status()["containment"]
        assert cont["refused_entries"] == {} and cont["readback_failures"] == 0
    finally:
        c.close()
        svc.stop()
        port_inst.reset_module_registry()


# --- containment: a failing or quarantined device is answered typed -----------

FIRST_FRAME = {
    "r2d2": b"READ /public/a.txt\r\n",
    "http": b"GET /public/a HTTP/1.1\r\nHost: svc.local\r\n\r\n",
    "dns": encode_dns_query("api.example.com"),
    "cassandra": _cass_query("SELECT * FROM public.t1"),
    "memcache": b"get user:1\r\n",
}


class _PlantedFault(RuntimeError):
    pass


class _Raising(_Audited):
    """A model whose every call raises, as a failed kernel launch does."""

    def __call__(self, *args):
        raise _PlantedFault("planted device fault")

    def verdicts_attr(self, *args):
        raise _PlantedFault("planted device fault")


def _plant_fault(eng):
    if eng.proto in ("r2d2", "dns"):
        eng.model = _Raising(eng.model)
    else:

        def judge(*args):
            raise _PlantedFault("planted device fault")

        eng._judge = judge


def _one_entry(c, conn_id, data):
    _, entries = c._on_data_rpc(conn_id, False, False, data)
    return [(int(r), [(int(o), int(n)) for o, n in ops]) for _, r, ops, _io, _ir in entries]


def _open(c, mod, proto, conn_id):
    res, _ = c.new_connection(mod, proto, conn_id, True, 1, 2, "1.1.1.1:1",
                              f"2.2.2.2:{PORTS[proto]}", NAMES[proto])
    assert res == int(FilterResult.OK)


@pytest.mark.parametrize("proto", ["r2d2", "http", "dns", "cassandra", "memcache"])
def test_failing_judge_answers_typed_errors(tmp_path, proto):
    """A judge or kernel launch that raises answers its entries with
    typed UNKNOWN_ERROR verdicts: none is judged on the host."""
    port_inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "fault.sock"), port_cfg()).start()
    c = SidecarClient(svc.socket_path, timeout=60.0)
    try:
        mod = open_with_policies(c, port_pl)
        _open(c, mod, proto, 4242)
        _plant_fault(svc._conns[4242].engine)
        got = _one_entry(c, 4242, FIRST_FRAME[proto])
        assert got and all(r == int(FilterResult.UNKNOWN_ERROR) and not ops for r, ops in got)
        st = svc.status()
        assert st["device"]["host_judged"] == 0 and st["device"]["device_judged"] == 0
        cont = st["containment"]
        assert cont["batch_crashes"] + cont["error_entries"] >= 1
        assert cont["refused_entries"] == {}
    finally:
        c.close()
        svc.stop()
        port_inst.reset_module_registry()


def _failing_probe():
    raise _PlantedFault("device still out")


def test_quarantine_refuses_device_entries_typed(tmp_path):
    """While the guard holds the device out, every device-engine entry
    (a bound conn's, and a conn opened during the quarantine) is refused
    typed; once it heals they serve from the device again."""
    port_inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "quar.sock"), port_cfg()).start()
    c = SidecarClient(svc.socket_path, timeout=60.0)
    try:
        mod = open_with_policies(c, port_pl)
        _open(c, mod, "r2d2", 1)
        _open(c, mod, "http", 2)
        svc._device_probe = _failing_probe
        svc.guard.quarantine("planted")
        _open(c, mod, "r2d2", 3)  # opened during the quarantine: unbound
        assert svc._conns[3].engine is None and svc._conns[3].demoted_mod is not None
        for cid, proto in ((1, "r2d2"), (2, "http"), (3, "r2d2")):
            assert _one_entry(c, cid, FIRST_FRAME[proto]) == [
                (int(FilterResult.UNKNOWN_ERROR), [])]
        st = svc.status()
        assert st["containment"]["refused_entries"] == {"quarantine": 3}
        assert st["device"]["host_judged"] == 0
        svc.guard._heal()
        want = ref_oracle_ops([FIRST_FRAME["r2d2"]])[0][0]
        for cid in (1, 3):
            assert _one_entry(c, cid, FIRST_FRAME["r2d2"]) == [(int(FilterResult.OK), want)]
        assert svc._conns[3].engine is svc._conns[1].engine
        st = svc.status()
        assert st["containment"]["refused_entries"] == {"quarantine": 3}
        assert st["device"]["host_judged"] == 0
    finally:
        c.close()
        svc.stop()
        port_inst.reset_module_registry()


def test_readback_failure_is_counted_and_trips_the_guard(tmp_path, monkeypatch):
    """A device readback that raises denies its frames, is counted, and
    counts toward the guard's quarantine threshold."""
    port_inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "rb.sock"), port_cfg(device_fail_threshold=2)).start()
    c = SidecarClient(svc.socket_path, timeout=60.0)
    try:
        mod = open_with_policies(c, port_pl)
        _open(c, mod, "r2d2", 7)
        svc._device_probe = _failing_probe

        def broken(x):
            raise _PlantedFault("planted readback fault")

        monkeypatch.setattr(port_service_mod, "_to_host", broken)
        for _ in range(2):
            for res, ops in _one_entry(c, 7, FIRST_FRAME["r2d2"]):
                assert res == int(FilterResult.OK) and all(o != PASS for o, _ in ops)
        st = svc.status()
        assert st["containment"]["readback_failures"] >= 2
        assert st["containment"]["quarantined"] is True
    finally:
        c.close()
        svc.stop()
        port_inst.reset_module_registry()


# --- (g) the mesh rung on one CPU slot, and no silent CPU ---------------------------


def test_mesh_on_raises_typed(tmp_path):
    """``mesh="on"`` is accepted: on one CPU slot it resolves a 1 x 1
    mesh at rung "full"; "auto" (no two cards) and "off" resolve none,
    and the status surface is None then, as the reference's."""
    svc = VerdictService(str(tmp_path / "on.sock"), port_cfg(mesh="on"))
    try:
        assert svc._mesh_status() is None  # unresolved until the first build
        mesh = svc._resolve_mesh()
        assert mesh is not None and mesh.shape == {"flows": 1, "rules": 1}
        st = svc._mesh_status()
        assert st["rung"] == "full" and st["devices"] == 1 and st["active"] is True
    finally:
        svc.stop()
    for mode in ("auto", "off"):
        svc = VerdictService(str(tmp_path / f"{mode}.sock"), port_cfg(mesh=mode))
        try:
            assert svc._resolve_mesh() is None
            assert svc._mesh_status() is None
        finally:
            svc.stop()


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    """``verdict_device="default"`` is the card: with none, ``start()``
    raises instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = VerdictService(str(tmp_path / "nocard.sock"), DaemonConfig())
    try:
        with pytest.raises(RuntimeError, match="CUDA device"):
            svc.start()
    finally:
        svc.stop()


# --- (h) the shm transport ------------------------------------------------------


@pytest.mark.parametrize("make", [SidecarClient, RefSidecarClient], ids=["port", "ref"])
def test_shm_transport_round_trip(port_service, make):
    c = make(port_service.socket_path, timeout=60.0, transport="shm")
    try:
        mod = open_with_policies(c, port_pl)
        for proto in ("r2d2", "memcache"):
            rounds = TRAFFIC[proto](random.Random(f"shm-{proto}"))
            got = service_rounds(c, mod, proto, rounds, next(_BASES))
            assert_rounds_equal(got, oracle_rounds(ref_inst, ref_pl, proto, rounds))
        assert c.status()["transport"]["sessions"][0]["mode"] == "shm"
        assert c.transport_mode == "shm"
        # A shim round trip rides the rings too.
        res, shim = c.new_connection(mod, "r2d2", next(_BASES), True, 1, 2, "1.1.1.1:1",
                                     "2.2.2.2:80", R2D2)
        assert res == int(FilterResult.OK)
        assert shim.on_io(False, b"READ /public/a.txt\r\nREAD /private/x\r\n") == (
            int(FilterResult.OK), b"READ /public/a.txt\r\n")
        assert shim.on_io(True, b"SERVED\r\n") == (int(FilterResult.OK), b"ERROR\r\nSERVED\r\n")
        shim.close()
    finally:
        c.close()
