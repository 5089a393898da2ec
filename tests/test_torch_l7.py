"""The port's Cassandra and memcached slices, and the device-assisted
engines, at device="cpu" against the JAX package.

Same policies, same numpy batches, same byte streams: the port's
``cassandra_verdicts`` and ``memcache_verdicts`` (over tests/test_l7_models.py's
seeded corpora and its overflow cases), the converted models, the parser
copies driven through the port's ``Connection``, and the
``CassandraBatchEngine``, ``MemcacheBatchEngine`` and ``HttpSidecarEngine``
op and inject streams (tests/test_l7_engines.py's streams, fed to the
engines directly) must equal the JAX package's and the in-process oracle's
(tolerance 0: every output is bool or int).  The plain PyTorch versions
run here; the card's kernels K10 and K11 are held against them in
tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import random
import struct

import numpy as np
import pytest
import torch

from cilium_tpu.models import cassandra as ref_cass
from cilium_tpu.models import http as ref_http
from cilium_tpu.models import memcached as ref_mc
from cilium_tpu.ops.dfa import DeviceDfa as RefDfa
from cilium_tpu.proxylib import NetworkPolicy as RefNetworkPolicy
from cilium_tpu.proxylib import PortNetworkPolicy as RefPortNetworkPolicy
from cilium_tpu.proxylib import PortNetworkPolicyRule as RefPortNetworkPolicyRule
from cilium_tpu.proxylib.connection import Connection as RefConnection
from cilium_tpu.proxylib.connection import InjectBuf as RefInjectBuf
from cilium_tpu.proxylib.parser import get_parser_factory as ref_parser_factory
from cilium_tpu.proxylib.parsers.memcached import MemcacheMeta as RefMemcacheMeta
from cilium_tpu.proxylib.policy import compile_policy as ref_compile_policy
from cilium_tpu.runtime import l7engine as ref_l7
from cilium_tpu_torch.convert import (
    CASSANDRA_TABLES,
    MEMCACHE_TABLES,
    cassandra_model_from_numpy,
    memcache_model_from_numpy,
)
from cilium_tpu_torch.entry import (
    cassandra_batch,
    cassandra_bench_policy,
    cassandra_requests,
    memcache_batch,
    memcache_bench_policy,
    memcache_frames,
)
from cilium_tpu_torch.models.base import ConstVerdict
from cilium_tpu_torch.models.cassandra import (
    MAX_ACTION,
    build_cassandra_model,
    cassandra_hits,
    cassandra_verdicts,
    encode_cassandra_batch,
)
from cilium_tpu_torch.models.http import build_http_model_for_port
from cilium_tpu_torch.models.memcached import (
    TEXT_COMMANDS,
    build_memcache_model,
    encode_memcache_batch,
    memcache_hits,
    memcache_verdicts,
)
from cilium_tpu_torch.proxylib import (
    NetworkPolicy,
    PortNetworkPolicy,
    PortNetworkPolicyRule,
    compile_policy,
)
from cilium_tpu_torch.proxylib.connection import Connection, InjectBuf
from cilium_tpu_torch.proxylib.parser import get_parser_factory
from cilium_tpu_torch.proxylib.parsers.memcached import MemcacheMeta
from cilium_tpu_torch.proxylib.types import DROP, PASS
from cilium_tpu_torch.runtime.l7engine import (
    CassandraBatchEngine,
    HttpSidecarEngine,
    MemcacheBatchEngine,
)


@pytest.fixture(autouse=True, scope="module")
def _reference_rule_parsers():
    """tests/test_proxylib.py leaves a dummy HTTP rule parser in the
    reference's registry; these tests compile policies through the
    reference, so they put its real parsers back first."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.cassandra import cassandra_rule_parser
    from cilium_tpu.proxylib.parsers.dns import dns_rule_parser
    from cilium_tpu.proxylib.parsers.http import http_rule_parser
    from cilium_tpu.proxylib.parsers.memcached import memcache_rule_parser

    register_l7_rule_parser("dns", dns_rule_parser)
    register_l7_rule_parser("cassandra", cassandra_rule_parser)
    register_l7_rule_parser("memcache", memcache_rule_parser)
    register_l7_rule_parser("http", http_rule_parser)


def both_policies(port, rules, name="l7t"):
    """(reference, port) PolicyInstances of one NPDS policy: ``rules`` are
    PortNetworkPolicyRule keyword dicts on ``port``."""
    out = []
    for (np_, pnp, pnpr), compile_ in (
        ((RefNetworkPolicy, RefPortNetworkPolicy, RefPortNetworkPolicyRule), ref_compile_policy),
        ((NetworkPolicy, PortNetworkPolicy, PortNetworkPolicyRule), compile_policy),
    ):
        out.append(compile_(np_(
            name=name, policy=2,
            ingress_per_port_policies=[pnp(port=port, rules=[pnpr(**r) for r in rules])],
        )))
    return out


def _eq(port, ref, what=""):
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(ref)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), what


def _automaton_leaves(tab):
    if isinstance(tab, RefDfa):
        keys = ["cls_lo", "cls_hi", "delta_id", "start_1h", "accept_mask", "accept_final_mask"]
    else:
        keys = ["delta_flat", "classmap", "start", "accept_t", "accept_final_t"]
    return {k: np.asarray(getattr(tab, k)) for k in keys}


# --- Cassandra model -----------------------------------------------------------

# tests/test_l7_models.py:29-36, :39-62
ACTIONS = ["select", "insert", "update", "delete", "use", "create-table"]
TABLES = ["system.local", "ks1.users", "ks1.orders", "secret.creds", "public.data", "a.b"]
TABLE_PATTERNS = ["^system\\.", "^ks1\\.", "users", "^public\\.data$", ".*", "^a\\."]


def cass_rules(rng, n_rules):
    rules = []
    for _ in range(n_rules):
        kv = {}
        if rng.random() < 0.7:
            kv["query_action"] = rng.choice(ACTIONS)
        if rng.random() < 0.7:
            kv["query_table"] = rng.choice(TABLE_PATTERNS)
        rules.append(kv)
    remotes = sorted(rng.sample(range(1, 8), rng.randrange(0, 3)))
    return [dict(remote_policies=remotes, l7_proto="cassandra", l7_rules=rules)]


def cass_corpus(rng, n=128):
    """tests/test_l7_models.py:71-82's requests, plus tokens that overflow
    the fixed widths and actions longer than any needle."""
    reqs, paths, remotes = [], [], []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.15:
            op = rng.choice(["options", "startup", "register"])
            reqs.append((op, "", True))
            paths.append(f"/{op}")
        elif roll < 0.2:
            table = rng.choice(["ks1." + "x" * 100, "a." + "b" * 94])
            action = rng.choice(ACTIONS)
            reqs.append((action, table, False))
            paths.append(f"/query/{action}/{table}")
        else:
            action = rng.choice(ACTIONS + ["selectx", "sel"])
            table = rng.choice(TABLES + [""])
            reqs.append((action, table, False))
            paths.append(f"/query/{action}/{table}")
        remotes.append(rng.randrange(1, 8))
    return reqs, paths, np.asarray(remotes, np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_cassandra_verdicts_match_reference_and_oracle(seed):
    rng = random.Random(seed)
    ref_policy, policy = both_policies(9042, cass_rules(rng, rng.randrange(1, 4)))
    ref = ref_cass.build_cassandra_model(ref_policy, True, 9042)
    port = build_cassandra_model(policy, True, 9042, device="cpu")
    reqs, paths, remotes = cass_corpus(rng)
    expected = [policy.matches(True, 9042, int(r), p) for r, p in zip(remotes, paths)]
    assert expected == [ref_policy.matches(True, 9042, int(r), p) for r, p in zip(remotes, paths)]
    if isinstance(ref, ConstVerdict):
        assert port == ref
        return
    assert (port.nfa is None) == bool(np.asarray(ref.table_none).all())
    enc = encode_cassandra_batch(reqs)
    for g, w in zip(enc, ref_cass.encode_cassandra_batch(reqs)):
        _eq(g, w)
    data, alen, tlen, nq, overflow = enc
    got = cassandra_verdicts(port, data, alen, tlen, nq, remotes)
    _eq(got, ref_cass.cassandra_verdicts(ref, data, alen, tlen, nq, remotes))
    for i in range(len(reqs)):
        if not overflow[i]:
            assert bool(got[i]) == expected[i], (reqs[i], int(remotes[i]))


def test_cassandra_oversize_table_overflow_flagged():
    reqs = [("select", "x" * 200, False), ("select", "ks.t", False), ("a" * 33, "t", False)]
    enc = encode_cassandra_batch(reqs, f_pad=8)
    for g, w in zip(enc, ref_cass.encode_cassandra_batch(reqs, f_pad=8)):
        _eq(g, w)
    assert enc[-1].tolist() == [True, False, True]


def test_cassandra_hits_need_the_automaton_exactly_when_the_model_has_one():
    _, policy = both_policies(9042, [dict(l7_proto="cassandra", l7_rules=[{"query_action": "use"}])])
    port = build_cassandra_model(policy, True, 9042, device="cpu")
    assert port.nfa is None
    data, alen, tlen, nq, _ = encode_cassandra_batch([("use", "", False)])
    args = [torch.from_numpy(a) for a in (data, alen, tlen, nq)]
    rem = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="rx"):
        cassandra_hits(port, *args, torch.ones((1, 1), dtype=torch.bool), rem)
    assert cassandra_hits(port, *args, None, rem).tolist() == [True]
    with pytest.raises(ValueError, match="data"):
        cassandra_hits(port, args[0][:, :MAX_ACTION].contiguous(), *args[1:], None, rem)


@pytest.mark.parametrize("seed", [0, 3])
def test_converted_cassandra_model_gives_equal_verdicts(seed):
    rng = random.Random(seed)
    ref_policy, _ = both_policies(9042, cass_rules(rng, 3))
    ref = ref_cass.build_cassandra_model(ref_policy, True, 9042)
    leaves = {k: np.asarray(getattr(ref, k)) for k in CASSANDRA_TABLES}
    leaves["nfa"] = _automaton_leaves(ref.nfa)
    port = cassandra_model_from_numpy(leaves, device="cpu")
    reqs, _, remotes = cass_corpus(rng)
    data, alen, tlen, nq, _ = encode_cassandra_batch(reqs)
    _eq(port(data, alen, tlen, nq, remotes),
        ref_cass.cassandra_verdicts(ref, data, alen, tlen, nq, remotes))


def test_cassandra_bench_batch_matches_reference():
    """The entry's policy and batch are bench.py::bench_cassandra's."""
    reqs = cassandra_requests()
    assert len(reqs) == 1024
    ref_policy, _ = both_policies(9042, [dict(l7_proto="cassandra", l7_rules=[
        {"query_action": "select", "query_table": "^public\\."},
        {"query_action": "insert", "query_table": "^public\\."}])])
    ref = ref_cass.build_cassandra_model(ref_policy, True, 9042)
    port = build_cassandra_model(cassandra_bench_policy(), True, 9042, device="cpu")
    args = cassandra_batch(2048)
    got = cassandra_verdicts(port, *args)
    _eq(got, ref_cass.cassandra_verdicts(ref, *args))
    assert 0.1 < float(got.float().mean()) < 0.4


# --- memcached model -------------------------------------------------------------

# tests/test_l7_models.py:106-108, :111-138, :141
MC_COMMANDS = ["get", "set", "delete", "incr", "stats", "touch", "flush_all"]
MC_GROUPS = ["get", "set", "storage", "writeGroup", "delete", "stats", "touch"]
MC_KEYS = [b"user:1", b"user:2", b"admin:1", b"k42", b"x", b""]
BIN_OPCODES = [0, 1, 2, 4, 5, 16, 20, 28, 10, 11]


def mc_rules(rng, n_rules):
    rules = []
    for _ in range(n_rules):
        kv = {}
        if rng.random() < 0.85:
            kv["command"] = rng.choice(MC_GROUPS)
            mode = rng.randrange(4)
            if mode == 1:
                kv["keyExact"] = rng.choice(["user:1", "k42"])
            elif mode == 2:
                kv["keyPrefix"] = rng.choice(["user:", "k"])
            elif mode == 3:
                kv["keyRegex"] = rng.choice(["^user:[0-9]+$", "k[0-9]+", "^x"])
        rules.append(kv)
    remotes = sorted(rng.sample(range(1, 8), rng.randrange(0, 3)))
    return [dict(remote_policies=remotes, l7_proto="memcache", l7_rules=rules)]


def mc_corpus(rng, meta_cls, n=128):
    """tests/test_l7_models.py:150-162's frames, plus multi-key, oversized
    and unknown-command frames (overflow) and keys longer than a prefix."""
    frames, metas, remotes = [], [], []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.45:
            op = rng.choice(BIN_OPCODES)
            key = rng.choice(MC_KEYS + [b"user:12345"])
            frames.append((True, op, "", [key]))
            metas.append(meta_cls(opcode=op, keys=[key]))
        elif roll < 0.9:
            cmd = rng.choice(MC_COMMANDS)
            nkeys = 0 if cmd in ("stats", "flush_all") else 1
            keys = [rng.choice(MC_KEYS[:-1] + [b"k42x"]) for _ in range(nkeys)]
            frames.append((False, 0, cmd, keys))
            metas.append(meta_cls(command=cmd, keys=keys))
        else:
            kind = rng.randrange(3)
            if kind == 0:
                keys = [b"user:1", b"user:2"]
                frames.append((False, 0, "get", keys))
                metas.append(meta_cls(command="get", keys=keys))
            elif kind == 1:
                keys = [b"k" * 97]
                frames.append((False, 0, "get", keys))
                metas.append(meta_cls(command="get", keys=keys))
            else:
                frames.append((False, 0, "frobnicate", [b"k"]))
                metas.append(meta_cls(command="frobnicate", keys=[b"k"]))
        remotes.append(rng.randrange(1, 8))
    return frames, metas, np.asarray(remotes, np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_memcache_verdicts_match_reference_and_oracle(seed):
    rng = random.Random(100 + seed)
    ref_policy, policy = both_policies(11211, mc_rules(rng, rng.randrange(1, 4)))
    ref = ref_mc.build_memcache_model(ref_policy, True, 11211)
    port = build_memcache_model(policy, True, 11211, device="cpu")
    frames, metas, remotes = mc_corpus(random.Random(seed), MemcacheMeta)
    expected = [policy.matches(True, 11211, int(r), m) for r, m in zip(remotes, metas)]
    _, ref_metas, _ = mc_corpus(random.Random(seed), RefMemcacheMeta)
    assert expected == [ref_policy.matches(True, 11211, int(r), m) for r, m in zip(remotes, ref_metas)]
    if isinstance(ref, ConstVerdict):
        assert port == ref
        return
    enc = encode_memcache_batch(frames)
    for g, w in zip(enc, ref_mc.encode_memcache_batch(frames)):
        _eq(g, w)
    *arrays, overflow = enc
    got = memcache_verdicts(port, *arrays, remotes)
    _eq(got, ref_mc.memcache_verdicts(ref, *arrays, remotes))
    for i in range(len(frames)):
        if not overflow[i]:
            assert bool(got[i]) == expected[i], (frames[i], int(remotes[i]))


def test_memcache_multikey_overflow_flagged():
    frames = [(False, 0, "get", [b"a", b"b"]), (False, 0, "get", [b"a"]),
              (False, 0, "nope", [b"a"]), (True, 1, "", [b"k" * 97])]
    enc = encode_memcache_batch(frames, f_pad=8)
    for g, w in zip(enc, ref_mc.encode_memcache_batch(frames, f_pad=8)):
        _eq(g, w)
    assert enc[-1].tolist() == [True, False, True, True]


def test_memcache_each_key_mode_and_table_index_match_reference():
    """Every key mode against keys at and around each needle's length,
    and opcode / command ids outside their tables (negative ids count
    from the end, then clamp, as the reference's gather does)."""
    rules = [dict(remote_policies=[], l7_proto="memcache", l7_rules=[
        {"command": "get", "keyExact": "user:1"},
        {"command": "get", "keyPrefix": "user:"},
        {"command": "set", "keyRegex": "^sess:[0-9]+$"},
        {"command": "delete"},
        {"command": "verbosity"},
    ])]
    ref_policy, policy = both_policies(11211, rules)
    ref = ref_mc.build_memcache_model(ref_policy, True, 11211)
    port = build_memcache_model(policy, True, 11211, device="cpu")
    keys = [b"user:1", b"user:", b"user", b"user:12", b"sess:9", b"sess:x", b"", b"k" * 96]
    nc = len(TEXT_COMMANDS)
    rows = []
    for key in keys:
        for binary, op, cmd in ((True, 0, 0), (True, 1, 0), (True, 4, 0), (True, 27, 0),
                                (False, 0, TEXT_COMMANDS.index("get")),
                                (False, 0, TEXT_COMMANDS.index("set")),
                                (True, -1, 0), (True, -256, 0), (True, -300, 0),
                                (True, 256, 0), (True, 1000, 0),
                                (False, 0, -1), (False, 0, nc), (False, 0, -nc - 5)):
            for has_key in (True, False):
                rows.append((key, binary, op, cmd, has_key))
    f = len(rows)
    key_data = np.zeros((f, 96), np.uint8)
    key_len = np.zeros(f, np.int32)
    has_key = np.zeros(f, bool)
    is_binary = np.zeros(f, bool)
    opcode = np.zeros(f, np.int32)
    cmd_id = np.zeros(f, np.int32)
    for i, (key, binary, op, cmd, hk) in enumerate(rows):
        key_data[i, : len(key)] = np.frombuffer(key, np.uint8)
        key_len[i], has_key[i], is_binary[i], opcode[i], cmd_id[i] = len(key), hk, binary, op, cmd
    remotes = np.ones(f, np.int32)
    args = (key_data, key_len, has_key, is_binary, opcode, cmd_id, remotes)
    got = memcache_verdicts(port, *args)
    _eq(got, ref_mc.memcache_verdicts(ref, *args))
    assert 0 < int(got.sum()) < f


def test_memcache_hits_need_the_automaton_exactly_when_the_model_has_one():
    _, policy = both_policies(11211, [dict(l7_proto="memcache", l7_rules=[
        {"command": "get", "keyPrefix": "user:"}])])
    port = build_memcache_model(policy, True, 11211, device="cpu")
    assert port.nfa is None
    *arrays, _ = encode_memcache_batch([(False, 0, "get", [b"user:1"])])
    args = [torch.from_numpy(a) for a in arrays]
    rem = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="rx"):
        memcache_hits(port, *args, torch.ones((1, 1), dtype=torch.bool), rem)
    assert memcache_hits(port, *args, None, rem).tolist() == [True]


@pytest.mark.parametrize("seed", [1, 4])
def test_converted_memcache_model_gives_equal_verdicts(seed):
    rng = random.Random(seed)
    ref_policy, _ = both_policies(11211, mc_rules(rng, 3))
    ref = ref_mc.build_memcache_model(ref_policy, True, 11211)
    if isinstance(ref, ConstVerdict):
        pytest.fail("the seed must give a device model")
    leaves = {k: np.asarray(getattr(ref, k)) for k in MEMCACHE_TABLES}
    leaves["nfa"] = _automaton_leaves(ref.nfa)
    port = memcache_model_from_numpy(leaves, device="cpu")
    frames, _, remotes = mc_corpus(rng, MemcacheMeta)
    *arrays, _ = encode_memcache_batch(frames)
    _eq(port(*arrays, remotes), ref_mc.memcache_verdicts(ref, *arrays, remotes))


def test_memcache_bench_batch_matches_reference():
    """The entry's policy and batch are bench.py::bench_memcached's."""
    assert len(memcache_frames()) == 1024
    ref_policy, _ = both_policies(11211, [dict(l7_proto="memcache", l7_rules=[
        {"command": "get", "keyPrefix": "user:"},
        {"command": "set", "keyRegex": "^sess:[0-9]+$"},
        {"command": "delete", "keyExact": "the-key"}])])
    ref = ref_mc.build_memcache_model(ref_policy, True, 11211)
    port = build_memcache_model(memcache_bench_policy(), True, 11211, device="cpu")
    args = memcache_batch(2048)
    got = memcache_verdicts(port, *args)
    _eq(got, ref_mc.memcache_verdicts(ref, *args))
    assert 0.5 < float(got.float().mean()) < 0.8


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_cassandra_model(cassandra_bench_policy(), True, 9042)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_memcache_model(memcache_bench_policy(), True, 11211)


# --- the parser copies, through each package's Connection ------------------------


class _Instance:
    """The instance side a Connection calls back into: the policy match
    (the host oracle) and the access log."""

    def __init__(self, policy):
        self.policy = policy
        self.entries = []

    def policy_matches_at(self, name, ingress, port, remote, l7):
        return self.policy.matches_at(ingress, port, remote, l7)

    def policy_matches(self, name, ingress, port, remote, l7):
        return self.policy.matches(ingress, port, remote, l7)

    def log(self, entry):
        self.entries.append(entry)


def conn_stream(ref, policy, proto, port, msgs, remote=1):
    """[(reply, bytes)] through a streaming parser on a Connection, as the
    in-process proxylib drives it: per message (ops, inject_reply,
    last_rule_id), then the access log.  ``ref`` picks the package."""
    conn_cls, buf_cls, factory = (
        (RefConnection, RefInjectBuf, ref_parser_factory) if ref
        else (Connection, InjectBuf, get_parser_factory)
    )
    inst = _Instance(policy)
    conn = conn_cls(instance=inst, conn_id=1, ingress=True, src_id=remote, dst_id=2,
                    src_addr="1.1.1.1:1", dst_addr=f"2.2.2.2:{port}", policy_name="l7t",
                    port=port, parser_name=proto, orig_buf=buf_cls(4096),
                    reply_buf=buf_cls(4096))
    conn.parser = factory(proto).create(conn)
    out = []
    bufs = {False: b"", True: b""}
    skip = {False: 0, True: 0}
    for reply, m in msgs:
        if skip[reply]:
            take = min(skip[reply], len(m))
            skip[reply] -= take
            m = m[take:]
        bufs[reply] += m
        ops = []
        res = conn.on_data(reply, False, [bufs[reply]], ops)
        consumed = 0
        for op, n in ops:
            if op in (PASS, DROP):
                take = min(n, len(bufs[reply]) - consumed)
                consumed += take
                skip[reply] += n - take
        bufs[reply] = bufs[reply][consumed:]
        out.append(([(int(o), int(n)) for o, n in ops], int(res), conn.reply_buf.take(),
                    conn.last_rule_id))
    keys = ("entry_type", "proto", "fields")
    return out, [tuple(getattr(e, k) for k in keys) for e in inst.entries]


def cass_frame(opcode, body=b"", version=4, stream=0):
    return bytes([version, 0]) + struct.pack(">HB", stream, opcode) + struct.pack(">I", len(body)) + body


def cass_query(cql, stream=0, opcode=0x07):
    """tests/test_l7_engines.py:88-94 (and tests/test_cassandra.py:77-81)."""
    q = cql.encode()
    return cass_frame(opcode, struct.pack(">I", len(q)) + q + b"\x00\x01\x00", stream=stream)


def cass_execute(prepared_id, stream=0):
    return cass_frame(0x0A, struct.pack(">H", len(prepared_id)) + prepared_id + b"\x00\x01\x00",
                      stream=stream)


def cass_prepared(prepared_id, stream=0):
    body = struct.pack(">I", 4) + struct.pack(">H", len(prepared_id)) + prepared_id
    return cass_frame(0x08, body, version=0x84, stream=stream)


def cass_batch(entries, stream=0):
    body = b"\x00" + struct.pack(">H", len(entries))
    for e in entries:
        if isinstance(e, str):
            q = e.encode()
            body += b"\x00" + struct.pack(">I", len(q)) + q
        else:
            body += b"\x01" + struct.pack(">H", len(e)) + e
    return cass_frame(0x0D, body + b"\x00\x01", stream=stream)


def bin_req(opcode, key=b"", extras=b"", value=b"", magic=0x80):
    """tests/test_memcached.py:67-80."""
    body = extras + key + value
    return (bytes([magic, opcode]) + struct.pack(">H", len(key)) + bytes([len(extras), 0])
            + b"\x00\x00" + struct.pack(">I", len(body)) + b"\x00" * 12 + body)


CASS_RULES = [dict(l7_proto="cassandra", l7_rules=[
    {"query_action": "select", "query_table": "^public\\."},
    {"query_action": "use"},
    {"query_action": "insert", "query_table": "^ks\\."},
    {"query_table": "^ks\\."},
])]
CASS_STREAMS = {
    "allow-deny-use": [
        (False, cass_query("SELECT * FROM public.users")),
        (False, cass_query("SELECT * FROM secret.creds", stream=3)),
        (False, cass_query("USE public")),
        (False, cass_query("SELECT * FROM t1")),
        (False, cass_query("INSERT INTO public.x (a) VALUES (1)")),
    ],
    "partial": [(False, b"\x04\x00"), (False, cass_query("SELECT * FROM ks.t1")[2:12]),
                (False, cass_query("SELECT * FROM ks.t1")[12:])],
    "non-query": [(False, cass_frame(0x05)), (False, cass_frame(0x01, b"\x00\x00"))],
    "comment": [(False, cass_query("SELECT * FROM t -- sneaky"))],
    "prepare-execute": [
        (False, cass_query("SELECT * FROM ks.t1", opcode=0x09, stream=3)),
        (True, cass_prepared(b"\x00\x01", stream=3)),
        (False, cass_execute(b"\x00\x01", stream=4)),
        (False, cass_query("SELECT * FROM other.t1", opcode=0x09, stream=5)),
    ],
    "unknown-id": [(False, cass_execute(b"\x00\x09", stream=5))],
    "batch": [
        (False, cass_batch(["INSERT INTO ks.a (x) VALUES (1)", "INSERT INTO ks.b (x) VALUES (2)"])),
        (False, cass_batch(["INSERT INTO ks.a (x) VALUES (1)", "INSERT INTO evil.b (x) VALUES (2)"])),
        (False, cass_query("INSERT INTO ks.a (x) VALUES (1)", opcode=0x09, stream=1)),
        (True, cass_prepared(b"\x11", stream=1)),
        (False, cass_batch([b"\x11", "INSERT INTO ks.c (x) VALUES (3)"])),
    ],
    "long-table": [(False, cass_query("SELECT * FROM public." + "t" * 120)),
                   (False, cass_query("SELECT * FROM ks." + "u" * 120))],
}
MC_RULES = [dict(l7_proto="memcache", l7_rules=[
    {"command": "get", "keyPrefix": "user:"},
    {"command": "set"},
    {"command": "get", "keyRegex": "^k[0-9]+$"},
    {"command": "delete", "keyExact": "the-key"},
    {"command": "stats"},
])]
MC_STREAMS = {
    "text": [
        (False, b"get user:1\r\n"),
        (False, b"get admin:1\r\n"),
        (False, b"set anything 0 0 2\r\nhi\r\n"),
        (True, b"VALUE user:1 0 1\r\nx\r\nEND\r\n"),
        (True, b"STORED\r\n"),
    ],
    "text-more": [
        (False, b"get user:1 user:2\r\n"), (False, b"get user:1 other:2\r\n"),
        (False, b"get k42\r\n"), (False, b"get k42x\r\n"),
        (False, b"delete the-key\r\n"), (False, b"delete thekey\r\n"),
        (False, b"set k 0 0 2 noreply\r\nhi\r\n"), (False, b"get us"), (False, b"er:9\r"),
        (False, b"\n"), (False, b"stats\r\n"), (True, b"VALUE user:1 0 1\r\nx\r\nEND\r\n"),
        (True, b"STAT pid 1\r\n"), (True, b"STAT pid 1\r\nEND\r\n"),
    ],
    "text-unknown": [(False, b"frobnicate k\r\n")],
    "binary": [
        (False, bin_req(0x00, key=b"user:9")),
        (False, bin_req(0x00, key=b"nope")),
        (False, bin_req(0x01, key=b"k", extras=b"\x00" * 8, value=b"v")),
        (False, bin_req(0x04, key=b"the-key")),
        (False, bin_req(0x04, key=b"k")[:10]),
        (False, bin_req(0x04, key=b"k")[10:]),
        (True, bin_req(0x00, value=b"x", magic=0x81)),
    ],
    "binary-bad-reply": [(False, bin_req(0x00, key=b"user:1")), (True, b"\x00" * 24)],
}


@pytest.mark.parametrize("name", sorted(CASS_STREAMS))
def test_cassandra_parser_copy_matches_reference(name):
    ref_policy, policy = both_policies(9042, CASS_RULES)
    got = conn_stream(False, policy, "cassandra", 9042, CASS_STREAMS[name])
    want = conn_stream(True, ref_policy, "cassandra", 9042, CASS_STREAMS[name])
    assert got == want


@pytest.mark.parametrize("name", sorted(MC_STREAMS))
def test_memcache_parser_copy_matches_reference(name):
    ref_policy, policy = both_policies(11211, MC_RULES)
    got = conn_stream(False, policy, "memcache", 11211, MC_STREAMS[name])
    want = conn_stream(True, ref_policy, "memcache", 11211, MC_STREAMS[name])
    assert got == want


# --- the engines ---------------------------------------------------------------


def engine_stream(eng, msgs, fid=7, remote=1):
    """[(reply, bytes)] fed to an engine one message at a time, pumped
    after each: per message (ops, inject_reply, last_rule_id)."""
    out = []
    for reply, m in msgs:
        eng.feed(fid, m, reply=reply, remote_id=remote)
        eng.pump()
        ops, _, inj = eng.take_ops(fid, reply)
        out.append(([(int(o), int(n)) for o, n in ops], inj, eng.flows[fid].conn.last_rule_id))
    return out


def _oracle(stream):
    return [(ops, inj, rule) for ops, _, inj, rule in stream]


def engines(kind, policies, attr_enabled=True):
    ref_policy, policy = policies
    if kind == "cassandra":
        ref_model = ref_cass.build_cassandra_model(ref_policy, True, 9042)
        model = build_cassandra_model(policy, True, 9042, device="cpu")
        return (ref_l7.CassandraBatchEngine(ref_policy, True, 9042, ref_model),
                CassandraBatchEngine(policy, True, 9042, model))
    if kind == "memcache":
        ref_model = ref_mc.build_memcache_model(ref_policy, True, 11211)
        model = build_memcache_model(policy, True, 11211, device="cpu")
        return (ref_l7.MemcacheBatchEngine(ref_policy, True, 11211, ref_model),
                MemcacheBatchEngine(policy, True, 11211, model))
    ref_model = ref_http.build_http_model_for_port(ref_policy, True, 80)
    model = build_http_model_for_port(policy, True, 80, device="cpu")
    return (ref_l7.HttpSidecarEngine(ref_policy, True, 80, ref_model, attr_enabled=attr_enabled),
            HttpSidecarEngine(policy, True, 80, model, attr_enabled=attr_enabled))


def chunked(raw, seed, most):
    rng = random.Random(seed)
    msgs, i = [], 0
    while i < len(raw):
        n = rng.randrange(1, most)
        msgs.append((False, raw[i : i + n]))
        i += n
    return msgs


def _assert_engines_agree(kind, policies, msgs, port_name, remote=1, attr_enabled=True):
    ref_eng, eng = engines(kind, policies, attr_enabled)
    got = engine_stream(eng, msgs, remote=remote)
    want = engine_stream(ref_eng, msgs, remote=remote)
    assert got == want
    assert (eng.device_judged, eng.host_judged) == (ref_eng.device_judged, ref_eng.host_judged)
    ref_policy, policy = policies
    oracle, _ = conn_stream(False, policy, kind, port_name, msgs, remote=remote)
    ref_oracle, _ = conn_stream(True, ref_policy, kind, port_name, msgs, remote=remote)
    assert _oracle(oracle) == _oracle(ref_oracle)
    assert [(o, i) for o, i, _ in got] == [(o, i) for o, i, _ in _oracle(oracle)]
    return eng


@pytest.mark.parametrize("name", sorted(CASS_STREAMS))
def test_cassandra_engine_matches_reference_and_oracle(name):
    eng = _assert_engines_agree("cassandra", both_policies(9042, CASS_RULES), CASS_STREAMS[name], 9042)
    if name == "long-table":
        assert eng.host_judged == 2  # the table overflows MAX_TABLE: the oracle's frames


@pytest.mark.parametrize("name", sorted(MC_STREAMS))
def test_memcache_engine_matches_reference_and_oracle(name):
    eng = _assert_engines_agree("memcache", both_policies(11211, MC_RULES), MC_STREAMS[name], 11211)
    if name == "text":
        assert eng.device_judged >= 3


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_memcache_engine_chunked_fuzz(seed):
    """tests/test_l7_engines.py::test_memcache_fuzz_chunked's stream."""
    raw = b"".join([
        b"get user:1\r\n", b"get admin:1\r\n", b"set k 0 0 4\r\nabcd\r\n",
        b"get user:2 user:3\r\n",  # multi-key -> the oracle judges it
        b"delete user:1\r\n", b"get user:4\r\n",
    ])
    eng = _assert_engines_agree("memcache", both_policies(11211, MC_RULES), chunked(raw, seed, 16), 11211)
    assert eng.host_judged >= 1


@pytest.mark.parametrize("seed", [11, 12])
def test_cassandra_engine_chunked_fuzz(seed):
    """tests/test_l7_engines.py::test_cassandra_fuzz_chunked's stream."""
    raw = b"".join([
        cass_query("SELECT * FROM public.users"), cass_query("SELECT * FROM secret.x"),
        cass_query("USE public"), cass_query("SELECT * FROM y"),
        cass_query("UPDATE public.z SET a=1"),
    ])
    _assert_engines_agree("cassandra", both_policies(9042, CASS_RULES), chunked(raw, seed, 24), 9042)


def test_engines_with_remote_sets_and_const_policies_match_reference():
    cass = [dict(remote_policies=[2], l7_proto="cassandra", l7_rules=[{"query_action": "select"}])]
    for remote in (1, 2):
        _assert_engines_agree("cassandra", both_policies(9042, cass), CASS_STREAMS["allow-deny-use"],
                              9042, remote=remote)
    const = [dict(remote_policies=[1])]
    for kind, port, streams in (("cassandra", 9042, CASS_STREAMS), ("memcache", 11211, MC_STREAMS)):
        policies = both_policies(port, [dict(l7_proto=kind, **const[0])])
        ref_eng, eng = engines(kind, policies)
        assert isinstance(eng.model, ConstVerdict)
        msgs = streams["allow-deny-use" if kind == "cassandra" else "text"]
        assert engine_stream(eng, msgs) == engine_stream(ref_eng, msgs)


HTTP_RULES = [
    dict(http_rules=[{"method": "GET", "path": "/public/.*"}]),
    dict(remote_policies=[2], http_rules=[{"method": "POST", "path": "/api/[0-9]+"}]),
    dict(remote_policies=[3]),
]


def http_req(method, path, body=b"", headers=""):
    extra = f"Content-Length: {len(body)}\r\n" if body else ""
    return f"{method} {path} HTTP/1.1\r\nHost: x\r\n{headers}{extra}\r\n".encode() + body


HTTP_STREAM = [
    (False, http_req("GET", "/public/a")),
    (False, http_req("GET", "/private/a")),
    (False, http_req("POST", "/api/12", body=b"abcd")),
    (False, http_req("GET", "/public/b")[:20]),
    (False, http_req("GET", "/public/b")[20:] + http_req("PUT", "/x")),
    (False, b"GET /public/x\r\n\r\n"),  # two tokens: the oracle denies, no device verdict
    (False, http_req("GET", "/public/c", headers="X-Pad: " + "p" * 700 + "\r\n")),
    (True, b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n"),
]


@pytest.mark.parametrize("remote", [1, 2, 3])
@pytest.mark.parametrize("attr_enabled", [True, False])
def test_http_sidecar_engine_matches_reference_and_oracle(remote, attr_enabled):
    _assert_engines_agree("http", both_policies(80, HTTP_RULES), HTTP_STREAM, 80,
                          remote=remote, attr_enabled=attr_enabled)


@pytest.mark.parametrize("seed", [1, 2])
def test_http_sidecar_engine_chunked_fuzz(seed):
    raw = b"".join(m for reply, m in HTTP_STREAM if not reply and m.count(b" ") > 1)
    _assert_engines_agree("http", both_policies(80, HTTP_RULES), chunked(raw, seed, 40), 80, remote=2)


def test_http_sidecar_engine_cache_tier_matches_reference():
    """With the verdict-cache tier on, remote 3's byte-free row answers
    from the claim (no device row), as the reference's does."""
    ref_eng, eng = engines("http", both_policies(80, HTTP_RULES))
    for e in (ref_eng, eng):
        e.cache_enabled = True
    for remote in (1, 3):
        assert eng.verdict_invariant(remote) == ref_eng.verdict_invariant(remote)
    msgs = HTTP_STREAM[:3]
    assert engine_stream(eng, msgs, remote=3) == engine_stream(ref_eng, msgs, remote=3)
    assert (eng.device_judged, eng.host_judged) == (ref_eng.device_judged, ref_eng.host_judged)


@pytest.mark.parametrize("kind", ["cassandra", "memcache", "http"])
def test_a_judge_that_raises_propagates_out_of_pump(kind, monkeypatch):
    """The port keeps no host fallback for a failing device judge: the
    exception leaves pump(), no frame is host-judged and no op is emitted."""
    port = {"cassandra": 9042, "memcache": 11211, "http": 80}[kind]
    rules = {"cassandra": CASS_RULES, "memcache": MC_RULES, "http": HTTP_RULES}[kind]
    msg = {"cassandra": CASS_STREAMS["allow-deny-use"][0][1], "memcache": b"get user:1\r\n",
           "http": http_req("GET", "/public/a")}[kind]
    _, eng = engines(kind, both_policies(port, rules))

    class Broken(Exception):
        pass

    def boom(*args, **kwargs):
        raise Broken()

    monkeypatch.setattr(eng, "_judge", boom)
    eng.feed(1, msg, remote_id=1)
    with pytest.raises(Broken):
        eng.pump()
    assert eng.host_judged == 0 and eng.flows[1].ops[False] == []


@pytest.mark.parametrize("kind", ["cassandra", "memcache", "http"])
def test_a_failing_kernel_propagates_with_no_fallback(kind, monkeypatch):
    """A wrapper that takes the kernel route and cannot launch raises: it
    does not run its plain version, and the engine does not hand the
    frame to the host oracle."""
    from cilium_tpu_torch import kernels

    port = {"cassandra": 9042, "memcache": 11211, "http": 80}[kind]
    rules = {"cassandra": CASS_RULES, "memcache": MC_RULES, "http": HTTP_RULES}[kind]
    msg = {"cassandra": CASS_STREAMS["allow-deny-use"][0][1], "memcache": b"get user:1\r\n",
           "http": http_req("GET", "/public/a")}[kind]
    _, eng = engines(kind, both_policies(port, rules))

    def no_library(stem):
        raise RuntimeError(f"{stem}: no kernel library")

    monkeypatch.setattr(kernels, "on_cpu", lambda device: False)
    monkeypatch.setattr(kernels, "library", no_library)
    eng.feed(1, msg, remote_id=1)
    with pytest.raises(RuntimeError, match="no kernel library"):
        eng.pump()
    assert eng.host_judged == 0 and eng.flows[1].ops[False] == []
