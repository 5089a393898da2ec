"""Port entry points: the r2d2 verdict step on the card, and the HTTP,
DNS, Cassandra and memcached verdict passes' policies and batches.

``bench_policy``, ``batch`` and ``entry`` are the counterparts of
``__graft_entry__._bench_policy``, ``_batch`` and ``entry()``
(``__graft_entry__.py:6-72``); ``http_bench_policy`` and ``http_batch``
are the port's copy of ``bench.py::bench_http``'s setup
(``bench.py:211-240``), and the ``dns_*``, ``cassandra_*`` and
``memcache_*`` pairs of ``bench_dns`` (``bench.py:566-615``),
``bench_cassandra`` (``:366-401``) and ``bench_memcached``
(``:447-501``), all built through NPDS.  ``datapath_bench_maps`` and
``datapath_batch`` are ``bench_datapath``'s maps and packet mix
(``bench.py:1417-1490``).  ``kafka_bench_rules``, ``kafka_requests`` and
``kafka_batch`` are ``bench_kafka``'s rules and requests
(``bench.py:272-301``); ``seqdfa_tables`` and ``seqdfa_batch`` are a
long-frame search at the HTTP engine's ``MAX_WIDTH`` over
tests/test_seqdfa.py's patterns.  ``dryrun_multichip`` is the
counterpart of ``__graft_entry__.dryrun_multichip`` on a mesh of virtual
slots; ``mesh_bench_policy`` / ``mesh_bench_batch`` and
``rules_100k_rows`` / ``rules_100k_batch`` are ``bench_multichip_scaling``'s
and ``bench_rules_100k``'s inputs (``bench.py:3072-3120,3184-3225``).
``policy_identities``, ``policy_rules``, ``policy_destination``,
``policy_http_requests`` and ``policy_kafka_frames`` are the policy
slice's configuration: tests/test_policygen.py's universe and random
rules (after Cilium's test/helpers/policygen) widened to 512 identities
and L7 sections, in the reference's JSON rule schema so the same
document loads into either package (``policy.rules_from_json``).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .device import resolve_device
from .kafka.request import RequestMessage
from .models.kafka import KafkaRequestBatch, encode_requests
from .policy.api import PortRuleKafka
from .regex.dfa import DfaTables, compile_pattern_dfas
from .runtime.engines import HttpBatchEngine
from .models.cassandra import encode_cassandra_batch
from .models.memcached import encode_memcache_batch
from .models.r2d2 import build_r2d2_model, r2d2_verdicts
from .proxylib.parsers.dns import encode_dns_query
from .proxylib import (
    NetworkPolicy,
    PolicyInstance,
    PortNetworkPolicy,
    PortNetworkPolicyRule,
    compile_policy,
)


def bench_policy() -> PolicyInstance:
    """The graft r2d2 policy: port 80 allows ``READ /public/.*`` and
    ``HALT``."""
    return compile_policy(
        NetworkPolicy(
            name="graft",
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
    )


def batch(f: int, l: int = 64):
    """(data [f, l] uint8, lengths [f] int32, remotes [f] int32) numpy
    arrays cycling the graft's four messages."""
    msgs = [b"READ /public/a.txt\r\n", b"WRITE /x\r\n", b"HALT\r\n", b"READ /private/b\r\n"]
    data = np.zeros((f, l), dtype=np.uint8)
    lengths = np.zeros((f,), dtype=np.int32)
    for i in range(f):
        m = msgs[i % len(msgs)]
        data[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        lengths[i] = len(m)
    remotes = np.ones((f,), dtype=np.int32)
    return data, lengths, remotes


def entry(device=None):
    """(fn, args): the forward step of the flagship model — the r2d2 L7
    verdict pipeline (frame -> tokenize -> automaton -> verdict) — with
    its example batch as tensors on ``device`` (None: the CUDA card,
    raising when there is none)."""
    device = resolve_device(device)
    model = build_r2d2_model(bench_policy(), ingress=True, port=80, device=device)
    args = tuple(torch.from_numpy(a).to(device) for a in batch(256))

    def fn(data, lengths, remotes):
        return r2d2_verdicts(model, data, lengths, remotes)

    return fn, args


def http_bench_policy() -> PolicyInstance:
    """The graft HTTP policy: port 80 allows ``GET /public/.*`` from any
    remote (``bench.py:211-214``)."""
    return compile_policy(
        NetworkPolicy(
            name="http-graft",
            policy=2,
            ingress_per_port_policies=[
                PortNetworkPolicy(
                    port=80,
                    rules=[
                        PortNetworkPolicyRule(
                            http_rules=[{"method": "GET", "path": "/public/.*"}],
                        )
                    ],
                )
            ],
        )
    )


def http_requests(n: int = 1024) -> list[bytes]:
    """``bench.py:216-228``'s request mix from ``random.Random(11)``: half
    under /public/, a fifth POST, each with Host and User-Agent headers."""
    rng = random.Random(11)
    reqs = []
    for _ in range(n):
        roll = rng.random()
        path = (
            f"/public/a{rng.randrange(1000)}" if roll < 0.5
            else f"/private/b{rng.randrange(1000)}"
        )
        method = "GET" if rng.random() < 0.8 else "POST"
        reqs.append(
            f"{method} {path} HTTP/1.1\r\nHost: svc.local\r\n"
            f"User-Agent: bench\r\n\r\n".encode()
        )
    return reqs


def http_batch(f: int, l: int = 512):
    """(data [f, l] uint8, lengths [f] int32, remotes [f] int32) numpy
    arrays cycling ``http_requests()`` (``bench.py:233-240``)."""
    reqs = http_requests()
    data = np.zeros((f, l), np.uint8)
    lengths = np.zeros((f,), np.int32)
    for i in range(f):
        r = reqs[i % len(reqs)][:l]
        data[i, : len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    remotes = np.ones((f,), np.int32)
    return data, lengths, remotes


def _l7_policy(port: int, l7_proto: str, l7_rules: list) -> PolicyInstance:
    """One NPDS policy named "bench" whose ingress ``port`` allows
    ``l7_rules`` of ``l7_proto`` from any remote."""
    return compile_policy(
        NetworkPolicy(
            name="bench",
            policy=2,
            ingress_per_port_policies=[
                PortNetworkPolicy(
                    port=port,
                    rules=[PortNetworkPolicyRule(l7_proto=l7_proto, l7_rules=l7_rules)],
                )
            ],
        )
    )


def dns_bench_policy() -> PolicyInstance:
    """``bench_dns``'s policy: port 53 allows ``api.example.com``,
    ``*.svc.cluster.local`` and ``^cdn[0-9]+[.]edge[.]net$``
    (``bench.py:566-586``)."""
    return _l7_policy(53, "dns", [
        {"matchName": "api.example.com"},
        {"matchPattern": "*.svc.cluster.local"},
        {"matchRegex": "^cdn[0-9]+[.]edge[.]net$"},
    ])


def dns_queries(n: int = 1024) -> list[bytes]:
    """``bench.py:589-605``'s query frames from ``random.Random(13)``: 30%
    api.example.com, 25% pod*.svc.cluster.local, 15% cdn*.edge.net, 30%
    evil*.test."""
    rng = random.Random(13)
    msgs = []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.3:
            msgs.append(encode_dns_query("api.example.com"))
        elif roll < 0.55:
            msgs.append(encode_dns_query(f"pod{rng.randrange(1000)}.svc.cluster.local"))
        elif roll < 0.7:
            msgs.append(encode_dns_query(f"cdn{rng.randrange(100)}.edge.net"))
        else:
            msgs.append(encode_dns_query(f"evil{rng.randrange(1000)}.test"))
    return msgs


def dns_batch(f: int, l: int = 64):
    """(data [f, l] uint8, lengths [f] int32, remotes [f] int32) numpy
    arrays cycling ``dns_queries()`` (``bench.py:607-614``)."""
    msgs = dns_queries()
    data = np.zeros((f, l), np.uint8)
    lengths = np.zeros((f,), np.int32)
    for i in range(f):
        m = msgs[i % len(msgs)][:l]
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = len(m)
    return data, lengths, np.ones((f,), np.int32)


def cassandra_bench_policy() -> PolicyInstance:
    """``bench_cassandra``'s policy: port 9042 allows ``select`` and
    ``insert`` on tables matching ``^public\\.`` (``bench.py:366-386``)."""
    return _l7_policy(9042, "cassandra", [
        {"query_action": "select", "query_table": "^public\\."},
        {"query_action": "insert", "query_table": "^public\\."},
    ])


def cassandra_requests(n: int = 1024) -> list[tuple[str, str, bool]]:
    """``bench.py:389-394``'s (action, table, non_query) tuples from
    ``random.Random(17)``."""
    rng = random.Random(17)
    out = []
    for _ in range(n):
        action = rng.choice(["select", "insert", "update", "delete"])
        ks = "public" if rng.random() < 0.5 else "secret"
        out.append((action, f"{ks}.t{rng.randrange(40)}", False))
    return out


def cassandra_batch(f: int):
    """``encode_cassandra_batch`` of ``cassandra_requests()`` cycled to
    ``f`` rows, plus remotes: (data [f, 128] uint8, action_len, table_len,
    non_query, remotes) numpy arrays (``bench.py:396-400``)."""
    reqs = cassandra_requests()
    data, alen, tlen, nq, overflow = encode_cassandra_batch(
        [reqs[i % len(reqs)] for i in range(f)]
    )
    assert not overflow.any()
    return data, alen, tlen, nq, np.ones((f,), np.int32)


def memcache_bench_policy() -> PolicyInstance:
    """``bench_memcached``'s policy: port 11211 allows ``get`` with
    keyPrefix ``user:``, ``set`` with keyRegex ``^sess:[0-9]+$`` and
    ``delete`` with keyExact ``the-key`` (``bench.py:447-470``)."""
    return _l7_policy(11211, "memcache", [
        {"command": "get", "keyPrefix": "user:"},
        {"command": "set", "keyRegex": "^sess:[0-9]+$"},
        {"command": "delete", "keyExact": "the-key"},
    ])


def memcache_frames(n: int = 1024) -> list[tuple[bool, int, str, list[bytes]]]:
    """``bench.py:474-494``'s (is_binary, opcode, command, keys) frames
    from ``random.Random(23)``: text and binary, half allowed."""
    rng = random.Random(23)
    out = []
    for _ in range(n):
        kind = rng.randrange(6)
        if kind == 0:
            out.append((False, 0, "get", [b"user:%d" % rng.randrange(99)]))
        elif kind == 1:
            out.append((False, 0, "get", [b"admin:%d" % rng.randrange(99)]))
        elif kind == 2:
            out.append((False, 0, "set", [b"sess:%d" % rng.randrange(99)]))
        elif kind == 3:
            out.append((False, 0, "set", [b"sess:x%d" % rng.randrange(99)]))
        elif kind == 4:
            out.append((True, rng.choice([0, 9]), "", [b"user:%d" % rng.randrange(99)]))
        else:
            out.append((True, 1, "", [b"sess:%d" % rng.randrange(99)]))
    return out


def memcache_batch(f: int):
    """``encode_memcache_batch`` of ``memcache_frames()`` cycled to ``f``
    rows, plus remotes: (key_data [f, 96] uint8, key_len, has_key,
    is_binary, opcode, cmd_id, remotes) numpy arrays
    (``bench.py:496-500``)."""
    frames = memcache_frames()
    *arrays, overflow = encode_memcache_batch([frames[i % len(frames)] for i in range(f)])
    assert not overflow.any()
    return (*arrays, np.ones((f,), np.int32))


def kafka_bench_rules() -> list[PortRuleKafka]:
    """``bench_kafka``'s two sanitized rules: produce and consume on
    ``allowed-topic`` (``bench.py:281-285``)."""
    rules = []
    for role in ("produce", "consume"):
        r = PortRuleKafka(role=role, topic="allowed-topic")
        r.sanitize()
        rules.append(r)
    return rules


def kafka_requests(n: int = 1024) -> list[RequestMessage]:
    """``bench.py:288-299``'s parsed requests from ``random.Random(13)``:
    half on ``allowed-topic``, api keys 0-3, version 1, client "bench"."""
    rng = random.Random(13)
    reqs = []
    for _ in range(n):
        topic = "allowed-topic" if rng.random() < 0.5 else f"t{rng.randrange(50)}"
        api_key = rng.choice([0, 1, 2, 3])  # produce/fetch/offsets/metadata
        reqs.append(
            RequestMessage(
                api_key=api_key, api_version=1,
                correlation_id=rng.randrange(1 << 16),
                client_id="bench", topics=[topic], parsed=True,
            )
        )
    return reqs


def kafka_batch(f: int) -> tuple[KafkaRequestBatch, np.ndarray]:
    """(``encode_requests`` of ``kafka_requests()`` cycled to ``f`` rows,
    remotes [f] int32 of 1) (``bench.py:301-303``)."""
    reqs = kafka_requests()
    batch = encode_requests([reqs[i % len(reqs)] for i in range(f)])
    return batch, np.ones((f,), np.int32)


# tests/test_seqdfa.py's patterns: anchors, $, loops, bounded repeats.
SEQDFA_PATTERNS = (
    r"abc", r"^abc", r"abc$", r"a.*c", r"(ab|cd)+", r"[a-z0-9_]+",
    r"/public/.*", r"^(GET|HEAD)$", r"a{2,4}",
)


def seqdfa_tables() -> DfaTables:
    """The per-pattern DFA tables of ``SEQDFA_PATTERNS``."""
    return compile_pattern_dfas(list(SEQDFA_PATTERNS))


def seqdfa_batch(f: int, width: int = HttpBatchEngine.MAX_WIDTH, n_chunks: int = 1,
                 seed: int = 5):
    """(data [f, width] uint8, lengths [f] int32): long frames from
    tests/test_seqdfa.py's alphabet with near-matches planted, lengths
    spread over [0, width]; every eighth row ends at a chunk boundary of
    ``n_chunks`` (or one byte either side), and row 0 holds ``/public/``
    across the middle boundary."""
    if width % n_chunks:
        raise ValueError(f"width {width} is not a multiple of n_chunks {n_chunks}")
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdxyz_/PGHET0123 ", np.uint8)
    data = alphabet[rng.integers(0, len(alphabet), size=(f, width))]
    lengths = rng.integers(0, width + 1, size=f).astype(np.int32)
    lc = width // n_chunks
    edge = np.arange(0, f, 8)
    lengths[edge] = np.clip(rng.integers(0, n_chunks + 1, size=len(edge)) * lc
                            + rng.integers(-1, 2, size=len(edge)), 0, width)
    plants = [b"abc", b"/public/x", b"GET", b"abab", b"aaa", b"cd"]
    for i in range(f):
        for _ in range(rng.integers(0, 4)):
            ins = plants[rng.integers(len(plants))]
            pos = int(rng.integers(0, max(1, width - len(ins) + 1)))
            data[i, pos : pos + len(ins)] = np.frombuffer(ins, np.uint8)[: width - pos]
    if f:
        mid = max(0, width // 2 - 4)
        data[0, mid : mid + 9] = np.frombuffer(b"/public/d", np.uint8)[: width - mid]
        lengths[0] = width
    data[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return np.ascontiguousarray(data), lengths


# --- the composed L3/L4 datapath (bench.py:1417-1490) ---------------------------

DATAPATH_SERVICES = 64


def _ip4(s: str) -> int:
    import ipaddress

    return int(ipaddress.IPv4Address(s))


def _datapath_ct_keys():
    from .maps.ctmap import PROTO_TCP, CtKey4

    return [
        CtKey4(
            daddr=_ip4(f"10.{i % 4}.{i % 250}.{i % 200 + 1}"),
            saddr=_ip4(f"10.200.0.{i % 250 + 1}"),
            dport=8000 + (i % 3), sport=1024 + i % 50000,
            nexthdr=PROTO_TCP,
        )
        for i in range(4096)
    ]


def datapath_bench_maps():
    """bench_datapath's host maps at per-endpoint scale: (ct, lb, ipcache,
    policy) with 64 services x 3 backends, 1,024 ipcache /24s, 510 + 1
    egress policy entries and 4,096 CT entries."""
    from .maps.ctmap import PROTO_TCP, CtMap
    from .maps.ipcache import IpcacheMap
    from .maps.lbmap import LbMap
    from .maps.policymap import DIR_EGRESS, PolicyMap

    lb = LbMap()
    for s in range(DATAPATH_SERVICES):
        vip = _ip4(f"172.16.0.{s + 1}")
        lb.upsert_service(
            vip, 80,
            [(_ip4(f"10.9.{s}.{b + 1}"), 8080) for b in range(3)],
            rev_nat_index=s + 1,
        )
    ipc = IpcacheMap()
    for i in range(1024):
        ipc.upsert(f"10.{i // 250}.{i % 250}.0/24", sec_label=256 + i)
    pol = PolicyMap()
    for i in range(510):
        pol.allow(256 + i, 8080 if i % 2 else 8000, PROTO_TCP, DIR_EGRESS,
                  proxy_port=15000 if i % 7 == 0 else 0)
    pol.allow(0, 443, PROTO_TCP, DIR_EGRESS)
    ct = CtMap()
    for k in _datapath_ct_keys():
        ct.create(k)
    return ct, lb, ipc, pol


def datapath_batch(f: int = 65536):
    """bench_datapath's packet mix (``random.Random(29)``): 20% established
    CT tuples, 30% service VIPs on port 80, the rest pods and world
    addresses on 8000, 8080, 443 or 9999.  Returns (saddr, daddr, sport,
    dport, proto) [f] int32 numpy arrays, addresses as uint32 bit
    patterns."""
    from .maps.ctmap import PROTO_TCP

    rng = random.Random(29)
    ct_keys = _datapath_ct_keys()
    saddr = np.zeros((f,), np.int64)
    daddr = np.zeros((f,), np.int64)
    sport = np.zeros((f,), np.int64)
    dport = np.zeros((f,), np.int64)
    proto = np.full((f,), PROTO_TCP, np.int64)
    for i in range(f):
        roll = rng.random()
        if roll < 0.2:  # established flow: exercise the CT fast path
            k = ct_keys[rng.randrange(len(ct_keys))]
            saddr[i], daddr[i] = k.saddr, k.daddr
            sport[i], dport[i] = k.sport, k.dport
            continue
        saddr[i] = _ip4(f"10.200.0.{rng.randrange(250) + 1}")
        if roll < 0.5:  # service VIP
            daddr[i] = _ip4(f"172.16.0.{rng.randrange(DATAPATH_SERVICES) + 1}")
            dport[i] = 80
        else:
            daddr[i] = _ip4(
                f"10.{rng.randrange(5)}.{rng.randrange(250)}."
                f"{rng.randrange(200) + 1}"
            )
            dport[i] = rng.choice([8000, 8080, 443, 9999])
        sport[i] = rng.randrange(1024, 51024)
    as32 = lambda a: (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)  # noqa: E731
    return (as32(saddr), as32(daddr), sport.astype(np.int32), dport.astype(np.int32),
            proto.astype(np.int32))


# --- multi-card: the dry run and bench.py's sharding inputs -------------------


def dryrun_multichip(n_devices: int, device=None, n_rule: int | None = None) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: the full
    batched verdict step over an ``n_devices``-slot mesh with BOTH
    parallel axes live — flows (data-parallel) x rules (model-parallel:
    per-shard NFA tables, the K21 merge) — on tiny shapes, plus the Kafka
    sharded step (K22) and the sequence-sharded DFA search on the same
    slots.  The slots are ``n_devices`` virtual slots on ``device``
    (None: the card; the reference asks its runtime for that many CPU
    devices).  ``n_rule`` defaults to the reference's 2 (1 for one slot).
    Raises on any disagreement with the single-device models; returns the
    checked outputs' first rows."""
    from .models.kafka import build_kafka_model, kafka_verdicts
    from .models.r2d2 import r2d2_verdicts_attr
    from .ops.dfa import device_dfa, dfa_search_batch
    from .ops.seqdfa import SEQ_AXIS, device_dfa_absorbing, seqdfa_search_sharded
    from .parallel.mesh import Mesh, flow_mesh, virtual_devices
    from .parallel.rulesharding import (
        ShardedKafkaModel,
        ShardedVerdictModel,
        build_sharded_kafka_model,
        build_sharded_r2d2_model,
        shard_offsets,
    )

    device = resolve_device(device)
    devices = virtual_devices(n_devices, device)
    if n_rule is None:
        n_rule = 2 if n_devices >= 2 else 1
    n_flow = n_devices // n_rule
    mesh = flow_mesh(n_flow=n_flow, n_rule=n_rule, devices=devices)
    policy = bench_policy()

    f = 8 * n_flow
    data, lengths, remotes = batch(f, 32)
    n_rows = 2  # the graft policy's flattened row count
    sharded = ShardedVerdictModel(
        build_sharded_r2d2_model(policy, True, 80, n_rule, device=device),
        shard_offsets(n_rows, n_rule), mesh, "r2d2",
    )
    _, _, allow = sharded(data, lengths, remotes)
    got = allow[:4].cpu().tolist()
    if got != [True, False, True, False]:
        raise AssertionError(f"multichip dryrun verdicts wrong: {got}")
    # Cross-check the rule-sharded path against the unsharded model.
    ref = build_r2d2_model(policy, True, 80, device=device)
    _, _, want = r2d2_verdicts(ref, data, lengths, remotes)
    if not torch.equal(allow, want):
        raise AssertionError("rule-sharded verdicts diverge from single-device model")
    # Attributed step: the GLOBAL first-match rule id (shard-local
    # argmax + cross-shard min-index reduction) must equal the unsharded
    # argmax row — the serving path's attribution contract.
    _, _, a_allow, a_rule = sharded.verdicts_attr(data, lengths, remotes)
    _, _, w_allow, w_rule = r2d2_verdicts_attr(ref, data, lengths, remotes)
    if not (torch.equal(a_allow, w_allow) and torch.equal(a_rule, w_rule)):
        raise AssertionError("global first-match rule ids diverge from single-device argmax")

    # Kafka: topic-ACL rules sharded over the rule axis, partial
    # reductions merged before the all-topics combine.
    k_rules = []
    for spec in (
        {"topic": "orders", "role": "produce"},
        {"topic": "logs", "role": "consume"},
        {"topic": "metrics"},
        {"client_id": "trusted"},
    ):
        kr = PortRuleKafka(**spec)
        kr.sanitize()
        k_rules.append((frozenset(), kr))
    reqs = [
        RequestMessage(0, 2, 1, "p", ["orders"], parsed=True),
        RequestMessage(0, 2, 1, "p", ["secret"], parsed=True),
        RequestMessage(1, 2, 1, "c", ["logs"], parsed=True),
        RequestMessage(12, 0, 1, "trusted", [], parsed=False),
    ] * (f // 4)
    kbatch = encode_requests(reqs)
    kremotes = np.ones((len(reqs),), np.int32)
    kmodel = ShardedKafkaModel(
        build_sharded_kafka_model(k_rules, n_rule, device=device), mesh
    )
    kallow = kmodel(kbatch, kremotes)
    kref = kafka_verdicts(build_kafka_model(k_rules, device), kbatch, kremotes)
    if not torch.equal(kallow, kref):
        raise AssertionError("rule-sharded kafka verdicts diverge")

    # Sequence axis: long frames sharded across the BYTE axis — chunk
    # folding + composition (ops/seqdfa.py), checked bit-identical
    # against the serial DFA scan.
    seq_mesh = Mesh(np.array(devices, dtype=object), (SEQ_AXIS,))
    seq_tables = compile_pattern_dfas([r"/public/.*", r"^(GET|HEAD)$"])
    seq_width = 16 * n_devices
    seq_f = 4 * n_devices  # flow count must split over the seq axis
    seq_data = np.zeros((seq_f, seq_width), np.uint8)
    head = b"x" * (seq_width // 2 - 4) + b"/public/a"  # straddles chunks
    seq_data[0, : len(head)] = np.frombuffer(head, np.uint8)
    seq_data[1, :3] = np.frombuffer(b"GET", np.uint8)
    seq_lengths = np.zeros((seq_f,), np.int32)
    seq_lengths[:4] = [len(head), 3, 0, seq_width]
    d = torch.from_numpy(seq_data).to(device)
    ln = torch.from_numpy(seq_lengths).to(device)
    seq_got = seqdfa_search_sharded(device_dfa_absorbing(seq_tables, device), d, ln, seq_mesh)
    seq_want = dfa_search_batch(device_dfa(seq_tables, device), d, ln)
    if not torch.equal(seq_got, seq_want):
        raise AssertionError("seq-sharded DFA diverges")
    if not (bool(seq_got[0, 0]) and bool(seq_got[1, 1])):
        raise AssertionError("seq-sharded DFA misses the straddling match")
    return {
        "mesh": (n_flow, n_rule), "allow": got,
        "kafka_allow": kallow[:4].cpu().tolist(),
        "seq": seq_got[:2].cpu().tolist(),
    }


def mesh_bench_policy() -> PolicyInstance:
    """``bench.py::_mesh_bench_policy`` (``:3072-3102``): port 80 allows
    ``READ /public/.*`` and ``HALT``."""
    return compile_policy(
        NetworkPolicy(
            name="mesh-bench",
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
    )


def mesh_bench_batch(f: int, width: int = 64):
    """``bench.py::_mesh_bench_batch`` (``:3105-3120``): ``f`` messages
    drawn from ``random.Random(11)``, remotes 1."""
    rng = random.Random(11)
    msgs = [
        b"READ /public/a.txt\r\n", b"HALT\r\n",
        b"READ /private/b\r\n", b"WRITE /x\r\n",
    ]
    data = np.zeros((f, width), np.uint8)
    lengths = np.zeros((f,), np.int32)
    for i in range(f):
        m = msgs[rng.randrange(len(msgs))]
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = len(m)
    return data, lengths, np.ones((f,), np.int32)


RULES_100K = 100_000


def rules_100k_rows(n: int = RULES_100K) -> list:
    """``bench.py::bench_rules_100k``'s table (``:3207-3216``): n - 1
    literal method + path rules with 1-3 remote ids drawn from
    ``random.Random(13)``, then one remote-free ``HEAD`` rule last."""
    from .policy.api import PortRuleHTTP

    rng = random.Random(13)
    verbs = ("GET", "POST", "PUT", "DELETE")
    rows = [
        (
            frozenset(rng.sample(range(1, 50_000), rng.randrange(1, 4))),
            PortRuleHTTP(method=verbs[j % 4], path=f"/p{j:06d}"),
        )
        for j in range(n - 1)
    ]
    rows.append((frozenset(), PortRuleHTTP(method="HEAD")))
    return rows


def rules_100k_batch(f: int = 2048, width: int = 64):
    """``bench_rules_100k``'s batch (``:3217-3226``): odd rows the HEAD
    probe the last rule allows, even rows a PATCH nothing allows;
    remotes 1."""
    data = np.zeros((f, width), np.uint8)
    lengths = np.zeros((f,), np.int32)
    remotes = np.ones((f,), np.int32)
    probe_allow = b"HEAD /anything HTTP/1.1\r\n\r\n"  # last row
    probe_deny = b"PATCH /nope HTTP/1.1\r\n\r\n"
    for i in range(f):
        m = probe_allow if i % 2 else probe_deny
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = len(m)
    return data, lengths, remotes


# --- the policy slice ---------------------------------------------------------

POLICY_APPS = tuple(f"app{i:02d}" for i in range(32))
POLICY_TIERS = ("web", "api", "worker", "db")
POLICY_NS = ("prod", "staging", "dev", "ops")
POLICY_IDENTITY_BASE = 256  # utils.defaults.MIN_USER_IDENTITY
POLICY_RESOURCES = tuple(f"res{i:02d}" for i in range(64))
POLICY_TOPICS = tuple(f"topic-{i:02d}" for i in range(64))
POLICY_HTTP_PORT = 80
POLICY_KAFKA_PORT = 9092
POLICY_METHODS = ("GET", "POST", "PUT", "DELETE")
# Source selectors by the labels they name.  With 32 x 4 x 4 identities
# "app" selects 16, "app+ns" 4, "tier+ns" 32, and "tier" or "ns" 128 (more
# than MAX_REMOTES: the model builder splits those into 4 rows).
POLICY_NARROW_SOURCES = (("app",), ("app", "ns"), ("tier", "ns"))
POLICY_BROAD_SOURCES = (("tier",), ("ns",))


def policy_identities() -> dict[int, list[str]]:
    """{numeric identity: label strings}: one identity per (app, tier,
    ns), 512 in all, numbered from ``POLICY_IDENTITY_BASE``."""
    out = {}
    for app in POLICY_APPS:
        for tier in POLICY_TIERS:
            for ns in POLICY_NS:
                out[POLICY_IDENTITY_BASE + len(out)] = [
                    f"k8s:app={app}", f"k8s:tier={tier}", f"k8s:ns={ns}"]
    return out


def _policy_pick(rng, keys) -> dict[str, str]:
    vals = {"app": POLICY_APPS, "tier": POLICY_TIERS, "ns": POLICY_NS}
    return {f"k8s:{k}": rng.choice(vals[k]) for k in keys}


def _policy_http_rule(rng) -> dict:
    res = rng.choice(POLICY_RESOURCES)
    rule = {"method": rng.choice(POLICY_METHODS)}
    if rng.random() < 1 / 8:
        rule["path"] = f"/api/v[0-9]+/{res}/.*"
    else:
        rule["path"] = f"/{res}/.*"  # a literal prefix
    if rng.random() < 1 / 24:
        rule["headers"] = [f"X-Tenant: {rng.choice(POLICY_NS)}"]
    return rule


def policy_rules(n_rules: int = 1000, seed: int = 20, broad: float = 0.35) -> list[dict]:
    """``n_rules`` rules in the reference's JSON schema, from
    ``random.Random(seed)``.  Each selects its endpoints by app, tier or
    both and has 1-2 ingress sections of 0-3 source selectors (a share
    ``broad`` of them selecting 128 identities) and ports 80/TCP with 1-4
    HTTP rules (a method and a path under a resource's prefix, one in
    8 a versioned-API regex instead; one in 24 also names a tenant
    header), 9092/TCP with 1-3 Kafka rules (produce or consume on one
    of 64 topics), or both."""
    rng = random.Random(seed)
    rules = []
    for i in range(n_rules):
        sections = []
        for _ in range(rng.randrange(1, 3)):
            froms = []
            for _ in range(rng.randrange(0, 4)):
                kinds = POLICY_BROAD_SOURCES if rng.random() < broad else POLICY_NARROW_SOURCES
                froms.append({"matchLabels": _policy_pick(rng, rng.choice(kinds))})
            which = rng.choice(("http", "http", "kafka", "both", "both"))
            ports = []
            if which in ("http", "both"):
                ports.append({
                    "ports": [{"port": str(POLICY_HTTP_PORT), "protocol": "TCP"}],
                    "rules": {"http": [_policy_http_rule(rng) for _ in range(rng.randrange(1, 5))]},
                })
            if which in ("kafka", "both"):
                ports.append({
                    "ports": [{"port": str(POLICY_KAFKA_PORT), "protocol": "TCP"}],
                    "rules": {"kafka": [
                        {"role": rng.choice(("produce", "consume")), "topic": rng.choice(POLICY_TOPICS)}
                        for _ in range(rng.randrange(1, 4))]},
                })
            section = {"toPorts": ports}
            if froms:
                section["fromEndpoints"] = froms
            sections.append(section)
        rules.append({
            "endpointSelector": {"matchLabels": _policy_pick(
                rng, rng.choice((("app",), ("tier",), ("app", "tier"))))},
            "labels": [f"k8s:policy=gen-{i:04d}"],
            "ingress": sections,
        })
    return rules


def policy_destination(identities: dict, rules: list[dict]) -> int:
    """The identity the most rules select (the lowest on a tie), read from
    the documents themselves: a rule selects an identity whose labels hold
    every pair of its ``matchLabels``."""
    def selected(numeric):
        lbls = set(identities[numeric])
        return sum(1 for r in rules
                   if all(f"{k}={v}" in lbls for k, v in r["endpointSelector"]["matchLabels"].items()))

    return max(sorted(identities), key=selected)


def policy_http_requests(n: int, seed: int = 21) -> list[bytes]:
    """``n`` request heads against the slice's rule vocabulary from
    ``random.Random(seed)``: paths under a resource's prefix, versioned
    API paths, misses of both shapes and unknown paths; methods including
    one no rule names; a tenant header on a third of them."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        res = rng.choice(POLICY_RESOURCES)
        roll = rng.random()
        if roll < 0.35:
            path = f"/{res}/item{rng.randrange(100)}"
        elif roll < 0.7:
            path = f"/api/v{rng.randrange(1, 4)}/{res}/x{rng.randrange(100)}"
        elif roll < 0.85:
            path = f"/api/vX/{res}/x"
        else:
            path = f"/internal/{res}"
        method = rng.choice(POLICY_METHODS + ("PATCH",))
        head = f"{method} {path} HTTP/1.1\r\nHost: svc.local\r\n"
        if rng.random() < 1 / 3:
            head += f"X-Tenant: {rng.choice(POLICY_NS)}\r\n"
        out.append((head + "\r\n").encode())
    return out


def _kafka_str(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(2, "big", signed=True) + b


def _kafka_i32(*vals) -> bytes:
    return b"".join(int(v).to_bytes(4, "big", signed=True) for v in vals)


def policy_kafka_frames(n: int, seed: int = 22) -> list[bytes]:
    """``n`` Kafka request frames from ``random.Random(seed)``: produce
    (key 0), fetch (1) or metadata (3) at version 0-2 over 1-2 topics of
    the slice's 64, or an unknown one."""
    rng = random.Random(seed)
    out = []
    for cid in range(n):
        topics = [rng.choice(POLICY_TOPICS) if rng.random() < 0.9 else "secret"
                  for _ in range(rng.randrange(1, 3))]
        kind = rng.choice((0, 1, 3))
        if kind == 0:
            body = (1).to_bytes(2, "big") + _kafka_i32(1000, len(topics))
            body += b"".join(_kafka_str(t) + _kafka_i32(1, 0, 4) + b"recs" for t in topics)
        elif kind == 1:
            body = _kafka_i32(-1, 100, 1, len(topics))
            body += b"".join(_kafka_str(t) + _kafka_i32(1, 0, 0, 0, 1048576) for t in topics)
        else:
            body = _kafka_i32(len(topics)) + b"".join(_kafka_str(t) for t in topics)
        payload = (kind.to_bytes(2, "big") + rng.randrange(3).to_bytes(2, "big")
                   + _kafka_i32(cid) + _kafka_str("svc") + body)
        out.append(len(payload).to_bytes(4, "big") + payload)
    return out
