"""The port's Kafka slice at device="cpu" against the JAX package.

Same frames, same rules, same numpy batches: the port's copies of
``parse_request``, ``frame_length``, ``matches_rule`` and
``encode_requests``, its ``kafka_verdicts`` (plain PyTorch here; kernel K17
``kafka_hits`` on the card) with ``kafka_rule_hits`` / ``kafka_combine``,
``kafka_model_from_numpy`` and ``KafkaBatchEngine`` must equal the JAX
package's and the host oracle's (tolerance 0: every output is bool or
int).  Frame builders and the fuzz mix are tests/test_kafka.py's.
"""

from __future__ import annotations

import random
import struct

import jax
import numpy as np
import pytest
import torch

from cilium_tpu import kafka as ref_kafka
from cilium_tpu.kafka import request as ref_request
from cilium_tpu.models import kafka as ref_model
from cilium_tpu.policy.api import PortRuleKafka as RefPortRuleKafka
from cilium_tpu.runtime.engines import KafkaBatchEngine as RefKafkaBatchEngine
from cilium_tpu_torch import kafka as port_kafka
from cilium_tpu_torch.convert import kafka_model_from_numpy
from cilium_tpu_torch.entry import kafka_batch, kafka_bench_rules, kafka_requests
from cilium_tpu_torch.kafka import request as port_request
from cilium_tpu_torch.models import kafka as port_model
from cilium_tpu_torch.models.base import MAX_REMOTES, ConstVerdict
from cilium_tpu_torch.policy.api import PortRuleKafka
from cilium_tpu_torch.runtime.engines import KafkaBatchEngine

from test_kafka import (
    _frame,
    _header,
    fetch_request,
    heartbeat_request,
    metadata_request,
    produce_request,
)

CPU = torch.device("cpu")


def _rules(kws):
    """The same sanitized rules for both packages."""
    out = []
    for cls in (PortRuleKafka, RefPortRuleKafka):
        rules = []
        for kw in kws:
            r = cls(**kw)
            r.sanitize()
            rules.append(r)
        out.append(rules)
    return out


def _models(kws, remotes=None):
    port_rules, ref_rules = _rules(kws)
    sets = remotes or [frozenset()] * len(kws)
    port = port_model.build_kafka_model(list(zip(sets, port_rules)), device="cpu")
    ref = ref_model.build_kafka_model(list(zip(sets, ref_rules)))
    return port, ref, port_rules, ref_rules


def _both(frame):
    """(port request, reference request) of one frame."""
    return port_kafka.parse_request(frame), ref_kafka.parse_request(frame)


def _fields(req):
    return (req.api_key, req.api_version, req.correlation_id, req.client_id,
            list(req.topics), req.parsed, req.raw)


def _verdicts(port, ref, reqs, remotes, topic_width=None):
    """(port allow, JAX allow, port (simple, cover), JAX (simple, cover),
    the port's numpy batch) on the same requests, each parsed by its own
    package; the two encoded batches must be equal."""
    port_batch = port_model.encode_requests([r[0] for r in reqs], topic_width)
    ref_batch = ref_model.encode_requests([r[1] for r in reqs], topic_width)
    for name in ("api_key", "api_version", "client", "client_len", "topics",
                 "topic_len", "topic_count", "parsed", "overflow"):
        np.testing.assert_array_equal(getattr(port_batch, name), getattr(ref_batch, name), err_msg=name)
    rem = np.asarray(remotes, np.int32)
    got = port_model.kafka_verdicts(port, port_batch, rem).numpy()
    want = np.asarray(ref_model.kafka_verdicts(ref, ref_batch, rem))
    tb = port_batch.to_device(CPU)
    parts = port_model.kafka_rule_hits(port, tb, torch.from_numpy(rem))
    ref_parts = ref_model.kafka_rule_hits(ref, ref_batch, rem)
    return got, want, parts, ref_parts, port_batch


def _assert_same(port, ref, reqs, remotes, oracle_rules=None, topic_width=None):
    got, want, parts, ref_parts, batch = _verdicts(port, ref, reqs, remotes, topic_width)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(parts, ref_parts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if oracle_rules is not None:
        oracle = [port_kafka.matches_rule(r[0], oracle_rules) for r in reqs]
        np.testing.assert_array_equal(got, np.asarray(oracle) & ~batch.overflow)
    return got


# --- the host copies -----------------------------------------------------------

FRAMES = {
    "produce": produce_request(["topic-a", "topic-b"]),
    "produce-dup": produce_request(["t", "t", "u"], client="", version=0),
    "fetch": fetch_request(["t1"]),
    "fetch-v0": fetch_request(["a", "b"], version=0),
    "metadata": metadata_request(["t1", "t2"]),
    "metadata-empty": metadata_request([]),
    "heartbeat": heartbeat_request(),
    "find-coordinator": _frame(_header(10, 0, 4, "c") + b"\x00\x01g"),
    "truncated": b"\x00\x00",
    "short-body": struct.pack(">i", 100) + b"short",
    "negative-length": struct.pack(">i", -5) + b"garbage",
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_parse_and_frame_length_match_reference(name):
    frame = FRAMES[name]
    outs = []
    for mod, req_mod in ((port_kafka, port_request), (ref_kafka, ref_request)):
        try:
            n = req_mod.frame_length(frame)
        except Exception as e:  # noqa: BLE001 — the error type is compared
            n = type(e).__name__
        try:
            req = mod.parse_request(frame)
            parsed = _fields(req) + (req.create_response().raw,)
        except Exception as e:  # noqa: BLE001
            parsed = type(e).__name__
        outs.append((n, parsed))
    assert outs[0] == outs[1]


def test_matches_rule_matches_reference():
    rule_sets = [
        [{}], [{"topic": "t1"}], [{"topic": "t1"}, {"topic": "t2"}],
        [{"role": "produce", "topic": "topic-a"}], [{"role": "consume", "topic": "t1"}],
        [{"api_version": "2"}], [{"client_id": "admin", "topic": "t2"}],
        [{"api_key": "findcoordinator", "topic": "x"}], [],
    ]
    for kws in rule_sets:
        port_rules, ref_rules = _rules(kws)
        for name, frame in FRAMES.items():
            try:
                p, r = _both(frame)
            except port_kafka.KafkaParseError:
                continue
            assert port_kafka.matches_rule(p, port_rules) == ref_kafka.matches_rule(r, ref_rules), (
                kws, name)


@pytest.mark.parametrize("longest,width", [(1, 32), (32, 32), (33, 64), (100, 128), (200, 256)])
def test_encode_requests_topic_width_buckets(longest, width):
    topics = ["a", "b" * longest]
    reqs = [_both(produce_request(topics)), _both(metadata_request(["x"]))]
    pb = port_model.encode_requests([r[0] for r in reqs])
    rb = ref_model.encode_requests([r[1] for r in reqs])
    assert pb.topics.shape == rb.topics.shape == (2, port_model.MAX_TOPICS, width)
    for name in ("topics", "topic_len", "topic_count", "client", "client_len", "parsed", "overflow"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(rb, name))


# --- the model -------------------------------------------------------------------

FUZZ_RULE_SETS = [
    [{}],
    [{"topic": "a"}, {"topic": "b"}],
    [{"role": "produce", "topic": "events"}],
    [{"role": "consume"}],
    [{"api_version": "2", "topic": "a"}],
    [{"client_id": "producer-1"}],
    [{"topic": "a", "client_id": "consumer-1"}, {"topic": "logs"}],
]


def _fuzz_frames(rng, n):
    """tests/test_kafka.py's TestDeviceModel._requests mix, as frames."""
    frames = []
    topics_pool = ["a", "b", "c", "events", "logs"]
    clients = ["producer-1", "consumer-1", "admin", ""]
    for _ in range(n):
        kind = rng.randrange(5)
        topics = rng.sample(topics_pool, k=rng.randrange(0, 3))
        client = rng.choice(clients)
        version = rng.randrange(0, 3)
        if kind == 0:
            frames.append(produce_request(topics, client=client, version=version))
        elif kind == 1:
            frames.append(fetch_request(topics, client=client, version=version))
        elif kind == 2:
            frames.append(metadata_request(topics, client=client, version=version))
        else:
            frames.append(heartbeat_request(client=client))
    return frames


@pytest.mark.parametrize("i", range(len(FUZZ_RULE_SETS)))
def test_fuzz_matches_reference_and_oracle(i):
    """test_fuzz_matches_host_oracle's seven rule sets, 300 requests each."""
    kws = FUZZ_RULE_SETS[i]
    port, ref, port_rules, _ = _models(kws)
    reqs = [_both(f) for f in _fuzz_frames(random.Random(11 + i), 300)]
    got = _assert_same(port, ref, reqs, np.ones(len(reqs)), port_rules)
    assert got.any() or i == 2  # every set but the produce-role one allows something


def _raw_batch(api_keys, parsed, topic_count=0):
    """A hand-made batch: keys the encoder would flag as overflow are left
    unflagged, so the model's clamped gathers are what decides."""
    f = len(api_keys)
    return ref_model.KafkaRequestBatch(
        api_key=np.asarray(api_keys, np.int32),
        api_version=np.zeros(f, np.int32),
        client=np.zeros((f, 64), np.uint8),
        client_len=np.zeros(f, np.int32),
        topics=np.zeros((f, 8, 32), np.uint8),
        topic_len=np.zeros((f, 8), np.int32),
        topic_count=np.full(f, topic_count, np.int32),
        parsed=np.asarray(parsed, bool),
        overflow=np.zeros(f, bool),
    )


def test_out_of_range_api_keys_gather_clamped():
    """Keys -1, 64 and 200 gather the api-key mask and the nil-topic gate
    at the key clamped to [0, 63] and mask with in_range
    (cilium_tpu/models/kafka.py:246-265); the encoder flags them."""
    keys = [-1, 64, 200, 0, 63, 10]
    for kws in ([{}], [{"topic": "t"}], [{"client_id": "c", "topic": "t"}], [{"api_key": "produce"}]):
        port, ref, _, _ = _models(kws)
        for parsed in (False, True):
            for tc in (0, 1):
                rb = _raw_batch(keys, [parsed] * len(keys), tc)
                pb = port_model.KafkaRequestBatch(**vars(rb)).to_device(CPU)
                rem = np.ones(len(keys), np.int32)
                want = np.asarray(ref_model.kafka_verdicts(ref, rb, rem))
                got = port_model.kafka_verdicts(port, pb, torch.from_numpy(rem)).numpy()
                np.testing.assert_array_equal(got, want)
                assert not got[:3].any()  # out of range never passes the key gate
    reqs = [port_request.RequestMessage(api_key=k, api_version=0, correlation_id=1, client_id="",
                                        topics=[], parsed=False) for k in keys]
    assert port_model.encode_requests(reqs).overflow.tolist() == [True, True, True, False, False, False]


def test_nine_topics_overflow_denied_on_device():
    port, ref, port_rules, _ = _models([{"topic": f"t{i}"} for i in range(12)])
    reqs = [_both(produce_request([f"t{i}" for i in range(9)])),
            _both(produce_request([f"t{i}" for i in range(8)]))]
    _, _, _, _, batch = _verdicts(port, ref, reqs, [1, 1])
    assert batch.overflow.tolist() == [True, False]
    got = _assert_same(port, ref, reqs, [1, 1])
    assert got.tolist() == [False, True]
    assert port_kafka.matches_rule(reqs[0][0], port_rules)  # the host would allow it


def test_rule_topic_longer_than_width_fails_on_length():
    """A 40-byte rule topic against a batch of width 32: the rule table is
    sliced to 32 bytes (cilium_tpu/models/kafka.py:292), and a request
    topic equal to the rule's first 32 bytes must not match."""
    long_topic = "x" * 40
    port, ref, port_rules, _ = _models([{"topic": long_topic}])
    reqs = [_both(produce_request(["x" * 32])), _both(produce_request([long_topic]))]
    got = _assert_same(port, ref, reqs[:1], [1])
    assert got.tolist() == [False]
    # the 40-byte request topic widens the batch to 64 and matches there
    got = _assert_same(port, ref, reqs, [1, 1], port_rules)
    assert got.tolist() == [False, True]
    # at a forced width of 32 it overflows instead of being truncated
    got = _assert_same(port, ref, reqs, [1, 1], topic_width=32)
    assert got.tolist() == [False, False]


def test_topicless_request_and_find_coordinator():
    """topic_count == 0 makes all_covered false but passes through simple
    (:280-283, :311); FindCoordinator (key 10) and a header-only topic key
    take the request-type gate's last branches (:266-274)."""
    port, ref, port_rules, _ = _models([{"topic": "t"}])
    reqs = [
        _both(metadata_request([])),  # parsed, no topics: allowed
        _both(FRAMES["find-coordinator"]),  # unparsed FindCoordinator: allowed
        _both(_frame(_header(4, 0, 1, "c") + b"\x00")),  # header-only topic key: denied
        _both(heartbeat_request()),  # header-only, not a topic key: allowed
        _both(produce_request(["t"])),
        _both(produce_request(["t", "u"])),
    ]
    got = _assert_same(port, ref, reqs, np.ones(len(reqs)), port_rules)
    assert got.tolist() == [True, True, False, True, True, False]


def test_client_id_rule():
    port, ref, port_rules, _ = _models([{"client_id": "producer-1", "topic": "t"},
                                        {"client_id": "producer-10"}])
    reqs = [_both(produce_request(["t"], client=c)) for c in ("producer-1", "producer-10", "producer", "")]
    reqs.append(_both(heartbeat_request(client="other")))
    got = _assert_same(port, ref, reqs, np.ones(len(reqs)), port_rules)
    assert got.tolist() == [True, True, False, False, True]


def test_remote_sets():
    port, ref, _, _ = _models([{"topic": "a"}], remotes=[frozenset({100})])
    reqs = [_both(produce_request(["a"]))] * 2
    got = _assert_same(port, ref, reqs, [100, 200])
    assert got.tolist() == [True, False]


def test_empty_ruleset_denies():
    m = port_model.build_kafka_model([], device="cpu")
    assert isinstance(m, ConstVerdict) and not m.allow


def test_kafka_hits_parts_on_cpu():
    """The wrapper's optional outputs are kafka_rule_hits' on the CPU."""
    port, _, _, _ = _models(FUZZ_RULE_SETS[6])
    reqs = [port_kafka.parse_request(f) for f in _fuzz_frames(random.Random(3), 64)]
    tb = port_model.encode_requests(reqs).to_device(CPU)
    rem = torch.ones(64, dtype=torch.int32)
    allow, simple, cover = port_model.kafka_hits(port, tb, rem, parts=True)
    want_simple, want_cover = port_model.kafka_rule_hits(port, tb, rem)
    assert torch.equal(simple, want_simple) and torch.equal(cover, want_cover)
    assert torch.equal(allow, port_model.kafka_verdicts_plain(port, tb, rem))
    with pytest.raises(TypeError):
        port_model.kafka_hits(port, tb, rem.to(torch.int64))


def test_model_from_numpy_matches_own_build():
    kws = [{"role": "produce", "topic": "a"}, {"client_id": "admin"}, {"api_version": "1"}]
    remotes = [frozenset({7, 9}), frozenset(), frozenset({3})]
    port, ref, _, _ = _models(kws, remotes)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
    conv = kafka_model_from_numpy(leaves, device="cpu")
    for f in port.__dataclass_fields__:
        assert torch.equal(getattr(conv, f), getattr(port, f)), f


def test_bench_batch_matches_reference_shape():
    """entry.kafka_batch is bench_kafka's: 1,024 requests tiled, width 32,
    no overflow, every verdict the oracle's."""
    reqs = kafka_requests()
    assert len(reqs) == 1024
    rules = kafka_bench_rules()
    batch, remotes = kafka_batch(2048)
    assert batch.topics.shape == (2048, 8, 32) and not batch.overflow.any()
    model = port_model.build_kafka_model([(frozenset(), r) for r in rules], device="cpu")
    got = port_model.kafka_verdicts(model, batch, remotes).numpy()
    want = [port_kafka.matches_rule(reqs[i % 1024], rules) for i in range(2048)]
    assert got.tolist() == want and 0 < sum(want) < 2048


# --- the engine ---------------------------------------------------------------


def _engines(kws, rows_remotes=None, host_rows=True):
    port, ref, port_rules, ref_rules = _models(kws, rows_remotes)
    sets = rows_remotes or [frozenset()] * len(kws)
    p_rows, r_rows = list(zip(sets, port_rules)), list(zip(sets, ref_rules))
    return (KafkaBatchEngine(port, host_rows=p_rows if host_rows else None),
            RefKafkaBatchEngine(ref, host_rows=r_rows if host_rows else None))


def _drive(engines, rounds):
    """Feed each round to both engines; every flow's (ops, inject) after
    each round, per engine."""
    outs = ([], [])
    for rnd in rounds:
        for eng in engines:
            for fid, chunk, remote in rnd:
                eng.feed(fid, chunk, remote_id=remote)
            eng.pump()
        for eng, out in zip(engines, outs):
            for fid, _, _ in rnd:
                ops, inj = eng.take_ops(fid)
                out.append((fid, [(int(op), n) for op, n in ops], inj))
    assert outs[0] == outs[1]
    return outs[0]


PASS, DROP, MORE = 1, 2, 0


def test_engine_allow_deny():
    f1, f2 = produce_request(["allowed"]), produce_request(["secret"])
    out = _drive(_engines([{"topic": "allowed", "role": "produce"}]), [[(1, f1, 1), (2, f2, 1)]])
    assert out[0] == (1, [(PASS, len(f1))], b"")
    assert out[1][1] == [(DROP, len(f2))] and out[1][2]  # error response injected
    assert out[1][2] == port_kafka.parse_request(f2).create_response().raw


def test_engine_framing_error_closes_connection():
    engines = _engines([{"topic": "allowed", "role": "produce"}])
    bad = struct.pack(">i", -5) + b"garbage"
    good = produce_request(["allowed"])
    out = _drive(engines, [[(1, bad, 1)], [(1, good, 1)]])
    assert out == [(1, [(DROP, len(bad))], b""), (1, [(DROP, len(good))], b"")]
    assert engines[0].flows[1].closed


def test_engine_topic_overflow_host_fallback():
    kws = [{"topic": f"t{i}", "role": "produce"} for i in range(12)]
    many = [f"t{i}" for i in range(port_model.MAX_TOPICS + 2)]
    f_ok, f_bad = produce_request(many), produce_request(many[:-1] + ["secret"])
    out = _drive(_engines(kws), [[(1, f_ok, 1), (2, f_bad, 1)]])
    assert out[0][1] == [(PASS, len(f_ok))] and out[1][1] == [(DROP, len(f_bad))]


def test_engine_remote_chunking_past_32():
    """A selector over more than MAX_REMOTES identities, as the reference's
    builder chunks it: two rule rows of at most 32 ids each.  Identity #40
    (in the second row) is allowed; an unknown identity is denied."""
    ids = [1000 + i for i in range(MAX_REMOTES + 8)]
    sets = [frozenset(ids[:MAX_REMOTES]), frozenset(ids[MAX_REMOTES:])]
    kws = [{"topic": "allowed", "role": "produce"}] * 2
    frame = produce_request(["allowed"])
    engines = _engines(kws, sets, host_rows=False)
    assert engines[0].model.n_rules == 2
    out = _drive(engines, [[(1, frame, ids[-1]), (2, frame, 4242)]])
    assert out[0][1] == [(PASS, len(frame))] and out[1][1] == [(DROP, len(frame))]


def test_engine_split_pipelined_and_const():
    """Frames split across rounds, pipelined pairs and a rule-less model
    (ConstVerdict) give the reference engine's ops."""
    f1, f2 = produce_request(["allowed"], cid=1), fetch_request(["allowed"], cid=2)
    rounds = [[(1, f1[:7], 1), (2, f1 + f2, 1), (3, f2, 5)],
              [(1, f1[7:], 1), (3, f1[:3], 5)],
              [(3, f1[3:], 5)]]
    out = _drive(_engines([{"topic": "allowed", "role": "produce"}], [frozenset({1})]), rounds)
    assert out[0][1] == [(MORE, 1)] and out[3][1] == [(PASS, len(f1))]
    port = KafkaBatchEngine(port_model.build_kafka_model([], device="cpu"))
    ref = RefKafkaBatchEngine(ref_model.build_kafka_model([]))
    out = _drive((port, ref), rounds)
    assert all(op == DROP for _, ops, _ in out for op, _ in ops if op != MORE)
