"""The port's model builder against the JAX package's.

``models.builder.build_model_for_filter`` compiles a resolved L4 filter
into the HTTP or Kafka verdict model.  Here each package resolves the
same JSON rule document (tests/policy_cases.py) with its own repository
and identity cache, builds its model (the JAX package's on the CPU, the
port's at ``device="cpu"``), and both judge the same numpy batches: the
verdicts and the first rule must be equal, tolerance 0.  Also: the
selector expansion and its chunks of ``MAX_REMOTES`` (past 32, the twin
of tests/test_runtime_engines.py::test_kafka_engine_remote_chunking_past_32),
a selector that matches no identity (dropped, never widened to a
wildcard), generic L7 filters, and the mesh branch on virtual CPU slots.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from cilium_tpu.kafka.request import parse_request as ref_parse_request
from cilium_tpu.models import http as ref_http
from cilium_tpu.models import kafka as ref_kafka
from cilium_tpu.models.base import ConstVerdict as RefConst
from cilium_tpu.runtime.engines_util import kafka_host_rows as ref_kafka_host_rows
from cilium_tpu_torch import entry
from cilium_tpu_torch.kafka.request import parse_request
from cilium_tpu_torch.models.base import MAX_REMOTES, ConstVerdict
from cilium_tpu_torch.models.http import HttpBatchModel
from cilium_tpu_torch.models.kafka import KafkaBatchModel, encode_requests, kafka_verdicts
from cilium_tpu_torch.parallel import flow_mesh, virtual_devices
from cilium_tpu_torch.parallel.rulesharding import ShardedKafkaModel, ShardedVerdictModel
from cilium_tpu_torch.runtime.engines_util import kafka_host_rows
from policy_cases import PKGS, canon_filter, ctx_to, remote_rows, world
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)




WIDTH = 128
F = 192


def _eq(port, ref, what=""):
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu", what
    want = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def resolved(seed, broad, n_rules=120, dst=None):
    """{package: (identity cache, ingress L4 map, destination)} for the
    same document; the destination defaults to the most-selected one."""
    out = {}
    ids = entry.policy_identities()
    if dst is None:
        dst = entry.policy_destination(ids, entry.policy_rules(n_rules, seed, broad))
    for name, pk in PKGS.items():
        cache, repo = world(pk, n_rules, seed, broad)
        out[name] = (cache, repo.resolve_l4_ingress_policy(ctx_to(pk, cache, dst)), dst)
    return out


def http_batch(seed, n=F):
    rng = random.Random(seed)
    heads = entry.policy_http_requests(n, seed=seed)
    pool = sorted(entry.policy_identities()) + [99_999]
    data = np.zeros((n, WIDTH), np.uint8)
    lengths = np.zeros((n,), np.int32)
    for i, h in enumerate(heads):
        h = h[:WIDTH]
        data[i, : len(h)] = np.frombuffer(h, np.uint8)
        lengths[i] = len(h)
    remotes = np.asarray([rng.choice(pool) for _ in range(n)], np.int32)
    return data, lengths, remotes


def kafka_batch(seed, n=F):
    rng = random.Random(seed)
    frames = entry.policy_kafka_frames(n, seed=seed)
    pool = sorted(entry.policy_identities()) + [99_999]
    remotes = np.asarray([rng.choice(pool) for _ in range(n)], np.int32)
    return frames, remotes


def both_models(res, key, mesh=None):
    (p_cache, p_l4, _), (r_cache, r_l4, _) = res["port"], res["ref"]
    port = PKGS["port"].builder.build_model_for_filter(p_l4[key], p_cache, mesh=mesh, device="cpu")
    ref = PKGS["ref"].builder.build_model_for_filter(r_l4[key], r_cache)
    return port, ref


@pytest.mark.parametrize("seed,broad", [(5, 0.35), (6, 0.0), (8, 1.0)])
def test_resolved_filters_and_rows_match_reference(seed, broad):
    res = resolved(seed, broad)
    (p_cache, p_l4, _), (r_cache, r_l4, _) = res["port"], res["ref"]
    assert set(p_l4) == set(r_l4) == {"80/TCP", "9092/TCP"}
    for key in p_l4:
        assert canon_filter(p_l4[key]) == canon_filter(r_l4[key])
        for (ps, pl7), (rs, _) in zip(p_l4[key].l7_rules_per_ep.items(), r_l4[key].l7_rules_per_ep.items()):
            got = PKGS["port"].builder._remote_rows(ps, p_cache)
            want = PKGS["ref"].builder._remote_rows(rs, r_cache)
            assert (got is None) == (want is None)
            if got is not None:
                assert [sorted(c) for c in got] == [sorted(c) for c in want]
                assert all(len(c) <= MAX_REMOTES for c in got)
    assert remote_rows(kafka_host_rows(p_l4["9092/TCP"], p_cache)) == remote_rows(
        ref_kafka_host_rows(r_l4["9092/TCP"], r_cache))


@pytest.mark.parametrize("seed,broad", [(5, 0.35), (6, 0.0)])
def test_http_model_for_filter_matches_reference(seed, broad):
    res = resolved(seed, broad)
    port, ref = both_models(res, "80/TCP")
    assert isinstance(port, HttpBatchModel) and port.n_rules == ref.n_rules
    assert port.match_kinds == ref.match_kinds
    data, lengths, remotes = http_batch(seed)
    got = port.verdicts_attr(data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w, "http attr")
    allow = got[2].numpy()
    assert 0 < allow.mean() < 1


@pytest.mark.parametrize("seed,broad", [(5, 0.35), (6, 0.0)])
def test_kafka_model_for_filter_matches_reference(seed, broad):
    res = resolved(seed, broad)
    port, ref = both_models(res, "9092/TCP")
    assert isinstance(port, KafkaBatchModel)
    frames, remotes = kafka_batch(seed)
    got = kafka_verdicts(port, encode_requests([parse_request(f) for f in frames]), remotes)
    want = ref_kafka.kafka_verdicts(ref, ref_kafka.encode_requests([ref_parse_request(f) for f in frames]),
                                    remotes)
    _eq(got, want, "kafka")
    assert 0 < got.numpy().mean() < 1


def _kafka_filter(pk, sel, rules):
    dm = pk.l4.L7DataMap()
    dm[sel] = pk.policy.L7Rules(kafka=rules)
    return pk.l4.L4Filter(port=9092, protocol="TCP", l7_parser=pk.l4.PARSER_TYPE_KAFKA, l7_rules_per_ep=dm)


def _krule(pk, **kw):
    r = pk.policy.PortRuleKafka(**kw)
    r.sanitize()
    return r


def produce_frame(topic: str) -> bytes:
    """A Kafka produce request (key 0, version 0) on one topic."""
    def s16(b):
        return len(b).to_bytes(2, "big") + b

    def i32(*vals):
        return b"".join(v.to_bytes(4, "big", signed=True) for v in vals)

    body = (1).to_bytes(2, "big") + i32(1000, 1) + s16(topic.encode()) + i32(1, 0, 4) + b"recs"
    payload = (0).to_bytes(2, "big") * 2 + i32(5) + s16(b"svc") + body
    return len(payload).to_bytes(4, "big") + payload


def test_kafka_remote_chunking_past_32_matches_reference():
    """One selector matching MAX_REMOTES + 8 identities chunks into two
    rows; the identity in the second chunk is allowed, an unknown one
    denied, in both packages."""
    n_ids = MAX_REMOTES + 8
    out = []
    for pk in (PKGS["port"], PKGS["ref"]):
        cache = {1000 + i: pk.labels.Labels.from_model(["k8s:app=web"]) for i in range(n_ids)}
        sel = pk.api.EndpointSelector.from_dict({"k8s:app": "web"})
        f = _kafka_filter(pk, sel, [_krule(pk, topic="allowed", role="produce")])
        rows = pk.builder._remote_rows(sel, cache)
        assert [len(c) for c in rows] == [MAX_REMOTES, 8]
        out.append((pk, f, cache))
    produce = produce_frame("allowed")
    remotes = np.asarray([1000 + n_ids - 1, 1000, 4242], np.int32)
    (pk_p, f_p, c_p), (pk_r, f_r, c_r) = out
    port = pk_p.builder.build_model_for_filter(f_p, c_p, device="cpu")
    ref = pk_r.builder.build_model_for_filter(f_r, c_r)
    assert port.version.shape[0] == 2
    got = kafka_verdicts(port, encode_requests([parse_request(produce)] * 3), remotes)
    want = ref_kafka.kafka_verdicts(ref, ref_kafka.encode_requests([ref_parse_request(produce)] * 3), remotes)
    _eq(got, want)
    assert got.tolist() == [True, True, False]


@pytest.mark.parametrize("parser", ["http", "kafka"])
def test_selector_matching_no_identity_is_dropped(parser):
    """expand_selector_remotes gives None for a wildcard and an empty set
    for "no identity"; the builder drops the second (fail closed) in both
    packages, so a filter of only such a selector denies everything."""
    for pk in (PKGS["port"], PKGS["ref"]):
        cache = {300: pk.labels.Labels.from_model(["k8s:app=web"])}
        nobody = pk.api.EndpointSelector.from_dict({"k8s:app": "ghost"})
        assert pk.builder.expand_selector_remotes(nobody, cache) == frozenset()
        assert pk.builder.expand_selector_remotes(pk.policy.WILDCARD_SELECTOR, cache) is None
        assert pk.builder._remote_rows(nobody, cache) is None
        assert pk.builder._remote_rows(pk.policy.WILDCARD_SELECTOR, cache) == [frozenset()]
        dm = pk.l4.L7DataMap()
        if parser == "http":
            dm[nobody] = pk.policy.L7Rules(http=[pk.policy.PortRuleHTTP(method="GET")])
            f = pk.l4.L4Filter(port=80, protocol="TCP", l7_parser="http", l7_rules_per_ep=dm)
        else:
            f = _kafka_filter(pk, nobody, [_krule(pk, topic="t")])
        kw = {"device": "cpu"} if pk.name == "port" else {}
        model = pk.builder.build_model_for_filter(f, cache, **kw)
        const = ConstVerdict if pk.name == "port" else RefConst
        assert isinstance(model, const) and not model.allow


def test_generic_l7_filter_is_a_constant_allow():
    for pk in (PKGS["port"], PKGS["ref"]):
        dm = pk.l4.L7DataMap()
        dm[pk.policy.WILDCARD_SELECTOR] = pk.policy.L7Rules(l7proto="r2d2", l7=[pk.policy.PortRuleL7({"cmd": "READ"})])
        f = pk.l4.L4Filter(port=80, protocol="TCP", l7_parser="r2d2", l7_rules_per_ep=dm)
        model = pk.builder.build_model_for_filter(f, {})
        assert model.allow is True


def test_l3_override_rows_allow_all_in_both():
    """A selector whose L7 rules are empty (the L3-override wildcard)
    becomes one allow-all row a remote chunk in both packages."""
    res = {}
    for pk in (PKGS["port"], PKGS["ref"]):
        cache = {300 + i: pk.labels.Labels.from_model([f"k8s:app=a{i % 2}"]) for i in range(6)}
        dm = pk.l4.L7DataMap()
        dm[pk.api.EndpointSelector.from_dict({"k8s:app": "a0"})] = pk.policy.L7Rules()
        dm[pk.api.EndpointSelector.from_dict({"k8s:app": "a1"})] = pk.policy.L7Rules(
            http=[pk.policy.PortRuleHTTP(method="GET", path="/x/.*")])
        f = pk.l4.L4Filter(port=80, protocol="TCP", l7_parser="http", l7_rules_per_ep=dm)
        kw = {"device": "cpu"} if pk.name == "port" else {}
        res[pk.name] = pk.builder.build_model_for_filter(f, cache, **kw)
    data, lengths, _ = http_batch(3, 32)
    remotes = np.asarray([300 + i % 7 for i in range(32)], np.int32)
    got = res["port"].verdicts_attr(data, lengths, remotes)
    want = ref_http.http_verdicts_attr(res["ref"], data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("n_flow,n_rule", [(1, 4), (2, 2)])
def test_mesh_branch_matches_single_model_and_reference(n_flow, n_rule):
    """With a mesh, the port's builder returns the sharded wrapper over
    virtual CPU slots; its verdicts and first rule equal the single-slot
    model's and the reference's unsharded model's."""
    res = resolved(5, 0.35)
    mesh = flow_mesh(n_flow, n_rule, virtual_devices(n_flow * n_rule, "cpu"))
    sharded, ref = both_models(res, "80/TCP", mesh=mesh)
    single, _ = both_models(res, "80/TCP")
    assert isinstance(sharded, ShardedVerdictModel) and sharded.n_shards == n_rule
    data, lengths, remotes = http_batch(9)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for model in (sharded, single):
        for g, w in zip(model.verdicts_attr(data, lengths, remotes), want):
            _eq(g, w, type(model).__name__)
    ksharded, kref = both_models(res, "9092/TCP", mesh=mesh)
    assert isinstance(ksharded, ShardedKafkaModel)
    frames, kremotes = kafka_batch(9)
    got = ksharded(encode_requests([parse_request(f) for f in frames]), kremotes)
    want = ref_kafka.kafka_verdicts(kref, ref_kafka.encode_requests([ref_parse_request(f) for f in frames]),
                                    kremotes)
    _eq(got, want, "mesh kafka")


def _http_rows(pk, f, cache):
    """The builder's HTTP rows of filter ``f`` in package ``pk``."""
    rows = []
    for sel, l7 in f.l7_rules_per_ep.items():
        for remotes in pk.builder._remote_rows(sel, cache) or []:
            if len(l7) == 0:
                rows.append((remotes, pk.policy.PortRuleHTTP()))
            rows.extend((remotes, h) for h in l7.http)
    return rows


def test_mesh_shard_nfa_past_one_launch_matches_reference():
    """The slice's share of regex paths (one HTTP rule in 8) at 500 rules:
    each 1 x 2 shard's union NFA holds more states than one K3 launch
    (``ops.nfa.MAX_STATES``) once padded to the largest, in the
    reference's stacked shards as in the port's.  The port cuts the
    largest shard's NFA into parts (a shard's padding states, where no
    pattern accepts, go in none), and its verdicts and first rule equal
    the reference's unsharded model's."""
    from cilium_tpu.parallel import rulesharding as ref_rs
    from cilium_tpu_torch.ops.nfa import MAX_STATES

    res = resolved(5, 0.35, n_rules=500)
    (p_cache, p_l4, _), (r_cache, r_l4, _) = res["port"], res["ref"]
    ref_rows = _http_rows(PKGS["ref"], r_l4["80/TCP"], r_cache)
    assert remote_rows(_http_rows(PKGS["port"], p_l4["80/TCP"], p_cache)) == remote_rows(ref_rows)
    assert ref_rs.build_sharded_http_model(ref_rows, 2).line_nfa.n_states > MAX_STATES
    sharded, ref = both_models(res, "80/TCP", mesh=flow_mesh(1, 2, virtual_devices(2, "cpu")))
    assert isinstance(sharded, ShardedVerdictModel)
    parts = [shard.line_nfa.scan_parts for shard in sharded.stacked]
    assert all(shard.line_nfa.n_states > MAX_STATES for shard in sharded.stacked)
    assert max(len(p) for p in parts) >= 2
    assert all(part.n_states <= MAX_STATES for p in parts for part, _ in p)
    data, lengths, remotes = http_batch(11)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(sharded.verdicts_attr(data, lengths, remotes), want):
        _eq(g, w)
    assert 0 < int(np.asarray(want[2]).sum()) < F


def test_mesh_branch_of_an_empty_filter_is_constant():
    """No rows (every selector matches nobody): the mesh branch is skipped
    and the unsharded builder's constant deny comes back."""
    pk = PKGS["port"]
    dm = pk.l4.L7DataMap()
    dm[pk.api.EndpointSelector.from_dict({"k8s:app": "ghost"})] = pk.policy.L7Rules(
        http=[pk.policy.PortRuleHTTP(method="GET")])
    f = pk.l4.L4Filter(port=80, protocol="TCP", l7_parser="http", l7_rules_per_ep=dm)
    model = pk.builder.build_model_for_filter(f, {}, mesh=flow_mesh(1, 2, virtual_devices(2, "cpu")), device="cpu")
    assert isinstance(model, ConstVerdict) and not model.allow
