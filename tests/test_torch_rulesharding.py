"""The port's rule- and flow-sharded verdicts on CPU slots against the JAX
package.

Twins of tests/test_rulesharding.py: the port's sharded models, run on a
mesh of virtual CPU slots at (flows x rules) = 1x1, 1x2, 2x2, 1x4 and 2x4,
must give the same verdicts, rule ids and match kinds as the reference's
single-device models and host oracle walk; the port's shard tables must be
the reference's stacked leaves, shard by shard; K21 and K22's plain
versions must equal the reference's ``psum`` / ``pmin`` expressions under
``shard_map`` on the conftest's 8 virtual CPU devices (the INT32_MAX case
included); and ``convert.sharded_*_from_numpy`` of the reference's stacked
models must serve the reference's sharded step's outputs.  Tolerance 0:
every output is bool or int, inputs made with numpy from seeds.
"""

from __future__ import annotations

import random
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.kafka.request import RequestMessage as RefRequest
from cilium_tpu.models import http as ref_http
from cilium_tpu.models import kafka as ref_kafka
from cilium_tpu.models import r2d2 as ref_r2d2
from cilium_tpu.models.dns import build_dns_model_from_rows as ref_build_dns
from cilium_tpu.models.dns import dns_verdicts_attr as ref_dns_attr
from cilium_tpu.ops.dfa import DeviceDfa as RefDfa
from cilium_tpu.parallel import flow_mesh as ref_flow_mesh
from cilium_tpu.parallel import rulesharding as ref_rs
from cilium_tpu.policy.api import PortRuleHTTP as RefRule
from cilium_tpu.policy.api import PortRuleKafka as RefKafkaRule
from cilium_tpu.proxylib.npds import policy_from_dict as ref_policy_from_dict
from cilium_tpu.proxylib.parsers.dns import DnsRule as RefDnsRule
from cilium_tpu.proxylib.policy import compile_policy as ref_compile_policy
from cilium_tpu.regex import compile_patterns as ref_compile_patterns
from cilium_tpu_torch.convert import (
    DNS_TABLES,
    HTTP_TABLES,
    sharded_kafka_model_from_numpy,
    sharded_model_from_numpy,
)
from cilium_tpu_torch import kernels
from cilium_tpu_torch.kafka.request import RequestMessage
from cilium_tpu_torch.models.base import ConstVerdict
from cilium_tpu_torch.models.kafka import encode_requests
from cilium_tpu_torch.models.r2d2 import MIN_RULE_BUCKET
from cilium_tpu_torch.ops.nfa import device_nfa
from cilium_tpu_torch.ops.rxsearch import automaton_search_spans
from cilium_tpu_torch.parallel import flow_mesh, virtual_devices
from cilium_tpu_torch.parallel import rulesharding as rs
from cilium_tpu_torch.parallel.rulesharding import (
    ShardedKafkaModel,
    ShardedVerdictModel,
    kafka_shard_combine,
    kafka_shard_combine_plain,
    mesh_http_model_from_rows,
    mesh_dns_model,
    mesh_kafka_model,
    mesh_model_from_family_rows,
    mesh_r2d2_model,
    shard_offsets,
    shard_reduce,
    shard_reduce_plain,
    split_balanced,
)
from cilium_tpu_torch.policy.api import PortRuleHTTP, PortRuleKafka
from cilium_tpu_torch.proxylib import compile_policy
from cilium_tpu_torch.proxylib.npds import policy_from_dict
from cilium_tpu_torch.proxylib.parsers.dns import DnsRule, encode_dns_query
from cilium_tpu_torch.proxylib.parsers.r2d2 import R2d2RequestData

MESHES = [(1, 1), (1, 2), (2, 2), (1, 4), (2, 4)]
MESH_IDS = [f"{f}x{r}" for f, r in MESHES]


@pytest.fixture(autouse=True, scope="module")
def _reference_leak_guard():
    """Reference tests leave a dummy HTTP/DNS rule parser registered and a
    FlightRecorder installed (ROADMAP Queue 3): put the real parsers back
    and uninstall every recorder, before and after this module."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.dns import dns_rule_parser
    from cilium_tpu.proxylib.parsers.http import http_rule_parser
    from cilium_tpu.sidecar import blackbox as ref_bb
    from cilium_tpu_torch.sidecar import blackbox as port_bb

    def clean():
        register_l7_rule_parser("http", http_rule_parser)
        register_l7_rule_parser("dns", dns_rule_parser)
        for bb in (ref_bb, port_bb):
            for rec in list(bb._RECORDERS):
                rec.uninstall()

    clean()
    yield
    clean()


def cpu_mesh(n_flow, n_rule):
    return flow_mesh(n_flow, n_rule, virtual_devices(n_flow * n_rule, "cpu"))


def _eq(port, ref, what=""):
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(ref)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.astype(want.dtype), want), what


# --- split, offsets, padding ----------------------------------------------------


def test_split_balanced():
    assert split_balanced([1, 2, 3, 4, 5], 2) == [[1, 2, 3], [4, 5]]
    assert split_balanced([1, 2], 4) == [[1], [2], [], []]
    assert split_balanced([], 2) == [[], []]
    rng = random.Random(0)
    for _ in range(50):
        seq = list(range(rng.randrange(0, 40)))
        k = rng.randrange(1, 9)
        assert split_balanced(seq, k) == ref_rs.split_balanced(seq, k)


def test_split_balanced_degenerate():
    assert split_balanced([1], 4) == [[1], [], [], []]
    assert split_balanced([], 3) == [[], [], []]
    assert split_balanced([1, 2, 3], 1) == [[1, 2, 3]]


def test_shard_offsets_match_split():
    assert np.asarray(shard_offsets(5, 2)).tolist() == [0, 3]
    assert np.asarray(shard_offsets(1, 4)).tolist() == [0, 1, 1, 1]
    assert np.asarray(shard_offsets(8, 4)).tolist() == [0, 2, 4, 6]
    for n, k in [(0, 1), (7, 3), (100, 8), (3, 64)]:
        got = shard_offsets(n, k)
        assert got.dtype == torch.int32
        _eq(got, ref_rs.shard_offsets(n, k), (n, k))


def test_pad_tables_padding_is_dead():
    """pad_tables grows (states, classes, patterns) with rows that never
    fire, array for array as the reference's."""
    from cilium_tpu_torch.regex import compile_patterns

    t = compile_patterns(["ab+c"])
    p = rs.pad_tables(t, t.n_states + 3, t.n_classes + 2, 5)
    rp = ref_rs.pad_tables(ref_compile_patterns(["ab+c"]), t.n_states + 3, t.n_classes + 2, 5)
    for k in ("classmap", "delta", "start", "accept", "accept_final", "matches_empty"):
        assert np.array_equal(getattr(p, k), getattr(rp, k)), k
    assert not p.accept[1:].any() and not p.accept_final[1:].any()
    assert not p.matches_empty[1:].any() and not p.delta[t.n_classes:].any()
    nfa = device_nfa(p, "cpu")
    data = np.zeros((2, 8), np.uint8)
    data[0, :4] = np.frombuffer(b"abbc", np.uint8)
    hits = automaton_search_spans(
        nfa, torch.from_numpy(data), torch.zeros(2, dtype=torch.int32),
        torch.tensor([4, 0], dtype=torch.int32),
    )
    assert hits[0, 0] and not hits[:, 1:].any()


def test_never_match_tables():
    t = rs._never_match_tables(3)
    rt = ref_rs._never_match_tables(3)
    assert t.n_patterns == 3
    assert not t.accept.any() and not t.accept_final.any() and not t.matches_empty.any()
    for k in ("classmap", "delta", "start", "accept", "accept_final"):
        assert np.array_equal(getattr(t, k), getattr(rt, k)), k


def test_stack_nfas_pads_every_shard_to_the_references_shape():
    """The port's per-shard list holds, shard for shard, the tables the
    reference stacks along its leading shard dim."""
    from cilium_tpu_torch.convert import nfa_from_leaves
    from cilium_tpu_torch.regex import compile_patterns

    pats = [["ab+c", "^x$"], ["(a|b)*a(a|b)(a|b)"], ["/public/.*", "q", "r"]]
    got = rs.stack_nfas([compile_patterns(p) for p in pats], device="cpu")
    ref = ref_rs.stack_nfas([ref_compile_patterns(p) for p in pats])
    keys = ("delta_flat", "classmap", "start", "accept_t", "accept_final_t")
    assert len({(n.n_states, n.n_classes, n.n_patterns) for n in got}) == 1
    for j, nfa in enumerate(got):
        want = nfa_from_leaves({k: np.asarray(getattr(ref, k))[j] for k in keys}, "cpu")
        for k in ("classmap", "delta_bits", "start_bits", "accept_bits", "accept_final_bits"):
            assert torch.equal(getattr(nfa, k), getattr(want, k)), (j, k)


# --- r2d2 ------------------------------------------------------------------------

R2D2_RULES = [
    {"cmd": "READ", "file": "/public/.*"},
    {"cmd": "HALT"},
    {"cmd": "WRITE", "file": "^/tmp/"},
    {"cmd": "READ", "file": "\\.txt$"},
    {"cmd": "RESET"},
    {"file": "/shared/.*"},
]

R2D2_MSGS = [
    b"READ /public/a.txt\r\n", b"READ /private/b\r\n", b"HALT\r\n",
    b"WRITE /tmp/x\r\n", b"WRITE /etc/passwd\r\n", b"RESET\r\n",
    b"FLY /public/a\r\n", b"READ notes.txt\r\n",
]


def _both(name, port_rules):
    d = {
        "name": name, "policy": 2,
        "ingress_per_port_policies": [{"port": 80, "rules": port_rules}],
    }
    return ref_compile_policy(ref_policy_from_dict(d)), compile_policy(policy_from_dict(d))


def r2d2_policies():
    return _both("shard-pol", [
        {"remote_policies": [1, 3], "l7_proto": "r2d2", "l7_rules": R2D2_RULES[:3]},
        {"l7_proto": "r2d2", "l7_rules": R2D2_RULES[3:]},
    ])


def _r2d2_batch(f, width=64, seed=0):
    rng = random.Random(seed)
    data = np.zeros((f, width), np.uint8)
    lengths = np.zeros((f,), np.int32)
    remotes = np.zeros((f,), np.int32)
    for i in range(f):
        m = R2D2_MSGS[rng.randrange(len(R2D2_MSGS))]
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = len(m)
        remotes[i] = rng.choice([1, 3, 9])
    return data, lengths, remotes


@pytest.mark.parametrize("n_flow,n_rule", MESHES, ids=MESH_IDS)
def test_r2d2_sharded_parity(n_flow, n_rule):
    ref_pol, pol = r2d2_policies()
    data, lengths, remotes = _r2d2_batch(30)  # 30 flows: the 2-row meshes pad
    want = ref_r2d2.r2d2_verdicts(ref_r2d2.build_r2d2_model(ref_pol, True, 80),
                                  data, lengths, remotes)
    stacked = rs.build_sharded_r2d2_model(pol, True, 80, n_rule, device="cpu")
    model = ShardedVerdictModel(stacked, shard_offsets(8, n_rule), cpu_mesh(n_flow, n_rule), "r2d2")
    got = model(data, lengths, remotes)
    for g, w, what in zip(got, want, ("complete", "msg_len", "allow")):
        _eq(g, w, what)


def test_r2d2_more_shards_than_rules():
    """n_rule above the row count exercises the empty-shard padding."""
    ref_pol, pol = r2d2_policies()
    data, lengths, remotes = _r2d2_batch(16)
    _, _, want = ref_r2d2.r2d2_verdicts(ref_r2d2.build_r2d2_model(ref_pol, True, 80),
                                        data, lengths, remotes)
    stacked = rs.build_sharded_r2d2_model(pol, True, 80, 8, device="cpu")
    model = ShardedVerdictModel(stacked, shard_offsets(6, 8), cpu_mesh(1, 8), "r2d2")
    _, _, got = model(data, lengths, remotes)
    _eq(got, want)


def _r2d2_ref_leaves(m, j):
    """Shard j of the reference's stacked r2d2 model, as the dict
    ``convert.model_from_numpy`` takes."""
    out = {k: np.asarray(getattr(m, k))[j]
           for k in ("cmd_needle", "cmd_len", "cmd_any", "remote_ids", "any_remote")}
    out.update({k: np.asarray(getattr(m.nfa, k))[j]
                for k in ("delta_flat", "classmap", "start", "accept_t", "accept_final_t")})
    return out


def _port_leaves(model):
    out = {}
    for k, v in vars(model).items():
        if isinstance(v, torch.Tensor):
            out[k] = v.numpy()
        elif hasattr(v, "delta_bits"):
            out.update({f"{k}.{kk}": vv.numpy() for kk, vv in vars(v).items()
                        if isinstance(vv, torch.Tensor)})
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_bucket_pads_rule_axis(n_shards):
    """bucket=True pads each shard's rule axis to the power-of-two bucket,
    and every shard's tables are the reference's stacked leaves."""
    from cilium_tpu_torch.convert import model_from_numpy

    ref_pol, pol = r2d2_policies()
    ref_stacked = ref_rs.build_sharded_r2d2_model(ref_pol, True, 80, n_shards, bucket=True)
    stacked = rs.build_sharded_r2d2_model(pol, True, 80, n_shards, bucket=True, device="cpu")
    assert len(stacked) == n_shards
    for j, shard in enumerate(stacked):
        r_dim = shard.cmd_len.shape[0]
        assert r_dim >= MIN_RULE_BUCKET and (r_dim & (r_dim - 1)) == 0
        want = _port_leaves(model_from_numpy(_r2d2_ref_leaves(ref_stacked, j), device="cpu"))
        got = _port_leaves(shard)
        assert got.keys() == want.keys()
        for k in got:
            assert np.array_equal(got[k], want[k]), (j, k)
    data, lengths, remotes = _r2d2_batch(16)
    _, _, want = ref_r2d2.r2d2_verdicts(ref_r2d2.build_r2d2_model(ref_pol, True, 80),
                                        data, lengths, remotes)
    n_flow = 2 if n_shards <= 4 else 1
    model = ShardedVerdictModel(stacked, shard_offsets(6, n_shards),
                                cpu_mesh(n_flow, n_shards), "r2d2")
    _eq(model(data, lengths, remotes)[2], want)


# --- http ------------------------------------------------------------------------

HTTP_SPECS = [
    ((), dict(method="GET", path="/public/.*")),
    ((1, 3), dict(method="POST", path="/api/v[0-9]+/.*")),
    ((), dict(path="/health")),
    ((), dict(method="GET", host="internal\\..*")),
    ((5,), dict(method="PUT", path="/up/.*", headers=["X-Token: s3cr3t"])),
    ((), dict(method="DELETE", path="/tmp/.*")),
]


def http_rows(specs=HTTP_SPECS, ref=False):
    cls = RefRule if ref else PortRuleHTTP
    return [(frozenset(rs_), cls(**kw)) for rs_, kw in specs]


def _http_batch(f, width=256, seed=1):
    rng = random.Random(seed)
    reqs = [
        b"GET /public/a HTTP/1.1\r\n\r\n",
        b"POST /api/v2/x HTTP/1.1\r\n\r\n",
        b"GET /health HTTP/1.1\r\n\r\n",
        b"GET / HTTP/1.1\r\nHost: internal.svc\r\n\r\n",
        b"PUT /up/f HTTP/1.1\r\nX-Token: s3cr3t\r\n\r\n",
        b"PUT /up/f HTTP/1.1\r\n\r\n",
        b"DELETE /tmp/x HTTP/1.1\r\n\r\n",
        b"PATCH /public/a HTTP/1.1\r\n\r\n",
    ]
    data = np.zeros((f, width), np.uint8)
    lengths = np.zeros((f,), np.int32)
    remotes = np.zeros((f,), np.int32)
    for i in range(f):
        m = reqs[rng.randrange(len(reqs))]
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = len(m)
        remotes[i] = rng.choice([1, 3, 5, 9])
    return data, lengths, remotes


@pytest.mark.parametrize("n_flow,n_rule", MESHES, ids=MESH_IDS)
def test_http_sharded_parity(n_flow, n_rule):
    ref_model = ref_http.build_http_model(http_rows(ref=True))
    data, lengths, remotes = _http_batch(32)
    _, _, want = ref_http.http_verdicts(ref_model, data, lengths, remotes)
    stacked = rs.build_sharded_http_model(http_rows(), n_rule, device="cpu")
    model = ShardedVerdictModel(stacked, shard_offsets(6, n_rule), cpu_mesh(n_flow, n_rule), "http")
    _eq(model(data, lengths, remotes)[2], want)


def test_http_sharded_no_head_patterns():
    """All-line-rule sets keep head_nfa None across shards."""
    specs = [((), dict(method="GET", path="/a/.*")), ((), dict(method="POST", path="/b"))]
    ref_model = ref_http.build_http_model(http_rows(specs, ref=True))
    assert ref_model.head_nfa is None
    data, lengths, remotes = _http_batch(16)
    _, _, want = ref_http.http_verdicts(ref_model, data, lengths, remotes)
    stacked = rs.build_sharded_http_model(http_rows(specs), 2, device="cpu")
    assert all(m.head_nfa is None for m in stacked)
    model = ShardedVerdictModel(stacked, shard_offsets(2, 2), cpu_mesh(4, 2), "http")
    _eq(model(data, lengths, remotes)[2], want)


@pytest.mark.parametrize("n_flow,n_rule", MESHES, ids=MESH_IDS)
def test_http_cross_shard_attr_parity(n_flow, n_rule):
    ref_model = ref_http.build_http_model(http_rows(ref=True))
    data, lengths, remotes = _http_batch(32)
    want = ref_http.http_verdicts_attr(ref_model, data, lengths, remotes)
    model = mesh_http_model_from_rows(http_rows(), cpu_mesh(n_flow, n_rule))
    assert model.match_kinds == ref_model.match_kinds
    got = model.verdicts_attr(data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w)


# --- cross-shard attribution parity against the host walk ------------------------

_NFA_FILE = "/n/(a|b)*a" + "(a|b)" * 7 + "/x"
ATTR_PORTS = [
    {"port": 80, "rules": [
        {"remote_policies": [1, 3], "l7_proto": "r2d2",
         "l7_rules": [{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}]},
        {"l7_proto": "r2d2", "l7_rules": [
            {"cmd": "WRITE", "file": _NFA_FILE}, {"file": "\\.txt$"},
            {"cmd": "READ", "file": "/d/[a-z]+"}]},
    ]},
    {"port": 0, "rules": [{"l7_proto": "r2d2", "l7_rules": [{"cmd": "RESET"}]}]},
]
_ATTR_MSGS = [
    b"READ /public/a.txt\r\n", b"HALT\r\n", b"WRITE /n/ababaababababab/x\r\n",
    b"WRITE /n/bbbb/x\r\n", b"READ notes.txt\r\n", b"READ /d/abc\r\n",
    b"RESET\r\n", b"FLY /public/a\r\n", b"READ /secret\r\n",
]


def attr_policies():
    d = {"name": "attr-pol", "policy": 2, "ingress_per_port_policies": ATTR_PORTS}
    return ref_compile_policy(ref_policy_from_dict(d)), compile_policy(policy_from_dict(d))


def _attr_batch(f=32, width=64, seed=7):
    rng = random.Random(seed)
    data = np.zeros((f, width), np.uint8)
    lengths = np.zeros((f,), np.int32)
    remotes = np.zeros((f,), np.int32)
    msgs = []
    for i in range(f):
        m = _ATTR_MSGS[rng.randrange(len(_ATTR_MSGS))]
        r = rng.choice([1, 3, 9])
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = len(m)
        remotes[i] = r
        msgs.append((m, r))
    return data, lengths, remotes, msgs


@pytest.mark.parametrize("n_flow,n_rule", MESHES, ids=MESH_IDS)
def test_r2d2_cross_shard_attr_parity_vs_host(n_flow, n_rule):
    ref_pol, pol = attr_policies()
    model = mesh_r2d2_model(pol, True, 80, cpu_mesh(n_flow, n_rule))
    assert model.n_shards == n_rule
    data, lengths, remotes, msgs = _attr_batch()
    _, _, allow, rule = model.verdicts_attr(data, lengths, remotes)
    ref_fb = ref_r2d2.build_r2d2_model(ref_pol, True, 80)
    _, _, fa, fr = ref_r2d2.r2d2_verdicts_attr(ref_fb, data, lengths, remotes)
    _eq(allow, fa)
    _eq(rule, fr)
    assert model.match_kinds == ref_fb.match_kinds
    assert len({"literal", "regex", "nfa"} & set(model.match_kinds)) >= 2
    for i, (m, r) in enumerate(msgs):
        parts = m[:-2].decode().split(" ")
        hok, hrule = pol.matches_at(True, 80, r, R2d2RequestData(parts[0], parts[1] if len(parts) > 1 else ""))
        assert bool(allow[i]) == hok, (m, r)
        assert int(rule[i]) == hrule, (m, r)
        if hrule >= 0:
            assert model.match_kinds[int(rule[i])] == model.fallback.match_kinds[hrule]


def test_r2d2_single_rule_many_shards():
    """1 rule over 4 shards: three all-empty shards stay dead on both
    merges (OR-allow and min-index attribution)."""
    _, pol = _both("one", [{"l7_proto": "r2d2", "l7_rules": [{"cmd": "HALT"}]}])
    model = mesh_r2d2_model(pol, True, 80, cpu_mesh(2, 4))
    assert model.n_shards == 4
    data = np.zeros((8, 32), np.uint8)
    lengths = np.zeros(8, np.int32)
    remotes = np.ones(8, np.int32)
    for i, m in enumerate([b"HALT\r\n", b"READ /x\r\n"] * 4):
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = len(m)
    _, _, a, r = model.verdicts_attr(data, lengths, remotes)
    _, _, fa, fr = model.fallback.verdicts_attr(data, lengths, remotes)
    assert torch.equal(a, fa) and torch.equal(r, fr)
    assert a[0] and not a[1] and int(r[0]) == 0


def test_constant_rule_sets_fold_as_unsharded():
    _, pol = _both("const", [{"remote_policies": [1]}])
    mesh = cpu_mesh(1, 2)
    assert mesh_r2d2_model(pol, True, 80, mesh) == ConstVerdict(True)
    assert mesh_r2d2_model(pol, True, 81, mesh) == ConstVerdict(False)
    assert mesh_model_from_family_rows("http", [], mesh) == ConstVerdict(False)


# --- dns -------------------------------------------------------------------------

DNS_ROWS = [
    ({7}, dict(name="www.example.com")),
    ((), dict(pattern="*.svc.cluster.local")),
    ({7, 9}, dict(regex="^cdn[0-9]+[.]edge[.]net$")),
    ({3}, None),
    ((), dict(name="api.internal")),
    ((), dict(name="x" * 40 + ".y")),
]
DNS_NAMES = ["www.example.com", "a.svc.cluster.local", "cdn42.edge.net", "api.internal",
             "x" * 40 + ".y", "nope.example", ""]


def dns_rows(ref=False):
    cls = RefDnsRule if ref else DnsRule
    return [(frozenset(s), None if kw is None else cls(**kw)) for s, kw in DNS_ROWS]


def _dns_batch(f=40, seed=5):
    rng = random.Random(seed)
    frames = [encode_dns_query(rng.choice(DNS_NAMES)) for _ in range(f)]
    width = max(len(x) for x in frames)
    data = np.zeros((f, width), np.uint8)
    lens = np.zeros(f, np.int32)
    for i, fr in enumerate(frames):
        data[i, : len(fr)] = np.frombuffer(fr, np.uint8)
        lens[i] = len(fr)
    return data, lens, np.asarray([rng.choice([1, 3, 7, 9]) for _ in range(f)], np.int32)


@pytest.mark.parametrize("n_flow,n_rule", MESHES, ids=MESH_IDS)
def test_dns_sharded_parity(n_flow, n_rule):
    """The sharded DNS build (one needle width for every shard, NFA shards)
    against the reference's single-device model, rule ids included."""
    data, lens, rem = _dns_batch()
    want = ref_dns_attr(ref_build_dns(dns_rows(ref=True), bucket=True), data, lens, rem)
    model = mesh_model_from_family_rows("dns", dns_rows(), cpu_mesh(n_flow, n_rule))
    widths = {m.name_needle.shape[1] for m in model.stacked}
    assert len(widths) == 1
    for g, w in zip(model.verdicts_attr(data, lens, rem), want):
        _eq(g, w)
    for g, w in zip(model(data, lens, rem), want[:3]):
        _eq(g, w)


@pytest.mark.parametrize("n_flow,n_rule", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_mesh_dns_model_through_the_port_cascade(n_flow, n_rule):
    """``mesh_dns_model`` on an NPDS policy (exact port and wildcard port
    rows) against the reference's single-device ``build_dns_model``."""
    from cilium_tpu.models.dns import build_dns_model as ref_build_dns_model

    rules = [{"l7_proto": "dns", "l7_rules": [
        {"matchName": "www.example.com"}, {"matchPattern": "*.svc.cluster.local"},
        {"matchRegex": "^cdn[0-9]+[.]edge[.]net$"}]},
        {"remote_policies": [3], "l7_proto": "dns", "l7_rules": [{"matchName": "api.internal"}]}]
    d = {"name": "dns-mesh", "policy": 2, "ingress_per_port_policies": [
        {"port": 53, "rules": rules},
        {"port": 0, "rules": [{"l7_proto": "dns", "l7_rules": [{"matchName": "x" * 40 + ".y"}]}]},
    ]}
    ref_pol = ref_compile_policy(ref_policy_from_dict(d))
    pol = compile_policy(policy_from_dict(d))
    data, lens, rem = _dns_batch(seed=11)
    want = ref_dns_attr(ref_build_dns_model(ref_pol, True, 53), data, lens, rem)
    model = mesh_dns_model(pol, True, 53, cpu_mesh(n_flow, n_rule))
    assert isinstance(model, ShardedVerdictModel) and model.n_shards == n_rule
    for g, w in zip(model.verdicts_attr(data, lens, rem), want):
        _eq(g, w)


def test_dns_row_arrays_width_argument():
    from cilium_tpu.models.dns import dns_row_arrays as ref_rows
    from cilium_tpu_torch.models.dns import dns_row_arrays

    for width in (None, 48, 64):
        got = dns_row_arrays(dns_rows(), 8, width=width)
        want = ref_rows(dns_rows(ref=True), 8, width=width)
        for g, w in zip(got[:6], want[:6]):
            assert np.array_equal(g, w)
        assert got[6] == want[6]
    with pytest.raises(ValueError, match="width"):
        dns_row_arrays(dns_rows(), 8, width=8)


# --- kafka -----------------------------------------------------------------------

KAFKA_SPECS = [
    {"topic": "orders", "role": "produce"}, {"topic": "orders", "role": "consume"},
    {"topic": "logs", "role": "produce"}, {"topic": "metrics"},
    {"client_id": "trusted", "topic": "audit"}, {"topic": "events", "api_version": "2"},
]
KAFKA_REMOTES = [(), (1, 3), (), (5,), (), ()]


def kafka_rows(ref=False):
    cls = RefKafkaRule if ref else PortRuleKafka
    out = []
    for spec, rem in zip(KAFKA_SPECS, KAFKA_REMOTES):
        r = cls(**spec)
        r.sanitize()
        out.append((frozenset(rem), r))
    return out


def kafka_case(seed=3, n=32):
    rng = random.Random(seed)
    specs = []
    for _ in range(n):
        specs.append(dict(
            api_key=rng.choice([0, 1, 2, 3, 12]), api_version=rng.choice([0, 2]),
            correlation_id=1, client_id=rng.choice(["trusted", "other"]),
            topics=rng.sample(["orders", "logs", "metrics", "audit", "events", "other"],
                              rng.randrange(0, 3)),
            parsed=True,
        ))
    remotes = np.asarray([rng.choice([1, 3, 5, 9]) for _ in specs], np.int32)
    return ([RefRequest(**s) for s in specs], [RequestMessage(**s) for s in specs], remotes)


@pytest.mark.parametrize("n_flow,n_rule", MESHES, ids=MESH_IDS)
def test_kafka_sharded_parity(n_flow, n_rule):
    ref_reqs, reqs, remotes = kafka_case()
    want = ref_kafka.kafka_verdicts(ref_kafka.build_kafka_model(kafka_rows(ref=True)),
                                    ref_kafka.encode_requests(ref_reqs), remotes)
    model = mesh_kafka_model(kafka_rows(), cpu_mesh(n_flow, n_rule))
    assert isinstance(model, ShardedKafkaModel)
    _eq(model(encode_requests(reqs), remotes), want)


# --- K21 / K22 against the reference's psum / pmin ----------------------------------


def _ref_merge(n_rule, allow_parts, rule_parts, offsets):
    """The reference's own merge expressions (rulesharding.py:494-498,
    :553-560) under shard_map over n_rule of the 8 virtual CPU devices."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:n_rule]), ("rules",))

    @partial(ref_rs.shard_map, mesh=mesh, in_specs=(P("rules"), P("rules"), P("rules")),
             out_specs=(P(), P()))
    def step(a, r, off):
        a, r, off = a[0], r[0], off[0]
        cand = jnp.where(r >= 0, r + off, jnp.int32(ref_rs._NO_MATCH))
        cand = jax.lax.pmin(cand, "rules")
        allow = jax.lax.psum(a.astype(jnp.int32), "rules") > 0
        return allow, jnp.where(allow, cand, jnp.int32(-1))

    return step(jnp.asarray(allow_parts), jnp.asarray(rule_parts), jnp.asarray(offsets))


@pytest.mark.parametrize("n_rule", [1, 2, 3, 8])
@pytest.mark.parametrize("f", [1, 37, 256])
def test_shard_reduce_plain_matches_reference_psum_pmin(n_rule, f):
    rng = np.random.default_rng(100 * n_rule + f)
    allow_parts = rng.random((n_rule, f)) < 0.3
    rule_parts = np.where(allow_parts, rng.integers(0, 40, (n_rule, f)), -1).astype(np.int32)
    # allowed by a shard that names no row: the INT32_MAX case
    ghost = rng.random((n_rule, f)) < 0.1
    allow_parts |= ghost
    rule_parts[ghost] = -1
    offsets = np.sort(rng.integers(0, 1000, n_rule)).astype(np.int32)
    offsets[0] = 0
    want_a, want_r = _ref_merge(n_rule, allow_parts, rule_parts, offsets)
    a, r = shard_reduce(torch.from_numpy(allow_parts), torch.from_numpy(rule_parts),
                        torch.from_numpy(offsets))
    _eq(a, want_a)
    _eq(r, want_r)
    _eq(shard_reduce(torch.from_numpy(allow_parts)), want_a)
    if ghost.any():
        assert (np.asarray(want_r) == np.iinfo(np.int32).max).any() or not (
            ghost & ~(rule_parts >= 0).any(axis=0)).any()


def test_shard_reduce_int32_max_where_no_shard_names_a_row():
    allow_parts = torch.tensor([[True, False, False], [False, False, True]])
    rule_parts = torch.tensor([[-1, -1, -1], [-1, -1, 4]], dtype=torch.int32)
    offsets = torch.tensor([0, 10], dtype=torch.int32)
    allow, rule = shard_reduce_plain(allow_parts, rule_parts, offsets)
    assert allow.tolist() == [True, False, True]
    assert rule.tolist() == [2**31 - 1, -1, 14]
    want_a, want_r = _ref_merge(2, allow_parts.numpy(), rule_parts.numpy(), offsets.numpy())
    _eq(rule, want_r)
    _eq(allow, want_a)


@pytest.mark.parametrize("n_rule", [1, 2, 4])
def test_kafka_shard_combine_plain_matches_reference(n_rule):
    """K22's plain version against the reference's psum of the partials
    then ``kafka_combine``, with overflow rows and topic counts 0 and 8."""
    from jax.sharding import Mesh, PartitionSpec as P

    rng = np.random.default_rng(n_rule)
    f, t = 200, 8
    simple = rng.random((n_rule, f)) < 0.1
    cover = rng.random((n_rule, f, t)) < 0.6
    topic_count = rng.integers(0, 10, f).astype(np.int32)
    topic_count[:3] = [0, 8, 9]
    overflow = rng.random(f) < 0.1
    mesh = Mesh(np.asarray(jax.devices()[:n_rule]), ("rules",))

    @partial(ref_rs.shard_map, mesh=mesh, in_specs=(P("rules"), P("rules"), P(), P()),
             out_specs=P())
    def step(s, c, tc, ov):
        s = jax.lax.psum(s[0].astype(jnp.int32), "rules") > 0
        c = jax.lax.psum(c[0].astype(jnp.int32), "rules") > 0
        return ref_kafka.kafka_combine(s, c, tc, ov)

    want = step(jnp.asarray(simple), jnp.asarray(cover), jnp.asarray(topic_count),
                jnp.asarray(overflow))
    got = kafka_shard_combine(*(torch.from_numpy(x) for x in (simple, cover, topic_count, overflow)))
    _eq(got, want)
    _eq(kafka_shard_combine_plain(*(torch.from_numpy(x) for x in
                                    (simple, cover, topic_count, overflow))), want)


def _ref_combine(simple, cover, topic_count, overflow):
    """The reference's merge on R shards' partials: psum (a sum over the
    shard axis) > 0, then ``kafka_combine``; any nonzero byte is true."""
    s = jnp.sum(jnp.asarray(simple != 0).astype(jnp.int32), axis=0) > 0
    c = jnp.sum(jnp.asarray(cover != 0).astype(jnp.int32), axis=0) > 0
    return ref_kafka.kafka_combine(s, c, jnp.asarray(topic_count), jnp.asarray(overflow != 0))


@pytest.mark.parametrize("t", [1, 3, 8, 13])
@pytest.mark.parametrize("f", [1, 3, 4099])
@pytest.mark.parametrize("n_rule", [1, 4, 9])
def test_kafka_shard_combine_plain_matches_reference_any_t(n_rule, f, t):
    """K22's plain version against the reference's psum then
    ``kafka_combine`` at T = 1, 3, 8 and 13, topic counts -1, 0, T and
    T + 1, R = 9 (past the kernel's template shard counts) and F = 1, 3
    and 4,099 (merge_cases, tolerance 0)."""
    import merge_cases as mc

    rng = np.random.default_rng(97 * n_rule + 13 * t + f)
    simple, cover, tc, ov = mc.combine_case(rng, n_rule, f, t)
    want = _ref_combine(simple, cover, tc, ov)
    args = [torch.from_numpy(simple != 0), torch.from_numpy(cover != 0), torch.from_numpy(tc),
            torch.from_numpy(ov != 0)]
    _eq(kafka_shard_combine_plain(*args), want)
    _eq(kafka_shard_combine(*args, path="general"), want)
    assert set(tc[: min(f, 4)].tolist()) == set([-1, 0, t, t + 1][: min(f, 4)])


def test_kafka_shard_combine_plain_counts_any_nonzero_byte_true():
    """A bool tensor whose bytes hold 2 or 255 (a view of other data) is
    true wherever a byte is nonzero, in the plain version as in the
    reference's psum."""
    import merge_cases as mc

    rng = np.random.default_rng(5)
    simple, cover, tc, ov = mc.combine_case(rng, 3, 257, 8)
    assert (simple > 1).any() and (cover > 1).any() and (ov > 1).any()
    dirty = [torch.from_numpy(simple).view(torch.bool), torch.from_numpy(cover).view(torch.bool),
             torch.from_numpy(tc), torch.from_numpy(ov).view(torch.bool)]
    _eq(kafka_shard_combine_plain(*dirty), _ref_combine(simple, cover, tc, ov))


@pytest.mark.parametrize("t", [1, 8, 13])
@pytest.mark.parametrize("f", [1, 3, 4, 4099])
def test_combine_variant_follows_the_launchers_rule(f, t):
    """combine_variant, the mirror of shard_reduce.cu's combine_pick:
    "flow" where T = 8 and cover is 8-byte aligned, else "general", on
    views at each COMBINE_OFFSETS alignment and with cover alone moved;
    the wrapper's output equals the reference's at each (the plain
    version here)."""
    import merge_cases as mc

    text = (kernels.CSRC / "shard_reduce.cu").read_text()
    assert "return flow_ok(a) ? kCombineFlow : kCombineGeneral;" in text
    assert "bool flow_ok(const CombineArgs& a) { return a.T == 8 && aligned(a.cover, 8); }" in text
    rng = np.random.default_rng(f + t)
    arrays = mc.combine_case(rng, 2, f, t)
    offsets = list(mc.COMBINE_OFFSETS) + [(0, 8, 0, 0), (0, 4, 0, 0), (0, 0, 4, 0), (0, 0, 0, 2)]
    for offs in offsets:
        s, c, tc, ov = (mc.at_offset(a, o, "cpu", d) for a, o, d in
                        zip(arrays, offs, (torch.bool, torch.bool, torch.int32, torch.bool)))
        assert rs.combine_variant(c) == ("flow" if t == 8 and offs[1] % 8 == 0 else "general"), offs
        _eq(rs.kafka_shard_combine(s, c, tc, ov), _ref_combine(*arrays))


def test_merge_wrappers_check_their_inputs():
    a = torch.zeros((2, 4), dtype=torch.bool)
    with pytest.raises(TypeError):
        shard_reduce(a.to(torch.int32))
    with pytest.raises(ValueError):
        shard_reduce(a, torch.zeros((2, 3), dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        shard_reduce(torch.zeros((0, 4), dtype=torch.bool))
    with pytest.raises(ValueError):
        kafka_shard_combine(a, torch.zeros((2, 3, 8), dtype=torch.bool),
                            torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="path"):
        kafka_shard_combine(a, torch.zeros((2, 4, 8), dtype=torch.bool),
                            torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.bool),
                            path="fast")


# --- convert: the reference's stacked models into the port ----------------------


def _automaton_leaves(tab):
    if tab is None:
        return None
    if isinstance(tab, RefDfa):
        keys = ["cls_lo", "cls_hi", "delta_id", "start_1h", "accept_mask", "accept_final_mask"]
    else:
        keys = ["delta_flat", "classmap", "start", "accept_t", "accept_final_t"]
    return {k: np.asarray(getattr(tab, k)) for k in keys}


def _family_leaves(family, m):
    if family == "r2d2":
        out = {k: np.asarray(getattr(m, k))
               for k in ("cmd_needle", "cmd_len", "cmd_any", "remote_ids", "any_remote")}
        out.update(_automaton_leaves(m.nfa))
        return out
    if family == "dns":
        out = {k: np.asarray(getattr(m, k)) for k in DNS_TABLES}
        out["nfa"] = _automaton_leaves(m.nfa)
        return out
    out = {k: np.asarray(getattr(m, k)) for k in HTTP_TABLES}
    out["line_nfa"] = _automaton_leaves(m.line_nfa)
    out["head_nfa"] = _automaton_leaves(m.head_nfa)
    return out


def _ref_sharded(family, n_flow, n_rule):
    """(reference ShardedVerdictModel, batch, reference outputs): its
    sharded step's, except for DNS, whose sharded step does not trace
    under this jax (the scan carry's varying-axes check, as
    test_dns.py::test_mesh_rebinds_engine_built_while_demoted shows): there its single-device
    fallback's, which the parity contract makes the same."""
    mesh = ref_flow_mesh(n_flow=n_flow, n_rule=n_rule, devices=jax.devices()[: n_flow * n_rule])
    if family == "r2d2":
        ref_pol, _ = attr_policies()
        model = ref_rs.mesh_r2d2_model(ref_pol, True, 80, mesh)
        data, lengths, remotes, _ = _attr_batch()
    elif family == "dns":
        model = ref_rs.mesh_model_from_family_rows("dns", dns_rows(ref=True), mesh)
        data, lengths, remotes = _dns_batch()
        return model, (data, lengths, remotes), model.fallback.verdicts_attr(data, lengths, remotes)
    else:
        model = ref_rs.mesh_http_model_from_rows(http_rows(ref=True), mesh)
        data, lengths, remotes = _http_batch(32)
    return model, (data, lengths, remotes), model.verdicts_attr(data, lengths, remotes)


@pytest.mark.parametrize("family", ["r2d2", "dns", "http"])
@pytest.mark.parametrize("n_flow,n_rule", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_convert_sharded_model_serves_the_reference_step(family, n_flow, n_rule):
    ref_model, args, want = _ref_sharded(family, n_flow, n_rule)
    static = fb_static = None
    if family == "http":
        s0 = ref_model.stacked
        static = dict(n_rules=s0.n_rules, has_method_rx=s0.has_method_rx,
                      has_path_rx=s0.has_path_rx)
        fb = ref_model.fallback
        fb_static = dict(n_rules=fb.n_rules, has_method_rx=fb.has_method_rx,
                         has_path_rx=fb.has_path_rx)
    model = sharded_model_from_numpy(
        family, _family_leaves(family, ref_model.stacked), np.asarray(ref_model.offsets),
        cpu_mesh(n_flow, n_rule), fallback_leaves=_family_leaves(family, ref_model.fallback),
        match_kinds=ref_model.match_kinds, static=static, fallback_static=fb_static,
    )
    assert model.n_shards == n_rule and model.match_kinds == tuple(ref_model.match_kinds)
    for g, w in zip(model.verdicts_attr(*args), want):
        _eq(g, w, family)
    for g, w in zip(model.fallback.verdicts_attr(*args), want):
        _eq(g, w, f"{family} fallback")


def test_convert_sharded_kafka_serves_the_reference_step():
    ref_mesh = ref_flow_mesh(n_flow=2, n_rule=2, devices=jax.devices()[:4])
    ref_model = ref_rs.mesh_kafka_model(kafka_rows(ref=True), ref_mesh)
    ref_reqs, reqs, remotes = kafka_case(seed=9)
    want = ref_model(ref_kafka.encode_requests(ref_reqs), remotes)
    model = sharded_kafka_model_from_numpy(
        jax.tree_util.tree_leaves(ref_model.stacked), cpu_mesh(2, 2),
        fallback_leaves=jax.tree_util.tree_leaves(ref_model.fallback),
    )
    batch = encode_requests(reqs)
    _eq(model(batch, remotes), want)
    _eq(model.fallback(batch, remotes), want)


# --- the model surface ------------------------------------------------------------


def test_sharded_model_surface():
    mesh = cpu_mesh(2, 2)
    model = mesh_model_from_family_rows(
        "r2d2", [(frozenset({1}), "READ", "/a.*"), (frozenset(), "HALT", "")], mesh
    )
    assert model.n_shards == 2 and model.dispatch_bare() is model
    assert model.device == torch.device("cpu") and not model.spans_cards
    assert tuple(model.remote_ids.shape) == (2, 8, 32)
    # one shared copy per shard on a virtual mesh: no per-slot copies
    assert model.slots[0][0] is model.slots[1][0] is model.stacked[0]
    with pytest.raises(ValueError, match="rule shards"):
        ShardedVerdictModel(model.stacked, shard_offsets(2, 2), cpu_mesh(1, 4), "r2d2")
    with pytest.raises(ValueError, match="family"):
        ShardedVerdictModel(model.stacked, shard_offsets(2, 2), mesh, "cassandra")


def test_entry_dryrun_multichip_on_cpu_slots():
    from cilium_tpu_torch.entry import dryrun_multichip

    for n, n_rule in ((4, None), (4, 4), (8, None), (1, None)):
        out = dryrun_multichip(n, device="cpu", n_rule=n_rule)
        assert out["allow"] == [True, False, True, False]
        assert out["seq"][0][0] and out["seq"][1][1]


def test_entry_sharding_inputs_match_reference_bench():
    import bench
    from cilium_tpu_torch import entry

    for got, want in zip(entry.mesh_bench_batch(100), bench._mesh_bench_batch(100)):
        assert np.array_equal(got, want)
    rows = entry.rules_100k_rows(500)
    assert len(rows) == 500 and rows[-1][1].method == "HEAD" and not rows[-1][0]
    assert rows[7][1].path == "/p000007" and rows[7][1].method == "DELETE"
    data, lengths, remotes = entry.rules_100k_batch(8)
    assert bytes(data[1, : lengths[1]]).startswith(b"HEAD ")
    assert bytes(data[0, : lengths[0]]).startswith(b"PATCH ")
