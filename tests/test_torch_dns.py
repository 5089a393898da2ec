"""The port's DNS slice at device="cpu" against the JAX package.

Same rules, same numpy batches, same feeds: the port's frame and QNAME
walk (all six outputs, the dotted rows included), verdicts, rule
attribution, NPDS-built and converted models, invariance claims, engine
op/inject sequences and the streaming parser copy must equal the JAX
package's (tolerance 0: every output is bool or int).  The plain PyTorch
versions run here; the card's kernels K8 and K9 are held against them in
tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from cilium_tpu.models import dns as ref_dns
from cilium_tpu.ops.dfa import DeviceDfa as RefDfa
from cilium_tpu.policy.invariance import invariant_verdict as ref_invariant_verdict
from cilium_tpu.proxylib import NetworkPolicy as RefNetworkPolicy
from cilium_tpu.proxylib import PortNetworkPolicy as RefPortNetworkPolicy
from cilium_tpu.proxylib import PortNetworkPolicyRule as RefPortNetworkPolicyRule
from cilium_tpu.proxylib.parsers.dns import DnsParser as RefDnsParser
from cilium_tpu.proxylib.parsers.dns import DnsRule as RefDnsRule
from cilium_tpu.proxylib.policy import compile_policy as ref_compile_policy
from cilium_tpu.runtime.dnsengine import DnsBatchEngine as RefEngine
from cilium_tpu_torch.convert import DNS_TABLES, dns_model_from_numpy
from cilium_tpu_torch.entry import dns_batch, dns_bench_policy, dns_queries
from cilium_tpu_torch.models.base import ConstVerdict
from cilium_tpu_torch.models.dns import (
    DNS_MIN_FRAME,
    DnsBatchModel,
    build_dns_model,
    build_dns_model_from_rows,
    collect_dns_policy_rows,
    dns_hits,
    dns_name,
    dns_name_plain,
    dns_verdicts,
    dns_verdicts_attr,
)
from cilium_tpu_torch.ops.rxsearch import DeviceDfa, DeviceNfa
from cilium_tpu_torch.policy.invariance import invariant_verdict
from cilium_tpu_torch.proxylib import (
    NetworkPolicy,
    PortNetworkPolicy,
    PortNetworkPolicyRule,
    compile_policy,
)
from cilium_tpu_torch.proxylib.accesslog import MemoryAccessLogger
from cilium_tpu_torch.proxylib.parsers.dns import (
    DNS_QNAME_OFF,
    MAX_LABELS,
    DnsParser,
    DnsRequestData,
    DnsRule,
    encode_dns_query,
    parse_dns_query,
)
from cilium_tpu_torch.proxylib.types import DROP, MORE, PASS
from cilium_tpu_torch.runtime.dnsengine import DnsBatchEngine


@pytest.fixture(autouse=True, scope="module")
def _reference_rule_parsers():
    """tests/test_proxylib.py leaves a dummy rule parser in the
    reference's registry; these tests compile DNS policies through the
    reference, so they put its real parsers back first."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.cassandra import cassandra_rule_parser
    from cilium_tpu.proxylib.parsers.dns import dns_rule_parser
    from cilium_tpu.proxylib.parsers.memcached import memcache_rule_parser

    register_l7_rule_parser("dns", dns_rule_parser)
    register_l7_rule_parser("cassandra", cassandra_rule_parser)
    register_l7_rule_parser("memcache", memcache_rule_parser)


# tests/test_dns_model.py's fuzz rows (:107-114) and a second set with a
# pattern that needs the NFA, an always-match row first and remotes.
ROW_SETS = {
    "fuzz": [
        ({7}, dict(name="www.example.com")),
        ((), dict(pattern="*.svc.cluster.local")),
        ({7, 9}, dict(regex="^cdn[0-9]+[.]edge[.]net$")),
        ({3}, None),
        ((), dict(name="api.internal")),
    ],
    "exact-only": [
        ((), dict(name="www.example.com")),
        ({1}, dict(name="a.b")),
        ((), dict(name="x" * 63 + ".y")),
    ],
    "nfa": [
        ({9}, None),
        ((), dict(regex="(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)[.]x$")),
        ({1, 3}, dict(pattern="www.*.com")),
        ((), dict()),
    ],
}
NAMES = [
    "www.example.com", "WWW.EXAMPLE.COM", "example.com",
    "a.svc.cluster.local", "x.y.svc.cluster.local", "svc.cluster.local",
    "cdn42.edge.net", "cdnx.edge.net", "api.internal", "api.internal2",
    "", "a" * 63, "a.b", "A.B", "x" * 63 + ".y", "www.foo.com",
    "www.a.b.com", "abaaaaaaaa.x", "bbbbbbbbb.x", "Z.q",
]
REMOTES = (1, 3, 7, 9)


def rows_for(name, ref=False):
    cls = RefDnsRule if ref else DnsRule
    return [
        (frozenset(rs), None if kw is None else cls(**kw))
        for rs, kw in ROW_SETS[name]
    ]


def both_models(name, bucket=True):
    ref = ref_dns.build_dns_model_from_rows(rows_for(name, ref=True), bucket=bucket)
    port = build_dns_model_from_rows(rows_for(name), bucket=bucket, device="cpu")
    return ref, port


def fuzz_frames(rng, n=200, names=NAMES):
    """tests/test_dns_model.py's _fuzz_frames mix (:117-140) over more
    names, plus the traps: deep names, truncated frames, pointers inside
    the name, oversized labels past the first, trailing bytes."""
    frames = []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.55:
            frames.append(encode_dns_query(rng.choice(names)))
        elif roll < 0.65:  # compression pointer / oversized label
            bad = bytearray(encode_dns_query(rng.choice(names) or "x"))
            bad[DNS_QNAME_OFF] = rng.choice([0xC0, 64, 255])
            frames.append(bytes(bad))
        elif roll < 0.72:  # qdcount 0
            frames.append(encode_dns_query(rng.choice(names), qdcount=0))
        elif roll < 0.79:  # random garbage message with a coherent prefix
            body = bytes(rng.randrange(256) for _ in range(rng.randrange(13, 40)))
            frames.append(len(body).to_bytes(2, "big") + body)
        elif roll < 0.84:  # 40 labels pass, 41 fail
            depth = rng.choice([MAX_LABELS - 1, MAX_LABELS, MAX_LABELS + 1])
            frames.append(encode_dns_query(".".join("a" for _ in range(depth))))
        elif roll < 0.89:  # a bad byte in a later label-length position
            f = bytearray(encode_dns_query("ab.cd.ef"))
            f[DNS_QNAME_OFF + 3] = rng.choice([0xC0, 64, 0x3F, 1])
            frames.append(bytes(f))
        elif roll < 0.94:  # QTYPE/QCLASS cut short (prefix shortened too)
            f = bytearray(encode_dns_query(rng.choice(names)))
            cut = rng.randrange(1, 5)
            f = f[:-cut]
            f[0:2] = (len(f) - 2).to_bytes(2, "big")
            frames.append(bytes(f))
        else:  # frame followed by trailing bytes (pipelined/garbage)
            frames.append(encode_dns_query(rng.choice(names)) + b"\x00\x05AB")
    return frames


def batch(frames, width=None):
    width = width or max(8, max((len(f) for f in frames), default=8))
    data = np.zeros((len(frames), width), np.uint8)
    lens = np.zeros(len(frames), np.int32)
    for i, f in enumerate(frames):
        row = np.frombuffer(f[:width], np.uint8)
        data[i, : len(row)] = row
        lens[i] = len(row)
    return data, lens


def _eq(port, ref, what=""):
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(ref)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), what


def _host_walk(rows, frame, remote):
    """The oracle's first-match walk over flattened rows."""
    name = parse_dns_query(frame)
    req = DnsRequestData(name=name if name is not None else "", valid=name is not None)
    for j, (rs, rule) in enumerate(rows):
        if rs and remote not in rs:
            continue
        if rule is None or rule.matches(req):
            return True, j
    return False, -1


# --- K8: frame + QNAME walk ----------------------------------------------------


def _byte_soup(seed, f=300, l=48):
    """Rows of DNS-shaped and random bytes at lengths around and past the
    prefix, with upper-case bytes everywhere (the fold covers the row)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"\x00\x01\x02\x03\x05\x3f\x40\xc0AZaz.-", np.uint8)
    data = rng.choice(alphabet, size=(f, l)).astype(np.uint8)
    data[:, 0] = 0
    data[:, 1] = rng.integers(0, l + 4, size=f)
    data[:, 6] = 0
    data[:, 7] = rng.integers(0, 3, size=f)
    lengths = rng.integers(0, l + 1, size=f).astype(np.int32)
    return data, lengths


@pytest.mark.parametrize("width", [None, 16, 18, 19, 20, 64])
def test_name_span_matches_reference(width):
    frames = fuzz_frames(random.Random(29 + (width or 0)))
    data, lens = batch(frames, width)
    got = dns_name(torch.from_numpy(data), torch.from_numpy(lens))
    want = ref_dns._dns_name_span(data, lens)
    for field, g, w in zip(got._fields, got, want):
        _eq(g, w, f"{field} L={data.shape[1]}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_name_span_on_byte_soup_matches_reference(seed):
    data, lens = _byte_soup(seed)
    got = dns_name_plain(torch.from_numpy(data), torch.from_numpy(lens))
    want = ref_dns._dns_name_span(data, lens)
    for field, g, w in zip(got._fields, got, want):
        _eq(g, w, field)


def test_name_span_traps():
    """Pinned before the kernel: below DNS_MIN_FRAME the row comes back
    unfolded with zero spans; the fold covers header bytes and bytes past
    the name; rows invalid from the start mark no separator; separators
    marked before a later invalidation stay '.'; span_start is always 15
    and span_end falls back to 15."""
    upper = encode_dns_query("AB.CD")
    data, lens = batch([upper], 16)
    name = dns_name(torch.from_numpy(data), torch.from_numpy(lens))
    assert 16 < DNS_MIN_FRAME
    assert torch.equal(name.dotted, torch.from_numpy(data))
    assert not name.complete.any() and not name.valid.any()
    assert name.span_start.tolist() == [0] and name.span_end.tolist() == [0]

    hdr = bytearray(encode_dns_query("AB.CD", qid=0x4142))  # id "AB"
    cut = bytearray(encode_dns_query("ab.cd"))
    cut[DNS_QNAME_OFF + 3] = 0xC0  # second label: a pointer
    qd0 = encode_dns_query("AB.CD", qdcount=0)
    frames = [bytes(hdr) + b"ZZ", bytes(cut), qd0]
    data, lens = batch(frames, 40)
    name = dns_name(torch.from_numpy(data), torch.from_numpy(lens))
    rows = [bytes(r) for r in name.dotted.numpy()]
    assert rows[0][2:4] == b"ab"  # the header id folds
    assert rows[0][DNS_QNAME_OFF:DNS_QNAME_OFF + 6] == b".ab.cd"
    assert name.valid.tolist() == [True, False, False]
    assert name.span_start.tolist() == [15, 15, 15]
    assert name.span_end.tolist() == [20, 15, 15]
    assert rows[1][DNS_QNAME_OFF] == ord(".")  # marked before the pointer
    assert rows[1][DNS_QNAME_OFF + 3] == 0xC0  # the pointer itself stays
    assert rows[2][DNS_QNAME_OFF] == 2  # invalid from the start: no '.'
    assert rows[2][DNS_QNAME_OFF + 1:DNS_QNAME_OFF + 3] == b"ab"
    want = ref_dns._dns_name_span(data, lens)
    for field, g, w in zip(name._fields, name, want):
        _eq(g, w, field)


def test_walk_reads_below_msg_len_only():
    """A label chain that runs past msg_len (but not past L) is invalid:
    the walk reads only below min(msg_len, L), and the final QTYPE test
    uses msg_len, not L."""
    f = bytearray(encode_dns_query("abc.de"))
    f[0:2] = (len(f) - 2 - 8).to_bytes(2, "big")  # prefix ends inside the name
    g = bytearray(encode_dns_query("abc.de"))
    g[0:2] = (len(g) - 2 - 2).to_bytes(2, "big")  # QTYPE/QCLASS cut by msg_len
    data, lens = batch([bytes(f), bytes(g)], 64)
    name = dns_name(torch.from_numpy(data), torch.from_numpy(lens))
    assert name.complete.tolist() == [True, True]
    assert name.valid.tolist() == [False, False]
    want = ref_dns._dns_name_span(data, lens)
    for field, w_, g_ in zip(name._fields, want, name):
        _eq(g_, w_, field)


# --- verdicts and attribution ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(ROW_SETS))
@pytest.mark.parametrize("seed", [29, 30])
def test_verdicts_and_attr_match_reference_and_oracle(name, seed):
    rng = random.Random(seed)
    ref, port = both_models(name)
    frames = fuzz_frames(rng)
    remotes = np.asarray([rng.choice(REMOTES) for _ in frames], np.int32)
    data, lens = batch(frames)
    got = dns_verdicts_attr(port, data, lens, remotes)
    want = ref_dns.dns_verdicts_attr(ref, data, lens, remotes)
    for g, w in zip(got, want):
        _eq(g, w, name)
    plain = dns_verdicts(port, data, lens, remotes)
    for g, w in zip(plain, got[:3]):
        assert torch.equal(g, w)
    rows = rows_for(name)
    for i, f in enumerate(frames):
        assert (bool(got[2][i]), int(got[3][i])) == _host_walk(rows, f, int(remotes[i]))


def test_model_tiers_match_reference():
    """The port compiles the reference's automaton kind, and no automaton
    where no row uses one; match_kinds agree."""
    kinds = {}
    for name in ROW_SETS:
        ref, port = both_models(name)
        assert port.match_kinds == ref.match_kinds
        assert port.invariant_rows == ref.invariant_rows
        kinds[name] = type(port.nfa).__name__
        if port.nfa is not None:
            assert isinstance(ref.nfa, RefDfa) == isinstance(port.nfa, DeviceDfa)
    assert kinds == {"fuzz": "DeviceDfa", "exact-only": "NoneType", "nfa": "DeviceNfa"}


def test_incomplete_and_pipelined_rows():
    rows = [(frozenset(), None)]
    ref = ref_dns.build_dns_model_from_rows(rows)
    port = build_dns_model_from_rows(rows, device="cpu")
    f1, f2 = encode_dns_query("a.b"), encode_dns_query("c.d")
    frames = [f1[:1], f1[:-3], f1 + f2, f1, b""]
    data, lens = batch(frames)
    got = dns_verdicts_attr(port, data, lens, np.ones(len(frames), np.int32))
    want = ref_dns.dns_verdicts_attr(ref, data, lens, np.ones(len(frames), np.int32))
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[0].tolist() == [False, False, True, True, False]
    assert got[1].tolist()[2:4] == [len(f1), len(f1)]


def test_min_frame_and_root():
    rows = [(frozenset(), "a")]
    ref = ref_dns.build_dns_model_from_rows([(s, RefDnsRule(name=n)) for s, n in rows])
    port = build_dns_model_from_rows([(s, DnsRule(name=n)) for s, n in rows], device="cpu")
    tiny = (3).to_bytes(2, "big") + b"xyz"
    root = encode_dns_query("")
    data, lens = batch([tiny, root, encode_dns_query("a")], width=32)
    rem = np.ones(3, np.int32)
    got = dns_verdicts_attr(port, data, lens, rem)
    want = ref_dns.dns_verdicts_attr(ref, data, lens, rem)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[2].tolist() == [False, False, True]


def test_long_exact_name_never_prefix_matches():
    long_name = ".".join(["a" * 60] * 5)
    imposter = long_name[:-1] + "b"
    rows_kw = [((), dict(name=long_name))]
    ref = ref_dns.build_dns_model_from_rows([(frozenset(), RefDnsRule(**kw)) for _, kw in rows_kw])
    port = build_dns_model_from_rows([(frozenset(), DnsRule(**kw)) for _, kw in rows_kw], device="cpu")
    assert port.name_needle.shape[1] >= len(long_name)
    data, lens = batch([encode_dns_query(long_name), encode_dns_query(imposter),
                        encode_dns_query(long_name.upper())])
    rem = np.ones(3, np.int32)
    got = dns_verdicts_attr(port, data, lens, rem)
    want = ref_dns.dns_verdicts_attr(ref, data, lens, rem)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[2].tolist() == [True, False, True]


@pytest.mark.parametrize("width", [16, 18])
def test_rows_below_min_frame_match_reference(width):
    """L < DNS_MIN_FRAME: nothing is complete, a byte-free row still
    allows (the reference's any over name_any rows), attribution agrees."""
    ref, port = both_models("nfa")
    frames = fuzz_frames(random.Random(3), n=40)
    data, lens = batch(frames, width)
    rem = np.asarray([REMOTES[i % 4] for i in range(len(frames))], np.int32)
    got = dns_verdicts_attr(port, data, lens, rem)
    want = ref_dns.dns_verdicts_attr(ref, data, lens, rem)
    for g, w in zip(got, want):
        _eq(g, w)
    assert not got[0].any() and got[2].any()


def test_pointers_deep_names_and_qdcount_zero():
    ref, port = both_models("fuzz")
    frames = []
    for name in ("www.example.com", "a.svc.cluster.local"):
        f = bytearray(encode_dns_query(name))
        f[DNS_QNAME_OFF] = 0xC0
        frames.append(bytes(f))
        frames.append(encode_dns_query(name, qdcount=0))
    frames.append(encode_dns_query(".".join("a" for _ in range(MAX_LABELS)) + ".svc.cluster.local"))
    frames.append(encode_dns_query(".".join("a" for _ in range(MAX_LABELS - 3)) + ".svc.cluster.local"))
    frames.append(encode_dns_query("www.example.com"))
    data, lens = batch(frames)
    rem = np.full(len(frames), 3, np.int32)
    rem[-1] = 7
    got = dns_verdicts_attr(port, data, lens, rem)
    want = ref_dns.dns_verdicts_attr(ref, data, lens, rem)
    for g, w in zip(got, want):
        _eq(g, w)
    name = dns_name(torch.from_numpy(data), torch.from_numpy(lens))
    assert name.valid.tolist() == [False] * 5 + [True, True]
    # identity 3's first admitting row is byte-free (row 3): it allows
    # even the invalid questions, at that row
    assert got[3].tolist()[:5] == [3] * 5
    assert got[3].tolist()[-1] == 0


def test_hits_need_the_automaton_exactly_when_the_model_has_one():
    _, port = both_models("exact-only")
    data, lens = batch([encode_dns_query("a.b")])
    name = dns_name(torch.from_numpy(data), torch.from_numpy(lens))
    rem = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="rx"):
        dns_hits(port, name, torch.zeros((1, port.n_rules), dtype=torch.bool), rem)
    assert dns_hits(port, name, None, rem)[1].tolist() == [1]  # "a.b" for remote 1


def test_model_tables_are_checked_once_at_build():
    _, port = both_models("fuzz")
    fields = {k: getattr(port, k) for k in (
        "nfa", "name_needle", "name_len", "name_any", "use_rx", "remote_ids", "any_remote")}
    with pytest.raises(TypeError, match="name_len"):
        DnsBatchModel(**{**fields, "name_len": port.name_len.to(torch.int64)})
    with pytest.raises(ValueError, match="use_rx"):
        DnsBatchModel(**{**fields, "use_rx": port.use_rx[:-1]})
    with pytest.raises(ValueError, match="nfa"):
        DnsBatchModel(**{**fields, "nfa": both_models("nfa", bucket=False)[1].nfa})


def test_wrappers_refuse_other_devices():
    _, port = both_models("fuzz")
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dns_name(torch.zeros((4, 32), dtype=torch.uint8, device=meta),
                 torch.zeros((4,), dtype=torch.int32, device=meta))
    name = dns_name(torch.zeros((4, 32), dtype=torch.uint8), torch.zeros((4,), dtype=torch.int32))
    moved = name._replace(dotted=name.dotted.to(meta))
    with pytest.raises(ValueError, match="expected device"):
        dns_hits(port, moved, torch.zeros((4, port.n_rules), dtype=torch.bool),
                 torch.zeros((4,), dtype=torch.int32))


# --- NPDS, invariance, conversion and the entry batch -------------------------


DNS_NPDS = [
    {"remote_policies": [1, 2], "l7_rules": [
        {"matchName": "api.example.com"}, {"matchPattern": "*.svc.cluster.local"}]},
    {"l7_rules": [{"matchRegex": "^cdn[0-9]+[.]edge[.]net$"}, {}]},
    {"remote_policies": [3]},
]


def _both_policies(port_rules=DNS_NPDS, wildcard=()):
    out = []
    for (np_, pnp, pnpr), compile_ in (
        ((RefNetworkPolicy, RefPortNetworkPolicy, RefPortNetworkPolicyRule), ref_compile_policy),
        ((NetworkPolicy, PortNetworkPolicy, PortNetworkPolicyRule), compile_policy),
    ):
        ports = [pnp(port=53, rules=[pnpr(l7_proto="dns", **r) for r in port_rules])]
        if wildcard:
            ports.append(pnp(port=0, rules=[pnpr(l7_proto="dns", **r) for r in wildcard]))
        out.append(compile_(np_(name="dnsp", policy=2, ingress_per_port_policies=ports)))
    return out


@pytest.mark.parametrize("wildcard", [(), ({"l7_rules": [{"matchName": "wild.card"}]},)])
def test_model_built_through_npds_matches_reference_and_oracle(wildcard):
    ref_policy, policy = _both_policies(wildcard=wildcard)
    ref = ref_dns.build_dns_model(ref_policy, True, 53)
    port = build_dns_model(policy, True, 53, device="cpu")
    assert port.match_kinds == ref.match_kinds
    assert port.invariant_rows == ref.invariant_rows
    rows = collect_dns_policy_rows(policy, True, 53)
    ref_rows = ref_dns.collect_dns_policy_rows(ref_policy, True, 53)
    assert [(rs, None if r is None else (r.name, r.pattern, r.regex)) for rs, r in rows] == \
        [(rs, None if r is None else (r.name, r.pattern, r.regex)) for rs, r in ref_rows]
    rng = random.Random(17)
    frames = fuzz_frames(rng, names=NAMES + ["wild.card", "api.example.com", "pod1.svc.cluster.local"])
    remotes = np.asarray([rng.randrange(0, 5) for _ in frames], np.int32)
    data, lens = batch(frames)
    got = dns_verdicts_attr(port, data, lens, remotes)
    want = ref_dns.dns_verdicts_attr(ref, data, lens, remotes)
    for g, w in zip(got, want):
        _eq(g, w)
    for i, f in enumerate(frames):
        q = parse_dns_query(f)
        req = DnsRequestData(name=q if q is not None else "", valid=q is not None)
        assert policy.matches_at(True, 53, int(remotes[i]), req) == (bool(got[2][i]), int(got[3][i]))
    for remote in range(6):
        assert invariant_verdict(port.invariant_rows, remote) == \
            ref_invariant_verdict(ref.invariant_rows, remote)


def test_npds_degenerate_ports_are_constant():
    _, policy = _both_policies(port_rules=[{"remote_policies": [1]}])
    assert build_dns_model(policy, True, 53, device="cpu") == ConstVerdict(True)
    assert build_dns_model(policy, True, 54, device="cpu") == ConstVerdict(False)
    assert build_dns_model(None, True, 53, device="cpu") == ConstVerdict(False)


def _automaton_leaves(tab):
    if isinstance(tab, RefDfa):
        keys = ["cls_lo", "cls_hi", "delta_id", "start_1h", "accept_mask", "accept_final_mask"]
    else:
        keys = ["delta_flat", "classmap", "start", "accept_t", "accept_final_t"]
    return {k: np.asarray(getattr(tab, k)) for k in keys}


@pytest.mark.parametrize("name", sorted(ROW_SETS))
def test_converted_model_gives_equal_verdicts(name):
    ref, _ = both_models(name)
    leaves = {k: np.asarray(getattr(ref, k)) for k in DNS_TABLES}
    leaves["nfa"] = _automaton_leaves(ref.nfa)
    model = dns_model_from_numpy(leaves, device="cpu", match_kinds=ref.match_kinds)
    assert model.invariant_rows is None and model.match_kinds == ref.match_kinds
    assert (model.nfa is None) == (name == "exact-only")
    rng = random.Random(5)
    frames = fuzz_frames(rng)
    remotes = np.asarray([rng.choice(REMOTES) for _ in frames], np.int32)
    data, lens = batch(frames)
    got = model.verdicts_attr(data, lens, remotes)
    want = ref_dns.dns_verdicts_attr(ref, data, lens, remotes)
    for g, w in zip(got, want):
        _eq(g, w, name)


def test_dns_bench_batch_matches_reference():
    """The entry's policy and batch are bench.py::bench_dns's: the same
    1,024 queries, verdicts equal to the reference model's."""
    msgs = dns_queries()
    assert len(msgs) == 1024
    port = build_dns_model(dns_bench_policy(), True, 53, device="cpu")
    ref = ref_dns.build_dns_model_from_rows([(frozenset(), RefDnsRule(**kw)) for kw in (
        dict(name="api.example.com"), dict(pattern="*.svc.cluster.local"),
        dict(regex="^cdn[0-9]+[.]edge[.]net$"))], bucket=True)
    data, lengths, remotes = dns_batch(2048)
    assert data.shape == (2048, 64) and lengths[1024] == len(msgs[0])
    got = dns_verdicts_attr(port, data, lengths, remotes)
    want = ref_dns.dns_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w)
    assert 0.6 < float(got[2].float().mean()) < 0.8


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dns_model(dns_bench_policy(), True, 53)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dns_model_from_rows([(frozenset(), DnsRule(name="a"))])


# --- the streaming parser copy ---------------------------------------------------


class _Conn:
    def __init__(self, rules, remote=1):
        self.rules = rules
        self.remote = remote
        self.logged = []

    def matches(self, req):
        return any(
            (r is None or r.matches(req))
            for rs, r in self.rules
            if not rs or self.remote in rs
        )

    def log(self, entry_type, **kw):
        self.logged.append((int(entry_type), kw))


def _parser_ops(parser_cls, rule_cls, feeds):
    conn = _Conn([(frozenset(), rule_cls(name="ok.com")), ({2}, rule_cls(pattern="*.x"))])
    p = parser_cls(conn)
    out = [tuple(int(v) for v in p.on_data(reply, False, [chunk])) for reply, chunk in feeds]
    return out, conn.logged


def test_parser_op_sequence_matches_reference():
    """tests/test_dns_model.py::test_parser_op_sequence's feeds, and more,
    through both parsers: the same ops and access-log entries."""
    f_ok, f_bad = encode_dns_query("OK.com"), encode_dns_query("no.com")
    bad = bytearray(encode_dns_query("a.x"))
    bad[DNS_QNAME_OFF] = 0xC0
    feeds = [
        (False, f_ok[:1]), (False, f_ok[:7]), (False, f_ok), (False, f_bad + f_ok),
        (True, f_bad), (True, f_bad[:1]), (False, bytes(bad)),
        (False, encode_dns_query("a.b.x")), (False, b""),
    ]
    got = _parser_ops(DnsParser, DnsRule, feeds)
    want = _parser_ops(RefDnsParser, RefDnsRule, feeds)
    assert got == want
    assert got[0][:5] == [(int(MORE), 1), (int(MORE), 1), (int(PASS), len(f_ok)),
                          (int(DROP), len(f_bad)), (int(PASS), len(f_bad))]


# --- the engine ----------------------------------------------------------------


def _engine_pair(name="fuzz", logger=False):
    ref, port = both_models(name)
    kw = lambda: dict(logger=MemoryAccessLogger()) if logger else {}  # noqa: E731
    return RefEngine(ref, **kw()), DnsBatchEngine(port, **kw())


def _drive(engines, feeds):
    outs = [[] for _ in engines]
    for rnd in feeds:
        for out, eng in zip(outs, engines):
            for fid, chunk, remote in rnd:
                eng.feed(fid, chunk, remote_id=remote)
            eng.pump()
            for fid, _, _ in rnd:
                ops, inj = eng.take_ops(fid)
                out.append((fid, [(int(op), n) for op, n in ops], inj, eng.flows[fid].last_rule_id))
    return outs


def _random_feeds(seed, n_flows=60):
    """Three rounds: several frames per flow cut at random points (across
    the prefix, mid-QNAME), invalid questions, long names that widen the
    width bucket, and a trailing partial prefix."""
    rng = random.Random(seed)
    rounds = [[], [], []]
    names = NAMES + ["x" * 60 + "." + "y" * 60 + "." + "z" * 60 + ".svc.cluster.local"]
    for fid in range(n_flows):
        frames = fuzz_frames(rng, n=rng.randrange(1, 5), names=names)
        stream = b"".join(frames) + (b"\x00" if fid % 7 == 0 else b"")
        c1 = rng.randrange(0, len(stream) + 1)
        c2 = rng.randrange(c1, len(stream) + 1)
        remote = rng.choice(REMOTES)
        for rnd, chunk in zip(rounds, (stream[:c1], stream[c1:c2], stream[c2:])):
            rnd.append((fid, chunk, remote))
    return rounds


@pytest.mark.parametrize("name", ["fuzz", "nfa"])
@pytest.mark.parametrize("seed", [1, 2])
def test_engine_ops_and_injects_match_reference(name, seed):
    ref, eng = _engine_pair(name, logger=True)
    feeds = _random_feeds(seed)
    got, want = _drive([eng, ref], feeds)
    assert got == want
    # the "nfa" set's last row allows every remote and name
    assert any(op == int(DROP) for _, ops, _, _ in got for op, _ in ops) == (name == "fuzz")
    assert all(inj == b"" for _, _, inj, _ in got)
    keys = ("entry_type", "source_security_id", "proto", "fields")
    assert [tuple(getattr(e, k) for k in keys) for e in eng.logger.entries] == \
        [tuple(getattr(e, k) for k in keys) for e in ref.logger.entries]


def test_engine_split_at_every_offset_matches_reference():
    """One pipelined pair of frames split at every byte offset, across the
    prefix and mid-QNAME."""
    stream = encode_dns_query("www.example.com") + encode_dns_query("evil.test")
    feeds = [[(i, stream[:i], 7) for i in range(len(stream) + 1)],
             [(i, stream[i:], 7) for i in range(len(stream) + 1)]]
    ref, eng = _engine_pair()
    got, want = _drive([eng, ref], feeds)
    assert got == want


def test_engine_feed_extract_and_settle_match_reference():
    ref, eng = _engine_pair()
    frames = [encode_dns_query("www.example.com"), encode_dns_query("a.svc.cluster.local")]
    stream = b"".join(frames)
    for e in (ref, eng):
        e.flow(5, 7)
    got = eng.feed_extract(5, stream[:-3], remote_id=7)
    want = ref.feed_extract(5, stream[:-3], remote_id=7)
    assert got == want and [m for m, _ in got] == [frames[0]]
    assert DnsBatchEngine.frame_row(got[0][0]) == frames[0]
    ops = eng.settle_entry(5, [(got[0][0], got[0][1], True, 0)], True)
    assert ops == ref.settle_entry(5, [(want[0][0], want[0][1], True, 0)], True)


def test_engine_model_failure_raises():
    _, eng = _engine_pair()

    class Broken(Exception):
        pass

    def boom(*args):
        raise Broken()

    eng.model = type("Failing", (), {"verdicts_attr": staticmethod(boom)})()
    eng.feed(1, encode_dns_query("a.b"), remote_id=1)
    with pytest.raises(Broken):
        eng.pump()
    assert eng.flows[1].ops == []


def test_engine_const_verdict_and_claims_match_reference():
    ref_policy, policy = _both_policies(port_rules=[{"remote_policies": [1]}])
    ref = RefEngine(ref_dns.build_dns_model(ref_policy, True, 53))
    eng = DnsBatchEngine(build_dns_model(policy, True, 53, device="cpu"))
    feeds = [[(1, encode_dns_query("a.b"), 1), (2, encode_dns_query("c.d")[:5], 2)]]
    got, want = _drive([eng, ref], feeds)
    assert got == want
    ref2, eng2 = _engine_pair()
    for remote in (1, 3, 7, 9, 11):
        assert eng2.verdict_invariant(remote) == ref2.verdict_invariant(remote)


def test_engine_failing_kernel_propagates_with_no_fallback(monkeypatch):
    """K8's wrapper on the kernel route with no kernel library raises; the
    plain version does not run in its place."""
    from cilium_tpu_torch import kernels

    _, eng = _engine_pair()

    def no_library(stem):
        raise RuntimeError(f"{stem}: no kernel library")

    monkeypatch.setattr(kernels, "on_cpu", lambda device: False)
    monkeypatch.setattr(kernels, "library", no_library)
    eng.feed(1, encode_dns_query("a.b"), remote_id=1)
    with pytest.raises(RuntimeError, match="dns_name: no kernel library"):
        eng.pump()
    assert eng.flows[1].ops == []
