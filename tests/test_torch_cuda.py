"""Port kernels on the card against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
Run them on the card with ``python -m pytest tests/test_torch_cuda.py -q``.
All outputs are bool or int, so every comparison is exact (tolerance 0).
This file imports no JAX, so it runs where only the port is installed.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from cilium_tpu_torch import kernels
from cilium_tpu_torch.models import cassandra as cass_mod
from cilium_tpu_torch.models import dns as dns_mod
from cilium_tpu_torch.models import http as http_mod
from cilium_tpu_torch.models import memcached as mc_mod
from cilium_tpu_torch.models import r2d2 as r2d2_mod
from cilium_tpu_torch.models.cassandra import (
    MAX_ACTION,
    build_cassandra_model,
    cassandra_hits,
    cassandra_hits_plain,
    encode_cassandra_batch,
)
from cilium_tpu_torch.models.dns import (
    build_dns_model_from_rows,
    dns_hits,
    dns_hits_plain,
    dns_name,
    dns_name_plain,
)
from cilium_tpu_torch.models.http import (
    build_http_model,
    http_frame,
    http_frame_plain,
    http_hits,
    http_hits_plain,
    http_lit,
    http_lit_plain,
)
from cilium_tpu_torch.kafka.request import RequestMessage
from cilium_tpu_torch.models import kafka as kafka_mod
from cilium_tpu_torch.models.kafka import (
    build_kafka_model,
    encode_requests,
    kafka_hits,
    kafka_rule_hits,
    kafka_verdicts_plain,
)
from cilium_tpu_torch.models.memcached import (
    TEXT_COMMANDS,
    build_memcache_model,
    encode_memcache_batch,
    memcache_hits,
    memcache_hits_plain,
)
from cilium_tpu_torch.models.r2d2 import (
    build_r2d2_model_from_rows,
    r2d2_frame,
    r2d2_frame_plain,
    r2d2_hits,
    r2d2_hits_plain,
)
from cilium_tpu_torch.ops import dfa as dfa_mod
from cilium_tpu_torch.ops import nfa as nfa_mod
from cilium_tpu_torch.ops.dfa import device_dfa, dfa_from_arrays, dfa_scan_plain, dfa_search_spans
from cilium_tpu_torch.ops.nfa import device_nfa, nfa_from_dense, nfa_scan_plain, nfa_search_spans
from cilium_tpu_torch.ops.rxsearch import automaton_search_spans
from cilium_tpu_torch.ops import seqdfa as seqdfa_mod
from cilium_tpu_torch.ops.dfa import dfa_search_batch
from cilium_tpu_torch.ops.seqdfa import (
    device_dfa_absorbing,
    seqdfa_apply,
    seqdfa_fold,
    seqdfa_fold_branches_plain,
    seqdfa_fold_plain,
    seqdfa_search_batch,
    seqdfa_search_batch_plain,
)
from cilium_tpu_torch.policy.api import PortRuleHTTP, PortRuleKafka
from cilium_tpu_torch.proxylib import (
    NetworkPolicy,
    PortNetworkPolicy,
    PortNetworkPolicyRule,
    compile_policy,
)
from cilium_tpu_torch.proxylib.parsers.dns import DNS_QNAME_OFF, MAX_LABELS, DnsRule, encode_dns_query
from cilium_tpu_torch.regex import compile_patterns
from cilium_tpu_torch.regex.dfa import compile_pattern_dfas
import dns_name_cases as dc
import kafka_cases as kc
from frame_cases import CARD_WIDTHS as FRAME_CARD_WIDTHS
from frame_cases import frame_batch, long_head_batch, on_card_at
import merge_cases as mc
import hits_cases as hc
import l7_hits_cases as lc

pytestmark = pytest.mark.cuda

DFA_PATTERNS = [
    "/public/.*", "", "^/public/", "\\.txt$", "/g07/[a-z0-9]+/item/.*",
    "^$", "a.c", "(ab|cd)+", "[^abc]", "^(GET|HEAD)$",
]
NFA_PATTERNS = ["/n00/(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)/x", "/g01/[a-z0-9]+/item/.*", ""]
ALPHABET = np.frombuffer(b"READ WRITE HALT /public/g07/item/x.txt\r\nab", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the plain versions are tested on the CPU")
    return torch.device("cuda")


def _batch(rng, f, l):
    data = rng.choice(ALPHABET, size=(f, l)).astype(np.uint8)
    lengths = rng.integers(0, l + 1, size=f).astype(np.int32)
    lengths[:4] = [0, l, 1, l - 1]
    data[1, l - 2 :] = [0x0D, 0x0A]  # CRLF in the last two columns
    data[2, l - 1] = 0x0D  # CR in the last column
    return data, lengths


def _spans(rng, lengths):
    a = rng.integers(0, lengths + 1)
    b = rng.integers(0, lengths + 1)
    return a.astype(np.int32), b.astype(np.int32)  # start >= end included


def _to(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("l", [64, 256, 67])
def test_frame_kernel_matches_plain(cuda, l):
    rng = np.random.default_rng(l)
    data, lengths = _batch(rng, 4099, l)
    d, n = _to(cuda, data, lengths)
    before = r2d2_mod._R2D2_FRAME.launches
    got = r2d2_frame(d, n)
    torch.cuda.synchronize()
    assert r2d2_mod._R2D2_FRAME.launches == before + 1
    want = r2d2_frame_plain(d, n)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("l", [64, 256])
def test_dfa_kernel_matches_plain(cuda, l):
    rng = np.random.default_rng(7 + l)
    dfa = device_dfa(compile_pattern_dfas(DFA_PATTERNS), cuda)
    data, lengths = _batch(rng, 3001, l)
    start, end = _spans(rng, lengths)
    d, s, e = _to(cuda, data, start, end)
    before = dfa_mod._DFA_SCAN.launches
    got = dfa_search_spans(dfa, d, s, e)
    torch.cuda.synchronize()
    assert dfa_mod._DFA_SCAN.launches == before + 1
    assert torch.equal(got, dfa_scan_plain(dfa, d, s, e))


def test_dfa_kernel_many_patterns_tiles(cuda):
    pats = [f"/g{j:02d}/[a-z0-9]+/item/.*" for j in range(37)]
    dfa = device_dfa(compile_pattern_dfas(pats), cuda)
    rng = np.random.default_rng(3)
    data, lengths = _batch(rng, 1000, 64)
    for i in range(0, 1000, 3):
        m = f"/g{i % 37:02d}/ab{i}/item/z".encode()
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = max(lengths[i], len(m))
    start, end = np.zeros_like(lengths), lengths
    d, s, e = _to(cuda, data, start, end)
    got = dfa_search_spans(dfa, d, s, e)
    want = dfa_scan_plain(dfa, d, s, e)
    assert torch.equal(got, want) and bool(want.any())


def test_nfa_kernel_matches_plain(cuda):
    rng = np.random.default_rng(11)
    nfa = device_nfa(compile_patterns(NFA_PATTERNS), cuda)
    data, lengths = _batch(rng, 2049, 64)
    for i in range(0, 2049, 5):
        m = b"/n00/" + rng.choice(np.frombuffer(b"ab", np.uint8), size=12).tobytes() + b"/x"
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = max(lengths[i], len(m))
    start, end = _spans(rng, lengths)
    start[::5] = 0
    end[::5] = lengths[::5]
    d, s, e = _to(cuda, data, start, end)
    before = nfa_mod._NFA_SCAN.launches
    got = nfa_search_spans(nfa, d, s, e)
    torch.cuda.synchronize()
    assert nfa_mod._NFA_SCAN.launches == before + 1
    want = nfa_scan_plain(nfa, d, s, e)
    assert torch.equal(got, want) and bool(want[:, 0].any())


def _random_dfa(rng, dev, r, s, c):
    """R random DFAs of S states over C classes, about 1 state in 10
    accepting (at least one a pattern)."""
    classmap = rng.integers(0, c, 256)
    classmap[:c] = np.arange(c)
    accept = rng.random((r, s)) < 0.1
    accept[np.arange(r), rng.integers(0, s, r)] = True
    return dfa_from_arrays(classmap, rng.integers(0, s, (r, s, c)), rng.integers(0, s, r),
                           accept, accept | (rng.random((r, s)) < 0.05), dev)


def _scan_batch(rng, dev, f, l, view=False):
    """Random bytes and spans: start >= end, start < 0 and end > L
    included; ``view`` puts the rows at a 3-byte offset into a larger
    buffer (a contiguous view whose rows are not 16-byte aligned)."""
    data = rng.integers(0, 256, (f, l)).astype(np.uint8)
    start = rng.integers(-2, l + 1, f).astype(np.int32)
    end = rng.integers(0, l + 9, f).astype(np.int32)
    start[:6] = [0, 0, 5, 3, l, -1]
    end[:6] = [l, 0, 2, l + 8, l, l]
    d = torch.from_numpy(data).to(dev)
    if view:
        buf = torch.zeros(f * l + 3, dtype=torch.uint8, device=dev)
        buf[3:] = d.reshape(-1)
        d = buf[3:].view(f, l)
        assert d.is_contiguous() and d.data_ptr() % 16 == 3
    return d, torch.from_numpy(start).to(dev), torch.from_numpy(end).to(dev)


def _one_launch(kernel, fn, *args):
    before = kernel.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return got


@pytest.mark.parametrize("r,s,c,es,tiles", [
    (1, 19, 9, 1, 1), (8, 19, 9, 1, 1), (33, 45, 19, 1, 1), (64, 45, 19, 1, 1),
    (9, 40, 20, 1, 1),
    (300, 128, 40, 1, 10),  # the tables exceed shared memory: 10 pattern tiles
    (5, 128, 256, 1, 2),    # S = 128 at C = 256: four lanes a flow, 2 tiles
    (200, 100, 5, 2, 2),    # 500 rows a tile: two-byte entries
])
@pytest.mark.parametrize("l", [64, 61])  # 61: the one-byte loads
def test_dfa_kernel_variants_match_plain(cuda, r, s, c, es, tiles, l):
    rng = np.random.default_rng(r * 1000 + s + l)
    dfa = _random_dfa(rng, cuda, r, s, c)
    assert dfa.scan_geom[3:] == (es, tiles)
    d, st, en = _scan_batch(rng, cuda, 2051 if r < 100 else 517, l)
    got = _one_launch(dfa_mod._DFA_SCAN, dfa_search_spans, dfa, d, st, en)
    want = dfa_scan_plain(dfa, d, st, en)
    assert torch.equal(got, want) and 0 < float(want.float().mean()) < 1


@pytest.mark.parametrize("r", [8, 64])
def test_dfa_kernel_row_view_matches_plain(cuda, r):
    rng = np.random.default_rng(40 + r)
    dfa = _random_dfa(rng, cuda, r, 45, 19)
    d, st, en = _scan_batch(rng, cuda, 1500, 64, view=True)
    got = _one_launch(dfa_mod._DFA_SCAN, dfa_search_spans, dfa, d, st, en)
    assert torch.equal(got, dfa_scan_plain(dfa, d, st, en))


def _random_nfa(rng, dev, c, s, r, edges):
    """A union NFA of S states over C classes with about ``edges`` random
    edges (about one a (class, state) row keeps the live set from dying
    out or filling up), 4 start states and 3 accepting states a pattern."""
    delta = np.zeros((c, s, s), bool)
    delta[rng.integers(0, c, edges), rng.integers(0, s, edges), rng.integers(0, s, edges)] = True
    classmap = rng.integers(0, c, 256)
    classmap[:c] = np.arange(c)
    accept = rng.random((r, s)) < 3 / s
    return nfa_from_dense(classmap, delta, rng.random(s) < 4 / s, accept,
                          accept | (rng.random((r, s)) < 1 / s), dev)


def _nfa_variant(nfa):
    """Which K3 variant csrc/nfa_scan.cu's dispatch takes for ``nfa``."""
    c, s = nfa.n_classes, nfa.n_states
    w = -(-s // 32)
    budget = 200 * 1024
    if w <= 2 and c * s * w * 4 <= budget:
        return "dense"
    if c * s * 8 + c * w * 4 <= budget:
        return "near"
    return "sparse"


@pytest.mark.parametrize("c,s,r,edges,variant", [
    (5, 30, 3, 150, "dense"),       # W = 1
    (12, 64, 8, 700, "dense"),      # W = 2, the mesh's DNS shards' size
    (60, 256, 4, 15000, "near"),    # W = 8, dense rows past shared memory
    (19, 320, 8, 6000, "near"),     # W = 10, the nfa shape's size (random
    (7, 1024, 5, 7000, "near"),     # targets: most walk their sparse rows)
    (40, 1024, 4, 40000, "sparse"),  # W = 32, near rows past shared memory
    (6, 60, 3, 0, "dense"),         # every (class, state) row empty
    (6, 100, 3, 0, "near"),         # the same, W = 4
    (256, 100, 3, 0, "sparse"),     # every row empty, no form in shared memory
])
@pytest.mark.parametrize("l", [64, 61])
def test_nfa_kernel_variants_match_plain(cuda, c, s, r, edges, variant, l):
    rng = np.random.default_rng(c * s + edges + l)
    nfa = _random_nfa(rng, cuda, c, s, r, edges)
    assert _nfa_variant(nfa) == variant
    d, st, en = _scan_batch(rng, cuda, 1031, l, view=(l == 64 and c == 19))
    got = _one_launch(nfa_mod._NFA_SCAN, nfa_search_spans, nfa, d, st, en)
    want = nfa_scan_plain(nfa, d, st, en)
    assert torch.equal(got, want) and (edges == 0 or bool(want.any()))


@pytest.mark.parametrize("l", [64, 61])
def test_nfa_kernel_past_one_launch_matches_plain(cuda, l):
    """An NFA past MAX_STATES states (48 patterns, 1,360 states): one K3
    launch a part, the result equal to the plain scan of the whole NFA."""
    from test_torch_scan_tables import SPLIT_PATTERNS, split_heads

    nfa = device_nfa(compile_patterns(SPLIT_PATTERNS), cuda)
    assert nfa.n_states > nfa_mod.MAX_STATES and len(nfa.scan_parts) >= 2
    data, lengths = split_heads(np.random.default_rng(l), 1031, l)
    d, en = data.to(cuda), lengths.to(cuda)
    st = torch.zeros_like(en)
    before = nfa_mod._NFA_SCAN.launches
    got = nfa_search_spans(nfa, d, st, en)
    torch.cuda.synchronize()
    assert nfa_mod._NFA_SCAN.launches == before + len(nfa.scan_parts)
    want = nfa_scan_plain(nfa, d, st, en)
    assert torch.equal(got, want) and bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("case", ["chain-1025", "random-1025", "nfa-wide-2064", "random-2500",
                                  "nfa-wide-4088", "random-4000"])
@pytest.mark.parametrize("l", [2048, 2045])
def test_nfa_wide_form_matches_plain(cuda, case, l):
    """A block of more than MAX_STATES states that no cut divides (a
    chain, compiled run-length patterns, random edges over every state):
    one launch of K3's wide form (a warp a flow, up to 4,096 states), equal
    to the plain scan on spans of random bytes with the needle planted."""
    import nfa_wide_cases as wc

    rng = np.random.default_rng(sum(map(ord, case)) + l)
    if case == "chain-1025":
        nfa = nfa_from_dense(*wc.chain(), cuda)
        needle = b"a" * (wc.CHAIN_STATES - 1)
    elif case.startswith("random"):
        s = int(case.split("-")[1])
        nfa = _random_nfa(rng, cuda, 6, s, 5, 6 * s)
        needle = bytes(rng.integers(0, 256, 64).astype(np.uint8))
    else:
        nfa = device_nfa(compile_patterns([wc.WIDE_PATTERNS[case]]), cuda)
        needle = wc.needle(wc.WIDE_PATTERNS[case])
    assert nfa_mod.MAX_STATES < nfa.n_states <= nfa_mod.WIDE_STATES and not nfa.scan_parts
    data, lengths = wc.planted(rng, 1031, l, needle)
    d = torch.from_numpy(data).to(cuda)
    en = torch.from_numpy(lengths).to(cuda)
    st = torch.from_numpy(rng.integers(-2, 3, len(lengths)).astype(np.int32)).to(cuda)
    st[:3] = torch.tensor([0, l, 5], dtype=torch.int32)
    got = _one_launch(nfa_mod._NFA_SCAN, nfa_search_spans, nfa, d, st, en)
    want = nfa_scan_plain(nfa, d, st, en)
    assert torch.equal(got, want)
    if not case.startswith("random"):
        assert bool(want.any()) and not bool(want.all())


def test_hits_kernel_matches_plain(cuda):
    rows = [
        (frozenset({7, 9}), "READ", ""),
        (frozenset(), "HALT", ""),
        (frozenset({5}), "", ""),
        (frozenset(), "WRITE", "x"),
        (frozenset({1}), "RESET", ""),
    ]
    model = build_r2d2_model_from_rows(rows, bucket=True, device=cuda)
    rng = np.random.default_rng(5)
    f, l = 4096, 64
    data, lengths = _batch(rng, f, l)
    cmds = [b"READ", b"HALT", b"WRITE", b"RESET", b"READX", b""]
    for i in range(f):
        c = cmds[i % len(cmds)]
        data[i, : len(c)] = np.frombuffer(c, np.uint8)
    sp = rng.integers(0, 9, size=f).astype(np.int32)
    sp[: len(cmds)] = [len(c) for c in cmds]
    file_ok = rng.random((f, model.cmd_len.shape[0])) < 0.7
    remotes = rng.choice([1, 5, 7, 9, 0], size=f).astype(np.int32)
    d, s, fo, rm = _to(cuda, data, sp, file_ok, remotes)
    before = r2d2_mod._R2D2_HITS.launches
    got = r2d2_hits(model, d, s, fo, rm)
    torch.cuda.synchronize()
    assert r2d2_mod._R2D2_HITS.launches == before + 1
    want = r2d2_hits_plain(model, d, s, fo, rm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[0].any()) and not bool(want[0].all())


def test_model_card_matches_cpu(cuda):
    rows = [
        (frozenset(), "READ", "/public/.*"),
        (frozenset(), "HALT", ""),
        (frozenset({3}), "", "\\.txt$"),
    ]
    msgs = [b"READ /public/a.txt\r\n", b"WRITE /x\r\n", b"HALT\r\n",
            b"READ /private/b.txt\r\n", b"READ  two\r\n", b"READ /public/x"]
    f, l = 600, 32
    data = np.zeros((f, l), np.uint8)
    lengths = np.zeros((f,), np.int32)
    for i in range(f):
        m = msgs[i % len(msgs)]
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = len(m)
    remotes = (np.arange(f) % 4).astype(np.int32)
    card = build_r2d2_model_from_rows(rows, bucket=True, device=cuda)
    cpu = build_r2d2_model_from_rows(rows, bucket=True, device="cpu")
    got = card.verdicts_attr(data, lengths, remotes)
    want = cpu.verdicts_attr(data, lengths, remotes)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


def test_wrappers_reject_bad_inputs(cuda):
    dfa = device_dfa(compile_pattern_dfas(["abc"]), cuda)
    data = torch.zeros((4, 8), dtype=torch.uint8, device=cuda)
    span = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        dfa_search_spans(dfa, data.to(torch.int32), span, span)
    with pytest.raises(ValueError):
        dfa_search_spans(dfa, data.t(), span, span)
    with pytest.raises(ValueError):
        dfa_search_spans(dfa, data.cpu(), span.cpu(), span.cpu())
    with pytest.raises(ValueError):
        r2d2_frame(data, span[:3])


# --- the HTTP kernels K5-K7 ----------------------------------------------------

HTTP_RULES = [
    (frozenset(), PortRuleHTTP(method="GET|HEAD", path="/pub(lic)?/.*")),
    (frozenset({1}), PortRuleHTTP(path="/a/[0-9]+")),
    (frozenset(), PortRuleHTTP(method="PUT")),
    (frozenset({2, 3}), PortRuleHTTP(host=".*\\.internal")),
    (frozenset(), PortRuleHTTP(method="GET", headers=("X-A: 1", "X-B: 2"))),
    (frozenset({3}), PortRuleHTTP(path="/a\nb.*")),
    (frozenset(), PortRuleHTTP(method="GET|POST", path="/api/v1/.*|/x")),
]
HTTP_ALPHABET = np.frombuffer(b"GET PUT /public/a/12\r\n\r\nHost: x.internal\nX-A: 1", np.uint8)


def _http_batch(rng, f, l):
    """Random heads over an HTTP alphabet, then well-formed heads in every
    third row; lengths include 0, l and l - 1."""
    data = rng.choice(HTTP_ALPHABET, size=(f, l)).astype(np.uint8)
    lengths = rng.integers(0, l + 1, size=f).astype(np.int32)
    lengths[:3] = [0, l, l - 1]
    heads = [b"GET /public/x HTTP/1.1\r\nHost: a.internal\r\n\r\n",
             b"GET /a/12 HTTP/1.1\r\nX-A: 1\r\nX-B: 2\r\n\r\n",
             b"PUT /z HTTP/1.1\r\n\r\n", b"GET /a\nbX HTTP/1.1\r\n\r\n",
             b"FOO\r\n\r\n", b"POST /api/v1/q HTTP/1.1\r\n\r\n"]
    for i in range(3, f, 3):
        h = heads[i % len(heads)][:l]
        data[i, : len(h)] = np.frombuffer(h, np.uint8)
        lengths[i] = len(h)
    return data, lengths


@pytest.mark.parametrize("l", [512, 67, 2048])
def test_http_frame_kernel_matches_plain(cuda, l):
    rng = np.random.default_rng(l)
    data, lengths = _http_batch(rng, 4099, l)
    data[1, l - 4 :] = np.frombuffer(b"\r\n\r\n", np.uint8)  # CRLFCRLF at the end
    d, n = _to(cuda, data, lengths)
    before = http_mod._HTTP_FRAME.launches
    got = http_frame(d, n)
    torch.cuda.synchronize()
    assert http_mod._HTTP_FRAME.launches == before + 1
    want = http_frame_plain(d, n)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
    assert bool(want.complete.any()) and not bool(want.complete.all())


# --- the framing kernels K1 and K5 on frame_cases' boundary batches -------------

FRAME_KERNELS = {
    "r2d2_frame": (r2d2_frame, r2d2_frame_plain, r2d2_mod._R2D2_FRAME),
    "http_frame": (http_frame, http_frame_plain, http_mod._HTTP_FRAME),
}
def _frame_matches_plain(kernel, data, lengths):
    run, plain, counter = FRAME_KERNELS[kernel]
    before = counter.launches
    got = run(data, lengths)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = plain(data, lengths)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
    return want


def _boundary_rows(l, rows):
    """frame_batch(l), or its rows cycled to ``rows`` (a batch of more than
    1,024 rows takes 4 lanes a row at every width)."""
    data, lengths = frame_batch(l)
    if rows is None:
        return data, lengths
    return np.resize(data, (rows, l)), np.resize(lengths, rows)


@pytest.mark.parametrize("rows", [None, 8192])
@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("l", FRAME_CARD_WIDTHS)
@pytest.mark.parametrize("kernel", sorted(FRAME_KERNELS))
def test_frame_kernels_match_plain_on_boundary_batch(cuda, kernel, l, offset, rows):
    data, lengths = _boundary_rows(l, rows)
    d = on_card_at(cuda, data, offset)
    assert kernels.frame_variant(kernel, d)[2] == (l % 16 == 0 and offset == 0)
    _frame_matches_plain(kernel, d, torch.from_numpy(lengths).to(cuda))


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("l", [l for l in FRAME_CARD_WIDTHS if l > 256])
@pytest.mark.parametrize("kernel", sorted(FRAME_KERNELS))
def test_frame_kernels_match_plain_a_warp_a_row(cuda, kernel, l, offset):
    """The boundary batch in launches of at most 1,024 rows, which take a
    warp a row (and 4 chunks a lane past 2,048 bytes)."""
    data, lengths = frame_batch(l)
    for s in range(0, len(data), 1024):
        d = on_card_at(cuda, data[s : s + 1024], offset)
        assert kernels.frame_variant(kernel, d)[:2] == (32, 4 if l > 2048 else 1)
        _frame_matches_plain(kernel, d, torch.from_numpy(lengths[s : s + 1024]).to(cuda))


@pytest.mark.parametrize("f", [1, 3, 2048, 65536])
@pytest.mark.parametrize("kernel", sorted(FRAME_KERNELS))
def test_frame_kernels_at_batch_sizes(cuda, kernel, f):
    for l in (64, 512):
        data, lengths = frame_batch(l)
        rows = np.random.default_rng(f + l).integers(0, len(data), f)
        d, n = _to(cuda, np.ascontiguousarray(data[rows]), np.ascontiguousarray(lengths[rows]))
        _frame_matches_plain(kernel, d, n)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("kernel", sorted(FRAME_KERNELS))
def test_frame_kernels_on_the_long_head_bucket(cuda, kernel, offset):
    """The HTTP engine's 32,768-wide bucket around a head over 32 KB."""
    data, lengths = long_head_batch()
    d, n = on_card_at(cuda, data, offset), torch.from_numpy(lengths).to(cuda)
    want = _frame_matches_plain(kernel, d, n)
    if kernel == "http_frame":
        assert want.complete[:3].tolist() == [False, True, True]
        assert want.head_len[1:3].tolist() == [32768, 32767]


def test_frame_shapes_take_every_variant(cuda):
    """The shapes of the tests above reach every variant the launchers take
    for 1 to 65,536 rows of 1 to 33,000 bytes, aligned or not."""
    buf = torch.empty(33000 + 16, dtype=torch.uint8, device=cuda)
    widths = sorted(set(range(1, 300)) | set(range(300, 33001, 16)) | set(range(301, 33001, 16)))
    both = (0, 5)
    shapes = [(len(frame_batch(l)[0]), l, both) for l in FRAME_CARD_WIDTHS]
    shapes += [(8192, l, both) for l in FRAME_CARD_WIDTHS] + [(64, 32768, both)]
    shapes += [(min(1024, len(frame_batch(l)[0])), l, both) for l in FRAME_CARD_WIDTHS if l > 256]
    shapes += [(f, l, (0,)) for f in (1, 3, 2048, 65536) for l in (64, 512)]
    for kernel in FRAME_KERNELS:
        def variant(f, l, offset):
            view = buf[offset : offset + l].as_strided((f, l), (0, 1))
            return kernels.frame_variant(kernel, view)

        every = {variant(f, l, off) for f in (1, 1500, 3000, 6000, 65536) for l in widths
                 for off in (0, 5)}
        tested = {variant(f, l, off) for f, l, offsets in shapes for off in offsets}
        assert every <= tested, sorted(every - tested)


@pytest.mark.parametrize("backend", ["auto", "nfa"])
def test_http_lit_and_hits_kernels_match_plain(cuda, backend):
    model = build_http_model(HTTP_RULES, backend=backend, device=cuda)
    rng = np.random.default_rng(9)
    data, lengths = _http_batch(rng, 3001, 96)
    remotes = rng.choice([1, 2, 3, 4], size=3001).astype(np.int32)
    d, n, rm = _to(cuda, data, lengths, remotes)
    frame = http_frame(d, n)
    before = http_mod._HTTP_LIT.launches
    lit = http_lit(model, d, frame)
    torch.cuda.synchronize()
    assert http_mod._HTTP_LIT.launches == before + 1
    want = http_lit_plain(model, d, frame)
    assert torch.equal(lit[0], want[0]) and torch.equal(lit[1], want[1])
    assert bool(want[1].any()) and not bool(want[1].all())
    zero = torch.zeros_like(frame.sp1)
    rx_m = automaton_search_spans(model.line_nfa, d, zero, frame.sp1)
    rx_p = automaton_search_spans(model.line_nfa, d, frame.p_start, frame.sp2)
    head = automaton_search_spans(model.head_nfa, d, frame.line_end, frame.h_end)
    for args in ((rx_m, rx_p, head), (None, rx_p, None), (rx_m, None, head)):
        before = http_mod._HTTP_HITS.launches
        got = http_hits(model, frame.complete, *lit, *args, rm)
        torch.cuda.synchronize()
        assert http_mod._HTTP_HITS.launches == before + 1
        want = http_hits_plain(model, frame.complete, *lit, *args, rm)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[0].any()) and not bool(want[0].all())


def test_http_model_card_matches_cpu(cuda):
    data, lengths = _http_batch(np.random.default_rng(4), 1024, 128)
    remotes = (np.arange(1024) % 4).astype(np.int32)
    for backend in ("auto", "regex-only"):
        card = build_http_model(HTTP_RULES, backend=backend, device=cuda)
        cpu = build_http_model(HTTP_RULES, backend=backend, device="cpu")
        got = card.verdicts_attr(data, lengths, remotes)
        want = cpu.verdicts_attr(data, lengths, remotes)
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            assert torch.equal(g.cpu(), w)


def test_http_model_widest_bucket_matches_cpu(cuda):
    """The engine's widest bucket: L = 32,768, F = MIN_ROWS, heads from a
    few bytes to the whole row, complete and cut."""
    f, l = 64, 1 << 15
    rng = np.random.default_rng(12)
    data = np.zeros((f, l), np.uint8)
    lengths = np.zeros((f,), np.int32)
    for i in range(f):
        # every fifth head outgrows the row and is cut: incomplete
        pad = "p" * (l if i % 5 == 0 else int(rng.integers(0, l - 100)))
        head = (f"GET /pub/{'x' * (i % 7)} HTTP/1.1\r\nHost: a.internal\r\n"
                f"X-Pad: {pad}\r\n\r\n").encode()[: l - (i % 3)]
        data[i, : len(head)] = np.frombuffer(head, np.uint8)
        lengths[i] = len(head)
    remotes = (np.arange(f) % 4).astype(np.int32)
    card = build_http_model(HTTP_RULES, device=cuda)
    cpu = build_http_model(HTTP_RULES, device="cpu")
    got = card.verdicts_attr(data, lengths, remotes)
    want = cpu.verdicts_attr(data, lengths, remotes)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(want[2].any()) and not bool(want[0].all())


# --- the DNS kernels K8, K9 ----------------------------------------------------

DNS_ROWS = [
    (frozenset({7}), DnsRule(name="www.example.com")),
    (frozenset(), DnsRule(pattern="*.svc.cluster.local")),
    (frozenset({7, 9}), DnsRule(regex="^cdn[0-9]+[.]edge[.]net$")),
    (frozenset({3}), None),
    (frozenset(), DnsRule(name="api.internal")),
]
DNS_NAMES = ["www.example.com", "WWW.Example.COM", "a.svc.cluster.local", "svc.cluster.local",
             "cdn42.edge.net", "cdnx.edge.net", "api.internal", "", "a" * 63, "x.y"]


def _dns_batch(rng, f, l):
    """Query frames (upper case, pointers, oversized labels, 40 and 41
    labels, QDCOUNT 0, cut QTYPE), incomplete and pipelined rows, and
    random bytes, in an [f, l] batch."""
    data = rng.integers(0, 256, size=(f, l)).astype(np.uint8)
    lengths = rng.integers(0, l + 1, size=f).astype(np.int32)
    for i in range(f):
        kind = i % 9
        name = DNS_NAMES[(i // 9) % len(DNS_NAMES)]
        if kind == 0:
            frame = encode_dns_query(name)
        elif kind == 1:
            frame = bytearray(encode_dns_query(name or "x"))
            frame[DNS_QNAME_OFF] = [0xC0, 64, 255][i % 3]
        elif kind == 2:
            frame = encode_dns_query(".".join("a" for _ in range(MAX_LABELS + i % 2)))
        elif kind == 3:
            frame = encode_dns_query(name, qdcount=0)
        elif kind == 4:
            frame = bytearray(encode_dns_query(name))[:-2]
            frame[0:2] = (len(frame) - 2).to_bytes(2, "big")
        elif kind == 5:
            frame = encode_dns_query(name)[: int(rng.integers(0, 20))]  # incomplete
        elif kind == 6:
            frame = encode_dns_query(name) + encode_dns_query("a.b")  # pipelined
        elif kind == 7:
            frame = bytearray(encode_dns_query("ab.cd.ef"))
            frame[DNS_QNAME_OFF + 3] = 0xC0  # a pointer after a label
        else:
            continue  # random bytes
        frame = bytes(frame)[:l]
        data[i, : len(frame)] = np.frombuffer(frame, np.uint8)
        lengths[i] = len(frame)
    return data, lengths


NAME_MANY_ROWS = 8192  # csrc/dns_name.cu kManyRows


def _name_equal(data, lengths):
    """K8 launched once on the card, equal to its plain version."""
    got = _one_launch(dns_mod._DNS_NAME, dns_name, data, lengths)
    want = dns_name_plain(data, lengths)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
    return want


@pytest.mark.parametrize("l", dc.CARD_WIDTHS)
def test_dns_name_kernel_matches_plain(cuda, l):
    """Random frames, then dns_name_cases' boundary batch at every F of
    F_SIZES and at NAME_MANY_ROWS (the launcher's pick for big batches),
    its rows 16-byte aligned and 5 bytes into their storage."""
    rng = np.random.default_rng(l)
    data, lengths = _dns_batch(rng, 4099, l)
    d, n = _to(cuda, data, lengths)
    want = _name_equal(d, n)
    if l >= 64:
        assert bool(want.valid.any()) and not bool(want.valid.all())
    for f in (None, *dc.F_SIZES, NAME_MANY_ROWS):
        data, lengths = dc.name_batch(l, f)
        for offset in dc.OFFSETS:
            d = dc.on_card_at(cuda, data, offset)
            assert kernels.name_variant(d)[2] == (l % 16 == 0 and offset == 0)
            _name_equal(d, torch.from_numpy(lengths).to(cuda))


@pytest.mark.parametrize("l", [64, 330])
def test_dns_hits_kernel_matches_plain(cuda, l):
    rng = np.random.default_rng(3 + l)
    remotes = rng.choice([1, 3, 7, 9], size=4099).astype(np.int32)
    data, lengths = _dns_batch(rng, 4099, l)
    d, n, rm = _to(cuda, data, lengths, remotes)
    name = dns_name(d, n)
    for rows in (DNS_ROWS, [r for r in DNS_ROWS if r[1] is None or r[1].name]):
        model = build_dns_model_from_rows(rows, bucket=True, device=cuda)
        rx = None
        if model.nfa is not None:
            rx = automaton_search_spans(model.nfa, name.dotted, name.span_start, name.span_end)
        before = dns_mod._DNS_HITS.launches
        got = dns_hits(model, name, rx, rm)
        torch.cuda.synchronize()
        assert dns_mod._DNS_HITS.launches == before + 1
        want = dns_hits_plain(model, name, rx, rm)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(want[0].any()) and not bool(want[0].all())


def test_dns_model_card_matches_cpu(cuda):
    data, lengths = _dns_batch(np.random.default_rng(8), 2048, 96)
    remotes = (np.arange(2048) % 10).astype(np.int32)
    card = build_dns_model_from_rows(DNS_ROWS, bucket=True, device=cuda)
    cpu = build_dns_model_from_rows(DNS_ROWS, bucket=True, device="cpu")
    got = card.verdicts_attr(data, lengths, remotes)
    want = cpu.verdicts_attr(data, lengths, remotes)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


# --- the Cassandra and memcached kernels K10, K11 ---------------------------------


def _policy(port, proto, rules):
    return compile_policy(NetworkPolicy(name="k", policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=port, rules=[
            PortNetworkPolicyRule(remote_policies=rs, l7_proto=proto, l7_rules=r)
            for rs, r in rules])]))


CASS_RULES = [
    ([], [{"query_action": "select", "query_table": "^public\\."}, {"query_action": "use"}]),
    ([2, 3], [{"query_table": "users"}, {"query_action": "create-table"}]),
]


def _cass_batch(rng, f):
    actions = ["select", "insert", "use", "create-table", "selec", "selectt", ""]
    tables = ["public.a", "secret.users", "", "public", "x" * 96]
    reqs = [(actions[int(rng.integers(len(actions)))], tables[int(rng.integers(len(tables)))],
             bool(rng.random() < 0.1)) for _ in range(f)]
    data, alen, tlen, nq, _ = encode_cassandra_batch(reqs)
    return data, alen, tlen, nq, rng.integers(0, 5, size=f).astype(np.int32)


@pytest.mark.parametrize("f", [4099, 65536])
def test_cassandra_hits_kernel_matches_plain(cuda, f):
    rng = np.random.default_rng(f)
    d, alen, tlen, nq, rm = _to(cuda, *_cass_batch(rng, f))
    for rules in (CASS_RULES, [([], [{"query_action": "select"}])]):
        model = build_cassandra_model(_policy(9042, "cassandra", rules), True, 9042, device=cuda)
        rx = None
        if model.nfa is not None:
            start = torch.full_like(tlen, MAX_ACTION)
            rx = automaton_search_spans(model.nfa, d, start, start + tlen)
        before = cass_mod._CASSANDRA_HITS.launches
        got = cassandra_hits(model, d, alen, tlen, nq, rx, rm)
        torch.cuda.synchronize()
        assert cass_mod._CASSANDRA_HITS.launches == before + 1
        want = cassandra_hits_plain(model, d, alen, tlen, nq, rx, rm)
        assert torch.equal(got, want)
        assert bool(want.any()) and not bool(want.all())


MC_RULES = [
    ([], [{"command": "get", "keyExact": "user:1"}, {"command": "get", "keyPrefix": "user:"},
          {"command": "set", "keyRegex": "^sess:[0-9]+$"}, {"command": "delete"}]),
    ([4], [{}]),
]


def _mc_batch(rng, f):
    nc = len(TEXT_COMMANDS)
    keys = [b"user:1", b"user:", b"user", b"user:12", b"sess:9", b"sess:x", b"", b"k" * 96]
    frames = []
    for _ in range(f):
        key = keys[int(rng.integers(len(keys)))]
        if rng.random() < 0.5:
            frames.append((True, int(rng.choice([0, 1, 4, 9, 27, 200])), "", [key]))
        else:
            cmd = ["get", "set", "delete", "stats"][int(rng.integers(4))]
            frames.append((False, 0, cmd, [] if cmd == "stats" else [key]))
    key_data, key_len, has_key, is_bin, opcode, cmd_id, _ = encode_memcache_batch(frames)
    opcode[::97] = -1  # indices outside the tables: counted from the end, clamped
    cmd_id[1::89] = nc + 3
    return key_data, key_len, has_key, is_bin, opcode, cmd_id, rng.integers(0, 6, size=f).astype(np.int32)


@pytest.mark.parametrize("f", [4099, 65536])
def test_memcache_hits_kernel_matches_plain(cuda, f):
    rng = np.random.default_rng(f + 1)
    args = _to(cuda, *_mc_batch(rng, f))
    for rules in (MC_RULES, [([], [{"command": "get", "keyPrefix": "user:"}])]):
        model = build_memcache_model(_policy(11211, "memcache", rules), True, 11211, device=cuda)
        rx = None
        if model.nfa is not None:
            rx = automaton_search_spans(model.nfa, args[0], torch.zeros_like(args[1]), args[1])
        before = mc_mod._MEMCACHE_HITS.launches
        got = memcache_hits(model, *args[:6], rx, args[6])
        torch.cuda.synchronize()
        assert mc_mod._MEMCACHE_HITS.launches == before + 1
        want = memcache_hits_plain(model, *args[:6], rx, args[6])
        assert torch.equal(got, want)
        assert bool(want.any()) and not bool(want.all())


def test_l7_models_card_match_cpu(cuda):
    rng = np.random.default_rng(21)
    cass = _cass_batch(rng, 1024)
    mc = _mc_batch(rng, 1024)
    for build, policy, port, batch_ in (
        (build_cassandra_model, _policy(9042, "cassandra", CASS_RULES), 9042, cass),
        (build_memcache_model, _policy(11211, "memcache", MC_RULES), 11211, mc),
    ):
        card = build(policy, True, port, device=cuda)
        cpu = build(policy, True, port, device="cpu")
        got = card(*batch_)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), cpu(*batch_))


# --- the L3/L4 kernels K12-K15 -------------------------------------------------


import random  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import l34_index_cases as ic  # noqa: E402
import l34_worlds as worlds  # noqa: E402
from cilium_tpu_torch import convert  # noqa: E402
from cilium_tpu_torch.datapath import ingress as ing_mod  # noqa: E402
from cilium_tpu_torch.datapath import pipeline as dp_mod  # noqa: E402
from cilium_tpu_torch.datapath.ingress import (  # noqa: E402
    MODE_NETDEV,
    MODE_OVERLAY,
    build_ingress_tables,
    ingress,
    ingress_plain,
)
from cilium_tpu_torch.datapath.pipeline import build_tables, datapath_pass, datapath_pass_plain  # noqa: E402
from cilium_tpu_torch.datapath.pipeline6 import build_tables6, datapath_verdicts6  # noqa: E402
from cilium_tpu_torch.maps import lbmap as lb_mod  # noqa: E402
from cilium_tpu_torch.maps import policymap as pol_mod  # noqa: E402
from cilium_tpu_torch.maps.ctmap import CtKey4, CtKey6, CtMap  # noqa: E402
from cilium_tpu_torch.maps.ipcache import IpcacheMap  # noqa: E402
from cilium_tpu_torch.maps.lbmap import DeviceLb6Map, DeviceLbMap, LbMap, lb_select, lb_select_plain  # noqa: E402
from cilium_tpu_torch.maps.lxcmap import EndpointInfo, LxcMap  # noqa: E402
from cilium_tpu_torch.maps.policymap import (  # noqa: E402
    DevicePolicyMap,
    PolicyMap,
    policy_can_access_batch,
    policy_can_access_plain,
)
from cilium_tpu_torch.ops import lpm as lpm_mod  # noqa: E402
from cilium_tpu_torch.ops import maplookup as ml_mod  # noqa: E402
from cilium_tpu_torch.ops.lpm import _mask32, lpm_from_arrays, lpm_lookup, lpm_lookup_plain  # noqa: E402
from cilium_tpu_torch.ops.maplookup import exact_lookup, exact_lookup_plain, pack_table, table_from_arrays  # noqa: E402

PORT_MAPS = SimpleNamespace(CtMap=CtMap, CtKey4=CtKey4, CtKey6=CtKey6, LbMap=LbMap,
                            IpcacheMap=IpcacheMap, PolicyMap=PolicyMap, LxcMap=LxcMap,
                            EndpointInfo=EndpointInfo)


def _rand_lpm(rng, n, w, dev):
    """Random prefixes over W words (a /0 first, equal prefixes with other
    values, some rows invalid) and addresses half inside them."""
    plen = rng.integers(0, 32 * w + 1, n)
    plen[0] = 0
    masks = np.stack([_mask32(plen, i, w == 4) for i in range(w)])
    words = rng.integers(0, 1 << 32, (w, n), dtype=np.uint64).astype(np.uint32) & masks
    if n >= 8:  # equal prefixes with other values: the largest value wins
        half = n // 2
        words[:, half:half + 3] = words[:, 1:4]
        plen[half:half + 3] = plen[1:4]
        masks[:, half:half + 3] = masks[:, 1:4]
    values = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return lpm_from_arrays(words.view(np.int32), masks.view(np.int32), plen.astype(np.int32),
                           values, valid, dev), words


def _addrs(rng, words, f):
    w, n = words.shape
    rows = rng.integers(0, n, f)
    noise = rng.integers(0, 1 << 32, (w, f), dtype=np.uint64).astype(np.uint32)
    inside = rng.random(f) < 0.5
    out = np.where(inside[None, :], words[:, rows] | (noise & 0xFF), noise)
    return [torch.from_numpy(np.ascontiguousarray(out[i].view(np.int32))) for i in range(w)]


@pytest.mark.parametrize("w,n,f", [(1, 1, 1), (1, 1000, 4099), (4, 33, 300), (4, 1025, 2049)])
def test_lpm_kernel_matches_plain(cuda, w, n, f):
    rng = np.random.default_rng(n + f)
    lpm, words = _rand_lpm(rng, n, w, cuda)
    addr = [a.to(cuda) for a in _addrs(rng, words, f)]
    before = lpm_mod._LPM.launches
    got = lpm_lookup(lpm, *addr)
    torch.cuda.synchronize()
    assert lpm_mod._LPM.launches == before + 1
    want = lpm_lookup_plain(lpm, *addr)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)
    assert bool(want[0].any()) or n == 1


@pytest.mark.parametrize("k,v,n,f", [(1, 2, 7, 129), (4, 1, 513, 4099), (5, 3, 4097, 1000), (11, 1, 64, 33)])
def test_exact_lookup_kernel_matches_plain(cuda, k, v, n, f):
    """Keys from a small range, so duplicate keys sum (with int32 wrap)
    and padding rows (all-zero keys, invalid) meet all-zero queries."""
    rng = np.random.default_rng(k * 100 + n)
    keys = rng.integers(0, 3, (n - 2, k))
    values = rng.integers(-(1 << 31), 1 << 31, (n - 2, v))
    table = pack_table(keys, values, pad_to=n, device=cuda)
    q = [torch.from_numpy(rng.integers(0, 4, f).astype(np.int32)).to(cuda) for _ in range(k)]
    before = ml_mod._EXACT.launches
    got = exact_lookup(table, *q)
    torch.cuda.synchronize()
    assert ml_mod._EXACT.launches == before + 1
    want = exact_lookup_plain(table, *q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[0].any()) and not bool(want[0].all()) or k >= 5


@pytest.mark.parametrize("n,f", [(5, 100), (513, 4099)])
def test_policy_kernel_matches_plain(cuda, n, f):
    rng = np.random.default_rng(n)
    keys = np.stack([rng.integers(0, 3, n), rng.choice([0, 80, 65535], n),
                     rng.choice([0, 6, 17], n), rng.integers(0, 2, n)], axis=1)
    vals = rng.integers(-5, 20000, (n, 2))
    dmap = DevicePolicyMap(table=pack_table(keys, vals, pad_to=n + 3, device=cuda))
    ident = torch.from_numpy(rng.integers(0, 4, f).astype(np.int32)).to(cuda)
    dport = torch.from_numpy(rng.choice([0, 80, 65535, 8], f).astype(np.int32)).to(cuda)
    proto = torch.from_numpy(rng.choice([0, 6, 17], f).astype(np.int32)).to(cuda)
    for direction in (0, 1):
        before = pol_mod._POLICY.launches
        got = policy_can_access_batch(dmap, ident, dport, proto, direction)
        torch.cuda.synchronize()
        assert pol_mod._POLICY.launches == before + 1
        want = policy_can_access_plain(dmap, ident, dport, proto, direction)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("w,s,f", [(1, 1, 50), (1, 70, 4099), (4, 9, 1000)])
def test_lb_kernel_matches_plain(cuda, w, s, f):
    """Duplicate VIPs, L4 and wildcard rows, counts of -1, 0 and above the
    backend columns (the index clamps), invalid rows, hashes >= 2^31."""
    rng = np.random.default_rng(s * w)
    b = 3
    vips = (rng.integers(0, 4, (w, s)) + (1 << 31)).astype(np.uint32).view(np.int32)
    cls = DeviceLbMap if w == 1 else DeviceLb6Map
    dlb = cls.from_arrays(
        vips, rng.choice([0, 80], s).astype(np.int32),
        rng.choice([-1, 0, 1, 2, 3, 9], s).astype(np.int32), rng.integers(0, 100, s).astype(np.int32),
        rng.integers(-(1 << 31), 1 << 31, (w, s, b)).astype(np.int32),
        rng.integers(1, 65536, (s, b)).astype(np.int32), rng.random(s) < 0.9, cuda,
    )
    vw = [torch.from_numpy((rng.integers(0, 5, f) + (1 << 31)).astype(np.uint32).view(np.int32)).to(cuda)
          for _ in range(w)]
    dport = torch.from_numpy(rng.choice([0, 80, 443], f).astype(np.int32)).to(cuda)
    fh = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, f).astype(np.int32)).to(cuda)
    before = lb_mod._LB.launches
    got = lb_select(dlb, vw, dport, fh)
    torch.cuda.synchronize()
    assert lb_mod._LB.launches == before + 1
    want = lb_select_plain(dlb, vw, dport, fh)
    assert torch.equal(got[0], want[0])
    for g, wt in zip(got[1], want[1]):
        assert torch.equal(g, wt)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


def _equal_dicts(got, want):
    assert got.keys() == want.keys()
    for key in want:
        g, wt = got[key], want[key]
        if isinstance(wt, tuple):
            for a, c in zip(g, wt):
                assert torch.equal(a, c), key
        else:
            assert g.device.type == "cuda"
            assert torch.equal(g, wt), key


@pytest.mark.parametrize("v6,n_ct,f", [(False, 1000, 4099), (False, 0, 33), (True, 37, 1000)])
def test_datapath_kernel_matches_plain(cuda, v6, n_ct, f):
    rng = random.Random(n_ct + f)
    clock = worlds.Clock()
    if v6:
        ct, lb, ipc, pol, keys = worlds.egress6_world(PORT_MAPS, rng, clock, n_ct=n_ct)
        _, _, sw, dw, sport, dport, proto = worlds.egress6_packets(rng, f, keys)
        tables = build_tables6(ct, lb, ipc, pol, device=cuda)
    else:
        ct, lb, ipc, pol, keys = worlds.egress4_world(PORT_MAPS, rng, clock, n_ct=n_ct)
        sa, da, sport, dport, proto = worlds.egress4_packets(rng, f, keys)
        sw, dw = (sa,), (da,)
        tables = build_tables(ct, lb, ipc, pol, device=cuda)
    args = [tuple(torch.from_numpy(a).to(cuda) for a in sw), tuple(torch.from_numpy(a).to(cuda) for a in dw),
            *(torch.from_numpy(a).to(cuda) for a in (sport, dport, proto))]
    kern = dp_mod._DATAPATH[tables.w]
    before = kern.launches
    got = datapath_pass(tables, *args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _equal_dicts(got, datapath_pass_plain(tables, *args))
    assert n_ct == 0 or bool(got["established"].any())


@pytest.mark.parametrize("mode,f", [(MODE_NETDEV, 4099), (MODE_OVERLAY, 1000), (MODE_NETDEV, 1)])
def test_ingress_kernel_matches_plain(cuda, mode, f):
    rng = random.Random(f)
    ipc, lxc, ct, pol = worlds.node_world(PORT_MAPS, rng, worlds.Clock(), n_ct=40)
    tables = build_ingress_tables(ipc, lxc, ct, pol, device=cuda)
    p = worlds.node_packets(rng, f)
    src = p["src_id"] if mode == MODE_NETDEV else p["vni"]
    args = [torch.from_numpy(p[k]).to(cuda) for k in ("saddr", "daddr", "sport", "dport", "proto")]
    args.append(torch.from_numpy(src).to(cuda))
    before = ing_mod._INGRESS.launches
    got = ingress(tables, mode, *args)
    torch.cuda.synchronize()
    assert ing_mod._INGRESS.launches == before + 1
    _equal_dicts(got, ingress_plain(tables, mode, *args))


# K14 / K15 probe hashed indexes (csrc/l34_index.cuh): adversarial tables
# (duplicate keys, all-zero keys beside padding, keys >= 2^31, irregular
# masks, plen -1 / INT32_MAX, one row, every row invalid) from
# tests/l34_index_cases.py, at F past a block's edge and at 65,536.
L34_SHAPES = {"adversarial": {}, "one-row": {"n": 1}, "all-invalid": {"invalid": True}}


@pytest.mark.parametrize("f", [4099, 65536])
@pytest.mark.parametrize("source", list(L34_SHAPES))
@pytest.mark.parametrize("w", [1, 4])
def test_datapath_kernel_matches_plain_on_adversarial_tables(cuda, w, source, f):
    rng = np.random.default_rng(100 * w + f % 97)
    leaves = ic.datapath_leaves(rng, w, **L34_SHAPES[source])
    conv = convert.datapath_tables_from_numpy if w == 1 else convert.datapath_tables6_from_numpy
    tables = conv(leaves, device=cuda)
    sw, dw, sport, dport, proto = ic.datapath_packets(rng, leaves, w, f)
    args = [tuple(torch.from_numpy(a).to(cuda) for a in sw), tuple(torch.from_numpy(a).to(cuda) for a in dw),
            *(torch.from_numpy(a).to(cuda) for a in (sport, dport, proto))]
    kern = dp_mod._DATAPATH[w]
    before = kern.launches
    got = datapath_pass(tables, *args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _equal_dicts(got, datapath_pass_plain(tables, *args))
    if source == "adversarial":
        assert bool(got["established"].any()) and bool((got["rev_nat"] != 0).any())


@pytest.mark.parametrize("f", [4099, 65536])
@pytest.mark.parametrize("source", list(L34_SHAPES))
@pytest.mark.parametrize("mode", [MODE_NETDEV, MODE_OVERLAY])
def test_ingress_kernel_matches_plain_on_adversarial_tables(cuda, mode, source, f):
    rng = np.random.default_rng(200 + 10 * mode + f % 89)
    leaves = ic.ingress_leaves(rng, **L34_SHAPES[source])
    tables = convert.ingress_tables_from_numpy(leaves, device=cuda)
    p = ic.ingress_packets(rng, leaves, f)
    src = p["src_id"] if mode == MODE_NETDEV else p["vni"]
    args = [torch.from_numpy(p[k]).to(cuda) for k in ("saddr", "daddr", "sport", "dport", "proto")]
    args.append(torch.from_numpy(src).to(cuda))
    before = ing_mod._INGRESS.launches
    got = ingress(tables, mode, *args)
    torch.cuda.synchronize()
    assert ing_mod._INGRESS.launches == before + 1
    _equal_dicts(got, ingress_plain(tables, mode, *args))
    if source == "adversarial":
        assert bool(got["established"].any()) and len(torch.unique(got["verdict"])) >= 4


@pytest.mark.parametrize("source", list(ic.WIDE))
@pytest.mark.parametrize("w", [1, 4])
def test_datapath_kernel_matches_plain_on_wide_tables(cuda, w, source):
    """CT and policy tables with more value columns: 16-word slots of
    values ("mid"), or slots of row ids whose rows a match reads ("wide")."""
    rng = np.random.default_rng(110 * w)
    leaves = ic.widen_datapath(rng, ic.datapath_leaves(rng, w), w, **ic.WIDE[source])
    conv = convert.datapath_tables_from_numpy if w == 1 else convert.datapath_tables6_from_numpy
    tables = conv(leaves, device=cuda)
    sw, dw, sport, dport, proto = ic.datapath_packets(rng, leaves, w, 4099)
    args = [tuple(torch.from_numpy(a).to(cuda) for a in sw), tuple(torch.from_numpy(a).to(cuda) for a in dw),
            *(torch.from_numpy(a).to(cuda) for a in (sport, dport, proto))]
    kern = dp_mod._DATAPATH[w]
    before = kern.launches
    got = datapath_pass(tables, *args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _equal_dicts(got, datapath_pass_plain(tables, *args))
    assert bool(got["established"].any()) and bool((got["proxy_port"] != 0).any())


@pytest.mark.parametrize("source", list(ic.WIDE))
@pytest.mark.parametrize("mode", [MODE_NETDEV, MODE_OVERLAY])
def test_ingress_kernel_matches_plain_on_wide_tables(cuda, mode, source):
    """Endpoint, CT and policy tables with more value columns, as above."""
    rng = np.random.default_rng(210 + mode)
    leaves = ic.widen_ingress(rng, ic.ingress_leaves(rng), **ic.WIDE[source])
    tables = convert.ingress_tables_from_numpy(leaves, device=cuda)
    p = ic.ingress_packets(rng, leaves, 4099)
    src = p["src_id"] if mode == MODE_NETDEV else p["vni"]
    args = [torch.from_numpy(p[k]).to(cuda) for k in ("saddr", "daddr", "sport", "dport", "proto")]
    args.append(torch.from_numpy(src).to(cuda))
    before = ing_mod._INGRESS.launches
    got = ingress(tables, mode, *args)
    torch.cuda.synchronize()
    assert ing_mod._INGRESS.launches == before + 1
    _equal_dicts(got, ingress_plain(tables, mode, *args))
    assert bool((got["lxc_id"] != 0).any()) and bool((got["proxy_port"] != 0).any())


def test_l34_launchers_refuse_tables_without_index(cuda):
    """The C launchers refuse arguments that carry no index: neither walks
    the rows."""
    import ctypes

    from cilium_tpu_torch.ops.l34_index import HashIx

    rng = np.random.default_rng(7)
    leaves = ic.datapath_leaves(rng, 1)
    tables = convert.datapath_tables_from_numpy(leaves, device=cuda)
    sw, dw, sport, dport, proto = ic.datapath_packets(rng, leaves, 1, 256)
    args = [tuple(torch.from_numpy(a).to(cuda) for a in sw), tuple(torch.from_numpy(a).to(cuda) for a in dw),
            *(torch.from_numpy(a).to(cuda) for a in (sport, dport, proto))]
    ix = tables.index
    out = torch.empty((7, 256), dtype=torch.int32, device=cuda)
    flags = torch.empty((2, 256), dtype=torch.bool, device=cuda)
    arr = ctypes.c_void_p * 4
    raw = dp_mod.DpArgs(tables.lb.abi(), tables.ct.abi(), tables.ipcache.abi(), tables.policy.table.abi(),
                        arr(args[0][0].data_ptr()), arr(args[1][0].data_ptr()),
                        *[t.data_ptr() for t in args[2:]], 256, out.data_ptr(), flags.data_ptr(),
                        ix.lb.abi(), HashIx(), ix.ipcache.abi(), ix.policy.abi())
    before = dp_mod._DATAPATH[1].launches
    with pytest.raises(RuntimeError):
        dp_mod._DATAPATH[1].launch(cuda, ctypes.addressof(raw))
    assert dp_mod._DATAPATH[1].launches == before
    nleaves = ic.ingress_leaves(rng)
    ntables = convert.ingress_tables_from_numpy(nleaves, device=cuda)
    p = ic.ingress_packets(rng, nleaves, 256)
    nargs = [torch.from_numpy(p[k]).to(cuda) for k in ("saddr", "daddr", "sport", "dport", "proto", "src_id")]
    nix = ntables.index
    out5 = torch.empty((5, 256), dtype=torch.int32, device=cuda)
    raw = ing_mod.IngArgs(ntables.ipcache_id.abi(), ntables.ipcache_tun.abi(), ntables.lxc.abi(),
                          ntables.ct.abi(), ntables.policy.table.abi(), *[t.data_ptr() for t in nargs],
                          MODE_NETDEV, 256, out5.data_ptr(), flags.data_ptr(),
                          nix.ipcache_id.abi(), nix.ipcache_tun.abi(), nix.lxc.abi(), HashIx(), nix.policy.abi())
    with pytest.raises(RuntimeError):
        ing_mod._INGRESS.launch(cuda, ctypes.addressof(raw))
    # an index whose slots are not its table's: 8-word policy slots beside
    # a policy table of 5 value columns (16-word slots)
    wide = DevicePolicyMap(table=table_from_arrays(
        list(tables.policy.table.keys.cpu().numpy()),
        np.repeat(tables.policy.table.values.cpu().numpy(), 5, 1), tables.policy.table.valid.cpu().numpy(), cuda))
    assert wide.table.index.width == 16 and ix.policy.width == 8
    raw = dp_mod.DpArgs(tables.lb.abi(), tables.ct.abi(), tables.ipcache.abi(), wide.table.abi(),
                        arr(args[0][0].data_ptr()), arr(args[1][0].data_ptr()),
                        *[t.data_ptr() for t in args[2:]], 256, out.data_ptr(), flags.data_ptr(),
                        ix.lb.abi(), ix.ct.abi(), ix.ipcache.abi(), ix.policy.abi())
    with pytest.raises(RuntimeError):
        dp_mod._DATAPATH[1].launch(cuda, ctypes.addressof(raw))
    assert dp_mod._DATAPATH[1].launches == before


@pytest.mark.parametrize("source", ["datapath", "datapath6", "ingress"])
def test_l34_index_build_waits_for_nothing(cuda, source):
    """A snapshot's indexes (each built by its table) build on the card
    with no op that waits for the device (torch's sync debug mode raises on
    one), so a table rebuilt after a CT round trip costs its launches and
    nothing more."""
    rng = np.random.default_rng(9)
    if source == "ingress":
        tables = convert.ingress_tables_from_numpy(ic.ingress_leaves(rng), device=cuda)
    else:
        w = 1 if source == "datapath" else 4
        conv = convert.datapath_tables_from_numpy if w == 1 else convert.datapath_tables6_from_numpy
        tables = conv(ic.datapath_leaves(rng, w), device=cuda)
    built = tables.index
    parts = [getattr(tables, name) for name in vars(built)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for part in parts:
            (part.table if isinstance(part, DevicePolicyMap) else part).__post_init__()
        tables.__post_init__()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name, ix in vars(tables.index).items():
        assert ix is not getattr(built, name)
        for a, b in zip(_index_tensors(ix), _index_tensors(getattr(built, name))):
            assert torch.equal(a, b), name


def _index_tensors(ix):
    return [ix.groups, ix.table.bounds, ix.table.slots] if hasattr(ix, "groups") else [ix.bounds, ix.slots]


def test_l34_wrappers_reject_bad_inputs(cuda):
    table = table_from_arrays([np.zeros(4, np.int32)], np.zeros((4, 1), np.int32), np.ones(4, bool), cuda)
    q = torch.zeros((8,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        exact_lookup(table, q.to(torch.int64))
    with pytest.raises(ValueError):
        exact_lookup(table, q.cpu())
    with pytest.raises(ValueError):
        exact_lookup(table, torch.zeros((8, 2), dtype=torch.int32, device=cuda)[:, 0])
    with pytest.raises(ValueError):
        exact_lookup(table, q, q)
    lpm, _ = _rand_lpm(np.random.default_rng(0), 4, 1, cuda)
    with pytest.raises(ValueError):
        lpm_lookup(lpm, q, q)
    with pytest.raises(ValueError):
        lpm_lookup(lpm, q[None, :])
    ct, lb, ipc, pol, _ = worlds.egress4_world(PORT_MAPS, random.Random(1), worlds.Clock())
    tables = build_tables(ct, lb, ipc, pol, device=cuda)
    with pytest.raises(ValueError):
        datapath_pass(tables, (q,), (q,), q, q, q[:7])
    with pytest.raises(ValueError):
        datapath_verdicts6(tables, (q,) * 4, (q,) * 4, q, q, q)


# --- K16 gather_rows and the sidecar's CUDA-graph dispatch -------------------


@pytest.mark.parametrize("view", [0, 1, 7], ids=["aligned", "view+1", "view+7"])
@pytest.mark.parametrize("f,blob_len,width", [(1, 65536, 256), (512, 65536, 256), (2048, 65536, 256),
                                              (8192, 65536, 64), (300, 300, 40), (7, 1, 16),
                                              (64, 4096, 512), (33, 70, 64)])
def test_gather_rows_kernel_matches_plain(cuda, f, blob_len, width, view):
    """K16's fast path (aligned 16-byte words, a shuffle, funnel shifts) and
    its byte path (a piece before the blob, or whose words reach past its
    end), on blobs at 16-byte aligned and unaligned addresses (``view``:
    the blob starts that many bytes into a larger tensor), with windows
    ending exactly at and running past B - 1, and rows of 1 to 32 pieces."""
    from cilium_tpu_torch.ops import gather as gather_mod

    rng = np.random.default_rng(f + width)
    blob = rng.integers(0, 256, blob_len, dtype=np.uint8)
    offs = rng.integers(-3, blob_len + 3, f).astype(np.int32)
    lens = rng.integers(-2, width + 20, f).astype(np.int32)
    edges = [(blob_len - 1, width), (blob_len - 1, 1), (0, 0), (5, width + 40),
             (blob_len - width, width), (blob_len - 17, width), (-17, width), (-2**31, 9),
             (2**31 - 1, 2**31 - 1)]
    for i, (o, ln) in enumerate(edges[:f]):
        offs[i], lens[i] = o, ln
    o, ln = _to(cuda, offs, lens)
    whole = torch.from_numpy(np.concatenate([np.zeros(view, np.uint8), blob])).to(cuda)
    b = whole[view:]
    assert b.data_ptr() % 16 == view
    before = gather_mod._GATHER_ROWS.launches
    got = gather_mod.gather_rows(b, o, ln, width)
    torch.cuda.synchronize()
    assert gather_mod._GATHER_ROWS.launches == before + 1
    assert torch.equal(got, gather_mod.gather_rows_plain(b, o, ln, width))


def test_gathered_call_in_a_graph_matches_eager(cuda, tmp_path):
    """The sidecar's blob lane (K16 then the r2d2 model) replayed from a
    CUDA graph gives the eager call's verdicts and rules, for two
    different chunks through the same captured graph; a capture counts in
    ``captured``, not in ``launches``, and each replay in ``replayed``."""
    from cilium_tpu_torch.ops import gather as gather_mod
    from cilium_tpu_torch.sidecar.service import VerdictService, _to_host
    from cilium_tpu_torch.utils.option import DaemonConfig

    policy = compile_policy(NetworkPolicy(name="p", policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
            remote_policies=[1, 3], l7_proto="r2d2",
            l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])])]))
    model = r2d2_mod.build_r2d2_model(policy, True, 80, device=cuda)
    svc = VerdictService(str(tmp_path / "g.sock"), DaemonConfig(dispatch_mode="jit")).start()
    try:
        frames = [b"READ /public/a.txt\r\n", b"READ /private/x\r\n", b"HALT\r\n", b"WRITE /public/b\r\n"]
        rng = np.random.default_rng(5)
        for _ in range(2):
            n = 300
            pick = [frames[i] for i in rng.integers(0, len(frames), n)]
            lens = np.zeros(512, np.int32)
            lens[:n] = [len(p) for p in pick]
            offs = np.zeros(512, np.int32)
            offs[:n] = np.concatenate(([0], np.cumsum(lens[:n])[:-1]))
            blob = np.zeros(svc.BLOB_CHUNK, np.uint8)
            raw = np.frombuffer(b"".join(pick), np.uint8)
            blob[: len(raw)] = raw
            rem = np.zeros(512, np.int32)
            rem[:n] = rng.choice([1, 3, 9], n)
            svc._use_jit = True
            k16 = gather_mod._GATHER_ROWS
            launches, captured, replayed = k16.launches, k16.captured, k16.replayed
            replays = svc.graph_stats["replays"]
            g_allow, g_rule = svc._gathered_call(model, blob, offs, lens, rem)
            assert svc.graph_stats["replays"] == replays + 1
            assert k16.replayed == replayed + 1  # the graph holds one K16 launch
            assert gather_mod._GATHER_ROWS.captured - captured <= 1
            assert gather_mod._GATHER_ROWS.launches - launches <= 1  # the warm launch only
            svc._use_jit = False
            e_allow, e_rule = svc._gathered_call(model, blob, offs, lens, rem)
            np.testing.assert_array_equal(_to_host(g_allow), _to_host(e_allow))
            np.testing.assert_array_equal(_to_host(g_rule), _to_host(e_rule))
        assert svc.graph_stats["captures"] == 1
        with pytest.raises(TypeError):
            np.asarray(torch.ones(2, device=cuda))  # why every readback is _to_host
    finally:
        svc.stop()


def test_graph_service_recaptures_after_a_policy_swap(cuda, tmp_path):
    """A service dispatching through CUDA graphs serves a whole-frame
    batch (the blob lane) equal to the in-process oracle, before and after
    a policy swap; the swap's new model gets graphs of its own."""
    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.proxylib.types import FilterResult
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
    from cilium_tpu_torch.utils.option import DaemonConfig

    def pol(rules):
        return NetworkPolicy(name="p", policy=2, ingress_per_port_policies=[
            PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
                remote_policies=[1, 3], l7_proto="r2d2", l7_rules=rules)])])

    frames = [b"READ /public/a.txt\r\n", b"READ /private/x\r\n", b"HALT\r\n", b"RESET\r\n"]

    def oracle(rules, conn_ids, msgs, remotes):
        mod = inst.open_module([("node-id", "oracle")], False)
        inst.find_instance(mod).policy_update([pol(rules)])
        out = []
        for cid, m, r in zip(conn_ids, msgs, remotes):
            _, conn = inst.on_new_connection(mod, "r2d2", cid, True, r, 2, "1.1.1.1:1",
                                             "2.2.2.2:80", "p")
            ops = []
            conn.on_data(False, False, [m], ops)
            out.append([(int(o), int(n)) for o, n in ops])
            inst.close_connection(cid)
        inst.close_module(mod)
        return out

    inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "swap.sock"), DaemonConfig(dispatch_mode="jit")).start()
    client = SidecarClient(svc.socket_path, timeout=120.0)
    try:
        rules0 = [{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}]
        mod = client.open_module([])
        assert client.policy_update(mod, [pol(rules0)]) == int(FilterResult.OK)
        ids = list(range(1, 301))
        remotes = [9 if i % 7 == 0 else 1 for i in ids]
        for cid, r in zip(ids, remotes):
            assert client.new_connection(mod, "r2d2", cid, True, r, 2, "1.1.1.1:1",
                                         "2.2.2.2:80", "p")[0] == int(FilterResult.OK)
        got, evt = {}, threading.Event()

        def cb(vb):
            got[vb.seq] = vb
            evt.set()

        client.verdict_callback = cb

        def round_trip(msgs):
            seq = next(client._seq)
            client.send_batch(seq, np.array(ids, np.uint64), np.zeros(len(ids), np.uint8),
                              np.array([len(m) for m in msgs], np.uint32), b"".join(msgs))
            assert evt.wait(60)
            while seq not in got:
                evt.clear()
                assert evt.wait(60)
            vb = got.pop(seq)
            per = {}
            for j in range(vb.count):
                cid, res, ops, _, _ = vb.entry(j)
                per.setdefault(int(cid), []).extend((int(o), int(n)) for o, n in ops)
            return [per[c] for c in ids]

        msgs = [frames[i % len(frames)] for i in ids]
        captures0 = svc.graph_stats["captures"]
        assert captures0 > 0
        assert round_trip(msgs) == oracle(rules0, ids, msgs, remotes)
        rules1 = [{"cmd": "RESET"}]
        assert client.policy_update(mod, [pol(rules1)]) == int(FilterResult.OK)
        assert svc.graph_stats["captures"] > captures0
        assert round_trip(msgs) == oracle(rules1, ids, msgs, remotes)
        assert svc.blob_chunks >= 2 and svc.status()["containment"]["refused_entries"] == {}
    finally:
        client.close()
        svc.stop()
        inst.reset_module_registry()


KAFKA_RULES = [
    ({}, ()), ({"topic": "a"}, (1, 2)), ({"role": "produce", "topic": "events"}, ()),
    ({"role": "consume"}, (3,)), ({"api_version": "2", "topic": "b"}, ()),
    ({"client_id": "producer-1"}, (1,)), ({"topic": "a", "client_id": "consumer-1"}, ()),
    ({"topic": "x" * 40}, ()), ({"topic": "y" * 200}, ()), ({"api_key": "findcoordinator", "topic": "c"}, ()),
]


def _kafka_case(rng, f, width, rules):
    pool = ["a", "b", "c", "events", "logs", "x" * 32, "x" * 40, "y" * 200]
    clients = ["producer-1", "consumer-1", "admin", "", "z" * 70]
    reqs = []
    for _ in range(f):
        n = int(rng.integers(0, 10))
        reqs.append(RequestMessage(
            api_key=int(rng.integers(-2, 71)), api_version=int(rng.integers(0, 3)),
            correlation_id=1, client_id=clients[int(rng.integers(len(clients)))],
            topics=[pool[int(i)] for i in rng.integers(0, len(pool), size=n)],
            parsed=bool(rng.random() < 0.7)))
    rows = []
    for kw, remotes in rules:
        r = PortRuleKafka(**kw)
        r.sanitize()
        rows.append((frozenset(remotes), r))
    return reqs, rows, encode_requests(reqs, topic_width=width), rng.integers(0, 5, size=f).astype(np.int32)


@pytest.mark.parametrize("width,f", [(32, 4099), (256, 4099), (32, 65536)])
def test_kafka_hits_kernel_matches_plain(cuda, width, f):
    """K17 against kafka_verdicts_plain and kafka_rule_hits, with
    out-of-range keys, 0-9 topics (overflow rows) and rule topics longer
    than the width."""
    rng = np.random.default_rng(width + f)
    for rules in (KAFKA_RULES, KAFKA_RULES[1:2], KAFKA_RULES[7:8]):
        reqs, rows, batch, remotes = _kafka_case(rng, f, width, rules)
        assert batch.overflow.any() and not batch.overflow.all()
        model = build_kafka_model(rows, device=cuda)
        tb = batch.to_device(cuda)
        rem = torch.from_numpy(remotes).to(cuda)
        before = kafka_mod._KAFKA_HITS.launches
        got = kafka_hits(model, tb, rem)
        allow, simple, cover = kafka_hits(model, tb, rem, parts=True)
        torch.cuda.synchronize()
        assert kafka_mod._KAFKA_HITS.launches == before + 2
        want = kafka_verdicts_plain(model, tb, rem)
        assert torch.equal(got, want) and torch.equal(allow, want)
        want_simple, want_cover = kafka_rule_hits(model, tb, rem)
        assert torch.equal(simple, want_simple) and torch.equal(cover, want_cover)
        if len(rules) > 1:
            assert bool(want.any()) and not bool(want.all())


def _kafka_equal(model, batch, rem):
    """K17 launched once a call on the card, with and without ``parts``,
    equal to its plain versions."""
    want = kafka_verdicts_plain(model, batch, rem)
    want_simple, want_cover = kafka_rule_hits(model, batch, rem)
    assert torch.equal(_one_launch(kafka_mod._KAFKA_HITS, kafka_hits, model, batch, rem), want)
    allow, simple, cover = _one_launch(kafka_mod._KAFKA_HITS, lambda *a: kafka_hits(*a, parts=True),
                                       model, batch, rem)
    assert torch.equal(allow, want) and torch.equal(simple, want_simple)
    assert torch.equal(cover, want_cover)
    return want


@pytest.mark.parametrize("offset", [0, 1])  # 16-byte and byte loads of the tables and batch
@pytest.mark.parametrize("w", kc.W_SIZES)
@pytest.mark.parametrize("r", kc.R_SIZES)
def test_kafka_hits_kernel_matches_plain_on_boundary_batches(cuda, r, w, offset):
    """kafka_cases' tables and batches at every F of F_SIZES."""
    t = kc.kafka_tables(r, w)
    model = kc.kafka_model(t, cuda, offset)
    for f in kc.F_SIZES:
        b, rem = kc.kafka_batch(t, f, w)
        want = _kafka_equal(model, kc.request_batch(b, cuda, offset), kc.at(cuda, rem, offset))
        if f >= 2048 and r > 2:
            assert bool(want.any()) and not bool(want.all())


def test_kafka_hits_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(3)
    _, rows, batch, remotes = _kafka_case(rng, 64, 32, KAFKA_RULES)
    model = build_kafka_model(rows, device=cuda)
    tb = batch.to_device(cuda)
    rem = torch.from_numpy(remotes).to(cuda)
    with pytest.raises(ValueError):
        kafka_hits(model, batch.to_device("cpu"), rem)
    with pytest.raises(ValueError):
        kafka_hits(model, tb, torch.from_numpy(np.repeat(remotes, 2)).to(cuda)[::2])
    with pytest.raises(TypeError):
        kafka_hits(model, tb, rem.to(torch.int64))


SEQ_PATTERNS = [r"abc", r"^abc", r"abc$", r"a.*c", r"(ab|cd)+", r"[a-z0-9_]+",
                r"/public/.*", r"^(GET|HEAD)$", r"a{2,4}"]
SEQ_ALPHABET = np.frombuffer(b"abcdxyz_/PGHET0123 ", np.uint8)


def _seq_batch(rng, f, width, n_chunks):
    data = rng.choice(SEQ_ALPHABET, size=(f, width)).astype(np.uint8)
    lengths = rng.integers(0, width + 1, size=f).astype(np.int32)
    lc = width // n_chunks
    lengths[: 3 * 5] = np.clip(np.repeat(np.arange(5) * lc, 3) + np.tile([-1, 0, 1], 5), 0, width)
    data[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return data, lengths


@pytest.mark.parametrize("patterns,f,width", [
    (SEQ_PATTERNS, 1027, 1024),
    ([f"/g{j:03d}/[a-z0-9]+/item/.*" for j in range(200)], 33, 256),  # table past shared memory
])
def test_seqdfa_kernel_matches_plain_and_serial(cuda, patterns, f, width):
    tables = compile_pattern_dfas(patterns)
    dfa = device_dfa(tables, cuda)
    dfa_abs = device_dfa_absorbing(tables, cuda)
    for n_chunks in (1, 4, 64):
        data, lengths = _seq_batch(np.random.default_rng(n_chunks), f, width, n_chunks)
        d, l = _to(cuda, data, lengths)
        before = (seqdfa_mod._SEQDFA_FOLD.launches, seqdfa_mod._SEQDFA_APPLY.launches)
        maps = seqdfa_fold(dfa_abs, d, l, n_chunks)
        got = seqdfa_apply(dfa_abs, maps)
        torch.cuda.synchronize()
        assert (seqdfa_mod._SEQDFA_FOLD.launches, seqdfa_mod._SEQDFA_APPLY.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(maps, seqdfa_fold_plain(dfa_abs, d, l, n_chunks))
        assert torch.equal(got, seqdfa_search_batch_plain(dfa_abs, d, l, n_chunks))
        assert torch.equal(got, dfa_search_batch(dfa, d, l))
        assert torch.equal(seqdfa_search_batch(dfa_abs, d, l, n_chunks), got)


def test_seqdfa_rejects_bad_inputs(cuda):
    dfa_abs = device_dfa_absorbing(compile_pattern_dfas(SEQ_PATTERNS), cuda)
    data, lengths = _seq_batch(np.random.default_rng(0), 16, 64, 4)
    d, l = _to(cuda, data, lengths)
    with pytest.raises(ValueError):
        seqdfa_fold(dfa_abs, d.cpu(), l.cpu(), 4)
    with pytest.raises(ValueError):
        seqdfa_fold(dfa_abs, d.t().contiguous().t(), l, 4)
    with pytest.raises(ValueError):
        seqdfa_fold(dfa_abs, d, l, 3)
    with pytest.raises(ValueError):
        seqdfa_apply(dfa_abs, seqdfa_fold(dfa_abs, d, l, 4).transpose(0, 2).contiguous().transpose(0, 2))


# K18 fold's two branches: the counters keep every start state apart (slow),
# test_seqdfa's patterns merge (fast); a set near 128 states keeps many apart.
SEQ_COUNTERS = ["^(a{13})*b", "^(a{11})*c"]
SEQ_WIDE = ["(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)", "a{124}", "x[ab]{40}y"]


def _edge_batch(rng, alphabet, f, width):
    """Frames over ``alphabet`` with lengths 0, the width, and one byte
    either side of every chunk edge of n_chunks 1, 8 and 64 and of every
    segment edge of K18's fold."""
    edges = {0, width}
    for step in {width // 8, width // 64, seqdfa_mod.fold_segment(f, width)}:
        for e in range(step, width, step):
            edges.update((e - 1, e, e + 1))
    edges = sorted(edges)
    lengths = rng.integers(0, width + 1, size=f).astype(np.int32)
    lengths[: len(edges)] = edges[:f]
    data = rng.choice(np.frombuffer(alphabet, np.uint8), size=(f, width)).astype(np.uint8)
    data[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return data, lengths


def _fold_checked(dfa, dfa_abs, d, l, n_chunks):
    """K18's fold with its branch counts: equal to the plain fold, K2 and
    the plain branch counts; one launch each.  Returns the counts."""
    dbg = torch.zeros(3, dtype=torch.int64, device=d.device)
    before = seqdfa_mod._SEQDFA_FOLD.launches
    maps = seqdfa_fold(dfa_abs, d, l, n_chunks, debug=dbg)
    torch.cuda.synchronize()
    assert seqdfa_mod._SEQDFA_FOLD.launches == before + 1
    assert torch.equal(maps, seqdfa_fold_plain(dfa_abs, d, l, n_chunks))
    assert torch.equal(seqdfa_apply(dfa_abs, maps), dfa_search_batch(dfa, d, l))
    counts = dbg.tolist()
    assert counts == seqdfa_fold_branches_plain(dfa_abs, d, l, n_chunks).tolist()
    return counts


@pytest.mark.parametrize("n_chunks", [1, 8, 64])
@pytest.mark.parametrize("which", ["counters", "near-128", "patterns"])
def test_seqdfa_fold_branches_match_plain_and_serial(cuda, which, n_chunks):
    """K18's fold against the plain fold and K2 at lengths on every chunk
    and segment edge; the counters run the slow branch only, the patterns
    the fast branch only, the set near 128 states both."""
    patterns, alphabet = {"counters": (SEQ_COUNTERS, b"a" * 63 + b"b"),
                          "near-128": (SEQ_WIDE, b"ababababababx"),
                          "patterns": (SEQ_PATTERNS, bytes(SEQ_ALPHABET))}[which]
    tables = compile_pattern_dfas(patterns)
    assert which != "near-128" or tables.n_states > 120
    data, lengths = _edge_batch(np.random.default_rng(n_chunks), alphabet, 256, 2048)
    d, l = _to(cuda, data, lengths)
    groups, chains, slow = _fold_checked(device_dfa(tables, cuda), device_dfa_absorbing(tables, cuda),
                                         d, l, n_chunks)
    assert groups > 0 and chains > 0
    if which == "counters":
        assert slow > 0.8 * groups
    elif which == "patterns":
        assert slow == 0
    else:
        assert 0 < slow < groups


@pytest.mark.parametrize("probe", ["none", "one byte", "past the segment"])
def test_seqdfa_fold_probe_lengths_match_plain(cuda, monkeypatch, probe):
    """No probe (every group with more than FOLD_DMAX live start states is
    slow), a one-byte probe, and a probe past the segment (the probe is
    the whole fold): the maps do not change."""
    f, width = 128, 1024
    past = seqdfa_mod.fold_segment(f, width) + 1
    monkeypatch.setattr(seqdfa_mod, "FOLD_PROBE", {"none": 0, "one byte": 1, "past the segment": past}[probe])
    tables = compile_pattern_dfas(SEQ_PATTERNS)
    data, lengths = _edge_batch(np.random.default_rng(len(probe)), bytes(SEQ_ALPHABET), f, width)
    d, l = _to(cuda, data, lengths)
    for n_chunks in (1, 8):
        groups, chains, slow = _fold_checked(device_dfa(tables, cuda), device_dfa_absorbing(tables, cuda),
                                             d, l, n_chunks)
        assert (slow > 0) == (probe == "none") and (chains == 0) == (probe == "past the segment")


@pytest.mark.parametrize("width,n_chunks,offset", [(1000, 8, 0), (1024, 4, 1), (96, 96, 3), (4096, 1, 0)])
def test_seqdfa_fold_odd_widths_and_views_match_plain(cuda, width, n_chunks, offset):
    """Chunks that are not a multiple of 16 bytes, one-byte chunks, a data
    view at a byte offset (staged a byte at a time) and a chunk longer
    than one pass of segments."""
    tables = compile_pattern_dfas(SEQ_PATTERNS)
    data, lengths = _seq_batch(np.random.default_rng(width), 67, width, n_chunks)
    flat = torch.zeros(offset + data.size, dtype=torch.uint8, device=cuda)
    flat[offset:] = torch.from_numpy(data.reshape(-1)).to(cuda)
    d = flat[offset:].view(data.shape)
    l = torch.from_numpy(lengths).to(cuda)
    _fold_checked(device_dfa(tables, cuda), device_dfa_absorbing(tables, cuda), d, l, n_chunks)


# --- K18 apply's paths (walk, staged) on merge_cases' maps ---------------------


@pytest.mark.parametrize("shape", mc.APPLY_SHAPES, ids=[s[0] for s in mc.APPLY_SHAPES])
def test_seqdfa_apply_paths_match_plain(cuda, shape):
    """The launcher's pick and every forced path equal the plain version
    on maps at byte offsets 0, 1 and 7 (K * S not a multiple of 16, F x R
    no multiple of the staged path's pairs a block, blocks of fewer than
    16 bytes, tiles past a block's budget, S = 1 to 128); one launch a
    call."""
    from cilium_tpu_torch.ops.seqdfa import seqdfa_apply_plain

    _, f, r, k, s = shape
    classmap, delta, start, accept, accept_final, maps = mc.apply_case(np.random.default_rng(f * k + s),
                                                                       f, r, k, s)
    dfa = dfa_from_arrays(classmap, delta, start, accept, accept_final, cuda)
    want = seqdfa_apply_plain(dfa_from_arrays(classmap, delta, start, accept, accept_final, "cpu"),
                              torch.from_numpy(maps))
    for offset in mc.APPLY_OFFSETS:
        m = mc.at_offset(maps, offset, cuda)
        assert m.data_ptr() % 16 == offset
        for path in seqdfa_mod.APPLY_PATHS:
            before = (seqdfa_mod._SEQDFA_APPLY.launches, seqdfa_mod._SEQDFA_APPLY_FORCED.launches)
            got = seqdfa_apply(dfa, m, None if path == "pick" else path)
            torch.cuda.synchronize()
            forced = path != "pick"
            assert (seqdfa_mod._SEQDFA_APPLY.launches, seqdfa_mod._SEQDFA_APPLY_FORCED.launches) == (
                before[0] + (not forced), before[1] + forced)
            assert torch.equal(got.cpu(), want), (shape, offset, path)


def test_seqdfa_apply_pick_is_the_mirrors(cuda):
    """The launcher's pick (kernels.seqdfa_apply_variant, from the library)
    is ops.seqdfa.apply_variant's at every phase-11 shape and beyond."""
    from cilium_tpu_torch.ops.seqdfa import APPLY_PATHS, apply_variant

    names = {v: k for k, v in APPLY_PATHS.items()}
    for f in (1, 3, 256, 2048, 10000):
        for r in (1, 2, 9):
            for s in (1, 16, 19, 127, 128):
                for k in (1, 7, 8, 64, 300, 2000):
                    path, pairs, kt = kernels.seqdfa_apply_variant(f, r, s, k)
                    assert (names[path], pairs, kt) == apply_variant(f, r, s, k), (f, r, s, k)


def test_seqdfa_apply_refuses_what_no_path_takes(cuda):
    """A path number past ApplyPath at the forced export, and an unknown
    path at the wrapper, raise; nothing falls back."""
    classmap, delta, start, accept, accept_final, maps = mc.apply_case(np.random.default_rng(0), 4, 2, 8, 19)
    dfa = dfa_from_arrays(classmap, delta, start, accept, accept_final, cuda)
    m = torch.from_numpy(maps).to(cuda)
    out = torch.empty((4, 2), dtype=torch.bool, device=cuda)
    p = kernels.p
    with pytest.raises(RuntimeError, match="seqdfa_apply_forced"):
        seqdfa_mod._SEQDFA_APPLY_FORCED.launch(cuda, p(m), p(dfa.start), p(dfa.accept_final), 4, 2, 19, 8,
                                               p(out), len(seqdfa_mod.APPLY_PATHS))
    with pytest.raises(ValueError):
        seqdfa_apply(dfa, m, "fast")


# --- K19 seam_probe and K20 rtt_tick ---------------------------------------------


@pytest.mark.parametrize("view", [0, 1], ids=["aligned", "view+4B"])
@pytest.mark.parametrize("f", [1, 2, 3, 4, 5, 513, 8192, 8195, 65536])
def test_seam_probe_kernel_matches_plain(cuda, f, view):
    """K19 on batches of 1 to 65,536 flows, on either side of a multiple
    of 4, and on lengths at a 4-byte offset (``view``) as well as at the
    start of an allocation."""
    from cilium_tpu_torch.models import base as base_mod

    rng = np.random.default_rng(f)
    lengths = rng.integers(-1, 257, f).astype(np.int32)
    lengths[0] = -1
    whole = torch.from_numpy(np.concatenate([np.zeros(view, np.int32), lengths])).to(cuda)
    lens = whole[view:]
    assert (lens.data_ptr() % 16 == 0) == (view == 0)
    for attr in (False, True):
        before = base_mod._SEAM_PROBE.launches
        got = base_mod.seam_probe(lens, attr=attr)
        torch.cuda.synchronize()
        assert base_mod._SEAM_PROBE.launches == before + 1
        want = base_mod.seam_probe_plain(lens, attr=attr)
        assert len(got) == len(want) == (4 if attr else 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.device == lens.device
            assert torch.equal(g, w)
        assert got[1].data_ptr() != lens.data_ptr()
    probe = base_mod.SeamProbe(device=cuda)
    out = probe.verdicts_attr(None, lengths, None)  # numpy in: copied to the card
    assert all(torch.equal(g, w) for g, w in zip(out, base_mod.seam_probe_plain(lens, attr=True)))
    with pytest.raises(TypeError):
        base_mod.seam_probe(lens.to(torch.int64))
    with pytest.raises(ValueError):
        base_mod.seam_probe(lens, device="cpu")


def test_rtt_tick_kernel_matches_plain(cuda):
    from cilium_tpu_torch.sidecar import latbench

    imax, imin = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    rng = np.random.default_rng(3)
    for x in (np.zeros(8, np.int32), np.array([imax, imin, -1, 0, 1, imax - 1, 7, -7], np.int32),
              rng.integers(imin, imax, 4099, dtype=np.int64).astype(np.int32)):
        t = torch.from_numpy(x).to(cuda)
        before = latbench._RTT_TICK.launches
        got = latbench.rtt_tick(t)
        torch.cuda.synchronize()
        assert latbench._RTT_TICK.launches == before + 1
        assert torch.equal(got, latbench.rtt_tick_plain(t))
    assert int(latbench.rtt_tick(torch.tensor([imax], dtype=torch.int32, device=cuda))[0]) == imin
    samples = []
    before = latbench._RTT_TICK.launches
    assert latbench.measure_device_rtt_ms(n=5, samples=samples) > 0
    assert len(samples) == 5 and latbench._RTT_TICK.launches == before + 6
    assert latbench.measure_uplink_mbps(n=2) > 0


def seam_service_ops(path, modes, n_conns=512, pkg=None, **cfg):
    """Each round's [(conn, result, ops, orig inject, reply inject)] from a
    seam_probe service (batch_flows 8,192, greedy, width 64; ``cfg`` adds
    to it) with latbench's policy and corpus over ``n_conns`` conns, one
    matrix or blob batch a round as ``modes`` says, and the service's
    seam_stages and status.  ``pkg`` is (VerdictService, DaemonConfig,
    SidecarClient, proxylib) of the package to drive, the port's by
    default (tests/test_torch_seam.py passes the JAX package's)."""
    from cilium_tpu_torch import proxylib as port_pl
    from cilium_tpu_torch.proxylib.types import FilterResult
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService, latbench
    from cilium_tpu_torch.utils.option import DaemonConfig

    svc_cls, cfg_cls, client_cls, pl = pkg or (VerdictService, DaemonConfig, SidecarClient, port_pl)
    cfg = dict(batch_flows=8192, batch_timeout_ms=0.0, batch_width=64, seam_probe=True, **cfg)
    svc = svc_cls(path, cfg_cls(**cfg)).start()
    client = client_cls(path, timeout=120.0)
    try:
        mod = client.open_module([])
        policy = pl.NetworkPolicy(name="latbench", policy=2, ingress_per_port_policies=[
            pl.PortNetworkPolicy(port=80, rules=[pl.PortNetworkPolicyRule(
                l7_proto="r2d2", l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])])])
        assert client.policy_update(mod, [policy]) == int(FilterResult.OK)
        msgs, lengths, blob, _ = latbench._corpus(n_conns)
        ids = np.arange(1, n_conns + 1, dtype=np.uint64)
        for cid in ids:
            assert client.new_connection(mod, "r2d2", int(cid), True, 1, 2, "1.1.1.1:1",
                                         "2.2.2.2:80", "latbench")[0] == int(FilterResult.OK)
        rows = np.zeros((n_conns, 64), np.uint8)
        for i, m in enumerate(msgs):
            rows[i, : len(m)] = np.frombuffer(m, np.uint8)
        got, evt = {}, threading.Event()

        def cb(vb):
            got[vb.seq] = vb
            evt.set()

        client.verdict_callback = cb
        out = []
        for seq, mode in enumerate(modes, start=100):
            if mode == "blob":
                client.send_blob(seq, ids, lengths, blob)
            else:
                client.send_matrix(seq, 64, ids, lengths, rows.tobytes(), complete=True)
            while seq not in got:
                evt.clear()
                assert evt.wait(60)
            vb = got.pop(seq)
            out.append([(int(c), int(r), [(int(o), int(n)) for o, n in ops], bytes(io), bytes(ir))
                        for c, r, ops, io, ir in (vb.entry(j) for j in range(vb.count))])
        return out, dict(svc.seam_stages), svc.status()
    finally:
        client.close()
        svc.stop()


@pytest.mark.parametrize("dispatch_mode", ["eager", "jit"])
def test_seam_probe_service_on_the_card_matches_cpu(cuda, tmp_path, dispatch_mode):
    """A seam_probe service on the card (K19, launched or replayed from a
    graph) answers the CPU service's ops, and its stages are recorded."""
    from cilium_tpu_torch.models import base as base_mod

    from cilium_tpu_torch.proxylib import instance as inst

    from cilium_tpu_torch.ops import gather as gather_mod

    k16, k19 = gather_mod._GATHER_ROWS, base_mod._SEAM_PROBE
    modes = ("matrix", "blob", "matrix", "blob")
    inst.reset_module_registry()
    before16 = (k16.launches, k16.replayed, k16.captured)
    before = k19.launches + k19.replayed
    rounds = []
    blob_rounds = ("blob",) * 3
    for mode_set in (modes, blob_rounds):
        # The probe reads no rows: its blob rounds build none (no K16
        # launched, captured or replayed), while K19 runs every round.
        got_k19 = k19.launches + k19.replayed
        out = seam_service_ops(str(tmp_path / f"card{len(rounds)}.sock"), mode_set,
                               dispatch_mode=dispatch_mode)
        assert (k16.launches, k16.replayed, k16.captured) == before16
        assert k19.launches + k19.replayed >= got_k19 + len(mode_set)
        rounds.append(out)
    got, stages, status = rounds[0]
    assert k19.launches + k19.replayed > before
    inst.reset_module_registry()
    want, cpu_stages, _ = seam_service_ops(str(tmp_path / "cpu.sock"), modes, verdict_device="cpu")
    inst.reset_module_registry()
    assert got == want
    assert set(stages) == set(cpu_stages) == {"concat", "eligibility", "device_issue",
                                              "readback", "respond"}
    assert status["containment"]["refused_entries"] == {}
    assert status["containment"]["readback_failures"] == 0


# --- the eighth slice: K21 / K22, the sharded search and the mesh service --------


@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("f", [1, 1000, 65537])
def test_shard_reduce_kernel_matches_plain(cuda, r, f):
    """K21 in both forms, with rows allowed by a shard that names no row
    (the INT32_MAX case)."""
    from cilium_tpu_torch.parallel import rulesharding as rs_mod
    from cilium_tpu_torch.parallel.rulesharding import shard_reduce, shard_reduce_plain

    rng = np.random.default_rng(10 * r + f)
    allow = rng.random((r, f)) < 0.3
    rule = np.where(allow, rng.integers(0, 500, (r, f)), -1).astype(np.int32)
    ghost = rng.random((r, f)) < 0.05
    allow |= ghost
    rule[ghost] = -1
    offsets = np.sort(rng.integers(0, 10_000, r)).astype(np.int32)
    a, ru, off = _to(cuda, allow, rule, offsets)
    launches = rs_mod._SHARD_REDUCE.launches
    assert torch.equal(shard_reduce(a).cpu(), shard_reduce_plain(*_to("cpu", allow)))
    got = shard_reduce(a, ru, off)
    want = shard_reduce_plain(*_to("cpu", allow, rule, offsets))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert rs_mod._SHARD_REDUCE.launches == launches + 2


@pytest.mark.parametrize("r", range(1, 9))
@pytest.mark.parametrize("f", [1, 15, 17, 65537])
@pytest.mark.parametrize("offset", [0, 1])
def test_shard_reduce_vector_widths_and_views_match_plain(cuda, r, f, offset):
    """K21 in both forms where F is not a multiple of its vector width and
    on views at a byte offset (rows that no vector load fits)."""
    from cilium_tpu_torch.parallel import rulesharding as rs_mod
    from cilium_tpu_torch.parallel.rulesharding import shard_reduce, shard_reduce_plain

    rng = np.random.default_rng(100 * r + f + offset)
    allow = rng.random((r, f)) < 0.3
    rule = np.where(allow, rng.integers(0, 500, (r, f)), -1).astype(np.int32)
    ghost = rng.random((r, f)) < 0.05
    allow |= ghost
    rule[ghost] = -1
    offsets = np.sort(rng.integers(0, 10_000, r)).astype(np.int32)
    flat = torch.zeros(offset + r * f, dtype=torch.bool, device=cuda)
    flat[offset:] = torch.from_numpy(allow.reshape(-1)).to(cuda)
    a = flat[offset:].view(r, f)
    rflat = torch.zeros(offset + r * f, dtype=torch.int32, device=cuda)
    rflat[offset:] = torch.from_numpy(rule.reshape(-1)).to(cuda)
    ru = rflat[offset:].view(r, f)
    off = torch.from_numpy(offsets).to(cuda)
    launches = rs_mod._SHARD_REDUCE.launches
    want = shard_reduce_plain(*_to("cpu", allow, rule, offsets))
    assert torch.equal(shard_reduce(a).cpu(), want[0])
    got = shard_reduce(a, ru, off)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert rs_mod._SHARD_REDUCE.launches == launches + 2


@pytest.mark.parametrize("r,f", [(1, 1), (2, 4099), (4, 65536)])
def test_kafka_shard_combine_kernel_matches_plain(cuda, r, f):
    """K22 with overflow rows and topic counts 0, 8 and past 8."""
    from cilium_tpu_torch.parallel.rulesharding import (
        kafka_shard_combine,
        kafka_shard_combine_plain,
    )

    rng = np.random.default_rng(r * 7 + f)
    simple = rng.random((r, f)) < 0.1
    cover = rng.random((r, f, 8)) < 0.7
    topic_count = rng.integers(0, 10, f).astype(np.int32)
    topic_count[: min(f, 3)] = [0, 8, 9][: min(f, 3)]
    overflow = rng.random(f) < 0.1
    args = (simple, cover, topic_count, overflow)
    got = kafka_shard_combine(*_to(cuda, *args))
    assert torch.equal(got.cpu(), kafka_shard_combine_plain(*_to("cpu", *args)))


@pytest.mark.parametrize("t", mc.COMBINE_T)
@pytest.mark.parametrize("r", range(1, 10))
def test_kafka_shard_combine_paths_match_plain(cuda, r, t):
    """K22's pick and every forced path on merge_cases' inputs (any
    nonzero byte true, topic counts -1, 0, T, T + 1), R = 1 to 9, F = 1,
    3, 4,099 and 4,100, aligned and at byte offsets; a path the inputs do
    not allow raises; one launch a call."""
    from cilium_tpu_torch.parallel import rulesharding as rs_mod

    for f in mc.COMBINE_F + ((65536,) if r in (1, 4, 8, 9) else ()):
        arrays = mc.combine_case(np.random.default_rng(31 * r + 7 * t + f), r, f, t)
        want = rs_mod.kafka_shard_combine_plain(*(torch.from_numpy(a != 0) if a.dtype == np.uint8
                                                  else torch.from_numpy(a) for a in arrays))
        for offs in mc.COMBINE_OFFSETS:
            s, c, tc, ov = (mc.at_offset(a, o, cuda, d) for a, o, d in
                            zip(arrays, offs, (torch.bool, torch.bool, torch.int32, torch.bool)))
            for path in rs_mod.COMBINE_PATHS:
                before = (rs_mod._KAFKA_SHARD_COMBINE.launches, rs_mod._KAFKA_SHARD_COMBINE_FORCED.launches)
                forced = path != "pick"
                if path == "flow" and rs_mod.combine_variant(c) != "flow":
                    with pytest.raises(RuntimeError, match="kafka_shard_combine_forced"):
                        rs_mod.kafka_shard_combine(s, c, tc, ov, path=path)
                    continue
                got = rs_mod.kafka_shard_combine(s, c, tc, ov, path=None if path == "pick" else path)
                torch.cuda.synchronize()
                assert (rs_mod._KAFKA_SHARD_COMBINE.launches,
                        rs_mod._KAFKA_SHARD_COMBINE_FORCED.launches) == (before[0] + (not forced),
                                                                          before[1] + forced)
                assert torch.equal(got.cpu(), want), (r, t, f, offs, path)
                assert set(got.view(torch.uint8).unique().tolist()) <= {0, 1}


@pytest.mark.parametrize("t", [1, 8, 13])
def test_kafka_shard_combine_pick_is_the_mirrors(cuda, t):
    """The launcher's pick (kernels.kafka_combine_variant, from the
    library) is rulesharding.combine_variant's, cover aligned and at byte
    offsets 1, 4 and 8."""
    from cilium_tpu_torch.parallel import rulesharding as rs_mod

    names = {v: k for k, v in rs_mod.COMBINE_PATHS.items()}
    cover = mc.combine_case(np.random.default_rng(t), 3, 4099, t)[1]
    for off in (0, 1, 4, 8):
        c = mc.at_offset(cover, off, cuda, torch.bool)
        assert names[kernels.kafka_combine_variant(c)] == rs_mod.combine_variant(c), (t, off)


def test_seqdfa_search_sharded_on_eight_slots_matches_k18(cuda):
    from cilium_tpu_torch.entry import seqdfa_batch, seqdfa_tables
    from cilium_tpu_torch.ops.seqdfa import SEQ_AXIS, seqdfa_search_sharded
    from cilium_tpu_torch.parallel import Mesh, virtual_devices

    tables = seqdfa_tables()
    data, lengths = seqdfa_batch(256, 4096, 8)
    d, ln = _to(cuda, data, lengths)
    dfa_abs = device_dfa_absorbing(tables, cuda)
    mesh = Mesh(np.array(virtual_devices(8, cuda), dtype=object), (SEQ_AXIS,))
    got = seqdfa_search_sharded(dfa_abs, d, ln, mesh)
    assert torch.equal(got, seqdfa_search_batch(dfa_abs, d, ln, 1))
    assert torch.equal(got, dfa_search_batch(device_dfa(tables, cuda), d, ln))


@pytest.mark.parametrize("dispatch_mode", ["eager", "jit"])
def test_mesh_service_on_four_slots_matches_cpu(cuda, tmp_path, monkeypatch, dispatch_mode):
    """A mesh="on", mesh_rule_shards=2 service on 4 slots of the card (a
    2 x 2 virtual mesh) answers as the same service on 4 CPU slots, in
    eager and CUDA-graph dispatch; K21 launches (or replays) on its path."""
    from cilium_tpu_torch.parallel import mesh as mesh_mod
    from cilium_tpu_torch.parallel import rulesharding as rs_mod
    from cilium_tpu_torch.parallel.mesh import virtual_devices
    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.proxylib.types import FilterResult
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
    from cilium_tpu_torch.utils.option import DaemonConfig

    pol = NetworkPolicy(name="p", policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=80, rules=[
            PortNetworkPolicyRule(remote_policies=[1, 3], l7_proto="r2d2",
                                  l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}]),
            PortNetworkPolicyRule(l7_proto="r2d2", l7_rules=[{"cmd": "WRITE", "file": "^/tmp/"}]),
        ])])
    traffic = [(b"READ /public/a.txt\r\n", 1), (b"READ /secret\r\n", 1), (b"HALT\r\n", 3),
               (b"HALT\r\n", 9), (b"WRITE /tmp/x\r\n", 9), (b"WRITE /etc/x\r\n", 1)] * 5

    def serve(device, mode):
        monkeypatch.setattr(mesh_mod, "local_devices",
                            lambda d=None: virtual_devices(4, device))
        inst.reset_module_registry()
        kw = dict(verdict_device="cpu") if device == "cpu" else {}
        svc = VerdictService(str(tmp_path / f"{device}-{mode}.sock"), DaemonConfig(
            dispatch_mode=mode, mesh="on", mesh_rule_shards=2, batch_timeout_ms=0.0,
            batch_flows=256, **kw)).start()
        client = SidecarClient(svc.socket_path, timeout=120.0)
        try:
            mod = client.open_module([])
            assert client.policy_update(mod, [pol]) == int(FilterResult.OK)
            outs = []
            for i, (frame, remote) in enumerate(traffic):
                res, shim = client.new_connection(mod, "r2d2", 100 + i, True, remote, 2,
                                                  "1.1.1.1:1", "2.2.2.2:80", "p")
                assert res == int(FilterResult.OK)
                outs.append(shim.on_io(False, frame))
                shim.close()
            st = svc.status()
            assert st["mesh"]["rung"] == "full" and st["mesh"]["devices"] == 4
            assert st["containment"]["refused_entries"] == {}
            eng = next(iter(svc._engines.values()))
            assert isinstance(eng.model, rs_mod.ShardedVerdictModel)
            return outs
        finally:
            client.close()
            svc.stop()
            inst.reset_module_registry()

    k21 = rs_mod._SHARD_REDUCE
    before = k21.launches + k21.replayed
    card = serve(cuda, dispatch_mode)
    assert k21.launches + k21.replayed > before
    assert card == serve("cpu", "eager")


# --- the ninth slice: K6 / K7 on a (flow, rule) grid and a lane group a flow --------

LIT_ALPHABET = np.frombuffer(b"GETPOSab/\n", np.uint8)


def _lit_model(rng, r, w, dev):
    """An HttpBatchModel of ``r`` rules straight from random tables: 0 to
    3 literal rows a rule and slot in no rule order, dead rows (as the
    padded shards have), exact and prefix rows of 0 to ``w`` bytes over a
    small alphabet (so they meet the spans), wildcard flags, method and
    path pattern columns, head patterns and remote sets."""
    tabs = {}
    for slot in ("m", "p"):
        n = max(1, int(r * rng.uniform(0.3, 2.0)))
        nlen = np.minimum(rng.geometric(0.25, n) - 1, w).astype(np.int32)
        needle = rng.choice(LIT_ALPHABET, (n, w)).astype(np.uint8)
        needle[np.arange(w)[None, :] >= nlen[:, None]] = 0
        tabs.update({
            f"{slot}_needle": needle, f"{slot}_len": nlen,
            f"{slot}_prefix": rng.random(n) < 0.3,
            f"{slot}_rule": rng.integers(0, r, n).astype(np.int32),
            f"{slot}_live": rng.random(n) < 0.85,
        })
    pl, p = max(1, r // 3), max(1, r // 4)
    head_rule = rng.integers(0, r, p).astype(np.int32)
    head_count = np.bincount(head_rule, minlength=r).astype(np.int32)
    head_count -= (rng.random(r) < 0.2).astype(np.int32) * (head_count > 0)
    remote_ids = np.where(rng.random((r, 32)) < 0.05, rng.integers(1, 6, (r, 32)), 0)
    tabs.update(
        method_any=rng.random(r) < 0.05, path_any=rng.random(r) < 0.05,
        line_rule=rng.integers(0, r, pl).astype(np.int32),
        line_slot=rng.integers(0, 2, pl).astype(np.int32),
        head_rule=head_rule, head_count=head_count,
        remote_ids=remote_ids.astype(np.int32), any_remote=rng.random(r) < 0.3,
    )
    return http_mod.HttpBatchModel(
        **{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in tabs.items()},
        line_nfa=None, head_nfa=None, n_rules=r)


def _lit_batch(rng, model, f, l=160):
    """Request lines whose method and path are the model's needles (the
    prefix rows' with a tail, an LF after the needle in some), empty
    spans and paths longer than LIT_W, then random bytes."""
    host = {k: getattr(model, k).cpu().numpy() for k in ("m_needle", "m_len", "p_needle", "p_len")}
    data = rng.choice(LIT_ALPHABET, (f, l)).astype(np.uint8)
    lengths = np.zeros((f,), np.int32)

    def token(slot):
        k = rng.integers(0, host[f"{slot}_len"].shape[0])
        tok = bytes(host[f"{slot}_needle"][k, : host[f"{slot}_len"][k]])
        roll = rng.random()
        if roll < 0.15:
            tok += bytes(rng.choice(LIT_ALPHABET, rng.integers(1, 6)))
        elif roll < 0.25:
            tok += b"a\nb"
        elif roll < 0.3:
            tok = b""
        elif roll < 0.35:
            tok = bytes(rng.choice(LIT_ALPHABET, rng.integers(60, 90)))
        return tok

    for i in range(f):
        head = token("m") + b" " + token("p") + b" HTTP/1.1\r\n\r\n"
        head = head[:l]
        data[i, : len(head)] = np.frombuffer(head, np.uint8)
        lengths[i] = len(head)
    return data, lengths


@pytest.mark.parametrize("r", [1, 5, 31, 32, 33, 257, 4097, 25000])
@pytest.mark.parametrize("f", [1, 127, 3001])
def test_http_lit_grid_matches_plain(cuda, r, f):
    """K6 on its (flow tile, rule tile) grid equals the plain version byte
    for byte, at R on both sides of every tile width and F on both sides
    of a flow tile; one launch a call."""
    rng = np.random.default_rng(r * 31 + f)
    model = _lit_model(rng, r, 16 if r > 4096 else 64, cuda)
    d, n = _to(cuda, *_lit_batch(rng, model, f))
    frame = http_frame(d, n)
    before = http_mod._HTTP_LIT.launches
    got = http_lit(model, d, frame)
    torch.cuda.synchronize()
    assert http_mod._HTTP_LIT.launches == before + 1
    want = http_lit_plain(model, d, frame)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if f > 1:
        assert bool(want[0].any()) and bool(want[1].any())


def _long_path_batch(rng, model, f, l=448):
    """Request lines whose path is one of the model's path needles and a
    tail to 255 bytes or more: 256 + the needle's length (which a length
    byte without the clamp at 255 would take for the needle's length), or
    255 to 320, an LF in the tail of some."""
    host = {k: getattr(model, k).cpu().numpy() for k in ("m_needle", "m_len", "p_needle", "p_len")}
    data = rng.choice(LIT_ALPHABET, (f, l)).astype(np.uint8)
    lengths = np.zeros((f,), np.int32)
    no_lf = LIT_ALPHABET[LIT_ALPHABET != ord("\n")]
    for i in range(f):
        k = rng.integers(0, host["m_len"].shape[0])
        method = bytes(host["m_needle"][k, : host["m_len"][k]])
        k = rng.integers(0, host["p_len"].shape[0])
        path = bytes(host["p_needle"][k, : host["p_len"][k]])
        n = 256 + len(path) if rng.random() < 0.5 else int(rng.integers(255, 321))
        tail = rng.choice(no_lf, n - len(path))
        if rng.random() < 0.2:
            tail[rng.integers(0, tail.shape[0])] = ord("\n")
        head = method + b" " + path + bytes(tail) + b" HTTP/1.1\r\n\r\n"
        data[i, : len(head)] = np.frombuffer(head, np.uint8)
        lengths[i] = len(head)
    return data, lengths


@pytest.mark.parametrize("r", [5, 33, 257])
def test_http_lit_long_paths_match_plain(cuda, r):
    """K6's length gate on paths of 255 bytes and more (the service's
    width of 256 and up makes them): exact rows never hit, prefix rows hit
    where no LF follows the needle, as in the plain version."""
    rng = np.random.default_rng(r + 7)
    model = _lit_model(rng, r, 64, cuda)
    d, n = _to(cuda, *_long_path_batch(rng, model, 1001))
    frame = http_frame(d, n)
    assert int((frame.sp2 - frame.p_start).min()) >= 255
    got = http_lit(model, d, frame)
    want = http_lit_plain(model, d, frame)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[1].any())


def _walk_inputs(rng, model, f, dev):
    """K7's inputs with the first rule that holds spread over the table:
    each flow's method density is drawn on a log scale, some heads are
    incomplete."""
    r = model.n_rules
    dens = 10.0 ** rng.uniform(-4.5, 0.0, (f, 1))
    method_ok = rng.random((f, r)) < dens
    path_ok = rng.random((f, r)) < 0.6
    pl, p = model.line_rule.shape[0], model.head_rule.shape[0]
    rx_m = rng.random((f, pl)) < 0.02
    rx_p = rng.random((f, pl)) < 0.3
    head = rng.random((f, p)) < 0.7
    complete = rng.random(f) < 0.9
    remotes = rng.integers(0, 6, f).astype(np.int32)
    return _to(dev, complete, method_ok, path_ok, rx_m, rx_p, head, remotes)


@pytest.mark.parametrize("r", [1, 5, 31, 32, 33, 257, 4097, 25000])
@pytest.mark.parametrize("f", [1, 127, 3001])
def test_http_hits_lane_groups_match_plain(cuda, r, f):
    """K7's lane groups equal the plain walk: allow and the first rule that
    holds, wherever it falls (past lane 31 of the first step included),
    with each of the pattern and head arguments present or absent."""
    rng = np.random.default_rng(r * 17 + f)
    model = _lit_model(rng, r, 8, cuda)
    complete, method_ok, path_ok, rx_m, rx_p, head, remotes = _walk_inputs(rng, model, f, cuda)
    firsts = []
    for args in ((rx_m, rx_p, head), (None, None, None), (rx_m, None, None),
                 (None, rx_p, None), (None, None, head)):
        before = http_mod._HTTP_HITS.launches
        got = http_hits(model, complete, method_ok, path_ok, *args, remotes)
        torch.cuda.synchronize()
        assert http_mod._HTTP_HITS.launches == before + 1
        want = http_hits_plain(model, complete, method_ok, path_ok, *args, remotes)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        firsts.append(want[1])
    if f == 3001 and r > 128:
        first = torch.cat(firsts)
        assert int(first.max()) > 128 and bool((first == -1).any())


def test_http_lit_and_hits_at_the_rules_100k_shard(cuda):
    """K6 and K7 on shard 0 of rules_100k (25,000 rules) at its batch of
    2,048 flows: equal to the plain versions, the HEAD probe allowed by
    the shard's last rule row only where that shard holds it."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.parallel.rulesharding import build_sharded_http_model

    shards = build_sharded_http_model(entry.rules_100k_rows(), 4, device=cuda)
    d, n, rem = _to(cuda, *entry.rules_100k_batch(2048))
    frame = http_frame(d, n)
    for model in (shards[0], shards[-1]):
        assert model.n_rules == 25000
        lit = http_lit(model, d, frame)
        want = http_lit_plain(model, d, frame)
        assert torch.equal(lit[0], want[0]) and torch.equal(lit[1], want[1])
        got = http_hits(model, frame.complete, *lit, None, None, None, rem)
        want = http_hits_plain(model, frame.complete, *lit, None, None, None, rem)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the HEAD rule is the table's last row: in the last shard only
    assert bool(got[0][1]) and not bool(got[0][0])


# --- the rule walks K4 and K9 on hits_cases' boundary batches -------------------

# With hits_cases.R_SIZES these row counts take every lane group the
# launchers take (test_hits_shapes_take_every_variant); 2,100 rows are
# staged in two tiles.
HITS_CARD_R = hc.R_SIZES + (4, 8, 13, 100, 300, 600, 2100)
# (W, L): needle widths of 4-byte words and of odd bytes, names past the
# 256 bytes staged a row (the rest compared from device memory)
DNS_CARD_WL = ((24, 64), (13, 61), (64, 40), (300, 400))


@pytest.fixture(scope="module")
def hits_forced():
    """Every (lanes, rows) variant of K4 and K9, built beside csrc by
    chip_hits_variants.build_forced (one library a kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the plain versions are tested on the CPU")
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_hits_variants

    return chip_hits_variants, chip_hits_variants.build_forced(log=lambda *a: None)


def _at(dev, a, offset):
    """numpy ``a`` on ``dev``, ``offset`` elements into its storage (a base
    that no 8- or 16-byte load takes, for offset 1 of a byte array)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    view = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)[offset:].view(t.shape)
    view.copy_(t)
    return view


def _r2d2_hits_case(dev, r, f, l, offset):
    t = hc.r2d2_tables(r)
    b = hc.r2d2_batch(t, f, l)
    model = r2d2_mod.R2d2BatchModel(nfa=None, **{k: _at(dev, v, offset) for k, v in t.items()})
    return model, [_at(dev, b[k], offset) for k in ("data", "sp", "file_ok", "remotes")]


def _dns_hits_case(dev, r, f, w, l, offset, rx):
    t = hc.dns_tables(r, w=w)
    b = hc.dns_batch(t, f, l, rx=rx)
    tabs = {k: _at(dev, v, offset) for k, v in t.items()}
    nfa = hc.Automaton(tabs["name_len"].device, r) if rx else None
    model = dns_mod.DnsBatchModel(nfa=nfa, **tabs)
    name = dns_mod.DnsName(*(_at(dev, b[k], offset) for k in ("valid", "span_start", "valid",
                                                                "span_start", "span_end", "dotted")))
    rx_t = _at(dev, b["rx"], offset) if rx else None
    return model, (name, rx_t, _at(dev, b["remotes"], offset))


def _hits_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("offset", [0, 4, 1])  # 16-, 4-byte and byte loads of file_ok
@pytest.mark.parametrize("r", HITS_CARD_R)
def test_r2d2_hits_kernel_matches_plain_on_boundary_batches(cuda, r, offset):
    for f in hc.F_SIZES if r < 2100 else (1031,):
        for l in (64, 6, 67):
            model, args = _r2d2_hits_case(cuda, r, f, l, offset)
            got = _one_launch(r2d2_mod._R2D2_HITS, r2d2_hits, model, *args)
            _hits_equal(got, r2d2_hits_plain(model, *args))


@pytest.mark.parametrize("rx", [True, False], ids=["rx", "no-rx"])
@pytest.mark.parametrize("offset", [0, 4, 1])
@pytest.mark.parametrize("r", HITS_CARD_R)
def test_dns_hits_kernel_matches_plain_on_boundary_batches(cuda, r, offset, rx):
    for f in hc.F_SIZES if r < 2100 else (1031,):
        for w, l in DNS_CARD_WL:
            model, args = _dns_hits_case(cuda, r, f, w, l, offset, rx)
            got = _one_launch(dns_mod._DNS_HITS, dns_hits, model, *args)
            _hits_equal(got, dns_hits_plain(model, *args))


HITS_VARIANTS = [f"{g}x{v}" for g in (1, 2, 4, 8, 16, 32) for v in (1, 4, 8, 16)]


@pytest.mark.parametrize("variant", HITS_VARIANTS)
def test_hits_variants_match_plain(cuda, hits_forced, variant):
    """Lane groups forced, taken by the launcher or not, on the boundary
    batches: R of every size to 300, F = 1,031 and 4,099, aligned and
    byte-loaded rows."""
    hv, fns = hits_forced
    g, v = hv.parse(variant)
    for r in hc.R_SIZES + (8, 300):
        for f in (1031, 4099):
            for offset in (0, 1):
                model, args = _r2d2_hits_case(cuda, r, f, (6, 64)[offset], offset)
                want = r2d2_hits_plain(model, *args)
                with hv.forced("r2d2_hits", fns[("r2d2_hits", g, v)]):
                    _hits_equal(_one_launch(r2d2_mod._R2D2_HITS, r2d2_hits, model, *args), want)
                w, l = DNS_CARD_WL[(r + offset) % len(DNS_CARD_WL)]
                for rx in (True, False):
                    model, args = _dns_hits_case(cuda, r, f, w, l, offset, rx)
                    want = dns_hits_plain(model, *args)
                    with hv.forced("dns_hits", fns[("dns_hits", g, v)]):
                        _hits_equal(_one_launch(dns_mod._DNS_HITS, dns_hits, model, *args), want)


def test_hits_variants_built_cover_every_pair(hits_forced):
    """build_forced builds every (lanes, rows) pair: the variants above
    and the rest the timing script reads."""
    hv, fns = hits_forced
    assert {(g, v) for _, g, v in fns} == {hv.parse(x) for x in hv.EVERY}
    assert sorted(HITS_VARIANTS) == sorted(hv.EVERY)


HITS_BIG_F = (16384, 20000, 65536)


@pytest.mark.parametrize("f", HITS_BIG_F)
@pytest.mark.parametrize("r", HITS_CARD_R[:-1])
def test_hits_kernels_match_plain_at_big_batches(cuda, r, f):
    """The main path's batch size and those between it and the engines',
    where the launchers take the fewest lanes."""
    model, args = _r2d2_hits_case(cuda, r, f, 64, 0)
    _hits_equal(_one_launch(r2d2_mod._R2D2_HITS, r2d2_hits, model, *args),
                r2d2_hits_plain(model, *args))
    model, args = _dns_hits_case(cuda, r, f, 24, 64, 0, True)
    _hits_equal(_one_launch(dns_mod._DNS_HITS, dns_hits, model, *args),
                dns_hits_plain(model, *args))


def test_hits_shapes_take_every_variant(cuda):
    """The row and flow counts of the tests above reach every variant the
    launchers take for 1 to 5,000 rows and 1 to 65,536 flows."""
    for stem in ("r2d2_hits", "dns_hits"):
        every = {kernels.hits_variant(stem, r, f) for r in range(1, 5001)
                 for f in (1, 1000, 2048, 4099, 16384, 65536)}
        tested = {kernels.hits_variant(stem, r, f) for r in HITS_CARD_R for f in hc.F_SIZES}
        tested |= {kernels.hits_variant(stem, r, f) for r in HITS_CARD_R[:-1] for f in HITS_BIG_F}
        assert every <= tested, sorted(every - tested)


# --- K8 and K17 in every launch variant ------------------------------------------


@pytest.fixture(scope="module")
def name_forced():
    """Every K8 variant of chip_frame_variants.NAME_VARIANTS, built beside
    csrc by chip_frame_variants.build_name_forced (one library)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the plain versions are tested on the CPU")
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_frame_variants

    return chip_frame_variants, chip_frame_variants.build_name_forced(log=lambda *a: None)


NAME_VARIANTS = ["1x4", "2x2", "2x4", "4x1", "4x2", "4x4", "8x1", "8x2", "16x1", "32x1", "2x2t128",
                 "4x1t128", "8x1t64", "16x1t64", "32x1t64"]


@pytest.mark.parametrize("variant", NAME_VARIANTS)
def test_dns_name_variants_match_plain(cuda, name_forced, variant):
    """K8 variants forced, taken by the launcher or not, on the boundary
    batches at every width, 37 and 4,099 rows, aligned and byte loads."""
    fv, fns = name_forced
    key = fv.parse_name(variant)
    kern = dns_mod._DNS_NAME
    own = kern._bind()
    kern._fn = fns[key]
    try:
        for l in dc.WIDTHS:
            for f in (37, 4099):
                data, lengths = dc.name_batch(l, f, seed=2)
                for offset in dc.OFFSETS:
                    _name_equal(dc.on_card_at(cuda, data, offset), torch.from_numpy(lengths).to(cuda))
    finally:
        kern._fn = own


def test_name_variants_built_cover_every_pick(cuda, name_forced):
    """The forced set holds every (lanes, chunks) the launcher takes for 1
    to 65,536 rows of 16 to 400 bytes, and test_dns_name_kernel_matches_plain
    launches every (lanes, chunks, aligned) pick; the variants list here is
    the script's."""
    fv, fns = name_forced
    assert sorted(NAME_VARIANTS) == sorted(fv.NAME_VARIANTS)
    buf = torch.empty(400 + 16, dtype=torch.uint8, device=cuda)

    def pick(f, l, off):
        return kernels.name_variant(buf[off: off + l].as_strided((f, l), (0, 1)))[:3]

    every = {pick(f, l, off) for l in range(16, 401) for f in (1, 37, 2048, 4099, 65536)
             for off in dc.OFFSETS}
    tested = {pick(f, l, off) for l in dc.CARD_WIDTHS for f in (*dc.F_SIZES, NAME_MANY_ROWS)
              for off in dc.OFFSETS}
    assert {(g, v) for g, v, _ in every} <= {key[:2] for key in fns}
    assert every <= tested, sorted(every - tested)


@pytest.fixture(scope="module")
def kafka_forced():
    """Every K17 variant of chip_hits_variants.KAFKA_VARIANTS, built beside
    csrc by chip_hits_variants.build_kafka_forced (one library)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the plain versions are tested on the CPU")
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_hits_variants

    return chip_hits_variants, chip_hits_variants.build_kafka_forced(log=lambda *a: None)


KAFKA_VARIANTS = ["1", "2", "4", "8", "16", "32", "1t32", "4t32", "16t32"]


@pytest.mark.parametrize("variant", KAFKA_VARIANTS)
def test_kafka_hits_variants_match_plain(cuda, kafka_forced, variant):
    """K17 variants forced (lanes a request; tables staged in tiles of 32
    rows where R > 32), parts on and off, on the boundary tables and
    batches: every R and W, F = 37 and 4,099, aligned and byte loads."""
    hv, fns = kafka_forced
    key = hv.parse_kafka(variant)
    with hv.forced("kafka_hits", fns[key]):
        for r in kc.R_SIZES:
            for w in kc.W_SIZES:
                t = kc.kafka_tables(r, w, seed=1)
                for offset in (0, 1):
                    model = kc.kafka_model(t, cuda, offset)
                    for f in (37, 4099):
                        b, rem = kc.kafka_batch(t, f, w, seed=1)
                        _kafka_equal(model, kc.request_batch(b, cuda, offset), kc.at(cuda, rem, offset))


def test_kafka_variants_built_cover_every_pick(cuda, kafka_forced):
    """The forced set holds every lane count the launcher takes for 1 to
    200 rows and 1 to 65,536 requests at T = 8; the variants list here is
    the script's."""
    hv, fns = kafka_forced
    assert sorted(KAFKA_VARIANTS) == sorted(hv.KAFKA_VARIANTS)
    every = {kernels.kafka_variant(r, f, 8) for r in range(1, 201) for f in (1, 37, 2048, 4099, 65536)}
    assert every <= {g for g, _ in fns}


# --- K10 and K11 in every launch variant ------------------------------------------

ACL_STEMS = ("cassandra_hits", "memcache_hits")
# The direct walk's last row count as the launchers take it (K10 9; K11
# has the direct walk alone; past 8 rows it takes the rest a row at a time).
ACL_DIRECT_ROWS = {"cassandra_hits": 9, "memcache_hits": None}
# R of l7_hits_cases, the direct walk's rows loaded at once (8) and K10's
# last row count and first lane walk, 17 (32 lanes at small F), rows past
# the staged remote ids, and 4,100 rows: staged in two tiles.
ACL_CARD_R = lc.R_SIZES + (8, 9, 10, 17, 33, 300, 4100)
# 16-byte loads, and every table and batch a view 5 elements into its
# storage (byte loads)
ACL_OFFSETS = (0, 5)
# with these at 2,048, 16,384 and 65,536 requests (the main path's size and
# the engines') the tests reach every pick (test_acl_shapes_take_every_variant)
ACL_BIG_R = (2, 3, 9, 10, 20, 33, 40, 70, 129, 300, 600)
ACL_BIG_F = (2048, 16384, 65536)


@functools.lru_cache(maxsize=None)
def _acl_host(stem, r, f, seed=0):
    """(tables, batch, rx) of l7_hits_cases in numpy; past 4,099 requests
    the 4,099-request batch cycled."""
    nc = len(TEXT_COMMANDS)
    if stem == "cassandra_hits":
        t = lc.cass_tables(r, seed)
        make = lambda n: lc.cass_batch(t, n, seed)  # noqa: E731
    else:
        t = lc.mc_tables(r, nc, seed)
        make = lambda n: lc.mc_batch(t, n, nc, seed)  # noqa: E731
    b = make(min(f, 4099))
    rx = lc.rx_hits(t, min(f, 4099))
    if f > 4099:
        b = {k: np.resize(v, (f, *v.shape[1:])) for k, v in b.items()}
        rx = None if rx is None else np.resize(rx, (f, r))
    return t, b, rx


def _acl_case(dev, stem, r, f, offset=0, seed=0):
    """(kernel, wrapper, plain version, model, the wrapper's arguments) on
    the card, every tensor ``offset`` elements into its storage."""
    t, b, rx = _acl_host(stem, r, f, seed)
    if stem == "cassandra_hits":
        model = lc.cass_model(t, dev, offset)
        keys = ("data", "action_len", "table_len", "non_query")
        kern, fn, plain = cass_mod._CASSANDRA_HITS, cassandra_hits, cassandra_hits_plain
    else:
        model = lc.mc_model(t, dev, offset)
        keys = ("key_data", "key_len", "has_key", "is_binary", "opcode", "cmd_id")
        kern, fn, plain = mc_mod._MEMCACHE_HITS, memcache_hits, memcache_hits_plain
    args = [lc.at(dev, b[k], offset) for k in keys]
    args += [None if rx is None else lc.at(dev, rx, offset), lc.at(dev, b["remotes"], offset)]
    return kern, fn, plain, model, args


@pytest.mark.parametrize("offset", ACL_OFFSETS)
@pytest.mark.parametrize("r", ACL_CARD_R)
@pytest.mark.parametrize("stem", ACL_STEMS)
def test_acl_hits_match_plain_on_boundary_batches(cuda, stem, r, offset):
    """The launcher's own pick on l7_hits_cases' tables and batches at F =
    1 to 4,099 (1,031 at 4,100 rows), one launch a call."""
    for f in lc.F_SIZES if r < 4100 else (1031,):
        kern, fn, plain, model, args = _acl_case(cuda, stem, r, f, offset)
        want = plain(model, *args)
        assert torch.equal(_one_launch(kern, fn, model, *args), want)
        if f >= 1031 and r <= 129:
            assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("f", ACL_BIG_F)
@pytest.mark.parametrize("r", ACL_BIG_R)
@pytest.mark.parametrize("stem", ACL_STEMS)
def test_acl_hits_match_plain_at_big_batches(cuda, stem, r, f):
    """The main path's batch size and the engines', where the launcher
    takes the fewest lanes."""
    kern, fn, plain, model, args = _acl_case(cuda, stem, r, f)
    assert torch.equal(_one_launch(kern, fn, model, *args), plain(model, *args))


def test_acl_shapes_take_every_variant(cuda):
    """The row and request counts of the two tests above reach every walk
    the launchers take for 1 to 5,000 rows and 1 to 65,536 requests, and
    the direct walk exactly up to each kernel's last row count (K11's
    always)."""
    for stem in ACL_STEMS:
        every = {kernels.hits_variant(stem, r, f) for r in range(1, 5001)
                 for f in (1, 37, 1031, 2048, 4099, 16384, 65536)}
        tested = {kernels.hits_variant(stem, r, f) for r in ACL_CARD_R for f in lc.F_SIZES}
        tested |= {kernels.hits_variant(stem, r, f) for r in ACL_BIG_R for f in ACL_BIG_F}
        assert every <= tested, sorted(every - tested)
        last = ACL_DIRECT_ROWS[stem]
        if last is None:
            assert every == {(0, 0)}
            continue
        assert kernels.hits_variant(stem, last, 65536) == (0, 0)
        assert kernels.hits_variant(stem, last + 1, 65536) != (0, 0)


@pytest.fixture(scope="module")
def acl_forced():
    """The direct walk of K10 and K11 and every (lanes, rows) variant of
    K10, built beside csrc by chip_hits_variants.build_forced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the plain versions are tested on the CPU")
    hv = _root_module("chip_hits_variants")
    return hv, hv.build_forced(hv.DIRECT, ("direct",) + hv.EVERY, log=lambda *a: None)


def _root_module(name):
    """A module of the repository's root (chip_smoke, the variants scripts)."""
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module(name)


ACL_VARIANTS = ["direct"] + HITS_VARIANTS


@pytest.mark.parametrize("variant", ACL_VARIANTS)
def test_acl_hits_variants_match_plain(cuda, acl_forced, variant):
    """Each walk a kernel has forced, taken by the launcher or not, on the
    boundary tables and batches: R of l7_hits_cases, 9 and 300, F = 1,031
    and 4,099, aligned and byte loads."""
    hv, fns = acl_forced
    g, v = hv.parse(variant)
    for stem in ACL_STEMS:
        if (stem, g, v) not in fns:  # K11 has no lane walk
            continue
        for r in lc.R_SIZES + (9, 300):
            for f in (1031, 4099):
                for offset in ACL_OFFSETS:
                    kern, fn, plain, model, args = _acl_case(cuda, stem, r, f, offset)
                    want = plain(model, *args)
                    with hv.forced(stem, fns[(stem, g, v)]):
                        assert torch.equal(_one_launch(kern, fn, model, *args), want)


def test_acl_variants_built_cover_every_pair(acl_forced):
    hv, fns = acl_forced
    assert {(s, g, v) for s, g, v in fns} == {("cassandra_hits", *hv.parse(x)) for x in ("direct",) + hv.EVERY} | {
        ("memcache_hits", 0, 0)}


def test_cassandra_stress_model_card_matches_cpu(cuda):
    """cassandra-stress (bench_stress's 40 regex rows and its mix): the
    card's verdicts, one K10 launch a call, equal the CPU model's and the
    host oracle's, and K10 takes the lane-group walk there."""
    cs = _root_module("chip_smoke")
    policy, reqs = cs.cassandra_stress_case()
    host = cs.cassandra_rows(reqs, 4099)
    card = build_cassandra_model(policy, True, 9042, device=cuda)
    cpu = build_cassandra_model(policy, True, 9042, device="cpu")
    assert card.n_rules == 40 and card.nfa is not None
    got = _one_launch(cass_mod._CASSANDRA_HITS, card, *host).cpu()
    assert torch.equal(got, cpu(*host))
    want = [policy.matches(True, 9042, 1, f"/query/{a}/{t}") for a, t, _ in reqs]
    assert got[: len(reqs)].tolist() == want
    assert kernels.hits_variant("cassandra_hits", 40, cs.F) != (0, 0)



# --- K12 / K13 on the indexes their tables carry --------------------------------
# tests/l34_index_cases.py's adversarial tables (duplicate keys, all-zero
# keys beside padding, keys >= 2^31, irregular masks, bits outside a mask,
# plen -1 / INT32_MAX, one row, every row invalid), tables of many mask
# groups and a wide table whose slots hold row ids, at F past a block's edge.

LPM_FORCED = ("1x1", "1x2", "1x4", "1x8", "1x16", "2x1", "2x2", "2x4", "4x1", "4x2", "4x4", "8x1", "8x2", "8x4",
              "walk")


@pytest.fixture(scope="module")
def lpm_forced():
    """Every K12 variant (L lanes an address and G groups a round, the
    walk), built beside csrc by chip_hits_variants.build_lpm_forced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the plain versions are tested on the CPU")
    hv = _root_module("chip_hits_variants")
    return hv, hv.build_lpm_forced(LPM_FORCED, log=lambda *a: None)


def _lpm_tables(cuda):
    """[(name, DeviceLpm on the card, address word tensors)]."""
    rng = np.random.default_rng(301)
    out = []
    cases_ = ic.lpm_cases(rng, 1) + ic.lpm_cases(rng, 4)
    cases_ += [(f"many{w}-{n}", *ic.many_group_lpm(rng, w, n)) for w, n in ((4, 256), (1, 1024), (4, 2048))]
    for name, *t in cases_:
        a = ic.addr_queries(rng, t[0], t[1], 3000)
        a = [np.concatenate([x, y]) for x, y in zip(a, ic.lpm_sources(rng, t[0], t[1], 4099))]
        out.append((name, lpm_from_arrays(*t, cuda), [torch.from_numpy(x).to(cuda) for x in a]))
    return out


@pytest.mark.parametrize("variant", ["pick", *LPM_FORCED])
def test_lpm_variants_match_plain(cuda, lpm_forced, variant):
    """The launcher's pick and each forced path (lanes and groups a round,
    the walk) equal the plain version on every table, F past a block's
    edge, one launch a call."""
    hv, fns = lpm_forced
    for name, lpm, a in _lpm_tables(cuda):
        want = lpm_lookup_plain(lpm, *a)
        before = lpm_mod._LPM.launches
        if variant == "pick":
            got = lpm_lookup(lpm, *a)
        else:
            with hv.forced("lpm", fns[variant]):
                got = lpm_lookup(lpm, *a)
        torch.cuda.synchronize()
        assert lpm_mod._LPM.launches == before + 1
        for g, wt in zip(got, want):
            assert torch.equal(g, wt), (name, variant)


def test_lpm_pick_follows_the_sweep(cuda):
    """The launcher walks where a table has fewer than 8 (v4) or 12 (v6)
    rows a mask group, else probes two groups a round with two lanes an
    address (v4) or one (v6) (lpm.cu Pick)."""
    lpm_lookup(_rand_lpm(np.random.default_rng(0), 4, 1, cuda)[0], torch.zeros(1, dtype=torch.int32, device=cuda))
    pick = kernels.lpm_variant
    assert pick(1, 1020, 25) == (2, 2) and pick(4, 256, 91) == (1, 0) and pick(4, 1027, 2) == (1, 2)
    assert pick(1, 199, 25) == (1, 0) and pick(1, 200, 25) == (2, 2) and pick(1, 1, 0) == (2, 2)
    assert pick(4, 1163, 97) == (1, 0) and pick(4, 1164, 97) == (1, 2)
    assert pick(4, 1535, 200) == (1, 0) and pick(4, 1536, 200) == (1, 2)  # past 128 groups: 128 staged


def _exact_cases(cuda):
    rng = np.random.default_rng(302)
    out = ic.exact_cases(rng) + [("wide", *ic.wide_table(rng))]
    for k, v in ((1, 15), (4, 11), (3, 1), (11, 4)):
        out.append((f"k{k}v{v}", *ic.exact_table(rng, k, 300, nv=v, pool=20)))
    return [(name, table_from_arrays(list(c), vals, valid, cuda), c) for name, c, vals, valid in out]


@pytest.mark.parametrize("f", [1, 4099, 65536])
def test_exact_lookup_on_adversarial_tables(cuda, f):
    """Every slot width (4, 8, 16), values in the slots or (K + V + 1 past
    16 words) read from the rows, duplicates summed with int32 wrap."""
    rng = np.random.default_rng(303 + f)
    for name, table, cols in _exact_cases(cuda):
        q = [torch.from_numpy(x).to(cuda) for x in ic.key_queries(rng, cols, f)]
        before = ml_mod._EXACT.launches
        got = exact_lookup(table, *q)
        torch.cuda.synchronize()
        assert ml_mod._EXACT.launches == before + 1
        want = exact_lookup_plain(table, *q)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


@pytest.mark.parametrize("nv", [1, 3, 5, 12])
def test_policy_kernel_on_adversarial_tables(cuda, nv):
    """8- and 16-word slots, and 12 value columns (the row id in the slot)."""
    rng = np.random.default_rng(304 + nv)
    for direction in (0, 1):
        leaves = ic._policy_leaves(rng, np.array([5, 9, 300, 1 << 31]), direction, n=300)
        vals = np.concatenate([leaves[4], ic.i32(rng.integers(0, 1 << 32, (300, nv - 1)))], 1)
        dmap = DevicePolicyMap(table=table_from_arrays(leaves[:4], vals, leaves[5], cuda))
        q = ic.key_queries(rng, np.stack(leaves[:4]), 4099)
        q[0][:500] = 0
        args = [torch.from_numpy(x).to(cuda) for x in q[:3]]
        got = policy_can_access_batch(dmap, *args, direction)
        want = policy_can_access_plain(dmap, *args, direction)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(want[0].any()) and not bool(want[0].all())


@pytest.mark.parametrize("w", [1, 4])
def test_lb_kernel_on_adversarial_tables(cuda, w):
    rng = np.random.default_rng(305 + w)
    for s in (1, 24, 300):
        leaves = ic.lb_arrays(rng, w, s=s)
        dlb = (DeviceLbMap if w == 1 else DeviceLb6Map).from_arrays(*leaves, cuda)
        f = 4099
        vw = np.asarray(leaves[0]).reshape(w, -1)
        pick = rng.integers(0, s, f)
        vips = [torch.from_numpy(np.where(rng.random(f) < 0.8, vw[c, pick], 0).astype(np.int32)).to(cuda)
                for c in range(w)]
        dport = torch.from_numpy(rng.choice(np.array([0, 80, 443, 8080], np.int32), f)).to(cuda)
        fh = torch.from_numpy(ic.i32(rng.integers(0, 1 << 32, f, dtype=np.int64))).to(cuda)
        got = lb_select(dlb, vips, dport, fh)
        want = lb_select_plain(dlb, vips, dport, fh)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        for g, wt in zip(got[1], want[1]):
            assert torch.equal(g, wt)


def test_k12_k13_launchers_refuse_tables_without_index(cuda):
    """Arguments without an index (or with slots of another width) raise;
    no launcher walks the rows instead, and nothing counts a launch."""
    import ctypes

    from cilium_tpu_torch.ops.l34_index import HashIx, LpmIx

    rng = np.random.default_rng(306)
    f = 256
    q = torch.zeros((f,), dtype=torch.int32, device=cuda)
    out_b = torch.empty((f,), dtype=torch.bool, device=cuda)
    out_i = torch.empty((4, f), dtype=torch.int32, device=cuda)
    lpm, _ = _rand_lpm(rng, 40, 1, cuda)
    table = table_from_arrays(list(ic.exact_table(rng, 5, 64)[0]), np.zeros((64, 1), np.int32),
                              np.ones(64, bool), cuda)
    leaves = ic._policy_leaves(rng, np.array([5]), 1)
    dmap = DevicePolicyMap(table=table_from_arrays(leaves[:4], leaves[4], leaves[5], cuda))
    dlb = DeviceLbMap.from_arrays(*ic.lb_arrays(rng, 1), cuda)
    arr4 = ctypes.c_void_p * 4
    wrong = HashIx(table.index.abi().bounds, table.index.abi().slots, table.index.abi().mask, 4)
    calls = [
        (lpm_mod._LPM, lpm_mod.LpmArgs(lpm.abi(), arr4(q.data_ptr()), f, out_b.data_ptr(), out_i[0].data_ptr(),
                                       out_i[1].data_ptr(), LpmIx())),
        (ml_mod._EXACT, ml_mod.ExactArgs(table.abi(), (ctypes.c_void_p * 11)(*[q.data_ptr()] * 5), f,
                                         out_b.data_ptr(), out_i.data_ptr(), HashIx())),
        (ml_mod._EXACT, ml_mod.ExactArgs(table.abi(), (ctypes.c_void_p * 11)(*[q.data_ptr()] * 5), f,
                                         out_b.data_ptr(), out_i.data_ptr(), wrong)),
        (pol_mod._POLICY, pol_mod.PolicyArgs(dmap.table.abi(), q.data_ptr(), q.data_ptr(), q.data_ptr(), 1, f,
                                             out_b.data_ptr(), out_i[0].data_ptr(), HashIx())),
        (lb_mod._LB, lb_mod.LbArgs(dlb.abi(), arr4(q.data_ptr()), q.data_ptr(), q.data_ptr(), f, out_b.data_ptr(),
                                   arr4(out_i[0].data_ptr()), out_i[1].data_ptr(), out_i[2].data_ptr(), HashIx())),
    ]
    for kern, args in calls:
        before = kern.launches
        with pytest.raises(RuntimeError):
            kern.launch(cuda, ctypes.addressof(args))
        assert kern.launches == before


@pytest.mark.parametrize("source", ["lpm", "exact", "lb"])
def test_table_index_build_waits_for_nothing(cuda, source):
    """Each table class builds its index on the card with no op that waits
    for the device, and builds the same index again."""
    rng = np.random.default_rng(307)
    if source == "lpm":
        table = lpm_from_arrays(*ic.many_group_lpm(rng, 4, 256), cuda)
    elif source == "exact":
        cols, vals, valid = ic.wide_table(rng)
        table = table_from_arrays(list(cols), vals, valid, cuda)
    else:
        table = DeviceLb6Map.from_arrays(*ic.lb_arrays(rng, 4, s=40), cuda)
    built = table.index
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        table.__post_init__()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert table.index is not built
    for a, b in zip(_index_tensors(table.index), _index_tensors(built)):
        assert torch.equal(a, b)


# --- the agent: a daemon on the card against the same daemon on the CPU ----------------


def _daemon_world(tmp_path, device):
    """A port ``Daemon`` at ``verdict_device`` ``device`` ("default" is the
    card) with 4 endpoints against ``entry.policy_rules(64)`` and 16
    identities, seeded: per endpoint its K13 outputs on its exported map and
    its HTTP and Kafka redirect engines' ops on seeded feeds, proxy ports as
    the redirects they name."""
    import json
    import random
    import time

    from cilium_tpu_torch import entry
    from cilium_tpu_torch import kvstore as kv_mod
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.labels import Labels
    from cilium_tpu_torch.maps import policymap as pol_mod
    from cilium_tpu_torch.policy import proxy_id, rules_from_json
    from cilium_tpu_torch.utils import option
    from cilium_tpu_torch.utils.option import DaemonConfig

    random.seed(64)
    saved = option.config, kv_mod._default_client
    ids = entry.policy_identities()
    doc = entry.policy_rules(64)
    ranked = sorted(sorted(ids), key=lambda n: -sum(
        all(f"{k}={v}" in ids[n] for k, v in r["endpointSelector"]["matchLabels"].items()) for r in doc))
    root = tmp_path / device
    d = Daemon(DaemonConfig(run_dir=str(root), socket_path=str(root / "a.sock"),
                            monitor_socket_path=str(root / "m.sock"), enable_health=False,
                            verdict_device=device))
    try:
        for n in ranked[4:16]:
            d.identity_allocator.allocate(Labels.from_model(ids[n]))
        rev = d.policy_add(rules_from_json(json.dumps(doc)))
        eps = [d.endpoint_create(i + 1, ipv4=f"10.50.0.{i + 1}", labels=ids[n]) for i, n in enumerate(ranked[:4])]
        deadline = time.monotonic() + 300
        while not all(ep.state.value == "ready" and ep.policy_revision >= rev for ep in eps):
            assert time.monotonic() < deadline, "endpoints not ready"
            time.sleep(0.05)
        assert d.build_queue.wait_idle(60)
        port_of = {r.proxy_port: pid for pid, r in d.proxy_manager.redirects.items()}
        cache = sorted(d.get_identity_cache())
        rng = np.random.default_rng(9)
        q = [torch.from_numpy(a).to(d.device) for a in (
            rng.choice(np.asarray(cache + [4242], np.int32), 4096),
            rng.choice(np.array([0, 80, 9092, 443], np.int32), 4096),
            rng.choice(np.array([0, 6, 17], np.int32), 4096))]
        heads = entry.policy_http_requests(256, seed=41)
        frames = entry.policy_kafka_frames(256, seed=42)
        out = {}
        for ep in eps:
            assert ep.device_policy_map.device.type == d.device.type
            allowed, port = (x.cpu() for x in pol_mod.policy_can_access_batch(
                ep.device_policy_map, *q, pol_mod.DIR_INGRESS))
            ops = {}
            for dport, stream in ((80, heads), (9092, frames)):
                red = d.proxy_manager.redirects.get(proxy_id(ep.id, True, "TCP", dport))
                if red is None or red.implementation is None:
                    continue
                eng = red.implementation
                assert next(t for t in vars(eng.model).values() if isinstance(t, torch.Tensor)).device.type \
                    == d.device.type
                got = []
                for fid in range(256):
                    eng.feed(fid, stream[(fid * 7) % len(stream)], remote_id=cache[(fid * 13) % len(cache)])
                eng.pump()
                for fid in range(256):
                    taken = eng.take_ops(fid)
                    got.append(([(int(o), n) for o, n in taken[0]], taken[-1]))
                ops[dport] = got
            out[ep.id] = (ep.security_identity.id, allowed.tolist(), [port_of.get(int(p), int(p)) for p in port],
                          sorted(ep.realized_redirects), ops)
        return out
    finally:
        d.close()
        option.config, kv_mod._default_client = saved


def test_daemon_on_the_card_matches_the_daemon_on_the_cpu(cuda, tmp_path):
    card = _daemon_world(tmp_path, "default")
    cpu = _daemon_world(tmp_path, "cpu")
    assert card == cpu
    assert any(ops for *_, ops in card.values())
    assert all(any(allowed) and not all(allowed) for _, allowed, *_ in card.values())


def test_daemon_on_the_card_launches_k13_and_the_engines(cuda, tmp_path):
    from cilium_tpu_torch.maps import policymap as pol_mod

    before = (pol_mod._POLICY.launches, http_mod._HTTP_FRAME.launches, kafka_mod._KAFKA_HITS.launches)
    _daemon_world(tmp_path, "default")
    after = (pol_mod._POLICY.launches, http_mod._HTTP_FRAME.launches, kafka_mod._KAFKA_HITS.launches)
    assert after[0] - before[0] == 4 and after[1] > before[1] and after[2] > before[2]


# --- the agent's front doors on the card --------------------------------------------


def _k8s_node(tmp_path, device):
    """tests/k8s_world.py's node at SMALL on a port ``Daemon`` at
    ``verdict_device`` ``device`` ("default" is the card), seeded: per
    endpoint its realized map and K13 outputs (identities by labels, proxy
    ports as presence), K13's LB outputs on the watcher's LB map, and the
    HTTP verdicts of a verdict service on the node's NPDS."""
    import ipaddress
    import random

    import k8s_world as kw
    from cilium_tpu_torch import kvstore as kv_mod
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.maps import lbmap as lb_mod
    from cilium_tpu_torch.maps import policymap as pol_mod
    from cilium_tpu_torch.proxy.npds_push import network_policy_for_endpoint
    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
    from cilium_tpu_torch.utils import option
    from cilium_tpu_torch.utils.option import DaemonConfig

    random.seed(43)
    saved = option.config, kv_mod._default_client
    inst.reset_module_registry()
    root = tmp_path / f"k8s-{device}"
    d = Daemon(DaemonConfig(run_dir=str(root), socket_path=str(root / "a.sock"), monitor_socket_path=str(root / "m.sock"),
                            enable_health=False, verdict_device=device), node_name="node-0")
    svc = VerdictService(str(root / "vs.sock"), DaemonConfig(batch_timeout_ms=2.0, verdict_device=device)).start()
    w = client = None
    try:
        w = kw.build_world(kw.modules("cilium_tpu_torch"), d, kw.SMALL, seed=5)
        by_labels = sorted(kw.labels_of(w, i) for i in d.get_identity_cache())
        id_of = {kw.labels_of(w, i): i for i in d.get_identity_cache()}
        rng = np.random.default_rng(11)
        pick = rng.integers(0, len(by_labels), 2048)
        ident = np.array([id_of[by_labels[j]] for j in pick], np.int32)
        dport = rng.choice(np.array([80, 443, 5432, 8080, 0], np.int32), 2048)
        proto = rng.choice(np.array([6, 17, 0], np.int32), 2048)
        q = [torch.from_numpy(a).to(d.device) for a in (ident, dport, proto)]
        out = {}
        for ep in w.endpoints():
            assert ep.device_policy_map.device.type == d.device.type
            allowed, port = (x.cpu().numpy() for x in pol_mod.policy_can_access_batch(ep.device_policy_map, *q,
                                                                                       pol_mod.DIR_INGRESS))
            out[ep.id] = (sorted((kw.labels_of(w, k.identity), k.dest_port, k.proto, k.direction, v.proxy_port != 0)
                                 for k, v in ep.realized_map_state.items()),
                          allowed.astype(bool).tolist(), (port != 0).tolist())
        vips = np.array([int(ipaddress.IPv4Address(kw.service_vip(s))) for s in range(kw.SMALL.services)] + [1],
                        np.int64)
        lbq = [torch.from_numpy(a).to(d.device) for a in (
            vips[rng.integers(0, len(vips), 2048)].astype(np.uint32).view(np.int32),
            rng.choice(np.array([80, 443], np.int32), 2048),
            rng.integers(0, 1 << 31, 2048).astype(np.int32))]
        out["lb"] = [x.cpu().numpy().tolist() for x in lb_mod.lb4_select_backend_batch(
            d.lb_map.to_device(device=d.device), *lbq)]
        d.attach_verdict_service(svc.socket_path)
        client = SidecarClient(svc.socket_path)
        out["verdicts"], _ = kw.shim_verdicts(w, network_policy_for_endpoint, client, client.open_module([]), 100)
        return out
    finally:
        if client is not None:
            client.close()
        if w is not None:
            w.close()
        d.close()
        svc.stop()
        inst.reset_module_registry()
        option.config, kv_mod._default_client = saved


def test_k8s_node_on_the_card_matches_the_node_on_the_cpu(cuda, tmp_path):
    card = _k8s_node(tmp_path, "default")
    cpu = _k8s_node(tmp_path, "cpu")
    assert card == cpu
    assert any(any(v[1]) for k, v in card.items() if isinstance(k, int))
    assert any(card["lb"][0]) and not all(card["lb"][0])
    outs = [b for v in card["verdicts"].values() for b in v[1:-1]]
    assert outs and any(outs) and not all(outs)


def _nvidia_smi_name():
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def test_bugtool_names_the_card(cuda, tmp_path):
    import json
    import tarfile

    from cilium_tpu_torch import kvstore as kv_mod
    from cilium_tpu_torch.api import ApiClient, ApiServer
    from cilium_tpu_torch.bugtool import collect
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.utils import option
    from cilium_tpu_torch.utils.option import DaemonConfig

    saved = option.config, kv_mod._default_client
    d = Daemon(DaemonConfig(run_dir=str(tmp_path), socket_path=str(tmp_path / "a.sock"),
                            monitor_socket_path=str(tmp_path / "m.sock"), enable_health=False))
    srv = ApiServer(d, str(tmp_path / "api.sock"))
    try:
        manifest = collect(ApiClient(str(tmp_path / "api.sock")), str(tmp_path / "b.tar.gz"))
        with tarfile.open(tmp_path / "b.tar.gz") as tar:
            device = json.load(tar.extractfile("cilium-tpu-bugtool/device.json"))
    finally:
        srv.close()
        d.close()
        option.config, kv_mod._default_client = saved
    assert manifest["sections"]["device.json"]["ok"] and device["backend"] == "cuda"
    assert device["device_count"] == torch.cuda.device_count() >= 1
    name = device["devices"][0]["name"]
    assert name == torch.cuda.get_device_name(0) == _nvidia_smi_name() and "H100" in name
    assert device["devices"][0]["capability"] == list(torch.cuda.get_device_capability(0))


def test_agent_process_on_the_card_stops_on_sigterm(cuda, tmp_path):
    import os
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    from cilium_tpu_torch.api import ApiClient

    root = str(Path(__file__).resolve().parent.parent)
    run_dir = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log = open(tmp_path / "agent.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "cilium_tpu_torch.agent", "--run-dir", str(run_dir),
                             "--no-restore"], cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, (tmp_path / "agent.log").read_text()[-2000:]
            try:
                status = ApiClient(str(run_dir / "cilium-tpu.sock")).get("/v1/status")
                break
            except OSError:
                assert time.monotonic() < deadline, "the agent did not serve its API"
                time.sleep(0.2)
        assert status["cilium"]["state"] == "Ok"
        # The API serves before the agent binds its access-log and NPDS
        # sockets: wait for all four, within the same deadline.
        want = ["access_log.sock", "cilium-tpu.sock", "monitor.sock", "npds.sock"]
        while (socks := sorted(f for f in os.listdir(run_dir) if f.endswith(".sock"))) != want:
            assert proc.poll() is None and time.monotonic() < deadline, socks
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
        assert not [f for f in os.listdir(run_dir) if f.endswith(".sock")]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        log.close()


# --- device contracts on the card (analysis/devicecheck.py) ---------------


@pytest.fixture(scope="module")
def card_contracts():
    """``check_device_contracts`` on the card (its default), once, with
    every traced model and sharded step's capture."""
    from cilium_tpu_torch.analysis import devicecheck

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    captures = []
    findings = devicecheck.check_device_contracts(captures=captures)
    return findings, {tag: (fn, cap) for tag, fn, cap in captures}


def test_device_contracts_clean_on_the_card(cuda, card_contracts):
    findings, caps = card_contracts
    assert findings == [], "\n".join(f.render() for f in findings)
    assert {"r2d2.plain", "r2d2.attr", "http.attr", "dns.attr",
            "seam_probe.plain", "sharded_kafka_step@4x2"} <= set(caps)


def test_model_graphs_hold_their_kernels(cuda, card_contracts):
    """A capture records one launch a kernel op of the trace: the graph's
    launches are the trace's kernel ops, and the attributed graph holds
    the plain graph's (no second pass)."""
    _, caps = card_contracts
    for tag, (_fn, cap) in caps.items():
        if "@" in tag:
            continue
        assert cap.graph is not None and cap.held, tag
        ops = cap.trace.kernel_counts()
        assert set(cap.launches()) == set(ops), tag
    for fam in ("r2d2", "http", "dns", "seam_probe"):
        assert caps[f"{fam}.attr"][1].launches() == caps[f"{fam}.plain"][1].launches()
    assert caps["r2d2.plain"][1].launches() == {"r2d2_frame": 1, "dfa_scan": 1, "r2d2_hits": 1}


@pytest.mark.parametrize("seed", [1, 2])
def test_contract_graph_replays_match_the_cpu_twins(cuda, card_contracts, seed):
    """Every captured graph replayed on fresh rows equals its CPU twin
    (the kernels' plain versions) on the same rows, and a replay adds
    exactly the launches its graph holds."""
    from cilium_tpu_torch.analysis import devicecheck

    _, caps = card_contracts
    twins = devicecheck.case_calls("cpu")
    rows = devicecheck.batch(cuda, seed=seed)
    cpu_rows = devicecheck.batch("cpu", seed=seed)
    for tag, (_fn, cap) in caps.items():
        twin_fn, twin_args = twins[tag]
        if isinstance(cap.ins[0], torch.Tensor):
            for dst, src in zip(cap.ins, rows):
                dst.copy_(src)
            twin_args = cpu_rows
        before = {k.symbol: k.replayed for k in kernels.ALL}
        cap.graph.replay()
        kernels.add_replays(cap.held)
        torch.cuda.synchronize()
        after = {k.symbol: k.replayed - before[k.symbol] for k in kernels.ALL}
        assert {k: n for k, n in after.items() if n} == cap.launches(), tag
        got = devicecheck._outputs(cap.outs)
        want = devicecheck._outputs(twin_fn(*twin_args))
        assert len(got) == len(want), tag
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), tag


def test_capture_of_a_host_sync_is_a_finding(cuda):
    """A model that reads to the host inside its call cannot be
    captured: the contract reports it, it never runs eagerly instead."""
    from cilium_tpu_torch.analysis import devicecheck

    class _Sync:
        def __call__(self, data, lengths, remotes):
            ok = lengths >= 0
            return ok, lengths + int(lengths.sum()), ok

    findings = devicecheck._check_model("sync", "x.py", _Sync(), cuda)
    assert any(f.rule in ("R8", "R9") for f in findings), [f.render() for f in findings]


def test_credit_starvation_neighbor_p99_bounded_on_the_card(cuda, tmp_path):
    """tests/test_fanin.py's starvation scenario on a service whose models
    run on the card, with the reference's parameters and bound: one
    session floods from 64 conns over its fair share while 15 light
    sessions keep serving, and every light session's p99 stays within
    max(25 x the no-flood baseline, 1 s)."""
    import time

    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.proxylib.types import FilterResult
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
    from cilium_tpu_torch.utils.option import DaemonConfig

    pol = NetworkPolicy(name="sidecar-pol", policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
            remote_policies=[1, 3], l7_proto="r2d2",
            l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])])])

    def open_conn(client, conn_id):
        mod = client.open_module([])
        assert client.policy_update(mod, [pol]) == int(FilterResult.OK)
        res, shim = client.new_connection(mod, "r2d2", conn_id, True, 1, 2, "1.1.1.1:1", "2.2.2.2:80",
                                          "sidecar-pol")
        assert res == int(FilterResult.OK)
        return mod, shim

    inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "starve.sock"), DaemonConfig(
        batch_timeout_ms=2.0, batch_flows=256, dispatch_mode="eager", shed_queue_entries=4096,
        session_share_min=128, session_flood_strikes=0)).start()
    hot = SidecarClient(svc.socket_path, timeout=60.0, identity="pod-hot")
    lights = [SidecarClient(svc.socket_path, timeout=60.0, identity=f"pod-light-{i}") for i in range(15)]
    stop = threading.Event()
    try:
        hot_mod, _ = open_conn(hot, 5500)
        hot_ids = [5500] + list(range(5501, 5564))
        for cid in hot_ids[1:]:
            res, _ = hot.new_connection(hot_mod, "r2d2", cid, True, 1, 2, f"1.1.1.9:{cid}", "2.2.2.2:80",
                                        "sidecar-pol")
            assert res == int(FilterResult.OK)
        light_shims = [open_conn(c, 5600 + i)[1] for i, c in enumerate(lights)]
        frame = b"HALT\r\n"
        for c, s in zip(lights, light_shims):
            assert c._on_data_rpc(s.conn_id, False, False, frame)[0] == int(FilterResult.OK)
        msg = b"READ /public/flood.txt\r\n"
        warm_done = set()
        hot.verdict_callback = lambda vb: warm_done.add(vb.seq)
        ids = np.array(hot_ids, np.uint64)
        lens = np.full(len(ids), len(msg), np.uint32)
        blob = msg * len(ids)
        for w in range(12):
            hot.send_batch(90_000 + w, ids, [0] * len(ids), lens, blob)
        deadline = time.monotonic() + 60
        while len(warm_done) < 12:
            assert time.monotonic() < deadline, "flood-shape prewarm"
            time.sleep(0.02)

        def light_p99(window_s):
            lats, k = [], 0
            t_end = time.monotonic() + window_s
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

        def flood():
            seq = 50_000
            while not stop.is_set():
                seq += 1
                try:
                    hot.send_batch(seq, ids, [0] * len(ids), lens, blob)
                except Exception:  # noqa: BLE001
                    break

        ft = threading.Thread(target=flood, daemon=True)
        ft.start()
        time.sleep(0.3)
        flooded = light_p99(2.0)
        stop.set()
        ft.join(10)
        hot_row = {r["identity"]: r for r in svc.status()["sessions"]["live"]}["pod-hot"]
        assert hot_row["shed"].get("session_quota", 0) > 0, "the flood never hit its quota"
        bound = max(25.0 * baseline, 1.0)
        assert flooded <= bound, (
            f"light-session p99 {flooded * 1e3:.1f}ms exceeds {bound * 1e3:.1f}ms "
            f"(baseline {baseline * 1e3:.1f}ms)")
    finally:
        stop.set()
        hot.verdict_callback = None
        hot.close()
        for c in lights:
            c.close()
        svc.stop()
        inst.reset_module_registry()


def test_concurrent_first_binds_capture_on_the_card(cuda, tmp_path):
    """Sixteen sessions push the same policy and open their first conns of
    two protocols at one moment on a service that captures CUDA graphs
    (the pods of a node coming up together): every push and registration
    answers OK, and every session's frames are judged (a capture racing
    another session's warm launch on the same pool stream fails both)."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.proxylib.types import FilterResult
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
    from cilium_tpu_torch.utils.option import DaemonConfig

    r2d2 = NetworkPolicy(name="r", policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
            remote_policies=[1], l7_proto="r2d2",
            l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])])])
    dns = dataclasses.replace(entry.dns_bench_policy().config, name="d")
    frames = {"r2d2": (b"READ /public/a.txt\r\n", b"READ /private/x\r\n")}
    inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "binds.sock"), DaemonConfig(dispatch_mode="jit")).start()
    n = 16
    gate = threading.Barrier(n)
    results, errs = {}, []

    def pod(k):
        client = SidecarClient(svc.socket_path, timeout=120.0, identity=f"pod-{k}")
        try:
            mod = client.open_module([])
            gate.wait(60)
            pushed = client.policy_update(mod, [r2d2, dns])
            res_r, shim = client.new_connection(mod, "r2d2", 100 + k, True, 1, 2, "1.1.1.1:1", "2.2.2.2:80", "r")
            res_d, _ = client.new_connection(mod, "dns", 200 + k, True, 1, 2, "1.1.1.1:1", "2.2.2.2:53", "d")
            outs = [shim.on_io(False, f) for f in frames["r2d2"]]
            results[k] = (pushed, res_r, res_d, outs)
        except Exception as exc:  # noqa: BLE001 - asserted below
            errs.append(exc)
        finally:
            client.close()

    threads = [threading.Thread(target=pod, args=(k,), daemon=True) for k in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errs, errs
        ok = int(FilterResult.OK)
        want = (ok, ok, ok, [(ok, frames["r2d2"][0]), (ok, b"")])
        assert {k: r for k, r in results.items() if r != want} == {} and len(results) == n
        assert svc.status()["device"]["graphs"]["captures"] > 0
    finally:
        svc.stop()
        inst.reset_module_registry()


def test_policy_churn_under_traffic_on_the_card(cuda, tmp_path):
    """Non-stop policy churn on a service that captures CUDA graphs: one
    session keeps judging r2d2 frames while another pushes new policies
    (each push rebuilds and recaptures every bound engine) and opens a
    conn under each; every frame of both is judged as the policy says and
    no push or registration fails (a capture must not meet another
    thread's launches)."""
    import time

    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.proxylib.types import FilterResult
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
    from cilium_tpu_torch.utils.option import DaemonConfig

    def pol(name, extra):
        return NetworkPolicy(name=name, policy=2, ingress_per_port_policies=[
            PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
                remote_policies=[1], l7_proto="r2d2",
                l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}, *extra])])])

    ok = int(FilterResult.OK)
    good, bad = b"READ /public/a.txt\r\n", b"READ /private/x\r\n"
    inst.reset_module_registry()
    svc = VerdictService(str(tmp_path / "churn.sock"), DaemonConfig(dispatch_mode="jit")).start()
    hot = SidecarClient(svc.socket_path, timeout=120.0, identity="pod-hot")
    churn = SidecarClient(svc.socket_path, timeout=120.0, identity="pod-churn")
    stop = threading.Event()
    got, errs = [], []
    try:
        pols = [pol("base", [])]
        mod = hot.open_module([])
        assert hot.policy_update(mod, pols) == ok
        shims = [hot.new_connection(mod, "r2d2", 100 + i, True, 1, 2, "1.1.1.1:1", "2.2.2.2:80", "base")[1]
                 for i in range(8)]

        def drive():
            k = 0
            try:
                while not stop.is_set():
                    frame = good if k % 2 == 0 else bad
                    got.append((shims[k % 8].on_io(False, frame), frame))
                    k += 1
            except Exception as exc:  # noqa: BLE001 - asserted below
                errs.append(exc)

        t = threading.Thread(target=drive, daemon=True)
        t.start()
        cmod = churn.open_module([])
        pushed, opened, judged = [], [], []
        for j in range(6):
            time.sleep(0.2)
            pols = pols + [pol(f"p{j}", [{"cmd": "READ", "file": f"/p{j}/.*"}])]
            pushed.append(churn.policy_update(cmod, pols))
            res, shim = churn.new_connection(cmod, "r2d2", 200 + j, True, 1, 2, "1.1.1.1:1", "2.2.2.2:80",
                                             f"p{j}")
            opened.append(res)
            judged.append(shim.on_io(False, b"READ /p%d/x\r\n" % j) if res == ok else None)
        time.sleep(0.2)
        stop.set()
        t.join(60)
        assert not errs, errs
        assert pushed == [ok] * 6 and opened == [ok] * 6, (pushed, opened)
        assert judged == [(ok, b"READ /p%d/x\r\n" % j) for j in range(6)], judged
        wrong = [(r, f) for r, f in got if r != ((ok, f) if f == good else (ok, b""))]
        assert len(got) > 100 and not wrong, (len(got), wrong[:3])
        assert svc.status()["device"]["graphs"]["captures"] > 0
    finally:
        stop.set()
        hot.close()
        churn.close()
        svc.stop()
        inst.reset_module_registry()
