"""The port's HTTP slice at device="cpu" against the JAX package.

Same rules, same numpy batches, same feeds: the port's framing spans,
literal tier, verdicts, rule attribution, NPDS-built and converted models
and engine op/inject sequences must equal the JAX package's (tolerance 0:
every output is bool or int).  The plain PyTorch versions run here; the
card's kernels are held against them in tests/test_torch_cuda.py and
chip_smoke.py.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from cilium_tpu.flowlog import FlowLog as RefFlowLog
from cilium_tpu.models import http as ref_http
from cilium_tpu.ops.bytescan import first_occurrence as ref_first_occurrence
from cilium_tpu.ops.bytescan import first_subsequence2 as ref_first_subsequence2
from cilium_tpu.ops.dfa import DeviceDfa as RefDfa
from cilium_tpu.ops.nfa import DeviceNfa as RefNfa
from cilium_tpu.policy.api import PortRuleHTTP as RefRule
from cilium_tpu.proxylib.npds import policy_from_dict as ref_policy_from_dict
from cilium_tpu.proxylib.policy import compile_policy as ref_compile_policy
from cilium_tpu.runtime.engines import HttpBatchEngine as RefEngine
from cilium_tpu_torch.convert import HTTP_TABLES, http_model_from_numpy
from cilium_tpu_torch.entry import http_batch, http_bench_policy, http_requests
from cilium_tpu_torch.flowlog import FlowLog
from cilium_tpu_torch.models import http as port_http
from cilium_tpu_torch.models.base import ConstVerdict
from cilium_tpu_torch.models.http import (
    HttpBatchModel,
    HttpFrame,
    build_http_model,
    build_http_model_for_port,
    http_frame,
    http_frame_plain,
    http_hits,
    http_lit,
    http_verdicts,
    http_verdicts_attr,
)
from cilium_tpu_torch.ops.rxsearch import DeviceDfa, DeviceNfa
from cilium_tpu_torch.policy.api import PortRuleHTTP
from cilium_tpu_torch.proxylib import compile_policy
from cilium_tpu_torch.proxylib.npds import policy_from_dict
from cilium_tpu_torch.proxylib.parsers.http import HTTP_403, parse_head
from cilium_tpu_torch.proxylib.types import DROP, MORE, PASS
from cilium_tpu_torch.runtime.engines import HttpBatchEngine

@pytest.fixture(autouse=True, scope="module")
def _reference_http_rule_parser():
    """tests/test_proxylib.py::test_mismatching_l7_types_rejected registers
    a dummy HTTP rule parser in the reference's registry and leaves it
    there; these tests compile HTTP policies through the reference, so
    they put its real parser back first."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.http import http_rule_parser

    register_l7_rule_parser("http", http_rule_parser)


# tests/test_http_model.py's fuzz rule sets (:237-242) and its other
# rules, plus literal-tier shapes: duplicate rows of one rule, prefix and
# exact rows, a rule with no method literal, a newline needle.
RULE_SETS = {
    "fuzz-pub": [dict(method="GET|HEAD", path="/pub(lic)?/.*")],
    "fuzz-digits-put": [dict(path="/a/[0-9]+"), dict(method="PUT")],
    "fuzz-host": [dict(host=".*\\.internal")],
    "fuzz-headers": [dict(method="GET", headers=("X-A: 1", "X-B: 2"))],
    "graft": [dict(method="GET", path="/public/.*")],
    "literals": [
        dict(method="GET|HEAD|PUT", path="/a|/b|/public/x"),
        dict(method="POST", path="/api/v1/.*"),
        dict(path="/"),
        dict(method="DELETE"),
    ],
    "mixed": [
        dict(method="GET|HEAD", path="/pub(lic)?/.*"),
        dict(path="/a/[0-9]+"),
        dict(host=".*\\.internal"),
        dict(method="GET", headers=("X-A: 1",)),
        dict(method="[A-Z]+T", path=".*"),
    ],
    "newline-needle": [dict(path="/a\nb.*"), dict(method="G\nT")],
    "dotstar": [dict(path=".*"), dict(method="", path="")],
}
REMOTE_SETS = ([], [1], [2, 3], [], [1, 3])
METHODS = ["GET", "PUT", "HEAD", "POST", "DELETE", "G\nT", "TRACE", "get"]
PATHS = ["/public/x", "/pub/y", "/a/12", "/a/xy", "/other", "/", "/b",
         "/api/v1/users", "/api/v2", "/a\nbX", "/a\nbX\nY", "/public/", ""]
HOSTS = [None, "svc.internal", "svc.external", "a.internal "]
HDRS = [[], ["X-A: 1"], ["X-A: 1", "X-B: 2"], ["X-B: 2"], ["x-a:1"]]
ODD = [
    b"FOO\r\n\r\n",  # no space: degenerate path span
    b"GET /x\r\n\r\n",  # one space
    b"GET  /public/x HTTP/1.1\r\n\r\n",  # empty path token
    b"GET /public/x HTTP/1.1\r\nHost: svc.internal\r\n",  # incomplete
    b"GET /public/x HTTP/1.1\nHost: x\r\n\r\n",  # bare LF in the line
    b"GET /public/x HTTP/1.1\r\n\r",  # cut inside the CRLFCRLF
    b"",
    b"\r\n\r\n",
    b" GET /a HTTP/1.1\r\n\r\n",
    b"GET /a/1\r\nX-A: 1\r\nX-B: 2\r\n\r\nbody",
]
SRC_IDS = (1, 2, 3)
WIDTH = 96


def req(method="GET", path="/", headers=()):
    head = f"{method} {path} HTTP/1.1\r\n".encode()
    for h in headers:
        head += h.encode() + b"\r\n"
    return head + b"\r\n"


def corpus(seed=5, n=96):
    rng = random.Random(seed)
    reqs = []
    for _ in range(n):
        headers = list(rng.choice(HDRS))
        host = rng.choice(HOSTS)
        if host:
            headers = [f"Host: {host}"] + headers
        reqs.append(req(rng.choice(METHODS), rng.choice(PATHS), headers))
    return reqs + ODD


def encode(requests, width=WIDTH):
    data = np.zeros((len(requests), width), np.uint8)
    lengths = np.zeros((len(requests),), np.int32)
    for i, r in enumerate(requests):
        b = r[:width]
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return data, lengths


def rows(name, remotes=False):
    out = []
    for i, kw in enumerate(RULE_SETS[name]):
        rs = frozenset(REMOTE_SETS[i % len(REMOTE_SETS)]) if remotes else frozenset()
        out.append((rs, kw))
    return out


def both_models(name, backend, remotes=False):
    rr = rows(name, remotes)
    ref = ref_http.build_http_model([(rs, RefRule(**kw)) for rs, kw in rr], backend=backend)
    port = build_http_model([(rs, PortRuleHTTP(**kw)) for rs, kw in rr],
                            backend=backend, device="cpu")
    return ref, port


def _eq(port, ref, what=""):
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu", what
    want = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _remotes(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.choice(np.asarray(SRC_IDS, np.int32), size=n).astype(np.int32)


# --- framing and the literal tier ---------------------------------------------


def _byte_soup(seed, f=257, l=48):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"\r\n\r\n\r\n  GET/a\nbX", np.uint8)
    data = rng.choice(alphabet, size=(f, l)).astype(np.uint8)
    lengths = rng.integers(0, l + 1, size=f).astype(np.int32)
    lengths[:3] = [0, l, l - 1]
    data[1, l - 4:] = np.frombuffer(b"\r\n\r\n", np.uint8)  # at the very end
    data[2, l - 4:] = np.frombuffer(b"\r\n\r\n", np.uint8)  # one byte past len
    return data, lengths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_spans_match_reference(seed):
    data, lengths = _byte_soup(seed)
    fr = http_frame(torch.from_numpy(data), torch.from_numpy(lengths))
    crlf2 = ref_http._first_crlfcrlf(data, lengths)
    line_end = ref_first_subsequence2(data, lengths, 0x0D, 0x0A)
    sp1 = ref_first_occurrence(data, line_end, 0x20)
    sp2 = ref_http._first_occurrence_after(data, sp1, line_end, 0x20)
    p_start = sp1 + 1
    _eq(fr.crlf2, crlf2, "crlf2")
    _eq(fr.complete, crlf2 < lengths, "complete")
    _eq(fr.head_len, crlf2 + 4, "head_len")
    _eq(fr.line_end, line_end, "line_end")
    _eq(fr.sp1, sp1, "sp1")
    _eq(fr.sp2, sp2, "sp2")
    _eq(fr.p_start, p_start, "p_start")
    _eq(fr.h_end, crlf2 + 2, "h_end")
    _eq(fr.last_nl_m, ref_http._last_in_span(data, np.zeros_like(lengths), sp1, 0x0A), "last_nl_m")
    _eq(fr.last_nl_p, ref_http._last_in_span(data, p_start, sp2, 0x0A), "last_nl_p")
    # every case of the soup is exercised
    assert bool(fr.complete.any()) and not bool(fr.complete.all())
    assert bool((fr.last_nl_m >= 0).any()) and bool((fr.last_nl_p >= 0).any())


def test_frame_outputs_are_the_references_eight():
    """K5 writes only the outputs the reference's framing defines; the
    path span's start and the header block's end are derived from them."""
    assert HttpFrame._fields == ("crlf2", "complete", "head_len", "line_end",
                                 "sp1", "sp2", "last_nl_m", "last_nl_p")
    data, lengths = _byte_soup(3)
    fr = http_frame(torch.from_numpy(data), torch.from_numpy(lengths))
    assert torch.equal(fr.p_start, fr.sp1 + 1)
    assert torch.equal(fr.h_end, fr.head_len - 2)


def test_incomplete_head_len_is_length_plus_four():
    """An incomplete head's head_len is len + 4, and its header span
    reaches past L: the outputs in their own right equal the reference's."""
    reqs = [b"GET /public/x HTTP/1.1\r\nHost: svc.internal\r\n",
            b"GET /public/x HTTP/1.1\r\nHost: svc.internal\r\n\r\n"]
    data, lengths = encode(reqs, width=len(reqs[0]))  # the second is cut at L
    for name in ("fuzz-host", "graft"):
        ref, port = both_models(name, "auto")
        remotes = np.ones((2,), np.int32)
        got = http_verdicts_attr(port, data, lengths, remotes)
        want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
        for g, w in zip(got, want):
            _eq(g, w, name)
        assert got[0].tolist() == [False, False]
        assert got[1].tolist() == [len(reqs[0]) + 4] * 2
        assert got[2].tolist() == [False, False]


@pytest.mark.parametrize("seed", [3, 4])
def test_lit_hits_and_scatter_or_match_reference(seed):
    """Random needles over the byte soup, several rows per rule (the
    reference's .at[].add sums duplicates; a plain write would drop all
    but one), prefix and exact rows, dead rows."""
    data, lengths = _byte_soup(seed)
    rng = np.random.default_rng(seed)
    lit_rows = []
    for k in range(23):
        start = int(rng.integers(0, 40))
        lit = bytes(data[k, start : start + int(rng.integers(0, 9))])
        lit_rows.append((lit, bool(rng.random() < 0.5), int(rng.integers(0, 5))))
    needle, nlen, prefix, rule, live = port_http.lit_arrays(lit_rows, n_pad=26)
    fr = http_frame_plain(torch.from_numpy(data), torch.from_numpy(lengths))
    start = fr.p_start.numpy()
    end = fr.sp2.numpy()
    want = ref_http._lit_hits(data, start, end, needle, nlen, prefix, live)
    got = port_http._lit_hits(
        torch.from_numpy(data), fr.p_start, fr.sp2, fr.last_nl_p,
        *(torch.from_numpy(a) for a in (needle, nlen, prefix, live)),
    )
    _eq(got, want, "lit hits")
    assert bool(got.any())
    _eq(port_http._scatter_or(got, torch.from_numpy(rule), 5),
        ref_http._scatter_or(want, rule, 5), "scatter_or")


def test_scatter_or_sums_duplicate_rows():
    """Two rows of one rule, the first a hit and the second a miss: the
    rule holds.  index_put_ without accumulate would keep the miss."""
    hits = torch.tensor([[True, False], [False, True], [False, False]])
    got = port_http._scatter_or(hits, torch.tensor([0, 0], dtype=torch.int32), 2)
    assert got.tolist() == [[True, False], [True, False], [False, False]]


def test_empty_literal_slot_has_one_dead_row():
    """A slot without literal rows packs one dead row of width 8; K6 takes
    Nm = 1 with live False, and the needle width differs per slot."""
    ref, port = both_models("fuzz-host", "auto")
    assert tuple(port.m_needle.shape) == (1, 8) and not bool(port.m_live.any())
    assert tuple(port.p_needle.shape) == (1, 8)
    _, wide = both_models("literals", "auto")
    assert wide.m_needle.shape[1] == 8 and wide.p_needle.shape[1] == 16
    for name, model in (("fuzz-host", port), ("literals", wide)):
        data, lengths = encode(corpus())
        ok = http_lit(model, torch.from_numpy(data), http_frame_plain(
            torch.from_numpy(data), torch.from_numpy(lengths)))
        assert ok[0].shape == (len(lengths), model.n_rules), name


# --- the verdict pass ----------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "dfa", "nfa", "regex-only"])
@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_verdicts_and_attr_match_reference(name, backend):
    ref, port = both_models(name, backend, remotes=True)
    assert port.match_kinds == ref.match_kinds
    assert port.has_method_rx == ref.has_method_rx
    assert port.has_path_rx == ref.has_path_rx
    assert port.invariant_rows == ref.invariant_rows
    data, lengths = encode(corpus())
    remotes = _remotes(len(lengths))
    got = http_verdicts(port, data, lengths, remotes)
    want = ref_http.http_verdicts(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w, f"{name}/{backend}")
    got = port.verdicts_attr(data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w, f"{name}/{backend} attr")


def test_backends_pick_the_reference_automata():
    for backend, line, head in (("auto", DeviceDfa, DeviceDfa), ("nfa", DeviceNfa, DeviceNfa),
                                ("dfa", DeviceDfa, DeviceDfa)):
        ref, port = both_models("mixed", backend)
        assert isinstance(port.line_nfa, line) and isinstance(port.head_nfa, head)
        assert type(ref.line_nfa).__name__ == line.__name__
    nfa_rule = [(frozenset(), dict(method="GET", path="/n00/(a|b)*a" + "(a|b)" * 7 + "/x"))]
    ref = ref_http.build_http_model([(rs, RefRule(**kw)) for rs, kw in nfa_rule])
    port = build_http_model([(rs, PortRuleHTTP(**kw)) for rs, kw in nfa_rule], device="cpu")
    assert isinstance(ref.line_nfa, RefNfa) and isinstance(port.line_nfa, DeviceNfa)
    assert port.match_kinds == ref.match_kinds == ("nfa",)
    reqs = [req("GET", "/n00/" + s + "/x") for s in ("abaaaaaaaa", "bbbbbbbbbb", "a" * 8, "")]
    data, lengths = encode(reqs)
    remotes = np.ones((len(reqs),), np.int32)
    got = http_verdicts_attr(port, data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w, "nfa")
    assert got[2].tolist() == [True, False, True, False]


@pytest.mark.parametrize("backend", ["auto", "regex-only"])
def test_degenerate_spans_match_reference(backend):
    """No space on the request line: the path span is [line_end + 1,
    line_end), clamped to empty; ".*" (a ("prefix", b"") row, or the
    automaton's empty-span accept_final) allows it, a literal does not."""
    rr = [(frozenset(), dict(path=".*")), (frozenset({9}), dict(path="/x"))]
    ref = ref_http.build_http_model([(rs, RefRule(**kw)) for rs, kw in rr], backend=backend)
    port = build_http_model([(rs, PortRuleHTTP(**kw)) for rs, kw in rr],
                            backend=backend, device="cpu")
    reqs = [b"FOO\r\n\r\n", b"GET\r\nHost: a\r\n\r\n", b"GET /x\r\n\r\n", b"\r\n\r\n"]
    data, lengths = encode(reqs)
    remotes = np.full((len(reqs),), 9, np.int32)
    got = http_verdicts_attr(port, data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w, backend)
    assert got[2].tolist() == [True] * 4 and got[3].tolist() == [0] * 4


@pytest.mark.parametrize("backend", ["auto", "regex-only"])
def test_newline_in_request_line_matches_reference(backend):
    """line_end is the first CRLF, so a bare LF can sit inside the method
    or path span: the prefix row's guard keys on the span's LAST LF."""
    rr = [(frozenset(), dict(path="/a\nb.*")), (frozenset(), dict(method="G\nT|P.*"))]
    ref = ref_http.build_http_model([(rs, RefRule(**kw)) for rs, kw in rr], backend=backend)
    port = build_http_model([(rs, PortRuleHTTP(**kw)) for rs, kw in rr],
                            backend=backend, device="cpu")
    reqs = [
        b"GET /a\nbX HTTP/1.1\r\n\r\n",  # remainder clean -> allow
        b"GET /a\nbX\nY HTTP/1.1\r\n\r\n",  # LF in the remainder -> deny
        b"G\nT /z HTTP/1.1\r\n\r\n",  # exact method with an LF
        b"PU\nT /z HTTP/1.1\r\n\r\n",  # LF in a method prefix's remainder
        b"PUT /z HTTP/1.1\r\n\r\n",
    ]
    data, lengths = encode(reqs)
    remotes = np.ones((len(reqs),), np.int32)
    got = http_verdicts_attr(port, data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w, backend)
    assert got[2].tolist() == [True, False, True, False, True]


def test_head_patterns_count_patterns_not_bytes():
    """A rule with two headers needs both patterns to hit; one header
    repeated on the wire still counts once."""
    rr = [(frozenset(), dict(headers=("X-A: 1", "X-B: 2"))), (frozenset({7}), dict(method="PUT"))]
    ref = ref_http.build_http_model([(rs, RefRule(**kw)) for rs, kw in rr])
    port = build_http_model([(rs, PortRuleHTTP(**kw)) for rs, kw in rr], device="cpu")
    reqs = [req("GET", "/", ["X-A: 1", "X-B: 2"]), req("GET", "/", ["X-A: 1", "X-A: 1"]),
            req("PUT", "/", ["X-B: 2"]), req("GET", "/", ["x-b:  2", "X-A:1"])]
    data, lengths = encode(reqs)
    remotes = np.asarray([1, 1, 7, 1], np.int32)
    got = http_verdicts_attr(port, data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[2].tolist() == [True, False, True, True]
    assert got[3].tolist() == [0, -1, 1, 0]


def test_attribution_is_the_first_rule_that_holds():
    """Several rules hold: ``rule`` is the first (torch's argmax takes no
    bool; first_match casts first), -1 where none holds or the head is
    incomplete."""
    rr = [(frozenset(), dict(method="PUT")), (frozenset({2}), dict(method="GET")),
          (frozenset(), dict(method="GET|HEAD")), (frozenset(), dict(path="/x.*"))]
    ref = ref_http.build_http_model([(rs, RefRule(**kw)) for rs, kw in rr])
    port = build_http_model([(rs, PortRuleHTTP(**kw)) for rs, kw in rr], device="cpu")
    reqs = [req("GET", "/x"), req("GET", "/x"), req("POST", "/x"), req("POST", "/y"),
            b"GET /x HTTP/1.1\r\n"]
    data, lengths = encode(reqs)
    remotes = np.asarray([2, 1, 1, 1, 2], np.int32)
    got = http_verdicts_attr(port, data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[3].tolist() == [1, 2, 3, -1, -1]


def test_model_tables_are_checked_once_at_build():
    """K6 and K7 index with the rule, length and slot tables, so the model
    refuses values out of range when it is built, not per call."""
    _, port = both_models("mixed", "auto")
    fields = {f: getattr(port, f) for f in HTTP_TABLES}
    fields.update(line_nfa=port.line_nfa, head_nfa=port.head_nfa, n_rules=port.n_rules,
                  has_method_rx=port.has_method_rx, has_path_rx=port.has_path_rx)
    HttpBatchModel(**fields)
    for name, bad in (("m_rule", port.n_rules), ("head_rule", -1), ("p_len", 99),
                      ("line_slot", 2)):
        t = fields[name].clone()
        t[0] = bad
        with pytest.raises(ValueError, match=name):
            HttpBatchModel(**{**fields, name: t})
    with pytest.raises(ValueError, match="m_needle"):
        HttpBatchModel(**{**fields, "m_needle": torch.zeros((4, 12), dtype=torch.uint8)})


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; a tensor on
    any other non-CUDA device, or on another device than the model's,
    raises before anything runs."""
    _, port = both_models("graft", "auto")
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        http_frame(torch.zeros((4, 8), dtype=torch.uint8, device=meta),
                   torch.zeros((4,), dtype=torch.int32, device=meta))
    fr = http_frame_plain(torch.zeros((4, 8), dtype=torch.uint8),
                          torch.zeros((4,), dtype=torch.int32))
    with pytest.raises(ValueError, match="expected device"):
        http_lit(port, torch.zeros((4, 8), dtype=torch.uint8, device=meta), fr)
    with pytest.raises(ValueError, match="expected device"):
        http_hits(port, fr.complete.to(meta), torch.zeros((4, 1), dtype=torch.bool),
                  torch.zeros((4, 1), dtype=torch.bool), None, None, None,
                  torch.zeros((4,), dtype=torch.int32))


# --- NPDS, conversion and the entry batch ----------------------------------------


NPDS_RULES = [
    {"remote_policies": [1], "http_rules": [
        {"method": "GET|HEAD", "path": "/pub(lic)?/.*"}, {"path": "/a/[0-9]+"}]},
    {"http_rules": [{"method": "PUT"}, {"host": ".*\\.internal"}]},
    {"remote_policies": [2, 3], "http_rules": [
        {"method": "GET", "headers": ["X-A: 1", "X-B: 2"]}]},
    {"remote_policies": [3]},
]


def _both_policies(port_rules=NPDS_RULES, wildcard=()):
    d = {
        "name": "http-npds",
        "policy": 2,
        "ingress_per_port_policies": [{"port": 80, "rules": list(port_rules)}]
        + ([{"port": 0, "rules": list(wildcard)}] if wildcard else []),
    }
    return ref_compile_policy(ref_policy_from_dict(d)), compile_policy(policy_from_dict(d))


@pytest.mark.parametrize("wildcard", [(), ({"http_rules": [{"method": "DELETE"}]},)])
def test_model_built_through_npds_matches_reference_and_oracle(wildcard):
    ref_policy, policy = _both_policies(wildcard=wildcard)
    ref = ref_http.build_http_model_for_port(ref_policy, True, 80)
    port = build_http_model_for_port(policy, True, 80, device="cpu")
    assert isinstance(port, HttpBatchModel)
    assert port.match_kinds == ref.match_kinds
    assert port.invariant_rows == ref.invariant_rows
    reqs = corpus(seed=9) + [req("DELETE", "/x")]
    data, lengths = encode(reqs, width=128)
    for src in SRC_IDS:
        remotes = np.full((len(reqs),), src, np.int32)
        got = port.verdicts_attr(data, lengths, remotes)
        want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
        for g, w in zip(got, want):
            _eq(g, w, f"remote {src}")
        complete, _, allow, rule = got
        for i, r in enumerate(reqs):
            if not bool(complete[i]) or b"\n" in r.split(b"\r\n", 1)[0]:
                continue  # the oracle parses complete heads
            parsed = parse_head(r[: int(got[1][i])])
            want_ok = policy.matches_at(True, 80, src, parsed) if parsed else (False, -1)
            if parsed is None:
                continue
            assert (bool(allow[i]), int(rule[i])) == want_ok, r


def test_npds_degenerate_ports_are_constant():
    _, policy = _both_policies(port_rules=[{"remote_policies": [1]}])
    assert build_http_model_for_port(policy, True, 80, device="cpu") == ConstVerdict(True)
    assert build_http_model_for_port(policy, True, 81, device="cpu") == ConstVerdict(False)
    assert build_http_model_for_port(None, True, 80, device="cpu") == ConstVerdict(False)


def _automaton_leaves(tab):
    if tab is None:
        return None
    if isinstance(tab, RefDfa):
        keys = ["cls_lo", "cls_hi", "delta_id", "start_1h", "accept_mask", "accept_final_mask"]
    else:
        keys = ["delta_flat", "classmap", "start", "accept_t", "accept_final_t"]
    return {k: np.asarray(getattr(tab, k)) for k in keys}


@pytest.mark.parametrize("backend", ["auto", "nfa", "regex-only"])
@pytest.mark.parametrize("name", ["graft", "mixed", "fuzz-headers"])
def test_converted_model_gives_equal_verdicts(name, backend):
    ref, _ = both_models(name, backend, remotes=True)
    leaves = {k: np.asarray(getattr(ref, k)) for k in HTTP_TABLES}
    leaves["line_nfa"] = _automaton_leaves(ref.line_nfa)
    leaves["head_nfa"] = _automaton_leaves(ref.head_nfa)
    model = http_model_from_numpy(
        leaves, device="cpu", n_rules=ref.n_rules, has_method_rx=ref.has_method_rx,
        has_path_rx=ref.has_path_rx, match_kinds=ref.match_kinds,
    )
    assert model.invariant_rows is None and model.match_kinds == ref.match_kinds
    data, lengths = encode(corpus(seed=11))
    remotes = _remotes(len(lengths), seed=4)
    got = model.verdicts_attr(data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w, f"{name}/{backend}")


def test_http_bench_batch_matches_reference_bench_setup():
    """The entry's policy and batch are bench.py::bench_http's: the same
    1,024 requests, verdicts equal to the reference model's."""
    reqs = http_requests()
    assert len(reqs) == 1024 and reqs[0].endswith(b"User-Agent: bench\r\n\r\n")
    model = build_http_model_for_port(http_bench_policy(), True, 80, device="cpu")
    rule = RefRule(method="GET", path="/public/.*")
    rule.sanitize()
    ref = ref_http.build_http_model([(frozenset(), rule)])
    data, lengths, remotes = http_batch(2048)
    assert data.shape == (2048, 512) and lengths[1024] == len(reqs[0])
    got = http_verdicts_attr(model, data, lengths, remotes)
    want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
    for g, w in zip(got, want):
        _eq(g, w)
    assert 0.2 < float(got[2].float().mean()) < 0.6


# --- K6's literal CSR and a table of thousands of rules ---------------------------


def _assert_lit_csr(model):
    """model.lit_csr, expanded, lists exactly the live literal rows of each
    rule, in row order, for both slots."""
    for slot in ("m", "p"):
        ptr = model.lit_csr[f"{slot}_ptr"].cpu().numpy()
        idx = model.lit_csr[f"{slot}_idx"].cpu().numpy()
        rule = getattr(model, f"{slot}_rule").cpu().numpy()
        live = getattr(model, f"{slot}_live").cpu().numpy()
        assert ptr.dtype == idx.dtype == np.int32
        assert ptr.shape == (model.n_rules + 1,) and ptr[0] == 0 and ptr[-1] == idx.shape[0]
        assert (np.diff(ptr) >= 0).all()
        owner = np.repeat(np.arange(model.n_rules), np.diff(ptr))
        rows = np.flatnonzero(live)
        order = np.lexsort((rows, rule[rows]))
        np.testing.assert_array_equal(owner, rule[rows][order], err_msg=slot)
        np.testing.assert_array_equal(idx, rows[order], err_msg=slot)


def _random_lit_tables(seed, r):
    """A model's tables straight from random numbers: 0 to several
    literal rows a rule in no rule order, dead rows among them."""
    rng = np.random.default_rng(seed)
    tabs = {}
    for slot in ("m", "p"):
        n = max(1, int(r * rng.uniform(0.3, 3.0)))
        nlen = rng.integers(0, 9, n).astype(np.int32)
        tabs.update({
            f"{slot}_needle": rng.integers(0, 256, (n, 8)).astype(np.uint8),
            f"{slot}_len": nlen, f"{slot}_prefix": rng.random(n) < 0.3,
            f"{slot}_rule": rng.integers(0, r, n).astype(np.int32),
            f"{slot}_live": rng.random(n) < 0.8,
        })
    tabs.update(
        method_any=rng.random(r) < 0.1, path_any=rng.random(r) < 0.1,
        line_rule=np.zeros((0,), np.int32), line_slot=np.zeros((0,), np.int32),
        head_rule=np.zeros((0,), np.int32), head_count=np.zeros((r,), np.int32),
        remote_ids=np.zeros((r, 32), np.int32), any_remote=np.ones((r,), bool),
    )
    return HttpBatchModel(**{k: torch.from_numpy(v) for k, v in tabs.items()},
                          line_nfa=None, head_nfa=None, n_rules=r)


@pytest.mark.parametrize("seed,r", [(0, 1), (1, 7), (2, 33), (3, 500)])
def test_literal_csr_lists_the_live_rows_of_random_tables(seed, r):
    _assert_lit_csr(_random_lit_tables(seed, r))


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_literal_csr_lists_the_live_rows_of_built_models(name):
    _, port = both_models(name, "auto", remotes=True)
    _assert_lit_csr(port)


def test_literal_csr_lists_the_live_rows_of_npds_and_converted_models():
    _, policy = _both_policies(wildcard=({"http_rules": [{"method": "DELETE|PUT"}]},))
    _assert_lit_csr(build_http_model_for_port(policy, True, 80, device="cpu"))
    ref, _ = both_models("literals", "auto", remotes=True)
    leaves = {k: np.asarray(getattr(ref, k)) for k in HTTP_TABLES}
    leaves["line_nfa"] = _automaton_leaves(ref.line_nfa)
    leaves["head_nfa"] = _automaton_leaves(ref.head_nfa)
    _assert_lit_csr(http_model_from_numpy(
        leaves, device="cpu", n_rules=ref.n_rules, has_method_rx=ref.has_method_rx,
        has_path_rx=ref.has_path_rx))


def test_literal_csr_lists_the_live_rows_of_rule_shards():
    """The padded shards of rules_100k's table: dead rows and dead rules."""
    from cilium_tpu_torch.entry import rules_100k_rows
    from cilium_tpu_torch.parallel.rulesharding import build_sharded_http_model

    shards = build_sharded_http_model(rules_100k_rows(2001), 4, device="cpu")
    assert [m.n_rules for m in shards] == [501] * 4
    for m in shards:
        _assert_lit_csr(m)
    assert int(shards[-1].lit_csr["p_ptr"][-1]) < int(shards[-1].p_live.numel())


def test_thousands_of_rules_first_match_mid_table_matches_reference():
    """3,001 literal rules (R not a multiple of 32), remote sets on most;
    requests whose first rule that holds lies anywhere in the table, past
    the first 32 and 128 rows included, or nowhere: verdicts and
    attribution equal to the JAX package's, tolerance 0."""
    rng = random.Random(21)
    verbs = ("GET", "POST", "PUT", "DELETE")
    rr = []
    for j in range(3000):
        path = f"/p{j:05d}" if j % 7 else f"/q{j % 50:02d}/.*"
        remotes = frozenset(rng.sample(range(1, 9), rng.randrange(0, 3)))
        rr.append((remotes, dict(method=verbs[j % 4], path=path)))
    rr.append((frozenset(), dict(method="HEAD")))
    ref = ref_http.build_http_model([(rs, RefRule(**kw)) for rs, kw in rr])
    port = build_http_model([(rs, PortRuleHTTP(**kw)) for rs, kw in rr], device="cpu")
    reqs = []
    for j in [5, 31, 32, 33, 127, 129, 700, 1500, 2345, 2999] + [rng.randrange(3000) for _ in range(40)]:
        reqs.append(req(verbs[j % 4], f"/p{j:05d}" if j % 7 else f"/q{j % 50:02d}/x"))
    reqs += [req("HEAD", "/x"), req("PATCH", "/p00005"), req("GET", "/q07/a\nb"),
             b"GET /p00008 HTTP/1.1\r\n"]
    data, lengths = encode(reqs, width=64)
    for src in (1, 4, 8):
        remotes = np.full((len(reqs),), src, np.int32)
        got = http_verdicts_attr(port, data, lengths, remotes)
        want = ref_http.http_verdicts_attr(ref, data, lengths, remotes)
        for g, w in zip(got, want):
            _eq(g, w, f"remote {src}")
        rule = got[3].numpy()
        assert (rule > 128).any() and (rule == -1).any()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_http_model_for_port(http_bench_policy(), True, 80)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_http_model([(frozenset(), PortRuleHTTP(method="GET"))])


# --- the engine ----------------------------------------------------------------


def _engine_pair(rules=None):
    rules = rules or [dict(method="GET", path="/public/.*")]
    ref_rows, port_rows = [], []
    for r in rules:
        a, b = RefRule(**r), PortRuleHTTP(**r)
        a.sanitize()
        b.sanitize()
        ref_rows.append((frozenset(), a))
        port_rows.append((frozenset(), b))
    ref = RefEngine(ref_http.build_http_model(ref_rows))
    port = HttpBatchEngine(build_http_model(port_rows, device="cpu"))
    return ref, port


def _drive(engines, feeds):
    """Feed every engine the same rounds; returns each engine's per-round
    (flow, ops, inject) lists."""
    outs = [[] for _ in engines]
    for rnd in feeds:
        for out, eng in zip(outs, engines):
            for fid, chunk, remote in rnd:
                eng.feed(fid, chunk, remote_id=remote)
            eng.pump()
            for fid, _, _ in rnd:
                ops, inj = eng.take_ops(fid)
                out.append((fid, [(int(op), n) for op, n in ops], inj))
    return outs


def test_engine_allow_deny_inject_matches_reference():
    ref, eng = _engine_pair()
    feeds = [[(1, b"GET /public/a HTTP/1.1\r\n\r\n", 1),
              (2, b"POST /public/a HTTP/1.1\r\n\r\n", 1)]]
    got, want = _drive([eng, ref], feeds)
    assert got == want
    assert got == [(1, [(int(PASS), 26)], b""), (2, [(int(DROP), 27)], HTTP_403)]


def test_engine_body_rides_verdict_matches_reference():
    ref, eng = _engine_pair()
    head = b"GET /public/a HTTP/1.1\r\nContent-Length: 5\r\n\r\n"
    feeds = [[(1, head + b"hel", 1)], [(1, b"lo", 1)]]
    got, want = _drive([eng, ref], feeds)
    assert got == want
    assert got == [(1, [(int(MORE), 1)], b""), (1, [(int(PASS), len(head) + 5)], b"")]


def test_engine_width_buckets_match_reference():
    ref, eng = _engine_pair()
    feeds = [[(1, b"GET /public/a HTTP/1.1\r\n\r\n", 1),
              (2, f"GET /public/{'x' * 2000} HTTP/1.1\r\n\r\n".encode(), 1),
              (3, b"GET /secret HTTP/1.1\r\n\r\n", 1),
              (4, f"GET /public/{'y' * 700} HTTP/1.1\r\n\r\n".encode(), 1)]]
    got, want = _drive([eng, ref], feeds)
    assert got == want
    assert [ops[0][0] for _, ops, _ in got] == [int(PASS), int(PASS), int(DROP), int(PASS)]


def test_engine_absurd_head_denied_without_a_device_pass(monkeypatch):
    ref, eng = _engine_pair()
    monster = b"GET /public/" + b"y" * (eng.MAX_WIDTH + 100) + b" HTTP/1.1\r\n\r\n"
    calls = []
    monkeypatch.setattr(port_http, "_verdict_pass", lambda *a: calls.append(a))
    got, want = _drive([eng, ref], [[(1, monster, 1)]])
    assert got == want == [(1, [(int(DROP), len(monster))], HTTP_403)]
    assert calls == []


def test_engine_prewarm_then_judge():
    ref, eng = _engine_pair()
    eng.prewarm()
    ref.prewarm()
    got, want = _drive([eng, ref], [[(1, b"GET /public/a HTTP/1.1\r\n\r\n", 1)]])
    assert got == want and got[0][1][0][0] == int(PASS)


def _random_feeds(seed, n_flows=40):
    rng = random.Random(seed)
    rounds = [[], [], []]
    for fid in range(n_flows):
        stream = b""
        for _ in range(rng.randrange(1, 4)):
            method = rng.choice(["GET", "GET", "POST", "PUT"])
            path = rng.choice(["/public/a", "/private/b", "/public/" + "z" * rng.randrange(500, 2600)])
            headers = [f"Host: svc{rng.randrange(3)}.internal"]
            body = b""
            if rng.random() < 0.3:
                body = b"x" * rng.randrange(0, 9)
                headers.append(f"Content-Length: {len(body)}")
            if rng.random() < 0.3:
                headers.append("X-A: 1")
            stream += req(method, path, headers) + body
        cut1 = rng.randrange(0, len(stream) + 1)
        cut2 = rng.randrange(cut1, len(stream) + 1)
        remote = rng.choice(SRC_IDS)
        for rnd, chunk in zip(rounds, (stream[:cut1], stream[cut1:cut2], stream[cut2:])):
            rnd.append((fid, chunk, remote))
    return rounds


@pytest.mark.parametrize("flowlog", [False, True])
def test_engine_ops_injects_and_records_match_reference(flowlog):
    rules = [dict(method="GET", path="/public/.*"), dict(host="svc1\\.internal"),
             dict(method="PUT", headers=("X-A: 1",))]
    logs = (RefFlowLog(), FlowLog()) if flowlog else (None, None)
    ref, eng = _engine_pair(rules)
    ref.flowlog, eng.flowlog = logs
    feeds = _random_feeds(21)
    got, want = _drive([eng, ref], feeds)
    assert got == want
    assert any(ops and ops[0][0] == int(DROP) for _, ops, _ in got)
    assert any(ops and ops[0][0] == int(PASS) for _, ops, _ in got)
    if flowlog:
        keys = ("conn_id", "verdict", "rule_id", "match_kind")
        rec = [tuple(r[k] for k in keys) for r in eng.flowlog.query(10000)]
        ref_rec = [tuple(r[k] for k in keys) for r in ref.flowlog.query(10000)]
        assert rec == ref_rec and len(rec) > 40
        assert {r[2] for r in rec} >= {-1, 0, 1}


def test_engine_cache_tier_claims_match_reference():
    d_rules = [{"remote_policies": [5]}, {"http_rules": [{"method": "GET"}]}]
    ref_policy, policy = _both_policies(port_rules=d_rules)
    ref = RefEngine(ref_http.build_http_model_for_port(ref_policy, True, 80), cache_enabled=True)
    eng = HttpBatchEngine(build_http_model_for_port(policy, True, 80, device="cpu"),
                          cache_enabled=True)
    for src in (1, 5):
        assert eng.verdict_invariant(src) == ref.verdict_invariant(src)
    feeds = [[(1, req("GET", "/x"), 5), (2, req("POST", "/x"), 5), (3, req("POST", "/x"), 1)]]
    got, want = _drive([eng, ref], feeds)
    assert got == want
    assert [ops[0][0] for _, ops, _ in got] == [int(PASS), int(PASS), int(DROP)]


def test_engine_cache_hits_are_counted_as_the_reference_counts_them():
    from cilium_tpu.utils import metrics as ref_metrics
    from cilium_tpu_torch.utils import metrics

    d_rules = [{"remote_policies": [5]}, {"http_rules": [{"method": "GET"}]}]
    ref_policy, policy = _both_policies(port_rules=d_rules)
    ref = RefEngine(ref_http.build_http_model_for_port(ref_policy, True, 80), cache_enabled=True)
    eng = HttpBatchEngine(build_http_model_for_port(policy, True, 80, device="cpu"),
                          cache_enabled=True)
    feeds = [[(1, req("GET", "/x"), 5), (2, req("PUT", "/y"), 5), (3, req("GET", "/x"), 1)]]
    before = (metrics.VerdictCacheHits.get("engine"), ref_metrics.VerdictCacheHits.get("engine"))
    _drive([eng], feeds)
    _drive([ref], feeds)
    hits = (metrics.VerdictCacheHits.get("engine") - before[0],
            ref_metrics.VerdictCacheHits.get("engine") - before[1])
    assert hits == (2, 2)
    assert "cilium_tpu_verdict_cache_hits_total{site=\"engine\"}" in metrics.registry.expose()


def test_flow_verdict_counter_matches_reference():
    from cilium_tpu.utils import metrics as ref_metrics
    from cilium_tpu_torch.utils import metrics

    ref, eng = _engine_pair([dict(method="GET", path="/public/.*")])
    ref.flowlog, eng.flowlog = RefFlowLog(), FlowLog()
    from cilium_tpu_torch.flowlog import MATCH_NONE, PATH_ENGINE
    from cilium_tpu_torch.flowlog.record import CODE_NAMES

    labels = [(v, PATH_ENGINE, k) for v in CODE_NAMES for k in ("literal", MATCH_NONE)]

    def counts(m):
        return [m.FlowVerdictsTotal.get(*lab) for lab in labels]

    before = (counts(metrics), counts(ref_metrics))
    _drive([eng], _random_feeds(5, n_flows=20))
    _drive([ref], _random_feeds(5, n_flows=20))
    got = [a - b for a, b in zip(counts(metrics), before[0])]
    want = [a - b for a, b in zip(counts(ref_metrics), before[1])]
    assert got == want and sum(got) > 20


def test_engine_model_failure_raises():
    """No port model carries a fallback: a model that fails fails the
    engine step, and nothing is emitted for the flow."""
    _, eng = _engine_pair()

    class Broken(Exception):
        pass

    def boom(*args):
        raise Broken()

    eng.model = type("Failing", (), {"__call__": staticmethod(boom)})()
    eng.feed(1, req("GET", "/public/a"), remote_id=1)
    with pytest.raises(Broken):
        eng.pump()
    assert eng.flows[1].ops == []


def test_engine_const_verdict_matches_reference():
    ref_policy, policy = _both_policies(port_rules=[{"remote_policies": [1]}])
    ref = RefEngine(ref_http.build_http_model_for_port(ref_policy, True, 80))
    eng = HttpBatchEngine(build_http_model_for_port(policy, True, 80, device="cpu"))
    got, want = _drive([eng, ref], [[(1, req("PUT", "/x"), 1), (2, b"GET /x HTTP/1.1\r\n", 1)]])
    assert got == want


def test_reference_divergences_are_kept_on_both_sides():
    """Three inputs where the device path and the streaming parser
    disagree by the reference's own design (ROADMAP Queue 3); the port
    keeps each side as the reference has it."""
    from cilium_tpu.proxylib.parsers.http import HttpParser as RefParser
    from cilium_tpu_torch.proxylib.parsers.http import HttpParser

    class Conn:
        def __init__(self, allow):
            self.allow = allow

        def matches(self, req):
            return self.allow

        def inject(self, reply, data):
            pass

        def log(self, *args, **kwargs):
            pass

    two_tokens = b"GET /public/x\r\n\r\n"
    ref, port = both_models("graft", "auto")
    data, lengths = encode([two_tokens])
    remotes = np.ones((1,), np.int32)
    _eq(http_verdicts(port, data, lengths, remotes)[2],
        ref_http.http_verdicts(ref, data, lengths, remotes)[2])
    assert http_verdicts(port, data, lengths, remotes)[2].tolist() == [True]
    big = b"GET /public/" + b"y" * 33000
    whole = big + b" HTTP/1.1\r\n\r\n"
    for parser in (RefParser, HttpParser):
        assert parser(Conn(True)).on_data(False, False, [two_tokens])[0] == DROP
        assert parser(Conn(True)).on_data(False, False, [big]) == (DROP, len(big))
        assert parser(Conn(True)).on_data(False, False, [whole]) == (PASS, len(whole))
    ref_eng, eng = _engine_pair()
    got, want = _drive([eng, ref_eng], [[(1, big, 1), (2, whole, 1)]])
    assert got == want == [(1, [(int(MORE), 1)], b""), (2, [(int(DROP), len(whole))], HTTP_403)]
