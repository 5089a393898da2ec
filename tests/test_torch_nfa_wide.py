"""NFAs with a block of more than 1,024 states, against the reference.

One long bounded repetition compiles to a block of states that no cut
(``ops.nfa.split_parts``) divides: K3 scans it in its wide form on the
card, and the plain scan takes it on the CPU.  Here the port at
``device="cpu"`` gives the reference's results: the HTTP rule
``path="/a{256}b{256}"`` through both packages' ``build_http_model`` and
verdicts, and the 2,064-state pattern through both packages'
``compile_patterns`` and NFA search.  Shapes from tests/nfa_wide_cases.py;
every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from cilium_tpu.models import http as ref_http
from cilium_tpu.ops import nfa as ref_nfa
from cilium_tpu.policy.api import PortRuleHTTP as RefRule
from cilium_tpu.regex import compile_patterns as ref_compile_patterns
from cilium_tpu_torch.models.http import build_http_model, http_verdicts, http_verdicts_attr
from cilium_tpu_torch.ops.nfa import MAX_STATES, WIDE_STATES, device_nfa, nfa_search_batch
from cilium_tpu_torch.ops.rxsearch import DeviceNfa
from cilium_tpu_torch.policy.api import PortRuleHTTP
from cilium_tpu_torch.regex import compile_patterns

import nfa_wide_cases as wc
from policy_cases import reference_leak_guard  # noqa: F401

WIDTH = 560  # the matching head is 550 bytes; the reference's scan costs S * C * S a byte


def _eq(got, want, what=""):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu", what
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def _http_batch():
    """Heads whose paths match the rule, fall one byte short of it, run
    past it, or are cut by the width; other methods; odd lines."""
    reqs = [wc.http_requests(256, 256, WIDTH), wc.http_requests(256, 255, WIDTH),
            wc.http_requests(255, 256, WIDTH), wc.http_requests(256, 256, WIDTH, b"c"),
            wc.http_requests(256, 257, WIDTH), wc.http_requests(300, 300, WIDTH),
            b"PUT /" + b"a" * 256 + b"b" * 256 + b" HTTP/1.1\r\n\r\n", b""]
    data = np.zeros((len(reqs), WIDTH), np.uint8)
    lengths = np.zeros(len(reqs), np.int32)
    for i, r in enumerate(reqs):
        data[i, : len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return data, lengths, np.ones(len(reqs), np.int32)


def test_http_rule_past_one_launch_matches_reference():
    """``GET /a{256}b{256}``: the reference's model serves it, and so does
    the port's at ``device="cpu"`` (its path NFA, one block of more than
    MAX_STATES states, is planned as one wide-form launch), with the
    reference's verdicts and deciding rows."""
    rows = [(frozenset(), wc.HTTP_WIDE_RULE)]
    ref = ref_http.build_http_model([(rs, RefRule(**kw)) for rs, kw in rows])
    port = build_http_model([(rs, PortRuleHTTP(**kw)) for rs, kw in rows], device="cpu")
    assert port.match_kinds == ref.match_kinds
    assert isinstance(port.line_nfa, DeviceNfa)
    assert MAX_STATES < port.line_nfa.n_states <= WIDE_STATES
    assert port.line_nfa.n_states == ref.line_nfa.n_states
    assert all(p.n_states > MAX_STATES for p, _ in port.line_nfa.scan_parts)
    data, lengths, remotes = _http_batch()
    for g, w in zip(http_verdicts(port, data, lengths, remotes),
                    ref_http.http_verdicts(ref, data, lengths, remotes)):
        _eq(g, w, "verdicts")
    got = http_verdicts_attr(port, data, lengths, remotes)
    for g, w in zip(got, ref_http.http_verdicts_attr(ref, data, lengths, remotes)):
        _eq(g, w, "attr")
    assert got[2].tolist()[:5] == [True, False, False, False, False]


def test_2064_state_pattern_matches_reference():
    """The 2,064-state pattern: both packages compile the same tables, and
    the port's search at ``device="cpu"`` gives the reference's results on
    rows with the needle, a near miss and random bytes planted."""
    pattern = wc.WIDE_PATTERNS["nfa-wide-2064"]
    ref_t, port_t = ref_compile_patterns([pattern]), compile_patterns([pattern])
    assert port_t.n_states == ref_t.n_states == 2064
    for name in ("classmap", "delta", "start", "accept", "accept_final"):
        np.testing.assert_array_equal(getattr(port_t, name), getattr(ref_t, name), err_msg=name)
    nfa = device_nfa(port_t, "cpu")
    # rows 2-4 of a planted batch: random bytes, the needle, a near miss
    # (the reference's scan costs S * C * S a byte of every row)
    data, lengths = wc.planted(np.random.default_rng(5), 5, 1032, wc.needle(pattern))
    data, lengths = data[2:], lengths[2:]
    want = np.asarray(ref_nfa.nfa_search_batch(ref_nfa.device_nfa(ref_t), data, lengths))
    got = nfa_search_batch(nfa, torch.from_numpy(data), torch.from_numpy(lengths))
    _eq(got, want)
    assert want[:, 0].tolist() == [False, True, False]

