"""Port ops at device="cpu" against the JAX package's ops, bit for bit.

The same numpy inputs, made from a seed, go through ``cilium_tpu.ops`` (JAX
on the CPU) and ``cilium_tpu_torch.ops`` (the kernels' plain versions).
Every output is bool or int: the tolerance is 0.  Lengths cover [0, L],
spans include start >= end, rows put CRLF in the last column and carry no
space, one space or two.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from cilium_tpu.ops import bytescan as ref_bs
from cilium_tpu.ops.dfa import device_dfa as ref_device_dfa
from cilium_tpu.ops.dfa import dfa_search_batch as ref_dfa_batch
from cilium_tpu.ops.dfa import dfa_search_spans as ref_dfa_spans
from cilium_tpu.ops.nfa import device_nfa as ref_device_nfa
from cilium_tpu.ops.nfa import nfa_search_batch as ref_nfa_batch
from cilium_tpu.ops.nfa import nfa_search_spans as ref_nfa_spans
from cilium_tpu.regex import compile_patterns as ref_compile_patterns
from cilium_tpu.regex.dfa import compile_pattern_dfas as ref_compile_dfas
from cilium_tpu_torch import kernels
from cilium_tpu_torch.models.r2d2 import r2d2_frame
from cilium_tpu_torch.ops import bytescan as port_bs
from cilium_tpu_torch.ops.dfa import device_dfa, dfa_search_batch, dfa_search_spans
from cilium_tpu_torch.ops.nfa import device_nfa, nfa_search_batch, nfa_search_spans
from cilium_tpu_torch.ops.rxsearch import (
    DeviceDfa,
    DeviceNfa,
    automaton_search_batch,
    compile_automaton,
)
from cilium_tpu_torch.regex import compile_patterns
from cilium_tpu_torch.regex.dfa import DfaBlowupError, compile_pattern_dfas

CPU = torch.device("cpu")
F, L = 192, 48
ALPHABET = np.frombuffer(b"READ HALT /public/x.txt\r\nabcd01", np.uint8)
PATTERNS = [
    "/public/.*", "", "^/public/", "\\.txt$", "a.c", "(ab|cd)+", "^$",
    "[^abc]", "^(READ|HALT)$", "x{2,3}", "/g07/[a-z0-9]+/item/.*",
]
NFA_PATTERNS = PATTERNS[:4] + ["/n00/(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)/x"]


def _fuzz(seed, f=F, l=L):
    rng = np.random.default_rng(seed)
    data = rng.choice(ALPHABET, size=(f, l)).astype(np.uint8)
    lengths = rng.integers(0, l + 1, size=f).astype(np.int32)
    lengths[:6] = [0, l, l, 1, l - 1, 2]
    data[1, l - 2 :] = [0x0D, 0x0A]  # CRLF in the last two columns
    data[2, l - 1] = 0x0D  # CR in the last column: no CRLF
    data[4, :] = 0x41  # no space, no CRLF
    data[5, :2] = [0x0D, 0x0A]
    rows = [b"READ /x\r\n", b"READ a b\r\n", b"HALT\r\n", b"READ  two\r\n"]
    for i, m in enumerate(rows):
        data[6 + i, :] = 0
        data[6 + i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[6 + i] = len(m)
    start = rng.integers(0, lengths + 1).astype(np.int32)
    end = rng.integers(0, lengths + 1).astype(np.int32)  # start >= end too
    return data, lengths, start, end


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bytescan_reductions_match(seed):
    data, lengths, _, _ = _fuzz(seed)
    d, n = _t(data, lengths)
    for byte in (0x20, 0x0D, 0x41):
        _eq(port_bs.first_occurrence(d, n, byte), ref_bs.first_occurrence(data, lengths, byte))
        _eq(port_bs.count_byte(d, n, byte), ref_bs.count_byte(data, lengths, byte))
    _eq(
        port_bs.first_subsequence2(d, n, 0x0D, 0x0A),
        ref_bs.first_subsequence2(data, lengths, 0x0D, 0x0A),
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_span_compares_match(seed):
    data, lengths, start, end = _fuzz(seed)
    rng = np.random.default_rng(seed)
    needles = np.zeros((5, 8), np.uint8)
    nlen = np.array([4, 0, 1, 8, 3], np.int32)
    for r in range(5):
        src = data[rng.integers(0, F), : nlen[r]]
        needles[r, : nlen[r]] = src
    d, s, e, nd, nl = _t(data, start, end, needles, nlen)
    _eq(
        port_bs.spans_equal_prefix(d, s, e, nd, nl),
        ref_bs.spans_equal_prefix(data, start, end, needles, nlen),
    )
    _eq(
        port_bs.spans_start_with(d, s, e, nd, nl),
        ref_bs.spans_start_with(data, start, end, needles, nlen),
    )
    # the r2d2 command compare: spans [0, first space)
    sp = ref_bs.first_occurrence(data, lengths, 0x20)
    zero = np.zeros_like(lengths)
    _eq(
        port_bs.spans_equal_prefix(d, _t(zero)[0], torch.from_numpy(np.array(sp)), nd, nl),
        ref_bs.spans_equal_prefix(data, zero, sp, needles, nlen),
    )


@pytest.mark.parametrize("seed", [5, 6])
def test_r2d2_frame_plain_matches_reference_framing(seed):
    data, lengths, _, _ = _fuzz(seed)
    frame = r2d2_frame(*_t(data, lengths))
    crlf = ref_bs.first_subsequence2(data, lengths, 0x0D, 0x0A)
    sp = ref_bs.first_occurrence(data, crlf, 0x20)
    one = np.asarray(ref_bs.count_byte(data, crlf, 0x20)) == 1
    _eq(frame.crlf, crlf)
    _eq(frame.complete, np.asarray(crlf) < lengths)
    _eq(frame.msg_len, np.asarray(crlf) + 2)
    _eq(frame.sp, sp)
    _eq(frame.file_start, np.where(one, np.asarray(sp) + 1, 0))
    _eq(frame.file_end, np.where(one, np.asarray(crlf), 0))


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_dfa_search_matches(seed):
    data, lengths, start, end = _fuzz(seed)
    ref = ref_device_dfa(ref_compile_dfas(PATTERNS))
    port = device_dfa(compile_pattern_dfas(PATTERNS), CPU)
    d, n, s, e = _t(data, lengths, start, end)
    _eq(dfa_search_spans(port, d, s, e), ref_dfa_spans(ref, data, start, end))
    _eq(dfa_search_batch(port, d, n), ref_dfa_batch(ref, data, lengths))


@pytest.mark.parametrize("seed", [10, 11])
def test_nfa_search_matches(seed):
    data, lengths, start, end = _fuzz(seed)
    # sprinkle strings the blowup pattern matches
    for i in range(0, F, 7):
        m = b"/n00/babaabbbbbbb/x"
        data[i, : len(m)] = np.frombuffer(m, np.uint8)
        lengths[i] = max(lengths[i], len(m))
        start[i], end[i] = 0, lengths[i]
    ref = ref_device_nfa(ref_compile_patterns(NFA_PATTERNS))
    port = device_nfa(compile_patterns(NFA_PATTERNS), CPU)
    d, n, s, e = _t(data, lengths, start, end)
    got = nfa_search_spans(port, d, s, e)
    _eq(got, ref_nfa_spans(ref, data, start, end))
    _eq(nfa_search_batch(port, d, n), ref_nfa_batch(ref, data, lengths))
    assert bool(got[:, -1].any())


def test_dispatch_keeps_the_128_state_guard():
    # 2^8 DFA states: under MAX_DFA_STATES (512) but over the device guard
    blowup = NFA_PATTERNS[-1:]
    assert compile_pattern_dfas(blowup).n_states > 128
    with pytest.raises(DfaBlowupError):
        device_dfa(compile_pattern_dfas(blowup), CPU)
    with pytest.raises(DfaBlowupError):
        compile_automaton(blowup, CPU, backend="dfa")
    assert isinstance(compile_automaton(blowup, CPU), DeviceNfa)
    assert isinstance(compile_automaton(PATTERNS, CPU), DeviceDfa)
    assert compile_automaton([], CPU) is None
    data, lengths, _, _ = _fuzz(12)
    d, n = _t(data, lengths)
    ref = ref_device_nfa(ref_compile_patterns(blowup))
    _eq(automaton_search_batch(compile_automaton(blowup, CPU), d, n), ref_nfa_batch(ref, data, lengths))


def test_automaton_uploads_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_dfa(compile_pattern_dfas(PATTERNS))
    with pytest.raises(RuntimeError, match="CUDA"):
        device_nfa(compile_patterns(NFA_PATTERNS))
    assert device_nfa(compile_patterns(NFA_PATTERNS), CPU).classmap.device == CPU


def test_wrappers_check_inputs():
    port = device_dfa(compile_pattern_dfas(["abc"]), CPU)
    data = torch.zeros((4, 8), dtype=torch.uint8)
    span = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(TypeError):
        dfa_search_spans(port, data.to(torch.int32), span, span)
    with pytest.raises(ValueError):
        dfa_search_spans(port, data.t(), span, span)
    with pytest.raises(ValueError):
        dfa_search_spans(port, data, span[:3], span)
    with pytest.raises(TypeError):
        r2d2_frame(data, span.to(torch.int64))


def test_launch_counters_lose_no_count_under_threads(monkeypatch):
    """Many threads launching one kernel (half of them while "capturing")
    and replaying graphs that hold it: every launch, capture and replay is
    counted (the counters are updated under kernels._lock).  The launcher
    is a stub, so no card is needed."""
    capturing = threading.local()
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))
    k = kernels.CudaKernel("stub", "stub", [])
    k._fn = lambda stream: 0
    n_threads, n_calls = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            capturing.on = i % 2 == 1
            for _ in range(n_calls):
                k.launch(torch.device("cuda"))
                kernels.add_replays([(k, 3)])

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        kernels.ALL.remove(k)
    half = n_threads // 2 * n_calls
    assert (k.launches, k.captured, k.replayed) == (half, half, 3 * n_threads * n_calls)
