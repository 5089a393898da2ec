"""The framing kernels' plain versions against the JAX formulas.

K1 ``r2d2_frame`` and K5 ``http_frame`` on the CPU (their plain PyTorch
versions) against the reference's reductions, on ``frame_cases``'
boundary batches: lengths 0, 1, L - 1, L and over L, a CR at n - 1, CRLF
and CRLFCRLF straddling every 4-byte, 16-byte and step boundary, 0-3+
spaces, LFs before the first space and inside the path, request lines
longer than one step.  Tolerance 0: every output is bool or int.  The card
holds the kernels against the same plain versions on the same batches in
tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.models.http import _first_crlfcrlf, _first_occurrence_after, _last_in_span
from cilium_tpu.ops.bytescan import count_byte, first_occurrence, first_subsequence2
from cilium_tpu_torch.models.http import http_frame
from cilium_tpu_torch.models.r2d2 import r2d2_frame
from frame_cases import WIDTHS, frame_batch


@pytest.fixture(autouse=True, scope="module")
def _reference_leak_guard():
    """Reference tests leave a dummy HTTP rule parser registered and a
    FlightRecorder installed (ROADMAP Queue 3): put the real parser back
    and uninstall every recorder, before and after this module."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.http import http_rule_parser
    from cilium_tpu.sidecar import blackbox as ref_bb
    from cilium_tpu_torch.sidecar import blackbox as port_bb

    def clean():
        register_l7_rule_parser("http", http_rule_parser)
        for bb in (ref_bb, port_bb):
            for rec in list(bb._RECORDERS):
                rec.uninstall()

    clean()
    yield
    clean()


def ref_r2d2_frame(data, lengths):
    """The reference's K1 formulas (cilium_tpu/models/r2d2.py:220-228)."""
    crlf = first_subsequence2(data, lengths, 0x0D, 0x0A)
    sp = first_occurrence(data, crlf, 0x20)
    one = count_byte(data, crlf, 0x20) == 1
    return dict(
        crlf=crlf, complete=crlf < lengths, msg_len=crlf + 2, sp=sp,
        file_start=jnp.where(one, sp + 1, 0), file_end=jnp.where(one, crlf, 0),
    )


def ref_http_frame(data, lengths):
    """The reference's K5 formulas (cilium_tpu/models/http.py:440-449, the
    literal slots' last LF of :409)."""
    crlf2 = _first_crlfcrlf(data, lengths)
    line_end = first_subsequence2(data, lengths, 0x0D, 0x0A)
    sp1 = first_occurrence(data, line_end, 0x20)
    sp2 = _first_occurrence_after(data, sp1, line_end, 0x20)
    return dict(
        crlf2=crlf2, complete=crlf2 < lengths, head_len=crlf2 + 4, line_end=line_end,
        sp1=sp1, sp2=sp2, last_nl_m=_last_in_span(data, jnp.zeros_like(sp1), sp1, 0x0A),
        last_nl_p=_last_in_span(data, sp1 + 1, sp2, 0x0A),
    )


KERNELS = {"r2d2_frame": (r2d2_frame, ref_r2d2_frame), "http_frame": (http_frame, ref_http_frame)}


@pytest.mark.parametrize("l", WIDTHS)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_frame_matches_reference(kernel, l):
    port, ref = KERNELS[kernel]
    data, lengths = frame_batch(l)
    got = port(torch.from_numpy(data), torch.from_numpy(lengths))
    want = ref(jnp.asarray(data), jnp.asarray(lengths))
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("l", WIDTHS)
def test_frame_batch_puts_every_case(l):
    """The batch holds what its docstring promises: complete and
    incomplete heads, lengths 0 and over l, lines with 0 to 3 spaces, LFs
    before the first space and in the path."""
    data, lengths = frame_batch(l)
    d, n = torch.from_numpy(data), torch.from_numpy(lengths)
    h = http_frame(d, n)
    r = r2d2_frame(d, n)
    assert bool(h.complete.any()) and not bool(h.complete.all())
    assert bool((n == 0).any()) and bool((n > l).any()) and bool((n == l).any())
    spaces = torch.where(r.sp < r.crlf, 1, 0) + torch.where(h.sp2 < h.line_end, 1, 0)
    assert set(spaces.tolist()) == {0, 1, 2}
    assert bool((r.file_end > 0).any())  # exactly one space
    assert bool((h.last_nl_m >= 0).any()) and bool((h.last_nl_p >= 0).any())
    assert bool((h.line_end >= 16).any()) and bool((h.crlf2 % 16 >= 13).any())
