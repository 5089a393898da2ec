"""K8's plain version against the JAX formula.

``dns_name_plain`` (and the wrapper ``dns_name``, which runs it for CPU
tensors) against the reference's ``_dns_name_span``
(``cilium_tpu/models/dns.py:223-288``) on ``dns_name_cases``' boundary
batches: 0 to 41 labels, label bytes over 63, chains that end at, before
and past min(msg_len, L), QDCOUNT 0, short and incomplete lengths, upper
case and '.' bytes in the data, at every width of ``WIDTHS`` and F of
``F_SIZES``.  Tolerance 0: every output is bool, int or a byte.  The card
holds the kernel against the same plain version on the same batches, in
every launch variant, in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dns_name_cases as dc
from cilium_tpu.models.dns import _dns_name_span
from cilium_tpu_torch.models.dns import dns_name, dns_name_plain


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


def _check(data, lengths):
    got = dns_name_plain(torch.from_numpy(data), torch.from_numpy(lengths))
    want = _dns_name_span(jnp.asarray(data), jnp.asarray(lengths))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert g.dtype == {"complete": torch.bool, "valid": torch.bool,
                           "dotted": torch.uint8}.get(name, torch.int32), name
    for g, w in zip(dns_name(torch.from_numpy(data), torch.from_numpy(lengths)), got):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("l", dc.WIDTHS)
def test_plain_dns_name_matches_reference(l):
    _check(*dc.name_batch(l))


@pytest.mark.parametrize("f", dc.F_SIZES)
@pytest.mark.parametrize("l", (19, 64, 330))
def test_plain_dns_name_matches_reference_at_batch_sizes(l, f):
    _check(*dc.name_batch(l, f, seed=1))


@pytest.mark.parametrize("l", dc.WIDTHS)
def test_name_batch_puts_every_case(l):
    """The batch holds what dns_name_cases promises, where the width
    allows it: valid and invalid rows, complete and incomplete ones, 40
    separators in a valid row and a row invalid by its 41st label,
    separators kept in a row a byte over 63 invalidates, upper case folded,
    '.' bytes in the data, and under 19 bytes the rows unchanged."""
    data, lengths = dc.name_batch(l)
    got = _check(data, lengths)
    d = torch.from_numpy(data)
    if l < 19:
        assert torch.equal(got.dotted, d) and not bool(got.complete.any())
        return
    seps = ((got.dotted == 0x2E) & (d != 0x2E)).sum(dim=1)
    assert bool(got.valid.any()) and not bool(got.valid.all())
    assert bool(got.complete.any()) and not bool(got.complete.all())
    assert bool((seps[~got.valid] > 0).any())  # separators kept in invalid rows
    assert bool(((d >= 0x41) & (d <= 0x5A)).any()) and bool((got.dotted[:, 15:] != d[:, 15:]).any())
    assert bool((d[:, 15:] == 0x2E).any())
    if l >= 128:
        assert int(seps[got.valid].max()) == 40 and int(seps.max()) == 40
        assert bool((got.span_end[got.valid] >= l - 8).any())
