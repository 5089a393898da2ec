"""The rule walks' plain versions against the JAX formulas.

K4 ``r2d2_hits`` and K9 ``dns_hits`` on the CPU (their plain PyTorch
versions, and the wrappers, which run them for CPU tensors) against the
reference's formulas, ``cilium_tpu.ops.bytescan.spans_equal_prefix``,
``cilium_tpu.models.base.remote_ok`` and ``first_match`` composed as
``cilium_tpu/models/r2d2.py:230-238`` and ``cilium_tpu/models/dns.py:301-314``
compose them, on ``hits_cases``' boundary batches and tables: R from 1 to
256, F from 1 to 4,099.  Tolerance 0: every output is bool or int.

The reference's ``window_at`` has two forms: on the TPU it zero-fills
past the row's end, on the CPU it repeats the row's last byte.  The port
follows the TPU form (a byte at or past L reads as 0), so the reference
runs here in that form; the two differ only where a command byte at or
past L is compared (sp over L < 8).  The card holds the kernels against
the same plain versions on the same batches in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hits_cases as hc
from cilium_tpu.models.base import first_match, remote_ok
from cilium_tpu.ops import bytescan
from cilium_tpu_torch.models.dns import dns_hits, dns_hits_plain
from cilium_tpu_torch.models.r2d2 import r2d2_hits, r2d2_hits_plain


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


@pytest.fixture
def tpu_window(monkeypatch):
    """The reference's window_at in its TPU form (the zero fill the port
    follows), whatever backend runs it."""
    monkeypatch.setattr(bytescan.jax, "default_backend", lambda: "tpu")


def ref_r2d2_hits(t, b):
    """The reference's K4 formulas (cilium_tpu/models/r2d2.py:230-238 and
    the two reductions of :255, :271)."""
    sp = jnp.asarray(b["sp"])
    cmd_ok = bytescan.spans_equal_prefix(
        jnp.asarray(b["data"]), jnp.zeros_like(sp), sp, jnp.asarray(t["cmd_needle"]),
        jnp.asarray(t["cmd_len"]),
    ) | jnp.asarray(t["cmd_any"])[None, :]
    rem_ok = remote_ok(jnp.asarray(b["remotes"]), jnp.asarray(t["remote_ids"]),
                       jnp.asarray(t["any_remote"]))
    hits = cmd_ok & jnp.asarray(b["file_ok"]) & rem_ok
    allow = jnp.any(hits, axis=1)
    return np.asarray(allow), np.asarray(first_match(hits, allow))


def ref_dns_hits(t, b):
    """The reference's K9 formulas (cilium_tpu/models/dns.py:301-314 and
    the reductions of :318, :332); an absent rx is no automaton hit."""
    f, r = b["dotted"].shape[0], t["name_len"].shape[0]
    exact_ok = bytescan.spans_equal_prefix(
        jnp.asarray(b["dotted"]), jnp.asarray(b["span_start"]), jnp.asarray(b["span_end"]),
        jnp.asarray(t["name_needle"]), jnp.asarray(t["name_len"]),
    )
    rx_ok = jnp.asarray(b["rx"]) if b["rx"] is not None else jnp.zeros((f, r), bool)
    name_ok = jnp.asarray(t["name_any"])[None, :] | (
        (exact_ok | (jnp.asarray(t["use_rx"])[None, :] & rx_ok)) & jnp.asarray(b["valid"])[:, None]
    )
    hits = name_ok & remote_ok(jnp.asarray(b["remotes"]), jnp.asarray(t["remote_ids"]),
                               jnp.asarray(t["any_remote"]))
    allow = jnp.any(hits, axis=1)
    return np.asarray(allow), np.asarray(first_match(hits, allow))


def _cases(widths):
    return [(r, f, widths[i % len(widths)]) for r in hc.R_SIZES
            for i, f in enumerate(hc.f_sizes(r))]


def _r2d2(r, f, l):
    t = hc.r2d2_tables(r)
    b = hc.r2d2_batch(t, f, l)
    model = hc.r2d2_model(t)
    args = [torch.from_numpy(b[k]) for k in ("data", "sp", "file_ok", "remotes")]
    return t, b, model, args


def _dns(r, f, l, rx):
    t = hc.dns_tables(r, w=24 if r < 64 else 64)
    b = hc.dns_batch(t, f, l, rx=rx)
    model = hc.dns_model(t, rx=rx)
    name = hc.dns_name(b)
    rx_t = None if b["rx"] is None else torch.from_numpy(b["rx"])
    return t, b, model, (name, rx_t, torch.from_numpy(b["remotes"]))


# L 6: sp over L with 8-byte commands; 67: rows not 8-byte aligned.
@pytest.mark.parametrize("r,f,l", _cases((64, 6, 67)))
def test_plain_r2d2_hits_matches_reference(tpu_window, r, f, l):
    t, b, model, args = _r2d2(r, f, l)
    allow, rule = r2d2_hits_plain(model, *args)
    want_allow, want_rule = ref_r2d2_hits(t, b)
    np.testing.assert_array_equal(allow.numpy(), want_allow)
    np.testing.assert_array_equal(rule.numpy(), want_rule)
    assert rule.dtype == torch.int32
    for g, w in zip(r2d2_hits(model, *args), (allow, rule)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rx", [True, False], ids=["rx", "no-rx"])
@pytest.mark.parametrize("r,f,l", _cases((64, 61, 40)))
def test_plain_dns_hits_matches_reference(tpu_window, r, f, l, rx):
    t, b, model, args = _dns(r, f, l, rx)
    allow, rule = dns_hits_plain(model, *args)
    want_allow, want_rule = ref_dns_hits(t, b)
    np.testing.assert_array_equal(allow.numpy(), want_allow)
    np.testing.assert_array_equal(rule.numpy(), want_rule)
    assert rule.dtype == torch.int32
    for g, w in zip(dns_hits(model, *args), (allow, rule)):
        assert torch.equal(g, w)


def test_r2d2_cases_put_every_case():
    """The batches hold what hits_cases promises: sp at 0, 1, 8, 9 and over
    L, hits and misses, a first hit on a padding row (sp 0, remote -1), on
    a 32-remote row, on a command of 8 and of 9 bytes, and walks past 32
    rows."""
    seen = dict(pad=False, many=False, cmd8=False, cmd9=False, deep=False)
    for r, f, l in _cases((64, 6, 67)):
        t, b, model, args = _r2d2(r, f, l)
        allow, rule = r2d2_hits_plain(model, *args)
        sp = b["sp"]
        assert {0, 1, 8, 9} <= set(sp.tolist()) or f < 6
        assert bool((sp > l).any()) or f < 6
        if f >= 1031:
            assert bool(allow.any()) and not bool(allow.all())
        hit = rule.numpy()[allow.numpy()]
        kinds = [hc.R2D2_KINDS[(i + 2) % len(hc.R2D2_KINDS)] for i in hit]
        for k in ("pad", "many", "cmd8", "cmd9"):
            seen[k] |= k in kinds
        seen["deep"] |= bool((hit >= 32).any())
    assert all(seen.values()), seen


def test_window_forms_differ_only_past_the_row(monkeypatch):
    """The reference's two window_at forms give other K4 verdicts on the
    batches, and only on flows whose sp is over L (a command byte past
    the row compared): why the reference runs in its TPU form here."""
    differ = 0
    for r, f, l in _cases((64, 6, 67)):
        t, b, _, _ = _r2d2(r, f, l)
        cpu = ref_r2d2_hits(t, b)
        with monkeypatch.context() as m:
            m.setattr(bytescan.jax, "default_backend", lambda: "tpu")
            tpu = ref_r2d2_hits(t, b)
        rows = (cpu[0] != tpu[0]) | (cpu[1] != tpu[1])
        assert bool((b["sp"][rows] > l).all())
        differ += int(rows.sum())
    assert differ > 0


def test_dns_cases_put_every_case():
    """The DNS batches hold: spans ending at L and with start > end,
    invalid flows matched by byte-free rows only, first hits by an exact
    name, a sibling name, a name as long as W and one longer, the
    automaton tier and padding never."""
    seen = {k: False for k in ("any-invalid", "name", "sibling", "long", "rx", "end-at-L", "empty")}
    for r, f, l in _cases((64, 61, 40)):
        t, b, model, args = _dns(r, f, l, True)
        allow, rule = dns_hits_plain(model, *args)
        a, ru = allow.numpy(), rule.numpy()
        kinds = np.array([hc.DNS_KINDS[(i + 2) % len(hc.DNS_KINDS)] for i in range(r)])
        seen["any-invalid"] |= bool((a & ~b["valid"]).any())
        assert set(kinds[ru[a & ~b["valid"]]]) <= {"any"}
        for k in ("name", "sibling", "long"):
            seen[k] |= bool((kinds[ru[a]] == k).any())
        seen["rx"] |= bool(np.isin(kinds[ru[a]], ["rx", "name+rx"]).any())
        assert not bool((kinds[ru[a]] == "pad").any())
        seen["end-at-L"] |= bool((b["span_end"] == l).any())
        seen["empty"] |= bool((b["span_start"] > b["span_end"]).any())
    assert all(seen.values()), seen
