"""K17's plain versions against the JAX formulas.

``kafka_rule_hits`` and ``kafka_verdicts_plain`` (and the wrapper
``kafka_hits``, which runs them for CPU tensors, with and without
``parts``) against the reference's ``kafka_rule_hits`` and
``kafka_verdicts`` (``cilium_tpu/models/kafka.py:229-330``) on
``kafka_cases``' boundary tables and batches: api keys -1 to 70, exact and
any versions, parsed and unparsed rows, client ids of 0 and 64 bytes and
equal up to the last byte, 0 to 9 topics, topics equal up to the last
byte and rule topics longer than W, remote sets of 1 and 32 ids and
any-remote rows, R of ``R_SIZES``, W of ``W_SIZES``.  Tolerance 0: every
output is bool.  The card holds the kernel against the same plain
versions on the same batches, in every launch variant, in
tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kafka_cases as kc
from cilium_tpu.models import kafka as ref
from cilium_tpu_torch.models.kafka import kafka_hits, kafka_rule_hits, kafka_verdicts_plain


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


def _cases():
    """(r, w, f): every R and W, F of F_SIZES (4,099 at W = 32 and R up to
    33: the reference's [F, T, R, W] compare bounds the rest)."""
    return [(r, w, f) for r in kc.R_SIZES for w in kc.W_SIZES for f in kc.F_SIZES
            if f < 4099 or (w == 32 and r <= 33)]


def _run(r, w, f):
    t = kc.kafka_tables(r, w)
    b, rem = kc.kafka_batch(t, f, w)
    model, batch, remotes = kc.kafka_model(t), kc.request_batch(b), torch.from_numpy(rem)
    simple, cover = kafka_rule_hits(model, batch, remotes)
    allow = kafka_verdicts_plain(model, batch, remotes)
    jm = ref.KafkaBatchModel(**{k: jnp.asarray(v) for k, v in t.items()})
    jb = ref.KafkaRequestBatch(**b)
    want_simple, want_cover = ref.kafka_rule_hits(jm, jb, rem)
    np.testing.assert_array_equal(simple.numpy(), np.asarray(want_simple))
    np.testing.assert_array_equal(cover.numpy(), np.asarray(want_cover))
    np.testing.assert_array_equal(allow.numpy(), np.asarray(ref.kafka_verdicts(jm, jb, rem)))
    assert torch.equal(kafka_hits(model, batch, remotes), allow)
    for g, w_ in zip(kafka_hits(model, batch, remotes, parts=True), (allow, simple, cover)):
        assert torch.equal(g, w_)
    return t, b, allow, simple, cover


@pytest.mark.parametrize("r,w,f", _cases())
def test_plain_kafka_hits_match_reference(r, w, f):
    _run(r, w, f)


def test_kafka_cases_put_every_case():
    """The batches hold what kafka_cases promises: allowed and denied rows,
    allowed by `simple` and by every slot covered, covers of slots past a
    row's first, overflow rows, rule topics longer than W, and unparsed
    rows allowed by a topic rule's nil-topic gate."""
    seen = dict(simple=False, covered=False, multi=False, overflow=False, long=False,
                unparsed=False)
    for r, w, f in _cases():
        if f < 2048:
            continue
        t, b, allow, simple, cover = _run(r, w, f)
        a, s = allow.numpy(), simple.numpy()
        tc = b["topic_count"]
        assert a.any() or r <= 2
        assert not a.all()
        seen["simple"] |= bool((a & s).any())
        seen["covered"] |= bool((a & ~s & (tc > 0)).any())
        seen["multi"] |= bool((a & ~s & (tc > 1)).any()) and bool(cover.numpy()[:, 1:].any())
        seen["overflow"] |= bool((b["overflow"] & ~a).any() and b["overflow"].any())
        seen["long"] |= bool((t["topic_len"] > w).any())
        seen["unparsed"] |= bool((a & ~b["parsed"]).any())
    assert all(seen.values()), seen
