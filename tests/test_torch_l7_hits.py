"""K10 and K11's plain versions against the JAX verdict functions.

``cassandra_rule_hits_plain`` / ``cassandra_hits_plain`` and
``memcache_rule_hits_plain`` / ``memcache_hits_plain`` (and the wrappers
``cassandra_hits`` / ``memcache_hits``, which run them for CPU tensors)
against the reference's ``cassandra_verdicts`` and ``memcache_verdicts``
(``cilium_tpu/models/cassandra.py:159``, ``cilium_tpu/models/memcached.py:208``)
on ``l7_hits_cases``' boundary tables and batches: R of ``R_SIZES`` (1, 2,
3, 40, 129), F up to 4,099.  The reference computes its automaton's
search over the table or key span as it always does, and the port is
given the same hits.  Tolerance 0: every output is bool.  The card holds
the kernels against the same plain versions on the same batches, in
every launch variant, in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l7_hits_cases as lc
from cilium_tpu.models import cassandra as ref_cass
from cilium_tpu.models import memcached as ref_mc
from cilium_tpu.ops.rxsearch import automaton_search_spans as ref_search
from cilium_tpu.ops.rxsearch import compile_automaton as ref_compile
from cilium_tpu_torch.models.cassandra import (
    cassandra_hits,
    cassandra_hits_plain,
    cassandra_rule_hits_plain,
)
from cilium_tpu_torch.models.memcached import (
    TEXT_COMMANDS,
    memcache_hits,
    memcache_hits_plain,
    memcache_rule_hits_plain,
)

NC = len(TEXT_COMMANDS)


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
    """(r, f, seed): every R, F up to 4,099 (1,031 past 40 rows: the
    reference's [F, R, 96] compare tensors bound the rest), and tables of
    seed 3, whose first two rows name no table regex (no automaton)."""
    return [(r, f, 0) for r in lc.R_SIZES for f in lc.F_SIZES if r <= 40 or f <= 1031] + [
        (1, 1031, 3), (2, 4099, 3)]


def _tables(t):
    return {k: jnp.asarray(v) for k, v in t.items() if k != "patterns"}


def _cass(r, f, seed):
    """(tables, batch, the reference's allow, the port's model and its
    arguments with the reference's rx)."""
    t = lc.cass_tables(r, seed)
    b = lc.cass_batch(t, f, seed)
    nfa = ref_compile(t["patterns"])
    jm = ref_cass.CassandraBatchModel(nfa=nfa, **_tables(t))
    start = jnp.full((f,), lc.MAX_ACTION, jnp.int32)
    rx = np.asarray(ref_search(nfa, jnp.asarray(b["data"]), start, start + jnp.asarray(b["table_len"])))
    want = np.asarray(ref_cass.cassandra_verdicts(
        jm, *(b[k] for k in ("data", "action_len", "table_len", "non_query", "remotes"))))
    model = lc.cass_model(t)
    args = [torch.from_numpy(b[k]) for k in ("data", "action_len", "table_len", "non_query")]
    rx_t = torch.from_numpy(rx.copy()) if model.nfa is not None else None
    return t, b, want, model, (*args, rx_t, torch.from_numpy(b["remotes"]))


def _mc(r, f, seed):
    t = lc.mc_tables(r, NC, seed)
    b = lc.mc_batch(t, f, NC, seed)
    nfa = ref_compile(t["patterns"])
    jm = ref_mc.MemcacheBatchModel(nfa=nfa, **_tables(t))
    zeros = jnp.zeros((f,), jnp.int32)
    rx = np.asarray(ref_search(nfa, jnp.asarray(b["key_data"]), zeros, jnp.asarray(b["key_len"])))
    keys = ("key_data", "key_len", "has_key", "is_binary", "opcode", "cmd_id")
    want = np.asarray(ref_mc.memcache_verdicts(jm, *(b[k] for k in keys), b["remotes"]))
    model = lc.mc_model(t)
    rx_t = torch.from_numpy(rx.copy()) if model.nfa is not None else None
    return t, b, want, model, (*(torch.from_numpy(b[k]) for k in keys), rx_t,
                               torch.from_numpy(b["remotes"]))


@pytest.mark.parametrize("r,f,seed", _cases())
def test_plain_cassandra_hits_match_reference(r, f, seed):
    _, _, want, model, args = _cass(r, f, seed)
    allow = cassandra_hits_plain(model, *args)
    np.testing.assert_array_equal(allow.numpy(), want)
    assert torch.equal(cassandra_rule_hits_plain(model, *args).any(dim=1), allow)
    assert torch.equal(cassandra_hits(model, *args), allow)


@pytest.mark.parametrize("r,f,seed", _cases())
def test_plain_memcache_hits_match_reference(r, f, seed):
    _, _, want, model, args = _mc(r, f, seed)
    allow = memcache_hits_plain(model, *args)
    np.testing.assert_array_equal(allow.numpy(), want)
    assert torch.equal(memcache_rule_hits_plain(model, *args).any(dim=1), allow)
    assert torch.equal(memcache_hits(model, *args), allow)


def _first_kinds(hits, kinds, seed=0):
    """The kind of each request's first allowing row (None where none)."""
    h = hits.numpy()
    first = h.argmax(axis=1)
    return [kinds[(j + seed) % len(kinds)] if h[i].any() else None for i, j in enumerate(first)]


def test_cassandra_cases_put_every_trap():
    """The batches hold first hits by every row kind but the near action,
    requests allowed by a zero-length needle with a negative action length,
    by a needle of 40 (32 bytes compared) with an action length of 40, by
    non-query rows alone and with an empty table name, and denied ones;
    and tables with no automaton."""
    seen = set()
    neg = long40 = nq = no_table = False
    no_rx = False
    for r, f, seed in _cases():
        if f < 1031:
            continue
        t, b, want, model, args = _cass(r, f, seed)
        hits = cassandra_rule_hits_plain(model, *args)
        kinds = _first_kinds(hits, lc.CASS_KINDS, seed)
        no_rx |= model.nfa is None
        seen |= {k for k in kinds if k}
        alen = b["action_len"]
        neg |= any(k == "empty-needle" and a < 0 for k, a in zip(kinds, alen))
        long40 |= any(k == "len40" and a == 40 for k, a in zip(kinds, alen))
        nq |= bool((want & b["non_query"]).any())
        no_table |= bool((want & (b["table_len"] == 0) & ~b["non_query"]).any())
        assert want.any() and not want.all()
    assert seen >= set(lc.CASS_KINDS) - {"near"}, sorted(set(lc.CASS_KINDS) - seen)
    assert neg and long40 and nq and no_table and no_rx


def test_memcache_cases_put_every_trap():
    """The batches hold first hits by every row kind, keyless frames
    allowed by keyed rows, prefix hits by keys over 96 bytes, binary and
    text frames with indices outside their tables, denied ones, and tables
    with no automaton."""
    seen = set()
    keyless = over96 = odd_bin = odd_text = False
    no_rx = False
    for r, f, seed in _cases():
        if f < 1031:
            continue
        t, b, want, model, args = _mc(r, f, seed)
        hits = memcache_rule_hits_plain(model, *args)
        kinds = _first_kinds(hits, lc.MC_KINDS, seed)
        no_rx |= model.nfa is None
        seen |= {k for k in kinds if k}
        keyless |= any(k in ("exact", "exact16") and not hk for k, hk in zip(kinds, b["has_key"]))
        over96 |= any(k and k.startswith("prefix") and kl > 96 for k, kl in zip(kinds, b["key_len"]))
        odd_bin |= bool((want & b["is_binary"] & ((b["opcode"] < 0) | (b["opcode"] > 255))).any())
        odd_text |= bool((want & ~b["is_binary"] & ((b["cmd_id"] < 0) | (b["cmd_id"] >= NC))).any())
        assert want.any() and not want.all()
    assert seen >= set(lc.MC_KINDS), sorted(set(lc.MC_KINDS) - seen)
    assert keyless and over96 and odd_bin and odd_text and no_rx
