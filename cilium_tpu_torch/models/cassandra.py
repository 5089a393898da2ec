"""Cassandra batch verdict model — device-side (action, table) ACL.

Counterpart of ``cilium_tpu/models/cassandra.py``.  Replaces the
per-request rule walk of the reference's cassandra parser (reference:
proxylib/cassandra/cassandraparser.go:58-95 Rule.Matches +
proxylib/proxylib/policymap.go rule cascade) with one device pass over a
batch of pre-tokenized requests.  The CQL tokenizer itself (stateful:
keyspace tracking, prepared-statement cache) stays host-side in the
streaming parser; what scales on device is the ACL:

  allow[f] = OR_r ( remote_ok[f,r] AND
                    (non_query[f] OR (action_ok[f,r] AND table_ok[f,r])) )

- non_query: paths with <= 2 parts (non-query-like opcodes) match every
  rule (cassandraparser.go:74-76)
- action_ok: exact compare against the rule's query_action (or any)
- table_ok: rule regex search over the table name (K2 ``dfa_scan`` or K3
  ``nfa_scan`` on the table span, only when some rule has a table
  regex); empty table name skips the table check (cassandraparser.go:87-91)

On the card the ACL itself is kernel K10 ``cassandra_hits``.  Input layout
[F, MAX_ACTION + MAX_TABLE] uint8: action bytes at offset 0, table bytes
at MAX_ACTION — one array, two spans.  The host compile and the encoder
are copies of the reference's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from ..ops.bytescan import spans_equal_prefix
from ..ops.rxsearch import DeviceDfa, DeviceNfa, automaton_search_spans, compile_automaton
from ..proxylib.parsers.cassandra import CassandraRule
from ..proxylib.policy import CompiledPortRules, PolicyInstance
from .base import MAX_REMOTES, ConstVerdict, VerdictModel, pack_remote_sets, remote_ok

MAX_ACTION = 32  # longest action is "create-materialized-view" (24)
MAX_TABLE = 96

_CASSANDRA_HITS = kernels.CudaKernel(
    "cassandra_hits", "cassandra_hits",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)


@dataclass
class CassandraBatchModel(VerdictModel):
    nfa: "DeviceDfa | DeviceNfa | None"  # query_table regex rows; None: no such row
    action_needle: torch.Tensor  # [R, MAX_ACTION] uint8
    action_len: torch.Tensor  # [R] int32
    action_any: torch.Tensor  # [R] bool
    table_none: torch.Tensor  # [R] bool — rule has no table regex
    remote_ids: torch.Tensor  # [R, MAX_REMOTES] int32
    any_remote: torch.Tensor  # [R] bool

    def __post_init__(self):
        # K10 reads these tables as they are: check them once, here.
        device = self.device
        chk = kernels.check
        chk(self.action_len, "action_len", torch.int32, (None,), device)
        r = self.action_len.shape[0]
        chk(self.action_needle, "action_needle", torch.uint8, (r, MAX_ACTION), device)
        chk(self.action_any, "action_any", torch.bool, (r,), device)
        chk(self.table_none, "table_none", torch.bool, (r,), device)
        chk(self.remote_ids, "remote_ids", torch.int32, (r, MAX_REMOTES), device)
        chk(self.any_remote, "any_remote", torch.bool, (r,), device)
        if self.nfa is not None and (
            self.nfa.device != device or self.nfa.n_patterns != r
        ):
            raise ValueError("nfa: expected one pattern per rule row on the model's device")

    @property
    def device(self) -> torch.device:
        return self.action_needle.device

    @property
    def n_rules(self) -> int:
        return self.action_len.shape[0]

    def __call__(self, data, action_len, table_len, non_query, remotes):
        return cassandra_verdicts(
            self, data, action_len, table_len, non_query, remotes
        )


def _collect_rows(rules: CompiledPortRules):
    rows = []  # (remote_set, action_exact, table_regex)
    for rule in rules.rules:
        matchers = rule.l7_matchers or [None]
        for m in matchers:
            if m is None:
                rows.append((rule.allowed_remotes, "", ""))
            else:
                if not isinstance(m, CassandraRule):
                    raise TypeError(f"not a cassandra rule: {m!r}")
                rows.append(
                    (rule.allowed_remotes, m.query_action_exact, m.table_regex)
                )
    return rows


def build_cassandra_model(
    policy: PolicyInstance | None, ingress: bool, port: int, device=None
) -> ConstVerdict | CassandraBatchModel:
    """Port-cascade build onto ``device`` (None: the CUDA card), identical
    in structure to build_r2d2_model (reference port cascade:
    proxylib/proxylib/policymap.go:208-236).  The automaton is compiled
    only when some row has a table regex; the reference compiles one for
    every model, but a row without one never reads it."""
    device = resolve_device(device)
    if policy is None:
        return ConstVerdict(False)
    side = policy.ingress if ingress else policy.egress
    rows = []
    for key in (port, 0):
        rules = side.by_port.get(key)
        if rules is None:
            continue
        if not rules.have_l7_rules or not rules.rules:
            return ConstVerdict(True)
        rows.extend(_collect_rows(rules))
    if not rows:
        return ConstVerdict(False)

    packed_ids, any_remote = pack_remote_sets([r[0] for r in rows])
    n = len(rows)
    action_needle = np.zeros((n, MAX_ACTION), np.uint8)
    action_len = np.zeros((n,), np.int32)
    action_any = np.zeros((n,), bool)
    table_none = np.zeros((n,), bool)
    for i, (_, action, table) in enumerate(rows):
        b = action.encode()
        action_needle[i, : len(b)] = np.frombuffer(b, np.uint8)
        action_len[i] = len(b)
        action_any[i] = len(b) == 0
        table_none[i] = table == ""

    def up(a):
        return torch.from_numpy(a).to(device)

    return CassandraBatchModel(
        nfa=(compile_automaton([r[2] for r in rows], device)
             if not table_none.all() else None),
        action_needle=up(action_needle),
        action_len=up(action_len),
        action_any=up(action_any),
        table_none=up(table_none),
        remote_ids=up(packed_ids),
        any_remote=up(any_remote),
    )


def encode_cassandra_batch(requests, f_pad: int | None = None):
    """Host-side batch packing: [(action, table, non_query)] ->
    (data [F, MAX_ACTION+MAX_TABLE], action_len, table_len, non_query,
    overflow).  ``overflow[i]`` marks requests whose tokens exceed the
    fixed widths — callers must fall back to the host oracle for those
    (fail closed, same pattern as the Kafka topic overflow)."""
    n = len(requests)
    f = f_pad or n
    data = np.zeros((f, MAX_ACTION + MAX_TABLE), np.uint8)
    action_len = np.zeros((f,), np.int32)
    table_len = np.zeros((f,), np.int32)
    non_query = np.zeros((f,), bool)
    overflow = np.zeros((n,), bool)
    for i, (action, table, nq) in enumerate(requests):
        ab = action.encode("utf-8", "surrogateescape")
        tb = table.encode("utf-8", "surrogateescape")
        if len(ab) > MAX_ACTION or len(tb) > MAX_TABLE:
            overflow[i] = True
            continue
        data[i, : len(ab)] = np.frombuffer(ab, np.uint8)
        data[i, MAX_ACTION : MAX_ACTION + len(tb)] = np.frombuffer(tb, np.uint8)
        action_len[i] = len(ab)
        table_len[i] = len(tb)
        non_query[i] = nq
    return data, action_len, table_len, non_query, overflow


# --- kernel K10: the ACL ----------------------------------------------------


def cassandra_rule_hits_plain(model: CassandraBatchModel, data, action_len,
                              table_len, non_query, rx, remotes) -> torch.Tensor:
    """[F, R] bool: rule row r allows request f
    (``cilium_tpu/models/cassandra.py:160-185`` after the automaton)."""
    zeros = torch.zeros_like(action_len)
    action_ok = (
        spans_equal_prefix(
            data, zeros, action_len, model.action_needle, model.action_len
        )
        | model.action_any[None, :]
    )  # [F, R]
    table_ok = model.table_none[None, :] | (table_len == 0)[:, None]
    if rx is not None:
        table_ok = table_ok | rx
    rem = remote_ok(remotes, model.remote_ids, model.any_remote)
    l7_ok = non_query[:, None] | (action_ok & table_ok)
    return rem & l7_ok


def cassandra_hits_plain(model: CassandraBatchModel, data, action_len,
                         table_len, non_query, rx, remotes) -> torch.Tensor:
    """Plain PyTorch version of K10: allow [F] bool."""
    return cassandra_rule_hits_plain(
        model, data, action_len, table_len, non_query, rx, remotes
    ).any(dim=1)


def cassandra_hits(model: CassandraBatchModel, data, action_len, table_len,
                   non_query, rx, remotes) -> torch.Tensor:
    """K10: allow [F] bool — some rule row's remote set holds and the
    request is not a query, or its action and table both pass.  ``rx``
    ([F, R] bool) is the table automaton's hits on
    [MAX_ACTION, MAX_ACTION + table_len), None when the model has none."""
    device = model.device
    kernels.check(data, "data", torch.uint8, (None, MAX_ACTION + MAX_TABLE), device)
    f = data.shape[0]
    r = model.n_rules
    kernels.check(action_len, "action_len", torch.int32, (f,), device)
    kernels.check(table_len, "table_len", torch.int32, (f,), device)
    kernels.check(non_query, "non_query", torch.bool, (f,), device)
    if (rx is None) != (model.nfa is None):
        raise ValueError("rx: expected the automaton's hits exactly when the model has one")
    if rx is not None:
        kernels.check(rx, "rx", torch.bool, (f, r), device)
    kernels.check(remotes, "remotes", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return cassandra_hits_plain(
            model, data, action_len, table_len, non_query, rx, remotes
        )
    allow = torch.empty((f,), dtype=torch.bool, device=device)
    if f:
        p = kernels.p
        _CASSANDRA_HITS.launch(
            device, p(data), p(action_len), p(table_len), p(non_query),
            ctypes.c_void_p(None) if rx is None else p(rx), p(remotes),
            p(model.action_needle), p(model.action_len), p(model.action_any),
            p(model.table_none), p(model.remote_ids), p(model.any_remote), f, r,
            p(allow),
        )
    return allow


def cassandra_verdicts(
    model: CassandraBatchModel,
    data,  # [F, MAX_ACTION + MAX_TABLE] uint8
    action_len,  # [F] int32
    table_len,  # [F] int32
    non_query,  # [F] bool
    remotes,  # [F] int32
) -> torch.Tensor:
    """allow [F] bool on the model's device; inputs may be numpy arrays
    or tensors."""
    device = model.device
    data = as_tensor(data, torch.uint8, device)
    action_len = as_tensor(action_len, torch.int32, device)
    table_len = as_tensor(table_len, torch.int32, device)
    non_query = as_tensor(non_query, torch.bool, device)
    remotes = as_tensor(remotes, torch.int32, device)
    rx = None
    if model.nfa is not None:
        table_start = torch.full_like(table_len, MAX_ACTION)
        rx = automaton_search_spans(
            model.nfa, data, table_start, table_start + table_len
        )  # [F, R]
    return cassandra_hits(
        model, data, action_len, table_len, non_query, rx, remotes
    )
