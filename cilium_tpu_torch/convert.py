"""Carry a JAX-built r2d2, HTTP, DNS, Cassandra, memcached or Kafka
model's tables over into the port.

``model_from_numpy`` takes the leaves of a ``cilium_tpu`` ``R2d2BatchModel``
as numpy arrays — ``cmd_needle``, ``cmd_len``, ``cmd_any``, ``remote_ids``,
``any_remote`` and either the ``DeviceDfa`` leaves (``cls_lo``, ``cls_hi``,
``delta_id``, ``start_1h``, ``accept_mask``, ``accept_final_mask``) or the
``DeviceNfa`` leaves (``delta_flat``, ``classmap``, ``start``, ``accept_t``,
``accept_final_t``) — and builds the port's model from them.  The port's DFA
keeps a 256-entry classmap and one start id per pattern where the reference
kept byte ranges and one-hot rows, so those are rebuilt here.  The leaves
carry no rule rows, so ``match_kinds`` and ``invariant_rows`` are the
caller's to pass; without rows the model makes no byte-invariance claim.

``http_model_from_numpy`` does the same for the 20 leaves of a
``cilium_tpu`` ``HttpBatchModel``, whose ``line_nfa`` and ``head_nfa`` are
each a ``DeviceDfa``'s leaves, a ``DeviceNfa``'s leaves or None.

``dns_model_from_numpy``, ``cassandra_model_from_numpy`` and
``memcache_model_from_numpy`` take the array leaves of a ``cilium_tpu``
``DnsBatchModel``, ``CassandraBatchModel`` or ``MemcacheBatchModel`` and
its ``nfa`` as a dict of automaton leaves.  The port compiles no
automaton for a model without pattern, table-regex or key-regex rows
(those rows never read it), so the ``nfa`` leaf is dropped there.
Converted DNS models make no byte-invariance claim
(``invariant_rows=None``), as converted r2d2 and HTTP models do not.

``kafka_model_from_numpy`` takes the twelve leaves of a ``cilium_tpu``
``KafkaBatchModel`` as numpy arrays, in pytree order.  ``dfa_from_leaves``
takes the leaves of any ``DeviceDfa``, those of ``device_dfa_absorbing``
(the sequence-folded search's tables) included.

``sharded_model_from_numpy`` and ``sharded_kafka_model_from_numpy`` take
the leaves of a ``cilium_tpu`` rule-sharded model (the stacked per-shard
model, every leaf with a leading [n_shards] dim) and build the port's
``ShardedVerdictModel`` / ``ShardedKafkaModel`` on a mesh of slots: the
leaves are unstacked into one port model per shard, each converted by the
family's ``*_from_numpy`` above, and the single-card fallback is converted
beside them.

``datapath_tables_from_numpy``, ``datapath_tables6_from_numpy`` and
``ingress_tables_from_numpy`` take the leaves of a ``cilium_tpu``
``DatapathTables``, ``DatapathTables6`` or ``IngressTables`` as numpy
arrays, in pytree order (``jax.tree_util.tree_leaves``), and build the
port's tables: the datapath's "weights carried across".
"""

from __future__ import annotations

import numpy as np
import torch

from .datapath.ingress import IngressTables
from .datapath.pipeline import DatapathTables
from .datapath.pipeline6 import DatapathTables6
from .device import resolve_device
from .maps.lbmap import DeviceLb6Map, DeviceLbMap
from .maps.policymap import DevicePolicyMap
from .models.cassandra import CassandraBatchModel
from .models.dns import DnsBatchModel
from .models.http import HttpBatchModel
from .models.kafka import KafkaBatchModel
from .models.memcached import KEY_MODE_REGEX, MemcacheBatchModel
from .models.r2d2 import R2d2BatchModel
from .ops.dfa import DeviceDfa, dfa_from_arrays
from .ops.lpm import lpm_from_arrays
from .ops.maplookup import table_from_arrays
from .ops.nfa import DeviceNfa, nfa_from_dense


def dfa_from_leaves(leaves: dict, device=None) -> DeviceDfa:
    lo = np.asarray(leaves["cls_lo"])
    hi = np.asarray(leaves["cls_hi"])
    c = lo.shape[0]
    classmap = np.full((256,), -1, np.int32)
    for cls in range(c):
        for a, b in zip(lo[cls], hi[cls]):
            if a <= b:  # padded runs have lo > hi
                classmap[a : b + 1] = cls
    if (classmap < 0).any():
        raise ValueError("cls_lo/cls_hi do not cover all 256 bytes")
    start_1h = np.asarray(leaves["start_1h"])
    if not (start_1h.sum(axis=1) == 1).all():
        raise ValueError("start_1h must hold one start state per pattern")
    return dfa_from_arrays(
        classmap,
        np.asarray(leaves["delta_id"]),
        start_1h.argmax(axis=1),
        np.asarray(leaves["accept_mask"]) != 0,
        np.asarray(leaves["accept_final_mask"]) != 0,
        device,
    )


def nfa_from_leaves(leaves: dict, device=None) -> DeviceNfa:
    delta_flat = np.asarray(leaves["delta_flat"])
    s = delta_flat.shape[0]
    c = delta_flat.shape[1] // s
    # [S, C*S] -> [S, C, S] -> [C, S, S]
    delta = delta_flat.reshape(s, c, s).transpose(1, 0, 2)
    return nfa_from_dense(
        np.asarray(leaves["classmap"]),
        delta,
        np.asarray(leaves["start"]) != 0,
        np.asarray(leaves["accept_t"]).T != 0,
        np.asarray(leaves["accept_final_t"]).T != 0,
        device,
    )


def model_from_numpy(
    leaves: dict, device=None, *, match_kinds: tuple = (), invariant_rows: tuple | None = None
) -> R2d2BatchModel:
    """The port's ``R2d2BatchModel`` on ``device`` (None: the CUDA card)
    from a JAX model's leaves, with the JAX model's ``match_kinds`` and
    ``invariant_rows`` where the caller has them."""
    device = resolve_device(device)
    automaton = automaton_from_leaves(leaves, device)

    def up(name, dtype):
        return torch.from_numpy(np.array(leaves[name], dtype)).to(device)

    return R2d2BatchModel(
        nfa=automaton,
        cmd_needle=up("cmd_needle", np.uint8),
        cmd_len=up("cmd_len", np.int32),
        cmd_any=up("cmd_any", bool),
        remote_ids=up("remote_ids", np.int32),
        any_remote=up("any_remote", bool),
        match_kinds=tuple(match_kinds),
        invariant_rows=None if invariant_rows is None else tuple(invariant_rows),
    )


# The array leaves of a JAX HttpBatchModel, in its pytree order
# (cilium_tpu/models/http.py:264-272), without the two automata.
HTTP_TABLES = {
    "m_needle": np.uint8, "m_len": np.int32, "m_prefix": bool,
    "m_rule": np.int32, "m_live": bool,
    "p_needle": np.uint8, "p_len": np.int32, "p_prefix": bool,
    "p_rule": np.int32, "p_live": bool,
    "method_any": bool, "path_any": bool,
    "line_rule": np.int32, "line_slot": np.int32,
    "head_rule": np.int32, "head_count": np.int32,
    "remote_ids": np.int32, "any_remote": bool,
}


def automaton_from_leaves(leaves: dict | None, device):
    """A ``DeviceDfa`` or ``DeviceNfa`` from the leaves of either, or None."""
    if leaves is None:
        return None
    if "delta_id" in leaves:
        return dfa_from_leaves(leaves, device)
    return nfa_from_leaves(leaves, device)


def http_model_from_numpy(
    leaves: dict, device=None, *, n_rules: int, has_method_rx: bool,
    has_path_rx: bool, match_kinds: tuple = (),
) -> HttpBatchModel:
    """The port's ``HttpBatchModel`` on ``device`` (None: the CUDA card)
    from a JAX model's leaves: the arrays named in ``HTTP_TABLES`` and
    ``line_nfa`` / ``head_nfa``, each a dict of automaton leaves or None.
    The JAX model's static fields come as arguments; without its rule
    rows the model makes no byte-invariance claim."""
    device = resolve_device(device)
    return HttpBatchModel(
        **_tables(leaves, HTTP_TABLES, device),
        line_nfa=automaton_from_leaves(leaves["line_nfa"], device),
        head_nfa=automaton_from_leaves(leaves["head_nfa"], device),
        n_rules=n_rules,
        has_method_rx=has_method_rx,
        has_path_rx=has_path_rx,
        match_kinds=tuple(match_kinds),
        invariant_rows=None,
    )


# The array leaves of the JAX DNS, Cassandra and memcached models, in
# pytree order (cilium_tpu/models/dns.py:82-87, cassandra.py:59-64,
# memcached.py:74-80), without the automaton.
DNS_TABLES = {
    "name_needle": np.uint8, "name_len": np.int32, "name_any": bool,
    "use_rx": bool, "remote_ids": np.int32, "any_remote": bool,
}
CASSANDRA_TABLES = {
    "action_needle": np.uint8, "action_len": np.int32, "action_any": bool,
    "table_none": bool, "remote_ids": np.int32, "any_remote": bool,
}
MEMCACHE_TABLES = {
    "op_tab": bool, "cmd_tab": bool, "empty_rule": bool,
    "key_mode": np.int32, "key_needle": np.uint8, "key_needle_len": np.int32,
    "remote_ids": np.int32, "any_remote": bool,
}


def _tables(leaves: dict, tables: dict, device) -> dict:
    return {
        name: torch.from_numpy(np.array(leaves[name], dtype)).to(device)
        for name, dtype in tables.items()
    }


def dns_model_from_numpy(leaves: dict, device=None, *, match_kinds: tuple = ()) -> DnsBatchModel:
    """The port's ``DnsBatchModel`` on ``device`` (None: the CUDA card)
    from a JAX model's leaves: the arrays named in ``DNS_TABLES`` and
    ``nfa``, a dict of automaton leaves."""
    device = resolve_device(device)
    has_rx = bool(np.asarray(leaves["use_rx"]).any())
    return DnsBatchModel(
        nfa=automaton_from_leaves(leaves["nfa"], device) if has_rx else None,
        **_tables(leaves, DNS_TABLES, device),
        match_kinds=tuple(match_kinds),
        invariant_rows=None,
    )


def cassandra_model_from_numpy(leaves: dict, device=None) -> CassandraBatchModel:
    """The port's ``CassandraBatchModel`` on ``device`` (None: the CUDA
    card) from a JAX model's leaves: the arrays named in
    ``CASSANDRA_TABLES`` and ``nfa``."""
    device = resolve_device(device)
    has_rx = not bool(np.asarray(leaves["table_none"]).all())
    return CassandraBatchModel(
        nfa=automaton_from_leaves(leaves["nfa"], device) if has_rx else None,
        **_tables(leaves, CASSANDRA_TABLES, device),
    )


def memcache_model_from_numpy(leaves: dict, device=None) -> MemcacheBatchModel:
    """The port's ``MemcacheBatchModel`` on ``device`` (None: the CUDA
    card) from a JAX model's leaves: the arrays named in
    ``MEMCACHE_TABLES`` and ``nfa``."""
    device = resolve_device(device)
    has_rx = bool((np.asarray(leaves["key_mode"]) == KEY_MODE_REGEX).any())
    return MemcacheBatchModel(
        nfa=automaton_from_leaves(leaves["nfa"], device) if has_rx else None,
        **_tables(leaves, MEMCACHE_TABLES, device),
    )


# The leaves of a JAX KafkaBatchModel, in its pytree order
# (cilium_tpu/models/kafka.py:58-66).
KAFKA_TABLES = {
    "api_key_mask": bool, "version": np.int32, "version_any": bool,
    "client": np.uint8, "client_len": np.int32, "client_any": bool,
    "topic": np.uint8, "topic_len": np.int32, "topic_any": bool,
    "is_topic_key": bool, "remote_ids": np.int32, "any_remote": bool,
}


def kafka_model_from_numpy(leaves, device=None) -> KafkaBatchModel:
    """The port's ``KafkaBatchModel`` on ``device`` (None: the CUDA card)
    from a JAX ``KafkaBatchModel``'s twelve leaves, in pytree order."""
    leaves = list(leaves)
    if len(leaves) != len(KAFKA_TABLES):
        raise ValueError(f"expected {len(KAFKA_TABLES)} leaves, got {len(leaves)}")
    return KafkaBatchModel(**_tables(dict(zip(KAFKA_TABLES, leaves)), KAFKA_TABLES,
                                     resolve_device(device)))


# --- rule-sharded models ------------------------------------------------------


def _unstack(leaves, j: int):
    """Shard ``j`` of stacked leaves: every array indexed on its leading
    shard dim, dicts walked, None kept."""
    if leaves is None:
        return None
    if isinstance(leaves, dict):
        return {k: _unstack(v, j) for k, v in leaves.items()}
    return np.asarray(leaves)[j]


def _family_model(family: str, leaves: dict, device, static: dict, match_kinds=()):
    if family == "r2d2":
        return model_from_numpy(leaves, device, match_kinds=match_kinds)
    if family == "dns":
        return dns_model_from_numpy(leaves, device, match_kinds=match_kinds)
    if family == "http":
        return http_model_from_numpy(leaves, device, match_kinds=match_kinds, **static)
    raise ValueError(f"unknown sharded family {family!r}")


def sharded_model_from_numpy(
    family: str, stacked_leaves: dict, offsets, mesh, *, fallback_leaves: dict,
    match_kinds: tuple = (), static: dict | None = None,
    fallback_static: dict | None = None,
):
    """The port's ``ShardedVerdictModel`` for ``family`` ("r2d2" | "dns"
    | "http") on ``mesh`` from a JAX ``ShardedVerdictModel``'s stacked
    leaves (the leaf dict the family's ``*_from_numpy`` takes, each array
    with a leading [n_shards] dim), its ``offsets`` and its fallback's
    leaves.  For HTTP, ``static`` and ``fallback_static`` carry the JAX
    models' ``n_rules``, ``has_method_rx`` and ``has_path_rx``.  The
    shards and the fallback are built on the mesh's first slot."""
    from .parallel.mesh import RULE_AXIS
    from .parallel.rulesharding import ShardedVerdictModel

    dev = mesh.devices[0, 0].device
    n_shards = mesh.shape[RULE_AXIS]
    stacked = [
        _family_model(family, _unstack(stacked_leaves, j), dev, static or {})
        for j in range(n_shards)
    ]
    fallback = _family_model(family, fallback_leaves, dev, fallback_static or {},
                             match_kinds)
    return ShardedVerdictModel(
        stacked, np.asarray(offsets, np.int32), mesh, family,
        fallback=fallback, match_kinds=tuple(match_kinds),
    )


def sharded_kafka_model_from_numpy(stacked_leaves, mesh, *, fallback_leaves):
    """The port's ``ShardedKafkaModel`` on ``mesh`` from a JAX
    ``ShardedKafkaModel``'s twelve stacked leaves (pytree order, each
    with a leading [n_shards] dim) and its fallback's twelve leaves."""
    from .parallel.mesh import RULE_AXIS
    from .parallel.rulesharding import ShardedKafkaModel

    dev = mesh.devices[0, 0].device
    leaves = [np.asarray(x) for x in stacked_leaves]
    stacked = [
        kafka_model_from_numpy([x[j] for x in leaves], dev)
        for j in range(mesh.shape[RULE_AXIS])
    ]
    return ShardedKafkaModel(
        stacked, mesh, fallback=kafka_model_from_numpy(fallback_leaves, dev)
    )


# --- the L3/L4 datapath's tables ----------------------------------------------


class _Leaves:
    """The leaves of a JAX table pytree, consumed in order (a
    ``DeviceTable`` is its key columns, values and valid; a ``DeviceLpm``
    its W words, W masks, plen, values and valid; a ``DeviceLbMap`` or
    ``DeviceLb6Map`` its seven arrays)."""

    def __init__(self, leaves, device):
        self._it = iter(leaves)
        self.device = device

    def take(self, n: int) -> list:
        return [np.array(next(self._it)) for _ in range(n)]

    def table(self, k: int):
        cols = self.take(k)
        values, valid = self.take(2)
        return table_from_arrays(cols, values, valid, self.device)

    def lpm(self, w: int):
        words, masks = self.take(w), self.take(w)
        plen, values, valid = self.take(3)
        return lpm_from_arrays(np.stack(words), np.stack(masks), plen, values, valid, self.device)

    def lb(self, cls):
        return cls.from_arrays(*self.take(7), self.device)

    def done(self) -> None:
        if next(self._it, None) is not None:
            raise ValueError("more leaves than the tables hold")


def datapath_tables_from_numpy(leaves, device=None) -> DatapathTables:
    """The port's v4 ``DatapathTables`` on ``device`` (None: the CUDA card)
    from a JAX ``DatapathTables``' 25 leaves: CT (5 columns), LB, ipcache
    LPM (1 word), policy (4 columns)."""
    it = _Leaves(leaves, resolve_device(device))
    out = DatapathTables(ct=it.table(5), lb=it.lb(DeviceLbMap), ipcache=it.lpm(1),
                         policy=DevicePolicyMap(table=it.table(4)))
    it.done()
    return out


def datapath_tables6_from_numpy(leaves, device=None) -> DatapathTables6:
    """The port's ``DatapathTables6`` from a JAX ``DatapathTables6``' 37
    leaves: CT (11 columns), LB6, ipcache LPM (4 words), policy."""
    it = _Leaves(leaves, resolve_device(device))
    out = DatapathTables6(ct=it.table(11), lb=it.lb(DeviceLb6Map), ipcache=it.lpm(4),
                          policy=DevicePolicyMap(table=it.table(4)))
    it.done()
    return out


def ingress_tables_from_numpy(leaves, device=None) -> IngressTables:
    """The port's ``IngressTables`` from a JAX ``IngressTables``' 26
    leaves: the identity and tunnel LPMs, the endpoint table (1 column),
    CT (5 columns), policy."""
    it = _Leaves(leaves, resolve_device(device))
    out = IngressTables(ipcache_id=it.lpm(1), ipcache_tun=it.lpm(1), lxc=it.table(1),
                        ct=it.table(5), policy=DevicePolicyMap(table=it.table(4)))
    it.done()
    return out
