"""Rule-axis model sharding: split a rule set across a mesh's slots.

Counterpart of ``cilium_tpu/parallel/rulesharding.py``.  A policy's
packed automaton tables and per-rule compare tensors grow with the rule
count, and past a point one card cannot hold them.  Rule-axis sharding
splits the RULES of one policy across the mesh's ``RULE_AXIS``:

  - every shard compiles ITS OWN rule subset into its own tables (an NFA
    over fewer patterns has fewer states, so its transition tables
    shrink quadratically);
  - shards are padded to a common (states, classes, patterns) shape, as
    the reference pads them to stack along a leading shard dim.  The
    port keeps the R per-shard models as a list (``stacked``) instead,
    and places shard j on the device of every slot of rule column j;
  - the step runs flow block i on every slot of flow row i, each slot
    its family's single-card path on its rule shard (K1 -> K3 -> K4 for
    r2d2, K5 -> K6 -> K3 -> K7 for HTTP, K8 -> K3 -> K9 for DNS, K17 with
    ``parts=True`` for Kafka).  Every slot's launches are issued before
    any reduction, so distinct cards overlap.  Row i's partial verdicts
    are copied to its first slot (no copy on a virtual mesh) and merged
    there by K21 ``shard_reduce`` (the reference's ``psum > 0`` and
    offset-biased ``pmin``) or K22 ``kafka_shard_combine`` (the Kafka
    OR-then-combine); the rows are concatenated on the mesh's first slot.

The OR-reduce is exact, not approximate: every model's verdict is
``any(rule allows)`` over disjoint rule subsets (for Kafka the ORable
partials are (simple, cover); the ∀-topics combine happens after the
reduce — see models/kafka.py kafka_rule_hits/kafka_combine).

On a CPU tensor K21 and K22 run their plain versions
(``shard_reduce_plain``, ``kafka_shard_combine_plain``); on a CUDA tensor
they launch ``csrc/shard_reduce.cu`` or raise.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from ..models.base import MAX_REMOTES, ConstVerdict, pack_remote_sets
from ..models.dns import (
    DnsBatchModel,
    build_dns_model_from_rows,
    collect_dns_policy_rows,
    dns_row_arrays,
    dns_verdicts,
    dns_verdicts_attr,
)
from ..models.http import (
    HttpBatchModel,
    analyze_rules,
    build_http_model,
    collect_http_rows,
    http_verdicts,
    http_verdicts_attr,
    lit_arrays,
)
from ..models.kafka import (
    KafkaBatchModel,
    KafkaRequestBatch,
    build_kafka_model,
    kafka_hits,
)
from ..models.r2d2 import (
    MAX_CMD,
    R2d2BatchModel,
    _rule_bucket,
    build_r2d2_model_from_rows,
    collect_policy_rows,
    r2d2_verdicts,
    r2d2_verdicts_attr,
)
from ..ops.nfa import DeviceNfa, device_nfa
from ..regex import compile_patterns
from ..regex.tables import NfaTables
from .mesh import FLOW_AXIS, RULE_AXIS, Mesh, flow_sharding, moved, replicated, to_slot

# Sentinel beating every real rule row in the cross-shard min-index
# reduction (rule counts are int32 row indices, far below this).
_NO_MATCH = int(np.iinfo(np.int32).max)

_SHARD_REDUCE = kernels.CudaKernel(
    "shard_reduce", "shard_reduce",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2,
)
_KAFKA_SHARD_COMBINE = kernels.CudaKernel(
    "shard_reduce", "kafka_shard_combine",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)
_KAFKA_SHARD_COMBINE_FORCED = kernels.CudaKernel(
    "shard_reduce", "kafka_shard_combine_forced",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int],
)
# K22's paths (csrc/shard_reduce.cu CombinePath); "pick" is the launcher's choice.
COMBINE_PATHS = {"pick": 0, "flow": 1, "general": 2}


def split_balanced(seq: list, k: int) -> list[list]:
    """Split seq into k contiguous, size-balanced chunks (first chunks
    one longer when len % k != 0).  Chunks may be empty when k > len."""
    n = len(seq)
    base, extra = divmod(n, k)
    out, i = [], 0
    for j in range(k):
        step = base + (1 if j < extra else 0)
        out.append(seq[i : i + step])
        i += step
    return out


def shard_offsets(n_rows: int, n_shards: int) -> torch.Tensor:
    """[n_shards] int32 (on the CPU) global row index of each shard's
    FIRST rule row under split_balanced — the per-shard bias that turns
    a shard-local first-match argmax into a global row id (attribution
    contract: global index == the unsharded model's flattened row order
    == the host oracle's walk order)."""
    sizes = np.asarray(
        [len(s) for s in split_balanced(list(range(n_rows)), n_shards)],
        np.int32,
    )
    return torch.from_numpy(
        np.concatenate(([0], np.cumsum(sizes)))[:-1].astype(np.int32)
    )


# --- K21 / K22: the cross-shard merges ---------------------------------------


def shard_reduce_plain(allow_parts, rule_parts=None, offsets=None):
    """Plain PyTorch version of K21: allow [F] = OR over shards; with
    ``rule_parts`` [R, F] and ``offsets`` [R] also rule [F] = the least
    offset-biased shard row where allowed (INT32_MAX where allowed with
    no shard row), -1 elsewhere — the reference's
    ``psum(allow) > 0`` and ``where(allow, pmin(cand), -1)``."""
    allow = allow_parts.to(torch.int32).sum(dim=0) > 0
    if rule_parts is None:
        return allow
    cand = torch.where(
        rule_parts >= 0, rule_parts + offsets[:, None],
        torch.full_like(rule_parts, _NO_MATCH),
    )
    cand = cand.amin(dim=0)
    return allow, torch.where(allow, cand, torch.full_like(cand, -1))


def shard_reduce(allow_parts, rule_parts=None, offsets=None):
    """K21: the merge of row i's R partial verdicts.  ``allow_parts``
    [R, F] bool; the attributed form also takes ``rule_parts`` [R, F]
    int32 and ``offsets`` [R] int32 and returns (allow, rule)."""
    device = allow_parts.device
    kernels.check(allow_parts, "allow_parts", torch.bool, (None, None), device)
    r, f = allow_parts.shape
    if r < 1:
        raise ValueError("allow_parts: expected at least one shard")
    attr = rule_parts is not None
    if attr:
        kernels.check(rule_parts, "rule_parts", torch.int32, (r, f), device)
        kernels.check(offsets, "offsets", torch.int32, (r,), device)
    if kernels.on_cpu(device):
        return shard_reduce_plain(allow_parts, rule_parts, offsets)
    allow = torch.empty((f,), dtype=torch.bool, device=device)
    rule = torch.empty((f,), dtype=torch.int32, device=device) if attr else None
    p = kernels.p
    null = ctypes.c_void_p(None)
    _SHARD_REDUCE.launch(
        device, p(allow_parts), p(rule_parts) if attr else null,
        p(offsets) if attr else null, r, f, p(allow),
        p(rule) if attr else null,
    )
    return (allow, rule) if attr else allow


def kafka_shard_combine_plain(simple_parts, cover_parts, topic_count, overflow):
    """Plain PyTorch version of K22: the reference's psum of the (simple,
    cover) partials over shards, then ``kafka_combine``."""
    simple = simple_parts.to(torch.int32).sum(dim=0) > 0
    cover = cover_parts.to(torch.int32).sum(dim=0) > 0
    t_idx = torch.arange(cover.shape[1], device=cover.device)[None, :]
    active = t_idx < topic_count[:, None]
    all_covered = (cover | ~active).all(dim=1) & (topic_count > 0)
    return (simple | all_covered) & ~overflow


def combine_variant(cover_parts) -> str:
    """The path K22's launcher takes for ``cover_parts`` [R, F, T]:
    ``csrc/shard_reduce.cu`` ``combine_pick``, "flow" where T = 8 and the
    tensor is 8-byte aligned, else "general".  Only the paths this returns
    and "general" may be forced on these inputs."""
    return "flow" if cover_parts.shape[2] == 8 and cover_parts.data_ptr() % 8 == 0 else "general"


def kafka_shard_combine(simple_parts, cover_parts, topic_count, overflow, path: str | None = None):
    """K22: allow [F] from R shards' ``simple_parts`` [R, F] and
    ``cover_parts`` [R, F, T] bool, with the batch's ``topic_count`` [F]
    int32 and ``overflow`` [F] bool.  ``path`` (a key of COMBINE_PATHS)
    forces the launcher's path (``kafka_shard_combine_forced``; "flow"
    where the inputs do not allow it raises); by default it picks (``combine_variant``)."""
    device = simple_parts.device
    kernels.check(simple_parts, "simple_parts", torch.bool, (None, None), device)
    r, f = simple_parts.shape
    if r < 1:
        raise ValueError("simple_parts: expected at least one shard")
    kernels.check(cover_parts, "cover_parts", torch.bool, (r, f, None), device)
    kernels.check(topic_count, "topic_count", torch.int32, (f,), device)
    kernels.check(overflow, "overflow", torch.bool, (f,), device)
    if path is not None and path not in COMBINE_PATHS:
        raise ValueError(f"path: expected one of {sorted(COMBINE_PATHS)}, got {path!r}")
    if kernels.on_cpu(device):
        return kafka_shard_combine_plain(simple_parts, cover_parts, topic_count, overflow)
    allow = torch.empty((f,), dtype=torch.bool, device=device)
    p = kernels.p
    args = (p(simple_parts), p(cover_parts), p(topic_count), p(overflow), r, f,
            cover_parts.shape[2], p(allow))
    if path is None:
        _KAFKA_SHARD_COMBINE.launch(device, *args)
    else:
        _KAFKA_SHARD_COMBINE_FORCED.launch(device, *args, COMBINE_PATHS[path])
    return allow


# --- table padding --------------------------------------------------------


def pad_tables(t: NfaTables, s: int, c: int, r: int) -> NfaTables:
    """Pad an NfaTables to (s states, c classes, r patterns).  Padding
    states have no transitions and are never set; padding classes are
    never produced by classmap; padding patterns never accept."""
    if s < t.n_states or c < t.n_classes or r < t.n_patterns:
        raise ValueError("pad_tables: target shape below the tables' own")
    delta = np.zeros((c, s, s), np.uint8)
    delta[: t.n_classes, : t.n_states, : t.n_states] = t.delta
    start = np.zeros((s,), bool)
    start[: t.n_states] = t.start
    accept = np.zeros((r, s), bool)
    accept[: t.n_patterns, : t.n_states] = t.accept
    accept_final = np.zeros((r, s), bool)
    accept_final[: t.n_patterns, : t.n_states] = t.accept_final
    matches_empty = np.zeros((r,), bool)
    matches_empty[: t.n_patterns] = t.matches_empty
    return NfaTables(
        n_states=s,
        n_classes=c,
        n_patterns=r,
        classmap=t.classmap,
        delta=delta,
        start=start,
        accept=accept,
        accept_final=accept_final,
        matches_empty=matches_empty,
        patterns=list(t.patterns),
    )


def _never_match_tables(n_patterns: int) -> NfaTables:
    """Tables with n_patterns patterns that accept nothing (used to give
    head-pattern-less shards a uniformly shaped head NFA)."""
    t = compile_patterns(["x"])
    t.accept[:] = False
    t.accept_final[:] = False
    t.matches_empty[:] = False
    return pad_tables(t, t.n_states, t.n_classes, max(n_patterns, 1))


def stack_nfas(tables: list[NfaTables], device=None) -> list[DeviceNfa]:
    """Pad a list of per-shard tables to a common shape and upload each
    to ``device`` (None: the card): the reference stacks these along a
    leading shard axis, the port keeps them as a list."""
    device = resolve_device(device)
    s = max(t.n_states for t in tables)
    c = max(t.n_classes for t in tables)
    r = max(t.n_patterns for t in tables)
    return [device_nfa(pad_tables(t, s, c, r), device) for t in tables]


def _up(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# --- r2d2 -----------------------------------------------------------------


def build_sharded_r2d2_model(
    policy, ingress: bool, port: int, n_shards: int, bucket: bool = False,
    device=None,
) -> ConstVerdict | list[R2d2BatchModel]:
    """Compile the policy's rows into ``n_shards`` shard models on
    ``device`` (None: the card).  Aux dims (states/classes/patterns) are
    padded to the max across shards, as the reference pads them to stack.
    Padded rule rows are dead via never-accepting NFA pattern rows
    (file_ok is always False for them, independent of input bytes).
    ``bucket=True`` pads the per-shard rule axis to the power-of-two
    bucket (models/r2d2.MIN_RULE_BUCKET)."""
    device = resolve_device(device)
    rows = collect_policy_rows(policy, ingress, port)
    if isinstance(rows, ConstVerdict):
        return rows
    return build_sharded_r2d2_from_rows(rows, n_shards, bucket=bucket, device=device)


def build_sharded_r2d2_from_rows(
    rows: list, n_shards: int, bucket: bool = False, device=None,
) -> list[R2d2BatchModel]:
    """Rows-based half of build_sharded_r2d2_model (exposed for giant
    synthetic tables, where a full proxylib policy compile of the same
    rows would dominate)."""
    device = resolve_device(device)
    shards = split_balanced(rows, n_shards)
    r_max = max(len(s) for s in shards)
    if bucket:
        r_max = _rule_bucket(r_max)
    shard_tables = [
        compile_patterns([r[2] for r in s]) if s else _never_match_tables(1)
        for s in shards
    ]
    s_max = max(t.n_states for t in shard_tables)
    c_max = max(t.n_classes for t in shard_tables)
    models = []
    for s, t in zip(shards, shard_tables):
        packed = np.zeros((r_max, MAX_REMOTES), np.int32)
        any_remote = np.zeros((r_max,), bool)
        cmd_needle = np.zeros((r_max, MAX_CMD), np.uint8)
        cmd_len = np.zeros((r_max,), np.int32)
        cmd_any = np.zeros((r_max,), bool)
        if s:
            ids, anyr = pack_remote_sets([r[0] for r in s])
            packed[: len(s)] = ids
            any_remote[: len(s)] = anyr
            for i, (_, cmd, _f) in enumerate(s):
                b = cmd.encode()
                cmd_needle[i, : len(b)] = np.frombuffer(b, np.uint8)
                cmd_len[i] = len(b)
                cmd_any[i] = len(b) == 0
        models.append(
            R2d2BatchModel(
                nfa=device_nfa(pad_tables(t, s_max, c_max, r_max), device),
                cmd_needle=_up(cmd_needle, device),
                cmd_len=_up(cmd_len, device),
                cmd_any=_up(cmd_any, device),
                remote_ids=_up(packed, device),
                any_remote=_up(any_remote, device),
            )
        )
    return models


# --- dns ------------------------------------------------------------------


def build_sharded_dns_from_rows(
    rows: list, n_shards: int, bucket: bool = False, device=None,
) -> list[DnsBatchModel]:
    """Shard (remote_set, DnsRule|None) rows across n_shards models.  Aux
    dims unify across shards (needle width, NFA states/classes/patterns);
    padding rows are dead (needle_len -1, never-accepting automaton
    slots, remote set {-1}) exactly like the single-card padding."""
    device = resolve_device(device)
    shards = split_balanced(list(rows), n_shards)
    r_max = max(len(s) for s in shards)
    if bucket:
        r_max = _rule_bucket(r_max)
    # One needle width across shards, as the reference's stacked leaves.
    width = max(
        (len(r.name.encode("latin-1", "replace"))
         for s in shards for _, r in s
         if r is not None and r.name),
        default=0,
    )
    width = max(8, (width + 7) // 8 * 8)
    per_shard = [dns_row_arrays(s, r_max, width=width) for s in shards]
    tables = [
        compile_patterns(arr[6]) if any(arr[6]) else
        _never_match_tables(max(len(arr[6]), 1))
        for arr in per_shard
    ]
    s_max = max(t.n_states for t in tables)
    c_max = max(t.n_classes for t in tables)
    p_max = max(t.n_patterns for t in tables)
    models = []
    for arr, t in zip(per_shard, tables):
        needle, n_len, n_any, use_rx, packed, any_remote, _pats = arr
        models.append(
            DnsBatchModel(
                nfa=device_nfa(pad_tables(t, s_max, c_max, p_max), device),
                name_needle=_up(needle, device),
                name_len=_up(n_len, device),
                name_any=_up(n_any, device),
                use_rx=_up(use_rx, device),
                remote_ids=_up(packed, device),
                any_remote=_up(any_remote, device),
            )
        )
    return models


# --- http -----------------------------------------------------------------


def build_sharded_http_model(
    rules_with_remotes: list, n_shards: int, device=None,
) -> ConstVerdict | list[HttpBatchModel]:
    """Shard (remote_set, PortRuleHTTP) rows across n_shards models.  Every
    tier pads to cross-shard maxima: literal rows via the live mask,
    regex/head patterns via never-accepting table rows, rule dims via
    dead rules (no wildcard flag + no rows = method_ok False)."""
    device = resolve_device(device)
    if not rules_with_remotes:
        return ConstVerdict(False)
    shards = split_balanced(list(rules_with_remotes), n_shards)
    r_max = max(len(s) for s in shards)
    analyzed = [analyze_rules(s) for s in shards]

    def line_tab(patterns):
        return (
            compile_patterns(patterns) if patterns else _never_match_tables(1)
        )

    line_ts = [line_tab(a[2]) for a in analyzed]
    any_head = any(a[7] for a in analyzed)
    head_ts = [line_tab(a[7]) if any_head else None for a in analyzed]

    nm = max(max(len(a[0]) for a in analyzed), 1)
    npath = max(max(len(a[1]) for a in analyzed), 1)
    # Needle widths unified across shards, as the reference's stacked
    # leaves share shapes.
    lit_w = max(
        (
            len(lit)
            for a in analyzed
            for rows in (a[0], a[1])
            for lit, _, _ in rows
        ),
        default=0,
    )
    lit_w = max(8, (lit_w + 7) // 8 * 8)
    # Slot-usage flags must agree across shards (a[4] is each shard's
    # line_slot list).
    has_m_rx = any(s == 0 for a in analyzed for s in a[4])
    has_p_rx = any(s == 1 for a in analyzed for s in a[4])
    pl_max = max(t.n_patterns for t in line_ts)
    ls = max(t.n_states for t in line_ts)
    lc = max(t.n_classes for t in line_ts)
    if any_head:
        p_max = max(t.n_patterns for t in head_ts)
        hs = max(t.n_states for t in head_ts)
        hc = max(t.n_classes for t in head_ts)

    models = []
    for shard, a, lt, ht in zip(shards, analyzed, line_ts, head_ts):
        (m_rows, p_rows, _line_pats, line_rule, line_slot, method_any,
         path_any, _head_pats, head_rule, head_count) = a
        n = len(shard)
        mn, ml, mp, mr, mlive = lit_arrays(m_rows, nm, width=lit_w)
        pn, pl_, pp, pr, plive = lit_arrays(p_rows, npath, width=lit_w)
        packed_ids = np.zeros((r_max, MAX_REMOTES), np.int32)
        any_remote = np.zeros((r_max,), bool)
        ma = np.zeros((r_max,), bool)
        pa = np.zeros((r_max,), bool)
        hcnt = np.zeros((r_max,), np.int32)
        if n:
            ids, anyr = pack_remote_sets([rs for rs, _ in shard])
            packed_ids[:n] = ids
            any_remote[:n] = anyr
            ma[:n] = method_any
            pa[:n] = path_any
            hcnt[:n] = np.asarray(head_count, np.int32)
        lr = np.zeros((pl_max,), np.int32)
        lsl = np.zeros((pl_max,), np.int32)
        lr[: len(line_rule)] = np.asarray(line_rule, np.int32)
        lsl[: len(line_slot)] = np.asarray(line_slot, np.int32)
        hr = np.zeros((max(p_max, 1) if any_head else 1,), np.int32)
        if any_head:
            hr[: len(head_rule)] = np.asarray(head_rule, np.int32)
        models.append(
            HttpBatchModel(
                m_needle=_up(mn, device),
                m_len=_up(ml, device),
                m_prefix=_up(mp, device),
                m_rule=_up(mr, device),
                m_live=_up(mlive, device),
                p_needle=_up(pn, device),
                p_len=_up(pl_, device),
                p_prefix=_up(pp, device),
                p_rule=_up(pr, device),
                p_live=_up(plive, device),
                method_any=_up(ma, device),
                path_any=_up(pa, device),
                line_nfa=device_nfa(pad_tables(lt, ls, lc, pl_max), device),
                line_rule=_up(lr, device),
                line_slot=_up(lsl, device),
                head_nfa=(
                    device_nfa(pad_tables(ht, hs, hc, p_max), device)
                    if any_head
                    else None
                ),
                head_rule=_up(hr, device),
                head_count=_up(hcnt, device),
                remote_ids=_up(packed_ids, device),
                any_remote=_up(any_remote, device),
                n_rules=r_max,
                has_method_rx=has_m_rx,
                has_path_rx=has_p_rx,
            )
        )
    return models


# --- kafka ----------------------------------------------------------------


def _pad_kafka_model(m: KafkaBatchModel, r: int) -> KafkaBatchModel:
    """Pad rule rows to r with dead rules (api_key_mask all-False fails
    key_ok; any_remote False with no ids fails remote_ok)."""
    cur = m.version.shape[0]
    if cur == r:
        return m

    def pad(x):
        return torch.cat([x, x.new_zeros((r - cur, *x.shape[1:]))])

    return KafkaBatchModel(
        api_key_mask=pad(m.api_key_mask),
        version=pad(m.version),
        version_any=pad(m.version_any),
        client=pad(m.client),
        client_len=pad(m.client_len),
        client_any=pad(m.client_any),
        topic=pad(m.topic),
        topic_len=pad(m.topic_len),
        topic_any=pad(m.topic_any),
        is_topic_key=m.is_topic_key,
        remote_ids=pad(m.remote_ids),
        any_remote=pad(m.any_remote),
    )


def build_sharded_kafka_model(
    rules_with_remotes: list, n_shards: int, device=None,
) -> ConstVerdict | list[KafkaBatchModel]:
    device = resolve_device(device)
    if not rules_with_remotes:
        return ConstVerdict(False)
    shards = split_balanced(list(rules_with_remotes), n_shards)
    r_max = max(len(s) for s in shards)
    models = []
    for s in shards:
        if s:
            m = build_kafka_model(s, device)
        else:
            m = build_kafka_model(rules_with_remotes[:1], device)
            m = KafkaBatchModel(**{
                f.name: torch.zeros_like(getattr(m, f.name))
                for f in dataclasses.fields(m)
            })
        models.append(_pad_kafka_model(m, r_max))
    return models


# --- slots --------------------------------------------------------------------


def _place(stacked: list, mesh: Mesh) -> list[list]:
    """slots[i][j]: rule shard j resident on slot (i, j)'s device — one
    copy per (shard, distinct device), the shard itself where it was
    built on that device."""
    n_flow, n_rule = mesh.shape[FLOW_AXIS], mesh.shape[RULE_AXIS]
    if len(stacked) != n_rule:
        raise ValueError(
            f"{len(stacked)} rule shards for a mesh of {n_rule} rule slots"
        )
    copies: dict = {}
    slots = []
    for i in range(n_flow):
        row = []
        for j in range(n_rule):
            dev = mesh.devices[i, j].device
            key = (j, dev)
            if key not in copies:
                m = stacked[j]
                copies[key] = moved(m, dev)
            row.append(copies[key])
        slots.append(row)
    return slots


def _device_ctx(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _pad_flow_axis(n: int, n_flow: int, *arrays):
    """Pad leading (flow) axes up to a multiple of the mesh's flow
    extent with zero rows.  The service's power-of-two buckets always
    divide, so this is a no-op on the dispatch path; ad-hoc callers
    (probes, tests) pay one pad (outputs are sliced back)."""
    pad = (-n) % n_flow
    if not pad:
        return 0, arrays

    def grow(x):
        if isinstance(x, KafkaRequestBatch):
            return KafkaRequestBatch(**{
                f.name: grow(getattr(x, f.name)) for f in dataclasses.fields(x)
            })
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])

    return pad, tuple(grow(a) for a in arrays)


def _spans_cards(mesh: Mesh) -> bool:
    return len({d.device for d in mesh.devices.flat}) > 1


# --- mesh-resident serving models -----------------------------------------
#
# Drop-in replacements for the single-card batch models on the live
# dispatch path: same (data, lengths, remotes) -> (complete, msg_len,
# allow[, rule]) contract, tables resident across the mesh's slots.

_FAMILY_FNS = {
    "r2d2": (r2d2_verdicts, r2d2_verdicts_attr),
    "http": (http_verdicts, http_verdicts_attr),
    "dns": (dns_verdicts, dns_verdicts_attr),
}


def _sharded_step(model: "ShardedVerdictModel", data, lengths, remotes, attr: bool):
    """The sharded verdict step (module docstring); the reference's
    ``sharded_verdict_step`` / ``sharded_verdict_step_attr``."""
    mesh = model.mesh
    n_flow, n_rule = mesh.shape[FLOW_AXIS], mesh.shape[RULE_AXIS]
    first = mesh.devices[0, 0].device
    ins = [
        to_slot(x, first) if isinstance(x, torch.Tensor) else as_tensor(x, dtype, first)
        for x, dtype in ((data, torch.uint8), (lengths, torch.int32),
                         (remotes, torch.int32))
    ]
    n = ins[0].shape[0]
    pad, ins = _pad_flow_axis(n, n_flow, *ins)
    blocks = [flow_sharding(mesh, x) for x in ins]
    fn = _FAMILY_FNS[model.family][1 if attr else 0]
    # Every slot's launches first, so distinct cards overlap.
    parts = []
    for i in range(n_flow):
        row = []
        for j in range(n_rule):
            dev = mesh.devices[i, j].device
            blk = [to_slot(b[i], dev) for b in blocks]
            with _device_ctx(dev):
                row.append(fn(model.slots[i][j], *blk))
        parts.append(row)
    outs = []
    for i in range(n_flow):
        lead = mesh.devices[i, 0].device
        row = [[to_slot(t, lead) for t in out] for out in parts[i]]
        complete, msg_len = row[0][0], row[0][1]
        with _device_ctx(lead):
            allow_parts = torch.stack([out[2] for out in row])
            if attr:
                rule_parts = torch.stack([out[3] for out in row])
                allow, rule = shard_reduce(
                    allow_parts, rule_parts, model.offsets_on(lead)
                )
                outs.append((complete, msg_len, allow, rule))
            else:
                outs.append((complete, msg_len, shard_reduce(allow_parts)))
    if n_flow == 1:
        out = outs[0]
    else:
        out = tuple(
            torch.cat([to_slot(o[k], first) for o in outs])
            for k in range(len(outs[0]))
        )
    return tuple(o[:n] for o in out) if pad else out


class ShardedVerdictModel:
    """A (flows, rules)-mesh-resident verdict model.

    ``stacked`` is the list of per-shard models (the reference's stacked
    pytree, one entry per rule shard); ``offsets`` the per-shard global
    row offsets the attributed step biases local argmaxes with.
    ``fallback`` is the SINGLE-CARD model compiled from the same rows —
    the degradation rung the service demotes to when a mesh slot is lost
    (typed + counted; verdicts are bit-identical by the sharding parity
    contract).  ``fallback`` and ``match_kinds`` are host-side metadata
    the step never reads."""

    def __init__(self, stacked, offsets, mesh: Mesh, family: str,
                 fallback=None, match_kinds: tuple = ()):
        if family not in _FAMILY_FNS:
            raise ValueError(f"unknown sharded family {family!r}")
        self.stacked = list(stacked)
        if not isinstance(offsets, torch.Tensor):
            offsets = torch.from_numpy(np.array(offsets, np.int32))
        self.offsets = offsets.to(dtype=torch.int32, device="cpu")
        self.mesh = mesh
        self.family = family
        self.fallback = fallback
        self.match_kinds = match_kinds
        self.slots = _place(self.stacked, mesh)
        self._offsets = replicated(mesh, self.offsets)

    @property
    def n_shards(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def device(self) -> torch.device:
        """Where the step takes its inputs and leaves its outputs: the
        mesh's first slot."""
        return self.mesh.devices[0, 0].device

    @property
    def spans_cards(self) -> bool:
        """True when the slots lie on more than one device: one CUDA graph
        cannot span cards, so the service dispatches such a model eagerly."""
        return _spans_cards(self.mesh)

    @property
    def remote_ids(self) -> torch.Tensor:
        """[n_shards, R, MAX_REMOTES] per-shard remote tables on the CPU
        (epoch parity probes ravel these to draw candidate identities)."""
        return torch.stack([m.remote_ids.cpu() for m in self.stacked])

    def offsets_on(self, device: torch.device) -> torch.Tensor:
        return self._offsets[device]

    def dispatch_bare(self) -> "ShardedVerdictModel":
        """Table-shape signature marker (see R2d2BatchModel): the
        per-shard models' tensors, in shard order, are its shape key."""
        return self

    def __call__(self, data, lengths, remotes):
        return _sharded_step(self, data, lengths, remotes, attr=False)

    def verdicts_attr(self, data, lengths, remotes):
        return _sharded_step(self, data, lengths, remotes, attr=True)


class ShardedKafkaModel:
    """Mesh twin of KafkaBatchModel's (batch, remotes) -> allow
    contract: each slot's K17 yields its (simple, cover) partials, and K22
    merges them and runs the ∀-topics combine on the merged partials."""

    def __init__(self, stacked, mesh: Mesh, fallback=None):
        self.stacked = list(stacked)
        self.mesh = mesh
        self.fallback = fallback
        self.slots = _place(self.stacked, mesh)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0, 0].device

    @property
    def spans_cards(self) -> bool:
        return _spans_cards(self.mesh)

    def __call__(self, batch: KafkaRequestBatch, remotes):
        mesh = self.mesh
        n_flow, n_rule = mesh.shape[FLOW_AXIS], mesh.shape[RULE_AXIS]
        first = self.device
        batch = batch.to_device(first)
        remotes = as_tensor(remotes, torch.int32, first)
        n = remotes.shape[0]
        pad, (batch, remotes) = _pad_flow_axis(n, n_flow, batch, remotes)
        names = [f.name for f in dataclasses.fields(batch)]
        blocks = {k: flow_sharding(mesh, getattr(batch, k)) for k in names}
        rem_blocks = flow_sharding(mesh, remotes)

        def block(i, dev):
            b = KafkaRequestBatch(**{k: to_slot(blocks[k][i], dev) for k in names})
            return b, to_slot(rem_blocks[i], dev)

        parts = []
        for i in range(n_flow):
            row = []
            for j in range(n_rule):
                dev = mesh.devices[i, j].device
                b, r = block(i, dev)
                with _device_ctx(dev):
                    _, simple, cover = kafka_hits(self.slots[i][j], b, r, parts=True)
                row.append((simple, cover))
            parts.append(row)
        outs = []
        for i in range(n_flow):
            lead = mesh.devices[i, 0].device
            b, _ = block(i, lead)
            with _device_ctx(lead):
                simple = torch.stack([to_slot(s, lead) for s, _ in parts[i]])
                cover = torch.stack([to_slot(c, lead) for _, c in parts[i]])
                outs.append(kafka_shard_combine(simple, cover, b.topic_count, b.overflow))
        allow = outs[0] if n_flow == 1 else torch.cat([to_slot(o, first) for o in outs])
        return allow[:n] if pad else allow


# --- mesh-aware model builds (the live serving path's entry) --------------


def mesh_r2d2_model(policy, ingress: bool, port: int, mesh: Mesh):
    """Mesh-resident r2d2 model for the live serving path: rule rows
    split-balanced and padded across the mesh's RULE_AXIS (bucketed),
    plus the single-card fallback the service demotes to on slot loss
    (on the mesh's first slot).  Constant-verdict rule sets fold exactly
    as in the unsharded build.  ``match_kinds`` comes from the fallback
    compile so the attribution legend is identical on both rungs."""
    rows = collect_policy_rows(policy, ingress, port)
    if isinstance(rows, ConstVerdict):
        return rows
    return mesh_model_from_family_rows("r2d2", rows, mesh)


def mesh_dns_model(policy, ingress: bool, port: int, mesh: Mesh):
    """Mesh-resident DNS name-policy model for the live serving path —
    the sharded twin of models/dns.build_dns_model: same port cascade,
    same flattened row order, single-card fallback compiled alongside,
    ``match_kinds`` from the fallback."""
    rows = collect_dns_policy_rows(policy, ingress, port)
    if isinstance(rows, ConstVerdict):
        return rows
    return mesh_model_from_family_rows("dns", rows, mesh)


def mesh_http_model_from_rows(rows: list, mesh: Mesh):
    """THE one assembly of a mesh-resident HTTP model from flattened
    (remote_set, PortRuleHTTP) rows."""
    return mesh_model_from_family_rows("http", rows, mesh)


def mesh_http_model(policy, ingress: bool, port: int, mesh: Mesh):
    """Mesh-resident HTTP model for (policy, direction, port) — the
    sharded twin of models/http.build_http_model_for_port, same port
    cascade and flattened row order."""
    rows = collect_http_rows(policy, ingress, port)
    if isinstance(rows, ConstVerdict):
        return rows
    return mesh_http_model_from_rows(rows, mesh)


def mesh_model_from_family_rows(family: str, rows: list, mesh: Mesh):
    """Build a ShardedVerdictModel for ``family`` ("r2d2" | "dns" |
    "http") from already-flattened rule rows against an ARBITRARY mesh
    — the width-ladder's one assembly seam: the service's off-path
    reshape (and its parity probe) rebuild through here, so a
    degraded-width rebuild can never drift from the full-width
    construction (same ``split_balanced`` re-balance, same re-derived
    ``shard_offsets``, same pow2 rule buckets).  Shards and the fallback
    are built on the mesh's first slot and copied to the others."""
    n_shards = mesh.shape[RULE_AXIS]
    dev = mesh.devices[0, 0].device
    if family == "r2d2":
        fallback = build_r2d2_model_from_rows(rows, bucket=True, device=dev)
        stacked = build_sharded_r2d2_from_rows(rows, n_shards, bucket=True, device=dev)
    elif family == "dns":
        fallback = build_dns_model_from_rows(rows, bucket=True, device=dev)
        stacked = build_sharded_dns_from_rows(rows, n_shards, bucket=True, device=dev)
    elif family == "http":
        fallback = build_http_model(rows, device=dev)
        if isinstance(fallback, ConstVerdict):
            return fallback
        stacked = build_sharded_http_model(rows, n_shards, device=dev)
    else:
        raise ValueError(f"unknown sharded family {family!r}")
    if isinstance(fallback, ConstVerdict):
        return fallback
    return ShardedVerdictModel(
        stacked, shard_offsets(len(rows), n_shards), mesh, family,
        fallback=fallback,
        match_kinds=getattr(fallback, "match_kinds", ()),
    )


def mesh_kafka_model(rules_with_remotes: list, mesh: Mesh):
    """Mesh-resident kafka topic-ACL model from (remote_set, rule)
    rows."""
    dev = mesh.devices[0, 0].device
    fallback = build_kafka_model(rules_with_remotes, dev)
    if isinstance(fallback, ConstVerdict):
        return fallback
    stacked = build_sharded_kafka_model(
        rules_with_remotes, mesh.shape[RULE_AXIS], device=dev
    )
    return ShardedKafkaModel(stacked, mesh, fallback=fallback)
