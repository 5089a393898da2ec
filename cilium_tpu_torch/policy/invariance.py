"""Rule-row byte-invariance analysis — the verdict-cache contract.

The established-flow verdict cache (sidecar service + shim client)
short-circuits frames of a flow whose verdict provably cannot depend on
the frame's bytes.  That claim is STRUCTURAL and per-epoch static: it is
derived here from the compiled rule rows at table-build time, never from
observed traffic, so a cached verdict is exactly what a cold recompute
would produce — attribution included.

The analysis walks the same flattened first-match row order the device
argmax and the host oracle use (models/r2d2.collect_policy_rows /
models/http.collect_http_rows in the JAX package, proxylib policy.matches_at):

- **invariant ALLOW, rule k** — the FIRST row whose remote set admits
  this identity has no byte constraint (an always-match row: an L7 rule
  with no matchers, or a blank matcher).  Every frame then matches row
  k: rows before it cannot match (remote excluded), and first-match
  semantics stop the walk at k, so both the verdict AND the attributed
  rule are byte-invariant.
- **invariant DENY** — no row admits this identity at all.  (The cache
  tiers deliberately do not arm on deny: denied frames carry
  per-frame inject side effects — the ERROR/403 responses — whose
  framing the short-circuit would skip.)
- **None** — the first admitting row inspects bytes: no claim.  This is
  deliberately conservative: a later always-match row would make the
  VERDICT invariant but not the attribution, and the churn-soak parity
  gate re-validates cached (verdict, rule, epoch) against a cold
  recompute.

A copy of ``cilium_tpu/policy/invariance.py``.

Rows are reduced to ``(remote_set_or_None, byte_free)`` pairs by the
model builders (``invariant_rows`` on the batch models, host-side aux
exactly like ``match_kinds`` — never device data, never tensors).

Cross-restart note: every grant is stamped with the policy epoch it was
derived under, and the restart handoff snapshot carries that epoch
forward — a successor re-derives grants from its own recompiled rows
and confirms the (epoch, rule) pair matches before counting the grant
restored, while the shim's survival window serves a grant only while
its epoch equals the last service epoch the shim saw.  The invariance
claim therefore never outlives the rows it was computed from, even
across a kill -9 boundary.
"""

from __future__ import annotations

# Claim constants: what a cache tier may do with a flow.
ALLOW = True
DENY = False


def reduce_r2d2_rows(rows) -> tuple:
    """(remote_set_or_None, byte_free) per flattened r2d2 row.  A row is
    byte-free iff it constrains neither the command nor the file (the
    ``l7_matchers == [None]`` always-match shape, or a fully blank
    matcher — both match every framed message, host and device)."""
    return tuple(
        (remotes if remotes else None, not cmd and not file_rx)
        for remotes, cmd, file_rx in rows
    )


def reduce_dns_rows(rows) -> tuple:
    """(remote_set_or_None, byte_free) per flattened DNS row.  A row is
    byte-free iff it carries no name constraint (the matcherless
    always-match shape, or a DnsRule with none of matchName/
    matchPattern/matchRegex set).  This is SOUND only because the DNS
    engine's always-match rows admit any complete frame — the QNAME
    validity gate masks name-CONSTRAINED rows only (a malformed
    question can never satisfy a name rule, but a byte-free "allow
    these peers' DNS" row passes it, host and device alike) — so the
    verdict and the attributed first-match row really are independent
    of the frame's bytes, and a cached whole-frame short-circuit is
    exactly what a cold recompute would produce."""
    return tuple(
        (
            remotes if remotes else None,
            rule is None
            or not (rule.name or rule.pattern or rule.regex),
        )
        for remotes, rule in rows
    )


def reduce_http_rows(rows) -> tuple:
    """(remote_set_or_None, byte_free) per flattened HTTP row.  A row is
    byte-free iff the PortRuleHTTP carries no method/path/host/header
    constraint — the pure-L3/L4 "allow these peers on this port" shape."""
    return tuple(
        (
            remotes if remotes else None,
            not (r.method or r.path or r.host or r.headers),
        )
        for remotes, r in rows
    )


def invariant_verdict(inv_rows, remote_id: int):
    """Byte-invariance claim for one identity against reduced rows.

    Returns ``(ALLOW, rule_row)`` / ``(DENY, -1)`` / ``None`` (no
    claim).  ``inv_rows`` is the builders' ``invariant_rows`` tuple; the
    rule row index is the flattened first-match row — identical to the
    device argmax and the host ``matches_at`` walk by construction."""
    for i, (remotes, byte_free) in enumerate(inv_rows):
        if remotes is not None and remote_id not in remotes:
            continue  # this row can never match the identity
        if byte_free:
            return ALLOW, i  # first admitting row always matches
        return None  # first admitting row inspects bytes: no claim
    return DENY, -1  # no row admits the identity


def model_invariant_rows(model):
    """Resolve ``invariant_rows`` through a mesh wrapper: the sharded
    wrappers keep host-side aux on their single-chip ``fallback`` (same
    rows, same flattened order — the global-argmax contract)."""
    rows = getattr(model, "invariant_rows", None)
    if rows is None:
        fb = getattr(model, "fallback", None)
        rows = getattr(fb, "invariant_rows", None)
    return rows


_MISS = object()
MEMO_MAX = 1 << 16  # bound each engine's per-identity claim memo


class InvariantClaimEngine:
    """Mixin: the engine half of the verdict-cache contract — THE one
    definition behind every engine's ``verdict_invariant``
    (R2d2BatchEngine, BaseBatchEngine, DeviceAssistedEngine).

    ``verdict_invariant(remote_id)`` returns ``(allow, rule_row)``
    when every future frame's verdict (and attributed first-match
    row) against the engine's compiled table is independent of its
    bytes — ConstVerdict models, or a first-admitting rule row with
    no byte constraint — else ``None`` (no claim).  Per-epoch static:
    derived from the rule rows at build time, memoized per identity,
    and the memo dies with its engine on an epoch swap (the serving
    caches key on the epoch).  Models exposing no ``invariant_rows``
    make no claim structurally: kafka (per-frame error-response
    injection is framing-dependent) and cassandra/memcached (reply-
    intent queues make per-frame framing load-bearing); the HTTP
    judge path does claim (request heads are judged statelessly and
    replies pass untouched).  The memo is created lazily, so mixers
    need no ``__init__`` cooperation."""

    _invariant_memo: dict | None = None

    def verdict_invariant(self, remote_id: int):
        memo = self._invariant_memo
        if memo is None:
            memo = self._invariant_memo = {}
        return memoized_claim(
            getattr(self, "model", None), memo, remote_id
        )


def memoized_claim(model, memo: dict, remote_id: int):
    """Engine-side claim lookup (see ``InvariantClaimEngine``, the
    mixin the engine tiers inherit it through): bounded per-engine memo,
    ConstVerdict special-case, else the first-match walk over the
    model's (or its mesh fallback's) ``invariant_rows``; a model
    exposing no rows makes no claim.  The memo dies with its engine on
    an epoch swap — the serving caches key on the epoch."""
    claim = memo.get(remote_id, _MISS)
    if claim is not _MISS:
        return claim
    from ..models.base import ConstVerdict  # lazy: keep policy/ leaf-like

    if isinstance(model, ConstVerdict):
        claim = (bool(model.allow), -1)
    else:
        rows = model_invariant_rows(model)
        claim = (
            invariant_verdict(rows, remote_id) if rows is not None else None
        )
    if len(memo) < MEMO_MAX:
        memo[remote_id] = claim
    return claim
