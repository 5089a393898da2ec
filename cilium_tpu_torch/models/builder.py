"""Build device verdict models from resolved L4 policy filters.

The bridge from the policy engine's output (L4Filter with per-selector
L7 rules, reference: pkg/policy/l4.go L7DataMap) to the device models:
selectors are expanded against the identity cache into allowed-remote
sets (the same expansion the reference does when pushing NPDS policy to
proxies, reference: pkg/envoy/server.go:607 getNetworkPolicy), and the
rules compile into the per-protocol batch model on ``device`` (None: the
CUDA card; ``"cpu"`` for the plain versions).
"""

from __future__ import annotations

from ..policy.api import PortRuleHTTP, PortRuleKafka
from ..policy.l4 import L4Filter, PARSER_TYPE_HTTP, PARSER_TYPE_KAFKA
from .base import ConstVerdict
from .http import build_http_model
from .kafka import build_kafka_model


def expand_selector_remotes(sel, identity_cache: dict) -> frozenset | None:
    """Identities whose labels the selector matches.  None means wildcard
    (any remote); an empty frozenset means the selector currently matches
    NO identity — callers must drop such rows, not wildcard them."""
    if sel.is_wildcard():
        return None
    return frozenset(
        numeric
        for numeric, lbls in identity_cache.items()
        if sel.matches(lbls.to_array())
    )


def _remote_rows(sel, identity_cache: dict) -> list[frozenset] | None:
    """Resolve a selector to pack_remote_sets-convention sets (empty set =
    wildcard), chunked so no set exceeds MAX_REMOTES (broad selectors
    split into several rows).  None means the row must be skipped (fail
    closed: a selector matching no known identity allows nobody)."""
    from .base import MAX_REMOTES

    remotes = expand_selector_remotes(sel, identity_cache)
    if remotes is None:
        return [frozenset()]  # wildcard
    if not remotes:
        return None  # matches nothing: skip
    ordered = sorted(remotes)
    return [
        frozenset(ordered[i:i + MAX_REMOTES])
        for i in range(0, len(ordered), MAX_REMOTES)
    ]


def kafka_host_rows(f: L4Filter, identity_cache: dict) -> list[tuple[frozenset, PortRuleKafka]]:
    """(remotes, rule) rows of a Kafka filter: the Kafka model's rows and
    the host oracle's (``runtime.engines_util`` exports it under this
    name), one copy of the expansion."""
    rows: list[tuple[frozenset, PortRuleKafka]] = []
    for sel, l7 in f.l7_rules_per_ep.items():
        remote_chunks = _remote_rows(sel, identity_cache)
        if remote_chunks is None:
            continue
        for remotes in remote_chunks:
            if len(l7) == 0:
                wildcard = PortRuleKafka()
                wildcard.sanitize()
                rows.append((remotes, wildcard))
            for k in l7.kafka:
                rows.append((remotes, k))
    return rows


def build_model_for_filter(f: L4Filter, identity_cache: dict, mesh=None,
                           device=None):
    """Compile an L4Filter's L7 rules into a device batch model.

    Returns a model callable or ConstVerdict.  Generic (l7proto) rules are
    served by the proxylib parser pipeline instead (cilium_tpu_torch.proxylib),
    mirroring the reference's dispatch (pkg/proxy/proxy.go:229-236).
    With a (flows, rules) ``mesh``, rule rows shard across RULE_AXIS and
    the returned model is the mesh-resident wrapper (same call contract,
    single-card fallback attached for the device-loss rung) on the
    mesh's slots, and ``device`` is not read.
    """
    if f.l7_parser == PARSER_TYPE_HTTP:
        rows: list[tuple[frozenset, PortRuleHTTP]] = []
        for sel, l7 in f.l7_rules_per_ep.items():
            remote_chunks = _remote_rows(sel, identity_cache)
            if remote_chunks is None:
                continue
            for remotes in remote_chunks:
                if len(l7) == 0:
                    # L3-override wildcard: allow-all row for these remotes
                    # (reference: l4.go:209-227 endpointsWithL3Override).
                    rows.append((remotes, PortRuleHTTP()))
                for h in l7.http:
                    rows.append((remotes, h))
        if mesh is not None and rows:
            from ..parallel.rulesharding import mesh_http_model_from_rows

            return mesh_http_model_from_rows(rows, mesh)
        return build_http_model(rows, device=device)

    if f.l7_parser == PARSER_TYPE_KAFKA:
        krows = kafka_host_rows(f, identity_cache)
        if mesh is not None and krows:
            from ..parallel.rulesharding import mesh_kafka_model

            return mesh_kafka_model(krows, mesh)
        return build_kafka_model(krows, device=device)

    return ConstVerdict(True)  # no L7 restrictions at this layer
