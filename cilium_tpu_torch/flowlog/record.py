"""Flow-record schema: one structured record per policy decision.

The per-flow analog of the reference's Hubble flow (reference:
pkg/monitor/payload + Hubble's flow proto built from drop/trace/
policy-verdict perf events): who talked to whom, which direction, which
serving path rendered the verdict (the degradation ladder), what
the verdict was, and — the part an opaque accelerator normally eats —
WHICH rule decided it (`rule_id`, the flattened first-match row index
shared bit-identically by the device argmax reduction and the host
oracle walk) plus the rule's compiled match kind (literal|regex|nfa).

Records are stored columnar per ROUND (see ring.py) — this module only
defines the field vocabulary and the per-record dict materialization.
"""

from __future__ import annotations

# Verdict names (shared with accesslog/record.py's vocabulary, plus the
# typed fail-closed outcomes of the containment ladder).
VERDICT_FORWARDED = "Forwarded"
VERDICT_DENIED = "Denied"
VERDICT_SHED = "Shed"
VERDICT_ERROR = "Error"

# Integer verdict codes used in the columnar round batches.
CODE_FORWARDED = 0
CODE_DENIED = 1
CODE_SHED = 2
CODE_ERROR = 3

CODE_NAMES = (VERDICT_FORWARDED, VERDICT_DENIED, VERDICT_SHED, VERDICT_ERROR)

# Serving-path labels: the L7 ladder reuses sidecar/trace.py's path
# vocabulary (vec | oracle | host | shed); the packet layers add their
# own.
PATH_DATAPATH = "datapath"  # L3/L4 composed pipeline verdicts
PATH_XDP = "xdp"            # prefilter (XDP analog) source drops
PATH_ENGINE = "engine"      # daemon-side L7 batch engines (runtime/)

# Match kinds: how the DECIDING rule was compiled.  literal/regex/nfa
# are the device model tiers (dns maps matchName/always rows to
# literal and matchPattern/matchRegex rows to the automaton kind, so
# the legend is uniform across engine families); l3/l4 mark
# packet-layer decisions where no L7 rule row exists.
MATCH_LITERAL = "literal"
MATCH_REGEX = "regex"
MATCH_NFA = "nfa"
MATCH_L3 = "l3"
MATCH_L4 = "l4"
MATCH_NONE = ""

# Conntrack state codes for the optional per-record ct_state column.
CT_UNKNOWN = 0
CT_NEW = 1
CT_ESTABLISHED = 2
CT_NAMES = ("", "new", "established")


def verdict_name(code: int) -> str:
    return CODE_NAMES[code] if 0 <= code < len(CODE_NAMES) else VERDICT_ERROR


def materialize(
    seq: int,
    ts: float,
    path: str,
    conn_id: int,
    code: int,
    rule: int,
    kind: str,
    meta: tuple | None,
    reason: str = "",
    extra: dict | None = None,
) -> dict:
    """Build one record dict from a round batch's columns — the single
    definition of the record schema (`cilium observe --json` output,
    the MSG_OBSERVE_REPLY payload, and the tests all read this shape).
    ``meta`` is the connection metadata tuple captured at registration:
    (policy_name, ingress, src_id, dst_id, src_addr, dst_addr, proto,
    port[, session]) — the optional trailing session id is the fan-in
    shim session the conn registered through (0 = unknown/legacy)."""
    rec = {
        "seq": int(seq),
        "ts": ts,
        "path": path,
        "conn_id": int(conn_id),
        "verdict": verdict_name(code),
        "rule_id": int(rule),
        "match_kind": kind,
    }
    if meta is not None:
        (policy_name, ingress, src_id, dst_id,
         src_addr, dst_addr, proto, port) = meta[:8]
        rec.update(
            policy=policy_name,
            ingress=bool(ingress),
            src_identity=int(src_id),
            dst_identity=int(dst_id),
            src_addr=src_addr,
            dst_addr=dst_addr,
            proto=proto,
            dport=int(port),
        )
        if len(meta) > 8 and meta[8]:
            rec["session"] = int(meta[8])
    if reason:
        rec["reason"] = reason
    if extra:
        rec.update(extra)
    return rec
