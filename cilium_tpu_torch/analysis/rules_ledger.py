"""R23 — unledgered compile site.

PR 20's tentpole contract: every executable-producing site — nvcc
builds, CUDA-graph captures, engine builds, mesh model builds, prewarm
launches — routes
through the device-economics ledger (sidecar/ledger.py), so
``device_compiles_total{cause}`` is a complete census and "warm churn
performs ZERO compiles" is an asserted invariant rather than a hope.
A compile site that bypasses the ledger silently un-censuses itself:
the soak's zero-compile assertion goes vacuous for that site, and the
ROADMAP item 5 before/after metric (executable-cache hit economics)
under-counts.

Detection (interprocedural, same import-resolved call graph R2/R4/R12
ride): compile-class calls (``torch.cuda.CUDAGraph`` /
``torch.cuda.graph``, ``kernels.build_all`` / ``kernels.library``,
``prewarm``, ``compile_automaton``, ``_make_engine``/``_build_engine``,
``_measure_dispatch_mode``, ``build_*model*`` / ``mesh_*model*``
builders) in the hot modules, reachable from the R12
dispatch roots PLUS the policy-builder roots (swap/rebind/mesh-ladder
— the off-path compile sites R12 deliberately sanctions are exactly
the ones the ledger must still see).  They are the sites of the
ledger's kinds ``nvcc-build``, ``cuda-graph-capture`` and
``engine-build`` (``sidecar/ledger.py``).  A site is LEDGERED when its
enclosing function shows ledger evidence: a ``record_compile`` /
``broadcast_compile`` call, a ``cause_scope(...)`` entry, or the
choke point's own residency bookkeeping (``executable_resident``).
Everything else is a finding — or carries a justified pragma naming
why that site is exempt (e.g. the cold first-bind whose default
"cold" cause IS the ledger contract).
"""

from __future__ import annotations

import os
import re

from .callgraph import get_graph
from .core import Finding, call_func_name
from .rules_compile import _DISPATCH_ROOTS, _HOT_BASENAMES, is_compile_call

# The policy-builder half of the root set: R12 keeps compiles OFF these
# paths' dispatch rounds; R23 makes the sanctioned off-path compiles
# visible to the ledger.
_BUILDER_ROOTS = {
    "_policy_builder_loop", "_run_swap", "_run_rebind",
    "_run_mesh_ladder", "_run_mesh_rebuild", "_promote_mesh_classic",
    "_bind_engine", "create_engine_for_redirect",
}

# engines.py: the daemon-side engine factory (broadcast_compile path).
_LEDGER_HOT_BASENAMES = _HOT_BASENAMES | {"engines.py"}

# Executable-producing names only — narrower than R12's set (no bare
# ``compile``/``trace``, which R12 bounds by dispatch-path
# reachability; R23's wider root set would false-positive on
# ``re.compile`` in builder helpers).
_COMPILE_NAMES = {
    "CUDAGraph", "build_all", "prewarm", "compile_automaton",
    "_make_engine", "_build_engine", "_measure_dispatch_mode",
}
_COMPILE_RE = re.compile(r"^(build|mesh)_\w*model\w*$")

# Function-level ledger evidence: the record call itself, the cause
# scope that classifies everything beneath it, or the choke point's
# residency bookkeeping.
_LEDGER_EVIDENCE = {
    "record_compile", "broadcast_compile", "cause_scope",
    "executable_resident",
}


def _reachable(graph):
    """FuncInfos reachable from the dispatch + builder roots of hot
    modules (same traversal as rules_compile._reachable_from_roots,
    over the widened root set)."""
    roots = [
        fi for fi in graph.funcs.values()
        if os.path.basename(fi.path) in _LEDGER_HOT_BASENAMES
        and fi.qual.split(".")[-1] in (_DISPATCH_ROOTS | _BUILDER_ROOTS)
    ]
    seen: set[str] = set()
    frontier = list(roots)
    reached = []
    while frontier:
        fi = frontier.pop()
        if fi.key in seen:
            continue
        seen.add(fi.key)
        reached.append(fi)
        for _call, _line, _col, _held, keys in fi.calls:
            for key in keys or ():
                callee = graph.funcs.get(key)
                if callee is not None:
                    frontier.append(callee)
    return reached


def check_r23(files):
    graph = get_graph(files)
    emitted: set[tuple] = set()
    for fi in _reachable(graph):
        if os.path.basename(fi.path) not in _LEDGER_HOT_BASENAMES:
            continue
        names = {call_func_name(c) for c, *_ in fi.calls}
        if names & _LEDGER_EVIDENCE:
            continue  # the function ledgers its compiles
        for call, line, col, _held, _keys in fi.calls:
            if not is_compile_call(call, _COMPILE_NAMES, _COMPILE_RE):
                continue
            name = call_func_name(call)
            key = (fi.path, line, col)
            if key in emitted:
                continue
            emitted.add(key)
            yield Finding(
                "R23", fi.path, line, col,
                f"unledgered compile site ({name}): every "
                f"executable-producing call routes through the device "
                f"ledger (record_compile/broadcast_compile, or a "
                f"cause_scope classifying the build) so the per-cause "
                f"compile census stays complete and the zero-compile "
                f"warm-churn invariant stays asserted",
                symbol=fi.qual,
            )
