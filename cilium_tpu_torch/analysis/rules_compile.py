"""R12 — compile-on-dispatch-path.

PR 9's tentpole contract: policy/table recompiles run on the builder
thread and reach the serving tables by a pointer flip — the dispatch
path must never pay an nvcc build, a CUDA-graph capture, an engine
build, or a prewarm.  A
compile that sneaks back onto a dispatch round (or under a handler
lock, where it stalls every reader/writer queued behind it) is exactly
the multi-second stall the async swap was built to remove, and no
functional test notices: verdicts stay bit-identical, only the p99
explodes at the first churned table shape.

Two detection halves, both interprocedural (import-resolved call
graph, the same engine R2/R4 ride):

- **Reachability.**  Compile-class calls (``torch.cuda.CUDAGraph`` /
  ``torch.cuda.graph`` captures, ``kernels.build_all`` /
  ``kernels.library`` nvcc builds, ``prewarm``, ``build_*_model*``,
  ``compile_automaton``, ``_make_engine`` / ``_build_engine``,
  ``_measure_dispatch_mode``, ``compile`` / ``trace``) reachable from
  the dispatch/service hot loops of the hot modules (dispatch.py / service.py / shm.py roots:
  the round entry ``_process*``, the vec/mat/slow runners, the
  completion/send loops, the reader loop, admission).  Findings land
  at call sites inside the hot modules — the first edge off the
  dispatch path — so the sanctioned cold paths (first-bind on a reader
  thread, the builder thread itself) carry their justification where
  the edge is.
- **Held-lock compiles.**  A compile-class call made while ANY lock is
  held, in a hot module: even off the dispatch path, a compile under
  the registry/handler lock stalls every round that snapshots behind
  it (the pre-PR 9 ``policy_update`` bug shape).
"""

from __future__ import annotations

import os
import re

from .callgraph import get_graph
from .core import Finding, call_func_name, unparse

_HOT_BASENAMES = {"dispatch.py", "service.py", "shm.py",
                  "dnsengine.py"}

# Functions that ARE the dispatch path in the hot modules: the round
# entry + everything a round runs through, the pipeline loops, and the
# per-session reader loop (a compile there wedges every flow on the
# shim connection — the pre-PR 9 policy_update handler shape).
_DISPATCH_ROOTS = {
    "_process", "_process_entrywise", "_run_mat_group", "_run_vec",
    "_run_fast", "_run_slow_batched", "_run_slow", "_issue_fast",
    "_issue_chunks", "_issue_chunks_blob", "_issue_slow_async",
    "_finish_fast", "_finish_slow_async", "_finish_vec",
    "_completion_loop", "_send_loop", "_admit", "_try_cut_through",
    "submit_data", "submit_matrix", "submit_ring", "read_loop",
    "_shm_doorbell", "_run",
}

_COMPILE_NAMES = {
    "CUDAGraph", "build_all", "prewarm", "compile_automaton",
    "_make_engine", "_build_engine", "_measure_dispatch_mode",
    "compile", "trace",
}
_COMPILE_RE = re.compile(r"^build_\w*model\w*$")
# Names that are compile-class only on this receiver.
_COMPILE_QUALIFIED = {"graph": "cuda.graph", "library": "kernels.library"}


def is_compile_call(call, names=_COMPILE_NAMES, pattern=_COMPILE_RE) -> bool:
    """True for a capture / nvcc build / engine build call."""
    name = call_func_name(call)
    qual = _COMPILE_QUALIFIED.get(name)
    if qual is not None:
        return unparse(call.func).endswith(qual)
    return name in names or bool(pattern.match(name))


def _reachable_from_roots(graph, files):
    """FuncInfos reachable from the dispatch roots of hot modules,
    following the import-resolved call graph plus same-module bare/
    self-call names (mirroring rules_jit's approximation)."""
    roots = [
        fi for fi in graph.funcs.values()
        if os.path.basename(fi.path) in _HOT_BASENAMES
        and fi.qual.split(".")[-1] in _DISPATCH_ROOTS
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


def check_r12(files):
    graph = get_graph(files)
    emitted: set[tuple] = set()

    def emit(fi, call, line, col, why):
        key = (fi.path, line, col)
        if key in emitted:
            return None
        emitted.add(key)
        name = call_func_name(call)
        return Finding(
            "R12", fi.path, line, col,
            f"compile/trace ({name}) {why}: table recompiles belong "
            f"on the policy builder thread with a pointer-flip swap — "
            f"a compile here stalls dispatch rounds for the whole "
            f"build or capture and no functional test can see it",
            symbol=fi.qual,
        )

    # Half 1: reachable from the dispatch roots; report sites in hot
    # modules (the first edge off the dispatch path).
    for fi in _reachable_from_roots(graph, files):
        if os.path.basename(fi.path) not in _HOT_BASENAMES:
            continue
        for call, line, col, _held, _keys in fi.calls:
            if is_compile_call(call):
                f = emit(fi, call, line, col,
                         "reachable from the dispatch hot path")
                if f is not None:
                    yield f

    # Half 2: compile while holding a lock, anywhere in a hot module.
    for fi in graph.funcs.values():
        if os.path.basename(fi.path) not in _HOT_BASENAMES:
            continue
        for call, line, col, held, _keys in fi.calls:
            if held and is_compile_call(call):
                f = emit(fi, call, line, col,
                         f"under held lock(s) {sorted(held)}")
                if f is not None:
                    yield f
