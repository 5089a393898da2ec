"""R4 — capture purity.

A CUDA graph records the kernels a function launches ONCE, at capture
time; every replay launches the recorded kernels and never re-enters
Python.  So any side effect of a function reached from a capture —
mutating ``self``, taking a lock, doing I/O, reading the wall clock —
happens at capture time only and is silently missing from every
replay.  A lock taken there guards one capture and then lies, and a
wall-clock read makes verdicts depend on when the graph was captured —
breaking the bit-identical verdicts the paper's determinism north
star asks for.

Roots (the port's capture points; the reference's were ``jax.jit`` /
``vmap`` / ``lax.scan`` sites):

- every function called inside a ``torch.cuda.graph(...)`` block;
- the function handed to ``_CudaGraphFn`` (its first argument);
- the ``trace_fn`` handed to ``_jit_for`` (its third argument);
- the model entry points those wrap: ``*_verdicts`` /
  ``*_verdicts_attr`` functions and the ``__call__`` /
  ``verdicts_attr`` methods of classes under a ``models/`` directory.

A root given as ``functools.partial(f, ...)`` is ``f``; a lambda, and
the body of a ``torch.cuda.graph`` block itself, are checked in
place.  Reachability is WHOLE-PROGRAM: same-module bare
names and ``self.method`` calls, plus the interprocedural engine's
import-resolved call graph across modules (``service.py``'s capture
reaches ``models/base.py`` helpers; a clock read hidden in a helper two
modules away is still a determinism break).  Findings land in the
impure function's own file.
"""

from __future__ import annotations

import ast
import os
import re

from .callgraph import get_graph
from .core import (
    Finding,
    call_func_name,
    enclosing_symbol,
    is_lock_like_expr,
    local_assignments,
    unparse,
    walk_functions,
)

# Constructors / caches whose argument at this position is captured.
_TRACE_ARG = {"_CudaGraphFn": 0, "_jit_for": 2}
_TRACE_KW = {"_CudaGraphFn": "fn", "_jit_for": "trace_fn"}
_ENTRY_RE = re.compile(r"(^|_)verdicts(_attr)?$")
_MODEL_METHODS = {"__call__", "verdicts_attr"}
_IO_CALLS = {
    "open", "print", "recv", "recv_into", "recvfrom", "accept",
    "connect", "sendall", "send_msg", "unlink", "makedirs", "remove",
}
_CLOCK_ATTRS = {
    "time", "monotonic", "perf_counter", "time_ns",
    "perf_counter_ns", "monotonic_ns", "now",
}
_CLOCK_MODULES = {"time", "datetime", "datetime.datetime"}


def is_graph_capture(expr: ast.AST) -> bool:
    """True for a ``torch.cuda.graph(...)`` context expression."""
    return (isinstance(expr, ast.Call)
            and call_func_name(expr) == "graph"
            and unparse(expr.func).endswith("cuda.graph"))


def _in_models_dir(path: str) -> bool:
    return "models" in os.path.normpath(path).split(os.sep)[:-1]


def _module_functions(tree):
    """name -> [function nodes]; methods are also indexed by bare name
    so ``self.step`` resolves (approximately) across the module."""
    table: dict[str, list] = {}
    for fn, _qual, _cls in walk_functions(tree):
        table.setdefault(fn.name, []).append(fn)
    return table


def _trace_targets(expr, table, inline):
    """Function nodes a captured-callable expression names (a lambda
    goes to ``inline``, as (node, symbol))."""
    if isinstance(expr, ast.Lambda):
        inline.append((expr, "<lambda>"))
        return []
    if isinstance(expr, ast.Call) and call_func_name(expr) == "partial":
        return (_trace_targets(expr.args[0], table, inline)
                if expr.args else [])
    if isinstance(expr, (ast.Name, ast.Attribute)):
        name = expr.id if isinstance(expr, ast.Name) else expr.attr
        return list(table.get(name, ()))
    return []


def _capture_roots(path, tree, table, graph):
    """(root function nodes, inline captured code as (node, symbol),
    cross-module callee keys) of one module."""
    roots, inline, keys = [], [], []
    if _in_models_dir(path):
        for fn, _qual, cls in walk_functions(tree):
            if (fn.name in _MODEL_METHODS if cls is not None
                    else _ENTRY_RE.search(fn.name)):
                roots.append(fn)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = call_func_name(node)
            pos = _TRACE_ARG.get(name)
            if pos is None:
                continue
            arg = node.args[pos] if len(node.args) > pos else next(
                (kw.value for kw in node.keywords
                 if kw.arg == _TRACE_KW[name]), None)
            if arg is not None:
                roots.extend(_trace_targets(arg, table, inline))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if not any(is_graph_capture(it.context_expr)
                       for it in node.items):
                continue
            inline.append((node, enclosing_symbol(tree, node.lineno)))
            calls = [sub for stmt in node.body for sub in ast.walk(stmt)
                     if isinstance(sub, ast.Call)]
            for call in calls:
                f = call.func
                if isinstance(f, ast.Name) or (
                        isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "self"):
                    roots.extend(_trace_targets(f, table, inline))
            inside = {id(call) for call in calls}
            for fi in graph.funcs.values():
                if fi.path != path:
                    continue
                for call, _l, _c, _held, ckeys in fi.calls:
                    if id(call) in inside:
                        keys.extend(ckeys or ())
    return roots, inline, keys


def _called_names(fn):
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name)
                  and f.value.id == "self"):
                out.add(f.attr)
    return out


_LOCK_MSG = ("capture-reached function takes a lock: it guards one "
             "capture and then lies — a graph replay never re-enters "
             "Python")


def _impurities(sf, fn, qual):
    aliases = {} if isinstance(fn, ast.Lambda) else local_assignments(fn)
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    yield Finding(
                        "R4", sf.path, node.lineno, node.col_offset,
                        f"capture-reached function mutates self."
                        f"{t.attr}: the mutation happens at capture "
                        f"time only and every graph replay silently "
                        f"runs without it",
                        symbol=qual,
                    )
        elif isinstance(node, ast.With):
            for item in node.items:
                if is_lock_like_expr(item.context_expr, aliases):
                    yield Finding("R4", sf.path, node.lineno,
                                  node.col_offset, _LOCK_MSG, symbol=qual)
        elif isinstance(node, ast.Call):
            name = call_func_name(node)
            if (name == "acquire"
                    and isinstance(node.func, ast.Attribute)
                    and is_lock_like_expr(node.func.value, aliases)):
                yield Finding("R4", sf.path, node.lineno,
                              node.col_offset, _LOCK_MSG, symbol=qual)
            elif name in _IO_CALLS:
                yield Finding(
                    "R4", sf.path, node.lineno, node.col_offset,
                    f"capture-reached function performs I/O ({name}): "
                    f"runs at capture time only, never per verdict",
                    symbol=qual,
                )
            elif (name in _CLOCK_ATTRS
                  and isinstance(node.func, ast.Attribute)
                  and unparse(node.func.value) in _CLOCK_MODULES):
                yield Finding(
                    "R4", sf.path, node.lineno, node.col_offset,
                    f"capture-reached function reads the wall clock "
                    f"({unparse(node.func)}): the capture-time value "
                    f"is baked into the graph, and verdicts stop "
                    f"being bit-identical across replicas",
                    symbol=qual,
                )


def capture_reached(files):
    """Whole-program capture reachability, memoized on the graph: the
    FuncInfos reachable from any capture root, plus the captured code
    checked in place (lambdas handed to a capture, the bodies of
    ``torch.cuda.graph`` blocks) as (SourceFile, node, symbol) — shared
    by R4 (purity) and the device-contract rules R8/R9 (capture hazards
    / host transfers), which police the same captured scope for
    different sins."""
    graph = get_graph(files)
    memo = graph.rule_memo.get("capture_reached")
    if memo is not None:
        return memo

    frontier: list = []
    all_inline: list[tuple] = []
    tables: dict[str, dict] = {}
    for path, sf in files.items():
        table = _module_functions(sf.tree)
        tables[path] = table
        roots, inline, keys = _capture_roots(path, sf.tree, table, graph)
        frontier.extend(roots)
        frontier.extend(graph.funcs[k].node for k in keys
                        if k in graph.funcs)
        all_inline.extend((sf, node, qual) for node, qual in inline)

    # Whole-program reachability: same-module bare-name/self tables
    # PLUS import-resolved cross-module targets.
    seen: set[int] = set()
    reached: list = []
    while frontier:
        fn = frontier.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        fi = graph.by_node.get(id(fn))
        if fi is None:
            continue
        reached.append(fi)
        table = tables.get(fi.path, {})
        for cname in _called_names(fn):
            frontier.extend(table.get(cname, ()))
        for _call, _line, _col, _held, keys in fi.calls:
            for key in keys or ():
                callee = graph.funcs.get(key)
                if callee is not None and callee.path != fi.path:
                    frontier.append(callee.node)

    memo = (reached, all_inline)
    graph.rule_memo["capture_reached"] = memo
    return memo


def check_r4(files):
    reached, all_inline = capture_reached(files)
    emitted: set[tuple[str, int, int, str]] = set()
    for fi in reached:
        sf = files.get(fi.path)
        if sf is None:
            continue
        for f in _impurities(sf, fi.node, fi.qual):
            key = (f.path, f.line, f.col, f.message[:40])
            if key not in emitted:
                emitted.add(key)
                yield f
    for sf, node, qual in all_inline:
        for f in _impurities(sf, node, qual):
            key = (f.path, f.line, f.col, f.message[:40])
            if key not in emitted:
                emitted.add(key)
                yield f
