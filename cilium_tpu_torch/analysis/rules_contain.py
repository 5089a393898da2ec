"""R15 — exception containment on the hot loops (raise-taint).

PR 2's finding (14): one entry's ``settle_entry`` crash aborted the
whole batch drain — every other entry in the round leaked unanswered.
The repo's containment contract since then: a raise must never escape
a per-entry/per-round hot loop except through a handler that produces
a TYPED outcome (UNKNOWN_ERROR / SHED verdicts, a demotion, a typed
fallback to the scalar rung).  The good shape is the per-entry ``try``
inside the batch drain; the bug shape is a bare call chain to a
``raise`` — one malformed entry then costs the whole round (or wedges
a pipeline loop that has no round-level backstop at all).

Interprocedural raise-taint on the shared call-graph engine:

- **Sources** are explicit ``raise`` statements (``NotImplementedError``
  stubs excluded — abstract contracts, not crash paths) that are not
  contained by a handler in their own function.
- **Propagation** follows resolved calls made outside any
  try-with-handlers; unresolved attribute calls fall back to a bounded
  same-module/import-closure name match (``reasm.ingest`` →
  ``Reassembler.ingest``) so the reassembler/framing hooks — the
  raise-capable per-framing callbacks — are not invisible.
- **Findings** land at call sites inside for/while loops of the hot
  dispatch/service/reasm roots (``_process*``, the dispatcher worker,
  the completion/send loops, the ring drain, the reader loop) where
  the chain can raise out of the loop and no enclosing handler in the
  root produces a typed outcome.
"""

from __future__ import annotations

import ast
import os

from .callgraph import get_graph
from .core import Finding, call_func_name, unparse

_HOT_BASENAMES = {"dispatch.py", "service.py", "shm.py", "reasm.py",
                  "client.py"}

_ROOT_EXACT = {"_run", "_watch", "_completion_loop", "_send_loop",
               "read_loop", "_shm_doorbell"}


def _is_root(name: str) -> bool:
    return name.startswith("_process") or name in _ROOT_EXACT


# Handler vocabulary that counts as a TYPED outcome: the crash turns
# into an answered entry (shed/error verdict), a demotion, or a typed
# fallback — never a silent drop.
_TYPED_TERMS = {
    "_shed_item", "_on_batch_error", "on_batch_error", "on_stall",
    "send_verdicts", "send_frames", "_typed_entries",
    "_record_contained_failure", "_demote_mesh", "record_stall",
    "_reasm_bail", "_reasm_fallback", "_kill", "_teardown",
    "_shm_quarantine", "quarantine",
}
_TYPED_TEXT = ("UNKNOWN_ERROR", "SHED", "demote", "fallback", "bail")

# Attribute names too generic to fall back on by name: container and
# socket verbs that would alias half the stdlib.
_COMMON_METHODS = {
    "get", "put", "pop", "append", "add", "items", "keys", "values",
    "read", "write", "close", "send", "recv", "join", "start",
    "release", "acquire", "copy", "update", "clear", "discard",
    "remove", "submit", "result", "set", "extend", "insert", "index",
    "count", "sort", "split", "strip", "encode", "decode", "wait",
    "notify", "notify_all", "flush", "tobytes", "astype", "sum",
    "max", "min", "any", "all", "item", "take",
}


def _handler_is_typed(handler: ast.ExceptHandler) -> bool:
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Call) and call_func_name(
                sub) in _TYPED_TERMS:
            return True
        if isinstance(sub, ast.Attribute) and any(
                t in sub.attr for t in _TYPED_TEXT):
            return True
        if isinstance(sub, ast.Name) and any(
                t in sub.id for t in _TYPED_TEXT):
            return True
    return False


def _raise_reason(node: ast.Raise) -> str:
    if node.exc is None:
        return "re-raise"
    exc = node.exc
    if isinstance(exc, ast.Call):
        return unparse(exc.func)
    return unparse(exc)


def _is_stub_raise(node: ast.Raise) -> bool:
    # NotImplementedError: abstract contract, not a crash path.
    # ProtocolViolation: the typestate tables' fail-closed assertion —
    # R18 statically proves every in-tree mediated transition is a
    # declared edge, so these raises are machine-checked-unreachable
    # invariant backstops; counting them would demand a pragma on
    # every mediated state flip inside the hot loops.
    exc = node.exc
    name = ""
    if isinstance(exc, ast.Call):
        name = unparse(exc.func)
    elif exc is not None:
        name = unparse(exc)
    return "NotImplementedError" in name or "ProtocolViolation" in name


# --- per-function facts ---------------------------------------------------

def _direct_facts(fn):
    """(uncontained_calls, uncontained_raises) of fn's own body: nodes
    not under a try-with-handlers within fn.  A raise/call inside an
    except handler escapes unless an OUTER try contains it."""
    calls: list = []
    raises: list = []

    def visit(node, contained: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.Try):
            inner = contained or bool(node.handlers)
            for stmt in node.body + node.orelse:
                visit(stmt, inner)
            for h in node.handlers:
                for stmt in h.body:
                    visit(stmt, contained)
            for stmt in node.finalbody:
                visit(stmt, contained)
            return
        if isinstance(node, ast.Raise):
            if not contained and not _is_stub_raise(node):
                raises.append(node)
        if isinstance(node, ast.Call) and not contained:
            calls.append(node)
        for child in ast.iter_child_nodes(node):
            visit(child, contained)

    for stmt in fn.body:
        visit(stmt, False)
    return calls, raises


def _fallback_keys(graph, fi, call: ast.Call) -> list[str]:
    """Bounded name-match resolution for attribute calls the import
    resolver cannot see (``self._reasm.ingest``): defs named like the
    attribute in the caller's module or its direct imports, capped so
    a generic name never aliases the world."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return []
    name = func.attr
    if name in _COMMON_METHODS or name.startswith("__"):
        return []
    mods = {fi.module}
    imp = graph.imports.get(fi.module)
    if imp is not None:
        for tgt in imp.aliases.values():
            mods.add(tgt[1])
    keys: list[str] = []
    for m in sorted(mods):
        for f in graph.defs.get(m, {}).get(name, ()):
            if f.key not in keys and f.key != fi.key:
                keys.append(f.key)
    return keys if 0 < len(keys) <= 4 else []


class _RaiseState:
    """raises[key] = (chain-of-names, reason, source line) when the
    function can raise out of itself through uncontained sites."""

    def __init__(self, graph) -> None:
        self.graph = graph
        self.facts: dict[str, tuple] = {}
        self.targets: dict[int, list] = {}
        resolved = {}
        for fi in graph.funcs.values():
            for call, _l, _c, _held, keys in fi.calls:
                resolved[id(call)] = keys or []
        for fi in graph.funcs.values():
            calls, raises = _direct_facts(fi.node)
            for call in calls:
                keys = resolved.get(id(call)) or _fallback_keys(
                    graph, fi, call
                )
                if keys:
                    self.targets[id(call)] = keys
            self.facts[fi.key] = (calls, raises)
        self.raises: dict[str, tuple | None] = {}
        for fi in graph.funcs.values():
            _calls, raises = self.facts[fi.key]
            self.raises[fi.key] = (
                ((), _raise_reason(raises[0]), raises[0].lineno)
                if raises else None
            )
        changed = True
        guard = 0
        while changed and guard < 60:
            changed = False
            guard += 1
            for fi in graph.funcs.values():
                if self.raises[fi.key] is not None:
                    continue
                calls, _raises = self.facts[fi.key]
                for call in calls:
                    for key in self.targets.get(id(call), ()):
                        got = self.raises.get(key)
                        if got is None:
                            continue
                        chain, reason, line = got
                        if len(chain) < 8:
                            callee = graph.funcs.get(key)
                            self.raises[fi.key] = (
                                (callee.name,) + chain, reason,
                                call.lineno,
                            )
                            changed = True
                            break
                    if self.raises[fi.key] is not None:
                        break

    def call_raise(self, call: ast.Call):
        """(chain, reason) when this call site can raise, else None."""
        for key in self.targets.get(id(call), ()):
            got = self.raises.get(key)
            if got is not None:
                callee = self.graph.funcs.get(key)
                chain, reason, _line = got
                return (callee.name,) + chain, reason
        return None


def _raise_state(files) -> _RaiseState:
    graph = get_graph(files)
    state = graph.rule_memo.get("r15_state")
    if state is None:
        state = _RaiseState(graph)
        graph.rule_memo["r15_state"] = state
    return state


# --- the rule -------------------------------------------------------------

def _loop_findings(fi, loop, state: _RaiseState, emitted: set):
    """Findings inside one hot loop: uncontained raising call chains
    and direct raises (a try WITH handlers inside the loop is the
    per-entry containment good shape and blesses its body)."""

    def visit(node, contained: bool):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.Try):
            inner = contained or bool(node.handlers)
            for stmt in node.body + node.orelse:
                yield from visit(stmt, inner)
            for h in node.handlers:
                for stmt in h.body:
                    yield from visit(stmt, contained)
            for stmt in node.finalbody:
                yield from visit(stmt, contained)
            return
        if isinstance(node, ast.Raise) and not contained \
                and not _is_stub_raise(node):
            key = (fi.path, node.lineno, node.col_offset)
            if key not in emitted:
                emitted.add(key)
                yield Finding(
                    "R15", fi.path, node.lineno, node.col_offset,
                    f"raise {_raise_reason(node)} escapes the "
                    f"per-entry hot loop in {fi.qual} with no typed "
                    f"outcome: one malformed entry aborts the whole "
                    f"drain and every other entry leaks unanswered "
                    f"(the PR 2 settle_entry crash class) — contain "
                    f"it per entry and answer typed "
                    f"(UNKNOWN_ERROR/SHED/demotion)",
                    symbol=fi.qual,
                )
        if isinstance(node, ast.Call) and not contained:
            got = state.call_raise(node)
            if got is not None:
                chain, reason = got
                key = (fi.path, node.lineno, node.col_offset)
                if key not in emitted:
                    emitted.add(key)
                    text = " -> ".join(chain)
                    yield Finding(
                        "R15", fi.path, node.lineno, node.col_offset,
                        f"call chain {text} can raise {reason} out of "
                        f"the per-entry hot loop in {fi.qual} with no "
                        f"enclosing handler that produces a typed "
                        f"outcome: one bad entry aborts the whole "
                        f"drain and the rest leak unanswered — wrap "
                        f"the per-entry work in a try that answers "
                        f"typed (UNKNOWN_ERROR/SHED/typed fallback)",
                        symbol=fi.qual,
                    )
        for child in ast.iter_child_nodes(node):
            yield from visit(child, contained)

    for stmt in loop.body:
        yield from visit(stmt, False)


def _walk_root(fi, state: _RaiseState, emitted: set):
    """Loops of one root function, honoring enclosing typed-outcome
    tries: a loop whose crash reaches a handler (in this root) that
    answers typed is the sanctioned round-containment shape."""

    def visit(node, typed_guarded: bool):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.Try):
            inner = typed_guarded or any(
                _handler_is_typed(h) for h in node.handlers
            )
            for stmt in node.body + node.orelse:
                yield from visit(stmt, inner)
            for h in node.handlers:
                for stmt in h.body:
                    yield from visit(stmt, typed_guarded)
            for stmt in node.finalbody:
                yield from visit(stmt, typed_guarded)
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            if not typed_guarded:
                yield from _loop_findings(fi, node, state, emitted)
            # Nested loops under a contained outer loop are still
            # visited for their own (deeper) context.
            for stmt in node.body + node.orelse:
                yield from visit(stmt, typed_guarded)
            return
        for child in ast.iter_child_nodes(node):
            yield from visit(child, typed_guarded)

    for stmt in fi.node.body:
        yield from visit(stmt, False)


def check_r15(files):
    state = _raise_state(files)
    graph = state.graph
    emitted: set = set()
    for fi in sorted(graph.funcs.values(),
                     key=lambda f: (f.path, f.node.lineno)):
        if os.path.basename(fi.path) not in _HOT_BASENAMES:
            continue
        if not _is_root(fi.node.name):
            continue
        yield from _walk_root(fi, state, emitted)
