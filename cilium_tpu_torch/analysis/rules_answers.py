"""R14 — exactly-once verdict accounting (the completion seam).

The paper's bit-identical-verdicts contract silently assumes a harder
one: every admitted frame is answered EXACTLY once with a typed
outcome.  Both halves of that invariant have real bug history here —
PR 2's deposed-round double reply (a stuck worker's late send racing
the watchdog's typed SHED sweep) and PR 10's columnar lane exits
(bytes stranded in the arena when a bail path forgot the release), and
PR 12's shim-local grants multiply the answer sites that must be
proven exclusive.  R14 models the seam on the whole-program call
graph:

- **Answer sites** are the sends/records keyed by entry/seq
  (``send_verdicts`` / ``send_frames`` / ``_shed_item`` /
  ``_on_batch_error`` / grant synthesis) and **typed hand-offs** are
  the accountability transfers (dispatcher ``submit*``, the completion
  pipeline ``put``/``_completion_put``, columnar ``assemble``,
  ``_reasm_bail``'s release-to-scalar).  A fixed-point pass lifts both
  through resolved calls (``answers_via``).
- **R14.1 admit accounting.**  A hot-module admit root (``submit_*``,
  ``_process*``, the ring drain) that can take a BARE return with no
  answer site or typed hand-off lexically dominating it is a path
  that drops an admitted entry on the floor — the caller blocks until
  its own timeout, and nothing counts the loss.  (Value-carrying
  returns are the bail PROTOCOL — ``return False`` hands the round
  back to the scalar rung — and are exempt.)
- **R14.2 answer exclusivity.**  Two answer sites reachable in ONE
  execution of a function, sharing an argument identity (the same
  entry/batch), with no dominating exclusivity guard between them —
  the ``answered`` cell, ``thread_round_is_shed``/deposal checks, the
  ``drain_lock`` atomic pop — is the double-reply shape: a packed
  reply stream answering one seq twice desyncs the shim.  Guards may
  live in the CALLEE (``_shed_item`` checks ``batch.answered`` before
  its send; ``send``/``send_frames`` mark under the write lock), so
  the check is interprocedural: only an answer path with no guard
  anywhere along it fires.
"""

from __future__ import annotations

import ast
import os

from .callgraph import get_graph
from .core import Finding, call_func_name

_HOT_BASENAMES = {"dispatch.py", "service.py", "shm.py", "reasm.py",
                  "client.py"}

# Direct answer emission, keyed by entry/seq: sends and typed-reply
# records.  (``send`` itself is covered through send_verdicts/
# send_frames — the bare name would drag control-plane frames in.)
ANSWER_TERMINALS = {
    "send_verdicts", "send_frames", "_shed_item", "_on_batch_error",
    "on_batch_error", "on_stall", "_send_cache_grants",
}

# Typed hand-offs: the entry stays accountable downstream (dispatcher
# queue, completion pipeline, columnar assembly, lane-exit release —
# ``adopt_residue``/``drop`` are the arena-carry accountability
# transfers of the columnar lane exit).
HANDOFF_TERMINALS = {
    "submit", "submit_many", "submit_data", "submit_matrix",
    "submit_ring", "_completion_put", "put", "put_nowait",
    "assemble", "_classify_entry", "_reasm_bail", "close_connection",
    "adopt_residue", "drop",
}

# Exclusivity-guard vocabulary: an expression touching one of these is
# the answered-cell / shed-round / deposal / drain-lock dance.
_GUARD_SUBSTRINGS = ("answered", "suppressed", "deposed", "is_shed",
                     "_shed_rounds", "drain_lock")

# Control-plane job queues: a ``.put`` on these receivers enqueues
# BUILDER work (epoch swaps, rebinds, mesh reshape/reprobe jobs, grant
# pushes), never an admitted entry — it is not an entry hand-off, so
# it neither discharges an admit root's accountability (R14.1) nor
# makes its caller an answer site (R14.2).  Without this, the mesh
# demote path (dispatch -> _mesh_guarded -> _demote_mesh -> reshape
# job enqueue) would turn every model call into a phantom answer site.
_CONTROL_QUEUE_RECEIVERS = ("_build_queue",)


def _is_control_queue_call(call: ast.Call) -> bool:
    fn = call.func
    if not (isinstance(fn, ast.Attribute)
            and fn.attr in ("put", "put_nowait")):
        return False
    recv = fn.value
    return isinstance(recv, ast.Attribute) and (
        recv.attr in _CONTROL_QUEUE_RECEIVERS
    )

_ADMIT_EXACT = {"_shm_doorbell", "_shm_submit_records"}


def _is_admit_root(name: str) -> bool:
    # ``_reasm*``: the columnar lane-exit plumbing — a bail/release
    # that bare-returns without handing the carry anywhere is the
    # PR 10 silent-byte-loss shape.  ``_fanin*``: the multi-session
    # coalescer seam — an admission gate or a coalesced round's
    # per-session slice fan-out that bare-returns (a quarantined
    # session's batch dropped unanswered, or a dead session's slice
    # aborting the remaining sessions' sends) is the same silent-loss
    # class, now scoped to a tenant.  (Value-carrying returns stay the
    # bail protocol: the fan-in admission gate returns its shed reason
    # and the CALLER owes the typed answer.)
    return (name.startswith("submit_") or name.startswith("_process")
            or name.startswith("_reasm") or name.startswith("_fanin")
            or name in _ADMIT_EXACT)


def _has_guard_text(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and any(
                g in sub.attr for g in _GUARD_SUBSTRINGS):
            return True
        if isinstance(sub, ast.Name) and any(
                g in sub.id for g in _GUARD_SUBSTRINGS):
            return True
    return False


def _fn_has_guard_marker(fn: ast.AST) -> bool:
    return _has_guard_text(fn)


def _arg_idents(call: ast.Call) -> set[str]:
    """Name identities flowing into a call's arguments — the 'same
    entry' approximation for R14.2 pairing (two sends that share no
    argument identity answer different entries)."""
    out: set[str] = set()
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        for sub in ast.walk(a):
            if isinstance(sub, ast.Name):
                out.add(sub.id)
            elif isinstance(sub, ast.Attribute) and isinstance(
                    sub.value, ast.Name):
                out.add(sub.value.id)
    out.discard("self")
    return out


# --- whole-program answer summaries ---------------------------------------

class _AnswerState:
    """Per-function answer facts over one graph: ``answers`` (reaches
    an answer site or hand-off), ``chain`` (how), ``exposes`` (has an
    answer path with NO guard anywhere along it — the callee side of
    R14.2), ``guard_marker`` (touches the exclusivity vocabulary)."""

    def __init__(self, graph) -> None:
        self.graph = graph
        self.call_keys: dict[int, list] = {}
        for fi in graph.funcs.values():
            for call, _l, _c, _held, keys in fi.calls:
                self.call_keys[id(call)] = keys or []
        self.answers: dict[str, bool] = {}
        self.chain: dict[str, tuple] = {}
        self.guard_marker: dict[str, bool] = {}
        self.exposes: dict[str, bool] = {}
        self._build()

    def _build(self) -> None:
        graph = self.graph
        for fi in graph.funcs.values():
            self.guard_marker[fi.key] = _fn_has_guard_marker(fi.node)
            direct = None
            for call, line, _c, _held, _keys in fi.calls:
                name = call_func_name(call)
                if (name in ANSWER_TERMINALS
                        or name in HANDOFF_TERMINALS) and not (
                            _is_control_queue_call(call)):
                    direct = (name,)
                    break
            self.answers[fi.key] = direct is not None
            self.chain[fi.key] = direct or ()
            # Direct exposure: an ANSWER_TERMINAL call in a function
            # with no guard vocabulary anywhere.
            self.exposes[fi.key] = bool(
                not self.guard_marker[fi.key]
                and any(
                    call_func_name(call) in ANSWER_TERMINALS
                    for call, *_ in fi.calls
                )
            )
        changed = True
        guard = 0
        while changed and guard < 60:
            changed = False
            guard += 1
            for fi in graph.funcs.values():
                for call, _l, _c, _held, keys in fi.calls:
                    for key in keys or ():
                        callee = graph.funcs.get(key)
                        if callee is None:
                            continue
                        if self.answers.get(key) and not self.answers[
                                fi.key]:
                            chain = self.chain.get(key, ())
                            if len(chain) < 8:
                                self.answers[fi.key] = True
                                self.chain[fi.key] = (
                                    callee.name,
                                ) + chain
                                changed = True
                        if (
                            self.exposes.get(key)
                            and not self.exposes[fi.key]
                            and not self.guard_marker[fi.key]
                        ):
                            self.exposes[fi.key] = True
                            changed = True

    def is_answer_event(self, call: ast.Call) -> bool:
        name = call_func_name(call)
        if name in ANSWER_TERMINALS or name in HANDOFF_TERMINALS:
            return not _is_control_queue_call(call)
        return any(
            self.answers.get(k) for k in self.call_keys.get(id(call), ())
        )

    def needs_guard(self, call: ast.Call) -> bool:
        """True when this answer event has no exclusivity guard
        anywhere along its own path — a second reply through it cannot
        stand itself down."""
        name = call_func_name(call)
        if name in HANDOFF_TERMINALS:
            return False
        keys = self.call_keys.get(id(call), ())
        if keys:
            resolved = [self.graph.funcs.get(k) for k in keys]
            if name in ANSWER_TERMINALS:
                return any(
                    fi is not None and not self.guard_marker.get(fi.key)
                    for fi in resolved
                )
            return any(self.exposes.get(k) for k in keys)
        return name in ANSWER_TERMINALS


def _answer_state(files) -> _AnswerState:
    graph = get_graph(files)
    state = graph.rule_memo.get("r14_state")
    if state is None:
        state = _AnswerState(graph)
        graph.rule_memo["r14_state"] = state
    return state


# --- ordered event walk ---------------------------------------------------

_ANSWER, _GUARD, _ALT = 0, 1, 2


def _stmt_events(node: ast.AST, state: _AnswerState) -> list:
    """Events inside ONE expression/simple statement, in source order:
    (kind, payload).  Nested function bodies are their own scopes."""
    found = []
    for sub in ast.walk(node):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            continue
        if isinstance(sub, ast.Call) and state.is_answer_event(sub):
            found.append((sub.lineno, sub.col_offset, (_ANSWER, sub)))
    if _has_guard_text(node):
        found.append((node.lineno, -1, (_GUARD, node.lineno)))
    found.sort(key=lambda t: (t[0], t[1]))
    return [ev for _l, _c, ev in found]


def _terminates(stmts) -> bool:
    """A statement list that cannot fall through to the code after its
    If: the function RETURNS before any later answer site runs, so
    answer events inside it can never pair with one below — the fan-in
    admission gates' shed-then-return shape.  A trailing ``raise`` is
    deliberately NOT terminating: it can land in a same-function
    except handler, which is exactly the PR 2 double-reply window the
    Try model pairs body sends with handler sends across."""
    return bool(stmts) and isinstance(stmts[-1], ast.Return)


def _body_events(stmts, state: _AnswerState) -> list:
    out: list = []
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(stmt, ast.If):
            out.extend(_stmt_events(stmt.test, state))
            out.append((_ALT, [
                (_body_events(stmt.body, state),
                 _terminates(stmt.body)),
                (_body_events(stmt.orelse, state),
                 _terminates(stmt.orelse)),
            ]))
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            out.extend(_stmt_events(stmt.iter, state))
            out.extend(_body_events(stmt.body, state))
            out.extend(_body_events(stmt.orelse, state))
        elif isinstance(stmt, ast.While):
            out.extend(_stmt_events(stmt.test, state))
            out.extend(_body_events(stmt.body, state))
            out.extend(_body_events(stmt.orelse, state))
        elif isinstance(stmt, ast.Try):
            out.extend(_body_events(stmt.body, state))
            # Handlers are alternatives of each other but SEQUENTIAL
            # with the body: an exception after the body's send still
            # reaches the handler — exactly the PR 2 double-reply
            # window.
            if stmt.handlers:
                out.append((_ALT, [
                    (_body_events(h.body, state), _terminates(h.body))
                    for h in stmt.handlers
                ] + [([], False)]))
            out.extend(_body_events(stmt.orelse, state))
            out.extend(_body_events(stmt.finalbody, state))
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                out.extend(_stmt_events(item.context_expr, state))
            out.extend(_body_events(stmt.body, state))
        else:
            out.extend(_stmt_events(stmt, state))
    return out


def _walk_pairs(events, opens, state: _AnswerState, findings: list):
    """Sequential double-answer scan: ``opens`` holds answer events not
    yet separated by a guard; a guard clears them; branch alternatives
    fork the state and merge by union."""
    for ev in events:
        if ev[0] == _GUARD:
            opens.clear()
        elif ev[0] == _ALT:
            merged: list = []
            for branch, terminated in ev[1]:
                branch_opens = list(opens)
                _walk_pairs(branch, branch_opens, state, findings)
                if terminated:
                    # The branch returns out of the function: its open
                    # answer events can never meet an answer site below
                    # the If — the admission gates' shed-then-return
                    # bail shape is exclusive by control flow, not by
                    # guard.  (Raise-ending branches are NOT pruned:
                    # they can resume in a same-function handler.)
                    continue
                merged.extend(
                    e for e in branch_opens if e not in merged
                )
            opens[:] = merged
        else:
            call = ev[1]
            if state.needs_guard(call):
                idents = _arg_idents(call)
                for prev in opens:
                    if prev is call:
                        continue
                    if idents & _arg_idents(prev):
                        findings.append((call, prev))
                        break
            if call not in opens:
                opens.append(call)
    return opens


# --- the rule -------------------------------------------------------------

def _own_returns(fn):
    """Return statements of fn's OWN body — nested defs are their own
    scopes and must not contribute returns to the enclosing root."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def check_r14(files):
    state = _answer_state(files)
    graph = state.graph

    for fi in sorted(graph.funcs.values(), key=lambda f: (f.path,
                                                          f.node.lineno)):
        if os.path.basename(fi.path) not in _HOT_BASENAMES:
            continue

        # R14.1 — admit accounting: bare returns with no dominating
        # answer site / typed hand-off in an admit root.
        if _is_admit_root(fi.node.name):
            event_lines = [
                call.lineno for call, *_ in fi.calls
                if state.is_answer_event(call)
            ]
            for node in _own_returns(fi.node):
                bare = node.value is None or (
                    isinstance(node.value, ast.Constant)
                    and node.value.value is None
                )
                if not bare:
                    continue  # value returns are the bail protocol
                if any(line <= node.lineno for line in event_lines):
                    continue
                yield Finding(
                    "R14", fi.path, node.lineno, node.col_offset,
                    "admit path can return without reaching an answer "
                    "site or a typed hand-off: an entry admitted "
                    "through this root is dropped on the floor — no "
                    "SHED, no error verdict, no dispatcher queue — "
                    "and its caller blocks until its own timeout "
                    "(silent-loss class; answer it typed or hand it "
                    "off before bailing)",
                    symbol=fi.qual,
                )

        # R14.2 — answer exclusivity: two answer sites for the same
        # entry with no dominating guard between them.
        events = _body_events(fi.node.body, state)
        pair_findings: list = []
        _walk_pairs(events, [], state, pair_findings)
        seen: set = set()
        for call, prev in pair_findings:
            key = (call.lineno, call.col_offset)
            if key in seen:
                continue
            seen.add(key)
            yield Finding(
                "R14", fi.path, call.lineno, call.col_offset,
                f"second answer site ({call_func_name(call)}) "
                f"reachable for the same entry as "
                f"{call_func_name(prev)} (line {prev.lineno}) with no "
                f"dominating exclusivity guard — no answered-cell "
                f"check, no thread_round_is_shed/deposal check, no "
                f"drain-lock pop anywhere on the path: a double reply "
                f"for one seq desyncs the shim (the PR 2 "
                f"deposed-round bug class)",
                symbol=fi.qual,
            )
