"""R1 (lock discipline) and R2 (blocking-under-lock).

R1 encodes the lock invariants PRs 1-2 paid for in review time:

- **R1.1 unpaired acquire** — a blocking ``X.acquire()`` statement must
  have a ``try/finally`` releasing the *same binding* ``X`` in the same
  function.  Try-locks (``blocking=False`` / ``timeout=``) are exempt,
  as are lock-wrapper classes (a class defining ``release`` IS the
  pairing, spanning methods by design).
- **R1.2 re-read-attribute capture** — ``self.X.acquire()`` /
  ``self.X.release()`` where attribute ``X`` is *swapped at runtime*
  (assigned outside ``__init__`` anywhere in the tree).  The exact
  ``_in_process_lock`` deposal bug: the stall watchdog swaps the
  attribute, so release-by-re-read releases a DIFFERENT lock object,
  raising out of the hot path while leaking the held lock.  The fix
  captures the object in a local before acquire (``with self.X:`` is
  safe — the expression is evaluated once).
- **R1.3 lock-order inversion** — lexically nested ``with`` statements
  must not invert the recorded lock-order graph.  Seeded from the
  sidecar session machinery: ``_wlock`` may be held when taking
  ``_down_once`` (client.py _resume), NEVER the reverse — _down_once
  holders run in disconnect callbacks that must not wait behind a
  sendall wedged under ``_wlock``.  Same-lock nesting of a
  non-reentrant lock is self-deadlock and also flagged.

R2 flags blocking calls — socket ops, ``queue.get``, ``Thread.join``,
``sleep``, device readbacks — lexically inside a held-lock ``with``
region.  ``.wait()`` is exempt everywhere: Condition.wait RELEASES the
lock, and flagging it would outlaw the dispatcher's core idiom.
R2.2 flags unbounded spin-waits: a ``while`` polling a shared slot
(subscript condition, or while-True with a subscript-compare break)
with no backoff, blocking call, or deadline — the shared-memory ring
transport's bug shape (its sanctioned shapes are doorbell-driven
consumption or backoff+deadline).

Both rules are WHOLE-PROGRAM since the interprocedural engine
(``analysis/callgraph.py``) landed:

- **R1.4 call-mediated lock-order graph** — every observed nesting,
  lexical or through a call chain, contributes an edge
  ``(held, taken)`` to a project-wide graph over QUALIFIED lock
  identities (``Cls._lock`` / ``module:name``).  Flagged: an edge
  inverting the recorded LOCK_ORDER, a pair of opposite edges observed
  anywhere in the project (a cross-module deadlock cycle — each end
  may look locally sane), and a call chain that re-acquires a
  non-reentrant lock already held at the call site.
- **R2 taint** — a call made under a held lock whose callee
  TRANSITIVELY blocks (through helpers like ``utils.sockutil``) is the
  same stall as a lexical ``sendall`` under the lock; the finding
  names the helper chain.
"""

from __future__ import annotations

import ast

from .callgraph import get_graph
from .core import (
    Finding,
    call_func_name,
    is_lock_like_expr,
    is_lock_like_name,
    local_assignments,
    lock_terminal,
    unparse,
    walk_functions,
)

# Recorded lock-order graph: (outer, inner) pairs that are LEGAL; taking
# `outer` while already holding `inner` is an inversion.  Seeded from
# sidecar/client.py (_resume nests _down_once inside _wlock; _down_once
# holders never take _wlock).
LOCK_ORDER: set[tuple[str, str]] = {
    ("_wlock", "_down_once"),
}

# Functions that ARE lock implementations or guards: the
# acquire/release pairing intentionally spans call boundaries there.
_WRAPPER_FUNCS = {
    "acquire", "release", "r_acquire", "r_release",
    "__enter__", "__exit__", "locked", "read",
}


def _class_defines_release(cls: ast.ClassDef | None) -> bool:
    if cls is None:
        return False
    return any(
        isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name in ("release", "r_release")
        for n in cls.body
    )


def _own_nodes(root: ast.AST):
    """``ast.walk`` limited to the function's OWN body: nested
    defs/lambdas are separate functions (walk_functions yields them on
    their own), so a finally-release tucked inside a closure must not
    satisfy the enclosing function's acquire pairing — the closure may
    never run on the exception path."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_try_lock(call: ast.Call) -> bool:
    if any(kw.arg in ("blocking", "timeout") for kw in call.keywords):
        return True
    return bool(call.args)  # acquire(<blocking/timeout expr>)


def _swappable_lock_attrs(files) -> set[str]:
    """Lock-like attribute names assigned ANYWHERE outside __init__ —
    the attributes a concurrent swap can re-point between an acquire
    and a re-read release."""
    out: set[str] = set()
    for sf in files.values():
        for fn, _qual, _cls in walk_functions(sf.tree):
            if fn.name == "__init__":
                continue
            for node in ast.walk(fn):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and is_lock_like_name(t.attr)):
                        out.add(t.attr)
    return out


def _reentrant_names(files) -> set[str]:
    """Attribute/local names bound to threading.RLock() anywhere —
    exempt from the same-lock-nesting check."""
    out: set[str] = set()
    for sf in files.values():
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ) and call_func_name(node.value) == "RLock":
                for t in node.targets:
                    name = (t.attr if isinstance(t, ast.Attribute)
                            else t.id if isinstance(t, ast.Name) else "")
                    if name:
                        out.add(name)
    return out


def check_r1(files):
    swappable = _swappable_lock_attrs(files)
    reentrant = _reentrant_names(files)
    for sf in files.values():
        for fn, qual, cls in walk_functions(sf.tree):
            if fn.name in _WRAPPER_FUNCS or _class_defines_release(cls):
                continue
            aliases = local_assignments(fn)
            yield from _r1_acquire_pairing(sf, fn, qual, aliases,
                                           swappable)
            yield from _r1_with_order(sf, fn, qual, aliases, reentrant)
    yield from _r1_lock_graph(files, reentrant)


def _r1_acquire_pairing(sf, fn, qual, aliases, swappable):
    finally_released: set[str] = set()
    for node in _own_nodes(fn):
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                for sub in _own_nodes(stmt):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "release"):
                        finally_released.add(unparse(sub.func.value))

    for node in _own_nodes(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        recv = node.func.value
        if node.func.attr == "acquire":
            if not is_lock_like_expr(recv, aliases):
                continue
            if (isinstance(recv, ast.Attribute)
                    and recv.attr in swappable):
                yield Finding(
                    "R1", sf.path, node.lineno, node.col_offset,
                    f"acquire on swappable lock attribute "
                    f"{recv.attr!r} (assigned outside __init__): "
                    f"capture the lock object in a local first, or a "
                    f"concurrent swap makes the paired release free a "
                    f"DIFFERENT lock (the _in_process_lock deposal "
                    f"bug)",
                    symbol=qual,
                )
            if _is_try_lock(node):
                continue
            if unparse(recv) not in finally_released:
                yield Finding(
                    "R1", sf.path, node.lineno, node.col_offset,
                    f"blocking {unparse(recv)}.acquire() without a "
                    f"try/finally release of the same binding in this "
                    f"function — an exception between acquire and "
                    f"release leaks the lock",
                    symbol=qual,
                )
        elif node.func.attr == "release":
            if (isinstance(recv, ast.Attribute)
                    and recv.attr in swappable):
                yield Finding(
                    "R1", sf.path, node.lineno, node.col_offset,
                    f"release re-reads swappable lock attribute "
                    f"{recv.attr!r}: if the attribute was swapped "
                    f"while held (stall-watchdog deposal), this "
                    f"releases a different lock and raises with the "
                    f"real lock still held — release the binding "
                    f"captured at acquire instead",
                    symbol=qual,
                )


def _r1_with_order(sf, fn, qual, aliases, reentrant):
    findings: list[Finding] = []

    def handle_with(node: ast.With, held: list[str]) -> None:
        taken = []
        for item in node.items:
            expr = item.context_expr
            if not is_lock_like_expr(expr, aliases):
                continue
            name = lock_terminal(expr, aliases)
            # ``with a, b:`` nests b inside a — earlier items of the
            # same statement count as held for the later ones.
            effective = held + taken
            if name in effective and name not in reentrant:
                findings.append(Finding(
                    "R1", sf.path, node.lineno, node.col_offset,
                    f"nested re-acquire of non-reentrant lock "
                    f"{name!r} — self-deadlock",
                    symbol=qual,
                ))
            for h in effective:
                if (name, h) in LOCK_ORDER:
                    findings.append(Finding(
                        "R1", sf.path, node.lineno, node.col_offset,
                        f"lock-order inversion: taking {name!r} while "
                        f"holding {h!r} inverts the recorded order "
                        f"{name!r} outside {h!r} — deadlocks against "
                        f"the legal nesting",
                        symbol=qual,
                    ))
            taken.append(name)
        for stmt in node.body:
            walk(stmt, held + taken)

    def walk(node: ast.AST, held: list[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # analyzed under their own (empty) stack
        if isinstance(node, ast.With):
            handle_with(node, held)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for stmt in fn.body:
        walk(stmt, [])
    yield from findings


# --- R1.4 whole-program lock-order graph ----------------------------------

def _r1_lock_graph(files, reentrant):
    """Project-wide lock-order edges over qualified identities.

    An edge ``(A, B)`` means "B was taken (directly or through a call
    chain) while A was held".  Three findings:

    - a CALL-MEDIATED edge inverting the recorded LOCK_ORDER (the
      lexical case is R1.3's);
    - opposite edges ``(A, B)`` and ``(B, A)`` observed anywhere in the
      scanned set — the classic distributed deadlock, each half locally
      sane, often in different modules;
    - a call chain that re-acquires a non-reentrant lock already held
      at the call site (self-deadlock through a helper).
    """
    graph = get_graph(files)
    # (outer_ident, inner_ident) -> [(path,line,col,qual,chain|None)]
    edges: dict[tuple[str, str], list] = {}

    def add_edge(outer, inner, site):
        edges.setdefault((outer, inner), []).append(site)

    for fi in graph.funcs.values():
        if fi.name in _WRAPPER_FUNCS:
            continue
        # Lexical nestings come straight from the graph's function
        # summaries (ONE With-walker, shared with the taint pass) and
        # feed the global graph so a cross-FILE opposite nesting
        # pairs up.
        for outer, inner, line, col in fi.lex_nestings:
            add_edge(outer, inner, (fi.path, line, col, fi.qual, None))

        # Call-mediated acquisitions under a held lock.
        for _call, line, col, held, keys in fi.calls:
            if not held:
                continue
            for key in keys or ():
                callee = graph.funcs.get(key)
                if callee is None:
                    continue
                for ident, chain in callee.t_acquires.items():
                    via = (key,) + chain
                    for h in held:
                        add_edge(h, ident,
                                 (fi.path, line, col, fi.qual, via))

    emitted: set = set()

    def emit(path, line, col, qual, msg):
        k = (path, line, col, msg[:60])
        if k in emitted:
            return None
        emitted.add(k)
        return Finding("R1", path, line, col, msg, symbol=qual)

    term = graph.lock_terminal_of
    for (outer, inner), sites in sorted(edges.items()):
        # recorded-order inversion through a call chain
        if (term(inner), term(outer)) in LOCK_ORDER and outer != inner:
            for path, line, col, qual, via in sites:
                if via is None:
                    continue  # lexical: R1.3 already owns it
                f = emit(
                    path, line, col, qual,
                    f"lock-order inversion via call chain "
                    f"{graph.chain_text(via)}: the chain acquires "
                    f"{term(inner)!r} while {term(outer)!r} is held "
                    f"here, inverting the recorded order "
                    f"{term(inner)!r} outside {term(outer)!r}",
                )
                if f:
                    yield f
            continue
        # self-deadlock through a helper
        if outer == inner and term(inner) not in reentrant:
            for path, line, col, qual, via in sites:
                if via is None:
                    continue  # lexical same-lock nesting is R1.3's
                f = emit(
                    path, line, col, qual,
                    f"call chain {graph.chain_text(via)} re-acquires "
                    f"non-reentrant lock {term(inner)!r} already held "
                    f"at this call site — self-deadlock through the "
                    f"helper",
                )
                if f:
                    yield f
            continue
        # opposite edges observed anywhere in the project
        rev = edges.get((inner, outer))
        if rev and outer != inner and outer < inner:
            for direction, dsites in (((outer, inner), sites),
                                      ((inner, outer), rev)):
                for path, line, col, qual, via in dsites:
                    how = (
                        f"via call chain {graph.chain_text(via)} "
                        if via else ""
                    )
                    f = emit(
                        path, line, col, qual,
                        f"lock-order cycle: {term(direction[1])!r} is "
                        f"taken {how}while {term(direction[0])!r} is "
                        f"held here, and the OPPOSITE nesting "
                        f"({term(direction[0])!r} inside "
                        f"{term(direction[1])!r}) is also reachable in "
                        f"this tree — two threads on the two paths "
                        f"deadlock",
                    )
                    if f:
                        yield f


# --- R2 -------------------------------------------------------------------

_SOCKET_BLOCKING = {
    "recv", "recv_into", "recvfrom", "accept", "connect", "connect_ex",
    "sendall", "create_connection",
    # The repo's frame-write primitive (wire.send_msg) is a sendall.
    "send_msg",
}
_DEVICE_BLOCKING = {"block_until_ready", "device_put", "device_get"}


def _blocking_reason(call: ast.Call) -> str | None:
    name = call_func_name(call)
    if name in _SOCKET_BLOCKING:
        return f"socket {name}()"
    if name in _DEVICE_BLOCKING:
        return f"device {name}()"
    if name == "sleep":
        return "sleep()"
    if isinstance(call.func, ast.Attribute):
        if name == "join":
            if isinstance(call.func.value, ast.Constant):
                return None  # "sep".join(...)
            if not call.args:
                return "join()"  # thread/queue join (kwargs-only)
            return None
        if name == "get":
            if not call.args and not call.keywords:
                return "queue get()"
            if any(kw.arg in ("timeout", "block")
                   for kw in call.keywords):
                return "queue get()"
            if (call.args
                    and isinstance(call.args[0], ast.Constant)
                    and call.args[0].value is True):
                return "queue get(True)"
    return None


# --- R2.2 spin-wait -------------------------------------------------------
#
# The shared-memory ring transport (sidecar/shm.py) made this bug shape
# reachable: an unbounded ``while`` that polls a shared slot — a
# subscript read in the loop condition, or a ``while True`` whose only
# exit compares a subscripted read — without yielding (sleep / wait /
# a blocking recv) and without bounding the wait (deadline / timeout /
# retry budget).  Under the GIL a spinning consumer actively STARVES
# the producer it waits on; the sanctioned shapes are doorbell-driven
# consumption (no wait at all) or a backoff loop with a deadline.

_SPIN_YIELDING = {
    "sleep", "wait", "recv", "recv_into", "recv_msg", "accept", "get",
    "select", "poll", "acquire", "join", "backoff",
}
_SPIN_BOUND_HINTS = (
    "deadline", "timeout", "budget", "remaining", "retries", "attempts",
    "waited", "tries",
)


def _spin_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def _spin_bounded(node) -> bool:
    return any(
        any(h in name.lower() for h in _SPIN_BOUND_HINTS)
        for name in _spin_names(node)
    )


def _spin_yields(body_nodes) -> bool:
    for node in body_nodes:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and (
                call_func_name(sub) in _SPIN_YIELDING
            ):
                return True
    return False


def _subscript_bases(node) -> set[str]:
    """Terminal base names of Subscript LOADS in ``node``."""
    out: set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Subscript) and isinstance(sub.ctx, ast.Load):
            base = sub.value
            while isinstance(base, ast.Subscript):
                base = base.value
            name = (base.attr if isinstance(base, ast.Attribute)
                    else base.id if isinstance(base, ast.Name) else "")
            if name:
                out.add(name)
    return out


def _body_mutates(body_nodes, bases: set[str]) -> bool:
    """True when the loop body writes/mutates any polled base — the
    loop is making its own progress (growing a list, compacting a
    buffer), not waiting on another thread."""
    for node in body_nodes:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target]
                           if isinstance(sub, ast.AugAssign)
                           else sub.targets)
                for t in targets:
                    while isinstance(t, ast.Subscript):
                        t = t.value
                    name = (t.attr if isinstance(t, ast.Attribute)
                            else t.id if isinstance(t, ast.Name) else "")
                    if name in bases:
                        return True
            elif (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)):
                recv = sub.func.value
                name = (recv.attr if isinstance(recv, ast.Attribute)
                        else recv.id if isinstance(recv, ast.Name)
                        else "")
                if name in bases:
                    return True  # method call on the polled object
    return False


def _while_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _r2_spin_wait(files):
    for sf in files.values():
        for fn, qual, _cls in walk_functions(sf.tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.While):
                    continue
                bases = _subscript_bases(node.test)
                if not bases and _while_true(node.test):
                    # while True whose ONLY exits are subscript-compare
                    # breaks: the poll moved into the body.
                    for sub in node.body:
                        for inner in ast.walk(sub):
                            if (isinstance(inner, ast.If)
                                    and any(isinstance(s, ast.Break)
                                            for s in inner.body)):
                                bases |= _subscript_bases(inner.test)
                if not bases:
                    continue
                scope = [node.test, *node.body]
                if _spin_yields(scope):
                    continue
                if any(_spin_bounded(s) for s in scope):
                    continue
                if _body_mutates(node.body, bases):
                    continue
                yield Finding(
                    "R2", sf.path, node.lineno, node.col_offset,
                    f"unbounded spin-wait polling shared slot(s) "
                    f"{sorted(bases)} with no backoff, blocking call, "
                    f"or deadline — under the GIL a spinning consumer "
                    f"starves the very producer it waits on; use "
                    f"doorbell-driven consumption or a "
                    f"backoff+deadline loop",
                    symbol=qual,
                )


def check_r2(files):
    yield from _r2_spin_wait(files)
    for sf in files.values():
        for fn, qual, cls in walk_functions(sf.tree):
            if fn.name in _WRAPPER_FUNCS or _class_defines_release(cls):
                continue
            aliases = local_assignments(fn)
            findings: list[Finding] = []

            def walk(node, lock_name, findings=findings,
                     aliases=aliases, sf=sf, qual=qual):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                    return
                if isinstance(node, ast.With):
                    inner = lock_name
                    for item in node.items:
                        if is_lock_like_expr(item.context_expr, aliases):
                            inner = lock_terminal(item.context_expr,
                                                  aliases)
                    for stmt in node.body:
                        walk(stmt, inner)
                    return
                if lock_name is not None and isinstance(node, ast.Call):
                    reason = _blocking_reason(node)
                    if reason is not None:
                        findings.append(Finding(
                            "R2", sf.path, node.lineno, node.col_offset,
                            f"blocking {reason} while holding "
                            f"{lock_name!r} — stalls every thread "
                            f"contending on the lock for the full "
                            f"wait",
                            symbol=qual,
                        ))
                for child in ast.iter_child_nodes(node):
                    walk(child, lock_name)

            for stmt in fn.body:
                walk(stmt, None)
            yield from findings
    yield from _r2_taint(files)


def _r2_taint(files):
    """Blocking-call taint through helpers: a call under a held lock
    whose callee TRANSITIVELY blocks is the same stall as a lexical
    sendall under the lock — the helper boundary must not launder it.
    Directly-blocking calls are the lexical rule's; this pass only
    fires when the blocking site is at least one call away."""
    graph = get_graph(files)
    for fi in graph.funcs.values():
        # Same exemptions as the lexical rule: lock wrappers and
        # lock-implementation classes pair/block by design.
        if fi.name in _WRAPPER_FUNCS:
            continue
        if _class_defines_release(fi.cls_node):
            continue
        for call, line, col, held, keys in fi.calls:
            if not held:
                continue
            if _blocking_reason(call) is not None:
                continue  # lexical R2 already flags it here
            for key in keys or ():
                callee = graph.funcs.get(key)
                if callee is None or callee.blocks_via is None:
                    continue
                chain, reason = callee.blocks_via
                via = (key,) + chain
                yield Finding(
                    "R2", fi.path, line, col,
                    f"call while holding "
                    f"{graph.lock_terminal_of(held[-1])!r} blocks via "
                    f"helper chain {graph.chain_text(via)} "
                    f"({reason}) — every thread contending on the "
                    f"lock stalls for the full wait",
                    symbol=fi.qual,
                )
                break  # one finding per call site is plenty
