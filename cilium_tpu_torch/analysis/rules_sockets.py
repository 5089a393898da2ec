"""R3 (socket hygiene) and R6 (thread hygiene).

R3 — the PR 2 zombie-service bug class, mechanized.  A bare
``sock.close()`` while ANOTHER thread is blocked in ``accept()`` /
``recv()`` on the same fd does not tear the kernel object down: the
close is deferred until that call returns — which it never does,
because only the teardown would have woken it.  Listeners keep
accepting into a dead service; readers wedge to process exit.  The fix
is always ``shutdown(SHUT_RDWR)`` *then* ``close()`` (see
``utils/sockutil.shutdown_close``).  The rule flags ``X.close()`` on a
socket-typed binding with no dominating ``X.shutdown(...)`` — a
shutdown (or a teardown-helper call taking X) lexically earlier in the
same function.

Socket typing is inferred, not guessed from bare names: a binding is
socket-typed when it is assigned from ``socket.socket(...)`` /
``socket.create_connection(...)`` / an ``accept()`` unpack, or is a
parameter annotated ``socket.socket`` — and attribute names assigned
from any of those anywhere in the tree are socket-typed attributes.

R6 — ``threading.Thread(...)`` without ``daemon=`` and without a local
``join()`` outlives its spawner silently; the conftest leak guard then
fails the whole module instead of the offending site.  Pass
``daemon=True`` (and a ``name=``) or join the thread where it is
spawned.
"""

from __future__ import annotations

import ast

from .core import Finding, call_func_name, unparse, walk_functions

_SOCK_CTORS = {"socket", "create_connection", "socketpair", "fromfd"}
# Helper callables that perform shutdown-then-close on their argument.
_TEARDOWN_HELPERS = ("teardown", "shutdown_close", "reset_conn")


def _is_socket_ctor(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Call)
            and call_func_name(expr) in _SOCK_CTORS)


def _socket_annotated(arg: ast.arg) -> bool:
    ann = arg.annotation
    return ann is not None and "socket" in unparse(ann)


def _socket_attr_names(files) -> set[str]:
    """Attribute names bound to sockets anywhere in the tree: direct
    constructor assigns, accept() unpacks, or assignment from a
    socket-annotated parameter."""
    out: set[str] = set()
    for sf in files.values():
        for fn, _qual, _cls in walk_functions(sf.tree):
            ann_params = {
                a.arg for a in list(fn.args.args)
                + list(fn.args.kwonlyargs) if _socket_annotated(a)
            }
            for node in ast.walk(fn):
                if isinstance(node, ast.AnnAssign):
                    # ``self._socks: dict[str, socket.socket]`` —
                    # socket-typed containers count: their elements
                    # are sockets when iterated.
                    if (isinstance(node.target, ast.Attribute)
                            and node.annotation is not None
                            and "socket" in unparse(node.annotation)):
                        out.add(node.target.attr)
                    continue
                if not isinstance(node, ast.Assign):
                    continue
                value = node.value
                sockety = _is_socket_ctor(value) or (
                    isinstance(value, ast.Name) and value.id in ann_params
                )
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and sockety:
                        out.add(t.attr)
                    if (isinstance(t, ast.Tuple)
                            and isinstance(value, ast.Call)
                            and call_func_name(value) == "accept"
                            and t.elts
                            and isinstance(t.elts[0], ast.Attribute)):
                        out.add(t.elts[0].attr)
    return out


def _local_socket_names(fn, sock_attrs: set[str]) -> set[str]:
    """Locals in ``fn`` that are socket-typed."""
    out = {
        a.arg for a in list(fn.args.args) + list(fn.args.kwonlyargs)
        if _socket_annotated(a)
    }

    def sockety_expr(expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in out
        if isinstance(expr, ast.Attribute):
            return expr.attr in sock_attrs
        return False

    # Iterate to a fixed point: for-loop targets and aliases can chain
    # (``for a, b in conns: ... for s in (a, b): s.close()``).
    changed = True
    while changed:
        changed = False

        def add(name: str) -> None:
            nonlocal changed
            if name not in out:
                out.add(name)
                changed = True

        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                value = node.value
                for t in node.targets:
                    if isinstance(t, ast.Name) and (
                        _is_socket_ctor(value) or sockety_expr(value)
                    ):
                        add(t.id)
                    if (isinstance(t, ast.Tuple)
                            and isinstance(value, ast.Call)
                            and call_func_name(value) == "accept"
                            and t.elts
                            and isinstance(t.elts[0], ast.Name)):
                        add(t.elts[0].id)
            elif isinstance(node, ast.For):
                it = node.iter
                elem_sockety = False
                if isinstance(it, (ast.Tuple, ast.List)):
                    elem_sockety = any(sockety_expr(e) for e in it.elts)
                elif isinstance(it, ast.Call) and call_func_name(
                    it
                ) == "values" and isinstance(it.func, ast.Attribute):
                    elem_sockety = sockety_expr(it.func.value)
                elif sockety_expr(it):
                    # Iterating a socket-typed container attribute
                    # (``for s in self._socks`` / a conns list).
                    elem_sockety = True
                if not elem_sockety:
                    continue
                if isinstance(node.target, ast.Name):
                    add(node.target.id)
                elif isinstance(node.target, ast.Tuple):
                    for e in node.target.elts:
                        if isinstance(e, ast.Name):
                            add(e.id)
    return out


def check_r3(files):
    sock_attrs = _socket_attr_names(files)
    for sf in files.values():
        for fn, qual, _cls in walk_functions(sf.tree):
            sock_locals = _local_socket_names(fn, sock_attrs)

            def is_socket_expr(expr) -> bool:
                if isinstance(expr, ast.Name):
                    return expr.id in sock_locals
                if isinstance(expr, ast.Attribute):
                    return expr.attr in sock_attrs
                return False

            # Lexically-earlier shutdowns / teardown-helper calls, by
            # receiver source.
            shutdown_lines: dict[str, int] = {}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "shutdown"):
                    src = unparse(node.func.value)
                    prev = shutdown_lines.get(src)
                    if prev is None or node.lineno < prev:
                        shutdown_lines[src] = node.lineno
                fname = call_func_name(node)
                if any(h in fname for h in _TEARDOWN_HELPERS):
                    for a in node.args:
                        src = unparse(a)
                        prev = shutdown_lines.get(src)
                        if prev is None or node.lineno < prev:
                            shutdown_lines[src] = node.lineno

            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "close"
                        and not node.args):
                    continue
                recv = node.func.value
                if not is_socket_expr(recv):
                    continue
                src = unparse(recv)
                dom = shutdown_lines.get(src)
                if dom is not None and dom <= node.lineno:
                    continue
                yield Finding(
                    "R3", sf.path, node.lineno, node.col_offset,
                    f"bare {src}.close() with no dominating "
                    f"shutdown(): a thread blocked in accept()/recv() "
                    f"on this socket defers the teardown forever "
                    f"(zombie listener / wedged reader) — use "
                    f"utils.sockutil.shutdown_close",
                    symbol=qual,
                )


# --- R6 -------------------------------------------------------------------

def check_r6(files):
    for sf in files.values():
        for fn, qual, _cls in walk_functions(sf.tree):
            # Locals with a later ``.daemon = True`` or ``.join(...)``.
            daemonized: set[str] = set()
            joined: set[str] = set()
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Attribute)
                        and node.targets[0].attr == "daemon"
                        and isinstance(node.targets[0].value, ast.Name)):
                    daemonized.add(node.targets[0].value.id)
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "join"
                        and isinstance(node.func.value, ast.Name)):
                    joined.add(node.func.value.id)

            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and call_func_name(node) == "Thread"):
                    continue
                if any(kw.arg == "daemon" for kw in node.keywords):
                    continue
                # ``t = Thread(...)`` then ``t.daemon = True`` or a
                # local join both keep the leak guard quiet.
                assigned = _assigned_name(fn, node)
                if assigned and assigned in (daemonized | joined):
                    continue
                yield Finding(
                    "R6", sf.path, node.lineno, node.col_offset,
                    "Thread(...) without daemon= and without a local "
                    "join: survivors hang interpreter exit and trip "
                    "the conftest thread-leak guard module-wide — "
                    "pass daemon=True (and name=) or join locally",
                    symbol=qual,
                )


def _assigned_name(fn, call: ast.Call) -> str | None:
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and node.value is call
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            return node.targets[0].id
    return None
