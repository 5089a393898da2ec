"""R18 — declared typestates: every state-field store is a declared,
mediated edge and every edge's site emits its declared typed outcome.

The transition tables live in ``analysis/protocols.py`` as
``Typestate(...)`` declarations the RUNTIME imports (one definition:
delete an edge and the runtime raises at the transition while this
pass flags the now-invalid site).  This rule extracts every Typestate
declaration from the scanned set — so a two-file corpus twin carrying
its own table exercises the same machinery the real tree does — and
proves three layers:

- **Table well-formedness**: the initial state is declared, every edge
  endpoint is declared, and every non-initial state keeps at least one
  in-edge (a state whose in-edges were all deleted is unreachable —
  every ``advance`` toward it is statically dead and the runtime would
  raise on the first attempt).
- **Store mediation**: an assignment to a bound state field (``attr``
  kind: ``obj.field = ...``; ``column``: ``self.field[...] = ...`` /
  ``self.field.fill(...)``; ``key``: ``row["field"] = ...``) must take
  its RHS from ``<PROTO>.advance/guard/require_edges(...)`` — the one
  expression shape that validates the edge at runtime.  The only bare
  store allowed is ``__init__`` assigning the declared initial state.
- **Edge + outcome validation at call sites**: every mediation call's
  named states must be declared, every named edge must exist, and when
  the declared outcome of the edge(s) is typed (non-None), at least
  one acceptable outcome token (metric class, counter attribute, or
  literal) must appear in the enclosing function — a silent transition
  on a counted edge is the hand-found bug class PRs 11-17 kept
  shipping.

Binding is conservative: a store binds to a protocol only when the
file also references the protocol object or one of its state
constants, so an unrelated ``self.state = ...`` in a module that never
touches the protocol stays out of scope (precision over recall).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field as _dc_field

from .core import Finding, terminal_name, walk_functions

_MEDIATORS = {"advance", "guard", "require_edges"}


@dataclass
class _Proto:
    obj: str  # assigned object name (e.g. SESSION_PROTOCOL)
    path: str
    line: int
    col: int
    name: str = ""
    owner: str = ""
    field: str = ""
    kind: str = "attr"
    states: tuple = ()
    initial: object = None
    edges: dict = _dc_field(default_factory=dict)  # (frm, to) -> outcome
    values: dict = _dc_field(default_factory=dict)  # state -> stored value
    state_names: set = _dc_field(default_factory=set)  # constant NAMES


def _const_pool(tree: ast.Module) -> dict[str, object]:
    """Module-level ``NAME = <str|int constant>`` assignments."""
    pool: dict[str, object] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, (str, int))
                and not isinstance(node.value.value, bool)):
            pool[node.targets[0].id] = node.value.value
    return pool


def _resolve(expr: ast.AST, pool: dict) -> object:
    """Constant value of a Name (via the pool) or Constant; else a
    sentinel."""
    if isinstance(expr, ast.Constant):
        return expr.value
    if isinstance(expr, ast.Name):
        return pool.get(expr.id, _UNRESOLVED)
    return _UNRESOLVED


_UNRESOLVED = object()


def _resolve_states(expr: ast.AST, pool: dict) -> list:
    """State names an expression may take: Constant/Name resolve to
    one; an IfExp contributes both branches (the mesh ladder's
    ``FULL if target is full else RESHAPED`` site)."""
    if isinstance(expr, ast.IfExp):
        return (_resolve_states(expr.body, pool)
                + _resolve_states(expr.orelse, pool))
    got = _resolve(expr, pool)
    return [] if got is _UNRESOLVED else [got]


def _outcome_of(expr: ast.AST, pool: dict) -> object:
    """Declared outcome: None, a token string, or a tuple of tokens."""
    if isinstance(expr, ast.Constant):
        return expr.value  # str or None
    if isinstance(expr, (ast.Tuple, ast.List)):
        toks = []
        for e in expr.elts:
            got = _resolve(e, pool)
            if isinstance(got, str):
                toks.append(got)
        return tuple(toks)
    got = _resolve(expr, pool)
    return got if isinstance(got, str) else None


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _pools(files) -> dict[str, dict]:
    """Per-path constant pools, each merged over the whole scanned
    set with the file's OWN module-level constants taking precedence:
    the runtime imports its state constants from protocols.py, so a
    consumer file resolves SESSION_ACTIVE through the defining file's
    pool (and a corpus twin redefining the name locally wins)."""
    own = {path: _const_pool(sf.tree) for path, sf in files.items()}
    merged_all: dict[str, object] = {}
    for path in sorted(own):
        merged_all.update(own[path])
    out: dict[str, dict] = {}
    for path, pool in own.items():
        m = dict(merged_all)
        m.update(pool)
        out[path] = m
    return out


def _extract_protocols(files, pools) -> tuple[list[_Proto], list[Finding]]:
    """Every ``NAME = Typestate(...)`` declaration in the scanned set,
    plus the well-formedness findings for malformed tables."""
    protos: list[_Proto] = []
    bad: list[Finding] = []
    for path, sf in sorted(files.items()):
        pool = pools[path]
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and terminal_name(node.value.func) == "Typestate"):
                continue
            call = node.value
            p = _Proto(obj=node.targets[0].id, path=path,
                       line=node.lineno, col=node.col_offset)
            name_e = _kw(call, "name")
            p.name = (_resolve(name_e, pool)
                      if name_e is not None else p.obj)
            if not isinstance(p.name, str):
                p.name = p.obj
            for attr in ("owner", "field", "kind"):
                e = _kw(call, attr)
                got = _resolve(e, pool) if e is not None else _UNRESOLVED
                if isinstance(got, str):
                    setattr(p, attr, got)
            states_e = _kw(call, "states")
            states: list = []
            if isinstance(states_e, (ast.Tuple, ast.List)):
                for e in states_e.elts:
                    got = _resolve(e, pool)
                    if got is _UNRESOLVED:
                        bad.append(Finding(
                            "R18", path, e.lineno, e.col_offset,
                            f"typestate {p.name!r}: unresolvable state "
                            f"expression (states must be string "
                            f"constants or module-level constant names)",
                        ))
                        continue
                    states.append(got)
                    if isinstance(e, ast.Name):
                        p.state_names.add(e.id)
            p.states = tuple(states)
            init_e = _kw(call, "initial")
            p.initial = (_resolve(init_e, pool)
                         if init_e is not None else _UNRESOLVED)
            if isinstance(init_e, ast.Name):
                p.state_names.add(init_e.id)
            edges_e = _kw(call, "edges")
            if isinstance(edges_e, ast.Dict):
                for k, v in zip(edges_e.keys, edges_e.values):
                    if not (isinstance(k, (ast.Tuple, ast.List))
                            and len(k.elts) == 2):
                        continue
                    frm = _resolve(k.elts[0], pool)
                    to = _resolve(k.elts[1], pool)
                    if frm is _UNRESOLVED or to is _UNRESOLVED:
                        bad.append(Finding(
                            "R18", path, k.lineno, k.col_offset,
                            f"typestate {p.name!r}: unresolvable edge "
                            f"endpoint",
                        ))
                        continue
                    for e in k.elts:
                        if isinstance(e, ast.Name):
                            p.state_names.add(e.id)
                    p.edges[(frm, to)] = _outcome_of(v, pool)
            values_e = _kw(call, "values")
            if isinstance(values_e, ast.Dict):
                for k, v in zip(values_e.keys, values_e.values):
                    ks = _resolve(k, pool)
                    vs = _resolve(v, pool)
                    if ks is not _UNRESOLVED and vs is not _UNRESOLVED:
                        p.values[ks] = vs
            else:
                p.values = {s: s for s in p.states}
            # -- table well-formedness --------------------------------
            sset = set(p.states)
            if p.initial is _UNRESOLVED or p.initial not in sset:
                bad.append(Finding(
                    "R18", path, p.line, p.col,
                    f"typestate {p.name!r}: initial state is not in "
                    f"the declared state set",
                ))
            for (frm, to) in sorted(p.edges, key=repr):
                if frm not in sset or to not in sset:
                    bad.append(Finding(
                        "R18", path, p.line, p.col,
                        f"typestate {p.name!r}: edge ({frm!r} -> "
                        f"{to!r}) names an undeclared state",
                    ))
            reachable = {to for (_f, to) in p.edges}
            for s in p.states:
                if s != p.initial and s not in reachable:
                    bad.append(Finding(
                        "R18", path, p.line, p.col,
                        f"typestate {p.name!r}: state {s!r} has no "
                        f"in-edge — unreachable (every advance toward "
                        f"it is statically dead and would raise at "
                        f"runtime)",
                    ))
            protos.append(p)
    return protos, bad


def _file_identifiers(tree: ast.Module) -> set[str]:
    ids: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            ids.add(node.id)
        elif isinstance(node, ast.Attribute):
            ids.add(node.attr)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                ids.add(a.asname or a.name.split(".")[0])
    return ids


def _fn_tokens(fn: ast.AST) -> set[str]:
    """Outcome-token pool of a function body: attribute names,
    bare names, and string literals (a typed metric class, a counter
    attribute, or a reason label all count as emitting the outcome)."""
    toks: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            toks.add(node.id)
        elif isinstance(node, ast.Attribute):
            toks.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            toks.add(node.value)
    return toks


def _own_nodes(fn: ast.AST):
    """Walk a function body without descending into nested defs (each
    nested def is visited as its own function by walk_functions)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _mediation_call(expr: ast.AST, objs: set[str]) -> tuple | None:
    """(obj_name, method, call) when expr is
    ``<declared protocol>.advance/guard/require_edges(...)``."""
    if (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr in _MEDIATORS):
        recv = terminal_name(expr.func.value)
        if recv in objs:
            return recv, expr.func.attr, expr
    return None


def _store_matches(node: ast.AST, proto: _Proto):
    """(rhs, line, col) when ``node`` stores to this protocol's field
    in its declared AST shape; None otherwise."""
    if proto.kind == "attr":
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and t.attr == proto.field):
                    return node.value, node.lineno, node.col_offset
        if (isinstance(node, ast.AugAssign)
                and isinstance(node.target, ast.Attribute)
                and node.target.attr == proto.field):
            return node.value, node.lineno, node.col_offset
    elif proto.kind == "column":
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Attribute)
                        and t.value.attr == proto.field):
                    return node.value, node.lineno, node.col_offset
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "fill"
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == proto.field
                and node.args):
            return node.args[0], node.lineno, node.col_offset
    elif proto.kind == "key":
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)
                        and t.slice.value == proto.field):
                    return node.value, node.lineno, node.col_offset
    return None


def _check_mediation_args(proto: _Proto, method: str, call: ast.Call,
                          pool: dict, fn_tokens: set, path: str):
    """Edge/state validation + outcome-token requirement for one
    mediation call against its protocol."""
    sset = set(proto.states)
    line, col = call.lineno, call.col_offset

    def token_required(edges_used: list):
        """Yield a finding when every possible edge is typed and no
        acceptable token appears in the enclosing function."""
        outcomes = [proto.edges[e] for e in edges_used
                    if e in proto.edges]
        if not outcomes or any(o is None for o in outcomes):
            return  # a declared-silent edge is possible: no demand
        acceptable: set[str] = set()
        for o in outcomes:
            acceptable.update((o,) if isinstance(o, str) else o)
        if not acceptable & fn_tokens:
            yield Finding(
                "R18", path, line, col,
                f"typestate {proto.name!r}: transition site emits "
                f"none of its declared outcome token(s) "
                f"{sorted(acceptable)} — a silent transition on a "
                f"counted edge",
            )

    if method == "advance":
        if len(call.args) < 2:
            return
        for to in _resolve_states(call.args[1], pool):
            if to not in sset:
                yield Finding(
                    "R18", path, line, col,
                    f"typestate {proto.name!r}: advance to undeclared "
                    f"state {to!r}",
                )
                continue
            in_edges = [e for e in proto.edges if e[1] == to]
            if not in_edges:
                yield Finding(
                    "R18", path, line, col,
                    f"typestate {proto.name!r}: advance to state "
                    f"{to!r} which has NO declared in-edge — this "
                    f"site always raises at runtime",
                )
                continue
            yield from token_required(in_edges)
    elif method == "guard":
        if len(call.args) < 2:
            return
        frms = _resolve_states(call.args[0], pool)
        tos = _resolve_states(call.args[1], pool)
        for frm in frms:
            for to in tos:
                if frm not in sset or to not in sset:
                    yield Finding(
                        "R18", path, line, col,
                        f"typestate {proto.name!r}: guard names "
                        f"undeclared state ({frm!r} -> {to!r})",
                    )
                elif (frm, to) not in proto.edges:
                    yield Finding(
                        "R18", path, line, col,
                        f"typestate {proto.name!r}: guard names "
                        f"undeclared edge {frm!r} -> {to!r} — this "
                        f"site always raises at runtime",
                    )
                else:
                    yield from token_required([(frm, to)])
    elif method == "require_edges":
        if len(call.args) < 2:
            return
        frms_e = call.args[0]
        frms: list = []
        if isinstance(frms_e, (ast.Tuple, ast.List)):
            for e in frms_e.elts:
                frms.extend(_resolve_states(e, pool))
        tos = _resolve_states(call.args[1], pool)
        for to in tos:
            for frm in frms:
                if frm not in sset or to not in sset:
                    yield Finding(
                        "R18", path, line, col,
                        f"typestate {proto.name!r}: require_edges "
                        f"names undeclared state ({frm!r} -> {to!r})",
                    )
                elif (frm, to) not in proto.edges:
                    yield Finding(
                        "R18", path, line, col,
                        f"typestate {proto.name!r}: require_edges "
                        f"names undeclared edge {frm!r} -> {to!r} — "
                        f"this site always raises at runtime",
                    )
                else:
                    yield from token_required([(frm, to)])


def check_r18(files):
    pools = _pools(files)
    protos, bad = _extract_protocols(files, pools)
    yield from bad
    if not protos:
        return
    objs = {p.obj for p in protos}
    by_obj = {p.obj: p for p in protos}

    for path, sf in sorted(files.items()):
        pool = pools[path]
        ids = _file_identifiers(sf.tree)
        bound = [
            p for p in protos
            if p.obj in ids or (p.state_names & ids)
        ]
        if not bound:
            continue
        for fn, qual, _cls in walk_functions(sf.tree):
            if isinstance(fn, ast.Lambda):
                continue
            tokens = None  # computed lazily: most functions need none
            for node in _own_nodes(fn):
                # -- mediation-call validation (stores AND bare
                #    validation calls, e.g. the derived mesh ladder) --
                med = _mediation_call(node, objs)
                if med is not None:
                    obj, method, call = med
                    if tokens is None:
                        tokens = _fn_tokens(fn)
                    yield from _check_mediation_args(
                        by_obj[obj], method, call, pool, tokens, path
                    )
                # -- store mediation ---------------------------------
                candidates = []
                hit = None
                for p in bound:
                    got = _store_matches(node, p)
                    if got is not None:
                        candidates.append(p)
                        hit = got
                if not candidates:
                    continue
                rhs, line, col = hit
                ok = False
                for p in candidates:
                    med = _mediation_call(rhs, {p.obj})
                    if med is not None:
                        ok = True
                        break
                    if fn.name == "__init__":
                        init_vals = {
                            p.values.get(p.initial), p.initial,
                        }
                        got = _resolve(rhs, pool)
                        if got is not _UNRESOLVED and got in init_vals:
                            ok = True
                            break
                if not ok:
                    names = ", ".join(
                        sorted(p.name for p in candidates)
                    )
                    yield Finding(
                        "R18", path, line, col,
                        f"bare store to typestate field "
                        f"{candidates[0].field!r} (protocol {names}): "
                        f"transitions must route through "
                        f"<PROTOCOL>.advance/guard/require_edges so "
                        f"the declared edge set is enforced at "
                        f"runtime (only __init__ may assign the "
                        f"initial state directly)",
                        symbol=qual,
                    )
