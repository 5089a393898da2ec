"""R19 — column-store lock discipline over the shared numpy columns.

The declared column families live in ``analysis/protocols.py``
(``COLUMN_STORES``): each maps an attribute-name prefix on an owner
class (the ``_tab_*`` conn table on VerdictService, the ``_grant_*``
rows on SidecarClient) to the ONE lock that owns every write.  Two
halves, both interprocedural over the callgraph engine:

- **Unlocked write**: every write shape that mutates a column —
  subscript store (``self._tab_x[i] = v``), bulk slice assign
  (``self._tab_x[:] = v``), augmented subscript store, ``.fill()``,
  ``np.add.at(self._tab_x, ...)``, and whole-array REBINDS outside
  ``__init__`` (a reallocation racing a lock-free store loses the
  store into the discarded array) — must be reachable only with the
  owning lock held: lexically at the write, or at EVERY project call
  site into the enclosing function (transitively, bounded depth).  A
  function containing an unprotected write with zero scanned callers
  is an unprotected entry point and flags too.
- **Torn snapshot**: a function that reads two or more distinct
  columns of one family under two or more SEPARATE owning-lock
  acquisitions, with no single acquisition covering all of them, can
  observe a row mutated between its lock trips — a multi-column
  snapshot must be taken in one trip.  Deliberately lock-free reads
  (no lock at all) are the data path's publish-order contract and are
  not this rule's business.

``unlocked_ok`` on a family waives the write check with a recorded
justification (the reasm arena is single-writer by construction).
"""

from __future__ import annotations

import ast

from .core import Finding, local_assignments, terminal_name

_WRITE_KINDS = {
    "subscript": "subscript store",
    "aug": "augmented subscript store",
    "fill": ".fill() bulk store",
    "ufunc": "np.add.at scatter store",
    "rebind": "whole-array rebind",
}


def _extract_families(files) -> list[tuple[dict, str, int]]:
    """Every (family dict, path, line) from ``COLUMN_STORES = (...)``
    declarations in the scanned set (all-literal tuples of dicts)."""
    out = []
    for path, sf in sorted(files.items()):
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "COLUMN_STORES"):
                try:
                    rows = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    continue
                for row in rows:
                    if isinstance(row, dict) and row.get("prefix"):
                        out.append((row, path, node.lineno))
    return out


def _self_column(expr: ast.AST, prefix: str) -> str | None:
    """Attribute name when ``expr`` is ``self.<prefix>...``."""
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr.startswith(prefix)):
        return expr.attr
    return None


def _held_has(held, owner: str, lock: str) -> bool:
    want = f"{owner}.{lock}"
    for ident in held:
        if ident == want or ident.split(".")[-1].split(":")[-1] == lock:
            return True
    return False


def _collect_sites(graph, fi, prefix: str, owner: str, lock: str):
    """(writes, read_regions) for one function.

    writes: [(kind, attr, line, col, held_tuple)]
    read_regions: {region_id: set(attrs)} — region_id is a fresh int
    per owning-lock ``with`` block, None outside any owning lock.
    Regions that WRITE a family column are mutation transactions, not
    snapshot assembly — their reads re-validate bounds under the lock
    they already hold — so they are dropped from the read map.
    """
    fn = fi.node
    aliases = local_assignments(fn)
    writes: list = []
    regions: dict = {}
    write_regions: set = set()
    region_seq = [0]

    def note_read(attr: str, region) -> None:
        if region is not None:
            regions.setdefault(region, set()).add(attr)

    def note_write(kind, attr, node, held, region) -> None:
        writes.append((kind, attr, node.lineno, node.col_offset, held))
        if region is not None:
            write_regions.add(region)

    def visit(node, held: tuple, region) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.With):
            taken = list(held)
            inner_region = region
            for item in node.items:
                visit(item.context_expr, tuple(taken), inner_region)
                ident = graph.lock_identity(item.context_expr, fi,
                                            aliases)
                if ident is not None:
                    taken.append(ident)
                    if _held_has((ident,), owner, lock):
                        region_seq[0] += 1
                        inner_region = region_seq[0]
            for stmt in node.body:
                visit(stmt, tuple(taken), inner_region)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    attr = _self_column(t.value, prefix)
                    if attr is not None:
                        note_write("subscript", attr, node, held, region)
                attr = _self_column(t, prefix)
                if attr is not None and fn.name != "__init__":
                    note_write("rebind", attr, node, held, region)
        elif isinstance(node, ast.AugAssign):
            if isinstance(node.target, ast.Subscript):
                attr = _self_column(node.target.value, prefix)
                if attr is not None:
                    note_write("aug", attr, node, held, region)
        elif isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fill"):
                attr = _self_column(node.func.value, prefix)
                if attr is not None:
                    note_write("fill", attr, node, held, region)
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "at"
                    and terminal_name(node.func.value) == "add"
                    and node.args):
                attr = _self_column(node.args[0], prefix)
                if attr is not None:
                    note_write("ufunc", attr, node, held, region)
        elif (isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)):
            attr = _self_column(node, prefix)
            if attr is not None:
                note_read(attr, region)
        for child in ast.iter_child_nodes(node):
            visit(child, held, region)

    for stmt in fn.body:
        visit(stmt, (), None)
    regions = {r: attrs for r, attrs in regions.items()
               if r not in write_regions}
    return writes, regions


def _build_reverse(graph) -> dict:
    """callee key -> [(caller key, held tuple at the call site)]."""
    rev: dict = {}
    for fi in graph.funcs.values():
        for _call, _l, _c, held, keys in fi.calls:
            for key in keys or ():
                rev.setdefault(key, []).append((fi.key, held))
    return rev


def _protected(rev, key: str, owner: str, lock: str,
               depth: int = 0, stack=None) -> bool:
    """True when every scanned call path into ``key`` holds the owning
    lock somewhere above the call.  Zero callers ⇒ unprotected entry."""
    if depth > 4:
        return False
    if stack is None:
        stack = set()
    callers = rev.get(key)
    if not callers:
        return False
    for caller_key, held in callers:
        if _held_has(held, owner, lock):
            continue
        if caller_key in stack:
            continue  # cycle: this path adds no new unlocked entry
        stack.add(caller_key)
        ok = _protected(rev, caller_key, owner, lock, depth + 1, stack)
        stack.discard(caller_key)
        if not ok:
            return False
    return True


def check_r19(files):
    from .callgraph import get_graph

    families = _extract_families(files)
    if not families:
        return
    graph = get_graph(files)
    rev = _build_reverse(graph)

    for fam, _decl_path, _decl_line in families:
        owner = fam.get("owner", "")
        prefix = fam["prefix"]
        lock = fam.get("lock")
        if fam.get("unlocked_ok"):
            continue  # waived with a recorded justification
        if not lock:
            continue
        for fi in sorted(graph.funcs.values(), key=lambda f: f.key):
            if fi.cls != owner:
                continue
            writes, regions = _collect_sites(graph, fi, prefix,
                                             owner, lock)
            for kind, attr, line, col, held in writes:
                if _held_has(held, owner, lock):
                    continue
                if fi.name == "__init__":
                    continue  # construction precedes sharing
                if _protected(rev, fi.key, owner, lock):
                    continue
                yield Finding(
                    "R19", fi.path, line, col,
                    f"{_WRITE_KINDS[kind]} to shared column {attr!r} "
                    f"(family {fam.get('name', prefix)!r}) reachable "
                    f"without owning lock {owner}.{lock} held — "
                    f"lock-free writers race reallocation and "
                    f"multi-column row publication",
                    symbol=fi.qual,
                )
            # -- torn multi-column snapshot across lock trips --------
            if len(regions) >= 2:
                union: set = set()
                for attrs in regions.values():
                    union |= attrs
                if len(union) >= 2 and not any(
                    attrs == union for attrs in regions.values()
                ):
                    yield Finding(
                        "R19", fi.path, fi.node.lineno,
                        fi.node.col_offset,
                        f"torn snapshot: columns {sorted(union)} "
                        f"(family {fam.get('name', prefix)!r}) are "
                        f"read across {len(regions)} separate "
                        f"{owner}.{lock} acquisitions with no single "
                        f"trip covering all of them — a row can "
                        f"mutate between the trips",
                        symbol=fi.qual,
                    )
