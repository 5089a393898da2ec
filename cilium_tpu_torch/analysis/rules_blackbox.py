"""R22 — fail-closed flight-recorder coverage against ``FAIL_CLOSED``.

R18 proves every typestate store is a declared, mediated edge; this
pass proves the declared FAIL-CLOSED surface is *observable*: every
row of ``analysis/protocols.py::FAIL_CLOSED`` must be a real row (a
declared table + edge for ``kind="edge"``, a token for
``kind="marker"``) AND must reach a recorder emit site somewhere in
the scanned set — a fail-closed transition the flight recorder can
never capture produces no incident timeline and no postmortem bundle,
which is exactly the blind spot the recorder exists to close.

Emit-site resolution per kind:

- **edge** rows ride the ``Typestate.advance/guard/require_edges``
  choke point (the transition observer hooks mediation itself), so an
  edge is covered when some mediated call on its protocol object can
  take it: an ``advance`` whose resolved target state is the edge's
  ``to`` (the from-state is runtime data — any advance into ``to``
  can record the edge), or a ``guard``/``require_edges`` naming the
  exact ``(frm, to)`` pair.
- **marker** rows are recorded explicitly, so the token string must
  appear as the first argument of a ``record_mark`` /
  ``broadcast_mark`` call.

Extraction mirrors R18: the FAIL_CLOSED literal and the Typestate
declarations are read from the scanned set itself, so a corpus twin
carrying its own table exercises the same machinery the real tree
does.  Resolution order is scanned-set first; when the declaring file
belongs to a real package (its grandparent directory carries an
``__init__.py``) and a row stays uncovered, the rest of that package
is parsed from disk before flagging — a partial scan of
``analysis/`` alone must not report the service's emit sites missing
(R21's resolution shape).  Corpus twins live outside any package, so
their coverage is judged on the scanned set alone.
"""

from __future__ import annotations

import ast
import glob as _glob
import hashlib
import os

from .core import Finding, SourceFile, terminal_name, walk_functions
from .rules_typestate import (
    _UNRESOLVED,
    _extract_protocols,
    _mediation_call,
    _pools,
    _resolve,
    _resolve_states,
)

_MARK_CALLS = {"record_mark", "broadcast_mark"}


def _extract_fail_closed(files, pools):
    """(rows, defining path, line) from the first
    ``FAIL_CLOSED = (...)`` tuple in the scanned set.  Row values may
    be constants or module-level constant names (the real table names
    its states symbolically)."""
    for path, sf in sorted(files.items()):
        pool = pools[path]
        for node in sf.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "FAIL_CLOSED"
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                continue
            rows = []
            for e in node.value.elts:
                if not isinstance(e, ast.Dict):
                    continue
                row: dict = {"_line": e.lineno, "_col": e.col_offset}
                for k, v in zip(e.keys, e.values):
                    key = _resolve(k, pool)
                    if not isinstance(key, str):
                        continue
                    if (key == "edge"
                            and isinstance(v, (ast.Tuple, ast.List))
                            and len(v.elts) == 2):
                        frm = _resolve(v.elts[0], pool)
                        to = _resolve(v.elts[1], pool)
                        if frm is not _UNRESOLVED and to is not _UNRESOLVED:
                            row["edge"] = (frm, to)
                    else:
                        got = _resolve(v, pool)
                        if got is not _UNRESOLVED:
                            row[key] = got
                rows.append(row)
            return rows, path, node.lineno
    return None, None, 0


def _emit_sites(files, pools, protos):
    """(advance_targets, exact_pairs, mark_tokens) over the scanned
    set: which (protocol name, to)-states some advance can enter,
    which (protocol name, frm, to) pairs a guard/require_edges names
    exactly, and which marker tokens reach a record_mark /
    broadcast_mark call."""
    objs = {p.obj for p in protos}
    by_obj = {p.obj: p for p in protos}
    advance_targets: set = set()
    exact_pairs: set = set()
    mark_tokens: set = set()
    for path, sf in sorted(files.items()):
        pool = pools[path]
        for fn, _qual, _cls in walk_functions(sf.tree):
            for node in ast.walk(fn):
                med = _mediation_call(node, objs)
                if med is not None:
                    obj, method, call = med
                    proto = by_obj[obj]
                    if method == "advance" and len(call.args) >= 2:
                        for to in _resolve_states(call.args[1], pool):
                            advance_targets.add((proto.name, to))
                    elif method == "guard" and len(call.args) >= 2:
                        for frm in _resolve_states(call.args[0], pool):
                            for to in _resolve_states(call.args[1], pool):
                                exact_pairs.add((proto.name, frm, to))
                    elif (method == "require_edges"
                          and len(call.args) >= 2):
                        frms_e = call.args[0]
                        frms: list = []
                        if isinstance(frms_e, (ast.Tuple, ast.List)):
                            for e in frms_e.elts:
                                frms.extend(_resolve_states(e, pool))
                        for to in _resolve_states(call.args[1], pool):
                            for frm in frms:
                                exact_pairs.add((proto.name, frm, to))
                    continue
                if (isinstance(node, ast.Call)
                        and terminal_name(node.func) in _MARK_CALLS
                        and node.args):
                    tok = _resolve(node.args[0], pool)
                    if isinstance(tok, str):
                        mark_tokens.add(tok)
    return advance_targets, exact_pairs, mark_tokens


def _pkg_root(decl_path):
    """The declaring file's package root (grandparent directory) — but
    only when it IS a package: corpus twins and tmp-dir fixtures have
    no ``__init__.py`` there, so their coverage stays scanned-set-only."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(decl_path)))
    if os.path.isfile(os.path.join(root, "__init__.py")):
        return root
    return None


def _disk_emit_sites(pkg_root, files, protos):
    """Emit sites harvested from the declaring package's unscanned
    files on disk — the fallback that keeps a partial scan (e.g.
    ``--device-contracts analysis/``) from flagging rows whose emit
    sites live in the sidecar/daemon halves of the same package.
    Pools are built over scanned + disk files together: a disk-side
    consumer resolves its state constants through the scanned
    declaring file, exactly as a full-tree scan would."""
    scanned_abs = {os.path.abspath(p) for p in files}
    extra = {}
    for cand in sorted(_glob.glob(
            os.path.join(pkg_root, "**", "*.py"), recursive=True)):
        if os.path.abspath(cand) in scanned_abs:
            continue
        try:
            with open(cand, "r", encoding="utf-8", errors="replace") as f:
                text = f.read()
        except OSError:
            continue
        sf = SourceFile(cand, text)
        if sf.tree is None:
            continue
        extra[cand] = sf
    if not extra:
        return set(), set(), set()
    both = dict(files)
    both.update(extra)
    return _emit_sites(extra, _pools(both), protos)


def _memo_extra(files) -> str:
    """Stat signature of the declaring package's ``.py`` files on disk —
    the coverage fallback reads them outside the scanned set, so their
    edits must invalidate the rule memo."""
    sig = []
    for path, sf in sorted(files.items()):
        if "FAIL_CLOSED" not in sf.text:
            continue
        root = _pkg_root(path)
        if root is None:
            continue
        for cand in sorted(_glob.glob(
                os.path.join(root, "**", "*.py"), recursive=True)):
            try:
                st = os.stat(cand)
                sig.append(f"{cand}:{st.st_size}:{st.st_mtime_ns}")
            except OSError:
                continue
        break
    return hashlib.sha256("|".join(sig).encode()).hexdigest()[:16]


def check_r22(files):
    pools = _pools(files)
    rows, decl_path, decl_line = _extract_fail_closed(files, pools)
    if rows is None:
        return
    protos, _bad = _extract_protocols(files, pools)  # R18 owns the bad
    by_name = {p.name: p for p in protos}
    advance_targets, exact_pairs, mark_tokens = _emit_sites(
        files, pools, protos
    )
    widened = []

    def _widen():
        # Lazy one-shot union of the package's on-disk emit sites;
        # only triggered when the scanned set alone leaves a row
        # uncovered, and only for real packages (see _pkg_root).
        if widened:
            return
        widened.append(True)
        root = _pkg_root(decl_path)
        if root is None:
            return
        adv, pairs, toks = _disk_emit_sites(root, files, protos)
        advance_targets.update(adv)
        exact_pairs.update(pairs)
        mark_tokens.update(toks)

    for row in rows:
        line, col = row["_line"], row["_col"]
        kind = row.get("kind")
        if kind == "edge":
            table = row.get("table")
            proto = by_name.get(table)
            if proto is None:
                yield Finding(
                    "R22", decl_path, line, col,
                    f"FAIL_CLOSED edge row names undeclared typestate "
                    f"table {table!r}",
                )
                continue
            edge = row.get("edge")
            if edge is None or edge not in proto.edges:
                yield Finding(
                    "R22", decl_path, line, col,
                    f"FAIL_CLOSED row names edge {edge!r} which is not "
                    f"a declared edge of typestate {table!r}",
                )
                continue
            frm, to = edge
            if ((table, to) not in advance_targets
                    and (table, frm, to) not in exact_pairs):
                _widen()
            if ((table, to) not in advance_targets
                    and (table, frm, to) not in exact_pairs):
                yield Finding(
                    "R22", decl_path, line, col,
                    f"fail-closed edge {table!r}: {frm!r} -> {to!r} "
                    f"has no mediated transition site in the scanned "
                    f"set — the flight recorder can never capture "
                    f"this incident (no advance into {to!r}, no "
                    f"guard/require_edges naming the pair)",
                )
        elif kind == "marker":
            token = row.get("token")
            if not isinstance(token, str):
                yield Finding(
                    "R22", decl_path, line, col,
                    "FAIL_CLOSED marker row carries no token string",
                )
                continue
            if token not in mark_tokens:
                _widen()
            if token not in mark_tokens:
                yield Finding(
                    "R22", decl_path, line, col,
                    f"fail-closed marker {token!r} never reaches a "
                    f"record_mark/broadcast_mark call — the flight "
                    f"recorder can never capture this incident",
                )
        else:
            yield Finding(
                "R22", decl_path, line, col,
                f"FAIL_CLOSED row has unknown kind {kind!r} (expected "
                f"'edge' or 'marker')",
            )


check_r22.memo_extra = _memo_extra
