"""R5 — wire / verdict exhaustiveness.

Four halves:

- **MSG coverage.**  Every ``MSG_*`` constant defined in a ``wire.py``
  must be referenced by its sibling ``service.py`` AND ``client.py``
  (the two ends of the seam).  A constant one side never mentions is a
  message the other side can emit into a peer that has no branch for
  it — at best dropped on the floor, at worst desynchronizing the
  framing.  PR 2's MSG_DATA_BATCH_DL landed correctly only because
  review checked both ends by hand; this rule makes that permanent.
- **FilterResult coverage.**  A module that dispatches on specific
  non-OK FilterResult codes (equality compares) must either cover
  every member or carry the fail-closed OK-gate default
  (``res != FilterResult.OK`` / ``== FilterResult.OK``): any code it
  has no branch for then lands in the non-OK arm, which is deny.  The
  extension codes (SHED=8, SERVICE_UNAVAILABLE=9) were designed to be
  safe on old consumers exactly because of this gate — the rule keeps
  new consumers honest.
- **JSON field symmetry** (the PR 4/5 payloads).  MSG_TRACE /
  MSG_OBSERVE and their replies carry ``json.dumps`` payloads, so
  message-NAME coverage alone proves nothing about fields: a request
  key the client writes that the service never reads is a filter
  silently ignored; a reply key the service emits that no consumer
  anywhere reads is a dead field (and the next rename breaks the CLI
  with no lint to catch it).  For every json-carried send site, each
  written key must be read either by the PEER's handler chain
  (import-resolved, two hops deep) or — for reply payloads the client
  returns opaquely — by SOME consumer in the scanned tree.
- **Struct field symmetry** (the MSG_SHM_* payloads).  For every
  ``pack_X``/``unpack_X`` pair in a ``wire.py``, the struct format
  literals used inside the pair must agree: a doorbell packed
  ``<IQQ`` but unpacked ``<IQ`` silently truncates a cursor and the
  ring protocol desynchronizes with no parse error — message-name
  coverage alone cannot see it.
"""

from __future__ import annotations

import ast
import os
import re

from .callgraph import get_graph
from .core import Finding, unparse, walk_functions

_FR_TOKEN = re.compile(r"FilterResult\.([A-Z_]+)")


def _msg_constants(sf):
    out = []
    for node in sf.tree.body:
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("MSG_")):
            out.append((node.targets[0].id, node.lineno))
    return out


def _referenced_msgs(sf) -> set[str]:
    out = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Attribute) and node.attr.startswith("MSG_"):
            out.add(node.attr)
        elif isinstance(node, ast.Name) and node.id.startswith("MSG_"):
            out.add(node.id)
    return out


def _filter_result_members(files) -> list[str]:
    for sf in files.values():
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef) and node.name == "FilterResult":
                return [
                    n.targets[0].id
                    for n in node.body
                    if isinstance(n, ast.Assign)
                    and isinstance(n.targets[0], ast.Name)
                ]
    try:  # linting a subset: fall back to the canonical enum
        from ..proxylib.types import FilterResult

        return [m.name for m in FilterResult]
    except Exception:  # noqa: BLE001 — standalone corpus run
        return []


# --- JSON field symmetry --------------------------------------------------

def _is_msg_token(node) -> str | None:
    if isinstance(node, ast.Attribute) and node.attr.startswith("MSG_"):
        return node.attr
    if isinstance(node, ast.Name) and node.id.startswith("MSG_"):
        return node.id
    return None


def _dumps_inner(node) -> ast.AST | None:
    """The EXPR of ``json.dumps(EXPR)`` / ``json.dumps(EXPR).encode()``."""
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "encode"):
        return _dumps_inner(node.func.value)
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "dumps"
            and node.args):
        return node.args[0]
    return None


def _own_nodes_with_lambdas(fn):
    """A function's own body, lambdas included, nested defs excluded —
    a payload built in a method and shipped via a ``lambda:`` send
    thunk belongs to the METHOD."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _json_send_sites(sf):
    """(msg_name, inner_expr, enclosing_fn_node, line, col): every
    tuple/call that pairs a MSG_* token with a json.dumps payload."""
    for fn, _qual, _cls in walk_functions(sf.tree):
        if isinstance(fn, ast.Lambda):
            continue
        for node in _own_nodes_with_lambdas(fn):
            parts = []
            if isinstance(node, ast.Tuple):
                parts = node.elts
            elif isinstance(node, ast.Call):
                parts = list(node.args)
            if len(parts) < 2:
                continue
            msg = None
            inner = None
            for p in parts:
                m = _is_msg_token(p)
                if m is not None:
                    msg = m
                d = _dumps_inner(p)
                if d is not None:
                    inner = d
            if msg is not None and inner is not None:
                yield msg, inner, fn, node.lineno, node.col_offset


def _written_keys(inner, fn, sf, graph) -> set[str]:
    """Constant keys the payload expression carries: dict literals and
    subscript-assigns for a Name; returned-dict keys (resolved through
    the call graph) for a producing Call."""
    keys: set[str] = set()

    def dict_keys(d: ast.Dict):
        for k in d.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)

    if isinstance(inner, ast.Dict):
        dict_keys(inner)
        return keys
    if isinstance(inner, ast.Name):
        target = inner.id
        for node in _own_nodes_with_lambdas(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Name) and t.id == target
                            and isinstance(node.value, ast.Dict)):
                        dict_keys(node.value)
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == target
                            and isinstance(t.slice, ast.Constant)
                            and isinstance(t.slice.value, str)):
                        keys.add(t.slice.value)
        return keys
    if isinstance(inner, ast.Call):
        fi = graph.info_for(fn)
        if fi is None:
            return keys
        for target in graph.resolve_call(inner, fi):
            tnode = target.node
            ret_names: set[str] = set()
            for node in ast.walk(tnode):
                if isinstance(node, ast.Return) and node.value is not None:
                    if isinstance(node.value, ast.Dict):
                        dict_keys(node.value)
                    elif isinstance(node.value, ast.Name):
                        ret_names.add(node.value.id)
            for node in ast.walk(tnode):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if (isinstance(t, ast.Name)
                                and t.id in ret_names
                                and isinstance(node.value, ast.Dict)):
                            dict_keys(node.value)
                        if (isinstance(t, ast.Subscript)
                                and isinstance(t.value, ast.Name)
                                and t.value.id in ret_names
                                and isinstance(t.slice, ast.Constant)
                                and isinstance(t.slice.value, str)):
                            keys.add(t.slice.value)
    return keys


def _read_keys_in(fn) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            out.add(node.slice.value)
        elif (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value)
    return out


def _peer_reader_keys(peer_sf, msg, graph, depth=2) -> set[str]:
    """Keys read by the peer functions that reference ``msg``, plus
    their import-resolved callees ``depth`` hops out (the handler
    delegates to observe_dump/trace_dump)."""
    keys: set[str] = set()
    seeds = []
    for fn, _qual, _cls in walk_functions(peer_sf.tree):
        for node in ast.walk(fn):
            if _is_msg_token(node) == msg:
                seeds.append(fn)
                break
    seen: set[int] = set()
    frontier = [(fn, 0) for fn in seeds]
    while frontier:
        fn, d = frontier.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        keys |= _read_keys_in(fn)
        if d >= depth:
            continue
        fi = graph.info_for(fn)
        if fi is None:
            continue
        for _call, _l, _c, _held, ks in fi.calls:
            for key in ks or ():
                callee = graph.funcs.get(key)
                if callee is not None:
                    frontier.append((callee.node, d + 1))
    return keys


def _check_json_fields(files, by_dir):
    graph = get_graph(files)
    # Fallback read-key pool (reply payloads are returned opaquely by
    # the client and consumed by the CLI/tests/monitor layers).  The
    # pool for one seam is its OWN directory plus every non-seam file:
    # another seam's equally-named keys must not mask this seam's
    # dropped field.
    global_reads: dict[str, set[str]] = {
        path: _read_keys_in(sf.tree) for path, sf in files.items()
    }
    seam_dirs = {
        d for d, g in by_dir.items()
        if "service.py" in g and "client.py" in g
    }
    for dirname, group in sorted(by_dir.items()):
        pair = {"service.py": "client.py", "client.py": "service.py"}
        for base, peer_base in pair.items():
            sf = group.get(base)
            peer = group.get(peer_base)
            if sf is None or peer is None:
                continue
            for msg, inner, fn, line, col in _json_send_sites(sf):
                written = _written_keys(inner, fn, sf, graph)
                if not written:
                    continue
                peer_keys = _peer_reader_keys(peer, msg, graph)
                missing = sorted(written - peer_keys)
                for key in missing:
                    read_somewhere = any(
                        key in ks
                        for path, ks in global_reads.items()
                        if path != sf.path and (
                            os.path.dirname(path) == dirname
                            or os.path.dirname(path) not in seam_dirs
                        )
                    )
                    if read_somewhere:
                        continue
                    yield Finding(
                        "R5", sf.path, line, col,
                        f"json field {key!r} of {msg} is written here "
                        f"but never read by {peer_base}'s handler "
                        f"chain nor any consumer in the tree — a "
                        f"dropped field passes the message-name "
                        f"coverage check silently",
                        symbol=msg,
                    )


# --- struct field symmetry ------------------------------------------------

_STRUCT_CALLS = {"pack", "pack_into", "unpack", "unpack_from", "Struct",
                 "calcsize"}
_FMT = re.compile(r"^[@=<>!]?[0-9xcbB?hHiIlLqQnNefdspP]+$")


def _struct_formats(fn) -> list[str]:
    """Struct format literals used by struct pack/unpack calls in
    ``fn``'s own body (sorted multiset)."""
    out: list[str] = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, (ast.Attribute, ast.Name))):
            continue
        name = (node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id)
        if name not in _STRUCT_CALLS or not node.args:
            continue
        arg = node.args[0]
        if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                and _FMT.match(arg.value)):
            out.append(arg.value)
    return sorted(out)


def _check_struct_symmetry(files):
    """pack_X/unpack_X pairs in a wire.py must use matching struct
    format literals (both halves considered as multisets — helpers
    shared at module level, like a module-level Struct, contribute to
    neither and stay exempt)."""
    for path, sf in sorted(files.items()):
        if os.path.basename(path) != "wire.py":
            continue
        fns = {
            fn.name: fn
            for fn in sf.tree.body
            if isinstance(fn, ast.FunctionDef)
        }
        for name, fn in sorted(fns.items()):
            if not name.startswith("pack_"):
                continue
            base = name[len("pack_"):]
            if base.endswith("_parts"):
                # Scatter-gather builders share the layout with their
                # joined twin; their unpack is the base name's.
                base = base[: -len("_parts")]
            peer = fns.get("unpack_" + base)
            if peer is None:
                continue
            got = _struct_formats(fn)
            want = _struct_formats(peer)
            if got and want and got != want:
                yield Finding(
                    "R5", path, fn.lineno, fn.col_offset,
                    f"struct-format asymmetry: {name} packs "
                    f"{got} but {peer.name} reads {want} — the "
                    f"truncated/reordered field desynchronizes the "
                    f"frame with no parse error",
                    symbol=name,
                )


def check_r5(files):
    yield from _check_struct_symmetry(files)

    # --- MSG coverage, per directory holding a wire.py ---
    by_dir: dict[str, dict[str, object]] = {}
    for path, sf in files.items():
        base = os.path.basename(path)
        if base in ("wire.py", "service.py", "client.py"):
            by_dir.setdefault(os.path.dirname(path), {})[base] = sf

    yield from _check_json_fields(files, by_dir)

    for dirname, group in sorted(by_dir.items()):
        wire = group.get("wire.py")
        if wire is None:
            continue
        consts = _msg_constants(wire)
        if not consts:
            continue
        siblings = [
            (name, group[name])
            for name in ("service.py", "client.py")
            if name in group
        ]
        for name, sib in siblings:
            refs = _referenced_msgs(sib)
            for const, line in consts:
                if const not in refs:
                    yield Finding(
                        "R5", wire.path, line, 0,
                        f"wire constant {const} has no handler "
                        f"reference in sibling {name}: one seam end "
                        f"can emit a message the other has no branch "
                        f"for",
                        symbol=const,
                    )

    # --- FilterResult dispatch coverage, per module ---
    members = _filter_result_members(files)
    if not members:
        return
    member_set = set(members)
    for path, sf in files.items():
        compared: set[str] = set()
        first: tuple[int, int] | None = None
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not all(
                isinstance(op, (ast.Eq, ast.NotEq, ast.In, ast.NotIn))
                for op in node.ops
            ):
                continue
            toks = set(_FR_TOKEN.findall(unparse(node)))
            got = toks & member_set
            if got:
                compared |= got
                if first is None:
                    first = (node.lineno, node.col_offset)
        non_ok = compared - {"OK"}
        if not non_ok:
            continue  # produces codes or only uses the OK gate: fine
        if "OK" in compared or compared >= member_set:
            continue
        missing = sorted(member_set - compared)
        yield Finding(
            "R5", path, first[0], first[1],
            f"dispatch over FilterResult codes covers "
            f"{sorted(compared)} but not {missing} and has no "
            f"fail-closed OK-gate default (compare against "
            f"FilterResult.OK so every unknown code lands in the "
            f"deny arm)",
        )
