"""R20 — wire-protocol lifecycle graph against the declared MSG table.

R5 proves the seam handles every ``MSG_*`` somewhere; this pass proves
each message's LIFECYCLE matches its declared row in
``analysis/protocols.py::WIRE_MESSAGES``: direction (who may send it),
reply pairing (a request handler must reach a send of its declared
reply), fire-and-forget consistency, and the version/flag gate tokens
both seam ends must reference.  The native-shim coexistence constants
(``NATIVE_MIRRORS``) are cross-checked value-for-value on every SHARED
name — the Python enums may extend past the reference ABI (fail-closed
on old consumers), the header may lag on the extensions, but a VALUE
drift on a shared name is silent verdict corruption at the C seam.

Seams are grouped by directory exactly like R5: a scanned dir holding
``wire.py`` + ``service.py`` + ``client.py`` is one seam, so a corpus
twin dir exercises the same resolution the real sidecar does.

Send-site strictness matters: a MSG token is a *send* only as a direct
positional argument of a send-named call (``send``, ``send_msg``,
``_send``...) — the client's control round-trips pass expected-REPLY
tokens as wait arguments, which must not count as the client sending a
service-direction frame.  A *handle* site is a MSG token inside an
equality/membership Compare (the dispatch chains' shape).
"""

from __future__ import annotations

import ast
import hashlib
import os
import re

from .core import Finding, terminal_name, walk_functions

_SEND_NAMES = {
    "send", "send_frames", "send_msg", "_send", "_send_round",
    "_transport_send",
}
_SEAM_BASES = ("wire.py", "service.py", "client.py")

_HDR_DEFINE = re.compile(r"#\s*define\s+(CT_[A-Z0-9_]+)\s+(\d+)")
_HDR_ENUM = re.compile(r"\b(CT_[A-Z0-9_]+)\s*=\s*(\d+)")


def _extract_table(files):
    """(table dict, defining path, line) from the first
    ``WIRE_MESSAGES = {...}`` literal in the scanned set."""
    for path, sf in sorted(files.items()):
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "WIRE_MESSAGES"):
                try:
                    table = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    continue
                if isinstance(table, dict):
                    return table, path, node.lineno
    return None, None, 0


def _extract_mirrors(files):
    for path, sf in sorted(files.items()):
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "NATIVE_MIRRORS"):
                try:
                    rows = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    continue
                return list(rows), path, node.lineno
    return [], None, 0


def _wire_msgs(sf) -> dict[str, int]:
    """Module-level ``MSG_X = <int>`` constants of a wire module."""
    out: dict[str, int] = {}
    for node in sf.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("MSG_")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)):
            out[node.targets[0].id] = node.value.value
    return out


def _msg_token(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name) and node.id.startswith("MSG_"):
        return node.id
    if isinstance(node, ast.Attribute) and node.attr.startswith("MSG_"):
        return node.attr
    return None


def _send_sites_in(node: ast.AST) -> dict[str, list[tuple[int, int]]]:
    """msg -> [(line, col)] for send-named calls carrying a MSG token
    as a direct positional argument."""
    out: dict[str, list] = {}
    for n in ast.walk(node):
        if (isinstance(n, ast.Call)
                and terminal_name(n.func) in _SEND_NAMES):
            for arg in n.args:
                msg = _msg_token(arg)
                if msg is not None:
                    out.setdefault(msg, []).append(
                        (n.lineno, n.col_offset)
                    )
    return out


def _handle_sites(sf) -> dict[str, list]:
    """msg -> [enclosing function node] for MSG tokens compared with
    ``==`` / ``in`` (the handler-dispatch shapes)."""
    out: dict[str, list] = {}
    for fn, _qual, _cls in walk_functions(sf.tree):
        if isinstance(fn, ast.Lambda):
            continue
        for n in ast.walk(fn):
            if not isinstance(n, ast.Compare):
                continue
            if not any(isinstance(op, (ast.Eq, ast.In)) for op in n.ops):
                continue
            for side in [n.left, *n.comparators]:
                msg = _msg_token(side)
                if msg is not None:
                    out.setdefault(msg, []).append(fn)
                elif isinstance(side, (ast.Tuple, ast.List, ast.Set)):
                    for e in side.elts:
                        m2 = _msg_token(e)
                        if m2 is not None:
                            out.setdefault(m2, []).append(fn)
    return out


def _identifiers(sf) -> set[str]:
    ids: set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Name):
            ids.add(node.id)
        elif isinstance(node, ast.Attribute):
            ids.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            ids.add(node.value)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                ids.add(a.asname or a.name.split(".")[0])
    return ids


def _references(sf) -> set[str]:
    refs: set[str] = set()
    for node in ast.walk(sf.tree):
        msg = _msg_token(node)
        if msg is not None:
            refs.add(msg)
    return refs


def _handler_reaches_send(graph, fn_node, reply: str, depth=2) -> bool:
    """Does the handler (or a scanned callee within ``depth`` hops)
    contain a send-site of ``reply``?"""
    seen: set[str] = set()
    frontier = [(fn_node, 0)]
    while frontier:
        node, d = frontier.pop()
        if reply in _send_sites_in(node):
            return True
        if d >= depth:
            continue
        fi = graph.info_for(node)
        if fi is None:
            continue
        for _call, _l, _c, _held, keys in fi.calls:
            for key in keys or ():
                if key in seen:
                    continue
                seen.add(key)
                callee = graph.funcs.get(key)
                if callee is not None:
                    frontier.append((callee.node, d + 1))
    return False


def _header_candidates(files) -> list[str]:
    """Possible native-header locations derived from the scanned set:
    next to each scanned dir and at each dir's great-grandparent (the
    repo root when the tables file sits at pkg/analysis/protocols.py)."""
    roots: set[str] = set()
    for path in files:
        d = os.path.dirname(os.path.abspath(path))
        roots.add(d)
        roots.add(os.path.dirname(os.path.dirname(d)))
    return sorted(roots)


def _memo_extra(files) -> str:
    """Disk-state digest for the rule memo: the native header is read
    from OUTSIDE the scanned set, so its (path, size, mtime) must key
    the cache or an edited header would re-serve stale findings."""
    sig = []
    for root in _header_candidates(files):
        hdr = os.path.join(root, "native", "cilium_tpu_shim.h")
        try:
            st = os.stat(hdr)
            sig.append(f"{hdr}:{st.st_size}:{st.st_mtime_ns}")
        except OSError:
            continue
    return hashlib.sha256("|".join(sig).encode()).hexdigest()[:16]


def _find_header(files, header_rel: str) -> str | None:
    for root in _header_candidates(files):
        cand = os.path.join(root, header_rel.replace("/", os.sep))
        if os.path.isfile(cand):
            return cand
    return None


def _python_enum_members(files, enum: str) -> dict[str, int] | None:
    for _path, sf in sorted(files.items()):
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef) and node.name == enum:
                out: dict[str, int] = {}
                for stmt in node.body:
                    if (isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Name)
                            and isinstance(stmt.value, ast.Constant)
                            and isinstance(stmt.value.value, int)):
                        out[stmt.targets[0].id] = stmt.value.value
                return out
    return None


def _check_native_mirrors(files, mirrors, decl_path, decl_line):
    if not mirrors:
        return
    header_texts: dict[str, str | None] = {}
    # Longest-prefix wins so CT_FILTEROP_* never misfiles under the
    # CT_FILTER_* row.
    ordered = sorted(mirrors, key=lambda m: -len(m.get("prefix", "")))
    for row in ordered:
        rel = row.get("header", "")
        if rel not in header_texts:
            found = _find_header(files, rel)
            if found is None:
                header_texts[rel] = None
            else:
                try:
                    with open(found, "r", encoding="utf-8",
                              errors="replace") as f:
                        header_texts[rel] = f.read()
                except OSError:
                    header_texts[rel] = None
        text = header_texts[rel]
        if text is None:
            continue  # no native build here: nothing to coexist with
        prefix = row.get("prefix", "")
        members = _python_enum_members(files, row.get("enum", ""))
        if members is None:
            continue
        consts: dict[str, int] = {}
        for rx in (_HDR_DEFINE, _HDR_ENUM):
            for m in rx.finditer(text):
                consts.setdefault(m.group(1), int(m.group(2)))
        longer = [
            m.get("prefix", "") for m in ordered
            if len(m.get("prefix", "")) > len(prefix)
        ]
        for cname, cval in sorted(consts.items()):
            if not cname.startswith(prefix):
                continue
            if any(cname.startswith(lp) for lp in longer):
                continue  # belongs to a more specific mirror row
            member = cname[len(prefix):]
            if member not in members:
                yield Finding(
                    "R20", decl_path, decl_line, 0,
                    f"native header constant {cname} has no "
                    f"{row['enum']} twin — the C seam carries a "
                    f"value Python cannot classify",
                )
            elif members[member] != cval:
                yield Finding(
                    "R20", decl_path, decl_line, 0,
                    f"native/Python enum drift: {cname}={cval} but "
                    f"{row['enum']}.{member}={members[member]} — "
                    f"shared ABI names must stay bit-identical",
                )


def check_r20(files):
    from .callgraph import get_graph

    table, decl_path, decl_line = _extract_table(files)
    if table is None:
        return

    # -- table self-consistency -------------------------------------
    for msg, row in sorted(table.items()):
        if row.get("fnf") and row.get("reply"):
            yield Finding(
                "R20", decl_path, decl_line, 0,
                f"{msg}: declared fire-and-forget but names reply "
                f"{row['reply']} — pick one",
            )
        if not row.get("fnf") and not row.get("reply"):
            yield Finding(
                "R20", decl_path, decl_line, 0,
                f"{msg}: neither fire-and-forget nor paired with a "
                f"reply — an unanswerable request",
            )
        reply = row.get("reply")
        if reply is not None and reply not in table:
            yield Finding(
                "R20", decl_path, decl_line, 0,
                f"{msg}: declared reply {reply} is not a declared "
                f"message",
            )

    # -- native mirror cross-check ----------------------------------
    mirrors, mdecl_path, mdecl_line = _extract_mirrors(files)
    yield from _check_native_mirrors(
        files, mirrors, mdecl_path or decl_path, mdecl_line or decl_line
    )

    # -- seam grouping (R5's shape) ---------------------------------
    by_dir: dict[str, dict] = {}
    for path in files:
        base = os.path.basename(path)
        if base in _SEAM_BASES:
            by_dir.setdefault(os.path.dirname(path), {})[base] = path
    graph = None
    for d, seam in sorted(by_dir.items()):
        if set(seam) != set(_SEAM_BASES):
            continue
        if graph is None:
            graph = get_graph(files)
        wire_sf = files[seam["wire.py"]]
        svc_sf = files[seam["service.py"]]
        cli_sf = files[seam["client.py"]]
        wire_path = seam["wire.py"]
        msgs = _wire_msgs(wire_sf)

        for msg in sorted(msgs):
            if msg not in table:
                yield Finding(
                    "R20", wire_path, wire_sf.tree.body[0].lineno, 0,
                    f"{msg} is defined on the wire but has no "
                    f"WIRE_MESSAGES lifecycle row — direction/reply/"
                    f"gating unchecked",
                )
        for msg in sorted(table):
            if msg not in msgs:
                yield Finding(
                    "R20", decl_path, decl_line, 0,
                    f"{msg} has a lifecycle row but no wire constant "
                    f"in {os.path.basename(d)}/wire.py",
                )

        svc_sends = _send_sites_in(svc_sf.tree)
        cli_sends = _send_sites_in(cli_sf.tree)
        svc_handles = _handle_sites(svc_sf)
        svc_ids = _identifiers(svc_sf)
        cli_ids = _identifiers(cli_sf)
        cli_refs = _references(cli_sf)

        for msg, row in sorted(table.items()):
            if msg not in msgs:
                continue
            direction = row.get("dir")
            if direction == "c2s":
                if msg not in svc_handles:
                    yield Finding(
                        "R20", seam["service.py"], 1, 0,
                        f"{msg} is declared client->service but the "
                        f"service dispatch chain never handles it "
                        f"(no ==/in compare)",
                    )
                if msg not in cli_refs:
                    yield Finding(
                        "R20", seam["client.py"], 1, 0,
                        f"{msg} is declared client->service but the "
                        f"client never references it",
                    )
                if msg in svc_sends:
                    line, col = svc_sends[msg][0]
                    yield Finding(
                        "R20", seam["service.py"], line, col,
                        f"{msg} is declared client->service but the "
                        f"service SENDS it — wrong direction",
                    )
            elif direction == "s2c":
                if msg not in svc_sends:
                    yield Finding(
                        "R20", seam["service.py"], 1, 0,
                        f"{msg} is declared service->client but the "
                        f"service never sends it",
                    )
                if msg not in cli_refs:
                    yield Finding(
                        "R20", seam["client.py"], 1, 0,
                        f"{msg} is declared service->client but the "
                        f"client never references it",
                    )
                if msg in cli_sends:
                    line, col = cli_sends[msg][0]
                    yield Finding(
                        "R20", seam["client.py"], line, col,
                        f"{msg} is declared service->client but the "
                        f"client SENDS it — wrong direction",
                    )
            # -- reply pairing (request handler reaches the send) ----
            reply = row.get("reply")
            if (reply is not None and not row.get("deferred")
                    and direction in ("c2s", "peer")
                    and msg in svc_handles):
                if not any(
                    _handler_reaches_send(graph, fn, reply)
                    for fn in svc_handles[msg]
                ):
                    fn0 = svc_handles[msg][0]
                    yield Finding(
                        "R20", seam["service.py"], fn0.lineno,
                        fn0.col_offset,
                        f"{msg} handler never reaches a send of its "
                        f"declared reply {reply} (within 2 call "
                        f"hops) — the requester hangs until its "
                        f"timeout",
                    )
            # -- gate tokens on both seam ends (a peer message's two
            # ends are BOTH the service module, so the client half is
            # out of scope for its gates) ----------------------------
            for gate in row.get("gates", ()):
                if gate not in svc_ids:
                    yield Finding(
                        "R20", seam["service.py"], 1, 0,
                        f"{msg}: gate token {gate} is never "
                        f"referenced by the service half",
                    )
                if direction != "peer" and gate not in cli_ids:
                    yield Finding(
                        "R20", seam["client.py"], 1, 0,
                        f"{msg}: gate token {gate} is never "
                        f"referenced by the client half",
                    )


check_r20.memo_extra = _memo_extra
