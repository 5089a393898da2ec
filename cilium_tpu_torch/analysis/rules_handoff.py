"""R17 — snapshot round-trip symmetry (the restart-handoff contract).

A ``snapshot_X`` / ``restore_X`` pair is a serialization seam exactly
like a wire ``pack_X``/``unpack_X`` pair (R5's struct half), but the
payload is a dict and the desync mode is quieter: a field the snapshot
writes that the restore never reads is state that silently dies at the
restart boundary (the successor serves without it and nothing parses
wrong), and a field the restore REQUIRES (hard subscript) that the
snapshot never writes makes every restore take the malformed-refusal
path — the handoff degrades to a cold boot forever and no test that
only exercises one process half will notice.

Two halves, anchored on same-module ``snapshot_*``/``restore_*`` def
pairs:

- **written-but-never-consumed**: every constant top-level key the
  snapshot half writes (returned dict literal, keys assigned onto the
  returned name) must be consumed by the restore half — a subscript
  read, a ``.get("key")``, or (the versioned-out escape) the key named
  as a plain string constant in the restore body (a dropped-fields
  tuple / version-gate branch), which records the retirement where the
  next reader looks.
- **required-but-never-written**: a HARD read (``snap["key"]``) in the
  restore half for a key the snapshot half never writes.  Tolerant
  ``.get`` reads are exempt — that is the sanctioned versioned-in form
  for fields newer snapshots may carry.

A ``snapshot_X`` with no ``restore_X`` twin in its module is a
write-only state transfer: flagged too (the Envoy hot-restart lesson —
serialization halves drift the moment they stop being reviewed as a
pair).
"""

from __future__ import annotations

import ast

from .core import Finding, walk_functions

_SNAP = "snapshot_"
_REST = "restore_"


def _top_level_written_keys(fn: ast.AST) -> dict[str, int]:
    """Constant top-level keys of the dict(s) ``fn`` returns:
    {key: lineno}.  Follows one level of name indirection (``out =
    {...}; out["k"] = ...; return out``); nested row dicts inside
    comprehensions are deliberately NOT schema — their keys are
    consumed row-by-row at replay time, not by the restore half."""
    keys: dict[str, int] = {}
    ret_names: set[str] = set()

    def dict_keys(d: ast.Dict) -> None:
        for k in d.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.setdefault(k.value, k.lineno)

    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            if isinstance(node.value, ast.Dict):
                dict_keys(node.value)
            elif isinstance(node.value, ast.Name):
                ret_names.add(node.value.id)
    if not ret_names:
        return keys
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Name) and t.id in ret_names
                    and isinstance(node.value, ast.Dict)):
                dict_keys(node.value)
            elif (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in ret_names
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)):
                keys.setdefault(t.slice.value, t.lineno)
    return keys


def _snap_param(fn) -> str | None:
    """The restore half's snapshot parameter name (first non-self
    positional arg)."""
    args = [a.arg for a in fn.args.args if a.arg != "self"]
    return args[0] if args else None


def _consumed_keys(fn: ast.AST, param: str | None):
    """(hard_reads {key: lineno}, tolerant_reads set, string_pool set)
    in the restore half.  Hard reads are subscripts ON THE SNAPSHOT
    PARAM specifically; tolerant/get reads and the bare-string pool
    (the versioned-out escape) are collected from the whole body —
    restore halves routinely rebind rows to locals."""
    hard: dict[str, int] = {}
    tolerant: set[str] = set()
    pool: set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            key = node.slice.value
            if (isinstance(node.value, ast.Name)
                    and param is not None and node.value.id == param):
                hard.setdefault(key, node.lineno)
            tolerant.add(key)
        elif (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            tolerant.add(node.args[0].value)
        elif (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            pool.add(node.value)
    return hard, tolerant, pool


def check_r17(files):
    for path, sf in sorted(files.items()):
        fns = {}
        for fn, qual, _cls in walk_functions(sf.tree):
            if isinstance(fn, ast.Lambda):
                continue
            if fn.name.startswith((_SNAP, _REST)):
                fns.setdefault(fn.name, (fn, qual))
        for name, (snap_fn, snap_qual) in sorted(fns.items()):
            if not name.startswith(_SNAP):
                continue
            suffix = name[len(_SNAP):]
            got = fns.get(_REST + suffix)
            if got is None:
                yield Finding(
                    "R17", path, snap_fn.lineno, snap_fn.col_offset,
                    f"{name} has no restore_{suffix} twin in this "
                    f"module: a write-only state transfer — the "
                    f"serialization halves must live (and be reviewed) "
                    f"as a pair",
                    symbol=snap_qual,
                )
                continue
            rest_fn, rest_qual = got
            written = _top_level_written_keys(snap_fn)
            hard, tolerant, pool = _consumed_keys(
                rest_fn, _snap_param(rest_fn)
            )
            consumed = tolerant | set(hard) | pool
            for key, line in sorted(written.items()):
                if key in consumed:
                    continue
                yield Finding(
                    "R17", path, line, 0,
                    f"snapshot field {key!r} written by {name} is "
                    f"never consumed by restore_{suffix} (no read, no "
                    f"versioned-out mention): state that silently dies "
                    f"at the restart boundary",
                    symbol=snap_qual,
                )
            for key, line in sorted(hard.items()):
                if key in written:
                    continue
                yield Finding(
                    "R17", path, line, 0,
                    f"restore_{suffix} REQUIRES snapshot field {key!r} "
                    f"(hard subscript) but {name} never writes it: "
                    f"every restore takes the malformed-refusal path "
                    f"and the handoff silently degrades to a cold "
                    f"boot (use .get for versioned-in fields)",
                    symbol=rest_qual,
                )
