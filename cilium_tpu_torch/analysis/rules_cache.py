"""R13 — epoch-unkeyed cache in hot modules.

PR 12's verdict cache made the repo's central caching contract explicit:
any cache consulted on the serving path must be keyed (or guarded) by
the policy epoch / generation it was derived under, or a pointer-flip
swap leaves it serving stale decisions with no functional test able to
see it (verdicts stay plausible — they are just the OLD table's).  The
conn-table cache columns pair every row with a ``*_epoch`` twin and the
hit mask compares it against the snapshot epoch; the shim grant table
stores epochs and compares against the latest revoke.  This rule pins
the pattern:

- **Unkeyed write.**  A subscript store into a cache-named container
  (``*cache*`` / ``*memo*``) in a hot module whose key derivation
  carries no epoch/generation term, in a function that maintains no
  sibling epoch store (``<base>_epoch[...]`` / any ``*epoch*`` /
  ``*generation*`` identifier) — nothing ties the entry to the table
  generation it was computed from.
- **Unchecked read.**  A subscript load / ``.get()`` on such a
  container in a function that never touches an epoch/generation
  identifier — the consumer cannot be validating the entry's
  generation.

Caches that are deliberately generation-free carry a justified pragma
naming WHY (the shape-keyed executable cache survives swaps by design:
its keys are table shapes, not table contents, and the id-keyed halves
are popped at the flip).
"""

from __future__ import annotations

import ast
import os

from .core import Finding

_HOT_BASENAMES = {
    "service.py", "dispatch.py", "client.py", "reasm.py", "shm.py",
    "transport.py", "wire.py", "dnsengine.py",
}

_CACHE_TOKENS = ("cache", "memo")
_EPOCH_TOKENS = ("epoch", "generation")


def _base_name(node) -> str | None:
    """Rightmost identifier of a subscript/call base: ``self._x[k]`` ->
    ``_x``, ``cache[k]`` -> ``cache``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_cache_name(name: str | None) -> bool:
    if not name:
        return False
    low = name.lower()
    return any(t in low for t in _CACHE_TOKENS)


def _has_epoch_token(name: str | None) -> bool:
    if not name:
        return False
    low = name.lower()
    return any(t in low for t in _EPOCH_TOKENS)


def _idents(node) -> set[str]:
    """All identifier strings under ``node`` (names + attribute
    components) — deliberately NOT source text, so a docstring merely
    mentioning 'epoch' cannot satisfy the rule."""
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _func_epoch_idents(fn: ast.AST) -> bool:
    return any(_has_epoch_token(i) for i in _idents(fn))


def _walk_own(fn):
    """Yield ``fn``'s own nodes, pruning nested function BODIES —
    ``ast.walk`` would keep descending past a nested def (a bare
    ``continue`` on the def node skips only the node itself), double-
    reporting every cache site inside a closure under both the closure
    and its parent."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested defs get their own visit
        stack.extend(ast.iter_child_nodes(node))


def check_r13(files):
    for path, sf in files.items():
        if os.path.basename(path) not in _HOT_BASENAMES:
            continue
        tree = sf.tree
        if tree is None:
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            epoch_aware = _func_epoch_idents(fn)
            if epoch_aware:
                # The function maintains/compares a generation term
                # somewhere — the sibling-epoch-store pattern (or an
                # explicit guard).  Per-site key analysis would only
                # produce noise on top of that signal.
                continue
            for node in _walk_own(fn):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if not isinstance(tgt, ast.Subscript):
                            continue
                        base = _base_name(tgt.value)
                        if not _is_cache_name(base) \
                                or _has_epoch_token(base):
                            continue
                        if any(_has_epoch_token(i)
                               for i in _idents(tgt.slice)):
                            continue
                        yield Finding(
                            "R13", sf.path, node.lineno,
                            node.col_offset,
                            f"cache store {base}[...] keyed without an "
                            f"epoch/generation term (and no sibling "
                            f"epoch store in {fn.name}): a policy "
                            f"pointer-flip leaves this entry serving "
                            f"the OLD table's decision",
                            symbol=fn.name,
                        )
                elif isinstance(node, ast.Subscript) and isinstance(
                    node.ctx, ast.Load
                ):
                    base = _base_name(node.value)
                    if _is_cache_name(base) and not _has_epoch_token(
                        base
                    ):
                        yield Finding(
                            "R13", sf.path, node.lineno,
                            node.col_offset,
                            f"cache read {base}[...] with no epoch/"
                            f"generation check anywhere in {fn.name}: "
                            f"the consumer cannot be validating the "
                            f"entry's table generation",
                            symbol=fn.name,
                        )
                elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ) and node.func.attr == "get":
                    base = _base_name(node.func.value)
                    if _is_cache_name(base) and not _has_epoch_token(
                        base
                    ):
                        yield Finding(
                            "R13", sf.path, node.lineno,
                            node.col_offset,
                            f"cache read {base}.get(...) with no "
                            f"epoch/generation check anywhere in "
                            f"{fn.name}: the consumer cannot be "
                            f"validating the entry's table generation",
                            symbol=fn.name,
                        )
