"""R7 — metric hygiene.

Two halves:

- **Dead metrics.**  Every module-level ``NAME = registry.counter/
  gauge/histogram(...)`` registration in a ``metrics.py`` must be
  referenced by name somewhere OUTSIDE that file.  A registered-but-
  never-incremented metric exports a permanently-zero series: dashboards
  read it as "nothing is wrong" when the truth is "nothing is wired" —
  exactly how ``drop_count_total``/``forward_count_total`` sat dead from
  the seed until PR 4 bridged the datapath metrics map into them.
- **Hot-loop observes.**  In the dispatch hot-path modules (files named
  ``dispatch.py`` or ``service.py``), a ``Histogram.observe`` call
  lexically inside a ``for``/``while`` loop is per-ENTRY cost on the
  path the project exists to make fast.  The latency-decomposition
  contract is one observe per stage per ROUND; a loop observe must be
  sample-guarded (an enclosing ``if`` whose condition mentions
  ``sample``/``slow`` or uses a modulo) or carry a justified pragma.
- **Hot-loop flow-record emission.**  Same modules, same reasoning for
  the flow-record ring (flowlog/ring.py): ``<flowlog>.add(...)`` /
  ``<flowlog>.append(...)`` inside a loop takes the ring lock per
  ENTRY.  The emission contract is per-ROUND columnar batches
  (``add_round``/``add_entries`` — the hot loop builds a plain list,
  the lock is taken once); a per-entry append must be sample-guarded
  or carry a justified pragma.
- **Hot-loop engine feeds (the columnar-reassembly contract).**  In
  the dispatch hot-path modules plus the columnar modules
  (``reasm.py``, ``mixbench.py``), a per-entry engine call —
  ``.feed(...)`` / ``.feed_extract(...)`` / ``.settle_entry(...)`` /
  ``.take_ops(...)`` — inside a loop is exactly the ~25µs/entry slow
  lane the columnar reassembler exists to replace (BENCH_NOTES r5);
  the surviving scalar-rung loops carry justified pragmas.  In the
  columnar modules themselves ANY ``.append(...)`` in a loop is
  flagged too: per-entry list building there means the columnar
  contract regressed to the shape it was built to kill.
"""

from __future__ import annotations

import ast
import os

from .core import Finding, call_func_name, unparse

_REG_CTORS = {"counter", "gauge", "histogram"}
_HOT_BASENAMES = {"dispatch.py", "service.py"}
# Columnar-contract modules: code whose reason to exist is replacing
# per-entry Python with array passes (sidecar/reasm.py and the mixed
# bench's round builder).
_COLUMNAR_BASENAMES = {"reasm.py", "mixbench.py", "dnsengine.py"}
_FEED_ATTRS = {"feed", "feed_extract", "settle_entry", "take_ops"}


def _registrations(sf):
    """Module-level ``NAME = <recv>.counter/gauge/histogram(...)``."""
    for node in sf.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and call_func_name(node.value) in _REG_CTORS
        ):
            yield node.targets[0].id, node.lineno


def _referenced_names(sf) -> set[str]:
    out = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.Name):
            out.add(node.id)
    return out


def _check_dead_metrics(files):
    reg_files = {
        path: sf for path, sf in files.items()
        if os.path.basename(path) == "metrics.py"
    }
    if not reg_files:
        return
    refs: set[str] = set()
    for path, sf in files.items():
        if path in reg_files:
            continue
        refs |= _referenced_names(sf)
    for path, sf in sorted(reg_files.items()):
        for name, line in _registrations(sf):
            if name not in refs:
                yield Finding(
                    "R7", path, line, 0,
                    f"metric {name} is registered but never referenced "
                    f"outside {os.path.basename(path)} — it exports a "
                    f"permanently-zero series (wire it or delete it)",
                    symbol=name,
                )


def _is_sample_guard(test: ast.AST) -> bool:
    """An If condition that rate-limits: mentions sample/slow or uses a
    modulo (``i % N == 0`` style)."""
    src = unparse(test).lower()
    if "sample" in src or "slow" in src:
        return True
    return any(
        isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod)
        for n in ast.walk(test)
    )


def _check_hot_loop_observes(files):
    for path, sf in sorted(files.items()):
        if os.path.basename(path) not in (
            _HOT_BASENAMES | _COLUMNAR_BASENAMES
        ):
            continue

        findings = []

        def visit(node, loop_depth, guarded):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "observe"
                and loop_depth > 0
                and not guarded
            ):
                findings.append(
                    Finding(
                        "R7", path, node.lineno, node.col_offset,
                        "Histogram.observe inside a dispatch hot "
                        "loop — per-entry metric cost on the "
                        "verdict path; record per ROUND or guard "
                        "with sampling",
                    )
                )
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("add", "append")
                and "flowlog" in unparse(node.func.value)
                .lower().replace("_", "")
                and loop_depth > 0
                and not guarded
            ):
                findings.append(
                    Finding(
                        "R7", path, node.lineno, node.col_offset,
                        "per-entry flow-record emission inside a "
                        "dispatch hot loop — the ring lock is taken "
                        "per ENTRY; build a plain list and emit one "
                        "add_round/add_entries per ROUND (or guard "
                        "with sampling)",
                    )
                )
            if isinstance(node, ast.If) and _is_sample_guard(node.test):
                # Only the guard's BODY is rate-limited; the else
                # branch runs on every un-sampled iteration.
                for child in node.body:
                    visit(child, loop_depth, True)
                for child in node.orelse:
                    visit(child, loop_depth, guarded)
                for child in (node.test,):
                    visit(child, loop_depth, guarded)
                return
            if isinstance(node, (ast.For, ast.While)):
                # A guard OUTSIDE the loop does not rate-limit the
                # per-entry observes inside it — the guard must sit
                # between the loop and the observe.
                for child in ast.iter_child_nodes(node):
                    visit(child, loop_depth + 1, False)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, loop_depth, guarded)

        visit(sf.tree, 0, False)
        yield from findings


def _check_hot_loop_feeds(files):
    """Per-entry engine feed/settle calls (and, in the columnar
    modules, ANY ``.append``) inside loops — the scalar slow-lane
    shape the columnar reassembler replaces.  Surviving scalar-rung
    loops carry justified pragmas; everything else is a regression."""
    for path, sf in sorted(files.items()):
        base = os.path.basename(path)
        hot = base in _HOT_BASENAMES
        columnar = base in _COLUMNAR_BASENAMES
        if not (hot or columnar):
            continue

        findings = []

        def visit(node, loop_depth, guarded):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and loop_depth > 0
                and not guarded
            ):
                attr = node.func.attr
                if attr in _FEED_ATTRS:
                    findings.append(
                        Finding(
                            "R7", path, node.lineno, node.col_offset,
                            f"per-entry engine .{attr}() inside a "
                            "hot loop — the ~25µs/entry slow-lane "
                            "shape the columnar reassembler "
                            "(sidecar/reasm.py) replaces; batch the "
                            "round columnar, or justify the scalar "
                            "rung with a pragma",
                        )
                    )
                elif columnar and attr == "append":
                    findings.append(
                        Finding(
                            "R7", path, node.lineno, node.col_offset,
                            "per-entry .append() in a columnar "
                            "module loop — reasm/mixbench exist to "
                            "replace per-entry list building with "
                            "array passes; vectorize it or justify "
                            "with a pragma",
                        )
                    )
            if isinstance(node, ast.If) and _is_sample_guard(node.test):
                for child in node.body:
                    visit(child, loop_depth, True)
                for child in node.orelse:
                    visit(child, loop_depth, guarded)
                for child in (node.test,):
                    visit(child, loop_depth, guarded)
                return
            if isinstance(node, (ast.For, ast.While)):
                for child in ast.iter_child_nodes(node):
                    visit(child, loop_depth + 1, False)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, loop_depth, guarded)

        visit(sf.tree, 0, False)
        yield from findings


def check_r7(files):
    yield from _check_dead_metrics(files)
    yield from _check_hot_loop_observes(files)
    yield from _check_hot_loop_feeds(files)
