"""Whole-program interprocedural engine: modules, imports, call graph.

PR 3's rules were deliberately AST-local — R4's docstring said it out
loud ("cross-module reachability is out of scope").  The hazards the
next ROADMAP items introduce are exactly the ones that scoping hides: a
blocking ``sendall`` reached through ``utils.sockutil``, a lock-order
inversion whose two halves live in ``sidecar/`` and ``kvstore/``,
capture impurity in a ``models/base.py`` helper reached from a
``service.py`` CUDA-graph capture.  This module gives every rule the project-wide view:

- **Module naming.**  A scanned file's dotted module name is derived
  from the ``__init__.py`` package chain above it
  (``cilium_tpu_torch/sidecar/client.py`` ->
  ``cilium_tpu_torch.sidecar.client``);
  files outside any package (the lint corpus) are top-level modules
  named by stem, so a two-file corpus pair exercises the same
  resolution the real tree does.
- **Import resolution.**  ``import a.b as c`` / ``from ..utils import
  sockutil`` / ``from .core import Finding`` all resolve against the
  scanned set, including relative levels and the from-import-of-a-
  submodule case.
- **Call resolution.**  Bare names resolve to module-level defs or
  from-imports; ``alias.f()`` resolves through module aliases;
  ``self.m()`` resolves to methods of the enclosing class first, then
  (same-module approximation) any same-named method.  Unresolvable
  receivers stay unresolved — precision over recall, so interprocedural
  findings are trustworthy enough to gate a build on.
- **Function summaries.**  Per function: direct blocking calls, locks
  acquired, call sites with the lock stack held at that point.  A
  fixed-point pass turns those into transitive facts (``blocks_via``:
  the helper chain to a blocking call; ``acquires``: every lock
  identity a call may take), which R1/R2/R4 consume.

Lock identity is qualified — ``Class._lock`` for ``self`` attributes,
``module:name`` for locals/globals — so the whole-program lock-order
graph never conflates two classes' equally-named ``_lock`` attributes:
an inversion finding requires the SAME two identities observed in both
orders.

The graph is memoized per content-hash of the scanned set (see
``get_graph``), which is what keeps the tier-1 gate fast: one build is
shared by every rule and every analyze_paths call in the process.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from .core import (
    is_lock_like_expr,
    local_assignments,
    lock_terminal,
    unparse,
    walk_functions,
)

# Functions that ARE lock implementations or guards (mirrors
# rules_locks: pairing/blocking inside them is the mechanism, not a
# bug) — taint and lock summaries do not propagate OUT of them either,
# or every ``with lock:`` would inherit Lock.acquire's own guts.
WRAPPER_FUNCS = {
    "acquire", "release", "r_acquire", "r_release",
    "__enter__", "__exit__", "locked", "read",
}


def module_name_for(path: str) -> tuple[str, bool]:
    """(dotted module name, in_package) from the ``__init__.py`` chain
    above path.  Files outside any package report in_package=False —
    the caller must key them by DIRECTORY too, or two corpus dirs'
    equally-named ``client.py`` files would clobber each other's
    symbol tables and silently disable the interprocedural rules."""
    path = os.path.abspath(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    parts = [] if stem == "__init__" else [stem]
    d = os.path.dirname(path)
    in_package = os.path.exists(os.path.join(d, "__init__.py"))
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return ".".join(parts) if parts else stem, in_package


@dataclass
class FuncInfo:
    node: ast.AST  # FunctionDef / AsyncFunctionDef
    module: str
    path: str
    qual: str
    cls: str  # enclosing class name, "" at module level
    cls_node: "ast.ClassDef | None" = None
    # Uniquifier for duplicate qualnames (property getter/setter
    # pairs, same-name defs in both branches of an if): without it the
    # funcs table is last-wins and the shadowed def silently drops out
    # of capture reachability.
    key_suffix: str = ""
    # direct facts (own body only, nested defs excluded)
    blocking: list = field(default_factory=list)  # (reason, line, col)
    acquired: set = field(default_factory=set)  # lock identities
    # lexical lock nestings: (outer_ident, inner_ident, line, col) —
    # ``with a: with b:`` AND ``with a, b:`` both count
    lex_nestings: list = field(default_factory=list)
    # (call node, line, col, held lock-identity tuple, callee key list)
    calls: list = field(default_factory=list)
    # transitive facts (fixed point)
    blocks_via: "tuple | None" = None  # (chain tuple, reason) or None
    t_acquires: dict = field(default_factory=dict)
    # lock identity -> call chain tuple that reaches its acquire

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qual}{self.key_suffix}"

    @property
    def name(self) -> str:
        return self.node.name


class _Imports:
    """One module's import table: alias -> resolved dotted target."""

    def __init__(self) -> None:
        # alias -> ("module", dotted) or ("symbol", dotted_module, name)
        self.aliases: dict[str, tuple] = {}

    def module_for(self, name: str) -> str | None:
        got = self.aliases.get(name)
        if got is not None and got[0] == "module":
            return got[1]
        return None

    def symbol_for(self, name: str) -> tuple[str, str] | None:
        got = self.aliases.get(name)
        if got is not None and got[0] == "symbol":
            return got[1], got[2]
        return None


class ProjectGraph:
    """Symbol tables + call graph + summaries over one scanned set."""

    def __init__(self, files: dict) -> None:
        self.files = files
        # Per-rule scratch memo: rules stash expensive intermediates
        # (or serialized findings) here; the graph itself is memoized
        # by content hash, so entries inherit correct invalidation.
        self.rule_memo: dict = {}
        self.modules: dict[str, str] = {}  # module key -> path
        self.mod_of_path: dict[str, str] = {}
        # (directory, stem) -> module key, for resolving bare imports
        # between NON-package files: two scanned dirs may each hold a
        # ``client.py``, so their keys carry the directory and a bare
        # ``import wire`` resolves against the importer's own dir.
        self._dir_stems: dict[tuple[str, str], str] = {}
        for path in files:
            mod, in_pkg = module_name_for(path)
            d = os.path.dirname(os.path.abspath(path))
            if not in_pkg:
                key = f"{d}::{mod}"
                self._dir_stems[(d, mod)] = key
                mod = key
            self.modules[mod] = path
            self.mod_of_path[path] = mod
        self.imports: dict[str, _Imports] = {}
        # module -> {func bare/qual name -> [FuncInfo]}
        self.defs: dict[str, dict[str, list[FuncInfo]]] = {}
        # module -> {class name -> {method name -> FuncInfo}}
        self.methods: dict[str, dict[str, dict[str, FuncInfo]]] = {}
        # module -> {class name -> [base class dotted refs]}
        self.bases: dict[str, dict[str, list[str]]] = {}
        self.funcs: dict[str, FuncInfo] = {}  # key -> FuncInfo
        self.by_node: dict[int, FuncInfo] = {}  # id(fn node) -> info
        for path, sf in files.items():
            self._index_module(self.mod_of_path[path], path, sf)
        for fi in self.funcs.values():
            self._summarize(fi)
        self._resolve_calls()
        self._fixpoint()

    # -- indexing ----------------------------------------------------------

    def _resolve_modref(self, name: str, cur_dir: str) -> str:
        """Registered module key for a (possibly bare) module
        reference: dotted package names match directly; bare stems
        resolve against the importer's own directory."""
        if name in self.modules:
            return name
        return self._dir_stems.get((cur_dir, name), name)

    def _index_module(self, mod: str, path: str, sf) -> None:
        imp = _Imports()
        self.imports[mod] = imp
        cur_dir = os.path.dirname(os.path.abspath(path))
        # Relative-import anchor: for pkg/__init__.py the module name
        # IS the package, so level-1 imports anchor at mod itself;
        # everywhere else at the containing package.
        if "::" in mod:
            pkg_parts = []
        elif os.path.basename(path) == "__init__.py":
            pkg_parts = mod.split(".")
        else:
            pkg_parts = mod.split(".")[:-1]
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    target = a.name if a.asname else a.name.split(".")[0]
                    imp.aliases[alias] = (
                        "module", self._resolve_modref(target, cur_dir)
                    )
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    anchor = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    base = ".".join(anchor + ([base] if base else []))
                base = self._resolve_modref(base, cur_dir)
                for a in node.names:
                    if a.name == "*":
                        continue
                    alias = a.asname or a.name
                    sub = f"{base}.{a.name}" if base else a.name
                    if sub in self.modules:
                        imp.aliases[alias] = ("module", sub)
                    else:
                        imp.aliases[alias] = ("symbol", base, a.name)

        table: dict[str, list[FuncInfo]] = {}
        meths: dict[str, dict[str, FuncInfo]] = {}
        bases: dict[str, list[str]] = {}
        for fn, qual, cls in walk_functions(sf.tree):
            fi = FuncInfo(node=fn, module=mod, path=path, qual=qual,
                          cls=cls.name if cls is not None else "",
                          cls_node=cls)
            if fi.key in self.funcs:
                fi.key_suffix = f"@{fn.lineno}"
            table.setdefault(fn.name, []).append(fi)
            if qual != fn.name:
                table.setdefault(qual, []).append(fi)
            if cls is not None:
                meths.setdefault(cls.name, {})[fn.name] = fi
            self.funcs[fi.key] = fi
            self.by_node[id(fn)] = fi
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                bases[node.name] = [unparse(b) for b in node.bases]
        self.defs[mod] = table
        self.methods[mod] = meths
        self.bases[mod] = bases

    # -- call resolution ---------------------------------------------------

    def resolve_call(self, call: ast.Call, fi: FuncInfo) -> list[FuncInfo]:
        """FuncInfos a call site may invoke (empty when unresolvable)."""
        func = call.func
        mod = fi.module
        imp = self.imports[mod]
        if isinstance(func, ast.Name):
            name = func.id
            sym = imp.symbol_for(name)
            if sym is not None:
                tmod, tname = sym
                if tmod in self.defs:
                    return [
                        f for f in self.defs[tmod].get(tname, ())
                        if f.cls == ""
                    ]
                return []
            local = [f for f in self.defs[mod].get(name, ()) if f.cls == ""]
            if local:
                return local
            # class constructor: Foo() runs Foo.__init__
            init = self.methods[mod].get(name, {}).get("__init__")
            if init is not None:
                return [init]
            return []
        if isinstance(func, ast.Attribute):
            attr = func.attr
            recv = func.value
            # self.m() — enclosing class first (incl. resolved bases),
            # then the same-module name approximation.
            if isinstance(recv, ast.Name) and recv.id == "self":
                got = self._resolve_method(mod, fi.cls, attr)
                if got:
                    return got
                out = []
                for meths in self.methods[mod].values():
                    if attr in meths:
                        out.append(meths[attr])
                return out
            # module_alias.f() / pkg.sub.f()
            tmod = self._module_of_expr(recv, imp)
            if tmod is not None and tmod in self.defs:
                return [
                    f for f in self.defs[tmod].get(attr, ())
                    if f.cls == ""
                ]
            # Cls.m() — class referenced by name (same module or import)
            if isinstance(recv, ast.Name):
                got = self.methods[mod].get(recv.id, {}).get(attr)
                if got is not None:
                    return [got]
                sym = imp.symbol_for(recv.id)
                if sym is not None:
                    tmod2, cname = sym
                    got = self.methods.get(tmod2, {}).get(
                        cname, {}
                    ).get(attr)
                    if got is not None:
                        return [got]
        return []

    def _module_of_expr(self, expr: ast.AST, imp: _Imports) -> str | None:
        """Dotted module named by an expression (``alias`` or
        ``alias.sub`` chains), if it is a scanned module."""
        if isinstance(expr, ast.Name):
            return imp.module_for(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self._module_of_expr(expr.value, imp)
            if base is not None:
                cand = f"{base}.{expr.attr}"
                if cand in self.modules:
                    return cand
        return None

    def _resolve_method(self, mod: str, cls: str, attr: str,
                        _seen: frozenset = frozenset()) -> list[FuncInfo]:
        """Method lookup through the (resolved) base-class chain."""
        if not cls or mod not in self.imports or (mod, cls) in _seen:
            return []
        got = self.methods.get(mod, {}).get(cls, {}).get(attr)
        if got is not None:
            return [got]
        out: list[FuncInfo] = []
        seen = _seen | {(mod, cls)}
        imp = self.imports[mod]
        for base_ref in self.bases.get(mod, {}).get(cls, ()):
            base_name = base_ref.split(".")[-1]
            if base_name in self.methods.get(mod, {}):
                out.extend(
                    self._resolve_method(mod, base_name, attr, seen)
                )
                continue
            head = base_ref.split(".")[0]
            sym = imp.symbol_for(head)
            if sym is not None:
                # ``from .base import VerdictModel`` then
                # ``class M(VerdictModel)`` — the base lives in the
                # imported module under its imported name.
                tmod, tname = sym
                out.extend(self._resolve_method(
                    tmod, tname if head == base_ref else base_name,
                    attr, seen))
                continue
            tmod = imp.module_for(head)
            if tmod is not None and "." in base_ref:
                out.extend(
                    self._resolve_method(tmod, base_name, attr, seen)
                )
        return out

    # -- lock identity -----------------------------------------------------

    def lock_identity(self, expr: ast.AST, fi: FuncInfo,
                      aliases: dict) -> str | None:
        """Qualified identity for a lock expression: ``Cls.attr`` for
        self attributes, ``module:name`` for locals/globals, terminal
        name otherwise.  None when the expression isn't lock-like."""
        if not is_lock_like_expr(expr, aliases):
            return None
        term = lock_terminal(expr, aliases)
        if not term:
            return None
        # unwrap rw.read()-style guards to the receiver for ownership
        probe = expr
        if isinstance(probe, ast.Call) and isinstance(
                probe.func, ast.Attribute):
            probe = probe.func.value
        if isinstance(probe, ast.Name) and probe.id in aliases:
            probe = aliases[probe.id]
        if (isinstance(probe, ast.Attribute)
                and isinstance(probe.value, ast.Name)
                and probe.value.id == "self"):
            return f"{fi.cls or fi.module}.{term}"
        if isinstance(probe, ast.Name):
            # A lock imported by name belongs to its DEFINING module:
            # ``from store import _store_lock`` used here is the same
            # object as store's own — the cross-module sharing that
            # makes cross-module deadlocks possible in the first
            # place.
            sym = self.imports[fi.module].symbol_for(probe.id)
            if sym is not None:
                return f"{sym[0]}:{sym[1]}"
            return f"{fi.module}:{term}"
        if isinstance(probe, ast.Attribute):
            # ``store._store_lock`` through a module alias: same
            # defining-module identity as store's own uses.
            tmod = self._module_of_expr(
                probe.value, self.imports[fi.module]
            )
            if tmod is not None:
                return f"{tmod}:{term}"
        return term

    @staticmethod
    def lock_terminal_of(identity: str) -> str:
        """Back out the bare attribute/local name from an identity."""
        return identity.split(".")[-1].split(":")[-1]

    # -- summaries ---------------------------------------------------------

    def _summarize(self, fi: FuncInfo) -> None:
        from .rules_locks import _blocking_reason  # shared taxonomy

        fn = fi.node
        aliases = local_assignments(fn)

        def visit(node, held: tuple) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if isinstance(node, ast.With):
                taken = list(held)
                for item in node.items:
                    # Earlier items of the same statement count as
                    # held for later ones (``with a, b:`` nests).
                    visit(item.context_expr, tuple(taken))
                    ident = self.lock_identity(item.context_expr, fi,
                                               aliases)
                    if ident is not None:
                        fi.acquired.add(ident)
                        for h in taken:
                            fi.lex_nestings.append(
                                (h, ident, node.lineno,
                                 node.col_offset)
                            )
                        taken.append(ident)
                for stmt in node.body:
                    visit(stmt, tuple(taken))
                return
            if isinstance(node, ast.Call):
                reason = _blocking_reason(node)
                if reason is not None:
                    fi.blocking.append(
                        (reason, node.lineno, node.col_offset)
                    )
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "acquire"):
                    ident = self.lock_identity(node.func.value, fi,
                                               aliases)
                    if ident is not None:
                        fi.acquired.add(ident)
                fi.calls.append(
                    [node, node.lineno, node.col_offset, held, None]
                )
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, ())

    def _resolve_calls(self) -> None:
        for fi in self.funcs.values():
            for entry in fi.calls:
                targets = self.resolve_call(entry[0], fi)
                entry[4] = [t.key for t in targets if t.key != fi.key]

    def _fixpoint(self) -> None:
        """Propagate blocking taint and transitive lock acquisition up
        the call graph to a fixed point.  Wrapper functions neither
        source nor forward facts (their insides are the mechanism)."""
        for fi in self.funcs.values():
            if fi.name in WRAPPER_FUNCS:
                fi.blocks_via = None
                fi.t_acquires = {}
                continue
            fi.blocks_via = (
                ((), fi.blocking[0][0]) if fi.blocking else None
            )
            fi.t_acquires = {ident: () for ident in fi.acquired}

        changed = True
        guard = 0
        while changed and guard < 100:
            changed = False
            guard += 1
            for fi in self.funcs.values():
                if fi.name in WRAPPER_FUNCS:
                    continue
                for _call, _l, _c, _held, keys in fi.calls:
                    for key in keys or ():
                        callee = self.funcs.get(key)
                        if callee is None or callee.name in WRAPPER_FUNCS:
                            continue
                        if callee.blocks_via is not None and \
                                fi.blocks_via is None:
                            chain, reason = callee.blocks_via
                            if len(chain) < 6:
                                fi.blocks_via = (
                                    (callee.key,) + chain, reason
                                )
                                changed = True
                        for ident, chain in callee.t_acquires.items():
                            if ident not in fi.t_acquires and \
                                    len(chain) < 6:
                                fi.t_acquires[ident] = (
                                    (callee.key,) + chain
                                )
                                changed = True

    # -- rendered helpers --------------------------------------------------

    def chain_text(self, chain: tuple) -> str:
        """Human chain rendering: a -> b -> c (short quals)."""
        return " -> ".join(
            k.rsplit(":", 1)[-1].split("@")[0] if ":" in k else k
            for k in chain
        )

    def info_for(self, fn_node: ast.AST) -> FuncInfo | None:
        return self.by_node.get(id(fn_node))


# --- memoized construction ------------------------------------------------

_GRAPH_CACHE: dict[frozenset, ProjectGraph] = {}
_GRAPH_CACHE_MAX = 8


def get_graph(files: dict) -> ProjectGraph:
    """The ProjectGraph for this scanned set, memoized by content hash
    so every rule (and every analyze_paths call over identical content)
    shares one build — the call-graph half of the lint cache.

    Cache hits additionally require OBJECT identity with the graph's
    own SourceFiles: the graph's node tables are id()-keyed, so a
    graph built from an evicted parse generation would silently miss
    every lookup against freshly re-parsed trees (zero findings, no
    error).  Same content but new objects ⇒ rebuild."""
    key = frozenset(
        (path, sf.content_hash) for path, sf in files.items()
    )
    got = _GRAPH_CACHE.get(key)
    if got is not None and all(
        got.files.get(p) is sf for p, sf in files.items()
    ):
        return got
    if len(_GRAPH_CACHE) >= _GRAPH_CACHE_MAX:
        _GRAPH_CACHE.pop(next(iter(_GRAPH_CACHE)))
    got = ProjectGraph(dict(files))
    _GRAPH_CACHE[key] = got
    return got
