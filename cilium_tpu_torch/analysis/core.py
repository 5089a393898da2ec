"""Framework for the invariant analyzer: findings, pragmas, file walk.

A *rule* is a function ``check(files) -> Iterable[Finding]`` where
``files`` maps absolute path -> :class:`SourceFile`.  Rules see the
whole scanned set at once so cross-file invariants (R5's wire
exhaustiveness, R1's swappable-attribute pre-pass) need no side
channel.

Suppression model — two layers, both checked in:

- **Pragmas** (per line, justified): ``# lint: disable=R2 -- reason``.
  The justification is mandatory; a pragma without one is an R0
  finding that cannot itself be suppressed.  A pragma on a
  comment-only line applies to the next line (for statements whose
  flagged line has no room).
- **Baseline** (``tests/lint_baseline_torch.json``): a checked-in list of
  ``{rule, file, symbol}`` entries for findings that are accepted
  wholesale.  New violations are never in the baseline, so they fail
  the build.  The shipped baseline is empty — inline pragmas carry
  every accepted suppression with its one-line why.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field

RULE_DOCS = {
    "R0": "lint hygiene: unparseable file or malformed/unjustified pragma",
    "R1": "lock discipline: acquire/finally pairing, captured-binding "
          "release, recorded lock-order graph",
    "R2": "blocking call (socket/queue/join/sleep/device) inside a "
          "held-lock region, or an unbounded spin-wait polling a "
          "shared slot without backoff/deadline",
    "R3": "socket close() with no dominating shutdown() — zombie "
          "listener / wedged-reader bug class",
    "R4": "function reached from a CUDA-graph capture (torch.cuda.graph "
          "block, _CudaGraphFn / _jit_for trace function, model entry "
          "point) mutates self, takes locks, does I/O, or reads the "
          "wall clock",
    "R5": "wire MSG_* constants and FilterResult codes must be "
          "exhaustively handled (or fall into a fail-closed default); "
          "pack_/unpack_ struct formats and JSON fields must be "
          "symmetric across the seam",
    "R6": "threading.Thread(...) without daemon= or a local join — "
          "leaks past the conftest thread guard",
    "R7": "metric hygiene: registered-but-unreferenced metric "
          "(permanently-zero series), or Histogram.observe inside a "
          "dispatch hot loop without per-round/sample guarding",
    "R8": "capture hazard in capture-reached code: Python-scalar "
          "concretization (int()/float()/bool() on tensor args), "
          "data-dependent shapes (torch.nonzero, masked_select, "
          "boolean-mask indexing), or torch.tensor(<scalar>) without "
          "dtype",
    "R9": "implicit host transfer: .item()/.cpu()/.tolist()/.numpy()/"
          "host-numpy coercion/synchronize inside capture-reached "
          "code, or a model output read (or the device synchronized) "
          "on the dispatch hot path outside _to_host/_issue_readback "
          "(the one sanctioned readback)",
    "R10": "per-slot fan-out consistency: a mesh slot's step "
           "(model.slots[i][j] fanned out by the sharded models) must "
           "be passed as many arguments as the step takes",
    "R11": "fused-attribution integrity: verdicts and verdicts_attr "
           "must consume ONE shared hit-matrix pass — the attr twin "
           "calling the plain twin (or a diverged hits helper) is a "
           "second device pass",
    "R12": "compile-on-dispatch-path: CUDA-graph capture/nvcc build/"
           "engine build/prewarm calls "
           "reachable from the dispatch/service hot loops, or made "
           "under a held lock in a hot module — recompiles belong on "
           "the policy builder thread behind a pointer-flip swap",
    "R13": "epoch-unkeyed cache in a hot module: a cache store whose "
           "key carries no epoch/generation term (and no sibling "
           "epoch store in the function), or a cache read with no "
           "epoch check anywhere in the consumer — a policy "
           "pointer-flip leaves such entries serving the old table",
    "R14": "exactly-once verdict accounting: an admit root that can "
           "bare-return without reaching an answer site or typed "
           "hand-off (silent loss), or two answer sites reachable "
           "for the same entry with no dominating exclusivity guard "
           "(answered cell / thread_round_is_shed / drain-lock pop) "
           "— the deposed-round double-reply class",
    "R15": "exception containment: a call chain that can raise out "
           "of a per-entry/per-round hot loop (dispatch/service/"
           "reasm roots) with no enclosing handler that produces a "
           "typed outcome (UNKNOWN_ERROR/SHED/demotion) — one bad "
           "entry aborts the drain and the rest leak unanswered",
    "R16": "graph shape-closure: a dispatch batch axis drawn from raw "
           "len()/.count/.shape instead of the declared power-of-two "
           "bucket universe keys a new CUDA graph per size — the "
           "op-trace twin (--device-contracts) audits the real "
           "serving surface against the enumerated closure",
    "R17": "snapshot round-trip symmetry: every top-level field a "
           "snapshot_* half writes must be consumed by its same-module "
           "restore_* twin (or named there as versioned-out), no "
           "hard-required restore field may go unwritten, and no "
           "snapshot half may ship without its twin — the "
           "restart-handoff drift class",
    "R18": "declared typestates: every state-field store must be a "
           "declared edge of its protocols.py transition table "
           "(mediated through advance/guard/require_edges), every "
           "counted edge's site must emit its declared metric token, "
           "and the table itself must be well-formed (reachable "
           "states, declared endpoints) — silent state flips and "
           "uncounted transitions are the bug class",
    "R19": "column-store lock discipline: every write to a declared "
           "shared numpy column family (subscript/slice/fill/np.add.at/"
           "rebind) must be reachable only with the owning lock held "
           "(lexically or at every call site), and a multi-column "
           "snapshot must be read in ONE lock trip — torn reads across "
           "separate acquisitions see half-mutated rows",
    "R20": "wire-protocol lifecycle: each MSG_* must match its "
           "declared WIRE_MESSAGES row — direction (who sends/handles "
           "it), request/reply pairing (the handler reaches a send of "
           "the declared reply), fire-and-forget consistency, gate "
           "tokens referenced on both seam ends, and native-shim enum "
           "values bit-identical on shared names",
    "R21": "parity-coverage registry: every runtime-registered framing "
           "family must declare (and actually ship) its landing bar — "
           "columnar model, host oracle, every-byte-offset parity "
           "test, bench config, and stress-mix slice — and every "
           "declared family must be registered",
    "R22": "fail-closed recorder coverage: every FAIL_CLOSED row must "
           "name a declared typestate edge (or carry a marker token) "
           "and reach a flight-recorder emit site — a mediated "
           "transition into the edge's target state, or a "
           "record_mark/broadcast_mark call carrying the token — so "
           "no declared fail-closed transition is invisible to the "
           "incident timeline and its postmortem bundle",
    "R23": "unledgered compile site: every executable-producing call "
           "(nvcc build, CUDA-graph capture, prewarm, engine- and "
           "mesh-model builds) reachable from "
           "the dispatch or policy-builder roots of the hot modules "
           "must route through the device-economics ledger "
           "(record_compile/broadcast_compile or a cause_scope) so the "
           "per-cause compile census is complete and warm-churn-is-"
           "zero-compiles stays an asserted invariant",
}

# ``# lint: disable=R1,R2 -- why this is safe`` (em-dash also accepted).
_PRAGMA_OK = re.compile(
    r"#\s*lint:\s*disable=([A-Z0-9]+(?:\s*,\s*[A-Z0-9]+)*)\s*"
    r"(?:--|—)\s*(\S.*?)\s*$"
)
_PRAGMA_ANY = re.compile(r"#\s*lint:")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    symbol: str = ""
    suppressed: bool = False
    justification: str = ""
    baselined: bool = False

    def render(self) -> str:
        where = f" [in {self.symbol}]" if self.symbol else ""
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule}: "
            f"{self.message}{where}"
        )

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "file": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
            "suppressed": self.suppressed,
            "justification": self.justification,
            "baselined": self.baselined,
        }


class SourceFile:
    """One parsed file: tree, lines, and its pragma table."""

    def __init__(self, path: str, text: str,
                 content_hash: str | None = None) -> None:
        self.path = path
        self.text = text
        self.content_hash = content_hash or hashlib.sha256(
            text.encode()).hexdigest()
        self.lines = text.splitlines()
        self.tree: ast.Module | None = None
        self.parse_error: str | None = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.parse_error = f"{e.msg} (line {e.lineno})"
        # line -> (set of rule ids, justification)
        self.pragmas: dict[int, tuple[set[str], str]] = {}
        # lines carrying a pragma-looking comment that failed the format
        self.bad_pragmas: list[tuple[int, str]] = []
        self._scan_pragmas()

    def _scan_pragmas(self) -> None:
        # Scan real COMMENT tokens, not raw lines: a pragma-shaped
        # substring inside a string/docstring (e.g. this framework's
        # own docs documenting the format) must neither register a
        # suppression nor trip R0.
        try:
            toks = [
                t for t in tokenize.generate_tokens(
                    io.StringIO(self.text).readline)
                if t.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, SyntaxError, IndentationError):
            # Untokenizable ⇒ unparseable: analyze_paths already emits
            # the R0 parse error and never consults this pragma table.
            return
        for tok in toks:
            i, col = tok.start
            comment = tok.string
            if not _PRAGMA_ANY.search(comment):
                continue
            m = _PRAGMA_OK.search(comment)
            if not m:
                self.bad_pragmas.append(
                    (i, "malformed lint pragma: expected "
                        "'# lint: disable=<RULES> -- <justification>' "
                        "(justification mandatory)")
                )
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            just = m.group(2).strip()
            entry = (rules, just)
            self._merge_pragma(i, entry)
            if not self.lines[i - 1][:col].strip():
                # Comment-only line: the pragma governs the next line.
                self._merge_pragma(i + 1, entry)

    def _merge_pragma(self, line: int, entry: tuple[set[str], str]) -> None:
        old = self.pragmas.get(line)
        if old is None:
            self.pragmas[line] = (set(entry[0]), entry[1])
        else:
            old[0].update(entry[0])

    def suppression(self, line: int, rule: str) -> str | None:
        """Justification text if ``rule`` is pragma-suppressed at
        ``line``, else None."""
        got = self.pragmas.get(line)
        if got is not None and rule in got[0]:
            return got[1]
        return None


# --- shared AST helpers ---------------------------------------------------

def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — defensive; lint must not crash
        return "<?>"


def terminal_name(expr: ast.AST) -> str:
    """Last path component of a Name/Attribute chain ('' otherwise)."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return ""


def call_func_name(call: ast.Call) -> str:
    return terminal_name(call.func)


_LOCK_NAME = re.compile(r"(lock|mutex|mu)$", re.IGNORECASE)
_LOCK_EXTRA = {"_down_once", "_cond", "_done"}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Mutex", "RWMutex"}


def is_lock_like_name(name: str) -> bool:
    return bool(name) and (bool(_LOCK_NAME.search(name))
                           or name in _LOCK_EXTRA)


def is_lock_ctor(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Call)
            and call_func_name(expr) in _LOCK_CTORS)


def local_assignments(func: ast.AST) -> dict[str, ast.AST]:
    """name -> last simple-RHS assignment in the function body (used to
    resolve ``lk = self._in_process_lock`` style aliases)."""
    out: dict[str, ast.AST] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                out[t.id] = node.value
    return out


def lock_terminal(expr: ast.AST, aliases: dict[str, ast.AST]) -> str:
    """Terminal lock name for a with/acquire receiver, following one
    level of local alias (``lk = self._in_process_lock``)."""
    if isinstance(expr, ast.Name) and expr.id in aliases:
        aliased = terminal_name(aliases[expr.id])
        if aliased:
            return aliased
    # ``rw.read()`` reader guard: the lock is the receiver.
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        return lock_terminal(expr.func.value, aliases)
    return terminal_name(expr)


def is_lock_like_expr(expr: ast.AST, aliases: dict[str, ast.AST]) -> bool:
    name = lock_terminal(expr, aliases)
    if is_lock_like_name(name):
        return True
    if isinstance(expr, ast.Name):
        rhs = aliases.get(expr.id)
        if rhs is not None and (is_lock_ctor(rhs)
                                or is_lock_like_name(terminal_name(rhs))):
            return True
    return False


def walk_functions(tree: ast.Module):
    """Yield (funcdef, qualname, enclosing_class_or_None), outermost
    first, for every def/async def in the module."""
    def rec(node, stack, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(stack + [child.name])
                yield child, qual, cls
                yield from rec(child, stack + [child.name], cls)
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, stack + [child.name], child)
            else:
                yield from rec(child, stack, cls)

    yield from rec(tree, [], None)


def enclosing_symbol(tree: ast.Module, line: int) -> str:
    """Qualname of the innermost function containing ``line``."""
    best = ""
    best_span = None
    for fn, qual, _cls in walk_functions(tree):
        end = getattr(fn, "end_lineno", fn.lineno)
        if fn.lineno <= line <= end:
            span = end - fn.lineno
            if best_span is None or span <= best_span:
                best, best_span = qual, span
    return best


# --- baseline -------------------------------------------------------------

def load_baseline_full(path: str) -> dict:
    """Normalized baseline: {"accepted": [entries], "max_suppressed":
    int | None}.  Accepts the legacy bare-list form (accepted entries
    only) and the ratchet form ({"accepted": [...], "max_suppressed":
    N} — the count ``--ratchet`` enforces may only decrease)."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, list):
        return {"accepted": data, "max_suppressed": None}
    if isinstance(data, dict):
        accepted = data.get("accepted", [])
        maxs = data.get("max_suppressed")
        if not isinstance(accepted, list) or not (
            maxs is None or isinstance(maxs, int)
        ):
            raise ValueError(
                f"baseline {path}: expected accepted=list, "
                f"max_suppressed=int"
            )
        return {"accepted": accepted, "max_suppressed": maxs}
    raise ValueError(f"baseline {path}: expected a JSON list or object")


def load_baseline(path: str) -> list[dict]:
    """Accepted-entry list (both baseline forms)."""
    return load_baseline_full(path)["accepted"]


def _baseline_matches(entry: dict, f: Finding) -> bool:
    if entry.get("rule") != f.rule:
        return False
    ef = entry.get("file", "")
    norm = f.path.replace(os.sep, "/")
    if ef and not norm.endswith(ef):
        return False
    sym = entry.get("symbol")
    if sym is not None and sym != f.symbol:
        return False
    return True


# --- driver ---------------------------------------------------------------

# Content-hash-keyed parse cache: parsing + tokenizing dominates a lint
# pass, and the tier-1 gate runs analyze_paths dozens of times over the
# same tree in one process (tree gate, corpus cases, CLI-contract
# tests).  Keyed by (path, sha256) so an edited file re-parses while
# everything else is reused; bounded so a long-lived process (or the
# corpus churn of a test run) cannot grow it without limit.
_SF_CACHE: dict[tuple[str, str], SourceFile] = {}
_SF_CACHE_MAX = 4096


def _load_source(path: str, text: str) -> SourceFile:
    digest = hashlib.sha256(text.encode()).hexdigest()
    key = (path, digest)
    sf = _SF_CACHE.get(key)
    if sf is None:
        if len(_SF_CACHE) >= _SF_CACHE_MAX:
            _SF_CACHE.clear()
        sf = SourceFile(path, text, content_hash=digest)
        _SF_CACHE[key] = sf
    return sf


def _collect_py(paths) -> list[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d != "__pycache__" and not d.startswith(".")
                )
                for n in sorted(names):
                    if n.endswith(".py"):
                        out.append(os.path.join(root, n))
        elif p.endswith(".py"):
            out.append(p)
    return out


def all_rules():
    from . import (
        rules_answers,
        rules_blackbox,
        rules_cache,
        rules_compile,
        rules_contain,
        rules_device,
        rules_handoff,
        rules_jit,
        rules_ledger,
        rules_locks,
        rules_columns,
        rules_metrics,
        rules_parity,
        rules_protocol,
        rules_sockets,
        rules_typestate,
        rules_wire,
    )

    return [
        rules_locks.check_r1,
        rules_locks.check_r2,
        rules_sockets.check_r3,
        rules_jit.check_r4,
        rules_wire.check_r5,
        rules_sockets.check_r6,
        rules_metrics.check_r7,
        rules_device.check_r8,
        rules_device.check_r9,
        rules_device.check_r10,
        rules_device.check_r11,
        rules_compile.check_r12,
        rules_cache.check_r13,
        rules_answers.check_r14,
        rules_contain.check_r15,
        rules_device.check_r16,
        rules_handoff.check_r17,
        rules_typestate.check_r18,
        rules_columns.check_r19,
        rules_protocol.check_r20,
        rules_parity.check_r21,
        rules_blackbox.check_r22,
        rules_ledger.check_r23,
    ]


def _run_rule_cached(rule, files):
    """Run a rule through the content-keyed memo: identical scanned
    content re-yields a rule's findings without re-walking a single
    AST.  Findings are REBUILT fresh on every hit — analyze_paths
    mutates suppression/baseline state per run, and that state must
    never leak between runs with different baselines."""
    from .callgraph import get_graph

    memo = get_graph(files).rule_memo
    key = f"{rule.__module__}.{rule.__qualname__}"
    # Rules that consult files OUTSIDE the scanned set (the native
    # header, tests/, bench.py) expose a ``memo_extra`` callable whose
    # digest of that external state joins the memo key — otherwise an
    # edit out there would re-serve stale findings from the memo.
    extra = getattr(rule, "memo_extra", None)
    if extra is not None:
        key += ":" + extra(files)
    got = memo.get(key)
    if got is None:
        got = list(rule(files))
        memo[key] = got
    return [
        Finding(f.rule, f.path, f.line, f.col, f.message,
                symbol=f.symbol)
        for f in got
    ]


def analyze_paths(
    paths,
    rules=None,
    baseline: list[dict] | None = None,
) -> list[Finding]:
    """Run the rule set; returns ALL findings (suppressed/baselined ones
    flagged, not dropped) sorted by (path, line, rule)."""
    files: dict[str, SourceFile] = {}
    findings: list[Finding] = []
    for path in _collect_py(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                text = fh.read()
        except OSError as e:
            findings.append(Finding("R0", path, 0, 0, f"unreadable: {e}"))
            continue
        sf = _load_source(path, text)
        if sf.parse_error is not None:
            findings.append(
                Finding("R0", path, 0, 0, f"parse error: {sf.parse_error}")
            )
            continue
        files[path] = sf
        for line, msg in sf.bad_pragmas:
            findings.append(Finding("R0", path, line, 0, msg))

    for rule in (rules if rules is not None else all_rules()):
        findings.extend(_run_rule_cached(rule, files))

    for f in findings:
        sf = files.get(f.path)
        if sf is None:
            continue
        if not f.symbol and sf.tree is not None:
            f.symbol = enclosing_symbol(sf.tree, f.line)
        if f.rule == "R0":
            continue  # pragma hygiene findings are unsuppressable
        just = sf.suppression(f.line, f.rule)
        if just is not None:
            f.suppressed = True
            f.justification = just
        if baseline:
            for entry in baseline:
                if _baseline_matches(entry, f):
                    f.baselined = True
                    break

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def split_findings(findings):
    """(active, suppressed) — active findings fail the build."""
    active = [f for f in findings if not f.suppressed and not f.baselined]
    muted = [f for f in findings if f.suppressed or f.baselined]
    return active, muted


def findings_to_json(findings) -> dict:
    active, muted = split_findings(findings)
    counts: dict[str, int] = {}
    for f in active:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "findings": [f.to_dict() for f in active],
        "suppressed": [f.to_dict() for f in muted],
        "counts": counts,
        "total": len(active),
    }
