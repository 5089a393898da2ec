"""R21 — machine-checked parity coverage for the framing registry.

ROADMAP's landing bar says every framing family ships five artifacts:
a columnar model, a host-side oracle parser, an every-byte-offset
parity test, a bench config, and a stress-mix slice.  This pass turns
that prose into a checked registry: ``analysis/protocols.py::
ENGINE_FAMILIES`` declares the five artifact coordinates per family,
and the checker proves (a) the declared families and the runtime
``reasm.FRAMINGS`` registration agree in BOTH directions — an
unregistered family is dead coverage, an undeclared framing is an
engine with no landing bar — and (b) every declared artifact actually
exists and names the family where it claims to.

Resolution order is scanned-set first (so a corpus twin directory is
self-contained), then disk relative to the roots derived from the
``FRAMINGS``-defining file: ``pkg_root`` is two levels above it
(``pkg/sidecar/reasm.py`` → ``pkg/``) and ``repo_root`` one above
that.  Disk fallback is what lets the tree gate — which scans only the
package — verify artifacts living in ``tests/`` and ``bench.py``; the
rule's ``memo_extra`` keys the memo on those files' stat signatures so
editing them invalidates cached findings.
"""

from __future__ import annotations

import ast
import glob as _glob
import hashlib
import os

from .core import Finding


def _extract_families(files):
    """(rows list, defining path, line) for ``ENGINE_FAMILIES``."""
    for path, sf in sorted(files.items()):
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "ENGINE_FAMILIES"):
                try:
                    rows = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    continue
                rows = [r for r in rows
                        if isinstance(r, dict) and r.get("kind")]
                return rows, path, node.lineno
    return [], None, 0


def _const_pool(sf) -> dict[str, str]:
    pool: dict[str, str] = {}
    for node in sf.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            pool[node.targets[0].id] = node.value.value
    return pool


def _extract_framings(files):
    """(registered kind -> line, defining path) from the runtime
    ``FRAMINGS = {...}`` registry (plain or annotated assign); dict
    keys may be names resolved through the file's constant pool."""
    for path, sf in sorted(files.items()):
        pool = None
        for node in sf.tree.body:
            value = None
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "FRAMINGS"):
                value = node.value
            elif (isinstance(node, ast.AnnAssign)
                    and isinstance(node.target, ast.Name)
                    and node.target.id == "FRAMINGS"):
                value = node.value
            if not isinstance(value, ast.Dict):
                continue
            if pool is None:
                pool = _const_pool(sf)
            kinds: dict[str, int] = {}
            for k in value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    kinds[k.value] = k.lineno
                elif isinstance(k, ast.Name) and k.id in pool:
                    kinds[pool[k.id]] = k.lineno
            return kinds, path
    return None, None


def _scanned_suffix(files, rel: str):
    want = rel.replace("/", os.sep)
    for path in sorted(files):
        if path.endswith(os.sep + want) or path == want:
            return path
    return None


def _scanned_basename_text(files, base: str):
    for path, sf in sorted(files.items()):
        if os.path.basename(path) == base:
            return sf.text
    return None


def _disk_text(path: str) -> str | None:
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.read()
    except OSError:
        return None


def _roots(files):
    """(pkg_root, repo_root) derived from the FRAMINGS-defining file —
    or from any scanned file as a degraded fallback."""
    kinds_path = None
    for path, sf in sorted(files.items()):
        if "FRAMINGS" in sf.text:
            k, p = _extract_framings({path: sf})
            if k is not None:
                kinds_path = p
                break
    if kinds_path is None:
        kinds_path = next(iter(sorted(files)), ".")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(kinds_path)))
    return pkg_root, os.path.dirname(pkg_root)


def _memo_extra(files) -> str:
    """Stat signature of the disk-resolved artifact files (bench.py and
    tests/test_*.py under the derived repo root) — they sit outside the
    scanned set, so their edits must invalidate the rule memo."""
    _pkg, repo_root = _roots(files)
    sig = []
    for cand in sorted(
        [os.path.join(repo_root, "bench.py")]
        + _glob.glob(os.path.join(repo_root, "tests", "test_*.py"))
    ):
        try:
            st = os.stat(cand)
            sig.append(f"{cand}:{st.st_size}:{st.st_mtime_ns}")
        except OSError:
            continue
    return hashlib.sha256("|".join(sig).encode()).hexdigest()[:16]


def check_r21(files):
    rows, decl_path, decl_line = _extract_families(files)
    if not rows:
        return
    kinds_by_name = {r["kind"]: r for r in rows}
    registered, framings_path = _extract_framings(files)
    pkg_root, repo_root = _roots(files)

    # -- bidirectional registry <-> runtime coverage -----------------
    if registered is not None:
        for kind, line in sorted(registered.items()):
            if kind not in kinds_by_name:
                yield Finding(
                    "R21", decl_path, decl_line, 0,
                    f"framing {kind!r} is registered in the runtime "
                    f"FRAMINGS but has no ENGINE_FAMILIES row — an "
                    f"engine with no parity landing bar",
                )
        for kind in sorted(kinds_by_name):
            if kind not in registered:
                yield Finding(
                    "R21", decl_path, decl_line, 0,
                    f"family {kind!r} declares a landing bar but is "
                    f"not registered in {os.path.basename(framings_path)}"
                    f"'s FRAMINGS — dead coverage",
                )

    # -- per-family artifact existence + family-name attestation -----
    for row in rows:
        kind = row["kind"]
        for slot in ("model", "oracle"):
            rel = row.get(slot, "")
            if not rel:
                yield Finding(
                    "R21", decl_path, decl_line, 0,
                    f"family {kind!r}: no {slot} declared",
                )
                continue
            path = _scanned_suffix(files, rel)
            if path is None and not os.path.isfile(
                os.path.join(pkg_root, rel.replace("/", os.sep))
            ):
                yield Finding(
                    "R21", decl_path, decl_line, 0,
                    f"family {kind!r}: declared {slot} {rel!r} exists "
                    f"neither in the scanned set nor under "
                    f"{os.path.basename(pkg_root)}/",
                )

        spec = row.get("parity_test", "")
        base, _sep, token = spec.partition("::")
        if not base or not token:
            yield Finding(
                "R21", decl_path, decl_line, 0,
                f"family {kind!r}: parity_test must be "
                f"'file::test_name', got {spec!r}",
            )
        else:
            text = _scanned_basename_text(files, base)
            if text is None:
                text = _disk_text(os.path.join(repo_root, "tests", base))
            if text is None:
                yield Finding(
                    "R21", decl_path, decl_line, 0,
                    f"family {kind!r}: parity test file {base!r} not "
                    f"found (scanned set or tests/)",
                )
            elif token not in text:
                yield Finding(
                    "R21", decl_path, decl_line, 0,
                    f"family {kind!r}: {base} does not define the "
                    f"declared every-offset parity test {token!r}",
                )

        bench_cfg = row.get("bench_config", "")
        bench_text = _scanned_basename_text(files, "bench.py")
        if bench_text is None:
            bench_text = _disk_text(os.path.join(repo_root, "bench.py"))
        if not bench_cfg:
            yield Finding(
                "R21", decl_path, decl_line, 0,
                f"family {kind!r}: no bench_config declared",
            )
        elif bench_text is None:
            yield Finding(
                "R21", decl_path, decl_line, 0,
                f"family {kind!r}: bench.py not found to verify "
                f"bench_config {bench_cfg!r}",
            )
        elif (f'"{bench_cfg}"' not in bench_text
                and f"'{bench_cfg}'" not in bench_text):
            yield Finding(
                "R21", decl_path, decl_line, 0,
                f"family {kind!r}: bench.py never names bench config "
                f"{bench_cfg!r} — the family is unbenchmarked",
            )

        slice_tok = row.get("stress_slice", "")
        if not slice_tok:
            yield Finding(
                "R21", decl_path, decl_line, 0,
                f"family {kind!r}: no stress_slice declared",
            )
            continue
        found = False
        for path, sf in sorted(files.items()):
            b = os.path.basename(path)
            if ((b.startswith("test_") or b == "bench.py")
                    and slice_tok in sf.text):
                found = True
                break
        if not found:
            for cand in ([os.path.join(repo_root, "bench.py")]
                         + sorted(_glob.glob(os.path.join(
                             repo_root, "tests", "test_*.py")))):
                text = _disk_text(cand)
                if text is not None and slice_tok in text:
                    found = True
                    break
        if not found:
            yield Finding(
                "R21", decl_path, decl_line, 0,
                f"family {kind!r}: stress-mix slice {slice_tok!r} "
                f"appears in no stress/bench harness — the family "
                f"never rides the mixed-load soak",
            )


check_r21.memo_extra = _memo_extra
