"""``cilium-lint`` CLI for the port: ``python -m
cilium_tpu_torch.analysis.cli [paths]`` (default ``cilium_tpu_torch``).

Text mode prints one line per active finding and exits 1 when any
survive suppression; ``--json`` emits the full machine-readable report
(active + suppressed + per-rule counts) for CI consumption.  The
baseline (``--baseline``, default ``tests/lint_baseline_torch.json``
when it exists next to the scanned tree) accepts findings wholesale so
new violations fail the build while grandfathered ones don't.

``--ratchet`` turns the baseline's ``max_suppressed`` into a one-way
gate: the tree's suppressed-finding count (pragmas + baselined) may
only DECREASE.  Growth fails the build — a new pragma must displace an
old one or argue its way into a recorded, reviewed ratchet bump via
``--ratchet-update``; a missing ``max_suppressed`` fails CLOSED, so
the gate cannot be disarmed by deleting the number.

``--device-contracts`` additionally runs the device-contract layer
(``analysis/devicecheck.py``): the real verdict models are captured
into CUDA graphs on the card (``--device cpu``: their op traces are
recorded on the CPU instead) and the R8-R11 contracts plus the R16
shape-closure audit verified on those traces.  Without a card it
raises unless ``--device cpu`` is given.

``--diff <rev>`` reports only findings in files changed since ``rev``
(plus untracked files) — the warm-cache pre-commit mode.  The
ANALYSIS still covers the full scan target: the interprocedural rules
are whole-program (R5's seam symmetry, R7's cross-file metric
references, R14's answer fixpoint), so scanning only the changed
files would both invent findings (half a seam looks broken) and miss
real ones; the content-hash parse/graph cache is what makes the full
pass cheap on a warm tree.  The rev is validated through git and a
failure is rc 2 (fail closed, like a typo'd path); zero CHANGED
Python files is a legitimate no-op (rc 0), unlike a zero-file scan
target, which stays rc 2.

``--sarif`` emits a SARIF 2.1.0 report on stdout for CI annotation
(one result per ACTIVE finding; pragma/baseline suppressions are
recorded as inSource/external suppressions so code-scanning UIs show
them resolved).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .core import (
    RULE_DOCS,
    _collect_py,
    analyze_paths,
    findings_to_json,
    load_baseline_full,
    split_findings,
)


BASELINE_NAME = "lint_baseline_torch.json"


def _default_baseline(paths) -> str | None:
    """tests/lint_baseline_torch.json next to the scanned package, if
    any."""
    for p in paths:
        d = os.path.abspath(p)
        if not os.path.isdir(d):
            d = os.path.dirname(d)
        for root in (d, os.path.dirname(d)):
            cand = os.path.join(root, "tests", BASELINE_NAME)
            if os.path.exists(cand):
                return cand
    return None


def _ratchet(args, baseline_path, baseline_full, muted) -> int | None:
    """Enforce max_suppressed; returns an exit code to stop with, or
    None to continue into normal reporting."""
    count = len(muted)
    if baseline_path is None or baseline_full is None:
        print("cilium-lint: --ratchet needs a baseline file "
              f"(tests/{BASELINE_NAME}) to ratchet against",
              file=sys.stderr)
        return 2
    # Advisory/status lines go to stderr: --ratchet composes with
    # --json, whose stdout must stay pure machine-readable report.
    def write_count(verb, old):
        baseline_full["max_suppressed"] = count
        with open(baseline_path, "w", encoding="utf-8") as f:
            json.dump(baseline_full, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"cilium-lint: ratchet {verb} "
              f"{old if old is not None else '(unset)'} -> {count}",
              file=sys.stderr)

    recorded = baseline_full.get("max_suppressed")
    if recorded is None:
        if args.ratchet_update:  # bootstrap the ratchet
            write_count("recorded", None)
            return None
        # Fail CLOSED: an unrecorded ratchet is indistinguishable from
        # a deleted one.
        print(f"cilium-lint: baseline {baseline_path} has no "
              f"max_suppressed — record the current count "
              f"({count}) with --ratchet --ratchet-update",
              file=sys.stderr)
        return 2
    if count > recorded:
        if args.ratchet_update:
            # The reviewed-bump path: the flag on the command line IS
            # the explicit sign-off, and the diff to the baseline file
            # is what review sees.
            write_count("RAISED", recorded)
            return None
        print(f"cilium-lint: RATCHET VIOLATION — {count} suppressed "
              f"finding(s), baseline allows {recorded}.  The "
              f"suppressed count may only decrease; remove a pragma "
              f"or record a reviewed bump with --ratchet "
              f"--ratchet-update.", file=sys.stderr)
        return 1
    if count < recorded:
        if args.ratchet_update:
            write_count("lowered", recorded)
        else:
            print(f"cilium-lint: suppressed count {count} is below "
                  f"the recorded {recorded} — lock in the progress "
                  f"with --ratchet --ratchet-update", file=sys.stderr)
    return None


def _changed_files(rev: str) -> set[str] | None:
    """Absolute paths changed since ``rev`` plus untracked files, or
    None when git cannot answer (bad rev / not a repo) — the caller
    fails CLOSED on None: a silent empty diff would green-light
    anything."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        diff = subprocess.run(
            ["git", "diff", "--name-only", rev],
            capture_output=True, text=True, timeout=60, check=True,
            cwd=top,
        ).stdout
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True, text=True, timeout=60, check=True,
            cwd=top,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    # realpath on BOTH sides of the membership test: git reports
    # physical paths, and a symlinked scan path (macOS /tmp) abspath'd
    # naively would intersect to nothing — a silent empty diff in an
    # explicitly fail-closed gate.
    return {
        os.path.realpath(os.path.join(top, line.strip()))
        for line in (diff + untracked).splitlines()
        if line.strip()
    }


def _sarif_report(findings) -> dict:
    """SARIF 2.1.0 for CI annotation: active findings as results,
    suppressed ones carried with their suppression kind so the
    code-scanning UI shows them resolved instead of re-opening them."""
    from .core import RULE_DOCS

    results = []
    for f in findings:
        res = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/"),
                    },
                    "region": {
                        "startLine": max(f.line, 1),
                        "startColumn": max(f.col + 1, 1),
                    },
                },
            }],
        }
        if f.suppressed or f.baselined:
            res["suppressions"] = [{
                "kind": "inSource" if f.suppressed else "external",
                "justification": f.justification,
            }]
        results.append(res)
    return {
        "$schema": ("https://json.schemastore.org/sarif-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                # No informationUri: SARIF 2.1.0 requires an absolute
                # URI there and this repo has no canonical public URL
                # — strict consumers reject a relative reference.
                "name": "cilium-lint",
                "rules": [
                    {"id": rule,
                     "shortDescription": {"text": doc}}
                    for rule, doc in sorted(RULE_DOCS.items())
                ],
            }},
            "results": results,
        }],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cilium-lint",
        description="whole-program concurrency & device-contract "
                    "invariant analyzer (rules R0-R23; see README "
                    "'Invariants & lint')",
    )
    p.add_argument("paths", nargs="*", default=["cilium_tpu_torch"],
                   help="files or directories to scan "
                        "(default: cilium_tpu_torch)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit a JSON report (active + suppressed + "
                        "per-rule counts)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="JSON list of {rule,file,symbol} accepted "
                        "findings (default: tests/"
                        f"{BASELINE_NAME} "
                        "next to the scanned tree, when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also print pragma-/baseline-suppressed "
                        "findings (text mode)")
    p.add_argument("--ratchet", action="store_true",
                   help="enforce the baseline's max_suppressed: the "
                        "suppressed-finding count may only decrease "
                        "(fails closed when unrecorded)")
    p.add_argument("--ratchet-update", action="store_true",
                   help="with --ratchet: record the current (lower) "
                        "suppressed count into the baseline file")
    p.add_argument("--device-contracts", action="store_true",
                   help="also verify R8-R11 and the R16 shape-closure "
                        "audit on the real verdict models: CUDA-graph "
                        "captures on the card (raises without one), or "
                        "op traces on the CPU with --device cpu")
    p.add_argument("--device", default=None, metavar="DEVICE",
                   help="device of --device-contracts: the card by "
                        "default, 'cpu' for the CPU op traces")
    p.add_argument("--diff", default=None, metavar="REV",
                   help="report only findings in files changed since "
                        "REV (plus untracked files); the whole-"
                        "program analysis still covers the full scan "
                        "target (warm-cache pre-commit mode) — a bad "
                        "rev fails closed (rc 2), zero changed "
                        "Python files is a no-op (rc 0)")
    p.add_argument("--sarif", action="store_true",
                   help="emit a SARIF 2.1.0 report on stdout for CI "
                        "annotation (mutually exclusive with --json)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule set and exit")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule, doc in sorted(RULE_DOCS.items()):
            print(f"{rule}  {doc}")
        return 0

    if args.as_json and args.sarif:
        print("cilium-lint: --json and --sarif are mutually "
              "exclusive", file=sys.stderr)
        return 2

    # The gate must fail CLOSED on a misconfigured invocation: a
    # typo'd path (or a CI job run from the wrong cwd) scanning zero
    # files would otherwise print '0 finding(s)' and go green forever.
    missing = [pth for pth in args.paths if not os.path.exists(pth)]
    if missing:
        for pth in missing:
            print(f"cilium-lint: no such path: {pth}", file=sys.stderr)
        return 2
    if not _collect_py(args.paths):
        print("cilium-lint: no Python files found under "
              + " ".join(args.paths), file=sys.stderr)
        return 2
    diff_filter: set[str] | None = None
    if args.diff is not None:
        changed = _changed_files(args.diff)
        if changed is None:
            # A bad rev (or no git) must not masquerade as a clean
            # scan — same fail-closed stance as a typo'd path.
            print(f"cilium-lint: --diff {args.diff}: git could not "
                  f"resolve the diff; fix the rev or drop --diff",
                  file=sys.stderr)
            return 2
        diff_filter = {
            os.path.realpath(f) for f in _collect_py(args.paths)
            if os.path.realpath(f) in changed
        }
        if not diff_filter:
            # The rev resolved and nothing under the scan paths
            # changed: a legitimate no-op (the pre-commit fast path),
            # NOT the misconfigured-scan case above.
            print(f"cilium-lint: no Python files under "
                  f"{' '.join(args.paths)} changed since "
                  f"{args.diff}; nothing to scan", file=sys.stderr)
            return 0

    baseline = None
    baseline_path = None
    baseline_full = None
    if not args.no_baseline:
        baseline_path = args.baseline or _default_baseline(args.paths)
        if baseline_path is not None:
            try:
                baseline_full = load_baseline_full(baseline_path)
                baseline = baseline_full["accepted"]
            except (OSError, ValueError) as e:
                print(f"cilium-lint: bad baseline {baseline_path}: {e}",
                      file=sys.stderr)
                return 2

    # The analysis ALWAYS sees the full scan target — the
    # interprocedural rules need both halves of every seam; --diff
    # only narrows the REPORT (the warm content-hash cache is what
    # makes the full pass cheap pre-commit).
    findings = analyze_paths(args.paths, baseline=baseline)
    if args.device_contracts:
        from . import devicecheck
        from .core import _baseline_matches

        extra = devicecheck.check_device_contracts(device=args.device)
        # Device-contract findings have no source line, so a pragma
        # can never reach them — the baseline's accepted list is their
        # ONE escape hatch (a torch upgrade shifting an op count must
        # be acceptable without editing the tool).
        if baseline:
            for f in extra:
                if any(_baseline_matches(e, f) for e in baseline):
                    f.baselined = True
        findings.extend(extra)

    if args.ratchet:
        # The ratchet counts the FULL (pre-filter) view: it gates the
        # tree-wide suppression total, and letting a --diff run record
        # a changed-files-only count would corrupt the baseline for
        # every full run after it.
        _, full_muted = split_findings(findings)
        rc = _ratchet(args, baseline_path, baseline_full, full_muted)
        if rc is not None:
            return rc

    # The report filter runs LAST — after the device-contract extend —
    # so diff mode never reports (or fails on) a finding in a file the
    # rev did not touch.
    if diff_filter is not None:
        findings = [
            f for f in findings
            if os.path.realpath(f.path) in diff_filter
        ]
    active, muted = split_findings(findings)

    if args.as_json:
        print(json.dumps(findings_to_json(findings), indent=2))
        return 1 if active else 0

    if args.sarif:
        print(json.dumps(_sarif_report(findings), indent=2))
        return 1 if active else 0

    for f in active:
        print(f.render())
    if args.show_suppressed:
        for f in muted:
            tag = "baseline" if f.baselined else "pragma"
            why = f" ({f.justification})" if f.justification else ""
            print(f"suppressed[{tag}]: {f.render()}{why}")
    n_files = len({f.path for f in findings}) if findings else 0
    print(
        f"cilium-lint: {len(active)} finding(s), "
        f"{len(muted)} suppressed"
        + (f" across {n_files} file(s)" if findings else "")
    )
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
