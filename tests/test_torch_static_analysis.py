"""The port's cilium-lint (``cilium_tpu_torch.analysis``) held to the
reference's (``cilium_tpu.analysis``), tolerance 0.

1. **Tree gate** — the port's tree has ZERO unsuppressed findings with
   no baseline entry, and its suppressed count is the ratchet recorded
   in ``tests/lint_baseline_torch.json``.
2. **Corpus parity** — on every case of ``tests/lint_corpus/`` that
   imports no JAX, both analysers return EQUAL findings (rule, file,
   line, column, message, symbol, suppression state); on every case of
   ``tests/lint_corpus_torch/`` (the torch twins of the JAX cases) the
   port returns the reference's rule ids at the reference's lines on
   the original, which are the twin's ``# EXPECT[Rn]`` markers.
3. **Sensitivity** — a ``.item()`` placed on the dispatch path, a lock
   taken in a function a ``torch.cuda.graph`` capture reaches, and a
   drifted per-slot fan-out each make the CLI exit 1.
4. **CLI contract** — defaults, baseline, ratchet, JSON/SARIF, rules.
"""

import json
import os
import re
import shutil

import pytest

import cilium_tpu_torch
from cilium_tpu.analysis import analyze_paths as ref_analyze
from cilium_tpu.analysis import split_findings as ref_split
from cilium_tpu_torch.analysis import (
    RULE_DOCS,
    analyze_paths,
    load_baseline,
    load_baseline_full,
    split_findings,
)
from cilium_tpu_torch.analysis.cli import main as lint_main

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PKG = os.path.dirname(os.path.abspath(cilium_tpu_torch.__file__))
CORPUS = os.path.join(TESTS, "lint_corpus")
TWINS = os.path.join(TESTS, "lint_corpus_torch")
BASELINE = os.path.join(TESTS, "lint_baseline_torch.json")

_EXPECT = re.compile(r"#\s*EXPECT\[(R[0-9]+)\]")


def _py_files(path):
    if os.path.isdir(path):
        return [os.path.join(path, n) for n in sorted(os.listdir(path))
                if n.endswith(".py")]
    return [path]


def _imports_jax(name):
    return any(re.search(r"^\s*(import|from)\s+jax", open(p).read(), re.M)
               for p in _py_files(os.path.join(CORPUS, name)))


AGNOSTIC = sorted(n for n in os.listdir(CORPUS) if not _imports_jax(n))
TWIN_CASES = sorted(os.listdir(TWINS))


@pytest.fixture(scope="module")
def tree_findings():
    return analyze_paths([PKG], baseline=load_baseline(BASELINE))


def _markers(findings):
    active, _ = split_findings(findings)
    return {(os.path.basename(f.path), f.line, f.rule) for f in active}


def _expected(path):
    out = set()
    for p in _py_files(path):
        with open(p, encoding="utf-8") as f:
            for i, line in enumerate(f, start=1):
                for m in _EXPECT.finditer(line):
                    out.add((os.path.basename(p), i, m.group(1)))
    return out


# --- 1. tree gate ---------------------------------------------------------

def test_port_tree_is_clean(tree_findings):
    active, _ = split_findings(tree_findings)
    assert not active, "\n".join(f.render() for f in active)
    assert not any(f.baselined for f in tree_findings)


def test_every_port_pragma_is_justified(tree_findings):
    assert not [f for f in tree_findings if f.rule == "R0"]
    for f in tree_findings:
        if f.suppressed:
            assert f.justification.strip(), f.render()


def test_port_ratchet_matches_tree(tree_findings):
    full = load_baseline_full(BASELINE)
    assert full["accepted"] == []
    _, muted = split_findings(tree_findings)
    assert len(muted) == full["max_suppressed"]


def test_cli_ratchet_passes_against_torch_baseline(tree_findings, capsys):
    # Right after the fixture, with its paths: the parse cache and the
    # rule memo (a few graphs deep) serve this run.
    assert lint_main(["--ratchet", "--baseline", BASELINE, PKG]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_device_probe_fallback_reads_through_to_host(tree_findings):
    """The bare-device fallback of ``VerdictService._device_probe`` read
    its sum with ``.item()``; it reads through ``_to_host`` now: no R9
    there, active or suppressed."""
    hits = [f for f in tree_findings
            if f.rule == "R9" and f.symbol.endswith("_device_probe")]
    assert hits == [], [f.render() for f in hits]


def test_port_rules_see_the_port_constructs(tree_findings):
    """The device rules' roots are the port's: the capture reach runs
    through ``_CudaGraphFn`` / ``_jit_for`` into the models, and R16
    knows both as graph wrappers."""
    from cilium_tpu_torch.analysis.core import SourceFile
    from cilium_tpu_torch.analysis.rules_device import _JIT_WRAPPERS
    from cilium_tpu_torch.analysis.rules_jit import capture_reached

    files = {}
    for p in (os.path.join(PKG, "sidecar", "service.py"),
              os.path.join(PKG, "models", "r2d2.py")):
        files[p] = SourceFile(p, open(p).read())
    reached, inline = capture_reached(files)
    quals = {fi.qual for fi in reached}
    assert {"_call_model", "_call_model_attr", "_gather_model",
            "r2d2_verdicts", "_verdict_pass"} <= quals
    assert inline  # the torch.cuda.graph block of _CudaGraphFn._capture
    assert {"_CudaGraphFn", "_jit_for"} <= _JIT_WRAPPERS


# --- 2. corpus parity -----------------------------------------------------

def test_corpus_splits_into_70_jax_free_cases_and_16_twins():
    assert len(AGNOSTIC) == 70
    assert sorted(set(os.listdir(CORPUS)) - set(AGNOSTIC)) == TWIN_CASES


@pytest.mark.parametrize("name", AGNOSTIC)
def test_agnostic_corpus_findings_equal(name):
    path = os.path.join(CORPUS, name)
    want = [f.to_dict() for f in ref_analyze([path])]
    got = [f.to_dict() for f in analyze_paths([path])]
    assert got == want


@pytest.mark.parametrize("name", TWIN_CASES)
def test_torch_twin_matches_reference_lines(name):
    ref_active, _ = ref_split(ref_analyze([os.path.join(CORPUS, name)]))
    want = {(os.path.basename(f.path), f.line, f.rule) for f in ref_active}
    twin = os.path.join(TWINS, name)
    assert _markers(analyze_paths([twin])) == want
    assert _expected(twin) == want


# --- 3. sensitivity -------------------------------------------------------

def _mutated_service(tmp_path, old, new):
    """A copy of the port's service.py with ``old`` replaced by ``new``,
    and the line ``new`` starts on."""
    src = open(os.path.join(PKG, "sidecar", "service.py")).read()
    assert src.count(old) == 1, old
    dst = tmp_path / "service.py"
    dst.write_text(src.replace(old, new))
    return str(dst), src[:src.index(old)].count("\n") + 1


def test_unmutated_service_lints_clean(tmp_path, capsys):
    path, _ = _mutated_service(tmp_path, "def _call_model(",
                               "def _call_model(")
    assert lint_main(["--no-baseline", path]) == 0
    capsys.readouterr()


def test_item_on_dispatch_path_fails(tmp_path, capsys):
    old = ("        allow, rules = self._readback_chunks(issued, n)\n"
           "        if rt is not None:\n")
    path, line = _mutated_service(
        tmp_path, old, old.replace("\n", "\n        first = allow.sum()"
                                   ".item()\n", 1))
    assert lint_main(["--no-baseline", path]) == 1
    out = capsys.readouterr().out
    assert f"service.py:{line + 1}:" in out and ": R9: " in out, out


def test_lock_in_captured_function_fails(tmp_path, capsys):
    """``_gather_model`` is what the ``torch.cuda.graph`` block of
    ``_CudaGraphFn._capture`` runs for the blob lane (``self.fn``)."""
    old = ("    rows = (gather_rows(blob, offs, lens, width)\n"
           "            if getattr(model, \"reads_rows\", True) else None)\n")
    new = ("    with _CAPTURE_LOCK:\n"
           "        rows = (gather_rows(blob, offs, lens, width)\n"
           "                if getattr(model, \"reads_rows\", True) "
           "else None)\n")
    path, line = _mutated_service(tmp_path, old, new)
    assert lint_main(["--no-baseline", path]) == 1
    out = capsys.readouterr().out
    assert f"service.py:{line}:" in out and ": R4: " in out, out
    assert "takes a lock" in out


def test_drifted_slot_fan_out_fails(tmp_path, capsys):
    root = tmp_path / "cilium_tpu_torch"
    for sub in ("", "parallel", "models"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(PKG, "__init__.py"), root / "__init__.py")
    for rel in ("parallel/__init__.py", "parallel/rulesharding.py",
                "models/__init__.py", "models/base.py", "models/r2d2.py",
                "models/http.py", "models/dns.py", "models/kafka.py"):
        shutil.copy(os.path.join(PKG, rel), root / rel)
    assert lint_main(["--no-baseline", str(tmp_path)]) == 0
    capsys.readouterr()
    rs = root / "parallel" / "rulesharding.py"
    src = rs.read_text()
    for old, new in (
        ("row.append(fn(model.slots[i][j], *blk))",
         "row.append(fn(model.slots[i][j], *blk, None))"),
        ("kafka_hits(self.slots[i][j], b, r, parts=True)",
         "kafka_hits(self.slots[i][j], b, parts=True)"),
    ):
        assert src.count(old) == 1
        src = src.replace(old, new)
    rs.write_text(src)
    assert lint_main(["--no-baseline", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    r10 = [ln for ln in out.splitlines() if ": R10: " in ln]
    assert len(r10) == 2, out
    assert "r2d2_verdicts_attr()" in r10[0] and "kafka_hits()" in r10[1]


# --- 4. CLI contract ------------------------------------------------------

def test_cli_defaults_to_the_port_and_its_baseline(monkeypatch):
    from cilium_tpu_torch.analysis import cli

    seen = {}
    monkeypatch.setattr(cli, "analyze_paths",
                        lambda paths, baseline=None: seen.update(
                            paths=paths, baseline=baseline) or [])
    monkeypatch.chdir(REPO)
    assert cli.main([]) == 0
    assert seen["paths"] == ["cilium_tpu_torch"]
    assert cli._default_baseline(["cilium_tpu_torch"]) == os.path.join(
        REPO, "tests", "lint_baseline_torch.json")


def test_cli_bad_twin_exits_one_json_and_sarif(capsys):
    target = os.path.join(TWINS, "r9_bad_host_transfer.py")
    assert lint_main(["--no-baseline", target]) == 1
    capsys.readouterr()
    assert lint_main(["--json", "--no-baseline", target]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert rep["counts"] == {"R9": 3} and rep["total"] == 3
    assert lint_main(["--sarif", "--no-baseline", target]) == 1
    sarif = json.loads(capsys.readouterr().out)
    assert [r["ruleId"] for r in sarif["runs"][0]["results"]] == ["R9"] * 3
    assert lint_main(["--json", "--sarif", target]) == 2
    capsys.readouterr()


def test_cli_ratchet_update_writes_only_the_given_baseline(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"accepted": [], "max_suppressed": 9}))
    target = os.path.join(CORPUS, "r0_good_pragma.py")
    assert lint_main(["--ratchet", "--ratchet-update", "--baseline",
                      str(bl), target]) == 0
    assert json.loads(bl.read_text())["max_suppressed"] == 1
    capsys.readouterr()


def test_cli_list_rules_names_the_torch_objects(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines() if ln.startswith("R")]) == 24
    assert "jax" not in out.lower()
    for rule, needle in (("R4", "torch.cuda.graph"), ("R9", "_to_host"),
                         ("R10", "slots"), ("R12", "nvcc"),
                         ("R16", "CUDA graph"), ("R23", "CUDA-graph")):
        assert needle in RULE_DOCS[rule], rule


def test_cli_device_contracts_needs_a_card_or_cpu(capsys):
    import torch

    target = os.path.join(TWINS, "r11_good_fused.py")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            lint_main(["--device-contracts", "--no-baseline", target])
    capsys.readouterr()
