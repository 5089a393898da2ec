"""The port's device contracts (``cilium_tpu_torch.analysis.devicecheck``)
on the CPU, held to the reference's (``cilium_tpu.analysis.devicecheck``),
tolerance 0.

The port records op traces (the kernel-wrapper calls and the aten ops of
the glue between them) where the reference traced jaxprs.  Nine of the
reference's own tests in ``tests/test_device_contracts.py`` fail under
jax 0.9, which removed ``jax.core.ClosedJaxpr`` (read by its
``_sub_jaxprs``), and its DNS sharded step does not trace there (a
``TypeError`` on the scan carry).  Their twins here hold the port to the
contract each reference test states; each says so.

1. **Contract gate** — the real verdict models, the sharded steps on
   every mesh, the reshape ladder and the shape closure hold: zero
   findings.
2. **Checker sensitivity** — broken models are CAUGHT: an output dtype
   leak, a host readback, a Python branch on a tensor, a second device
   pass, an unbalanced shard stack, an unbucketed shape or model.
3. **Parity with the reference** — the shape universe, the audit's
   findings on synthetic sets, and the traced shape set of every family
   the reference traces.
4. **CLI surface** — ``--device-contracts`` with ``--device cpu``.
"""

import os

import pytest
import torch

from cilium_tpu_torch.analysis import devicecheck as dc
from cilium_tpu_torch.models.r2d2 import build_r2d2_model_from_rows

CPU = torch.device("cpu")
TWINS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "lint_corpus_torch")
R2D2_ROWS = [
    (frozenset(), "OPEN", "/etc/.*"),
    (frozenset({3}), "", "docs/[a-z]+"),
]


@pytest.fixture(scope="module")
def contracts():
    """Every device-contract check on the CPU, once: findings by part,
    the traces of the models and sharded steps, the traced shape set."""
    captures, traced = [], []
    out = {"models": []}
    for name, path, model in dc._model_cases(CPU):
        out["models"].extend(dc._check_model(name, path, model, CPU,
                                             captures))
    out["sharded"] = dc._check_sharded(CPU, captures)
    out["ladder"] = dc.check_reshape_ladder(device=CPU)
    out["closure"] = dc.check_shape_closure(CPU, traced)
    out["captures"] = {tag: c for tag, _fn, c in captures}
    out["traced"] = traced
    return out


# --- 1. contract gate -----------------------------------------------------

def test_device_contracts_clean(contracts):
    for part in ("models", "sharded", "ladder", "closure"):
        assert contracts[part] == [], "\n".join(
            f.render() for f in contracts[part])


def test_check_device_contracts_runs_every_part(monkeypatch):
    calls = []
    for name in ("_check_model", "_check_sharded", "check_reshape_ladder",
                 "check_shape_closure"):
        monkeypatch.setattr(dc, name, lambda *a, _n=name, **k: calls.append(
            (_n, a, k)) or [])
    assert dc.check_device_contracts(device="cpu") == []
    assert [c[0] for c in calls] == ["_check_model"] * 4 + [
        "_check_sharded", "check_reshape_ladder", "check_shape_closure"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dc.check_device_contracts()  # the card is the default


def test_attr_trace_is_plain_plus_bounded_epilogue(contracts):
    """Twin of the reference's test of the same name (which fails under
    jax 0.9: ``ClosedJaxpr``).  Its contract: the real fused models sit
    WELL inside the budget, so version drift cannot flap the gate."""
    caps = contracts["captures"]
    for fam in ("r2d2", "http", "dns", "seam_probe"):
        plain = caps[f"{fam}.plain"].trace
        attr = caps[f"{fam}.attr"].trace
        assert len(attr.ops) <= len(plain.ops) + dc.ATTR_EXTRA_OPS
        assert len(attr.ops) < 1.5 * len(plain.ops)
        assert attr.kernel_counts() == plain.kernel_counts()


def test_model_traces_reach_their_kernels(contracts):
    caps = contracts["captures"]
    assert caps["r2d2.plain"].trace.kernel_counts() == {
        "r2d2_frame": 1, "dfa_scan": 1, "r2d2_hits": 1}
    assert caps["dns.plain"].trace.kernel_counts() == {
        "dns_name": 1, "dfa_scan": 1, "dns_hits": 1}
    assert {"http_frame", "http_lit", "http_hits"} <= set(
        caps["http.plain"].trace.kernel_counts())
    assert caps["seam_probe.plain"].trace.kernel_counts() == {
        "seam_probe": 1}


# --- 2. checker sensitivity -----------------------------------------------

class _DtypeLeakModel:
    def __call__(self, data, lengths, remotes):
        ok = lengths >= 0
        return ok, lengths * 1.5, ok  # msg_len follows a float scalar


class _HostReadModel:
    def __call__(self, data, lengths, remotes):
        ok = lengths >= 0
        echoed = torch.from_numpy(lengths.cpu().numpy())
        return ok, echoed, ok


class _BranchModel:
    def __call__(self, data, lengths, remotes):
        if lengths[0] > 0:  # Python branch on a tensor
            return lengths >= 0, lengths, lengths >= 0
        return lengths >= 0, lengths, lengths >= 0


def _two_pass_model():
    from cilium_tpu_torch.models import r2d2 as r2d2_mod

    base = build_r2d2_model_from_rows(R2D2_ROWS, device="cpu")

    class _TwoPass:
        def __call__(self, d, l, r):
            c, m, a, _ = r2d2_mod._verdict_pass(base, d, l, r)
            return c, m, a

        def verdicts_attr(self, d, l, r):
            c, m, allow = self(d, l, r)  # pass 1
            *_, rule = r2d2_mod._verdict_pass(base, d, l, r)  # pass 2 (bug)
            return c, m, allow, rule

    return _TwoPass()


@pytest.mark.parametrize("model,rule,needle", [
    (_DtypeLeakModel(), "R8", "dtypes"),
    (_HostReadModel(), "R9", "reads the tensor to the host"),
    (_BranchModel(), "R8", "reads a scalar to the host"),
], ids=["dtype-leak", "host-readback", "python-branch"])
def test_checker_catches_broken_models(model, rule, needle):
    """Twins of the reference's (weak-type-leak and host-callback fail
    there under jax 0.9): an output whose dtype follows a Python scalar,
    a host readback, a Python branch on traced data."""
    findings = dc._check_model("broken", "x.py", model)
    assert any(f.rule == rule and needle in f.message
               for f in findings), [f.render() for f in findings]


def test_checker_catches_second_device_pass():
    """Twin of the reference's test (fails there under jax 0.9): the
    pinned PR 5 bug shape — attribution recomputes the hit matrix,
    results bit-identical, device cost doubled."""
    findings = dc._check_model("twopass", "x.py", _two_pass_model())
    assert any(f.rule == "R11" and "SECOND device pass" in f.message
               for f in findings), [f.render() for f in findings]


def test_sharded_steps_run_on_every_mesh(contracts):
    """Twin of ``test_sharded_step_traces_on_cpu_mesh`` (fails there
    under jax 0.9): every sharded step runs on 1x1, 1x2, 2x1, 2x2, 4x1
    and 4x2 meshes — no mesh skipped — balanced across slots."""
    assert contracts["sharded"] == []
    caps = contracts["captures"]
    for step in ("sharded_verdict_step", "sharded_verdict_step_attr",
                 "sharded_dns_step", "sharded_dns_step_attr",
                 "sharded_kafka_step"):
        for n_flow, n_rule in dc._SHARD_MESHES:
            tr = caps[f"{step}@{n_flow}x{n_rule}"].trace
            merge = ("kafka_shard_combine" if "kafka" in step
                     else "shard_reduce")
            assert tr.kernel_counts()[merge] == n_flow


def test_checker_catches_unbalanced_shard_stack():
    """A 1-shard stack offered to a 2-wide RULE_AXIS, and a stack whose
    shards' tables differ in shape, are caught by check_stacked_model;
    the 1-shard stack cannot even be placed; the padded stack is clean
    and steps."""
    from cilium_tpu_torch.parallel import rulesharding
    from cilium_tpu_torch.parallel.mesh import flow_mesh, virtual_devices

    model = build_r2d2_model_from_rows([(frozenset(), "OPEN", "/x/.*")],
                                       device="cpu")
    mesh = flow_mesh(n_flow=1, n_rule=2, devices=virtual_devices(2, "cpu"))
    assert dc.check_stacked_model([model], mesh)
    with pytest.raises(ValueError):
        rulesharding.ShardedVerdictModel(
            [model], rulesharding.shard_offsets(2, 2), mesh, "r2d2")
    other = build_r2d2_model_from_rows(
        [(frozenset(), "OPEN", "/x/.*"), (frozenset(), "", "a+b+c+d")],
        device="cpu")
    assert any("unpadded" in p
               for p in dc.check_stacked_model([model, other], mesh))
    good = rulesharding.build_sharded_r2d2_from_rows(
        R2D2_ROWS, 2, bucket=True, device="cpu")
    assert dc.check_stacked_model(good, mesh) == []
    step = rulesharding.ShardedVerdictModel(
        good, rulesharding.shard_offsets(2, 2), mesh, "r2d2")
    assert len(step(*dc.batch(CPU))) == 3


def test_sharded_attr_step_contract(contracts):
    """Twin of the reference's test (fails there under jax 0.9): the
    attributed mesh step is arity 4 with an int32 GLOBAL rule row, and
    its body reads nothing back to the host."""
    c = contracts["captures"]["sharded_verdict_step_attr@2x2"]
    outs = dc._outputs(c.outs)
    assert len(outs) == 4 and outs[3].dtype == torch.int32
    assert c.trace.hazards == []


def test_reshape_ladder_audit_clean_and_sensitive(contracts):
    """Twin of the reference's test (fails there under jax 0.9): the
    audit is clean on the real assembly seam and FIRES on a stale
    1-shard stack served on a 2-wide rung."""
    from cilium_tpu_torch.parallel import rulesharding
    from cilium_tpu_torch.parallel.mesh import flow_mesh

    assert contracts["ladder"] == []

    def broken(family, rows, mesh):
        one = flow_mesh(n_flow=1, n_rule=1,
                        devices=list(mesh.devices.flat)[:1])
        model = rulesharding.mesh_model_from_family_rows(family, rows, one)
        model.mesh = mesh
        return model

    found = dc.check_reshape_ladder(build=broken, device=CPU)
    assert found and any("shard" in f.message.lower() for f in found)


def test_closure_catches_unbucketed_traced_shape():
    u = dc.enumerate_shape_universe()
    got = dc.audit_traced_shapes(
        [("bad-flows", "x.py", 19, 256), ("bad-width", "x.py", 32, 300),
         ("good", "x.py", 32, 256)], u,
    )
    assert len(got) == 2 and all(f.rule == "R16" for f in got)
    assert any("batch axis 19" in f.message for f in got)
    assert any("row width 300" in f.message for f in got)


def test_closure_catches_deliberately_unbucketed_model():
    from cilium_tpu_torch.models.dns import build_dns_model_from_rows
    from cilium_tpu_torch.proxylib.parsers.dns import DnsRule

    def rows(n):
        return [(frozenset({i}), DnsRule(name="w.example.com"))
                for i in range(n)]

    bad = dc.audit_rule_axis(
        "dns-unbucketed", "x.py",
        lambda n: build_dns_model_from_rows(rows(n), bucket=False,
                                            device="cpu"),
    )
    assert len(bad) == 1 and bad[0].rule == "R16"
    assert "UNBUCKETED" in bad[0].message
    good = dc.audit_rule_axis(
        "dns-bucketed", "x.py",
        lambda n: build_dns_model_from_rows(rows(n), bucket=True,
                                            device="cpu"),
    )
    assert good == []


def test_closure_model_without_shape_key_is_flagged():
    class _Opaque:
        pass

    got = dc.audit_rule_axis("opaque", "x.py", lambda n: _Opaque())
    assert len(got) == 1 and "dispatch_bare" in got[0].message


# --- 3. parity with the reference -----------------------------------------

def test_shape_universe_equals_reference():
    from cilium_tpu.analysis import devicecheck as ref

    assert dc.enumerate_shape_universe() == ref.enumerate_shape_universe()


@pytest.mark.parametrize("traced", [
    [("bad-flows", "cilium_tpu/x.py", 19, 256),
     ("bad-width", "cilium_tpu/x.py", 32, 300),
     ("good", "cilium_tpu/x.py", 32, 256)],
    [("none", "cilium_tpu/y.py", None, None),
     ("kafka", "cilium_tpu/y.py", 32, None),
     ("big", "cilium_tpu/y.py", 1 << 23, 1 << 23)],
    [("p", "cilium_tpu/z.py", 64, 2048), ("q", "cilium_tpu/z.py", 16, 128)],
], ids=["mixed", "open-axes", "below-floor"])
def test_audit_findings_equal_reference(traced):
    from cilium_tpu.analysis import devicecheck as ref

    def port_path(p):
        return p.replace("cilium_tpu/", "cilium_tpu_torch/", 1)

    u = ref.enumerate_shape_universe()
    want = []
    for f in ref.audit_traced_shapes(traced, u):
        d = f.to_dict()
        d["file"] = port_path(d["file"])
        want.append(d)
    got = dc.audit_traced_shapes(
        [(t, port_path(p), n, w) for t, p, n, w in traced], u)
    assert [f.to_dict() for f in got] == want


def test_traced_shape_set_equals_reference(contracts, monkeypatch):
    """The shapes that reach the port's dispatch seam are the shapes
    the reference traces, family by family.  The reference's DNS
    sharded step does not trace under jax 0.9 (a TypeError on the scan
    carry, which its ``test_shape_closure_gate_is_clean`` shows); for
    those tags the port is held to that test's contract instead: it
    runs them and they lie in the universe (no closure finding)."""
    from cilium_tpu.analysis import devicecheck as ref

    seen = []
    audit = ref.audit_traced_shapes

    def spy(traced, universe):
        traced = list(traced)
        seen.extend(traced)
        return audit(traced, universe)

    monkeypatch.setattr(ref, "audit_traced_shapes", spy)
    ref_findings = ref.check_shape_closure()
    failed = {f.symbol for f in ref_findings if "trace failed" in f.message}
    assert failed <= {f"dns.{k}@{m}" for k in ("sharded", "sharded_attr")
                      for m in ("1x2", "2x1", "2x2")}
    want = {(t, n, w) for t, _p, n, w in seen}
    got = {(t, n, w) for t, _p, n, w in contracts["traced"]}
    assert {x for x in got if x[0] not in failed} == want
    assert {x[0] for x in got if x[0] in failed} == failed
    assert contracts["closure"] == []
    paths = {p for _t, p, _n, _w in contracts["traced"]}
    assert {p.replace("cilium_tpu_torch/", "cilium_tpu/", 1)
            for p in paths} == {p for _t, p, _n, _w in seen}


def test_traced_set_came_through_the_service_seam(contracts):
    tags = {t for t, *_ in contracts["traced"]}
    for fam in ("r2d2", "dns", "http"):
        for role in ("plain", "attr"):
            assert {f"{fam}.{role}@{b}x{w}" for b in (32, 64)
                    for w in (256, 512)} <= tags
    assert {f"kafka.sharded@{m}" for m in ("1x2", "2x1", "2x2")} <= tags


# --- 4. CLI surface -------------------------------------------------------

def test_cli_device_contracts_flag(capsys, monkeypatch):
    """Twin of the reference's test (fails there under jax 0.9): the
    flag runs the device layer — here on the CPU, as asked — and a clean
    layer leaves the exit code 0."""
    from cilium_tpu_torch.analysis.cli import main as lint_main

    asked = []
    monkeypatch.setattr(dc, "check_device_contracts",
                        lambda device=None: asked.append(device) or [])
    target = os.path.join(TWINS, "r11_good_fused.py")
    assert lint_main(["--device-contracts", "--device", "cpu",
                      "--no-baseline", target]) == 0
    assert asked == ["cpu"]
    capsys.readouterr()


def test_device_contract_findings_are_baselinable(
    tmp_path, capsys, monkeypatch
):
    import json

    from cilium_tpu_torch.analysis.cli import main as lint_main
    from cilium_tpu_torch.analysis.core import Finding

    fake = Finding("R11", "cilium_tpu_torch/models/r2d2.py", 0, 0,
                   "[device-contract:r2d2] pretend drift", symbol="r2d2")
    monkeypatch.setattr(dc, "check_device_contracts",
                        lambda device=None: [fake])
    target = os.path.join(TWINS, "r11_good_fused.py")
    assert lint_main(["--device-contracts", "--device", "cpu",
                      "--no-baseline", target]) == 1
    capsys.readouterr()
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps(
        {"accepted": [{"rule": "R11", "file": "models/r2d2.py"}],
         "max_suppressed": 5}))
    fake.baselined = False
    assert lint_main(["--device-contracts", "--device", "cpu",
                      "--baseline", str(baseline), target]) == 0
    capsys.readouterr()


def test_recorder_restores_what_it_patched():
    from cilium_tpu_torch.models import r2d2 as r2d2_mod

    before = (r2d2_mod.r2d2_hits, torch.Tensor.item, torch.Tensor.cpu)
    tr = dc.Trace()
    with dc.recording(tr):
        assert r2d2_mod.r2d2_hits is not before[0]
        torch.zeros(2).sum()
    assert (r2d2_mod.r2d2_hits, torch.Tensor.item,
            torch.Tensor.cpu) == before
    assert tr.ops and {op[0] for op in tr.ops} == {"aten"}
    assert tr.hazards == []
