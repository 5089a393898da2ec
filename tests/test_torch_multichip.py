"""The port's multi-card sharded verdict serving on a mesh of CPU slots
against the JAX package.

Twins of the tier-1 tests of tests/test_multichip_serving.py.  The port's
``VerdictService`` at ``verdict_device="cpu"``, ``mesh="on"`` and
``mesh_rule_shards=2`` resolves its mesh over 8 virtual CPU slots (the
counterpart of the reference tests' 8 virtual CPU devices: the tests put
them in through ``parallel.mesh.local_devices``) and must:

- answer byte-identically to the reference's mesh service, to its own
  single-card control and to the policy truth, with the reference's status
  surface, flow records carrying the host walk's global rule ids, and the
  columnar reassembly lane dispatching the sharded step;
- walk the width ladder as the reference does: a fault on a sharded
  dispatch demotes typed and is answered from the single-card fallback in
  the same round; an attributed slot (the exception's ``failed_devices``,
  or ``cuda:N`` in its text) reshapes onto the survivors; the paced
  re-probe re-promotes after heal; every verdict stays bit-identical with
  zero errors and zero shed;
- keep ``mesh_extents`` / ``reshape_mesh`` and the 64-wide degenerate
  splits as the reference's.

A sharded dispatch fails here by a one-shot fault planted on the sharded
model's calls (the CPU service dispatches eagerly, where the reference
tests patch ``_jit_for``).  Tolerance 0: ops, bytes and rule ids.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import cilium_tpu.proxylib as ref_pl
import cilium_tpu_torch.proxylib as port_pl
from cilium_tpu.proxylib import instance as ref_inst
from cilium_tpu.sidecar import SidecarClient as RefSidecarClient
from cilium_tpu.sidecar import VerdictService as RefVerdictService
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig
from cilium_tpu_torch.parallel import mesh as mesh_mod
from cilium_tpu_torch.parallel.mesh import FLOW_AXIS, RULE_AXIS, virtual_devices
from cilium_tpu_torch.parallel.rulesharding import ShardedKafkaModel, ShardedVerdictModel
from cilium_tpu_torch.proxylib import instance as inst
from cilium_tpu_torch.proxylib.types import DROP, PASS, FilterResult
from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
from cilium_tpu_torch.utils.option import DaemonConfig

POLICY_RULES = [
    {"cmd": "READ", "file": "/public/.*"},
    {"cmd": "HALT"},
    {"cmd": "WRITE", "file": "^/tmp/"},
    {"file": "\\.txt$"},
]

# (frame, remote) -> allowed under the policy above.
TRAFFIC = [
    (b"READ /public/a.txt\r\n", 1, True),
    (b"READ /secret\r\n", 1, False),
    (b"HALT\r\n", 3, True),
    (b"HALT\r\n", 9, False),     # remote 9 not in [1, 3]
    (b"WRITE /tmp/x\r\n", 9, True),
    (b"WRITE /etc/x\r\n", 1, False),
    (b"READ notes.txt\r\n", 5, True),
]


@pytest.fixture(autouse=True, scope="module")
def _reference_leak_guard():
    """Reference tests leave a dummy HTTP rule parser registered and a
    FlightRecorder installed (ROADMAP Queue 3): put the real parser back
    and uninstall every recorder, before and after this module."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.http import http_rule_parser
    from cilium_tpu.sidecar import blackbox as ref_bb
    from cilium_tpu_torch.sidecar import blackbox as port_bb

    def clean():
        register_l7_rule_parser("http", http_rule_parser)
        for bb in (ref_bb, port_bb):
            for rec in list(bb._RECORDERS):
                rec.uninstall()

    clean()
    yield
    clean()


@pytest.fixture(autouse=True)
def eight_slots(monkeypatch):
    """8 virtual CPU slots for every mesh the port resolves."""
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda device=None: virtual_devices(8, "cpu"))


def _policy(pl, name="mesh-pol"):
    return pl.NetworkPolicy(
        name=name,
        policy=2,
        ingress_per_port_policies=[
            pl.PortNetworkPolicy(
                port=80,
                rules=[
                    pl.PortNetworkPolicyRule(
                        remote_policies=[1, 3], l7_proto="r2d2",
                        l7_rules=POLICY_RULES[:2],
                    ),
                    pl.PortNetworkPolicyRule(l7_proto="r2d2", l7_rules=POLICY_RULES[2:]),
                ],
            )
        ],
    )


def _cfg(cls=DaemonConfig, **kw):
    defaults = dict(
        batch_flows=64, dispatch_mode="jit", mesh="on", mesh_rule_shards=2,
        device_reprobe_interval_s=1e9,
    )
    if cls is DaemonConfig:
        defaults["verdict_device"] = "cpu"
    defaults.update(kw)
    return cls(**defaults)


def _start(tmp_path, name, ref=False, **cfg_kw):
    svc_cls, cli_cls, pl = (
        (RefVerdictService, RefSidecarClient, ref_pl) if ref
        else (VerdictService, SidecarClient, port_pl)
    )
    cfg = _cfg(RefDaemonConfig if ref else DaemonConfig, **cfg_kw)
    svc = svc_cls(str(tmp_path / f"{name}.sock"), cfg).start()
    client = cli_cls(svc.socket_path, timeout=120.0)
    mod = client.open_module([])
    assert mod != 0
    assert client.policy_update(mod, [_policy(pl)]) == int(FilterResult.OK)
    return svc, client, mod


def _conn(client, mod, conn_id, remote):
    res, shim = client.new_connection(
        mod, "r2d2", conn_id, True, remote, 2,
        f"1.1.1.{conn_id % 250}:{1000 + conn_id}", "2.2.2.2:80", "mesh-pol",
    )
    assert res == int(FilterResult.OK)
    return shim


def _drive(client, mod, base_cid=1):
    outs = []
    for i, (frame, remote, _want) in enumerate(TRAFFIC):
        shim = _conn(client, mod, base_cid + i, remote)
        res, out = shim.on_io(False, frame)
        assert res == int(FilterResult.OK)
        outs.append(out)
        shim.close()
    return outs


def _stop(client, svc):
    if client is not None:
        client.close()
    if svc is not None:
        svc.stop()


class _Fault(RuntimeError):
    pass


def _arm_loss(monkeypatch, dev_id=None, text="device lost", one_shot=True):
    """A fault on the next sharded dispatch (every one unless
    ``one_shot``), naming slot ``dev_id`` through ``failed_devices``."""
    armed = {"on": True}
    for name in ("__call__", "verdicts_attr"):
        orig = getattr(ShardedVerdictModel, name)

        def boom(self, *a, _orig=orig, **k):
            if armed["on"]:
                if one_shot:
                    armed["on"] = False
                exc = _Fault(text)
                if dev_id is not None:
                    exc.failed_devices = [dev_id]
                raise exc
            return _orig(self, *a, **k)

        monkeypatch.setattr(ShardedVerdictModel, name, boom)
    return armed


def _await_rung(svc, rung, client=None, mod=None, timeout=60.0, drive=False):
    deadline = time.monotonic() + timeout
    i = 0
    while time.monotonic() < deadline:
        st = svc.status()["mesh"]
        if st["rung"] == rung:
            return st
        if drive:
            s = _conn(client, mod, 9000 + (i % 50), 3)
            res, out = s.on_io(False, b"HALT\r\n")
            assert res == int(FilterResult.OK) and out == b"HALT\r\n"
            s.close()
            i += 1
        time.sleep(0.05)
    raise AssertionError(f"rung {rung!r} never reached: {svc.status()['mesh']}")


def _clean_containment(st):
    c = st["containment"]
    assert c["shed_entries"] == 0 and c["batch_crashes"] == 0
    assert c["error_entries"] == 0 and c["refused_entries"] == {}


def test_mesh_service_serves_sharded_bit_identical(tmp_path):
    """Greedy mesh service: the engine's model IS the sharded model, the
    status surface is the reference's, and every verdict matches the
    reference's mesh service, a single-card control and the truth."""
    got = {}
    for label, ref, mesh in (("port", False, "on"), ("ref", True, "on"), ("ctrl", False, "off")):
        (ref_inst if ref else inst).reset_module_registry()
        svc = client = None
        try:
            svc, client, mod = _start(tmp_path, label, ref=ref, batch_timeout_ms=0.0, mesh=mesh)
            got[label] = (_drive(client, mod), svc.status()["mesh"])
            if label == "port":
                eng = next(iter(svc._engines.values()))
                assert isinstance(eng.model, ShardedVerdictModel)
                assert eng.model.n_shards == 2
        finally:
            _stop(client, svc)
            (ref_inst if ref else inst).reset_module_registry()
    assert got["port"][1] == got["ref"][1] == {
        "devices": 8, "flow_shards": 4, "rule_shards": 2,
        "active": True, "demoted": None, "demotions": {},
        "repromotions": 0, "rebind_rebuilds": 0,
        "rung": "full", "serving_devices": 8, "lost_devices": [],
        "reshapes": 0, "reshape_failures": {},
        "capacity_frac": 1.0, "reshape_window_ms": 0.0,
    }
    assert got["ctrl"][1] is None
    assert got["port"][0] == got["ref"][0] == got["ctrl"][0]
    for out, (frame, _r, want) in zip(got["port"][0], TRAFFIC):
        assert (out == frame) == want, (frame, out)


def test_mesh_columnar_lane_parity(tmp_path):
    """Pipelined mesh service: split frames ride the columnar reassembly
    lane, whose bucket issue dispatches the sharded step."""
    inst.reset_module_registry()
    svc = client = None
    try:
        svc, client, mod = _start(tmp_path, "mesh-col", batch_timeout_ms=2.0,
                                  batch_width=64, reasm_min_entries=1)
        for cid in (1, 2, 3, 4):
            _conn(client, mod, cid, 1)
        got: dict = {}
        evt = threading.Event()

        def cb(vb):
            got[vb.seq] = [vb.entry(i) for i in range(vb.count)]
            evt.set()

        client.verdict_callback = cb

        def send(seq, entries):
            cids = np.array([e[0] for e in entries], np.uint64)
            fl = np.array([e[1] for e in entries], np.uint8)
            lens = np.array([len(e[2]) for e in entries], np.uint32)
            client.send_batch(seq, cids, fl, lens, b"".join(e[2] for e in entries))

        def wait_for(seq):
            deadline = time.monotonic() + 90
            while seq not in got and time.monotonic() < deadline:
                evt.wait(0.5)
                evt.clear()
            assert seq in got, sorted(got)

        send(1, [(1, 0, b"READ /pub"), (2, 0, b"READ /sec"), (3, 0, b"HALT"), (4, 0, b"WRITE /tm")])
        wait_for(1)
        send(2, [(1, 0, b"lic/a.txt\r\n"), (2, 0, b"ret\r\n"), (3, 0, b"\r\n"), (4, 0, b"p/x\r\n")])
        wait_for(2)
        by_cid = {e[0]: e for e in got[2]}
        assert [by_cid[c][2][0][0] for c in (1, 2, 3, 4)] == [
            int(PASS), int(DROP), int(PASS), int(PASS)]
        st = svc.status()
        assert st["reasm"] is not None and st["reasm"]["rounds"] > 0, st["reasm"]
        assert st["mesh"]["active"]
        assert isinstance(next(iter(svc._engines.values())).model, ShardedVerdictModel)
    finally:
        _stop(client, svc)
        inst.reset_module_registry()


def test_mesh_flowlog_attribution_matches_host_walk(tmp_path):
    """Flow records from the mesh path carry GLOBAL rule ids and kinds:
    the host oracle walk's first match over the same frame."""
    from cilium_tpu_torch.proxylib.parsers.r2d2 import R2d2RequestData

    inst.reset_module_registry()
    svc = client = None
    try:
        svc, client, mod = _start(tmp_path, "mesh-attr", batch_timeout_ms=0.0)
        _drive(client, mod)
        pi = inst.find_instance(mod).policy_map()["mesh-pol"]
        kinds = next(iter(svc._engines.values())).model.match_kinds
        want_allowed = sum(1 for _f, _r, w in TRAFFIC if w)
        deadline = time.monotonic() + 10
        recs = []
        while time.monotonic() < deadline:
            recs = [r for r in svc.flowlog.query(n=10000) if r.get("rule_id", -1) >= 0]
            if len(recs) >= want_allowed:
                break
            time.sleep(0.05)
        assert len(recs) >= want_allowed, recs
        frames = {i + 1: (f, r) for i, (f, r, _w) in enumerate(TRAFFIC)}
        for rec in recs:
            frame, remote = frames[rec["conn_id"]]
            parts = frame[:-2].decode().split(" ")
            hok, hrule = pi.matches_at(
                True, 80, remote, R2d2RequestData(parts[0], parts[1] if len(parts) > 1 else ""))
            assert hok and rec["rule_id"] == hrule, (frame, rec, hrule)
            assert rec["match_kind"] == kinds[hrule], (frame, rec)
    finally:
        _stop(client, svc)
        inst.reset_module_registry()


def _http_policy():
    return port_pl.NetworkPolicy(
        name="http-mesh", policy=2,
        ingress_per_port_policies=[
            port_pl.PortNetworkPolicy(port=80, rules=[
                port_pl.PortNetworkPolicyRule(http_rules=[
                    {"method": "GET", "path": "/public/.*"},
                    {"method": "POST", "path": "/api/.*"},
                ])
            ])
        ],
    )


def _http_service(tmp_path, name, **kw):
    svc = VerdictService(str(tmp_path / f"{name}.sock"),
                         _cfg(batch_timeout_ms=0.0, **kw)).start()
    client = SidecarClient(svc.socket_path, timeout=120.0)
    mod = client.open_module([])
    assert client.policy_update(mod, [_http_policy()]) == int(FilterResult.OK)

    def req(cid, frame):
        res, shim = client.new_connection(
            mod, "http", cid, True, 1, 2, f"1.1.1.{cid}:{1000 + cid}", "2.2.2.2:80", "http-mesh",
        )
        assert res == int(FilterResult.OK)
        res, out = shim.on_io(False, frame)
        assert res == int(FilterResult.OK)
        shim.close()
        return out

    return svc, client, req


def test_http_sidecar_lane_serves_sharded_and_demotes(tmp_path, monkeypatch):
    """The HTTP judge routes through the service's dispatch and the mesh
    rung: a raising sharded dispatch demotes typed and the round is
    answered from the single-card fallback."""
    inst.reset_module_registry()
    svc = client = None
    try:
        svc, client, req = _http_service(tmp_path, "http-mesh")
        ok_req = b"GET /public/a HTTP/1.1\r\n\r\n"
        assert req(9, ok_req) == ok_req
        eng = next(e for k, e in svc._engines.items() if k[4] == "http")
        assert isinstance(eng.model, ShardedVerdictModel)
        _arm_loss(monkeypatch, one_shot=False)
        assert req(10, b"POST /api/x HTTP/1.1\r\n\r\n") == b"POST /api/x HTTP/1.1\r\n\r\n"
        st = svc.status()
        assert st["mesh"]["demoted"] == "device-call"
        assert not isinstance(eng.model, ShardedVerdictModel)
        assert req(11, b"DELETE /x HTTP/1.1\r\n\r\n") != b"DELETE /x HTTP/1.1\r\n\r\n"
        assert st["containment"]["batch_crashes"] == 0
        assert st["containment"]["refused_entries"] == {}
    finally:
        _stop(client, svc)
        inst.reset_module_registry()


def test_daemon_engine_factory_builds_sharded_and_demotes():
    """The daemon side: ``_daemon_mesh`` resolves once from the config,
    the runtime engines serve sharded HTTP and Kafka models
    bit-identically, and the engine-level judge rung demotes a dead
    sharded model to its fallback instead of crashing the step."""
    from cilium_tpu_torch.parallel.rulesharding import mesh_http_model_from_rows, mesh_kafka_model
    from cilium_tpu_torch.policy.api import PortRuleHTTP, PortRuleKafka
    from cilium_tpu_torch.runtime.engines import HttpBatchEngine, KafkaBatchEngine, _daemon_mesh
    from cilium_tpu_torch.utils import metrics

    class _Daemon:
        config = DaemonConfig(mesh="on", mesh_rule_shards=2, verdict_device="cpu")

    d = _Daemon()
    mesh = _daemon_mesh(d)
    assert mesh is not None and mesh.shape[RULE_AXIS] == 2 and mesh.shape[FLOW_AXIS] == 4
    assert d.verdict_mesh is mesh and _daemon_mesh(d) is mesh

    model = mesh_http_model_from_rows(
        [(frozenset({7}), PortRuleHTTP(method="GET", path="/ok/.*"))], mesh)
    assert isinstance(model, ShardedVerdictModel)
    eng = HttpBatchEngine(model)
    req = b"GET /ok/x HTTP/1.1\r\n\r\n"
    eng.feed(1, req, remote_id=7)
    eng.feed(2, req, remote_id=99)
    eng.pump()
    assert eng.take_ops(1)[0] == [(PASS, len(req))]
    assert eng.take_ops(2)[0][0][0] == int(DROP)

    class _DeadSharded:
        def __init__(self, fallback):
            self.fallback = fallback

        def __call__(self, *_a, **_k):
            raise RuntimeError("copy to cuda:1 failed")

        verdicts_attr = __call__

    before = metrics.MeshDemotions.get("engine-judge")
    eng.model = _DeadSharded(model.fallback)
    eng.feed(3, req, remote_id=7)
    eng.pump()
    assert eng.take_ops(3)[0] == [(PASS, len(req))]
    assert eng.model is model.fallback
    assert metrics.MeshDemotions.get("engine-judge") == before + 1

    kr = PortRuleKafka(topic="orders", role="produce")
    kr.sanitize()
    kmodel = mesh_kafka_model([(frozenset({7}), kr)], mesh)
    assert isinstance(kmodel, ShardedKafkaModel)
    from test_kafka import produce_request

    keng = KafkaBatchEngine(kmodel)
    ok, bad = produce_request(["orders"]), produce_request(["secret"])
    keng.feed(1, ok, remote_id=7)
    keng.feed(2, bad, remote_id=7)
    keng.pump()
    assert keng.take_ops(1)[0] == [(PASS, len(ok))]
    assert keng.take_ops(2)[0][0][0] == int(DROP)


def test_device_loss_demotes_typed_zero_silent_loss(tmp_path, monkeypatch):
    """A sharded dispatch that raises: the round is answered from the
    fallback in the same round, the demotion is typed and sticky, and
    everything after serves bit-identically with nothing lost."""
    inst.reset_module_registry()
    svc = client = None
    try:
        svc, client, mod = _start(tmp_path, "mesh-loss", batch_timeout_ms=0.0)
        shim = _conn(client, mod, 50, 1)
        assert shim.on_io(False, b"READ /public/a.txt\r\n")[1] == b"READ /public/a.txt\r\n"
        _arm_loss(monkeypatch, one_shot=False)
        res, out = shim.on_io(False, b"HALT\r\n")
        assert res == int(FilterResult.OK) and out == b"HALT\r\n"
        st = svc.status()["mesh"]
        assert st["demoted"] == "device-call" and st["demotions"] == {"device-call": 1}
        assert st["active"] is False and st["rung"] == "fallback"
        assert not isinstance(next(iter(svc._engines.values())).model, ShardedVerdictModel)
        for frame, remote, want in TRAFFIC:
            s2 = _conn(client, mod, 60 + remote, remote)
            res, out = s2.on_io(False, frame)
            assert res == int(FilterResult.OK) and (out == frame) == want, (frame, out)
            s2.close()
        st = svc.status()
        _clean_containment(st)
        assert st["mesh"]["demotions"] == {"device-call": 1}
        assert svc._serving_mesh() is None
    finally:
        _stop(client, svc)
        inst.reset_module_registry()


def test_mesh_repromotes_after_heal_bit_identical(tmp_path, monkeypatch):
    """After a demotion with no attributed slot, the paced re-probe
    parity-probes off-path and flips the retained sharded models back;
    a second loss after the heal demotes again, typed."""
    inst.reset_module_registry()
    svc = client = None
    try:
        svc, client, mod = _start(tmp_path, "mesh-heal", batch_timeout_ms=0.0,
                                  mesh_reprobe_interval_s=0.05)
        shim = _conn(client, mod, 50, 1)
        assert shim.on_io(False, b"READ /public/a.txt\r\n")[1] == b"READ /public/a.txt\r\n"
        armed = _arm_loss(monkeypatch, one_shot=False)
        assert shim.on_io(False, b"HALT\r\n") == (int(FilterResult.OK), b"HALT\r\n")
        assert svc.status()["mesh"]["demoted"] == "device-call"
        armed["on"] = False  # the slot heals
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            assert shim.on_io(False, b"HALT\r\n") == (int(FilterResult.OK), b"HALT\r\n")
            if svc.status()["mesh"]["active"]:
                break
            time.sleep(0.05)
        st = svc.status()["mesh"]
        assert st["active"] is True and st["demoted"] is None and st["repromotions"] == 1
        assert isinstance(next(iter(svc._engines.values())).model, ShardedVerdictModel)
        assert svc._serving_mesh() is not None
        for i, (frame, remote, want) in enumerate(TRAFFIC):
            s2 = _conn(client, mod, 70 + i, remote)
            res, out = s2.on_io(False, frame)
            assert res == int(FilterResult.OK) and (out == frame) == want
            s2.close()
        _clean_containment(svc.status())
        armed["on"] = True
        assert shim.on_io(False, b"HALT\r\n") == (int(FilterResult.OK), b"HALT\r\n")
        assert svc.status()["mesh"]["demotions"]["device-call"] == 2
    finally:
        _stop(client, svc)
        inst.reset_module_registry()


def _arm_named_loss(svc, monkeypatch, dev_id, text=None):
    """One-shot sharded fault naming slot ``dev_id`` (through
    ``failed_devices``, or in its text as ``cuda:N``) plus a probe seam
    marking that slot dead."""
    if text is None:
        _arm_loss(monkeypatch, dev_id=dev_id)
    else:
        _arm_loss(monkeypatch, text=text)
    svc._device_probe_fn = lambda dev, _d=dev_id: dev.id != _d


@pytest.mark.parametrize("named_by", ["failed_devices", "text"])
def test_mesh_reshape_serves_degraded_then_repromotes(tmp_path, monkeypatch, named_by):
    """An attributed slot loss demotes typed, the immediate off-path
    reshape flips every engine onto a survivor mesh at a published
    capacity fraction, and the paced re-probe walks back up to full
    width when the slot heals — all counted, zero loss."""
    inst.reset_module_registry()
    svc = client = None
    try:
        svc, client, mod = _start(tmp_path, "mesh-reshape", batch_timeout_ms=0.0,
                                  mesh_reprobe_interval_s=0.05)
        shim = _conn(client, mod, 50, 1)
        assert shim.on_io(False, b"READ /public/a.txt\r\n")[1] == b"READ /public/a.txt\r\n"
        full_share = svc._drr_share()
        text = None if named_by == "failed_devices" else "copy to cuda:3 failed"
        _arm_named_loss(svc, monkeypatch, 3, text)
        assert shim.on_io(False, b"HALT\r\n") == (int(FilterResult.OK), b"HALT\r\n")
        assert svc.status()["mesh"]["demotions"] == {"device-call": 1}
        st = _await_rung(svc, "reshaped")
        assert st["active"] is True and st["demoted"] is None
        assert st["lost_devices"] == [3] and st["reshapes"] == 1
        assert 1 <= st["serving_devices"] < 8 and 0.0 < st["capacity_frac"] < 1.0
        assert st["reshape_window_ms"] > 0.0
        assert isinstance(next(iter(svc._engines.values())).model, ShardedVerdictModel)
        serving_ids = {d.id for d in svc._mesh_serving.devices.flat}
        assert 3 not in serving_ids and len(serving_ids) == st["serving_devices"]
        assert svc.dispatcher.max_pending < svc.config.shed_queue_entries
        assert svc._drr_share() <= full_share
        table = svc.guard.device_table()
        assert table["3"]["state"] == "lost"
        assert table["3"]["faults"].get("device-call", 0) >= 1
        for i, (frame, remote, want) in enumerate(TRAFFIC):
            s2 = _conn(client, mod, 100 + i, remote)
            res, out = s2.on_io(False, frame)
            assert res == int(FilterResult.OK) and (out == frame) == want
            s2.close()
        assert svc._serving_mesh() is svc._mesh_serving
        reshape_evs = svc.ledger.events(n=1000, cause="mesh-reshape")
        assert reshape_evs
        for ev in reshape_evs:
            assert ev["kind"] == "engine-build" and not ev["on_dispatch_path"] and ev["mesh"]

        svc._device_probe_fn = lambda dev: True
        st = _await_rung(svc, "full", client, mod, drive=True)
        assert st["repromotions"] == 1 and st["lost_devices"] == []
        assert st["capacity_frac"] == 1.0 and st["serving_devices"] == 8
        assert svc.dispatcher.max_pending == svc.config.shed_queue_entries
        table = svc.guard.device_table()
        assert table["3"]["state"] == "ok" and table["3"]["heals"] >= 1
        by_cause = svc.ledger.status()["by_cause"]
        assert by_cause.get("mesh-reshape", 0) >= 1 and by_cause.get("repromotion", 0) >= 1
        assert isinstance(next(iter(svc._engines.values())).model, ShardedVerdictModel)
        for i, (frame, remote, want) in enumerate(TRAFFIC):
            s2 = _conn(client, mod, 200 + i, remote)
            res, out = s2.on_io(False, frame)
            assert res == int(FilterResult.OK) and (out == frame) == want
            s2.close()
        _clean_containment(svc.status())
    finally:
        _stop(client, svc)
        inst.reset_module_registry()


def test_capacity_scaling_never_raises_a_small_cap(tmp_path, monkeypatch):
    inst.reset_module_registry()
    svc = client = None
    try:
        svc, client, mod = _start(tmp_path, "small-cap", shed_queue_entries=8)
        shim = _conn(client, mod, 1, 3)
        assert shim.on_io(False, b"HALT\r\n") == (int(FilterResult.OK), b"HALT\r\n")
        assert svc.status()["mesh"]["rung"] == "full"
        assert svc.dispatcher.max_pending == 8
        _arm_named_loss(svc, monkeypatch, 3)
        assert shim.on_io(False, b"HALT\r\n") == (int(FilterResult.OK), b"HALT\r\n")
        _await_rung(svc, "reshaped", client, mod, drive=True)
        assert 1 <= svc.dispatcher.max_pending <= 8
    finally:
        _stop(client, svc)
        inst.reset_module_registry()


LANE_CONFIGS = {
    "vec": dict(batch_timeout_ms=2.0),
    "fast-entry": dict(batch_timeout_ms=0.0),
}


@pytest.mark.parametrize("lane", ["fast-entry", "vec"])
def test_mesh_reshape_per_lane_bit_identical(tmp_path, monkeypatch, lane):
    """fault -> reshape -> bit-identical service -> re-promotion on each
    lane, against a single-card control fed the same bytes."""
    cfg_kw = LANE_CONFIGS[lane]

    def run(name, mesh_mode, fault):
        inst.reset_module_registry()
        svc = client = None
        try:
            svc, client, mod = _start(tmp_path, name, mesh=mesh_mode,
                                      mesh_reprobe_interval_s=0.05, **cfg_kw)
            outs = []

            def burst(base):
                for i, (frame, remote, _w) in enumerate(TRAFFIC):
                    shim = _conn(client, mod, base + i, remote)
                    r1, o1 = shim.on_io(False, frame)
                    assert r1 == int(FilterResult.OK)
                    outs.append(o1)
                    shim.close()

            burst(100)
            if fault:
                _arm_named_loss(svc, monkeypatch, 5)
            burst(200)
            if fault:
                st = _await_rung(svc, "reshaped")
                assert st["lost_devices"] == [5] and st["reshapes"] == 1
            burst(300)
            if fault:
                svc._device_probe_fn = lambda dev: True
                _await_rung(svc, "full", client, mod, drive=True)
                assert svc.status()["mesh"]["repromotions"] == 1
            burst(400)
            if fault:
                _clean_containment(svc.status())
            return outs
        finally:
            _stop(client, svc)
            inst.reset_module_registry()

    chaos = run(f"lane-{lane}", "on", fault=True)
    control = run(f"lane-{lane}-ctrl", "off", fault=False)
    assert chaos == control


def test_http_judge_lane_reshapes_and_repromotes(tmp_path, monkeypatch):
    inst.reset_module_registry()
    svc = client = None
    try:
        svc, client, req = _http_service(tmp_path, "http-mesh-l", mesh_reprobe_interval_s=0.05)
        ok_req, bad_req = b"GET /public/a HTTP/1.1\r\n\r\n", b"DELETE /x HTTP/1.1\r\n\r\n"
        assert req(9, ok_req) == ok_req
        _arm_named_loss(svc, monkeypatch, 2)
        assert req(10, ok_req) == ok_req
        assert svc.status()["mesh"]["demotions"] == {"device-call": 1}
        st = _await_rung(svc, "reshaped")
        assert st["lost_devices"] == [2]
        eng = next(e for k, e in svc._engines.items() if k[4] == "http")
        assert isinstance(eng.model, ShardedVerdictModel)
        assert req(11, ok_req) == ok_req and req(12, bad_req) != bad_req
        svc._device_probe_fn = lambda dev: True
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and svc.status()["mesh"]["rung"] != "full":
            assert req(13, ok_req) == ok_req
            time.sleep(0.05)
        st = svc.status()["mesh"]
        assert st["rung"] == "full" and st["repromotions"] == 1
        assert req(14, ok_req) == ok_req and req(15, bad_req) != bad_req
        st = svc.status()
        assert st["containment"]["batch_crashes"] == 0
        assert st["containment"]["refused_entries"] == {}
    finally:
        _stop(client, svc)
        inst.reset_module_registry()


# --- layouts ---------------------------------------------------------------------


def test_mesh_extents_64_wide_and_auto_cap():
    from cilium_tpu.parallel import mesh_extents as ref_extents
    from cilium_tpu_torch.parallel import mesh_extents

    cases = [
        (("on",), dict(flow_shards=64, n_devices=64), (64, 1)),
        (("on",), dict(rule_shards=2, flow_shards=64, n_devices=128), (64, 2)),
        (("on",), dict(n_devices=128), (32, 1)),
        (("on",), dict(n_devices=128, max_flow=64), (64, 1)),
        (("on",), dict(flow_shards=48, n_devices=64), (32, 1)),
        (("on",), dict(flow_shards=64, n_devices=32), None),
        (("off",), {}, None),
    ]
    for args, kw, want in cases:
        assert mesh_extents(*args, **kw) == want == ref_extents(*args, **kw)


def test_reshape_mesh_rungs_on_virtual_slots():
    from cilium_tpu_torch.parallel import reshape_mesh

    devs = virtual_devices(8, "cpu")
    m = reshape_mesh(devs[:3] + devs[4:], rule_shards=2, max_flow=4)
    assert (m.shape[FLOW_AXIS], m.shape[RULE_AXIS]) == (2, 2)
    assert devs[3] not in set(m.devices.flat)
    m = reshape_mesh(devs[:3], rule_shards=2)
    assert (m.shape[FLOW_AXIS], m.shape[RULE_AXIS]) == (1, 2)
    m = reshape_mesh(devs[:2], rule_shards=4)
    assert (m.shape[FLOW_AXIS], m.shape[RULE_AXIS]) == (1, 2)
    assert reshape_mesh(devs[:1], rule_shards=2) is None
    assert reshape_mesh([], rule_shards=1) is None


def test_serving_mesh_auto_needs_distinct_cards():
    """'auto' never builds a mesh of slots on one device (the reference
    needs more than one real accelerator); 'on' does; 'off' never."""
    from cilium_tpu_torch.parallel import serving_mesh

    devs = virtual_devices(8, "cpu")
    assert serving_mesh("auto", devices=devs) is None
    assert serving_mesh("off", devices=devs) is None
    m = serving_mesh("on", rule_shards=2, devices=devs)
    assert (m.shape[FLOW_AXIS], m.shape[RULE_AXIS]) == (4, 2)


def test_sharded_split_64_wide_degenerate_shapes():
    from cilium_tpu_torch.parallel.rulesharding import (
        build_sharded_r2d2_from_rows, shard_offsets, split_balanced,
    )

    rows = [
        (frozenset({1, 3}), "READ", "/public/.*"),
        (frozenset(), "HALT", ""),
        (frozenset({9}), "WRITE", "^/tmp/"),
        (frozenset(), "", "\\.txt$"),
    ]
    chunks = split_balanced(rows, 64)
    assert len(chunks) == 64 and [len(c) for c in chunks[:4]] == [1, 1, 1, 1]
    assert all(not c for c in chunks[4:])
    offs = np.asarray(shard_offsets(len(rows), 64))
    assert offs.shape == (64,) and list(offs[:4]) == [0, 1, 2, 3]
    assert all(int(o) == 4 for o in offs[4:])
    shards = build_sharded_r2d2_from_rows(rows, 64, bucket=True, device="cpu")
    assert len(shards) == 64
    shapes = {(m.cmd_len.shape, m.nfa.n_states, m.nfa.n_patterns) for m in shards}
    assert len(shapes) == 1  # one common shape, as the reference's stack
