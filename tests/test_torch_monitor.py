"""The port's monitor against the JAX package's.

Twins of the reference's monitor tests: the flow log's POLICY-VERDICT
events under ``OPTION_POLICY_VERDICT_NOTIFY`` (tests/test_flowlog.py's
toggle test), the tracer's TRACE exemplars (tests/test_observability.py),
the flight recorder's POSTMORTEM events (tests/test_blackbox.py), the two
listener tests of tests/test_runtime_engines.py, ``format_event`` on the
same events, and the monitor socket.  The flow log, tracer and recorder
reach the monitor through a lazy import inside a ``try``: without the
port's ``monitor`` package they emit nothing.  Each event's type and
payload must equal the reference's (tolerance 0).
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from cilium_tpu.flowlog import CODE_DENIED as REF_DENIED
from cilium_tpu.flowlog import CODE_FORWARDED as REF_FORWARDED
from cilium_tpu.flowlog import FlowLog as RefFlowLog
from cilium_tpu.monitor import Monitor as RefMonitor
from cilium_tpu.monitor import format_event as ref_format_event
from cilium_tpu.monitor import monitor as ref_monitor_mod
from cilium_tpu.sidecar.trace import VerdictTracer as RefTracer
from cilium_tpu.utils.option import OptionMap as RefOptionMap
from cilium_tpu_torch import monitor as port_monitor_pkg
from cilium_tpu_torch.flowlog import CODE_DENIED, CODE_FORWARDED, FlowLog
from cilium_tpu_torch.monitor import Monitor, MonitorClient, MonitorEvent, MonitorServer, format_event
from cilium_tpu_torch.monitor import monitor as monitor_mod
from cilium_tpu_torch.sidecar.trace import VerdictTracer
from cilium_tpu_torch.utils.option import OPTION_POLICY_VERDICT_NOTIFY, OptionMap
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

PORT = dict(FlowLog=FlowLog, Monitor=Monitor, OptionMap=OptionMap, Tracer=VerdictTracer,
            FORWARDED=CODE_FORWARDED, DENIED=CODE_DENIED, mod=monitor_mod)
REF = dict(FlowLog=RefFlowLog, Monitor=RefMonitor, OptionMap=RefOptionMap, Tracer=RefTracer,
           FORWARDED=REF_FORWARDED, DENIED=REF_DENIED, mod=ref_monitor_mod)




def _event(e):
    return e.type, e.payload


def _await(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"{what} never held")


def test_monitor_exports_the_references_names():
    from cilium_tpu import monitor as ref_pkg

    assert port_monitor_pkg.__all__ == ref_pkg.__all__
    for name in ref_pkg.__all__:
        ref = getattr(ref_pkg, name)
        if isinstance(ref, (int, str)):
            assert getattr(port_monitor_pkg, name) == ref, name


# --- the flow log's POLICY-VERDICT events (tests/test_flowlog.py:150) ---------


def _toggle_run(ns):
    opts = ns["OptionMap"]()
    events = []
    mon = ns["Monitor"]()
    mon.add_listener(events.append, queued=False)
    fl = ns["FlowLog"](capacity=100, opts=opts, monitor=mon)
    fl.register_conn(5, "pol", True, 1, 2, "a:1", "b:2", "r2d2", 80)

    def round_():
        fl.add_round(
            "vec", np.asarray([5, 5], np.int64),
            np.asarray([ns["FORWARDED"], ns["DENIED"]], np.int8),
            np.asarray([1, -1], np.int32), kinds=("literal", "regex"),
        )

    out = []
    round_()
    out.append([_event(e) for e in events])
    assert opts.set(OPTION_POLICY_VERDICT_NOTIFY, True)
    round_()
    out.append([_event(e) for e in events])
    events.clear()
    assert opts.set(OPTION_POLICY_VERDICT_NOTIFY, False)
    round_()
    out.append([_event(e) for e in events])
    return out


def test_policy_verdict_notify_option_toggle():
    """Off -> silent, on -> POLICY-VERDICT events (allow and deny, with the
    rule attribution), off again -> silent; the same events as the
    reference's."""
    off, on, off_again = _toggle_run(PORT)
    assert off == [] and off_again == []
    assert {t for t, _ in on} == {monitor_mod.MSG_TYPE_POLICY_VERDICT}
    assert {p["allowed"] for _, p in on} == {True, False}
    allow = next(p for _, p in on if p["allowed"])
    assert (allow["rule_id"], allow["match_kind"], allow["policy"]) == (1, "regex", "pol")
    assert [off, on, off_again] == _toggle_run(REF)


def test_policy_verdict_events_are_capped_per_round():
    """A round of more verdicts than MAX_VERDICT_NOTIFICATIONS emits that
    many events, as the reference does."""
    from cilium_tpu_torch.flowlog.ring import MAX_VERDICT_NOTIFICATIONS

    got = []
    for ns in (PORT, REF):
        opts = ns["OptionMap"]()
        opts.set(OPTION_POLICY_VERDICT_NOTIFY, True)
        events = []
        mon = ns["Monitor"]()
        mon.add_listener(events.append, queued=False)
        fl = ns["FlowLog"](capacity=4096, opts=opts, monitor=mon)
        n = MAX_VERDICT_NOTIFICATIONS + 7
        rng = np.random.default_rng(3)
        fl.add_round("vec", np.arange(n, dtype=np.int64),
                     np.where(rng.random(n) < 0.5, ns["FORWARDED"], ns["DENIED"]).astype(np.int8),
                     np.full(n, -1, np.int32))
        got.append([_event(e) for e in events])
    assert len(got[0]) == MAX_VERDICT_NOTIFICATIONS
    assert got[0] == got[1]


# --- TRACE exemplars (tests/test_observability.py) ----------------------------


def _tracer_run(ns):
    events = []
    mon = ns["Monitor"]()
    mon.add_listener(events.append, queued=False)
    tr = ns["Tracer"](sample_every=1, slow_ms=1e9, ring=4, batch_capacity=64)
    tr.monitor = mon
    t0 = time.monotonic()
    rt = tr.begin_round("oracle", 3, t0, t0)
    tr.finish_round(rt, [(7, 3, t0, 11)])
    sampled = list(events)
    tr.slow_s = 0.0
    rt = tr.begin_round("oracle", 2, t0, t0)
    tr.finish_round(rt, [(8, 2, t0, 12)])
    return sampled, events


@pytest.mark.parametrize("ns", [PORT, REF], ids=["port", "ref"])
def test_tracer_slow_exemplar_reaches_the_monitor(ns):
    sampled, events = _tracer_run(ns)
    assert sampled == []  # sampled spans are cheap: no monitor fan-out
    assert len(events) == 1 and events[0].type == ns["mod"].MSG_TYPE_TRACE
    sv = events[0].payload["slow_verdict"]
    assert (sv["seq"], sv["path"], sv["kind"]) == (8, "oracle", "slow")


def test_tracer_trace_event_matches_reference():
    def shape(events):
        sv = events[0].payload["slow_verdict"]
        return events[0].type, sorted(sv), {k: sv[k] for k in ("seq", "path", "kind", "entries", "conn_id")}

    assert shape(_tracer_run(PORT)[1]) == shape(_tracer_run(REF)[1])


# --- POSTMORTEM events (tests/test_blackbox.py) --------------------------------


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_flight_recorder_postmortem_reaches_the_monitor(pkg):
    """A fail-closed edge through the real choke point writes a bundle and
    notifies the recorder's monitor with a POSTMORTEM event."""
    if pkg == "port":
        from cilium_tpu_torch.analysis import protocols as proto
        from cilium_tpu_torch.sidecar.blackbox import FlightRecorder
        mon_cls, mod = Monitor, monitor_mod
    else:
        from cilium_tpu.analysis import protocols as proto
        from cilium_tpu.sidecar.blackbox import FlightRecorder
        mon_cls, mod = RefMonitor, ref_monitor_mod
    events = []
    mon = mon_cls()
    mon.add_listener(events.append, queued=False)
    rec = FlightRecorder()
    rec.install()
    rec.monitor = mon
    try:
        rec.record_mark("warmup")
        proto.MESH_DEVICE_PROTOCOL.advance(proto.DEVICE_OK, proto.DEVICE_LOST)
        _await(lambda: events, what="postmortem notify")
        assert [e.type for e in events] == [mod.MSG_TYPE_POSTMORTEM]
        p = events[0].payload
        assert p["trigger"] == "mesh_device:ok->lost" and p["events"] == 2
        proto.MESH_DEVICE_PROTOCOL.advance(proto.DEVICE_LOST, proto.DEVICE_OK)
    finally:
        rec.uninstall()


# --- the listeners (tests/test_runtime_engines.py:182,206) --------------------


def test_monitor_slow_listener_does_not_stall_publisher():
    mon = Monitor(queue_size=8)
    seen = []

    def slow(ev):
        time.sleep(0.05)
        seen.append(ev)

    mon.add_listener(slow)
    t0 = time.perf_counter()
    for i in range(20):
        mon.notify(MonitorEvent(monitor_mod.MSG_TYPE_AGENT, {"i": i}))
    publish_time = time.perf_counter() - t0
    # publishing 20 events must not serialize behind the 50 ms callback
    assert publish_time < 0.5, publish_time
    time.sleep(1.2)
    status = mon.status()
    # the slow listener lost some events to its bounded queue, counted
    assert status["seen"] == 20
    assert len(seen) + status["lost"] >= 20
    assert status["lost"] > 0  # queue of 8 overflowed
    mon.remove_listener(slow)


def test_monitor_fast_listener_gets_everything():
    mon = Monitor(queue_size=64)
    got = []
    mon.add_listener(got.append)
    for i in range(30):
        mon.notify(MonitorEvent(monitor_mod.MSG_TYPE_AGENT, {"i": i}))
    deadline = time.monotonic() + 2
    while len(got) < 30 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(got) == 30
    assert [e.payload["i"] for e in got] == list(range(30))  # in order
    # bound-method removal must actually remove (== matching, not id)
    mon.remove_listener(got.append)
    assert mon.status()["listeners"] == 0
    mon.notify(MonitorEvent(monitor_mod.MSG_TYPE_AGENT, {"i": 99}))
    time.sleep(0.1)
    assert len(got) == 30  # nothing delivered after removal


# --- format_event ----------------------------------------------------------------


def _format_cases(mod):
    ev = mod.MonitorEvent
    return [
        ev(mod.MSG_TYPE_POLICY_VERDICT, {"src_identity": 1, "dst_identity": 2, "dport": 80, "proto": 6,
                                         "allowed": True, "rule_id": 3, "match_kind": "literal",
                                         "policy": "web", "proxy_port": 10001}, timestamp=0.0),
        ev(mod.MSG_TYPE_POLICY_VERDICT, {"src_identity": 1, "dst_identity": 2, "dport": 80, "proto": 17,
                                         "allowed": False, "rule_id": -1, "match_kind": "",
                                         "policy": "web"}, timestamp=0.0),
        ev(mod.MSG_TYPE_DROP, {"src_identity": 5, "dst_identity": 6, "dport": 443, "proto": 6,
                               "l7": "http"}, timestamp=0.0),
        ev(mod.MSG_TYPE_DROP, {"src_identity": 1, "dst_identity": 2, "dport": 80, "proto": 99},
           timestamp=0.0),
        ev(mod.MSG_TYPE_AGENT, {"text": "policy updated"}, timestamp=0.0),
        ev(mod.MSG_TYPE_ACCESS_LOG, {"verdict": "Denied", "l7_protocol": "kafka", "info": "t"},
           timestamp=0.0),
        ev(mod.MSG_TYPE_TRACE, {"slow_verdict": {"path": "vec", "seq": 1, "conn_id": 2, "entries": 3,
                                                 "e2e_us": 1500.0, "reason": "shed",
                                                 "stages_us": {"queue": 1200.0, "device": 300.0}}},
           timestamp=0.0),
        ev(mod.MSG_TYPE_TRACE, {"x": 1}, timestamp=0.0),
        ev(mod.MSG_TYPE_POSTMORTEM, {"trigger": "mesh_device:ok->lost", "seq": 4, "events": 2,
                                     "reason": "unit", "path": "/b/1.json"}, timestamp=0.0),
        ev(mod.MSG_TYPE_DEBUG, {"k": "v"}, timestamp=0.0),
        ev(77, {"k": "v"}, timestamp=0.0),
    ]


def test_format_event_matches_reference():
    got = [format_event(e) for e in _format_cases(monitor_mod)]
    want = [ref_format_event(e) for e in _format_cases(ref_monitor_mod)]
    assert got == want
    assert "POLICY-VERDICT: ALLOW identity 1 -> 2 dport 80/tcp redirect :10001" in got[0]
    assert "SLOW-VERDICT" in got[6] and "POSTMORTEM" in got[8]
    # the event dict codec round trip renders the same line
    for e in _format_cases(monitor_mod):
        back = MonitorEvent.from_dict(json.loads(json.dumps(e.to_dict())))
        assert format_event(back) == format_event(e)


# --- the monitor socket (reference: monitor/listener1_2.go) ---------------------


def test_monitor_server_streams_events_to_a_client(tmp_path):
    mon = Monitor()
    path = str(tmp_path / "monitor.sock")
    server = MonitorServer(mon, path)
    try:
        client = MonitorClient(path)
        try:
            _await(lambda: server.subscriber_count() == 1, what="subscription")
            for i in range(5):
                mon.notify(MonitorEvent(monitor_mod.MSG_TYPE_AGENT, {"text": f"e{i}"}))
            got = [client.next_event(timeout=5.0) for _ in range(5)]
        finally:
            client.close()
    finally:
        server.close()
    assert [e.payload["text"] for e in got] == [f"e{i}" for i in range(5)]
    assert {e.type for e in got} == {monitor_mod.MSG_TYPE_AGENT}


def test_engine_keeps_the_monitor_it_is_given():
    """BaseBatchEngine takes the reference's ``monitor=`` keyword again
    (``create_engine_for_redirect`` passes it)."""
    from cilium_tpu_torch.models.base import ConstVerdict
    from cilium_tpu_torch.runtime.engines import HttpBatchEngine, KafkaBatchEngine

    mon = Monitor()
    assert HttpBatchEngine(ConstVerdict(True), monitor=mon).monitor is mon
    assert KafkaBatchEngine(ConstVerdict(True), monitor=mon).monitor is mon
    assert HttpBatchEngine(ConstVerdict(True)).monitor is None
