"""The port's policy distribution and access log
(``cilium_tpu_torch/distribution/``, ``cilium_tpu_torch/accesslog/``)
against the reference's.

tests/test_distribution.py's cases run through both packages
(tests/agent_cases.py): cache versioning and reverts, subscriptions, ACK
and NACK tracking with completions, the socket round trip, the access
log's client / server round trip and the logger's endpoint enrichment.
Each scenario returns what the reference test asserts; the two packages'
answers must be equal.
"""

from __future__ import annotations

import json
import socket

import pytest

from agent_cases import PKGS, agent_globals, both, wait_for  # noqa: F401 (a fixture)
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)


def _np(pk):
    return pk.distribution.TYPE_NETWORK_POLICY


# --- the cache -----------------------------------------------------------------------


def _versioning(pk):
    c = pk.distribution.Cache()
    v0 = c.version
    v1, up1, _ = c.upsert(_np(pk), "ep1", {"p": 1})
    v2, up2, _ = c.upsert(_np(pk), "ep1", {"p": 1})
    v3, up3, _ = c.upsert(_np(pk), "ep1", {"p": 2})
    return (v0, v1, up1, v2, up2, v3, up3, c.lookup(_np(pk), "ep1"))


def _resources_since(pk):
    c = pk.distribution.Cache()
    c.upsert(_np(pk), "a", 1)
    v, _, _ = c.upsert(_np(pk), "b", 2)
    vr = c.get_resources(_np(pk), since_version=v - 1)
    return c.get_resources(_np(pk), since_version=v) is None, vr.version, dict(vr.resources)


def _cache_revert(pk):
    c = pk.distribution.Cache()
    c.upsert(_np(pk), "a", 1)
    _, _, revert = c.upsert(_np(pk), "a", 2)
    revert()
    after_upsert = c.lookup(_np(pk), "a")
    _, _, revert = c.delete(_np(pk), "a")
    deleted = c.lookup(_np(pk), "a")
    revert()
    return after_upsert, deleted, c.lookup(_np(pk), "a")


@pytest.mark.parametrize("scenario,want", [
    (_versioning, (1, 2, True, 2, False, 3, True, {"p": 2})),
    (_resources_since, (True, 3, {"a": 1, "b": 2})),
    (_cache_revert, (1, None, 1)),
], ids=["versioning", "resources-since", "revert"])
def test_cache_matches_reference(scenario, want):
    out = both(scenario)
    if scenario is _versioning:  # the first version is the cache's own
        assert out[1] > out[0] and out[3] == out[1] and out[5] > out[1]
        out = (1, 2, *out[2:5], 3, *out[6:])
    assert out == want


# --- the server and ACK tracking -----------------------------------------------------


def _subscribe_initial_and_updates(pk):
    c = pk.distribution.Cache()
    c.upsert(_np(pk), "ep1", {"rules": []})
    s = pk.distribution.DistributionServer(c)
    sub = s.subscribe("node1", _np(pk))
    first = sorted(sub.next(1).resources)
    c.upsert(_np(pk), "ep2", {"rules": [1]})
    return first, sorted(sub.next(1).resources)


def _ack_tracking(pk):
    c = pk.distribution.Cache()
    s = pk.distribution.DistributionServer(c)
    sub = s.subscribe("node1", _np(pk))
    v, _, _ = c.upsert(_np(pk), "ep1", 1)
    s.ack(sub, v)
    acked = s.node_acked_version("node1", _np(pk)) == v
    v2, _, _ = c.upsert(_np(pk), "ep1", 2)
    s.ack(sub, v2, nack=True)
    return acked, s.node_acked_version("node1", _np(pk)) == v


def _completion_on_all_acks(pk):
    c = pk.distribution.Cache()
    s = pk.distribution.DistributionServer(c)
    m = pk.distribution.AckingMutator(c, s)
    sub1, sub2 = s.subscribe("n1", _np(pk)), s.subscribe("n2", _np(pk))
    comp = pk.completion.Completion()
    m.upsert(_np(pk), "ep1", {"r": 1}, ["n1", "n2"], comp)
    s.ack(sub1, sub1.next(1).version)
    half = comp.completed
    s.ack(sub2, sub2.next(1).version)
    return half, comp.wait(1), m.pending_count()


def _nack_leaves_pending(pk):
    c = pk.distribution.Cache()
    s = pk.distribution.DistributionServer(c)
    m = pk.distribution.AckingMutator(c, s)
    sub = s.subscribe("n1", _np(pk))
    comp = pk.completion.Completion()
    m.upsert(_np(pk), "ep1", {"r": 1}, ["n1"], comp)
    s.ack(sub, sub.next(1).version, nack=True)
    return comp.completed, comp.wait(0.05), m.pending_count()


def _already_acked_completes(pk):
    c = pk.distribution.Cache()
    s = pk.distribution.DistributionServer(c)
    m = pk.distribution.AckingMutator(c, s)
    sub = s.subscribe("n1", _np(pk))
    v, _, _ = c.upsert(_np(pk), "x", 1)
    s.ack(sub, v + 10)  # the node is ahead of anything pushed next
    comp = pk.completion.Completion()
    m.upsert(_np(pk), "x", 1, ["n1"], comp)
    return comp.completed


def _later_ack_completes_older(pk):
    c = pk.distribution.Cache()
    s = pk.distribution.DistributionServer(c)
    m = pk.distribution.AckingMutator(c, s)
    sub = s.subscribe("n1", _np(pk))
    c1, c2 = pk.completion.Completion(), pk.completion.Completion()
    m.upsert(_np(pk), "a", 1, ["n1"], c1)
    m.upsert(_np(pk), "b", 2, ["n1"], c2)
    last = None
    while True:
        vr = sub.next(0.2)
        if vr is None:
            break
        last = vr
    s.ack(sub, last.version)
    return c1.wait(1), c2.wait(1), m.pending_count()


@pytest.mark.parametrize("scenario,want", [
    (_subscribe_initial_and_updates, (["ep1"], ["ep1", "ep2"])),
    (_ack_tracking, (True, True)),
    (_completion_on_all_acks, (False, True, 0)),
    (_nack_leaves_pending, (False, False, 1)),
    (_already_acked_completes, True),
    (_later_ack_completes_older, (True, True, 0)),
], ids=["subscribe", "ack-tracking", "completion-on-all-acks", "nack-leaves-pending", "already-acked",
        "later-ack-completes-older"])
def test_server_and_acks_match_reference(scenario, want):
    assert both(scenario) == want


# --- the socket transport ------------------------------------------------------------


def _socket_roundtrip(pk, tmp_path):
    c = pk.distribution.Cache()
    s = pk.distribution.DistributionServer(c)
    path = str(tmp_path / f"{pk.name}-dist.sock")
    srv = pk.sock.SocketDistributionServer(s, path)
    client = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        c.upsert(_np(pk), "ep1", {"rules": ["a"]})
        client.connect(path)
        pk.sock.send_frame(client, {"subscribe": {"node": "sidecar1", "type_url": _np(pk)}})
        msg = pk.sock.recv_frame(client)
        pk.sock.send_frame(client, {"ack": {"version": msg["version"]}})
        acked = wait_for(lambda: s.node_acked_version("sidecar1", _np(pk)) == msg["version"], 2)
        c.upsert(_np(pk), "ep2", {"rules": ["b"]})
        msg2 = pk.sock.recv_frame(client)
        return msg["resources"], acked, sorted(msg2["resources"]), msg2["version"] - msg["version"]
    finally:
        client.close()
        srv.close()


def test_socket_roundtrip_matches_reference(tmp_path):
    assert both(_socket_roundtrip, tmp_path) == ({"ep1": {"rules": ["a"]}}, True, ["ep1", "ep2"], 1)


# --- the access log ------------------------------------------------------------------


def _accesslog_roundtrip(pk, tmp_path):
    path = str(tmp_path / f"{pk.name}-access.sock")
    got = []
    srv = pk.accesslog.AccessLogServer(path, on_record=got.append)
    client = None
    try:
        client = pk.accesslog.AccessLogClient(path)
        rec = pk.accesslog.LogRecord(verdict=pk.accesslog.VERDICT_DENIED,
                                     http=pk.accesslog.HttpLogEntry(code=403, method="GET", url="/private"))
        sent = client.log(rec)
        wait_for(lambda: got, 10)
        return sent, [r.to_dict() for r in got]
    finally:
        if client is not None:
            client.close()
        srv.close()


def test_accesslog_client_server_matches_reference(tmp_path):
    sent, records = both(_accesslog_roundtrip, tmp_path)
    assert sent and len(records) == 1
    assert records[0]["verdict"] == PKGS["ref"].accesslog.VERDICT_DENIED


def _logger_enrichment(pk, tmp_path):
    ep = pk.endpoint.Endpoint(7, ipv4="10.0.0.7", **pk.ep_kw)
    ep.set_identity(pk.identity.Identity(id=555, labels=pk.labels.Labels.from_model(["k8s:app=x"])))
    logfile = tmp_path / f"{pk.name}-access.log"
    notified = []
    logger = pk.accesslog.AccessLogger(endpoint_lookup=lambda eid: ep if eid == 7 else None,
                                       notify=notified.append, logfile_path=str(logfile))
    before = pk.metrics.ProxyVerdicts.get("unknown", "forwarded")
    rec = pk.accesslog.LogRecord()
    rec.destination.id = 7
    logger.log(rec)
    line = json.loads(logfile.read_text().splitlines()[0])
    return (rec.destination.identity, rec.destination.labels, rec.destination.ipv4, len(notified),
            line["destination"], pk.metrics.ProxyVerdicts.get("unknown", "forwarded") - before)


def test_accesslog_logger_enrichment_matches_reference(tmp_path):
    out = both(_logger_enrichment, tmp_path)
    assert out[:4] == (555, ["k8s:app=x"], "10.0.0.7", 1) and out[4]["identity"] == 555 and out[5] == 1


def test_accesslog_exports_match_reference():
    ref, port = PKGS["ref"].accesslog, PKGS["port"].accesslog
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in ref.__all__:
        if name.isupper():
            assert getattr(port, name) == getattr(ref, name)
