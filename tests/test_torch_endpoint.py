"""The port's endpoints (``cilium_tpu_torch/endpoint/``) and spanstat
against the reference.

Scenarios from tests/test_endpoint.py (the state machine, regeneration
into desired and realized policy-map state, redirects, enforcement modes,
revision skips, stale-key sync, restore, the manager's indexes, the build
queue) and tests/test_utils.py's spanstat cases run through both packages
(tests/state_cases.py).  The port's endpoints export their policy maps at
``device="cpu"``: the ``DevicePolicyMap`` tables and K13's
``policy_can_access_batch`` verdicts on them (the plain path) must equal
the reference's.  Host code and the plain versions only.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from cilium_tpu.maps import policymap as ref_policymap_ops
from cilium_tpu_torch.maps import policymap as port_policymap_ops
from policy_cases import reference_leak_guard  # noqa: F401
from state_cases import PKGS, both, policymap_contents


@pytest.fixture(autouse=True)
def _default_enforcement():
    for pk in PKGS.values():
        pk.option.config = pk.option.DaemonConfig()
        pk.policy.set_policy_enabled("default")
    yield
    for pk in PKGS.values():
        pk.policy.set_policy_enabled("default")


class _Owner:
    """The endpoint's daemon, as tests/test_endpoint.py's FakeOwner: a
    repository, an identity cache, a proxy manager, and an ACK that
    ``acks`` decides."""

    def __init__(self, pk, acks=True):
        self.repo = pk.policy.Repository()
        self.identity_cache = {}
        self.proxy = pk.proxy.ProxyManager()
        self.acks = acks

    def get_policy_repository(self):
        return self.repo

    def get_identity_cache(self):
        return dict(self.identity_cache)

    def get_proxy_manager(self):
        return self.proxy

    def update_network_policy(self, ep):
        return self.acks


def _sel(pk, *lbls):
    return pk.policy.EndpointSelector.from_labels(*(pk.labels.parse_select_label(x) for x in lbls))


def _endpoint(pk, ep_id=100, identity_id=1000, labels=("k8s:app=server",)):
    ep = pk.endpoint.Endpoint(ep_id, ipv4="10.0.0.10", **pk.ep_kw)
    ep.set_identity(pk.identity.Identity(id=identity_id, labels=pk.labels.Labels.from_model(labels)))
    ep.state = pk.endpoint.EndpointState.WAITING_TO_REGENERATE
    return ep


def _state(ep):
    """An endpoint's policy state: desired, realized, the host map, the
    redirects, its state and revision."""
    def keyed(d):
        return {(k.identity, k.dest_port, k.proto, k.direction): v.proxy_port for k, v in d.items()}
    return dict(desired=keyed(ep.desired_map_state), realized=keyed(ep.realized_map_state),
                map=policymap_contents(ep.policy_map), redirects=dict(ep.realized_redirects),
                state=ep.state.value, revision=ep.policy_revision)


def _device_table(dmap):
    """A DevicePolicyMap's table as numpy: keys [4, N], values, valid."""
    t = dmap.table
    if hasattr(t, "keys") and isinstance(t.keys, torch.Tensor):
        assert t.keys.device.type == "cpu"
        return t.keys.numpy(), t.values.numpy(), t.valid.numpy()
    return np.stack([np.asarray(c) for c in t.cols]), np.asarray(t.values), np.asarray(t.valid)


def _queries(rng, ids, n=512):
    ident = rng.choice(np.asarray(sorted(ids) + [0, 4242], np.int32), n)
    dport = rng.choice(np.asarray([0, 80, 443, 9092], np.int32), n)
    proto = rng.choice(np.asarray([0, 6, 17], np.int32), n)
    return ident, dport, proto


def _verdicts(pk, dmap, q, direction):
    if pk.name == "cilium_tpu":
        return [np.asarray(x) for x in ref_policymap_ops.policy_can_access_batch(dmap, *q, direction)]
    qt = [torch.from_numpy(x) for x in q]
    return [x.numpy() for x in port_policymap_ops.policy_can_access_batch(dmap, *qt, direction)]


# --- the state machine ----------------------------------------------------------------


def _lifecycle(pk):
    S = pk.endpoint.EndpointState
    ep = pk.endpoint.Endpoint(1, **pk.ep_kw)
    out = [ep.set_state(s) for s in (S.WAITING_FOR_IDENTITY, S.READY, S.WAITING_TO_REGENERATE,
                                     S.REGENERATING, S.READY, S.DISCONNECTING, S.DISCONNECTED)]
    ep2 = pk.endpoint.Endpoint(2, **pk.ep_kw)
    out.append(ep2.set_state(S.READY))
    ep2.state = S.DISCONNECTED
    out += [ep2.set_state(S.READY), ep2.set_state(S.DISCONNECTED), ep2.is_disconnecting()]
    return out


def test_state_machine_matches_reference():
    assert both(_lifecycle) == [True] * 7 + [False, False, False, True]


def test_endpoint_runs_on_the_card_unless_asked():
    """``device=None`` is the CUDA card and raises without one (this
    sandbox has none); "cpu" exports to the CPU tables."""
    port = PKGS["port"].endpoint
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.Endpoint(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            port.EndpointManager()
    assert port.Endpoint(1, device="cpu").device == torch.device("cpu")
    mgr = port.EndpointManager(device="cpu")
    mgr.insert(port.Endpoint(3, device="cpu"))
    assert len(mgr) == 1


# --- regeneration ---------------------------------------------------------------------


def _l4_world(pk, owner, l7):
    P = pk.policy
    owner.identity_cache = {1000: pk.labels.Labels.from_model(["k8s:app=server"]),
                            2000: pk.labels.Labels.from_model(["k8s:app=client"]),
                            3000: pk.labels.Labels.from_model(["k8s:app=other"])}
    rules = P.L7Rules(l7proto="r2d2", l7=[P.PortRuleL7({"cmd": "READ"})]) if l7 else None
    owner.repo.add(P.Rule(
        endpoint_selector=_sel(pk, "app=server"),
        labels=pk.labels.LabelArray.parse("rule=l4"),
        ingress=[P.IngressRule(from_endpoints=[_sel(pk, "app=client")],
                               to_ports=[P.PortRule(ports=[P.PortProtocol("80", "TCP")], rules=rules)])]))


def _regenerate(pk, l7, seed):
    owner = _Owner(pk)
    _l4_world(pk, owner, l7)
    ep = _endpoint(pk)
    out = [ep.regenerate(owner), _state(ep)]
    q = _queries(np.random.default_rng(seed), owner.identity_cache)
    DIR = pk.policymap
    table = _device_table(ep.device_policy_map)
    out.append([a.tolist() for a in table])
    out.append([v.tolist() for d in (DIR.DIR_INGRESS, DIR.DIR_EGRESS)
                for v in _verdicts(pk, ep.device_policy_map, q, d)])
    out.append([ep.policy_map.lookup(i, p, pr, DIR.DIR_INGRESS) for i, p, pr in zip(*(x.tolist() for x in q))])
    # a second regeneration keeps the redirect's port; deleting the rule
    # tears the redirect down
    ep.force_policy_compute = True
    ep.set_state(pk.endpoint.EndpointState.WAITING_TO_REGENERATE)
    out += [ep.regenerate(owner), _state(ep)]
    owner.repo.delete_by_labels(pk.labels.LabelArray.parse("rule=l4"))
    ep.set_state(pk.endpoint.EndpointState.WAITING_TO_REGENERATE)
    out += [ep.regenerate(owner), _state(ep), [a.tolist() for a in _device_table(ep.device_policy_map)]]
    # no ACK: the map reverts and the endpoint is not ready
    owner.acks = False
    _l4_world(pk, owner, l7)
    ep.set_state(pk.endpoint.EndpointState.WAITING_TO_REGENERATE)
    out += [ep.regenerate(owner), _state(ep), ep.force_policy_compute]
    return out


@pytest.mark.parametrize("l7", [False, True])
def test_regeneration_matches_reference(l7):
    out = both(_regenerate, l7, 3)
    assert out[0] and out[1]["state"] == "ready"
    # DIR_INGRESS 0, DIR_EGRESS 1
    assert out[1]["desired"][(2000, 80, 6, 0)] == (out[1]["redirects"].get("100:ingress:TCP:80", 0))
    assert (1000, 80, 6, 0) not in out[1]["desired"] and (2000, 0, 0, 1) in out[1]["desired"]
    assert out[1]["realized"] == out[1]["desired"] == out[1]["map"]
    if l7:
        assert 10000 <= out[1]["desired"][(2000, 80, 6, 0)] < 20000
        assert out[6]["desired"] == out[1]["desired"]
    assert out[7] and not out[8]["redirects"]
    assert out[-3] is False and out[-2]["state"] == "not-ready" and out[-1] is True


def _enforcement(pk):
    owner = _Owner(pk)
    owner.identity_cache = {2000: pk.labels.Labels.from_model(["k8s:app=client"])}
    ep = _endpoint(pk)
    out = []
    for mode in ("never", "always"):
        pk.policy.set_policy_enabled(mode)
        ep.force_policy_compute = True
        ep.set_state(pk.endpoint.EndpointState.WAITING_TO_REGENERATE)
        out += [ep.regenerate(owner), _state(ep)]
    pk.policy.set_policy_enabled("never")
    ep.force_policy_compute = True
    ep.set_state(pk.endpoint.EndpointState.WAITING_TO_REGENERATE)
    out += [ep.regenerate(owner), ep.policy_map.exists(2000, 0, 0, pk.policymap.DIR_INGRESS)]
    owner.identity_cache = {}
    ep.force_policy_compute = True
    ep.set_state(pk.endpoint.EndpointState.WAITING_TO_REGENERATE)
    out += [ep.regenerate(owner), ep.policy_map.exists(2000, 0, 0, pk.policymap.DIR_INGRESS)]
    # revision skips
    owner2 = _Owner(pk)
    owner2.identity_cache = {1000: pk.labels.Labels.from_model(["k8s:app=server"])}
    ep2 = _endpoint(pk, ep_id=7)
    out.append(ep2.regenerate_policy(owner2))
    out.append(ep2.regenerate_policy(owner2))
    owner2.repo.bump_revision()
    out.append(ep2.regenerate_policy(owner2))
    owner2.identity_cache[2000] = pk.labels.Labels.from_model(["k8s:app=client"])
    out.append(ep2.regenerate_policy(owner2))
    return out


def test_enforcement_modes_and_revisions_match_reference():
    out = both(_enforcement)
    assert (2000, 0, 0, 0) in out[1]["desired"] and (2000, 0, 0, 1) in out[1]["desired"]
    assert (2000, 0, 0, 0) not in out[3]["desired"]
    assert out[4:] == [True, True, True, False, True, False, True, True]


# --- restore, manager, build queue ---------------------------------------------------


def _restore(pk, tmp):
    ep = _endpoint(pk, ep_id=42)
    ep.policy_revision = 7
    path = ep.write_state(tmp)
    bad = pk.endpoint.Endpoint(13, **pk.ep_kw).write_state(tmp)
    with open(bad, "w") as f:
        f.write("{nope")
    restored = pk.endpoint.Endpoint.restore_from_dir(tmp, **pk.ep_kw)
    return [path.endswith("42/ep_config.json")] + [
        (r.id, r.ipv4, r.security_identity.id, r.policy_revision, r.state.value,
         sorted(r.security_identity.labels.get_model())) for r in restored]


def test_restore_matches_reference(tmp_path):
    got = {}
    for name, pk in PKGS.items():
        (tmp_path / name).mkdir()
        got[name] = _restore(pk, str(tmp_path / name))
    assert got["port"] == got["ref"] == [True, (42, "10.0.0.10", 1000, 7, "restoring", ["k8s:app=server"])]
    restored = PKGS["port"].endpoint.Endpoint.restore_from_dir(str(tmp_path / "port"), device="cpu")
    assert restored[0].device == torch.device("cpu")


def _manager(pk):
    mgr = pk.endpoint.EndpointManager(**pk.ep_kw)
    eps = []
    for i in range(3):
        e = _endpoint(pk, ep_id=i + 1)
        e.ipv4 = f"10.0.0.{i + 1}"
        e.container_name = f"web-{i}"
        mgr.insert(e)
        eps.append(e)
    out = [mgr.lookup(2) is eps[1], mgr.lookup_container("web-0") is eps[0],
           mgr.lookup_ipv4("10.0.0.3") is eps[2], len(mgr)]
    seen = []
    out += [mgr.trigger_policy_updates(lambda ep: seen.append(ep.id)), seen]
    out += [mgr.remove(eps[0]), mgr.lookup(1), mgr.remove(eps[0]), [e.id for e in mgr.get_endpoints()]]
    return out


def test_manager_matches_reference():
    assert both(_manager) == [True, True, True, 3, 3, [1, 2, 3], True, None, False, [2, 3]]


def _queue(pk):
    BuildQueue = pk.endpoint.BuildQueue
    built = []
    q = BuildQueue(lambda x: built.append(x), workers=2)
    for i in range(10):
        q.enqueue(i)
    out = [q.wait_idle(5), sorted(built)]
    q.stop()
    started, release, folded = threading.Event(), threading.Event(), []

    def build(x):
        folded.append(x)
        started.set()
        release.wait(5)

    q = BuildQueue(build, workers=1)
    q.enqueue("ep1", key="ep1")
    out.append(started.wait(2))
    for _ in range(3):
        q.enqueue("ep1", key="ep1")
    release.set()
    out += [q.wait_idle(5), folded]
    q.stop()
    good = []

    def flaky(x):
        if x == "bad":
            raise RuntimeError("boom")
        good.append(x)

    q = BuildQueue(flaky, workers=1)
    q.enqueue("bad")
    q.enqueue("good")
    out += [q.wait_idle(5), good]
    q.stop()
    return out


def test_build_queue_matches_reference():
    assert both(_queue) == [True, list(range(10)), True, True, ["ep1", "ep1"], True, ["good"]]


def _spans(pk):
    s = pk.spanstat.SpanStat()
    s.start()
    time.sleep(0.01)
    d = s.end(success=True)
    s.start()
    s.end(success=False)
    st = pk.spanstat.SpanStats()
    st.span("policy").start()
    st.span("policy").end()
    return [d > 0, s.num_success, s.num_failure, s.total() >= d, sorted(st.report())]


def test_spanstat_matches_reference():
    assert both(_spans) == [True, 1, 1, True, ["policy"]]
