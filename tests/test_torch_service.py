"""The port's services control plane (``cilium_tpu_torch/service/``)
against the reference.

The ID-allocator and ``ServiceManager`` scenarios of
tests/test_services.py (not its daemon, k8s or REST cases) run through
both packages (tests/state_cases.py) over each package's ``LbMap``, with
frontends and backends drawn from a numpy seed; the service ids and the
LB map's services and reverse-NAT entries must be equal.  Host code only.
"""

from __future__ import annotations

import ipaddress

import numpy as np
import pytest

from policy_cases import reference_leak_guard  # noqa: F401
from state_cases import PKGS, both, lbmap_contents


def _id_allocator(pk):
    svc = pk.service
    be = pk.kvstore.LocalBackend()
    a1, a2 = svc.ServiceIDAllocator(be), svc.ServiceIDAllocator(be)
    fe, fe2 = svc.L3n4Addr("172.16.0.1", 80), svc.L3n4Addr("172.16.0.2", 80)
    id1 = a1.acquire_id(fe)
    out = [id1, a1.acquire_id(fe), a2.acquire_id(fe), a1.acquire_id(fe2), a1.get_id(id1) == fe]
    out += [a1.delete_id(id1), a1.get_id(id1), a1.delete_id(id1)]
    fe3 = svc.L3n4Addr("172.16.0.3", 80)
    out.append(a1.acquire_id(fe3, desired=7))
    for addr, want in ((fe3, 9), (svc.L3n4Addr("172.16.0.4", 80), 7)):
        try:
            a1.acquire_id(addr, desired=want)
            out.append("acquired")
        except svc.ServiceError:
            out.append("refused")
    out.append(a1.acquire_id(fe3, desired=7))
    return out


def test_service_id_allocator_matches_reference():
    out = both(_id_allocator)
    assert out[0] >= 1 and out[0] == out[1] == out[2] != out[3] and out[4]
    assert out[5:] == [True, None, False, 7, "refused", "refused", 7]


def _services(rng, n):
    """``n`` v4 frontends of 1-8 backends each."""
    out = []
    for i in range(n):
        fe = (f"172.16.{i // 250}.{i % 250 + 1}", int(rng.choice([80, 443, 8080])))
        bes = [(f"10.{int(a)}.{int(b)}.{int(c)}", int(p))
               for a, b, c, p in zip(*rng.integers(1, 250, (3, int(rng.integers(1, 9)))),
                                     rng.choice([8080, 9090], 8))]
        out.append((fe, bes))
    return out


def _manager(pk, services, drop, rebackend):
    svc = pk.service
    lb = pk.lbmap.LbMap()
    mgr = svc.ServiceManager(lb, pk.kvstore.LocalBackend())

    def addr(a):
        return svc.L3n4Addr(*a)

    ids = [mgr.upsert(addr(fe), [addr(b) for b in bes]) for fe, bes in services]
    out = [ids, lbmap_contents(lb)]
    # backends updated in place, frontends deleted by id and by address
    for i in rebackend:
        fe, bes = services[i]
        out.append(mgr.upsert(addr(fe), [addr(b) for b in bes[:1]]))
    for i in drop[::2]:
        out.append(mgr.delete_by_id(ids[i][0]))
    for i in drop[1::2]:
        out.append(mgr.delete_by_frontend(addr(services[i][0])))
    out.append(mgr.delete_by_id(ids[drop[0]][0]))
    out.append(lbmap_contents(lb))
    out.append([s.to_model() for s in mgr.list()])
    # a resync onto a desired set missing a few and holding a new frontend
    desired = [(addr(fe), [addr(b) for b in bes]) for fe, bes in services[::3]]
    desired.append((svc.L3n4Addr("172.16.9.9", 443), [svc.L3n4Addr("10.0.4.4", 8443)]))
    out.append(mgr.resync(desired))
    out.append(mgr.resync(desired))
    out.append(lbmap_contents(lb))
    # a protocol-only collision is refused, v6 lives in its own table
    fe = services[0][0]
    try:
        mgr.upsert(svc.L3n4Addr(fe[0], fe[1], "UDP"), [svc.L3n4Addr("10.1.0.2", 53)])
        out.append("collided")
    except svc.ServiceError:
        out.append("refused")
    fe6 = svc.L3n4Addr("fd00::1", 443)
    sid6, _ = mgr.upsert(fe6, [svc.L3n4Addr("fd00::10", 8443)])
    out.append(lbmap_contents(lb)["v6"])
    try:
        mgr.upsert(svc.L3n4Addr("172.16.0.1", 80), [svc.L3n4Addr("fd00::10", 8443)])
        out.append("mixed")
    except svc.ServiceError:
        out.append("refused")
    out += [mgr.delete_by_frontend(fe6), lbmap_contents(lb)["v6"], len(mgr)]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_service_manager_matches_reference(seed):
    rng = np.random.default_rng(seed)
    services = _services(rng, 40)
    drop = sorted(rng.choice(40, 6, replace=False).tolist())
    rebackend = sorted(rng.choice(40, 4, replace=False).tolist())
    out = both(_manager, services, drop, rebackend, seed=seed)
    ids, contents = out[0], out[1]
    assert len({i for i, _ in ids}) == 40 and all(created for _, created in ids)
    vip = int(ipaddress.IPv4Address(services[0][0][0]))
    assert contents["v4"][(vip, services[0][0][1], 0)][2] == len(services[0][1])
    assert contents["revnat"][ids[0][0]] == (vip, services[0][0][1])
    assert out[-6] == "refused" and out[-4] == "refused" and out[-2] == {}
