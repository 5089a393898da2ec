"""Both packages' state layers side by side, for the parity tests of
tests/test_torch_{kvstore,identity,service,endpoint,state_slice}.py.

``PKGS["ref"]`` and ``PKGS["port"]`` name each package's kvstore,
identity, ipcache, node, service, endpoint and map modules under the same
attributes (tests/state_world.py ``modules``), so one scenario body runs
on either; each test runs a scenario through both and asserts equal
outputs (tolerance 0).  The allocators pick free ids with the ``random``
module, so a scenario that compares ids seeds it first (``both(...,
seed=)``).  ``wait_for`` bounds every wait on a watcher thread.
"""

from __future__ import annotations

import random
import time

from state_world import modules


def _package(pkg, ep_kw):
    """``state_world.modules(pkg)`` and where its endpoints export their
    policy maps: the reference has one device, the port takes "cpu"."""
    ns = modules(pkg)
    ns.ep_kw = ep_kw
    return ns


PKGS = {"ref": _package("cilium_tpu", {}), "port": _package("cilium_tpu_torch", {"device": "cpu"})}


def both(scenario, *args, seed=None):
    """``scenario(pk, *args)`` through each package; asserts the two
    results are equal and returns the reference's."""
    out = {}
    for name, pk in PKGS.items():
        if seed is not None:
            random.seed(seed)
        out[name] = scenario(pk, *args)
    assert out["port"] == out["ref"]
    return out["ref"]


def wait_for(cond, timeout=3.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def label_sets(rng, n, apps=6, tiers=3):
    """``n`` distinct label-string lists drawn with a numpy generator."""
    seen, out = set(), []
    while len(out) < n:
        lbls = [f"k8s:app=a{int(rng.integers(apps))}", f"k8s:tier=t{int(rng.integers(tiers))}",
                f"k8s:ns=n{int(rng.integers(n))}"]
        key = tuple(lbls)
        if key not in seen:
            seen.add(key)
            out.append(lbls)
    return out


def ipcache_contents(m) -> dict:
    """An IpcacheMap as {prefix: (identity, tunnel endpoint)}."""
    return {k: (info.sec_label, info.tunnel_endpoint)
            for table in (m.v4, m.v6) for k, (_, info) in table.items()}


def lbmap_contents(lb) -> dict:
    """An LbMap's services and reverse-NAT tables as plain dicts."""
    def svc(d):
        return {(k.address, k.dport, k.slave): (v.target, v.port, v.count, v.rev_nat_index, v.weight)
                for k, v in d.items()}
    return {"v4": svc(lb.services), "v6": svc(lb.services6),
            "revnat": dict(lb.revnat), "revnat6": dict(lb.revnat6)}


def policymap_contents(pm) -> dict:
    """A host PolicyMap as {(identity, dport, proto, direction): proxy port}."""
    return {(k.identity, k.dest_port, k.proto, k.direction): v.proxy_port
            for k, v in pm.entries.items()}
