"""Both packages' agents side by side, for the parity tests of
tests/test_torch_{control_utils,distribution,health_fqdn,clustermesh,daemon}.py.

``PKGS["ref"]`` and ``PKGS["port"]`` name each package's agent modules
(the daemon, its controllers, triggers, completions, distribution cache,
access log, health, FQDN poller, clustermesh and what they drive) under the
same attributes, so one scenario body runs on either; ``both`` runs it
through each and asserts equal outputs (tolerance 0).  The port's daemon
and endpoints run at ``verdict_device="cpu"`` / ``device="cpu"``
(``cfg_kw``, ``ep_kw``).  The allocators pick free ids with the ``random``
module, so a scenario that compares ids seeds it first (``both(...,
seed=)``).  ``agent_globals`` puts back what a daemon sets process-wide.
"""

from __future__ import annotations

import importlib
import random
import time
from types import SimpleNamespace

import pytest

SUBMODULES = {
    "completion": "utils.completion", "controller": "utils.controller", "trigger": "utils.trigger",
    "revert": "utils.revert", "option": "utils.option", "metrics": "utils.metrics",
    "accesslog": "accesslog", "distribution": "distribution", "sock": "distribution.sock",
    "health": "health", "fqdn": "fqdn", "clustermesh": "clustermesh", "daemon": "daemon",
    "policy": "policy", "api": "policy.api", "repository": "policy.repository", "labels": "labels",
    "endpoint": "endpoint", "identity": "identity", "kvstore": "kvstore", "ipcache": "ipcache",
    "policymap": "maps.policymap", "npds_push": "proxy.npds_push", "instance": "proxylib.instance",
    "http_parser": "proxylib.parsers.http", "types": "proxylib.types",
}


def _package(pkg, cfg_kw, ep_kw):
    ns = SimpleNamespace(name=pkg, **{k: importlib.import_module(f"{pkg}.{v}") for k, v in SUBMODULES.items()})
    ns.cfg_kw, ns.ep_kw = cfg_kw, ep_kw
    return ns


PKGS = {"ref": _package("cilium_tpu", {}, {}),
        "port": _package("cilium_tpu_torch", {"verdict_device": "cpu"}, {"device": "cpu"})}


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


def wait_for(cond, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def config(pk, tmp_path, **kw):
    """A ``DaemonConfig`` of ``pk`` under ``tmp_path`` (the port's on the
    CPU)."""
    return pk.option.DaemonConfig(run_dir=str(tmp_path), socket_path=str(tmp_path / "agent.sock"),
                                  monitor_socket_path=str(tmp_path / "monitor.sock"), **pk.cfg_kw, **kw)


@pytest.fixture(autouse=True)
def agent_globals():
    """A daemon installs its config as ``option.config`` and its store as
    the kvstore client, process-wide: put back each package's, and the
    default enforcement mode, after every test of a module that imports
    this fixture."""
    saved = {name: (pk.option.config, pk.kvstore._default_client) for name, pk in PKGS.items()}
    for pk in PKGS.values():
        pk.policy.set_policy_enabled("default")
    yield
    for name, pk in PKGS.items():
        pk.option.config, pk.kvstore._default_client = saved[name]
        pk.policy.set_policy_enabled("default")
