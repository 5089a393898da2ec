"""The port's agent surfaces (``api/server.py``, ``cli.py``, ``bugtool.py``,
``agent.py``) against the reference's.

Each package's daemon (on the CPU) serves its REST API on a unix socket;
the same CLI commands, run through each package's ``cli.main`` on the same
seeded state, must print the same standard output and exit with the same
code (tolerance 0; uptimes and timing spans are taken out first).  The
bugtool bundles must hold the same members and manifest, apart from
``device.json``, which here (no card) must report the CUDA backend with
count 0.  Then the port's ``Agent`` starts and closes with no thread, fd
or socket left behind, and without a card ``Agent(DaemonConfig())``
raises before it makes its run directory.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import re
import tarfile
import threading
import time

import pytest
import torch

from agent_cases import PKGS, agent_globals, config, wait_for  # noqa: F401 (a fixture)
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)

for _pk in PKGS.values():
    for _attr, _mod in (("cli", "cli"), ("apimod", "api"), ("bugtool", "bugtool"), ("agent", "agent")):
        setattr(_pk, _attr, importlib.import_module(f"{_pk.name}.{_mod}"))

POLICY = json.dumps([{
    "endpointSelector": {"matchLabels": {"app": "server"}},
    "labels": ["k8s:policy=web"],
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "client"}}],
                 "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                              "rules": {"http": [{"method": "GET", "path": "/public/.*"}]}}]}],
}])


def _run(pk, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pk.cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _status(text):
    return re.sub(r"uptime [0-9.]+s", "uptime Ns", text)


def _without_spans(text):
    doc = json.loads(text)
    doc.pop("spans", None)
    return doc


def _metric_names(text):
    return [ln for ln in text.splitlines() if ln.startswith("# ")]


def _bundle(path):
    with tarfile.open(path) as tar:
        names = sorted(m.name for m in tar.getmembers())
        manifest = json.load(tar.extractfile("cilium-tpu-bugtool/MANIFEST.json"))
        device = json.load(tar.extractfile("cilium-tpu-bugtool/device.json"))
        endpoints = json.load(tar.extractfile("cilium-tpu-bugtool/endpoints.json"))
    sections = {k: v["ok"] for k, v in manifest["sections"].items()}
    return names, sections, device, sorted((e["id"], e["ipv4"], e["identity"]) for e in endpoints)


def _settled(d):
    rev = d.get_policy_repository().get_revision()
    return d.build_queue.wait_idle(0.05) and all(
        ep.state.value == "ready" and ep.policy_revision >= rev for ep in d.endpoint_manager.get_endpoints())


def _settle(d):
    """Every endpoint ready at the policy's revision, and still so after
    the policy trigger's interval has passed twice."""
    for _ in range(3):
        assert wait_for(lambda: _settled(d), 10.0)
        time.sleep(0.15)
    assert _settled(d)


def _session(pk, tmp_path):
    """Every command's (exit code, normalized stdout) on ``pk``'s daemon."""
    import random

    random.seed(31)
    root = tmp_path / pk.name
    root.mkdir()
    d = pk.daemon.Daemon(config(pk, root, dry_mode=True, enable_health=False), node_name="api-node")
    srv = pk.apimod.ApiServer(d, str(root / "api.sock"))
    base = ["--socket", str(root / "api.sock")]
    out = {}
    try:
        (root / "policy.json").write_text(POLICY)

        def run(key, *argv, norm=None):
            rc, text, _ = _run(pk, base + list(argv))
            out[key] = (rc, norm(text) if norm and rc == 0 else text)
            return rc, text

        run("policy-import", "policy", "import", str(root / "policy.json"))
        run("endpoint-create-1", "endpoint", "create", "1", "--ipv4", "10.0.0.1", "-l", "k8s:app=server")
        run("endpoint-create-2", "endpoint", "create", "2", "--ipv4", "10.0.0.2", "-l", "k8s:app=client")
        _settle(d)
        server_id = d.endpoint_manager.lookup(1).security_identity.id
        run("version", "version")
        run("status", "status", norm=_status)
        run("policy-get", "policy", "get")
        run("policy-trace-allowed", "policy", "trace", "--src", "app=client", "--dst", "app=server",
            "--dport", "80/TCP")
        run("policy-trace-denied", "policy", "trace", "--src", "app=rogue", "--dst", "app=server",
            "--dport", "80/TCP")
        run("endpoint-list", "endpoint", "list")
        run("endpoint-get", "endpoint", "get", "1", norm=_without_spans)
        run("endpoint-get-missing", "endpoint", "get", "999")
        run("identity-list", "identity", "list")
        run("identity-get", "identity", "get", str(server_id))
        run("ipcache", "ipcache")
        run("map-list", "map", "list")
        for name in ("policy-1", "policy-2", "ipcache", "lb", "ct", "metrics"):
            run(f"map-get-{name}", "map", "get", name)
        rev = json.loads(_run(pk, base + ["prefilter", "list"])[1])["revision"]
        run("prefilter-update", "prefilter", "update", "--revision", str(rev), "--cidr", "198.51.100.0/24",
            "--cidr", "2001:db8::/32")
        run("prefilter-list", "prefilter", "list")
        run("prefilter-delete", "prefilter", "delete", "--revision", str(rev + 1), "--cidr", "198.51.100.0/24")
        run("service-update", "service", "update", "--id", "7", "--frontend", "10.96.0.1:80",
            "--backends", "10.0.0.1:8080,10.0.0.2:8080")
        run("service-list", "service", "list")
        run("service-get", "service", "get", "7")
        run("service-delete", "service", "delete", "7")
        run("config", "config")
        run("health", "health")
        run("node-list", "node", "list")
        run("metrics-policy", "metrics", "policy", norm=_metric_names)
        run("endpoint-regenerate", "endpoint", "regenerate", "1")
        _settle(d)
        run("bugtool", "bugtool", "-o", str(root / "bundle.tar.gz"), norm=lambda t: t.replace(str(root), "<dir>"))
        out["bundle"] = _bundle(str(root / "bundle.tar.gz"))
        run("policy-delete", "policy", "delete", "k8s:policy=web")
        run("endpoint-delete", "endpoint", "delete", "2")
        run("endpoint-list-after", "endpoint", "list")
    finally:
        srv.close()
        d.close()
    out["unreachable"] = _run(pk, ["--socket", str(root / "none.sock"), "status"])[:2]
    return out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("agent-api")
    saved = {name: (pk.option.config, pk.kvstore._default_client) for name, pk in PKGS.items()}
    try:
        return {name: _session(pk, tmp) for name, pk in PKGS.items()}
    finally:
        for name, pk in PKGS.items():
            pk.option.config, pk.kvstore._default_client = saved[name]


COMMANDS = (
    "policy-import", "endpoint-create-1", "endpoint-create-2", "version", "status", "policy-get",
    "policy-trace-allowed", "policy-trace-denied", "endpoint-list", "endpoint-get", "endpoint-get-missing",
    "identity-list", "identity-get", "ipcache", "map-list", "map-get-policy-1", "map-get-policy-2",
    "map-get-ipcache", "map-get-lb", "map-get-ct", "map-get-metrics", "prefilter-update", "prefilter-list",
    "prefilter-delete", "service-update", "service-list", "service-get", "service-delete", "config", "health",
    "node-list", "metrics-policy", "endpoint-regenerate", "bugtool", "policy-delete", "endpoint-delete",
    "endpoint-list-after", "unreachable",
)


@pytest.mark.parametrize("command", COMMANDS)
def test_cli_command_output_matches_reference(sessions, command):
    assert sessions["port"][command] == sessions["ref"][command]


def test_cli_session_exit_codes(sessions):
    ref = sessions["ref"]
    failing = {k for k in COMMANDS if ref[k][0] != 0}
    assert failing == {"policy-trace-denied", "endpoint-get-missing", "unreachable"}
    assert "Verdict: allowed" in ref["policy-trace-allowed"][1] and ref["map-get-policy-1"][1].strip() != "[]"


def test_bugtool_bundle_matches_reference_but_the_device(sessions):
    ref_names, ref_sections, _, ref_eps = sessions["ref"]["bundle"]
    names, sections, device, eps = sessions["port"]["bundle"]
    assert names == ref_names and sections == ref_sections and eps == ref_eps and all(sections.values())
    assert device == {"backend": "cuda", "device_count": 0, "devices": []}


# --- the port's Agent --------------------------------------------------------------------


def _open_fds():
    return sorted(os.listdir("/proc/self/fd"))


def test_agent_start_and_close_leave_nothing_behind(tmp_path):
    port = PKGS["port"]
    threads, fds = set(threading.enumerate()), _open_fds()
    run_dir = tmp_path / "run"
    cfg = port.option.DaemonConfig(run_dir=str(run_dir), socket_path=str(run_dir / "cilium-tpu.sock"),
                                   monitor_socket_path=str(run_dir / "monitor.sock"), verdict_device="cpu",
                                   restore_state=False)
    agent = port.agent.Agent(cfg)
    try:
        socks = sorted(f for f in os.listdir(run_dir) if f.endswith(".sock"))
        status = port.apimod.ApiClient(cfg.socket_path).get("/v1/healthz")
    finally:
        agent.close()
    assert socks == ["access_log.sock", "cilium-tpu.sock", "monitor.sock", "npds.sock"]
    assert status == {"cilium": {"state": "Ok"}} and agent.daemon.device.type == "cpu"
    assert wait_for(lambda: set(threading.enumerate()) <= threads, 10.0), set(threading.enumerate()) - threads
    assert _open_fds() == fds
    assert not [f for f in os.listdir(run_dir) if f.endswith(".sock")]


def test_agent_without_a_card_raises_before_anything(tmp_path, monkeypatch):
    port = PKGS["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []

    class _Os:  # the agent module's os, recording what it would make
        def __getattr__(self, name):
            return getattr(os, name)

        def makedirs(self, *a, **k):
            made.append(a)

    monkeypatch.setattr(port.agent, "os", _Os())
    threads, fds = set(threading.enumerate()), _open_fds()
    with pytest.raises(RuntimeError, match="CUDA device"):
        port.agent.Agent(port.option.DaemonConfig())
    assert made == [] and set(threading.enumerate()) == threads and _open_fds() == fds
