"""bugtool: one-shot support-bundle collector.

reference: bugtool/cmd/root.go:159 — archives the agent's observable
state (CLI dumps, BPF map dumps, system state, logs) into a tar for
support triage.  REST sections come over the agent's API exactly like
an operator's CLI would; NATIVE sections capture state outside the
agent (the reference's tc/ip/bpffs dumps): the accelerator platform
(the CUDA devices torch sees), the verdict service's live counters over its own wire,
the kvstore failure counters, CNI interface provisioning records, and
the latest BENCH/MULTICHIP artifacts from the repo root.  Unreachable
sections are recorded as errors instead of aborting the bundle (the
reference likewise continues past failing commands).
"""

from __future__ import annotations

import glob
import io
import json
import os
import tarfile
import time

# Route table: archive member name -> REST route.
SECTIONS = [
    ("status.json", "/v1/status"),
    ("config.json", "/v1/config"),
    ("policy.json", "/v1/policy"),
    ("endpoints.json", "/v1/endpoint"),
    ("identities.json", "/v1/identity"),
    ("ipcache.json", "/v1/ipcache"),
    ("maps.json", "/v1/map"),
    ("prefilter.json", "/v1/prefilter"),
    ("metrics.txt", "/metrics"),
    ("monitor-tail.json", "/v1/monitor/recent"),
    ("health.json", "/v1/health"),
]


def _device_section() -> dict:
    """Accelerator platform state (the reference's analog: the node's
    tc/ip device dumps — here the cards the verdict engines run on).
    A node with no card reports a count of 0; the CPU is never reported
    as the device."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = []
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        devices.append({
            "index": i,
            "name": torch.cuda.get_device_name(i),
            "capability": list(torch.cuda.get_device_capability(i)),
            "total_memory": int(props.total_memory),
        })
    return {
        "backend": "cuda",
        "device_count": n,
        "devices": devices,
    }


def _verdict_service_section(socket_path: str) -> dict:
    """Live verdict-service counters over its own wire (the shim/Envoy
    admin-state analog)."""
    from .sidecar.client import SidecarClient

    cl = SidecarClient(socket_path, timeout=5.0)
    try:
        return cl.status()
    finally:
        cl.close()


def _artifact_files(repo_root: str) -> list[str]:
    """Latest BENCH_r*/MULTICHIP_r* paths — the perf state of the
    node's engines at bundle time (read via record() so an unreadable
    artifact degrades to an error member, not an aborted bundle)."""
    out = []
    for pattern in ("BENCH_r*.json", "MULTICHIP_r*.json"):
        files = sorted(glob.glob(os.path.join(repo_root, pattern)))
        if files:
            out.append(files[-1])
    return out


def collect(
    client,
    out_path: str,
    verdict_socket: str | None = None,
    cni=None,
    repo_root: str | None = None,
    kvstore=None,
) -> dict:
    """Collect every section through ``client`` (ApiClient) plus the
    native/device sections into a gzipped tar at ``out_path``; returns
    a summary manifest."""
    manifest = {
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "sections": {},
    }

    def record(name: str, fn) -> bytes:
        try:
            data = fn()
            if isinstance(data, (dict, list)):
                blob = json.dumps(data, indent=2, default=str).encode()
            elif isinstance(data, bytes):
                blob = data
            else:
                blob = str(data).encode()
            manifest["sections"][name] = {"ok": True, "bytes": len(blob)}
        except Exception as e:  # noqa: BLE001 — best-effort bundle
            blob = f"ERROR collecting {name}: {e}\n".encode()
            manifest["sections"][name] = {"ok": False, "error": str(e)}
        return blob

    with tarfile.open(out_path, "w:gz") as tar:
        for name, route in SECTIONS:
            _add_member(tar, name, record(name, lambda r=route: client.get(r)))
        # Native/device sections (bugtool/cmd/root.go's beyond-the-agent
        # captures).
        _add_member(tar, "device.json", record("device.json", _device_section))
        _add_member(
            tar, "kvstore-counters.json",
            record(
                "kvstore-counters.json",
                lambda: (
                    kvstore.counters.snapshot()
                    if kvstore is not None
                    and hasattr(kvstore, "counters")
                    else {}
                ),
            ),
        )
        if verdict_socket:
            _add_member(
                tar, "verdict-service.json",
                record(
                    "verdict-service.json",
                    lambda: _verdict_service_section(verdict_socket),
                ),
            )
        if cni is not None:
            _add_member(
                tar, "cni-interfaces.json",
                record(
                    "cni-interfaces.json",
                    lambda: {
                        cid: vars(v)
                        for cid, v in cni.interfaces_all().items()
                    },
                ),
            )
        for fname in _artifact_files(repo_root or "."):
            base = os.path.basename(fname)
            _add_member(
                tar, f"artifacts/{base}",
                record(f"artifacts/{base}",
                       lambda f=fname: open(f, "rb").read()),
            )
        _add_member(
            tar, "MANIFEST.json",
            json.dumps(manifest, indent=2).encode(),
        )
    return manifest




def _add_member(tar: tarfile.TarFile, name: str, blob: bytes) -> None:
    info = tarfile.TarInfo(name=f"cilium-tpu-bugtool/{name}")
    info.size = len(blob)
    info.mtime = int(time.time())
    tar.addfile(info, io.BytesIO(blob))
