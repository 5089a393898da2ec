"""The port's clustermesh (``cilium_tpu_torch/clustermesh.py``) against
the reference's.

tests/test_kvstore_net.py::TestClusterMesh::test_remote_cluster_merge_and_purge's
scenario runs through both packages (tests/agent_cases.py): cluster B's
daemon (the port's on the CPU) publishes endpoint IPs to its kvstore
server; cluster A's ``ClusterMesh`` connects to it from a config file,
merges B's IPs and nodes into A's ipcache, and purges them when the file
goes.  The seeded identity ids, A's ipcache at each step and the mesh's
status must be equal.
"""

from __future__ import annotations

import json
import os

from agent_cases import agent_globals, both, config, wait_for  # noqa: F401 (a fixture)
from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)


def _merge_and_purge(pk, tmp_path):
    srv = pk.kvstore.KvstoreServer()
    root = tmp_path / pk.name
    db = pk.daemon.Daemon(config(pk, root / "b", dry_mode=True, kvstore="tcp",
                                 kvstore_opts={"address": srv.address}, cluster_name="cluster-b",
                                 node_ipv4="192.168.30.2"), node_name="b0")
    cache_a = pk.ipcache.IPIdentityCache("cluster-a")
    cfg_dir = str(root / "mesh")
    mesh = pk.clustermesh.ClusterMesh(cfg_dir, cache_a, interval=0.05)
    try:
        with open(f"{cfg_dir}/cluster-b", "w") as f:
            json.dump({"address": srv.address}, f)
        ids = {}
        for i, app in enumerate(("remote", "other", "remote")):
            ep = db.endpoint_create(31 + i, ipv4=f"10.60.0.{31 + i}", labels=[f"k8s:app={app}"])
            ids[ep.ipv4] = ep.security_identity.id
        merged = wait_for(lambda: all(cache_a.lookup_by_ip(ip) == n for ip, n in ids.items()), 5)
        wait_for(lambda: mesh.status() and mesh.status()[0]["nodes"] >= 1, 5)
        (st,) = mesh.status()
        seen = {ip: cache_a.lookup_by_ip(ip) for ip in sorted(ids)}
        db.endpoint_delete(32)
        gone = wait_for(lambda: cache_a.lookup_by_ip("10.60.0.32") is None, 5)
        os.unlink(f"{cfg_dir}/cluster-b")
        purged = wait_for(lambda: all(cache_a.lookup_by_ip(ip) is None for ip in ids), 5)
        return (merged, seen, sorted(ids.values()), (st["name"], st["connected"], st["nodes"], st["ips"]),
                gone, purged, mesh.num_connected(), mesh.status())
    finally:
        mesh.close()
        db.close()
        srv.close()


def test_remote_cluster_merge_and_purge_matches_reference(tmp_path):
    merged, seen, idents, st, gone, purged, n_connected, status = both(_merge_and_purge, tmp_path, seed=22)
    assert merged and gone and purged
    assert seen["10.60.0.31"] == seen["10.60.0.33"] != seen["10.60.0.32"]
    assert st == ("cluster-b", True, 1, 3)
    assert n_connected == 0 and status == []
