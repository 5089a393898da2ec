"""The port's kvstore (``cilium_tpu_torch/kvstore/``) against the reference.

Each test runs one scenario, drawn from tests/test_kvstore_identity.py's
backend, allocator and shared-store cases and tests/test_kvstore_net.py's
TCP-backend cases, through both packages (tests/state_cases.py) and
asserts equal results; the scenarios assert the reference tests' own
properties too.  Allocated ids are compared with the ``random`` module
seeded alike and keys drawn from a numpy seed.  One wire test puts a port
``NetBackend`` and a reference one on one server: their identity
allocators agree.  Host code only; every wait has its own timeout.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from policy_cases import reference_leak_guard  # noqa: F401
from state_cases import PKGS, both, label_sets, wait_for


# --- the in-process backends ---------------------------------------------------


def _local_contract(pk):
    kv = pk.kvstore
    b = kv.LocalBackend()
    out = [b.get("k")]
    b.set("a/k1", b"v1")
    b.set("a/k2", b"v2")
    out += [b.get("a/k1"), b.get_prefix("a/"), sorted(b.list_prefix("a/"))]
    b.delete("a/k1")
    out.append(b.get("a/k1"))
    b.delete_prefix("a/")
    out.append(b.list_prefix("a/"))
    out += [b.create_only("c", b"1"), b.create_only("c", b"2"), b.get("c")]
    out += [b.create_if_exists("cond", "k", b"v")]
    b.set("cond", b"x")
    out += [b.create_if_exists("cond", "k", b"v"), b.get("k")]
    b.set("p/a", b"1")
    w = b.list_and_watch("t", "p/")
    evs = [w.next_event(1), w.next_event(1)]
    b.set("p/b", b"2")
    b.delete("p/b")
    evs += [w.next_event(1), w.next_event(1)]
    b.set("q/x", b"3")
    evs.append(w.next_event(0.05))
    w.stop()
    out.append([None if e is None else (e.typ.name, e.key) for e in evs])
    l1 = b.lock_path("x")
    try:
        b.lock_path("x", timeout=0.05)
        out.append("locked twice")
    except kv.KvstoreError:
        out.append("exclusive")
    l1.unlock()
    b.lock_path("x", timeout=0.5).unlock()
    b.set("leased", b"1", lease=True)
    b.set("durable", b"2")
    b.close()
    out += [b.get("leased"), b.get("durable")]
    return out


def test_local_backend_contract_matches_reference():
    out = both(_local_contract)
    assert out[-3] == "exclusive" and out[-2:] == [None, b"2"]
    assert out[-4] == [("CREATE", "p/a"), ("LIST_DONE", ""), ("CREATE", "p/b"), ("DELETE", "p/b"), None]


def _file_persists(pk, path):
    b1 = pk.kvstore.FileBackend(path)
    b1.set("persist/me", b"hello")
    b1.set("lease/me", b"bye", lease=True)
    b1._persist()
    b2 = pk.kvstore.FileBackend(path)
    return [b2.get("persist/me"), b2.get("lease/me")]


def test_file_backend_persists_like_reference(tmp_path):
    got = {name: _file_persists(pk, str(tmp_path / f"{name}.json")) for name, pk in PKGS.items()}
    assert got["port"] == got["ref"] == [b"hello", None]


# --- the allocator -------------------------------------------------------------------


def _allocator_rounds(pk, keys):
    """Allocate, reuse, refcount, release, GC and reallocate ``keys``
    over one LocalBackend with two nodes; every id and state observed."""
    b = pk.kvstore.LocalBackend()
    a1 = pk.allocator.Allocator(b, "test/ids", "node1", min_id=10, max_id=1000)
    a2 = pk.allocator.Allocator(b, "test/ids", "node2", min_id=10, max_id=1000)
    out = [a1.allocate(k) for k in keys]
    out += [a1.allocate(k) for k in keys[::3]]
    out += [a2.allocate(k) for k in keys[::2]]
    out += [a1.release(k) for k in keys[::3]]
    out.append(sorted(b.list_prefix(a1._value_prefix(keys[0]) + "/")))
    out += [a1.release(k) for k in keys]
    out += [a2.release(k) for k in keys[::2]]
    out.append(a1.run_gc())
    out += [a1.allocate(k) for k in keys[:5]]
    # a restarted node reads the store and reuses, not reallocates
    a3 = pk.allocator.Allocator(b, "test/ids", "node1-restarted", min_id=10, max_id=1000)
    out += [a3.get_by_id(i) for i, _ in out[-5:]]
    out += [a3.allocate(k) for k in keys[:5]]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_ids_match_reference(seed):
    rng = np.random.default_rng(seed)
    keys = [";".join(lbls) for lbls in label_sets(rng, 24)]
    out = both(_allocator_rounds, keys, seed=seed)
    n = len(keys)
    ids = [i for i, _ in out[:n]]
    assert len(set(ids)) == n and all(10 <= i <= 1000 for i in ids)
    assert all(not new for _, new in out[n: n + len(keys[::3]) + len(keys[::2])])


def _exhaustion_and_watch(pk):
    kv, alloc = pk.kvstore, pk.allocator
    a = alloc.Allocator(kv.LocalBackend(), "test/ids", "n", min_id=1, max_id=2)
    out = [a.allocate("x"), a.allocate("y")]
    try:
        a.allocate("z")
        out.append("allocated past the pool")
    except alloc.AllocatorError:
        out.append("exhausted")
    b = kv.LocalBackend()
    a1 = alloc.Allocator(b, "test/ids", "node1", min_id=10, max_id=99)
    a1.start_watch()
    a2 = alloc.Allocator(b, "test/ids", "node2", min_id=10, max_id=99)
    id_, _ = a2.allocate("remote-key")
    out.append(wait_for(lambda: a1.get_by_id(id_) == "remote-key"))
    a1.stop_watch()
    return out


def test_allocator_exhaustion_and_watch_match_reference():
    out = both(_exhaustion_and_watch, seed=3)
    assert out[2:] == ["exhausted", True]


def _shared_store(pk):
    b = pk.kvstore.LocalBackend()
    seen = {}
    s1 = pk.store.SharedStore(b, "test/store", "n1")
    s2 = pk.store.SharedStore(b, "test/store", "n2", on_update=lambda n, v: seen.update({n: v}))
    s1.update_local_key_sync("n1", {"x": 1})
    out = [wait_for(lambda: s2.get("n1") == {"x": 1}), dict(seen)]
    s1.delete_local_key("n1")
    out.append(wait_for(lambda: s2.get("n1") is None))
    s1.close()
    s2.close()
    return out


def test_shared_store_sync_matches_reference():
    assert both(_shared_store) == [True, {"n1": {"x": 1}}, True]


# --- the TCP backend -----------------------------------------------------------------


def _on_server(pk, body):
    """``body(server, client, connect)`` against one of ``pk``'s servers;
    every client and the server closed after."""
    kv = pk.kvstore
    srv = kv.KvstoreServer()
    clients = []

    def connect():
        c = kv.NetBackend(srv.address, timeout=5.0)
        clients.append(c)
        return c

    try:
        return body(kv, srv, connect(), connect)
    finally:
        for c in clients:
            c.close()
        srv.close()


def _drain(w, typ, key, timeout=3.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ev = w.next_event(timeout=0.2)
        if ev is not None and ev.typ == typ and ev.key == key:
            return True
    return False


def _net_crud_cas_watch(kv, srv, client, connect):
    out = [client.get("a/b")]
    client.set("a/b", b"v1")
    client.set("a/c", b"v2")
    out += [client.get("a/b"), client.list_prefix("a/"), client.get_prefix("a/")]
    client.delete("a/b")
    client.delete_prefix("a/")
    out += [client.get("a/b"), client.list_prefix("a/")]
    c2 = connect()
    out += [client.create_only("id/5", b"x"), c2.create_only("id/5", b"y"), client.get("id/5"),
            c2.create_if_exists("id/5", "val/5/n2", b"1"),
            c2.create_if_exists("id/9", "val/9/n2", b"1")]
    client.set("w/a", b"1")
    w = c2.list_and_watch("t", "w/")
    first = w.next_event(timeout=2)
    out += [(first.typ.name, first.key), w.next_event(timeout=2).typ.name]
    client.set("w/b", b"2")
    out.append(_drain(w, kv.EventType.CREATE, "w/b"))
    client.delete("w/b")
    out.append(_drain(w, kv.EventType.DELETE, "w/b"))
    w.stop()
    out.append("connected" in client.status())
    return out


def test_net_backend_crud_cas_watch_match_reference():
    out = both(lambda pk: _on_server(pk, _net_crud_cas_watch))
    assert out[-5:] == [("CREATE", "w/a"), "LIST_DONE", True, True, True]


def _net_locks_and_leases(kv, srv, client, connect):
    out = []
    c2 = connect()
    lock = client.lock_path("locks/x", timeout=1.0)
    try:
        c2.lock_path("locks/x", timeout=0.3)
        out.append("locked twice")
    except kv.LockError:
        out.append("exclusive")
    lock.unlock()
    c2.lock_path("locks/x", timeout=2.0).unlock()
    c3 = connect()
    c3.set("lease/k", b"v", lease=True)
    c3.set("plain/k", b"v")
    w = client.list_and_watch("t", "lease/")
    out.append(_drain(w, kv.EventType.CREATE, "lease/k"))
    c3.lock_path("locks/dead", timeout=1.0)
    c3.close()
    out.append(_drain(w, kv.EventType.DELETE, "lease/k"))
    w.stop()
    out += [client.get("lease/k"), client.get("plain/k")]
    deadline, freed = time.monotonic() + 3, False
    while not freed and time.monotonic() < deadline:
        try:
            client.lock_path("locks/dead", timeout=0.3).unlock()
            freed = True
        except kv.LockError:
            pass
    out.append(freed)
    # the latest PUT's lease wins; a plain PUT detaches a lease
    c_old, c_new = connect(), connect()
    c_old.set("nodes/A", b"v1", lease=True)
    c_new.set("nodes/A", b"v2", lease=True)
    c_old.set("cfg/x", b"v1", lease=True)
    client.set("cfg/x", b"v2")
    c_old.close()
    time.sleep(0.3)
    out += [client.get("nodes/A"), client.get("cfg/x")]
    c_new.close()
    out.append(wait_for(lambda: client.get("nodes/A") is None))
    return out


def test_net_backend_locks_and_leases_match_reference():
    out = both(lambda pk: _on_server(pk, _net_locks_and_leases))
    assert out == ["exclusive", True, True, None, b"v", True, b"v2", b"v2", True]


def test_port_and_reference_clients_agree_on_one_server():
    """The wire: a port NetBackend and a reference NetBackend on one
    server (the port's), each under its package's IdentityAllocator, take
    overlapping label sets; both get one id a label set, and each learns
    the other's allocations through its watch."""
    ref, port = PKGS["ref"], PKGS["port"]
    sets = label_sets(np.random.default_rng(11), 12)
    srv = port.kvstore.KvstoreServer()
    backends = []
    try:
        backends = [ref.kvstore.NetBackend(srv.address, timeout=5.0),
                    port.kvstore.NetBackend(srv.address, timeout=5.0)]
        allocs = [ref.identity.IdentityAllocator(backend=backends[0], node_name="ref"),
                  port.identity.IdentityAllocator(backend=backends[1], node_name="port")]
        ids = [{}, {}]
        for k, (pk, alloc) in enumerate(zip((ref, port), allocs)):
            for lbls in (sets[:8] if k == 0 else sets[4:]):
                ids[k][tuple(lbls)] = alloc.allocate(pk.labels.Labels.from_model(lbls))[0].id
        both_ids = set(ids[0]) & set(ids[1])
        assert len(both_ids) == 4 and all(ids[0][k] == ids[1][k] for k in both_ids)

        def cache(alloc):
            return {i: sorted(lbls.get_model()) for i, lbls in alloc.get_identity_cache().items()}

        assert wait_for(lambda: cache(allocs[0]) == cache(allocs[1]), timeout=5.0)
        assert len({**ids[0], **ids[1]}) == len(set(ids[0].values()) | set(ids[1].values())) == 12
        for alloc in allocs:
            alloc.close()
    finally:
        for b in backends:
            b.close()
        srv.close()


# --- the launcher --------------------------------------------------------------------

_REPO = Path(__file__).resolve().parent.parent
_LAUNCHERS = {"ref": [str(_REPO / "bin" / "cilium-tpu-kvstore")], "port": ["-m", "cilium_tpu_torch.kvstore"]}


def _launch(name, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(_REPO))
    proc = subprocess.Popen([sys.executable, *_LAUNCHERS[name], "--port", "0", *argv], cwd=_REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()  # "kvstore <role> serving on host:port"
    if "serving on" not in line:
        proc.kill()
        raise AssertionError(f"{name} launcher: {line!r} {proc.communicate(timeout=30)}")
    return proc, line.split()[-1]


def _launcher_roundtrip(name):
    procs, b = [], None
    try:
        primary, addr = _launch(name)
        procs.append(primary)
        follower, faddr = _launch(name, "--follow", addr)
        procs.append(follower)
        b = PKGS["port"].kvstore.NetBackend(addr, timeout=5.0)
        b.set("cluster/k", b"v1")
        f = PKGS["port"].kvstore.NetBackend(faddr, timeout=5.0)
        try:
            assert wait_for(lambda: f.get("cluster/k") == b"v1", timeout=10.0)
            got = f.get("cluster/k")
        finally:
            f.close()
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(30) for p in reversed(procs)]
        return got, rcs
    finally:
        if b is not None:
            b.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_launcher_primary_and_follower(name):
    """``bin/cilium-tpu-kvstore`` and ``python -m cilium_tpu_torch.kvstore``
    with the same flags: a primary and a ``--follow`` replica as processes,
    a key written to the primary read back from the follower, and both
    stopping on SIGTERM with exit code 0."""
    assert _launcher_roundtrip(name) == (b"v1", [0, 0])
