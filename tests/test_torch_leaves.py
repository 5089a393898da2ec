"""The port's leaf utilities against the reference's: ``utils/lock.py``,
``utils/loadinfo.py`` and ``maps/proxymap.py``.

tests/test_lock.py's 18 cases, the loadinfo cases of
tests/test_observability.py and ``TestProxyMap`` of tests/test_maps.py
run through both packages; each scenario returns what it observed, and
the two packages' observations must be equal (tolerance 0).  The proxy
map's ``save()`` snapshots (the file the native shim reads) must be equal
byte for byte, and ``ProxyMap`` is exported from the port's ``maps``.
"""

from __future__ import annotations

import importlib
import logging
import os
import threading
import time
from types import SimpleNamespace

import pytest

from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)


def _package(pkg):
    return SimpleNamespace(name=pkg, lk=importlib.import_module(f"{pkg}.utils.lock"),
                           loadinfo=importlib.import_module(f"{pkg}.utils.loadinfo"),
                           proxymap=importlib.import_module(f"{pkg}.maps.proxymap"),
                           maps=importlib.import_module(f"{pkg}.maps"))


PKGS = {"ref": _package("cilium_tpu"), "port": _package("cilium_tpu_torch")}


def both(scenario, *args):
    out = {}
    for name, pk in PKGS.items():
        try:
            out[name] = scenario(pk, *args)
        finally:
            pk.lk.disable_debug()
    assert out["port"] == out["ref"]
    return out["ref"]


class _Records(logging.Handler):
    """The messages a package's lock logger emits at ``level`` and above."""

    def __init__(self, pk, level):
        super().__init__(level)
        self.logger = logging.getLogger(f"{pk.name}.utils.lock")
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.old = self.logger.level
        self.logger.setLevel(self.level)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.old)


def _raises_deadlock(fn):
    try:
        fn()
    except RuntimeError as e:
        return "deadlock" in str(e)
    return False


# --- tests/test_lock.py --------------------------------------------------------------


def _mutex_basic_exclusion(pk):
    m = pk.lk.Mutex("t")
    hits = []

    def worker():
        for _ in range(200):
            with m:
                hits.append(len(hits))

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return hits == list(range(800))


def _mutex_debug_self_deadlock(pk):
    pk.lk.enable_debug()
    m = pk.lk.Mutex("self")
    m.acquire()
    out = _raises_deadlock(m.acquire)
    m.release()
    return out


def _selfish(pk, make):
    pk.lk.enable_debug()
    lock = make(pk)
    with _Records(pk, logging.WARNING) as rec:
        lock.acquire()
        time.sleep(pk.lk.SELFISH_THRESHOLD + 0.05)
        lock.release()
    return any("held for" in m for m in rec.messages)


def _rwmutex_shares(pk):
    rw = pk.lk.RWMutex("rw")
    state = {"readers": 0, "max_readers": 0, "writer_in": False}
    mu = threading.Lock()
    errors = []

    def reader():
        for _ in range(50):
            with rw.read():
                with mu:
                    state["readers"] += 1
                    state["max_readers"] = max(state["max_readers"], state["readers"])
                    if state["writer_in"]:
                        errors.append("reader overlapped writer")
                time.sleep(0.0005)
                with mu:
                    state["readers"] -= 1

    def writer():
        for _ in range(20):
            with rw:
                with mu:
                    if state["readers"] or state["writer_in"]:
                        errors.append("writer overlapped")
                    state["writer_in"] = True
                time.sleep(0.0005)
                with mu:
                    state["writer_in"] = False

    ts = [threading.Thread(target=reader) for _ in range(3)] + [threading.Thread(target=writer)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return errors, state["max_readers"] >= 2


def _rwmutex_read_under_write(pk):
    pk.lk.enable_debug()
    rw = pk.lk.RWMutex("rw2")
    rw.acquire()
    out = _raises_deadlock(rw.r_acquire)
    rw.release()
    return out


def _try_lock_timeout_silent(pk):
    pk.lk.enable_debug()
    m = pk.lk.Mutex("try")
    m.acquire()
    with _Records(pk, logging.ERROR) as rec:
        t = threading.Thread(target=lambda: m.acquire(timeout=0.05))
        t.start()
        t.join()
    m.release()
    return rec.messages


def _owner_survives_toggle(pk):
    pk.lk.enable_debug()
    m = pk.lk.Mutex("toggle")
    m.acquire()
    pk.lk.disable_debug()
    m.release()
    pk.lk.enable_debug()
    got = m.acquire()
    m.release()
    return got


def _release_after_swap(pk):
    class Holder:
        def __init__(self):
            self.lock = pk.lk.Mutex("swapped")

    h = Holder()
    captured = h.lock
    captured.acquire()
    h.lock = pk.lk.Mutex("fresh")
    captured.release()
    out = [captured.acquire(timeout=0.1)]
    captured.release()
    out.append(h.lock.acquire(timeout=0.1))
    h.lock.release()
    return out


def _release_unheld(pk):
    try:
        pk.lk.Mutex("unheld").release()
    except RuntimeError:
        return "raised"
    return "no error"


def _context_releases(pk):
    m = pk.lk.Mutex("exc")
    try:
        with m:
            raise ValueError("boom")
    except ValueError:
        pass
    got = m.acquire(timeout=0.1)
    m.release()
    return got


def _timeout_keeps_owner(pk):
    m = pk.lk.Mutex("t2")
    m.acquire()
    got = []
    t = threading.Thread(target=lambda: got.append(m.acquire(timeout=0.05)))
    t.start()
    t.join()
    m.release()
    again = m.acquire(timeout=0.5)
    m.release()
    return got, again


def _debug_timeout_is_trylock(pk):
    pk.lk.enable_debug()
    m = pk.lk.Mutex("try2")
    m.acquire()
    got = m.acquire(timeout=0.05)
    m.release()
    return got


def _writer_preference(pk):
    rw = pk.lk.RWMutex("pref")
    order = []
    rw.r_acquire()
    started = threading.Event()

    def writer():
        started.set()
        rw.acquire()
        order.append("writer")
        rw.release()

    def late_reader():
        rw.r_acquire()
        order.append("reader")
        rw.r_release()

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    started.wait(1.0)
    time.sleep(0.1)
    rt = threading.Thread(target=late_reader, daemon=True)
    rt.start()
    time.sleep(0.1)
    blocked = list(order)
    rw.r_release()
    wt.join(2.0)
    rt.join(2.0)
    return blocked, order


def _writer_waits_for_readers(pk):
    rw = pk.lk.RWMutex("multi")
    rw.r_acquire()
    rw.r_acquire()
    acquired = threading.Event()

    def writer():
        rw.acquire()
        acquired.set()
        rw.release()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    rw.r_release()
    time.sleep(0.05)
    early = acquired.is_set()
    rw.r_release()
    got = acquired.wait(2.0)
    t.join(2.0)
    return early, got


def _read_guard(pk):
    rw = pk.lk.RWMutex("guard")
    with rw.read():
        with rw.read():
            pass
    acquired = threading.Event()

    def writer():
        rw.acquire()
        acquired.set()
        rw.release()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    got = acquired.wait(2.0)
    t.join(2.0)
    return got


def _write_reacquire(pk):
    pk.lk.enable_debug()
    rw = pk.lk.RWMutex("rw3")
    rw.acquire()
    out = _raises_deadlock(rw.acquire)
    rw.release()
    return out


def _toggle(pk):
    out = [pk.lk.debug_enabled()]
    pk.lk.enable_debug()
    out.append(pk.lk.debug_enabled())
    pk.lk.disable_debug()
    return out + [pk.lk.debug_enabled()]


LOCK_CASES = {
    "mutex_basic_exclusion": (_mutex_basic_exclusion, True),
    "mutex_debug_detects_self_deadlock": (_mutex_debug_self_deadlock, True),
    "mutex_debug_warns_selfish_hold": (lambda pk: _selfish(pk, lambda pk: pk.lk.Mutex("slow")), True),
    "rwmutex_readers_share_writers_exclude": (_rwmutex_shares, ([], True)),
    "rwmutex_debug_detects_read_under_write": (_rwmutex_read_under_write, True),
    "mutex_try_lock_timeout_is_not_deadlock": (_try_lock_timeout_silent, []),
    "mutex_owner_survives_debug_toggle": (_owner_survives_toggle, True),
    "mutex_release_releases_called_object_after_attribute_swap": (_release_after_swap, [True, True]),
    "mutex_release_of_unheld_lock_raises": (_release_unheld, "raised"),
    "mutex_context_manager_releases_on_exception": (_context_releases, True),
    "mutex_timeout_expiry_keeps_owner_and_exclusion": (_timeout_keeps_owner, ([False], True)),
    "mutex_debug_timeout_reacquire_is_trylock_not_deadlock": (_debug_timeout_is_trylock, False),
    "rwmutex_writer_preference_blocks_new_readers": (_writer_preference, ([], ["writer", "reader"])),
    "rwmutex_writer_waits_for_every_reader": (_writer_waits_for_readers, (False, True)),
    "rwmutex_read_guard_context_manager": (_read_guard, True),
    "rwmutex_debug_write_reacquire_raises": (_write_reacquire, True),
    "rwmutex_debug_selfish_write_hold_warns": (lambda pk: _selfish(pk, lambda pk: pk.lk.RWMutex("slow-w")), True),
    "debug_toggle_roundtrip": (_toggle, [False, True, False]),
}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_lock_case_matches_reference(case):
    scenario, want = LOCK_CASES[case]
    assert both(scenario) == want


# --- tests/test_observability.py's loadinfo cases --------------------------------------


def _system_load(pk):
    lines = []
    out = pk.loadinfo.log_current_system_load(lambda fmt, *a: lines.append(fmt % a))
    return (sorted(out), out["load"] is not None and len(out["load"]) == 3,
            out["memory"] is not None and out["memory"]["total_mb"] > 0,
            any("Load 1-min" in ln for ln in lines), any("Memory:" in ln for ln in lines))


def _periodic_ticks(pk):
    lines = []
    with pk.loadinfo.PeriodicLoadLogger(lambda fmt, *a: lines.append(fmt), interval=0.05):
        time.sleep(0.2)
    return len([ln for ln in lines if "Load" in ln]) >= 2


def _sampler_sees_self(pk):
    s = pk.loadinfo._ProcSampler()
    s.sample()
    t0 = time.monotonic()
    while time.monotonic() - t0 < 0.3:
        sum(i * i for i in range(1000))
    return os.getpid() in {pid for pid, _, _ in s.sample()}


def test_log_current_system_load_matches_reference():
    keys, load, memory, load_line, mem_line = both(_system_load)
    assert load and memory and load_line and mem_line and "load" in keys and "memory" in keys


def test_periodic_load_logger_ticks_matches_reference():
    assert both(_periodic_ticks) is True


def test_proc_sampler_sees_busy_self_matches_reference():
    assert both(_sampler_sees_self) is True


# --- TestProxyMap of tests/test_maps.py --------------------------------------------------


def _orig_dst_round_trip(pk):
    t = [0.0]
    pm = pk.proxymap.ProxyMap(clock=lambda: t[0])
    key = pk.proxymap.ProxyKey4(1, 2, 40000, 9000, 6)
    pm.create(key, orig_daddr=0x0A000005, orig_dport=80, identity=1234)
    v = pm.lookup(key)
    got = (v.orig_daddr, v.orig_dport, v.identity, v.lifetime)
    t[0] = 100000
    return got, pm.lookup(key)


def test_proxymap_orig_dst_round_trip_matches_reference():
    lifetime = PKGS["ref"].proxymap.PROXY_DEFAULT_LIFETIME
    assert both(_orig_dst_round_trip) == ((0x0A000005, 80, 1234, lifetime), None)


def _snapshot(pk, tmp_path):
    """Entries created, one expired, refreshed and collected; the saved
    snapshot's bytes, its count and the map's dump."""
    t = [1000.0]
    pm = pk.maps.ProxyMap(clock=lambda: t[0])
    K = pk.proxymap.ProxyKey4
    for i in range(12):
        pm.create(K(0x0A000000 + i, 0xC0A80001, 40000 + i, 9000 + i % 3, 6 if i % 4 else 17),
                  orig_daddr=0xAC140000 + 7 * i, orig_dport=80 + i, identity=256 + i)
    t[0] += pk.proxymap.PROXY_DEFAULT_LIFETIME - 1
    pm.lookup(K(0x0A000003, 0xC0A80001, 40003, 9000, 6))  # refreshed: outlives the rest
    t[0] += 2
    path = tmp_path / f"{pk.name}.bin"
    n = pm.save(str(path))
    gc = pm.gc()
    return n, path.read_bytes(), gc, [(vars(k), vars(v)) for k, v in pm.dump()], pm.flush()


def test_proxymap_snapshot_bytes_match_reference(tmp_path):
    n, blob, gc, dump, flushed = both(_snapshot, tmp_path)
    assert n == 1 and blob[:4] == b"CTPM" and len(blob) == 8 + 32 * n and gc == 11 and flushed == 1
    assert dump[0][1]["orig_dport"] == 83


def test_proxymap_exported_from_the_ports_maps():
    assert PKGS["port"].maps.ProxyMap is PKGS["port"].proxymap.ProxyMap
    assert "ProxyMap" in PKGS["port"].maps.__all__
    assert set(PKGS["port"].maps.__all__) == set(PKGS["ref"].maps.__all__)
