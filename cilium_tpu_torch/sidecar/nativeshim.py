"""The native C++ shim (``native/shim.cc``) as the port's verdict service
sees it: built from the checkout, bound through ctypes, and run as shim
processes.

The shim is the Envoy side of the seam (the reference's consumer of
``proxylib/libcilium.h``): each pod's proxy loads it, opens a module on
the service's socket and pushes its policy, registers connections
(``cilium_tpu_on_new_connection`` or ``cilium_tpu_accept``) and runs
``cilium_tpu_on_io`` for every read, both directions.  Production runs N
shim processes against one service.

- ``build_shim`` builds ``native/build/libcilium_tpu_shim.so`` with
  ``make -C native`` (or the Makefile's own ``g++`` line where ``make``
  is missing) and raises if the build fails.
- ``Shim`` binds the C ABI; ``OnIoMirror`` is ``cilium_tpu_on_io``'s
  buffer contract in Python, so the forwarded bytes and the access-log
  verdicts of a call follow from a host oracle's ops and injects.
- Run as a script, this file is one shim process::

      python cilium_tpu_torch/sidecar/nativeshim.py

  It reads job files from its standard input, one path a line, and
  answers each line with ``done <path>`` once ``<path>.out`` holds the
  result (see ``ShimProcess.run_job``).  A ``drive`` job that names ``pause_after``
  prints ``pause`` after that round and waits for a ``go`` line.  It
  uses the standard library only, so a shim process starts without
  torch.
"""

from __future__ import annotations

import base64
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SHIM_SO = NATIVE_DIR / "build" / "libcilium_tpu_shim.so"

OK = 0
MORE, PASS, DROP, INJECT = 0, 1, 2, 3
OUT_CAP = 1 << 20  # one on_io's forwarded bytes and injects, one on_data's injects
MAX_OPS = 4096  # one on_data's ops


def build_shim(build_dir: Path | None = None) -> Path:
    """Build the shim from ``native/``'s sources into ``build_dir``
    (default ``native/build``), every time; returns the library's path.
    Raises ``RuntimeError`` with the compiler's output if the build
    fails."""
    native_dir = NATIVE_DIR
    build_dir = Path(build_dir or native_dir / "build").resolve()
    so = build_dir / "libcilium_tpu_shim.so"
    if shutil.which("make"):
        cmd = ["make", "-B", "-C", str(native_dir), f"BUILD={build_dir}"]
    else:  # the Makefile's own line
        so.parent.mkdir(parents=True, exist_ok=True)
        cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
               str(native_dir / "shim.cc"), "-o", str(so)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or not so.exists():
        raise RuntimeError(f"native shim build failed ({' '.join(cmd)}): "
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return so


class FilterOp(ctypes.Structure):
    _fields_ = [("op", ctypes.c_uint64), ("n_bytes", ctypes.c_int64)]


_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_SIGNATURES = {
    "cilium_tpu_open": (ctypes.c_uint64, [ctypes.c_char_p, ctypes.c_uint8]),
    "cilium_tpu_close_module": (None, [ctypes.c_uint64]),
    "cilium_tpu_policy_update_json": (ctypes.c_uint32, [ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t]),
    "cilium_tpu_on_new_connection": (ctypes.c_uint32, [
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint8, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]),
    "cilium_tpu_on_io": (ctypes.c_uint32, [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_char_p,
        ctypes.c_int64, _U8P, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]),
    "cilium_tpu_on_data": (ctypes.c_uint32, [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_char_p,
        ctypes.c_int64, ctypes.POINTER(FilterOp), ctypes.POINTER(ctypes.c_int32), _U8P,
        ctypes.POINTER(ctypes.c_int64), _U8P, ctypes.POINTER(ctypes.c_int64)]),
    "cilium_tpu_close_connection": (None, [ctypes.c_uint64, ctypes.c_uint64]),
    "cilium_tpu_accesslog_open": (ctypes.c_uint64, [ctypes.c_char_p]),
    "cilium_tpu_accesslog_close": (None, [ctypes.c_uint64]),
    "cilium_tpu_set_accesslog": (None, [ctypes.c_uint64, ctypes.c_uint64]),
    "cilium_tpu_proxymap_open": (ctypes.c_uint64, [ctypes.c_char_p]),
    "cilium_tpu_proxymap_close": (None, [ctypes.c_uint64]),
    "cilium_tpu_hostmap_open": (ctypes.c_uint64, [ctypes.c_char_p]),
    "cilium_tpu_hostmap_lookup": (ctypes.c_uint32, [ctypes.c_uint64, ctypes.c_uint32, _U32P, _U32P]),
    "cilium_tpu_hostmap_close": (None, [ctypes.c_uint64]),
    "cilium_tpu_accept": (ctypes.c_uint32, [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint8, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint16, ctypes.c_uint16,
        ctypes.c_uint8, ctypes.c_char_p, _U32P, _U32P, _U32P, _U32P]),
}


class Shim:
    """The shim's C ABI, one library a process.  Not thread-safe: ``on_io``
    reuses one output buffer."""

    def __init__(self, path=SHIM_SO):
        self.lib = ctypes.CDLL(str(path))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.restype, fn.argtypes = res, args
        self._out = (ctypes.c_uint8 * OUT_CAP)()
        self._out_len = ctypes.c_int64(0)

    def open(self, socket_path: str, policy_json: bytes) -> int:
        """A module on the service's socket, its policy pushed."""
        mod = self.lib.cilium_tpu_open(socket_path.encode(), 1)
        if not mod:
            raise ConnectionError(f"cilium_tpu_open({socket_path!r}) failed")
        res = self.lib.cilium_tpu_policy_update_json(mod, policy_json, len(policy_json))
        if res != OK:
            raise RuntimeError(f"cilium_tpu_policy_update_json: result {res}")
        return mod

    def close(self, mod: int) -> None:
        self.lib.cilium_tpu_close_module(mod)

    def new_connection(self, mod, proto, conn_id, src_id, dst_id, src_addr, dst_addr, policy) -> int:
        """Register an ingress conn; returns its result."""
        return self.lib.cilium_tpu_on_new_connection(
            mod, proto.encode(), conn_id, 1, src_id, dst_id, src_addr.encode(), dst_addr.encode(),
            policy.encode())

    def close_connection(self, mod, conn_id) -> None:
        self.lib.cilium_tpu_close_connection(mod, conn_id)

    def on_io(self, mod, conn_id, reply, data: bytes) -> tuple[int, bytes]:
        """One read of one direction: (result, the bytes to forward)."""
        res = self.lib.cilium_tpu_on_io(mod, conn_id, int(reply), 0, data, len(data),
                                        self._out, OUT_CAP, ctypes.byref(self._out_len))
        return res, ctypes.string_at(self._out, self._out_len.value)

    def on_data(self, mod, conn_id, reply, data: bytes) -> tuple[int, list, bytes, bytes]:
        """The raw OnData ABI: (result, [(op, n)], orig inject, reply inject)."""
        ops = (FilterOp * MAX_OPS)()
        n_ops = ctypes.c_int32(MAX_OPS)
        bufs = [(ctypes.c_uint8 * OUT_CAP)() for _ in range(2)]
        lens = [ctypes.c_int64(OUT_CAP) for _ in range(2)]
        res = self.lib.cilium_tpu_on_data(
            mod, conn_id, int(reply), 0, data, len(data), ops, ctypes.byref(n_ops),
            bufs[0], ctypes.byref(lens[0]), bufs[1], ctypes.byref(lens[1]))
        return (res, [(ops[i].op, ops[i].n_bytes) for i in range(n_ops.value)],
                ctypes.string_at(bufs[0], lens[0].value), ctypes.string_at(bufs[1], lens[1].value))

    def accesslog_open(self, path: str) -> int:
        return self.lib.cilium_tpu_accesslog_open(path.encode())

    def accesslog_close(self, handle: int) -> None:
        self.lib.cilium_tpu_accesslog_close(handle)

    def set_accesslog(self, mod: int, handle: int) -> None:
        self.lib.cilium_tpu_set_accesslog(mod, handle)

    def proxymap_open(self, path: str) -> int:
        return self.lib.cilium_tpu_proxymap_open(path.encode())

    def proxymap_close(self, handle: int) -> None:
        self.lib.cilium_tpu_proxymap_close(handle)

    def hostmap_open(self, path: str) -> int:
        return self.lib.cilium_tpu_hostmap_open(path.encode())

    def hostmap_close(self, handle: int) -> None:
        self.lib.cilium_tpu_hostmap_close(handle)

    def hostmap_lookup(self, handle: int, addr: int) -> tuple[int, int]:
        """(matched prefix length + 1, or 0 on a miss; identity)."""
        ident, tun = ctypes.c_uint32(), ctypes.c_uint32()
        hit = self.lib.cilium_tpu_hostmap_lookup(handle, addr, ctypes.byref(ident), ctypes.byref(tun))
        return hit, ident.value if hit else 0

    def accept(self, mod, proxymap, hostmap, l7_proto, conn_id, saddr, daddr, sport, dport,
               policy) -> tuple[int, int, int, int, int]:
        """(result, orig daddr, orig dport, source identity, destination
        identity) of ``cilium_tpu_accept`` for an ingress TCP conn;
        addresses host order."""
        out = [ctypes.c_uint32() for _ in range(4)]
        res = self.lib.cilium_tpu_accept(
            mod, proxymap, hostmap, l7_proto.encode(), conn_id, 1, saddr, daddr, sport, dport, 6,
            policy.encode(), *(ctypes.byref(o) for o in out))
        return (res, *(o.value for o in out))


class OnIoMirror:
    """``cilium_tpu_on_io``'s contract for one connection (reference:
    envoy/cilium_proxylib.cc OnIO): the bytes a call forwards, from the
    ops and injects the service returned for it.  Per direction: bytes a
    PASS or DROP covered beyond the buffer pass or drop on arrival, the
    rest is retained; injects queued for a direction go out ahead of its
    next call's bytes, and INJECT ops take from that queue."""

    def __init__(self):
        self.buffer = [bytearray(), bytearray()]
        self.pass_bytes = [0, 0]
        self.drop_bytes = [0, 0]
        self.inject = [bytearray(), bytearray()]

    def call(self, reply: bool, data: bytes, ops, inject_orig: bytes, inject_reply: bytes):
        """Returns (forwarded bytes, frames passed, frames dropped)."""
        d = int(bool(reply))
        out = bytearray()
        pos = 0
        if self.pass_bytes[d]:
            pos = min(self.pass_bytes[d], len(data))
            out += data[:pos]
            self.pass_bytes[d] -= pos
        elif self.drop_bytes[d]:
            pos = min(self.drop_bytes[d], len(data))
            self.drop_bytes[d] -= pos
        buf = self.buffer[d]
        buf += data[pos:]
        out += self.inject[d]
        self.inject[d].clear()
        self.inject[0] += inject_orig
        self.inject[1] += inject_reply
        passed = dropped = 0
        for op, n in ops:
            if op == PASS:
                take = min(n, len(buf))
                out += buf[:take]
                del buf[:take]
                self.pass_bytes[d] = n - take if n > take else self.pass_bytes[d]
                passed += 1
            elif op == DROP:
                take = min(n, len(buf))
                del buf[:take]
                self.drop_bytes[d] = n - take if n > take else self.drop_bytes[d]
                dropped += 1
            elif op == INJECT:
                if n > len(self.inject[d]):
                    raise ValueError(f"INJECT {n} past the {len(self.inject[d])} queued bytes")
                out += self.inject[d][:n]
                del self.inject[d][:n]
            elif op != MORE:
                raise ValueError(f"op {op}")
        return bytes(out), passed, dropped


# --- a shim process ------------------------------------------------------------------


def b64(b: bytes) -> str:
    """Bytes as job-file text."""
    return base64.b64encode(b).decode()


def unb64(s: str) -> bytes:
    return base64.b64decode(s)


class ShimProcess:
    """One shim process's state across its jobs: the library and the one
    module the pod keeps open (its first job opens it on ``socket`` and
    pushes ``policy``; a later job reuses it, as a pod's proxy does, and
    the shim itself reconnects and replays after a service restart)."""

    def __init__(self, library: str):
        self.shim = Shim(library)
        self.mod = 0
        self.accesslog = 0

    def module(self, job: dict) -> int:
        if not self.mod:
            self.mod = self.shim.open(job["socket"], job["policy"].encode())
        return self.mod

    def close(self) -> None:
        if self.mod:
            self.shim.close(self.mod)
        if self.accesslog:
            self.shim.accesslog_close(self.accesslog)
        self.mod = self.accesslog = 0

    def _register(self, conns) -> list:
        refused = []
        for proto, cid, src_id, src, dst, policy in conns:
            res = self.shim.new_connection(self.mod, proto, cid, src_id, 2, src, dst, policy)
            if res != OK:
                refused.append([cid, res])
        return refused

    def drive(self, job: dict, stdin) -> dict:
        """Register the job's conns (with the access log ``accesslog``
        attached, or none), accept its accepted conns and resolve its
        host-map addresses, then run its calls in order with ``on_io``,
        each timed on the host clock; pauses after round ``pause_after``
        until a ``go`` line arrives.  Closes the job's conns at the end."""
        shim, mod = self.shim, self.module(job)
        if job.get("accesslog") and not self.accesslog:
            self.accesslog = shim.accesslog_open(job["accesslog"])
        shim.set_accesslog(mod, self.accesslog if job.get("accesslog") else 0)
        out = {"conn_results": self._register(job["conns"]), "accept": [], "hostmap": []}
        acc = job.get("accept")
        accepted = []
        if acc:
            pm = shim.proxymap_open(acc["proxymap"])
            hm = shim.hostmap_open(acc["hostmap"])
            try:
                if not pm or not hm:
                    raise RuntimeError(f"map snapshots did not open: proxymap {pm}, hostmap {hm}")
                for cid, saddr, daddr, sport, dport, policy in acc["conns"]:
                    out["accept"].append([cid, *shim.accept(mod, pm, hm, "r2d2", cid, saddr, daddr,
                                                            sport, dport, policy)])
                    accepted.append(cid)
                out["hostmap"] = [list(shim.hostmap_lookup(hm, a)) for a in acc["addrs"]]
            finally:
                if pm:
                    shim.proxymap_close(pm)
                if hm:
                    shim.hostmap_close(hm)
        results, outs, rtt_us = [], [], []
        pause = job.get("pause_after")
        t0 = time.perf_counter()
        for rnd, cid, reply, data in job["calls"]:
            if pause is not None and rnd > pause:
                self._pause(stdin)
                pause = None
            data = unb64(data)
            t = time.perf_counter()
            res, got = shim.on_io(mod, cid, reply, data)
            rtt_us.append((time.perf_counter() - t) * 1e6)
            results.append(res)
            outs.append(b64(got))
        if pause is not None:  # no call after the pause round: pause at the end
            self._pause(stdin)
        out.update(results=results, outs=outs, rtt_us=rtt_us, seconds=time.perf_counter() - t0)
        for cid in [c[1] for c in job["conns"]] + accepted:
            shim.close_connection(mod, cid)
        return out

    @staticmethod
    def _pause(stdin) -> None:
        print("pause", flush=True)
        if stdin.readline().strip() != "go":
            raise RuntimeError("expected go")

    def paced(self, job: dict) -> dict:
        """Whole frames on the job's conns in turn, one ``on_io`` at a
        time: closed loop where ``rate`` is 0, else started ``rate`` times
        a second from ``start`` (a ``time.time()`` shared by every
        process) for ``duration`` seconds.  A call whose result is not OK
        leaves its conn (its bytes stay retained there)."""
        shim, mod = self.shim, self.module(job)
        shim.set_accesslog(mod, 0)
        refused = self._register(job["conns"])
        if refused:
            raise RuntimeError(f"conns refused: {refused}")
        conns = [c[1] for c in job["conns"]]
        frames = [unb64(f) for f in job["frames"]]
        rate, duration = job["rate"], job["duration"]
        start = job.get("start") or time.time()
        while time.time() < start:
            time.sleep(min(start - time.time(), 0.001))
        t_end = time.perf_counter() + duration
        interval = 1.0 / rate if rate else 0.0
        next_fire = time.perf_counter()
        calls = ok = wrong = 0
        other: dict = {}
        rtt_us = []
        live = list(conns)
        k = 0
        while time.perf_counter() < t_end and live:
            now = time.perf_counter()
            if interval and now < next_fire:
                time.sleep(min(next_fire - now, 0.001))
                continue
            next_fire += interval
            cid = live[k % len(live)]
            frame = frames[k % len(frames)]
            k += 1
            t = time.perf_counter()
            res, got = shim.on_io(mod, cid, False, frame)
            rtt_us.append((time.perf_counter() - t) * 1e6)
            calls += 1
            if res == OK:
                ok += 1
                wrong += got != frame
            else:
                other[str(res)] = other.get(str(res), 0) + 1
                live.remove(cid)
        for cid in conns:
            shim.close_connection(mod, cid)
        return dict(calls=calls, ok=ok, wrong=wrong, other=other, rtt_us=rtt_us, seconds=duration)

    def run_job(self, path: str, stdin) -> None:
        """Run the job in the JSON file ``path`` (``kind`` "drive" or
        "paced") and write its result to ``path + ".out"``."""
        job = json.loads(Path(path).read_text())
        out = self.drive(job, stdin) if job["kind"] == "drive" else self.paced(job)
        tmp = Path(path + ".out.tmp")
        tmp.write_text(json.dumps(out))
        tmp.replace(path + ".out")


def main() -> int:
    proc = None
    try:
        for line in sys.stdin:
            path = line.strip()
            if not path:
                continue
            if proc is None:
                proc = ShimProcess(json.loads(Path(path).read_text())["library"])
            try:
                proc.run_job(path, sys.stdin)
            except Exception as exc:  # noqa: BLE001 - the parent reads the reason
                print(f"error {type(exc).__name__}: {exc}", flush=True)
                return 1
            print(f"done {path}", flush=True)
        return 0
    finally:
        if proc is not None:
            proc.close()


if __name__ == "__main__":
    sys.exit(main())
