"""System-load logging during long-running operations.

reference: pkg/loadinfo/loadinfo.go — LogCurrentSystemLoad logs load
averages, memory, and any process above a CPU watermark;
LogPeriodicSystemLoad repeats that every interval until stopped (the
daemon wraps long compiles/regenerations with it).  This build reads
/proc directly instead of gopsutil; on non-Linux the probes degrade to
empty results rather than failing.
"""

from __future__ import annotations

import logging
import os
import threading
import time

log = logging.getLogger(__name__)

BACKGROUND_INTERVAL = 5.0  # reference: loadinfo.go backgroundInterval
CPU_WATERMARK = 1.0  # reference: loadinfo.go cpuWatermark (percent)


def _load_avg() -> tuple[float, float, float] | None:
    try:
        with open("/proc/loadavg") as f:
            p = f.read().split()
        return float(p[0]), float(p[1]), float(p[2])
    except (OSError, ValueError, IndexError):
        return None


def _mem_info() -> dict | None:
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                fields[k] = int(rest.split()[0])  # kB
        total = fields["MemTotal"]
        avail = fields.get("MemAvailable", fields.get("MemFree", 0))
        used = total - avail
        return {
            "total_mb": total // 1024,
            "used_mb": used // 1024,
            "available_mb": avail // 1024,
            "used_pct": round(100.0 * used / total, 2) if total else 0.0,
        }
    except (OSError, ValueError, KeyError):
        return None


class _ProcSampler:
    """Per-process CPU%% between consecutive samples (utime+stime delta
    over wall delta), mirroring the reference's process listing."""

    def __init__(self) -> None:
        self._prev: dict[int, tuple[float, float]] = {}
        self._tick = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100

    def sample(self) -> list[tuple[int, str, float]]:
        now = time.monotonic()
        out = []
        try:
            pids = [int(d) for d in os.listdir("/proc") if d.isdigit()]
        except OSError:
            return out
        fresh: dict[int, tuple[float, float]] = {}
        for pid in pids:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    raw = f.read()
                # comm may contain spaces; it is parenthesised.
                rpar = raw.rindex(")")
                comm = raw[raw.index("(") + 1 : rpar]
                rest = raw[rpar + 2 :].split()
                cpu_s = (int(rest[11]) + int(rest[12])) / self._tick
            except (OSError, ValueError, IndexError):
                continue
            fresh[pid] = (cpu_s, now)
            prev = self._prev.get(pid)
            if prev is not None and now > prev[1]:
                pct = 100.0 * (cpu_s - prev[0]) / (now - prev[1])
                if pct >= CPU_WATERMARK:
                    out.append((pid, comm, round(pct, 2)))
        self._prev = fresh
        out.sort(key=lambda r: -r[2])
        return out


def log_current_system_load(log_func=log.info, sampler: _ProcSampler | None = None):
    """One snapshot: load averages + memory + busy processes
    (reference: loadinfo.go LogCurrentSystemLoad)."""
    la = _load_avg()
    if la is not None:
        log_func("Load 1-min: %.2f 5-min: %.2f 15min: %.2f", *la)
    mi = _mem_info()
    if mi is not None:
        log_func(
            "Memory: Total: %d Used: %d (%.2f%%) Available: %d",
            mi["total_mb"], mi["used_mb"], mi["used_pct"], mi["available_mb"],
        )
    for pid, comm, pct in (sampler or _ProcSampler()).sample():
        log_func("NAME %s PID %d CPU: %.2f%%", comm, pid, pct)
    return {"load": la, "memory": mi}


class PeriodicLoadLogger:
    """reference: loadinfo.go LogPeriodicSystemLoad — context manager
    logging system load every interval while a long operation runs."""

    def __init__(self, log_func=log.info, interval: float = BACKGROUND_INTERVAL):
        self.log_func = log_func
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sampler = _ProcSampler()

    def __enter__(self) -> "PeriodicLoadLogger":
        log_current_system_load(self.log_func, self._sampler)
        self._thread = threading.Thread(
            target=self._loop, name="loadinfo", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            log_current_system_load(self.log_func, self._sampler)

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
