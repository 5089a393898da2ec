"""Opt-in profiling endpoint.

reference: pkg/pprof/pprof.go — ``Enable`` serves Go's net/http/pprof
on localhost:6060.  The Python analog serves the equivalent trio on a
localhost HTTP socket:

- ``/debug/pprof/profile?seconds=N`` — statistical profile of ALL live
  threads: ``sys._current_frames`` sampled every 5ms for N seconds,
  aggregated to sample counts per frame (Go's CPU profile is likewise
  a sampling profiler; a deterministic cProfile would only see the
  handler thread)
- ``/debug/pprof/threads``          — stack dump of every live thread
  (the goroutine-dump analog)
- ``/debug/pprof/heap``             — tracemalloc top allocations if
  tracing is active, else a gc generation/object summary
"""

from __future__ import annotations

import gc
import logging
import sys
import threading
import traceback
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

log = logging.getLogger(__name__)

API_ADDRESS = ("127.0.0.1", 6060)  # reference: pprof.go apiAddress
SAMPLE_INTERVAL = 0.005


def profile_text(seconds: float = 1.0, top: int = 50) -> str:
    """Sample every live thread's current frame for ``seconds``."""
    me = threading.get_ident()
    counts: Counter = Counter()
    stop = threading.Event()
    n_samples = 0
    while not stop.wait(SAMPLE_INTERVAL):
        n_samples += 1
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            code = frame.f_code
            # co_qualname needs py3.11.  The fallback must keep the
            # enclosing function's name for <genexpr>/<lambda>/<listcomp>
            # frames (their co_name alone is anonymous, and a hot
            # comprehension would otherwise hide its owner from the
            # profile).
            qual = getattr(code, "co_qualname", None)
            if qual is None:
                qual = code.co_name
                if qual.startswith("<") and frame.f_back is not None:
                    qual = f"{frame.f_back.f_code.co_name}.{qual}"
            counts[
                f"{code.co_filename}:{frame.f_lineno} ({qual})"
            ] += 1
        if n_samples * SAMPLE_INTERVAL >= seconds:
            stop.set()
    lines = [f"samples: {n_samples} interval: {SAMPLE_INTERVAL * 1e3:.0f}ms"]
    for where, n in counts.most_common(top):
        lines.append(f"{n:8d} {where}")
    return "\n".join(lines) + "\n"


def threads_text() -> str:
    """Stack dump of all live threads (goroutine-dump analog)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def heap_text(top: int = 25) -> str:
    try:
        import tracemalloc

        if tracemalloc.is_tracing():
            snap = tracemalloc.take_snapshot()
            stats = snap.statistics("lineno")[:top]
            return "\n".join(str(s) for s in stats) + "\n"
    except ImportError:  # pragma: no cover
        pass
    counts = gc.get_count()
    return (
        f"gc counts: {counts}\n"
        f"tracked objects: {len(gc.get_objects())}\n"
        "(start tracemalloc for per-line allocations)\n"
    )


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        url = urlparse(self.path)
        if url.path == "/debug/pprof/profile":
            secs = float(parse_qs(url.query).get("seconds", ["1"])[0])
            body = profile_text(min(secs, 30.0))
        elif url.path == "/debug/pprof/threads":
            body = threads_text()
        elif url.path == "/debug/pprof/heap":
            body = heap_text()
        else:
            self.send_error(404)
            return
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def enable(address: tuple[str, int] | None = None) -> ThreadingHTTPServer:
    """Start the profiling server in the background (reference:
    pprof.go Enable); returns the server so tests/callers can stop it.
    Port 0 picks a free port (server.server_address reports it)."""
    srv = ThreadingHTTPServer(address or API_ADDRESS, _Handler)
    t = threading.Thread(target=srv.serve_forever, name="pprof", daemon=True)
    t.start()
    log.info("pprof API served on %s:%d", *srv.server_address[:2])
    return srv
