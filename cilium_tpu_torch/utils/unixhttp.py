"""Shared unix-socket HTTP server plumbing.

One threading unix-stream HTTP server used by every plugin-style
surface (the agent REST API, the docker libnetwork driver) so socket
lifecycle fixes land once: stale-socket unlink, directory creation,
daemonized serve thread, shutdown + unlink on close.
"""

from __future__ import annotations

import os
import socketserver
import threading


class UnixHTTPServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


def serve_unix(path: str, handler_cls) -> UnixHTTPServer:
    """Bind ``handler_cls`` on a fresh unix socket at ``path`` and serve
    it from a daemon thread; returns the server (close with
    ``shutdown_unix``)."""
    if os.path.exists(path):
        os.unlink(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    server = UnixHTTPServer(path, handler_cls)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def shutdown_unix(server: UnixHTTPServer, path: str) -> None:
    server.shutdown()
    server.server_close()
    try:
        os.unlink(path)
    except OSError:
        pass
