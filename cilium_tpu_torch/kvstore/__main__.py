"""Standalone kvstore server / replica launcher.

The etcd process a cluster's agents point at.  Run a primary:
    python -m cilium_tpu_torch.kvstore --port 4370 --snapshot /var/lib/kv.json
Run a follower replicating from it:
    python -m cilium_tpu_torch.kvstore --port 4371 --follow 127.0.0.1:4370
Agents then use:  --kvstore tcp --kvstore-address host:4370,host:4371
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="cilium-tpu kvstore server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=4370)
    p.add_argument("--snapshot", default="",
                   help="persist non-leased keys to this JSON file")
    p.add_argument("--follow", default="",
                   help="replicate from this primary host:port "
                        "(runs as a failover follower)")
    args = p.parse_args(argv)

    from . import KvstoreFollower, KvstoreServer

    kw = {"host": args.host, "port": args.port,
          "snapshot_path": args.snapshot or None}
    if args.follow:
        server = KvstoreFollower(args.follow, **kw)
        if not server.synced.wait(30.0):
            print(
                "warning: initial snapshot replay has not completed "
                "after 30s; serving may return misses until it does",
                file=sys.stderr, flush=True,
            )
        role = f"follower of {args.follow}"
    else:
        server = KvstoreServer(**kw)
        role = "primary"
    print(f"kvstore {role} serving on {server.address}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
