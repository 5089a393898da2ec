"""Agent entrypoint (reference: daemon/main.go runDaemon).

Brings up the daemon and its servers: REST API socket, monitor socket,
access log socket, distribution socket; then serves until interrupted.
The daemon runs on the CUDA card (``python -m cilium_tpu_torch.agent``);
``DaemonConfig(verdict_device="cpu")`` puts it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from .accesslog import AccessLogServer
from .api import ApiServer
from .daemon import Daemon
from .device import config_device, resolve_device
from .distribution.sock import SocketDistributionServer
from .monitor import MonitorServer
from .utils import defaults
from .utils.logging import get_logger, set_log_level
from .utils.option import DaemonConfig

log = get_logger("agent")


class Agent:
    """Owns the daemon plus all listening sockets."""

    def __init__(self, config: DaemonConfig, node_name: str = "local") -> None:
        # The daemon's device first: without a card the agent raises before
        # it makes its run directory, opens a socket or starts a thread.
        resolve_device(config_device(config))
        os.makedirs(config.run_dir, exist_ok=True)
        self.daemon = Daemon(config, node_name=node_name)
        self.api = ApiServer(self.daemon, config.socket_path)
        self.monitor_server = MonitorServer(
            self.daemon.monitor, config.monitor_socket_path
        )
        self.accesslog_server = AccessLogServer(
            os.path.join(config.run_dir, "access_log.sock"),
            on_record=self.daemon.access_logger.log,
        )
        self.dist_sock = SocketDistributionServer(
            self.daemon.dist_server,
            os.path.join(config.run_dir, "npds.sock"),
        )
        log.with_fields(
            api=config.socket_path, monitor=config.monitor_socket_path
        ).info("agent listening")

    def close(self) -> None:
        self.dist_sock.close()
        self.accesslog_server.close()
        self.monitor_server.close()
        self.api.close()
        self.daemon.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cilium-tpu-agent",
        description="cilium node agent (PyTorch and CUDA)",
    )
    p.add_argument("--run-dir", default=defaults.RUNTIME_PATH)
    p.add_argument("--node-name", default="local")
    p.add_argument("--cluster-name", default=defaults.CLUSTER_NAME)
    p.add_argument("--enable-policy", default="default",
                   choices=["default", "always", "never"])
    p.add_argument("--kvstore", default="local",
                   choices=["local", "file", "tcp"])
    p.add_argument("--kvstore-address", default="",
                   help="host:port of the kvstore server (kvstore=tcp); "
                        "comma-separated failover list supported "
                        "(primary,follower)")
    p.add_argument("--dry-mode", action="store_true",
                   help="skip device exports (reference: DryMode)")
    p.add_argument("--restore", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="restore endpoints from the state directory "
                        "(--no-restore for a clean start)")
    p.add_argument("--log-level", default="info")
    args = p.parse_args(argv)

    set_log_level(args.log_level)
    cfg = DaemonConfig(
        run_dir=args.run_dir,
        socket_path=os.path.join(args.run_dir, "cilium-tpu.sock"),
        monitor_socket_path=os.path.join(args.run_dir, "monitor.sock"),
        cluster_name=args.cluster_name,
        enable_policy=args.enable_policy,
        kvstore=args.kvstore,
        kvstore_opts=(
            {"address": args.kvstore_address} if args.kvstore_address else {}
        ),
        dry_mode=args.dry_mode,
        restore_state=args.restore,
    )
    from .policy import set_policy_enabled

    set_policy_enabled(args.enable_policy)
    agent = Agent(cfg, node_name=args.node_name)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        agent.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
