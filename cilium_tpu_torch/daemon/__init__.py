"""The agent daemon: wires every subsystem into one running node agent.

reference: daemon/ — NewDaemon (daemon.go:1090) constructs the policy
repository, identity allocator, ipcache watcher, endpoint builders, proxy
support and API servers; runDaemon (main.go:837) brings the node online.
"""

from .daemon import Daemon

__all__ = ["Daemon"]
