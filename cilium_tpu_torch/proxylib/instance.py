"""Instance/module lifecycle and connection registry.

Reference: proxylib/proxylib/instance.go (instance registry keyed on
node-id/xds-path/access-log-path, refcounted open/close, atomic policy-map
swap) and proxylib/proxylib.go:57-153 (the cgo module surface: OpenModule /
OnNewConnection / OnData / Close / CloseModule, with the global connection
map).  The same surface is exported to the native C++ shim via
``runtime/capi.py`` of the JAX package.
"""

from __future__ import annotations

import threading
from typing import Callable

from .accesslog import MemoryAccessLogger
from .connection import FILTER_OPS_CAPACITY, Connection, InjectBuf
from .npds import NetworkPolicy
from .parser import PolicyParseError, get_parser_factory
from .policy import PolicyMap, compile_policy
from .types import FilterResult, OpType


class Instance:
    def __init__(self, instance_id: int, node_id: str, access_logger=None):
        self.id = instance_id
        self.open_count = 1
        self.node_id = node_id or f"host~127.0.0.1~libcilium-{instance_id}~localdomain"
        self.access_logger = access_logger
        self.policy_client = None
        self._policy_map: PolicyMap = {}
        self._lock = threading.Lock()

    # -- policy ----------------------------------------------------------
    def policy_matches(
        self, policy_name: str, ingress: bool, port: int, remote_id: int, l7_data
    ) -> bool:
        policy = self._policy_map.get(policy_name)
        return policy is not None and policy.matches(ingress, port, remote_id, l7_data)

    def policy_matches_at(
        self, policy_name: str, ingress: bool, port: int, remote_id: int, l7_data
    ) -> tuple[bool, int]:
        """policy_matches plus the deciding flattened rule row (-1 for
        deny/unattributed) — the attribution walk Connection.matches
        records onto ``last_rule_id`` for flow-record emission."""
        policy = self._policy_map.get(policy_name)
        if policy is None:
            return False, -1
        return policy.matches_at(ingress, port, remote_id, l7_data)

    def has_policy(self, policy_name: str) -> bool:
        return policy_name in self._policy_map

    def policy_map(self) -> PolicyMap:
        return self._policy_map

    def policy_prepare(self, configs: list[NetworkPolicy]) -> PolicyMap:
        """Compile a STAGED policy map without publishing it: the active
        map keeps serving while compilation runs, and a compile error
        leaves nothing half-applied (the staged map is simply dropped).
        Unchanged policies are re-used from the old map.  The sidecar's
        epoch swap builds device tables against the staged map and
        publishes both in one pointer flip (policy_commit)."""
        old = self._policy_map
        new: PolicyMap = {}
        for config in configs:
            existing = old.get(config.name)
            if existing is not None and existing.config == config:
                new[config.name] = existing
                continue
            new[config.name] = compile_policy(config)  # may raise
        return new

    def policy_commit(self, new: PolicyMap) -> None:
        """Publish a staged map (atomic plain store; maps are never
        mutated after construction)."""
        self._policy_map = new

    def policy_update(self, configs: list[NetworkPolicy]) -> None:
        """Atomically replace the policy map; an error while compiling any
        policy leaves the active map untouched (reference: instance.go:168-219)."""
        self.policy_commit(self.policy_prepare(configs))

    def log(self, entry) -> None:
        if self.access_logger is not None:
            self.access_logger.log(entry)


# --- module-level registries (the cgo export surface) -------------------

_mutex = threading.Lock()
_instances: dict[int, Instance] = {}
_next_instance_id = 0
_connections: dict[int, Connection] = {}


def open_instance(
    node_id: str,
    xds_path: str = "",
    access_log_path: str = "",
    new_access_logger: Callable = MemoryAccessLogger,
    new_policy_client: Callable | None = None,
) -> int:
    """Open (or ref) an instance with these parameters
    (reference: instance.go:85-116)."""
    global _next_instance_id
    with _mutex:
        for iid, old in _instances.items():
            old_xds = old.policy_client.path() if old.policy_client else ""
            old_log = old.access_logger.path() if old.access_logger else ""
            if (
                (node_id == "" or old.node_id == node_id)
                and xds_path == old_xds
                and access_log_path == old_log
            ):
                old.open_count += 1
                return iid
        _next_instance_id += 1
        ins = Instance(
            _next_instance_id, node_id, new_access_logger(access_log_path)
        )
        if new_policy_client is not None:
            ins.policy_client = new_policy_client(xds_path, ins.node_id, ins)
        _instances[_next_instance_id] = ins
        return _next_instance_id


def find_instance(instance_id: int) -> Instance | None:
    with _mutex:
        return _instances.get(instance_id)


def close_instance(instance_id: int) -> int:
    with _mutex:
        ins = _instances.get(instance_id)
        if ins is None:
            return 0
        ins.open_count -= 1
        if ins.open_count <= 0:
            if ins.policy_client is not None:
                ins.policy_client.close()
            if ins.access_logger is not None:
                ins.access_logger.close()
            del _instances[instance_id]
            return 0
        return ins.open_count


_KNOWN_MODULE_PARAMS = ("node-id", "xds-path", "access-log-path")


def open_module(params: list[tuple[str, str]], debug: bool = False) -> int:
    """The OpenModule surface (reference: proxylib/proxylib.go:124-153).
    Unknown params fail with 0."""
    kv = {}
    for k, v in params:
        if k not in _KNOWN_MODULE_PARAMS:
            return 0
        kv[k] = v
    return open_instance(
        kv.get("node-id", ""),
        xds_path=kv.get("xds-path", ""),
        access_log_path=kv.get("access-log-path", ""),
    )


def close_module(module_id: int) -> int:
    return close_instance(module_id)


def reset_module_registry() -> None:
    """Test hook: drop all instances/connections."""
    global _next_instance_id
    with _mutex:
        _instances.clear()
        _connections.clear()
        _next_instance_id = 0


# --- connection surface (reference: proxylib/proxylib.go:57-122) --------

def on_new_connection(
    instance_id: int,
    proto: str,
    connection_id: int,
    ingress: bool,
    src_id: int,
    dst_id: int,
    src_addr: str,
    dst_addr: str,
    policy_name: str,
    orig_buf_capacity: int = 1024,
    reply_buf_capacity: int = 1024,
) -> tuple[FilterResult, Connection | None]:
    ins = find_instance(instance_id)
    if ins is None:
        return FilterResult.INVALID_INSTANCE, None
    factory = get_parser_factory(proto)
    if factory is None:
        return FilterResult.UNKNOWN_PARSER, None
    port = _parse_port(dst_addr)
    if port is None:
        return FilterResult.INVALID_ADDRESS, None
    conn = Connection(
        instance=ins,
        conn_id=connection_id,
        ingress=ingress,
        src_id=src_id,
        dst_id=dst_id,
        src_addr=src_addr,
        dst_addr=dst_addr,
        policy_name=policy_name,
        port=port,
        parser_name=proto,
        orig_buf=InjectBuf(orig_buf_capacity),
        reply_buf=InjectBuf(reply_buf_capacity),
    )
    parser = factory.create(conn)
    if parser is None:
        return FilterResult.POLICY_DROP, None
    conn.parser = parser
    with _mutex:
        _connections[connection_id] = conn
    return FilterResult.OK, conn


def on_data(
    connection_id: int,
    reply: bool,
    end_stream: bool,
    data: list[bytes],
    ops: list[tuple[OpType, int]],
    ops_capacity: int = FILTER_OPS_CAPACITY,
) -> FilterResult:
    with _mutex:
        conn = _connections.get(connection_id)
    if conn is None:
        return FilterResult.UNKNOWN_CONNECTION
    return conn.on_data(reply, end_stream, data, ops, ops_capacity)


def close_connection(connection_id: int) -> int:
    with _mutex:
        _connections.pop(connection_id, None)
        return len(_connections)


def _parse_port(addr: str) -> int | None:
    """Destination port from 'a.b.c.d:port' / '[v6]:port'; 0 is reserved
    for wildcarding and invalid here (reference: connection.go:71-78)."""
    host, sep, port_s = addr.rpartition(":")
    if not sep or not host:
        return None
    try:
        port = int(port_s)
    except ValueError:
        return None
    if not (0 < port <= 65535):
        return None
    return port
