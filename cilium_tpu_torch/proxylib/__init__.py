"""Host policy compile for the port: the NPDS wire model, the policy-match
cascade, the rule parsers and the per-connection op loop.

Copies of the jax-free ``cilium_tpu/proxylib`` modules the r2d2, HTTP,
DNS, Cassandra and memcached slices need (``types``, ``npds``,
``parser``, ``policy``, ``accesslog``, ``connection``, the rule half of
``parsers/r2d2`` and ``parsers/{http,dns,cassandra,memcached}``).
``PolicyInstance.matches_at`` is the host oracle the device verdicts are
held against; ``Connection`` drives the streaming parsers inside
``runtime/l7engine.py``.  The instance layer is not part of the port yet.
"""

from .types import (
    OpType,
    OpError,
    FilterResult,
    MORE,
    PASS,
    DROP,
    INJECT,
    ERROR,
    NOP,
)
from .parser import (
    PolicyParseError,
    get_l7_rule_parser,
    parse_error,
    register_l7_rule_parser,
)
from .npds import (
    NetworkPolicy,
    PortNetworkPolicy,
    PortNetworkPolicyRule,
    TCP,
    UDP,
)
from .policy import PolicyInstance, PolicyMap, build_policy_map, compile_policy
from .connection import Connection, FILTER_OPS_CAPACITY
from .accesslog import LogEntry, EntryType, MemoryAccessLogger

# Rule-parser registrations (import side effects, like the reference's init()).
from . import parsers as _parsers  # noqa: F401

__all__ = [
    "OpType", "OpError", "FilterResult",
    "MORE", "PASS", "DROP", "INJECT", "ERROR", "NOP",
    "PolicyParseError", "get_l7_rule_parser", "parse_error",
    "register_l7_rule_parser",
    "NetworkPolicy", "PortNetworkPolicy", "PortNetworkPolicyRule", "TCP", "UDP",
    "PolicyInstance", "PolicyMap", "build_policy_map", "compile_policy",
    "Connection", "FILTER_OPS_CAPACITY",
    "LogEntry", "EntryType", "MemoryAccessLogger",
]
