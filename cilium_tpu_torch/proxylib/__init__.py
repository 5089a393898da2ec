"""Host policy compile for the port: the NPDS wire model, the policy-match
cascade, the rule parsers and the per-connection op loop.

Copies of the jax-free ``cilium_tpu/proxylib`` modules (``types``,
``npds``, ``parser``, ``policy``, ``accesslog``, ``connection``,
``instance`` and ``parsers/{r2d2,http,dns,cassandra,memcached}``).
``PolicyInstance.matches_at`` is the host oracle the device verdicts are
held against; ``Connection`` drives the streaming parsers inside
``runtime/l7engine.py``; the module/instance layer is the in-process
oracle the sidecar service runs beside its engines.
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
    Parser,
    ParserFactory,
    PolicyParseError,
    get_l7_rule_parser,
    get_parser_factory,
    parse_error,
    register_l7_rule_parser,
    register_parser_factory,
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
from .instance import (
    Instance,
    open_instance,
    find_instance,
    close_instance,
    open_module,
    close_module,
    reset_module_registry,
)
from .accesslog import LogEntry, EntryType, MemoryAccessLogger

# Rule-parser registrations (import side effects, like the reference's init()).
from . import parsers as _parsers  # noqa: F401

__all__ = [
    "OpType", "OpError", "FilterResult",
    "MORE", "PASS", "DROP", "INJECT", "ERROR", "NOP",
    "Parser", "ParserFactory", "PolicyParseError", "get_l7_rule_parser",
    "get_parser_factory", "parse_error", "register_l7_rule_parser",
    "register_parser_factory",
    "NetworkPolicy", "PortNetworkPolicy", "PortNetworkPolicyRule", "TCP", "UDP",
    "PolicyInstance", "PolicyMap", "build_policy_map", "compile_policy",
    "Connection", "FILTER_OPS_CAPACITY",
    "Instance", "open_instance", "find_instance", "close_instance",
    "open_module", "close_module", "reset_module_registry",
    "LogEntry", "EntryType", "MemoryAccessLogger",
]
