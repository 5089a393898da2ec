"""Flow-level verdict observability: per-flow records with device-side
rule attribution.  A copy of ``cilium_tpu/flowlog``; the HTTP engine
emits one columnar round per step into a ``FlowLog``."""

from .record import (
    CODE_DENIED,
    CODE_ERROR,
    CODE_FORWARDED,
    CODE_SHED,
    CT_ESTABLISHED,
    CT_NEW,
    CT_UNKNOWN,
    MATCH_L3,
    MATCH_L4,
    MATCH_LITERAL,
    MATCH_NFA,
    MATCH_NONE,
    MATCH_REGEX,
    PATH_DATAPATH,
    PATH_ENGINE,
    PATH_XDP,
    VERDICT_DENIED,
    VERDICT_ERROR,
    VERDICT_FORWARDED,
    VERDICT_SHED,
    verdict_name,
)
from .ring import MAX_VERDICT_NOTIFICATIONS, FlowLog

__all__ = [
    "FlowLog",
    "MAX_VERDICT_NOTIFICATIONS",
    "CODE_FORWARDED",
    "CODE_DENIED",
    "CODE_SHED",
    "CODE_ERROR",
    "CT_UNKNOWN",
    "CT_NEW",
    "CT_ESTABLISHED",
    "MATCH_LITERAL",
    "MATCH_REGEX",
    "MATCH_NFA",
    "MATCH_L3",
    "MATCH_L4",
    "MATCH_NONE",
    "PATH_DATAPATH",
    "PATH_ENGINE",
    "PATH_XDP",
    "VERDICT_FORWARDED",
    "VERDICT_DENIED",
    "VERDICT_SHED",
    "VERDICT_ERROR",
    "verdict_name",
]
