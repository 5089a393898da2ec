"""Kafka protocol support: request parsing, policy matching, correlation
tracking and error response injection.  A copy of ``cilium_tpu/kafka``
(host code); the batched ACL model is ``models/kafka.py``.

reference: pkg/kafka — request frame parse (request.go:186 ReadRequest),
topic extraction per API key (request.go:88 GetTopics), policy matching
(policy.go:200 MatchesRule), correlation-ID rewrite cache
(correlation_cache.go), deny response injection (request.go:158).
"""

from .request import (
    KafkaParseError,
    RequestMessage,
    ResponseMessage,
    parse_request,
)
from .policy import matches_rule
from .correlation import CorrelationCache

__all__ = [
    "CorrelationCache",
    "KafkaParseError",
    "RequestMessage",
    "ResponseMessage",
    "matches_rule",
    "parse_request",
]
