"""Kafka policy matching — the host oracle for the device ACL model.

reference: pkg/kafka/policy.go:200 MatchesRule + :142 ruleMatches.
"""

from __future__ import annotations

from ..policy.api import PortRuleKafka
from .request import (
    FIND_COORDINATOR_KEY,
    PARSED_TOPIC_KEYS,
    RequestMessage,
    TOPIC_API_KEYS,
)


def _rule_matches(req: RequestMessage, rule: PortRuleKafka) -> bool:
    """reference: policy.go:142 ruleMatches."""
    if not rule.check_api_key_role(req.api_key):
        return False
    api_version, wildcard = rule.get_api_version()
    if not wildcard and api_version != req.api_version:
        return False
    if rule.topic == "" and rule.client_id == "":
        return True
    if req.parsed and req.api_key in PARSED_TOPIC_KEYS:
        # Parsed request types check ClientID (policy.go:73-140).
        if rule.client_id and rule.client_id != req.client_id:
            return False
        return True
    if req.api_key == FIND_COORDINATOR_KEY:
        # ConsumerMetadataReq: unconditionally allowed (policy.go:181).
        return True
    # Header-only (nil request): a topic rule can never match a
    # topic-carrying API key (policy.go:54 matchNonTopicRequests).
    if rule.topic and req.api_key in TOPIC_API_KEYS:
        return False
    return True


def matches_rule(req: RequestMessage, rules: list[PortRuleKafka]) -> bool:
    """reference: policy.go:200 MatchesRule — a request is allowed if a
    topic-less matching rule allows it outright, or every distinct topic
    in the request is allowed by some matching rule naming it."""
    topics = set(req.get_topics())
    remaining = set(topics)
    for rule in rules:
        if rule.topic == "" or not topics:
            if _rule_matches(req, rule):
                return True
        elif rule.topic in remaining:
            if _rule_matches(req, rule):
                remaining.discard(rule.topic)
                if not remaining:
                    return True
    return False
