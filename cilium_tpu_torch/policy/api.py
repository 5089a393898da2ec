"""The HTTP and Kafka rules of the policy language, copied from
``cilium_tpu/policy/api.py`` (``PolicyValidationError``, ``PortRuleHTTP``,
the ``KAFKA_*`` tables and ``PortRuleKafka``; reference:
pkg/policy/api/{http,kafka}.go).  The rest of that module (selectors,
L3/L4 rules) is not part of the port yet."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional


class PolicyValidationError(ValueError):
    """Raised by sanitize on an invalid rule (reference: rule_validation.go)."""


@dataclass
class PortRuleHTTP:
    """HTTP constraint; fields are POSIX-extended regexes
    (reference: pkg/policy/api/http.go:28)."""

    path: str = ""
    method: str = ""
    host: str = ""
    headers: tuple[str, ...] = ()

    def sanitize(self) -> None:
        from ..regex import ParseError, compile_pattern

        for pat in (self.path, self.method):
            if pat:
                try:
                    compile_pattern(pat)
                except ParseError as e:
                    raise PolicyValidationError(f"invalid regex {pat!r}: {e}")

    def key(self):
        return (self.path, self.method, self.host, tuple(self.headers))


# Kafka API keys (reference: pkg/policy/api/kafka.go:153-190).
KAFKA_API_KEY_MAP: dict[str, int] = {
    "produce": 0, "fetch": 1, "offsets": 2, "metadata": 3, "leaderandisr": 4,
    "stopreplica": 5, "updatemetadata": 6, "controlledshutdown": 7,
    "offsetcommit": 8, "offsetfetch": 9, "findcoordinator": 10, "joingroup": 11,
    "heartbeat": 12, "leavegroup": 13, "syncgroup": 14, "describegroups": 15,
    "listgroups": 16, "saslhandshake": 17, "apiversions": 18, "createtopics": 19,
    "deletetopics": 20, "deleterecords": 21, "initproducerid": 22,
    "offsetforleaderepoch": 23, "addpartitionstotxn": 24, "addoffsetstotxn": 25,
    "endtxn": 26, "writetxnmarkers": 27, "txnoffsetcommit": 28,
    "describeacls": 29, "createacls": 30, "deleteacls": 31,
    "describeconfigs": 32, "alterconfigs": 33,
}
KAFKA_REVERSE_API_KEY_MAP = {v: k for k, v in KAFKA_API_KEY_MAP.items()}

KAFKA_ROLE_PRODUCE = "produce"
KAFKA_ROLE_CONSUME = "consume"

# Role expansions (reference: kafka.go:274-291): produce needs
# produce+metadata+apiversions; consume needs the full consumer-group set.
KAFKA_PRODUCE_KEYS = (0, 3, 18)
KAFKA_CONSUME_KEYS = (1, 2, 3, 8, 9, 10, 11, 12, 13, 14, 18)

KAFKA_MAX_TOPIC_LEN = 255
# The reference's pattern is a Go *raw* string (kafka.go:244), so its `\\`
# is a regex-escaped literal backslash: backslashes ARE accepted there, and
# this port preserves that exact behavior.
_KAFKA_TOPIC_RE = re.compile(r"^[a-zA-Z0-9._\-\\]+$")

# API keys whose requests carry topics — the behavioral set the matcher
# uses (reference: pkg/kafka/policy.go:27 isTopicAPIKey; note kafka.go's
# constant block also lists FindCoordinator/JoinGroup, but isTopicAPIKey,
# which decides verdicts, does not).
KAFKA_TOPIC_API_KEYS = frozenset(
    [0, 1, 2, 3, 4, 5, 6, 8, 9, 19, 20, 21, 23, 24, 27, 28, 34, 35, 37]
)


@dataclass
class PortRuleKafka:
    """Kafka constraint (reference: pkg/policy/api/kafka.go:26)."""

    role: str = ""
    api_key: str = ""
    api_version: str = ""
    client_id: str = ""
    topic: str = ""

    # Private, filled by sanitize.
    api_keys_int: tuple[int, ...] = field(default=(), compare=False)
    api_version_int: Optional[int] = field(default=None, compare=False)

    def sanitize(self) -> None:
        if self.api_key and self.role:
            raise PolicyValidationError(
                f"cannot set both Role {self.role!r} and APIKey {self.api_key!r}"
            )
        if self.api_key:
            n = KAFKA_API_KEY_MAP.get(self.api_key.lower())
            if n is None:
                raise PolicyValidationError(f"invalid Kafka APIKey {self.api_key!r}")
            self.api_keys_int = (n,)
        if self.role:
            role = self.role.lower()
            if role == KAFKA_ROLE_PRODUCE:
                self.api_keys_int = KAFKA_PRODUCE_KEYS
            elif role == KAFKA_ROLE_CONSUME:
                self.api_keys_int = KAFKA_CONSUME_KEYS
            else:
                raise PolicyValidationError(f"invalid Kafka role {self.role!r}")
        if self.api_version:
            try:
                self.api_version_int = int(self.api_version)
            except ValueError:
                raise PolicyValidationError(
                    f"invalid Kafka APIVersion {self.api_version!r}"
                )
        if self.topic:
            if len(self.topic) > KAFKA_MAX_TOPIC_LEN:
                raise PolicyValidationError(
                    f"kafka topic exceeds maximum len of {KAFKA_MAX_TOPIC_LEN}"
                )
            if not _KAFKA_TOPIC_RE.match(self.topic):
                raise PolicyValidationError(
                    f"invalid Kafka topic name {self.topic!r}"
                )

    def check_api_key_role(self, kind: int) -> bool:
        """reference: kafka.go CheckAPIKeyRole — empty set is a wildcard."""
        return not self.api_keys_int or kind in self.api_keys_int

    def get_api_version(self) -> tuple[int, bool]:
        if self.api_version_int is None:
            return 0, True
        return self.api_version_int, False

    def key(self):
        return (self.role, self.api_key, self.api_version, self.client_id, self.topic)
