"""The HTTP rule of the policy language, copied from
``cilium_tpu/policy/api.py`` (``PolicyValidationError`` and
``PortRuleHTTP``; reference: pkg/policy/api/http.go).  The rest of that
module (selectors, L3/L4 rules, Kafka) is not part of the port yet."""

from __future__ import annotations

from dataclasses import dataclass


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
