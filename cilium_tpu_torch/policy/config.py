"""Policy enforcement mode (reference: pkg/policy/config.go)."""

from __future__ import annotations

import threading

# Enforcement modes (reference: pkg/option — DefaultEnforcement etc.).
DEFAULT_ENFORCEMENT = "default"
ALWAYS_ENFORCE = "always"
NEVER_ENFORCE = "never"

_mutex = threading.Lock()
_policy_enabled = DEFAULT_ENFORCEMENT


def set_policy_enabled(val: str) -> None:
    global _policy_enabled
    with _mutex:
        _policy_enabled = val.lower()


def get_policy_enabled() -> str:
    with _mutex:
        return _policy_enabled
