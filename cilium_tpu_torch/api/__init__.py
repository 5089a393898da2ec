"""REST API over a unix socket (reference: api/v1 + daemon REST handlers
wired at daemon/main.go:990, served on the agent's unix socket)."""

from .server import ApiClient, ApiError, ApiServer

__all__ = ["ApiClient", "ApiError", "ApiServer"]
