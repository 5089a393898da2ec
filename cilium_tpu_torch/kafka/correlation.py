"""Correlation-ID rewrite cache.

reference: pkg/kafka/correlation_cache.go — the proxy rewrites each
forwarded request's correlation ID to a locally unique value so responses
can be matched back to their origin request, then restores the original ID
on the response path.
"""

from __future__ import annotations

import threading
from typing import Optional

from .request import RequestMessage


class CorrelationCache:
    def __init__(self) -> None:
        self._next = 1
        self._origins: dict[int, tuple[int, RequestMessage]] = {}
        self._mutex = threading.Lock()

    def handle_request(self, req: RequestMessage) -> int:
        """Assign a unique ID, remembering the original; returns the new
        ID (reference: correlation_cache.go HandleRequest)."""
        with self._mutex:
            new_id = self._next
            self._next += 1
            if self._next > 0x7FFFFFFF:
                self._next = 1
            self._origins[new_id] = (req.correlation_id, req)
        req.set_correlation_id(new_id)
        return new_id

    def correlate(self, response_id: int) -> Optional[RequestMessage]:
        """Find the origin request for a response (keeps the entry for
        duplicate responses until delete)."""
        with self._mutex:
            entry = self._origins.get(response_id)
            return entry[1] if entry else None

    def restore_response_id(self, response_id: int) -> Optional[int]:
        """Original correlation ID for a proxied response; removes the
        entry (reference: correlation_cache.go Delete on response)."""
        with self._mutex:
            entry = self._origins.pop(response_id, None)
            return entry[0] if entry else None

    def __len__(self) -> int:
        return len(self._origins)
