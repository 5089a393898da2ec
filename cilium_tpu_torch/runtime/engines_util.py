"""Engine construction helpers."""

from __future__ import annotations

from ..models.builder import kafka_host_rows

__all__ = ["kafka_host_rows"]
