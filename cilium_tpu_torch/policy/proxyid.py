"""Proxy redirect identifiers (reference: pkg/policy/proxyid.go)."""

from __future__ import annotations


def proxy_id(endpoint_id: int, ingress: bool, protocol: str, port: int) -> str:
    """``epID:direction:proto:port`` linking an L4Filter to its redirect
    (reference: proxyid.go:24)."""
    direction = "ingress" if ingress else "egress"
    return f"{endpoint_id}:{direction}:{protocol}:{port}"


def parse_proxy_id(pid: str) -> tuple[int, bool, str, int]:
    """reference: proxyid.go:33."""
    parts = pid.split(":")
    if len(parts) != 4:
        raise ValueError(f"invalid proxy ID {pid!r}")
    ep_id = int(parts[0])
    if parts[1] == "ingress":
        ingress = True
    elif parts[1] == "egress":
        ingress = False
    else:
        raise ValueError(f"invalid direction in proxy ID {pid!r}")
    return ep_id, ingress, parts[2], int(parts[3])
