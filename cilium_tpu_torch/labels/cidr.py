"""CIDR -> label conversion (reference: pkg/labels/cidr.go).

CIDR prefixes appearing in policy become labels with source ``cidr`` so the
selector machinery can treat IP blocks uniformly with label selectors; IPv6
colons become dashes (selector keys can't contain ':').
"""

from __future__ import annotations

import ipaddress

from . import Label, parse_label

SOURCE_CIDR = "cidr"


def _masked_ip_to_label_string(ip: str, prefix: int) -> str:
    s = ip.replace(":", "-")
    pre = "0" if s.startswith("-") else ""
    post = "0" if s.endswith("-") else ""
    return f"{SOURCE_CIDR}:{pre}{s}{post}/{prefix}"


def ipnet_to_label(net: ipaddress._BaseNetwork) -> Label:
    return parse_label(
        _masked_ip_to_label_string(str(net.network_address), net.prefixlen)
    )


def ip_string_to_label(ip: str) -> Label | None:
    """Parse an IP or CIDR string into its cidr-source label; None if invalid
    (reference: pkg/labels/cidr.go:58-74)."""
    try:
        net = ipaddress.ip_network(ip, strict=False)
    except ValueError:
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return None
        net = ipaddress.ip_network(f"{addr}/{addr.max_prefixlen}")
    return ipnet_to_label(net)
