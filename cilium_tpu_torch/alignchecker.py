"""Struct-layout equivalence check.

reference: pkg/alignchecker/alignchecker.go:48 — the agent refuses to start
if its Go map structs don't byte-match the C structs in bpf/lib/common.h.
Here the authoritative layouts are the documented C sizes; every packed map
struct must serialize to exactly that size so dumps/restores and any future
native consumers stay ABI-compatible.
"""

from __future__ import annotations

# Expected packed sizes from the reference datapath ABI
# (reference: bpf/lib/common.h).
_EXPECTED_SIZES = {
    "policy_key": 8,
    "policy_entry": 24,
    "ipv4_ct_tuple": 14,
    "lb4_key": 8,
    "lb4_service": 12,
    "endpoint_info": 48,
}


class AlignmentError(RuntimeError):
    pass


def check_struct_alignments() -> None:
    """Raise AlignmentError on any layout mismatch; called at daemon boot
    (reference: daemon bootstrap calling alignchecker.CheckStructAlignments)."""
    from .maps.ctmap import TUPLE4_SIZE
    from .maps.lbmap import LB4_KEY_SIZE, LB4_SERVICE_SIZE
    from .maps.lxcmap import ENDPOINT_INFO_SIZE
    from .maps.policymap import ENTRY_SIZE, KEY_SIZE

    actual = {
        "policy_key": KEY_SIZE,
        "policy_entry": ENTRY_SIZE,
        "ipv4_ct_tuple": TUPLE4_SIZE,
        "lb4_key": LB4_KEY_SIZE,
        "lb4_service": LB4_SERVICE_SIZE,
        "endpoint_info": ENDPOINT_INFO_SIZE,
    }
    for name, want in _EXPECTED_SIZES.items():
        got = actual[name]
        if got != want:
            raise AlignmentError(
                f"struct {name}: packed size {got} != expected {want}"
            )
