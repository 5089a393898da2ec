"""Endpoint lifecycle: state machine, policy regeneration, restore.

reference: pkg/endpoint — the Endpoint object owns its identity, policy
state and datapath map; Regenerate (policy.go:812) recomputes policy from
the repository (regeneratePolicy policy.go:482), converts it into a
desired policy-map state keyed by {identity, port, proto, direction}
(policy.go:144-254), then syncs the per-endpoint policy map by diffing
desired vs realized (bpf.go syncPolicyMap) and installs L7 redirects.
Where the reference compiles and loads a BPF program per endpoint, this
build exports the policy map to device arrays for the batched verdict ops
— "compile" is a device-table pack, not a clang exec.

A copy of ``cilium_tpu/endpoint/``; an ``Endpoint`` and an
``EndpointManager`` take ``device`` (None: the CUDA card, raising without
one; "cpu" for the plain versions), where the policy map is exported.
"""

from .endpoint import (
    Endpoint,
    EndpointOwner,
    EndpointState,
    PolicyMapStateEntry,
)
from .manager import EndpointManager
from .buildqueue import BuildQueue

__all__ = [
    "BuildQueue",
    "Endpoint",
    "EndpointManager",
    "EndpointOwner",
    "EndpointState",
    "PolicyMapStateEntry",
]
