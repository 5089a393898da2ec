"""Mesh and sharding helpers: flow- and rule-sharded verdicts over slots.

Counterpart of ``cilium_tpu/parallel``.  The reference scales the verdict
plane by sharding the *flow* (batch) axis of every device op over a mesh;
rule tables are replicated until they outgrow one device's memory, at
which point the rule axis shards too.  The port runs a mesh as one
process over its slots (``mesh.MeshDevice``), each on a CUDA card or, as
a virtual mesh, several on one card.
"""

from .mesh import (
    FLOW_AXIS,
    RULE_AXIS,
    Mesh,
    MeshDevice,
    flow_mesh,
    flow_sharding,
    local_devices,
    mesh_extents,
    replicated,
    reshape_mesh,
    serving_mesh,
    virtual_devices,
)

__all__ = [
    "FLOW_AXIS", "RULE_AXIS", "Mesh", "MeshDevice", "flow_mesh",
    "flow_sharding", "local_devices", "mesh_extents", "replicated",
    "reshape_mesh", "serving_mesh", "virtual_devices",
]
