"""Device mesh construction and the flow-axis helpers.

Counterpart of ``cilium_tpu/parallel/mesh.py``.  Axes:
  "flows" — data-parallel axis; every batch dimension shards here.
  "rules" — model-parallel axis for rule sets too large for one card's
            memory; 1 by default.

A mesh is one process over its slots, as the reference's is one process
over its local devices.  A slot is a ``MeshDevice``: an id and the
``torch.device`` it runs on.  Slot ids are distinct even where slots share
a ``torch.device``: a *virtual* mesh is several slots on one card (or on
the CPU), the counterpart of the reference's virtual CPU devices.  Data
moves between slots by a copy to the receiving slot's device after an
event on the source's stream (``to_slot``), which is NVLink between two
cards and no copy at all between two slots of one device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

FLOW_AXIS = "flows"
RULE_AXIS = "rules"


@dataclass(frozen=True)
class MeshDevice:
    """One slot of a mesh: ``id`` names it (fault attribution, the
    service's lost set), ``device`` is where its work runs."""

    id: int
    device: torch.device

    @property
    def platform(self) -> str:
        return self.device.type


class Mesh:
    """An object array of ``MeshDevice`` slots with named axes."""

    def __init__(self, devices, axis_names: tuple):
        devs = np.asarray(devices, dtype=object)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d devices for axes {axis_names}")
        ids = [d.id for d in devs.flat]
        if len(set(ids)) != len(ids):
            raise ValueError(f"slot ids must be distinct: {ids}")
        self.devices = devs
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ids={[d.id for d in self.devices.flat]})"


def local_devices(device=None) -> list[MeshDevice]:
    """The slots this process can run on — THE one place that lists
    devices.  ``None`` or a CUDA device: one slot per CUDA card (id =
    card index; raises without a card); the CPU: one slot."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [
            MeshDevice(i, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())
        ]
    return [MeshDevice(0, dev)]


def virtual_devices(n: int, device=None) -> list[MeshDevice]:
    """``n`` slots (ids 0..n-1) on one device (``None``: the card): a
    virtual mesh, where every copy between slots is a no-op."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [MeshDevice(i, dev) for i in range(n)]


def flow_mesh(n_flow: int | None = None, n_rule: int = 1, devices=None) -> Mesh:
    """Build a (flows, rules) mesh over ``devices`` (default: every
    local card)."""
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if n_flow is None:
        n_flow = len(devices) // n_rule
    if n_flow * n_rule > len(devices) or n_flow < 1 or n_rule < 1:
        raise ValueError(
            f"a ({n_flow}, {n_rule}) mesh needs {n_flow * n_rule} slots, "
            f"{len(devices)} given"
        )
    devs = np.empty((n_flow, n_rule), dtype=object)
    for k, d in enumerate(devices[: n_flow * n_rule]):
        devs[k // n_rule, k % n_rule] = d
    return Mesh(devs, (FLOW_AXIS, RULE_AXIS))


def mesh_extents(mode: str, rule_shards: int = 0, flow_shards: int = 0,
                 n_devices: int = 0,
                 max_flow: int = 32) -> tuple[int, int] | None:
    """Pure extent resolution for ``serving_mesh`` — (n_flow, n_rule)
    or None — split out so >32-wide layouts are unit-testable without
    64 real devices.  The flow extent is floored to a power of two
    (every power-of-two dispatch bucket then divides it).  The
    ``max_flow`` cap applies only to the AUTO derivation (flow_shards
    == 0): an EXPLICIT ``mesh_flow_shards`` may exceed the smallest
    dispatch bucket — the service grows its minimum bucket to the flow
    extent instead, so >32-device pods shard the flow
    axis fully."""
    if mode == "off":
        return None
    n_rule = max(rule_shards, 1)
    n_flow = flow_shards or max(n_devices // n_rule, 1)
    n_flow = 1 << (n_flow.bit_length() - 1)
    if not flow_shards:
        n_flow = min(n_flow, max_flow)
    if n_flow * n_rule > n_devices:
        return None
    return n_flow, n_rule


def serving_mesh(mode: str, rule_shards: int = 0, flow_shards: int = 0,
                 devices=None, max_flow: int = 32) -> Mesh | None:
    """Resolve a (flows, rules) SERVING mesh from the DaemonConfig
    knobs (``mesh``/``mesh_rule_shards``/``mesh_flow_shards``), or
    None when multi-card serving is off — THE one resolution shared by
    the sidecar service and the daemon-side engine factory.  'auto'
    requires two or more distinct CUDA cards (slots of one card, or of
    the CPU, share its cores — a cross-shard reduce there only adds
    work); 'on' forces a mesh at any slot count.  Extent rules (pow2
    flooring, the auto-only ``max_flow`` cap) live in
    ``mesh_extents``."""
    if mode == "off":
        return None
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if mode != "on":
        cards = {d.device for d in devices if d.platform == "cuda"}
        if len(cards) < 2 or len(cards) != len(devices):
            return None
    ext = mesh_extents(mode, rule_shards, flow_shards, len(devices),
                       max_flow=max_flow)
    if ext is None:
        return None
    n_flow, n_rule = ext
    return flow_mesh(n_flow=n_flow, n_rule=n_rule, devices=devices)


def reshape_mesh(survivors, rule_shards: int = 1,
                 max_flow: int = 32) -> Mesh | None:
    """Width-ladder rung: the widest bucketable (flows, rules) mesh
    over a SURVIVING slot subset after a partial loss.  The rule
    extent is preserved when the survivors can still fill it (rule
    sharding exists for memory capacity — halving it doubles per-card
    table memory) and halved only when they cannot; the flow extent is
    the power-of-two floor of what remains, capped at ``max_flow`` so
    every dispatch bucket still divides it.  None when fewer than two
    slots survive in a usable layout — the service then holds the
    single-card fallback rung instead."""
    survivors = list(survivors)
    n = len(survivors)
    n_rule = max(rule_shards, 1)
    while n_rule > 1 and n_rule > n:
        n_rule = max(n_rule // 2, 1)
    n_flow = n // n_rule
    if n_flow < 1:
        return None
    n_flow = 1 << (n_flow.bit_length() - 1)
    if max_flow:
        n_flow = min(n_flow, max_flow)
    if n_flow * n_rule < 2:
        return None
    return flow_mesh(n_flow=n_flow, n_rule=n_rule, devices=survivors)


def to_slot(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: the tensor itself where it already lies there
    (no copy, no allocation), else a copy that waits on an event recorded
    on the source's current stream, so the source's pending work is done
    before the receiving card reads it."""
    if t.device == device:
        return t
    if t.device.type == "cuda" and device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(device).wait_event(ev)
        with torch.cuda.device(device):
            return t.to(device, non_blocking=True)
    return t.to(device)


def moved(obj, device: torch.device):
    """A model (a dataclass of tensors, automata nested) on ``device``:
    the object itself where it already lies there, else a copy."""
    if getattr(obj, "device", None) == device:
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{
            f.name: moved(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj


def flow_sharding(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Split the leading (flow) axis of ``x`` into the mesh's flow
    blocks, block i on the device of row i's first slot.  The extent
    must divide the flow count (see ``rulesharding._pad_flow_axis``)."""
    n_flow = mesh.shape[FLOW_AXIS]
    if x.shape[0] % n_flow:
        raise ValueError(f"{x.shape[0]} flows do not split into {n_flow} blocks")
    fb = x.shape[0] // n_flow
    return [
        to_slot(x[i * fb:(i + 1) * fb], mesh.devices[i, 0].device)
        for i in range(n_flow)
    ]


def replicated(mesh: Mesh, x: torch.Tensor) -> dict:
    """A copy of ``x`` on every distinct device of the mesh's slots:
    {torch.device: tensor} (one shared tensor on a virtual mesh)."""
    out: dict = {}
    for d in mesh.devices.flat:
        if d.device not in out:
            out[d.device] = to_slot(x, d.device)
    return out
