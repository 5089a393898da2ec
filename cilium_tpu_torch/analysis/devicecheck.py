"""Device-contract verification on OP TRACES of the real verdict models
(R8-R11, R16).

The AST half of R8-R11 (``rules_device.py``) pattern-matches hazards;
this half proves the contracts on the REAL verdict models by recording
what one call of each does.  A *trace* is the ordered list of port ops
one model call reaches, each with its tensor shapes: every call of a
kernel wrapper (``KERNEL_OPS``: the op functions that hold a kernel, as
one entry each, with the shapes of their inputs and outputs) and every
aten op of the glue between them (through a ``TorchDispatchMode``).

- **On the CPU** (``device="cpu"``, what the tests ask for) the
  wrappers run their plain PyTorch versions; the recorder sees the same
  op sequence the card runs.
- **On the card** (the default; raises without one) the same recorder
  runs around a real ``torch.cuda.graph`` capture, and
  ``kernels.captured_by`` reads the launches the graph holds.

The contracts, with the reference's rule ids:

- **R8** — two traces of one model are IDENTICAL (no wall-clock / rng /
  iteration-order dependence: each difference is a new graph
  signature), no op of the glue reads a scalar to the host (``int()`` /
  ``bool()`` / a Python branch on a tensor) or has a data-dependent
  output shape (``nonzero``, ``masked_select``, boolean-mask indexing),
  and the outputs keep the contract's dtypes (bool complete, int32
  msg_len, bool allow).
- **R9** — no host readback (``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``) in the glue; on the card, the capture completes (a host
  sync inside it fails the capture, and that is the finding — never a
  quiet eager run).
- **R10** — every sharded step (``parallel/rulesharding.py``) runs on
  1x1, 1x2, 2x1, 2x2, 4x1 and 4x2 (flows, rules) meshes of virtual
  slots with a balanced shard stack (``check_stacked_model``: one
  shard a rule slot, every shard's tables the same shapes), per-slot
  traces that are identical across slots, a step whose kernel ops are
  exactly its slots' plus one merge a flow block, a kernel-op set
  independent of the mesh, and two identical traces per mesh.
  ``check_reshape_ladder`` walks the width ladder's degraded rungs
  through the real assembly seam.
- **R11** — ``verdicts_attr``'s trace is the plain trace plus an
  epilogue of at most ``ATTR_EXTRA_OPS`` ops: 4 outputs with an int32
  rule row, and no scan, literal or hits op runs more often than in
  the plain call (a second hit-matrix pass would double them).
- **R16** — ``check_shape_closure``: the shapes that reach the
  service's dispatch seam over a prewarm and one round of each family
  stay inside the declared bucket universe.

Torch and the models are imported inside the entry points, so the AST
lint never pays for them; ``python -m cilium_tpu_torch.analysis.cli
--device-contracts`` and tests/test_torch_device_contracts.py are the
consumers.
"""

from __future__ import annotations

import contextlib
import sys

from .core import Finding

# An attribution epilogue is a where/argmax and a few selects; a SECOND
# hit-matrix pass repeats every scan, literal and hits op of the plain
# call.  The bound is loose enough for op-by-op torch version drift and
# tight enough that a doubled pass cannot hide.
ATTR_EXTRA_OPS = 12

_BATCH = 8
_WIDTH = 128
_PKG = "cilium_tpu_torch"

# The verdict path's kernel wrappers: launcher -> (module, function).
KERNEL_OPS = {
    "r2d2_frame": ("models.r2d2", "r2d2_frame"),
    "r2d2_hits": ("models.r2d2", "r2d2_hits"),
    "dfa_scan": ("ops.dfa", "dfa_search_spans"),
    "nfa_scan": ("ops.nfa", "nfa_search_spans"),
    "http_frame": ("models.http", "http_frame"),
    "http_lit": ("models.http", "http_lit"),
    "http_hits": ("models.http", "http_hits"),
    "dns_name": ("models.dns", "dns_name"),
    "dns_hits": ("models.dns", "dns_hits"),
    "kafka_hits": ("models.kafka", "kafka_hits"),
    "seam_probe": ("models.base", "seam_probe"),
    "gather_rows": ("ops.gather", "gather_rows"),
    "shard_reduce": ("parallel.rulesharding", "shard_reduce"),
    "kafka_shard_combine": ("parallel.rulesharding", "kafka_shard_combine"),
}
# Ops that merge the per-slot partials of a sharded step (one a flow
# block).
_MERGE_OPS = {"shard_reduce", "kafka_shard_combine"}

# Glue ops whose output shape depends on the data (R8), and the aten
# ops that read a scalar to the host (R8: int()/float()/bool()/a
# Python branch on a tensor).
_DATA_SHAPED = ("nonzero", "masked_select", "argwhere", "_unique", "unique")
_SCALAR_READS = ("_local_scalar_dense", "is_nonzero")
# Tensor methods that read a whole tensor to the host (R9).
_HOST_READS = ("item", "cpu", "tolist", "numpy")


# --- the recorder ---------------------------------------------------------

def _sig(x):
    """A hashable shape signature of an op argument or result: tensors by
    shape and dtype, sequences element-wise, scalars by value, anything
    else (a model, a table) by type name."""
    import torch

    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_sig(e) for e in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if hasattr(x, "__dataclass_fields__") and type(x).__name__.endswith(
            "Batch"):
        return (type(x).__name__,) + tuple(
            _sig(getattr(x, f)) for f in x.__dataclass_fields__)
    return type(x).__name__


class Trace:
    """One recorded call: ``ops`` is the ordered list of (kind, name,
    signature) — kind "kernel" (name: the launcher; signature: inputs,
    outputs) or "aten" (name: the overload; signature: outputs);
    ``hazards`` the (rule, message) pairs the glue ran into."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.hazards: list[tuple[str, str]] = []

    def kernel_ops(self) -> list[tuple]:
        return [op for op in self.ops if op[0] == "kernel"]

    def kernel_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for _kind, name, _sig_ in self.kernel_ops():
            out[name] = out.get(name, 0) + 1
        return out


def _wrappers():
    """{launcher: wrapper function} of ``KERNEL_OPS``, modules imported."""
    import importlib

    out = {}
    for launcher, (mod, fn) in KERNEL_OPS.items():
        out[launcher] = getattr(
            importlib.import_module(f"{_PKG}.{mod}"), fn)
    return out


@contextlib.contextmanager
def recording(trace: Trace):
    """Record into ``trace`` every kernel-wrapper call (wherever the
    package binds the wrapper: ``from .x import f`` copies the name) and
    every aten op of the glue between them.  Inside a wrapper nothing
    else is recorded: its plain version (CPU) or launch (card) is the
    op."""
    import torch
    from torch.utils._python_dispatch import (
        TorchDispatchMode,
        _disable_current_modes,
    )

    depth = [0]
    in_read = [0]
    card = torch.cuda.is_available()

    def hazard(rule, msg):
        if depth[0]:
            return
        trace.hazards.append((rule, msg))
        if card and torch.cuda.is_current_stream_capturing():
            # Stop before the sync runs: a sync inside a capture is a
            # CUDA error that would outlive this check.
            raise RuntimeError(f"host read inside a CUDA-graph capture: {msg}")

    def wrap(launcher, fn):
        def recorded(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            try:
                with _disable_current_modes():
                    out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            trace.ops.append((
                "kernel", launcher,
                (_sig(args), _sig(sorted(kwargs.items())), _sig(out)),
            ))
            return out

        recorded.__wrapped__ = fn
        return recorded

    class _Glue(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if depth[0]:
                return func(*args, **(kwargs or {}))
            name = str(func)
            base = name.split(".")[1] if "." in name else name
            if base in _SCALAR_READS and not in_read[0]:
                hazard("R8", f"{name} reads a scalar to the host "
                             f"(int()/float()/bool() or a Python branch "
                             f"on a tensor)")
            elif base in _DATA_SHAPED or (
                    base == "index" and _bool_index(args)):
                hazard("R8", f"{name} has a data-dependent output shape")
            out = func(*args, **(kwargs or {}))
            trace.ops.append(("aten", name, _sig(out)))
            return out

    def _bool_index(args):
        idx = args[1] if len(args) > 1 else ()
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in idx or ())

    def read(meth, orig):
        def host_read(self, *a, **k):
            hazard("R9", f"Tensor.{meth}() reads the tensor to the host")
            in_read[0] += 1
            try:
                return orig(self, *a, **k)
            finally:
                in_read[0] -= 1

        return host_read

    patched = []
    try:
        for launcher, fn in _wrappers().items():
            w = wrap(launcher, fn)
            for name, mod in list(sys.modules.items()):
                if mod is None or not (
                        name == _PKG or name.startswith(_PKG + ".")):
                    continue
                for attr, val in list(vars(mod).items()):
                    if val is fn:
                        patched.append((mod, attr, val))
                        setattr(mod, attr, w)
        for meth in _HOST_READS:
            orig = getattr(torch.Tensor, meth)
            patched.append((torch.Tensor, meth, orig))
            setattr(torch.Tensor, meth, read(meth, orig))
        with _Glue():
            yield trace
    finally:
        for obj, attr, val in reversed(patched):
            setattr(obj, attr, val)


# --- one traced call, on the CPU or captured on the card -------------------

def resolve(device=None):
    """The device of a check: None is the card (raises without one),
    anything else is named."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Capture:
    """One traced call: its trace, outputs, inputs and, on the card, the
    graph captured over those inputs and the launches it holds."""

    def __init__(self, trace, outs, ins, graph=None, held=None):
        self.trace = trace
        self.outs = outs
        self.ins = ins
        self.graph = graph
        self.held = held or []

    def launches(self) -> dict[str, int]:
        return {k.symbol: n for k, n in self.held}


def trace_call(fn, args, device, capture: bool = True) -> Capture:
    """Trace ``fn(*args)`` on ``device``: a recorded eager call on the
    CPU (or with ``capture=False``); on the card one eager warm call on a
    side stream (the first launches load the kernels, as
    ``_CudaGraphFn`` does), then a recorded ``torch.cuda.graph`` capture
    over the same inputs.  A capture that fails raises: the caller's
    finding."""
    import torch

    from .. import kernels

    trace = Trace()
    if device.type != "cuda" or not capture:
        with recording(trace):
            outs = fn(*args)
        return Capture(trace, outs, args)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn(*args)
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    box = {}

    def run():
        # Record inside the capture: its prologue's ops (the generator's
        # seed and offset tensors, made on a process's first capture and
        # filled on every one) are the graph's, not the call's.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"), \
                recording(trace):
            box["outs"] = fn(*args)

    held = kernels.captured_by(run)
    return Capture(trace, box["outs"], args, graph, held)


def _first_difference(c1: Capture, c2: Capture) -> str:
    """Where two traces of one call part: the first differing op, or the
    launches their graphs hold."""
    a, b = c1.trace.ops, c2.trace.ops
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"op {i}: {x} vs {y}"
    if len(a) != len(b):
        return f"{len(a)} vs {len(b)} ops"
    return f"launches {c1.launches()} vs {c2.launches()}"


def _outputs(out) -> tuple:
    import torch

    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


# --- model cases ----------------------------------------------------------

def _model_cases(device):
    """Tiny-but-representative models per engine family, each touching
    every tier the builders have (literal, prefix, regex, header)."""
    from ..models.base import SeamProbe
    from ..models.dns import build_dns_model_from_rows
    from ..models.http import build_http_model
    from ..models.r2d2 import build_r2d2_model_from_rows
    from ..policy.api import PortRuleHTTP
    from ..proxylib.parsers.dns import DnsRule

    http = build_http_model([
        (frozenset(), PortRuleHTTP(method="GET", path="/api/v1/.*")),
        (frozenset({7}), PortRuleHTTP(method="GET|HEAD",
                                      path="/x/[a-z]+",
                                      host="example[.]com")),
        (frozenset({3}), PortRuleHTTP()),
    ], device=device)
    r2d2 = build_r2d2_model_from_rows([
        (frozenset(), "OPEN", "/etc/.*"),
        (frozenset({3}), "", "docs/[a-z]+[.]txt"),
        (frozenset({3, 9}), "RETR", ""),
    ], device=device)
    dns = build_dns_model_from_rows([
        (frozenset(), DnsRule(name="www.example.com")),
        (frozenset({3}), DnsRule(pattern="*.svc.cluster.local")),
        (frozenset({3, 9}), DnsRule(regex="internal[.](a|b)")),
        (frozenset({7}), None),
    ], device=device)
    return [
        ("http", f"{_PKG}/models/http.py", http),
        ("r2d2", f"{_PKG}/models/r2d2.py", r2d2),
        ("dns", f"{_PKG}/models/dns.py", dns),
        ("seam_probe", f"{_PKG}/models/base.py", SeamProbe(device)),
    ]


_FRAMES = (
    b"OPEN /etc/passwd\r\n", b"RETR docs/a.txt\r\n",
    b"GET /api/v1/x HTTP/1.1\r\nHost: example.com\r\n\r\n",
    b"\x00\x10\x12\x34\x01\x00\x00\x01\x00\x00\x00\x00\x00\x00"
    b"\x03www\x07example\x03com\x00\x00\x01\x00\x01",
)


def batch(device, b: int = _BATCH, w: int = _WIDTH, seed: int = 0):
    """(data uint8 [b, w], lengths int32 [b], remotes int32 [b]) on
    ``device``: the families' frames and random bytes, made from
    ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (b, w), dtype=np.uint8)
    lengths = rng.integers(0, w + 1, b).astype(np.int32)
    for i in range(b):
        k = i % (len(_FRAMES) + 1)  # every fifth row stays random
        if k < len(_FRAMES) and len(_FRAMES[k]) <= w:
            data[i, :len(_FRAMES[k])] = np.frombuffer(_FRAMES[k], np.uint8)
            lengths[i] = len(_FRAMES[k])
    remotes = rng.choice(np.array([0, 3, 7, 9], np.int32), b)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (data, lengths, remotes))


def _check_model(name, path, model, device=None, captures=None):
    """R8, R9 and R11 on one model; ``captures`` (a list) collects the
    plain and attributed captures."""
    import torch

    dev = resolve(device) if device is not None else _model_device(model)
    args = batch(dev)
    findings = []

    def fail(rule, msg):
        findings.append(Finding(
            rule, path, 0, 0, f"[device-contract:{name}] {msg}",
            symbol=name,
        ))

    def hazards(tr, what):
        for rule, msg in dict.fromkeys(tr.hazards):
            fail(rule, f"{what}: {msg} — a sync the capture refuses, "
                       f"and on an eager call a per-batch host round "
                       f"trip")

    # R8 / R9: the call traces (captures) at all, twice, identically.
    try:
        c1 = trace_call(model.__call__, args, dev)
        c2 = trace_call(model.__call__, args, dev)
    except Exception as e:  # noqa: BLE001 — any trace failure is the finding
        fail("R9" if dev.type == "cuda" else "R8",
             f"verdict model failed to trace: {e!r}")
        return findings
    if c1.trace.ops != c2.trace.ops or c1.launches() != c2.launches():
        fail("R8", "two traces of the verdict model produced DIFFERENT "
                   "op sequences — capture-time nondeterminism (wall "
                   "clock / rng / iteration order) and a new graph per "
                   "dispatch on the hot path; "
                   + _first_difference(c1, c2))
    hazards(c1.trace, "verdict call")
    outs = _outputs(c1.outs)
    want = (torch.bool, torch.int32, torch.bool)
    got = tuple(getattr(o, "dtype", None) for o in outs)
    if got != want:
        fail("R8", f"verdict outputs have dtypes {got}, contract is "
                   f"{want} (complete, msg_len, allow): an output dtype "
                   f"that follows the inputs keys a separate graph per "
                   f"caller dtype mix")
    if captures is not None:
        captures.append((f"{name}.plain", model.__call__, c1))

    # R11: fused attribution — arity 4, int32 rule row, bounded epilogue.
    if not hasattr(model, "verdicts_attr"):
        return findings
    try:
        ca = trace_call(model.verdicts_attr, args, dev)
    except Exception as e:  # noqa: BLE001
        fail("R11", f"verdicts_attr failed to trace: {e!r}")
        return findings
    hazards(ca.trace, "attributed call")
    outs = _outputs(ca.outs)
    if len(outs) != 4:
        fail("R11", f"verdicts_attr returns {len(outs)} outputs, "
                    f"contract is 4 (complete, len, allow, rule)")
    elif outs[3].dtype != torch.int32:
        fail("R11", f"attribution rule row dtype is {outs[3].dtype}, "
                    f"contract is int32 (the wire packs <i4)")
    n_plain, n_attr = len(c1.trace.ops), len(ca.trace.ops)
    plain_k, attr_k = c1.trace.kernel_counts(), ca.trace.kernel_counts()
    again = sorted(k for k, n in attr_k.items() if n > plain_k.get(k, 0))
    if again or n_attr > n_plain + ATTR_EXTRA_OPS:
        fail("R11", f"verdicts_attr traces to {n_attr} ops vs {n_plain} "
                    f"for the plain verdict (+{ATTR_EXTRA_OPS} allowed)"
                    + (f", running {again} more often" if again else "")
                    + ": attribution is recomputing the hit matrix — a "
                      "SECOND device pass the parity tests cannot see")
    if dev.type == "cuda" and ca.launches() != c1.launches():
        fail("R11", f"the attributed graph holds {ca.launches()} "
                    f"launches, the plain graph {c1.launches()}: a "
                    f"second device pass")
    if captures is not None:
        captures.append((f"{name}.attr", model.verdicts_attr, ca))
    return findings


def _model_device(model):
    return getattr(model, "device", None) or resolve("cpu")


# --- R10: sharded steps ---------------------------------------------------

# Mesh aspect ratios the R10 gate runs every sharded step on — both axes
# alone and together, and the 4-wide flow extents the reshape ladder
# lands on (4 -> 2 -> 1).  Every one is a mesh of virtual slots on the
# checked device.
_SHARD_MESHES = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2))

_SHARD_PATH = f"{_PKG}/parallel/rulesharding.py"


def _tables(obj, prefix: str = ""):
    """(name, shape, dtype) of a shard model's declared tables: the
    tensors of its init fields, nested automata included (the indexes
    ``__post_init__`` derives from the content are sized by it)."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        yield (prefix, tuple(obj.shape), str(obj.dtype))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.init:
                yield from _tables(getattr(obj, f.name),
                                   f"{prefix}.{f.name}" if prefix else f.name)


def check_stacked_model(stacked, mesh) -> list[str]:
    """R10 structural half: one shard model a rule slot of ``mesh``, and
    every shard's tables the same shapes and dtypes — the
    split-balanced + pad_tables contract that gives every slot the same
    launches.  Returns problem strings."""
    from ..parallel.mesh import RULE_AXIS

    n = mesh.shape[RULE_AXIS]
    probs = []
    if len(stacked) != n:
        probs.append(f"{len(stacked)} shard model(s) for a RULE_AXIS "
                     f"extent of {n} (unbalanced shard stack)")
    if stacked:
        first = list(_tables(stacked[0]))
        for j, m in enumerate(stacked[1:], start=1):
            if list(_tables(m)) != first:
                probs.append(f"shard {j}'s tables differ in shape from "
                             f"shard 0's (unpadded shard stack)")
    return probs


def _slot_traces(model, args, dev, kafka: bool, attr: bool):
    """The trace of each slot's own step (slot model, its flow block),
    recorded eagerly."""
    from ..parallel.mesh import FLOW_AXIS, RULE_AXIS, flow_sharding
    from ..parallel.rulesharding import _FAMILY_FNS

    mesh = model.mesh
    n_flow, n_rule = mesh.shape[FLOW_AXIS], mesh.shape[RULE_AXIS]
    out = {}
    if kafka:
        from ..models import kafka as kafka_mod
        from ..models.kafka import KafkaRequestBatch

        b, rem = args
        names = list(b.__dataclass_fields__)
        blocks = {k: flow_sharding(mesh, getattr(b, k)) for k in names}
        rems = flow_sharding(mesh, rem)
        for i in range(n_flow):
            blk = KafkaRequestBatch(**{k: blocks[k][i] for k in names})
            for j in range(n_rule):
                out[(i, j)] = trace_call(
                lambda m, x, r: kafka_mod.kafka_hits(m, x, r, parts=True),
                (model.slots[i][j], blk, rems[i]), dev, False).trace
        return out
    fn = _FAMILY_FNS[model.family][1 if attr else 0]
    blocks = [flow_sharding(mesh, x) for x in args]
    for i in range(n_flow):
        for j in range(n_rule):
            out[(i, j)] = trace_call(
                fn, (model.slots[i][j],) + tuple(b[i] for b in blocks),
                dev, False).trace
    return out


def _check_step(tag, step, args, n_out, model, dev, fail, kafka=False,
                captures=None):
    """Trace one sharded step twice and hold it to the R10 contract;
    returns its kernel-op name set (None when it failed)."""
    from ..parallel.mesh import FLOW_AXIS

    try:
        c1 = trace_call(step, args, dev)
        c2 = trace_call(step, args, dev)
    except Exception as e:  # noqa: BLE001
        fail(f"[device-contract:{tag}] failed to run — the per-slot "
             f"fan-out drifted from the step functions' signatures or "
             f"shard arity: {e!r}")
        return None
    outs = _outputs(c1.outs)
    if len(outs) != n_out:
        fail(f"[device-contract:{tag}] expected {n_out} outputs, got "
             f"{len(outs)}")
    if n_out == 4 and len(outs) == 4 and str(outs[3].dtype) != \
            "torch.int32":
        fail(f"[device-contract:{tag}] global first-match rule row dtype "
             f"is {outs[3].dtype}, contract is int32")
    if c1.trace.ops != c2.trace.ops:
        fail(f"[device-contract:{tag}] two traces produced DIFFERENT op "
             f"sequences — nondeterminism recaptures per mesh in "
             f"production; {_first_difference(c1, c2)}")
    for _rule, msg in dict.fromkeys(c1.trace.hazards):
        fail(f"[device-contract:{tag}] stepped body: {msg} — a device->"
             f"host sync inside the mesh round")
    slots = _slot_traces(model, args, dev, kafka, attr=n_out == 4)
    first = next(iter(slots.values()))
    for key, tr in slots.items():
        if tr.kernel_ops() != first.kernel_ops():
            fail(f"[device-contract:{tag}] slot {key}'s launches differ "
                 f"from slot (0, 0)'s — an unbalanced shard stack")
    want: dict[str, int] = {}
    for tr in slots.values():
        for k, n in tr.kernel_counts().items():
            want[k] = want.get(k, 0) + n
    merges = model.mesh.shape[FLOW_AXIS]
    got = c1.trace.kernel_counts()
    merged = {k: got.pop(k) for k in list(got) if k in _MERGE_OPS}
    if got != want or sum(merged.values()) != merges:
        fail(f"[device-contract:{tag}] the step launches "
             f"{c1.trace.kernel_counts()}, its slots {want} plus "
             f"{merges} merge(s): a slot stepped twice or skipped")
    if captures is not None:
        captures.append((tag, step, c1))
    return frozenset(op[1] for op in c1.trace.kernel_ops())


def shard_cases(device):
    """The sharded steps of every ``_SHARD_MESHES`` mesh of virtual slots
    on ``device``: (tag, step, sharded model, args, n_out, kafka), plus
    the (tag, stack, mesh) shard stacks they are built from."""
    import torch

    from ..kafka.request import RequestMessage
    from ..models.dns import build_dns_model_from_rows
    from ..models.kafka import build_kafka_model, encode_requests
    from ..models.r2d2 import build_r2d2_model_from_rows
    from ..parallel import rulesharding
    from ..parallel.mesh import flow_mesh, virtual_devices
    from ..policy.api import PortRuleKafka
    from ..proxylib.parsers.dns import DnsRule

    model = build_r2d2_model_from_rows([
        (frozenset(), "OPEN", "/etc/.*"),
        (frozenset({3}), "", "docs/[a-z]+"),
    ], device=device)
    dmodel = build_dns_model_from_rows([
        (frozenset(), DnsRule(name="www.example.com")),
        (frozenset({3}), DnsRule(pattern="*.example.com")),
    ], device=device)
    kr = PortRuleKafka(topic="orders")
    kr.sanitize()
    kmodel = build_kafka_model([(frozenset(), kr)], device)
    kbatch = encode_requests(
        [RequestMessage(0, 2, 1, "c", ["orders"], parsed=True)] * _BATCH
    ).to_device(device)
    krem = torch.ones(_BATCH, dtype=torch.int32, device=device)
    rows = batch(device)
    cases, stacks = [], []
    for n_flow, n_rule in _SHARD_MESHES:
        mesh = flow_mesh(n_flow=n_flow, n_rule=n_rule,
                         devices=virtual_devices(n_flow * n_rule, device))
        at = f"{n_flow}x{n_rule}"
        for fam, m in (("stacked", model), ("dns-stacked", dmodel),
                       ("kafka-stacked", kmodel)):
            stacks.append((f"{fam}@{at}", [m] * n_rule, mesh))
        offsets = rulesharding.shard_offsets(2, n_rule)
        sv = rulesharding.ShardedVerdictModel(
            [model] * n_rule, offsets, mesh, "r2d2")
        sd = rulesharding.ShardedVerdictModel(
            [dmodel] * n_rule, offsets, mesh, "dns")
        sk = rulesharding.ShardedKafkaModel([kmodel] * n_rule, mesh)
        cases.extend((f"{name}@{at}", step, sm, args, n_out, kafka)
                     for name, step, sm, args, n_out, kafka in (
            ("sharded_verdict_step", sv.__call__, sv, rows, 3, False),
            ("sharded_verdict_step_attr", sv.verdicts_attr, sv, rows, 4,
             False),
            ("sharded_dns_step", sd.__call__, sd, rows, 3, False),
            ("sharded_dns_step_attr", sd.verdicts_attr, sd, rows, 4, False),
            ("sharded_kafka_step", sk.__call__, sk, (kbatch, krem), 1,
             True),
        ))
    return cases, stacks


def case_calls(device) -> dict[str, tuple]:
    """{tag: (fn, args)} of every model call and sharded step the gate
    traces, built on ``device``: the card's captures' twins on the CPU
    (their kernels' plain versions) for a replay check."""
    out = {}
    args = batch(device)
    for name, _path, model in _model_cases(device):
        out[f"{name}.plain"] = (model.__call__, args)
        out[f"{name}.attr"] = (model.verdicts_attr, args)
    for tag, step, _m, sargs, _n, _k in shard_cases(device)[0]:
        out[tag] = (step, sargs)
    return out


def _check_sharded(device=None, captures=None):
    """R10: every sharded step runs on every ``_SHARD_MESHES`` mesh of
    virtual slots and holds the contract of ``_check_step``; every shard
    stack is balanced; the kernel-op set of a step must not depend on
    the mesh."""
    dev = resolve(device)
    findings = []

    def fail(msg):
        findings.append(Finding("R10", _SHARD_PATH, 0, 0, msg))

    cases, stacks = shard_cases(dev)
    for tag, stacked, mesh in stacks:
        for prob in check_stacked_model(stacked, mesh):
            fail(f"[device-contract:{tag}] {prob}")
    op_sets: dict[str, dict] = {}
    for tag, step, smodel, args, n_out, kafka in cases:
        ops = _check_step(tag, step, args, n_out, smodel, dev, fail, kafka,
                          captures)
        if ops is None:
            continue
        name, _, at = tag.partition("@")
        prev = op_sets.setdefault(name, {})
        for other, oops in prev.items():
            if ops != oops:
                fail(f"[device-contract:{name}] kernel-op set differs "
                     f"between meshes {other} and {at}: "
                     f"{sorted(ops ^ oops)} — the stepped computation's "
                     f"structure must not depend on the shard count")
        prev[at] = ops
    return findings


def check_reshape_ladder(build=None, device=None) -> list[Finding]:
    """R10 reshape half: every DEGRADED rung the width ladder can land
    on (lose a slot, reshape over the survivors — flow extent 4 -> 2 ->
    1 at a preserved-or-halved rule extent) assembles through
    ``mesh_model_from_family_rows`` and steps with the SAME structure
    as full width: a balanced shard stack for the rung's RULE_AXIS,
    offsets for as many shards, a retained single-card fallback twin
    (the next demotion's landing rung), two identical traces, no host
    sync, and a width-INDEPENDENT kernel-op set — a reshape may change
    shapes, never the stepped computation.  ``build`` is the assembly
    seam under audit, injectable so the sensitivity test can pin that a
    broken reshape model fails here.  The full width is a 4x2 mesh of
    eight virtual slots."""
    from ..parallel import rulesharding
    from ..parallel.mesh import (
        FLOW_AXIS,
        RULE_AXIS,
        flow_mesh,
        reshape_mesh,
        virtual_devices,
    )
    from ..proxylib.parsers.dns import DnsRule

    if build is None:
        build = rulesharding.mesh_model_from_family_rows
    dev = resolve(device)
    findings: list[Finding] = []

    def fail(msg):
        findings.append(Finding("R10", _SHARD_PATH, 0, 0, msg))

    family_rows = {
        "r2d2": [
            (frozenset(), "OPEN", "/etc/.*"),
            (frozenset({3}), "", "docs/[a-z]+"),
            (frozenset({7}), "READ", "/pub/.*"),
        ],
        "dns": [
            (frozenset(), DnsRule(name="www.example.com")),
            (frozenset({3}), DnsRule(pattern="*.example.com")),
        ],
    }
    devices = virtual_devices(8, dev)
    n_rule, n_flow = 2, 4
    full = flow_mesh(n_flow=n_flow, n_rule=n_rule, devices=devices)
    rungs = [("full", full)]
    seen = {(n_flow, n_rule)}
    survivors = list(devices)
    while len(survivors) > 1:
        survivors = survivors[:-1]
        rung = reshape_mesh(survivors, n_rule,
                            max_flow=full.shape[FLOW_AXIS])
        if rung is None:
            break
        key = (rung.shape[FLOW_AXIS], rung.shape[RULE_AXIS])
        if key in seen:
            continue
        seen.add(key)
        rungs.append((f"{key[0]}x{key[1]}", rung))
    args = batch(dev)
    op_sets: dict[str, dict] = {}
    for rung_name, mesh in rungs:
        for family, rows in family_rows.items():
            tag = f"reshape:{family}@{rung_name}"
            try:
                model = build(family, rows, mesh)
            except Exception as e:  # noqa: BLE001
                fail(f"[device-contract:{tag}] reshaped assembly "
                     f"raised: {e!r}")
                continue
            if not isinstance(model, rulesharding.ShardedVerdictModel):
                fail(f"[device-contract:{tag}] assembly folded to "
                     f"{type(model).__name__} — these rows must build "
                     f"a mesh-resident model at every rung")
                continue
            for prob in check_stacked_model(model.stacked, mesh):
                fail(f"[device-contract:{tag}] {prob}")
            if model.n_shards != mesh.shape[RULE_AXIS]:
                fail(f"[device-contract:{tag}] shard_offsets arity "
                     f"{model.n_shards} != rung RULE_AXIS extent "
                     f"{mesh.shape[RULE_AXIS]} (stale full-width "
                     f"offsets would mis-attribute global rule rows)")
            if model.fallback is None:
                fail(f"[device-contract:{tag}] reshaped model carries "
                     f"no single-card fallback twin — the NEXT device "
                     f"loss on this rung would have nothing to demote "
                     f"to")
            try:
                c1 = trace_call(model.verdicts_attr, args, dev)
                c2 = trace_call(model.verdicts_attr, args, dev)
            except Exception as e:  # noqa: BLE001
                fail(f"[device-contract:{tag}] failed to run the "
                     f"reshaped attributed step: {e!r}")
                continue
            if c1.trace.ops != c2.trace.ops:
                fail(f"[device-contract:{tag}] two traces produced "
                     f"DIFFERENT op sequences — a nondeterministic "
                     f"reshape rebuild recaptures per fault in "
                     f"production; {_first_difference(c1, c2)}")
            for _rule, msg in dict.fromkeys(c1.trace.hazards):
                fail(f"[device-contract:{tag}] stepped body: {msg}")
            ops = frozenset(op[1] for op in c1.trace.kernel_ops())
            prev = op_sets.setdefault(family, {})
            for other, oops in prev.items():
                if ops != oops:
                    fail(f"[device-contract:reshape:{family}] kernel-op "
                         f"set differs between rungs {other} and "
                         f"{rung_name}: {sorted(ops ^ oops)} — a "
                         f"degraded width must change shapes, not the "
                         f"stepped computation")
            prev[rung_name] = ops
    return findings


def check_device_contracts(device=None, captures=None) -> list[Finding]:
    """Run every device-contract check; returns findings (empty = all
    contracts hold).  ``device=None`` is the card (raises without one);
    ``device="cpu"`` records op traces on the CPU.  ``captures`` (a
    list) collects (tag, fn, Capture) of every model and sharded step
    traced, for a caller that replays the graphs."""
    dev = resolve(device)
    findings: list[Finding] = []
    for name, path, model in _model_cases(dev):
        findings.extend(_check_model(name, path, model, dev, captures))
    findings.extend(_check_sharded(dev, captures))
    findings.extend(check_reshape_ladder(device=dev))
    findings.extend(check_shape_closure(dev))
    return findings


# --- R16: shape-closure audit ---------------------------------------------
#
# "No new graph shapes" is a gate, not prose: enumerate the DECLARED
# shape universe (the service's MIN_BUCKET pow2 ladder, pack_buckets'
# width ladder, the MIN_RULE_BUCKET churn buckets, the mesh shard
# extents, bounded by SHAPE_CACHE_MAX), drive the serving surface
# through the service's dispatch seam, and assert the set of shapes
# that reached it is CLOSED under that universe.  A future engine that
# ships an unbucketed axis — one raw batch size, one unpadded rule
# table — fails HERE instead of silently recapturing per shape on the
# hot path.

_AXIS_CAP = 1 << 22


def _pow2_set(floor: int, cap: int = _AXIS_CAP) -> frozenset:
    out = set()
    v = int(floor)
    while v <= cap:
        out.add(v)
        v *= 2
    return frozenset(out)


def enumerate_shape_universe() -> dict:
    """The statically-declared shape universe, resolved from the SAME
    constants the serving path derives its shapes from (a second copy
    could drift and silently unpair the gate)."""
    from ..models.r2d2 import MIN_RULE_BUCKET
    from ..sidecar.service import VerdictService
    from ..utils import defaults

    return {
        # Dispatch batch (flow) axis: pow2 from the greedy floor; the
        # remote floor (MIN_BUCKET) and every pack_buckets f_pad are
        # members by construction.
        "flows": _pow2_set(VerdictService.MIN_BUCKET_GREEDY),
        # Row width axis: pack_buckets widens base_width << k.
        "widths": _pow2_set(defaults.BATCH_WIDTH),
        # Rule-table churn buckets (models/r2d2.MIN_RULE_BUCKET).
        "rules": _pow2_set(MIN_RULE_BUCKET),
        # Mesh shard extents: pow2, flow extent capped at the
        # smallest dispatch bucket so every bucket divides it.
        "mesh": _pow2_set(1, VerdictService.MIN_BUCKET_GREEDY),
        "cache_max": VerdictService.SHAPE_CACHE_MAX,
    }


_R16_PATH = f"{_PKG}/sidecar/service.py"


def audit_traced_shapes(traced, universe) -> list[Finding]:
    """R16 closure primitive: every traced shape's (flows, width) axes
    must be members of the enumerated universe (a captured graph is the
    port's executable).  ``traced`` is an iterable of (tag, path,
    n_flows_or_None, width_or_None)."""
    findings = []
    for tag, path, n_flows, width in traced:
        if n_flows is not None and n_flows not in universe["flows"]:
            findings.append(Finding(
                "R16", path, 0, 0,
                f"[shape-closure:{tag}] traced executable batch axis "
                f"{n_flows} is OUTSIDE the declared bucket universe "
                f"(pow2 ladder from MIN_BUCKET_GREEDY): this shape "
                f"re-traces every time it recurs on the hot path",
                symbol=tag,
            ))
        if width is not None and width not in universe["widths"]:
            findings.append(Finding(
                "R16", path, 0, 0,
                f"[shape-closure:{tag}] traced executable row width "
                f"{width} is OUTSIDE the declared width ladder "
                f"(batch_width << k): an unbucketed width axis keys a "
                f"new executable per frame size",
                symbol=tag,
            ))
    return findings


def _bare_shape_key(model):
    """The churn cache's key derivation (the service's
    ``_model_shape_key``): the bare dispatch model's type and the
    (name, shape, dtype) of its tensors, or None when the model is not
    shape-keyed."""
    from ..sidecar.service import _tensor_signature

    bare_fn = getattr(model, "dispatch_bare", None)
    if bare_fn is None:
        return None
    bare = bare_fn()
    return (type(bare).__name__, tuple(_tensor_signature(bare)))


def audit_rule_axis(tag: str, path: str, build) -> list[Finding]:
    """Rule-axis churn closure: same-bucket rebuilds must key the SAME
    graph.  ``build(n)`` builds an n-rule model; 2 and 3 rules share
    the MIN_RULE_BUCKET bucket, so their shape keys must be identical —
    an unbucketed builder keys a new graph per rule count, i.e. a full
    recapture on every policy churn."""
    k2 = _bare_shape_key(build(2))
    k3 = _bare_shape_key(build(3))
    if k2 is None or k3 is None:
        return [Finding(
            "R16", path, 0, 0,
            f"[shape-closure:{tag}] model exposes no dispatch_bare "
            f"shape key — the shape-keyed churn cache cannot cover it",
            symbol=tag,
        )]
    if k2 != k3:
        return [Finding(
            "R16", path, 0, 0,
            f"[shape-closure:{tag}] rule axis is UNBUCKETED: a 2-rule "
            f"and a 3-rule table key DIFFERENT graphs — every policy "
            f"churn recaptures instead of hitting the shape-keyed "
            f"cache; pad the row axis to the MIN_RULE_BUCKET "
            f"power-of-two ladder",
            symbol=tag,
        )]
    return []


class _SeamRecorder:
    """Records the (flows, width) of every call that reaches the
    service's dispatch seam (``_model_call``, ``_model_call_attr``,
    ``_gathered_call``; the outermost call only), tagged by the family
    and role the caller sets."""

    def __init__(self, svc, width: int):
        self.svc = svc
        self.width = width
        self.seen: list[tuple] = []
        self.label = None
        self._depth = 0
        self._orig = {}
        for name in ("_model_call", "_model_call_attr", "_gathered_call"):
            fn = getattr(svc, name)
            self._orig[name] = fn
            setattr(svc, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def seam(model, data, *rest, **kw):
            if not self._depth and self.label is not None:
                if name == "_gathered_call":
                    flows, width = rest[0].shape[0], self.width
                else:
                    flows, width = data.shape[0], data.shape[1]
                self.seen.append((self.label, int(flows), int(width)))
            self._depth += 1
            try:
                return fn(model, data, *rest, **kw)
            finally:
                self._depth -= 1

        return seam

    def close(self):
        for name, fn in self._orig.items():
            setattr(self.svc, name, fn)


def _graph_shapes(svc, model) -> set[tuple]:
    """(role, flows, width) of every CUDA graph the service captured for
    ``model``: the ``_CudaGraphFn.graphs`` keys of its caches."""
    out = set()
    for role, cache in (("plain", svc._jit_cache), ("attr", svc._jit_attr),
                        ("gather", svc._jit_gather)):
        ent = cache.get(id(model))
        if ent is None:
            continue
        for sig in ent[1].graphs:
            if role == "gather":
                out.add((role, sig[1][0][0], svc.config.batch_width))
            else:
                out.add((role, sig[0][0][0], sig[0][0][1]))
    return out


def check_shape_closure(device=None, traced_out=None) -> list[Finding]:
    """R16 device half: drive the serving surface — r2d2, DNS and HTTP
    single-card and sharded, plain and attributed — through a
    ``VerdictService``'s dispatch seam (a prewarm, then one round at
    each of the two smallest flow buckets and widths), Kafka (which no
    service engine serves) through its model call, plus the real
    pack_buckets packer over adversarial frame lengths, and assert every
    shape that reached the seam is a member of the enumerated universe,
    the distinct-shape count fits SHAPE_CACHE_MAX, and the shape-keyed
    rule axes are churn-closed.  On the card the shapes are the keys of
    the CUDA graphs the service captured, and every seam call must have
    gone through one.  ``traced_out`` (a list) receives the traced set
    as (tag, path, flows, width)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from ..kafka.request import RequestMessage
    from ..models.dns import build_dns_model_from_rows
    from ..models.http import build_http_model
    from ..models.kafka import build_kafka_model, encode_requests
    from ..models.r2d2 import build_r2d2_model_from_rows
    from ..parallel import rulesharding
    from ..parallel.mesh import FLOW_AXIS, RULE_AXIS, flow_mesh, virtual_devices
    from ..policy.api import PortRuleHTTP, PortRuleKafka
    from ..proxylib.parsers.dns import DnsRule
    from ..sidecar.reasm import Reassembler
    from ..sidecar.service import VerdictService
    from ..utils import defaults
    from ..utils.option import DaemonConfig

    dev = resolve(device)
    universe = enumerate_shape_universe()
    findings: list[Finding] = []
    traced: list[tuple] = []
    exes: set = set()

    # Rule-axis probes hold the regex VOCABULARY fixed across n: the
    # automaton state/class axes legitimately scale with the compiled
    # pattern set, so only the row axis may vary here — that is the
    # axis MIN_RULE_BUCKET declares closed.
    def rows_r2d2(n):
        return [(frozenset({i}), "", "/p/.*") for i in range(n)]

    def rows_dns(n):
        return [
            (frozenset({i}), DnsRule(name="w.example.com"))
            for i in range(n)
        ]

    r2 = build_r2d2_model_from_rows(rows_r2d2(2), bucket=True, device=dev)
    dn = build_dns_model_from_rows(rows_dns(2), bucket=True, device=dev)
    ht = build_http_model([
        (frozenset(), PortRuleHTTP(method="GET", path="/api/.*")),
        (frozenset({3}), PortRuleHTTP()),
    ], device=dev)
    kr = PortRuleKafka(topic="orders")
    kr.sanitize()
    km = build_kafka_model([(frozenset(), kr)], dev)
    mods = {f: f"{_PKG}/models/{f}.py"
            for f in ("r2d2", "dns", "http", "kafka")}

    b0 = VerdictService.MIN_BUCKET_GREEDY
    w0 = defaults.BATCH_WIDTH

    def fail(tag, path, e):
        findings.append(Finding(
            "R16", path, 0, 0,
            f"[shape-closure:{tag}] serving-surface call failed: {e!r}",
            symbol=tag,
        ))

    def zeros(b, w):
        return (np.zeros((b, w), np.uint8), np.zeros(b, np.int32),
                np.zeros(b, np.int32))

    # The single-card and sharded surface through one greedy service's
    # dispatch seam: flow buckets b0 and 2 * b0, CUDA graphs on the card.
    cfg = DaemonConfig(
        verdict_device="cpu" if dev.type == "cpu" else "default",
        dispatch_mode="jit", batch_timeout_ms=0, batch_width=w0,
        batch_flows=2 * b0, flow_observe=True, mesh="off",
    )
    surfaces = [(name, model, mods[name], False)
                for name, model in (("r2d2", r2), ("dns", dn), ("http", ht))]
    shard_meshes = []
    for n_flow, n_rule in ((1, 2), (2, 1), (2, 2)):
        mesh = flow_mesh(n_flow=n_flow, n_rule=n_rule,
                         devices=virtual_devices(n_flow * n_rule, dev))
        shard_meshes.append((n_flow, n_rule, mesh))
        for axis, extent in (("flows", mesh.shape[FLOW_AXIS]),
                             ("rules", mesh.shape[RULE_AXIS])):
            if extent not in universe["mesh"]:
                findings.append(Finding(
                    "R16", _SHARD_PATH, 0, 0,
                    f"[shape-closure:mesh@{n_flow}x{n_rule}] {axis} "
                    f"shard extent {extent} is outside the declared "
                    f"mesh universe (pow2, flow extent <= the "
                    f"smallest dispatch bucket)",
                ))
        offsets = rulesharding.shard_offsets(2, n_rule)
        for name, model in (("r2d2", r2), ("dns", dn)):
            surfaces.append((
                f"{name}@{n_flow}x{n_rule}",
                rulesharding.ShardedVerdictModel(
                    [model] * n_rule, offsets, mesh, name),
                _SHARD_PATH, True,
            ))
    with tempfile.TemporaryDirectory(prefix="devicecheck-") as tmp:
        svc = VerdictService(os.path.join(tmp, "vs.sock"), cfg).start()
        seam = _SeamRecorder(svc, w0)
        try:
            for name, model, path, sharded in surfaces:
                base, _, at = name.partition("@")
                plain = f"{base}.sharded@{at}" if sharded else None
                attr = f"{base}.sharded_attr@{at}" if sharded else None
                try:
                    if not sharded:
                        # A prewarm, as an engine build runs it.
                        seam.label = "attr"
                        svc._prewarm_model(model)
                    shapes = [(b0, w0)] if sharded else [
                        (b, w) for b in (b0, 2 * b0) for w in (w0, 2 * w0)]
                    for b, w in shapes:
                        seam.label = "plain"
                        out = svc._model_call(model, *zeros(b, w))
                        _host(out[-1])
                        seam.label = "attr"
                        out = svc._model_call_attr(model, *zeros(b, w))
                        _host(out[2])
                except Exception as e:  # noqa: BLE001 — a failed surface gates
                    fail(name, path, e)
                    continue
                finally:
                    seam.label = None
                got = {(role, f, w) for role, f, w in seam.seen}
                seam.seen.clear()
                if dev.type == "cuda":
                    graphs = _graph_shapes(svc, model)
                    if got != graphs:
                        findings.append(Finding(
                            "R16", path, 0, 0,
                            f"[shape-closure:{name}] the dispatch seam "
                            f"saw {sorted(got)} but the service holds "
                            f"graphs for {sorted(graphs)}: a dispatch "
                            f"that bypassed (or a capture beside) the "
                            f"graph cache",
                            symbol=name,
                        ))
                    got = graphs
                for role, f, w in sorted(got):
                    tag = (({"plain": plain, "attr": attr}[role])
                           if sharded else f"{base}.{role}@{f}x{w}")
                    traced.append((tag, path, f, w))
                    exes.add(tag)
            if svc._mesh_demoted is not None:
                findings.append(Finding(
                    "R16", _SHARD_PATH, 0, 0,
                    "[shape-closure] a sharded dispatch failed and "
                    "the service demoted to its fallback",
                ))
        finally:
            seam.close()
            svc.stop()

    # Kafka: no service engine serves it; its model call is its seam.
    kbatch = encode_requests(
        [RequestMessage(0, 2, 1, "c", ["orders"], parsed=True)] * b0
    ).to_device(dev)
    krem = torch.ones(b0, dtype=torch.int32, device=dev)
    kafka_calls = [(f"kafka.plain@{b0}", mods["kafka"], km)]
    for n_flow, n_rule, mesh in shard_meshes:
        kafka_calls.append((
            f"kafka.sharded@{n_flow}x{n_rule}", _SHARD_PATH,
            rulesharding.ShardedKafkaModel([km] * n_rule, mesh)))
    for tag, path, model in kafka_calls:
        try:
            c = trace_call(model, (kbatch, krem), dev)
        except Exception as e:  # noqa: BLE001
            fail(tag, path, e)
            continue
        traced.append((tag, path, int(_outputs(c.outs)[0].shape[0]), None))
        exes.add(tag)

    # The real packer's output shapes over adversarial frame lengths
    # (minimal, exact-width, width+1, a multi-bucket jump) must land in
    # the same universe the dispatch caches enumerate.
    reasm = Reassembler()
    frame_lens = [2, w0, w0 + 1, 4 * w0 + 5, 17]
    payloads = [b"x" * (fl - 2) + b"\r\n" for fl in frame_lens]
    lens = np.array([len(p) for p in payloads], np.int64)
    ends = np.cumsum(lens)
    rnd = reasm.ingest(
        np.arange(1, len(payloads) + 1, dtype=np.int64),
        ends - lens, lens,
        np.frombuffer(b"".join(payloads), np.uint8),
    )
    for _fi, data, _lengths, _rem in reasm.pack_buckets(
        rnd, w0, b0, np.zeros(len(payloads), np.int32)
    ):
        f_pad, wv = data.shape
        traced.append((f"pack_buckets@{f_pad}x{wv}",
                       f"{_PKG}/sidecar/reasm.py", int(f_pad), int(wv)))

    if traced_out is not None:
        traced_out.extend(traced)
    findings.extend(audit_traced_shapes(traced, universe))
    if len(exes) > universe["cache_max"]:
        findings.append(Finding(
            "R16", _R16_PATH, 0, 0,
            f"[shape-closure] {len(exes)} distinct serving-surface "
            f"graphs exceed SHAPE_CACHE_MAX={universe['cache_max']} — "
            f"the graph cache would thrash-evict on the hot path",
        ))
    findings.extend(audit_rule_axis(
        "r2d2.rule-axis", mods["r2d2"],
        lambda n: build_r2d2_model_from_rows(rows_r2d2(n), bucket=True,
                                             device=dev),
    ))
    findings.extend(audit_rule_axis(
        "dns.rule-axis", mods["dns"],
        lambda n: build_dns_model_from_rows(rows_dns(n), bucket=True,
                                            device=dev),
    ))
    return findings


def _host(x):
    from ..sidecar.service import _to_host

    return _to_host(x)
