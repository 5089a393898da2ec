"""Declared typestates and protocol registries — ONE source of truth.

Every safety-critical state machine the runtime grew over PRs 11-17
(session containment, the device-guard latch, the mesh width ladder,
the flow-cache arm lifecycle, the policy-epoch stage/commit path, the
shim grant rows) is declared here as data: states, allowed edges, and
the typed outcome (metric / counter token) each edge must emit.  The
runtime IMPORTS these tables and routes every transition through
:meth:`Typestate.advance` / :meth:`Typestate.guard` /
:meth:`Typestate.require_edges` — an undeclared transition raises
:class:`ProtocolViolation` at runtime, and the R18 lint pass proves by
AST+callgraph that every assignment to a declared state field is a
mediated, declared edge whose site emits its declared outcome.  Delete
an edge here and BOTH halves fail: the checker flags the now-invalid
site and the runtime transition raises fail-closed.

Also declared here, for the same one-definition reason:

- ``COLUMN_STORES`` — the shared numpy column families and the lock
  that owns each (R19 held-lock discipline over every write);
- ``WIRE_MESSAGES`` — the per-``MSG_*`` lifecycle table: direction,
  reply pairing, fire-and-forget flag, version/flag gating (R20);
- ``NATIVE_MIRRORS`` — the native-shim enum constants that must stay
  bit-identical to their Python twins (R20);
- ``ENGINE_FAMILIES`` — the ROADMAP "landing bar" registry: model +
  host oracle + every-offset parity test + bench config + stress-mix
  slice per registered ``reasm.FRAMINGS`` engine family (R21);
- ``FAIL_CLOSED`` — the declared fail-closed surface: every typestate
  edge (plus the two non-typestate markers) that narrows a serving
  tier, and therefore must both reach the flight recorder and trigger
  a postmortem bundle (R22).

Serving-path cost: everything in this module is an import-time
constant.  ``advance``/``guard`` are two dict lookups and run only at
transition sites (session containment, policy swaps, cache arm/disarm,
mesh rungs) — control-plane events, never inside the per-entry verdict
loop.  The R7/R12 passes keep that claim checked (BENCH_NOTES r08).
"""

from __future__ import annotations


class ProtocolViolation(RuntimeError):
    """An undeclared typestate transition was attempted at runtime."""


# -- transition observer (flight recorder hook) ---------------------------
#
# ONE process-wide hook, installed by the sidecar flight recorder
# (``sidecar/blackbox.py``).  Every mediated transition that VALIDATES
# (advance/guard/require_edges) reports ``(table, frm, to, outcome)``
# here AFTER the edge check — an undeclared edge still raises before
# any observation happens.  The hook is ``None`` by default, so the
# unobserved cost is one attribute load + ``is None`` test at each
# (control-plane) transition site, and its invocation is contained: a
# broken observer can never turn a legal transition into a failure.
# This module must stay importable without the sidecar package — the
# recorder pushes its callback in; nothing here imports it.

_TRANSITION_OBSERVER = None


def set_transition_observer(fn) -> None:
    """Install (or clear, with ``None``) the process-wide transition
    observer.  Called by the flight recorder at service start/stop;
    analysis-side code never sets it."""
    global _TRANSITION_OBSERVER
    _TRANSITION_OBSERVER = fn


def _observe(name, frm, to, outcome) -> None:
    obs = _TRANSITION_OBSERVER
    if obs is None:
        return
    try:
        obs(name, frm, to, outcome)
    except Exception:  # noqa: BLE001 -- observer faults must never fail a legal transition
        pass


class Typestate:
    """A declarative transition table.

    ``states`` is the closed state vocabulary; ``initial`` the
    construction-time state; ``edges`` maps ``(frm, to)`` to the typed
    outcome the transition site must emit — ``None`` for a declared-
    silent edge, a token string, or a tuple of acceptable tokens.
    ``values`` maps state names to the stored representation (identity
    for string-state attributes, small ints for numpy columns); a
    PARTIAL values map is legal for value-carrying columns (e.g. the
    grant-epoch column, where "armed" stores the live epoch and only
    the tombstone value is fixed) — such protocols are mediated through
    :meth:`guard` instead of :meth:`advance`.

    ``kind`` tells the R18 checker how stores look in the AST:
    ``"attr"`` (``obj.field = ...``), ``"column"`` (``self.field[...]
    = ...`` numpy subscript), ``"key"`` (``row["field"] = ...``), or
    ``"derived"`` (no stored field — the state is computed from other
    fields and transition sites call :meth:`advance` for validation
    only).
    """

    __slots__ = ("name", "owner", "field", "kind", "states", "initial",
                 "edges", "values", "_by_value")

    def __init__(self, name: str, owner: str, field: str, kind: str,
                 states, initial, edges: dict, values: dict | None = None):
        self.name = name
        self.owner = owner
        self.field = field
        self.kind = kind
        self.states = tuple(states)
        self.initial = initial
        self.edges = dict(edges)
        self.values = (dict(values) if values is not None
                       else {s: s for s in self.states})
        sset = set(self.states)
        if initial not in sset:
            raise ProtocolViolation(
                f"{name}: initial state {initial!r} not in states"
            )
        for frm, to in self.edges:
            if frm not in sset or to not in sset:
                raise ProtocolViolation(
                    f"{name}: edge ({frm!r} -> {to!r}) names an "
                    f"undeclared state"
                )
        for s in self.values:
            if s not in sset:
                raise ProtocolViolation(
                    f"{name}: value mapped for undeclared state {s!r}"
                )
        self._by_value = {v: s for s, v in self.values.items()}

    # -- runtime mediation -------------------------------------------------

    def value(self, state):
        """The stored representation of ``state``."""
        try:
            return self.values[state]
        except KeyError:
            raise ProtocolViolation(
                f"{self.name}: state {state!r} has no declared stored "
                f"value"
            ) from None

    def state_of(self, value):
        """The state name behind a stored value (numpy scalars
        normalized)."""
        try:
            return self._by_value[value]
        except (KeyError, TypeError):
            pass
        item = getattr(value, "item", None)
        if item is not None:
            try:
                return self._by_value[item()]
            except (KeyError, TypeError):
                pass
        raise ProtocolViolation(
            f"{self.name}: stored value {value!r} maps to no declared "
            f"state"
        )

    def advance(self, cur_value, to):
        """Validate the transition from the CURRENT stored value to
        state ``to`` and return ``to``'s stored value — the one
        expression a mediated store site uses::

            self.state = SESSION_PROTOCOL.advance(self.state,
                                                  SESSION_DEAD)
        """
        frm = self.state_of(cur_value)
        if (frm, to) not in self.edges:
            raise ProtocolViolation(
                f"{self.name}: undeclared transition "
                f"{frm!r} -> {to!r}"
            )
        if _TRANSITION_OBSERVER is not None:
            _observe(self.name, frm, to, self.edges[(frm, to)])
        return self.value(to)

    def guard(self, frm, to, value):
        """Validate a declared edge and pass ``value`` through — the
        mediation for value-carrying columns where the stored value is
        dynamic (the grant epoch) and the edge is statically known at
        the site."""
        if (frm, to) not in self.edges:
            raise ProtocolViolation(
                f"{self.name}: undeclared transition "
                f"{frm!r} -> {to!r}"
            )
        if _TRANSITION_OBSERVER is not None:
            _observe(self.name, frm, to, self.edges[(frm, to)])
        return value

    def require_edges(self, frms, to):
        """Validate every ``frm -> to`` edge of a BULK store (slice
        assign / ``.fill``) and return ``to``'s stored value::

            tab[tab != 0] = FLOW_CACHE_PROTOCOL.require_edges(
                (CACHE_ARMED, CACHE_DECLINED), CACHE_UNARMED)
        """
        for frm in frms:
            if (frm, to) not in self.edges:
                raise ProtocolViolation(
                    f"{self.name}: undeclared transition "
                    f"{frm!r} -> {to!r}"
                )
        if _TRANSITION_OBSERVER is not None:
            for frm in frms:
                _observe(self.name, frm, to, self.edges[(frm, to)])
        return self.value(to)


# =========================================================================
# State vocabularies.  The session constants are the SAME objects the
# transport module re-exports — one definition, everywhere.
# =========================================================================

# Fan-in session containment (transport.SessionState.state).
SESSION_ACTIVE = "active"
SESSION_QUARANTINED = "quarantined"
SESSION_DEAD = "dead"

# Device-guard quarantine latch (guard.DeviceGuard._latch).
GUARD_SERVING = "serving"
GUARD_QUARANTINED = "quarantined"

# Per-device health rows (guard.DeviceGuard._devices[key]["state"]).
DEVICE_OK = "ok"
DEVICE_LOST = "lost"

# Mesh width-ladder rung, DERIVED from (_mesh_demoted, _mesh_serving).
MESH_FULL = "full"
MESH_RESHAPED = "reshaped"
MESH_FALLBACK = "fallback"

# Flow-cache arm lifecycle (service._tab_cache column values).
CACHE_UNARMED = "unarmed"
CACHE_ARMED = "armed"
CACHE_DECLINED = "declined"

# Policy-epoch swap job (service._SwapJob.phase).
SWAP_STAGED = "staged"
SWAP_COMMITTED = "committed"
SWAP_REJECTED = "rejected"

# Shim grant rows (client._grant_epoch column; "armed" stores the live
# epoch — value-carrying, mediated via guard()/require_edges()).
GRANT_NONE = "none"
GRANT_ARMED = "armed"

GRANT_TOMBSTONE = -1  # the one fixed stored value ("none")


# =========================================================================
# Typestate tables (R18).
# =========================================================================

SESSION_PROTOCOL = Typestate(
    name="session",
    owner="SessionState",
    field="state",
    kind="attr",
    states=(SESSION_ACTIVE, SESSION_QUARANTINED, SESSION_DEAD),
    initial=SESSION_ACTIVE,
    edges={
        (SESSION_ACTIVE, SESSION_QUARANTINED): "SidecarSessionQuarantines",
        (SESSION_QUARANTINED, SESSION_QUARANTINED):
            "SidecarSessionQuarantines",
        # Lazy heal when the quarantine window passes: declared-silent
        # (the open of the window was the counted event).
        (SESSION_QUARANTINED, SESSION_ACTIVE): None,
        (SESSION_ACTIVE, SESSION_DEAD): "SidecarSessionDeaths",
        (SESSION_QUARANTINED, SESSION_DEAD): "SidecarSessionDeaths",
    },
)

DEVICE_GUARD_PROTOCOL = Typestate(
    name="device_guard",
    owner="DeviceGuard",
    field="_latch",
    kind="attr",
    states=(GUARD_SERVING, GUARD_QUARANTINED),
    initial=GUARD_SERVING,
    edges={
        (GUARD_SERVING, GUARD_QUARANTINED): "quarantine_events",
        (GUARD_QUARANTINED, GUARD_SERVING): "_quarantined_total_s",
    },
)

MESH_DEVICE_PROTOCOL = Typestate(
    name="mesh_device",
    owner="DeviceGuard",
    field="state",
    kind="key",
    states=(DEVICE_OK, DEVICE_LOST),
    initial=DEVICE_OK,
    edges={
        (DEVICE_OK, DEVICE_LOST): "faults",
        (DEVICE_LOST, DEVICE_LOST): "faults",
        (DEVICE_LOST, DEVICE_OK): "heals",
    },
)

MESH_LADDER_PROTOCOL = Typestate(
    name="mesh_ladder",
    owner="VerdictService",
    field="",
    kind="derived",
    states=(MESH_FULL, MESH_RESHAPED, MESH_FALLBACK),
    initial=MESH_FULL,
    edges={
        (MESH_FULL, MESH_FALLBACK): "MeshDemotions",
        (MESH_RESHAPED, MESH_FALLBACK): "MeshDemotions",
        (MESH_FULL, MESH_RESHAPED): "mesh_reshapes",
        (MESH_FALLBACK, MESH_RESHAPED): "mesh_reshapes",
        (MESH_RESHAPED, MESH_RESHAPED): "mesh_reshapes",
        (MESH_FALLBACK, MESH_FULL): "mesh_repromotions",
        (MESH_RESHAPED, MESH_FULL): "mesh_repromotions",
    },
)

FLOW_CACHE_PROTOCOL = Typestate(
    name="flow_cache",
    owner="VerdictService",
    field="_tab_cache",
    kind="column",
    states=(CACHE_UNARMED, CACHE_ARMED, CACHE_DECLINED),
    initial=CACHE_UNARMED,
    values={CACHE_UNARMED: 0, CACHE_ARMED: 1, CACHE_DECLINED: 2},
    edges={
        (CACHE_UNARMED, CACHE_ARMED): None,
        (CACHE_ARMED, CACHE_ARMED): None,
        (CACHE_DECLINED, CACHE_ARMED): None,
        (CACHE_UNARMED, CACHE_DECLINED): None,
        (CACHE_DECLINED, CACHE_DECLINED): None,
        (CACHE_ARMED, CACHE_DECLINED): "VerdictCacheInvalidations",
        (CACHE_ARMED, CACHE_UNARMED): (
            "VerdictCacheEvictions", "VerdictCacheInvalidations",
            "cache_invalidations",
        ),
        (CACHE_DECLINED, CACHE_UNARMED): None,
        (CACHE_UNARMED, CACHE_UNARMED): None,
    },
)

EPOCH_SWAP_PROTOCOL = Typestate(
    name="epoch_swap",
    owner="_SwapJob",
    field="phase",
    kind="attr",
    states=(SWAP_STAGED, SWAP_COMMITTED, SWAP_REJECTED),
    initial=SWAP_STAGED,
    edges={
        (SWAP_STAGED, SWAP_COMMITTED): "_commit_epoch",
        (SWAP_STAGED, SWAP_REJECTED): "_swap_failed",
    },
)

GRANT_PROTOCOL = Typestate(
    name="shim_grant",
    owner="SidecarClient",
    field="_grant_epoch",
    kind="column",
    states=(GRANT_NONE, GRANT_ARMED),
    initial=GRANT_NONE,
    values={GRANT_NONE: GRANT_TOMBSTONE},
    edges={
        (GRANT_NONE, GRANT_ARMED): None,
        (GRANT_ARMED, GRANT_ARMED): None,
        (GRANT_ARMED, GRANT_NONE): None,
        (GRANT_NONE, GRANT_NONE): None,
    },
)


# =========================================================================
# Declared fail-closed surface (R22).  Every row here is an event that
# NARROWS a serving tier — the transitions an operator reconstructing
# an incident must be able to see.  ``kind="edge"`` rows name a
# declared typestate edge (validated against the tables above at
# import time); ``kind="marker"`` rows name the two fail-closed events
# with no typestate table, recorded via ``blackbox.record_mark`` /
# ``blackbox.broadcast_mark``.  The flight recorder arms a postmortem
# bundle on every row, and the R22 lint pass proves each row reaches a
# recorder emit site — a declared fail-closed edge invisible to the
# recorder is a finding.
# =========================================================================

FAIL_CLOSED = (
    {"kind": "edge", "table": "session",
     "edge": (SESSION_ACTIVE, SESSION_QUARANTINED)},
    {"kind": "edge", "table": "session",
     "edge": (SESSION_QUARANTINED, SESSION_QUARANTINED)},
    {"kind": "edge", "table": "session",
     "edge": (SESSION_ACTIVE, SESSION_DEAD)},
    {"kind": "edge", "table": "session",
     "edge": (SESSION_QUARANTINED, SESSION_DEAD)},
    {"kind": "edge", "table": "device_guard",
     "edge": (GUARD_SERVING, GUARD_QUARANTINED)},
    {"kind": "edge", "table": "mesh_device",
     "edge": (DEVICE_OK, DEVICE_LOST)},
    {"kind": "edge", "table": "mesh_device",
     "edge": (DEVICE_LOST, DEVICE_LOST)},
    {"kind": "edge", "table": "mesh_ladder",
     "edge": (MESH_FULL, MESH_FALLBACK)},
    {"kind": "edge", "table": "mesh_ladder",
     "edge": (MESH_RESHAPED, MESH_FALLBACK)},
    # Reshapes are descents only when entered from a WIDER rung; the
    # fallback -> reshaped edge is an ascent (heal) and is excluded.
    {"kind": "edge", "table": "mesh_ladder",
     "edge": (MESH_FULL, MESH_RESHAPED)},
    {"kind": "edge", "table": "mesh_ladder",
     "edge": (MESH_RESHAPED, MESH_RESHAPED)},
    {"kind": "edge", "table": "epoch_swap",
     "edge": (SWAP_STAGED, SWAP_REJECTED)},
    {"kind": "marker", "token": "shm_demotion"},
    {"kind": "marker", "token": "kvstore_degraded"},
)

# Runtime lookup forms: the recorder checks membership per transition.
FAIL_CLOSED_EDGES = frozenset(
    (row["table"],) + tuple(row["edge"])
    for row in FAIL_CLOSED if row["kind"] == "edge"
)
FAIL_CLOSED_MARKERS = frozenset(
    row["token"] for row in FAIL_CLOSED if row["kind"] == "marker"
)

_PROTOCOLS_BY_NAME = {
    p.name: p
    for p in (SESSION_PROTOCOL, DEVICE_GUARD_PROTOCOL,
              MESH_DEVICE_PROTOCOL, MESH_LADDER_PROTOCOL,
              FLOW_CACHE_PROTOCOL, EPOCH_SWAP_PROTOCOL, GRANT_PROTOCOL)
}

for _row in FAIL_CLOSED:
    if _row["kind"] == "edge":
        _p = _PROTOCOLS_BY_NAME.get(_row["table"])
        if _p is None or tuple(_row["edge"]) not in _p.edges:
            raise ProtocolViolation(
                f"FAIL_CLOSED: row {_row!r} names an undeclared table "
                f"or edge"
            )
        del _p
    elif _row["kind"] != "marker":
        raise ProtocolViolation(
            f"FAIL_CLOSED: row {_row!r} has an unknown kind"
        )
del _row


# =========================================================================
# Column-store lock discipline (R19).  Every write to a column whose
# attribute name starts with ``prefix`` on a ``owner`` instance must be
# reachable only with ``lock`` held (lexically or through every
# project call site).  ``unlocked_ok`` waives the check with a
# recorded justification (the arena is single-writer by construction).
# =========================================================================

COLUMN_STORES = (
    {"name": "conn_table", "owner": "VerdictService",
     "prefix": "_tab_", "lock": "_lock", "unlocked_ok": None},
    {"name": "shim_grants", "owner": "SidecarClient",
     "prefix": "_grant_", "lock": "_glock", "unlocked_ok": None},
    {"name": "reasm_arena", "owner": "ByteArena",
     "prefix": "s_", "lock": None,
     "unlocked_ok": "single-writer: the arena is owned by the reasm "
                    "pass on the dispatch thread; no concurrent "
                    "mutator exists by construction"},
)


# =========================================================================
# Wire-protocol lifecycle table (R20).  One row per MSG_* constant:
# direction ("c2s" client->service, "s2c" service->client, "peer"
# service<->service over the handoff dial), the declared reply message
# (None for fire-and-forget), whether the reply is DEFERRED (answered
# by a later dispatcher round, not the handler chain), and the
# flag/version gate tokens both seam ends must reference.
# =========================================================================

WIRE_MESSAGES = {
    "MSG_OPEN_MODULE": {
        "dir": "c2s", "reply": "MSG_MODULE_ID", "fnf": False,
        "deferred": False, "gates": ()},
    "MSG_MODULE_ID": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_NEW_CONNECTION": {
        "dir": "c2s", "reply": "MSG_CONN_RESULT", "fnf": False,
        "deferred": False, "gates": ("CONN_FLAG_RETAINED",)},
    "MSG_CONN_RESULT": {
        "dir": "s2c", "reply": None, "fnf": True, "deferred": False,
        "gates": ("CONN_RESULT_FLAG_RESIDUE_ADOPTED",)},
    "MSG_DATA_BATCH": {
        "dir": "c2s", "reply": "MSG_VERDICT_BATCH", "fnf": False,
        "deferred": True, "gates": ()},
    "MSG_DATA_BATCH_DL": {
        "dir": "c2s", "reply": "MSG_VERDICT_BATCH", "fnf": False,
        "deferred": True, "gates": ()},
    "MSG_DATA_MATRIX": {
        "dir": "c2s", "reply": "MSG_VERDICT_BATCH", "fnf": False,
        "deferred": True, "gates": ()},
    "MSG_VERDICT_BATCH": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_VERDICT_MULTI": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_CLOSE": {
        "dir": "c2s", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_POLICY_UPDATE": {
        "dir": "c2s", "reply": "MSG_ACK", "fnf": False,
        "deferred": False, "gates": ()},
    "MSG_ACK": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_STATUS": {
        "dir": "c2s", "reply": "MSG_STATUS_REPLY", "fnf": False,
        "deferred": False, "gates": ()},
    "MSG_STATUS_REPLY": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_TRACE": {
        "dir": "c2s", "reply": "MSG_TRACE_REPLY", "fnf": False,
        "deferred": False, "gates": ()},
    "MSG_TRACE_REPLY": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_OBSERVE": {
        "dir": "c2s", "reply": "MSG_OBSERVE_REPLY", "fnf": False,
        "deferred": False, "gates": ()},
    "MSG_OBSERVE_REPLY": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_SHM_ATTACH": {
        "dir": "c2s", "reply": "MSG_SHM_ATTACH_REPLY", "fnf": False,
        "deferred": False, "gates": ()},
    "MSG_SHM_ATTACH_REPLY": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_SHM_DOORBELL": {
        "dir": "c2s", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_SHM_CREDIT": {
        "dir": "s2c", "reply": None, "fnf": True, "deferred": False,
        "gates": ("CREDIT_FLAG_QUARANTINED",)},
    "MSG_SHM_DETACH": {
        "dir": "c2s", "reply": "MSG_ACK", "fnf": False,
        "deferred": False, "gates": ("DETACH_FLAG_NO_ACK",)},
    "MSG_CACHE_ENABLE": {
        "dir": "c2s", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_CACHE_GRANT": {
        "dir": "s2c", "reply": None, "fnf": True, "deferred": False,
        "gates": ("CACHE_FLAG_ALLOW",)},
    "MSG_CACHE_REVOKE": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_SESSION_HELLO": {
        "dir": "c2s", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_HANDOFF": {
        "dir": "peer", "reply": "MSG_HANDOFF_REPLY", "fnf": False,
        "deferred": False, "gates": ("HANDOFF_VERSION",)},
    "MSG_HANDOFF_REPLY": {
        "dir": "peer", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_TIMELINE": {
        "dir": "c2s", "reply": "MSG_TIMELINE_REPLY", "fnf": False,
        "deferred": False, "gates": ()},
    "MSG_TIMELINE_REPLY": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
    "MSG_LEDGER": {
        "dir": "c2s", "reply": "MSG_LEDGER_REPLY", "fnf": False,
        "deferred": False, "gates": ()},
    "MSG_LEDGER_REPLY": {
        "dir": "s2c", "reply": None, "fnf": True,
        "deferred": False, "gates": ()},
}

# Native-shim coexistence: the C header's enum constants mirror the
# Python IntEnums member-for-member on every SHARED name (the Python
# side may extend beyond the ABI range — FilterResult >= 8 stays
# fail-closed on old consumers by construction, so a header that lags
# on the extensions is fine; a VALUE mismatch on a shared name is not).
NATIVE_MIRRORS = (
    {"header": "native/cilium_tpu_shim.h",
     "prefix": "CT_FILTEROP_", "enum": "OpType"},
    {"header": "native/cilium_tpu_shim.h",
     "prefix": "CT_FILTER_", "enum": "FilterResult"},
)


# =========================================================================
# Parity-coverage registry (R21).  One row per registered
# ``reasm.FRAMINGS`` engine family: the ROADMAP landing bar says each
# family ships a device model, a host oracle, an every-offset parity
# test, a bench config, and a stress-mix slice — this registry makes
# that bar machine-checked, so a future TLS-SNI/HTTP2 engine cannot
# land half-covered.  ``parity_test`` rows use ``file::name`` so two
# families sharing a test NAME still each pin their own FILE.
# =========================================================================

ENGINE_FAMILIES = (
    {"kind": "crlf",
     "model": "models/r2d2.py",
     "oracle": "proxylib/parsers/r2d2.py",
     "parity_test": "test_reasm.py::test_columnar_parity_every_byte_offset",
     "bench_config": "r2d2",
     "stress_slice": "MixBench"},
    {"kind": "dns",
     "model": "models/dns.py",
     "oracle": "proxylib/parsers/dns.py",
     "parity_test": "test_dns.py::test_columnar_parity_every_byte_offset",
     "bench_config": "dns",
     "stress_slice": "_stress_dns_pattern"},
)
