"""Memcached batch verdict model — device-side (command/opcode, key) ACL.

Counterpart of ``cilium_tpu/models/memcached.py``.  Replaces the
per-request rule walk of the reference's memcached parsers (reference:
proxylib/memcached/parser.go:47-110 Rule.Matches) with one device pass
over pre-framed requests:

  allow[f] = OR_r ( remote_ok AND (empty_rule OR (cmd_ok AND
                                                  (no_key OR key_ok))) )

- cmd_ok: binary flows index a [R, 256] opcode table; text flows index
  a [R, NCMDS] command table over the global text-command vocabulary
  (MEMCACHE_OPCODE_MAP); empty rules match everything
- key_ok by rule mode: exact (span equality), prefix (span starts-with),
  regex (K2 ``dfa_scan`` or K3 ``nfa_scan`` on the key span, only when
  some rule has a keyRegex), or none
- multi-key frames (text multi-get) are judged host-side — the device
  path covers the <= 1 key case, the overwhelming steady state; callers
  fall back on overflow exactly like the Kafka topic path

On the card the ACL itself is kernel K11 ``memcache_hits``.  Framing
(header fields, token split, reply sequencing, denial-inject ordering)
stays host-side in the streaming parsers.  The host compile and the
encoder are copies of the reference's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from ..ops.bytescan import spans_equal_prefix, spans_start_with
from ..ops.rxsearch import DeviceDfa, DeviceNfa, automaton_search_spans, compile_automaton
from ..proxylib.parsers.memcached import MEMCACHE_OPCODE_MAP, MemcacheRule
from ..proxylib.policy import CompiledPortRules, PolicyInstance
from .base import MAX_REMOTES, ConstVerdict, VerdictModel, pack_remote_sets, remote_ok

MAX_KEY = 96

# Global text-command vocabulary (order fixed at import): every text
# command any rule group can allow.  Flows carry an index into this.
TEXT_COMMANDS: tuple[str, ...] = tuple(
    sorted({c for text, _ in MEMCACHE_OPCODE_MAP.values() for c in text})
)
TEXT_COMMAND_INDEX = {c: i for i, c in enumerate(TEXT_COMMANDS)}

KEY_MODE_NONE = 0
KEY_MODE_EXACT = 1
KEY_MODE_PREFIX = 2
KEY_MODE_REGEX = 3

_MEMCACHE_HITS = kernels.CudaKernel(
    "memcache_hits", "memcache_hits",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


@dataclass
class MemcacheBatchModel(VerdictModel):
    nfa: "DeviceDfa | DeviceNfa | None"  # keyRegex rows; None: no such row
    op_tab: torch.Tensor  # [R, 256] bool — allowed binary opcodes
    cmd_tab: torch.Tensor  # [R, NCMDS] bool — allowed text commands
    empty_rule: torch.Tensor  # [R] bool — matches anything
    key_mode: torch.Tensor  # [R] int32
    key_needle: torch.Tensor  # [R, MAX_KEY] uint8
    key_needle_len: torch.Tensor  # [R] int32
    remote_ids: torch.Tensor  # [R, MAX_REMOTES] int32
    any_remote: torch.Tensor  # [R] bool

    def __post_init__(self):
        # K11 reads these tables as they are: check them once, here.
        device = self.device
        chk = kernels.check
        chk(self.key_mode, "key_mode", torch.int32, (None,), device)
        r = self.key_mode.shape[0]
        chk(self.op_tab, "op_tab", torch.bool, (r, 256), device)
        chk(self.cmd_tab, "cmd_tab", torch.bool, (r, None), device)
        if self.cmd_tab.shape[1] < 1:
            raise ValueError("cmd_tab: expected at least one text command column")
        chk(self.empty_rule, "empty_rule", torch.bool, (r,), device)
        chk(self.key_needle, "key_needle", torch.uint8, (r, MAX_KEY), device)
        chk(self.key_needle_len, "key_needle_len", torch.int32, (r,), device)
        chk(self.remote_ids, "remote_ids", torch.int32, (r, MAX_REMOTES), device)
        chk(self.any_remote, "any_remote", torch.bool, (r,), device)
        if self.nfa is not None and (
            self.nfa.device != device or self.nfa.n_patterns != r
        ):
            raise ValueError("nfa: expected one pattern per rule row on the model's device")

    @property
    def device(self) -> torch.device:
        return self.key_needle.device

    @property
    def n_rules(self) -> int:
        return self.key_mode.shape[0]

    def __call__(self, key_data, key_len, has_key, is_binary, opcode,
                 cmd_id, remotes):
        return memcache_verdicts(
            self, key_data, key_len, has_key, is_binary, opcode, cmd_id,
            remotes,
        )


def _collect_rows(rules: CompiledPortRules):
    rows = []  # (remote_set, MemcacheRule | None)
    for rule in rules.rules:
        matchers = rule.l7_matchers or [None]
        for m in matchers:
            if m is not None and not isinstance(m, MemcacheRule):
                raise TypeError(f"not a memcache rule: {m!r}")
            rows.append((rule.allowed_remotes, m))
    return rows


def build_memcache_model(
    policy: PolicyInstance | None, ingress: bool, port: int, device=None
) -> ConstVerdict | MemcacheBatchModel:
    """Port-cascade build onto ``device`` (None: the CUDA card; reference:
    policymap.go:208-236).  The automaton is compiled only when some row
    has a keyRegex; the reference compiles one for every model, but a row
    in another key mode never reads it."""
    device = resolve_device(device)
    if policy is None:
        return ConstVerdict(False)
    side = policy.ingress if ingress else policy.egress
    rows = []
    for key in (port, 0):
        rules = side.by_port.get(key)
        if rules is None:
            continue
        if not rules.have_l7_rules or not rules.rules:
            return ConstVerdict(True)
        rows.extend(_collect_rows(rules))
    if not rows:
        return ConstVerdict(False)

    packed_ids, any_remote = pack_remote_sets([r[0] for r in rows])
    n = len(rows)
    op_tab = np.zeros((n, 256), bool)
    cmd_tab = np.zeros((n, len(TEXT_COMMANDS)), bool)
    empty_rule = np.zeros((n,), bool)
    key_mode = np.zeros((n,), np.int32)
    key_needle = np.zeros((n, MAX_KEY), np.uint8)
    key_needle_len = np.zeros((n,), np.int32)
    patterns = []
    for i, (_, m) in enumerate(rows):
        if m is None or m.empty:
            empty_rule[i] = True
            patterns.append("")
            continue
        for op in m.bin_opcodes:
            op_tab[i, op] = True
        for c in m.text_cmds:
            cmd_tab[i, TEXT_COMMAND_INDEX[c]] = True
        if m.key_exact:
            key_mode[i] = KEY_MODE_EXACT
            needle = m.key_exact
        elif m.key_prefix:
            key_mode[i] = KEY_MODE_PREFIX
            needle = m.key_prefix
        elif m.key_compiled is not None:
            key_mode[i] = KEY_MODE_REGEX
            needle = b""
        else:
            key_mode[i] = KEY_MODE_NONE
            needle = b""
        if len(needle) > MAX_KEY:
            raise ValueError(
                f"memcache key needle exceeds MAX_KEY ({len(needle)})"
            )
        key_needle[i, : len(needle)] = np.frombuffer(needle, np.uint8)
        key_needle_len[i] = len(needle)
        patterns.append(m.key_regex if key_mode[i] == KEY_MODE_REGEX else "")

    def up(a):
        return torch.from_numpy(a).to(device)

    return MemcacheBatchModel(
        nfa=(compile_automaton(patterns, device)
             if (key_mode == KEY_MODE_REGEX).any() else None),
        op_tab=up(op_tab),
        cmd_tab=up(cmd_tab),
        empty_rule=up(empty_rule),
        key_mode=up(key_mode),
        key_needle=up(key_needle),
        key_needle_len=up(key_needle_len),
        remote_ids=up(packed_ids),
        any_remote=up(any_remote),
    )


def encode_memcache_batch(frames, f_pad: int | None = None):
    """Host-side batch packing: [(is_binary, opcode, command, keys)] ->
    device arrays + overflow flags.  overflow marks frames the device
    path cannot judge (multi-key, oversized key, unknown text command);
    callers fall back to the host oracle for those."""
    n = len(frames)
    f = f_pad or n
    key_data = np.zeros((f, MAX_KEY), np.uint8)
    key_len = np.zeros((f,), np.int32)
    has_key = np.zeros((f,), bool)
    is_binary = np.zeros((f,), bool)
    opcode = np.zeros((f,), np.int32)
    cmd_id = np.zeros((f,), np.int32)
    overflow = np.zeros((n,), bool)
    for i, (binary, op, command, keys) in enumerate(frames):
        if len(keys) > 1:
            overflow[i] = True
            continue
        key = keys[0] if keys else None
        if key is not None and len(key) > MAX_KEY:
            overflow[i] = True
            continue
        is_binary[i] = binary
        if binary:
            opcode[i] = op
        else:
            idx = TEXT_COMMAND_INDEX.get(command)
            if idx is None:
                overflow[i] = True
                continue
            cmd_id[i] = idx
        if key is not None:
            has_key[i] = True
            if key:
                key_data[i, : len(key)] = np.frombuffer(key, np.uint8)
            key_len[i] = len(key)
    return key_data, key_len, has_key, is_binary, opcode, cmd_id, overflow


# --- kernel K11: the ACL ----------------------------------------------------


def _gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A table column index as the reference's gather takes it: a negative
    index counts from the end, then the index is clamped into [0, n)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def memcache_rule_hits_plain(model: MemcacheBatchModel, key_data, key_len,
                             has_key, is_binary, opcode, cmd_id, rx,
                             remotes) -> torch.Tensor:
    """[F, R] bool: rule row r allows frame f
    (``cilium_tpu/models/memcached.py:209-246`` after the automaton)."""
    op_ok = model.op_tab[:, _gather_index(opcode, 256)].T  # [F, R]
    cmd_ok_text = model.cmd_tab[:, _gather_index(cmd_id, model.cmd_tab.shape[1])].T
    cmd_ok = torch.where(is_binary[:, None], op_ok, cmd_ok_text)

    zeros = torch.zeros_like(key_len)
    exact = spans_equal_prefix(
        key_data, zeros, key_len, model.key_needle, model.key_needle_len
    )
    prefix = spans_start_with(
        key_data, zeros, key_len, model.key_needle, model.key_needle_len
    )
    regex = rx if rx is not None else torch.zeros_like(exact)
    mode = model.key_mode[None, :]
    key_ok = torch.where(
        mode == KEY_MODE_EXACT,
        exact,
        torch.where(
            mode == KEY_MODE_PREFIX,
            prefix,
            torch.where(mode == KEY_MODE_REGEX, regex, torch.ones_like(exact)),
        ),
    )
    key_ok = ~has_key[:, None] | key_ok

    rem = remote_ok(remotes, model.remote_ids, model.any_remote)
    l7_ok = model.empty_rule[None, :] | (cmd_ok & key_ok)
    return rem & l7_ok


def memcache_hits_plain(model: MemcacheBatchModel, key_data, key_len, has_key,
                        is_binary, opcode, cmd_id, rx, remotes) -> torch.Tensor:
    """Plain PyTorch version of K11: allow [F] bool."""
    return memcache_rule_hits_plain(
        model, key_data, key_len, has_key, is_binary, opcode, cmd_id, rx,
        remotes,
    ).any(dim=1)


def memcache_hits(model: MemcacheBatchModel, key_data, key_len, has_key,
                  is_binary, opcode, cmd_id, rx, remotes) -> torch.Tensor:
    """K11: allow [F] bool — some rule row's remote set holds and the rule
    is empty, or the frame's opcode (binary) or command (text) is allowed
    and its key passes the row's key mode.  ``rx`` ([F, R] bool) is the
    key automaton's hits on [0, key_len), None when the model has none."""
    device = model.device
    kernels.check(key_data, "key_data", torch.uint8, (None, MAX_KEY), device)
    f = key_data.shape[0]
    r = model.n_rules
    kernels.check(key_len, "key_len", torch.int32, (f,), device)
    kernels.check(has_key, "has_key", torch.bool, (f,), device)
    kernels.check(is_binary, "is_binary", torch.bool, (f,), device)
    kernels.check(opcode, "opcode", torch.int32, (f,), device)
    kernels.check(cmd_id, "cmd_id", torch.int32, (f,), device)
    if (rx is None) != (model.nfa is None):
        raise ValueError("rx: expected the automaton's hits exactly when the model has one")
    if rx is not None:
        kernels.check(rx, "rx", torch.bool, (f, r), device)
    kernels.check(remotes, "remotes", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        return memcache_hits_plain(
            model, key_data, key_len, has_key, is_binary, opcode, cmd_id,
            rx, remotes,
        )
    allow = torch.empty((f,), dtype=torch.bool, device=device)
    if f:
        p = kernels.p
        _MEMCACHE_HITS.launch(
            device, p(key_data), p(key_len), p(has_key), p(is_binary),
            p(opcode), p(cmd_id), ctypes.c_void_p(None) if rx is None else p(rx),
            p(remotes), p(model.op_tab), p(model.cmd_tab), p(model.empty_rule),
            p(model.key_mode), p(model.key_needle), p(model.key_needle_len),
            p(model.remote_ids), p(model.any_remote), f, r,
            model.cmd_tab.shape[1], p(allow),
        )
    return allow


def memcache_verdicts(
    model: MemcacheBatchModel,
    key_data,  # [F, MAX_KEY] uint8
    key_len,  # [F] int32
    has_key,  # [F] bool
    is_binary,  # [F] bool
    opcode,  # [F] int32
    cmd_id,  # [F] int32
    remotes,  # [F] int32
) -> torch.Tensor:
    """allow [F] bool on the model's device; inputs may be numpy arrays
    or tensors."""
    device = model.device
    key_data = as_tensor(key_data, torch.uint8, device)
    key_len = as_tensor(key_len, torch.int32, device)
    has_key = as_tensor(has_key, torch.bool, device)
    is_binary = as_tensor(is_binary, torch.bool, device)
    opcode = as_tensor(opcode, torch.int32, device)
    cmd_id = as_tensor(cmd_id, torch.int32, device)
    remotes = as_tensor(remotes, torch.int32, device)
    rx = None
    if model.nfa is not None:
        zeros = torch.zeros_like(key_len)
        rx = automaton_search_spans(model.nfa, key_data, zeros, key_len)  # [F, R]
    return memcache_hits(
        model, key_data, key_len, has_key, is_binary, opcode, cmd_id, rx,
        remotes,
    )
