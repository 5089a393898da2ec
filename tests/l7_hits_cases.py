"""Boundary tables and batches for the ACL walks K10 ``cassandra_hits``
and K11 ``memcache_hits`` (numpy only, no JAX: the card tests and
``chip_hits_variants.py`` import it too).

``cass_tables(r)`` / ``cass_batch(tables, f)`` and ``mc_tables(r, nc)`` /
``mc_batch(tables, f, nc)`` are seeded numpy arrays in the models'
layouts, each table with ``patterns``, the table or key regex of each row
("" where it has none) for the reference's automaton.  The tables cycle
through every kind of row a walk could get wrong, on any table and not
only on those ``build_*_model`` makes:

- Cassandra: actions of 6 bytes and one equal to "select" up to its last
  byte, of 17 bytes (past the first 16-byte word), of 32 bytes, a needle
  length of 40 (32 bytes stored and compared), a zero-length needle that
  is not ``action_any``, a needle with bytes past its length (not
  compared), ``action_any`` rows, and rows with and without a table regex;
- memcached: exact and prefix keys of 0, 5, 16, 17, 33 and 96 bytes, a
  needle with bytes past its length, regex rows, rows of no key mode and
  of a mode outside the four, empty rules, opcode and command columns of
  a few entries each;
- remote sets of 1 id (padded with itself), of 32 distinct ids in no
  order, padded with -1, and any-remote rows.

The batches put action and key lengths at 0, at each needle's, over 32
and over 96 and negative; table lengths 0, positive and negative; garbage
past every length; non-query rows, keyless frames, opcodes and command
ids outside their tables and negative; and remotes -1, 0, the tables' ids
and unknown ones.  ``R_SIZES`` and ``F_SIZES`` are the sizes the tests
take; past 128 rows the remote ids are no longer staged.
"""

from __future__ import annotations

import numpy as np

MAX_ACTION = 32
MAX_TABLE = 96
MAX_KEY = 96
MAX_REMOTES = 32
KEY_NONE, KEY_EXACT, KEY_PREFIX, KEY_REGEX = 0, 1, 2, 3
R_SIZES = (1, 2, 3, 40, 129)
F_SIZES = (1, 37, 1031, 4099)
REMOTES = (-1, 0, 1, 2, 3, 5, 7, 9, 1000)

ACTIONS = (b"select", b"insert", b"selecu", b"create-aggregate1", b"a" * 32, b"o" * 32, b"",
           b"use")
TABLE_RX = ("^public\\.", "^ks\\.(t01|tmp01)[0-9]*$", "users", "^secret\\.t[0-9]$")
TABLES = (b"public.a", b"ks.t01", b"ks.tmp017", b"secret.users", b"secret.t5", b"other.t01", b"",
          b"x" * 96)
CASS_KINDS = ("select+rx", "insert+rx", "any+rx", "select", "any", "near", "len17", "len32",
              "len40", "empty-needle", "dirty-needle")

KEYS = (b"user:1", b"user:", b"user", b"user:12", b"sess:9", b"sess:x", b"", b"k" * 96,
        b"0123456789abcdef", b"0123456789abcdefg", b"p" * 33, b"p" * 40)
KEY_RX = ("^sess:[0-9]+$", "user", "^k+$")
MC_KINDS = ("exact", "prefix", "regex", "none", "empty", "exact0", "prefix0", "exact16",
            "exact17", "prefix33", "exact96", "dirty", "mode7")
OPCODES = (0, 1, 4, 9, 27, 200, 255)


def _pad(b: bytes, width: int) -> np.ndarray:
    out = np.zeros(width, np.uint8)
    out[: len(b)] = np.frombuffer(b[:width], np.uint8)
    return out


def _ids(rng, kind: str) -> tuple[np.ndarray, bool]:
    """One remote-id row and its any-remote flag."""
    if kind == "any":
        return np.zeros(MAX_REMOTES, np.int32), True
    if kind == "one":
        return np.full(MAX_REMOTES, int(rng.choice([0, 1, 2, 3, 7])), np.int32), False
    if kind == "many":  # 32 distinct ids in no order, 0 and 5 among them
        ids = np.concatenate([[0, 5], rng.choice(np.arange(8, 4000), MAX_REMOTES - 2, replace=False)])
        return rng.permutation(ids).astype(np.int32), False
    ids = np.full(MAX_REMOTES, -1, np.int32)
    ids[:3] = rng.permutation([3, 1, 2])
    return ids, False


def _remote_kind(i: int, seed: int, open_row: bool) -> str:
    """The remote set of row i: any, one, many and few in turn, but never
    any on a row that passes every request (the walk would stop there)."""
    kind = ("any", "one", "many", "few")[(i // 2 + seed) % 4]
    return "few" if open_row and kind == "any" else kind


def _remotes(rng, tables: dict, f: int) -> np.ndarray:
    """f remotes: the pool's and, for 30% of rows, one of the tables' ids."""
    remotes = rng.choice(REMOTES, size=f).astype(np.int32)
    held = tables["remote_ids"][~tables["any_remote"]].ravel()
    if held.size:
        pick = rng.random(f) < 0.3
        remotes[pick] = rng.choice(held, size=int(pick.sum()))
    return remotes


def _garbage(rng, row: np.ndarray, start: int) -> None:
    """Random bytes from start on (bytes past a length are never compared)."""
    if start < row.shape[0]:
        row[max(start, 0):] = rng.integers(1, 256, size=row.shape[0] - max(start, 0))


def cass_tables(r: int, seed: int = 0) -> dict:
    """The rule tables of ``CassandraBatchModel`` for r rows, the kinds of
    ``CASS_KINDS`` in turn, and ``patterns``."""
    rng = np.random.default_rng(5000 + r + seed)
    t = dict(
        action_needle=np.zeros((r, MAX_ACTION), np.uint8), action_len=np.zeros(r, np.int32),
        action_any=np.zeros(r, bool), table_none=np.ones(r, bool),
        remote_ids=np.zeros((r, MAX_REMOTES), np.int32), any_remote=np.zeros(r, bool),
    )
    patterns = []
    for i in range(r):
        kind = CASS_KINDS[(i + seed) % len(CASS_KINDS)]
        action = {"select+rx": b"select", "insert+rx": b"insert", "select": b"select",
                  "near": b"selecu", "len17": ACTIONS[3], "len32": ACTIONS[4], "len40": ACTIONS[5],
                  "dirty-needle": b"use"}.get(kind, b"")
        t["action_needle"][i] = _pad(action, MAX_ACTION)
        t["action_len"][i] = 40 if kind == "len40" else len(action)
        t["action_any"][i] = kind in ("any+rx", "any")
        if kind == "dirty-needle":
            _garbage(rng, t["action_needle"][i], len(action))
        rx = kind in ("select+rx", "insert+rx", "any+rx", "near", "len17") or (
            kind not in ("select", "any") and rng.random() < 0.5)
        patterns.append(TABLE_RX[int(rng.integers(len(TABLE_RX)))] if rx else "")
        t["table_none"][i] = not rx
        t["remote_ids"][i], t["any_remote"][i] = _ids(rng, _remote_kind(i, seed, kind == "any"))
    t["patterns"] = patterns
    return t


def cass_batch(tables: dict, f: int, seed: int = 0) -> dict:
    """A request batch of f rows (``encode_cassandra_batch``'s arrays) and
    its remotes."""
    r = tables["action_len"].shape[0]
    rng = np.random.default_rng(6000 + 7 * f + r + seed)
    b = dict(data=np.zeros((f, MAX_ACTION + MAX_TABLE), np.uint8), action_len=np.zeros(f, np.int32),
             table_len=np.zeros(f, np.int32), non_query=rng.random(f) < 0.1)
    for i in range(f):
        action = ACTIONS[int(rng.integers(len(ACTIONS)))]
        if rng.random() < 0.3:  # a table row's action
            j = int(rng.integers(r))
            action = bytes(tables["action_needle"][j, : min(max(tables["action_len"][j], 0), MAX_ACTION)])
        alen = len(action)
        roll = rng.random()
        if roll < 0.05:
            alen = -int(rng.integers(1, 6))
        elif roll < 0.12 and action == ACTIONS[5]:
            alen = 40  # over 32: the stored 32 bytes are compared
        elif roll < 0.16:
            alen = 33
        row = b["data"][i]
        row[: MAX_ACTION] = _pad(action, MAX_ACTION)
        _garbage(rng, row[:MAX_ACTION], max(alen, len(action)))
        table = TABLES[int(rng.integers(len(TABLES)))]
        row[MAX_ACTION:] = _pad(table, MAX_TABLE)
        tlen = len(table)
        if rng.random() < 0.05:
            tlen = -1  # not 0: the table gate still applies
        b["action_len"][i] = alen
        b["table_len"][i] = tlen
    b["action_len"][: min(f, 4)] = [0, 6, -1, 40][: min(f, 4)]
    b["remotes"] = _remotes(rng, tables, f)
    return b


def mc_tables(r: int, nc: int, seed: int = 0) -> dict:
    """The rule tables of ``MemcacheBatchModel`` for r rows and nc text
    commands, the kinds of ``MC_KINDS`` in turn, and ``patterns``."""
    rng = np.random.default_rng(7000 + r + nc + seed)
    t = dict(
        op_tab=np.zeros((r, 256), bool), cmd_tab=np.zeros((r, nc), bool), empty_rule=np.zeros(r, bool),
        key_mode=np.zeros(r, np.int32), key_needle=np.zeros((r, MAX_KEY), np.uint8),
        key_needle_len=np.zeros(r, np.int32), remote_ids=np.zeros((r, MAX_REMOTES), np.int32),
        any_remote=np.zeros(r, bool),
    )
    patterns = []
    for i in range(r):
        kind = MC_KINDS[(i + seed) % len(MC_KINDS)]
        t["op_tab"][i, rng.choice(OPCODES, size=int(rng.integers(1, 4)), replace=False)] = True
        t["op_tab"][i, int(rng.integers(256))] = True
        t["cmd_tab"][i, rng.choice(nc, size=int(rng.integers(1, 4)), replace=False)] = True
        t["cmd_tab"][i, [0, nc - 1]] = rng.random() < 0.5  # the columns clamped indices reach
        mode, needle, pattern = KEY_NONE, b"", ""
        if kind in ("exact", "prefix", "dirty"):
            mode = KEY_EXACT if kind != "prefix" else KEY_PREFIX
            needle = KEYS[int(rng.integers(0, 4))]
        elif kind == "regex":
            mode, pattern = KEY_REGEX, KEY_RX[int(rng.integers(len(KEY_RX)))]
        elif kind == "empty":
            t["empty_rule"][i] = True
        elif kind in ("exact0", "prefix0"):
            mode = KEY_EXACT if kind == "exact0" else KEY_PREFIX
        elif kind in ("exact16", "exact17", "exact96"):
            mode, needle = KEY_EXACT, {"exact16": KEYS[8], "exact17": KEYS[9], "exact96": KEYS[7]}[kind]
        elif kind == "prefix33":
            mode, needle = KEY_PREFIX, KEYS[10]
        elif kind == "mode7":
            mode = 7
        t["key_mode"][i] = mode
        t["key_needle"][i] = _pad(needle, MAX_KEY)
        t["key_needle_len"][i] = len(needle)
        if kind == "dirty":
            _garbage(rng, t["key_needle"][i], len(needle))
        patterns.append(pattern)
        t["remote_ids"][i], t["any_remote"][i] = _ids(rng, _remote_kind(i, seed, kind == "empty"))
    t["patterns"] = patterns
    return t


def mc_batch(tables: dict, f: int, nc: int, seed: int = 0) -> dict:
    """A frame batch of f rows (``encode_memcache_batch``'s arrays) and its
    remotes."""
    r = tables["key_mode"].shape[0]
    rng = np.random.default_rng(8000 + 7 * f + r + nc + seed)
    b = dict(key_data=np.zeros((f, MAX_KEY), np.uint8), key_len=np.zeros(f, np.int32),
             has_key=rng.random(f) < 0.8, is_binary=rng.random(f) < 0.5,
             opcode=rng.choice(OPCODES, size=f).astype(np.int32),
             cmd_id=rng.integers(0, nc, size=f).astype(np.int32))
    for i in range(f):
        key = KEYS[int(rng.integers(len(KEYS)))]
        if rng.random() < 0.15:  # a key that extends one (prefix rows)
            key = key + b"-tail"
        klen = len(key)
        roll = rng.random()
        if roll < 0.05:
            klen = -int(rng.integers(1, 6))
        elif roll < 0.1:
            klen = 100 + int(rng.integers(0, 20))  # over 96: the row holds the first 96 bytes
        row = b["key_data"][i]
        row[:] = _pad(key, MAX_KEY)
        _garbage(rng, row, max(klen, len(key)))
        b["key_len"][i] = klen
    odd = rng.random(f) < 0.1  # indices outside the tables: counted from the end, clamped
    b["opcode"][odd] = rng.choice([-1, -256, -300, 256, 1000], size=int(odd.sum()))
    b["cmd_id"][odd] = rng.choice([-1, nc, -nc - 5, nc + 3], size=int(odd.sum()))
    b["remotes"] = _remotes(rng, tables, f)
    return b


class Automaton:
    """Stands in for a model's automaton: K10 and K11 check only that the
    model has one, on its device, with a pattern a row."""

    def __init__(self, device, n_patterns):
        import torch

        self.device = torch.device(device)
        self.n_patterns = n_patterns


def at(dev, a: np.ndarray, offset: int = 0):
    """numpy ``a`` as a tensor on ``dev``, ``offset`` elements into its
    storage (a base no 16-byte load takes, for an odd offset of a byte
    array)."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if not offset:
        return t.to(dev)
    view = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)[offset:].view(t.shape)
    view.copy_(t)
    return view


def cass_model(tables: dict, device="cpu", offset: int = 0):
    """A ``CassandraBatchModel`` on ``device`` holding the tables, each
    ``offset`` elements into its storage; it takes the automaton's hits
    where some row has a table regex."""
    from cilium_tpu_torch.models.cassandra import CassandraBatchModel

    t = {k: at(device, v, offset) for k, v in tables.items() if k != "patterns"}
    nfa = Automaton(t["action_len"].device, len(tables["patterns"])) if any(tables["patterns"]) else None
    return CassandraBatchModel(nfa=nfa, **t)


def mc_model(tables: dict, device="cpu", offset: int = 0):
    """A ``MemcacheBatchModel`` as ``cass_model`` makes one."""
    from cilium_tpu_torch.models.memcached import MemcacheBatchModel

    t = {k: at(device, v, offset) for k, v in tables.items() if k != "patterns"}
    nfa = Automaton(t["key_mode"].device, len(tables["patterns"])) if any(tables["patterns"]) else None
    return MemcacheBatchModel(nfa=nfa, **t)


def rx_hits(tables: dict, f: int, seed: int = 0):
    """[f, r] bool automaton hits for the card tests (the CPU tests take
    the reference automaton's): rows all false, all true, sparse and
    dense; None where no row has a regex (the model then has no
    automaton)."""
    if not any(tables["patterns"]):
        return None
    r = len(tables["patterns"])
    rng = np.random.default_rng(9000 + 7 * f + r + seed)
    density = rng.choice([0.0, 0.05, 0.5, 1.0], size=(f, 1))
    return rng.random((f, r)) < density
