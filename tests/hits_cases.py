"""Boundary batches and rule tables for the rule walks K4 ``r2d2_hits``
and K9 ``dns_hits`` (no JAX: the card tests and ``chip_smoke.py`` import
it too).

``r2d2_tables(r)`` / ``r2d2_batch(tables, f, l)`` and ``dns_tables(r, w)``
/ ``dns_batch(tables, f, l)`` are seeded numpy arrays in the models'
layouts.  The tables cycle through every kind of row a walk could get
wrong, on any table and not only on those `build_*_model` makes:

- bucket padding (command length 0 and no wildcard; remote ids all -1,
  no any-remote; DNS name length -1), which a flow with sp 0 and remote
  -1 matches, as in the plain version;
- any-command / byte-free rows, any-remote rows whose ids are 0;
- rows with 1 remote (padded with itself, as ``pack_remote_sets`` pads)
  and with 32 distinct remotes in no order, rows padded with -1;
- 8-byte commands equal up to their last byte, "AAAAAAAA" (on a row
  of "A"s cut to L < 8 it matches only if the bytes past L read as the
  last byte, which they do not), a command length of 9
  (the 8 stored bytes compared) and of 1; DNS names equal up to their
  last byte, a name as long as W and one longer than W (W bytes
  compared), a row that is both an exact name and an automaton row.

The batches put sp at 0, 1, 8, 9, over L and at the command's length;
remotes -1, 0, the tables' ids and unknown ones; file_ok / rx rows all
false, sparse, dense and all true; DNS spans at the QNAME offset and
elsewhere, spans that end at L, spans with start > end, names that differ
from a row's in their last byte, ``valid`` false (against byte-free
rows), and ``rx`` absent.  R and F are any size (``R_SIZES``,
``F_SIZES``); the card also takes odd R (byte loads of the [F, R] rows).
"""

from __future__ import annotations

import numpy as np
import torch

MAX_CMD = 8
MAX_REMOTES = 32
R_SIZES = (1, 2, 20, 31, 33, 64, 256)
F_SIZES = (1, 37, 1031, 4099)
COMMANDS = (b"READ", b"HALT", b"WRITE", b"RESET", b"R", b"ABCDEFGH", b"ABCDEFGX", b"READ2")


def f_sizes(r: int) -> tuple[int, ...]:
    """The flow counts a case takes at r rules (the JAX reference's [F, R,
    W] compare tensors bound the largest)."""
    return F_SIZES if r < 64 else F_SIZES[:3]


def _ids(rng, kind: str) -> tuple[np.ndarray, bool]:
    """One remote-id row and its any-remote flag."""
    if kind == "pad":
        return np.full(MAX_REMOTES, -1, np.int32), False
    if kind == "any":
        return np.zeros(MAX_REMOTES, np.int32), True
    if kind == "one":
        return np.full(MAX_REMOTES, int(rng.choice([0, 1, 2, 3, 7])), np.int32), False
    if kind == "many":  # 32 distinct ids in no order, 0 and 5 among them
        ids = np.concatenate([[0, 5], rng.choice(np.arange(8, 4000), MAX_REMOTES - 2, replace=False)])
        return rng.permutation(ids).astype(np.int32), False
    # a few ids in no order, padded with -1 (not pack_remote_sets' form)
    ids = np.full(MAX_REMOTES, -1, np.int32)
    ids[:3] = rng.permutation([3, 1, 2])
    return ids, False


R2D2_KINDS = ("pad", "any", "one", "many", "cmd8", "cmd9", "any-ids")


def r2d2_tables(r: int, seed: int = 0) -> dict:
    """cmd_needle [r, 8] uint8, cmd_len / cmd_any / remote_ids / any_remote
    for r rule rows, the kinds of ``R2D2_KINDS`` in turn."""
    rng = np.random.default_rng(1000 + r + seed)
    needle = np.zeros((r, MAX_CMD), np.uint8)
    length = np.zeros(r, np.int32)
    cmd_any = np.zeros(r, bool)
    ids = np.zeros((r, MAX_REMOTES), np.int32)
    any_remote = np.zeros(r, bool)
    for i in range(r):
        kind = R2D2_KINDS[(i + seed + 2) % len(R2D2_KINDS)]
        cmd = b""
        if kind == "any":
            cmd_any[i] = True
        elif kind == "cmd8":
            cmd = (b"ABCDEFGH", b"ABCDEFGX", b"AAAAAAAA")[i % 3]
        elif kind == "cmd9":
            needle[i] = np.frombuffer(b"ABCDEFGH", np.uint8)
            length[i] = 9
        elif kind != "pad":
            cmd = COMMANDS[int(rng.integers(0, len(COMMANDS)))]
        if cmd:
            needle[i, : len(cmd)] = np.frombuffer(cmd, np.uint8)
            length[i] = len(cmd)
        rem_kind = {"pad": "pad", "any": "any", "one": "one", "many": "many",
                    "cmd8": "few", "cmd9": "few", "any-ids": "any"}[kind]
        ids[i], any_remote[i] = _ids(rng, rem_kind)
        if kind == "any-ids":
            ids[i] = rng.integers(-5, 5, MAX_REMOTES)
    return dict(cmd_needle=needle, cmd_len=length, cmd_any=cmd_any, remote_ids=ids,
                any_remote=any_remote)


REMOTES = (-1, 0, 1, 2, 3, 5, 7, 9, 1000)


def r2d2_batch(tables: dict, f: int, l: int, seed: int = 0) -> dict:
    """data [f, l] uint8, sp / remotes [f] int32 and file_ok [f, r] bool."""
    r = tables["cmd_len"].shape[0]
    rng = np.random.default_rng(2000 + 7 * f + l + r + seed)
    data = rng.integers(0x20, 0x7F, (f, l)).astype(np.uint8)
    sp = np.zeros(f, np.int32)
    odd = (0, 1, 8, 9, l + 1, l + 5)
    for i in range(f):
        cmd = (COMMANDS + (b"", b"READX", b"ABCDEFGHI", b"AAAAAAAA"))[int(rng.integers(0, len(COMMANDS) + 4))]
        row = (cmd + b" /public/x.txt")[:l]
        data[i, : len(row)] = np.frombuffer(row, np.uint8)
        sp[i] = len(cmd) if rng.random() < 0.7 else odd[int(rng.integers(0, len(odd)))]
    sp[: min(f, len(odd))] = odd[: min(f, len(odd))]
    density = rng.choice([0.0, 0.03, 0.5, 1.0], size=(f, 1))
    file_ok = rng.random((f, r)) < density
    remotes = rng.choice(REMOTES, size=f).astype(np.int32)
    many = tables["remote_ids"][~tables["any_remote"]].ravel()
    if many.size:
        pick = rng.random(f) < 0.3
        remotes[pick] = rng.choice(many, size=int(pick.sum()))
    return dict(data=data, sp=sp, file_ok=file_ok, remotes=remotes)


DNS_KINDS = ("pad", "any", "name", "sibling", "rx", "long", "name+rx")


def _name(rng, n: int) -> bytes:
    """A dotted lower-case name of n bytes (labels of at most 63)."""
    out = bytearray(rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789-", np.uint8), n))
    for k in range(int(rng.integers(3, 9)), n - 1, int(rng.integers(4, 40))):
        out[k] = ord(".")
    return bytes(out)


def dns_tables(r: int, w: int = 64, seed: int = 0) -> dict:
    """name_needle [r, w] uint8 (zero past each name), name_len / name_any /
    use_rx / remote_ids / any_remote for r rule rows, the kinds of
    ``DNS_KINDS`` in turn; the names' lengths run from 8 to w."""
    rng = np.random.default_rng(3000 + r + w + seed)
    needle = np.zeros((r, w), np.uint8)
    length = np.full(r, -1, np.int32)
    name_any = np.zeros(r, bool)
    use_rx = np.zeros(r, bool)
    ids = np.zeros((r, MAX_REMOTES), np.int32)
    any_remote = np.zeros(r, bool)
    last = _name(rng, min(w, 18))
    for i in range(r):
        kind = DNS_KINDS[(i + seed + 2) % len(DNS_KINDS)]
        name = None
        if kind == "any":
            name_any[i] = True
        elif kind in ("rx", "name+rx"):
            use_rx[i] = True
        if kind in ("name", "name+rx"):
            name = _name(rng, int(rng.integers(min(8, w), w + 1)))
            last = name
        elif kind == "sibling":  # the last name but for its last byte
            name = last[:-1] + (b"z" if last[-1:] != b"z" else b"y")
        elif kind == "long":  # as long as W, or longer (its first W bytes stored)
            name = _name(rng, w)
            length[i] = w + (3 if i % 2 else 0)
        if name is not None:
            needle[i, : len(name)] = np.frombuffer(name, np.uint8)
            if kind != "long":
                length[i] = len(name)
        rem_kind = {"pad": "pad", "any": "any", "name": "one", "sibling": "many",
                    "rx": "any", "long": "any", "name+rx": "few"}[kind]
        ids[i], any_remote[i] = _ids(rng, rem_kind)
    return dict(name_needle=needle, name_len=length, name_any=name_any, use_rx=use_rx,
                remote_ids=ids, any_remote=any_remote)


QNAME_START = 15  # models/dns.py: the first label byte of a framed query


def dns_batch(tables: dict, f: int, l: int, seed: int = 0, rx: bool = True) -> dict:
    """dotted [f, l] uint8, valid [f] bool, span_start / span_end /
    remotes [f] int32 and rx [f, r] bool (None when ``rx`` is false)."""
    needle, length = tables["name_needle"], tables["name_len"]
    r, w = needle.shape
    rng = np.random.default_rng(4000 + 7 * f + l + r + w + seed)
    dotted = rng.integers(0x2D, 0x7B, (f, l)).astype(np.uint8)
    start = np.full(f, QNAME_START, np.int32)
    end = np.zeros(f, np.int32)
    names = [bytes(needle[i, : min(length[i], w)]) for i in range(r) if length[i] >= 0]
    for i in range(f):
        s = QNAME_START if rng.random() < 0.7 else int(rng.integers(0, l))
        roll = rng.random()
        if names and roll < 0.5:
            name = names[int(rng.integers(0, len(names)))]
        elif names and roll < 0.65:  # a row's name but for its last byte
            name = names[int(rng.integers(0, len(names)))]
            name = name[:-1] + bytes([name[-1] ^ 1]) if name else b"x"
        else:
            name = _name(rng, int(rng.integers(1, max(2, w + 4))))
        if len(name) == w and rng.random() < 0.5:
            name += b"abc"  # a name longer than W: its first W bytes compared
        cut = name[: max(l - s, 0)]
        dotted[i, s : s + len(cut)] = np.frombuffer(cut, np.uint8)
        start[i] = s
        end[i] = min(s + len(name), l)  # a span past the row ends at L
        if rng.random() < 0.05:
            end[i] = s - int(rng.integers(1, 6))  # start > end: an empty span
        if rng.random() < 0.05:
            end[i] = l
    valid = rng.random(f) < 0.85
    density = rng.choice([0.0, 0.05, 0.5, 1.0], size=(f, 1))
    rx_ok = rng.random((f, r)) < density if rx else None
    remotes = rng.choice(REMOTES, size=f).astype(np.int32)
    many = tables["remote_ids"][~tables["any_remote"]].ravel()
    if many.size:
        pick = rng.random(f) < 0.3
        remotes[pick] = rng.choice(many, size=int(pick.sum()))
    return dict(dotted=dotted, valid=valid, span_start=start, span_end=end, rx=rx_ok,
                remotes=remotes)


def r2d2_model(tables: dict, device="cpu"):
    """An ``R2d2BatchModel`` on ``device`` holding the tables as they are
    (no automaton: K4 and its plain version read none)."""
    from cilium_tpu_torch.models.r2d2 import R2d2BatchModel

    return R2d2BatchModel(nfa=None, **{k: torch.from_numpy(v).to(device) for k, v in tables.items()})


class Automaton:
    """Stands in for a model's automaton: ``dns_hits`` checks only that the
    model has one, on its device, with a pattern a row."""

    def __init__(self, device, n_patterns):
        self.device = torch.device(device)
        self.n_patterns = n_patterns


def dns_model(tables: dict, device="cpu", rx: bool = True):
    """A ``DnsBatchModel`` on ``device`` holding the tables as they are;
    with ``rx`` it takes the automaton's hits."""
    from cilium_tpu_torch.models.dns import DnsBatchModel

    t = {k: torch.from_numpy(v).to(device) for k, v in tables.items()}
    nfa = Automaton(t["name_len"].device, t["name_len"].shape[0]) if rx else None
    return DnsBatchModel(nfa=nfa, **t)


def dns_name(batch: dict, device="cpu"):
    """The batch as the ``DnsName`` K9 reads (complete and msg_len unused)."""
    from cilium_tpu_torch.models.dns import DnsName

    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items() if k not in ("rx", "remotes")}
    zero = torch.zeros_like(t["span_start"])
    return DnsName(t["valid"].clone(), zero, t["valid"], t["span_start"], t["span_end"], t["dotted"])
