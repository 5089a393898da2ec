"""Boundary batches for K8 ``dns_name`` (no JAX: the card tests,
``chip_smoke.py`` and ``chip_frame_variants.py`` import it too).

``name_batch(l, f)`` is an [f, l] uint8 batch of prefixed DNS-over-TCP
rows with its [f] int32 lengths, seeded numpy, whose rows put every case
the lane groups' label walk could get wrong:

- names of 0 to 40 labels, and a 41st (invalid), labels of 1 to 63 bytes;
- a label byte over 63 (64, 0xC0 compression pointers, 0xFF) first and
  after other labels, so separators marked before it stay '.';
- chains that end exactly at, one byte before and past min(msg_len, L),
  chains that run past L, and QTYPE / QCLASS cut (pos + 5 > msg_len);
- QDCOUNT 0, 1, 2 and 256; msg_len below 19; lengths 0, 1, below msg_len,
  at it and past L;
- upper case, the bytes around 'A'..'Z' ('@', '[', '`', '{'), the same
  bytes with the high bit set, and '.' bytes already in the data;
- rows of random bytes, and rows of random label chains.

Every width of ``WIDTHS`` takes the same recipe (rows longer than L are
cut to L).  ``F_SIZES`` are the flow counts the tests cycle the rows to.
"""

from __future__ import annotations

import numpy as np
import torch

WIDTHS = (16, 18, 19, 64, 67, 128, 256, 330)
# With OFFSETS these widths take every (lanes, aligned) pick of
# csrc/dns_name.cu's geometry besides: 200 bytes at 16 lanes unaligned,
# 384 at a warp aligned.
CARD_WIDTHS = WIDTHS + (200, 384)
F_SIZES = (1, 37, 2048, 4099)
# Row bases 0 and 5 bytes into their storage (16-byte and byte loads).
OFFSETS = (0, 5)
QNAME_OFF = 14  # the first label-length byte of a prefixed query
ALPHA = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_@[`{.\xc1\xda\xe1"


def frame(labels: list[bytes | int], qdcount: int = 1, tail: bytes = b"\x00\x01\x00\x01") -> bytes:
    """A prefixed query: header with ``qdcount``, the labels (each after its
    length byte; an int stands for a raw byte in the chain, written without
    a length: over 63, a compression pointer or an oversize label), a
    terminal zero, then ``tail`` (QTYPE and QCLASS)."""
    qn = bytearray()
    for lab in labels:
        if isinstance(lab, int):
            qn.append(lab)
        else:
            qn += bytes([len(lab)]) + lab
    msg = b"\x12\x34\x01\x00" + qdcount.to_bytes(2, "big") + b"\x00" * 6 + bytes(qn) + b"\x00" + tail
    return len(msg).to_bytes(2, "big") + msg


def _label(rng, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(ALPHA, np.uint8), n))


def name_rows(l: int, seed: int = 0) -> list[tuple[bytes, int]]:
    """(row bytes, length) pairs; the bytes past l are cut off in the batch."""
    rng = np.random.default_rng(seed + 7 * l)
    rows: list[tuple[bytes, int]] = []

    def add(row: bytes, n: int | None = None):
        rows.append((row, len(row) if n is None else n))

    # 0 to 41 labels of 1 byte (the 41st invalidates), and of 2-5 bytes.
    for k in range(0, 42):
        add(frame([b"a"] * k))
        add(frame([_label(rng, int(rng.integers(1, 6))) for _ in range(k)]))
    # Labels of every size class, upper case and high-bit bytes included.
    for n in (1, 2, 3, 15, 16, 17, 31, 32, 33, 47, 48, 62, 63):
        add(frame([_label(rng, n)]))
        add(frame([b"Ab", _label(rng, n), b"ZZ"]))
        add(frame([_label(rng, n), _label(rng, 63 - n + 1)]))
    add(frame([b"WWW", b"Example", b"COM"]))
    add(frame([b"@AZ[", b"`az{", b"\xc1\xda\xe1", b"a.b", b"..."]))
    # A byte over 63 in the chain, first and after labels.
    for bad in (64, 0x7F, 0xC0, 0xFF):
        add(frame([bad, b"x"]))
        add(frame([b"ab", b"cd", bad, b"ef"]))
        add(frame([_label(rng, 20), _label(rng, 10), bad]))
    # Chains against the frame's limit min(msg_len, L): the terminal zero
    # at msg_len - 1, msg_len, past it; a cut QTYPE / QCLASS.
    base = frame([b"svc", b"cluster", b"local"])
    end = len(base) - 5  # the terminal zero's position
    for ml in range(end - 3, end + 8):  # msg_len = prefix + 2 around it
        add((ml - 2).to_bytes(2, "big") + base[2:], max(ml, len(base)))
    # QTYPE cut: pos + 5 > msg_len with the zero inside.
    add(frame([b"ab"], tail=b"\x00\x01"))
    add(frame([b"ab"], tail=b"\x00\x01\x00"))
    add(frame([b"ab"], tail=b""))
    # Chains that run past L and into the row's last bytes.
    for m in sorted({l - 16, l - 15, l - 14, l - 13, l - 2, l - 1, l, l + 1, l + 40} - {0}):
        labs, used = [], QNAME_OFF
        while used + 1 < m:
            n = int(min(63, max(1, m - used - 1)))
            labs.append(_label(rng, n))
            used += 1 + n
        add(frame(labs))
        add(frame(labs), min(len(frame(labs)), l))
    # QDCOUNT, msg_len and lengths.
    q = frame([b"api", b"example", b"com"])
    for qd in (0, 1, 2, 256):
        add(frame([b"api", b"example", b"com"], qdcount=qd))
    for n in (0, 1, 2, 18, 19, len(q) - 1, len(q), len(q) + 1, l, l + 3):
        add(q, n)
    for ml in (0, 1, 16, 17, 18, 19, 20, 300, 65535):
        add((ml - 2 if ml >= 2 else 0).to_bytes(2, "big") + q[2:], max(ml, len(q)))
    add(frame([b"a"]) + frame([b"b", b"c"]))  # pipelined: the first frame only
    # Random label chains and random bytes.
    for _ in range(60):
        k = int(rng.integers(0, 12))
        labs = [_label(rng, int(rng.integers(1, 64 if rng.random() < 0.2 else 12))) for _ in range(k)]
        if rng.random() < 0.15:
            labs.insert(int(rng.integers(0, k + 1)), int(rng.choice([64, 0xC0, 0xC1, 0xFF])))
        row = frame(labs, qdcount=int(rng.choice([0, 1, 1, 1, 3])))
        add(row, int(rng.choice([len(row), len(row), int(rng.integers(0, len(row) + 8))])))
    for _ in range(20):
        n = int(rng.integers(0, l + 9))
        add(bytes(rng.integers(0, 256, size=n).astype(np.uint8)), n)
    return rows


def pack(rows: list[tuple[bytes, int]], l: int) -> tuple[np.ndarray, np.ndarray]:
    """(data [F, l] uint8, lengths [F] int32): each row's first l bytes,
    zeros after them."""
    data = np.zeros((len(rows), l), np.uint8)
    lengths = np.zeros((len(rows),), np.int32)
    for i, (row, n) in enumerate(rows):
        cut = row[:l]
        data[i, : len(cut)] = np.frombuffer(cut, np.uint8)
        lengths[i] = n
    return data, lengths


def name_batch(l: int, f: int | None = None, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(data [f, l] uint8, lengths [f] int32) of ``name_rows(l, seed)``,
    cycled or cut to f rows (all of them for None)."""
    data, lengths = pack(name_rows(l, seed), l)
    if f is None:
        return data, lengths
    return np.resize(data, (f, l)), np.resize(lengths, f)


def on_card_at(dev, data: np.ndarray, offset: int) -> torch.Tensor:
    """``data`` [F, L] on ``dev``, ``offset`` bytes into its storage."""
    f, l = data.shape
    view = torch.empty(f * l + offset, dtype=torch.uint8, device=dev)[offset:].view(f, l)
    view.copy_(torch.from_numpy(data))
    return view
