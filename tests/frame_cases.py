"""Boundary batches for the framing kernels K1 ``r2d2_frame`` and K5
``http_frame`` (no JAX: the card tests and ``chip_smoke.py`` import it
too).

``frame_batch(l)`` is an [F, l] uint8 batch with its [F] int32 lengths
whose rows put every case the kernels' chunked scan could get wrong:

- lengths 0, 1, l - 1, l and over l (the row then holds the first l bytes);
- a CR at n - 1 (its LF at n does not count), at l - 1 with no LF inside;
- a CRLF and a CRLFCRLF straddling every 4-byte boundary below 160, every
  16-byte boundary and every multiple of 64 (the lane groups' steps are
  64-2,048 bytes);
- request lines with 0, 1, 2, 3 and more spaces;
- LFs before the first space and inside the path;
- request lines longer than one step (up to the whole row);
- dense random rows over CR, LF, space and two plain bytes.
"""

from __future__ import annotations

import numpy as np
import torch

WIDTHS = (16, 17, 64, 67, 256, 512, 4096)
# With a row base 0 or 5 bytes into its storage and the batch's rows or
# 8,192 of them, these widths take every variant of csrc/frame_scan.cuh's
# geometry: 4 lanes a row and a warp a row, 16-byte loads (a 16-byte
# multiple at an aligned base) and byte loads.
CARD_WIDTHS = tuple(sorted(set(WIDTHS) | {128, 1024, 1500, 2048, 5000, 8192}))

LINES = (
    b"HALT", b"GET", b"GET /x", b"GET /x HTTP/1.1", b"GET /x y HTTP/1.1", b"A B C D E",
    b"READ /public/a.txt", b"WRITE /x y", b" ", b"  ", b"GE\nT /x HTTP/1.1",
    b"GET /a\nb HTTP/1.1", b"G\nE\nT /a\nb\nc d\ne", b"\n\n / \n \n", b"GET /a\nb",
)


def boundaries(l: int) -> list[int]:
    """Every 4-byte boundary below 160, every 16-byte one and every
    multiple of 64, inside (0, l + 4)."""
    out = set(range(4, min(l, 160), 4)) | set(range(16, l + 4, 16)) | set(range(64, l + 4, 64))
    out |= {l - 1, l - 2, l - 3}
    return sorted(b for b in out if 0 < b < l + 4)


def _line_at(p: int) -> bytes:
    """A request line of p bytes (its CRLF then starts at p)."""
    if p >= 16:
        return (b"GET /" + b"a" * (p - 14) + b" HTTP/1.1")[:p]
    return (b"R /" + b"ab " * 6)[:p]


def _head_at(p: int) -> bytes:
    """A head whose CRLFCRLF starts at p."""
    line = b"GET / HTTP/1.1\r\n"
    if p >= len(line) + 3:
        return line + b"X: " + b"v" * (p - len(line) - 3) + b"\r\n\r\n"
    return (b"ab " * 8)[:p] + b"\r\n\r\n"


def frame_rows(l: int, seed: int = 0) -> list[tuple[bytes, int]]:
    """(row bytes, length) pairs; the bytes past l are cut off in the batch."""
    rng = np.random.default_rng(seed + l)
    rows: list[tuple[bytes, int]] = []
    head = b"GET /public/x HTTP/1.1\r\nHost: a\r\n\r\n"
    dense = bytes(rng.choice(np.frombuffer(b"\r\n \naa/", np.uint8), size=l + 8))
    for body in (head * (l // len(head) + 1), dense):
        for n in (0, 1, 2, l - 1, l, l + 1, l + 7, 2 * l):
            rows.append((body, max(n, 0)))
    # A CR at n - 1: its LF lies at n, outside the length.
    for n in sorted({2, 16, 17, 64, l - 1, l} & set(range(2, l + 1))):
        rows.append(((b"a " * n)[: n - 1] + b"\r\n\r\n", n))
        rows.append((b"a" * (n - 1) + b"\r\n", n))
    rows.append((b"R /a" + b"b" * (l - 5) + b"\r\n", l + 1))  # CR at l - 1, its LF past the row
    # CRLF and CRLFCRLF straddling each boundary b.
    for b in boundaries(l):
        line = _line_at(b - 1)
        rows.append((line + b"\r\nHost: h\r\n\r\n", len(line) + 13))
        for k in (1, 2, 3):
            if b - k >= 0:
                h = _head_at(b - k)
                rows.append((h, len(h)))
                rows.append((h, len(h) - 1))  # the last LF outside the length
    for line in LINES:
        rows.append((line + b"\r\n\r\n", len(line) + 4))
        rows.append((line, len(line)))
        rows.append((line + b"\r\nH: x y\r\n", len(line) + 10))  # spaces past the line end
    # Request lines longer than one step, up to the whole row.
    for m in sorted({l // 2, l - 12, l - 2, l, l + 40} - {0}):
        rows.append((b"GET /" + b"p\n" * (max(m, 12) // 2 - 6) + b" HTTP/1.1\r\n\r\n", m + 4))
        rows.append((b"a" * max(m - 9, 0) + b" /x\n HTTP\r\n\r\n", m + 4))
    for _ in range(40):
        n = int(rng.integers(0, l + 9))
        row = bytes(rng.choice(np.frombuffer(b"\r\n \nab", np.uint8), size=n))
        rows.append((row, n))
    return rows


def pack(rows: list[tuple[bytes, int]], l: int) -> tuple[np.ndarray, np.ndarray]:
    """(data [F, l] uint8, lengths [F] int32) of (row bytes, length) pairs:
    each row's first l bytes, zeros after them."""
    data = np.zeros((len(rows), l), np.uint8)
    lengths = np.zeros((len(rows),), np.int32)
    for i, (row, n) in enumerate(rows):
        cut = row[:l]
        data[i, : len(cut)] = np.frombuffer(cut, np.uint8)
        lengths[i] = n
    return data, lengths


def frame_batch(l: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(data [F, l] uint8, lengths [F] int32) of ``frame_rows(l, seed)``."""
    return pack(frame_rows(l, seed), l)


# A head over the HTTP engine's 32 KB widest bucket (``chip_smoke.py``'s
# HTTP engine feeds send it too).
LONG_HEAD = b"GET /private/" + b"y" * 33000 + b" HTTP/1.1\r\nHost: svc.local\r\n\r\n"


def on_card_at(dev, data: np.ndarray, offset: int) -> torch.Tensor:
    """``data`` [F, L] on ``dev``, ``offset`` bytes into its storage (a row
    base that is not 16-byte aligned for an odd offset)."""
    f, l = data.shape
    view = torch.empty(f * l + offset, dtype=torch.uint8, device=dev)[offset:].view(f, l)
    view.copy_(torch.from_numpy(data))
    return view


def long_head_batch(head: bytes = LONG_HEAD, f: int = 64, l: int = 32768) -> tuple[np.ndarray, np.ndarray]:
    """The HTTP engine's widest bucket (f rows of l bytes) around a head
    longer than l: row 0 holds its first l bytes with its whole length,
    row 1 the same head cut to end at byte l - 1, row 2 one byte shorter;
    the rest are heads of 40 to 16,000 bytes."""
    rows = [(head, len(head))]
    mid = len(head) // 2
    for end in (l, l - 1):  # cut from the middle of the long line
        row = head[:mid] + head[mid + len(head) - end:]
        rows.append((row, len(row)))
    for i in range(3, f):
        m = (40, 600, 3000, 16000)[i % 4]
        h = b"GET /public/" + b"q" * m + b" HTTP/1.1\r\nHost: a\r\n\r\n"
        rows.append((h, len(h)))
    return pack(rows[:f], l)
