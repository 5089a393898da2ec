"""NFAs past one thread's 1,024 states that no cut divides: K3's wide form.

One block of more than ``ops.nfa.MAX_STATES`` states (a long bounded
repetition) cannot be cut into parts (``ops.nfa.split_parts``), so K3
scans it a warp a flow.  The CPU tests (tests/test_torch_scan_tables.py),
the card tests (tests/test_torch_cuda.py) and ``chip_smoke.py`` phase 15
take their shapes from here:

- ``chain(s)``: dense tables of a chain of ``s`` states on one byte, the
  smallest such block (1,025 states: one past one thread);
- ``WIDE_PATTERNS``: compiled patterns of 2,064 and 4,088 states (fifteen
  runs of 135 distinct letters, 128 state words: the wide form's limit);
- ``HTTP_WIDE_RULE``: the HTTP path rule whose model holds such a block;
- ``planted(rng, f, l, needle)``: random bytes over the needle's alphabet
  with the needle, or a copy one byte short, planted in some rows.
"""

from __future__ import annotations

import numpy as np

CHAIN_STATES = 1025
WIDE_PATTERNS = {
    "nfa-wide-2064": "/a{256}b{256}c{256}d{256}e",
    "nfa-wide-4088": "".join(f"{ch}{{135}}" for ch in "abcdefghijklmno"),
}
HTTP_WIDE_RULE = dict(method="GET", path="/a{256}b{256}")


def chain(s=CHAIN_STATES):
    """(classmap, delta, start, accept, accept_final) of a chain of ``s``
    states: byte ``a`` (class 1) moves state i to i + 1, every other byte
    (class 0) kills the set; state 0 starts, state s - 1 accepts."""
    classmap = np.zeros(256, np.int64)
    classmap[ord("a")] = 1
    delta = np.zeros((2, s, s), bool)
    delta[1, np.arange(s - 1), np.arange(1, s)] = True
    start = np.zeros(s, bool)
    start[0] = True
    accept = np.zeros((1, s), bool)
    accept[0, -1] = True
    return classmap, delta, start, accept, accept


def needle(pattern: str) -> bytes:
    """The shortest string a run-length pattern (``x{n}`` runs and single
    characters) matches."""
    out, i = b"", 0
    while i < len(pattern):
        ch = pattern[i]
        if i + 1 < len(pattern) and pattern[i + 1] == "{":
            j = pattern.index("}", i)
            out += ch.encode() * int(pattern[i + 2 : j])
            i = j + 1
        else:
            out += ch.encode()
            i += 1
    return out


def planted(rng, f, l, pattern_needle: bytes):
    """[f, l] uint8 rows and [f] int32 lengths: bytes drawn from the
    needle's alphabet and one other; every third row holds the needle at a
    random offset, every third a copy one byte short (a near miss), where
    it fits in ``l``."""
    alphabet = np.frombuffer(bytes(sorted(set(pattern_needle))) + b"z", np.uint8)
    data = rng.choice(alphabet, size=(f, l)).astype(np.uint8)
    n = len(pattern_needle)
    lengths = rng.integers(max(l // 2, min(l, n + 8)), l + 1, size=f).astype(np.int32)
    lengths[:2] = [0, l]
    for i in range(2, f):
        cut = pattern_needle if i % 3 == 0 else pattern_needle[:-1] if i % 3 == 1 else b""
        if cut and len(cut) <= lengths[i]:
            at = int(rng.integers(0, lengths[i] - len(cut) + 1))
            data[i, at : at + len(cut)] = np.frombuffer(cut, np.uint8)
            if len(cut) < n and at + len(cut) < l:
                data[i, at + len(cut)] = ord("z")  # the near miss stays one
    return data, lengths


def http_requests(n_path_a: int, n_path_b: int, width: int, extra: bytes = b"") -> bytes:
    """One GET request head whose path is /a..ab..b (``n_path_a`` a's and
    ``n_path_b`` b's), cut to ``width`` bytes."""
    path = b"/" + b"a" * n_path_a + b"b" * n_path_b + extra
    return (b"GET " + path + b" HTTP/1.1\r\nHost: svc.local\r\n\r\n")[:width]
