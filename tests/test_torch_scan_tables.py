"""K2's and K3's packed tables give back the tables they were built from.

``DeviceDfa.scan_tab`` (ops/dfa.py ``scan_table``: each entry the
target's row, accept states absorbing, a flag entry a state, the columns
interleaved for the banks) and ``DeviceNfa``'s near and sparse rows
(ops/nfa.py ``near_rows``, ``sparse_rows``) are what the kernels read on
the card; the plain versions read ``delta`` / ``accept`` /
``accept_final`` and ``delta_bits``.  Each test unpacks the kernel's form
here, by the layout the kernels' sources describe, and asserts it gives
those back exactly (``delta`` on every state that does not accept: an
accepting state's row is its own), on compiled pattern sets, synthetic
tables at the limits (128 DFA states, R tiled past shared memory, an NFA
of 1,024 states, one with no edges) and dataclasses rebuilt from their
``init`` fields as ``parallel/mesh.py`` ``moved`` rebuilds them.  CPU
only; no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cilium_tpu_torch.convert import dfa_from_leaves, nfa_from_leaves
from cilium_tpu_torch.ops.dfa import (
    SCAN_KT_MAX,
    SCAN_SMEM,
    DeviceDfa,
    device_dfa,
    dfa_from_arrays,
    scan_geometry,
)
from cilium_tpu_torch.ops.nfa import (
    MAX_STATES,
    DeviceNfa,
    device_nfa,
    nfa_from_dense,
    nfa_scan_plain,
    nfa_search_batch,
    pack_bits,
    unpack_bits,
)
from cilium_tpu_torch.parallel.mesh import moved
from cilium_tpu_torch.parallel.rulesharding import stack_nfas
from cilium_tpu_torch.regex import compile_patterns
from cilium_tpu_torch.regex.dfa import compile_pattern_dfas

CPU = torch.device("cpu")
PATTERNS = [
    "/public/.*", "", "^/public/", "\\.txt$", "a.c", "(ab|cd)+", "^$",
    "[^abc]", "^(READ|HALT)$", "x{2,3}", "/g07/[a-z0-9]+/item/.*",
]
NFA_PATTERNS = PATTERNS[:4] + ["/n00/(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)/x"]
WIDE = [f"/g{j:02d}/[a-z0-9]+/item/.*" for j in range(64)]


def _random_dfa(seed, r, s, c):
    rng = np.random.default_rng(seed)
    classmap = rng.integers(0, c, 256)
    classmap[:c] = np.arange(c)
    accept = rng.random((r, s)) < 0.1
    return dfa_from_arrays(
        classmap, rng.integers(0, s, (r, s, c)), rng.integers(0, s, r), accept,
        accept | (rng.random((r, s)) < 0.1), CPU,
    )


def _random_nfa(seed, c, s, r, density):
    rng = np.random.default_rng(seed)
    classmap = rng.integers(0, c, 256)
    classmap[:c] = np.arange(c)
    accept = rng.random((r, s)) < 0.05
    return nfa_from_dense(
        classmap, rng.random((c, s, s)) < density, rng.random(s) < 0.1, accept,
        accept | (rng.random((r, s)) < 0.05), CPU,
    )


def _unpack_dfa(dfa: DeviceDfa):
    """(targets [R, S, C], flags [R, S]) read back from scan_tab by
    csrc/dfa_scan.cu's addressing: the entry of (state s, class c) is the
    target's row in the tile, the flag entry accept | accept_final << 1."""
    g, kt, nc, es, tiles = dfa.scan_geom
    r, s, c = dfa.n_patterns, dfa.n_states, dfa.n_classes
    epw = 4 // es
    cq = -(-(c + 1) // epw)
    n = kt * s * cq * nc * 4
    tab = dfa.scan_tab.numpy().reshape(tiles, -1)
    assert tab.shape[1] == -(-n // 16) * 16 and np.all(tab[:, n:] == 0)
    tab = tab[:, :n].reshape(tiles, -1, es).astype(np.int64)
    tab = (tab << (8 * np.arange(es))).sum(-1)  # little-endian entries
    # [tiles, kt * S, cq, nc, epw]: lane l reads column l % nc, and
    # column col holds the patterns of lane slot col % g
    tab = tab.reshape(tiles, kt * s, cq, nc, epw)
    for col in range(nc):
        assert np.array_equal(tab[:, :, :, col], tab[:, :, :, col % g])
    # -> [pattern = (tile, j, q), S, cq * epw]
    ent = tab[:, :, :, :g].reshape(tiles, kt, s, cq, g, epw).transpose(0, 1, 4, 2, 3, 5)
    ent = ent.reshape(tiles * kt * g, s, cq * epw)
    assert np.all(ent[r:] == 0) and np.all(ent[:, :, c + 1 :] == 0)
    slot = (np.arange(r) // g) % kt
    tgt = ent[:r, :, :c] - slot[:, None, None] * s
    assert np.all((tgt >= 0) & (tgt < s))
    return tgt, ent[:r, :, c]


def _check_dfa(dfa: DeviceDfa):
    g, kt, nc, es, tiles = dfa.scan_geom
    r, s, c = dfa.n_patterns, dfa.n_states, dfa.n_classes
    assert (g, kt, nc, es, tiles) == scan_geometry(r, s, c)
    assert g & (g - 1) == 0 and g <= nc <= 32 and nc & (nc - 1) == 0 and 1 <= kt <= SCAN_KT_MAX
    assert es == (1 if kt * s <= 256 else 2) and tiles * g * kt >= r
    assert nc * kt * s * -(-(c + 1) * es // 4) * 4 <= SCAN_SMEM
    tgt, flags = _unpack_dfa(dfa)
    delta, accept = dfa.delta.numpy(), dfa.accept.numpy()
    # accepting states are absorbing; every other row is delta's
    assert np.array_equal(tgt[~accept], delta[~accept])
    assert np.all(tgt[accept] == np.nonzero(accept)[1][:, None])
    assert np.array_equal(flags & 1, accept)
    assert np.array_equal(flags >> 1, dfa.accept_final.numpy())


def _unpack_nfa(nfa: DeviceNfa) -> np.ndarray:
    """Dense [C, S, S] bool read back from the sparse rows by
    csrc/nfa_scan.cu's addressing."""
    c, s = nfa.n_classes, nfa.n_states
    rows = nfa.scan_rows.numpy().astype(np.int64)
    tgt = nfa.scan_targets.numpy().astype(np.int64)
    has = unpack_bits(nfa.scan_has, s).numpy()
    dense = np.zeros((c * s, s), bool)
    for i, (begin, packed) in enumerate(rows):
        n, first = packed & 0xFFFF, packed >> 16
        assert has.reshape(-1)[i] == (n > 0)
        if n:
            assert first == tgt[begin]
            ts = tgt[begin : begin + n]
            assert np.all(np.diff(ts) > 0)
            dense[i, ts] = True
        else:
            assert first == 0
    assert tgt.shape == (int((rows[:, 1] & 0xFFFF).sum()) + 1,) and tgt[-1] == 0
    return dense.reshape(c, s, s)


def _check_nfa(nfa: DeviceNfa):
    s = nfa.n_states
    dense = _unpack_nfa(nfa)
    assert np.array_equal(pack_bits(dense), nfa.delta_bits.numpy())
    assert np.array_equal(dense, unpack_bits(nfa.delta_bits, s).numpy())
    # the near rows: a row's words j and j + 1, and the far mask marks
    # exactly the rows with a target in any other word
    c, w = nfa.n_classes, nfa.delta_bits.shape[2]
    words = np.concatenate([nfa.delta_bits.numpy(), np.zeros((c, s, 1), np.int32)], 2)
    j = np.arange(s) // 32
    near = nfa.scan_near.numpy().reshape(c, s, 2)
    assert np.array_equal(near[:, :, 0], words[:, np.arange(s), j])
    assert np.array_equal(near[:, :, 1], words[:, np.arange(s), j + 1])
    other = np.arange(w)[None, :] != j[:, None]
    other &= np.arange(w)[None, :] != j[:, None] + 1
    far = unpack_bits(nfa.scan_far, s).numpy()
    assert np.array_equal(far, ((words[:, :, :w] != 0) & other[None]).any(2))
    want_any = [unpack_bits(b, 32 * nfa.delta_bits.shape[2]).numpy().any(0)
                for b in (nfa.accept_bits, nfa.accept_final_bits)]
    assert np.array_equal(nfa.scan_any.numpy(), pack_bits(np.stack(want_any)))


def _rebuilt(obj):
    """``obj`` rebuilt from its init fields, as parallel/mesh.py moved does."""
    return type(obj)(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj) if f.init})


@pytest.mark.parametrize("make", [
    pytest.param(lambda: device_dfa(compile_pattern_dfas(PATTERNS), CPU), id="patterns"),
    pytest.param(lambda: device_dfa(compile_pattern_dfas(PATTERNS[:1]), CPU), id="one-pattern"),
    pytest.param(lambda: device_dfa(compile_pattern_dfas(WIDE), CPU), id="wide-64"),
    pytest.param(lambda: _random_dfa(1, 33, 45, 19), id="r33"),
    pytest.param(lambda: _random_dfa(2, 8, 128, 40), id="s128"),
    pytest.param(lambda: _random_dfa(3, 300, 128, 40), id="tiled-r300"),
    pytest.param(lambda: _random_dfa(4, 5, 128, 256), id="s128-c256"),
    pytest.param(lambda: _random_dfa(6, 200, 100, 5), id="two-byte-entries"),
])
def test_dfa_scan_table_round_trips(make):
    dfa = make()
    _check_dfa(dfa)
    again = _rebuilt(dfa)
    assert again.scan_geom == dfa.scan_geom
    assert torch.equal(again.scan_tab, dfa.scan_tab)


def test_dfa_geometry_takes_the_whole_table_when_it_fits():
    # chip_smoke.py's wide shape: one pass over all 64 patterns, a lane
    # each in its own bank; graft's R = 8: four flows a warp
    assert scan_geometry(64, 45, 19) == (32, 2, 32, 1, 1)
    assert scan_geometry(8, 19, 9) == (8, 1, 32, 1, 1)
    assert scan_geometry(1, 19, 9) == (1, 1, 32, 1, 1)
    g, kt, nc, es, tiles = scan_geometry(300, 128, 40)
    assert tiles > 1 and g * kt * tiles >= 300
    assert scan_geometry(200, 100, 5)[3] == 2  # past 256 rows a tile


def test_dfa_from_leaves_and_the_128_state_dfa_round_trip():
    dfa = _random_dfa(5, 3, 128, 7)
    # one run a byte; the padded runs have lo > hi
    leaves = {"cls_lo": np.full((7, 256), 256), "cls_hi": np.zeros((7, 256), np.int64)}
    classmap = dfa.classmap.numpy()
    for cls in range(7):
        idx = np.nonzero(classmap == cls)[0]
        leaves["cls_lo"][cls, : len(idx)] = idx
        leaves["cls_hi"][cls, : len(idx)] = idx
    leaves["delta_id"] = dfa.delta.numpy()
    leaves["start_1h"] = np.eye(128, dtype=np.int32)[dfa.start.numpy()]
    leaves["accept_mask"] = dfa.accept.numpy().astype(np.int32)
    leaves["accept_final_mask"] = dfa.accept_final.numpy().astype(np.int32)
    again = dfa_from_leaves(leaves, CPU)
    _check_dfa(again)
    assert torch.equal(again.scan_tab, dfa.scan_tab)


@pytest.mark.parametrize("make", [
    pytest.param(lambda: device_nfa(compile_patterns(NFA_PATTERNS), CPU), id="nfa-patterns"),
    pytest.param(lambda: device_nfa(compile_patterns(PATTERNS), CPU), id="patterns"),
    pytest.param(lambda: _random_nfa(6, 5, 1024, 3, 0.002), id="w32"),
    pytest.param(lambda: _random_nfa(7, 19, 320, 8, 0.0006), id="w10"),
    pytest.param(lambda: _random_nfa(8, 4, 20, 2, 0.0), id="no-edges"),
])
def test_nfa_sparse_rows_round_trip(make):
    nfa = make()
    _check_nfa(nfa)
    again = _rebuilt(nfa)
    for name in ("scan_near", "scan_far", "scan_rows", "scan_targets", "scan_has", "scan_any"):
        assert torch.equal(getattr(again, name), getattr(nfa, name)), name


def test_nfa_with_no_edges_has_empty_rows():
    nfa = _random_nfa(9, 4, 20, 2, 0.0)
    assert not nfa.delta_bits.any()
    assert nfa.scan_targets.tolist() == [0]
    assert not nfa.scan_rows.any() and not nfa.scan_has.any()


def test_moved_and_stacked_and_converted_tables_carry_the_sparse_rows():
    tables = [compile_patterns(NFA_PATTERNS), compile_patterns(PATTERNS[:2])]
    for nfa in stack_nfas(tables, CPU):
        _check_nfa(nfa)
    nfa = device_nfa(tables[0], CPU)
    assert moved(nfa, CPU) is nfa
    delta = unpack_bits(nfa.delta_bits, nfa.n_states).numpy()
    s, c = nfa.n_states, nfa.n_classes
    leaves = {
        "classmap": nfa.classmap.numpy(),
        "delta_flat": delta.transpose(1, 0, 2).reshape(s, c * s),
        "start": unpack_bits(nfa.start_bits, s).numpy(),
        "accept_t": unpack_bits(nfa.accept_bits, s).numpy().T,
        "accept_final_t": unpack_bits(nfa.accept_final_bits, s).numpy().T,
    }
    again = nfa_from_leaves(leaves, CPU)
    _check_nfa(again)
    assert torch.equal(again.scan_rows, nfa.scan_rows)
    assert torch.equal(again.scan_targets, nfa.scan_targets)


# Past one launch's MAX_STATES states: 48 patterns of 24-40 states, 1,360
# in all, and heads that match some of each shape.
SPLIT_RES = ["orders", "users", "items", "carts", "books", "films", "songs", "teams",
             "maps", "docs", "logs", "keys"]
SPLIT_PATTERNS = [p.format(r) for p in ("/api/v[0-9]+/{}/.*", "/v[0-9]+/{}/[a-z]+",
                                        "/{}/x[0-9]*y", "/api/v[1-3]/{}/.*") for r in SPLIT_RES]


def split_heads(rng, n, width=48):
    """[n, width] uint8 rows of paths against SPLIT_PATTERNS and their lengths."""
    shapes = ("/api/v{}/{}/a", "/v{}/{}/ab", "/{}/x{}y", "/api/vX/{}/a")
    data = np.zeros((n, width), np.uint8)
    lengths = np.zeros((n,), np.int32)
    for i in range(n):
        shape = shapes[i % len(shapes)]
        res = SPLIT_RES[rng.integers(len(SPLIT_RES))]
        num = int(rng.integers(0, 5))
        h = (shape.format(res, num) if shape.startswith("/{}") else shape.format(num, res)).encode()
        data[i, : len(h)] = np.frombuffer(h, np.uint8)
        lengths[i] = len(h)
    return torch.from_numpy(data), torch.from_numpy(lengths)


def test_nfa_past_one_launch_splits_exactly():
    """An NFA of more than MAX_STATES states is cut into parts of at most
    MAX_STATES at states that no edge and no accept set crosses; the
    parts' columns cover every pattern once, and the plain scan of the
    parts, put together, is the plain scan of the whole NFA."""
    tables = compile_patterns(SPLIT_PATTERNS)
    nfa = device_nfa(tables, CPU)
    assert nfa.n_states > MAX_STATES
    assert len(nfa.scan_parts) >= 2
    cols = torch.cat([c for _, c in nfa.scan_parts])
    assert sorted(cols.tolist()) == list(range(nfa.n_patterns))
    for part, c in nfa.scan_parts:
        assert part.n_states <= MAX_STATES and part.n_patterns == len(c) and not part.scan_parts
        _check_nfa(part)
    data, lengths = split_heads(np.random.default_rng(3), 96)
    start = torch.zeros_like(lengths)
    whole = nfa_scan_plain(nfa, data, start, lengths)
    joined = torch.zeros_like(whole)
    for part, c in nfa.scan_parts:
        joined[:, c] = nfa_scan_plain(part, data, start, lengths)
    assert torch.equal(joined, whole)
    assert all(bool(whole[:, c].any()) for _, c in nfa.scan_parts) and not whole.all()
    # the padding of a mesh shard's tables (states and patterns that never
    # accept) leaves the parts' patterns as they were
    from cilium_tpu_torch.parallel.rulesharding import pad_tables

    padded = device_nfa(pad_tables(tables, tables.n_states + 200, tables.n_classes,
                                   tables.n_patterns + 3), CPU)
    joined = torch.zeros((len(data), padded.n_patterns), dtype=torch.bool)
    for part, c in padded.scan_parts:
        joined[:, c] = nfa_scan_plain(part, data, start, lengths)
    assert torch.equal(joined[:, : nfa.n_patterns], whole) and not joined[:, nfa.n_patterns :].any()


def test_nfa_block_past_one_launch_raises():
    """A chain of MAX_STATES + 1 states has no cut.  The upload no longer
    raises (K3 scans such a block in its wide form): the port at
    ``device="cpu"`` gives the reference's ``nfa_search_batch`` on runs
    of the chain's byte that reach its end, fall one short or are broken,
    and on an empty span."""
    from cilium_tpu.ops import nfa as ref_nfa
    from cilium_tpu.regex.tables import NfaTables

    import nfa_wide_cases as wc

    classmap, delta, start, accept, accept_final = wc.chain(MAX_STATES + 1)
    s = delta.shape[1]
    nfa = nfa_from_dense(classmap, delta, start, accept, accept_final, CPU)
    assert nfa.n_states == s and nfa.scan_parts == []
    _check_nfa(nfa)
    # the reference's scan costs S * C * S a byte of every row
    data = np.full((4, s), ord("a"), np.uint8)
    data[2, 7] = ord("b")
    lengths = np.array([s - 1, s - 2, s, 0], np.int32)
    ref = ref_nfa.device_nfa(NfaTables(
        n_states=s, n_classes=2, n_patterns=1, classmap=classmap.astype(np.int32),
        delta=delta.astype(np.uint8), start=start, accept=accept, accept_final=accept_final,
        matches_empty=np.zeros(1, bool)))
    want = np.asarray(ref_nfa.nfa_search_batch(ref, data, lengths))
    got = nfa_search_batch(nfa, torch.from_numpy(data), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, 0].tolist() == [True, False, False, False]
