"""The port's sequence-folded DFA search at device="cpu" against the JAX
package and the serial scan.

tests/test_seqdfa.py's patterns and batches: the port's
``seqdfa_search_batch`` (plain PyTorch here; kernel K18 ``seqdfa_fold`` /
``seqdfa_apply`` on the card) must equal the JAX package's
``seqdfa_search_batch`` and the port's serial ``dfa_search_batch`` for
every chunking (tolerance 0: the output is bool), on the port's own
absorbing tables and on the JAX tables carried over by ``dfa_from_leaves``.
"""

from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

from cilium_tpu.ops import seqdfa as ref_seqdfa
from cilium_tpu.regex.dfa import compile_pattern_dfas as ref_compile
from cilium_tpu_torch.convert import dfa_from_leaves
from cilium_tpu_torch.entry import SEQDFA_PATTERNS, seqdfa_batch, seqdfa_tables
from cilium_tpu_torch.ops.dfa import device_dfa, dfa_search_batch
from cilium_tpu_torch.ops.seqdfa import (
    FOLD_DMAX,
    SEQ_AXIS,
    device_dfa_absorbing,
    make_absorbing,
    seqdfa_apply,
    seqdfa_fold,
    seqdfa_fold_branches_plain,
    seqdfa_fold_plain,
    seqdfa_search_batch,
    seqdfa_search_batch_plain,
    seqdfa_search_sharded,
    sink_states,
)
from cilium_tpu_torch.regex.dfa import DfaBlowupError, compile_pattern_dfas

from test_seqdfa import PATTERNS, _batch

CPU = torch.device("cpu")
LEAVES = ("cls_lo", "cls_hi", "delta_id", "start_1h", "accept_mask", "accept_final_mask")


@pytest.fixture(scope="module")
def tables():
    return compile_pattern_dfas(PATTERNS)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def test_patterns_are_the_reference_tests():
    assert list(SEQDFA_PATTERNS) == PATTERNS


def test_make_absorbing_matches_reference(tables):
    mine = make_absorbing(tables)
    ref = ref_seqdfa.make_absorbing(ref_compile(PATTERNS))
    np.testing.assert_array_equal(mine.delta, ref.delta)
    np.testing.assert_array_equal(mine.accept_final, ref.accept_final)


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 8])
def test_chunked_fold_matches_serial_and_reference(tables, n_chunks):
    """test_chunked_fold_matches_serial's batch: the port's chunk fold
    equals the serial sticky scan, the JAX package's fold, and itself on
    the JAX tables carried over."""
    rng = random.Random(5)
    data, lengths = _batch(rng, 64, 32)
    d, l = _t(data, torch.uint8), _t(lengths, torch.int32)
    serial = dfa_search_batch(device_dfa(tables, CPU), d, l)
    dfa_abs = device_dfa_absorbing(tables, CPU)
    got = seqdfa_search_batch(dfa_abs, d, l, n_chunks=n_chunks)
    assert torch.equal(got, serial)
    assert torch.equal(got, seqdfa_search_batch_plain(dfa_abs, d, l, n_chunks))
    ref_abs = ref_seqdfa.device_dfa_absorbing(ref_compile(PATTERNS))
    want = np.asarray(ref_seqdfa.seqdfa_search_batch(ref_abs, data, lengths, n_chunks=n_chunks))
    np.testing.assert_array_equal(got.numpy(), want)
    leaves = dict(zip(LEAVES, (np.asarray(x) for x in jax.tree_util.tree_leaves(ref_abs))))
    carried = dfa_from_leaves(leaves, CPU)
    assert torch.equal(seqdfa_search_batch(carried, d, l, n_chunks), got)


def test_dfa_from_leaves_takes_absorbing_leaves_unchanged(tables):
    ref_abs = ref_seqdfa.device_dfa_absorbing(ref_compile(PATTERNS))
    leaves = dict(zip(LEAVES, (np.asarray(x) for x in jax.tree_util.tree_leaves(ref_abs))))
    carried = dfa_from_leaves(leaves, CPU)
    mine = device_dfa_absorbing(tables, CPU)
    for name in ("classmap", "delta", "start", "accept", "accept_final"):
        assert torch.equal(getattr(carried, name), getattr(mine, name)), name


@pytest.mark.parametrize("width,n_chunks", [(256, 8), (512, 64), (96, 3)])
def test_long_frames_and_chunk_boundaries(tables, width, n_chunks):
    """Long frames from entry.seqdfa_batch: lengths at chunk boundaries
    (and one byte either side), a match straddling the middle; every
    chunking equals the serial scan."""
    data, lengths = seqdfa_batch(24, width, n_chunks, seed=width)
    d, l = _t(data, torch.uint8), _t(lengths, torch.int32)
    serial = dfa_search_batch(device_dfa(tables, CPU), d, l)
    dfa_abs = device_dfa_absorbing(tables, CPU)
    for k in (1, n_chunks):
        assert torch.equal(seqdfa_search_batch(dfa_abs, d, l, k), serial)
    assert serial[0, PATTERNS.index(r"/public/.*")]
    assert serial.any() and not serial.all()


def test_width_not_multiple_of_chunks_raises(tables):
    dfa_abs = device_dfa_absorbing(tables, CPU)
    d = torch.zeros((4, 30), dtype=torch.uint8)
    l = torch.full((4,), 30, dtype=torch.int32)
    with pytest.raises(ValueError):
        seqdfa_search_batch(dfa_abs, d, l, n_chunks=4)
    with pytest.raises(ValueError):
        seqdfa_search_batch_plain(dfa_abs, d, l, n_chunks=0)
    with pytest.raises(ValueError):
        seqdfa_batch(4, 30, 4)


def test_fold_maps_are_functions_and_padded_states_stay_in_range(tables):
    """Every map entry is a state id < S (padded states map to 0, never an
    error); a chunk with no active byte is the identity."""
    dfa_abs = device_dfa_absorbing(tables, CPU)
    data, lengths = _batch(random.Random(9), 16, 32)
    lengths[:4] = 0
    d, l = _t(data, torch.uint8), _t(lengths, torch.int32)
    maps = seqdfa_fold(dfa_abs, d, l, 4)
    assert maps.shape == (16, len(PATTERNS), 4, tables.n_states) and maps.dtype == torch.uint8
    assert int(maps.max()) < tables.n_states
    ident = torch.arange(tables.n_states, dtype=torch.uint8)
    assert (maps[:4] == ident).all()
    assert torch.equal(maps, seqdfa_fold_plain(dfa_abs, d, l, 4))
    assert torch.equal(seqdfa_apply(dfa_abs, maps), seqdfa_search_batch(dfa_abs, d, l, 4))


def test_more_than_128_states_raises():
    """device_dfa (so device_dfa_absorbing) refuses tables whose state ids
    do not fit the kernels' byte."""
    big = compile_pattern_dfas(["a[ab]{7}b"], max_states=512)
    assert big.n_states > 128
    with pytest.raises(DfaBlowupError):
        device_dfa_absorbing(big, CPU)


def test_table_uploads_need_a_card_unless_asked_for_the_cpu(tables, monkeypatch):
    """device=None is the card: without one the uploads raise rather than
    leave the tables on the CPU, where the search would run plain."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_dfa_absorbing(tables)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_dfa(tables)
    assert device_dfa_absorbing(tables, CPU).device == CPU


def test_inputs_are_checked(tables):
    dfa_abs = device_dfa_absorbing(tables, CPU)
    d = torch.zeros((4, 32), dtype=torch.uint8)
    with pytest.raises(TypeError):
        seqdfa_search_batch(dfa_abs, d, torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        seqdfa_search_batch(dfa_abs, d.t(), torch.zeros(32, dtype=torch.int32), 2)


# --- the sequence-sharded search (slots of a ("seq",) mesh) --------------------


def _seq_mesh(n):
    from cilium_tpu_torch.parallel import Mesh, virtual_devices

    return Mesh(np.array(virtual_devices(n, CPU), dtype=object), (SEQ_AXIS,))


def _ref_seq_mesh(n):
    from jax.sharding import Mesh as RefMesh

    return RefMesh(np.array(jax.devices()[:n]), (ref_seqdfa.SEQ_AXIS,))


def test_seq_sharded_matches_serial_on_mesh(tables):
    """8-slot sequence mesh: each slot folds its byte slice, the maps are
    gathered in slot order for one apply — identical to the serial scan
    and to the JAX package's search on its 8-device mesh."""
    rng = random.Random(6)
    data, lengths = _batch(rng, 32, 64)  # 8 bytes per slot
    d, l = _t(data, torch.uint8), _t(lengths, torch.int32)
    want = dfa_search_batch(device_dfa(tables, CPU), d, l)
    got = seqdfa_search_sharded(device_dfa_absorbing(tables, CPU), d, l, _seq_mesh(8))
    assert torch.equal(got, want)
    ref_abs = ref_seqdfa.device_dfa_absorbing(ref_compile(PATTERNS))
    ref = ref_seqdfa.seqdfa_search_sharded(ref_abs, data, lengths, _ref_seq_mesh(8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_seq_sharded_wide_frames(tables):
    """Frames of 1,024 bytes on 8 slots, a match straddling a chunk
    boundary, spans ending mid-chunk."""
    rng = random.Random(7)
    data, lengths = _batch(rng, 8, 1024)
    data[0, :] = 0
    payload = b"x" * 124 + b"/public/deep" + b"y" * 12
    data[0, : len(payload)] = np.frombuffer(payload, np.uint8)
    lengths[0] = len(payload)
    d, l = _t(data, torch.uint8), _t(lengths, torch.int32)
    want = dfa_search_batch(device_dfa(tables, CPU), d, l)
    got = seqdfa_search_sharded(device_dfa_absorbing(tables, CPU), d, l, _seq_mesh(8))
    assert torch.equal(got, want)
    assert got[0, PATTERNS.index(r"/public/.*")]
    ref_abs = ref_seqdfa.device_dfa_absorbing(ref_compile(PATTERNS))
    ref = ref_seqdfa.seqdfa_search_sharded(ref_abs, data, lengths, _ref_seq_mesh(8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("end", ["before", "inside", "after"])
def test_slot_lengths_fold_what_the_reference_t0_folds(tables, end):
    """Slot k folds its slice with lengths clamp(lengths - k*lc, 0, lc)
    where the reference passes t0 = k*lc to ``_fold_chunk``: the two give
    the same state map for a span that ends before, inside and after the
    chunk."""
    import jax.numpy as jnp

    n, lc = 4, 16
    rng = random.Random({"before": 1, "inside": 2, "after": 3}[end])
    data, _ = _batch(rng, 12, n * lc)
    k = 2
    lo, hi = k * lc, (k + 1) * lc
    span = {"before": (0, lo - 1), "inside": (lo + 1, hi - 1), "after": (hi, n * lc + 1)}[end]
    lengths = np.asarray([rng.randrange(*span) for _ in range(12)], np.int32)
    dfa_abs = device_dfa_absorbing(tables, CPU)
    d = _t(data[:, lo:hi], torch.uint8)
    ln = (_t(lengths, torch.int32) - lo).clamp(0, lc)
    got = seqdfa_fold(dfa_abs, d, ln.to(torch.int32), 1)[:, :, 0, :]
    ref_abs = ref_seqdfa.device_dfa_absorbing(ref_compile(PATTERNS))
    one_hot = ref_seqdfa._fold_chunk(
        ref_abs, jnp.asarray(data[:, lo:hi]), jnp.int32(lo),
        jnp.zeros(12, jnp.int32), jnp.asarray(lengths),
    )
    want = np.asarray(one_hot).argmax(axis=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    ident = np.arange(tables.n_states)
    if end == "before":
        assert (got.numpy() == ident).all()


def test_seq_sharded_raises_the_references_errors(tables):
    dfa_abs = device_dfa_absorbing(tables, CPU)
    mesh = _seq_mesh(4)
    with pytest.raises(ValueError, match="width"):
        seqdfa_search_sharded(dfa_abs, torch.zeros((8, 30), dtype=torch.uint8),
                              torch.zeros(8, dtype=torch.int32), mesh)
    with pytest.raises(ValueError, match="flow count"):
        seqdfa_search_sharded(dfa_abs, torch.zeros((6, 32), dtype=torch.uint8),
                              torch.zeros(6, dtype=torch.int32), mesh)


# --- K18 fold's merge: sinks and branch counts -----------------------------------

COUNTERS = ["^(a{13})*b", "^(a{11})*c"]


def _counter_batch(f, width):
    """Frames of 'a' ending in 'b' (even flows) or 'c' (odd), lengths near
    the width: the counters' start states never merge."""
    lengths = (width - np.arange(f) % 29).astype(np.int32)
    data = np.full((f, width), ord("a"), np.uint8)
    data[np.arange(f), lengths - 1] = np.where(np.arange(f) % 2 == 0, ord("b"), ord("c"))
    data[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return data, lengths


@pytest.mark.parametrize("patterns", [PATTERNS, COUNTERS])
def test_sink_states_match_the_reference_absorbing_tables(patterns):
    """sink_states on the JAX package's make_absorbing tables: exactly the
    states whose every class steps to themselves, every accept state
    among them."""
    ref = ref_seqdfa.make_absorbing(ref_compile(patterns))
    delta = np.asarray(ref.delta)
    got = sink_states(device_dfa(ref, CPU)).numpy()
    r, s, _ = delta.shape
    want = np.array([[(delta[i, j] == j).all() for j in range(s)] for i in range(r)])
    np.testing.assert_array_equal(got, want)
    assert got[np.asarray(ref.accept)].all()
    assert torch.equal(sink_states(device_dfa_absorbing(compile_pattern_dfas(patterns), CPU)),
                       torch.from_numpy(got))


def _branches_by_hand(dfa, data, lengths, n_chunks, seg, probe):
    """seqdfa_fold_branches_plain's counts, one group at a time."""
    delta = dfa.delta.numpy()
    cls = dfa.classmap.numpy()[data]
    sink = sink_states(dfa).numpy()
    r, s, _ = delta.shape
    width = data.shape[1]
    lc = width // n_chunks
    sl = min(seg, lc)
    groups = chains = slow = 0
    for f in range(data.shape[0]):
        for k in range(n_chunks):
            for a in range(k * lc, (k + 1) * lc, sl):
                n = min(sl, (k + 1) * lc - a, max(0, int(lengths[f]) - a))
                if n <= 0:
                    continue
                for p in range(r):
                    ends = []
                    for s0 in range(s):
                        st = s0
                        for j in range(min(probe, n)):
                            st = delta[p, st, cls[f, a + j]]
                        ends.append(st)
                    live = [e for e in ends if not sink[p, e] and n > probe]
                    distinct = len(set(live))
                    groups += 1
                    slow += distinct > FOLD_DMAX
                    chains += len(live) if distinct > FOLD_DMAX else distinct
    return [groups, chains, slow]


@pytest.mark.parametrize("seg,probe", [(16, 2), (32, 0), (16, 1), (16, 20)])
def test_fold_branch_counts_match_a_walk_by_hand(tables, seg, probe):
    """The branch counts K18's fold reports, computed per group by hand,
    on test_seqdfa's patterns and on the counters."""
    data, lengths = _batch(random.Random(seg + probe), 5, 96)
    for tabs, (d, ln) in ((tables, (data, lengths)), (compile_pattern_dfas(COUNTERS), _counter_batch(4, 96))):
        dfa_abs = device_dfa_absorbing(tabs, CPU)
        for k in (1, 3):
            got = seqdfa_fold_branches_plain(dfa_abs, _t(d, torch.uint8), _t(ln, torch.int32), k,
                                             seg=seg, probe=probe)
            assert got.tolist() == _branches_by_hand(dfa_abs, d, ln, k, seg, probe)


def test_counters_take_the_slow_branch_and_the_patterns_the_fast(tables):
    """On frames of one byte the counters keep every start state apart:
    every group is slow.  test_seqdfa's patterns on seqdfa_batch's frames
    merge to a few states after the default probe: no group is slow."""
    d, ln = _counter_batch(6, 512)
    dfa_abs = device_dfa_absorbing(compile_pattern_dfas(COUNTERS), CPU)
    groups, chains, slow = seqdfa_fold_branches_plain(dfa_abs, _t(d, torch.uint8), _t(ln, torch.int32), 4).tolist()
    assert groups == slow > 0 and chains > FOLD_DMAX * slow
    data, lengths = seqdfa_batch(16, 1024, 8)
    dfa_abs = device_dfa_absorbing(tables, CPU)
    groups, chains, slow = seqdfa_fold_branches_plain(dfa_abs, _t(data, torch.uint8),
                                                      _t(lengths, torch.int32), 8).tolist()
    assert groups > 0 and chains > 0 and slow == 0


def test_counters_match_the_reference(tables):
    """The counters' search on their one-byte frames: the port's chunk fold
    equals the serial scan and the JAX package's search."""
    data, lengths = _counter_batch(30, 64)
    d, l = _t(data, torch.uint8), _t(lengths, torch.int32)
    counters = compile_pattern_dfas(COUNTERS)
    serial = dfa_search_batch(device_dfa(counters, CPU), d, l)
    ref_abs = ref_seqdfa.device_dfa_absorbing(ref_compile(COUNTERS))
    for k in (1, 4, 16):
        got = seqdfa_search_batch(device_dfa_absorbing(counters, CPU), d, l, k)
        assert torch.equal(got, serial)
        want = np.asarray(ref_seqdfa.seqdfa_search_batch(ref_abs, data, lengths, n_chunks=k))
        np.testing.assert_array_equal(got.numpy(), want)
    assert serial.any() and not serial.all()


def test_fold_debug_counts_on_the_cpu(tables):
    """seqdfa_fold's debug tensor gets the branch counts added (the plain
    version's on the CPU) and is checked like every kernel argument."""
    data, lengths = seqdfa_batch(8, 512, 4)
    d, l = _t(data, torch.uint8), _t(lengths, torch.int32)
    dfa_abs = device_dfa_absorbing(tables, CPU)
    dbg = torch.zeros(3, dtype=torch.int64)
    maps = seqdfa_fold(dfa_abs, d, l, 4, debug=dbg)
    seqdfa_fold(dfa_abs, d, l, 4, debug=dbg)
    assert torch.equal(maps, seqdfa_fold_plain(dfa_abs, d, l, 4))
    assert torch.equal(dbg, 2 * seqdfa_fold_branches_plain(dfa_abs, d, l, 4))
    with pytest.raises(TypeError):
        seqdfa_fold(dfa_abs, d, l, 4, debug=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        seqdfa_fold(dfa_abs, d, l, 4, debug=torch.zeros(2, dtype=torch.int64))


# --- K18 apply: the plain version against the reference's compose, and the
# launcher's pick (csrc/seqdfa.cu apply_plan) as the Python mirror reads it ---


@pytest.fixture(autouse=True, scope="module")
def _reference_leak_guard():
    """Reference tests leave a dummy HTTP/DNS rule parser registered and a
    FlightRecorder installed (ROADMAP Queue 3): put the real parsers back
    and uninstall every recorder, before and after this module."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.dns import dns_rule_parser
    from cilium_tpu.proxylib.parsers.http import http_rule_parser
    from cilium_tpu.sidecar import blackbox as ref_bb
    from cilium_tpu_torch.sidecar import blackbox as port_bb

    def clean():
        register_l7_rule_parser("http", http_rule_parser)
        register_l7_rule_parser("dns", dns_rule_parser)
        for bb in (ref_bb, port_bb):
            for rec in list(bb._RECORDERS):
                rec.uninstall()

    clean()
    yield
    clean()


def _ref_apply(start, accept_final, maps):
    """The reference's apply on one-hot maps: ``_compose`` in chunk order,
    then ``_apply_start_accept``."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    f, r, k, s = maps.shape
    eye = np.eye(s, dtype=np.int8)
    pmap = jnp.asarray(eye[maps[:, :, 0, :]])  # [F, R, S, S]: row s0 one-hot at maps[..., s0]
    for c in range(1, k):
        pmap = ref_seqdfa._compose(pmap, jnp.asarray(eye[maps[:, :, c, :]]))
    dfa = SimpleNamespace(start_1h=jnp.asarray(eye[start]),
                          accept_final_mask=jnp.asarray(accept_final.astype(np.int8)))
    return np.asarray(ref_seqdfa._apply_start_accept(dfa, pmap))


@pytest.mark.parametrize("f,r,k,s", [(37, 9, 1, 19), (5, 3, 1, 128), (6, 2, 9, 127), (9, 9, 64, 19),
                                     (4, 2, 5, 1), (11, 3, 13, 33), (3, 1, 64, 16)],
                         ids=["k1", "k1-s128", "near-128", "seq9-k64", "s1", "odd-s", "adv-s16"])
def test_apply_plain_matches_the_reference_compose(f, r, k, s):
    """K18 apply's plain version against the reference's one-hot compose
    and start/accept on seeded maps (tolerance 0): K = 1, a table at and
    near the 128-state limit, odd S, S = 1, and pairs whose every map sends
    all states to one state (merge_cases)."""
    from cilium_tpu_torch.ops.dfa import dfa_from_arrays
    from cilium_tpu_torch.ops.seqdfa import seqdfa_apply_plain

    import merge_cases as mc

    rng = np.random.default_rng(1000 * k + s)
    classmap, delta, start, accept, accept_final, maps = mc.apply_case(rng, f, r, k, s)
    dfa = dfa_from_arrays(classmap, delta, start, accept, accept_final, CPU)
    got = seqdfa_apply_plain(dfa, torch.from_numpy(maps))
    want = _ref_apply(start, accept_final, maps)
    np.testing.assert_array_equal(got.numpy(), want)
    got_w = seqdfa_apply(dfa, torch.from_numpy(maps), "staged")  # the plain version on the CPU
    assert torch.equal(got_w, got)
    assert want.any() or not accept_final.any()


def test_apply_variant_reads_the_launchers_constants():
    """The mirror's thresholds are seqdfa.cu's own constants."""
    from cilium_tpu_torch import kernels

    text = (kernels.CSRC / "seqdfa.cu").read_text()
    c = kernels.cu_constants("seqdfa")
    for name in ("kApplyThreads", "kApplyStageBytes", "kApplyMinBlocks", "kApplyStageMinK",
                 "kMaxStates"):
        assert f"constexpr int {name} = {c[name]};" in text
    assert c["kMaxStates"] == 128


@pytest.mark.parametrize("path", ["pick", "staged", "walk"])
@pytest.mark.parametrize("f,r,k,s", [(2048, 9, 64, 19), (256, 9, 64, 19), (2048, 9, 8, 19),
                                     (256, 9, 8, 19), (2048, 9, 1, 19), (2048, 2, 64, 16),
                                     (256, 8, 8, 19), (3, 2, 2000, 19), (1, 1, 1, 128), (5, 1, 3, 1)])
def test_apply_variant_follows_the_launchers_rule(f, r, k, s, path):
    """apply_variant: the walk (a pair a thread, no tiles) where forced and
    below kApplyStageMinK chunks on the pick; staged: a block's pairs fit
    its threads, their regions (an odd number of 16-byte words, one more
    than a tile's bytes need) fit kApplyStageBytes, the grid keeps
    kApplyMinBlocks blocks where F x R allows it and takes as many pairs as
    it can, and chunks past the budget go in tiles."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.ops.seqdfa import APPLY_PATHS, apply_variant

    c = kernels.cu_constants("seqdfa")
    got, pairs, kt = apply_variant(f, r, s, k, path)
    assert got in APPLY_PATHS and got != "pick"
    if path == "walk" or (path == "pick" and k < c["kApplyStageMinK"]):
        assert (got, pairs, kt) == ("walk", 1, 0)
        return
    assert got == "staged"
    words = ((kt * s + 15) // 16 + 1) | 1
    assert words % 2 == 1 and 16 * words >= kt * s + 15
    assert 1 <= kt <= k and (kt == k or 16 * words + 48 > c["kApplyStageBytes"] - s)
    assert pairs <= c["kApplyThreads"] and (pairs == 1 or pairs * 16 * words <= c["kApplyStageBytes"])
    n = f * r
    blocks = -(-n // pairs)
    most = min(c["kApplyThreads"], c["kApplyStageBytes"] // (16 * words))
    assert blocks >= min(c["kApplyMinBlocks"], -(-n // max(most, 1)))
    assert pairs == max(1, min(most, -(-n // c["kApplyMinBlocks"])))


def test_apply_staged_bytes_count_each_pairs_words():
    """apply_staged_bytes: the aligned 16-byte words holding each pair's
    tile, at the maps' own byte offset."""
    from cilium_tpu_torch.ops.seqdfa import apply_staged_bytes

    import merge_cases as mc

    maps = np.zeros((3, 2, 5, 19), np.uint8)  # a pair is 95 bytes
    for off in (0, 1, 15):
        m = mc.at_offset(maps, off, CPU)
        want = 0
        for q in range(6):
            for k0 in range(0, 5, 2):
                a = m.data_ptr() + q * 95 + k0 * 19
                end = a + min(2, 5 - k0) * 19
                want += 16 * ((end + 15) // 16 - a // 16)
        assert apply_staged_bytes(m, 2) == want
    assert apply_staged_bytes(mc.at_offset(maps, 0, CPU), 5) == 16 * sum(
        (q * 95 + 95 + 15) // 16 - q * 95 // 16 for q in range(6))


def test_apply_path_is_checked(tables):
    dfa_abs = device_dfa_absorbing(tables, CPU)
    data, lengths = seqdfa_batch(4, 64, 4)
    maps = seqdfa_fold(dfa_abs, _t(data, torch.uint8), _t(lengths, torch.int32), 4)
    with pytest.raises(ValueError, match="path"):
        seqdfa_apply(dfa_abs, maps, "fast")
    with pytest.raises(ValueError, match="path"):
        seqdfa_apply(dfa_abs, maps, "split")
    for path in ("pick", "walk", "staged"):
        assert torch.equal(seqdfa_apply(dfa_abs, maps, path), seqdfa_apply(dfa_abs, maps))
