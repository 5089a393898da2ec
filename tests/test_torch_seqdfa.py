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
    device_dfa_absorbing,
    make_absorbing,
    seqdfa_apply,
    seqdfa_fold,
    seqdfa_fold_plain,
    seqdfa_search_batch,
    seqdfa_search_batch_plain,
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
