"""The port's seam benchmark path at device="cpu" against the JAX package's.

``SeamProbe`` (the plain version of kernel K19) must give the reference
``SeamProbe``'s values and dtypes in both call forms; ``rtt_tick_plain``
(the plain version of kernel K20) the reference's jitted ``x + 1``; a
``seam_probe`` service the reference service's ops, in the matrix and the
blob wire modes, and the same ``seam_stages`` keys; ``_corpus``,
``NullVerdictServer._const_verdict`` and ``MixBench._build_round`` the
reference's bytes.  Small runs of ``LatencyBench``, ``run_paired_colocated``
and ``MixBench`` show the port's benches work end to end on the CPU, and
the probes, the K16 / K19 wrappers given numpy and a default-device
service raise where there is no card and no CPU was asked for.  The blob
lane's call of the probe (``_gather_model``) builds no rows and equals
the reference's.  Every comparison is exact (tolerance 0: bools,
ints and bytes).  The card's K19 and K20 are held against these plain
versions in tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cilium_tpu.proxylib as ref_pl
from cilium_tpu.models.base import SeamProbe as RefSeamProbe
from cilium_tpu.proxylib import instance as ref_inst
from cilium_tpu.sidecar import SidecarClient as RefSidecarClient
from cilium_tpu.sidecar import VerdictService as RefVerdictService
from cilium_tpu.sidecar import latbench as ref_latbench
from cilium_tpu.sidecar import mixbench as ref_mixbench
from cilium_tpu.sidecar import service as ref_service
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig
import cilium_tpu_torch.proxylib as port_pl
from cilium_tpu_torch.models.base import SeamProbe, seam_probe, seam_probe_plain
from cilium_tpu_torch.models.r2d2 import build_r2d2_model
from cilium_tpu_torch.ops.gather import gather_rows
from cilium_tpu_torch.proxylib import instance as port_inst
from cilium_tpu_torch.proxylib.types import MORE, PASS
from cilium_tpu_torch.sidecar import VerdictService, latbench, mixbench, wire
from cilium_tpu_torch.sidecar import service as port_service
from cilium_tpu_torch.utils.option import DaemonConfig
from test_torch_cuda import seam_service_ops


@pytest.fixture(autouse=True)
def _registries():
    """Each test starts and ends with empty module registries on both
    packages: services and in-process oracles register modules there."""
    port_inst.reset_module_registry()
    ref_inst.reset_module_registry()
    yield
    port_inst.reset_module_registry()
    ref_inst.reset_module_registry()


# --- (a) K19's plain version: SeamProbe ---------------------------------------


def _lengths(f, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 65, f).astype(np.int32)
    lengths[rng.random(f) < 0.05] = -1
    lengths[0] = -1 if f > 1 else lengths[0]
    return lengths


@pytest.mark.parametrize("attr", [False, True], ids=["call", "attr"])
@pytest.mark.parametrize("f", [1, 7, 64, 8192])
def test_seam_probe_matches_reference(f, attr):
    lengths = _lengths(f, 40 + f)
    data = np.zeros((f, 64), np.uint8)
    remotes = np.ones(f, np.int32)
    ref_model = RefSeamProbe()
    ref_fn = ref_model.verdicts_attr if attr else ref_model
    want = [np.asarray(x) for x in ref_fn(jnp.asarray(data), jnp.asarray(lengths),
                                          jnp.asarray(remotes))]
    model = SeamProbe(device="cpu")
    port_fn = model.verdicts_attr if attr else model
    for inp in (torch.from_numpy(lengths), lengths):  # a tensor, and numpy (the engine's call)
        got = port_fn(data, inp, remotes)
        assert len(got) == len(want) == (4 if attr else 3)
        for g, w in zip(got, want):
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
        if isinstance(inp, torch.Tensor):
            # K19 writes msg_len as a copy of its own: no output aliases an input
            assert got[1].data_ptr() != inp.data_ptr()
    for g, w in zip(seam_probe_plain(torch.from_numpy(lengths), attr), want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("attr", [False, True], ids=["call", "attr"])
@pytest.mark.parametrize("f", [1, 64, 8192])
def test_blob_lane_builds_no_rows_for_the_probe(f, attr, monkeypatch):
    """The blob lane's call of the seam probe (``_gather_model``) gives the
    reference's values and dtypes and builds no rows: the row build's
    wrapper (K16 on the card) is never called for the probe, and once for
    the r2d2 model through the same function."""
    rng = np.random.default_rng(70 + f)
    blob = rng.integers(0, 256, 65536, dtype=np.uint8)
    offs = rng.integers(-4, 65536, f).astype(np.int32)
    lengths = _lengths(f, 80 + f)
    remotes = np.ones(f, np.int32)
    want = [np.asarray(x) for x in ref_service._gather_model(
        RefSeamProbe(), *(jnp.asarray(a) for a in (blob, offs, lengths, remotes)), 64, attr)]
    calls = []

    def counted(*args):
        calls.append(args)
        return gather_rows(*args)

    monkeypatch.setattr(port_service, "gather_rows", counted)
    args = [torch.from_numpy(a) for a in (blob, offs, lengths, remotes)]
    got = port_service._gather_model(SeamProbe(device="cpu"), *args, 64, attr)
    assert calls == []
    assert len(got) == len(want) == (4 if attr else 3)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    policy = port_pl.compile_policy(port_pl.NetworkPolicy(
        name="p", policy=2, ingress_per_port_policies=[port_pl.PortNetworkPolicy(
            port=80, rules=[port_pl.PortNetworkPolicyRule(
                l7_proto="r2d2", l7_rules=[{"cmd": "READ", "file": "/public/.*"}])])]))
    r2d2 = build_r2d2_model(policy, True, 80, device="cpu")
    out = port_service._gather_model(r2d2, *args, 64, attr)
    assert len(calls) == 1 and len(out) == (4 if attr else 3)


def test_seam_probe_checks_its_inputs(tmp_path):
    with pytest.raises(TypeError, match="lengths"):
        seam_probe(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="lengths"):
        seam_probe(torch.zeros((2, 2), dtype=torch.int32))
    assert SeamProbe(device="cpu").match_kinds == RefSeamProbe.match_kinds == ("probe",)
    # Not a dataclass and no dispatch_bare: the service keys no table shape for it.
    svc = VerdictService(str(tmp_path / "k.sock"), DaemonConfig(verdict_device="cpu"))
    try:
        assert svc._model_shape_key(SeamProbe(device="cpu")) is None
    finally:
        svc.stop()


# --- (b) K20's plain version: rtt_tick ----------------------------------------


def test_rtt_tick_plain_matches_reference():
    tick = jax.jit(lambda x: x + 1)
    rng = np.random.default_rng(8)
    imax, imin = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    cases = [
        np.zeros(8, np.int32),
        rng.integers(imin, imax, 8, dtype=np.int64).astype(np.int32),
        np.full(8, imax, np.int32),
        np.array([imax, imin, -1, 0, 1, imax - 1, 7, -7], np.int32),
    ]
    for x in cases:
        want = np.asarray(tick(jnp.asarray(x)))
        assert want.dtype == np.int32
        for got in (latbench.rtt_tick_plain(torch.from_numpy(x)), latbench.rtt_tick(torch.from_numpy(x)),
                    latbench.rtt_tick(x, device="cpu")):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    assert int(latbench.rtt_tick_plain(torch.tensor([imax], dtype=torch.int32))[0]) == imin
    with pytest.raises(TypeError, match="x"):
        latbench.rtt_tick(torch.zeros(8, dtype=torch.int64))
    assert latbench.measure_device_rtt_ms(n=3, device="cpu") >= 0.0


# --- (c) byte equality of the bench generators ---------------------------------


def test_corpus_and_const_verdict_match_reference():
    for pool, seed in ((256, 7), (4096, 7), (100, 3)):
        got = latbench._corpus(pool, seed)
        want = ref_latbench._corpus(pool, seed)
        assert got[0] == want[0]
        assert got[2] == want[2]
        for g, w in ((got[1], want[1]), (got[3], want[3])):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for seq, ids in ((1, np.arange(1, 257, dtype=np.uint64)), (2**40, np.array([], np.uint64)),
                     (7, np.array([5, 2**63 + 1], np.uint64))):
        got = latbench.NullVerdictServer._const_verdict(seq, ids)
        assert got == ref_latbench.NullVerdictServer._const_verdict(seq, ids)
        vb = wire.unpack_verdict_batch(got)
        assert vb.seq == seq and vb.count == len(ids)


def _mixbench_state(cls, pool=256, n_partial=26, n_pipe=13, n_reply=13):
    """A ``cls`` (either package's MixBench) with its round-build state
    set up as ``__init__`` sets it, without a service (the twin of
    tests/test_reasm.py's builder test)."""
    mb = object.__new__(cls)
    mb.pool = pool
    rng = np.random.default_rng(11)
    mb.frames = []
    for i in range(pool):
        roll = rng.random()
        if roll < 0.4:
            mb.frames.append(f"READ /public/f{i % 997}.txt\r\n".encode())
        elif roll < 0.55:
            mb.frames.append(b"HALT\r\n")
        else:
            mb.frames.append(f"READ /private/f{i % 997}\r\n".encode())
    mb.n_fast = pool - n_partial - n_pipe - n_reply
    mb.n_partial, mb.n_pipe, mb.n_reply = n_partial, n_pipe, n_reply
    mb.pool_rows = np.zeros((pool, 64), np.uint8)
    mb.pool_lens = np.zeros((pool,), np.uint32)
    for i, f in enumerate(mb.frames):
        mb.pool_rows[i, : len(f)] = np.frombuffer(f, np.uint8)
        mb.pool_lens[i] = len(f)
    mb._pool_flat = mb.pool_rows.reshape(-1)
    mb._pool_lens64 = mb.pool_lens.astype(np.int64)
    mb._p_cids = np.arange(mb.n_fast + 1, mb.n_fast + n_partial + 1, dtype=np.int64)
    mb._pi_cids = np.arange(mb.n_fast + n_partial + 1, mb.n_fast + n_partial + n_pipe + 1,
                            dtype=np.int64)
    n0 = mb.n_fast + n_partial + n_pipe
    mb._re_cids = np.arange(n0 + 1, n0 + n_reply + 1, dtype=np.int64)
    mb._data_cids = np.concatenate((mb._p_cids, mb._pi_cids, mb._re_cids)).astype(np.uint64)
    mb._data_flags = np.concatenate((
        np.zeros(n_partial + n_pipe, np.uint8),
        np.full(n_reply, wire.FLAG_REPLY, np.uint8),
    ))
    mb._reply_tail = np.tile(np.frombuffer(b"OK\r\n", np.uint8), n_reply)
    return mb


@pytest.mark.parametrize("shape", [(256, 26, 13, 13), (1000, 100, 50, 50), (64, 0, 3, 0)])
def test_mixbench_build_round_matches_reference(shape):
    port = _mixbench_state(mixbench.MixBench, *shape)
    ref = _mixbench_state(ref_mixbench.MixBench, *shape)
    for r in range(7):
        (pm, pd, pnf, psplit), (rm, rd, rnf, rsplit) = port._build_round(r), ref._build_round(r)
        assert pnf == rnf and psplit == rsplit
        for g, w in zip(pm + pd, rm + rd):
            if isinstance(w, bytes):
                assert g == w
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


# --- (d) a seam_probe service against the reference's ---------------------------


@pytest.mark.parametrize("wire_mode", ["matrix", "blob"])
def test_seam_probe_service_matches_reference(tmp_path, wire_mode):
    modes = (wire_mode,) * 3
    got, stages, status = seam_service_ops(str(tmp_path / "p.sock"), modes, 256,
                                           verdict_device="cpu")
    want, ref_stages, _ = seam_service_ops(
        str(tmp_path / "r.sock"), modes, 256,
        (RefVerdictService, RefDaemonConfig, RefSidecarClient, ref_pl),
        verdict_device="cpu", dispatch_mode="eager")
    assert got == want
    # The seam probe allows every whole frame: a PASS of its length, then MORE.
    msgs = latbench._corpus(256)[0]
    assert [e[2] for e in got[0]] == [[(PASS, len(m)), (MORE, 1)] for m in msgs]
    assert set(stages) == set(ref_stages)
    if wire_mode == "matrix":
        assert set(stages) == {"concat", "eligibility", "device_issue", "readback", "respond"}
        assert all(rec[0] >= 1 for rec in stages.values())
    assert status["containment"]["refused_entries"] == {}


# --- (e) the benches, small, on the CPU -------------------------------------------


def test_latency_bench_answers_every_request(tmp_path):
    bench = latbench.LatencyBench(str(tmp_path / "lb.sock"), verdict_device="cpu", seam_probe=True,
                                  batch_timeout_ms=0.0, client_timeout_ms=0.3, batch_flows=8192,
                                  client_batch=2048)
    try:
        r = bench.run_rate(20_000, 2_000, seed=5)
        assert r.requests == 2_000
        assert r.p50_ms <= r.p90_ms <= r.p99_ms <= r.max_ms
        assert r.achieved_rate > 0
        assert bench.service.dispatch_mode_chosen == "eager"
        assert set(bench.service.seam_stages) == {"concat", "eligibility", "device_issue",
                                                  "readback", "respond"}
    finally:
        bench.close()


def test_paired_colocated_runs_on_the_cpu_when_asked(tmp_path):
    out = latbench.run_paired_colocated(str(tmp_path / "pc.sock"), n_requests=1_000, reps=1,
                                        verdict_device="cpu")
    assert out["seam_100k"].requests == out["null_100k"].requests == 1_000
    assert out["seam_1m"].requests == out["null_1m"].requests == 1_000
    assert len(out["pair_deltas_ms"]) == 1
    assert out["dispatch_mode"] == "eager"
    assert out["seam_transport"]["mode"] == "socket"
    assert set(out["seam_stages_us"]) == {"concat", "eligibility", "device_issue", "readback",
                                          "respond"}


def test_mixbench_runs_the_reassembly_lane(tmp_path):
    b = mixbench.MixBench(str(tmp_path / "mb.sock"), pool=512, batch_flows=1024,
                          verdict_device="cpu")
    try:
        out = b.run(duration_s=1.0, warmup_rounds=2)
    finally:
        b.close()
    assert out["reasm_rounds"] > 0 and out["frames"] > 0
    assert out["verdicts_per_sec"] > 0 and 0 < out["slow_fraction"] < 1


# --- (f) no silent CPU run ------------------------------------------------------


def test_no_card_no_cpu_run(tmp_path, monkeypatch):
    """Without a card, the probes, the K16 / K19 / K20 wrappers given numpy and
    no device, and a default-device seam_probe service raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lengths = np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        seam_probe(lengths)
    with pytest.raises(RuntimeError, match="CUDA device"):
        gather_rows(np.zeros(8, np.uint8), lengths, lengths, 4)
    with pytest.raises(RuntimeError, match="CUDA device"):
        latbench.rtt_tick(lengths)
    with pytest.raises(RuntimeError, match="CUDA device"):
        latbench.measure_device_rtt_ms()
    with pytest.raises(RuntimeError, match="CUDA device"):
        latbench.measure_uplink_mbps()
    with pytest.raises(RuntimeError, match="CUDA device"):
        SeamProbe()
    svc = VerdictService(str(tmp_path / "nocard.sock"), DaemonConfig(seam_probe=True))
    try:
        with pytest.raises(RuntimeError, match="CUDA device"):
            svc.start()
    finally:
        svc.stop()
