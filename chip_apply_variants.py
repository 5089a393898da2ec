#!/usr/bin/env python3
"""Time K18 ``seqdfa_apply`` and K22 ``kafka_shard_combine`` on every path
their launchers have, beside the path each launcher picks, on one CUDA
card.

    python3 chip_apply_variants.py [--baseline-csrc DIR] [--pairs 4,8,16,32,64]
        [--kernels seqdfa_apply,kafka_shard_combine]

K18 apply's paths (``csrc/seqdfa.cu``): ``walk`` (a thread a (flow,
pattern) pair loading each map from global memory) and ``staged`` (a
block stages its pairs' map bytes in shared memory, then walks them
there), forced through ``seqdfa_apply(..., path)``, and the staged path
with each count of ``--pairs`` a block: those come from a library built
here (``build_apply_forced``) from a translation unit that includes
``csrc/seqdfa.cu`` and exports ``forced_p<P>``, the launcher's staged plan
with P pairs a block; the port's own library has no such knob.  Its
shapes are ``chip_smoke.py`` phase 11's: the maps K18's fold writes for
seqdfa-32k and -4k at n_chunks 1, 8 and 64 and seqdfa-32k-adv at 1 and
64.  K22's paths (``csrc/shard_reduce.cu``): ``flow`` (a flow a thread, an
8-byte cover load a shard) and ``general`` (byte loads, any T); its
shapes are phase 13's: random partials at R = 1 to 8 shards of F = 65,536
flows, T = 8, and the merge the 1 x 4 Kafka mesh makes on bench_kafka's
requests.  Every path is held equal to the plain version, then all of a
shape's paths (and, with ``--baseline-csrc``, the parent's kernel through
the same wrapper) are read in turns, three rounds (CUDA-graph device ms;
medians).  Prints a line a shape, then one JSON object with every reading
and the card line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs


def variant_turns(fns, rounds=3, **graph):
    """CUDA-graph ms of each of ``fns`` ({name: fn}), read in turns: the
    names in order, then reversed, ``rounds`` times: {name: [readings]}."""
    names = list(fns)
    out = {n: [] for n in names}
    for i in range(rounds):
        for n in (names if i % 2 == 0 else names[::-1]):
            out[n].append(cs.graph_ms(fns[n], **graph))
    return out


def build_apply_forced(pair_counts, log=print):
    """{P: ctypes launcher with ``seqdfa_apply``'s arguments}: K18 apply's
    staged plan with P pairs a block, one library from a translation unit
    that includes csrc/seqdfa.cu."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.ops import seqdfa

    d = kernels.BUILD / "variants" / "seqdfa-apply-forced"
    d.mkdir(parents=True, exist_ok=True)
    text = '#include "seqdfa.cu"\n\n'
    for n in pair_counts:
        text += (f"CILIUM_EXPORT int forced_p{n}(const void* maps, const void* start, "
                 "const void* accept_final, int F, int R, int S, int K, void* out, void* stream) {\n"
                 "  if (!apply_args_ok(F, R, S, K, kApplyStaged)) return cudaErrorInvalidValue;\n"
                 "  ApplyPlan p = apply_plan(F, R, S, K, kApplyStaged);\n"
                 f"  set_pairs(p, {n});\n"
                 "  return run_apply(p, maps, start, accept_final, F, out, stream);\n}\n")
    (d / "forced.cu").write_text(text)
    cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(d / "forced.so"),
           str(d / "forced.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"seqdfa apply variants failed to build:\n{proc.stdout}")
    log(f"built {d.name}: " + " | ".join(
        ln.strip() for ln in proc.stdout.splitlines() if "Compiling" in ln or "registers" in ln
        or "spill" in ln))
    lib = ctypes.CDLL(str(d / "forced.so"))
    fns = {}
    for n in pair_counts:
        fn = getattr(lib, f"forced_p{n}")
        fn.argtypes = [*seqdfa._SEQDFA_APPLY.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


class forced:
    """Inside ``with forced(kernel, fn)``, ``kernel`` (a ``CudaKernel``)
    launches ``fn`` with its wrapper's own arguments."""

    def __init__(self, kernel, fn):
        self.kern = kernel
        self.fn = fn

    def __enter__(self):
        self.own = self.kern._bind()
        self.kern._fn = self.fn

    def __exit__(self, *exc):
        self.kern._fn = self.own


def apply_table(dev, card, pair_fns):
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.ops import seqdfa as sq

    names = {v: n for n, v in sq.APPLY_PATHS.items()}
    table = []
    for name, c in cs.seqdfa_cases(dev).items():
        dfa = c["abs"]
        maps = sq.seqdfa_fold(dfa, c["d"], c["l"], c["k"])
        f, r, k, s = maps.shape
        want = sq.seqdfa_apply_plain(dfa, maps)
        code, pairs, kt = kernels.seqdfa_apply_variant(f, r, s, k)
        path = names[code]
        fns = {"pick": lambda: sq.seqdfa_apply(dfa, maps)}
        for p in sq.APPLY_PATHS:
            if p != "pick":
                fns[p] = lambda p=p: sq.seqdfa_apply(dfa, maps, p)
        for n, fn in pair_fns.items():
            def staged_p(fn=fn):
                with forced(sq._SEQDFA_APPLY, fn):
                    return sq.seqdfa_apply(dfa, maps)

            fns[f"staged-p{n}"] = staged_p
        if "seqdfa" in cs.BASELINE:
            def parent():
                with cs.parent_kernels(["seqdfa"]):
                    return sq.seqdfa_apply(dfa, maps)

            fns["parent"] = parent
        for label, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: seqdfa_apply {label} != plain")
        turns = variant_turns(fns)
        med = {n: sorted(v)[1] for n, v in turns.items()}
        staged = sq.apply_staged_bytes(maps, sq.apply_variant(f, r, s, k, "staged")[2])
        cs.log(f"{name:18s} seqdfa_apply F={f} R={r} K={k} S={s}: pick {path} P={pairs} kt={kt}; "
               + ", ".join(f"{n} {t:.5f}" for n, t in med.items())
               + f" ms (medians of three in turns); staged reads {staged} bytes [{card}]")
        table.append(dict(kernel="seqdfa_apply", shape=name, F=f, R=r, K=k, S=s, pick=[path, pairs, kt],
                          staged_bytes=staged, turns=turns, medians=med))
    return table


def combine_table(dev, card):
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.parallel import rulesharding as rs
    from cilium_tpu_torch.parallel.mesh import flow_mesh

    g = torch.Generator(device="cpu").manual_seed(13)
    shapes = []
    for r in cs.MESH_K22_RULES:
        f = cs.MESH_F
        shapes.append((f"mesh-k22-R{r}", ((torch.rand((r, f), generator=g) < 0.1).to(dev),
                                          (torch.rand((r, f, 8), generator=g) < 0.7).to(dev),
                                          torch.randint(0, 10, (f,), generator=g, dtype=torch.int32).to(dev),
                                          (torch.rand(f, generator=g) < 0.1).to(dev))))
    batch, rem = entry.kafka_batch(cs.MESH_F)
    kmodel = rs.mesh_kafka_model([(frozenset(), r) for r in entry.kafka_bench_rules()],
                                 flow_mesh(1, 4, cs.mesh_slots(dev, 4)[0]))
    calls = cs.recorded_calls(rs, "kafka_shard_combine",
                              lambda: kmodel(batch.to_device(dev), torch.from_numpy(rem).to(dev)))
    shapes.append(("mesh-kafka-1x4", calls[0][:4]))
    table = []
    for name, args in shapes:
        want = rs.kafka_shard_combine_plain(*args)
        fns = {"pick": lambda: rs.kafka_shard_combine(*args)}
        for p in cs.combine_paths(args[1]):
            fns[p] = lambda p=p: rs.kafka_shard_combine(*args, path=p)
        if "shard_reduce" in cs.BASELINE:
            def parent():
                with cs.parent_kernels(["shard_reduce"]):
                    return rs.kafka_shard_combine(*args)

            fns["parent"] = parent
        for label, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: kafka_shard_combine {label} != plain")
        turns = variant_turns(fns)
        med = {n: sorted(v)[1] for n, v in turns.items()}
        r, f = args[0].shape
        cs.log(f"{name:18s} kafka_shard_combine R={r} F={f} T={args[1].shape[2]}: pick "
               f"{rs.combine_variant(args[1])}; " + ", ".join(f"{n} {t:.5f}" for n, t in med.items())
               + f" ms (medians of three in turns) [{card}]")
        table.append(dict(kernel="kafka_shard_combine", shape=name, R=r, F=f,
                          pick=rs.combine_variant(args[1]), turns=turns, medians=med))
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-csrc", metavar="DIR", help="a parent commit's cilium_tpu_torch/csrc: "
                    "its kernels read in turns beside every path")
    ap.add_argument("--pairs", default="4,8,16,32,64", help="staged path: pairs a block to force")
    ap.add_argument("--kernels", default="seqdfa_apply,kafka_shard_combine")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_apply_variants: no CUDA card is available", file=sys.stderr)
        return 2
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.ops import seqdfa  # noqa: F401  (K18 in kernels.ALL)
    from cilium_tpu_torch.parallel import rulesharding  # noqa: F401  (K21 / K22 in kernels.ALL)

    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log("card:", card)
    kernels.build_all()
    if args.baseline_csrc:
        cs.log("built the parent's", ", ".join(cs.build_baseline(args.baseline_csrc)))
    which = args.kernels.split(",")
    table = []
    if "seqdfa_apply" in which:
        pair_counts = sorted({int(x) for x in args.pairs.split(",") if x})
        table += apply_table(dev, card, build_apply_forced(pair_counts, log=cs.log) if pair_counts else {})
    if "kafka_shard_combine" in which:
        table += combine_table(dev, card)
    print(json.dumps({"card": card, "readings": table}, default=lambda x: np.asarray(x).tolist()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
