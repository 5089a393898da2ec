#!/usr/bin/env python3
"""Time the rule walks K4 ``r2d2_hits``, K9 ``dns_hits``, K10
``cassandra_hits``, K11 ``memcache_hits`` and K17 ``kafka_hits``, and K12
``lpm_lookup``, in variants that their launchers do not take, beside the
variant they do, on one CUDA card.

    python3 chip_hits_variants.py [--variants 1x1,1x8,4x16,8x8,32x16,...]
        [--kafka-variants 8,16,32,8t32] [--lpm-variants 1x2,4x1,walk,...]
        [--kernels r2d2_hits,dns_hits,cassandra_hits,memcache_hits,kafka_hits,lpm_lookup]

A variant ``GxV`` is G lanes a flow and V rows a lane a step
(``csrc/rule_walk.cuh``); K10 also takes ``direct``, a thread a request
walking the rows in order with no staging (``csrc/acl_walk.cuh``, exported
as ``forced_0_0``), and K11 has that walk alone.  As ``chip_frame_variants.py`` does for the
framing kernels, the variants are built into ``_build/variants`` from one
more translation unit a kernel that includes ``csrc/<stem>.cu`` and exports
a launcher of the source's C interface for each variant,
``forced_<G>_<V>``, that runs ``Launch::run<G, V>`` (``direct()`` for
``forced_0_0``); the sources in
``csrc`` stay as they are.  One ``nvcc`` a kernel, both together.  Each
variant is bound with the wrapper's own arguments, held equal to the
launcher's own output and timed (CUDA-graph device ms), the launcher's
pick read first and last at each shape.  The shapes, each the wrapper's
inputs recorded on the main path: K4 at graft, wide and nfa (F = 65,536),
the r2d2 engine's largest rule walk and rule shard 0 of mesh-r2d2 1 x 4;
K9 at dns, dns-stress and dns-names-256 (F = 65,536), the DNS engine's
largest rule walk and rule shard 0 of mesh-dns 1 x 4; K10 and K11 at
``chip_smoke.acl_main_shapes`` (cassandra, cassandra-stress and memcached,
F = 65,536) and ``acl_engine_shapes`` (the two engines' largest calls and
the sidecar's), and beside them, at F = 65,536, K10's direct walk
against its lane walk at R = 2 to 40 (``acl_sweep``: where the launcher's
threshold, ``cassandra_hits.cu``'s kDirectRows, comes from).  K17's variants
``G[tT]`` are G lanes a request (its 8 topic slots spread over them) and at most
T rule rows staged at once (by default as many as 48 KB of shared memory
holds), exported as ``forced_<G>_<T>`` by ``build_kafka_forced``; its
shapes ``chip_smoke.kafka_shapes``: kafka and kafka-fuzz-1..7 (F =
65,536), the Kafka engine's largest step and rule shard 0 of
mesh-kafka-1x4 (``parts=True``).  Prints a line a (shape, variant), then
one JSON object with every reading and the card line.  Needs a CUDA card
and nvcc.

K12's variants ``LxG`` are the index probe with L lanes an address and
G mask groups a round (``forced_<L>x<G>``), and ``walk`` the row walk
(``forced_walk``), built by ``build_lpm_forced`` from a
translation unit that includes ``csrc/lpm.cu``; its shapes are
prefilter, prefilter6 and the ipcache at datapath-maps / datapath6-maps
(the main path's K12 calls, F = 65,536), then ``LPM_SWEEP``:
``tests/l34_index_cases.py`` tables of every prefix length (25 v4 groups,
up to 97 v6) at N rows, with the prefilter's mix of sources, where the
launcher's picks (``lpm.cu``'s ``Pick``: lanes, groups a round and the
walk's threshold ``kWalkRowsPerGroup``) come from.

``build_forced``, ``build_kafka_forced`` and ``build_lpm_forced`` are also
what the card tests force the variants with.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import subprocess
import sys
from pathlib import Path

import torch

LANES = (1, 2, 4, 8, 16, 32)
ROWS = (1, 4, 8, 16)
EVERY = tuple(f"{g}x{v}" for g in LANES for v in ROWS)
STEMS = ("r2d2_hits", "dns_hits")
# K10 and K11: a direct walk (variant (0, 0), "direct").
DIRECT = ("cassandra_hits", "memcache_hits")
# The kernels with lane-group walks (K11 has the direct walk alone).
LANE_WALKS = STEMS + ("cassandra_hits",)


def parse(spec):
    """'8x16' -> (8, 16); 'direct' -> (0, 0)."""
    if spec == "direct":
        return 0, 0
    g, v = (int(x) for x in spec.split("x"))
    if g not in LANES or v not in ROWS:
        raise ValueError(f"bad variant {spec!r}: lanes {LANES}, rows {ROWS}")
    return g, v


def build_forced(stems=STEMS, variants=EVERY, log=print):
    """{(stem, lanes, rows): ctypes launcher}: one library a kernel, built
    together, exporting forced_<G>_<V> for each variant the kernel has
    (forced_0_0, the direct walk, for K10 and K11; the lane groups for
    every kernel but K11)."""
    import importlib

    from cilium_tpu_torch import kernels

    for mod in ("r2d2", "dns", "cassandra", "memcached"):  # their kernels into kernels.ALL
        importlib.import_module(f"cilium_tpu_torch.models.{mod}")
    every = [parse(v) if isinstance(v, str) else v for v in variants]
    procs = {}
    for stem in stems:
        pairs = [(g, v) for g, v in every if stem in (LANE_WALKS if g else DIRECT)]
        k = next(k for k in kernels.ALL if k.stem == stem)
        params = [f"{'int' if t is ctypes.c_int else 'void*'} a{i}" for i, t in enumerate(k.argtypes)]
        names = ", ".join(f"a{i}" for i in range(len(k.argtypes)))
        d = kernels.BUILD / "variants" / f"{stem}-forced"
        d.mkdir(parents=True, exist_ok=True)
        text = f'#include "{stem}.cu"\n\n'
        for g, v in pairs:
            call = f"run<{g}, {v}>()" if g else "direct()"
            text += (f"CILIUM_EXPORT int forced_{g}_{v}({', '.join(params)}, void* stream) {{\n"
                     f"  return make_launch({names}, stream).{call};\n}}\n")
        (d / "forced.cu").write_text(text)
        cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(d / "forced.so"), str(d / "forced.cu")]
        procs[stem] = (d, k, pairs, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
    fns = {}
    for stem, (d, k, pairs, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{stem} variants failed to build:\n{log_text}")
        regs = [ln.strip() for ln in log_text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"built {d.name}: " + " | ".join(regs))
        lib = ctypes.CDLL(str(d / "forced.so"))
        for g, v in pairs:
            fn = getattr(lib, f"forced_{g}_{v}")
            fn.argtypes = [*k.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[(stem, g, v)] = fn
    return fns


KAFKA_VARIANTS = ("1", "2", "4", "8", "16", "32", "1t32", "4t32", "16t32")


def parse_kafka(spec):
    """'16t32' -> (16, 32); tile 0 (the launcher's) unless given."""
    g, _, t = spec.partition("t")
    if int(g) not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"bad K17 variant {spec!r}: 1 to 32 lanes, a power of two")
    return int(g), int(t or 0)


def build_kafka_forced(variants=KAFKA_VARIANTS, log=print):
    """{(lanes, tile rows): ctypes launcher} of K17: one library exporting
    forced_<G>_<T> for each variant, from a translation unit that includes
    csrc/kafka_hits.cu."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models import kafka as kafka_mod

    k = kafka_mod._KAFKA_HITS
    keys = [parse_kafka(v) if isinstance(v, str) else v for v in variants]
    params = [f"{'int' if t is ctypes.c_int else 'void*'} a{i}" for i, t in enumerate(k.argtypes)]
    names = ", ".join(f"a{i}" for i in range(len(k.argtypes)))
    d = kernels.BUILD / "variants" / "kafka_hits-forced"
    d.mkdir(parents=True, exist_ok=True)
    text = '#include "kafka_hits.cu"\n\n'
    for g, t in keys:
        text += (f"CILIUM_EXPORT int forced_{g}_{t}({', '.join(params)}, void* stream) {{\n"
                 f"  Launch l = make_launch({names}, stream);\n  l.tile_cap = {t};\n"
                 f"  return l.run<{g}>();\n}}\n")
    (d / "forced.cu").write_text(text)
    cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(d / "forced.so"),
           str(d / "forced.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kafka_hits variants failed to build:\n{proc.stdout}")
    log(f"built {d.name}: " + " | ".join(
        ln.strip() for ln in proc.stdout.splitlines() if "registers" in ln or "spill" in ln))
    lib = ctypes.CDLL(str(d / "forced.so"))
    fns = {}
    for g, t in keys:
        fn = getattr(lib, f"forced_{g}_{t}")
        fn.argtypes = [*k.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[(g, t)] = fn
    return fns


LPM_VARIANTS = ("1x1", "1x2", "1x4", "1x8", "1x16", "2x1", "2x2", "2x4", "4x1", "4x2", "4x4", "8x1", "8x2",
                "8x4", "walk")
# (W, N) of the threshold sweep, F = 65,536
LPM_SWEEP = ((1, 32), (1, 64), (1, 128), (1, 256), (1, 1024), (4, 128), (4, 256), (4, 512),
             (4, 1024), (4, 2048))


def build_lpm_forced(variants=LPM_VARIANTS, log=print):
    """{variant: ctypes launcher} of K12: ``forced_<L>x<G>`` probes the
    index with L lanes an address and G mask groups a round (at W = 1 and
    4), ``forced_walk`` walks the rows; one library from a translation unit
    that includes csrc/lpm.cu."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.ops import lpm as lpm_mod

    k = lpm_mod._LPM
    d = kernels.BUILD / "variants" / "lpm-forced"
    d.mkdir(parents=True, exist_ok=True)
    text = '#include "lpm.cu"\n\n'
    for v in variants:
        if v == "walk":
            call = "launch<1, 1, 1, 1, lpmk::kWalk>"
        else:
            lanes, g = (int(x) for x in v.split("x"))
            call = f"launch<{lanes}, {g}, {lanes}, {g}, lpmk::kProbe>"
        text += (f"CILIUM_EXPORT int forced_{v}(const LpmArgs* args, void* stream) {{\n"
                 f"  return lpmk::{call}(args, stream);\n}}\n")
    (d / "forced.cu").write_text(text)
    cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(d / "forced.so"),
           str(d / "forced.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"lpm variants failed to build:\n{proc.stdout}")
    log(f"built {d.name}: " + " | ".join(
        ln.strip() for ln in proc.stdout.splitlines() if "Compiling" in ln or "registers" in ln
        or "spill" in ln))
    lib = ctypes.CDLL(str(d / "forced.so"))
    fns = {}
    for v in variants:
        fn = getattr(lib, f"forced_{v}")
        fn.argtypes = [*k.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[v] = fn
    return fns


def lpm_shapes(dev):
    """[(label, DeviceLpm, address word tensors)]: K12's calls on the main
    path (chip_smoke.py phase 8), F = 65,536."""
    import numpy as np

    import chip_smoke as cs
    from cilium_tpu_torch.datapath import pipeline as dp
    from cilium_tpu_torch.datapath import pipeline6 as dp6
    from cilium_tpu_torch.datapath.prefilter import PreFilter
    from cilium_tpu_torch.entry import datapath_batch, datapath_bench_maps
    from cilium_tpu_torch.ops.lpm import ipv6_to_words

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cidrs, src4, src6 = cs.prefilter_case(cs.F)
    pf = PreFilter(dev)
    pf.insert(1, cidrs)
    out = [("prefilter", pf.device_lpm(), (on(cs._i32(src4)),)),
           ("prefilter6", pf.device_lpm(v6=True), tuple(on(w) for w in ipv6_to_words(src6)))]
    pk = datapath_batch(cs.F)
    t4 = dp.build_tables(*datapath_bench_maps(), device=dev)
    out.append(("datapath-maps", t4.ipcache, (dp.datapath_verdicts(t4, *pk)["new_daddr"],)))
    maps6, (_, _, sw, dw, sp, dpt, pr) = cs.datapath6_case(cs.F)
    t6 = dp6.build_tables6(*maps6, device=dev)
    out.append(("datapath6-maps", t6.ipcache, tuple(dp6.datapath_verdicts6(t6, sw, dw, sp, dpt, pr)[
        "new_daddr_words"])))
    return out


def lpm_table(dev, card, fns):
    """K12's readings: the launcher's pick and each forced variant, held to
    the plain version and timed, at the main path's shapes and the sweep's."""
    import numpy as np

    import chip_smoke as cs
    from cilium_tpu_torch.ops.lpm import lpm_from_arrays, lpm_lookup, lpm_lookup_plain

    ic = cs.l34_cases()
    rng = np.random.default_rng(71)
    shapes = lpm_shapes(dev)
    for w, n in LPM_SWEEP:
        t = ic.many_group_lpm(rng, w, n)
        ws = tuple(torch.from_numpy(x).to(dev) for x in ic.lpm_sources(rng, t[0], t[1], cs.F))
        shapes.append((f"sweep-w{w}-n{n}", lpm_from_arrays(*t, device=dev), ws))
    table = []
    for label, lpm, ws in shapes:
        def run():
            return lpm_lookup(lpm, *ws)

        want = cs._outputs(lpm_lookup_plain(lpm, *ws))
        row = dict(shape=label, stem="lpm_lookup", W=lpm.w, N=lpm.n, groups=lpm.index.n_groups,
                   F=ws[0].shape[0])
        pick = [cs.graph_ms(run)]
        for v, fn in [(None, None), *fns.items()]:
            if fn is None:
                got = cs._outputs(run())
            else:
                with forced("lpm", fn):
                    got = cs._outputs(run())
                    row[v] = cs.graph_ms(run)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{label}: K12 {v or 'pick'} disagrees with the plain version")
        pick.append(cs.graph_ms(run))
        row["pick"] = pick
        table.append(row)
        cs.log(f"{label:16s} lpm_lookup W={lpm.w} N={lpm.n} groups={row['groups']}: pick "
               f"{pick[0]:.5f} / {pick[1]:.5f} ms; " + ", ".join(
                   f"{v} {row[v]:.5f}" for v in fns) + f" ms [{card}]")
    return table


def kafka_table(dev, card, fns):
    """K17's readings: each forced variant held equal to the launcher's
    outputs and timed, the launcher's pick read first and last."""
    import chip_smoke as cs
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.kafka import kafka_hits

    table = []
    for label, model, b, rem, parts in cs.kafka_shapes(dev):
        run = lambda: kafka_hits(model, b, rem, parts=parts)  # noqa: E731
        want = cs._outputs(run())
        pick = [cs.graph_ms(run)]
        f, t_n = b.topic_len.shape
        for (g, t), fn in fns.items():
            with forced("kafka_hits", fn):
                if not all(torch.equal(x, y) for x, y in zip(cs._outputs(run()), want)):
                    raise AssertionError(f"{label}: K17 variant {g}t{t} disagrees with the launcher's")
                ms = cs.graph_ms(run)
            table.append(dict(shape=label, stem="kafka_hits", lanes=g, tile=t, ms=ms, F=f,
                              R=model.n_rules, parts=parts))
            cs.log(f"{label:22s} kafka_hits {g:2d} lanes, tile {t or 'as staged'}: {ms:.5f} ms [{card}]")
        pick.append(cs.graph_ms(run))
        variant = kernels.kafka_variant(model.n_rules, f, t_n)
        table.append(dict(shape=label, stem="kafka_hits", pick=variant, ms=pick, F=f, R=model.n_rules,
                          W=b.topics.shape[2], parts=parts))
        cs.log(f"{label:22s} kafka_hits the launcher's {variant} lanes: {pick[0]:.5f} / {pick[1]:.5f} "
               f"ms (F={f}, R={model.n_rules}, W={b.topics.shape[2]}) [{card}]")
    return table


ACL_SWEEP_R = (2, 3, 4, 6, 8, 9, 12, 16, 24, 40)


def acl_sweep(dev, card, fns):
    """Where K10's direct walk stops paying: at F = 65,536 and R of
    ``ACL_SWEEP_R`` (tests/l7_hits_cases.py's tables and batches, the
    4,099-request batch cycled), the direct walk and the lane walk the
    launcher would take without it (a lane a request, the fewest rows a
    step that cover R), each forced, held to the plain version and timed."""
    import numpy as np

    import chip_smoke as cs
    from cilium_tpu_torch.models import cassandra as cm

    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import l7_hits_cases as lc

    table = []
    stem = "cassandra_hits"
    for r in ACL_SWEEP_R:
        t = lc.cass_tables(r)
        b = lc.cass_batch(t, 4099)
        model = lc.cass_model(t, dev)
        rx = lc.rx_hits(t, 4099)
        grow = lambda x: torch.from_numpy(np.ascontiguousarray(np.resize(x, (cs.F, *x.shape[1:])))).to(dev)  # noqa: E731
        args = [grow(b[k]) for k in ("data", "action_len", "table_len", "non_query")]
        args += [None if rx is None else grow(rx), grow(b["remotes"])]
        want = cm.cassandra_hits_plain(model, *args)
        lane = (1, next((v for v in ROWS if v >= r), ROWS[-1]))
        row = dict(stem=stem, R=r, F=cs.F)
        for name, key in (("direct", (0, 0)), (f"{lane[0]}x{lane[1]}", lane)):
            if (stem, *key) not in fns:
                continue
            with forced(stem, fns[(stem, *key)]):
                if not torch.equal(cm.cassandra_hits(model, *args), want):
                    raise AssertionError(f"{stem} R={r}: {name} disagrees with the plain version")
                row[name] = cs.graph_ms(lambda: cm.cassandra_hits(model, *args))
        table.append(row)
        cs.log(f"sweep {stem} R={r:2d} F={cs.F}: " + ", ".join(
            f"{k} {v:.5f} ms" for k, v in row.items() if isinstance(v, float)) + f" [{card}]")
    return table


class forced:
    """Inside ``with forced(stem, fn)``, the wrapper of ``stem`` launches
    ``fn`` (a ``build_forced`` launcher) with its own arguments."""

    def __init__(self, stem, fn):
        from cilium_tpu_torch import kernels

        self.kern = next(k for k in kernels.ALL if k.stem == stem)
        self.fn = fn

    def __enter__(self):
        self.own = self.kern._bind()
        self.kern._fn = self.fn

    def __exit__(self, *exc):
        self.kern._fn = self.own


def shapes(dev, stems=STEMS + DIRECT):
    """[(label, kernel stem, the wrapper's arguments)] on the card for the
    kernels of ``stems``, each recorded where the main path calls the
    wrapper."""
    import chip_smoke as cs
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.models import dns as dns_mod
    from cilium_tpu_torch.models import r2d2 as r2d2_mod
    from cilium_tpu_torch.models.dns import build_dns_model, dns_verdicts_attr
    from cilium_tpu_torch.models.r2d2 import build_r2d2_model, r2d2_verdicts_attr
    from cilium_tpu_torch.parallel import rulesharding as rs
    from cilium_tpu_torch.parallel.mesh import flow_mesh
    from cilium_tpu_torch.runtime.dnsengine import DnsBatchEngine

    def on_card(host):
        return [torch.from_numpy(a).to(dev) for a in host]

    def first_call(mod, stem, run):
        return cs.recorded_calls(mod, stem, run)[0]

    acl = cs.acl_main_shapes(dev) + cs.acl_engine_shapes(dev) if set(DIRECT) & set(stems) else []
    if not {"r2d2_hits", "dns_hits"} & set(stems):
        return acl
    out = []
    rng = random.Random(7)  # chip_smoke.main's order: graft, wide, nfa
    graft_policy = None
    for name, make in (("graft", cs.graft_case), ("wide", cs.wide_case), ("nfa", cs.nfa_case)):
        policy, msgs, remotes, width = make(rng)
        graft_policy = graft_policy or policy
        model = build_r2d2_model(policy, True, 80)
        inp = on_card(cs.tile(msgs, remotes, cs.F, width))
        out.append((name, "r2d2_hits", first_call(
            r2d2_mod, "r2d2_hits", lambda: r2d2_verdicts_attr(model, *inp))))
    model = build_r2d2_model(graft_policy, True, 80)
    feeds = cs.engine_feeds(random.Random(11), 3000)
    calls = cs.recorded_calls(r2d2_mod, "r2d2_hits", lambda: cs.run_engine(model, feeds))
    out.append(("engine", "r2d2_hits", max(calls, key=lambda c: c[3].numel())))

    stress_policy, stress_frames = cs.dns_stress_case()
    names_policy, names_frames = cs.dns_names_case()
    for name, policy, host in (
        ("dns", entry.dns_bench_policy(), entry.dns_batch(cs.F)),
        ("dns-stress", stress_policy, cs.tile_heads(stress_frames, [1] * len(stress_frames), cs.F, 64)),
        ("dns-names-256", names_policy,
         cs.tile_heads(names_frames, [1] * len(names_frames), cs.F, cs.DNS_NAMES_WIDTH)),
    ):
        model = build_dns_model(policy, True, 53)
        inp = on_card(host)
        out.append((name, "dns_hits", first_call(
            dns_mod, "dns_hits", lambda: dns_verdicts_attr(model, *inp))))
    model = build_dns_model(entry.dns_bench_policy(), True, 53)
    feeds = cs.dns_engine_feeds(random.Random(31), 3000)
    calls = cs.recorded_calls(dns_mod, "dns_hits", lambda: cs.run_l7_engine(
        lambda: DnsBatchEngine(model), feeds))
    out.append(("dns-engine", "dns_hits", max(calls, key=lambda c: c[1].dotted.numel())))

    mesh = flow_mesh(1, 4, cs.mesh_slots(dev, 4)[0])
    for fam, build, pol, host, port, mod, stem in (
        ("r2d2", rs.mesh_r2d2_model, entry.bench_policy(), entry.batch(cs.MESH_F, 64), 80,
         r2d2_mod, "r2d2_hits"),
        ("dns", rs.mesh_dns_model, entry.dns_bench_policy(), entry.dns_batch(cs.MESH_F), 53,
         dns_mod, "dns_hits"),
    ):
        model = build(pol, True, port, mesh)
        inp = on_card(host)
        out.append((f"mesh-{fam}-1x4-shard0", stem, first_call(
            mod, stem, lambda: model.verdicts_attr(*inp))))
    return out + acl


def shape_of(stem, args):
    """(F, R) of a recorded call."""
    if stem == "r2d2_hits":
        return tuple(args[3].shape)
    if stem == "dns_hits":
        return args[1].dotted.shape[0], args[0].n_rules
    return args[1].shape[0], args[0].n_rules


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(("direct",) + EVERY))
    ap.add_argument("--kafka-variants", default=",".join(KAFKA_VARIANTS))
    ap.add_argument("--lpm-variants", default=",".join(LPM_VARIANTS))
    ap.add_argument("--kernels", default=",".join(STEMS + DIRECT + ("kafka_hits", "lpm_lookup")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_hits_variants: no CUDA card is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.cassandra import cassandra_hits
    from cilium_tpu_torch.models.dns import dns_hits
    from cilium_tpu_torch.models.memcached import memcache_hits
    from cilium_tpu_torch.models.r2d2 import r2d2_hits

    dev = torch.device("cuda")
    card = cs.card_line()
    kernels.build_all()
    chosen = args.kernels.split(",")
    stems = tuple(s for s in STEMS + DIRECT if s in chosen)
    fns = build_forced(stems, args.variants.split(","), log=cs.log) if stems else {}
    wrappers = {"r2d2_hits": r2d2_hits, "dns_hits": dns_hits, "cassandra_hits": cassandra_hits,
                "memcache_hits": memcache_hits}
    table = []
    if "kafka_hits" in chosen:
        table += kafka_table(dev, card, build_kafka_forced(args.kafka_variants.split(","), log=cs.log))
    if "lpm_lookup" in chosen:
        table += lpm_table(dev, card, build_lpm_forced(args.lpm_variants.split(","), log=cs.log))
    for label, stem, call in shapes(dev, stems) if stems else ():
        if stem not in stems:
            continue
        run = lambda: wrappers[stem](*call)  # noqa: E731
        want = cs._outputs(run())
        pick = [cs.graph_ms(run)]
        f, r = shape_of(stem, call)
        variant = kernels.hits_variant(stem, r, f)
        for (s, g, v), fn in fns.items():
            if s != stem:
                continue
            with forced(stem, fn):
                got = cs._outputs(run())
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{label}: variant {g}x{v} disagrees with the launcher's")
                ms = cs.graph_ms(run)
            table.append(dict(shape=label, stem=stem, lanes=g, rows=v, ms=ms, F=f, R=r))
            cs.log(f"{label:22s} {stem} {g:2d} lanes x {v:2d} rows: {ms:.5f} ms [{card}]")
        pick.append(cs.graph_ms(run))
        table.append(dict(shape=label, stem=stem, pick=variant, ms=pick, F=f, R=r))
        cs.log(f"{label:22s} {stem} the launcher's {variant}: {pick[0]:.5f} / {pick[1]:.5f} ms "
               f"(F={f}, R={r}) [{card}]")
    if "cassandra_hits" in stems:
        table += acl_sweep(dev, card, fns)
    print(json.dumps({"hits_variants": table}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
