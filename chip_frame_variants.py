#!/usr/bin/env python3
"""Time the framing kernels K1 ``r2d2_frame``, K5 ``http_frame`` and K8
``dns_name`` in launch variants that their launchers do not take, beside
the variant they do, on one CUDA card.

    python3 chip_frame_variants.py [--variants 4x1,8x1,16x1,32x1,32x4,4x1e0,4x1b8]
        [--name-variants 4x1,8x1,32x1,4x1t64] [--kernels r2d2_frame,http_frame,dns_name]

A variant ``GxV[eE][bB]`` is G lanes a row, V 16-byte chunks a lane a step,
E bytes of a row loaded before its length arrives (default 128, as built)
and B blocks an SM that ``__launch_bounds__`` must allow (default: none,
as built).  Each is built into ``_build/variants`` from copies of
``csrc/<stem>.cu`` and ``csrc/frame_scan.cuh`` (E and B written into the
copies) with one more translation unit that includes the copy and exports
a launcher of the source's C interface that runs ``Launch::run<G, V, A>``;
the sources in ``csrc`` stay as they are.  One ``nvcc`` each, all
together.  Each variant is bound with the wrapper's own arguments, held
equal to the launcher's own output and timed (CUDA-graph device ms), the
launcher's pick read first and last at each shape.  The shapes: K1 at
graft, wide and nfa (F = 65,536) and the largest call of the r2d2 engine's
run at each width; K5 at http-graft, http-stress and http-head (F =
65,536), the largest call of the HTTP engine's run at each width, the 64 x
32,768 bucket around ``LONG_HEAD``, and http-graft's heads at 1,024 and
2,048 rows of 512 and 1,024 bytes; each engine call of fewer than 1,024
rows also cycled to 1,024 and 4,096 rows (the edges of the launcher's
rule).

K8's variants ``GxV[tT]`` (G lanes a row, V chunks a lane a step, T
threads a block, by default the launcher's) are built as
``chip_hits_variants.py`` builds K4's: one more translation unit that
includes ``csrc/dns_name.cu`` and exports ``forced_<G>_<V>_<T>`` for each
(``build_name_forced``, which the card tests force the variants with).
K8's shapes: dns and dns-stress (65,536 x 64), dns-names-256 (65,536 x
128), the DNS engine's largest call and the sidecar's DNS bucket
(``chip_smoke.dns_name_shapes``).
Prints a line a (shape, variant), then one JSON object with every reading
and the card line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import re
import subprocess
import sys

import torch

import chip_smoke as cs


def parse(spec):
    """'32x4e0b8' -> (32, 4, 0, 8); eager 128 and blocks 0 (none) unless given."""
    m = re.fullmatch(r"(\d+)x(\d+)(?:e(\d+))?(?:b(\d+))?", spec)
    if not m:
        raise ValueError(f"bad variant {spec!r}")
    lanes, vecs, eager, blocks = m.groups()
    return int(lanes), int(vecs), int(eager or 128), int(blocks or 0)


def patched(text, old, new):
    if old not in text:
        raise RuntimeError(f"{old!r} is not in the source: the variant cannot be built")
    return text.replace(old, new)


def build_variants(stems, variants):
    """{(stem, lanes, vecs, eager, blocks): ctypes launcher}, built together."""
    from cilium_tpu_torch import kernels

    procs = {}
    for stem in stems:
        k = next(k for k in kernels.ALL if k.stem == stem)
        outs = len(k.argtypes) - 4  # data, lengths, F, L, then the outputs
        for lanes, vecs, eager, blocks in variants:
            key = (stem, lanes, vecs, eager, blocks)
            d = kernels.BUILD / "variants" / f"{stem}-{lanes}x{vecs}-e{eager}-b{blocks}"
            d.mkdir(parents=True, exist_ok=True)
            (d / "frame_scan.cuh").write_text(patched(
                (kernels.CSRC / "frame_scan.cuh").read_text(), "constexpr int kEager = 128;",
                f"constexpr int kEager = {eager};"))
            src = (kernels.CSRC / f"{stem}.cu").read_text()
            if blocks:
                src = patched(src, "__launch_bounds__(kThreads)", f"__launch_bounds__(kThreads, {blocks})")
            (d / f"{stem}.cu").write_text(src)
            o = [f"o{i}" for i in range(outs)]
            (d / "forced.cu").write_text(
                f'#include "{stem}.cu"\n\n'
                f'CILIUM_EXPORT int forced(const void* data, const void* lengths, int F, int L, '
                f'{", ".join("void* " + x for x in o)}, void* stream) {{\n'
                f'  const Launch launch{{data, lengths, F, L, {", ".join(o)}, '
                f'static_cast<cudaStream_t>(stream)}};\n'
                f'  return frame::geometry(L, F, data).aligned ? launch.run<{lanes}, {vecs}, true>()\n'
                f'                                             : launch.run<{lanes}, {vecs}, false>();\n'
                f'}}\n')
            cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
                   str(d / "forced.so"), str(d / "forced.cu")]
            procs[key] = (d, k, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (d, k, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key} failed to build:\n{log_text}")
        regs = [ln.strip() for ln in log_text.splitlines() if "registers" in ln or "spill" in ln]
        cs.log(f"built {d.name}: " + " | ".join(regs))
        fn = ctypes.CDLL(str(d / "forced.so")).forced
        fn.argtypes = [*k.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


NAME_VARIANTS = ("1x4", "2x2", "2x4", "4x1", "4x2", "4x4", "8x1", "8x2", "16x1", "32x1", "2x2t128",
                 "4x1t128", "8x1t64", "16x1t64", "32x1t64")


def parse_name(spec):
    """'4x1t64' -> (4, 1, 64): G lanes a row, V chunks a lane, T threads a
    block (0: the launcher's)."""
    m = re.fullmatch(r"(\d+)x(\d+)(?:t(\d+))?", spec)
    if not m or int(m.group(1)) not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"bad K8 variant {spec!r}")
    return int(m.group(1)), int(m.group(2)), int(m.group(3) or 0)


def build_name_forced(variants=NAME_VARIANTS, log=print):
    """{(lanes, vecs, threads): ctypes launcher} of K8: one library
    exporting forced_<G>_<V>_<T> for each variant, from a translation unit
    that includes csrc/dns_name.cu."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models import dns as dns_mod

    k = dns_mod._DNS_NAME
    keys = [parse_name(v) if isinstance(v, str) else v for v in variants]
    d = kernels.BUILD / "variants" / "dns_name-forced"
    d.mkdir(parents=True, exist_ok=True)
    outs = ", ".join(f"void* o{i}" for i in range(6))
    names = ", ".join(f"o{i}" for i in range(6))
    text = '#include "dns_name.cu"\n\n'
    for g, v, t in keys:
        text += (f"CILIUM_EXPORT int forced_{g}_{v}_{t}(const void* data, const void* lengths, "
                 f"int F, int L, {outs}, void* stream) {{\n"
                 f"  Launch l = make_launch(data, lengths, F, L, {names}, stream);\n"
                 + (f"  l.geom.threads = {t};\n" if t else "")
                 + f"  return l.geom.aligned ? l.run<{g}, {v}, true>() : l.run<{g}, {v}, false>();\n}}\n")
    (d / "forced.cu").write_text(text)
    cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(d / "forced.so"),
           str(d / "forced.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"dns_name variants failed to build:\n{proc.stdout}")
    log(f"built {d.name}: " + " | ".join(
        ln.strip() for ln in proc.stdout.splitlines() if "registers" in ln or "spill" in ln))
    lib = ctypes.CDLL(str(d / "forced.so"))
    fns = {}
    for key in keys:
        fn = getattr(lib, "forced_{}_{}_{}".format(*key))
        fn.argtypes = [*k.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def name_shapes(dev):
    """K8's [(label, "dns_name", data, lengths)] on the card."""
    from cilium_tpu_torch import entry

    _, stress = cs.dns_stress_case()
    out = [("dns", *entry.dns_batch(cs.F)[:2]),
           ("dns-stress", *cs.tile_heads(stress, [1] * len(stress), cs.F, 64)[:2])]
    out = [(n, "dns_name", *(torch.from_numpy(a).to(dev) for a in host)) for n, *host in out]
    return out + [(n, "dns_name", d, ln) for n, d, ln in cs.dns_name_shapes(dev)]


def largest_by_width(calls):
    """The call with the most rows at each width, widest first."""
    best = {}
    for data, lengths in calls:
        f, l = data.shape
        if l not in best or f > best[l][0].shape[0]:
            best[l] = (data, lengths)
    return [best[l] for l in sorted(best, reverse=True)]


def shapes(dev):
    """[(label, kernel stem, data, lengths)] on the card."""
    from cilium_tpu_torch.flowlog import FlowLog
    from cilium_tpu_torch.models import http as http_mod
    from cilium_tpu_torch.models import r2d2 as r2d2_mod
    from cilium_tpu_torch.models.http import build_http_model_for_port
    from cilium_tpu_torch.models.r2d2 import build_r2d2_model

    out = []
    rng = random.Random(7)  # chip_smoke.main's order: graft, wide, nfa
    graft_policy = None
    for name, make in (("graft", cs.graft_case), ("wide", cs.wide_case), ("nfa", cs.nfa_case)):
        policy, msgs, remotes, width = make(rng)
        graft_policy = graft_policy or policy
        data, lengths, _ = cs.tile(msgs, remotes, cs.F, width)
        out.append((name, "r2d2_frame", data, lengths))
    heads = None
    for make in (cs.http_graft_cases, cs.http_stress_cases, cs.http_head_cases):
        models, reqs, remotes, width = make()
        heads = heads or (reqs, remotes)
        data, lengths, _ = cs.tile_heads(reqs, remotes, cs.F, width)
        out.append((next(iter(models)).replace("-lit", ""), "http_frame", data, lengths))
    for f in (1024, 2048):
        for width in (512, 1024):
            data, lengths, _ = cs.tile_heads(*heads, f, width)
            out.append((f"http-graft-{f}x{width}", "http_frame", data, lengths))
    long_head = cs.frame_cases().long_head_batch()
    out.append(("http-long-head", "http_frame", *long_head))
    out = [(n, k, *(torch.from_numpy(a).to(dev) for a in (d, ln))) for n, k, d, ln in out]
    model = build_r2d2_model(graft_policy, True, 80)
    feeds = cs.engine_feeds(random.Random(11), 3000)
    calls = cs.recorded_calls(r2d2_mod, "r2d2_frame", lambda: cs.run_engine(model, feeds))
    out += engine_shapes("engine", "r2d2_frame", calls)
    policy, backend = cs.http_graft_cases()[0]["http-graft"]
    hmodel = build_http_model_for_port(policy, True, 80, backend)
    hfeeds = cs.http_engine_feeds(random.Random(13), 3000)
    calls = cs.recorded_calls(http_mod, "http_frame", lambda: cs.run_http_engine(
        hmodel, hfeeds, FlowLog(capacity=1 << 20)))
    return out + engine_shapes("http-engine", "http_frame", calls)


def name_table(dev, card, fns, dns_name):
    """K8's readings: each forced variant held equal to the launcher's
    output and timed, the launcher's pick read first and last."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models import dns as dns_mod

    kern = dns_mod._DNS_NAME
    table = []
    for label, _, data, lengths in name_shapes(dev):
        own = kern._bind()
        run = lambda: dns_name(data, lengths)  # noqa: E731
        want = run()
        pick = [cs.graph_ms(run)]
        for (g, v, t), fn in fns.items():
            kern._fn = fn
            try:
                got = run()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"{label}: K8 variant {g}x{v}t{t} disagrees with the launcher's")
                ms = cs.graph_ms(run)
            finally:
                kern._fn = own
            table.append(dict(shape=label, stem="dns_name", lanes=g, chunks=v, threads=t, ms=ms,
                              F=data.shape[0], L=data.shape[1]))
            cs.log(f"{label:22s} dns_name {g:2d} lanes x {v} chunks, threads {t or 'as picked'}: "
                   f"{ms:.5f} ms [{card}]")
        pick.append(cs.graph_ms(run))
        variant = kernels.name_variant(data)
        # the same bytes copied by torch: what reading and writing them costs
        copy = torch.empty_like(data)
        copy_ms = cs.graph_ms(lambda: copy.copy_(data))
        table.append(dict(shape=label, stem="dns_name", pick=variant, ms=pick, F=data.shape[0],
                          L=data.shape[1], copy_ms=copy_ms))
        cs.log(f"{label:22s} dns_name the launcher's {variant}: {pick[0]:.5f} / {pick[1]:.5f} ms; "
               f"torch copy of the rows {copy_ms:.5f} ms [{card}]")
    return table


def engine_shapes(label, stem, calls):
    """The largest of an engine's calls at each width, and those of fewer
    than 1,024 rows cycled to 1,024 and 4,096 rows (as many rows of the
    same contents)."""
    out = []
    for data, lengths in largest_by_width(calls):
        f, l = data.shape
        out.append((f"{label}-{f}x{l}", stem, data, lengths))
        for rows in (1024, 4096) if f < 1024 else ():
            idx = torch.arange(rows, device=data.device) % f
            out.append((f"{label}-{f}x{l}-as-{rows}", stem, data[idx].contiguous(), lengths[idx].contiguous()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="4x1,8x1,16x1,32x1,32x4,4x1e0,4x1e65536,4x1b8,32x4b8")
    ap.add_argument("--name-variants", default=",".join(NAME_VARIANTS))
    ap.add_argument("--kernels", default="r2d2_frame,http_frame,dns_name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_frame_variants: no CUDA card is available", file=sys.stderr)
        return 2
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.dns import dns_name
    from cilium_tpu_torch.models.http import http_frame
    from cilium_tpu_torch.models.r2d2 import r2d2_frame

    dev = torch.device("cuda")
    card = cs.card_line()
    kernels.build_all()
    chosen = args.kernels.split(",")
    stems = {k: w for k, w in (("r2d2_frame", r2d2_frame), ("http_frame", http_frame)) if k in chosen}
    fns = build_variants(stems, [parse(v) for v in args.variants.split(",")]) if stems else {}
    table = []
    if "dns_name" in chosen:
        table += name_table(dev, card, build_name_forced(args.name_variants.split(","), log=cs.log),
                            dns_name)
    for label, stem, data, lengths in shapes(dev) if stems else ():
        if stem not in stems:
            continue
        wrapper = stems[stem]
        kern = next(k for k in kernels.ALL if k.stem == stem)
        own = kern._bind()
        run = lambda: wrapper(data, lengths)  # noqa: E731
        want = run()
        pick = [cs.graph_ms(run)]
        variant = kernels.frame_variant(stem, data)
        row = (cs.k1_row if stem == "r2d2_frame" else cs.k5_row)(data, lengths, want)
        for key, fn in fns.items():
            if key[0] != stem:
                continue
            kern._fn = fn
            try:
                got = run()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{label}: variant {key} disagrees with the launcher's")
                ms = cs.graph_ms(run)
            finally:
                kern._fn = own
            table.append(dict(shape=label, stem=stem, lanes=key[1], chunks=key[2], eager=key[3],
                              min_blocks=key[4], ms=ms, F=data.shape[0], L=data.shape[1]))
            cs.log(f"{label:22s} {stem} {key[1]:2d} lanes x {key[2]} chunks, eager {key[3]:5d}, "
                   f"{key[4]} blocks an SM: {ms:.5f} ms [{card}]")
        pick.append(cs.graph_ms(run))
        table.append(dict(shape=label, stem=stem, pick=variant, ms=pick, F=data.shape[0],
                          L=data.shape[1], bound_ms=row["bound_ms"], bound_by=row["bound_by"]))
        cs.log(f"{label:22s} {stem} the launcher's {variant}: {pick[0]:.5f} / {pick[1]:.5f} ms, "
               f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}) [{card}]")
    print(json.dumps({"frame_variants": table}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
