#!/usr/bin/env python3
"""Drive the port's r2d2 and HTTP verdict paths on one CUDA card and check
them.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them.  It builds
the kernels from ``cilium_tpu_torch/csrc`` and runs these phases, each of
which fails the run on any mismatch:

1. environment: card name and power limit, torch, CUDA, nvcc, and each
   kernel's registers, shared memory and spills (``-Xptxas -v``);
2. main path, counted: every kernel's launch count is set to 0, then
   ``r2d2_verdicts`` / ``r2d2_verdicts_attr`` run on three r2d2 policies
   (graft, wide, nfa), ``R2d2BatchEngine`` judges 3,000 flows,
   ``http_verdicts`` / ``http_verdicts_attr`` run on five HTTP models
   (http-graft, the three http-stress models, http-head) and
   ``HttpBatchEngine`` judges 3,000 flows with a flow log; the counts are
   read right after, every kernel must have launched, and each run's own
   launches (the deltas around it, and around each automaton search on an
   HTTP span) must add up to them; K5-K7 launch once per HTTP call and
   K2/K3 on the HTTP spans exactly where the reference searches;
3. model: the card's verdicts against the same calls at device="cpu" and
   against the host oracle ``PolicyInstance.matches_at`` (on parsed heads
   for HTTP);
4. engines: the card engines' ops and injects against the CPU engines'
   and, for HTTP, against the streaming ``HttpParser``'s, and the HTTP
   flow records against the CPU engine's;
5. kernels against their plain PyTorch versions on the card, at the main
   path's inputs (exact equality: every output is bool or int);
6. times: CUDA events around each kernel, its plain version and each
   verdict pass, bounds from the run's own data, and the engines on the
   host clock and under the profiler, with the card's name and power
   limit.

It prints the ``kernels`` JSON line, then the card line, then the result
line last.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM peak outside the tensor cores (fp32)
F = 65536


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --- policies and batches ----------------------------------------------------


def graft_case(rng):
    """bench.py's r2d2 policy and message mix (bench.py:128-172)."""
    from cilium_tpu_torch.entry import bench_policy

    msgs = []
    for _ in range(1024):
        roll = rng.random()
        if roll < 0.35:
            msgs.append(f"READ /public/file{rng.randrange(1000)}.txt".encode())
        elif roll < 0.5:
            msgs.append(b"HALT")
        elif roll < 0.75:
            msgs.append(f"READ /private/file{rng.randrange(1000)}".encode())
        else:
            msgs.append(f"WRITE /public/f{rng.randrange(1000)}".encode())
    return bench_policy(), msgs, [1] * len(msgs), 64


WIDE_TAIL = "(a|b)" * 7


def _rules_policy(name, rows):
    from cilium_tpu_torch.proxylib import (
        NetworkPolicy,
        PortNetworkPolicy,
        PortNetworkPolicyRule,
        compile_policy,
    )

    rules = [
        PortNetworkPolicyRule(
            remote_policies=[remote], l7_proto="r2d2",
            l7_rules=[{"cmd": "READ", "file": pattern}],
        )
        for remote, pattern in rows
    ]
    return compile_policy(NetworkPolicy(
        name=name, policy=2,
        ingress_per_port_policies=[PortNetworkPolicy(port=80, rules=rules)],
    ))


def _wide_message(rng, j):
    tok = rng.choice(["ab12", "zz9", "Q7", "k" * rng.randrange(1, 20)])
    tail = "".join(rng.choice("abcdefgh/._-") for _ in range(rng.randrange(0, 180)))
    cmd = "READ" if rng.random() < 0.85 else "WRITE"
    return f"{cmd} /g{j:02d}/{tok}/item/{tail}".encode()


def wide_case(rng):
    """64 rows in bench.py:861 _stress_regex_path's convention; a hit/miss
    mix (rows 64-69, upper-case tokens, WRITE and remote 8 never match)."""
    rows = [(1 + j % 7, f"/g{j:02d}/[a-z0-9]+/item/.*") for j in range(64)]
    msgs = [_wide_message(rng, rng.randrange(70)) for _ in range(1024)]
    remotes = [1 + rng.randrange(8) for _ in msgs]
    return _rules_policy("wide", rows), msgs, remotes, 256


def nfa_case(rng):
    """6 wide rows plus 2 rows of bench.py:872 _stress_nfa_path, whose DFA
    exceeds the 128-state guard: the NFA runs."""
    rows = [(1 + j % 7, f"/g{j:02d}/[a-z0-9]+/item/.*") for j in range(6)]
    rows += [(1 + (6 + j) % 7, f"/n{j:02d}/(a|b)*a{WIDE_TAIL}/x") for j in range(2)]
    msgs, remotes = [], []
    for _ in range(512):
        if rng.random() < 0.5:
            j = rng.randrange(3)
            ab = "".join(rng.choice("ab") for _ in range(rng.randrange(4, 24)))
            msgs.append(f"READ /n{j:02d}/{ab}/x".encode())
        else:
            msgs.append(_wide_message(rng, rng.randrange(8))[:58])
        remotes.append(1 + rng.randrange(8))
    return _rules_policy("nfa", rows), msgs, remotes, 64


def tile(msgs, remotes, f, width):
    """[f, width] rows cycling the framed messages."""
    n = len(msgs)
    data = np.zeros((n, width), np.uint8)
    lengths = np.zeros((n,), np.int32)
    for i, m in enumerate(msgs):
        framed = m + b"\r\n"
        data[i, : len(framed)] = np.frombuffer(framed, np.uint8)
        lengths[i] = len(framed)
    reps = -(-f // n)
    return (
        np.ascontiguousarray(np.tile(data, (reps, 1))[:f]),
        np.ascontiguousarray(np.tile(lengths, reps)[:f]),
        np.ascontiguousarray(np.tile(np.asarray(remotes, np.int32), reps)[:f]),
    )


def engine_feeds(rng, n_flows):
    """Three rounds of (flow, chunk, remote): several frames per buffer,
    partial frames, frames longer than 256 bytes (the 512 bucket)."""
    rounds = [[], [], []]
    for fid in range(n_flows):
        msgs = []
        for _ in range(rng.randrange(1, 5)):
            roll = rng.random()
            if roll < 0.4:
                msgs.append(f"READ /public/f{rng.randrange(99)}.txt")
            elif roll < 0.6:
                msgs.append("HALT")
            elif roll < 0.8:
                msgs.append(f"READ /private/f{rng.randrange(99)}")
            else:
                msgs.append(f"WRITE /x{rng.randrange(9)}")
        if fid % 50 == 0:
            msgs.append("READ /public/" + "z" * rng.randrange(260, 400) + ".txt")
        stream = "".join(m + "\r\n" for m in msgs).encode()
        cut1 = rng.randrange(0, len(stream) + 1)
        cut2 = rng.randrange(cut1, len(stream) + 1)
        tail = b"HALT" if fid % 3 else b""
        for rnd, chunk in zip(rounds, (stream[:cut1], stream[cut1:cut2], stream[cut2:] + tail)):
            rnd.append((fid, chunk, 1 if fid % 5 else 2))
    return rounds


def run_engine(model, rounds):
    from cilium_tpu_torch.runtime.batch import R2d2BatchEngine

    eng = R2d2BatchEngine(model, capacity=2048, width=256)
    out = []
    for rnd in rounds:
        for fid, chunk, remote in rnd:
            eng.feed(fid, chunk, remote_id=remote)
        eng.pump()
        for fid, _, _ in rnd:
            ops, inject = eng.take_ops(fid)
            out.append((fid, [(int(op), n) for op, n in ops], inject))
    return out


# --- HTTP policies, batches and traffic ----------------------------------------


def _http_policy(name, rules):
    """An NPDS policy on port 80 from (remote_policies, http_rules) pairs."""
    from cilium_tpu_torch.proxylib import (
        NetworkPolicy,
        PortNetworkPolicy,
        PortNetworkPolicyRule,
        compile_policy,
    )

    return compile_policy(NetworkPolicy(
        name=name, policy=2,
        ingress_per_port_policies=[PortNetworkPolicy(port=80, rules=[
            PortNetworkPolicyRule(remote_policies=list(remotes), http_rules=list(http))
            for remotes, http in rules
        ])],
    ))


def http_graft_cases():
    """bench.py:205-240 bench_http: GET /public/.*, random.Random(11)'s
    1,024 requests with Host and User-Agent headers, L = 512."""
    from cilium_tpu_torch.entry import http_bench_policy, http_requests

    reqs = http_requests()
    return {"http-graft": (http_bench_policy(), "auto")}, reqs, [1] * len(reqs), 512


NFA_TAIL = "(a|b)" * 7


def http_stress_cases():
    """bench.py:893-940 _stress_http_models for policy 0 (12 literal-prefix
    rules; 6 regex rules with backend "dfa"; 2 rules whose DFA passes the
    128-state guard, backend "auto" -> NFA) and bench.py:1060-1103's request
    mix for policy 0 from random.Random(23), L = 64."""
    lit = [{"method": "GET", "path": f"/svc000/r{j:02d}/.*"} for j in range(12)]
    rx = [{"method": "GET", "path": f"/g{j:02d}/[a-z0-9]+/item/.*"} for j in range(6)]
    nfa = [{"method": "GET", "path": f"/n{j:02d}/(a|b)*a{NFA_TAIL}/x"} for j in range(2)]
    cases = {
        "http-stress-lit": (_http_policy("stress-lit", [([], lit)]), "auto"),
        "http-stress-dfa": (_http_policy("stress-dfa", [([], rx)]), "dfa"),
        "http-stress-nfa": (_http_policy("stress-nfa", [([], nfa)]), "auto"),
    }
    rng = random.Random(23)
    reqs = []
    for _ in range(1024):
        roll = rng.random()
        if roll < 0.30:
            method, path = "GET", f"/svc000/r{rng.randrange(12):02d}/items/x{rng.randrange(1000)}"
        elif roll < 0.47:
            method, path = "GET", f"/g{rng.randrange(6):02d}/ab{rng.randrange(1000)}z/item/{rng.randrange(10)}"
        elif roll < 0.55:
            method, path = "GET", f"/g{rng.randrange(6):02d}/ABC/item/1"
        elif roll < 0.63:
            seg = "ab" * rng.randrange(3) + "a" + "".join(rng.choice("ab") for _ in range(7))
            method, path = "GET", f"/n{rng.randrange(2):02d}/{seg}/x"
        elif roll < 0.70:
            seg = "b" + "".join(rng.choice("ab") for _ in range(7))
            method, path = "GET", f"/n{rng.randrange(2):02d}/{seg}/x"
        elif roll < 0.78:
            method, path = "POST", f"/svc000/r{rng.randrange(12):02d}/items/y"
        elif roll < 0.9:
            method, path = "GET", f"/svc000/r{rng.randrange(12) + 50}/z"
        else:
            method, path = "GET", "/svc001/q/"
        reqs.append(f"{method} {path} HTTP/1.1\r\n\r\n".encode())
    return cases, reqs, [1] * len(reqs), 64


def http_head_cases():
    """The five rules of tests/test_http_model.py:237-242's four rule sets
    as one policy, with remote sets, and that test's request generator
    (random.Random(5)); remotes 1-4, L = 512.  Host and header patterns
    run through K2 over [line_end, head_len - 2), /pub(lic)?/.* and
    /a/[0-9]+ through K2 on the path span."""
    policy = _http_policy("head", [
        ([], [{"method": "GET|HEAD", "path": "/pub(lic)?/.*"}]),
        ([1, 2], [{"path": "/a/[0-9]+"}, {"method": "PUT"}]),
        ([2, 4], [{"host": ".*\\.internal"}]),
        ([1, 3], [{"method": "GET", "headers": ["X-A: 1", "X-B: 2"]}]),
    ])
    rng = random.Random(5)
    methods = ["GET", "PUT", "HEAD", "POST"]
    paths = ["/public/x", "/pub/y", "/a/12", "/a/xy", "/other"]
    hosts = [None, "svc.internal", "svc.external"]
    hdrs = [[], ["X-A: 1"], ["X-A: 1", "X-B: 2"], ["X-B: 2"]]
    reqs, remotes = [], []
    for _ in range(1024):
        headers = list(rng.choice(hdrs))
        host = rng.choice(hosts)
        if host:
            headers = [f"Host: {host}"] + headers
        head = f"{rng.choice(methods)} {rng.choice(paths)} HTTP/1.1\r\n"
        reqs.append((head + "".join(h + "\r\n" for h in headers) + "\r\n").encode())
        remotes.append(1 + rng.randrange(4))
    return {"http-head": (policy, "auto")}, reqs, remotes, 512


def tile_heads(reqs, remotes, f, width):
    """[f, width] rows cycling the request heads."""
    n = len(reqs)
    data = np.zeros((n, width), np.uint8)
    lengths = np.zeros((n,), np.int32)
    for i, r in enumerate(reqs):
        data[i, : len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    reps = -(-f // n)
    return (
        np.ascontiguousarray(np.tile(data, (reps, 1))[:f]),
        np.ascontiguousarray(np.tile(lengths, reps)[:f]),
        np.ascontiguousarray(np.tile(np.asarray(remotes, np.int32), reps)[:f]),
    )


LONG_HEAD = b"GET /private/" + b"y" * 33000 + b" HTTP/1.1\r\nHost: svc.local\r\n\r\n"


def http_engine_feeds(rng, n_flows):
    """Three rounds of (flow, chunk, remote) on the http-graft policy:
    several requests per buffer, Content-Length bodies, partial heads,
    heads of 600-3,000 bytes (the 1,024, 2,048 and 4,096 buckets),
    denied requests (POST, /private/) and one head over 32 KB, denied
    without a device pass."""
    rounds = [[], [], []]
    for fid in range(n_flows):
        stream = b""
        for _ in range(rng.randrange(1, 5)):
            path = (f"/public/a{rng.randrange(1000)}" if rng.random() < 0.5
                    else f"/private/b{rng.randrange(1000)}")
            method = "GET" if rng.random() < 0.8 else "POST"
            headers = "Host: svc.local\r\nUser-Agent: bench\r\n"
            body = b""
            if rng.random() < 0.2:
                body = bytes(rng.randrange(97, 123) for _ in range(rng.randrange(64)))
                headers += f"Content-Length: {len(body)}\r\n"
            if fid % 40 == 0:
                headers += "X-Pad: " + "p" * rng.randrange(560, 2960) + "\r\n"
            stream += f"{method} {path} HTTP/1.1\r\n{headers}\r\n".encode() + body
        if fid == 7:
            stream += LONG_HEAD
        cut1 = rng.randrange(0, len(stream) + 1)
        cut2 = rng.randrange(cut1, len(stream) + 1)
        for rnd, chunk in zip(rounds, (stream[:cut1], stream[cut1:cut2], stream[cut2:])):
            rnd.append((fid, chunk, 1 if fid % 5 else 2))
    return rounds


def run_http_engine(model, rounds, flowlog):
    from cilium_tpu_torch.runtime.engines import HttpBatchEngine

    eng = HttpBatchEngine(model, flowlog=flowlog)
    eng.prewarm()
    out = []
    for rnd in rounds:
        for fid, chunk, remote in rnd:
            eng.feed(fid, chunk, remote_id=remote)
        eng.pump()
        for fid, _, _ in rnd:
            ops, inject = eng.take_ops(fid)
            out.append((fid, [(int(op), n) for op, n in ops], inject))
    return out


class _StreamConn:
    """The connection side the streaming ``HttpParser`` calls back into:
    the policy match (the host oracle) and the reply inject buffer."""

    def __init__(self, policy, remote):
        self.policy = policy
        self.remote = remote
        self.injected = bytearray()

    def matches(self, req):
        return self.policy.matches(True, 80, self.remote, req)

    def inject(self, reply, data):
        self.injected += data

    def log(self, *args, **kwargs):
        pass


def run_http_stream(policy, rounds):
    """The same rounds through the streaming ``HttpParser`` (one parser per
    flow, called on the buffered bytes until it answers MORE), in the
    engine's op shape: a verdict per complete request, then MORE 1 while
    bytes remain."""
    from cilium_tpu_torch.proxylib.parsers.http import HttpParser
    from cilium_tpu_torch.proxylib.types import MORE

    flows = {}
    out = []
    for rnd in rounds:
        for fid, chunk, remote in rnd:
            if fid not in flows:
                conn = _StreamConn(policy, remote)
                flows[fid] = (bytearray(), conn, HttpParser(conn))
            flows[fid][0].extend(chunk)
        for fid, _, _ in rnd:
            buf, conn, parser = flows[fid]
            ops = []
            while buf:
                op, n = parser.on_data(False, False, [bytes(buf)])
                if op == MORE:
                    ops.append((int(MORE), 1))
                    break
                ops.append((int(op), n))
                del buf[:n]
            out.append((fid, ops, bytes(conn.injected)))
            conn.injected.clear()
    return out


def http_oracle(policy, reqs, remotes):
    """(allow, rule) per request from the host oracle on the parsed head
    (``parse_head`` -> ``PolicyInstance.matches_at``; an unparseable head
    is denied)."""
    from cilium_tpu_torch.proxylib.parsers.http import parse_head

    out = []
    for r, remote in zip(reqs, remotes):
        end = r.find(b"\r\n\r\n")
        parsed = parse_head(r[: end + 4]) if end >= 0 else None
        out.append(policy.matches_at(True, 80, remote, parsed) if parsed else (False, -1))
    return out


# --- timing -------------------------------------------------------------------


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` calls after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters=20, replays=10):
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's launch cost is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (iters * replays)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over every output (0 when equal)."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def bound(row):
    """Fill ``bound_ms`` / ``bound_by`` from the row's bytes and ops."""
    t_bytes = row["bytes"] / HBM_BYTES_PER_S
    t_ops = row["ops"] / SCALAR_OPS_PER_S
    row["bound_ms"] = max(t_bytes, t_ops) * 1e3
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def sector_bytes(need, l):
    """Bytes of the whole 32-byte sectors that hold the first ``need[f]``
    bytes of each row of an [F, l] batch."""
    need = need.clamp(0, l).to(torch.int64)
    start = torch.arange(need.shape[0], device=need.device, dtype=torch.int64) * l
    sectors = torch.where(need > 0, (start + need + 31) // 32 - start // 32, 0)
    return 32 * int(sectors.sum())


def span_bytes(start, end, l):
    s = start.clamp(0, l)
    e = end.clamp(0, l)
    return int((e - s).clamp(min=0).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.entry import entry, http_batch
    from cilium_tpu_torch.flowlog import FlowLog
    from cilium_tpu_torch.models import http as http_mod
    from cilium_tpu_torch.models import r2d2 as r2d2_mod
    from cilium_tpu_torch.models.http import (
        HttpBatchModel,
        build_http_model_for_port,
        http_frame,
        http_frame_plain,
        http_hits,
        http_hits_plain,
        http_lit,
        http_lit_plain,
        http_verdicts,
        http_verdicts_attr,
    )
    from cilium_tpu_torch.models.r2d2 import (
        build_r2d2_model,
        r2d2_frame,
        r2d2_frame_plain,
        r2d2_hits,
        r2d2_hits_plain,
        r2d2_verdicts,
        r2d2_verdicts_attr,
    )
    from cilium_tpu_torch.ops import dfa as dfa_mod
    from cilium_tpu_torch.ops import nfa as nfa_mod
    from cilium_tpu_torch.ops.rxsearch import DeviceDfa, DeviceNfa
    from cilium_tpu_torch.proxylib.parsers.r2d2 import request_data

    t_start = time.monotonic()
    dev = torch.device("cuda")
    card = card_line()

    # 1. environment and build
    log("== environment")
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    log(subprocess.run([kernels.nvcc(), "--version"], capture_output=True, text=True).stdout.strip().splitlines()[-1])
    t0 = time.monotonic()
    libs = kernels.build_all()
    log(f"built {len(libs)} kernel libraries in {time.monotonic() - t0:.1f} s")
    for src in kernels.sources():
        for line in kernels.ptxas_log(src).read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src.name}: {line.strip()}")

    kerns = {
        "r2d2_frame": r2d2_mod._R2D2_FRAME,
        "dfa_scan": dfa_mod._DFA_SCAN,
        "nfa_scan": nfa_mod._NFA_SCAN,
        "r2d2_hits": r2d2_mod._R2D2_HITS,
        "http_frame": http_mod._HTTP_FRAME,
        "http_lit": http_mod._HTTP_LIT,
        "http_hits": http_mod._HTTP_HITS,
    }
    scans = {"dfa_scan": (dfa_mod.dfa_search_spans, dfa_mod.dfa_scan_plain),
             "nfa_scan": (nfa_mod.nfa_search_spans, nfa_mod.nfa_scan_plain)}

    def scan_kernel(tab):
        return "dfa_scan" if isinstance(tab, DeviceDfa) else "nfa_scan"

    rng = random.Random(7)
    cases = {}
    for name, make in (("graft", graft_case), ("wide", wide_case), ("nfa", nfa_case)):
        policy, msgs, remotes, width = make(rng)
        data, lengths, rem = tile(msgs, remotes, F, width)
        cases[name] = dict(
            policy=policy, msgs=msgs, remotes=remotes,
            host=(data, lengths, rem),
            dev=tuple(torch.from_numpy(a).to(dev) for a in (data, lengths, rem)),
            model=build_r2d2_model(policy, True, 80),
            cpu_model=build_r2d2_model(policy, True, 80, device="cpu"),
        )
        m = cases[name]["model"]
        log(f"{name}: F={F} L={width} R={m.cmd_len.shape[0]} automaton="
            f"{type(m.nfa).__name__} S={m.nfa.n_states} C={m.nfa.n_classes}")
    kinds = {name: type(c["model"].nfa) for name, c in cases.items()}
    if kinds != {"graft": DeviceDfa, "wide": DeviceDfa, "nfa": DeviceNfa}:
        raise AssertionError(f"unexpected automata: {kinds}")
    feeds = engine_feeds(random.Random(11), 3000)

    hcases = {}
    for make in (http_graft_cases, http_stress_cases, http_head_cases):
        models, reqs, remotes, width = make()
        data, lengths, rem = tile_heads(reqs, remotes, F, width)
        devt = tuple(torch.from_numpy(a).to(dev) for a in (data, lengths, rem))
        for name, (policy, backend) in models.items():
            model = build_http_model_for_port(policy, True, 80, backend)
            if not isinstance(model, HttpBatchModel):
                raise AssertionError(f"{name}: no device model ({model!r})")
            hcases[name] = dict(
                policy=policy, reqs=reqs, remotes=remotes, host=(data, lengths, rem),
                dev=devt, model=model,
                cpu_model=build_http_model_for_port(policy, True, 80, backend, device="cpu"),
            )
            log(f"{name}: F={F} L={width} R={model.n_rules} literal rows "
                f"{tuple(model.m_needle.shape)} / {tuple(model.p_needle.shape)} "
                f"line={type(model.line_nfa).__name__} head={type(model.head_nfa).__name__} "
                f"kinds={sorted(set(model.match_kinds))}")
    tiers = {name: (type(c["model"].line_nfa).__name__, type(c["model"].head_nfa).__name__)
             for name, c in hcases.items()}
    want_tiers = {
        "http-graft": ("NoneType", "NoneType"),
        "http-stress-lit": ("NoneType", "NoneType"),
        "http-stress-dfa": ("DeviceDfa", "NoneType"),
        "http-stress-nfa": ("DeviceNfa", "NoneType"),
        "http-head": ("DeviceDfa", "DeviceDfa"),
    }
    if tiers != want_tiers:
        raise AssertionError(f"unexpected HTTP tiers: {tiers}")
    hfeeds = http_engine_feeds(random.Random(13), 3000)

    # 2. the main path, counted: every count is set to 0 here and read
    # after the last call.  Each run's own launches are the deltas around
    # it, and each automaton search on an HTTP span is counted on its own
    # through a recorder around the model's search call.
    log("== main path (counted)")

    def counts():
        return {n: k.launches for n, k in kerns.items()}

    def delta(before):
        return {n: k.launches - before[n] for n, k in kerns.items()}

    span_runs = {}
    current = {}
    search = http_mod.automaton_search_spans

    def counted_search(tab, data, start, end):
        before = counts()
        out = search(tab, data, start, end)
        m = current["model"]
        if tab is m.head_nfa:
            span = "head"
        else:  # the reference searches the method span before the path
            span = "method" if m.has_method_rx and not current["line_calls"] else "path"
            current["line_calls"] += 1
        run = span_runs.setdefault(f"{current['shape']}:{span}", dict.fromkeys(kerns, 0))
        for n, d in delta(before).items():
            run[n] += d
        return out

    for k in kerns.values():
        k.launches = 0
    runs = {}
    outs = {}
    for name, c in cases.items():
        before = counts()
        v = r2d2_verdicts(c["model"], *c["host"])
        a = r2d2_verdicts_attr(c["model"], *c["host"])
        outs[name] = (v, a)
        runs[name] = delta(before)
    before = counts()
    eng_card = run_engine(cases["graft"]["model"], feeds)
    runs["engine"] = delta(before)
    houts = {}
    http_mod.automaton_search_spans = counted_search
    try:
        for name, c in hcases.items():
            before = counts()
            current.update(shape=name, model=c["model"], line_calls=0)
            v = http_verdicts(c["model"], *c["host"])
            current["line_calls"] = 0
            a = http_verdicts_attr(c["model"], *c["host"])
            houts[name] = (v, a)
            runs[name] = delta(before)
    finally:
        http_mod.automaton_search_spans = search
    hlog_card = FlowLog(capacity=1 << 20)
    before = counts()
    heng_card = run_http_engine(hcases["http-graft"]["model"], hfeeds, hlog_card)
    runs["http-engine"] = delta(before)
    torch.cuda.synchronize()
    launches = counts()
    log("launches:", json.dumps(launches))
    log("launches by run:", json.dumps({n: {k: c for k, c in r.items() if c}
                                        for n, r in {**runs, **span_runs}.items()}))
    for n, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {n} was not launched on the main path")
        if sum(r[n] for r in runs.values()) != count:
            raise AssertionError(f"{n}: the runs' launches do not add up to the main path's")
    for name, c in hcases.items():
        # each call frames, compares literals and combines once, and
        # searches the method span, the path span and the head where the
        # reference does (cilium_tpu/models/http.py:467-499)
        m = c["model"]
        want = {k: 0 for k in kerns}
        want.update(http_frame=2, http_lit=2, http_hits=2)
        spans_want = {}
        if m.line_nfa is not None:
            for span, on in (("method", m.has_method_rx), ("path", m.has_path_rx)):
                if on:
                    spans_want[span] = scan_kernel(m.line_nfa)
        if m.head_nfa is not None:
            spans_want["head"] = scan_kernel(m.head_nfa)
        for span, kname in spans_want.items():
            want[kname] += 2
            got = {k: n for k, n in span_runs.get(f"{name}:{span}", {}).items() if n}
            if got != {kname: 2}:
                raise AssertionError(f"{name}:{span}: launches {got} != {{{kname!r}: 2}}")
        if runs[name] != want:
            raise AssertionError(f"{name}: launches {runs[name]} != {want}")
    if not (runs["http-stress-dfa"]["dfa_scan"] and runs["http-stress-nfa"]["nfa_scan"]
            and runs["http-head"]["dfa_scan"]):
        raise AssertionError("K2 and K3 did not run on HTTP spans")
    fn, args = entry()
    graft_known = fn(*args)[2][:4].tolist()
    if graft_known != [True, False, True, False]:
        raise AssertionError(f"graft known answers wrong: {graft_known}")
    log("graft known answers:", graft_known)
    hdata, hlengths, hrem = http_batch(8)
    hknown = http_verdicts(hcases["http-graft"]["model"], hdata, hlengths, hrem)[2].tolist()
    hwant = []
    for row, n in zip(hdata, hlengths):
        method, path = bytes(row[:n]).split(b" ")[:2]
        hwant.append(method == b"GET" and path.startswith(b"/public/"))
    if hknown != hwant or all(hknown) or not any(hknown):
        raise AssertionError(f"http-graft known answers wrong: {hknown} != {hwant}")
    log("http-graft known answers:", hknown)

    # 3. model against the CPU path and the host oracle
    log("== model")
    for name, c in cases.items():
        (v, a) = outs[name]
        for t in (*v, *a):
            if t.device.type != "cuda":
                raise AssertionError(f"{name}: output not on the card")
        for x, y in zip(v, a[:3]):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: verdicts and verdicts_attr disagree")
        n = len(c["msgs"])
        host = [t.cpu() for t in a]
        # the batch repeats its n messages: every row equals its first copy
        for t in host:
            reps = -(-F // n)
            if not torch.equal(t, t[:n].repeat(reps)[:F]):
                raise AssertionError(f"{name}: rows of one message disagree")
        data, lengths, rem = (x[:n] for x in c["host"])
        want = r2d2_verdicts_attr(c["cpu_model"], data, lengths, rem)
        for i, (g, w) in enumerate(zip(host, want)):
            if not torch.equal(g[:n], w):
                raise AssertionError(f"{name}: card output {i} != CPU output")
        complete, allow, rule = host[0][:n], host[2][:n], host[3][:n]
        bad = 0
        for i, (m, r) in enumerate(zip(c["msgs"], c["remotes"])):
            ok, row = c["policy"].matches_at(True, 80, r, request_data(m))
            if not bool(complete[i]) or (bool(allow[i]), int(rule[i])) != (ok, row):
                bad += 1
        if bad:
            raise AssertionError(f"{name}: {bad} verdicts disagree with the host oracle")
        log(f"{name}: card == cpu on {n} distinct rows, == host oracle, "
            f"allow share {float(allow.float().mean()):.3f}")
    for name, c in hcases.items():
        (v, a) = houts[name]
        for t in (*v, *a):
            if t.device.type != "cuda":
                raise AssertionError(f"{name}: output not on the card")
        for x, y in zip(v, a[:3]):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: verdicts and verdicts_attr disagree")
        n = len(c["reqs"])
        host = [t.cpu() for t in a]
        for t in host:
            reps = -(-F // n)
            if not torch.equal(t, t[:n].repeat(reps)[:F]):
                raise AssertionError(f"{name}: rows of one request disagree")
        data, lengths, rem = (x[:n] for x in c["host"])
        want = http_verdicts_attr(c["cpu_model"], data, lengths, rem)
        for i, (g, w) in enumerate(zip(host, want)):
            if not torch.equal(g[:n], w):
                raise AssertionError(f"{name}: card output {i} != CPU output")
        complete, head_len, allow, rule = (t[:n] for t in host)
        if not bool(complete.all()) or head_len.tolist() != [len(r) for r in c["reqs"]]:
            raise AssertionError(f"{name}: heads not framed whole")
        oracle = http_oracle(c["policy"], c["reqs"], c["remotes"])
        bad = sum(
            1 for i, want_i in enumerate(oracle)
            if (bool(allow[i]), int(rule[i])) != want_i
        )
        if bad:
            raise AssertionError(f"{name}: {bad} verdicts disagree with the host oracle")
        log(f"{name}: card == cpu on {n} distinct rows, == host oracle, "
            f"allow share {float(allow.float().mean()):.3f}")

    # 4. engines against the CPU engines (and the streaming parser)
    log("== engine")
    eng_cpu = run_engine(cases["graft"]["cpu_model"], feeds)
    if eng_card != eng_cpu:
        diff = next(i for i, (x, y) in enumerate(zip(eng_card, eng_cpu)) if x != y)
        raise AssertionError(f"engine ops differ at {eng_card[diff]} vs {eng_cpu[diff]}")
    n_ops = sum(len(ops) for _, ops, _ in eng_card)
    n_drop = sum(1 for _, ops, _ in eng_card for op, _ in ops if op == 2)
    n_inject = sum(len(inj) for _, _, inj in eng_card)
    log(f"engine: {len(feeds[0])} flows, {n_ops} ops ({n_drop} DROP, {n_inject} inject "
        f"bytes) equal on card and CPU")
    hlog_cpu = FlowLog(capacity=1 << 20)
    heng_cpu = run_http_engine(hcases["http-graft"]["cpu_model"], hfeeds, hlog_cpu)
    heng_stream = run_http_stream(hcases["http-graft"]["policy"], hfeeds)
    for other, label in ((heng_cpu, "the CPU engine"), (heng_stream, "the streaming parser")):
        if heng_card != other:
            diff = next(i for i, (x, y) in enumerate(zip(heng_card, other)) if x != y)
            raise AssertionError(
                f"http engine ops differ from {label} at {heng_card[diff]} vs {other[diff]}")
    keys = ("conn_id", "verdict", "rule_id", "match_kind")
    recs = [tuple(r[k] for k in keys) for r in hlog_card.query(1 << 20)]
    if recs != [tuple(r[k] for k in keys) for r in hlog_cpu.query(1 << 20)]:
        raise AssertionError("http engine flow records differ between card and CPU")
    n_ops = sum(len(ops) for _, ops, _ in heng_card)
    n_drop = sum(1 for _, ops, _ in heng_card for op, _ in ops if op == 2)
    n_inject = sum(len(inj) for _, _, inj in heng_card)
    long_ops = [ops for fid, ops, _ in heng_card if fid == 7 and ops]
    if not any((2, len(LONG_HEAD)) in ops for ops in long_ops):
        raise AssertionError("the head over 32 KB was not denied")
    log(f"http engine: {len(hfeeds[0])} flows, {n_ops} ops ({n_drop} DROP, {n_inject} inject "
        f"bytes), {len(recs)} flow records, equal on card, CPU and the streaming parser")

    # 5. kernels against their plain versions, at the main path's inputs
    log("== kernels vs plain")
    report = {}
    inputs = {}
    for name, c in cases.items():
        data, lengths, rem = c["dev"]
        model = c["model"]
        frame = r2d2_frame(data, lengths)
        err = max_abs_err(frame, r2d2_frame_plain(data, lengths))
        report.setdefault("r2d2_frame", {})[name] = err
        nfa = model.nfa
        kname = scan_kernel(nfa)
        scan, plain = scans[kname]
        file_ok = scan(nfa, data, frame.file_start, frame.file_end)
        err = max_abs_err([file_ok], [plain(nfa, data, frame.file_start, frame.file_end)])
        report.setdefault(kname, {})[name] = err
        hits = r2d2_hits(model, data, frame.sp, file_ok, rem)
        err = max_abs_err(hits, r2d2_hits_plain(model, data, frame.sp, file_ok, rem))
        report.setdefault("r2d2_hits", {})[name] = err
        inputs[name] = (data, lengths, rem, frame, file_ok, hits)
    hinputs = {}
    for name, c in hcases.items():
        data, lengths, rem = c["dev"]
        model = c["model"]
        frame = http_frame(data, lengths)
        report.setdefault("http_frame", {})[name] = max_abs_err(frame, http_frame_plain(data, lengths))
        lit = http_lit(model, data, frame)
        report.setdefault("http_lit", {})[name] = max_abs_err(lit, http_lit_plain(model, data, frame))
        spans = {}
        if model.line_nfa is not None:
            if model.has_method_rx:
                spans["method"] = (model.line_nfa, torch.zeros_like(frame.sp1), frame.sp1)
            if model.has_path_rx:
                spans["path"] = (model.line_nfa, frame.p_start, frame.sp2)
        if model.head_nfa is not None:
            spans["head"] = (model.head_nfa, frame.line_end, frame.h_end)
        rx = {}
        for span, (tab, s, e) in spans.items():
            kname = scan_kernel(tab)
            scan, plain = scans[kname]
            rx[span] = scan(tab, data, s, e)
            report.setdefault(kname, {})[f"{name}:{span}"] = max_abs_err(
                [rx[span]], [plain(tab, data, s, e)])
        args = (frame.complete, *lit, rx.get("method"), rx.get("path"), rx.get("head"), rem)
        hits = http_hits(model, *args)
        report.setdefault("http_hits", {})[name] = max_abs_err(hits, http_hits_plain(model, *args))
        hinputs[name] = (data, lengths, rem, frame, lit, spans, rx, hits)
    log("max |kernel - plain|:", json.dumps(report))
    for kname, per in report.items():
        for name, err in per.items():
            if err != 0:
                raise AssertionError(f"{kname} disagrees with its plain version on {name}")

    # 6. times
    log("== times on", card)
    timed = {}

    def frame_bytes(frame, lengths, l):
        """(bytes, sector bytes) that framing must read: each row up to and
        including its first CRLF, all of [0, min(len, L)) where there is
        none; the second counts the whole 32-byte sectors they lie in."""
        need = torch.minimum(frame.crlf + 2, lengths).clamp(0, l).to(torch.int64)
        return int(need.sum()), sector_bytes(need, l)

    for name in ("graft", "wide", "nfa"):
        data, lengths, rem, frame, file_ok, hits = inputs[name]
        model = cases[name]["model"]
        f, l = data.shape
        r = model.cmd_len.shape[0]
        nfa = model.nfa
        sb = span_bytes(frame.file_start, frame.file_end, l)
        walked = torch.where(hits[0], hits[1] + 1, torch.full_like(hits[1], r))
        rows = {}
        # K1: read each row's sectors up to its first CRLF and the
        # lengths once, write six [F] outputs
        need, sectors = frame_bytes(frame, lengths, l)
        k1 = lambda: r2d2_frame(data, lengths)
        rows["r2d2_frame"] = dict(
            ms=graph_ms(k1), call_ms=cuda_ms(k1, 50),
            plain_ms=cuda_ms(lambda: r2d2_frame_plain(data, lengths), 10),
            bytes=sectors + 4 * f + 21 * f, ops=need,
        )
        kname = scan_kernel(nfa)
        rows[kname] = scan_row(scans[kname], nfa, data, frame.file_start, frame.file_end, sb)
        sp = frame.sp
        head = int(sp.clamp(0, min(l, 8)).sum())
        k4 = lambda: r2d2_hits(model, data, sp, file_ok, rem)
        rows["r2d2_hits"] = dict(
            ms=graph_ms(k4), call_ms=cuda_ms(k4, 50),
            plain_ms=cuda_ms(lambda: r2d2_hits_plain(model, data, sp, file_ok, rem), 10),
            bytes=head + 4 * f + f * r + 4 * f + r * (8 + 4 + 1 + 128 + 1) + 5 * f,
            ops=int(walked.sum()) * (8 + 32),
        )
        host = cases[name]["host"]
        timed[name] = dict(rows=rows, **pass_times(
            lambda: r2d2_verdicts(model, data, lengths, rem),
            lambda: r2d2_verdicts(model, *host),
        ))
        for kname, row in rows.items():
            bound(row)
            log_row(name, kname, row)
        log_pass(name, "r2d2_verdicts", timed[name], card)

    for name, c in hcases.items():
        data, lengths, rem, frame, lit, spans, rx, hits = hinputs[name]
        model = c["model"]
        f, l = data.shape
        r = model.n_rules
        rows = {}
        # K5: each row's sectors up to min(head_len, len) and the lengths
        # once, eight [F] outputs (seven int32, one bool)
        need = torch.minimum(frame.head_len, lengths)
        k5 = lambda: http_frame(data, lengths)
        rows["http_frame"] = dict(
            ms=graph_ms(k5), call_ms=cuda_ms(k5, 50),
            plain_ms=cuda_ms(lambda: http_frame_plain(data, lengths), 10),
            bytes=sector_bytes(need, l) + 4 * f + 29 * f,
            ops=int(need.clamp(0, l).sum()),
        )
        # K6: the span bytes it compares (at most LIT_W a slot), the spans,
        # the literal tables once and two [F, R] outputs; one op per needle
        # byte of every live row whose length test passes
        m_len = (frame.sp1).clamp(min=0)
        p_len = (frame.sp2 - frame.p_start).clamp(min=0)
        ops = 0
        for slen, slot in ((m_len, "m"), (p_len, "p")):
            nlen = getattr(model, f"{slot}_len")
            ok = torch.where(getattr(model, f"{slot}_prefix")[None, :],
                             slen[:, None] >= nlen[None, :], slen[:, None] == nlen[None, :])
            ok &= getattr(model, f"{slot}_live")[None, :]
            ops += int((ok * nlen[None, :]).sum())
        read = int(m_len.clamp(max=http_mod.LIT_W).sum() + p_len.clamp(max=http_mod.LIT_W).sum())
        tables = sum(getattr(model, f"{s}_needle").numel() + 10 * getattr(model, f"{s}_len").numel()
                     for s in ("m", "p")) + 2 * r
        k6 = lambda: http_lit(model, data, frame)
        rows["http_lit"] = dict(
            ms=graph_ms(k6), call_ms=cuda_ms(k6, 50),
            plain_ms=cuda_ms(lambda: http_lit_plain(model, data, frame), 10),
            bytes=read + 16 * f + tables + 2 * f * r, ops=ops,
        )
        # the automata on the HTTP spans
        for span, (tab, s, e) in spans.items():
            kname = scan_kernel(tab)
            row = scan_row(scans[kname], tab, data, s, e, span_bytes(s, e, l))
            row["span"] = span
            rows[f"{kname}:{span}"] = row
        # K7: the hit matrices in, [F] out, rows walked
        args = (frame.complete, *lit, rx.get("method"), rx.get("path"), rx.get("head"), rem)
        cols = sum(t.shape[1] for t in rx.values())
        walked = torch.where(hits[0], hits[1] + 1,
                             torch.where(frame.complete, torch.full_like(hits[1], r), 0))
        k7 = lambda: http_hits(model, *args)
        rows["http_hits"] = dict(
            ms=graph_ms(k7), call_ms=cuda_ms(k7, 50),
            plain_ms=cuda_ms(lambda: http_hits_plain(model, *args), 10),
            bytes=2 * f * r + f * cols + f + 4 * f + 5 * f + r * (4 + 4 * 4 + 128 + 1),
            ops=int(walked.sum()) * (2 + 32) + f * cols,
        )
        host = c["host"]
        timed[name] = dict(rows=rows, **pass_times(
            lambda: http_verdicts(model, data, lengths, rem),
            lambda: http_verdicts(model, *host),
        ))
        for kname, row in rows.items():
            bound(row)
            log_row(name, kname, row)
        log_pass(name, "http_verdicts", timed[name], card)

    # The engines on the host clock, then once more under the profiler for
    # the device's busy share (a reading only: the profiler is no check).
    frames = sum(1 for _, ops, _ in eng_card for op, _ in ops if op in (1, 2))
    engine_times(f"engine graft: {frames} frames of {len(feeds[0])} flows", frames, card,
                 lambda: run_engine(cases["graft"]["model"], feeds))
    frames = sum(1 for _, ops, _ in heng_card for op, _ in ops if op in (1, 2))
    engine_times(f"http engine: {frames} requests of {len(hfeeds[0])} flows", frames, card,
                 lambda: run_http_engine(hcases["http-graft"]["model"], hfeeds, FlowLog(capacity=1 << 20)))

    replaces = {
        "r2d2_frame": ("cilium_tpu_torch/csrc/r2d2_frame.cu", "cilium_tpu/models/r2d2.py:211", "graft"),
        "dfa_scan": ("cilium_tpu_torch/csrc/dfa_scan.cu", "cilium_tpu/ops/dfa.py:146", "graft"),
        "nfa_scan": ("cilium_tpu_torch/csrc/nfa_scan.cu", "cilium_tpu/ops/nfa.py:92", "nfa"),
        "r2d2_hits": ("cilium_tpu_torch/csrc/r2d2_hits.cu", "cilium_tpu/ops/bytescan.py:84", "graft"),
        "http_frame": ("cilium_tpu_torch/csrc/http_frame.cu", "cilium_tpu/models/http.py:539", "http-graft"),
        "http_lit": ("cilium_tpu_torch/csrc/http_lit.cu", "cilium_tpu/models/http.py:403", "http-graft"),
        "http_hits": ("cilium_tpu_torch/csrc/http_hits.cu", "cilium_tpu/models/http.py:509", "http-graft"),
    }
    fields = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    kernels_line = []
    for kname, (source, ref, shape) in replaces.items():
        row = timed[shape]["rows"][kname]
        entry_ = {
            "name": kname, "route": "cuda", "source": source, "replaces": ref,
            "launches": launches[kname], "max_abs_err": max(report[kname].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "shape": shape,
            "shape_launches": runs[shape][kname], "call_ms": row["call_ms"],
        }
        others = {}
        for other, t in timed.items():
            for key, w in t["rows"].items():
                if other != shape and key.split(":")[0] == kname:
                    label = other if ":" not in key else f"{other}:{key.split(':')[1]}"
                    others[label] = {k: w[k] for k in fields}
                    # this run's own launches on the counted main path
                    run = span_runs[label] if ":" in label else runs[other]
                    others[label]["launches"] = run[kname]
        entry_["shapes"] = others
        kernels_line.append(entry_)
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def scan_row(scan_pair, tab, data, start, end, sb):
    """K2 or K3 over [start, end): times and its bytes and ops."""
    from cilium_tpu_torch.ops.dfa import DeviceDfa

    scan, plain = scan_pair
    f = data.shape[0]
    r = tab.n_patterns
    run = lambda: scan(tab, data, start, end)
    if isinstance(tab, DeviceDfa):
        tables = tab.delta.numel() + 256 + tab.start.numel() + 2 * tab.accept.numel()
        ops = sb * r  # one table step per (span byte, pattern)
    else:
        tables = 4 * (tab.delta_bits.numel() + tab.start_bits.numel()
                      + 2 * tab.accept_bits.numel()) + 256
        ops = sb * tab.delta_bits.shape[2]  # one word op per state word per byte
    return dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: plain(tab, data, start, end), 3),
        bytes=sb + 8 * f + tables + f * r, ops=ops,
    )


def pass_times(on_card, from_numpy):
    """A verdict pass on the card's tensors (device time from a CUDA graph,
    and per call), and from numpy with one stacked readback (host clock)."""
    dev_ms = graph_ms(on_card)
    call_ms = cuda_ms(on_card, 30)
    t0 = time.perf_counter()
    for _ in range(10):
        out = from_numpy()
        torch.stack([t.to(torch.int32) for t in out]).cpu()
    host_ms = (time.perf_counter() - t0) * 100
    return dict(pass_dev_ms=dev_ms, pass_ms=call_ms, host_ms=host_ms)


def log_row(name, kname, row):
    log(f"{name:15s} {kname:14s} device {row['ms']:.5f} ms  per call {row['call_ms']:.5f} ms  "
        f"plain {row['plain_ms']:.5f} ms  bound {row['bound_ms']:.6f} ms ({row['bound_by']})")


def log_pass(name, fn, t, card):
    log(f"{name:15s} {fn} device {t['pass_dev_ms']:.5f} ms = {F / t['pass_dev_ms'] * 1e3:.0f} "
        f"verdicts/s; per call {t['pass_ms']:.5f} ms = {F / t['pass_ms'] * 1e3:.0f} verdicts/s; "
        f"numpy in, one readback {t['host_ms']:.5f} ms = {F / t['host_ms'] * 1e3:.0f} "
        f"verdicts/s [{card}]")


def engine_times(label, frames, card, run):
    """Two engine runs on the host clock (it spreads between runs), then
    one under the profiler."""
    for turn in ("first", "second"):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        eng_s = time.perf_counter() - t0
        log(f"{label}, {turn} run: {eng_s * 1e3:.1f} ms = {frames / eng_s:.0f} per second "
            f"(host clock) [{card}]")
    # Only starting the profiler may fail softly; the engine run under it
    # raises like any other phase.
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as err:
        log(f"{label} under the profiler: not measured ({err})")
        return
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        prof.stop()
    busy = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.key] = e.self_device_time_total
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    log(f"{label} under the profiler: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{total / 1e3:.2f} ms, idle share {1 - total / wall_us:.4f}; top device time: "
        + "; ".join(f"{k[:48]} {v / 1e3:.2f} ms" for k, v in top))


if __name__ == "__main__":
    sys.exit(main())
