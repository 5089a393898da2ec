#!/usr/bin/env python3
"""Drive the port's r2d2, HTTP, DNS, Cassandra, memcached and Kafka
verdict paths, its L3/L4 datapath, its sidecar service, its chunk-folded
DFA search, its seam benchmarks, its sharded verdicts on a mesh and its
policy plane, its state layer, its agent and the agent's front doors
(the Kubernetes watcher, CNI, the REST API and the CLI), and the native
shim as shim processes, on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline-csrc DIR   # also time the kernels whose
                                                # sources differ from DIR's (a
                                                # parent's csrc) beside them

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
   path's inputs (exact equality: every output is bool or int), and K1 /
   K5 on tests/frame_cases.py's boundary batches at widths that take
   every variant of their launchers (row bases 16-byte aligned and 5 bytes
   into the storage) and on the 64 x 32,768 bucket around LONG_HEAD;
6. times: CUDA events around each kernel, its plain version and each
   verdict pass, bounds from the run's own data, and the engines on the
   host clock and under the profiler, with the card's name and power
   limit; K2 again at the r2d2 engine's own batch shape (the largest
   search one engine run makes, its inputs recorded), K1 at its largest
   frame call, K5 at the HTTP engine's widest frame call and on the
   LONG_HEAD bucket, K4 at the r2d2 engine's largest rule walk; K4 and K9
   with bounds that count the function's work (a test a row the
   first-match walk visits and the bytes compared) and the launcher's lane
   group; given --baseline-csrc, every reading of a kernel whose source
   differs from the parent's (K8 and K17 before their redesign) here and in
   phases 7, 10, 11 and 13, and each pass that runs one (here, phase 7's
   DNS passes, phase 10's Kafka passes and phase 13's mesh passes), also
   runs with the parent's kernel
   on the same inputs, held equal and timed in turns (n o o n n o, medians
   of three; per call, the better of two each);
7. the third slice, counted in a run of its own (every count set to 0
   just before it, read just after): ``dns_verdicts(_attr)`` on bench_dns's
   policy and bench_stress's DNS policy 0, ``cassandra_verdicts`` on
   bench_cassandra's and on bench_stress's Cassandra policy and mix
   (cassandra-stress: 40 regex rows), ``memcache_verdicts`` on
   bench_memcached's (all F = 65,536), then ``DnsBatchEngine``, ``CassandraBatchEngine``,
   ``MemcacheBatchEngine`` and ``HttpSidecarEngine`` on 2,000-3,000 flows;
   K8-K11 launch once per call and K2/K3 once per call on the name, table
   and key spans; then phases 3-6 for these paths, the engines held
   against the CPU engines and the streaming parsers driven through the
   port's ``Connection``; K9 at the DNS engine's largest rule walk and on
   dns-names-256 (256 exact names of 8 to 64 bytes, bench_stress's frame
   mix over them, F = 65,536; held against the host oracle), timed; K8 at
   dns-names-256, the DNS engine's largest call and the sidecar's DNS
   bucket (1,024 x 256), held to its plain version and timed; K10 and
   K11 at the Cassandra and memcache engines' largest calls and the
   sidecar's, held to their plain versions and timed (every K10 / K11
   reading beside the parent's in turns, given --baseline-csrc);
8. the fourth slice, the L3/L4 datapath, counted in a run of its own (all
   F = 65,536): ``datapath_verdicts`` on bench_datapath's maps and mix
   (K14 ``datapath4``), ``datapath_verdicts6`` at the same table scale
   (K14 ``datapath6``), ``netdev_verdicts`` and ``overlay_verdicts`` (K15),
   ``PreFilter.filter_batch`` on v4 and v6 sources (K12), the map-level
   lookups on the passes' own intermediates (K13 ``lb_select``,
   ``exact_lookup``, ``policy_can_access``, K12 on the ipcache), and a CT
   round trip (``apply_ct_creates``, tables rebuilt, every created flow
   established); the card is held against the CPU path on the whole
   batch, the host oracles on 2,000 packets a shape and each kernel's
   plain version, ``account_verdicts`` runs once on the card's output,
   and everything is timed; K12-K15 probe the hashed index each table
   builds when it is made (``ops/l34_index.py``): the build times and
   bytes are logged beside the tables', and each K12 table's mask groups
   and the launcher's pick (G groups a round, or the walk); K12-K15 are
   also held to their plain versions on tests/l34_index_cases.py's
   adversarial tables (K14 / K15 timed there too) and on tables with
   more value columns (16-word slots of values, or slots of row ids), K12
   on tables of many mask groups and K13 on a wide table; K12 / K13 rows
   carry the index design's bound beside the walk's and the smaller as
   their bound; K14 is timed at the round trip's shapes (datapath-rt,
   datapath6-rt), the whole round trip (creates applied, tables and
   indexes rebuilt, the pass read back) is timed on the host clock five
   times, and given --baseline-csrc every K12-K15 reading runs in turns
   with the parent's;
9. the fifth slice, the sidecar verdict service, counted in a run of its
   own: a ``VerdictService`` at the reference's defaults (batch_flows
   2,048, batch_width 256, the card, eager dispatch) on a unix socket,
   driven by the port's ``SidecarClient`` over the socket and then the shm
   rings with r2d2 (4,096 conns, bench_mixed's mix), HTTP and DNS (1,024
   each, DNS through the columnar reassembly lane) and Cassandra and
   memcached (256 each); every op and inject equals the port's in-process
   proxylib oracle's, K16 ``gather_rows`` launches once per blob chunk
   the service issued, each protocol's kernels launch in its own drive,
   the guard never trips and no judge fails; the same traffic through a
   service at verdict_device="cpu" and one dispatching through CUDA
   graphs gives the same ops, and dispatch_mode="auto" resolves by
   measurement; then frames/s, the seam's round trip p50/p99, the
   device's idle share, and K16 against its plain version, timed at
   buckets 512 and 2,048 x 256 and at the seam services' largest,
   4,096 x 64 (given --baseline-csrc, in turns with the parent's K16);
10. Kafka, counted in a run of its own: ``kafka_verdicts`` on
   bench_kafka's rules and requests (F = 65,536, W = 32) and on the fuzz
   mix (0-9 topics, api keys to 70, overflow rows) against
   tests/test_kafka.py's seven rule sets, then ``KafkaBatchEngine`` on
   2,048 flows over 3 rounds (whole, split and pipelined frames, a
   framing error every 50th flow, an overflow every 20th); K17
   ``kafka_hits`` launches once a call and once a device step of the
   engine; the card against the CPU path, ``matches_rule`` on 4,096 rows
   a shape, the CPU engine and a frame-by-frame oracle, K17 against its
   plain version, and times (K17 also at the engine's largest step);
11. the chunk-folded DFA search, counted in a run of its own:
   ``seqdfa_search_batch`` (K18 ``seqdfa_fold`` then ``seqdfa_apply``) on
   tests/test_seqdfa.py's 9 patterns at F = 2,048 x W = 32,768 and F = 256
   x W = 4,096, n_chunks 1, 8 and 64, and two counters on frames of one
   byte (seqdfa-32k-adv, n_chunks 1 and 64: the fold's slow branch);
   bit-equal to K2 ``dfa_search_batch`` on the non-absorbing tables, fold
   and apply to their plain versions at 4,096 and at 32,768 with 64
   chunks, the fold's branch counts to ``seqdfa_fold_branches_plain``
   (both branches must run), and timed beside K2 (and K2 beside the
   parent's K2 in turns on seqdfa-32k and -4k, given --baseline-csrc and a
   parent whose dfa_scan.cu differs); K18's apply on its pick and every
   forced path (walk, staged) against its plain version at every case and
   on tests/merge_cases.py's maps, the launcher's plan and the bytes the
   staged path loads logged, and the apply beside the parent's in turns at
   every case (--baseline-csrc; every path in turns:
   ``chip_apply_variants.py``);
12. the seam benchmarks, counted in a run of their own (a launch here is a
   wrapper launch or a CUDA-graph replay): ``measure_device_rtt_ms`` (K20
   ``rtt_tick`` + a blocking readback) and ``measure_uplink_mbps``;
   ``run_paired_colocated`` over the socket and over the shm rings, and
   on the blob wire eager and through graphs (the seam probe, K19
   ``seam_probe``, on the card, one launch or replay a dispatch and no
   K16: the probe reads no rows; seam - null p99, the per-stage seam
   breakdown, graph captures inside the timed windows);
   ``latbench.run`` with the r2d2 model at 100k, 1M and 5M requests/s;
   ``MixBench`` (its first two timed rounds held against the in-process
   parser) and ``oracle_rate``; ``FlowCacheBench`` with the cache on and
   off; 16-session fan-in with its contract; then K19 at the service's
   flow buckets and 65,536 and K20 at [8] against their plain versions,
   and timed, and the probe's blob round graph-timed against the round as
   the parent ran it (K16, then K19; the parent's K16 given
   --baseline-csrc).  Every latency and rate is a reading, printed with
   the card line; none is held to a limit;
13. rule- and flow-sharded verdicts on a mesh of slots (virtual slots on
   the card unless the host has that many cards), counted in a run of
   their own: ``dryrun_multichip`` at 2 x 2 and 1 x 4, ``mesh_r2d2_model``,
   ``mesh_http_model``, ``mesh_dns_model`` and ``mesh_kafka_model`` on
   the entry's bench policies at F = 65,536 (plain and attributed, bit
   for bit against the single-device models, each slot's kernels and K21
   ``shard_reduce`` / K22 ``kafka_shard_combine`` launched as many times
   as the layout says); rules_100k (100,000 HTTP rules on 4 rule shards,
   F = 2,048) against the unsharded table with p99, rate and table bytes,
   and K6 / K7 at shard 0 and unsharded against their plain versions,
   with their bounds, timed; K4 and K9 on rule shard 0 of mesh-r2d2 and
   mesh-dns 1 x 4, and K17 (``parts=True``) on mesh-kafka 1 x 4's, timed;
   multichip_scaling at 1, 2 and 4 flow slots; ``seqdfa_search_sharded``
   at 8 slots on the seqdfa-32k and -4k shapes against K18's serial
   search; a ``VerdictService`` with ``mesh="on"``,
   ``mesh_rule_shards=2`` on 4 slots serving phase 9's r2d2, DNS and HTTP
   traffic equal to the host oracle through a fault on slot 1, the
   reshape onto the survivors and the re-promotion; then K21 (both
   forms) at R = 1, 2, 4, 8 and K22 at R = 1 to 8 (F = 65,536) and on the
   1 x 4 Kafka mesh's own merge against their plain versions, timed
   beside the library calls (K21's plain form against ``torch.any`` in
   turns, three readings each) and the parent's kernels in turns
   (--baseline-csrc), K22 on its pick and every path the inputs allow
   held to plain, also on tests/merge_cases.py's inputs.  The rules_100k budget and the
   scaling floor are asserted only on 4 distinct cards;
14. the policy plane, counted in a run of its own (a launch is a wrapper
   launch or a graph replay): ``entry.policy_rules()`` (1,000 rules over
   512 identities, after tests/test_policygen.py) loaded from JSON into
   a ``Repository``, ingress resolved for the most-selected identity
   (host clock), its 80/TCP and 9092/TCP filters turned into engines by
   ``ProxyManager`` -> ``create_engine_for_redirect`` for a stand-in
   daemon on the card, at device="cpu" and on the 1 x 4 mesh (at least
   1,000 HTTP and 200 Kafka rows); the models' passes at F = 65,536 (HTTP
   L = 512), ``HttpBatchEngine`` and ``KafkaBatchEngine`` on 4,096 flows
   over 3 rounds, the mesh models and engine, and NPDS for 64 endpoints
   pushed by ``NpdsPusher`` to a ``VerdictService`` at its defaults with
   256 HTTP conns over the socket; every run's K2/K3/K5/K6/K7/K17 (and
   K21/K22 on the mesh) launches printed, each nonzero on its path; 0
   mismatches between the card, the CPU path and the host oracles (the
   proxylib ``HttpParser`` / ``matches_at`` on the NPDS rendering of the
   destination's policy, ``matches_rule`` over ``kafka_host_rows``, the
   in-process proxylib oracle for the service), the mesh equal to the
   single card; the engines' monitor gets POLICY-VERDICT events; K2, K5,
   K6, K7 and K17 held to their plain versions and timed at these shapes;
   resolve ms, model build ms and engine frames/s on the host clock;
15. the state layer, counted in a run of its own (tests/state_world.py):
   a ``KvstoreServer`` with two agents on their own ``NetBackend``
   clients allocating policy-1000's 512 identities (a quarter contended)
   until both caches agree, 65,536 pod IPs published through
   ``KvstoreIPSync`` (half each) into B's ipcache through
   ``datapath_listener``, two nodes, 1,024 services of 8 backends through
   ``ServiceManager`` (ids from the kvstore), 64 endpoints on the card
   regenerated through ``EndpointManager`` / ``BuildQueue`` against the
   1,000 rules with a stub owner that ACKs; then K13 ``policy_can_access``
   on every endpoint's map, K12 on B's ipcache, K13 ``lb_select`` on B's
   LB map, K14 ``datapath4`` and K15 overlay on B's maps at F = 65,536,
   held to the CPU path and the host oracles, before and after churn
   (1,024 IPs and 64 backends deleted, 8 endpoints moved to a new
   identity), each stage's host-clock seconds and rates and the tables'
   build times logged; and K3's wide form (a block of more than 1,024
   states) on the HTTP rule ``path="/a{256}b{256}"`` at F = 65,536 x 512
   and on 2,064- and 4,088-state patterns over planted bytes, held to
   ``nfa_scan_plain`` and timed beside its bound.  ``--state-only`` runs
   the build and this phase alone and prints no result line;
16. the agent, counted in a run of its own: a ``Daemon`` on the card
   (tcp kvstore whose 512 identities a peer allocated, health, device
   export) with policy-1000 less its 128-identity sources and a
   ``toFQDNs`` rule, 8 endpoints, a ``VerdictService`` on its NPDS push,
   its own HTTP and Kafka engines against the streaming parser and
   ``matches_rule``, K13 on every endpoint map, K12 on its prefilter and
   its ipcache map after the DNS poller, 256 conns through the service
   against the proxylib oracle, 100 rules deleted as one policy (the first
   changed verdict timed), and a restart; ``--daemon-only`` runs it alone;
17. the agent's front doors, counted in a run of its own
   (tests/k8s_world.py): a ``Daemon`` on the card fed by the
   ``K8sWatcher`` (128 NetworkPolicies, 64 HTTP CNPs and 4 toServices CNPs,
   1,024 Services of 8 backends with their Endpoints) and 110 pods through
   ``CniPlugin.cni_add`` on ``IpamAllocator("10.0.0.0/24")``; the CLI
   (``cli.main``) against an in-process ``ApiServer``: status, endpoint
   list / get, identity list, map list / get, service list, policy trace,
   ``prefilter update`` with phase 8's deny list (then K12 at F = 65,536)
   and ``bugtool`` (its device.json names the card); K13 on every
   endpoint map, K13's LB on the watcher's LB map at F = 65,536 (again
   after 2 backends are cut from 64 Services), 8 containers through the
   workloads watcher and 8 through the libnetwork driver's socket, 10 CNI
   DELs; a ``VerdictService`` on the NPDS of the node with 256 conns on 8
   endpoints' policies against the proxylib oracle, one CNP deleted
   through the API server (the first changed verdict timed, the new
   policies equal to a repository of the remaining documents); K14 on
   tables from the daemon's maps; every kernel against its plain
   version; then ``python -m cilium_tpu_torch.agent`` as a process on the
   card driven by the CLI as processes (status, policy import, endpoint
   create x 8, map get, bugtool), its map equal to an in-process agent's
   at verdict_device="cpu", SIGTERM exiting 0 with no socket left;
   ``--k8s-only`` runs it alone.
18. the device contracts (``cilium_tpu_torch.analysis.devicecheck``),
   counted in a run of their own: ``check_device_contracts`` on the card
   (the HTTP, r2d2, DNS and seam-probe models and every sharded step
   captured into CUDA graphs, the reshape ladder, the shape closure
   through a ``VerdictService``'s graph caches) must return no finding;
   each captured graph is replayed on fresh inputs and held equal to its
   CPU twin (the kernels' plain versions) on the same inputs, a replay
   adding exactly the launches its graph holds; the launches print per
   model and per kernel; the port's linter (``python -m
   cilium_tpu_torch.analysis.cli --json --ratchet cilium_tpu_torch``, a
   process started with the phase) must report 0 active findings;
   ``--contracts-only`` runs it alone;
19. the native shim, counted in a run of its own: ``native/shim.cc``
   built with ``make -B -C native`` and run as 16 shim processes
   (``cilium_tpu_torch/sidecar/nativeshim.py`` as a script) against one
   ``VerdictService`` on the card at the reference's defaults with phase
   9's five policies: the processes open phase 9's 6,656 conns and drive
   every round through ``cilium_tpu_on_io`` with an access log attached,
   and accept 1,024 conns through ``ProxyMap`` / ``IpcacheMap`` snapshots
   of phase 17's node and 16,384 pod IPs; every call's forwarded bytes
   and every access-log record equal to the host oracle's, the shim's
   host-map identities to K12 on the card (and K12 to its plain
   version); then the service stopped between two rounds of a fresh
   r2d2 drive and a new one started on the same socket (0 errors, the
   split frames judged as the oracle says), the fan-in contract with the
   16 processes at twice one process's closed-loop capacity, and the
   native and the in-process seams (``on_io`` p50 / p99, frames/s, the
   device's idle share, launches) in turns; ``--native-only`` runs it
   alone.  ``--fanin-only N`` runs phase 12's fan-in contract N times.

It prints the ``kernels`` JSON line, then the card line, then the result
line last.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import json
import random
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# Every kernel here does integer work: an int32 compare, AND or add is one
# instruction on one of an SM's 64 int32 lanes (CUDA C++ Programming
# Guide's throughput table, compute capability 9.0), where the published
# 67 TFLOP/s fp32 counts an FMA as two ops on 128 lanes: 67e12 / 4.
INT32_OPS_PER_S = 67e12 / 4
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


def recorded_calls(module, name, run):
    """The calls ``run()`` makes to ``module.<name>`` (an automaton search,
    K1 or K5), in call order, each as its arguments with the tensors
    copied at the call (keyword arguments, where a call has them, as one
    dict after them)."""
    calls = []
    fn = getattr(module, name)

    def record(*args, **kw):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     + ((kw,) if kw else ()))
        return fn(*args, **kw)

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, fn)
    return calls


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
            stream += frame_cases().LONG_HEAD
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


# --- DNS, Cassandra and memcached: policies, batches and traffic ----------------


def _l7_policy(name, port, proto, rules):
    """An NPDS policy on ``port`` from (remote_policies, l7_rules) pairs."""
    from cilium_tpu_torch.proxylib import (
        NetworkPolicy,
        PortNetworkPolicy,
        PortNetworkPolicyRule,
        compile_policy,
    )

    return compile_policy(NetworkPolicy(
        name=name, policy=2,
        ingress_per_port_policies=[PortNetworkPolicy(port=port, rules=[
            PortNetworkPolicyRule(remote_policies=list(remotes), l7_proto=proto, l7_rules=list(r))
            for remotes, r in rules
        ])],
    ))


def dns_stress_case():
    """bench.py:1179-1230 bench_stress's DNS policy 0: 16 exact names
    s{j:02d}.p000.svc.local and 4 patterns *.w{j:02d}.svc.local, with that
    mix for policy 0 (random.Random(23)): exact hits, upper-case exact
    hits, wildcard hits and misses, unknown names and compression
    pointers; 1,024 frames."""
    from cilium_tpu_torch.proxylib.parsers.dns import DNS_QNAME_OFF, encode_dns_query

    names = [f"s{j:02d}.p000.svc.local" for j in range(16)]
    rules = [{"matchName": n} for n in names]
    rules += [{"matchPattern": f"*.w{j:02d}.svc.local"} for j in range(4)]
    rng = random.Random(23)
    frames = []
    for i in range(1024):
        roll = rng.random()
        if roll < 0.30:
            frames.append(encode_dns_query(names[rng.randrange(16)]))
        elif roll < 0.42:
            frames.append(encode_dns_query(names[rng.randrange(16)].upper()))
        elif roll < 0.62:
            depth = "a.b." if rng.random() < 0.3 else f"h{i % 7}."
            frames.append(encode_dns_query(f"{depth}w{rng.randrange(4):02d}.svc.local"))
        elif roll < 0.72:
            frames.append(encode_dns_query(f"w{rng.randrange(4):02d}.svc.local"))
        elif roll < 0.92:
            frames.append(encode_dns_query(f"x{rng.randrange(100)}.other.local"))
        else:
            bad = bytearray(encode_dns_query("bad.svc.local"))
            bad[DNS_QNAME_OFF] = 0xC0
            frames.append(bytes(bad))
    return _l7_policy("dns-stress", 53, "dns", [([], rules)]), frames


DNS_NAMES_RULES = 256
DNS_NAMES_WIDTH = 128


def dns_names_case():
    """dns-names-256: 256 matchName rules (a toFQDNs policy of hundreds of
    names) whose names run from 8 to 64 bytes, and dns_stress_case's frame
    mix drawn over them (random.Random(29)): exact hits, upper-case exact
    hits, a label in front of a name and a name's suffix (misses where the
    stress policy had wildcards), unknown names and compression pointers;
    1,024 frames.  No pattern rows: the model has no automaton."""
    from cilium_tpu_torch.proxylib.parsers.dns import DNS_QNAME_OFF, encode_dns_query

    names = []
    for j in range(DNS_NAMES_RULES):
        n = 8 + j * 56 // (DNS_NAMES_RULES - 1)
        s = f"r{j:03d}"
        while len(s) < n:
            s += "." if len(s) % 16 == 15 and len(s) < n - 1 else "k"
        names.append(s)
    rng = random.Random(29)
    frames = []
    for i in range(1024):
        roll = rng.random()
        name = names[rng.randrange(len(names))]
        if roll < 0.30:
            frames.append(encode_dns_query(name))
        elif roll < 0.42:
            frames.append(encode_dns_query(name.upper()))
        elif roll < 0.62:
            frames.append(encode_dns_query(f"h{i % 7}.{name}"))
        elif roll < 0.72:
            frames.append(encode_dns_query(name[5:] or "k"))
        elif roll < 0.92:
            frames.append(encode_dns_query(f"x{rng.randrange(100)}.other.local"))
        else:
            bad = bytearray(encode_dns_query("bad.svc.local"))
            bad[DNS_QNAME_OFF] = 0xC0
            frames.append(bytes(bad))
    rules = [{"matchName": n} for n in names]
    return _l7_policy("dns-names-256", 53, "dns", [([], rules)]), frames


CASS_STRESS_RULES = 40  # bench.py:840 STRESS_CASS_RULES


def cassandra_stress_rules():
    """bench.py:1006-1036 bench_stress's Cassandra rules: 40 rows, select
    (even j) or insert (odd j) on the tables ``^ks\\.(tNN|tmpNN)[0-9]*$``."""
    return [{"query_action": "select" if j % 2 == 0 else "insert",
             "query_table": f"^ks\\.(t{j:02d}|tmp{j:02d})[0-9]*$"} for j in range(CASS_STRESS_RULES)]


def cassandra_stress_case():
    """cassandra-stress: bench_stress's Cassandra policy and its request
    mix (bench.py:1145-1170, drawn from random.Random(61)): 45% rule hits
    (the t or tmp table of a rule, a digit tail 60% of the time), 20%
    action misses (update on a covered table), 20% unknown tables, 15%
    keyspace misses; 1,024 (action, table, non_query) requests."""
    rng = random.Random(61)
    reqs = []
    for _ in range(1024):
        roll = rng.random()
        j = rng.randrange(CASS_STRESS_RULES)
        action = "select" if j % 2 == 0 else "insert"
        if roll < 0.45:
            base = "t" if rng.random() < 0.7 else "tmp"
            tail = str(rng.randrange(100)) if rng.random() < 0.6 else ""
            reqs.append((action, f"ks.{base}{j:02d}{tail}", False))
        elif roll < 0.65:
            reqs.append(("update", f"ks.t{j:02d}", False))
        elif roll < 0.85:
            reqs.append((action, f"ks.x{j:02d}", False))
        else:
            reqs.append((action, f"other.t{j:02d}", False))
    policy = _l7_policy("cassandra-stress", 9042, "cassandra", [([], cassandra_stress_rules())])
    return policy, reqs


def cassandra_rows(reqs, f):
    """``encode_cassandra_batch`` of ``reqs`` cycled to f rows, and remotes
    of 1: (data, action_len, table_len, non_query, remotes) numpy arrays."""
    from cilium_tpu_torch.models.cassandra import encode_cassandra_batch

    data, alen, tlen, nq, overflow = encode_cassandra_batch([reqs[i % len(reqs)] for i in range(f)])
    if overflow.any():
        raise AssertionError("a request overflows the batch widths")
    return data, alen, tlen, nq, np.ones((f,), np.int32)


def dns_oracle(policy, frames, remotes):
    """(allow, rule) per frame from the host oracle on the parsed question
    (``parse_dns_query`` -> ``PolicyInstance.matches_at``)."""
    from cilium_tpu_torch.proxylib.parsers.dns import DnsRequestData, parse_dns_query

    out = []
    for f, r in zip(frames, remotes):
        q = parse_dns_query(f)
        req = DnsRequestData(name=q if q is not None else "", valid=q is not None)
        out.append(policy.matches_at(True, 53, int(r), req))
    return out


def _split(rng, stream):
    """A stream cut into three round chunks at two random points."""
    c1 = rng.randrange(0, len(stream) + 1)
    c2 = rng.randrange(c1, len(stream) + 1)
    return stream[:c1], stream[c1:c2], stream[c2:]


def dns_engine_feeds(rng, n_flows):
    """Three rounds of (flow, chunk, remote): 1-4 pipelined queries of
    bench_dns's mix per flow (denied evil*.test among them), upper-case
    names, a compression pointer every 23rd flow, cut across the length
    prefix and mid-name."""
    from cilium_tpu_torch.entry import dns_queries
    from cilium_tpu_torch.proxylib.parsers.dns import DNS_QNAME_OFF

    qs = dns_queries()
    rounds = [[], [], []]
    for fid in range(n_flows):
        frames = [qs[rng.randrange(len(qs))] for _ in range(rng.randrange(1, 5))]
        if fid % 23 == 0:
            bad = bytearray(frames[0])
            bad[DNS_QNAME_OFF] = 0xC0
            frames.append(bytes(bad))
        if fid % 11 == 0:
            f = bytearray(frames[0])
            f[DNS_QNAME_OFF + 1:] = bytes(f[DNS_QNAME_OFF + 1:]).upper()
            frames.append(bytes(f))
        for rnd, chunk in zip(rounds, _split(rng, b"".join(frames))):
            rnd.append((fid, chunk, 1))
    return rounds


def _cass_query(cql, stream=0):
    import struct

    q = cql.encode()
    body = struct.pack(">I", len(q)) + q + b"\x00\x01\x00"
    return bytes([4, 0]) + struct.pack(">HB", stream, 0x07) + struct.pack(">I", len(body)) + body


def cassandra_engine_feeds(rng, n_flows):
    """Three rounds on bench_cassandra's policy: 1-4 queries per flow
    (select/insert/update/delete on public.* and secret.*, USE, an
    unqualified table after USE public), denials with the unauthorized
    inject, and a table name over MAX_TABLE every 50th flow (overflow:
    the host oracle judges it)."""
    rounds = [[], [], []]
    for fid in range(n_flows):
        frames = []
        for k in range(rng.randrange(1, 5)):
            roll = rng.random()
            ks = "public" if rng.random() < 0.5 else "secret"
            if roll < 0.3:
                frames.append(_cass_query(f"SELECT * FROM {ks}.t{rng.randrange(40)}", k))
            elif roll < 0.55:
                frames.append(_cass_query(f"INSERT INTO {ks}.t{rng.randrange(40)} (a) VALUES (1)", k))
            elif roll < 0.7:
                frames.append(_cass_query(f"UPDATE {ks}.z SET a=1", k))
            elif roll < 0.8:
                frames.append(_cass_query(f"DELETE FROM {ks}.z WHERE a=1", k))
            else:
                frames.append(_cass_query("USE public", k))
                frames.append(_cass_query(f"SELECT * FROM t{rng.randrange(9)}", k + 1))
        if fid % 50 == 0:
            frames.append(_cass_query("SELECT * FROM public." + "t" * 120, 9))
        for rnd, chunk in zip(rounds, _split(rng, b"".join(frames))):
            rnd.append((fid, chunk, 1))
    return rounds


def _mc_bin(opcode, key=b"", extras=b"", value=b""):
    import struct

    body = extras + key + value
    return (bytes([0x80, opcode]) + struct.pack(">H", len(key)) + bytes([len(extras), 0])
            + b"\x00\x00" + struct.pack(">I", len(body)) + b"\x00" * 12 + body)


def memcache_engine_feeds(rng, n_flows):
    """Three rounds on bench_memcached's policy: text flows (get user:/
    admin:, set sess:N and sess:xN with data blocks, delete the-key and
    others, a two-key get every 40th flow: overflow, the host oracle
    judges it) and binary flows (get/getq user:, set sess: with extras,
    delete); a denied first frame injects inline."""
    rounds = [[], [], []]
    for fid in range(n_flows):
        frames = []
        binary = fid % 3 == 0
        for _ in range(rng.randrange(1, 5)):
            n = rng.randrange(99)
            roll = rng.random()
            if binary:
                if roll < 0.4:
                    frames.append(_mc_bin(rng.choice([0, 9]), key=b"user:%d" % n))
                elif roll < 0.6:
                    frames.append(_mc_bin(0, key=b"admin:%d" % n))
                elif roll < 0.85:
                    frames.append(_mc_bin(1, key=b"sess:%d" % n, extras=b"\x00" * 8, value=b"v"))
                else:
                    frames.append(_mc_bin(4, key=b"the-key" if roll < 0.93 else b"k"))
            else:
                if roll < 0.35:
                    frames.append(b"get user:%d\r\n" % n)
                elif roll < 0.5:
                    frames.append(b"get admin:%d\r\n" % n)
                elif roll < 0.7:
                    frames.append(b"set sess:%d 0 0 2\r\nhi\r\n" % n)
                elif roll < 0.8:
                    frames.append(b"set sess:x%d 0 0 3\r\nabc\r\n" % n)
                else:
                    frames.append(b"delete the-key\r\n" if roll < 0.9 else b"delete k%d\r\n" % n)
        if not binary and fid % 40 == 1:
            frames.append(b"get user:1 user:2\r\n")
        for rnd, chunk in zip(rounds, _split(rng, b"".join(frames))):
            rnd.append((fid, chunk, 1))
    return rounds


def http_sidecar_feeds(rng, n_flows):
    """Three rounds on the http-graft policy: 1-4 requests per flow,
    Content-Length bodies, POST and /private/ denials (the 403 inject)."""
    rounds = [[], [], []]
    for fid in range(n_flows):
        stream = b""
        for _ in range(rng.randrange(1, 5)):
            path = (f"/public/a{rng.randrange(1000)}" if rng.random() < 0.5
                    else f"/private/b{rng.randrange(1000)}")
            method = "GET" if rng.random() < 0.8 else "POST"
            body = b""
            headers = "Host: svc.local\r\nUser-Agent: bench\r\n"
            if rng.random() < 0.2:
                body = bytes(rng.randrange(97, 123) for _ in range(rng.randrange(64)))
                headers += f"Content-Length: {len(body)}\r\n"
            stream += f"{method} {path} HTTP/1.1\r\n{headers}\r\n".encode() + body
        for rnd, chunk in zip(rounds, _split(rng, stream)):
            rnd.append((fid, chunk, 1 if fid % 5 else 2))
    return rounds


def run_l7_engine(make, rounds):
    """(per-flow-round (flow, ops, inject) list, engine) from feeding the
    rounds to a fresh engine."""
    eng = make()
    out = []
    for rnd in rounds:
        for fid, chunk, remote in rnd:
            eng.feed(fid, chunk, remote_id=remote)
        eng.pump()
        for fid, _, _ in rnd:
            # (ops, reply inject) from the DNS engine, (ops, orig inject,
            # reply inject) from the device-assisted ones
            taken = eng.take_ops(fid)
            out.append((fid, [(int(op), n) for op, n in taken[0]], taken[-1]))
    return out, eng


class _OracleInstance:
    """The instance side the port's ``Connection`` calls back into: the
    host oracle ``PolicyInstance.matches_at`` and a null access log."""

    def __init__(self, policy):
        self.policy = policy

    def policy_matches_at(self, name, ingress, port, remote, l7):
        return self.policy.matches_at(ingress, port, remote, l7)

    def policy_matches(self, name, ingress, port, remote, l7):
        return self.policy.matches(ingress, port, remote, l7)

    def log(self, entry):
        pass


def run_l7_stream(policy, proto, port, rounds):
    """The same rounds through the streaming parser on the port's own
    ``Connection`` (one per flow), driven once per round where bytes are
    buffered, in the engines' op shape."""
    from cilium_tpu_torch.proxylib.connection import Connection, InjectBuf
    from cilium_tpu_torch.proxylib.parser import get_parser_factory
    from cilium_tpu_torch.proxylib.types import DROP, PASS

    inst = _OracleInstance(policy)
    flows = {}
    out = []
    for rnd in rounds:
        for fid, chunk, remote in rnd:
            if fid not in flows:
                conn = Connection(
                    instance=inst, conn_id=fid, ingress=True, src_id=remote, dst_id=0,
                    src_addr="", dst_addr=f"0.0.0.0:{port}", policy_name="", port=port,
                    parser_name=proto, orig_buf=InjectBuf(4096), reply_buf=InjectBuf(4096),
                )
                conn.parser = get_parser_factory(proto).create(conn)
                flows[fid] = [bytearray(), 0, conn]
            st = flows[fid]
            take = min(st[1], len(chunk))
            st[1] -= take
            st[0].extend(chunk[take:])
        for fid, _, _ in rnd:
            buf, _, conn = flows[fid]
            ops = []
            if buf:
                conn.on_data(False, False, [bytes(buf)], ops)
                consumed = 0
                for op, n in ops:
                    if op in (PASS, DROP):
                        t = min(n, len(buf) - consumed)
                        consumed += t
                        flows[fid][1] += n - t
                del buf[:consumed]
            out.append((fid, [(int(op), n) for op, n in ops], conn.reply_buf.take()))
    return out


def _first_diff(a, b):
    return next((x, y) for x, y in zip(a, b) if x != y) if len(a) == len(b) else (len(a), len(b))


def l7_slice(dev, card, kerns, scans, scan_kernel, tile_rows):
    """The third slice's paths on the card: DNS (K8, K9), Cassandra (K10)
    and memcached (K11) at F = 65,536, K2/K3 on their spans where the
    model has pattern or regex rows, and the DNS, Cassandra, memcached and
    HTTP-sidecar engines.  Every count is set to 0 just before the counted
    run and read just after; then the card is held against the CPU path,
    the host oracle, the CPU engines, the streaming parsers and each
    kernel's plain version, and timed.  Returns (launches, runs, span_runs,
    report, timed) for the kernels line."""
    from cilium_tpu_torch.entry import (
        cassandra_batch,
        cassandra_bench_policy,
        cassandra_requests,
        dns_batch,
        dns_bench_policy,
        dns_queries,
        http_bench_policy,
        memcache_batch,
        memcache_bench_policy,
        memcache_frames,
    )
    from cilium_tpu_torch.models import cassandra as cass_mod
    from cilium_tpu_torch.models import dns as dns_mod
    from cilium_tpu_torch.models import memcached as mc_mod
    from cilium_tpu_torch.models.cassandra import (
        MAX_ACTION,
        build_cassandra_model,
        cassandra_hits,
        cassandra_hits_plain,
        cassandra_verdicts,
    )
    from cilium_tpu_torch.models.dns import (
        build_dns_model,
        dns_hits,
        dns_hits_plain,
        dns_name,
        dns_name_plain,
        dns_verdicts,
        dns_verdicts_attr,
    )
    from cilium_tpu_torch.models.http import build_http_model_for_port
    from cilium_tpu_torch.models.memcached import (
        build_memcache_model,
        memcache_hits,
        memcache_hits_plain,
        memcache_verdicts,
    )
    from cilium_tpu_torch.proxylib.parsers.memcached import MemcacheMeta
    from cilium_tpu_torch.runtime.dnsengine import DnsBatchEngine
    from cilium_tpu_torch.runtime.l7engine import (
        CassandraBatchEngine,
        HttpSidecarEngine,
        MemcacheBatchEngine,
    )

    kerns = {**kerns, "dns_name": dns_mod._DNS_NAME, "dns_hits": dns_mod._DNS_HITS,
             "cassandra_hits": cass_mod._CASSANDRA_HITS, "memcache_hits": mc_mod._MEMCACHE_HITS}
    new = ("dns_name", "dns_hits", "cassandra_hits", "memcache_hits")

    # the four shapes at F = 65,536 (entry.py's copies of bench.py's setups)
    stress_policy, stress_frames = dns_stress_case()
    cass_stress_policy, cass_stress_reqs = cassandra_stress_case()
    cases = {
        "dns": dict(kind="dns", port=53, policy=dns_bench_policy(), items=dns_queries(),
                    host=dns_batch(F)),
        "dns-stress": dict(kind="dns", port=53, policy=stress_policy, items=stress_frames,
                           host=tile_rows(stress_frames, [1] * len(stress_frames), F, 64)),
        "cassandra": dict(kind="cassandra", port=9042, policy=cassandra_bench_policy(),
                          items=cassandra_requests(), host=cassandra_batch(F)),
        "cassandra-stress": dict(kind="cassandra", port=9042, policy=cass_stress_policy,
                                 items=cass_stress_reqs, host=cassandra_rows(cass_stress_reqs, F)),
        "memcached": dict(kind="memcached", port=11211, policy=memcache_bench_policy(),
                          items=memcache_frames(), host=memcache_batch(F)),
    }
    build = {"dns": build_dns_model, "cassandra": build_cassandra_model,
             "memcached": build_memcache_model}
    span_of = {"dns": "name", "cassandra": "table", "memcached": "key"}
    for name, c in cases.items():
        c["dev"] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in c["host"])
        c["model"] = build[c["kind"]](c["policy"], True, c["port"])
        c["cpu_model"] = build[c["kind"]](c["policy"], True, c["port"], device="cpu")
        m = c["model"]
        tab = m.nfa
        log(f"{name}: F={F} width={c['host'][0].shape[1]} R={m.n_rules} automaton="
            f"{type(tab).__name__}" + (f" S={tab.n_states} C={tab.n_classes}" if tab is not None else ""))
        if tab is None:
            raise AssertionError(f"{name}: the bench policy has pattern/regex rows, so an automaton")

    def verdicts(c, model, args):
        if c["kind"] == "dns":
            return dns_verdicts_attr(model, *args)
        fn = cassandra_verdicts if c["kind"] == "cassandra" else memcache_verdicts
        return (fn(model, *args),)

    http_policy = http_bench_policy()
    models = {
        "dns": (cases["dns"]["model"], cases["dns"]["cpu_model"]),
        "cassandra": (cases["cassandra"]["model"], cases["cassandra"]["cpu_model"]),
        "memcached": (cases["memcached"]["model"], cases["memcached"]["cpu_model"]),
        "http": (build_http_model_for_port(http_policy, True, 80),
                 build_http_model_for_port(http_policy, True, 80, device="cpu")),
    }
    engines = {
        "dns-engine": ("dns", 53, cases["dns"]["policy"],
                       lambda m: DnsBatchEngine(m), dns_engine_feeds(random.Random(31), 3000)),
        "cassandra-engine": ("cassandra", 9042, cases["cassandra"]["policy"],
                             lambda m: CassandraBatchEngine(cases["cassandra"]["policy"], True, 9042, m),
                             cassandra_engine_feeds(random.Random(37), 2000)),
        "memcache-engine": ("memcache", 11211, cases["memcached"]["policy"],
                            lambda m: MemcacheBatchEngine(cases["memcached"]["policy"], True, 11211, m),
                            memcache_engine_feeds(random.Random(41), 2000)),
        "http-sidecar-engine": ("http", 80, http_policy,
                                lambda m: HttpSidecarEngine(http_policy, True, 80, m),
                                http_sidecar_feeds(random.Random(43), 2000)),
    }
    model_of = {"dns": "dns", "cassandra": "cassandra", "memcache": "memcached", "http": "http"}

    # the main path, counted: every count is set to 0 here and read after
    # the last call; each run's own launches are the deltas around it, and
    # each automaton search on a span through a recorder around the
    # model's search call.
    log("== DNS, Cassandra, memcached main path (counted)")

    def counts():
        return {n: k.launches for n, k in kerns.items()}

    def delta(before):
        return {n: k.launches - before[n] for n, k in kerns.items()}

    span_runs = {}
    current = {}
    mods = {"dns": dns_mod, "cassandra": cass_mod, "memcached": mc_mod}
    searches = {kind: mod.automaton_search_spans for kind, mod in mods.items()}

    def recorder(kind):
        def counted(tab, data, start, end):
            before = counts()
            out = searches[kind](tab, data, start, end)
            run = span_runs.setdefault(f"{current['run']}:{span_of[kind]}", dict.fromkeys(kerns, 0))
            for n, d in delta(before).items():
                run[n] += d
            return out
        return counted

    for k in kerns.values():
        k.launches = 0
    runs, outs, eng_card = {}, {}, {}
    for kind, mod in mods.items():
        mod.automaton_search_spans = recorder(kind)
    try:
        for name, c in cases.items():
            before = counts()
            current["run"] = name
            if c["kind"] == "dns":
                outs[name] = (dns_verdicts(c["model"], *c["host"]), dns_verdicts_attr(c["model"], *c["host"]))
            else:
                outs[name] = verdicts(c, c["model"], c["host"])
            runs[name] = delta(before)
        for name, (proto, port, policy, make, feeds) in engines.items():
            before = counts()
            current["run"] = name
            eng_card[name] = run_l7_engine(lambda: make(models[model_of[proto]][0]), feeds)
            runs[name] = delta(before)
    finally:
        for kind, mod in mods.items():
            mod.automaton_search_spans = searches[kind]
    torch.cuda.synchronize()
    launches = counts()
    log("launches:", json.dumps(launches))
    log("launches by run:", json.dumps({n: {k: c for k, c in r.items() if c}
                                        for n, r in {**runs, **span_runs}.items()}))
    for n, count in launches.items():
        if sum(r[n] for r in runs.values()) != count:
            raise AssertionError(f"{n}: the runs' launches do not add up to the main path's")
    for n in new:
        if launches[n] <= 0:
            raise AssertionError(f"kernel {n} was not launched on the main path")
    own = {"dns": ("dns_name", "dns_hits"), "cassandra": ("cassandra_hits",),
           "memcached": ("memcache_hits",)}
    for name, c in cases.items():
        calls = 2 if c["kind"] == "dns" else 1  # verdicts and _attr; one call each else
        kname = scan_kernel(c["model"].nfa)
        want = dict.fromkeys(kerns, 0)
        for k in own[c["kind"]]:
            want[k] = calls
        want[kname] = calls
        if runs[name] != want:
            raise AssertionError(f"{name}: launches {runs[name]} != {want}")
        got = {k: n for k, n in span_runs.get(f"{name}:{span_of[c['kind']]}", {}).items() if n}
        if got != {kname: calls}:
            raise AssertionError(f"{name}: span launches {got} != {{{kname!r}: {calls}}}")
    for name, ks in (("dns-engine", ("dns_name", "dns_hits")), ("cassandra-engine", ("cassandra_hits",)),
                     ("memcache-engine", ("memcache_hits",)),
                     ("http-sidecar-engine", ("http_frame", "http_lit", "http_hits"))):
        if not all(runs[name][k] > 0 for k in ks) or len({runs[name][k] for k in ks}) != 1:
            raise AssertionError(f"{name}: launches {runs[name]}")

    # the model against the CPU path and the host oracle
    log("== DNS, Cassandra, memcached model")
    for name, c in cases.items():
        got = outs[name][1] if c["kind"] == "dns" else outs[name]
        if c["kind"] == "dns":
            for x, y in zip(outs[name][0], got[:3]):
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: verdicts and verdicts_attr disagree")
        n = len(c["items"])
        host = [t.cpu() for t in got]
        for t in host:
            if t.device.type != "cpu" or not torch.equal(t, t[:n].repeat(-(-F // n))[:F]):
                raise AssertionError(f"{name}: rows of one request disagree")
        want = verdicts(c, c["cpu_model"], tuple(a[:n] for a in c["host"]))
        for i, (g, w) in enumerate(zip(host, want)):
            if not torch.equal(g[:n], w):
                raise AssertionError(f"{name}: card output {i} != CPU output")
        if c["kind"] == "dns":
            complete, msg_len, allow, rule = (t[:n] for t in host)
            if not bool(complete.all()) or msg_len.tolist() != [len(q) for q in c["items"]]:
                raise AssertionError(f"{name}: frames not framed whole")
            got_o = [(bool(a), int(r)) for a, r in zip(allow, rule)]
            want_o = dns_oracle(c["policy"], c["items"], [1] * n)
        elif c["kind"] == "cassandra":
            allow = host[0][:n]
            got_o = [bool(a) for a in allow]
            want_o = [c["policy"].matches(True, 9042, 1, f"/query/{a}/{t}") for a, t, _ in c["items"]]
        else:
            allow = host[0][:n]
            got_o = [bool(a) for a in allow]
            want_o = [c["policy"].matches(True, 11211, 1, MemcacheMeta(
                command="" if b else cmd, opcode=op if b else -1, keys=list(keys)))
                for b, op, cmd, keys in c["items"]]
        bad = sum(1 for x, y in zip(got_o, want_o) if x != y)
        if bad:
            raise AssertionError(f"{name}: {bad} verdicts disagree with the host oracle")
        log(f"{name}: card == cpu on {n} distinct rows, == host oracle, "
            f"allow share {float(allow.float().mean()):.3f}")

    # the engines against the CPU engines and the streaming parsers
    log("== DNS, Cassandra, memcached, HTTP-sidecar engines")
    for name, (proto, port, policy, make, feeds) in engines.items():
        card_out, eng = eng_card[name]
        cpu_out, cpu_eng = run_l7_engine(lambda: make(models[model_of[proto]][1]), feeds)
        stream_out = run_l7_stream(policy, proto, port, feeds)
        for other, label in ((cpu_out, "the CPU engine"), (stream_out, "the streaming parser")):
            if card_out != other:
                raise AssertionError(f"{name}: ops differ from {label}: {_first_diff(card_out, other)}")
        n_ops = sum(len(ops) for _, ops, _ in card_out)
        n_drop = sum(1 for _, ops, _ in card_out for op, _ in ops if op == 2)
        n_inject = sum(len(inj) for _, _, inj in card_out)
        judged = ""
        if hasattr(eng, "device_judged"):
            if (eng.device_judged, eng.host_judged) != (cpu_eng.device_judged, cpu_eng.host_judged):
                raise AssertionError(f"{name}: device/host judged counts differ from the CPU engine")
            judged = (f", {eng.device_judged} frames judged on the card, {eng.host_judged} by the "
                      f"host oracle (overflow or past the peek horizon)")
        if not n_drop:
            raise AssertionError(f"{name}: the traffic has no denial")
        log(f"{name}: {len(feeds[0])} flows, {n_ops} ops ({n_drop} DROP, {n_inject} inject bytes)"
            f"{judged}, equal on card, CPU and the streaming parser")

    # kernels against their plain versions, at the main path's inputs
    log("== K8-K11 and K2/K3 on the new spans vs plain")
    report, inputs = {}, {}

    def put(kname, label, got, want):
        report.setdefault(kname, {})[label] = max_abs_err(got, want)

    for name, c in cases.items():
        model, args = c["model"], c["dev"]
        tab = model.nfa
        kname = scan_kernel(tab)
        scan, plain = scans[kname]
        if c["kind"] == "dns":
            data, lengths, rem = args
            nm = dns_name(data, lengths)
            put("dns_name", name, nm, dns_name_plain(data, lengths))
            span = (nm.dotted, nm.span_start, nm.span_end)
            rx = scan(tab, *span)
            put(kname, f"{name}:name", [rx], [plain(tab, *span)])
            hits = dns_hits(model, nm, rx, rem)
            put("dns_hits", name, hits, dns_hits_plain(model, nm, rx, rem))
            inputs[name] = dict(name=nm, span=span, rx=rx, hits=hits)
        elif c["kind"] == "cassandra":
            data, alen, tlen, nq, rem = args
            start = torch.full_like(tlen, MAX_ACTION)
            span = (data, start, start + tlen)
            rx = scan(tab, *span)
            put(kname, f"{name}:table", [rx], [plain(tab, *span)])
            allow = cassandra_hits(model, data, alen, tlen, nq, rx, rem)
            put("cassandra_hits", name, [allow], [cassandra_hits_plain(model, data, alen, tlen, nq, rx, rem)])
            inputs[name] = dict(span=span, rx=rx)
        else:
            kd, klen, hk, ib, op, cid, rem = args
            span = (kd, torch.zeros_like(klen), klen)
            rx = scan(tab, *span)
            put(kname, f"{name}:key", [rx], [plain(tab, *span)])
            allow = memcache_hits(model, kd, klen, hk, ib, op, cid, rx, rem)
            put("memcache_hits", name, [allow],
                [memcache_hits_plain(model, kd, klen, hk, ib, op, cid, rx, rem)])
            inputs[name] = dict(span=span, rx=rx)
    log("max |kernel - plain|:", json.dumps(report))
    for kname, per in report.items():
        for label, err in per.items():
            if err != 0:
                raise AssertionError(f"{kname} disagrees with its plain version on {label}")

    # times
    log("== DNS, Cassandra, memcached times on", card)
    timed = {}

    for name, c in cases.items():
        model, args, inp = c["model"], c["dev"], inputs[name]
        tab = model.nfa
        r = model.n_rules
        rows = {}
        kname = scan_kernel(tab)
        data_s, s_, e_ = inp["span"]
        f, width = data_s.shape
        if c["kind"] == "dns":
            data, lengths, rem = args
            nm = inp["name"]
            rows["dns_name"] = k8_row(data, lengths)
            rows["dns_hits"] = k9_row(model, nm, inp["rx"], rem)
            on_card = lambda: dns_verdicts(model, data, lengths, rem)
        elif c["kind"] == "cassandra":
            data, alen, tlen, nq, rem = args
            rows["cassandra_hits"] = k10_row(model, data, alen, tlen, nq, inp["rx"], rem)
            on_card = lambda: (cassandra_verdicts(model, data, alen, tlen, nq, rem),)
        else:
            kd, klen, hk, ib, op, cid, rem = args
            rows["memcache_hits"] = k11_row(model, kd, klen, hk, ib, op, cid, inp["rx"], rem)
            on_card = lambda: (memcache_verdicts(model, kd, klen, hk, ib, op, cid, rem),)
        row = scan_row(scans[kname], tab, data_s, s_, e_, span_bytes(s_, e_, width))
        row["span"] = span_of[c["kind"]]
        rows[f"{kname}:{row['span']}"] = row
        host = c["host"]
        timed[name] = dict(rows=rows, **pass_times(on_card, lambda: verdicts(c, model, host)))
        for kn, row in rows.items():
            bound(row)
            log_row(name, kn, row)
        log_pass(name, c["kind"] + "_verdicts", timed[name], card,
                 parent_turns(PASS_KERNELS[c["kind"]], on_card, {}))

    for name, (proto, port, policy, make, feeds) in engines.items():
        out = eng_card[name][0]
        frames = sum(1 for _, ops, _ in out for op, _ in ops if op in (1, 2))
        engine_times(f"{name}: {frames} frames of {len(feeds[0])} flows", frames, card,
                     lambda: run_l7_engine(lambda: make(models[model_of[proto]][0]), feeds))

    # K9 at the DNS engine's largest rule walk, its inputs recorded.
    proto, _, _, make, feeds = engines["dns-engine"]
    calls = recorded_calls(dns_mod, "dns_hits", lambda: run_l7_engine(
        lambda: make(models[model_of[proto]][0]), feeds))
    e_model, e_name, e_rx, e_rem = max(calls, key=lambda call: call[1].dotted.numel())
    timed["dns-engine"] = dict(rows={"dns_hits": k9_row(e_model, e_name, e_rx, e_rem)})
    log(f"dns-engine: K9 at F={e_name.dotted.shape[0]} L={e_name.dotted.shape[1]} R={e_model.n_rules}")
    log_row("dns-engine", "dns_hits", timed["dns-engine"]["rows"]["dns_hits"])

    # K10 and K11 at the Cassandra and memcache engines' largest calls and
    # the sidecar's (readings, beside the parent's in turns given
    # --baseline-csrc).
    for label, stem, call in acl_engine_shapes(dev):
        row = (k10_row if stem == "cassandra_hits" else k11_row)(*call)
        report[stem][label] = row["max_abs_err"]
        timed.setdefault(label, dict(rows={}))["rows"][stem] = row
        log(f"{label}: {stem} at F={call[1].shape[0]} R={call[0].n_rules}")
        log_row(label, stem, row)

    # dns-names-256 (a reading, in no counted run): 256 exact names of 8 to
    # 64 bytes and no automaton; the card against the host oracle, K9
    # against its plain version, timed.
    policy, frames = dns_names_case()
    model = build_dns_model(policy, True, 53)
    host = tile_rows(frames, [1] * len(frames), F, DNS_NAMES_WIDTH)
    data, lengths, rem = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host)
    n = len(frames)
    got = [t.cpu() for t in dns_verdicts_attr(model, data, lengths, rem)]
    want_o = dns_oracle(policy, frames, [1] * n)
    bad = sum(1 for i, w in enumerate(want_o) if (bool(got[2][i]), int(got[3][i])) != w)
    if bad or model.nfa is not None or model.n_rules != DNS_NAMES_RULES:
        raise AssertionError(f"dns-names-256: {bad} verdicts disagree with the host oracle")
    nm = dns_name(data, lengths)
    report["dns_hits"]["dns-names-256"] = max_abs_err(dns_hits(model, nm, None, rem),
                                                      dns_hits_plain(model, nm, None, rem))
    row = k9_row(model, nm, None, rem)
    timed["dns-names-256"] = dict(rows={"dns_hits": row})
    log(f"dns-names-256: F={F} width={DNS_NAMES_WIDTH} R={model.n_rules} W="
        f"{model.name_needle.shape[1]}; == host oracle on {n} distinct rows, allow share "
        f"{float(got[2][:n].float().mean()):.3f}")
    log_row("dns-names-256", "dns_hits", row)

    # K8 at dns-names-256, the DNS engine's largest call and the sidecar's
    # DNS bucket (readings, beside the parent's in turns given
    # --baseline-csrc).
    for label, data, lengths in dns_name_shapes(dev):
        row = k8_row(data, lengths)
        report["dns_name"][label] = 0  # k8_row raises where the kernel and its plain version differ
        timed.setdefault(label, dict(rows={}))["rows"]["dns_name"] = row
        log(f"{label}: K8 at F={data.shape[0]} L={data.shape[1]}")
        log_row(label, "dns_name", row)
    return launches, runs, span_runs, report, timed


# --- the L3/L4 datapath: maps, batches and the slice ----------------------------


def _ip4(s: str) -> int:
    return int(ipaddress.IPv4Address(s))


def _ip6(s: str) -> int:
    return int(ipaddress.IPv6Address(s))


def _flat(out) -> list:
    """A pass's outputs (a dict or tuple, with tuples of word tensors
    inside) as one list of tensors."""
    vals = out.values() if isinstance(out, dict) else out
    return [x for v in vals for x in (v if isinstance(v, tuple) else (v,))]


def _i32(a) -> np.ndarray:
    return (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def datapath6_case(f):
    """The v6 egress pass at bench_datapath's table scale: 64 VIPs x 3
    backends, 1,024 /64s and three /128s, 510 + 2 policy entries, 4,096
    CT entries; the mix of tests/test_datapath_pipeline6.py:61-94
    (service, established, ipcache hit and miss, UDP 53 to the wildcard
    rule) drawn from random.Random(31).  Returns (maps, (saddr ints,
    daddr ints, saddr words, daddr words, sport, dport, proto))."""
    from cilium_tpu_torch.maps.ctmap import PROTO_TCP, PROTO_UDP, CtKey6, CtMap
    from cilium_tpu_torch.maps.ipcache import IpcacheMap
    from cilium_tpu_torch.maps.lbmap import LbMap
    from cilium_tpu_torch.maps.policymap import DIR_EGRESS, PolicyMap
    from cilium_tpu_torch.ops.lpm import ipv6_to_words

    rng = random.Random(31)
    lb = LbMap()
    for s in range(64):
        lb.upsert_service6(_ip6(f"fd00:aa::{s + 1:x}"), 80,
                           [(_ip6(f"fd00:be::{s * 8 + b + 1:x}"), 8000 + b) for b in range(3)],
                           rev_nat_index=s + 1)
    ipc = IpcacheMap()
    for i in range(1024):
        ipc.upsert(f"fd00:{i:x}::/64", sec_label=256 + i)
    for j, host in enumerate(("fd00:3::7", "fd00:5::9", "fd00:be::5")):
        ipc.upsert(f"{host}/128", sec_label=2000 + j)
    pol = PolicyMap()
    for i in range(510):
        pol.allow(256 + i, 8000 + i % 3, PROTO_TCP, DIR_EGRESS,
                  proxy_port=16000 if i % 5 == 0 else 0)
    pol.allow(2000, 8000, PROTO_TCP, DIR_EGRESS)
    pol.allow(0, 53, PROTO_UDP, DIR_EGRESS)
    ct = CtMap()
    keys = []
    for k in range(4096):
        key = CtKey6(daddr=_ip6(f"fd00:be::{k % 192 + 1:x}"), saddr=_ip6(f"fd00:1::{k + 5:x}"),
                     dport=8000 + k % 3, sport=42000 + k % 20000, nexthdr=PROTO_TCP)
        ct.create(key)
        keys.append(key)
    saddr, daddr = [], []
    sport = np.zeros((f,), np.int64)
    dport = np.zeros((f,), np.int64)
    proto = np.zeros((f,), np.int64)
    for i in range(f):
        saddr.append(_ip6(f"fd00:{rng.randrange(8):x}::{rng.randrange(1, 200):x}"))
        roll = rng.random()
        if roll < 0.4:  # VIP traffic
            daddr.append(_ip6(f"fd00:aa::{rng.randrange(1, 67):x}"))
            dport[i] = 80 if rng.random() < 0.8 else 8080
        elif roll < 0.7:  # backend / pod
            daddr.append(_ip6(f"fd00:be::{rng.randrange(1, 30):x}"))
            dport[i] = rng.choice([8000, 53, 9999])
        elif roll < 0.85:  # a /128 entry
            daddr.append(_ip6("fd00:3::7"))
            dport[i] = 8000
        else:  # unknown -> world
            daddr.append(_ip6("2001:db8::9"))
            dport[i] = 8000
        if rng.random() < 0.2:  # an established tuple
            k = keys[rng.randrange(len(keys))]
            saddr[-1], daddr[-1] = k.saddr, k.daddr
            sport[i], dport[i] = k.sport, k.dport
        else:
            sport[i] = rng.randrange(1024, 60000)
        proto[i] = PROTO_TCP if rng.random() < 0.8 else PROTO_UDP
    return (ct, lb, ipc, pol), (saddr, daddr, ipv6_to_words(saddr), ipv6_to_words(daddr),
                                _i32(sport), _i32(dport), _i32(proto))


def node_case(f):
    """The node-ingress programs at the same table scale: 1,024 /24s (every
    eighth with a tunnel endpoint at or above 2^31) and a HOST_ID prefix,
    64 local endpoints and the host endpoint, 4,096 CT entries (2,048
    inbound, 2,048 egress-created whose replies come back swapped), 509 +
    3 ingress policy entries; the mix of tests/test_datapath_ingress.py:
    69-100 with reserved and HOST_ID sources, from random.Random(37).
    Returns (maps, {column: [f] int32})."""
    from cilium_tpu_torch.datapath.ingress import HOST_ID, WORLD_ID
    from cilium_tpu_torch.maps.ctmap import PROTO_TCP, PROTO_UDP, CtKey4, CtMap
    from cilium_tpu_torch.maps.ipcache import IpcacheMap
    from cilium_tpu_torch.maps.lxcmap import ENDPOINT_F_HOST, EndpointInfo, LxcMap
    from cilium_tpu_torch.maps.policymap import DIR_INGRESS, PolicyMap

    rng = random.Random(37)
    ipc = IpcacheMap()
    for i in range(1024):
        tun = _ip4(f"192.168.{i // 8 % 256}.{i % 250 + 1}") if i % 8 == 7 else 0
        ipc.upsert(f"10.{i // 256}.{i % 256}.0/24", sec_label=256 + i, tunnel_endpoint=tun)
    ipc.upsert("10.250.0.0/16", sec_label=HOST_ID)
    lxc = LxcMap()
    for e in range(64):
        lxc.upsert(f"10.0.0.{e + 10}", 40 + e, EndpointInfo(ifindex=e + 2))
    lxc.upsert("10.0.0.1", 1, EndpointInfo(flags=ENDPOINT_F_HOST))
    pol = PolicyMap()
    for i in range(509):
        pol.allow(256 + i, 8080, PROTO_TCP, DIR_INGRESS, proxy_port=14000 if i % 5 == 0 else 0)
    pol.allow(WORLD_ID, 8080, PROTO_TCP, DIR_INGRESS)
    pol.allow(0, 53, PROTO_UDP, DIR_INGRESS)
    pol.allow(300, 0, 0, DIR_INGRESS)
    ct = CtMap()
    inbound, outbound = [], []
    for k in range(2048):
        key = CtKey4(daddr=_ip4(f"10.0.0.{k % 64 + 10}"), saddr=_ip4(f"10.1.{k // 250 % 256}.{k % 250 + 1}"),
                     dport=8080, sport=41000 + k, nexthdr=PROTO_TCP)
        ct.create(key)
        inbound.append(key)
        key = CtKey4(daddr=_ip4(f"203.0.113.{k % 250 + 1}"), saddr=_ip4(f"10.0.0.{k % 64 + 10}"),
                     dport=443, sport=50000 + k, nexthdr=PROTO_TCP)
        ct.create(key)
        outbound.append(key)
    cols = {k: np.zeros((f,), np.int64) for k in
            ("saddr", "daddr", "sport", "dport", "proto", "src_id", "vni")}
    for i in range(f):
        roll = rng.random()
        if roll < 0.4:  # known pod source
            cols["saddr"][i] = _ip4(f"10.{rng.randrange(4)}.{rng.randrange(256)}.{rng.randrange(2, 250)}")
        elif roll < 0.55:  # SNAT / host-claiming prefix
            cols["saddr"][i] = _ip4(f"10.250.0.{rng.randrange(1, 250)}")
        else:  # unknown world source
            cols["saddr"][i] = _ip4(f"203.0.{rng.randrange(113, 120)}.{rng.randrange(1, 250)}")
        droll = rng.random()
        if droll < 0.45:  # local endpoint, sometimes an established tuple
            cols["daddr"][i] = _ip4(f"10.0.0.{rng.randrange(10, 74)}")
            cols["dport"][i] = rng.choice([8080, 53, 9000])
            cols["sport"][i] = rng.randrange(1024, 60000)
            pick = rng.random()
            if pick < 0.2:
                k = inbound[rng.randrange(len(inbound))]
                cols["saddr"][i], cols["daddr"][i] = k.saddr, k.daddr
                cols["sport"][i], cols["dport"][i] = k.sport, k.dport
            elif pick < 0.4:  # the reply to an egress-created entry
                k = outbound[rng.randrange(len(outbound))]
                cols["saddr"][i], cols["daddr"][i] = k.daddr, k.saddr
                cols["sport"][i], cols["dport"][i] = k.dport, k.sport
        elif droll < 0.55:  # host endpoint
            cols["daddr"][i] = _ip4("10.0.0.1")
            cols["dport"][i] = 22
            cols["sport"][i] = rng.randrange(1024, 60000)
        elif droll < 0.8:  # remote pod, via the overlay where the ipcache says so
            cols["daddr"][i] = _ip4(f"10.{rng.randrange(4)}.{rng.randrange(256)}.{rng.randrange(1, 250)}")
            cols["dport"][i] = 8080
            cols["sport"][i] = rng.randrange(1024, 60000)
        else:  # unknown destination
            cols["daddr"][i] = _ip4("198.51.100.7")
            cols["dport"][i] = 443
            cols["sport"][i] = rng.randrange(1024, 60000)
        cols["proto"][i] = PROTO_TCP if rng.random() < 0.8 else PROTO_UDP
        cols["src_id"][i] = rng.choice([0, 0, HOST_ID, 4, 100, 5000])
        cols["vni"][i] = rng.choice([256, 257, 300, WORLD_ID])
    return (ipc, lxc, ct, pol), {k: _i32(v) for k, v in cols.items()}


def prefilter_case(f):
    """1,024 v4 deny prefixes (/8-/32) and 256 v6 ones (/32-/128) drawn
    from random.Random(41), none inside 100.64.0.0/10 or fc00::/7; the
    sources are 20% inside a deny prefix and 80% in those two ranges.
    Returns (cidrs, v4 addresses, v6 addresses)."""
    rng = random.Random(41)
    keep4, keep6 = ipaddress.ip_network("100.64.0.0/10"), ipaddress.ip_network("fc00::/7")
    nets4, nets6 = [], []
    while len(nets4) < 1024:
        net = ipaddress.ip_network(f"{ipaddress.IPv4Address(rng.getrandbits(32))}/{rng.randrange(8, 33)}",
                                   strict=False)
        if not net.overlaps(keep4):
            nets4.append(net)
    while len(nets6) < 256:
        net = ipaddress.ip_network(f"{ipaddress.IPv6Address(rng.getrandbits(128))}/{rng.randrange(32, 129)}",
                                   strict=False)
        if not net.overlaps(keep6):
            nets6.append(net)

    def sources(nets, keep, bits):
        out = []
        for _ in range(f):
            if rng.random() < 0.2:
                net = rng.choice(nets)
                host = rng.getrandbits(bits - net.prefixlen) if net.prefixlen < bits else 0
                out.append(int(net.network_address) | host)
            else:
                out.append(int(keep.network_address) | rng.getrandbits(bits - keep.prefixlen))
        return out

    return ([str(n) for n in nets4 + nets6], sources(nets4, keep4, 32), sources(nets6, keep6, 128))


# tests/l34_index_cases.py's adversarial snapshots: all rows, one row a
# table, every row invalid
ADV_SHAPES = {"adv": {}, "adv-one-row": {"n": 1}, "adv-invalid": {"invalid": True}}


def _tests_module(name):
    """A module of tests/ (the case builders the card tests share)."""
    import importlib
    from pathlib import Path

    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def l34_cases():
    """tests/l34_index_cases.py: adversarial tables for K14 and K15."""
    return _tests_module("l34_index_cases")


def snapshot_ms(build):
    """Host-clock ms of ``build()`` on the card, synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def rebuild_indexes(tables):
    """Build the hashed index of each table of a snapshot again (each table
    builds its own; the snapshot only gathers them)."""
    from cilium_tpu_torch.maps.policymap import DevicePolicyMap

    for name in vars(tables.index):
        part = getattr(tables, name)
        (part.table if isinstance(part, DevicePolicyMap) else part).__post_init__()
    tables.__post_init__()


def lpm_pick(w, n, groups):
    """K12's launcher's path for a table, as text: 'LxG' (L lanes an
    address, G mask groups a round) or 'walk'."""
    from cilium_tpu_torch import kernels

    lanes, g = kernels.lpm_variant(w, n, groups)
    return f"{lanes}x{g}" if g else "walk"


def table_bytes(*objs):
    """Bytes of the tensors of tables (dataclasses, nested), not counting
    the hashed indexes they carry."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        else:
            total += table_bytes(*[v for k, v in vars(o).items() if k != "index"])
    return total


def hash_ops(words):
    """Integer ops of one MurmurHash3 of a key of ``words`` words
    (csrc/l34_index.cuh hash_key): 7 a word (two multiplies, two
    rotates, an xor, a multiply-add) and 8 to finish."""
    return 7 * words + 8


def index_bytes(ix):
    """Bytes a pass may read of one index: every bucket's bounds, the
    indexed rows' slots (not the zero slots past them) and, of an LPM's
    group list, the groups and the zero row that ends them."""
    from cilium_tpu_torch.ops import l34_index

    if isinstance(ix, l34_index.LpmIndex):
        return (ix.n_groups + 1) * ix.groups.shape[1] * 4 + index_bytes(ix.table)
    return table_bytes(ix.bounds) + ix.m * ix.width * 4


def k14_bytes(t, w):
    """K14's inputs and outputs once, its four indexes and the LB
    columns the probe still reads (counts, backends, rev NAT): the
    keys and values of the other tables live in the index slots."""
    lb = t.lb
    return (2 * w + 3) * 4 * F + (w + 6) * 4 * F + 2 * F \
        + sum(index_bytes(v) for v in vars(t.index).values()) \
        + table_bytes(lb.counts, lb.b_target_words, lb.b_port, lb.revnat)


def k15_bytes(t, netdev):
    """K15's inputs and outputs once and the indexes its mode probes
    (every value it reads lives in their slots)."""
    used = ["lxc", "ct", "policy", "ipcache_tun"] + (["ipcache_id"] if netdev else [])
    return 24 * F + 22 * F + sum(index_bytes(getattr(t.index, k)) for k in used)


def l34_slice(dev, card, kerns):
    """The fourth slice's paths on the card at F = 65,536: the v4 egress
    pass on bench_datapath's maps and mix (K14 datapath4), the v6 pass
    (K14 datapath6), node ingress from the netdev and the overlay (K15),
    the XDP prefilter for v4 and v6 (K12), and the map-level lookups on
    the passes' own intermediates (K13 exact_lookup, policy_can_access,
    lb_select and K12 on the ipcache), then a CT round trip through
    apply_ct_creates.  Every count is set to 0 just before the counted run
    and read just after; then the card is held against the CPU path on
    the whole batch, against the host oracles on 2,000 packets a shape,
    and each kernel against its plain version, and timed.  Returns
    (launches, runs, report, timed) for the kernels line."""
    import copy
    import gc

    from cilium_tpu_torch.datapath import ingress as ing_mod
    from cilium_tpu_torch.datapath import pipeline as dp_mod
    from cilium_tpu_torch.datapath import pipeline6 as dp6_mod
    from cilium_tpu_torch.datapath.notify import account_verdicts
    from cilium_tpu_torch.datapath.prefilter import PreFilter
    from cilium_tpu_torch.entry import datapath_batch, datapath_bench_maps
    from cilium_tpu_torch.flowlog import FlowLog
    from cilium_tpu_torch.maps import lbmap as lb_mod
    from cilium_tpu_torch.maps import policymap as pol_mod
    from cilium_tpu_torch.maps.metricsmap import MetricsMap
    from cilium_tpu_torch.maps.policymap import DIR_EGRESS
    from cilium_tpu_torch.models import cassandra as cass_mod
    from cilium_tpu_torch.models import dns as dns_mod
    from cilium_tpu_torch.models import memcached as mc_mod
    from cilium_tpu_torch import convert
    from cilium_tpu_torch.ops import l34_index
    from cilium_tpu_torch.ops import lpm as lpm_mod
    from cilium_tpu_torch.ops import maplookup as ml_mod

    new = {"lpm_lookup": lpm_mod._LPM, "exact_lookup": ml_mod._EXACT,
           "policy_can_access": pol_mod._POLICY, "lb_select": lb_mod._LB,
           "datapath4": dp_mod._DATAPATH[1], "datapath6": dp_mod._DATAPATH[4],
           "ingress": ing_mod._INGRESS}
    kerns = {**kerns, "dns_name": dns_mod._DNS_NAME, "dns_hits": dns_mod._DNS_HITS,
             "cassandra_hits": cass_mod._CASSANDRA_HITS, "memcache_hits": mc_mod._MEMCACHE_HITS, **new}
    host_arrays = dp_mod.host_arrays

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the shapes at F = 65,536
    t0 = time.monotonic()
    maps4 = datapath_bench_maps()
    pk4 = datapath_batch(F)
    maps6, (sa6, da6, sw6, dw6, sp6, dp6, pr6) = datapath6_case(F)
    node, npk = node_case(F)
    cidrs, src4, src6 = prefilter_case(F)
    words4 = _i32(src4)
    words6 = np.stack(lpm_mod.ipv6_to_words(src6))
    pf, pf_cpu = PreFilter(), PreFilter(device="cpu")
    for p in (pf, pf_cpu):
        p.insert(1, cidrs)
    tables = {
        "datapath": (dp_mod.build_tables(*maps4), dp_mod.build_tables(*maps4, device="cpu")),
        "datapath6": (dp6_mod.build_tables6(*maps6), dp6_mod.build_tables6(*maps6, device="cpu")),
        "node": (ing_mod.build_ingress_tables(*node), ing_mod.build_ingress_tables(*node, device="cpu")),
    }
    in4 = (pk4[0], pk4[1], *pk4[2:])
    in6 = (sw6, dw6, sp6, dp6, pr6)
    cols = [npk[k] for k in ("saddr", "daddr", "sport", "dport", "proto")]
    t4, t6, tn = (tables[k][0] for k in ("datapath", "datapath6", "node"))
    log(f"l34 shapes built in {time.monotonic() - t0:.1f} s: datapath CT {t4.ct.n} LB {t4.lb.valid.shape[0]}x"
        f"{t4.lb.b_port.shape[1]} ipcache {t4.ipcache.n} policy {t4.policy.table.n}; datapath6 CT "
        f"{t6.ct.n} LB {t6.lb.valid.shape[0]} ipcache {t6.ipcache.n} policy {t6.policy.table.n}; node "
        f"ipcache {tn.ipcache_id.n} lxc {tn.lxc.n} CT {tn.ct.n} policy {tn.policy.table.n}; prefilter "
        f"{pf.device_lpm().n} v4 / {pf.device_lpm(v6=True).n} v6 prefixes")

    for name, t, build in (("datapath", t4, lambda: dp_mod.build_tables(*maps4)),
                           ("datapath6", t6, lambda: dp6_mod.build_tables6(*maps6)),
                           ("node", tn, lambda: ing_mod.build_ingress_tables(*node))):
        pack_ms = snapshot_ms(build)
        ix_ms = snapshot_ms(lambda: rebuild_indexes(t))  # the tables' indexes, built again
        ixb = l34_index.nbytes(t.index)
        lpms = [v for v in vars(t.index).values() if isinstance(v, l34_index.LpmIndex)]
        log(f"{name}: tables built from the host maps in {pack_ms:.2f} ms (host clock), the hashed "
            f"index {ix_ms:.2f} ms of it; index {ixb} bytes beside {table_bytes(t)} bytes of "
            f"tables; CT {t.index.ct.buckets} buckets for {t.index.ct.m} rows; "
            f"{', '.join(str(x.n_groups) for x in lpms)} LPM mask group(s) [{card}]")

    for v6 in (False, True):
        lpm = pf.device_lpm(v6=v6)
        ix_ms = snapshot_ms(lpm.__post_init__)  # the index, built again
        log(f"prefilter{'6' if v6 else ''}: index of {lpm.n} prefixes built in {ix_ms:.2f} ms (host clock), "
            f"{l34_index.nbytes(lpm.index)} bytes [{card}]")
    for name, lpm in (("prefilter", pf.device_lpm()), ("prefilter6", pf.device_lpm(v6=True)),
                      ("datapath ipcache", t4.ipcache), ("datapath6 ipcache", t6.ipcache),
                      ("node ipcache", tn.ipcache_id)):
        g = lpm.index.n_groups
        log(f"K12 {name}: {lpm.n} prefixes, {g} mask group(s); the launcher takes "
            + lpm_pick(lpm.w, lpm.n, g))

    def maps_run(t, out, saddr_w, daddr_w, sport, dport, proto):
        """The map-level lookups on the pass's own intermediates: LB on
        daddr with the flow hash, CT on the post-DNAT tuple, the ipcache
        LPM and the policy cascade on dst_identity."""
        if t.w == 1:
            fh = dp_mod.flow_hash32(saddr_w[0], daddr_w[0], sport, dport, proto)
            lb = lb_mod.lb4_select_backend_batch(t.lb, daddr_w[0], dport, fh)
            lb = (lb[0], (lb[1],), lb[2], lb[3])
            nd = (out["new_daddr"],)
        else:
            fh = dp_mod.flow_hash32_v6(saddr_w, daddr_w, sport, dport, proto)
            lb = lb_mod.lb6_select_backend_batch(t.lb, daddr_w, dport, fh)
            nd = out["new_daddr_words"]
        ct = ml_mod.exact_lookup(t.ct, *nd, *saddr_w, out["new_dport"], sport, proto)
        ip = lpm_mod.lpm_lookup(t.ipcache, *nd)
        pol = pol_mod.policy_can_access_batch(t.policy, out["dst_identity"], out["new_dport"], proto,
                                              DIR_EGRESS)
        return dict(fh=fh, lb=lb, ct=ct, ip=ip, pol=pol)

    def maps_agree(name, out, m, daddr_w, dport):
        """The map-level answers compose to the pass's outputs."""
        found, target, port, rev = m["lb"]
        nd = (out["new_daddr"],) if "new_daddr" in out else out["new_daddr_words"]
        est, allowed, proxy = m["ct"][0], m["pol"][0], m["pol"][1]
        checks = [all(torch.equal(torch.where(found, t_, d), n) for t_, d, n in zip(target, daddr_w, nd)),
                  torch.equal(torch.where(found, port, dport), out["new_dport"]),
                  torch.equal(torch.where(found, rev, 0), out["rev_nat"]),
                  torch.equal(est, out["established"]),
                  torch.equal(torch.where(m["ip"][0], m["ip"][1], dp_mod.WORLD_ID), out["dst_identity"]),
                  torch.equal(torch.where(est, 0, proxy), out["proxy_port"]),
                  torch.equal(torch.where(est | allowed, torch.where((proxy > 0) & ~est, 2, 0), 1).to(torch.int32),
                              out["verdict"])]
        if not all(checks):
            raise AssertionError(f"{name}: the map-level lookups do not compose to the pass ({checks})")

    d4 = [on_dev(a) for a in pk4]
    d6 = (tuple(on_dev(w) for w in sw6), tuple(on_dev(w) for w in dw6), on_dev(sp6), on_dev(dp6), on_dev(pr6))
    dn = [on_dev(c) for c in cols]
    dsrc, dvni = on_dev(npk["src_id"]), on_dev(npk["vni"])

    # the main path, counted
    log("== L3/L4 datapath main path (counted)")

    def counts():
        return {n: k.launches for n, k in kerns.items()}

    def delta(before):
        return {n: k.launches - before[n] for n, k in kerns.items()}

    runs, outs = {}, {}

    def run(name, fn):
        before = counts()
        outs[name] = fn()
        runs[name] = delta(before)

    flowlogs = {"prefilter": FlowLog(capacity=1 << 17), "prefilter6": FlowLog(capacity=1 << 17)}
    ct4_rt, ct6_rt = copy.deepcopy(maps4[0]), copy.deepcopy(maps6[0])
    for k in kerns.values():
        k.launches = 0
    run("datapath", lambda: dp_mod.datapath_verdicts(t4, *in4))
    run("datapath-maps", lambda: maps_run(t4, outs["datapath"], (d4[0],), (d4[1],), *d4[2:]))
    run("datapath6", lambda: dp6_mod.datapath_verdicts6(t6, *in6))
    run("datapath6-maps", lambda: maps_run(t6, outs["datapath6"], *d6))
    run("netdev", lambda: ing_mod.netdev_verdicts(tn, *cols, npk["src_id"]))
    run("overlay", lambda: ing_mod.overlay_verdicts(tn, *cols, npk["vni"]))
    run("prefilter", lambda: pf.filter_batch(words4, flowlog=flowlogs["prefilter"]))
    run("prefilter6", lambda: pf.filter_batch(words6, v6=True, flowlog=flowlogs["prefilter6"]))
    # the CT round trip: the host applies the creates, the tables are
    # rebuilt, and every created flow must come back established
    rt_clock = time.monotonic()  # the timed round trips below see the CT as this one did
    created4 = dp_mod.apply_ct_creates(ct4_rt, outs["datapath"], pk4[0], pk4[2], pk4[4])
    created6 = dp6_mod.apply_ct_creates6(ct6_rt, outs["datapath6"], sw6, sp6, pr6)
    t4_rt = dp_mod.build_tables(ct4_rt, *maps4[1:])
    t6_rt = dp6_mod.build_tables6(ct6_rt, *maps6[1:])
    run("datapath-rt", lambda: dp_mod.datapath_verdicts(t4_rt, *in4))
    run("datapath6-rt", lambda: dp6_mod.datapath_verdicts6(t6_rt, *in6))
    torch.cuda.synchronize()
    launches = counts()
    log("launches:", json.dumps({k: n for k, n in launches.items() if n}))
    log("launches by run:", json.dumps({n: {k: c for k, c in r.items() if c} for n, r in runs.items()}))
    for n, count in launches.items():
        if sum(r[n] for r in runs.values()) != count:
            raise AssertionError(f"{n}: the runs' launches do not add up to the main path's")
    for n in new:
        if launches[n] <= 0:
            raise AssertionError(f"kernel {n} was not launched on the main path")
    maps_want = {"lb_select": 1, "exact_lookup": 1, "lpm_lookup": 1, "policy_can_access": 1}
    want = {"datapath": {"datapath4": 1}, "datapath-maps": maps_want, "datapath6": {"datapath6": 1},
            "datapath6-maps": maps_want, "netdev": {"ingress": 1}, "overlay": {"ingress": 1},
            "prefilter": {"lpm_lookup": 1}, "prefilter6": {"lpm_lookup": 1},
            "datapath-rt": {"datapath4": 1}, "datapath6-rt": {"datapath6": 1}}
    for name, w in want.items():
        got = {k: c for k, c in runs[name].items() if c}
        if got != w:
            raise AssertionError(f"{name}: launches {got} != {w}")

    # the card against the CPU path (whole batch) and the host oracles
    log("== L3/L4 datapath against the CPU path and the host oracles")
    maps_agree("datapath", outs["datapath"], outs["datapath-maps"], (d4[1],), d4[3])
    maps_agree("datapath6", outs["datapath6"], outs["datapath6-maps"], d6[1], d6[3])
    cpu = {
        "datapath": dp_mod.datapath_verdicts(tables["datapath"][1], *in4),
        "datapath6": dp6_mod.datapath_verdicts6(tables["datapath6"][1], *in6),
        "netdev": ing_mod.netdev_verdicts(tables["node"][1], *cols, npk["src_id"]),
        "overlay": ing_mod.overlay_verdicts(tables["node"][1], *cols, npk["vni"]),
    }
    card_h = {}
    for name, want_out in cpu.items():
        got, want_h = host_arrays(outs[name]), host_arrays(want_out)
        for key, w in want_h.items():
            for g_, w_ in zip(got[key] if isinstance(w, tuple) else (got[key],), w if isinstance(w, tuple) else (w,)):
                if g_.dtype != w_.dtype or not np.array_equal(g_, w_):
                    raise AssertionError(f"{name}: card {key} != CPU path")
        card_h[name] = got
    for name, words, v6 in (("prefilter", words4, False), ("prefilter6", words6, True)):
        keep_cpu = pf_cpu.filter_batch(words, v6=v6)
        if not np.array_equal(outs[name], keep_cpu):
            raise AssertionError(f"{name}: card keep mask != CPU path")
    sample = sorted(random.Random(43).sample(range(F), 2000))

    def u32(x):
        return int(np.int64(x) & 0xFFFFFFFF)

    def hold(name, oracle_fn, fields):
        got = card_h[name]
        for i in sample:
            want_o = oracle_fn(i)
            for key in fields:
                if u32(got[key][i]) != u32(want_o[key]):
                    raise AssertionError(f"{name}: packet {i} {key} {got[key][i]} != oracle {want_o[key]}")

    fields4 = ("verdict", "new_daddr", "new_dport", "dst_identity", "proxy_port", "rev_nat",
               "established", "needs_ct_create")
    hold("datapath", lambda i: dp_mod.host_oracle(*maps4, u32(pk4[0][i]), u32(pk4[1][i]), int(pk4[2][i]),
                                                   int(pk4[3][i]), int(pk4[4][i])), fields4)
    got6 = card_h["datapath6"]
    for i in sample:
        want_o = dp6_mod.host_oracle6(*maps6, sa6[i], da6[i], int(sp6[i]), int(dp6[i]), int(pr6[i]))
        words = sum(u32(w[i]) << (96 - 32 * j) for j, w in enumerate(got6["new_daddr_words"]))
        if words != want_o["new_daddr"] or any(u32(got6[k][i]) != u32(want_o[k]) for k in fields4 if k != "new_daddr"):
            raise AssertionError(f"datapath6: packet {i} != oracle {want_o}")
    fieldsn = ("verdict", "src_identity", "lxc_id", "tunnel_endpoint", "proxy_port", "established",
               "needs_ct_create")
    hold("netdev", lambda i: ing_mod.host_oracle_netdev(
        *node, *(u32(c[i]) if j < 2 else int(c[i]) for j, c in enumerate(cols)),
        src_identity=int(npk["src_id"][i])), fieldsn)
    hold("overlay", lambda i: ing_mod.host_oracle_netdev(
        *node, *(u32(c[i]) if j < 2 else int(c[i]) for j, c in enumerate(cols)),
        tunnel_id=int(npk["vni"][i])), fieldsn)
    nets = [ipaddress.ip_network(c) for c in cidrs]
    for name, srcs, keep, v in (("prefilter", src4, outs["prefilter"], 4),
                                ("prefilter6", src6, outs["prefilter6"], 6)):
        deny = [n for n in nets if n.version == v]
        for i in sample:
            addr = ipaddress.ip_address(srcs[i])
            if bool(keep[i]) == any(addr in n for n in deny):
                raise AssertionError(f"{name}: packet {i} keep {keep[i]} disagrees with the deny sets")
    for name, out, created in (("datapath-rt", outs["datapath-rt"], outs["datapath"]),
                               ("datapath6-rt", outs["datapath6-rt"], outs["datapath6"])):
        need = created["needs_ct_create"]
        if not bool(need.any()) or not bool(out["established"][need].all()):
            raise AssertionError(f"{name}: a created flow did not come back established")
    log(f"CT round trip: {created4} v4 and {created6} v6 entries created; every created flow comes back "
        f"established (v4 established share {float(outs['datapath-rt']['established'].float().mean()):.3f})")
    acct = []
    for out in (outs["datapath"], cpu["datapath"]):
        fl = FlowLog(capacity=1 << 17)
        counts_ = account_verdicts(out, MetricsMap(), flowlog=fl, proto=pk4[4])
        acct.append((counts_, [{k: v for k, v in r.items() if k != "ts"} for r in fl.query(n=1 << 17)]))
    if acct[0] != acct[1] or not acct[0][1]:
        raise AssertionError("account_verdicts: the card's output accounts differently from the CPU path's")
    log(f"account_verdicts on the card's output: {acct[0][0]}, {len(acct[0][1])} flow records, "
        "equal to the CPU path's")
    for name in ("datapath", "datapath6", "netdev", "overlay"):
        v = card_h[name]["verdict"]
        log(f"{name}: card == CPU path on {F} packets, == host oracle on {len(sample)}; verdicts "
            f"{np.bincount(v, minlength=5).tolist()} (FORWARD, DROP, TO_PROXY, TO_HOST, TO_OVERLAY), "
            f"established share {card_h[name]['established'].mean():.3f}")
    for name in ("prefilter", "prefilter6"):
        log(f"{name}: card == CPU path, == deny sets on {len(sample)}; drop share "
            f"{1 - outs[name].mean():.3f}, {len(flowlogs[name].query(n=1 << 17))} flow records")

    # kernels against their plain versions, at the main path's inputs
    log("== K12-K15 vs plain")
    report = {}

    def put(kname, label, got, want_):
        report.setdefault(kname, {})[label] = max_abs_err(_flat(got), _flat(want_))

    inputs = {}
    for name, t, w, args in (("datapath", t4, 1, ((d4[0],), (d4[1],), *d4[2:])), ("datapath6", t6, 4, d6)):
        put(f"datapath{4 if w == 1 else 6}", name, dp_mod.datapath_pass(t, *args),
            dp_mod.datapath_pass_plain(t, *args))
        out = outs[name]
        nd = (out["new_daddr"],) if w == 1 else out["new_daddr_words"]
        m = outs[f"{name}-maps"]
        saddr_w, daddr_w, sport, dport, proto = args
        lb_in = (t.lb, daddr_w, dport, m["fh"])
        ct_in = (t.ct, *nd, *saddr_w, out["new_dport"], sport, proto)
        pol_in = (t.policy, out["dst_identity"], out["new_dport"], proto, DIR_EGRESS)
        put("lb_select", f"{name}-maps", lb_mod.lb_select(*lb_in), lb_mod.lb_select_plain(*lb_in))
        put("exact_lookup", f"{name}-maps", ml_mod.exact_lookup(*ct_in), ml_mod.exact_lookup_plain(*ct_in))
        put("lpm_lookup", f"{name}-maps", lpm_mod.lpm_lookup(t.ipcache, *nd), lpm_mod.lpm_lookup_plain(t.ipcache, *nd))
        put("policy_can_access", f"{name}-maps", pol_mod.policy_can_access_batch(*pol_in),
            pol_mod.policy_can_access_plain(*pol_in))
        inputs[name] = dict(args=args, fh=m["fh"])
    for name, t, args in (("datapath-rt", t4_rt, ((d4[0],), (d4[1],), *d4[2:])), ("datapath6-rt", t6_rt, d6)):
        put(f"datapath{4 if t.w == 1 else 6}", name, dp_mod.datapath_pass(t, *args),
            dp_mod.datapath_pass_plain(t, *args))
    for name, mode, src in (("netdev", ing_mod.MODE_NETDEV, dsrc), ("overlay", ing_mod.MODE_OVERLAY, dvni)):
        put("ingress", name, ing_mod.ingress(tn, mode, *dn, src), ing_mod.ingress_plain(tn, mode, *dn, src))
    pf_words = {"prefilter": (on_dev(words4),), "prefilter6": tuple(on_dev(w) for w in words6)}
    for name, ws in pf_words.items():
        lpm = pf.device_lpm(v6=name == "prefilter6")
        put("lpm_lookup", name, lpm_mod.lpm_lookup(lpm, *ws), lpm_mod.lpm_lookup_plain(lpm, *ws))
    # K14 and K15 on adversarial tables (tests/l34_index_cases.py)
    ic = l34_cases()
    rng = np.random.default_rng(61)
    adv = {}
    for label, kw in ADV_SHAPES.items():
        for w, kname in ((1, "datapath4"), (4, "datapath6")):
            leaves = ic.datapath_leaves(rng, w, **kw)
            t = (convert.datapath_tables_from_numpy if w == 1 else convert.datapath_tables6_from_numpy)(
                leaves, device=dev)
            sw, dw, sp, dpt, pr = ic.datapath_packets(rng, leaves, w, F)
            args = (tuple(on_dev(x) for x in sw), tuple(on_dev(x) for x in dw), on_dev(sp), on_dev(dpt),
                    on_dev(pr))
            name = f"{'datapath' if w == 1 else 'datapath6'}-{label}"
            put(kname, name, dp_mod.datapath_pass(t, *args), dp_mod.datapath_pass_plain(t, *args))
            adv[name] = (kname, t, args)
        leaves = ic.ingress_leaves(rng, **kw)
        t = convert.ingress_tables_from_numpy(leaves, device=dev)
        p = ic.ingress_packets(rng, leaves, F)
        cols_ = [on_dev(p[k]) for k in ("saddr", "daddr", "sport", "dport", "proto")]
        for mode, mname, src in ((ing_mod.MODE_NETDEV, "netdev", "src_id"), (ing_mod.MODE_OVERLAY, "overlay", "vni")):
            args = (mode, *cols_, on_dev(p[src]))
            put("ingress", f"{mname}-{label}", ing_mod.ingress(t, *args), ing_mod.ingress_plain(t, *args))
            adv[f"{mname}-{label}"] = ("ingress", t, args)
    # K14 and K15 on tables with more value columns: 16-word slots of
    # values, or slots of row ids whose rows a match reads
    wrng = np.random.default_rng(62)
    for label, widths in ic.WIDE.items():
        for w, kname in ((1, "datapath4"), (4, "datapath6")):
            leaves = ic.widen_datapath(wrng, ic.datapath_leaves(wrng, w), w, **widths)
            t = (convert.datapath_tables_from_numpy if w == 1 else convert.datapath_tables6_from_numpy)(
                leaves, device=dev)
            sw, dw, sp, dpt, pr = ic.datapath_packets(wrng, leaves, w, F)
            args = (tuple(on_dev(x) for x in sw), tuple(on_dev(x) for x in dw), on_dev(sp), on_dev(dpt),
                    on_dev(pr))
            put(kname, f"{'datapath' if w == 1 else 'datapath6'}-{label}", dp_mod.datapath_pass(t, *args),
                dp_mod.datapath_pass_plain(t, *args))
        leaves = ic.widen_ingress(wrng, ic.ingress_leaves(wrng), **widths)
        t = convert.ingress_tables_from_numpy(leaves, device=dev)
        p = ic.ingress_packets(wrng, leaves, F)
        cols_ = [on_dev(p[k]) for k in ("saddr", "daddr", "sport", "dport", "proto")]
        for mode, mname, src in ((ing_mod.MODE_NETDEV, "netdev", "src_id"), (ing_mod.MODE_OVERLAY, "overlay", "vni")):
            args = (mode, *cols_, on_dev(p[src]))
            put("ingress", f"{mname}-{label}", ing_mod.ingress(t, *args), ing_mod.ingress_plain(t, *args))
    # K12 and K13 on adversarial tables, tables of many mask groups and a
    # wide table (tests/l34_index_cases.py)
    for name, words, masks, plen, values, valid in (
            ic.lpm_cases(rng, 1) + ic.lpm_cases(rng, 4)
            + [(f"many{w}-{n}", *ic.many_group_lpm(rng, w, n)) for w, n in ((4, 256), (1, 1024), (4, 2048))]):
        lpm = lpm_mod.lpm_from_arrays(words, masks, plen, values, valid, device=dev)
        ws = [on_dev(np.concatenate([a, b])) for a, b in zip(ic.addr_queries(rng, words, masks, F // 2),
                                                            ic.lpm_sources(rng, words, masks, F // 2))]
        put("lpm_lookup", f"lpm-{name}", lpm_mod.lpm_lookup(lpm, *ws), lpm_mod.lpm_lookup_plain(lpm, *ws))
        log(f"lpm-{name}: {lpm.n} rows, {lpm.index.n_groups} mask group(s); the launcher takes "
            + lpm_pick(lpm.w, lpm.n, lpm.index.n_groups))
    for name, cols_, vals, valid in ic.exact_cases(rng) + [("wide", *ic.wide_table(rng))]:
        table = ml_mod.table_from_arrays(list(cols_), vals, valid, device=dev)
        q = [on_dev(x) for x in ic.key_queries(rng, cols_, F)]
        put("exact_lookup", f"exact-{name}", ml_mod.exact_lookup(table, *q), ml_mod.exact_lookup_plain(table, *q))
    for nv in (1, 12):
        leaves = ic._policy_leaves(rng, np.array([5, 9, 300]), 1, n=300)
        vals = np.concatenate([leaves[4], ic.i32(rng.integers(0, 1 << 32, (300, nv - 1)))], 1)
        dmap = pol_mod.DevicePolicyMap(table=ml_mod.table_from_arrays(leaves[:4], vals, leaves[5], device=dev))
        q = [on_dev(x) for x in ic.key_queries(rng, np.stack(leaves[:4]), F)[:3]]
        put("policy_can_access", f"policy-adv-v{nv}", pol_mod.policy_can_access_batch(dmap, *q, DIR_EGRESS),
            pol_mod.policy_can_access_plain(dmap, *q, DIR_EGRESS))
    for w, cls in ((1, lb_mod.DeviceLbMap), (4, lb_mod.DeviceLb6Map)):
        leaves = ic.lb_arrays(rng, w, s=300)
        dlb = cls.from_arrays(*leaves, dev)
        vw = np.asarray(leaves[0]).reshape(w, -1)[:, rng.integers(0, 300, F)]
        lb_in = (dlb, [on_dev(x) for x in vw], on_dev(rng.choice(np.array([0, 80, 443], np.int32), F)),
                 on_dev(ic.i32(rng.integers(0, 1 << 32, F, dtype=np.int64))))
        put("lb_select", f"lb-adv-w{w}", lb_mod.lb_select(*lb_in), lb_mod.lb_select_plain(*lb_in))
    log("max |kernel - plain|:", json.dumps(report))
    for kname, per in report.items():
        for label, err in per.items():
            if err != 0:
                raise AssertionError(f"{kname} disagrees with its plain version on {label}")

    # times
    log("== L3/L4 datapath times on", card)
    timed = {}

    nbytes = table_bytes

    # Operations as the walks of csrc/l34.cuh need them on this run's data:
    # one integer op (a compare, or the AND of a mask) for the reject column
    # of every row a walk reads, and the row's other key columns only where
    # that one passed.
    def chunks(n):
        step = ml_mod.chunk_rows(n)
        return [(lo, min(F, lo + step)) for lo in range(0, F, step)]

    def first_rows(table, queries):
        """[F] rows a walk that stops at its first match reads: up to its
        first row matching any of ``queries``, all N on a miss."""
        out = torch.empty(F, dtype=torch.int64, device=dev)
        for lo, hi in chunks(table.n):
            m = None
            for q in queries:
                mq = ml_mod.table_matches(table, q, lo, hi)
                m = mq if m is None else m | mq
            first = torch.argmax(m.to(torch.int32), dim=1) + 1
            out[lo:hi] = torch.where(m.any(dim=1), first, table.n)
        return out

    def passing(n, test, limit=None):
        """``test(lo, hi)``'s [hi - lo, n] rows summed over the F queries,
        only those below ``limit[f]`` (the rows the walk reads) when given."""
        total = 0
        idx = torch.arange(n, device=dev)
        for lo, hi in chunks(n):
            m = test(lo, hi)
            if limit is not None:
                m = m & (idx[None, :] < limit[lo:hi, None])
            total += int(m.sum())
        return total

    def exact_ops(table, q, limit=None):
        """exact_sum: column K - 2 of every row read (all N, or up to
        ``limit``), the other K - 1 where it matched; without a limit
        (every matched row summed) one add a value column a matched row."""
        k = len(q)
        c = k - 2 if k >= 2 else 0
        col = table.cols[c]
        ops = (F * table.n if limit is None else int(limit.sum())) \
            + (k - 1) * passing(table.n, lambda lo, hi: col[None, :] == q[c][lo:hi, None], limit)
        if limit is None:
            ops += table.values.shape[1] * passing(table.n, lambda lo, hi: ml_mod.table_matches(table, q, lo, hi))
        return ops

    def lpm_ops(lpm, words):
        """lpm_walk: the mask and compare of word 0 of every prefix, of
        words 1..W-1 where word 0 matched."""
        a, m0, w0 = words[0], lpm.masks[0], lpm.words[0]
        ops = 2 * F * lpm.n
        if len(words) > 1:
            ops += 2 * (len(words) - 1) * passing(
                lpm.n, lambda lo, hi: (a[lo:hi, None] & m0[None, :]) == w0[None, :])
        return ops

    def policy_ops(pmap, ident):
        """policy_walk: the identity column of every row against the
        identity and 0, the dport, proto and direction columns where it
        passed."""
        c0 = pmap.table.cols[0]
        return 2 * F * pmap.table.n + 3 * passing(
            pmap.table.n, lambda lo, hi: (c0[None, :] == ident[lo:hi, None]) | (c0[None, :] == 0))

    def lb_ops(lb, vip_words):
        """lb_walk: VIP word 0 of every service, words 1..W-1 and the
        two port tests (the L4 port, the wildcard) where it matched."""
        v0, a = lb.vip_words[0], vip_words[0]
        return F * lb.valid.shape[0] + (len(vip_words) + 1) * passing(
            lb.valid.shape[0], lambda lo, hi: v0[None, :] == a[lo:hi, None])

    def ct_either_ops(ct, sa, da, sp, dp, pr):
        """ingress.cu ct_either: the sport column of every row up to the
        first match of either orientation, against both ports; the other
        four columns of each orientation whose port matched."""
        limit = first_rows(ct, [(da, sa, dp, sp, pr), (sa, da, sp, dp, pr)])
        c3 = ct.cols[3]
        fwd = passing(ct.n, lambda lo, hi: c3[None, :] == sp[lo:hi, None], limit)
        rev = passing(ct.n, lambda lo, hi: c3[None, :] == dp[lo:hi, None], limit)
        return 2 * int(limit.sum()) + 4 * (fwd + rev), limit

    def row(fn, plain, bytes_, ops, plain_iters=3):
        return bound(dict(ms=graph_ms(fn), call_ms=cuda_ms(fn, 30), plain_ms=cuda_ms(plain, plain_iters),
                          bytes=bytes_, ops=ops))

    def index_row(fn, plain, bytes_, probes, walk_bytes=None, walk_ops=None):
        """A K14 / K15 row held to the index design's bound: ``bytes_`` (the
        inputs and outputs once, the tables and the indexes read once) and
        the hashes each packet computes at least (``probes``: the key words
        of each probe), beside the walk's bound (the parent's design: the
        row walks of csrc/l34.cuh on this run's data, tables once)."""
        r = row(fn, plain, bytes_, F * sum(hash_ops(k) for k in probes))
        if walk_ops is not None:
            wb = bound(dict(bytes=walk_bytes, ops=walk_ops))
            r["walk_bound_ms"], r["walk_bound_by"] = wb["bound_ms"], wb["bound_by"]
        return r

    def map_row(fn, plain, io, ix, hashes, walk_bytes, walk_ops, extra=0):
        """A K12 / K13 row held to the least of two bounds: the index
        design's (``io`` bytes in and out, the index ``ix`` read once and
        ``extra`` bytes read beside it; ``hashes`` the MurmurHash3 ops of
        the probes this run's queries need) and the walk's (the parent's
        design: the row walks on this run's data, the tables read once)."""
        r = row(fn, plain, io + index_bytes(ix) + extra, hashes)
        wb = bound(dict(bytes=walk_bytes, ops=walk_ops))
        r["index_bound_ms"], r["index_bound_by"] = r["bound_ms"], r["bound_by"]
        r["walk_bound_ms"], r["walk_bound_by"] = wb["bound_ms"], wb["bound_by"]
        if wb["bound_ms"] < r["bound_ms"]:
            r["bound_ms"], r["bound_by"] = wb["bound_ms"], wb["bound_by"]
        return r

    def lpm_hashes(lpm, words):
        """The MurmurHash3 ops of the groups a best-first probe must see at
        least: a query probes every group whose best score reaches the
        score it ends with (all of them on a miss)."""
        gb = lpm.index.groups[:lpm.index.n_groups, 0]
        plen = lpm_mod.lpm_lookup_plain(lpm, *words)[2]
        probes = 0
        for lo, hi in chunks(gb.numel()):
            probes += int((gb[None, :] >= plen[lo:hi, None] + 1).sum())
        return probes * hash_ops(len(words) + 1)

    def lpm_row(lpm, ws):
        """K12 at one table, in turns with the parent's kernel."""
        def fn():
            return lpm_mod.lpm_lookup(lpm, *ws)

        w = len(ws)
        r = map_row(fn, lambda: lpm_mod.lpm_lookup_plain(lpm, *ws), w * 4 * F + 9 * F, lpm.index,
                    lpm_hashes(lpm, ws), w * 4 * F + 9 * F + nbytes(lpm), lpm_ops(lpm, ws))
        r["groups"] = lpm.index.n_groups
        r["variant"] = lpm_pick(w, lpm.n, r["groups"])
        return parent_turns("lpm", fn, r)

    for name, base, t, w in (("datapath", "datapath", t4, 1), ("datapath6", "datapath6", t6, 4),
                             ("datapath-rt", "datapath", t4_rt, 1), ("datapath6-rt", "datapath6", t6_rt, 4)):
        inp = inputs[base]
        args = inp["args"]
        out = outs[name]
        nd = (out["new_daddr"],) if w == 1 else out["new_daddr_words"]
        saddr_w, daddr_w, sport, dport, proto = args
        lb_in = (t.lb, daddr_w, dport, inp["fh"])
        ct_in = (t.ct, *nd, *saddr_w, out["new_dport"], sport, proto)
        pol_in = (t.policy, out["dst_identity"], out["new_dport"], proto, DIR_EGRESS)
        kname = f"datapath{4 if w == 1 else 6}"
        ct_limit = first_rows(t.ct, [ct_in[1:]])
        ct_rows = int(ct_limit.sum())
        io = (2 * w + 3) * 4 * F + (w + 6) * 4 * F + 2 * F
        map_ops = {"lb_select": lb_ops(t.lb, lb_in[1]), "lpm_lookup": lpm_ops(t.ipcache, nd),
                   "policy_can_access": policy_ops(t.policy, pol_in[1])}
        ops = sum(map_ops.values()) + exact_ops(t.ct, ct_in[1:], ct_limit)
        ixb = l34_index.nbytes(t.index)

        def k14():
            return _flat(dp_mod.datapath_pass(t, *args))

        r = index_row(k14, lambda: dp_mod.datapath_pass_plain(t, *args), k14_bytes(t, w),
                      [w + 1] * 4 + [2 * w + 3] + [4] * 3, io + nbytes(t), ops)
        rows = {kname: parent_turns("datapath", k14, r)}
        host_t = {"datapath": t4, "datapath6": t6, "datapath-rt": t4_rt, "datapath6-rt": t6_rt}[name]
        pt = pass_times(k14, (lambda: _flat(dp_mod.datapath_verdicts(host_t, *in4))) if w == 1
                        else (lambda: _flat(dp6_mod.datapath_verdicts6(host_t, *in6))))
        timed[name] = dict(rows=rows, **pt)
        log_row(name, kname, rows[kname])
        log(f"{name}: CT {t.ct.n} rows, index {ixb} bytes; the parent's CT walk must compare "
            f"{ct_rows / F:.1f} rows a packet (to its first match, all {t.ct.n} on a miss); walk bound "
            f"{r['walk_bound_ms']:.6f} ms ({r['walk_bound_by']})")
        log_pass(name, kname, timed[name], card, parent=rows[kname])
        if name != base:
            continue
        k_ct = 2 * w + 3
        lb = t.lb
        lb_io = (w + 2) * 4 * F + F + (w + 2) * 4 * F
        ct_io = k_ct * 4 * F + F + 4 * F
        pol_io = 12 * F + 5 * F

        def k13(fn):
            return lambda: _flat(fn())

        mrows = {
            "lb_select": parent_turns("l34_tables", k13(lambda: lb_mod.lb_select(*lb_in)), map_row(
                lambda: lb_mod.lb_select(*lb_in), lambda: lb_mod.lb_select_plain(*lb_in), lb_io, t.index.lb,
                F * 2 * hash_ops(w + 1), lb_io + nbytes(lb), map_ops["lb_select"],
                extra=nbytes(lb.counts, lb.b_target_words, lb.b_port, lb.revnat))),
            "exact_lookup": parent_turns("l34_tables", k13(lambda: ml_mod.exact_lookup(*ct_in)), map_row(
                lambda: ml_mod.exact_lookup(*ct_in), lambda: ml_mod.exact_lookup_plain(*ct_in), ct_io,
                t.index.ct, F * hash_ops(k_ct), ct_io + nbytes(t.ct), exact_ops(t.ct, ct_in[1:]))),
            "lpm_lookup": lpm_row(t.ipcache, nd),
            "policy_can_access": parent_turns("l34_tables", k13(lambda: pol_mod.policy_can_access_batch(*pol_in)),
                                              map_row(lambda: pol_mod.policy_can_access_batch(*pol_in),
                                                      lambda: pol_mod.policy_can_access_plain(*pol_in), pol_io,
                                                      t.index.policy, F * 3 * hash_ops(4),
                                                      pol_io + nbytes(t.policy),
                                                      map_ops["policy_can_access"])),
        }
        timed[f"{name}-maps"] = dict(rows=mrows)
        for kn, mr in mrows.items():
            log_row(f"{name}-maps", kn, mr)
    # The whole CT round trip on the host clock: the creates applied to a
    # fresh copy of the CT map, the tables (and their indexes) rebuilt and
    # the pass read back, five times.  (Not in turns with the parent's
    # kernel: both sides would run this tree's host code, and the kernel is
    # well under the host clock's spread.  That a snapshot builds one index
    # a table is held by tests/test_torch_map_index.py.)  The
    # copies' clock stays at the counted round trip's, so every trip expires
    # and creates the same entries; the collector runs before each trip and
    # is off during it (its pauses spread the readings 3x otherwise).
    trips = (("datapath-rt", maps4, t4,
              lambda ct: dp_mod.apply_ct_creates(ct, outs["datapath"], pk4[0], pk4[2], pk4[4]),
              lambda ct: dp_mod.datapath_verdicts(dp_mod.build_tables(ct, *maps4[1:]), *in4)),
             ("datapath6-rt", maps6, t6, lambda ct: dp6_mod.apply_ct_creates6(ct, outs["datapath6"], sw6, sp6, pr6),
              lambda ct: dp6_mod.datapath_verdicts6(dp6_mod.build_tables6(ct, *maps6[1:]), *in6)))
    for name, maps, t, apply, rebuild_pass in trips:
        def trip():
            ct = copy.deepcopy(maps[0])
            ct.clock = lambda: rt_clock
            gc.collect()
            gc.disable()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                apply(ct)
                got = torch.stack([x.to(torch.int32) for x in _flat(rebuild_pass(ct))]).cpu()
                return (time.perf_counter() - t0) * 1e3, got
            finally:
                gc.enable()

        readings, want = [], None
        for _ in range(5):
            ms, got = trip()
            want = got if want is None else want
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: the timed round trips disagree")
            readings.append(ms)
        timed[name]["round_trip"] = readings
        log(f"{name:15s} CT round trip (creates applied, tables and indexes rebuilt, pass read back), host "
            f"clock: " + ", ".join(f"{x:.2f}" for x in readings) + f" ms [{card}]")
    for name, mode, src in (("netdev", ing_mod.MODE_NETDEV, dsrc), ("overlay", ing_mod.MODE_OVERLAY, dvni)):
        sa, da, sp, dp, pr = dn
        netdev = mode == ing_mod.MODE_NETDEV
        ct_ops, ct_limit = ct_either_ops(tn.ct, sa, da, sp, dp, pr)
        ct_rows = int(ct_limit.sum())
        ops = (lpm_ops(tn.ipcache_id, (sa,)) if netdev else 0) \
            + exact_ops(tn.lxc, (da,)) + ct_ops + policy_ops(tn.policy, outs[name]["src_identity"]) \
            + lpm_ops(tn.ipcache_tun, (da,))
        used = ["lxc", "ct", "policy", "ipcache_tun"] + (["ipcache_id"] if netdev else [])
        tbytes = nbytes(*[getattr(tn, k) for k in used])
        ixb = sum(l34_index.nbytes(getattr(tn.index, k)) for k in used)

        def k15():
            return _flat(ing_mod.ingress(tn, mode, *dn, src))

        r = index_row(k15, lambda: ing_mod.ingress_plain(tn, mode, *dn, src), k15_bytes(tn, netdev),
                      ([2, 2] if netdev else []) + [1, 5, 5, 2, 2, 4, 4, 4], 24 * F + 22 * F + tbytes, ops)
        rows = {"ingress": parent_turns("ingress", k15, r)}
        host_src = npk["src_id"] if netdev else npk["vni"]
        timed[name] = dict(rows=rows, **pass_times(k15, lambda: _flat(ing_mod.ingress(tn, mode, *cols, host_src))))
        log_row(name, "ingress", rows["ingress"])
        log(f"{name}: index {ixb} bytes; the parent's CT walk must compare {ct_rows / F:.1f} rows a packet "
            f"(either orientation); walk bound {r['walk_bound_ms']:.6f} ms ({r['walk_bound_by']})")
        log_pass(name, "ingress", timed[name], card, parent=rows["ingress"])
    for name, (kname, t, args) in adv.items():
        if not name.endswith("-adv"):
            continue
        if kname == "ingress":
            netdev = args[0] == ing_mod.MODE_NETDEV

            def fn():
                return _flat(ing_mod.ingress(t, *args))

            r = index_row(fn, lambda: ing_mod.ingress_plain(t, *args), k15_bytes(t, netdev),
                          ([2, 2] if netdev else []) + [1, 5, 5, 2, 2, 4, 4, 4])
        else:
            w = t.w

            def fn():
                return _flat(dp_mod.datapath_pass(t, *args))

            r = index_row(fn, lambda: dp_mod.datapath_pass_plain(t, *args), k14_bytes(t, w),
                          [w + 1] * 4 + [2 * w + 3] + [4] * 3)
        timed[name] = dict(rows={kname: parent_turns(kname if kname == "ingress" else "datapath", fn, r)})
        groups = [v.n_groups for v in vars(t.index).values() if isinstance(v, l34_index.LpmIndex)]
        log_row(name, kname, r)
        log(f"{name}: {groups} LPM mask group(s), index {l34_index.nbytes(t.index)} bytes")
    for name, ws in pf_words.items():
        v6 = name == "prefilter6"
        lpm = pf.device_lpm(v6=v6)
        host_words = words6 if v6 else words4
        rows = {"lpm_lookup": lpm_row(lpm, ws)}
        timed[name] = dict(rows=rows, **pass_times(
            lambda: (lpm_mod.prefilter_check_batch(lpm, *ws),),
            lambda: (torch.from_numpy(pf.filter_batch(host_words, v6=v6)),)))
        log_row(name, "lpm_lookup", rows["lpm_lookup"])
        log_pass(name, "filter_batch", timed[name], card)
    return launches, runs, report, timed


# --- timing -------------------------------------------------------------------


# --- phase 9: the sidecar verdict service ------------------------------------

SIDE_NAMES = {"r2d2": "sidecar-pol", "http": "http-graft", "dns": "dns-bench",
              "cassandra": "cass-bench", "memcache": "mc-bench"}
SIDE_PORTS = {"r2d2": 80, "http": 80, "dns": 53, "cassandra": 9042, "memcache": 11211}
# Connections per protocol (ISSUE shapes): r2d2 4,096 under bench_mixed's
# mix, HTTP and DNS 1,024, Cassandra and memcached 256.
SIDE_CONNS = {"r2d2": 4096, "http": 1024, "dns": 1024, "cassandra": 256, "memcache": 256}
SIDE_BASES = {"r2d2": 1_000_000, "http": 2_000_000, "dns": 3_000_000,
              "cassandra": 4_000_000, "memcache": 5_000_000}
# The kernels each protocol's engine runs on the card (r2d2 and DNS also
# the blob lane's K16).
SIDE_KERNELS = {
    "r2d2": ("r2d2_frame", "dfa_scan", "r2d2_hits", "gather_rows"),
    "dns": ("dns_name", "dfa_scan", "dns_hits", "gather_rows"),
    "http": ("http_frame", "http_lit", "http_hits"),
    "cassandra": ("dfa_scan", "cassandra_hits"),
    "memcache": ("dfa_scan", "memcache_hits"),
}
R2D2_CORPUS = (b"READ /public/a.txt\r\n", b"READ /private/x\r\n", b"HALT\r\n",
               b"WRITE /public/b\r\n", b"RESET\r\n", b"READ /public/deep/path/c.dat\r\n")


def sidecar_policies():
    """tests/test_sidecar.py's two-rule r2d2 policy and bench.py's HTTP,
    DNS, Cassandra and memcached policies (``entry.*_bench_policy``), one
    NPDS policy each, pushed together."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.proxylib import NetworkPolicy, PortNetworkPolicy, PortNetworkPolicyRule

    out = [NetworkPolicy(name=SIDE_NAMES["r2d2"], policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
            remote_policies=[1, 3], l7_proto="r2d2",
            l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])])])]
    for proto, make in (("http", entry.http_bench_policy), ("dns", entry.dns_bench_policy),
                        ("cassandra", entry.cassandra_bench_policy),
                        ("memcache", entry.memcache_bench_policy)):
        out.append(dataclasses.replace(make().config, name=SIDE_NAMES[proto]))
    return out


def r2d2_side_rounds(rng, n_conns, n_rounds=3):
    """bench_mixed's mix (bench.py:1556-1562) per conn: 80% whole frames
    (the blob lane), 10% frames split across rounds, 5% pipelined pairs,
    5% reply-direction bytes; remote 9 (denied) on every 7th conn."""
    def frame():
        roll = rng.random()
        if roll < 0.5:
            return b"READ /public/f%d.txt\r\n" % rng.randrange(1000)
        return R2D2_CORPUS[rng.randrange(len(R2D2_CORPUS))]

    rounds = [[] for _ in range(n_rounds)]
    for fid in range(n_conns):
        remote = 9 if fid % 7 == 6 else (1 if fid % 2 else 3)
        kind = fid % 20
        for rnd in range(n_rounds):
            f = frame()
            if kind < 16:
                rounds[rnd].append((fid, f, remote, False))
            elif kind < 18:
                cut = rng.randrange(1, len(f))
                rounds[rnd].append((fid, f[:cut] if rnd % 2 == 0 else f[cut:], remote, False))
            elif kind < 19:
                rounds[rnd].append((fid, f + frame(), remote, False))
            else:
                rounds[rnd].append((fid, b"OK %d\r\n" % rnd if rnd else f, remote, rnd > 0))
    return rounds


def dns_side_rounds(n_conns, n_rounds=4):
    """bench.py:664-705's DNS lane over ``entry.dns_queries()``: whole
    frames, frames split mid-QNAME across round pairs, pipelined pairs."""
    from cilium_tpu_torch.entry import dns_queries

    msgs = dns_queries(64)
    rounds = [[] for _ in range(n_rounds)]
    for rnd in range(n_rounds):
        for fid in range(n_conns):
            f = msgs[(fid + rnd) % len(msgs)]
            if fid % 3 == 0:
                fs = msgs[(fid + rnd // 2) % len(msgs)]
                half = len(fs) // 2
                chunk = fs[:half] if rnd % 2 == 0 else fs[half:]
            elif fid % 3 == 1:
                chunk = f + msgs[(fid + rnd + 1) % len(msgs)]
            else:
                chunk = f
            rounds[rnd].append((fid, chunk, 1, False))
    return rounds


def sidecar_traffic():
    """{proto: (rounds of (conn, bytes, remote, reply), batch group of a conn)}."""
    def req(rounds):
        return [[(fid, chunk, remote, False) for fid, chunk, remote in rnd] for rnd in rounds]

    return {
        "r2d2": (r2d2_side_rounds(random.Random(41), SIDE_CONNS["r2d2"]),
                 lambda fid: int(fid % 20 >= 16)),
        "http": (req(http_sidecar_feeds(random.Random(43), SIDE_CONNS["http"])), lambda fid: 0),
        "dns": (dns_side_rounds(SIDE_CONNS["dns"]), lambda fid: int(fid % 3 != 2)),
        "cassandra": (req(cassandra_engine_feeds(random.Random(47), SIDE_CONNS["cassandra"])),
                      lambda fid: 0),
        "memcache": (req(memcache_engine_feeds(random.Random(53), SIDE_CONNS["memcache"])),
                     lambda fid: 0),
    }


_SIDE_WORLD = []


def side_world():
    """(phase 9's policies, traffic, each protocol's host-oracle rounds),
    made once a run: phases 9 and 19 drive the same traffic."""
    if not _SIDE_WORLD:
        pols, traffic = sidecar_policies(), sidecar_traffic()
        t0 = time.monotonic()
        expect = {p: sidecar_oracle(p, traffic[p][0], pols) for p in traffic}
        log(f"sidecar traffic: " + ", ".join(
            f"{p} {SIDE_CONNS[p]} conns x {len(traffic[p][0])} rounds = {side_frames(e)} frames"
            for p, e in expect.items()) + f"; host oracle {time.monotonic() - t0:.1f} s")
        _SIDE_WORLD.append((pols, traffic, expect))
    return _SIDE_WORLD[0]


def sidecar_oracle(proto, rounds, pols, name=None, port=None, base=None):
    """Each round's {conn: (ops, orig inject, reply inject)} from the port's
    in-process proxylib ``Instance`` on the host, fed as the service's
    buffer mirror feeds it (new bytes appended per direction, the
    unconsumed buffer offered again, bytes a PASS/DROP covered beyond it
    skipped on arrival).  The conns' policy name (or {conn: name}), port
    and id base default to phase 9's for ``proto``."""
    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.proxylib.types import DROP, PASS, FilterResult

    name = SIDE_NAMES[proto] if name is None else name
    port = SIDE_PORTS[proto] if port is None else port
    base = SIDE_BASES[proto] if base is None else base
    mod = inst.open_module([("node-id", f"oracle-{proto}")], False)
    inst.find_instance(mod).policy_update(pols)
    conns, out = {}, []
    for rnd in rounds:
        got = {}
        for fid, chunk, remote, reply in rnd:
            if fid not in conns:
                res, conn = inst.on_new_connection(
                    mod, proto, base + fid, True, remote, 2, "1.1.1.1:1",
                    f"2.2.2.2:{port}", name[fid] if isinstance(name, dict) else name,
                    orig_buf_capacity=1 << 16, reply_buf_capacity=1 << 16,
                )
                if res != FilterResult.OK:
                    raise AssertionError(f"oracle {proto} conn {fid}: {res!r}")
                conns[fid] = [conn, {False: bytearray(), True: bytearray()}, {False: 0, True: 0}]
            conn, bufs, skip = conns[fid]
            take = min(skip[reply], len(chunk))
            skip[reply] -= take
            bufs[reply].extend(chunk[take:])
            ops = []
            if bufs[reply]:
                conn.on_data(reply, False, [bytes(bufs[reply])], ops)
            consumed = 0
            for op, n in ops:
                if op in (PASS, DROP):
                    t = min(n, len(bufs[reply]) - consumed)
                    consumed += t
                    skip[reply] += n - t
            del bufs[reply][:consumed]
            got[fid] = ([(int(o), int(n)) for o, n in ops], conn.orig_buf.take(),
                        conn.reply_buf.take())
        out.append(got)
    for fid in conns:
        inst.close_connection(base + fid)
    inst.close_module(mod)
    return out


class SidecarDriver:
    """One ``SidecarClient`` on a service: opens the conns of a protocol
    and drives its rounds, one DATA batch a round for each batch group (a
    round's batches in flight together), timing each batch's round trip
    on the host clock."""

    def __init__(self, path, transport, pols, base_shift=0):
        from cilium_tpu_torch.proxylib.types import FilterResult
        from cilium_tpu_torch.sidecar import SidecarClient

        self.client = SidecarClient(path, timeout=120.0, transport=transport)
        self.mod = self.client.open_module([])
        if pols is not None and self.client.policy_update(self.mod, pols) != int(FilterResult.OK):
            raise AssertionError("policy_update refused")
        self.shift = base_shift
        self.rtt_ms = []
        self._got = {}
        self._sent = {}
        self._evt = threading.Event()
        self.client.verdict_callback = self._on_verdict

    def _on_verdict(self, vb):
        t = time.perf_counter()
        self._got[vb.seq] = (vb, t)
        self._evt.set()

    def base(self, proto):
        return SIDE_BASES[proto] + self.shift

    def open(self, proto, rounds, names=None):
        """Open the rounds' conns; ``names`` ({conn: policy name}) defaults
        every conn to phase 9's policy for ``proto``."""
        from cilium_tpu_torch.proxylib.types import FilterResult

        seen = {}
        for rnd in rounds:
            for fid, _, remote, _ in rnd:
                seen.setdefault(fid, remote)
        for fid, remote in seen.items():
            res, _ = self.client.new_connection(
                self.mod, proto, self.base(proto) + fid, True, remote, 2, "1.1.1.1:1",
                f"2.2.2.2:{SIDE_PORTS[proto]}", SIDE_NAMES[proto] if names is None else names[fid])
            if res != int(FilterResult.OK):
                raise AssertionError(f"{proto} conn {fid}: result {res}")
        return list(seen)

    def close(self, proto, fids):
        for fid in fids:
            self.client.close_connection(self.base(proto) + fid)

    def run(self, proto, rounds, group):
        from cilium_tpu_torch.sidecar import wire

        base = self.base(proto)
        out = []
        for rnd in rounds:
            batches = {}
            for e in rnd:
                batches.setdefault(group(e[0]), []).append(e)
            seqs = []
            for ents in batches.values():
                seq = next(self.client._seq)
                seqs.append(seq)
                ids = np.array([base + fid for fid, *_ in ents], np.uint64)
                flags = np.array([wire.FLAG_REPLY if r else 0 for *_, r in ents], np.uint8)
                lens = np.array([len(c) for _, c, _, _ in ents], np.uint32)
                blob = b"".join(c for _, c, _, _ in ents)
                self._sent[seq] = time.perf_counter()
                self.client.send_batch(seq, ids, flags, lens, blob)
            deadline = time.monotonic() + 120
            while not all(q in self._got for q in seqs):
                if time.monotonic() > deadline:
                    raise AssertionError(f"{proto}: batches {seqs} unanswered")
                self._evt.wait(0.01)
                self._evt.clear()
            per = {}
            for q in seqs:
                vb, t = self._got.pop(q)
                self.rtt_ms.append((t - self._sent.pop(q)) * 1e3)
                for j in range(vb.count):
                    cid, res, ops, io, ir = vb.entry(j)
                    if res != 0:
                        raise AssertionError(f"{proto} conn {int(cid) - base}: result {res}")
                    o, a, b = per.setdefault(int(cid) - base, ([], b"", b""))
                    per[int(cid) - base] = (o + [(int(x), int(n)) for x, n in ops], a + io, b + ir)
            out.append(per)
        return out

    def close_client(self):
        self.client.close()


def side_mismatches(got, exp):
    """(conn, round) pairs whose ops or injects differ, or that one side
    lacks."""
    bad = 0
    for g, e in zip(got, exp):
        for fid in set(g) | set(e):
            if g.get(fid) != e.get(fid):
                bad += 1
    return bad + abs(len(got) - len(exp))


def side_frames(exp):
    from cilium_tpu_torch.proxylib.types import DROP, PASS

    return sum(1 for rnd in exp for ops, _, _ in rnd.values() for op, _ in ops if op in (PASS, DROP))


def side_config(**kw):
    """The reference's defaults (batch_flows 2,048, batch_width 256, the
    0.5 ms batch window, reasm on) on the card unless ``kw`` says otherwise."""
    from cilium_tpu_torch.utils.option import DaemonConfig

    return DaemonConfig(**kw)


def sidecar_serve(path, cfg, pols, traffic, transports=("socket",), counted=None):
    """Start a service, drive every protocol over each transport, stop it.
    ``counted(phase, proto, svc)`` is called with "start" after every conn
    is open (the engines built and prewarmed) and with "before"/"after"
    around each protocol's drive over the first transport.  Returns (service status, per-transport
    {proto: rounds}, per-transport {proto: drive seconds}, rtts, engines)."""
    from cilium_tpu_torch.sidecar import VerdictService

    svc = VerdictService(path, cfg).start()
    drivers = []
    try:
        for i, tr in enumerate(transports):
            drivers.append(SidecarDriver(path, tr, pols if i == 0 else None, base_shift=100_000 * i))
        opened = [{p: d.open(p, traffic[p][0]) for p in traffic} for d in drivers]
        if counted:
            counted("start", None, svc)
        outs, secs = [], []
        for d in drivers:
            o, s = {}, {}
            for proto, (rounds, group) in traffic.items():
                if counted and d is drivers[0]:
                    counted("before", proto, svc)
                t0 = time.perf_counter()
                o[proto] = d.run(proto, rounds, group)
                s[proto] = time.perf_counter() - t0
                if counted and d is drivers[0]:
                    counted("after", proto, svc)
            outs.append(o)
            secs.append(s)
        status = svc.status()
        engines = {key[-1]: eng for key, eng in svc._engines.items()}
        extra = dict(blob_chunks=svc.blob_chunks, dispatch=svc.dispatch_mode_chosen,
                     measured=getattr(svc, "dispatch_measured", None), svc=svc)
        for d, op in zip(drivers, opened):
            for proto, fids in op.items():
                d.close(proto, fids)
        rtts = [ms for d in drivers for ms in d.rtt_ms]
        return status, outs, secs, rtts, engines, extra
    finally:
        for d in drivers:
            d.close_client()
        svc.stop()


def sidecar_slice(dev, card, kerns):
    """Phase 9: the sidecar verdict service on the card, counted in a run
    of its own.  Returns (launches, runs, report, timed) as the other
    slices do."""
    import tempfile

    from cilium_tpu_torch.models import cassandra as cass_mod
    from cilium_tpu_torch.models import dns as dns_mod
    from cilium_tpu_torch.models import memcached as mc_mod
    from cilium_tpu_torch.ops import gather as gather_mod
    from cilium_tpu_torch.proxylib import instance as inst

    log("== sidecar slice")
    t_phase = time.monotonic()
    kerns = dict(kerns)
    kerns.update(dns_name=dns_mod._DNS_NAME, dns_hits=dns_mod._DNS_HITS,
                 cassandra_hits=cass_mod._CASSANDRA_HITS, memcache_hits=mc_mod._MEMCACHE_HITS,
                 gather_rows=gather_mod._GATHER_ROWS)
    pols, traffic, expect = side_world()
    frames = {p: side_frames(e) for p, e in expect.items()}
    inst.reset_module_registry()
    with tempfile.TemporaryDirectory(prefix="sidecar-", dir=".") as tmp:
        return _sidecar_runs(dev, card, kerns, pols, traffic, expect, frames, tmp, t_phase)


def _sidecar_runs(dev, card, kerns, pols, traffic, expect, frames, tmp, t_phase):
    """The service runs of ``sidecar_slice``, their sockets under ``tmp``."""
    from cilium_tpu_torch.ops import gather as gather_mod

    # 9a. the counted run: eager dispatch, socket then shm.
    per_proto, marks = {}, {}

    def counted(phase, proto, svc):
        if phase == "start":
            for k in kerns.values():
                k.launches = 0
            marks["blob0"] = svc.blob_chunks
            marks["svc"] = svc
            return
        now = {n: k.launches for n, k in kerns.items()}
        if phase == "before":
            marks[proto] = now
        else:
            per_proto[proto] = {n: now[n] - marks[proto][n] for n in now}

    status, outs, secs, rtts, engines, extra = sidecar_serve(
        f"{tmp}/eager.sock", side_config(dispatch_mode="eager"), pols, traffic,
        transports=("socket", "shm"), counted=counted)
    launches = {n: k.launches for n, k in kerns.items()}
    blob_chunks = extra["blob_chunks"] - marks["blob0"]
    for tr, o in zip(("socket", "shm"), outs):
        for proto in traffic:
            bad = side_mismatches(o[proto], expect[proto])
            log(f"sidecar {tr:6s} {proto:9s} vs host oracle: {bad} mismatches "
                f"({len(o[proto])} rounds, {frames[proto]} frames)")
            if bad:
                raise AssertionError(f"sidecar {tr} {proto}: {bad} mismatches against the oracle")
    sessions = status["transport"]["sessions"]
    if sorted(s["mode"] for s in sessions) != ["shm", "socket"] or not status["transport"]["shm_entries"]:
        raise AssertionError(f"transports: {sessions}, shm entries {status['transport']['shm_entries']}")
    # Launches add up: K16 once per blob chunk; each protocol's kernels
    # launched in its own drive and no other protocol's.
    if launches["gather_rows"] != blob_chunks or blob_chunks == 0:
        raise AssertionError(f"K16 launched {launches['gather_rows']} times for {blob_chunks} blob chunks")
    for proto, d in per_proto.items():
        want = set(SIDE_KERNELS[proto])
        missing = [k for k in want if d[k] == 0]
        stray = {k: v for k, v in d.items() if v and k not in want}
        if missing or stray:
            raise AssertionError(f"sidecar {proto}: kernels not launched {missing}, stray {stray}")
        pairs = {"r2d2": ("r2d2_frame", "r2d2_hits"), "dns": ("dns_name", "dns_hits"),
                 "http": ("http_frame", "http_hits")}
        if proto in pairs and d[pairs[proto][0]] != d[pairs[proto][1]]:
            raise AssertionError(f"sidecar {proto}: {pairs[proto]} launched {d}")
        if proto == "http" and d["http_lit"] != d["http_frame"]:
            raise AssertionError(f"sidecar http: {d}")
        log(f"sidecar launches, socket drive of {proto}: " +
            ", ".join(f"{k} {d[k]}" for k in SIDE_KERNELS[proto]))
    log(f"sidecar counted run: K16 {launches['gather_rows']} launches = {blob_chunks} blob chunks; "
        f"totals {launches}")
    # Nothing silently fell back.
    cont, devst = status["containment"], status["device"]
    if (cont["quarantined"] or cont["batch_crashes"] or cont["error_entries"] or cont["shed_entries"]
            or cont["refused_entries"] or cont["readback_failures"]):
        raise AssertionError(f"sidecar containment tripped: {cont} {devst}")
    if not status["reasm"]["rounds_by_framing"].get("dns"):
        raise AssertionError(f"dns columnar lane never engaged: {status['reasm']}")
    log(f"sidecar reasm rounds by framing {status['reasm']['rounds_by_framing']}, "
        f"vec batches {marks['svc'].vec_batches}, fast-path requests {marks['svc'].fast_log.requests}, "
        f"guard {cont['quarantined']}, judged on the device {devst['device_judged']}, "
        f"by the host oracle {devst['host_judged']}")

    # 9b. the same traffic at verdict_device="cpu" (socket only).
    cpu_status, cpu_outs, _, _, cpu_engines, _ = sidecar_serve(
        f"{tmp}/cpu.sock", side_config(verdict_device="cpu"), pols, traffic)
    for proto in traffic:
        bad = side_mismatches(outs[0][proto], cpu_outs[0][proto])
        if bad:
            raise AssertionError(f"sidecar {proto}: card and CPU service differ in {bad} places")
    for proto in ("http", "cassandra", "memcache"):
        got = (engines[proto].device_judged, engines[proto].host_judged)
        want = (cpu_engines[proto].device_judged, cpu_engines[proto].host_judged)
        # Two transports drove the card's engines: the CPU's counts twice.
        if got != (2 * want[0], 2 * want[1]) or want[0] == 0:
            raise AssertionError(f"sidecar {proto}: judged on the device/host {got}, CPU {want}")
        log(f"sidecar {proto}: frames judged on the device {got[0]}, by the host oracle {got[1]} "
            f"(overflow and peek-horizon frames; the CPU service: {want[0]} / {want[1]} per transport)")
    log("sidecar card service == CPU service: 0 mismatches on every protocol")

    # 9c. CUDA graphs ("jit") against eager, and "auto" resolving by measurement.
    # Two drives on fresh conns: shapes prewarm does not cover (the
    # columnar lane's widths, the HTTP judge's buckets) are captured at
    # first use in the first; the second runs on warm graphs.
    # Graph replays launch the kernels without their wrappers: each
    # replay adds the launches its graph captured to ``replayed``, so
    # K16's replays must equal this run's blob chunks.
    cap0 = {n: k.captured for n, k in kerns.items()}
    jit_marks = {}

    def jit_counted(phase, proto, svc):
        if phase == "start":
            jit_marks["replayed"] = {n: k.replayed for n, k in kerns.items()}
            jit_marks["blob0"] = svc.blob_chunks

    jit_status, jit_outs, jit_secs, _, _, jit_extra = sidecar_serve(
        f"{tmp}/jit.sock", side_config(dispatch_mode="jit"), pols, traffic,
        transports=("socket", "socket"), counted=jit_counted)
    replayed = {n: k.replayed - jit_marks["replayed"][n] for n, k in kerns.items()}
    jit_chunks = jit_extra["blob_chunks"] - jit_marks["blob0"]
    if replayed["gather_rows"] != jit_chunks or jit_chunks == 0:
        raise AssertionError(f"jit: K16 replayed {replayed['gather_rows']} times for {jit_chunks} blob chunks")
    for proto in ("r2d2", "dns"):
        idle = [k for k in SIDE_KERNELS[proto] if not replayed[k]]
        if idle:
            raise AssertionError(f"jit {proto}: kernels never replayed from a graph: {idle}")
    for proto in traffic:
        bad = sum(side_mismatches(o[proto], outs[0][proto]) for o in jit_outs)
        if bad:
            raise AssertionError(f"sidecar {proto}: graphs and eager differ in {bad} places")
    led = jit_status["ledger"]
    log(f"sidecar jit ledger: {led['compiles']} compiles ({led['by_cause']}), "
        f"{led['dispatch_path_compiles']} of them captured on the dispatch path, "
        f"{led['compile_seconds']:.3f} s in all")
    graphs = jit_status["device"]["graphs"]
    captured = {n: k.captured - cap0[n] for n, k in kerns.items() if k.captured - cap0[n]}
    if jit_status["dispatch_mode"] != "jit" or not graphs["captures"] or not graphs["replays"] \
            or not captured.get("gather_rows"):
        raise AssertionError(f"jit service: {jit_status['dispatch_mode']} {graphs} {captured}")
    log(f"sidecar jit (CUDA graphs) == eager: 0 mismatches; {graphs['captures']} graphs captured, "
        f"{graphs['replays']} replays; kernels captured {captured}; launches replayed from graphs "
        f"after the conns opened {({n: v for n, v in replayed.items() if v})}, K16 "
        f"{replayed['gather_rows']} = {jit_chunks} blob chunks")
    auto_traffic = {"r2d2": traffic["r2d2"]}
    auto_status, auto_outs, _, _, _, auto_extra = sidecar_serve(
        f"{tmp}/auto.sock", side_config(dispatch_mode="auto"), pols, auto_traffic)
    if auto_status["dispatch_mode"] not in ("eager", "jit") or not auto_extra["measured"]:
        raise AssertionError(f"auto did not resolve by measurement: {auto_status['dispatch_mode']}")
    if side_mismatches(auto_outs[0]["r2d2"], outs[0]["r2d2"]):
        raise AssertionError("sidecar auto: ops differ from eager")
    m = auto_extra["measured"]
    log(f"sidecar auto: 8 issues + readback, eager {m['eager_ms']:.3f} ms, graphs "
        f"{m['jit_ms']:.3f} ms -> {auto_status['dispatch_mode']} [{card}]")

    # 9d. numbers, each with the card line.
    for proto in traffic:
        rates = ", ".join(f"{name} {frames[proto] / t[proto]:.0f}" for name, t in (
            ("eager socket", secs[0]), ("eager shm", secs[1]), ("graphs first", jit_secs[0]),
            ("graphs warm", jit_secs[1])))
        log(f"sidecar {proto}: {frames[proto]} frames; frames/s {rates} (host clock) [{card}]")
    r = np.array(rtts)
    log(f"sidecar batch round trip (eager, socket and shm, {len(r)} batches of the drives): p50 "
        f"{np.percentile(r, 50):.3f} ms, p99 {np.percentile(r, 99):.3f} ms (host clock) [{card}]")
    seam = sidecar_latency(f"{tmp}/lat.sock", pols, card)
    idle = sidecar_idle(f"{tmp}/idle.sock", pols, traffic, card)

    # 9e. K16 against its plain version on the card, at the main path's
    # shapes (the whole-frame batch of round 0, cut as _issue_chunks_blob
    # cuts it, and the seam services' largest bucket, the 64 KiB window
    # of latbench's corpus: 3,180 messages padded to 4,096 x 64), and
    # timed; given --baseline-csrc, in turns with the parent's.
    report, timed = {"gather_rows": {}}, {}
    r2d2_rounds, r2d2_group = traffic["r2d2"]
    whole = [c for fid, c, _, _ in r2d2_rounds[0] if r2d2_group(fid) == 0]
    shapes = {"sidecar-512": (side_blob_chunk(whole, 512), 256),
              "sidecar": (side_blob_chunk(whole, 2048), 256),
              "sidecar-4096x64": (seam_blob_chunk(4096), 64)}
    for shape, ((blob, offs, lens), width) in shapes.items():
        b, o, ln = (torch.from_numpy(a).to(dev) for a in (blob, offs, lens))
        f_pad = o.shape[0]
        got = gather_mod.gather_rows(b, o, ln, width)
        want = gather_mod.gather_rows_plain(b, o, ln, width)
        err = max_abs_err([got], [want])
        report["gather_rows"][shape] = err
        edge_o = o.clone()
        edge_l = ln.clone()
        edge_o[:6] = torch.tensor([65535, 65530, 0, 3, 65536 - width, -17], dtype=torch.int32)
        edge_l[:6] = torch.tensor([width, width + 44, 0, -1, width, width], dtype=torch.int32)
        err_e = max_abs_err([gather_mod.gather_rows(b, edge_o, edge_l, width)],
                            [gather_mod.gather_rows_plain(b, edge_o, edge_l, width)])
        report["gather_rows"][f"{shape}-edges"] = err_e
        if err or err_e:
            raise AssertionError(f"K16 differs from its plain version at {shape}: {err} / {err_e}")
        col = torch.arange(width, device=dev)[None, :]
        g = (o.long()[:, None] + col).clamp(0, 65535)
        covered = torch.zeros(65536, dtype=torch.bool, device=dev)
        covered[g[col < ln.long()[:, None]]] = True
        row = dict(
            ms=graph_ms(lambda: gather_mod.gather_rows(b, o, ln, width)),
            call_ms=cuda_ms(lambda: gather_mod.gather_rows(b, o, ln, width), 50),
            plain_ms=cuda_ms(lambda: gather_mod.gather_rows_plain(b, o, ln, width), 20),
            library_ms=cuda_ms(lambda: b[g], 50),
            bytes=f_pad * width + int(covered.sum()) + 8 * f_pad, ops=0,
        )
        bound(row)
        parent_turns("gather_rows", lambda: gather_mod.gather_rows(b, o, ln, width), row)
        timed[shape] = {"rows": {"gather_rows": row}}
        log_row(shape, "gather_rows", row)
        log(f"{shape:15s} gather_rows library blob[g] (one advanced-indexing call, no mask) "
            f"{row['library_ms']:.5f} ms [{card}]")
    runs = {"sidecar": launches, "sidecar-512": launches, "sidecar-4096x64": launches}
    log(f"sidecar slice: {time.monotonic() - t_phase:.1f} s; seam p50/p99 {seam}; idle share {idle}")
    return launches, runs, report, timed


def seam_blob_chunk(f_pad, blob_len=65536):
    """The first blob chunk the seam services cut from latbench's corpus
    at bucket ``f_pad`` (``side_blob_chunk`` of its messages): at 4,096
    the 64 KiB window's 3,180 messages, the largest chunk they send."""
    from cilium_tpu_torch.sidecar import latbench

    return side_blob_chunk(latbench._corpus(f_pad)[0], f_pad, blob_len)


def side_blob_chunk(frames, f_pad, blob_len=65536):
    """The first chunk ``_issue_chunks_blob`` cuts from whole frames: the
    flow cap ``f_pad`` and the 65,536-byte window, padded to ``f_pad``."""
    offs, lens, blob, n = [], [], bytearray(), 0
    for f in frames:
        if n == f_pad or len(blob) + len(f) > blob_len:
            break
        offs.append(len(blob))
        lens.append(len(f))
        blob += f
        n += 1
    o = np.zeros(f_pad, np.int32)
    ln = np.zeros(f_pad, np.int32)
    o[:n], ln[:n] = offs, lens
    bp = np.zeros(blob_len, np.uint8)
    bp[: len(blob)] = np.frombuffer(bytes(blob), np.uint8)
    return bp, o, ln


def sidecar_latency(path, pols, card, n_batches=400, per_batch=64):
    """Round trip of one whole-frame r2d2 batch at a time (the blob lane),
    on the host clock: p50 and p99 over ``n_batches`` batches."""
    from cilium_tpu_torch.sidecar import VerdictService

    svc = VerdictService(path, side_config(dispatch_mode="eager")).start()
    d = None
    try:
        d = SidecarDriver(path, "socket", pols, base_shift=900_000)
        rounds = [[(i % 4096, R2D2_CORPUS[(i + k) % 3], 1, False) for i in range(per_batch)]
                  for k in range(n_batches)]
        fids = d.open("r2d2", rounds)
        d.run("r2d2", rounds[:20], lambda fid: 0)  # warm
        d.rtt_ms.clear()
        d.run("r2d2", rounds, lambda fid: 0)
        r = np.array(d.rtt_ms)
        d.close("r2d2", fids)
    finally:
        if d is not None:
            d.close_client()
        svc.stop()
    out = (float(np.percentile(r, 50)), float(np.percentile(r, 99)))
    log(f"sidecar seam round trip, {n_batches} sequential batches of {per_batch} whole r2d2 frames "
        f"(eager, socket): p50 {out[0]:.3f} ms, p99 {out[1]:.3f} ms (host clock) [{card}]")
    return out


def sidecar_idle(path, pols, traffic, card):
    """The device's idle share over the r2d2 and DNS drives, from the
    profiler's device time against the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from cilium_tpu_torch.sidecar import VerdictService

    sub = {p: traffic[p] for p in ("r2d2", "dns")}
    svc = VerdictService(path, side_config(dispatch_mode="eager")).start()
    d = None
    try:
        d = SidecarDriver(path, "socket", pols, base_shift=800_000)
        opened = {p: d.open(p, sub[p][0]) for p in sub}
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        try:
            prof.start()
        except RuntimeError as err:
            log(f"sidecar idle share: not measured ({err})")
            return None
        try:
            t0 = time.perf_counter()
            for p, (rounds, group) in sub.items():
                d.run(p, rounds, group)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            prof.stop()
        for p, fids in opened.items():
            d.close(p, fids)
    finally:
        if d is not None:
            d.close_client()
        svc.stop()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    share = 1 - busy / wall_us
    log(f"sidecar r2d2 + dns drives under the profiler: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {share:.4f} [{card}]")
    return share


# --- phase 10: Kafka -----------------------------------------------------------


def _kstr(s):
    b = s.encode()
    return len(b).to_bytes(2, "big", signed=True) + b


def _kframe(api_key, version, cid, client, body):
    payload = (api_key.to_bytes(2, "big", signed=True) + version.to_bytes(2, "big", signed=True)
               + cid.to_bytes(4, "big", signed=True) + _kstr(client) + body)
    return len(payload).to_bytes(4, "big", signed=True) + payload


def _kint32(*vals):
    return b"".join(int(v).to_bytes(4, "big", signed=True) for v in vals)


def kafka_frame(rng, topics, cid, kind=None):
    """One request frame of tests/test_kafka.py's fuzz mix: produce (kind
    0), fetch (1) or metadata (2) over ``topics``, or a header-only
    heartbeat (3); ``kind`` None draws one."""
    client = rng.choice(["producer-1", "consumer-1", "admin", ""])
    version = rng.randrange(0, 3)
    kind = rng.randrange(4) if kind is None else kind
    if kind == 0:
        body = (1).to_bytes(2, "big") + _kint32(1000, len(topics))
        body += b"".join(_kstr(t) + _kint32(1, 0, 4) + b"recs" for t in topics)
        return _kframe(0, version, cid, client, body)
    if kind == 1:
        body = _kint32(-1, 100, 1, len(topics))
        body += b"".join(_kstr(t) + _kint32(1, 0, 0, 0, 1048576) for t in topics)
        return _kframe(1, version, cid, client, body)
    if kind == 2:
        return _kframe(3, version, cid, client, _kint32(len(topics)) + b"".join(_kstr(t) for t in topics))
    return _kframe(12, 0, cid, client, b"\x00\x00")


KAFKA_POOL = ["a", "b", "c", "events", "logs"] + [f"t{i}" for i in range(7)]
# tests/test_kafka.py's seven fuzz rule sets (test_fuzz_matches_host_oracle)
KAFKA_FUZZ_RULES = [
    [{}],
    [{"topic": "a"}, {"topic": "b"}],
    [{"role": "produce", "topic": "events"}],
    [{"role": "consume"}],
    [{"api_version": "2", "topic": "a"}],
    [{"client_id": "producer-1"}],
    [{"topic": "a", "client_id": "consumer-1"}, {"topic": "logs"}],
]


def kafka_fuzz_requests(rng, n):
    """``n`` parsed requests: the fuzz mix with 0-9 distinct topics (9 is
    past MAX_TOPICS: overflow), and one in five a header-only request with
    an api key in [0, 70] (64 and above: overflow)."""
    from cilium_tpu_torch.kafka import parse_request
    from cilium_tpu_torch.kafka.request import RequestMessage

    reqs = []
    for i in range(n):
        if rng.random() < 0.2:
            reqs.append(RequestMessage(api_key=rng.randrange(0, 71), api_version=rng.randrange(0, 3),
                                       correlation_id=i, client_id=rng.choice(["admin", ""]),
                                       topics=[], parsed=False))
        else:
            topics = rng.sample(KAFKA_POOL, k=rng.randrange(0, 10))
            reqs.append(parse_request(kafka_frame(rng, topics, i)))
    return reqs


def _krules(kws):
    from cilium_tpu_torch.policy.api import PortRuleKafka

    out = []
    for kw in kws:
        r = PortRuleKafka(**kw)
        r.sanitize()
        out.append(r)
    return out


def kafka_engine_rows():
    """(remote set, rule) rows of the engine drive: fuzz rule set 7 with
    its first row behind remotes {1, 2}, the produce role on ``events``
    behind remote 3, and any-remote rules on t0-t11 so overflow requests
    (9-10 topics) can be allowed by the host."""
    rules = _krules([{"topic": "a", "client_id": "consumer-1"}, {"topic": "logs"},
                     {"role": "produce", "topic": "events"}]
                    + [{"topic": f"t{i}"} for i in range(12)])
    sets = [frozenset({1, 2}), frozenset(), frozenset({3})] + [frozenset()] * 12
    return list(zip(sets, rules))


def kafka_engine_feeds(rng, n_flows):
    """3 rounds of (flow, bytes, remote) for ``n_flows`` flows: whole
    frames, frames split across rounds, pipelined pairs; every 50th flow
    opens with a framing error (a negative length) and every 20th sends a
    request of 9-10 topics (overflow)."""
    rounds = [[], [], []]
    for fid in range(1, n_flows + 1):
        remote = rng.randrange(1, 5)
        if fid % 50 == 0:
            rounds[0].append((fid, (-5).to_bytes(4, "big", signed=True) + b"garbage", remote))
            rounds[1].append((fid, kafka_frame(rng, ["a"], fid), remote))
            continue
        if fid % 20 == 0:
            topics = [f"t{i}" for i in rng.sample(range(12), k=rng.randrange(9, 11))]
            if rng.random() < 0.5:
                topics[-1] = "secret"
            frames = [kafka_frame(rng, topics, fid, kind=0)]
        else:
            frames = [kafka_frame(rng, rng.sample(KAFKA_POOL, k=rng.randrange(0, 4)), fid)
                      for _ in range(rng.choice([1, 1, 2]))]
        stream = b"".join(frames)
        mode = rng.randrange(3)
        if mode == 0:
            rounds[0].append((fid, stream, remote))
        else:
            cuts = sorted(rng.sample(range(1, len(stream)), k=min(mode, len(stream) - 1)))
            parts = [stream[a:b] for a, b in zip([0, *cuts], [*cuts, len(stream)])]
            for rnd, part in zip(rounds, parts):
                rnd.append((fid, part, remote))
    return rounds


def kafka_oracle(rows, rounds, inject_capacity=4096):
    """The rounds judged by ``matches_rule`` frame by frame, in the engines'
    (flow, ops, inject) shape: PASS or DROP with the error response per
    frame, a framing error drops the buffer and every later byte, a frame
    that does not parse drops, MORE where bytes wait."""
    from cilium_tpu_torch.kafka import matches_rule, parse_request
    from cilium_tpu_torch.kafka.request import KafkaParseError, frame_length

    bufs, closed, out = {}, set(), []
    for rnd in rounds:
        for fid, chunk, _ in rnd:
            bufs.setdefault(fid, bytearray()).extend(chunk)
        for fid, _, remote in rnd:
            buf, ops, inject = bufs[fid], [], bytearray()
            while buf:
                if fid in closed:
                    ops.append((2, len(buf)))
                    buf.clear()
                    break
                try:
                    n = frame_length(bytes(buf))
                except KafkaParseError:
                    closed.add(fid)
                    ops.append((2, len(buf)))
                    buf.clear()
                    break
                if n is None or len(buf) < n:
                    break
                try:
                    req = parse_request(bytes(buf[:n]))
                except KafkaParseError:
                    ops.append((2, n))
                else:
                    rules = [r for rs, r in rows if not rs or remote in rs]
                    if matches_rule(req, rules):
                        ops.append((1, n))
                    else:
                        ops.append((2, n))
                        inject += req.create_response().raw[: max(inject_capacity - len(inject), 0)]
                del buf[:n]
            if buf:
                ops.append((0, 1))
            out.append((fid, ops, bytes(inject)))
    return out


class _CountedModel:
    """A model wrapper that counts the engine's device steps."""

    def __init__(self, model):
        self.model = model
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return self.model(*args)


def kafka_bound(model, b, rem):
    """(bytes, ops) K17 needs on this batch: seven [F] columns, the [F]
    output, the topic lengths of active slots and the bytes of those
    whose length some topic rule shares, the client bytes of parsed rows
    whose length some client rule shares, and the tables once; 4 gate ops
    and 32 remote compares (where the row has a remote set) per rule row
    the walk visits before the verdict settles, one length compare per
    (active topic, topic rule) where the row's gates hold and one per
    byte compared where the lengths are equal."""
    from cilium_tpu_torch.models.base import remote_ok
    from cilium_tpu_torch.models.kafka import FIND_COORDINATOR_KEY

    f, t_n, width = b.topics.shape
    r = model.n_rules
    tc = b.topic_count.long()
    active = torch.arange(t_n, device=rem.device)[None, :] < tc[:, None]  # [F, T]
    topic_rule = ~model.topic_any
    t_match = (b.topic_len[:, :, None] == model.topic_len[None, None, :]) & topic_rule[None, None, :]
    c_need = b.parsed & ((b.client_len[:, None] == model.client_len[None, :])
                         & ~model.client_any[None, :]).any(dim=1)
    nbytes = (23 * f + 4 * int(tc.clamp(0, t_n).sum())
              + int((b.topic_len * (active & t_match.any(dim=2))).sum())
              + int((b.client_len * c_need).sum())
              + r * (64 + 4 + 1 + 64 + 4 + 1 + 256 + 4 + 1 + 128 + 1) + 64)
    # the walk's early exit: each rule row's key, version, request-type
    # and remote gates (the plain version's, kafka_rule_hits)
    key = b.api_key.clamp(0, 63).long()
    in_range = (b.api_key >= 0) & (b.api_key < 64)
    client_eq = (b.client_len[:, None] == model.client_len[None, :]) & (
        b.client[:, None, :] == model.client[None, :, :]).all(dim=-1)
    nil_reject = topic_rule[None, :] & (model.is_topic_key[key] & in_range)[:, None]
    extra = torch.where(b.parsed[:, None], model.client_any[None, :] | client_eq,
                        (b.api_key == FIND_COORDINATOR_KEY)[:, None] | ~nil_reject)
    extra |= (model.topic_any & model.client_any)[None, :]
    base = (model.api_key_mask.T[key] & in_range[:, None]
            & (model.version_any[None, :] | (model.version[None, :] == b.api_version[:, None]))
            & extra & remote_ok(rem, model.remote_ids, model.any_remote))
    simple = (base & (model.topic_any[None, :] | (tc == 0)[:, None])).to(torch.int32).cummax(dim=1).values
    t_eq = t_match & (b.topics[:, :, None, :] == model.topic[None, None, :, :width]).all(dim=-1)
    cover = (t_eq & base[:, None, :]).to(torch.int32).cummax(dim=2).values.bool()
    done = simple.bool() | ((cover | ~active[:, :, None]).all(dim=1) & (tc > 0)[:, None])
    first = torch.where(done.any(dim=1), torch.argmax(done.to(torch.int32), dim=1) + 1,
                        torch.full_like(tc, r))
    visited = torch.arange(r, device=rem.device)[None, :] < first[:, None]  # [F, R]
    ops = int((visited * (4 + 32 * (~model.any_remote).to(torch.int64))[None, :]).sum())
    cmp = (visited & base)[:, None, :] & active[:, :, None] & topic_rule[None, None, :]
    ops += int(cmp.sum()) + int(((cmp & t_match) * b.topic_len[:, :, None]).sum())
    return nbytes, ops


def kafka_slice(dev, card, kerns):
    """Phase 10, Kafka on the card, counted in a run of its own: bench_kafka's
    shape (F = 65,536, 2 rules, W = 32), the fuzz mix against
    tests/test_kafka.py's seven rule sets (F = 65,536, overflow rows
    included) and ``KafkaBatchEngine`` on 2,048 flows over 3 rounds.  The
    card is held against the CPU path, ``matches_rule`` on 4,096 rows a
    shape, the CPU engine and the oracle, and K17 against its plain
    version; then timed.  Returns (launches, runs, report, timed)."""
    from cilium_tpu_torch.kafka import matches_rule
    from cilium_tpu_torch.models.kafka import (
        build_kafka_model,
        kafka_hits,
        kafka_rule_hits,
        kafka_verdicts,
        kafka_verdicts_plain,
    )
    from cilium_tpu_torch.runtime.engines import KafkaBatchEngine

    log("== Kafka slice")
    t_phase = time.monotonic()
    cases = kafka_cases()
    fuzz_batch = cases["kafka-fuzz-1"]["batch"]
    for name, c in cases.items():
        c["model"] = build_kafka_model(c["rows"])
        c["cpu_model"] = build_kafka_model(c["rows"], device="cpu")
        c["dev"] = c["batch"].to_device(dev)
        c["rem"] = torch.from_numpy(c["remotes"]).to(dev)
        b = c["batch"]
        log(f"{name}: F={F} W={b.topics.shape[2]} R={c['model'].n_rules} overflow rows "
            f"{int(b.overflow.sum())} topic counts {np.bincount(b.topic_count, minlength=9).tolist()}")
    if cases["kafka"]["batch"].overflow.any() or not fuzz_batch.overflow.any():
        raise AssertionError("kafka: bench's batch must not overflow and the fuzz batch must")
    eng_rows = kafka_engine_rows()
    feeds = kafka_engine_feeds(random.Random(19), 2048)

    # the main path, counted
    log("== Kafka main path (counted)")

    def counts():
        return {n: k.launches for n, k in kerns.items()}

    def delta(before):
        return {n: k.launches - before[n] for n, k in kerns.items()}

    for k in kerns.values():
        k.launches = 0
    runs, outs = {}, {}
    for name, c in cases.items():
        before = counts()
        outs[name] = kafka_verdicts(c["model"], c["batch"], c["remotes"])
        runs[name] = delta(before)
    counted_model = _CountedModel(build_kafka_model(eng_rows))
    before = counts()
    eng_card = run_l7_engine(lambda: KafkaBatchEngine(counted_model, host_rows=eng_rows), feeds)[0]
    runs["kafka-engine"] = delta(before)
    torch.cuda.synchronize()
    launches = counts()
    log("launches:", json.dumps({n: v for n, v in launches.items() if v}))
    log("launches by run:", json.dumps({n: {k: v for k, v in r.items() if v} for n, r in runs.items()}))
    for n, count in launches.items():
        if sum(r[n] for r in runs.values()) != count:
            raise AssertionError(f"{n}: the runs' launches do not add up to the main path's")
    for name in cases:
        want = dict.fromkeys(kerns, 0)
        want["kafka_hits"] = 1
        if runs[name] != want:
            raise AssertionError(f"{name}: launches {runs[name]} != {want}")
    want = dict.fromkeys(kerns, 0)
    want["kafka_hits"] = counted_model.calls
    if not counted_model.calls or runs["kafka-engine"] != want:
        raise AssertionError(f"kafka-engine: launches {runs['kafka-engine']} != its "
                             f"{counted_model.calls} device steps")

    # the model against the CPU path and the host oracle
    log("== Kafka model")
    for name, c in cases.items():
        got = outs[name]
        if got.device.type != dev.type:
            raise AssertionError(f"{name}: output not on the card")
        host = got.cpu().numpy()
        n = len(c["reqs"])
        if not (host == np.resize(host[:n], F)).all():
            raise AssertionError(f"{name}: rows of one request disagree")
        want = kafka_verdicts(c["cpu_model"], c["batch"], c["remotes"]).numpy()
        if not (host == want).all():
            raise AssertionError(f"{name}: card != CPU on {int((host != want).sum())} rows")
        sample = min(F, 4096)  # row i holds request i % n
        over = c["batch"].overflow
        oracle = [matches_rule(c["reqs"][i % n], [r for _, r in c["rows"]]) and not over[i]
                  for i in range(sample)]
        bad = sum(1 for i in range(sample) if bool(host[i]) != oracle[i])
        if bad:
            raise AssertionError(f"{name}: {bad} of {sample} verdicts disagree with matches_rule")
        log(f"{name}: card == cpu on {F} rows, == matches_rule on {sample} rows (overflow denied), "
            f"allow share {float(host.mean()):.3f}")

    log("== Kafka engine")
    cpu_out = run_l7_engine(lambda: KafkaBatchEngine(build_kafka_model(eng_rows, device="cpu"),
                                                     host_rows=eng_rows), feeds)[0]
    oracle_out = kafka_oracle(eng_rows, feeds)
    for other, label in ((cpu_out, "the CPU engine"), (oracle_out, "the matches_rule oracle")):
        if eng_card != other:
            raise AssertionError(f"kafka-engine: ops differ from {label}: {_first_diff(eng_card, other)}")
    n_ops = sum(len(ops) for _, ops, _ in eng_card)
    n_drop = sum(1 for _, ops, _ in eng_card for op, _ in ops if op == 2)
    n_inject = sum(len(inj) for _, _, inj in eng_card)
    if not n_drop or not n_inject:
        raise AssertionError("kafka-engine: the traffic has no denial")
    log(f"kafka-engine: {len(feeds[0])} flows x 3 rounds, {n_ops} ops ({n_drop} DROP, {n_inject} inject "
        f"bytes), {counted_model.calls} device steps, equal on card, CPU and the oracle")

    # K17 against its plain version at the main path's inputs
    log("== K17 vs plain")
    report = {"kafka_hits": {}}
    for name, c in cases.items():
        allow, simple, cover = kafka_hits(c["model"], c["dev"], c["rem"], parts=True)
        want = kafka_verdicts_plain(c["model"], c["dev"], c["rem"])
        report["kafka_hits"][name] = max_abs_err(
            [kafka_hits(c["model"], c["dev"], c["rem"]), allow, simple, cover],
            [want, want, *kafka_rule_hits(c["model"], c["dev"], c["rem"])])
    log("max |kernel - plain|:", json.dumps(report))
    if any(report["kafka_hits"].values()):
        raise AssertionError("K17 disagrees with its plain version")

    # times
    log("== Kafka times on", card)
    timed = {}
    for name, c in cases.items():
        model, b, rem = c["model"], c["dev"], c["rem"]
        row = k17_row(model, b, rem)
        nb = c["batch"]
        on_card = lambda: (kafka_hits(model, b, rem),)  # noqa: E731
        timed[name] = dict(rows={"kafka_hits": row}, **pass_times(
            on_card, lambda: (kafka_verdicts(model, nb, c["remotes"]),)))
        log_row(name, "kafka_hits", row)
        log_pass(name, "kafka_verdicts", timed[name], card, parent_turns("kafka_hits", on_card, {}))
    # K17 at the engine's largest step, its inputs recorded
    label, e_model, e_b, e_rem, _ = kafka_engine_shape(dev)
    timed[label] = dict(rows={"kafka_hits": k17_row(e_model, e_b, e_rem)})
    log(f"{label}: K17 at F={e_b.api_key.shape[0]} W={e_b.topics.shape[2]} R={e_model.n_rules}")
    log_row(label, "kafka_hits", timed[label]["rows"]["kafka_hits"])
    frames = sum(1 for _, ops, _ in eng_card for op, _ in ops if op in (1, 2))
    engine_times(f"kafka-engine: {frames} frames of {len(feeds[0])} flows", frames, card,
                 lambda: run_l7_engine(lambda: KafkaBatchEngine(build_kafka_model(eng_rows),
                                                                host_rows=eng_rows), feeds))
    log(f"Kafka slice: {time.monotonic() - t_phase:.1f} s")
    return launches, runs, report, timed


# --- phase 11: long-frame sequence folding (seqdfa) ----------------------------

SEQ_CHUNKS = (1, 8, 64)
# (shape, flows, width): the engines' capacity at the HTTP engine's
# MAX_WIDTH, and a narrower batch the plain version can follow quickly
SEQ_SHAPES = (("seqdfa-32k", 2048, 32768), ("seqdfa-4k", 256, 4096))
# The adversarial shape: counters modulo 13 and 11 on frames of their one
# byte, so no two start states of a group merge and K18's fold runs its
# slow branch (one thread a live start state) everywhere.
SEQ_ADV = ("seqdfa-32k-adv", 2048, 32768, (1, 64))
SEQ_ADV_PATTERNS = ("^(a{13})*b", "^(a{11})*c")
# The parent's kernels (a parent checkout's csrc, --baseline-csrc): for each
# source that differs from the parent's, {symbol: the parent's C launcher
# bound with the current wrapper's argtypes}; empty without the flag.
BASELINE: dict = {}
# The kernels of each verdict pass: a pass runs in turns with the parent's
# versions of those whose sources differ (parent_turns keeps those in
# BASELINE).
R2D2_PASS = ("r2d2_frame", "dfa_scan", "nfa_scan", "r2d2_hits")
HTTP_PASS = ("http_frame", "http_lit", "dfa_scan", "nfa_scan", "http_hits")
DNS_PASS = ("dns_name", "dfa_scan", "nfa_scan", "dns_hits")
PASS_KERNELS = {"dns": DNS_PASS, "cassandra": ("dfa_scan", "nfa_scan", "cassandra_hits"),
                "memcached": ("dfa_scan", "nfa_scan", "memcache_hits")}


def seqdfa_adv_batch(f, width):
    """Frames of 'a' with lengths near the width; each ends in 'b' (even
    flows) or 'c' (odd), so the counters accept where the count fits."""
    lengths = (width - (np.arange(f) * 7919) % 97).astype(np.int32)
    data = np.full((f, width), ord("a"), np.uint8)
    data[np.arange(f), lengths - 1] = np.where(np.arange(f) % 2 == 0, ord("b"), ord("c"))
    data[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return data, lengths


def build_baseline(csrc):
    """Build each ``<stem>.cu`` that differs from ``csrc``'s (the parent's
    sources; a source differs when its text or a header it includes does)
    from ``csrc`` into _build/baseline, one ``nvcc`` each, together, and
    bind every launcher of those sources with the current ``CudaKernel``'s
    argtypes: their C interfaces must be the parent's, so that the
    wrappers' own argument packing drives both (``parent_kernels`` swaps
    them in).  Returns the stems."""
    import ctypes
    import re
    from pathlib import Path

    from cilium_tpu_torch import kernels

    # every module that defines a kernel, so that each source's launchers
    # are in kernels.ALL before they are bound
    every_kernel()
    csrc = Path(csrc).resolve()

    def read_or_none(path):
        return path.read_bytes() if path.exists() else None

    stems = []
    for src in kernels.sources():
        deps, todo = set(), [src.name]
        while todo:  # the source and the headers it includes, transitively
            name = todo.pop()
            if name not in deps and (kernels.CSRC / name).exists():
                deps.add(name)
                todo += re.findall(r'#include "([^"]+)"', (kernels.CSRC / name).read_text())
        if any(read_or_none(kernels.CSRC / d) != read_or_none(csrc / d) for d in deps):
            stems.append(src.stem)
    out = kernels.BUILD / "baseline"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in stems:
        cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-o", str(out / f"{stem}.so"),
               str(csrc / f"{stem}.cu")]
        procs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for stem, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"baseline {stem}.cu failed to build:\n{text}")
        lib = ctypes.CDLL(str(out / f"{stem}.so"))
        bound = {}
        for k in kernels.ALL:
            # a launcher the parent lacks (a forced-variant export) is
            # not swapped
            if k.stem == stem and hasattr(lib, k.symbol):
                fn = getattr(lib, k.symbol)
                fn.argtypes = [*k.argtypes, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                bound[k.symbol] = fn
        if not bound:
            raise RuntimeError(f"baseline {stem}: no kernel of the port has that source")
        BASELINE[stem] = bound
    BASELINE["csrc"] = str(csrc)
    return stems


class parent_kernels:
    """Inside ``with parent_kernels(stems)``, the wrappers of those sources
    launch the parent's kernels (``BASELINE``) with their own arguments."""

    def __init__(self, stems):
        from cilium_tpu_torch import kernels

        self.held = [(k, BASELINE[k.stem][k.symbol]) for k in kernels.ALL
                     if k.stem in stems and k.symbol in BASELINE[k.stem]]

    def __enter__(self):
        self.own = [(k, k._bind()) for k, _ in self.held]
        for k, fn in self.held:
            k._fn = fn

    def __exit__(self, *exc):
        for k, fn in self.own:
            k._fn = fn


def _outputs(out):
    return [out] if isinstance(out, torch.Tensor) else [t for t in out if t is not None]


def parent_turns(stems, new, row, **graph):
    """With --baseline-csrc and a stem of ``stems`` (a kernel name or a
    list) built from the parent: ``new`` again with the parent's kernels
    swapped in, held equal to ``new``'s output and timed beside it in
    turns; the median of each side goes into ``row`` (``turns_ms`` /
    ``parent_ms``), the readings into ``row["turns"]``."""
    stems = [s for s in ([stems] if isinstance(stems, str) else stems) if s in BASELINE]
    if not stems:
        return row

    def old():
        with parent_kernels(stems):
            return new()

    got, want = _outputs(old()), _outputs(new())
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{'/'.join(stems)}: the parent's kernel and this one disagree")
    turns = in_turns(new, old, **graph)
    calls = {"n": [], "o": []}  # per call (host launch included), in turns n o o n
    for who in "noon":
        calls[who].append(cuda_ms(new if who == "n" else old, 20))
    row.update(turns=turns, turns_ms=sorted(turns["n"])[1], parent_ms=sorted(turns["o"])[1],
               turns_call_ms=min(calls["n"]), parent_call_ms=min(calls["o"]), parent_stems=stems)
    return row


def in_turns(new, old, **graph):
    """CUDA-graph ms of ``new`` and ``old`` read in turns, n o o n n o:
    {"n": [three readings], "o": [three readings]}."""
    turns = {"n": [], "o": []}
    for who in "noonno":
        turns[who].append(graph_ms(new if who == "n" else old, **graph))
    return turns


def apply_paths_held(dfa, maps, want, label, report):
    """K18 apply on its pick and every forced path (APPLY_PATHS) against
    ``want`` (the plain version's output): the error of each into
    ``report`` as ``label:path``."""
    from cilium_tpu_torch.ops.seqdfa import APPLY_PATHS, seqdfa_apply

    for path in APPLY_PATHS:
        got = seqdfa_apply(dfa, maps, None if path == "pick" else path)
        report[f"{label}:{path}"] = max_abs_err([got], [want])


def apply_boundary(dev, report):
    """K18 apply's pick and forced paths on tests/merge_cases.py's maps
    (K = 1 to 2,000, S = 1 to 128, F x R off every block's pairs), at byte
    offsets 0, 1 and 7, against the plain version."""
    from cilium_tpu_torch.ops.dfa import dfa_from_arrays
    from cilium_tpu_torch.ops.seqdfa import seqdfa_apply_plain

    mc = _tests_module("merge_cases")
    for name, f, r, k, s in mc.APPLY_SHAPES:
        classmap, delta, start, accept, accept_final, maps = mc.apply_case(
            np.random.default_rng(f * k + s), f, r, k, s)
        dfa = dfa_from_arrays(classmap, delta, start, accept, accept_final, dev)
        want = seqdfa_apply_plain(dfa, torch.from_numpy(maps).to(dev))
        for off in mc.APPLY_OFFSETS:
            apply_paths_held(dfa, mc.at_offset(maps, off, dev), want, f"apply-{name}-o{off}", report)


def seqdfa_cases(dev):
    """Phase 11's cases: {name: dict(d, l, k, f, width, base, dfa, abs)},
    seqdfa-32k and -4k (seq9 patterns) at each of SEQ_CHUNKS and
    seqdfa-32k-adv at k1 and k64."""
    from cilium_tpu_torch.entry import seqdfa_batch, seqdfa_tables
    from cilium_tpu_torch.ops.dfa import device_dfa
    from cilium_tpu_torch.ops.seqdfa import device_dfa_absorbing, fold_segment
    from cilium_tpu_torch.regex.dfa import compile_pattern_dfas

    tabs = {}
    for name, tables in (("seq9", seqdfa_tables()), ("adv", compile_pattern_dfas(list(SEQ_ADV_PATTERNS)))):
        tabs[name] = (device_dfa(tables, dev), device_dfa_absorbing(tables, dev))
    cases = {}
    shapes = [(label, f, width, SEQ_CHUNKS, "seq9") for label, f, width in SEQ_SHAPES]
    shapes.append((*SEQ_ADV, "adv"))
    for label, f, width, chunks, tname in shapes:
        make = seqdfa_adv_batch if tname == "adv" else lambda f, w: seqdfa_batch(f, w, max(SEQ_CHUNKS))
        data, lengths = make(f, width)
        d = torch.from_numpy(data).to(dev)
        l = torch.from_numpy(lengths).to(dev)
        dfa, dfa_abs = tabs[tname]
        for k in chunks:
            cases[f"{label}-k{k}"] = dict(d=d, l=l, k=k, f=f, width=width, base=label, dfa=dfa,
                                          abs=dfa_abs)
        log(f"{label}: F={f} W={width} R={dfa_abs.n_patterns} S={dfa_abs.n_states} "
            f"C={dfa_abs.n_classes} mean length {float(lengths.mean()):.0f}; K18 fold segments of "
            f"{fold_segment(f, width)} bytes")
    return cases


def seqdfa_slice(dev, card, kerns):
    """Phase 11, the chunk-folded DFA search on the card, counted in a run
    of its own: seqdfa-32k (F = 2,048, the engines' capacity, x W =
    32,768, the HTTP engine's MAX_WIDTH) and seqdfa-4k (F = 256 x W =
    4,096), tests/test_seqdfa.py's 9 patterns, n_chunks 1, 8 and 64; and
    seqdfa-32k-adv (two counters on frames of one byte, n_chunks 1 and
    64), where K18's fold takes its slow branch.  K18 is held against K2
    ``dfa_search_batch`` on the non-absorbing tables (every case), its
    fold and apply against their plain versions where the plain fold is
    quick enough (``plain_case``), its branch counters against
    ``seqdfa_fold_branches_plain``, and it is timed beside K2 (and K2
    beside the parent's K2 in turns on each frame shape, given
    --baseline-csrc and a parent whose dfa_scan.cu differs).  Returns
    (launches, runs, report, timed)."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.ops.dfa import dfa_search_batch
    from cilium_tpu_torch.ops.seqdfa import (
        FOLD_DMAX,
        FOLD_PROBE,
        APPLY_PATHS,
        apply_staged_bytes,
        seqdfa_apply,
        seqdfa_apply_plain,
        seqdfa_fold,
        seqdfa_fold_branches_plain,
        seqdfa_fold_plain,
        seqdfa_search_batch,
    )

    log("== seqdfa slice")
    t_phase = time.monotonic()
    cases = seqdfa_cases(dev)
    log(f"K18 fold: probe {FOLD_PROBE} bytes, at most {FOLD_DMAX} distinct states a fast group")

    log("== seqdfa main path (counted)")

    def counts():
        return {n: k.launches for n, k in kerns.items()}

    def delta(before):
        return {n: k.launches - before[n] for n, k in kerns.items()}

    for k in kerns.values():
        k.launches = 0
    runs, outs = {}, {}
    for name, cs in cases.items():
        before = counts()
        outs[name] = seqdfa_search_batch(cs["abs"], cs["d"], cs["l"], cs["k"])
        runs[name] = delta(before)
    torch.cuda.synchronize()
    launches = counts()
    log("launches:", json.dumps({n: v for n, v in launches.items() if v}))
    for name in cases:
        want = dict.fromkeys(kerns, 0)
        want.update(seqdfa_fold=1, seqdfa_apply=1)
        if runs[name] != want:
            raise AssertionError(f"{name}: launches {runs[name]} != {want}")
    for n, count in launches.items():
        if sum(rr[n] for rr in runs.values()) != count:
            raise AssertionError(f"{n}: the runs' launches do not add up to the main path's")

    # The plain fold steps a [F, R, K, S] state W / K times: at 32k it is
    # followed at n_chunks 64 only, and 32k-k1 / -k8 stand on K2 alone.
    def plain_case(cs):
        return cs["base"] == "seqdfa-4k" or cs["k"] == max(SEQ_CHUNKS)

    # against K2 on the non-absorbing tables (every case), the plain fold
    # and apply (the plain cases), bit for bit, and the branch counters
    log("== K18 vs K2 and plain")
    report = {"seqdfa_fold": {}, "seqdfa_apply": {}}
    serial, branches = {}, {}
    for name, cs in cases.items():
        dfa_abs = cs["abs"]
        if cs["base"] not in serial:
            serial[cs["base"]] = dfa_search_batch(cs["dfa"], cs["d"], cs["l"])
        if not torch.equal(outs[name], serial[cs["base"]]):
            raise AssertionError(f"{name}: K18 != K2 on {int((outs[name] != serial[cs['base']]).sum())} "
                                 f"(flow, pattern) pairs")
        if plain_case(cs):
            maps = seqdfa_fold(dfa_abs, cs["d"], cs["l"], cs["k"])
            want_maps = seqdfa_fold_plain(dfa_abs, cs["d"], cs["l"], cs["k"])
            want = seqdfa_apply_plain(dfa_abs, want_maps)
            report["seqdfa_fold"][name] = max_abs_err([maps], [want_maps])
            report["seqdfa_apply"][name] = max_abs_err([seqdfa_apply(dfa_abs, maps)], [want])
            if not torch.equal(outs[name], want):
                raise AssertionError(f"{name}: K18 != its plain version")
        dbg = torch.zeros(3, dtype=torch.int64, device=dev)
        seqdfa_fold(dfa_abs, cs["d"], cs["l"], cs["k"], debug=dbg)
        got = [int(x) for x in dbg.cpu()]
        want_b = [int(x) for x in seqdfa_fold_branches_plain(dfa_abs, cs["d"], cs["l"], cs["k"]).cpu()]
        if got != want_b:
            raise AssertionError(f"{name}: fold branch counts {got} != plain {want_b}")
        branches[name] = got
        groups, chains, slow = got
        log(f"{name:18s} fold groups {groups} (flow, pattern, segment); chains walked past the probe "
            f"{chains} ({chains / max(groups, 1):.4f} a group); slow branch {slow} groups, share "
            f"{slow / max(groups, 1):.6f}")
    # K18 apply on every path at every case and on the boundary maps
    for name, cs in cases.items():
        maps = seqdfa_fold(cs["abs"], cs["d"], cs["l"], cs["k"])
        apply_paths_held(cs["abs"], maps, seqdfa_apply_plain(cs["abs"], maps), name, report["seqdfa_apply"])
    apply_boundary(dev, report["seqdfa_apply"])
    log(f"K18 apply: pick and {len(APPLY_PATHS) - 1} forced paths held to plain at every case and "
        f"{sum(1 for n in report['seqdfa_apply'] if n.startswith('apply-'))} boundary readings")
    hits = serial["seqdfa-32k"]
    log(f"K18 == K2 at every n_chunks; 32k match share per pattern "
        f"{[round(float(x), 3) for x in hits.float().mean(dim=0)]}; adv match share "
        f"{[round(float(x), 3) for x in serial[SEQ_ADV[0]].float().mean(dim=0)]}")
    log("max |kernel - plain|:", json.dumps(report))
    if any(v for per in report.values() for v in per.values()):
        raise AssertionError("K18 disagrees with its plain version")
    # the fast branch: chains walked with no slow group; the slow branch:
    # every adversarial case
    fast_ran = any(b[1] > 0 and b[2] == 0 for n, b in branches.items() if cases[n]["base"] != SEQ_ADV[0])
    slow_ran = all(b[2] > 0 for n, b in branches.items() if cases[n]["base"] == SEQ_ADV[0])
    if not (fast_ran and slow_ran):
        raise AssertionError("K18's fold did not run both branches")

    # times: fold and apply apart, the pair against K2 at the same width
    log("== seqdfa times on", card)
    timed = {}
    for name, cs in cases.items():
        d, l, k, f, width, dfa_abs = cs["d"], cs["l"], cs["k"], cs["f"], cs["width"], cs["abs"]
        r, s, c = dfa_abs.n_patterns, dfa_abs.n_states, dfa_abs.n_classes
        active = int(l.clamp(0, width).sum())
        maps = seqdfa_fold(dfa_abs, d, l, k)
        fold = lambda: seqdfa_fold(dfa_abs, d, l, k)  # noqa: E731
        apply_ = lambda: seqdfa_apply(dfa_abs, maps)  # noqa: E731
        plain = plain_case(cs)
        rows = {
            # the bound: one table step per active (flow, pattern, byte)
            "seqdfa_fold": dict(
                ms=graph_ms(fold, iters=5, replays=4), call_ms=cuda_ms(fold, 10),
                plain_ms=cuda_ms(lambda: seqdfa_fold_plain(dfa_abs, d, l, k), 2) if plain else None,
                library_ms=None, bytes=active + 4 * f + f * r * k * s + 256 + r * s * c,
                ops=active * r),
            "seqdfa_apply": dict(
                ms=graph_ms(apply_), call_ms=cuda_ms(apply_, 50),
                plain_ms=cuda_ms(lambda: seqdfa_apply_plain(dfa_abs, maps), 10),
                library_ms=None, bytes=f * r * k + f * r + r + r * s, ops=f * r * k),
        }
        # the launcher's plan (from the library), the bytes it stages, and
        # the parent's apply in turns (--baseline-csrc)
        code, pairs, kt = kernels.seqdfa_apply_variant(f, r, s, k)
        path = {v: n for n, v in APPLY_PATHS.items()}[code]
        arow = rows["seqdfa_apply"]
        arow["variant"] = f"{path} P={pairs} kt={kt}"
        staged = apply_staged_bytes(maps, kt) if path != "walk" else None
        log(f"{name:18s} seqdfa_apply path {path}, {pairs} pairs a block, {kt} chunks a tile; "
            + (f"stages {staged} bytes ({staged / (f * r * k * s):.3f} x the maps)" if staged else
               f"loads {f * r * k} map bytes, one a dependent step") + f" [{card}]")
        parent_turns("seqdfa", apply_, arow)
        for kname, row in rows.items():
            bound(row)
            log_row(name, kname, row)
        log(f"{name:18s} seqdfa_fold S-fold count (every start state through every byte): "
            f"{active * r * s} ops, {active * r * s / INT32_OPS_PER_S * 1e3:.6f} ms")
        k2 = lambda: dfa_search_batch(cs["dfa"], d, l)  # noqa: E731
        k2_ms = graph_ms(k2, iters=5, replays=4)
        timed[name] = dict(rows=rows, k2_ms=k2_ms)
        if "dfa_scan" in BASELINE and cs["base"] in ("seqdfa-32k", "seqdfa-4k") \
                and cs["k"] == max(SEQ_CHUNKS):
            # K2 does not depend on n_chunks: once a frame shape
            k2_row = parent_turns("dfa_scan", k2, {}, iters=5, replays=4)
            log(f"{cs['base']:18s} K2 dfa_scan {turns_text(k2_row['turns'])} [{card}]")
        pair = rows["seqdfa_fold"]["ms"] + rows["seqdfa_apply"]["ms"]
        log(f"{name:18s} K18 fold + apply {pair:.5f} ms against K2 dfa_scan {k2_ms:.5f} ms "
            f"(K18 / K2 = {pair / k2_ms:.3f}) [{card}]")
    log(f"seqdfa slice: {time.monotonic() - t_phase:.1f} s")
    return launches, runs, report, timed


# --- phase 12: the seam benchmarks (latbench, mixbench, fan-in) ----------------

# run_paired_colocated's pairs per transport (its default is 9)
SEAM_PAIRED_REPS = 5
# the service's flow buckets at latbench's batch_flows (MIN_BUCKET .. 8,192)
SEAM_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)
SEAM_MIX_SECONDS = 5.0  # bench_mixed runs 12 s
SEAM_CACHE_SECONDS = 3.0  # bench_flow_cache runs 8 s a side


def seam_slice(dev, card, kerns):
    """Phase 12, the seam benchmarks on the card, counted in a run of their
    own: the round-trip and uplink probes, the paired seam-vs-null
    experiment over the socket and the shm rings (the seam probe, K19, on
    the card), the real r2d2 model at 100k, 1M and 5M requests/s, the
    mixed-path bench held against the in-process parser, the flow cache
    paired, and 16-session fan-in; then K19 and K20 against their plain
    versions and timed.  Returns (launches, runs, report, timed); here a
    launch is a wrapper launch or a graph replay."""
    import tempfile

    from cilium_tpu_torch.proxylib import instance as inst

    log("== seam slice")
    t_phase = time.monotonic()
    inst.reset_module_registry()
    with tempfile.TemporaryDirectory(prefix="seam-", dir=".") as tmp:
        return _seam_runs(dev, card, kerns, tmp, t_phase)


def seam_windows():
    """Patch ``LatencyBench.run_rate`` to note, for each timed window on a
    verdict service, the graph captures and ledger compiles made inside
    it, and the tracer's wall-clock stages of the vec path after it
    (``status()["latency"]``: cumulative over the service's rounds).
    Returns (the notes, a function that undoes the patch)."""
    from cilium_tpu_torch.sidecar import latbench

    notes = []
    real = latbench.LatencyBench.run_rate

    def run_rate(self, rate, n_requests, seed=3):
        svc = self.service
        stats = getattr(svc, "graph_stats", None)
        if stats is None:  # the null server
            return real(self, rate, n_requests, seed)
        c0, l0 = stats["captures"], svc.ledger.status()["compiles"]
        r = real(self, rate, n_requests, seed)
        notes.append(dict(rate=rate, captures=stats["captures"] - c0,
                          compiles=svc.ledger.status()["compiles"] - l0,
                          stages=svc.status()["latency"]["stages"].get("vec", {})))
        return r

    latbench.LatencyBench.run_rate = run_rate
    return notes, lambda: setattr(latbench.LatencyBench, "run_rate", real)


def tap_verdicts(client, seqs):
    """Keep, for each seq in ``seqs``, the {conn: (ops, orig inject, reply
    inject)} of the verdicts ``client`` delivers to whatever callback it is
    given later (the benches set their own)."""
    kept = {}
    base = type(client)

    class Tapped(base):
        @property
        def verdict_callback(self):
            return self.__dict__.get("_tapped_cb")

        @verdict_callback.setter
        def verdict_callback(self, cb):
            def tapped(vb):
                if vb.seq in seqs:
                    per = kept.setdefault(vb.seq, {})
                    for j in range(vb.count):
                        cid, _, ops, io, ir = vb.entry(j)
                        o, a, b = per.get(int(cid), ([], b"", b""))
                        per[int(cid)] = (o + [(int(x), int(n)) for x, n in ops], a + bytes(io),
                                         b + bytes(ir))
                cb(vb)

            self.__dict__["_tapped_cb"] = None if cb is None else tapped

    cb = client.verdict_callback
    client.__class__ = Tapped
    client.verdict_callback = cb
    return kept


def mix_rounds(b, n):
    """MixBench's first ``n`` rounds (``_build_round``, the stream
    ``oracle_rate`` feeds) as sidecar_oracle rounds: (conn, bytes, remote 1,
    reply)."""
    from cilium_tpu_torch.sidecar import wire

    out = []
    for r in range(n):
        (m_ids, m_lens, m_rows), (ids, fl, lens, blob), _, _ = b._build_round(r)
        rows = np.frombuffer(m_rows, np.uint8).reshape(-1, 64)
        rnd = [(int(c), rows[k, : m_lens[k]].tobytes(), 1, False) for k, c in enumerate(m_ids)]
        offs = np.concatenate(([0], np.cumsum(lens.astype(np.int64))))
        rnd += [(int(c), blob[offs[k]:offs[k + 1]], 1, bool(fl[k] & wire.FLAG_REPLY))
                for k, c in enumerate(ids)]
        out.append(rnd)
    return out


def seam_fanin(path, card, n_sessions=16):
    """bench.py's ``bench_fanin_concurrent`` on the card: n_sessions shim
    sessions (one SidecarClient each, 16 conns each) feeding one
    dispatcher at twice the single-session capacity.  Its contract holds
    or this raises: every seq answered exactly once (served OK or a typed
    SHED), no reply routed to the wrong session, every session served,
    and each session's submitted count equal to its answered count."""
    from cilium_tpu_torch.proxylib import FilterResult, NetworkPolicy, PortNetworkPolicy, PortNetworkPolicyRule
    from cilium_tpu_torch.proxylib import instance as inst_mod
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService
    from cilium_tpu_torch.utils.option import DaemonConfig

    policy = NetworkPolicy(name="bench-fanin", policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
            remote_policies=[1], l7_proto="r2d2", l7_rules=[{"cmd": "READ", "file": "/public/.*"}])])])
    inst_mod.reset_module_registry()
    cfg = DaemonConfig(batch_timeout_ms=0.0, batch_flows=512, shed_queue_entries=2048,
                       shed_queue_age_ms=25.0)
    svc = VerdictService(path, cfg).start()
    msg = b"READ /public/bench.txt\r\n"
    conns_per = 16
    clients, metas = [], []
    try:
        for s in range(n_sessions):
            cl = SidecarClient(svc.socket_path, timeout=60.0, identity=f"bench-pod-{s}")
            clients.append(cl)
            mod = cl.open_module([])
            if cl.policy_update(mod, [policy]) != int(FilterResult.OK):
                raise AssertionError("fan-in: policy_update refused")
            base = 1000 * (s + 1)
            for k in range(conns_per):
                res, _ = cl.new_connection(mod, "r2d2", base + k, True, 1, 2, f"1.1.1.{s + 1}:{k + 1}",
                                           "2.2.2.2:80", "bench-fanin")
                if res != int(FilterResult.OK):
                    raise AssertionError(f"fan-in: conn {base + k}: {res}")
            lock = threading.Lock()
            answered, sent_ts = {}, {}

            def cb(vb, _answered=answered, _lock=lock):
                now = time.perf_counter()
                ok = bool(vb.count) and int(vb.results[0]) == int(FilterResult.OK)
                with _lock:
                    _answered[vb.seq] = (now, ok)

            cl.verdict_callback = cb
            metas.append({"client": cl, "ids": np.arange(base, base + conns_per, dtype=np.uint64),
                          "lens": np.full(conns_per, len(msg), np.uint32), "answered": answered,
                          "sent": sent_ts, "lock": lock, "blob": msg * conns_per})

        def fire(m, seq):
            m["sent"][seq] = time.perf_counter()
            m["client"].send_batch(seq, m["ids"], [0] * conns_per, m["lens"], m["blob"])

        def drain(m, upto, timeout_s):
            deadline = time.perf_counter() + timeout_s
            while time.perf_counter() < deadline:
                with m["lock"]:
                    if len(m["answered"]) >= upto:
                        return True
                time.sleep(0.002)
            return False

        # single-session baseline: closed-loop capacity and p99
        m0 = metas[0]
        for s in range(1, 21):
            fire(m0, s)
            if not drain(m0, s, 60.0):
                raise AssertionError("fan-in warm-up stalled")
        with m0["lock"]:
            m0["answered"].clear()
        m0["sent"].clear()
        t0 = time.perf_counter()
        n_cap = 200
        for s in range(100, 100 + n_cap):
            fire(m0, s)
            if not drain(m0, s - 99, 60.0):
                raise AssertionError("fan-in capacity phase stalled")
        single_rate = n_cap * conns_per / (time.perf_counter() - t0)
        with m0["lock"]:
            base_lat = sorted((m0["answered"][s][0] - m0["sent"][s]) * 1e3
                              for s in m0["sent"] if s in m0["answered"])
            m0["answered"].clear()
        m0["sent"].clear()
        single_p99 = base_lat[min(int(len(base_lat) * 0.99), len(base_lat) - 1)]

        # n_sessions at twice the single-session capacity in aggregate
        offered = 2.0 * single_rate
        interval = conns_per / (offered / n_sessions)
        window = 128  # per-session unanswered batches in flight

        def open_loop(m, seq0, duration, t_start):
            seq, next_fire = seq0, t_start
            while time.perf_counter() - t_start < duration:
                now = time.perf_counter()
                if now < next_fire:
                    time.sleep(min(next_fire - now, 0.001))
                    continue
                with m["lock"]:
                    outstanding = len(m["sent"]) - len(m["answered"])
                if outstanding >= window:
                    time.sleep(0.001)
                    continue
                seq += 1
                fire(m, seq)
                next_fire += interval

        def run_phase(duration, phase):
            t_start = time.perf_counter() + 0.1
            threads = [threading.Thread(target=open_loop, daemon=True, args=(
                m, 10_000_000 * phase + 100_000 * (i + 1), duration, t_start))
                for i, m in enumerate(metas)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(duration + 30)

        def quiesce(timeout_s):
            deadline = time.perf_counter() + timeout_s
            while time.perf_counter() < deadline:
                if all(all(s in m["answered"] for s in m["sent"]) for m in metas):
                    return
                time.sleep(0.01)

        run_phase(2.0, phase=1)  # prime: the aggregated round shapes
        quiesce(30.0)
        for m in metas:
            with m["lock"]:
                m["answered"].clear()
            m["sent"].clear()
        duration = 4.0
        run_phase(duration, phase=2)
        quiesce(30.0)

        silent_loss = served = shed = 0
        p99s = []
        for m in metas:
            with m["lock"]:
                done = dict(m["answered"])
            silent_loss += sum(1 for s in m["sent"] if s not in done)
            lats = sorted((done[s][0] - m["sent"][s]) * 1e3 for s in m["sent"] if s in done and done[s][1])
            served += len(lats) * conns_per
            shed += sum(conns_per for s in m["sent"] if s in done and not done[s][1])
            if lats:
                p99s.append(lats[min(int(len(lats) * 0.99), len(lats) - 1)])
        misroutes = sum(c.misrouted_verdicts for c in clients)
        if silent_loss or misroutes or len(p99s) != n_sessions:
            raise AssertionError(f"fan-in contract: {silent_loss} batches unanswered, {misroutes} "
                                 f"misrouted, {len(p99s)} of {n_sessions} sessions served")
        rows = svc.status()["sessions"]["live"]
        for row in rows:
            if row["submitted"] != row["answered"]:
                raise AssertionError(f"fan-in session {row}")
        out = dict(single_rate=single_rate, single_p99_ms=single_p99, aggregate_rate=served / duration,
                   offered=offered, per_session_p99_ms=[round(p, 3) for p in p99s],
                   p99_worst_ms=max(p99s), p99_median_ms=sorted(p99s)[n_sessions // 2],
                   served_entries=served, shed_entries=shed, dispatch=svc.dispatch_mode_chosen)
    finally:
        for c in clients:
            c.close()
        svc.stop()
        inst_mod.reset_module_registry()
    log(f"fan-in, {n_sessions} sessions x {conns_per} conns at 2x the single-session capacity "
        f"({offered:.0f} offered): aggregate {out['aggregate_rate']:.0f} verdicts/s served, "
        f"{shed} shed typed, single session {single_rate:.0f} verdicts/s (p99 {single_p99:.3f} ms); "
        f"per-session p99 median {out['p99_median_ms']:.3f} ms, worst {out['p99_worst_ms']:.3f} ms "
        f"{out['per_session_p99_ms']}; 0 unanswered, 0 misrouted; dispatch {out['dispatch']} "
        f"(host clock) [{card}]")
    return out


def _rate_line(tag, r, card):
    log(f"{tag}: offered {r.offered_rate:.0f}/s achieved {r.achieved_rate:.0f}/s "
        f"({r.requests} requests) p50 {r.p50_ms:.4f} p90 {r.p90_ms:.4f} p99 {r.p99_ms:.4f} "
        f"max {r.max_ms:.4f} ms; added p50 {r.added_p50_ms:.4f} p99 {r.added_p99_ms:.4f} ms; "
        f"release late p50 {r.release_late_p50_ms:.4f} p99 {r.release_late_p99_ms:.4f} ms; "
        f"gen_saturated {r.gen_saturated} (host clock) [{card}]")


class probe_dispatches:
    """Inside ``with probe_dispatches() as n``, ``n["calls"]`` counts the
    services' device dispatches of the seam probe: calls of
    ``_model_call``, ``_model_call_attr`` and ``_gathered_call`` on a
    ``SeamProbe`` (the outermost of nested ones).  Each is one K19
    launch or graph replay; a graph capture adds its warm launch."""

    NAMES = ("_model_call", "_model_call_attr", "_gathered_call")

    def __enter__(self):
        from cilium_tpu_torch.models.base import SeamProbe
        from cilium_tpu_torch.sidecar.service import VerdictService

        counts, depth, lock = {"calls": 0}, threading.local(), threading.Lock()
        self.real = {n: getattr(VerdictService, n) for n in self.NAMES}

        def wrap(real):
            def call(svc, model, *args, **kw):
                d = getattr(depth, "n", 0)
                if d == 0 and isinstance(svc._live_model(model), SeamProbe):
                    with lock:
                        counts["calls"] += 1
                depth.n = d + 1
                try:
                    return real(svc, model, *args, **kw)
                finally:
                    depth.n = d
            return call

        for n, real in self.real.items():
            setattr(VerdictService, n, wrap(real))
        return counts

    def __exit__(self, *exc):
        from cilium_tpu_torch.sidecar.service import VerdictService

        for n, real in self.real.items():
            setattr(VerdictService, n, real)


def probe_round_times(dev, card):
    """12i. The seam probe's blob-lane round, graph-timed, at the smallest
    bucket (the rounds at 100k/s) and the largest the services cut from
    latbench's corpus (4,096: the 64 KiB window's 3,180 messages): ``_gather_model`` on a ``SeamProbe`` as the service now
    runs it (K19 alone) in turns with the round as the parent ran it (K16,
    then K19; the parent's kernels given --baseline-csrc, else this
    tree's; K19's source is the parent's).  Both rounds' outputs must be
    equal."""
    from cilium_tpu_torch.models.base import SeamProbe
    from cilium_tpu_torch.ops.gather import gather_rows
    from cilium_tpu_torch.sidecar.service import _gather_model

    probe = SeamProbe(device=dev)
    stems = [s for s in ("gather_rows",) if s in BASELINE]
    for f in (256, 4096):
        b, o, ln = (torch.from_numpy(a).to(dev) for a in seam_blob_chunk(f))
        r = torch.ones(f, dtype=torch.int32, device=dev)

        def new():
            return _gather_model(probe, b, o, ln, r, 64, True)

        def old():
            with parent_kernels(stems):
                gather_rows(b, o, ln, 64)
                return probe.verdicts_attr(None, ln, r)

        if max_abs_err(list(new()), list(old())):
            raise AssertionError(f"the probe's round at {f} differs from the parent's")
        turns = in_turns(new, old)
        n, o = sorted(turns["n"])[1], sorted(turns["o"])[1]
        kern = "the parent's K16" if stems else "this tree's K16"
        log(f"seam probe blob round {f} x 64, graph-timed: K19 alone "
            + ", ".join(f"{t:.5f}" for t in turns["n"]) + " ms; K16 then K19 as the parent ran it ("
            + kern + ") " + ", ".join(f"{t:.5f}" for t in turns["o"])
            + f" ms (in turns n o o n n o; medians {n:.5f} / {o:.5f} = {n / o:.3f}) [{card}]")


def _seam_runs(dev, card, kerns, tmp, t_phase):
    """The runs of ``seam_slice``, their sockets under ``tmp``."""
    from cilium_tpu_torch.models import base as base_mod
    from cilium_tpu_torch.sidecar import latbench, mixbench

    def counts():
        return {n: (k.launches, k.replayed) for n, k in kerns.items()}

    def delta(before):
        now = counts()
        return {n: now[n][0] - before[n][0] + now[n][1] - before[n][1] for n in now}

    def launched(d, names, run):
        idle = [n for n in names if d[n] <= 0]
        if idle:
            raise AssertionError(f"{run}: kernels of the path never launched: {idle}")

    notes, unpatch = seam_windows()
    runs = {}
    # 12b-12g, the main path, counted: every count set to 0 just before,
    # read just after; a launch is a wrapper launch or a graph replay.
    log("== seam main path (counted)")
    for k in kerns.values():
        k.launches = 0
        k.replayed = 0
    try:
        # 12b. device round trip (K20) and uplink
        before = counts()
        samples = []
        rtt = latbench.measure_device_rtt_ms(samples=samples)
        uplink = latbench.measure_uplink_mbps()
        runs["seam-rtt"] = delta(before)
        launched(runs["seam-rtt"], ["rtt_tick"], "rtt")
        log(f"device round trip, K20 rtt_tick on [8] int32 + blocking readback: median {rtt:.4f} ms "
            f"of {len(samples)} (min {min(samples):.4f}, max {max(samples):.4f}); uplink "
            f"{uplink:.1f} MB/s (512 KiB pageable numpy, serialized) [{card}]")

        # 12c. the paired colocated experiment, socket then shm (matrix
        # wire), then the blob wire eager and through graphs: the probe
        # reads no rows, so no K16 launches, replays or captures, and one
        # K19 launch or replay a dispatch (and one warm launch a capture).
        paired = {}
        for tr, transport, kw in (
                ("socket", "socket", {}), ("shm", "shm", {}),
                ("blob-eager", "socket", dict(wire_mode="blob", dispatch_mode="eager", reps=2)),
                ("blob-jit", "socket", dict(wire_mode="blob", dispatch_mode="jit", reps=2))):
            before, n0 = counts(), len(notes)
            cap0 = {n: kerns[n].captured for n in ("seam_probe", "gather_rows")}
            with probe_dispatches() as disp:
                out = latbench.run_paired_colocated(
                    f"{tmp}/p-{tr}.sock", transport=transport, **{"reps": SEAM_PAIRED_REPS, **kw})
            d = runs[f"seam-paired-{tr}"] = delta(before)
            launched(d, ["seam_probe"], f"paired {tr}")
            cap = {n: kerns[n].captured - c for n, c in cap0.items()}
            if d["gather_rows"] or cap["gather_rows"] or d["seam_probe"] != disp["calls"] + cap["seam_probe"]:
                raise AssertionError(f"paired {tr}: K16 {d['gather_rows']} launches + replays, "
                                     f"{cap['gather_rows']} captures; K19 {d['seam_probe']} for "
                                     f"{disp['calls']} probe dispatches and {cap['seam_probe']} captures")
            log(f"paired {tr}: K16 launches + replays {d['gather_rows']}, captures {cap['gather_rows']}; "
                f"K19 launches + replays {d['seam_probe']} = {disp['calls']} probe dispatches + "
                f"{cap['seam_probe']} graph captures' warm launches")
            st = out["seam_transport"]
            if st["mode"] != transport:
                raise AssertionError(f"paired {tr}: the seam client rode {st['mode']}: {st}")
            win = notes[n0:]
            paired[tr] = out
            log(f"paired colocated ({tr}, {len(out['pair_deltas_ms'])} pairs at 100k/s, seam probe K19 on the card, "
                f"dispatch {out['dispatch_mode']}): delta p99 (seam - null) {out['delta_p99_ms']:.4f} ms, "
                f"pair deltas {out['pair_deltas_ms']}, seam p99 runs {out['seam_p99_runs']}, null p99 "
                f"runs {out['null_p99_runs']} (host clock) [{card}]")
            for tag in ("seam_100k", "null_100k", "seam_1m", "null_1m"):
                _rate_line(f"paired {tr} {tag}", out[tag], card)
            log(f"paired {tr}: seam_stages_us {out['seam_stages_us']}; oracle p50 "
                f"{out['oracle_p50_ms']:.4f} p99 {out['oracle_p99_ms']:.4f} ms; os noise {out['os_noise']}")
            log(f"paired {tr}: transport {json.dumps({k: st.get(k) for k in ('mode', 'preference', 'fallbacks', 'bytes_pushed')})}")
            log(f"paired {tr}: K19 launches + graph replays {d['seam_probe']}; graph captures in the "
                f"{len(win)} timed windows {sum(w['captures'] for w in win)}, ledger compiles "
                f"{sum(w['compiles'] for w in win)} "
                f"({[{k: w[k] for k in ('rate', 'captures', 'compiles')} for w in win]})")
            stages = [w for w in win if w["rate"] == 100_000][-1]["stages"]
            log(f"paired {tr}: the tracer's vec-path stages over the warm-up and the 100k/s windows, "
                f"wall clock: " + ", ".join(
                    f"{k} {v['mean_us']} us mean / {v['p99_us']} us p99 ({v['rounds']} rounds)"
                    for k, v in stages.items() if v["rounds"] and v["mean_us"])
                + f" (host clock) [{card}]")

        # 12d. the real r2d2 model at 100k, 1M and 5M requests/s
        before, n0 = counts(), len(notes)
        lat = latbench.run(f"{tmp}/lat.sock", rates=(100_000, 1_000_000, 5_000_000),
                           n_requests=100_000, colocated=False)
        d = runs["seam-latency"] = delta(before)
        launched(d, ["r2d2_frame", "dfa_scan", "r2d2_hits", "gather_rows", "rtt_tick"], "latency")
        win = notes[n0:]
        log(f"latency, r2d2 model on the card (blob wire, dispatch {lat['dispatch_mode']}): device rtt "
            f"{lat['device_rtt_ms']:.4f} ms, uplink {lat['uplink_mbps']:.1f} MB/s, oracle p50 "
            f"{lat['oracle_p50_ms']:.4f} ms, dispatcher {lat['dispatcher']}; graph captures in the timed "
            f"windows {sum(w['captures'] for w in win)}, ledger compiles {sum(w['compiles'] for w in win)} "
            f"[{card}]")
        for r in lat["rates"]:
            _rate_line(f"latency {r.offered_rate:.0f}/s", r, card)

        # 12e. the mixed-path bench, its first two timed rounds held to the in-process parser
        before = counts()
        b = mixbench.MixBench(f"{tmp}/mix.sock")
        try:
            # warm-up rounds 0-3 use seqs 1-8; timed rounds 4 and 5 are 9/10 and 11/12
            kept = tap_verdicts(b.client, {9, 10, 11, 12})
            mix = b.run(duration_s=SEAM_MIX_SECONDS)
            mix["oracle_per_sec"] = b.oracle_rate()
            rounds = mix_rounds(b, 6)
        finally:
            b.close()
        d = runs["seam-mixed"] = delta(before)
        launched(d, ["r2d2_frame", "r2d2_hits"], "mixed")
        if mix["reasm_rounds"] <= 0:
            raise AssertionError(f"mixed: the columnar reassembler never engaged: {mix}")
        exp = sidecar_oracle("r2d2", rounds, [b._policy], name="mixbench", port=80, base=5_000_000)[4:6]
        got = []
        for m_seq in (9, 11):
            per = dict(kept.get(m_seq, {}))
            per.update(kept.get(m_seq + 1, {}))
            got.append(per)
        bad = side_mismatches(got, exp)
        n_conn = sum(len(e) for e in exp)
        log(f"mixed: timed rounds 4-5 vs the in-process parser: {bad} mismatches over {n_conn} conn rounds")
        if bad or sum(len(g) for g in got) != n_conn:
            raise AssertionError(f"mixed: {bad} mismatches against the in-process parser")
        log(f"mixed ({b.pool} conns, {SEAM_MIX_SECONDS:.0f} s): {mix['verdicts_per_sec']:.0f} verdicts/s, "
            f"slow_fraction {mix['slow_fraction']:.4f}, reasm rounds {mix['reasm_rounds']} frames "
            f"{mix['reasm_frames']} fallbacks {mix['reasm_fallbacks']}, rounds {mix['rounds']}; "
            f"in-process parser {mix['oracle_per_sec']:.0f} verdicts/s (host clock) [{card}]")

        # 12f. the flow cache, paired
        cache = {}
        for on in (False, True):
            before = counts()
            fb = mixbench.FlowCacheBench(f"{tmp}/fc{int(on)}.sock", flow_cache=on)
            try:
                cache[on] = fb.run(duration_s=SEAM_CACHE_SECONDS)
            finally:
                fb.close()
            runs[f"seam-cache-{'on' if on else 'off'}"] = delta(before)
        bpv = {on: c["bytes_pushed"] / max(c["frames"], 1) for on, c in cache.items()}
        if cache[True]["hit_rate"] < 0.5 or cache[False]["hit_rate"] != 0.0 or not bpv[True] < bpv[False]:
            raise AssertionError(f"flow cache: {cache}")
        log(f"flow cache ({SEAM_CACHE_SECONDS:.0f} s a side): on {cache[True]['verdicts_per_sec']:.0f} "
            f"verdicts/s (hit rate {cache[True]['hit_rate']:.4f}, {bpv[True]:.1f} bytes a verdict), off "
            f"{cache[False]['verdicts_per_sec']:.0f} verdicts/s (hit rate {cache[False]['hit_rate']:.4f}, "
            f"{bpv[False]:.1f} bytes a verdict) (host clock) [{card}]")

        # 12g. fan-in
        before = counts()
        fan = seam_fanin(f"{tmp}/fan.sock", card)
        runs["seam-fanin"] = delta(before)
    finally:
        unpatch()
    launches = {n: k.launches + k.replayed for n, k in kerns.items()}
    log("seam launches (wrapper + graph replays):", json.dumps({n: v for n, v in launches.items() if v}))
    log("seam launches by run:", json.dumps({r: {n: v for n, v in d.items() if v} for r, d in runs.items()}))
    for n, count in launches.items():
        if sum(d[n] for d in runs.values()) != count:
            raise AssertionError(f"{n}: the seam runs' launches do not add up to the main path's")
    for n in ("seam_probe", "rtt_tick"):
        if launches[n] <= 0:
            raise AssertionError(f"{n} never launched on the seam path")

    # 12a. K19 and K20 against their plain versions, and timed
    log("== K19 / K20 vs plain, and times on", card)
    seam_probe, plain = base_mod.seam_probe, base_mod.seam_probe_plain
    corpus = latbench._corpus(latbench.CONN_POOL)[1].astype(np.int32)
    report = {"seam_probe": {}, "rtt_tick": {}}
    timed = {}
    for f in (*SEAM_BUCKETS, 65536):
        lens = torch.from_numpy(np.resize(corpus, f)).to(dev)
        edge = lens.clone()
        edge[::7] = -1
        err = 0
        for t in (lens, edge):
            for attr in (False, True):
                err = max(err, max_abs_err(list(seam_probe(t, attr)), list(plain(t, attr))))
        shape = f"seam-{f}"
        report["seam_probe"][shape] = err
        if err:
            raise AssertionError(f"K19 differs from its plain version at F = {f}: {err}")
        row = dict(
            ms=graph_ms(lambda: seam_probe(lens, True)),
            call_ms=cuda_ms(lambda: seam_probe(lens, True), 50),
            plain_ms=cuda_ms(lambda: plain(lens, True), 50),
            library_ms=cuda_ms(lambda: torch.ge(lens, 0), 50),
            bytes=13 * f, ops=f,  # read 4F; write ok F, msg_len 4F, rule 4F
        )
        bound(row)
        timed[shape] = {"rows": {"seam_probe": row}}
        runs[shape] = launches
        log_row(shape, "seam_probe", row)
        log(f"{shape:15s} seam_probe library torch.ge(lengths, 0) {row['library_ms']:.5f} ms [{card}]")
    x = torch.tensor([0, 1, -1, 2**31 - 1, -2**31, 7, 100, -100], dtype=torch.int32, device=dev)
    err = max_abs_err([latbench.rtt_tick(x)], [latbench.rtt_tick_plain(x)])
    report["rtt_tick"]["seam-rtt-8"] = err
    if err or int(latbench.rtt_tick(x)[3]) != -2**31:
        raise AssertionError(f"K20 differs from its plain version: {err}")
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    row = dict(ms=graph_ms(lambda: latbench.rtt_tick(x)), call_ms=cuda_ms(lambda: latbench.rtt_tick(x), 50),
               plain_ms=cuda_ms(lambda: latbench.rtt_tick_plain(x), 50),
               library_ms=cuda_ms(lambda: x + 1, 50), bytes=64, ops=8)
    bound(row)
    timed["seam-rtt-8"] = {"rows": {"rtt_tick": row}}
    runs["seam-rtt-8"] = launches
    log_row("seam-rtt-8", "rtt_tick", row)
    log(f"{'seam-rtt-8':15s} rtt_tick library x + 1 {row['library_ms']:.5f} ms [{card}]")
    log("max |kernel - plain|:", json.dumps(report))
    seam_issue_costs(dev, card)
    probe_round_times(dev, card)
    log(f"seam slice: {time.monotonic() - t_phase:.1f} s")
    return launches, runs, report, timed


def seam_issue_costs(dev, card, f=256, n=400):
    """12h. Where a seam round's ``device_issue`` and ``readback`` go on
    the host: thread CPU and wall time of each step of one K19 dispatch of
    the smallest bucket (the rounds at 100k/s fill it), as the service
    takes them (``_upload``'s pinned staging, the K19 wrapper,
    ``_issue_readback``'s pinned copies, ``_to_host``), and of the whole
    issue + readback eager and as a CUDA-graph replay."""
    from cilium_tpu_torch.models.base import SeamProbe, seam_probe
    from cilium_tpu_torch.sidecar.service import _CudaGraphFn, _issue_readback, _to_host

    data = np.zeros((f, 64), np.uint8)
    lens = np.resize(np.arange(2, 40, dtype=np.int32), f)
    rem = np.ones(f, np.int32)
    probe = SeamProbe(device=dev)
    d_lens = torch.from_numpy(lens).to(dev)
    outs = seam_probe(d_lens, attr=True)
    graph = _CudaGraphFn(lambda *a: probe.verdicts_attr(*a), dev, lambda *a: None,
                         {"captures": 0, "replays": 0})

    def upload():
        return [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True) for a in (data, lens, rem)]

    def eager():
        rb = _issue_readback(probe.verdicts_attr(*upload()))
        return [_to_host(x) for x in rb]

    def replay():
        return [_to_host(x) for x in graph(data, lens, rem)]

    steps = {
        "upload (3 pinned stagings + copies)": upload,
        "K19 wrapper on the card's tensors": lambda: seam_probe(d_lens, attr=True),
        "issue readback (4 pinned buffers + copies + event)": lambda: _issue_readback(outs),
        "to_host (event wait) of an issued readback": None,
        "eager issue + readback": eager,
        "graph replay issue + readback": replay,
    }
    parts = []
    for name, fn in steps.items():
        if fn is None:
            rbs = [_issue_readback(outs) for _ in range(n)]
            torch.cuda.synchronize()
            fn = lambda it=iter(rbs): [_to_host(x) for x in next(it)]
        else:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        c0, w0 = time.thread_time(), time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        cpu_us = (time.thread_time() - c0) / n * 1e6
        wall_us = (time.perf_counter() - w0) / n * 1e6
        parts.append(f"{name}: cpu {cpu_us:.1f} us, wall {wall_us:.1f} us")
    log(f"seam issue costs at F = {f}, {n} calls each (host clocks, one thread): " + "; ".join(parts)
        + f" [{card}]")


# --- phase 13: rule- and flow-sharded verdicts on a mesh (K21, K22) -----------

MESH_F = 65536
# (flows x rules) layouts of 13b, on four slots
MESH_LAYOUTS = ((2, 2), (1, 4))
MESH_K_RULES = (1, 2, 4, 8)
MESH_SEQ_SLOTS = 8
MESH_SCALE_PER_SLOT = 16384  # bench_multichip_scaling's per-device batch
MESH_100K_F = 2048
MESH_100K_BUDGET_MS = 1.0  # bench_rules_100k's budget, asserted only on 4 cards


def mesh_slots(dev, n):
    """``n`` slots: distinct cards when the host has that many, else
    virtual slots on ``dev``."""
    from cilium_tpu_torch.parallel.mesh import local_devices, virtual_devices

    cards = local_devices()
    return (cards[:n], True) if len(cards) >= n else (virtual_devices(n, dev), False)


def mesh_table_bytes(models) -> int:
    """Bytes of every tensor of the models (automata and the per-rule CSR
    tables included)."""
    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))

    total = 0
    for m in models:
        for v in vars(m).values():
            if isinstance(v, torch.Tensor):
                total += size([v])
            elif isinstance(v, dict):
                total += size(v.values())
            elif hasattr(v, "n_states"):
                total += size(vars(v).values())
    return total


def mesh_equal(name, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{name}: output {i} differs from the single-device model "
                                 f"({int((g.cpu() != w.cpu()).sum())} rows)")


def mesh_latencies(fn, n=20):
    """(p99 ms, calls/s) of ``fn`` on the host clock, each call synced."""
    fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    lat.sort()
    return lat[min(int(0.99 * len(lat)), len(lat) - 1)] * 1e3, n / sum(lat)


def mesh_rate(fn, f, n=20):
    """Verdicts/s of ``fn`` over ``n`` calls issued back to back, one sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return f * n / (time.perf_counter() - t0)


MESH_K22_RULES = tuple(range(1, 9))


def k22_row(label, args, card, report, timed):
    """K22 at ``args`` (simple, cover, topic_count, overflow): its pick
    and every path the inputs allow held to the plain version (errors into
    ``report``), timed beside the plain version and the library
    expression, and the parent's kernel in turns (--baseline-csrc).  Fills
    ``timed[label]``."""
    from cilium_tpu_torch.parallel import rulesharding as rs

    simple, cover, tc, ov = args
    r, f = simple.shape
    t = cover.shape[2]
    want = rs.kafka_shard_combine_plain(*args)
    report[label] = max_abs_err([rs.kafka_shard_combine(*args)], [want])
    for p_ in combine_paths(cover):
        report[f"{label}:{p_}"] = max_abs_err([rs.kafka_shard_combine(*args, path=p_)], [want])
    t_idx = torch.arange(t, device=cover.device)[None, :]
    klib = lambda: ((simple.any(dim=0) | ((cover.any(dim=0) | (t_idx >= tc[:, None]))  # noqa: E731
                                          .all(dim=1) & (tc > 0))) & ~ov)
    k22 = lambda: rs.kafka_shard_combine(*args)  # noqa: E731
    krow = dict(ms=graph_ms(k22), call_ms=cuda_ms(k22, 50),
                plain_ms=cuda_ms(lambda: rs.kafka_shard_combine_plain(*args), 20),
                library_ms=graph_ms(klib), bytes=r * f + t * r * f + 4 * f + f + f,
                ops=(t + 1) * r * f, variant=rs.combine_variant(cover))
    log(f"{label:15s} kafka_shard_combine R={r} F={f} T={t}: path {krow['variant']} [{card}]")
    parent_turns("shard_reduce", k22, krow)
    timed.setdefault(label, dict(rows={}))["rows"]["kafka_shard_combine"] = bound(krow)
    log_row(label, "kafka_shard_combine", krow)


def combine_paths(cover):
    """The K22 paths that may be forced on ``cover``: the launcher's pick
    (``combine_variant``) and the general path, which takes any input."""
    from cilium_tpu_torch.parallel import rulesharding as rs

    return list(dict.fromkeys((rs.combine_variant(cover), "general")))


def combine_boundary(dev, report):
    """K22's pick and every path the inputs allow on tests/merge_cases.py's
    inputs (any nonzero byte true; T = 1, 3, 8, 13; topic counts -1, 0, T,
    T + 1; F = 1, 3, 4,099, 4,100), R = 1, 4 and 9, aligned and at byte
    offsets, against the plain version on the bytes read as bools."""
    from cilium_tpu_torch.parallel import rulesharding as rs

    mc = _tests_module("merge_cases")
    for r in (1, 4, 9):
        for t in mc.COMBINE_T:
            for f in mc.COMBINE_F:
                arrays = mc.combine_case(np.random.default_rng(31 * r + 7 * t + f), r, f, t)
                want = rs.kafka_shard_combine_plain(*(torch.from_numpy(a != 0) if a.dtype == np.uint8
                                                      else torch.from_numpy(a) for a in arrays)).to(dev)
                for i, offs in enumerate(mc.COMBINE_OFFSETS):
                    args = [mc.at_offset(a, o, dev, d) for a, o, d in
                            zip(arrays, offs, (torch.bool, torch.bool, torch.int32, torch.bool))]
                    for p_ in ["pick", *combine_paths(args[1])]:
                        got = rs.kafka_shard_combine(*args, path=None if p_ == "pick" else p_)
                        report[f"combine-R{r}-T{t}-F{f}-o{i}:{p_}"] = max_abs_err([got], [want])


def mesh_slice(dev, card, kerns):
    """Phase 13, rule- and flow-sharded verdicts on a mesh of slots, counted
    in a run of its own over every kernel: 13b ``dryrun_multichip`` at 2 x
    2 and 1 x 4 and the four mesh models at F = 65,536; 13c rules_100k;
    13d multichip_scaling; 13e ``seqdfa_search_sharded`` at 8 slots; 13f a
    mesh service through its width ladder.  Then 13a: K21 and K22 against
    their plain versions at F = 65,536, R = 1, 2, 4, 8, timed beside the
    library calls.  Slots are virtual slots on the card unless the host
    has that many cards.  Returns (launches, runs, report, timed)."""
    import tempfile

    from cilium_tpu_torch.proxylib import instance as inst

    log("== mesh slice")
    t_phase = time.monotonic()
    inst.reset_module_registry()
    with tempfile.TemporaryDirectory(prefix="mesh-", dir=".") as tmp:
        out = _mesh_runs(dev, card, kerns, tmp)
    log(f"mesh slice: {time.monotonic() - t_phase:.1f} s")
    return out


def _mesh_runs(dev, card, kerns, tmp):
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.models.dns import build_dns_model
    from cilium_tpu_torch.models.http import build_http_model, build_http_model_for_port
    from cilium_tpu_torch.models.kafka import build_kafka_model
    from cilium_tpu_torch.models.r2d2 import build_r2d2_model, r2d2_verdicts
    from cilium_tpu_torch.ops.dfa import device_dfa, dfa_search_batch
    from cilium_tpu_torch.ops.seqdfa import (
        SEQ_AXIS,
        device_dfa_absorbing,
        seqdfa_search_batch,
        seqdfa_search_sharded,
    )
    from cilium_tpu_torch.parallel import rulesharding as rs
    from cilium_tpu_torch.parallel.mesh import Mesh, flow_mesh

    n_cards = torch.cuda.device_count()
    log(f"cards on this host: {n_cards}; meshes run on "
        + ("distinct cards where enough exist, else " if n_cards > 1 else "")
        + f"virtual slots on {dev}")

    def counts():
        return {n: (k.launches, k.replayed) for n, k in kerns.items()}

    def delta(before):
        now = counts()
        return {n: now[n][0] - before[n][0] + now[n][1] - before[n][1] for n in now}

    runs = {}

    def counted(name, fn):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        runs[name] = delta(before)
        return out

    def expect(name, **want):
        bad = {k: (runs[name][k], v) for k, v in want.items() if runs[name][k] != v}
        if bad:
            raise AssertionError(f"{name}: launches (got, want) {bad}")

    # Inputs and the single-device references, built before the count.
    r2d2_pol = entry.bench_policy()
    r2d2_in = tuple(torch.from_numpy(a).to(dev) for a in entry.batch(MESH_F, 64))
    http_pol = entry.http_bench_policy()
    http_in = tuple(torch.from_numpy(a).to(dev) for a in entry.http_batch(MESH_F))
    dns_pol = entry.dns_bench_policy()
    dns_in = tuple(torch.from_numpy(a).to(dev) for a in entry.dns_batch(MESH_F))
    k_rows = [(frozenset(), r) for r in entry.kafka_bench_rules()]
    k_batch, k_rem = entry.kafka_batch(MESH_F)
    k_batch = k_batch.to_device(dev)
    k_rem = torch.from_numpy(k_rem).to(dev)
    refs = {
        "r2d2": build_r2d2_model(r2d2_pol, True, 80, device=dev),
        "http": build_http_model_for_port(http_pol, True, 80, device=dev),
        "dns": build_dns_model(dns_pol, True, 53, device=dev),
    }
    want = {fam: (m(*inp), m.verdicts_attr(*inp)) for fam, m, inp in (
        ("r2d2", refs["r2d2"], r2d2_in), ("http", refs["http"], http_in),
        ("dns", refs["dns"], dns_in))}
    k_want = build_kafka_model(k_rows, dev)(k_batch, k_rem)
    rows100k = entry.rules_100k_rows()
    in100k = tuple(torch.from_numpy(a).to(dev) for a in entry.rules_100k_batch(MESH_100K_F, 64))
    t0 = time.monotonic()
    ref100k = build_http_model(rows100k, device=dev)
    t_ref100k = time.monotonic() - t0
    seq_tables = entry.seqdfa_tables()
    seq_cases = []
    for label, f, width in SEQ_SHAPES:
        d, ln = entry.seqdfa_batch(f, width, MESH_SEQ_SLOTS)
        seq_cases.append((label, torch.from_numpy(d).to(dev), torch.from_numpy(ln).to(dev)))
    seq_abs = device_dfa_absorbing(seq_tables, dev)
    seq_dfa = device_dfa(seq_tables, dev)
    fam_kernels = {
        "r2d2": ("r2d2_frame", "nfa_scan", "r2d2_hits"),
        "http": ("http_frame", "http_lit", "http_hits"),
        "dns": ("dns_name", "nfa_scan", "dns_hits"),
    }
    torch.cuda.synchronize()

    # The main path, counted: every count set to 0 just before, read just
    # after; a launch is a wrapper launch or a graph replay.
    log("== mesh main path (counted)")
    for k in kerns.values():
        k.launches = 0
        k.replayed = 0
    # 13b. dryrun_multichip, then the four mesh models at F = 65,536.
    passes, kafka_models = {}, {}
    for n_flow, n_rule in MESH_LAYOUTS:
        name = f"mesh-dryrun-{n_flow}x{n_rule}"
        got = counted(name, lambda: entry.dryrun_multichip(n_flow * n_rule, dev, n_rule=n_rule))
        log(f"{name}: {got}")
        slots, real = mesh_slots(dev, n_flow * n_rule)
        mesh = flow_mesh(n_flow, n_rule, slots)
        for fam, build, pol, inp in (
            ("r2d2", rs.mesh_r2d2_model, r2d2_pol, r2d2_in),
            ("http", rs.mesh_http_model, http_pol, http_in),
            ("dns", rs.mesh_dns_model, dns_pol, dns_in),
        ):
            model = build(pol, True, 53 if fam == "dns" else 80, mesh)
            if not isinstance(model, rs.ShardedVerdictModel):
                raise AssertionError(f"{fam}: no sharded model ({model!r})")
            run = f"mesh-{fam}-{n_flow}x{n_rule}"
            plain, attr = counted(run, lambda: (model(*inp), model.verdicts_attr(*inp)))
            mesh_equal(run, plain, want[fam][0])
            mesh_equal(run + " attr", attr, want[fam][1])
            per = 2 * n_flow * n_rule
            expect(run, shard_reduce=2 * n_flow, **{k: per for k in fam_kernels[fam]})
            passes[run] = (model, refs[fam], inp)
            log(f"{run}: plain and attributed == the single-device model on {MESH_F} flows "
                f"({'cards' if real else 'virtual slots'}); launches "
                + json.dumps({k: v for k, v in runs[run].items() if v}))
        kmodel = rs.mesh_kafka_model(k_rows, mesh)
        run = f"mesh-kafka-{n_flow}x{n_rule}"
        kafka_models[run] = kmodel
        got = counted(run, lambda: kmodel(k_batch, k_rem))
        mesh_equal(run, [got], [k_want])
        expect(run, kafka_hits=n_flow * n_rule, kafka_shard_combine=n_flow)
        log(f"{run}: == the single-device Kafka model on {MESH_F} requests")
    if n_cards >= 2:
        mesh = flow_mesh(1, 2, mesh_slots(dev, 2)[0])
        model = rs.mesh_r2d2_model(r2d2_pol, True, 80, mesh)
        got = counted("mesh-r2d2-cards", lambda: model.verdicts_attr(*r2d2_in))
        mesh_equal("mesh-r2d2-cards", got, want["r2d2"][1])
        log(f"mesh-r2d2-cards: 1 x 2 on {n_cards} cards == the single-device model")

    # 13c. rules_100k: 100,000 HTTP rules on 4 rule shards.
    slots, real100k = mesh_slots(dev, 4)
    t0 = time.monotonic()
    sharded100k = rs.mesh_http_model_from_rows(rows100k, flow_mesh(1, 4, slots))
    t_sh100k = time.monotonic() - t0
    got100k = counted("mesh-rules-100k", lambda: sharded100k(*in100k))
    expect("mesh-rules-100k", http_frame=4, http_lit=4, http_hits=4, shard_reduce=1)

    # 13d. multichip_scaling: r2d2 at 16,384 flows a slot, 1, 2 and 4 flow slots.
    scale_pol = entry.mesh_bench_policy()
    scale = {}
    for nd in (1, 2, 4):
        slots, _ = mesh_slots(dev, nd)
        model = rs.ShardedVerdictModel(
            rs.build_sharded_r2d2_model(scale_pol, True, 80, 1, device=slots[0].device),
            rs.shard_offsets(2, 1), flow_mesh(nd, 1, slots), "r2d2")
        f = MESH_SCALE_PER_SLOT * nd
        inp = tuple(torch.from_numpy(a).to(dev) for a in entry.mesh_bench_batch(f))
        got = counted(f"mesh-scaling-{nd}", lambda: model(*inp))
        expect(f"mesh-scaling-{nd}", r2d2_frame=nd, shard_reduce=nd)
        scale[nd] = (model, inp, got)

    # 13e. seqdfa_search_sharded at 8 seq slots.
    seq_slots, _ = mesh_slots(dev, MESH_SEQ_SLOTS)
    seq_mesh = Mesh(np.array(seq_slots, dtype=object), (SEQ_AXIS,))
    seq_got = {}
    for label, d, ln in seq_cases:
        run = f"mesh-seq-{label}"
        seq_got[label] = counted(run, lambda: seqdfa_search_sharded(seq_abs, d, ln, seq_mesh))
        expect(run, seqdfa_fold=MESH_SEQ_SLOTS, seqdfa_apply=1)

    # 13f. the mesh service through its width ladder: one counted run, as
    # its builder thread launches (reshape, parity probes) between rounds.
    counted("mesh-service", lambda: mesh_service(dev, card, tmp))
    idle = [n for n in ("r2d2_frame", "nfa_scan", "r2d2_hits", "dns_name", "dns_hits",
                        "http_frame", "http_lit", "http_hits", "gather_rows", "shard_reduce")
            if runs["mesh-service"][n] <= 0]
    if idle:
        raise AssertionError(f"mesh-service: kernels of the path never launched: {idle}")
    log("mesh-service launches: " + json.dumps({k: v for k, v in runs["mesh-service"].items() if v}))
    torch.cuda.synchronize()
    launches = {n: k.launches + k.replayed for n, k in kerns.items()}
    log("launches:", json.dumps({n: v for n, v in launches.items() if v}))
    for n, count in launches.items():
        if sum(r[n] for r in runs.values()) != count:
            raise AssertionError(f"{n}: the runs' launches do not add up to the mesh path's")
    for n in ("shard_reduce", "kafka_shard_combine"):
        if launches[n] <= 0:
            raise AssertionError(f"{n} never launched on the mesh path")

    # Checks and times of 13b-13e, after the count.
    for run, (model, ref_model, inp) in passes.items():
        t_mesh = graph_ms(lambda: model.verdicts_attr(*inp))
        t_one = graph_ms(lambda: ref_model.verdicts_attr(*inp))
        log(f"{run}: attributed pass device {t_mesh:.5f} ms against the single-card model's "
            f"{t_one:.5f} ms (x{t_mesh / t_one:.2f}) [{card}]")
        # the same sharded pass with the parent's kernels of its family
        # swapped in, in turns (--baseline-csrc)
        row = parent_turns(fam_kernels[run.split("-")[1]], lambda: model.verdicts_attr(*inp), {})
        if "turns" in row:
            log(f"{run}: attributed pass {turns_text(row['turns'])} with the parent's "
                f"{'/'.join(row['parent_stems'])} [{card}]")
    mesh_equal("mesh-rules-100k", got100k, ref100k(*in100k))
    if not (bool(got100k[2][1]) and not bool(got100k[2][0])):
        raise AssertionError("mesh-rules-100k: the HEAD probe must pass and PATCH fail")
    sh_p99, sh_rate = mesh_latencies(lambda: sharded100k(*in100k))
    un_p99, un_rate = mesh_latencies(lambda: ref100k(*in100k))
    sh_bytes = mesh_table_bytes(sharded100k.stacked)
    un_bytes = mesh_table_bytes([ref100k])
    log(f"mesh-rules-100k: {len(rows100k)} rules, F={MESH_100K_F} W=64, 4 rule shards "
        f"({'cards' if real100k else 'virtual slots'}): sharded == unsharded, got[1] and not "
        f"got[0]; p99 sharded {sh_p99:.4f} ms ({sh_rate * MESH_100K_F:,.0f} verdicts/s), "
        f"unsharded {un_p99:.4f} ms ({un_rate * MESH_100K_F:,.0f} verdicts/s); budget "
        f"{MESH_100K_BUDGET_MS} ms (asserted on 4 cards only); table bytes on the card: shards "
        f"{sh_bytes:,} ({sh_bytes // 4:,} a slot), unsharded {un_bytes:,}; host builds "
        f"sharded + fallback {t_sh100k:.1f} s, unsharded {t_ref100k:.1f} s [{card}]")
    from cilium_tpu_torch.models.http import (
        http_frame,
        http_frame_plain,
        http_hits,
        http_hits_plain,
        http_lit,
        http_lit_plain,
    )

    # K6 and K7 at rules_100k: shard 0 (the shape the counted run launched
    # on each of the 4 slots) and the unsharded table, against their plain
    # versions, then timed beside their bounds.
    report = {"http_lit": {}, "http_hits": {}, "shard_reduce": {}, "kafka_shard_combine": {},
              "http_frame": {}}
    timed = {}
    data100k = in100k[0]
    frame = http_frame(data100k, in100k[1])
    # K5 as each rule shard frames its flow block (beside the parent's in
    # turns, given --baseline-csrc)
    report["http_frame"]["mesh-rules-100k"] = max_abs_err(frame, http_frame_plain(*in100k[:2]))
    frame_row = k5_row(data100k, in100k[1], frame)
    for label, shape, m in (("shard 0", "mesh-rules-100k", sharded100k.stacked[0]),
                            ("unsharded", "mesh-rules-100k-unsharded", ref100k)):
        lit = http_lit(m, data100k, frame)
        args = (frame.complete, *lit, None, None, None, in100k[2])
        hits = http_hits(m, *args)
        report["http_lit"][shape] = max_abs_err(lit, http_lit_plain(m, data100k, frame))
        report["http_hits"][shape] = max_abs_err(hits, http_hits_plain(m, *args))
        k6 = lambda: http_lit(m, data100k, frame)  # noqa: E731
        k7 = lambda: http_hits(m, *args)  # noqa: E731
        rows = {
            "http_lit": dict(ms=graph_ms(k6, iters=10, replays=5), call_ms=cuda_ms(k6, 10),
                             plain_ms=cuda_ms(lambda: http_lit_plain(m, data100k, frame), 1),
                             **lit_counts(m, frame)),
            "http_hits": dict(ms=graph_ms(k7, iters=10, replays=5), call_ms=cuda_ms(k7, 10),
                              plain_ms=cuda_ms(lambda: http_hits_plain(m, *args), 1),
                              **hits_counts(m, args, hits)),
        }
        if label == "shard 0":
            rows["http_frame"] = frame_row
        timed[shape] = dict(rows=rows)
        runs.setdefault(shape, dict.fromkeys(kerns, 0))
        log(f"{shape} ({label}: {m.n_rules} rules, literal rows {m.m_needle.shape[0]} + "
            f"{m.p_needle.shape[0]}, F={MESH_100K_F}): max |kernel - plain| K6 "
            f"{report['http_lit'][shape]}, K7 {report['http_hits'][shape]}; main-path launches "
            f"K6 {runs[shape]['http_lit']}, K7 {runs[shape]['http_hits']} [{card}]")
        for kname, row in rows.items():
            log_row(shape, kname, bound(row))
    if real100k and n_cards >= 4 and sh_p99 > MESH_100K_BUDGET_MS:
        raise AssertionError(f"rules_100k sharded p99 {sh_p99:.3f} ms over the budget")
    ref = build_r2d2_model(scale_pol, True, 80, device=dev)
    curve = {}
    for nd, (model, inp, got) in scale.items():
        mesh_equal(f"mesh-scaling-{nd}", got, r2d2_verdicts(ref, *inp))
        curve[nd] = mesh_rate(lambda: model(*inp), MESH_SCALE_PER_SLOT * nd)
    linearity = curve[4] / (curve[1] * 4)
    log(f"multichip_scaling (r2d2, {MESH_SCALE_PER_SLOT} flows a slot, "
        f"{'cards' if n_cards >= 4 else 'virtual slots of one card'}): == the single-device "
        f"model at each point; " + ", ".join(f"{k} -> {v:,.0f}/s" for k, v in curve.items())
        + f"; linearity {linearity:.3f} (0.7 floor asserted on 4 cards only) [{card}]")
    if n_cards >= 4 and linearity < 0.7:
        raise AssertionError(f"multichip scaling {linearity:.2f} below 0.7")
    for label, d, ln in seq_cases:
        got = seq_got[label]
        if not (torch.equal(got, seqdfa_search_batch(seq_abs, d, ln, 1))
                and torch.equal(got, dfa_search_batch(seq_dfa, d, ln))):
            raise AssertionError(f"mesh-seq-{label}: sharded search != K18's serial search")
        t_sh = graph_ms(lambda: seqdfa_search_sharded(seq_abs, d, ln, seq_mesh), iters=3, replays=3)
        t_serial = graph_ms(lambda: seqdfa_search_batch(seq_abs, d, ln, 1), iters=3, replays=3)
        log(f"mesh-seq-{label}: {MESH_SEQ_SLOTS} slots == K18's serial search (and K2); device "
            f"{t_sh:.4f} ms against serial {t_serial:.4f} ms [{card}]")

    # K4 and K9 as rule shard 0 of the 1 x 4 r2d2 and DNS meshes walks its
    # rows (each slot's call recorded), against their plain versions (in
    # k4_row / k9_row) and timed.
    from cilium_tpu_torch.models import dns as dns_mod
    from cilium_tpu_torch.models import r2d2 as r2d2_mod

    for run, mod, stem, row_of in (("mesh-r2d2-1x4", r2d2_mod, "r2d2_hits", k4_row),
                                   ("mesh-dns-1x4", dns_mod, "dns_hits", k9_row)):
        model, _, inp = passes[run]
        calls = recorded_calls(mod, stem, lambda: model.verdicts_attr(*inp))
        if len(calls) != 4:
            raise AssertionError(f"{run}: {len(calls)} {stem} calls, one a rule shard expected")
        row = row_of(*calls[0])
        timed[run] = dict(rows={stem: row})
        log(f"{run} rule shard 0: {stem} at F={calls[0][1].shape[0]} R={calls[0][3].shape[1]}"
            if stem == "r2d2_hits" else
            f"{run} rule shard 0: {stem} at F={calls[0][1].dotted.shape[0]} R={calls[0][0].n_rules}")
        log_row(run, stem, row)

    # K17 as rule shard 0 of the 1 x 4 Kafka mesh takes its rows (parts=True),
    # against its plain versions (in k17_row) and timed.
    _, k_model, kb, kr, parts = kafka_mesh_shape(dev)
    row = k17_row(k_model, kb, kr, parts=parts)
    timed.setdefault("mesh-kafka-1x4", dict(rows={}))["rows"]["kafka_hits"] = row
    log(f"mesh-kafka-1x4 rule shard 0: kafka_hits at F={kb.api_key.shape[0]} R={k_model.n_rules}, "
        "parts=True")
    log_row("mesh-kafka-1x4", "kafka_hits", row)

    # 13a. K21 and K22 against their plain versions, then timed.
    log("== K21 / K22 vs plain and timed")
    g = torch.Generator(device="cpu").manual_seed(13)
    nomatch = torch.iinfo(torch.int32).max
    for r in MESH_K_RULES:
        f = MESH_F
        allow = (torch.rand((r, f), generator=g) < 0.3).to(dev)
        rule = torch.where(allow.cpu(), torch.randint(0, 1000, (r, f), generator=g,
                                                      dtype=torch.int32), -1).to(dev)
        ghost = (torch.rand((r, f), generator=g) < 0.05).to(dev)
        allow = allow | ghost
        rule = torch.where(ghost, torch.full_like(rule, -1), rule)
        off = (torch.arange(r, dtype=torch.int32) * 1000).to(dev)
        got_a, got_r = rs.shard_reduce(allow, rule, off)
        want_a, want_r = rs.shard_reduce_plain(allow, rule, off)
        got_p = rs.shard_reduce(allow)
        report["shard_reduce"][f"mesh-k21-R{r}"] = max_abs_err(
            [got_a, got_r, got_p], [want_a, want_r, rs.shard_reduce_plain(allow)])
        k21 = lambda: rs.shard_reduce(allow, rule, off)  # noqa: E731
        lib = lambda: torch.where(  # noqa: E731
            allow.any(dim=0),
            torch.where(rule >= 0, rule + off[:, None], nomatch).amin(dim=0), -1)
        row = dict(ms=graph_ms(k21), call_ms=cuda_ms(k21, 50),
                   plain_ms=cuda_ms(lambda: rs.shard_reduce_plain(allow, rule, off), 20),
                   library_ms=graph_ms(lib),
                   bytes=r * f + 4 * r * f + 4 * r + f + 4 * f, ops=2 * r * f)
        parent_turns("shard_reduce", k21, row)
        timed[f"mesh-k21-R{r}"] = dict(rows={"shard_reduce": bound(row)})
        runs[f"mesh-k21-R{r}"] = dict.fromkeys(kerns, 0)
        log_row(f"mesh-k21-R{r}", "shard_reduce", row)
        k21p = lambda: rs.shard_reduce(allow)  # noqa: E731
        anyp = lambda: allow.any(dim=0)  # noqa: E731
        # K21's plain form and torch.any in turns (k, a, a, k, k, a): the
        # spread of each is the spread of its three readings
        turns = in_turns(k21p, anyp)
        turns = {"k": turns["n"], "a": turns["o"]}
        prow = dict(ms=min(turns["k"]), call_ms=cuda_ms(k21p, 50),
                    plain_ms=cuda_ms(lambda: rs.shard_reduce_plain(allow), 20),
                    library_ms=min(turns["a"]), bytes=r * f + f, ops=r * f)
        timed[f"mesh-k21plain-R{r}"] = dict(rows={"shard_reduce": bound(prow)})
        runs[f"mesh-k21plain-R{r}"] = dict.fromkeys(kerns, 0)
        log_row(f"mesh-k21plain-R{r}", "shard_reduce", prow)
        log(f"mesh-k21plain-R{r}: K21 plain form "
            + ", ".join(f"{t:.5f}" for t in turns["k"]) + " ms against torch.any "
            + ", ".join(f"{t:.5f}" for t in turns["a"]) + f" ms (in turns k a a k k a; medians "
            + f"{sorted(turns['k'])[1]:.5f} / {sorted(turns['a'])[1]:.5f}) [{card}]")

    for r in MESH_K22_RULES:
        f = MESH_F
        simple = (torch.rand((r, f), generator=g) < 0.1).to(dev)
        cover = (torch.rand((r, f, 8), generator=g) < 0.7).to(dev)
        tc = torch.randint(0, 10, (f,), generator=g, dtype=torch.int32).to(dev)
        ov = (torch.rand(f, generator=g) < 0.1).to(dev)
        k22_row(f"mesh-k22-R{r}", (simple, cover, tc, ov), card, report["kafka_shard_combine"], timed)
        runs[f"mesh-k22-R{r}"] = dict.fromkeys(kerns, 0)
    # K22 on the main path's own call: the 1 x 4 Kafka mesh's merge (R = 4,
    # F = 65,536, bench_kafka's requests), recorded.
    calls = recorded_calls(rs, "kafka_shard_combine",
                           lambda: kafka_models["mesh-kafka-1x4"](k_batch, k_rem))
    if len(calls) != 1:
        raise AssertionError(f"mesh-kafka-1x4: {len(calls)} kafka_shard_combine calls, one expected")
    k22_row("mesh-kafka-1x4", calls[0][:4], card, report["kafka_shard_combine"], timed)
    combine_boundary(dev, report["kafka_shard_combine"])
    # The main path's own shapes (R = 4, F = 65,536 on the 1 x 4 mesh).
    timed["mesh-r2d2-1x4"]["rows"]["shard_reduce"] = timed["mesh-k21-R4"]["rows"]["shard_reduce"]
    log("max |kernel - plain|:", json.dumps(report))
    if any(v for per in report.values() for v in per.values()):
        raise AssertionError("K6 / K7 / K21 / K22 disagree with their plain versions")
    return launches, runs, report, timed


def mesh_service(dev, card, tmp):
    """13f: a mesh="on", mesh_rule_shards=2 service on 4 slots (a 2 x 2
    mesh) serving phase 9's seeded r2d2, DNS and HTTP traffic against the
    host oracle, through a fault on slot 1 (the ``failed_devices`` seam),
    the reshape onto the survivors and the re-promotion after heal."""
    from cilium_tpu_torch.parallel import mesh as mesh_mod
    from cilium_tpu_torch.parallel import rulesharding as rs
    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.proxylib.types import FilterResult
    from cilium_tpu_torch.sidecar import SidecarClient, VerdictService

    slots = mesh_mod.virtual_devices(4, dev)
    pols = sidecar_policies()
    traffic = sidecar_traffic()
    traffic = {
        "r2d2": (r2d2_side_rounds(random.Random(41), SIDE_CONNS["r2d2"], n_rounds=4),
                 traffic["r2d2"][1]),
        "dns": traffic["dns"], "http": traffic["http"],
    }
    expect = {p: sidecar_oracle(p, traffic[p][0], pols) for p in traffic}
    inst.reset_module_registry()
    orig_local = mesh_mod.local_devices
    orig_calls = {n: getattr(rs.ShardedVerdictModel, n) for n in ("__call__", "verdicts_attr")}
    armed = {"on": False}

    class SlotLost(RuntimeError):
        pass

    def faulty(name):
        def call(self, *a):
            if armed["on"]:
                armed["on"] = False
                exc = SlotLost("planted fault: copy to slot 1 failed")
                exc.failed_devices = [1]
                raise exc
            return orig_calls[name](self, *a)
        return call

    mesh_mod.local_devices = lambda device=None: slots
    for n in orig_calls:
        setattr(rs.ShardedVerdictModel, n, faulty(n))
    path = f"{tmp}/mesh.sock"
    svc = driver = pacer = None
    try:
        svc = VerdictService(path, side_config(
            mesh="on", mesh_rule_shards=2, dispatch_mode="eager", mesh_reprobe_interval_s=0.05,
            device_reprobe_interval_s=1e9)).start()
        driver = SidecarDriver(path, "socket", pols)
        opened = {p: driver.open(p, traffic[p][0]) for p in traffic}
        st = svc.status()["mesh"]
        if st is None or st["rung"] != "full" or st["devices"] != 4:
            raise AssertionError(f"mesh service did not resolve a full 2 x 2 mesh: {st}")
        sharded = [k[-1] for k, e in svc._engines.items()
                   if isinstance(e.model, rs.ShardedVerdictModel)]
        if sorted(set(sharded)) != ["dns", "http", "r2d2"]:
            raise AssertionError(f"engines serving sharded models: {sharded}")
        got = {p: [] for p in traffic}

        def stage(k):
            for p, (rounds, group) in traffic.items():
                if k < len(rounds):
                    got[p] += driver.run(p, rounds[k:k + 1], group)

        def await_rung(rung, pace=False):
            deadline = time.monotonic() + 60
            i = 0
            while svc.status()["mesh"]["rung"] != rung:
                if time.monotonic() > deadline:
                    raise AssertionError(f"rung {rung} never reached: {svc.status()['mesh']}")
                if pace:
                    res, shim = pacer.new_connection(pmod, "r2d2", 9_000_000 + i, True, 3, 2,
                                                     "1.1.1.1:1", "2.2.2.2:80", SIDE_NAMES["r2d2"])
                    if res != int(FilterResult.OK) or shim.on_io(False, b"HALT\r\n") != (
                            int(FilterResult.OK), b"HALT\r\n"):
                        raise AssertionError("pacing traffic was not served")
                    shim.close()
                    i += 1
                time.sleep(0.05)
            return svc.status()["mesh"]

        stage(0)
        armed["on"] = True
        svc._device_probe_fn = lambda d: d.id != 1
        stage(1)
        if armed["on"]:
            raise AssertionError("the planted fault never fired")
        st = await_rung("reshaped")
        if st["lost_devices"] != [1] or st["demotions"] != {"device-call": 1}:
            raise AssertionError(f"unexpected reshape: {st}")
        log(f"mesh service: fault on slot 1 -> demoted typed, reshaped to "
            f"{st['serving_devices']} slots (capacity {st['capacity_frac']}), window "
            f"{st['reshape_window_ms']:.1f} ms")
        stage(2)
        svc._device_probe_fn = lambda d: True
        pacer = SidecarClient(path, timeout=120.0)
        pmod = pacer.open_module([])
        pacer.policy_update(pmod, pols)
        st = await_rung("full", pace=True)
        if st["repromotions"] != 1:
            raise AssertionError(f"unexpected re-promotion: {st}")
        stage(3)
        bad = {p: side_mismatches(got[p], expect[p]) for p in traffic}
        if any(bad.values()):
            raise AssertionError(f"mesh service ops differ from the host oracle: {bad}")
        c = svc.status()["containment"]
        if c["shed_entries"] or c["error_entries"] or c["batch_crashes"] or c["refused_entries"]:
            raise AssertionError(f"mesh service lost entries: {c}")
        for p, fids in opened.items():
            driver.close(p, fids)
        log(f"mesh service (2 x 2 virtual slots): r2d2 {len(expect['r2d2'])}, DNS "
            f"{len(expect['dns'])}, HTTP {len(expect['http'])} rounds == the host oracle through "
            f"full -> fallback -> reshaped -> full; containment clean [{card}]")
    finally:
        mesh_mod.local_devices = orig_local
        for n, fn in orig_calls.items():
            setattr(rs.ShardedVerdictModel, n, fn)
        for c in (driver, pacer):
            if c is not None:
                c.close_client() if hasattr(c, "close_client") else c.close()
        if svc is not None:
            svc.stop()
        inst.reset_module_registry()


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
    t_ops = row["ops"] / INT32_OPS_PER_S
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


def lit_counts(model, frame):
    """K6's bytes and ops: the span bytes it compares (at most LIT_W a
    slot), the spans, the literal tables once and the two [F, R] outputs;
    one op per needle byte of every live row whose length test passes."""
    from cilium_tpu_torch.models.http import LIT_W

    f, r = frame.sp1.shape[0], model.n_rules
    m_len = frame.sp1.clamp(min=0)
    p_len = (frame.sp2 - frame.p_start).clamp(min=0)
    ops = 0
    for slen, slot in ((m_len, "m"), (p_len, "p")):
        nlen = getattr(model, f"{slot}_len").to(torch.int64)
        live = getattr(model, f"{slot}_live")
        pre = getattr(model, f"{slot}_prefix")
        for f0 in range(0, f, 256):  # [256, N] at a time: N is 100,000 at rules_100k
            sl = slen[f0:f0 + 256, None]
            ok = torch.where(pre[None, :], sl >= nlen[None, :], sl == nlen[None, :]) & live[None, :]
            ops += int((ok * nlen[None, :]).sum())
    read = int(m_len.clamp(max=LIT_W).sum() + p_len.clamp(max=LIT_W).sum())
    tables = sum(getattr(model, f"{s}_needle").numel() + 10 * getattr(model, f"{s}_len").numel()
                 for s in ("m", "p")) + 2 * r
    return dict(bytes=read + 16 * f + tables + 2 * f * r, ops=ops)


def hits_counts(model, args, hits):
    """K7's bytes and ops over the rows its walk must visit (up to the
    first that holds, all of them where none does, none on an incomplete
    head): the method_ok bytes of those rows, the path_ok bytes where the
    method holds, the automaton hit columns, the [F] inputs and outputs,
    and each rule's table entries once where the walk reads them (its
    method or path pattern list where that byte is false and the patterns
    are given, its head list and count where method and path hold, its
    remote flag where all three hold and its remote set where that flag
    is false); two tests a row visited, the 32 remote compares only where
    method, path and head hold."""
    from cilium_tpu_torch.models.http import _scatter_or

    complete, method_ok, path_ok, rx_m, rx_p, head_hits, _ = args
    f, r = method_ok.shape
    m_byte, p_byte = method_ok, path_ok
    is_m = model.line_slot == 0
    if rx_m is not None:
        method_ok = method_ok | _scatter_or(rx_m & is_m[None, :], model.line_rule, r)
    if rx_p is not None:
        path_ok = path_ok | _scatter_or(rx_p & ~is_m[None, :], model.line_rule, r)
    need = torch.where(hits[0], hits[1] + 1, torch.where(
        complete, torch.full_like(hits[1], r), torch.zeros_like(hits[1])))
    walked = torch.arange(r, device=need.device)[None, :] < need[:, None]
    m_walked = walked & method_ok
    mph = m_walked & path_ok
    if head_hits is not None:
        per_rule = torch.zeros((f, r), dtype=torch.int32, device=head_hits.device)
        per_rule.index_add_(1, model.head_rule.long(), head_hits.to(torch.int32))
        mph &= per_rule >= model.head_count[None, :]
    cols = sum(t.shape[1] for t in (rx_m, rx_p, head_hits) if t is not None)
    n_walked, n_m, n_mph = int(walked.sum()), int(m_walked.sum()), int(mph.sum())

    def lists(rows, ptr):  # the rules some flow reads: a pointer and the indices each
        rules = rows.any(0)
        return 4 * int(rules.sum()) + 4 * int((ptr[1:] - ptr[:-1])[rules].sum())

    tables = 0
    if rx_m is not None:
        tables += lists(walked & ~m_byte, model.csr["m_ptr"])
    if rx_p is not None:
        tables += lists(m_walked & ~p_byte, model.csr["p_ptr"])
    if head_hits is not None:
        mp = m_walked & path_ok
        tables += lists(mp, model.csr["h_ptr"]) + 4 * int(mp.any(0).sum())
    held = mph.any(0)
    tables += int(held.sum()) + 4 * 32 * int((held & ~model.any_remote).sum())
    return dict(
        bytes=n_walked + n_m + f * cols + f + 4 * f + 5 * f + tables,
        ops=2 * n_walked + 32 * n_mph + f * cols,
    )


# --- phase 14: the policy plane --------------------------------------------------

POLICY_PERIOD = 4096  # the passes' batches repeat every 4,096 rows
POLICY_L = 512  # bench_http's width
POLICY_ENGINE_FLOWS = 4096
POLICY_NPDS_RULES = 128
POLICY_NPDS_ENDPOINTS = 64
POLICY_NPDS_CONNS = 256
POLICY_NPDS_BASE = 7_000_000
POLICY_WORLD = (1000, 20, 0.35)  # entry.policy_rules(n_rules, seed, broad) of the slice


class _RecordCounter:
    """An access logger that counts the records the engines write."""

    def __init__(self):
        self.records = 0

    def log(self, record):
        self.records += 1


class PolicyDaemon:
    """What ``create_engine_for_redirect`` reads of a daemon: the identity
    cache ({numeric: Labels}, as ``Daemon.get_identity_cache`` returns it),
    an access logger, the port's ``Monitor``, a flow log that feeds it
    POLICY-VERDICT events, and a config with ``flow_cache`` and ``mesh``
    (``verdict_device`` "cpu" for the CPU path; ``verdict_mesh`` set for
    the mesh branch)."""

    def __init__(self, cache, device="default", mesh=None):
        from cilium_tpu_torch.flowlog import FlowLog
        from cilium_tpu_torch.monitor import Monitor
        from cilium_tpu_torch.utils.option import OPTION_POLICY_VERDICT_NOTIFY, DaemonConfig, OptionMap

        self.cache = cache
        self.config = DaemonConfig(verdict_device=device, mesh="off", flow_cache=False)
        self.access_logger = _RecordCounter()
        self.monitor = Monitor(queue_size=1 << 16)
        self.events = []
        self.monitor.add_listener(self.events.append, queued=False)
        opts = OptionMap()
        opts.set(OPTION_POLICY_VERDICT_NOTIFY, True)
        self.flowlog = FlowLog(capacity=1 << 20, opts=opts, monitor=self.monitor)
        if mesh is not None:
            self.verdict_mesh = mesh

    def get_identity_cache(self):
        return self.cache


def policy_world(n_rules, seed, broad):
    """(identities, repository, identity cache) of ``entry``'s policy
    slice: the rules loaded from their JSON document and added (``add``
    sanitizes)."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.labels import Labels
    from cilium_tpu_torch.policy import Repository, rules_from_json

    ids = entry.policy_identities()
    repo = Repository()
    for rule in rules_from_json(json.dumps(entry.policy_rules(n_rules, seed, broad))):
        repo.add(rule)
    return ids, repo, {n: Labels.from_model(lbls) for n, lbls in ids.items()}


def policy_endpoint(ep_id, numeric, repo, cache):
    """A stand-in endpoint as ``network_policy_for_endpoint`` reads one:
    its id, address, identity and resolved ingress policy."""
    from types import SimpleNamespace

    from cilium_tpu_torch.policy import L4Policy, SearchContext

    l4 = repo.resolve_l4_ingress_policy(SearchContext(to_labels=cache[numeric].to_array()))
    return SimpleNamespace(id=ep_id, ipv4=f"10.20.{ep_id // 250}.{ep_id % 250 + 1}",
                           security_identity=SimpleNamespace(id=numeric),
                           desired_l4_policy=L4Policy(ingress=l4))


def policy_remotes(rng, ids, n):
    """``n`` remote identities: the slice's identities and, one time in
    sixteen, one that no cache holds."""
    pool = sorted(ids)
    return [rng.choice(pool) if rng.random() < 15 / 16 else 99_999 for _ in range(n)]


def policy_http_feeds(rng, ids, n_flows):
    """Three rounds of (flow, chunk, remote): 1-3 of the slice's request
    heads a flow, every 8th with a body, cut at two random points."""
    from cilium_tpu_torch import entry

    heads = entry.policy_http_requests(1024, seed=25)
    rounds = [[], [], []]
    for fid, remote in enumerate(policy_remotes(rng, ids, n_flows)):
        stream = b""
        for _ in range(rng.randrange(1, 4)):
            head = rng.choice(heads)
            if fid % 8 == 0:
                body = b"x" * rng.randrange(1, 64)
                head = head[:-2] + b"Content-Length: %d\r\n\r\n" % len(body) + body
            stream += head
        cut1 = rng.randrange(0, len(stream) + 1)
        cut2 = rng.randrange(cut1, len(stream) + 1)
        for rnd, chunk in zip(rounds, (stream[:cut1], stream[cut1:cut2], stream[cut2:])):
            rnd.append((fid, chunk, remote))
    return rounds


def policy_kafka_feeds(rng, ids, n_flows):
    """Three rounds of (flow, chunk, remote): 1-2 of the slice's Kafka
    frames a flow, cut at two random points."""
    from cilium_tpu_torch import entry

    frames = entry.policy_kafka_frames(1024, seed=26)
    rounds = [[], [], []]
    for fid, remote in enumerate(policy_remotes(rng, ids, n_flows)):
        stream = b"".join(rng.choice(frames) for _ in range(rng.randrange(1, 3)))
        cut1 = rng.randrange(0, len(stream) + 1)
        cut2 = rng.randrange(cut1, len(stream) + 1)
        for rnd, chunk in zip(rounds, (stream[:cut1], stream[cut1:cut2], stream[cut2:])):
            rnd.append((fid, chunk, remote))
    return rounds


def fresh_engine(eng):
    """A new engine of ``eng``'s class on the same model and sinks."""
    from cilium_tpu_torch.runtime.engines import HttpBatchEngine

    kw = dict(logger=eng.logger, monitor=eng.monitor, flowlog=eng.flowlog)
    if isinstance(eng, HttpBatchEngine):
        return HttpBatchEngine(eng.model, cache_enabled=eng.cache_enabled, **kw)
    return type(eng)(eng.model, host_rows=eng.host_rows, **kw)


def policy_matching_head(http_rule: dict) -> bytes:
    """A request head an NPDS HTTP rule allows."""
    path = http_rule["path"].replace("v[0-9]+", "v2").replace(".*", "item")
    head = f"{http_rule['method']} {path} HTTP/1.1\r\nHost: svc.local\r\n"
    return (head + "".join(f"{h}\r\n" for h in http_rule["headers"]) + "\r\n").encode()


def policy_npds_traffic(rng, eps, pols, ids):
    """{conn: policy name} and three rounds of (conn, bytes, remote, reply)
    for ``POLICY_NPDS_CONNS`` HTTP conns, four on each endpoint's policy:
    every other conn's remote one that a rule of its endpoint names, and
    each round 1-2 request heads a conn, the slice's requests or heads
    that one of the endpoint's rules allows."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.proxy.npds_push import endpoint_policy_name

    heads = entry.policy_http_requests(512, seed=27)
    names, remotes, rules = {}, {}, {}
    pool = sorted(ids) + [99_999]
    for fid in range(POLICY_NPDS_CONNS):
        i = fid % len(eps)
        names[fid] = endpoint_policy_name(eps[i])
        rules[fid] = [r for pp in pols[i].ingress_per_port_policies for r in pp.rules if r.http_rules]
        named = [x for r in rules[fid] for x in r.remote_policies]
        remotes[fid] = rng.choice(named) if fid % 2 and named else rng.choice(pool)

    def head(fid):
        if rules[fid] and rng.random() < 0.5:
            return policy_matching_head(rng.choice(rng.choice(rules[fid]).http_rules))
        return rng.choice(heads)

    rounds = [[(fid, b"".join(head(fid) for _ in range(rng.randrange(1, 3))), remotes[fid], False)
               for fid in names] for _ in range(3)]
    return names, rounds


def npds_serve(path, cfg, eps, cache, names, rounds, counted=None):
    """Start a ``VerdictService``, push every endpoint's NPDS policy through
    ``NpdsPusher`` (one full-state push an endpoint), open the conns on
    their endpoints' policies and drive the rounds over the socket; stop
    it.  ``counted(phase)`` is called with "before" and "after" around the
    drive.  Returns (per-round {conn: (ops, orig inject, reply inject)},
    pushes, service status)."""
    from cilium_tpu_torch.proxy.npds_push import NpdsPusher
    from cilium_tpu_torch.sidecar import VerdictService

    svc = VerdictService(path, cfg).start()
    pusher = driver = None
    try:
        pusher = NpdsPusher(path, ack_timeout=120.0)
        for ep in eps:
            if not pusher.upsert(ep, cache):
                raise AssertionError(f"NPDS push for endpoint {ep.id} NACKed")
        driver = SidecarDriver(path, "socket", None, base_shift=POLICY_NPDS_BASE - SIDE_BASES["http"])
        fids = driver.open("http", rounds, names=names)
        if counted:
            counted("before")
        out = driver.run("http", rounds, lambda fid: 0)
        if counted:
            counted("after")
        driver.close("http", fids)
        return out, pusher.pushes, svc.status()
    finally:
        if driver is not None:
            driver.close_client()
        if pusher is not None:
            pusher.close()
        svc.stop()


def policy_slice(dev, card, kerns):
    """Phase 14, the policy plane on the card, counted in a run of its own
    over every kernel (a launch is a wrapper launch or a graph replay).
    Returns (launches, runs, span_runs, report, timed)."""
    import tempfile

    from cilium_tpu_torch.proxylib import instance as inst

    log("== policy slice")
    t_phase = time.monotonic()
    inst.reset_module_registry()
    with tempfile.TemporaryDirectory(prefix="policy-", dir=".") as tmp:
        out = _policy_runs(dev, card, kerns, tmp)
    inst.reset_module_registry()
    log(f"policy slice: {time.monotonic() - t_phase:.1f} s")
    return out


def _policy_runs(dev, card, kerns, tmp):
    import statistics

    from cilium_tpu_torch import entry
    from cilium_tpu_torch.kafka import matches_rule, parse_request
    from cilium_tpu_torch.models import http as http_mod
    from cilium_tpu_torch.models.http import (
        HttpBatchModel,
        http_frame,
        http_frame_plain,
        http_hits,
        http_hits_plain,
        http_lit,
        http_lit_plain,
        http_verdicts_attr,
    )
    from cilium_tpu_torch.models.kafka import (
        KafkaBatchModel,
        encode_requests,
        kafka_hits,
        kafka_verdicts,
        kafka_verdicts_plain,
    )
    from cilium_tpu_torch.monitor.monitor import MSG_TYPE_POLICY_VERDICT
    from cilium_tpu_torch.ops import dfa as dfa_mod
    from cilium_tpu_torch.ops import nfa as nfa_mod
    from cilium_tpu_torch.ops.dfa import DeviceDfa
    from cilium_tpu_torch.parallel import rulesharding as rs_mod
    from cilium_tpu_torch.parallel.mesh import flow_mesh
    from cilium_tpu_torch.parallel.rulesharding import ShardedKafkaModel, ShardedVerdictModel
    from cilium_tpu_torch.policy import SearchContext, proxy_id
    from cilium_tpu_torch.proxy import ProxyManager
    from cilium_tpu_torch.proxy.npds_push import network_policy_for_endpoint
    from cilium_tpu_torch.proxylib import compile_policy
    from cilium_tpu_torch.runtime.engines import HttpBatchEngine, KafkaBatchEngine, create_engine_for_redirect
    from cilium_tpu_torch.runtime.engines_util import kafka_host_rows
    from cilium_tpu_torch.utils import metrics

    scans = {"dfa_scan": (dfa_mod.dfa_search_spans, dfa_mod.dfa_scan_plain),
             "nfa_scan": (nfa_mod.nfa_search_spans, nfa_mod.nfa_scan_plain)}

    def scan_kernel(tab):
        return "dfa_scan" if isinstance(tab, DeviceDfa) else "nfa_scan"

    # the configuration: 512 identities, 1,000 rules, ingress resolved for
    # the identity the most rules select
    ids, repo, cache = policy_world(*POLICY_WORLD)
    dst = entry.policy_destination(ids, entry.policy_rules(*POLICY_WORLD))
    ctx = SearchContext(to_labels=cache[dst].to_array())
    resolve_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        l4 = repo.resolve_l4_ingress_policy(ctx)
        resolve_ms.append((time.perf_counter() - t0) * 1e3)
    ep = policy_endpoint(1, dst, repo, cache)  # resolves once more, untimed
    l4 = ep.desired_l4_policy.ingress
    f_http, f_kafka = l4["80/TCP"], l4["9092/TCP"]
    log(f"policy-1000: {repo.num_rules()} rules, {len(ids)} identities, destination {dst} "
        f"{sorted(cache[dst].get_model())}; ingress ports {sorted(l4)}; 80/TCP {len(f_http.l7_rules_per_ep)} "
        f"selectors, 9092/TCP {len(f_kafka.l7_rules_per_ep)}; resolve_l4_ingress_policy "
        f"{statistics.median(resolve_ms):.2f} ms (median of 5, host clock) [{card}]")
    # the destination's NPDS rendering: the HTTP host oracle's policy
    oracle_policy = compile_policy(network_policy_for_endpoint(ep, cache))
    host_rows = kafka_host_rows(f_kafka, cache)

    # the engines through ProxyManager -> create_engine_for_redirect, on the
    # card, at device="cpu" and on the 1 x 4 mesh
    slots, distinct = mesh_slots(dev, 4)
    mesh = flow_mesh(1, 4, slots)
    daemons = {"card": PolicyDaemon(cache), "cpu": PolicyDaemon(cache, device="cpu"),
               "mesh": PolicyDaemon(cache, mesh=mesh)}
    managers = {k: ProxyManager(create_backend=lambda r, d=d: create_engine_for_redirect(d, r))
                for k, d in daemons.items()}
    redirects, build_ms = {}, {}
    for k, pm in managers.items():
        for f in (f_http, f_kafka):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = pm.create_or_update_redirect(f, proxy_id(1, True, "TCP", f.port), 1)
            torch.cuda.synchronize()
            build_ms[(k, f.port)] = (time.perf_counter() - t0) * 1e3
            redirects[(k, f.port)] = r.implementation
    want_types = {80: (HttpBatchEngine, HttpBatchModel, ShardedVerdictModel),
                  9092: (KafkaBatchEngine, KafkaBatchModel, ShardedKafkaModel)}
    for (k, port), eng in redirects.items():
        e_cls, m_cls, s_cls = want_types[port]
        if type(eng) is not e_cls or not isinstance(eng.model, s_cls if k == "mesh" else m_cls):
            raise AssertionError(f"{k} {port}: engine {type(eng).__name__} on {type(eng.model).__name__}")
        if eng.monitor is not daemons[k].monitor or eng.capacity != 2048:
            raise AssertionError(f"{k} {port}: the engine lacks the daemon's monitor or capacity 2,048")
    model, kmodel = redirects[("card", 80)].model, redirects[("card", 9092)].model
    cpu_model, cpu_kmodel = redirects[("cpu", 80)].model, redirects[("cpu", 9092)].model
    mesh_model = redirects[("mesh", 80)].model
    shard_states = [(m.line_nfa.n_states, [p.n_states for p, _ in m.line_nfa.scan_parts],
                     m.head_nfa.n_states if m.head_nfa is not None else 0) for m in mesh_model.stacked]
    log(f"policy-1000: 1 x 4 mesh shards' NFAs (line states, K3 parts, head states): {shard_states}")
    if model.n_rules < 1000 or kmodel.n_rules < 200:
        raise AssertionError(f"rows {model.n_rules} HTTP / {kmodel.n_rules} Kafka, below 1,000 / 200")
    log(f"policy-1000: port 80 -> {model.n_rules} HTTP rows (line automaton "
        f"{type(model.line_nfa).__name__}, head {type(model.head_nfa).__name__}), port 9092 -> "
        f"{kmodel.n_rules} Kafka rows; create_or_update_redirect (model build + engine) ms: "
        + ", ".join(f"{k} {p} {ms:.1f}" for (k, p), ms in build_ms.items()) + f" (host clock) [{card}]")

    # the passes' batches: POLICY_PERIOD requests and remotes, cycled to F
    rng = random.Random(28)
    heads = entry.policy_http_requests(POLICY_PERIOD)
    rem = policy_remotes(rng, ids, POLICY_PERIOD)
    hdata, hlen, hrem = tile_heads(heads, rem, F, POLICY_L)
    h_dev = tuple(torch.from_numpy(a).to(dev) for a in (hdata, hlen, hrem))
    kreqs = [parse_request(fr) for fr in entry.policy_kafka_frames(POLICY_PERIOD)]
    krem = np.asarray(policy_remotes(rng, ids, POLICY_PERIOD), np.int32)
    kbatch = encode_requests([kreqs[i % POLICY_PERIOD] for i in range(F)])
    kremotes = np.resize(krem, F)
    k_dev, krem_dev = kbatch.to_device(dev), torch.from_numpy(kremotes).to(dev)
    if kbatch.overflow.any():
        raise AssertionError("policy-kafka: the batch overflows")
    hfeeds = policy_http_feeds(random.Random(29), ids, POLICY_ENGINE_FLOWS)
    kfeeds = policy_kafka_feeds(random.Random(30), ids, POLICY_ENGINE_FLOWS)
    npds_ids, npds_repo, npds_cache = policy_world(POLICY_NPDS_RULES, 23, 0.0)
    eps = [policy_endpoint(i + 1, n, npds_repo, npds_cache)
           for i, n in enumerate(sorted(npds_ids)[:: len(npds_ids) // POLICY_NPDS_ENDPOINTS])]
    pols = [network_policy_for_endpoint(e, npds_cache) for e in eps]
    names, nrounds = policy_npds_traffic(random.Random(31), eps, pols, npds_ids)
    n_npds_rules = sum(len(r.http_rules) for p in pols for pp in p.ingress_per_port_policies for r in pp.rules)
    log(f"policy-npds: {POLICY_NPDS_RULES} rules without 128-identity sources (a verdict service's "
        f"model takes at most 32 remotes a rule), {len(eps)} endpoints, {n_npds_rules} HTTP rules "
        f"rendered, {POLICY_NPDS_CONNS} conns x {len(nrounds)} rounds")

    # the main path, counted
    log("== policy main path (counted)")

    def counts():
        return {n: k.launches + k.replayed for n, k in kerns.items()}

    def delta(before):
        now = counts()
        return {n: now[n] - before[n] for n in kerns}

    span_runs = {}
    current = {"line_calls": 0}
    search = http_mod.automaton_search_spans

    def counted_search(tab, data, start, end):
        before = counts()
        out = search(tab, data, start, end)
        if tab is model.head_nfa:
            span = "head"
        else:  # the reference searches the method span before the path
            span = "method" if model.has_method_rx and not current["line_calls"] else "path"
            current["line_calls"] += 1
        run = span_runs.setdefault(f"policy-http:{span}", dict.fromkeys(kerns, 0))
        for n, d in delta(before).items():
            run[n] += d
        return out

    def drive(eng, feeds):
        return run_l7_engine(lambda: eng, feeds)[0]

    # the mesh runs' K21 / K22 inputs, held against the plain versions below
    merges = {"shard_reduce": [], "kafka_shard_combine": []}
    merge_fns = {n: getattr(rs_mod, n) for n in merges}

    def recording(name):
        def call(*args):
            merges[name].append(args)
            return merge_fns[name](*args)
        return call

    npds_before = {}

    def npds_counted(phase):
        if phase == "before":
            npds_before.update(counts())
        else:
            runs["policy-npds"] = delta(npds_before)

    for k in kerns.values():
        k.launches = 0
        k.replayed = 0
    runs = {}
    before = counts()
    http_mod.automaton_search_spans = counted_search
    try:
        h_out = http_verdicts_attr(model, *h_dev)
    finally:
        http_mod.automaton_search_spans = search
    runs["policy-http"] = delta(before)
    before = counts()
    k_out = kafka_verdicts(kmodel, k_dev, krem_dev)
    runs["policy-kafka"] = delta(before)
    eng_out = {}
    for port, feeds, label in ((80, hfeeds, "policy-http-engine"), (9092, kfeeds, "policy-kafka-engine")):
        before = counts()
        eng_out[label] = drive(redirects[("card", port)], feeds)
        runs[label] = delta(before)
    demoted = metrics.MeshDemotions.get("engine-judge")
    for n in merges:
        setattr(rs_mod, n, recording(n))
    try:
        before = counts()
        mh_out = mesh_model.verdicts_attr(*h_dev)
        runs["policy-mesh-http"] = delta(before)
        before = counts()
        mk_out = redirects[("mesh", 9092)].model(k_dev, krem_dev)
        runs["policy-mesh-kafka"] = delta(before)
        before = counts()
        mesh_eng = drive(redirects[("mesh", 80)], hfeeds)
        runs["policy-mesh-engine"] = delta(before)
    finally:
        for n, fn in merge_fns.items():
            setattr(rs_mod, n, fn)
    # the engine judged every round on the mesh: a sharded dispatch that
    # raised would have swapped in its single-card fallback
    if redirects[("mesh", 80)].model is not mesh_model or metrics.MeshDemotions.get("engine-judge") != demoted:
        raise AssertionError("policy-mesh-engine: the engine was demoted to its single-card fallback")
    if runs["policy-mesh-engine"]["shard_reduce"] != len(merges["shard_reduce"]) - 1:
        raise AssertionError("policy-mesh-engine: K21 launches differ from the engine's sharded steps")
    npds_card, pushes, npds_status = npds_serve(f"{tmp}/npds.sock", side_config(), eps, npds_cache,
                                                names, nrounds, counted=npds_counted)
    torch.cuda.synchronize()
    launches = {n: sum(r[n] for r in runs.values()) for n in kerns}
    log("launches:", json.dumps({n: v for n, v in launches.items() if v}))
    log("launches by run:", json.dumps({n: {k: v for k, v in r.items() if v}
                                        for n, r in {**runs, **span_runs}.items()}))

    # each run's kernels: K5-K7 once per HTTP call, K2/K3 once per span the
    # model searches, K17 once per Kafka call, K21 / K22 on the mesh
    spans = [s for s, on in (("method", model.has_method_rx), ("path", model.has_path_rx),
                             ("head", model.head_nfa is not None)) if on]
    for span in spans:
        tab = model.head_nfa if span == "head" else model.line_nfa
        got = {k: n for k, n in span_runs.get(f"policy-http:{span}", {}).items() if n}
        if got != {scan_kernel(tab): 1}:
            raise AssertionError(f"policy-http:{span}: launches {got}")
    want = dict.fromkeys(kerns, 0)
    want.update(http_frame=1, http_lit=1, http_hits=1)
    for span in spans:
        kname = scan_kernel(model.head_nfa if span == "head" else model.line_nfa)
        want[kname] += 1
    if runs["policy-http"] != want:
        raise AssertionError(f"policy-http: launches {runs['policy-http']} != {want}")
    want = dict.fromkeys(kerns, 0)
    want["kafka_hits"] = 1
    if runs["policy-kafka"] != want:
        raise AssertionError(f"policy-kafka: launches {runs['policy-kafka']} != {want}")
    on_path = {
        "policy-http-engine": ("http_frame", "http_lit", "http_hits"),
        "policy-kafka-engine": ("kafka_hits",),
        "policy-mesh-http": ("http_frame", "http_lit", "http_hits", "nfa_scan", "shard_reduce"),
        "policy-mesh-kafka": ("kafka_hits", "kafka_shard_combine"),
        "policy-mesh-engine": ("http_frame", "http_lit", "http_hits", "nfa_scan", "shard_reduce"),
        "policy-npds": ("http_frame", "http_lit", "http_hits"),
    }
    for label, names_ in on_path.items():
        missing = [n for n in names_ if not runs[label][n]]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched")
    log("policy launches of K2/K3/K5/K6/K7/K17/K21/K22: " + json.dumps({
        label: {n: r[n] for n in ("dfa_scan", "nfa_scan", "http_frame", "http_lit", "http_hits",
                                  "kafka_hits", "shard_reduce", "kafka_shard_combine")}
        for label, r in runs.items()}))

    # the passes against the CPU path and the host oracles on one period
    log("== policy model")
    host = torch.stack([t.to(torch.int32) for t in h_out]).cpu().numpy()
    if not (host == np.tile(host[:, :POLICY_PERIOD], (1, F // POLICY_PERIOD))).all():
        raise AssertionError("policy-http: rows of one request disagree")
    p = slice(0, POLICY_PERIOD)
    cpu = torch.stack([t.to(torch.int32) for t in
                       http_verdicts_attr(cpu_model, hdata[p], hlen[p], hrem[p])]).numpy()
    bad_cpu = int((host[:, p] != cpu).any(axis=0).sum())
    oracle = http_oracle(oracle_policy, heads, rem)
    bad_oracle = sum(1 for i, (a, _) in enumerate(oracle) if bool(host[2, i]) != a)
    mesh_host = torch.stack([t.to(torch.int32) for t in mh_out]).cpu().numpy()
    bad_mesh = int((mesh_host != host).any(axis=0).sum())
    log(f"policy-http: F={F} L={POLICY_L} R={model.n_rules}: card != cpu on {bad_cpu} of "
        f"{POLICY_PERIOD} rows, != the NPDS policy's matches_at on {bad_oracle}, 1 x 4 mesh != "
        f"card on {bad_mesh} of {F} (verdicts and first rule); allow share {float(host[2].mean()):.3f}")
    khost = k_out.cpu().numpy()
    if not (khost == np.resize(khost[:POLICY_PERIOD], F)).all():
        raise AssertionError("policy-kafka: rows of one request disagree")
    kcpu = kafka_verdicts(cpu_kmodel, encode_requests(kreqs), krem).numpy()
    kbad_cpu = int((khost[p] != kcpu).sum())
    koracle = [matches_rule(r, [rule for rs, rule in host_rows if not rs or int(x) in rs])
               for r, x in zip(kreqs, krem)]
    kbad_oracle = sum(1 for i in range(POLICY_PERIOD) if bool(khost[i]) != koracle[i])
    kbad_mesh = int((mk_out.cpu().numpy() != khost).sum())
    log(f"policy-kafka: F={F} W={kbatch.topics.shape[2]} R={kmodel.n_rules}: card != cpu on "
        f"{kbad_cpu} of {POLICY_PERIOD} rows, != matches_rule on {kbad_oracle}, 1 x 4 mesh != card on "
        f"{kbad_mesh} of {F}; allow share {float(khost.mean()):.3f}")
    if bad_cpu or bad_oracle or bad_mesh or kbad_cpu or kbad_oracle or kbad_mesh:
        raise AssertionError("policy passes: mismatches")
    if not 0 < host[2].mean() < 1 or not 0 < khost.mean() < 1:
        raise AssertionError("policy passes: every verdict is the same")

    log("== policy engines")
    card_mon = daemons["card"]
    pv_events = sum(1 for e in card_mon.events if e.type == MSG_TYPE_POLICY_VERDICT)
    checks = {
        "policy-http-engine": (eng_out["policy-http-engine"], [
            (drive(redirects[("cpu", 80)], hfeeds), "the CPU engine"),
            (run_http_stream(oracle_policy, hfeeds), "the streaming HttpParser on the NPDS policy"),
            (mesh_eng, "the 1 x 4 mesh engine")]),
        "policy-kafka-engine": (eng_out["policy-kafka-engine"], [
            (drive(redirects[("cpu", 9092)], kfeeds), "the CPU engine"),
            (kafka_oracle(host_rows, kfeeds), "the matches_rule oracle")]),
    }
    for label, (got, others) in checks.items():
        for other, what in others:
            if got != other:
                raise AssertionError(f"{label}: ops differ from {what}: {_first_diff(got, other)}")
        n_ops = sum(len(ops) for _, ops, _ in got)
        n_drop = sum(1 for _, ops, _ in got for op, _ in ops if op == 2)
        if not n_drop or n_drop == n_ops:
            raise AssertionError(f"{label}: the traffic is all allowed or all denied")
        log(f"{label}: {POLICY_ENGINE_FLOWS} flows x 3 rounds, {n_ops} ops ({n_drop} DROP), 0 mismatches "
            f"against {', '.join(w for _, w in others)}")
    if not pv_events or not card_mon.access_logger.records:
        raise AssertionError("the card engines' monitor got no POLICY-VERDICT event or no access record")
    log(f"monitor: {pv_events} POLICY-VERDICT events and {card_mon.access_logger.records} access "
        f"records from the card engines (flow log notify on)")

    log("== policy NPDS")
    oracle_npds = sidecar_oracle("http", nrounds, pols, name=names, port=80, base=POLICY_NPDS_BASE)
    npds_cpu, _, _ = npds_serve(f"{tmp}/npds-cpu.sock", side_config(verdict_device="cpu"), eps,
                                npds_cache, names, nrounds)
    bad = side_mismatches(npds_card, oracle_npds) + side_mismatches(npds_card, npds_cpu)
    frames = side_frames(oracle_npds)
    dev_st = npds_status.get("device", {})
    ops = [op for rnd in oracle_npds for o, _, _ in rnd.values() for op, _ in o]
    log(f"policy-npds: {pushes} NPDS pushes ({len(eps)} endpoints), {POLICY_NPDS_CONNS} conns, "
        f"{frames} requests ({ops.count(1)} PASS, {ops.count(2)} DROP): {bad} mismatches against the "
        f"in-process proxylib oracle and the CPU service; device-judged {dev_st.get('device_judged')}, "
        f"host-judged {dev_st.get('host_judged')}")
    if bad or not ops.count(1) or not ops.count(2):
        raise AssertionError("policy-npds: the service disagrees, or allows or denies everything")

    # K2/K3/K5/K6/K7/K17/K21/K22 against their plain versions at the slice's shapes
    log("== policy kernels vs plain")
    report = {}
    data, lengths, rm = h_dev
    frame = http_frame(data, lengths)
    report["http_frame"] = {"policy-http": max_abs_err(frame, http_frame_plain(data, lengths))}
    lit = http_lit(model, data, frame)
    report["http_lit"] = {"policy-http": max_abs_err(lit, http_lit_plain(model, data, frame))}
    span_args = {"method": (model.line_nfa, torch.zeros_like(frame.sp1), frame.sp1),
                 "path": (model.line_nfa, frame.p_start, frame.sp2),
                 "head": (model.head_nfa, frame.line_end, frame.h_end)}
    rx = {}
    for span in spans:
        tab, s, e = span_args[span]
        kname = scan_kernel(tab)
        scan, plain = scans[kname]
        rx[span] = scan(tab, data, s, e)
        report.setdefault(kname, {})[f"policy-http:{span}"] = max_abs_err([rx[span]], [plain(tab, data, s, e)])
    args = (frame.complete, *lit, rx.get("method"), rx.get("path"), rx.get("head"), rm)
    hits = http_hits(model, *args)
    report["http_hits"] = {"policy-http": max_abs_err(hits, http_hits_plain(model, *args))}
    report["kafka_hits"] = {"policy-kafka": max_abs_err(
        [kafka_hits(kmodel, k_dev, krem_dev)], [kafka_verdicts_plain(kmodel, k_dev, krem_dev)])}
    # K3 on each 1 x 4 mesh shard's NFAs and spans, K21 / K22 on the mesh
    # runs' partials
    for j, shard in enumerate(mesh_model.slots[0]):
        sdev = shard.device
        sd, sl = data.to(sdev), lengths.to(sdev)
        sframe = http_frame(sd, sl)
        sargs = {"method": (shard.line_nfa, torch.zeros_like(sframe.sp1), sframe.sp1),
                 "path": (shard.line_nfa, sframe.p_start, sframe.sp2),
                 "head": (shard.head_nfa, sframe.line_end, sframe.h_end)}
        for span in [s for s, on in (("method", shard.has_method_rx), ("path", shard.has_path_rx),
                                     ("head", shard.head_nfa is not None)) if on]:
            tab, s, e = sargs[span]
            kname = scan_kernel(tab)
            scan, plain = scans[kname]
            report.setdefault(kname, {})[f"policy-mesh-http:s{j}:{span}"] = max_abs_err(
                [scan(tab, sd, s, e)], [plain(tab, sd, s, e)])
    def k21_err(args):
        got, want = rs_mod.shard_reduce(*args), rs_mod.shard_reduce_plain(*args)
        return max_abs_err(got, want) if isinstance(got, tuple) else max_abs_err([got], [want])

    recorded = merges["shard_reduce"]
    report["shard_reduce"] = {"policy-mesh-http": k21_err(recorded[0]),
                              "policy-mesh-engine": max(k21_err(a) for a in recorded[1:])}
    report["kafka_shard_combine"] = {"policy-mesh-kafka": max(
        max_abs_err([rs_mod.kafka_shard_combine(*a)], [rs_mod.kafka_shard_combine_plain(*a)])
        for a in merges["kafka_shard_combine"])}
    log("max |kernel - plain|:", json.dumps(report))
    for kname, per in report.items():
        for name, err in per.items():
            if err != 0:
                raise AssertionError(f"{kname} disagrees with its plain version on {name}")

    # times: the kernels and passes, the engines on the host clock
    log("== policy times on", card)
    rows = {"http_frame": k5_row(data, lengths, frame)}
    k6 = lambda: http_lit(model, data, frame)  # noqa: E731
    rows["http_lit"] = dict(ms=graph_ms(k6), call_ms=cuda_ms(k6, 50),
                            plain_ms=cuda_ms(lambda: http_lit_plain(model, data, frame), 5),
                            **lit_counts(model, frame))
    for span in spans:
        tab, s, e = span_args[span]
        kname = scan_kernel(tab)
        row = scan_row(scans[kname], tab, data, s, e, span_bytes(s, e, POLICY_L))
        row["span"] = span
        rows[f"{kname}:{span}"] = row
    k7 = lambda: http_hits(model, *args)  # noqa: E731
    rows["http_hits"] = dict(ms=graph_ms(k7), call_ms=cuda_ms(k7, 50),
                             plain_ms=cuda_ms(lambda: http_hits_plain(model, *args), 5),
                             **hits_counts(model, args, hits))
    on_card = lambda: http_verdicts_attr(model, *h_dev)  # noqa: E731
    timed = {"policy-http": dict(rows=rows, **pass_times(
        on_card, lambda: http_verdicts_attr(model, hdata, hlen, hrem)))}
    for kname, row in rows.items():
        bound(row)
        log_row("policy-http", kname, row)
    log_pass("policy-http", "http_verdicts_attr", timed["policy-http"], card)
    krow = k17_row(kmodel, k_dev, krem_dev)
    timed["policy-kafka"] = dict(rows={"kafka_hits": krow}, **pass_times(
        lambda: (kafka_hits(kmodel, k_dev, krem_dev),),
        lambda: (kafka_verdicts(kmodel, kbatch, kremotes),)))
    log_row("policy-kafka", "kafka_hits", krow)
    log_pass("policy-kafka", "kafka_verdicts", timed["policy-kafka"], card)
    # K3 on the mesh shard its NFA cuts in the most parts (one launch a part)
    j = max(range(len(mesh_model.stacked)), key=lambda i: len(mesh_model.stacked[i].line_nfa.scan_parts))
    shard = mesh_model.slots[0][j]
    sd, sl = data.to(shard.device), lengths.to(shard.device)
    sframe = http_frame(sd, sl)
    for span, tab, s, e in (("path", shard.line_nfa, sframe.p_start, sframe.sp2),
                            ("head", shard.head_nfa, sframe.line_end, sframe.h_end)):
        if tab is None or not isinstance(tab, nfa_mod.DeviceNfa):
            continue
        row = scan_row(scans["nfa_scan"], tab, sd, s, e, span_bytes(s, e, POLICY_L))
        row.update(span=span, states=tab.n_states, parts=len(tab.scan_parts) or 1)
        bound(row)
        name = f"policy-mesh-s{j}-{span}"
        timed[name] = dict(rows={"nfa_scan": row})
        log_row(name, "nfa_scan", row)
        log(f"{name}: {row['states']} states in {row['parts']} K3 launch(es) a call")
    for port, feeds, label in ((80, hfeeds, "policy-http-engine"), (9092, kfeeds, "policy-kafka-engine")):
        got = eng_out[label]
        n = sum(1 for _, ops, _ in got for op, _ in ops if op in (1, 2))
        eng = redirects[("card", port)]
        engine_times(f"{label}: {n} frames of {POLICY_ENGINE_FLOWS} flows", n, card,
                     lambda: drive(fresh_engine(eng), feeds))
    return launches, runs, span_runs, report, timed


# --- phase 15: the state layer into K12-K15, and K3's wide form ---------------


STATE_SEED = 15  # the world's numpy seed (services' backends)
STATE_CLOCK = 10_000.0  # the CT map's clock
STATE_SAMPLE = 2000  # queries a shape held to the host oracles
# queries of the shapes whose host oracles walk the ipcache: IpcacheMap.lookup
# scans its 16,384 prefixes in Python, milliseconds a query
STATE_LPM_SAMPLE = 64
# endpoints regenerated against policy-1000 (state_world.Scale's 64 cut to
# 16, so that phase 16 fits in the script's time limit)
STATE_ENDPOINTS = 16
# pod IPs an identity: 16,384 published pairs (state_world.Scale's 128, 65,536
# pairs, cut so that phase 17 fits in the script's time limit; every query
# width stays)
STATE_IPS_PER_IDENTITY = 32
STATE_CPU_F = 8192  # queries a shape held to the CPU path (its LPM walks 16,384 prefixes a query)
STATE_SHAPES = ("state-policy", "state-ipcache", "state-lb", "state-datapath", "state-overlay")
# K3's wide form at these (F, L): the HTTP rule at policy-http's shape and
# the compiled patterns on planted bytes (tests/nfa_wide_cases.py)
NFA_WIDE_SHAPES = {"nfa-wide-http": (F, POLICY_L), "nfa-wide-2064": (8192, 1280),
                   "nfa-wide-4088": (2048, 2048)}


def state_slice(dev, card, kerns):
    """Phase 15, the state layer on the card, counted in a run of its own
    over every kernel.  Returns (launches, runs, report, timed)."""
    sw = _tests_module("state_world")
    log("== state slice")
    t_phase = time.monotonic()
    held = {}
    try:
        out = _state_runs(dev, card, kerns, sw, held)
    finally:
        if "world" in held:
            held["world"].close()
    log(f"state slice: {time.monotonic() - t_phase:.1f} s")
    return out


def state_stage_lines(stages, card):
    """One log line a stage of the world's build: host-clock seconds and
    its rates and counts."""
    for name, (secs, info) in stages.items():
        rates = ""
        if name == "identities":
            rates = f" = {info['allocations'] / secs:.0f} allocations/s"
        elif name == "ipcache":
            rates = (f"; published in {info['publish_s']:.2f} s = {info['published'] / info['publish_s']:.0f}"
                     f" pairs/s, converged on B at {info['entries'] / secs:.0f} entries/s")
        elif name == "services":
            rates = f" = {info['services'] / secs:.0f} services/s"
        elif name == "endpoints":
            rates = f" = {info['endpoints'] / secs:.1f} regenerations/s"
        log(f"state {name}: {secs:.3f} s (host clock){rates}; "
            + ", ".join(f"{k} {v}" for k, v in info.items() if k != "publish_s") + f" [{card}]")


def _state_runs(dev, card, kerns, sw, held):
    import copy

    from cilium_tpu_torch import entry
    from cilium_tpu_torch.datapath import ingress as ing_mod
    from cilium_tpu_torch.datapath import pipeline as dp_mod
    from cilium_tpu_torch.maps import lbmap as lb_mod
    from cilium_tpu_torch.maps import policymap as pol_mod
    from cilium_tpu_torch.maps.policymap import DIR_INGRESS
    from cilium_tpu_torch.models.http import build_http_model, http_frame, http_verdicts_attr
    from cilium_tpu_torch.ops import l34_index
    from cilium_tpu_torch.ops import lpm as lpm_mod
    from cilium_tpu_torch.ops import nfa as nfa_mod
    from cilium_tpu_torch.policy.api import PortRuleHTTP
    from cilium_tpu_torch.regex import compile_patterns

    wc = _tests_module("nfa_wide_cases")
    new = {"lpm_lookup": lpm_mod._LPM, "policy_can_access": pol_mod._POLICY, "lb_select": lb_mod._LB,
           "datapath4": dp_mod._DATAPATH[1], "ingress": ing_mod._INGRESS, "nfa_scan": nfa_mod._NFA_SCAN}
    kerns = {**kerns, **new}

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def counts():
        return {n: k.launches + k.replayed for n, k in kerns.items()}

    runs, outs = {}, {}

    def run(name, fn):
        before = counts()
        outs[name] = fn()
        now = counts()
        runs[name] = {n: now[n] - before[n] for n in kerns}

    # K3's wide form: the HTTP rule's model and the compiled patterns, with
    # their batches (built before the count: no kernel runs here)
    wide = {}
    rule = [(frozenset(), PortRuleHTTP(**wc.HTTP_WIDE_RULE))]
    hmodel = build_http_model(rule, device=dev)
    f_h, l_h = NFA_WIDE_SHAPES["nfa-wide-http"]
    hrng = np.random.default_rng(71)
    heads = [wc.http_requests(int(a), int(b), l_h)
             for a, b in zip(hrng.integers(200, 257, 512), hrng.integers(0, 200, 512))]
    hdata, hlen, hrem = tile_heads(heads, [1] * len(heads), f_h, l_h)
    wide["nfa-wide-http"] = dict(tab=hmodel.line_nfa, dev=tuple(on_dev(a) for a in (hdata, hlen, hrem)))
    for shape, pattern in wc.WIDE_PATTERNS.items():
        f_w, l_w = NFA_WIDE_SHAPES[shape]
        data, lengths = wc.planted(np.random.default_rng(72), f_w, l_w, wc.needle(pattern))
        wide[shape] = dict(tab=nfa_mod.device_nfa(compile_patterns([pattern]), dev),
                           dev=(on_dev(data), on_dev(lengths)))
    for shape, c in wide.items():
        tab = c["tab"]
        if not (nfa_mod.MAX_STATES < tab.n_states <= nfa_mod.WIDE_STATES) or tab.scan_parts:
            raise AssertionError(f"{shape}: {tab.n_states} states in {len(tab.scan_parts)} parts: "
                                 "not one launch of K3's wide form")
        log(f"{shape}: {tab.n_states} states ({-(-tab.n_states // 32)} words), {tab.n_classes} classes, "
            f"{tab.n_patterns} pattern(s), F={c['dev'][0].shape[0]} L={c['dev'][0].shape[1]}: one K3 "
            "launch in the wide form")

    # the main path, counted: the world built, the lookups on its maps,
    # the churn, the lookups again, K3's wide form
    log("== state main path (counted)")
    for k in kerns.values():
        k.launches = 0
        k.replayed = 0
    sets = list(entry.policy_identities().values())
    rules_json = json.dumps(entry.policy_rules(*POLICY_WORLD))
    t_sec = time.monotonic()
    w = held["world"] = sw.build_world(sw.modules("cilium_tpu_torch"), sw.Scale(endpoints=STATE_ENDPOINTS,
                                                                        ips_per_identity=STATE_IPS_PER_IDENTITY), sets,
                                       rules_json, seed=STATE_SEED, concurrent=True, ct_clock=lambda: STATE_CLOCK)
    state_stage_lines(w.stages, card)
    eps = w.manager.get_endpoints()
    if any(ep.device_policy_map.device.type != dev.type for ep in eps):
        raise AssertionError("an endpoint's policy map is not on the card")
    snaps = {}

    def snapshot(tag):
        """The host maps and the card's tables of this moment, built
        (timed) from the world's maps, and their CPU twins."""
        pol = eps[0].policy_map
        t = {}
        t["lpm_ms"] = snapshot_ms(lambda: t.update(lpm=w.ipc.to_device(device=dev)))
        t["lb_ms"] = snapshot_ms(lambda: t.update(lb=w.lb.to_device(device=dev)))
        t["dp_ms"] = snapshot_ms(lambda: t.update(dp=dp_mod.build_tables(w.ct, w.lb, w.ipc, pol, dev)))
        t["ing_ms"] = snapshot_ms(lambda: t.update(ing=ing_mod.build_ingress_tables(w.ipc, w.lxc, w.ct, pol, dev)))
        t["dp_ix_ms"] = snapshot_ms(lambda: rebuild_indexes(t["dp"]))
        t["host"] = tuple(copy.deepcopy(m) for m in (w.ct, w.lb, w.ipc, pol, w.lxc))
        t["eps"] = [(ep.id, ep.device_policy_map, copy.deepcopy(ep.policy_map)) for ep in eps]
        t["cpu_maps"] = [ep.policy_map.to_device(device="cpu") for ep in eps]
        ct, lb, ipc, hpol, lxc = t["host"]
        t["cpu"] = dict(lpm=ipc.to_device(device="cpu"), lb=lb.to_device(device="cpu"),
                        dp=dp_mod.build_tables(ct, lb, ipc, hpol, "cpu"),
                        ing=ing_mod.build_ingress_tables(ipc, lxc, ct, hpol, "cpu"))
        rng = np.random.default_rng(STATE_SEED + len(snaps))
        t["q"] = dict(policy=sw.policy_queries(w, rng, F), ipcache=(sw.address_queries(w, rng, F),),
                      lb=sw.lb_queries(w, rng, F), datapath=sw.datapath_packets(w, rng, F),
                      overlay=sw.overlay_packets(w, rng, F))
        t["d"] = {k: tuple(on_dev(a) for a in v) for k, v in t["q"].items()}
        snaps[tag] = t
        log(f"state {tag}: tables from the host maps (host clock, synchronised): ipcache "
            f"{t['lpm'].n} prefixes {t['lpm_ms']:.2f} ms, LB "
            f"{t['lb'].valid.shape[0]} services x {t['lb'].b_port.shape[1]} {t['lb_ms']:.2f} ms, K14's "
            f"tables {t['dp_ms']:.2f} ms (their indexes rebuilt alone {t['dp_ix_ms']:.2f} ms; "
            f"{l34_index.nbytes(t['dp'].index)} index bytes beside {table_bytes(t['dp'])} of tables), "
            f"K15's {t['ing_ms']:.2f} ms [{card}]")
        return t

    def lookups(tag, t):
        d = t["d"]
        run(f"state-policy{tag}", lambda: [pol_mod.policy_can_access_batch(dm, *d["policy"], DIR_INGRESS)
                                           for _, dm, _ in t["eps"]])
        run(f"state-ipcache{tag}", lambda: lpm_mod.lpm_lookup(t["lpm"], *d["ipcache"]))
        run(f"state-lb{tag}", lambda: lb_mod.lb4_select_backend_batch(t["lb"], *d["lb"]))
        run(f"state-datapath{tag}", lambda: dp_mod.datapath_verdicts(t["dp"], *d["datapath"]))
        run(f"state-overlay{tag}", lambda: ing_mod.overlay_verdicts(t["ing"], *d["overlay"]))
        state_held(tag, t)

    def state_held(tag, t):
        """The card's outputs against the CPU path (the first STATE_CPU_F
        queries) and the host oracles (STATE_SAMPLE queries a shape,
        STATE_LPM_SAMPLE where the oracle walks the ipcache)."""
        t0 = time.perf_counter()
        q = {k: tuple(a[:STATE_CPU_F] for a in v) for k, v in t["q"].items()}
        cpu = t["cpu"]
        ct, lb, ipc, hpol, lxc = t["host"]
        want = {
            f"state-policy{tag}": [pol_mod.policy_can_access_batch(cm, *(torch.from_numpy(x) for x in q["policy"]),
                                                                   DIR_INGRESS) for cm in t["cpu_maps"]],
            f"state-ipcache{tag}": lpm_mod.lpm_lookup(cpu["lpm"], torch.from_numpy(q["ipcache"][0])),
            f"state-lb{tag}": lb_mod.lb4_select_backend_batch(cpu["lb"], *(torch.from_numpy(x) for x in q["lb"])),
            f"state-datapath{tag}": dp_mod.datapath_verdicts(cpu["dp"], *q["datapath"]),
            f"state-overlay{tag}": ing_mod.overlay_verdicts(cpu["ing"], *q["overlay"]),
        }
        for name, wv in want.items():
            if max_abs_err([x[:STATE_CPU_F].cpu() for x in _flat(outs[name])], _flat(wv)) != 0:
                raise AssertionError(f"{name}: the card differs from the CPU path")
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        q = t["q"]
        sample = sorted(random.Random(STATE_SEED).sample(range(F), STATE_SAMPLE))
        lpm_sample = sample[:: STATE_SAMPLE // STATE_LPM_SAMPLE]

        def u32(x):
            return int(np.int64(x) & 0xFFFFFFFF)

        def ip(x):
            return str(ipaddress.IPv4Address(u32(x)))

        ident, dport, proto = q["policy"]
        probe = [i for i in sample if dport[i] != 0]  # not the L3-only shape (ROADMAP Queue 3)
        for (eid, _, hmap), (allowed, port) in zip(t["eps"], outs[f"state-policy{tag}"]):
            a, pp = allowed.cpu().numpy(), port.cpu().numpy()
            for i in probe:
                if (bool(a[i]), int(pp[i])) != hmap.lookup(int(ident[i]), int(dport[i]), int(proto[i]),
                                                          DIR_INGRESS, count_packets=False):
                    raise AssertionError(f"state-policy{tag}: endpoint {eid} query {i} != PolicyMap.lookup")
        found, value, _ = (x.cpu().numpy() for x in outs[f"state-ipcache{tag}"])
        for i in lpm_sample:
            info = ipc.lookup(ip(q["ipcache"][0][i]))
            if bool(found[i]) != (info is not None) or (info is not None and int(value[i]) != info.sec_label):
                raise AssertionError(f"state-ipcache{tag}: address {i} != IpcacheMap.lookup")
        lbo = [x.cpu().numpy() for x in outs[f"state-lb{tag}"]]
        for i in sample:
            b = lb.select_backend(u32(q["lb"][0][i]), int(q["lb"][1][i]), u32(q["lb"][2][i]))
            got = (bool(lbo[0][i]),) + ((u32(lbo[1][i]), int(lbo[2][i]), int(lbo[3][i])) if lbo[0][i] else ())
            if got != ((True, b.target, b.port, b.rev_nat_index) if b is not None else (False,)):
                raise AssertionError(f"state-lb{tag}: flow {i} != LbMap.select_backend")
        dp_h = dp_mod.host_arrays(outs[f"state-datapath{tag}"])
        pk = q["datapath"]
        for i in lpm_sample:
            o = dp_mod.host_oracle(ct, lb, ipc, hpol, u32(pk[0][i]), u32(pk[1][i]), int(pk[2][i]),
                                   int(pk[3][i]), int(pk[4][i]))
            for key in ("verdict", "new_daddr", "new_dport", "dst_identity", "proxy_port", "rev_nat",
                        "established", "needs_ct_create"):
                if u32(dp_h[key][i]) != u32(o[key]):
                    raise AssertionError(f"state-datapath{tag}: packet {i} {key} != host_oracle")
        ov_h = dp_mod.host_arrays(outs[f"state-overlay{tag}"])
        pk = q["overlay"]
        for i in lpm_sample:
            o = ing_mod.host_oracle_netdev(ipc, lxc, ct, hpol, u32(pk[0][i]), u32(pk[1][i]), int(pk[2][i]),
                                           int(pk[3][i]), int(pk[4][i]), tunnel_id=int(pk[5][i]))
            for key in ("verdict", "src_identity", "lxc_id", "tunnel_endpoint", "proxy_port", "established",
                        "needs_ct_create"):
                if u32(ov_h[key][i]) != u32(o[key]):
                    raise AssertionError(f"state-overlay{tag}: packet {i} {key} != host_oracle_netdev")
        v = dp_h["verdict"], ov_h["verdict"]
        log(f"state{tag}: card == CPU path on {STATE_CPU_F} queries a shape ({len(t['eps'])} endpoint maps; "
            f"{cpu_s:.1f} s), == the host oracles on {STATE_SAMPLE} (K13) / {len(lpm_sample)} (K12, K14, "
            f"K15; {time.perf_counter() - t0:.1f} s); K12 hit share {found.mean():.3f}, K13 LB found share "
            f"{lbo[0].mean():.3f}, K13 policy allowed share (endpoint {t['eps'][0][0]}) "
            f"{outs[f'state-policy{tag}'][0][0].float().mean().item():.3f}; K14 verdicts "
            f"{np.bincount(v[0], minlength=5).tolist()}, K15 overlay "
            f"{np.bincount(v[1], minlength=5).tolist()} (FORWARD, DROP, TO_PROXY, TO_HOST, TO_OVERLAY)")

    sections = {"build": time.monotonic() - t_sec}
    t_sec = time.monotonic()
    lookups("", snapshot(""))
    sections["snapshot-and-checks"] = time.monotonic() - t_sec
    t_sec = time.monotonic()
    sw.churn(w, seed=STATE_SEED + 1)  # holds B's cache and ipcache to what was published
    state_stage_lines({"churn": w.stages["churn"]}, card)
    lookups("-churn", snapshot("-churn"))
    sections["churn-and-checks"] = time.monotonic() - t_sec
    t_sec = time.monotonic()
    # K3's wide form
    run("nfa-wide-http", lambda: http_verdicts_attr(hmodel, *wide["nfa-wide-http"]["dev"]))
    for shape in wc.WIDE_PATTERNS:
        run(shape, lambda s=shape: nfa_mod.nfa_search_batch(wide[s]["tab"], *wide[s]["dev"]))
    torch.cuda.synchronize()
    launches = {n: sum(r[n] for r in runs.values()) for n in kerns}
    log("launches:", json.dumps({n: v for n, v in launches.items() if v}))
    log("launches by run:", json.dumps({n: {k: c for k, c in r.items() if c} for n, r in runs.items()}))
    for n in new:
        if launches[n] <= 0:
            raise AssertionError(f"kernel {n} was not launched on the state slice's main path")
    n_eps = len(eps)
    for tag in ("", "-churn"):
        want = {"state-policy": {"policy_can_access": n_eps}, "state-ipcache": {"lpm_lookup": 1},
                "state-lb": {"lb_select": 1}, "state-datapath": {"datapath4": 1}, "state-overlay": {"ingress": 1}}
        for name, wv in want.items():
            got = {k: c for k, c in runs[name + tag].items() if c}
            if got != wv:
                raise AssertionError(f"{name}{tag}: launches {got} != {wv}")
    for shape in NFA_WIDE_SHAPES:
        if runs[shape]["nfa_scan"] != 1:
            raise AssertionError(f"{shape}: K3 launched {runs[shape]['nfa_scan']} times, not once")

    # kernels against their plain versions, at the main path's inputs
    sections["k3-wide-and-counts"] = time.monotonic() - t_sec
    t_sec = time.monotonic()
    log("== K3 wide form, K12-K15 on the state vs plain")
    report = {}

    def put(kname, label, got, want_):
        report.setdefault(kname, {})[label] = max_abs_err(_flat(got), _flat(want_))

    for tag, t in snaps.items():
        d = t["d"]
        for eid, dm, _ in t["eps"]:
            put("policy_can_access", f"state-policy{tag}/{eid}",
                pol_mod.policy_can_access_batch(dm, *d["policy"], DIR_INGRESS),
                pol_mod.policy_can_access_plain(dm, *d["policy"], DIR_INGRESS))
        put("lpm_lookup", f"state-ipcache{tag}", lpm_mod.lpm_lookup(t["lpm"], *d["ipcache"]),
            lpm_mod.lpm_lookup_plain(t["lpm"], *d["ipcache"]))
        lb_in = (t["lb"], [d["lb"][0]], d["lb"][1], d["lb"][2])
        put("lb_select", f"state-lb{tag}", lb_mod.lb_select(*lb_in), lb_mod.lb_select_plain(*lb_in))
        dp_in = (t["dp"], (d["datapath"][0],), (d["datapath"][1],), *d["datapath"][2:])
        put("datapath4", f"state-datapath{tag}", dp_mod.datapath_pass(*dp_in), dp_mod.datapath_pass_plain(*dp_in))
        ov_in = (t["ing"], ing_mod.MODE_OVERLAY, *d["overlay"])
        put("ingress", f"state-overlay{tag}", ing_mod.ingress(*ov_in), ing_mod.ingress_plain(*ov_in))
    hframe = http_frame(*wide["nfa-wide-http"]["dev"][:2])
    wide["nfa-wide-http"]["span"] = (hframe.p_start, hframe.sp2)
    plain_ms = {}
    for shape, c in wide.items():
        tab, data = c["tab"], c["dev"][0]
        start, end = c.get("span") or (torch.zeros_like(c["dev"][1]), c["dev"][1])
        c["span"] = (start, end)
        got = nfa_mod.nfa_search_spans(tab, data, start, end)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        want_ = nfa_mod.nfa_scan_plain(tab, data, start, end)
        e1.record()
        torch.cuda.synchronize()
        plain_ms[shape] = e0.elapsed_time(e1)
        put("nfa_scan", shape, got, want_)
        hits = want_.any(1)
        log(f"{shape}: K3's wide form == nfa_scan_plain on {data.shape[0]} flows; {int(hits.sum())} match")
        if shape != "nfa-wide-http" and not (bool(hits.any()) and not bool(hits.all())):
            raise AssertionError(f"{shape}: the planted needles did not give both outcomes")
    # the HTTP verdicts, as a whole, against the CPU model (no row can
    # match at L = 512: the rule's path alone is 513 bytes) on the first
    # STATE_CPU_F rows; the rows repeat the 512 heads, and every later row
    # must equal its first occurrence
    card_h = np.stack([x.cpu().numpy().astype(np.int64) for x in _flat(outs["nfa-wide-http"])])
    period = len(heads)
    if not (card_h == np.tile(card_h[:, :period], (1, card_h.shape[1] // period))).all():
        raise AssertionError("nfa-wide-http: rows of one head disagree on the card")
    cpu_h = build_http_model(rule, device="cpu")
    hcpu = http_verdicts_attr(cpu_h, *(torch.from_numpy(a[:STATE_CPU_F]) for a in (hdata, hlen, hrem)))
    if max_abs_err([torch.from_numpy(c[:STATE_CPU_F]) for c in card_h], _flat(hcpu)) != 0:
        raise AssertionError("nfa-wide-http: the card's verdicts differ from the CPU model's")
    log("max |kernel - plain|:", json.dumps(report))
    for kname, per in report.items():
        for label, err in per.items():
            if err != 0:
                raise AssertionError(f"{kname} disagrees with its plain version on {label}")

    # times
    sections["vs-plain"] = time.monotonic() - t_sec
    t_sec = time.monotonic()
    log("== state slice times on", card)
    timed = {}

    def row(fn, plain, bytes_, ops, plain_iters=3):
        return bound(dict(ms=graph_ms(fn), call_ms=cuda_ms(fn, 30), plain_ms=cuda_ms(plain, plain_iters),
                          bytes=bytes_, ops=ops))

    for tag, t in snaps.items():
        d = t["d"]
        _, dm, _ = t["eps"][0]
        pol_in = (dm, *d["policy"], DIR_INGRESS)
        rows = {
            f"state-policy{tag}": ("policy_can_access", row(
                lambda: _flat(pol_mod.policy_can_access_batch(*pol_in)),
                lambda: pol_mod.policy_can_access_plain(*pol_in),
                17 * F + index_bytes(dm.table.index), F * 3 * hash_ops(4))),
            f"state-ipcache{tag}": ("lpm_lookup", row(
                lambda: _flat(lpm_mod.lpm_lookup(t["lpm"], *d["ipcache"])),
                lambda: lpm_mod.lpm_lookup_plain(t["lpm"], *d["ipcache"]),
                4 * F + 9 * F + index_bytes(t["lpm"].index),
                F * t["lpm"].index.n_groups * hash_ops(2))),
            f"state-lb{tag}": ("lb_select", row(
                lambda: _flat(lb_mod.lb4_select_backend_batch(t["lb"], *d["lb"])),
                lambda: lb_mod.lb_select_plain(t["lb"], [d["lb"][0]], d["lb"][1], d["lb"][2]),
                12 * F + F + 12 * F + index_bytes(t["lb"].index)
                + table_bytes(t["lb"].counts, t["lb"].b_target_words, t["lb"].b_port, t["lb"].revnat),
                F * 2 * hash_ops(2))),
            f"state-datapath{tag}": ("datapath4", row(
                lambda: _flat(dp_mod.datapath_pass(t["dp"], (d["datapath"][0],), (d["datapath"][1],),
                                                   *d["datapath"][2:])),
                lambda: dp_mod.datapath_pass_plain(t["dp"], (d["datapath"][0],), (d["datapath"][1],),
                                                   *d["datapath"][2:]),
                k14_bytes(t["dp"], 1), F * sum(hash_ops(k) for k in [2] * 4 + [5] + [4] * 3))),
            f"state-overlay{tag}": ("ingress", row(
                lambda: _flat(ing_mod.ingress(t["ing"], ing_mod.MODE_OVERLAY, *d["overlay"])),
                lambda: ing_mod.ingress_plain(t["ing"], ing_mod.MODE_OVERLAY, *d["overlay"]),
                k15_bytes(t["ing"], False), F * sum(hash_ops(k) for k in [1, 5, 5, 2, 2, 4, 4, 4]))),
        }
        for name, (kname, r) in rows.items():
            timed[name] = dict(rows={kname: r})
            log_row(name, kname, r)
        timed[f"state-datapath{tag}"].update(pass_times(
            lambda: _flat(dp_mod.datapath_verdicts(t["dp"], *d["datapath"])),
            lambda: _flat(dp_mod.datapath_verdicts(t["dp"], *t["q"]["datapath"]))))
        log_pass(f"state-datapath{tag}", "datapath4", timed[f"state-datapath{tag}"], card)
    for shape, c in wide.items():
        tab, data = c["tab"], c["dev"][0]
        start, end = c["span"]
        f_w, l_w = data.shape
        sb = span_bytes(start, end, l_w)
        # the wide form reads the sparse rows, not delta_bits
        tables = 4 * (tab.scan_rows.numel() + tab.scan_has.numel() + tab.start_bits.numel()
                      + 2 * tab.accept_bits.numel()) + 2 * tab.scan_targets.numel() + 256
        fn = (lambda tab=tab, data=data, start=start, end=end: nfa_mod.nfa_search_spans(tab, data, start, end))
        r = bound(dict(ms=graph_ms(fn, iters=5, replays=4), call_ms=cuda_ms(fn, 5), plain_ms=plain_ms[shape],
                       bytes=sb + 8 * f_w + tables + f_w * tab.n_patterns, ops=sb * tab.delta_bits.shape[2],
                       states=tab.n_states))
        timed[shape] = dict(rows={"nfa_scan": r})
        log_row(shape, "nfa_scan", r)
        log(f"{shape}: {tab.n_states} states, {sb} span bytes; wide form {r['ms'] / r['bound_ms']:.1f}x its "
            f"bound [{card}]")
    on_card = lambda: http_verdicts_attr(hmodel, *wide["nfa-wide-http"]["dev"])  # noqa: E731
    timed["nfa-wide-http"].update(pass_times(on_card, lambda: http_verdicts_attr(hmodel, hdata, hlen, hrem)))
    log_pass("nfa-wide-http", "http_verdicts_attr", timed["nfa-wide-http"], card)
    sections["times"] = time.monotonic() - t_sec
    log("state sections (host clock s): " + json.dumps(sections))
    return launches, runs, report, timed


# --- phase 16: the agent, from policy to verdict and through a restart ------------

# policy-1000 without its 128-identity sources: the daemon pushes every
# endpoint's policy to the verdict service, whose model takes at most 32
# remotes a rule (models/base.py MAX_REMOTES, the reference's too; a conn
# on a policy with a wider rule loses its connection)
DAEMON_WORLD = (1000, 20, 0.0)
# Each endpoint's regeneration pushes the full NPDS state, ACK-gated, and
# the service rebuilds every engine a conn has bound on each push: a round
# of N regenerations costs about N x N engine builds (at 32 endpoints, 4.5 s
# a push and 223 s for the delete's round on the H100's host), so the phase
# runs 8 endpoints (16 until phase 17 came) to keep the script inside its
# time limit.
DAEMON_ENDPOINTS = 8
DAEMON_ACK_TIMEOUT_S = 120.0  # a push waits for the service to rebuild its bound engines
DAEMON_ENGINE_FLOWS = 4096
DAEMON_K13_F = 8192  # queries a endpoint map
DAEMON_SAMPLE = 2000  # of them held to PolicyMap.lookup; prefilter sources held to the deny sets
DAEMON_DELETE = 100  # rules deleted together (one policy of many rules): those that select the most endpoints
DAEMON_DELETE_LABEL = "k8s:policy-set=bulk"  # the label the deleted rules share
DAEMON_BASE = 8_000_000  # the service conns' ids; each later drive 1,000 above the last
DAEMON_NODE = "192.168.20.1"
DAEMON_FQDN = "svc.example.com"
DAEMON_FQDN_CIDR = "10.96.0.0/16"  # the FQDN rule's own toCIDRSet section
DAEMON_FQDN_IPS = ("10.96.3.7", "10.96.41.9", "10.96.200.1")  # the stub resolver's answer
DAEMON_WAIT_S = 900.0  # the longest wait for endpoints to settle


def daemon_fqdn_rule(labels):
    """An egress rule selecting the endpoint of ``labels`` (its full label
    set): one section to ``DAEMON_FQDN`` and one to ``DAEMON_FQDN_CIDR``."""
    return {"endpointSelector": {"matchLabels": dict(lbl.split("=", 1) for lbl in labels)},
            "labels": ["k8s:policy=fqdn"],
            "egress": [{"toFQDNs": [{"matchName": DAEMON_FQDN}]},
                       {"toCIDRSet": [{"cidr": DAEMON_FQDN_CIDR}]}]}


def _selects(rule, labels) -> bool:
    lbls = set(labels)
    return all(f"{k}={v}" in lbls for k, v in rule["endpointSelector"]["matchLabels"].items())


def daemon_endpoint_ids(ids, rules, n):
    """The ``n`` identities the most rules select (the lowest first on a
    tie), as ``entry.policy_destination`` ranks them."""
    return sorted(sorted(ids), key=lambda x: -sum(_selects(r, ids[x]) for r in rules))[:n]


def daemon_deleted_rules(rules, label_sets, n):
    """The labels of the ``n`` rules that select the most of ``label_sets``
    (the endpoints'; the earliest first on a tie)."""
    ranked = sorted(range(len(rules)), key=lambda i: -sum(_selects(rules[i], ls) for ls in label_sets))
    return [rules[i]["labels"][0] for i in ranked[:n]]


def every_kernel():
    """Every kernel of the port by launcher name, the modules that define
    them imported first."""
    import importlib

    from cilium_tpu_torch import kernels

    for mod in ("models.base", "models.r2d2", "models.http", "models.dns", "models.cassandra",
                "models.memcached", "models.kafka", "ops.dfa", "ops.nfa", "ops.gather",
                "ops.seqdfa", "ops.lpm", "ops.maplookup", "maps.lbmap", "maps.policymap",
                "datapath.pipeline", "datapath.ingress", "parallel.rulesharding",
                "sidecar.latbench"):
        importlib.import_module(f"cilium_tpu_torch.{mod}")
    every = {k.symbol: k for k in kernels.ALL}
    if len(every) != len(kernels.ALL):
        raise AssertionError("two kernels share a launcher name")
    return every


def daemon_mismatch_lines(label, got, want, rounds, names, n=3):
    """Log the first ``n`` (conn, round) pairs whose service output differs
    from the oracle's, with the conn's policy, remote and bytes."""
    shown = 0
    for r, (g, w) in enumerate(zip(got, want)):
        for fid in sorted(set(g) | set(w)):
            if g.get(fid) != w.get(fid) and shown < n:
                shown += 1
                sent = [(c, rem) for f, c, rem, _ in rounds[r] if f == fid]
                log(f"{label}: conn {fid} round {r} policy {names[fid]} remote {sent[0][1] if sent else None} "
                    f"bytes {sent[0][0] if sent else None!r}: service {g.get(fid)} != oracle {w.get(fid)}")


def daemon_slice(dev, card, kerns):
    """Phase 16, the agent on the card: a ``Daemon`` with its kvstore,
    identities, endpoints, proxy engines, NPDS push, prefilter, DNS poller
    and a restart, counted in a run of its own over every kernel.
    ``option.config``, the kvstore client and the proxylib registry are put
    back after it.  Returns (launches, runs, report, timed)."""
    import tempfile

    from cilium_tpu_torch import kvstore as kv_mod
    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.utils import option

    log("== daemon slice")
    t_phase = time.monotonic()
    saved = option.config, kv_mod._default_client
    held = {}
    inst.reset_module_registry()
    try:
        with tempfile.TemporaryDirectory(prefix="daemon-", dir=".") as tmp:
            try:
                out = _daemon_runs(dev, card, kerns, tmp, held)
            finally:
                for key in ("daemon", "svc", "peer", "peer_kv", "server"):
                    obj = held.pop(key, None)
                    if obj is not None:
                        (obj.stop if key == "svc" else obj.close)()
    finally:
        option.config, kv_mod._default_client = saved
        inst.reset_module_registry()
    log(f"daemon slice: {time.monotonic() - t_phase:.1f} s")
    return out


def _daemon_runs(dev, card, kerns, tmp, held):
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.datapath.prefilter import PreFilter
    from cilium_tpu_torch.endpoint import EndpointState
    from cilium_tpu_torch.identity import IdentityAllocator
    from cilium_tpu_torch.kvstore import KvstoreServer, NetBackend
    from cilium_tpu_torch.labels import LabelArray, Labels
    from cilium_tpu_torch.maps import policymap as pol_mod
    from cilium_tpu_torch.maps.policymap import DIR_INGRESS
    from cilium_tpu_torch.models.http import (
        HttpBatchModel,
        http_frame,
        http_frame_plain,
        http_hits,
        http_hits_plain,
        http_lit,
        http_lit_plain,
    )
    from cilium_tpu_torch.models.kafka import KafkaBatchModel, encode_requests, kafka_hits, kafka_verdicts_plain
    from cilium_tpu_torch.kafka import parse_request
    from cilium_tpu_torch.monitor.monitor import MSG_TYPE_ACCESS_LOG
    from cilium_tpu_torch.ops import dfa as dfa_mod
    from cilium_tpu_torch.ops import lpm as lpm_mod
    from cilium_tpu_torch.ops import nfa as nfa_mod
    from cilium_tpu_torch.ops.dfa import DeviceDfa
    from types import SimpleNamespace

    from cilium_tpu_torch.policy import L4Policy, Repository, SearchContext, proxy_id, rules_from_json
    from cilium_tpu_torch.proxy.npds_push import network_policy_for_endpoint
    from cilium_tpu_torch.proxylib import compile_policy
    from cilium_tpu_torch.runtime.engines import HttpBatchEngine, KafkaBatchEngine
    from cilium_tpu_torch.runtime.engines_util import kafka_host_rows
    from cilium_tpu_torch.sidecar import VerdictService
    from cilium_tpu_torch.utils import metrics
    from cilium_tpu_torch.utils.option import DaemonConfig

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counts():
        return {n: k.launches + k.replayed for n, k in kerns.items()}

    runs, stages = {}, {}

    def stage(name, secs, **info):
        stages[name] = (secs, info)
        log(f"daemon {name}: {secs:.3f} s (host clock); " + ", ".join(f"{k} {v}" for k, v in info.items())
            + f" [{card}]")

    def counted(name, fn):
        before = counts()
        out = fn()
        sync()
        now = counts()
        run = runs.setdefault(name, dict.fromkeys(kerns, 0))
        for n in kerns:
            run[n] += now[n] - before[n]
        return out

    def wait_for(cond, what, timeout=DAEMON_WAIT_S):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"daemon: {what} within {timeout:.0f} s")
            time.sleep(0.02)

    def regenerations():
        return int(metrics.EndpointRegenerationCount.get("success")
                   + metrics.EndpointRegenerationCount.get("fail"))

    def settled(d, eps, rev):
        return all(ep.state == EndpointState.READY and ep.policy_revision >= rev for ep in eps) \
            and d.build_queue.wait_idle(0.01)

    ids = entry.policy_identities()
    rules = entry.policy_rules(*DAEMON_WORLD)
    ep_ids = daemon_endpoint_ids(ids, rules, DAEMON_ENDPOINTS)
    fqdn_labels = ids[ep_ids[0]]
    gone = set(daemon_deleted_rules(rules, [ids[n] for n in ep_ids], DAEMON_DELETE))
    for r in rules:
        if r["labels"][0] in gone:
            r["labels"].append(DAEMON_DELETE_LABEL)
    doc = json.dumps(rules + [daemon_fqdn_rule(fqdn_labels)])
    cfg = DaemonConfig(
        kvstore="tcp", run_dir=f"{tmp}/run", dry_mode=False, enable_health=True, node_ipv4=DAEMON_NODE,
        verdict_device="default" if on_card else "cpu", socket_path=f"{tmp}/agent.sock",
        monitor_socket_path=f"{tmp}/monitor.sock", proxy_ack_timeout_s=DAEMON_ACK_TIMEOUT_S,
    )

    # the main path, counted: every count is 0 from here to the restart's K13
    log("== daemon main path (counted)")
    for k in kerns.values():
        k.launches = 0
        k.replayed = 0

    # 1. setup: the cluster's store, its 512 identities allocated by a peer
    # agent, and the daemon on the card with health and a node address
    t0 = time.monotonic()
    server = held["server"] = KvstoreServer()
    cfg.kvstore_opts = {"address": server.address}
    peer_kv = held["peer_kv"] = NetBackend(server.address)
    peer = held["peer"] = IdentityAllocator(backend=peer_kv, node_name="peer")
    numeric = {}
    for n in sorted(ids):
        ident, _ = peer.allocate(Labels.from_model(ids[n]))
        numeric[n] = ident.id
    stage("identities", time.monotonic() - t0, allocated=len(numeric))
    t0 = time.monotonic()
    dm = held["daemon"] = Daemon(cfg, node_name="agent-16")
    if {dm.device.type, dm.prefilter.device.type, dm.endpoint_manager.device.type} != {dev.type}:
        raise AssertionError(f"daemon: device {dm.device}, not {dev}")
    events = []
    dm.monitor.add_listener(events.append, queued=False)
    wait_for(lambda: all(i in dm.get_identity_cache() for i in numeric.values()),
             "the daemon's identity cache learns the peer's identities")
    stage("start", time.monotonic() - t0, identities=len(dm.get_identity_cache()))

    # 2. policy in, 3. endpoints: created one at a time, readied through the
    # daemon's trigger and build queue
    regen0 = regenerations()
    t_policy = time.monotonic()
    rev = dm.policy_add(rules_from_json(doc))
    eps = []
    for i, n in enumerate(ep_ids):
        eps.append(dm.endpoint_create(i + 1, ipv4=f"10.40.{i // 250}.{i % 250 + 1}", labels=ids[n]))
    wait_for(lambda: settled(dm, eps, rev), "every endpoint ready at the policy's revision")
    t_ready = time.monotonic()
    stage("policy-to-ready", t_ready - t_policy, rules=dm.policy.num_rules(), endpoints=len(eps),
          regenerations=regenerations() - regen0, redirects=len(dm.proxy_manager.redirects))
    if any(ep.security_identity.id != numeric[n] for ep, n in zip(eps, ep_ids)):
        raise AssertionError("daemon: an endpoint's identity differs from the peer's for its labels")
    if any(ep.device_policy_map is None or ep.device_policy_map.device.type != dev.type for ep in eps):
        raise AssertionError("daemon: an endpoint's policy map is not on the daemon's device")
    cache = dm.get_identity_cache()
    pool = sorted(numeric.values())

    # 4. the verdict service on the card at its defaults; the NPDS push
    svc_path = f"{tmp}/vs.sock"
    held["svc"] = VerdictService(svc_path, side_config(**({} if on_card else {"verdict_device": "cpu"}))).start()
    t0 = time.monotonic()
    pusher = dm.attach_verdict_service(svc_path)
    stage("attach", time.monotonic() - t0, pushes=pusher.pushes, nacks=pusher.nacks)
    if pusher.nacks or pusher.pushes < len(eps):
        raise AssertionError(f"daemon: {pusher.pushes} NPDS pushes, {pusher.nacks} NACKs")

    # 5. the daemon's own engines, built by its ProxyManager for the first
    # endpoint's redirects
    ep0 = eps[0]
    eng_h = dm.proxy_manager.redirects[proxy_id(ep0.id, True, "TCP", 80)].implementation
    red_k = dm.proxy_manager.redirects[proxy_id(ep0.id, True, "TCP", 9092)]
    eng_k = red_k.implementation
    if (type(eng_h) is not HttpBatchEngine or not isinstance(eng_h.model, HttpBatchModel)
            or type(eng_k) is not KafkaBatchEngine or not isinstance(eng_k.model, KafkaBatchModel)):
        raise AssertionError(f"daemon: engines {type(eng_h).__name__} / {type(eng_k).__name__}")
    if eng_h.logger is not dm.access_logger or eng_h.monitor is not dm.monitor:
        raise AssertionError("daemon: the HTTP engine lacks the daemon's access logger or monitor")
    hmodel, kmodel = eng_h.model, eng_k.model
    if hmodel.m_needle.device.type != dev.type:
        raise AssertionError("daemon: the HTTP engine's model is not on the daemon's device")
    hfeeds = policy_http_feeds(random.Random(29), pool, DAEMON_ENGINE_FLOWS)
    kfeeds = policy_kafka_feeds(random.Random(30), pool, DAEMON_ENGINE_FLOWS)
    n_access = sum(1 for e in events if e.type == MSG_TYPE_ACCESS_LOG)
    eng_out = {
        "daemon-http-engine": counted("daemon-http-engine", lambda: run_l7_engine(lambda: eng_h, hfeeds)[0]),
        "daemon-kafka-engine": counted("daemon-kafka-engine", lambda: run_l7_engine(lambda: eng_k, kfeeds)[0]),
    }
    n_access = sum(1 for e in events if e.type == MSG_TYPE_ACCESS_LOG) - n_access
    oracle_policy = compile_policy(network_policy_for_endpoint(ep0, cache))
    checks = {"daemon-http-engine": (run_http_stream(oracle_policy, hfeeds), "the streaming HttpParser"),
              "daemon-kafka-engine": (kafka_oracle(kafka_host_rows(red_k.l4_filter, cache), kfeeds),
                                      "matches_rule over kafka_host_rows")}
    for label, (want, what) in checks.items():
        got = eng_out[label]
        if got != want:
            raise AssertionError(f"{label}: ops differ from {what}: {_first_diff(got, want)}")
        n_ops = sum(len(o) for _, o, _ in got)
        n_drop = sum(1 for _, o, _ in got for op, _ in o if op == 2)
        if not n_drop or n_drop == n_ops:
            raise AssertionError(f"{label}: the traffic is all allowed or all denied")
        log(f"{label}: endpoint {ep0.id}'s engine ({hmodel.n_rules if 'http' in label else kmodel.n_rules} "
            f"rows), {DAEMON_ENGINE_FLOWS} flows x 3 rounds, {n_ops} ops ({n_drop} DROP), 0 mismatches "
            f"against {what}")
    if n_access <= 0:
        raise AssertionError("daemon: the access logger delivered no access-log event to the monitor")
    log(f"daemon monitor: {n_access} access-log events from the engines")

    # 6. K13 on every endpoint's exported map
    rng = np.random.default_rng(16)
    qpool = np.asarray(pool + [1, 2, 4242, 99_999], np.int64)
    q7 = (_i32(rng.choice(qpool, DAEMON_K13_F)),
          _i32(rng.choice(np.array([80, 9092, 8080, 443, 0]), DAEMON_K13_F, p=[0.4, 0.3, 0.1, 0.1, 0.1])),
          _i32(rng.choice(np.array([6, 17, 0]), DAEMON_K13_F, p=[0.8, 0.1, 0.1])))
    q7_dev = tuple(torch.from_numpy(a).to(dev) for a in q7)
    k13_in = {ep.id: ep.device_policy_map for ep in eps}
    ports7 = {r.proxy_port: pid for pid, r in dm.proxy_manager.redirects.items()}
    k13 = counted("daemon-policy", lambda: {i: pol_mod.policy_can_access_batch(m, *q7_dev, DIR_INGRESS)
                                            for i, m in k13_in.items()})
    sample = [i for i in sorted(random.Random(16).sample(range(DAEMON_K13_F), DAEMON_SAMPLE)) if q7[1][i] != 0]
    q7_cpu = tuple(torch.from_numpy(a) for a in q7)
    allowed_share = []
    for ep in eps:
        got = [x.cpu() for x in k13[ep.id]]
        want = pol_mod.policy_can_access_batch(ep.policy_map.to_device(device="cpu"), *q7_cpu, DIR_INGRESS)
        if max_abs_err(got, list(want)) != 0:
            raise AssertionError(f"daemon-policy: endpoint {ep.id}'s map on {dev} differs from the CPU path")
        a, pp = got[0].numpy(), got[1].numpy()
        for i in sample:
            if (bool(a[i]), int(pp[i])) != ep.policy_map.lookup(int(q7[0][i]), int(q7[1][i]), int(q7[2][i]),
                                                                DIR_INGRESS, count_packets=False):
                raise AssertionError(f"daemon-policy: endpoint {ep.id} query {i} != PolicyMap.lookup")
        allowed_share.append(float(a.mean()))
    log(f"daemon-policy: K13 on {len(eps)} endpoint maps ({sum(len(ep.policy_map.entries) for ep in eps)} entries) x "
        f"{DAEMON_K13_F} queries == the CPU path, {len(sample)} a map == PolicyMap.lookup; allowed share "
        f"{min(allowed_share):.3f}-{max(allowed_share):.3f}")

    # 7. K12 on the daemon: its prefilter with phase 8's deny list, then the
    # DNS poller's answer in its ipcache map
    cidrs, src4, _ = prefilter_case(F)
    words4 = _i32(src4)
    dm.prefilter.insert(1, cidrs)
    keep = counted("daemon-prefilter", lambda: dm.prefilter.filter_batch(words4))
    pf_cpu = PreFilter(device="cpu")
    pf_cpu.insert(1, cidrs)
    if not np.array_equal(keep, pf_cpu.filter_batch(words4)):
        raise AssertionError("daemon-prefilter: the keep mask differs from the CPU path")
    deny = [n for n in map(ipaddress.ip_network, cidrs) if n.version == 4]
    for i in sorted(random.Random(43).sample(range(F), DAEMON_SAMPLE)):
        if bool(keep[i]) == any(ipaddress.ip_address(src4[i]) in n for n in deny):
            raise AssertionError(f"daemon-prefilter: source {i} disagrees with the deny sets")
    log(f"daemon-prefilter: K12 over {dm.prefilter.device_lpm().n} v4 prefixes at F={F} == the CPU path, "
        f"== the deny sets on {DAEMON_SAMPLE}; drop share {1 - float(keep.mean()):.3f}")
    fq_ep = eps[0]
    rev_fq = fq_ep.policy_revision
    t0 = time.monotonic()
    dm.start_dns_poller(lambda name: (list(DAEMON_FQDN_IPS), 3600.0), interval=3600.0)
    want_cidrs = {f"{ip}/32" for ip in DAEMON_FQDN_IPS}

    def generated():
        with dm.policy.mutex:
            return {c.cidr for r in dm.policy.rules for e in r.egress for c in e.to_cidr_set if c.generated}

    wait_for(lambda: generated() == want_cidrs and fq_ep.policy_revision > rev_fq
             and settled(dm, eps, dm.policy.get_revision()), "the FQDN endpoint regenerates on the poller's answer")
    stage("fqdn", time.monotonic() - t0, generated=len(generated()), revision=f"{rev_fq} -> {fq_ep.policy_revision}")
    cidr_id = dm._cidr_identities[DAEMON_FQDN_CIDR].id
    addrs = list(DAEMON_FQDN_IPS) + [ep.ipv4 for ep in eps] + ["10.97.0.1", "172.16.5.5", DAEMON_NODE]
    words = _i32([int(ipaddress.IPv4Address(a)) for a in addrs])
    words = np.resize(words, F)
    lpm = dm.ipcache_map.to_device(device=dev)
    found, value, _ = (x.cpu().numpy() for x in counted(
        "daemon-ipcache", lambda: lpm_mod.lpm_lookup(lpm, torch.from_numpy(words).to(dev))))
    for i, a in enumerate(addrs):
        info = dm.ipcache_map.lookup(a)
        if bool(found[i]) != (info is not None) or (info is not None and int(value[i]) != info.sec_label):
            raise AssertionError(f"daemon-ipcache: {a} != IpcacheMap.lookup")
    for i in range(len(DAEMON_FQDN_IPS)):
        if not found[i] or int(value[i]) != cidr_id:
            raise AssertionError(f"daemon-ipcache: {addrs[i]} not found under {DAEMON_FQDN_CIDR}'s identity")
    if not (np.resize(found[:len(addrs)], F) == found).all():
        raise AssertionError("daemon-ipcache: rows of one address disagree")
    log(f"daemon-fqdn: the poller's {len(want_cidrs)} CIDRs regenerated endpoint {fq_ep.id} in "
        f"{stages['fqdn'][0]:.3f} s; K12 on the daemon's ipcache map ({lpm.n} prefixes) finds them under "
        f"{DAEMON_FQDN_CIDR}'s identity {cidr_id}, == IpcacheMap.lookup on {len(addrs)} addresses")

    # 8. HTTP conns through the service on the pushed policies (after the
    # FQDN's round of regenerations: each push rebuilds every engine a conn
    # has bound in the service, so the round before any conn pushes cheaply)
    pols = [network_policy_for_endpoint(ep, cache) for ep in eps]
    names, rounds = policy_npds_traffic(random.Random(31), eps, pols, pool)
    shifts = iter(range(DAEMON_BASE - SIDE_BASES["http"], 1 << 40, 1000))

    def serve(tag, rnds=None):
        rnds = rounds if rnds is None else rnds
        shift = next(shifts)
        driver = SidecarDriver(svc_path, "socket", None, base_shift=shift)
        try:
            fids = driver.open("http", rnds, names=names)
            out = counted(tag, lambda: driver.run("http", rnds, lambda fid: 0))
            driver.close("http", fids)
        finally:
            driver.close_client()
        return out, SIDE_BASES["http"] + shift

    served, base = serve("daemon-service")
    oracle = sidecar_oracle("http", rounds, pols, name=names, port=80, base=base)
    bad = side_mismatches(served, oracle)
    daemon_mismatch_lines("daemon-service", served, oracle, rounds, names)
    ops = [op for rnd in oracle for o, _, _ in rnd.values() for op, _ in o]
    log(f"daemon-service: {len(eps)} endpoints' NPDS policies ({pusher.pushes} pushes, 0 NACKs), "
        f"{POLICY_NPDS_CONNS} conns x {len(rounds)} rounds, {side_frames(oracle)} requests "
        f"({ops.count(1)} PASS, {ops.count(2)} DROP): {bad} mismatches against the in-process proxylib oracle")
    if bad or not ops.count(1) or not ops.count(2):
        raise AssertionError("daemon-service: the service disagrees, or allows or denies everything")

    # 9. delete rules. The endpoints' policies after the delete, resolved
    # beforehand from a repository of the remaining rules, name the conns
    # whose verdicts change; one of them is probed until its verdict
    # changes. Then new conns are held to the oracle on the regenerated
    # policies, which must equal the prediction.
    kept = Repository()
    for rule in rules_from_json(json.dumps([r for r in json.loads(doc) if DAEMON_DELETE_LABEL not in r["labels"]])):
        kept.add(rule)
    pred = [network_policy_for_endpoint(SimpleNamespace(
        id=ep.id, ipv4=ep.ipv4, security_identity=ep.security_identity, desired_l4_policy=L4Policy(
            ingress=kept.resolve_l4_ingress_policy(SearchContext(to_labels=ep.security_label_array())))), cache)
        for ep in eps]
    oracle_pred = sidecar_oracle("http", rounds, pred, name=names, port=80, base=base)
    moved = sorted({fid for o, p in zip(oracle, oracle_pred) for fid in o if o[fid] != p.get(fid)})
    if not moved:
        raise AssertionError("daemon-delete: the delete changes the verdict of no conn")
    probe_rounds = [[e for e in rnd if e[0] == moved[0]] for rnd in rounds]
    probe_before = [{moved[0]: rnd[moved[0]]} for rnd in served]
    regen0 = regenerations()
    t_del = time.monotonic()
    deleted = dm.policy_delete(LabelArray.parse(DAEMON_DELETE_LABEL))[1]
    t_deleted = time.monotonic()
    rev_del = dm.policy.get_revision()
    first_change, probes = None, 0
    while first_change is None:
        done = settled(dm, eps, rev_del)
        out, _ = serve("daemon-delete-probe", probe_rounds)
        probes += 1
        if side_mismatches(out, probe_before):
            first_change = time.monotonic() - t_del
        elif done:
            break
        elif time.monotonic() - t_del > DAEMON_WAIT_S:
            raise AssertionError("daemon: endpoints did not settle after the delete")
        else:
            time.sleep(0.2)  # the build-queue workers share the host's cores with the probe
    wait_for(lambda: settled(dm, eps, rev_del), "every endpoint ready after the delete")
    t_settle = time.monotonic() - t_del
    pols2 = [network_policy_for_endpoint(ep, cache) for ep in eps]
    served2, base2 = serve("daemon-delete")
    oracle2 = sidecar_oracle("http", rounds, pols2, name=names, port=80, base=base2)
    bad2 = side_mismatches(served2, oracle2)
    daemon_mismatch_lines("daemon-delete", served2, oracle2, rounds, names)
    changed = side_mismatches(served2, served)
    changed_fids = sorted({fid for g, w in zip(served2, served) for fid in g if g[fid] != w.get(fid)})
    if [dataclasses.asdict(x) for x in pols2] != [dataclasses.asdict(x) for x in pred] or changed_fids != moved:
        raise AssertionError("daemon-delete: the regenerated policies or the changed conns differ from the "
                             "prediction of a repository of the remaining rules")
    stage("delete", t_settle, deleted=deleted, delete_calls_s=round(t_deleted - t_del, 3),
          first_changed_verdict_s=first_change, probes=probes, regenerations=regenerations() - regen0,
          pushes=pusher.pushes, nacks=pusher.nacks)
    log(f"daemon-delete: {deleted} rules deleted; first changed verdict "
        f"{'none' if first_change is None else f'{first_change:.3f} s'} after the delete ({probes} probes of "
        f"conn {moved[0]}); endpoints settled in {t_settle:.3f} s; {changed} (conn, round) outputs of "
        f"{len(moved)} conns changed, as predicted; new conns {bad2} mismatches against the oracle on the "
        "regenerated policies, which equal the prediction")
    if deleted != DAEMON_DELETE or bad2 or not changed or first_change is None or pusher.nacks:
        raise AssertionError("daemon-delete: mismatches, a NACK, or no verdict changed")

    # 10. restart: a second daemon on the same run_dir; the policy is added
    # again, then the endpoints are restored from the run_dir and regenerate
    # once (as the agent waits for its policy sources before it regenerates
    # restored endpoints); K13 on the restored maps
    dm.close()
    held.pop("daemon")
    regen0 = regenerations()
    t0 = time.monotonic()
    dm2 = held["daemon"] = Daemon(dataclasses.replace(cfg, restore_state=False), node_name="agent-16")
    rev2 = dm2.policy_add(rules_from_json(doc))
    t_policy2 = time.monotonic() - t0
    n_restored = dm2.restore_endpoints()
    restored = sorted(dm2.endpoint_manager.get_endpoints(), key=lambda ep: ep.id)
    t_restored = time.monotonic() - t0
    if n_restored != len(eps) or [ep.id for ep in restored] != [ep.id for ep in eps] or any(
            ep.device.type != dev.type for ep in restored):
        raise AssertionError(f"daemon restart: restored {[ep.id for ep in restored]} on the wrong device")
    wait_for(lambda: settled(dm2, restored, rev2) and all(ep.policy_revision == rev2 for ep in restored),
             "every restored endpoint ready at the re-added policy")
    stage("restart", time.monotonic() - t0, restored=len(restored), policy_s=round(t_policy2, 3),
          restore_s=round(t_restored, 3), regenerations=regenerations() - regen0,
          redirects=len(dm2.proxy_manager.redirects))
    k13_again_in = {ep.id: ep.device_policy_map for ep in restored}
    ports10 = {r.proxy_port: pid for pid, r in dm2.proxy_manager.redirects.items()}
    moved = 0
    k13_again = counted("daemon-restart", lambda: {i: pol_mod.policy_can_access_batch(m, *q7_dev, DIR_INGRESS)
                                                   for i, m in k13_again_in.items()})
    for i, got in k13_again.items():
        a0, p0 = (x.cpu().numpy() for x in k13[i])
        a1, p1 = (x.cpu().numpy() for x in got)
        if not np.array_equal(a0, a1) or [ports7.get(int(x), int(x)) for x in p0] != [
                ports10.get(int(x), int(x)) for x in p1]:
            raise AssertionError(f"daemon restart: endpoint {i}'s K13 outputs differ from before the restart")
        moved += int((p0 != p1).sum())
    log(f"daemon-restart: {len(restored)} endpoints restored {t_restored:.3f} s and ready at the re-added "
        f"policy {stages['restart'][0]:.3f} s after the second daemon began; K13 on their maps == step 7's "
        f"(verdicts equal; proxy ports equal as redirects: {moved} outputs carry a redirect's new port, the "
        "ports being allocated in the order the build-queue workers reach the endpoints)")
    sync()
    launches = {n: sum(r[n] for r in runs.values()) for n in kerns}
    total = counts()
    runs["daemon-build"] = {n: total[n] - launches[n] for n in kerns}  # outside every step: the builds
    launches = total
    status = dm2.status()
    metric_lines = [ln for ln in dm2.metrics_text().splitlines() if ln and not ln.startswith("#")]
    dm2.close()
    held.pop("daemon")

    # 11. report
    log("daemon status:", json.dumps(status, default=str, sort_keys=True))
    log(f"daemon metrics_text: {len(metric_lines)} samples; " + ", ".join(
        ln for ln in metric_lines if ln.split("{")[0].split(" ")[0] in (
            "cilium_tpu_endpoint_regenerations_total", "cilium_tpu_policy_count",
            "cilium_tpu_endpoint_count", "cilium_tpu_policy_max_revision")))
    log("daemon stages (host clock s): " + json.dumps({name: secs for name, (secs, _) in stages.items()}))
    log("launches:", json.dumps({n: v for n, v in launches.items() if v}))
    log("launches by run:", json.dumps({n: {k: c for k, c in r.items() if c} for n, r in runs.items()}))
    if on_card:
        for n in ("dfa_scan", "http_frame", "http_lit", "http_hits", "lpm_lookup", "policy_can_access",
                  "kafka_hits"):
            if launches[n] <= 0:
                raise AssertionError(f"kernel {n} was not launched on the daemon slice's main path")
        want = {"daemon-policy": {"policy_can_access": len(eps)}, "daemon-restart": {"policy_can_access": len(eps)},
                "daemon-prefilter": {"lpm_lookup": 1}, "daemon-ipcache": {"lpm_lookup": 1}}
        for name, wv in want.items():
            got = {k: c for k, c in runs[name].items() if c}
            if got != wv:
                raise AssertionError(f"{name}: launches {got} != {wv}")
        for name, names_ in (("daemon-service", ("http_frame", "http_lit", "http_hits")),
                             ("daemon-http-engine", ("http_frame", "http_lit", "http_hits")),
                             ("daemon-kafka-engine", ("kafka_hits",)),
                             ("daemon-delete", ("http_frame", "http_lit", "http_hits"))):
            missing = [n for n in names_ if not runs[name][n]]
            if missing:
                raise AssertionError(f"{name}: {missing} never launched")

    # the kernels against their plain versions at the slice's inputs: K13 on
    # every map, K12 on the prefilter and the ipcache map, K5-K7 and K2 / K3
    # on the daemon's HTTP engine model, K17 on its Kafka model
    log("== daemon kernels vs plain")
    report = {}

    def put(kname, label, got, want):
        report.setdefault(kname, {})[label] = max_abs_err(_flat(got), _flat(want))

    for tag, maps in (("daemon-policy", k13_in), ("daemon-restart", k13_again_in)):
        for i, m in maps.items():
            put("policy_can_access", f"{tag}/{i}", pol_mod.policy_can_access_batch(m, *q7_dev, DIR_INGRESS),
                pol_mod.policy_can_access_plain(m, *q7_dev, DIR_INGRESS))
    w4 = torch.from_numpy(words4).to(dev)
    pf_lpm = dm.prefilter.device_lpm()
    put("lpm_lookup", "daemon-prefilter", lpm_mod.lpm_lookup(pf_lpm, w4), lpm_mod.lpm_lookup_plain(pf_lpm, w4))
    wd = torch.from_numpy(words).to(dev)
    put("lpm_lookup", "daemon-ipcache", lpm_mod.lpm_lookup(lpm, wd), lpm_mod.lpm_lookup_plain(lpm, wd))
    heads = entry.policy_http_requests(POLICY_PERIOD)
    rem = policy_remotes(random.Random(28), pool, POLICY_PERIOD)
    data, lengths, rm = (torch.from_numpy(a).to(dev) for a in tile_heads(heads, rem, POLICY_PERIOD, POLICY_L))
    frame = http_frame(data, lengths)
    put("http_frame", "daemon-http", frame, http_frame_plain(data, lengths))
    lit = http_lit(hmodel, data, frame)
    put("http_lit", "daemon-http", lit, http_lit_plain(hmodel, data, frame))
    spans = {"method": (hmodel.line_nfa, torch.zeros_like(frame.sp1), frame.sp1, hmodel.has_method_rx),
             "path": (hmodel.line_nfa, frame.p_start, frame.sp2, hmodel.has_path_rx),
             "head": (hmodel.head_nfa, frame.line_end, frame.h_end, hmodel.head_nfa is not None)}
    rx = {}
    for span, (tab, s, e, on) in spans.items():
        if not on:
            continue
        if isinstance(tab, DeviceDfa):
            kname, scan, plain = "dfa_scan", dfa_mod.dfa_search_spans, dfa_mod.dfa_scan_plain
        else:
            kname, scan, plain = "nfa_scan", nfa_mod.nfa_search_spans, nfa_mod.nfa_scan_plain
        rx[span] = scan(tab, data, s, e)
        put(kname, f"daemon-http:{span}", [rx[span]], [plain(tab, data, s, e)])
    args = (frame.complete, *lit, rx.get("method"), rx.get("path"), rx.get("head"), rm)
    put("http_hits", "daemon-http", http_hits(hmodel, *args), http_hits_plain(hmodel, *args))
    kreqs = [parse_request(fr) for fr in entry.policy_kafka_frames(POLICY_PERIOD)]
    kb = encode_requests(kreqs).to_device(dev)
    krem = torch.from_numpy(np.asarray(policy_remotes(random.Random(30), pool, POLICY_PERIOD), np.int32)).to(dev)
    put("kafka_hits", "daemon-kafka", [kafka_hits(kmodel, kb, krem)], [kafka_verdicts_plain(kmodel, kb, krem)])
    log("max |kernel - plain|:", json.dumps(report))
    for kname, per in report.items():
        for label, err in per.items():
            if err != 0:
                raise AssertionError(f"{kname} disagrees with its plain version on {label}")
    return launches, runs, report, {}


# --- phase 17: the agent's front doors, a node from a CNP to verdicts ------------

K8S_SEED = 17  # the world's documents (tests/k8s_world.py)
# The endpoints whose NPDS policies the service's conns use: each push
# rebuilds every engine a conn has bound, and a CNP delete regenerates every
# endpoint (each one a push), so the conns use few policies; the 110 pods stay.
K8S_CONN_ENDPOINTS = 8
K8S_K13_F = 8192  # queries a endpoint map
K8S_SAMPLE = 2000  # of them held to the host oracles
K8S_CUT_SERVICES = 64  # Services that lose backends
K8S_CUT_BACKENDS = 2
K8S_CNI_DEL = 10
K8S_WORKLOADS = 8  # containers through the workloads watcher, and through the libnetwork driver
K8S_AGENT_ENDPOINTS = 8
K8S_AGENT_WAIT_S = 120.0
K8S_BASE = 9_000_000  # the service conns' ids; each later drive 1,000 above the last
K8S_WAIT_S = 300.0


def cli_out(cli, argv):
    """(exit code, stdout) of the CLI's ``main(argv)`` in this process."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def bugtool_device(path):
    """The ``device.json`` member of a bugtool bundle."""
    import tarfile

    with tarfile.open(path) as tar:
        return json.load(tar.extractfile("cilium-tpu-bugtool/device.json"))


def agent_map(map_out, ident_out):
    """A ``map get`` JSON dump with each identity named by its labels
    (from an ``identity list`` JSON dump), sorted."""
    names = {e["id"]: tuple(sorted(e["labels"])) for e in json.loads(ident_out)}
    return sorted((names.get(e["identity"], e["identity"]), e["dport"], e["proto"], e["direction"],
                   e["proxy_port"] != 0) for e in json.loads(map_out))


def k8s_slice(dev, card, kerns):
    """Phase 17, the agent's front doors on the card: a ``Daemon`` fed by
    the Kubernetes watcher, CNI and IPAM (tests/k8s_world.py), reached
    through an in-process ``ApiServer`` and the CLI, a verdict service on
    its NPDS, the workloads watcher and the libnetwork driver, then the
    agent as its own process; counted in a run of its own over every
    kernel.  ``option.config``, the kvstore client and the proxylib
    registry are put back after it.  Returns (launches, runs, report, timed)."""
    import tempfile

    from cilium_tpu_torch import kvstore as kv_mod
    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.utils import option

    kw = _tests_module("k8s_world")
    log("== k8s slice")
    t_phase = time.monotonic()
    saved = option.config, kv_mod._default_client
    held = {}
    inst.reset_module_registry()
    try:
        with tempfile.TemporaryDirectory(prefix="k8s-", dir=".") as tmp:
            try:
                out = _k8s_runs(dev, card, kerns, kw, tmp, held)
            finally:
                proc = held.pop("proc", None)
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait(30)
                for key in ("world", "api", "driver", "watcher", "svc", "daemon", "agent_cpu"):
                    obj = held.pop(key, None)
                    if obj is not None:
                        (obj.stop if key == "svc" else obj.close)()
    finally:
        option.config, kv_mod._default_client = saved
        inst.reset_module_registry()
    log(f"k8s slice: {time.monotonic() - t_phase:.1f} s")
    return out


CONTRACTS_SEED = 1
CONTRACTS_LINT_S = 300.0  # the linter process: about 40 s on one core


def contracts_slice(dev, card, kerns):
    """Phase 18, the device contracts on the card: the port's
    ``check_device_contracts`` (the card is its default), every captured
    graph replayed on fresh inputs against its CPU twin, and the port's
    linter over the package in a process of its own, started first and
    waited for last; counted in a run of its own over every kernel.
    Returns (launches, runs, report, timed)."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.analysis import devicecheck as dc

    log("== contracts slice")
    t_phase = time.monotonic()
    on_card = dev.type == "cuda"
    lint = subprocess.Popen(
        [sys.executable, "-m", "cilium_tpu_torch.analysis.cli", "--json", "--ratchet",
         "cilium_tpu_torch"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        out = _contracts_runs(dev, card, kerns, dc, kernels, on_card)
        lint_out, lint_err = lint.communicate(timeout=CONTRACTS_LINT_S)
    finally:
        if lint.poll() is None:
            lint.kill()
            lint.wait(30)
    try:
        rep = json.loads(lint_out)
    except ValueError:
        raise AssertionError(f"linter: rc {lint.returncode}, no report: {lint_err[-2000:]}")
    log(f"contracts lint: {rep['total']} active, {len(rep['suppressed'])} suppressed, rc "
        f"{lint.returncode} ({time.monotonic() - t_phase:.1f} s into the phase, host clock)")
    if lint.returncode != 0 or rep["total"]:
        raise AssertionError(f"linter: rc {lint.returncode}, findings {rep['findings'][:5]} "
                             f"{lint_err[-2000:]}")
    log(f"contracts slice: {time.monotonic() - t_phase:.1f} s")
    return out


def _contracts_runs(dev, card, kerns, dc, kernels, on_card):
    cpu = torch.device("cpu")

    def counts():
        return {n: k.launches + k.replayed for n, k in kerns.items()}

    # the main path, counted: every count is 0 from here to the last check
    for k in kerns.values():
        k.launches = 0
        k.replayed = 0
    captures = []
    t0 = time.monotonic()
    findings = dc.check_device_contracts(None if on_card else "cpu", captures=captures)
    if on_card:
        torch.cuda.synchronize()
    t_check = time.monotonic() - t0
    for f in findings:
        log("contract finding:", f.render())
    if findings:
        raise AssertionError(f"{len(findings)} device-contract finding(s)")
    log(f"contracts: 0 findings over {len(captures)} traced calls in {t_check:.1f} s (host clock) [{card}]")
    after_check = counts()
    runs = {"contracts-check": dict(after_check)}

    # every captured graph replayed on fresh inputs, held to its CPU twin
    twins = dc.case_calls(cpu)
    report, per_kernel = {}, {}
    fresh = {dev: dc.batch(dev, seed=CONTRACTS_SEED), cpu: dc.batch(cpu, seed=CONTRACTS_SEED)}
    for tag, fn, cap in captures:
        twin_fn, twin_args = twins[tag]
        if isinstance(cap.ins[0], torch.Tensor):  # a row batch: fresh rows
            for dst, src in zip(cap.ins, fresh[dev]):
                dst.copy_(src)
            twin_args = fresh[cpu]
        before = counts()
        if on_card:
            cap.graph.replay()
            kernels.add_replays(cap.held)
            torch.cuda.synchronize()
            got = dc._outputs(cap.outs)
        else:
            got = dc._outputs(fn(*cap.ins))
        now = counts()
        run = {n: now[n] - before[n] for n in kerns}
        runs[f"contracts-{tag}"] = run
        held = cap.launches()
        if on_card and {n: c for n, c in run.items() if c} != held:
            raise AssertionError(f"contracts {tag}: a replay launched {run}, its graph holds {held}")
        err = max_abs_err([g.cpu() for g in got], dc._outputs(twin_fn(*twin_args)))
        if err:
            raise AssertionError(f"contracts {tag}: the replay disagrees with its CPU twin by {err}")
        for n, c in held.items():
            report.setdefault(n, {})[f"contracts-{tag}"] = err
            per_kernel[n] = per_kernel.get(n, 0) + c
        log(f"contracts {tag}: replay == plain, launches a replay "
            + ", ".join(f"{n} {c}" for n, c in sorted(held.items())))
    launches = counts()
    if on_card:
        torch.cuda.synchronize()
        missing = sorted(n for n in per_kernel if not launches[n])
        if missing:
            raise AssertionError(f"contracts: kernels of the path never launched: {missing}")
    log("contracts launches by kernel (warm calls, service rounds and replays): "
        + ", ".join(f"{n} {c}" for n, c in sorted(launches.items()) if c) + f" [{card}]")
    log("contracts replayed by kernel (the replay check alone): "
        + ", ".join(f"{n} {c}" for n, c in sorted(per_kernel.items())))
    return launches, runs, report, {}


def _k8s_runs(dev, card, kerns, kw, tmp, held):
    import os
    import signal
    import tarfile

    from cilium_tpu_torch import cli
    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.api import ApiClient, ApiServer
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.datapath import pipeline as dp_mod
    from cilium_tpu_torch.datapath.prefilter import PreFilter
    from cilium_tpu_torch.k8s import IpamAllocator, parse_cnp, parse_network_policy
    from cilium_tpu_torch.k8s.cni import CniError
    from cilium_tpu_torch.maps import lbmap as lb_mod
    from cilium_tpu_torch.maps import policymap as pol_mod
    from cilium_tpu_torch.maps.policymap import DIR_INGRESS
    from cilium_tpu_torch.models.http import (
        build_http_model_for_port,
        http_frame,
        http_frame_plain,
        http_hits,
        http_hits_plain,
        http_lit,
        http_lit_plain,
    )
    from cilium_tpu_torch.ops import dfa as dfa_mod
    from cilium_tpu_torch.ops import lpm as lpm_mod
    from cilium_tpu_torch.ops import nfa as nfa_mod
    from cilium_tpu_torch.ops.dfa import DeviceDfa
    from types import SimpleNamespace

    from cilium_tpu_torch.plugins.docker import LibnetworkDriver
    from cilium_tpu_torch.policy import L4Policy, Repository, SearchContext
    from cilium_tpu_torch.policy.serialize import rules_to_json
    from cilium_tpu_torch.proxy.npds_push import network_policy_for_endpoint
    from cilium_tpu_torch.proxylib import compile_policy
    from cilium_tpu_torch.sidecar import VerdictService
    from cilium_tpu_torch.utils.option import DaemonConfig
    from cilium_tpu_torch import workloads as workloads_mod
    from cilium_tpu_torch.workloads import EventType, WorkloadWatcher

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counts():
        return {n: k.launches + k.replayed for n, k in kerns.items()}

    runs, stages, sections = {}, {}, {}

    def stage(name, secs, **info):
        stages[name] = (secs, info)
        log(f"k8s {name}: {secs:.3f} s (host clock); " + ", ".join(f"{k} {v}" for k, v in info.items())
            + f" [{card}]")

    def counted(name, fn):
        before = counts()
        out = fn()
        sync()
        now = counts()
        run = runs.setdefault(name, dict.fromkeys(kerns, 0))
        for n in kerns:
            run[n] += now[n] - before[n]
        return out

    def wait_for(cond, what, timeout=K8S_WAIT_S):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"k8s: {what} within {timeout:.0f} s")
            time.sleep(0.02)

    def u32(x):
        return int(np.int64(x) & 0xFFFFFFFF)

    def ip_int(ip):
        return int(ipaddress.IPv4Address(ip))

    cfg = DaemonConfig(
        run_dir=f"{tmp}/run", dry_mode=False, enable_health=False, verdict_device="default" if on_card else "cpu",
        socket_path=f"{tmp}/agent.sock", monitor_socket_path=f"{tmp}/monitor.sock",
        proxy_ack_timeout_s=DAEMON_ACK_TIMEOUT_S,
    )

    # the main path, counted: every count is 0 from here to the last check
    log("== k8s main path (counted)")
    for k in kerns.values():
        k.launches = 0
        k.replayed = 0
    t_sec = time.monotonic()

    # 1. the daemon on the card, its REST API, and the node built through
    # the watcher, IPAM and CNI
    t0 = time.monotonic()
    dm = held["daemon"] = Daemon(cfg, node_name="node-0")
    if {dm.device.type, dm.prefilter.device.type, dm.endpoint_manager.device.type} != {dev.type}:
        raise AssertionError(f"k8s: daemon device {dm.device}, not {dev}")
    sock = cfg.socket_path
    held["api"] = ApiServer(dm, sock)
    stage("start", time.monotonic() - t0)
    w = held["world"] = kw.build_world(kw.modules("cilium_tpu_torch"), dm, kw.Scale(timeout=K8S_WAIT_S),
                                       seed=K8S_SEED)
    for name, (secs, info) in w.stages.items():
        stage(f"world-{name}", secs, **info)
    eps = w.endpoints()
    if len(eps) != w.scale.pods or any(ep.device_policy_map is None or ep.device_policy_map.device.type != dev.type
                                       for ep in eps):
        raise AssertionError("k8s: a pod's endpoint has no policy map on the daemon's device")
    cache = dm.get_identity_cache()
    pool = sorted(cache)
    sections["world"] = time.monotonic() - t_sec

    # 2. the CLI against the API server
    t_sec = time.monotonic()
    base = ["--socket", sock]
    outs = {}
    first = eps[0]
    for key, argv in (("status", ["status"]), ("endpoint-list", ["endpoint", "list"]),
                      ("endpoint-get", ["endpoint", "get", str(first.id)]), ("identity-list", ["identity", "list"]),
                      ("map-list", ["map", "list"]), ("map-get", ["map", "get", f"policy-{first.id}"]),
                      ("service-list", ["service", "list"]), ("prefilter-list", ["prefilter", "list"])):
        rc, out = cli_out(cli, base + argv)
        if rc != 0:
            raise AssertionError(f"k8s cli {' '.join(argv)}: exit {rc}")
        outs[key] = out
    if f"Endpoints:      {len(eps)} (ready={len(eps)})" not in outs["status"]:
        raise AssertionError(f"k8s cli status: {outs['status']!r}")
    listed = outs["endpoint-list"].splitlines()[1:]
    if sorted(int(ln.split()[0]) for ln in listed) != [ep.id for ep in eps]:
        raise AssertionError("k8s cli endpoint list: not the daemon's endpoints")
    got_ep = json.loads(outs["endpoint-get"])
    if (got_ep["ipv4"], got_ep["identity"], got_ep["policy_map_entries"]) != (
            first.ipv4, first.security_identity.id, len(first.policy_map.entries)):
        raise AssertionError("k8s cli endpoint get: not the daemon's endpoint")
    if {e["id"] for e in json.loads(outs["identity-list"])} != set(cache):
        raise AssertionError("k8s cli identity list: not the daemon's identity cache")
    if not {f"policy-{ep.id}" for ep in eps} <= set(outs["map-list"].split()):
        raise AssertionError("k8s cli map list: an endpoint's policy map is missing")
    want_map = sorted((k.identity, k.dest_port, k.proto, k.direction, v.proxy_port)
                      for k, v in first.policy_map.dump())
    if sorted((e["identity"], e["dport"], e["proto"], e["direction"], e["proxy_port"])
              for e in json.loads(outs["map-get"])) != want_map:
        raise AssertionError("k8s cli map get: not the endpoint's policy map")
    fronts = [ln.split()[1] for ln in outs["service-list"].splitlines()]
    n_services = len(fronts)
    if sorted(fronts) != sorted(f"{kw.service_vip(s)}:{kw.HTTP_PORT}/TCP" for s in range(w.scale.services)):
        raise AssertionError(f"k8s cli service list: {n_services} frontends, not the {w.scale.services} Services'")
    # policy trace: a CNP's source and destination on 80/TCP, and a source
    # no rule admits
    cnp0 = w.cnps[0]["spec"]
    ns0 = w.cnps[0]["metadata"]["namespace"]
    dst = ",".join(f"k8s:{k}={v}" for k, v in cnp0["endpointSelector"]["matchLabels"].items()) + f",{kw.NS_LABEL}={ns0}"
    src = ",".join(f"k8s:{k}={v}" for k, v in cnp0["ingress"][0]["fromEndpoints"][0]["matchLabels"].items()) \
        + f",{kw.NS_LABEL}={ns0}"
    rc_allow, out_allow = cli_out(cli, base + ["policy", "trace", "--src", src, "--dst", dst, "--dport", "80/TCP"])
    rc_deny, out_deny = cli_out(cli, base + ["policy", "trace", "--src", "k8s:app=nobody", "--dst", dst,
                                              "--dport", "80/TCP"])
    if (rc_allow, rc_deny) != (0, 1):
        raise AssertionError(f"k8s cli policy trace: {out_allow!r} / {out_deny!r}")
    log(f"k8s-cli: status, endpoint list ({len(listed)}) / get, identity list ({len(cache)}), map list / get "
        f"({len(want_map)} entries of endpoint {first.id}), service list ({n_services}), policy trace "
        f"(allowed / denied) == the daemon's state")

    # 3. the prefilter through the CLI, then K12 on it
    cidrs, src4, _ = prefilter_case(F)
    words4 = _i32(src4)
    rev0 = json.loads(outs["prefilter-list"])["revision"]
    rc, out = cli_out(cli, base + ["prefilter", "update", "--revision", str(rev0)]
                      + [a for c in cidrs for a in ("--cidr", c)])
    if rc != 0 or dm.prefilter.dump()[0] != rev0 + 1:
        raise AssertionError(f"k8s cli prefilter update: exit {rc}, {out!r}")
    keep = counted("k8s-prefilter", lambda: dm.prefilter.filter_batch(words4))
    pf_cpu = PreFilter(device="cpu")
    pf_cpu.insert(pf_cpu.revision, cidrs)
    if not np.array_equal(keep, pf_cpu.filter_batch(words4)):
        raise AssertionError("k8s-prefilter: the keep mask differs from the CPU path")
    deny = [n for n in map(ipaddress.ip_network, cidrs) if n.version == 4]
    for i in sorted(random.Random(43).sample(range(F), K8S_SAMPLE)):
        if bool(keep[i]) == any(ipaddress.ip_address(src4[i]) in n for n in deny):
            raise AssertionError(f"k8s-prefilter: source {i} disagrees with the deny sets")
    log(f"k8s-prefilter: {len(cidrs)} CIDRs through `prefilter update`; K12 at F={F} == the CPU path, == the deny "
        f"sets on {K8S_SAMPLE}; drop share {1 - float(keep.mean()):.3f}")

    # 4. the bugtool bundle through the CLI
    bundle = f"{tmp}/bugtool.tar.gz"
    rc, out = cli_out(cli, base + ["bugtool", "-o", bundle])
    dev_json = bugtool_device(bundle)
    want_name = card.split(",")[0].strip()
    names = [d["name"] for d in dev_json["devices"]]
    if on_card and (rc != 0 or dev_json["backend"] != "cuda" or names[:1] != [want_name]):
        raise AssertionError(f"k8s cli bugtool: exit {rc}, {out!r}, device.json {dev_json}")
    with tarfile.open(bundle) as tar:
        members = len(tar.getmembers())
    log(f"k8s-bugtool: {members} members; device.json {json.dumps(dev_json)} names {names[:1]} "
        f"(nvidia-smi: {want_name})")
    sections["cli"] = time.monotonic() - t_sec

    # 5. K13 on every endpoint's map, K13's LB on the watcher's LB map, K14
    # on tables from the daemon's maps
    t_sec = time.monotonic()
    rng = np.random.default_rng(K8S_SEED)
    qpool = np.asarray(pool + [99_999], np.int64)
    q13 = (_i32(rng.choice(qpool, K8S_K13_F)),
           _i32(rng.choice(np.array([80, 443, 5432, 6379, 8080, 0]), K8S_K13_F, p=[0.4, 0.1, 0.1, 0.1, 0.2, 0.1])),
           _i32(rng.choice(np.array([6, 17, 0]), K8S_K13_F, p=[0.8, 0.1, 0.1])))
    q13_dev = tuple(torch.from_numpy(a).to(dev) for a in q13)
    q13_cpu = tuple(torch.from_numpy(a) for a in q13)
    sample13 = [i for i in sorted(random.Random(K8S_SEED).sample(range(K8S_K13_F), K8S_SAMPLE)) if q13[1][i] != 0]

    def k13_policy(tag, endpoints):
        maps = {ep.id: ep.device_policy_map for ep in endpoints}
        got = counted(tag, lambda: {i: pol_mod.policy_can_access_batch(m, *q13_dev, DIR_INGRESS)
                                    for i, m in maps.items()})
        shares = []
        for ep in endpoints:
            g = [x.cpu() for x in got[ep.id]]
            want = pol_mod.policy_can_access_batch(ep.policy_map.to_device(device="cpu"), *q13_cpu, DIR_INGRESS)
            if max_abs_err(g, list(want)) != 0:
                raise AssertionError(f"{tag}: endpoint {ep.id}'s map on {dev} differs from the CPU path")
            a, pp = g[0].numpy(), g[1].numpy()
            for i in sample13:
                if (bool(a[i]), int(pp[i])) != ep.policy_map.lookup(int(q13[0][i]), int(q13[1][i]), int(q13[2][i]),
                                                                    DIR_INGRESS, count_packets=False):
                    raise AssertionError(f"{tag}: endpoint {ep.id} query {i} != PolicyMap.lookup")
            shares.append(float(a.mean()))
        log(f"{tag}: K13 on {len(endpoints)} endpoint maps ({sum(len(ep.policy_map.entries) for ep in endpoints)} "
            f"entries) x {K8S_K13_F} queries == the CPU path, {len(sample13)} a map == PolicyMap.lookup; allowed "
            f"share {min(shares):.3f}-{max(shares):.3f}")
        return maps

    k13_maps = k13_policy("k8s-policy", eps)
    vips = np.array([ip_int(kw.service_vip(s)) for s in range(w.scale.services)] + [ip_int("172.21.0.1")], np.int64)

    def lb_case(seed):
        r = np.random.default_rng(seed)
        return (_i32(vips[r.integers(0, len(vips), F)]),
                _i32(r.choice(np.array([kw.HTTP_PORT, 443], np.int64), F, p=[0.9, 0.1])),
                _i32(r.integers(0, 1 << 32, F, dtype=np.int64)))

    def k13_lb(tag, q):
        tab = dm.lb_map.to_device(device=dev)
        out = counted(tag, lambda: lb_mod.lb4_select_backend_batch(tab, *(torch.from_numpy(a).to(dev) for a in q)))
        got = [x.cpu().numpy() for x in out]
        want = lb_mod.lb4_select_backend_batch(dm.lb_map.to_device(device="cpu"), *(torch.from_numpy(a) for a in q))
        if max_abs_err([torch.from_numpy(x) for x in got], list(want)) != 0:
            raise AssertionError(f"{tag}: the card differs from the CPU path")
        for i in sorted(random.Random(K8S_SEED + 1).sample(range(F), K8S_SAMPLE)):
            b = dm.lb_map.select_backend(u32(q[0][i]), int(q[1][i]), u32(q[2][i]))
            g = (bool(got[0][i]),) + ((u32(got[1][i]), int(got[2][i]), int(got[3][i])) if got[0][i] else ())
            if g != ((True, b.target, b.port, b.rev_nat_index) if b is not None else (False,)):
                raise AssertionError(f"{tag}: flow {i} != LbMap.select_backend")
        log(f"{tag}: K13's LB on the watcher's LB map ({len(dm.service_manager)} services, "
            f"{len(dm.lb_map.dump())} entries) at F={F} == the CPU path, == select_backend on {K8S_SAMPLE}; "
            f"found share {got[0].mean():.3f}")
        return tab

    lb_q = lb_case(K8S_SEED + 2)
    lb_tab = k13_lb("k8s-lb", lb_q)

    # K14: egress from a pod a toServices CNP selects (its egress is
    # enforced); 40% to Service VIPs, 40% to pods on 80 / 443 / 8080, 20%
    # outside
    dp_ep = next(ep for ep in eps[: len(eps) - K8S_CNI_DEL] if ep.egress_policy_enabled)  # CNI DEL takes the last
    pod_ips = np.array([ip_int(ep.ipv4) for ep in eps], np.int64)
    r14 = np.random.default_rng(K8S_SEED + 3)
    saddr = np.full(F, ip_int(dp_ep.ipv4), np.int64)
    roll = r14.random(F)
    daddr = pod_ips[r14.integers(0, len(pod_ips), F)]
    to_vip, outside = roll < 0.4, roll >= 0.8
    daddr[to_vip] = vips[r14.integers(0, len(vips) - 1, int(to_vip.sum()))]
    daddr[outside] = r14.integers(ip_int("11.0.0.0"), ip_int("11.255.255.255"), int(outside.sum()))
    dport = r14.choice(np.array([80, 443, 8080], np.int64), F)
    dport[to_vip] = kw.HTTP_PORT
    pk14 = tuple(_i32(x) for x in (saddr, daddr, r14.integers(1024, 65535, F), dport,
                                    r14.choice(np.array([6, 17], np.int64), F, p=[0.9, 0.1])))

    # 6. workloads and the libnetwork driver: 8 containers each, their
    # endpoints regenerated on the card
    t0 = time.monotonic()
    runtime = kw.fake_runtime(workloads_mod)
    extra = []
    for i in range(K8S_WORKLOADS):
        wid = f"work{i:02d}" * 8
        ip = f"10.0.2.{i + 2}"
        runtime.add(wid, {"app": kw.APPS[i % len(kw.APPS)], "role": "batch"}, ip)
        extra.append(dm.endpoint_create(3000 + i, ipv4=ip, container_name=wid))
    watcher = held["watcher"] = WorkloadWatcher(dm, runtime)
    for wid in runtime.list_workloads():
        watcher.enqueue(wid, EventType.START)
    watcher.flush(K8S_WAIT_S)
    driver = held["driver"] = LibnetworkDriver(dm, IpamAllocator("10.11.0.0/24")).serve(f"{tmp}/docker.sock")

    def post(route, body):
        return kw.unix_post(f"{tmp}/docker.sock", route, body)

    for route, body in (("/Plugin.Activate", {}), ("/NetworkDriver.CreateNetwork", {"NetworkID": "n1"})):
        if post(route, body)[0] != 200:
            raise AssertionError(f"k8s libnetwork {route} refused")
    for i in range(K8S_WORKLOADS):
        st, out = post("/NetworkDriver.CreateEndpoint",
                       {"EndpointID": f"lnet{i:02d}", "Interface": {"Address": f"10.11.0.{i + 2}/24"}})
        st2, out2 = post("/NetworkDriver.Join", {"EndpointID": f"lnet{i:02d}", "SandboxKey": f"/sb/{i}"})
        if (st, st2) != (200, 200) or out2["Gateway"] != "10.11.0.1":
            raise AssertionError(f"k8s libnetwork endpoint {i}: {st} {out} / {st2} {out2}")
        extra.append(dm.endpoint_manager.lookup_container(f"lnet{i:02d}"))
    wait_for(lambda: all(ep.state.value == "ready" and ep.device_policy_map is not None for ep in extra)
             and w.settled(), "the containers' endpoints ready")
    for ep in extra[:K8S_WORKLOADS]:
        want = sorted(runtime.inspect(ep.container_name).identity_labels())
        if sorted(str(lb) for lb in ep.labels.values()) != want:
            raise AssertionError(f"k8s workloads: endpoint {ep.id} labels {ep.labels} != the runtime's {want}")
    stage("containers", time.monotonic() - t0, workloads=K8S_WORKLOADS, libnetwork=K8S_WORKLOADS,
          identities=len({ep.security_identity.id for ep in extra}))
    k13_policy("k8s-containers", extra)

    # 7. churn before the service: CNI DEL 10 pods, 2 backends cut from 64
    # Services
    t0 = time.monotonic()
    gone = kw.cni_del(w, K8S_CNI_DEL)
    for cid, res in gone:
        if dm.endpoint_manager.lookup(res.endpoint_id) is not None or res.ip in w.ipam.dump():
            raise AssertionError(f"k8s cni del {cid}: endpoint or IP left behind")
        try:
            w.cni.cni_check(cid)
        except CniError:
            continue
        raise AssertionError(f"k8s cni check {cid}: passed after DEL")
    if any(dm.ipcache.lookup_by_ip(res.ip) is not None for _, res in gone):
        raise AssertionError("k8s cni del: an IP is still in the ipcache")
    cut = kw.cut_backends(w, K8S_CUT_SERVICES, K8S_CUT_BACKENDS)
    stage("churn", time.monotonic() - t0, cni_del=len(gone), services_cut=len(cut),
          lb_entries=len(dm.lb_map.dump()))
    k13_lb("k8s-lb-cut", lb_q)
    eps = w.endpoints()
    wait_for(w.settled, "the node settled after the churn")
    sections["maps-containers-churn"] = time.monotonic() - t_sec

    # 8. the verdict service on its NPDS; 256 HTTP conns on the policies of
    # K8S_CONN_ENDPOINTS endpoints that CNPs admit HTTP to, those with a
    # regex path first
    t_sec = time.monotonic()
    svc_path = f"{tmp}/vs.sock"
    held["svc"] = VerdictService(svc_path, side_config(**({} if on_card else {"verdict_device": "cpu"}))).start()
    t0 = time.monotonic()
    pusher = dm.attach_verdict_service(svc_path)
    stage("attach", time.monotonic() - t0, pushes=pusher.pushes, nacks=pusher.nacks)
    all_eps = sorted(dm.endpoint_manager.get_endpoints(), key=lambda ep: ep.id)
    if pusher.nacks or pusher.pushes < len(all_eps):
        raise AssertionError(f"k8s: {pusher.pushes} NPDS pushes, {pusher.nacks} NACKs")
    cache = dm.get_identity_cache()

    def http_rows(pol):
        return [r for pp in pol.ingress_per_port_policies if pp.port == kw.HTTP_PORT for r in pp.rules
                if r.http_rules]

    cands = [(ep, network_policy_for_endpoint(ep, cache)) for ep in eps]
    cands = [(ep, pol) for ep, pol in cands if http_rows(pol)]
    cands.sort(key=lambda c: (not any("[" in h["path"] for r in http_rows(c[1]) for h in r.http_rules), c[0].id))
    conn_eps = [ep for ep, _ in cands[:K8S_CONN_ENDPOINTS]]
    pols = [pol for _, pol in cands[:K8S_CONN_ENDPOINTS]]
    if len(conn_eps) < K8S_CONN_ENDPOINTS:
        raise AssertionError(f"k8s: {len(conn_eps)} endpoints with HTTP rules")
    n_regex = sum(1 for pol in pols if any("[" in h["path"] for r in http_rows(pol) for h in r.http_rules))
    names, rounds = policy_npds_traffic(random.Random(K8S_SEED), conn_eps, pols, pool)
    shifts = iter(range(K8S_BASE - SIDE_BASES["http"], 1 << 40, 1000))

    def serve(tag, rnds=None):
        rnds = rounds if rnds is None else rnds
        shift = next(shifts)
        drv = SidecarDriver(svc_path, "socket", None, base_shift=shift)
        try:
            fids = drv.open("http", rnds, names=names)
            out = counted(tag, lambda: drv.run("http", rnds, lambda fid: 0))
            drv.close("http", fids)
        finally:
            drv.close_client()
        return out, SIDE_BASES["http"] + shift

    served, base_id = serve("k8s-service")
    oracle = sidecar_oracle("http", rounds, pols, name=names, port=80, base=base_id)
    bad = side_mismatches(served, oracle)
    daemon_mismatch_lines("k8s-service", served, oracle, rounds, names)
    ops = [op for rnd in oracle for o, _, _ in rnd.values() for op, _ in o]
    log(f"k8s-service: {len(all_eps)} endpoints' NPDS policies ({pusher.pushes} pushes, {pusher.nacks} NACKs); "
        f"{POLICY_NPDS_CONNS} conns on {len(conn_eps)} endpoints' policies ({n_regex} with a regex path) x "
        f"{len(rounds)} rounds, {side_frames(oracle)} requests ({ops.count(1)} PASS, {ops.count(2)} DROP): {bad} "
        "mismatches against the in-process proxylib oracle")
    if bad or not ops.count(1) or not ops.count(2):
        raise AssertionError("k8s-service: the service disagrees, or allows or denies everything")

    # 9. delete one CNP through the API server: the one whose loss the
    # most conns see, predicted from a repository of the remaining
    # documents; one of those conns is probed until its verdict changes
    def predict(skip):
        kept = Repository()
        for obj in w.nps:
            for rule in parse_network_policy(obj):
                kept.add(rule)
        for obj in w.cnps:
            if obj["metadata"]["name"] != skip:
                for rule in parse_cnp(obj):
                    kept.add(rule)
        return [network_policy_for_endpoint(SimpleNamespace(
            id=ep.id, ipv4=ep.ipv4, security_identity=ep.security_identity, desired_l4_policy=L4Policy(
                ingress=kept.resolve_l4_ingress_policy(SearchContext(to_labels=ep.security_label_array())))), cache)
            for ep in conn_eps]

    best = None
    for obj in w.cnps[: w.scale.cnps]:
        sel = obj["spec"]["endpointSelector"]["matchLabels"]
        hits = [ep for ep in conn_eps if ep.security_identity.labels.get_model() and all(
            f"k8s:{k}={v}" in ep.security_identity.labels.get_model() for k, v in sel.items())
            and f"{kw.NS_LABEL}={obj['metadata']['namespace']}" in ep.security_identity.labels.get_model()]
        if hits and (best is None or len(hits) > best[1]):
            best = (obj["metadata"]["name"], len(hits))
    gone_cnp = best[0]
    pred = predict(gone_cnp)
    oracle_pred = sidecar_oracle("http", rounds, pred, name=names, port=80, base=base_id)
    moved = sorted({fid for o, p in zip(oracle, oracle_pred) for fid in o if o[fid] != p.get(fid)})
    if not moved:
        raise AssertionError(f"k8s-delete: deleting {gone_cnp} changes the verdict of no conn")
    probe_rounds = [[e for e in rnd if e[0] == moved[0]] for rnd in rounds]
    probe_before = [{moved[0]: rnd[moved[0]]} for rnd in served]
    t_del = time.monotonic()
    kw.delete_cnp(w, gone_cnp)
    t_deleted = time.monotonic()
    rev_del = dm.get_policy_repository().get_revision()
    first_change, probes = None, 0
    while first_change is None:
        done = w.settled()
        out, _ = serve("k8s-delete-probe", probe_rounds)
        probes += 1
        if side_mismatches(out, probe_before):
            first_change = time.monotonic() - t_del
        elif done:
            break
        elif time.monotonic() - t_del > K8S_WAIT_S:
            raise AssertionError("k8s: endpoints did not settle after the CNP delete")
        else:
            time.sleep(0.2)
    wait_for(lambda: w.settled() and all(ep.policy_revision >= rev_del for ep in conn_eps),
             "every endpoint ready after the CNP delete")
    t_settle = time.monotonic() - t_del
    pols2 = [network_policy_for_endpoint(ep, cache) for ep in conn_eps]
    served2, base2 = serve("k8s-delete")
    oracle2 = sidecar_oracle("http", rounds, pols2, name=names, port=80, base=base2)
    bad2 = side_mismatches(served2, oracle2)
    daemon_mismatch_lines("k8s-delete", served2, oracle2, rounds, names)
    changed_fids = sorted({fid for g, o in zip(served2, served) for fid in g if g[fid] != o.get(fid)})
    if [dataclasses.asdict(x) for x in pols2] != [dataclasses.asdict(x) for x in pred] or changed_fids != moved:
        raise AssertionError("k8s-delete: the regenerated policies or the changed conns differ from the prediction "
                             "of a repository of the remaining documents")
    stage("cnp-delete", t_settle, cnp=gone_cnp, delete_call_s=round(t_deleted - t_del, 3),
          first_changed_verdict_s=first_change, probes=probes, pushes=pusher.pushes, nacks=pusher.nacks)
    log(f"k8s-delete: {gone_cnp} deleted through the API server; first changed verdict "
        f"{'none' if first_change is None else f'{first_change:.3f} s'} after it ({probes} probes of conn "
        f"{moved[0]}); settled in {t_settle:.3f} s; {len(moved)} conns changed, as predicted; new conns {bad2} "
        "mismatches against the oracle on the regenerated policies, which equal the prediction")
    if bad2 or first_change is None or pusher.nacks:
        raise AssertionError("k8s-delete: mismatches, a NACK, or no verdict changed")

    # K14 on tables built from the daemon's maps, as phase 15 builds them
    dp_pol = dp_ep.policy_map
    dp_tab = dp_mod.build_tables(dm.ct_map, dm.lb_map, dm.ipcache_map, dp_pol, dev)
    dp_out = counted("k8s-datapath", lambda: dp_mod.datapath_verdicts(dp_tab, *pk14))
    dp_cpu = dp_mod.datapath_verdicts(dp_mod.build_tables(dm.ct_map, dm.lb_map, dm.ipcache_map, dp_pol, "cpu"),
                                      *(a[:STATE_CPU_F] for a in pk14))
    if max_abs_err([x[:STATE_CPU_F].cpu() for x in _flat(dp_out)], _flat(dp_cpu)) != 0:
        raise AssertionError("k8s-datapath: the card differs from the CPU path")
    dp_h = dp_mod.host_arrays(dp_out)
    for i in sorted(random.Random(K8S_SEED + 4).sample(range(F), K8S_SAMPLE)):
        o = dp_mod.host_oracle(dm.ct_map, dm.lb_map, dm.ipcache_map, dp_pol, u32(pk14[0][i]), u32(pk14[1][i]),
                               int(pk14[2][i]), int(pk14[3][i]), int(pk14[4][i]))
        for key in ("verdict", "new_daddr", "new_dport", "dst_identity", "proxy_port", "rev_nat", "established",
                    "needs_ct_create"):
            if u32(dp_h[key][i]) != u32(o[key]):
                raise AssertionError(f"k8s-datapath: packet {i} {key} != host_oracle")
    log(f"k8s-datapath: K14 on tables from the daemon's CT, LB, ipcache and endpoint {dp_ep.id}'s policy "
        f"map at F={F} == the CPU path on {STATE_CPU_F}, == host_oracle on {K8S_SAMPLE}; verdicts "
        f"{np.bincount(dp_h['verdict'], minlength=5).tolist()} (FORWARD, DROP, TO_PROXY, TO_HOST, TO_OVERLAY)")
    sections["service-delete-datapath"] = time.monotonic() - t_sec

    sync()
    launches = {n: sum(r[n] for r in runs.values()) for n in kerns}
    total = counts()
    runs["k8s-build"] = {n: total[n] - launches[n] for n in kerns}  # outside every step: the builds
    launches = total
    log("launches:", json.dumps({n: v for n, v in launches.items() if v}))
    log("launches by run:", json.dumps({n: {k: c for k, c in r.items() if c} for n, r in runs.items()}))
    if on_card:
        for n in ("http_frame", "http_lit", "http_hits", "lpm_lookup", "policy_can_access", "lb_select",
                  "datapath4"):
            if launches[n] <= 0:
                raise AssertionError(f"kernel {n} was not launched on the k8s slice's main path")
        if n_regex and launches["dfa_scan"] + launches["nfa_scan"] <= 0:
            raise AssertionError("k8s: no automaton scan ran for the regex paths")
        want = {"k8s-policy": {"policy_can_access": len(k13_maps)}, "k8s-prefilter": {"lpm_lookup": 1},
                "k8s-lb": {"lb_select": 1}, "k8s-lb-cut": {"lb_select": 1}, "k8s-datapath": {"datapath4": 1}}
        for name, wv in want.items():
            got = {k: c for k, c in runs[name].items() if c}
            if got != wv:
                raise AssertionError(f"{name}: launches {got} != {wv}")
        for name in ("k8s-service", "k8s-delete"):
            missing = [n for n in ("http_frame", "http_lit", "http_hits") if not runs[name][n]]
            if missing:
                raise AssertionError(f"{name}: {missing} never launched")

    # the kernels against their plain versions at the slice's inputs: K13 on
    # every map, K13 LB, K12 on the prefilter, K14, and K5-K7 with K2 / K3 on
    # the first conn policy's HTTP model
    t_sec = time.monotonic()
    log("== k8s kernels vs plain")
    report = {}

    def put(kname, label, got, want_):
        report.setdefault(kname, {})[label] = max_abs_err(_flat(got), _flat(want_))

    for i, m in k13_maps.items():
        put("policy_can_access", f"k8s-policy/{i}", pol_mod.policy_can_access_batch(m, *q13_dev, DIR_INGRESS),
            pol_mod.policy_can_access_plain(m, *q13_dev, DIR_INGRESS))
    lb_in = (lb_tab, [torch.from_numpy(lb_q[0]).to(dev)], *(torch.from_numpy(a).to(dev) for a in lb_q[1:]))
    put("lb_select", "k8s-lb", lb_mod.lb_select(*lb_in), lb_mod.lb_select_plain(*lb_in))
    w4 = torch.from_numpy(words4).to(dev)
    pf_lpm = dm.prefilter.device_lpm()
    put("lpm_lookup", "k8s-prefilter", lpm_mod.lpm_lookup(pf_lpm, w4), lpm_mod.lpm_lookup_plain(pf_lpm, w4))
    d14 = tuple(torch.from_numpy(a).to(dev) for a in pk14)
    dp_in = (dp_tab, (d14[0],), (d14[1],), *d14[2:])
    put("datapath4", "k8s-datapath", dp_mod.datapath_pass(*dp_in), dp_mod.datapath_pass_plain(*dp_in))
    hmodel = build_http_model_for_port(compile_policy(pols[0]), True, kw.HTTP_PORT, "auto", dev)
    heads = [policy_matching_head(h) for r in http_rows(pols[0]) for h in r.http_rules] \
        + [h for _, c, _, _ in rounds[0] for h in [c]][:256]
    rem = policy_remotes(random.Random(K8S_SEED), pool, len(heads))
    data, lengths, rm = (torch.from_numpy(a).to(dev) for a in tile_heads(heads, rem, POLICY_PERIOD, POLICY_L))
    frame = http_frame(data, lengths)
    put("http_frame", "k8s-http", frame, http_frame_plain(data, lengths))
    lit = http_lit(hmodel, data, frame)
    put("http_lit", "k8s-http", lit, http_lit_plain(hmodel, data, frame))
    spans = {"method": (hmodel.line_nfa, torch.zeros_like(frame.sp1), frame.sp1, hmodel.has_method_rx),
             "path": (hmodel.line_nfa, frame.p_start, frame.sp2, hmodel.has_path_rx),
             "head": (hmodel.head_nfa, frame.line_end, frame.h_end, hmodel.head_nfa is not None)}
    rx = {}
    for span, (tab, s, e, on) in spans.items():
        if not on:
            continue
        if isinstance(tab, DeviceDfa):
            kname, scan, plain = "dfa_scan", dfa_mod.dfa_search_spans, dfa_mod.dfa_scan_plain
        else:
            kname, scan, plain = "nfa_scan", nfa_mod.nfa_search_spans, nfa_mod.nfa_scan_plain
        rx[span] = scan(tab, data, s, e)
        put(kname, f"k8s-http:{span}", [rx[span]], [plain(tab, data, s, e)])
    args = (frame.complete, *lit, rx.get("method"), rx.get("path"), rx.get("head"), rm)
    put("http_hits", "k8s-http", http_hits(hmodel, *args), http_hits_plain(hmodel, *args))
    log("max |kernel - plain| (readings, largest):", json.dumps(
        {k: [len(v), max(v.values())] for k, v in report.items()}))
    for kname, per in report.items():
        for label, err in per.items():
            if err != 0:
                raise AssertionError(f"{kname} disagrees with its plain version on {label}")
    sections["vs-plain"] = time.monotonic() - t_sec
    # the node's daemon, service and servers stop before the agent runs as
    # a process (a daemon sets process-wide state: one at a time here)
    for key in ("world", "api", "driver", "watcher", "svc", "daemon"):
        obj = held.pop(key)
        (obj.stop if key == "svc" else obj.close)()

    # 10. the agent as its own process on the card, driven by the CLI as
    # processes; the same commands on an in-process agent at
    # verdict_device="cpu" give the same map, identities named by labels
    t_sec = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + (os.pathsep + os.environ["PYTHONPATH"]
                                              if os.environ.get("PYTHONPATH") else ""))
    run_dir = f"{tmp}/agent"
    agent_sock = f"{run_dir}/cilium-tpu.sock"
    rules_file = f"{tmp}/cnp-rules.json"
    with open(rules_file, "w") as fh:
        fh.write(rules_to_json([r for obj in w.cnps for r in parse_cnp(obj)]))
    picked = [ep for ep in w.endpoints() if ep.realized_redirects][:K8S_AGENT_ENDPOINTS]
    specs = [(7000 + i, f"10.0.3.{i + 2}", sorted(ep.security_identity.labels.get_model()))
             for i, ep in enumerate(picked)]
    t0 = time.monotonic()
    log_out = open(f"{tmp}/agent.log", "w")
    proc = held["proc"] = subprocess.Popen(
        [sys.executable, "-m", "cilium_tpu_torch.agent", "--run-dir", run_dir, "--no-restore"],
        cwd=root, env=env, stdout=log_out, stderr=subprocess.STDOUT)

    def agent_up():
        if proc.poll() is not None:
            raise AssertionError(f"k8s agent: exited {proc.returncode}: "
                                 + open(f"{tmp}/agent.log").read()[-2000:])
        try:
            return ApiClient(agent_sock).get("/v1/healthz")["cilium"]["state"] == "Ok"
        except OSError:
            return False

    wait_for(agent_up, "the agent process serves its API", timeout=K8S_AGENT_WAIT_S)
    t_up = time.monotonic() - t0

    def cli_proc(*argv):
        return subprocess.Popen([sys.executable, "-m", "cilium_tpu_torch.cli", "--socket", agent_sock, *argv],
                                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(p, what):
        out, err = p.communicate(timeout=K8S_AGENT_WAIT_S)
        if p.returncode != 0:
            raise AssertionError(f"k8s cli process {what}: exit {p.returncode}: {err[-2000:]}")
        return out

    # two rounds of processes run together (each process takes seconds to
    # import torch): status, the import and the creates, then the reads
    p_status, p_import = cli_proc("status"), cli_proc("policy", "import", rules_file)
    creates = [cli_proc("endpoint", "create", str(i), "--ipv4", ip, *[a for lb in lbls for a in ("-l", lb)])
               for i, ip, lbls in specs]
    proc_out = {"status": finish(p_status, "status"), "import": finish(p_import, "policy import")}
    for p, (i, _, _) in zip(creates, specs):
        finish(p, f"endpoint create {i}")
    client = ApiClient(agent_sock)

    def agent_ready(c):
        st = c.get("/v1/status")
        eps_ = c.get("/v1/endpoint")
        return st["policy"]["rules"] > 0 and len(eps_) == len(specs) and all(
            e["state"] == "ready" and e["policy_revision"] >= st["policy"]["revision"] for e in eps_)

    wait_for(lambda: agent_ready(client), "the agent's endpoints ready", timeout=K8S_AGENT_WAIT_S)
    map_name = f"policy-{specs[0][0]}"
    p_map, p_ident, p_bug = (cli_proc("map", "get", map_name), cli_proc("identity", "list"),
                             cli_proc("bugtool", "-o", f"{tmp}/agent-bugtool.tar.gz"))
    proc_out.update(map=finish(p_map, "map get"), ident=finish(p_ident, "identity list"),
                    bugtool=finish(p_bug, "bugtool"))
    t_cli = time.monotonic() - t0 - t_up
    agent_dev = bugtool_device(f"{tmp}/agent-bugtool.tar.gz")
    if on_card and [d["name"] for d in agent_dev["devices"]][:1] != [want_name]:
        raise AssertionError(f"k8s agent bugtool: device.json {agent_dev} does not name {want_name}")
    t_stop = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(30)
    t_stop = time.monotonic() - t_stop
    held.pop("proc")
    log_out.close()
    left = [f for f in os.listdir(run_dir) if f.endswith(".sock")]
    if rc != 0 or left:
        raise AssertionError(f"k8s agent: SIGTERM exit {rc}, sockets left {left}: "
                             + open(f"{tmp}/agent.log").read()[-2000:])
    # the same commands on an in-process agent on the CPU
    cpu_dir = f"{tmp}/agent-cpu"
    cpu_cfg = DaemonConfig(run_dir=cpu_dir, socket_path=f"{cpu_dir}/cilium-tpu.sock",
                           monitor_socket_path=f"{cpu_dir}/monitor.sock", verdict_device="cpu", restore_state=False)
    held["agent_cpu"] = Agent(cpu_cfg)
    cbase = ["--socket", cpu_cfg.socket_path]
    for argv in (["policy", "import", rules_file],
                 *(["endpoint", "create", str(i), "--ipv4", ip, *[a for lb in lbls for a in ("-l", lb)]]
                   for i, ip, lbls in specs)):
        if cli_out(cli, cbase + argv)[0] != 0:
            raise AssertionError(f"k8s cpu agent: {argv[:2]} failed")
    wait_for(lambda: agent_ready(ApiClient(cpu_cfg.socket_path)), "the CPU agent's endpoints ready")
    cpu_map = cli_out(cli, cbase + ["map", "get", map_name])[1]
    cpu_ident = cli_out(cli, cbase + ["identity", "list"])[1]
    held.pop("agent_cpu").close()
    got_map, want_agent = agent_map(proc_out["map"], proc_out["ident"]), agent_map(cpu_map, cpu_ident)
    if got_map != want_agent or not got_map:
        raise AssertionError(f"k8s agent: map {map_name} on the card differs from the CPU agent's "
                             f"({len(got_map)} / {len(want_agent)} entries)")
    stage("agent-process", time.monotonic() - t0, up_s=round(t_up, 3), cli_s=round(t_cli, 3),
          sigterm_s=round(t_stop, 3), rules=proc_out["import"].strip(), endpoints=len(specs),
          map_entries=len(got_map))
    log(f"k8s-agent: `python -m cilium_tpu_torch.agent` served in {t_up:.1f} s; the CLI as processes: status, "
        f"policy import ({proc_out['import'].strip()}), {len(specs)} endpoint creates, map get {map_name} "
        f"({len(got_map)} entries == the in-process CPU agent's, identities by labels), bugtool (device.json "
        f"names {agent_dev['devices'][0]['name'] if agent_dev['devices'] else None}); SIGTERM: exit 0 in "
        f"{t_stop:.2f} s, no socket left")
    sections["agent-process"] = time.monotonic() - t_sec

    log("k8s stages (host clock s): " + json.dumps({name: secs for name, (secs, _) in stages.items()}))
    log("k8s sections (host clock s): " + json.dumps(sections))
    return launches, runs, report, {}


# --- phase 19: the native shim, as N shim processes, into the service ------------

NATIVE_PROCS = 16  # the pods of one node, one shim process each
NATIVE_ACCEPT = 64  # conns a shim process accepts through its map snapshots
NATIVE_ACCEPT_BASE = 5_500_000
NATIVE_ACCEPT_POLICY = "native-accept"
NATIVE_NODE_SEED = 17  # phase 17's node (tests/k8s_world.py: 110 pods on 10.0.0.0/24)
NATIVE_CLUSTER_IPS = 16_384  # phase 15's pod IPs (tests/state_world.py pod_ip)
NATIVE_RANDOM_IPS = 1_024  # addresses drawn at random, most outside every pod prefix
NATIVE_RESTART_SHIFT = 200_000  # the restart drive's conns: SIDE_BASES + this
NATIVE_TURN_SHIFT = 300_000  # turn t's conns: SIDE_BASES + this + 100,000 t
NATIVE_TURNS = ("native", "in-process", "native", "in-process")
NATIVE_PROFILED = 2  # the last turns, one of each kind, run under the profiler
NATIVE_TURN_ROUNDS = 1  # a turn drives the traffic's first round (cut for time)
NATIVE_RESTART_ROUNDS = 2  # the restart falls between them
NATIVE_FANIN_BASE = 5_600_000
NATIVE_FANIN_CONNS = 16  # a process's conns in the fan-in (seam_fanin's 16 a session)
NATIVE_FANIN_CAP_S = 2.0
NATIVE_FANIN_S = 4.0
NATIVE_JOB_S = 300.0  # the longest a shim process may take for one job
NATIVE_KERNELS = ("r2d2_frame", "dfa_scan", "r2d2_hits", "http_frame", "http_lit", "http_hits",
                  "dns_name", "dns_hits", "cassandra_hits", "memcache_hits", "lpm_lookup")
FANIN_FRAME = b"READ /public/bench.txt\r\n"


class ShimProcs:
    """N shim processes (``sidecar/nativeshim.py`` run as a script, each
    its own OS process with the library loaded through ctypes) and the job
    protocol they speak on their standard input and output."""

    def __init__(self, n, library, tmp):
        from cilium_tpu_torch.sidecar import nativeshim

        self.library, self.tmp, self.n_jobs = str(library), tmp, 0
        self.errs = [open(f"{tmp}/shim-{k}.err", "w") for k in range(n)]
        self.procs = [subprocess.Popen([sys.executable, nativeshim.__file__], stdin=subprocess.PIPE,
                                       stdout=subprocess.PIPE, stderr=e, text=True, bufsize=1)
                      for e in self.errs]

    def _line(self, k, deadline):
        import select

        p = self.procs[k]
        ready, _, _ = select.select([p.stdout], [], [], max(deadline - time.monotonic(), 0.0))
        line = p.stdout.readline().strip() if ready else None
        if not line or line.startswith("error"):
            self.errs[k].flush()
            with open(self.errs[k].name) as f:
                tail = f.read()[-2000:]
            raise AssertionError(f"shim process {k}: {line or 'no answer in time'} {tail}")
        return line

    def run(self, jobs, on_pause=None):
        """Hand ``jobs`` ({process: job}) out together and return {process:
        result}.  With ``on_pause``, every process's pause is awaited, then
        ``on_pause()`` runs and they go on."""
        paths = {}
        for k, job in jobs.items():
            self.n_jobs += 1
            paths[k] = f"{self.tmp}/job-{self.n_jobs}.json"
            with open(paths[k], "w") as f:
                json.dump(dict(job, library=self.library), f)
            self.procs[k].stdin.write(paths[k] + "\n")
            self.procs[k].stdin.flush()
        deadline = time.monotonic() + NATIVE_JOB_S
        if on_pause is not None:
            for k in jobs:
                if self._line(k, deadline) != "pause":
                    raise AssertionError(f"shim process {k} did not pause")
            on_pause()
            for k in jobs:
                self.procs[k].stdin.write("go\n")
                self.procs[k].stdin.flush()
        out = {}
        for k, path in paths.items():
            line = self._line(k, deadline)
            if line != f"done {path}":
                raise AssertionError(f"shim process {k}: {line}")
            with open(path + ".out") as f:
                out[k] = json.load(f)
        return out

    def close(self):
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)
        for e in self.errs:
            e.close()


def native_src(proto, fid):
    """A conn's own source address (its access-log records carry it)."""
    return f"10.{list(SIDE_PORTS).index(proto) + 1}.{fid // 256}.{fid % 256}:{1024 + fid}"


def native_share(traffic, k, n, shift=0, protos=None, rounds=None):
    """Shim process k's part of phase 9's traffic: every protocol's conns
    with fid % n == k, and their calls in round order (every protocol's
    round r before any round r + 1), the first ``rounds`` rounds (all by
    default).  Returns (conns, calls, keys): keys[i] is call i's (proto,
    fid, round)."""
    from cilium_tpu_torch.sidecar.nativeshim import b64

    protos = list(protos or traffic)
    conns, calls, keys = [], [], []
    for proto in protos:
        remotes = {fid: remote for rnd in traffic[proto][0] for fid, _, remote, _ in rnd}
        conns += [[proto, SIDE_BASES[proto] + shift + fid, remote, native_src(proto, fid),
                   f"2.2.2.2:{SIDE_PORTS[proto]}", SIDE_NAMES[proto]]
                  for fid, remote in remotes.items() if fid % n == k]
    for r in range(min(max(len(traffic[p][0]) for p in protos), rounds or 1 << 30)):
        for proto in protos:
            rounds = traffic[proto][0]
            for fid, chunk, _, reply in rounds[r] if r < len(rounds) else ():
                if fid % n == k:
                    calls.append([r, SIDE_BASES[proto] + shift + fid, bool(reply), b64(chunk)])
                    keys.append((proto, fid, r))
    return conns, calls, keys


def native_expect(traffic, expect):
    """{(proto, fid, round): (forwarded bytes, frames passed, frames
    dropped)}: the oracle's ops and injects through ``OnIoMirror``, the
    shim's ``on_io`` contract."""
    from cilium_tpu_torch.sidecar.nativeshim import OnIoMirror

    out = {}
    for proto, (rounds, _) in traffic.items():
        mirrors = {}
        for r, rnd in enumerate(rounds):
            for fid, chunk, _, reply in rnd:
                ops, io, ir = expect[proto][r][fid]
                out[(proto, fid, r)] = mirrors.setdefault(fid, OnIoMirror()).call(reply, chunk, ops, io, ir)
    return out


def native_outputs(label, keys, results, want):
    """Every call's result OK and forwarded bytes equal to ``want[key][0]``;
    raises with the first few that are not."""
    from cilium_tpu_torch.sidecar.nativeshim import unb64

    bad = []
    for k, res in results.items():
        if res.get("conn_results"):
            raise AssertionError(f"{label}: shim process {k} conns refused {res['conn_results'][:5]}")
        for key, r, got in zip(keys[k], res["results"], res["outs"]):
            if r != 0 or unb64(got) != want[key][0]:
                bad.append((key, r, unb64(got)[:80], want[key][0][:80]))
        if len(res["results"]) != len(keys[k]):
            raise AssertionError(f"{label}: shim process {k} made {len(res['results'])} of {len(keys[k])} calls")
    if bad:
        raise AssertionError(f"{label}: {len(bad)} calls differ from the oracle, first {bad[:3]}")
    return sum(len(v) for v in keys.values())


def native_accept_world(tmp, pols):
    """Phase 17's node (110 pods on 10.0.0.0/24, an identity a label set)
    and phase 15's 16,384 pod IPs (an identity a 32) in an ``IpcacheMap``,
    under 10.0.0.0/8 (9) and the world default (2); ``NATIVE_PROCS`` x
    ``NATIVE_ACCEPT`` conns to accept: node pods redirected to the node's
    proxy (a ``ProxyMap`` entry with the original destination and the
    source identity), node pods, cluster pods and outside sources direct.
    Writes both snapshots; returns the world and the push's policies with
    the accepted conns' policy (the node's prod pods allowed) added."""
    from cilium_tpu_torch.maps.ipcache import IpcacheMap
    from cilium_tpu_torch.maps.proxymap import ProxyKey4, ProxyMap
    from cilium_tpu_torch.proxylib import NetworkPolicy, PortNetworkPolicy, PortNetworkPolicyRule

    kw, sw = _tests_module("k8s_world"), _tests_module("state_world")
    ipc = IpcacheMap()
    ipc.upsert("0.0.0.0/0", sec_label=2)
    ipc.upsert("10.0.0.0/8", sec_label=9)
    ids, node = {}, []
    for i, pod in enumerate(kw.pods(kw.Scale(), NATIVE_NODE_SEED)):
        ident = ids.setdefault((pod["namespace"], pod["labels"]["app"], pod["labels"]["tier"]),
                               1000 + len(ids))
        node.append((f"10.0.0.{i + 2}", ident, pod["namespace"]))
        ipc.upsert(f"10.0.0.{i + 2}/32", sec_label=ident)
    cluster = [sw.pod_ip(i) for i in range(NATIVE_CLUSTER_IPS)]
    for i, ip in enumerate(cluster):
        ipc.upsert(f"{ip}/32", sec_label=256 + i // 32)
    rng = random.Random(19)
    rand = [str(ipaddress.IPv4Address(rng.getrandbits(32))) for _ in range(NATIVE_RANDOM_IPS)]
    ip = lambda s: int(ipaddress.IPv4Address(s))
    pm = ProxyMap(clock=lambda: 0.0)
    conns = []
    for j in range(NATIVE_PROCS * NATIVE_ACCEPT):
        kind, pod, peer = j % 4, node[j % len(node)], cluster[(j * 7) % len(cluster)]
        sport = 20_000 + j
        if kind == 0:  # redirected to the node's proxy port
            pm.create(ProxyKey4(saddr=ip(pod[0]), daddr=ip("10.0.0.1"), sport=sport, dport=15001, nexthdr=6),
                      orig_daddr=ip(peer), orig_dport=80, identity=pod[1])
            conns.append((j, pod[0], "10.0.0.1", sport, 15001, peer, pod[1]))
        elif kind == 1:
            conns.append((j, pod[0], peer, sport, 80, peer, None))
        elif kind == 2:
            conns.append((j, peer, pod[0], sport, 80, pod[0], None))
        else:
            conns.append((j, f"203.0.113.{j % 250 + 1}", pod[0], sport, 80, pod[0], None))
    paths = {"hostmap": f"{tmp}/hostmap.bin", "proxymap": f"{tmp}/proxymap.bin"}
    n_ipc, n_pm = ipc.save(paths["hostmap"]), pm.save(paths["proxymap"])
    allowed = sorted({ident for _, ident, ns in node if ns == "prod"})
    accept_pol = NetworkPolicy(name=NATIVE_ACCEPT_POLICY, policy=2, ingress_per_port_policies=[
        PortNetworkPolicy(port=80, rules=[PortNetworkPolicyRule(
            remote_policies=allowed, l7_proto="r2d2",
            l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])])])
    addrs = [p[0] for p in node] + cluster + rand
    log(f"native accept world: {len(node)} node pods ({len(ids)} identities, {len(allowed)} allowed), "
        f"{len(cluster)} cluster pod IPs, {n_ipc} ipcache prefixes, {n_pm} proxymap entries, "
        f"{len(conns)} conns to accept, {len(addrs)} addresses to resolve")
    return dict(ipc=ipc, conns=conns, addrs=addrs, paths=paths, ip=ip), pols + [accept_pol]


def native_accept_frame(j, r):
    """Accepted conn j's frame in its round r (of two)."""
    return R2D2_CORPUS[j % len(R2D2_CORPUS)] if r == 0 else b"READ /public/acc%d.txt\r\n" % j


def native_records(srv, want_total, timeout_s=60.0):
    """The access-log server's records by source address: (verdict, source
    identity, destination identity, destination, proto) in arrival order."""
    deadline = time.monotonic() + timeout_s
    while len(srv.records) < want_total and time.monotonic() < deadline:
        time.sleep(0.05)
    out = {}
    for r in list(srv.records):
        out.setdefault(r.source.ipv4, []).append(
            (r.verdict, r.source.identity, r.destination.identity, r.destination.ipv4, r.l7.proto))
    return out


def native_slice(dev, card, kerns):
    """Phase 19: the native C++ shim (``native/shim.cc``, built here with
    ``make -C native``) as 16 shim processes, the pods of one node, into
    one port ``VerdictService`` on the card at the reference's defaults
    with phase 9's five policies and traffic, counted in a run of its own
    over every kernel: every call's forwarded bytes and every access-log
    record held to the host oracle, the accept path's identities to K12,
    a service restart mid-stream, the fan-in contract across processes,
    then readings of the native and the in-process seams in turns.
    Returns (launches, runs, report, timed)."""
    import tempfile

    from cilium_tpu_torch.proxylib import instance as inst
    from cilium_tpu_torch.sidecar import nativeshim

    log("== native slice")
    t_phase = time.monotonic()
    t0 = time.monotonic()
    so = nativeshim.build_shim()
    log(f"native shim built from native/ ({so.stat().st_size} bytes) in {time.monotonic() - t0:.1f} s")
    pols, traffic, expect = side_world()
    inst.reset_module_registry()
    held = {}
    try:
        with tempfile.TemporaryDirectory(prefix="native-", dir=".") as tmp:
            try:
                out = _native_runs(dev, card, kerns, so, pols, traffic, expect, tmp, held)
            finally:
                procs = held.pop("procs", None)
                if procs is not None:
                    procs.close()
                for key in ("svc", "al"):
                    obj = held.pop(key, None)
                    if obj is not None:
                        (obj.stop if key == "svc" else obj.close)()
    finally:
        inst.reset_module_registry()
    log(f"native slice: {time.monotonic() - t_phase:.1f} s")
    return out


def _native_runs(dev, card, kerns, so, pols, traffic, expect, tmp, held):
    from cilium_tpu_torch.accesslog.server import AccessLogServer
    from cilium_tpu_torch.ops.lpm import ipv4_to_words, lpm_lookup, lpm_lookup_plain
    from cilium_tpu_torch.sidecar import VerdictService
    from cilium_tpu_torch.sidecar.nativeshim import b64

    sections, t_mark = {}, [time.monotonic()]

    def mark(name):
        now = time.monotonic()
        sections[name] = round(now - t_mark[0], 1)
        t_mark[0] = now

    world, pols = native_accept_world(tmp, pols)
    pj = json.dumps([dataclasses.asdict(p) for p in pols])
    path = f"{tmp}/native.sock"
    n = NATIVE_PROCS
    want = native_expect(traffic, expect)
    frames = sum(side_frames(e) for e in expect.values())
    held["al"] = srv = AccessLogServer(f"{tmp}/access.sock")
    held["svc"] = VerdictService(path, side_config()).start()
    held["procs"] = procs = ShimProcs(n, so, tmp)

    def counts():
        return {name: k.launches + k.replayed for name, k in kerns.items()}

    mark("setup")

    # 19a. the counted run: 16 shim processes push the five policies (and
    # the accepted conns'), open their share of phase 9's 6,656 conns with
    # their own source addresses and an access log, accept 64 conns each
    # through the map snapshots and resolve the addresses, drive every
    # round with on_io; then K12 resolves the same addresses on the card.
    shares = {k: native_share(traffic, k, n) for k in range(n)}
    acc = world["conns"]
    jobs = {}
    for k in range(n):
        mine = [c for c in acc if c[0] % n == k]
        acc_calls = [[100 + r, NATIVE_ACCEPT_BASE + j, False, b64(native_accept_frame(j, r))]
                     for r in range(2) for j, *_ in mine]
        jobs[k] = dict(kind="drive", socket=path, policy=pj, accesslog=srv.path, conns=shares[k][0],
                       calls=shares[k][1] + acc_calls,
                       accept=dict(proxymap=world["paths"]["proxymap"], hostmap=world["paths"]["hostmap"],
                                   conns=[[NATIVE_ACCEPT_BASE + j, world["ip"](s), world["ip"](d), sp, dp,
                                           NATIVE_ACCEPT_POLICY] for j, s, d, sp, dp, _, _ in mine],
                                   addrs=[world["ip"](a) for a in world["addrs"][k::n]]))
    addrs = world["addrs"] + [c[1] for c in acc] + [c[5] for c in acc]
    for k in kerns.values():
        k.launches = 0
        k.replayed = 0
    t0 = time.monotonic()
    main = procs.run(jobs)
    t_drive = time.monotonic() - t0
    lpm = world["ipc"].to_device(device=dev)
    found, value, plen = (t.cpu().numpy() for t in lpm_lookup(lpm, *ipv4_to_words(addrs)))
    launches = counts()
    runs = {"native": dict(launches)}
    ws = [torch.from_numpy(w).to(dev) for w in ipv4_to_words(addrs)]
    report = {"lpm_lookup": {"native-accept": max_abs_err(list(lpm_lookup(lpm, *ws)),
                                                          list(lpm_lookup_plain(lpm, *ws)))}}
    if report["lpm_lookup"]["native-accept"]:
        raise AssertionError(f"native accept: K12 differs from its plain version: {report}")
    missing = [name for name in NATIVE_KERNELS if not launches[name]]
    if missing:
        raise AssertionError(f"native: kernels of the path never launched: {missing} ({launches})")
    log("native counted run: " + ", ".join(f"{name} {c}" for name, c in sorted(launches.items()) if c)
        + f"; K16 (the blob lane) {launches['gather_rows']} [{card}]")

    mark("counted-run")

    # accept: the shim's host-map reader and its accept path against K12.
    k12 = {a: (int(plen[i]) + 1 if found[i] else 0, int(value[i]) if found[i] else 0)
           for i, a in enumerate(addrs)}
    bad = [(a, got, k12[a]) for k in range(n)
           for a, got in zip(world["addrs"][k::n], main[k]["hostmap"]) if tuple(got) != k12[a]]
    if bad:
        raise AssertionError(f"native hostmap: {len(bad)} of {len(world['addrs'])} addresses differ "
                             f"from K12, first {bad[:3]}")
    sids = {}
    for k in range(n):
        for cid, res, od, op, sid, did in main[k]["accept"]:
            j = cid - NATIVE_ACCEPT_BASE
            _, s, d, sp, dp, orig, pm_id = acc[j]
            want_sid = pm_id if pm_id is not None else k12[s][1]
            got = (res, od, op, sid, did)
            exp = (0, world["ip"](orig), 80, want_sid, k12[orig][1])
            if got != exp:
                raise AssertionError(f"native accept conn {j}: {got} != {exp}")
            sids[j] = sid
    if len(sids) != len(acc):
        raise AssertionError(f"native accept: {len(sids)} of {len(acc)} conns accepted")
    acc_rounds = [[(j, native_accept_frame(j, r), sids[j], False) for j, *_ in acc] for r in range(2)]
    acc_expect = sidecar_oracle("r2d2", acc_rounds, pols, name=NATIVE_ACCEPT_POLICY, port=80,
                                base=NATIVE_ACCEPT_BASE)
    want.update({("accept", j, 100 + r): w for (_, j, r), w in
                 native_expect({"accept": (acc_rounds, None)}, {"accept": acc_expect}).items()})
    keys = {k: shares[k][2] + [("accept", j, 100 + r) for r in range(2) for j, *_ in acc if j % n == k]
            for k in range(n)}
    n_calls = native_outputs("native", keys, main, want)
    allowed = set(pols[-1].ingress_per_port_policies[0].rules[0].remote_policies)
    log(f"native: {n} shim processes, {sum(len(s[0]) for s in shares.values())} conns of five protocols "
        f"and {len(acc)} accepted, {n_calls} on_io calls ({frames} frames of phase 9's traffic) at "
        f"{side_config().batch_flows} x {side_config().batch_width}: 0 mismatches against the oracle, "
        f"drive {t_drive:.1f} s (host clock) [{card}]")
    log(f"native accept: {len(world['addrs'])} addresses through the shim's host map == K12 on the card "
        f"({len(addrs)} looked up, {int(found.sum())} found); {len(acc)} conns accepted (identities and "
        f"original destinations == K12 and the proxymap, {sum(s in allowed for s in sids.values())} from an "
        f"allowed identity), their frames judged as the oracle says")

    # access log: each conn's records, in order, are the oracle's frames.
    rec_want = {}
    for proto, (rounds, _) in traffic.items():
        for r, rnd in enumerate(rounds):
            for fid, _, remote, _ in rnd:
                _, passed, dropped = want[(proto, fid, r)]
                rec = (remote, 2, f"2.2.2.2:{SIDE_PORTS[proto]}", proto)
                rec_want.setdefault(native_src(proto, fid), []).extend(
                    [("Forwarded", *rec)] * passed + [("Denied", *rec)] * dropped)
    dotted = lambda a: str(ipaddress.IPv4Address(a))
    for r in range(2):
        for j, s_ip, _, sport, _, orig, _ in acc:
            _, passed, dropped = want[("accept", j, 100 + r)]
            rec = (sids[j], k12[orig][1], f"{orig}:80", "r2d2")
            rec_want.setdefault(f"{s_ip}:{sport}", []).extend(
                [("Forwarded", *rec)] * passed + [("Denied", *rec)] * dropped)
    rec_want = {src: w for src, w in rec_want.items() if w}  # a conn that only buffered logs nothing
    n_recs = sum(map(len, rec_want.values()))
    got_recs = native_records(srv, n_recs)
    bad = [(src, got_recs.get(src, [])[:3], w[:3]) for src, w in rec_want.items() if got_recs.get(src) != w]
    if bad or len(got_recs) != len(rec_want):
        raise AssertionError(f"native access log: {len(bad)} conns' records differ from the oracle "
                             f"({sum(map(len, got_recs.values()))} of {n_recs} records), first {bad[:2]}")
    log(f"native access log: {n_recs} records from {len(rec_want)} conns over {n} shim clients == the "
        f"oracle's frames ({sum(v[0] == 'Forwarded' for w in rec_want.values() for v in w)} forwarded)")

    mark("checks")

    # 19b. restart: stop the service between round 0 and round 1 of a fresh
    # r2d2 drive (its split frames cross the restart) and start a new one on
    # the card on the same socket; the shims replay their policy and conns.
    r2d2_only = {"r2d2": traffic["r2d2"]}
    rs = {k: native_share(r2d2_only, k, n, shift=NATIVE_RESTART_SHIFT, rounds=NATIVE_RESTART_ROUNDS)
          for k in range(n)}
    restarted = {}

    def restart():
        t = time.monotonic()
        held.pop("svc").stop()
        held["svc"] = VerdictService(path, side_config()).start()
        restarted["s"] = time.monotonic() - t

    res = procs.run({k: dict(kind="drive", socket=path, policy=pj, conns=rs[k][0], calls=rs[k][1],
                             pause_after=0) for k in range(n)}, on_pause=restart)
    native_outputs("native restart", {k: s[2] for k, s in rs.items()}, res, want)
    split = sum(1 for fid in range(SIDE_CONNS["r2d2"]) if 16 <= fid % 20 < 18)
    svc = held["svc"]
    log(f"native restart: service stopped after round 0 and a fresh one started on the card in "
        f"{restarted['s']:.1f} s; {sum(len(s[1]) for s in rs.values())} calls on "
        f"{sum(len(s[0]) for s in rs.values())} r2d2 conns ({split} with a frame split across it) == the "
        f"oracle, 0 errors (host clock) [{card}]")

    mark("restart")

    # 19c. the fan-in contract across processes: one process's closed-loop
    # capacity, then 16 at twice it together.
    fan_pol = SIDE_NAMES["r2d2"]

    def fan_conns(k):
        return [["r2d2", NATIVE_FANIN_BASE + 100 * k + i, 1, f"10.9.{k}.{i}:1", "2.2.2.2:80", fan_pol]
                for i in range(NATIVE_FANIN_CONNS)]

    cap = procs.run({0: dict(kind="paced", socket=path, policy=pj, conns=fan_conns(0),
                             frames=[b64(FANIN_FRAME)], rate=0, duration=NATIVE_FANIN_CAP_S)})[0]
    if cap["ok"] != cap["calls"] or cap["wrong"]:
        raise AssertionError(f"native fan-in capacity run: {cap['calls']} calls, {cap['ok']} OK, "
                             f"{cap['wrong']} wrong")
    single = cap["calls"] / cap["seconds"]
    rate = 2.0 * single / n
    start = time.time() + 1.0
    fan = procs.run({k: dict(kind="paced", socket=path, policy=pj, conns=fan_conns(k + 1),
                             frames=[b64(FANIN_FRAME)], rate=rate, duration=NATIVE_FANIN_S, start=start)
                     for k in range(n)})
    served = [r["ok"] for r in fan.values()]
    wrong = sum(r["wrong"] for r in fan.values())
    typed = {}
    for r in fan.values():
        for code, c in r["other"].items():
            typed[code] = typed.get(code, 0) + c
    rows = [row for row in svc.status()["sessions"]["live"] if row["submitted"] != row["answered"]]
    if wrong or min(served) == 0 or rows:
        raise AssertionError(f"native fan-in contract: {wrong} misrouted, served {served}, sessions "
                             f"unbalanced {rows[:2]}")
    p99s = [float(np.percentile(r["rtt_us"], 99)) / 1e3 for r in fan.values()]
    log(f"native fan-in, {n} shim processes x {NATIVE_FANIN_CONNS} conns at twice one process's closed-loop "
        f"capacity ({single:.0f} calls/s; {2 * single:.0f} offered): {sum(served)} served in "
        f"{NATIVE_FANIN_S:.0f} s ({sum(served) / NATIVE_FANIN_S:.0f}/s), typed non-OK {typed}, 0 misrouted, "
        f"every process served, every session's submitted == answered; per-process on_io p99 median "
        f"{sorted(p99s)[n // 2]:.3f} ms, worst {max(p99s):.3f} ms; single p50 "
        f"{np.percentile(cap['rtt_us'], 50) / 1e3:.3f} ms (host clock) [{card}]")

    mark("fan-in")

    # 19d. readings in turns, the same service and traffic: the 16 native
    # processes, then 16 in-process SidecarClient sessions (the Python
    # shim's on_io), alternating; the last two under the profiler.
    turns = []
    turn_frames = sum(p + d for (_, _, r), (_, p, d) in want.items() if r < NATIVE_TURN_ROUNDS)
    for t, kind in enumerate(NATIVE_TURNS):
        shift = NATIVE_TURN_SHIFT + 100_000 * t
        share = {k: native_share(traffic, k, n, shift=shift, rounds=NATIVE_TURN_ROUNDS) for k in range(n)}
        profiled = t >= len(NATIVE_TURNS) - NATIVE_PROFILED
        before = counts()
        prof = native_profiler() if profiled else None
        if kind == "native":
            res = procs.run({k: dict(kind="drive", socket=path, policy=pj, conns=share[k][0],
                                     calls=share[k][1]) for k in range(n)})
        else:
            res = native_inprocess(path, share)
        device_us = native_profiler_busy(prof) if prof is not None else None
        native_outputs(f"native turn {t} ({kind})", {k: s[2] for k, s in share.items()}, res, want)
        after = counts()
        secs = max(r["seconds"] for r in res.values())
        per = [(float(np.percentile(r["rtt_us"], 50)) / 1e3, float(np.percentile(r["rtt_us"], 99)) / 1e3)
               for r in res.values()]
        turns.append(dict(kind=kind, frames_per_s=turn_frames / secs, seconds=secs,
                          p50=sorted(p for p, _ in per)[n // 2], p99=sorted(q for _, q in per)[n // 2],
                          p99_worst=max(q for _, q in per),
                          idle=None if device_us is None else 1 - device_us / (secs * 1e6),
                          launches={name: after[name] - before[name] for name in after
                                    if after[name] != before[name]}))
        tr = turns[-1]
        log(f"native turn {t} {kind}: {turn_frames} frames in {secs:.2f} s = {tr['frames_per_s']:.0f} frames/s; "
            f"on_io per process p50 median {tr['p50']:.3f} ms, p99 median {tr['p99']:.3f} ms, worst "
            f"{tr['p99_worst']:.3f} ms; idle share "
            f"{'not measured (unprofiled)' if tr['idle'] is None else format(tr['idle'], '.4f')}; launches "
            f"{tr['launches']} (host clock) [{card}]")
    mark("turns")
    log("native sections (host clock s): " + json.dumps(sections) + f" [{card}]")
    st = svc.status()
    log(f"native seam_stages {dict(svc.seam_stages)} (filled on the matrix path of a seam-probe "
        f"service only); the tracer's stages {json.dumps(st['latency'])[:1500]} (host clock) [{card}]")
    return launches, runs, report, {}


def native_profiler():
    """A started CUDA-activity profiler, or None where it will not start."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as err:
        log(f"native idle share: not measured ({err})")
        return None
    return prof


def native_profiler_busy(prof):
    """Device-busy microseconds the stopped profiler saw."""
    torch.cuda.synchronize()
    prof.stop()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def native_inprocess(path, share):
    """The in-process side of a turn: one ``SidecarClient`` session a
    share in a thread of this process (phase 12's fan-in sessions), each
    opening its conns and running its calls through the Python shim's
    ``on_io`` in order, timed as the native processes time theirs."""
    from cilium_tpu_torch.sidecar import SidecarClient
    from cilium_tpu_torch.sidecar.nativeshim import b64, unb64

    out, errs = {}, []
    ready = threading.Barrier(len(share) + 1)

    def run(k, conns, calls):
        client = SidecarClient(path, timeout=120.0, identity=f"inproc-{k}")
        try:
            mod = client.open_module([])
            shims = {}
            for proto, cid, remote, src, dst, policy in conns:
                res, shims[cid] = client.new_connection(mod, proto, cid, True, remote, 2, src, dst, policy)
                if res != 0:
                    raise AssertionError(f"in-process conn {cid}: {res}")
            ready.wait()
            results, outs, rtt = [], [], []
            t0 = time.perf_counter()
            for _, cid, reply, data in calls:
                data = unb64(data)
                t = time.perf_counter()
                res, got = shims[cid].on_io(reply, data)
                rtt.append((time.perf_counter() - t) * 1e6)
                results.append(int(res))
                outs.append(b64(got))
            out[k] = dict(results=results, outs=outs, rtt_us=rtt, seconds=time.perf_counter() - t0)
            for cid in shims:
                client.close_connection(cid)
        except Exception as exc:  # noqa: BLE001 - raised below
            errs.append(exc)
            ready.abort()
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(k, *s[:2]), daemon=True) for k, s in share.items()]
    for t in threads:
        t.start()
    try:
        ready.wait(NATIVE_JOB_S)
    except threading.BrokenBarrierError:
        pass
    for t in threads:
        t.join(NATIVE_JOB_S)
    if errs or len(out) != len(share):
        raise AssertionError(f"in-process turn: {errs[:3]} ({len(out)} of {len(share)} sessions)")
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one CUDA card and check it.")
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="a parent commit's cilium_tpu_torch/csrc (unpacked): time the kernels "
                    "whose sources differ from it beside the parent's, in turns, at every "
                    "shape that times them, and the passes that run them")
    ap.add_argument("--state-only", action="store_true",
                    help="build every kernel and run phase 15 (the state slice) alone; prints its "
                    "readings and no result line")
    ap.add_argument("--daemon-only", action="store_true",
                    help="build every kernel and run phase 16 (the agent) alone; prints its readings "
                    "and no result line")
    ap.add_argument("--k8s-only", action="store_true",
                    help="build every kernel and run phase 17 (the agent's front doors) alone; prints "
                    "its readings and no result line")
    ap.add_argument("--contracts-only", action="store_true",
                    help="build every kernel and run phase 18 (the device contracts and the linter) "
                    "alone; prints its readings and no result line")
    ap.add_argument("--native-only", action="store_true",
                    help="build every kernel and run phase 19 (the native shim as 16 shim processes "
                    "into the service) alone; prints its readings and no result line")
    ap.add_argument("--fanin-only", type=int, default=0, metavar="N",
                    help="build every kernel and run phase 12's fan-in contract (seam_fanin) N "
                    "times, each on a fresh service; prints each run and no result line, and exits "
                    "non-zero if any run broke the contract")
    args = ap.parse_args()
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
    if args.baseline_csrc:
        stems = build_baseline(args.baseline_csrc)
        log(f"built the parent's {', '.join(stems) or 'nothing (no source differs)'} from "
            f"{BASELINE['csrc']}")
    for src in kernels.sources():
        for line in kernels.ptxas_log(src).read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src.name}: {line.strip()}")

    if args.state_only:
        state_slice(dev, card, {k.symbol: k for k in kernels.ALL})
        log(f"total {time.monotonic() - t_start:.1f} s")
        return 0
    if args.daemon_only:
        daemon_slice(dev, card, every_kernel())
        log(f"total {time.monotonic() - t_start:.1f} s")
        return 0
    if args.k8s_only:
        k8s_slice(dev, card, every_kernel())
        log(f"total {time.monotonic() - t_start:.1f} s")
        return 0
    if args.contracts_only:
        contracts_slice(dev, card, every_kernel())
        log(f"total {time.monotonic() - t_start:.1f} s")
        return 0
    if args.native_only:
        native_slice(dev, card, every_kernel())
        log(f"total {time.monotonic() - t_start:.1f} s")
        return 0
    if args.fanin_only:
        import tempfile

        broke = 0
        for i in range(args.fanin_only):
            with tempfile.TemporaryDirectory(prefix="fanin-", dir=".") as tmp:
                try:
                    seam_fanin(f"{tmp}/fanin.sock", card)
                except AssertionError as exc:
                    broke += 1
                    log(f"fan-in run {i}: {exc}")
        log(f"fan-in: {args.fanin_only - broke} of {args.fanin_only} runs held the contract [{card}]")
        log(f"total {time.monotonic() - t_start:.1f} s")
        return 1 if broke else 0

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
    if not any((2, len(frame_cases().LONG_HEAD)) in ops for ops in long_ops):
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
    # K1 and K5 on tests/frame_cases.py's boundary batches at widths and
    # rows that take every variant of their launchers (a row base 16-byte
    # aligned and 5 bytes into the storage; the batch's rows, 8,192 of them
    # and slices of 1,024), and on the HTTP engine's widest bucket around
    # LONG_HEAD.
    fc = frame_cases()
    variants = {}
    long_np = fc.long_head_batch()
    long_data, long_lengths = (torch.from_numpy(a).to(dev) for a in long_np)
    batches = [("long-head", long_data, long_lengths),
               ("long-head+5", fc.on_card_at(dev, long_np[0], 5), long_lengths)]
    for l in fc.CARD_WIDTHS:
        data, lengths = fc.frame_batch(l)
        for rows in (len(data), 8192):
            n = torch.from_numpy(np.resize(lengths, rows)).to(dev)
            for offset in (0, 5):
                batches.append((f"frame-{rows}x{l}+{offset}",
                                fc.on_card_at(dev, np.resize(data, (rows, l)), offset), n))
        # launches of at most 1,024 rows: a warp a row past 256 bytes
        for s in range(0, len(data), 1024) if l > 256 else ():
            n = torch.from_numpy(lengths[s : s + 1024]).to(dev)
            for offset in (0, 5):
                batches.append((f"frame-{l}[{s}:+1024]+{offset}",
                                fc.on_card_at(dev, data[s : s + 1024], offset), n))
    for label, d, n in batches:
        for kname, run, plain in (("r2d2_frame", r2d2_frame, r2d2_frame_plain),
                                  ("http_frame", http_frame, http_frame_plain)):
            report[kname][label] = max_abs_err(run(d, n), plain(d, n))
            variants.setdefault(kname, set()).add(kernels.frame_variant(kname, d))
    log(f"K1 / K5 on the boundary batches of widths {fc.CARD_WIDTHS} (their rows, 8,192 and "
        f"slices of 1,024; bases 0 and 5 bytes into their storage) and the "
        f"{tuple(long_data.shape)} long-head bucket: "
        f"variants (lanes, chunks, aligned) {sorted(variants['r2d2_frame'])}")
    log("max |kernel - plain|:", json.dumps(report))
    for kname, per in report.items():
        for name, err in per.items():
            if err != 0:
                raise AssertionError(f"{kname} disagrees with its plain version on {name}")

    # 6. times
    log("== times on", card)
    timed = {}

    for name in ("graft", "wide", "nfa"):
        data, lengths, rem, frame, file_ok, _ = inputs[name]
        model = cases[name]["model"]
        nfa = model.nfa
        sb = span_bytes(frame.file_start, frame.file_end, data.shape[1])
        rows = {"r2d2_frame": k1_row(data, lengths, frame)}
        kname = scan_kernel(nfa)
        rows[kname] = scan_row(scans[kname], nfa, data, frame.file_start, frame.file_end, sb)
        rows["r2d2_hits"] = k4_row(model, data, frame.sp, file_ok, rem)
        host = cases[name]["host"]
        on_card = lambda: r2d2_verdicts(model, data, lengths, rem)  # noqa: E731
        timed[name] = dict(rows=rows, **pass_times(on_card, lambda: r2d2_verdicts(model, *host)))
        for kname, row in rows.items():
            bound(row)
            log_row(name, kname, row)
        log_pass(name, "r2d2_verdicts", timed[name], card, parent_turns(R2D2_PASS, on_card, {}))

    for name, c in hcases.items():
        data, lengths, rem, frame, lit, spans, rx, hits = hinputs[name]
        model = c["model"]
        f, l = data.shape
        rows = {"http_frame": k5_row(data, lengths, frame)}
        k6 = lambda: http_lit(model, data, frame)
        rows["http_lit"] = dict(
            ms=graph_ms(k6), call_ms=cuda_ms(k6, 50),
            plain_ms=cuda_ms(lambda: http_lit_plain(model, data, frame), 10),
            **lit_counts(model, frame),
        )
        # the automata on the HTTP spans
        for span, (tab, s, e) in spans.items():
            kname = scan_kernel(tab)
            row = scan_row(scans[kname], tab, data, s, e, span_bytes(s, e, l))
            row["span"] = span
            rows[f"{kname}:{span}"] = row
        args = (frame.complete, *lit, rx.get("method"), rx.get("path"), rx.get("head"), rem)
        k7 = lambda: http_hits(model, *args)
        rows["http_hits"] = dict(
            ms=graph_ms(k7), call_ms=cuda_ms(k7, 50),
            plain_ms=cuda_ms(lambda: http_hits_plain(model, *args), 10),
            **hits_counts(model, args, hits),
        )
        host = c["host"]
        on_card = lambda: http_verdicts(model, data, lengths, rem)  # noqa: E731
        timed[name] = dict(rows=rows, **pass_times(on_card, lambda: http_verdicts(model, *host)))
        for kname, row in rows.items():
            bound(row)
            log_row(name, kname, row)
        log_pass(name, "http_verdicts", timed[name], card, parent_turns(HTTP_PASS, on_card, {}))

    # The engines on the host clock, then once more under the profiler for
    # the device's busy share (a reading only: the profiler is no check).
    frames = sum(1 for _, ops, _ in eng_card for op, _ in ops if op in (1, 2))
    engine_times(f"engine graft: {frames} frames of {len(feeds[0])} flows", frames, card,
                 lambda: run_engine(cases["graft"]["model"], feeds))
    frames = sum(1 for _, ops, _ in heng_card for op, _ in ops if op in (1, 2))
    engine_times(f"http engine: {frames} requests of {len(hfeeds[0])} flows", frames, card,
                 lambda: run_http_engine(hcases["http-graft"]["model"], hfeeds, FlowLog(capacity=1 << 20)))

    # K2 at the r2d2 engine's own batch shape: the largest search one
    # engine run makes, its inputs recorded and timed alone.
    e_tab, e_data, e_s, e_e = max(
        recorded_calls(r2d2_mod, "automaton_search_spans",
                       lambda: run_engine(cases["graft"]["model"], feeds)),
        key=lambda call: call[1].numel())
    kname = scan_kernel(e_tab)
    row = bound(scan_row(scans[kname], e_tab, e_data, e_s, e_e,
                         span_bytes(e_s, e_e, e_data.shape[1])))
    timed["engine"] = dict(rows={kname: row})
    log(f"engine: the largest of its searches is F={e_data.shape[0]} L={e_data.shape[1]} "
        f"R={e_tab.n_patterns}")
    log_row("engine", kname, row)
    # K1 at the r2d2 engine's largest frame call and K5 at the HTTP engine's
    # widest, their inputs recorded; K5 on the bucket that would hold
    # LONG_HEAD (the engine denies a head over 32 KB without a device pass).
    calls = recorded_calls(r2d2_mod, "r2d2_frame",
                           lambda: run_engine(cases["graft"]["model"], feeds))
    f_data, f_len = max(calls, key=lambda call: call[0].numel())
    timed["engine"]["rows"]["r2d2_frame"] = k1_row(f_data, f_len, r2d2_frame(f_data, f_len))
    calls = recorded_calls(http_mod, "http_frame", lambda: run_http_engine(
        hcases["http-graft"]["model"], hfeeds, FlowLog(capacity=1 << 20)))
    h_data, h_len = max(calls, key=lambda call: (call[0].shape[1], call[0].shape[0]))
    timed["http-engine"] = dict(rows={"http_frame": k5_row(h_data, h_len, http_frame(h_data, h_len))})
    timed["http-long-head"] = dict(rows={"http_frame": k5_row(
        long_data, long_lengths, http_frame(long_data, long_lengths))})
    for label, kname, shape in (("engine", "r2d2_frame", f_data.shape),
                                ("http-engine", "http_frame", h_data.shape),
                                ("http-long-head", "http_frame", long_data.shape)):
        log(f"{label}: K{1 if kname == 'r2d2_frame' else 5} at F={shape[0]} L={shape[1]}")
        log_row(label, kname, timed[label]["rows"][kname])
    # K4 at the r2d2 engine's largest rule walk, its inputs recorded.
    calls = recorded_calls(r2d2_mod, "r2d2_hits", lambda: run_engine(cases["graft"]["model"], feeds))
    e_model, *e_args = max(calls, key=lambda call: call[3].numel())
    timed["engine"]["rows"]["r2d2_hits"] = k4_row(e_model, *e_args)
    log(f"engine: K4 at F={e_args[0].shape[0]} L={e_args[0].shape[1]} R={e_args[2].shape[1]}")
    log_row("engine", "r2d2_hits", timed["engine"]["rows"]["r2d2_hits"])

    # The third slice's paths, counted in their own run.
    launches3, runs3, span_runs3, report3, timed3 = l7_slice(dev, card, kerns, scans, scan_kernel,
                                                             tile_heads)
    runs.update(runs3)
    span_runs.update(span_runs3)
    timed.update(timed3)
    for kname, per in report3.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches3.items():
        launches[kname] = launches.get(kname, 0) + n

    # The fourth slice's paths (the L3/L4 datapath), counted in their own run.
    launches4, runs4, report4, timed4 = l34_slice(dev, card, kerns)
    runs.update(runs4)
    timed.update(timed4)
    for kname, per in report4.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches4.items():
        launches[kname] = launches.get(kname, 0) + n

    # The fifth slice's path (the sidecar verdict service), counted in its own run.
    launches5, runs5, report5, timed5 = sidecar_slice(dev, card, kerns)
    runs.update(runs5)
    timed.update(timed5)
    for kname, per in report5.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches5.items():
        launches[kname] = launches.get(kname, 0) + n

    # The sixth slice's paths (Kafka, the chunk-folded DFA search), each
    # counted in a run of its own over every kernel of the port (their
    # modules imported first, so that K17 and K18 are in kernels.ALL).
    from cilium_tpu_torch.models import kafka  # noqa: F401
    from cilium_tpu_torch.ops import seqdfa  # noqa: F401

    every = {k.symbol: k for k in kernels.ALL}
    if len(every) != len(kernels.ALL):
        raise AssertionError("two kernels share a launcher name")
    for slice_ in (kafka_slice, seqdfa_slice):
        launches6, runs6, report6, timed6 = slice_(dev, card, every)
        runs.update(runs6)
        timed.update(timed6)
        for kname, per in report6.items():
            report.setdefault(kname, {}).update(per)
        for kname, n in launches6.items():
            launches[kname] = launches.get(kname, 0) + n

    # The seventh slice's path (the seam benchmarks), counted in a run of its
    # own over every kernel (latbench imported first, so that K20 is in
    # kernels.ALL).
    from cilium_tpu_torch.sidecar import latbench  # noqa: F401

    every = {k.symbol: k for k in kernels.ALL}
    launches7, runs7, report7, timed7 = seam_slice(dev, card, every)
    runs.update(runs7)
    timed.update(timed7)
    for kname, per in report7.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches7.items():
        launches[kname] = launches.get(kname, 0) + n

    # The eighth slice's paths (rule- and flow-sharded verdicts on a mesh),
    # counted in a run of their own over every kernel (rulesharding
    # imported first, so that K21 and K22 are in kernels.ALL).
    from cilium_tpu_torch.parallel import rulesharding  # noqa: F401

    every = {k.symbol: k for k in kernels.ALL}
    launches8, runs8, report8, timed8 = mesh_slice(dev, card, every)
    runs.update(runs8)
    timed.update(timed8)
    for kname, per in report8.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches8.items():
        launches[kname] = launches.get(kname, 0) + n

    # The policy plane (rules -> repository -> L4 filters -> models and
    # engines through ProxyManager, NPDS to a verdict service), counted in a
    # run of its own over every kernel.
    every = {k.symbol: k for k in kernels.ALL}
    launches14, runs14, span_runs14, report14, timed14 = policy_slice(dev, card, every)
    runs.update(runs14)
    span_runs.update(span_runs14)
    timed.update(timed14)
    for kname, per in report14.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches14.items():
        launches[kname] = launches.get(kname, 0) + n

    # The state layer (kvstore, identities, ipcache, services, endpoints)
    # into K12-K15, and K3's wide form, counted in a run of their own.
    every = {k.symbol: k for k in kernels.ALL}
    launches15, runs15, report15, timed15 = state_slice(dev, card, every)
    runs.update(runs15)
    timed.update(timed15)
    for kname, per in report15.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches15.items():
        launches[kname] = launches.get(kname, 0) + n

    # The agent (a Daemon from policy to verdict, through a restart), last,
    # counted in a run of its own over every kernel.
    launches16, runs16, report16, timed16 = daemon_slice(dev, card, every_kernel())
    runs.update(runs16)
    timed.update(timed16)
    for kname, per in report16.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches16.items():
        launches[kname] = launches.get(kname, 0) + n

    # The agent's front doors (the Kubernetes watcher, CNI and IPAM, the
    # REST API and CLI, workloads, the libnetwork driver, the agent process),
    # last, counted in a run of its own over every kernel.
    launches17, runs17, report17, timed17 = k8s_slice(dev, card, every_kernel())
    runs.update(runs17)
    timed.update(timed17)
    for kname, per in report17.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches17.items():
        launches[kname] = launches.get(kname, 0) + n

    # The device contracts (the models and sharded steps captured into
    # CUDA graphs, the shape closure, the linter), last, counted in a run
    # of their own over every kernel.
    launches18, runs18, report18, timed18 = contracts_slice(dev, card, every_kernel())
    runs.update(runs18)
    timed.update(timed18)
    for kname, per in report18.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches18.items():
        launches[kname] = launches.get(kname, 0) + n

    # The native shim as 16 shim processes into the service (accept, access
    # log, restart, fan-in, readings in turns), last, counted in a run of its
    # own over every kernel.
    launches19, runs19, report19, timed19 = native_slice(dev, card, every_kernel())
    runs.update(runs19)
    timed.update(timed19)
    for kname, per in report19.items():
        report.setdefault(kname, {}).update(per)
    for kname, n in launches19.items():
        launches[kname] = launches.get(kname, 0) + n

    replaces = {
        "r2d2_frame": ("cilium_tpu_torch/csrc/r2d2_frame.cu", "cilium_tpu/models/r2d2.py:211", "graft"),
        "dfa_scan": ("cilium_tpu_torch/csrc/dfa_scan.cu", "cilium_tpu/ops/dfa.py:146", "graft"),
        "nfa_scan": ("cilium_tpu_torch/csrc/nfa_scan.cu", "cilium_tpu/ops/nfa.py:92", "nfa"),
        "r2d2_hits": ("cilium_tpu_torch/csrc/r2d2_hits.cu", "cilium_tpu/ops/bytescan.py:84", "graft"),
        "http_frame": ("cilium_tpu_torch/csrc/http_frame.cu", "cilium_tpu/models/http.py:539", "http-graft"),
        "http_lit": ("cilium_tpu_torch/csrc/http_lit.cu", "cilium_tpu/models/http.py:403", "http-graft"),
        "http_hits": ("cilium_tpu_torch/csrc/http_hits.cu", "cilium_tpu/models/http.py:509", "http-graft"),
        "dns_name": ("cilium_tpu_torch/csrc/dns_name.cu", "cilium_tpu/models/dns.py:223", "dns"),
        "dns_hits": ("cilium_tpu_torch/csrc/dns_hits.cu", "cilium_tpu/models/dns.py:291", "dns"),
        "cassandra_hits": ("cilium_tpu_torch/csrc/cassandra_hits.cu",
                           "cilium_tpu/models/cassandra.py:160", "cassandra"),
        "memcache_hits": ("cilium_tpu_torch/csrc/memcache_hits.cu",
                          "cilium_tpu/models/memcached.py:209", "memcached"),
        "lpm_lookup": ("cilium_tpu_torch/csrc/lpm.cu", "cilium_tpu/ops/lpm.py:109", "prefilter"),
        "exact_lookup": ("cilium_tpu_torch/csrc/l34_tables.cu", "cilium_tpu/ops/maplookup.py:80",
                         "datapath-maps"),
        "policy_can_access": ("cilium_tpu_torch/csrc/l34_tables.cu", "cilium_tpu/maps/policymap.py:191",
                              "datapath-maps"),
        "lb_select": ("cilium_tpu_torch/csrc/l34_tables.cu", "cilium_tpu/maps/lbmap.py:284",
                      "datapath-maps"),
        "datapath4": ("cilium_tpu_torch/csrc/datapath.cu", "cilium_tpu/datapath/pipeline.py:125",
                      "datapath"),
        "datapath6": ("cilium_tpu_torch/csrc/datapath.cu", "cilium_tpu/datapath/pipeline6.py:92",
                      "datapath6"),
        "ingress": ("cilium_tpu_torch/csrc/ingress.cu", "cilium_tpu/datapath/ingress.py:91", "netdev"),
        "gather_rows": ("cilium_tpu_torch/csrc/gather_rows.cu", "cilium_tpu/sidecar/service.py:165",
                        "sidecar"),
        "kafka_hits": ("cilium_tpu_torch/csrc/kafka_hits.cu", "cilium_tpu/models/kafka.py:318", "kafka"),
        "seqdfa_fold": ("cilium_tpu_torch/csrc/seqdfa.cu", "cilium_tpu/ops/seqdfa.py:68",
                        "seqdfa-32k-k64"),
        "seqdfa_apply": ("cilium_tpu_torch/csrc/seqdfa.cu", "cilium_tpu/ops/seqdfa.py:121",
                         "seqdfa-32k-k64"),
        "seam_probe": ("cilium_tpu_torch/csrc/seam.cu", "cilium_tpu/models/base.py:41", "seam-8192"),
        "rtt_tick": ("cilium_tpu_torch/csrc/seam.cu", "cilium_tpu/sidecar/latbench.py:617",
                     "seam-rtt-8"),
        "shard_reduce": ("cilium_tpu_torch/csrc/shard_reduce.cu",
                         "cilium_tpu/parallel/rulesharding.py:527", "mesh-r2d2-1x4"),
        "kafka_shard_combine": ("cilium_tpu_torch/csrc/shard_reduce.cu",
                                "cilium_tpu/parallel/rulesharding.py:503", "mesh-kafka-1x4"),
    }
    fields = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "turns_ms",
              "parent_ms", "turns_call_ms", "parent_call_ms", "variant", "walk_bound_ms", "index_bound_ms",
              "groups")
    kernels_line = []
    for kname, (source, ref, shape) in replaces.items():
        row = timed[shape]["rows"][kname]
        entry_ = {
            "name": kname, "route": "cuda", "source": source, "replaces": ref,
            "launches": launches[kname], "max_abs_err": max(report[kname].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "turns_ms": row.get("turns_ms"), "parent_ms": row.get("parent_ms"), "shape": shape,
            "shape_launches": runs[shape][kname], "call_ms": row["call_ms"],
            "variant": row.get("variant"), "walk_bound_ms": row.get("walk_bound_ms"),
            "index_bound_ms": row.get("index_bound_ms"), "groups": row.get("groups"),
        }
        others = {}
        for other, t in timed.items():
            for key, w in t["rows"].items():
                if other != shape and key.split(":")[0] == kname:
                    label = other if ":" not in key else f"{other}:{key.split(':')[1]}"
                    others[label] = {k: w.get(k) for k in fields}
                    # this run's own launches on the counted main path; null
                    # for a shape no counted run covers (http-long-head)
                    run = span_runs[label] if ":" in label else runs.get(other)
                    others[label]["launches"] = None if run is None else run[kname]
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
    row = dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: plain(tab, data, start, end), 3),
        bytes=sb + 8 * f + tables + f * r, ops=ops,
    )
    return parent_turns("dfa_scan" if isinstance(tab, DeviceDfa) else "nfa_scan", run, row)


def frame_cases():
    """tests/frame_cases.py: the framing kernels' boundary batches."""
    return _tests_module("frame_cases")


def k1_row(data, lengths, frame):
    """K1 on [F, L]: read each row's sectors up to its first CRLF and the
    lengths once, write six [F] outputs; times (beside the parent's in
    turns, given --baseline-csrc), bytes, ops and the launcher's variant."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.r2d2 import r2d2_frame, r2d2_frame_plain

    f, l = data.shape
    need = torch.minimum(frame.crlf + 2, lengths).clamp(0, l).to(torch.int64)
    run = lambda: r2d2_frame(data, lengths)  # noqa: E731
    row = dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: r2d2_frame_plain(data, lengths), 10),
        bytes=sector_bytes(need, l) + 4 * f + 21 * f, ops=int(need.sum()),
        variant=kernels.frame_variant("r2d2_frame", data),
    )
    return parent_turns("r2d2_frame", run, bound(row))


def k5_row(data, lengths, frame):
    """K5 on [F, L]: each row's sectors up to min(head_len, len) and the
    lengths once, eight [F] outputs (seven int32, one bool); as ``k1_row``."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.http import http_frame, http_frame_plain

    f, l = data.shape
    need = torch.minimum(frame.head_len, lengths)
    run = lambda: http_frame(data, lengths)  # noqa: E731
    row = dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: http_frame_plain(data, lengths), 10),
        bytes=sector_bytes(need, l) + 4 * f + 29 * f, ops=int(need.clamp(0, l).sum()),
        variant=kernels.frame_variant("http_frame", data),
    )
    return parent_turns("http_frame", run, bound(row))


def visited_rows(allow, rule, r):
    """[F, R] bool: the rows a first-match walk must visit (up to the first
    that holds, all R where none does)."""
    walked = torch.where(allow, rule + 1, torch.full_like(rule, r))
    return torch.arange(r, device=rule.device)[None, :] < walked[:, None]


def k4_row(model, data, sp, file_ok, rem):
    """K4 on [F, L] and R rule rows: bytes, the first min(sp, L, 8) bytes of
    each row, sp, file_ok, remotes, the tables and two [F] outputs; ops,
    one test a (flow, row) the first-match walk visits and the command
    bytes compared on the visited rows whose file and command length hold
    (the function's work, not a design's); times (beside the parent's in
    turns, given --baseline-csrc) and the launcher's variant."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.r2d2 import r2d2_hits, r2d2_hits_plain

    f, l = data.shape
    r = model.cmd_len.shape[0]
    allow, rule = r2d2_hits_plain(model, data, sp, file_ok, rem)
    if max_abs_err(r2d2_hits(model, data, sp, file_ok, rem), (allow, rule)):
        raise AssertionError(f"r2d2_hits disagrees with its plain version at F={f} L={l} R={r}")
    visited = visited_rows(allow, rule, r)
    s = sp.clamp(min=0)
    compared = visited & file_ok & ~model.cmd_any[None, :] & (model.cmd_len[None, :] == s[:, None])
    run = lambda: r2d2_hits(model, data, sp, file_ok, rem)  # noqa: E731
    row = dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: r2d2_hits_plain(model, data, sp, file_ok, rem), 10),
        bytes=int(sp.clamp(0, min(l, 8)).sum()) + 4 * f + f * r + 4 * f
        + r * (8 + 4 + 1 + 128 + 1) + 5 * f,
        ops=int(visited.sum()) + int((compared * s.clamp(max=8)[:, None]).sum()),
        variant=kernels.hits_variant("r2d2_hits", r, f),
    )
    return parent_turns("r2d2_hits", run, bound(row))


def k9_row(model, name, rx, rem):
    """K9 on [F, L] and R rule rows: bytes, the dotted bytes of the names
    it compares (rows whose needle length is the span's), the [F, R]
    automaton hits where given, spans, valid, remotes, the tables and two
    [F] outputs; ops, one test a (flow, row) the first-match walk visits
    and the name bytes compared on the visited rows the automaton does not
    decide, whose length is the span's; as ``k4_row``."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.dns import dns_hits, dns_hits_plain

    f = name.dotted.shape[0]
    r, w = model.name_needle.shape
    allow, rule = dns_hits_plain(model, name, rx, rem)
    if max_abs_err(dns_hits(model, name, rx, rem), (allow, rule)):
        raise AssertionError(f"dns_hits disagrees with its plain version at F={f} R={r} W={w}")
    visited = visited_rows(allow, rule, r)
    span_len = (name.span_end - name.span_start).clamp(min=0)
    same = model.name_len[None, :] == span_len[:, None]
    need = torch.where(name.valid & same.any(dim=1), span_len, torch.zeros_like(span_len))
    compared = visited & same & name.valid[:, None] & ~model.name_any[None, :]
    if rx is not None:
        compared &= ~(model.use_rx[None, :] & rx)
    run = lambda: dns_hits(model, name, rx, rem)  # noqa: E731
    row = dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: dns_hits_plain(model, name, rx, rem), 10),
        bytes=int(need.sum()) + (f * r if rx is not None else 0) + 9 * f + 4 * f + 5 * f
        + r * (w + 4 + 1 + 1 + 128 + 1),
        ops=int(visited.sum()) + int((compared * span_len.clamp(max=w)[:, None]).sum()),
        variant=kernels.hits_variant("dns_hits", r, f),
    )
    return parent_turns("dns_hits", run, bound(row))


def k8_row(data, lengths):
    """K8 on [F, L]: every row read once and written once (the dotted copy
    covers the whole row), the lengths, five [F] outputs; one op a byte for
    the fold, one a label for the walk; held to its plain version, then
    timed beside the parent's in turns (given --baseline-csrc), with the
    launcher's variant."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.dns import dns_name, dns_name_plain

    f, width = data.shape
    nm = dns_name_plain(data, lengths)
    if max_abs_err(dns_name(data, lengths), nm):
        raise AssertionError(f"dns_name disagrees with its plain version at F={f} L={width}")
    labels = int(((nm.dotted == 0x2E) & (data != 0x2E)).sum()) + f
    run = lambda: dns_name(data, lengths)  # noqa: E731
    row = dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: dns_name_plain(data, lengths), 3),
        bytes=2 * f * width + 4 * f + 14 * f, ops=f * width + labels,
        variant=kernels.name_variant(data),
    )
    return parent_turns("dns_name", run, bound(row))


def k17_row(model, b, rem, parts=False):
    """K17 on F requests and R rule rows: ``kafka_bound``'s bytes and ops
    (with ``parts``, the [F] and [F, T] bool outputs besides); held to its
    plain versions, then timed beside the parent's in turns (given
    --baseline-csrc), with the launcher's lanes a request."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.kafka import kafka_hits, kafka_rule_hits, kafka_verdicts_plain

    f, t_n, _ = b.topics.shape
    want = kafka_verdicts_plain(model, b, rem)
    got = kafka_hits(model, b, rem, parts=parts)
    if max_abs_err(_outputs(got), [want, *kafka_rule_hits(model, b, rem)][: 3 if parts else 1]):
        raise AssertionError(f"kafka_hits disagrees with its plain versions at F={f} R={model.n_rules}")
    nbytes, ops = kafka_bound(model, b, rem)
    run = lambda: kafka_hits(model, b, rem, parts=parts)  # noqa: E731
    row = dict(ms=graph_ms(run), call_ms=cuda_ms(run, 50),
               plain_ms=cuda_ms(lambda: kafka_verdicts_plain(model, b, rem), 5), library_ms=None,
               bytes=nbytes + (f + f * t_n if parts else 0), ops=ops,
               variant=kernels.kafka_variant(model.n_rules, f, t_n))
    return parent_turns("kafka_hits", run, bound(row))


def walked_rows(hits, r):
    """Rule rows a first-match walk visits over [F, R] row hits: up to the
    first hit, all R where none."""
    any_ = hits.any(dim=1)
    first = torch.argmax(hits.to(torch.int32), dim=1)
    return int(torch.where(any_, first + 1, torch.full_like(first, r)).sum())


def k10_row(model, data, alen, tlen, nq, rx, rem):
    """K10 on F requests and R rule rows: bytes, the action bytes of the
    requests some row names the length of, the [F, R] automaton hits where
    given, five [F] inputs, the tables and the [F] output; ops, one test a
    (request, row) the first-match walk visits and those action bytes (as
    K4 and K9 count them); held to its plain version (its max_abs_err),
    then timed beside the parent's in turns (given --baseline-csrc), with
    the launcher's variant."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.cassandra import (
        MAX_ACTION,
        cassandra_hits,
        cassandra_hits_plain,
        cassandra_rule_hits_plain,
    )

    f, r = data.shape[0], model.n_rules
    args = (model, data, alen, tlen, nq, rx, rem)
    err = max_abs_err([cassandra_hits(*args)], [cassandra_hits_plain(*args)])
    if err:
        raise AssertionError(f"cassandra_hits disagrees with its plain version at F={f} R={r}")
    cmp = ((alen[:, None] == model.action_len[None, :]) & ~model.action_any[None, :]).any(dim=1)
    need = int(torch.where(cmp, alen.clamp(0, MAX_ACTION), torch.zeros_like(alen)).sum())
    run = lambda: cassandra_hits(*args)  # noqa: E731
    row = dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: cassandra_hits_plain(*args), 10),
        bytes=need + (f * r if rx is not None else 0) + 13 * f + f
        + r * (MAX_ACTION + 4 + 1 + 1 + 128 + 1),
        ops=walked_rows(cassandra_rule_hits_plain(*args), r) + need,
        variant=kernels.hits_variant("cassandra_hits", r, f), max_abs_err=err,
    )
    return parent_turns("cassandra_hits", run, bound(row))


def k11_row(model, kd, klen, hk, ib, op, cid, rx, rem):
    """K11 on F frames and R rule rows: bytes, each keyed frame's key up to
    the longest exact or prefix needle, the [F, R] automaton hits where
    given, seven [F] inputs, the tables and the [F] output; ops, one test a
    (frame, row) the first-match walk visits and those key bytes (as K4
    and K9 count them); as ``k10_row``."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.models.memcached import (
        KEY_MODE_EXACT,
        KEY_MODE_PREFIX,
        memcache_hits,
        memcache_hits_plain,
        memcache_rule_hits_plain,
    )

    f, r = kd.shape[0], model.n_rules
    args = (model, kd, klen, hk, ib, op, cid, rx, rem)
    err = max_abs_err([memcache_hits(*args)], [memcache_hits_plain(*args)])
    if err:
        raise AssertionError(f"memcache_hits disagrees with its plain version at F={f} R={r}")
    modes = model.key_mode
    lens = model.key_needle_len[(modes == KEY_MODE_EXACT) | (modes == KEY_MODE_PREFIX)]
    most = int(lens.max()) if lens.numel() else 0
    need = int(torch.where(hk, klen.clamp(0, most), torch.zeros_like(klen)).sum())
    nc = model.cmd_tab.shape[1]
    run = lambda: memcache_hits(*args)  # noqa: E731
    row = dict(
        ms=graph_ms(run), call_ms=cuda_ms(run, 50),
        plain_ms=cuda_ms(lambda: memcache_hits_plain(*args), 10),
        bytes=need + (f * r if rx is not None else 0) + 18 * f + f
        + r * (256 + nc + 1 + 4 + 96 + 4 + 128 + 1),
        ops=walked_rows(memcache_rule_hits_plain(*args), r) + need,
        variant=kernels.hits_variant("memcache_hits", r, f), max_abs_err=err,
    )
    return parent_turns("memcache_hits", run, bound(row))


def acl_main_shapes(dev):
    """K10 and K11 as phase 6 calls them at F = 65,536: cassandra,
    cassandra-stress and memcached, each the wrapper's inputs recorded in
    the verdict pass.  [(label, stem, args)] on the card."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.models import cassandra as cass_mod
    from cilium_tpu_torch.models import memcached as mc_mod

    def on_card(host):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]

    stress_policy, stress_reqs = cassandra_stress_case()
    out = []
    for label, policy, host in (("cassandra", entry.cassandra_bench_policy(), entry.cassandra_batch(F)),
                                ("cassandra-stress", stress_policy, cassandra_rows(stress_reqs, F))):
        model = cass_mod.build_cassandra_model(policy, True, 9042)
        inp = on_card(host)
        out.append((label, "cassandra_hits", recorded_calls(
            cass_mod, "cassandra_hits", lambda: cass_mod.cassandra_verdicts(model, *inp))[0]))
    model = mc_mod.build_memcache_model(entry.memcache_bench_policy(), True, 11211)
    inp = on_card(entry.memcache_batch(F))
    out.append(("memcached", "memcache_hits", recorded_calls(
        mc_mod, "memcache_hits", lambda: mc_mod.memcache_verdicts(model, *inp))[0]))
    return out


def acl_engine_shapes(dev):
    """K10 and K11 at the Cassandra and memcache engines' largest calls
    (phase 6's engine traffic) and at the sidecar's (its 256 Cassandra or
    memcached conns' traffic, phase 9's, through the same engine), each
    the wrapper's inputs recorded where the engine calls it.  [(label,
    stem, args)] on the card."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.models import cassandra as cass_mod
    from cilium_tpu_torch.models import memcached as mc_mod
    from cilium_tpu_torch.runtime.l7engine import CassandraBatchEngine, MemcacheBatchEngine

    cpol, mpol = entry.cassandra_bench_policy(), entry.memcache_bench_policy()
    cmodel = cass_mod.build_cassandra_model(cpol, True, 9042)
    mmodel = mc_mod.build_memcache_model(mpol, True, 11211)
    out = []
    for label, mod, stem, make, feeds in (
        ("cassandra-engine", cass_mod, "cassandra_hits",
         lambda: CassandraBatchEngine(cpol, True, 9042, cmodel), cassandra_engine_feeds(random.Random(37), 2000)),
        ("memcache-engine", mc_mod, "memcache_hits",
         lambda: MemcacheBatchEngine(mpol, True, 11211, mmodel), memcache_engine_feeds(random.Random(41), 2000)),
        (f"sidecar-cassandra-{SIDE_CONNS['cassandra']}", cass_mod, "cassandra_hits",
         lambda: CassandraBatchEngine(cpol, True, 9042, cmodel),
         cassandra_engine_feeds(random.Random(47), SIDE_CONNS["cassandra"])),
        (f"sidecar-memcache-{SIDE_CONNS['memcache']}", mc_mod, "memcache_hits",
         lambda: MemcacheBatchEngine(mpol, True, 11211, mmodel),
         memcache_engine_feeds(random.Random(53), SIDE_CONNS["memcache"])),
    ):
        calls = recorded_calls(mod, stem, lambda: run_l7_engine(make, feeds))
        out.append((label, stem, max(calls, key=lambda c: c[1].shape[0])))
    return out


def dns_name_shapes(dev):
    """K8's readings besides phase 6's dns and dns-stress, each the
    wrapper's inputs where the main path calls it: dns-names-256 (65,536 x
    128), the DNS engine's largest call and the sidecar's DNS bucket (its
    1,024 DNS conns in one bucket at the service's width, 256).
    [(label, data, lengths)] on the card."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.models import dns as dns_mod
    from cilium_tpu_torch.models.dns import build_dns_model
    from cilium_tpu_torch.runtime.dnsengine import DnsBatchEngine

    def on_card(host):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host[:2])

    _, frames = dns_names_case()
    queries = entry.dns_queries()
    model = build_dns_model(entry.dns_bench_policy(), True, 53)
    calls = recorded_calls(dns_mod, "dns_name", lambda: run_l7_engine(
        lambda: DnsBatchEngine(model), dns_engine_feeds(random.Random(31), 3000)))
    return [
        ("dns-names-256", *on_card(tile_heads(frames, [1] * len(frames), F, DNS_NAMES_WIDTH))),
        ("dns-engine", *max(calls, key=lambda c: c[0].numel())),
        (f"sidecar-dns-{SIDE_CONNS['dns']}x256",
         *on_card(tile_heads(queries, [1] * len(queries), SIDE_CONNS["dns"], 256))),
    ]


def kafka_cases():
    """Phase 10's shapes: bench_kafka's (F = 65,536, 2 rules, W = 32) and
    the fuzz mix against tests/test_kafka.py's seven rule sets (F =
    65,536, overflow rows included); {name: dict(rows, reqs, batch,
    remotes)} with numpy batches."""
    from cilium_tpu_torch.entry import kafka_batch, kafka_bench_rules, kafka_requests
    from cilium_tpu_torch.models.kafka import KafkaRequestBatch, encode_requests

    batch, remotes = kafka_batch(F)
    cases = {"kafka": dict(rows=[(frozenset(), r) for r in kafka_bench_rules()], reqs=kafka_requests(),
                           batch=batch, remotes=remotes)}
    pool = kafka_fuzz_requests(random.Random(17), 4096)
    pb = encode_requests(pool)
    reps = -(-F // len(pool))
    fuzz_batch = KafkaRequestBatch(**{k: np.ascontiguousarray(np.concatenate([v] * reps)[:F])
                                      for k, v in vars(pb).items()})
    fuzz_rem = np.ones(F, np.int32)
    for i, kws in enumerate(KAFKA_FUZZ_RULES, 1):
        cases[f"kafka-fuzz-{i}"] = dict(rows=[(frozenset(), r) for r in _krules(kws)], reqs=pool,
                                        batch=fuzz_batch, remotes=fuzz_rem)
    return cases


def kafka_engine_shape(dev):
    """The Kafka engine's largest step as K17 gets it: (label, model,
    batch, remotes, parts)."""
    from cilium_tpu_torch.models import kafka as kafka_mod
    from cilium_tpu_torch.models.kafka import build_kafka_model
    from cilium_tpu_torch.runtime.engines import KafkaBatchEngine

    rows = kafka_engine_rows()
    calls = recorded_calls(kafka_mod, "kafka_hits", lambda: run_l7_engine(
        lambda: KafkaBatchEngine(build_kafka_model(rows), host_rows=rows),
        kafka_engine_feeds(random.Random(19), 2048)))
    return ("kafka-engine", *max(calls, key=lambda c: c[1].api_key.numel())[:3], False)


def kafka_mesh_shape(dev):
    """Rule shard 0 of mesh-kafka-1x4 (bench_kafka's rules and requests,
    F = 65,536) as K17 gets it, ``parts=True``: (label, model, batch,
    remotes, parts)."""
    from cilium_tpu_torch import entry
    from cilium_tpu_torch.parallel import rulesharding as rs
    from cilium_tpu_torch.parallel.mesh import flow_mesh

    batch, rem = entry.kafka_batch(MESH_F)
    kmodel = rs.mesh_kafka_model([(frozenset(), r) for r in entry.kafka_bench_rules()],
                                 flow_mesh(1, 4, mesh_slots(dev, 4)[0]))
    calls = recorded_calls(rs, "kafka_hits", lambda: kmodel(batch.to_device(dev),
                                                            torch.from_numpy(rem).to(dev)))
    if len(calls) != 4 or not calls[0][3].get("parts"):
        raise AssertionError(f"mesh-kafka-1x4: {len(calls)} kafka_hits calls, one a rule shard with parts")
    return ("mesh-kafka-1x4-shard0", *calls[0][:3], True)


def kafka_shapes(dev):
    """K17's readings, each the wrapper's inputs where the main path calls
    it: kafka and kafka-fuzz-1..7 (F = 65,536), the Kafka engine's largest
    step and rule shard 0 of mesh-kafka-1x4.  [(label, model, batch,
    remotes, parts)] on the card."""
    from cilium_tpu_torch.models.kafka import build_kafka_model

    out = [(name, build_kafka_model(c["rows"]), c["batch"].to_device(dev),
            torch.from_numpy(c["remotes"]).to(dev), False) for name, c in kafka_cases().items()]
    return out + [kafka_engine_shape(dev), kafka_mesh_shape(dev)]


def turns_text(turns):
    """The readings of ``in_turns`` as one log phrase."""
    n, o = sorted(turns["n"])[1], sorted(turns["o"])[1]
    return (", ".join(f"{t:.5f}" for t in turns["n"]) + " ms against the parent's "
            + ", ".join(f"{t:.5f}" for t in turns["o"])
            + f" ms (in turns n o o n n o; medians {n:.5f} / {o:.5f} = {n / o:.3f})")


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
    plain = "not measured" if row["plain_ms"] is None else f"{row['plain_ms']:.5f} ms"
    log(f"{name:15s} {kname:14s} device {row['ms']:.5f} ms  per call {row['call_ms']:.5f} ms  "
        f"plain {plain}  bound {row['bound_ms']:.6f} ms ({row['bound_by']}; "
        f"{row['bytes']} bytes, {row['ops']} ops)"
        + (" variant %s" % (row["variant"],) if "variant" in row else ""))
    if "index_bound_ms" in row:
        log(f"{name:15s} {kname:14s} index bound {row['index_bound_ms']:.6f} ms ({row['index_bound_by']}), "
            f"walk bound {row['walk_bound_ms']:.6f} ms ({row['walk_bound_by']})"
            + (f", {row['groups']} mask group(s)" if "groups" in row else ""))
    if "turns" in row:
        log(f"{name:15s} {kname:14s} {turns_text(row['turns'])}; per call {row['turns_call_ms']:.5f} "
            f"ms against the parent's {row['parent_call_ms']:.5f} (the better of two each)")


def log_pass(name, fn, t, card, parent=None):
    """A pass's times; ``parent``: ``parent_turns``' row for the same pass
    with the parent's kernels (empty without --baseline-csrc)."""
    log(f"{name:15s} {fn} device {t['pass_dev_ms']:.5f} ms = {F / t['pass_dev_ms'] * 1e3:.0f} "
        f"verdicts/s; per call {t['pass_ms']:.5f} ms = {F / t['pass_ms'] * 1e3:.0f} verdicts/s; "
        f"numpy in, one readback {t['host_ms']:.5f} ms = {F / t['host_ms'] * 1e3:.0f} "
        f"verdicts/s [{card}]")
    if parent and "turns" in parent:
        t["parent_turns"] = parent["turns"]
        log(f"{name:15s} {fn} device {turns_text(parent['turns'])} with the parent's "
            f"{'/'.join(parent['parent_stems'])} [{card}]")


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
