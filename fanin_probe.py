#!/usr/bin/env python3
"""The fan-in stall's smallest input, against either package's service on
the CPU.

One session floods F conns with back-to-back batches of F whole r2d2
frames while L light sessions each send one frame at a time; prints the
light sessions' p99 round trip without and with the flood, their RPCs
answered other than OK, the flooder's sheds, and with ``--count-ops``
(port only) the r2d2 passes the dispatcher ran during the flood: how
many, their torch ops and their longest wall time.

    python3 fanin_probe.py --package port --flood-conns 1 --lights 1
    python3 fanin_probe.py --package ref --flood-conns 64 --lights 15

The service runs with tests/test_fanin.py's starvation parameters
(``shed_queue_entries`` 4,096, ``session_share_min`` 128, no flood
quarantine).  Host code; set ``JAX_PLATFORMS=cpu`` for the reference.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import tempfile
import threading
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("port", "ref"), default="port")
    ap.add_argument("--flood-conns", type=int, default=1)
    ap.add_argument("--lights", type=int, default=1)
    ap.add_argument("--window", type=float, default=2.0, help="seconds of each measured window")
    ap.add_argument("--count-ops", action="store_true",
                    help="(port) count each r2d2 pass's torch ops; the counting itself costs time")
    args = ap.parse_args()
    pkg = "cilium_tpu_torch" if args.package == "port" else "cilium_tpu"
    pl = importlib.import_module(f"{pkg}.proxylib")
    sidecar = importlib.import_module(f"{pkg}.sidecar")
    option = importlib.import_module(f"{pkg}.utils.option")
    kw = dict(batch_timeout_ms=2.0, batch_flows=256, dispatch_mode="eager", shed_queue_entries=4096,
              session_share_min=128, session_flood_strikes=0)
    if args.package == "port":
        kw["verdict_device"] = "cpu"
    passes = _count_passes() if args.count_ops and args.package == "port" else None

    pol = pl.NetworkPolicy(name="p", policy=2, ingress_per_port_policies=[pl.PortNetworkPolicy(
        port=80, rules=[pl.PortNetworkPolicyRule(
            remote_policies=[1, 3], l7_proto="r2d2",
            l7_rules=[{"cmd": "READ", "file": "/public/.*"}, {"cmd": "HALT"}])])])
    tmp = tempfile.mkdtemp(prefix="fanin-probe-")
    svc = sidecar.VerdictService(os.path.join(tmp, "v.sock"), option.DaemonConfig(**kw)).start()
    clients = []
    try:
        def open_conns(client, ids):
            mod = client.open_module([])
            assert client.policy_update(mod, [pol]) == 0
            return [client.new_connection(mod, "r2d2", cid, True, 1, 2, f"1.1.1.1:{cid}", "2.2.2.2:80", "p")[1]
                    for cid in ids]

        hot = sidecar.SidecarClient(svc.socket_path, timeout=60.0, identity="hot")
        clients.append(hot)
        f = args.flood_conns
        open_conns(hot, range(5500, 5500 + f))
        lights = [sidecar.SidecarClient(svc.socket_path, timeout=60.0, identity=f"light-{i}")
                  for i in range(args.lights)]
        clients += lights
        shims = [open_conns(c, [5600 + i])[0] for i, c in enumerate(lights)]
        msg = b"READ /public/flood.txt\r\n"
        ids = np.arange(5500, 5500 + f, dtype=np.uint64)
        lens = np.full(f, len(msg), np.uint32)
        done = set()
        hot.verdict_callback = lambda vb: done.add(vb.seq)
        for w in range(12):  # every round shape the flood makes, warm
            hot.send_batch(90_000 + w, ids, [0] * f, lens, msg * f)
        while len(done) < 12:
            time.sleep(0.01)

        def p99():
            lats, k, failed = [], 0, 0
            t_end = time.monotonic() + args.window
            while time.monotonic() < t_end:
                t0 = time.monotonic()
                res, _ = lights[k % len(lights)]._on_data_rpc(shims[k % len(lights)].conn_id, False, False,
                                                               b"HALT\r\n")
                failed += res != 0
                lats.append(time.monotonic() - t0)
                k += 1
                time.sleep(0.005)
            lats.sort()
            return lats[min(int(len(lats) * 0.99), len(lats) - 1)] * 1e3, len(lats), failed

        baseline = p99()
        hot.verdict_callback = lambda vb: None
        stop = threading.Event()

        def flood():
            seq = 50_000
            while not stop.is_set():
                seq += 1
                hot.send_batch(seq, ids, [0] * f, lens, msg * f)

        t = threading.Thread(target=flood, daemon=True)
        t.start()
        time.sleep(0.3)
        if passes is not None:
            passes.clear()
        flooded = p99()
        stop.set()
        t.join(10)
        row = [r for r in svc.status()["sessions"]["live"] if r["identity"] == "hot"][0]
        out = dict(package=args.package, flood_conns=f, lights=args.lights,
                   baseline_p99_ms=round(baseline[0], 1), flooded_p99_ms=round(flooded[0], 1),
                   flooded_rpcs=flooded[1], light_not_ok=baseline[2] + flooded[2], flooder_shed=row["shed"],
                   flooder_submitted=row["submitted"])
        if passes is not None:
            out.update(passes=len(passes), pass_ops=sorted({n for n, _ in passes}),
                       pass_max_s=round(max((s for _, s in passes), default=0.0), 3),
                       pass_total_s=round(sum(s for _, s in passes), 3))
        print(json.dumps(out), flush=True)
    finally:
        for c in clients:
            c.close()
        svc.stop()
    return 0


def _count_passes():
    """Wrap the port's r2d2 verdict pass: [(torch ops, wall seconds)] a call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from cilium_tpu_torch.models import r2d2

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    passes = []
    inner = r2d2._verdict_pass

    def counted(model, data, lengths, remotes):
        t0 = time.perf_counter()
        with Count() as c:
            out = inner(model, data, lengths, remotes)
        passes.append((c.n, time.perf_counter() - t0))
        return out

    r2d2._verdict_pass = counted
    return passes


if __name__ == "__main__":
    raise SystemExit(main())
