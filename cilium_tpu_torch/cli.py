"""cilium-tpu CLI — the operator interface.

reference: cilium/cmd (cobra command tree: status, policy, endpoint,
identity, bpf map dumps, monitor, prefilter, config, metrics).  Speaks the
REST API on the agent's unix socket; `monitor` attaches to the monitor
socket.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .api import ApiClient, ApiError
from .utils import defaults

VERSION = "0.1.0"


def _client(args) -> ApiClient:
    return ApiClient(args.socket)


def _print(obj, as_json: bool) -> None:
    if as_json or isinstance(obj, str):
        print(obj if isinstance(obj, str) else json.dumps(obj, indent=2))
    else:
        print(json.dumps(obj, indent=2))


def cmd_status(args):
    st = _client(args).get("/v1/status")
    if args.json:
        _print(st, True)
        return 0
    print(f"KVStore:        {st['kvstore']['state']}  "
          f"({st['kvstore']['status']})")
    print(f"Cilium:         {st['cilium']['state']}  "
          f"uptime {st['cilium']['uptime_s']}s")
    print(f"Cluster:        {st['cluster']} node {st['node']}")
    print(f"Policy:         revision {st['policy']['revision']}, "
          f"{st['policy']['rules']} rules")
    eps = st["endpoints"]
    states = " ".join(f"{k}={v}" for k, v in eps["by_state"].items())
    print(f"Endpoints:      {eps['total']} ({states})")
    print(f"Identities:     {st['identity']['allocated']}")
    print(f"IPCache:        {st['ipcache']['entries']} entries")
    print(f"Proxy:          {st['proxy']['redirects']} redirects on "
          f"{st['proxy']['port_range']}")
    if args.all_controllers:
        print("Controllers:")
        for c in st["controllers"]:
            mark = "OK " if not c["last_error"] else "ERR"
            print(f"  {mark} {c['name']} success={c['success']} "
                  f"failure={c['failure']} {c['last_error']}")
    return 0


def cmd_policy_get(args):
    _print(_client(args).get("/v1/policy"), args.json)
    return 0


def cmd_policy_import(args):
    text = (
        sys.stdin.read() if args.file == "-" else open(args.file).read()
    )
    out = _client(args).put("/v1/policy", text)
    print(f"Revision: {out['revision']}")
    return 0


def cmd_policy_delete(args):
    out = _client(args).delete("/v1/policy", args.labels)
    print(f"Revision: {out['revision']}, deleted {out['deleted']} rules")
    return 0


def cmd_policy_trace(args):
    route = f"/v1/policy/resolve?from={args.src}&to={args.dst}"
    if args.dport:
        route += f"&dport={args.dport}"
    out = _client(args).get(route)
    if args.verbose and out.get("trace"):
        print(out["trace"])
    print(f"Verdict: {out['verdict']}")
    return 0 if out["verdict"] == "allowed" else 1


def cmd_endpoint_list(args):
    eps = _client(args).get("/v1/endpoint")
    if args.json:
        _print(eps, True)
        return 0
    print(f"{'ID':<8}{'STATE':<24}{'IDENTITY':<10}{'IPV4':<16}LABELS")
    for ep in eps:
        print(f"{ep['id']:<8}{ep['state']:<24}{ep['identity']:<10}"
              f"{ep['ipv4']:<16}{','.join(ep['labels'])}")
    return 0


def cmd_endpoint_get(args):
    _print(_client(args).get(f"/v1/endpoint/{args.id}"), args.json)
    return 0


def cmd_endpoint_create(args):
    spec = {"ipv4": args.ipv4, "labels": args.label or []}
    out = _client(args).put(f"/v1/endpoint/{args.id}", spec)
    _print(out, args.json)
    return 0


def cmd_endpoint_delete(args):
    _client(args).delete(f"/v1/endpoint/{args.id}")
    print(f"Endpoint {args.id} deleted")
    return 0


def cmd_endpoint_regenerate(args):
    _client(args).post(f"/v1/endpoint/{args.id}/regenerate")
    print(f"Endpoint {args.id} regeneration queued")
    return 0


def cmd_identity_list(args):
    _print(_client(args).get("/v1/identity"), args.json)
    return 0


def cmd_identity_get(args):
    _print(_client(args).get(f"/v1/identity/{args.id}"), args.json)
    return 0


def cmd_ipcache(args):
    _print(_client(args).get("/v1/ipcache"), args.json)
    return 0


def cmd_map_list(args):
    for name in _client(args).get("/v1/map"):
        print(name)
    return 0


def cmd_map_get(args):
    _print(_client(args).get(f"/v1/map/{args.name}"), args.json)
    return 0


def cmd_prefilter_list(args):
    _print(_client(args).get("/v1/prefilter"), args.json)
    return 0


def cmd_prefilter_update(args):
    out = _client(args).patch(
        "/v1/prefilter", {"revision": args.revision, "cidrs": args.cidr}
    )
    print(f"Revision: {out['revision']}")
    return 0


def cmd_prefilter_delete(args):
    out = _client(args).delete(
        "/v1/prefilter", {"revision": args.revision, "cidrs": args.cidr}
    )
    print(f"Revision: {out['revision']}")
    return 0


def cmd_config(args):
    c = _client(args)
    if args.option:
        changes = {}
        for opt in args.option:
            k, _, v = opt.partition("=")
            changes[k] = v or "true"
        out = c.patch("/v1/config", {"options": changes})
        _print(out, args.json)
    else:
        _print(c.get("/v1/config"), args.json)
    return 0


def _filter_metrics(text: str, prefix: str) -> str:
    """Name-prefix filter over Prometheus text exposition: keeps the
    HELP/TYPE/sample lines of metrics whose name starts with ``prefix``
    (with or without the ``cilium_tpu_`` namespace), including their
    ``_bucket``/``_sum``/``_count`` series."""
    if not prefix:
        return text
    from .utils.metrics import NAMESPACE

    prefixes = (prefix, f"{NAMESPACE}_{prefix}")
    out = []
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            name = line.split(" ", 3)[2]
        else:
            name = line.split("{", 1)[0].split(" ", 1)[0]
        if name.startswith(prefixes):
            out.append(line)
    return "\n".join(out) + ("\n" if out else "")


def cmd_metrics(args):
    text = _client(args).get("/metrics")
    print(_filter_metrics(text, args.prefix), end="")
    return 0


def cmd_monitor(args):
    from .monitor import MonitorClient, format_event

    client = MonitorClient(args.monitor_socket, version=args.protocol)
    print("Listening for events...", file=sys.stderr)
    try:
        while True:
            ev = client.next_event(timeout=1.0)
            if ev is None:
                continue
            if args.json:
                print(json.dumps(ev.to_dict()))
            else:
                print(format_event(ev))
            sys.stdout.flush()
    except KeyboardInterrupt:
        return 0
    finally:
        client.close()


def cmd_health(args):
    """reference: cilium-health status."""
    _print(_client(args).get("/v1/health"), args.json)
    return 0


def cmd_bugtool(args):
    """reference: bugtool/cmd/root.go:159 — support bundle."""
    from .bugtool import collect

    manifest = collect(_client(args), args.output)
    failed = [k for k, v in manifest["sections"].items() if not v["ok"]]
    print(f"wrote {args.output} ({len(manifest['sections'])} sections"
          + (f", {len(failed)} failed: {failed}" if failed else "") + ")")
    return 1 if failed else 0


def cmd_version(args):
    print(f"cilium-tpu {VERSION}")
    return 0


def _parse_l3n4(spec: str) -> dict:
    """'ip:port' or '[v6]:port' -> address dict (reference: cilium
    service update --frontend)."""
    host, _, port = spec.rpartition(":")
    host = host.strip("[]")
    try:
        port_n = int(port)
    except ValueError:
        port_n = 0
    if not host or not port_n:
        raise SystemExit(f"invalid address {spec!r}; want IP:PORT")
    return {"ip": host, "port": port_n, "protocol": "TCP"}


def cmd_service_list(args):
    """reference: cilium service list (cilium/cmd/service_list.go)."""
    data = _client(args).get("/v1/service")
    if args.json:
        print(json.dumps(data, indent=2))
        return 0
    for svc in data:
        fe = svc["frontend-address"]
        bes = ", ".join(
            f"{b['ip']}:{b['port']}" for b in svc["backend-addresses"]
        ) or "-"
        print(f"{svc['id']} {fe['ip']}:{fe['port']}/{fe['protocol']} -> {bes}")
    return 0


def cmd_service_get(args):
    _print(_client(args).get(f"/v1/service/{args.id}"), args.json)
    return 0


def cmd_service_update(args):
    """reference: cilium service update --id --frontend --backends."""
    body = {
        "frontend-address": _parse_l3n4(args.frontend),
        "backend-addresses": [
            _parse_l3n4(b) for b in (args.backends or "").split(",") if b
        ],
    }
    out = _client(args).put(f"/v1/service/{args.id}", body)
    _print(out, args.json)
    return 0


def cmd_service_delete(args):
    _client(args).delete(f"/v1/service/{args.id}")
    print(f"service {args.id} deleted")
    return 0


def cmd_node_list(args):
    """reference: cilium node list — local node + kvstore-discovered
    peers."""
    data = _client(args).get("/v1/node")
    if args.json:
        print(json.dumps(data, indent=2))
        return 0
    local = data["local"]
    print(f"local: {local['Cluster']}/{local['Name']} "
          f"{local['IPv4Address'] or '-'}")
    for name, n in sorted(data["nodes"].items()):
        print(f"{name} {n['IPv4Address'] or '-'}")
    return 0


def _run_kvstore(args, fn) -> int:
    """Direct store connection + error handling (reference:
    cilium/cmd/kvstore.go — these commands bypass the agent and dial
    the store, so failures name the STORE, not the agent socket)."""
    from .kvstore.backend import KvstoreError
    from .kvstore.net import NetBackend

    try:
        b = NetBackend(args.address)
    except (OSError, ValueError) as e:
        print(f"Error: cannot reach kvstore at {args.address}: {e}",
              file=sys.stderr)
        return 1
    try:
        return fn(b)
    except KvstoreError as e:
        print(f"Error: kvstore at {args.address}: {e}", file=sys.stderr)
        return 1
    finally:
        b.close()


def cmd_kvstore_get(args):
    def go(b):
        if args.recursive:
            items = b.list_prefix(args.key)
            for k in sorted(items):
                print(f"{k} => {items[k].decode(errors='replace')}")
            return 0
        v = b.get(args.key)
        if v is None:
            print(f"key {args.key} not found", file=sys.stderr)
            return 1
        print(v.decode(errors="replace"))
        return 0

    return _run_kvstore(args, go)


def cmd_kvstore_set(args):
    def go(b):
        b.set(args.key, args.value.encode())
        return 0

    return _run_kvstore(args, go)


def cmd_kvstore_delete(args):
    def go(b):
        if args.recursive:
            b.delete_prefix(args.key)
        else:
            b.delete(args.key)
        return 0

    return _run_kvstore(args, go)


def cmd_kvstore_status(args):
    """Fencing/arbitration view of one store server: role, epoch,
    whether it has been fenced by a newer primary, and the failure
    counters on both ends (reference: cilium kvstore + the etcd
    cluster-health probes in `cilium status --all-health`)."""

    def go(b):
        info = b.server_info()
        if args.json:
            print(json.dumps(info, indent=2))
            return 0
        fenced = (
            f"FENCED by epoch {info['fenced_by']}" if info["fenced"]
            else "writable" if info["role"] == "primary"
            else "read-only (replicating)"
        )
        print(f"{info['address']}: role={info['role']} "
              f"epoch={info['epoch']} {fenced}")
        print(f"backend: {info['backend']}")
        if info["replicating"]:
            print("replication: streaming from primary")
        for side in ("server", "client"):
            counters = info[f"{side}_counters"]
            if counters:
                joined = " ".join(
                    f"{k}={v}" for k, v in sorted(counters.items())
                )
                print(f"{side} counters: {joined}")
        return 0

    return _run_kvstore(args, go)


def cmd_sidecar_status(args):
    """Verdict-service health: throughput counters plus the overload/
    fault-containment ladder (queue depth, shed counts, quarantine,
    host-fallback) — the L7 analog of `cilium kvstore status`."""
    from .sidecar import SidecarClient, SidecarUnavailable

    try:
        cl = SidecarClient(args.address, timeout=3.0)
    except OSError as e:
        print(f"Error: cannot reach verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    try:
        st = cl.status()
    except (SidecarUnavailable, TimeoutError) as e:
        print(f"Error: verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    finally:
        cl.close()
    if args.json:
        print(json.dumps(st, indent=2))
        return 0
    cont = st.get("containment", {})
    disp = st.get("dispatcher", {})
    health = (
        "QUARANTINED (host fallback active)" if cont.get("quarantined")
        else "Ok"
    )
    print(f"{args.address}: {health}")
    print(f"connections: {st['connections']}  engines: {st['engines']}  "
          f"dispatch={st['dispatch_mode']}")
    print(f"verdicts: {st['requests']} requests, {st['denied']} denied, "
          f"{st['vec_entries']} vectorized")
    print(f"queue: depth={disp.get('queue_depth', 0)} "
          f"oldest={disp.get('queue_oldest_ms', 0)}ms "
          f"shed_submits={disp.get('shed_submits', 0)} "
          f"stall_deposals={disp.get('stall_deposals', 0)}")
    print(f"containment: shed={cont.get('shed_entries', 0)} "
          f"errors={cont.get('error_entries', 0)} "
          f"crashes={cont.get('batch_crashes', 0)} "
          f"fallback={cont.get('fallback_entries', 0)} "
          f"stalls={cont.get('stalls', 0)} "
          f"quarantine_events={cont.get('quarantine_events', 0)}")
    rst = st.get("restart") or {}
    if rst:
        refused = " ".join(
            f"{k}={v}"
            for k, v in sorted((rst.get("handoff_refused") or {}).items())
        )
        age = rst.get("handoff_age_s")
        print(f"restart: generation={rst.get('generation', 1)}"
              + (" FENCED(zombie predecessor)" if rst.get("fenced") else "")
              + (f" handoff_age={age}s" if age is not None else "")
              + f" restores: sessions={rst.get('session_restores', 0)}"
              + f" conns={rst.get('conn_restores', 0)}"
              + f" grants={rst.get('grant_restores', 0)}"
              + f" residue={rst.get('residue_restores', 0)}"
              + f" warm_shapes={rst.get('warm_shapes', 0)}"
              + (f" fence_rejects={rst.get('fence_rejects', 0)}"
                 if rst.get("fence_rejects") else "")
              + (f" stale_segments_swept={rst.get('stale_segments_swept', 0)}"
                 if rst.get("stale_segments_swept") else "")
              + (f" refused: {refused}" if refused else ""))
    pol = st.get("policy") or {}
    if pol:
        fails = " ".join(
            f"{k}={v}"
            for k, v in sorted((pol.get("swap_failures") or {}).items())
        )
        print(f"policy: epoch={pol.get('epoch', 0)} "
              f"swaps={pol.get('swaps', 0)} "
              f"last_swap={pol.get('last_swap_ms', 0)}ms "
              f"pending_builds={pol.get('pending_builds', 0)}"
              + (f" failures: {fails}" if fails else ""))
    mesh = st.get("mesh") or {}
    if mesh:
        dem = " ".join(
            f"{k}={v}"
            for k, v in sorted((mesh.get("demotions") or {}).items())
        )
        rung = mesh.get("rung") or (
            "full" if mesh.get("active") else "fallback"
        )
        lost = mesh.get("lost_devices") or []
        rfails = " ".join(
            f"{k}={v}"
            for k, v in sorted(
                (mesh.get("reshape_failures") or {}).items()
            )
        )
        print(f"mesh: devices={mesh.get('devices', 0)} "
              f"(flows={mesh.get('flow_shards', 0)}, "
              f"rules={mesh.get('rule_shards', 0)}) "
              f"{'ACTIVE' if mesh.get('active') else 'DEMOTED'} "
              f"rung={rung}"
              + (f" serving={mesh.get('serving_devices')}"
                 f"/{mesh.get('devices', 0)} "
                 f"capacity={mesh.get('capacity_frac', 1.0):.2f}"
                 if rung != "full" else "")
              + (f" lost={','.join(str(x) for x in lost)}"
                 if lost else "")
              + (f" reason={mesh.get('demoted')}" if mesh.get("demoted")
                 else "")
              + (f" demotions: {dem}" if dem else "")
              + (f" reshapes={mesh.get('reshapes', 0)}"
                 if mesh.get("reshapes") else "")
              + (f" reshape_window={mesh.get('reshape_window_ms', 0):.0f}ms"
                 if mesh.get("reshape_window_ms") else "")
              + (f" reshape_failures: {rfails}" if rfails else "")
              + (f" repromotions={mesh.get('repromotions', 0)}"
                 if mesh.get("repromotions") else "")
              + (f" rebind_rebuilds={mesh.get('rebind_rebuilds', 0)}"
                 if mesh.get("rebind_rebuilds") else ""))
    fc = st.get("flow_cache") or {}
    if fc:
        print(f"flow_cache: armed={fc.get('armed', 0)}/"
              f"{fc.get('cap', 0)} "
              f"hits={fc.get('hits', 0)} "
              f"misses={fc.get('misses', 0)} "
              f"invalidations={fc.get('invalidations', 0)} "
              f"evictions={fc.get('evictions', 0)}")
    def _fmt_shed(row):
        return " ".join(
            f"{k}={v}"
            for k, v in sorted((row.get("shed") or {}).items())
        )

    sessions = st.get("sessions") or {}
    if sessions:
        print(f"sessions: {len(sessions.get('live', []))} live, "
              f"{len(sessions.get('dead', []))} recently dead "
              f"(fair_share={sessions.get('fair_share', 0)})")
        for row in sessions.get("live", []):
            shed = _fmt_shed(row)
            q = ""
            if row.get("state") == "quarantined":
                q = (f" QUARANTINED({row.get('quarantine_reason')}, "
                     f"{row.get('quarantine_remaining_s', 0)}s left)")
            print(
                f"  [{row.get('session')}] {row.get('identity')} "
                f"{row.get('state')}{q} "
                f"submitted={row.get('submitted', 0)} "
                f"answered={row.get('answered', 0)} "
                f"served={row.get('served', 0)} "
                f"q={row.get('q_weight', 0)}"
                + (f" shed: {shed}" if shed else "")
            )
        for row in sessions.get("dead", []):
            shed = _fmt_shed(row)
            print(
                f"  [{row.get('session')}] {row.get('identity')} "
                f"dead({row.get('death_reason', '?')}) "
                f"submitted={row.get('submitted', 0)} "
                f"answered={row.get('answered', 0)}"
                + (f" shed: {shed}" if shed else "")
            )
    tr = st.get("transport") or {}
    if tr:
        rejects = " ".join(
            f"{k}={v}" for k, v in sorted((tr.get("rejects") or {}).items())
        )
        print(f"transport: shm_entries={tr.get('shm_entries', 0)} "
              f"shm_reclaims={tr.get('shm_reclaims', 0)}"
              + (f" rejects: {rejects}" if rejects else ""))
        for sess in tr.get("sessions", []):
            mode = sess.get("mode", "socket")
            tag = (f"session={sess.get('session', '?')} "
                   f"{sess.get('identity', '')}")
            if mode != "shm" and not sess.get("fallbacks"):
                print(f"  [{tag}] mode={mode}")
                continue
            data = sess.get("data") or {}
            verdict = sess.get("verdict") or {}
            fb = " ".join(
                f"{k}={v}"
                for k, v in sorted((sess.get("fallbacks") or {}).items())
            )
            print(
                f"  [{tag}] mode={mode} gen={sess.get('generation')} "
                f"data={data.get('occupancy', 0)}/{data.get('slots', 0)} "
                f"verdict={verdict.get('occupancy', 0)}"
                f"/{verdict.get('slots', 0)} "
                f"doorbells={sess.get('doorbells', 0)} "
                f"(batch~{sess.get('doorbell_batch_mean', 0)}) "
                f"credits={sess.get('credits', 0)}"
                + (f" fallbacks: {fb}" if fb else "")
            )
    rs = st.get("reasm") or {}
    if rs:
        arena = rs.get("arena") or {}
        fb = " ".join(
            f"{k}={v}"
            for k, v in sorted((rs.get("fallbacks") or {}).items())
        )
        by_f = " ".join(
            f"{k}={v}"
            for k, v in sorted((rs.get("rounds_by_framing") or {}).items())
        )
        print(f"reasm: rounds={rs.get('rounds', 0)}"
              + (f" ({by_f})" if by_f else "") + " "
              f"entries={rs.get('entries', 0)} "
              f"frames={rs.get('frames', 0)} "
              f"overflows={rs.get('overflows', 0)} "
              f"arena={arena.get('live_bytes', 0)}B/"
              f"{arena.get('capacity', 0)}B "
              f"({arena.get('slots', 0)} conns, "
              f"{arena.get('compactions', 0)} compactions)"
              + (f" fallbacks: {fb}" if fb else ""))
    if cont.get("quarantined"):
        print(f"quarantine: {cont.get('reason', '')} "
              f"for {cont.get('quarantined_for_s', 0)}s "
              f"(probes: {cont.get('probes', 0)})")
    lat = st.get("latency") or {}
    if lat.get("rounds"):
        print(f"latency: {lat['rounds']} rounds, "
              f"{lat.get('spans_sampled', 0)} sampled spans, "
              f"{lat.get('slow_exemplars', 0)} slow exemplars "
              f"(threshold {lat.get('slow_threshold_ms', 0)}ms, "
              f"sample 1/{lat.get('sample_every', 0)})")
        for path, stages in sorted((lat.get("stages") or {}).items()):
            cells = " ".join(
                f"{stage}={rec['mean_us']:.0f}us"
                + (f"/p99<={rec['p99_us']:.0f}us"
                   if rec.get("p99_us") is not None else "")
                for stage, rec in stages.items()
            )
            print(f"  [{path}] {cells}")
    tl = st.get("timeline") or {}
    if tl:
        tiers = " ".join(
            f"{k}={v}" for k, v in sorted((tl.get("tiers") or {}).items())
        )
        last = tl.get("last_postmortem") or {}
        print(f"timeline: {tl.get('events', 0)}/{tl.get('ring', 0)} events "
              f"(seq {tl.get('seq', 0)}), "
              f"{tl.get('fail_closed_events', 0)} fail-closed, "
              f"{tl.get('postmortems', 0)} postmortem(s)"
              + (f" tiers: {tiers}" if tiers else ""))
        if last:
            print(f"  last postmortem: {last.get('trigger', '?')} "
                  f"seq={last.get('seq')} events={last.get('events')}"
                  + (f" -> {last['path']}" if last.get("path") else ""))
    led = st.get("ledger") or {}
    if led:
        causes = " ".join(
            f"{k}={v}" for k, v in sorted((led.get("by_cause") or {}).items())
        )
        print(f"ledger: {led.get('compiles', 0)} compile(s) "
              f"({led.get('compile_seconds', 0.0):.3f}s total), "
              f"{led.get('executables_resident', 0)} executable(s) "
              f"resident, {led.get('dispatch_path_compiles', 0)} on "
              f"dispatch path"
              + (f" causes: {causes}" if causes else ""))
        for trig, rec in sorted((led.get("formation") or {}).items()):
            print(f"  [{trig}] rounds={rec.get('rounds', 0)} "
                  f"occ={rec.get('occ_mean', 0.0):.2f} "
                  f"age_mean={rec.get('age_mean_s', 0.0) * 1e6:.0f}us "
                  f"age_max={rec.get('age_max_s', 0.0) * 1e6:.0f}us "
                  f"depth_max={rec.get('depth_max', 0)} "
                  f"bytes={rec.get('bytes', 0)}")
    return 0


def cmd_sidecar_trace(args):
    """Dump the verdict service's latency-trace ring: sampled per-entry
    spans plus every slow-verdict exemplar, with per-stage breakdowns
    (the forensic half of the always-on stage histograms)."""
    from .sidecar import SidecarClient, SidecarUnavailable

    try:
        cl = SidecarClient(args.address, timeout=3.0)
    except OSError as e:
        print(f"Error: cannot reach verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    try:
        out = cl.trace(n=args.n, kind=args.kind, session=args.session)
    except (SidecarUnavailable, TimeoutError) as e:
        print(f"Error: verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    finally:
        cl.close()
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    spans = out.get("spans", [])
    lat = out.get("latency", {})
    print(f"{args.address}: {len(spans)} span(s) "
          f"({lat.get('spans_sampled', 0)} sampled, "
          f"{lat.get('slow_exemplars', 0)} slow, "
          f"{lat.get('shed_spans', 0)} shed)")
    from .sidecar.trace import format_stages_us

    for s in spans:
        stages = format_stages_us(s.get("stages_us", {}))
        reason = f" reason={s['reason']}" if s.get("reason") else ""
        sess = f" session={s['session']}" if s.get("session") else ""
        print(f"  {s['kind']:<6} path={s['path']:<6} seq={s['seq']:<8} "
              f"conn={s['conn_id']:<6} n={s['entries']:<5} "
              f"e2e={s['e2e_us'] / 1e3:.3f}ms{sess}{reason} {stages}")
    return 0


_TIMELINE_ID_KEYS = ("reason", "session", "conn", "epoch", "device", "n")


def _format_timeline_event(ev: dict) -> str:
    """One human line per flight-recorder event: seq, wall clock,
    table, edge, and whatever correlation ids the transition site
    annotated (reason/session/conn/epoch/device)."""
    import time as _time

    ts = _time.strftime("%H:%M:%S", _time.localtime(ev.get("t", 0)))
    frm, to = (ev.get("edge") or ["?", "?"])[:2]
    ids = " ".join(
        f"{k}={ev[k]}" for k in _TIMELINE_ID_KEYS if ev.get(k) is not None
    )
    flag = " FAIL-CLOSED" if ev.get("fail_closed") else ""
    return (f"  {ev.get('seq', 0):<7} {ts} {ev.get('table', '?'):<12} "
            f"{frm}->{to}{flag}" + (f" {ids}" if ids else ""))


def cmd_sidecar_timeline(args):
    """Dump the verdict service's flight recorder: the declared-edge
    incident timeline, windowed occupancy samples, and postmortem
    bundle summaries from every fail-closed transition."""
    from .sidecar import SidecarClient, SidecarUnavailable

    try:
        cl = SidecarClient(args.address, timeout=3.0)
    except OSError as e:
        print(f"Error: cannot reach verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    try:
        out = cl.timeline(n=args.n, since=args.since, table=args.table)
    except (SidecarUnavailable, TimeoutError) as e:
        print(f"Error: verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    finally:
        cl.close()
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    events = out.get("events", [])
    tl = out.get("timeline", {})
    tiers = " ".join(
        f"{k}={v}" for k, v in sorted((tl.get("tiers") or {}).items())
    )
    print(f"{args.address}: {len(events)} event(s) of "
          f"{tl.get('events', 0)} ringed (seq {tl.get('seq', 0)}, "
          f"{tl.get('fail_closed_events', 0)} fail-closed)"
          + (f" tiers: {tiers}" if tiers else ""))
    for ev in events:
        print(_format_timeline_event(ev))
    occ = out.get("occupancy", [])
    if occ:
        recent = occ[-5:]
        cells = " ".join(
            f"[busy={b.get('busy', 0):.2f} occ={b.get('occupancy', 0):.2f} "
            f"q={b.get('queue_max', 0)}]" for b in recent
        )
        print(f"occupancy ({len(occ)} bucket(s), newest last): {cells}")
    for pm in out.get("postmortems", []):
        print(f"postmortem: {pm.get('trigger', '?')} seq={pm.get('seq')} "
              f"events={pm.get('events')}"
              + (f" reason={pm['reason']}" if pm.get("reason") else "")
              + (f" -> {pm['path']}" if pm.get("path") else ""))
    return 0


_LEDGER_ID_KEYS = ("rules", "mesh", "epoch", "kind", "on_dispatch_path")


def _format_ledger_event(ev: dict) -> str:
    """One human line per compile-ledger event: seq, wall clock, cause,
    engine family, compile seconds, and the shape/correlation ids the
    recording site attached."""
    import time as _time

    ts = _time.strftime("%H:%M:%S", _time.localtime(ev.get("t", 0)))
    ids = " ".join(
        f"{k}={ev[k]}" for k in _LEDGER_ID_KEYS if ev.get(k) not in (None,
                                                                     False)
    )
    shape = f" shape={ev['shape']}" if ev.get("shape") else ""
    return (f"  {ev.get('seq', 0):<7} {ts} {ev.get('cause', '?'):<16} "
            f"{ev.get('family', '?'):<18} {ev.get('seconds', 0.0):.3f}s"
            + (f" {ids}" if ids else "") + shape)


def cmd_sidecar_ledger(args):
    """Dump the verdict service's device-economics ledger: per-cause
    trace/compile events, per-trigger batch-formation provenance, and
    the resident-executable census."""
    from .sidecar import SidecarClient, SidecarUnavailable

    try:
        cl = SidecarClient(args.address, timeout=3.0)
    except OSError as e:
        print(f"Error: cannot reach verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    try:
        out = cl.ledger(n=args.n, since=args.since, cause=args.cause)
    except (SidecarUnavailable, TimeoutError) as e:
        print(f"Error: verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    finally:
        cl.close()
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    events = out.get("compiles", [])
    led = out.get("ledger", {})
    causes = " ".join(
        f"{k}={v}" for k, v in sorted((led.get("by_cause") or {}).items())
    )
    print(f"{args.address}: {len(events)} compile(s) of "
          f"{led.get('compiles', 0)} recorded (seq {led.get('seq', 0)}, "
          f"{led.get('executables_resident', 0)} resident, "
          f"{led.get('dispatch_path_compiles', 0)} on dispatch path)"
          + (f" causes: {causes}" if causes else ""))
    for ev in events:
        print(_format_ledger_event(ev))
    form = out.get("formation", {})
    for trig, rec in sorted(form.items()):
        print(f"formation [{trig}]: rounds={rec.get('rounds', 0)} "
              f"items={rec.get('items', 0)} "
              f"occ={rec.get('occ_mean', 0.0):.2f} "
              f"age_mean={rec.get('age_mean_s', 0.0) * 1e6:.0f}us "
              f"age_max={rec.get('age_max_s', 0.0) * 1e6:.0f}us "
              f"depth_max={rec.get('depth_max', 0)} "
              f"bytes={rec.get('bytes', 0)}")
    return 0


def _format_flow_record(rec: dict) -> str:
    """One human line per flow record: who -> whom, verdict, serving
    path, and the deciding rule (`rule=<row> (<match kind>)`)."""
    import time as _time

    ts = _time.strftime("%H:%M:%S", _time.localtime(rec.get("ts", 0)))
    arrow = "->" if rec.get("ingress", True) else "<-"
    src = rec.get("src_identity", "?")
    dst = rec.get("dst_identity", "?")
    where = (
        f"{rec.get('proto', '?')}:{rec.get('dport', '?')}"
        + (f" policy={rec['policy']}" if rec.get("policy") else "")
    )
    rule = rec.get("rule_id", -1)
    attr = (
        f" rule={rule} ({rec.get('match_kind') or '?'})"
        if rule >= 0 else ""
    )
    if rec.get("epoch") is not None:
        attr += f" epoch={rec['epoch']}"
    if rec.get("session"):
        attr += f" session={rec['session']}"
    reason = f" reason={rec['reason']}" if rec.get("reason") else ""
    return (
        f"{ts} [{rec.get('path', '?')}] {rec.get('verdict', '?').upper()}: "
        f"identity {src} {arrow} {dst} conn={rec.get('conn_id')} "
        f"{where}{attr}{reason}"
    )


def cmd_observe(args):
    """Per-flow verdict records from the verdict service's flow log:
    why did flow X get verdict Y, and which rule decided it — the
    `cilium observe` / Hubble analog over MSG_OBSERVE."""
    from .sidecar import SidecarClient, SidecarUnavailable

    try:
        cl = SidecarClient(args.address, timeout=3.0)
    except OSError as e:
        print(f"Error: cannot reach verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    filters = dict(
        verdict=args.verdict, path=args.path,
        rule=args.rule, conn=args.conn, epoch=args.epoch,
        session=args.session,
    )
    try:
        if not args.follow:
            out = cl.observe(n=args.last, **filters)
            records = out.get("records", [])
            if args.json:
                print(json.dumps(out, indent=2))
                return 0
            stats = out.get("stats", {})
            if stats.get("disabled"):
                print("flow observability is disabled "
                      "(flow_observe=False)", file=sys.stderr)
                return 1
            for rec in reversed(records):  # oldest first for reading
                print(_format_flow_record(rec))
            print(f"{len(records)} record(s) "
                  f"({stats.get('records_total', 0)} total, ring "
                  f"{stats.get('records', 0)}/{stats.get('capacity', 0)})")
            return 0
        # Follow mode: poll with the seq cursor; records stream in
        # ascending order, each printed exactly once.
        cursor = None
        try:
            while True:
                out = cl.observe(n=args.last, since=cursor, **filters)
                if cursor is None and out.get("stats", {}).get("disabled"):
                    print("flow observability is disabled "
                          "(flow_observe=False)", file=sys.stderr)
                    return 1
                if cursor is None:
                    # Start at the CURRENT tail: follow shows new
                    # records, not history (use a plain query for that).
                    cursor = out.get("stats", {}).get("next_seq", 0) - 1
                    continue
                for rec in out.get("records", []):
                    if args.json:
                        print(json.dumps(rec))
                    else:
                        print(_format_flow_record(rec))
                    cursor = max(cursor, rec["seq"])
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
    except (SidecarUnavailable, TimeoutError) as e:
        print(f"Error: verdict service at {args.address}: {e}",
              file=sys.stderr)
        return 1
    finally:
        cl.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cilium-tpu",
        description="CLI for the cilium node agent (PyTorch and CUDA)",
    )
    p.add_argument("--socket", default=defaults.SOCK_PATH,
                   help="agent API unix socket")
    p.add_argument("--json", action="store_true", help="JSON output")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("status", help="daemon status")
    s.add_argument("--all-controllers", action="store_true")
    s.set_defaults(fn=cmd_status)

    pol = sub.add_parser("policy", help="policy management").add_subparsers(
        dest="sub", required=True
    )
    x = pol.add_parser("get")
    x.set_defaults(fn=cmd_policy_get)
    x = pol.add_parser("import")
    x.add_argument("file", help="policy JSON file, or - for stdin")
    x.set_defaults(fn=cmd_policy_import)
    x = pol.add_parser("delete")
    x.add_argument("labels", nargs="+")
    x.set_defaults(fn=cmd_policy_delete)
    x = pol.add_parser("trace")
    x.add_argument("--src", required=True, help="comma-separated labels")
    x.add_argument("--dst", required=True)
    x.add_argument("--dport", default="")
    x.add_argument("-v", "--verbose", action="store_true")
    x.set_defaults(fn=cmd_policy_trace)

    ep = sub.add_parser("endpoint", help="endpoints").add_subparsers(
        dest="sub", required=True
    )
    x = ep.add_parser("list")
    x.set_defaults(fn=cmd_endpoint_list)
    x = ep.add_parser("get")
    x.add_argument("id", type=int)
    x.set_defaults(fn=cmd_endpoint_get)
    x = ep.add_parser("create")
    x.add_argument("id", type=int)
    x.add_argument("--ipv4", default="")
    x.add_argument("-l", "--label", action="append")
    x.set_defaults(fn=cmd_endpoint_create)
    x = ep.add_parser("delete")
    x.add_argument("id", type=int)
    x.set_defaults(fn=cmd_endpoint_delete)
    x = ep.add_parser("regenerate")
    x.add_argument("id", type=int)
    x.set_defaults(fn=cmd_endpoint_regenerate)

    ident = sub.add_parser("identity", help="identities").add_subparsers(
        dest="sub", required=True
    )
    x = ident.add_parser("list")
    x.set_defaults(fn=cmd_identity_list)
    x = ident.add_parser("get")
    x.add_argument("id", type=int)
    x.set_defaults(fn=cmd_identity_get)

    x = sub.add_parser("ipcache", help="IP to identity mappings")
    x.set_defaults(fn=cmd_ipcache)

    mp = sub.add_parser("map", help="datapath maps").add_subparsers(
        dest="sub", required=True
    )
    x = mp.add_parser("list")
    x.set_defaults(fn=cmd_map_list)
    x = mp.add_parser("get")
    x.add_argument("name")
    x.set_defaults(fn=cmd_map_get)

    pf = sub.add_parser("prefilter", help="CIDR prefilter").add_subparsers(
        dest="sub", required=True
    )
    x = pf.add_parser("list")
    x.set_defaults(fn=cmd_prefilter_list)
    x = pf.add_parser("update")
    x.add_argument("--revision", type=int, required=True)
    x.add_argument("--cidr", action="append", required=True)
    x.set_defaults(fn=cmd_prefilter_update)
    x = pf.add_parser("delete")
    x.add_argument("--revision", type=int, required=True)
    x.add_argument("--cidr", action="append", required=True)
    x.set_defaults(fn=cmd_prefilter_delete)

    x = sub.add_parser("config", help="get/set daemon options")
    x.add_argument("option", nargs="*", help="Option=value pairs")
    x.set_defaults(fn=cmd_config)

    x = sub.add_parser("metrics", help="Prometheus metrics")
    x.add_argument("prefix", nargs="?", default="",
                   help="only metrics whose name starts with this "
                        "prefix (namespace optional)")
    x.set_defaults(fn=cmd_metrics)

    x = sub.add_parser("monitor", help="live event stream")
    x.add_argument("--monitor-socket", default=defaults.MONITOR_SOCK_PATH)
    # Listener protocol generation (reference: monitor/listener1_0.go
    # vs listener1_2.go — both served simultaneously).
    x.add_argument("--protocol", choices=["1.0", "1.2"], default="1.2")
    x.set_defaults(fn=cmd_monitor)

    x = sub.add_parser("health", help="node connectivity status")
    x.set_defaults(fn=cmd_health)

    x = sub.add_parser("bugtool", help="collect a support bundle")
    x.add_argument("-o", "--output", default="cilium-tpu-bugtool.tar.gz")
    x.set_defaults(fn=cmd_bugtool)

    nd = sub.add_parser("node", help="cluster nodes").add_subparsers(
        dest="node_cmd", required=True
    )
    x = nd.add_parser("list")
    x.set_defaults(fn=cmd_node_list)

    # reference: cilium service list/get/update/delete
    # (cilium/cmd/service*.go)
    svc = sub.add_parser(
        "service", help="load-balancer services"
    ).add_subparsers(dest="svc_cmd", required=True)
    x = svc.add_parser("list")
    x.set_defaults(fn=cmd_service_list)
    x = svc.add_parser("get")
    x.add_argument("id", type=int)
    x.set_defaults(fn=cmd_service_get)
    x = svc.add_parser("update")
    x.add_argument("--id", type=int, required=True)
    x.add_argument("--frontend", required=True, help="VIP as IP:PORT")
    x.add_argument("--backends", default="",
                   help="comma-separated backend IP:PORT list")
    x.set_defaults(fn=cmd_service_update)
    x = svc.add_parser("delete")
    x.add_argument("id", type=int)
    x.set_defaults(fn=cmd_service_delete)

    kv = sub.add_parser(
        "kvstore", help="direct kvstore access (reference: cilium kvstore)"
    ).add_subparsers(dest="kv_cmd", required=True)
    for name, fn, val in (
        ("get", cmd_kvstore_get, False),
        ("set", cmd_kvstore_set, True),
        ("delete", cmd_kvstore_delete, False),
    ):
        x = kv.add_parser(name)
        x.add_argument("key")
        if val:
            x.add_argument("value")
        else:
            x.add_argument("--recursive", action="store_true")
        x.add_argument("--address", required=True,
                       help="kvstore server host:port")
        x.set_defaults(fn=fn)
    x = kv.add_parser(
        "status", help="store role/epoch/fencing state + counters"
    )
    x.add_argument("--address", required=True,
                   help="kvstore server host:port")
    x.add_argument("--json", action="store_true")
    x.set_defaults(fn=cmd_kvstore_status)

    sc = sub.add_parser(
        "sidecar", help="verdict-service status (overload/containment)"
    ).add_subparsers(dest="sc_cmd", required=True)
    x = sc.add_parser(
        "status",
        help="verdict counters + shed/quarantine/fallback ladder",
    )
    x.add_argument("--address", required=True,
                   help="verdict service unix socket path")
    x.add_argument("--json", action="store_true")
    x.set_defaults(fn=cmd_sidecar_status)
    x = sc.add_parser(
        "trace",
        help="latency-trace ring: sampled spans + slow-verdict "
             "exemplars with stage breakdowns",
    )
    x.add_argument("--address", required=True,
                   help="verdict service unix socket path")
    x.add_argument("-n", type=int, default=50, help="max spans")
    x.add_argument("--kind", choices=["sample", "slow", "shed"],
                   default=None, help="only spans of this kind")
    x.add_argument("--session", type=int, default=None,
                   help="only spans attributed to this fan-in session "
                        "id (see `cilium sidecar status` sessions)")
    x.add_argument("--json", action="store_true")
    x.set_defaults(fn=cmd_sidecar_trace)
    x = sc.add_parser(
        "timeline",
        help="flight-recorder ring: declared-edge incident timeline, "
             "occupancy buckets, and postmortem bundle summaries",
    )
    x.add_argument("--address", required=True,
                   help="verdict service unix socket path")
    x.add_argument("-n", type=int, default=100, help="max events")
    x.add_argument("--since", type=int, default=0,
                   help="only events with seq strictly greater "
                        "(incremental tail cursor)")
    x.add_argument("--table", default=None,
                   help="typestate table filter (session, device_guard, "
                        "mesh_device, mesh_ladder, flow_cache, "
                        "epoch_swap, mark, overload)")
    x.add_argument("--json", action="store_true")
    x.set_defaults(fn=cmd_sidecar_timeline)
    x = sc.add_parser(
        "ledger",
        help="device-economics ledger: per-cause compile events, "
             "batch-formation provenance, resident-executable census",
    )
    x.add_argument("--address", required=True,
                   help="verdict service unix socket path")
    x.add_argument("-n", type=int, default=100,
                   help="max compile events")
    x.add_argument("--since", type=int, default=0,
                   help="only events with seq strictly greater "
                        "(incremental tail cursor)")
    x.add_argument("--cause", default=None,
                   help="compile-cause filter (cold, prewarm, "
                        "churn-new-shape, churn-vocab, mesh-reshape, "
                        "repromotion, heal-rebind)")
    x.add_argument("--json", action="store_true")
    x.set_defaults(fn=cmd_sidecar_ledger)

    x = sub.add_parser(
        "observe",
        help="per-flow verdict records with rule attribution "
             "(verdict service flow log)",
    )
    x.add_argument("--address", required=True,
                   help="verdict service unix socket path")
    x.add_argument("--last", type=int, default=20,
                   help="max records per query")
    x.add_argument("--verdict",
                   choices=["Forwarded", "Denied", "Shed", "Error"],
                   default=None)
    x.add_argument("--path", default=None,
                   help="serving path filter (vec|oracle|host|shed|...)")
    x.add_argument("--rule", type=int, default=None,
                   help="deciding rule row filter")
    x.add_argument("--conn", type=int, default=None,
                   help="connection id filter")
    x.add_argument("--epoch", type=int, default=None,
                   help="policy-table epoch filter (the epoch the "
                        "verdict was decided against)")
    x.add_argument("--session", type=int, default=None,
                   help="fan-in session filter (the shim session the "
                        "conn registered through)")
    x.add_argument("--follow", "-f", action="store_true",
                   help="stream new records (poll with a seq cursor)")
    x.add_argument("--interval", type=float, default=0.5,
                   help="follow poll interval seconds")
    x.add_argument("--json", action="store_true")
    x.set_defaults(fn=cmd_observe)

    x = sub.add_parser("version")
    x.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except (ConnectionRefusedError, FileNotFoundError):
        print(
            f"Error: cannot reach the agent on {args.socket} "
            "(is cilium-tpu-agent running?)",
            file=sys.stderr,
        )
        return 1


if __name__ == "__main__":
    sys.exit(main())
