"""Unix-socket HTTP API server and client.

reference: the go-swagger REST API on the agent socket (api/v1/openapi.yaml,
served from daemon/main.go:973+; client pkg/client).  Routes mirror the
reference's /v1 surface: healthz, config, policy (+resolve), endpoint,
identity, ipcache, prefilter, map dumps, metrics.
"""

from __future__ import annotations

import http.client
import json
import re
import socket
import os
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable

from ..labels import LabelArray
from ..utils.unixhttp import serve_unix, shutdown_unix
from ..policy import DPort, rules_from_json
from ..utils.logging import get_logger

log = get_logger("api")


class ApiError(RuntimeError):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


class ApiServer:
    """Routes -> daemon methods (reference: daemon REST handler wiring)."""

    def __init__(self, daemon, path: str) -> None:
        self.daemon = daemon
        self.path = path
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _respond(self, status: int, body: Any) -> None:
                data = (
                    body.encode() if isinstance(body, str)
                    else json.dumps(body).encode()
                )
                self.send_response(status)
                ctype = (
                    "text/plain" if isinstance(body, str)
                    else "application/json"
                )
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n) if n else b""

            def _dispatch(self, method: str) -> None:
                try:
                    status, body = api.handle(
                        method, self.path, self._body()
                    )
                    self._respond(status, body)
                except ApiError as e:
                    self._respond(e.status, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — surface as 500
                    self._respond(500, {"error": f"{type(e).__name__}: {e}"})

            def do_GET(self):
                self._dispatch("GET")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

            def do_PATCH(self):
                self._dispatch("PATCH")

        self._httpd = serve_unix(path, Handler)

    # -- routing -----------------------------------------------------------

    def handle(self, method: str, path: str, body: bytes) -> tuple[int, Any]:
        path, _, query = path.partition("?")
        params = dict(
            p.split("=", 1) for p in query.split("&") if "=" in p
        )
        d = self.daemon

        if path == "/v1/healthz" and method == "GET":
            return 200, {"cilium": {"state": "Ok"}}
        if path == "/v1/status" and method == "GET":
            return 200, d.status()
        if path == "/metrics" and method == "GET":
            return 200, d.metrics_text()
        if path == "/v1/monitor/recent" and method == "GET":
            return 200, [e.to_dict() for e in d.monitor.recent(200)]
        if path == "/v1/node" and method == "GET":
            # Local node + discovered peers (reference: pkg/node store).
            return 200, {
                "local": d.node_discovery.local.to_dict(),
                "nodes": {
                    name: n.to_dict()
                    for name, n in d.node_discovery.get_nodes().items()
                },
            }
        if path == "/v1/health" and method == "GET":
            from ..health import Prober

            # a fresh Prober's status IS the empty shape — no drift
            prober = d.health_prober if d.health_prober is not None else Prober()
            return 200, prober.get_status()

        if path == "/v1/config":
            if method == "GET":
                cfg = d.config
                return 200, {
                    "cluster_name": cfg.cluster_name,
                    "enable_policy": cfg.enable_policy,
                    "dry_mode": cfg.dry_mode,
                    "batch_flows": cfg.batch_flows,
                    "options": cfg.opts.snapshot(),
                }
            if method == "PATCH":
                changes = json.loads(body.decode() or "{}")
                changed = {}
                for k, v in changes.get("options", {}).items():
                    changed[k] = d.config.opts.set(k, v)
                return 200, {"changed": changed}

        if path == "/v1/policy":
            if method == "GET":
                return 200, json.loads(d.policy_get())
            if method == "PUT":
                rules = rules_from_json(body.decode())
                rev = d.policy_add(rules)
                return 200, {"revision": rev}
            if method == "DELETE":
                lbls = json.loads(body.decode() or "[]")
                rev, deleted = d.policy_delete(LabelArray.parse(*lbls))
                return 200, {"revision": rev, "deleted": deleted}

        if path == "/v1/policy/resolve" and method == "GET":
            dports = []
            if params.get("dport"):
                port, _, proto = params["dport"].partition("/")
                dports = [DPort(int(port), (proto or "ANY").upper())]
            verdict, trace = d.policy_trace(
                LabelArray.parse_select(
                    *params.get("from", "").split(",")
                ) if params.get("from") else LabelArray(),
                LabelArray.parse_select(
                    *params.get("to", "").split(",")
                ) if params.get("to") else LabelArray(),
                dports,
            )
            return 200, {"verdict": verdict, "trace": trace}

        m = re.fullmatch(r"/v1/endpoint(?:/(\d+))?(/regenerate)?", path)
        if m:
            ep_id = int(m.group(1)) if m.group(1) else None
            if method == "GET" and ep_id is None:
                return 200, [
                    _endpoint_model(ep)
                    for ep in d.endpoint_manager.get_endpoints()
                ]
            if method == "GET":
                ep = d.endpoint_manager.lookup(ep_id)
                if ep is None:
                    raise ApiError(404, f"endpoint {ep_id} not found")
                return 200, _endpoint_model(ep, detail=True)
            if method == "PUT" and ep_id is not None:
                spec = json.loads(body.decode() or "{}")
                ep = d.endpoint_create(
                    ep_id,
                    ipv4=spec.get("ipv4", ""),
                    labels=spec.get("labels", []),
                    container_name=spec.get("container_name", ""),
                )
                return 201, _endpoint_model(ep)
            if method == "DELETE" and ep_id is not None:
                if not d.endpoint_delete(ep_id):
                    raise ApiError(404, f"endpoint {ep_id} not found")
                return 200, {}
            if method == "POST" and m.group(2):
                if not d.endpoint_regenerate(ep_id):
                    raise ApiError(404, f"endpoint {ep_id} not found")
                return 200, {}

        m = re.fullmatch(r"/v1/identity(?:/(\d+))?", path)
        if m and method == "GET":
            if m.group(1):
                ident = d.identity_allocator.lookup_by_id(int(m.group(1)))
                if ident is None:
                    raise ApiError(404, "identity not found")
                return 200, {
                    "id": ident.id, "labels": ident.labels.get_model()
                }
            return 200, [
                {"id": i, "labels": lbls.get_model()}
                for i, lbls in sorted(d.get_identity_cache().items())
            ]

        if path == "/v1/ipcache" and method == "GET":
            return 200, [
                {"ip": p.ip, "identity": p.identity}
                for p in d.ipcache.dump()
            ]

        if path == "/v1/prefilter":
            if method == "GET":
                rev, cidrs = d.prefilter.dump()
                return 200, {"revision": rev, "cidrs": cidrs}
            spec = json.loads(body.decode() or "{}")
            if method == "PATCH":
                rev = d.prefilter.insert(
                    spec.get("revision", 0), spec.get("cidrs", [])
                )
                return 200, {"revision": rev}
            if method == "DELETE":
                rev = d.prefilter.delete(
                    spec.get("revision", 0), spec.get("cidrs", [])
                )
                return 200, {"revision": rev}

        m = re.fullmatch(r"/v1/service(?:/(\d+))?", path)
        if m:
            return self._service(method, m.group(1), body)

        m = re.fullmatch(r"/v1/map(?:/([\w-]+))?", path)
        if m and method == "GET":
            return self._map_dump(m.group(1))

        raise ApiError(404, f"no route for {method} {path}")

    def _service(self, method: str, id_str: str | None,
                 body: bytes) -> tuple[int, Any]:
        """Service REST handlers (reference: daemon/loadbalancer.go
        PutServiceID :135 / GetServiceID :289 / DeleteServiceID :183
        + GET /service list)."""
        from ..service import L3n4Addr, ServiceError

        mgr = self.daemon.service_manager
        if method == "GET" and id_str is None:
            return 200, [s.to_model() for s in mgr.list()]
        if id_str is None:
            raise ApiError(400, "service ID required")
        svc_id = int(id_str)
        if svc_id == 0:
            raise ApiError(400, "invalid service ID 0")  # SVCAdd contract
        if method == "GET":
            svc = mgr.get(svc_id)
            if svc is None:
                raise ApiError(404, f"service {svc_id} not found")
            return 200, svc.to_model()
        if method == "DELETE":
            if not mgr.delete_by_id(svc_id):
                raise ApiError(404, f"service {svc_id} not found")
            return 200, {}
        if method == "PUT":
            spec = json.loads(body.decode() or "{}")
            try:
                frontend = L3n4Addr.from_dict(
                    spec.get("frontend-address") or {}
                )
                backends = [
                    L3n4Addr.from_dict(b)
                    for b in spec.get("backend-addresses") or []
                ]
                _, created = mgr.upsert(frontend, backends, id=svc_id)
            except ServiceError as e:
                raise ApiError(460, str(e)) from e
            return (201 if created else 200), mgr.get(svc_id).to_model()
        raise ApiError(405, f"{method} not supported on /v1/service")

    def _map_dump(self, name: str | None) -> tuple[int, Any]:
        """reference: cilium bpf * list / cilium map get."""
        d = self.daemon
        eps = d.endpoint_manager.get_endpoints()
        maps = {
            "ipcache": lambda: [
                {"prefix": k, "identity": v.sec_label}
                for k, v in d.ipcache_map.dump()
            ],
            "ct": lambda: [
                {
                    "daddr": k.daddr, "saddr": k.saddr, "dport": k.dport,
                    "sport": k.sport, "proto": k.nexthdr,
                    "lifetime": e.lifetime, "tx": e.tx_packets,
                    "rx": e.rx_packets,
                }
                for k, e in d.ct_map.dump()
            ],
            "lb": lambda: [
                {"vip": k.address, "dport": k.dport, "slave": k.slave,
                 "target": v.target, "port": v.port, "count": v.count}
                for k, v in d.lb_map.dump()
            ],
            "metrics": lambda: [
                {"direction": dir_, "reason": reason,
                 "count": count, "bytes": nbytes}
                for dir_, reason, count, nbytes in d.metrics_map.dump()
            ],
        }
        for ep in eps:
            maps[f"policy-{ep.id}"] = (
                lambda ep=ep: [
                    {"identity": k.identity, "dport": k.dest_port,
                     "proto": k.proto, "direction": k.direction,
                     "proxy_port": v.proxy_port}
                    for k, v in ep.policy_map.dump()
                ]
            )
        if name is None:
            return 200, sorted(maps)
        if name not in maps:
            raise ApiError(404, f"unknown map {name!r}")
        return 200, maps[name]()

    def close(self) -> None:
        shutdown_unix(self._httpd, self.path)


class _UnixConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: float = 10.0) -> None:
        super().__init__("localhost", timeout=timeout)
        self._unix_path = path

    def connect(self) -> None:
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(self.timeout)
        self.sock.connect(self._unix_path)


class ApiClient:
    """reference: pkg/client — CLI-side API access."""

    def __init__(self, path: str) -> None:
        self.path = path

    def request(self, method: str, route: str, body: Any = None) -> Any:
        conn = _UnixConnection(self.path)
        try:
            data = None
            headers = {}
            if body is not None:
                data = (
                    body.encode() if isinstance(body, str)
                    else json.dumps(body).encode()
                )
                headers["Content-Type"] = "application/json"
            conn.request(method, route, body=data, headers=headers)
            resp = conn.getresponse()
            payload = resp.read().decode()
            if resp.status >= 400:
                try:
                    msg = json.loads(payload).get("error", payload)
                except ValueError:
                    msg = payload
                raise ApiError(resp.status, msg)
            ctype = resp.headers.get("Content-Type", "")
            if "json" in ctype:
                return json.loads(payload) if payload else None
            return payload
        finally:
            conn.close()

    def get(self, route: str) -> Any:
        return self.request("GET", route)

    def put(self, route: str, body: Any = None) -> Any:
        return self.request("PUT", route, body)

    def post(self, route: str, body: Any = None) -> Any:
        return self.request("POST", route, body)

    def delete(self, route: str, body: Any = None) -> Any:
        return self.request("DELETE", route, body)

    def patch(self, route: str, body: Any = None) -> Any:
        return self.request("PATCH", route, body)


def _endpoint_model(ep, detail: bool = False) -> dict:
    out = {
        "id": ep.id,
        "state": ep.state.value,
        "ipv4": ep.ipv4,
        "identity": ep.security_identity.id if ep.security_identity else 0,
        "labels": ep.labels.get_model(),
        "policy_revision": ep.policy_revision,
    }
    if detail:
        out["ingress_enforced"] = ep.ingress_policy_enabled
        out["egress_enforced"] = ep.egress_policy_enabled
        out["redirects"] = dict(ep.realized_redirects)
        out["policy_map_entries"] = len(ep.policy_map.entries)
        out["spans"] = ep.stats.report()
    return out
