"""Docker libnetwork remote driver.

reference: plugins/cilium-docker/driver/driver.go — an HTTP plugin on a
unix socket speaking the libnetwork remote-driver protocol: docker POSTs
JSON to /Plugin.Activate and NetworkDriver.* endpoints; the driver
answers with capabilities, provisions endpoints against the agent, and
on Join hands libnetwork the veth + gateway configuration.

Method surface mirrors driver.go:165-181 (Listen): Plugin.Activate,
NetworkDriver.{GetCapabilities, CreateNetwork, DeleteNetwork,
CreateEndpoint, DeleteEndpoint, EndpointOperInfo, Join, Leave}.
Errors use libnetwork's {"Err": "..."} shape.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler

from ..endpoint.connector import move_to_netns, setup_veth
from ..utils.logging import get_logger
from ..utils.unixhttp import serve_unix, shutdown_unix

log = get_logger("docker-driver")


class DriverError(RuntimeError):
    pass


class LibnetworkDriver:
    """The driver state machine; serve() exposes it on a unix socket."""

    def __init__(self, daemon, ipam, mtu: int = 1500) -> None:
        self.daemon = daemon
        self.ipam = ipam
        self.mtu = mtu
        self._lock = threading.Lock()
        self._networks: set[str] = set()
        # libnetwork EndpointID -> record
        self._endpoints: dict[str, dict] = {}
        self._next_ep_id = 5000
        self._server = None

    # -- protocol methods (driver.go handler names) -----------------------

    def activate(self, _body: dict) -> dict:
        """reference: driver.go handshake — implements NetworkDriver."""
        return {"Implements": ["NetworkDriver"]}

    def get_capabilities(self, _body: dict) -> dict:
        """reference: driver.go capabilities — local scope."""
        return {"Scope": "local"}

    def create_network(self, body: dict) -> dict:
        with self._lock:
            self._networks.add(body["NetworkID"])
        return {}

    def delete_network(self, body: dict) -> dict:
        with self._lock:
            self._networks.discard(body["NetworkID"])
        return {}

    def create_endpoint(self, body: dict) -> dict:
        """reference: driver.go:278 createEndpoint — rejects duplicates
        and missing IPv4, creates the agent endpoint."""
        eid = body["EndpointID"]
        iface = body.get("Interface") or {}
        addr = iface.get("Address", "")  # "ip/prefix"
        if not addr:
            raise DriverError("No IPv4 address provided")
        ip = addr.split("/")[0]
        with self._lock:
            if eid in self._endpoints:
                raise DriverError("Endpoint already exists")
            ep_id = self._next_ep_id
            self._next_ep_id += 1
            self._endpoints[eid] = {"ep_id": ep_id, "ip": ip, "veth": None}
        try:
            self.daemon.endpoint_create(
                ep_id, ipv4=ip, labels=["container:docker"],
                container_name=eid,
            )
        except Exception as e:  # noqa: BLE001 — surface as driver error
            with self._lock:
                self._endpoints.pop(eid, None)
            raise DriverError(str(e)) from e
        # libnetwork owns the interface it described; respond empty
        # (driver.go returns an empty Interface).
        return {"Interface": {}}

    def delete_endpoint(self, body: dict) -> dict:
        eid = body["EndpointID"]
        with self._lock:
            rec = self._endpoints.pop(eid, None)
        if rec is not None:
            self.daemon.endpoint_delete(rec["ep_id"])
        return {}

    def endpoint_info(self, body: dict) -> dict:
        eid = body["EndpointID"]
        with self._lock:
            if eid not in self._endpoints:
                raise DriverError(f"unknown endpoint {eid}")
        return {"Value": {}}

    def join(self, body: dict) -> dict:
        """reference: driver.go joinEndpoint — provision the veth and
        hand libnetwork the interface name + gateway."""
        eid = body["EndpointID"]
        with self._lock:
            rec = self._endpoints.get(eid)
        if rec is None:
            raise DriverError(f"unknown endpoint {eid}")
        veth = setup_veth(eid, body.get("SandboxKey", ""), mtu=self.mtu)
        move_to_netns(veth)
        rec["veth"] = veth
        return {
            "InterfaceName": {
                "SrcName": veth.tmp_ifname,
                "DstPrefix": "eth",
            },
            "Gateway": self.ipam.router_ip,
        }

    def leave(self, body: dict) -> dict:
        eid = body["EndpointID"]
        with self._lock:
            rec = self._endpoints.get(eid)
            if rec is not None:
                rec["veth"] = None
        return {}

    ROUTES = {
        "/Plugin.Activate": "activate",
        "/NetworkDriver.GetCapabilities": "get_capabilities",
        "/NetworkDriver.CreateNetwork": "create_network",
        "/NetworkDriver.DeleteNetwork": "delete_network",
        "/NetworkDriver.CreateEndpoint": "create_endpoint",
        "/NetworkDriver.DeleteEndpoint": "delete_endpoint",
        "/NetworkDriver.EndpointOperInfo": "endpoint_info",
        "/NetworkDriver.Join": "join",
        "/NetworkDriver.Leave": "leave",
    }

    # -- unix-socket HTTP plumbing ----------------------------------------

    def serve(self, path: str) -> "LibnetworkDriver":
        driver = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    body = {}
                name = driver.ROUTES.get(self.path)
                if name is None:
                    out, status = {"Err": f"unknown {self.path}"}, 404
                else:
                    try:
                        out, status = getattr(driver, name)(body), 200
                    except DriverError as e:
                        out, status = {"Err": str(e)}, 400
                    except Exception as e:  # noqa: BLE001
                        log.with_field("err", str(e)).warning(
                            "driver method failed"
                        )
                        out, status = {"Err": str(e)}, 500
                payload = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._server = serve_unix(path, Handler)
        self.path = path
        return self

    def close(self) -> None:
        if self._server is not None:
            shutdown_unix(self._server, self.path)
