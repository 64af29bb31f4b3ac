"""The port's service proxy against the JAX package's.

Exact, on the same inputs made from a seed:

- `LoadBalancerRR`'s picks, errors and endpoint lists over one sequence
  of service registrations, endpoint updates (decoded by each package's
  model), picks with and without ClientIP affinity, affinity drops and
  deletes;
- `PortalRuleTable` after the same rule operations;
- the proxier's open and closed portals after the same service updates
  (each portal's VIP, port, protocol, affinity, node port, and its rule
  pointing at its own listener), with real listeners, the TCP copy loop
  to local echo backends (the round-robin order of the answers) and the
  UDP path;
- `LoopbackPortals` and a real-portal `Proxier` with the `ip` runner
  (`portal._ip`) replaced by a recorder: the same commands in both, and
  no address is installed on the machine;
- `ProxyServer` fed by the watches of an in-process apiserver.

Every listener and backend binds port 0, except the one node port,
which each package binds in turn.
"""

import random
import socket
import socketserver
import subprocess
import threading
import time
import types

import pytest

from kubernetes_tpu.client import rest as jax_rest
from kubernetes_tpu.models import objects as jax_objects
from kubernetes_tpu.models import serde as jax_serde
from kubernetes_tpu.proxy import config as jax_config
from kubernetes_tpu.proxy import portal as jax_portal
from kubernetes_tpu.proxy import proxier as jax_proxier
from kubernetes_tpu.proxy import roundrobin as jax_rr
from kubernetes_tpu.proxy import ruletable as jax_rules
from kubernetes_tpu.server import api as jax_api

from kubernetes_tpu_torch.client import rest as port_rest
from kubernetes_tpu_torch.models import apiobjects as port_objects
from kubernetes_tpu_torch.models import serde as port_serde
from kubernetes_tpu_torch.proxy import config as port_config
from kubernetes_tpu_torch.proxy import portal as port_portal
from kubernetes_tpu_torch.proxy import proxier as port_proxier
from kubernetes_tpu_torch.proxy import roundrobin as port_rr
from kubernetes_tpu_torch.proxy import ruletable as port_rules
from kubernetes_tpu_torch.server import api as port_api

JAX = types.SimpleNamespace(name="jax", rest=jax_rest, objects=jax_objects, serde=jax_serde,
                            config=jax_config, portal=jax_portal, proxier=jax_proxier,
                            rr=jax_rr, rules=jax_rules, api=jax_api)
PORT = types.SimpleNamespace(name="port", rest=port_rest, objects=port_objects,
                             serde=port_serde, config=port_config, portal=port_portal,
                             proxier=port_proxier, rr=port_rr, rules=port_rules, api=port_api)
BOTH = (JAX, PORT)


class _Echo(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _EchoHandler(socketserver.BaseRequestHandler):
    def handle(self):
        while True:
            data = self.request.recv(4096)
            if not data:
                return
            self.request.sendall(self.server.tag + data)


@pytest.fixture
def backends():
    servers = []
    for tag in (b"A:", b"B:", b"C:"):
        srv = _Echo(("127.0.0.1", 0), _EchoHandler)
        srv.tag = tag
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    yield servers
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _roundtrip(addr, payload=b"hi"):
    with socket.create_connection(addr, timeout=5) as s:
        s.sendall(payload)
        return s.recv(4096)


def _endpoints_wire(name, addrs, portname="", ns="default"):
    subsets = {}
    for ip, port in addrs:
        subsets.setdefault(port, []).append({"ip": ip})
    return {"kind": "Endpoints", "metadata": {"name": name, "namespace": ns},
            "subsets": [{"addresses": a, "ports": [{"name": portname, "port": p}]}
                        for p, a in subsets.items()]}


def _service_wire(name, ip, ports, affinity="None", ns="default"):
    return {"kind": "Service", "metadata": {"name": name, "namespace": ns},
            "spec": {"clusterIP": ip, "sessionAffinity": affinity, "ports": ports}}


def _typed(pkg, kind, wire):
    return pkg.serde.from_wire(getattr(pkg.objects, kind), wire)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except KeyError as e:
        return ("error", type(e).__name__, e.args)


@pytest.mark.parametrize("seed", range(5))
def test_load_balancer_matches_jax(seed):
    rng = random.Random(seed)
    svcs = [("default", f"s{i}", rng.choice(["", "http"])) for i in range(3)]
    ops = []
    for _ in range(120):
        svc = rng.choice(svcs)
        kind = rng.choice(["pick"] * 6 + ["new", "update", "delete", "drop", "clean"])
        if kind == "new":
            ops.append((kind, svc, rng.choice(["None", "ClientIP"]), rng.choice([0, 60])))
        elif kind == "update":
            ops.append((kind, [_endpoints_wire(s[1], [(f"10.1.{i}.{rng.randrange(4)}",
                                                      rng.choice([80, 8080]))
                                                     for i in range(rng.randrange(0, 4))],
                                               portname=s[2])
                               for s in svcs if rng.random() < 0.8]))
        else:
            ops.append((kind, svc, f"192.168.0.{rng.randrange(4)}" if rng.random() < 0.7 else ""))
    seen = {}
    for pkg in BOTH:
        lb = pkg.rr.LoadBalancerRR()
        out = []
        for op in ops:
            if op[0] == "new":
                lb.new_service(op[1], affinity_type=op[2], ttl_seconds=op[3])
            elif op[0] == "update":
                lb.on_update([_typed(pkg, "Endpoints", w) for w in op[1]])
                out.append([lb.endpoints_for(s) for s in svcs])
            elif op[0] == "pick":
                out.append(_outcome(lb.next_endpoint, op[1], op[2]))
            elif op[0] == "delete":
                lb.delete_service(op[1])
            elif op[0] == "drop":
                lb.invalidate_affinity(op[1], op[2])
            else:
                lb.clean_expired_affinity()
        seen[pkg.name] = out
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("seed", range(3))
def test_rule_table_matches_jax(seed):
    rng = random.Random(seed)
    ops = []
    for _ in range(80):
        key = (f"10.0.0.{rng.randrange(5)}", rng.choice([80, 443]), rng.choice(["TCP", "udp"]))
        if rng.random() < 0.6:
            ops.append(("ensure", key, ("127.0.0.1", rng.randrange(3) + 30000), "ns/s:p"))
        elif rng.random() < 0.5:
            ops.append(("delete", key))
        else:
            ops.append(("resolve", key))
    seen = {}
    for pkg in BOTH:
        table = pkg.rules.PortalRuleTable()
        out = []
        for op in ops:
            if op[0] == "ensure":
                out.append(table.ensure_rule(pkg.rules.PortalRule(*op[1], *op[2], op[3])))
            elif op[0] == "delete":
                table.delete_rule(*op[1])
            else:
                out.append(table.resolve(*op[1]))
            out.append(len(table))
        out.append(sorted(repr(r) for r in table.rules()))
        table.flush()
        out.append(len(table))
        seen[pkg.name] = out
    assert seen["port"] == seen["jax"]


def _free_port(kind=socket.SOCK_STREAM):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reserved_port():
    """A TCP port held bound (not listening, SO_REUSEADDR) so no other
    process's ephemeral bind takes it, while a proxier's SO_REUSEADDR
    listener may still bind it. Close the socket when done."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s


def _portals(proxier, rules, node_ports=()):
    """The proxier's open portals and the rules pointing at them (a port
    of `node_ports` written as "node-port")."""
    out = {}
    for name, info in sorted(proxier._services.items()):
        rule = rules.resolve(info.portal_ip, info.portal_port, info.protocol)
        out[name] = (info.portal_ip, info.portal_port, info.protocol, info.session_affinity,
                     "node-port" if info.node_port and info.node_port in node_ports
                     else info.node_port, info.real, info.node_socket is not None,
                     rule == (proxier.listen_ip, info.proxy_port))
    return out, len(rules)


@pytest.mark.parametrize("seed", range(3))
def test_proxier_portals_match_jax(seed):
    rng = random.Random(seed)
    updates = []
    for _ in range(6):
        services = []
        for i in range(rng.randrange(1, 5)):
            ports = [{"name": f"p{k}", "port": 80 + k,
                      "protocol": rng.choice(["TCP", "TCP", "UDP"])}
                     for k in range(rng.randrange(1, 3))]
            if i == 0 and rng.random() < 0.5:
                ports[0]["nodePort"] = "node-port"
                ports[0]["protocol"] = "TCP"
            services.append(_service_wire(f"s{i}", rng.choice(["10.0.0.1", f"10.0.0.{i + 2}",
                                                               "None", ""]), ports,
                                          affinity=rng.choice(["None", "ClientIP"])))
        updates.append(services)
    seen = {}
    for pkg in BOTH:
        # A node port an update, each held until its proxier stops: a
        # closed listener lingers while its accept thread waits, so a
        # port is never bound twice in a run.
        reservations = [_reserved_port() for _ in updates]
        node_ports = {r.getsockname()[1] for r in reservations}
        p = pkg.proxier.Proxier()
        try:
            seen[pkg.name] = []
            for services, reservation in zip(updates, reservations):
                for s in services:
                    for port in s["spec"]["ports"]:
                        if "nodePort" in port:
                            port["nodePort"] = reservation.getsockname()[1]
                p.on_update([_typed(pkg, "Service", w) for w in services])
                seen[pkg.name].append(_portals(p, p.rules, node_ports))
        finally:
            p.stop()
            for r in reservations:
                r.close()
        seen[pkg.name].append((len(p.rules), p.has_real_portals))
    assert seen["port"] == seen["jax"]


def test_tcp_and_udp_paths_match_jax(backends):
    eps = [("127.0.0.1", b.server_address[1]) for b in backends]
    udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    udp.bind(("127.0.0.1", 0))
    stop = threading.Event()

    def udp_echo():
        udp.settimeout(0.2)
        while not stop.is_set():
            try:
                data, addr = udp.recvfrom(4096)
            except OSError:
                continue
            udp.sendto(b"U:" + data, addr)

    threading.Thread(target=udp_echo, daemon=True).start()
    seen = {}
    try:
        for pkg in BOTH:
            p = pkg.proxier.Proxier()
            try:
                p.on_update([_typed(pkg, "Service", _service_wire(
                    "web", "10.0.0.5", [{"name": "", "port": 80, "protocol": "TCP"}])),
                             _typed(pkg, "Service", _service_wire(
                                 "sticky", "10.0.0.6", [{"name": "", "port": 80}],
                                 affinity="ClientIP")),
                             _typed(pkg, "Service", _service_wire(
                                 "dns", "10.0.0.7", [{"name": "", "port": 53,
                                                      "protocol": "UDP"}]))])
                dns = ("dns", [("127.0.0.1", udp.getsockname()[1])])
                p.lb.on_update([_typed(pkg, "Endpoints", _endpoints_wire(n, e))
                                for n, e in (("web", eps), ("sticky", eps), dns)])
                web = p.rules.resolve("10.0.0.5", 80)
                answers = [_roundtrip(web, b"x%d" % i) for i in range(9)]
                sticky = {_roundtrip(p.rules.resolve("10.0.0.6", 80))[:2] for _ in range(5)}
                # A dead backend is skipped. (An update is the whole state.)
                p.lb.on_update([_typed(pkg, "Endpoints", _endpoints_wire(n, e)) for n, e in (
                    ("web", [("127.0.0.1", _free_port()), eps[1]]), ("sticky", eps), dns)])
                retried = [_roundtrip(web)[:2] for _ in range(4)]
                u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                u.settimeout(5)
                u.sendto(b"q", p.rules.resolve("10.0.0.7", 53, "UDP"))
                udp_answer = u.recv(4096)
                u.close()
                p.on_update([])
                closed = (len(p.rules), p.rules.resolve("10.0.0.5", 80))
                # A closed portal answers nothing: the connect is refused,
                # or (a listener closed under its accept thread) accepted
                # and closed with no backend.
                try:
                    closed += (_roundtrip(web),)
                except OSError:
                    closed += (b"",)
            finally:
                p.stop()
            seen[pkg.name] = (answers, len(sticky), retried, udp_answer, closed)
    finally:
        stop.set()
        udp.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][:3] == [b"A:x0", b"B:x1", b"C:x2"]


class _Recorder:
    """Stands in for `portal._ip`: records each `ip` command and answers
    as `ip addr add` would, an address named in `existing` already being
    there. Nothing reaches the machine's network stack."""

    def __init__(self, existing=()):
        self.calls = []
        self.existing = set(existing)

    def __call__(self, *args):
        self.calls.append(args)
        if args[:2] == ("addr", "add") and args[2].split("/")[0] in self.existing:
            return subprocess.CompletedProcess(["ip", *args], 2, "",
                                               "RTNETLINK answers: File exists")
        return subprocess.CompletedProcess(["ip", *args], 0, "", "")


def test_loopback_portals_commands_match_jax(monkeypatch):
    seen = {}
    for pkg in BOTH:
        rec = _Recorder(existing={"10.0.0.9"})
        monkeypatch.setattr(pkg.portal, "_ip", rec)
        monkeypatch.setattr(pkg.portal.LoopbackPortals, "_supported", None)
        portals = pkg.portal.LoopbackPortals
        out = [portals.supported(), portals.supported()]
        lp = portals()
        out += [lp.acquire("10.0.0.1"), lp.acquire("10.0.0.1"), lp.acquire("10.0.0.9"),
                lp.acquire("10.0.0.2")]
        lp.release("10.0.0.1")
        lp.release("10.0.0.1")
        lp.release("10.0.0.9")
        lp.release_all()
        seen[pkg.name] = (out, rec.calls)
    assert seen["port"] == seen["jax"]
    assert ("addr", "del", "10.0.0.9/32", "dev", "lo") not in seen["port"][1]


def test_real_portal_proxier_commands_match_jax(monkeypatch, backends):
    """A real-portal proxier whose addresses the recorder only pretends
    to install: the VIP bind fails, the address is released, and the
    portal falls back to an ephemeral listener behind the rule table, in
    both packages alike."""
    eps = [("127.0.0.1", b.server_address[1]) for b in backends]
    seen = {}
    for pkg in BOTH:
        rec = _Recorder()
        monkeypatch.setattr(pkg.portal, "_ip", rec)
        monkeypatch.setattr(pkg.portal.LoopbackPortals, "_supported", None)
        p = pkg.proxier.Proxier(real_portals=True)
        try:
            p.on_update([_typed(pkg, "Service", _service_wire(
                "web", "10.254.77.1", [{"name": "", "port": 80}]))])
            p.lb.on_update([_typed(pkg, "Endpoints", _endpoints_wire("web", eps))])
            answer = _roundtrip(p.rules.resolve("10.254.77.1", 80))
            portals = _portals(p, p.rules)
        finally:
            p.stop()
        seen[pkg.name] = (p.has_real_portals, portals, answer, rec.calls)
    assert seen["port"] == seen["jax"]


def test_proxy_server_follows_the_apiserver_like_jax(backends):
    eps = [("127.0.0.1", b.server_address[1]) for b in backends]
    seen = {}
    for pkg in BOTH:
        api = pkg.api.APIServer()
        client = pkg.rest.Client(pkg.rest.LocalTransport(api))
        client.create("services", _service_wire("web", "", [{"name": "", "port": 80}]),
                      namespace="default")
        ip = client.get_wire("services", "web", namespace="default")["spec"]["clusterIP"] \
            if hasattr(client, "get_wire") else client.get("services", "web").spec.cluster_ip
        client.create("endpoints", _endpoints_wire("web", eps[:2]), namespace="default")
        server = pkg.config.ProxyServer(client).start()
        try:
            deadline = time.monotonic() + 10
            while server.resolve_portal(ip, 80) is None and time.monotonic() < deadline:
                time.sleep(0.02)
            first = [_roundtrip(server.resolve_portal(ip, 80))[:2] for _ in range(4)]
            wire = _endpoints_wire("web", eps[2:])
            wire["metadata"]["resourceVersion"] = client.get_wire(
                "endpoints", "web", namespace="default")["metadata"]["resourceVersion"] \
                if hasattr(client, "get_wire") else client.get(
                    "endpoints", "web").metadata.resource_version
            client.update("endpoints", wire, namespace="default")
            while (server.lb.endpoints_for(("default", "web", "")) != [f"127.0.0.1:{eps[2][1]}"]
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            after = [_roundtrip(server.resolve_portal(ip, 80))[:2] for _ in range(3)]
            client.delete("services", "web", namespace="default")
            while server.resolve_portal(ip, 80) is not None and time.monotonic() < deadline:
                time.sleep(0.02)
            gone = server.resolve_portal(ip, 80)
        finally:
            server.stop()
        seen[pkg.name] = (ip, first, after, gone)
    assert seen["port"][1:] == seen["jax"][1:]
    assert seen["port"][1:] == ([b"A:", b"B:", b"A:", b"B:"], [b"C:"] * 3, None)


class _AnswerAtEOF(socketserver.BaseRequestHandler):
    """Reads the whole request (to the client's half-close), then answers
    and closes, as a request-to-EOF protocol does."""

    def handle(self):
        data = b""
        while True:
            chunk = self.request.recv(4096)
            if not chunk:
                break
            data += chunk
        self.request.sendall(b"got " + data)


@pytest.mark.parametrize("size", [1, 3000, 200_000])
def test_portal_keeps_the_reply_after_the_client_half_closes(size):
    """A client that half-closes after its request still gets the whole
    reply: each direction of the port's copy loop only half-closes, and
    the sockets close once both are done (the reference's copyBytes; a
    departure from JAX's loop, which closes both sockets as soon as the
    client's side ends, before the backend has answered)."""
    srv = _Echo(("127.0.0.1", 0), _AnswerAtEOF)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    payload = bytes(random.Random(size).randrange(256) for _ in range(size))
    p = PORT.proxier.Proxier()
    try:
        p.on_update([_typed(PORT, "Service", _service_wire(
            "eof", "10.0.0.9", [{"name": "", "port": 80}]))])
        p.lb.on_update([_typed(PORT, "Endpoints", _endpoints_wire(
            "eof", [("127.0.0.1", srv.server_address[1])]))])
        for _ in range(3):
            with socket.create_connection(p.rules.resolve("10.0.0.9", 80), timeout=10) as s:
                s.sendall(payload)
                s.shutdown(socket.SHUT_WR)
                got = b""
                while True:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    got += chunk
            assert got == b"got " + payload
    finally:
        p.stop()
        srv.shutdown()
        srv.server_close()
