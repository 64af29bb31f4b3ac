"""Userspace service proxier.

Reference: pkg/proxy/proxier.go — Proxier.OnUpdate (:264-321) diffs the
desired service list against running portals, opens a listener socket
per service port (addServiceOnPort :222), installs portal redirect
rules (openPortal :376), and shuttles bytes between accepted client
connections and a load-balanced backend endpoint
(pkg/proxy/proxysocket.go TCP copy loop, udp_server.go).

The listener sockets and the copy loop here are real; only the DNAT
hop is the in-memory PortalRuleTable (see ruletable.py).

The port's copy of `kubernetes_tpu/proxy/proxier.py`. One departure: a
TCP connection's two copy directions end as the reference's do
(proxysocket.go proxyTCP/copyBytes): each half-closes (the source's read
side, the destination's write side), and the sockets are closed once,
after both directions have ended. JAX's copy loop shuts down and closes
both sockets in whichever direction ends first, while the other may be
inside a call on the same descriptor; once closed, the descriptor's
number goes to the next accepted connection, which that call can then
shut down before it is answered.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.proxy.roundrobin import (
    ErrMissingEndpoints,
    ErrMissingServiceEntry,
    LoadBalancerRR,
    ServicePortName,
)
from kubernetes_tpu_torch.proxy.ruletable import PortalRule, PortalRuleTable

_BUFSIZE = 65536
_UDP_IDLE_TIMEOUT = 10.0


@dataclass
class ServiceInfo:
    """One proxied service port (reference: proxier.go serviceInfo)."""

    portal_ip: str
    portal_port: int
    protocol: str
    proxy_port: int
    socket: object
    session_affinity: str = "None"
    node_port: int = 0
    is_alive: bool = True
    real: bool = False  # listener bound at the VIP itself (portal.py)
    node_socket: object = None  # extra listener at the node port itself
    threads: List[threading.Thread] = field(default_factory=list)


class Proxier:
    """Owns one listener socket per (service, port)."""

    def __init__(
        self,
        load_balancer: Optional[LoadBalancerRR] = None,
        rule_table: Optional[PortalRuleTable] = None,
        listen_ip: str = "127.0.0.1",
        real_portals: bool = False,
    ):
        # `is None` checks: an empty PortalRuleTable is falsy (__len__).
        self.lb = load_balancer if load_balancer is not None else LoadBalancerRR()
        self.rules = rule_table if rule_table is not None else PortalRuleTable()
        self.listen_ip = listen_ip
        # Real portals (portal.py): install each service VIP on lo and
        # bind the listener AT clusterIP:port, so clients dial the VIP
        # directly (the openPortal/iptables analog made literal).
        # Per-service fallback to the ephemeral-listener + rule-table
        # mode when the address can't be installed or bound.
        self._portals = None
        if real_portals:
            from kubernetes_tpu_torch.proxy.portal import LoopbackPortals

            if LoopbackPortals.supported():
                self._portals = LoopbackPortals()
        self._lock = threading.Lock()
        self._services: Dict[ServicePortName, ServiceInfo] = {}
        self._stopped = False

    # -- lifecycle ----------------------------------------------------

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            infos = list(self._services.items())
            self._services.clear()
        for name, info in infos:
            self._close_service(name, info)
        if self._portals is not None:
            self._portals.release_all()

    # -- desired state ------------------------------------------------

    def on_update(self, services: List) -> None:
        """Reconcile running portals against the full service list
        (reference: Proxier.OnUpdate, proxier.go:264-321)."""
        active: Dict[ServicePortName, object] = {}
        for svc in services:
            if not svc.spec.cluster_ip or svc.spec.cluster_ip == "None":
                continue  # headless: no portal
            ns = svc.metadata.namespace or "default"
            for port in svc.spec.ports:
                name: ServicePortName = (ns, svc.metadata.name, port.name)
                active[name] = (svc, port)
        with self._lock:
            if self._stopped:
                return
            to_close = {
                name: info
                for name, info in self._services.items()
                if name not in active
            }
            for name in to_close:
                del self._services[name]
        for name, info in to_close.items():
            self._close_service(name, info, drop_lb=True)
        for name, (svc, port) in active.items():
            self._ensure_service(name, svc, port)

    def service_info(self, name: ServicePortName) -> Optional[ServiceInfo]:
        with self._lock:
            return self._services.get(name)

    def _ensure_service(self, name: ServicePortName, svc, port) -> None:
        # The whole create/reconfigure path runs under the lock:
        # check-then-act with the lock released in between let two
        # threads (informer handler + ProxyServer.start priming) both
        # open a listener for the same service, leaking the loser's
        # socket and accept thread. Creation is
        # rare and cheap (local bind); the data path doesn't take this
        # lock.
        with self._lock:
            self._ensure_service_locked(name, svc, port)

    def _ensure_service_locked(self, name: ServicePortName, svc, port) -> None:
        if self._stopped:
            # stop() may have run between on_update's check and this
            # acquisition; creating a portal now would leak its socket
            # and accept thread past shutdown.
            return
        info = self._services.get(name)
        if info is not None:
            if (
                info.portal_ip == svc.spec.cluster_ip
                and info.portal_port == port.port
                and info.protocol == port.protocol.upper()
                and info.session_affinity == (svc.spec.session_affinity or "None")
                and info.node_port == getattr(port, "node_port", 0)
            ):
                # Unchanged spec — but a node-port bind that lost its
                # port to a squatter retries on every sync, so the
                # degradation heals once the port frees up.
                if info.node_port and info.node_socket is None:
                    try:
                        info.node_socket = self._open_socket(
                            info.protocol, self.listen_ip, info.node_port
                        )
                    except OSError:
                        return
                    serve = (
                        self._tcp_accept_loop
                        if info.protocol == "TCP"
                        else self._udp_loop
                    )
                    t = threading.Thread(
                        target=serve,
                        args=(name, info, info.node_socket),
                        daemon=True,
                    )
                    info.threads.append(t)
                    t.start()
                return
            # Reconfiguration: tear down the portal but KEEP the load
            # balancer's endpoint list — endpoints didn't change, and a
            # fresh empty entry would blackhole until the next
            # endpoints event.
            self._close_service(name, info, drop_lb=False)
        proto = port.protocol.upper()
        sock, real = self._open_portal_socket(
            proto, svc.spec.cluster_ip, port.port
        )
        proxy_ip = svc.spec.cluster_ip if real else self.listen_ip
        proxy_port = sock.getsockname()[1]
        info = ServiceInfo(
            portal_ip=svc.spec.cluster_ip,
            portal_port=port.port,
            protocol=proto,
            proxy_port=proxy_port,
            socket=sock,
            session_affinity=svc.spec.session_affinity or "None",
            node_port=getattr(port, "node_port", 0),
            real=real,
        )
        self.lb.new_service(name, affinity_type=info.session_affinity)
        self.rules.ensure_rule(
            PortalRule(
                portal_ip=info.portal_ip,
                portal_port=info.portal_port,
                protocol=proto,
                proxy_ip=proxy_ip,
                proxy_port=proxy_port,
                service=f"{name[0]}/{name[1]}:{name[2]}",
            )
        )
        # NodePort: an extra rule on the node's own address (reference
        # proxier.go openNodePort) PLUS a real listener at the node
        # port itself — the analog of the iptables redirect that makes
        # nodeAddr:nodePort actually accept traffic. Bind failure
        # (port squatted) degrades to the rule-only entry.
        if info.node_port:
            self.rules.ensure_rule(
                PortalRule(
                    portal_ip="0.0.0.0",
                    portal_port=info.node_port,
                    protocol=proto,
                    # Must point where the listener actually is — with
                    # a real portal that is the VIP itself.
                    proxy_ip=proxy_ip,
                    proxy_port=proxy_port,
                    service=f"{name[0]}/{name[1]}:{name[2]}",
                )
            )
            try:
                info.node_socket = self._open_socket(
                    proto, self.listen_ip, info.node_port
                )
            except OSError:
                info.node_socket = None
        serve = self._tcp_accept_loop if proto == "TCP" else self._udp_loop
        socks = [sock] + ([info.node_socket] if info.node_socket else [])
        for s in socks:
            accept = threading.Thread(
                target=serve, args=(name, info, s), daemon=True
            )
            info.threads.append(accept)
        self._services[name] = info
        for t in info.threads:
            t.start()

    @property
    def has_real_portals(self) -> bool:
        """Whether VIP-bound portals are available in this proxier."""
        return self._portals is not None

    def _open_socket(self, proto: str, ip: str = "", port: int = 0):
        kind = socket.SOCK_STREAM if proto == "TCP" else socket.SOCK_DGRAM
        sock = socket.socket(socket.AF_INET, kind)
        # No SO_REUSEADDR on fixed-port UDP binds: two REUSEADDR UDP
        # sockets can both bind the same addr:port with datagrams going
        # to only one of them — the bind must FAIL (degrade to the
        # rule-table entry) rather than silently steal or lose traffic.
        if not (kind == socket.SOCK_DGRAM and port):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind((ip or self.listen_ip, port))
            if proto == "TCP":
                sock.listen(64)
        except OSError:
            sock.close()
            raise
        return sock

    def _open_portal_socket(self, proto: str, cluster_ip: str, port: int):
        """(socket, real): bind AT the VIP when real portals are on and
        the address can be installed; otherwise the classic ephemeral
        listener on listen_ip with the rule table carrying the DNAT."""
        if self._portals is not None and self._portals.acquire(cluster_ip):
            try:
                return self._open_socket(proto, cluster_ip, port), True
            except OSError:
                self._portals.release(cluster_ip)
        return self._open_socket(proto), False

    def _close_service(
        self, name: ServicePortName, info: ServiceInfo, drop_lb: bool = True
    ) -> None:
        info.is_alive = False
        self.rules.delete_rule(info.portal_ip, info.portal_port, info.protocol)
        if info.node_port:
            self.rules.delete_rule("0.0.0.0", info.node_port, info.protocol)
        if drop_lb:
            self.lb.delete_service(name)
        for s in (info.socket, info.node_socket):
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass
        if info.real and self._portals is not None:
            self._portals.release(info.portal_ip)

    # -- TCP path (reference: proxysocket.go ProxyLoop + proxyTCP) ----

    def _tcp_accept_loop(
        self, name: ServicePortName, info: ServiceInfo, sock=None
    ) -> None:
        sock = sock if sock is not None else info.socket
        while info.is_alive:
            try:
                client, addr = sock.accept()
            except OSError:
                return
            # Backend dialing happens on a per-connection thread: the
            # up-to-2s endpoint wait must never head-of-line block the
            # accept loop (10 clients arriving during an endpoint gap
            # would otherwise serialize ~2s each behind one accept).
            threading.Thread(
                target=self._serve_connection,
                args=(name, info, client, addr),
                daemon=True,
            ).start()

    def _serve_connection(
        self, name: ServicePortName, info: ServiceInfo, client, addr
    ) -> None:
        try:
            backend = self._connect_backend_wait(name, info, addr[0])
        except (ErrMissingServiceEntry, ErrMissingEndpoints, OSError):
            client.close()
            return
        replies = threading.Thread(
            target=self._copy_bytes, args=(backend, client), daemon=True
        )
        replies.start()
        self._copy_bytes(client, backend)
        replies.join()
        # Closed only here, after both directions: no call of either
        # copy can reach a descriptor number already handed on.
        for s in (client, backend):
            try:
                s.close()
            except OSError:
                pass

    def _connect_backend_wait(
        self,
        name: ServicePortName,
        info: ServiceInfo,
        client_ip: str,
        wait: float = 2.0,
    ):
        """_connect_backend, waiting out brief backend gaps: endpoints
        repopulate milliseconds after a readiness flap, and a freshly
        started pod's server may bind a beat after its endpoint is
        published — in both windows dropping an accepted connection
        loses requests a client already queued behind a successful
        portal connect. The reference's tryConnect similarly retries
        dialing with backoff instead of failing the session on the
        first error (proxysocket.go endpointDialTimeout ladder)."""
        deadline = time.monotonic() + wait
        while True:
            try:
                return self._connect_backend(name, client_ip)
            except (ErrMissingServiceEntry, ErrMissingEndpoints, OSError):
                if time.monotonic() >= deadline or not info.is_alive:
                    raise
                time.sleep(0.05)

    def _connect_backend(self, name: ServicePortName, client_ip: str):
        # Retry across endpoints like the reference's tryConnect
        # (proxysocket.go): a dead backend shouldn't fail the session
        # while others remain.
        last_err: Optional[Exception] = None
        for _ in range(max(1, len(self.lb.endpoints_for(name)))):
            endpoint = self.lb.next_endpoint(name, client_ip)
            host, _, port = endpoint.rpartition(":")
            try:
                return socket.create_connection((host, int(port)), timeout=5)
            except OSError as e:
                last_err = e
                # A sticky (ClientIP-affinity) client would otherwise
                # get the same dead endpoint back on every retry.
                self.lb.invalidate_affinity(name, client_ip)
        raise last_err if last_err else OSError("no endpoints")

    @staticmethod
    def _copy_bytes(src, dst) -> None:
        """One direction of a connection until `src` ends or fails, then
        its half-close (reference copyBytes: dest.CloseWrite,
        src.CloseRead), which also wakes the other direction when the
        peer has gone. The caller closes the sockets."""
        try:
            while True:
                data = src.recv(_BUFSIZE)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s, how in ((dst, socket.SHUT_WR), (src, socket.SHUT_RD)):
                try:
                    s.shutdown(how)
                except OSError:
                    pass

    # -- UDP path (reference: udp_server.go / proxysocket.go UDP) -----

    def _udp_loop(
        self, name: ServicePortName, info: ServiceInfo, sock=None
    ) -> None:
        # client addr -> backend socket: UDP "sessions" keyed on the
        # 5-tuple, as the reference's activeClients map does. `sock` is
        # the ingress socket this loop serves (portal or node port);
        # replies must leave through the same one.
        sock = sock if sock is not None else info.socket
        sessions: Dict[Tuple[str, int], socket.socket] = {}

        def reply_loop(client_addr, backend_sock):
            backend_sock.settimeout(_UDP_IDLE_TIMEOUT)
            try:
                while info.is_alive:
                    data = backend_sock.recv(_BUFSIZE)
                    if not data:
                        break
                    sock.sendto(data, client_addr)
            except OSError:
                pass
            finally:
                sessions.pop(client_addr, None)
                try:
                    backend_sock.close()
                except OSError:
                    pass

        while info.is_alive:
            try:
                data, client_addr = sock.recvfrom(_BUFSIZE)
            except OSError:
                return
            backend_sock = sessions.get(client_addr)
            if backend_sock is None:
                try:
                    endpoint = self.lb.next_endpoint(name, client_addr[0])
                except (ErrMissingServiceEntry, ErrMissingEndpoints):
                    continue
                host, _, port = endpoint.rpartition(":")
                backend_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                backend_sock.connect((host, int(port)))
                sessions[client_addr] = backend_sock
                # Not tracked in info.threads: reply loops are
                # per-session and self-clean in their finally block.
                threading.Thread(
                    target=reply_loop, args=(client_addr, backend_sock),
                    daemon=True,
                ).start()
            try:
                backend_sock.send(data)
            except OSError:
                sessions.pop(client_addr, None)
