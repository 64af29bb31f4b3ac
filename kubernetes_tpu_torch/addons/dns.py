"""Cluster DNS addon: service discovery by name.

Reference: cluster/addons/dns — skydns fed by kube2sky watching
services, so `<service>.<namespace>.svc.<domain>` resolves to the
service's portal (cluster) IP. Here both halves live in one small UDP
server: a service Informer keeps the name table, and a minimal DNS
responder answers A queries from it (NXDOMAIN otherwise).

Accepted names (trailing dot optional):
    <service>.<namespace>.svc.<domain>     e.g. web.default.svc.cluster.local
    <service>.<namespace>                  the short form kube2sky also served

The port's copy of `kubernetes_tpu/addons/dns.py`: the same wire codec
(`parse_query`, `build_response`), name table and `publish`. Services
are decoded into the whole model (`models/apiobjects.py`); `publish`
catches the client's `APIError`. Host code: no torch, no numpy.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import Service

DEFAULT_DOMAIN = "cluster.local"

_FLAG_RESPONSE = 0x8000
_FLAG_RD = 0x0100
_FLAG_RA = 0x0080
RCODE_NXDOMAIN = 3
QTYPE_A = 1
QCLASS_IN = 1


def _decode_service(wire: dict) -> Service:
    return serde.from_wire(Service, wire)


def parse_query(data: bytes) -> Optional[Tuple[int, int, str, int, bytes]]:
    """-> (txid, flags, qname, qtype, question_bytes) or None."""
    if len(data) < 12:
        return None
    txid, flags, qdcount, _an, _ns, _ar = struct.unpack(">HHHHHH", data[:12])
    if qdcount < 1:
        return None
    labels = []
    pos = 12
    while pos < len(data):
        n = data[pos]
        if n == 0:
            pos += 1
            break
        if n > 63 or pos + 1 + n > len(data):
            return None
        labels.append(data[pos + 1 : pos + 1 + n].decode(errors="replace"))
        pos += 1 + n
    if pos + 4 > len(data):
        return None
    qtype, qclass = struct.unpack(">HH", data[pos : pos + 4])
    if qclass != QCLASS_IN:
        return None
    return txid, flags, ".".join(labels), qtype, data[12 : pos + 4]


def build_response(
    txid: int,
    flags: int,
    question: bytes,
    ip: Optional[str],
    ttl: int = 30,
    name_exists: Optional[bool] = None,
) -> bytes:
    """NXDOMAIN only when the NAME is unknown; an existing name queried
    with an unsupported qtype gets NOERROR with zero answers (resolvers
    negative-cache NXDOMAIN for the whole name, breaking the A lookup a
    dual-stack client runs in parallel)."""
    exists = name_exists if name_exists is not None else bool(ip)
    rcode = 0 if exists else RCODE_NXDOMAIN
    out_flags = _FLAG_RESPONSE | (flags & _FLAG_RD) | _FLAG_RA | rcode
    answers = 1 if ip else 0
    head = struct.pack(">HHHHHH", txid, out_flags, 1, answers, 0, 0)
    body = question
    if ip:
        # Answer: name pointer to the question at offset 12 (0xC00C),
        # TYPE A, CLASS IN, TTL, RDLENGTH 4, then the address.
        body += struct.pack(
            ">HHHIH", 0xC00C, QTYPE_A, QCLASS_IN, ttl, 4
        ) + socket.inet_aton(ip)
    return head + body


class ClusterDNS:
    """UDP DNS server over the live service table."""

    def __init__(
        self,
        client,
        domain: str = DEFAULT_DOMAIN,
        bind: str = "127.0.0.1",
        port: int = 0,
        resync_period: float = 5.0,
    ):
        self.domain = domain.strip(".")
        self.resync_period = resync_period
        self._table: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.services = Informer(
            client,
            "services",
            decode=_decode_service,
            on_add=self._upsert,
            on_update=self._upsert,
            on_delete=self._remove,
        )
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((bind, port))
        self.sock.settimeout(0.2)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.sock.getsockname()[1]

    def publish(self, client, cluster_ip: str = "10.0.0.10",
                namespace: str = "default", host: str = "127.0.0.1") -> None:
        """Register the kube-dns Service + Endpoints (the reference's
        skydns-svc.yaml pins the well-known 10.0.0.10). A real-portal
        kube-proxy then serves DNS at VIP:53/UDP for every process on
        the host. Selector-less, so the endpoints controller leaves
        the manual endpoints alone. Idempotent across restarts."""
        svc = {
            "kind": "Service",
            "apiVersion": "v1",
            "metadata": {
                "name": "kube-dns",
                "namespace": namespace,
                "labels": {"kubernetes.io/cluster-service": "true"},
            },
            "spec": {
                "clusterIP": cluster_ip,
                "ports": [{"name": "dns", "port": 53, "protocol": "UDP"}],
            },
        }
        try:
            client.get("services", "kube-dns", namespace=namespace)
        except APIError as e:
            if e.code != 404:
                raise
            client.create("services", svc, namespace=namespace)
        endpoints = {
            "kind": "Endpoints",
            "apiVersion": "v1",
            "metadata": {"name": "kube-dns", "namespace": namespace},
            "subsets": [
                {
                    # The reachable address of the host running this
                    # addon — loopback only works on single-host
                    # clusters; multi-host composition passes the
                    # master's address.
                    "addresses": [{"ip": host}],
                    "ports": [{"name": "dns", "port": self.port,
                               "protocol": "UDP"}],
                }
            ],
        }
        try:
            client.create("endpoints", endpoints, namespace=namespace)
        except APIError as e:
            if e.code != 409:
                raise
            client.update("endpoints", endpoints, namespace=namespace)

    # -- service table (the kube2sky half) ----------------------------

    def _key(self, svc: Service) -> str:
        return f"{svc.metadata.name}.{svc.metadata.namespace or 'default'}"

    def _upsert(self, svc: Service) -> None:
        ip = svc.spec.cluster_ip
        with self._lock:
            if ip and ip != "None":
                self._table[self._key(svc)] = ip
            else:
                self._table.pop(self._key(svc), None)  # headless

    def _remove(self, svc: Service) -> None:
        with self._lock:
            self._table.pop(self._key(svc), None)

    def resolve(self, qname: str) -> Optional[str]:
        name = qname.rstrip(".").lower()
        suffix = f".svc.{self.domain}"
        if name.endswith(suffix):
            name = name[: -len(suffix)]
        if name.count(".") != 1:
            return None  # must be <service>.<namespace>
        with self._lock:
            return self._table.get(name)

    # -- the skydns half ----------------------------------------------

    def start(self) -> "ClusterDNS":
        self.services.start()
        self.services.wait_for_sync()
        # Prime by full rebuild from the synced store: the reflector
        # signals sync BEFORE its ADDED callbacks drain, so relying on
        # the callbacks alone can briefly answer NXDOMAIN for
        # pre-existing services. (Event callbacks then keep the table
        # hot; the serve loop's periodic rebuild heals re-list gaps.)
        self._rebuild()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.services.stop()
        if self._thread:
            self._thread.join(timeout=2)
        self.sock.close()

    def _rebuild(self) -> None:
        """Reconcile the table against the informer store. Event
        callbacks alone are not enough: a watch drop + re-list REPLACES
        the store without firing DELETED for objects that vanished in
        the gap, and the start()-time prime races concurrent deletes —
        either would leave a deleted service resolving forever."""
        fresh: Dict[str, str] = {}
        for svc in self.services.store.list():
            ip = svc.spec.cluster_ip
            if ip and ip != "None":
                fresh[self._key(svc)] = ip
        with self._lock:
            self._table = fresh

    def _serve(self) -> None:
        import time

        last_sync = time.monotonic()
        while not self._stop.is_set():
            if time.monotonic() - last_sync > self.resync_period:
                self._rebuild()
                last_sync = time.monotonic()
            try:
                data, addr = self.sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                parsed = parse_query(data)
                if parsed is None:
                    continue
                txid, flags, qname, qtype, question = parsed
                resolved = self.resolve(qname)
                ip = resolved if qtype == QTYPE_A else None
                self.sock.sendto(
                    build_response(
                        txid, flags, question, ip,
                        name_exists=resolved is not None,
                    ),
                    addr,
                )
            except Exception:
                pass  # one bad packet must not kill the resolver
