"""The port's cluster addons against the JAX package's.

- DNS: the wire codec (`parse_query`, `build_response`) on seeded
  queries and malformed packets, byte for byte; twin `ClusterDNS`
  servers over twin apiservers holding the same seeded services answer
  the same queries (A, AAAA, MX; full and short names, any case, a
  trailing dot, unknown names) byte for byte except the id, before and
  after service churn; `publish` stores the same kube-dns Service and
  Endpoints, the bound port aside, and twice in a row; the monitor's
  `publish` stores the same monitoring-heapster pair, and a second call
  is refused alike (the allocator refuses the granted cluster IP).
- Monitoring: twin `ClusterMonitor`s scrape the same seeded kubelet
  stats (urlopen replaced) at the same instants and serve the same
  model views, on every path and over HTTP, through pod deletes,
  tombstones and rebirths.
- Logging: twin `ClusterLogAggregator`s over the same pods and the same
  seeded log texts (growing, rotated, an unterminated last line, a
  kubelet that does not serve logs yet, a deleted pod) ingest the same
  lines and answer the same searches.
- The runner: `python -m kubernetes_tpu_torch.addons` has JAX's flags.
"""

import itertools
import json
import socket
import struct
import time
import types
import urllib.request

import numpy as np
import pytest

from kubernetes_tpu.addons import __main__ as jax_main
from kubernetes_tpu.addons import dns as jax_dns
from kubernetes_tpu.addons import logging as jax_logging
from kubernetes_tpu.addons import monitoring as jax_monitoring
from kubernetes_tpu.client import rest as jax_rest
from kubernetes_tpu.models import objects as jax_objects
from kubernetes_tpu.server import api as jax_api

from kubernetes_tpu_torch.addons import __main__ as port_main
from kubernetes_tpu_torch.addons import dns as port_dns
from kubernetes_tpu_torch.addons import logging as port_logging
from kubernetes_tpu_torch.addons import monitoring as port_monitoring
from kubernetes_tpu_torch.client import rest as port_rest
from kubernetes_tpu_torch.models import apiobjects as port_apiobjects
from kubernetes_tpu_torch.models import objects as port_objects
from kubernetes_tpu_torch.server import api as port_api

STAMP = "2026-01-01T00:00:00Z"

JAX = types.SimpleNamespace(name="jax", rest=jax_rest, api_mod=jax_api, obj_mods=(jax_objects,),
                            dns=jax_dns, monitoring=jax_monitoring, logging=jax_logging)
PORT = types.SimpleNamespace(name="port", rest=port_rest, api_mod=port_api,
                             obj_mods=(port_objects, port_apiobjects), dns=port_dns,
                             monitoring=port_monitoring, logging=port_logging)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def same_uids_and_stamps(monkeypatch):
    for pkg in BOTH:
        counter = itertools.count(1)

        def uid(c=counter):
            return f"00000000-0000-4000-8000-{next(c):012d}"

        for mod in (pkg.api_mod, *pkg.obj_mods):
            monkeypatch.setattr(mod, "new_uid", uid)
            monkeypatch.setattr(mod, "now_iso", lambda: STAMP)


class Twin:
    def __init__(self):
        self.side = {}
        for pkg in BOTH:
            api = pkg.api_mod.APIServer()
            self.side[pkg.name] = types.SimpleNamespace(
                pkg=pkg, api=api, client=pkg.rest.Client(pkg.rest.LocalTransport(api)))

    def each(self, fn):
        return {name: fn(s.pkg, s) for name, s in self.side.items()}

    def same(self, fn):
        got = self.each(fn)
        assert got["port"] == got["jax"]
        return got["port"]

    def create(self, resource, ns, obj):
        for s in self.side.values():
            s.api.create(resource, ns, json.loads(json.dumps(obj)))

    def call(self, method, *args):
        for s in self.side.values():
            getattr(s.api, method)(*json.loads(json.dumps(args)))


def prime(*informers):
    for inf in informers:
        inf.reflector._list()


# -- DNS ----------------------------------------------------------------------


def encode_query(txid, flags, name, qtype=1, qclass=1, qdcount=1):
    qname = b"".join(bytes([len(p)]) + p.encode() for p in name.strip(".").split(".") if p)
    return (struct.pack(">HHHHHH", txid, flags, qdcount, 0, 0, 0) + qname + b"\x00"
            + struct.pack(">HH", qtype, qclass))


def seeded_packets(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(40):
        labels = [("abcdefgh"[int(rng.integers(0, 8))] * int(rng.integers(1, 6)))
                  for _ in range(int(rng.integers(1, 6)))]
        name = ".".join(labels)
        out.append(encode_query(int(rng.integers(0, 65536)),
                                int(rng.choice([0, 0x0100, 0x0110, 0x7FFF])), name,
                                int(rng.choice([1, 28, 15, 255])), int(rng.choice([1, 1, 3])),
                                int(rng.choice([1, 1, 0, 2]))))
    good = out[0]
    out += [good[:11], good[:12], good[:-3], good[:12] + b"\x40" + good[13:],
            good[:12] + b"\x05ab", b"", bytes(range(40))]
    return out


@pytest.mark.parametrize("seed", range(6))
def test_wire_codec_byte_for_byte(seed):
    rng = np.random.default_rng(100 + seed)
    for packet in seeded_packets(seed):
        parsed = port_dns.parse_query(packet)
        assert parsed == jax_dns.parse_query(packet)
        if parsed is None:
            continue
        txid, flags, _qname, _qtype, question = parsed
        ip = str(rng.choice(["10.0.0.10", "192.168.7.1", ""])) or None
        exists = rng.choice([None, True, False])
        ttl = int(rng.integers(0, 100))
        kw = dict(ttl=ttl, name_exists=None if exists is None else bool(exists))
        assert port_dns.build_response(txid, flags, question, ip, **kw) == \
            jax_dns.build_response(txid, flags, question, ip, **kw)


def service_wire(name, ip, ns="default"):
    return {"kind": "Service", "metadata": {"name": name, "namespace": ns},
            "spec": {"selector": {"app": name}, "ports": [{"name": "http", "port": 80}],
                     "clusterIP": ip}}


def seeded_services(seed):
    rng = np.random.default_rng(seed)
    used, out = set(), []
    for i in range(10):
        ns = str(rng.choice(["default", "kube-system", "team-a"]))
        ip = "None" if rng.integers(0, 5) == 0 else f"10.0.0.{int(rng.integers(20, 250))}"
        if ip in used:
            continue
        used.add(ip)
        out.append((f"svc{i}", ip, ns))
    return out


def ask(port, packet):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(3.0)
    try:
        s.sendto(packet, ("127.0.0.1", port))
        return s.recvfrom(512)[0]
    finally:
        s.close()


def queries(services, rng):
    names = ["nope.default.svc.cluster.local", "a.b.c.svc.cluster.local", "x", "",
             "web.default.svc.other.local"]
    for name, _ip, ns in services:
        names += [f"{name}.{ns}.svc.cluster.local", f"{name}.{ns}.svc.cluster.local.".upper(),
                  f"{name}.{ns}", f"{name}.{ns}.", f"{name}.{ns}.svc"]
    return [encode_query(int(rng.integers(0, 65536)), int(rng.choice([0, 0x0100])), n,
                         int(rng.choice([1, 1, 28, 15]))) for n in names]


def answers_of(servers, packets):
    out = {}
    for name, srv in servers.items():
        got = []
        for p in packets:
            r = ask(srv.port, p)
            assert r[:2] == p[:2]  # the id echoed
            got.append(r[2:].hex())
        out[name] = got
    return out


@pytest.fixture
def dns_twin():
    servers = {}
    yield servers
    for srv in servers.values():
        srv.stop()


@pytest.mark.parametrize("seed", range(3))
def test_twin_dns_servers_answer_byte_for_byte(seed, dns_twin):
    tw = Twin()
    services = seeded_services(seed)
    for name, ip, ns in services:
        tw.create("services", ns, service_wire(name, ip, ns))
    dns_twin.update(tw.each(lambda pkg, s: pkg.dns.ClusterDNS(s.client).start()))
    rng = np.random.default_rng(seed)
    got = answers_of(dns_twin, queries(services, np.random.default_rng(seed)))
    assert got["port"] == got["jax"]
    resolved = {name: dns_twin["port"].resolve(f"{name}.{ns}") for name, _ip, ns in services}
    assert resolved == {name: (None if ip == "None" else ip) for name, ip, ns in services}
    # Churn: a new service, a deleted one and a headless flip; both
    # tables follow their informers.
    gone = services[int(rng.integers(0, len(services)))]
    tw.create("services", "default", service_wire("fresh", "10.0.0.7"))
    tw.call("delete", "services", gone[2], gone[0])
    want_fresh, want_gone = "10.0.0.7", None
    deadline = time.monotonic() + 10
    while not all(srv.resolve("fresh.default") == want_fresh
                  and srv.resolve(f"{gone[0]}.{gone[2]}") is want_gone
                  for srv in dns_twin.values()):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    after = [s for s in services if s != gone] + [("fresh", "10.0.0.7", "default"), gone]
    got = answers_of(dns_twin, queries(after, np.random.default_rng(seed + 50)))
    assert got["port"] == got["jax"]


def test_publish_stores_kube_dns_as_jax_and_is_idempotent(dns_twin):
    tw = Twin()
    dns_twin.update(tw.each(lambda pkg, s: pkg.dns.ClusterDNS(s.client).start()))
    for _ in range(2):
        tw.each(lambda pkg, s: dns_twin[pkg.name].publish(s.client))

    def stored(pkg, s):
        svc = s.api.get("services", "default", "kube-dns")
        eps = s.api.get("endpoints", "default", "kube-dns")
        port = eps["subsets"][0]["ports"][0].pop("port")
        assert port == dns_twin[pkg.name].port
        return svc, eps

    svc, _eps = tw.same(stored)
    assert svc["spec"]["clusterIP"] == "10.0.0.10"
    tw.each(lambda pkg, s: dns_twin[pkg.name].publish(s.client, cluster_ip="10.0.0.10",
                                                      namespace="default", host="10.1.2.3"))
    tw.same(stored)


# -- monitoring --------------------------------------------------------------------


class Clock:
    """time.time for both monitors: one fixed instant, moved by the test."""

    def __init__(self):
        self.t = 1_767_225_600.0

    def module(self):
        import time as real

        return types.SimpleNamespace(time=lambda: self.t, strftime=real.strftime,
                                     gmtime=real.gmtime, monotonic=real.monotonic)


def seeded_stats(seed, pods_by_node):
    rng = np.random.default_rng(seed)
    out = {}
    for node, uids in pods_by_node.items():
        pods = {}
        for uid in uids + ["orphan-uid"]:
            pods[uid] = [{"rssBytes": int(rng.integers(0, 1 << 30)),
                          "restartCount": int(rng.integers(0, 4)),
                          "uptimeSeconds": int(rng.integers(0, 1000))}
                         for _ in range(int(rng.integers(1, 4)))]
        out[node] = {"pods": pods, "disk": {"usedFraction": float(rng.random())}}
    return out


class FakeResponse:
    def __init__(self, body):
        self.body = body

    def read(self):
        return self.body

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


MODEL_PATHS = ("/healthz", "/", "/api/v1/model/nodes", "/api/v1/model/nodes/n0",
               "/api/v1/model/nodes/n0/metrics", "/api/v1/model/nodes/n0/metrics/pods",
               "/api/v1/model/nodes/n1/metrics/memory_rss_bytes",
               "/api/v1/model/nodes/n0/metrics/nope", "/api/v1/model/nodes/ghost/metrics/pods",
               "/api/v1/model/namespaces/default/pods", "/api/v1/model/namespaces/other/pods",
               "/api/v1/model/namespaces/default/pods/p0/metrics",
               "/api/v1/model/namespaces/default/pods/p0/metrics/restarts",
               "/api/v1/model/namespaces/default/pods/p1/metrics/uptime_seconds",
               "/api/v1/model/namespaces/default/pods/ghost/metrics/restarts",
               "/api/v1/model/bogus")


def pod_wire(name, node, ns="default", phase="Running", containers=("c",)):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": ns},
            "spec": {"nodeName": node, "containers": [{"name": c, "image": "x"}
                                                      for c in containers]},
            "status": {"phase": phase}}


@pytest.mark.parametrize("seed", range(3))
def test_monitor_views_as_jax(seed, monkeypatch):
    tw = Twin()
    for n in ("n0", "n1"):
        tw.create("nodes", "", {"kind": "Node", "metadata": {"name": n}})
    for i in range(4):
        tw.create("pods", "default", pod_wire(f"p{i}", f"n{i % 2}"))
    clock = Clock()
    mons = tw.each(lambda pkg, s: pkg.monitoring.ClusterMonitor(
        s.client, "http://apiserver.invalid", resolution=1.0, window=5.0))
    for pkg in BOTH:
        monkeypatch.setattr(pkg.monitoring, "time", clock.module())
    stats = {}
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=None: FakeResponse(
        json.dumps(stats[url.split("/nodes/")[1].split("/")[0]]).encode()))
    try:
        tw.each(lambda pkg, s: prime(mons[pkg.name].nodes, mons[pkg.name].pods))
        uids = tw.same(lambda pkg, s: {p["metadata"]["name"]: p["metadata"]["uid"]
                                       for p in s.api.list("pods", "default")["items"]})
        by_node = {"n0": [uids["p0"], uids["p2"]], "n1": [uids["p1"], uids["p3"]]}
        views = lambda: tw.same(lambda pkg, s: [mons[pkg.name]._serve(p)  # noqa: E731
                                                for p in MODEL_PATHS])
        for rnd in range(8):
            stats.update(seeded_stats(seed * 100 + rnd, by_node))
            for node in ("n0", "n1"):
                tw.each(lambda pkg, s: mons[pkg.name]._scrape_node(node))
            clock.t += 1.0
            if rnd == 3:
                # p0 deleted: its series pruned and tombstoned; a scrape
                # still naming it within two resolutions is dropped.
                tw.each(lambda pkg, s: mons[pkg.name]._prune("pod", "default/p0"))
            if rnd == 6:
                clock.t += 5.0  # past the tombstone: p0's series is reborn
            views()
        out = views()
        assert out[2] == (200, {"items": ["n0", "n1"]})
        assert len(out[5][1]["metrics"]) == 5  # the window's ring
        # The HTTP view serves the same bodies.
        for m in mons.values():
            __import__("threading").Thread(target=m.httpd.serve_forever,
                                           kwargs={"poll_interval": 0.05}, daemon=True).start()
        for path in MODEL_PATHS[:6]:
            bodies = {}
            for name, m in mons.items():
                try:
                    with urllib.request.build_opener().open(
                            f"http://127.0.0.1:{m.port}{path}", timeout=5) as r:
                        bodies[name] = (r.status, r.read())
                except urllib.error.HTTPError as e:
                    bodies[name] = (e.code, e.read())
            assert bodies["port"] == bodies["jax"], path
    finally:
        for m in mons.values():
            m.httpd.shutdown()
            m.httpd.server_close()


def test_monitor_publish_as_jax():
    tw = Twin()
    mons = tw.each(lambda pkg, s: pkg.monitoring.ClusterMonitor(s.client, "http://x"))
    try:
        tw.each(lambda pkg, s: mons[pkg.name].publish(s.client))

        def again(pkg, s):
            # The second create asks for the granted cluster IP again,
            # which the allocator refuses before the name's conflict.
            try:
                mons[pkg.name].publish(s.client)
            except Exception as e:
                return type(e).__name__, e.code
            return None

        assert tw.same(again) == ("APIError", 422)

        def stored(pkg, s):
            eps = s.api.get("endpoints", "kube-system", "monitoring-heapster")
            assert eps["subsets"][0]["ports"][0].pop("port") == mons[pkg.name].port
            return s.api.get("services", "kube-system", "monitoring-heapster"), eps

        tw.same(stored)
    finally:
        for m in mons.values():
            m.httpd.server_close()


# -- logging -----------------------------------------------------------------------


class LogClient:
    """A client whose pod_logs answers from `texts`, keyed (ns, pod,
    container); a missing key is a kubelet that does not serve yet."""

    def __init__(self, client, texts, error):
        self.client, self.texts, self.error = client, texts, error

    def __getattr__(self, name):
        return getattr(self.client, name)

    def pod_logs(self, name, namespace="default", container="", tail=None):
        key = (namespace, name, container)
        if key not in self.texts:
            raise self.error(502, "BadGateway", "kubelet log fetch failed")
        return self.texts[key]


@pytest.mark.parametrize("seed", range(4))
def test_log_aggregator_ingests_and_searches_as_jax(seed):
    rng = np.random.default_rng(seed)
    tw = Twin()
    pods = [("default", "web-0", ("app", "side")), ("default", "web-1", ("app",)),
            ("team", "db-0", ("db",)), ("team", "pending", ("db",))]
    for ns, name, containers in pods:
        tw.create("pods", ns, pod_wire(name, "" if name == "pending" else "n0", ns=ns,
                                       phase="Pending" if name == "pending" else "Running",
                                       containers=containers))
    texts = {}
    aggs = tw.each(lambda pkg, s: pkg.logging.ClusterLogAggregator(
        LogClient(s.client, texts, pkg.rest.APIError), capacity=50))
    words = ["alpha", "beta", "error: disk", "gamma", "warn"]

    def sweep():
        tw.each(lambda pkg, s: prime(aggs[pkg.name].pods))
        return tw.same(lambda pkg, s: aggs[pkg.name].collect_once())

    def searches():
        return tw.same(lambda pkg, s: [
            [(e.namespace, e.pod, e.container, e.line) for e in aggs[pkg.name].search(*q)]
            for q in (("",), ("error",), ("a", "team"), ("", None, "web-0"), ("", None, None, 3))])

    for rnd in range(6):
        for ns, name, containers in pods:
            for c in containers:
                key = (ns, name, c)
                if rng.integers(0, 4) == 0:
                    continue  # this container's kubelet does not answer this round
                lines = texts.get(key, "").splitlines(keepends=True)
                if rng.integers(0, 6) == 0:
                    lines = []  # rotated
                lines += [f"{words[int(rng.integers(0, 5))]} {rnd}\n"
                          for _ in range(int(rng.integers(0, 5)))]
                text = "".join(lines)
                if rng.integers(0, 3) == 0:
                    text += "partial"  # an unterminated last line
                texts[key] = text
        sweep()
        searches()
        if rnd == 3:
            tw.call("delete", "pods", "default", "web-1")
    assert searches()[0]


# -- the runner ---------------------------------------------------------------


def test_addon_runner_flags_are_jax_flags(monkeypatch, capsys):
    import argparse

    parsers = {}
    for name, mod in (("jax", jax_main), ("port", port_main)):
        def grab(self, argv=None, _name=name):
            parsers[_name] = sorted((a.dest, tuple(a.option_strings), a.default, a.type)
                                    for a in self._actions if a.dest != "help")
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            mod.main([])
    assert parsers["port"] == parsers["jax"]
    monkeypatch.undo()
    with pytest.raises(SystemExit) as e:
        port_main.main(["--server", "http://127.0.0.1:1"])
    assert e.value.code == 2 and "nothing to run" in capsys.readouterr().err
