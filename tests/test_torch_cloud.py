"""The port's cloud provider and cloud controllers against the JAX package's.

The providers are fed the same device records, made from a seed (hosts,
cards a host, kinds, platforms, coordinates), and every method must
answer alike with host names mapped `tpu-host-N` <-> `gpu-host-N`. With
no records the port's `GPUCloudProvider` reads `torch.cuda` (patched
here to a fake card machine) and raises without a card. The cloud
controllers run on twin apiservers, the JAX one under the JAX client
and the port's under the port's, driven by `sync_once` and `sync` with
their informers primed by one LIST, and the stored nodes and services
and the providers' balancers and routes must be equal after each step;
the started controllers (threads) are checked the same way, as are
`ControllerManager`'s controller list and `hyperkube controller-manager
--cloud-provider`.
"""

import itertools
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from kubernetes_tpu import cloudprovider as jax_cloud
from kubernetes_tpu.client import rest as jax_rest
from kubernetes_tpu.cloudprovider import tpu as jax_tpu
from kubernetes_tpu.controllers import cloudnodes as jax_cloudnodes
from kubernetes_tpu.controllers import manager as jax_manager
from kubernetes_tpu.controllers import routes as jax_routes
from kubernetes_tpu.controllers import servicelb as jax_servicelb
from kubernetes_tpu.models import objects as jax_objects
from kubernetes_tpu.server import api as jax_api

from kubernetes_tpu_torch import cloudprovider as port_cloud
from kubernetes_tpu_torch.client import rest as port_rest
from kubernetes_tpu_torch.cloudprovider import gpu as port_gpu
from kubernetes_tpu_torch.controllers import cloudnodes as port_cloudnodes
from kubernetes_tpu_torch.controllers import manager as port_manager
from kubernetes_tpu_torch.controllers import routes as port_routes
from kubernetes_tpu_torch.controllers import servicelb as port_servicelb
from kubernetes_tpu_torch.models import apiobjects as port_apiobjects
from kubernetes_tpu_torch.models import objects as port_objects
from kubernetes_tpu_torch.server import api as port_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMP = "2026-01-01T00:00:00Z"

JAX = types.SimpleNamespace(
    name="jax", cloud=jax_cloud, rest=jax_rest, api_mod=jax_api, obj_mods=(jax_objects,),
    cloudnodes=jax_cloudnodes, servicelb=jax_servicelb, routes=jax_routes,
    manager=jax_manager, provider=jax_tpu.TPUCloudProvider)
PORT = types.SimpleNamespace(
    name="port", cloud=port_cloud, rest=port_rest, api_mod=port_api,
    obj_mods=(port_objects, port_apiobjects), cloudnodes=port_cloudnodes,
    servicelb=port_servicelb, routes=port_routes, manager=port_manager,
    provider=port_gpu.GPUCloudProvider)
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


def to_jax_names(value):
    """The port's answer with its host names written as JAX's."""
    return json.loads(json.dumps(value).replace("gpu-host-", "tpu-host-"))


def device_records(seed):
    """Seeded device records: 1-4 hosts of 1-8 devices each, a kind, a
    platform, and coordinates on some hosts."""
    rng = np.random.default_rng(seed)
    kind = str(rng.choice(["TPU v5e", "TPU v4", "NVIDIA H100 80GB HBM3", "tpu-v5p"]))
    platform = str(rng.choice(["tpu", "gpu"]))
    hosts = [int(h) for h in rng.permutation(int(rng.integers(1, 5)))]
    out = []
    for h in hosts:
        with_coords = bool(rng.integers(0, 2))
        for i in range(int(rng.integers(1, 9))):
            out.append(types.SimpleNamespace(
                process_index=h, device_kind=kind, platform=platform,
                coords=(i, h, int(rng.integers(0, 2))) if with_coords else None))
    return out


def answers(provider):
    """Every method of a provider, and its routes after creates and deletes."""
    out = {"instances": [(i.name, i.addresses, i.instance_type, i.instance_id, i.labels,
                          i.labels_dict()) for i in provider.instances()],
           "routes": [(r.name, r.target_instance, r.destination_cidr) for r in provider.routes()],
           "clusters": provider.cluster_names()}
    names = [i.name for i in provider.instances()] + ["nope"]
    out["zones"] = [(z.failure_domain, z.region) if z else None
                    for z in (provider.zone_of(n) for n in names)]
    provider.create_route("podcidr-a", names[0], "10.244.1.0/24")
    provider.create_route("podcidr-b", names[-2], "10.244.2.0/24")
    provider.create_route("podcidr-a", names[0], "10.244.9.0/24")
    provider.delete_route("podcidr-b")
    provider.delete_route("missing")
    out["managed"] = [(r.name, r.target_instance, r.destination_cidr) for r in provider.routes()]
    lb = provider.load_balancer()
    out["lb"] = [lb.ensure("web", names[:-1]), lb.address("web"), dict(lb.balancers)]
    lb.update_hosts("web", names[:1])
    lb.update_hosts("ghost", names)
    out["lb"].append(dict(lb.balancers))
    lb.delete("web")
    out["lb"].append(dict(lb.balancers))
    return out


# -- the providers ------------------------------------------------------------


def test_registry_as_jax():
    for name in ("fake",):
        assert type(port_cloud.get_provider(name)).__name__ == type(
            jax_cloud.get_provider(name)).__name__
    with pytest.raises(KeyError) as port_err:
        port_cloud.get_provider("no-such-cloud")
    with pytest.raises(KeyError) as jax_err:
        jax_cloud.get_provider("no-such-cloud")
    head = "cloud provider 'no-such-cloud' not registered (have: "
    assert str(port_err.value).startswith('"' + head) and str(jax_err.value).startswith(
        '"' + head)
    # `tpu` is not registered in the port: the card machine's provider is `gpu`.
    with pytest.raises(KeyError, match="'tpu' not registered"):
        port_cloud.get_provider("tpu")
    port_cloud.register_provider("custom-port", lambda: port_cloud.FakeCloudProvider())
    assert isinstance(port_cloud.get_provider("custom-port"), port_cloud.FakeCloudProvider)


@pytest.mark.parametrize("seed", range(12))
def test_providers_answer_alike_on_the_same_records(seed):
    jax_answers = answers(jax_tpu.TPUCloudProvider(devices=device_records(seed),
                                                   slice_name=f"slice-{seed}"))
    port_answers = answers(port_gpu.GPUCloudProvider(devices=device_records(seed),
                                                     slice_name=f"slice-{seed}"))
    assert to_jax_names(port_answers) == json.loads(json.dumps(jax_answers))


def test_label_keys_are_jax_keys():
    for key in ("LABEL_PLATFORM", "LABEL_CHIP", "LABEL_CHIPS", "LABEL_HOST", "LABEL_COORDS"):
        assert getattr(port_gpu, key) == getattr(jax_tpu, key)
    for key in ("LABEL_INSTANCE_TYPE", "LABEL_ZONE", "LABEL_REGION", "LABEL_MANAGED"):
        assert getattr(port_cloudnodes, key) == getattr(jax_cloudnodes, key)


@pytest.fixture
def fake_cards(monkeypatch):
    """torch.cuda patched to a machine of two named cards."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")


def test_gpu_provider_inventories_the_cards(fake_cards):
    provider = port_gpu.GPUCloudProvider()
    assert [(d.process_index, d.device_kind, d.platform, d.coords) for d in provider.devices] == [
        (0, "NVIDIA H100 80GB HBM3", "gpu", None)] * 2
    (inst,) = provider.instances()
    assert inst.name == "gpu-host-0" and inst.addresses == ("127.0.0.1",)
    assert inst.instance_type == "gpu-2x-NVIDIA-H100-80GB-HBM3"
    assert inst.labels_dict() == {port_gpu.LABEL_PLATFORM: "gpu",
                                  port_gpu.LABEL_CHIP: "NVIDIA-H100-80GB-HBM3",
                                  port_gpu.LABEL_CHIPS: "2", port_gpu.LABEL_HOST: "0"}
    assert provider.routes() == [] and provider.cluster_names() == ["slice-0"]
    assert isinstance(port_cloud.get_provider("gpu"), port_gpu.GPUCloudProvider)


def test_gpu_provider_raises_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_gpu.GPUCloudProvider()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_cloud.get_provider("gpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_gpu.GPUCloudProvider()


# -- twin apiservers ----------------------------------------------------------


class Twin:
    def __init__(self):
        self.side = {}
        for pkg in BOTH:
            api = pkg.api_mod.APIServer()
            self.side[pkg.name] = types.SimpleNamespace(
                pkg=pkg, api=api, client=pkg.rest.Client(pkg.rest.LocalTransport(api)))

    def each(self, fn):
        return {name: fn(s.pkg, s) for name, s in self.side.items()}

    def same(self, fn, map_names=False):
        got = self.each(fn)
        port = to_jax_names(got["port"]) if map_names else got["port"]
        assert json.loads(json.dumps(port)) == json.loads(json.dumps(got["jax"]))
        return got["port"]

    def create(self, resource, ns, obj):
        for s in self.side.values():
            s.api.create(resource, ns, json.loads(json.dumps(obj)))

    def call(self, method, *args):
        for s in self.side.values():
            getattr(s.api, method)(*json.loads(json.dumps(args)))

    def stored(self, *resources, ns="", map_names=False):
        return self.same(lambda pkg, s: {r: s.api.list(r, ns)["items"] for r in resources},
                         map_names=map_names)


def prime(*informers):
    for inf in informers:
        inf.reflector._list()


def node_wire(name, ready=True, pod_cidr=""):
    return {"kind": "Node", "metadata": {"name": name}, "spec": {"podCIDR": pod_cidr},
            "status": {"conditions": [{"type": "Ready", "status": "True" if ready else "False"}]}}


def lb_service_wire(name, svc_type="LoadBalancer", ns="default"):
    return {"kind": "Service", "metadata": {"name": name, "namespace": ns},
            "spec": {"selector": {"app": name}, "ports": [{"name": "http", "port": 80}],
                     "type": svc_type}}


def fake_instances(seed):
    rng = np.random.default_rng(seed)
    out, zones = [], {}
    for i in range(int(rng.integers(2, 7))):
        name = f"host-{i}"
        labels = (("chip", str(rng.choice(["v5e", "h100"]))),
                  ("rack", str(int(rng.integers(0, 3)))))
        out.append((name, str(rng.choice(["", "tpu-4x", "gpu-8x"])), labels))
        if rng.integers(0, 2):
            zones[name] = (f"s{seed}/h{i}", f"s{seed}")
    return out, zones


def fake_provider(pkg, instances, zones):
    return pkg.cloud.FakeCloudProvider(
        instances=[pkg.cloud.Instance(name=n, instance_type=t, labels=l)
                   for n, t, l in instances],
        zones={n: pkg.cloud.Zone(failure_domain=fd, region=r) for n, (fd, r) in zones.items()})


@pytest.mark.parametrize("seed", range(6))
def test_cloud_nodes_register_label_and_reap_as_jax(seed):
    tw = Twin()
    instances, zones = fake_instances(seed)
    providers = tw.each(lambda pkg, s: fake_provider(pkg, instances, zones))
    ctls = tw.each(lambda pkg, s: pkg.cloudnodes.CloudNodeController(s.client,
                                                                     providers[pkg.name]))
    assert tw.same(lambda pkg, s: ctls[pkg.name].sync_once()) == len(instances)
    nodes = tw.stored("nodes")["nodes"]
    assert all(n["metadata"]["labels"][port_cloudnodes.LABEL_MANAGED] == "cloud" for n in nodes)
    assert all(n["status"]["conditions"][0]["status"] == "Unknown" for n in nodes)
    assert tw.same(lambda pkg, s: ctls[pkg.name].sync_once()) == 0
    # A self-registered node the cloud does not know, and a departed host.
    tw.create("nodes", "", {"kind": "Node", "metadata": {"name": "manual-node"}})
    keep = instances[1:]
    for pkg in BOTH:
        providers[pkg.name].set_instances(
            [pkg.cloud.Instance(name=n, instance_type=t, labels=l) for n, t, l in keep])
    assert tw.same(lambda pkg, s: ctls[pkg.name].sync_once()) == 1
    names = {n["metadata"]["name"] for n in tw.stored("nodes")["nodes"]}
    assert names == {"manual-node"} | {n for n, _, _ in keep}
    # A kubelet registered a node first: a 409, not an error.
    tw.call("delete", "nodes", "", keep[0][0])
    tw.create("nodes", "", node_wire(keep[0][0]))
    assert tw.same(lambda pkg, s: ctls[pkg.name].sync_once()) == 0
    tw.stored("nodes")


@pytest.mark.parametrize("seed", range(4))
def test_card_provider_nodes_as_the_tpu_providers(seed):
    """Both packages' hardware providers over the same records register
    the same nodes, host names mapped."""
    tw = Twin()
    ctls = tw.each(lambda pkg, s: pkg.cloudnodes.CloudNodeController(
        s.client, pkg.provider(devices=device_records(seed))))
    n_hosts = len({d.process_index for d in device_records(seed)})
    assert tw.same(lambda pkg, s: ctls[pkg.name].sync_once()) == n_hosts
    nodes = tw.stored("nodes", map_names=True)["nodes"]
    assert len(nodes) == n_hosts


def test_gpu_provider_registers_the_card_machine(fake_cards):
    """`GPUCloudProvider()` on the (patched) card machine registers
    gpu-host-0 with the cards' name and count in its labels."""
    api = port_api.APIServer()
    client = port_rest.Client(port_rest.LocalTransport(api))
    ctl = port_cloudnodes.CloudNodeController(client, port_gpu.GPUCloudProvider())
    assert ctl.sync_once() == 1
    labels = api.get("nodes", "", "gpu-host-0")["metadata"]["labels"]
    assert labels[port_gpu.LABEL_CHIP] == "NVIDIA-H100-80GB-HBM3"
    assert labels[port_gpu.LABEL_CHIPS] == "2"
    assert labels[port_cloudnodes.LABEL_MANAGED] == "cloud"
    assert labels[port_cloudnodes.LABEL_INSTANCE_TYPE] == "gpu-2x-NVIDIA-H100-80GB-HBM3"


# -- service load balancers ---------------------------------------------------


def balancers(tw, providers):
    return tw.same(lambda pkg, s: dict(providers[pkg.name].load_balancer().balancers))


def test_service_lb_ingress_churn_type_change_and_teardown_as_jax():
    tw = Twin()
    for name, ready in (("n1", True), ("n2", True), ("sick", False)):
        tw.create("nodes", "", node_wire(name, ready=ready))
    providers = tw.each(lambda pkg, s: pkg.cloud.FakeCloudProvider())
    ctls = tw.each(lambda pkg, s: pkg.servicelb.ServiceController(s.client, providers[pkg.name]))

    def sync():
        tw.each(lambda pkg, s: prime(ctls[pkg.name].services, ctls[pkg.name].nodes))
        tw.each(lambda pkg, s: ctls[pkg.name].sync())
        return tw.stored("services", ns="default")["services"]

    for name in ("web", "api"):
        tw.create("services", "default", lb_service_wire(name))
    tw.create("services", "team-a", lb_service_wire("api", ns="team-a"))
    tw.create("services", "default", lb_service_wire("plain", svc_type="ClusterIP"))
    svcs = {(s["metadata"]["namespace"], s["metadata"]["name"]): s for s in sync()}
    web = svcs[("default", "web")]
    lb = jax_servicelb.ServiceController._lb_name(
        types.SimpleNamespace(metadata=types.SimpleNamespace(namespace="default", name="web")))
    assert web["status"]["loadBalancer"]["ingress"] == [{"ip": f"lb-{lb}"}]
    assert not (svcs[("default", "plain")].get("status") or {}).get("loadBalancer")
    assert balancers(tw, providers)[lb] == ["n1", "n2"]  # only Ready nodes
    # Node churn: a new Ready node joins every balancer.
    tw.create("nodes", "", node_wire("n3"))
    sync()
    assert balancers(tw, providers)[lb] == ["n1", "n2", "n3"]
    # A type change clears the ingress and the balancer; a delete tears down.
    for s in tw.side.values():
        svc = s.api.get("services", "default", "web")
        svc["spec"]["type"] = "ClusterIP"
        s.api.update("services", "default", "web", svc)
    tw.call("delete", "services", "default", "api")
    svcs = {(s["metadata"]["namespace"], s["metadata"]["name"]): s for s in sync()}
    assert not (svcs[("default", "web")].get("status") or {}).get("loadBalancer")
    assert set(balancers(tw, providers)) == {
        jax_servicelb.ServiceController._lb_name(types.SimpleNamespace(
            metadata=types.SimpleNamespace(namespace="team-a", name="api")))}
    assert sync()  # no drift, nothing more written
    tw.stored("services", "nodes")


def test_started_service_controller_publishes_ingress_as_jax():
    """The started controllers (informers and loop threads) on the
    card-machine provider: a LoadBalancer service gets its ingress."""
    tw = Twin()
    tw.create("nodes", "", node_wire("tpu-host-0"))
    providers = tw.each(lambda pkg, s: pkg.provider(devices=device_records(1)))
    ctls = tw.each(lambda pkg, s: pkg.servicelb.ServiceController(
        s.client, providers[pkg.name], sync_period=0.05).start())
    try:
        tw.create("services", "default", lb_service_wire("inference"))
        deadline = time.monotonic() + 10
        while not all((s.api.get("services", "default", "inference").get("status") or {})
                      .get("loadBalancer") for s in tw.side.values()):
            assert time.monotonic() < deadline
            time.sleep(0.02)
    finally:
        tw.each(lambda pkg, s: ctls[pkg.name].stop())
    assert balancers(tw, providers) == {next(iter(balancers(tw, providers))): ["tpu-host-0"]}
    tw.stored("services", ns="default")


# -- routes --------------------------------------------------------------------


def routes_of(tw, providers):
    return tw.same(lambda pkg, s: sorted((r.name, r.target_instance, r.destination_cidr)
                                         for r in providers[pkg.name].routes()),
                   map_names=True)


def test_routes_follow_pod_cidrs():
    """The twin of tests/test_cloud_controllers.py's test: the started
    route controllers on twin apiservers. The port's reads each node's
    podCIDR through the whole model; through the client's trimmed one
    it would see none and make no route."""
    tw = Twin()
    tw.create("nodes", "", node_wire("n1", pod_cidr="10.244.1.0/24"))
    tw.create("nodes", "", node_wire("n2", pod_cidr="10.244.2.0/24"))
    tw.create("nodes", "", node_wire("nocidr"))
    providers = tw.each(lambda pkg, s: pkg.cloud.FakeCloudProvider())
    ctls = tw.each(lambda pkg, s: pkg.routes.RouteController(
        s.client, providers[pkg.name], sync_period=0.05).start())

    def settle(want):
        deadline = time.monotonic() + 10
        while any({r.name for r in p.routes()} != want for p in providers.values()):
            assert time.monotonic() < deadline, {k: p.routes() for k, p in providers.items()}
            time.sleep(0.02)

    try:
        settle({"podcidr-n1", "podcidr-n2"})
        assert routes_of(tw, providers) == [("podcidr-n1", "n1", "10.244.1.0/24"),
                                            ("podcidr-n2", "n2", "10.244.2.0/24")]
        tw.call("delete", "nodes", "", "n2")
        settle({"podcidr-n1"})
        routes_of(tw, providers)
    finally:
        tw.each(lambda pkg, s: ctls[pkg.name].stop())


@pytest.mark.parametrize("seed", range(4))
def test_routes_cidr_moves_and_base_routes_as_jax(seed):
    """Seeded node CIDRs on a multi-host hardware provider: a route a
    node podCIDR, recreated when it moves, gone with the node or its
    CIDR; the provider's base ring is never touched."""
    rng = np.random.default_rng(seed)
    tw = Twin()
    records = [types.SimpleNamespace(process_index=h, device_kind="k", platform="gpu",
                                     coords=None) for h in range(3)]
    providers = tw.each(lambda pkg, s: pkg.provider(devices=records))
    base = routes_of(tw, providers)
    assert len(base) == 3
    ctls = tw.each(lambda pkg, s: pkg.routes.RouteController(s.client, providers[pkg.name]))
    names = [f"n{i}" for i in range(6)]
    for name in names:
        cidr = f"10.244.{int(rng.integers(0, 250))}.0/24" if rng.integers(0, 4) else ""
        tw.create("nodes", "", node_wire(name, pod_cidr=cidr))

    def sync():
        tw.each(lambda pkg, s: prime(ctls[pkg.name].nodes))
        tw.each(lambda pkg, s: ctls[pkg.name].sync())
        return routes_of(tw, providers)

    sync()
    for step in range(4):
        name = str(rng.choice(names))
        cidr = f"10.245.{step}.0/24" if rng.integers(0, 3) else ""
        for s in tw.side.values():
            node = s.api.get("nodes", "", name)
            node["spec"]["podCIDR"] = cidr
            s.api.update("nodes", "", name, node)
        got = sync()
        assert set(base) <= set(got)
    tw.call("delete", "nodes", "", names[0])
    assert set(base) <= set(sync())
    tw.stored("nodes")


# -- the manager and the command ---------------------------------------------------


def _cloud_list(pkg, client, provider):
    mgr = pkg.manager.ControllerManager(client, cloud_provider=provider)
    return [type(c).__name__ for c in mgr.controllers]


def test_controller_manager_builds_the_jax_cloud_controllers():
    """With a provider, the manager leads with the cloud node controller,
    then the service and route controllers where the provider has those
    surfaces, as JAX's does."""
    class Bare:
        def load_balancer(self):
            return None

        def routes(self):
            return None

    got = {}
    for pkg in BOTH:
        client = pkg.rest.Client(pkg.rest.LocalTransport(pkg.api_mod.APIServer()))
        got[pkg.name] = [_cloud_list(pkg, client, p) for p in (
            pkg.cloud.FakeCloudProvider(), pkg.provider(devices=device_records(0)), Bare())]
    assert got["port"] == got["jax"]
    assert got["port"][0][:3] == ["CloudNodeController", "ServiceController", "RouteController"]
    assert got["port"][2][:2] == ["CloudNodeController", "ReplicationManager"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


@pytest.mark.parametrize("name,says", [("gpu", "no CUDA card"), ("tpu", "not registered")])
def test_command_refuses_a_provider_it_cannot_build(name, says):
    """`hyperkube controller-manager --cloud-provider gpu` without a card,
    or an unknown provider, fails at start naming why; nothing runs
    without the cloud."""
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "controller-manager",
         "--server", "http://127.0.0.1:1", "--cloud-provider", name, "--healthz-port", "-1"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and says in proc.stderr
