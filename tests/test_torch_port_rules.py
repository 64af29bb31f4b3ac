"""Rules the port keeps: no JAX, a CUDA default, no quiet CPU fallback.

- `kubernetes_tpu_torch/` and `chip_smoke.py` import neither `jax` nor
  anything of `kubernetes_tpu`, and start no module of `kubernetes_tpu`
  as a child process (both checked on the syntax tree). Every program
  `chip_smoke.py` passes to `python -c` is one of its module-level
  `*_LAUNCHER` string constants, and each is held to the same rules.
- Entry points with no `device` and no CUDA raise.
- The kernel wrapper sends CPU tensors to the plain version and never
  launches there; an unknown device raises.
- `chip_smoke.py` exits non-zero and prints no result without CUDA, and
  alone in a directory.
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import kubernetes_tpu_torch
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.ops import build, policy_scan, scan_kernel
from kubernetes_tpu_torch.ops.matrices import device_snapshot
from kubernetes_tpu_torch.ops import SolverSession
from kubernetes_tpu_torch.ops.pipeline import gang_member_counts_device, solve_backlog_pipelined
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog, schedule_backlog_gang

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kubernetes_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        yield from _imports_of(f.read(), path)


def _imports_of(source, name="<string>"):
    tree = ast.parse(source, name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kubernetes_tpu") or top.startswith("jax.")


def test_forbidden_import_detector():
    assert _forbidden("jax.numpy") and _forbidden("kubernetes_tpu.ops")
    assert _forbidden("jaxlib") and not _forbidden("kubernetes_tpu_torch.ops")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_no_jax_package(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def _is_jax_module(value):
    return value == "kubernetes_tpu" or value.startswith("kubernetes_tpu.")


_SPAWNERS = {"Popen", "run", "call", "check_call", "check_output", "spawnv", "spawnl",
             "execv", "execl", "execvp", "execlp", "system", "create_subprocess_exec",
             "create_subprocess_shell"}


def _child_jax_modules(source):
    """JAX-package module paths that `source` would start as a child
    process: the module after a `-m` in a list or tuple literal or a
    call's arguments, a `-m kubernetes_tpu...` inside a command string,
    and any `kubernetes_tpu.` module path among the arguments of a
    subprocess, os.exec/spawn or asyncio call."""
    tree = ast.parse(source)
    found = []

    def strings(node):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                yield sub.value

    for node in ast.walk(tree):
        seqs = []
        if isinstance(node, (ast.List, ast.Tuple)):
            seqs.append(node.elts)
        if isinstance(node, ast.Call):
            seqs.append(node.args)
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
            if name in _SPAWNERS:
                for arg in [*node.args, *(k.value for k in node.keywords)]:
                    found += [v for v in strings(arg) if _is_jax_module(v)]
        for elts in seqs:
            for a, b in zip(elts, elts[1:]):
                if (isinstance(a, ast.Constant) and a.value == "-m"
                        and isinstance(b, ast.Constant) and isinstance(b.value, str)
                        and _is_jax_module(b.value)):
                    found.append(b.value)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            found += [m for m in re.findall(r"-m\s+(kubernetes_tpu(?:\.[\w.]+)?)\b",
                                            node.value)]
    return found


def test_child_process_detector():
    assert _child_jax_modules(
        'cmd = [sys.executable, "-m", "kubernetes_tpu.cmd.hyperkube", "apiserver"]'
    ) == ["kubernetes_tpu.cmd.hyperkube"]
    assert _child_jax_modules('subprocess.Popen(["python", "x.py", "kubernetes_tpu.cli"])')
    assert _child_jax_modules('os.system("python -m kubernetes_tpu.cmd.hyperkube apiserver")')
    assert not _child_jax_modules(
        'cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "apiserver"]\n'
        'bad = [m for m in sys.modules if m.startswith("kubernetes_tpu.")]'
    )


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_starts_no_jax_module_as_a_child(path):
    with open(path) as f:
        bad = _child_jax_modules(f.read())
    assert not bad, f"{os.path.relpath(path, REPO)} starts {bad} as a child process"


def _launchers(source):
    """{name: program} of the module-level string constants named
    `*_LAUNCHER` in `source`."""
    out = {}
    for node in ast.parse(source).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.endswith("_LAUNCHER")
                and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)):
            out[node.targets[0].id] = node.value.value
    return out


def _dash_c_programs(source):
    """What follows each "-c" in a list or tuple literal of `source`."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, (ast.List, ast.Tuple)):
            for a, b in zip(node.elts, node.elts[1:]):
                if isinstance(a, ast.Constant) and a.value == "-c":
                    found.append(b)
    return found


def test_launcher_detector():
    bad = 'X_LAUNCHER = "import kubernetes_tpu.server.api"\ncmd = [sys.executable, "-c", X_LAUNCHER]'
    programs = _launchers(bad)
    assert list(programs) == ["X_LAUNCHER"]
    assert [m for m in _imports_of(programs["X_LAUNCHER"]) if _forbidden(m)]
    assert [n.id for n in _dash_c_programs(bad)] == ["X_LAUNCHER"]


def test_smoke_launcher_programs_import_no_jax_and_start_none():
    """The replicas of the smoke's replicated control plane run a program
    given to `python -c` (REPLICA_LAUNCHER): it imports neither `jax`
    nor anything of `kubernetes_tpu` and starts no JAX module, and no
    other program reaches `-c` in the smoke."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        source = f.read()
    programs = _launchers(source)
    assert "REPLICA_LAUNCHER" in programs
    for name, program in programs.items():
        imported = list(_imports_of(program, name))
        assert "kubernetes_tpu_torch.store.replication" in imported or name != "REPLICA_LAUNCHER"
        bad = [m for m in imported if _forbidden(m)]
        assert not bad, f"{name} imports {bad}"
        assert not _child_jax_modules(program), name
    given = _dash_c_programs(source)
    assert given and all(isinstance(n, ast.Name) and n.id in programs for n in given), [
        ast.dump(n) for n in given]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        kubernetes_tpu_torch.default_device()
    assert kubernetes_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(no_cuda):
    pods, nodes, services = workload.synthetic_objects(8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_backlog_pipelined(pods, nodes, services=services)
    with pytest.raises(RuntimeError, match="CUDA"):
        schedule_backlog(pods, nodes, services=services)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_snapshot(build_snapshot(pods, nodes, services=services))
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverSession(nodes, services)
    with pytest.raises(RuntimeError, match="CUDA"):
        schedule_backlog_gang(pods, nodes, services=services)
    with pytest.raises(RuntimeError, match="CUDA"):
        gang_member_counts_device([True], [0], 1)


def test_new_modules_fall_under_the_import_check():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {
        "kubernetes_tpu_torch/ops/incremental.py",
        "kubernetes_tpu_torch/scheduler/gang.py",
        "kubernetes_tpu_torch/ops/policy_scan.py",
        "kubernetes_tpu_torch/ops/sidecar.py",
        "kubernetes_tpu_torch/ops/wave.py",
        "kubernetes_tpu_torch/ops/sinkhorn.py",
        "kubernetes_tpu_torch/ops/oracle.py",
        "kubernetes_tpu_torch/ops/preemption.py",
        "kubernetes_tpu_torch/ops/capacity.py",
        "kubernetes_tpu_torch/ops/rebalance.py",
        "kubernetes_tpu_torch/utils/capacity.py",
        "kubernetes_tpu_torch/utils/rebalance.py",
        "kubernetes_tpu_torch/native.py",
        "kubernetes_tpu_torch/ops/ledger.py",
        "kubernetes_tpu_torch/utils/metrics.py",
        "kubernetes_tpu_torch/utils/tracing.py",
        "kubernetes_tpu_torch/utils/sli.py",
        "kubernetes_tpu_torch/utils/profiler.py",
        "kubernetes_tpu_torch/utils/flightrecorder.py",
        "kubernetes_tpu_torch/models/serde.py",
        "kubernetes_tpu_torch/utils/ratelimit.py",
        "kubernetes_tpu_torch/client/cache.py",
        "kubernetes_tpu_torch/client/rest.py",
        "kubernetes_tpu_torch/client/record.py",
        "kubernetes_tpu_torch/scheduler/modeler.py",
        "kubernetes_tpu_torch/scheduler/daemon.py",
        "kubernetes_tpu_torch/cmd/scheduler.py",
        "kubernetes_tpu_torch/models/labels.py",
        "kubernetes_tpu_torch/scheduler/types.py",
        "kubernetes_tpu_torch/scheduler/predicates.py",
        "kubernetes_tpu_torch/scheduler/priorities.py",
        "kubernetes_tpu_torch/scheduler/generic.py",
        "kubernetes_tpu_torch/scheduler/plugins.py",
        "kubernetes_tpu_torch/controllers/__init__.py",
        "kubernetes_tpu_torch/controllers/descheduler.py",
        "kubernetes_tpu_torch/controllers/autoscaler.py",
        "kubernetes_tpu_torch/utils/lease.py",
        "kubernetes_tpu_torch/utils/leaderelect.py",
        "kubernetes_tpu_torch/scheduler/standby.py",
        "kubernetes_tpu_torch/models/validation.py",
        "kubernetes_tpu_torch/models/apiobjects.py",
        "kubernetes_tpu_torch/models/conversion.py",
        "kubernetes_tpu_torch/store/__init__.py",
        "kubernetes_tpu_torch/store/watch.py",
        "kubernetes_tpu_torch/store/kvstore.py",
        "kubernetes_tpu_torch/server/__init__.py",
        "kubernetes_tpu_torch/server/allocators.py",
        "kubernetes_tpu_torch/server/registry.py",
        "kubernetes_tpu_torch/server/watchcache.py",
        "kubernetes_tpu_torch/server/admission.py",
        "kubernetes_tpu_torch/server/auth.py",
        "kubernetes_tpu_torch/server/api.py",
        "kubernetes_tpu_torch/server/httpserver.py",
        "kubernetes_tpu_torch/utils/websocket.py",
        "kubernetes_tpu_torch/utils/timeseries.py",
        "kubernetes_tpu_torch/utils/alerts.py",
        "kubernetes_tpu_torch/cmd/daemons.py",
        "kubernetes_tpu_torch/cmd/hyperkube.py",
        "kubernetes_tpu_torch/store/replication.py",
        "kubernetes_tpu_torch/controllers/manager.py",
        "kubernetes_tpu_torch/controllers/replication.py",
        "kubernetes_tpu_torch/controllers/endpoints.py",
        "kubernetes_tpu_torch/controllers/nodelifecycle.py",
        "kubernetes_tpu_torch/controllers/namespace.py",
        "kubernetes_tpu_torch/controllers/serviceaccounts.py",
        "kubernetes_tpu_torch/controllers/resourcequota.py",
        "kubernetes_tpu_torch/controllers/gangs.py",
        "kubernetes_tpu_torch/controllers/volumeclaimbinder.py",
        "kubernetes_tpu_torch/controllers/pvrecycler.py",
        "kubernetes_tpu_torch/kubelet/__init__.py",
        "kubernetes_tpu_torch/kubelet/agent.py",
        "kubernetes_tpu_torch/kubelet/envvars.py",
        "kubernetes_tpu_torch/kubelet/managers.py",
        "kubernetes_tpu_torch/kubelet/probes.py",
        "kubernetes_tpu_torch/kubelet/process_runtime.py",
        "kubernetes_tpu_torch/kubelet/runtime.py",
        "kubernetes_tpu_torch/kubelet/sandbox_runtime.py",
        "kubernetes_tpu_torch/kubelet/server.py",
        "kubernetes_tpu_torch/volumes/__init__.py",
        "kubernetes_tpu_torch/volumes/mount.py",
        "kubernetes_tpu_torch/volumes/plugins.py",
        "kubernetes_tpu_torch/proxy/__init__.py",
        "kubernetes_tpu_torch/proxy/config.py",
        "kubernetes_tpu_torch/proxy/portal.py",
        "kubernetes_tpu_torch/proxy/proxier.py",
        "kubernetes_tpu_torch/proxy/roundrobin.py",
        "kubernetes_tpu_torch/proxy/ruletable.py",
        "kubernetes_tpu_torch/cloudprovider/__init__.py",
        "kubernetes_tpu_torch/cloudprovider/interface.py",
        "kubernetes_tpu_torch/cloudprovider/fake.py",
        "kubernetes_tpu_torch/cloudprovider/gpu.py",
        "kubernetes_tpu_torch/controllers/cloudnodes.py",
        "kubernetes_tpu_torch/controllers/servicelb.py",
        "kubernetes_tpu_torch/controllers/routes.py",
        "kubernetes_tpu_torch/addons/__init__.py",
        "kubernetes_tpu_torch/addons/__main__.py",
        "kubernetes_tpu_torch/addons/dns.py",
        "kubernetes_tpu_torch/addons/logging.py",
        "kubernetes_tpu_torch/addons/monitoring.py",
        "kubernetes_tpu_torch/cmd/localup.py",
        "kubernetes_tpu_torch/cmd/clusterup.py",
    } <= names


#: Each node command's path, driven in a child: the kubelet registers
#: and syncs a pod on the fake and the process runtimes (the process
#: runtime builds its pause anchor), the proxy opens a portal.
_NODE_PATHS = {
    "kubelet": (
        "import sys, tempfile, time\n"
        "from kubernetes_tpu_torch.client.rest import Client, LocalTransport\n"
        "from kubernetes_tpu_torch.cmd import daemons, hyperkube\n"
        "from kubernetes_tpu_torch.server.api import APIServer\n"
        "api = APIServer()\n"
        "root = tempfile.mkdtemp()\n"
        "for flags in (['--fake-runtime'], ['--root-dir', root]):\n"
        "    args = daemons.kubelet_parser().parse_args(['--node-name', 'n' + str(len(flags)), *flags])\n"
        "    k = daemons.start_kubelet(args, Client(LocalTransport(api)))\n"
        "    api.create('pods', 'default', {'metadata': {'name': 'p' + str(len(flags))},\n"
        "        'spec': {'nodeName': args.node_name, 'containers': [{'name': 'c', 'image': 'x'}]}})\n"
        "    deadline = time.monotonic() + 20\n"
        "    while api.get('pods', 'default', 'p' + str(len(flags))).get('status', {}).get('phase') != 'Running':\n"
        "        assert time.monotonic() < deadline\n"
        "        time.sleep(0.05)\n"
        "    k.stop()\n"
        "    for uid in list(k.runtime.list_pods()):\n"
        "        k.runtime.kill_pod(uid)\n"
    ),
    "proxy": (
        "import sys\n"
        "from kubernetes_tpu_torch.client.rest import Client, LocalTransport\n"
        "from kubernetes_tpu_torch.cmd import daemons, hyperkube\n"
        "from kubernetes_tpu_torch.server.api import APIServer\n"
        "api = APIServer()\n"
        "api.create('services', 'default', {'metadata': {'name': 's'}, 'spec': {'ports': [{'port': 80}]}})\n"
        "args = daemons.proxy_parser().parse_args(['--no-real-portals', '--healthz-port', '-1'])\n"
        "p = daemons.start_proxy(args, Client(LocalTransport(api)))\n"
        "assert p.proxier.service_info(('default', 's', '')) is not None\n"
        "p.stop()\n"
    ),
}


@pytest.mark.parametrize("server", sorted(_NODE_PATHS))
def test_node_commands_load_no_torch_and_no_jax_package(server):
    """`hyperkube kubelet` and `hyperkube proxy`: their command module
    and the path each drives load neither torch nor numpy nor anything
    of the JAX package."""
    proc = _python(["-c", _NODE_PATHS[server] + (
        "print(sorted(m for m in sys.modules if m == 'kubernetes_tpu'\n"
        "             or m.startswith('kubernetes_tpu.')), 'torch' in sys.modules,\n"
        "      'numpy' in sys.modules)\n")], timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[] False False"


def test_cloud_controller_manager_loads_no_torch_and_no_jax_package():
    """`hyperkube controller-manager --cloud-provider fake`: the command
    module, the registry and the started manager with its cloud
    controllers load neither torch nor numpy nor anything of the JAX
    package; only the `gpu` provider's inventory read would load torch."""
    proc = _python(["-c", (
        "import sys\n"
        "from kubernetes_tpu_torch.client.rest import Client, LocalTransport\n"
        "from kubernetes_tpu_torch.cmd import daemons, hyperkube\n"
        "from kubernetes_tpu_torch.server.api import APIServer\n"
        "args = daemons.controller_manager_parser().parse_args(['--cloud-provider', 'fake'])\n"
        "mgr = daemons.start_controller_manager(args, Client(LocalTransport(APIServer())))\n"
        "names = [type(c).__name__ for c in mgr.controllers][:3]\n"
        "mgr.stop()\n"
        "print(sorted(m for m in sys.modules if m == 'kubernetes_tpu'\n"
        "             or m.startswith('kubernetes_tpu.')), 'torch' in sys.modules,\n"
        "      'numpy' in sys.modules, names)\n")], timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == (
        "[] False False ['CloudNodeController', 'ServiceController', 'RouteController']")


def test_gpu_cloud_provider_raises_without_cuda(no_cuda):
    """The card inventory has no CPU fallback: no card, no provider."""
    from kubernetes_tpu_torch.cloudprovider import GPUCloudProvider, get_provider

    with pytest.raises(RuntimeError, match="CUDA"):
        GPUCloudProvider()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_provider("gpu")


def test_local_up_batch_scheduler_raises_without_cuda(no_cuda):
    """`LocalCluster` with a batch scheduler and no `--device cpu`
    raises before it builds or serves anything."""
    from kubernetes_tpu_torch.cmd.localup import LocalCluster, build_parser

    with pytest.raises(RuntimeError, match="CUDA"):
        LocalCluster(build_parser().parse_args(["--batch-scheduler", "--port", "0"]))


def test_standby_raises_without_cuda(no_cuda):
    """A warm standby (and so an HAScheduler's) is built on the card:
    without one and without `device="cpu"` it raises before any
    informer starts."""
    from kubernetes_tpu.server.api import APIServer

    from kubernetes_tpu_torch.client.rest import Client, LocalTransport
    from kubernetes_tpu_torch.scheduler.standby import HAScheduler, WarmStandbyScheduler

    client = Client(LocalTransport(APIServer()))
    with pytest.raises(RuntimeError, match="CUDA"):
        WarmStandbyScheduler(client)
    with pytest.raises(RuntimeError, match="CUDA"):
        HAScheduler(client, "a").start()


def _python(args, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, **kw)


def test_scheduler_command_loads_nothing_of_the_jax_package():
    proc = _python(["-c", "import sys, kubernetes_tpu_torch.cmd.scheduler; "
                          "print(sorted(m for m in sys.modules "
                          "if m == 'kubernetes_tpu' or m.startswith('kubernetes_tpu.')))"],
                   timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_scheduler_command_raises_without_cuda():
    proc = _python(["-m", "kubernetes_tpu_torch.cmd.scheduler", "--server",
                    "http://127.0.0.1:9", "--batch"], timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    proc = _python(["-m", "kubernetes_tpu_torch.cmd.scheduler", "--device", "cpu",
                    "--batch-incremental", "--policy-config-file", "policy.json"], timeout=120)
    assert proc.returncode != 0 and "supports the default policy only" in proc.stderr
    # With a batch flag, the full re-lower daemon runs on the card too.
    proc = _python(["-m", "kubernetes_tpu_torch.cmd.scheduler", "--server", "http://127.0.0.1:9",
                    "--batch", "--batch-full-relower"], timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr


def test_scheduler_command_binds_on_the_cpu_when_asked():
    """--device cpu: the daemon process schedules a pod of the apiserver
    it was pointed at, and exits 0 on SIGTERM."""
    import signal
    import time

    from kubernetes_tpu.client import Client, LocalTransport
    from kubernetes_tpu.server.api import APIServer
    from kubernetes_tpu.server.httpserver import APIHTTPServer

    api = APIServer()
    setup = Client(LocalTransport(api))
    setup.create("nodes", {"kind": "Node", "metadata": {"name": "n0"},
                           "status": {"capacity": {"cpu": "2", "memory": "4Gi", "pods": "10"}}})
    setup.create("pods", {"kind": "Pod", "metadata": {"name": "p", "namespace": "default"},
                          "spec": {"containers": [{"name": "c", "image": "app"}]}},
                 namespace="default")
    srv = APIHTTPServer(api).start()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.scheduler", "--server", srv.address,
         "--device", "cpu", "--prewarm-buckets", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and proc.poll() is None:
            if setup.get("pods", "p", namespace="default").spec.node_name:
                break
            time.sleep(0.1)
        assert setup.get("pods", "p", namespace="default").spec.node_name == "n0"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "scheduler running" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        srv.stop()


def test_preemption_capacity_and_rebalance_entry_points_raise_without_cuda(no_cuda):
    from kubernetes_tpu_torch.ops.capacity import capacity_report
    from kubernetes_tpu_torch.ops.preemption import build_preemption_problem, solve_preemption
    from kubernetes_tpu_torch.ops.rebalance import plan_moves
    from kubernetes_tpu_torch.scheduler.batch import preempt_backlog
    from kubernetes_tpu_torch.utils.capacity import sample as capacity_sample
    from kubernetes_tpu_torch.utils.rebalance import build_plan, fragment_score

    preemptors, nodes, assigned = workload.preemption_objects(4, 20, 3, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        preempt_backlog(preemptors, nodes, assigned)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_preemption(build_preemption_problem(nodes, assigned), preemptors)
    args = workload.random_rebalance_args(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_moves(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        capacity_report(*args[:8], *args[13:17])
    cols = dict(zip(("cpu_cap", "mem_cap", "pods_cap", "cpu_fit", "mem_fit", "pods_used",
                     "over", "sched"), args[:8]))
    probes = [("q", 500.0, 256.0, 1)]
    names = [f"n{j}" for j in range(len(args[0]))]
    with pytest.raises(RuntimeError, match="CUDA"):
        build_plan(cols, names, assigned, probes)
    with pytest.raises(RuntimeError, match="CUDA"):
        fragment_score(cols, probes)
    with pytest.raises(RuntimeError, match="CUDA"):
        capacity_sample(cols, probes)
    from kubernetes_tpu_torch.utils.capacity import CapacityMonitor

    with pytest.raises(RuntimeError, match="CUDA"):
        CapacityMonitor().sample(cols, names)
    with pytest.raises(RuntimeError, match="CUDA"):
        CapacityMonitor().warm(len(names))


def test_controllers_raise_without_cuda(no_cuda):
    """The descheduler, and an autoscaler that builds its own, resolve
    the card at construction."""
    from kubernetes_tpu_torch.client.rest import Client, LocalTransport
    from kubernetes_tpu_torch.controllers import Autoscaler, Descheduler

    client = Client(LocalTransport(object()))

    class Pool:
        name = "p"

        def size(self):
            return 0

    with pytest.raises(RuntimeError, match="CUDA"):
        Descheduler(client)
    with pytest.raises(RuntimeError, match="CUDA"):
        Autoscaler(client, Pool())
    assert str(Descheduler(client, device="cpu").device) == "cpu"


def test_rebalance_wrapper_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    from kubernetes_tpu_torch.ops import rebalance

    def no_launch(*args, **kwargs):
        raise AssertionError("the CUDA launch path was taken for CPU tensors")

    monkeypatch.setattr(rebalance, "_launch", no_launch)
    before = rebalance.plan_moves.launches
    out = rebalance.plan_moves(*workload.random_rebalance_args(2), device="cpu")
    assert out[0].device.type == "cpu" and rebalance.plan_moves.launches == before


def test_rebalance_wrapper_rejects_other_devices():
    from kubernetes_tpu_torch.ops import rebalance

    with pytest.raises(ValueError, match="unsupported device"):
        rebalance.plan_moves(*workload.random_rebalance_args(2), device="meta")


def test_windowed_entry_points_raise_without_cuda(no_cuda):
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog_sinkhorn, schedule_backlog_wave

    pods, nodes, services = workload.synthetic_objects(8, 2)
    for mode in ("wave", "sinkhorn"):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve_backlog_pipelined(pods, nodes, services=services, mode=mode)
        with pytest.raises(RuntimeError, match="CUDA"):
            SolverSession(nodes, services, mode=mode)
    for entry in (schedule_backlog_wave, schedule_backlog_sinkhorn):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(pods, nodes, services=services)


def _policy_state(seed=4):
    from kubernetes_tpu_torch.models.algspec import spec_from_policy

    pending, nodes, assigned, services = workload.policy_cluster(seed)
    spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    return device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), device="cpu")


def test_policy_entry_points_raise_without_cuda(no_cuda):
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.ops.pipeline import explain_backlog
    from kubernetes_tpu_torch.ops.sidecar import serve

    pending, nodes, assigned, services = workload.policy_cluster(1)
    spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    with pytest.raises(RuntimeError, match="CUDA"):
        schedule_backlog(pending, nodes, assigned, services, spec=spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        explain_backlog(pending, nodes, assigned, services)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("/nonexistent/dir/solver.sock")


def test_policy_wrapper_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("the CUDA launch path was taken for CPU tensors")

    monkeypatch.setattr(policy_scan, "_launch", no_launch)
    d = _policy_state()
    before = policy_scan.policy_scan_with_state.launches
    choice, _ = policy_scan.policy_scan_with_state(
        d.pods, {k: v.clone() for k, v in d.nodes.items()}, d.weights, d.lowered)
    assert choice.shape == (d.pod_count_padded,)
    assert policy_scan.policy_scan_with_state.launches == before


def test_policy_wrapper_rejects_other_devices():
    d = _policy_state()
    meta_pods = {k: v.to("meta") for k, v in d.pods.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        policy_scan.policy_scan_with_state(meta_pods, d.nodes, d.weights, d.lowered)


def test_policy_launch_plan_raises_before_any_launch():
    from kubernetes_tpu_torch.models.algspec import LoweredSpec

    one = LoweredSpec(aa_weights=(1,), aa_zones=(16,))
    plan = policy_scan.launch_plan(5120, 2, 2, 2, 8, 1, one)
    assert (plan.cluster, plan.threads, plan.zone_bins, plan.resident) == (16, 320, 16, True)
    widths = (5120, 2, 2, 2, 8, 1, 0, 1, 0, 16, 16, True)
    assert plan.smem_bytes == policy_scan.smem_bytes(*widths) <= policy_scan.SMEM_LIMIT
    assert policy_scan.launch_plan(40, 2, 2, 2, 8, 0, LoweredSpec(static_prio=True)).threads == 32
    # Six hostname-like instances at 5,120 nodes, or 60,000 zone bins:
    # their bins alone fill a CTA's shared memory, so the plan keeps them
    # in device memory; only a plan forced to hold them resident raises.
    six = LoweredSpec(aa_weights=(1,) * 6, aa_zones=(5120,) * 6)
    wide = LoweredSpec(aa_weights=(1,), aa_zones=(60000,))
    for N, lspec in ((5120, six), (100, wide)):
        assert not policy_scan.launch_plan(N, 2, 2, 2, 8, 0, lspec).resident
    bad = [
        # Any number of instances and affinity labels plans; shared
        # memory is what remains: nine wide instances held resident, or
        # pod rows of 8,000 affinity pins even in place.
        (dict(N=100, KA=0, lspec=LoweredSpec(aa_weights=(1,) * 9, aa_zones=(60000,) * 9),
              resident=True), "shared memory"),
        (dict(N=100, KA=8000, lspec=LoweredSpec(service_affinity=True)), "shared memory"),
        (dict(N=5120, KA=0, lspec=six, resident=True), "shared memory"),
        (dict(N=100, KA=0, lspec=wide, resident=True), "shared memory"),
        (dict(N=100, KA=0, lspec=LoweredSpec(aa_weights=(1,), aa_zones=())), "zone sizes"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            policy_scan.launch_plan(kw["N"], 2, 2, 2, 8, kw["KA"], kw["lspec"],
                                    resident=kw.get("resident"))
    with pytest.raises(ValueError, match="threads"):
        policy_scan.launch_plan(100, 2, 2, 2, 8, 0, one, threads=48)


def test_policy_wrapper_checks_the_spec_columns():
    """A spec whose columns the snapshot lacks is refused before any
    launch, not read out of bounds."""
    from kubernetes_tpu_torch.models.algspec import LoweredSpec

    d = _policy_state()
    nodes = {k: v for k, v in d.nodes.items() if k != "aa_zone"}
    with pytest.raises(ValueError, match="aa_zone"):
        policy_scan._check(d.pods, nodes, d.lowered, policy_scan._dims(d.pods, nodes, d.lowered),
                           d.pods["cpu"].device)
    with pytest.raises(ValueError, match="static_prio"):
        lspec = LoweredSpec(static_prio=True)
        nodes = {k: v for k, v in d.nodes.items() if k != "static_prio"}
        policy_scan._check(d.pods, nodes, lspec, policy_scan._dims(d.pods, nodes, lspec),
                           d.pods["cpu"].device)


def test_session_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("the CUDA launch path was taken for CPU tensors")

    monkeypatch.setattr(scan_kernel, "_launch", no_launch)
    pods, nodes, services = workload.synthetic_objects(8, 2)
    session = SolverSession(nodes, services, device="cpu")
    for pod in pods:
        session.add_pending(pod)
    before = scan_kernel.scan_with_state.launches
    assert len(session.solve()) == 8
    assert scan_kernel.scan_with_state.launches == before


def test_wrapper_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("the CUDA launch path was taken for CPU tensors")

    monkeypatch.setattr(scan_kernel, "_launch", no_launch)
    pending, nodes, assigned, services = workload.small_cluster(4)
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device="cpu")
    before = scan_kernel.scan_with_state.launches
    choice, _ = scan_kernel.scan_with_state(d.pods, {k: v.clone() for k, v in d.nodes.items()})
    assert choice.shape == (d.pod_count_padded,)
    assert scan_kernel.scan_with_state.launches == before


def test_wrapper_rejects_other_devices():
    pending, nodes, assigned, services = workload.small_cluster(4)
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device="cpu")
    meta_pods = {k: v.to("meta") for k, v in d.pods.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        scan_kernel.scan_with_state(meta_pods, d.nodes)


def test_build_keys_libraries_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build.library_path("k")
    assert build.kernel_names() == ["k"]
    src.write_text("// two\n")
    assert build.library_path("k") != first
    assert os.path.dirname(first) == str(tmp_path / "build")


def test_build_names_every_kernel_source():
    assert build.kernel_names() == ["policy_scan_kernel", "rebalance_kernel", "scan_kernel"]


def test_each_kernel_is_keyed_by_its_own_source(tmp_path, monkeypatch):
    """Two sources, two libraries: editing one rebuilds only that one
    (each is its own nvcc process, keyed by its own hash)."""
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "a.cu").write_text("// a\n")
    (tmp_path / "b.cu").write_text("// b\n")
    a, b = build.library_path("a"), build.library_path("b")
    assert a != b
    (tmp_path / "a.cu").write_text("// a, edited\n")
    assert build.library_path("a") != a and build.library_path("b") == b


def test_nvcc_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


def _run_smoke(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and obj.get("ok") is True:
            return True
    return False


def test_chip_smoke_fails_without_cuda():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_chip_smoke_log_tail_leaves_the_childs_offset():
    """A child's output file read while the child writes: every line
    lands once and in order. The child writes through the same open
    file, so a reader that seeks moves the child's write offset, and
    the child's next line overwrites the start of the file."""
    import importlib.util
    import tempfile

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n = 400
    with tempfile.TemporaryFile() as log:
        child = subprocess.Popen(
            [sys.executable, "-c", "import time\n"
             f"for i in range({n}):\n    print(f'line {{i}}', flush=True)\n    time.sleep(0.001)"],
            stdout=log, stderr=subprocess.STDOUT)
        while child.poll() is None:
            smoke._log_tail(log, 100)
        child.wait(timeout=60)
        assert smoke._log_tail(log, 1 << 20).splitlines() == [f"line {i}" for i in range(n)]
