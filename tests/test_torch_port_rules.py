"""Rules the port keeps: no JAX, a CUDA default, no quiet CPU fallback.

- `kubernetes_tpu_torch/` and `chip_smoke.py` import neither `jax` nor
  anything of `kubernetes_tpu` (checked on the syntax tree).
- Entry points with no `device` and no CUDA raise.
- The kernel wrapper sends CPU tensors to the plain version and never
  launches there; an unknown device raises.
- `chip_smoke.py` exits non-zero and prints no result without CUDA, and
  alone in a directory.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import kubernetes_tpu_torch
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.ops import build, scan_kernel
from kubernetes_tpu_torch.ops.matrices import device_snapshot
from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kubernetes_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
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
    assert build.kernel_names() == ["scan_kernel"]


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
