"""The port's solver sidecar speaks the JAX package's wire, both ways.

- Frames encoded by either package decode in the other, the tagged
  LoweredSpec included, and the encodings are byte-identical; version
  skew and a bad magic fail clean.
- A port server (`python -m kubernetes_tpu_torch.ops.sidecar <socket>
  --device cpu`) answers the JAX package's `SidecarSolver` with the JAX
  package's `schedule_backlog_tpu` decisions, default and policy spec;
  the JAX `BatchScheduler` binds a backlog through it with no fallback;
  modes "wave" and "sinkhorn" answer as the JAX server's do (a policy in
  a wave request ignored); a failed solve is a structured error; a
  garbage frame does not kill it; without `--device cpu` and without a
  card it exits non-zero.
- The port's client against the JAX package's server gives the same
  decisions.

Every subprocess has its own wait of at most 30 s and is killed in
teardown, so a hang fails one test and not the run."""

import os
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from kubernetes_tpu.client import Client, LocalTransport
from kubernetes_tpu.models.algspec import LoweredSpec as JLoweredSpec
from kubernetes_tpu.models.algspec import spec_from_policy as jspec_from_policy
from kubernetes_tpu.ops import sidecar as jsidecar
from kubernetes_tpu.scheduler.batch import schedule_backlog_tpu
from kubernetes_tpu.scheduler.daemon import BatchScheduler, SchedulerConfig
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.algspec import LoweredSpec, spec_from_policy
from kubernetes_tpu_torch.ops import sidecar
from tests.test_sidecar import node_wire, pod_wire
from tests.test_solver_parity import random_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=WAIT_S)


def _message(lowered_cls):
    return {
        "op": "solve",
        "mode": "scan",
        "pods": {
            "cpu": np.arange(6, dtype=np.float32),
            "bits": np.array([[1, 2], [3, 4]], dtype=np.uint32),
            "empty": np.zeros((0, 3), dtype=np.int32),
        },
        "weights": (2, 0, 1),
        "lowered": lowered_cls(ports=False, node_label=True, aa_weights=(3, 1), aa_zones=(16, 32)),
        "none_field": None,
        "flag": True,
        "names": ["a", "b"],
    }


def _check_decoded(out, lowered_cls):
    ref = _message(lowered_cls)
    assert out["op"] == "solve" and out["flag"] is True and out["none_field"] is None
    assert out["weights"] == (2, 0, 1) and out["names"] == ["a", "b"]
    assert isinstance(out["lowered"], lowered_cls)
    assert tuple(out["lowered"]) == tuple(ref["lowered"])
    for k, v in ref["pods"].items():
        assert out["pods"][k].dtype == v.dtype and np.array_equal(out["pods"][k], v)


def test_encodings_are_byte_identical():
    header, arrays = sidecar._encode(_message(LoweredSpec))
    jheader, jarrays = jsidecar._encode(_message(JLoweredSpec))
    assert header == jheader
    assert [a.tobytes() for a in arrays] == [a.tobytes() for a in jarrays]
    assert (sidecar._MAGIC, sidecar._VERSION) == (jsidecar._MAGIC, jsidecar._VERSION)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frames_round_trip_between_packages(direction):
    """A whole frame over a socket pair: sent by one package, received
    and decoded by the other, LoweredSpec tag included."""
    send, recv, cls = (
        (jsidecar._send_msg, sidecar._recv_msg, LoweredSpec)
        if direction == "jax_to_port"
        else (sidecar._send_msg, jsidecar._recv_msg, JLoweredSpec)
    )
    src_cls = JLoweredSpec if cls is LoweredSpec else LoweredSpec
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=send, args=(a, _message(src_cls)), daemon=True)
        t.start()
        out = recv(b)
        t.join(timeout=WAIT_S)
        _check_decoded(out, cls)
    finally:
        a.close()
        b.close()


def test_snapshot_payload_round_trips_into_the_port():
    """The JAX client's solve payload for a policy snapshot decodes into
    the port's Snapshot with every column and the service carry."""
    from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot

    pending, nodes, assigned, services = workload.policy_objects(60, 12, seed=1)
    jsnap = jbuild_snapshot(pending, nodes, assigned, services,
                            spec=jspec_from_policy(workload.FULL_VOCABULARY_POLICY))
    header, arrays = jsidecar._encode({"op": "solve", **jsidecar._snapshot_payload(jsnap)})
    snap = sidecar._snapshot_from_payload(sidecar._decode(header, bytearray(b"".join(
        a.tobytes() for a in arrays))))
    assert tuple(snap.lowered) == tuple(jsnap.lowered) and snap.weights == jsnap.weights
    for side in ("pods", "nodes"):
        for k, v in jsidecar._snapshot_payload(jsnap)[side].items():
            got = getattr(getattr(snap, side), k)
            assert (got is None) == (v is None), k
            if v is not None:
                assert got.dtype == v.dtype and np.array_equal(got, v), k
    assert np.array_equal(snap.anchor_init, jsnap.anchor_init)
    assert np.array_equal(snap.svc_total_init, jsnap.svc_total_init)


def test_version_skew_and_bad_magic_fail_clean():
    for frame, match in (
        (sidecar._MAGIC + struct.pack(">HQI", 9, 23, 23) + b'{"meta":{},"arrays":[]}', "version skew"),
        (b"\x00" * 64, "magic"),
    ):
        a, b = socket.socketpair()
        try:
            threading.Thread(target=a.sendall, args=(frame,), daemon=True).start()
            with pytest.raises(sidecar.SidecarError, match=match):
                sidecar._recv_msg(b)
        finally:
            a.close()
            b.close()


@pytest.fixture(scope="module")
def port_server():
    """The port's sidecar on the CPU, as a subprocess (its socket in a
    short temporary directory: a unix socket path holds 108 bytes)."""
    # One intra-op thread: the suite's other workers share the cores.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc, sock_path = sidecar.spawn_sidecar(wait=WAIT_S, device="cpu", env=env)
    try:
        yield sock_path
    finally:
        _stop(proc)
        shutil.rmtree(os.path.dirname(sock_path), ignore_errors=True)


def _policy_spec_jax():
    return jspec_from_policy(workload.FULL_VOCABULARY_POLICY)


@pytest.mark.parametrize("case", ["default", "policy"])
def test_jax_client_gets_jax_decisions_from_the_port_server(port_server, case):
    client = jsidecar.SidecarSolver(port_server, timeout=WAIT_S)
    if case == "default":
        pending, nodes, assigned, services = random_cluster(4)
        spec = None
    else:
        pending, nodes, assigned, services = workload.policy_objects(120, 16, seed=5)
        spec = _policy_spec_jax()
    remote = client.solve(pending, nodes, assigned, services, spec=spec)
    local = schedule_backlog_tpu(pending, nodes, assigned, services, spec=spec)
    assert remote == local
    assert any(r is not None for r in remote)


def test_port_client_reads_the_servers_launch_counts(port_server):
    """The port's server reports each solve's kernel launches beside the
    assignment (none on the CPU, where the plain version runs)."""
    client = sidecar.SidecarSolver(port_server, timeout=WAIT_S)
    pending, nodes, assigned, services = workload.policy_objects(40, 6, seed=3)
    got = client.solve(pending, nodes, assigned, services,
                       spec=spec_from_policy(workload.FULL_VOCABULARY_POLICY))
    assert got == schedule_backlog_tpu(pending, nodes, assigned, services, spec=_policy_spec_jax())
    assert client.last_kernel_launches == {"scan_kernel": 0, "policy_scan_kernel": 0}


def test_unported_mode_is_a_structured_error_and_the_server_survives(port_server):
    """Every mode the JAX server answers is ported, so what is left to
    fail is the solve itself: a request without its snapshot comes back
    as a structured error, for each mode, and the server goes on."""
    client = jsidecar.SidecarSolver(port_server, timeout=WAIT_S)
    for mode in ("scan", "wave", "sinkhorn"):
        reply = client._request({"op": "solve", "mode": mode}, WAIT_S)
        assert reply["error"].startswith("KeyError"), reply
    pending, nodes, assigned, services = random_cluster(2)
    assert client.solve(pending, nodes, assigned, services, mode="wave") is not None
    assert client.ping()


@pytest.mark.parametrize("mode", ["wave", "sinkhorn"])
@pytest.mark.parametrize("case", ["default", "policy"])
def test_jax_client_windowed_modes_from_the_port_server(port_server, mode, case):
    """The JAX daemon's `--batch-mode wave|sinkhorn --solver-sidecar`
    request against the port's server: the wave's names equal the JAX
    package's own wave solve, Sinkhorn's agree on 99% of the pods, and
    a policy in the request is ignored, as the JAX server ignores it."""
    from kubernetes_tpu.scheduler.batch import schedule_backlog_sinkhorn, schedule_backlog_wave

    client = jsidecar.SidecarSolver(port_server, timeout=WAIT_S)
    pending, nodes, assigned, services = workload.policy_objects(300, 24, seed=6)
    spec = _policy_spec_jax() if case == "policy" else None
    remote = client.solve(pending, nodes, assigned, services, mode=mode, spec=spec)
    local = (schedule_backlog_wave if mode == "wave" else schedule_backlog_sinkhorn)(
        pending, nodes, assigned, services)
    if mode == "wave":
        assert remote == local
    else:
        assert np.mean([a == b for a, b in zip(remote, local)]) >= 0.99
    assert sum(r is not None for r in remote) > 100
    port = sidecar.SidecarSolver(port_server, timeout=WAIT_S)
    assert port.solve(pending, nodes, assigned, services, mode=mode) == remote
    assert port.last_kernel_launches == {"scan_kernel": 0, "policy_scan_kernel": 0}


def test_garbage_frame_does_not_kill_the_port_server(port_server):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(WAIT_S)
    s.connect(port_server)
    s.sendall(b"GARBAGE" * 100)
    s.close()
    assert sidecar.SidecarSolver(port_server).ping()
    assert jsidecar.SidecarSolver(port_server).ping()


def test_jax_batch_scheduler_binds_through_the_port_server(port_server):
    api = APIServer()
    client = Client(LocalTransport(api))
    for j in range(3):
        client.create("nodes", node_wire(f"n{j}"))
    for i in range(9):
        client.create("pods", pod_wire(f"p{i}"))
    cfg = SchedulerConfig(Client(LocalTransport(api))).start()
    try:
        assert cfg.wait_for_sync()
        sched = BatchScheduler(cfg, sidecar_path=port_server)
        sched.sidecar.timeout = WAIT_S
        processed = 0
        deadline = time.monotonic() + WAIT_S
        while processed < 9 and time.monotonic() < deadline:
            processed += sched.schedule_batch(timeout=0.5)
        pods, _ = client.list("pods", namespace="default")
        assert len(pods) == 9 and all(p.spec.node_name for p in pods)
        assert sched.fallback_count == 0
    finally:
        cfg.stop()


def test_port_client_gets_jax_decisions_from_the_jax_server():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc, sock_path = jsidecar.spawn_sidecar(wait=WAIT_S, env=env)
    try:
        client = sidecar.SidecarSolver(sock_path, timeout=WAIT_S)
        assert client.ping()
        pending, nodes, assigned, services = workload.policy_objects(80, 12, seed=2)
        for port_spec, jax_spec in ((None, None), (spec_from_policy(workload.FULL_VOCABULARY_POLICY),
                                                   _policy_spec_jax())):
            remote = client.solve(pending, nodes, assigned, services, spec=port_spec)
            assert remote == schedule_backlog_tpu(pending, nodes, assigned, services, spec=jax_spec)
            assert client.last_kernel_launches is None  # the JAX server reports none
    finally:
        _stop(proc)
        shutil.rmtree(os.path.dirname(sock_path), ignore_errors=True)


def test_entry_point_without_a_card_exits_nonzero(tmp_path):
    """Without `--device cpu` the server wants the CUDA card; here there
    is none, so it exits non-zero before serving."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    sock_path = str(tmp_path / "s.sock")
    run = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.ops.sidecar", sock_path],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=WAIT_S,
    )
    assert run.returncode != 0
    assert "CUDA" in run.stderr
    assert not os.path.exists(sock_path)
