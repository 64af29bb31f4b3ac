"""The port's soak harness (`kubernetes_tpu_torch/soak.py`) against the
JAX package's (`tools/soak.py`).

- `build_schedule` returns JAX's schedule entry for entry, for seeds
  0-9 at 6, 200 and 1,000 nodes, and for subsets of the epochs;
- the artifact carries JAX's keys;
- two miniature runs on the CPU (hollow fleet, the durable store, the
  incremental daemon on the plain scan): an apiserver kill -9 (a torn
  WAL write, a crash, a replay) and a daemon killed mid-gang by the
  `scheduler.commit.crash` seam, each with zero invariant violations
  and the fault registry disarmed after it; the second runs with the
  port's lock sanitizer on and ends with no finding;
- with `cuda` and no card, `run_soak` raises before anything starts.
"""

import ast
import os

import pytest

from kubernetes_tpu_torch import soak
from kubernetes_tpu_torch.utils import faults
from tests.torch_ktsan import torch_ktsan  # noqa: F401
from tools import soak as jax_soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    faults.clear()
    faults.reset_stats(reseed=0)
    yield
    faults.clear()


@pytest.fixture(autouse=True)
def _process_planes_kept(monkeypatch):
    """A soak configures the process-wide retention, alert engine,
    monitors and recorder: each test gets fresh ones, so the files that
    run after it in the same worker find theirs as they left them."""
    from kubernetes_tpu_torch.utils import alerts, capacity, flightrecorder, rebalance, timeseries

    retention = timeseries.Retention()
    sampler = timeseries.Sampler(retention)
    monkeypatch.setattr(timeseries, "DEFAULT", retention)
    monkeypatch.setattr(timeseries, "SAMPLER", sampler)
    monkeypatch.setattr(alerts, "DEFAULT", alerts.AlertEngine(retention=retention))
    monkeypatch.setattr(capacity, "DEFAULT", capacity.CapacityMonitor())
    monkeypatch.setattr(rebalance, "DEFAULT", rebalance.RebalanceMonitor())
    monkeypatch.setattr(flightrecorder, "DEFAULT", flightrecorder.FlightRecorder())
    yield
    sampler.stop()


def test_the_epochs_are_jaxs():
    assert soak.EPOCHS == jax_soak.EPOCHS
    assert soak.SOAK_ALERT_SCALE == jax_soak.SOAK_ALERT_SCALE
    assert soak.ALERT_SAMPLE_S == jax_soak.ALERT_SAMPLE_S
    assert ([(r.name, r.threshold) for r in soak._soak_alert_rules()]
            == [(r.name, r.threshold) for r in jax_soak._soak_alert_rules()])


@pytest.mark.parametrize("n_nodes", [6, 200, 1000])
@pytest.mark.parametrize("seed", range(10))
def test_build_schedule_is_jaxs(seed, n_nodes):
    port = soak.build_schedule(seed, n_nodes=n_nodes)
    assert port == jax_soak.build_schedule(seed, n_nodes=n_nodes)
    assert port == soak.build_schedule(seed, n_nodes=n_nodes)  # pure
    for entry in port:
        if "rule" in entry:
            assert entry["rule"]["site"] in faults.SITES


@pytest.mark.parametrize("epochs", [
    ["baseline", "apiserver_restart"],
    ["final", "preemption_storm", "baseline"],
    ["baseline", "apiserver_restart", "daemon_restart_mid_gang", "preemption_storm",
     "defrag_daemon_crash", "final"],
])
def test_build_schedule_of_a_subset_is_jaxs(epochs):
    assert soak.build_schedule(7, epochs, 200) == jax_soak.build_schedule(7, epochs, 200)
    with pytest.raises(ValueError, match="unknown epoch"):
        soak.build_schedule(1, epochs=["nope"])


def _artifact_keys(path):
    """The keys of the `artifact = {...}` literal in a soak module."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "artifact" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no artifact literal in {path}")


def test_the_artifact_keys_are_jaxs():
    assert (_artifact_keys(soak.__file__)
            == _artifact_keys(os.path.join(ROOT, "tools", "soak.py")))


def test_cuda_without_a_card_raises_before_anything_starts(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "data"
    with pytest.raises(RuntimeError, match="CUDA"):
        soak.run_soak(n_nodes=6, seed=1, epochs=["baseline"], data_dir=str(data),
                      verbose=False)
    assert not data.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        soak.main(["--nodes", "6", "--epochs", "baseline", "--quiet"])


def test_mini_soak_apiserver_crash_epoch():
    """Hollow fleet + incremental daemon + an apiserver kill -9 (torn
    WAL write, crash, replay): zero invariant violations, every wave pod
    bound, the mirror equal to the store across the restart."""
    artifact = soak.run_soak(n_nodes=6, seed=11, epochs=["baseline", "apiserver_restart"],
                             fsync=False, verbose=False, device="cpu")
    assert artifact["invariant_violations"] == [], artifact
    assert artifact["restarts"]["apiserver"] == 1
    assert artifact["pods_bound"] >= 64  # two 32-pod waves
    assert artifact["bind_p99_s"] is not None
    assert artifact["faults_injected"]["kvstore.wal.torn_write"]["fired"] == 1
    assert not faults.enabled()  # run_soak leaves the registry off


@pytest.mark.usefixtures("torch_ktsan")
def test_mini_soak_daemon_restart_mid_gang_sanitized():
    """The commit seam kills the daemon before the gang tick's binds
    land; a fresh daemon rebuilds from LIST+watch and binds every gang
    whole. The port's sanitizer is on for the whole run and the guard
    fails the test on any finding."""
    artifact = soak.run_soak(n_nodes=6, seed=11, epochs=["baseline", "daemon_restart_mid_gang"],
                             fsync=False, verbose=False, device="cpu")
    assert artifact["invariant_violations"] == [], artifact
    assert artifact["restarts"] == {"apiserver": 0, "scheduler": 1}
    assert artifact["faults_injected"]["scheduler.commit.crash"]["fired"] == 1
    entry = artifact["schedule"][1]
    assert artifact["pods_bound"] >= 32 + entry["warmup_pods"] + entry["gangs"] * entry["gang_size"]
    assert not faults.enabled()
