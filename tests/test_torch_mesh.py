"""The port's node-sharded mesh against the JAX package's, on the CPU.

`tests/conftest.py` forces JAX onto eight CPU devices, so the JAX
package's solvers run sharded over a real `jax.sharding.Mesh` from its
`host_mesh`. The port's meshes come from its own `host_mesh` with
`devices=("cpu",) * n`: every shard in this process, on the CPU, with
the sharded scan's plain shard step (the kernel's plain version; the
kernel itself is held to it in `tests/test_torch_kernel_emulation.py`).

On meshes of 2, 4 and 8 shards, over the parity fuzz clusters of
`tests/test_solver_parity.py` (1 to 12 nodes, padded so the mesh
divides them: most shards hold padding only, and the padding sits on
the last shards) and a backlog of 120 pods on 45 nodes:

- staging: `device_snapshot(mesh=)` stitched back equals the JAX
  package's sharded staging and the port's unsharded one;
- the scan (decisions and the nine carry fields) and the wave
  (decisions, carry, wave count) bit-equal to the JAX package's
  sharded solves and to the port's unsharded ones;
- Sinkhorn: prices within 1e-4 of JAX's on a congested matrix cut into
  shards, decisions at least 99% equal to JAX's sharded solve and equal
  to the port's unsharded one, every placement valid by the port's
  oracle;
- `solve_backlog_pipelined(mesh=)` in all three modes, `explain_backlog
  (mesh=)`, `schedule_backlog(mesh=)` and its wave and Sinkhorn
  siblings against the JAX package's with the same mesh size, and the
  gang solve against the port's unsharded one;
- `SolverSession(mesh=)` tick by tick against the JAX session on a
  mesh;
- `env_mesh` and `resolve_batch_mode` on the same cases as JAX's,
  warnings included (the port's CUDA device count is patched to eight,
  as JAX sees eight CPU devices here).
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from __graft_entry__ import _synthetic_objects
from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot
from kubernetes_tpu.ops import device_snapshot as jdevice_snapshot
from kubernetes_tpu.ops import sinkhorn as jsinkhorn
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.ops import wave as jwave
from kubernetes_tpu.ops.pipeline import explain_backlog as jexplain_backlog
from kubernetes_tpu.ops.pipeline import solve_backlog_pipelined as jpipelined
from kubernetes_tpu.scheduler import batch as jbatch
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.ops import oracle, sinkhorn, wave
from kubernetes_tpu_torch.ops.matrices import (
    CARRY_KEYS, Mesh, ShardedNodes, device_snapshot, host_mesh, node_axis_multiple,
    shard_nodes, shardings_for, state_to_numpy)
from kubernetes_tpu_torch.ops.pipeline import explain_backlog, solve_backlog_pipelined
from kubernetes_tpu_torch.ops.solver import solve_assignments, solve_with_state
from kubernetes_tpu_torch.scheduler import batch
from tests.test_solver_parity import random_cluster

MESHES = (2, 4, 8)
PRICE_ATOL = 1e-4
AGREEMENT = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n):
    mesh = host_mesh(n, devices=("cpu",) * n)
    assert mesh is not None and mesh.size == n
    return mesh


def _pad(n):
    """The JAX multichip tests' padding: a multiple of 8 or of the mesh."""
    return max(8, n)


def _both_snapshots(objects, n, pad_to=None):
    """(JAX sharded snapshot, its mesh, port sharded snapshot, port
    unsharded snapshot) of the same objects."""
    pending, nodes, assigned, services = objects
    from kubernetes_tpu.ops import matrices as jmatrices

    pad_to = _pad(n) if pad_to is None else pad_to
    jmesh = jmatrices.host_mesh(n)
    jd = jdevice_snapshot(jbuild_snapshot(pending, nodes, assigned, services), mesh=jmesh,
                          pad_to=pad_to)
    # Two lowerings: staging on the CPU shares a snapshot's arrays where
    # no padding copies them, and each solve commits into its own.
    return (jd, jmesh,
            device_snapshot(build_snapshot(pending, nodes, assigned, services), pad_to=pad_to,
                            mesh=cpu_mesh(n)),
            device_snapshot(build_snapshot(pending, nodes, assigned, services), "cpu",
                            pad_to=pad_to))


def _carry_equal(got, *refs):
    """`got`'s carry (sharded or not) equals each of `refs` (tensors or
    numpy arrays), dtype and bits."""
    got = state_to_numpy(got)
    for ref in refs:
        if isinstance(ref, ShardedNodes) or any(torch.is_tensor(v) for v in ref.values()):
            ref = state_to_numpy(ref)
        for k in CARRY_KEYS:
            r = np.asarray(ref[k])
            assert got[k].dtype == r.dtype and np.array_equal(got[k], r), f"carry field {k} differs"


@pytest.fixture(scope="module")
def backlog():
    """120 pods on 45 nodes (services, ports, selectors): a node count no
    mesh here divides."""
    jobjs = _synthetic_objects(120, 45, seed=13)
    return {"jax": jobjs, "port": workload.synthetic_objects(120, 45, seed=13)}


# -- the mesh and the staging -----------------------------------------------


def test_host_mesh_as_jax():
    """n < 2 or too few devices: None, as JAX's. The devices of a mesh
    are its shards' in order; `node_axis_multiple` is JAX's rule."""
    from kubernetes_tpu.ops import matrices as jmatrices

    assert host_mesh(1, devices=("cpu",)) is None and jmatrices.host_mesh(1) is None
    assert host_mesh(3, devices=("cpu",) * 2) is None
    assert jmatrices.host_mesh(9) is None
    if not torch.cuda.is_available():
        assert host_mesh(2) is None
    for n in MESHES:
        mesh = cpu_mesh(n)
        jmesh = jmatrices.host_mesh(n)
        assert mesh.shape == dict(jmesh.shape) and mesh.axis_names == tuple(jmesh.axis_names)
        for pad_to in (1, 8, 128):
            assert node_axis_multiple(mesh, pad_to) == jmatrices.node_axis_multiple(jmesh, pad_to)
        assert shardings_for(mesh) == (mesh.devices, mesh.first)
        assert mesh.ranges(8 * n)[-1] == (8 * (n - 1), 8 * n)
    mixed = host_mesh(2, devices=("cpu", torch.device("cpu")))
    assert mixed.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        cpu_mesh(4).ranges(6)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("seed", [0, 3])
def test_sharded_staging_equals_jax(seed, n):
    jd, _, d, u = _both_snapshots(random_cluster(seed), n)
    assert isinstance(d.nodes, ShardedNodes) and d.mesh.size == n
    assert d.nodes.ranges == d.mesh.ranges(d.nodes.n_padded)
    stitched, flat = state_to_numpy(d.nodes), state_to_numpy(u.nodes)
    for k, v in jd.nodes.items():
        ref = np.asarray(v)
        assert np.array_equal(stitched[k], ref) and np.array_equal(flat[k], ref), k
    for k, v in jd.pods.items():
        got = state_to_numpy({k: d.pods[k]})[k]
        assert np.array_equal(got, np.asarray(v)), k
    # Padding nodes are unschedulable and sit at the end, on the last shards.
    assert not stitched["sched"][d.n_nodes:].any()
    assert d.nodes.ranges[-1][1] == d.nodes.n_padded >= d.n_nodes


# -- the scan -----------------------------------------------------------------


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("seed", [0, 1, 3, 9])
def test_sharded_scan_bit_equal(seed, n):
    """Decisions and carry equal to JAX's sharded scan and to the port's
    unsharded scan."""
    jd, jmesh, d, u = _both_snapshots(random_cluster(seed), n)
    with jmesh:
        jchoice, jnodes = jsolver.solve_with_state(jd.pods, jd.nodes)
        jchoice = np.asarray(jchoice)
        jnodes = {k: np.asarray(v) for k, v in jnodes.items()}
    choice, nodes = solve_with_state(d.pods, d.nodes)
    ref, ref_nodes = solve_with_state(u.pods, u.nodes)
    assert np.array_equal(choice.numpy(), jchoice)
    assert torch.equal(choice, ref)
    _carry_equal(nodes, jnodes, ref_nodes)


def test_sharded_scan_backlog_and_assignments(backlog):
    """120 pods on 45 nodes over 4 shards of 32 (the staging's own
    padding, the shapes `schedule_backlog` stages): `solve_assignments`
    equals JAX's and the port's unsharded one, and leaves the caller's
    carry as it was."""
    pending, nodes, services = backlog["jax"]
    jd, jmesh, d, u = _both_snapshots((pending, nodes, (), services), 4, pad_to=128)
    before = state_to_numpy(d.nodes)
    with jmesh:
        want = jsolver.solve_assignments(jd)
    got = solve_assignments(d)
    assert np.array_equal(got, want) and np.array_equal(got, solve_assignments(u))
    after = state_to_numpy(d.nodes)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_sharded_scan_rejects_a_policy_spec():
    from kubernetes_tpu_torch.models.algspec import LoweredSpec

    _, _, d, _ = _both_snapshots(random_cluster(0), 2)
    with pytest.raises(ValueError, match="policy spec"):
        solve_with_state(d.pods, d.nodes, (1, 1, 1), LoweredSpec(node_label=True))


# -- the wave -----------------------------------------------------------------


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("seed", [1, 3])
def test_sharded_wave_bit_equal(seed, n):
    jd, jmesh, d, u = _both_snapshots(random_cluster(seed), n)
    with jmesh:
        ja, jnodes, jw = jwave.solve_waves_with_state(jd.pods, jd.nodes, window=8)
        ja = np.asarray(ja)
        jnodes = {k: np.asarray(v) for k, v in jnodes.items()}
    a, nodes, w = wave.solve_waves_with_state(d.pods, d.nodes, window=8)
    ra, ref_nodes, rw = wave.solve_waves_with_state(u.pods, u.nodes, window=8)
    assert np.array_equal(a.numpy(), ja) and torch.equal(a, ra)
    assert w == int(jw) == rw
    _carry_equal(nodes, jnodes, ref_nodes)


def test_sharded_wave_backlog(backlog):
    pending, nodes, services = backlog["jax"]
    jd, jmesh, d, u = _both_snapshots((pending, nodes, (), services), 4, pad_to=128)
    with jmesh:
        want, jw = jwave.wave_assignments(jd)
    got, w = wave.wave_assignments(d)
    ref, rw = wave.wave_assignments(u)
    assert np.array_equal(got, want) and np.array_equal(got, ref) and w == jw == rw


# -- Sinkhorn -----------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("tol", [0.0, 1.0])
def test_sharded_prices_within_tolerance(n, tol):
    """A congested 64 x 12 matrix cut over n shards: prices, iterations
    and residual against JAX's unsharded `_congestion_prices`."""
    rng = np.random.default_rng(n)
    W, N = 64, 12
    masked = rng.integers(0, 31, size=(W, N)).astype(np.float32)
    masked[:, :3] += 10
    masked[rng.random((W, N)) < 0.3] = -1
    masked[:4] = -1
    valid = rng.random(W) < 0.9
    capacity = rng.choice([0, 1, 2, 5], size=N).astype(np.float32)
    rg, ri, rr = jsinkhorn._congestion_prices(
        jnp.asarray(masked), jnp.asarray(valid), jnp.asarray(capacity), 2.0, 20, tol)
    mesh = Mesh((torch.device("cpu"),) * n)
    cut = np.array_split(np.arange(N), n)
    nodes = ShardedNodes(mesh, [{"cpu_cap": torch.zeros(len(c))} for c in cut])
    g, i, r = sinkhorn._congestion_prices_sharded(
        [torch.from_numpy(masked[:, c]) for c in cut], torch.from_numpy(valid),
        [torch.from_numpy(capacity[c]) for c in cut], nodes, 2.0, 20, tol)
    assert int(i) == int(ri) and int(i) >= 1
    assert np.allclose(torch.cat(g).numpy(), np.asarray(rg), rtol=0, atol=PRICE_ATOL)
    assert abs(float(r) - float(rr)) <= PRICE_ATOL


def test_sharded_sinkhorn_backlog(backlog):
    pending, nodes, services = backlog["jax"]
    jd, jmesh, d, u = _both_snapshots((pending, nodes, (), services), 4, pad_to=128)
    with jmesh:
        want, _ = jsinkhorn.sinkhorn_assignments(jd)
    got, _ = sinkhorn.sinkhorn_assignments(d)
    ref, _ = sinkhorn.sinkhorn_assignments(u)
    assert float((got == want).mean()) >= AGREEMENT
    assert np.array_equal(got, ref)
    ppending, pnodes, pservices = backlog["port"]
    oracle.validate_assignment_numpy(build_snapshot(ppending, pnodes, services=pservices), got)


@pytest.mark.parametrize("seed", [1, 3])
def test_sharded_sinkhorn_fuzz(seed):
    jd, jmesh, d, u = _both_snapshots(random_cluster(seed), 4)
    with jmesh:
        want, _ = jsinkhorn.solve_sinkhorn(jd.pods, jd.nodes, window=8)
    got, _ = sinkhorn.solve_sinkhorn(d.pods, d.nodes, window=8)
    ref, _ = sinkhorn.solve_sinkhorn(u.pods, u.nodes, window=8)
    assert float((got.numpy() == np.asarray(want)).mean()) >= AGREEMENT
    assert torch.equal(got, ref)


# -- the entry points -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["scan", "wave", "sinkhorn"])
def test_pipelined_on_a_mesh(backlog, mode):
    """Two chunks of 60 pods over the carry sharded four ways."""
    from kubernetes_tpu.ops import matrices as jmatrices

    pending, nodes, services = backlog["jax"]
    jmesh = jmatrices.host_mesh(4)
    with jmesh:
        want = jpipelined(pending, nodes, (), services, mesh=jmesh, chunk=60, mode=mode)
    ppending, pnodes, pservices = backlog["port"]
    got = solve_backlog_pipelined(ppending, pnodes, (), pservices, chunk=60, mode=mode,
                                  mesh=cpu_mesh(4))
    flat = solve_backlog_pipelined(ppending, pnodes, (), pservices, chunk=60, mode=mode,
                                   device="cpu")
    assert got == flat
    agree = np.mean([a == b for a, b in zip(got, want)])
    assert agree == 1.0 if mode != "sinkhorn" else agree >= AGREEMENT


@pytest.mark.parametrize("seed", [1, 3])
def test_explain_backlog_on_a_mesh(seed):
    from kubernetes_tpu.ops import matrices as jmatrices

    pending, nodes, assigned, services = random_cluster(seed)
    jmesh = jmatrices.host_mesh(4)
    with jmesh:
        want = jexplain_backlog(pending, nodes, assigned, services, mesh=jmesh)
    got = explain_backlog(pending, nodes, assigned, services, mesh=cpu_mesh(4))
    assert got == want
    assert got == explain_backlog(pending, nodes, assigned, services, device="cpu")


def test_schedule_backlog_family_on_a_mesh(backlog):
    from kubernetes_tpu.ops import matrices as jmatrices

    pending, nodes, services = backlog["jax"]
    ppending, pnodes, pservices = backlog["port"]
    jmesh, mesh = jmatrices.host_mesh(4), cpu_mesh(4)
    with jmesh:
        jscan = jbatch.schedule_backlog_tpu(pending, nodes, (), services, mesh=jmesh)
        jw = jbatch.schedule_backlog_wave(pending, nodes, (), services, mesh=jmesh)
        js = jbatch.schedule_backlog_sinkhorn(pending, nodes, (), services, mesh=jmesh)
    assert batch.schedule_backlog(ppending, pnodes, (), pservices, mesh=mesh) == jscan
    assert batch.schedule_backlog_wave(ppending, pnodes, (), pservices, mesh=mesh) == jw
    got = batch.schedule_backlog_sinkhorn(ppending, pnodes, (), pservices, mesh=mesh)
    assert np.mean([a == b for a, b in zip(got, js)]) >= AGREEMENT
    assert got == batch.schedule_backlog_sinkhorn(ppending, pnodes, (), pservices, device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_schedule_backlog_gang_on_a_mesh(seed):
    """Gangs over a mesh of 4 equal the port's unsharded gang solve
    (held to the JAX package's in `tests/test_torch_gang.py`)."""
    from kubernetes_tpu_torch.scheduler.gang import partition_backlog
    from tests.test_torch_gang import _grouped_cluster, _keys

    pending, nodes, assigned, services, mm = _grouped_cluster(seed)
    got = batch.schedule_backlog_gang(
        pending, nodes, assigned, services, groups=partition_backlog(pending, assigned, mm),
        mesh=cpu_mesh(4))
    want = batch.schedule_backlog_gang(
        pending, nodes, assigned, services, groups=partition_backlog(pending, assigned, mm),
        device="cpu")
    assert got[0] == want[0]
    assert _keys(got[1]) == _keys(want[1]) and _keys(got[2]) == _keys(want[2])


# -- env_mesh and resolve_batch_mode ----------------------------------------------


@pytest.fixture
def eight_cards(monkeypatch):
    """The port sees eight CUDA devices, as JAX sees eight CPU devices
    here (host_mesh only names them), and both packages' warn-once flags
    start clear."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for mod in (batch, jbatch):
        monkeypatch.setattr(mod, "_ENV_MESH_WARNED", False)
        monkeypatch.setattr(mod, "_AUTO_NO_MESH_WARNED", False)


def _warnings(caplog, logger):
    return [r for r in caplog.records if r.name == logger and r.levelno == logging.WARNING]


@pytest.mark.parametrize("raw", [None, "8", "2", "1", "0", "-3", "not-a-number", "1000000", " 4 "])
def test_env_mesh_and_auto_as_jax(eight_cards, monkeypatch, caplog, raw):
    """Each value twice: the same mesh size (or none), the same resolved
    mode, and the same warnings, each only the first time."""
    if raw is None:
        monkeypatch.delenv("KT_MESH_DEVICES", raising=False)
    else:
        monkeypatch.setenv("KT_MESH_DEVICES", raw)
    caplog.set_level(logging.WARNING)
    for _ in range(2):
        jm, pm = jbatch.env_mesh(), batch.env_mesh()
        assert (jm is None) == (pm is None)
        if pm is not None:
            assert pm.size == jm.devices.size
            assert pm.devices == tuple(torch.device("cuda", i) for i in range(pm.size))
        assert batch.resolve_batch_mode("auto") == jbatch.resolve_batch_mode("auto")
    jw, pw = _warnings(caplog, jbatch.__name__), _warnings(caplog, batch.__name__)
    assert len(pw) == len(jw) <= 2
    for mode in ("scan", "wave", "sinkhorn"):
        assert batch.resolve_batch_mode(mode) == jbatch.resolve_batch_mode(mode) == mode


def test_auto_with_a_mesh_picks_the_wave(eight_cards, monkeypatch, caplog):
    monkeypatch.delenv("KT_MESH_DEVICES", raising=False)
    caplog.set_level(logging.WARNING)
    assert batch.resolve_batch_mode("auto", mesh=cpu_mesh(2)) == "wave"
    assert batch.resolve_batch_mode("auto", mesh=object()) == "wave"
    assert not _warnings(caplog, batch.__name__)
    assert batch.resolve_batch_mode("auto") == "scan"
    assert batch.resolve_batch_mode("auto") == "scan"
    assert len(_warnings(caplog, batch.__name__)) == 1


def test_one_card_mesh_holds_every_shard():
    """`devices=` may name one device for every shard (the one-card
    mesh of the smoke); `shard_nodes` cuts an unsharded dict the same
    way `device_snapshot(mesh=)` stages it."""
    _, _, d, u = _both_snapshots(random_cluster(1), 4)
    again = shard_nodes(u.nodes, d.mesh)
    assert again.ranges == d.nodes.ranges
    a, b = state_to_numpy(again), state_to_numpy(d.nodes)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    # Fresh tensors: committing into the cut leaves the source alone.
    again.shards[0]["pods_used"] += 1
    assert not torch.equal(again.shards[0]["pods_used"], u.nodes["pods_used"][:again.ranges[0][1]])


# -- the incremental session ------------------------------------------------------


@pytest.mark.parametrize("mode", ["scan", "wave", "sinkhorn"])
def test_session_on_a_mesh_matches_jax(monkeypatch, mode):
    """`tests/test_torch_incremental.py`'s seeded churn (node upserts and
    removals, foreign pods, deletes, soft pins) with both sessions on a
    mesh of 4: after every tick the results, the host mirror and every
    device leaf (the port's stitched back) equal the JAX session's."""
    from kubernetes_tpu.ops import SolverSession as JSolverSession
    from kubernetes_tpu.ops import matrices as jmatrices
    from kubernetes_tpu_torch.ops import SolverSession
    import tests.test_torch_incremental as incremental

    class MeshTwin(incremental.Twin):
        def __init__(self, nodes, services=(), assigned=(), **kw):
            self.j = JSolverSession(nodes, services=services, assigned=assigned,
                                    mesh=jmatrices.host_mesh(4), **kw)
            self.t = SolverSession(nodes, services=services, assigned=assigned,
                                   mesh=cpu_mesh(4), **kw)
            assert isinstance(self.t.dev, ShardedNodes)
            self.assert_same("build")

    monkeypatch.setattr(incremental, "Twin", MeshTwin)
    tw = incremental._seeded_churn(2, mode)
    assert tw.t.dev.mesh.size == 4 and tw.t.device == torch.device("cpu")


def test_session_prewarm_on_a_mesh_leaves_the_state():
    from kubernetes_tpu_torch.ops import SolverSession

    pending, nodes, services = workload.synthetic_objects(40, 12, seed=3)
    session = SolverSession(nodes, services, mesh=cpu_mesh(2))
    before = state_to_numpy(session.dev)
    assert session.prewarm(max_pod_bucket=256, max_scatter_width=16) == 4
    after = state_to_numpy(session.dev)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    flat = SolverSession(nodes, services, device="cpu")
    for pod in pending:
        session.add_pending(pod)
        flat.add_pending(pod)
    assert session.solve() == flat.solve()


def test_plain_shard_step_reads_nothing_back():
    """The sharded plain scan only enqueues work: no operation of a
    whole solve reads a value back to the host (`_local_scalar_dense`
    is what `.item()` and indexing by a 0-dim tensor dispatch), so on a
    card the plain version is not held up by a wait a step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from kubernetes_tpu_torch.ops import shard_scan

    class Reads(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                Reads.count += 1
            return func(*args, **(kwargs or {}))

    _, _, d, u = _both_snapshots(random_cluster(0), 4)
    with Reads():
        choice, _ = shard_scan.plain_sharded_scan_with_state(d.pods, d.nodes)
    assert Reads.count == 0
    assert torch.equal(choice, solve_with_state(u.pods, u.nodes)[0])
