"""The port's host lowering helper equals the JAX package's and its own
NumPy versions, bit for bit.

`kubernetes_tpu_torch/csrc/columnar.cc` (bound by
`kubernetes_tpu_torch/native.py`, built with g++ at first use) is the
port's copy of `native/columnar.cc`. Each helper runs on the same seeded
inputs through the port's binding, the JAX binding
(`kubernetes_tpu.native`, over its own library built by its own
`ensure_built()`), and the port's NumPy versions in
`models/columnar.py`; every output must be equal exactly (tolerance:
none). The JAX binding builds into a private copy of `native/` here, so
this file never races `tests/test_native.py`'s build of the repo's.
`build_snapshot` must be the same through the helper and through the
NumPy versions, and equal to the JAX package's.
"""

import os
import shutil
import types

import numpy as np
import pytest

from kubernetes_tpu import native as jnative
from kubernetes_tpu.models import algspec as jalgspec
from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot
from kubernetes_tpu_torch import native, workload
from kubernetes_tpu_torch.models import algspec, columnar
from kubernetes_tpu_torch.ops import build, ledger
from tests.test_torch_columnar import _assert_snapshots_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX binding, built by its own ensure_built() (its Makefile)
    into a private copy of the repo's native/ directory."""
    root = tmp_path_factory.mktemp("jax_native_root")
    shutil.copytree(os.path.join(REPO, "native"), root / "native",
                    ignore=shutil.ignore_patterns("build"))
    saved = {k: getattr(jnative, k) for k in
             ("_REPO_ROOT", "_LIB_PATH", "_SOURCES", "_lib", "_load_attempted")}
    jnative._REPO_ROOT = str(root)
    jnative._LIB_PATH = str(root / "native" / "build" / "libkubetpu.so")
    jnative._SOURCES = (str(root / "native" / "columnar.cc"), str(root / "native" / "Makefile"))
    jnative._lib, jnative._load_attempted = None, False
    try:
        assert jnative.ensure_built(), "the JAX package's native build failed"
        assert jnative.available()
        yield jnative
    finally:
        for k, v in saved.items():
            setattr(jnative, k, v)


PLAIN = types.SimpleNamespace(
    pack_bitsets=columnar.pack_bitsets,
    or_rows_by_index=columnar.or_rows_by_index,
    greedy_fit=columnar.greedy_fit,
)


def _three(jax_native):
    return (("port", native), ("jax", jax_native), ("numpy", PLAIN))


# -- pack_bitsets ---------------------------------------------------------


def _id_lists(seed, n, words):
    rng = np.random.default_rng(seed)
    out = [sorted(rng.choice(words * 32, size=rng.integers(0, 5), replace=False).tolist())
           for _ in range(n)]
    out[0] = [0, 31, 32, 63][: 2 * words]  # word edges
    out[1] = []
    return out


@pytest.mark.parametrize("seed,n,words", [(0, 50, 2), (1, 200, 4), (2, 3, 1), (3, 64, 3)])
def test_pack_bitsets_equal(jax_native, seed, n, words):
    ids = _id_lists(seed, n, words)
    outs = {name: mod.pack_bitsets(ids, words) for name, mod in _three(jax_native)}
    for name, got in outs.items():
        assert got.dtype == np.uint32 and got.shape == (n, words), name
        assert np.array_equal(got, outs["numpy"]), name


def test_pack_bitsets_empty_rows_and_range(jax_native):
    for name, mod in _three(jax_native):
        assert mod.pack_bitsets([], 2).shape == (0, 2), name
        assert not mod.pack_bitsets([[], [], []], 2).any(), name
    for bad in ([[64]], [[-1]]):
        with pytest.raises(IndexError):
            native.pack_bitsets(bad, 2)
        with pytest.raises(IndexError):
            columnar.pack_bitsets(bad, 2)


# -- or_rows_by_index -----------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_or_rows_by_index_equal(jax_native, seed):
    rng = np.random.default_rng(10 + seed)
    A, N, W = 300, 17, 2 + seed % 2
    node_idx = rng.integers(-1, N, size=A).astype(np.int32)  # -1: skipped
    pod_rows = columnar.pack_bitsets(_id_lists(seed, A, W), W)
    base = rng.integers(0, 2**32, size=(N, W), dtype=np.uint64).astype(np.uint32)
    base[::3] = 0
    outs = {}
    for name, mod in _three(jax_native):
        rows = base.copy()
        mod.or_rows_by_index(node_idx, pod_rows, rows)
        outs[name] = rows
    for name, rows in outs.items():
        assert np.array_equal(rows, outs["numpy"]), name


def test_or_rows_by_index_checks_before_the_call():
    rows = np.zeros((4, 2), np.uint32)
    with pytest.raises(IndexError):
        native.or_rows_by_index(np.array([4], np.int32), np.zeros((1, 2), np.uint32), rows)
    with pytest.raises(ValueError):  # a strided output would take no writes
        native.or_rows_by_index(np.array([0], np.int32), np.zeros((1, 2), np.uint32),
                                np.zeros((4, 4), np.uint32)[:, :2])
    with pytest.raises(ValueError):
        native.or_rows_by_index(np.array([0], np.int32), np.zeros((1, 3), np.uint32), rows)


# -- greedy_fit -----------------------------------------------------------


def _fit_case(seed):
    """Seeded assigned pods: unassigned ones (-1), zero capacities (no
    limit), nodes overcommitted in list order, and f32 sums that round
    (values past 2^24 and fractions)."""
    rng = np.random.default_rng(20 + seed)
    A, N = 400, 23
    node_idx = rng.integers(-1, N, size=A).astype(np.int32)
    cpu = rng.choice([0.0, 100.0, 250.5, 1000.0, 3333.3], size=A).astype(np.float32)
    mem = rng.choice([0.0, 64.0, 1024.0, 16777217.0, 0.1], size=A).astype(np.float32)
    cpu_cap = rng.choice([0.0, 2000.0, 4000.0, 16000.0], size=N).astype(np.float32)
    mem_cap = rng.choice([0.0, 4096.0, 3.0e7, 16777216.0], size=N).astype(np.float32)
    return node_idx, cpu, mem, cpu_cap, mem_cap


def _run_fit(mod, case):
    node_idx, cpu, mem, cpu_cap, mem_cap = case
    N = len(cpu_cap)
    out = [np.zeros(N, np.float32), np.zeros(N, np.float32), np.zeros(N, bool),
           np.zeros(N, np.float32), np.zeros(N, np.float32), np.zeros(N, np.float32)]
    mod.greedy_fit(node_idx, cpu, mem, cpu_cap, mem_cap, *out)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_greedy_fit_equal(jax_native, seed):
    case = _fit_case(seed)
    outs = {name: _run_fit(mod, case) for name, mod in _three(jax_native)}
    ref = outs["numpy"]
    assert ref[2].any() and not ref[2].all()  # some nodes overcommitted, not all
    for name, got in outs.items():
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_greedy_fit_rounds_in_list_order(jax_native):
    """2^24 + 1 is not an f32: each add rounds back to 2^24, so the
    later pods of node 0 still fit its 2^24 capacity; node 1 has no cpu
    limit (capacity 0)."""
    case = (np.array([0, 0, 0, 1], np.int32),
            np.array([16777216.0, 1.0, 1.0, 0.5], np.float32),
            np.zeros(4, np.float32),
            np.array([16777216.0, 0.0], np.float32), np.zeros(2, np.float32))
    for name, mod in _three(jax_native):
        cpu_fit, _mf, over, cpu_used, _mu, pods_used = _run_fit(mod, case)
        assert cpu_fit.tolist() == [16777216.0, 0.5], name
        assert over.tolist() == [False, False], name  # 2^24 + 1 rounds to 2^24: it fits
        assert cpu_used.tolist() == [16777216.0, 0.5] and pods_used.tolist() == [3.0, 1.0], name


def test_greedy_fit_checks_before_the_call():
    case = _fit_case(0)
    N = len(case[3])
    good = [np.zeros(N, np.float32)] * 2 + [np.zeros(N, bool)] + [np.zeros(N, np.float32)] * 3
    with pytest.raises(IndexError):
        bad_idx = case[0].copy()
        bad_idx[0] = N
        native.greedy_fit(bad_idx, *case[1:], *good)
    with pytest.raises(ValueError):  # a float64 output would be a converted copy
        native.greedy_fit(*case, np.zeros(N), *good[1:])


# -- build_snapshot -------------------------------------------------------


def _cases():
    yield "small_cluster0", workload.small_cluster(0), None
    yield "small_cluster3", workload.small_cluster(3), None
    pods, nodes, services = workload.synthetic_objects(400, 30, seed=1)
    yield "synthetic", (pods, nodes, [], services), None
    yield "policy", workload.policy_objects(300, 40, seed=2), workload.FULL_VOCABULARY_POLICY


@pytest.mark.parametrize("tag,objs,policy", list(_cases()), ids=lambda x: x if isinstance(x, str) else "")
def test_build_snapshot_native_numpy_and_jax(monkeypatch, tag, objs, policy):
    pending, nodes, assigned, services = objs
    spec = algspec.spec_from_policy(policy) if policy else None
    jspec = jalgspec.spec_from_policy(policy) if policy else None
    got = columnar.build_snapshot(pending, nodes, assigned, services, spec=spec)
    with monkeypatch.context() as m:
        m.setattr(columnar, "native", PLAIN)
        plain = columnar.build_snapshot(pending, nodes, assigned, services, spec=spec)
    ref = jbuild_snapshot(pending, nodes, assigned, services, spec=jspec)
    _assert_snapshots_equal(got, plain)
    _assert_snapshots_equal(got, ref)
    if assigned:
        assert got.nodes.pods_used.sum() > 0


# -- the build ------------------------------------------------------------


def test_host_helper_is_not_a_kernel():
    assert build.host_names() == ["columnar"]
    assert "columnar" not in build.kernel_names()
    path = native.ensure_built()
    assert os.path.dirname(path) == build.BUILD_DIR and path.endswith(".so")


def test_missing_gxx_raises(tmp_path, monkeypatch):
    """No quiet fallback: with g++ hidden, building the helper raises."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.ensure_built()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.pack_bitsets([[1]], 1)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        columnar.build_snapshot(*workload.small_cluster(0))


def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "columnar.cc").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.ensure_built()
    assert os.listdir(tmp_path / "build") == []


def test_build_is_recorded_in_the_ledger(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    before = {(r["kernel"], r["impl"]): r["compiles"] for r in ledger.DEFAULT.rows()}
    native.ensure_built()
    row = {(r["kernel"], r["impl"]): r for r in ledger.DEFAULT.rows()}[("columnar", "host")]
    assert row["compiles"] == before.get(("columnar", "host"), 0) + 1
    assert row["compile_seconds"] > 0
