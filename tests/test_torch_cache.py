"""The four cache classes the port gained (`Indexer`, `ExpirationCache`,
`UndeltaStore`, `DeltaFIFO` in `kubernetes_tpu_torch/client/cache.py`)
against the JAX package's.

Twins of `tests/test_cache.py`'s cases for the four classes, each run
on both packages, and a seeded sequence of adds, updates, deletes and
replaces (made with numpy) that must leave both packages' caches, index
buckets, pushes and popped deltas equal.
"""

import threading
import time

import numpy as np
import pytest

from kubernetes_tpu.client import cache as jax_cache
from kubernetes_tpu_torch.client import cache as port_cache

PACKAGES = {"jax": jax_cache, "port": port_cache}


@pytest.fixture(params=sorted(PACKAGES))
def cache(request):
    return PACKAGES[request.param]


def obj(name, ns="default", **extra):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": ns}, **extra}


def _names(objs):
    return {o["metadata"]["name"] for o in objs}


class TestIndexer:
    def test_by_index(self, cache):
        by_node = lambda o: [o.get("spec", {}).get("nodeName", "")]  # noqa: E731
        idx = cache.Indexer({"node": by_node})
        idx.add(obj("a", spec={"nodeName": "n1"}))
        idx.add(obj("b", spec={"nodeName": "n1"}))
        idx.add(obj("c", spec={"nodeName": "n2"}))
        assert _names(idx.by_index("node", "n1")) == {"a", "b"}
        assert idx.index_values("node") == ["n1", "n2"]
        idx.add(obj("a", spec={"nodeName": "n2"}))  # moves between buckets
        assert _names(idx.by_index("node", "n2")) == {"a", "c"}
        idx.delete(obj("c"))
        assert _names(idx.by_index("node", "n2")) == {"a"}
        idx.replace([obj("z", spec={"nodeName": "n9"})])
        assert idx.by_index("node", "n1") == []
        assert len(idx.by_index("node", "n9")) == 1

    def test_update_reindexes(self, cache):
        idx = cache.Indexer({"node": lambda o: [o["spec"]["nodeName"]]})
        idx.add(obj("a", spec={"nodeName": "n1"}))
        idx.update(obj("a", spec={"nodeName": "n3"}))
        assert idx.by_index("node", "n1") == [] and _names(idx.by_index("node", "n3")) == {"a"}


class TestExpirationCache:
    def test_entries_age_out(self, cache):
        c = cache.ExpirationCache(ttl=0.15)
        c.add(obj("a"))
        assert c.get("default/a") is not None
        time.sleep(0.2)
        assert c.get("default/a") is None
        assert c.list() == [] and c.keys() == [] and len(c) == 0

    def test_readd_refreshes(self, cache):
        c = cache.ExpirationCache(ttl=0.3)
        c.add(obj("a"))
        time.sleep(0.18)
        c.add(obj("a"))  # refresh
        time.sleep(0.18)
        assert c.get("default/a") is not None
        c.delete(obj("a"))
        assert c.get("default/a") is None


class TestUndeltaStore:
    def test_pushes_full_state(self, cache):
        snaps = []
        s = cache.UndeltaStore(lambda state: snaps.append(sorted(_names(state))))
        s.add(obj("a"))
        s.add(obj("b"))
        s.update(obj("b", spec={"x": 1}))
        s.delete(obj("a"))
        s.replace([obj("x")])
        assert snaps == [["a"], ["a", "b"], ["a", "b"], ["b"], ["x"]]


class TestDeltaFIFO:
    def test_deletions_survive_dedup(self, cache):
        q = cache.DeltaFIFO()
        q.add(obj("a"))
        q.delete(obj("a"))
        assert [t for t, _o in q.pop(timeout=1)] == ["ADDED", "DELETED"]

    def test_add_then_update_types(self, cache):
        q = cache.DeltaFIFO()
        q.add(obj("a"))
        assert [t for t, _ in q.pop(timeout=1)] == ["ADDED"]
        q.add(obj("a", spec={"x": 1}))
        assert [t for t, _ in q.pop(timeout=1)] == ["MODIFIED"]

    def test_replace_syncs_and_synthesizes_deletes(self, cache):
        q = cache.DeltaFIFO()
        q.add(obj("gone"))
        q.pop(timeout=1)
        q.replace([obj("kept")])
        batches = [q.pop(timeout=1), q.pop(timeout=1)]
        types = {d[0][1]["metadata"]["name"]: [t for t, _ in d] for d in batches}
        assert types == {"gone": ["DELETED"], "kept": ["SYNC"]}

    def test_close_unblocks_pop(self, cache):
        q = cache.DeltaFIFO()
        out = []
        t = threading.Thread(target=lambda: out.append(q.pop()), daemon=True)
        t.start()
        q.close()
        t.join(timeout=5)
        assert out == [None]

    def test_pop_times_out_empty(self, cache):
        q = cache.DeltaFIFO()
        assert q.pop(timeout=0.05) is None and len(q) == 0


def _ops(seed, n=300):
    """A seeded script of (verb, object) over 12 names and 4 nodes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = rng.random()
        name = f"p{int(rng.integers(12))}"
        node = f"n{int(rng.integers(4))}"
        if r < 0.45:
            out.append(("add", obj(name, spec={"nodeName": node, "i": i})))
        elif r < 0.65:
            out.append(("update", obj(name, spec={"nodeName": node, "i": i})))
        elif r < 0.9:
            out.append(("delete", obj(name)))
        elif r < 0.95:
            keep = sorted({f"p{int(k)}" for k in rng.integers(12, size=4)})
            out.append(("replace", [obj(k, spec={"nodeName": node, "i": i}) for k in keep]))
        else:
            out.append(("pop", None))
    return out


def _drive(cache, ops):
    idx = cache.Indexer({"node": lambda o: [o.get("spec", {}).get("nodeName", "")]})
    pushes = []
    und = cache.UndeltaStore(lambda state: pushes.append(sorted(
        (o["metadata"]["name"], o.get("spec", {}).get("i")) for o in state)))
    q = cache.DeltaFIFO()
    popped = []
    for verb, o in ops:
        if verb == "pop":
            d = q.pop(timeout=0)
            popped.append(None if d is None else [(t, x["metadata"]["name"]) for t, x in d])
            continue
        for target in (idx, und, q):
            getattr(target, verb)(o)
    while True:
        d = q.pop(timeout=0)
        if d is None:
            break
        popped.append([(t, x["metadata"]["name"]) for t, x in d])
    buckets = {v: sorted(_names(idx.by_index("node", v))) for v in idx.index_values("node")}
    return sorted(idx.keys()), buckets, pushes, popped


@pytest.mark.parametrize("seed", range(6))
def test_a_seeded_script_leaves_both_packages_alike(seed):
    ops = _ops(seed)
    jax = _drive(jax_cache, ops)
    port = _drive(port_cache, ops)
    assert port == jax
    assert jax[2] and jax[3]  # the script pushed and popped something


def test_the_port_classes_are_the_four_of_jax():
    for name in ("Indexer", "ExpirationCache", "UndeltaStore", "DeltaFIFO"):
        assert hasattr(port_cache, name)
    assert issubclass(port_cache.Indexer, port_cache.ThreadSafeStore)
    assert port_cache.DeltaFIFO.SYNC == jax_cache.DeltaFIFO.SYNC
