"""The port's KVStore against the JAX package's.

The same operations, made from a seed, give the same results, versions
and watch events in both stores, in memory and on disk, and write the
same bytes to the data directory (WAL and snapshot). A data directory
written by either package recovers in the other with every key and
version, and the clock goes on from there; a WAL cut mid-record (the
file truncated, as a process killed mid-append leaves it) recovers
alike in both, the torn tail dropped.
"""

import json
import os
import random
import shutil
import time

import pytest

from kubernetes_tpu.store import kvstore as jax_kv

from kubernetes_tpu_torch.store import kvstore as port_kv
from tests.torch_ktsan import torch_ktsan_guard  # noqa: F401 (runs the file sanitized)

PACKAGES = {"jax": jax_kv, "port": port_kv}


class Clock:
    """A settable wall clock for TTLs (the store reads `_now`)."""

    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


def _obj(name, n=0):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "ns"},
            "spec": {"nodeName": f"n{n}" if n else "", "containers": [{"name": "c"}]}}


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("error", type(e).__name__, str(e))
    return ("ok", _plain(out))


def _plain(x):
    if isinstance(x, Exception):
        return ("error", type(x).__name__, str(x))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _script(seed, n=120):
    """A seeded list of store operations: (name, args)."""
    rng = random.Random(seed)
    names = [f"/registry/pods/ns/p{i}" for i in range(24)]
    ops = []
    for step in range(n):
        k = rng.choice(names)
        r = rng.random()
        if r < 0.25:
            ops.append(("create", (k, _obj(k, step % 5), rng.choice([None, None, 30.0]))))
        elif r < 0.35:
            ops.append(("create_many", ([(rng.choice(names), _obj(f"m{step}-{j}", j), None)
                                         for j in range(rng.randint(1, 4))],)))
        elif r < 0.5:
            ops.append(("set", (k, _obj(k, step % 7), rng.choice([None, step, step + 1000]))))
        elif r < 0.6:
            ops.append(("delete", (k, rng.choice([None, step]))))
        elif r < 0.65:
            ops.append(("delete_many", (rng.sample(names, 3),)))
        elif r < 0.75:
            ops.append(("guaranteed_update", (k, step)))
        elif r < 0.82:
            ops.append(("atomic_update", (k, step)))
        elif r < 0.87:
            ops.append(("tick", (rng.choice([5.0, 40.0]),)))
        elif r < 0.93:
            ops.append(("get", (k,)))
        else:
            ops.append(("list", ("/registry/pods/ns/",)))
    return ops


def _label(step):
    def fn(obj):
        obj.setdefault("metadata", {}).setdefault("labels", {})["step"] = str(step)
        return obj
    return fn


def _apply(store, clock, op, args):
    if op == "create":
        return _outcome(lambda: store.create(args[0], args[1], ttl=args[2]))
    if op == "create_many":
        return _outcome(lambda: store.create_many(args[0]))
    if op == "set":
        return _outcome(lambda: store.set(args[0], args[1], expected_version=args[2]))
    if op == "delete":
        return _outcome(lambda: store.delete(args[0], expected_version=args[1]))
    if op == "delete_many":
        return _outcome(lambda: store.delete_many(args[0]))
    if op == "guaranteed_update":
        return _outcome(lambda: store.guaranteed_update(args[0], _label(args[1])))
    if op == "atomic_update":
        return _outcome(lambda: store.atomic_update(args[0], _label(args[1])))
    if op == "tick":
        clock.t += args[0]
        store.expire_now()
        return ("ok", store.version)
    if op == "get":
        return _outcome(lambda: store.get(args[0]))
    return _outcome(lambda: store.list(args[0]))


def _drain(stream, want_version, timeout=10.0):
    events, deadline = [], time.monotonic() + timeout
    while time.monotonic() < deadline:
        ev = stream.next(timeout=0.05)
        if ev is None:
            if events and events[-1][1] >= want_version or want_version == 0:
                break
            continue
        events.append((ev.type, ev.version, ev.object))
    return events


def _run(kv, seed, data_dir=None):
    clock = Clock()
    store = kv.KVStore(data_dir=data_dir, fsync=False, snapshot_every=40) if data_dir \
        else kv.KVStore(history_limit=64)
    store._now = clock
    seen = []
    store.subscribe(lambda v, t, k, o, p: seen.append((v, t, k)))
    everything = store.watch("/registry/", since=0, maxsize=100000)
    selected = store.watch("/registry/pods/ns/", since=0, maxsize=100000,
                           pred=lambda o: bool(o.get("spec", {}).get("nodeName")))
    results = [_apply(store, clock, op, args) for op, args in _script(seed)]
    version = store.version
    events = _drain(everything, version)
    picked = _drain(selected, 0, timeout=0.5)
    replay = None
    try:
        replay = _drain(store.watch("/registry/", since=max(0, version - 20)), version)
    except kv.CompactedError as e:
        replay = ("compacted", str(e))
    try:
        gone = store.watch("/registry/", since=1)
        gone = ("open", _drain(gone, version, timeout=0.5))
    except kv.CompactedError as e:
        gone = ("compacted", str(e))
    deadline = time.monotonic() + 5
    while (not seen or seen[-1][0] < version) and time.monotonic() < deadline:
        time.sleep(0.01)
    state = store.dump_state()
    store.close()
    return {"results": results, "version": version, "events": events, "picked": picked,
            "replay": replay, "gone": gone, "subscriber": seen, "state": state}


@pytest.mark.parametrize("durable", [False, True], ids=["memory", "durable"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_operations_same_results_versions_and_events(tmp_path, seed, durable):
    runs = {}
    for name, kv in PACKAGES.items():
        d = str(tmp_path / name) if durable else None
        runs[name] = _run(kv, seed, d)
    assert runs["port"] == runs["jax"]
    assert runs["port"]["version"] > 0 and runs["port"]["events"]
    if durable:
        for f in ("wal.log", "snapshot.json"):
            with open(tmp_path / "jax" / f, "rb") as a, open(tmp_path / "port" / f, "rb") as b:
                assert a.read() == b.read(), f


def _write(kv, d, seed, n=90):
    """A durable store in `d` through `n` seeded operations; returns its
    final state and version (closed cleanly)."""
    clock = Clock()
    store = kv.KVStore(data_dir=d, fsync=True, snapshot_every=32)
    store._now = clock
    for op, args in _script(seed, n):
        _apply(store, clock, op, args)
    state, version = store.dump_state(), store.version
    store.close()
    return state, version


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_recovers_the_others_data_dir(tmp_path, writer, reader):
    d = str(tmp_path / "data")
    state, version = _write(PACKAGES[writer], d, seed=7)
    assert os.path.exists(os.path.join(d, "snapshot.json"))
    # Both packages read the directory the same way.
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    store = PACKAGES[reader].KVStore(data_dir=d, fsync=True, snapshot_every=32)
    twin = PACKAGES[writer].KVStore(data_dir=copy, fsync=True, snapshot_every=32)
    try:
        assert store.version == twin.version == version
        got = store.dump_state()
        assert got == twin.dump_state()
        assert got["version"] == state["version"]
        assert {k: v for k, _o, v, _e in got["items"]} == {k: v for k, _o, v, _e in state["items"]}
        for key, obj, ver, _exp in state["items"]:
            assert store.get(key) == obj and int(obj["metadata"]["resourceVersion"]) == ver
        # The clock goes on from the last recovered version in both.
        out = [s.create("/registry/pods/ns/after", _obj("after")) for s in (store, twin)]
        assert out[0] == out[1]
        assert int(out[0]["metadata"]["resourceVersion"]) == version + 1
    finally:
        store.close()
        twin.close()


@pytest.mark.parametrize("cut", [1, 7, -2])
def test_a_wal_cut_mid_record_recovers_alike(tmp_path, cut):
    """A WAL whose last record is cut short (`cut` bytes into it, or
    `-cut` before its end) recovers in both packages to the state before
    that record, with the same files left behind."""
    base = str(tmp_path / "base")
    clock = Clock()
    store = port_kv.KVStore(data_dir=base, fsync=True, snapshot_every=10_000)
    store._now = clock
    for op, args in _script(11, 60):
        _apply(store, clock, op, args)
    store.crash()
    wal = os.path.join(base, "wal.log")
    with open(wal, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    keep = b"".join(lines[:-1])
    last = lines[-1]
    torn = last[:cut] if cut > 0 else last[:len(last) + cut]
    assert torn and not torn.endswith(b"\n")
    with open(wal, "wb") as f:
        f.write(keep + torn)
    recovered = {}
    for name, kv in PACKAGES.items():
        d = str(tmp_path / name)
        shutil.copytree(base, d)
        s = kv.KVStore(data_dir=d, fsync=True, snapshot_every=10_000)
        s.close()
        files = {}
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f), "rb") as fh:
                files[f] = fh.read()
        recovered[name] = (s.version, s.dump_state(), files)
    assert recovered["port"] == recovered["jax"]
    # The dropped record was the newest write: the version is the one
    # before it.
    assert recovered["port"][0] == json.loads(lines[-2])["v"]
