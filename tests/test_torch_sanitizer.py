"""The port's lock sanitizer (`kubernetes_tpu_torch/utils/sanitizer.py`)
against the JAX package's.

Twins of `tests/test_ktsan.py`'s runtime half: every detector fires on
a deliberate violation (a lock-order inversion, a blocking call under a
lock, an Event.wait without a timeout, a kernel-dispatch hook under a
lock, a lock held by a dead thread) and stays quiet on the sanctioned
shapes (io_gate locks, allow_blocking grants, RLock re-entry). The
same scenario run on both sanitizers gives the same findings; a port
run's `KT_SANITIZE_REPORT` loads in the JAX package's lock-graph merge
under JAX's lock names. The static half is the JAX package's ktlint,
which reads only that package.

The file runs sanitized (`tests/torch_ktsan.py`).
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from kubernetes_tpu.utils import sanitizer as jax_sanitizer
from kubernetes_tpu_torch.utils import sanitizer
from tests.torch_ktsan import torch_ktsan_guard  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- runtime: lock-order graph -----------------------------------------


class TestRuntimeLockOrder:
    def test_inversion_is_a_finding(self):
        a = sanitizer.lock("fxpt.a")
        b = sanitizer.lock("fxpt.b")
        with a:
            with b:
                pass

        def reversed_order():
            with b:
                with a:
                    pass

        t = threading.Thread(target=reversed_order)
        t.start()
        t.join()
        cyc = [f for f in sanitizer.findings() if f["kind"] == "lock-order-cycle"]
        assert cyc, sanitizer.findings()
        assert set(cyc[0]["cycle"]) >= {"fxpt.a", "fxpt.b"}
        sanitizer.reset()

    def test_consistent_order_is_clean(self):
        a = sanitizer.lock("fxpt.c1")
        b = sanitizer.lock("fxpt.c2")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert sanitizer.findings() == []

    def test_sibling_instances_same_name_not_an_edge(self):
        s1 = sanitizer.lock("fxpt.sib")
        s2 = sanitizer.lock("fxpt.sib")
        with s1:
            with s2:
                pass
        assert sanitizer.findings() == []
        assert not any(e["from"] == e["to"] == "fxpt.sib" for e in sanitizer.edges())

    def test_rlock_reentry_is_not_an_edge(self):
        r = sanitizer.rlock("fxpt.re")
        with r:
            with r:
                assert r._is_owned()
        assert sanitizer.findings() == []

    def test_condition_over_a_sanitized_lock_keeps_the_stack_across_wait(self):
        lk = sanitizer.lock("fxpt.cond")
        cond = threading.Condition(lk)
        with cond:
            cond.wait(timeout=0.01)
            assert "fxpt.cond" in [n for _t, n in sanitizer.held_locks()]
        assert "fxpt.cond" not in [n for _t, n in sanitizer.held_locks()]
        assert sanitizer.findings() == []


# -- runtime: blocking under a lock ------------------------------------


def _flushed(tmp_path):
    f = open(tmp_path / "x", "w")
    f.write("x")
    f.flush()
    return f


class TestRuntimeBlocking:
    def test_fsync_under_lock_fires(self, tmp_path):
        lk = sanitizer.lock("fxpt.fs")
        f = _flushed(tmp_path)
        with lk:
            os.fsync(f.fileno())
        f.close()
        found = [x for x in sanitizer.findings()
                 if x["kind"] == "blocking-under-lock" and x["op"] == "fsync"]
        assert found and "fxpt.fs" in found[0]["locks"]
        sanitizer.reset()

    def test_io_gate_lock_is_exempt(self, tmp_path):
        gate = sanitizer.lock("fxpt.gate", io_gate=True)
        f = _flushed(tmp_path)
        with gate:
            os.fsync(f.fileno())
        f.close()
        assert sanitizer.findings() == []

    def test_allow_blocking_grant(self, tmp_path):
        lk = sanitizer.lock("fxpt.grant")
        f = _flushed(tmp_path)
        with lk:
            with sanitizer.allow_blocking("fixture: documented exception"):
                os.fsync(f.fileno())
        f.close()
        assert sanitizer.findings() == []

    def test_event_wait_no_timeout_under_lock_fires(self):
        lk = sanitizer.lock("fxpt.evw")
        ev = threading.Event()
        ev.set()  # wait() returns at once; the CALL is the finding
        with lk:
            ev.wait()
        assert any(f["op"] == "event-wait-no-timeout" for f in sanitizer.findings())
        sanitizer.reset()

    def test_event_wait_with_timeout_is_fine(self):
        lk = sanitizer.lock("fxpt.evt")
        ev = threading.Event()
        with lk:
            ev.wait(timeout=0.001)
        assert sanitizer.findings() == []

    def test_kernel_dispatch_hook_under_lock_fires(self):
        lk = sanitizer.lock("fxpt.kd")
        sanitizer.check_blocking("kernel-dispatch", "free")  # no lock: quiet
        assert sanitizer.findings() == []
        with lk:
            sanitizer.check_blocking("kernel-dispatch", "under lock")
        assert any(f["op"] == "kernel-dispatch" for f in sanitizer.findings())
        sanitizer.reset()

    def test_blocking_only_observes_sanitized_locks(self, tmp_path):
        plain = threading.Lock()
        f = _flushed(tmp_path)
        with plain:
            os.fsync(f.fileno())
        f.close()
        assert sanitizer.findings() == []


@pytest.mark.parametrize("entry", ["schedule_backlog", "schedule_backlog_wave",
                                   "schedule_backlog_sinkhorn", "solve_backlog_pipelined"])
def test_each_dispatch_entry_point_reports_a_call_under_a_lock(entry):
    """The four `check_blocking` hooks sit at the port's counterparts
    of JAX's four dispatch sites: a call under a sanitized lock is a
    finding named after the entry point, a free call is not."""
    from kubernetes_tpu_torch.ops import pipeline
    from kubernetes_tpu_torch.scheduler import batch
    from tests.test_solver_parity import mk_node, mk_pod

    fn = getattr(pipeline if entry == "solve_backlog_pipelined" else batch, entry)
    pods, nodes = [mk_pod("p0", cpu=100)], [mk_node("n0")]
    assert fn(pods, nodes, device="cpu") == ["n0"]
    assert sanitizer.findings() == []
    lk = sanitizer.lock("fxpt.dispatch")
    with lk:
        fn(pods, nodes, device="cpu")
    found = [f for f in sanitizer.findings() if f["op"] == "kernel-dispatch"]
    assert [f["detail"] for f in found] == [entry] and found[0]["locks"] == ["fxpt.dispatch"]
    sanitizer.reset()


# -- runtime: leaks -----------------------------------------------------


class TestRuntimeLeaks:
    def test_lock_held_by_dead_thread_is_leaked(self):
        lk = sanitizer.lock("fxpt.leak")

        def die_holding():
            lk.acquire()

        t = threading.Thread(target=die_holding)
        t.start()
        t.join()
        leaks = sanitizer.leaked_locks()
        assert "fxpt.leak" in [name for _t, name in leaks], leaks
        sanitizer.purge_dead_threads()
        lk._inner.release()
        assert sanitizer.leaked_locks() == []

    def test_held_locks_snapshot(self):
        lk = sanitizer.lock("fxpt.held")
        with lk:
            assert "fxpt.held" in [n for _t, n in sanitizer.held_locks()]
        assert "fxpt.held" not in [n for _t, n in sanitizer.held_locks()]


def test_factory_returns_plain_locks_when_off():
    sanitizer.disable()
    try:
        lk = sanitizer.lock("noop")
        rk = sanitizer.rlock("noop")
        assert type(lk) is type(threading.Lock())
        assert isinstance(rk, type(threading.RLock()))
    finally:
        sanitizer.enable()


# -- the two packages alike ---------------------------------------------


def _scenario(san, tmp_path):
    """A fixed script of lock nestings and blocking calls; its findings
    without the stack sites."""
    a, b, c = san.lock("fxtw.a"), san.lock("fxtw.b"), san.rlock("fxtw.c")
    gate = san.lock("fxtw.gate", io_gate=True)
    f = _flushed(tmp_path)
    with a:
        with b:
            with c:
                with c:
                    pass
    with gate:
        os.fsync(f.fileno())
    with b:
        os.fsync(f.fileno())
        with a:
            pass
    with c:
        san.check_blocking("dispatch", "x")
        with san.allow_blocking("granted"):
            os.fsync(f.fileno())
    f.close()
    out = [{k: v for k, v in x.items() if k not in ("site", "reverse_site")}
           for x in san.findings()]
    edges = [(e["from"], e["to"], e["count"]) for e in san.edges()
             if e["from"].startswith("fxtw.")]
    return out, edges


def test_the_same_scenario_gives_the_same_findings_in_both_packages(tmp_path):
    port = _scenario(sanitizer, tmp_path)
    sanitizer.reset()
    jax_on = jax_sanitizer.enabled()
    jax_sanitizer.enable()
    jax_sanitizer.reset()
    try:
        jax = _scenario(jax_sanitizer, tmp_path)
    finally:
        jax_sanitizer.reset()
        if not jax_on:
            jax_sanitizer.disable()
    assert port == jax
    kinds = sorted(f["kind"] for f in port[0])
    assert kinds == ["blocking-under-lock", "blocking-under-lock", "lock-order-cycle"]


def test_the_hub_reads_the_store_outside_its_lock():
    """The replication hub once read the store's version under its own
    lock while its WAL tap takes that lock under the store's: a cycle
    `kvstore.lock` <-> `replication.hub` (JAX's hub still does). Attach
    a hub, add a follower and write through it: no cycle, no finding."""
    from kubernetes_tpu_torch.store.kvstore import KVStore
    from kubernetes_tpu_torch.store.replication import FollowerReplica, LocalLink, ReplicationHub

    store = KVStore()
    store.create("/registry/pods/default/a", {"kind": "Pod", "metadata": {"name": "a"}})
    follower = FollowerReplica(store=KVStore(), name="f0")
    hub = ReplicationHub(store, name="leader").attach()
    try:
        hub.add_follower(LocalLink(follower, "f0"))
        store.create("/registry/pods/default/b", {"kind": "Pod", "metadata": {"name": "b"}})
        assert hub.wait_committed(store.version, timeout=10)
    finally:
        hub.stop()
        store.close()
    edges = {(e["from"], e["to"]) for e in sanitizer.edges()}
    assert ("kvstore.lock", "replication.hub") in edges
    assert ("replication.hub", "kvstore.lock") not in edges
    assert sanitizer.findings() == []


_REPORT_RUN = r"""
import sys
from kubernetes_tpu_torch.store.kvstore import KVStore
from kubernetes_tpu_torch.server.api import APIServer
store = KVStore(data_dir=sys.argv[1])
api = APIServer(store=store)
for i in range(4):
    api.create("pods", "default", {"kind": "Pod", "metadata": {"name": f"p{i}"},
               "spec": {"containers": [{"name": "c", "image": "x"}]}})
store.snapshot()
store.close()
"""


def test_a_port_report_loads_in_the_jax_lock_graph(tmp_path):
    """`KT_SANITIZE=locks KT_SANITIZE_REPORT=...` on a port process
    writes JAX's report shape under JAX's lock names, and the JAX
    package's `tools.ktlint.lockgraph` merges it with its static graph."""
    sys.path.insert(0, ROOT)
    from tools.ktlint import lockgraph

    report = tmp_path / "port-ktsan.json"
    env = dict(os.environ, KT_SANITIZE="locks", KT_SANITIZE_REPORT=str(report),
               PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", _REPORT_RUN, str(tmp_path / "data")],
                   env=env, check=True, timeout=120)
    runtime = lockgraph.load_runtime_report(report)
    assert runtime["findings"] == []
    names = {n for e in runtime["edges"] for n in (e["from"], e["to"])}
    assert "kvstore.lock" in names and names <= _jax_lock_names()
    rep = lockgraph.analyze(
        [os.path.join(ROOT, "kubernetes_tpu", "store", f) for f in ("kvstore.py", "watch.py")],
        runtime=runtime)
    assert rep.cycles == [] and rep.runtime_findings == []
    assert any(e.kind == "runtime" for e in rep.edges)
    assert json.loads(report.read_text()).keys() == {"edges", "findings"}


def _port_lock_names():
    import re

    names = set()
    for root, _dirs, files in os.walk(os.path.join(ROOT, "kubernetes_tpu_torch")):
        for f in files:
            if f.endswith(".py") and f != "sanitizer.py":
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r'sanitizer\.r?lock\(\s*"([\w.]+)"', fh.read()))
    return names


def test_the_ports_locks_carry_jaxs_names():
    """Every sanitized lock of the port has the name of its JAX site,
    but one: `sli.device` stands where JAX's `sli.xla` guards an XLA
    compile-cache count."""
    port, jax = _port_lock_names(), _jax_lock_names()
    assert port - jax == {"sli.device"}
    assert jax - port == {"sli.xla"}
    assert len(port) == 28


def _jax_lock_names():
    import re

    names = set()
    for root, _dirs, files in os.walk(os.path.join(ROOT, "kubernetes_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r'sanitizer\.r?lock\(\s*"([\w.]+)"', fh.read()))
    return names
