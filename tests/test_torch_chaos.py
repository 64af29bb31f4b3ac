"""The port's chaos transport (`kubernetes_tpu_torch/client/chaos.py`)
against the JAX package's (`kubernetes_tpu/client/chaos.py`).

- For a seed and a policy, `ChaosPolicy.act` passes, fails and delays
  in the same sequence in both packages; its server error is the
  client's `APIError(500)`.
- The twins of `tests/test_ws_chaos_stress.py`'s chaos cases:
  `ChaosTransport` over `LocalTransport` and over `HTTPTransport`
  drives an informer through a burst of injected failures to the same
  store as a clean informer's, and it still tracks objects made after
  the burst.
"""

import time

import pytest

from kubernetes_tpu.client import chaos as jax_chaos
from kubernetes_tpu_torch.client import chaos
from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.client.rest import APIError, Client, HTTPTransport, LocalTransport
from kubernetes_tpu_torch.server.api import APIServer
from kubernetes_tpu_torch.server.httpserver import APIHTTPServer


def wait_until(cond, timeout=8.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def pod_wire(name, ns="default"):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "x"}]}}


def _acts(mod, monkeypatch, n=400, **policy):
    """What `act` did on each of `n` requests: pass, delay, network or
    server (with the server error's code)."""
    slept = []
    monkeypatch.setattr(mod.time, "sleep", lambda s: slept.append(s))
    p = mod.ChaosPolicy(**policy)
    out = []
    for _ in range(n):
        before = len(slept)
        try:
            p.act()
            out.append("delay" if len(slept) > before else "pass")
        except ConnectionError as e:
            out.append(("network", str(e)))
        except Exception as e:  # noqa: BLE001 - the server error's class is each package's
            out.append(("server", e.code, e.reason, str(e)))
    return out, p.failures, p.requests, slept


@pytest.mark.parametrize("policy", [
    dict(seed=7, p_error=0.3, p_network=0.3, max_failures=8),
    dict(seed=1, p_error=1.0, max_failures=3),
    dict(seed=3, p_error=0.1, p_network=0.05, p_delay=0.2, delay_s=0.01),
    dict(seed=11, p_network=0.5, p_delay=0.5, max_failures=20),
    dict(seed=0),
])
def test_the_policy_acts_as_jaxs(monkeypatch, policy):
    port = _acts(chaos, monkeypatch, **policy)
    jax = _acts(jax_chaos, monkeypatch, **policy)
    assert port == jax


def test_the_injected_server_error_is_the_clients():
    p = chaos.ChaosPolicy(seed=1, p_error=1.0, max_failures=1)
    with pytest.raises(APIError) as ei:
        p.act()
    assert ei.value.code == 500 and ei.value.reason == "InternalError"
    p.act()  # the budget is spent: a pass


def test_policy_budget():
    policy = chaos.ChaosPolicy(seed=1, p_error=1.0, max_failures=3)
    failures = 0
    for _ in range(10):
        try:
            policy.act()
        except Exception:
            failures += 1
    assert failures == 3  # budget exhausted, then passthrough


def _names(informer):
    return sorted(p["metadata"]["name"] if isinstance(p, dict) else p.metadata.name
                  for p in informer.store.list())


@pytest.fixture(params=["local", "http"])
def transport(request):
    """(a clean transport, a factory of further ones) over one apiserver,
    in process or over HTTP."""
    api = APIServer()
    if request.param == "local":
        yield lambda: LocalTransport(api)
        return
    srv = APIHTTPServer(api).start()
    try:
        yield lambda: HTTPTransport(srv.address)
    finally:
        srv.stop()


@pytest.mark.parametrize("seed", [7, 8])
def test_informer_converges_through_injected_failures(transport, seed):
    """Retry and backoff absorb a burst of transport failures: the
    chaotic informer's store equals a clean informer's, before the burst
    ends and after."""
    healthy = Client(transport())
    for i in range(5):
        healthy.create("pods", pod_wire(f"pre{i}"), namespace="default")
    policy = chaos.ChaosPolicy(seed=seed, p_error=0.3, p_network=0.3, max_failures=8)
    chaotic = Informer(Client(chaos.ChaosTransport(transport(), policy)), "pods")
    clean = Informer(Client(transport()), "pods")
    chaotic.start()
    clean.start()
    try:
        assert wait_until(lambda: len(chaotic.store.list()) == 5, timeout=15), (
            f"informer never converged (failures={policy.failures})")
        assert policy.failures > 0, "chaos injected nothing"
        assert wait_until(lambda: _names(clean) == _names(chaotic))
        healthy.create("pods", pod_wire("post"), namespace="default")
        healthy.delete("pods", "pre0", namespace="default")
        # The reflector may be riding out its capped 5 s backoff.
        assert wait_until(lambda: _names(chaotic) == _names(clean)
                          == ["post", "pre1", "pre2", "pre3", "pre4"], timeout=20)
    finally:
        chaotic.stop()
        clean.stop()
