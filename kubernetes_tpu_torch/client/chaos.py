"""Fault-injecting client transport.

Reference: pkg/client/chaosclient/chaosclient.go — a RoundTripper
wrapper that injects failures by policy so retry/backoff paths get
exercised under test instead of trusted on faith. This wraps any
Transport: each request consults the seeded policy and either fails
(APIError or raised ConnectionError), delays, or passes through.

A copy of `kubernetes_tpu/client/chaos.py` over the port's `Transport`.
Its injected server error is the client's `APIError(500, ...)`
(`client/rest.py`), the class the port's callers catch; for a seed the
policy rolls, fails and delays in the same sequence as JAX's.
"""

from __future__ import annotations

import random
import time
from typing import Optional

from kubernetes_tpu_torch.client.rest import APIError, Transport


class ChaosPolicy:
    """Seeded failure policy. Probabilities are per-request."""

    def __init__(
        self,
        seed: int = 0,
        p_error: float = 0.0,  # APIError 500 (server-side failure)
        p_network: float = 0.0,  # ConnectionError (transport failure)
        p_delay: float = 0.0,
        delay_s: float = 0.05,
        max_failures: Optional[int] = None,  # stop injecting after N
    ):
        self.rng = random.Random(seed)
        self.p_error = p_error
        self.p_network = p_network
        self.p_delay = p_delay
        self.delay_s = delay_s
        self.max_failures = max_failures
        self.failures = 0
        self.requests = 0

    def act(self) -> None:
        """Raise/delay per policy; returns normally to pass through."""
        self.requests += 1
        budget = (
            self.max_failures is None or self.failures < self.max_failures
        )
        roll = self.rng.random()
        fail_band = self.p_network + self.p_error
        if budget and roll < self.p_network:
            self.failures += 1
            raise ConnectionError("chaos: injected connection failure")
        if budget and roll < fail_band:
            self.failures += 1
            raise APIError(500, "InternalError", "chaos: injected server error")
        # Delay band is [fail_band, fail_band + p_delay): a roll in the
        # failure band with an exhausted budget passes through instead
        # of silently becoming a delay.
        if fail_band <= roll < fail_band + self.p_delay:
            time.sleep(self.delay_s)


class ChaosTransport(Transport):
    """Wraps a Transport; every request and watch-open passes through
    the policy first."""

    def __init__(self, inner: Transport, policy: ChaosPolicy):
        self.inner = inner
        self.policy = policy

    def request(self, verb, op, args, body=None, patch_type=None):
        self.policy.act()
        return self.inner.request(verb, op, args, body, patch_type=patch_type)

    def watch(self, resource, namespace, since, lsel, fsel):
        self.policy.act()
        return self.inner.watch(resource, namespace, since, lsel, fsel)
