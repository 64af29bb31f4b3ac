"""The autoscaler: elastic node pools closing the capacity loop.

The port of `kubernetes_tpu/controllers/autoscaler.py`. The capacity
plane tells two kinds of starvation apart: a fragmented cluster (free
capacity in unusable shards, the descheduler's job) and a full one
(`capacity_zero_headroom_ticks_total` rising while pods wait, which only
more nodes fix). This controller handles the second, and the reverse:
low utilisation with an empty backlog is paid capacity idling, so the
pool shrinks.

Grow: `grow_after` consecutive polls that see starvation (the
zero-headroom counter rose since the last poll, or pods are pending)
add `grow_step` nodes through the pool provider.

Shrink: `shrink_after` consecutive polls of mean live-node CPU
utilisation below `low_util` with no pending pod start a drain: the
pool node with the fewest pods is cordoned (`spec.unschedulable`), its
pods move out through the descheduler's graceful moves
(`Descheduler.drain_node`, K2 with the node forced), and the provider
retires the node only once nothing runs on it. A node that will not
empty stays cordoned and the drain goes on at the next poll.

The counter it reads is this process's: the autoscaler runs in the
process of the scheduler daemon whose capacity samples
(`scheduler/daemon.py _sample_capacity`) count it. The pool provider is
duck-typed: `name`, `size()`, `grow(n) -> [node names]`,
`shrink(node_name)`, and optionally `node_names()` (the pool's
members; without it every node is one). `device` is the default
descheduler's (None: the CUDA card).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

import numpy as np

from kubernetes_tpu_torch import DeviceLike
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils.capacity import ZERO_HEADROOM, cluster_columns

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.autoscaler")

POOL_SIZE = metrics.DEFAULT.gauge("autoscaler_pool_size", "Current node count of each elastic pool",
                                  ("pool",))
SCALE_EVENTS = metrics.DEFAULT.counter("autoscaler_scale_events_total",
                                       "Pool resize decisions by direction (up/down)",
                                       ("direction",))
_SYNCS = metrics.DEFAULT.counter("autoscaler_syncs_total", "Autoscaler evaluation passes",
                                 ("result",))

_TERMINAL = ("Succeeded", "Failed")


class Autoscaler:
    """Periodic pool-size controller. `sync_once()` works without
    `start()`."""

    def __init__(
        self,
        client,
        pool,
        sync_period: float = 10.0,
        min_size: int = 1,
        max_size: int = 16,
        grow_after: int = 3,
        grow_step: int = 1,
        shrink_after: int = 6,
        low_util: float = 0.25,
        descheduler=None,
        device: DeviceLike = None,
    ):
        self.client = client
        self.pool = pool
        self.sync_period = sync_period
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.grow_after = int(grow_after)
        self.grow_step = int(grow_step)
        self.shrink_after = int(shrink_after)
        self.low_util = float(low_util)
        if descheduler is None:
            from kubernetes_tpu_torch.controllers.descheduler import Descheduler

            descheduler = Descheduler(client, device=device)
        self.descheduler = descheduler
        self._starve_polls = 0
        self._idle_polls = 0
        self._last_burn: Optional[float] = None
        self._draining: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        POOL_SIZE.set(self.pool.size(), pool=self.pool.name)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
                _SYNCS.inc(result="ok")
            except Exception:
                _LOG.exception("autoscaler sync failed")
                _SYNCS.inc(result="error")
            self._stop.wait(self.sync_period)

    # -- the poll ----------------------------------------------------------

    def sync_once(self) -> dict:
        """One evaluation: read the cluster, fold the starvation and idle
        streaks, act when one completes. Returns the poll's summary."""
        nodes, _ = self.client.list("nodes")
        pods, _ = self.client.list("pods")
        cols, _names = cluster_columns(nodes, pods)
        pending = sum(1 for p in pods if not p.spec.node_name and p.status.phase not in _TERMINAL)

        burn = ZERO_HEADROOM.value()
        burned = self._last_burn is not None and burn > self._last_burn
        self._last_burn = burn

        # cpu_fit is the greedy-fit charge: utilisation as the capacity
        # report computes it.
        live = np.asarray(cols["sched"], bool)
        caps = np.asarray(cols["cpu_cap"], np.float32)
        fits = np.asarray(cols["cpu_fit"], np.float32)
        util = 0.0
        mask = live & (caps > 0)
        if mask.any():
            util = float(np.mean(np.clip(fits[mask] / caps[mask], 0.0, 1.0)))

        starving = burned or pending > 0
        idle = not pending and util < self.low_util
        if starving:
            self._starve_polls += 1
            self._idle_polls = 0
        elif idle:
            self._idle_polls += 1
            self._starve_polls = 0
        else:
            self._starve_polls = 0
            self._idle_polls = 0

        summary = {
            "kind": "AutoscalerPoll",
            "pool": self.pool.name,
            "size": self.pool.size(),
            "pending": pending,
            "mean_cpu_util": round(util, 4),
            "starve_polls": self._starve_polls,
            "idle_polls": self._idle_polls,
            "action": "none",
        }

        if self._draining is not None:
            summary["action"] = self._continue_drain(pods)
        elif self._starve_polls >= self.grow_after and self.pool.size() < self.max_size:
            added = self.pool.grow(min(self.grow_step, self.max_size - self.pool.size()))
            self._starve_polls = 0
            SCALE_EVENTS.inc(direction="up")
            summary["action"] = "grow"
            summary["added"] = list(added or [])
        elif self._idle_polls >= self.shrink_after and self.pool.size() > self.min_size:
            summary["action"] = self._start_drain(nodes, pods)

        POOL_SIZE.set(self.pool.size(), pool=self.pool.name)
        summary["size"] = self.pool.size()
        return summary

    # -- shrinking ---------------------------------------------------------

    def _pool_nodes(self, nodes) -> List:
        members = set(getattr(self.pool, "node_names", lambda: [])() or [])
        if members:
            return [n for n in nodes if n.metadata.name in members]
        return list(nodes)

    def _start_drain(self, nodes, pods) -> str:
        """Cordon the pool node with the fewest pods and start its drain."""
        counts = {}
        for p in pods:
            if p.spec.node_name and p.status.phase not in _TERMINAL:
                counts[p.spec.node_name] = counts.get(p.spec.node_name, 0) + 1
        candidates = [n for n in self._pool_nodes(nodes)
                      if not (n.spec.unschedulable if n.spec else False)]
        if not candidates:
            return "none"
        victim = min(candidates, key=lambda n: (counts.get(n.metadata.name, 0), n.metadata.name))
        name = victim.metadata.name
        try:
            self.client.patch("nodes", name, {"spec": {"unschedulable": True}})
        except APIError:
            return "none"
        self._draining = name
        self.descheduler.drain_node(name)
        return "drain"

    def _continue_drain(self, pods) -> str:
        """Retire the draining node once no live pod is bound to it;
        until then drain again."""
        name = self._draining
        if any(p.spec.node_name == name and p.status.phase not in _TERMINAL for p in pods):
            self.descheduler.drain_node(name)
            return "draining"
        self.pool.shrink(name)
        self._draining = None
        self._idle_polls = 0
        SCALE_EVENTS.inc(direction="down")
        return "shrink"
