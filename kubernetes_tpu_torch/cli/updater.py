"""Rolling updater, scaler, and reapers — the kubectl operational tier.

Reference:
- pkg/kubectl/rolling_updater.go (RollingUpdater.Update): scale the new
  RC up and the old RC down one replica at a time, waiting for ready
  pods between steps, then delete the old RC and (when the caller asks)
  rename the new one to the old name.
- pkg/kubectl/scale.go (Scaler with retry): conflict-retrying scale
  with a wait-for-replicas option.
- pkg/kubectl/stop.go (reapers): deleting an RC first scales it to 0
  and waits for its pods to drain, so nothing re-creates them.

A copy of `kubernetes_tpu/cli/updater.py` over the port's client, with
three departures:

- The errors caught are the client's `APIError`
  (`client/rest.py`), which both of the port's transports raise; JAX's
  catches the apiserver's, which its transports raise. A 409 during a
  scale is then a retry, not a crash.
- Each scale-down of the old RC waits until its pods number the new
  count, as the reference's `scaleAndWait` does. JAX's does not wait,
  and deletes the old RC right after its scale to 0: the pods its
  manager has not removed by then run on, owned by no RC (in JAX's
  `tests/test_kubectl_tier.py` fixture, usually one).
- Objects are read in wire form and typed with the whole object model
  of the apiserver's registry (`models/apiobjects.py`), whatever model
  the given client types with: the port's `Client` types pods with the
  scheduler's trimmed model, and a pod written back from it would lose
  the fields that model leaves out.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.server.registry import RESOURCES


class UpdateTimeout(Exception):
    pass


def selector_string(selector) -> str:
    """Canonical label-selector string for a selector dict."""
    return ",".join(f"{k}={v}" for k, v in sorted((selector or {}).items()))


def get_typed(client, resource: str, name: str, namespace: str = ""):
    """One object, typed with the registry's whole model."""
    return serde.from_wire(RESOURCES[resource].cls,
                           client.get_wire(resource, name, namespace=namespace))


def list_typed(client, resource: str, namespace: str = "", label_selector: str = "",
               field_selector: str = ""):
    """(objects typed with the registry's whole model, the list's version)."""
    items, version = client.list_wire(resource, namespace=namespace,
                                      label_selector=label_selector,
                                      field_selector=field_selector)
    cls = RESOURCES[resource].cls
    return [serde.from_wire(cls, o) for o in items], version


def _wait(cond: Callable[[], bool], timeout: float, interval: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    if cond():
        return
    raise UpdateTimeout(f"timed out waiting for {what}")


class Scaler:
    """Conflict-retrying scaler (pkg/kubectl/scale.go ScaleWithRetries)."""

    def __init__(self, client, retries: int = 10, interval: float = 0.1):
        self.client = client
        self.retries = retries
        self.interval = interval

    def scale(
        self,
        name: str,
        replicas: int,
        namespace: str = "default",
        wait: bool = False,
        timeout: float = 30.0,
    ) -> None:
        for attempt in range(self.retries):
            rc = get_typed(self.client, "replicationcontrollers", name, namespace)
            rc.spec.replicas = replicas
            try:
                self.client.update(
                    "replicationcontrollers", rc, namespace=namespace
                )
                break
            except APIError as e:
                if e.code != 409 or attempt == self.retries - 1:
                    raise
                time.sleep(self.interval)
        if wait:
            # Selector is immutable for the duration of the wait: fetch
            # once, poll only the pod list.
            selector = self._selector(name, namespace)
            _wait(
                lambda: self._observed(selector, namespace) == replicas,
                timeout,
                0.1,
                f"rc {name} to reach {replicas} replicas",
            )

    def _observed(self, selector: str, namespace: str) -> int:
        pods, _ = list_typed(self.client, "pods", namespace, selector)
        return len([p for p in pods if p.status.phase not in ("Succeeded", "Failed")])

    def _selector(self, name: str, namespace: str) -> str:
        rc = get_typed(self.client, "replicationcontrollers", name, namespace)
        return selector_string(rc.spec.selector)


class RollingUpdater:
    """One-replica-at-a-time RC replacement (rolling_updater.go)."""

    def __init__(
        self,
        client,
        poll_interval: float = 0.2,
        update_period: float = 0.0,
        timeout: float = 60.0,
        progress: Optional[Callable[[str], None]] = None,
    ):
        self.client = client
        self.poll = poll_interval
        self.period = update_period
        self.timeout = timeout
        self._say = progress or (lambda msg: None)

    # -- helpers ------------------------------------------------------

    def _ready_count(self, rc, namespace: str) -> int:
        selector = selector_string(rc.spec.selector)
        pods, _ = list_typed(self.client, "pods", namespace, selector)
        ready = 0
        for p in pods:
            if p.status.phase != "Running":
                continue
            if any(
                c.type == "Ready" and c.status == "True"
                for c in p.status.conditions
            ):
                ready += 1
        return ready

    def _scale(self, name: str, replicas: int, namespace: str) -> None:
        Scaler(self.client).scale(name, replicas, namespace=namespace)

    def _ensure_disjoint(self, old, new_rc, namespace: str):
        """If the old RC's selector would adopt the NEW pods, retrofit a
        deployment-key label onto the old RC and its existing pods so
        the two controllers can't fight over replicas during the update
        (rolling_updater.go AddDeploymentKeyToReplicationController:
        label the live pods FIRST, then narrow the selector)."""
        import hashlib
        import json as _json

        old_sel = dict(old.spec.selector or {})
        new_labels = dict(
            (new_rc.spec.template.metadata.labels or {})
            if new_rc.spec.template is not None
            else {}
        )
        if not all(new_labels.get(k) == v for k, v in old_sel.items()):
            return old  # already disjoint
        key = hashlib.sha1(
            _json.dumps(serde.to_wire(old.spec.template), sort_keys=True).encode()
        ).hexdigest()[:8]
        pods, _ = list_typed(self.client, "pods", namespace, selector_string(old_sel))
        for pod in pods:
            if pod.metadata.labels.get("deployment") == key:
                continue
            pod.metadata.labels["deployment"] = key
            try:
                self.client.update("pods", pod, namespace=namespace)
            except APIError:
                pass  # pod vanished mid-retrofit; the RC will replace it
        old.spec.selector["deployment"] = key
        if old.spec.template is not None:
            old.spec.template.metadata.labels = dict(
                old.spec.template.metadata.labels or {}
            )
            old.spec.template.metadata.labels["deployment"] = key
        self.client.update("replicationcontrollers", old, namespace=namespace)
        return get_typed(self.client, "replicationcontrollers", old.metadata.name, namespace)

    # -- the update loop ----------------------------------------------

    def update(
        self,
        old_name: str,
        new_rc,
        namespace: str = "default",
        rename: bool = True,
    ) -> str:
        """Replace old_name's pods with new_rc's, one replica at a time.
        new_rc must carry a DIFFERENT selector than the old RC (the
        reference enforces a deployment-key label for the same reason:
        both RCs run concurrently and must not adopt each other's
        pods). Returns the surviving RC's name."""
        old = get_typed(self.client, "replicationcontrollers", old_name, namespace)
        desired = new_rc.spec.replicas or old.spec.replicas
        if new_rc.metadata.name == old_name:
            raise ValueError(
                "new RC must have a different name than the old RC"
            )
        if dict(new_rc.spec.selector) == dict(old.spec.selector):
            raise ValueError(
                "new RC must use a different selector than the old RC"
            )
        # Reverse-adoption guard: if the NEW selector matches the OLD
        # template's labels, the new RC would instantly adopt (and its
        # waits would count) the old pods — and no retrofit can fix the
        # new RC's identity for the user. Refuse up front.
        old_labels = dict(
            (old.spec.template.metadata.labels or {})
            if old.spec.template is not None
            else {}
        )
        new_sel = dict(new_rc.spec.selector or {})
        if new_sel and all(old_labels.get(k) == v for k, v in new_sel.items()):
            raise ValueError(
                "new RC's selector matches the old RC's pods; add a "
                "distinguishing label (e.g. a deployment key) to the new "
                "selector and template"
            )
        old = self._ensure_disjoint(old, new_rc, namespace)

        # Ensure the new RC exists, starting from 0 replicas.
        new_name = new_rc.metadata.name
        try:
            self.client.get_wire("replicationcontrollers", new_name, namespace=namespace)
        except APIError as e:
            if e.code != 404:
                raise
            created = copy.deepcopy(new_rc)
            created.spec.replicas = 0
            self.client.create(
                "replicationcontrollers", created, namespace=namespace
            )

        new_count = get_typed(
            self.client, "replicationcontrollers", new_name, namespace
        ).spec.replicas
        old_count = old.spec.replicas
        while new_count < desired or old_count > 0:
            if new_count < desired:
                new_count += 1
                self._say(f"Scaling {new_name} up to {new_count}")
                self._scale(new_name, new_count, namespace)
                new_obj = get_typed(
                    self.client, "replicationcontrollers", new_name, namespace
                )
                _wait(
                    lambda: self._ready_count(new_obj, namespace) >= new_count,
                    self.timeout,
                    self.poll,
                    f"{new_name} to have {new_count} ready pods",
                )
            if old_count > 0:
                old_count -= 1
                self._say(f"Scaling {old_name} down to {old_count}")
                # Wait for the old RC's pods to drain to the new count
                # (rolling_updater.go scaleAndWait): deleted right after
                # its scale to 0, the old RC would leave the pods its
                # manager had not removed yet running, owned by no RC.
                Scaler(self.client).scale(old_name, old_count, namespace=namespace,
                                          wait=True, timeout=self.timeout)
            if self.period:
                time.sleep(self.period)

        # Old RC drained: delete it (rolling_updater.go cleanup).
        self.client.delete(
            "replicationcontrollers", old_name, namespace=namespace
        )
        if rename and new_name != old_name:
            # Reference renames the new RC back to the old name so the
            # deployment keeps its identity (rolling_updater.go Rename:
            # delete + recreate under the old name; pods are adopted by
            # selector, not by RC name, so they are untouched).
            final = get_typed(
                self.client, "replicationcontrollers", new_name, namespace
            )
            self.client.delete(
                "replicationcontrollers", new_name, namespace=namespace
            )
            final.metadata.name = old_name
            final.metadata.resource_version = ""
            final.metadata.uid = ""
            self.client.create(
                "replicationcontrollers", final, namespace=namespace
            )
            return old_name
        return new_name


class Reaper:
    """Graceful deletion (stop.go): RCs drain before deletion so the
    controller can't re-create their pods."""

    def __init__(self, client, timeout: float = 30.0):
        self.client = client
        self.timeout = timeout

    def stop(self, resource: str, name: str, namespace: str = "default") -> None:
        if resource == "replicationcontrollers":
            scaler = Scaler(self.client)
            scaler.scale(name, 0, namespace=namespace, wait=True, timeout=self.timeout)
            self.client.delete(
                "replicationcontrollers", name, namespace=namespace
            )
            return
        self.client.delete(resource, name, namespace=namespace)
