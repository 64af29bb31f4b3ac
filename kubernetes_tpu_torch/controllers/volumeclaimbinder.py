"""PersistentVolumeClaimBinder: match Pending claims to Available
volumes.

Reference: pkg/volumeclaimbinder/persistent_volume_claim_binder.go —
smallest-sufficient-volume matching on capacity + access modes, bind by
cross-referencing pv.spec.claimRef <-> pvc.spec.volumeName, release on
claim deletion honoring the reclaim policy (Retain keeps the volume
Released; Recycle returns it to Available).

The port's copy of `kubernetes_tpu/controllers/volumeclaimbinder.py`.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.models.apiobjects import ObjectReference
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.volumeclaimbinder")

_SYNCS = metrics.DEFAULT.counter(
    "pv_claim_binder_syncs_total", "PV claim binder passes", ("result",)
)


def _storage_milli(resource_list) -> int:
    q = (resource_list or {}).get("storage")
    return q.milli_value() if q is not None else 0


class PersistentVolumeClaimBinder:
    def __init__(self, client, sync_period: float = 2.0):
        self.client = client
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PersistentVolumeClaimBinder":
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
            except Exception:
                _LOG.exception("claim binder sync pass failed")
                _SYNCS.inc(result="error")
            self._stop.wait(self.sync_period)

    def sync_once(self) -> int:
        """Bind pending claims, release orphaned volumes; returns the
        number of bindings made."""
        volumes, _ = self.client.list("persistentvolumes")
        claims, _ = self.client.list("persistentvolumeclaims")
        bound = 0

        # Phase transitions for fresh volumes. Status writes bump the
        # resourceVersion, so re-list before the CAS'd bind updates.
        transitioned = False
        for pv in volumes:
            if pv.status.phase == "Pending":
                pv.status.phase = "Available"
                self._put_pv_status(pv)
                transitioned = True
        if transitioned:
            volumes, _ = self.client.list("persistentvolumes")

        # Release volumes whose claim vanished — including a claim
        # deleted and RECREATED under the same name (uid mismatch): the
        # reservation belonged to the old claim, never the new one.
        claim_uids = {
            (c.metadata.namespace, c.metadata.name): c.metadata.uid for c in claims
        }
        for pv in volumes:
            ref = pv.spec.claim_ref
            if ref is None:
                continue
            current_uid = claim_uids.get((ref.namespace, ref.name))
            if current_uid is not None and (not ref.uid or ref.uid == current_uid):
                continue  # the claim it references still exists
            if pv.status.phase == "Bound":
                self._release(pv)
            elif pv.status.phase != "Released":
                # Reserved (claimRef set) but never fully bound, and
                # the claim is gone: just return it to the pool.
                # Released volumes stay Released — Retain semantics;
                # re-pooling them would hand old data to a new tenant.
                self._rollback(pv.metadata.name)

        # Bind pending claims: smallest sufficient Available volume.
        available = [
            pv
            for pv in volumes
            if pv.status.phase in ("Available", "Pending")
            and pv.spec.claim_ref is None
        ]
        available.sort(key=lambda pv: _storage_milli(pv.spec.capacity))
        for claim in claims:
            if claim.status.phase == "Bound" or claim.spec.volume_name:
                continue
            # Self-heal: a volume already reserved for this claim by an
            # earlier partial bind completes first, instead of grabbing
            # (and stranding) a second volume.
            # Match by uid, not just ns/name: a Released volume whose
            # old claim shared this claim's NAME must never self-heal
            # onto the new claim (old tenant's data).
            reserved = next(
                (
                    pv
                    for pv in volumes
                    if pv.spec.claim_ref is not None
                    and pv.status.phase != "Released"
                    and (pv.spec.claim_ref.namespace, pv.spec.claim_ref.name)
                    == (claim.metadata.namespace, claim.metadata.name)
                    and (
                        not pv.spec.claim_ref.uid
                        or pv.spec.claim_ref.uid == claim.metadata.uid
                    )
                ),
                None,
            )
            if reserved is not None:
                if self._bind(reserved, claim):
                    bound += 1
                    _SYNCS.inc(result="bound")
                continue
            want = _storage_milli(
                claim.spec.resources.requests or claim.spec.resources.limits
            )
            modes = set(claim.spec.access_modes)
            match = None
            for pv in available:
                if _storage_milli(pv.spec.capacity) < want:
                    continue
                if not modes.issubset(set(pv.spec.access_modes)):
                    continue
                match = pv
                break
            if match is None:
                continue
            if self._bind(match, claim):
                available.remove(match)
                bound += 1
                _SYNCS.inc(result="bound")
        return bound

    def _bind(self, pv, claim) -> bool:
        ref = pv.spec.claim_ref
        already_reserved = ref is not None and (ref.namespace, ref.name) == (
            claim.metadata.namespace,
            claim.metadata.name,
        )
        if not already_reserved:
            pv.spec.claim_ref = ObjectReference(
                kind="PersistentVolumeClaim",
                namespace=claim.metadata.namespace,
                name=claim.metadata.name,
                uid=claim.metadata.uid,
            )
            try:
                pv = self.client.update("persistentvolumes", pv)
            except APIError:
                return False
        if pv.status.phase != "Bound":
            pv.status.phase = "Bound"
            self._put_pv_status(pv)
        claim.spec.volume_name = pv.metadata.name
        try:
            claim = self.client.update(
                "persistentvolumeclaims", claim, namespace=claim.metadata.namespace
            )
        except APIError as e:
            if e.code == 404:
                # Claim vanished: roll the volume back to Available.
                # (On transient errors the reservation stands — the
                # self-heal path in sync_once completes it next pass.)
                self._rollback(pv.metadata.name)
            return False
        claim.status.phase = "Bound"
        claim.status.capacity = dict(pv.spec.capacity)
        claim.status.access_modes = list(pv.spec.access_modes)
        try:
            self.client.update_status(
                "persistentvolumeclaims", claim, namespace=claim.metadata.namespace
            )
        except APIError:
            pass
        return True

    def _rollback(self, pv_name: str) -> None:
        """Return a reserved volume to Available. GET-retry (guaranteed
        update): the status writes in _bind bumped the resourceVersion
        past any copy we hold, so updating a stale object would always
        CAS-conflict and strand the volume claimRef'd but Available."""
        for _ in range(3):
            try:
                fresh = self.client.get("persistentvolumes", pv_name)
            except APIError:
                return
            fresh.spec.claim_ref = None
            try:
                fresh = self.client.update("persistentvolumes", fresh)
            except APIError as e:
                if e.code == 409:
                    continue
                return
            fresh.status.phase = "Available"
            self._put_pv_status(fresh)
            return

    def _release(self, pv) -> None:
        # Every reclaim policy goes through Released: Recycle volumes
        # are picked up from there by the PersistentVolumeRecycler
        # (scrub THEN re-pool — returning one to Available before the
        # scrub would hand the old tenant's data to the next claim);
        # Retain (and Delete, modeled as Retain + operator action)
        # stays Released forever.
        pv.status.phase = "Released"
        self._put_pv_status(pv)
        _SYNCS.inc(result="released")

    def _put_pv_status(self, pv) -> None:
        try:
            self.client.update_status("persistentvolumes", pv)
        except APIError:
            pass
