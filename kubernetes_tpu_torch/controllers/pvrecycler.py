"""PersistentVolumeRecycler: scrub Released Recycle-policy volumes
back into the Available pool.

Reference: pkg/volumeclaimbinder/persistent_volume_recycler.go — a
Released volume whose reclaim policy is Recycle is handed to its
volume plugin's recycler (the reference launches a scrub pod that
rm -rf's the volume contents, pv_recycler.go in pkg/volume/host_path),
then returned to the pool: claimRef cleared, phase back to Available,
so the NEXT claim can bind it without inheriting the old tenant's
data. Retain volumes stay Released forever (operator action).

Plugin recyclability is a probe, like the reference's
findRecyclablePluginBySpec (persistent_volume_claim_binder_test.go:
202-204): host_path is recyclable — the scrub is real deletion of the
directory's CONTENTS on this process substrate (the directory itself
survives: it is the volume). Sources with no recycler (NFS, cloud
disks) send the volume to Failed with a message, matching the
reference's error path, instead of silently re-pooling dirty storage.

The port's copy of `kubernetes_tpu/controllers/pvrecycler.py`.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Callable, Optional

from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.pvrecycler")

_RECYCLES = metrics.DEFAULT.counter(
    "pv_recycler_total", "PV recycler outcomes", ("result",)
)


def scrub_directory(path: str) -> None:
    """Delete the CONTENTS of `path`, keeping the directory.

    Refuses the filesystem root and missing/non-directory paths loudly:
    a malformed PV spec must fail the recycle (-> Failed phase), never
    wander the host deleting things.
    """
    real = os.path.realpath(path)
    if real == os.path.sep:
        raise OSError(f"refusing to scrub filesystem root ({path!r})")
    if not os.path.isdir(real):
        raise OSError(f"scrub target {path!r} is not a directory")
    for entry in os.listdir(real):
        full = os.path.join(real, entry)
        if os.path.isdir(full) and not os.path.islink(full):
            shutil.rmtree(full)
        else:
            os.unlink(full)


class PersistentVolumeRecycler:
    """Control loop pairing with PersistentVolumeClaimBinder (which
    moves Bound -> Released on claim deletion; this loop moves
    Released+Recycle -> scrub -> Available)."""

    def __init__(self, client, sync_period: float = 2.0):
        self.client = client
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PersistentVolumeRecycler":
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
                _LOG.exception("volume recycle pass failed")
                _RECYCLES.inc(result="error")
            self._stop.wait(self.sync_period)

    def sync_once(self) -> int:
        """Recycle every Released Recycle-policy volume; returns how
        many returned to Available."""
        volumes, _ = self.client.list("persistentvolumes")
        recycled = 0
        for pv in volumes:
            if pv.status.phase != "Released":
                continue
            if pv.spec.persistent_volume_reclaim_policy != "Recycle":
                continue
            scrub = self._scrubber_for(pv)
            if scrub is None:
                self._fail(
                    pv,
                    "no recyclable volume plugin for this source "
                    "(reference: findRecyclablePluginBySpec error path)",
                )
                continue
            try:
                scrub()
            except OSError as e:
                self._fail(pv, f"scrub failed: {e}")
                continue
            if self._repool(pv.metadata.name):
                recycled += 1
                _RECYCLES.inc(result="recycled")
        return recycled

    def _scrubber_for(self, pv) -> Optional[Callable[[], None]]:
        src = pv.spec.persistent_volume_source
        hp = getattr(src, "host_path", None)
        if hp is not None and hp.path:
            return lambda: scrub_directory(hp.path)
        return None

    def _repool(self, pv_name: str) -> bool:
        """Clear claimRef and set Available. GET-retry under CAS: the
        binder's status writes race ours."""
        for _ in range(3):
            try:
                fresh = self.client.get("persistentvolumes", pv_name)
            except APIError:
                return False
            fresh.spec.claim_ref = None
            try:
                fresh = self.client.update("persistentvolumes", fresh)
            except APIError as e:
                if e.code == 409:
                    continue
                return False
            fresh.status.phase = "Available"
            fresh.status.message = ""
            try:
                self.client.update_status("persistentvolumes", fresh)
            except APIError:
                pass
            return True
        return False

    def _fail(self, pv, message: str) -> None:
        pv.status.phase = "Failed"
        pv.status.message = message
        try:
            self.client.update_status("persistentvolumes", pv)
        except APIError:
            pass
        _RECYCLES.inc(result="failed")
