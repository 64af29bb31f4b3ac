"""Versioned object store with CAS and watch streams.

Plays the role of etcd + the reference's EtcdHelper
(pkg/tools/etcd_helper.go): a single source of truth with a global
logical clock (resourceVersion), compare-and-swap updates, and
history-replayable watch streams. In-process by design — the control
plane is one process with many threads; durability is via snapshot
checkpoints (everything device-side is reconstructible, SURVEY.md §5).

The port's copy of `kubernetes_tpu/store/` (kvstore and watch; the
replication module is not ported yet).
"""

from kubernetes_tpu_torch.store.kvstore import (
    AbortedError,
    CompactedError,
    ConflictError,
    KVStore,
    NotFoundError,
    AlreadyExistsError,
)
from kubernetes_tpu_torch.store.watch import Event, ADDED, MODIFIED, DELETED, ERROR

__all__ = [
    "KVStore",
    "AbortedError",
    "ConflictError",
    "NotFoundError",
    "AlreadyExistsError",
    "CompactedError",
    "Event",
    "ADDED",
    "MODIFIED",
    "DELETED",
    "ERROR",
]
