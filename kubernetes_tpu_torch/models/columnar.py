"""Columnar (struct-of-arrays) encodings of pods and nodes.

This is the matrix schema consumed by the device scheduler path: the
reference's per-pod Go loops over object graphs
(plugin/pkg/scheduler/generic_scheduler.go:106-171,
plugin/pkg/scheduler/algorithm/predicates/predicates.go) become dense
ops over these arrays. Semantics mirror the scalar oracle
(kubernetes_tpu.scheduler.predicates/priorities) bit for bit wherever
integers allow.

A copy of `kubernetes_tpu/models/columnar.py` for the PyTorch port,
with the JAX package's optional ctypes helper replaced by the NumPy
helpers below. Objects are read by attribute only, so the JAX package's
API objects lower here exactly as the port's own do.

Design notes:
- Resources are lowered once, host-side, to integer-valued float32
  columns: CPU in millicores, memory in MiB. float32 holds integers
  exactly up to 2^24, i.e. 16 TiB of MiB-granular memory and 16M
  millicores — beyond any single node. Requests round UP to MiB and
  capacity rounds DOWN, so lowering can under-promise but never
  overcommit. Integer score truncation (priorities.go:39) is then exact
  on device for Mi-granular quantities.
- Resource accounting uses container LIMITS, matching the v0.19
  reference (getResourceRequest, predicates.go:106-114).
- PodFitsResources parity needs three per-node facts (predicates.go:
  116-156): the greedy-fitted usage sums, whether ANY existing pod
  overflowed the greedy simulation (such nodes reject every new pod),
  and the existing-pod count vs pods capacity. Priorities instead use
  the FULL usage sums including overflowing pods (calculateOccupancy,
  priorities.go:44-58). Both are encoded.
- Set-valued predicates (nodeSelector subset-match, hostPort conflicts,
  exclusive-disk conflicts) use snapshot-scoped vocabularies: every
  distinct key=value / port / volume-id observed is assigned an id, and
  membership becomes uint32 bitsets. Volumes carry two bitsets (all
  mounts vs read-write mounts) so the GCE-PD both-read-only exemption
  (predicates.go:59-66) survives lowering; AWS EBS volumes set both
  bits because they conflict regardless of read-only.
- Pods with identical selector sets share a row in a deduped selector
  table, so selector bitsets are stored once per distinct selector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.models.algspec import (
    AlgorithmSpec,
    LoweredSpec,
    lower_spec,
)
from kubernetes_tpu_torch.models.objects import (
    Node,
    Pod,
    REBALANCE_DEST_ANNOTATION,
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Service,
)

MIB = 1024 * 1024

# Services a single pod can belong to on device (top-K id list; pods
# matching more than SVC_K services contribute only their first SVC_K —
# far beyond any realistic overlap). Shared by the device path
# (ops.matrices), the sequential oracle, and the incremental session so
# truncation is identical everywhere.
SVC_K = 8


# ---------------------------------------------------------------------------
# Vocabularies
# ---------------------------------------------------------------------------


class Vocab:
    """Snapshot-scoped string->id mapping used for bitset encodings."""

    def __init__(self):
        self.index: Dict[str, int] = {}

    def id(self, token: str) -> int:
        i = self.index.get(token)
        if i is None:
            i = len(self.index)
            self.index[token] = i
        return i

    def __len__(self) -> int:
        return len(self.index)

    @property
    def words(self) -> int:
        """Number of uint32 words needed for a bitset (at least 1)."""
        return max(1, (len(self.index) + 31) // 32)


def bitset(ids: Sequence[int], words: int) -> np.ndarray:
    out = np.zeros(words, dtype=np.uint32)
    for i in ids:
        out[i >> 5] |= np.uint32(1 << (i & 31))
    return out


def pack_bitsets(id_lists: Sequence[Sequence[int]], words: int) -> np.ndarray:
    """Rows of ids -> u32[n_rows, words] bitsets."""
    n = len(id_lists)
    out = np.zeros((n, words), dtype=np.uint32)
    # Most backlogs have no hostPorts/volumes on most pods: a truthiness
    # sweep is far cheaper than building the flat index arrays.
    if n == 0 or not any(id_lists):
        return out
    counts = np.fromiter((len(ids) for ids in id_lists), dtype=np.int64, count=n)
    flat = np.fromiter(
        (i for ids in id_lists for i in ids), dtype=np.int64, count=int(counts.sum())
    )
    if int(flat.min()) < 0 or int(flat.max()) >= words * 32:
        raise IndexError(
            f"bitset id out of range for {words} words "
            f"(max {int(flat.max())}, min {int(flat.min())})"
        )
    rows = np.repeat(np.arange(n), counts)
    bits = np.left_shift(np.uint32(1), (flat & 31).astype(np.uint32))
    np.bitwise_or.at(out, (rows, flat >> 5), bits)
    return out


def or_rows_by_index(
    node_idx: np.ndarray, pod_rows: np.ndarray, node_rows: np.ndarray
) -> None:
    """node_rows[node_idx[i]] |= pod_rows[i] in place (node_idx < 0 skipped)."""
    keep = node_idx >= 0
    np.bitwise_or.at(node_rows, node_idx[keep], pod_rows[keep])


def greedy_fit(
    node_idx: np.ndarray,
    cpu: np.ndarray,
    mem: np.ndarray,
    cpu_cap: np.ndarray,
    mem_cap: np.ndarray,
    cpu_fit: np.ndarray,
    mem_fit: np.ndarray,
    over: np.ndarray,
    cpu_used: np.ndarray,
    mem_used: np.ndarray,
    pods_used: np.ndarray,
) -> None:
    """Assigned-pod occupancy sweep, in place, in list order
    (reference MapPodsToMachines / CheckPodsExceedingCapacity): every
    pod counts toward the full usage sums; a pod that does not fit the
    greedy-fitted sums marks its node overcommitted instead."""
    for i, j in enumerate(node_idx.tolist()):
        if j < 0:
            continue
        c, m = cpu[i], mem[i]
        cpu_used[j] += c
        mem_used[j] += m
        pods_used[j] += 1
        fits_cpu = cpu_cap[j] == 0 or cpu_fit[j] + c <= cpu_cap[j]
        fits_mem = mem_cap[j] == 0 or mem_fit[j] + m <= mem_cap[j]
        if fits_cpu and fits_mem:
            cpu_fit[j] += c
            mem_fit[j] += m
        else:
            over[j] = True


# ---------------------------------------------------------------------------
# Resource lowering
# ---------------------------------------------------------------------------


def pod_resource_limits(pod: Pod) -> Tuple[int, int]:
    """Sum of container LIMITS: (milli-CPU, memory bytes).

    Reference: predicates.go:106-114 getResourceRequest — v0.19 sums
    limits.Cpu().MilliValue() and limits.Memory().Value().
    """
    cpu = 0
    mem = 0
    for c in pod.spec.containers:
        lim = c.resources.limits
        if RESOURCE_CPU in lim:
            cpu += lim[RESOURCE_CPU].milli_value()
        if RESOURCE_MEMORY in lim:
            mem += lim[RESOURCE_MEMORY].value()
    return cpu, mem


def mem_to_mib_ceil(mem_bytes: int) -> int:
    return -((-mem_bytes) // MIB)


def pod_host_ports(pod: Pod) -> List[int]:
    """Nonzero hostPorts (getUsedPorts skips 0 at the check site,
    predicates.go:337-349)."""
    ports = []
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                ports.append(p.host_port)
    return ports


def pod_volumes(pod: Pod) -> List[Tuple[str, bool]]:
    """Exclusive volumes as (id, read_write) pairs.

    GCE PD mounts conflict unless BOTH are read-only; AWS EBS mounts
    always conflict (isVolumeConflict, predicates.go:53-78) — EBS is
    returned as read_write=True regardless.
    """
    vols = []
    for v in pod.spec.volumes:
        if v.gce_persistent_disk is not None and v.gce_persistent_disk.pd_name:
            vols.append(
                ("gce-pd:" + v.gce_persistent_disk.pd_name,
                 not v.gce_persistent_disk.read_only)
            )
        if (
            v.aws_elastic_block_store is not None
            and v.aws_elastic_block_store.volume_id
        ):
            vols.append(("aws-ebs:" + v.aws_elastic_block_store.volume_id, True))
    return vols


# ---------------------------------------------------------------------------
# Columnar batches
# ---------------------------------------------------------------------------


@dataclass
class PodColumns:
    """Struct-of-arrays for P pending pods."""

    names: List[str]  # namespace/name keys, host-side only
    cpu_milli: np.ndarray  # f32[P]
    mem_mib: np.ndarray  # f32[P]
    zero_req: np.ndarray  # bool[P] — cpu==0 and mem==0 (different fit rule)
    selector_id: np.ndarray  # i32[P] — row into sel_bits (0 = empty selector)
    port_bits: np.ndarray  # u32[P, PW]
    vol_any_bits: np.ndarray  # u32[P, VW] — all exclusive mounts
    vol_rw_bits: np.ndarray  # u32[P, VW] — read-write mounts only
    pinned_node: np.ndarray  # i32[P] — node index, -1 unpinned, -2 unknown
    service_id: np.ndarray  # i32[P] — first matching service, -1 if none
    svc_topk: np.ndarray  # i32[P, SVC_K] — matching service ids, -1 pad
    sel_bits: np.ndarray  # u32[U, LW] — deduped selector table
    # Policy-spec columns (None unless a non-default spec is lowered):
    # per ServiceAffinity label: the pod's pinned nodeSelector pair id
    # (label vocab id of "l=v"), -1 when the pod doesn't pin it.
    aff_pin: Optional[np.ndarray] = None  # i32[P, K]

    @property
    def count(self) -> int:
        return len(self.names)


@dataclass
class NodeColumns:
    """Struct-of-arrays for N nodes (capacity + current occupancy)."""

    names: List[str]
    cpu_cap: np.ndarray  # f32[N] millicores
    mem_cap: np.ndarray  # f32[N] MiB
    pods_cap: np.ndarray  # f32[N] max pods
    # Feasibility-side occupancy: greedy-fitted sums + overflow flag
    # (CheckPodsExceedingCapacity semantics).
    cpu_fit_used: np.ndarray  # f32[N]
    mem_fit_used: np.ndarray  # f32[N]
    overcommitted: np.ndarray  # bool[N] — some existing pod overflowed
    # Scoring-side occupancy: FULL sums (calculateOccupancy semantics).
    cpu_used: np.ndarray  # f32[N]
    mem_used: np.ndarray  # f32[N]
    pods_used: np.ndarray  # f32[N] — count of existing (non-terminal) pods
    label_bits: np.ndarray  # u32[N, LW]
    used_port_bits: np.ndarray  # u32[N, PW]
    used_vol_any_bits: np.ndarray  # u32[N, VW]
    used_vol_rw_bits: np.ndarray  # u32[N, VW]
    service_counts: np.ndarray  # f32[N, S] — matching-pod count per service
    schedulable: np.ndarray  # bool[N] — Ready and not unschedulable
    # Policy-spec columns (None unless a non-default spec is lowered):
    policy_ok: Optional[np.ndarray] = None  # bool[N] — NodeLabelPresence AND
    static_prio: Optional[np.ndarray] = None  # i32[N] — LabelPreference sum
    aff_vid: Optional[np.ndarray] = None  # i32[N, K] — "l=value" pair ids
    aa_zone: Optional[np.ndarray] = None  # i32[N, I] — anti-affinity zones

    @property
    def count(self) -> int:
        return len(self.names)


@dataclass
class Snapshot:
    """One scheduling problem: P pending pods x N nodes."""

    pods: PodColumns
    nodes: NodeColumns
    label_vocab: Vocab
    port_vocab: Vocab
    vol_vocab: Vocab
    service_names: List[str]
    # Non-default policy lowering (None for the default pipeline):
    lowered: Optional[LoweredSpec] = None
    weights: Optional[Tuple[int, int, int]] = None
    # ServiceAffinity / ServiceAntiAffinity carry seeds, one slot per
    # service: index of the node hosting each service's FIRST listed
    # peer (-1 none, -2 unknown node — the scalar's error case), and
    # the phase-unfiltered peer count (numServicePods).
    anchor_init: Optional[np.ndarray] = None  # i32[max(S,1)]
    svc_total_init: Optional[np.ndarray] = None  # f32[max(S,1)]


def pod_key(pod: Pod) -> str:
    """Canonical 'namespace/name' key with the empty namespace
    normalized to 'default' — the SAME scheme the daemons' pending-path
    maps, gang keys, and preemption records use (models.objects.
    pod_full_key is the typed twin). One scheme everywhere: a pod
    created with namespace='' must solve, match, and bind under ONE
    key, never slip between '/p' and 'default/p' (ADVICE r5)."""
    return f"{pod.metadata.namespace or 'default'}/{pod.metadata.name}"


def node_is_ready(node: Node) -> bool:
    """Reference: StoreToNodeLister filters to Ready nodes
    (pkg/client/cache/listers.go) and spec.unschedulable gates fit."""
    if node.spec.unschedulable:
        return False
    for c in node.status.conditions:
        if c.type == "Ready":
            return c.status == "True"
    # Nodes with no conditions reported are treated as ready (matches the
    # reference's permissive default for freshly registered nodes).
    return True


_EMPTY_IDS = np.zeros(0, dtype=np.int64)


class ServiceMatcher:
    """Inverted index over service selectors: pod -> multi-hot
    membership in O(pod labels), not O(services).

    Semantics identical to the naive scan: a pod matches a service iff
    they share a namespace, the selector is non-empty, and every
    selector pair appears in the pod's labels. The pending pod spreads
    against its FIRST match (GetPodServices / spreading.go:44-56), but
    as an *existing* pod it is counted by every matching service
    (pod_lister.list(selector) in CalculateSpreadPriority). At 50k
    pods x 500 services the naive scan is 25M dict compares — the
    dominant host cost of snapshot lowering.
    """

    def __init__(self, services: List[Service]):
        self.S = len(services)
        self.out_width = max(self.S, 1)
        # namespace -> ((k,v) -> np.array of service indices)
        self._pair_index: Dict[str, Dict[Tuple[str, str], np.ndarray]] = {}
        self._sel_size = np.zeros(max(self.S, 1), dtype=np.int32)
        # Pods from one RC share an identical label set, so membership
        # is memoized by (namespace, labels) signature: a 50k-pod
        # backlog with a few hundred distinct templates costs a few
        # hundred matches, not 50k. Bounded: long-lived sessions
        # (incremental.SolverSession holds one matcher for its life)
        # feeding per-pod-unique labels must not grow host memory
        # without limit — on overflow the cache resets wholesale
        # (recomputing a membership is cheap; unbounded growth is not).
        self._id_cache: Dict[Tuple, Tuple[np.ndarray, int]] = {}
        self._cache_limit = 65536
        by_ns: Dict[str, Dict[Tuple[str, str], List[int]]] = {}
        for i, svc in enumerate(services):
            sel = svc.spec.selector
            if not sel:
                continue  # selector-less services never match
            self._sel_size[i] = len(sel)
            ns_idx = by_ns.setdefault(svc.metadata.namespace, {})
            for pair in sel.items():
                ns_idx.setdefault(pair, []).append(i)
        for ns, idx in by_ns.items():
            self._pair_index[ns] = {
                pair: np.asarray(ids, dtype=np.int64) for pair, ids in idx.items()
            }

    def membership_ids(self, pod: Pod) -> Tuple[np.ndarray, int]:
        """(sorted matching service indices i64[k], first index or -1),
        memoized by (namespace, labels) signature."""
        labels = pod.metadata.labels
        ns = pod.metadata.namespace
        if not labels or ns not in self._pair_index:
            return _EMPTY_IDS, -1
        # Tuple of items, not frozenset: ~2x cheaper to build+hash, and
        # this key construction runs once per pod on the lowering
        # critical path. Same labels in a different insertion order
        # produce a second (identical-valued) entry — harmless.
        key = (ns, tuple(labels.items()))
        hit = self._id_cache.get(key)
        if hit is not None:
            return hit
        idx = self._pair_index[ns]
        counts = np.zeros(self.out_width, dtype=np.int32)
        for pair in labels.items():
            ids = idx.get(pair)
            if ids is not None:
                counts[ids] += 1
        matched = np.nonzero((counts == self._sel_size) & (self._sel_size > 0))[0]
        hit = (matched, int(matched[0]) if len(matched) else -1)
        if len(self._id_cache) >= self._cache_limit:
            self._id_cache.clear()
        self._id_cache[key] = hit
        return hit


class SnapshotBuilder:
    """Two-phase lowering: a cheap vocabulary pass over ALL objects,
    then column fills that may be CHUNKED over the pending backlog.

    Chunking exists so the host->device pipeline can overlap: lower
    chunk k+1 on the host while the device solves chunk k (the solver
    carry chains placements across chunks, so decisions are identical
    to one monolithic solve). build_snapshot() is the one-shot wrapper.
    """

    def __init__(
        self,
        pending_pods: Sequence[Pod],
        nodes: Sequence[Node],
        assigned_pods: Sequence[Pod] = (),
        services: Sequence[Service] = (),
        spec: Optional[AlgorithmSpec] = None,
    ):
        # A non-default AlgorithmSpec adds policy columns (and may
        # raise UnloweredPolicyError right here, before any lowering
        # work — the batch daemon catches it and runs the scalar path).
        self.spec = None if spec is None or spec.is_default() else spec
        if self.spec is not None:
            self._lowered_partial, self._weights = lower_spec(self.spec)
        self.nodes = list(nodes)
        self.pending = list(pending_pods)
        self.services = list(services)
        # Terminal-phase filtering applies to OCCUPANCY
        # (MapPodsToMachines / filterNonRunningPods,
        # predicates.go:361-377) but NOT to service spreading counts —
        # CalculateSpreadPriority lists pods by selector with no phase
        # filter (spreading.go:44-57).
        self.all_assigned = list(assigned_pods)
        self.assigned = [
            p
            for p in self.all_assigned
            if p.status.phase not in ("Succeeded", "Failed")
        ]
        self.node_index = {n.metadata.name: i for i, n in enumerate(self.nodes)}
        self.S = len(self.services)
        self.matcher = ServiceMatcher(self.services)
        self.label_vocab, self.port_vocab, self.vol_vocab = (
            Vocab(),
            Vocab(),
            Vocab(),
        )

        # -- vocabulary passes (one sweep each; selector table dedup) --
        for n in self.nodes:
            for k, v in (n.metadata.labels or {}).items():
                self.label_vocab.id(f"{k}={v}")
        # Vocab pass over every pod: fully serial before the first
        # chunk can lower, so it sits on the pipelined solve's critical
        # path — locals bound outside the loop, helper calls inlined,
        # and the overwhelmingly common empty selector/port/volume
        # cases short-circuited (was ~0.18s of the 50k wall).
        self.sel_keys: Dict[Tuple[Tuple[str, str], ...], int] = {(): 0}
        self._pod_sel_rows = np.zeros(len(self.pending), dtype=np.int32)
        label_id = self.label_vocab.id
        port_id = self.port_vocab.id
        vol_id = self.vol_vocab.id
        sel_keys = self.sel_keys
        sel_rows = self._pod_sel_rows
        for i, p in enumerate(self.pending):
            spec = p.spec
            nsel = spec.node_selector
            if nsel:
                sel = tuple(sorted(nsel.items()))
                for k, v in sel:
                    label_id(f"{k}={v}")
                sel_rows[i] = sel_keys.setdefault(sel, len(sel_keys))
            for c in spec.containers:
                for cp in c.ports:
                    if cp.host_port > 0:
                        port_id(str(cp.host_port))
            if spec.volumes:
                for vol, _rw in pod_volumes(p):
                    vol_id(vol)
        for p in self.assigned:
            for c in p.spec.containers:
                for cp in c.ports:
                    if cp.host_port > 0:
                        port_id(str(cp.host_port))
            if p.spec.volumes:
                for vol, _rw in pod_volumes(p):
                    vol_id(vol)
        self.LW = self.label_vocab.words
        self.PW = self.port_vocab.words
        self.VW = self.vol_vocab.words
        self._sel_bits: Optional[np.ndarray] = None

    @property
    def sel_bits(self) -> np.ndarray:
        if self._sel_bits is None:
            out = np.zeros((len(self.sel_keys), self.LW), dtype=np.uint32)
            for sel, row in self.sel_keys.items():
                out[row] = bitset(
                    [self.label_vocab.id(f"{k}={v}") for k, v in sel], self.LW
                )
            self._sel_bits = out
        return self._sel_bits

    def pod_columns(self, start: int = 0, stop: Optional[int] = None) -> PodColumns:
        """Lower pending pods [start:stop) (the whole backlog by
        default). Chunks share the global vocabularies/selector table."""
        stop = len(self.pending) if stop is None else stop
        chunk = self.pending[start:stop]
        P = len(chunk)
        # This loop IS the serial "lower" phase of the pipelined solve
        # (the only host work on the 50k-backlog critical path), so the
        # extraction helpers (pod_resource_limits / pod_host_ports /
        # pod_volumes — the single-pod API, kept for tests and scalar
        # callers) are inlined here with locals bound outside the loop:
        # per-pod function-call + per-element ndarray-store overhead was
        # ~40% of the phase at 50k pods.
        cpu_list: List[float] = []
        mem_list: List[int] = []
        zero_list: List[bool] = []
        pinned = np.full(P, -1, dtype=np.int32)
        service_id = np.full(P, -1, dtype=np.int32)
        svc_topk = np.full((P, SVC_K), -1, dtype=np.int32)
        port_id_lists: List[List[int]] = []
        vol_any_lists: List[List[int]] = []
        vol_rw_lists: List[List[int]] = []
        port_vocab_id = self.port_vocab.id
        vol_vocab_id = self.vol_vocab.id
        node_index_get = self.node_index.get
        membership_ids = self.matcher.membership_ids
        cpu_key, mem_key = RESOURCE_CPU, RESOURCE_MEMORY
        for i, p in enumerate(chunk):
            spec = p.spec
            cpu = 0
            mem = 0
            port_ids: List[int] = []
            for c in spec.containers:
                lim = c.resources.limits
                q = lim.get(cpu_key)
                if q is not None:
                    cpu += q.milli_value()
                q = lim.get(mem_key)
                if q is not None:
                    mem += q.value()
                for cp in c.ports:
                    hp = cp.host_port
                    if hp > 0:
                        port_ids.append(port_vocab_id(str(hp)))
            cpu_list.append(cpu)
            mem_list.append(-((-mem) // MIB))  # mem_to_mib_ceil
            zero_list.append(cpu == 0 and mem == 0)
            port_id_lists.append(port_ids)
            vol_any: List[int] = []
            vol_rw: List[int] = []
            for v in spec.volumes:
                pd = v.gce_persistent_disk
                if pd is not None and pd.pd_name:
                    vid = vol_vocab_id("gce-pd:" + pd.pd_name)
                    vol_any.append(vid)
                    if not pd.read_only:
                        vol_rw.append(vid)
                ebs = v.aws_elastic_block_store
                if ebs is not None and ebs.volume_id:
                    vid = vol_vocab_id("aws-ebs:" + ebs.volume_id)
                    vol_any.append(vid)
                    vol_rw.append(vid)
            vol_any_lists.append(vol_any)
            vol_rw_lists.append(vol_rw)
            if spec.node_name:
                pinned[i] = node_index_get(spec.node_name, -2)
            else:
                # Rebalance nomination: a pod the descheduler recreated
                # after a defrag eviction carries its planned
                # destination as an annotation (mirrored in
                # status.nominatedNodeName); honor it as a HostName pin
                # so the micro-tick daemon rebinds it there. Unknown
                # node -> unpinned (-1): a destination that vanished
                # mid-move must not strand the pod, it just re-solves
                # anywhere.
                dest = (p.metadata.annotations or {}).get(
                    REBALANCE_DEST_ANNOTATION, ""
                )
                if dest:
                    pinned[i] = node_index_get(dest, -1)
            ids, first = membership_ids(p)
            if len(ids):
                k = min(len(ids), SVC_K)
                svc_topk[i, :k] = ids[:k]
                service_id[i] = first
        cpu_req = np.asarray(cpu_list, dtype=np.float32)
        mem_req = np.asarray(mem_list, dtype=np.float32)
        zero_req = np.asarray(zero_list, dtype=bool)
        aff_pin = None
        if self.spec is not None and self.spec.affinity_labels:
            # ServiceAffinity: per affinity label, the pod's pinned
            # "l=v" pair id from its nodeSelector (predicates.go:273-281
            # — pinned values are never overridden by the anchor peer).
            aff = self.spec.affinity_labels
            aff_pin = np.full((P, len(aff)), -1, dtype=np.int32)
            for i, p in enumerate(chunk):
                nsel = p.spec.node_selector or {}
                for k, label in enumerate(aff):
                    if label in nsel:
                        aff_pin[i, k] = self.label_vocab.id(
                            f"{label}={nsel[label]}"
                        )
        return PodColumns(
            names=[pod_key(p) for p in chunk],
            cpu_milli=cpu_req,
            mem_mib=mem_req,
            zero_req=zero_req,
            selector_id=self._pod_sel_rows[start:stop],
            port_bits=pack_bitsets(port_id_lists, self.PW),
            vol_any_bits=pack_bitsets(vol_any_lists, self.VW),
            vol_rw_bits=pack_bitsets(vol_rw_lists, self.VW),
            pinned_node=pinned,
            service_id=service_id,
            svc_topk=svc_topk,
            sel_bits=self.sel_bits,
            aff_pin=aff_pin,
        )

    def node_columns(self) -> NodeColumns:
        nodes, N = self.nodes, len(self.nodes)
        LW, PW, VW = self.LW, self.PW, self.VW
        cpu_cap = np.zeros(N, dtype=np.float32)
        mem_cap = np.zeros(N, dtype=np.float32)
        pods_cap = np.zeros(N, dtype=np.float32)
        cpu_fit_used = np.zeros(N, dtype=np.float32)
        mem_fit_used = np.zeros(N, dtype=np.float32)
        overcommitted = np.zeros(N, dtype=bool)
        cpu_used = np.zeros(N, dtype=np.float32)
        mem_used = np.zeros(N, dtype=np.float32)
        pods_used = np.zeros(N, dtype=np.float32)
        label_bits = np.zeros((N, LW), dtype=np.uint32)
        used_port_bits = np.zeros((N, PW), dtype=np.uint32)
        used_vol_any = np.zeros((N, VW), dtype=np.uint32)
        used_vol_rw = np.zeros((N, VW), dtype=np.uint32)
        service_counts = np.zeros((N, max(self.S, 1)), dtype=np.float32)
        schedulable = np.zeros(N, dtype=bool)
        for j, n in enumerate(nodes):
            cap = n.status.capacity or {}
            if RESOURCE_CPU in cap:
                cpu_cap[j] = cap[RESOURCE_CPU].milli_value()
            if RESOURCE_MEMORY in cap:
                # Capacity rounds DOWN (requests round up) so lowering
                # can only under-promise, never overcommit a node.
                mem_cap[j] = cap[RESOURCE_MEMORY].value() // MIB
            if RESOURCE_PODS in cap:
                pods_cap[j] = cap[RESOURCE_PODS].value()
            label_bits[j] = bitset(
                [
                    self.label_vocab.id(f"{k}={v}")
                    for k, v in (n.metadata.labels or {}).items()
                ],
                LW,
            )
            schedulable[j] = node_is_ready(n)

        # Assigned-pod occupancy sweep (MapPodsToMachines greedy order
        # = list order).
        A = len(self.assigned)
        a_idx = np.full(A, -1, dtype=np.int32)
        a_cpu = np.zeros(A, dtype=np.float32)
        a_mem = np.zeros(A, dtype=np.float32)
        a_port_lists: List[List[int]] = []
        a_vol_any_lists: List[List[int]] = []
        a_vol_rw_lists: List[List[int]] = []
        for i, p in enumerate(self.assigned):
            j = self.node_index.get(p.spec.node_name)
            a_idx[i] = -1 if j is None else j
            cpu, mem = pod_resource_limits(p)
            a_cpu[i] = cpu
            a_mem[i] = mem_to_mib_ceil(mem)
            a_port_lists.append(
                [self.port_vocab.id(str(x)) for x in pod_host_ports(p)]
            )
            vols = pod_volumes(p)
            a_vol_any_lists.append([self.vol_vocab.id(v) for v, _ in vols])
            a_vol_rw_lists.append(
                [self.vol_vocab.id(v) for v, rw in vols if rw]
            )
        greedy_fit(
            a_idx, a_cpu, a_mem, cpu_cap, mem_cap,
            cpu_fit_used, mem_fit_used, overcommitted, cpu_used, mem_used,
            pods_used,
        )
        or_rows_by_index(
            a_idx, pack_bitsets(a_port_lists, PW), used_port_bits
        )
        or_rows_by_index(
            a_idx, pack_bitsets(a_vol_any_lists, VW), used_vol_any
        )
        or_rows_by_index(
            a_idx, pack_bitsets(a_vol_rw_lists, VW), used_vol_rw
        )

        # Spreading counts: every pod (phase-unfiltered) contributes to
        # every service whose selector matches its labels.
        for p in self.all_assigned:
            j = self.node_index.get(p.spec.node_name)
            if j is None:
                continue
            ids, _ = self.matcher.membership_ids(p)
            if len(ids):
                service_counts[j, ids] += 1.0

        policy_ok = static_prio = aff_vid = aa_zone = None
        if self.spec is not None:
            policy_ok, static_prio, aff_vid, aa_zone = self._policy_node_columns()

        return NodeColumns(
            names=[n.metadata.name for n in nodes],
            cpu_cap=cpu_cap,
            mem_cap=mem_cap,
            pods_cap=pods_cap,
            cpu_fit_used=cpu_fit_used,
            mem_fit_used=mem_fit_used,
            overcommitted=overcommitted,
            cpu_used=cpu_used,
            mem_used=mem_used,
            pods_used=pods_used,
            label_bits=label_bits,
            used_port_bits=used_port_bits,
            used_vol_any_bits=used_vol_any,
            used_vol_rw_bits=used_vol_rw,
            service_counts=service_counts,
            schedulable=schedulable,
            policy_ok=policy_ok,
            static_prio=static_prio,
            aff_vid=aff_vid,
            aa_zone=aa_zone,
        )

    # -- policy-spec lowering -----------------------------------------

    def _policy_node_columns(self):
        """Node-side columns for the configurable vocabulary. All are
        pure node facts, so they lower host-side to static columns; the
        order-dependent ServiceAffinity anchor state lives in the
        solver carry instead (seeded by _service_seeds)."""
        spec, N = self.spec, len(self.nodes)
        node_labels = [n.metadata.labels or {} for n in self.nodes]
        # CheckNodeLabelPresence (predicates.go:226-240): pod-independent
        # — one AND-combined bool per node across all instances.
        policy_ok = None
        checkers = [p for p in spec.predicates if p.kind == "NodeLabelPresence"]
        if checkers:
            policy_ok = np.ones(N, dtype=bool)
            for j, labels in enumerate(node_labels):
                for c in checkers:
                    for label in c.labels:
                        exists = label in labels
                        if (exists and not c.presence) or (
                            not exists and c.presence
                        ):
                            policy_ok[j] = False
                            break
                    else:
                        continue
                    break
        # CalculateNodeLabelPriority (priorities.go:113-138): static
        # 10-or-0 per node, summed over instances with weights.
        static_prio = None
        prefs = [
            p
            for p in spec.priorities
            if p.kind == "LabelPreference" and p.weight != 0
        ]
        if prefs:
            static_prio = np.zeros(N, dtype=np.int32)
            for j, labels in enumerate(node_labels):
                for p in prefs:
                    exists = p.label in labels
                    if (exists and p.presence) or (not exists and not p.presence):
                        static_prio[j] += 10 * p.weight
        # ServiceAffinity: per node per affinity label, the "l=value"
        # pair id (shared vocab with pod nodeSelector pins, so equality
        # is one integer compare on device).
        aff_vid = None
        aff = spec.affinity_labels
        if aff:
            aff_vid = np.full((N, len(aff)), -1, dtype=np.int32)
            for j, labels in enumerate(node_labels):
                for k, label in enumerate(aff):
                    if label in labels:
                        aff_vid[j, k] = self.label_vocab.id(
                            f"{label}={labels[label]}"
                        )
        # ServiceAntiAffinity (spreading.go:105-169): nodes partition
        # into zones by the value of one label; -1 = unlabeled (scores
        # a flat 0). Zone vocabularies are per instance and compact,
        # bucketed to 16 so value churn reuses compiled executables.
        aa_zone = None
        self._aa_zones: Tuple[int, ...] = ()
        # Filter EXACTLY like lower_spec filters aa_weights: columns
        # here and weights there are zipped positionally in the solver.
        antis = [
            p
            for p in spec.priorities
            if p.kind == "ServiceAntiAffinity" and p.weight != 0
        ]
        if antis:
            aa_zone = np.full((N, len(antis)), -1, dtype=np.int32)
            zones = []
            for i, p in enumerate(antis):
                vocab: Dict[str, int] = {}
                for j, labels in enumerate(node_labels):
                    if p.label in labels:
                        aa_zone[j, i] = vocab.setdefault(
                            labels[p.label], len(vocab)
                        )
                zones.append(max(16, -(-len(vocab) // 16) * 16))
            self._aa_zones = tuple(zones)
        return policy_ok, static_prio, aff_vid, aa_zone

    def _service_seeds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Seed the ServiceAffinity/AntiAffinity carry from the
        already-assigned pods: per service, the node index of the FIRST
        listed peer (nsServicePods[0], predicates.go:301-313; -1 no
        peers, -2 peer on an unknown node = the scalar's GetNodeInfo
        error, which fails the pod everywhere) and the peer count
        (numServicePods, spreading.go:150 — node-presence-unfiltered)."""
        S1 = max(self.S, 1)
        anchor = np.full(S1, -1, dtype=np.int32)
        total = np.zeros(S1, dtype=np.float32)
        for p in self.all_assigned:
            ids, _ = self.matcher.membership_ids(p)
            if not len(ids):
                continue
            total[ids] += 1.0
            j = self.node_index.get(p.spec.node_name)
            for sid in ids:
                if anchor[sid] == -1:
                    anchor[sid] = -2 if j is None else j
        return anchor, total

    def snapshot(self) -> Snapshot:
        pods = self.pod_columns()
        nodes = self.node_columns()
        lowered = weights = anchor = svc_total = None
        if self.spec is not None:
            lowered = self._lowered_partial._replace(aa_zones=self._aa_zones)
            weights = self._weights
            if lowered.service_affinity or lowered.aa_weights:
                anchor, svc_total = self._service_seeds()
        return Snapshot(
            pods=pods,
            nodes=nodes,
            label_vocab=self.label_vocab,
            port_vocab=self.port_vocab,
            vol_vocab=self.vol_vocab,
            service_names=[
                f"{s.metadata.namespace}/{s.metadata.name}"
                for s in self.services
            ],
            lowered=lowered,
            weights=weights,
            anchor_init=anchor,
            svc_total_init=svc_total,
        )


def build_snapshot(
    pending_pods: Sequence[Pod],
    nodes: Sequence[Node],
    assigned_pods: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    spec: Optional[AlgorithmSpec] = None,
) -> Snapshot:
    """Lower API objects into a dense scheduling snapshot.

    `assigned_pods` are pods already bound to nodes; they contribute to
    occupancy the way MapPodsToMachines does (predicates.go:379-392),
    with terminal-phase pods filtered out. A non-default `spec` adds
    the policy columns (raises UnloweredPolicyError for kinds with no
    columnar encoding).
    """
    return SnapshotBuilder(
        pending_pods, nodes, assigned_pods, services, spec=spec
    ).snapshot()
