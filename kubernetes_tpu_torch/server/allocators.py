"""Service cluster-IP and node-port allocators.

The reference apiserver owns two allocation pools for services: the
portal/cluster-IP range (pkg/registry/service/ipallocator/allocator.go)
and the node-port range (pkg/registry/service/portallocator/
allocator.go), both wired into the service REST storage
(pkg/master/master.go:440-455) and exercised at create/update/delete
(pkg/registry/service/rest.go:68-131).  On restart the reference runs a
repair pass that rebuilds the in-memory bitmaps from the stored
services (pkg/registry/service/ipallocator/controller/repair.go); here
`repair_from` does the same from a store listing.

Both pools are the same shape — a contiguous integer range with a
bitmap of allocations — so they share one implementation.

A copy of `kubernetes_tpu/server/allocators.py`.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Iterable, List


class AllocationError(Exception):
    """Requested value unavailable or the pool is exhausted."""


class _RangeAllocator:
    """Bitmap allocator over [0, size) offsets with a rolling scan
    pointer so sequential allocate_next calls spread across the range
    instead of immediately reusing just-released values (the reference
    randomizes for the same reason, ipallocator/allocator.go:160)."""

    def __init__(self, size: int):
        self._size = size
        self._used = set()
        self._next = 0
        self._lock = threading.Lock()

    def _offset_name(self, offset: int) -> str:
        raise NotImplementedError

    def _allocate_offset(self, offset: int) -> None:
        with self._lock:
            if offset in self._used:
                raise AllocationError(
                    f"{self._offset_name(offset)} is already allocated"
                )
            self._used.add(offset)

    def _allocate_next_offset(self) -> int:
        with self._lock:
            if len(self._used) >= self._size:
                raise AllocationError("range is full")
            for i in range(self._size):
                offset = (self._next + i) % self._size
                if offset not in self._used:
                    self._used.add(offset)
                    self._next = (offset + 1) % self._size
                    return offset
            raise AllocationError("range is full")  # pragma: no cover

    def _release_offset(self, offset: int) -> None:
        with self._lock:
            self._used.discard(offset)

    def _offset_allocated(self, offset: int) -> bool:
        with self._lock:
            return offset in self._used

    @property
    def free(self) -> int:
        with self._lock:
            return self._size - len(self._used)


class IPAllocator(_RangeAllocator):
    """Cluster-IP pool over a CIDR; network and broadcast addresses are
    excluded, matching ipallocator.NewCIDRRange."""

    def __init__(self, cidr: str):
        self.network = ipaddress.ip_network(cidr)
        base = int(self.network.network_address) + 1
        size = self.network.num_addresses - 2
        if size < 1:
            raise ValueError(f"service CIDR {cidr} has no allocatable addresses")
        self._base = base
        super().__init__(size)

    def _offset_name(self, offset: int) -> str:
        return str(ipaddress.ip_address(self._base + offset))

    def _offset_of(self, ip: str) -> int:
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            raise AllocationError(f"{ip!r} is not a valid IP address")
        offset = int(addr) - self._base
        if not (0 <= offset < self._size):
            raise AllocationError(
                f"{ip} is not in the service IP range {self.network}"
            )
        return offset

    def allocate(self, ip: str) -> None:
        self._allocate_offset(self._offset_of(ip))

    def allocate_next(self) -> str:
        return str(ipaddress.ip_address(self._base + self._allocate_next_offset()))

    def release(self, ip: str) -> None:
        try:
            self._release_offset(self._offset_of(ip))
        except AllocationError:
            pass  # out-of-range IPs were never ours to track

    def mark(self, ip: str) -> None:
        """Repair-pass variant of allocate: out-of-range / duplicate
        stored values are tolerated (the reference repair loop logs and
        continues rather than refusing to start)."""
        try:
            self._allocate_offset(self._offset_of(ip))
        except AllocationError:
            pass


class PortAllocator(_RangeAllocator):
    """Node-port pool over an inclusive [lo, hi] port range (reference
    default 30000-32767, portallocator wired at master.go:446)."""

    def __init__(self, lo: int = 30000, hi: int = 32767):
        if not (0 < lo <= hi <= 65535):
            raise ValueError(f"invalid node port range {lo}-{hi}")
        self.lo, self.hi = lo, hi
        super().__init__(hi - lo + 1)

    def _offset_name(self, offset: int) -> str:
        return f"port {self.lo + offset}"

    def allocate(self, port: int) -> None:
        if not (self.lo <= port <= self.hi):
            raise AllocationError(
                f"port {port} is not in the node port range {self.lo}-{self.hi}"
            )
        self._allocate_offset(port - self.lo)

    def is_allocated(self, port: int) -> bool:
        return self.lo <= port <= self.hi and self._offset_allocated(port - self.lo)

    def allocate_next(self) -> int:
        return self.lo + self._allocate_next_offset()

    def release(self, port: int) -> None:
        if self.lo <= port <= self.hi:
            self._release_offset(port - self.lo)

    def mark(self, port: int) -> None:
        try:
            self.allocate(port)
        except AllocationError:
            pass


def service_ips_in_use(services: Iterable[dict]) -> List[str]:
    """Cluster IPs recorded in stored service objects (headless 'None'
    and unset excluded)."""
    out = []
    for svc in services:
        ip = (svc.get("spec") or {}).get("clusterIP") or ""
        if ip and ip != "None":
            out.append(ip)
    return out


def service_node_ports_in_use(services: Iterable[dict]) -> List[int]:
    out = []
    for svc in services:
        for port in (svc.get("spec") or {}).get("ports") or []:
            np = port.get("nodePort") or 0
            if np:
                out.append(np)
    return out
