"""Solver sidecar: the device solver as a process of its own.

The counterpart of `kubernetes_tpu/ops/sidecar.py`, speaking the same
wire, byte for byte. The project's architecture keeps the control plane
and the accelerator in separate processes: the control plane lowers API
objects host-side and ships only arrays over a unix socket to a process
that owns the card; a sidecar crash degrades to the scalar path instead
of taking the scheduler down. With this server, the JAX package's
control plane (`scheduler --batch --solver-sidecar <socket>`, its
`SidecarSolver` and `BatchScheduler`) schedules on the CUDA card, and
this package's `SidecarSolver` can drive the JAX package's server.

Wire format (one frame per message, either direction):

    b"KTPU" | u16 version | u64 total_len | u32 header_len |
    header JSON | array bytes

The JSON header carries the structured message with ndarrays replaced
by {"__nd__": i} placeholders into an arrays table of {dtype, shape};
the raw buffers follow concatenated in table order. Tuples and the
solver's LoweredSpec round-trip via tagged objects. Version skew fails
with a clean SidecarError, and no pickle means a frame can name no code
to run.

Server: `python -m kubernetes_tpu_torch.ops.sidecar <socket> [--device cpu]`
serves on the CUDA card by default and exits non-zero at start without
one. Mode "wave" solves through `ops.wave.wave_assignments` and
"sinkhorn" through `ops.sinkhorn.sinkhorn_assignments` (default policy,
a policy spec in the request ignored, as the JAX server does); any
other mode through `ops.solver.solve_assignments`, the default spec on
the scan kernel and a policy spec on the policy scan kernel. A bad
frame or a failed solve (a structured `{"error": ...}` reply) never
ends the serving loop. Each request is recorded as one trace of the
server's spans (`utils/tracing.py` DEFAULT_BUFFER); `serve(...,
stop=event)` runs the loop on a thread until the event is set.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from kubernetes_tpu_torch.models.algspec import LoweredSpec
from kubernetes_tpu_torch.models.columnar import (
    NodeColumns,
    PodColumns,
    Snapshot,
    Vocab,
    build_snapshot,
)
from kubernetes_tpu_torch.utils.tracing import phase, span, trace


class SidecarError(Exception):
    pass


# -- framing ----------------------------------------------------------

_MAGIC = b"KTPU"
_VERSION = 2  # v1 was pickle; bumped with any schema change


def _encode(obj):
    """-> (header_bytes, [contiguous ndarrays])."""
    arrays: List[np.ndarray] = []

    def walk(x):
        if isinstance(x, np.ndarray):
            arrays.append(np.ascontiguousarray(x))
            return {"__nd__": len(arrays) - 1}
        if isinstance(x, LoweredSpec):
            return {"__lowered__": walk(dict(x._asdict()))}
        if isinstance(x, tuple):
            return {"__tuple__": [walk(v) for v in x]}
        if isinstance(x, dict):
            return {str(k): walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, np.integer):
            return int(x)
        if isinstance(x, np.floating):
            return float(x)
        if isinstance(x, np.bool_):
            return bool(x)
        if x is None or isinstance(x, (str, int, float, bool)):
            return x
        raise SidecarError(f"unencodable field type {type(x).__name__}")

    meta = walk(obj)
    header = json.dumps(
        {
            "meta": meta,
            "arrays": [
                {"dtype": a.dtype.str, "shape": list(a.shape)} for a in arrays
            ],
        },
        separators=(",", ":"),
    ).encode()
    return header, arrays


def _decode(header: bytes, body: bytearray):
    """Every malformed-frame failure surfaces as SidecarError — the
    'any transport/sidecar error raises SidecarError' contract the
    daemon's error count and ping() rely on (a raw TypeError from a
    corrupt dtype string would otherwise crash the readiness loop)."""
    try:
        doc = json.loads(header)
        specs = doc["arrays"]
        views = []
        mv = memoryview(body)  # slices of a memoryview are zero-copy
        off = 0
        for s in specs:
            dt = np.dtype(s["dtype"])
            n = int(np.prod(s["shape"])) * dt.itemsize
            if n < 0 or off + n > len(body):
                raise SidecarError("frame body shorter than its array table")
            views.append(
                np.frombuffer(mv[off:off + n], dtype=dt).reshape(s["shape"])
            )
            off += n

        def walk(x):
            if isinstance(x, dict):
                if "__nd__" in x and len(x) == 1:
                    return views[x["__nd__"]]
                if "__tuple__" in x and len(x) == 1:
                    return tuple(walk(v) for v in x["__tuple__"])
                if "__lowered__" in x and len(x) == 1:
                    return LoweredSpec(**walk(x["__lowered__"]))
                return {k: walk(v) for k, v in x.items()}
            if isinstance(x, list):
                return [walk(v) for v in x]
            return x

        return walk(doc["meta"])
    except SidecarError:
        raise
    except Exception as e:
        raise SidecarError(f"malformed frame: {type(e).__name__}: {e}")


def _send_msg(sock: socket.socket, obj) -> None:
    header, arrays = _encode(obj)
    total = len(header) + sum(a.nbytes for a in arrays)
    sock.sendall(
        _MAGIC + struct.pack(">HQI", _VERSION, total, len(header)) + header
    )
    for a in arrays:
        sock.sendall(a.data if a.nbytes else b"")


def _recv_msg(sock: socket.socket):
    head = _recv_exact(sock, 4 + 2 + 8 + 4)
    if head[:4] != _MAGIC:
        raise SidecarError("not a KTPU frame (magic mismatch)")
    version, total, header_len = struct.unpack(">HQI", head[4:])
    if version != _VERSION:
        raise SidecarError(
            f"sidecar protocol version skew: peer speaks v{version}, "
            f"this build speaks v{_VERSION} — restart the older side"
        )
    if total > 1 << 31 or header_len > total:
        raise SidecarError(f"oversized frame ({total} bytes)")
    header = _recv_exact(sock, header_len)
    body = _recv_exact(sock, total - header_len)
    return _decode(header, body)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """n bytes from the socket, in a writable buffer: the arrays decoded
    from it are writable views, which the solver may update in place."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise SidecarError("sidecar connection closed mid-frame")
        buf.extend(chunk)
    return buf


def _snapshot_payload(snap: Snapshot) -> dict:
    p, n = snap.pods, snap.nodes
    return {
        "pods": {
            "cpu_milli": p.cpu_milli,
            "mem_mib": p.mem_mib,
            "zero_req": p.zero_req,
            "selector_id": p.selector_id,
            "port_bits": p.port_bits,
            "vol_any_bits": p.vol_any_bits,
            "vol_rw_bits": p.vol_rw_bits,
            "pinned_node": p.pinned_node,
            "service_id": p.service_id,
            "svc_topk": p.svc_topk,
            "sel_bits": p.sel_bits,
            "aff_pin": p.aff_pin,
        },
        "nodes": {
            "cpu_cap": n.cpu_cap,
            "mem_cap": n.mem_cap,
            "pods_cap": n.pods_cap,
            "cpu_fit_used": n.cpu_fit_used,
            "mem_fit_used": n.mem_fit_used,
            "overcommitted": n.overcommitted,
            "cpu_used": n.cpu_used,
            "mem_used": n.mem_used,
            "pods_used": n.pods_used,
            "label_bits": n.label_bits,
            "used_port_bits": n.used_port_bits,
            "used_vol_any_bits": n.used_vol_any_bits,
            "used_vol_rw_bits": n.used_vol_rw_bits,
            "service_counts": n.service_counts,
            "schedulable": n.schedulable,
            "policy_ok": n.policy_ok,
            "static_prio": n.static_prio,
            "aff_vid": n.aff_vid,
            "aa_zone": n.aa_zone,
        },
        # Policy lowering (None/default for the stock pipeline).
        "lowered": snap.lowered,
        "weights": snap.weights,
        "anchor_init": snap.anchor_init,
        "svc_total_init": snap.svc_total_init,
    }


def _snapshot_from_payload(payload: dict) -> Snapshot:
    p = payload["pods"]
    n = payload["nodes"]
    P = len(p["cpu_milli"])
    N = len(n["cpu_cap"])
    pods = PodColumns(names=[str(i) for i in range(P)], **p)
    nodes = NodeColumns(names=[str(j) for j in range(N)], **n)
    return Snapshot(
        pods=pods,
        nodes=nodes,
        label_vocab=Vocab(),
        port_vocab=Vocab(),
        vol_vocab=Vocab(),
        service_names=[],
        lowered=payload.get("lowered"),
        weights=payload.get("weights"),
        anchor_init=payload.get("anchor_init"),
        svc_total_init=payload.get("svc_total_init"),
    )


# -- client -----------------------------------------------------------


class SidecarSolver:
    """Client half: lowers API objects host-side, ships arrays to the
    sidecar, returns node names. Raises SidecarError on ANY failure: the
    port's daemon counts it as a device error and stops (it has no
    scalar fallback).

    Trust model: the schema'd protocol carries only JSON + raw
    arrays (no code), but the socket remains same-user-only as defense
    in depth: the server chmods it 0600 and the client refuses sockets
    owned by another uid; point --solver-sidecar only at paths this
    user controls.

    The default timeout is deliberately short: a HUNG (not crashed)
    sidecar would otherwise stall the daemon for a long time before
    the error reaches it."""

    def __init__(self, sock_path: str, timeout: float = 15.0):
        self.sock_path = sock_path
        self.timeout = timeout
        #: The kernel launches the last solve reported (this package's
        #: server reports them; the JAX package's does not: None).
        self.last_kernel_launches: Optional[dict] = None

    def _request(self, obj, timeout: float) -> dict:
        try:
            st = os.stat(self.sock_path)
            if st.st_uid != os.geteuid():
                raise SidecarError(
                    f"sidecar socket {self.sock_path!r} owned by uid "
                    f"{st.st_uid}, not us — refusing (same-user boundary)"
                )
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(timeout)
            sock.connect(self.sock_path)
            try:
                _send_msg(sock, obj)
                return _recv_msg(sock)
            finally:
                sock.close()
        except (OSError, EOFError) as e:
            raise SidecarError(f"sidecar transport failure: {e}")

    def solve(
        self,
        pending,
        nodes,
        assigned: Sequence = (),
        services: Sequence = (),
        mode: str = "scan",
        spec=None,
    ) -> List[Optional[str]]:
        # Policy lowering happens client-side (UnloweredPolicyError
        # surfaces here, pre-transport); the sidecar receives finished
        # columns + the static LoweredSpec and just solves.
        snap = build_snapshot(pending, nodes, assigned, services, spec=spec)
        reply = self._request(
            {"op": "solve", "mode": mode, **_snapshot_payload(snap)},
            self.timeout,
        )
        if reply.get("error"):
            raise SidecarError(f"sidecar solve failed: {reply['error']}")
        self.last_kernel_launches = reply.get("kernel_launches")
        assignment = reply["assignment"]
        names = snap.nodes.names
        return [
            names[i] if 0 <= i < len(names) else None for i in assignment
        ]

    def ping(self) -> bool:
        try:
            return self._request({"op": "ping"}, 5.0).get("ok", False)
        except SidecarError:
            return False


def spawn_sidecar(
    sock_path: Optional[str] = None, wait: float = 60.0, env=None, device: Optional[str] = None
) -> tuple:
    """Launch the port's sidecar subprocess (`python -m
    kubernetes_tpu_torch.ops.sidecar`, on `device`, default the CUDA
    card); returns (Popen, sock_path)."""
    if sock_path is None:
        sock_path = os.path.join(
            tempfile.mkdtemp(prefix="ktpu-sidecar-"), "solver.sock"
        )
    cmd = [sys.executable, "-m", "kubernetes_tpu_torch.ops.sidecar", sock_path]
    if device is not None:
        cmd += ["--device", str(device)]
    proc = subprocess.Popen(
        cmd,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        env=env,
    )
    client = SidecarSolver(sock_path)
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise SidecarError(
                f"sidecar exited rc={proc.returncode} before serving"
            )
        if os.path.exists(sock_path) and client.ping():
            return proc, sock_path
        time.sleep(0.1)
    proc.terminate()
    proc.wait(timeout=10)
    raise SidecarError("sidecar never became ready")


# -- server -----------------------------------------------------------


def _solve_request(req: dict, device) -> dict:
    """One solve request -> its reply: the assignment, and the kernel
    launches the solve made (a key the JAX package's client ignores; the
    windowed modes launch none). Any failure of the solve is a
    structured error."""
    from kubernetes_tpu_torch.ops import policy_scan, scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_snapshot
    from kubernetes_tpu_torch.ops.sinkhorn import sinkhorn_assignments
    from kubernetes_tpu_torch.ops.solver import solve_assignments
    from kubernetes_tpu_torch.ops.wave import wave_assignments

    counters = {
        "scan_kernel": scan_kernel.scan_with_state,
        "policy_scan_kernel": policy_scan.policy_scan_with_state,
    }
    try:
        mode = req.get("mode", "scan")
        with span("decode"):
            snap = _snapshot_from_payload(req)
        before = {name: fn.launches for name, fn in counters.items()}
        with phase("upload"):
            dsnap = device_snapshot(snap, device)
        if mode == "wave":
            assignment, _ = wave_assignments(dsnap)
        elif mode == "sinkhorn":
            assignment, _ = sinkhorn_assignments(dsnap)
        else:
            # solve_assignments reads the choices back: the device time.
            with phase("solve", mode="scan"):
                assignment = solve_assignments(dsnap)
        return {
            "assignment": assignment.tolist(),
            "kernel_launches": {name: fn.launches - before[name] for name, fn in counters.items()},
        }
    except Exception as e:  # solve failure -> structured error
        return {"error": f"{type(e).__name__}: {e}"}


def serve(sock_path: str, device=None, stop: Optional[threading.Event] = None) -> None:
    """Sidecar main loop: owns the device (default: the CUDA card; raises
    without one) and solves snapshots, one connection at a time, until
    `stop` is set (None: forever).

    Each request is one trace in `utils.tracing.DEFAULT_BUFFER`: spans
    `recv` (the frame in), `decode`, phases `upload` and `solve`, and
    `send` (the reply out).

    Per-connection containment: a garbage frame, a client that hangs up
    mid-reply, or a failed solve never ends this loop; a dead sidecar
    would stop every daemon that solves through it."""
    from kubernetes_tpu_torch import resolve_device

    device = resolve_device(device)
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    server.bind(sock_path)
    os.chmod(sock_path, 0o600)  # same-user boundary
    server.listen(4)
    if stop is not None:
        server.settimeout(0.2)  # wake to look at `stop`
    try:
        while stop is None or not stop.is_set():
            try:
                conn, _ = server.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            try:
                with trace("sidecar_request"):
                    with span("recv"):
                        req = _recv_msg(conn)
                    if not isinstance(req, dict):
                        reply = {"error": "request must be a dict"}
                    elif req.get("op") == "ping":
                        reply = {"ok": True}
                    else:
                        reply = _solve_request(req, device)
                    with span("send"):
                        _send_msg(conn, reply)
            except Exception:
                pass  # bad frame / client hung up mid-reply; next client
            finally:
                conn.close()
    finally:
        server.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.ops.sidecar",
        description="Serve the CUDA solver on a unix socket.",
    )
    parser.add_argument("socket", help="path of the unix socket to serve on")
    parser.add_argument(
        "--device", default=None,
        help="torch device to solve on (default: the CUDA card; 'cpu' runs the plain solver)",
    )
    args = parser.parse_args(argv)
    from kubernetes_tpu_torch import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"sidecar: {e}", file=sys.stderr)
        return 1
    serve(args.socket, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
