"""A daemon's own health and debug listener.

The port's copy of `HealthServer`, `_loop_alive_check` and
`_start_health` of `kubernetes_tpu/cmd/daemons.py` (reference: every
daemon mounts healthz and prometheus handlers on its own port, the
scheduler's on 10251, plugin/cmd/kube-scheduler/app/server.go:105-109):

- `GET /healthz`: 200 `ok` when every check passes, else 500 with the
  problems joined by "; ". A check is a callable returning (ok, msg).
- `GET /metrics`: the port's registry (`utils.metrics.DEFAULT`) in the
  Prometheus text format.
- `GET /debug/<view>`: the scheduler's debug views, with the query
  parameters, status codes and bodies of the JAX apiserver's handlers
  (`kubernetes_tpu/server/httpserver.py` `_serve_debug`). The JAX
  package serves them from the process that holds the rings; the
  port's rings live in its scheduler's process, so they are mounted
  here. `traces?pod=&limit=`, `decisions?pod=&limit=`, `solves?limit=`,
  `slo`, `capacity`, `rebalance`, `kernels` (`ops.ledger.DEFAULT`, read
  from `sys.modules`, so a process that never launched a kernel reports
  none), `device-profile?seconds=` (409 while a capture runs, 503 when
  the profiler is unavailable), `stacks` and `profile?seconds=&format=`.
  A bad number is a 400 and an unknown view a 404 listing these, each a
  `Status` body. The apiserver's own views (`requests`, `alerts`,
  `timeseries`, `health`) stay with the apiserver.

The JAX package's `ktctl explain` and `ktctl trace`, given a client on
this listener's address, read `/debug/decisions` and `/debug/traces`
here as they read them from the JAX apiserver.
"""

from __future__ import annotations

import http.server
import json
import sys
import threading
from typing import Callable, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

from kubernetes_tpu_torch.client.rest import APIError

#: The debug views this listener serves.
DEBUG_VIEWS = ("traces", "decisions", "solves", "slo", "capacity", "rebalance", "kernels",
               "device-profile", "stacks", "profile")

Check = Callable[[], Tuple[bool, str]]


def _number(query: dict, key: str, default: str, cast=float):
    try:
        return cast(query.get(key, default))
    except ValueError:
        raise APIError(400, "BadRequest", f"{key} must be numeric")


def serve_debug(view: str, query: dict) -> Tuple[str, str]:
    """(body, content type) of one debug view; raises APIError, which
    the server answers with a `Status` body."""
    from kubernetes_tpu_torch.utils import debug, flightrecorder, tracing

    if view == "traces":
        return tracing.render_json(pod=query.get("pod", ""),
                                   limit=_number(query, "limit", "64", int)), "application/json"
    if view == "decisions":
        return (flightrecorder.render_decisions_json(
            pod=query.get("pod", ""), limit=_number(query, "limit", "64", int)),
            "application/json")
    if view == "solves":
        return (flightrecorder.render_solves_json(limit=_number(query, "limit", "64", int)),
                "application/json")
    if view == "slo":
        from kubernetes_tpu_torch.utils import slo

        return json.dumps(slo.evaluate()), "application/json"
    if view == "capacity":
        from kubernetes_tpu_torch.utils import capacity

        return json.dumps(capacity.DEFAULT.snapshot()), "application/json"
    if view == "rebalance":
        from kubernetes_tpu_torch.utils import rebalance

        return json.dumps(rebalance.DEFAULT.snapshot()), "application/json"
    if view == "kernels":
        led = sys.modules.get("kubernetes_tpu_torch.ops.ledger")
        payload = (led.DEFAULT.to_dict() if led is not None
                   else {"kernels": [], "summary": {"compiles": 0}})
        return json.dumps(payload), "application/json"
    if view == "device-profile":
        from kubernetes_tpu_torch.utils import profiler

        seconds = _number(query, "seconds", "2")
        try:
            info = profiler.capture_device_trace(seconds=seconds)
        except profiler.TraceInProgress as e:
            raise APIError(409, "Conflict", str(e))
        except profiler.ProfilerUnavailable as e:
            raise APIError(503, "ServiceUnavailable", str(e))
        return json.dumps(info), "application/json"
    if view == "stacks":
        return debug.dump_stacks(), "text/plain; charset=utf-8"
    if view == "profile":
        seconds = _number(query, "seconds", "2")
        fmt = query.get("format", "top")
        if fmt not in ("top", "collapsed"):
            raise APIError(400, "BadRequest", "format must be top or collapsed")
        return debug.sample_profile(seconds=seconds, fmt=fmt), "text/plain; charset=utf-8"
    raise APIError(404, "NotFound",
                   "debug endpoints: " + " ".join(f"/debug/{v}" for v in DEBUG_VIEWS))


class HealthServer:
    """The /healthz, /metrics and /debug listener of one daemon.
    `checks` are callables returning (ok, msg); /healthz is 200 only
    when all pass (a raising check fails with its exception)."""

    def __init__(self, port: int, checks: Optional[Sequence[Check]] = None,
                 host: str = "127.0.0.1"):
        from kubernetes_tpu_torch.utils import metrics

        checks = list(checks or [])

        class Handler(http.server.BaseHTTPRequestHandler):
            disable_nagle_algorithm = True

            def log_message(self, fmt, *a):  # noqa: N802
                pass

            def _send(self, code, payload, ctype="text/plain"):
                data = payload.encode() if isinstance(payload, str) else payload
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                parsed = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                parts = [s for s in parsed.path.split("/") if s]
                if parts == ["healthz"]:
                    problems = []
                    for check in checks:
                        try:
                            ok, msg = check()
                        except Exception as e:
                            ok, msg = False, f"{type(e).__name__}: {e}"
                        if not ok:
                            problems.append(msg)
                    if problems:
                        self._send(500, "; ".join(problems))
                    else:
                        self._send(200, "ok")
                elif parts == ["metrics"]:
                    self._send(200, metrics.DEFAULT.render(), "text/plain; version=0.0.4")
                elif parts and parts[0] == "debug":
                    try:
                        body, ctype = serve_debug("/".join(parts[1:]), query)
                    except APIError as e:
                        status = {"kind": "Status", "apiVersion": "v1", "status": "Failure",
                                  "reason": e.reason, "message": e.message, "code": e.code}
                        self._send(e.code, json.dumps(status), "application/json")
                        return
                    self._send(200, body, ctype)
                else:
                    self._send(404, "not found")

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1}, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "HealthServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _loop_alive_check(daemon) -> Check:
    """Healthy while the daemon's loop thread is alive (a daemon with no
    loop thread, as the leader-election wrapper, reports ok)."""

    def check():
        t = getattr(daemon, "_thread", None)
        if t is None:
            return True, "ok"
        return t.is_alive(), "ok" if t.is_alive() else "loop not running"

    return check


def _start_health(args, checks: List[Check]) -> Optional[HealthServer]:
    """Bind the daemon's healthz port when enabled (negative disables).
    A port that is taken prints a warning and the daemon runs on: a
    daemon must not die because its health port is taken."""
    port = getattr(args, "healthz_port", -1)
    if port is None or port < 0:
        return None
    try:
        srv = HealthServer(port, checks).start()
    except OSError as e:
        print(f"warning: healthz port {port} unavailable: {e}", file=sys.stderr)
        return None
    print(f"healthz serving on 127.0.0.1:{srv.port}", flush=True)
    return srv
