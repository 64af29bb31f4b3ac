"""HTTP transport for the API server.

Reference: route installation in pkg/apiserver/api_installer.go:268-284
and the chunked-JSON watch server (pkg/apiserver/watch.go:45-102).

Routes (all under /api/v1):
    GET|POST   /{resource}                          cluster-scoped or all-ns
    GET|PUT|DELETE /{resource}/{name}               cluster-scoped
    GET|POST   /namespaces/{ns}/{resource}
    GET|PUT|DELETE /namespaces/{ns}/{resource}/{name}
    PUT        /namespaces/{ns}/{resource}/{name}/status
    POST       /namespaces/{ns}/bindings
    POST       /namespaces/{ns}/pods/{name}/binding
    GET        /watch/{resource}            (+ /watch/namespaces/{ns}/{resource})
Plus /healthz, /metrics, /version, /api.

Watch responses are chunked newline-delimited JSON frames
{"type": ..., "object": ...} — same wire shape as the reference.

A copy of `kubernetes_tpu/server/httpserver.py`, the replication plane
included (`/replication/append` and `/replication/status`, a follower's
write forward to its leader, the replication subcheck of `/healthz` and
component of `/debug/health`). It differs in two places: the `/debug/*`
views other than `health` are rendered by `utils.debug.render_view`,
which the daemons' health servers share; `/version` reports platform
`gpu`.
Nothing here touches the card: `/debug/device-profile` answers as the
scheduler's health server does (503 when the profiler is unavailable).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from kubernetes_tpu_torch import __version__
from kubernetes_tpu_torch.models import conversion
from kubernetes_tpu_torch.server.api import APIError, APIServer
from kubernetes_tpu_torch.server.registry import RESOURCES
from kubernetes_tpu_torch.utils import metrics, sli, tracing

_REQS = metrics.DEFAULT.counter(
    "apiserver_request_count", "API requests by verb/resource/code",
    ("verb", "resource", "code"),
)
# Histogram (not summary): bucketed latencies aggregate across
# scrapes/instances and the SLO gate reads interpolated quantiles off
# the same series (the reference moved the scheduler/apiserver SLO
# metrics the same way).
_LATENCY = metrics.DEFAULT.histogram(
    "apiserver_request_latencies_seconds", "API request latency",
    ("verb", "resource"),
)
_INFLIGHT_REJECTS = metrics.DEFAULT.counter(
    "apiserver_dropped_requests_total",
    "Requests rejected by the max-in-flight limit",
)


def _first_container_port(pod: dict, name: str) -> int:
    """The pod's first declared container port — the default target for
    the proxy and redirect verbs when the client gives no ':port'."""
    for c in pod.get("spec", {}).get("containers", []):
        for p in c.get("ports", []):
            if p.get("containerPort", 0):
                return p["containerPort"]
    raise APIError(
        400, "BadRequest",
        f"pod {name!r} declares no container port; use {name}:<port>",
    )


#: Subresource suffixes whose requests are long-running by design —
#: exempt from the latency SLO exactly like the reference's ignored
#: verbs/resources (test/e2e/util.go:1286-1301 skips WATCHLIST/PROXY).
_LONG_RUNNING = ("watch", "proxy", "portforward", "exec", "run", "log")


def _request_is_long_running(parts, query) -> bool:
    """Max-in-flight passthrough test (pkg/apiserver/handlers.go
    MaxInFlightLimit: requests matching the long-running regex bypass
    the limit — a hung watch or kubelet relay must not eat a slot
    forever). Like the reference's regex, 'proxy' etc. match ANYWHERE
    in the path: proxy requests carry subpaths after the verb."""
    if query.get("watch") in ("true", "1"):
        return True
    if any(p in ("watch", "proxy", "portforward", "exec", "run") for p in parts):
        return True
    return (
        bool(parts)
        and parts[-1] == "log"
        and query.get("follow") in ("true", "1")
    )


def reset_request_latency() -> None:
    """Start a fresh measurement window on the process-global request
    latency summary. The reference's e2e SLO gate scrapes a freshly
    started cluster's apiserver (test/e2e/util.go:1286); in-process
    suites share ONE registry across many clusters, so a test gating
    on p99 must open its own window or it inherits every earlier
    test's observations."""
    _LATENCY.reset()


def high_latency_requests(threshold: float = 1.0, summary=None):
    """The HighLatencyRequests SLO gate (reference: test/e2e/
    util.go:1286 scrapes apiserver request-latency summaries and fails
    e2e when p99 exceeds the roadmap's 1 s bar, docs/roadmap.md:69).
    Returns [(verb, resource, p99_seconds)] violations. `summary`
    defaults to the live apiserver latency series; tests pass their
    own so suites sharing the process-global registry can't pollute
    each other's gates."""
    summary = summary if summary is not None else _LATENCY
    keys = summary.label_values()
    out = []
    for verb, resource in keys:
        if resource.rsplit("/", 1)[-1] in _LONG_RUNNING:
            continue
        p99 = summary.quantile(0.99, verb=verb, resource=resource)
        if p99 == p99 and p99 > threshold:  # NaN-safe
            out.append((verb, resource, p99))
    return sorted(out)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "kubernetes-tpu-apiserver"
    # Nagle + delayed-ACK interact catastrophically with keep-alive
    # request/response traffic (~40ms stalls per request on loopback);
    # the reference's Go net/http also runs with TCP_NODELAY.
    disable_nagle_algorithm = True
    api: APIServer  # set by serve()
    # Inbound protection (pkg/apiserver/handlers.go MaxInFlightLimit,
    # wired at pkg/master/master.go): a BoundedSemaphore shared by all
    # handler threads, or None for unlimited. Long-running requests
    # (watch/exec/proxy/...) bypass it.
    inflight = None

    # Silence default stderr logging; metrics carry the signal.
    def log_message(self, fmt, *args):  # noqa: N802
        pass

    # -- plumbing -----------------------------------------------------

    def _send_json(self, code: int, obj: dict) -> None:
        version = getattr(self, "wire_version", "v1")
        if version != "v1":
            obj = conversion.from_internal(obj, version)
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(
        self, code: int, body, content_type: str = "text/plain"
    ) -> None:
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _read_body(self, kind_hint: str = "") -> dict:
        """Parse (and version-convert) the request body. `kind_hint` is
        the kind implied by the route: the API accepts kind-less bodies
        (api.create setdefaults kind from the path), but conversion
        dispatches ON kind — a kind-less v1beta3 body would silently
        skip conversion and store legacy field names internally."""
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length == 0:
            return {}
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise APIError(400, "BadRequest", f"invalid JSON body: {e}")
        version = getattr(self, "wire_version", "v1")
        if version != "v1" and isinstance(body, dict):
            if kind_hint and not body.get("kind"):
                body["kind"] = kind_hint
            body = conversion.to_internal(body, version)
        return body

    def _kind_of(self, resource: str) -> str:
        info = RESOURCES.get(resource)
        return info.kind if info is not None else ""

    def _serve_ui(self) -> None:
        """Live dashboard (reference: pkg/ui serves the www/ AngularJS
        app at /ui/; ours is an original self-contained SPA that polls
        the REST API — hash-routed per-resource views, auto-refresh)."""
        self._send_text(200, _UI_PAGE, "text/html; charset=utf-8")

    #: The apiserver's debug views, in the order its 404 lists them.
    DEBUG_VIEWS = (
        "requests", "stacks", "profile", "traces", "decisions", "solves",
        "slo", "kernels", "capacity", "rebalance", "device-profile",
        "alerts", "timeseries", "health",
    )

    def _serve_debug(self, rest: Tuple[str, ...]) -> None:
        """GET /debug/<view>: `/debug/health` here (it reads this
        apiserver), every other view through the renderer the daemons'
        health servers share (`utils.debug.render_view`)."""
        from kubernetes_tpu_torch.utils import debug

        if rest == ("health",):
            self._serve_debug_health()
            return
        try:
            body, ctype = debug.render_view(
                "/".join(rest), self.query, self.DEBUG_VIEWS
            )
        except debug.ViewError as e:
            raise APIError(e.code, e.reason, e.message)
        self._send_text(200, body, ctype)

    def _health_checks(self) -> dict:
        """The /healthz subcheck dict (kvstore, watch hub, replication,
        flight recorder) — also the component half of the /debug/health
        rollup, so the probe and the rollup can never disagree about a
        dependency's state."""
        from kubernetes_tpu_torch.utils import flightrecorder

        checks = {}
        try:
            store = self.api.store
            if store.closed:
                checks["kvstore"] = {
                    "status": "unhealthy", "message": "store closed",
                }
            else:
                checks["kvstore"] = {
                    "status": "ok", "resourceVersion": store.version,
                }
        except Exception as e:
            checks["kvstore"] = {"status": "unhealthy", "message": str(e)}
        try:
            alive = self.api.store.dispatcher_alive()
            checks["watchHub"] = (
                {"status": "ok"}
                if alive
                else {
                    "status": "unhealthy",
                    "message": "watch dispatcher thread dead",
                }
            )
        except Exception as e:
            checks["watchHub"] = {"status": "unhealthy", "message": str(e)}
        rep = getattr(self.api, "replication", None)
        if rep is not None:
            # HA subcheck: role + commit index + per-follower lag
            # (leader side) or journaled/commit watermarks (follower).
            # A dead follower link flips the check unhealthy — the
            # load balancer should stop preferring this replica's
            # writes before quorum stalls, not after.
            try:
                st = rep.status()
                followers = st.get("followers", [])
                dead = [
                    f["name"] for f in followers if not f.get("alive", True)
                ]
                check = {
                    "status": "unhealthy" if dead else "ok",
                    "role": st.get("role", ""),
                    "commitIndex": st.get("commitIndex", 0),
                    "followerLag": {
                        f["name"]: f.get("lagVersions", 0)
                        for f in followers
                    },
                }
                if dead:
                    check["message"] = (
                        "unreachable followers: " + ", ".join(dead)
                    )
                checks["replication"] = check
            except Exception as e:
                checks["replication"] = {
                    "status": "unhealthy", "message": str(e),
                }
        try:
            size, cap = flightrecorder.DEFAULT.ring_stats()
            checks["flightRecorder"] = (
                {"status": "ok", "decisions": size, "capacity": cap}
                if size <= cap
                else {
                    "status": "unhealthy",
                    "message": f"ring overflow: {size} > {cap}",
                }
            )
        except Exception as e:
            checks["flightRecorder"] = {
                "status": "unhealthy", "message": str(e),
            }
        return checks

    def _serve_healthz(self) -> None:
        """/healthz with JSON subchecks (kvstore, watch hub, flight
        recorder), 200 only when every check passes — the reference's
        bare "ok" told an operator nothing about WHICH dependency was
        sick. Stays ahead of the auth chain like the plain probe did
        (load balancers and kubelets probe unauthenticated)."""
        checks = self._health_checks()
        healthy = all(c.get("status") == "ok" for c in checks.values())
        self._send_json(
            200 if healthy else 503,
            {
                "kind": "Health",
                "status": "ok" if healthy else "unhealthy",
                "checks": checks,
            },
        )

    #: A follower trailing the leader's commit index by more than this
    #: many versions verdicts the replication component "warn" before
    #: the link actually dies (mirrors the alert rule's threshold).
    _REPLICATION_LAG_WARN = 1024
    #: A lease record whose renew timestamp is older than this reads
    #: stale — holders renew every ~1s against 5s windows, so 30s of
    #: silence means the tier is leaderless or wedged.
    _LEASE_STALE_S = 30.0

    def _serve_debug_health(self) -> None:
        """GET /debug/health: the HA-aware rollup. Joins the /healthz
        subchecks, /replication/status (role, commit index, follower
        lag), the lease records in kube-system, the SLO report, and
        the alert engine into per-component pass/warn/burn verdicts
        plus one overall worst — the `ktctl top health` data source.
        `sampled` keys the miss contract: an unmeasured cluster (no
        SLI samples AND no alert evaluations) exits the CLI 1."""
        from kubernetes_tpu_torch.utils import alerts, slo

        checks = self._health_checks()
        components = {}
        for name, c in checks.items():
            comp = dict(c)
            comp["verdict"] = "pass" if c.get("status") == "ok" else "burn"
            components[name] = comp
        rep = components.get("replication")
        if rep is not None and rep["verdict"] == "pass":
            # Alive links can still be falling behind: sustained lag is
            # the pre-quorum-loss signal (warn, not burn — the link is
            # up and catching up is still possible).
            lag = max(rep.get("followerLag", {}).values(), default=0)
            if lag > self._REPLICATION_LAG_WARN:
                rep["verdict"] = "warn"
                rep["message"] = f"follower lag {lag} versions"
        # Lease tier: every lease record in kube-system (scheduler
        # standby, kvstore tiers) with holder/token/age. A stale or
        # holderless lease is warn — the tier is between leaders, which
        # the warm standby exists to make brief.
        try:
            from kubernetes_tpu_torch.utils.lease import (
                HOLDER_KEY,
                RENEW_KEY,
                TOKEN_KEY,
            )

            items = self.api.list("endpoints", namespace="kube-system")[
                "items"
            ]
            leases = []
            verdict = "pass"
            now = time.time()
            for obj in items:
                ann = (obj.get("metadata", {}) or {}).get(
                    "annotations", {}
                ) or {}
                if HOLDER_KEY not in ann:
                    continue
                try:
                    renewed = float(ann.get(RENEW_KEY, "0") or "0")
                except ValueError:
                    renewed = 0.0
                age = max(0.0, now - renewed) if renewed else None
                stale = age is None or age > self._LEASE_STALE_S
                holder = ann.get(HOLDER_KEY, "")
                leases.append(
                    {
                        "name": obj.get("metadata", {}).get("name", ""),
                        "holder": holder,
                        "token": ann.get(TOKEN_KEY, ""),
                        "ageS": None if age is None else round(age, 1),
                        "stale": stale,
                    }
                )
                if stale or not holder:
                    verdict = "warn"
            if leases:
                components["leases"] = {
                    "status": "ok" if verdict == "pass" else "stale",
                    "verdict": verdict,
                    "leases": leases,
                }
        except Exception as e:
            components["leases"] = {
                "status": "unhealthy", "verdict": "warn", "message": str(e),
            }
        slo_report = slo.evaluate()
        components["slo"] = {
            "status": slo_report["verdict"],
            "verdict": (
                slo_report["verdict"]
                if slo_report["verdict"] != "no_data"
                else "pass"
            ),
            "sampled": slo_report["sampled"],
            "objectivesBurning": [
                e["name"]
                for e in slo_report["objectives"]
                if e["verdict"] in ("warn", "burn")
            ],
        }
        alert_snap = alerts.DEFAULT.snapshot()
        firing = alert_snap["firing"]
        sev = {
            r["name"]: r["severity"] for r in alert_snap["rules"]
        }
        if not alert_snap["sampled"]:
            alert_verdict = "pass"  # unmeasured: surfaced via `sampled`
        elif any(sev.get(n) == "page" for n in firing):
            alert_verdict = "burn"
        elif firing:
            alert_verdict = "warn"
        else:
            alert_verdict = "pass"
        components["alerts"] = {
            "status": "firing" if firing else "ok",
            "verdict": alert_verdict,
            "sampled": alert_snap["sampled"],
            "firing": firing,
            "evaluations": alert_snap["evaluations"],
        }
        overall = slo.worst(
            *[c["verdict"] for c in components.values()]
        )
        self._send_json(
            200,
            {
                "kind": "HealthRollup",
                "verdict": overall,
                "sampled": bool(
                    slo_report["sampled"] or alert_snap["sampled"]
                ),
                "components": components,
            },
        )

    def _serve_replication(self, verb: str, rest: Tuple[str, ...]) -> None:
        """The WAL-shipping ingest plane (store/replication.py).

        POST /replication/append — leader hub -> this follower:
        {"lines": [...], "commit": N} journals + applies; {"bootstrap":
        state} installs a dump_state() snapshot; commit=-1 is a pure
        status probe. Bodies are internal wire format — no version
        conversion, no auth (peer plane, like /healthz).
        GET /replication/status — role/commit/lag introspection."""
        rep = getattr(self.api, "replication", None)
        if rest == ("status",) and verb == "GET":
            if rep is None:
                raise APIError(
                    404, "NotFound", "replication not configured"
                )
            self._send_json(200, rep.status())
            return
        if rest != ("append",) or verb != "POST":
            raise APIError(
                404, "NotFound",
                "replication endpoints: POST /replication/append, "
                "GET /replication/status",
            )
        from kubernetes_tpu_torch.store.replication import (
            FollowerReplica,
            ReplicationError,
        )

        if not isinstance(rep, FollowerReplica):
            raise APIError(
                409, "Conflict",
                "this apiserver does not front a follower replica",
            )
        length = int(self.headers.get("Content-Length", 0) or 0)
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError as e:
            raise APIError(400, "BadRequest", f"invalid JSON body: {e}")
        try:
            if "bootstrap" in body:
                rep.bootstrap(body["bootstrap"])
                journaled = rep.store.journaled_version
            else:
                journaled = rep.append(
                    list(body.get("lines", ())),
                    int(body.get("commit", -1)),
                )
        except ReplicationError as e:
            # 409: the shipper must NOT retry into a promoted follower
            # (a stale leader's stream) — it surfaces as a dead link.
            raise APIError(409, "Conflict", str(e))
        self._send_json(200, dict(rep.status(), journaled=journaled))

    def _forward_leader(self, verb: str) -> Tuple[str, int]:
        """Follower write path: relay the request verbatim to the
        leader apiserver and pass its response through. The follower
        stays a pure read fan-out — its store is a replica and refuses
        local mutation; clients keep one endpoint list and never need
        to know who leads (the reference gets this for free from etcd:
        any member proxies writes to the raft leader)."""
        import urllib.error
        import urllib.request

        url = self.api.leader_url.rstrip("/") + self.path
        length = int(self.headers.get("Content-Length", 0) or 0)
        data = self.rfile.read(length) if length else None
        headers = {}
        for h in ("Content-Type", "Authorization"):
            if self.headers.get(h):
                headers[h] = self.headers[h]
        # One trace end-to-end across the hop: reuse the client's
        # X-Trace-Id when it stamped one; otherwise mint an id HERE so
        # the follower's request-log entry and the leader's carry the
        # same trace id (before this, an unstamped forwarded mutation
        # appeared as two unrelated requests at /debug/requests).
        tid = (
            self.headers.get(tracing.TRACE_HEADER)
            or tracing.current_trace_id()
            or tracing.new_trace_id()
        )
        headers[tracing.TRACE_HEADER] = tid
        self._request_trace_id = tid
        req = urllib.request.Request(
            url, data=data, headers=headers, method=verb
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = resp.read()
                code = resp.status
                ctype = resp.headers.get("Content-Type", "application/json")
        except urllib.error.HTTPError as e:
            body = e.read()
            code = e.code
            ctype = e.headers.get("Content-Type", "application/json")
        except urllib.error.URLError as e:
            raise APIError(
                502, "BadGateway", f"leader forward failed: {e}"
            )
        self._send_text(code, body, ctype)
        return "forwarded", code

    def _route(self) -> Tuple[str, ...]:
        parsed = urlparse(self.path)
        self.query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        return tuple(s for s in parsed.path.split("/") if s)

    # -- verbs --------------------------------------------------------

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_PUT(self):  # noqa: N802
        self._dispatch("PUT")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    def do_PATCH(self):  # noqa: N802
        self._dispatch("PATCH")

    def _dispatch(self, verb: str) -> None:
        # Propagated request trace (Dapper hop): a client that stamped
        # X-Trace-Id gets this request recorded as a span under ITS
        # trace id — the scheduler's bind call and the apiserver's
        # handling merge into one trace at /debug/traces. No header,
        # no cost. (In-process LocalTransport calls skip HTTP entirely
        # and join the caller's trace via the contextvar instead.)
        tid = self.headers.get(tracing.TRACE_HEADER)
        # Stashed for the request log (reset per request — keep-alive
        # reuses this handler instance): /debug/requests entries join
        # /debug/traces on it.
        self._request_trace_id = tid or ""
        if not tid:
            return self._dispatch_inner(verb)
        with tracing.trace(
            f"{verb} {urlparse(self.path).path}", trace_id=tid
        ):
            return self._dispatch_inner(verb)

    def _dispatch_inner(self, verb: str) -> None:
        start = time.monotonic()
        resource = ""
        code = 200
        # Reset per request: keep-alive connections reuse this handler
        # instance, and a prior request's version must not leak.
        self.wire_version = "v1"
        try:
            parts = self._route()
            if parts == ("healthz",):
                self._serve_healthz()
                return
            if parts and parts[0] == "replication":
                # Internal replication plane (store/replication.py
                # HTTPLink): peer traffic, ahead of the auth chain like
                # /healthz — the WAL stream must keep flowing while the
                # user-facing auth config churns.
                self._serve_replication(verb, parts[1:])
                return
            if parts == ("metrics",):
                self._send_text(
                    200, metrics.DEFAULT.render(), "text/plain; version=0.0.4"
                )
                return
            if parts == ("version",):
                self._send_json(200, {"gitVersion": __version__, "platform": "gpu"})
                return
            if parts == ("validate",):
                # Component validation report (pkg/apiserver/validator.go):
                # probe every registered component; 500 when any fails.
                statuses = self.api.list("componentstatuses")["items"]
                report = []
                all_healthy = bool(statuses)
                for cs in statuses:
                    cond = (cs.get("conditions") or [{}])[0]
                    healthy = cond.get("status") == "True"
                    all_healthy = all_healthy and healthy
                    report.append(
                        {
                            "component": cs["metadata"]["name"],
                            "health": "ok" if healthy else "unhealthy",
                            "msg": cond.get("message", ""),
                        }
                    )
                self._send_json(200 if all_healthy else 500, {"validate": report})
                return
            if parts == ("api",):
                self._send_json(
                    200,
                    {"kind": "APIVersions", "versions": list(conversion.VERSIONS)},
                )
                return
            if parts and parts[0] == "debug":
                # Debug surfaces (pkg/httplog + net/http/pprof analogs),
                # behind the same auth chain as the API.
                self._check_auth(verb, parts)
                self._serve_debug(parts[1:])
                return
            if parts == ("swagger.json",) or parts == ("swaggerapi",):
                # API discovery document (reference serves swagger 1.2
                # from api/swagger-spec/ via pkg/apiserver; ours is
                # generated from the live resource registry). Behind
                # the same auth chain as the API (master.go wraps the
                # FULL mux, UI included).
                self._check_auth(verb, parts)
                self._send_json(200, _swagger_doc())
                return
            if parts and parts[0] == "swagger-ui":
                # Interactive API browser over /swagger.json (the
                # reference vendors third_party/swagger-ui/ and wires
                # it in pkg/master/master.go; ours is a self-contained
                # page — zero-egress box, no external assets).
                self._check_auth(verb, parts)
                self._send_text(
                    200, _SWAGGER_UI_PAGE, "text/html; charset=utf-8"
                )
                return
            if parts and parts[0] == "ui":
                # Any /ui/* path serves the SPA (it hash-routes
                # client-side, like the reference's app shell).
                self._check_auth(verb, parts)
                self._serve_ui()
                return
            if (
                len(parts) < 2
                or parts[0] != "api"
                or parts[1] not in conversion.VERSIONS
            ):
                raise APIError(404, "NotFound", f"unknown path {self.path!r}")
            # Multi-version negotiation (pkg/api/latest/latest.go:32-78):
            # bodies decode from — and responses encode to — the path's
            # version; the registry/store speak internal (v1) only.
            self.wire_version = parts[1]
            rest = parts[2:]
            self._check_auth(verb, rest)
            sem = self.inflight
            if sem is None or _request_is_long_running(rest, self.query):
                resource, code = self._api_v1(verb, rest)
            elif sem.acquire(blocking=False):
                try:
                    resource, code = self._api_v1(verb, rest)
                finally:
                    sem.release()
            else:
                _INFLIGHT_REJECTS.inc()
                raise APIError(
                    429, "TooManyRequests",
                    "too many requests in flight; retry",
                )
        except APIError as e:
            code = e.code
            self._send_json(e.code, e.to_status())
        except (BrokenPipeError, ConnectionResetError):
            code = 499
        except Exception as e:  # pragma: no cover - crash containment
            code = 500
            try:
                self._send_json(
                    500,
                    {
                        "kind": "Status",
                        "status": "Failure",
                        "reason": "InternalError",
                        "message": str(e),
                        "code": 500,
                    },
                )
            except Exception:  # ktlint: disable=KT003
                pass  # client already gone; the 500 has nowhere to go
        finally:
            duration = time.monotonic() - start
            _REQS.inc(verb=verb, resource=resource, code=str(code))
            _LATENCY.observe(duration, verb=verb, resource=resource)
            from kubernetes_tpu_torch.utils import debug

            debug.DEFAULT_REQUEST_LOG.record(
                verb, self.path, code, duration,
                trace_id=getattr(self, "_request_trace_id", ""),
            )

    def _check_auth(self, verb: str, rest: Tuple[str, ...]) -> None:
        """Authenticate + authorize an /api request. Reference:
        handler chain in pkg/master/master.go:584-585 (authn wraps
        authz wraps the REST mux); 401 on bad credentials, 403 on
        policy denial."""
        authenticator = getattr(self, "authenticator", None)
        authorizer = getattr(self, "authorizer", None)
        if authenticator is None and authorizer is None:
            return
        from kubernetes_tpu_torch.server import auth as authpkg

        user = authpkg.UserInfo(name="system:anonymous")
        # x509 first, like the reference's request-authenticator union
        # (authn.go:35): a CA-verified client cert IS the identity; the
        # Authorization header is only consulted without one.
        peercert = None
        getpeercert = getattr(self.connection, "getpeercert", None)
        if getpeercert is not None:
            try:
                peercert = getpeercert()
            except ValueError:
                peercert = None
        if peercert:
            try:
                user = authpkg.X509Authenticator().authenticate_peer_cert(
                    peercert
                )
            except authpkg.AuthenticationError as e:
                raise APIError(401, "Unauthorized", str(e))
        elif authenticator is not None:
            try:
                user = authenticator.authenticate_request(
                    self.headers.get("Authorization", "")
                )
            except authpkg.AuthenticationError as e:
                raise APIError(401, "Unauthorized", str(e))
        if authorizer is not None:
            # Derive (resource, namespace) from the path shape. The
            # watch/redirect prefixes are verbs, not resources — policy
            # is written against the underlying resource.
            resource, ns = "", ""
            if rest and rest[0] in ("watch", "redirect"):
                rest = rest[1:]
            if len(rest) == 3 and rest[0] == "namespaces" and rest[2] == "finalize":
                resource = "namespaces"  # cluster-scoped subresource path
            elif len(rest) >= 3 and rest[0] == "namespaces":
                ns, resource = rest[1], rest[2]
            elif rest:
                resource = rest[0]
            # Bulk verbs ride the resource segment ("pods:bulk");
            # policy is written against the underlying resource.
            resource = resource.partition(":")[0]
            try:
                authorizer.authorize(
                    authpkg.AuthzAttributes(
                        user=user,
                        readonly=verb in ("GET", "HEAD"),
                        resource=resource,
                        namespace=ns,
                    )
                )
            except authpkg.AuthorizationError as e:
                raise APIError(403, "Forbidden", str(e))

    # -- /api/v1 router ----------------------------------------------

    def _api_v1(self, verb: str, rest: Tuple[str, ...]) -> Tuple[str, int]:
        api = self.api
        if (
            verb in ("POST", "PUT", "DELETE", "PATCH")
            and api.leader_url
            and getattr(api.store, "replica", False)
        ):
            # Stateless-apiserver write path: this replica's store is
            # read-only; every mutation forwards to the leader. Reads
            # and watches stay local (the watch cache fans out on every
            # replica — that's the whole point of N apiservers).
            return self._forward_leader(verb)
        q = self.query
        lsel = q.get("labelSelector", "")
        fsel = q.get("fieldSelector", "")

        if not rest:
            self._send_json(
                200,
                {
                    "kind": "APIResourceList",
                    "resources": sorted(
                        {i.name for i in RESOURCES.values()}
                    ),
                },
            )
            return "", 200

        # Watch endpoints: /watch/{resource} or /watch/namespaces/{ns}/{resource}
        if rest[0] == "watch":
            wrest = rest[1:]
            if len(wrest) == 1:
                resource, ns = wrest[0], ""
            elif len(wrest) == 3 and wrest[0] == "namespaces":
                resource, ns = wrest[2], wrest[1]
            else:
                raise APIError(404, "NotFound", f"bad watch path {self.path!r}")
            self._serve_watch(resource, ns, lsel, fsel, q)
            # Same long-running metrics label as ?watch=true — a watch
            # holds its connection for its lifetime and must not feed
            # the plain-GET p99 series the SLO gate reads.
            return resource + "/watch", 200

        # Legacy REDIRECT verb (pkg/apiserver/redirect.go:57-100 +
        # api_installer.go:280): GET /redirect/... answers 307 with the
        # resource's backend Location — pods (pod IP:port), services
        # (a ready endpoint), nodes (the kubelet API) — instead of
        # relaying like /proxy does.
        if rest[0] == "redirect":
            if verb != "GET":
                raise APIError(
                    405, "MethodNotAllowed", "redirect supports GET only"
                )
            return self._redirect(rest[1:])

        # Namespace finalize subresource (not a namespaced collection
        # path): PUT /api/v1/namespaces/{name}/finalize.
        if (
            len(rest) == 3
            and rest[0] == "namespaces"
            and rest[2] == "finalize"
            and verb == "PUT"
        ):
            out = self.api.finalize_namespace(rest[1], self._read_body())
            self._send_json(200, out)
            return "namespaces", 200

        # Namespaced paths.
        if rest[0] == "namespaces" and len(rest) >= 3:
            ns = rest[1]
            resource = rest[2]
            if resource == "bindings" and verb == "POST":
                body = self._read_body()
                name = body.get("metadata", {}).get("name", "")
                if name:
                    tracing.note_pods((name,))
                out = api.bind(ns, body)
                self._send_json(201, out)
                return "bindings", 201
            if resource == "bulkbindings" and verb == "POST":
                body = self._read_body()
                tracing.note_pods(
                    n
                    for n in (
                        b.get("metadata", {}).get("name", "")
                        for b in body.get("bindings", ())
                    )
                    if n
                )
                # The whole body dict rides through: it carries the
                # optional "atomic" (all-or-nothing gang commit) flag
                # alongside "bindings".
                results = api.bind_bulk(ns, body)
                self._send_json(
                    200, {"kind": "BindingResultList", "results": results}
                )
                return "bulkbindings", 200
            if resource == "bulkevents" and verb == "POST":
                body = self._read_body()
                results = api.create_events_bulk(ns, body.get("items", []))
                self._send_json(
                    200, {"kind": "EventResultList", "results": results}
                )
                return "bulkevents", 200
            if ":" in resource and verb == "POST" and len(rest) == 3:
                # Bulk object verbs: POST .../{resource}:bulk (create),
                # :bulkupdate, :bulkdelete — N objects through one
                # store group commit (the API-plane write fast path).
                return self._bulk(resource, ns)
            if len(rest) == 3:
                return self._collection(verb, resource, ns, lsel, fsel)
            name = rest[3]
            if len(rest) == 5 and rest[4] == "binding" and verb == "POST":
                tracing.note_pods((name,))
                body = self._read_body()
                body.setdefault("metadata", {})["name"] = name
                out = api.bind(ns, body)
                self._send_json(201, out)
                return "bindings", 201
            if (
                len(rest) == 5
                and rest[4] == "eviction"
                and resource == "pods"
                and verb == "POST"
            ):
                # Eviction subresource (shape: policy/v1 Eviction) —
                # graceful delete; the victim goes Terminating now and
                # is removed when its kubelet confirms.
                out = api.evict_pod(ns, name, self._read_body())
                self._send_json(201, out)
                return "pods/eviction", 201
            if len(rest) == 5 and rest[4] == "status" and verb == "PUT":
                out = api.update_status(
                    resource, ns, name, self._read_body(self._kind_of(resource))
                )
                self._send_json(200, out)
                return resource, 200
            if (
                len(rest) == 5
                and rest[4] == "log"
                and resource == "pods"
                and verb == "GET"
            ):
                # GET /pods/{name}/log (pkg/registry/pod/etcd/etcd.go:45
                # LogREST): resolve the pod's kubelet and relay.
                return self._pod_log(ns, name)
            if (
                len(rest) == 5
                and rest[4] == "portforward"
                and resource == "pods"
                and verb == "GET"
            ):
                # Websocket tunnel relayed through to the pod's kubelet
                # (pkg/registry/pod/etcd/etcd.go:49 PortForwardREST +
                # pkg/client/portforward; SPDY there, websocket here).
                self.api.connect(resource, ns, name, "portforward")
                self._pod_portforward(ns, name)
                return "pods/portforward", 101
            if (
                len(rest) >= 5
                and rest[4] == "proxy"
                and resource == "pods"
                and verb in ("GET", "POST")
            ):
                # Pod proxy subresource (etcd.go:47 ProxyREST): relay
                # an HTTP request to the pod's port. Name may carry
                # ":port" (reference's pods/name:port/proxy form) —
                # parsed ONCE here so admission and the relay can't
                # disagree on the pod name.
                pod_name, _, port_s = name.partition(":")
                self.api.connect(resource, ns, pod_name, "proxy")
                return self._pod_proxy(
                    verb, ns, pod_name,
                    int(port_s) if port_s.isdigit() else 0,
                    rest[5:],
                )
            if (
                len(rest) >= 5
                and rest[4] == "proxy"
                and resource == "services"
                and verb in ("GET", "POST")
            ):
                # Services proxy subresource (pkg/registry/service/
                # rest.go ResourceLocation + pkg/apiserver/proxy.go):
                # relay to a randomly-chosen ready endpoint. Name may
                # carry ":port" selecting an endpoint port by name or
                # number.
                svc_name, _, port_s = name.partition(":")
                self.api.connect(resource, ns, svc_name, "proxy")
                ip, port = self.api.service_location(ns, svc_name, port_s)
                url = f"http://{ip}:{port}/" + "/".join(rest[5:])
                code = self._relay_http(url, verb, "service proxy")
                return "services/proxy", code
            if len(rest) == 5 and rest[4] in ("exec", "attach", "run") and verb == "POST":
                # CONNECT subresources (pkg/apiserver/api_installer.go
                # CONNECT routes). Admission (DenyExecOnPrivileged) runs
                # inside pod_exec; the call relays to the node agent's
                # API (pkg/kubelet/server.go /exec/) as JSON run-exec.
                if resource != "pods":
                    raise APIError(
                        404, "NotFound", f"{resource} has no {rest[4]} subresource"
                    )
                body = self._read_body()
                container = self.query.get("container") or body.get("container", "")
                if "command" not in body and "command" in self.query:
                    body["command"] = [self.query["command"]]
                out = api.pod_exec(ns, name, container, body)
                self._send_json(200, out)
                return "pods/exec", 200
            if len(rest) == 4:
                return self._item(verb, resource, ns, name)
            raise APIError(404, "NotFound", f"unknown path {self.path!r}")

        # Cluster-scoped or cross-namespace.
        resource = rest[0]
        if ":" in resource and verb == "POST" and len(rest) == 1:
            return self._bulk(resource, "")
        info = RESOURCES.get(resource)
        if info is None:
            raise APIError(404, "NotFound", f"unknown resource {resource!r}")
        if (
            len(rest) >= 3
            and resource == "nodes"
            and rest[2] == "proxy"
            and verb == "GET"
        ):
            # Node proxy subresource: relay to the node's kubelet API
            # (reference: pkg/master/master.go:497-520 dials node:10250
            # for logs/stats/spec through the apiserver).
            return self._node_proxy(rest[1], rest[3:])
        if len(rest) == 1:
            return self._collection(verb, resource, "", lsel, fsel)
        if info.namespaced and len(rest) >= 2:
            raise APIError(
                400, "BadRequest", f"{resource} is namespaced; use /namespaces/.."
            )
        if len(rest) == 2:
            return self._item(verb, resource, "", rest[1])
        if len(rest) == 3 and rest[2] == "status" and verb == "PUT":
            # Cluster-scoped status subresource — PUT /nodes/{n}/status
            # is every kubelet's heartbeat write (the reference installs
            # status routes for all resources, api_installer.go).
            out = api.update_status(
                resource, "", rest[1], self._read_body(self._kind_of(resource))
            )
            self._send_json(200, out)
            return resource, 200
        raise APIError(404, "NotFound", f"unknown path {self.path!r}")

    def _bulk(self, spec: str, ns: str) -> Tuple[str, int]:
        """POST {resource}:bulk|:bulkupdate|:bulkdelete — batch verbs
        committing N objects under one WAL group commit (api.create_bulk
        and friends). Bodies: {"items": [...]} for create/update,
        {"names": [...]} for delete. Per-item Status results in order."""
        base, _, bulk_verb = spec.partition(":")
        if RESOURCES.get(base) is None:
            raise APIError(404, "NotFound", f"unknown resource {base!r}")
        # No kind hint: the body is a bulk ENVELOPE, not an object —
        # version conversion dispatches on kind and would mangle it.
        # Bulk verbs are v1-only by contract.
        body = self._read_body()
        if bulk_verb == "bulk":
            # copy=False: the just-parsed body is private to this
            # request — the store may own the dicts outright.
            results = self.api.create_bulk(
                base, ns, body.get("items", []), copy=False
            )
        elif bulk_verb == "bulkupdate":
            results = self.api.update_bulk(
                base, ns, body.get("items", []), copy=False
            )
        elif bulk_verb == "bulkdelete":
            results = self.api.delete_bulk(base, ns, body.get("names", []))
        else:
            raise APIError(
                404, "NotFound",
                f"unknown bulk verb {bulk_verb!r} "
                "(bulk, bulkupdate, bulkdelete)",
            )
        self._send_json(200, {"kind": "BulkResultList", "results": results})
        return f"{base}/{bulk_verb}", 200

    # -- pod subresources proxied to the kubelet API ------------------

    def _pod_log(self, ns: str, name: str) -> Tuple[str, int]:
        tail_raw = self.query.get("tailLines") or self.query.get("tail")
        tail = None
        if tail_raw:
            try:
                tail = int(tail_raw)
            except ValueError:
                raise APIError(
                    400, "BadRequest", f"invalid tailLines {tail_raw!r}"
                )
        text = self.api.pod_log(
            ns,
            name,
            container=self.query.get("container", ""),
            tail=tail,
        )
        self._send_text(200, text)
        return "pods/log", 200

    def _pod_portforward(self, ns: str, name: str) -> None:
        """Relay a websocket tunnel: client <-> apiserver <-> kubelet."""
        from kubernetes_tpu_torch.utils import websocket as ws

        key = self.headers.get("Sec-WebSocket-Key")
        if self.headers.get("Upgrade", "").lower() != "websocket" or not key:
            raise APIError(
                400, "BadRequest", "port-forward requires websocket upgrade"
            )
        port = self.query.get("port", "")
        if not port.isdigit():
            raise APIError(400, "BadRequest", f"invalid ?port={port!r}")
        base, _pod = self.api.kubelet_location(ns, name)
        parsed = urlparse(base)
        upstream = ws.WebSocketClient(
            parsed.hostname,
            parsed.port,
            f"/portForward/{ns or 'default'}/{name}/{port}",
        )
        upstream.clear_timeout()
        self.send_response(101, "Switching Protocols")
        for hname, value in ws.handshake_headers(key):
            self.send_header(hname, value)
        self.end_headers()
        ws.relay_ws_ws(
            ws.ServerEndpoint(self.rfile, self.wfile, raw_socket=self.connection),
            upstream,
        )
        self.close_connection = True

    def _relay_http(self, url: str, verb: str, what: str) -> int:
        """Relay one HTTP request (with query string, body, and salient
        headers) to `url`, passing the upstream's status/body through.
        Shared by the pod and node proxy subresources."""
        import urllib.error
        import urllib.request

        raw_query = urlparse(self.path).query
        if raw_query:
            url += "?" + raw_query
        data = None
        headers = {}
        if verb == "POST":
            length = int(self.headers.get("Content-Length", 0) or 0)
            data = self.rfile.read(length) if length else b""
            if self.headers.get("Content-Type"):
                headers["Content-Type"] = self.headers["Content-Type"]
        if self.headers.get("Accept"):
            headers["Accept"] = self.headers["Accept"]
        req = urllib.request.Request(url, data=data, headers=headers, method=verb)
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                body = resp.read()
                ctype = resp.headers.get("Content-Type", "text/plain")
                code = resp.status
        except urllib.error.HTTPError as e:
            body = e.read()
            ctype = e.headers.get("Content-Type", "text/plain")
            code = e.code
        except urllib.error.URLError as e:
            raise APIError(502, "BadGateway", f"{what} dial failed: {e}")
        self._send_text(code, body, ctype)
        return code

    def _pod_proxy(
        self,
        verb: str,
        ns: str,
        name: str,
        port: int,
        subpath: Tuple[str, ...],
    ) -> Tuple[str, int]:
        """Relay one HTTP request to the pod's port (host network:
        the pod's host IP + the explicit, or first declared, container
        port)."""
        base, pod = self.api.kubelet_location(ns, name)
        port = port or _first_container_port(pod, name)
        host = urlparse(base).hostname or "127.0.0.1"
        url = f"http://{host}:{port}/" + "/".join(subpath)
        code = self._relay_http(url, verb, "pod proxy")
        return "pods/proxy", code

    def _redirect(self, rest: Tuple[str, ...]) -> Tuple[str, int]:
        """Resolve a resource's backend location and answer 307
        (RedirectHandler: ResourceLocation per storage kind)."""
        if len(rest) == 4 and rest[0] == "namespaces":
            ns, resource, name = rest[1], rest[2], rest[3]
        elif len(rest) == 2:
            ns, resource, name = "", rest[0], rest[1]
        else:
            raise APIError(404, "NotFound", f"bad redirect path {self.path!r}")
        base, _, port_s = name.partition(":")
        if resource == "services":
            ip, port = self.api.service_location(ns, base, port_s)
            location = f"http://{ip}:{port}/"
        elif resource == "pods":
            pod = self.api.get("pods", ns, base)
            ip = pod.get("status", {}).get("podIP", "")
            if not ip:
                raise APIError(
                    409, "Conflict", f"pod {base!r} has no pod IP yet"
                )
            if not port_s:
                port = _first_container_port(pod, base)
            elif port_s.isdigit():
                port = int(port_s)
            else:
                # Named container port, like the service form resolves
                # endpoint port names.
                port = next(
                    (
                        p["containerPort"]
                        for c in pod.get("spec", {}).get("containers", [])
                        for p in c.get("ports", [])
                        if p.get("name") == port_s and p.get("containerPort")
                    ),
                    0,
                )
                if not port:
                    raise APIError(
                        400, "BadRequest",
                        f"pod {base!r} has no container port named {port_s!r}",
                    )
            location = f"http://{ip}:{port}/"
        elif resource == "nodes":
            # kubelet_location resolves via a pod normally; nodes
            # resolve directly from their status.
            node = self.api.get("nodes", "", base)
            status = node.get("status", {})
            port = (
                status.get("daemonEndpoints", {})
                .get("kubeletEndpoint", {})
                .get("port", 0)
            )
            if not port:
                raise APIError(
                    501, "NotImplemented",
                    f"node {base!r} does not publish a kubelet API endpoint",
                )
            ip = next(
                (
                    a.get("address")
                    for a in status.get("addresses", [])
                    if a.get("type") == "InternalIP"
                ),
                "127.0.0.1",
            )
            location = f"http://{ip}:{port}/"
        else:
            raise APIError(
                405, "MethodNotAllowed", f"{resource} is not a redirector"
            )
        self.send_response(307)
        self.send_header("Location", location)
        self.send_header("Content-Length", "0")
        self.end_headers()
        return f"{resource}/redirect", 307

    def _node_proxy(
        self, node_name: str, subpath: Tuple[str, ...]
    ) -> Tuple[str, int]:
        """GET /nodes/{name}/proxy/{path} -> the node's kubelet API."""
        node = self.api.get("nodes", "", node_name)
        status = node.get("status", {})
        port = (
            status.get("daemonEndpoints", {})
            .get("kubeletEndpoint", {})
            .get("port", 0)
        )
        if not port:
            raise APIError(
                501, "NotImplemented",
                f"node {node_name!r} does not publish a kubelet API endpoint",
            )
        ip = next(
            (
                a.get("address")
                for a in status.get("addresses", [])
                if a.get("type") == "InternalIP"
            ),
            "127.0.0.1",
        )
        url = f"http://{ip}:{port}/" + "/".join(subpath)
        code = self._relay_http(url, "GET", "kubelet proxy")
        return "nodes/proxy", code

    def _collection(self, verb, resource, ns, lsel, fsel) -> Tuple[str, int]:
        api = self.api
        if verb == "GET":
            if self.query.get("watch") in ("true", "1"):
                self._serve_watch(resource, ns, lsel, fsel, self.query)
                # Distinct metrics label: a watch holds its connection
                # for its whole lifetime — folding that duration into
                # the plain-GET latency series would wreck the p99 SLO
                # signal (the reference uses verb WATCHLIST the same
                # way, pkg/apiserver/metrics.go).
                return resource + "/watch", 200
            # Watch-cache fast path: the response is assembled from
            # per-object encodings cached by resourceVersion — repeat
            # LISTs (controller relists, reflector syncs) never
            # re-serialize unchanged objects. Non-v1 wire versions and
            # live componentstatuses fall back to the dict path.
            if getattr(self, "wire_version", "v1") == "v1":
                enc = api.list_response_bytes(resource, ns, lsel, fsel)
                if enc is not None:
                    self._send_text(200, enc, "application/json")
                    return resource, 200
            # copy=False: the list is encoded and discarded right here,
            # so the store's read-only refs skip a full deep copy.
            self._send_json(200, api.list(resource, ns, lsel, fsel, copy=False))
            return resource, 200
        if verb == "POST":
            body = self._read_body(self._kind_of(resource))
            if resource == "pods":
                name = body.get("metadata", {}).get("name", "")
                if name:
                    tracing.note_pods((name,))
            out = api.create(resource, ns, body)
            self._send_json(201, out)
            return resource, 201
        raise APIError(405, "MethodNotAllowed", f"{verb} not allowed on collection")

    def _item(self, verb, resource, ns, name) -> Tuple[str, int]:
        api = self.api
        if verb == "GET":
            enc = None
            if getattr(self, "wire_version", "v1") == "v1":
                # Cached per-object encoding (miss = absent object or
                # stale cache: the slow path owns 404 semantics).
                enc = api.get_response_bytes(resource, ns, name)
            if enc is not None:
                self._send_text(200, enc, "application/json")
            else:
                self._send_json(200, api.get(resource, ns, name))
        elif verb == "PUT":
            self._send_json(
                200, api.update(resource, ns, name, self._read_body(self._kind_of(resource)))
            )
        elif verb == "PATCH":
            # All three reference patch types, selected by Content-Type
            # (resthandler.go:446): json-patch / strategic-merge /
            # merge (the default; plain application/json means merge).
            # The kind hint lets a kind-less partial v1beta3 merge body
            # still version-convert; json-patch op arrays pass through
            # untouched and address internal (v1) field names.
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            ptype = {
                "application/json-patch+json": "json",
                "application/strategic-merge-patch+json": "strategic",
            }.get(ctype, "merge")
            self._send_json(
                200,
                api.patch(
                    resource, ns, name,
                    self._read_body(self._kind_of(resource)),
                    patch_type=ptype,
                ),
            )
        elif verb == "DELETE":
            grace = None
            g = self.query.get("gracePeriodSeconds")
            if g is not None:
                try:
                    grace = int(g)
                except ValueError:
                    raise APIError(
                        400, "BadRequest",
                        f"gracePeriodSeconds must be numeric, got {g!r}",
                    )
            self._send_json(
                200, api.delete(resource, ns, name, grace_period_seconds=grace)
            )
        else:
            raise APIError(405, "MethodNotAllowed", f"{verb} not allowed on item")
        return resource, 200

    def _serve_watch(self, resource, ns, lsel, fsel, q) -> None:
        try:
            since = int(q.get("resourceVersion", "0") or "0")
            timeout = float(q.get("timeoutSeconds", "0") or "0") or None
            maxsize = int(q.get("maxsize", "4096") or "4096")
        except ValueError:
            raise APIError(
                400, "BadRequest",
                "resourceVersion/timeoutSeconds/maxsize must be numeric",
            )
        # Both transports the reference serves (pkg/apiserver/watch.go:
        # 45-102): websocket when the client asks to upgrade, chunked
        # newline-JSON otherwise. Frame payloads are identical.
        websocket = (
            self.headers.get("Upgrade", "").lower() == "websocket"
            and self.headers.get("Sec-WebSocket-Key")
        )
        stream = self.api.watch(
            resource, ns, since=since, label_selector=lsel,
            field_selector=fsel, maxsize=maxsize,
        )
        from kubernetes_tpu_torch.utils import websocket as ws

        if websocket:
            self.send_response(101, "Switching Protocols")
            for name, value in ws.handshake_headers(
                self.headers["Sec-WebSocket-Key"]
            ):
                self.send_header(name, value)
            self.end_headers()
        else:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                wait = 1.0
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        break
                ev = stream.next(timeout=wait)
                if ev is None:
                    if stream.closed:
                        break
                    continue
                # Burst coalescing: drain whatever else is already
                # queued (bounded) and ship ONE socket write. At bulk
                # churn rates a write+flush syscall per event made this
                # writer thread the slow consumer — the store would
                # drop the stream mid-drill.
                batch = [ev]
                while len(batch) < 512:
                    nxt = stream.next(timeout=0)
                    if nxt is None:
                        break
                    batch.append(nxt)
                out = []
                version = getattr(self, "wire_version", "v1")
                for ev in batch:
                    obj = ev.object
                    if version != "v1" and isinstance(obj, dict):
                        obj = conversion.from_internal(obj, version)
                        frame = json.dumps(
                            {"type": ev.type, "object": obj}
                        ).encode()
                    else:
                        # Shared frame cache: one event fanned out to
                        # N watch connections is encoded once (keyed
                        # by the store's globally unique version).
                        frame = self.api.caches.frame_bytes(
                            ev.type, ev.version, obj
                        )
                    if websocket:
                        out.append(ws.encode_frame(frame))
                    else:
                        frame += b"\n"
                        out.append(
                            b"%x\r\n" % len(frame) + frame + b"\r\n"
                        )
                self.wfile.write(b"".join(out))
                self.wfile.flush()
                # Fan-out lag SLI: how many store versions this
                # connection's delivery trails ITS resource's applied
                # watermark by (one observation per burst, not per
                # event). Filtered streams — selector OR namespace
                # scoped — are skipped: events filtered out of their
                # view never advance the delivered version, which
                # would read as permanent false lag against the
                # resource-wide watermark.
                last_v = batch[-1].version
                if last_v and not ns and not lsel and not fsel:
                    applied = self.api.caches.applied_version(resource)
                    if applied:
                        sli.observe_watch_lag(resource, applied - last_v)
        except (BrokenPipeError, ConnectionResetError, socket.timeout):
            pass
        finally:
            stream.close()
            try:
                if websocket:
                    self.wfile.write(ws.encode_frame(b"", ws.OP_CLOSE))
                else:
                    self.wfile.write(b"0\r\n\r\n")
            except Exception:  # ktlint: disable=KT003
                pass  # watch client already gone mid-close
            self.close_connection = True


def _swagger_doc() -> dict:
    """OpenAPI-style discovery doc generated from the resource registry
    (reference ships a static api/swagger-spec/v1.json; generating from
    RESOURCES means the doc can't drift from the router)."""
    from kubernetes_tpu_torch.server.registry import unique_resources

    paths = {}
    for info in unique_resources():
        base = (
            f"/api/v1/namespaces/{{namespace}}/{info.name}"
            if info.namespaced
            else f"/api/v1/{info.name}"
        )
        paths[base] = {
            "get": {"summary": f"list {info.kind} objects"},
            "post": {"summary": f"create a {info.kind}"},
        }
        paths[base + "/{name}"] = {
            "get": {"summary": f"read a {info.kind}"},
            "put": {"summary": f"replace a {info.kind}"},
            "delete": {"summary": f"delete a {info.kind}"},
        }
        paths[f"/api/v1/watch/{info.name}"] = {
            "get": {"summary": f"watch {info.kind} objects (chunked or websocket)"}
        }
    paths["/api/v1/namespaces/{namespace}/pods/{name}/log"] = {
        "get": {"summary": "read container logs (kubelet relay)"}
    }
    paths["/api/v1/namespaces/{namespace}/pods/{name}/exec"] = {
        "post": {"summary": "run a command in a container (kubelet relay)"}
    }
    paths["/api/v1/namespaces/{namespace}/bindings"] = {
        "post": {"summary": "bind a pod to a node"}
    }
    return {
        "openapi": "3.0.0",
        "info": {"title": "kubernetes-tpu", "version": __version__},
        "paths": paths,
    }


#: Interactive API browser (reference: third_party/swagger-ui/ wired
#: at /swagger-ui/ by pkg/master/master.go). Self-contained: renders
#: /swagger.json as expandable per-path operation cards with a
#: "try it" runner for GET operations (path params become inputs).
_SWAGGER_UI_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>kubernetes-tpu API</title>
<style>
body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1c2733}
header{background:#1c2733;color:#fff;padding:14px 22px;font-size:18px}
header a{color:#8fd0ff;text-decoration:none;margin-left:14px;font-size:13px}
#paths{max-width:980px;margin:18px auto;padding:0 16px}
.path{background:#fff;border:1px solid #dde3ea;border-radius:6px;margin:8px 0}
.path>summary{padding:9px 14px;cursor:pointer;font-family:ui-monospace,monospace;
  font-size:13px;display:flex;gap:10px;align-items:center}
.verb{font-size:11px;font-weight:700;border-radius:3px;padding:2px 7px;color:#fff}
.get{background:#2f81f7}.post{background:#2da44e}.put{background:#bf8700}
.delete{background:#cf222e}
.op{border-top:1px solid #eef1f5;padding:10px 16px;font-size:13px}
.op .summary{color:#4a5766;margin-left:8px}
.try{margin-top:8px}
.try input{font-family:ui-monospace,monospace;font-size:12px;margin:0 6px 4px 0;
  padding:3px 6px;border:1px solid #c6ccd4;border-radius:4px}
.try button{padding:3px 12px;border:0;border-radius:4px;background:#2f81f7;
  color:#fff;cursor:pointer;font-size:12px}
pre.result{background:#0d1117;color:#d7e1ec;font-size:11px;padding:10px;
  border-radius:6px;max-height:340px;overflow:auto;white-space:pre-wrap}
</style></head><body>
<header>kubernetes-tpu API browser
  <a href="/swagger.json">swagger.json</a><a href="/ui/">dashboard</a>
  <a href="/metrics">metrics</a></header>
<div id="paths">loading /swagger.json…</div>
<script>
(async () => {
  const doc = await (await fetch('/swagger.json')).json();
  const root = document.getElementById('paths');
  root.innerHTML = '<p style="color:#4a5766">' +
    (doc.info ? doc.info.title + ' v' + doc.info.version + ' — ' : '') +
    Object.keys(doc.paths).length + ' paths</p>';
  for (const [path, ops] of Object.entries(doc.paths).sort()) {
    const det = document.createElement('details');
    det.className = 'path';
    const verbs = Object.keys(ops).map(v =>
      '<span class="verb ' + v + '">' + v.toUpperCase() + '</span>').join('');
    det.innerHTML = '<summary>' + verbs + ' ' + path + '</summary>';
    for (const [verb, op] of Object.entries(ops)) {
      const d = document.createElement('div');
      d.className = 'op';
      d.innerHTML = '<span class="verb ' + verb + '">' + verb.toUpperCase() +
        '</span><span class="summary">' + (op.summary || '') + '</span>';
      if (verb === 'get') {
        const params = [...path.matchAll(/{([^}]+)}/g)].map(m => m[1]);
        const form = document.createElement('div');
        form.className = 'try';
        form.innerHTML = params.map(p =>
          '<input placeholder="' + p + '" data-p="' + p + '">').join('') +
          '<button>try it</button><pre class="result" hidden></pre>';
        form.querySelector('button').onclick = async () => {
          let url = path;
          form.querySelectorAll('input').forEach(i => {
            url = url.replace('{' + i.dataset.p + '}',
                              encodeURIComponent(i.value || 'default'));
          });
          const out = form.querySelector('pre');
          out.hidden = false;
          out.textContent = 'GET ' + url + ' …';
          try {
            const r = await fetch(url);
            const text = await r.text();
            let body = text;
            try { body = JSON.stringify(JSON.parse(text), null, 1); }
            catch (e) {}
            out.textContent = 'HTTP ' + r.status + '\\n' + body;
          } catch (e) { out.textContent = String(e); }
        };
        d.appendChild(form);
      }
      det.appendChild(d);
    }
    root.appendChild(det);
  }
})();
</script></body></html>
"""


#: The live dashboard: a self-contained single-page app (no external
#: assets — this box has zero egress, and the reference vendors its
#: AngularJS app into pkg/ui/datafile.go for the same reason). Hash
#: routing gives per-resource views; every view polls the REST API and
#: re-renders, so the page tracks the cluster live.
_UI_PAGE = """<!doctype html>
<html><head><title>kubernetes-tpu</title>
<meta charset="utf-8">
<style>
 body { font-family: -apple-system, 'Segoe UI', sans-serif; margin: 0;
        background: #f6f8fa; color: #1f2328; }
 header { background: #1b1f24; color: #eee; padding: 10px 18px;
          display: flex; align-items: baseline; gap: 16px; }
 header h1 { font-size: 1.05em; margin: 0; font-weight: 600; }
 header a { color: #9cc4ff; text-decoration: none; font-size: .85em; }
 nav { background: #fff; border-bottom: 1px solid #d8dee4;
       padding: 6px 18px; display: flex; flex-wrap: wrap; gap: 4px; }
 nav a { padding: 4px 10px; border-radius: 6px; text-decoration: none;
         color: #1f2328; font-size: .9em; }
 nav a.active { background: #0969da; color: #fff; }
 nav a:hover:not(.active) { background: #eaeef2; }
 main { padding: 16px 18px; }
 table { border-collapse: collapse; background: #fff; width: 100%;
         box-shadow: 0 1px 2px rgba(0,0,0,.06); }
 th { text-align: left; font-size: .78em; text-transform: uppercase;
      letter-spacing: .04em; color: #57606a; }
 td, th { border-bottom: 1px solid #e6e9ec; padding: 7px 12px;
          font-size: .9em; }
 tr:hover td { background: #f6f8fa; }
 .pill { display: inline-block; padding: 1px 9px; border-radius: 10px;
         font-size: .82em; background: #eaeef2; }
 .ok  { background: #dafbe1; color: #116329; }
 .bad { background: #ffebe9; color: #a40e26; }
 .warn{ background: #fff8c5; color: #7d4e00; }
 .cards { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 16px; }
 .card { background: #fff; border: 1px solid #d8dee4; border-radius: 8px;
         padding: 10px 16px; min-width: 110px; cursor: pointer; }
 .card b { display: block; font-size: 1.5em; }
 .card span { color: #57606a; font-size: .82em; }
 .muted { color: #57606a; font-size: .85em; }
 select { margin-left: auto; }
 pre { background: #fff; border: 1px solid #d8dee4; padding: 10px;
       overflow-x: auto; font-size: .85em; }
</style></head>
<body>
<header><h1>kubernetes-tpu</h1>
 <span id=status class=muted></span>
 <a href="/swagger-ui/">api</a> <a href="/metrics">metrics</a>
 <a href="/healthz">healthz</a> <a href="/debug/requests">requests</a>
 <select id=nsSel title=namespace></select>
</header>
<nav id=nav></nav>
<main id=main>loading…</main>
<script>
const RESOURCES = {
 pods: {cols: ['name','phase','node','ready','restarts','age'],
  row: p => [name(p), pill(p.status&&p.status.phase), (p.spec||{}).nodeName||'',
   ready(p), restarts(p), age(p)]},
 nodes: {ns: false, cols: ['name','status','cpu','memory','pods','age'],
  row: n => {const c=(n.status||{}).capacity||{};
   return [name(n), nodeReady(n), c.cpu||'', c.memory||'', c.pods||'', age(n)];}},
 services: {cols: ['name','type','cluster-ip','ports','selector','age'],
  row: s => {const sp=s.spec||{};
   return [name(s), sp.type||'ClusterIP', sp.clusterIP||'',
    (sp.ports||[]).map(p=>p.port+(p.nodePort?':'+p.nodePort:'')+'/'+(p.protocol||'TCP')).join(', '),
    kv(sp.selector), age(s)];}},
 replicationcontrollers: {cols: ['name','desired','current','selector','age'],
  row: r => [name(r), (r.spec||{}).replicas||0, (r.status||{}).replicas||0,
   kv((r.spec||{}).selector), age(r)]},
 endpoints: {cols: ['name','endpoints','age'],
  row: e => [name(e), (e.subsets||[]).map(s =>
   (s.addresses||[]).map(a=>a.ip).join(',')+':'+ (s.ports||[]).map(p=>p.port).join(',')
  ).join(' | ') || '<none>', age(e)]},
 events: {cols: ['last seen','count','reason','object','message'],
  row: e => [e.lastTimestamp||e.firstTimestamp||'', e.count||1,
   pill(e.reason, /fail|unhealthy|kill/i.test(e.reason||'')?'bad':''),
   ((e.involvedObject||{}).kind||'')+'/'+((e.involvedObject||{}).name||''),
   e.message||'']},
 namespaces: {ns: false, cols: ['name','phase','age'],
  row: n => [name(n), pill((n.status||{}).phase), age(n)]},
 secrets: {cols: ['name','type','keys','age'],
  row: s => [name(s), s.type||'Opaque', Object.keys(s.data||{}).join(', '), age(s)]},
 serviceaccounts: {cols: ['name','secrets','age'],
  row: s => [name(s), (s.secrets||[]).map(x=>x.name).join(', '), age(s)]},
 resourcequotas: {cols: ['name','hard','used','age'],
  row: r => [name(r), kv((r.spec||{}).hard), kv((r.status||{}).used), age(r)]},
 limitranges: {cols: ['name','age'], row: l => [name(l), age(l)]},
 persistentvolumes: {ns: false, cols: ['name','capacity','phase','claim','age'],
  row: v => [name(v), kv((v.spec||{}).capacity), pill((v.status||{}).phase),
   (((v.spec||{}).claimRef)||{}).name||'', age(v)]},
 persistentvolumeclaims: {cols: ['name','phase','volume','age'],
  row: c => [name(c), pill((c.status||{}).phase), (c.spec||{}).volumeName||'', age(c)]},
 podgroups: {cols: ['name','min-member','phase','bound','age'],
  row: g => [name(g), ((g.spec||{}).minMember)||1,
   pill((g.status||{}).phase||'Pending'),
   ((g.status||{}).bound||0)+'/'+((g.status||{}).members||0), age(g)]},
 podtemplates: {cols: ['name','containers','age'],
  row: t => [name(t), (((t.template||{}).spec||{}).containers||[])
   .map(c=>c.name).join(', '), age(t)]},
 priorityclasses: {ns: false,
  cols: ['name','value','global-default','preemption-policy','age'],
  row: c => [name(c), c.value||0, String(!!c.globalDefault),
   c.preemptionPolicy||'PreemptLowerPriority', age(c)]},
 componentstatuses: {ns: false, cols: ['name','status','message'],
  row: c => {const cond=(c.conditions||[{}])[0];
   return [name(c), pill(cond.status==='True'?'Healthy':'Unhealthy',
    cond.status==='True'?'ok':'bad'), cond.message||''];}},
};
const esc = s => String(s==null?'':s).replace(/[&<>"]/g,
 c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c]));
// Escaping happens EXACTLY ONCE, at the table sink: row builders
// return plain strings (escaped there), or {h: html} for trusted
// markup whose dynamic parts were esc()'d at construction (pill).
const name = o => (o.metadata||{}).name||'';
const kv = m => Object.entries(m||{}).map(([k,v])=>k+'='+v).join(',');
const pill = (txt, cls) => txt ? {h: '<span class="pill '+(cls||
 (/running|active|true|bound|healthy|normal|scheduled/i.test(txt)?'ok':
  /fail|error|unhealthy|lost|terminat/i.test(txt)?'bad':
  /pending/i.test(txt)?'warn':''))+'">'+esc(txt)+'</span>'} : '';
function age(o){const t=(o.metadata||{}).creationTimestamp; if(!t) return '';
 const s=Math.max(0,(Date.now()-Date.parse(t))/1000)|0;
 return s<120?s+'s':s<7200?(s/60|0)+'m':s<172800?(s/3600|0)+'h':(s/86400|0)+'d';}
function ready(p){const cs=(p.status||{}).containerStatuses||[];
 return cs.filter(c=>c.ready).length+'/'+((p.spec||{}).containers||[]).length;}
function restarts(p){return ((p.status||{}).containerStatuses||[])
 .reduce((a,c)=>a+(c.restartCount||0),0);}
function nodeReady(n){const c=((n.status||{}).conditions||[])
 .find(x=>x.type==='Ready'); const un=(n.spec||{}).unschedulable;
 let txt=c&&c.status==='True'?'Ready':'NotReady';
 if(un) txt+=',Unschedulable';
 return pill(txt, txt==='Ready'?'ok':'bad');}
let NS='default';
async function getJSON(u){
 // Bounded: a blackholed request must fail fast, or the no-overlap
 // render gate would freeze polling until the browser's own timeout.
 const r=await fetch(u, {signal: AbortSignal.timeout(4000)});
 if(!r.ok) throw new Error(r.status);
 return r.json();}
const listPath=(res)=> (RESOURCES[res]&&RESOURCES[res].ns===false)
 ? '/api/v1/'+res : '/api/v1/namespaces/'+encodeURIComponent(NS)+'/'+res;
function route(){return location.hash.replace(/^#\\/?/, '')||'overview';}
function nav(){const cur=route();
 document.getElementById('nav').innerHTML =
  ['overview', ...Object.keys(RESOURCES)].map(r =>
   '<a href="#/'+r+'" class="'+(r===cur?'active':'')+'">'+r+'</a>').join('');}
async function refreshNamespaces(){
 try{const d=await getJSON('/api/v1/namespaces');
  const names=(d.items||[]).map(n=>name(n)).filter(Boolean);
  if(!names.includes(NS)) names.push(NS);
  const sel=document.getElementById('nsSel');
  // Compare the OPTION VALUES, not innerHTML (browsers normalize
  // serialized markup, so a string compare would rebuild — and close
  // an open dropdown — on every tick).
  const have=[...sel.options].map(o=>o.value).join('\\u0000');
  if(have!==names.join('\\u0000')){
   sel.innerHTML=names.map(n=>'<option>'+esc(n)+'</option>').join('');}
  sel.value=NS;
 }catch(e){}}
async function renderOverview(){
 const lists=await Promise.all(Object.keys(RESOURCES).map(async r=>{
  try{const d=await getJSON(listPath(r)); return [r, d.items||[]];}
  catch(e){return [r, null];}}));
 let html='<div class=cards>'+lists.map(([r,items]) =>
  '<div class=card onclick="location.hash=\\'#/'+r+'\\'"><b>'+
  (items===null?'?':items.length)+'</b><span>'+r+'</span></div>').join('')+'</div>';
 const ev=lists.find(([r])=>r==='events');
 if(ev && ev[1]!==null){
  html+='<h3>recent events</h3>'+tableFor('events', ev[1].slice(-12).reverse());}
 return html;}
function tableFor(res, items){const def=RESOURCES[res];
 const cell=v => (v&&v.h) ? v.h : esc(String(v));
 return '<table><tr>'+def.cols.map(c=>'<th>'+esc(c)+'</th>').join('')+'</tr>'+
  items.map(o=>'<tr>'+def.row(o).map(v=>'<td>'+cell(v)+'</td>').join('')+'</tr>').join('')+
  '</table>';}
let renderGen=0, rendering=false, lastOverview=0;
async function render(force){nav(); refreshNamespaces();
 const cur=route();
 // Be a polite API client: never overlap request rounds, and poll the
 // request-heavy overview (one list per resource kind) at 6s instead
 // of 2s so a parked tab can't crowd the max-in-flight budget.
 if(rendering && !force) return;
 if(cur==='overview' && !force && Date.now()-lastOverview < 5500) return;
 rendering=true;
 const gen=++renderGen;
 const main=document.getElementById('main');
 try{
  let html;
  if(cur==='overview'){html=await renderOverview();}
  else if(RESOURCES[cur]){const d=await getJSON(listPath(cur));
   const items=d.items||[];
   html='<p class=muted>'+items.length+' object(s)'+
    (RESOURCES[cur].ns===false?'':' in namespace '+esc(NS))+
    ' &middot; <a href="'+listPath(cur)+'">raw json</a></p>'+
    tableFor(cur, items);}
  else {html='unknown view '+esc(cur);}
  // A slower, earlier render must never paint over a newer one
  // (hashchange + the 2s tick can overlap via force).
  if(gen!==renderGen) return;
  if(cur==='overview') lastOverview=Date.now();
  main.innerHTML=html;
  document.getElementById('status').textContent='live · '+new Date().toLocaleTimeString();
 }catch(e){if(gen===renderGen)
  document.getElementById('status').textContent='api error: '+e;}
 finally{if(gen===renderGen) rendering=false;}
}
document.getElementById('nsSel').addEventListener('change', e=>{
 NS=e.target.value; render(true);});
window.addEventListener('hashchange', ()=>render(true));
render(true); setInterval(()=>render(false), 2000);
</script>
</body></html>"""


class _TLSCapableServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that TLS-wraps each accepted connection with
    do_handshake_on_connect=False: the handshake then happens on the
    handler thread's first read, so a client that stalls mid-handshake
    ties up one daemon thread instead of the accept loop.

    Accepted sockets are tracked (weakly) so close_connections() can
    sever live keep-alive sessions on shutdown: a process restart
    resets every TCP connection, and an in-process restart (tests, the
    HTTP-tier-only restart path) must behave the same — otherwise a
    successor on the same port coexists with the predecessor's handler
    threads still serving stale keep-alive clients."""

    ssl_context = None

    def __init__(self, *args, **kwargs):
        import weakref

        super().__init__(*args, **kwargs)
        self._conns: "weakref.WeakSet" = weakref.WeakSet()
        self._conns_lock = threading.Lock()

    def get_request(self):
        sock, addr = self.socket.accept()
        if self.ssl_context is not None:
            sock = self.ssl_context.wrap_socket(
                sock, server_side=True, do_handshake_on_connect=False
            )
        with self._conns_lock:
            self._conns.add(sock)
        return sock, addr

    def close_connections(self) -> None:
        import socket as _socket

        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass


class APIHTTPServer:
    """Owns the listening socket + serving thread."""

    def __init__(
        self,
        api: APIServer,
        host: str = "127.0.0.1",
        port: int = 0,
        authenticator=None,
        authorizer=None,
        publish_master: bool = False,
        max_in_flight: int = 0,
        tls_cert_file: str = "",
        tls_key_file: str = "",
        client_ca_file: str = "",
    ):
        # publish_master: create/reconcile the "kubernetes" service +
        # endpoints on start (pkg/master/publish.go). Off by default so
        # unit fixtures see only the objects they create; the daemon
        # launchers turn it on.
        # max_in_flight: cap on concurrently-served non-long-running
        # API requests; excess get 429 (pkg/apiserver/handlers.go).
        # 0 = unlimited (unit-test default; the daemon passes 400 like
        # the reference's --max-requests-inflight).
        self._publish_master = publish_master
        handler = type(
            "BoundHandler",
            (_Handler,),
            {
                "api": api,
                "authenticator": authenticator,
                "authorizer": authorizer,
                "inflight": (
                    threading.BoundedSemaphore(max_in_flight)
                    if max_in_flight > 0
                    else None
                ),
            },
        )
        self.httpd = _TLSCapableServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.api = api
        self._thread: Optional[threading.Thread] = None
        # TLS + x509 client-cert authn (--tls-cert-file /
        # --tls-private-key-file / --client-ca-file; reference:
        # cmd/kube-apiserver/app/server.go secure serving +
        # pkg/apiserver/authn.go x509). CERT_OPTIONAL: clients without
        # certs still reach basic/token auth; clients WITH certs must
        # chain to the CA or the handshake fails. Sockets are wrapped
        # PER CONNECTION with a deferred handshake so a stalled client
        # blocks only its own handler thread, never the accept loop.
        self._tls = False
        if tls_cert_file and tls_key_file:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert_file, tls_key_file)
            if client_ca_file:
                ctx.load_verify_locations(client_ca_file)
                ctx.verify_mode = ssl.CERT_OPTIONAL
            self.httpd.ssl_context = ctx
            self._tls = True

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    def start(self) -> "APIHTTPServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1}, daemon=True
        )
        self._thread.start()
        if self._publish_master:
            host, port = self.httpd.server_address[:2]
            if host in ("0.0.0.0", "::", ""):
                # A wildcard bind is not a routable endpoint address;
                # publish a real interface IP (the reference resolves a
                # public address the same way before publishing).
                import socket as _socket

                try:
                    with _socket.socket(
                        _socket.AF_INET, _socket.SOCK_DGRAM
                    ) as probe:
                        # UDP connect only records the peer addr;
                        # it cannot block.  # ktlint: disable=KT004
                        probe.connect(("10.255.255.255", 1))
                        host = probe.getsockname()[0]
                except OSError:
                    host = "127.0.0.1"
            self.api.publish_master_service(host, port)
        return self

    def stop(self, release_store: bool = True) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        # Sever live keep-alive connections: a dead server must not
        # keep answering old clients through lingering handler threads
        # (a successor may be about to bind the same port).
        self.httpd.close_connections()
        if self._thread:
            self._thread.join(timeout=5)
        # Release the store (WAL handle + data-dir flock): a stopped
        # apiserver must let a successor open the same --data-dir.
        # release_store=False keeps it live for callers that hand the
        # SAME APIServer to a replacement front-end (HTTP-tier-only
        # restart; the store outlives the listener like etcd outlives
        # the reference apiserver).
        if release_store:
            self.api.store.close()
