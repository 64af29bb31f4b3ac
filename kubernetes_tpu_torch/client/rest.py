"""Typed REST client over a pluggable transport.

A copy of the part of `kubernetes_tpu/client/rest.py` the scheduler
daemon runs (reference: pkg/client/client.go + request.go):

- `LocalTransport` calls an in-process object that has the apiserver's
  method names (`list`, `get`, `create`, `watch`, `bind_bulk`, ...)
  directly. It is duck-typed: the port's `server.api.APIServer`, or in
  the tests the JAX package's. An error that carries `code`, `reason`
  and `message` is raised again as the port's `APIError`.
- `HTTPTransport` speaks the apiserver's HTTP wire to one endpoint or a
  list of them (the replicated control plane's apiservers): the active
  trace's id in the `X-Trace-Id` header of each request, one keep-alive
  connection a thread, a free replay when a reused connection proves
  stale, bounded retries of idempotent verbs on connection failures and
  502/503/504, each retry rotating to the next endpoint (a POST is
  never replayed, so it fails on a dead endpoint and rotates nothing),
  and the watch as a stream of newline-delimited JSON frames read by a
  thread of its own, its dial rotating through the endpoints once.
- `Client` types objects through `models/serde.py` and records events
  through `client/record.py`. `list_wire`, `get_wire` and
  `update_status_wire` return the apiserver's dicts as they come, for a
  caller that must carry every field of a stored object (the
  descheduler's moves, the kubelet's node).

A watch yields `Event`s (`.type`, `.object` as a wire dict, `.version`),
the shape of `kubernetes_tpu/store/watch.py`'s.
"""

from __future__ import annotations

import http.client
import json
import queue
import random
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlencode, urlparse

from kubernetes_tpu_torch.models import apiobjects, serde
from kubernetes_tpu_torch.models.objects import Event as EventObject
from kubernetes_tpu_torch.models.objects import (
    Endpoints,
    Node,
    Pod,
    PodGroup,
    PodTemplate,
    Service,
)
from kubernetes_tpu_torch.utils import tracing

# Watch event types (reference: pkg/watch Event{Added,Modified,Deleted,Error}).
ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
ERROR = "ERROR"


@dataclass
class Event:
    """One watch event: `object` is the wire dict, `version` its
    resourceVersion."""

    type: str
    object: Any
    version: int = 0


class APIError(Exception):
    """An apiserver error status (code, reason, message)."""

    def __init__(self, code: int, reason: str, message: str):
        self.code = code
        self.reason = reason
        self.message = message
        super().__init__(message)


@dataclass(frozen=True)
class Resource:
    name: str  # plural REST name
    cls: type
    namespaced: bool = True


#: The resources the daemons and the controllers read and write. Pods
#: and nodes are typed with the trimmed `models/objects.py`, whose decode
#: the scheduler's ticks pay for; the kinds only the controllers read
#: are typed with the whole model, `models/apiobjects.py`. A controller
#: that needs a pod's or a node's other fields decodes the wire form
#: with `models/apiobjects.py` itself (its `Informer`'s `decode`).
RESOURCES: Dict[str, Resource] = {
    "pods": Resource("pods", Pod),
    "podtemplates": Resource("podtemplates", PodTemplate),
    "nodes": Resource("nodes", Node, namespaced=False),
    "services": Resource("services", Service),
    "podgroups": Resource("podgroups", PodGroup),
    "events": Resource("events", EventObject),
    # Leader election's lock and the fencing lease (utils/leaderelect.py,
    # utils/lease.py).
    "endpoints": Resource("endpoints", Endpoints),
    "replicationcontrollers": Resource("replicationcontrollers",
                                       apiobjects.ReplicationController),
    "namespaces": Resource("namespaces", apiobjects.Namespace, namespaced=False),
    "resourcequotas": Resource("resourcequotas", apiobjects.ResourceQuota),
    "serviceaccounts": Resource("serviceaccounts", apiobjects.ServiceAccount),
    "secrets": Resource("secrets", apiobjects.Secret),
    "persistentvolumes": Resource("persistentvolumes", apiobjects.PersistentVolume,
                                  namespaced=False),
    "persistentvolumeclaims": Resource("persistentvolumeclaims",
                                       apiobjects.PersistentVolumeClaim),
    "limitranges": Resource("limitranges", apiobjects.LimitRange),
}

#: Failures that mean a pooled keep-alive connection went stale.
_STALE_ERRORS = (
    http.client.BadStatusLine,
    http.client.CannotSendRequest,
    ConnectionError,
    BrokenPipeError,
)

#: Verbs replayed when a reused connection dies before any response
#: byte; a POST is never replayed (the server may have applied it).
_IDEMPOTENT_VERBS = frozenset({"GET", "HEAD", "PUT", "DELETE"})

#: Statuses that mean "transiently unavailable": retried on idempotent verbs.
_TRANSIENT_5XX = frozenset({502, 503, 504})

_RETRY_RNG = random.Random(0x5EED)


class _ReplayStale(Exception):
    """A reused keep-alive connection went stale before the request
    reached a live server: replay on a fresh connection, free."""


class UnknownOutcomeError(ConnectionError):
    """A non-idempotent request's connection died after send, before any
    response byte: the server may or may not have applied it."""

    def __init__(self, verb: str, path: str):
        super().__init__(f"{verb} {path}: connection lost before response; outcome unknown")
        self.verb = verb
        self.path = path


class Transport:
    def request(self, verb: str, op: str, args: tuple, body=None, patch_type=None):
        raise NotImplementedError

    def watch(self, resource: str, namespace: str, since: int, lsel: str, fsel: str):
        raise NotImplementedError


def _as_api_error(e: Exception) -> Optional[APIError]:
    """A foreign apiserver error (anything with an int `code` and a
    `reason`) as the port's APIError, else None."""
    code = getattr(e, "code", None)
    if isinstance(code, int) and hasattr(e, "reason"):
        return APIError(code, e.reason, getattr(e, "message", str(e)))
    return None


class LocalTransport(Transport):
    """Direct calls into an in-process apiserver object."""

    def __init__(self, api):
        self.api = api

    def request(self, verb, op, args, body=None, patch_type=None):
        fn = getattr(self.api, op)
        try:
            if patch_type is not None:
                return fn(*args, body, patch_type=patch_type)
            if body is not None:
                return fn(*args, body)
            return fn(*args)
        except APIError:
            raise
        except Exception as e:
            err = _as_api_error(e)
            if err is None:
                raise
            raise err from e

    def watch(self, resource, namespace, since, lsel, fsel):
        try:
            return self.api.watch(resource, namespace, since=since, label_selector=lsel,
                                  field_selector=fsel)
        except APIError:
            raise
        except Exception as e:
            err = _as_api_error(e)
            if err is None:
                raise
            raise err from e


class _HTTPWatchStream:
    """Chunked watch frames from an HTTP response. A reader thread does
    the blocking readline()s and feeds a queue, so next(timeout) never
    sets a socket timeout that could cut a frame in half."""

    def __init__(self, conn: http.client.HTTPConnection, resp):
        self._conn = conn
        self._resp = resp
        self._closed = False
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self) -> None:
        try:
            while True:
                line = self._resp.readline()
                if not line:
                    break
                try:
                    frame = json.loads(line)
                except json.JSONDecodeError:
                    break  # corrupt frame: drop the watch, the caller re-lists
                obj = frame.get("object", {})
                version = int(obj.get("metadata", {}).get("resourceVersion", "0") or "0")
                self._q.put(Event(frame.get("type", ERROR), obj, version))
        except OSError:
            pass
        finally:
            self._closed = True
            try:
                self._conn.close()
            except Exception:
                pass
            self._q.put(None)

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        if self._closed and self._q.empty():
            return None
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            # Shut the raw socket to unblock the reader, which then
            # closes the connection itself (conn.close() here would
            # wait on the lock its blocked readline() holds).
            try:
                if self._conn.sock is not None:
                    self._conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    @property
    def closed(self) -> bool:
        return self._closed


class HTTPTransport(Transport):
    """HTTP to one apiserver endpoint, or to a list of them. Requests pin
    to one endpoint until a retry of a transient failure rotates to the
    next; the rotation bumps a generation that makes every thread's
    pooled connection dial the new endpoint."""

    def __init__(self, base_url, timeout: float = 30.0, max_retries: int = 3):
        urls = [base_url] if isinstance(base_url, str) else list(base_url)
        if not urls:
            raise ValueError("HTTPTransport needs at least one endpoint")
        self.endpoints: List[Tuple[str, int]] = []
        for raw in urls:
            u = urlparse(raw)
            if u.scheme not in ("", "http"):
                raise ValueError(f"HTTPTransport speaks plain http, not {u.scheme!r}")
            self.endpoints.append((u.hostname or "127.0.0.1", u.port or 80))
        self._ep_lock = threading.Lock()
        self._ep_idx = 0
        self._ep_gen = 0
        self.timeout = timeout
        self.max_retries = max_retries
        self._local = threading.local()  # one keep-alive connection a thread

    @property
    def host(self) -> str:
        return self.endpoints[self._ep_idx][0]

    @property
    def port(self) -> int:
        return self.endpoints[self._ep_idx][1]

    def _rotate(self) -> None:
        """Advance to the next endpoint (with one, only the pool discard)
        and invalidate every thread's pooled connection."""
        with self._ep_lock:
            if len(self.endpoints) > 1:
                self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)
            self._ep_gen += 1
        self._discard()

    def _connect(self, timeout=None) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=timeout)
        conn.connect()
        try:
            # Nagle with delayed ACKs stalls keep-alive round trips.
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        return conn

    def _pooled(self) -> Tuple[http.client.HTTPConnection, bool]:
        """(this thread's connection, whether it was reused); one dialed
        before the last rotation is closed and dialed again."""
        gen = self._ep_gen
        conn = getattr(self._local, "conn", None)
        if conn is not None and getattr(self._local, "gen", -1) == gen:
            return conn, True
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
        conn = self._local.conn = self._connect(timeout=self.timeout)
        self._local.gen = gen
        return conn, False

    def _discard(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    @staticmethod
    def _collection_path(resource: str, namespace: str) -> str:
        info = RESOURCES[resource]
        if info.namespaced and namespace:
            return f"/api/v1/namespaces/{namespace}/{info.name}"
        return f"/api/v1/{info.name}"

    def _do(self, verb: str, path: str, query: Optional[dict] = None, body=None,
            content_type: str = "application/json", raw: bool = False):
        """One request over the thread's keep-alive connection, the
        JSON-decoded body back (`raw`: the body's text, a pod's log). Connection failures and 502/503/504
        retry idempotent verbs up to max_retries times with capped,
        jittered backoff; a POST whose connection died after send
        raises UnknownOutcomeError."""
        if query:
            path = path + "?" + urlencode({k: v for k, v in query.items() if v})
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": content_type} if payload else {}
        # Dapper hop: the apiserver records its handling of this request
        # under the active trace's id.
        tid = tracing.current_trace_id()
        if tid:
            headers[tracing.TRACE_HEADER] = tid
        attempts = 0
        while True:
            try:
                return self._attempt(verb, path, payload, headers, raw)
            except _ReplayStale:
                continue
            except APIError as e:
                if (e.code in _TRANSIENT_5XX and verb in _IDEMPOTENT_VERBS
                        and attempts < self.max_retries):
                    attempts += 1
                    self._rotate()  # this endpoint answered but is sick
                    self._retry_backoff(attempts)
                    continue
                raise
            except _STALE_ERRORS:
                if verb in _IDEMPOTENT_VERBS and attempts < self.max_retries:
                    attempts += 1
                    self._rotate()
                    self._retry_backoff(attempts)
                    continue
                raise

    @staticmethod
    def _retry_backoff(attempt: int) -> None:
        delay = min(0.05 * (2 ** (attempt - 1)), 1.0)
        time.sleep(delay * (0.5 + 0.5 * _RETRY_RNG.random()))

    def _attempt(self, verb, path, payload, headers, raw=False):
        conn, reused = self._pooled()
        try:
            conn.request(verb, path, body=payload, headers=headers)
        except _STALE_ERRORS:
            self._discard()
            if reused:
                raise _ReplayStale()  # the request never left: any verb
            raise
        except Exception:
            self._discard()
            raise
        try:
            resp = conn.getresponse()
            raw_body = resp.read()
        except http.client.RemoteDisconnected as e:
            self._discard()
            if reused and verb in _IDEMPOTENT_VERBS:
                raise _ReplayStale()
            if reused:
                raise UnknownOutcomeError(verb, path) from e
            raise
        except _STALE_ERRORS:
            self._discard()
            if reused and verb == "GET":
                raise _ReplayStale()
            raise
        except Exception:
            self._discard()
            raise
        if resp.will_close:
            self._discard()
        if resp.status >= 400:
            try:
                data = json.loads(raw_body or b"{}")
            except json.JSONDecodeError:
                data = {}
            raise APIError(data.get("code", resp.status), data.get("reason", "Unknown"),
                           data.get("message", f"HTTP {resp.status}"))
        if raw:
            return raw_body.decode(errors="replace")
        return json.loads(raw_body or b"{}")

    def request(self, verb, op, args, body=None, patch_type=None):
        if op == "create":
            resource, namespace = args
            return self._do("POST", self._collection_path(resource, namespace), body=body)
        if op == "get":
            resource, namespace, name = args
            return self._do("GET", self._collection_path(resource, namespace) + f"/{name}")
        if op == "list":
            resource, namespace, lsel, fsel = args
            return self._do("GET", self._collection_path(resource, namespace),
                            query={"labelSelector": lsel, "fieldSelector": fsel})
        if op == "update":
            resource, namespace, name = args
            return self._do("PUT", self._collection_path(resource, namespace) + f"/{name}",
                            body=body)
        if op == "update_status":
            resource, namespace, name = args
            return self._do("PUT", self._collection_path(resource, namespace) + f"/{name}/status",
                            body=body)
        if op == "finalize_namespace":
            (name,) = args
            return self._do("PUT", f"/api/v1/namespaces/{name}/finalize", body=body)
        if op == "delete":
            resource, namespace, name = args[:3]
            grace = args[3] if len(args) > 3 else None
            return self._do("DELETE", self._collection_path(resource, namespace) + f"/{name}",
                            query={"gracePeriodSeconds": str(int(grace))} if grace is not None
                            else None)
        if op == "evict_pod":
            namespace, name = args
            return self._do("POST", self._collection_path("pods", namespace or "default")
                            + f"/{name}/eviction", body=body)
        if op == "patch":
            resource, namespace, name = args
            return self._do("PATCH", self._collection_path(resource, namespace) + f"/{name}",
                            body=body, content_type="application/merge-patch+json")
        if op == "bind":
            (namespace,) = args
            return self._do("POST", f"/api/v1/namespaces/{namespace or 'default'}/bindings",
                            body=body)
        if op == "bind_bulk":
            (namespace,) = args
            return self._do("POST", f"/api/v1/namespaces/{namespace or 'default'}/bulkbindings",
                            body=body)
        if op == "create_events_bulk":
            (namespace,) = args
            return self._do("POST", f"/api/v1/namespaces/{namespace or 'default'}/bulkevents",
                            body=body)
        if op == "create_bulk":
            resource, namespace = args
            return self._do("POST", self._collection_path(resource, namespace) + ":bulk",
                            body={"items": body})
        if op == "pod_log":
            namespace, name, container, tail = args
            return self._do("GET", f"/api/v1/namespaces/{namespace or 'default'}/pods/{name}/log",
                            query={"container": container,
                                   "tailLines": str(tail) if tail is not None else ""},
                            raw=True)
        raise ValueError(f"unknown op {op!r}")

    def watch(self, resource, namespace, since, lsel, fsel):
        info = RESOURCES[resource]
        if info.namespaced and namespace:
            path = f"/api/v1/watch/namespaces/{namespace}/{info.name}"
        else:
            path = f"/api/v1/watch/{info.name}"
        query = urlencode({k: v for k, v in {
            "resourceVersion": str(since) if since else "",
            "labelSelector": lsel,
            "fieldSelector": fsel,
        }.items() if v})
        if query:
            path += "?" + query
        # Bound the dial and the response headers, then clear the socket
        # timeout: a watch is long-lived and may be silent for minutes. A
        # failed dial rotates through the other endpoints once; the
        # Reflector resumes the watch on the one it lands on.
        last_exc = None
        for _ in range(len(self.endpoints)):
            try:
                conn = self._connect(timeout=self.timeout)
                conn.request("GET", path)
                resp = conn.getresponse()
                break
            except _STALE_ERRORS as e:
                last_exc = e
                self._rotate()
        else:
            raise last_exc
        if resp.status >= 400:
            data = json.loads(resp.read() or b"{}")
            conn.close()
            raise APIError(data.get("code", resp.status), data.get("reason", "Unknown"),
                           data.get("message", f"HTTP {resp.status}"))
        if conn.sock is not None:
            conn.sock.settimeout(None)
        return _HTTPWatchStream(conn, resp)


class Client:
    """Typed client over a Transport. The JAX client's optional QPS
    throttle is not carried: the daemon never throttles its requests."""

    def __init__(self, transport: Transport):
        self.t = transport
        self._recorder_lock = threading.Lock()
        self._broadcaster = None
        self._recorders: dict = {}

    @staticmethod
    def _typed(resource: str, wire: dict):
        return serde.from_wire(RESOURCES[resource].cls, wire)

    @staticmethod
    def _wire(obj) -> dict:
        return obj if isinstance(obj, dict) else serde.to_wire(obj)

    @staticmethod
    def _results(out) -> list:
        return out.get("results", []) if isinstance(out, dict) else out

    def create(self, resource: str, obj, namespace: str = ""):
        return self._typed(resource, self.t.request("POST", "create", (resource, namespace),
                                                    self._wire(obj)))

    def get(self, resource: str, name: str, namespace: str = ""):
        return self._typed(resource, self.get_wire(resource, name, namespace))

    def get_wire(self, resource: str, name: str, namespace: str = "") -> dict:
        """The object as the apiserver returns it."""
        return self.t.request("GET", "get", (resource, namespace, name))

    def list(self, resource: str, namespace: str = "", label_selector: str = "",
             field_selector: str = "") -> Tuple[List[Any], int]:
        """(typed items, the list's resourceVersion)."""
        items, version = self.list_wire(resource, namespace, label_selector, field_selector)
        return [self._typed(resource, o) for o in items], version

    def list_wire(self, resource: str, namespace: str = "", label_selector: str = "",
                  field_selector: str = "") -> Tuple[List[dict], int]:
        """(the items as the apiserver returns them, the list's
        resourceVersion). Over a LocalTransport they may be the server's
        own dicts: copy before changing one."""
        out = self.t.request("GET", "list", (resource, namespace, label_selector, field_selector))
        version = int(out.get("metadata", {}).get("resourceVersion", "0") or "0")
        return out.get("items", []), version

    def update(self, resource: str, obj, namespace: str = ""):
        wire = self._wire(obj)
        name = wire.get("metadata", {}).get("name", "")
        return self._typed(resource, self.t.request("PUT", "update", (resource, namespace, name),
                                                    wire))

    def update_status(self, resource: str, obj, namespace: str = ""):
        """PUT the status subresource: the stored spec is kept."""
        return self._typed(resource, self.update_status_wire(resource, obj, namespace))

    def update_status_wire(self, resource: str, obj, namespace: str = "") -> dict:
        """`update_status`, the stored object returned as the apiserver
        sends it (the kubelet's heartbeat keeps the node whole)."""
        wire = self._wire(obj)
        name = wire.get("metadata", {}).get("name", "")
        return self.t.request("PUT", "update_status", (resource, namespace, name), wire)

    def finalize_namespace(self, name: str, finalizers) -> None:
        """PUT the namespace's `finalize` subresource with these finalizers."""
        self.t.request("PUT", "finalize_namespace", (name,),
                       {"kind": "Namespace", "metadata": {"name": name},
                        "spec": {"finalizers": list(finalizers)}})

    def delete(self, resource: str, name: str, namespace: str = "",
               grace_period_seconds: Optional[int] = None) -> None:
        """Delete; a grace over 0 on a bound pod marks it Terminating
        instead (its kubelet confirms at the deadline). None or 0
        deletes at once."""
        args = (resource, namespace, name)
        if grace_period_seconds is not None:
            args = args + (grace_period_seconds,)
        self.t.request("DELETE", "delete", args)

    def evict(self, name: str, namespace: str = "default",
              grace_period_seconds: Optional[int] = None):
        """POST the pods/{name}/eviction subresource: a graceful delete
        (the preemption pass's victim exit)."""
        opts = {}
        if grace_period_seconds is not None:
            opts["gracePeriodSeconds"] = int(grace_period_seconds)
        body = {"kind": "Eviction", "apiVersion": "v1",
                "metadata": {"name": name, "namespace": namespace}, "deleteOptions": opts}
        return self.t.request("POST", "evict_pod", (namespace, name), body)

    def patch(self, resource: str, name: str, patch: dict, namespace: str = ""):
        """A merge patch (RFC 7386)."""
        out = self.t.request("PATCH", "patch", (resource, namespace, name), patch,
                             patch_type="merge")
        return self._typed(resource, out)

    def pod_logs(self, name: str, namespace: str = "default", container: str = "",
                 tail: Optional[int] = None) -> str:
        """GET /pods/{name}/log (relayed through the apiserver from the
        pod's kubelet)."""
        return self.t.request("GET", "pod_log", (namespace, name, container, tail))

    def bind(self, pod_name: str, node_name: str, namespace: str = "default") -> None:
        """POST one Binding (the per-pod scheduler's commit;
        factory.go:311-315): the pod's node is set only while it has
        none, else a 409."""
        binding = {"kind": "Binding", "apiVersion": "v1",
                   "metadata": {"name": pod_name, "namespace": namespace},
                   "target": {"kind": "Node", "name": node_name}}
        self.t.request("POST", "bind", (namespace,), binding)

    def bind_bulk(self, bindings, namespace: str = "default", atomic: bool = False) -> list:
        """Commit many (pod_name, node_name) bindings in one request;
        per-item Status dicts back. atomic=True (a gang's commit): the
        first conflict rejects the whole batch and no pod is bound."""
        wire = [
            {"kind": "Binding", "apiVersion": "v1",
             "metadata": {"name": p, "namespace": namespace},
             "target": {"kind": "Node", "name": n}}
            for p, n in bindings
        ]
        body = {"bindings": wire}
        if atomic:
            body["atomic"] = True
        return self._results(self.t.request("POST", "bind_bulk", (namespace,), body))

    def create_bulk(self, resource: str, objs, namespace: str = "") -> list:
        """Create N objects in one request; per-item Status dicts in input order."""
        return self._results(self.t.request("POST", "create_bulk", (resource, namespace),
                                            [self._wire(o) for o in objs]))

    def create_events_bulk(self, events, namespace: str = "default") -> list:
        """Write many Events in one request (the event sink's batches)."""
        return self._results(self.t.request("POST", "create_events_bulk", (namespace,),
                                            {"items": list(events)}))

    def watch(self, resource: str, namespace: str = "", since: int = 0,
              label_selector: str = "", field_selector: str = ""):
        """Raw watch stream of wire-form Events."""
        return self.t.watch(resource, namespace, since, label_selector, field_selector)

    # -- events (reference: pkg/client/record EventRecorder) ----------

    def record_event(self, involved, reason: str, message: str, source: str = "",
                     namespace: str = "default") -> None:
        """Record through the shared broadcaster: async, and repeats
        compress into one Event with a rising count."""
        wire = self._wire(involved)
        if not wire.get("metadata", {}).get("namespace"):
            wire = dict(wire, metadata=dict(wire.get("metadata", {}), namespace=namespace))
        self.recorder(source).event(wire, reason, message)

    def recorder(self, component: str = ""):
        """Component-scoped EventRecorder on this client's broadcaster,
        started on first use."""
        with self._recorder_lock:
            if self._broadcaster is None:
                from kubernetes_tpu_torch.client.record import EventBroadcaster

                self._broadcaster = EventBroadcaster().start_recording_to_sink(self)
            rec = self._recorders.get(component)
            if rec is None:
                rec = self._recorders[component] = self._broadcaster.new_recorder(component)
            return rec

    def flush_events(self, timeout: float = 2.0) -> None:
        """Block until the events recorded so far went through the sink."""
        with self._recorder_lock:
            b = self._broadcaster
        if b is not None:
            b.flush(timeout)
