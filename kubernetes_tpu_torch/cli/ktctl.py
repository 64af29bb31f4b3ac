"""ktctl — the CLI.

Reference: pkg/kubectl/cmd/ (cobra command tree), pkg/kubectl/resource
(builder: files/stdin -> objects), resource_printer.go (table/json/yaml
printers), describe.go, scale.go, expose.go.

Usage:
    ktctl [--server URL] [-n NAMESPACE] [-o table|json|yaml|name] CMD ...

Commands: get (incl. -w watch), create, apply, update, delete,
describe, scale, label, expose, run, rolling-update, stop (reaper),
logs (incl. -f follow), exec, port-forward, proxy, top, namespace,
config, api-resources, api-versions, cluster-info, version, and the
scheduler's records: trace, explain, slo, profile, alerts, rebalance.

The port's copy of `kubernetes_tpu/cli/ktctl.py`, the same command tree
and output, run as `python -m kubernetes_tpu_torch.cli` or
`python -m kubernetes_tpu_torch.cmd.hyperkube ktctl`. It is a thin
client: neither torch nor numpy is loaded unless a command reads the
process-local records of an in-process client (a `LocalTransport`).
Departures:

- PyYAML is imported only where YAML is read or written. A manifest
  whose text parses as JSON is read with `json` (what
  `yaml.safe_load_all` gives for it); any other manifest, `-o yaml` and
  `describe` (whose body is YAML) need PyYAML and exit with an error
  naming it when it is missing. JAX's imports it at the top.
- Objects are read in wire form and typed with the whole object model
  of the apiserver's registry (`cli/updater.get_typed`), whatever model
  the given client types with.
- `profile kernels` reads the port's kernel ledger (`ops/ledger.py`):
  one row a kernel and impl (`scan_kernel[cuda]`, `scan_kernel[plain]`),
  its launches under CALLS and its builds under COMPILES. The port has
  no shape contracts or collective inventories, so CONTRACT and COMM
  print `-`. `profile device` prints the directory of the server's
  torch.profiler trace.
- `version` with an in-process client says `(gpu)` where JAX's says
  `(tpu)`, as the port's `/version` does.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.cli.updater import get_typed, list_typed
from kubernetes_tpu_torch.client.rest import APIError, Client, HTTPTransport
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.server.registry import RESOURCES


def _yaml():
    """PyYAML, imported where YAML is read or written."""
    try:
        import yaml
    except ImportError:
        raise SystemExit(
            "error: PyYAML is not installed; YAML input and output (-o yaml, "
            "describe) need it, JSON manifests and -o json do not"
        )
    return yaml


def _yaml_dump(data, **kw) -> str:
    return _yaml().safe_dump(data, **kw)


def _parse_manifests(text: str) -> List[Any]:
    """The documents of one manifest text: the JSON value when the text
    parses as JSON (one document, as `yaml.safe_load_all` reads it),
    else its YAML documents."""
    try:
        return [json.loads(text)]
    except json.JSONDecodeError:
        return list(_yaml().safe_load_all(text))

# Short aliases (reference: kubectl.go resource shortcuts).
ALIASES = {
    "po": "pods",
    "pod": "pods",
    "no": "nodes",
    "node": "nodes",
    "svc": "services",
    "service": "services",
    "rc": "replicationcontrollers",
    "ep": "endpoints",
    "ev": "events",
    "ns": "namespaces",
    "namespace": "namespaces",
    "secret": "secrets",
    "event": "events",
    "pg": "podgroups",
    "podgroup": "podgroups",
    "pc": "priorityclasses",
    "priorityclass": "priorityclasses",
}


def resolve_resource(name: str) -> str:
    name = name.lower()
    name = ALIASES.get(name, name)
    if name not in RESOURCES:
        raise SystemExit(f"error: unknown resource type {name!r}")
    return RESOURCES[name].name


# ---------------------------------------------------------------------------
# Printers (reference: resource_printer.go)
# ---------------------------------------------------------------------------


def _age(ts: str) -> str:
    import time
    from datetime import datetime, timezone

    if not ts:
        return "<none>"
    try:
        then = datetime.strptime(ts, "%Y-%m-%dT%H:%M:%SZ").replace(
            tzinfo=timezone.utc
        )
    except ValueError:
        return "<none>"
    secs = int(time.time() - then.timestamp())
    if secs < 120:
        return f"{secs}s"
    if secs < 7200:
        return f"{secs // 60}m"
    if secs < 172800:
        return f"{secs // 3600}h"
    return f"{secs // 86400}d"


def _pod_row(o) -> List[str]:
    statuses = o.status.container_statuses
    ready = sum(1 for c in statuses if c.ready)
    restarts = sum(c.restart_count for c in statuses)
    return [
        o.metadata.name,
        f"{ready}/{max(len(statuses), len(o.spec.containers))}",
        o.status.phase,
        str(restarts),
        o.spec.node_name or "<none>",
        _age(o.metadata.creation_timestamp),
    ]


def _node_row(o) -> List[str]:
    ready = "Unknown"
    for c in o.status.conditions:
        if c.type == "Ready":
            ready = {"True": "Ready", "False": "NotReady"}.get(c.status, "Unknown")
    if o.spec.unschedulable:
        ready += ",SchedulingDisabled"
    cap = o.status.capacity
    return [
        o.metadata.name,
        ready,
        str(cap.get("cpu", "")),
        str(cap.get("memory", "")),
        _age(o.metadata.creation_timestamp),
    ]


def _svc_row(o) -> List[str]:
    ports = ",".join(f"{p.port}/{p.protocol}" for p in o.spec.ports)
    return [
        o.metadata.name,
        o.spec.type,
        o.spec.cluster_ip or "<none>",
        ports or "<none>",
        _age(o.metadata.creation_timestamp),
    ]


def _rc_row(o) -> List[str]:
    return [
        o.metadata.name,
        str(o.spec.replicas),
        str(o.status.replicas),
        ",".join(f"{k}={v}" for k, v in o.spec.selector.items()),
        _age(o.metadata.creation_timestamp),
    ]


def _ep_row(o) -> List[str]:
    addrs = []
    for s in o.subsets:
        for a in s.addresses:
            for p in s.ports:
                addrs.append(f"{a.ip}:{p.port}")
    return [o.metadata.name, ",".join(addrs[:4]) + ("..." if len(addrs) > 4 else "") or "<none>", _age(o.metadata.creation_timestamp)]


def _event_row(o) -> List[str]:
    return [
        _age(o.last_timestamp or o.first_timestamp),
        o.reason,
        f"{o.involved_object.kind}/{o.involved_object.name}",
        (o.source or {}).get("component", ""),
        o.message[:80],
    ]


def _podgroup_row(o) -> List[str]:
    return [
        o.metadata.name,
        str(o.spec.min_member),
        o.status.phase or "Pending",
        f"{o.status.bound}/{o.status.members}",
        _age(o.metadata.creation_timestamp),
    ]


def _priorityclass_row(o) -> List[str]:
    return [
        o.metadata.name,
        str(o.value),
        "true" if o.global_default else "false",
        o.preemption_policy or "PreemptLowerPriority",
        _age(o.metadata.creation_timestamp),
    ]


TABLE_COLUMNS = {
    "pods": (["NAME", "READY", "STATUS", "RESTARTS", "NODE", "AGE"], _pod_row),
    "nodes": (["NAME", "STATUS", "CPU", "MEMORY", "AGE"], _node_row),
    "services": (["NAME", "TYPE", "CLUSTER-IP", "PORTS", "AGE"], _svc_row),
    "replicationcontrollers": (
        ["NAME", "DESIRED", "CURRENT", "SELECTOR", "AGE"],
        _rc_row,
    ),
    "endpoints": (["NAME", "ENDPOINTS", "AGE"], _ep_row),
    "events": (["AGE", "REASON", "OBJECT", "SOURCE", "MESSAGE"], _event_row),
    "podgroups": (
        ["NAME", "MIN-MEMBER", "PHASE", "BOUND", "AGE"],
        _podgroup_row,
    ),
    "priorityclasses": (
        ["NAME", "VALUE", "GLOBAL-DEFAULT", "PREEMPTION-POLICY", "AGE"],
        _priorityclass_row,
    ),
}


def _generic_row(o) -> List[str]:
    return [o.metadata.name, _age(o.metadata.creation_timestamp)]


def print_table(
    resource: str, objs: List[Any], out=None, header: bool = True
) -> None:
    out = out or sys.stdout
    headers, row_fn = TABLE_COLUMNS.get(resource, (["NAME", "AGE"], _generic_row))
    rows = [headers] + [row_fn(o) for o in objs]
    widths = [max(len(r[i]) for r in rows) for i in range(len(headers))]
    for r in rows if header else rows[1:]:
        out.write("   ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() + "\n")


def print_objs(resource: str, objs: List[Any], fmt: str, out=None) -> None:
    out = out or sys.stdout
    if fmt == "table":
        print_table(resource, objs, out)
    elif fmt == "name":
        for o in objs:
            out.write(f"{resource}/{o.metadata.name}\n")
    else:
        wires = [serde.to_wire(o) for o in objs]
        payload = wires[0] if len(wires) == 1 else {"kind": "List", "items": wires}
        if fmt == "json":
            out.write(json.dumps(payload, indent=2) + "\n")
        else:
            out.write(_yaml_dump(payload, sort_keys=False))


# ---------------------------------------------------------------------------
# Resource builder (reference: resource/builder.go — files/stdin -> objects)
# ---------------------------------------------------------------------------


def load_manifests(filename: str) -> List[Dict]:
    """Files, directories, stdin ('-'), or URLs — the reference
    resource builder's input surface (builder.go:77-126; directories
    visit every .json/.yaml/.yml inside, sorted)."""
    import os

    if filename == "-":
        texts = [sys.stdin.read()]
    elif filename.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(filename, timeout=30) as resp:
            texts = [resp.read().decode()]
    elif os.path.isdir(filename):
        texts = []
        for entry in sorted(os.listdir(filename)):
            if not entry.endswith((".json", ".yaml", ".yml")):
                continue
            with open(os.path.join(filename, entry)) as f:
                texts.append(f.read())
        if not texts:
            raise SystemExit(f"error: no manifests in directory {filename!r}")
    else:
        with open(filename) as f:
            texts = [f.read()]
    docs: List[Dict] = []
    for text in texts:
        for doc in _parse_manifests(text):
            if not doc:
                continue
            if doc.get("kind") == "List":
                docs.extend(doc.get("items", []))
            else:
                docs.append(doc)
    return docs


def resource_for_kind(kind: str) -> str:
    for name, info in RESOURCES.items():
        if info.kind == kind and name == info.name:
            return name
    raise SystemExit(f"error: no resource for kind {kind!r}")


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------


def cmd_get(client: Client, args) -> int:
    resource = resolve_resource(args.resource)
    watching = getattr(args, "watch", False) or getattr(args, "watch_only", False)
    ns = "" if args.all_namespaces else args.namespace
    # A named get narrows both the list and the watch server-side.
    fsel = f"metadata.name={args.name}" if args.name else ""
    version = 0
    printed_header = False
    if args.name and not watching:
        obj = get_typed(client, resource, args.name, args.namespace)
        print_objs(resource, [obj], args.output)
        return 0
    if not getattr(args, "watch_only", False):
        objs, version = list_typed(
            client,
            resource,
            namespace=ns,
            label_selector=args.selector or "",
            field_selector=fsel,
        )
        print_objs(resource, objs, args.output)
        printed_header = bool(objs)
    if not watching:
        return 0
    # --watch / --watch-only (reference: get.go:79-143 WatchLoop):
    # stream changes after the listed resourceVersion, one row per
    # event. Ctrl-C ends the loop.
    stream = client.watch(
        resource,
        namespace=ns,
        since=int(version or 0),
        label_selector=args.selector or "",
        field_selector=fsel,
    )
    limit = getattr(args, "watch_events", None)  # test hook
    seen = 0
    try:
        for event in stream:
            wire = event.object
            if not isinstance(wire, dict) or event.type == "ERROR":
                continue
            obj = serde.from_wire(RESOURCES[resource].cls, wire)
            if args.output == "table":
                # One header for the whole stream (kubectl appends
                # rows, it doesn't reprint the header per event).
                print_table(resource, [obj], header=not printed_header)
                printed_header = True
            else:
                print_objs(resource, [obj], args.output)
            sys.stdout.flush()
            seen += 1
            if limit is not None and seen >= limit:
                break
    except KeyboardInterrupt:
        pass
    finally:
        stream.close()
    return 0


def cmd_create(client: Client, args) -> int:
    count = 0
    for wire in load_manifests(args.filename):
        resource = resource_for_kind(wire.get("kind", ""))
        out = client.create(resource, wire, namespace=args.namespace)
        print(f"{resource}/{out.metadata.name} created")
        count += 1
    if count == 0:
        print("error: no objects in input", file=sys.stderr)
        return 1
    return 0


def cmd_apply(client: Client, args) -> int:
    """Create-or-update (kubectl apply shape)."""
    for wire in load_manifests(args.filename):
        resource = resource_for_kind(wire.get("kind", ""))
        name = wire.get("metadata", {}).get("name", "")
        try:
            client.create(resource, wire, namespace=args.namespace)
            print(f"{resource}/{name} created")
        except APIError as e:
            if e.code != 409:
                raise
            wire.setdefault("metadata", {}).pop("resourceVersion", None)
            client.update(resource, wire, namespace=args.namespace)
            print(f"{resource}/{name} configured")
    return 0


def cmd_delete(client: Client, args) -> int:
    grace = getattr(args, "grace_period", None)
    if args.filename:
        for wire in load_manifests(args.filename):
            resource = resource_for_kind(wire.get("kind", ""))
            name = wire.get("metadata", {}).get("name", "")
            client.delete(
                resource, name, namespace=args.namespace,
                grace_period_seconds=grace,
            )
            print(f"{resource}/{name} deleted")
        return 0
    if args.resource and args.name and getattr(args, "selector", None):
        # kubectl errors on NAME + -l: a selector meant as a safety
        # scope must never be silently ignored.
        raise SystemExit("error: delete takes a NAME or -l SELECTOR, not both")
    if args.resource and not args.name and getattr(args, "selector", None):
        # Selector-based delete (reference: delete.go over the
        # builder's selector path).
        resource = resolve_resource(args.resource)
        objs, _ = list_typed(
            client, resource, namespace=args.namespace, label_selector=args.selector
        )
        if not objs:
            print(f"No resources found matching -l {args.selector}")
            return 0
        for o in objs:
            client.delete(
                resource, o.metadata.name, namespace=args.namespace,
                grace_period_seconds=grace,
            )
            print(f"{resource}/{o.metadata.name} deleted")
        return 0
    if not args.resource or not args.name:
        raise SystemExit(
            "error: delete requires RESOURCE NAME, RESOURCE -l SELECTOR, "
            "or -f FILE"
        )
    resource = resolve_resource(args.resource)
    client.delete(
        resource, args.name, namespace=args.namespace,
        grace_period_seconds=grace,
    )
    print(f"{resource}/{args.name} deleted")
    return 0


def cmd_describe(client: Client, args) -> int:
    """reference: describe.go — object + its events."""
    resource = resolve_resource(args.resource)
    obj = get_typed(client, resource, args.name, args.namespace)
    wire = serde.to_wire(obj)
    print(_yaml_dump(wire, sort_keys=False).rstrip())
    try:
        events, _ = list_typed(
            client,
            "events",
            namespace=args.namespace,
            field_selector=f"involvedObject.name={args.name}",
        )
    except APIError:
        events = []
    if events:
        print("\nEvents:")
        for e in events[-10:]:
            print(f"  {e.reason}\t{e.message}")
    return 0


def cmd_scale(client: Client, args) -> int:
    """reference: scale.go (conflict-retrying Scaler)."""
    from kubernetes_tpu_torch.cli.updater import Scaler

    resource = resolve_resource(args.resource)
    if resource != "replicationcontrollers":
        raise SystemExit("error: scale only supports replicationcontrollers")
    Scaler(client).scale(args.name, args.replicas, namespace=args.namespace)
    print(f"replicationcontroller/{args.name} scaled to {args.replicas}")
    return 0


def cmd_rolling_update(client: Client, args) -> int:
    """reference: pkg/kubectl/cmd/rollingupdate.go + rolling_updater.go.

    Two modes, like the reference: `-f new-rc.json` (explicit new RC
    with a different selector) or `--image` (derive the new RC from the
    old one, adding a deployment-key label to keep selectors disjoint).
    """
    import hashlib

    from kubernetes_tpu_torch.cli.updater import RollingUpdater, UpdateTimeout
    from kubernetes_tpu_torch.models.apiobjects import ReplicationController

    if bool(args.filename) == bool(args.image):
        raise SystemExit("error: exactly one of -f or --image is required")
    if args.filename:
        manifests = load_manifests(args.filename)
        if len(manifests) != 1 or manifests[0].get("kind") != "ReplicationController":
            raise SystemExit("error: -f must contain exactly one ReplicationController")
        new_rc = serde.from_wire(ReplicationController, manifests[0])
    else:
        old = get_typed(client, "replicationcontrollers", args.name, args.namespace)
        new_rc = serde.from_wire(ReplicationController, serde.to_wire(old))
        new_rc.metadata.resource_version = ""
        new_rc.metadata.uid = ""
        if new_rc.spec.template is None or not new_rc.spec.template.spec.containers:
            raise SystemExit("error: old RC has no pod template containers")
        new_rc.spec.template.spec.containers[0].image = args.image
        key = hashlib.sha1(args.image.encode()).hexdigest()[:8]
        new_rc.metadata.name = f"{args.name}-{key}"
        # Deployment-key label keeps the two selectors disjoint
        # (rolling_updater.go AddDeploymentKeyToReplicationController).
        new_rc.spec.selector = dict(new_rc.spec.selector or {})
        new_rc.spec.selector["deployment"] = key
        new_rc.spec.template.metadata.labels = dict(
            new_rc.spec.template.metadata.labels or {}
        )
        new_rc.spec.template.metadata.labels["deployment"] = key
    updater = RollingUpdater(
        client,
        poll_interval=args.poll_interval,
        timeout=args.timeout,
        progress=lambda msg: print(msg),
    )
    try:
        survivor = updater.update(args.name, new_rc, namespace=args.namespace)
    except UpdateTimeout as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"replicationcontroller/{survivor} rolling updated")
    return 0


def cmd_stop(client: Client, args) -> int:
    """reference: pkg/kubectl/cmd/stop.go (reapers drain before
    deleting)."""
    from kubernetes_tpu_torch.cli.updater import Reaper, UpdateTimeout

    resource = resolve_resource(args.resource)
    try:
        Reaper(client, timeout=args.timeout).stop(
            resource, args.name, namespace=args.namespace
        )
    except UpdateTimeout as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"{resource}/{args.name} stopped")
    return 0


def cmd_label(client: Client, args) -> int:
    resource = resolve_resource(args.resource)
    obj = get_typed(client, resource, args.name, args.namespace)
    for kv in args.labels:
        if "=" in kv:
            k, v = kv.split("=", 1)
            if obj.metadata.labels.get(k) is not None and not args.overwrite:
                raise SystemExit(
                    f"error: label {k!r} already set; use --overwrite"
                )
            obj.metadata.labels[k] = v
        elif kv.endswith("-"):
            obj.metadata.labels.pop(kv[:-1], None)
        else:
            raise SystemExit(f"error: bad label spec {kv!r}")
    client.update(resource, obj, namespace=args.namespace)
    print(f"{resource}/{args.name} labeled")
    return 0


def cmd_expose(client: Client, args) -> int:
    """reference: expose.go — make a Service fronting an RC."""
    resource = resolve_resource(args.resource)
    if resource != "replicationcontrollers":
        raise SystemExit(f"error: cannot expose {resource}; only replicationcontrollers")
    rc = get_typed(client, "replicationcontrollers", args.name, args.namespace)
    svc = {
        "kind": "Service",
        "metadata": {"name": args.service_name or args.name},
        "spec": {
            "selector": dict(rc.spec.selector),
            "ports": [{"port": args.port, "targetPort": args.target_port or args.port}],
        },
    }
    out = client.create("services", svc, namespace=args.namespace)
    print(f"services/{out.metadata.name} exposed")
    return 0


def cmd_run(client: Client, args) -> int:
    """reference: run.go — create an RC running an image."""
    rc = {
        "kind": "ReplicationController",
        "metadata": {"name": args.name},
        "spec": {
            "replicas": args.replicas,
            "selector": {"run": args.name},
            "template": {
                "metadata": {"labels": {"run": args.name}},
                "spec": {
                    "containers": [
                        {
                            "name": args.name,
                            "image": args.image,
                            "resources": {
                                "limits": {"cpu": args.cpu, "memory": args.memory}
                            },
                        }
                    ]
                },
            },
        },
    }
    out = client.create("replicationcontrollers", rc, namespace=args.namespace)
    print(f"replicationcontrollers/{out.metadata.name} created")
    return 0


def cmd_logs(client: Client, args) -> int:
    """Reference: pkg/kubectl/cmd/log.go — fetch container logs via the
    apiserver's pod log subresource; -f polls for new lines until the
    pod disappears or the user interrupts."""
    if not getattr(args, "follow", False):
        out = client.pod_logs(
            args.name,
            namespace=args.namespace,
            container=args.container or "",
            tail=args.tail,
        )
        sys.stdout.write(out)
        if out and not out.endswith("\n"):
            sys.stdout.write("\n")
        return 0
    import time as _time

    # Char-offset diffing (not line counts): a poll that catches a
    # partially-written last line must emit the rest on the next poll,
    # not lose it. Each poll refetches the full log through the relay —
    # the subresource has no offset parameter; acceptable for the dev
    # clusters this CLI drives.
    seen = 0
    rounds = 0
    fetched = False
    limit = getattr(args, "follow_rounds", None)  # test hook
    while True:
        try:
            text = client.pod_logs(
                args.name, namespace=args.namespace,
                container=args.container or "",
            )
            if not fetched:
                fetched = True
                if args.tail is not None:
                    # Honor --tail on the first emission: skip
                    # everything before the last N lines.
                    cut = text.splitlines(keepends=True)[-args.tail:]
                    seen = len(text) - sum(len(c) for c in cut)
            if len(text) < seen:
                seen = 0  # log truncated/rotated: re-emit
            sys.stdout.write(text[seen:])
            sys.stdout.flush()
            seen = len(text)
            rounds += 1
            if limit is not None and rounds >= limit:
                return 0
            _time.sleep(0.5)
        except APIError as e:
            if e.code == 404 and fetched:
                return 0  # pod gone mid-stream: clean end
            raise  # never-seen pod: surface the error like plain logs
        except KeyboardInterrupt:
            return 0


def cmd_exec(client: Client, args) -> int:
    """Reference: pkg/kubectl/cmd/exec.go — run a command in a
    container (JSON run-exec; no tty streaming)."""
    result = client.pod_exec(
        args.name,
        args.cmd,
        namespace=args.namespace,
        container=args.container or "",
    )
    output = result.get("output", "")
    sys.stdout.write(output)
    if output and not output.endswith("\n"):
        sys.stdout.write("\n")
    return int(result.get("exitCode", 0))


def forward_port(
    server: str,
    pod: str,
    local_port: int,
    remote_port: int,
    namespace: str = "default",
    ready_event=None,
    stop_event=None,
    headers: Optional[Dict[str, str]] = None,
):
    """Listen on local_port; tunnel each connection through the
    apiserver's pod portforward subresource (websocket) to the pod.
    Reference: pkg/kubectl/cmd/portforward.go + pkg/client/portforward.
    Runs until stop_event is set (or forever). `headers` carry the
    kubeconfig's auth to the handshake."""
    import socket
    import threading
    import urllib.parse as _up

    from kubernetes_tpu_torch.utils import websocket as ws

    if "//" not in server:
        # Same scheme-less tolerance HTTPTransport has ("localhost:8001").
        server = "http://" + server
    parsed = _up.urlparse(server)
    if parsed.scheme == "https":
        raise SystemExit("error: port-forward does not support https servers")
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", local_port))
    listener.listen(16)
    listener.settimeout(0.2)
    bound_port = listener.getsockname()[1]
    if ready_event is not None:
        ready_event.port = bound_port
        ready_event.set()

    def tunnel(conn):
        try:
            upstream = ws.WebSocketClient(
                parsed.hostname,
                parsed.port or 80,
                f"/api/v1/namespaces/{namespace}/pods/{pod}/portforward"
                f"?port={remote_port}",
                headers=headers,
            )
        except (ConnectionError, OSError):
            conn.close()
            return
        upstream.clear_timeout()
        ws.relay_ws_tcp(upstream, conn)

    try:
        while stop_event is None or not stop_event.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            threading.Thread(target=tunnel, args=(conn,), daemon=True).start()
    finally:
        listener.close()


def cmd_port_forward(client: Client, args) -> int:
    local_s, _, remote_s = args.ports.partition(":")
    if not remote_s:
        remote_s = local_s
    print(
        f"Forwarding 127.0.0.1:{local_s} -> {args.name}:{remote_s} "
        "(Ctrl-C to stop)"
    )
    try:
        forward_port(
            args.server, args.name, int(local_s), int(remote_s),
            namespace=args.namespace,
            headers=getattr(args, "_auth_headers", None),
        )
    except KeyboardInterrupt:
        print("stopped")
    return 0


def cmd_top(client: Client, args) -> int:
    """Live resource usage, heapster-era style: scrape every node's
    kubelet /stats THROUGH the apiserver node proxy (reference:
    cluster/addons/cluster-monitoring pulls cadvisor stats via the
    master; kubectl top arrived with that pipeline)."""
    import json as _json
    import urllib.error
    import urllib.request

    if args.what == "cluster":
        return _cmd_top_cluster(client, args)
    if args.what == "capacity":
        return _cmd_top_capacity(client, args)
    if args.what == "health":
        return _cmd_top_health(client, args)
    nodes, _ = list_typed(client, "nodes")
    node_util = {}
    if args.what == "nodes":
        # UTIL% rides the capacity plane's per-node utilization (the
        # scheduler's own staged occupancy view) rather than a second
        # kubelet scrape — one sample source, no extra round-trips.
        try:
            cap = _fetch_capacity_report(client, args)
            if cap.get("sampled"):
                node_util = cap.get("node_utilization", {}) or {}
        except Exception:
            node_util = {}
        print(f"{'NAME':20}{'PODS':6}{'RSS':>12}{'DISK-USED':>11}{'UTIL%':>8}")
    else:
        print(f"{'POD-UID':38}{'CONTAINER':14}{'STATE':10}{'RSS':>12}{'RESTARTS':>9}")
    for node in nodes:
        stats = None
        if args.server:
            url = (
                f"{args.server}/api/v1/nodes/{node.metadata.name}"
                "/proxy/stats"
            )
            try:
                with urllib.request.urlopen(url, timeout=10) as resp:
                    stats = _json.loads(resp.read())
            except (urllib.error.URLError, OSError) as e:
                print(
                    f"# {node.metadata.name}: unreachable ({e})",
                    file=sys.stderr,
                )
        if args.what == "nodes":
            # Kubelet stats may be unreachable (or there is no HTTP
            # server at all — injected transport): the scheduler-side
            # UTIL% column still renders, the kubelet columns dash out.
            pods = (stats or {}).get("pods", {})
            rss = sum(
                c.get("rssBytes", 0) for cs in pods.values() for c in cs
            )
            disk = (stats or {}).get("disk", {}).get("usedFraction", 0)
            # Binding-resource utilization: the max of cpu/mem/pods
            # ratios — the one that fills first is the one that blocks
            # the next placement.
            util = node_util.get(node.metadata.name)
            util_s = f"{max(util):.0%}" if util else "-"
            print(
                f"{node.metadata.name:20}"
                f"{len(pods) if stats else '-':<6}"
                f"{_human_bytes(rss) if stats else '-':>12}"
                f"{f'{disk:.0%}' if stats else '-':>10}{util_s:>8}"
            )
        else:
            if stats is None:
                continue
            pods = stats.get("pods", {})
            for uid, containers in sorted(pods.items()):
                for c in containers:
                    print(
                        f"{uid:38}{c.get('name', ''):14}"
                        f"{c.get('state', ''):10}"
                        f"{_human_bytes(c.get('rssBytes', 0)):>12}"
                        f"{c.get('restartCount', 0):>9}"
                    )
    return 0


def _human_bytes(n: int) -> str:
    for unit in ("B", "Ki", "Mi", "Gi"):
        if n < 1024 or unit == "Gi":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n}B"


def cmd_api_resources(client: Client, args) -> int:
    seen = set()
    print(f"{'NAME':32}{'NAMESPACED':12}KIND")
    for name, info in sorted(RESOURCES.items()):
        if info.name in seen or name != info.name:
            continue
        seen.add(info.name)
        print(f"{info.name:32}{str(info.namespaced).lower():12}{info.kind}")
    return 0


def _server_get_json(args, path: str) -> Dict:
    import urllib.request

    req = urllib.request.Request(
        f"{args.server}{path}", headers=getattr(args, "_auth_headers", {}) or {}
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read().decode())


def cmd_version(client: Client, args) -> int:
    """Reference: pkg/kubectl/cmd/version.go — client and server
    versions."""
    from kubernetes_tpu_torch import __version__

    print(f"Client Version: {__version__}")
    if not args.server:
        # Injected in-process transport: the "server" is this process.
        print(f"Server Version: {__version__} (gpu)")
        return 0
    try:
        info = _server_get_json(args, "/version")
    except Exception as e:
        print(f"error: couldn't read version from server: {e}", file=sys.stderr)
        return 1
    print(f"Server Version: {info.get('gitVersion', '?')} ({info.get('platform', '')})")
    return 0


def cmd_api_versions(client: Client, args) -> int:
    """Reference: pkg/kubectl/cmd/apiversions.go."""
    if not args.server:
        from kubernetes_tpu_torch.models import conversion

        print("Available Server Api Versions:", ",".join(conversion.VERSIONS))
        return 0
    try:
        info = _server_get_json(args, "/api")
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print("Available Server Api Versions:", ",".join(info.get("versions", [])))
    return 0


def cmd_cluster_info(client: Client, args) -> int:
    """Reference: pkg/kubectl/cmd/clusterinfo.go — master address plus
    any services labeled kubernetes.io/cluster-service=true."""
    print(f"Kubernetes master is running at {args.server}")
    services, _ = list_typed(
        client, "services", namespace="", label_selector="kubernetes.io/cluster-service=true"
    )
    for svc in services:
        ns, name = svc.metadata.namespace, svc.metadata.name
        print(
            f"{name} is running at {args.server}"
            f"/api/v1/namespaces/{ns}/services/{name}/proxy"
        )
    return 0


def cmd_namespace(client: Client, args) -> int:
    """Reference: pkg/kubectl/cmd/namespace.go — show or set the
    default namespace recorded in the kubeconfig's current context."""
    from kubernetes_tpu_torch.client import kubeconfig as kc

    path = kc.config_path(args.kubeconfig)
    data = kc.load_raw(path)
    current = args.context or data.get("current-context", "")
    if not args.ns:
        ctx = kc._by_name(data.get("contexts"), current) or {}
        print(ctx.get("context", {}).get("namespace") or "default")
        return 0
    if not current:
        print("error: no current context to set the namespace on", file=sys.stderr)
        return 1
    kc.set_entry(data, "contexts", current, "context", {"namespace": args.ns})
    kc.save_raw(path, data)
    print(f'Set default namespace to "{args.ns}" in context "{current}"')
    return 0


def cmd_update(client: Client, args) -> int:
    """Reference: pkg/kubectl/cmd/update.go — full replace from -f, or
    a merge patch with --patch."""
    if bool(args.filename) == bool(args.patch):
        raise SystemExit("error: exactly one of -f or --patch is required")
    if args.patch:
        if not (args.resource and args.name):
            raise SystemExit("error: --patch requires RESOURCE NAME")
        resource = resolve_resource(args.resource)
        try:
            patch = json.loads(args.patch)
        except json.JSONDecodeError as e:
            raise SystemExit(f"error: --patch is not valid JSON: {e}")
        client.patch(resource, args.name, patch, namespace=args.namespace)
        print(f"{resource}/{args.name} updated")
        return 0
    for wire in load_manifests(args.filename):
        resource = resource_for_kind(wire.get("kind", ""))
        name = wire.get("metadata", {}).get("name", "")
        client.update(resource, wire, namespace=args.namespace)
        print(f"{resource}/{name} updated")
    return 0


class _ProxyServer:
    """`ktctl proxy` — a local HTTP relay to the apiserver carrying the
    kubeconfig's credentials (pkg/kubectl/proxy.go, cmd/proxy.go):
    lets credential-less local tools browse the API."""

    def __init__(self, server: str, headers: Dict[str, str],
                 host: str = "127.0.0.1", port: int = 8001,
                 api_prefix: str = "/api"):
        import http.server
        import socketserver
        import urllib.error
        import urllib.request

        upstream = server.rstrip("/")
        prefix = api_prefix.rstrip("/") or "/api"

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):  # noqa: N802
                pass

            def _relay(self, verb: str) -> None:
                if not (self.path.startswith(prefix + "/") or self.path == prefix
                        or self.path.startswith(("/version", "/healthz", "/swagger"))):
                    self.send_error(404, "not proxied")
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else None
                req = urllib.request.Request(
                    upstream + self.path, data=body, method=verb,
                    headers={**headers, "Content-Type": "application/json"},
                )
                try:
                    resp = urllib.request.urlopen(req, timeout=30)
                    code, payload = resp.status, resp.read()
                except urllib.error.HTTPError as e:
                    code, payload = e.code, e.read()
                except (urllib.error.URLError, OSError) as e:
                    # Apiserver unreachable: answer 502 instead of
                    # resetting the client's connection.
                    code = 502
                    payload = json.dumps(
                        {
                            "kind": "Status",
                            "status": "Failure",
                            "reason": "BadGateway",
                            "message": f"apiserver unreachable: {e}",
                        }
                    ).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):  # noqa: N802
                self._relay("GET")

            def do_POST(self):  # noqa: N802
                self._relay("POST")

            def do_PUT(self):  # noqa: N802
                self._relay("PUT")

            def do_DELETE(self):  # noqa: N802
                self._relay("DELETE")

            def do_PATCH(self):  # noqa: N802
                self._relay("PATCH")

        class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True

        self.httpd = Server((host, port), Handler)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_background(self):
        import threading

        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def cmd_proxy(client: Client, args) -> int:
    srv = _ProxyServer(
        args.server,
        getattr(args, "_auth_headers", {}) or {},
        port=args.port,
        api_prefix=args.api_prefix,
    )
    print(f"Starting to serve on 127.0.0.1:{srv.port}")
    try:
        srv.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


def cmd_trace(client: Client, args) -> int:
    """Render recent scheduling traces as span trees (the CLI face of
    GET /debug/traces): `ktctl trace <pod>` shows every trace that
    touched the pod — enqueue through bind — with durations."""
    from kubernetes_tpu_torch.utils import tracing

    transport = client.t
    get_json = getattr(transport, "get_json", None)
    if get_json is not None:
        data = get_json(
            "/debug/traces",
            query={"pod": args.name or "", "limit": str(args.limit)},
        )
    else:
        # Transport without a raw-GET surface (LocalTransport: the
        # injected in-process client of tests/embedding) — the trace
        # buffer is process-local, read it directly.
        data = tracing.DEFAULT_BUFFER.to_dicts(
            pod=args.name or "", limit=args.limit
        )
    traces = data.get("traces", [])
    if not traces:
        # Clean nonzero exit, nothing on stdout: a script piping this
        # must see the miss, not an empty tree.
        if args.name:
            print(
                f'no trace recorded for pod "{args.name}"', file=sys.stderr
            )
        else:
            print("no traces recorded", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(data, indent=2))
        return 0
    if args.output == "yaml":
        print(_yaml_dump(data, default_flow_style=False))
        return 0
    for tr in traces:
        print(tracing.format_trace(tr))
    return 0


def cmd_explain(client: Client, args) -> int:
    """`ktctl explain pod <name>` — the CLI face of the scheduling
    flight recorder (GET /debug/decisions): why the pod landed where it
    did (winner + score decomposition), or a per-node table of "why
    not" predicate reasons when it is stuck, plus any preemption
    verdict (nominated node / victims)."""
    from kubernetes_tpu_torch.utils import flightrecorder

    resource = resolve_resource(args.resource)
    if resource != "pods":
        raise SystemExit("error: explain supports pods only")
    key = f"{args.namespace}/{args.name}"
    transport = client.t
    get_json = getattr(transport, "get_json", None)
    if get_json is not None:
        data = get_json(
            "/debug/decisions",
            query={"pod": key, "limit": str(args.limit)},
        )
    else:
        # Injected in-process transport (LocalTransport): the recorder
        # is process-local, read it directly — same as `ktctl trace`.
        data = flightrecorder.DEFAULT.decisions(pod=key, limit=args.limit)
    decisions = data.get("decisions", [])
    if not decisions:
        print(
            f'no decision recorded for pod "{args.name}"', file=sys.stderr
        )
        return 1
    if args.output == "json":
        print(json.dumps(data, indent=2))
        return 0
    if args.output == "yaml":
        print(_yaml_dump(data, default_flow_style=False))
        return 0
    for d in decisions:
        print(flightrecorder.format_decision(d))
    return 0


def _fetch_slo_report(client: Client, args) -> Dict:
    """The SLO report: GET /debug/slo over HTTP transports, or the
    process-local engine for injected LocalTransport clients (same
    split as `ktctl trace` / `ktctl explain`)."""
    transport = client.t
    get_json = getattr(transport, "get_json", None)
    if get_json is not None:
        return get_json("/debug/slo")
    from kubernetes_tpu_torch.utils import slo

    return slo.evaluate()


def _render_slo_table(report: Dict) -> List[str]:
    lines = [
        f"{'OBJECTIVE':24}{'SERIES':34}{'P50':>9}{'P99':>9}"
        f"{'TARGET':>9}{'SAMPLES':>9}  VERDICT"
    ]
    for o in report.get("objectives", ()):
        series = o.get("series", "")
        labels = o.get("labels") or {}
        if labels:
            inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            series = f"{series}{{{inner}}}"

        def num(v):
            return "-" if v is None else f"{v:.4g}"

        lines.append(
            f"{o.get('name', ''):24}{series:34}"
            f"{num(o.get('p50')):>9}"
            f"{num(o.get('p99', o.get('value'))):>9}"
            f"{num(o.get('target')):>9}"
            f"{o.get('samples', 0):>9}  {o.get('verdict', '')}"
        )
    lines.append(f"overall: {report.get('verdict', 'no_data')}")
    return lines


def cmd_slo(client: Client, args) -> int:
    """`ktctl slo` — per-objective service-level verdicts from the SLO
    engine (GET /debug/slo): pod-startup milestone watermarks, watch
    fan-out lag, and solver device telemetry with pass/warn/burn
    verdicts. Exits 1 with 'no SLI samples recorded' when no objective
    has samples yet (mirror of the trace/explain miss contract)."""
    report = _fetch_slo_report(client, args)
    if not report.get("sampled"):
        # Clean nonzero exit, empty stdout: a script gating on SLOs
        # must see that nothing has been measured, not a hollow pass.
        print("no SLI samples recorded", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(report, indent=2))
        return 0
    if args.output == "yaml":
        print(_yaml_dump(report, default_flow_style=False))
        return 0
    for line in _render_slo_table(report):
        print(line)
    return 0


def _fmt_qty(v) -> str:
    """Human-compact engineering figure for ledger table cells."""
    if v is None:
        return "-"
    v = float(v)
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.4g}"


def cmd_profile(client: Client, args) -> int:
    """`ktctl profile [kernels|cpu|device]` — the device-time profiling
    plane's CLI face:

    - kernels: the kernel ledger (GET /debug/kernels) — one row per
      kernel and impl with its calls, builds and build wall, and the
      cost of its largest shape. Exits 1 with 'no compiles recorded'
      on a cold process (the trace/explain/slo miss contract).
    - cpu: the wall-clock sampling profiler (GET /debug/profile),
      --format collapsed emits flamegraph.pl/speedscope folded stacks.
    - device: an on-demand torch.profiler device trace
      (GET /debug/device-profile?seconds=N); prints the server-side
      trace directory.
    """
    transport = client.t
    get_json = getattr(transport, "get_json", None)
    if args.what in ("cpu", "device") and hasattr(transport, "timeout"):
        # The capture blocks the handler for --seconds; the transport's
        # default 30s socket timeout would sever a longer capture
        # mid-flight (and the server-side trace would keep running,
        # 409-ing the retry).
        transport.timeout = max(transport.timeout, args.seconds + 30.0)
    if args.what == "kernels":
        if get_json is not None:
            data = get_json("/debug/kernels")
        else:
            # Injected in-process transport (LocalTransport): the
            # ledger is process-local — read it via sys.modules so a
            # process that never launched a kernel (ledger module never
            # imported) reports the miss without loading torch.
            led = sys.modules.get("kubernetes_tpu_torch.ops.ledger")
            data = (
                led.DEFAULT.to_dict()
                if led is not None
                else {"kernels": [], "summary": {"compiles": 0}}
            )
        rows = data.get("kernels", [])
        if not rows:
            # Clean nonzero exit, empty stdout: a script gating on the
            # ledger must see that nothing compiled, not a hollow table.
            print("no compiles recorded", file=sys.stderr)
            return 1
        if args.output == "json":
            print(json.dumps(data, indent=2))
            return 0
        if args.output == "yaml":
            print(_yaml_dump(data, default_flow_style=False))
            return 0
        print(
            f"{'KERNEL':44}{'CALLS':>7}{'COMPILES':>9}{'COMPILE_S':>10}"
            f"{'FLOPS':>9}{'BYTES':>9}{'AI':>7}  {'CONTRACT':9} COMM"
        )
        mismatches = []
        for r in rows:
            shapes = r.get("shapes", ())

            def peak(metric):
                vals = [
                    s.get(metric) for s in shapes
                    if s.get(metric) is not None
                ]
                return max(vals) if vals else None

            # Declared-vs-observed staged shapes: the port's ledger has
            # no contract verdicts, so this stays "-" (as does COMM).
            verdicts = [s.get("contract") for s in shapes]
            if any(v and v.startswith("mismatch") for v in verdicts):
                contract = "MISMATCH"
                mismatches.extend(
                    (r["kernel"], s.get("signature", ""), s["contract"])
                    for s in shapes
                    if (s.get("contract") or "").startswith("mismatch")
                )
            elif "uncontracted" in verdicts:
                contract = "uncontracted"
            elif verdicts and all(v == "ok" for v in verdicts):
                contract = "ok"
            else:
                contract = "-"
            # Collective-inventory verdict (harvest-attached; same
            # worst-across-shape-rows logic): DRIFT when any staged
            # bucket compiled an undeclared collective kind.
            comms = [s.get("collectives_verdict") for s in shapes]
            if any(v and v.startswith("drift") for v in comms):
                comm = "DRIFT"
                mismatches.extend(
                    (r["kernel"], s.get("signature", ""),
                     s["collectives_verdict"])
                    for s in shapes
                    if (s.get("collectives_verdict") or "").startswith(
                        "drift"
                    )
                )
            elif comms and all(v == "ok" for v in comms):
                comm = "ok"
            elif "uncontracted" in comms:
                comm = "uncontracted"
            else:
                comm = "-"
            ai = peak("arithmetic_intensity")
            name = f"{r['kernel']}[{r['impl']}]" if r.get("impl") else r["kernel"]
            print(
                f"{name:44}{r.get('calls', 0):>7}"
                f"{r.get('compiles', 0):>9}"
                f"{r.get('compile_seconds', 0.0):>10.3f}"
                f"{_fmt_qty(peak('flops')):>9}"
                f"{_fmt_qty(peak('bytes_accessed')):>9}"
                f"{'-' if ai is None else f'{ai:.2f}':>7}  "
                f"{contract:9} {comm}"
            )
        for kernel, signature, verdict in mismatches:
            print(f"  {kernel} {signature}: {verdict}")
        summary = data.get("summary", {})
        print(
            f"total: {summary.get('compiles', 0)} compiles, "
            f"{summary.get('compile_seconds_total', 0.0)}s compiling, "
            f"{summary.get('pending_cost_rows', 0)} cost rows pending"
        )
        return 0
    if args.what == "cpu":
        get_text = getattr(transport, "get_text", None)
        if get_text is not None:
            body = get_text(
                "/debug/profile",
                query={"seconds": str(args.seconds), "format": args.fmt},
            )
        else:
            from kubernetes_tpu_torch.utils import debug

            body = debug.sample_profile(seconds=args.seconds, fmt=args.fmt)
        sys.stdout.write(body)
        return 0
    # device
    if get_json is not None:
        info = get_json(
            "/debug/device-profile", query={"seconds": str(args.seconds)}
        )
    else:
        from kubernetes_tpu_torch.utils import profiler

        try:
            info = profiler.capture_device_trace(seconds=args.seconds)
        except (profiler.TraceInProgress, profiler.ProfilerUnavailable) as e:
            # Same one-line contract the HTTP path gets via 409/503 ->
            # APIError; a traceback is not an error message.
            print(f"error: {e}", file=sys.stderr)
            return 1
    if args.output == "json":
        print(json.dumps(info, indent=2))
        return 0
    print(
        f"device trace: {info.get('seconds')}s captured to "
        f"{info.get('dir')} ({len(info.get('files', []))} files)"
    )
    return 0


#: /metrics series prefixes `ktctl top cluster` surfaces (the telemetry
#: plane's device/solver/watch families, not the whole exposition).
_TOP_CLUSTER_PREFIXES = (
    "pod_startup_latency_seconds",
    "watch_fanout_lag_versions",
    "watch_streams_dropped_total",
    "watch_stream_queue_depth",
    "scheduler_informer_staleness_seconds",
    "solver_device_transfer_bytes_total",
    "solver_xla_",
    "device_memory_bytes",
    "cluster_fragmentation_score",
    "cluster_headroom_pods",
    "slice_alloc_success_rate",
    "scheduler_backlog_pressure",
    "capacity_zero_headroom_ticks_total",
)


def _fetch_capacity_report(client: Client, args) -> Dict:
    """The capacity report: GET /debug/capacity over HTTP transports,
    or the process-local monitor for injected LocalTransport clients
    (same split as `ktctl slo`; the port's utils/capacity loads torch,
    which only an in-process client's read pays for)."""
    transport = client.t
    get_json = getattr(transport, "get_json", None)
    if get_json is not None:
        return get_json("/debug/capacity")
    from kubernetes_tpu_torch.utils import capacity

    return capacity.DEFAULT.snapshot()


def _cmd_top_capacity(client: Client, args) -> int:
    """`ktctl top capacity` — the capacity & fragmentation plane:
    cluster fragmentation score, per-probe-shape headroom table, top-k
    stranded nodes, and backlog pressure (GET /debug/capacity). Exits 1
    with 'no capacity samples recorded' on a cluster whose scheduler
    has not sampled yet (the trace/explain/slo miss contract)."""
    report = _fetch_capacity_report(client, args)
    if not report.get("sampled"):
        # Clean nonzero exit, empty stdout: a script gating on capacity
        # must see that nothing was measured, not a hollow table.
        print("no capacity samples recorded", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(report, indent=2))
        return 0
    if args.output == "yaml":
        print(_yaml_dump(report, default_flow_style=False))
        return 0
    backlog = report.get("backlog", {})
    print(
        f"fragmentation: {report.get('fragmentation_score', 0.0):.4f}  "
        f"slice-alloc: {report.get('slice_alloc_success_rate', 0.0):.0%}  "
        f"live-nodes: {report.get('live_nodes', 0)}  "
        f"stranded: {report.get('stranded_node_count', 0)}"
    )
    print(
        f"backlog: depth={backlog.get('depth', 0)} "
        f"oldest={backlog.get('oldest_age_s', 0.0):.2f}s "
        f"pressure={backlog.get('pressure', 0.0):.2f}"
    )
    print()
    print(
        f"{'SHAPE':20}{'CPU(m)':>8}{'MEM(MiB)':>10}{'MIN':>5}"
        f"{'HEADROOM':>10}{'FRAG':>8}  ALLOC"
    )
    for p in report.get("probes", ()):
        print(
            f"{p.get('shape', ''):20}{p.get('cpu_milli', 0):>8.0f}"
            f"{p.get('mem_mib', 0):>10.0f}{p.get('min_member', 1):>5}"
            f"{p.get('headroom_pods', 0):>10}"
            f"{p.get('fragmentation', 0.0):>8.3f}"
            f"  {'yes' if p.get('allocatable') else 'NO'}"
        )
    stranded = report.get("stranded_nodes", ())
    if stranded:
        print()
        print(f"{'STRANDED-NODE':20}{'FREE-CPU(m)':>12}{'FREE-MEM(MiB)':>14}")
        for n in stranded:
            print(
                f"{n.get('name', ''):20}{n.get('free_cpu_milli', 0):>12.0f}"
                f"{n.get('free_mem_mib', 0):>14.0f}"
            )
    trend = report.get("trend", ())
    if trend:
        print()
        print(
            f"trend ({len(trend)} samples): "
            + " ".join(f"{v:.3f}" for v in trend[-12:])
        )
    return 0


def _fetch_rebalance_report(client: Client, args) -> Dict:
    """The rebalance report: GET /debug/rebalance over HTTP
    transports, or the process-local monitor for injected
    LocalTransport clients (same split as the capacity fetch above)."""
    transport = client.t
    get_json = getattr(transport, "get_json", None)
    if get_json is not None:
        return get_json("/debug/rebalance")
    from kubernetes_tpu_torch.utils import rebalance

    return rebalance.DEFAULT.snapshot()


def _fetch_alert_report(client: Client, args) -> Dict:
    """The alert report: GET /debug/alerts over HTTP transports, or
    the process-local engine for injected LocalTransport clients (same
    split as the slo/capacity fetches above)."""
    transport = client.t
    get_json = getattr(transport, "get_json", None)
    if get_json is not None:
        return get_json("/debug/alerts")
    from kubernetes_tpu_torch.utils import alerts

    return alerts.DEFAULT.snapshot()


def cmd_alerts(client: Client, args) -> int:
    """`ktctl alerts` — the burn-rate alerting plane: one row per
    declarative rule with its multi-window multi-burn-rate state
    (inactive/pending/firing/resolved), the observed value against the
    threshold, and the recent transition log (GET /debug/alerts).
    Exits 1 with 'no alert evaluations recorded' until the retention
    sampler has fed the engine at least one evaluation pass (the
    trace/explain/slo miss contract)."""
    report = _fetch_alert_report(client, args)
    if not report.get("sampled"):
        # Clean nonzero exit, empty stdout: a script gating on alerts
        # must see that nothing was evaluated, not a hollow all-clear.
        print("no alert evaluations recorded", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(report, indent=2))
        return 0
    if args.output == "yaml":
        print(_yaml_dump(report, default_flow_style=False))
        return 0

    def num(v):
        return "-" if v is None else f"{v:.4g}"

    print(
        f"{'RULE':26}{'SERIES':34}{'SEVERITY':9}{'STATE':10}"
        f"{'VALUE':>9}{'THRESHOLD':>10}{'SINCE':>8}"
    )
    for r in report.get("rules", ()):
        since = r.get("sinceS")
        print(
            f"{r.get('name', ''):26}{r.get('series', ''):34}"
            f"{r.get('severity', ''):9}{r.get('state', ''):10}"
            f"{num(r.get('value')):>9}{num(r.get('threshold')):>10}"
            f"{'-' if since is None else f'{since:.0f}s':>8}"
        )
    firing = report.get("firing", ())
    print(f"firing: {len(firing)}" + (f" ({' '.join(firing)})" if firing else ""))
    transitions = report.get("transitions", ())
    if transitions:
        print()
        print("RECENT TRANSITIONS")
        for t in transitions[-args.limit:]:
            print(
                f"  {t.get('rule', ''):26}{t.get('from', ''):>9} -> "
                f"{t.get('to', ''):9}value={num(t.get('value'))}"
            )
    return 0


def _fetch_health_rollup(client: Client, args) -> Dict:
    """The HA-aware health rollup: GET /debug/health over HTTP
    transports. For injected LocalTransport clients the server-side
    components (healthz subchecks, replication, leases) have no
    process-local equivalent, so the rollup degrades to the two
    process-global planes — SLO verdicts and alert state."""
    transport = client.t
    get_json = getattr(transport, "get_json", None)
    if get_json is not None:
        return get_json("/debug/health")
    from kubernetes_tpu_torch.utils import alerts, slo

    slo_report = slo.evaluate()
    alert_snap = alerts.DEFAULT.snapshot()
    slo_verdict = slo_report.get("verdict", "no_data")
    components = {
        "slo": {
            "verdict": "pass" if slo_verdict == "no_data" else slo_verdict,
            "sampled": bool(slo_report.get("sampled")),
            "objectivesBurning": [
                o["name"] for o in slo_report.get("objectives", ())
                if o.get("verdict") == "burn"
            ],
        },
        "alerts": {
            "verdict": "burn" if any(
                r.get("state") == "firing" and r.get("severity") == "page"
                for r in alert_snap.get("rules", ())
            ) else ("warn" if alert_snap.get("firing") else "pass"),
            "status": "firing" if alert_snap.get("firing") else "ok",
            "firing": list(alert_snap.get("firing", ())),
        },
    }
    return {
        "kind": "HealthRollup",
        "verdict": slo.worst(*[c["verdict"] for c in components.values()]),
        "sampled": bool(slo_report.get("sampled")) or bool(alert_snap.get("sampled")),
        "components": components,
    }


def _cmd_top_health(client: Client, args) -> int:
    """`ktctl top health` — the HA-aware health rollup: one verdict
    per control-plane component (apiserver subchecks, replication,
    leases, SLO plane, alert plane) folded into an overall cluster
    verdict (GET /debug/health). Exits 1 with 'no health samples
    recorded' until either the SLO or alert plane has measured
    anything (the trace/explain/slo miss contract)."""
    report = _fetch_health_rollup(client, args)
    if not report.get("sampled"):
        # Clean nonzero exit, empty stdout: a script gating on health
        # must see that nothing was measured, not a hollow green board.
        print("no health samples recorded", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(report, indent=2))
        return 0
    if args.output == "yaml":
        print(_yaml_dump(report, default_flow_style=False))
        return 0
    print(f"overall: {report.get('verdict', 'no_data')}")
    print()
    print(f"{'COMPONENT':16}{'VERDICT':9}DETAIL")
    for name, comp in sorted(report.get("components", {}).items()):
        detail = ""
        if name == "replication":
            lag = comp.get("maxFollowerLag")
            detail = (
                f"role={comp.get('role', '')}"
                + (f" max-follower-lag={lag}" if lag is not None else "")
            )
        elif name == "leases":
            stale = [r["name"] for r in comp.get("records", ()) if r.get("stale")]
            detail = (
                f"tracked={len(comp.get('records', ()))}"
                + (f" stale={','.join(stale)}" if stale else "")
            )
        elif name == "slo":
            burning = comp.get("objectivesBurning", ())
            detail = f"burning={','.join(burning)}" if burning else "all objectives ok"
        elif name == "alerts":
            firing = comp.get("firing", ())
            detail = f"firing={','.join(firing)}" if firing else "no alerts firing"
        elif comp.get("status"):
            detail = str(comp["status"])
        print(f"{name:16}{comp.get('verdict', ''):9}{detail}")
    return 0


def cmd_rebalance(client: Client, args) -> int:
    """`ktctl rebalance plan|status` — the rebalancing plane: the
    descheduler's last defrag plan (per-move table) or its cycle
    status (scores, move outcomes, improvement trend). Exits 1 with
    'no rebalance samples recorded' until the first executed defrag
    cycle (the trace/explain/slo/capacity miss contract)."""
    report = _fetch_rebalance_report(client, args)
    if not report.get("sampled"):
        # Clean nonzero exit, empty stdout: a script gating on defrag
        # must see that nothing ran, not a hollow table.
        print("no rebalance samples recorded", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(report, indent=2))
        return 0
    if args.output == "yaml":
        print(_yaml_dump(report, default_flow_style=False))
        return 0
    cycle = report.get("last_cycle", {})
    plan = report.get("last_plan", {})
    if args.what == "plan":
        print(
            f"score: {plan.get('score_before', 0.0):.4f} -> "
            f"{plan.get('score_after', 0.0):.4f} (forecast)  "
            f"budget: {plan.get('move_budget', 0)}  "
            f"movable: {plan.get('movable_pods', 0)}"
        )
        dropped = plan.get("dropped_partial_gangs", ())
        if dropped:
            print("dropped partial gangs: " + " ".join(dropped))
        print()
        print(f"{'POD':32}{'FROM':16}{'TO':16}{'GAIN':>6}  KIND")
        for m in plan.get("moves", ()):
            kind = "gang" if m.get("gang") else (
                "drain" if m.get("forced") else "defrag"
            )
            print(
                f"{m.get('pod', ''):32}{m.get('from', ''):16}"
                f"{m.get('to', ''):16}{m.get('gain', 0):>6}  {kind}"
            )
        return 0
    print(
        f"cycles: {report.get('samples', 0)}  last: "
        f"{cycle.get('score_before', 0.0):.4f} -> "
        f"{cycle.get('score_after', 0.0):.4f} "
        f"(improvement {cycle.get('improvement', 0.0):.4f}, "
        f"{cycle.get('moves_executed', 0)} moves, "
        f"{cycle.get('trigger', '')})"
    )
    outcomes = report.get("outcomes", {})
    if outcomes:
        print(
            "moves: "
            + "  ".join(
                f"{k}={outcomes[k]}" for k in sorted(outcomes)
            )
        )
    trend = report.get("trend", ())
    if trend:
        print(
            f"trend ({len(trend)} cycles): "
            + " ".join(f"{v:.3f}" for v in trend[-12:])
        )
    return 0


def _cmd_top_cluster(client: Client, args) -> int:
    """`ktctl top cluster` — the cluster-level resource view: SLO
    verdict table, the capacity plane's headline row, plus the raw
    telemetry-plane series from /metrics (device memory, transfer
    bytes, compile cache, watch fan-out)."""
    report = _fetch_slo_report(client, args)
    for line in _render_slo_table(report):
        print(line)
    cap = _fetch_capacity_report(client, args)
    if cap.get("sampled"):
        worst = min(
            (p for p in cap.get("probes", ())),
            key=lambda p: p.get("headroom_pods", 0),
            default=None,
        )
        head = (
            f"min-headroom {worst.get('headroom_pods', 0)} pods "
            f"({worst.get('shape', '')})"
            if worst is not None
            else "no probes"
        )
        print()
        print(
            f"CAPACITY  fragmentation={cap.get('fragmentation_score', 0.0):.4f}"
            f"  {head}  stranded-nodes={cap.get('stranded_node_count', 0)}"
        )
    transport = client.t
    if getattr(transport, "get_json", None) is not None and args.server:
        import urllib.request

        req = urllib.request.Request(
            f"{args.server}/metrics",
            headers=getattr(args, "_auth_headers", {}) or {},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            text = resp.read().decode()
    else:
        from kubernetes_tpu_torch.utils import metrics as _metrics

        text = _metrics.DEFAULT.render()
    shown = [
        line
        for line in text.splitlines()
        if not line.startswith("#")
        and line.startswith(_TOP_CLUSTER_PREFIXES)
    ]
    if shown:
        print()
        print("TELEMETRY")
        for line in shown:
            print(line)
    return 0


def cmd_config(client: Client, args) -> int:
    """Reference: pkg/kubectl/cmd/config/ — view / set-cluster /
    set-credentials / set-context / use-context / set / unset over the
    kubeconfig file."""
    from kubernetes_tpu_torch.client import kubeconfig as kc

    path = kc.config_path(args.kubeconfig)
    data = kc.load_raw(path)
    sub = args.config_cmd
    if sub == "view":
        print(json.dumps(data, indent=2, sort_keys=True))
        return 0
    if sub == "use-context":
        if kc._by_name(data.get("contexts"), args.cname) is None:
            print(f'error: no context exists with the name: "{args.cname}"',
                  file=sys.stderr)
            return 1
        data["current-context"] = args.cname
        kc.save_raw(path, data)
        print(f'Switched to context "{args.cname}"')
        return 0
    if sub == "set-cluster":
        body = {}
        if args.server_url:
            body["server"] = args.server_url
        kc.set_entry(data, "clusters", args.cname, "cluster", body)
        kc.save_raw(path, data)
        print(f'Cluster "{args.cname}" set')
        return 0
    if sub == "set-credentials":
        body = {}
        if args.username:
            body["username"] = args.username
        if args.password:
            body["password"] = args.password
        if args.token:
            body["token"] = args.token
        kc.set_entry(data, "users", args.cname, "user", body)
        kc.save_raw(path, data)
        print(f'User "{args.cname}" set')
        return 0
    if sub == "set-context":
        body = {}
        if args.cluster:
            body["cluster"] = args.cluster
        if args.user:
            body["user"] = args.user
        if args.ctx_namespace:
            body["namespace"] = args.ctx_namespace
        kc.set_entry(data, "contexts", args.cname, "context", body)
        kc.save_raw(path, data)
        print(f'Context "{args.cname}" set')
        return 0
    if sub in ("set", "unset"):
        # Dotted-path property access (config/set.go navigation steps);
        # the useful subset: top-level keys like current-context.
        if "." in args.prop:
            print(f"error: only top-level properties supported: {args.prop!r}",
                  file=sys.stderr)
            return 1
        if sub == "set":
            data[args.prop] = args.value
        else:
            data.pop(args.prop, None)
        kc.save_raw(path, data)
        print(f'Property "{args.prop}" {sub}')
        return 0
    raise SystemExit(f"unknown config subcommand {sub!r}")


# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    # Global flags live on a parent parser attached to every
    # subcommand, so `ktctl get pods -o yaml` parses naturally.
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--server", "-s", default=None)
    common.add_argument("--namespace", "-n", default=None)
    common.add_argument("--kubeconfig", default=None)
    common.add_argument("--context", default=None)
    common.add_argument("--output", "-o", default="table",
                        choices=["table", "json", "yaml", "name"])
    p = argparse.ArgumentParser(prog="ktctl", description="kubernetes-tpu CLI")
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("get", parents=[common])
    g.add_argument("resource")
    g.add_argument("name", nargs="?")
    g.add_argument("--selector", "-l")
    g.add_argument("--all-namespaces", "-A", action="store_true")
    g.add_argument("--watch", "-w", action="store_true",
                   help="after listing, watch for changes")
    g.add_argument("--watch-only", action="store_true",
                   help="watch without the initial list")
    g.add_argument("--watch-events", type=int, default=None,
                   help=argparse.SUPPRESS)  # exit after N events (tests)
    g.set_defaults(fn=cmd_get)

    c = sub.add_parser("create", parents=[common])
    c.add_argument("--filename", "-f", required=True)
    c.set_defaults(fn=cmd_create)

    a = sub.add_parser("apply", parents=[common])
    a.add_argument("--filename", "-f", required=True)
    a.set_defaults(fn=cmd_apply)

    d = sub.add_parser("delete", parents=[common])
    d.add_argument("resource", nargs="?")
    d.add_argument("name", nargs="?")
    d.add_argument("--filename", "-f")
    d.add_argument("--selector", "-l")
    d.add_argument(
        "--grace-period", type=int, default=None,
        help="seconds a bound pod stays Terminating before removal "
        "(0 = immediate; pods only)",
    )
    d.set_defaults(fn=cmd_delete)

    ds = sub.add_parser("describe", parents=[common])
    ds.add_argument("resource")
    ds.add_argument("name")
    ds.set_defaults(fn=cmd_describe)

    sc = sub.add_parser("scale", parents=[common])
    sc.add_argument("resource")
    sc.add_argument("name")
    sc.add_argument("--replicas", type=int, required=True)
    sc.set_defaults(fn=cmd_scale)

    lb = sub.add_parser("label", parents=[common])
    lb.add_argument("resource")
    lb.add_argument("name")
    lb.add_argument("labels", nargs="+")
    lb.add_argument("--overwrite", action="store_true")
    lb.set_defaults(fn=cmd_label)

    ex = sub.add_parser("expose", parents=[common])
    ex.add_argument("resource")  # only rc supported
    ex.add_argument("name")
    ex.add_argument("--port", type=int, required=True)
    ex.add_argument("--target-port", type=int)
    ex.add_argument("--service-name")
    ex.set_defaults(fn=cmd_expose)

    rn = sub.add_parser("run", parents=[common])
    rn.add_argument("name")
    rn.add_argument("--image", required=True)
    rn.add_argument("--replicas", "-r", type=int, default=1)
    rn.add_argument("--cpu", default="100m")
    rn.add_argument("--memory", default="64Mi")
    rn.set_defaults(fn=cmd_run)

    ru = sub.add_parser("rolling-update", parents=[common])
    ru.add_argument("name")
    ru.add_argument("--filename", "-f", default=None)
    ru.add_argument("--image", default=None)
    ru.add_argument("--poll-interval", type=float, default=0.2)
    ru.add_argument("--timeout", type=float, default=60.0)
    ru.set_defaults(fn=cmd_rolling_update)

    st = sub.add_parser("stop", parents=[common])
    st.add_argument("resource")
    st.add_argument("name")
    st.add_argument("--timeout", type=float, default=30.0)
    st.set_defaults(fn=cmd_stop)

    lg = sub.add_parser("logs", parents=[common])
    lg.add_argument("name")
    lg.add_argument("--container", "-c", default="")
    lg.add_argument("--tail", type=int, default=None)
    lg.add_argument("--follow", "-f", action="store_true",
                    help="stream new lines until the pod goes away")
    lg.add_argument("--follow-rounds", type=int, default=None,
                    help=argparse.SUPPRESS)  # exit after N polls (tests)
    lg.set_defaults(fn=cmd_logs)

    ee = sub.add_parser("exec", parents=[common])
    ee.add_argument("name")
    ee.add_argument("--container", "-c", default="")
    ee.add_argument("cmd", nargs="+")
    ee.set_defaults(fn=cmd_exec)

    tp = sub.add_parser("top", parents=[common])
    tp.add_argument(
        "what", choices=["nodes", "pods", "cluster", "capacity", "health"]
    )
    tp.set_defaults(fn=cmd_top)

    sl = sub.add_parser("slo", parents=[common])
    sl.set_defaults(fn=cmd_slo)

    al = sub.add_parser("alerts", parents=[common])
    al.add_argument("--limit", type=int, default=16,
                    help="transitions to show, newest last")
    al.set_defaults(fn=cmd_alerts)

    rb = sub.add_parser("rebalance", parents=[common])
    rb.add_argument("what", nargs="?", default="status",
                    choices=["plan", "status"])
    rb.set_defaults(fn=cmd_rebalance)

    pf2 = sub.add_parser("profile", parents=[common])
    pf2.add_argument(
        "what", nargs="?", default="kernels",
        choices=["kernels", "cpu", "device"],
    )
    pf2.add_argument("--seconds", type=float, default=2.0)
    pf2.add_argument(
        "--format", dest="fmt", default="top",
        choices=["top", "collapsed"],
        help="cpu profile rendering: human-readable or folded stacks",
    )
    pf2.set_defaults(fn=cmd_profile)

    tc = sub.add_parser("trace", parents=[common])
    tc.add_argument("name", nargs="?", help="pod name (omit for all)")
    tc.add_argument("--limit", type=int, default=16)
    tc.set_defaults(fn=cmd_trace)

    xp = sub.add_parser("explain", parents=[common])
    xp.add_argument("resource", help="pods (or an alias)")
    xp.add_argument("name")
    xp.add_argument("--limit", type=int, default=1,
                    help="decisions to show, newest first")
    xp.set_defaults(fn=cmd_explain)

    pf = sub.add_parser("port-forward", parents=[common])
    pf.add_argument("name")
    pf.add_argument("ports", help="LOCAL:REMOTE (or one port for both)")
    pf.set_defaults(fn=cmd_port_forward)

    ar = sub.add_parser("api-resources", parents=[common])
    ar.set_defaults(fn=cmd_api_resources)

    vs = sub.add_parser("version", parents=[common])
    vs.set_defaults(fn=cmd_version)

    av = sub.add_parser("api-versions", parents=[common])
    av.set_defaults(fn=cmd_api_versions)

    ci = sub.add_parser("cluster-info", parents=[common])
    ci.set_defaults(fn=cmd_cluster_info)

    nsp = sub.add_parser("namespace", parents=[common])
    nsp.add_argument("ns", nargs="?")
    nsp.set_defaults(fn=cmd_namespace)

    up = sub.add_parser("update", parents=[common])
    up.add_argument("resource", nargs="?")
    up.add_argument("name", nargs="?")
    up.add_argument("--filename", "-f", default=None)
    up.add_argument("--patch", default=None, help="JSON merge patch")
    up.set_defaults(fn=cmd_update)

    px = sub.add_parser("proxy", parents=[common])
    px.add_argument("--port", "-p", type=int, default=8001)
    px.add_argument("--api-prefix", default="/api")
    px.set_defaults(fn=cmd_proxy)

    cf = sub.add_parser("config", parents=[common])
    cfs = cf.add_subparsers(dest="config_cmd", required=True)
    cfs.add_parser("view")
    for name in ("set-cluster", "set-credentials", "set-context", "use-context"):
        cp = cfs.add_parser(name)
        cp.add_argument("cname")
        if name == "set-cluster":
            cp.add_argument("--server-url", "--cluster-server", dest="server_url")
        elif name == "set-credentials":
            cp.add_argument("--username")
            cp.add_argument("--password")
            cp.add_argument("--token")
        elif name == "set-context":
            cp.add_argument("--cluster")
            cp.add_argument("--user")
            cp.add_argument("--ctx-namespace", "--set-namespace",
                            dest="ctx_namespace")
    for name in ("set", "unset"):
        cp = cfs.add_parser(name)
        cp.add_argument("prop")
        if name == "set":
            cp.add_argument("value")
    cf.set_defaults(fn=cmd_config, local_only=True)
    nsp.set_defaults(local_only=True)
    return p


def main(argv: Optional[List[str]] = None, client: Optional[Client] = None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "local_only", False):
        # config/namespace operate on the kubeconfig file only — no
        # server connection (and no requirement that one exists).
        from kubernetes_tpu_torch.client.kubeconfig import KubeconfigError

        try:
            return args.fn(client, args)
        except (OSError, KubeconfigError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if client is None:
        # kubeconfig resolution (pkg/client/clientcmd): explicit flags
        # win, then the file's current-context, then local defaults.
        # Skipped entirely for injected clients (tests/embedding must
        # not pick up the operator's personal config).
        from kubernetes_tpu_torch.client.kubeconfig import (
            KubeconfigError,
            load_kubeconfig,
        )

        try:
            cfg = load_kubeconfig(args.kubeconfig, context=args.context)
        except KubeconfigError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if args.server is None:
            args.server = cfg.server
        if args.namespace is None:
            args.namespace = cfg.namespace or "default"
        args._auth_headers = cfg.auth_headers()
        client = Client(HTTPTransport(args.server, headers=args._auth_headers))
    if args.namespace is None:
        args.namespace = "default"
    try:
        return args.fn(client, args)
    except APIError as e:
        print(f"Error from server ({e.reason}): {e.message}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # stdout consumer went away (logs -f | head): end quietly.
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0
    except (OSError, ConnectionError) as e:
        print(f"Unable to connect to server {args.server}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
