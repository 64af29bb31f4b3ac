"""ktchaos: a process-global, deterministically seeded fault registry.

The control plane now has real recovery machinery — WAL replay with
torn-line truncation, watch re-list on drops, bind CAS, gang rollback,
graceful-delete confirmation — but until this module, none of it was
*driven*: the code paths only ran when the world happened to misbehave.
This registry turns each recovery seam into a named injection site that
tests and the soak harness (`soak.py`) can fire on a seeded,
reproducible schedule.

Mirrors the ``KT_SANITIZE`` pattern (utils/sanitizer.py): OFF by
default with one module-global check per ``fire()`` call, so
instrumenting hot paths (WAL append, watch push, heartbeats) costs a
predicate and nothing else. ON via ``KT_FAULTS=<spec>`` in the
environment or the programmatic API (:func:`inject` / :func:`configure`).

Sites are REGISTERED NAMED CONSTANTS in this module — ``faults.fire(
faults.WAL_FSYNC)``, never ``faults.fire("kvstore.wal.fsync")`` — so
the site inventory stays auditable exactly like the sanitizer's lock
names (the JAX package's ktlint rule KT008 holds it there; here
:func:`inject` refuses a string).

Determinism: every site owns its own ``random.Random`` seeded from
``(seed, site name)`` and its own call counter, so the firing schedule
at one site is a pure function of (seed, rule, per-site call index) —
independent of how OTHER sites' calls interleave across threads. The
soak harness's acceptance bar ("same seed reproduces the same fault
timeline") rests on this.

Rule grammar (``KT_FAULTS`` / :func:`configure`)::

    seed=42;kvstore.wal.fsync:p=0.01,times=3;http.request.latency:every=7,delay=0.02

``;``-separated rules, each ``<site>:<k>=<v>,...`` with knobs

- ``p``      per-call firing probability (site-seeded RNG);
- ``every``  fire every Nth eligible call (deterministic cadence);
- ``times``  stop after N firings (budget);
- ``after``  skip the first N calls at the site;
- ``delay``  sleep seconds for delay-kind sites (default 0.02).

What firing DOES is the site's declared kind:

- ``error``  raise the site's exception (``FaultInjected`` /
  ``InjectedIOError`` / an injected ``APIError``/``ConnectionError``);
- ``delay``  sleep ``delay`` seconds, then proceed;
- ``trip``   return True — the call site interprets it (torn WAL
  write, forced watch-stream drop, skipped heartbeat).

``fire()`` returns False when disabled or nothing fired, so call sites
read ``if faults.fire(faults.X): <site-specific behavior>``.

A copy of `kubernetes_tpu/utils/faults.py`. The 15 site names, their
kinds, the rule grammar and the per-site seeding are JAX's, so one spec
and seed arm the same sites and fire them at the same per-site call
indices in both packages. Departure: ``http.request.error5xx`` raises
the CLIENT's ``APIError`` (`client/rest.py`), not the server's, because
it fires inside the client's retry loop and the port's transports
retry and catch only the client's class. The seams sit in the port's
counterparts of JAX's modules: `store/kvstore.py`, `store/watch.py`,
`client/rest.py`, `scheduler/daemon.py`, `controllers/descheduler.py`,
`kubelet/agent.py`, `utils/lease.py` and `utils/timeseries.py`; the
soak harness, `kubernetes_tpu_torch/soak.py`, drives them.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "FaultInjected",
    "InjectedIOError",
    "FaultSite",
    "SITES",
    "clear",
    "configure",
    "enabled",
    "fire",
    "inject",
    "reset_stats",
    "rules",
    "stats",
    "timeline",
]


class FaultInjected(Exception):
    """An injected failure (never raised by real code paths); carries
    the site name so logs/tests can tell chaos from genuine faults."""


class InjectedIOError(FaultInjected, OSError):
    """Injected I/O failure — an OSError so the code under test takes
    its real I/O-error path (WAL fsync, snapshot rename)."""


def _api_error_503(site: str):
    # Lazy import: utils must stay importable below the client layer.
    # The client's class: the site fires inside the client's retry loop.
    from kubernetes_tpu_torch.client.rest import APIError

    return APIError(
        503, "ServiceUnavailable", f"fault injected at {site}"
    )


class FaultSite:
    """A named injection point. Instances are the module constants
    below — the one place sites are minted (KT008)."""

    __slots__ = ("name", "kind", "exc", "doc")

    def __init__(self, name: str, kind: str, exc=None, doc: str = ""):
        assert kind in ("error", "delay", "trip")
        self.name = name
        self.kind = kind
        self.exc = exc  # callable(site_name) -> Exception, for "error"
        self.doc = doc

    def __repr__(self) -> str:
        return f"<FaultSite {self.name} [{self.kind}]>"


#: name -> FaultSite; populated by _site() only (module constants).
SITES: Dict[str, FaultSite] = {}


def _site(name: str, kind: str, exc=None, doc: str = "") -> FaultSite:
    site = FaultSite(name, kind, exc=exc, doc=doc)
    SITES[name] = site
    return site


def _fi(site: str) -> Exception:
    return FaultInjected(f"fault injected at {site}")


def _io(site: str) -> Exception:
    return InjectedIOError(f"fault injected at {site}")


def _reset(site: str) -> Exception:
    return ConnectionResetError(f"fault injected at {site}")


# -- the site inventory -------------------------------------------------
# kvstore durability seams (store/kvstore.py):
WAL_TORN_WRITE = _site(
    "kvstore.wal.torn_write", "trip",
    doc="append only a prefix of the WAL record (no newline) and raise "
        "— the mid-append process death _recover()'s torn-line "
        "truncation exists for; pair with KVStore.crash()",
)
WAL_FSYNC = _site(
    "kvstore.wal.fsync", "error", exc=_io,
    doc="group-commit fsync fails; the acking writer surfaces a real "
        "I/O error and the write is flushed-but-not-durable",
)
SNAPSHOT_RENAME = _site(
    "kvstore.snapshot.rename", "error", exc=_io,
    doc="crash before the snapshot's os.replace — recovery must keep "
        "serving from the previous snapshot + full WAL",
)
# watch fan-out (store/watch.py):
WATCH_DROP = _site(
    "watch.stream.drop", "trip",
    doc="force the slow-consumer drop on a store-fed stream; the "
        "consumer must re-list (Reflector backoff path)",
)
WATCH_DELAY = _site(
    "watch.stream.delay", "delay",
    doc="stall event delivery on the dispatcher thread",
)
# client HTTP transport (client/rest.py):
HTTP_RESET = _site(
    "http.request.reset", "error", exc=_reset,
    doc="connection reset before the request is sent; idempotent "
        "verbs retry with capped jittered backoff",
)
HTTP_5XX = _site(
    "http.request.error5xx", "error", exc=_api_error_503,
    doc="transient server 5xx; idempotent verbs retry with backoff",
)
HTTP_DELAY = _site(
    "http.request.latency", "delay",
    doc="added request latency on the client transport",
)
# scheduler commit path (scheduler/daemon.py):
SCHED_COMMIT_CRASH = _site(
    "scheduler.commit.crash", "error", exc=_fi,
    doc="daemon dies between solve and commit: the commit job raises "
        "before any bind lands — recovery is a daemon restart that "
        "rebuilds its SolverSession from LIST+watch",
)
SCHED_EVICT_ERROR = _site(
    "scheduler.evict.error", "error", exc=_fi,
    doc="victim eviction fails transiently; the preemption pass must "
        "count evict_failed and retry without recording a nomination",
)
# descheduler move execution (controllers/descheduler.py):
DESCHED_MOVE_CRASH = _site(
    "descheduler.move.crash", "error", exc=_fi,
    doc="descheduler dies mid-move, after the eviction but before the "
        "replacement pod is recreated — the journaled move intent "
        "(PodTemplate) must let recovery re-pend the pod so a crashed "
        "defrag strands nothing",
)
# kubelet sync loop (kubelet/agent.py):
KUBELET_TERMINATING_STALL = _site(
    "kubelet.terminating.stall", "delay",
    doc="the Terminating confirm path stalls; grace-deadline handling "
        "and exactly-one-DELETED must survive the lag",
)
KUBELET_HEARTBEAT_DROP = _site(
    "kubelet.heartbeat.drop", "trip",
    doc="skip a node status heartbeat (lost beat, not a dead kubelet)",
)
# lease-based leader election (utils/lease.py):
LEASE_RENEW_LOST = _site(
    "lease.renew.lost", "error", exc=_fi,
    doc="the holder's renew CAS is lost in flight (network partition "
        "from the lease store); the holder must demote itself once the "
        "lease window expires on its own clock, never before",
)
LEASE_CLOCK_SKEW = _site(
    "lease.clock.skew", "trip",
    doc="the holder's local clock runs slow by one lease duration: it "
        "believes it still holds an expired lease while a rival steals "
        "it — the fencing token is what keeps its stale writes out",
)
# health-plane retention sampler (utils/timeseries.py):
TIMESERIES_SAMPLE_SKIP = _site(
    "timeseries.sample.skip", "trip",
    doc="the retention sampler misses a cadence beat (GC pause / "
        "stalled scrape analog); windowed queries must degrade to the "
        "surviving samples, never extrapolate through the gap",
)


# -- rule state ---------------------------------------------------------


class FaultRule:
    """One armed rule at one site. Mutable counters are guarded by the
    module lock; the parameters are frozen at install."""

    __slots__ = ("site", "p", "every", "times", "after", "delay_s", "fired")

    def __init__(
        self,
        site: FaultSite,
        p: float = 0.0,
        every: int = 0,
        times: Optional[int] = None,
        after: int = 0,
        delay_s: float = 0.02,
    ):
        if p <= 0.0 and every <= 0:
            raise ValueError(
                f"rule at {site.name}: need p= or every= to ever fire"
            )
        self.site = site
        self.p = float(p)
        self.every = int(every)
        self.times = None if times is None else int(times)
        self.after = int(after)
        self.delay_s = float(delay_s)
        self.fired = 0

    def describe(self) -> dict:
        return {
            "site": self.site.name,
            "p": self.p,
            "every": self.every,
            "times": self.times,
            "after": self.after,
            "delay_s": self.delay_s,
            "fired": self.fired,
        }


class _SiteState:
    __slots__ = ("calls", "fired", "rng")

    def __init__(self, seed: int, name: str):
        self.calls = 0
        self.fired = 0
        self.rng = random.Random(f"{seed}:{name}")


#: Master switch — a plain module global, read on every fire() (the
#: zero-cost-when-off contract, same shape as sanitizer._enabled).
_enabled = False

_lock = threading.Lock()
_seed = 0
_rules: Dict[str, List[FaultRule]] = {}
_state: Dict[str, _SiteState] = {}
#: Bounded fired-event log: (site name, per-site call index). The soak
#: artifact records it as the realized fault timeline.
_timeline: List[Tuple[str, int]] = []
_MAX_TIMELINE = 4096


def enabled() -> bool:
    return _enabled


def _state_for_locked(name: str) -> _SiteState:
    st = _state.get(name)
    if st is None:
        st = _state[name] = _SiteState(_seed, name)
    return st


def inject(site: FaultSite, **kw) -> FaultRule:
    """Arm a rule at `site` (see FaultRule knobs) and enable the
    registry. Returns the rule (live counters) so tests can assert
    `rule.fired`."""
    global _enabled
    if not isinstance(site, FaultSite):
        raise TypeError(
            "inject() takes a registered FaultSite constant "
            "(faults.WAL_FSYNC, ...), not a string — KT008"
        )
    rule = FaultRule(site, **kw)
    with _lock:
        _rules.setdefault(site.name, []).append(rule)
        _state_for_locked(site.name)
        _enabled = True
    return rule


def clear(site: Optional[FaultSite] = None) -> None:
    """Disarm rules (one site, or all) — the registry disables itself
    when no rule remains armed. Per-site call counters and the timeline
    survive until reset_stats()."""
    global _enabled
    with _lock:
        if site is None:
            _rules.clear()
        else:
            _rules.pop(site.name, None)
        if not _rules:
            _enabled = False


def reset_stats(reseed: Optional[int] = None) -> None:
    """Drop counters, per-site RNG state and the timeline (a fresh
    deterministic run); optionally install a new seed."""
    global _seed
    with _lock:
        if reseed is not None:
            _seed = int(reseed)
        _state.clear()
        del _timeline[:]
        for rs in _rules.values():
            for r in rs:
                r.fired = 0


def configure(spec: str, seed: Optional[int] = None) -> None:
    """Parse a KT_FAULTS-style spec and arm it (replacing any armed
    rules). Empty spec = disarm."""
    clear()
    if seed is not None:
        reset_stats(reseed=seed)
    for part in (spec or "").replace("\n", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            reset_stats(reseed=int(part[5:]))
            continue
        name, _, knobs = part.partition(":")
        name = name.strip()
        site = SITES.get(name)
        if site is None:
            raise ValueError(
                f"KT_FAULTS: unknown fault site {name!r} "
                f"(known: {', '.join(sorted(SITES))})"
            )
        kw: dict = {}
        for knob in knobs.split(","):
            knob = knob.strip()
            if not knob:
                continue
            k, _, v = knob.partition("=")
            k = k.strip()
            if k == "p":
                kw["p"] = float(v)
            elif k == "every":
                kw["every"] = int(v)
            elif k == "times":
                kw["times"] = int(v)
            elif k == "after":
                kw["after"] = int(v)
            elif k == "delay":
                kw["delay_s"] = float(v)
            else:
                raise ValueError(f"KT_FAULTS: unknown knob {k!r} in {part!r}")
        inject(site, **kw)


def fire(site: FaultSite, detail: str = "") -> bool:
    """Consult the armed rules for `site`. No-op (False) when the
    registry is off — the only cost hot paths pay. When a rule fires:
    error-kind sites RAISE, delay-kind sites sleep then return True,
    trip-kind sites return True for the call site to interpret."""
    if not _enabled:
        return False
    delay_s = 0.0
    fired = None
    with _lock:
        site_rules = _rules.get(site.name)
        st = _state_for_locked(site.name)
        st.calls += 1
        if not site_rules:
            return False
        for rule in site_rules:
            if st.calls <= rule.after:
                continue
            if rule.times is not None and rule.fired >= rule.times:
                continue
            eligible = st.calls - rule.after
            if rule.every > 0:
                if eligible % rule.every != 0:
                    continue
            elif not (rule.p > 0.0 and st.rng.random() < rule.p):
                continue
            rule.fired += 1
            st.fired += 1
            if len(_timeline) < _MAX_TIMELINE:
                _timeline.append((site.name, st.calls))
            fired = rule
            delay_s = rule.delay_s
            break
    if fired is None:
        return False
    if site.kind == "error":
        raise site.exc(site.name if not detail else f"{site.name}: {detail}")
    if site.kind == "delay":
        time.sleep(delay_s)
    return True


def rules() -> List[dict]:
    with _lock:
        return [r.describe() for rs in _rules.values() for r in rs]


def stats() -> Dict[str, dict]:
    """Per-site {calls, fired} counters (the soak artifact's
    faults-injected figure)."""
    with _lock:
        return {
            name: {"calls": st.calls, "fired": st.fired}
            for name, st in sorted(_state.items())
        }


def timeline() -> List[Tuple[str, int]]:
    """The realized fault timeline: (site, per-site call index) per
    firing, in process order (bounded)."""
    with _lock:
        return list(_timeline)


# -- env arming ---------------------------------------------------------

_env_spec = os.environ.get("KT_FAULTS", "")
if _env_spec:
    configure(_env_spec)
