"""Deterministic fault injection: exercise every recovery path in tests.

The port's copy of the JAX package's ``utils/faultinject.py``.  Named
**sites** sit at the serve stack's failure points (dispatch, fused
dispatch, the wire's send and receive paths, stream steps), and a seeded,
deterministic **fault plan** decides which site hits raise, stall, or
enact a chaos kind.  The site table keeps the JAX package's names, the
sites the port has not planted yet included.

Zero cost when inactive: ``site()`` is one module-global ``None`` check.

A plan is a list of fault specs::

    plan = FaultPlan([
        Fault(site="serve_dispatch", kind="raise", after=1),   # 2nd hit
        Fault(site="serve_dispatch", kind="device_restart", after=3),
    ])
    with plan.active():
        batcher.submit(...)

Fault kinds:
  * ``raise``   — raise ``InjectedFault`` (classified TRANSIENT: simulates
    worker death; retry/resume paths must recover);
  * ``deterministic`` — raise ``InjectedDeterministicFault`` (a ValueError:
    simulates a program bug; retry must fail FAST);
  * ``stall``   — sleep ``stall_s`` at the site (simulates a hung worker;
    drain watchdogs must fire).  At a serve dispatch site this IS the
    ``stalled_dispatch`` chaos primitive — the stall plus the watchdog
    deadline turn into a ``WatchdogTimeout`` the re-dispatch path recovers;
  * ``truncate``— only honored by ``SweepCheckpoint`` appends: write a
    partial line then raise (simulates a kill mid-append; the loader must
    skip the torn line);
  * serve/network/device chaos kinds — enacted by the SITE
    owner, which passes a handler per kind it can perform (``site(name,
    actions={...})``); a chaos kind fired at a site with no handler for it
    degrades to ``raise`` so a misplanned schedule still fails loudly:

      - ``conn_drop``      the server hard-closes the TCP connection
                           (client reconnect + resubmit must recover);
      - ``torn_frame``     the server writes a torn frame (header + partial
                           body) then drops the connection;
      - ``session_evict``  the serving session is evicted from the cache
                           mid-flight (the rebuild path must serve it);
      - ``device_restart`` ``reset_device_state()`` runs (every uploaded
                           buffer conceptually dies) and the dispatch
                           fails transiently — the self-healing probe must
                           recompile sessions without operator action;
      - ``mesh_device_loss`` raise ``resilience.MeshDeviceLoss``
                           (classified "resource": retrying the same mesh
                           cannot help, replanning onto surviving devices
                           can) — the elastic mesh-degrade primitive;
      - ``stream_kill``    the server kills a stream step mid-window: the
                           in-flight (uncommitted) window is dropped and
                           the connection hard-closes — the client must
                           resume from the last committed cycle via the
                           ``stream_commit`` watermark, exactly once;
      - ``host_kill``      a whole serving host dies hard —
                           server tasks cancelled before the batcher
                           closes, so clients see transport death, never
                           structured errors; the fleet router's deadman-
                           driven handoff must re-home the host's
                           families onto their successors exactly-once;
      - ``journal_lag``    the router's journal-replication
                           step fails, so the successor's copy of the
                           (tenant, session, idem) journal falls behind —
                           a handoff must then BLOCK on watermark
                           catch-up instead of serving stale answers;
      - ``router_partition`` the router routes one frame on a
                           stale placement (a partitioned router's view):
                           the old owner's epoch fence must refuse it
                           (``route_stale``) and the router re-resolve +
                           re-forward, never double-decode.

All literal site names live in the ``SITES`` table below: every
``faultinject.site("...")`` literal in the package is registered here
and used at exactly ONE call site — a typo'd site name
would otherwise silently never fire.

Env activation for subprocesses / CI: ``QLDPC_FAULT_PLAN`` holds the plan as
JSON (``[{"site": "megabatch_dispatch", "kind": "raise", "after": 1}]`` or
``{"seed": 0, "faults": [...]}``); it is installed on first ``site()`` call.
Every injection emits a ``faultinject.injected`` counter + ``fault_injected``
event so test assertions can see exactly what fired.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading

from . import telemetry, tracing
from .resilience import MeshDeviceLoss, TransientFault, sleep_for

__all__ = [
    "InjectedFault",
    "InjectedDeterministicFault",
    "Fault",
    "FaultPlan",
    "SITES",
    "active_plan",
    "activate",
    "deactivate",
    "site",
    "truncate_fraction",
]


# ---------------------------------------------------------------------------
# The one site table:
# every literal site name passed to ``site()`` / ``truncate_fraction()``
# anywhere in the package must be a key here, and each name must appear at
# exactly one call site — one name, one failure point, so a fault plan (or
# a chaos schedule) can never silently target nothing.  Engine-level sites
# ("wer.data", ...) are minted dynamically via ``resilient_engine_run`` and
# are deliberately NOT listed: the rule only constrains literals.
SITES = {
    "megabatch_dispatch": "parallel/shots.py MegabatchDriver dispatch",
    "megabatch_drain": "parallel/shots.py run_keys double-buffered drain",
    "fused_cells_launch": "sim/common.py fused bucket async launch",
    "fused_cells_drain": "sim/common.py fused bucket carry fetch",
    "windowed_launch": "sim/common.py windowed (host-OSD) batch launch",
    "windowed_drain": "sim/common.py windowed (host-OSD) batch drain",
    "mesh_dispatch": "sim/common.py mesh_batch_stats sharded dispatch",
    "mesh_replay_dispatch": "sim/common.py mesh-degrade replay dispatch",
    "sweep_ckpt_put": "utils/checkpoint.py JSONL append",
    "serve_dispatch": "serve/scheduler.py per-session batch dispatch",
    "serve_fused_dispatch": "serve/scheduler.py cross-session fused dispatch",
    "serve_conn_rx": "serve/server.py per-received-frame (network chaos)",
    "serve_respond": "serve/server.py before a response frame is written",
    "serve_stream_step": "serve/server.py stream chunk, before decode/commit",
    "router_route": "serve/router.py per-forwarded-frame (routing chaos)",
    "router_replicate": "serve/router.py journal replication pull/push step",
    "fleet_host_tick": "serve/router.py LocalFleet chaos tick (host_kill)",
}


class InjectedFault(TransientFault):
    """Injected transient infrastructure fault (simulated worker death)."""


class InjectedDeterministicFault(ValueError):
    """Injected deterministic bug (retry must fail fast, not back off)."""


class Fault:
    """One fault spec: fire at hits ``after < n <= after + count`` of
    ``site`` (``after=0, count=1`` = first hit only)."""

    KINDS = ("raise", "deterministic", "stall", "truncate",
             "conn_drop", "torn_frame", "session_evict", "device_restart",
             "mesh_device_loss", "stream_kill",
             "host_kill", "journal_lag", "router_partition")

    def __init__(self, site: str, kind: str = "raise", after: int = 0,
                 count: int = 1, stall_s: float = 0.25,
                 truncate_at: float = 0.5, message: str = "",
                 target: str = ""):
        if kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {self.KINDS})")
        self.site = str(site)
        self.kind = kind
        self.after = int(after)
        self.count = int(count)
        self.stall_s = float(stall_s)
        self.truncate_at = float(truncate_at)
        self.message = message or f"injected {kind} at {site}"
        # optional aim point for site handlers that pick a victim — e.g. a
        # host_kill handler kills this family's (or label's) host instead
        # of its default choice; plain data, the site's handler interprets
        self.target = str(target)

    def matches(self, hit: int) -> bool:
        return self.after < hit <= self.after + self.count

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        return cls(**d)


class FaultPlan:
    """Deterministic plan: per-site hit counters decide which spec fires.
    ``seed`` is recorded with every event so a failing CI run names the
    exact plan that produced it (hit counting itself is already
    deterministic)."""

    def __init__(self, faults, seed: int = 0):
        self.seed = int(seed)
        self.faults = [f if isinstance(f, Fault) else Fault.from_dict(f)
                       for f in faults]
        self._hits: dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        if isinstance(data, dict):
            return cls(data.get("faults", []), seed=int(data.get("seed", 0)))
        return cls(data)

    def hits(self, site_name: str) -> int:
        with self._lock:
            return self._hits.get(site_name, 0)

    def _fire(self, site_name: str) -> "Fault | None":
        with self._lock:
            hit = self._hits.get(site_name, 0) + 1
            self._hits[site_name] = hit
        for fault in self.faults:
            if fault.site == site_name and fault.matches(hit):
                return fault
        return None

    def active(self):
        return active_plan(self)


_ACTIVE: FaultPlan | None = None
_ENV_CHECKED = False


def activate(plan: FaultPlan) -> None:
    global _ACTIVE
    _ACTIVE = plan


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def active_plan(plan: FaultPlan):
    """Scope a plan; restores the previous one (env-installed or None)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def _maybe_install_env_plan() -> None:
    """Install the QLDPC_FAULT_PLAN env plan once (subprocess activation)."""
    global _ENV_CHECKED, _ACTIVE
    _ENV_CHECKED = True
    text = os.environ.get("QLDPC_FAULT_PLAN", "").strip()
    if not text:
        return
    if os.path.exists(text):
        with open(text, encoding="utf-8") as fh:
            text = fh.read()
    _ACTIVE = FaultPlan.from_json(text)


def _record(fault: Fault, site_name: str) -> None:
    telemetry.count("faultinject.injected")
    telemetry.count(f"faultinject.{fault.kind}")
    telemetry.event("fault_injected", site=site_name, fault_kind=fault.kind,
                    seed=_ACTIVE.seed if _ACTIVE else 0)
    # the injection itself goes into the flight-recorder ring so the
    # postmortem a downstream failure ships names the fault that caused it
    tracing.flight_record("fault_injected", site=site_name,
                          fault_kind=fault.kind)


def _perform(fault: Fault, name: str, actions=None) -> None:
    """Enact one matched fault.  ``actions`` maps chaos kinds the SITE can
    perform to handlers (the handler enacts the chaos — dropping the
    connection, evicting the session, resetting device state — and may
    itself raise); chaos kinds without a handler here degrade to ``raise``
    so a schedule aimed at the wrong site still fails loudly instead of
    silently doing nothing.  ``actions`` wins over the built-in ``stall``
    sleep: an ASYNC site (the serve front-end's event loop) must perform
    the stall as an awaited sleep on one connection, never a blocking
    ``sleep_for`` that freezes every connection on the loop thread."""
    _record(fault, name)
    if actions and fault.kind in actions:
        actions[fault.kind](fault)
        return
    if fault.kind == "stall":
        sleep_for(fault.stall_s)
        return
    if fault.kind == "deterministic":
        raise InjectedDeterministicFault(fault.message)
    if fault.kind == "mesh_device_loss":
        raise MeshDeviceLoss(fault.message)
    # "raise", and every unhandled chaos kind
    raise InjectedFault(fault.message)


def site(name: str, actions=None) -> None:
    """Named injection point.  One global ``None`` check when no plan is
    active; under a plan, counts the hit and performs the matching fault
    (``truncate`` specs are ignored here — they only make sense where the
    caller owns the write, see ``truncate_fraction``).  ``actions`` lets
    the site owner enact the chaos kinds it can perform (see
    ``_perform``)."""
    if _ACTIVE is None:
        if _ENV_CHECKED:
            return
        _maybe_install_env_plan()
        if _ACTIVE is None:
            return
    fault = _ACTIVE._fire(name)
    if fault is None:
        return
    if fault.kind == "truncate":
        _record(fault, name)  # counted, but only write owners can enact it
        return
    _perform(fault, name, actions)


def truncate_fraction(name: str) -> float | None:
    """Checkpoint-append variant of ``site``: returns the fraction of the
    line to write before dying when a ``truncate`` fault matches (the
    caller writes the torn prefix, fsyncs, and raises ``InjectedFault`` —
    exactly what a kill mid-append leaves on disk), else None.  Other fault
    kinds at the same site behave as in ``site()``."""
    if _ACTIVE is None:
        if _ENV_CHECKED:
            return None
        _maybe_install_env_plan()
        if _ACTIVE is None:
            return None
    fault = _ACTIVE._fire(name)
    if fault is None:
        return None
    if fault.kind == "truncate":
        _record(fault, name)
        return fault.truncate_at
    _perform(fault, name)
    return None
