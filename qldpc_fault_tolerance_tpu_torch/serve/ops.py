"""The decode service's live ops plane: SLO burn-rate engine + HTTP
endpoints.

Two pieces a production decode service is actually operated with, built on
the telemetry/tracing substrate that already exists:

  * **SLOEngine** — rolling-window burn-rate evaluation over the served
    request stream (latency-vs-target and error-rate objectives, fed
    per-request by the ``ContinuousBatcher``).  Burn rate is the standard
    SRE quantity: the fraction of the error budget consumed in the window,
    normalized so 1.0 = exactly on budget.  Sustained burn above the
    ``defer`` threshold marks a tenant for deprioritized assembly (its
    requests ride batches' spare capacity); above the ``shed`` threshold
    new submits for the tenant are rejected at admission with a structured
    error — the concrete admission signal the
    admission-control/autoscaling loop needs.  Every signal transition
    emits a versioned ``slo_alert`` event.

  * **OpsServer** — a dependency-free asyncio HTTP/1.1 endpoint beside the
    TCP decode port serving ``/metrics`` (the existing Prometheus text
    exposition), ``/healthz`` (queue depth, session cache, last-dispatch
    age, SLO signals; 503 while draining/stopped), ``/varz`` (raw registry
    snapshot + compile stats as JSON), and ``/tracez`` (recent slow /
    errored traces from the flight-recorder ring; filter with
    ``?trace_id=``, ``?slow_ms=``, ``?errored=1``, ``?limit=``).

  * **HealthProbe** — the self-healing loop: a daemon thread
    that drains the batcher's dispatch-failure *incidents* (watchdog
    fires, transient dispatch deaths — recorded push-style by the
    dispatcher, never polled from device state) and watches the process
    device-reset epoch (``utils.resilience.device_epoch`` — bumped by
    every ``reset_device_state``), then drives
    ``DecodeSession.heal()`` — rebuild state + recompile the warm bucket
    set — on ITS OWN thread while the old programs keep serving, swapping
    atomically when ready.  Recovery stops being "the next request pays
    (or fails)" and becomes invisible to traffic.

Neither piece touches the sweep hot path; all read state the serving
layer already maintains.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import threading
import time
import urllib.parse

from ..utils import resilience, telemetry, timeseries, tracing

__all__ = [
    "AdmissionError",
    "AutoScaler",
    "ScalePolicy",
    "SLOPolicy",
    "SLOEngine",
    "HealthProbe",
    "AlertRule",
    "AlertEngine",
    "default_alert_rules",
    "OpsServer",
    "OpsHandle",
    "spawn_server_loop",
    "start_ops_thread",
]


class AdmissionError(RuntimeError):
    """A submit rejected by the SLO admission signal (tenant shed).  The
    server answers the request with this as a structured error — shed
    traffic is refused loudly and cheaply, never queued and timed out."""

    def __init__(self, tenant: str, signal: str, burn_rate: float):
        self.tenant = str(tenant)
        self.signal = str(signal)
        self.burn_rate = float(burn_rate)
        super().__init__(
            f"admission {signal}: tenant {tenant!r} is burning its SLO "
            f"budget at {burn_rate:.1f}x (shed threshold exceeded)")


@dataclasses.dataclass
class SLOPolicy:
    """The objectives and thresholds one SLOEngine evaluates.

    ``latency_target_s`` / ``latency_objective``: at least that fraction
    of a tenant's requests must complete under the target.
    ``error_objective``: at least that fraction must succeed.  Budgets are
    the complements; burn rate is bad-fraction / budget over the rolling
    ``window_s``.  Signals: burn >= ``burn_shed`` -> "shed"; >=
    ``burn_defer`` -> "defer"; else "admit".  ``min_requests`` keeps a
    cold tenant from being judged on noise.
    """

    latency_target_s: float = 0.25
    latency_objective: float = 0.99
    error_objective: float = 0.999
    window_s: float = 30.0
    min_requests: int = 20
    burn_defer: float = 2.0
    burn_shed: float = 6.0
    eval_interval_s: float = 0.5
    max_window_requests: int = 4096  # per-tenant memory bound
    # total-tenant memory bound: tenant names are WIRE-supplied, so the
    # engine must not let a hostile client mint unbounded per-tenant
    # state (the scheduler caps its per-tenant counters the same way).
    # Tenants beyond the cap are simply not judged (admitted); tenants
    # whose whole window aged out are garbage-collected every evaluate.
    max_tenants: int = 256


class _TenantWindow:
    """One tenant's rolling window with incrementally maintained bad
    counts: O(1) per observation and per expiry, so ``evaluate`` never
    rescans live entries — it runs synchronously inside submits,
    including on the server's event-loop thread, where an O(window)
    scan per tenant would stall every connection."""

    __slots__ = ("entries", "max_entries", "bad_lat", "bad_err")

    def __init__(self, max_entries: int):
        self.entries: collections.deque = collections.deque()
        self.max_entries = int(max_entries)
        self.bad_lat = 0
        self.bad_err = 0

    def append(self, now: float, bad_lat: bool, ok: bool) -> None:
        if len(self.entries) >= self.max_entries:
            self._drop()
        self.entries.append((now, bad_lat, ok))
        if bad_lat:
            self.bad_lat += 1
        if not ok:
            self.bad_err += 1

    def _drop(self) -> None:
        _, bad_lat, ok = self.entries.popleft()
        if bad_lat:
            self.bad_lat -= 1
        if not ok:
            self.bad_err -= 1

    def expire(self, cutoff: float) -> None:
        """Drop entries older than the window (they are append-time
        ordered, so the stale ones are a prefix)."""
        while self.entries and self.entries[0][0] < cutoff:
            self._drop()

    def newest_ts(self) -> float:
        return self.entries[-1][0] if self.entries else float("-inf")

    def __len__(self) -> int:
        return len(self.entries)


class SLOEngine:
    """Per-tenant rolling-window burn-rate evaluation + admission signals.

    The batcher feeds ``observe_request`` per completed request and
    consults ``admission`` per submit / ``deferred_tenants`` per assembly;
    both consults are a dict read after a lazily rate-limited
    ``evaluate``.  ``now`` is injectable everywhere (monotonic seconds)
    so tests drive the window deterministically."""

    def __init__(self, policy: SLOPolicy | None = None):
        self.policy = policy or SLOPolicy()
        self._lock = threading.Lock()
        self._windows: dict[str, _TenantWindow] = {}
        self._signals: dict[str, str] = {}
        self._last_eval = float("-inf")
        self._last_report: dict = {}
        self._queue_depth = 0

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    def observe_request(self, tenant: str, latency_s: float,
                        ok: bool = True, now: float | None = None) -> None:
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            win = self._windows.get(tenant)
            if win is None:
                if len(self._windows) >= self.policy.max_tenants:
                    # wire-supplied tenant names must not mint unbounded
                    # state; an overflow tenant is unjudged (admitted)
                    telemetry.count("serve.slo.tenant_overflow")
                    return
                win = self._windows[tenant] = _TenantWindow(
                    self.policy.max_window_requests)
            win.append(now, float(latency_s) > self.policy.latency_target_s,
                       bool(ok))
        self._maybe_evaluate(now)

    def observe_queue_depth(self, depth: int) -> None:
        self._queue_depth = int(depth)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _tenant_burn(self, win: _TenantWindow) -> dict | None:
        # caller (evaluate, under the lock) already expired every entry
        # older than the window, and the window maintains its bad counts
        # incrementally: this is O(1)
        n = len(win)
        if n < self.policy.min_requests:
            return None
        bad_lat, bad_err = win.bad_lat, win.bad_err
        budget_lat = max(1e-9, 1.0 - self.policy.latency_objective)
        budget_err = max(1e-9, 1.0 - self.policy.error_objective)
        burn_lat = (bad_lat / n) / budget_lat
        burn_err = (bad_err / n) / budget_err
        burn = max(burn_lat, burn_err)
        return {
            "requests": n,
            "bad_latency": bad_lat,
            "bad_errors": bad_err,
            "burn_latency": round(burn_lat, 4),
            "burn_error": round(burn_err, 4),
            "burn_rate": round(burn, 4),
            "objective": ("latency" if burn_lat >= burn_err else "errors"),
            "bad_fraction": round(max(bad_lat, bad_err) / n, 6),
        }

    def _maybe_evaluate(self, now: float) -> None:
        if now - self._last_eval >= self.policy.eval_interval_s:
            self.evaluate(now=now)

    def evaluate(self, now: float | None = None) -> dict:
        """Re-derive every tenant's burn rate and admission signal; emits
        one ``slo_alert`` event (+ counter) per signal TRANSITION — steady
        state is silent.  Returns {tenant: report}."""
        now = time.monotonic() if now is None else float(now)
        pol = self.policy
        report: dict = {}
        alerts = []
        with self._lock:
            self._last_eval = now
            # GC tenants whose whole window aged out: their signal is
            # "admit" by construction, and dropping them bounds state to
            # the tenants actually sending traffic (a shed tenant that
            # went quiet gets its recovery transition on the way out)
            cutoff = now - pol.window_s
            for tenant in [t for t, w in self._windows.items()
                           if w.newest_ts() < cutoff]:
                del self._windows[tenant]
                prev = self._signals.pop(tenant, "admit")
                if prev != "admit":
                    alerts.append((tenant, prev, "admit",
                                   {"requests": 0, "burn_rate": 0.0}))
            for tenant, win in self._windows.items():
                win.expire(cutoff)
                burn = self._tenant_burn(win)
                if burn is None:
                    signal = "admit"
                    burn = {"requests": len(win), "burn_rate": 0.0}
                elif burn["burn_rate"] >= pol.burn_shed:
                    signal = "shed"
                elif burn["burn_rate"] >= pol.burn_defer:
                    signal = "defer"
                else:
                    signal = "admit"
                prev = self._signals.get(tenant, "admit")
                if signal != prev:
                    alerts.append((tenant, prev, signal, dict(burn)))
                self._signals[tenant] = signal
                report[tenant] = {**burn, "signal": signal}
            self._last_report = report
        for tenant, prev, signal, burn in alerts:
            telemetry.count("serve.slo.alerts")
            telemetry.count(f"serve.slo.{signal}_transitions")
            fields = dict(
                tenant=str(tenant), signal=signal, prev_signal=prev,
                window_s=float(pol.window_s),
                queue_depth=int(self._queue_depth),
                **{k: v for k, v in burn.items()
                   if k in ("burn_rate", "burn_latency", "burn_error",
                            "objective", "requests", "bad_fraction")})
            telemetry.event("slo_alert", **fields)
            tracing.flight_record("slo_alert", **fields)
        return report

    # ------------------------------------------------------------------
    # signals the batcher consumes
    # ------------------------------------------------------------------
    def admission(self, tenant: str, now: float | None = None) -> str:
        """"admit" | "defer" | "shed" for one tenant (re-evaluating when
        the cached evaluation went stale)."""
        self._maybe_evaluate(time.monotonic() if now is None
                             else float(now))
        return self._signals.get(str(tenant), "admit")

    def deferred_tenants(self) -> frozenset:
        # under the lock: evaluate() inserts/deletes keys concurrently
        # from submit threads, and a mid-iteration resize here would
        # RuntimeError the scheduler loop thread
        with self._lock:
            return frozenset(t for t, s in self._signals.items()
                             if s == "defer")

    def check_admission(self, tenant: str,
                        now: float | None = None) -> str:
        """The submit-side gate: raises ``AdmissionError`` for a shed
        tenant, returns the signal otherwise."""
        signal = self.admission(tenant, now=now)
        if signal == "shed":
            # aggregate counter only: tenant is wire input, and a counter
            # per name would let clients grow the registry without bound
            # (the slo_alert event already names the tenant)
            telemetry.count("serve.admission.shed")
            burn = self._last_report.get(str(tenant), {})
            raise AdmissionError(tenant, signal,
                                 float(burn.get("burn_rate", 0.0)))
        if signal == "defer":
            telemetry.count("serve.admission.deferred")
        return signal

    def report(self) -> dict:
        """The last evaluation's per-tenant report (for /healthz)."""
        with self._lock:
            return {t: dict(r) for t, r in self._last_report.items()}


# ---------------------------------------------------------------------------
# Admission-driven autoscaler
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ScalePolicy:
    """The autoscaler's control law, all knobs explicit.

    Batch-target control: overload (queue depth at/above
    ``grow_queue_depth``, or any tenant's SLO burn rate at/above
    ``grow_burn_rate``) doubles the batcher's ``max_batch_shots`` toward
    ``max_batch_shots`` and cuts ``max_wait_s`` to ``overload_wait_s`` —
    under load the queue refills batches instantly, so waiting only adds
    latency while bigger batches buy amortization.  Underload (depth
    at/below ``shrink_queue_depth`` AND burn below the grow threshold)
    walks both knobs back toward their construction-time base values.

    Mesh-shard control: a session whose QUEUED SHOTS cross
    ``shard_queued_shots`` is sharded across the batcher's mesh
    (``DecodeSession.shard``); it retires (``unshard``) once its queue
    falls to ``unshard_queued_shots``.  Hysteresis between the two
    thresholds (and ``cooldown_s`` between any two actions) keeps the
    scaler from flapping.
    """

    min_batch_shots: int = 64
    max_batch_shots: int = 8192
    grow_queue_depth: int = 64
    shrink_queue_depth: int = 4
    grow_burn_rate: float = 1.0
    overload_wait_s: float = 0.0005
    shard_queued_shots: int = 4096
    unshard_queued_shots: int = 256
    cooldown_s: float = 2.0
    eval_interval_s: float = 0.5


class AutoScaler:
    """The loop that ACTS on the admission signals (the autoscaling
    half): consumes the batcher's queue stats and the SLO
    engine's burn-rate report, resizes the batcher's continuous-batching
    targets (``max_batch_shots`` / ``max_wait_s``) and triggers/retires
    hot-session mesh sharding.  Every action emits a versioned
    ``scale_event`` (+ ``serve.scale.events`` counter and
    ``serve.autoscale.*`` gauges) and lands in the flight-recorder ring,
    so scaling history is reconstructable from the JSONL stream alone.

    ``now`` is injectable everywhere (monotonic seconds), so tests drive
    a synthetic SLO burn deterministically; ``evaluate_once()`` is the
    synchronous unit, the daemon loop is that on a timer."""

    def __init__(self, batcher, slo: SLOEngine | None = None,
                 policy: ScalePolicy | None = None,
                 interval_s: float | None = None, start: bool = True):
        self.batcher = batcher
        self.slo = slo
        self.policy = policy or ScalePolicy()
        self.interval_s = (self.policy.eval_interval_s
                          if interval_s is None else float(interval_s))
        # construction-time targets are the underload resting point
        self.base_batch_shots = int(batcher.max_batch_shots)
        self.base_wait_s = float(batcher.max_wait_s)
        self.actions = 0
        self._last_action_t = float("-inf")
        self._sharded: set[str] = set()
        self._last_actions: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="qldpc-serve-autoscaler")
            self._thread.start()

    # ------------------------------------------------------------------
    def _emit(self, now: float, action: str, **fields) -> dict:
        rec = {"action": action, **fields}
        self.actions += 1
        self._last_action_t = now
        telemetry.count("serve.scale.events")
        telemetry.event("scale_event", **rec)
        tracing.flight_record("scale_event", **rec)
        return rec

    def _burn_rate(self) -> float:
        if self.slo is None:
            return 0.0
        report = self.slo.report()
        return max((r.get("burn_rate", 0.0) for r in report.values()),
                   default=0.0)

    def evaluate_once(self, now: float | None = None) -> list:
        """One control pass; returns the actions taken (empty in steady
        state or inside the cooldown window)."""
        now = time.monotonic() if now is None else float(now)
        pol = self.policy
        stats = self.batcher.queue_stats()
        depth = stats["queued_requests"]
        queued_shots = stats["queued_shots"]
        burn = self._burn_rate()
        telemetry.set_gauge("serve.autoscale.max_batch_shots",
                            self.batcher.max_batch_shots)
        if now - self._last_action_t < pol.cooldown_s:
            return []
        actions = []
        overloaded = depth >= pol.grow_queue_depth \
            or burn >= pol.grow_burn_rate
        cur = int(self.batcher.max_batch_shots)
        cur_wait = float(self.batcher.max_wait_s)
        if overloaded:
            # never SHRINK on the grow path: an operator-configured base
            # above the policy cap must not be halved by a "grow" (the
            # restore path could never recover it past the cap either)
            target = max(cur, min(pol.max_batch_shots,
                                  max(cur * 2, pol.min_batch_shots)))
            if target != cur:
                self.batcher.max_batch_shots = target
                actions.append(self._emit(
                    now, "grow_batch", target="max_batch_shots",
                    from_value=cur, to_value=target, queue_depth=depth,
                    burn_rate=round(burn, 4),
                    reason=("queue_depth" if depth >= pol.grow_queue_depth
                            else "slo_burn")))
            if cur_wait > pol.overload_wait_s:
                self.batcher.max_wait_s = pol.overload_wait_s
                actions.append(self._emit(
                    now, "cut_wait", target="max_wait_s",
                    from_value=cur_wait, to_value=pol.overload_wait_s,
                    queue_depth=depth, burn_rate=round(burn, 4),
                    reason="overload"))
        elif depth <= pol.shrink_queue_depth:
            target = max(self.base_batch_shots,
                         max(pol.min_batch_shots, cur // 2))
            if target < cur:
                self.batcher.max_batch_shots = target
                actions.append(self._emit(
                    now, "shrink_batch", target="max_batch_shots",
                    from_value=cur, to_value=target, queue_depth=depth,
                    burn_rate=round(burn, 4), reason="underload"))
            if cur_wait != self.base_wait_s:
                self.batcher.max_wait_s = self.base_wait_s
                actions.append(self._emit(
                    now, "restore_wait", target="max_wait_s",
                    from_value=cur_wait, to_value=self.base_wait_s,
                    queue_depth=depth, burn_rate=round(burn, 4),
                    reason="underload"))
        actions.extend(self._scale_sharding(now, depth, queued_shots))
        if actions:
            self._last_actions = actions
        telemetry.set_gauge("serve.autoscale.sharded_sessions",
                            len(self._sharded))
        return actions

    def _scale_sharding(self, now: float, depth: int,
                        queued_shots: dict) -> list:
        """Trigger/retire hot-session mesh sharding on per-session queue
        pressure.  ``shard()``/``unshard()`` are no-ops (False) for
        sessions without a mesh — nothing is emitted for those.  The
        SESSION's ``sharded`` flag is the source of truth: the
        scheduler's degrade rung may have unsharded a session under us
        (mesh fault), and the local set must resync rather than block a
        hot session's re-shard forever."""
        pol = self.policy
        actions = []
        for name, shots in queued_shots.items():
            if shots < pol.shard_queued_shots:
                continue
            try:
                sess = self.batcher.sessions.get(name)
            except KeyError:
                continue
            if sess.sharded:
                self._sharded.add(name)  # resync (e.g. manual shard)
                continue
            if sess.shard(reason="autoscale"):
                self._sharded.add(name)
                actions.append(self._emit(
                    now, "shard", session=name, queue_depth=depth,
                    queued_shots=int(shots), reason="hot_session"))
        for name in sorted(self._sharded):
            try:
                sess = self.batcher.sessions.get(name)
            except KeyError:
                self._sharded.discard(name)
                continue
            if not sess.sharded:
                # the degrade rung (or an operator) already unsharded it
                self._sharded.discard(name)
                continue
            shots = int(queued_shots.get(name, 0))
            if shots > pol.unshard_queued_shots:
                continue
            if sess.unshard(reason="autoscale"):
                actions.append(self._emit(
                    now, "unshard", session=name, queue_depth=depth,
                    queued_shots=shots, reason="cooled"))
            self._sharded.discard(name)
        return actions

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — the loop never dies
                telemetry.count("serve.autoscale.errors")

    def report(self) -> dict:
        """The /varz + /healthz block: current vs base targets, sharded
        sessions, lifetime action count and the last action batch."""
        return {
            "max_batch_shots": int(self.batcher.max_batch_shots),
            "max_wait_s": float(self.batcher.max_wait_s),
            "base_batch_shots": self.base_batch_shots,
            "base_wait_s": self.base_wait_s,
            "sharded_sessions": sorted(self._sharded),
            "actions": int(self.actions),
            "last_actions": list(self._last_actions),
            "running": bool(self._thread is not None
                            and self._thread.is_alive()),
        }

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)


# ---------------------------------------------------------------------------
# Self-healing sessions
# ---------------------------------------------------------------------------
class HealthProbe:
    """The self-healing loop: detect dead device state, recompile sessions
    in the background, swap while the old programs keep serving.

    Detection is two signals, both free of device round-trips:

      * the batcher's *incidents* — every dispatch that died after its
        in-dispatch retries (watchdog-failed fetch, transient fault,
        injected chaos) is recorded with its session name and error
        classification; the probe heals exactly the sessions implicated;
      * the process device-reset epoch (``resilience.device_epoch``) — a
        ``reset_device_state`` anywhere in the process conceptually kills
        EVERY session's uploaded state, so an epoch move heals all of
        them.  This is deliberately conservative: the default RetryPolicy
        resets caches between transient retries, so a serving host that
        shares its process with retrying sweeps (or leaves the default
        policy's ``reset_caches`` on for serve dispatches) will
        fleet-heal after any such retry.  Heals are always SAFE (rebuild
        from host data, off the dispatcher thread, atomic swap) and
        coalesce per probe pass; a deployment where that background
        recompile traffic matters should serve under a
        ``reset_caches=False`` policy — incident-driven heals already
        cover the sessions a real failure implicates.

    ``DecodeSession.heal()`` runs on the probe thread: the dispatcher
    keeps serving the old programs until the atomic swap, so recovery
    costs traffic nothing (tests pin that a request stream running across
    a heal never fails and stays bit-exact).  ``probe_once()`` is the
    synchronous unit tests drive; the daemon loop is just that on a
    timer."""

    def __init__(self, batcher, *, interval_s: float = 0.25,
                 start: bool = True):
        self.batcher = batcher
        self.interval_s = float(interval_s)
        self.heals = 0
        self.last_heal_t: float | None = None
        self._healed_epoch = resilience.device_epoch()
        # sessions owing a heal, by reason.  Signals are consumed into
        # this map BEFORE the heal attempts, and an entry only leaves on
        # SUCCESS — a heal that fails (the device may still be flapping
        # right after the restart that triggered it) is retried on every
        # later pass instead of being silently given up on.  Touched only
        # by the probe thread / direct probe_once() callers.
        self._pending_heals: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="qldpc-serve-healthprobe")
            self._thread.start()

    # ------------------------------------------------------------------
    def probe_once(self) -> list:
        """One probe pass: drain incidents, check the reset epoch, heal
        owing sessions on THIS thread.  Returns the healed session names
        (empty = healthy).  A failed heal keeps its session in the
        pending map, so the NEXT pass retries it — the signals are
        consumed here, but the obligation only clears on success."""
        # probe-liveness heartbeat: the deadman alert kind watches this
        # counter move, so a wedged/dead probe thread becomes an alert
        telemetry.count("serve.probe_passes")
        for inc in self.batcher.take_incidents():
            # deterministic failures are program bugs — recompiling the
            # same program against the same state cannot fix them
            if inc.get("kind") != "deterministic":
                self._pending_heals[str(inc.get("session"))] = "incident"
        epoch = resilience.device_epoch()
        if epoch != self._healed_epoch:
            self._healed_epoch = epoch
            for name in self.batcher.sessions.names():
                self._pending_heals.setdefault(name, "device_reset")
        healed = []
        for name in sorted(self._pending_heals):
            try:
                sess = self.batcher.sessions.get(name)
            except KeyError:
                # evicted since the incident — nothing left to heal
                self._pending_heals.pop(name, None)
                continue
            try:
                sess.heal(reason=self._pending_heals[name])
            except Exception as exc:  # noqa: BLE001 — probe must survive
                telemetry.count("serve.heal_failures")
                tracing.note_failure("heal_failed", session=name,
                                     error=f"{type(exc).__name__}: {exc}")
                continue  # stays pending: retried next pass
            self._pending_heals.pop(name, None)
            healed.append(name)
            self.heals += 1
            self.last_heal_t = time.monotonic()
        return healed

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — the loop never dies
                telemetry.count("serve.probe_errors")

    def report(self) -> dict:
        """The /healthz block: lifetime heals + last-heal age."""
        last = self.last_heal_t
        return {
            "heals": int(self.heals),
            "pending_heals": len(self._pending_heals),
            "device_epoch": resilience.device_epoch(),
            "last_heal_age_s": (None if last is None
                                else round(time.monotonic() - last, 3)),
            "running": bool(self._thread is not None
                            and self._thread.is_alive()),
        }

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)


# ---------------------------------------------------------------------------
# Alert-rules engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AlertRule:
    """One declarative alert rule over the time-series store.

    ``kind="threshold"``: derive a number from ``metric`` per ``mode`` —
    ``"value"`` (last sample), ``"rate"`` (counter rate over ``window_s``)
    or ``"quantile"`` (windowed histogram quantile ``q``) — and compare it
    to ``threshold`` with ``op``.  The condition must hold ``for_s``
    seconds of scrape ticks before the alert fires (a blip shorter than
    ``for_s`` never pages).

    ``kind="deadman"``: the inverse — fire when ``metric`` has NOT changed
    (counter moved / gauge re-set / histogram observed) within ``window_s``.
    A metric never seen at all is a missing heartbeat, not a healthy one.
    ``threshold``/``op``/``mode``/``q`` are ignored for deadman rules.
    """

    name: str
    metric: str
    kind: str = "threshold"      # "threshold" | "deadman"
    mode: str = "value"          # "value" | "rate" | "quantile"
    q: float = 0.99
    window_s: float = 60.0
    op: str = ">"                # ">" | ">=" | "<" | "<="
    threshold: float = 0.0
    for_s: float = 0.0
    severity: str = "warning"    # "info" | "warning" | "critical"

    _OPS = {">": lambda v, t: v > t, ">=": lambda v, t: v >= t,
            "<": lambda v, t: v < t, "<=": lambda v, t: v <= t}

    def __post_init__(self):
        if self.kind not in ("threshold", "deadman"):
            raise ValueError(f"rule {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if self.kind == "threshold" and self.mode not in (
                "value", "rate", "quantile"):
            raise ValueError(f"rule {self.name!r}: unknown mode "
                             f"{self.mode!r}")
        if self.op not in self._OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")

    def observe(self, store, now):
        """(condition_breached, observed_value) against ``store`` at
        ``now``.  For threshold rules a metric with no derivable value is
        healthy (a rule on traffic that never started must not page); for
        deadman rules the observed value is the heartbeat age and None IS
        the breach."""
        if self.kind == "deadman":
            age = store.age(self.metric, now=now)
            return (age is None or age > self.window_s), age
        if self.mode == "rate":
            v = store.rate(self.metric, self.window_s, now=now)
        elif self.mode == "quantile":
            v = store.quantile(self.metric, self.q, self.window_s, now=now)
        else:
            v = store.last_value(self.metric)
        if v is None:
            return False, None
        return self._OPS[self.op](float(v), self.threshold), v


def default_alert_rules(
        scrape_interval_s: float = timeseries.DEFAULT_INTERVAL_S) -> list:
    """The shipped heartbeat deadman rules: scraper self-watch, serve
    health-probe liveness, stream-commit liveness.  The scraper's own
    tick counter is watched at 4x the scrape interval, so a dead sampler
    pages through any OTHER live evaluator (the fleet gateway evaluates
    rules too — a host whose scraper died stops moving the counter)."""
    grace = max(4.0 * float(scrape_interval_s), 1.0)
    return [
        AlertRule(name="scraper_deadman", metric="timeseries.scrapes",
                  kind="deadman", window_s=grace, severity="critical"),
        AlertRule(name="health_probe_deadman", metric="serve.probe_passes",
                  kind="deadman", window_s=max(grace, 5.0),
                  severity="critical"),
        AlertRule(name="stream_commit_deadman", metric="stream.commits",
                  kind="deadman", window_s=max(grace, 30.0),
                  severity="warning"),
    ]


class AlertEngine:
    """Rule-state machines over a :class:`utils.timeseries.SeriesStore`,
    evaluated on the scrape tick.

    Per-rule states: ``inactive`` -> ``pending`` (condition breached,
    burning its ``for_s`` fuse) -> ``firing`` -> ``inactive`` again on the
    first healthy tick.  Events (schema v7) and counters are emitted on
    TRANSITIONS only, exactly like the SLO engine's ``slo_alert`` — a
    firing alert is silent until it resolves.  ``evaluate`` has the tick
    hook signature (``fn(store, now)``) so ``attach(scraper)`` is one
    line; tests drive it directly with an injectable clock.  Recently
    resolved alerts are kept in a bounded ring for ``/alertz``.
    """

    def __init__(self, rules=(), store=None, now=time.time,
                 resolved_keep: int = 32):
        self.store = store
        self._now = now
        self._lock = threading.Lock()
        self._rules: dict[str, AlertRule] = {}
        self._state: dict[str, dict] = {}
        self._resolved: collections.deque = collections.deque(
            maxlen=int(resolved_keep))
        self.evaluations = 0
        for r in rules:
            self.add_rule(r)

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            if rule.name in self._rules:
                raise ValueError(f"duplicate alert rule {rule.name!r}")
            self._rules[rule.name] = rule
            self._state[rule.name] = {"state": "inactive", "since": None,
                                      "fired_at": None, "value": None}

    def rules(self) -> list:
        with self._lock:
            return [dataclasses.replace(r) for r in self._rules.values()]

    def attach(self, scraper) -> "AlertEngine":
        """Ride ``scraper``'s tick (and adopt its store when none was
        given)."""
        if self.store is None:
            self.store = scraper.store
        scraper.add_tick_hook(self.evaluate)
        return self

    # ------------------------------------------------------------------
    def evaluate(self, store=None, now=None) -> dict:
        """One evaluation pass; returns {rule_name: state}.  Runs every
        rule's observe/transition under the engine lock — rule counts are
        operator-small, and the tick cadence is seconds."""
        store = store if store is not None else self.store
        if store is None:
            return {}
        now = self._now() if now is None else now
        out = {}
        with self._lock:
            self.evaluations += 1
            for name, rule in self._rules.items():
                st = self._state[name]
                breached, value = rule.observe(store, now)
                st["value"] = value
                if breached:
                    if st["state"] == "inactive":
                        st["state"] = "pending"
                        st["since"] = now
                    if st["state"] == "pending" and \
                            now - st["since"] >= rule.for_s:
                        st["state"] = "firing"
                        st["fired_at"] = now
                        self._emit_fired(rule, st, now)
                else:
                    if st["state"] == "firing":
                        self._emit_resolved(rule, st, now)
                    st["state"] = "inactive"
                    st["since"] = None
                    st["fired_at"] = None
                out[name] = st["state"]
        return out

    def _emit_fired(self, rule: AlertRule, st: dict, now: float) -> None:
        telemetry.count("alerts.fired")
        fields = dict(alert=rule.name, severity=rule.severity,
                      rule_kind=rule.kind, metric=rule.metric,
                      for_s=float(rule.for_s), window_s=float(rule.window_s))
        if rule.kind == "deadman":
            fields["age_s"] = st["value"]
        else:
            fields.update(mode=rule.mode, value=st["value"],
                          threshold=float(rule.threshold))
        telemetry.event("alert_fired", **fields)

    def _emit_resolved(self, rule: AlertRule, st: dict, now: float) -> None:
        telemetry.count("alerts.resolved")
        active_s = now - st["fired_at"]
        telemetry.event("alert_resolved", alert=rule.name,
                        severity=rule.severity, rule_kind=rule.kind,
                        metric=rule.metric, value=st["value"],
                        active_s=float(active_s))
        self._resolved.append({
            "alert": rule.name, "severity": rule.severity,
            "rule_kind": rule.kind, "metric": rule.metric,
            "resolved_at": now, "active_s": round(active_s, 3),
        })

    # ------------------------------------------------------------------
    def report(self, now=None) -> dict:
        """The /alertz body: firing + fuse-burning rules, the recently
        resolved ring, and per-rule state for dashboards."""
        now = self._now() if now is None else now
        with self._lock:
            active = []
            states = {}
            for name, rule in self._rules.items():
                st = self._state[name]
                states[name] = st["state"]
                if st["state"] == "inactive":
                    continue
                entry = {
                    "alert": name, "state": st["state"],
                    "severity": rule.severity, "rule_kind": rule.kind,
                    "metric": rule.metric, "value": st["value"],
                    "pending_s": (None if st["since"] is None
                                  else round(now - st["since"], 3)),
                }
                if st["state"] == "firing":
                    entry["firing_s"] = round(now - st["fired_at"], 3)
                active.append(entry)
            return {
                "active": active,
                "resolved": list(self._resolved),
                "rules": len(self._rules),
                "states": states,
                "evaluations": int(self.evaluations),
            }

    def firing(self) -> list:
        """Names of rules currently in the firing state."""
        with self._lock:
            return sorted(n for n, st in self._state.items()
                          if st["state"] == "firing")


# ---------------------------------------------------------------------------
# HTTP ops plane
# ---------------------------------------------------------------------------
_HTTP_REASONS = {200: "OK", 404: "Not Found", 405: "Method Not Allowed",
                 500: "Internal Server Error", 503: "Service Unavailable"}


def _http_response(status: int, body: str,
                   content_type: str = "application/json") -> bytes:
    payload = body.encode("utf-8")
    head = (f"HTTP/1.1 {status} {_HTTP_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}; charset=utf-8\r\n"
            f"Content-Length: {len(payload)}\r\n"
            "Connection: close\r\n\r\n")
    return head.encode("ascii") + payload


class OpsServer:
    """The HTTP sidecar: GET-only, one request per connection, stdlib
    asyncio all the way down (the decode service deliberately has no web
    framework dependency)."""

    def __init__(self, batcher=None, slo: SLOEngine | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 flight: "tracing.FlightRecorder | None" = None,
                 probe: "HealthProbe | None" = None,
                 scaler: "AutoScaler | None" = None,
                 alerts: "AlertEngine | None" = None):
        self.batcher = batcher
        self.slo = slo
        self.host = host
        self.port = int(port)
        self.flight = flight
        self.probe = probe
        self.scaler = scaler
        self.alerts = alerts
        self._server: asyncio.AbstractServer | None = None
        self.t_started = time.monotonic()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), timeout=10.0)
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                    asyncio.TimeoutError, ConnectionError):
                return
            request_line = head.split(b"\r\n", 1)[0].decode(
                "latin-1", "replace")
            parts = request_line.split()
            if len(parts) < 2:
                return
            method, target = parts[0], parts[1]
            if method != "GET":
                writer.write(_http_response(
                    405, json.dumps({"error": "GET only"})))
            else:
                writer.write(self._route(target))
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    def _route(self, target: str) -> bytes:
        telemetry.count("serve.ops.requests")
        url = urllib.parse.urlsplit(target)
        query = urllib.parse.parse_qs(url.query)
        try:
            if url.path == "/metrics":
                # the exposition-format version real Prometheus scrapers
                # negotiate on (conformance pinned by tier-1)
                return _http_response(
                    200, telemetry.prometheus_text(),
                    content_type=telemetry.PROMETHEUS_CONTENT_TYPE)
            if url.path == "/healthz":
                body = self.healthz()
                status = 200 if body.get("ok") else 503
                return _http_response(status, json.dumps(
                    body, sort_keys=True, default=str))
            if url.path == "/varz":
                return _http_response(200, json.dumps(
                    self.varz(), sort_keys=True, default=str))
            if url.path == "/tracez":
                return _http_response(200, json.dumps(
                    self.tracez(query), sort_keys=True, default=str))
            if url.path == "/alertz":
                return _http_response(200, json.dumps(
                    self.alertz(), sort_keys=True, default=str))
            return _http_response(404, json.dumps(
                {"error": f"unknown path {url.path!r}", "paths":
                 ["/metrics", "/healthz", "/varz", "/tracez", "/alertz"]}))
        except Exception as exc:  # noqa: BLE001 — an ops bug must answer
            return _http_response(500, json.dumps(
                {"error": f"{type(exc).__name__}: {exc}"}))

    # ------------------------------------------------------------------
    # endpoint bodies (plain methods so tests can call them directly)
    # ------------------------------------------------------------------
    def healthz(self) -> dict:
        body: dict = {"ok": True, "uptime_s": round(
            time.monotonic() - self.t_started, 3)}
        if self.batcher is not None:
            health = self.batcher.health()
            body.update(health)
            body["ok"] = not (health.get("stopped")
                              or health.get("draining"))
        if self.slo is not None:
            body["slo"] = self.slo.report()
        if self.probe is not None:
            body["probe"] = self.probe.report()
        if self.scaler is not None:
            body["autoscale"] = self.scaler.report()
        if self.alerts is not None:
            firing = self.alerts.firing()
            body["alerts"] = {"firing": firing, "count": len(firing)}
        return body

    def alertz(self) -> dict:
        """The /alertz body: active + recently-resolved alerts (an empty
        engine-less plane still answers, so fleet scraping stays uniform)."""
        if self.alerts is None:
            return {"active": [], "resolved": [], "rules": 0, "states": {},
                    "evaluations": 0}
        return self.alerts.report()

    def varz(self) -> dict:
        body = {"metrics": telemetry.snapshot(),
                "compile": telemetry.compile_stats(),
                "process": telemetry.process_info()}
        if self.scaler is not None:
            body["autoscale"] = self.scaler.report()
        return body

    def tracez(self, query: dict | None = None) -> dict:
        query = query or {}
        flight = self.flight if self.flight is not None \
            else tracing.recorder()
        records = flight.snapshot()

        def _one(name, cast, default=None):
            vals = query.get(name)
            try:
                return cast(vals[0]) if vals else default
            except (TypeError, ValueError):
                return default

        trace_id = _one("trace_id", str)
        if trace_id:
            spans = tracing.traces_from_records(records).get(trace_id, [])
            return {"trace_id": trace_id, "spans": spans,
                    "tree_spans": tracing.trace_tree(spans)["spans"]}
        slow_ms = _one("slow_ms", float)
        limit = _one("limit", int, 50)
        errored = bool(_one("errored", int, 0))
        return {
            "traces": tracing.trace_summaries(
                records, limit=limit,
                slow_s=None if slow_ms is None else slow_ms / 1e3,
                errored_only=errored),
            "ring_records": len(records),
        }


class OpsHandle:
    """An OpsServer running on its own event-loop thread."""

    def __init__(self, server: OpsServer, loop: asyncio.AbstractEventLoop,
                 thread: threading.Thread):
        self.server = server
        self._loop = loop
        self._thread = thread

    @property
    def address(self) -> tuple[str, int]:
        return (self.server.host, self.server.port)

    def stop(self, timeout: float = 10.0) -> None:
        try:
            asyncio.run_coroutine_threadsafe(
                self.server.stop(), self._loop).result(timeout)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=timeout)


def spawn_server_loop(start, thread_name: str, what: str):
    """Run an asyncio server on a fresh daemon-thread event loop; returns
    ``(loop, thread)`` once the awaited ``start()`` accepted.  A failed
    start (e.g. bind) is re-raised in the caller, and the loop is closed
    either way so a failed bind cannot leak its fds.  Shared by
    ``start_ops_thread`` and ``serve.server.start_server_thread``."""
    loop = asyncio.new_event_loop()
    started = threading.Event()
    box: dict = {}

    def run():
        asyncio.set_event_loop(loop)
        try:
            try:
                loop.run_until_complete(start())
            except Exception as exc:  # surface bind failures to the caller
                box["error"] = exc
                return
            started.set()
            loop.run_forever()
        finally:
            started.set()
            loop.close()  # a failed bind must not leak the loop's fds

    thread = threading.Thread(target=run, daemon=True, name=thread_name)
    thread.start()
    if not started.wait(timeout=30.0):
        raise RuntimeError(f"{what} failed to start within 30s")
    if "error" in box:
        raise box["error"]
    return loop, thread


def start_ops_thread(batcher=None, slo: SLOEngine | None = None,
                     host: str = "127.0.0.1", port: int = 0,
                     probe: "HealthProbe | None" = None,
                     scaler: "AutoScaler | None" = None,
                     alerts: "AlertEngine | None" = None) -> OpsHandle:
    """Start the ops plane on a daemon thread; returns once it accepts."""
    server = OpsServer(batcher=batcher, slo=slo, host=host, port=port,
                       probe=probe, scaler=scaler, alerts=alerts)
    loop, thread = spawn_server_loop(server.start, "qldpc-serve-ops",
                                     "ops server")
    return OpsHandle(server, loop, thread)
