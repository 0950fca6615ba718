"""Resilient execution: error classification, retry with backoff, host
fetch watchdogs, graceful degradation.

The port's counterpart of the JAX package's ``utils/resilience.py``:

  * ``classify_error``: ``"transient"`` (retry can help: injected faults,
    watchdog timeouts, dropped connections), ``"resource"`` (an
    allocation failure: retrying the same rung cannot help, a cheaper rung
    can) or ``"deterministic"`` (fail fast).  A sticky CUDA error (an
    illegal memory access, a device-side assert, an unspecified launch
    failure, a misaligned address) leaves the process's CUDA context dead:
    no retry or recapture in this process can help, and retrying would hide
    a kernel fault, so it is deterministic;
  * ``RetryPolicy``: jittered exponential backoff that drops the device
    memos (``reset_device_state``) between attempts, with an optional
    degradation hook stepped after repeated faults;
  * ``fetch_with_watchdog`` / ``guarded_fetch``: a deadline around a
    blocking device-to-host read;
  * ``DegradationLadder``: ordered rungs a path steps down when a rung
    repeatedly faults (the serve stack's: unshard, then recapture).

Every retry, fail-fast, watchdog fire and degrade emits a telemetry counter
and event plus one structured log line, and the terminal ones reach the
flight recorder (``utils.tracing``).

Policy resolution: the process default is built from the environment
(``QLDPC_RETRY_ATTEMPTS`` / ``QLDPC_RETRY_BASE_S`` /
``QLDPC_WATCHDOG_SECS``) and can be swapped with ``set_default_policy`` or
scoped to a thread with ``policy_override``.  ``time.sleep`` lives only
here (``sleep_for``).
"""
from __future__ import annotations

import collections
import contextlib
import os
import random
import threading
import time

import torch

from . import telemetry, tracing

__all__ = [
    "TransientFault",
    "WatchdogTimeout",
    "MeshDeviceLoss",
    "classify_error",
    "RetryPolicy",
    "DegradationLadder",
    "current_policy",
    "set_default_policy",
    "policy_override",
    "run_cell",
    "fetch_with_watchdog",
    "guarded_fetch",
    "sleep_for",
    "device_epoch",
    "note_device_reset",
]


class TransientFault(RuntimeError):
    """Base class for errors that are transient BY CONSTRUCTION (injected
    faults subclass this); always classified retryable."""


class WatchdogTimeout(TimeoutError):
    """A watchdog-wrapped host fetch exceeded its deadline (a hung
    device)."""


class MeshDeviceLoss(RuntimeError):
    """A mesh-sharded dispatch lost one of its devices (a peer gone / an
    injected ``mesh_device_loss`` chaos fault).  Classified "resource":
    retrying the SAME mesh program is a guaranteed loss — the device is
    still gone — but stepping a degradation ladder that REPLANS the shot
    split onto surviving devices (an unshard rung)
    makes the very next attempt worthwhile, with no backoff burned."""


# ---------------------------------------------------------------------------
# Device-reset epoch (the self-healing probe's restart signal)
# ---------------------------------------------------------------------------
# Monotonic count of reset_device_state() calls this process has performed.
# A reset stands for a device restart, after which a serving layer holding
# CUDA graphs captured against pre-reset state must rebuild;
# serve.ops.HealthProbe compares this epoch against the one it last healed
# at and drives session recaptures in the background when it moves.
_EPOCH_LOCK = threading.Lock()
_DEVICE_EPOCH = 0


def device_epoch() -> int:
    """How many device-state resets this process has performed."""
    with _EPOCH_LOCK:
        return _DEVICE_EPOCH


def note_device_reset() -> None:
    """Called by ``qldpc_fault_tolerance_tpu_torch.reset_device_state`` (the one
    sanctioned reset entry point) so probes can detect restarts they did
    not themselves cause."""
    global _DEVICE_EPOCH
    with _EPOCH_LOCK:
        _DEVICE_EPOCH += 1
    telemetry.count("resilience.device_resets")


def sleep_for(seconds: float) -> None:
    """The single sanctioned sleep in the library (backoff waits, injected
    drain stalls).  Centralized so the no-bare-sleep guard test has exactly
    one exemption to police."""
    if seconds > 0:
        time.sleep(seconds)


# ---------------------------------------------------------------------------
# Error classification
# ---------------------------------------------------------------------------
# Messages of the CUDA errors that leave the context sticky-dead: every
# later CUDA call in the process fails too, so nothing in process can
# recover, and a retry would only hide the kernel fault behind them.
STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
)
# an allocation failure raised as a plain RuntimeError (the caching
# allocator raises torch.cuda.OutOfMemoryError, caught by type)
_RESOURCE_MARKERS = ("out of memory",)


def classify_error(exc: BaseException) -> str:
    """``"transient"`` (retry can help), ``"resource"`` (retrying the same
    rung cannot help but degrading to a cheaper one can), or
    ``"deterministic"`` (fail fast).

    ``torch.cuda.OutOfMemoryError`` (and an "out of memory" message) is
    resource; a sticky CUDA error (``STICKY_CUDA_MARKERS``) is
    deterministic; injected ``TransientFault``s, watchdog timeouts and
    dropped connections are transient; everything else (ValueError,
    TypeError, other RuntimeErrors) is a deterministic bug."""
    if isinstance(exc, MeshDeviceLoss):
        # the lost device stays lost: only a replan (ladder step) helps
        return "resource"
    if isinstance(exc, (TransientFault, WatchdogTimeout)):
        return "transient"
    if isinstance(exc, (TimeoutError, ConnectionError, BrokenPipeError)):
        return "transient"
    msg = str(exc).lower()
    if any(marker in msg for marker in STICKY_CUDA_MARKERS):
        return "deterministic"
    if isinstance(exc, torch.cuda.OutOfMemoryError) or (
            isinstance(exc, RuntimeError)
            and any(marker in msg for marker in _RESOURCE_MARKERS)):
        return "resource"
    return "deterministic"


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------
class DegradationLadder:
    """Ordered fallback rungs an execution path steps down when a rung
    repeatedly faults.  ``rungs`` is a list of ``(name, apply_fn)`` pairs;
    ``step()`` applies the next one (telemetry-counted) and returns its
    name, or ``None`` when the ladder is exhausted.  The serve stack's
    rungs (unshard a mesh-sharded session, then recapture its graphs) are
    bit-exact with the rung above them; the engines'
    (``sim.common.engine_ladder_step``: the fused sampler's v2 -> v1,
    packed -> dense) and the mesh's ``mesh_replan`` stay on the card's
    kernels.  No rung steps to a plain version or to the CPU.  A ladder
    steps only on a fault that ``classify_error`` does not call
    deterministic.  ``DegradationLadder.taken`` counts every rung stepped
    in this process by name, so a run can show that none was."""

    taken: collections.Counter = collections.Counter()

    def __init__(self, rungs):
        self._rungs = list(rungs)
        self._pos = 0

    @property
    def remaining(self) -> int:
        return len(self._rungs) - self._pos

    def step(self) -> str | None:
        if self._pos >= len(self._rungs):
            return None
        name, apply_fn = self._rungs[self._pos]
        self._pos += 1
        apply_fn()
        DegradationLadder.taken[name] += 1
        telemetry.count("resilience.degrades")
        telemetry.event("degrade", rung=name)
        _log("degrade", rung=name)
        # black box: a degrade means a rung died — ship the in-flight ring
        # (no-op unless a postmortem directory is configured)
        tracing.note_failure("degrade", rung=name)
        # the sweep monitor hears of the step directly (not through the
        # event stream), so ladder anomalies fire with telemetry off
        from . import diagnostics

        diagnostics.notify_degrade(name)
        return name


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------
def _log(event: str, **fields) -> None:
    from .observability import get_logger, log_record

    log_record(get_logger(), event, **fields)


def _reset_device_caches() -> None:
    """Drop the device memos and the in-process graph cache
    (``reset_device_state``), so the next attempt rebuilds its state."""
    from .. import reset_device_state

    reset_device_state()


class RetryPolicy:
    """Jittered-exponential-backoff retry for transient infrastructure
    faults.

    * deterministic errors (``classify_error``) re-raise IMMEDIATELY — no
      attempt of the backoff budget is burned on a guaranteed loss;
    * between transient attempts the policy resets device caches
      (``reset_device_state``) and sleeps ``base_delay * backoff**i``
      clamped to ``max_delay``, with multiplicative jitter of ±``jitter``
      drawn from a policy-seeded PRNG (deterministic per policy instance);
    * ``degrade_after``: every that-many consecutive transient failures the
      ``degrade`` hook passed to ``run`` is stepped once (an engine's
      ``DegradationLadder``);
    * ``watchdog_s``: deadline handed to ``fetch_with_watchdog`` for host
      fetches guarded under this policy (None = no watchdog).

    ``run(fn)`` executes ``fn()`` under the policy.  ``fn`` must be safe to
    re-execute from scratch (engine WER runs are: deterministic in their
    key, accumulation is idempotent-by-restart, and mid-cell progress
    records turn a restart into a resume).
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 2.0,
                 backoff: float = 4.0, max_delay: float = 240.0,
                 jitter: float = 0.25, watchdog_s: float | None = None,
                 degrade_after: int = 2, reset_caches: bool = True,
                 seed: int = 0):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = float(base_delay)
        self.backoff = float(backoff)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.watchdog_s = watchdog_s
        self.degrade_after = max(1, int(degrade_after))
        self.reset_caches = bool(reset_caches)
        self._rng = random.Random(seed)

    def delay(self, failure_index: int) -> float:
        d = min(self.base_delay * self.backoff ** failure_index,
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    @property
    def trivial(self) -> bool:
        """True when ``run`` can be a plain call (no retries, no watchdog) —
        the zero-fault fast path."""
        return self.max_attempts <= 1 and self.watchdog_s is None

    def run(self, fn, *, label: str = "", degrade=None):
        """Execute ``fn()``; retry transient faults with backoff, fail fast
        on deterministic ones, step ``degrade`` after repeated faults."""
        failures = 0
        while True:
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 — classification decides
                kind = classify_error(exc)
                summary = f"{type(exc).__name__}: " + \
                    str(exc).splitlines()[0][:120] if str(exc) else \
                    type(exc).__name__
                if kind == "deterministic":
                    telemetry.count("resilience.deterministic_failures")
                    telemetry.event("fail_fast", label=label, error=summary)
                    _log("fail_fast", label=label, error=summary)
                    tracing.flight_record("fail_fast", label=label,
                                          error=summary)
                    raise
                if kind == "resource":
                    # retrying the SAME rung cannot help (same program ->
                    # same OOM): only a ladder step makes another attempt
                    # worthwhile — no ladder / exhausted ladder fails fast.
                    # A successful step re-attempts IMMEDIATELY: nothing
                    # transient is being waited out, so no backoff sleep,
                    # and no transient-budget burn (the ladder length bounds
                    # the loop).
                    if degrade is None or degrade() is None:
                        telemetry.count("resilience.deterministic_failures")
                        telemetry.event("fail_fast", label=label,
                                        error=summary)
                        _log("fail_fast", label=label, error=summary)
                        raise
                    telemetry.event("retry", label=label, attempt=failures,
                                    wait_s=0.0, error=summary)
                    _log("retry", label=label, attempt=failures, wait_s=0.0,
                         error=summary)
                    continue
                failures += 1
                if failures >= self.max_attempts:
                    telemetry.count("resilience.exhausted")
                    telemetry.event("retry_exhausted", label=label,
                                    attempts=failures, error=summary)
                    _log("retry_exhausted", label=label, attempts=failures,
                         error=summary)
                    tracing.note_failure("retry_exhausted", label=label,
                                         attempts=failures, error=summary)
                    raise
                if kind == "transient" and degrade is not None \
                        and failures % self.degrade_after == 0:
                    degrade()
                wait = self.delay(failures - 1)
                telemetry.count("resilience.retries")
                telemetry.event("retry", label=label, attempt=failures,
                                wait_s=round(wait, 3), error=summary)
                _log("retry", label=label, attempt=failures,
                     wait_s=round(wait, 3), error=summary)
                tracing.flight_record("retry", label=label, attempt=failures,
                                      error=summary)
                if self.reset_caches:
                    try:
                        _reset_device_caches()
                    except Exception:  # cache reset must never mask the retry
                        pass
                sleep_for(wait)


# ---------------------------------------------------------------------------
# Default policy: env-configured, swap-able, scope-able
# ---------------------------------------------------------------------------
def _env_policy() -> "RetryPolicy | None":
    """Build the process default from env vars.  ``QLDPC_RETRY_ATTEMPTS=1``
    with no watchdog yields a trivial policy (pure pass-through);
    ``QLDPC_RETRY_ATTEMPTS=0`` disables the layer entirely."""
    attempts = int(os.environ.get("QLDPC_RETRY_ATTEMPTS", "3"))
    if attempts <= 0:
        return None
    base = float(os.environ.get("QLDPC_RETRY_BASE_S", "2.0"))
    watchdog = float(os.environ.get("QLDPC_WATCHDOG_SECS", "0")) or None
    return RetryPolicy(max_attempts=attempts, base_delay=base,
                       watchdog_s=watchdog)


_POLICY_LOCK = threading.Lock()
_DEFAULT_POLICY: RetryPolicy | None = None
_POLICY_INITIALIZED = False
_OVERRIDE = threading.local()


def current_policy() -> RetryPolicy | None:
    """The active policy: a thread-local override if one is in scope, else
    the process default (env-configured on first use)."""
    override = getattr(_OVERRIDE, "stack", None)
    if override:
        return override[-1]
    global _POLICY_INITIALIZED, _DEFAULT_POLICY
    if not _POLICY_INITIALIZED:
        with _POLICY_LOCK:
            if not _POLICY_INITIALIZED:
                _DEFAULT_POLICY = _env_policy()
                _POLICY_INITIALIZED = True
    return _DEFAULT_POLICY


def set_default_policy(policy: RetryPolicy | None) -> None:
    """Replace the process-wide default (None disables the layer)."""
    global _DEFAULT_POLICY, _POLICY_INITIALIZED
    with _POLICY_LOCK:
        _DEFAULT_POLICY = policy
        _POLICY_INITIALIZED = True


@contextlib.contextmanager
def policy_override(policy: RetryPolicy | None):
    """Scope a policy (or None = resilience off) to the current thread —
    tests and the bench A/B use this; nesting restores the outer policy."""
    stack = getattr(_OVERRIDE, "stack", None)
    if stack is None:
        stack = _OVERRIDE.stack = []
    stack.append(policy)
    try:
        yield policy
    finally:
        stack.pop()


def run_cell(fn, *, label: str = "", degrade=None):
    """Run one unit of recoverable work (an engine WER run, a sweep cell, a
    megabatch dispatch) under the active policy.  The zero-fault fast path
    is one ``current_policy()`` read and a ``trivial`` check."""
    policy = current_policy()
    if policy is None or policy.trivial:
        return fn()
    return policy.run(fn, label=label, degrade=degrade)


# ---------------------------------------------------------------------------
# Dispatch watchdog
# ---------------------------------------------------------------------------
def fetch_with_watchdog(fn, *, label: str = "", timeout_s: float | None = None):
    """Run a blocking host fetch with a deadline.  ``timeout_s`` defaults to
    the active policy's ``watchdog_s``; with no deadline the call is direct
    (zero overhead).  With one, the fetch runs on its own DAEMON thread and
    a ``WatchdogTimeout`` (transient — the surrounding RetryPolicy retries
    or resumes) is raised if it misses the deadline.  Daemon threads are
    deliberate: an abandoned fetch blocked in a device-to-host copy on a
    hung device must neither block interpreter shutdown nor exhaust a
    shared pool and un-time later fetches (one thread per fetch; creation
    cost is microseconds against the ~100 ms transfers being guarded)."""
    if timeout_s is None:
        policy = current_policy()
        timeout_s = policy.watchdog_s if policy is not None else None
    if timeout_s is None:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _runner():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised in caller
            box["error"] = exc
        finally:
            done.set()

    threading.Thread(target=_runner, daemon=True,
                     name=f"qldpc-watchdog:{label or 'fetch'}").start()
    if done.wait(timeout=float(timeout_s)):
        if "error" in box:
            raise box["error"]
        return box["value"]
    telemetry.count("resilience.watchdog_fires")
    telemetry.event("watchdog_timeout", label=label,
                    timeout_s=float(timeout_s))
    _log("watchdog_timeout", label=label, timeout_s=float(timeout_s))
    tracing.note_failure("watchdog_timeout", label=label,
                         timeout_s=float(timeout_s))
    raise WatchdogTimeout(
        f"host fetch {label or 'fetch'!r} exceeded {timeout_s}s "
        "(hung device->host transfer — a dead or wedged device)")


def guarded_fetch(fn, *, label: str = ""):
    """Watchdog + retry around one blocking host fetch: the deadline comes
    from the active policy, and a timed-out (or transiently failed) fetch
    re-runs under the same policy — the device values being fetched stay
    alive across attempts, so a retried fetch is bit-exact.  Callers must
    pass an ``fn`` that is pure or idempotent (device_get of a live buffer,
    OSD postprocess of a pending batch): a fetch that timed out but is
    still limping along on its abandoned thread may complete concurrently
    with the retry, so side effects would race (telemetry counters inside
    ``fn`` can double-count in that window; estimator state may not)."""
    policy = current_policy()
    if policy is None or policy.trivial:
        return fn()
    return policy.run(
        lambda: fetch_with_watchdog(fn, label=label,
                                    timeout_s=policy.watchdog_s),
        label=label)
