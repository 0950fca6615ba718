"""Host telemetry: metrics registry, spans, run events, sinks, schema.

The port's counterpart of the JAX package's ``utils/telemetry.py``:

  * a process-wide, thread-safe **metrics registry** — counters, gauges
    (``set_gauge``, with a high-water mark) and fixed-bucket histograms
    (``observe``; ``LATENCY_BUCKETS`` for request latencies) — with an
    in-memory ``snapshot`` and the Prometheus text exposition
    (``prometheus_text``);
  * hierarchical **timing spans** whose wall-clock lands in per-span
    duration histograms;
  * **run events** (``event``) to pluggable **sinks** (a JSONL stream via
    ``QLDPC_TELEMETRY_JSONL`` or ``enable(path)``, an in-memory list),
    validated by the versioned schema registry ``EVENT_SCHEMAS`` /
    ``validate_event``, the JAX package's schema unchanged;
  * ``compile_stats()``: the CUDA graphs this process captured and the
    seconds they took (``note_capture``), the port's stand-in for the JAX
    package's compile tracker;
  * ``session`` for one enabled region.

The **device telemetry vector** (``device_tele_vec``, slots ``TELE_*``):
an int32 (``TELE_LEN``,) vector of decoder statistics (BP convergence, the
iteration histogram, OSD routing, compaction tiers, the OSD-CS sweep's
counts) built on the device from a batch's decode aux, folded through the
megabatch carry and read in the run's one host read per megabatch;
``publish_device_tele`` folds a host copy into the registry.  The engines
collect a batch's aux with ``collect_device_aux`` / ``note_device_aux``.

Counters the port's modules keep include ``driver.early_stops``,
``sweep.*``, ``mesh.replans``, ``resilience.*``, ``progcache.*`` and the
serve stack's ``serve.*`` / ``stream.*``.

Everything is behind one enable switch and costs nothing when disabled:
every hot-path helper (``count`` / ``observe`` / ``set_gauge`` / ``span``
/ ``event``) starts with a single module-global boolean check.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time

__all__ = [
    "enabled", "enable", "disable", "reset", "session",
    "count", "observe", "set_gauge", "span", "event",
    "counter", "gauge", "histogram", "snapshot", "prometheus_text",
    "registry", "add_sink", "remove_sink", "JsonlSink", "MemorySink",
    "write_snapshot_event", "compile_stats", "note_capture", "process_info",
    "ITER_BUCKETS", "LATENCY_BUCKETS", "set_default_buckets",
    "default_buckets", "set_metric_help", "metric_help",
    "PROMETHEUS_CONTENT_TYPE",
    "EVENT_SCHEMA_VERSION", "EVENT_SCHEMAS", "validate_event",
    "TELE_BP_SHOTS", "TELE_BP_CONVERGED", "TELE_OSD_SHOTS", "TELE_ITER_SUM",
    "TELE_ITER_HIST0", "TELE_OSD_TIER_NONE", "TELE_OSD_TIER_COMPACT",
    "TELE_OSD_TIER_FULL", "TELE_CS_CANDIDATES", "TELE_CS_CHUNKS", "TELE_LEN",
    "device_tele_vec", "publish_device_tele", "collect_device_aux",
    "note_device_aux", "record_bp_aux",
]

# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------

# span-duration histogram edges (seconds, ~half-decade): dispatch latencies
# span 1e-4 (eager CPU op) .. 1e2 (whole sweeps)
DEFAULT_TIME_BUCKETS = (
    1e-4, 3.2e-4, 1e-3, 3.2e-3, 1e-2, 3.2e-2, 0.1, 0.32, 1.0, 3.2, 10.0,
    32.0, 100.0,
)

# BP iterations-to-convergence histogram (upper-inclusive edges + overflow);
# shared by the device telemetry vector and the host-side recorder so the
# two accumulation paths merge into ONE registry histogram
ITER_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

# request-latency histogram edges: log-spaced, 4 per decade, 0.1 ms .. 10 s.
# The DEFAULT_TIME_BUCKETS half-decade ladder was built for dispatch spans;
# at accelerator decode speeds an entire serve latency distribution lands inside
# one or two of its buckets and the interpolated p50/p99 are useless —
# these edges resolve sub-ms tails while still covering multi-second
# stalls.
LATENCY_BUCKETS = tuple(
    round(10.0 ** (-4 + k / 4.0), 10) for k in range(21))

# per-metric default bucket boundaries, consulted by ``histogram`` /
# ``observe`` when the call site passes buckets=None: call sites stay
# one-liners while operators retune boundaries process-wide
# (``set_default_buckets`` or the QLDPC_HIST_BUCKETS env var, a JSON
# object {"metric.name": [edge, ...]}).
_BUCKET_SPECS: dict = {}
_BUCKET_LOCK = threading.Lock()

# per-metric HELP strings for the Prometheus exposition (``# HELP`` lines): registered by the subsystems that own the metrics;
# unregistered names fall back to a generated line so every family still
# carries HELP (real scrapers warn on TYPE-without-HELP).
_HELP_TEXTS: dict = {}
_HELP_LOCK = threading.Lock()


def set_metric_help(name: str, text: str | None) -> None:
    """Register the ``# HELP`` string for ``name`` (None removes it).
    Newlines/backslashes are escaped at render time per the exposition
    format."""
    with _HELP_LOCK:
        if text is None:
            _HELP_TEXTS.pop(str(name), None)
        else:
            _HELP_TEXTS[str(name)] = str(text)


def metric_help(name: str) -> str:
    """The HELP string rendered for ``name`` (generated when unregistered)."""
    text = _HELP_TEXTS.get(str(name))
    if text is None:
        text = f"qldpc telemetry metric '{name}'"
    return text


def set_default_buckets(name: str, buckets) -> None:
    """Register default histogram boundaries for ``name`` (None removes
    the spec).  Takes effect for histograms not yet created — an existing
    histogram keeps its boundaries (counts cannot be rebucketed)."""
    with _BUCKET_LOCK:
        if buckets is None:
            _BUCKET_SPECS.pop(str(name), None)
        else:
            _BUCKET_SPECS[str(name)] = tuple(float(b) for b in buckets)


def default_buckets(name: str):
    """The registered default boundaries for ``name`` (None = the global
    DEFAULT_TIME_BUCKETS ladder)."""
    return _BUCKET_SPECS.get(str(name))


def _install_env_bucket_specs() -> None:
    text = os.environ.get("QLDPC_HIST_BUCKETS", "").strip()
    if not text:
        return
    try:
        spec = json.loads(text)
        for name, edges in spec.items():
            set_default_buckets(name, edges)
    except (ValueError, TypeError, AttributeError):
        import warnings

        warnings.warn("QLDPC_HIST_BUCKETS is not a JSON object of "
                      "{metric: [edges]}; ignoring", stacklevel=1)


class Counter:
    """Monotonic counter.  ``inc`` under the registry lock."""

    kind = "counter"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value = 0

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def to_dict(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar (plus a high-water mark for depth-style gauges).

    ``ts`` is the wall-clock of the last ``set`` — snapshot consumers
    (telemetry_report, sweep_dashboard, the fleet gateway) use it to mark a
    gauge STALE instead of silently rendering a frozen value."""

    kind = "gauge"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value = 0
        self.max_value = 0
        self.ts = None

    def set(self, v):
        with self._lock:
            self.value = v
            if v > self.max_value:
                self.max_value = v
            self.ts = time.time()

    def to_dict(self):
        return {"type": "gauge", "value": self.value, "max": self.max_value,
                "ts": self.ts}


class Histogram:
    """Fixed-bucket histogram: counts per upper-inclusive edge + overflow,
    plus exact ``sum``/``count`` (Prometheus-histogram compatible)."""

    kind = "histogram"

    def __init__(self, name: str, lock: threading.Lock, buckets=None):
        self.name = name
        self._lock = lock
        self.buckets = tuple(buckets if buckets is not None
                             else DEFAULT_TIME_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def _bucket_index(self, v) -> int:
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                return i
        return len(self.buckets)

    def observe(self, v):
        with self._lock:
            self.counts[self._bucket_index(v)] += 1
            self.sum += v
            self.count += 1

    def merge_counts(self, counts, total_sum, total_count):
        """Fold pre-bucketed counts (device-side accumulation) in one shot.
        ``counts`` must have len(buckets)+1 entries (overflow last)."""
        assert len(counts) == len(self.counts), (
            f"{self.name}: bucket shape mismatch "
            f"({len(counts)} vs {len(self.counts)})")
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += int(c)
            self.sum += float(total_sum)
            self.count += int(total_count)

    def to_dict(self):
        return {
            "type": "histogram", "buckets": list(self.buckets),
            "counts": list(self.counts), "sum": self.sum, "count": self.count,
            "mean": (self.sum / self.count) if self.count else None,
        }


class MetricsRegistry:
    """Process-wide, thread-safe name -> metric map.

    One lock guards creation and every mutation (metrics share it): the
    enabled-path cost is one lock round-trip per record, far below the
    dispatch latencies being measured; the disabled path never gets here.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, self._lock, **kw)
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def snapshot(self) -> dict:
        """In-memory sink: {name: metric dict}, a deep copy safe to mutate.
        Built entirely under the shared lock (metrics mutate under the same
        lock) so a concurrent ``observe`` can't tear a histogram's
        counts/sum/count mid-copy."""
        with self._lock:
            return {name: m.to_dict()
                    for name, m in sorted(self._metrics.items())}

    def reset(self):
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# Module state: the global registry, the enable switch, sinks
# ---------------------------------------------------------------------------
_REGISTRY = MetricsRegistry()
_ENABLED = False            # the single hot-path check
_SINKS: list = []
_SINKS_SNAPSHOT: tuple = ()  # lock-free read copy for the event hot path
_SINK_LOCK = threading.Lock()
_SPAN_STACK = threading.local()


def registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _ENABLED


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    if buckets is None:
        buckets = _BUCKET_SPECS.get(name)
    return _REGISTRY.histogram(name, buckets)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def reset() -> None:
    """Clear all metrics (the enable switch and sinks are untouched)."""
    _REGISTRY.reset()


# ---------------------------------------------------------------------------
# Hot-path helpers — one boolean check when disabled
# ---------------------------------------------------------------------------
def count(name: str, n=1) -> None:
    if not _ENABLED:
        return
    _REGISTRY.counter(name).inc(n)


def set_gauge(name: str, value) -> None:
    if not _ENABLED:
        return
    _REGISTRY.gauge(name).set(value)


def observe(name: str, value, buckets=None) -> None:
    if not _ENABLED:
        return
    if buckets is None:
        buckets = _BUCKET_SPECS.get(name)
    _REGISTRY.histogram(name, buckets).observe(value)


class _NullContext:
    """Shared allocation-free no-op context (disabled spans)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()


@contextlib.contextmanager
def _span_enabled(name: str):
    stack = getattr(_SPAN_STACK, "stack", None)
    if stack is None:
        stack = _SPAN_STACK.stack = []
    path = "/".join(stack + [name]) if stack else name
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        _REGISTRY.histogram(f"span.{path}.seconds").observe(dt)


def span(name: str):
    """Hierarchical trace span.  Nested spans join into a ``/``-path (per
    thread); each span records wall-clock into ``span.<path>.seconds``.
    A shared no-op when disabled."""
    if not _ENABLED:
        return _NULL_CONTEXT
    return _span_enabled(name)


def event(kind: str, **fields) -> None:
    """Emit one structured run event to every installed sink (JSONL etc.).
    No-op when disabled."""
    # sink emission is this function's ONLY effect, so no sinks = a pure
    # no-op — return before building the record (the traced serve path
    # emits thousands of events per second).  _SINKS_SNAPSHOT is an
    # immutable tuple swapped whole under the sink lock; reading the
    # reference is GIL-atomic, so the hot path pays no lock.
    if not _ENABLED or not _SINKS_SNAPSHOT:
        return
    rec = {"ts": round(time.time(), 6), "kind": kind, **fields}
    for s in _SINKS_SNAPSHOT:
        try:
            s.emit(rec)
        except Exception:  # a broken sink must not kill the run
            pass


# ---------------------------------------------------------------------------
# Event schema registry
# ---------------------------------------------------------------------------
# Versioned contract between the event emitters and every consumer of the
# JSONL stream (scripts/telemetry_report.py, scripts/sweep_dashboard.py,
# scripts/bench_compare.py, the diagnostics monitors): each event kind lists
# its required and known-optional fields with allowed (json-decoded) types.
# A tier-1 test validates every kind emitted by real runs against this
# registry, so a renamed/retyped field fails CI instead of silently breaking
# a consumer.  Adding a NEW optional field is backward-compatible (add it
# here in the same change); changing a required field bumps the version.
#
# v2: adds the serve.* kinds (serve_session / serve_request /
# serve_batch / serve_drain) emitted by the decode service.  Purely
# additive — every v1 event validates unchanged (pinned by the
# back-compat test in tests/test_serve.py against _V1_EVENT_KINDS).
#
# v3: the rare-event subsystem (qldpc_fault_tolerance_tpu.rare)
# adds the ``rare_stratum`` kind (one per fixed-weight stratum of a
# subset-splitting run) and the weighted ``wer_run`` / ``cell_done`` /
# ``cell_progress`` fields (log_weight_sum, ess, ess_failures, tilt) —
# all OPTIONAL, so direct-MC events validate unchanged.  The v1 AND v2
# kind sets are frozen below; the back-compat test extends to both.
#
# v4: the operational-observability layer adds ``trace`` (one
# per request span — utils.tracing), ``slo_alert`` (serve.ops burn-rate
# engine signal transitions) and ``process_info`` (once-per-enable
# environment provenance so cross-round drift can be attributed to
# jax/backend/host changes).  Purely additive again — the v1/v2/v3 kind
# sets are frozen below and the back-compat tests cover all three.
#
# v5: the serving scaling half adds ``scale_event`` (one per
# autoscaler action — serve.ops.AutoScaler resizing batch targets or
# sharding/unsharding a hot session) and the additive serve-event fields
# for cross-session fused dispatch (serve_batch ``fused``/``lanes``/
# ``family``, serve_session ``sharded``/``lanes``/``family``).  The
# v1..v4 kind sets are frozen below; the back-compat test chain extends
# to all four.
#
# v6: streaming decode adds the stream lifecycle events —
# ``stream_open`` (one per overlap-commit stream opened on the server),
# ``stream_close`` (client close or server shutdown, with the final
# commit watermark) and ``stream_shed`` (the streaming SLO rung dropped
# the WHOLE stream under burn-rate pressure).  v1..v5 are frozen below.
#
# v7: the fleet observability plane adds ``alert_fired`` /
# ``alert_resolved`` (serve.ops.AlertEngine rule-state transitions —
# threshold rules over time-series rates/quantiles and deadman rules over
# heartbeats; emitted on transitions ONLY, like slo_alert).  v1..v6 are
# frozen below.
EVENT_SCHEMA_VERSION = 7

# the v1 kind set, frozen for the back-compat guarantee: these kinds and
# their required fields must keep validating across schema bumps
_V1_EVENT_KINDS = frozenset({
    "telemetry_enabled", "snapshot", "wer_run", "heartbeat", "cell_done",
    "cell_progress", "cell_resume", "fit_report", "anomaly", "ledger",
    "fused_fallback", "fault_injected", "degrade", "retry",
    "retry_exhausted", "fail_fast", "watchdog_timeout", "program_cost",
})

# the v2 additions, frozen with the same guarantee at the v3 bump
_V2_EVENT_KINDS = frozenset({
    "serve_session", "serve_request", "serve_batch", "serve_drain",
})

# the v3 additions, frozen with the same guarantee at the v4 bump
_V3_EVENT_KINDS = frozenset({"rare_stratum"})

# the v4 additions, frozen with the same
# guarantee at the v5 bump.  The tests pin every frozen set's
# size and membership against EVENT_SCHEMAS, so shrinking any of these is
# a tier-1 failure before it is a consumer outage.
_V4_EVENT_KINDS = frozenset({"trace", "slo_alert", "process_info"})

# the v5 additions, frozen with the same
# guarantee at the v6 bump
_V5_EVENT_KINDS = frozenset({"scale_event"})

# the v6 additions, frozen with the same
# guarantee at the v7 bump
_V6_EVENT_KINDS = frozenset({"stream_open", "stream_close", "stream_shed"})

# the v7 additions, frozen with the
# same guarantee for the eventual v8 bump
_V7_EVENT_KINDS = frozenset({"alert_fired", "alert_resolved"})

_NUM = (int, float)
_OPT_NUM = (int, float, type(None))
_OPT_STR = (str, type(None))
# the shared uncertainty block (utils.diagnostics.ci_fields) events may carry
_CI_FIELDS = {
    "failures": int, "shots": int, "rate": _NUM,
    "ci_low": _NUM, "ci_high": _NUM,
    "rel_ci_width": _OPT_NUM, "rse": _OPT_NUM,
}
_CELL_KEY_FIELDS = {
    "cycles": int, "samples": int, "rep": int, "wer": _NUM,
}
# the importance-sampled block (v3): WeightedStats.event_fields plus the
# ESS-aware uncertainty extras (utils.diagnostics.weighted_ci_fields) a
# weighted run's wer_run / cell_done events carry
_WEIGHTED_FIELDS = {
    "log_weight_sum": _OPT_NUM, "ess": _NUM, "ess_failures": _NUM,
    "tilt": _NUM,
}

EVENT_SCHEMAS: dict[str, dict] = {
    "telemetry_enabled": {"required": {"pid": int}, "optional": {}},
    "snapshot": {"required": {"metrics": dict, "compile": dict},
                 "optional": {}},
    "wer_run": {
        "required": {"engine": str, "shots": int, "failures": int,
                     "wer": _NUM},
        # kernel_variant: which BP kernel served the run (one of
        # ops.bp_kernel.KERNEL_VARIANTS, or "mixed") — silent routing to
        # the float32 program leaves a named trace.
        # osd_backend: where the run's OSD stage ran —
        # "device" / "host" / "mixed" / "none" (no OSD decoder); 
        # adds the value "device_cs" (device combination sweep) — an
        # additive VALUE only, the field set is unchanged
        "optional": {"dispatches": int, "kernel_variant": str,
                     "osd_backend": str,
                     **_CI_FIELDS, **_WEIGHTED_FIELDS},
    },
    "heartbeat": {
        "required": {"engine": str, "shots": int},
        "optional": {"waterfall": dict, "rse": _OPT_NUM},
    },
    "cell_done": {
        "required": {"code": str, "noise": str, "type": str, "p": _NUM},
        "optional": {**_CELL_KEY_FIELDS, **_CI_FIELDS, **_WEIGHTED_FIELDS},
    },
    "cell_progress": {
        "required": {"engine": str, "cells": list, "failures": list,
                     "shots": list, "ci_low": list, "ci_high": list},
        # ess (per-cell list): present on weighted fused buckets — the
        # dashboard's mark for importance-sampled cells
        "optional": {"rse": list, "ess": list},
    },
    "cell_resume": {
        "required": {"key": dict, "batches_done": int},
        "optional": {},
    },
    "fit_report": {
        "required": {"fit": str, "converged": bool},
        "optional": {"params": dict, "error": str, "p_c": _NUM,
                     "pc_ci": list, "d_eff": _NUM, "d_ci": list,
                     "d_per_code": list, "p_sus": _NUM, "stderr": dict,
                     "r2": _OPT_NUM, "chi2": _OPT_NUM, "dof": int,
                     "residual_rms": _OPT_NUM, "residual_max": _OPT_NUM,
                     "n_points": int, "bootstrap": int,
                     "bootstrap_failed": int, "code_index": int,
                     "covariance_ok": bool},
    },
    "anomaly": {
        "required": {"anomaly": str},
        "optional": {"cell": dict, "cells": list, "rungs": list,
                     "substrates": dict,
                     "code": _OPT_STR, "type": _OPT_STR, "noise": _OPT_STR,
                     "p_low": _NUM, "p_high": _NUM, "rate_low": _OPT_NUM,
                     "rate_high": _OPT_NUM, "ci_low_cell": list,
                     "ci_high_cell": list, "converged_fraction": _NUM,
                     "shots": int, "tv_distance": _NUM},
    },
    "ledger": {
        "required": {"run_id": str, "fingerprint": str, "cells": int,
                     "fits": int, "anomalies": int},
        "optional": {"path": _OPT_STR, "complete": bool},
    },
    "fused_fallback": {
        "required": {"reason": str, "cells": int}, "optional": {},
    },
    "fault_injected": {
        "required": {"site": str, "fault_kind": str, "seed": int},
        "optional": {},
    },
    "degrade": {"required": {"rung": str}, "optional": {}},
    "retry": {
        "required": {"label": str, "attempt": int, "wait_s": _NUM,
                     "error": str},
        "optional": {},
    },
    "retry_exhausted": {
        "required": {"label": str, "attempts": int, "error": str},
        "optional": {},
    },
    "fail_fast": {
        "required": {"label": str, "error": str}, "optional": {},
    },
    "watchdog_timeout": {
        "required": {"label": str, "timeout_s": _NUM}, "optional": {},
    },
    "program_cost": {
        "required": {"label": str},
        "optional": {"flops": _NUM, "bytes_accessed": _NUM,
                     "argument_bytes": int, "output_bytes": int,
                     "temp_bytes": int, "generated_code_bytes": int,
                     "peak_bytes": int, "backend": str},
    },
    # --- v2: decode-service (serve/) events ------------------------------
    "serve_session": {
        "required": {"session": str, "event": str},
        # osd_backend: "device" for bposd_dev
        # programs, "none" otherwise — host-OSD configs are rejected at
        # session construction, so "host" never appears here; 
        # adds "device_cs" for combination-sweep programs (additive
        # VALUE only, the field set is unchanged).
        # reason/programs: the self-healing
        # event="heal" names why the probe fired and how many warm
        # buckets were recompiled in the background.
        # sharded/lanes/family: mesh-sharded hot
        # sessions (event="shard"/"unshard" + per-compile routing) and
        # cross-session fused-group compiles (event="fused_compile" with
        # the lane count + bucket-family label)
        "optional": {"bucket": int, "compile_s": _NUM,
                     "syndrome_width": int, "kernel_variant": str,
                     "osd_backend": str, "reason": str, "programs": int,
                     "sharded": bool, "lanes": int, "family": str},
    },
    "serve_request": {
        "required": {"session": str, "tenant": str, "shots": int},
        "optional": {"id": _OPT_STR, "latency_s": _NUM, "ok": bool,
                     "error": str},
    },
    "serve_batch": {
        "required": {"session": str, "requests": int, "shots": int,
                     "bucket": int},
        # requeued: how many of a failed batch's
        # requests re-queued for exactly-once re-dispatch instead of
        # being answered with the error.
        # fused/lanes/family: whether this round
        # rode a cross-session fused dispatch, how many lanes (sessions)
        # shared it, and the bucket-family label
        "optional": {"occupancy": _NUM, "tenants": int, "wait_s": _NUM,
                     "dispatch_s": _NUM, "ok": bool, "error": str,
                     "requeued": int, "fused": bool, "lanes": int,
                     "family": str},
    },
    "serve_drain": {
        "required": {"pending_requests": int, "completed": int},
        "optional": {"elapsed_s": _NUM},
    },
    # --- v3: rare-event estimation (rare/) events -------------------------
    # one per fixed-weight stratum of a subset-splitting run
    # (rare.estimator.stratified_wer): weight is the binomial mass P(W=k)
    # the stratum's empirical rate is combined under
    "rare_stratum": {
        "required": {"stratum": int, "shots": int, "failures": int,
                     "weight": _NUM, "rate": _NUM},
        "optional": {"contribution": _NUM},
    },
    # --- v4: operational observability -------------------------
    # one request stage (utils.tracing.record_span): queue_wait /
    # batch_assemble / pad / device_decode / slice / respond plus the
    # server-side serve.request root — the span tree /tracez and the
    # JSONL stream reassemble per trace id
    "trace": {
        "required": {"trace_id": str, "span_id": str, "name": str,
                     "dur_s": _NUM},
        "optional": {"parent_id": _OPT_STR, "t0": _NUM, "session": str,
                     "tenant": str, "request_id": _OPT_STR, "shots": int,
                     "requests": int, "bucket": int, "amortized_over": int,
                     "ok": bool, "error": str},
    },
    # an SLO burn-rate signal transition (serve.ops.SLOEngine): the
    # admission state the batcher consumes for the named tenant changed
    "slo_alert": {
        "required": {"tenant": str, "signal": str},
        "optional": {"prev_signal": str, "burn_rate": _NUM,
                     "burn_latency": _NUM, "burn_error": _NUM,
                     "objective": str, "window_s": _NUM, "requests": int,
                     "bad_fraction": _NUM, "queue_depth": int},
    },
    # --- v5: serving scaling half ------------------------------
    # one autoscaler action (serve.ops.AutoScaler): a batch-target resize
    # or a hot-session shard/unshard, with the signals that drove it
    "scale_event": {
        "required": {"action": str},
        "optional": {"target": str, "session": _OPT_STR,
                     "from_value": _NUM, "to_value": _NUM,
                     "queue_depth": int, "queued_shots": int,
                     "burn_rate": _NUM, "reason": str},
    },
    # --- v6: streaming decode ----------------------------------
    # one per overlap-commit stream opened on the serve front-end
    # (serve.server.DecodeServer._stream_open)
    "stream_open": {
        "required": {"stream": str, "session": str},
        "optional": {"tenant": str, "lanes": int, "width": int,
                     "cycles_per_window": int},
    },
    # stream retirement — client close ("client") or server shutdown
    # ("shutdown") — with the final commit watermark
    "stream_close": {
        "required": {"stream": str, "committed": int},
        "optional": {"committed_cycles": int, "reason": str},
    },
    # the streaming SLO rung: burn-rate pressure shed the WHOLE stream
    # (its state dropped, subsequent chunks answer unknown-stream)
    "stream_shed": {
        "required": {"stream": str, "tenant": str},
        "optional": {"committed": int, "burn_rate": _NUM, "signal": str},
    },
    # --- v7: fleet observability plane -------------------------
    # one alert-rule state transition pending->firing (serve.ops.AlertEngine,
    # evaluated on the time-series scrape tick): threshold rules carry the
    # observed value; deadman rules carry the heartbeat age instead
    "alert_fired": {
        "required": {"alert": str, "severity": str},
        "optional": {"rule_kind": str, "metric": str, "mode": str,
                     "value": _OPT_NUM, "threshold": _OPT_NUM,
                     "for_s": _NUM, "window_s": _NUM, "age_s": _OPT_NUM,
                     "host": str},
    },
    # the matching firing->resolved transition, with how long it burned
    "alert_resolved": {
        "required": {"alert": str, "severity": str},
        "optional": {"rule_kind": str, "metric": str, "mode": str,
                     "value": _OPT_NUM, "threshold": _OPT_NUM,
                     "active_s": _NUM, "host": str},
    },
    # one-shot surfacing of launch gates that no run on the card measured
    # (utils.profiling.note_unmeasured_gates of smem_gates computed without
    # a card)
    "unmeasured_gates": {
        "required": {"gates": list},
        "optional": {"backend": _OPT_STR, "table_generated_at": _OPT_STR},
    },
    # environment provenance, once per telemetry enable (and embedded in
    # every RunLedger record): lets sweep_dashboard --drift and
    # bench_compare attribute cross-round drift to environment changes
    "process_info": {
        "required": {"pid": int, "hostname": str},
        "optional": {"git_sha": _OPT_STR, "jax": _OPT_STR,
                     "jaxlib": _OPT_STR, "backend": _OPT_STR,
                     "python": _OPT_STR, "platform": _OPT_STR,
                     "schema_version": int},
    },
}


def validate_event(record: dict) -> list[str]:
    """Validate one emitted event against the schema registry.  Returns a
    list of problems (empty = valid).  Unknown kinds and missing/mistyped
    declared fields are problems; fields a schema does not declare are
    allowed (emitters may carry extra context), so consumers must key on
    declared names only."""
    problems = []
    kind = record.get("kind")
    schema = EVENT_SCHEMAS.get(kind)
    if schema is None:
        return [f"unknown event kind {kind!r} "
                f"(not in EVENT_SCHEMAS v{EVENT_SCHEMA_VERSION})"]
    ts = record.get("ts")
    if not isinstance(ts, (int, float)):
        problems.append(f"{kind}: missing/non-numeric ts")
    for field, types in schema["required"].items():
        if field not in record:
            problems.append(f"{kind}: missing required field {field!r}")
        elif not isinstance(record[field], types):
            problems.append(
                f"{kind}: field {field!r} has type "
                f"{type(record[field]).__name__}, expected {types}")
    for field, types in schema.get("optional", {}).items():
        if field in record and not isinstance(record[field], types):
            problems.append(
                f"{kind}: optional field {field!r} has type "
                f"{type(record[field]).__name__}, expected {types}")
    return problems


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------
class JsonlSink:
    """Append-only JSONL event stream; one json object per line, flushed per
    event so crashed runs keep their tail.  Render with
    ``scripts/telemetry_report.py``."""

    def __init__(self, path: str):
        self.path = str(path)
        # cold-start friendliness (shared with checkpoint/ledger writers):
        # a fresh host's stream directory is created, not required
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, record: dict):
        line = json.dumps(record, sort_keys=True, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class MemorySink:
    """Collects events in a list (tests, notebooks)."""

    def __init__(self):
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def emit(self, record: dict):
        with self._lock:
            self.records.append(record)

    def close(self):
        pass


def add_sink(sink) -> None:
    global _SINKS_SNAPSHOT
    with _SINK_LOCK:
        _SINKS.append(sink)
        _SINKS_SNAPSHOT = tuple(_SINKS)


def remove_sink(sink) -> None:
    global _SINKS_SNAPSHOT
    with _SINK_LOCK:
        if sink in _SINKS:
            _SINKS.remove(sink)
        _SINKS_SNAPSHOT = tuple(_SINKS)


def write_snapshot_event(**extra_fields) -> dict:
    """Emit the full metrics snapshot (plus compile stats) as one
    ``kind="snapshot"`` event; returns the snapshot dict."""
    snap = snapshot()
    stats = compile_stats()
    event("snapshot", metrics=snap, compile=stats, **extra_fields)
    return snap


# ---------------------------------------------------------------------------
# Process provenance
# ---------------------------------------------------------------------------
def process_info() -> dict:
    """Environment provenance for the run ledger and ``/varz``: pid,
    hostname, python and platform strings, the event schema version, and
    the torch version and CUDA build when torch is already imported (this
    never imports it)."""
    import platform
    import sys

    info = {"pid": os.getpid(), "hostname": platform.node() or "unknown",
            "python": platform.python_version(),
            "platform": platform.platform(), "torch": None, "cuda": None,
            "schema_version": EVENT_SCHEMA_VERSION}
    torch = sys.modules.get("torch")
    if torch is not None:
        info["torch"] = str(torch.__version__)
        info["cuda"] = getattr(torch.version, "cuda", None)
    return info


# ---------------------------------------------------------------------------
# Enable switch
# ---------------------------------------------------------------------------
_OWNED_SINKS: list = []


def enable(jsonl_path: str | None = None) -> None:
    """Turn telemetry on.  ``jsonl_path``: additionally stream run events to
    a JSONL file (``scripts/telemetry_report.py`` renders it).  Idempotent —
    a second ``enable`` while already on keeps the switch and existing
    sinks (never duplicating a stream), though an explicit NEW ``jsonl_path``
    still gets its sink.  Honors the ``QLDPC_TELEMETRY_JSONL`` env var when
    no path is given."""
    global _ENABLED
    if _ENABLED:
        # already on: honor an EXPLICIT new stream path (a dropped path
        # would silently lose the run's events), but never duplicate a
        # sink on a path already streaming
        if jsonl_path is not None:
            with _SINK_LOCK:
                streaming = any(isinstance(s, JsonlSink)
                                and s.path == str(jsonl_path)
                                for s in _SINKS)
            if not streaming:
                s = JsonlSink(jsonl_path)
                with _SINK_LOCK:
                    _OWNED_SINKS.append(s)
                add_sink(s)
        return
    if jsonl_path is None:
        jsonl_path = os.environ.get("QLDPC_TELEMETRY_JSONL") or None
    if jsonl_path is not None:
        s = JsonlSink(jsonl_path)
        with _SINK_LOCK:
            _OWNED_SINKS.append(s)
        add_sink(s)
    _ENABLED = True
    event("telemetry_enabled", pid=os.getpid())
    # provenance rides every stream's head so any JSONL artifact can be
    # attributed to the environment that produced it
    event("process_info", **process_info())


def disable() -> None:
    """Turn telemetry off and close sinks ``enable`` opened.  Metrics stay
    in the registry until ``reset()``."""
    global _ENABLED
    _ENABLED = False
    with _SINK_LOCK:
        owned = list(_OWNED_SINKS)
        _OWNED_SINKS.clear()
    for s in owned:
        remove_sink(s)
        try:
            s.close()
        except Exception:
            pass


@contextlib.contextmanager
def session(jsonl_path: str | None = None, reset_metrics: bool = True):
    """One telemetry-enabled region: enable, yield the registry, emit a
    final snapshot event, disable.  The bench and tests use this so runs
    can't leak an enabled switch.  Nested inside an already-enabled region
    (e.g. a parity sweep enabled via env var) it leaves the outer enable,
    sinks, and accumulated metrics untouched — ``reset_metrics`` is ignored
    (the registry belongs to the outer region) but ``jsonl_path`` still
    gets its own stream for the session's events + final snapshot."""
    was_enabled = _ENABLED
    own_sink = None
    if was_enabled:
        if jsonl_path is not None:
            own_sink = JsonlSink(jsonl_path)
            add_sink(own_sink)
    else:
        if reset_metrics:
            reset()
        enable(jsonl_path)
    try:
        yield _REGISTRY
    finally:
        write_snapshot_event()
        if own_sink is not None:
            remove_sink(own_sink)
            own_sink.close()
        if not was_enabled:
            disable()


# ---------------------------------------------------------------------------
# CUDA-graph capture tracker (the JAX package's compile tracker)
# ---------------------------------------------------------------------------
_CAPTURES = {"cuda.graph_captures": 0, "cuda.graph_captures.seconds": 0.0}
_CAPTURE_LOCK = threading.Lock()


def note_capture(seconds: float) -> None:
    """Count one CUDA-graph capture and its seconds (warm-up, capture and
    instantiation): ``parallel.shots._capture_graph`` calls it for every
    graph the port captures.  Counted whether or not telemetry is on, and
    mirrored into the registry when it is."""
    with _CAPTURE_LOCK:
        _CAPTURES["cuda.graph_captures"] += 1
        _CAPTURES["cuda.graph_captures.seconds"] += float(seconds)
    count("cuda.graph_captures")
    count("cuda.graph_captures.seconds", float(seconds))


def compile_stats() -> dict:
    """The CUDA graphs this process captured and their total seconds —
    what ``/varz`` and the snapshot event report under ``compile``."""
    with _CAPTURE_LOCK:
        out = dict(_CAPTURES)
    out["source"] = "cuda_graph"
    return out


# ---------------------------------------------------------------------------
# Prometheus-style text exposition
# ---------------------------------------------------------------------------
# the exposition-format version real Prometheus scrapers negotiate on; every
# /metrics endpoint (ops plane, fleet gateway) serves with this content type
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    return "qldpc_" + (s if not s[:1].isdigit() else "_" + s)


def _prom_num(v) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def _prom_help(text: str) -> str:
    # exposition format: HELP text escapes backslash and newline only
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def prometheus_text(snap: dict | None = None) -> str:
    """Render a snapshot in the Prometheus text exposition format (counters,
    gauges, cumulative-bucket histograms), ``# HELP`` + ``# TYPE`` per
    family.  Serve with the ``text/plain; version=0.0.4`` content type
    (serve.ops.OpsServer does) so real scrapers ingest it cleanly."""
    snap = snapshot() if snap is None else snap
    lines = []
    for name, m in snap.items():
        pn = _prom_name(name)
        kind = m["type"]
        lines.append(f"# HELP {pn} {_prom_help(metric_help(name))}")
        lines.append(f"# TYPE {pn} {kind}")
        if kind == "counter":
            lines.append(f"{pn} {_prom_num(m['value'])}")
        elif kind == "gauge":
            lines.append(f"{pn} {_prom_num(m['value'])}")
            # the high-water mark is its own family: give it HELP/TYPE so
            # strict parsers don't see an undeclared qldpc_*_max series
            lines.append(f"# HELP {pn}_max "
                         f"{_prom_help('high-water mark of ' + name)}")
            lines.append(f"# TYPE {pn}_max gauge")
            lines.append(f"{pn}_max {_prom_num(m['max'])}")
        else:  # histogram: cumulative buckets + +Inf + _sum/_count
            acc = 0
            for edge, c in zip(m["buckets"], m["counts"]):
                acc += c
                lines.append(f'{pn}_bucket{{le="{_prom_num(edge)}"}} {acc}')
            acc += m["counts"][-1]
            lines.append(f'{pn}_bucket{{le="+Inf"}} {acc}')
            lines.append(f"{pn}_sum {_prom_num(m['sum'])}")
            lines.append(f"{pn}_count {m['count']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Device telemetry vector (folded through the megabatch carry)
# ---------------------------------------------------------------------------
# int32 slot layout, the JAX package's: counts fold across batches on the
# device and publish at the run's host read.  The iteration sum covers
# CONVERGED shots only, so it holds ~2^31 / mean_iters shots a run;
# publish_device_tele detects a wrapped sum and falls back to a
# bucket-midpoint estimate.
TELE_BP_SHOTS = 0        # decoder shots counted (both sectors)
TELE_BP_CONVERGED = 1    # ... of which BP converged within max_iter
TELE_OSD_SHOTS = 2       # shots routed to a device-OSD stage
TELE_ITER_SUM = 3        # sum of iterations over CONVERGED shots
TELE_ITER_HIST0 = 4      # + len(ITER_BUCKETS)+1 histogram slots
# which compaction tier a bposd_dev decode's straggler OSD took, one count
# per decode (decoders.bp_decoders.osd_compaction_tiers is the ladder)
TELE_OSD_TIER_NONE = TELE_ITER_HIST0 + len(ITER_BUCKETS) + 1  # all converged
TELE_OSD_TIER_COMPACT = TELE_OSD_TIER_NONE + 1  # a compaction tier engaged
TELE_OSD_TIER_FULL = TELE_OSD_TIER_NONE + 2     # full-batch elimination
# the OSD-CS sweep: candidates scored (sweep width x OSD-routed shots) and
# chunk sweeps run, widths from ops.osd_cs_device.cs_sweep_shape (the
# definition the decode sizes its sweep by)
TELE_CS_CANDIDATES = TELE_OSD_TIER_FULL + 1
TELE_CS_CHUNKS = TELE_CS_CANDIDATES + 1
TELE_LEN = TELE_CS_CHUNKS + 1

_AUX = threading.local()
_EDGES: dict = {}   # device -> int32 ITER_BUCKETS tensor
_EDGES_LOCK = threading.Lock()


@contextlib.contextmanager
def collect_device_aux():
    """Within the block (this thread), ``note_device_aux`` appends each
    decode's ``(static, aux)`` to the yielded list: the engines wrap one
    batch in it and hand the list to ``device_tele_vec``."""
    prev = getattr(_AUX, "items", None)
    _AUX.items = items = []
    try:
        yield items
    finally:
        _AUX.items = prev


def note_device_aux(static, aux) -> None:
    """Record one decode's ``(static, aux)`` for the enclosing
    ``collect_device_aux``; nothing outside one."""
    items = getattr(_AUX, "items", None)
    if items is not None:
        items.append((static, aux))


def _iter_edges(device):
    """``ITER_BUCKETS`` as an int32 tensor on ``device``, made once per
    device (a megabatch's warm-up makes it before its capture, in which a
    host copy could not run)."""
    import torch

    key = str(device)
    with _EDGES_LOCK:  # one tensor a device, whichever thread asks first
        edges = _EDGES.get(key)
        if edges is None:
            edges = _EDGES[key] = torch.tensor(ITER_BUCKETS,
                                               dtype=torch.int32).to(device)
    return edges


def device_tele_vec(aux_by_static, device=None):
    """The (TELE_LEN,) int32 telemetry vector of one batch, on the device:
    plain int32 arithmetic with no host read and no data-dependent shape,
    so it captures into a megabatch's CUDA graph.  ``aux_by_static``:
    ``(decoder static, aux)`` pairs as ``decoders.bp_decoders.
    decode_device`` returns them.  Decoders without BP aux (FirstMin) add
    nothing; ``bposd_dev`` statics also count their OSD-routed shots (the
    BP-failed ones), the compaction tier their decode took and, for OSD-CS,
    the sweep's candidates and chunks.  Iteration statistics cover
    converged shots only.  ``device`` places the vector when no pair has
    aux."""
    import torch

    from ..decoders.bp_decoders import osd_compaction_tiers
    from ..ops.osd_cs_device import cs_sweep_shape

    pairs = [(s, a) for s, a in aux_by_static
             if a.get("converged") is not None]
    if device is None:
        device = pairs[0][1]["converged"].device if pairs else "cpu"
    i32 = torch.int32

    def zero():
        return torch.zeros((), dtype=i32, device=device)

    shots = 0
    conv, osd, it_sum = zero(), zero(), zero()
    hist = torch.zeros(len(ITER_BUCKETS) + 1, dtype=i32, device=device)
    tier_none, tier_compact, tier_full = zero(), zero(), zero()
    cs_cand, cs_chunks = zero(), zero()
    for static, aux in pairs:
        c = aux["converged"].bool()
        shots += int(c.shape[0])
        conv = conv + c.sum(dtype=i32)
        if static and static[0] == "bposd_dev":
            n_bad = (~c).sum(dtype=i32)
            osd = osd + n_bad
            # the tier decode_device's ladder takes: the smallest
            # compaction capacity holding n_bad, else the full batch
            fits = torch.zeros((), dtype=torch.bool, device=device)
            for cap in osd_compaction_tiers(int(c.shape[0])):
                fits = fits | (n_bad <= cap)
            none_b = (n_bad == 0).to(i32)
            compact_b = ((n_bad > 0) & fits).to(i32)
            tier_none = tier_none + none_b
            tier_compact = tier_compact + compact_b
            tier_full = tier_full + (1 - none_b - compact_b)
            if len(static) > 6 and static[6] == "osd_cs":
                n_cand, n_chunks = cs_sweep_shape(
                    int(static[2]), int(static[3]), int(static[4]))
                cs_cand = cs_cand + n_bad * int(n_cand)
                cs_chunks = cs_chunks + (n_bad > 0).to(i32) * int(n_chunks)
        it = aux.get("iterations")
        if it is not None:
            cmask = c.to(i32)
            it32 = it.to(i32).reshape(-1).contiguous()
            it_sum = it_sum + (it32 * cmask).sum(dtype=i32)
            idx = torch.searchsorted(_iter_edges(device), it32)
            hist = hist.scatter_add(0, idx, cmask)
    head = torch.stack([torch.full((), shots, dtype=i32, device=device),
                        conv, osd, it_sum])
    tail = torch.stack([tier_none, tier_compact, tier_full, cs_cand,
                        cs_chunks])
    return torch.cat([head, hist, tail])


def _approx_iter_sum(counts) -> int:
    """Bucket-midpoint estimate of the iteration sum: the fallback when
    the device's int32 sum slot wrapped on a huge run."""
    total, lo = 0, 0
    for edge, c in zip(ITER_BUCKETS, counts):
        total += int(c) * (lo + 1 + edge) // 2
        lo = edge
    total += int(counts[len(ITER_BUCKETS)]) * (ITER_BUCKETS[-1] * 3 // 2)
    return total


def publish_device_tele(vec) -> None:
    """Fold a host copy of a device telemetry vector into the registry
    (the engines call it right after their host read)."""
    if not _ENABLED:
        return
    import numpy as np

    v = np.asarray(vec).astype(np.int64).reshape(-1)
    if int(v[TELE_BP_SHOTS]) == 0:
        return
    _REGISTRY.counter("bp.shots").inc(int(v[TELE_BP_SHOTS]))
    _REGISTRY.counter("bp.converged").inc(int(v[TELE_BP_CONVERGED]))
    if int(v[TELE_OSD_SHOTS]):
        _REGISTRY.counter("osd.device_shots").inc(int(v[TELE_OSD_SHOTS]))
    if len(v) > TELE_OSD_TIER_FULL:  # older persisted carries lack these
        for slot, name in ((TELE_OSD_TIER_NONE, "osd.tier_none"),
                           (TELE_OSD_TIER_COMPACT, "osd.tier_compacted"),
                           (TELE_OSD_TIER_FULL, "osd.tier_full")):
            if int(v[slot]):
                _REGISTRY.counter(name).inc(int(v[slot]))
    if len(v) > TELE_CS_CHUNKS:
        for slot, name in ((TELE_CS_CANDIDATES, "osd.cs_candidates"),
                           (TELE_CS_CHUNKS, "osd.cs_chunks")):
            if int(v[slot]):
                _REGISTRY.counter(name).inc(int(v[slot]))
    hist = _REGISTRY.histogram("bp.iterations", ITER_BUCKETS)
    counts = v[TELE_ITER_HIST0:TELE_ITER_HIST0 + len(ITER_BUCKETS) + 1]
    it_sum = int(v[TELE_ITER_SUM])
    if it_sum < 0:  # the int32 carry slot wrapped (TELE_ITER_SUM's bound)
        it_sum = _approx_iter_sum(counts)
    hist.merge_counts(counts, it_sum, int(counts.sum()))


def record_bp_aux(aux) -> None:
    """The host twin of ``device_tele_vec`` for the host-assisted paths
    (a BPOSD decoder's host OSD stage, the decoders' host batch API),
    where the decoder aux comes to the host anyway: records its
    ``converged`` / ``iterations`` (host arrays or tensors) into the same
    ``bp.shots``, ``bp.converged`` and ``bp.iterations`` (converged shots
    only) metrics, so both paths merge.  OSD routing is counted where it
    happens, not here."""
    if not _ENABLED:
        return
    import numpy as np

    def host(x):
        return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)

    conv = aux.get("converged") if isinstance(aux, dict) else None
    if conv is None:
        return
    conv = host(conv).astype(bool).ravel()
    _REGISTRY.counter("bp.shots").inc(int(conv.size))
    _REGISTRY.counter("bp.converged").inc(int(conv.sum()))
    it = aux.get("iterations")
    if it is not None:
        it = host(it).ravel().astype(np.int64)[conv]
        edges = np.asarray(ITER_BUCKETS, np.int64)
        idx = np.searchsorted(edges, it)
        counts = np.bincount(idx, minlength=len(ITER_BUCKETS) + 1)
        _REGISTRY.histogram("bp.iterations", ITER_BUCKETS).merge_counts(
            counts, int(it.sum()), int(it.size))


# metric-specific default boundaries: the serve latency histogram gets the
# log-spaced ladder (p50/p99 stay meaningful at sub-ms decode latencies);
# operators may retune any metric via QLDPC_HIST_BUCKETS (applied last, so
# the env wins over the shipped specs)
set_default_buckets("serve.latency_s", LATENCY_BUCKETS)
set_default_buckets("serve.batch_wait_s", LATENCY_BUCKETS)
_install_env_bucket_specs()

# HELP strings for the cross-subsystem metric families (subsystems may
# register their own with set_metric_help; unregistered names render a
# generated fallback)
for _n, _h in (
    ("bp.shots", "decoder shots counted (both sectors)"),
    ("bp.converged", "shots whose BP converged within max_iter"),
    ("bp.iterations", "BP iterations to convergence (converged shots only)"),
    ("osd.device_shots", "shots routed to a device-OSD stage"),
    ("osd.cs_candidates", "combination-sweep candidates scored on device"),
    ("osd.cs_chunks", "combination-sweep pattern-chunk passes run"),
    ("serve.latency_s", "end-to-end request latency, seconds"),
    ("serve.batch_wait_s", "request wait before batch dispatch, seconds"),
    ("serve.queue_depth", "batcher queue depth at sample time"),
    ("timeseries.scrapes", "time-series scraper ticks completed"),
    ("alerts.fired", "alert-rule pending->firing transitions"),
    ("alerts.resolved", "alert-rule firing->resolved transitions"),
    ("fleet.scrapes", "fleet gateway scrape rounds completed"),
    ("fleet.host_up", "fleet hosts answering their ops endpoint"),
):
    set_metric_help(_n, _h)
del _n, _h
