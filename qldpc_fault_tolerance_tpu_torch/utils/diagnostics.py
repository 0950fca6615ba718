"""Statistical observability: estimator health for the sweep stack.

The port's counterpart of the JAX package's ``utils/diagnostics.py``, the
parts a sweep and its fits call:

  * **uncertainty** — Wilson / Clopper-Pearson intervals, relative CI
    width and relative standard error from a cell's ``(failures, shots)``
    counts (``ci_fields`` / ``ci_arrays``), carried by every ``cell_done``
    event, cell record and checkpoint cursor;
  * **anomaly detection** — ``SweepMonitor`` watches a grid for
    non-monotone WER vs p beyond CI overlap, degradation-ladder steps and
    substrate mismatches within one grid, BP-iteration-histogram drift
    between cells, and stalled-convergence cells, each a structured
    ``anomaly`` event; fused buckets publish their live per-cell intervals
    (``publish_cell_progress``) from counts they already read;
  * **run ledger** — ``RunLedger`` appends one JSONL record per sweep run
    (run id, config fingerprint, per-cell final counts + CIs, fit reports,
    anomalies) under a ``ledger/`` dir.

Free when disabled and bit-exact on/off: host bookkeeping over counts that
already crossed to the host.  The switch follows the telemetry enable;
``enable()`` / ``disable()`` force it.

The weighted (importance-sampled) runs' intervals map a weight stream to
its effective binomial counts (``ess_interval``, ``weighted_ci_fields``).
The BP-statistics detectors read the ``bp.*`` counters that the device
telemetry vector and ``telemetry.record_bp_aux`` publish, so they need
telemetry on; the ladder detectors hear of each step from
``utils.resilience`` (``notify_degrade``) with telemetry on or off.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import threading
import time
import uuid

import numpy as np

from . import telemetry

__all__ = [
    "Z_95",
    "CI_KEYS",
    "wilson_interval",
    "clopper_pearson_interval",
    "ci_fields",
    "ci_arrays",
    "effective_sample_size",
    "ess_interval",
    "weighted_ci_fields",
    "enabled",
    "enable",
    "disable",
    "auto",
    "active",
    "SweepMonitor",
    "SweepRun",
    "sweep_run",
    "current_run",
    "cell_scope",
    "note_run",
    "record_cell",
    "drain_degrade_rungs",
    "report_ladder_anomaly",
    "notify_degrade",
    "note_fit",
    "publish_cell_progress",
    "RunLedger",
    "resolve_ledger",
    "load_ledger",
    "config_signature",
    "new_run_id",
]

# two-sided 95% normal quantile — the z every interval here defaults to
Z_95 = 1.959963984540054

# the uncertainty fields a cell record / cell_done event / checkpoint cursor
# may carry (consumers: SweepMonitor, sweep_dashboard, telemetry_report)
CI_KEYS = ("failures", "shots", "rate", "ci_low", "ci_high",
           "rel_ci_width", "rse")


# ---------------------------------------------------------------------------
# Interval estimators (host-side numpy; vectorized over cells)
# ---------------------------------------------------------------------------
def wilson_interval(failures, shots, z: float = Z_95):
    """Wilson score interval for the per-cell logical failure RATE
    ``failures / shots`` (the quantity the Monte-Carlo counts estimate;
    WER is a per-cell monotone transform of it, so CI overlap statements
    transfer).  Vectorized: scalars or same-shape arrays.  ``shots == 0``
    yields the vacuous ``(0, 1)`` interval."""
    f = np.asarray(failures, np.float64)
    n = np.asarray(shots, np.float64)
    safe_n = np.maximum(n, 1.0)
    phat = f / safe_n
    z2 = z * z
    denom = 1.0 + z2 / safe_n
    center = (phat + z2 / (2.0 * safe_n)) / denom
    half = (z * np.sqrt(phat * (1.0 - phat) / safe_n
                        + z2 / (4.0 * safe_n * safe_n))) / denom
    lo = np.clip(center - half, 0.0, 1.0)
    hi = np.clip(center + half, 0.0, 1.0)
    lo = np.where(n > 0, lo, 0.0)
    hi = np.where(n > 0, hi, 1.0)
    if np.ndim(failures) == 0 and np.ndim(shots) == 0:
        return float(lo), float(hi)
    return lo, hi


def clopper_pearson_interval(failures, shots, alpha: float = 0.05):
    """Exact (conservative) Clopper-Pearson interval via the beta quantile
    duality — the reference interval the Wilson fields are sanity-checked
    against in tests.  Scalar only (scipy.stats.beta on host)."""
    from scipy.stats import beta

    f, n = int(failures), int(shots)
    if n <= 0:
        return 0.0, 1.0
    lo = 0.0 if f == 0 else float(beta.ppf(alpha / 2.0, f, n - f + 1))
    hi = 1.0 if f >= n else float(beta.ppf(1.0 - alpha / 2.0, f + 1, n - f))
    return lo, hi


def effective_sample_size(w1, w2):
    """Kish effective sample size ``(sum w)^2 / sum w^2`` of a weight
    stream from its moments: the shot count for uniform weights, toward 1
    for a degenerate stream, 0.0 for an empty one."""
    w1 = float(w1)
    w2 = float(w2)
    return (w1 * w1 / w2) if w2 > 0 else 0.0


def ess_interval(s1, s2, shots, z: float = Z_95):
    """Confidence interval of a weighted failure rate ``s1 / shots``
    (``s1 = sum w_i I_i``, ``s2 = sum w_i^2 I_i``), as the JAX package
    computes it: the Wilson interval of the effective counts ``f_eff =
    s1^2 / s2`` failures in ``n_eff = shots * s1 / s2`` shots.  Uniform
    weights give ``wilson_interval(failures, shots)``; no failures fall
    back to Wilson at ``(0, shots)``."""
    s1 = float(s1)
    s2 = float(s2)
    shots = float(shots)
    if shots <= 0:
        return 0.0, 1.0
    if s1 <= 0 or s2 <= 0:
        return wilson_interval(0.0, shots, z)
    return wilson_interval(s1 * s1 / s2, shots * s1 / s2, z)


def weighted_ci_fields(failures, s1, s2, w1, w2, shots,
                       z: float = Z_95) -> dict:
    """``ci_fields`` of an importance-sampled run: the rate ``s1 /
    shots``, the ``ess_interval``, the rse from the sample variance of the
    per-shot ``w*I`` terms, and the effective sample sizes of the whole
    weight stream (``ess``) and of its failure terms (``ess_failures``).
    ``failures`` stays the raw failure count."""
    s1 = float(s1)
    s2 = float(s2)
    n = int(shots)
    rate = s1 / n if n else 0.0
    lo, hi = ess_interval(s1, s2, n, z)
    rel_width = (hi - lo) / rate if rate > 0 else None
    var = max(s2 / n - rate * rate, 0.0) / n if n else 0.0
    rse = math.sqrt(var) / rate if rate > 0 else None
    return {"failures": int(failures), "shots": n, "rate": rate,
            "ci_low": lo, "ci_high": hi,
            "rel_ci_width": rel_width, "rse": rse,
            "ess": effective_sample_size(w1, w2),
            "ess_failures": effective_sample_size(s1, s2)}


def ci_fields(failures, shots, z: float = Z_95) -> dict:
    """The uncertainty block attached to per-cell events and records:
    failure counts, rate, Wilson interval, relative CI width, and relative
    standard error (all JSON-safe scalars; the undefined ratios at zero
    counts are None, not NaN)."""
    f, n = int(failures), int(shots)
    lo, hi = wilson_interval(f, n, z)
    rate = f / n if n else 0.0
    rel_width = (hi - lo) / rate if rate > 0 else None
    # rse = binomial se / rate = sqrt((1-rate)/failures): the convergence
    # criterion adaptive shot budgets decide on
    rse = math.sqrt(max(1.0 - rate, 0.0) / f) if f > 0 else None
    return {"failures": f, "shots": n, "rate": rate,
            "ci_low": lo, "ci_high": hi,
            "rel_ci_width": rel_width, "rse": rse}


def ci_arrays(failures, shots, z: float = Z_95) -> dict:
    """Vector twin of ``ci_fields`` for fused per-cell records (checkpoint
    cursors, cell_progress events): JSON-safe lists, None where undefined."""
    f = np.asarray(failures, np.int64)
    n = np.asarray(shots, np.int64)
    lo, hi = wilson_interval(f, n, z)
    lo, hi = np.atleast_1d(lo), np.atleast_1d(hi)
    rate = np.divide(f, np.maximum(n, 1), dtype=np.float64)
    rse = [
        (math.sqrt(max(1.0 - r, 0.0) / fi) if fi > 0 else None)
        for fi, r in zip(f.ravel().tolist(), rate.ravel().tolist())
    ]
    return {
        "ci_low": [float(x) for x in lo],
        "ci_high": [float(x) for x in hi],
        "rse": rse,
    }


# ---------------------------------------------------------------------------
# Enable switch: default rides the telemetry enable; force for A/B
# ---------------------------------------------------------------------------
_FORCED: bool | None = None  # None = auto (follow telemetry)


def enabled() -> bool:
    """Diagnostics switch.  Auto mode (the default) follows the telemetry
    enable — diagnostics are event/registry enrichment, so they are
    meaningless without the event layer; ``enable()``/``disable()`` force
    the switch (A/B measurement, tests)."""
    if _FORCED is not None:
        return _FORCED
    return telemetry.enabled()


def enable() -> None:
    global _FORCED
    _FORCED = True


def disable() -> None:
    global _FORCED
    _FORCED = False


def auto() -> None:
    """Restore the default follow-telemetry behavior."""
    global _FORCED
    _FORCED = None


_TL = threading.local()


def active() -> bool:
    """True when diagnostics should enrich records on this thread: the
    switch is on, or a sweep run (ledger) is explicitly in scope."""
    return enabled() or getattr(_TL, "run", None) is not None


# ---------------------------------------------------------------------------
# Anomaly monitors
# ---------------------------------------------------------------------------
def _log(event: str, **fields) -> None:
    from .observability import get_logger, log_record

    log_record(get_logger(), event, **fields)


class SweepMonitor:
    """Host-side estimator-health monitor for one sweep grid, as the JAX
    package's: a telemetry sink for ``degrade`` events (``emit``; a sweep
    run feeds it through ``notify_degrade`` instead) fed finished cells
    via ``note_cell``.  Five detectors, each raising a structured
    ``anomaly`` event plus ``diag.anomalies`` / ``diag.anomaly.<kind>``
    counters and a log line:

      * ``ladder_degrade`` — a degradation-ladder step fired while a cell
        ran (the cell's result came from a fallback substrate); names the
        cell and the rung(s) taken.
      * ``substrate_mismatch`` — cells of ONE grid completed on different
        substrates (some degraded, some not): each cell is still bit-exact
        rung for rung, but a curve mixing substrates deserves a flag
        (finalize-time check).
      * ``stalled_convergence`` — a cell whose BP converged fraction
        (``bp.shots`` / ``bp.converged`` registry delta between cells)
        fell below ``stall_fraction``.
      * ``bp_iteration_drift`` — the per-cell BP iterations-to-convergence
        histogram (registry delta, normalized) moved by more than
        ``drift_tv`` in total-variation distance vs the previous cell.
      * ``non_monotone_wer`` — finalize-time: within one (code, type,
        noise, cycles) curve, a higher-p cell's failure rate sits
        DECISIVELY below a lower-p cell's (Wilson CIs disjoint): the rate
        must be non-decreasing in p, so this flags a broken estimate, not
        noise.

    The BP detectors skip cells of fewer than ``min_shots`` BP shots."""

    def __init__(self, grid: dict | None = None, *,
                 stall_fraction: float = 0.5, min_shots: int = 256,
                 drift_tv: float = 0.35):
        self.grid = dict(grid or {})
        self.stall_fraction = float(stall_fraction)
        self.min_shots = int(min_shots)
        self.drift_tv = float(drift_tv)
        self.cells: list[dict] = []
        self.anomalies: list[dict] = []
        self._lock = threading.Lock()
        self._pending_rungs: list[str] = []
        self._last_bp = self._bp_snapshot()
        self._last_hist: np.ndarray | None = None
        self._finalized = False

    # -- telemetry sink protocol (degrade events only) -------------------
    def emit(self, record: dict) -> None:
        if record.get("kind") == "degrade":
            with self._lock:
                self._pending_rungs.append(str(record.get("rung")))

    def close(self) -> None:
        pass

    # -- detectors -------------------------------------------------------
    @staticmethod
    def _bp_snapshot() -> dict:
        snap = telemetry.snapshot()
        it = snap.get("bp.iterations", {})
        return {
            "shots": snap.get("bp.shots", {}).get("value", 0),
            "converged": snap.get("bp.converged", {}).get("value", 0),
            "counts": np.asarray(it.get("counts")
                                 or [0] * (len(telemetry.ITER_BUCKETS) + 1),
                                 np.int64),
        }

    def _anomaly(self, kind: str, **fields) -> None:
        rec = {"anomaly": kind, **fields}
        self.anomalies.append(rec)
        telemetry.count("diag.anomalies")
        telemetry.count(f"diag.anomaly.{kind}")
        telemetry.event("anomaly", **rec)
        _log("anomaly", **rec)

    def drain_rungs(self) -> list[str]:
        """Take (and clear) the ladder rungs recorded since the last
        drain.  A fused bucket (one device run serves every cell) drains
        once before recording its cells, so all of them are labelled with
        the fallback substrate, not only the first."""
        with self._lock:
            rungs, self._pending_rungs = self._pending_rungs, []
        return rungs

    def note_cell(self, cell_key: dict, wer: float, ci: dict | None,
                  rungs: list | None = None) -> None:
        """Record one finished cell (ci: a ``ci_fields`` block or {}).
        ``rungs=None`` (serial cells) drains the pending ladder queue and
        raises the per-cell ladder anomaly itself; an explicit list (a
        fused bucket's cells: the caller drained once for the whole bucket
        and raised one bucket-level anomaly) only labels the substrate."""
        cell = {"cell": dict(cell_key), "wer": float(wer), **(ci or {})}
        if rungs is None:
            rungs = self.drain_rungs()
            if rungs:
                self._anomaly("ladder_degrade", cell=dict(cell_key),
                              rungs=list(rungs))
        if rungs:
            cell["substrate"] = rungs[-1]
        self.cells.append(cell)
        self._bp_deltas(cell_key)

    def _bp_deltas(self, cell_key: dict) -> None:
        snap = self._bp_snapshot()
        last, self._last_bp = self._last_bp, snap
        d_shots = int(snap["shots"]) - int(last["shots"])
        if d_shots < self.min_shots:
            return
        d_conv = int(snap["converged"]) - int(last["converged"])
        frac = d_conv / d_shots
        if frac < self.stall_fraction:
            self._anomaly("stalled_convergence", cell=dict(cell_key),
                          converged_fraction=round(frac, 6),
                          shots=d_shots)
        d_hist = snap["counts"] - last["counts"]
        total = int(d_hist.sum())
        if total <= 0:
            return
        norm = d_hist / total
        if self._last_hist is not None:
            tv = 0.5 * float(np.abs(norm - self._last_hist).sum())
            if tv > self.drift_tv:
                self._anomaly("bp_iteration_drift", cell=dict(cell_key),
                              tv_distance=round(tv, 4))
        self._last_hist = norm

    def finalize(self) -> None:
        """Grid-level checks once every cell is in: monotonicity beyond CI
        overlap and the substrate-mismatch scan.  Idempotent."""
        if self._finalized:
            return
        self._finalized = True
        self._check_monotone()
        self._check_substrates()

    def _check_monotone(self) -> None:
        groups: dict[tuple, list[dict]] = {}
        for c in self.cells:
            if c.get("ci_low") is None or c.get("ci_high") is None:
                continue
            k = c["cell"]
            gk = (k.get("code"), k.get("type"), k.get("noise"),
                  k.get("cycles"))
            groups.setdefault(gk, []).append(c)
        for (code, ltype, noise, cycles), cs in groups.items():
            cs = sorted(cs, key=lambda c: float(c["cell"].get("p", 0.0)))
            for a, b in zip(cs, cs[1:]):
                # rate must be non-decreasing in p; only a DISJOINT-CI
                # decrease is an anomaly (overlapping CIs are just noise)
                if b["ci_high"] < a["ci_low"]:
                    self._anomaly(
                        "non_monotone_wer", code=code, type=ltype,
                        noise=noise,
                        p_low=float(a["cell"]["p"]),
                        p_high=float(b["cell"]["p"]),
                        rate_low=a.get("rate"), rate_high=b.get("rate"),
                        ci_low_cell=[a["ci_low"], a["ci_high"]],
                        ci_high_cell=[b["ci_low"], b["ci_high"]])

    def _check_substrates(self) -> None:
        by_sub: dict[str, list[dict]] = {}
        for c in self.cells:
            by_sub.setdefault(c.get("substrate") or "default", []).append(c)
        if len(by_sub) > 1:
            self._anomaly(
                "substrate_mismatch",
                substrates={sub: [cc["cell"] for cc in cs]
                            for sub, cs in by_sub.items()})


# ---------------------------------------------------------------------------
# Run ledger
# ---------------------------------------------------------------------------
LEDGER_VERSION = 1
DEFAULT_LEDGER_DIR = "ledger"


def config_signature(config: dict) -> str:
    """Stable identity of a sweep configuration (codes, p-grid, noise
    model, samples, ...) — the key ``sweep_dashboard.py --drift`` matches
    runs on.  Floats are rounded to 12 places so equal grids fingerprint
    equally across float formatting."""

    def canon(v):
        if isinstance(v, float):
            return round(v, 12)
        if isinstance(v, dict):
            return {k: canon(x) for k, x in sorted(v.items())}
        if isinstance(v, (list, tuple)):
            return [canon(x) for x in v]
        return v

    text = json.dumps(canon(dict(config)), sort_keys=True, default=str)
    return hashlib.sha1(text.encode("utf-8")).hexdigest()[:16]


def new_run_id() -> str:
    return (time.strftime("%Y%m%dT%H%M%S") + f"-{os.getpid()}-"
            + uuid.uuid4().hex[:6])


class RunLedger:
    """Append-only JSONL ledger of sweep runs.

    One line per run: ``{v, run_id, ts, fingerprint, config, cells, fits,
    anomalies}`` with every cell carrying its final counts + Wilson CI.
    ``path`` may be a directory (records land in ``<dir>/sweeps.jsonl``)
    or a ``.jsonl`` file.  Loading skips torn lines (kill mid-append) like
    the sweep checkpoint does."""

    def __init__(self, path: str = DEFAULT_LEDGER_DIR):
        path = str(path)
        if path.endswith(".jsonl"):
            self.path = path
        else:
            self.path = os.path.join(path, "sweeps.jsonl")
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()

    def append(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True, default=str)
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
                fh.flush()
        telemetry.count("diag.ledger_records")

    def load(self) -> list[dict]:
        return load_ledger(self.path)


def load_ledger(path: str) -> list[dict]:
    """Parse a ledger file (or directory) into run records, skipping
    unparseable lines (crash-tolerant, like the sweep checkpoint)."""
    if os.path.isdir(path):
        path = os.path.join(path, "sweeps.jsonl")
    records = []
    if not os.path.exists(path):
        return records
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def resolve_ledger(ledger) -> "RunLedger | None":
    """Normalize the sweep drivers' ``ledger=`` knob: None consults the
    ``QLDPC_LEDGER_DIR`` env var; True means the default ``ledger/`` dir;
    a string is a dir or .jsonl path; a RunLedger passes through."""
    if ledger is None:
        env = os.environ.get("QLDPC_LEDGER_DIR", "").strip()
        return RunLedger(env) if env else None
    if ledger is True:
        return RunLedger(DEFAULT_LEDGER_DIR)
    if isinstance(ledger, RunLedger):
        return ledger
    return RunLedger(str(ledger))


# ---------------------------------------------------------------------------
# Sweep-run scope: monitor + ledger + fit collection for one grid
# ---------------------------------------------------------------------------
class SweepRun:
    """One sweep run's collected state: its monitor, cells, fit reports."""

    def __init__(self, config: dict, ledger: RunLedger | None):
        self.config = dict(config or {})
        self.ledger = ledger
        self.run_id = new_run_id()
        self.fingerprint = config_signature(self.config)
        self.monitor = SweepMonitor(self.config)
        self.fits: list[dict] = []
        self.error: str | None = None
        self.t0 = time.time()

    def note_cell(self, cell_key: dict, wer: float, ci: dict | None,
                  rungs: list | None = None) -> None:
        self.monitor.note_cell(cell_key, wer, ci, rungs=rungs)

    def note_fit(self, report: dict) -> None:
        self.fits.append(dict(report))

    def finalize(self) -> dict:
        self.monitor.finalize()
        record = {
            "v": LEDGER_VERSION,
            "run_id": self.run_id,
            "ts": round(time.time(), 3),
            "elapsed_s": round(time.time() - self.t0, 3),
            "fingerprint": self.fingerprint,
            "config": self.config,
            "complete": self.error is None,
            "cells": self.monitor.cells,
            "fits": self.fits,
            "anomalies": self.monitor.anomalies,
            # environment provenance: tells a drift compare an
            # environment change from a change in the physics
            "env": telemetry.process_info(),
        }
        if self.error is not None:
            record["error"] = self.error
        if self.ledger is not None:
            self.ledger.append(record)
        telemetry.event(
            "ledger", run_id=self.run_id, fingerprint=self.fingerprint,
            cells=len(record["cells"]), fits=len(record["fits"]),
            anomalies=len(record["anomalies"]),
            complete=record["complete"],
            path=(self.ledger.path if self.ledger is not None else None))
        return record


@contextlib.contextmanager
def sweep_run(config: dict | None = None, ledger=None):
    """Scope one sweep grid's diagnostics: resolves the ledger, activates
    a SweepMonitor for the grid (ladder steps reach it via
    ``notify_degrade``, so it works with telemetry off; the BP-statistics
    detectors read the telemetry registry and so need telemetry on), and
    finalizes (grid checks + ledger append) on exit.  Reentrant — a nested
    scope (EvalWER inside EvalThreshold) joins the outer run so fit
    reports land in the same ledger record.  A no-op context (yields None)
    when diagnostics are off AND no ledger was requested — the
    free-when-disabled path.  A sweep that RAISES still appends its ledger
    record, marked ``complete: false`` with the error — a crashed run must
    not masquerade as a finished one (drift compares skip it)."""
    outer = getattr(_TL, "run", None)
    if outer is not None:
        yield outer
        return
    ledger_obj = resolve_ledger(ledger)
    if ledger_obj is None and not enabled():
        yield None
        return
    run = SweepRun(config or {}, ledger_obj)
    _TL.run = run
    try:
        yield run
    except BaseException as exc:
        run.error = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}" \
            if str(exc) else type(exc).__name__
        raise
    finally:
        _TL.run = None
        run.finalize()


def current_run() -> SweepRun | None:
    return getattr(_TL, "run", None)


def record_cell(cell_key: dict, wer: float, ci: dict | None = None,
                rungs: list | None = None) -> None:
    """Feed one finished cell to the active sweep run (monitor + ledger).
    ``rungs``: see ``SweepMonitor.note_cell`` — a fused bucket passes its
    once-drained rung list so every cell of the bucket is labelled.  No-op
    outside a run."""
    run = getattr(_TL, "run", None)
    if run is not None:
        run.note_cell(cell_key, wer, ci, rungs=rungs)


def drain_degrade_rungs() -> list:
    """Ladder rungs recorded since the last drain, from the active run's
    monitor ([] outside a run): a fused bucket calls this once before
    recording its cells."""
    run = getattr(_TL, "run", None)
    return run.monitor.drain_rungs() if run is not None else []


def report_ladder_anomaly(cells: list, rungs: list) -> None:
    """One bucket-level ``ladder_degrade`` anomaly naming every cell the
    degraded device run served (a fused bucket: one run, many cells)."""
    run = getattr(_TL, "run", None)
    if run is not None and rungs:
        run.monitor._anomaly("ladder_degrade",
                             cells=[dict(c) for c in cells],
                             rungs=list(rungs))


def notify_degrade(rung) -> None:
    """Route a degradation-ladder step to the active sweep run's monitor.
    ``utils.resilience`` calls this beside its ``degrade`` telemetry
    event, so ladder anomalies fire in ledger-only runs where telemetry
    (and so the event stream) is off.  No-op outside a sweep run."""
    run = getattr(_TL, "run", None)
    if run is not None:
        run.monitor.emit({"kind": "degrade", "rung": str(rung)})


def note_fit(report: dict) -> None:
    """Attach a fit report to the active sweep run's ledger record (the
    fit layer calls this alongside its ``fit_report`` event)."""
    run = getattr(_TL, "run", None)
    if run is not None:
        run.note_fit(report)


# ---------------------------------------------------------------------------
# Per-cell run-stat capture for the serial sweep loop
# ---------------------------------------------------------------------------
class _CellStats:
    """Collects the (failures, shots) of engine runs executed inside one
    serial sweep cell (reported via ``note_run``)."""

    __slots__ = ("runs",)

    def __init__(self):
        self.runs: list[tuple[int, int]] = []

    def fields(self, z: float = Z_95) -> dict:
        # exactly one engine run -> its counts ARE the cell's counts; a
        # multi-run cell (circuit 'Total' = X-run + Z-run) has no single
        # binomial count, so it gets no interval rather than a wrong one
        if len(self.runs) != 1:
            return {}
        failures, shots = self.runs[0]
        return ci_fields(failures, shots, z)


@contextlib.contextmanager
def cell_scope():
    """Scope one serial sweep cell: engine runs inside it report their
    counts to the yielded ``_CellStats`` (``note_run``), and ``.fields()``
    afterwards is the cell's uncertainty block."""
    box = _CellStats()
    prev = getattr(_TL, "cell", None)
    _TL.cell = box
    try:
        yield box
    finally:
        _TL.cell = prev


def note_run(failures, shots) -> None:
    """Report one engine WER run's counts to the enclosing cell scope (the
    engines' ``sim.common.count_failures`` calls this for every run)."""
    box = getattr(_TL, "cell", None)
    if box is not None:
        box.runs.append((int(failures), int(shots)))


# ---------------------------------------------------------------------------
# Fused-grid live publishing (counts already on the host: no extra read)
# ---------------------------------------------------------------------------
def publish_cell_progress(engine: str, cells, failures, shots,
                          z: float = Z_95) -> None:
    """Publish per-cell interval gauges and one ``cell_progress`` event
    from a fused bucket's counters that a megabatch read already brought
    to the host (no further transfer).

    ``cells``: per-cell descriptors — the sweep planner's cell-key dicts
    when available, else the builders' p-value tags, else lane indices.
    Gauges: ``cell.<code>.p<p>.ci_low`` / ``.ci_high`` / ``.rse`` (rse
    only when defined; bare p tags when no cell key is available — the
    code qualifier keeps same-p cells of different codes from overwriting
    each other's gauges)."""
    if not active():
        return
    f = np.asarray(failures, np.int64)
    n = np.asarray(shots, np.int64)
    arrs = ci_arrays(f, n, z)
    if cells is None:
        cells = list(range(len(f)))
    cells = list(cells)

    def tag(c):
        if isinstance(c, dict):
            p = c.get("p")
            p_part = f"p{p:g}" if isinstance(p, float) else f"p{p}"
            code = c.get("code")
            return f"{code}.{p_part}" if code else p_part
        return f"{c:g}" if isinstance(c, float) else str(c)

    for c, lo, hi, rse in zip(cells, arrs["ci_low"], arrs["ci_high"],
                              arrs["rse"]):
        t = tag(c)
        telemetry.set_gauge(f"cell.{t}.ci_low", lo)
        telemetry.set_gauge(f"cell.{t}.ci_high", hi)
        if rse is not None:
            telemetry.set_gauge(f"cell.{t}.rse", rse)
    telemetry.event(
        "cell_progress", engine=str(engine),
        cells=[c if isinstance(c, dict) else {"p": c} for c in cells],
        failures=[int(x) for x in f], shots=[int(x) for x in n],
        ci_low=arrs["ci_low"], ci_high=arrs["ci_high"], rse=arrs["rse"])
