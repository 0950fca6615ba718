"""Statistical observability: estimator health for the sweep stack.

The port's counterpart of the JAX package's ``utils/diagnostics.py``, the
parts a sweep and its fits call:

  * **uncertainty** — Wilson / Clopper-Pearson intervals, relative CI
    width and relative standard error from a cell's ``(failures, shots)``
    counts (``ci_fields`` / ``ci_arrays``), carried by every ``cell_done``
    event, cell record and checkpoint cursor;
  * **the grid's monotonicity check** — ``SweepMonitor`` flags a higher-p
    cell whose failure rate sits decisively (Wilson CIs disjoint) below a
    lower-p cell's, as a structured ``anomaly``;
  * **run ledger** — ``RunLedger`` appends one JSONL record per sweep run
    (run id, config fingerprint, per-cell final counts + CIs, fit reports,
    anomalies) under a ``ledger/`` dir.

Free when disabled and bit-exact on/off: host bookkeeping over counts that
already crossed to the host.  The switch follows the telemetry enable;
``enable()`` / ``disable()`` force it.

The weighted (importance-sampled) runs' intervals map a weight stream to
its effective binomial counts (``ess_interval``, ``weighted_ci_fields``).

Not here yet (ROADMAP queue A item 10): the BP-statistics detectors
(stalled convergence, iteration-histogram drift), which read the device
telemetry vector, and the degradation-ladder detectors (the port has no
ladder).
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
    "note_fit",
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
# Anomaly monitor
# ---------------------------------------------------------------------------
def _log(event: str, **fields) -> None:
    from .observability import get_logger, log_record

    log_record(get_logger(), event, **fields)


class SweepMonitor:
    """Host-side estimator-health monitor for one sweep grid, fed finished
    cells via ``note_cell``.  ``finalize`` runs the grid check:

      * ``non_monotone_wer`` — within one (code, type, noise, cycles)
        curve, a higher-p cell's failure rate sits DECISIVELY below a
        lower-p cell's (Wilson CIs disjoint): the rate must be
        non-decreasing in p, so this flags a broken estimate, not noise.

    Each anomaly is a structured ``anomaly`` event plus ``diag.anomalies``
    / ``diag.anomaly.<kind>`` counters and a log line."""

    def __init__(self, grid: dict | None = None):
        self.grid = dict(grid or {})
        self.cells: list[dict] = []
        self.anomalies: list[dict] = []
        self._finalized = False

    def _anomaly(self, kind: str, **fields) -> None:
        rec = {"anomaly": kind, **fields}
        self.anomalies.append(rec)
        telemetry.count("diag.anomalies")
        telemetry.count(f"diag.anomaly.{kind}")
        telemetry.event("anomaly", **rec)
        _log("anomaly", **rec)

    def note_cell(self, cell_key: dict, wer: float, ci: dict | None) -> None:
        """Record one finished cell (ci: a ``ci_fields`` block or {})."""
        self.cells.append({"cell": dict(cell_key), "wer": float(wer),
                           **(ci or {})})

    def finalize(self) -> None:
        """The grid check once every cell is in.  Idempotent."""
        if self._finalized:
            return
        self._finalized = True
        self._check_monotone()

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

    def note_cell(self, cell_key: dict, wer: float, ci: dict | None) -> None:
        self.monitor.note_cell(cell_key, wer, ci)

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
    a SweepMonitor for the grid, and finalizes (grid check + ledger
    append) on exit.  Reentrant — a nested
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


def record_cell(cell_key: dict, wer: float, ci: dict | None = None) -> None:
    """Feed one finished cell to the active sweep run (monitor + ledger).
    No-op outside a run."""
    run = getattr(_TL, "run", None)
    if run is not None:
        run.note_cell(cell_key, wer, ci)


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
