"""Observability: stage timers and structured logging.

The reference has no tracing or logging at all — notebooks time whole sweeps
with ``time.time()`` prints (SURVEY §5).  Here every sweep stage can be
timed and the results are structured records.  The port's copy of the JAX
package's module; ``profile_trace`` traces a region with ``torch.profiler``
where the JAX package attaches its profiler.
"""
from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from collections import defaultdict

__all__ = ["stage_timer", "timings", "reset_timings", "profile_trace",
           "get_logger", "log_record"]

_TIMINGS: dict[str, list[float]] = defaultdict(list)
# timers may run on several threads; append and snapshot would
# interleave without this lock
_TIMINGS_LOCK = threading.Lock()


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate wall-clock for a named stage (sample/decode/osd/fit/...).

    with stage_timer("decode"):
        sim.WordErrorRate(...)

    When utils.telemetry is enabled, every stage timer is ALSO a telemetry
    span: the duration lands in the span histogram (utils/telemetry.span).
    """
    from . import telemetry

    t0 = time.perf_counter()
    try:
        with telemetry.span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _TIMINGS_LOCK:
            _TIMINGS[name].append(dt)


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated quantile of a pre-sorted sample."""
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def timings() -> dict[str, dict]:
    """Summary of accumulated stage timings per stage: count / total /
    mean plus the distribution — p50 / p95 / max.  A mean alone hides the
    exact long-tail behavior (one 10s stalled drain among a thousand 10ms
    ones) that stage timers exist to expose."""
    with _TIMINGS_LOCK:
        items = {name: list(vals) for name, vals in _TIMINGS.items()}
    out = {}
    for name, vals in items.items():
        if not vals:
            continue
        s = sorted(vals)
        out[name] = {
            "count": len(s),
            "total_s": round(sum(s), 6),
            "mean_s": round(sum(s) / len(s), 6),
            "p50_s": round(_quantile(s, 0.50), 6),
            "p95_s": round(_quantile(s, 0.95), 6),
            "max_s": round(s[-1], 6),
        }
    return out


def reset_timings() -> None:
    with _TIMINGS_LOCK:
        _TIMINGS.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace a region with ``torch.profiler`` (the host, and the card's
    kernels when CUDA is there) and write its Chrome trace under
    ``log_dir`` (``utils.profiling.parse_trace`` sums it).  A no-op
    context when the profiler cannot start (e.g. one is already
    running)."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 - the region runs untraced
        logging.getLogger("qldpc").warning("profiler not started: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def get_logger(name: str = "qldpc") -> logging.Logger:
    """Framework logger; INFO to stderr unless the app configured logging."""
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def log_record(logger: logging.Logger, event: str, **fields) -> None:
    """One structured (JSON) log line — grep/parse-friendly sweep records."""
    logger.info("%s %s", event, json.dumps(fields, sort_keys=True, default=str))
