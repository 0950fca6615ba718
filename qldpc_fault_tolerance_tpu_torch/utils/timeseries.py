"""Time-series retention over the telemetry registry.

``telemetry.snapshot()`` is point-in-time: it answers "what is the counter
now", never "how fast is it moving" or "what was p99 over the last minute".
This module adds the missing axis.  A :class:`Scraper` samples the registry
on a fixed interval into a :class:`SeriesStore` — bounded ring retention per
metric — from which windowed derivations fall out:

  * **counters** are stored as monotone samples; ``rate(name, window_s)``
    is the positive-delta sum over the window divided by elapsed time, so a
    process restart (value decrease) contributes zero instead of a huge
    negative rate;
  * **gauges** are last-value series (with the per-set ``ts`` stamp the
    registry records, so staleness survives into retention);
  * **histograms** are stored as cumulative bucket vectors; a windowed
    quantile is derived from the **bucket-count delta** between the window's
    edge samples, interpolated within the winning bucket exactly like the
    lifetime quantile in ``scripts/telemetry_report.py``.

The same ``ingest(ts, snapshot)`` path serves both the live scraper and
offline reconstruction from a JSONL stream's ``snapshot`` events
(``telemetry_report --rates``), so the derivations are tested once.

Cost model: the scraper thread wakes every ``interval_s`` (default 5 s),
takes one registry snapshot (a dict copy under the registry lock) and
appends one sample per metric to a ``deque(maxlen=...)``.  When telemetry
is disabled the tick is a single boolean check — same zero-cost contract
as every other telemetry path.

Per-series ``last_change_ts`` tracking feeds the deadman alert kind
(serve.ops.AlertEngine): a heartbeat is "this counter moved / this gauge
was re-set recently", and :meth:`SeriesStore.age` answers how long ago
that last happened.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import deque

from . import telemetry

__all__ = [
    "SeriesStore", "Scraper", "hist_quantile",
    "DEFAULT_INTERVAL_S", "DEFAULT_RETENTION",
]

DEFAULT_INTERVAL_S = 5.0
# ring capacity in samples per metric: at the 5 s default interval this
# retains 20 minutes — enough for any rule window the alert engine ships
DEFAULT_RETENTION = 240


def hist_quantile(buckets, counts, q):
    """Quantile from per-bucket (non-cumulative) counts by linear
    interpolation within the winning bucket.  ``counts`` has
    ``len(buckets) + 1`` entries (overflow last); returns None on an empty
    window, and the last finite edge when the quantile lands in overflow."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    acc = 0.0
    lo = 0.0
    for edge, c in zip(buckets, counts):
        if acc + c >= target and c > 0:
            frac = (target - acc) / c
            return lo + frac * (edge - lo)
        acc += c
        lo = edge
    return float(buckets[-1]) if buckets else None


class _Series:
    """One metric's bounded ring: (ts, payload) samples plus the
    last-change stamp the deadman kind keys on."""

    __slots__ = ("kind", "samples", "last_change_ts")

    def __init__(self, kind: str, capacity: int):
        self.kind = kind
        self.samples: deque = deque(maxlen=capacity)
        self.last_change_ts = None

    def append(self, ts, payload, changed: bool):
        self.samples.append((ts, payload))
        if changed or self.last_change_ts is None:
            self.last_change_ts = ts


class SeriesStore:
    """Bounded per-metric retention with windowed derivations.

    All state lives behind one instance lock; payloads are immutable
    (numbers / tuples), so query methods copy only sample lists.
    """

    def __init__(self, retention: int = DEFAULT_RETENTION):
        self.retention = int(retention)
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}

    # -- ingestion ---------------------------------------------------------
    def ingest(self, ts: float, snap: dict) -> None:
        """Fold one registry snapshot (``telemetry.snapshot()`` shape, or a
        JSONL ``snapshot`` event's ``metrics`` dict) taken at time ``ts``."""
        with self._lock:
            for name, m in snap.items():
                kind = m.get("type")
                if kind == "counter":
                    payload = m["value"]
                elif kind == "gauge":
                    payload = (m["value"], m.get("ts"))
                elif kind == "histogram":
                    payload = (tuple(m["counts"]), float(m["sum"]),
                               int(m["count"]))
                else:
                    continue
                s = self._series.get(name)
                if s is None:
                    s = self._series[name] = _Series(kind, self.retention)
                elif s.kind != kind:  # re-registered under a new type
                    s = self._series[name] = _Series(kind, self.retention)
                changed = (not s.samples) or s.samples[-1][1] != payload
                s.append(ts, payload, changed)

    # -- raw access --------------------------------------------------------
    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def kind(self, name: str):
        with self._lock:
            s = self._series.get(name)
            return s.kind if s else None

    def samples(self, name: str) -> list:
        """The retained (ts, payload) samples, oldest first."""
        with self._lock:
            s = self._series.get(name)
            return list(s.samples) if s else []

    def _window(self, name: str, window_s, now):
        """Samples inside [now - window_s, now], oldest first (lock held by
        caller-facing wrappers)."""
        s = self._series.get(name)
        if s is None:
            return []
        pts = list(s.samples)
        if window_s is None:
            return pts
        t0 = now - float(window_s)
        lo = bisect.bisect_left(pts, t0, key=lambda p: p[0])
        return pts[lo:]

    # -- derivations -------------------------------------------------------
    def rate(self, name: str, window_s, now=None):
        """Counter rate over the trailing window: positive-delta sum /
        elapsed.  None when fewer than two samples land in the window."""
        now = time.time() if now is None else now
        with self._lock:
            pts = self._window(name, window_s, now)
        if len(pts) < 2:
            return None
        delta = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            if b > a:  # a decrease is a counter reset, not negative traffic
                delta += b - a
        elapsed = pts[-1][0] - pts[0][0]
        return (delta / elapsed) if elapsed > 0 else None

    def last_value(self, name: str):
        """Most recent sample value (gauge value / counter value /
        histogram count); None when the series is empty."""
        with self._lock:
            s = self._series.get(name)
            if s is None or not s.samples:
                return None
            ts, payload = s.samples[-1]
            if s.kind == "gauge":
                return payload[0]
            if s.kind == "histogram":
                return payload[2]
            return payload

    def gauge_set_ts(self, name: str):
        """The registry's last-set stamp for a gauge series (staleness)."""
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "gauge" or not s.samples:
                return None
            return s.samples[-1][1][1]

    def quantile(self, name: str, q: float, window_s, now=None):
        """Windowed histogram quantile from cumulative-bucket deltas between
        the window's edge samples (see :meth:`window_hist`); boundaries come
        from the registered default spec, falling back to arity-matching the
        shipped ladders."""
        got = self.window_hist(name, window_s, now=now)
        if got is None:
            return None
        buckets, counts, _sum, _count = got
        return hist_quantile(buckets, counts, q)

    def window_hist(self, name: str, window_s, now=None):
        """(buckets, delta_counts, delta_sum, delta_count) over the trailing
        window, or None.  With one sample in the window the delta is taken
        against the newest sample *before* it (so a fresh window still
        reports traffic); with no earlier sample the lifetime cumulative
        counts stand in."""
        now = time.time() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "histogram" or not s.samples:
                return None
            pts = list(s.samples)
        if window_s is None:
            in_win, before = pts, []
        else:
            t0 = now - float(window_s)
            lo = bisect.bisect_left(pts, t0, key=lambda p: p[0])
            in_win, before = pts[lo:], pts[:lo]
        if not in_win:
            return None
        last = in_win[-1][1]
        base = before[-1][1] if before else (
            in_win[0][1] if len(in_win) > 1 else None)
        buckets = self._buckets_for(name, len(last[0]) - 1)
        if base is None:
            counts = list(last[0])
            dsum, dcount = last[1], last[2]
        else:
            if last[2] < base[2]:  # histogram reset mid-window
                counts = list(last[0])
                dsum, dcount = last[1], last[2]
            else:
                counts = [b - a for a, b in zip(base[0], last[0])]
                dsum, dcount = last[1] - base[1], last[2] - base[2]
        return buckets, counts, dsum, dcount

    @staticmethod
    def _buckets_for(name: str, n_edges: int):
        # boundaries are not retained per sample (they are fixed per
        # histogram for its lifetime); prefer the registered default spec,
        # else infer the shipped ladder by count arity
        spec = telemetry.default_buckets(name)
        if spec is not None and len(spec) == n_edges:
            return tuple(spec)
        for ladder in (telemetry.LATENCY_BUCKETS,
                       telemetry.DEFAULT_TIME_BUCKETS,
                       telemetry.ITER_BUCKETS):
            if len(ladder) == n_edges:
                return tuple(ladder)
        return tuple(range(1, n_edges + 1))

    def set_buckets(self, name: str, buckets) -> None:
        """Pin bucket boundaries for offline reconstruction (the JSONL
        snapshot events carry them; the live path never needs this)."""
        telemetry.set_default_buckets(name, buckets)

    def age(self, name: str, now=None):
        """Seconds since the series last *changed* (counter moved, gauge
        re-set, histogram observed).  None when the series was never seen —
        deadman rules treat that as "no heartbeat yet"."""
        now = time.time() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None or s.last_change_ts is None:
                return None
            return now - s.last_change_ts


class Scraper:
    """Background sampler: telemetry registry -> :class:`SeriesStore` on a
    fixed interval, with tick hooks the alert engine rides.

    ``scrape_once(now)`` is the synchronous unit (tests drive it with an
    injectable clock); ``start()`` runs it on a daemon thread using the
    same ``Event.wait`` loop as serve.ops.HealthProbe.  Disabled telemetry
    makes a tick one boolean check.
    """

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 retention: int = DEFAULT_RETENTION,
                 store: SeriesStore | None = None, now=time.time,
                 emit_snapshot_events: bool = False):
        self.interval_s = float(interval_s)
        self.store = store if store is not None else SeriesStore(retention)
        self._now = now
        # True: each tick also writes a kind="snapshot" event to the
        # sinks, so a JSONL stream carries the retention an offline
        # ``telemetry_report --rates`` rebuilds its store from
        self.emit_snapshot_events = bool(emit_snapshot_events)
        self._hooks: tuple = ()
        self._hook_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def add_tick_hook(self, fn) -> None:
        """Register ``fn(store, now)`` to run after every scrape (the alert
        engine's evaluation hook).  Hook errors are counted, not raised —
        a broken rule must not kill the sampling loop."""
        with self._hook_lock:
            self._hooks = self._hooks + (fn,)

    def scrape_once(self, now=None) -> bool:
        """One tick: snapshot -> ingest -> hooks.  Returns False when
        telemetry is disabled (nothing sampled)."""
        if not telemetry.enabled():
            return False
        now = self._now() if now is None else now
        self.store.ingest(now, telemetry.snapshot())
        telemetry.count("timeseries.scrapes")
        if self.emit_snapshot_events:
            telemetry.write_snapshot_event()
        for fn in self._hooks:
            try:
                fn(self.store, now)
            except Exception:
                telemetry.count("timeseries.hook_errors")
        return True

    # -- daemon loop (HealthProbe pattern: Event.wait, no bare sleep) ------
    def start(self) -> "Scraper":
        if self._thread is not None:
            return self
        self._stop.clear()
        t = threading.Thread(target=self._run, name="timeseries-scraper",
                             daemon=True)
        self._thread = t
        t.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self.scrape_once()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None
