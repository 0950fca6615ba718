"""Cross-host federation gateway, the JAX package's ``serve/fleet.py``
on the port's ops plane (jax-free there, kept as the port's own copy).

One serving host exposes /metrics /healthz /varz /tracez /alertz through
``ops.OpsServer``; a fleet needs those surfaces ONCE, not N times.  The
:class:`FleetGateway` scrapes every configured host's ops endpoint on an
interval, merges what it finds, and re-serves the fleet view on the same
stdlib-asyncio HTTP shape:

  * ``/metrics`` — merged Prometheus exposition: counter totals summed
    **bit-exactly** (integer sums of integer samples) and histogram bucket
    vectors added element-wise when boundaries agree (the bucket-boundary
    registry in utils.telemetry makes that the common case — a boundary
    mismatch skips the merge and is counted, never fudged), each with
    per-host labeled samples next to the unlabeled fleet total; gauges are
    inherently per-host (a queue depth does not sum) so they appear ONLY
    host-labeled, staleness stamps intact.
  * ``/healthz`` — per-host up/down + each host's own ok verdict, and an
    aggregate ``ok`` that is true only when every host is up and healthy.
  * ``/alertz`` — the union of every host's active/resolved alerts, each
    tagged with its host label, plus the gateway's own rules: host-down is
    itself an alert via the **deadman** kind (a host's successful-scrape
    heartbeat stops moving -> ``host_down:<label>`` fires).

Scraping rides ``/varz`` (the JSON snapshot) rather than parsing the text
exposition: merges then operate on exact integers, not rendered floats.
Host liveness heartbeats are fed into the gateway's own
:class:`utils.timeseries.SeriesStore` as synthetic counters, so the
deadman machinery is EXACTLY the one the local alert engine uses — same
store, same rule class, same transition events — and works with an
injectable clock for deterministic tests.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request

from ..utils import telemetry, timeseries
from . import ops

__all__ = [
    "FleetGateway", "FleetServer", "FleetHandle", "start_fleet_thread",
    "merge_snapshots",
]

DEFAULT_SCRAPE_INTERVAL_S = 5.0
DEFAULT_TIMEOUT_S = 5.0


def merge_snapshots(per_host: dict) -> dict:
    """Merge {host_label: registry-snapshot} into one fleet snapshot.

    Counters sum bit-exactly; histograms add bucket vectors + sum/count
    when every host agrees on boundaries (mismatches leave the metric
    unmerged, reported in ``skipped``); gauges never merge.  Returns
    ``{"merged": {name: metric}, "gauges": {name: {host: metric}},
    "skipped": [name, ...]}``.
    """
    merged: dict = {}
    gauges: dict = {}
    skipped: list = []
    for host in sorted(per_host):
        for name, m in per_host[host].items():
            kind = m.get("type")
            if kind == "gauge":
                gauges.setdefault(name, {})[host] = m
                continue
            if kind not in ("counter", "histogram") or name in skipped:
                continue
            cur = merged.get(name)
            if cur is None:
                if kind == "counter":
                    merged[name] = {"type": "counter", "value": m["value"]}
                else:
                    merged[name] = {
                        "type": "histogram",
                        "buckets": list(m["buckets"]),
                        "counts": list(m["counts"]),
                        "sum": m["sum"], "count": int(m["count"]),
                    }
                continue
            if cur["type"] != kind:
                skipped.append(name)
                merged.pop(name, None)
                continue
            if kind == "counter":
                cur["value"] += m["value"]
            else:
                if list(m["buckets"]) != cur["buckets"] or \
                        len(m["counts"]) != len(cur["counts"]):
                    skipped.append(name)
                    merged.pop(name, None)
                    continue
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], m["counts"])]
                cur["sum"] += m["sum"]
                cur["count"] += int(m["count"])
    return {"merged": merged, "gauges": gauges, "skipped": sorted(skipped)}


class FleetGateway:
    """Scrape N ops endpoints, merge, alert on host loss.

    ``targets`` maps a host label to an ops base URL
    (``{"a": "http://127.0.0.1:9001", ...}``).  ``scrape_once(now)`` is
    the synchronous unit tests drive with an injectable clock and a
    pluggable ``fetch`` (label, path) -> dict; ``start()`` runs it on a
    daemon thread (HealthProbe's ``Event.wait`` loop).  ``down_after_s``
    is the deadman window for the per-host heartbeat (default 3 scrape
    intervals).
    """

    def __init__(self, targets: dict, *,
                 interval_s: float = DEFAULT_SCRAPE_INTERVAL_S,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 down_after_s: float | None = None,
                 now=time.time, fetch=None):
        self.targets = {str(k): str(v).rstrip("/")
                        for k, v in dict(targets).items()}
        if not self.targets:
            raise ValueError("FleetGateway needs at least one target")
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.down_after_s = (3.0 * self.interval_s if down_after_s is None
                             else float(down_after_s))
        self._now = now
        self._fetch = fetch if fetch is not None else self._fetch_http
        self._lock = threading.Lock()
        # per-host scrape state: snap/health/alertz payloads + bookkeeping
        self._hosts: dict[str, dict] = {
            label: {"ok_scrapes": 0, "last_ok": None, "last_error": None,
                    "snap": {}, "healthz": None, "alertz": None}
            for label in self.targets}
        self.scrapes = 0
        self.t_started = now()
        # the gateway's OWN time-series + alert engine: one deadman rule
        # per host over its successful-scrape heartbeat
        self.store = timeseries.SeriesStore()
        self.alerts = ops.AlertEngine(store=self.store, now=now)
        for label in sorted(self.targets):
            self.alerts.add_rule(ops.AlertRule(
                name=f"host_down:{label}",
                metric=f"fleet.host.{label}.ok_scrapes",
                kind="deadman", window_s=self.down_after_s,
                severity="critical"))
        # merge loss is operator-visible, not just a /varz list: every scrape whose merge skipped metrics (type
        # conflict / histogram boundary mismatch) bumps a counter, and a
        # default rate rule pages while skips keep happening
        self._merge_skips = 0
        self.alerts.add_rule(ops.AlertRule(
            name="fleet_merge_skips", metric="fleet.merge_skips",
            kind="threshold", mode="rate", op=">", threshold=0.0,
            window_s=self.down_after_s, severity="warning"))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _fetch_http(self, label: str, path: str) -> dict:
        url = self.targets[label] + path
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def scrape_once(self, now=None) -> dict:
        """One scrape round over every host; returns {label: up_bool}.
        The heartbeat counters are ingested and the host-down deadman
        rules evaluated at the SAME ``now``, so tests step time
        explicitly."""
        now = self._now() if now is None else now
        up: dict = {}
        for label in sorted(self.targets):
            state = self._hosts[label]
            try:
                varz = self._fetch(label, "/varz")
                healthz = self._fetch(label, "/healthz")
                alertz = self._fetch(label, "/alertz")
            except Exception as exc:  # host down IS the signal, not a bug
                up[label] = False
                with self._lock:
                    state["last_error"] = f"{type(exc).__name__}: {exc}"
                telemetry.count("fleet.scrape_errors")
                continue
            up[label] = True
            with self._lock:
                state["ok_scrapes"] += 1
                state["last_ok"] = now
                state["last_error"] = None
                state["snap"] = varz.get("metrics", {})
                state["healthz"] = healthz
                state["alertz"] = alertz
        with self._lock:
            self.scrapes += 1
            heartbeats = {
                f"fleet.host.{label}.ok_scrapes":
                    {"type": "counter",
                     "value": self._hosts[label]["ok_scrapes"]}
                for label in self.targets}
            per_host = {label: st["snap"] for label, st in
                        self._hosts.items() if st["snap"]}
        # count this round's merge skips (a skipped metric stays skipped
        # every round it conflicts — the rate rule fires for as long as
        # the conflict persists, which is exactly the operator signal)
        skips = len(merge_snapshots(per_host)["skipped"])
        if skips:
            telemetry.count("fleet.merge_skips", skips)
        with self._lock:
            self._merge_skips += skips
            heartbeats["fleet.merge_skips"] = {
                "type": "counter", "value": self._merge_skips}
        self.store.ingest(now, heartbeats)
        self.alerts.evaluate(now=now)
        telemetry.count("fleet.scrapes")
        telemetry.set_gauge("fleet.host_up", sum(up.values()))
        return up

    # ------------------------------------------------------------------
    def merged(self) -> dict:
        """The current merge (see :func:`merge_snapshots`) over the last
        successful snapshot of every host that has one."""
        with self._lock:
            per_host = {label: st["snap"] for label, st in
                        self._hosts.items() if st["snap"]}
        return merge_snapshots(per_host)

    def metrics_text(self) -> str:
        """Fleet Prometheus exposition: per family one HELP/TYPE, the
        unlabeled fleet total (counters/histograms), and per-host labeled
        samples (counters and gauges — gauges have no total)."""
        with self._lock:
            per_host = {label: dict(st["snap"]) for label, st in
                        self._hosts.items() if st["snap"]}
        fleet = merge_snapshots(per_host)
        pt = telemetry  # naming helpers live with the local exposition
        lines = []
        for name in sorted(set(fleet["merged"]) | set(fleet["gauges"])):
            pn = pt._prom_name(name)
            if name in fleet["merged"]:
                m = fleet["merged"][name]
                lines.append(f"# HELP {pn} "
                             f"{pt._prom_help(pt.metric_help(name))}")
                lines.append(f"# TYPE {pn} {m['type']}")
                if m["type"] == "counter":
                    lines.append(f"{pn} {pt._prom_num(m['value'])}")
                    for host in sorted(per_host):
                        hm = per_host[host].get(name)
                        if hm is not None:
                            lines.append(f'{pn}{{host="{host}"}} '
                                         f'{pt._prom_num(hm["value"])}')
                else:
                    acc = 0
                    for edge, c in zip(m["buckets"], m["counts"]):
                        acc += c
                        lines.append(f'{pn}_bucket{{le='
                                     f'"{pt._prom_num(edge)}"}} {acc}')
                    acc += m["counts"][-1]
                    lines.append(f'{pn}_bucket{{le="+Inf"}} {acc}')
                    lines.append(f"{pn}_sum {pt._prom_num(m['sum'])}")
                    lines.append(f"{pn}_count {m['count']}")
            else:
                lines.append(f"# HELP {pn} "
                             f"{pt._prom_help(pt.metric_help(name))}")
                lines.append(f"# TYPE {pn} gauge")
                for host, hm in sorted(fleet["gauges"][name].items()):
                    lines.append(f'{pn}{{host="{host}"}} '
                                 f'{pt._prom_num(hm["value"])}')
        return "\n".join(lines) + "\n"

    def healthz(self, now=None) -> dict:
        """Per-host up/down + aggregate.  A host is up when its heartbeat
        deadman is NOT firing and its own /healthz said ok."""
        now = self._now() if now is None else now
        firing = set(self.alerts.firing())
        hosts = {}
        ok = True
        n_up = 0
        with self._lock:
            for label, st in sorted(self._hosts.items()):
                host_up = f"host_down:{label}" not in firing \
                    and st["last_ok"] is not None
                host_ok = bool(st["healthz"] and st["healthz"].get("ok"))
                hosts[label] = {
                    "up": host_up, "ok": host_ok,
                    "last_ok_age_s": (None if st["last_ok"] is None
                                      else round(now - st["last_ok"], 3)),
                    "ok_scrapes": st["ok_scrapes"],
                    "error": st["last_error"],
                }
                n_up += bool(host_up)
                ok = ok and host_up and host_ok
        return {"ok": ok, "hosts": hosts, "up": n_up,
                "down": sorted(label for label, h in hosts.items()
                               if not h["up"]),
                "targets": len(self.targets),
                "uptime_s": round(now - self.t_started, 3)}

    def alertz(self, now=None) -> dict:
        """Fleet alert view: every host's active/resolved alerts tagged
        with its label, plus the gateway's own (host-down deadman)
        tagged ``host="fleet"``."""
        own = self.alerts.report(now=now)
        active = [dict(a, host="fleet") for a in own["active"]]
        resolved = [dict(r, host="fleet") for r in own["resolved"]]
        with self._lock:
            for label, st in sorted(self._hosts.items()):
                hz = st["alertz"]
                if not hz:
                    continue
                active.extend(dict(a, host=label)
                              for a in hz.get("active", ()))
                resolved.extend(dict(r, host=label)
                                for r in hz.get("resolved", ()))
        return {"active": active, "resolved": resolved,
                "hosts": sorted(self.targets), "scrapes": int(self.scrapes)}

    def host_loads(self) -> dict:
        """Per-host load signal for the fleet scaler: each host's last
        /healthz queue depth (None while a host has never been scraped or
        its healthz omitted one).  Reads the scrape cache only — never
        blocks on the network."""
        with self._lock:
            return {label: (st["healthz"] or {}).get("queue_depth")
                    for label, st in self._hosts.items()}

    def varz(self) -> dict:
        fleet = self.merged()
        with self._lock:
            merge_skips = int(self._merge_skips)
        return {"targets": dict(self.targets),
                "scrapes": int(self.scrapes),
                "merged": fleet["merged"],
                "gauges": fleet["gauges"],
                "merge_skipped": fleet["skipped"],
                "merge_skips": merge_skips}

    # -- daemon loop (Event.wait, no bare sleep) ------------------------
    def start(self) -> "FleetGateway":
        if self._thread is not None:
            return self
        self._stop.clear()
        t = threading.Thread(target=self._run, name="qldpc-fleet-gateway",
                             daemon=True)
        self._thread = t
        t.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the loop never dies
                telemetry.count("fleet.loop_errors")

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None


class FleetServer(ops.OpsServer):
    """The fleet HTTP face: same GET-only asyncio shape as the per-host
    ops plane, but every endpoint answers from the gateway's merged
    state.  ``/varz`` shows the merge itself (inputs + skips) so a
    boundary mismatch is visible, not silent."""

    def __init__(self, gateway: FleetGateway,
                 host: str = "127.0.0.1", port: int = 0):
        super().__init__(host=host, port=port)
        self.gateway = gateway

    def healthz(self) -> dict:
        return self.gateway.healthz()

    def varz(self) -> dict:
        return self.gateway.varz()

    def alertz(self) -> dict:
        return self.gateway.alertz()

    def _route(self, target: str) -> bytes:
        telemetry.count("fleet.ops.requests")
        path = target.split("?", 1)[0]
        try:
            if path == "/metrics":
                return ops._http_response(
                    200, self.gateway.metrics_text(),
                    content_type=telemetry.PROMETHEUS_CONTENT_TYPE)
            if path == "/healthz":
                body = self.healthz()
                return ops._http_response(
                    200 if body.get("ok") else 503,
                    json.dumps(body, sort_keys=True, default=str))
            if path == "/varz":
                return ops._http_response(200, json.dumps(
                    self.varz(), sort_keys=True, default=str))
            if path == "/alertz":
                return ops._http_response(200, json.dumps(
                    self.alertz(), sort_keys=True, default=str))
            return ops._http_response(404, json.dumps(
                {"error": f"unknown path {path!r}", "paths":
                 ["/metrics", "/healthz", "/varz", "/alertz"]}))
        except Exception as exc:  # noqa: BLE001 — an ops bug must answer
            return ops._http_response(500, json.dumps(
                {"error": f"{type(exc).__name__}: {exc}"}))


class FleetHandle(ops.OpsHandle):
    """A FleetServer + its gateway scrape loop, stopped together."""

    def __init__(self, server: FleetServer, loop, thread):
        super().__init__(server, loop, thread)
        self.gateway = server.gateway

    def stop(self, timeout: float = 10.0) -> None:
        self.gateway.stop(timeout)
        super().stop(timeout)


def start_fleet_thread(gateway: FleetGateway, host: str = "127.0.0.1",
                       port: int = 0, *, scrape: bool = True) -> FleetHandle:
    """Serve the fleet view on a daemon thread (and start the scrape loop
    unless ``scrape=False`` — tests drive ``scrape_once`` themselves)."""
    server = FleetServer(gateway, host=host, port=port)
    loop, thread = ops.spawn_server_loop(server.start, "qldpc-fleet-ops",
                                         "fleet gateway")
    if scrape:
        gateway.start()
    return FleetHandle(server, loop, thread)
