"""The port's federation gateway and routing ring (``serve/fleet.py``,
``serve/router.py``) against the JAX package's, on the CPU.

  * ``HashRing.order`` names the same owner, successor and ring order as
    the JAX package's for the same host labels and family keys, and moves
    placements as little when a host leaves.
  * ``merge_snapshots`` gives the JAX package's merge of the same per-host
    snapshots: counters summed bit-exactly, histograms added bucket by
    bucket, gauges per host, conflicts skipped.
  * The gateway's host-down deadman and ``/healthz`` under a host kill
    (an injectable clock and fetch) step exactly as the JAX gateway's on
    the same sequence, and the fleet HTTP plane over two live ops
    servers serves the merged view and flips ``/healthz`` to 503.

Tolerance: none (integer counters and ring positions are exact; the
histogram sums are compared to 1e-12).  Every socket has its own timeout.
"""
import json
import urllib.error
import urllib.request

import pytest

from qldpc_fault_tolerance_tpu.serve import fleet as jfleet
from qldpc_fault_tolerance_tpu.serve import router as jrouter
from qldpc_fault_tolerance_tpu_torch.serve import ops
from qldpc_fault_tolerance_tpu_torch.serve.fleet import (
    FleetGateway,
    merge_snapshots,
    start_fleet_thread,
)
from qldpc_fault_tolerance_tpu_torch.serve.router import HashRing
from qldpc_fault_tolerance_tpu_torch.utils import telemetry

TIMEOUT = 10.0


@pytest.fixture(autouse=True)
def _clean():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _counter(v):
    return {"type": "counter", "value": v}


@pytest.mark.parametrize("labels", [["h0", "h1"], ["h0", "h1", "h2", "h3"],
                                    ["a", "b", "c"]])
def test_hash_ring_order_equals_jax(labels):
    keys = [f"fam-{i:04x}{i * 7919:08x}" for i in range(64)]
    ring, jring = HashRing(labels), jrouter.HashRing(labels)
    for key in keys:
        order = ring.order(key)
        assert order == jring.order(key)
        assert sorted(order) == sorted(labels)
    # a host leaving moves only the families it owned
    smaller = HashRing(labels[1:])
    moved = [k for k in keys if ring.order(k)[0] != smaller.order(k)[0]]
    assert all(ring.order(k)[0] == labels[0] for k in moved)
    assert [smaller.order(k) for k in keys] == \
        [jrouter.HashRing(labels[1:]).order(k) for k in keys]


def _snapshots():
    h = {"type": "histogram", "buckets": [1.0, 2.0], "counts": [1, 2, 3],
         "sum": 4.5, "count": 6}
    h2 = {"type": "histogram", "buckets": [1.0, 2.0], "counts": [4, 5, 6],
          "sum": 2.5, "count": 15}
    h3 = {"type": "histogram", "buckets": [1.0, 3.0], "counts": [2, 2, 2],
          "sum": 6.0, "count": 6}
    bad = {"type": "histogram", "buckets": [9.0], "counts": [1, 1],
           "sum": 1.0, "count": 2}
    return [
        {"a": {"c": _counter(2 ** 53 + 1), "h": h,
               "g": {"type": "gauge", "value": 3.0, "ts": 1.0},
               "mix": _counter(1)},
         "b": {"c": _counter(3), "h": h2, "mix": bad}},
        {"a": {"h": h}, "b": {"h": h3}},
        {"x": {"bp.shots": _counter(3_000_000_001)},
         "y": {"bp.shots": _counter(4_000_000_007),
               "q": {"type": "gauge", "value": 5.0, "ts": 2.0}},
         "z": {}},
    ]


@pytest.mark.parametrize("case", range(3))
def test_merge_snapshots_equals_jax(case):
    snaps = _snapshots()[case]
    got, want = merge_snapshots(snaps), jfleet.merge_snapshots(snaps)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if case == 0:
        assert got["merged"]["c"]["value"] == 2 ** 53 + 4
        assert got["merged"]["h"]["counts"] == [5, 7, 9]
        assert abs(got["merged"]["h"]["sum"] - 7.0) < 1e-12
        assert got["skipped"] == ["mix"] and "g" not in got["merged"]


class _FakeFleet:
    """Two synthetic hosts behind a (label, path) -> dict fetch."""

    def __init__(self):
        self.snaps = {"a": {"bp.shots": _counter(1000)},
                      "b": {"bp.shots": _counter(2000)}}
        self.dead: set = set()

    def fetch(self, label, path):
        if label in self.dead:
            raise ConnectionError(f"{label} is down")
        if path == "/varz":
            return {"metrics": self.snaps[label]}
        if path == "/healthz":
            return {"ok": True}
        return {"active": [], "resolved": []}


def _kill_sequence(gateway_cls):
    """The JAX test's host-kill sequence on one gateway class: what each
    step observed."""
    fake = _FakeFleet()
    gw = gateway_cls({"a": "http://a:1", "b": "http://b:1"},
                     interval_s=5.0, down_after_s=12.0, now=lambda: 0.0,
                     fetch=fake.fetch)
    seen = [gw.scrape_once(now=0.0), gw.scrape_once(now=5.0)]
    hz = gw.healthz(now=5.0)
    seen += [(hz["ok"], hz["up"], hz["down"]),
             gw.merged()["merged"]["bp.shots"]["value"]]
    fake.dead.add("b")
    seen += [gw.scrape_once(now=10.0), gw.healthz(now=10.0)["ok"]]
    gw.scrape_once(now=20.0)
    hz = gw.healthz(now=20.0)
    seen += [gw.alerts.firing(), hz["ok"], hz["down"],
             hz["hosts"]["a"]["up"], hz["hosts"]["b"]["error"],
             [(a["alert"], a["host"]) for a in gw.alertz(now=20.0)["active"]]]
    fake.dead.discard("b")
    gw.scrape_once(now=25.0)
    seen += [gw.alerts.firing(), gw.healthz(now=25.0)["ok"],
             [r["alert"] for r in gw.alertz(now=25.0)["resolved"]]]
    return seen


def test_gateway_host_kill_deadman_and_healthz_equal_jax():
    got = _kill_sequence(FleetGateway)
    assert got == _kill_sequence(jfleet.FleetGateway)
    assert got[0] == {"a": True, "b": True} and got[2] == (True, 2, [])
    assert got[3] == 3000
    assert got[4] == {"a": True, "b": False} and got[5] is True
    assert got[6] == ["host_down:b"] and got[7] is False
    assert got[8] == ["b"] and got[10].startswith("ConnectionError")
    assert got[11] == [("host_down:b", "fleet")]
    assert got[12] == [] and got[13] is True and got[14] == ["host_down:b"]


class _StaticOps(ops.OpsServer):
    """An ops plane serving a fixed snapshot, so two in-process servers
    report distinct per-host metrics."""

    def __init__(self, snap):
        super().__init__()
        self._snap = snap

    def varz(self):
        return {"metrics": self._snap}


def _start_static(snap):
    server = _StaticOps(snap)
    loop, thread = ops.spawn_server_loop(server.start, "test-static-ops",
                                         "static ops")
    return ops.OpsHandle(server, loop, thread)


def _get(url):
    return json.loads(urllib.request.urlopen(url, timeout=TIMEOUT).read())


def test_fleet_plane_over_two_live_ops_servers_and_host_kill():
    buckets = [0.01, 0.1, 1.0]
    ca, cb = [90, 8, 2, 0], [10, 60, 25, 5]
    snap_a = {"bp.shots": _counter(3_000_000_001),
              "serve.latency_s": {"type": "histogram", "buckets": buckets,
                                  "counts": ca, "sum": 1.5, "count": 100}}
    snap_b = {"bp.shots": _counter(4_000_000_007),
              "serve.latency_s": {"type": "histogram", "buckets": buckets,
                                  "counts": cb, "sum": 9.0, "count": 100}}
    ha, hb = _start_static(snap_a), _start_static(snap_b)
    clk = {"t": 0.0}
    gw = FleetGateway({"a": "http://%s:%s" % ha.address,
                       "b": "http://%s:%s" % hb.address},
                      interval_s=5.0, down_after_s=12.0,
                      now=lambda: clk["t"])
    fh = start_fleet_thread(gw, scrape=False)
    b_alive = True
    try:
        base = "http://%s:%s" % fh.address
        assert gw.scrape_once(now=0.0) == {"a": True, "b": True}
        varz = _get(base + "/varz")
        assert varz["merged"]["bp.shots"]["value"] == 7_000_000_008
        assert varz["merged"]["serve.latency_s"]["counts"] == \
            [a + b for a, b in zip(ca, cb)]
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=TIMEOUT).read().decode()
        assert "qldpc_bp_shots 7000000008" in text.splitlines()
        assert _get(base + "/healthz")["up"] == 2
        hb.stop()
        b_alive = False
        clk["t"] = 20.0
        assert gw.scrape_once(now=20.0) == {"a": True, "b": False}
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT)
        assert exc.value.code == 503
        assert json.loads(exc.value.read())["down"] == ["b"]
        assert gw.alerts.firing() == ["host_down:b"]
    finally:
        fh.stop()
        ha.stop()
        if b_alive:
            hb.stop()


def test_fabric_and_native_modules_are_in_the_import_boundary():
    """``tests/test_torch_boundary.py`` scans every port module: the fabric
    and the host OSD's loader are among them and import no JAX."""
    import os

    from tests import test_torch_boundary as boundary

    scanned = {os.path.relpath(p, boundary.PORT) for p in boundary._sources()}
    new = {os.path.join("serve", "fleet.py"), os.path.join("serve", "router.py"),
           os.path.join("_native", "__init__.py"),
           os.path.join("decoders", "osd.py")}
    assert new <= scanned
    for rel in new:
        path = os.path.join(boundary.PORT, rel)
        assert not [m for m in boundary._imported_modules(path)
                    if boundary._forbidden(m)]
