"""The port's runtime modules under the serve stack (``utils/telemetry.py``,
``tracing.py``, ``faultinject.py``, ``timeseries.py``, ``resilience.py``,
``progcache.py``, the package's ``reset_device_state`` and
``ops.bp._LruCache``) against the JAX package's, on the CPU.

The same calls go to both sides and their outputs are compared whole:
the Prometheus text, the event schema registry and ``validate_event``'s
verdicts, span trees and flight-recorder dumps, fault-plan firing,
``SeriesStore`` queries and ``RetryPolicy`` backoff sequences under one
seed.  Tolerance: none (ids and wall-clock stamps, which differ by nature,
are replaced before comparing).  ``classify_error`` is held on the port's
own classes: ``torch.cuda.OutOfMemoryError`` is "resource", the sticky
CUDA error texts are "deterministic"."""
import json
import os
import threading

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.utils import faultinject as jfi
from qldpc_fault_tolerance_tpu.utils import resilience as jres
from qldpc_fault_tolerance_tpu.utils import telemetry as jtel
from qldpc_fault_tolerance_tpu.utils import timeseries as jts
from qldpc_fault_tolerance_tpu.utils import tracing as jtr
import qldpc_fault_tolerance_tpu.serve  # noqa: F401 — registers metric help
import qldpc_fault_tolerance_tpu_torch as port
import qldpc_fault_tolerance_tpu_torch.serve  # noqa: F401 — the same
from qldpc_fault_tolerance_tpu_torch.decoders import bp_decoders
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.utils import faultinject as tfi
from qldpc_fault_tolerance_tpu_torch.utils import progcache
from qldpc_fault_tolerance_tpu_torch.utils import resilience as tres
from qldpc_fault_tolerance_tpu_torch.utils import telemetry as ttel
from qldpc_fault_tolerance_tpu_torch.utils import timeseries as tts
from qldpc_fault_tolerance_tpu_torch.utils import tracing as ttr

SIDES = {"jax": (jtel, jtr, jfi, jts, jres), "port": (ttel, ttr, tfi, tts, tres)}


@pytest.fixture(autouse=True)
def _clean():
    for tel, tr, fi, _ts, _res in SIDES.values():
        tel.disable()
        tel.reset()
        tr.recorder().clear()
        fi.deactivate()
    yield
    for tel, tr, fi, _ts, _res in SIDES.values():
        tel.disable()
        tel.reset()
        tr.recorder().clear()
        fi.deactivate()


def _metrics_scenario(tel):
    tel.enable()
    tel.count("serve.requests", 3)
    tel.count("serve.shots", 96)
    tel.set_gauge("serve.queue_depth", 7)
    tel.set_gauge("serve.queue_depth", 2)
    for v in (0.0004, 0.003, 0.02, 0.02, 1.5):
        tel.observe("serve.latency_s", v, buckets=tel.LATENCY_BUCKETS)
    tel.observe("serve.batch_occupancy", 0.55, buckets=(0.5, 1.0))
    tel.set_metric_help("serve.shots", "shots decoded\nby the service")
    text = tel.prometheus_text()
    tel.set_metric_help("serve.shots", None)
    return text, tel.snapshot()


def test_prometheus_text_and_snapshot_equal_jax():
    jtext, jsnap = _metrics_scenario(jtel)
    ttext, tsnap = _metrics_scenario(ttel)
    assert ttext == jtext
    assert _norm(tsnap, {}) == _norm(jsnap, {})
    assert ttel.PROMETHEUS_CONTENT_TYPE == jtel.PROMETHEUS_CONTENT_TYPE


def test_event_schema_registry_equals_jax():
    assert ttel.EVENT_SCHEMA_VERSION == jtel.EVENT_SCHEMA_VERSION
    assert ttel.EVENT_SCHEMAS == jtel.EVENT_SCHEMAS
    assert ttel.LATENCY_BUCKETS == jtel.LATENCY_BUCKETS
    assert ttel.ITER_BUCKETS == jtel.ITER_BUCKETS


@pytest.mark.parametrize("record", [
    {"kind": "serve_batch", "ts": 1.0, "session": "s", "requests": 2,
     "shots": 64, "bucket": 64, "ok": True, "fused": True, "lanes": 2},
    {"kind": "serve_batch", "ts": 1.0, "session": "s", "requests": "2"},
    {"kind": "serve_session", "ts": 1.0, "session": "s", "event": "heal",
     "syndrome_width": 300, "kernel_variant": "sparse_gather"},
    {"kind": "serve_request", "ts": 1.0},
    {"kind": "trace", "ts": 1.0, "trace_id": "t", "span_id": "s",
     "name": "queue_wait", "dur_s": 0.1},
    {"kind": "scale_event", "ts": "now"},
    {"kind": "no_such_kind", "ts": 1.0},
    {"kind": "alert_fired", "ts": 1.0, "rule": "r"},
    {"kind": "process_info", "ts": 1.0, "pid": 1, "hostname": "h"},
])
def test_validate_event_verdicts_equal_jax(record):
    assert ttel.validate_event(record) == jtel.validate_event(record)


def test_port_emits_schema_valid_process_and_snapshot_events():
    sink = ttel.MemorySink()
    ttel.add_sink(sink)
    try:
        with ttel.session():
            ttel.count("serve.requests")
    finally:
        ttel.remove_sink(sink)
    kinds = [r["kind"] for r in sink.records]
    assert kinds == ["telemetry_enabled", "process_info", "snapshot"]
    for rec in sink.records:
        assert ttel.validate_event(rec) == [], rec
    assert sink.records[-1]["compile"]["source"] == "cuda_graph"


def test_compile_stats_count_captures():
    before = ttel.compile_stats()
    ttel.note_capture(0.25)
    after = ttel.compile_stats()
    assert after["cuda.graph_captures"] == before["cuda.graph_captures"] + 1
    assert after["cuda.graph_captures.seconds"] == pytest.approx(
        before["cuda.graph_captures.seconds"] + 0.25)


def _norm(obj, ids):
    """``obj`` with ids, timestamps and pids replaced by stable tokens."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ("ts", "t0", "pid", "dur_s", "created", "last_ts",
                     "total_dur_s", "max_dur_s"):
                out[k] = "<" + k + ">"
            elif k in ("trace_id", "span_id", "parent_id") and v is not None:
                out[k] = ids.setdefault(v, f"id{len(ids)}")
            else:
                out[k] = _norm(v, ids)
        return out
    if isinstance(obj, list):
        return [_norm(v, ids) for v in obj]
    return obj


def _trace_scenario(tr, tmp):
    ctx = tr.TraceContext()
    wire = ctx.to_wire()
    back = tr.TraceContext.from_wire(wire)
    tr.record_span("queue_wait", back, dur_s=0.01, session="s")
    child = back.child()
    tr.record_span("device_decode", child, dur_s=0.02, shots=32,
                   amortized_over=2)
    with tr.span("respond", back, bytes=10):
        pass
    with pytest.raises(ValueError):
        with tr.span("slice", back):
            raise ValueError("boom")
    tr.flight_record("request", id="r1")
    records = tr.recorder().snapshot()
    tree = tr.trace_tree(tr.traces_from_records(records)[ctx.trace_id])
    rows = tr.trace_summaries(records, limit=5)
    path = tr.recorder().dump("watchdog: fired", tmp, extra={"label": "x"})
    dump = [json.loads(x) for x in open(path, encoding="utf-8")]
    ids = {}
    return (_norm(records, ids), _norm(tree, ids), _norm(rows, ids),
            _norm(dump, ids), os.path.basename(path).startswith("postmortem-"))


def test_tracing_spans_trees_and_dumps_equal_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j = _trace_scenario(jtr, str(tmp_path / "jax"))
    t = _trace_scenario(ttr, str(tmp_path / "port"))
    assert t == j
    assert t[-1] is True


def _fault_scenario(fi):
    plan = fi.FaultPlan([
        fi.Fault(site="serve_dispatch", kind="raise", after=1, count=2),
        fi.Fault(site="serve_dispatch", kind="deterministic", after=4),
        fi.Fault(site="serve_fused_dispatch", kind="device_restart"),
        fi.Fault(site="wire_send", kind="conn_drop", after=2)], seed=5)
    fired, enacted = [], []
    with plan.active():
        for site in ["serve_dispatch"] * 6 + ["serve_fused_dispatch"] * 2 \
                + ["wire_send"] * 4:
            try:
                fi.site(site, actions={
                    "device_restart": lambda f: enacted.append(f.kind)})
                fired.append((site, None))
            except Exception as exc:  # noqa: BLE001 — what fired is compared
                fired.append((site, type(exc).__name__))
    hits = {s: plan.hits(s) for s in ("serve_dispatch",
                                      "serve_fused_dispatch", "wire_send")}
    return fired, enacted, hits


def test_fault_plan_firing_equals_jax():
    assert _fault_scenario(tfi) == _fault_scenario(jfi)
    assert tfi.SITES == jfi.SITES
    plan = '{"seed": 3, "faults": [{"site": "serve_dispatch", "kind": "stall"}]}'
    assert vars(tfi.FaultPlan.from_json(plan).faults[0]) == \
        vars(jfi.FaultPlan.from_json(plan).faults[0])


def _series_scenario(ts):
    store = ts.SeriesStore(retention=16)
    for i in range(10):
        snap = {
            "serve.requests": {"type": "counter", "value": 5 * i},
            "serve.queue_depth": {"type": "gauge", "value": i % 3,
                                  "max": 2},
            "serve.latency_s": {"type": "histogram",
                                "buckets": [0.01, 0.1, 1.0],
                                "counts": [i, 2 * i, i // 2, 1],
                                "sum": 0.5 * i, "count": 3 * i + i // 2 + 1},
        }
        store.ingest(100.0 + i, snap)
    return (store.names(), store.rate("serve.requests", 5.0, now=109.0),
            store.last_value("serve.queue_depth"),
            store.quantile("serve.latency_s", 0.5, 5.0, now=109.0),
            store.quantile("serve.latency_s", 0.99, 8.0, now=109.0),
            store.window_hist("serve.latency_s", 5.0, now=109.0),
            store.age("serve.requests", now=109.0),
            ts.hist_quantile([0.01, 0.1, 1.0], [1, 2, 3, 0], 0.9))


def test_series_store_queries_equal_jax():
    assert _series_scenario(tts) == _series_scenario(jts)


def _retry_scenario(res, fi):
    policy = res.RetryPolicy(max_attempts=5, base_delay=0.5, backoff=3.0,
                             max_delay=4.0, jitter=0.25, seed=11)
    delays = [policy.delay(i) for i in range(8)]
    fast = res.RetryPolicy(max_attempts=4, base_delay=0.0, jitter=0.0,
                           reset_caches=False, degrade_after=2, seed=1)
    calls, steps = [], []
    ladder = res.DegradationLadder([("a", lambda: steps.append("a")),
                                    ("b", lambda: steps.append("b"))])

    def flaky():
        calls.append(len(calls))
        if len(calls) < 4:
            raise fi.InjectedFault("transient")
        return "ok"

    out = fast.run(flaky, label="x", degrade=ladder.step)
    with pytest.raises(ValueError):
        fast.run(lambda: (_ for _ in ()).throw(ValueError("bug")))
    return delays, out, len(calls), steps, ladder.remaining, policy.trivial


def test_retry_backoff_sequences_equal_jax():
    assert _retry_scenario(tres, tfi) == _retry_scenario(jres, jfi)


@pytest.mark.parametrize("exc,kind", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "resource"),
    (RuntimeError("CUDA error: out of memory"), "resource"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "deterministic"),
    (RuntimeError("CUDA error: device-side assert triggered"),
     "deterministic"),
    (RuntimeError("CUDA error: unspecified launch failure"),
     "deterministic"),
    (RuntimeError("CUDA error: misaligned address"), "deterministic"),
    (tfi.InjectedFault("injected"), "transient"),
    (tres.WatchdogTimeout("late"), "transient"),
    (ConnectionResetError("peer"), "transient"),
    (tres.MeshDeviceLoss("gone"), "resource"),
    (ValueError("bad shape"), "deterministic"),
    (RuntimeError("some other failure"), "deterministic"),
])
def test_classify_error_on_torch_errors(exc, kind):
    assert tres.classify_error(exc) == kind


def test_sticky_cuda_error_fails_fast_without_retry():
    policy = tres.RetryPolicy(max_attempts=5, base_delay=0.0,
                              reset_caches=False)
    calls = []

    def sticky():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with pytest.raises(RuntimeError):
        policy.run(sticky)
    assert len(calls) == 1


def test_policy_override_is_thread_local():
    base = tres.current_policy()
    seen = []
    with tres.policy_override(None):
        assert tres.current_policy() is None
        th = threading.Thread(target=lambda: seen.append(
            tres.current_policy()))
        th.start()
        th.join(timeout=10)
    assert not th.is_alive() and seen == [base]
    assert tres.current_policy() is base


def test_watchdog_fires_on_a_hung_fetch():
    release = threading.Event()
    with pytest.raises(tres.WatchdogTimeout):
        tres.fetch_with_watchdog(lambda: release.wait(5), label="t",
                                 timeout_s=0.05)
    release.set()
    assert tres.fetch_with_watchdog(lambda: 3, timeout_s=1.0) == 3


def test_reset_device_state_clears_memos_and_bumps_epoch():
    h = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    bp_decoders._per_h(h, torch.device("cpu"), "minimum_sum")
    progcache.compile_cached(lambda: object(), kind="t", parts={"a": 1})
    epoch = tres.device_epoch()
    assert bp_decoders._PER_H
    port.reset_device_state()
    assert not bp_decoders._PER_H
    assert tres.device_epoch() == epoch + 1
    assert progcache.load_cached("t", {"a": 1}) is None


def test_progcache_single_flight_and_in_process_only():
    progcache.reset(purge_stats=True)
    built = []
    gate = threading.Event()

    def build():
        gate.wait(5)
        built.append(1)
        return object()

    out = []
    threads = [threading.Thread(target=lambda: out.append(
        progcache.compile_cached(build, kind="k", parts={"b": 64})))
        for _ in range(4)]
    for th in threads:
        th.start()
    gate.set()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert len(built) == 1
    assert sorted(src for _p, src in out) == ["compile", "mem", "mem", "mem"]
    assert len({id(p) for p, _src in out}) == 1
    # inactive by default: the build stays in process, nothing is stored
    assert not progcache.active()
    stats = progcache.stats()
    assert (stats["mem_hits"], stats["misses"], stats["stores"]) == (3, 1, 0)
    assert progcache.hit_rate() == 0.75
    key = progcache.cache_key("k", {"b": 64})
    assert key == progcache.cache_key("k", {"b": 64})
    assert key != progcache.cache_key("k", {"b": 128})
    assert progcache.evict(key) and progcache.load_cached("k", {"b": 64}) is None
    progcache.configure(None)
    assert not progcache.active()


@pytest.mark.parametrize("impl", [jbp._LruCache, tbp._LruCache],
                         ids=["jax", "port"])
def test_lru_cache_eviction_clear_and_failed_build(impl):
    cache = impl(maxsize=2)
    evicted = []
    cache.on_evict = lambda k, v: evicted.append(k)
    for k in "abc":
        cache.get(k, lambda k=k: k.upper())
    assert cache.keys() == ["b", "c"] and evicted == ["a"]
    with pytest.raises(KeyError):
        cache.peek("a")
    with pytest.raises(RuntimeError):
        cache.get("d", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert cache.get("d", lambda: "D") == "D" and "d" in cache
    cache.clear()
    assert len(cache) == 0
