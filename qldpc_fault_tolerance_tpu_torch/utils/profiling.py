"""Performance attribution: graph cost accounting, device-time waterfalls,
timing helpers, trace summaries and the card's launch gates.

The port's counterpart of the JAX package's ``utils/profiling.py``.  The
telemetry layer (``utils/telemetry.py``) says what ran; this module says
where the time and the bytes went:

  * **Graph cost accounting.**  The JAX package reads XLA's cost model of
    each compiled program; a captured CUDA graph has none.  The port
    records per captured graph label (``capture_jit_cost``, called by
    ``parallel.shots._capture_graph`` while profiling is on) a
    ``ProgramCost``: the graph's node count, the device memory its capture
    reserved for its private pool, and the analytic operations and bytes of the
    kernel launches it holds, where a launch wrapper declares them
    (``ops._kernels.declare_cost``: the min-sum kernels, with the counts
    of the "bound" column of PERF.md's kernel table at ``max_iter``
    iterations a shot, the most a launch can run).  ``derive_utilization``
    turns a measured shot rate and a cost into rates against
    ``device_peaks()``, the card's peaks.
  * **Device-time waterfall.**  ``engine_scope`` (opened by
    ``sim.common.resilient_engine_run``) accounts each megabatch replay
    launch and each host read inside a run (``record_dispatch``,
    ``record_host_sync``: the megabatch driver's replay and eager
    megabatch, its one read a megabatch, ``windowed_count``'s launches and
    host-OSD drains), so a run's wall decomposes into launch, host sync
    and an unattributed gap, with a ``dispatch_gap_fraction``.
    ``deep_timing`` times each dispatch with CUDA events and a synchronize
    (device time measured, the double-buffered drain serialized): for
    attribution passes, never for a headline time.  The JAX package's
    ``accumulate_counts`` has no counterpart in the port.
  * **Timing helpers.**  ``timeit_block``, ``per_call_seconds`` and
    ``measure_stages`` time with CUDA events on the card and
    ``time.perf_counter`` on the CPU.  CUDA events around a kernel of ~10
    microseconds time its launch as much as the kernel.
  * **Trace summary.**  ``parse_trace`` sums a ``torch.profiler`` Chrome
    trace (``export_chrome_trace``) into device time per kernel name.
  * **Gates.**  The JAX package's VMEM calibration table is a TPU
    measurement and is not read.  Its counterpart is the shared-memory and
    occupancy gates that the port's layouts compute from the card
    (``ops.bp_kernel.minsum_layout``, ``ops.osd_device.elim_layout``):
    ``smem_gates`` reports them per kernel, measured (the card's occupancy
    API) or computed without a card; ``note_unmeasured_gates`` surfaces
    the latter once.  ``probe_max_block`` keeps the JAX contract: a failed
    try is data, not a crash.

Everything is behind one switch and costs one boolean check when off;
``engine_scope`` also opens while telemetry is on, so heartbeat events
carry a waterfall without a separate opt-in.  Nothing here changes what a
run computes: results with profiling on equal those with it off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import gzip
import json
import os
import threading
import time

__all__ = [
    "enabled", "enable", "disable", "profile_session",
    "ProgramCost", "capture_jit_cost", "program_costs", "reset_costs",
    "device_peaks", "derive_utilization",
    "engine_scope", "current_scope", "run_heartbeat", "deep_timing",
    "deep_timing_enabled", "record_dispatch", "record_host_sync",
    "timed_dispatch", "timeit_block", "timeit_async", "per_call_seconds",
    "measure_stages",
    "parse_trace", "probe_max_block", "smem_gates", "note_unmeasured_gates",
    "H100_SXM_PEAKS",
]

# ---------------------------------------------------------------------------
# Enable switch
# ---------------------------------------------------------------------------
_ENABLED = False


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    """Turn the profiling layer on (graph cost capture and waterfall
    accounting).  Host-side only: no captured graph changes."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


@contextlib.contextmanager
def profile_session(reset: bool = True):
    """One profiling-enabled region: enable, yield, disable.  ``reset``
    clears the cost table first, so the session's captures are its own."""
    was = _ENABLED
    if reset:
        reset_costs()
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


# ---------------------------------------------------------------------------
# Graph cost accounting and the card's peaks
# ---------------------------------------------------------------------------
# NVIDIA H100 80GB HBM3 (SXM), measured at a 700.00 W power limit: device
# memory 3.35e12 B/s, float32 outside the tensor cores 67e12 op/s (132 SMs x
# 128 lanes x 2 x 1.98 GHz), 32-bit integer 64 lanes x 132 SMs x 1.98 GHz.
# The rates chip_smoke.py's bounds use; a card set below 700 W runs slower.
H100_SXM_PEAKS = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
                  "sm_count": 132, "clock_hz": 1.98e9,
                  "hbm_bytes_per_s": 3.35e12, "flops_per_s": 67e12,
                  "int32_ops_per_s": 64 * 132 * 1.98e9}


def device_peaks(device=None) -> dict:
    """``{"flops_per_s", "int32_ops_per_s", "hbm_bytes_per_s", "sm_count",
    "name", "source"}`` of ``device`` (the current CUDA device by default):
    the SM count, and the memory rate where the properties give the memory
    clock and bus width, from ``torch.cuda.get_device_properties``; the
    rest from ``H100_SXM_PEAKS`` (the clock and the per-SM lanes).  Without
    a card, ``H100_SXM_PEAKS`` itself."""
    import torch

    peaks = dict(H100_SXM_PEAKS, source="constants")
    peaks.pop("power_limit_w")
    if device is None and not torch.cuda.is_available():
        return peaks
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        return peaks
    props = torch.cuda.get_device_properties(dev)
    sms = int(getattr(props, "multi_processor_count", peaks["sm_count"]))
    scale = sms / H100_SXM_PEAKS["sm_count"]
    peaks.update(name=props.name, sm_count=sms, source="properties",
                 flops_per_s=H100_SXM_PEAKS["flops_per_s"] * scale,
                 int32_ops_per_s=H100_SXM_PEAKS["int32_ops_per_s"] * scale)
    clock_khz = getattr(props, "memory_clock_rate", None)
    bus_bits = getattr(props, "memory_bus_width", None)
    if clock_khz and bus_bits:  # double data rate
        peaks["hbm_bytes_per_s"] = 2.0 * clock_khz * 1e3 * bus_bits / 8
    return peaks


@dataclasses.dataclass
class ProgramCost:
    """What one captured graph holds: its nodes (conditional bodies
    included), the device memory its capture reserved, the kernel
    launches captured, and the operations and bytes of those whose wrapper
    declares them (``ops._kernels.declare_cost``)."""

    label: str
    nodes: int = 0
    pool_bytes: int = 0
    launches: int = 0
    costed_launches: int = 0
    ops: float = 0.0
    bytes_accessed: float = 0.0
    capture_s: float = 0.0

    @property
    def peak_bytes(self) -> int:
        """The graph's live-memory peak proxy, the JAX name for it: the
        device memory its capture reserved."""
        return self.pool_bytes

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_COSTS: dict = {}
_COSTS_LOCK = threading.Lock()


def capture_jit_cost(label: str, stats: dict, launch_costs=()) -> ProgramCost:
    """Record a captured graph's ``ProgramCost`` under ``label`` (the JAX
    name; on this card the graph's capture statistics ``stats`` with
    ``nodes``, ``pool_bytes`` and the capture's seconds, and
    ``launch_costs``, the ``(kernel, ops, bytes)`` that the captured
    launches declared).  Published as ``cost.<label>.*`` gauges and one
    ``program_cost`` event."""
    from . import telemetry

    costed = [c for c in launch_costs if c[1] is not None]
    cost = ProgramCost(
        label=str(label), nodes=int(stats.get("nodes", 0)),
        pool_bytes=int(stats.get("pool_bytes", 0)),
        launches=len(launch_costs), costed_launches=len(costed),
        ops=float(sum(c[1] for c in costed)),
        bytes_accessed=float(sum(c[2] for c in costed)),
        capture_s=float(sum(stats.get(k, 0.0) for k in (
            "warmup_s", "capture_s", "instantiate_s"))))
    with _COSTS_LOCK:
        _COSTS[cost.label] = cost
    for field in ("nodes", "pool_bytes", "ops", "bytes_accessed"):
        telemetry.set_gauge(f"cost.{cost.label}.{field}",
                            getattr(cost, field))
    telemetry.event("program_cost", **cost.to_dict())
    return cost


def program_costs() -> dict:
    """The recorded costs: ``{label: cost dict}``."""
    with _COSTS_LOCK:
        return {label: c.to_dict() for label, c in sorted(_COSTS.items())}


def reset_costs() -> None:
    with _COSTS_LOCK:
        _COSTS.clear()


def derive_utilization(cost, shots_per_call: int, rate_shots_per_s: float,
                       peaks: dict | None = None) -> dict:
    """Rates from a recorded graph cost and a measured shot rate:
    ``cost`` a ``ProgramCost``, its dict or its label; ``shots_per_call``
    the shots one replay covers (batch x batches a megabatch).  Returns
    per-shot operations and bytes and the fractions of ``device_peaks()``
    they reach at that rate ({} without a cost)."""
    if isinstance(cost, str):
        cost = program_costs().get(cost)
    if isinstance(cost, ProgramCost):
        cost = cost.to_dict()
    if not cost or not shots_per_call:
        return {}
    peaks = peaks or device_peaks()
    ops_per_shot = float(cost.get("ops", 0.0)) / shots_per_call
    bytes_per_shot = float(cost.get("bytes_accessed", 0.0)) / shots_per_call
    return {
        "ops_per_shot": ops_per_shot,
        "bytes_per_shot": bytes_per_shot,
        "pool_bytes": int(cost.get("pool_bytes", 0)),
        "hbm_gbps": rate_shots_per_s * bytes_per_shot / 1e9,
        "hbm_util": rate_shots_per_s * bytes_per_shot
        / peaks["hbm_bytes_per_s"],
        "ops_util": rate_shots_per_s * ops_per_shot / peaks["flops_per_s"],
    }


# ---------------------------------------------------------------------------
# Device-time waterfall
# ---------------------------------------------------------------------------
_SCOPES = threading.local()     # per-thread stack of _RunAccounting
_ACTIVE = 0                     # open scopes: the hot path's check
_ACTIVE_LOCK = threading.Lock()
_DEEP = False                   # per-dispatch CUDA-event timing


class _RunAccounting:
    """One run's stage accumulator, written by the run's thread."""

    __slots__ = ("engine", "t0", "launch_s", "device_s", "sync_s",
                 "n_dispatches", "n_syncs", "deep")

    def __init__(self, engine: str):
        self.engine = engine
        self.t0 = time.perf_counter()
        self.launch_s = 0.0
        self.device_s = 0.0     # deep timing only
        self.sync_s = 0.0
        self.n_dispatches = 0
        self.n_syncs = 0
        self.deep = _DEEP

    def waterfall(self, wall_s: float | None = None) -> dict:
        """The run's wall so far as stages.  ``dispatch_gap_fraction`` is
        the share of the wall not attributed to device work or host reads:
        under deep timing the device time is measured per dispatch;
        otherwise the launches' host time stands in for it, so the gap is
        an upper bound on the idle time."""
        wall = (time.perf_counter() - self.t0) if wall_s is None \
            else float(wall_s)
        busy = (self.device_s if self.deep else self.launch_s) + self.sync_s
        gap = max(0.0, wall - busy)
        stages = {"dispatch_launch_s": round(self.launch_s, 6),
                  "host_sync_s": round(self.sync_s, 6),
                  "host_gap_s": round(gap, 6)}
        if self.deep:
            stages["device_s"] = round(self.device_s, 6)
        return {"wall_s": round(wall, 6), "n_dispatches": self.n_dispatches,
                "n_syncs": self.n_syncs, "deep_timed": self.deep,
                "stages": stages,
                "dispatch_gap_fraction": round(gap / wall, 4) if wall > 0
                else None}


def _scope_stack() -> list:
    stack = getattr(_SCOPES, "stack", None)
    if stack is None:
        stack = _SCOPES.stack = []
    return stack


@contextlib.contextmanager
def engine_scope(engine: str):
    """One run's waterfall scope, open while profiling or telemetry is on
    (heartbeats need its stages); yields the accounting (None when
    closed)."""
    from . import telemetry

    global _ACTIVE
    if not (_ENABLED or telemetry.enabled()):
        yield None
        return
    acct = _RunAccounting(engine)
    stack = _scope_stack()
    stack.append(acct)
    with _ACTIVE_LOCK:
        _ACTIVE += 1
    try:
        yield acct
    finally:
        stack.pop()
        with _ACTIVE_LOCK:
            _ACTIVE -= 1


def current_scope():
    """The innermost open scope on this thread, or None."""
    if not _ACTIVE:
        return None
    stack = getattr(_SCOPES, "stack", None)
    return stack[-1] if stack else None


def run_heartbeat() -> dict | None:
    """The innermost scope's waterfall at its wall so far (what
    ``sim.common.record_wer_run`` puts in the run's heartbeat)."""
    acct = current_scope()
    return acct.waterfall() if acct is not None else None


@contextlib.contextmanager
def deep_timing():
    """Time each dispatch with CUDA events and a synchronize: device time
    measured, the double-buffered drain serialized.  For attribution
    passes only; it cannot run under ``parallel.shots.check_syncs``."""
    global _DEEP
    was = _DEEP
    _DEEP = True
    try:
        yield
    finally:
        _DEEP = was


def deep_timing_enabled() -> bool:
    return _DEEP


def record_dispatch(launch_s: float, device_s: float | None = None) -> None:
    """Account one dispatch: its launch's host time, and its device time
    under deep timing."""
    if not _ACTIVE:
        return
    for acct in _scope_stack():
        acct.launch_s += launch_s
        acct.n_dispatches += 1
        if device_s is not None:
            acct.device_s += device_s


def record_host_sync(seconds: float) -> None:
    """Account one blocking host read."""
    if not _ACTIVE:
        return
    for acct in _scope_stack():
        acct.sync_s += seconds
        acct.n_syncs += 1


def timed_dispatch(fn, device=None):
    """``fn()`` (one dispatch on ``device``) accounted in the open scopes:
    its launch time, and under deep timing its device time (CUDA events
    around it and a synchronize on the card; on the CPU, where a dispatch
    runs to its end, the call's time).  Nothing but the call when no scope
    is open."""
    if not _ACTIVE:
        return fn()
    cuda = device is not None and getattr(device, "type", device) == "cuda"
    if _DEEP and cuda:
        import torch

        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        launch = time.perf_counter() - t0
        end.synchronize()
        record_dispatch(launch, start.elapsed_time(end) / 1e3)
        return out
    t0 = time.perf_counter()
    out = fn()
    launch = time.perf_counter() - t0
    record_dispatch(launch, launch if _DEEP else None)
    return out


# ---------------------------------------------------------------------------
# Timing helpers
# ---------------------------------------------------------------------------
def _on_card(out) -> bool:
    import torch

    def cuda(x):
        return isinstance(x, torch.Tensor) and x.is_cuda

    if isinstance(out, (tuple, list)):
        return any(cuda(x) for x in out)
    return cuda(out)


def timeit_block(fn, *args, reps: int = 5, **kw):
    """Median seconds of one ``fn(*args)`` over ``reps`` calls, each
    waited for: CUDA events around each call when it works on the card,
    ``time.perf_counter`` otherwise.  Returns ``(seconds, last output)``."""
    import torch

    out = fn(*args, **kw)  # warm
    card = _on_card(out) and torch.cuda.is_available()
    times = []
    for _ in range(max(1, reps)):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def timeit_async(fn, *args, reps: int = 20, **kw):
    """Steady-state seconds per call: one warm call waited for, then
    ``reps`` calls launched back to back and waited for once, the time
    divided by ``reps`` (the wait's fixed cost spread over the calls).
    On the card the wait is a device synchronize.  Returns ``(seconds,
    last output)``."""
    import torch

    def wait(out):
        if _on_card(out) and torch.cuda.is_available():
            torch.cuda.synchronize()

    wait(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(max(1, reps)):
        out = fn(*args, **kw)
    wait(out)
    return (time.perf_counter() - t0) / max(1, reps), out


def per_call_seconds(fn, *args, lo: int = 3, hi: int = 23, trials: int = 3):
    """Median slope of the time of ``r`` chained calls of ``fn(*args)``
    between ``r = lo`` and ``r = hi`` (each batch waited for once), between
    CUDA events when the calls work on the card, by ``time.perf_counter``
    otherwise: a fixed cost per batch cancels."""
    import torch

    card = _on_card(fn(*args)) and torch.cuda.is_available()  # warm

    def run(reps):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return time.perf_counter() - t0

    slopes = sorted((run(hi) - run(lo)) / (hi - lo) for _ in range(trials))
    return slopes[len(slopes) // 2]


def measure_stages(stages, reps: int = 5) -> dict:
    """``{name: seconds}`` of ``[(name, zero-argument fn), ...]``, each
    warmed once and timed by ``timeit_block``."""
    return {name: timeit_block(fn, reps=reps)[0] for name, fn in stages}


# ---------------------------------------------------------------------------
# torch.profiler trace summary
# ---------------------------------------------------------------------------
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def parse_trace(path: str) -> dict:
    """Summary of a ``torch.profiler`` Chrome trace: ``path`` a trace file
    (``.json`` or ``.json.gz``) or a directory searched for ``*.json*``.
    Complete events (``ph == "X"``) are summed per name and split by
    category: device work (``kernel``, ``gpu_memcpy``, ``gpu_memset``)
    against host events.  Returns ``{"files", "device_s", "host_s",
    "kernels": {kernel name: device seconds}, "events": {name: seconds}}``
    (the 50 largest of each); an unreadable file is skipped."""
    files = ([path] if os.path.isfile(path) else sorted(
        glob.glob(os.path.join(path, "**", "*.json*"), recursive=True)))
    kernels: dict = {}
    events: dict = {}
    device_s = host_s = 0.0
    read = 0
    for fp in files:
        try:
            opener = gzip.open if fp.endswith(".gz") else open
            with opener(fp, "rt", encoding="utf-8", errors="replace") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            continue
        read += 1
        trace = data.get("traceEvents", []) if isinstance(data, dict) \
            else data
        for ev in trace:
            if not isinstance(ev, dict) or ev.get("ph") != "X":
                continue
            dur_s = float(ev.get("dur", 0)) * 1e-6
            name = str(ev.get("name", "?"))
            events[name] = events.get(name, 0.0) + dur_s
            if str(ev.get("cat", "")).lower() in _DEVICE_CATS:
                device_s += dur_s
                if str(ev.get("cat", "")).lower() == "kernel":
                    kernels[name] = kernels.get(name, 0.0) + dur_s
            else:
                host_s += dur_s

    def top(d):
        return {k: round(v, 9) for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:50]}

    return {"files": read, "device_s": round(device_s, 9),
            "host_s": round(host_s, 9), "kernels": top(kernels),
            "events": top(events)}


# ---------------------------------------------------------------------------
# The card's gates
# ---------------------------------------------------------------------------
def probe_max_block(try_launch, candidates) -> tuple[int, list]:
    """The largest working block of ``candidates`` (tried in the order
    given, largest first): ``try_launch(block)`` builds or launches it,
    and an exception or a false return marks it infeasible, as data, not
    a crash.  Returns ``(best, attempts)``: ``best`` 0 when nothing works,
    ``attempts`` ``(block, ok, error text or None)`` per try."""
    attempts = []
    best = 0
    for cand in candidates:
        cand = int(cand)
        try:
            ok = bool(try_launch(cand))
            err = None
        except Exception as e:  # noqa: BLE001 — a failed try is the probe
            ok, err = False, f"{type(e).__name__}: {e}"
        attempts.append((cand, ok, err[:200] if err else None))
        if ok:
            best = cand
            break
    return best, attempts


def smem_gates(B: int, m: int, n: int, rw: int, cw: int, fcap: int = 10,
               device=None) -> dict:
    """The shared-memory and occupancy gates of the port's kernels for a
    batch of ``B`` shots of an (m, n) check matrix of row weight ``rw``
    and column weight ``cw``: per kernel its launch layout (memory mode,
    threads, blocks, shared memory per block, resident blocks per SM) as
    the wrappers pick it.  On a CUDA ``device`` they come from the card
    (its SM count and occupancy API, ``"measured": True``); otherwise from
    ``H100_SXM_PEAKS``'s SM count with resident blocks by threads and
    shared memory alone (``"measured": False``)."""
    import torch

    from ..ops import bp_kernel, osd_device

    dev = torch.device(device) if device is not None else None
    card = dev is not None and dev.type == "cuda"
    sms = H100_SXM_PEAKS["sm_count"]
    gates = {}
    for name, bf16 in (("bp_minsum", False), ("bp_minsum_bf16", True)):
        lay = (bp_kernel.card_minsum_layout(dev, B, m, n, rw, cw, bf16)
               if card else bp_kernel.minsum_layout(
                   B, m, n, rw, cw, bf16, sms, memory="auto"))
        gates[name] = lay._asdict()
    for name, mode in (("osd_elim", "skip"), ("osd_elim_full", "full")):
        lay = (osd_device.card_elim_layout(dev, B, m, n, fcap, mode, cw=cw)
               if card else osd_device.elim_layout(
                   B, m, n, fcap, mode, sms, memory="auto", cw=cw))
        gates[name] = lay._asdict()
    return {"measured": card, "shape": {"B": B, "m": m, "n": n, "rw": rw,
                                        "cw": cw, "fcap": fcap},
            "kernels": gates}


_UNMEASURED_NOTED = False
_NOTE_LOCK = threading.Lock()


def note_unmeasured_gates(gates: dict | None = None) -> bool:
    """Emit once per process the ``unmeasured_gates`` event and the
    ``calibration.unmeasured_gates`` counter (one per kernel) for gates
    that no run on the card measured (``smem_gates(...)["measured"]``
    false).  Returns True when it fired."""
    global _UNMEASURED_NOTED
    if not gates or gates.get("measured"):
        return False
    with _NOTE_LOCK:
        if _UNMEASURED_NOTED:
            return False
        _UNMEASURED_NOTED = True
    from . import telemetry

    names = sorted(gates.get("kernels", {}))
    telemetry.count("calibration.unmeasured_gates", len(names))
    telemetry.event("unmeasured_gates", gates=names, backend="cpu")
    return True
