"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``.  The build runs at first
use, keyed on a hash of the flags, the source and every ``csrc/`` header it
includes (transitively), into ``build/torch_kernels/`` at the root of the
checkout; ``build_all`` starts one ``nvcc`` per source at once.  Nothing
here runs when the module is imported.

``force_plain()`` makes every kernel wrapper take its plain PyTorch version
even for CUDA tensors.  It exists so a run can hold the whole pipeline on the
card against its plain versions; wrappers count no launch in that mode.
``force_eager()`` makes the megabatch driver run its batches eagerly on the
card instead of replaying a captured CUDA graph, so that a run can hold the
graph against the eager path.

Launch counts: each wrapper calls ``count_launch`` where it launches its
kernel.  Outside a CUDA-graph capture that adds one to the wrapper's
attribute at once.  During a capture it adds one to a device counter in the
same branch as the launch, so only replays that run the branch count;
``fold_launch_counts`` adds the device counters' growth to the attributes
(the megabatch driver reads them with its carry).  Within
``collect_costs()`` (a capture under ``utils.profiling``) each captured
launch is listed, with the operations and bytes its wrapper declares
(``declare_cost``).

The min-sum and elimination wrappers launch their kernels in the memory mode
(``MEMORY_MODES``, ``ELIM_MEMORY_MODES``) that their layouts pick from the
shape.  ``force_memory(mode)`` fixes the mode instead, so that a timing run can hold
the modes against each other at one shape; ``force_planes(form)`` fixes the
plane form (``PLANE_FORMS``) of the min-sum kernels' check-state mode.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils.device import capturing

__all__ = ["SOURCES", "build_all", "library", "force_plain", "plain_forced",
           "force_eager", "eager_forced", "MEMORY_MODES", "ELIM_MEMORY_MODES",
           "force_memory",
           "memory_mode", "PLANE_FORMS", "force_planes", "planes_form",
           "check_launch", "count_launch", "launch_counts",
           "fold_launch_counts", "collect_costs", "declare_cost"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("bp_minsum", "osd_elim", "gf2_sample", "gf2_residual",
           "fused_decode", "fused_decode_int8", "cs_sweep", "bp_int8",
           "graph_cond")
# -fmad=false keeps a*b+c from contracting into one FMA, so the kernels round
# exactly like their plain PyTorch versions and can be compared bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}
_lock = threading.Lock()
_force = threading.local()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources_of(name: str) -> list:
    """``csrc/<name>.cu`` and every file it includes with ``#include "..."``,
    transitively, in a stable order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources_of(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(target, tmp, process)`` or ``(target, None, None)``."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish_build(name, target, tmp, proc) -> Path:
    if proc is None:
        return target
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)
    return target


def build_all(names=SOURCES) -> dict:
    """Build every named kernel library, all ``nvcc`` runs at once; returns
    ``{name: path}``."""
    with _lock:
        started = {name: _start_build(name) for name in names}
        return {name: _finish_build(name, *started[name]) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all((name,))[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


@contextlib.contextmanager
def force_plain():
    """Within the block, kernel wrappers run their plain PyTorch versions on
    CUDA tensors too (this thread only)."""
    prev = getattr(_force, "on", False)
    _force.on = True
    try:
        yield
    finally:
        _force.on = prev


def plain_forced() -> bool:
    return getattr(_force, "on", False)


@contextlib.contextmanager
def force_eager():
    """Within the block, the megabatch driver runs its batches eagerly on
    the card, one host read per tier choice, in place of its captured CUDA
    graph (this thread only)."""
    prev = getattr(_force, "eager", False)
    _force.eager = True
    try:
        yield
    finally:
        _force.eager = prev


def eager_forced() -> bool:
    return getattr(_force, "eager", False)


@contextlib.contextmanager
def uncounted():
    """Within the block launches count nowhere (this thread only): the
    megabatch driver's warm-up before a capture."""
    prev = getattr(_force, "uncounted", False)
    _force.uncounted = True
    try:
        yield
    finally:
        _force.uncounted = prev


# (function, attribute) of every launch counter, in the order of their
# slots in the device counters
_COUNTERS: list = []
_COUNTER_SLOTS = 64
# device index -> [int64 device counters, their values last folded (host)]
_device_counts: dict = {}


def _slot(fn, attr: str) -> int:
    key = (fn, attr)
    if key not in _COUNTERS:
        if len(_COUNTERS) == _COUNTER_SLOTS:
            raise RuntimeError("no launch-counter slot left")
        _COUNTERS.append(key)
    return _COUNTERS.index(key)


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def launch_counts(device) -> torch.Tensor:
    """The int64 device counters of ``device`` (a CUDA device), made on
    first use; make them before a capture, which must not allocate them."""
    index = _index(device)
    entry = _device_counts.get(index)
    if entry is None:
        if capturing():
            raise RuntimeError("launch counters must exist before a capture")
        counts = torch.zeros(_COUNTER_SLOTS, dtype=torch.int64,
                             device=torch.device("cuda", index))
        entry = _device_counts[index] = [counts, [0] * _COUNTER_SLOTS]
    return entry[0]


# the counters that count every launch of their wrapper (the others count
# a mode's share of them)
_TOTAL_ATTRS = ("launches", "full_launches", "int8_launches")


@contextlib.contextmanager
def collect_costs():
    """Within the block (this thread) each counted launch appends
    ``[kernel, ops, bytes]`` to the yielded list, ``ops`` and ``bytes``
    None unless its wrapper declares them (``declare_cost``)."""
    prev = getattr(_force, "costs", None)
    _force.costs = costs = []
    try:
        yield costs
    finally:
        _force.costs = prev


def declare_cost(ops: float, nbytes: float) -> None:
    """The operations and bytes of the launch a wrapper just counted, for
    an enclosing ``collect_costs``."""
    costs = getattr(_force, "costs", None)
    if costs:
        costs[-1][1:] = [float(ops), float(nbytes)]


def count_launch(fn, attr: str, device, launched=True) -> None:
    """Count one launch of ``fn``'s kernel on ``device`` in ``fn.attr``
    (nothing when ``launched`` is false): at once, or during a CUDA-graph
    capture at each replay that runs it (module docstring)."""
    if not launched or getattr(_force, "uncounted", False):
        return
    if capturing():
        launch_counts(device)[_slot(fn, attr)].add_(1)
    else:
        setattr(fn, attr, getattr(fn, attr) + 1)
    costs = getattr(_force, "costs", None)
    if costs is not None and attr in _TOTAL_ATTRS:
        costs.append([fn.__name__, None, None])


def fold_launch_counts(device, values) -> None:
    """Add to each counted attribute its device counter's growth since the
    last fold; ``values`` are ``launch_counts(device)``'s values read on
    the host (a snapshot, in stream order)."""
    last = _device_counts[_index(device)][1]
    for i, (fn, attr) in enumerate(list(_COUNTERS)):
        grown = int(values[i]) - last[i]
        if grown:
            setattr(fn, attr, getattr(fn, attr) + grown)
            last[i] = int(values[i])


# where a kernel keeps one shot's working set: in its block's shared memory;
# in a device-memory scratch (the min-sum kernels keep their 16-bit planes
# staged); in a device-memory scratch with the graph's 32-bit planes read
# from device memory too (the min-sum kernels only); as one record per
# check and the totals in shared memory, the planes staged or read from
# device memory (the min-sum kernels' check-state mode only)
MEMORY_MODES = ("shared", "device", "device_planes", "checks")
# the elimination's (csrc/osd_elim.cu): its shot's matrix in shared memory;
# in a device-memory scratch (kGlobal); as the shot's m x m row transform
# in shared memory (kTransform).  "transform" is no min-sum mode, so it
# stays out of MEMORY_MODES, whose index is csrc/bp_minsum.cu's kMem.
ELIM_MEMORY_MODES = ("shared", "device", "transform")


@contextlib.contextmanager
def force_memory(mode: str):
    """Within the block, the min-sum and elimination wrappers launch their
    kernels in ``mode`` (one of MEMORY_MODES, or ``"transform"``, which
    only the elimination has) in place of the one their layouts pick (this
    thread only); a wrapper whose kernel has no such mode raises."""
    if mode not in MEMORY_MODES + ELIM_MEMORY_MODES[2:]:
        raise ValueError(f"memory mode {mode!r} is not one of "
                         f"{MEMORY_MODES + ELIM_MEMORY_MODES[2:]}")
    prev = getattr(_force, "memory", "auto")
    _force.memory = mode
    try:
        yield
    finally:
        _force.memory = prev


def memory_mode() -> str:
    """The mode ``force_memory`` fixes, else ``"auto"``: the layout's
    choice."""
    return getattr(_force, "memory", "auto")


# where the min-sum kernels' check-state mode ("checks") reads its graph
# from (csrc/bp_minsum.cu kPlanes, by index): 16-bit planes staged in
# shared memory, 16-bit planes read from device memory, 32-bit planes read
# from device memory
PLANE_FORMS = ("staged16", "global16", "global32")


@contextlib.contextmanager
def force_planes(form: str):
    """Within the block, the min-sum wrappers' check-state mode reads its
    planes in ``form`` (one of PLANE_FORMS) in place of the one its layout
    picks (this thread only)."""
    if form not in PLANE_FORMS:
        raise ValueError(f"plane form {form!r} is not one of {PLANE_FORMS}")
    prev = getattr(_force, "planes", None)
    _force.planes = form
    try:
        yield
    finally:
        _force.planes = prev


def planes_form():
    """The plane form ``force_planes`` fixes, else None: the layout's
    choice."""
    return getattr(_force, "planes", None)
