"""Device selection and on-device control flow shared by the port.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller asks for it.  With no card and no explicit CPU request they raise:
nothing falls back to the CPU on its own.

``device_cond(pred, true_fn, false_fn)`` is the port's ``lax.cond``.  While
a CUDA graph is being captured (``graph_capture``), both branches are
captured as IF nodes of the graph (``csrc/graph_cond.cu``) on the device
scalar ``pred`` and on its negation, so a replay runs one branch and reads
nothing on the host; the outputs merge into one set of buffers.  Anywhere
else ``pred`` is read on the host and one branch runs.  ``host_value`` is
the read that picks a branch: it returns a count as a host int outside a
capture (counted in its owner's ``host_reads``) and leaves it on the device
during one.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import threading

import torch
import torch.utils._pytree as pytree

__all__ = ["resolve_device", "capturing", "graph_capture", "graph_nodes",
           "device_cond", "host_value"]

_state = threading.local()
# nesting depths whose body streams exist before a capture starts (the BP
# tier ladder nests four deep)
_PREMADE_DEPTHS = 8


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when it names CUDA and no card
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _traced() -> bool:
    """Whether branches stay on the device: during a capture, or under the
    both-branches test hook."""
    return getattr(_state, "both", False) or capturing()


class _Capture:
    """What ``device_cond`` needs of the graph being captured: the pool its
    IF bodies allocate from, and the node count of the bodies."""

    def __init__(self, device: torch.device):
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        # the bodies capture on their own streams, which the graph's pool
        # does not serve; their tensors live in this pool, kept with the graph
        self.body_pool = torch.cuda.MemPool()
        self.body_nodes = 0
        self.depth = 0


@contextlib.contextmanager
def graph_capture(graph: torch.cuda.CUDAGraph, device, stream):
    """``torch.cuda.graph(graph, stream=stream)`` with ``device_cond``'s
    conditional nodes enabled; yields the capture record (``body_pool``,
    which must live as long as the graph, and ``body_nodes``)."""
    if getattr(_state, "capture", None) is not None:
        raise RuntimeError("graph captures do not nest")
    rec = _Capture(torch.device(device))
    for depth in range(_PREMADE_DEPTHS):  # no stream creation mid-capture
        _body_stream(rec.device, depth)
    _state.capture = rec
    # torch.cuda.graph collects garbage before it begins; a collection
    # during the capture could free an earlier graph, whose teardown a
    # capture forbids
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream):
            yield rec
    finally:
        _state.capture = None
        if collecting:
            gc.enable()


def host_value(value: torch.Tensor, owner):
    """A device count a tier choice reads: the tensor itself while branches
    stay on the device, else its value as a host int, one read counted in
    ``owner.host_reads``."""
    if _traced():
        return value
    owner.host_reads += 1
    return int(value)


def _lib():
    from ..ops import _kernels

    lib = _kernels.library("graph_cond")
    if not getattr(lib, "_typed", False):
        P, U = ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)
        lib.graph_if_begin.argtypes = [P, P, P, ctypes.c_int]
        lib.graph_if_end.argtypes = [P, U]
        lib.graph_node_count.argtypes = [P, U]
        lib.graph_stream_create.argtypes = [ctypes.POINTER(P)]
        for fn in (lib.graph_if_begin, lib.graph_if_end,
                   lib.graph_node_count, lib.graph_stream_create):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The top-level node count of a graph captured with ``keep_graph``."""
    count = ctypes.c_ulonglong(0)
    rc = _lib().graph_node_count(graph.raw_cuda_graph(), ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed with CUDA error {rc}")
    return count.value


# (device index, nesting depth) -> the stream IF bodies at that depth capture
# on; siblings capture one after another, so a depth needs one stream
_body_streams: dict = {}


def _body_stream(device: torch.device, depth: int):
    key = (device.index, depth)
    stream = _body_streams.get(key)
    if stream is None:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = _lib().graph_stream_create(ctypes.byref(ptr))
        if rc != 0:
            raise RuntimeError(f"cudaStreamCreate failed with CUDA error {rc}")
        stream = _body_streams[key] = torch.cuda.ExternalStream(
            ptr.value, device=device)
    return stream


def _if_node(rec: _Capture, pred: torch.Tensor, negate: bool, fn):
    """``fn()`` captured as the body of an IF node on ``pred`` (negated with
    ``negate``), on the stream of its nesting depth."""
    lib = _lib()
    parent = torch.cuda.current_stream(rec.device)
    body = _body_stream(rec.device, rec.depth)
    rc = lib.graph_if_begin(parent.cuda_stream, body.cuda_stream,
                            pred.data_ptr(), int(negate))
    if rc != 0:
        raise RuntimeError(f"conditional node capture failed with CUDA "
                           f"error {rc}")
    if rec.depth == 0:
        torch._C._cuda_beginAllocateCurrentThreadToPool(
            rec.device.index, rec.body_pool.id)
    rec.depth += 1
    try:
        with torch.cuda.stream(body):
            return fn()
    finally:
        rec.depth -= 1
        if rec.depth == 0:
            # each begin takes a reference on the pool, which its release
            # gives back (as torch.cuda.use_mem_pool does); the MemPool's own
            # keeps the memory while the graph lives, and the pool is freed
            # with it
            torch._C._cuda_endAllocateToPool(rec.device.index,
                                             rec.body_pool.id)
            torch._C._cuda_releasePool(rec.device.index, rec.body_pool.id)
        nodes = ctypes.c_ulonglong(0)
        rc = lib.graph_if_end(body.cuda_stream, ctypes.byref(nodes))
        rec.body_nodes += nodes.value
        if rc != 0:
            raise RuntimeError(f"conditional node capture failed with CUDA "
                               f"error {rc}")


def _check_like(t_leaves, f_leaves, t_spec, f_spec) -> None:
    if t_spec != f_spec:
        raise ValueError(f"device_cond branches return different structures: "
                         f"{t_spec} vs {f_spec}")
    for a, b in zip(t_leaves, f_leaves):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            raise TypeError("device_cond branches must return tensors")
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            raise ValueError(f"device_cond branches differ: {a.shape} "
                             f"{a.dtype} vs {b.shape} {b.dtype}")


def _captured(rec: _Capture, pred: torch.Tensor, true_fn, false_fn):
    """Both branches as IF nodes on ``pred`` and ``!pred``; the true
    branch's outputs are copied into fresh buffers, which the false branch
    overwrites when it runs."""
    pred = pred.to(torch.bool).reshape(()).contiguous()
    out = {}

    def true_body():
        leaves, out["spec"] = pytree.tree_flatten(true_fn())
        out["leaves"] = [t.clone() for t in leaves]

    def false_body():
        leaves, spec = pytree.tree_flatten(false_fn())
        _check_like(out["leaves"], leaves, out["spec"], spec)
        for dst, src in zip(out["leaves"], leaves):
            dst.copy_(src)

    _if_node(rec, pred, False, true_body)
    _if_node(rec, pred, True, false_body)
    return pytree.tree_unflatten(out["leaves"], out["spec"])


def device_cond(pred, true_fn, false_fn):
    """``true_fn()`` if ``pred`` else ``false_fn()`` (module docstring).

    ``pred`` is a Python bool (the branch runs at once) or a 0-dim tensor.
    The branches take no arguments and return tensors (or a pytree of
    them) of the same structure, shapes and dtypes."""
    if getattr(_state, "both", False):
        t_leaves, t_spec = pytree.tree_flatten(true_fn())
        f_leaves, f_spec = pytree.tree_flatten(false_fn())
        _check_like(t_leaves, f_leaves, t_spec, f_spec)
        return pytree.tree_unflatten(
            [torch.where(torch.as_tensor(pred, device=a.device), a, b)
             for a, b in zip(t_leaves, f_leaves)], t_spec)
    if isinstance(pred, torch.Tensor):
        rec = getattr(_state, "capture", None)
        if capturing():
            if rec is None:
                raise RuntimeError("device_cond under a capture that "
                                   "graph_capture did not start")
            return _captured(rec, pred, true_fn, false_fn)
        device_cond.host_reads += 1
        pred = bool(pred)
    return true_fn() if pred else false_fn()


# reads of a tensor ``pred`` on the host (outside a capture)
device_cond.host_reads = 0


@contextlib.contextmanager
def _both_branches():
    """Test hook: within the block every ``device_cond`` runs both branches
    and selects the result with ``torch.where``, and ``host_value`` reads
    nothing: the contract a captured IF node needs, checked eagerly."""
    prev = getattr(_state, "both", False)
    _state.both = True
    try:
        yield
    finally:
        _state.both = prev
