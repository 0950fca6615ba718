"""In-process cache of captured decode programs, content-addressed.

The port's counterpart of the JAX package's ``utils/progcache.py``, its
in-process half.  A program here is what a serve session replays for one
shape bucket: a captured CUDA graph on the card, the eager decode on the
CPU (``serve/session.py``).  ``compile_cached(build, kind=, parts=)`` keys
it by ``cache_key(kind, parts)`` and builds it once per process: population
rides the shared single-flight ``ops.bp._LruCache``, so concurrent first
requests for one program capture it once, and different keys overlap.

A captured graph reads its decoder state at the addresses it was captured
with, so a program is only shareable between callers whose state is the
same: the parts of a serve program name the state's content (a digest of
its tensors) as well as its shapes, and the program keeps that state
alive.

The disk half (serialized programs that survive the process) is not
ported: ``configure(root)`` with a directory raises.

Counters (module-local ``stats()``, mirrored into telemetry as
``progcache.*``): ``mem_hits``, ``misses``, ``stores``.
"""
from __future__ import annotations

import threading
import time

__all__ = [
    "cache_key",
    "clear_memory",
    "compile_cached",
    "configure",
    "evict",
    "hit_rate",
    "load_cached",
    "reset",
    "stats",
]

_MEM_SIZE = 256

_lock = threading.RLock()
_mem = None                       # shared single-flight _LruCache

_STATS_KEYS = ("mem_hits", "misses", "stores")
_stats = {k: 0 for k in _STATS_KEYS}


def _count(name: str, n: int = 1) -> None:
    from . import telemetry

    with _lock:
        _stats[name] = _stats.get(name, 0) + n
    telemetry.count(f"progcache.{name}", n)


def stats() -> dict:
    """Counter snapshot (independent of the telemetry switch)."""
    with _lock:
        return dict(_stats)


def hit_rate() -> float:
    """hits / (hits + misses) over this process's lifetime (0.0 when the
    cache never fielded a request)."""
    s = stats()
    total = s["mem_hits"] + s["misses"]
    return s["mem_hits"] / total if total else 0.0


def configure(root: str | None) -> None:
    """``None`` keeps the cache in process (the only mode the port has);
    a directory raises, since the disk cache is not ported."""
    if root:
        raise NotImplementedError(
            "the port's program cache is in-process only: the disk cache "
            f"(serialized programs under {root!r}) is not ported")
    clear_memory()


def reset(purge_stats: bool = False) -> None:
    """Drop every program; with ``purge_stats`` zero the counters too."""
    if purge_stats:
        with _lock:
            for k in _STATS_KEYS:
                _stats[k] = 0
    clear_memory()


def _memcache():
    global _mem
    with _lock:
        if _mem is None:
            from ..ops.bp import _LruCache

            _mem = _LruCache(maxsize=_MEM_SIZE)
        return _mem


def clear_memory() -> None:
    """Drop every in-process program (``reset_device_state``).  Holders
    of a program (a session) keep it until they swap it out."""
    with _lock:
        mem = _mem
    if mem is not None:
        mem.clear()


def cache_key(kind: str, parts: dict) -> str:
    """Content address for one program: a digest of the canonicalized
    ``{kind, parts}`` document (``diagnostics.config_signature``: keys
    sorted, floats rounded).  ``parts`` values may be any repr-stable
    objects; they are stringified first.  Every key of one process shares
    its toolchain, so no toolchain fingerprint joins the key: that comes
    with the disk cache, where programs outlive the process."""
    from .diagnostics import config_signature

    doc = {"kind": str(kind),
           "parts": {str(k): repr(v) for k, v in dict(parts).items()}}
    return config_signature(doc)


def evict(key: str) -> bool:
    """Drop one program; True when it was resident."""
    return _memcache().pop(key)


def compile_cached(build, *, kind: str, parts: dict):
    """The cache-or-build front door: ``build()`` (which captures) runs
    once per key and process.  Returns ``(program, source)``, source
    ``"mem"`` (a hit) or ``"compile"`` (this call built it)."""
    key = cache_key(kind, parts)
    source = []

    def make():
        _count("misses")
        t0 = time.perf_counter()
        prog = build()
        from . import telemetry

        telemetry.observe("progcache.compile_s", time.perf_counter() - t0)
        _count("stores")
        source.append("compile")
        return prog

    prog = _memcache().get(key, make)
    if not source:
        _count("mem_hits")
        return prog, "mem"
    return prog, "compile"


def load_cached(kind: str, parts: dict):
    """Load-only probe: the resident program for ``(kind, parts)``, or
    None; never builds."""
    try:
        prog = _memcache().peek(cache_key(kind, parts))
    except KeyError:
        return None
    _count("mem_hits")
    return prog
