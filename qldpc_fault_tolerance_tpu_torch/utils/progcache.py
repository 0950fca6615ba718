"""Content-addressed cache of decode programs: in process, and on disk.

The port's counterpart of the JAX package's ``utils/progcache.py``.  A
program here is what a serve session replays for one shape bucket: a
captured CUDA graph on the card, the eager decode on the CPU
(``serve/session.py``).

  * **In process.**  ``compile_cached(build, kind=, parts=)`` keys a
    program by ``cache_key(kind, parts)`` and builds it once per process;
    population rides the shared single-flight ``ops.bp._LruCache``, so
    concurrent first requests for one program build it once and different
    keys overlap.  A captured graph reads its decoder state at the
    addresses it was captured with, so the parts of a serve program name
    the state's content (a digest of its tensors) as well as its shapes.
  * **On disk** (inactive by default; ``configure(root)`` or
    ``QLDPC_PROGCACHE_DIR``).  One ``<key>.qpc`` artifact per entry under
    the root, written atomically (a temporary file, then a rename).  A
    CUDA graph cannot be serialized, so an artifact holds what a fresh
    process can reload without rebuilding it: a serve program's bucket and
    layout picks (``compile_cached(save=, load=)``), and a session's
    decoder state tensors (``store_artifact`` / ``load_artifact``).  A
    program loaded from disk rebuilds no decoder state but captures its
    graph again: every such load counts one ``recaptures`` (the JAX
    package's ``serialize_unsupported`` case, where its loads recompile);
    a load never reports a graph as loaded from disk.
  * **Key anatomy.**  ``fingerprint()`` joins every key: the torch and
    CUDA versions, the device's name and compute capability, the build
    hash of every ``csrc/`` source (``ops._kernels._target``) and an
    optional ``QLDPC_PROGCACHE_SALT``.  An artifact whose recorded
    fingerprint differs from the loader's is a miss
    (``fingerprint_rejects``), never a crash.
  * **Corruption.**  A truncated, foreign or unloadable artifact is
    counted (``load_errors``), deleted, built again and replaced.

Counters (module-local ``stats()``, mirrored into telemetry as
``progcache.*``): ``mem_hits``, ``disk_hits``, ``misses``, ``stores``,
``store_errors``, ``load_errors``, ``fingerprint_rejects`` and
``recaptures`` (programs loaded from disk whose graph was captured again).
"""
from __future__ import annotations

import os
import threading
import time

__all__ = [
    "ARTIFACT_SUFFIX",
    "active",
    "cache_dir",
    "cache_key",
    "clear_memory",
    "compile_cached",
    "configure",
    "evict",
    "fingerprint",
    "has_artifact",
    "hit_rate",
    "load_artifact",
    "load_cached",
    "memory_generation",
    "reset",
    "stats",
    "store_artifact",
]

ARTIFACT_SUFFIX = ".qpc"
_SCHEMA = 1
_MEM_SIZE = 256

_lock = threading.RLock()
_root: str | None = None          # the configured root (None: inactive)
_configured = False               # configure() called (overrides the env)
_mem = None                       # shared single-flight _LruCache
_mem_gen = 0                      # bumped by clear_memory()
_fingerprint_cache: dict | None = None

_STATS_KEYS = ("mem_hits", "disk_hits", "misses", "stores", "store_errors",
               "load_errors", "fingerprint_rejects", "recaptures")
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
    """hits / (hits + misses) over this process's lifetime, memory and
    disk hits together (0.0 when the cache fielded no request)."""
    s = stats()
    hits = s["mem_hits"] + s["disk_hits"]
    total = hits + s["misses"]
    return hits / total if total else 0.0


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def configure(root: str | None) -> None:
    """Point the disk cache at ``root`` (created on demand); ``None``
    keeps it inactive.  Overrides ``QLDPC_PROGCACHE_DIR`` until
    ``reset()``."""
    global _root, _configured
    with _lock:
        _root = os.path.abspath(root) if root else None
        _configured = True
    clear_memory()


def reset(purge_stats: bool = False) -> None:
    """Back to the environment's configuration and an empty memory; with
    ``purge_stats`` the counters zeroed too."""
    global _root, _configured, _fingerprint_cache
    with _lock:
        _root = None
        _configured = False
        _fingerprint_cache = None
        if purge_stats:
            for k in _STATS_KEYS:
                _stats[k] = 0
    clear_memory()


def cache_dir() -> str | None:
    """The disk cache's root, or None when it is inactive."""
    with _lock:
        if _configured:
            return _root
    env = os.environ.get("QLDPC_PROGCACHE_DIR")
    return os.path.abspath(env) if env else None


def active() -> bool:
    return cache_dir() is not None


def _memcache():
    global _mem
    with _lock:
        if _mem is None:
            from ..ops.bp import _LruCache

            _mem = _LruCache(maxsize=_MEM_SIZE)
        return _mem


def clear_memory() -> None:
    """Drop every in-process program (``reset_device_state``); the disk
    artifacts stay valid.  Bumps ``memory_generation``.  Holders of a
    program (a session) keep it until they swap it out."""
    global _mem_gen
    with _lock:
        _mem_gen += 1
        mem = _mem
    if mem is not None:
        mem.clear()


def memory_generation() -> int:
    with _lock:
        return _mem_gen


# ---------------------------------------------------------------------------
# key anatomy
# ---------------------------------------------------------------------------
def fingerprint(refresh: bool = False) -> dict:
    """The toolchain half of every key: torch and CUDA versions, the
    current device's name and compute capability (the CPU without a
    card), the build hash of every ``csrc/`` source and
    ``QLDPC_PROGCACHE_SALT``.  An artifact recorded under another
    fingerprint is a miss."""
    global _fingerprint_cache
    with _lock:
        if _fingerprint_cache is not None and not refresh:
            return dict(_fingerprint_cache)
    import torch

    from ..ops import _kernels

    fp = {"schema": _SCHEMA, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "salt": os.environ.get("QLDPC_PROGCACHE_SALT", ""),
          "kernels": {name: _kernels._target(name).stem.rsplit("_", 1)[-1]
                      for name in _kernels.SOURCES}}
    if torch.cuda.is_available():
        index = torch.cuda.current_device()
        fp["device"] = torch.cuda.get_device_name(index)
        fp["capability"] = list(torch.cuda.get_device_capability(index))
    else:
        fp["device"], fp["capability"] = "cpu", None
    with _lock:
        _fingerprint_cache = dict(fp)
    return fp


def cache_key(kind: str, parts: dict) -> str:
    """Content address for one entry: a digest of the canonicalized
    ``{fingerprint, kind, parts}`` document (``diagnostics.
    config_signature``: keys sorted, floats rounded).  ``parts`` values
    may be any repr-stable objects; they are stringified first."""
    from .diagnostics import config_signature

    doc = {"fingerprint": fingerprint(), "kind": str(kind),
           "parts": {str(k): repr(v) for k, v in dict(parts).items()}}
    return config_signature(doc)


def _artifact_path(key: str) -> str | None:
    root = cache_dir()
    if root is None:
        return None
    return os.path.join(root, key[:2], key + ARTIFACT_SUFFIX)


def has_artifact(key: str) -> bool:
    """Whether ``key`` is resident in this process or on disk (no
    load)."""
    try:
        _memcache().peek(key)
        return True
    except KeyError:
        pass
    path = _artifact_path(key)
    return path is not None and os.path.exists(path)


def evict(key: str) -> bool:
    """Drop one entry from memory and from disk (a stale artifact); True
    when it was resident in either."""
    resident = _memcache().pop(key)
    path = _artifact_path(key)
    removed = False
    if path is not None:
        try:
            os.remove(path)
            removed = True
        except OSError:
            pass
    return bool(resident) or removed


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------
def _store(key: str, payload, label: str, build_s: float) -> None:
    """Write one artifact atomically: ``payload`` (tensors on the CPU,
    numbers, strings, tuples) with the key, the fingerprint and what the
    build cost.  A failed write is counted, never raised."""
    import torch

    path = _artifact_path(key)
    if path is None:
        return
    doc = {"schema": _SCHEMA, "key": key,
           "meta": {"fingerprint": fingerprint(), "label": str(label),
                    "build_s": float(build_s), "created": time.time()},
           "payload": payload}
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(doc, tmp)
        os.replace(tmp, path)
        _count("stores")
    except Exception:  # noqa: BLE001 — a full disk must not fail a decode
        _count("store_errors")
        try:
            os.remove(tmp)
        except OSError:
            pass


def _drop(path: str) -> None:
    _count("load_errors")
    try:
        os.remove(path)
    except OSError:
        pass


def _load(key: str):
    """One disk probe: the artifact's payload, or None (a miss).  A
    truncated or foreign artifact is counted and deleted, so the caller's
    build replaces it; one recorded under another fingerprint is a miss."""
    import torch

    path = _artifact_path(key)
    if path is None or not os.path.exists(path):
        return None
    t0 = time.perf_counter()
    try:
        doc = torch.load(path, map_location="cpu", weights_only=False)
        if not isinstance(doc, dict) or doc.get("schema") != _SCHEMA \
                or doc.get("key") != key or "payload" not in doc:
            raise ValueError("artifact header mismatch")
    except Exception:  # noqa: BLE001 — a corrupt entry is replaced
        _drop(path)
        return None
    meta = doc.get("meta") or {}
    if meta.get("fingerprint") != fingerprint():
        _count("fingerprint_rejects")
        return None
    from . import telemetry

    telemetry.observe("progcache.load_s", time.perf_counter() - t0)
    saved = meta.get("build_s")
    if isinstance(saved, (int, float)) and saved > 0:
        telemetry.observe("progcache.compile_s_saved", float(saved))
    return doc["payload"]


def _from_disk(key: str, load):
    """``load(payload)`` of ``key``'s artifact (a program whose graph it
    captures again), or None on a miss; a payload ``load`` refuses is a
    load error, deleted."""
    payload = _load(key)
    if payload is None:
        return None
    try:
        prog = load(payload)
    except Exception:  # noqa: BLE001 — refused picks, a stale payload
        _drop(_artifact_path(key))
        return None
    _count("disk_hits")
    _count("recaptures")
    return prog


def store_artifact(kind: str, parts: dict, payload, label: str = "",
                   build_s: float = 0.0) -> bool:
    """Write ``payload`` under ``cache_key(kind, parts)`` (the disk cache
    active; False otherwise)."""
    if not active():
        return False
    _store(cache_key(kind, parts), payload, label or kind, build_s)
    return True


def load_artifact(kind: str, parts: dict):
    """The payload stored under ``cache_key(kind, parts)``, or None (the
    cache inactive, a miss, a corrupt or foreign artifact); a hit counts
    one ``disk_hits``."""
    if not active():
        return None
    payload = _load(cache_key(kind, parts))
    if payload is not None:
        _count("disk_hits")
    return payload


# ---------------------------------------------------------------------------
# the front doors
# ---------------------------------------------------------------------------
def compile_cached(build, *, kind: str, parts: dict, save=None, load=None,
                   label: str = ""):
    """The cache-or-build front door.  Returns ``(program, source)``,
    source ``"mem"`` (a hit in this process), ``"disk"`` (``load(payload)``
    of an artifact: its graph captured again) or ``"compile"`` (``build()``
    ran).  With the disk cache active a built program's ``save(program)``
    payload is stored, and a later process loads it with ``load``; without
    ``save`` / ``load`` the entry stays in process.  Population is
    single-flight per key."""
    key = cache_key(kind, parts)
    source = []

    def make():
        if active() and load is not None:
            prog = _from_disk(key, load)
            if prog is not None:
                source.append("disk")
                return prog
        _count("misses")
        t0 = time.perf_counter()
        prog = build()
        dt = time.perf_counter() - t0
        from . import telemetry

        telemetry.observe("progcache.compile_s", dt)
        if active() and save is not None:
            _store(key, save(prog), label or kind, dt)
        source.append("compile")
        return prog

    prog = _memcache().get(key, make)
    if not source:
        _count("mem_hits")
        return prog, "mem"
    return prog, source[0]


def load_cached(kind: str, parts: dict, load=None):
    """Load-only probe: the program for ``(kind, parts)`` in this process,
    or with ``load`` and the disk cache active, ``load(payload)`` of its
    artifact (its graph captured again); None otherwise.  Never builds a
    program from nothing."""
    key = cache_key(kind, parts)
    mem = _memcache()
    try:
        prog = mem.peek(key)
        _count("mem_hits")
        return prog
    except KeyError:
        pass
    if load is None or not active():
        return None
    path = _artifact_path(key)
    if path is None or not os.path.exists(path):
        return None

    def make():
        prog = _from_disk(key, load)
        if prog is None:
            raise KeyError(key)  # corrupt or foreign: nothing cached
        return prog

    try:
        return mem.get(key, make)
    except KeyError:
        return None
