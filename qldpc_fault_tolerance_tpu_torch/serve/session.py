"""Persistent decode sessions: build and capture once, serve forever.

The port's counterpart of the JAX package's ``serve/session.py``.  A
``DecodeSession`` holds one (H, decoder config) pair's decode programs:

  * construction resolves the decoder's ``(device_static, device_state)``
    pair, from a built decoder or a factory's ``GetDecoderState`` (the
    per-H memo makes a warm H a dict hit);
  * requests pad up to a small ladder of shape BUCKETS; each bucket's
    program is, on the card, one CUDA graph that replays
    ``decoders.bp_decoders.decode_device`` over a static padded ``(bucket,
    m)`` uint8 input buffer (``parallel.shots._capture_graph``, whose
    ``device_cond`` IF nodes carry the OSD tiers), and on the CPU the eager
    call of the same function.  A decode copies its padded chunk into the
    input buffer, replays the graph and reads the corrections, ``converged``
    and the graph's launch counters to the host in ONE read
    (``resilience.guarded_fetch``);
  * the warm path captures nothing: ``compiles`` counts captures (builds on
    the CPU), ``loads`` programs found in the program cache
    (``utils.progcache``): in this process, or with its disk half active
    (``progcache.configure(dir)``) on disk.  There a factory session
    (``decoder_class=``) stores its decoder state tensors under its recipe
    (a digest of the class's configuration and the params) and each
    bucket's layout picks; a fresh process loads the state instead of
    rebuilding it (``state_source == "disk"``) and captures each bucket's
    graph again, counted in ``progcache``'s ``recaptures``.

The contract: a served round equals the offline ``decode_device`` of
the same rows padded into the same bucket, bit for bit, on each device,
and a permutation of those rows permutes the answers.  It does not
promise that a shot's answer is independent of the other rows of its
round.  On the card the bucket matters: BP's bf16 head engages only at
batches that are multiples of ``ops.bp.HEAD_BLOCK`` (256), so buckets
32-128 decode in float32 kernel 1 and buckets 256 and up in the bf16
head, and one shot's correction may differ between two buckets.  Within
a bucket the straggler and BP-failure counts of the whole round pick the
tiers of two-phase BP and of OSD (``decode_device``), and on the card a
tier can change a shot's numerics, so its neighbours can change a
BP-failed shot's answer.  ``kernel_variant(static, state, bucket)`` is
recorded for each bucket (``bucket_variants``).

Threads and captures.  ``torch.cuda.graph`` captures in its "global" error
mode, in which a CUDA call on any other thread during the capture fails.
The serve stack has several threads (dispatcher, health probe, ops
sidecar, asyncio loop), so every capture, every replay with its read, and
every state resolution (which uploads tensors) holds ``DEVICE_LOCK``, one
process-wide lock; warming every bucket before serving keeps captures off
the served path, and a later capture (a miss, a heal, the recapture rung)
waits for the replay in flight and holds the next one back until it
ends.  Code outside the serve stack that drives the card from another
thread of the same process must take the lock too.

``SessionCache`` bounds the live-session set (LRU).  ``FusedDecodeGroup``
decodes one round of several sessions of one bucket family in one graph.
``StreamSession`` keeps a syndrome stream's overlap-commit ledger.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..decoders.bp_decoders import (decode_device, device_syndrome_width,
                                     kernel_variant)
from ..ops import _kernels
from ..parallel.shots import _capture_graph
from ..utils import progcache, resilience, telemetry
from ..utils.device import canonical

__all__ = ["DEFAULT_BUCKETS", "DEVICE_LOCK", "DecodeOutput", "DecodeSession",
           "FusedDecodeGroup", "SessionCache", "StreamProfile",
           "StreamProtocolError", "StreamSession", "bucket_family",
           "device_syndrome_width", "family_digest"]

# request batches pad up to the smallest bucket that fits; the ladder is
# geometric so padding waste is bounded at ~2x worst case and the program
# set per session stays small
DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

# batch-occupancy histogram edges (fraction of the padded bucket that was
# real request shots)
OCCUPANCY_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

# every serve capture, replay-and-read and state resolution holds this
# (module docstring)
DEVICE_LOCK = threading.RLock()


def _state_device(state) -> torch.device:
    for leaf in pytree.tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("decoder state holds no tensor")


def _leaf_shapes(state) -> tuple:
    leaves, spec = pytree.tree_flatten(state)
    shapes = tuple(
        (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor)
        else (None, type(x).__name__) for x in leaves)
    return str(spec), shapes


def _state_digest(state) -> str:
    """Content digest of a state's leaves (tensor bytes, scalars' reprs):
    two states with one digest give one program the same values."""
    h = hashlib.sha1()
    for leaf in pytree.tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            h.update(repr((tuple(leaf.shape), str(leaf.dtype),
                           str(leaf.device))).encode())
            flat = leaf.detach().reshape(-1).contiguous()
            h.update(flat.view(torch.uint8).cpu().numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def _digest_value(h, v) -> None:
    """Fold ``v`` (arrays by their bytes, containers by their items, the
    rest by repr) into the hash ``h``."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        h.update(repr((v.shape, str(v.dtype))).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    elif isinstance(v, dict):
        for k in sorted(v, key=str):
            h.update(repr(k).encode())
            _digest_value(h, v[k])
    elif isinstance(v, (list, tuple)):
        h.update(f"{type(v).__name__}{len(v)}".encode())
        for x in v:
            _digest_value(h, x)
    else:
        h.update(repr(v).encode())


def _recipe_digest(decoder_class, params) -> str:
    """Digest of what a factory session's state is built from: the decoder
    class, its configuration and the params (matrices by their bytes).
    ``GetDecoderState`` is deterministic, so equal recipes build equal
    states."""
    h = hashlib.sha1()
    _digest_value(h, (type(decoder_class).__module__,
                      type(decoder_class).__qualname__,
                      {k: v for k, v in vars(decoder_class).items()
                       if not k.startswith("_")}, dict(params)))
    return h.hexdigest()


def _decode_fn(static, state):
    def fn(syndromes):
        cor, aux = decode_device(static, state, syndromes)
        conv = aux.get("converged") if isinstance(aux, dict) else None
        return cor, conv
    return fn


class _Program:
    """One shape's decode program (module docstring).

    ``fn(*buffers) -> (corrections, converged or None)`` over input
    buffers of ``in_specs`` (shape, dtype) on ``device``.  On the card it
    is captured once into a CUDA graph whose output is one flat uint8
    buffer: the corrections, ``converged`` and the launch counters
    (``ops._kernels.launch_counts``), read to pinned host memory in one
    copy.  ``keep`` is what the graph reads (its decoder state), held
    alive with it."""

    def __init__(self, fn, in_specs, device, keep=None):
        self.device = canonical(device)
        self.fn = fn
        self.keep = keep
        self.in_specs = [(tuple(s), d) for s, d in in_specs]
        self.replays = 0
        self.host_reads = 0
        self.nodes = None
        self.capture_s = 0.0
        self.graph = None
        if self.device.type == "cuda":
            with DEVICE_LOCK:
                self._capture()

    def _capture(self) -> None:
        dev = self.device
        self.bufs = [torch.zeros(s, dtype=d, device=dev)
                     for s, d in self.in_specs]
        self.stage = [torch.zeros(s, dtype=d, pin_memory=True)
                      for s, d in self.in_specs]
        layout = {}

        def body():
            cor, conv = self.fn(*self.bufs)
            layout["cor"] = tuple(cor.shape)
            layout["conv"] = None if conv is None else tuple(conv.shape)
            parts = [cor.reshape(-1)]
            if conv is not None:
                parts.append(conv.reshape(-1).to(torch.uint8))
            parts.append(_kernels.launch_counts(dev).view(torch.uint8))
            return torch.cat(parts)

        t0 = time.perf_counter()
        graph, out, self.pool, stats = _capture_graph(
            dev, lambda: self.fn(*self.bufs), body,
            label="serve." + "x".join(str(d) for d in self.in_specs[0][0]))
        self.capture_s = time.perf_counter() - t0
        self.graph, self.out = graph, out
        self.nodes = stats["nodes"]
        self.layout = layout
        self.out_host = torch.empty(out.shape, dtype=torch.uint8,
                                    pin_memory=True)
        self.done = torch.cuda.Event()

    def _read(self):
        self.done.synchronize()
        return self.out_host.numpy().copy()

    def run(self, *arrays, label: str = "serve_fetch"):
        """Decode host ``arrays`` (one per input buffer); returns host
        ``(corrections, converged or None)``."""
        if self.graph is None:
            with DEVICE_LOCK:
                cor, conv = self.fn(*[torch.from_numpy(np.ascontiguousarray(a))
                                      for a in arrays])
                self.replays += 1
                self.host_reads += 1
                return (cor.numpy().copy(),
                        None if conv is None else conv.numpy().copy())
        with DEVICE_LOCK:
            for stage, buf, a in zip(self.stage, self.bufs, arrays):
                np.copyto(stage.numpy(), a)
                buf.copy_(stage, non_blocking=True)
            self.graph.replay()
            self.out_host.copy_(self.out, non_blocking=True)
            self.done.record()
            flat = resilience.guarded_fetch(self._read, label=label)
            self.replays += 1
            self.host_reads += 1
            n_cor = int(np.prod(self.layout["cor"]))
            cor = flat[:n_cor].reshape(self.layout["cor"])
            conv = None
            if self.layout["conv"] is not None:
                n_conv = int(np.prod(self.layout["conv"]))
                conv = flat[n_cor:n_cor + n_conv].reshape(
                    self.layout["conv"]).astype(bool)
                n_cor += n_conv
            _kernels.fold_launch_counts(self.device,
                                        flat[n_cor:].view(np.int64))
        return cor, conv


class _ShardedProgram:
    """A bucket split over a shot mesh's entries: each entry replays its
    own program over its slice, on its replica of the state."""

    def __init__(self, progs):
        self.progs = list(progs)
        self.nodes = sum(p.nodes or 0 for p in self.progs)
        self.capture_s = sum(p.capture_s for p in self.progs)

    @property
    def host_reads(self) -> int:
        return sum(p.host_reads for p in self.progs)

    def run(self, pad, label: str = "serve_fetch"):
        outs = [p.run(part, label=label)
                for p, part in zip(self.progs,
                                   np.split(pad, len(self.progs)))]
        cor = np.concatenate([c for c, _ in outs])
        conv = (None if outs[0][1] is None
                else np.concatenate([v for _, v in outs]))
        return cor, conv


@dataclasses.dataclass
class DecodeOutput:
    """One served decode: host corrections + per-shot convergence flags
    (None for decoders without BP aux) + padding accounting."""

    corrections: np.ndarray          # (B, n) uint8
    converged: np.ndarray | None     # (B,) bool, when the decoder reports it
    shots: int                       # real request shots decoded
    padded_shots: int                # total padded shots dispatched
    buckets: tuple                   # bucket sizes the decode ran as
    # per-stage wall clock summed over chunks (pad / device_decode /
    # slice), consumed by the scheduler's trace spans
    timings: dict | None = None


class DecodeSession:
    """One (H, decoder-config) pair's persistent decode programs.

    ``decoder``: a built decoder (``device_static`` / ``device_state``).
    ``decoder_class`` + ``params``: the factory path —
    ``GetDecoderState(params)`` resolves the pair without building a
    decoder.  ``mesh``: a ``parallel.shots.ShotMesh``; ``shard()`` then
    splits each divisible bucket over the mesh's entries.

    ``decode(syndromes)`` pads the batch to a shape bucket and replays the
    bucket's program; batches beyond the largest bucket are chunked.
    State is swapped only under the session lock (``invalidate`` /
    ``heal``), together with the program map.

    Heals capture anew rather than copying new state into the old graphs'
    buffers: a graph bakes in the address of every tensor it reads, the
    decoder state's and those its kernels' wrappers keep, so only a fresh
    capture is sure to read the rebuilt state.  The new programs are
    captured on the calling thread (the health probe's) while the old ones
    keep serving, and swap in atomically with the state."""

    def __init__(self, name: str, *, decoder=None, decoder_class=None,
                 params=None, buckets=DEFAULT_BUCKETS, mesh=None):
        if (decoder is None) == (decoder_class is None):
            raise ValueError(
                "pass exactly one of decoder= or (decoder_class=, params=)")
        self.name = str(name)
        from ..parallel.shots import check_mesh

        self._recipe = None       # a factory session's state recipe
        self._factory = decoder_class
        # where the state came from: "build" or, from the program cache's
        # disk half, "disk"
        self.state_source = "build"

        self._mesh = check_mesh(mesh)
        self._mesh_devices = 0 if mesh is None else int(mesh.size)
        self._sharded = False
        if decoder is not None:
            # a CPU clone of the state, uploaded again on each rebuild: a
            # reset_device_state stands for a restart, after which the
            # decoder's own tensors are not to be served again
            static0 = decoder.device_static
            dev = _state_device(decoder.device_state)
            host_state = pytree.tree_map(
                lambda x: (x.detach().cpu().clone()
                           if isinstance(x, torch.Tensor) else x),
                decoder.device_state)
            self._rebuild = lambda: (static0, pytree.tree_map(
                lambda x: (x.to(dev, copy=True) if isinstance(x, torch.Tensor)
                           else x),
                host_state))
        else:
            if params is None:
                raise ValueError("decoder_class= requires params=")
            self._rebuild = lambda: decoder_class.GetDecoderState(
                dict(params))
            self._recipe = _recipe_digest(decoder_class, params)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid bucket ladder {buckets!r}")
        self._lock = threading.RLock()
        self._programs: dict = {}
        self._family = None  # (generation, bucket_family) lazy cache
        self.compiles = 0
        self.loads = 0
        # bumped by every state swap (invalidate / heal)
        self.generation = 0
        self.heals = 0
        # bucket -> kernel_variant(static, state, bucket) of its program
        self.bucket_variants: dict = {}
        self._resolve_state()

    def _state_parts(self) -> dict:
        """The key of a factory session's state artifact."""
        return {"recipe": self._recipe}

    def _resolve_pair(self):
        """``(static, state, digest)``: loaded from the program cache's
        disk half where a factory session stored it (its digest checked),
        else built (and stored there when the disk half is active)."""
        if self._recipe is not None and progcache.active():
            payload = progcache.load_artifact("serve.state",
                                              self._state_parts())
            if payload is not None:
                dev = self._state_home()
                with DEVICE_LOCK:
                    state = pytree.tree_map(
                        lambda x: (x.to(dev) if isinstance(x, torch.Tensor)
                                   else x), payload["state"])
                    digest = _state_digest(state)
                if digest == payload["digest"]:
                    self.state_source = "disk"
                    telemetry.count("serve.session.state_loads")
                    return payload["static"], state, digest
        t0 = time.perf_counter()
        with DEVICE_LOCK:
            static, state = self._rebuild()
            digest = _state_digest(state)
        telemetry.count("serve.session.builds")
        self.state_source = "build"
        if self._recipe is not None and progcache.active():
            progcache.store_artifact(
                "serve.state", self._state_parts(),
                {"static": static, "digest": digest,
                 "state": pytree.tree_map(
                     lambda x: (x.detach().cpu() if isinstance(x, torch.Tensor)
                                else x), state)},
                label=f"serve.state.{self.name}",
                build_s=time.perf_counter() - t0)
        return static, state, digest

    def _state_home(self) -> torch.device:
        """The device a factory's states live on (its ``device``)."""
        return canonical(getattr(self._factory, "device", "cuda"))

    def _resolved(self):
        """One fresh ``(static, state, syndrome_width, kernel_variant,
        osd_backend, digest)`` resolution, built without assigning so
        ``heal()`` can build replacement state while the current pair
        keeps serving."""
        static, state, digest = self._resolve_pair()
        width = device_syndrome_width(static, state)
        if static[0] != "bposd_dev":
            backend = "none"
        elif len(static) > 6 and static[6] == "osd_cs":
            backend = "device_cs"
        else:
            backend = "device"
        return (static, state, width, kernel_variant(static, state),
                backend, digest)

    def _resolve_state(self) -> None:
        (self.static, self.state, self.syndrome_width,
         self.kernel_variant, self.osd_backend,
         self._digest) = self._resolved()

    @property
    def device(self) -> torch.device:
        return _state_device(self.state)

    # ------------------------------------------------------------------
    # program cache
    # ------------------------------------------------------------------
    def bucket_for(self, n_shots: int) -> int:
        """Smallest bucket holding ``n_shots`` (callers chunk beyond the
        largest)."""
        for b in self.buckets:
            if n_shots <= b:
                return b
        return self.buckets[-1]

    def _prog_parts(self, static, state, width, bucket: int, sharded: bool,
                    digest: str) -> dict:
        """The key of this program in the in-process cache: the static
        decoder tuple, the bucket, the state's structure and leaf shapes,
        and its content digest (a graph reads its state's values, so
        programs are shared only between equal states)."""
        spec, shapes = _leaf_shapes(state)
        parts = {"static": static, "width": int(width),
                 "bucket": int(bucket), "state_tree": spec,
                 "state_shapes": shapes, "state_digest": digest,
                 "device": str(_state_device(state)),
                 "sharded": bool(sharded)}
        if sharded and self._mesh is not None:
            parts["mesh"] = tuple(str(d) for d in self._mesh.devices)
        return parts

    def _program_entry(self, static, state, width, bucket: int,
                       sharded: bool, digest: str):
        """What the program cache needs of one program: ``(parts, build,
        picks, load)``, its key's parts, the build function (the plain
        per-bucket program, or its mesh-sharded twin: the bucket split over
        the mesh's entries, the state replicated to each), the bucket and
        layout picks its artifact holds, and the loader of that artifact
        (it captures the graph again; picks that moved refuse it, and the
        program is rebuilt)."""
        parts = self._prog_parts(static, state, width, bucket, sharded,
                                 digest)

        def build():
            if not sharded:
                return _Program(_decode_fn(static, state),
                                [((int(bucket), width), torch.uint8)],
                                _state_device(state), keep=state)
            from ..sim.common import replicate

            per = int(bucket) // self._mesh_devices
            progs = []
            for dev in self._mesh.devices:
                with DEVICE_LOCK:
                    rep = replicate(state, dev)
                progs.append(_Program(_decode_fn(static, rep),
                                      [((per, width), torch.uint8)], dev,
                                      keep=rep))
            return _ShardedProgram(progs)

        picks = {"bucket": int(bucket), "width": int(width),
                 "sharded": bool(sharded),
                 "kernel_variant": kernel_variant(static, state, int(bucket)),
                 "digest": digest}

        def load(payload):
            if payload != picks:
                raise ValueError(f"stale program artifact {payload}")
            return build()

        return parts, build, picks, load

    def _compile_program(self, static, state, width, bucket: int,
                         sharded: bool, digest: str):
        """One program (``_program_entry``) from the program cache.
        Returns ``(program, source)`` with source ``"mem"`` (found in this
        process), ``"disk"`` (its artifact loaded, the graph captured
        again) or ``"compile"``."""
        parts, build, picks, load = self._program_entry(
            static, state, width, bucket, sharded, digest)
        return progcache.compile_cached(
            build, kind="serve.session", parts=parts,
            save=lambda prog: picks, load=load,
            label=f"serve.session.{self.name}.{int(bucket)}")

    def _route_sharded(self, bucket: int) -> bool:
        """Whether this bucket's decode runs the mesh-sharded program
        right now.  A bucket the mesh size doesn't divide keeps the plain
        program (counted — sharding must degrade loudly, not wrongly)."""
        if not self._sharded or self._mesh is None:
            return False
        if int(bucket) % self._mesh_devices:
            telemetry.count("serve.session.mesh_misfit")
            return False
        return True

    def program(self, bucket: int, sharded: bool | None = None):
        """The program for one bucket (capturing on a miss).
        ``sharded=None`` routes through the session's current sharding
        state (``shard()`` / ``unshard()``)."""
        if sharded is None:
            sharded = self._route_sharded(bucket)
        key = (int(bucket), bool(sharded))
        prog = self._programs.get(key)
        if prog is not None:
            telemetry.count("serve.session.hits")
            return prog
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                return prog
            t0 = time.perf_counter()
            prog, source = self._compile_program(
                self.static, self.state, self.syndrome_width, bucket,
                sharded, self._digest)
            dt = time.perf_counter() - t0
            self._programs[key] = prog
            variant = kernel_variant(self.static, self.state, int(bucket))
            self.bucket_variants[int(bucket)] = variant
            if source == "compile":
                self.compiles += 1
                telemetry.count("serve.session.compiles")
                telemetry.observe("serve.session.compile_s", dt)
                telemetry.event("serve_session", session=self.name,
                                event="compile", bucket=int(bucket),
                                compile_s=round(dt, 4),
                                syndrome_width=self.syndrome_width,
                                sharded=bool(sharded),
                                # per BUCKET: the head engages only at
                                # multiples of 256 shots
                                kernel_variant=variant,
                                osd_backend=self.osd_backend)
            else:
                self.loads += 1
                telemetry.count("serve.session.loads")
                telemetry.observe("serve.session.load_s", dt)
            return prog

    def warm(self, max_shots: int | None = None) -> list[int]:
        """Capture every bucket up to ``bucket_for(max_shots)`` (all
        buckets when None), so the served path never captures."""
        top = (self.buckets[-1] if max_shots is None
               else self.bucket_for(int(max_shots)))
        done = []
        for b in self.buckets:
            if b > top:
                break
            self.program(b)
            done.append(b)
        return done

    def invalidate(self, stale_artifact: bool = False) -> None:
        """Drop the programs and re-resolve the decoder state — the
        recapture rung a serving dispatch steps after repeated transient
        faults (after ``reset_device_state`` the re-resolve rebuilds the
        state, and the next ``program()`` captures against it).
        ``stale_artifact=True`` also evicts the warm keys from the program
        cache (memory and disk) and the session's state artifact, so a
        re-resolve to equal state builds and captures anew."""
        with self._lock:
            if stale_artifact:
                for (bucket, sharded) in list(self._programs):
                    parts = self._prog_parts(self.static, self.state,
                                             self.syndrome_width, bucket,
                                             sharded, self._digest)
                    progcache.evict(
                        progcache.cache_key("serve.session", parts))
                if self._recipe is not None:
                    progcache.evict(progcache.cache_key(
                        "serve.state", self._state_parts()))
                telemetry.count("serve.session.artifact_evictions",
                                len(self._programs))
            self._programs.clear()
            self._resolve_state()
            self.generation += 1
            telemetry.count("serve.session.invalidations")
            telemetry.event("serve_session", session=self.name,
                            event="invalidate",
                            syndrome_width=self.syndrome_width,
                            kernel_variant=self.kernel_variant,
                            osd_backend=self.osd_backend)

    def warm_keys(self) -> list:
        """The currently-warm program keys as ``[bucket, sharded]``
        pairs."""
        with self._lock:
            return sorted([int(b), bool(s)] for (b, s) in self._programs)

    def adopt_program(self, bucket: int, sharded: bool = False) -> bool:
        """Take one program from the program cache: in this process, or
        with its disk half active from its artifact (the graph captured
        again); never builds a program that has no artifact — a miss is a
        no-op (False)."""
        if sharded is None:
            sharded = self._route_sharded(bucket)
        key = (int(bucket), bool(sharded))
        with self._lock:
            if key in self._programs:
                telemetry.count("serve.session.warm_already")
                return True
            t0 = time.perf_counter()
            parts, _build, _picks, load = self._program_entry(
                self.static, self.state, self.syndrome_width, key[0],
                key[1], self._digest)
            prog = progcache.load_cached("serve.session", parts, load=load)
            if prog is None:
                telemetry.count("serve.session.warm_load_misses")
                return False
            self._programs[key] = prog
            self.loads += 1
            telemetry.count("serve.session.warm_loads")
            telemetry.observe("serve.session.load_s",
                              time.perf_counter() - t0)
            return True

    def heal(self, reason: str = "probe") -> int:
        """Self-healing: rebuild the decoder state and build every
        currently-warm bucket's program anew (captured, or found in the
        in-process cache when the rebuilt state equals one it holds) on
        the CALLING thread while the old programs keep serving, then swap
        state and programs atomically.  Returns the number of programs.
        A bucket built concurrently between the warm-set snapshot and the
        swap is dropped by the swap and builds on its next request."""
        t0 = time.perf_counter()
        with self._lock:
            warm = sorted(self._programs)
        static, state, width, kvariant, osd, digest = self._resolved()
        built = {
            key: self._compile_program(static, state, width, key[0], key[1],
                                       digest)
            for key in warm}
        programs = {key: prog for key, (prog, _src) in built.items()}
        compiled = sum(1 for _p, src in built.values() if src == "compile")
        loaded = len(built) - compiled
        dt = time.perf_counter() - t0
        with self._lock:
            self.static, self.state = static, state
            self.syndrome_width, self._digest = width, digest
            self.kernel_variant, self.osd_backend = kvariant, osd
            self._programs = programs
            self.compiles += compiled
            self.loads += loaded
            self.generation += 1
            self.heals += 1
        telemetry.count("serve.session.heals")
        telemetry.count("serve.session.compiles", compiled)
        telemetry.count("serve.session.loads", loaded)
        telemetry.observe("serve.session.heal_s", dt)
        telemetry.event("serve_session", session=self.name, event="heal",
                        reason=str(reason), programs=len(programs),
                        compile_s=round(dt, 4),
                        syndrome_width=width, kernel_variant=kvariant,
                        osd_backend=osd)
        return len(programs)

    @property
    def family(self) -> tuple:
        """This session's ``bucket_family`` (cached per generation)."""
        fam = self._family
        if fam is None or fam[0] != self.generation:
            self._family = fam = (self.generation, bucket_family(self))
        return fam[1]

    def programs(self) -> dict:
        """The warm programs by ``(bucket, sharded)`` (a copy)."""
        with self._lock:
            return dict(self._programs)

    def release(self) -> int:
        """Drop this session's programs (its captured graphs and the
        static buffers they read), as a dead host's sessions are; the
        in-process cache keeps what another session of equal state still
        shares.  Returns how many were dropped."""
        with self._lock:
            n = len(self._programs)
            self._programs.clear()
            return n

    @property
    def host_reads(self) -> int:
        """Host reads of this session's current programs."""
        return sum(p.host_reads for p in self.programs().values())

    # ------------------------------------------------------------------
    # hot-session mesh sharding
    # ------------------------------------------------------------------
    @property
    def sharded(self) -> bool:
        return self._sharded

    def shard(self, reason: str = "autoscale") -> bool:
        """Start serving this session's decodes split over its mesh.
        Builds sharded twins of every currently-warm divisible bucket on
        the CALLING thread (the autoscaler's) BEFORE flipping the route.
        No-op (False) without a mesh or when already sharded."""
        if self._mesh is None or self._sharded:
            return False
        t0 = time.perf_counter()
        with self._lock:
            warm = sorted({b for (b, _s) in self._programs})
        built = {
            (b, True): self._compile_program(
                self.static, self.state, self.syndrome_width, b, True,
                self._digest)
            for b in warm
            if b % self._mesh_devices == 0 and
            (b, True) not in self._programs}
        compiled = sum(1 for _p, src in built.values() if src == "compile")
        with self._lock:
            self._programs.update(
                {key: prog for key, (prog, _src) in built.items()})
            self.compiles += compiled
            self.loads += len(built) - compiled
            self._sharded = True
        telemetry.count("serve.session.shards")
        telemetry.count("serve.session.compiles", compiled)
        telemetry.count("serve.session.loads", len(built) - compiled)
        telemetry.event("serve_session", session=self.name, event="shard",
                        reason=str(reason), programs=len(built),
                        compile_s=round(time.perf_counter() - t0, 4),
                        sharded=True, syndrome_width=self.syndrome_width)
        return True

    def unshard(self, reason: str = "autoscale") -> bool:
        """Route decodes back to the single-device programs (they stayed
        warm).  Both the autoscaler's retire path and the degrade rung a
        mesh-lost dispatch steps: the plain program decodes the same
        rows bit for bit."""
        if not self._sharded:
            return False
        with self._lock:
            self._sharded = False
        telemetry.count("serve.session.unshards")
        telemetry.event("serve_session", session=self.name,
                        event="unshard", reason=str(reason), sharded=False,
                        syndrome_width=self.syndrome_width)
        return True

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def decode(self, syndromes) -> DecodeOutput:
        """Decode a (B, m) uint8 syndrome batch on the warm programs: pad
        to the shape bucket (chunking past the largest), replay, read the
        padded planes in one host read and slice the pad off on the host.
        The rows equal the offline ``decode_device`` of the same rows
        padded into the same buckets (the module's contract)."""
        arr = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        if arr.ndim != 2 or arr.shape[0] == 0:
            raise ValueError(f"syndromes must be (B, m), got {arr.shape}")
        if arr.shape[1] != self.syndrome_width:
            raise ValueError(
                f"session {self.name!r} decodes syndromes of width "
                f"{self.syndrome_width}, got {arr.shape[1]}")
        top = self.buckets[-1]
        cors, convs, buckets_used, padded = [], [], [], 0
        pad_s = device_s = slice_s = 0.0
        for lo in range(0, arr.shape[0], top):
            chunk = arr[lo:lo + top]
            bucket = self.bucket_for(chunk.shape[0])
            # the program is taken under the session lock: a concurrent
            # heal() swaps state and programs together
            with self._lock:
                prog = self.program(bucket)
            t0 = time.perf_counter()
            pad = np.zeros((bucket, self.syndrome_width), np.uint8)
            pad[:chunk.shape[0]] = chunk
            t1 = time.perf_counter()
            pad_s += t1 - t0
            with telemetry.span("serve.decode"):
                cor, conv = prog.run(pad, label="serve_fetch")
            t2 = time.perf_counter()
            device_s += t2 - t1
            cors.append(cor[:chunk.shape[0]])
            convs.append(None if conv is None else conv[:chunk.shape[0]])
            slice_s += time.perf_counter() - t2
            buckets_used.append(bucket)
            padded += bucket
        return DecodeOutput(
            corrections=np.concatenate(cors) if len(cors) > 1 else cors[0],
            converged=(None if convs[0] is None
                       else (np.concatenate(convs) if len(convs) > 1
                             else convs[0])),
            shots=int(arr.shape[0]), padded_shots=int(padded),
            buckets=tuple(buckets_used),
            timings={"pad": pad_s, "device_decode": device_s,
                     "slice": slice_s})


def family_digest(family: tuple) -> str:
    """6-hex content digest of a family tuple — restart- and
    process-stable (builtin ``hash`` is salted per process)."""
    return hashlib.sha1(repr(family).encode("utf-8")).hexdigest()[:6]


def bucket_family(session: "DecodeSession") -> tuple:
    """The hashable SHAPE identity of a session's decode program: static
    config, syndrome width, bucket ladder, and the state's structure
    (the state dict's keys in a fixed order) and leaf shapes and dtypes.
    Sessions with equal families can ride ONE fused program (session =
    lane); their values differ (another code of equal shape, another p's
    priors)."""
    spec, shapes = _leaf_shapes(session.state)
    return (session.static, int(session.syndrome_width),
            tuple(session.buckets), spec, shapes,
            str(_state_device(session.state)))


class FusedDecodeGroup:
    """Cross-session fused dispatch: one program decodes a whole bucket
    family's round — session is the lane axis.

    Built over the sessions of one ``bucket_family``; their states stack
    along a leading lane axis as a fused sweep bucket's cells do
    (``sim.common.stack_cell_states``: leaves equal across sessions stay
    shared, per-session leaves gain the axis).  One program per
    ``(n_lanes, bucket)``: on the card one CUDA graph whose lanes run in
    turn, each gathering its member's state by the ``lane_cell`` index
    held in a device input buffer (``sim.common.gather_lane_states``), so
    one graph serves every member subset of that size.

    A member heal restacks by copying the new per-lane values into the
    stacked buffers the graphs read (under ``DEVICE_LOCK``), so the graphs
    stay valid; a shared leaf that changed (a rebuilt Tanner graph after
    ``reset_device_state``) drops the programs, which capture again.

    Bit-exactness: each lane runs ``decode_device`` on its member's state
    and rows, what the member's own program runs at that bucket."""

    def __init__(self, sessions, name: str | None = None):
        sessions = list(sessions)
        if len(sessions) < 2:
            raise ValueError("a fused group needs >= 2 member sessions")
        families = {bucket_family(s) for s in sessions}
        if len(families) != 1:
            raise ValueError(
                "fused-group members must share one bucket family "
                f"(got {len(families)} distinct shapes)")
        self.family = families.pop()
        self.sessions = sessions
        self.names = tuple(s.name for s in sessions)
        self.name = name or "fused:" + "+".join(self.names)
        rep = sessions[0]
        self.static = rep.static
        self.syndrome_width = rep.syndrome_width
        self.buckets = rep.buckets
        self.kernel_variant = rep.kernel_variant
        self.osd_backend = rep.osd_backend
        self.device = rep.device
        self._lock = threading.RLock()
        self._programs: dict = {}
        self.compiles = 0
        self.loads = 0
        self.restacks = 0
        self.generation = 0
        self._axes = None
        self._gens = None
        self._stacked = None
        self._restack_locked()

    # -- state stacking ------------------------------------------------
    def _restack_locked(self) -> None:
        """(Re)stack the member states.  Where the programs' stacked
        buffers can take the new values (same per-lane leaves, the same
        shared leaves), the values are copied into them; otherwise the
        group restacks and drops its programs."""
        with DEVICE_LOCK:
            self._restack_device()

    def _restack_device(self) -> None:
        from ..sim.common import _leaf_equal, stack_cell_states

        states = [s.state for s in self.sessions]
        if self._stacked is not None:
            old = pytree.tree_leaves(self._stacked)
            flats = [pytree.tree_flatten(st) for st in states]
            fits = all(sp == self._spec for _l, sp in flats)
            if fits:
                groups = list(zip(*(leaves for leaves, _sp in flats)))
                for x, axis, group in zip(old, self._axes, groups):
                    if axis is None:
                        fits = all(_leaf_equal(x, g) for g in group)
                    else:
                        fits = all(isinstance(g, torch.Tensor)
                                   and g.shape == x.shape[1:]
                                   and g.dtype == x.dtype
                                   and g.device == x.device for g in group)
                    if not fits:
                        break
            if fits:
                for x, axis, group in zip(old, self._axes, groups):
                    if axis == 0:
                        x.copy_(torch.stack(list(group)))
                self._gens = tuple(s.generation for s in self.sessions)
                self.restacks += 1
                return
            if self._programs:
                telemetry.count("serve.fused.reprograms")
            self._programs.clear()
        stacked, spec, axes = stack_cell_states(states)
        self._stacked, self._spec, self._axes = stacked, spec, axes
        self._gens = tuple(s.generation for s in self.sessions)
        self.restacks += 1

    def ensure_fresh(self) -> bool:
        """Cheap pre-dispatch check: restack when any member's generation
        moved (heal / invalidate swapped its state).  Returns True when a
        restack happened."""
        gens = tuple(s.generation for s in self.sessions)
        if gens == self._gens:
            return False
        with self._lock:
            if tuple(s.generation for s in self.sessions) == self._gens:
                return False
            self._restack_locked()
            self.generation += 1
        telemetry.count("serve.fused.restacks")
        return True

    def invalidate(self) -> None:
        """The fused recapture rung: drop the group's programs, invalidate
        every member and restack; the next attempt captures against the
        rebuilt state."""
        with self._lock:
            self._programs.clear()
            for s in self.sessions:
                s.invalidate()
            self._stacked = None
            self._restack_locked()
            self.generation += 1
        telemetry.count("serve.fused.invalidations")

    # -- programs ------------------------------------------------------
    def bucket_for(self, n_shots: int) -> int:
        for b in self.buckets:
            if n_shots <= b:
                return b
        return self.buckets[-1]

    def _fused_fn(self, n_lanes: int):
        from ..sim.common import gather_lane_states

        static, spec, axes = self.static, self._spec, self._axes
        stacked = self._stacked

        def run(syndromes, lane_cell):
            cors, convs = [], []
            for lane in range(n_lanes):
                state = gather_lane_states(stacked, spec, axes,
                                           lane_cell[lane:lane + 1])
                cor, conv = _decode_fn(static, state)(syndromes[lane])
                cors.append(cor)
                convs.append(conv)
            conv = None if convs[0] is None else torch.stack(convs)
            return torch.stack(cors), conv

        return run

    def program(self, n_lanes: int, bucket: int):
        """The program decoding ``n_lanes`` lanes of one padded ``bucket``
        (capturing on a miss).  ``lane_cell`` is an input, so the same
        program serves every member subset of that size."""
        key = (int(n_lanes), int(bucket))
        prog = self._programs.get(key)
        if prog is not None:
            telemetry.count("serve.fused.hits")
            return prog
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                return prog
            t0 = time.perf_counter()
            prog = _Program(
                self._fused_fn(key[0]),
                [((key[0], key[1], self.syndrome_width), torch.uint8),
                 ((key[0],), torch.int64)],
                self.device, keep=self._stacked)
            dt = time.perf_counter() - t0
            self._programs[key] = prog
            self.compiles += 1
            telemetry.count("serve.fused.compiles")
            telemetry.observe("serve.session.compile_s", dt)
            telemetry.event("serve_session", session=self.name,
                            event="fused_compile", bucket=key[1],
                            lanes=key[0], family=self.family_label(),
                            compile_s=round(dt, 4),
                            syndrome_width=self.syndrome_width,
                            kernel_variant=kernel_variant(
                                self.static, self.sessions[0].state,
                                key[1]),
                            osd_backend=self.osd_backend)
            return prog

    def programs(self) -> dict:
        """The warm programs by ``(n_lanes, bucket)`` (a copy)."""
        with self._lock:
            return dict(self._programs)

    def release(self) -> int:
        """Drop this group's programs (``DecodeSession.release``)."""
        with self._lock:
            n = len(self._programs)
            self._programs.clear()
            return n

    def family_label(self) -> str:
        """Short STABLE label for telemetry/health, built from a content
        digest of the family."""
        return (f"{self.static[0]}.w{self.syndrome_width}."
                f"{family_digest(self.family)}")

    def warm(self, max_shots: int | None = None,
             lanes: "tuple | None" = None) -> int:
        """Capture every (n_lanes, bucket) combination up to
        ``bucket_for(max_shots)`` for ``lanes`` (default: every member
        count 2..N)."""
        top = (self.buckets[-1] if max_shots is None
               else self.bucket_for(int(max_shots)))
        lanes = (tuple(range(2, len(self.sessions) + 1))
                 if lanes is None else tuple(int(x) for x in lanes))
        done = 0
        for n_lanes in lanes:
            for b in self.buckets:
                if b > top:
                    break
                self.program(n_lanes, b)
                done += 1
        return done

    # -- serving -------------------------------------------------------
    def decode(self, parts) -> list:
        """Decode one fused round: ``parts`` is a list of
        ``(member_index, syndromes)`` — at most one per member, each at
        most the top bucket.  Returns one ``DecodeOutput`` per part,
        sliced on the host from the fused planes; all parts share the
        dispatch's stage timings."""
        arrs = [np.atleast_2d(np.asarray(s, np.uint8)) for _i, s in parts]
        cells = [int(i) for i, _s in parts]
        if len(set(cells)) != len(cells):
            raise ValueError("one lane per member session and round")
        top = self.buckets[-1]
        if any(a.shape[0] > top for a in arrs):
            raise ValueError(f"fused parts must fit the top bucket {top}")
        bucket = max(self.bucket_for(a.shape[0]) for a in arrs)
        n_lanes = len(parts)
        with self._lock:
            prog = self.program(n_lanes, bucket)
        t0 = time.perf_counter()
        pad = np.zeros((n_lanes, bucket, self.syndrome_width), np.uint8)
        for lane, a in enumerate(arrs):
            pad[lane, :a.shape[0]] = a
        lane_cell = np.asarray(cells, np.int64)
        t1 = time.perf_counter()
        with telemetry.span("serve.fused_decode"):
            cor, conv = prog.run(pad, lane_cell, label="serve_fused_fetch")
        t2 = time.perf_counter()
        outs = []
        for lane, a in enumerate(arrs):
            b = a.shape[0]
            outs.append(DecodeOutput(
                corrections=cor[lane, :b],
                converged=None if conv is None else conv[lane, :b],
                shots=int(b), padded_shots=int(bucket),
                buckets=(int(bucket),), timings=None))
        slice_s = time.perf_counter() - t2
        timings = {"pad": t1 - t0, "device_decode": t2 - t1,
                   "slice": slice_s}
        for out in outs:
            out.timings = timings
        return outs


class SessionCache:
    """Bounded LRU of live sessions keyed by name.

    ``get_or_create(name, factory)`` returns the cached session or builds
    one; beyond ``max_sessions`` the least-recently-used session is
    evicted (its programs are dropped with it — a re-request rebuilds via
    its factory).  Built on the shared single-flight LRU
    (``ops.bp._LruCache``): concurrent first requests for one name build
    once, and the map lock is never held across ``factory()``."""

    def __init__(self, max_sessions: int = 8):
        from ..ops.bp import _LruCache

        self._cache = _LruCache(maxsize=max(1, int(max_sessions)))
        self._cache.on_evict = self._evicted
        self.max_sessions = self._cache.maxsize

    @staticmethod
    def _evicted(name, old: "DecodeSession") -> None:
        telemetry.count("serve.session.evictions")
        telemetry.event("serve_session", session=name, event="evict",
                        syndrome_width=old.syndrome_width)

    def get(self, name: str) -> DecodeSession:
        try:
            return self._cache.peek(name)
        except KeyError:
            raise KeyError(f"unknown session {name!r}") from None

    def get_or_create(self, name: str, factory) -> DecodeSession:
        sess = self._cache.get(name, factory)
        telemetry.set_gauge("serve.sessions", len(self._cache))
        return sess

    def add(self, session: DecodeSession) -> DecodeSession:
        return self.get_or_create(session.name, lambda: session)

    def names(self) -> list[str]:
        return self._cache.keys()

    def __len__(self) -> int:
        return len(self._cache)

    def __contains__(self, name: str) -> bool:
        return name in self._cache


# ---------------------------------------------------------------------------
# Streaming decode: persistent per-stream overlap-commit state
# ---------------------------------------------------------------------------
class StreamProtocolError(ValueError):
    """A stream protocol violation (gap / stale / busy / shape mismatch).

    The stream itself stays healthy — the server answers a structured
    error for the offending chunk and keeps serving; ``code`` names the
    violation so clients can branch without parsing messages."""

    def __init__(self, message: str, code: str):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class StreamProfile:
    """Server-side recipe for opening streams: the ``DecodeSession`` that
    decodes one window, plus the optional commit matrices.

    ``space_cor`` (n_faults, m): folds a window's fault corrections into
    the next window's first detector slice — the circuit engine's
    ``h1_space_cor`` overlap-commit carry.  ``log_mat`` (n_faults, k):
    folds corrections into the running logical frame (``L1``).  Both None
    selects frame mode (the phenom engine's carry): the stream accumulates
    the XOR of committed data corrections as a Pauli frame and chunks pass
    to the decoder unadjusted."""

    session: str
    space_cor: np.ndarray | None = None
    log_mat: np.ndarray | None = None
    cycles_per_window: int | None = None


class StreamSession:
    """One live syndrome stream's overlap-commit ledger over a
    ``DecodeSession``.

    The expensive machinery is all reused: the window decode runs through
    the wrapped session's bucket programs (no capture on the warm path,
    heal/shard intact) and — on the server — through the ``ContinuousBatcher`` with
    ``idem="stream:<id>:<seq>"``, so co-family stream steps fuse into the
    same dispatch as batch traffic and the decode is exactly-once under
    chaos.  What is new is the per-stream state: a commit watermark, the
    boundary carry, and the last committed response, all updated
    atomically under one lock so a kill mid-window loses only in-flight
    work, never a commit.

    Chunk protocol (enforced here, transport-agnostic):

      * ``seq`` starts at 1 and increments by one per window;
      * ``seq == committed``: replay — the cached response is returned
        without re-decoding or re-folding (the no-double-commit half);
      * ``seq <= committed`` otherwise: structured ``stale`` error;
      * ``seq > committed + 1``: structured ``gap`` error (the no-lost-
        commit half: the client must resend the missing window);
      * a chunk for a seq already being decoded: structured ``busy`` error
        (resubmit races resolve by retrying after the in-flight attempt
        lands or dies).
    """

    def __init__(self, stream_id: str, session: DecodeSession, *,
                 lanes: int, space_cor=None, log_mat=None,
                 cycles_per_window: int | None = None,
                 tenant: str = "default"):
        self.stream_id = str(stream_id)
        self.session = session
        self.lanes = int(lanes)
        if self.lanes < 1:
            raise ValueError(f"need lanes >= 1, got {lanes}")
        self.width = int(session.syndrome_width)
        self.tenant = str(tenant)
        self._space_cor = (None if space_cor is None
                           else np.ascontiguousarray(space_cor, np.uint8))
        self._log_mat = (None if log_mat is None
                         else np.ascontiguousarray(log_mat, np.uint8))
        if cycles_per_window is None:
            static = getattr(session, "static", None)
            cycles_per_window = (int(static[1])
                                 if static and static[0] == "st_syndrome"
                                 else 1)
        self.cycles_per_window = int(cycles_per_window)
        self._lock = threading.Lock()
        self.committed = 0
        self.closed = False
        self._inflight: int | None = None
        self._last_response: dict | None = None
        # boundary carries: circuit mode folds corrections forward through
        # the matrices; frame mode accumulates the correction XOR
        self._carry_space = (None if self._space_cor is None else
                             np.zeros((self.lanes, self._space_cor.shape[1]),
                                      np.uint8))
        self._carry_log = (None if self._log_mat is None else
                           np.zeros((self.lanes, self._log_mat.shape[1]),
                                    np.uint8))
        self._frame: np.ndarray | None = None

    @property
    def committed_cycles(self) -> int:
        return self.committed * self.cycles_per_window

    def snapshot(self) -> dict:
        """The resume handshake: where may the client continue?"""
        with self._lock:
            return {"stream": self.stream_id,
                    "committed": self.committed,
                    "committed_cycles": self.committed_cycles,
                    "lanes": self.lanes, "width": self.width,
                    "closed": self.closed}

    def prepare(self, seq, chunk):
        """Validate + stage chunk ``seq``.  Returns ``("replay", payload)``
        for the already-committed watermark chunk, else ``("decode",
        adjusted_chunk)`` with the overlap carry folded into the first
        detector slice (circuit mode).  Raises ``StreamProtocolError`` on
        protocol violations; nothing is mutated except the in-flight mark."""
        try:
            seq = int(seq)
        except (TypeError, ValueError):
            raise StreamProtocolError(
                f"chunk seq must be an int, got {seq!r}", code="seq") from None
        arr = np.atleast_2d(np.ascontiguousarray(chunk, np.uint8))
        with self._lock:
            if self.closed:
                raise StreamProtocolError(
                    f"stream {self.stream_id} is closed", code="closed")
            if seq == self.committed and self._last_response is not None:
                telemetry.count("stream.replays")
                return "replay", dict(self._last_response)
            if seq <= self.committed:
                raise StreamProtocolError(
                    f"chunk seq {seq} is behind the commit watermark "
                    f"{self.committed} and no longer cached", code="stale")
            if seq > self.committed + 1:
                raise StreamProtocolError(
                    f"chunk seq {seq} leaves a gap after committed "
                    f"{self.committed} — resend window {self.committed + 1}",
                    code="gap")
            if self._inflight is not None:
                raise StreamProtocolError(
                    f"window {self._inflight} is already in flight",
                    code="busy")
            if arr.shape != (self.lanes, self.width):
                raise StreamProtocolError(
                    f"chunk shape {arr.shape} != ({self.lanes}, "
                    f"{self.width})", code="shape")
            self._inflight = seq
            if self._carry_space is not None:
                adjusted = arr.copy()
                m = self._carry_space.shape[1]
                adjusted[:, :m] ^= self._carry_space
                return "decode", adjusted
            return "decode", arr

    def commit(self, seq: int, corrections, converged=None) -> dict:
        """Fold window ``seq``'s corrections into the carry and advance the
        watermark — the ONLY mutation of committed state, atomic under the
        stream lock.  Returns the response payload (also cached for
        replay)."""
        cor = np.atleast_2d(np.asarray(corrections, np.uint8))
        with self._lock:
            if self._inflight != seq:
                raise StreamProtocolError(
                    f"commit of seq {seq} does not match the in-flight "
                    f"window {self._inflight}", code="commit")
            if self._carry_space is not None:
                self._carry_space ^= (cor @ self._space_cor) % 2
            else:
                self._frame = (cor.copy() if self._frame is None
                               else self._frame ^ cor)
            if self._log_mat is not None:
                self._carry_log ^= (cor @ self._log_mat) % 2
            self.committed = seq
            self._inflight = None
            payload = {"ok": True, "stream": self.stream_id, "seq": seq,
                       "committed": seq,
                       "committed_cycles": self.committed_cycles,
                       "corrections": cor,
                       "converged": (None if converged is None else
                                     [bool(x) for x in np.asarray(converged).ravel()])}
            if self._carry_log is not None:
                payload["log_frame"] = self._carry_log.tolist()
            self._last_response = payload
            telemetry.count("stream.commits")
            telemetry.count("stream.cycles", self.cycles_per_window)
            return dict(payload)

    def abort(self, seq: int) -> None:
        """Drop the in-flight mark after a failed decode attempt: the
        window was NOT committed and the client may resend it."""
        with self._lock:
            if self._inflight == seq:
                self._inflight = None

    def frame(self) -> np.ndarray | None:
        """Frame-mode accumulated Pauli frame (copy), None before the
        first commit or in circuit mode."""
        with self._lock:
            return None if self._frame is None else self._frame.copy()

    # ------------------------------------------------------------------
    # handoff replication
    # ------------------------------------------------------------------
    def export_state(self) -> dict:
        """JSON-serializable snapshot of the COMMITTED state — watermark,
        boundary carries, the cached replay response — everything a
        successor host needs to continue this stream exactly-once after a
        handoff.  In-flight (uncommitted) work is deliberately excluded:
        the client retries the same seq and the successor decodes it fresh
        from the replicated carry, bit-exact."""
        with self._lock:
            last = None
            if self._last_response is not None:
                last = {k: (np.asarray(v, np.uint8).tolist()
                            if k == "corrections" else v)
                        for k, v in self._last_response.items()}
            return {
                "stream": self.stream_id,
                "profile": getattr(self, "profile_name", None),
                "committed": int(self.committed),
                "closed": bool(self.closed),
                "lanes": int(self.lanes),
                "tenant": self.tenant,
                "carry_space": (None if self._carry_space is None
                                else self._carry_space.tolist()),
                "carry_log": (None if self._carry_log is None
                              else self._carry_log.tolist()),
                "frame": (None if self._frame is None
                          else self._frame.tolist()),
                "last_response": last,
            }

    def import_state(self, state: dict) -> bool:
        """Merge one ``export_state`` snapshot, idempotent and monotone:
        the snapshot only applies when its watermark is AHEAD of ours
        (replication deltas can arrive duplicated or out of order; an
        older copy must never roll a commit back).  Returns True when the
        snapshot advanced this stream."""
        committed = int(state.get("committed", 0))
        with self._lock:
            if committed <= self.committed:
                return False
            self.committed = committed
            self.closed = bool(state.get("closed", False))
            self._inflight = None
            cs = state.get("carry_space")
            if cs is not None and self._carry_space is not None:
                self._carry_space = np.ascontiguousarray(cs, np.uint8)
            cl = state.get("carry_log")
            if cl is not None and self._carry_log is not None:
                self._carry_log = np.ascontiguousarray(cl, np.uint8)
            fr = state.get("frame")
            if fr is not None:
                self._frame = np.ascontiguousarray(fr, np.uint8)
            last = state.get("last_response")
            if last is not None:
                payload = dict(last)
                if payload.get("corrections") is not None:
                    payload["corrections"] = np.atleast_2d(np.asarray(
                        payload["corrections"], np.uint8))
                self._last_response = payload
            return True

    def close(self) -> dict:
        with self._lock:
            self.closed = True
            return {"stream": self.stream_id, "committed": self.committed,
                    "committed_cycles": self.committed_cycles}
