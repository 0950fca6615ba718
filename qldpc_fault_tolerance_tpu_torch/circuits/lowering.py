"""Lowering of the circuit IR to fused, vectorizable primitive ops.

The sampler (device, random) and the detector-error-model derivation (host,
deterministic) share this compiled form, so fault propagation and sampling
agree by construction.

Compilation steps:
  1. walk the IR, resolving DETECTOR / OBSERVABLE_INCLUDE record lookbacks to
     absolute measurement-record columns (REPEAT blocks contribute contiguous
     record ranges);
  2. lower gates/noise to primitive ops with explicit target index arrays and
     *absolute* record columns on measurement ops (so op order no longer
     encodes record order);
  3. fuse ops: an op may migrate backward past ops whose qubit support is
     disjoint from its own and merge into an earlier op with the same kind and
     args — disjoint-support ops commute, so this is semantics-preserving.
     CX/CZ additionally refuse a merge that would put one qubit on both the
     control and target side (shared controls or shared targets are fine:
     the fused update uses XOR-accumulating scatters).  This collapses the
     reference's CX / DEPOLARIZE2 interleave (AddCXError emits one noise line
     per gate line) into one gate op + one noise op per scheduling layer.

Zero-probability noise ops are dropped (the notebooks routinely pass
p_i = p_state_p = 0, src demo cell 2).
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
import threading
import warnings
from collections import OrderedDict

import numpy as np

from .ir import (
    Circuit,
    Instruction,
    MEASUREMENT_NAMES,
    NOISE_NAMES,
    RecTarget,
    RepeatBlock,
)

__all__ = ["Op", "Segment", "CompiledCircuit", "compile_circuit"]


@dataclasses.dataclass
class Op:
    """One fused primitive op.

    kind:
      'cx'/'cz'    a, b: control/target index arrays
      'h'          a: qubit indices (x/z swap)
      'reset'      a: qubit indices (frame cleared; covers R and RX)
      'measure'    a: qubit indices; basis 'z' (M/MR: record x-frame) or
                   'x' (MX: record z-frame); rec: absolute record columns;
                   reset_after: MR; collapse: randomize conjugate frame (M/MX)
      'dep1'       a, p: single-qubit depolarizing (X/Y/Z each p/3)
      'dep2'       a, b, p: two-qubit depolarizing (15 components, p/15 each)
      'perr'       a, p, fx, fz: Pauli error (X_ERROR: fx; Z_ERROR: fz;
                   Y_ERROR: both)
    """

    kind: str
    a: np.ndarray
    b: np.ndarray | None = None
    p: float = 0.0
    basis: str = "z"
    rec: np.ndarray | None = None
    reset_after: bool = False
    collapse: bool = False
    fx: bool = False
    fz: bool = False
    noise_id: int = -1

    @property
    def is_random(self) -> bool:
        return self.kind in ("dep1", "dep2", "perr") or (
            self.kind == "measure" and self.collapse and not self.reset_after
        )

    def support(self) -> frozenset:
        s = set(self.a.tolist())
        if self.b is not None:
            s |= set(self.b.tolist())
        return frozenset(s)


@dataclasses.dataclass
class Segment:
    """A run of ops executed once ('block') or scanned ('repeat')."""

    kind: str  # 'block' | 'repeat'
    ops: list[Op]
    repeat_count: int = 1
    meas_per_iter: int = 0  # record width contributed by one iteration
    rec_offset: int = 0  # absolute record column of this segment's first bit


@dataclasses.dataclass
class CompiledCircuit:
    num_qubits: int
    num_measurements: int
    num_detectors: int
    num_observables: int
    segments: list[Segment]
    # detector d = XOR of record columns det_cols[d]; same for observables
    det_cols: list[list[int]]
    obs_cols: list[list[int]]
    # text-emission metadata for the DEM: ('shift',) and ('det', det_index,
    # args) events in circuit order, only for detectors carrying args
    coord_events: list[tuple]

    def structure_key(self) -> str:
        """Digest of the circuit *structure* — every field the sampler bakes
        into its program EXCEPT the noise probabilities ``op.p``.  Two
        compiled circuits with equal keys differ in their error rates
        alone."""
        import hashlib

        h = hashlib.sha256()

        def put(*vals):
            # each value is framed (type tag + shape/dtype for arrays + a
            # terminator) so adjacent fields can never alias across
            # boundaries — ints (1, 23) vs (12, 3) must hash differently
            for v in vals:
                if isinstance(v, np.ndarray):
                    h.update(f"a{v.dtype}{v.shape}|".encode())
                    h.update(v.tobytes())
                else:
                    h.update(f"v{v!r}".encode())
                h.update(b";")

        put(self.num_qubits, self.num_measurements, self.num_detectors,
            self.num_observables)
        for seg in self.segments:
            put(seg.kind, seg.repeat_count, seg.meas_per_iter, seg.rec_offset)
            for op in seg.ops:
                put(op.kind, op.a, op.b if op.b is not None else "-",
                    op.basis, op.rec if op.rec is not None else "-",
                    op.reset_after, op.collapse, op.fx, op.fz, op.noise_id)
        for cols in self.det_cols:
            put(cols)
        for cols in self.obs_cols:
            put(cols)
        return h.hexdigest()

    def flattened_ops(self):
        """Ops with repeat segments unrolled; measurement record columns
        shifted per iteration.  Yields (op, unrolled_index)."""
        i = 0
        for seg in self.segments:
            for it in range(seg.repeat_count if seg.kind == "repeat" else 1):
                for op in seg.ops:
                    if op.kind == "measure" and seg.kind == "repeat":
                        op = dataclasses.replace(
                            op, rec=op.rec + seg.rec_offset + it * seg.meas_per_iter
                        )
                    elif op.kind == "measure":
                        op = dataclasses.replace(op, rec=op.rec + seg.rec_offset)
                    yield op, i
                    i += 1


def _mergeable(into: Op, op: Op) -> bool:
    if into.kind != op.kind:
        return False
    if into.kind in ("dep1", "dep2", "perr"):
        # disjoint support required: the scatter-free sampler applies fused
        # noise via membership masks, which would collapse a repeated qubit's
        # k independent channel applications into one
        return (into.p == op.p and into.fx == op.fx and into.fz == op.fz
                and not (into.support() & op.support()))
    if into.kind in ("cx", "cz"):
        # one side may repeat, but no qubit may sit on both sides of the
        # fused op (that would reorder a read-after-write)
        a = set(into.a.tolist()) | set(op.a.tolist())
        b = set(into.b.tolist()) | set(op.b.tolist())
        return not (a & b)
    if into.kind in ("h", "reset"):
        return not (into.support() & op.support())
    if into.kind == "measure":
        return (
            into.basis == op.basis
            and into.reset_after == op.reset_after
            and into.collapse == op.collapse
            and not (into.support() & op.support())
        )
    return False


def _merge(into: Op, op: Op) -> Op:
    a = np.concatenate([into.a, op.a])
    b = None if into.b is None else np.concatenate([into.b, op.b])
    rec = None if into.rec is None else np.concatenate([into.rec, op.rec])
    return dataclasses.replace(into, a=a, b=b, rec=rec)


def _fuse(ops: list[Op]) -> list[Op]:
    fused: list[Op] = []
    supports: list[frozenset] = []
    for op in ops:
        sup = op.support()
        merged = False
        # migrate backward past disjoint ops; merge into a compatible one
        for j in range(len(fused) - 1, -1, -1):
            if _mergeable(fused[j], op):
                fused[j] = _merge(fused[j], op)
                supports[j] = supports[j] | sup
                merged = True
                break
            if supports[j] & sup:
                break
        if not merged:
            fused.append(op)
            supports.append(sup)
    return fused


def _lower_instruction(ins: Instruction, rec_base: int):
    """Lower one IR instruction to zero, one, or a list of proto-ops.
    rec_base is the
    measurement count before this instruction (for record columns relative to
    the enclosing segment)."""
    name = ins.name
    q = np.asarray([t for t in ins.targets if not isinstance(t, RecTarget)], dtype=np.int32)
    if name == "TICK" or name in ("DETECTOR", "OBSERVABLE_INCLUDE", "SHIFT_COORDS"):
        return None
    if name in ("R", "RX"):
        return Op("reset", q)
    if name == "H":
        return Op("h", q)
    if name in ("CX", "CZ"):
        a, b = q[0::2], q[1::2]
        if name == "CX" and set(a.tolist()) & set(b.tolist()):
            # Chained pairs sharing a qubit across sides ('CX 0 1 1 2'):
            # stim applies the pairs left to right, so a later pair must see
            # the frame already updated by an earlier one.  A single fused
            # scatter op would read pre-update values — split into
            # sequential per-pair ops (_fuse re-merges only the safe ones).
            # CZ needs no split: it only reads x-frames and writes z-frames,
            # so the fused add-scatter is order-independent.
            return [
                Op(name.lower(), a[i : i + 1], b[i : i + 1])
                for i in range(len(a))
            ]
        return Op(name.lower(), a, b)
    if name in ("M", "MR", "MX"):
        rec = np.arange(rec_base, rec_base + len(q), dtype=np.int32)
        return Op(
            "measure", q, basis="x" if name == "MX" else "z", rec=rec,
            reset_after=(name == "MR"), collapse=(name != "MR"),
        )
    if name in ("X_ERROR", "Y_ERROR", "Z_ERROR", "DEPOLARIZE1", "DEPOLARIZE2"):
        p = float(ins.args[0]) if ins.args else 0.0
        if p == 0.0 or len(q) == 0:
            return None
        if name == "DEPOLARIZE1":
            return Op("dep1", q, p=p)
        if name == "DEPOLARIZE2":
            return Op("dep2", q[0::2], q[1::2], p=p)
        return Op(
            "perr", q, p=p,
            fx=name in ("X_ERROR", "Y_ERROR"), fz=name in ("Z_ERROR", "Y_ERROR"),
        )
    raise ValueError(f"cannot lower instruction {name}")


_NOISE_ARG_RE = re.compile(
    r"^(\s*(?:X_ERROR|Y_ERROR|Z_ERROR|DEPOLARIZE1|DEPOLARIZE2))\(([^)]+)\)",
    re.M,
)

# digest -> lowered template; keyed on sha256 of the canonical text so the
# memo does not pin multi-MB circuit strings (hgp-sized circuits are ~70k
# instruction lines).  functools.lru_cache does not fit: the value is built
# from the canonical TEXT while the key must be its digest.
_TEMPLATE_CACHE: "OrderedDict[str, CompiledCircuit]" = OrderedDict()
_TEMPLATE_CACHE_MAX = 32
_TEMPLATE_CACHE_LOCK = threading.Lock()


def _freeze_template_arrays(template: CompiledCircuit) -> None:
    """Templates share their index arrays (op targets, rec columns) with
    every instantiation compile_circuit returns — an in-place write through
    any of them would corrupt the cache and all sibling instantiations, so
    make numpy raise instead."""
    for seg in template.segments:
        for op in seg.ops:
            for arr in (op.a, op.b, op.rec):
                if arr is not None:
                    arr.setflags(write=False)


def compile_circuit(circuit: Circuit) -> CompiledCircuit:
    """Lower a circuit, memoizing the expensive passes on the circuit's
    p-CANONICALIZED text.

    A threshold sweep lowers the same memory-circuit layout once per
    (code, p, seed) cell — seconds of pure Python each for hgp-sized
    circuits (~70k instructions), differing only in the noise-probability
    literals.  The canonical form replaces each distinct nonzero
    probability with its first-occurrence index (1, 2, ...), which
    preserves BOTH lowering-relevant properties of the probabilities: the
    zero/nonzero pattern (zero-p ops are dropped) and the equality pattern
    (_mergeable fuses noise ops only at equal p).  The lowered template is
    cached on the canonical text's sha256; instantiation rewrites only the
    fused noise ops' ``p`` values (index -> actual probability), sharing
    every index array.

    Probability precision: canonicalization reads the probabilities from
    the circuit's TEXT form, whose fixed-point float format carries 12
    decimals (ir._fmt_arg) — probabilities are distinguished (and
    preserved) to 1e-12, far below any physical operating point; a nonzero
    p that formats to 0 would be dropped like an explicit zero.
    """
    text = str(circuit)
    values: list[float] = []
    ids: dict[float, int] = {}
    saw_zero_noise = False

    def _sub(m):
        # the package emits exactly one argument per noise instruction; a
        # multi-arg line would silently corrupt the index mapping below, so
        # fail loudly instead of guessing
        f = float(m.group(2).strip())
        if f == 0.0:
            nonlocal saw_zero_noise
            saw_zero_noise = True
            return m.group(0)
        if f not in ids:
            ids[f] = len(values) + 1
            values.append(f)
        return f"{m.group(1)}({ids[f]})"

    canon = _NOISE_ARG_RE.sub(_sub, text)
    if saw_zero_noise:
        # a zero-probability NOISE arg in the text is either a true p=0 op
        # (dropped by design) or a nonzero p < 5e-13 that rounded to zero in
        # the 12-decimal format; tell those apart from the in-memory
        # instructions and make the pathological case visible.  (Gated on
        # noise args specifically — annotation args like OBSERVABLE_INCLUDE(0)
        # must not trigger the O(instructions) walk on every compile.)
        def _each_ins(items):
            for item in items:
                if isinstance(item, RepeatBlock):
                    yield from _each_ins(item.body.items)
                else:
                    yield item

        for ins in _each_ins(circuit.items):
            if ins.name in NOISE_NAMES and ins.args and 0 < ins.args[0] < 5e-13:
                warnings.warn(
                    f"noise probability {ins.args[0]!r} formats to 0 in the "
                    "12-decimal circuit text and the op will be dropped "
                    "(compile_circuit docstring, 'Probability precision')",
                    stacklevel=2,
                )
                break
    digest = hashlib.sha256(canon.encode()).hexdigest()
    with _TEMPLATE_CACHE_LOCK:
        template = _TEMPLATE_CACHE.get(digest)
        if template is not None:
            _TEMPLATE_CACHE.move_to_end(digest)
    if template is None:
        template = _compile_circuit_impl(Circuit(canon))
        _freeze_template_arrays(template)
        with _TEMPLATE_CACHE_LOCK:
            _TEMPLATE_CACHE[digest] = template
            if len(_TEMPLATE_CACHE) > _TEMPLATE_CACHE_MAX:
                _TEMPLATE_CACHE.popitem(last=False)
    segs = []
    for seg in template.segments:
        ops = []
        for op in seg.ops:
            if op.kind in ("dep1", "dep2", "perr"):
                idx = int(op.p)
                if op.p != idx or not 1 <= idx <= len(values):
                    # hard error (not assert: silent corruption under -O
                    # would install a wrong probability)
                    raise RuntimeError(
                        "template op carries a non-index probability "
                        f"({op.p!r}) — canonicalization missed a noise "
                        "instruction"
                    )
                op = dataclasses.replace(op, p=values[idx - 1])
            ops.append(op)
        segs.append(dataclasses.replace(seg, ops=ops))
    return dataclasses.replace(template, segments=segs)


def _compile_circuit_impl(circuit: Circuit) -> CompiledCircuit:
    nq = circuit.num_qubits

    # ---- pass 1: resolve record columns for detectors/observables, collect
    # coordinate events, and lower to per-segment proto-op lists
    det_cols: list[list[int]] = []
    obs_cols_by_idx: dict[int, list[int]] = {}
    coord_events: list[tuple] = []
    segments: list[Segment] = []
    meas_count = 0
    det_count = 0

    def walk(items, ops_out: list[Op], seg_rec_base: int):
        nonlocal meas_count, det_count
        for item in items:
            if isinstance(item, RepeatBlock):
                raise ValueError("nested REPEAT blocks are not supported")
            ins = item
            if ins.name == "DETECTOR":
                det_cols.append(
                    sorted(meas_count + t.offset for t in ins.targets)
                )
                if ins.args:
                    coord_events.append(("det", det_count, ins.args))
                det_count += 1
                continue
            if ins.name == "OBSERVABLE_INCLUDE":
                idx = int(ins.args[0]) if ins.args else 0
                obs_cols_by_idx.setdefault(idx, []).extend(
                    meas_count + t.offset for t in ins.targets
                )
                continue
            if ins.name == "SHIFT_COORDS":
                coord_events.append(("shift", tuple(ins.args)))
                continue
            op = _lower_instruction(ins, meas_count - seg_rec_base)
            if ins.name in MEASUREMENT_NAMES:
                meas_count += sum(
                    1 for t in ins.targets if not isinstance(t, RecTarget)
                )
            if op is not None:
                ops_out.extend(op) if isinstance(op, list) else ops_out.append(op)

    pending: list[Op] = []
    pending_rec_offset = 0

    def flush_pending():
        nonlocal pending
        if pending:
            segments.append(
                Segment("block", _fuse(pending), rec_offset=pending_rec_offset)
            )
        pending = []

    for item in circuit.items:
        if isinstance(item, RepeatBlock):
            body = item.body
            if any(isinstance(x, RepeatBlock) for x in body.items):
                # only the outermost repeat is scanned; inner repeats (e.g.
                # the (num_rep-1)-fold sub-round block of the space-time
                # circuit) are unrolled into the scanned body
                flat = Circuit()
                flat.items = list(body.flattened())
                body = flat
            body_meas = body.num_measurements
            body_dets = body.num_detectors
            flush_pending()
            seg_ops: list[Op] = []
            rec_offset = meas_count
            # resolve detector lookbacks against iteration 0; later
            # iterations' columns follow by a uniform +it*body_meas shift
            # (valid for lookbacks into the current or any earlier iteration,
            # e.g. the reference's difference detectors)
            start_meas = meas_count
            start_det = det_count
            body_coord_start = len(coord_events)
            obs_lens_before = {k: len(v) for k, v in obs_cols_by_idx.items()}
            walk(body.items, seg_ops, start_meas)
            first_iter_det = det_cols[start_det:det_count]
            first_iter_coords = coord_events[body_coord_start:]
            first_iter_obs = {
                k: v[obs_lens_before.get(k, 0):]
                for k, v in obs_cols_by_idx.items()
                if len(v) > obs_lens_before.get(k, 0)
            }
            for it in range(1, item.repeat_count):
                shift = it * body_meas
                for cols in first_iter_det:
                    det_cols.append([c + shift for c in cols])
                for k, cols in first_iter_obs.items():
                    obs_cols_by_idx[k].extend(c + shift for c in cols)
                for ev in first_iter_coords:
                    if ev[0] == "det":
                        coord_events.append(
                            ("det", ev[1] + it * body_dets, ev[2])
                        )
                    else:
                        coord_events.append(ev)
            det_count = start_det + item.repeat_count * body_dets
            meas_count = start_meas + item.repeat_count * body_meas
            segments.append(
                Segment(
                    "repeat", _fuse(seg_ops), repeat_count=item.repeat_count,
                    meas_per_iter=body_meas, rec_offset=rec_offset,
                )
            )
        else:
            if not pending:
                pending_rec_offset = meas_count
            walk([item], pending, pending_rec_offset)
    flush_pending()

    # measurement ops inside 'block' segments carry columns relative to the
    # segment; inside 'repeat' segments relative to the iteration (both are
    # shifted by Segment.rec_offset / iteration stride at execution time)

    # ---- assign noise ids
    nid = 0
    for seg in segments:
        for op in seg.ops:
            if op.is_random or op.kind == "measure":
                op.noise_id = nid
                nid += 1

    num_obs = (max(obs_cols_by_idx) + 1) if obs_cols_by_idx else 0
    obs_cols = [sorted(obs_cols_by_idx.get(i, [])) for i in range(num_obs)]

    return CompiledCircuit(
        num_qubits=nq,
        num_measurements=meas_count,
        num_detectors=det_count,
        num_observables=num_obs,
        segments=segments,
        det_cols=det_cols,
        obs_cols=obs_cols,
        coord_events=coord_events,
    )
