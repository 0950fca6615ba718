"""Vectorized Pauli-frame detector sampler (the JAX package's
``FrameSampler``, ``circuits/sampler.py``, in PyTorch; the counterpart of
stim's ``compile_detector_sampler``).

A Pauli frame is a pair of uint8 bit planes (x, z) of shape (shots,
num_qubits) tracking the difference between the noisy run and a noiseless
reference run.  Gates propagate the frame, noise ops XOR random flips into
it, and measurements copy the relevant plane into a (shots, num_measurements
+ 1) measurement record whose last column stays 0.  Detectors and
observables are XORs of record columns, gathered at the end.

Every op acts on the whole batch and the full qubit width, as the JAX
sampler does: gates are gathers through per-op index maps and masked XORs
(CX and CZ in rounds of disjoint pairs, ``_pairmap``), and every noise op
draws one full-width uniform plane and masks it.  REPEAT blocks run their
ops once per iteration (on the card, inside the captured megabatch).

The uniforms come through one seam, ``uniform(segment, iteration, noise_id,
shape)`` (``iteration`` None outside a REPEAT block): ``sample`` feeds it
from one ``torch.Generator``, one ``torch.rand`` per noise op; a test can
feed it the JAX sampler's own ``jax.random.uniform`` planes, and the
detectors and observables are then the JAX sampler's bit for bit (every op
is an exact compare, or a float32 multiply and truncation).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.prng import key_words, prng_key
from ..parallel.shots import batch_generator
from ..utils.device import resolve_device
from .ir import Circuit
from .lowering import CompiledCircuit, Op, compile_circuit

__all__ = ["FrameSampler"]


def _pad_cols(cols_list: list[list[int]], pad: int) -> np.ndarray:
    width = max((len(c) for c in cols_list), default=0)
    out = np.full((len(cols_list), max(width, 1)), pad, dtype=np.int64)
    for i, cols in enumerate(cols_list):
        out[i, : len(cols)] = cols
    return out


@functools.lru_cache(maxsize=8192)
def _pairmap(a: tuple, b: tuple, nq: int):
    """Rounds of (src[t]=c / src[c]=t index maps + membership masks), as
    the JAX sampler builds them.

    The two sides are disjoint (lowering splits cross-side chains), so the
    pairs commute and any decomposition into rounds with per-round-unique
    qubits reproduces the simultaneous (accumulating) semantics: duplicates
    within a side (one control driving several targets in a fused op) land
    in later rounds."""
    cnt: dict[int, int] = {}
    rounds: dict[int, list[tuple[int, int]]] = {}
    for qa, qb in zip(a, b):
        r = max(cnt.get(qa, 0), cnt.get(qb, 0))
        cnt[qa] = r + 1
        cnt[qb] = r + 1
        rounds.setdefault(r, []).append((qa, qb))
    out = []
    for r in sorted(rounds):
        ra = [p[0] for p in rounds[r]]
        rb = [p[1] for p in rounds[r]]
        ident = np.arange(nq, dtype=np.int64)
        src_t = ident.copy()
        src_t[rb] = ra
        tmask = np.zeros(nq, np.uint8)
        tmask[rb] = 1
        src_c = ident.copy()
        src_c[ra] = rb
        cmask = np.zeros(nq, np.uint8)
        cmask[ra] = 1
        out.append((src_t, tmask, src_c, cmask))
    return tuple(out)


def _qmask(q, nq: int) -> np.ndarray:
    q = list(q)
    if len(set(q)) != len(q):
        raise ValueError("noise/gate op with a repeated qubit: lowering "
                         "must keep overlapping ops separate (_mergeable)")
    m = np.zeros(nq, np.uint8)
    m[q] = 1
    return m


def _pair_expand(a, b, nq: int):
    """pairidx[q] = index of q's pair (0 for uninvolved qubits) plus role
    masks: expands per-pair draws to full qubit width with one gather."""
    qs = list(a) + list(b)
    if len(set(qs)) != len(qs):
        raise ValueError("dep2 op with a repeated qubit: lowering must keep "
                         "overlapping noise ops separate (_mergeable)")
    pairidx = np.zeros(nq, np.int64)
    rolea = np.zeros(nq, np.uint8)
    roleb = np.zeros(nq, np.uint8)
    for i, (qa, qb) in enumerate(zip(a, b)):
        pairidx[qa] = i
        rolea[qa] = 1
        pairidx[qb] = i
        roleb[qb] = 1
    return pairidx, rolea, roleb


def _f32(v: float) -> float:
    """``v`` rounded to float32 (what the JAX sampler computes with)."""
    return float(np.float32(v))


class _Plan:
    """One op with its index maps and masks on the device."""

    def __init__(self, op: Op, nq: int, dev):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.op = op
        kind = op.kind
        if kind in ("cx", "cz"):
            self.rounds = [tuple(map(t, r)) for r in _pairmap(
                tuple(op.a.tolist()), tuple(op.b.tolist()), nq)]
        elif kind == "dep2":
            self.width = len(op.a)
            self.pairidx, self.rolea, self.roleb = map(
                t, _pair_expand(op.a.tolist(), op.b.tolist(), nq))
        else:
            mask = _qmask(op.a.tolist(), nq)
            self.mask = t(mask)
            self.keep = t(1 - mask)
        if kind == "measure":
            self.q = t(np.asarray(op.a, np.int64))
            rec = np.asarray(op.rec, np.int64)
            # contiguous columns are written as a slice, others by index
            contiguous = rec.size and np.all(np.diff(rec) == 1)
            self.rec_slice = int(rec[0]) if contiguous else None
            self.rec = None if contiguous else t(rec)
        if kind in ("dep1", "dep2", "perr"):
            self.p = _f32(op.p)
        if kind in ("dep1", "dep2"):
            # the JAX sampler's float32 ``3.0 / p`` and ``15.0 / p``
            self.scale = _f32(np.float32(3.0 if kind == "dep1" else 15.0)
                              / np.float32(op.p))


def _gate(plan: _Plan, x, z):
    kind = plan.op.kind
    if kind == "cx":
        for src_t, tmask, src_c, cmask in plan.rounds:
            x = x ^ (x[:, src_t] & tmask)
            z = z ^ (z[:, src_c] & cmask)
        return x, z
    if kind == "cz":
        # z_b ^= x_a and z_a ^= x_b: reads x, writes z
        for src_t, tmask, src_c, cmask in plan.rounds:
            z = z ^ (x[:, src_t] & tmask) ^ (x[:, src_c] & cmask)
        return x, z
    if kind == "h":
        d = (x ^ z) & plan.mask
        return x ^ d, z ^ d
    if kind == "reset":
        return x & plan.keep, z & plan.keep
    raise AssertionError(kind)


def _noise(plan: _Plan, u, x, z):
    """``u``: the op's float32 uniforms, (shots, nq), or (shots, pairs) for
    dep2."""
    op = plan.op
    if op.kind == "perr":
        flips = (u < plan.p).to(torch.uint8) & plan.mask
        if op.fx:
            x = x ^ flips
        if op.fz:
            z = z ^ flips
        return x, z
    event = u < plan.p
    comp = (u * plan.scale).to(torch.int32)
    if op.kind == "dep1":
        comp = comp.clamp(0, 2)
        fx = (event & (comp <= 1)).to(torch.uint8) & plan.mask  # X or Y
        fz = (event & (comp >= 1)).to(torch.uint8) & plan.mask  # Y or Z
        return x ^ fx, z ^ fz
    if op.kind == "dep2":
        comp = comp.clamp(0, 14) + 1
        p1 = comp >> 2  # first-qubit Pauli in {I,X,Y,Z} = {0,1,2,3}
        p2 = comp & 3
        fxa = (event & ((p1 == 1) | (p1 == 2))).to(torch.uint8)
        fza = (event & ((p1 == 2) | (p1 == 3))).to(torch.uint8)
        fxb = (event & ((p2 == 1) | (p2 == 2))).to(torch.uint8)
        fzb = (event & ((p2 == 2) | (p2 == 3))).to(torch.uint8)
        fx = (fxa[:, plan.pairidx] & plan.rolea) ^ (fxb[:, plan.pairidx]
                                                   & plan.roleb)
        fz = (fza[:, plan.pairidx] & plan.rolea) ^ (fzb[:, plan.pairidx]
                                                   & plan.roleb)
        return x ^ fx, z ^ fz
    raise AssertionError(op.kind)


def _measure(plan: _Plan, u, x, z, rec, shift: int):
    """Record the measured plane at the op's columns plus ``shift``, then
    reset or collapse (``u``: the collapse's uniforms, or None)."""
    op = plan.op
    bits = (z if op.basis == "x" else x)[:, plan.q]
    if plan.rec_slice is not None:
        c0 = plan.rec_slice + shift
        rec[:, c0:c0 + bits.shape[1]] = bits
    else:
        rec.index_copy_(1, plan.rec + shift, bits)
    if op.reset_after:
        return x & plan.keep, z & plan.keep
    if op.collapse:
        # the conjugate plane becomes irrelevant: randomize it so later
        # (anti)commuting ops see no spurious signal
        r = (u < 0.5).to(torch.uint8) & plan.mask
        if op.basis == "x":
            return x ^ r, z
        return x, z ^ r
    return x, z


class FrameSampler:
    """Detector sampler for one circuit on ``device``.

    ``sample(key, shots)`` returns ``(detectors, observables)`` as device
    uint8 tensors of shape (shots, num_detectors) / (shots,
    num_observables); ``sample_np`` is the host-array convenience.
    """

    def __init__(self, circuit: Circuit | CompiledCircuit, device="cuda"):
        self.device = resolve_device(device)
        self.compiled = (
            circuit if isinstance(circuit, CompiledCircuit)
            else compile_circuit(circuit)
        )
        c = self.compiled
        self.num_qubits = c.num_qubits
        self.num_measurements = c.num_measurements
        self.num_detectors = c.num_detectors
        self.num_observables = c.num_observables
        self.num_noise_ops = sum(op.kind in ("dep1", "dep2", "perr")
                                 for seg in c.segments for op in seg.ops)
        self._segments = [(seg, [_Plan(op, c.num_qubits, self.device)
                                 for op in seg.ops]) for seg in c.segments]
        self._det_idx = torch.from_numpy(
            _pad_cols(c.det_cols, pad=c.num_measurements)).to(self.device)
        self._obs_idx = torch.from_numpy(
            _pad_cols(c.obs_cols, pad=c.num_measurements)).to(self.device)

    def _run_ops(self, plans, uniform, si, it, x, z, rec, shift):
        shots, nq = x.shape
        for plan in plans:
            op = plan.op
            if op.kind in ("cx", "cz", "h", "reset"):
                x, z = _gate(plan, x, z)
            elif op.kind == "measure":
                u = (uniform(si, it, op.noise_id, (shots, nq))
                     if op.is_random else None)
                x, z = _measure(plan, u, x, z, rec, shift)
            else:
                width = plan.width if op.kind == "dep2" else nq
                x, z = _noise(plan, uniform(si, it, op.noise_id,
                                            (shots, width)), x, z)
        return x, z

    def sample_with(self, uniform, shots: int):
        """Detectors and observables with the uniforms from ``uniform(
        segment, iteration, noise_id, shape)`` (module docstring)."""
        dev = self.device
        x = torch.zeros((shots, self.num_qubits), dtype=torch.uint8,
                        device=dev)
        z = torch.zeros_like(x)
        rec = torch.zeros((shots, self.num_measurements + 1),
                          dtype=torch.uint8, device=dev)
        for si, (seg, plans) in enumerate(self._segments):
            if seg.kind == "block":
                x, z = self._run_ops(plans, uniform, si, None, x, z, rec,
                                     seg.rec_offset)
                continue
            for it in range(seg.repeat_count):
                x, z = self._run_ops(plans, uniform, si, it, x, z, rec,
                                     seg.rec_offset + it * seg.meas_per_iter)
        return (self._gather(rec, self._det_idx, self.num_detectors),
                self._gather(rec, self._obs_idx, self.num_observables))

    @staticmethod
    def _gather(rec, idx, width: int):
        """XOR of the record columns each row of ``idx`` names (padding
        points at the always-zero last column)."""
        out = rec[:, idx[:, 0]]
        for t in range(1, idx.shape[1]):
            out = out ^ rec[:, idx[:, t]]
        return out[:, :width]

    def without_noise(self) -> "FrameSampler":
        """A sampler of the same circuit whose noise ops never fire (each
        probability 0; it draws the same uniforms): the noiseless anchor of
        an engine whose decoding graphs came from the noisy circuit."""
        quiet = FrameSampler(self.compiled, device=self.device)
        for _, plans in quiet._segments:
            for plan in plans:
                if plan.op.kind in ("dep1", "dep2", "perr"):
                    plan.p = 0.0
        return quiet

    def sample_generator(self, generator: torch.Generator, shots: int):
        """Detectors and observables drawn from ``generator``: one
        ``torch.rand`` per noise op, in circuit order."""
        def uniform(_si, _it, _nid, shape):
            return torch.rand(shape, generator=generator,
                              dtype=torch.float32, device=self.device)
        return self.sample_with(uniform, shots)

    def sample(self, key, shots: int):
        """Detectors and observables of ``shots`` shots drawn from ``key``
        (a seed or a key, ``ops/prng.py``)."""
        if isinstance(key, (int, np.integer)):
            key = prng_key(key)
        return self.sample_generator(
            batch_generator(key_words(key), 0, self.device), shots)

    def sample_np(self, seed_or_key, shots: int,
                  append_observables: bool = False):
        """stim-like convenience: host uint8 array, observables appended as
        the trailing columns when requested (the reference always samples
        with ``append_observables=True``)."""
        dets, obs = self.sample(seed_or_key, shots)
        if append_observables:
            return torch.cat([dets, obs], dim=1).cpu().numpy()
        return dets.cpu().numpy()
