"""Detector-error-model derivation and fault-hypergraph extraction.

Replaces ``stim.Circuit.detector_error_model(flatten_loops=True)`` plus the
reference's DEM-text parsers (``GenFaultHyperGraph`` /
``GenCorrecHyperGraph``, src/Simulators_SpaceTime.py:551-668).

Derivation: every noise instruction decomposes into elementary Pauli fault
components (X/Y/Z at p/3 for DEPOLARIZE1, the 15 two-qubit Paulis at p/15 for
DEPOLARIZE2, the literal flip for {X,Y,Z}_ERROR).  Each component is injected
as a deterministic frame flip at its circuit position and propagated through
the Clifford ops to a set of flipped detectors/observables (its *symptom*).
Components are propagated in vectorized host batches over the same lowered op
list the frame sampler executes — sampling and analysis cannot drift apart.
Components with identical symptoms are merged independently:
p <- p1(1-p2) + p2(1-p1); empty symptoms are dropped.

The text form mirrors stim's flattened DEM layout closely enough for the
reference parsers' assumptions (error lines first; coordinate declarations
``detector(c) D#`` grouped per layer and separated by ``shift_detectors(1) 0``
markers; fixed-point probabilities, src/Simulators_SpaceTime.py:554-575).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .ir import Circuit, _fmt_arg
from .lowering import compile_circuit

__all__ = [
    "DetectorErrorModel",
    "detector_error_model",
    "GenFaultHyperGraph",
    "GenCorrecHyperGraph",
]


@dataclasses.dataclass
class DetectorErrorModel:
    """errors: list of (probability, detector ids, observable ids)."""

    errors: list
    num_detectors: int
    num_observables: int
    coord_events: list

    def __str__(self):
        lines = []
        for p, dets, obs in self.errors:
            toks = [f"D{d}" for d in dets] + [f"L{o}" for o in obs]
            lines.append(f"error({_fmt_prob(p)}) " + " ".join(toks))
        for ev in self.coord_events:
            if ev[0] == "shift":
                args = ", ".join(_fmt_arg(a) for a in ev[1])
                lines.append(f"shift_detectors({args}) 0")
            else:
                args = ", ".join(_fmt_arg(a) for a in ev[2])
                lines.append(f"detector({args}) D{ev[1]}")
        return "\n".join(lines)


def _fmt_prob(p: float) -> str:
    s = f"{p:.15f}".rstrip("0")
    if s.endswith("."):
        s += "0"
    return s


def _fault_components(op):
    """Yield (x_qubits, z_qubits, prob) elementary components of a noise op."""
    if op.kind == "perr":
        for q in op.a.tolist():
            yield ((q,) if op.fx else ()), ((q,) if op.fz else ()), op.p
    elif op.kind == "dep1":
        for q in op.a.tolist():
            yield (q,), (), op.p / 3  # X
            yield (q,), (q,), op.p / 3  # Y
            yield (), (q,), op.p / 3  # Z
    elif op.kind == "dep2":
        for a, b in zip(op.a.tolist(), op.b.tolist()):
            for comp in range(1, 16):
                p1, p2 = comp >> 2, comp & 3
                xq = tuple(
                    q for q, pl in ((a, p1), (b, p2)) if pl in (1, 2)
                )
                zq = tuple(
                    q for q, pl in ((a, p1), (b, p2)) if pl in (2, 3)
                )
                yield xq, zq, op.p / 15


def _propagate_chunk(ops, faults, nq, num_meas):
    """Propagate a chunk of deterministic faults; returns their measurement
    flip records (F, num_meas) uint8.

    ops: list of (op, unrolled_index); faults: list of
    (position, x_qubits, z_qubits)."""
    F = len(faults)
    fx = np.zeros((F, nq), np.uint8)
    fz = np.zeros((F, nq), np.uint8)
    rec = np.zeros((F, num_meas), np.uint8)
    by_pos: dict[int, list[int]] = {}
    for i, (pos, _, _) in enumerate(faults):
        by_pos.setdefault(pos, []).append(i)

    for op, pos in ops:
        for i in by_pos.get(pos, ()):  # inject at the faulty op's position
            _, xq, zq = faults[i]
            for q in xq:
                fx[i, q] ^= 1
            for q in zq:
                fz[i, q] ^= 1
        k = op.kind
        if k == "cx":
            np.add.at(fx, (slice(None), op.b), fx[:, op.a])
            np.add.at(fz, (slice(None), op.a), fz[:, op.b])
            fx &= 1
            fz &= 1
        elif k == "cz":
            np.add.at(fz, (slice(None), op.b), fx[:, op.a])
            np.add.at(fz, (slice(None), op.a), fx[:, op.b])
            fz &= 1
        elif k == "h":
            tmp = fx[:, op.a].copy()
            fx[:, op.a] = fz[:, op.a]
            fz[:, op.a] = tmp
        elif k == "reset":
            fx[:, op.a] = 0
            fz[:, op.a] = 0
        elif k == "measure":
            rec[:, op.rec] = fz[:, op.a] if op.basis == "x" else fx[:, op.a]
            if op.reset_after:
                fx[:, op.a] = 0
                fz[:, op.a] = 0
            else:
                # projective collapse: a fault component that (anti)commutes
                # trivially with the measured observable acts trivially on the
                # post-measurement state — clear the conjugate plane (the
                # sampler randomizes it instead, which matches in distribution
                # whenever detectors are noiseless-deterministic; DEM
                # derivation, like stim's, requires that determinism)
                if op.basis == "x":
                    fx[:, op.a] = 0
                else:
                    fz[:, op.a] = 0
        # noise ops: nothing to do deterministically
    return rec


def detector_error_model(
    circuit: Circuit, flatten_loops: bool = True, chunk: int = 4096
) -> DetectorErrorModel:
    """Derive the DEM of a noisy circuit (host-side, construction-time).

    ``flatten_loops`` is accepted for stim-signature parity; the model is
    always flattened."""
    del flatten_loops
    c = compile_circuit(circuit)
    ops = list(c.flattened_ops())

    faults = []  # (position, x_qubits, z_qubits, prob)
    for op, pos in ops:
        if op.kind in ("perr", "dep1", "dep2"):
            for xq, zq, p in _fault_components(op):
                faults.append((pos, xq, zq, p))

    det_idx = [np.asarray(cols, np.int64) for cols in c.det_cols]
    obs_idx = [np.asarray(cols, np.int64) for cols in c.obs_cols]

    merged: dict[tuple, float] = {}
    order: list[tuple] = []
    for lo in range(0, len(faults), chunk):
        batch = faults[lo : lo + chunk]
        rec = _propagate_chunk(
            ops, [(f[0], f[1], f[2]) for f in batch], c.num_qubits,
            c.num_measurements,
        )
        # symptom = XOR of record columns per detector/observable
        dets = np.zeros((len(batch), c.num_detectors), np.uint8)
        for d, cols in enumerate(det_idx):
            if len(cols):
                dets[:, d] = rec[:, cols].sum(axis=1) & 1
        obs = np.zeros((len(batch), c.num_observables), np.uint8)
        for o, cols in enumerate(obs_idx):
            if len(cols):
                obs[:, o] = rec[:, cols].sum(axis=1) & 1
        for i, (_, _, _, p) in enumerate(batch):
            sym = (
                tuple(np.flatnonzero(dets[i]).tolist()),
                tuple(np.flatnonzero(obs[i]).tolist()),
            )
            if not sym[0] and not sym[1]:
                continue
            if sym in merged:
                q = merged[sym]
                merged[sym] = q * (1 - p) + p * (1 - q)
            else:
                merged[sym] = p
                order.append(sym)

    errors = [(merged[sym], sym[0], sym[1]) for sym in order]
    return DetectorErrorModel(
        errors=errors,
        num_detectors=c.num_detectors,
        num_observables=c.num_observables,
        coord_events=c.coord_events,
    )


# ---------------------------------------------------------------------------
# Fault-hypergraph extraction (reference GenFaultHyperGraph /
# GenCorrecHyperGraph semantics, src/Simulators_SpaceTime.py:551-668)
# ---------------------------------------------------------------------------

def _parse_dem_text(dem_text: str):
    """Parse DEM text into (errors, detector layers).

    errors: list of (p, det_names list, logical_names list);
    layers: contiguous groups of declared detector names split on
    shift_detectors markers (empty groups dropped)."""
    errors = []
    layers: list[list[str]] = [[]]
    for raw in dem_text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("error"):
            toks = line.split()
            p = float(toks[0][toks[0].index("(") + 1 : toks[0].index(")")])
            dets = [t for t in toks[1:] if t.startswith("D")]
            logs = [t for t in toks[1:] if t.startswith("L")]
            errors.append((p, dets, logs))
        elif line.startswith("shift_detectors"):
            layers.append([])
        elif line.startswith("detector"):
            layers[-1].append(line.split()[-1])
    layers = [g for g in layers if g]
    return errors, layers


def GenFaultHyperGraph(detector_error_model: str, num_rounds: int,
                       num_rep: int, num_logicals: int):
    """Per-layer fault matrices from a DEM (reference
    src/Simulators_SpaceTime.py:551-610).

    Layers are (first window, final); each error is assigned to the first
    layer whose detectors it touches, restricted to that layer's detectors.
    Returns (H_list, L_list, channel_prob_list)."""
    errors, layer_groups = _parse_dem_text(detector_error_model)
    layered = [layer_groups[0], layer_groups[-1]]
    layer_sets = [set(g) for g in layered]

    layered_errors: list[list] = [[], []]
    for p, dets, logs in errors:
        for layer, names in enumerate(layer_sets):
            hit = set(dets) & names
            if hit:
                layered_errors[layer].append((p, hit, set(logs)))
                break

    H_list, L_list, channel_prob_list = [], [], []
    logicals = [f"L{i}" for i in range(num_logicals)]
    for names, errs in zip(layered, layered_errors):
        H = np.zeros((len(names), len(errs)))
        L = np.zeros((num_logicals, len(errs)))
        for j, (_, dets, logs) in enumerate(errs):
            for i, name in enumerate(names):
                if name in dets:
                    H[i, j] = 1
            for i, lg in enumerate(logicals):
                if lg in logs:
                    L[i, j] = 1
        H_list.append(H)
        L_list.append(L)
        channel_prob_list.append([e[0] for e in errs])
    return H_list, L_list, channel_prob_list


def GenCorrecHyperGraph(detector_error_model: str, num_rounds: int,
                        num_rep: int, num_checks: int, num_logicals: int):
    """Space-correction matrix: which next-window first-layer checks each
    first-window fault flips, folded mod 2 over the num_rep+1 detector slices
    (reference src/Simulators_SpaceTime.py:615-668)."""
    errors, layer_groups = _parse_dem_text(detector_error_model)
    layered = [layer_groups[0], layer_groups[-1]]
    layer_sets = [set(g) for g in layered]
    relevant = layered[0] + layered[1]
    relevant_set = set(relevant)

    first_layer_errors = []
    for p, dets, logs in errors:
        for layer, names in enumerate(layer_sets):
            if set(dets) & names:
                if layer == 0:
                    first_layer_errors.append((p, set(dets) & relevant_set))
                break

    H = np.zeros((len(relevant), len(first_layer_errors)))
    for j, (_, dets) in enumerate(first_layer_errors):
        for i, name in enumerate(relevant):
            if name in dets:
                H[i, j] = 1

    H_space_cor = np.zeros((num_checks, len(first_layer_errors)))
    for i in range(num_rep + 1):
        H_space_cor += H[i * num_checks : (i + 1) * num_checks, :]
    return H_space_cor % 2
