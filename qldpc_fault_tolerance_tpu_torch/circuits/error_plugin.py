"""Noise injection by circuit-text rewriting.

Mirrors the reference's rewrite-``str(circuit)``-and-reparse approach
(src/ErrorPlugin.py): each function finds unique instruction lines and splices
error instructions around them.  Only ``AddCXError`` is used on the
reference's main simulation paths (src/Simulators.py:597,
src/Simulators_SpaceTime.py:935-936); the rest are provided for parity.

Conscious fix vs the reference (documented per SURVEY §2.4): the reference's
measurement/reset regexes (``'\\nM .*\\n'`` etc.) consume the surrounding
newlines, so of two *adjacent* M/R lines only one is rewritten.  Here lines
are matched with ^...$ in MULTILINE mode, so every matching line is rewritten.
Probabilities are formatted fixed-point (never scientific) so tiny values
survive the text round-trip.
"""
from __future__ import annotations

import re

from .ir import Circuit, fmt_float

__all__ = [
    "AddCXError",
    "AddCZError",
    "AddMeasurementError",
    "AddResetError",
    "AddIdlingError",
    "AddSingleQubitErrorBeforeRound",
]


def _rewrite_lines(circuit: Circuit, head_re: str, fn) -> Circuit:
    """Rewrite every line whose mnemonic matches ``head_re``; ``fn(line,
    head)`` returns the replacement text (typically the line plus a spliced
    error line)."""
    pattern = re.compile(rf"^\s*({head_re})( .*)?$", re.MULTILINE)
    out = []
    for raw in str(circuit).splitlines():
        m = pattern.match(raw)
        out.append(fn(raw, m.group(1).strip()) if m else raw)
    return Circuit("\n".join(out))


def AddCXError(circuit: Circuit, error_instruction: str) -> Circuit:
    """Append ``error_instruction`` (e.g. ``'DEPOLARIZE2(0.01)'``) on the same
    targets after every CX (src/ErrorPlugin.py:11-25)."""
    return _rewrite_lines(
        circuit, "CX",
        lambda line, head: line + "\n" + line.replace("CX", error_instruction, 1),
    )


def AddCZError(circuit: Circuit, error_instruction: str) -> Circuit:
    """src/ErrorPlugin.py:29-42."""
    return _rewrite_lines(
        circuit, "CZ",
        lambda line, head: line + "\n" + line.replace("CZ", error_instruction, 1),
    )


def AddMeasurementError(circuit: Circuit, meas_p: float) -> Circuit:
    """X_ERROR(p) on the measured qubits immediately before every M / MR
    (src/ErrorPlugin.py:94-113)."""
    err = f"X_ERROR({fmt_float(meas_p)})"
    return _rewrite_lines(
        circuit, "MR|M",
        lambda line, head: line.replace(head, err, 1) + "\n" + line,
    )


def AddResetError(circuit: Circuit, reset_p: float) -> Circuit:
    """X_ERROR(p) on the reset qubits immediately after every R / MR
    (src/ErrorPlugin.py:145-163)."""
    err = f"X_ERROR({fmt_float(reset_p)})"
    return _rewrite_lines(
        circuit, "MR|R",
        lambda line, head: line + "\n" + line.replace(head, err, 1),
    )


def _targets_suffix(error_instruction: str, target_qubit_indices) -> str:
    return error_instruction + " " + " ".join(str(i) for i in target_qubit_indices)


def AddIdlingError(circuit: Circuit, error_instruction: str,
                   target_qubit_indices=()) -> Circuit:
    """Idling errors on ``target_qubit_indices`` after every M / MR
    (src/ErrorPlugin.py:116-142)."""
    if not len(target_qubit_indices):
        return circuit.copy()
    suffix = _targets_suffix(error_instruction, target_qubit_indices)
    return _rewrite_lines(
        circuit, "MR|M", lambda line, head: line + "\n" + suffix
    )


def AddSingleQubitErrorBeforeRound(circuit: Circuit, error_instruction: str,
                                   target_qubit_indices=()) -> Circuit:
    """Single-qubit errors on ``target_qubit_indices`` after every R / MR
    (src/ErrorPlugin.py:70-91 — the second of the two identically-named
    definitions, which shadows the first)."""
    if not len(target_qubit_indices):
        return circuit.copy()
    suffix = _targets_suffix(error_instruction, target_qubit_indices)
    return _rewrite_lines(
        circuit, "MR|R", lambda line, head: line + "\n" + suffix
    )
