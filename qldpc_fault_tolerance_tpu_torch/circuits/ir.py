"""Stabilizer-circuit IR with a stim-compatible text round-trip.

The reference drives everything through ``stim.Circuit`` and its *text* form:
circuits are composed with ``+`` / ``*``, noise is injected by regex rewrites
of ``str(circuit)`` (src/ErrorPlugin.py), and the space-time decoder consumes
the text of ``circuit.detector_error_model(...)``.  This module provides the
same surface without stim: a minimal instruction list, ``append`` with stim's
argument conventions, text emission/parsing, and REPEAT blocks (kept
structured so the frame sampler runs a block's ops once per iteration).

Supported instructions (all the reference emits, src/Simulators.py:438-609,
src/Simulators_SpaceTime.py:737-941): R, RX, H, CX, CZ, M, MR, MX, TICK,
X_ERROR, Y_ERROR, Z_ERROR, DEPOLARIZE1, DEPOLARIZE2, DETECTOR,
OBSERVABLE_INCLUDE, SHIFT_COORDS, and REPEAT blocks.
"""
from __future__ import annotations

import dataclasses
import re

__all__ = ["Circuit", "Instruction", "RepeatBlock", "RecTarget", "target_rec"]

GATE_NAMES = {"R", "RX", "H", "CX", "CZ", "M", "MR", "MX", "TICK"}
NOISE_NAMES = {"X_ERROR", "Y_ERROR", "Z_ERROR", "DEPOLARIZE1", "DEPOLARIZE2"}
ANNOTATION_NAMES = {"DETECTOR", "OBSERVABLE_INCLUDE", "SHIFT_COORDS"}
MEASUREMENT_NAMES = {"M", "MR", "MX"}
TWO_QUBIT_NAMES = {"CX", "CZ"}


@dataclasses.dataclass(frozen=True)
class RecTarget:
    """A measurement-record lookback target (stim's ``rec[-k]``)."""

    offset: int

    def __post_init__(self):
        if self.offset >= 0:
            raise ValueError("measurement record targets must be negative lookbacks")

    def __str__(self):
        return f"rec[{self.offset}]"


def target_rec(offset: int) -> RecTarget:
    """stim.target_rec equivalent."""
    return RecTarget(int(offset))


@dataclasses.dataclass(frozen=True)
class Instruction:
    name: str
    targets: tuple  # ints (qubits) or RecTargets (record lookbacks)
    args: tuple  # parenthesised float arguments

    def __str__(self):
        out = self.name
        if self.args:
            out += "(" + ", ".join(_fmt_arg(a) for a in self.args) + ")"
        for t in self.targets:
            out += " " + str(t)
        return out


@dataclasses.dataclass
class RepeatBlock:
    repeat_count: int
    body: "Circuit"

    def __str__(self):
        inner = "\n".join("    " + line for line in str(self.body).splitlines())
        return f"REPEAT {self.repeat_count} {{\n{inner}\n}}"


def fmt_float(a: float) -> str:
    """Public fixed-point float formatter for building instruction strings
    (e.g. ``f"DEPOLARIZE2({fmt_float(p)})"``) — never scientific notation, so
    tiny probabilities survive the text round-trip."""
    return _fmt_arg(a)


def _fmt_arg(a: float) -> str:
    """Fixed-point float formatting: the reference DEM/noise parsers match
    ``\\d+\\.\\d+`` (src/Simulators_SpaceTime.py:575), so never emit scientific
    notation and always keep a decimal point."""
    if a == int(a):
        return f"{int(a)}" if abs(a) < 1e15 else f"{a:.1f}"
    s = f"{a:.12f}".rstrip("0")
    if s.endswith("."):
        s += "0"
    return s


def _canon_name(name: str) -> str:
    name = name.upper()
    if name == "DETECTOR" or name == "OBSERVABLE_INCLUDE" or name in GATE_NAMES \
            or name in NOISE_NAMES or name == "SHIFT_COORDS" or name == "REPEAT":
        return name
    raise ValueError(f"unsupported instruction: {name}")


class Circuit:
    """A sequence of Instructions and RepeatBlocks."""

    def __init__(self, text: str | None = None):
        self.items: list[Instruction | RepeatBlock] = []
        if text:
            self._parse(text)

    # ------------------------------------------------------------- building
    def append(self, name, targets=(), args=None):
        """stim-style append.  ``targets`` may be an int, an iterable of ints,
        or RecTargets; ``args`` a float or tuple of floats."""
        name = _canon_name(str(name))
        if isinstance(targets, (int,)):
            targets = (targets,)
        elif isinstance(targets, RecTarget):
            targets = (targets,)
        targets = tuple(
            t if isinstance(t, RecTarget) else int(t) for t in targets
        )
        if args is None:
            args = ()
        elif isinstance(args, (int, float)):
            args = (float(args),)
        else:
            args = tuple(float(a) for a in args)
        if name in TWO_QUBIT_NAMES and len(targets) % 2:
            raise ValueError(f"{name} needs an even number of targets")
        if name in ("DETECTOR", "OBSERVABLE_INCLUDE"):
            if not all(isinstance(t, RecTarget) for t in targets):
                raise ValueError(f"{name} targets must be measurement records")
        self.items.append(Instruction(name, targets, args))
        return self

    def __iadd__(self, other: "Circuit"):
        self.items.extend(other.copy().items)
        return self

    def __add__(self, other: "Circuit") -> "Circuit":
        out = self.copy()
        out.items.extend(other.copy().items)
        return out

    def __mul__(self, n: int) -> "Circuit":
        out = Circuit()
        n = int(n)
        if n < 0:
            raise ValueError("repeat count must be non-negative")
        if n == 0 or not self.items:
            return out
        if n == 1:
            return self.copy()
        out.items.append(RepeatBlock(n, self.copy()))
        return out

    __rmul__ = __mul__

    def detector_error_model(self, flatten_loops: bool = True):
        """stim-parity surface: notebooks call
        ``circuit.detector_error_model(flatten_loops=True)`` directly
        (SpaceTimeDecodingDemo cell 4)."""
        from .dem import detector_error_model

        return detector_error_model(self, flatten_loops=flatten_loops)

    def copy(self) -> "Circuit":
        out = Circuit()
        for item in self.items:
            if isinstance(item, RepeatBlock):
                out.items.append(RepeatBlock(item.repeat_count, item.body.copy()))
            else:
                out.items.append(item)
        return out

    # ------------------------------------------------------------ analysis
    def flattened(self):
        """Yield instructions with REPEAT blocks unrolled."""
        for item in self.items:
            if isinstance(item, RepeatBlock):
                for _ in range(item.repeat_count):
                    yield from item.body.flattened()
            else:
                yield item

    @property
    def num_measurements(self) -> int:
        return sum(
            len(ins.targets) for ins in self.flattened()
            if ins.name in MEASUREMENT_NAMES
        )

    @property
    def num_detectors(self) -> int:
        return sum(1 for ins in self.flattened() if ins.name == "DETECTOR")

    @property
    def num_observables(self) -> int:
        obs = [
            int(ins.args[0]) if ins.args else 0
            for ins in self.flattened() if ins.name == "OBSERVABLE_INCLUDE"
        ]
        return (max(obs) + 1) if obs else 0

    @property
    def num_qubits(self) -> int:
        mx = -1
        for ins in self.flattened():
            for t in ins.targets:
                if not isinstance(t, RecTarget):
                    mx = max(mx, t)
        return mx + 1

    # ---------------------------------------------------------------- text
    def __str__(self):
        return "\n".join(str(item) for item in self.items)

    def __repr__(self):
        return f"Circuit(<{len(self.items)} items>)"

    def __eq__(self, other):
        return isinstance(other, Circuit) and str(self) == str(other)

    _INS_RE = re.compile(r"^([A-Za-z_0-9]+)\s*(?:\(([^)]*)\))?\s*(.*)$")

    def _parse(self, text: str):
        lines = text.splitlines()
        stack_circ = [self]
        stack_reps: list[int] = []
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line == "}":
                if len(stack_circ) < 2:
                    raise ValueError("unbalanced '}' in circuit text")
                body = stack_circ.pop()
                rep = stack_reps.pop()
                stack_circ[-1].items.append(RepeatBlock(rep, body))
                continue
            if line.upper().startswith("REPEAT"):
                m = re.match(r"^REPEAT\s+(\d+)\s*\{$", line, re.IGNORECASE)
                if not m:
                    raise ValueError(f"malformed REPEAT line: {raw!r}")
                stack_reps.append(int(m.group(1)))
                stack_circ.append(Circuit())
                continue
            m = self._INS_RE.match(line)
            if not m:
                raise ValueError(f"cannot parse circuit line: {raw!r}")
            name, argstr, targetstr = m.groups()
            args = tuple(
                float(a) for a in argstr.split(",") if a.strip()
            ) if argstr is not None else ()
            targets = []
            for tok in targetstr.split():
                if tok.startswith("rec["):
                    targets.append(RecTarget(int(tok[4:-1])))
                else:
                    targets.append(int(tok))
            stack_circ[-1].append(name, targets, args if args else None)
        if len(stack_circ) != 1:
            raise ValueError("unbalanced REPEAT block in circuit text")
