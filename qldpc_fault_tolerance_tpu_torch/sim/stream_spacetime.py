"""Streaming space-time decode: sliding-window overlap-commit drivers.

The JAX package's ``sim/stream_spacetime.py``.  The batch space-time engines
decode a fixed number of cycles at once; the drivers here run the same
window step the batch engines run (``PhenomEngine._window``,
``CodeSimulator_Circuit_SpaceTime._window_commit``), one fixed-shape step
per committed window, so a commit costs one window however long the stream
runs, and the carry after k streamed windows is bit for bit the batch
engine's after k windows on the same shots.

On the card each driver captures its step once per (batch, window) shape as
a CUDA graph (``parallel/shots.py`` ``CapturedStep``, the decodes' tier
ladders conditional nodes in it) and replays it every step: a step reads
nothing on the host, the port's counterpart of "one executable serves every
step".  Elsewhere a step runs eagerly.

Window/commit structure: a window is ``num_rep`` cycles decoded jointly;
committing it folds its corrections into the boundary carry (phenom: the
residual data errors; circuit: the accumulated space and logical
corrections), which adjusts the next window's first detector slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.prng import key_words, prng_key
from ..parallel.shots import CapturedStep, batch_seed
from .common import st_round_counts, st_window_count

__all__ = [
    "PhenomStreamDriver",
    "CircuitStreamDriver",
    "st_round_counts",
    "st_window_count",
]


class PhenomStreamDriver:
    """Streaming driver over a phenomenological engine
    (``CodeSimulator_Phenon_SpaceTime``, or ``CodeSimulator_Phenon``, whose
    window is one round).

    ``reset(key)`` starts the stream of ``run_batch(key, ...)``: its errors
    come from the batch generator of ``key``, and window i draws the i-th
    window's errors of that stream (on the card a Philox offset that
    depends on the key and i alone: the port's counterpart of the JAX
    driver's ``fold_in(key, i)``).  ``step()`` samples, decodes and commits
    one window, so after k steps ``carry`` is the batch engine's carry after
    k windows, and ``finalize()`` runs the perfect final round on the
    stream's next draws and returns ``run_batch(key, k + 1)``'s per-shot
    failure flags, bit for bit.
    """

    def __init__(self, sim, batch_size: int | None = None):
        self.sim = sim
        self.batch_size = int(batch_size or sim.batch_size)
        self.num_rep = int(getattr(sim, "num_rep", 1))
        dev = sim.device
        self.generator = torch.Generator(device=dev)
        self._step = CapturedStep(self._body, sim._zeros(self.batch_size),
                                  self.generator)
        self.reset(prng_key(0))

    def _body(self, generator, carry):
        return self.sim._window(self.sim._draws(generator, self.batch_size),
                                *carry, self.batch_size)

    @property
    def carry(self):
        """The (X, Z) residual data errors after the committed windows
        (packed 32 shots per word when the engine runs packed)."""
        return self._step.carry

    def reset(self, key):
        self.key = key
        self.generator.manual_seed(batch_seed(key_words(key), 0))
        for c in self._step.carry:
            c.zero_()
        self.committed_rounds = 0
        return self

    @property
    def committed_cycles(self) -> int:
        return self.committed_rounds * self.num_rep

    def step(self):
        """Commit the next window; returns its (X, Z) corrections (the
        graph's buffers on the card, overwritten by the next step)."""
        cors = self._step()
        self.committed_rounds += 1
        return cors

    def finalize(self) -> np.ndarray:
        """The perfect final round on the streamed carry -> per-shot
        failure flags (host bool array)."""
        sim, bs = self.sim, self.batch_size
        res = sim._final_round(sim._draws(self.generator, bs), *self.carry,
                               bs)
        fail, min_w = sim._flags(*res, bs)
        sim.min_logical_weight = min(sim.min_logical_weight, int(min_w))
        return fail.cpu().numpy()


class CircuitStreamDriver:
    """Streaming driver over ``CodeSimulator_Circuit_SpaceTime``.

    The caller feeds per-window detector slices of shape ``(batch, num_rep
    * m)``, the rows the batch engine's window scan decodes; each ``step``
    decodes one window and commits it into the (space correction, logical
    correction) carry.  After k steps the carry is the batch scan's after
    the same k windows, bit for bit.  ``finalize`` folds the carry into the
    final detector slice and runs the final-layer decode.
    """

    def __init__(self, sim, batch_size: int | None = None):
        sim._ensure_ready()
        self.sim = sim
        self.batch_size = int(batch_size or sim.batch_size)
        self.m = sim.num_checks
        dev = sim.device
        self._window = torch.zeros((self.batch_size, sim.num_rep * self.m),
                                   dtype=torch.uint8, device=dev)
        carry = (torch.zeros((self.batch_size, self.m), dtype=torch.uint8,
                             device=dev),
                 torch.zeros((self.batch_size, sim.num_logicals),
                             dtype=torch.uint8, device=dev))
        self._step = CapturedStep(
            lambda _gen, carry: sim._window_commit(carry, self._window),
            carry)
        self.reset()

    @property
    def carry(self):
        """(space correction (B, m), logical correction (B,
        num_logicals)) uint8 after the committed windows."""
        return self._step.carry

    def reset(self):
        for c in self._step.carry:
            c.zero_()
        self.committed_windows = 0
        return self

    @property
    def committed_cycles(self) -> int:
        return self.committed_windows * self.sim.num_rep

    def step(self, window):
        """Commit one window of detector data (a device tensor, or a host
        array that is copied over); returns its fault corrections (the
        graph's buffer on the card, overwritten by the next step)."""
        want = (self.batch_size, self.sim.num_rep * self.m)
        if tuple(window.shape) != want:
            raise ValueError(f"window shape {tuple(window.shape)} != {want}")
        if not isinstance(window, torch.Tensor):
            window = torch.from_numpy(np.array(window, np.uint8))
        self._window.copy_(window)
        cor = self._step()
        self.committed_windows += 1
        return cor

    def finalize(self, final_syn_raw):
        """The final-layer decode on the streamed carry: (logical
        correction, final syndrome, final correction), as the batch
        engine's window scan ends."""
        if not isinstance(final_syn_raw, torch.Tensor):
            final_syn_raw = torch.from_numpy(np.array(final_syn_raw,
                                                      np.uint8))
        return self.sim._final_decode(
            self.carry, final_syn_raw.to(self.sim.device, torch.uint8))
