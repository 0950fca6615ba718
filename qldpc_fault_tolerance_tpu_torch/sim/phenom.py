"""Phenomenological-noise Monte-Carlo engine.

The reference ``CodeSimulator_Phenon`` (``src/Simulators.py:194-383``) and
the JAX package's engine of that name (``sim/phenom.py``): data
depolarizing errors plus syndrome-measurement bit flips over many QEC
rounds.  Per batch, on the device:

  * ``num_rounds - 1`` noisy rounds: fresh data errors (XORed onto the
    carried data residual) and syndrome flips, the extended-matrix [H | I]
    syndromes, decoder 1 (Z sector, then X), and only the data part of the
    residual carried on;
  * a final perfect round: fresh data errors, bare-H syndromes, decoder 2;
  * the residual checks, the Z residual's weight counted only where its
    stabilizer check passed (the reference's if/elif).

``packed=True`` (default) keeps the error and residual planes 32 shots per
int32 word (``ops/gf2_packed.py``): syndromes are XOR gathers and the
checks ``packed_residual_stats``; only the decoders see unpacked planes.
``packed=False`` runs dense ``gf2_matmul`` syndromes and checks on the same
draws, bit for bit the same.  Batches fold through the megabatch driver
(``parallel/shots.py``), one host read per megabatch.  On the card a run
replays a captured megabatch (cached per simulator, rounds and shape), in
which the decoders' tier choices (``decode_device``: the two-phase
straggler count, the OSD tier) are conditional nodes, so it makes no other
host read; eagerly (the CPU) each tier choice reads the host once.

The errors are drawn from ``torch.Generator`` streams, not ``jax.random``,
so the JAX engine's failures are matched within binomial error; the
pipeline itself is held exactly against the JAX engine's functions on
injected errors (``_stats_from_errors``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..decoders.bp_decoders import decode_device
from ..noise import (
    bit_flips,
    bit_flips_packed,
    depolarizing_xz,
    depolarizing_xz_packed,
)
from ..ops.gf2_packed import (
    pack_shots,
    packed_parity_apply,
    packed_residual_stats,
    unpack_shots,
)
from ..ops.linalg import ParityOp, gf2_matmul
from ..ops.prng import key_words, prng_key, split_key
from ..parallel.shots import (
    GeneratorInput,
    batch_generator,
)
from ..utils.device import resolve_device
from .common import (
    count_failures,
    decoder_key,
    dense_check_flags,
    megabatch_driver,
    select_failures,
    wer_per_cycle,
    wer_single_shot,
)

__all__ = ["CodeSimulator_Phenon"]


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


class PhenomEngine:
    """What the phenomenological engines share: the draws, syndromes,
    decodes, final perfect round and residual checks of a batch, the
    pipeline of its rounds, its megabatch driver, and ``run_batch`` /
    ``_single_run``.  A subclass gives ``_window(draw, data_x, data_z,
    batch_size)``: one noisy window from ``draw`` (one round, or
    ``num_rep`` sub-rounds decoded jointly), returning the new data carry
    and the window's corrections; it is also the step of
    ``sim/stream_spacetime.py``'s ``PhenomStreamDriver``.
    """

    def __init__(self, code=None, decoder1_x=None, decoder1_z=None,
                 decoder2_x=None, decoder2_z=None,
                 pauli_error_probs=(0.01, 0.01, 0.01), q=0,
                 eval_logical_type="Total", seed: int = 0,
                 batch_size: int = 1024, scan_chunk: int = 4,
                 packed: bool = True, device="cuda"):
        if eval_logical_type not in ("X", "Z", "Total"):
            raise ValueError(f"eval_logical_type must be X, Z or Total, "
                             f"got {eval_logical_type!r}")
        self.device = resolve_device(device)
        decoders = (decoder1_x, decoder1_z, decoder2_x, decoder2_z)
        for dec in decoders:
            if dec.device != self.device:
                raise ValueError(f"decoder on {dec.device}, simulator on "
                                 f"{self.device}")
        self.code = code
        self.decoder1_x, self.decoder1_z = decoder1_x, decoder1_z
        self.decoder2_x, self.decoder2_z = decoder2_x, decoder2_z
        self.hx_ext = np.hstack([code.hx, np.eye(code.hx.shape[0],
                                                  dtype=np.uint8)])
        self.hz_ext = np.hstack([code.hz, np.eye(code.hz.shape[0],
                                                  dtype=np.uint8)])
        self.N = code.N
        self.K = code.K
        self.channel_probs = list(pauli_error_probs)
        self.synd_prob = q
        self.eval_logical_type = eval_logical_type
        self.min_logical_weight = self.N
        self.batch_size = int(batch_size)
        self._scan_chunk = max(1, int(scan_chunk))
        self._packed = bool(packed)
        self._base_key = prng_key(seed)
        self._mx, self._mz = code.hx.shape[0], code.hz.shape[0]
        # failures and shots of the most recent run
        self.last_failures = 0
        self.last_shots = 0
        self.last_megabatches = 0
        self.last_host_reads = 0
        self.last_graph = None  # the captured megabatch's cost, on the card
        self._drivers = {}
        dev = self.device
        # sparse adjacency of [H | I] (row weight rw(H) + 1) and of H for
        # the packed syndromes and checks; (n, m) transposes for the dense
        # path and the logical checks
        self._par = {name: (op.nbr, op.mask) for name, op in (
            ("hx_ext", ParityOp(self.hx_ext, dev)),
            ("hz_ext", ParityOp(self.hz_ext, dev)),
            ("hx", ParityOp(code.hx, dev)), ("hz", ParityOp(code.hz, dev)))}
        self._t = {name: _tensor(np.asarray(h).T, dev) for name, h in (
            ("hx_ext", self.hx_ext), ("hz_ext", self.hz_ext),
            ("hx", code.hx), ("hz", code.hz), ("lx", code.lx),
            ("lz", code.lz))}

    # ------------------------------------------------------------------
    def _draws(self, generator, batch_size: int):
        """The draws of one batch, round by round: ``draw(final)`` gives
        (data X, data Z, X syndrome flips, Z syndrome flips) of a noisy
        round, (data X, data Z) of the final one; packed or unpacked as the
        engine runs, from the same uniforms either way."""
        shape = (batch_size, self.N)
        dep = depolarizing_xz_packed if self._packed else depolarizing_xz
        flips = bit_flips_packed if self._packed else bit_flips

        def draw(final: bool):
            ex, ez = dep(generator, shape, self.channel_probs)
            if final:
                return ex, ez
            # hz_ext acts on X errors (mz flips), hx_ext on Z errors
            sx = flips(generator, (batch_size, self._mz), self.synd_prob)
            sz = flips(generator, (batch_size, self._mx), self.synd_prob)
            return ex, ez, sx, sz
        return draw

    def _syndromes(self, cur_x, cur_z, hx: str, hz: str, batch_size: int):
        """(B, m) uint8 syndromes of the X errors against ``hz`` and the Z
        errors against ``hx`` (names in ``_par`` / ``_t``)."""
        if self._packed:
            return (unpack_shots(packed_parity_apply(*self._par[hz], cur_x),
                                 batch_size),
                    unpack_shots(packed_parity_apply(*self._par[hx], cur_z),
                                 batch_size))
        return gf2_matmul(cur_x, self._t[hz]), gf2_matmul(cur_z, self._t[hx])

    def _decode(self, dec_x, dec_z, synd_x, synd_z):
        """Both sectors' corrections (Z first, as the JAX engine), packed
        when the engine runs packed."""
        cz, _ = decode_device(dec_z.device_static, dec_z.device_state, synd_z)
        cx, _ = decode_device(dec_x.device_static, dec_x.device_state, synd_x)
        if self._packed:
            return pack_shots(cx), pack_shots(cz)
        return cx, cz

    def _zeros(self, batch_size: int):
        """A zero (X, Z) data carry, packed or unpacked."""
        if self._packed:
            shape, dtype = (-(-batch_size // 32), self.N), torch.int32
        else:
            shape, dtype = (batch_size, self.N), torch.uint8
        data_x = torch.zeros(shape, dtype=dtype, device=self.device)
        return data_x, torch.zeros_like(data_x)

    def _final_round(self, draw, data_x, data_z, batch_size: int):
        """The final perfect round on the carried data errors: fresh data
        errors, bare-H syndromes, decoder 2 -> the residuals (X, Z)."""
        ex, ez = draw(True)
        cur_x, cur_z = data_x ^ ex, data_z ^ ez
        synd_x, synd_z = self._syndromes(cur_x, cur_z, "hx", "hz", batch_size)
        dx, dz = self._decode(self.decoder2_x, self.decoder2_z, synd_x, synd_z)
        return cur_x ^ dx, cur_z ^ dz

    def _pipeline(self, draw, num_rounds: int, batch_size: int):
        """Every window of one batch from ``draw`` -> the final round's
        residuals (X, Z), packed or unpacked."""
        data_x, data_z = self._zeros(batch_size)
        for _ in range(max(int(num_rounds) - 1, 0)):
            (data_x, data_z), _ = self._window(draw, data_x, data_z,
                                               batch_size)
        return self._final_round(draw, data_x, data_z, batch_size)

    def _stats(self, res_x, res_z, batch_size: int):
        """(failure count, min logical weight) int32 device scalars."""
        if self._packed:
            return packed_residual_stats(
                res_x, res_z, self._par["hz"], self._par["hx"],
                self._t["lz"], self._t["lx"], self.eval_logical_type,
                batch_size, self.N, z_weight_excludes_stab=True)
        fail, min_w = self._flags(res_x, res_z, batch_size)
        return fail.sum(dtype=torch.int32), min_w

    def _flags(self, res_x, res_z, batch_size: int):
        """Per-shot failures (bool) and the min logical weight."""
        if self._packed:
            res_x = unpack_shots(res_x, batch_size)
            res_z = unpack_shots(res_z, batch_size)
        x_fail, z_fail, min_w = dense_check_flags(
            res_x, res_z, self._t["hz"], self._t["hx"], self._t["lz"],
            self._t["lx"], self.N, z_weight_excludes_stab=True)
        return select_failures(x_fail, z_fail, self.eval_logical_type), min_w

    def _batch_stats(self, generator, num_rounds: int):
        B = self.batch_size
        return self._stats(*self._pipeline(self._draws(generator, B),
                                           num_rounds, B), B)

    def _stats_given(self, draws, final, num_rounds: int):
        """The pipeline of ``num_rounds`` rounds on given errors: ``draws``
        a list of numpy (data X, data Z, X syndrome flips, Z syndrome flips)
        (B, ·) uint8 tuples in the order the pipeline draws them, ``final``
        the last round's (data X, data Z).  Returns int32 device scalars
        (failure count, min weight)."""
        planes = [[_tensor(np.asarray(a, np.uint8), self.device) for a in r]
                  for r in list(draws) + [final]]
        if self._packed:
            planes = [[pack_shots(a) for a in r] for r in planes]
        batch_size = np.asarray(final[0]).shape[0]
        it = iter(planes)
        return self._stats(*self._pipeline(lambda final: tuple(next(it)),
                                           num_rounds, batch_size),
                           batch_size)

    # ------------------------------------------------------------------
    def run_batch(self, key, num_rounds: int,
                  batch_size: int | None = None) -> np.ndarray:
        """One batch of ``num_rounds`` rounds drawn from ``key`` (batch 0
        of a run's stream with that key): per-shot failure flags (host bool
        array); updates ``min_logical_weight``."""
        bs = int(batch_size or self.batch_size)
        gen = batch_generator(key_words(key), 0, self.device)
        fail, min_w = self._flags(*self._pipeline(self._draws(gen, bs),
                                                  num_rounds, bs), bs)
        fail = fail.cpu().numpy()
        self.min_logical_weight = min(self.min_logical_weight, int(min_w))
        return fail

    def _single_run(self, num_rounds: int) -> int:
        """Reference-compatible single-shot entry."""
        self._base_key, sub = split_key(self._base_key)
        return int(self.run_batch(sub, num_rounds, 1)[0])

    def _count_failures(self, num_rounds: int, num_samples: int, key=None,
                        target_failures=None, progress=None):
        """(failure count, shots run) of ``num_samples`` shots of
        ``num_rounds`` rounds (``sim.common.count_failures``)."""
        return count_failures(self, num_samples, key, target_failures,
                              int(num_rounds), progress=progress)

    def _driver(self, chunk: int):
        """The megabatch driver of ``chunk`` batches per megabatch (its
        captured graphs, one per round count, with it)."""
        return megabatch_driver(self, chunk, self._program(),
                                self._batch_stats, GeneratorInput(self.device))

    def _program(self) -> tuple:
        """What a captured batch bakes in besides its chunk."""
        return (self.batch_size, tuple(self.channel_probs), self.synd_prob,
                self.eval_logical_type, self._packed,
                *(decoder_key(d) for d in (
                    self.decoder1_x, self.decoder1_z, self.decoder2_x,
                    self.decoder2_z)))


class CodeSimulator_Phenon(PhenomEngine):
    """Reference ``CodeSimulator_Phenon`` surface, batched on one device.

    Decoder 1 of each sector decodes against the extended matrix [H | I]
    (``hx_ext`` for Z errors, ``hz_ext`` for X errors), decoder 2 against
    the bare H.  ``q`` is the syndrome flip rate, ``seed`` makes the base
    key that each run splits, ``batch_size`` the shots per batch,
    ``scan_chunk`` the batches per megabatch.  All four decoders must live
    on ``device``.
    """

    def _window(self, draw, data_x, data_z, batch_size: int):
        """One noisy round: fresh data errors and syndrome flips, the [H | I]
        syndromes, decoder 1; the data part of the residual carried on.
        Returns the new (X, Z) carry and decoder 1's (X, Z) corrections."""
        n = self.N
        ex, ez, sx, sz = draw(False)
        cur_x = torch.cat([ex ^ data_x, sx], dim=1)
        cur_z = torch.cat([ez ^ data_z, sz], dim=1)
        synd_x, synd_z = self._syndromes(cur_x, cur_z, "hx_ext", "hz_ext",
                                         batch_size)
        dx, dz = self._decode(self.decoder1_x, self.decoder1_z, synd_x,
                              synd_z)
        return ((cur_x ^ dx)[:, :n], (cur_z ^ dz)[:, :n]), (dx, dz)

    def _stats_from_errors(self, rounds, final):
        """The pipeline on given errors: ``rounds`` a list of numpy (data X,
        data Z, X syndrome flips, Z syndrome flips) (B, ·) uint8 tuples, one
        per noisy round, ``final`` the last round's (data X, data Z).
        Returns int32 device scalars (failure count, min weight)."""
        return self._stats_given(rounds, final, len(rounds) + 1)

    def WordErrorRate(self, num_rounds: int, num_samples: int, key=None,
                      target_failures=None, progress=None):
        """Per-qubit-per-cycle WER and its error bar
        (``sim.common.wer_per_cycle``).  ``progress``: mid-cell resume, as
        the data engine's ``WordErrorRate``."""
        count, total = self._count_failures(num_rounds, num_samples, key,
                                            target_failures, progress)
        return wer_per_cycle(count, total, self.K, num_rounds)

    def WordErrorProbability(self, num_rounds: int, num_samples: int,
                             key=None):
        """End-of-run word error probability (``wer_single_shot``)."""
        count, total = self._count_failures(num_rounds, num_samples, key)
        return wer_single_shot(count, total, self.K)
