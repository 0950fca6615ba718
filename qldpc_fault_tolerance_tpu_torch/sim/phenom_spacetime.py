"""Phenomenological space-time Monte-Carlo engine.

The reference ``CodeSimulator_Phenon_SpaceTime``
(``src/Simulators_SpaceTime.py:382-548``) and the JAX package's engine of
that name (``sim/phenom_spacetime.py``).  Per batch, on the device:

  * ``num_rounds - 1`` windows, each of ``num_rep`` sub-rounds: fresh data
    errors XORed onto the carried data errors, fresh syndrome flips, and the
    [H | I] syndromes of both, stacked into a (B, num_rep, m) history; then
    one joint decode of the window by the space-time decoder 1
    (``ST_BP_Decoder_syndrome``, Z sector first), whose corrections fold
    into the carry;
  * a final perfect round: fresh data errors, bare-H syndromes, decoder 2;
  * the residual checks, the Z residual's weight counted only where its
    stabilizer check passed (the reference's if/elif).

Preserved reference quirk: the Z detector history is the XOR of consecutive
syndrome slices, the X history is passed raw
(``src/Simulators_SpaceTime.py:471-479``).

The data carry and the checks run packed, 32 shots per int32 word
(``ops/gf2_packed.py``), bit for bit the results of the dense planes; only
the decoders see unpacked planes.  Batches fold through the megabatch
driver (``parallel/shots.py``): on the card a run replays one captured
megabatch, in which the window decodes' tier choices are conditional
nodes, one host read per megabatch.  The errors are drawn from
``torch.Generator`` streams, so the JAX engine's failures are matched within
binomial error; the pipeline is held exactly against the JAX engine's
functions on injected errors (``_stats_from_errors``).

A run executes under the active resilience policy (site ``wer.phenl_st``,
the phenom engine's ladder).  A decoder 2 with a host OSD stage
(``BPOSD_Decoder(device_osd=False)``) takes the host-assisted loop
(``PhenomEngine._count_host``): the same draws batch by batch, the OSD on
the host.
"""
from __future__ import annotations

import torch

from .common import st_round_counts, wer_per_cycle
from .phenom import PhenomEngine

__all__ = ["CodeSimulator_Phenon_SpaceTime"]


class CodeSimulator_Phenon_SpaceTime(PhenomEngine):
    """Reference ``CodeSimulator_Phenon_SpaceTime`` surface, batched on one
    device.

    Decoder 1 of each sector is a space-time window decoder over
    ``num_rep`` slices of the code's [H | I] (``ST_BP_Decoder_Class`` with
    ``num_rep``; ``decoder1_z`` on hx for Z errors, ``decoder1_x`` on hz),
    decoder 2 decodes the bare H.  ``q`` is the syndrome flip rate, ``seed``
    makes the base key that each run splits, ``batch_size`` the shots per
    batch, ``scan_chunk`` the batches per megabatch.  All four decoders must
    live on ``device``; ``mesh`` shards the runs over a
    ``parallel.shots.ShotMesh``, as the phenom engine's does.
    """

    def __init__(self, code=None, decoder1_x=None, decoder1_z=None,
                 decoder2_x=None, decoder2_z=None,
                 pauli_error_probs=(0.01, 0.01, 0.01), q=0,
                 eval_logical_type="Total", num_rep: int = 1, seed: int = 0,
                 batch_size: int = 512, scan_chunk: int = 4, device="cuda",
                 mesh=None):
        super().__init__(code=code, decoder1_x=decoder1_x,
                         decoder1_z=decoder1_z, decoder2_x=decoder2_x,
                         decoder2_z=decoder2_z,
                         pauli_error_probs=pauli_error_probs, q=q,
                         eval_logical_type=eval_logical_type, seed=seed,
                         batch_size=batch_size, scan_chunk=scan_chunk,
                         device=device, mesh=mesh)
        self.num_rep = int(num_rep)

    def _window(self, draw, data_x, data_z, batch_size: int):
        """One window: ``num_rep`` sub-rounds of fresh errors and flips
        stacked into (B, num_rep, m) detector histories, decoded jointly by
        decoder 1.  Returns the new (X, Z) carry and the folded (X, Z)
        corrections."""
        hist_x, hist_z = [], []
        for _ in range(self.num_rep):
            ex, ez, sx, sz = draw(False)
            data_x, data_z = data_x ^ ex, data_z ^ ez
            synd_x, synd_z = self._syndromes(
                torch.cat([data_x, sx], dim=1),
                torch.cat([data_z, sz], dim=1), "hx_ext", "hz_ext",
                batch_size)
            hist_x.append(synd_x)
            hist_z.append(synd_z)
        # (B, num_rep, m); Z differenced slice to slice, X raw
        det_z = torch.stack([hist_z[0]] + [b ^ a for a, b in zip(
            hist_z, hist_z[1:])], dim=1)
        det_x = torch.stack(hist_x, dim=1)
        cx, cz = self._decode(self.decoder1_x, self.decoder1_z, det_x, det_z)
        return (data_x ^ cx, data_z ^ cz), (cx, cz)

    def _stats_from_errors(self, sub_rounds, final):
        """The pipeline on given errors: ``sub_rounds`` a list of numpy
        (data X, data Z, X syndrome flips, Z syndrome flips) (B, ·) uint8
        tuples, ``num_rep`` per window, ``final`` the last round's (data X,
        data Z).  Returns int32 device scalars (failure count, min
        weight)."""
        windows, rem = divmod(len(sub_rounds), self.num_rep)
        if rem:
            raise ValueError(f"{len(sub_rounds)} sub-rounds do not fill "
                             f"windows of {self.num_rep}")
        return self._stats_given(sub_rounds, final, windows + 1)

    def _program(self) -> tuple:
        return (*super()._program(), self.num_rep)

    def WordErrorRate(self, num_cycles: int, num_samples: int, key=None):
        """Per-qubit-per-cycle WER and its error bar: ``num_cycles`` are
        grouped into windows of ``num_rep`` (``st_round_counts``) and the
        rate is normalised by the cycles those windows realize."""
        num_rounds, total_num_cycles = st_round_counts(num_cycles,
                                                       self.num_rep)
        return self._count_failures(
            num_rounds, num_samples,
            lambda c, t: wer_per_cycle(c, t, self.K, total_num_cycles), key,
            site="wer.phenl_st")
