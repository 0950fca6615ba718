"""Code-capacity (data-noise) Monte-Carlo engine.

Per batch, on the device: depolarizing sample (packed 32 shots per int32
word), syndrome SpMV as an XOR gather on lane words, decode of both sectors
(BP, or BP + device OSD), then packed residual stabilizer/logical checks
reduced to a failure count and the minimum residual weight among logical
failures.  Only the BP stage works on unpacked planes: syndromes unpack at
its input and corrections pack at its output.

Batches fold through the megabatch driver (``parallel/shots.py``): the
count and min weight stay device tensors, read by the host once per run
(once per megabatch with ``target_failures``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..decoders.bp_decoders import decode_device
from ..noise import depolarizing_xz_packed
from ..ops.gf2_packed import (
    pack_shots,
    packed_parity_apply,
    packed_residual_stats,
    unpack_shots,
)
from ..ops.linalg import ParityOp
from ..parallel.shots import count_min_driver
from ..utils.device import resolve_device
from .common import ShotBatcher, wer_single_shot

__all__ = ["CodeSimulator_DataError"]


class CodeSimulator_DataError:
    """Reference ``CodeSimulator_DataError`` surface, batched on one device.

    ``seed`` seeds every run's generator stream, ``batch_size`` is the shots
    per batch, ``scan_chunk`` the batches per megabatch (one host read each
    when streaming).  Both decoders must live on ``device``.
    """

    def __init__(self, code=None, decoder_x=None, decoder_z=None,
                 pauli_error_probs=(0.01, 0.01, 0.01),
                 eval_logical_type="Total", seed: int = 0,
                 batch_size: int = 2048, scan_chunk: int = 8,
                 device="cuda"):
        if eval_logical_type not in ("X", "Z", "Total"):
            raise ValueError(f"eval_logical_type must be X, Z or Total, "
                             f"got {eval_logical_type!r}")
        self.device = resolve_device(device)
        for dec in (decoder_x, decoder_z):
            if dec.device != self.device:
                raise ValueError(f"decoder on {dec.device}, simulator on "
                                 f"{self.device}")
        self.code = code
        self.decoder_z, self.decoder_x = decoder_z, decoder_x
        self.N = code.N
        self.K = code.K
        self.channel_probs = list(pauli_error_probs)
        self.eval_logical_type = eval_logical_type
        self.min_logical_weight = self.N
        self.batch_size = int(batch_size)
        self._scan_chunk = max(1, int(scan_chunk))
        self._seed = int(seed)
        self._runs = 0  # WordErrorRate calls so far: each draws a new stream
        # failures and shots of the most recent WordErrorRate run
        self.last_failures = 0
        self.last_shots = 0
        self.last_megabatches = 0
        hx_par = ParityOp(code.hx, self.device)
        hz_par = ParityOp(code.hz, self.device)
        self._hx_par = (hx_par.nbr, hx_par.mask)
        self._hz_par = (hz_par.nbr, hz_par.mask)
        self._lx_t = torch.from_numpy(np.ascontiguousarray(code.lx.T)).to(self.device)
        self._lz_t = torch.from_numpy(np.ascontiguousarray(code.lz.T)).to(self.device)

    def _packed_stats(self, ex_p, ez_p):
        """One batch from packed (W, n) error planes -> (failure count,
        min logical weight) int32 device scalars."""
        B, n = self.batch_size, self.N
        synd_z = unpack_shots(packed_parity_apply(*self._hx_par, ez_p), B)
        synd_x = unpack_shots(packed_parity_apply(*self._hz_par, ex_p), B)
        dz, dx = self.decoder_z, self.decoder_x
        cor_z, _ = decode_device(dz.device_static, dz.device_state, synd_z)
        cor_x, _ = decode_device(dx.device_static, dx.device_state, synd_x)
        return packed_residual_stats(
            ex_p ^ pack_shots(cor_x), ez_p ^ pack_shots(cor_z),
            self._hz_par, self._hx_par, self._lz_t, self._lx_t,
            self.eval_logical_type, B, n)

    def _batch_stats(self, generator):
        ex_p, ez_p = depolarizing_xz_packed(
            generator, (self.batch_size, self.N), self.channel_probs)
        return self._packed_stats(ex_p, ez_p)

    def WordErrorRate(self, num_run: int, target_failures=None):
        """WER over ``num_run`` shots: ``(wer, error bar)``.

        ``target_failures`` stops the run after the first megabatch whose
        cumulative failure count reaches it; the denominator is the shots
        actually run."""
        seed = (self._seed, self._runs)
        self._runs += 1
        batcher = ShotBatcher(num_run, self.batch_size)
        chunk = min(batcher.num_batches, self._scan_chunk)
        n_batches = -(-batcher.num_batches // chunk) * chunk
        driver = count_min_driver(self._batch_stats, self.N, self.device,
                                  chunk)
        if target_failures is None:
            carry, done = driver.run(seed, n_batches)
            failures, min_w = torch.stack(carry).tolist()
        else:
            for carry, done in driver.stream(seed, n_batches):
                failures, min_w = torch.stack(carry).tolist()
                if failures >= int(target_failures):
                    break
        self.last_megabatches = driver.megabatches
        self.last_failures, self.last_shots = failures, done * self.batch_size
        self.min_logical_weight = min(self.min_logical_weight, min_w)
        return wer_single_shot(failures, self.last_shots, self.K)
