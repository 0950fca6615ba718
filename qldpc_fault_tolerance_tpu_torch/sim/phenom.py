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

``mesh`` shards the shots over a ``parallel.shots.ShotMesh``'s devices, as
the data engine's does (``sim.common.mesh_batch_stats``); the phenom
space-time engine inherits it.

``CodeSimulator_Phenon.WeightedWordErrorRate`` draws every round's data
errors and syndrome flips from tilted rates and carries the per-shot log
weight through the rounds (zero tilt: ``WordErrorRate``'s draws and counts
bit for bit), and ``fused_cells_program`` runs a sweep bucket's cells as
one ``parallel.shots.CellFusedDriver`` program, as the data engine's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..decoders.bp_decoders import decode_device
from ..noise import (
    bit_flips,
    bit_flips_packed,
    bit_flips_tilted,
    bit_flips_tilted_packed,
    depolarizing_xz,
    depolarizing_xz_packed,
    depolarizing_xz_tilted,
    depolarizing_xz_tilted_packed,
)
from ..ops.gf2_packed import (
    pack_shots,
    packed_parity_apply,
    packed_residual_flags,
    packed_residual_stats,
    unpack_shots,
)
from ..ops.linalg import ParityOp, gf2_matmul
from ..ops.prng import key_words, prng_key, split_key
from ..parallel.shots import (
    GeneratorInput,
    batch_generator,
    check_mesh,
)
from ..utils import telemetry
from ..utils.device import resolve_device
from .common import (
    LTYPE_CODES,
    FusedCellProgram,
    LaneDecoder,
    ShotBatcher,
    WeightedStats,
    bucket_driver,
    bucket_layout,
    check_tilt_probs,
    count_failures,
    decoder_key,
    degrade_mesh,
    dense_check_flags,
    drive_weighted_run,
    engine_ladder_step,
    finish_decode,
    gather_lane_states,
    launch_decode,
    lane_view,
    megabatch_driver,
    needs_host,
    record_engine_run,
    refuse_mesh,
    resilient_engine_run,
    resumable_weighted_stream,
    run_signature,
    select_failures,
    stack_cell_states,
    tags_json,
    tele_on,
    weighted_driver,
    weighted_unit,
    wer_per_cycle,
    wer_per_cycle_weighted,
    wer_single_shot,
    windowed_count,
)

__all__ = ["CodeSimulator_Phenon", "fused_cells_program",
           "fused_cells_program_states"]

_DECODERS = ("decoder1_x", "decoder1_z", "decoder2_x", "decoder2_z")


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
                 packed: bool = True, device="cuda", mesh=None):
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
        self._mesh = check_mesh(mesh)
        self._mx, self._mz = code.hx.shape[0], code.hz.shape[0]
        # failures and shots of the most recent run
        self.last_failures = 0
        self.last_shots = 0
        self.last_megabatches = 0
        self.last_dispatches = 0  # megabatches launched, every device's
        self.last_host_reads = 0
        self.last_graph = None  # the captured megabatch's cost, on the card
        self._drivers = {}
        self._ladder = None  # the degradation ladder, built at its first step
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
        # the channel and the flip rate as device tensors: the tilted
        # samplers' targets and a fused bucket's per-cell leaves
        self._probs_t = _tensor(np.asarray(self.channel_probs, np.float32),
                                dev)
        self._q_t = torch.tensor(float(np.float32(q)), dtype=torch.float32,
                                 device=dev)
        self._tilts = {}  # (tilt triple, tilt_q) -> their device tensors

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

    def _decode(self, dec_x, dec_z, synd_x, synd_z, note: bool = False):
        """Both sectors' corrections (Z first, as the JAX engine), packed
        when the engine runs packed.  ``note``: the decodes' aux feed the
        device telemetry vector (the final round's decoder 2 only, as in
        the JAX package)."""
        cz, az = decode_device(dec_z.device_static, dec_z.device_state, synd_z)
        cx, ax = decode_device(dec_x.device_static, dec_x.device_state, synd_x)
        if note:
            telemetry.note_device_aux(dec_x.device_static, ax)
            telemetry.note_device_aux(dec_z.device_static, az)
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
        dx, dz = self._decode(self.decoder2_x, self.decoder2_z, synd_x, synd_z,
                              note=True)
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
        return fail.sum(dim=0, dtype=torch.int32), min_w

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

    # ------------------------------------------------------------------
    def _cell_state(self) -> dict:
        """What a fused bucket stacks of this cell: the channel, the flip
        rate and the four decoders' states."""
        return {"probs": self._probs_t, "q": self._q_t,
                **{name: getattr(self, name).device_state
                   for name in _DECODERS}}

    def _lane(self, state):
        """This engine on a fused lane's gathered ``state``: its batch
        unit counts all three logical types."""
        return lane_view(
            self, channel_probs=state["probs"], _probs_t=state["probs"],
            synd_prob=state["q"], _q_t=state["q"], eval_logical_type="ALL",
            **{name: LaneDecoder(getattr(self, name).device_static,
                                 state[name]) for name in _DECODERS})

    def _tilted_draws(self, generator, batch_size: int, tilt, tilt_q, logw):
        """``_draws`` from the tilted rates (device tensors), the same
        uniforms in the same order; each draw adds its per-shot log weight
        to ``logw[0]``."""
        shape = (batch_size, self.N)
        dep = (depolarizing_xz_tilted_packed if self._packed
               else depolarizing_xz_tilted)
        flips = bit_flips_tilted_packed if self._packed else bit_flips_tilted

        def draw(final: bool):
            ex, ez, lw = dep(generator, shape, self._probs_t, tilt)
            logw[0] = logw[0] + lw
            if final:
                return ex, ez
            sx, lwx = flips(generator, (batch_size, self._mz), self._q_t,
                            tilt_q)
            sz, lwz = flips(generator, (batch_size, self._mx), self._q_t,
                            tilt_q)
            logw[0] = logw[0] + lwx + lwz
            return ex, ez, sx, sz
        return draw

    def _weighted_batch(self, generator, num_rounds: int, tilt, tilt_q):
        """One tilted batch -> ``weighted_unit``'s outputs, every logical
        type's (the Z weight counted where its stabilizer check passed)."""
        B = self.batch_size
        logw = [torch.zeros(B, dtype=torch.float32, device=self.device)]
        res_x, res_z = self._pipeline(
            self._tilted_draws(generator, B, tilt, tilt_q, logw),
            num_rounds, B)
        if self._packed:
            x_fail, z_fail, min_w = packed_residual_flags(
                res_x, res_z, self._par["hz"], self._par["hx"],
                self._t["lz"], self._t["lx"], B, self.N,
                z_weight_excludes_stab=True)
        else:
            x_fail, z_fail, min_w = dense_check_flags(
                res_x, res_z, self._t["hz"], self._t["hx"], self._t["lz"],
                self._t["lx"], self.N, z_weight_excludes_stab=True)
        return weighted_unit(x_fail, z_fail, min_w, logw[0])

    def _weighted_stats(self, generator, num_rounds: int, tilt, tilt_q):
        cnt, min_w, s1, s2, w1, w2 = self._weighted_batch(
            generator, num_rounds, tilt, tilt_q)
        i = LTYPE_CODES[self.eval_logical_type]
        return cnt[i], min_w, s1[i], s2[i], w1, w2

    def _tilt_tensors(self, tilt, tilt_q):
        """The device tensors of a tilt, one pair per tilt (a captured
        run's graph is keyed on them)."""
        key = (tuple(float(q) for q in tilt), float(tilt_q))
        pair = self._tilts.get(key)
        if pair is None:
            pair = self._tilts[key] = (
                _tensor(np.asarray(key[0], np.float32), self.device),
                torch.tensor(key[1], dtype=torch.float32,
                             device=self.device))
        return pair

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

    def _count_failures(self, num_rounds: int, num_samples: int, wer_fn,
                        key=None, target_failures=None, progress=None,
                        site: str = "wer.phenl"):
        """``wer_fn(failure count, shots run)`` of ``num_samples`` shots of
        ``num_rounds`` rounds (``sim.common.count_failures``), recorded
        (``record_engine_run``, the engine named by ``site``), under the
        active resilience policy behind the fault site ``site``
        (``sim.common.resilient_engine_run``; the ladder is
        ``_degrade_once``).  A decoder 2 with a host OSD stage runs the
        host-assisted loop (``sim.common.windowed_count``)."""
        if key is None:
            self._base_key, key = split_key(self._base_key)

        def run():
            if needs_host(self.decoder2_x, self.decoder2_z):
                count, total = self._count_host(int(num_rounds), num_samples,
                                                key)
            else:
                count, total = count_failures(
                    self, num_samples, key, target_failures,
                    int(num_rounds), progress=progress)
            wer = wer_fn(count, total)
            record_engine_run(self, site.split(".", 1)[1],
                              [getattr(self, name) for name in _DECODERS],
                              count, total, wer[0])
            return wer

        return resilient_engine_run(run, site=site,
                                    degrade=self._degrade_once)

    def _set_packed(self, packed: bool) -> None:
        """The ladder's ``packed->dense`` rung (bit for bit the packed
        run)."""
        self._packed = bool(packed)

    def _degrade_once(self):
        """One rung down the degradation ladder: packed -> dense
        (``sim.common.engine_ladder_step``), the JAX engine's rung that
        stays on the card's kernels; past it a fault raises."""
        return engine_ladder_step(self)

    def _count_host(self, num_rounds: int, num_samples: int, key):
        """The host-assisted run (decoder 2 with a host OSD stage): batch
        ``j`` draws what the device path's batch ``j`` draws; its windows
        and decoder 2's BP run on the device, the OSD on the host
        (``windowed_count``).  No progress cursor and no early stop, as in
        the JAX package."""
        batcher = ShotBatcher(num_samples, self.batch_size)
        seed = key_words(key)
        B = self.batch_size

        def launch(j):
            draw = self._draws(batch_generator(seed, j, self.device), B)
            data_x, data_z = self._zeros(B)
            for _ in range(max(num_rounds - 1, 0)):
                (data_x, data_z), _ = self._window(draw, data_x, data_z, B)
            ex, ez = draw(True)
            cur_x, cur_z = data_x ^ ex, data_z ^ ez
            synd_x, synd_z = self._syndromes(cur_x, cur_z, "hx", "hz", B)
            return (cur_x, cur_z,
                    launch_decode(self.decoder2_x, synd_x),
                    launch_decode(self.decoder2_z, synd_z))

        def finish(pending):
            cur_x, cur_z, px, pz = pending
            dx = finish_decode(self.decoder2_x, px)
            dz = finish_decode(self.decoder2_z, pz)
            if self._packed:
                dx, dz = pack_shots(dx), pack_shots(dz)
            fail, min_w = self._flags(cur_x ^ dx, cur_z ^ dz, B)
            self.min_logical_weight = min(self.min_logical_weight,
                                          int(min_w))
            return fail.cpu().numpy()

        count = windowed_count(launch, finish, range(batcher.num_batches))
        self.last_failures, self.last_shots = count, batcher.total
        self.last_dispatches = batcher.num_batches
        return count, batcher.total

    def degrade_mesh(self) -> None:
        """Replay this engine's mesh runs on one device from now on
        (``sim.common.degrade_mesh``)."""
        degrade_mesh(self)

    def _driver(self, chunk: int, tele: bool = False):
        """The megabatch driver of ``chunk`` batches per megabatch (its
        captured graphs, one per round count, with it); ``tele`` adds the
        telemetry slot."""
        return megabatch_driver(self, chunk, self._program(),
                                self._batch_stats, GeneratorInput(self.device),
                                tele=tele)

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
    on ``device``; ``mesh`` shards the runs (module docstring).
    """

    # the batch units return the device telemetry vector (the final round's
    # decoder 2) when telemetry is on (sim.common.tele_on)
    _DEVICE_TELE = True

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
        self._reject_host_decoders()
        return self._count_failures(
            num_rounds, num_samples,
            lambda c, t: wer_per_cycle(c, t, self.K, num_rounds), key,
            target_failures, progress)

    def WordErrorProbability(self, num_rounds: int, num_samples: int,
                             key=None):
        """End-of-run word error probability (``wer_single_shot``)."""
        self._reject_host_decoders()
        return self._count_failures(
            num_rounds, num_samples,
            lambda c, t: wer_single_shot(c, t, self.K), key)

    def _reject_host_decoders(self) -> None:
        """The phenomenological engine decodes every round inside its
        captured batches: host-OSD decoders have no path here (as in the
        JAX package)."""
        if needs_host(*(getattr(self, name) for name in _DECODERS)):
            raise ValueError(
                "host-OSD decoders (device_osd=False) have no phenom-engine "
                "path: BPOSD runs its OSD on the device inside the "
                "megabatch")

    def WeightedWordErrorRate(self, num_rounds: int, num_samples: int,
                              tilt_probs=None, tilt_q=None, key=None,
                              progress=None, target_rse=None):
        """Importance-sampled per-qubit-per-cycle WER (the JAX package's
        contract): every round's data errors draw from ``tilt_probs`` and
        its syndrome flips from ``tilt_q``, the per-shot log weight carried
        through the rounds and folded into the weight moments on the
        device.  Zero tilt (both None, or the channel's own) gives
        ``WordErrorRate``'s draws and counts bit for bit; ``progress`` and
        ``target_rse`` as the data engine's.  Returns ``(wer, wer_eb)``
        (``wer_per_cycle_weighted``); the ``WeightedStats`` lands on
        ``self.last_weighted``."""
        refuse_mesh(self, "weighted estimation")
        if tilt_probs is None:
            tilt_probs = list(self.channel_probs)
        tilt = check_tilt_probs(tilt_probs, self.channel_probs)
        tilt_q = float(self.synd_prob if tilt_q is None else tilt_q)
        if not 0.0 <= tilt_q < 1.0 or (float(self.synd_prob) > 0
                                       and tilt_q == 0):
            raise ValueError(
                f"tilt_q must be a probability covering the syndrome "
                f"channel's support (synd_prob={float(self.synd_prob)}), "
                f"got {tilt_q}")
        self._reject_host_decoders()
        if key is None:
            self._base_key, key = split_key(self._base_key)
        def run():
            ws = self._weighted_run(num_rounds, num_samples, tilt, tilt_q,
                                    key, progress, target_rse)
            wer = wer_per_cycle_weighted(ws, self.K, num_rounds)
            record_engine_run(self, "phenl",
                              [getattr(self, name) for name in _DECODERS],
                              ws.failures, ws.shots, wer[0], weighted=ws,
                              tilt=float(sum(tilt)))
            return wer

        return resilient_engine_run(run, site="wer.phenl_w",
                                    degrade=self._degrade_once)

    def _weighted_run(self, num_rounds, num_samples, tilt, tilt_q, key,
                      progress, target_rse):
        """One attempt of ``WeightedWordErrorRate``: its ``WeightedStats``,
        recorded on the engine."""
        batcher = ShotBatcher(num_samples, self.batch_size)
        chunk = min(batcher.num_batches, self._scan_chunk)
        n_batches = -(-batcher.num_batches // chunk) * chunk
        extra = (int(num_rounds), *self._tilt_tensors(tilt, tilt_q))
        tele = tele_on(self)
        driver = weighted_driver(self, chunk, self._program(),
                                 self._weighted_stats,
                                 GeneratorInput(self.device), tele=tele)
        megabatches = driver.megabatches
        fp = run_signature("phenl-w", key, batch_size=self.batch_size,
                           chunk=chunk, n_batches=n_batches,
                           rounds=int(num_rounds),
                           tilt=[round(q, 12) for q in tilt],
                           tilt_q=round(tilt_q, 12))
        (carry0, start), stream = resumable_weighted_stream(
            driver, key, n_batches, extra, signature=fp, progress=progress,
            tele=tele)
        carry, done = drive_weighted_run(
            driver, key, n_batches, extra, batch_size=self.batch_size,
            total=batcher.total, carry0=carry0, start=start, stream=stream,
            target_rse=target_rse, progress=progress)
        if tele:
            telemetry.publish_device_tele(carry[6])
        self.last_dispatches = driver.megabatches - megabatches
        ws = WeightedStats.from_carry(carry, done * self.batch_size)
        self.last_failures, self.last_shots = ws.failures, ws.shots
        self.min_logical_weight = min(self.min_logical_weight, ws.min_w)
        self.last_weighted = ws
        return ws


# ---------------------------------------------------------------------------
# Cell-fused sweep execution (see sim/data_error.py; a phenom cell also
# stacks its flip rate and its decoder-1 priors over [H | I])
# ---------------------------------------------------------------------------
def _cell_key(sim) -> tuple:
    return (sim.batch_size, sim.N, sim.K, sim._packed,
            key_words(sim._base_key), sim.device,
            *(getattr(sim, name).device_static for name in _DECODERS))


def fused_cells_program_states(rep, cell_states, ltype_codes, cell_tags,
                               num_samples: int, num_rounds: int, mesh=None,
                               prestacked=None) -> FusedCellProgram:
    """One phenom bucket's fused program; the contract of
    ``sim/data_error.fused_cells_program_states``, the per-cell WER the
    serial ``WordErrorRate``'s cycle inversion over ``num_rounds``."""
    for name in _DECODERS:
        if not hasattr(getattr(rep, name), "device_static"):
            raise ValueError(
                "cell fusion needs decoders with a device program")
    stacked, spec, axes = (prestacked if prestacked is not None
                           else stack_cell_states(cell_states))
    codes = [int(c) for c in ltype_codes]
    ltypes = torch.tensor(codes, dtype=torch.int64, device=rep.device)
    key, chunk, n_batches = bucket_layout(rep, num_samples, mesh)

    def unit(r, st, lt):
        def stats(generator, cell, rounds):
            view = r._lane(gather_lane_states(st, spec, axes, cell))
            cnt3, min_w = view._batch_stats(generator, rounds)
            return cnt3.index_select(0, lt.index_select(0, cell))[0], min_w
        return stats

    def rebuild():
        return bucket_driver(unit, rep, stacked, ltypes, chunk, mesh)

    K = rep.K
    return FusedCellProgram(
        driver=rebuild(), key=key_words(key), extras=(int(num_rounds),),
        n_batches=n_batches, chunk=chunk, batch_size=rep.batch_size,
        n_cells=len(codes), engine="phenl", rep=rep, rebuild=rebuild,
        wer_fn=lambda failures, shots: wer_per_cycle(
            int(failures), int(shots), K, num_rounds),
        signature_fn=lambda: run_signature(
            "phenl-cells", key, batch_size=rep.batch_size, chunk=chunk,
            n_batches=n_batches, rounds=int(num_rounds),
            cells=tags_json(cell_tags), ltypes=codes),
        cell_tags=tuple(cell_tags))


def fused_cells_program(sims, num_samples: int, num_rounds: int, mesh=None):
    """A ``FusedCellProgram`` of same-shape phenomenological engines (one
    per sweep cell, one seed); raises ValueError when they cannot fuse."""
    rep = sims[0]
    for s in sims[1:]:
        if _cell_key(s) != _cell_key(rep):
            raise ValueError(
                "cells differ in program structure (batch size, code shape, "
                "decoder statics, seed or device); split them into separate "
                "buckets")
    return fused_cells_program_states(
        rep, [s._cell_state() for s in sims],
        [LTYPE_CODES[s.eval_logical_type] for s in sims],
        [[float(p) for p in s.channel_probs] + [float(s.synd_prob)]
         for s in sims], num_samples, num_rounds, mesh=mesh)


# the cell-fused sweep's entries on the engine, as in the JAX package
CodeSimulator_Phenon.fused_cells_program = staticmethod(fused_cells_program)
CodeSimulator_Phenon.fused_cells_program_states = staticmethod(
    fused_cells_program_states)
