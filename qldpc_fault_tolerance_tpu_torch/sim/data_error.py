"""Code-capacity (data-noise) Monte-Carlo engine.

Per batch, on the device: depolarizing sample (packed 32 shots per int32
word), syndrome SpMV as an XOR gather on lane words, decode of both sectors
(BP, or BP + device OSD), then packed residual stabilizer/logical checks
reduced to a failure count and the minimum residual weight among logical
failures.  Only the BP stage works on unpacked planes: syndromes unpack at
its input and corrections pack at its output.

``fused_sampler`` selects the counter-PRNG engines (``ops/gf2_kernel.py``),
which draw the JAX package's fused engines' errors seed for seed:

  * ``True``: ``sample_syndrome`` writes only the packed syndromes, the
    decoders run, and ``residual_check_stats`` regenerates the errors from
    their counters for the checks;
  * ``"v2"``: ``fused_decode_stats`` runs the whole pipeline, min-sum decodes
    included, in one kernel, with plain min-sum ``BPDecoder``s: bf16
    messages for float decoders, int8 messages with one scale per tile for
    ``BPDecoder(quantize="int8")``, as the JAX package's v2 engine decodes.

Both draw the same errors for the same key, and each gives the JAX
package's engine of the same name its failures and minimum weight seed for
seed.  v2 and v1 differ: v1 runs the decoders' own programs (float32
min-sum with float decoders), v2 the JAX fused kernel's bf16 or int8 loop.
On the card a ``"v2"`` whose kernel cannot take the code and batch
(``gf2_kernel.fused_decode_feasible``) runs as ``True`` (the same counter
stream) from construction, counted in
``CodeSimulator_DataError.fused_fallbacks``, as the JAX package drops an
infeasible v2 to its v1 fused path on its TPU.

``packed=False`` (the default engine only) keeps the planes unpacked:
dense syndromes and checks on the same draws, bit for bit the same.

``WeightedWordErrorRate`` draws from a tilted channel and folds the
per-shot importance weights into the carry's weight moments (the
rare-event estimators, ``rare/``); at zero tilt its draws and counts are
``WordErrorRate``'s bit for bit.  ``fused_cells_program`` and
``weighted_cells_program`` run many same-shape cells (a sweep's p-points)
as one ``parallel.shots.CellFusedDriver`` program, each lane the serial
batch unit on its cell's gathered state, so each cell's counts are its
serial run's seed for seed.

``mesh`` (a ``parallel.shots.ShotMesh``) shards the shots over its
devices (``sim.common.mesh_batch_stats``), as the JAX engine's ``mesh``
does: each device runs ``batch_size`` shots a batch on its own replica of
the engine, the counts fold on the host.  A mesh takes no
``target_failures`` and no weighted run, as in the JAX package.

Batches fold through the megabatch driver (``parallel/shots.py``): the
count and min weight stay device tensors, read by the host once per
megabatch, double-buffered.  On the card every ``WordErrorRate`` path (the
default engine, the fused engines, every OSD method) replays a captured
megabatch, cached per simulator and shape, so a run makes no other host
read; ``run_batch`` returns per-shot flags and stays eager.

With telemetry on (``utils.telemetry.enable``), every path's batch unit
(dense, packed, fused v1 and v2, mesh, weighted, fused cells) also returns
the batch's device telemetry vector (``device_tele_vec`` of both sectors'
decode aux; in v2, B5's per-shot ``converged`` and ``iterations``), which
the carry sums and the run's one host read a megabatch brings back; each
run ends in ``sim.common.record_wer_run``.  Telemetry never changes a
count.

Every run executes under the active ``utils.resilience`` policy
(``sim.common.resilient_engine_run``, sites ``wer.data`` / ``wer.data_w``):
transient faults retry bit for bit, deterministic ones raise, and repeated
faults step the degradation ladder (``_degrade_once``); a fault that
outlives both raises.  Decoders with a host OSD stage are refused, as in
the JAX package.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..decoders.bp_decoders import FusedBPPair, decode_device
from ..noise import (
    depolarizing_xz,
    depolarizing_xz_packed,
    depolarizing_xz_tilted,
    depolarizing_xz_tilted_packed,
)
from ..ops import gf2_kernel
from ..ops.prng import key_words, prng_key, split_key
from ..ops.gf2_packed import (
    pack_shots,
    packed_parity_apply,
    packed_residual_flags,
    packed_residual_stats,
    unpack_shots,
)
from ..ops.linalg import ParityOp, gf2_matmul
from ..parallel.shots import (
    GeneratorInput,
    KeyInput,
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
    gather_lane_states,
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
    wer_single_shot,
    wer_single_shot_weighted,
)

__all__ = ["CodeSimulator_DataError", "fused_cells_program",
           "fused_cells_program_states", "weighted_cells_program"]


def _bp_loop_params(static):
    """(max_iter, ms_scaling_factor, quantize) off a plain min-sum BP
    decoder static: the fused decode runs the decode in its kernel, so it
    takes the decoder's loop parameters rather than its decode program."""
    if static[0] != "bp" or static[2] != "minimum_sum":
        raise ValueError(
            "fused_sampler='v2' runs min-sum BP inside the fused kernel; "
            f"decoder static {static[:3]} is not a plain min-sum BP program")
    _, max_iter, _method, msf, _two_phase, head_tag = static
    return int(max_iter), float(msf), (
        "int8" if head_tag == "v2_int8" else None)


class CodeSimulator_DataError:
    """Reference ``CodeSimulator_DataError`` surface, batched on one device.

    ``seed`` makes the base key, which each ``WordErrorRate`` call splits as
    the JAX engine does; ``batch_size`` is the shots per batch,
    ``scan_chunk`` the batches per megabatch (one host read each when
    streaming); ``fused_sampler`` is False, True or ``"v2"``, ``packed``
    whether the default engine packs its planes (module docstring).  Both
    decoders must live on ``device``; with a ``mesh`` the runs go to its
    devices, each holding a replica (module docstring).

    ``fuse_sectors`` (as in the JAX package) decodes ``run_batch``'s X and
    Z syndromes in one ``FusedBPPair`` decode when both decoders are
    compatible (``FusedBPPair.compatible``; on the card one launch of
    kernel 1's sector mode), with the same failures as the two separate
    decodes; otherwise it changes nothing and warns.
    """

    # v2 engines that ran as fused v1 because the card's fused kernel
    # could not take them
    fused_fallbacks = 0
    # the batch units return the device telemetry vector when telemetry is
    # on (sim.common.tele_on)
    _DEVICE_TELE = True

    def __init__(self, code=None, decoder_x=None, decoder_z=None,
                 pauli_error_probs=(0.01, 0.01, 0.01),
                 eval_logical_type="Total", seed: int = 0,
                 batch_size: int = 2048, scan_chunk: int = 8,
                 fused_sampler=False, packed: bool = True, device="cuda",
                 mesh=None, fuse_sectors: bool = False):
        if eval_logical_type not in ("X", "Z", "Total"):
            raise ValueError(f"eval_logical_type must be X, Z or Total, "
                             f"got {eval_logical_type!r}")
        if fused_sampler not in (False, True, "v2"):
            raise ValueError(f"fused_sampler must be False, True or 'v2', "
                             f"got {fused_sampler!r}")
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
        self._fused_sampler = fused_sampler
        self._packed = bool(packed)
        self._base_key = prng_key(seed)
        self._mesh = check_mesh(mesh)
        # failures and shots of the most recent WordErrorRate run
        self.last_failures = 0
        self.last_shots = 0
        self.last_megabatches = 0
        self.last_dispatches = 0  # megabatches launched, every device's
        self.last_host_reads = 0
        self.last_graph = None  # the captured megabatch's cost, on the card
        self._drivers = {}
        hx_par = ParityOp(code.hx, self.device)
        hz_par = ParityOp(code.hz, self.device)
        self._hx_par = (hx_par.nbr, hx_par.mask)
        self._hz_par = (hz_par.nbr, hz_par.mask)
        self._lx_t = torch.from_numpy(np.ascontiguousarray(code.lx.T)).to(self.device)
        self._lz_t = torch.from_numpy(np.ascontiguousarray(code.lz.T)).to(self.device)
        self._hx_t, self._hz_t = (
            torch.from_numpy(np.ascontiguousarray(h.T)).to(self.device)
            for h in (code.hx, code.hz))
        # the channel as a device tensor: the tilted sampler's target and a
        # fused bucket's per-cell leaf
        self._probs_t = torch.tensor(np.asarray(self.channel_probs,
                                                np.float32),
                                     device=self.device)
        self._tilts = {}  # tilt triple -> its device tensor
        self._ladder = None  # the degradation ladder, built at its first step
        self._fused = None
        if fuse_sectors and FusedBPPair.compatible(decoder_x, decoder_z):
            self._fused = FusedBPPair(decoder_x, decoder_z)
        elif fuse_sectors:
            warnings.warn(
                "fuse_sectors=True builds no FusedBPPair: the decoders are "
                "not two plain two-phase BPDecoders with equal settings "
                "and no BP head (on the card pass bp_kernel='xla'); X and "
                "Z decode separately", stacklevel=2)
        self._select_stats()

    def _select_stats(self) -> None:
        """``self._stats``, the batch unit of the engine the flags
        (``_fused_sampler``, ``_packed``) name, building the fused specs it
        needs."""
        code, fused_sampler = self.code, self._fused_sampler
        decoder_x, decoder_z = self.decoder_x, self.decoder_z
        self._stats = self._batch_stats if self._packed else self._dense_stats
        if fused_sampler == "v2":
            self._iters_x, msf_x, q_x = _bp_loop_params(decoder_x.device_static)
            self._iters_z, msf_z, q_z = _bp_loop_params(decoder_z.device_static)
            if msf_x != msf_z or q_x != q_z:
                raise ValueError(
                    "fused_sampler='v2' needs both sector decoders to share "
                    "ms_scaling_factor and quantize mode (got "
                    f"{msf_x}/{q_x} vs {msf_z}/{q_z})")
            self._msf, self._quantize = msf_x, q_x
            self._fspec2 = gf2_kernel.build_fused_decode_spec(
                code.hx, code.hz, code.lx, code.lz, self.channel_probs,
                decoder_x.llr0, decoder_z.llr0, self.device)
            self._stats = self._stats_fused_v2
            if self.device.type == "cuda" and not \
                    gf2_kernel.fused_decode_feasible(
                        self._fspec2, self.batch_size, quantize=q_x):
                CodeSimulator_DataError.fused_fallbacks += 1
                self._fused_sampler = fused_sampler = True
        if fused_sampler is True:
            if getattr(self, "_fspec", None) is None:
                self._fspec = gf2_kernel.build_fused_spec(
                    code.hx, code.hz, code.lx, code.lz, self.channel_probs,
                    self.device)
            self._stats = self._stats_fused

    def _set_packed(self, packed: bool) -> None:
        """The ladder's ``packed->dense`` rung (bit for bit the packed
        run)."""
        self._packed = bool(packed)
        self._select_stats()

    def _set_fused(self, fused_sampler) -> None:
        self._fused_sampler = fused_sampler
        self._select_stats()

    def _degrade_once(self):
        """One rung down the degradation ladder, the JAX package's rungs
        that stay on the card's kernels, in its order:
        ``fused_v2->fused_pallas`` (B5's decode -> the B3/B4 kernels and
        the BP kernels; v2 and v1 differ in BP's numerics, so within
        binomial error) and, on a packed engine, ``packed->dense`` (bit for
        bit).  JAX's ``fused_pallas->fused_xla``, ``fused->packed`` and
        ``device->cpu`` would run B3-B5's work in plain PyTorch or on the
        CPU; the port has no such rung (``engine_ladder_step``)."""
        rungs = []
        if self._fused_sampler == "v2":
            rungs.append(("fused_v2->fused_pallas",
                          lambda: self._set_fused(True)))
        return engine_ladder_step(self, rungs)

    def _reject_host_decoders(self) -> None:
        """The data engine decodes inside its captured batches: a decoder
        with a host OSD stage has no path here (as in the JAX package)."""
        if needs_host(self.decoder_x, self.decoder_z):
            raise ValueError(
                "host-OSD decoders (device_osd=False) have no data-engine "
                "path: BPOSD runs its OSD on the device inside the "
                "megabatch")

    def _packed_stats(self, ex_p, ez_p):
        """One batch from packed (W, n) error planes -> (failure count,
        min logical weight) int32 device scalars."""
        B, n = self.batch_size, self.N
        synd_z = unpack_shots(packed_parity_apply(*self._hx_par, ez_p), B)
        synd_x = unpack_shots(packed_parity_apply(*self._hz_par, ex_p), B)
        cor_x, cor_z = self._decode(synd_x, synd_z)
        return packed_residual_stats(
            ex_p ^ pack_shots(cor_x), ez_p ^ pack_shots(cor_z),
            self._hz_par, self._hx_par, self._lz_t, self._lx_t,
            self.eval_logical_type, B, n)

    def _decode(self, synd_x, synd_z):
        dz, dx = self.decoder_z, self.decoder_x
        cor_z, aux_z = decode_device(dz.device_static, dz.device_state, synd_z)
        cor_x, aux_x = decode_device(dx.device_static, dx.device_state, synd_x)
        telemetry.note_device_aux(dx.device_static, aux_x)
        telemetry.note_device_aux(dz.device_static, aux_z)
        return cor_x, cor_z

    def _batch_stats(self, generator):
        ex_p, ez_p = depolarizing_xz_packed(
            generator, (self.batch_size, self.N), self.channel_probs)
        return self._packed_stats(ex_p, ez_p)

    def _dense_flags(self, generator, batch_size: int, pair=None):
        """One unpacked batch: per-shot failures (bool) and the min logical
        weight (``packed=False``, ``run_batch``); ``pair`` (a
        ``FusedBPPair``) decodes both sectors at once."""
        ex, ez = depolarizing_xz(generator, (batch_size, self.N),
                                 self.channel_probs)
        decode = self._decode if pair is None else pair.decode_pair_device
        cor_x, cor_z = decode(gf2_matmul(ex, self._hz_t),
                              gf2_matmul(ez, self._hx_t))
        x_fail, z_fail, min_w = dense_check_flags(
            ex ^ cor_x, ez ^ cor_z, self._hz_t, self._hx_t, self._lz_t,
            self._lx_t, self.N)
        return select_failures(x_fail, z_fail, self.eval_logical_type), min_w

    def _dense_stats(self, generator):
        fail, min_w = self._dense_flags(generator, self.batch_size)
        return fail.sum(dim=0, dtype=torch.int32), min_w

    def _cell_state(self) -> dict:
        """What a fused bucket stacks of this cell: the channel and both
        decoders' states."""
        return {"probs": self._probs_t, "dx": self.decoder_x.device_state,
                "dz": self.decoder_z.device_state}

    def _lane(self, state):
        """This engine on a fused lane's gathered ``state``: its batch
        unit counts all three logical types."""
        return lane_view(
            self, channel_probs=state["probs"], _probs_t=state["probs"],
            eval_logical_type="ALL",
            decoder_x=LaneDecoder(self.decoder_x.device_static, state["dx"]),
            decoder_z=LaneDecoder(self.decoder_z.device_static, state["dz"]))

    def _lane_stats(self, generator):
        """The serial batch unit (packed or dense) of this engine."""
        if self._packed:
            return self._batch_stats(generator)
        return self._dense_stats(generator)

    def _weighted_batch(self, generator, tilt):
        """One batch from the channel tilted to ``tilt`` (a (3,) float32
        device tensor) -> ``weighted_unit``'s outputs, every logical
        type's."""
        B, n = self.batch_size, self.N
        if self._packed:
            ex_p, ez_p, logw = depolarizing_xz_tilted_packed(
                generator, (B, n), self._probs_t, tilt)
            synd_z = unpack_shots(packed_parity_apply(*self._hx_par, ez_p), B)
            synd_x = unpack_shots(packed_parity_apply(*self._hz_par, ex_p), B)
            cor_x, cor_z = self._decode(synd_x, synd_z)
            x_fail, z_fail, min_w = packed_residual_flags(
                ex_p ^ pack_shots(cor_x), ez_p ^ pack_shots(cor_z),
                self._hz_par, self._hx_par, self._lz_t, self._lx_t, B, n)
        else:
            ex, ez, logw = depolarizing_xz_tilted(generator, (B, n),
                                                  self._probs_t, tilt)
            cor_x, cor_z = self._decode(gf2_matmul(ex, self._hz_t),
                                        gf2_matmul(ez, self._hx_t))
            x_fail, z_fail, min_w = dense_check_flags(
                ex ^ cor_x, ez ^ cor_z, self._hz_t, self._hx_t, self._lz_t,
                self._lx_t, n)
        return weighted_unit(x_fail, z_fail, min_w, logw)

    def _weighted_stats(self, generator, tilt):
        """The serial weighted unit: ``(count, min_w, s1, s2, w1, w2)`` of
        this engine's logical type."""
        cnt, min_w, s1, s2, w1, w2 = self._weighted_batch(generator, tilt)
        i = LTYPE_CODES[self.eval_logical_type]
        return cnt[i], min_w, s1[i], s2[i], w1, w2

    def _tilt_tensor(self, tilt) -> torch.Tensor:
        """The device tensor of a tilt triple, one per triple (a captured
        run's graph is keyed on it)."""
        key = tuple(float(q) for q in tilt)
        t = self._tilts.get(key)
        if t is None:
            t = self._tilts[key] = torch.tensor(np.asarray(key, np.float32),
                                                device=self.device)
        return t

    def run_batch(self, key, batch_size: int | None = None) -> np.ndarray:
        """One batch drawn from ``key`` (batch 0 of a default-engine run's
        stream with that key), unpacked: per-shot failure flags (host bool
        array); updates ``min_logical_weight``.  With ``fuse_sectors`` and
        compatible decoders both sectors decode in one ``FusedBPPair``
        decode."""
        bs = int(batch_size or self.batch_size)
        gen = batch_generator(key_words(key), 0, self.device)
        fail, min_w = self._dense_flags(gen, bs, self._fused)
        fail = fail.cpu().numpy()
        self.min_logical_weight = min(self.min_logical_weight, int(min_w))
        return fail

    def _single_run(self) -> int:
        """Reference-compatible single-shot entry."""
        self._base_key, sub = split_key(self._base_key)
        return int(self.run_batch(sub, 1)[0])

    def _stats_fused(self, key):
        """Counter-PRNG batch: packed syndromes only, both decodes, then the
        residual checks with the errors regenerated from ``key``."""
        B = self.batch_size
        sxp, szp = gf2_kernel.sample_syndrome(self._fspec, key, B,
                                              emit_errors=False)
        cor_x, cor_z = self._decode(unpack_shots(sxp, B), unpack_shots(szp, B))
        return gf2_kernel.residual_check_stats(
            self._fspec, key, B, pack_shots(cor_x), pack_shots(cor_z),
            self.eval_logical_type)

    def _stats_fused_v2(self, key):
        """Whole-pipeline batch: one fused kernel from draws to checks; its
        per-shot ``converged`` / ``iterations`` of each sector feed the
        device telemetry vector."""
        cnt, min_w, aux_x, aux_z = gf2_kernel.fused_decode_stats(
            self._fspec2, key, self.batch_size,
            eval_type=self.eval_logical_type, max_iter_z=self._iters_z,
            max_iter_x=self._iters_x, ms_scaling_factor=self._msf,
            quantize=self._quantize)
        telemetry.note_device_aux(self.decoder_x.device_static, aux_x)
        telemetry.note_device_aux(self.decoder_z.device_static, aux_z)
        return cnt, min_w

    def WordErrorRate(self, num_run: int, key=None, target_failures=None,
                      progress=None):
        """WER over ``num_run`` shots: ``(wer, error bar)``.

        ``key`` (two 32-bit words) fixes the run's stream; without it the
        run splits the simulator's base key, as the JAX engine does.
        ``target_failures`` stops the run after the first megabatch whose
        cumulative failure count reaches it; the denominator is the shots
        actually run.  ``progress`` (a ``utils.checkpoint.CellProgress``)
        persists the run's cursor after every megabatch, and resumes a run
        killed mid-cell from it, seed for seed the unbroken run's result
        (``sim.common.resumable_stream``)."""
        self._reject_host_decoders()
        if key is None:
            self._base_key, key = split_key(self._base_key)

        return resilient_engine_run(
            lambda: self._wer_result(*count_failures(
                self, num_run, key, target_failures, progress=progress)),
            site="wer.data", degrade=self._degrade_once)

    def _record(self, failures, shots, wer, **kw) -> None:
        """``record_wer_run`` of one run of this engine."""
        record_engine_run(self, "data", (self.decoder_x, self.decoder_z),
                          failures, shots, wer, **kw)

    def _wer_result(self, failures: int, shots: int):
        """The WER of a run, recorded (``record_wer_run``)."""
        wer = wer_single_shot(failures, shots, self.K)
        self._record(failures, shots, wer[0])
        return wer

    def WeightedWordErrorRate(self, num_run: int, tilt_probs=None, key=None,
                              progress=None, target_rse=None):
        """Importance-sampled WER over ``num_run`` shots drawn from the
        TILTED channel ``tilt_probs`` (a ``[qx, qy, qz]`` triple, usually
        ``rare.tilt_channel``'s), the JAX package's contract: the per-shot
        log weights fold into the weight moments on the device, one host
        read a megabatch.  ``tilt_probs=None`` (or the channel's own) is
        the zero tilt: draws, failures and min weight are
        ``WordErrorRate``'s bit for bit.  ``progress`` persists the cursor
        with the moments; ``target_rse`` stops once the weighted relative
        standard error reaches it.  Returns ``(wer, wer_eb)``; the
        ``WeightedStats`` lands on ``self.last_weighted``."""
        refuse_mesh(self, "weighted estimation")
        if self._fused_sampler:
            raise ValueError(
                "the fused sampler has its own PRNG stream; weighted "
                "estimation covers the seed-comparable packed/dense paths")
        self._reject_host_decoders()
        if tilt_probs is None:
            tilt_probs = list(self.channel_probs)
        tilt = check_tilt_probs(tilt_probs, self.channel_probs)
        if key is None:
            self._base_key, key = split_key(self._base_key)

        def run():
            ws = self._weighted_run(num_run, tilt, key, progress, target_rse)
            wer = wer_single_shot_weighted(ws, self.K)
            self._record(ws.failures, ws.shots, wer[0], weighted=ws,
                         tilt=float(sum(tilt)))
            return wer

        return resilient_engine_run(run, site="wer.data_w",
                                    degrade=self._degrade_once)

    def _weighted_run(self, num_run, tilt, key, progress, target_rse):
        """One attempt of ``WeightedWordErrorRate``: its ``WeightedStats``,
        recorded on the engine."""
        batcher = ShotBatcher(num_run, self.batch_size)
        chunk = min(batcher.num_batches, self._scan_chunk)
        n_batches = -(-batcher.num_batches // chunk) * chunk
        extra = (self._tilt_tensor(tilt),)
        tele = tele_on(self)
        driver = weighted_driver(self, chunk, self._program(),
                                 self._weighted_stats,
                                 GeneratorInput(self.device), tele=tele)
        reads = driver.host_reads
        megabatches = driver.megabatches
        fp = run_signature("data-w", key, batch_size=self.batch_size,
                           chunk=chunk, n_batches=n_batches,
                           tilt=[round(q, 12) for q in tilt])
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
        self.last_host_reads = driver.host_reads - reads
        self.last_graph = driver.graph_stats
        self.last_failures, self.last_shots = ws.failures, ws.shots
        self.min_logical_weight = min(self.min_logical_weight, ws.min_w)
        self.last_weighted = ws
        return ws

    def degrade_mesh(self) -> None:
        """Replay this engine's mesh runs on one device from now on
        (``sim.common.degrade_mesh``)."""
        degrade_mesh(self)

    def _program(self) -> tuple:
        """What a captured batch bakes in besides its chunk."""
        return (self.batch_size, tuple(self.channel_probs),
                self.eval_logical_type, self._fused_sampler, self._packed,
                decoder_key(self.decoder_x), decoder_key(self.decoder_z))

    def _driver(self, chunk: int, tele: bool = False):
        """The megabatch driver of ``chunk`` batches per megabatch (its
        captured graph with it); ``tele`` adds the telemetry slot."""
        batch_input = (KeyInput if self._fused_sampler else
                       GeneratorInput)(self.device)
        return megabatch_driver(self, chunk, self._program(), self._stats,
                                batch_input, tele=tele)


# ---------------------------------------------------------------------------
# Cell-fused sweep execution: every p-point (and logical type) of a code in
# one CellFusedDriver program (sweep/fused.py drives it)
# ---------------------------------------------------------------------------
def _check_rep_fusable(rep) -> None:
    """Raise ValueError for an engine whose cells cannot share a fused
    program: the fused sampler (its counter stream has no per-lane
    generator), or a decoder without a device program."""
    if rep._fused_sampler:
        raise ValueError(
            "the fused sampler has its own PRNG stream; cell fusion only "
            "covers the seed-comparable packed/dense paths")
    for dec in (rep.decoder_x, rep.decoder_z):
        if not hasattr(dec, "device_static"):
            raise ValueError(
                "cell fusion needs decoders with a device program")


def _cell_key(sim) -> tuple:
    return (sim.batch_size, sim.N, sim.K, sim.decoder_x.device_static,
            sim.decoder_z.device_static, sim._packed, sim._fused_sampler,
            key_words(sim._base_key), sim.device)


def _check_bucket(sims) -> None:
    rep = sims[0]
    for s in sims[1:]:
        if _cell_key(s) != _cell_key(rep):
            raise ValueError(
                "cells differ in program structure (batch size, code shape, "
                "decoder statics, seed or device); split them into separate "
                "buckets")


def fused_cells_program_states(rep, cell_states, ltype_codes, cell_tags,
                               num_samples: int, mesh=None,
                               prestacked=None) -> FusedCellProgram:
    """One data bucket's fused program from its representative engine
    ``rep`` (cell 0, built) and the cells' states (``_cell_state``-shaped
    dicts: the light path takes the other cells' decoder states from
    ``GetDecoderState``), or ``prestacked`` (``stack_from_overrides``'s
    triple).  ``cell_tags`` name the cells in the resume fingerprint.  The
    key, batch layout and chunk are each cell's serial run's, so each
    cell's counts are its serial run's seed for seed."""
    _check_rep_fusable(rep)
    stacked, spec, axes = (prestacked if prestacked is not None
                           else stack_cell_states(cell_states))
    codes = [int(c) for c in ltype_codes]
    ltypes = torch.tensor(codes, dtype=torch.int64, device=rep.device)
    key, chunk, n_batches = bucket_layout(rep, num_samples, mesh)

    def unit(r, st, lt):
        def stats(generator, cell):
            view = r._lane(gather_lane_states(st, spec, axes, cell))
            cnt3, min_w = view._lane_stats(generator)
            return cnt3.index_select(0, lt.index_select(0, cell))[0], min_w
        return stats

    def rebuild():
        return bucket_driver(unit, rep, stacked, ltypes, chunk, mesh)

    K = rep.K
    return FusedCellProgram(
        driver=rebuild(), key=key_words(key), extras=(), n_batches=n_batches,
        chunk=chunk, batch_size=rep.batch_size, n_cells=len(codes),
        engine="data", rep=rep, rebuild=rebuild,
        wer_fn=lambda failures, shots: wer_single_shot(
            int(failures), int(shots), K),
        signature_fn=lambda: run_signature(
            "data-cells", key, batch_size=rep.batch_size, chunk=chunk,
            n_batches=n_batches, cells=tags_json(cell_tags), ltypes=codes),
        cell_tags=tuple(cell_tags))


def fused_cells_program(sims, num_samples: int, mesh=None):
    """A ``FusedCellProgram`` of same-shape data engines (one per (p,
    logical type) cell of a sweep bucket, one seed): every p-dependent
    leaf (the channel, the decoders' priors) stacked along a cell axis,
    the rest shared.  Raises ValueError when the bucket cannot fuse."""
    _check_bucket(sims)
    return fused_cells_program_states(
        sims[0], [s._cell_state() for s in sims],
        [LTYPE_CODES[s.eval_logical_type] for s in sims],
        [[float(p) for p in s.channel_probs] for s in sims], num_samples,
        mesh=mesh)


def weighted_cells_program(sims, tilts, num_samples: int, mesh=None):
    """A weighted ``FusedCellProgram``: one cell per (p, tilt) rung of a
    rare-event grid, the channel, priors and tilt stacked on the cell
    axis.  A cell's moments are its serial ``WeightedWordErrorRate``'s
    seed for seed; a cell tilted to its own channel runs the zero tilt."""
    _check_bucket(sims)
    rep = sims[0]
    _check_rep_fusable(rep)
    tilts = [check_tilt_probs(t, s.channel_probs)
             for s, t in zip(sims, tilts)]
    stacked, spec, axes = stack_cell_states([
        dict(s._cell_state(), tilt=s._tilt_tensor(t))
        for s, t in zip(sims, tilts)])
    codes = [LTYPE_CODES[s.eval_logical_type] for s in sims]
    ltypes = torch.tensor(codes, dtype=torch.int64, device=rep.device)
    key, chunk, n_batches = bucket_layout(rep, num_samples, mesh)

    def unit(r, st, lt):
        def stats(generator, cell):
            state = gather_lane_states(st, spec, axes, cell)
            cnt, min_w, s1, s2, w1, w2 = r._lane(state)._weighted_batch(
                generator, state["tilt"])
            t = lt.index_select(0, cell)
            return (cnt.index_select(0, t)[0], min_w,
                    s1.index_select(0, t)[0], s2.index_select(0, t)[0],
                    w1, w2)
        return stats

    def rebuild():
        return bucket_driver(unit, rep, stacked, ltypes, chunk, mesh,
                             weighted=True)

    cell_tags = [[float(p) for p in s.channel_probs] + [float(q) for q in t]
                 for s, t in zip(sims, tilts)]

    def direct_wer(failures, shots):
        raise ValueError(
            "a weighted fused program's raw counts have no WER meaning; "
            "drive it through rare.sweep.eval_weighted_cells")

    return FusedCellProgram(
        driver=rebuild(), key=key_words(key), extras=(), n_batches=n_batches,
        chunk=chunk, batch_size=rep.batch_size, n_cells=len(codes),
        engine="data", wer_fn=direct_wer, rep=rep, rebuild=rebuild,
        signature_fn=lambda: run_signature(
            "data-cells-w", key, batch_size=rep.batch_size, chunk=chunk,
            n_batches=n_batches, cells=tags_json(cell_tags), ltypes=codes),
        cell_tags=tuple(map(tuple, cell_tags)), weighted=True)


# the cell-fused sweep's entries on the engine, as in the JAX package
CodeSimulator_DataError.fused_cells_program = staticmethod(fused_cells_program)
CodeSimulator_DataError.fused_cells_program_states = staticmethod(
    fused_cells_program_states)
CodeSimulator_DataError.weighted_cells_program = staticmethod(
    weighted_cells_program)
