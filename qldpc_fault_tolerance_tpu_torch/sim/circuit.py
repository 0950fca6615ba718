"""Circuit-level Monte-Carlo engine (plain, per-round decoding).

The reference ``CodeSimulator_Circuit`` (``src/Simulators.py:386-671``) and
the JAX package's engine of that name (``sim/circuit.py``): synthesize the
full stabilizer-extraction circuit (init layer, first measurement layer
with detectors on the X ancillas, repeated layers with difference
detectors, final transversal MX layer with reconstructed-syndrome detectors
and one OBSERVABLE per lx row), inject CX depolarizing noise with the
text-rewrite plugin, sample detectors with the Pauli-frame sampler
(``circuits/sampler.py``), and decode each round in turn with the
(correction, residual syndrome) carry; decoder 2 decodes the final
corrected syndrome.

Per batch everything runs on the device; batches fold through the
megabatch driver (``parallel/shots.py``), so on the card a run replays one
captured megabatch (the sampler's REPEAT iterations and every per-round
decode with its tier ladder inside it), one host read per megabatch.  The
reference tracks no minimum logical weight here (the decode lives in
detector space): the weight slot stays N.

A run executes under the active resilience policy (site ``wer.circuit``,
``sim.common.resilient_engine_run``).  A decoder 2 with a host OSD stage
(``BPOSD_Decoder(device_osd=False)``) takes the host-assisted loop
(``_count_host``, ``sim.common.windowed_count``): the same draws batch by
batch, the OSD on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..circuits import (
    AddCXError,
    Circuit,
    ColorationCircuit,
    ColorationCircuitHK,
    FrameSampler,
    RandomCircuit,
    target_rec,
)
from ..circuits.ir import fmt_float
from ..decoders.bp_decoders import decode_device
from ..ops.linalg import ParityOp, parity_apply
from ..ops.prng import key_words, prng_key, split_key
from ..parallel.shots import GeneratorInput, batch_generator, check_mesh
from ..utils.device import resolve_device
from .common import (
    ShotBatcher,
    count_failures,
    decoder_key,
    degrade_mesh,
    finish_decode,
    launch_decode,
    megabatch_driver,
    needs_host,
    record_engine_run,
    resilient_engine_run,
    wer_per_cycle,
    windowed_count,
)

__all__ = ["CodeSimulator_Circuit", "build_memory_circuit"]


def build_memory_circuit(code, num_cycles: int, error_params: dict,
                         scheduling_X, scheduling_Z,
                         spacetime: bool = False, num_rep: int = 1,
                         num_rounds: int = 1,
                         final_ancilla_compare: bool | None = None) -> Circuit:
    """Synthesize the X-basis memory-experiment circuit.

    ``spacetime=False`` reproduces the plain layout
    (src/Simulators.py:438-609): init + first-measurement layer +
    (num_cycles-2) repeated difference-detector layers + final MX layer whose
    detectors reconstruct the X syndrome from the data measurements XOR the
    last ancilla measurement.

    ``spacetime=True`` reproduces the space-time layout
    (src/Simulators_SpaceTime.py:737-941): init resets ancillas too, each of
    ``num_rounds`` windows holds ``num_rep`` measurement sub-rounds (first
    with raw detectors behind a SHIFT_COORDS marker, the rest with difference
    detectors).

    ``final_ancilla_compare`` controls whether the final MX detectors also
    XOR in the last ancilla measurement.  Defaults: True for the plain layout
    (src/Simulators.py:574-583), False for the space-time main circuit
    (src/Simulators_SpaceTime.py:889-899, the window boundary feed-forward
    accounts for it); the space-time *fault* circuit passes True explicitly
    (circuit_final_meas_f, src/Simulators_SpaceTime.py:908-920).
    """
    if final_ancilla_compare is None:
        final_ancilla_compare = not spacetime
    if not spacetime and num_cycles < 2:
        raise ValueError(
            f"num_cycles must be >= 2 (one initial measurement layer plus the "
            f"final readout layer); got {num_cycles}"
        )
    hx, hz, lx = code.hx, code.hz, code.lx
    n = hx.shape[1]
    n_z, n_x = hz.shape[0], hx.shape[0]
    data = list(range(n))
    z_anc = list(range(n, n + n_z))
    x_anc = list(range(n + n_z, n + n_z + n_x))
    p_i = error_params["p_i"]
    p_sp = error_params["p_state_p"]
    p_m = error_params["p_m"]

    def cx_layers(c: Circuit, scheduling, x_type: bool, idle_all: bool):
        """One CX sub-circuit per scheduling timestep.  X-type checks use
        ancilla→data CX, Z-type data→ancilla (src/Simulators.py:470-502).
        ``idle_all`` switches between the plain engine's idling-on-unchecked-
        data noise and the space-time engine's idling-on-all-qubits noise
        (src/Simulators_SpaceTime.py:772-806)."""
        anc = x_anc if x_type else z_anc
        for step in scheduling:
            if idle_all:
                c.append("DEPOLARIZE1", data + anc,
                         error_params["p_idling_gate"])
            idling = set(data)
            for j, q in step.items():
                if x_type:
                    c.append("CX", [anc[j], q])
                else:
                    c.append("CX", [q, anc[j]])
                idling.discard(q)
            if not idle_all:
                c.append("DEPOLARIZE1", sorted(idling), p_i)
            c.append("TICK")

    def meas_layer(c: Circuit, reset_x_anc: bool, reset_z_anc: bool):
        """One full stabilizer-measurement layer up to and including the MR
        (detectors are appended by the caller)."""
        if reset_x_anc:
            c.append("R", x_anc)
        c.append("H", x_anc)
        c.append("DEPOLARIZE1", x_anc, p_sp)
        c.append("DEPOLARIZE1", data, p_i)
        c.append("TICK")
        cx_layers(c, scheduling_X, x_type=True, idle_all=spacetime)
        if reset_z_anc:
            c.append("R", z_anc)
        c.append("DEPOLARIZE1", z_anc, p_sp)
        c.append("DEPOLARIZE1", data, p_i)
        c.append("TICK")
        cx_layers(c, scheduling_Z, x_type=False, idle_all=spacetime)
        c.append("H", x_anc)
        c.append("DEPOLARIZE1", x_anc, p_m)
        c.append("DEPOLARIZE1", data, p_i)
        c.append("MR", z_anc + x_anc)

    def raw_detectors(c: Circuit, coord: bool):
        for i in range(n_x):
            c.append("DETECTOR", [target_rec(-n_x + i)], (0,) if coord else None)

    def diff_detectors(c: Circuit, coord: bool):
        for i in range(n_x):
            c.append(
                "DETECTOR",
                [target_rec(-n_x + i), target_rec(-n_x + i - n_z - n_x)],
                (0,) if coord else None,
            )

    init = Circuit()
    init.append("RX", data)
    if spacetime:
        init.append("R", x_anc + z_anc)

    if spacetime:
        rep1 = Circuit()
        meas_layer(rep1, reset_x_anc=False, reset_z_anc=False)
        rep1.append("SHIFT_COORDS", [], (1,))
        raw_detectors(rep1, coord=True)
        rep1.append("TICK")
        rep2 = Circuit()
        meas_layer(rep2, reset_x_anc=False, reset_z_anc=False)
        diff_detectors(rep2, coord=True)
        rep2.append("TICK")
        window = rep1 + (num_rep - 1) * rep2
        body = num_rounds * window
    else:
        first = Circuit()
        meas_layer(first, reset_x_anc=True, reset_z_anc=True)
        raw_detectors(first, coord=False)
        first.append("TICK")
        rep = Circuit()
        meas_layer(rep, reset_x_anc=False, reset_z_anc=False)
        diff_detectors(rep, coord=False)
        rep.append("TICK")
        body = first + (num_cycles - 2) * rep

    final = Circuit()
    final.append("DEPOLARIZE1", data, p_m)
    final.append("MX", data)
    if spacetime:
        final.append("SHIFT_COORDS", [], (1,))
    for i in range(n_x):
        recs = [target_rec(-n + q) for q in np.flatnonzero(hx[i]).tolist()]
        if final_ancilla_compare:
            recs.append(target_rec(-n_x + i - n))
        final.append("DETECTOR", recs, (0,) if spacetime else None)
    for i in range(lx.shape[0]):
        final.append(
            "OBSERVABLE_INCLUDE",
            [target_rec(-n + q) for q in np.flatnonzero(lx[i]).tolist()],
            (i,),
        )

    circuit = init + body + final
    return AddCXError(circuit, f"DEPOLARIZE2({fmt_float(error_params['p_CX'])})")


def _swap_xz_inplace(code):
    """The reference swaps hx<->hz / lx<->lz on the *shared* code object when
    eval_logical_type='X' (src/Simulators.py:390-402) — calling twice
    un-swaps.  Preserved verbatim for observable-behavior parity."""
    code.hx, code.hz = code.hz, code.hx
    code.lx, code.lz = code.lz, code.lx


class CodeSimulator_Circuit:
    """Reference ``CodeSimulator_Circuit`` surface (``src/Simulators.py:
    386-435``), plus ``seed``, ``batch_size``, ``scan_chunk`` (batches per
    megabatch) and ``device``, on which both decoders must live; ``mesh``
    (a ``parallel.shots.ShotMesh``) shards the shots over its devices, a
    replica of the engine on each (``sim.common.mesh_batch_stats``).

    Decoder 1 decodes each noisy round's corrected syndrome against [H | I]
    (a BP decoder), decoder 2 the final one against H.  ``eval_logical_type
    ="X"`` swaps hx/hz and lx/lz on the *shared* code object, as the
    reference does (a second such construction un-swaps), and takes the X
    decoders; ``pz`` is the notebook-era name of ``p``.
    """

    def __init__(self, code=None, decoder1_z=None, decoder1_x=None,
                 decoder2_z=None, decoder2_x=None, p=0, num_cycles=1,
                 error_params=None, eval_logical_type="Z",
                 circuit_type="coloration", rand_scheduling_seed=0,
                 seed: int = 0, batch_size: int = 256, mesh=None, pz=None, *,
                 scan_chunk: int = 4, device="cuda"):
        if pz is not None:
            p = pz
        self.device = resolve_device(device)
        if eval_logical_type == "X":
            _swap_xz_inplace(code)
            decoder1_z = decoder1_x
            decoder2_z = decoder2_x
        for dec in (decoder1_z, decoder2_z):
            if dec.device != self.device:
                raise ValueError(f"decoder on {dec.device}, simulator on "
                                 f"{self.device}")
        self.eval_code = code
        self.hx_ext = np.hstack([code.hx, np.eye(code.hx.shape[0],
                                                  dtype=code.hx.dtype)])
        self.hz_ext = np.hstack([code.hz, np.eye(code.hz.shape[0],
                                                  dtype=code.hz.dtype)])
        self.decoder1_z = decoder1_z
        self.decoder2_z = decoder2_z
        self.N = code.N
        self.K = code.K
        self.pz = p
        self.synd_prob = p
        self.min_logical_weight = self.N
        self.num_cycles = int(num_cycles)
        self.error_params = error_params
        self.batch_size = int(batch_size)
        self._scan_chunk = max(1, int(scan_chunk))
        self._base_key = prng_key(seed)
        self._mesh = check_mesh(mesh)
        if circuit_type == "random":
            self.scheduling_X = RandomCircuit(code.hx)
            self.scheduling_Z = RandomCircuit(code.hz)
        elif circuit_type == "coloration":
            self.scheduling_X = ColorationCircuit(code.hx)
            self.scheduling_Z = ColorationCircuit(code.hz)
        elif circuit_type == "coloration_hk":
            # the reference's padded-graph Hopcroft-Karp coloring (networkx)
            self.scheduling_X = ColorationCircuitHK(code.hx)
            self.scheduling_Z = ColorationCircuitHK(code.hz)
        else:
            raise ValueError(f"unknown circuit_type {circuit_type!r}")
        self.circuit: Circuit | None = None
        self._sampler: FrameSampler | None = None
        self._m = code.hx.shape[0]
        hx_op, lx_op = ParityOp(code.hx, self.device), ParityOp(
            code.lx, self.device)
        self._hx = (hx_op.nbr, hx_op.mask)
        self._lx = (lx_op.nbr, lx_op.mask)
        # failures and shots of the most recent run
        self.last_failures = 0
        self.last_shots = 0
        self.last_megabatches = 0
        self.last_dispatches = 0  # megabatches launched, every device's
        self.last_host_reads = 0
        self.last_graph = None  # the captured megabatch's cost, on the card
        self._drivers = {}

    # ------------------------------------------------------------------
    def _generate_circuit(self):
        """src/Simulators.py:438-609."""
        self.circuit = build_memory_circuit(
            self.eval_code, self.num_cycles, self.error_params,
            self.scheduling_X, self.scheduling_Z, spacetime=False,
        )
        self._sampler = FrameSampler(self.circuit, device=self.device)

    def _ensure_circuit(self):
        if self._sampler is None:
            self._generate_circuit()

    def _decode_rounds(self, dets):
        """The per-round decode of sampled detectors (``src/Simulators.py:
        612-632``): each noisy round's syndrome, corrected by the residual
        of the corrections so far, decoded by decoder 1; the final one by
        decoder 2 (its host OSD stage too, where it has one).  Returns
        (correction, corrected final syndrome, final correction)."""
        correction, corrected_final, pending = self._launch_rounds(dets)
        return (correction, corrected_final,
                finish_decode(self.decoder2_z, pending))

    def _launch_rounds(self, dets):
        """``_decode_rounds``' device half: (correction, corrected final
        syndrome, decoder 2's pending decode,
        ``sim.common.launch_decode``)."""
        B, n = dets.shape[0], self.N
        hist = dets.reshape(B, self.num_cycles, self._m)
        d1, d2 = self.decoder1_z, self.decoder2_z
        correction = torch.zeros((B, n), dtype=torch.uint8, device=dets.device)
        residual = torch.zeros((B, self._m), dtype=torch.uint8,
                               device=dets.device)
        for j in range(self.num_cycles - 1):
            corrected = hist[:, j] ^ residual
            new_cor, _ = decode_device(d1.device_static, d1.device_state,
                                       corrected)
            data_cor = new_cor[:, :n]
            correction = correction ^ data_cor
            residual = corrected ^ parity_apply(*self._hx, data_cor)
        corrected_final = hist[:, -1] ^ residual
        return correction, corrected_final, launch_decode(d2,
                                                          corrected_final)

    def _flags(self, dets, obs):
        """Per-shot failures (``src/Simulators.py:634-641``): a nonzero
        residual syndrome or a logical flip left by the corrections."""
        return self._check(obs, *self._decode_rounds(dets))

    def _check(self, obs, correction, corrected_final, final_cor):
        residual_syn = corrected_final ^ parity_apply(*self._hx, final_cor)
        residual_log = obs ^ parity_apply(*self._lx, correction ^ final_cor)
        return residual_syn.bool().any(dim=-1) | residual_log.bool().any(
            dim=-1)

    def _count_given(self, dets, obs):
        """int32 device failure count of sampled detectors and
        observables (numpy or tensors)."""
        dets, obs = (torch.from_numpy(np.array(a, np.uint8)).to(self.device)
                     for a in (dets, obs))
        return self._flags(dets, obs).sum(dtype=torch.int32)

    def _batch_stats(self, generator):
        dets, obs = self._sampler.sample_generator(generator, self.batch_size)
        return (self._flags(dets, obs).sum(dtype=torch.int32),
                torch.full((), self.N, dtype=torch.int32, device=self.device))

    # ------------------------------------------------------------------
    def run_batch(self, key, batch_size: int | None = None) -> np.ndarray:
        """One batch drawn from ``key`` (batch 0 of a run's stream with that
        key): per-shot failure flags (host bool array)."""
        self._ensure_circuit()
        bs = int(batch_size or self.batch_size)
        gen = batch_generator(key_words(key), 0, self.device)
        return self._flags(*self._sampler.sample_generator(gen, bs)).cpu(
            ).numpy()

    def _single_run(self) -> int:
        """Reference-compatible single-shot entry."""
        self._base_key, sub = split_key(self._base_key)
        return int(self.run_batch(sub, 1)[0])

    def _wer(self, num_samples: int, key=None):
        """``(wer, wer_eb)`` per cycle of ``num_samples`` shots
        (``sim.common.count_failures``), recorded
        (``sim.common.record_engine_run``), under the active resilience
        policy behind the fault site ``wer.circuit``.  A decoder 2 with a
        host OSD stage runs the host-assisted loop (``_count_host``)."""
        self._ensure_circuit()
        if needs_host(self.decoder1_z):
            raise ValueError(
                "decoder1 runs inside the per-round decode on the device: a "
                "host OSD stage there has no path (use a BP decoder, as the "
                "reference does)")
        if key is None:
            self._base_key, key = split_key(self._base_key)

        def run():
            if needs_host(self.decoder2_z):
                count, total = self._count_host(num_samples, key)
            else:
                count, total = count_failures(self, num_samples, key)
            wer = wer_per_cycle(count, total, self.K, self.num_cycles)
            record_engine_run(self, "circuit", (self.decoder1_z, self.decoder2_z), count, total, wer[0])
            return wer

        return resilient_engine_run(run, site="wer.circuit")

    def _count_host(self, num_samples: int, key):
        """The host-assisted run (the JAX package's windowed path): batch
        ``j`` draws what the device path's batch ``j`` draws, its rounds
        and decoder 2's BP run on the device, the OSD on the host
        (``sim.common.windowed_count``)."""
        batcher = ShotBatcher(num_samples, self.batch_size)
        seed, B = key_words(key), self.batch_size

        def launch(j):
            dets, obs = self._sampler.sample_generator(
                batch_generator(seed, j, self.device), B)
            return (obs, *self._launch_rounds(dets))

        def finish(pending):
            obs, correction, corrected_final, dec = pending
            return self._check(obs, correction, corrected_final,
                               finish_decode(self.decoder2_z, dec)).cpu(
                                   ).numpy()

        count = windowed_count(launch, finish, range(batcher.num_batches))
        self.last_failures, self.last_shots = count, batcher.total
        self.last_dispatches = batcher.num_batches
        return count, batcher.total

    def degrade_mesh(self) -> None:
        """Replay this engine's mesh runs on one device from now on
        (``sim.common.degrade_mesh``)."""
        degrade_mesh(self)

    def _driver(self, chunk: int):
        """The megabatch driver of ``chunk`` batches per megabatch (its
        captured graph with it)."""
        program = (self.batch_size, self._sampler, self.num_cycles,
                   *(decoder_key(d) for d in (self.decoder1_z,
                                              self.decoder2_z)))
        return megabatch_driver(self, chunk, program, self._batch_stats,
                                GeneratorInput(self.device))

    def WordErrorRate(self, num_samples: int, key=None):
        """Per-qubit-per-cycle WER and its error bar (``src/Simulators.py:
        653-671``, ``sim.common.wer_per_cycle``)."""
        return self._wer(num_samples, key)
