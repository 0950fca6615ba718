"""Circuit-level space-time Monte-Carlo engine (sliding-window decoding).

The reference ``CodeSimulator_Circuit_SpaceTime``
(``src/Simulators_SpaceTime.py:672-1077``) and the JAX package's engine of
that name (``sim/circuit_spacetime.py``), the flagship path of the
reference's SpaceTimeDecodingDemo: the main memory circuit holds
``num_rounds`` windows of ``num_rep`` measurement sub-rounds and a final
transversal readout; a one-window ``fault_circuit`` is built only to derive
the detector error model (``circuits/dem.py``), from which come the decoding
graphs (``h1`` / ``L1`` / ``channel_ps1`` for the windows, ``h2`` / ``L2`` /
``channel_ps2`` for the final layer) and the space-correction matrix
``h1_space_cor``, which feeds each window's correction forward into the next
window's first detector slice.

Per batch, on the device: the Pauli-frame sampler draws the detectors; the
window scan decodes each window with decoder 1 after XORing the carried
space correction into its first ``m`` detectors, and advances the (space
correction, logical correction) carry through ``h1_space_cor`` and ``L1``
(sparse parity gathers, ``ops/linalg.py``); decoder 2 decodes the final
detector slice corrected by the carried space correction; a shot fails on a
nonzero residual syndrome or a logical flip.  Batches fold through the
megabatch driver (``parallel/shots.py``): on the card a run replays one
captured megabatch, the window and final decodes' tier ladders conditional
nodes in it, one host read per megabatch.  ``_window_commit`` is also the
step of ``sim/stream_spacetime.py``'s ``CircuitStreamDriver``.

The detectors are drawn from ``torch.Generator`` streams, so the JAX
engine's failures are matched within binomial error; the decode is held
exactly against the JAX engine's functions on given detectors
(``_decode_given``).  As in the reference, the decoders may be assigned
after construction, once the decoding graphs exist.  The weight slot of the
megabatch fold stays N (the reference tracks no minimum logical weight in
circuit engines).

A run executes under the active resilience policy (site
``wer.circuit_st``).  A decoder 2 with a host OSD stage
(``BPOSD_Decoder(device_osd=False)``) takes the host-assisted loop
(``_count_host``): the same draws batch by batch, the OSD on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..circuits import (
    ColorationCircuit,
    ColorationCircuitHK,
    FrameSampler,
    GenCorrecHyperGraph,
    GenFaultHyperGraph,
    RandomCircuit,
    detector_error_model,
)
from ..decoders.bp_decoders import decode_device
from ..ops.linalg import ParityOp
from ..ops.prng import fold_in, key_words, prng_key, split_key
from ..parallel.shots import GeneratorInput, batch_generator, check_mesh
from ..utils import profiling
from ..utils.device import resolve_device
from .circuit import _swap_xz_inplace, build_memory_circuit
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
    st_window_count,
    wer_per_cycle,
    windowed_count,
)

__all__ = ["CodeSimulator_Circuit_SpaceTime"]


class CodeSimulator_Circuit_SpaceTime:
    """Reference ``CodeSimulator_Circuit_SpaceTime`` surface
    (``src/Simulators_SpaceTime.py:672-735``), plus ``seed``,
    ``batch_size``, ``scan_chunk`` (batches per megabatch) and ``device``,
    on which both decoders must live; ``mesh`` shards the shots as the
    circuit engine's does.

    ``decoder1_z`` decodes each window's ``num_rep * m`` detectors against
    ``circuit_graph["h1"]`` (a device BP decoder, ``ST_BP_Decoder_Circuit``),
    ``decoder2_z`` the final slice against ``h2``; either may be assigned
    after ``_generate_circuit_graph``.  ``eval_logical_type="X"`` swaps
    hx/hz and lx/lz on the *shared* code object, as the reference does, and
    takes the X decoders; ``pz`` is the notebook-era name of ``p``.
    """

    def __init__(self, code=None, decoder1_z=None, decoder1_x=None,
                 decoder2_z=None, decoder2_x=None, p=0, num_cycles=1,
                 num_rep=1, error_params=None, eval_logical_type="Z",
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
        self.num_rep = int(num_rep)
        self.num_rounds = st_window_count(self.num_cycles, self.num_rep)
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
        self.num_logicals = code.lx.shape[0]
        self.num_checks = code.hx.shape[0]
        self.circuit = None
        self.fault_circuit = None
        self.detector_sampler: FrameSampler | None = None
        self.circuit_graph: dict | None = None
        self.h1_space_cor: np.ndarray | None = None
        self._ops = None  # the graphs' parity gathers on the device
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
        """Main and one-window fault circuit
        (``src/Simulators_SpaceTime.py:737-941``)."""
        self.circuit = build_memory_circuit(
            self.eval_code, self.num_cycles, self.error_params,
            self.scheduling_X, self.scheduling_Z, spacetime=True,
            num_rep=self.num_rep, num_rounds=self.num_rounds)
        # one window whose final detectors also compare against the last
        # ancilla measurement (circuit_final_meas_f,
        # src/Simulators_SpaceTime.py:908-926)
        self.fault_circuit = build_memory_circuit(
            self.eval_code, self.num_rep + 1, self.error_params,
            self.scheduling_X, self.scheduling_Z, spacetime=True,
            num_rep=self.num_rep, num_rounds=1, final_ancilla_compare=True)
        self.detector_sampler = FrameSampler(self.circuit, device=self.device)

    def _generate_circuit_graph(self):
        """Detector error model -> decoding graphs
        (``src/Simulators_SpaceTime.py:943-967``)."""
        if self.fault_circuit is None:
            self._generate_circuit()
        dem_text = str(detector_error_model(self.fault_circuit,
                                            flatten_loops=True))
        H_list, L_list, ps_list = GenFaultHyperGraph(
            dem_text, num_rounds=self.num_rounds, num_rep=self.num_rep,
            num_logicals=self.num_logicals)
        if any(h.shape[1] == 0 for h in H_list):
            raise ValueError(
                "the circuit's detector error model has no fault mechanisms "
                "(all error probabilities are zero?): the space-time "
                "decoding graphs would be empty.  Build the graphs from a "
                "noisy circuit; to evaluate noiseless behavior, sample with "
                "a noiseless sampler instead "
                "(detector_sampler.without_noise()).")
        self.circuit_graph = {
            "h1": H_list[0], "L1": L_list[0], "channel_ps1": ps_list[0],
            "h2": H_list[-1], "L2": L_list[-1], "channel_ps2": ps_list[-1],
        }
        self.h1_space_cor = GenCorrecHyperGraph(
            dem_text, num_rounds=self.num_rounds, num_rep=self.num_rep,
            num_checks=self.num_checks, num_logicals=self.num_logicals)
        self._ops = None

    def _ensure_ready(self):
        if self.detector_sampler is None:
            self._generate_circuit()
        if self.circuit_graph is None:
            self._generate_circuit_graph()
        if self._ops is None:
            g = self.circuit_graph
            self._ops = {name: ParityOp(h, self.device) for name, h in (
                ("space", self.h1_space_cor), ("L1", g["L1"]),
                ("h2", g["h2"]), ("L2", g["L2"]))}
        for name, dec in (("decoder1_z", self.decoder1_z),
                          ("decoder2_z", self.decoder2_z)):
            if dec is None:
                raise ValueError(f"{name} is not set: assign it once the "
                                 f"decoding graphs exist")
            # the window decoder runs inside the window scan on the device
            # (src/Simulators_SpaceTime.py:994-1002), as the final one does
            if not hasattr(dec, "device_static"):
                raise TypeError(f"{name} must be a device decoder")
            if name == "decoder1_z" and needs_host(dec):
                raise ValueError(
                    "decoder1_z runs inside the window scan on the device: "
                    "a host OSD stage there has no path (use a BP decoder, "
                    "as the reference does)")
            if dec.device != self.device:
                raise ValueError(f"{name} on {dec.device}, simulator on "
                                 f"{self.device}")

    # ------------------------------------------------------------------
    def _window_commit(self, carry, syn_j):
        """One window's decode and overlap commit
        (``src/Simulators_SpaceTime.py:969-1006``): the carried space
        correction folded into the window's first detector slice, decoder
        1, and the window's correction pushed forward through
        ``h1_space_cor`` and ``L1``.  ``carry`` is (space correction (B,
        m), logical correction (B, num_logicals)) uint8; returns the new
        carry and the window's fault correction."""
        total_space, total_log = carry
        m = self.num_checks
        syn = torch.cat([syn_j[:, :m] ^ total_space, syn_j[:, m:]], dim=1)
        d1 = self.decoder1_z
        cor, _ = decode_device(d1.device_static, d1.device_state, syn)
        return (total_space ^ self._ops["space"](cor),
                total_log ^ self._ops["L1"](cor)), cor

    def _windows_decode(self, dets):
        """The window scan over sampled detectors, then the final decode:
        returns (logical correction, corrected final syndrome, final
        correction)."""
        return self._final_decode(*self._windows(dets))

    def _windows(self, dets):
        """The window scan over sampled detectors: its (space correction,
        logical correction) carry and the raw final detector slice."""
        B, m = dets.shape[0], self.num_checks
        hist = dets.reshape(B, self.num_cycles, m)
        windows = hist[:, :self.num_rounds * self.num_rep].reshape(
            B, self.num_rounds, self.num_rep * m)
        carry = (torch.zeros((B, m), dtype=torch.uint8, device=dets.device),
                 torch.zeros((B, self.num_logicals), dtype=torch.uint8,
                             device=dets.device))
        for j in range(self.num_rounds):
            carry, _ = self._window_commit(carry, windows[:, j])
        return carry, hist[:, -1]

    def _final_launch(self, carry, final_syn_raw):
        """Decoder 2's device half on the final detector slice corrected by
        the carried space correction: (logical correction, final syndrome,
        its pending decode, ``sim.common.launch_decode``)."""
        total_space, total_log = carry
        final_syn = final_syn_raw ^ total_space
        return total_log, final_syn, launch_decode(self.decoder2_z,
                                                   final_syn)

    def _final_decode(self, carry, final_syn_raw):
        """Decoder 2 on the final detector slice corrected by the carried
        space correction (its host OSD stage too, where it has one):
        (logical correction, final syndrome, final correction)."""
        total_log, final_syn, pending = self._final_launch(carry,
                                                           final_syn_raw)
        return total_log, final_syn, finish_decode(self.decoder2_z, pending)

    def _check(self, obs, total_log, final_syn, final_cor):
        """Per-shot failures (``src/Simulators_SpaceTime.py:1004-1017``): a
        nonzero residual syndrome or a logical flip left by the
        corrections."""
        total_log = total_log ^ self._ops["L2"](final_cor)
        residual_syn = final_syn ^ self._ops["h2"](final_cor)
        residual_log = obs ^ total_log
        return residual_syn.bool().any(dim=-1) | residual_log.bool().any(
            dim=-1)

    def _flags(self, dets, obs):
        return self._check(obs, *self._windows_decode(dets))

    def _decode_given(self, dets):
        """The window scan and final decode of given detectors (numpy or
        tensors): (logical correction, final syndrome, final correction)
        device tensors."""
        self._ensure_ready()
        return self._windows_decode(torch.from_numpy(
            np.array(dets, np.uint8)).to(self.device))

    def _batch_stats(self, generator):
        dets, obs = self.detector_sampler.sample_generator(generator,
                                                           self.batch_size)
        return (self._flags(dets, obs).sum(dtype=torch.int32),
                torch.full((), self.N, dtype=torch.int32, device=self.device))

    # ------------------------------------------------------------------
    def run_batch(self, key, batch_size: int | None = None) -> np.ndarray:
        """One batch drawn from ``key`` (batch 0 of a run's stream with that
        key): per-shot failure flags (host bool array)."""
        self._ensure_ready()
        bs = int(batch_size or self.batch_size)
        gen = batch_generator(key_words(key), 0, self.device)
        return self._flags(*self.detector_sampler.sample_generator(
            gen, bs)).cpu().numpy()

    def _single_run(self) -> int:
        """Reference-compatible single-shot entry."""
        self._base_key, sub = split_key(self._base_key)
        return int(self.run_batch(sub, 1)[0])

    def _wer(self, num_samples: int, key=None):
        """``(wer, wer_eb)`` per cycle of ``num_samples`` shots
        (``sim.common.count_failures``), recorded
        (``sim.common.record_engine_run``), under the active resilience
        policy behind the fault site ``wer.circuit_st``.  A decoder 2 with
        a host OSD stage runs the host-assisted loop (``_count_host``)."""
        self._ensure_ready()
        if key is None:
            self._base_key, key = split_key(self._base_key)

        def run():
            if needs_host(self.decoder2_z):
                count, total = self._count_host(num_samples, key)
            else:
                count, total = count_failures(self, num_samples, key)
            wer = wer_per_cycle(count, total, self.K, self.num_cycles)
            record_engine_run(self, "circuit_st", (self.decoder1_z, self.decoder2_z), count, total, wer[0])
            return wer

        return resilient_engine_run(run, site="wer.circuit_st")

    def _count_host(self, num_samples: int, key):
        """The host-assisted run (the JAX package's windowed path): batch
        ``j`` draws what the device path's batch ``j`` draws, its windows
        and decoder 2's BP run on the device, the OSD on the host
        (``sim.common.windowed_count``)."""
        batcher = ShotBatcher(num_samples, self.batch_size)
        seed, B = key_words(key), self.batch_size

        def launch(j):
            dets, obs = self.detector_sampler.sample_generator(
                batch_generator(seed, j, self.device), B)
            return (obs, *self._final_launch(*self._windows(dets)))

        def finish(pending):
            obs, total_log, final_syn, dec = pending
            return self._check(obs, total_log, final_syn,
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
        program = (self.batch_size, self.detector_sampler, self.num_cycles,
                   self.num_rep, *self._ops.values(),
                   *(decoder_key(d) for d in (self.decoder1_z,
                                              self.decoder2_z)))
        return megabatch_driver(self, chunk, program, self._batch_stats,
                                GeneratorInput(self.device))

    def WordErrorRate(self, num_samples: int, key=None):
        """Per-qubit-per-cycle WER and its error bar
        (``src/Simulators_SpaceTime.py:1031-1049``,
        ``sim.common.wer_per_cycle``)."""
        return self._wer(num_samples, key)

    def WordErrorRate_TargetFailure(self, target_failures: int,
                                    batch_size: int, max_batches: int,
                                    key=None):
        """Adaptive sampling (``src/Simulators_SpaceTime.py:1051-1077``):
        batches of ``batch_size`` drawn from ``fold_in(key, i)`` until
        ``target_failures`` failures accumulate or ``max_batches`` ran.
        Returns (wer, total samples)."""
        self._ensure_ready()
        if key is None:
            self._base_key, key = split_key(self._base_key)
        total_samples, total_failures = 0, 0
        with profiling.engine_scope("wer.circuit_st"):
            for i in range(int(max_batches)):
                fails = profiling.timed_dispatch(lambda i=i: self.run_batch(
                    fold_in(key, i), int(batch_size)))
                total_failures += int(fails.sum())
                total_samples += int(batch_size)
                if total_failures >= target_failures:
                    break
            self.last_failures, self.last_shots = total_failures, total_samples
            self.last_dispatches = total_samples // int(batch_size)
            wer, _ = wer_per_cycle(total_failures, total_samples, self.K,
                                   self.num_cycles)
            record_engine_run(self, "circuit_st",
                              (self.decoder1_z, self.decoder2_z),
                              total_failures, total_samples, wer)
        return wer, total_samples
