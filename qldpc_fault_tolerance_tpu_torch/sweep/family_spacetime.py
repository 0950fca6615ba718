"""CodeFamily_SpaceTime orchestration for the space-time decoding stack
(reference src/Simulators_SpaceTime.py:1152-1362), over the port's engines.

Returns ragged ``(eval_wer_list, eval_p_adapt_list)`` lists (per code), since
the adaptive p-grid pruning can evaluate different p-points per code.

The JAX package's fixes of the reference, kept (SURVEY §2.4):
  * the reference's phenl branch names a nonexistent ``CodeSimulator_SpaceTime``
    (latent NameError, src/Simulators_SpaceTime.py:1213); here it runs the
    actual ``CodeSimulator_Phenon_SpaceTime``;
  * the reference's ``EvalThreshold`` passes ``data_synd_noise_ratio`` into
    the ``num_rep`` positional slot of EvalWER
    (src/Simulators_SpaceTime.py:1318-1321); here ``num_rep`` is explicit.

The data branch runs on the fused path by default (``fused="auto"`` or
True, ``sweep/fused.py``), as the JAX package's does; the phenl and
circuit branches, and ``fused=False``, run every cell in the serial loop
(``sweep/family.py``).  A circuit cell rebuilds its detector error model
for each p, host work that dominates such a cell at hgp_34_n625.
"""
from __future__ import annotations

import numpy as np

from ..decoders import DecoderClass
from ..sim import (
    CodeSimulator_Circuit_SpaceTime,
    CodeSimulator_DataError,
    CodeSimulator_Phenon_SpaceTime,
)
from .family import (
    _check_fused,
    code_label,
    distance_grid,
    run_engine,
    run_serial_cells,
    threshold_grid,
)
from .fits import DistanceEst, SustainableThresholdEst, ThresholdEst_extrapolation

__all__ = ["CodeFamily_SpaceTime"]


class CodeFamily_SpaceTime:
    """The reference class's constructor and methods, with the JAX
    package's ``mesh`` (every engine shards its shots over it, as in
    ``sweep/family.py``) and ``device`` (the card unless the caller asks
    for the CPU)."""

    def __init__(self, code_list: list, decoder1_class: DecoderClass,
                 decoder2_class: DecoderClass, batch_size: int = 512,
                 seed: int = 0, mesh=None, *, device="cuda"):
        self.code_list = code_list
        self.decoder1_class = decoder1_class
        self.decoder2_class = decoder2_class
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.device = device
        self.mesh = mesh  # the shot mesh every engine shards over

    # ------------------------------------------------------------------
    def EvalWER(self, noise_model: str, eval_logical_type: str,
                eval_p_list: list, num_samples: int, num_cycles=1, num_rep=1,
                circuit_type="coloration", circuit_error_params=None,
                if_plot=True, if_adaptive=False, adaptive_params=None,
                checkpoint=None, shard_across_processes: bool = False,
                progress_every: int = 1, fused: bool | str = "auto",
                ledger=None):
        """(ragged) per-code WER/p lists
        (src/Simulators_SpaceTime.py:1158-1307).

        ``if_adaptive`` (circuit only): a code keeps the p of
        ``eval_p_list`` where ``adaptive_params["WEREst"](code.N, p) >=
        adaptive_params["min_wer"]``.  ``checkpoint``: finished cells are
        persisted and skipped on rerun; the data branch also persists its
        cursor every ``progress_every`` megabatches (0: none), so a killed
        run resumes inside the cell (``sweep/family.py``).  ``fused``,
        ``shard_across_processes`` and ``ledger``: as in
        ``CodeFamily.EvalWER``.  ``if_plot`` is accepted and draws
        nothing, as in the JAX package."""
        assert noise_model in ["data", "phenl", "circuit"], (
            "noise_model should be one of [data, phenl, circuit]"
        )
        assert eval_logical_type in ["X", "Z", "Total"], (
            "eval_type should be one of [X, Y, Total]"
        )
        _check_fused(fused)
        from ..parallel.grid import merge_cell_results, process_cell_owner
        from ..utils import diagnostics

        # deterministic cell enumeration (same on every process)
        per_code_p: list[list] = []
        for code in self.code_list:
            if noise_model == "circuit" and if_adaptive:
                WEREst = adaptive_params["WEREst"]
                min_wer = adaptive_params["min_wer"]
                per_code_p.append(
                    [p for p in eval_p_list if WEREst(code.N, p) >= min_wer])
            else:
                per_code_p.append(list(eval_p_list))
        cells = [
            (ci, p) for ci, p_list in enumerate(per_code_p) for p in p_list
        ]
        owned = (
            process_cell_owner(len(cells)) if shard_across_processes
            else np.ones(len(cells), dtype=bool)
        )

        def cell_key_fn(idx, ci, code, eval_p):
            return {
                "code": code_label(code, ci),
                "noise": f"st-{noise_model}", "type": eval_logical_type,
                "p": float(eval_p), "cycles": int(num_cycles),
                "rep": int(num_rep), "samples": int(num_samples),
            }

        def run_fn(code, eval_p, progress):
            if noise_model == "data":
                return self._data_wer(code, eval_p, eval_logical_type,
                                      num_samples, progress=progress)
            if noise_model == "phenl":
                return self._phenl_wer(code, eval_p, eval_logical_type,
                                       num_samples, num_cycles, num_rep)
            return self._circuit_wer(code, eval_p, eval_logical_type,
                                     num_samples, num_cycles, num_rep,
                                     circuit_type, circuit_error_params)

        grid_cfg = {
            "driver": "CodeFamily_SpaceTime.EvalWER", "noise": noise_model,
            "type": eval_logical_type,
            "codes": [code_label(c, ci)
                      for ci, c in enumerate(self.code_list)],
            "p_list": [[float(p) for p in p_list] for p_list in per_code_p],
            "cycles": int(num_cycles), "rep": int(num_rep),
            "samples": int(num_samples),
            "batch": int(self.batch_size), "seed": int(self.seed),
        }
        flat_wer = np.full(len(cells), np.nan)
        with diagnostics.sweep_run(grid_cfg, ledger=ledger):
            serial = [(idx, ci, self.code_list[ci], eval_p)
                      for idx, (ci, eval_p) in enumerate(cells) if owned[idx]]
            # the data branch (the only one on the megabatch data engine)
            # rides the fused planner; a grid across processes keeps the
            # serial loop
            if (fused is not False and noise_model == "data"
                    and not shard_across_processes):
                from .fused import eval_cells_fused

                results, serial = eval_cells_fused(
                    serial, lambda bucket, mesh: self._data_bucket_program(
                        bucket, eval_logical_type, num_samples, mesh),
                    cell_key_fn, checkpoint=checkpoint,
                    progress_every=progress_every, mesh=self.mesh)
                for idx, wer in results.items():
                    flat_wer[idx] = wer
            run_serial_cells(
                serial, cell_key_fn, run_fn, f"st-{noise_model}",
                checkpoint=checkpoint, progress_every=progress_every,
                store=lambda idx, wer: flat_wer.__setitem__(idx, wer))
        if shard_across_processes:
            flat_wer = merge_cell_results(flat_wer)

        eval_wer_list, eval_p_adapt_list, pos = [], [], 0
        for p_list in per_code_p:
            eval_p_adapt_list.append(np.array(p_list))
            eval_wer_list.append(flat_wer[pos: pos + len(p_list)])
            pos += len(p_list)
        return eval_wer_list, eval_p_adapt_list

    # ------------------------------------------------------------------
    def _data_sim(self, code, eval_p, eval_logical_type):
        """One data cell's engine (src/Simulators_SpaceTime.py:1165-1181) —
        the decoder params carry 'code_h'/'channel_probs' so circuit-style
        factory classes work on the data branch too."""
        p = eval_p * 3 / 2
        decoder_x = self.decoder2_class.GetDecoder({
            "code_h": code.hz, "h": code.hz, "p_data": eval_p,
            "channel_probs": eval_p * np.ones(code.N),
        })
        decoder_z = self.decoder2_class.GetDecoder({
            "code_h": code.hx, "h": code.hx, "p_data": eval_p,
            "channel_probs": eval_p * np.ones(code.N),
        })
        return CodeSimulator_DataError(
            code=code, decoder_x=decoder_x, decoder_z=decoder_z,
            pauli_error_probs=[p / 3, p / 3, p / 3],
            eval_logical_type=eval_logical_type,
            batch_size=self.batch_size, seed=self.seed, device=self.device,
            mesh=self.mesh,
        )

    def _data_bucket_program(self, bucket, eval_logical_type, num_samples,
                             mesh=None):
        """The fused data bucket (``sweep/fused.build_data_bucket``) with
        this family's decoder params."""
        from .fused import build_data_bucket

        _, _, code, p0 = bucket[0]
        rep = self._data_sim(code, p0, eval_logical_type)

        def params(p, sector):
            h = code.hz if sector == "x" else code.hx
            return {"code_h": h, "h": h, "p_data": p,
                    "channel_probs": p * np.ones(code.N)}

        return build_data_bucket(rep, bucket, self.decoder2_class, params,
                                 eval_logical_type, num_samples, mesh=mesh)

    def _data_wer(self, code, eval_p, eval_logical_type, num_samples,
                  progress=None):
        """src/Simulators_SpaceTime.py:1165-1186."""
        return run_engine(
            self._data_sim(code, eval_p, eval_logical_type),
            lambda sim: sim.WordErrorRate(num_samples, progress=progress)[0])

    def _phenl_wer(self, code, eval_p, eval_logical_type, num_samples,
                   num_cycles, num_rep):
        """src/Simulators_SpaceTime.py:1189-1217 (with the NameError fixed)."""
        p = 3 / 2 * eval_p
        q = eval_p
        p_data = p * 2 / 3
        dec1_x = self.decoder1_class.GetDecoder(
            {"h": code.hz, "p_data": p_data, "p_syndrome": q, "num_rep": num_rep})
        dec1_z = self.decoder1_class.GetDecoder(
            {"h": code.hx, "p_data": p_data, "p_syndrome": q, "num_rep": num_rep})
        dec2_x = self.decoder2_class.GetDecoder({"h": code.hz, "p_data": p_data})
        dec2_z = self.decoder2_class.GetDecoder({"h": code.hx, "p_data": p_data})
        sim = CodeSimulator_Phenon_SpaceTime(
            code=code, decoder1_x=dec1_x, decoder1_z=dec1_z,
            decoder2_x=dec2_x, decoder2_z=dec2_z,
            pauli_error_probs=[p / 3, p / 3, p / 3], q=q,
            eval_logical_type=eval_logical_type, num_rep=num_rep,
            batch_size=self.batch_size, seed=self.seed, device=self.device,
            mesh=self.mesh,
        )
        return run_engine(sim, lambda s: s.WordErrorRate(
            num_cycles=num_cycles, num_samples=num_samples)[0])

    def _circuit_wer(self, code, eval_p, eval_logical_type, num_samples,
                     num_cycles, num_rep, circuit_type, circuit_error_params):
        """src/Simulators_SpaceTime.py:1221-1262: simulator first, DEM-derived
        decoding graphs, then decoders through the factory classes."""
        p = eval_p
        error_params = {
            k: circuit_error_params[k] * p
            for k in ("p_i", "p_state_p", "p_m", "p_CX", "p_idling_gate")
        }
        sim = CodeSimulator_Circuit_SpaceTime(
            code=code, p=p, num_cycles=num_cycles, num_rep=num_rep,
            error_params=error_params, eval_logical_type=eval_logical_type,
            circuit_type=circuit_type, rand_scheduling_seed=1,
            batch_size=self.batch_size, seed=self.seed, device=self.device,
            mesh=self.mesh,
        )
        sim._generate_circuit()
        sim._generate_circuit_graph()
        g = sim.circuit_graph
        sim.decoder1_z = self.decoder1_class.GetDecoder({
            "code_h": code.hx, "h": g["h1"], "channel_probs": g["channel_ps1"],
        })
        sim.decoder2_z = self.decoder2_class.GetDecoder({
            "code_h": code.hx, "h": g["h2"], "channel_probs": g["channel_ps2"],
        })
        return run_engine(
            sim, lambda s: s.WordErrorRate(num_samples=num_samples)[0])

    def _cfg(self, driver: str, noise_model, eval_logical_type, **fields):
        return {"driver": f"CodeFamily_SpaceTime.{driver}",
                "noise": noise_model, "type": eval_logical_type,
                "codes": [c.name or f"N{c.N}K{c.K}" for c in self.code_list],
                **fields}

    # ------------------------------------------------------------------
    def EvalThreshold(self, noise_model: str, eval_logical_type: str,
                      eval_method: str, est_threshold: float,
                      num_samples: int, num_cycles=1, num_rep=1,
                      circuit_type="coloration", circuit_error_params=None,
                      if_plot=False, ledger=None):
        """src/Simulators_SpaceTime.py:1311-1323 (explicit num_rep); grid
        and threshold fit share one ledger record."""
        assert eval_method in ["extrapolation"]
        from ..utils import diagnostics

        eval_p_list = threshold_grid(est_threshold)
        cfg = self._cfg("EvalThreshold", noise_model, eval_logical_type,
                        p_list=[float(p) for p in eval_p_list],
                        cycles=int(num_cycles), rep=int(num_rep),
                        samples=int(num_samples))
        with diagnostics.sweep_run(cfg, ledger=ledger):
            wer_list, _ = self.EvalWER(
                noise_model, eval_logical_type, eval_p_list, num_samples,
                num_cycles, num_rep, circuit_type, circuit_error_params,
                if_plot=False,
            )
            return ThresholdEst_extrapolation(eval_p_list,
                                              np.array(wer_list), if_plot)

    def EvalSustainableThreshold(self, noise_model: str, eval_logical_type: str,
                                 eval_method: str, est_threshold: float,
                                 num_samples_per_cycle: int,
                                 num_cycles_list: list, num_rep=1,
                                 circuit_type="coloration",
                                 circuit_error_params=None, if_plot=False,
                                 ledger=None):
        """src/Simulators_SpaceTime.py:1326-1347; one ledger record spans
        every cycle count's grid and fits."""
        from ..utils import diagnostics

        cfg = self._cfg("EvalSustainableThreshold", noise_model,
                        eval_logical_type, est_threshold=float(est_threshold),
                        cycles_list=[int(n) for n in num_cycles_list],
                        rep=int(num_rep),
                        samples_per_cycle=int(num_samples_per_cycle))
        with diagnostics.sweep_run(cfg, ledger=ledger):
            thresholds = [
                self.EvalThreshold(
                    noise_model=noise_model,
                    eval_logical_type=eval_logical_type,
                    eval_method=eval_method, est_threshold=est_threshold,
                    num_samples=int(num_samples_per_cycle / n),
                    num_cycles=n, num_rep=num_rep,
                    circuit_type=circuit_type,
                    circuit_error_params=circuit_error_params,
                    if_plot=if_plot,
                )
                for n in num_cycles_list
            ]
            return SustainableThresholdEst(num_cycles_list, thresholds,
                                           if_plot=if_plot)

    def EvalEffectiveDistances(self, noise_model: str, eval_logical_type: str,
                               eval_method: str, est_threshold: float,
                               num_samples: int, num_cycles=1, num_rep=1,
                               circuit_type="coloration",
                               circuit_error_params=None, if_plot=False,
                               ledger=None):
        """src/Simulators_SpaceTime.py:1350-1362 (with
        ``circuit_error_params``); grid and distance fits share one ledger
        record."""
        assert eval_method in ["extrapolation"]
        from ..utils import diagnostics

        eval_p_list = distance_grid(est_threshold)
        cfg = self._cfg("EvalEffectiveDistances", noise_model,
                        eval_logical_type,
                        p_list=[float(p) for p in eval_p_list],
                        cycles=int(num_cycles), rep=int(num_rep),
                        samples=int(num_samples))
        with diagnostics.sweep_run(cfg, ledger=ledger):
            wer_list, _ = self.EvalWER(
                noise_model, eval_logical_type, eval_p_list, num_samples,
                num_cycles, num_rep, circuit_type, circuit_error_params,
                if_plot=False,
            )
            return DistanceEst(eval_p_list, np.array(wer_list), if_plot)
