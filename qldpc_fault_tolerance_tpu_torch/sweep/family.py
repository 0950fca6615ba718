"""CodeFamily orchestration: (code x p) WER sweeps, thresholds, effective
distances (reference src/Simulators.py:746-963), over the port's engines.

Decoder wiring, probability scalings and p-grids follow the reference and
the JAX package's ``sweep/family.py`` exactly (data: depolarizing
p' = 3p/2 split evenly; phenl: p_data = p, p_synd = p, decoder 1 over the
extended [H|I] matrix; circuit: per-gate params scaled by p, decoder-1
priors from the analytic ``data_synd_noise_ratio`` heuristic).

Data and phenl grids run on the fused path by default (``fused="auto"``
or True, ``sweep/fused.py``), as the JAX package's do: every p of a code
in one program, one representative engine built a code and one graph
captured a bucket, each cell's counts its serial run's seed for seed.
``fused=False``, circuit grids and buckets that cannot fuse run the
serial loop, each (code, p) cell building its decoders and engine.

``mesh`` (a ``parallel.shots.ShotMesh``) shards every cell's shots over its
devices, on the fused path and in the serial loop, as the JAX package's
``mesh`` does; ``shard_across_processes`` gives each process of a
``torch.distributed`` group its round-robin share of the cells and merges
the grid (``parallel/grid.py``).
"""
from __future__ import annotations

import warnings

import numpy as np

from ..decoders import DecoderClass
from ..sim import (
    CodeSimulator_Circuit,
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from ..sim.common import release_graphs
from .fits import DistanceEst, SustainableThresholdEst, ThresholdEst_extrapolation

__all__ = ["CodeFamily"]

def _ext(h):
    return np.hstack([h, np.eye(h.shape[0], dtype=np.asarray(h).dtype)])


def _check_fused(fused) -> None:
    if fused not in (True, False, "auto"):
        raise ValueError(f"fused must be True, False or 'auto', got {fused!r}")


def run_engine(sim, run):
    """``run(sim)``, then ``sim``'s captured graphs released
    (``sim.common.release_graphs``): a grid builds an engine a cell, and
    the card would otherwise hold every finished cell's graph memory until
    the garbage collector ran."""
    try:
        return run(sim)
    finally:
        release_graphs(sim)


def code_label(code, ci: int) -> str:
    return code.name or f"code{ci}_N{code.N}K{code.K}"


def run_serial_cells(cells, cell_key_fn, run_fn, noise_label: str, *,
                     checkpoint, progress_every: int, store) -> None:
    """The serial per-cell loop of both families (the JAX package's
    ``EvalWER`` bodies): ``cells`` are ``(idx, ci, code, eval_p)``; a cell
    that ``checkpoint`` holds is skipped with its stored WER; otherwise
    ``run_fn(code, eval_p, progress)`` runs it under a ``CellProgress``
    (mid-cell resume; none with ``progress_every=0``), its WER and Wilson
    interval are logged, sent to telemetry, the sweep run and the
    checkpoint, and ``store(idx, wer)`` keeps it."""
    from ..utils import diagnostics, resilience, telemetry
    from ..utils.checkpoint import CellProgress
    from ..utils.observability import get_logger, log_record, stage_timer

    logger = get_logger()
    for idx, ci, code, eval_p in cells:
        cell_key = cell_key_fn(idx, ci, code, eval_p)
        if checkpoint is not None and (rec := checkpoint.get(cell_key)):
            store(idx, rec["wer"])
            diagnostics.record_cell(
                cell_key, rec["wer"],
                {k: rec[k] for k in diagnostics.CI_KEYS if k in rec})
            continue
        progress = (CellProgress(checkpoint, cell_key, every=progress_every)
                    if checkpoint is not None and progress_every else None)
        # the cell scope collects the engine run's (failures, shots), so
        # the record carries its Wilson interval (none for the circuit
        # model's 'Total', the sum of two runs)
        with stage_timer(f"cell:{noise_label}"), \
                diagnostics.cell_scope() as cell_stats:
            wer = resilience.run_cell(
                lambda: run_fn(code, eval_p, progress),  # noqa: B023
                label=f"cell:{noise_label}")
        ci_block = cell_stats.fields()
        log_record(logger, "cell_done", **cell_key, wer=float(wer),
                   **ci_block)
        telemetry.event("cell_done", **cell_key, wer=float(wer), **ci_block)
        telemetry.count("sweep.cells")
        diagnostics.record_cell(cell_key, float(wer), ci_block)
        if checkpoint is not None:
            checkpoint.put(cell_key, {"wer": float(wer), **ci_block})
        store(idx, float(wer))


def threshold_grid(est_threshold: float) -> np.ndarray:
    """EvalThreshold's p-grid: logspace(0.4 est, 0.8 est, 6)."""
    return 10 ** (np.linspace(np.log10(est_threshold * 0.4),
                              np.log10(est_threshold * 0.8), 6))


def distance_grid(est_threshold: float) -> np.ndarray:
    """EvalEffectiveDistances' p-grid: logspace(est/6, est/4, 5)."""
    return 10 ** (np.linspace(np.log10(est_threshold / 6),
                              np.log10(est_threshold / 4), 5))


class CodeFamily:
    """The reference class's constructor and methods, with the JAX
    package's ``batch_size`` / ``seed`` / ``mesh`` engine knobs and
    ``device`` (the engines' device, the card unless the caller asks for
    the CPU; with a ``mesh`` the runs go to its devices)."""

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
    def _data_sim(self, code, eval_p, eval_logical_type):
        """One data-noise cell's engine (src/Simulators.py:759-770)."""
        p = eval_p * 3 / 2
        decoder_x = self.decoder2_class.GetDecoder({"h": code.hz, "p_data": eval_p})
        decoder_z = self.decoder2_class.GetDecoder({"h": code.hx, "p_data": eval_p})
        return CodeSimulator_DataError(
            code=code, decoder_x=decoder_x, decoder_z=decoder_z,
            pauli_error_probs=[p / 3, p / 3, p / 3],
            eval_logical_type=eval_logical_type,
            batch_size=self.batch_size, seed=self.seed, device=self.device,
            mesh=self.mesh,
        )

    def _data_wer(self, code, eval_p, eval_logical_type, num_samples,
                  progress=None, target_failures=None):
        """src/Simulators.py:759-777."""
        return run_engine(
            self._data_sim(code, eval_p, eval_logical_type),
            lambda sim: sim.WordErrorRate(
                num_samples, progress=progress,
                target_failures=target_failures)[0])

    def _phenl_sim(self, code, eval_p, eval_logical_type):
        """One phenomenological cell's engine (src/Simulators.py:780-802)."""
        p = 3 / 2 * eval_p
        q = eval_p
        p_data = p * 2 / 3
        dec1_x = self.decoder1_class.GetDecoder(
            {"h": _ext(code.hz), "p_data": p_data, "p_syndrome": q})
        dec1_z = self.decoder1_class.GetDecoder(
            {"h": _ext(code.hx), "p_data": p_data, "p_syndrome": q})
        dec2_x = self.decoder2_class.GetDecoder({"h": code.hz, "p_data": p_data})
        dec2_z = self.decoder2_class.GetDecoder({"h": code.hx, "p_data": p_data})
        return CodeSimulator_Phenon(
            code=code, decoder1_x=dec1_x, decoder1_z=dec1_z,
            decoder2_x=dec2_x, decoder2_z=dec2_z,
            pauli_error_probs=[p / 3, p / 3, p / 3], q=q,
            eval_logical_type=eval_logical_type,
            batch_size=self.batch_size, seed=self.seed, device=self.device,
            mesh=self.mesh,
        )

    def _phenl_wer(self, code, eval_p, eval_logical_type, num_samples,
                   num_cycles, progress=None, target_failures=None):
        """src/Simulators.py:780-811."""
        return run_engine(
            self._phenl_sim(code, eval_p, eval_logical_type),
            lambda sim: sim.WordErrorRate(
                num_rounds=num_cycles, num_samples=num_samples,
                progress=progress, target_failures=target_failures)[0])

    # ------------------------------------------------------------------
    # fused bucket builders (sweep/fused.py): one representative engine a
    # bucket; the other cells give only their p-dependent decoder state
    # through the factories' GetDecoderState
    def _data_bucket_program(self, bucket, eval_logical_type, num_samples,
                             mesh=None):
        from .fused import build_data_bucket

        _, _, code, p0 = bucket[0]
        rep = self._data_sim(code, p0, eval_logical_type)
        return build_data_bucket(
            rep, bucket, self.decoder2_class,
            lambda p, sector: {"h": code.hz if sector == "x" else code.hx,
                               "p_data": p},
            eval_logical_type, num_samples, mesh=mesh)

    def _phenl_bucket_program(self, bucket, eval_logical_type, num_samples,
                              num_cycles, mesh=None):
        import torch

        from ..sim.common import (
            CELL_LEAVES,
            LTYPE_CODES,
            stack_from_overrides,
            states_share_but_llr,
        )

        _, _, code, p0 = bucket[0]
        rep = self._phenl_sim(code, p0, eval_logical_type)
        base = rep._cell_state()
        decs = ("decoder1_x", "decoder1_z", "decoder2_x", "decoder2_z")
        cells = {k: [base[k]] for k in decs}
        probs, qs = [base["probs"]], [base["q"]]
        statics = tuple(getattr(rep, k).device_static for k in decs)
        for _, _, _, eval_p in bucket[1:]:
            p = 3 / 2 * eval_p
            q = eval_p
            p_data = p * 2 / 3
            built = (
                self.decoder1_class.GetDecoderState(
                    {"h": _ext(code.hz), "p_data": p_data, "p_syndrome": q}),
                self.decoder1_class.GetDecoderState(
                    {"h": _ext(code.hx), "p_data": p_data, "p_syndrome": q}),
                self.decoder2_class.GetDecoderState(
                    {"h": code.hz, "p_data": p_data}),
                self.decoder2_class.GetDecoderState(
                    {"h": code.hx, "p_data": p_data}),
            )
            if tuple(s for s, _ in built) != statics:
                raise ValueError(
                    "decoder statics differ across the bucket's p-points")
            for k, (_, st) in zip(decs, built):
                cells[k].append(st)
            probs.append(torch.tensor([p / 3] * 3, dtype=torch.float32,
                                      device=rep.device))
            qs.append(torch.tensor(q, dtype=torch.float32,
                                   device=rep.device))
        tags = [float(eval_p) for _, _, _, eval_p in bucket]
        lt = [LTYPE_CODES[eval_logical_type]] * len(bucket)
        if all(states_share_but_llr(cells[k][0], d)
               for k in decs for d in cells[k]):
            over = {(k, leaf): torch.stack([d[leaf] for d in cells[k]])
                    for k in decs for leaf in CELL_LEAVES if leaf in base[k]}
            over[("probs",)] = torch.stack(probs)
            over[("q",)] = torch.stack(qs)
            return CodeSimulator_Phenon.fused_cells_program_states(
                rep, None, lt, tags, num_samples, num_cycles, mesh=mesh,
                prestacked=stack_from_overrides(base, over))
        states = [dict(zip(decs, ds), probs=pr, q=q) for pr, q, *ds in zip(
            probs, qs, *(cells[k] for k in decs))]
        return CodeSimulator_Phenon.fused_cells_program_states(
            rep, states, lt, tags, num_samples, num_cycles, mesh=mesh)

    def _circuit_wer(self, code, eval_p, eval_logical_type, num_samples,
                     num_cycles, data_synd_noise_ratio, circuit_type,
                     circuit_error_params):
        """src/Simulators.py:815-870."""
        p = eval_p
        error_params = {
            k: circuit_error_params[k] * p
            for k in ("p_i", "p_state_p", "p_m", "p_CX", "p_idling_gate")
        }
        p_data = data_synd_noise_ratio * p
        p_synd = 1 * p
        dec1_z = self.decoder1_class.GetDecoder(
            {"h": _ext(code.hx), "p_data": p_data, "p_syndrome": p_synd})
        dec1_x = self.decoder1_class.GetDecoder(
            {"h": _ext(code.hz), "p_data": p_data, "p_syndrome": p_synd})
        dec2_z = self.decoder2_class.GetDecoder({"h": code.hx, "p_data": eval_p})
        dec2_x = self.decoder2_class.GetDecoder({"h": code.hz, "p_data": eval_p})

        def run(logical_type):
            sim = CodeSimulator_Circuit(
                code=code, decoder1_z=dec1_z, decoder1_x=dec1_x,
                decoder2_z=dec2_z, decoder2_x=dec2_x, p=p,
                num_cycles=num_cycles, error_params=error_params,
                eval_logical_type=logical_type, circuit_type=circuit_type,
                rand_scheduling_seed=1, batch_size=self.batch_size,
                seed=self.seed, device=self.device,
                mesh=self.mesh,
            )
            sim._generate_circuit()
            return run_engine(
                sim, lambda s: s.WordErrorRate(num_samples=num_samples)[0])

        if eval_logical_type == "Total":
            # total ~ wer_x + wer_z from two runs (src/Simulators.py:843-861);
            # the second construction sees the code object X-swapped by the
            # first (reference quirk preserved by the engines)
            return run("Z") + run("X")
        return run(eval_logical_type)

    # ------------------------------------------------------------------
    def EvalWER(self, noise_model: str, eval_logical_type: str,
                eval_p_list: list, num_samples: int, num_cycles=1,
                data_synd_noise_ratio=1, circuit_type="coloration",
                circuit_error_params=None, if_plot=True, checkpoint=None,
                shard_across_processes: bool = False,
                progress_every: int = 1, fused: bool | str = "auto",
                target_failures=None, ledger=None):
        """(len(code_list), len(eval_p_list)) WER array
        (src/Simulators.py:752-908), the JAX package's contract:

        ``fused``: "auto" (the default) and True run data and phenl grids
        on the fused path (module docstring), bucket by bucket, a bucket
        that cannot fuse in the serial loop; False runs every cell in the
        serial loop.  The results are the same.
        ``target_failures``: per-cell early stop — a cell stops after the
        first megabatch whose failure count reaches it (the denominator is
        the shots actually run); the circuit model raises.
        ``checkpoint``: optional ``utils.checkpoint.SweepCheckpoint`` —
        finished (code, p) cells are persisted as they complete and skipped
        on rerun, and the data and phenl engines persist their cursor
        mid-cell, so a killed run resumes INSIDE the running cell, seed for
        seed what the unbroken run gives (``CellProgress``).
        ``progress_every``: persist the cursor every that-many megabatches
        (0: no mid-cell resume).
        ``shard_across_processes``: in a ``torch.distributed`` group each
        process runs its round-robin share of the cells (in the serial
        loop, as in the JAX package) and the grid merges across the
        processes (``parallel/grid.py``); at world size 1 it changes
        nothing.
        ``ledger``: the run ledger (``utils.diagnostics.RunLedger``): True
        = ``ledger/``, a path = that dir or .jsonl file, None = the
        ``QLDPC_LEDGER_DIR`` environment variable (unset: none).  With a
        ledger (or telemetry on) every cell record carries its Wilson
        interval, the grid is checked for a WER that falls with p beyond
        its intervals, and one JSONL record of the run is appended.  Host
        bookkeeping only: the WER is the same with it on or off.
        """
        assert noise_model in ["data", "phenl", "circuit"], (
            "noise_model should be one of [data, phenl, circuit]"
        )
        assert eval_logical_type in ["X", "Z", "Total"], (
            "eval_type should be one of [X, Y, Total]"
        )
        _check_fused(fused)
        from ..parallel.grid import merge_cell_results, process_cell_owner
        from ..utils import diagnostics

        if noise_model == "circuit" and eval_logical_type == "X":
            warnings.warn(
                "eval_logical_type='X' swaps hx<->hz in place on the shared "
                "code object (reference quirk, src/Simulators.py:390-402) and "
                "the swap persists after the run: every successive 'X' "
                "construction on the same code object — later p-points in "
                "this call, or later EvalWER calls — alternates between X- "
                "and Z-type logicals.  Use 'Total' (symmetric) for multi-cell "
                "sweeps.",
                stacklevel=2,
            )
        if target_failures is not None and noise_model == "circuit":
            raise ValueError(
                "target_failures is not supported for the circuit noise "
                "model (its engine has no megabatch early stop)")

        cells = [
            (i, ci, code, eval_p)
            for i, (ci, code, eval_p) in enumerate(
                (ci, code, eval_p)
                for ci, code in enumerate(self.code_list)
                for eval_p in eval_p_list
            )
        ]
        owned = (
            process_cell_owner(len(cells)) if shard_across_processes
            else np.ones(len(cells), dtype=bool)
        )

        def cell_key_fn(i, ci, code, eval_p):
            return {
                "code": code_label(code, ci),
                "noise": noise_model, "type": eval_logical_type,
                "p": float(eval_p), "cycles": int(num_cycles),
                "samples": int(num_samples),
            }

        def run_fn(code, eval_p, progress):
            if noise_model == "data":
                return self._data_wer(code, eval_p, eval_logical_type,
                                      num_samples, progress=progress,
                                      target_failures=target_failures)
            if noise_model == "phenl":
                return self._phenl_wer(code, eval_p, eval_logical_type,
                                       num_samples, num_cycles,
                                       progress=progress,
                                       target_failures=target_failures)
            return self._circuit_wer(code, eval_p, eval_logical_type,
                                     num_samples, num_cycles,
                                     data_synd_noise_ratio, circuit_type,
                                     circuit_error_params)

        # the grid's identity for the run ledger: the physics
        # configuration, not execution knobs
        grid_cfg = {
            "driver": "CodeFamily.EvalWER", "noise": noise_model,
            "type": eval_logical_type,
            "codes": [code_label(code, ci)
                      for ci, code in enumerate(self.code_list)],
            "p_list": [float(p) for p in eval_p_list],
            "cycles": int(num_cycles), "samples": int(num_samples),
            "batch": int(self.batch_size), "seed": int(self.seed),
        }
        values = np.full(len(cells), np.nan)
        with diagnostics.sweep_run(grid_cfg, ledger=ledger):
            serial = [c for c, mine in zip(cells, owned) if mine]
            # a grid across processes keeps the serial loop, as in the JAX
            # package
            if (fused is not False and noise_model in ("data", "phenl")
                    and not shard_across_processes):
                from .fused import eval_cells_fused

                if noise_model == "data":
                    def builder(bucket, mesh):
                        return self._data_bucket_program(
                            bucket, eval_logical_type, num_samples, mesh)
                else:
                    def builder(bucket, mesh):
                        return self._phenl_bucket_program(
                            bucket, eval_logical_type, num_samples,
                            num_cycles, mesh)
                results, serial = eval_cells_fused(
                    serial, builder, cell_key_fn, checkpoint=checkpoint,
                    progress_every=progress_every,
                    target_failures=target_failures, mesh=self.mesh)
                for i, wer in results.items():
                    values[i] = wer
            run_serial_cells(
                serial, cell_key_fn, run_fn, noise_model,
                checkpoint=checkpoint, progress_every=progress_every,
                store=lambda i, wer: values.__setitem__(i, wer))
            if shard_across_processes:
                values = merge_cell_results(values)
            eval_wer_array = values.reshape(len(self.code_list),
                                            len(eval_p_list))
        if if_plot:
            self._plot_wer(eval_p_list, eval_wer_array, num_cycles)
        return eval_wer_array

    def _plot_wer(self, eval_p_list, eval_wer_array, num_cycles):
        """3-panel log-log plot (src/Simulators.py:877-906); needs
        matplotlib."""
        try:
            import matplotlib.pyplot as plt
        except ImportError as e:
            raise ImportError("if_plot=True needs matplotlib, which is not "
                              "installed; pass if_plot=False") from e

        per_qubit = (1 - (1 - 2 * eval_wer_array) ** num_cycles) / 2
        logical = np.zeros(eval_wer_array.shape)
        for i, code in enumerate(self.code_list):
            logical[i, :] = 1 - (1 - per_qubit[i, :]) ** code.K

        fig, ax = plt.subplots(1, 3, figsize=(15, 3))
        for panel, data, label in (
            (ax[0], logical, "Logical error"),
            (ax[1], per_qubit, "Logical error per qubit"),
            (ax[2], eval_wer_array, "WER"),
        ):
            for row in data:
                panel.plot(eval_p_list, row, "D--")
            panel.set_xscale("log")
            panel.set_yscale("log")
            panel.set_xlabel(r"$p$")
            panel.set_ylabel(label)
        plt.show()

    def _cfg(self, driver: str, noise_model, eval_logical_type, **fields):
        return {"driver": f"CodeFamily.{driver}", "noise": noise_model,
                "type": eval_logical_type,
                "codes": [c.name or f"N{c.N}K{c.K}" for c in self.code_list],
                **fields}

    # ------------------------------------------------------------------
    def EvalThreshold(self, noise_model: str, eval_logical_type: str,
                      eval_method: str, est_threshold: float,
                      num_samples: int, num_cycles=1, data_synd_noise_ratio=1,
                      circuit_type="coloration", circuit_error_params=None,
                      if_plot=False, ledger=None, fused="auto"):
        """p-grid = logspace(0.4 est, 0.8 est, 6); extrapolation fit
        (src/Simulators.py:912-924).  ``ledger``: as in EvalWER — the
        sweep-run scope spans the grid AND the fit, so the threshold's
        ``fit_report`` (bootstrap CI on p_c included) lands in the same
        ledger record as the cells it was fit from.  ``fused``: EvalWER's
        (the grid is the same either way)."""
        assert eval_method in ["extrapolation"], (
            "eval_method should be one of [extrapolation]"
        )
        from ..utils import diagnostics

        eval_p_list = threshold_grid(est_threshold)
        cfg = self._cfg("EvalThreshold", noise_model, eval_logical_type,
                        p_list=[float(p) for p in eval_p_list],
                        cycles=int(num_cycles), samples=int(num_samples))
        with diagnostics.sweep_run(cfg, ledger=ledger):
            eval_wer_array = self.EvalWER(
                noise_model, eval_logical_type, eval_p_list, num_samples,
                num_cycles, data_synd_noise_ratio, circuit_type,
                circuit_error_params, if_plot=False, fused=fused,
            )
            return ThresholdEst_extrapolation(eval_p_list, eval_wer_array,
                                              if_plot)

    def EvalSustainableThreshold(self, noise_model: str, eval_logical_type: str,
                                 eval_method: str, est_threshold: float,
                                 num_samples_per_cycle: int,
                                 num_cycles_list: list,
                                 data_synd_noise_ratio=1,
                                 circuit_type="coloration",
                                 circuit_error_params=None, if_plot=False,
                                 ledger=None):
        """Fit p_sus over thresholds at increasing cycle counts
        (src/Simulators.py:927-948); one ledger record spans every cycle
        count's grid and fits."""
        from ..utils import diagnostics

        cfg = self._cfg("EvalSustainableThreshold", noise_model,
                        eval_logical_type, est_threshold=float(est_threshold),
                        cycles_list=[int(n) for n in num_cycles_list],
                        samples_per_cycle=int(num_samples_per_cycle))
        with diagnostics.sweep_run(cfg, ledger=ledger):
            thresholds = [
                self.EvalThreshold(
                    noise_model=noise_model,
                    eval_logical_type=eval_logical_type,
                    eval_method=eval_method, est_threshold=est_threshold,
                    num_samples=int(num_samples_per_cycle / n),
                    num_cycles=n,
                    data_synd_noise_ratio=data_synd_noise_ratio,
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
                               num_samples: int, num_cycles=1,
                               data_synd_noise_ratio=1,
                               circuit_type="coloration",
                               circuit_error_params=None, if_plot=False,
                               ledger=None):
        """p-grid = logspace(est/6, est/4, 5); per-code distance fits
        (src/Simulators.py:951-963, with ``circuit_error_params`` as the
        JAX package adds it); grid and fits share one ledger record."""
        assert eval_method in ["extrapolation"]
        from ..utils import diagnostics

        eval_p_list = distance_grid(est_threshold)
        cfg = self._cfg("EvalEffectiveDistances", noise_model,
                        eval_logical_type,
                        p_list=[float(p) for p in eval_p_list],
                        cycles=int(num_cycles), samples=int(num_samples))
        with diagnostics.sweep_run(cfg, ledger=ledger):
            eval_wer_array = self.EvalWER(
                noise_model, eval_logical_type, eval_p_list, num_samples,
                num_cycles, data_synd_noise_ratio, circuit_type,
                circuit_error_params, if_plot=False,
            )
            return DistanceEst(eval_p_list, eval_wer_array, if_plot)
