"""The port against the JAX package, parameter by parameter.

For every function, class and method pair that
``tests/test_torch_api_parity.py`` makes (the same JAX name in a module the
two packages share), the port takes each JAX parameter under JAX's name,
and a JAX caller's i-th positional argument lands in the parameter of the
same name.  The port's own parameters (``device``, ``scan_chunk``,
``batch_input``, ``root``, ...) therefore come after JAX's or are
keyword-only.  What differs by design goes through ``EXEMPT``: a key
``mod.Name`` exempts the pair, ``mod.Name(param)`` one JAX parameter; each
entry carries its reason, and ``test_exemptions_are_live`` fails on an
entry that no longer differs.

Two behavioural cases, each in both packages:
``CodeSimulator_Phenon.WordErrorProbability(progress=)`` (a cell killed
after k megabatches and rerun from its cursor gives the unbroken run's
result) and ``telemetry.process_info(refresh=)`` (cached until a
refresh).  Tolerance: none (names and integer counts).
"""
import inspect

import numpy as np
import pytest
import torch

from test_torch_api_parity import JAX_PKG, PORT_PKG, SHARED, _import, _is_method

_KEY = ("the port's samplers draw from a torch.Generator passed in the "
        "key's place, not from a JAX PRNG key")
_PLUMBING = ("driver plumbing: JAX's program keys (tag, cfg, tele_len) "
             "name jit programs, the port's captured graphs are keyed by "
             "the driver object")
_SEED = ("the captured drivers take the run's counter seed words in the "
         "key's place (parallel/shots.py GeneratorInput / KeyInput)")
_TELE_ON_PROG = ("the fused program carries its telemetry switch "
                 "(FusedCellProgram.tele), so the stream takes none")

EXEMPT = {
    **{f"noise.samplers.{f}(key)": _KEY for f in (
        "bit_flips", "bit_flips_packed", "bit_flips_tilted",
        "bit_flips_tilted_packed", "depolarizing_xz", "depolarizing_xz_packed",
        "depolarizing_xz_stratum", "depolarizing_xz_tilted",
        "depolarizing_xz_tilted_packed", "fixed_weight_flips")},
    "analysis.core.AnalysisContext(schema_module_rel)":
        "the port's R005 takes the schema module on the rule "
        "(SchemaDriftRule(schema_module_rel=)), so one context lints the "
        "JAX tree and the port's",
    "analysis.rules_kernels.KernelContract":
        "a contract of a CUDA wrapper, its source, launch and plain "
        "version, not of a Pallas kernel and its twin",
    "parallel.shots.CellFusedDriver": _PLUMBING,
    "parallel.shots.count_min_driver": _PLUMBING,
    "parallel.shots.cell_fused_driver": _PLUMBING,
    "sim.common.mesh_batch_stats": _PLUMBING,
    "parallel.shots.CellFusedDriver.dispatch_plan": _SEED,
    "parallel.shots.CellFusedDriver.run_keys": _SEED,
    "parallel.shots.CellFusedDriver.run_plan": _SEED,
    "parallel.shots.CellFusedDriver.run_plan_keys": _SEED,
    "parallel.shots.MegabatchDriver.run_keys": _SEED,
    "parallel.shots.CellFusedDriver.run":
        _SEED + "; a resume goes through run_keys(start=, carry0=)",
    "parallel.shots.MegabatchDriver.run":
        _SEED + "; a resume goes through run_keys(start=, carry0=)",
    "rare.sweep.weighted_cell_adaptive(tele_on)": _TELE_ON_PROG,
    "rare.sweep.weighted_cell_stream(tele_on)": _TELE_ON_PROG,
    "sim.common.fused_cell_adaptive(tele_on)": _TELE_ON_PROG,
    "sim.common.fused_cell_stream(tele_on)": _TELE_ON_PROG,
    "sim.common.fused_cell_finish":
        "the port drains a pending device carry with its program "
        "(pending, tele, prog), not a host carry",
    "sim.common.drive_weighted_run(fetch)":
        "JAX's fetch pulls a sharded carry to the host; the port's carry "
        "is read once a megabatch by the driver",
    "sim.common.gather_lane_states":
        "JAX's treedef / axes_flat are a jax pytree's; the port's lane "
        "states are a spec and axes of plain tensors",
    "sim.common.resilient_engine_run":
        "the port's ladders have no device->cpu rung (ROADMAP section C, "
        "departures), so the run needs no simulator",
    "sim.stream_spacetime.PhenomStreamDriver.finalize(key)":
        "the final round draws from the generator that reset(key) seeded",
    "utils.profiling.ProgramCost":
        "XLA's compiled-program fields (flops, argument/output/temp/"
        "generated-code bytes, backend); a captured CUDA graph has nodes, "
        "a pool and launches",
    "utils.profiling.capture_jit_cost":
        "takes a jitted function to lower; the port costs a captured "
        "graph's stats and launches",
    "utils.progcache.compile_cached":
        "compiles a jitted function on its arguments; the port caches a "
        "build callable",
}


def _sig(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _pairs() -> list:
    """``(key, JAX object, port object)`` for every pair the parity test
    makes whose both signatures are readable."""
    out = []
    for mod in SHARED:
        jm, tm = _import(JAX_PKG, mod), _import(PORT_PKG, mod)
        for name, obj in sorted(vars(jm).items()):
            if name.startswith("_") or not (inspect.isfunction(obj)
                                            or inspect.isclass(obj)):
                continue
            if getattr(obj, "__module__", None) != jm.__name__:
                continue
            if not hasattr(tm, name):
                continue
            key = f"{mod}.{name}" if mod else name
            port = getattr(tm, name)
            out.append((key, obj, port))
            if inspect.isclass(obj):
                for meth in dir(obj):
                    if (meth.startswith("_") or not _is_method(obj, meth)
                            or not hasattr(port, meth)):
                        continue
                    out.append((f"{key}.{meth}", getattr(obj, meth),
                                getattr(port, meth)))
    return [(k, j, t) for k, j, t in out
            if _sig(j) is not None and _sig(t) is not None]


_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def differences(key, jax_obj, port_obj) -> list:
    """What a JAX caller of ``key`` would find different in the port:
    ``key(param)`` for a JAX parameter the port lacks, ``key[i]`` for a
    positional slot that lands in a differently named parameter."""
    js, ts = _sig(jax_obj), _sig(port_obj)
    tp = ts.parameters
    out = [f"{key}({p.name})" for p in js.parameters.values()
           if p.kind not in _VAR and p.name not in tp
           and p.kind is not inspect.Parameter.POSITIONAL_ONLY]
    jpos = [p.name for p in js.parameters.values() if p.kind in _POSITIONAL]
    tpos = [p.name for p in tp.values() if p.kind in _POSITIONAL]
    for i, name in enumerate(jpos):
        if f"{key}({name})" in out:
            continue  # reported, or exempted, as missing
        if i >= len(tpos) or tpos[i] != name:
            out.append(f"{key}[{i}]")
    return out


def _exempt(diff: str, key: str) -> bool:
    return key in EXEMPT or diff in EXEMPT


PAIRS = _pairs()


@pytest.mark.parametrize("key,jax_obj,port_obj", PAIRS,
                         ids=[k for k, _, _ in PAIRS])
def test_parameters_in_jax_order(key, jax_obj, port_obj):
    left = [d for d in differences(key, jax_obj, port_obj)
            if not _exempt(d, key)]
    assert left == [], (f"JAX {inspect.signature(jax_obj)} against the "
                        f"port's {inspect.signature(port_obj)}")


def test_exemptions_are_live():
    """Every exemption names a pair that still differs, or a JAX
    parameter the port still lacks, and carries its reason."""
    live = set()
    for key, j, t in PAIRS:
        diffs = differences(key, j, t)
        if diffs:
            live.add(key)
        live.update(diffs)
    assert sorted(k for k in EXEMPT if k not in live) == []
    assert all(reason.strip() for reason in EXEMPT.values())


def test_differences_reads_names_and_slots():
    """A missing parameter is named once, and a moved one by its slot; a
    port parameter that is keyword-only, or after JAX's, is no
    difference."""
    def jax_f(code, batch_size=1, mesh=None, pz=None):
        pass

    def moved(code, batch_size=1, scan_chunk=4, pz=None, mesh=None):
        pass

    def fine(code, batch_size=1, mesh=None, pz=None, *, device="cuda"):
        pass

    def lacks(code, batch_size=1, pz=None):
        pass

    assert differences("f", jax_f, fine) == []
    assert differences("f", jax_f, moved) == ["f[2]"]
    assert differences("f", jax_f, lacks) == ["f(mesh)", "f[3]"]


# ----------------------------------------------------- the behavioural case

class _Killed(Exception):
    pass


def _dying(base):
    class Dying(base):
        """Saves its cursor, then dies after ``kill_after`` saves."""

        def __init__(self, checkpoint, key, kill_after):
            super().__init__(checkpoint, key)
            self.kill_after, self.saves = kill_after, 0

        def save(self, *args, **kwargs):
            super().save(*args, **kwargs)
            self.saves += 1
            if self.saves >= self.kill_after:
                raise _Killed
    return Dying


CELL = {"code": "c", "noise": "phenl", "p": 0.03, "cycles": 3}


def _phenom(pkg):
    """A BP + BPOSD-E phenomenological engine on hgp(rep 3, rep 3) from
    ``pkg`` (the JAX package or the port)."""
    import importlib

    codes = importlib.import_module(f"{pkg}.codes")
    decs = importlib.import_module(f"{pkg}.decoders")
    sim = importlib.import_module(f"{pkg}.sim")
    dev = {"device": "cpu"} if pkg == PORT_PKG else {}
    code = codes.hgp(codes.rep_code(3), codes.rep_code(3))
    c1 = decs.BP_Decoder_Class(3, "minimum_sum", 0.625, **dev)
    c2 = decs.BPOSD_Decoder_Class(3, "minimum_sum", 0.625, "osd_e", 4, **dev)
    ext = lambda h: np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])  # noqa: E731
    d1 = [c1.GetDecoder({"h": ext(h), "p_data": 0.03, "p_syndrome": 0.03})
          for h in (code.hz, code.hx)]
    d2 = [c2.GetDecoder({"h": h, "p_data": 0.03}) for h in (code.hz, code.hx)]
    return sim.CodeSimulator_Phenon(
        code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
        decoder2_z=d2[1], pauli_error_probs=[0.015] * 3, q=0.03,
        batch_size=64, scan_chunk=2, seed=4, **dev)


@pytest.mark.parametrize("pkg", [PORT_PKG, JAX_PKG])
def test_word_error_probability_resumes_mid_cell(tmp_path, pkg):
    import importlib

    torch.set_num_threads(1)
    ckpt = importlib.import_module(f"{pkg}.utils.checkpoint")
    samples = 64 * 2 * 4  # 4 megabatches of 2 batches
    unbroken = _phenom(pkg)
    want = unbroken.WordErrorProbability(3, samples)
    ck = ckpt.SweepCheckpoint(str(tmp_path / "ck.jsonl"))
    with pytest.raises(_Killed):
        _phenom(pkg).WordErrorProbability(
            3, samples, progress=_dying(ckpt.CellProgress)(ck, CELL, 1))
    state = ckpt.SweepCheckpoint(ck.path).get_progress(CELL)
    assert 0 < state["batches_done"] < samples // 64
    resumed = _phenom(pkg)
    got = resumed.WordErrorProbability(
        3, samples, None, ckpt.CellProgress(ckpt.SweepCheckpoint(ck.path),
                                            CELL))
    assert np.array_equal(np.asarray(got, dtype=float),
                          np.asarray(want, dtype=float))
    assert resumed.min_logical_weight == unbroken.min_logical_weight
    if pkg == PORT_PKG:
        assert state["batches_done"] == 2
        assert (resumed.last_failures, resumed.last_shots) == (
            unbroken.last_failures, unbroken.last_shots)
        assert resumed.last_megabatches == 3
        assert 0 < unbroken.last_failures < samples


@pytest.mark.parametrize("pkg", [PORT_PKG, JAX_PKG])
def test_process_info_caches_until_refresh(monkeypatch, pkg):
    """``telemetry.process_info(refresh=)`` has JAX's meaning: the first
    probe is cached per process and ``refresh=True`` probes anew."""
    import importlib
    import platform

    telemetry = importlib.import_module(f"{pkg}.utils.telemetry")
    try:
        monkeypatch.setattr(platform, "node", lambda: "host-a")
        assert telemetry.process_info(refresh=True)["hostname"] == "host-a"
        monkeypatch.setattr(platform, "node", lambda: "host-b")
        assert telemetry.process_info()["hostname"] == "host-a"
        assert telemetry.process_info(refresh=True)["hostname"] == "host-b"
    finally:
        monkeypatch.undo()
        telemetry.process_info(refresh=True)
