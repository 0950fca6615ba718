"""The port's reference-name shims (``qldpc_fault_tolerance_tpu_torch.compat``)
against the JAX package's, on the CPU.

``install(device="cpu")`` maps the eight reference names and the
third-party stubs to the port's objects (over the JAX compat layer too) and
binds the device into every entry point that takes one; the stubs give the
JAX stubs' values.  The reference notebooks' cells run verbatim: each
package's header imports resolve from that package's shim modules (no
``sys.modules`` clash), SpaceTimeDecodingDemo cells 2-3 give exactly JAX's
``circuit_graph``, and cell 4 (verbatim, 10,000 samples) and a Single-Shot
cell (n225, one p, 512 runs) equal the port's direct engines bit for bit and
lie within 4 binomial sigma of the JAX compat runs; at these sizes that check
rejects a port that corrects every shot or fails twice as often.  ``load_object_compat``
substitutes an absent author pickle with one warning, and the ``loadmat``
redirect fires only for the notebooks' ``.mat`` basenames.  Every test
that installs restores ``sys.modules`` and ``scipy.io.loadmat``.
"""
import builtins
import importlib
import math
import os
import sys
import types
import warnings

import numpy as np
import pytest
import scipy.io

import qldpc_fault_tolerance_tpu.compat as jcompat
import qldpc_fault_tolerance_tpu_torch.compat as tcompat
from qldpc_fault_tolerance_tpu_torch import codes as tcodes
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch import sim as tsim
from qldpc_fault_tolerance_tpu_torch import sweep as tsweep
from qldpc_fault_tolerance_tpu_torch.compat import _paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXECUTED = os.path.join(REPO, "examples", "executed")
REFERENCE_NAMES = ("Simulators", "Simulators_SpaceTime", "Decoders",
                   "Decoders_SpaceTime", "ErrorPlugin", "CircuitScheduling",
                   "QuantumExanderCodesGene", "par2gen")
STUB_NAMES = ("ldpc", "ldpc.codes", "ldpc.mod2", "ldpc.code_util", "bposd",
              "bposd.hgp", "bposd.css", "bposd.css_decode_sim", "stim",
              "graph_tools")
CPU = "cpu"
TPKG, JPKG = "qldpc_fault_tolerance_tpu_torch", "qldpc_fault_tolerance_tpu"


def _isolate(mp):
    """Take every reference name and stub out of ``sys.modules`` and pin
    ``scipy.io.loadmat``; ``mp`` puts all of it back at its undo."""
    for name in REFERENCE_NAMES + STUB_NAMES:
        mp.setitem(sys.modules, name, None)
        del sys.modules[name]
    mp.setattr(scipy.io, "loadmat", scipy.io.loadmat)


@pytest.fixture
def isolated(monkeypatch):
    _isolate(monkeypatch)
    return monkeypatch


def _cells(notebook):
    return tcompat.notebook_cells(os.path.join(EXECUTED, notebook))


def _namespace(mods):
    """A fresh exec namespace whose imports of the names in ``mods``
    resolve to those modules (``from X import *`` included) and every
    other import to the real one."""
    real = builtins.__import__

    def imp(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name in mods:
            return mods[name] if fromlist else mods[name.split(".")[0]]
        return real(name, globals, locals, fromlist, level)

    return {"__builtins__": dict(vars(builtins), __import__=imp)}


def _port_modules():
    return {**tcompat.reference_modules(device=CPU),
            **tcompat.third_party_stubs(device=CPU)}


def _jax_modules():
    """The JAX package's shim modules: its compat submodules under the
    reference names, and the stubs its ``install`` registers."""
    with pytest.MonkeyPatch.context() as mp:
        _isolate(mp)
        jcompat.install()
        stubs = {name: sys.modules[name] for name in STUB_NAMES}
    refs = {name: importlib.import_module(
        f"qldpc_fault_tolerance_tpu.compat.{name}") for name in REFERENCE_NAMES}
    return {**refs, **stubs}


def _counted(pkg, src, ns):
    """``compat.run_cell`` with the package's own diagnostics: the cell's
    output and the (failures, shots) of every engine run in it."""
    return tcompat.run_cell(
        src, ns, importlib.import_module(f"{pkg}.utils.diagnostics"))


def _within_4_sigma(k1, n1, k2, n2):
    p = (k1 + k2) / (n1 + n2)
    sigma = math.sqrt(max(p * (1 - p), 1e-12) * (1 / n1 + 1 / n2))
    return abs(k1 / n1 - k2 / n2) <= 4 * sigma + 1e-12


# ---------------------------------------------------------------------------
# install
# ---------------------------------------------------------------------------
def test_install_maps_the_reference_names_and_stubs(isolated):
    tcompat.install(device=CPU)
    for name in REFERENCE_NAMES + STUB_NAMES:
        mod = sys.modules[name]
        assert mod.__qldpc_stub__ == "qldpc_fault_tolerance_tpu_torch", name
    from Decoders import BPDecoder, BPOSD_Decoder_Class
    from Simulators import CodeFamily, CodeSimulator_DataError, parmap
    from Simulators_SpaceTime import (CodeSimulator_Circuit_SpaceTime,
                                      GenFaultHyperGraph)
    from Decoders_SpaceTime import ST_BPOSD_Decoder_Circuit_Class
    from ErrorPlugin import AddCXError
    from CircuitScheduling import ColorationCircuit
    from QuantumExanderCodesGene import Girth, RandomaGraphs
    from par2gen import LinearBlockCode

    assert issubclass(BPDecoder, tdec.BPDecoder)
    assert issubclass(BPOSD_Decoder_Class, tdec.BPOSD_Decoder_Class)
    assert issubclass(CodeFamily, tsweep.CodeFamily)
    assert issubclass(CodeSimulator_DataError, tsim.CodeSimulator_DataError)
    assert issubclass(CodeSimulator_Circuit_SpaceTime,
                      tsim.CodeSimulator_Circuit_SpaceTime)
    assert issubclass(ST_BPOSD_Decoder_Circuit_Class,
                      tdec.ST_BPOSD_Decoder_Circuit_Class)
    for obj in (GenFaultHyperGraph, AddCXError, ColorationCircuit, Girth,
                RandomaGraphs, LinearBlockCode):
        assert obj.__module__.startswith("qldpc_fault_tolerance_tpu_torch.")
    assert parmap(lambda x: x * 2, [3, 1, 2]) == [6, 2, 4]
    import ldpc
    import scipy.io as sio

    assert ldpc.bp_decoder is BPDecoder
    assert sio.loadmat.__qldpc_redirect__ == "qldpc_fault_tolerance_tpu_torch"


def test_install_binds_the_device(isolated):
    tcompat.install(device=CPU)
    from Decoders import BPDecoder, BP_Decoder_Class
    from Simulators import CodeSimulator_DataError

    code = tcodes.hgp(tcodes.rep_code(3), tcodes.rep_code(3))
    dec = BPDecoder(code.hx, [0.01] * code.N, 5)
    assert isinstance(dec, tdec.BPDecoder) and type(dec).__name__ == \
        "BPDecoder" and str(dec.device) == CPU
    cls = BP_Decoder_Class(0.5, "minimum_sum", 0.625)
    assert isinstance(cls, tdec.BP_Decoder_Class) and str(cls.device) == CPU
    d = cls.GetDecoder({"h": code.hz, "p_data": 0.01})
    sim = CodeSimulator_DataError(code=code, decoder_x=d, decoder_z=dec,
                                  pauli_error_probs=[0.01] * 3)
    assert str(sim.device) == CPU
    # an explicit device still wins; a bound class is made once a device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BPDecoder(code.hx, [0.01] * code.N, 5, device="cuda")
    assert tcompat.reference_modules(CPU)["Decoders"].BPDecoder is BPDecoder


def test_every_device_taking_entry_point_is_bound():
    """Every class or function the shims and stubs expose whose signature
    takes a ``device`` carries the installed one (a function would need
    binding too: none takes a device)."""
    import inspect

    mods = _port_modules()
    seen = 0
    for mod in mods.values():
        for name in getattr(mod, "__all__", None) or vars(mod):
            obj = getattr(mod, name)
            if name.startswith("__") or not callable(obj):
                continue
            try:
                sig = inspect.signature(obj.__init__ if isinstance(obj, type)
                                        else obj)
            except (TypeError, ValueError):
                continue
            if "device" in sig.parameters:
                assert getattr(obj, "__qldpc_device__", None) == CPU, name
                seen += 1
    assert seen >= 20


def test_bound_class_keeps_a_positional_device(isolated):
    tcompat.install(device=CPU)
    from Decoders import BPDecoder

    code = tcodes.hgp(tcodes.rep_code(3), tcodes.rep_code(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BPDecoder(code.hx, [0.01] * code.N, 5, "minimum_sum", 0.625, True,
                  None, None, "cuda")


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="holds the raise of a machine with no card")
def test_install_cuda_without_a_card_raises_at_construction(isolated):
    tcompat.install(device="cuda")
    from Decoders import BPDecoder

    code = tcodes.hgp(tcodes.rep_code(3), tcodes.rep_code(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BPDecoder(code.hx, [0.01] * code.N, 5)


def test_install_replaces_the_jax_compat_layer(isolated):
    jcompat.install()
    import Simulators
    import ldpc

    assert Simulators.__name__.startswith("qldpc_fault_tolerance_tpu.")
    assert ldpc.bp_decoder.__module__.startswith("qldpc_fault_tolerance_tpu.")
    tcompat.install(device=CPU)
    for name in REFERENCE_NAMES + STUB_NAMES:
        assert sys.modules[name].__qldpc_stub__ == \
            "qldpc_fault_tolerance_tpu_torch", name
    from Simulators import CodeSimulator_DataError
    from ldpc import bp_decoder

    assert issubclass(CodeSimulator_DataError, tsim.CodeSimulator_DataError)
    assert issubclass(bp_decoder, tdec.BPDecoder)
    assert scipy.io.loadmat.__qldpc_redirect__ == \
        "qldpc_fault_tolerance_tpu_torch"
    assert scipy.io.loadmat.__wrapped__ is scipy.io.matlab.loadmat


def test_real_modules_win(isolated):
    real_ldpc = types.ModuleType("ldpc")
    real_sim = types.ModuleType("Simulators")
    isolated.setitem(sys.modules, "ldpc", real_ldpc)
    isolated.setitem(sys.modules, "Simulators", real_sim)
    tcompat.install(device=CPU)
    assert sys.modules["ldpc"] is real_ldpc
    assert sys.modules["Simulators"] is real_sim
    assert sys.modules["bposd"].__qldpc_stub__ and \
        sys.modules["Decoders"].__qldpc_stub__


def test_install_restores_nothing_outside_the_test():
    """The fixture's undo ran: no port shim outlives a test of this file."""
    for name in REFERENCE_NAMES + STUB_NAMES:
        mod = sys.modules.get(name)
        assert getattr(mod, "__qldpc_stub__", None) != \
            "qldpc_fault_tolerance_tpu_torch", name
    assert getattr(scipy.io.loadmat, "__qldpc_redirect__", None) != \
        "qldpc_fault_tolerance_tpu_torch"


# ---------------------------------------------------------------------------
# the stubs' values against the JAX stubs'
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shims():
    return {"port": _port_modules(), "jax": _jax_modules()}


def test_stub_values_equal_the_jax_stubs(shims):
    t, j = shims["port"], shims["jax"]
    for mods in (t, j):
        q = mods["bposd.hgp"].hgp(mods["ldpc.codes"].rep_code(3),
                                  mods["ldpc.codes"].rep_code(3))
        assert (q.N, q.K) == (13, 1)
        assert mods["ldpc.mod2"].rank(mods["ldpc.codes"].ring_code(4)) == 3
    h = np.array([[1, 1, 0, 1, 0], [0, 1, 1, 0, 1], [1, 0, 1, 1, 1]],
                 np.uint8)
    for name in ("rank", "nullspace", "row_basis"):
        a = getattr(t["ldpc.mod2"], name)(h)
        b = getattr(j["ldpc.mod2"], name)(h)
        assert np.array_equal(a, b), name
    assert t["ldpc.code_util"].compute_code_distance(h) == \
        j["ldpc.code_util"].compute_code_distance(h)
    for d in (3, 5):
        assert np.array_equal(t["ldpc.codes"].ring_code(d),
                              j["ldpc.codes"].ring_code(d))
    hx, hz = np.array([[1, 1, 1, 1, 0]]), np.array([[1, 1, 0, 0, 0]])
    tc = t["bposd.css"].css_code(hx=hx, hz=hz)
    jc = j["bposd.css"].css_code(hx=hx, hz=hz)
    assert np.array_equal(tc.lx, jc.lx) and np.array_equal(tc.lz, jc.lz)
    assert issubclass(t["ldpc"].bp_decoder, tdec.BPDecoder)
    assert issubclass(t["bposd"].bposd_decoder, tdec.BPOSD_Decoder)
    assert t["stim"].Circuit.__module__.startswith(
        "qldpc_fault_tolerance_tpu_torch.")


# ---------------------------------------------------------------------------
# SpaceTimeDecodingDemo
# ---------------------------------------------------------------------------
ST_NB = "SpaceTimeDecodingDemo.executed.ipynb"
# cell 4 runs verbatim, at the notebook's own sample count
ST_SAMPLES = 10000


@pytest.fixture(scope="module")
def st_runs(shims):
    cells = _cells(ST_NB)
    cell4 = cells[4]
    assert f"num_samples = {ST_SAMPLES}" in cell4
    out = {}
    for pkg, name in (("port", TPKG), ("jax", JPKG)):
        ns = _namespace(shims[pkg])
        exec(tcompat.notebook_header(cells), ns)
        exec(cells[2], ns)
        exec(cells[3], ns)
        graph = {k: np.array(ns["circuit_fault_graphs"][k])
                 for k in ("h1", "h2", "channel_ps1", "channel_ps2")}
        wer, runs = _counted(name, cell4, ns)
        assert len(runs) == 1
        out[pkg] = (ns, graph, wer, runs[0])
    return out


@pytest.mark.parametrize("key", ["h1", "h2", "channel_ps1", "channel_ps2"])
def test_spacetime_demo_circuit_graph_equals_jax(st_runs, key):
    a, b = st_runs["port"][1][key], st_runs["jax"][1][key]
    assert a.shape == b.shape and a.size > 0
    assert np.array_equal(a, b)


def test_spacetime_demo_equals_the_direct_engine(st_runs):
    ns, _graph, nb_wer, (failures, shots) = st_runs["port"]
    assert shots >= ST_SAMPLES
    assert (ns["circuit_simulator"].last_failures,
            ns["circuit_simulator"].last_shots) == (failures, shots)
    code = tcodes.hgp(tcodes.ring_code(3), tcodes.ring_code(3))
    ep = {k: v * 1e-3 for k, v in {"p_i": 0, "p_state_p": 0, "p_m": 0,
                                   "p_CX": 1, "p_idling_gate": 0}.items()}
    sim = tsim.CodeSimulator_Circuit_SpaceTime(
        code=code, p=1e-3, num_cycles=13, num_rep=3, error_params=ep,
        eval_logical_type="Z", circuit_type="coloration",
        rand_scheduling_seed=1, device=CPU)
    sim._generate_circuit()
    sim._generate_circuit_graph()
    g = sim.circuit_graph
    max_iter = int(code.N / 10)
    sim.decoder1_z = tdec.ST_BP_Decoder_Circuit(
        h=g["h1"], channel_probs=g["channel_ps1"], max_iter=max_iter,
        bp_method="minimum_sum", ms_scaling_factor=0.625, device=CPU)
    sim.decoder2_z = tdec.ST_BPOSD_Decoder_Circuit(
        h=g["h2"], channel_probs=g["channel_ps2"], max_iter=max_iter,
        bp_method="minimum_sum", ms_scaling_factor=0.625, osd_method="osd_e",
        osd_order=10, device=CPU)
    wer = sim.WordErrorRate(num_samples=ST_SAMPLES)[0]
    assert (sim.last_failures, sim.last_shots) == (failures, shots)
    assert wer == nb_wer
    # the notebook's simulator is the bound subclass of the direct one
    assert isinstance(ns["circuit_simulator"],
                      tsim.CodeSimulator_Circuit_SpaceTime)
    assert str(ns["circuit_simulator"].device) == CPU


def test_spacetime_demo_rate_within_4_sigma_of_jax(st_runs):
    _, _, _, (kt, nt) = st_runs["port"]
    _, _, _, (kj, nj) = st_runs["jax"]
    assert nt == nj
    assert _within_4_sigma(kt, nt, kj, nj), (kt, nt, kj, nj)


def _rejects_wrong_decoders(kj, n):
    """The 4-sigma check against JAX's ``kj`` failures in ``n`` shots has
    power at this size: it rejects a port that corrects every shot and one
    that fails twice as often."""
    assert kj > 0
    return not _within_4_sigma(0, n, kj, n) and \
        not _within_4_sigma(2 * kj, n, kj, n)


def test_spacetime_demo_rate_check_rejects_wrong_decoders(st_runs):
    _, _, _, (kj, nj) = st_runs["jax"]
    assert _rejects_wrong_decoders(kj, nj), (kj, nj)


def test_spacetime_demo_fault_hypergraph_cell(st_runs):
    """Cell 5: ``GenFaultHyperGraph`` of the simulator's DEM text."""
    cells = _cells(ST_NB)
    lists = {}
    for pkg in ("port", "jax"):
        ns = st_runs[pkg][0]
        exec(cells[5], ns)
        lists[pkg] = (ns["H_list"], ns["L_list"], ns["channel_prob_list"])
    for a, b in zip(lists["port"], lists["jax"]):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# Single-Shot
# ---------------------------------------------------------------------------
SS_NB = "Single-Shot-checkpoint.executed.ipynb"
SS_RUNS = 512
# one named cut of cell 3: n225 only, the first p, 512 runs
SS_CUT = (("eval_code_list = [hgp_n225, hgp_n625, hgp_n1225, hgp_n1600]",
           "eval_code_list = [hgp_n225]"),
          ("np.log10(1.3e-1), 4))", "np.log10(1.3e-1), 1))"),
          ("num_runs = 1000", f"num_runs = {SS_RUNS}"))


@pytest.fixture(scope="module")
def ss_runs(shims):
    cells = _cells(SS_NB)
    cell3 = cells[3]
    for old, new in SS_CUT:
        assert old in cell3
        cell3 = cell3.replace(old, new)
    out = {}
    for pkg, name in (("port", TPKG), ("jax", JPKG)):
        ns = _namespace(shims[pkg])
        exec(tcompat.notebook_header(cells), ns)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            exec(cells[2], ns)
        _, runs = _counted(name, cell3, ns)
        assert len(runs) == 1
        out[pkg] = (ns, runs[0])
    return out


def test_single_shot_cell_equals_the_direct_engine(ss_runs):
    ns, (failures, shots) = ss_runs["port"]
    code = tcodes.load_code(os.path.join(REPO, "codes_lib_tpu",
                                         "hgp_34_n225.npz"))
    p = ns["eval_p_list"][0]
    probs = [p / 3, p / 3, p / 3]
    px, pz = probs[0] + probs[1], probs[1] + probs[2]
    kw = dict(max_iter=int(code.N / 10), bp_method="minimum_sum",
              ms_scaling_factor=0.625, osd_method="osd_e", osd_order=10,
              device=CPU)
    dx = tdec.BPOSD_Decoder(h=code.hz, channel_probs=px * np.ones(code.N),
                            **kw)
    dz = tdec.BPOSD_Decoder(h=code.hx, channel_probs=pz * np.ones(code.N),
                            **kw)
    sim = tsim.CodeSimulator_DataError(code=code, decoder_x=dx, decoder_z=dz,
                                       pauli_error_probs=probs, device=CPU)
    wer = sim.WordErrorRate(SS_RUNS)[0]
    assert (sim.last_failures, sim.last_shots) == (failures, shots)
    assert ns["eval_wer_list"] == [wer]
    assert float(p) == pytest.approx(5e-2, rel=1e-12)


def test_single_shot_cell_within_4_sigma_of_jax(ss_runs):
    _, (kt, nt) = ss_runs["port"]
    _, (kj, nj) = ss_runs["jax"]
    assert nt == nj
    assert _within_4_sigma(kt, nt, kj, nj), (kt, nt, kj, nj)
    assert _rejects_wrong_decoders(kj, nj), (kj, nj)
    assert ss_runs["port"][0]["hgp_n625"].N == 625


# ---------------------------------------------------------------------------
# author paths
# ---------------------------------------------------------------------------
AUTHOR = "/Users/qian/Box Sync/Research/Jiang_group_projects/QLDPC/codes_lib/"


def test_load_object_compat_substitutes_with_one_warning(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(_paths, "_warned", set())
    monkeypatch.setattr(_paths, "_REFERENCE_CODES_LIB", str(tmp_path))
    with pytest.warns(UserWarning, match="hgp_34_n625_q1.pkl") as rec:
        code = _paths.load_object_compat(AUTHOR + "hgp_34_n625_q1.pkl")
    assert len(rec) == 1 and (code.N, code.K) == (625, 25)
    want = tcodes.load_code(os.path.join(REPO, "codes_lib_tpu",
                                         "hgp_34_n625.npz"))
    assert np.array_equal(code.hx, want.hx)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = _paths.load_object_compat(AUTHOR + "hgp_34_n625_q1.pkl")
    assert np.array_equal(again.hz, want.hz)
    with pytest.raises(FileNotFoundError):
        _paths.load_object_compat(AUTHOR + "tanner_code1.pkl")
    # a file in the reference codes_lib is loaded as it is
    tcodes.save_object({"hx": want.hx}, str(tmp_path / "hgp_34_n625.pkl"))
    got = _paths.load_object_compat(AUTHOR + "hgp_34_n625.pkl")
    assert np.array_equal(got["hx"], want.hx)


def test_loadmat_redirect_fires_only_for_the_notebook_basenames(isolated,
                                                                tmp_path):
    isolated.setenv("QLDPC_REF_CODES_LIB", str(tmp_path))
    m = np.eye(3, dtype=np.uint8)
    for base in ("LP_Matg8_L16_Dmin12_hx.mat", "GenBicycleA1_hx.mat",
                 "other_hx.mat"):
        scipy.io.savemat(str(tmp_path / base), {"M": m})
    tcompat.install(device=CPU)
    from scipy.io import loadmat

    for base in ("LP_Matg8_L16_Dmin12_hx.mat", "GenBicycleA1_hx.mat"):
        with pytest.warns(UserWarning, match="redirected"):
            got = loadmat(AUTHOR + base)
        assert np.array_equal(got["M"], m)
    with pytest.raises(FileNotFoundError):
        loadmat(AUTHOR + "other_hx.mat")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert np.array_equal(loadmat(str(tmp_path / "other_hx.mat"))["M"],
                              m)
    tcompat.install(device=CPU)   # idempotent: the redirect wraps once
    assert scipy.io.loadmat is loadmat
