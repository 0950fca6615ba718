"""The port's code-construction helpers against the JAX package's, bit for
bit: ``codes/codegen.py`` (random biregular Tanner graphs, girth, girth
swaps, classical parameters, quantum expanders), ``utils/par2gen.py`` (the
[7,4,3] Hamming code), ``classical_code_distance``,
``hgp(compute_distance=True).D``, ``gf2.solve`` / ``row_reduce_augmented``,
and the loaders' round trips (``save_code`` / ``load_code``,
``save_object`` / ``load_object``, across the two packages).  A subprocess
that refuses every import of ``jax`` and of the JAX package loads a pickled
JAX ``CssCode`` through the port's ``load_pickle_code``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from qldpc_fault_tolerance_tpu import codes as jcodes
from qldpc_fault_tolerance_tpu.codes import gf2 as jgf2
from qldpc_fault_tolerance_tpu.utils import par2gen as jpar2gen
from qldpc_fault_tolerance_tpu_torch import codes as tcodes
from qldpc_fault_tolerance_tpu_torch.codes import gf2 as tgf2
from qldpc_fault_tolerance_tpu_torch.utils import par2gen as tpar2gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 7]


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# codegen
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_random_biregular_tanner_and_girth(seed):
    jh = jcodes.random_biregular_tanner(4, 4, 3, np.random.default_rng(seed))
    th = tcodes.random_biregular_tanner(4, 4, 3, np.random.default_rng(seed))
    assert _eq(jh, th) and th.shape == (12, 16)
    assert (th.sum(1) == 4).all() and (th.sum(0) == 3).all()
    assert tcodes.tanner_girth(th) == jcodes.tanner_girth(jh)
    jg, jcrit = jcodes.min_cycle_edges(jh)
    tg, tcrit = tcodes.min_cycle_edges(th)
    assert (jg, jcrit) == (tg, tcrit)


@pytest.mark.parametrize("seed", SEEDS)
def test_improve_girth(seed):
    h = jcodes.random_biregular_tanner(5, 4, 3, np.random.default_rng(seed))
    jh, jok = jcodes.improve_girth(h, 6, max_iter=300,
                                   rng=np.random.default_rng(seed + 100))
    th, tok = tcodes.improve_girth(h, 6, max_iter=300,
                                   rng=np.random.default_rng(seed + 100))
    assert _eq(jh, th) and jok == tok
    assert (th.sum(1) == h.sum(1)).all() and (th.sum(0) == h.sum(0)).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_gene_rand_graphs_large_girth_final(seed):
    kw = dict(n0=3, Delta_c=4, Delta_v=3, min_girth1=4, target_girth=6,
              num=2, max_iter=20, seed=seed, swap_iters=200)
    jout = jcodes.GeneRandGraphsLargeGirthFinal(**kw)
    tout = tcodes.GeneRandGraphsLargeGirthFinal(**kw)
    assert len(jout) == len(tout)
    assert all(_eq(a, b) for a, b in zip(jout, tout))


def test_gene_rand_graphs_max_iter_is_counted():
    from qldpc_fault_tolerance_tpu_torch.utils import telemetry

    was = telemetry.enabled()
    telemetry.enable()
    try:
        before = telemetry.snapshot().get("codegen.max_iter_reached",
                                          {}).get("value", 0)
        with pytest.warns(UserWarning, match="max_iter=1 reached"):
            out = tcodes.GeneRandGraphsLargeGirthFinal(
                3, 4, 3, min_girth1=4, target_girth=50, num=1, max_iter=1,
                seed=0, swap_iters=2)
        after = telemetry.snapshot()["codegen.max_iter_reached"]["value"]
    finally:
        if not was:
            telemetry.disable()
    assert out == [] and after == before + 1


@pytest.mark.parametrize("seed", SEEDS)
def test_classical_params_and_quantum_expander(seed):
    h = jcodes.random_biregular_tanner(3, 4, 3, np.random.default_rng(seed))
    jp = jcodes.GetClassicalCodeParams(h)
    tp = tcodes.GetClassicalCodeParams(h)
    assert jp[:3] == tp[:3] and float(jp[3]) == float(tp[3])
    jq = jcodes.QuantumExpanderFromCheckMat(h)
    tq = tcodes.QuantumExpanderFromCheckMat(h)
    for attr in ("hx", "hz", "lx", "lz"):
        assert _eq(getattr(jq, attr), getattr(tq, attr))
    assert (tq.N, tq.K, tq.D) == (jq.N, jq.K, jq.D) and tq.D is not None


# ---------------------------------------------------------------------------
# hgp distance, classical distance, gf2 solves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_classical_code_distance(seed):
    rng = np.random.default_rng(seed)
    h = (rng.random((6, 11)) < 0.35).astype(np.uint8)
    assert tcodes.classical_code_distance(h) == \
        jcodes.classical_code_distance(h)
    assert tcodes.classical_code_distance(tcodes.rep_code(5)) == 5
    assert tcodes.classical_code_distance(np.eye(4, dtype=np.uint8)) == \
        int(1e9)
    with pytest.raises(ValueError, match="too large"):
        tcodes.classical_code_distance(np.zeros((1, 30), np.uint8))


@pytest.mark.parametrize("pair", ["rep3", "ring3_rep4", "rep5"])
def test_hgp_compute_distance(pair):
    mats = {"rep3": ("rep_code", 3, "rep_code", 3),
            "ring3_rep4": ("ring_code", 3, "rep_code", 4),
            "rep5": ("rep_code", 5, "rep_code", 5)}[pair]
    a, da, b, db = mats
    jc = jcodes.hgp(getattr(jcodes, a)(da), getattr(jcodes, b)(db),
                    compute_distance=True)
    tc = tcodes.hgp(getattr(tcodes, a)(da), getattr(tcodes, b)(db),
                    compute_distance=True, name="x")
    assert tc.D == jc.D and tc.D is not None and tc.name == "x"
    assert tcodes.hgp(tcodes.rep_code(3), tcodes.rep_code(3)).D is None


@pytest.mark.parametrize("seed", SEEDS)
def test_gf2_solve_and_row_reduce_augmented(seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((7, 10)) < 0.4).astype(np.uint8)
    for _ in range(6):
        b = (rng.random(7) < 0.5).astype(np.uint8)
        js, ts = jgf2.solve(a, b), tgf2.solve(a, b)
        assert (js is None) == (ts is None)
        if ts is not None:
            assert _eq(js, ts)
            assert np.array_equal(a.astype(int) @ ts % 2, b)
    # a consistent system with a dependent row, and an inconsistent one
    a2 = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]], np.uint8)
    assert tgf2.solve(a2, [1, 0, 1]) is not None
    assert tgf2.solve(a2, [1, 0, 0]) is None
    bs = (rng.random((5, 10)) < 0.5).astype(np.uint8)
    jr = jgf2.row_reduce_augmented(a, bs)
    tr = tgf2.row_reduce_augmented(a, bs)
    assert len(jr) == len(tr) == 5
    for x, y in zip(jr, tr):
        assert (x is None) == (y is None)
        if y is not None:
            assert _eq(x, y)


# ---------------------------------------------------------------------------
# par2gen: the [7,4,3] Hamming code
# ---------------------------------------------------------------------------
HAMMING_P = np.array([[1, 1, 0], [0, 1, 1], [1, 1, 1], [1, 0, 1]])


@pytest.fixture
def hamming():
    g = np.concatenate([HAMMING_P, np.eye(4, dtype=int)], axis=1)
    return jpar2gen.LinearBlockCode(G=g), tpar2gen.LinearBlockCode(G=g)


def test_linear_block_code_params(hamming):
    j, t = hamming
    assert (t.n(), t.k(), t.dmin(), t.t(), t.errorDetectionCapability()) == \
        (j.n(), j.k(), j.dmin(), j.t(), j.errorDetectionCapability()) == \
        (7, 4, 3, 1, 2)
    assert t.R() == j.R()


def test_linear_block_code_weight_distribution(hamming):
    j, t = hamming
    assert list(t.A()) == list(j.A()) == [1, 0, 0, 7, 7, 0, 0, 1]
    assert t.Ai(3) == j.Ai(3) == 7


def test_linear_block_code_h_g_round_trip(hamming):
    j, t = hamming
    assert _eq(t.H(), j.H())
    assert not (t.H() @ t.G().T % 2).any()
    assert np.array_equal(tpar2gen.HtoG(tpar2gen.GtoH(t.G())), t.G())
    assert _eq(tpar2gen.HtoP(t.H()), jpar2gen.HtoP(j.H()))
    assert _eq(tpar2gen.GtoP(t.G()), jpar2gen.GtoP(j.G()))
    assert _eq(t.C(), j.C()) and _eq(t.M(), j.M())


def test_linear_block_code_syndrome_decode(hamming):
    j, t = hamming
    m = np.array([1, 0, 1, 1])
    c = t.c(m)
    assert _eq(c, j.c(m))
    for pos in range(7):
        r = c.copy()
        r[pos] ^= 1  # single error: within t=1
        assert np.array_equal(t.syndromeDecode(r), c)
        assert _eq(t.s(r), j.s(r))
    assert t.decodingTable().keys() == j.decodingTable().keys()


def test_linear_block_code_probabilities(hamming):
    j, t = hamming
    for p in (0.0, 0.01, 0.1):
        assert t.PU(p) == j.PU(p) and t.Pe(p) == j.Pe(p)
    assert t.PU(0.0) == 0.0 and 0 < t.PU(0.01) < t.PU(0.1)


def test_par2gen_helpers_and_printing(hamming, capsys):
    j, t = hamming
    assert tpar2gen.w([1, 0, 1]) == 2 and tpar2gen.d([1, 0], [0, 1]) == 2
    assert _eq(tpar2gen.intToArray(5, 4), jpar2gen.intToArray(5, 4))
    assert tpar2gen.arrayToString([1, 0, 1]) == \
        jpar2gen.arrayToString([1, 0, 1])
    assert tpar2gen.nCr(7, 3) == jpar2gen.nCr(7, 3)
    assert tpar2gen.matrixMultiplicationEquations(t.H(), "c", "s") == \
        jpar2gen.matrixMultiplicationEquations(j.H(), "c", "s")
    t.printInfo()
    port_out = capsys.readouterr().out
    j.printInfo()
    assert port_out == capsys.readouterr().out and port_out


def test_utils_exports_par2gen():
    from qldpc_fault_tolerance_tpu_torch import utils

    assert utils.par2gen is tpar2gen
    assert utils.LinearBlockCode is tpar2gen.LinearBlockCode
    assert {"HtoG", "GtoH", "HtoP", "GtoP"} <= set(utils.__all__)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------
def _same_code(a, b):
    return all(_eq(getattr(a, k), getattr(b, k))
               for k in ("hx", "hz", "lx", "lz")) and \
        (a.N, a.K, a.D, a.name) == (b.N, b.K, b.D, b.name)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_code_load_code_round_trip(tmp_path, writer):
    code = tcodes.hgp(tcodes.ring_code(3), tcodes.rep_code(4),
                      compute_distance=True, name="t34")
    jcode = jcodes.hgp(jcodes.ring_code(3), jcodes.rep_code(4),
                       compute_distance=True, name="t34")
    path = str(tmp_path / "code.npz")
    if writer == "port":
        tcodes.save_code(code, path)
        assert _same_code(jcodes.load_code(path), jcode)
    else:
        jcodes.save_code(jcode, path)
    assert _same_code(tcodes.load_code(path), code)
    bare = str(tmp_path / "bare.npz")
    tcodes.save_code(tcodes.hgp(tcodes.rep_code(3), tcodes.rep_code(3)),
                     bare)
    assert tcodes.load_code(bare).D is None


def test_save_object_load_object_round_trip(tmp_path):
    code = tcodes.hgp(tcodes.rep_code(3), tcodes.rep_code(3), name="s")
    obj = {"code": code, "ps": np.linspace(0, 1, 5), "tag": "x"}
    path = str(tmp_path / "obj.pkl")
    tcodes.save_object(obj, path)
    back = tcodes.load_object(path)
    assert _same_code(back["code"], code) and back["tag"] == "x"
    assert np.array_equal(back["ps"], obj["ps"])
    # the JAX package reads the port's pickle of plain data alike
    jback = jcodes.load_object(path)
    assert np.array_equal(jback["ps"], obj["ps"])


def test_load_pickle_code_of_a_bposd_style_object(tmp_path, monkeypatch):
    """A pickle naming a class of a package that is absent (as bposd's
    ``hgp`` is): the class is shimmed and the code rebuilt from its state."""
    import types

    mod = types.ModuleType("_qldpc_absent_bposd")

    class hgp:  # noqa: N801 - the reference's class name
        pass

    hgp.__module__, hgp.__qualname__ = mod.__name__, "hgp"
    mod.hgp = hgp
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    code = jcodes.hgp(jcodes.rep_code(3), jcodes.rep_code(4))
    obj = hgp()
    obj.hx, obj.hz, obj.D = code.hx, code.hz, 3
    path = tmp_path / "hgp_x.pkl"
    path.write_bytes(pickle.dumps(obj))
    monkeypatch.delitem(sys.modules, mod.__name__)
    tc = tcodes.load_pickle_code(str(path))
    jc = jcodes.load_pickle_code(str(path))
    assert _same_code(tc, jc) and tc.D == 3 and tc.name == "hgp_x"
    assert _eq(tc.hx, code.hx)


CHILD = textwrap.dedent("""
    import importlib.abc, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib",
                                      "qldpc_fault_tolerance_tpu"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    from qldpc_fault_tolerance_tpu_torch.codes import load_pickle_code
    code = load_pickle_code(sys.argv[1])
    want = np.load(sys.argv[2])
    assert np.array_equal(code.hx, want["hx"])
    assert np.array_equal(code.hz, want["hz"])
    assert np.array_equal(code.lx, want["lx"])
    assert code.D == int(want["D"]), (code.D, want["D"])
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "qldpc_fault_tolerance_tpu"))
    assert not bad, bad
    print("ok", code.N, code.K)
""")


def test_load_pickle_code_of_a_jax_css_code_imports_no_jax(tmp_path):
    jc = jcodes.hgp(jcodes.ring_code(3), jcodes.rep_code(3),
                    compute_distance=True, name="jax_code")
    pkl = str(tmp_path / "jax_code.pkl")
    jcodes.save_object(jc, pkl)
    with open(pkl, "rb") as fh:
        assert b"qldpc_fault_tolerance_tpu.codes.css" in fh.read()
    ref = str(tmp_path / "ref.npz")
    np.savez(ref, hx=jc.hx, hz=jc.hz, lx=jc.lx, D=jc.D)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", CHILD, pkl, ref], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["ok", str(jc.N), str(jc.K)]
    # in this process too, the loaded object is the port's, not JAX's
    tc = tcodes.load_pickle_code(pkl)
    assert type(tc) is tcodes.CssCode and _eq(tc.hz, jc.hz)
