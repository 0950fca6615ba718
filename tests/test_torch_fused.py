"""The port's fused counter-PRNG path against the JAX package, on the CPU.

  * The plain ``sample_syndrome`` (both ``emit_errors``) and
    ``residual_check_stats`` (X/Z/Total) against the JAX package's XLA twins
    and its Pallas kernels in interpret mode.  Tolerance: none.
  * The plain ``fused_decode_stats`` against the JAX fused-decode twin,
    whose messages are bf16: count, min weight and each shot's converged
    flag and iterations identical.  Against a JAX reference composed of
    ``counter_draws`` -> ``packed_parity_apply`` -> f32 ``bp_decode`` ->
    ``packed_residual_stats``, counts agree within 4 binomial sigma.
    (``tests/test_torch_fused_v2.py`` holds both message modes against the
    JAX package.)
  * ``CodeSimulator_DataError`` with ``fused_sampler=True`` and ``"v2"``
    (float and int8 decoders) against the JAX engine of the same mode with
    the same seed: the same failures and min weight, run after run.  v2's
    failures lie within 4 binomial sigma of v1's; p=0 gives no failure.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim.data_error as jde
from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import gf2_packed as jgp
from qldpc_fault_tolerance_tpu.ops import gf2_pallas as gp
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, rep_code
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_packed as tgp
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBS = (0.02, 0.01, 0.03)


@pytest.fixture(scope="module")
def code():
    return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))


@pytest.fixture(scope="module")
def specs(code):
    return (gp.build_fused_spec(code.hx, code.hz, code.lx, code.lz, PROBS),
            gk.build_fused_spec(code.hx, code.hz, code.lx, code.lz, PROBS,
                                "cpu"))


def _key(seed):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    return jkey, gk.fold_in(gk.prng_key(seed), 3)


def _same_words(jax_words, torch_words):
    assert len(jax_words) == len(torch_words)
    for j, t in zip(jax_words, torch_words):
        assert np.array_equal(np.asarray(j).view(np.int32), t.numpy())


@pytest.mark.parametrize("B", [256, 200])
@pytest.mark.parametrize("emit_errors", [True, False])
def test_sample_syndrome_matches_jax(specs, B, emit_errors):
    jspec, tspec = specs
    jkey, tkey = _key(B)
    got = gk.sample_syndrome(tspec, tkey, B, emit_errors=emit_errors)
    _same_words(gp.sample_syndrome(jspec, jkey, B, backend="xla",
                                   emit_errors=emit_errors), got)
    if B % 256 == 0:  # the TPU kernel's block: 8 words of 32 shots
        _same_words(gp.sample_syndrome(jspec, jkey, B, backend="pallas",
                                       interpret=True,
                                       emit_errors=emit_errors), got)
    if B % 32:  # the ragged last word pads with zero bits
        pad = ~tgp.lane_mask(B, "cpu")[-1]
        assert all(bool(((w[-1] & pad) == 0).all()) for w in got)


def _corrections(code, jspec, jkey, B):
    """The batch's true error words with ~1% of words hit by one bit flip:
    some shots fail, most do not."""
    exp, ezp, _, _ = gp.sample_syndrome(jspec, jkey, B, backend="xla")
    rng = np.random.default_rng(B)
    out = []
    for e in (exp, ezp):
        flip = (rng.random(e.shape) < 0.01).astype(np.uint32) \
            << rng.integers(0, 32, e.shape).astype(np.uint32)
        out.append(np.asarray(e) ^ flip)
    return out


@pytest.mark.parametrize("B", [256, 200])
@pytest.mark.parametrize("eval_type", ["X", "Z", "Total"])
def test_residual_check_matches_jax(code, specs, B, eval_type):
    jspec, tspec = specs
    jkey, tkey = _key(B + 1)
    corx, corz = _corrections(code, jspec, jkey, B)
    got = gk.residual_check_stats(
        tspec, tkey, B, torch.from_numpy(corx.view(np.int32)),
        torch.from_numpy(corz.view(np.int32)), eval_type)
    want = gp.residual_check_stats(jspec, jkey, B, jnp.asarray(corx),
                                   jnp.asarray(corz), eval_type,
                                   backend="xla")
    assert 0 < int(want[0]) < B
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    if B % 256 == 0:
        ker = gp.residual_check_stats(jspec, jkey, B, jnp.asarray(corx),
                                      jnp.asarray(corz), eval_type,
                                      backend="pallas", interpret=True)
        assert (int(got[0]), int(got[1])) == (int(ker[0]), int(ker[1]))


def _decode_specs(code, p):
    """Specs whose sectors have different, non-uniform channel LLRs (min-sum
    is blind to a uniform scale), so a swap of the sectors' priors shows."""
    rng = np.random.default_rng(code.N)
    llr_x, llr_z = (np.asarray(jbp.llr_from_probs(
        rng.uniform(p / 4, p, code.N))) for _ in range(2))
    jspec = gp.build_fused_decode_spec(code.hx, code.hz, code.lx, code.lz,
                                       [p / 3] * 3, llr_x, llr_z)
    tspec = gk.build_fused_decode_spec(code.hx, code.hz, code.lx, code.lz,
                                       [p / 3] * 3, llr_x, llr_z, "cpu")
    return jspec, tspec


def _jax_f32_reference(code, jspec, jkey, B, max_iter):
    """counter_draws -> packed_parity_apply -> f32 bp_decode ->
    packed_residual_stats, all from the JAX package."""
    base = jspec.base
    k0, k1 = gp._key_words(jkey)
    ex, ez = gp._errors_from_draws(gp.counter_draws(k0, k1, B, code.N),
                                   base.cuts)
    exp, ezp = jgp.pack_shots(ex.astype(jnp.uint8)), jgp.pack_shots(
        ez.astype(jnp.uint8))
    sz = jgp.unpack_shots(jgp.packed_parity_apply(base.hx_nbr, base.hx_mask,
                                                  ezp), B)
    sx = jgp.unpack_shots(jgp.packed_parity_apply(base.hz_nbr, base.hz_mask,
                                                  exp), B)
    rz = jbp.bp_decode(jbp.build_tanner_graph(code.hx), sz,
                       jspec.llr_z.reshape(-1), max_iter=max_iter)
    rx = jbp.bp_decode(jbp.build_tanner_graph(code.hz), sx,
                       jspec.llr_x.reshape(-1), max_iter=max_iter)
    cnt, mw = jgp.packed_residual_stats(
        exp ^ jgp.pack_shots(rx.error), ezp ^ jgp.pack_shots(rz.error),
        (base.hz_nbr, base.hz_mask), (base.hx_nbr, base.hx_mask),
        base.lz_t != 0, base.lx_t != 0, "Total", B, code.N)
    return cnt, mw, rx, rz


@pytest.mark.parametrize("name,B", [("rep3", 256), ("n225", 256)])
def test_fused_decode_matches_jax_f32_and_bf16(code, name, B):
    """Exact against the JAX package's bf16 fused twin; within 4 binomial
    sigma of float32 min-sum (the JAX package's bp_decode)."""
    c = code if name == "n225" else hgp(rep_code(3), rep_code(3))
    p, it = 0.05, 20
    jspec, tspec = _decode_specs(c, p)
    jkey, tkey = _key(11)
    cnt, mw, ax, az = gk.fused_decode_stats(tspec, tkey, B, max_iter_z=it,
                                            max_iter_x=it)
    bcnt, bmw, bx, bz = gp.fused_decode_stats(
        jspec, jkey, B, eval_type="Total", max_iter_z=it, max_iter_x=it,
        backend="xla", block_w=B // 32)
    assert (int(cnt), int(mw)) == (int(bcnt), int(bmw))
    for aux, res in ((ax, bx), (az, bz)):
        assert np.array_equal(aux["converged"].numpy(),
                              np.asarray(res["converged"]))
        assert np.array_equal(aux["iterations"].numpy(),
                              np.asarray(res["iterations"]))
    jcnt, _jmw, rx, rz = _jax_f32_reference(c, jspec, jkey, B, it)
    f_b, f_f = int(cnt) / B, int(jcnt) / B
    sigma = np.sqrt((f_b * (1 - f_b) + f_f * (1 - f_f)) / B)
    assert abs(f_b - f_f) <= 4 * sigma + 1e-12, (f_b, f_f)
    same = np.mean([np.mean(np.asarray(r.converged) == a["converged"].numpy())
                    for a, r in ((ax, rx), (az, rz))])
    print(f"{name}: bf16 {int(cnt)} vs f32 {int(jcnt)} failures; "
          f"converged flags identical on {same:.4f} of shots")


def _sims(code, p, fused, seed=5, batch_size=256, kind="bp", **kw):
    probs = np.full(code.N, 2 * p / 3)
    cls = {"bp": tdec.BPDecoder, "bposd": tdec.BPOSD_Decoder}[kind]
    return CodeSimulator_DataError(
        code=code, decoder_x=cls(code.hz, probs, 50, device="cpu", **kw),
        decoder_z=cls(code.hx, probs, 50, device="cpu", **kw),
        pauli_error_probs=[p / 3] * 3, seed=seed, batch_size=batch_size,
        fused_sampler=fused, device="cpu")


ENGINE_MODES = ((True, None), ("v2", None), ("v2", "int8"))


@pytest.fixture(scope="module")
def jax_engine_runs(code):
    """For each (fused_sampler, quantize) of ENGINE_MODES: two successive
    4-batch WordErrorRate runs of the JAX engine, then one run with an
    explicit positional key."""
    p = 0.03
    probs = np.full(code.N, 2 * p / 3)
    out = {}
    for fused, quantize in ENGINE_MODES:
        kw = {"quantize": quantize} if quantize else {}
        jsim = jde.CodeSimulator_DataError(
            code=code, decoder_x=jdec.BPDecoder(code.hz, probs, 50, **kw),
            decoder_z=jdec.BPDecoder(code.hx, probs, 50, **kw),
            pauli_error_probs=[p / 3] * 3, seed=5, batch_size=256,
            fused_sampler=fused)
        runs = []
        for key in (None, None, jax.random.PRNGKey(9)):
            wer = jsim.WordErrorRate(1024, key) if key is not None \
                else jsim.WordErrorRate(1024)
            runs.append((wer, jsim.min_logical_weight))
        out[fused, quantize] = runs
    return out


def test_fused_engine_matches_jax_engine_seed_for_seed(code, jax_engine_runs):
    """Each mode against the JAX engine of the same mode: v1 decodes with
    the decoders' own programs, v2 with the JAX fused kernel's bf16 loop, or
    its int8 loop for int8 decoders."""
    for fused, quantize in ENGINE_MODES:
        kw = {"quantize": quantize} if quantize else {}
        sim = _sims(code, 0.03, fused, **kw)
        want = jax_engine_runs[fused, quantize]
        for w in want[:2]:
            wer = sim.WordErrorRate(1024)
            assert sim.last_shots == 1024 and sim.last_failures > 0
            assert (wer, sim.min_logical_weight) == w, (fused, quantize)
        wer = sim.WordErrorRate(1024, (0, 9))
        assert (wer, sim.min_logical_weight) == want[2], (fused, quantize)


def test_word_error_rate_takes_key_positionally(code, jax_engine_runs):
    sim = _sims(code, 0.03, True)
    wer = sim.WordErrorRate(1024, (0, 9))
    assert (wer, sim.min_logical_weight) == jax_engine_runs[True, None][2]
    assert sim.WordErrorRate(1024, key=np.array([0, 9], np.uint32)) == wer
    early = _sims(code, 0.03, "v2")
    early.WordErrorRate(8192, (0, 9), 1)
    assert early.last_failures >= 1 and early.last_shots < 8192


def test_fused_v2_equals_v1_and_zero_noise(code):
    """v2 (bf16 messages) and v1 (float32) decode the same errors: their
    failures agree within 4 combined binomial sigma, not exactly.  p=0
    gives no failure in any mode."""
    one, two = _sims(code, 0.05, True, seed=2), _sims(code, 0.05, "v2", seed=2)
    for _ in range(2):
        one.WordErrorRate(512)
        two.WordErrorRate(512)
        f1, f2 = one.last_failures / 512, two.last_failures / 512
        sigma = np.sqrt((f1 * (1 - f1) + f2 * (1 - f2)) / 512)
        assert one.last_failures > 0 and two.last_failures > 0
        assert abs(f1 - f2) <= 4 * sigma, (f1, f2)
    for fused, quantize in ENGINE_MODES:
        kw = {"quantize": quantize} if quantize else {}
        zero = _sims(code, 0.0, fused, **kw)
        assert zero.WordErrorRate(512) == (0.0, 0.0)
        assert zero.last_failures == 0 and zero.min_logical_weight == code.N


def test_fused_v1_takes_bposd_decoders(code):
    """Same key: OSD only replaces BP's unconverged corrections, and those
    always fail a stabilizer check, so BPOSD never fails more shots."""
    bp = _sims(code, 0.06, True, batch_size=128)
    osd = _sims(code, 0.06, True, batch_size=128, kind="bposd")
    bp.WordErrorRate(128)
    osd.WordErrorRate(128)
    assert osd.last_failures <= bp.last_failures
    assert bp.last_failures > 0


def test_fused_engines_reject_what_they_cannot_run(code):
    probs = np.full(code.N, 0.02)
    bp = [tdec.BPDecoder(h, probs, 20, device="cpu") for h in (code.hz, code.hx)]
    with pytest.raises(ValueError, match="fused_sampler"):
        CodeSimulator_DataError(code=code, decoder_x=bp[0], decoder_z=bp[1],
                                fused_sampler="v3", device="cpu")
    osd = [tdec.BPOSD_Decoder(h, probs, 20, device="cpu")
           for h in (code.hz, code.hx)]
    with pytest.raises(ValueError, match="min-sum"):
        CodeSimulator_DataError(code=code, decoder_x=osd[0], decoder_z=osd[1],
                                fused_sampler="v2", device="cpu")
    other = tdec.BPDecoder(code.hx, probs, 20, ms_scaling_factor=0.9,
                           device="cpu")
    with pytest.raises(ValueError, match="ms_scaling_factor"):
        CodeSimulator_DataError(code=code, decoder_x=bp[0], decoder_z=other,
                                fused_sampler="v2", device="cpu")
    _, tspec = _decode_specs(code, 0.03)
    for quantize in (None, "int8"):
        with pytest.raises(ValueError, match="divisible by 32"):
            gk.fused_decode_stats(tspec, (0, 1), 48, max_iter_z=5,
                                  max_iter_x=5, quantize=quantize)
    int8 = [tdec.BPDecoder(h, probs, 20, quantize="int8", device="cpu")
            for h in (code.hz, code.hx)]
    with pytest.raises(ValueError, match="quantize"):
        CodeSimulator_DataError(code=code, decoder_x=int8[0],
                                decoder_z=bp[1], fused_sampler="v2",
                                device="cpu")
    ragged = CodeSimulator_DataError(code=code, decoder_x=int8[0],
                                     decoder_z=int8[1], fused_sampler="v2",
                                     batch_size=48, device="cpu")
    with pytest.raises(ValueError, match="divisible by 32"):
        ragged.WordErrorRate(48)


def test_fused_spec_from_jax_round_trip(code):
    jspec, tspec = _decode_specs(code, 0.03)
    np_spec = jax.tree_util.tree_map(np.asarray, jspec)
    for got, want in ((gk.fused_spec_from_jax(np_spec.base, "cpu"),
                       tspec.base),
                      (gk.fused_spec_from_jax(np_spec, "cpu"), tspec)):
        assert type(got) is type(want)
        flat_got = jax.tree_util.tree_leaves(got)
        flat_want = jax.tree_util.tree_leaves(want)
        assert len(flat_got) == len(flat_want)
        for a, b in zip(flat_got, flat_want):
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b)
            else:
                assert a == b
    broken = np_spec._replace(zg_idx=np_spec.zg_idx[::-1])
    with pytest.raises(ValueError):
        gk.fused_spec_from_jax(broken, "cpu")


def test_driver_key_stream_hands_each_batch_its_folded_key():
    from qldpc_fault_tolerance_tpu_torch.ops.prng import fold_in
    from qldpc_fault_tolerance_tpu_torch.parallel import MegabatchDriver

    seen = []

    def stats(batch_key):
        seen.append(batch_key)
        return (torch.ones((), dtype=torch.int32),)

    driver = MegabatchDriver(stats, lambda c, o: (c[0] + o[0],),
                             lambda: (torch.zeros((), dtype=torch.int32),),
                             fold_in, k_inner=3)
    carry, done = driver.run((0, 9), 5)
    assert done == 6 and int(carry[0]) == 6
    assert seen == [tuple(int(w) for w in np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(9), j)))) for j in range(6)]


def test_fused_entry_points_raise_without_card_or_cpu_request(code,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gk.build_fused_spec(code.hx, code.hz, code.lx, code.lz, PROBS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gk.build_fused_decode_spec(code.hx, code.hz, code.lx, code.lz, PROBS,
                                   np.ones(code.N), np.ones(code.N))
