"""The smaller names the port gained to match the JAX package name by name
(``tests/test_torch_api_parity.py`` lists them), each against its JAX
counterpart on the same inputs where one computes the same thing:
``gf2.pack_bitplane`` / ``unpack_bitplane``, ``CssCode.validate``,
``gf2_packed.or_reduce``, ``linalg.syndrome`` / ``as_device_gf2``,
``cs_sweep_feasible``, ``device_syndrome_width``, ``bp_batch_device`` and
``host_postprocess``, ``SimResult``, ``accumulate_device`` /
``accumulate_counts`` / ``timed_host_sync`` / ``key_bytes``,
``CellFusedDriver.degrade_mesh`` / ``dispatch_plan``,
``ProgramCost.peak_bytes``, ``timeit_async``, ``profile_trace``, and
``telemetry.record_bp_aux``, whose counts on a host-OSD
(``device_osd=False``) engine run equal a numpy recount of the decoder aux
that reached the host."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu.codes import gf2 as jgf2
from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep
from qldpc_fault_tolerance_tpu.decoders import bp_decoders as jbd
from qldpc_fault_tolerance_tpu.ops import linalg as jlinalg
from qldpc_fault_tolerance_tpu.sim import common as jcommon
from qldpc_fault_tolerance_tpu_torch.codes import gf2, hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.codes.css import CssCode
from qldpc_fault_tolerance_tpu_torch.decoders import bp_decoders as tbd
from qldpc_fault_tolerance_tpu_torch.ops import gf2_packed, linalg
from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs
from qldpc_fault_tolerance_tpu_torch.ops.prng import prng_key
from qldpc_fault_tolerance_tpu_torch.parallel.shots import CellFusedDriver
from qldpc_fault_tolerance_tpu_torch.sim import common as tcommon
from qldpc_fault_tolerance_tpu_torch.utils import observability, profiling
from qldpc_fault_tolerance_tpu_torch.utils import telemetry


@pytest.mark.parametrize("b", [1, 31, 32, 70])
def test_pack_bitplane_matches_jax_and_the_device_packing(b):
    bits = (np.random.default_rng(b).random((b, 5, 3)) < 0.4).astype(np.uint8)
    packed = gf2.pack_bitplane(bits)
    np.testing.assert_array_equal(packed, jgf2.pack_bitplane(bits))
    np.testing.assert_array_equal(gf2.unpack_bitplane(packed, b), bits)
    np.testing.assert_array_equal(
        gf2.unpack_bitplane(packed, b), jgf2.unpack_bitplane(packed, b))
    dev = gf2_packed.pack_shots(torch.from_numpy(bits[:, :, 0]))
    np.testing.assert_array_equal(dev.numpy().view(np.uint32),
                                  packed[:, :, 0])


def test_css_validate_passes_and_catches_a_bad_logical():
    code = hgp(rep_code(3), rep_code(4))
    code.validate()
    bad = CssCode(code.hx, code.hz, lx=code.hx[:1].copy(), lz=code.lz)
    with pytest.raises(AssertionError):
        bad.validate()
    jcode = jhgp(jrep(3), jrep(4))
    jcode.validate()
    np.testing.assert_array_equal(code.lx, jcode.lx)


def test_or_reduce_syndrome_and_device_gf2():
    rng = np.random.default_rng(2)
    words = rng.integers(-2 ** 31, 2 ** 31, (7, 5), dtype=np.int64).astype(
        np.int32)
    for dim in (0, 1, -1):
        np.testing.assert_array_equal(
            gf2_packed.or_reduce(torch.from_numpy(words), dim).numpy(),
            np.bitwise_or.reduce(words, axis=dim))
    np.testing.assert_array_equal(
        gf2_packed.packed_any(torch.from_numpy(words)).numpy(),
        np.bitwise_or.reduce(words, axis=-1))
    h = hgp(rep_code(3), rep_code(3)).hx
    e = (rng.random((9, h.shape[1])) < 0.3).astype(np.uint8)
    got = linalg.syndrome(h, torch.from_numpy(e))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlinalg.syndrome(h, jnp.asarray(e))))
    dg = linalg.as_device_gf2(h, "cpu")
    assert dg.dtype == torch.uint8 and np.array_equal(
        dg.numpy(), np.asarray(jlinalg.as_device_gf2(h)))


def test_cs_sweep_feasible_is_the_sweep_blocks_gate():
    f, w, _ = tcs._cs_counts(625, 300, 10)
    assert tcs.cs_sweep_feasible(625, 300, 10) == (
        tcs.cs_rows_smem_bytes(20, 300, f, w) <= tcs.od.SMEM_LIMIT)
    assert tcs.cs_sweep_feasible(625, 300, 10)
    assert not tcs.cs_sweep_feasible(60000, 20000, 10)


def test_device_syndrome_width_matches_jax():
    code = hgp(rep_code(3), rep_code(4))
    probs = np.full(code.N, 0.05)
    dec = tbd.BPDecoder(code.hx, probs, 10, device="cpu")
    jdec = jbd.BPDecoder(code.hx, probs, 10)
    st = tbd.ST_BP_Decoder_syndrome(code.hx, 0.05, 0.05, 10, num_rep=3,
                                    device="cpu")
    jst = jbd.ST_BP_Decoder_syndrome(code.hx, 0.05, 0.05, 10, num_rep=3)
    for d, j in ((dec, jdec), (st, jst)):
        assert tbd.device_syndrome_width(d.device_static, d.device_state) \
            == jbd.device_syndrome_width(j.device_static, j.device_state)


@pytest.mark.parametrize("batch", [8, 96])
def test_bp_batch_device_and_host_postprocess_match_jax(batch):
    code = hgp(rep_code(4), rep_code(5))
    probs = np.full(code.N, 0.06)
    e = (np.random.default_rng(batch).random((batch, code.N)) < 0.06)
    synd = (e.astype(np.uint8) @ code.hx.T % 2).astype(np.uint8)
    dec = tbd.BPDecoder(code.hx, probs, 20, device="cpu")
    got = dec.bp_batch_device(torch.from_numpy(synd))
    want = jbd.BPDecoder(code.hx, probs, 20).bp_batch_device(
        jnp.asarray(synd))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    osd = tbd.BPOSD_Decoder(code.hx, probs, 20, osd_order=4, device="cpu")
    for a, b in zip(osd.bp_batch_device(torch.from_numpy(synd)), got):
        assert torch.equal(a, b)
    corr = got.error
    fm = tbd.FirstMinBPDecoder(code.hx, probs, 5, device="cpu")
    st = tbd.ST_BP_Decoder_syndrome(code.hx, 0.05, 0.05, 10, device="cpu")
    for d in (dec, fm, st):
        assert d.host_postprocess(synd, corr, {}) is corr


def test_sim_common_names():
    assert [f.name for f in dataclasses.fields(tcommon.SimResult)] == \
        [f.name for f in dataclasses.fields(jcommon.SimResult)]
    r = tcommon.SimResult(3, 100, 0.03, None)
    assert r.extra == {}
    keys = [prng_key(s) for s in range(5)]
    assert tcommon.accumulate_device(lambda k: k[1], keys,
                                     lambda a, b: a + b) == sum(
        k[1] for k in keys)
    assert tcommon.accumulate_device(lambda k: 1, [], max) is None
    count = tcommon.accumulate_counts(
        lambda k: torch.tensor(k[1] % 7, dtype=torch.int32), keys)
    assert count == sum(k[1] % 7 for k in keys)
    assert tcommon.accumulate_counts(lambda k: 1, []) == 0
    assert tcommon.timed_host_sync(lambda: 5) == 5
    for s in (0, 3, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            tcommon.key_bytes(prng_key(s)),
            jcommon.key_bytes(jax.random.PRNGKey(s)))
    assert tcommon.run_signature("data", prng_key(4))["key"] == \
        tcommon.key_bytes(prng_key(4)).tolist()


def test_cell_fused_driver_jax_names():
    def stats(generator, cell):
        x = torch.rand((), generator=generator)
        return (x < 0.5).to(torch.int32), torch.zeros((), dtype=torch.int32)

    drv = CellFusedDriver(stats, 2, 8, 2, 9, torch.device("cpu"))
    drv.degrade_mesh()  # one device: nothing to replan
    plan = (np.array([0, 0]), np.array([1, 1]), np.array([0, 1]),
            np.array([True, True]))
    a = drv.read(drv.dispatch_plan(drv._init_fn(), (1, 2), plan))
    b = drv.read(drv.dispatch(drv._init_fn(), (1, 2), plan))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_profiling_and_observability_names(tmp_path):
    cost = profiling.ProgramCost("x", pool_bytes=123)
    assert cost.peak_bytes == 123
    seconds, out = profiling.timeit_async(lambda a: a + 1, 1, reps=3)
    assert out == 2 and seconds >= 0.0
    with observability.profile_trace(str(tmp_path)):
        torch.ones(64).sum()
    (trace,) = tmp_path.iterdir()
    assert profiling.parse_trace(str(trace)) is not None


@pytest.fixture
def tele_on():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


def test_record_bp_aux_off_is_free():
    telemetry.disable()
    telemetry.reset()
    telemetry.record_bp_aux({"converged": np.ones(5, bool),
                             "iterations": np.ones(5)})
    assert "bp.shots" not in telemetry.snapshot()


def test_record_bp_aux_equals_a_numpy_recount(tele_on, monkeypatch):
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_Circuit

    code = hgp(rep_code(3), rep_code(3))
    p = 0.03
    ext = np.hstack([code.hx, np.eye(code.hx.shape[0], dtype=np.uint8)])
    d1 = tbd.BP_Decoder_Class(30, "minimum_sum", 0.625,
                              device="cpu").GetDecoder(
        {"h": ext, "p_data": p, "p_syndrome": p})
    d2 = tbd.BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 4,
                                 device="cpu", device_osd=False
                                 ).GetDecoder({"h": code.hx, "p_data": p})
    ep = {"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": p, "p_idling_gate": 0}
    sim = CodeSimulator_Circuit(code=code, decoder1_z=d1, decoder2_z=d2,
                                p=p, num_cycles=3, error_params=ep,
                                batch_size=128, device="cpu")
    seen = []
    host = tbd.BPOSD_Decoder.host_postprocess

    def spy(self, syndromes, corrections, aux):
        seen.append({k: np.asarray(aux[k]) for k in ("converged",
                                                      "iterations")})
        return host(self, syndromes, corrections, aux)

    monkeypatch.setattr(tbd.BPOSD_Decoder, "host_postprocess", spy)
    sim.WordErrorRate(512, key=(0, 3))
    assert seen
    conv = np.concatenate([s["converged"] for s in seen]).astype(bool)
    its = np.concatenate([s["iterations"] for s in seen])[conv]
    edges = np.asarray(telemetry.ITER_BUCKETS)
    want = np.bincount(np.searchsorted(edges, its),
                       minlength=len(edges) + 1)
    snap = telemetry.snapshot()
    assert snap["bp.shots"]["value"] == conv.size
    assert snap["bp.converged"]["value"] == conv.sum()
    assert snap["bp.iterations"]["counts"] == want.tolist()
    assert snap["bp.iterations"]["sum"] == its.sum()
