"""The port's shot mesh (``parallel/shots.py``, ``sim/common.py``
``mesh_batch_stats``) against the JAX package's, on the CPU.

A ``ShotMesh`` may name one device many times: ``["cpu"] * n`` is the
port's counterpart of the JAX tests' virtual CPU devices
(``tests/conftest.py``).

  * ``split_keys_for_mesh`` and the device-side mesh keys equal JAX's
    ``jax.random.split`` word for word at n = 1, 2 and 8; ``replay_fold``
    equals JAX's on seeded inputs (float32 moments bit for bit: both sum in
    device order).
  * ``sharded_batch_stats`` equals the sum of per-device runs, and each of
    the five engines' mesh WER on a logical mesh of 2 equals its unsharded
    replay (the engine's one-batch unit under every device's key, summed):
    counts and min weight bit for bit (JAX ``tests/test_parallel.py``).
    ``degrade_mesh()`` (the replay runner) gives the same counts.
  * The fused v2 counter-PRNG data engine on ``["cpu"] * 8`` equals the JAX
    package's 8-device mesh seed for seed: same keys, same counter stream,
    failures and min weight identical.
  * The refusals: ``target_failures`` and weighted or stratified runs with
    a mesh raise; a mesh naming a card raises without one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qldpc_fault_tolerance_tpu import parallel as jpar
from qldpc_fault_tolerance_tpu.decoders import BPDecoder as JBPDecoder
from qldpc_fault_tolerance_tpu.sim import data_error as jde
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BPDecoder,
    ST_BP_Decoder_Circuit,
    ST_BP_Decoder_syndrome,
)
from qldpc_fault_tolerance_tpu_torch.ops.prng import (
    _as_int32,
    mesh_key,
    mesh_keys_device,
)
from qldpc_fault_tolerance_tpu_torch.parallel import (
    ShotMesh,
    batch_generator,
    replay_fold,
    sharded_batch_stats,
    shot_mesh,
    split_keys_for_mesh,
)
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_Circuit,
    CodeSimulator_Circuit_SpaceTime,
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
    CodeSimulator_Phenon_SpaceTime,
)
from qldpc_fault_tolerance_tpu_torch.sim.common import ShotBatcher

torch.set_num_threads(1)

CODE = hgp(rep_code(3), rep_code(3))
MESH2 = shot_mesh(["cpu"] * 2)


def _words(keys) -> list:
    return [tuple(int(w) for w in np.asarray(jax.random.key_data(k)
                                             if jnp.issubdtype(
                                                 k.dtype,
                                                 jax.dtypes.prng_key)
                                             else k, np.uint32))
            for k in keys]


@pytest.mark.parametrize("n", [1, 2, 8])
def test_split_keys_for_mesh_equals_jax(n):
    jmesh = jpar.shot_mesh(jax.devices()[:n])
    for seed in (0, 7, 2 ** 31 + 5):
        want = _words(jpar.split_keys_for_mesh(jax.random.PRNGKey(seed),
                                               jmesh))
        got = split_keys_for_mesh((0, seed & 0xFFFFFFFF), shot_mesh(
            ["cpu"] * n))
        assert [tuple(k) for k in got] == want


@pytest.mark.parametrize("n", [1, 2, 8])
def test_device_mesh_keys_equal_jax_split_of_folded_key(n):
    key = jax.random.PRNGKey(11)
    j = torch.arange(5, dtype=torch.int64) + 3
    base = torch.tensor((0, 11), dtype=torch.int64)
    for d in range(n):
        want = [_words(jax.random.split(jax.random.fold_in(key, int(i)),
                                        n))[d] for i in j]
        assert [mesh_key((0, 11), int(i), d) for i in j] == want
        got = mesh_keys_device(base, j, d)
        assert torch.equal(got, _as_int32(torch.tensor(want,
                                                       dtype=torch.int64)))


@pytest.mark.parametrize("n_w,has_tele", [(0, False), (4, False), (4, True)])
def test_replay_fold_equals_jax(n_w, has_tele):
    rng = np.random.default_rng(n_w + has_tele)
    outs = []
    for _ in range(5):
        out = [np.int32(rng.integers(0, 1000)), np.int32(rng.integers(0, 50))]
        out += [np.float32(rng.random()) for _ in range(n_w)]
        if has_tele:
            out.append(rng.integers(0, 9, 6).astype(np.int32))
        outs.append(tuple(out))
    want = jpar.replay_fold([tuple(jnp.asarray(x) for x in o) for o in outs],
                            n_w=n_w, has_tele=has_tele)
    got = replay_fold(outs, n_w=n_w, has_tele=has_tele)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


def _data(mesh=None, batch_size=64, seed=0, fused=False, p=0.05):
    dx = BPDecoder(CODE.hz, np.full(CODE.N, p), 10, device="cpu")
    dz = BPDecoder(CODE.hx, np.full(CODE.N, p), 10, device="cpu")
    return CodeSimulator_DataError(
        code=CODE, decoder_x=dx, decoder_z=dz,
        pauli_error_probs=[p / 3] * 3, batch_size=batch_size, seed=seed,
        fused_sampler=fused, device="cpu", mesh=mesh)


def test_sharded_count_matches_per_device_runs():
    sim = _data(batch_size=32)
    keys = split_keys_for_mesh((0, 3), MESH2)
    run = sharded_batch_stats(
        lambda k, dev: sim._stats(batch_generator(k, 0, dev)), MESH2)
    total, min_w = run(keys)
    assert total == sum(int(sim.run_batch(k, 32).sum()) for k in keys)
    assert isinstance(total, int) and 0 <= min_w <= CODE.N


def _replay(stats, num_samples, key, batch_size, n=2):
    """The mesh run's shot stream unsharded: every batch's unit under each
    device's key, summed and min-reduced."""
    batcher = ShotBatcher(num_samples, batch_size * n)
    count, min_w = 0, CODE.N
    for i in range(batcher.num_batches):
        for d in range(n):
            c, w = stats(batch_generator(mesh_key(key, i, d), 0, "cpu"))
            count, min_w = count + int(c), min(min_w, int(w))
    return count, min_w, batcher.total


def _phenom(mesh, p=0.04, q=0.04):
    m = CODE.hx.shape[0]
    ext = lambda h: np.hstack([h, np.eye(m, dtype=np.uint8)])  # noqa: E731
    pr = np.concatenate([np.full(CODE.N, p), np.full(m, q)])
    return CodeSimulator_Phenon(
        code=CODE, decoder1_x=BPDecoder(ext(CODE.hz), pr, 8, device="cpu"),
        decoder1_z=BPDecoder(ext(CODE.hx), pr, 8, device="cpu"),
        decoder2_x=BPDecoder(CODE.hz, np.full(CODE.N, p), 8, device="cpu"),
        decoder2_z=BPDecoder(CODE.hx, np.full(CODE.N, p), 8, device="cpu"),
        pauli_error_probs=[p / 3] * 3, q=q, batch_size=32, device="cpu",
        mesh=mesh)


def _phenom_st(mesh, p=0.03, q=0.03, num_rep=2):
    def st(h):
        return ST_BP_Decoder_syndrome(h, p, q, 8, num_rep=num_rep,
                                      device="cpu")
    return CodeSimulator_Phenon_SpaceTime(
        code=CODE, decoder1_x=st(CODE.hz), decoder1_z=st(CODE.hx),
        decoder2_x=BPDecoder(CODE.hz, np.full(CODE.N, p), 8, device="cpu"),
        decoder2_z=BPDecoder(CODE.hx, np.full(CODE.N, p), 8, device="cpu"),
        pauli_error_probs=[p / 3] * 3, q=q, num_rep=num_rep, batch_size=32,
        device="cpu", mesh=mesh)


EP = {"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": 1, "p_idling_gate": 0}


def _circuit(mesh, p=0.01):
    code = hgp(rep_code(3), rep_code(3))
    m = code.hx.shape[0]
    ext = np.hstack([code.hx, np.eye(m, dtype=np.uint8)])
    sim = CodeSimulator_Circuit(
        code=code, decoder1_z=BPDecoder(ext, np.full(code.N + m, p), 8,
                                        device="cpu"),
        decoder2_z=BPDecoder(code.hx, np.full(code.N, p), 8, device="cpu"),
        p=p, num_cycles=3, error_params=EP, batch_size=32, device="cpu",
        mesh=mesh)
    sim._ensure_circuit()
    return sim


def _circuit_st(mesh, p=0.01):
    code = hgp(rep_code(3), rep_code(3))
    sim = CodeSimulator_Circuit_SpaceTime(
        code=code, p=p, num_cycles=7, num_rep=3, error_params=EP,
        batch_size=32, device="cpu", mesh=mesh)
    sim._generate_circuit()
    sim._generate_circuit_graph()
    g = sim.circuit_graph
    sim.decoder1_z = ST_BP_Decoder_Circuit(g["h1"], g["channel_ps1"], 8,
                                           device="cpu")
    sim.decoder2_z = ST_BP_Decoder_Circuit(g["h2"], g["channel_ps2"], 8,
                                           device="cpu")
    sim._ensure_ready()
    return sim


# engine -> (builder, WordErrorRate arguments, the one-batch unit)
ENGINES = {
    "data": (_data, (), lambda s: s._stats),
    "phenom": (_phenom, (5,), lambda s: lambda g: s._batch_stats(g, 5)),
    "phenom_st": (_phenom_st, (5,),
                  lambda s: lambda g: s._batch_stats(g, 3)),
    "circuit": (_circuit, (), lambda s: s._batch_stats),
    "circuit_st": (_circuit_st, (), lambda s: s._batch_stats),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_mesh_wer_equals_unsharded_replay(engine):
    build, args, unit = ENGINES[engine]
    key = (0, 11)
    sim_m = build(MESH2)
    wer_m = sim_m.WordErrorRate(*args, 256, key=key)
    sim_s = build(None)
    count, min_w, total = _replay(unit(sim_s), 256, key, sim_s.batch_size)
    assert (sim_m.last_failures, sim_m.last_shots) == (count, total)
    assert sim_m.min_logical_weight == min(sim_m.N, min_w)
    # the denominator is batch_size * n_dev a batch; one megabatch a
    # device, one host read each
    assert [r["host_reads"] for r in sim_m.last_mesh] == [1, 1]
    assert sim_m.last_dispatches == 2
    # the replay runner (degrade_mesh): the same streams in turn, one device
    sim_r = build(MESH2)
    sim_r.degrade_mesh()
    assert sim_r.WordErrorRate(*args, 256, key=key) == wer_m
    assert (sim_r.last_failures, sim_r.min_logical_weight) == (
        count, sim_m.min_logical_weight)
    assert {r["device"] for r in sim_r.last_mesh} == {"cpu"}


def test_mesh_runs_reuse_their_replicas_until_the_state_changes():
    sim = _data(MESH2, seed=4)
    sim.WordErrorRate(256)
    reps = dict(sim._mesh_replicas)
    sim.WordErrorRate(256)
    assert {k: id(v[1]) for k, v in sim._mesh_replicas.items()} == {
        k: id(v[1]) for k, v in reps.items()}
    # a replica on its engine's own device shares the engine's state
    (_, rep), = [v for k, v in reps.items() if k[1] == 0]
    assert rep.decoder_x is sim.decoder_x and rep._hx_par is sim._hx_par
    assert rep._drivers is not sim._drivers and rep._stats.__self__ is rep
    sim.decoder_x = BPDecoder(CODE.hz, np.full(CODE.N, 0.05), 10,
                              device="cpu")
    sim.WordErrorRate(256)
    assert all(sim._mesh_replicas[k][1] is not v[1] for k, v in reps.items())


def test_fused_v2_mesh_of_eight_equals_jax_mesh_seed_for_seed():
    """The counter-PRNG engine's unit under a key is the JAX fused v2
    unit's, so the 8-entry mesh matches JAX's 8-device mesh exactly."""
    p = 0.05
    jsim = jde.CodeSimulator_DataError(
        code=CODE, decoder_x=JBPDecoder(CODE.hz, np.full(CODE.N, p), 10),
        decoder_z=JBPDecoder(CODE.hx, np.full(CODE.N, p), 10),
        pauli_error_probs=[p / 3] * 3, batch_size=64, seed=0,
        fused_sampler="v2", mesh=jpar.shot_mesh())
    mesh8 = shot_mesh(["cpu"] * 8)
    sim = _data(mesh8, fused="v2")
    for key in (1, 12):
        wer_j, _ = jsim.WordErrorRate(2048, key=jax.random.PRNGKey(key))
        wer_t, _ = sim.WordErrorRate(2048, key=(0, key))
        assert sim.last_shots == 2048 and wer_t == wer_j
        assert sim.min_logical_weight == jsim.min_logical_weight
    assert sim.last_failures > 0


def test_mesh_refuses_what_it_does_not_shard():
    from qldpc_fault_tolerance_tpu_torch.rare.estimator import stratified_wer

    sim = _data(MESH2)
    with pytest.raises(ValueError, match="no mesh"):
        sim.WordErrorRate(256, target_failures=3)
    with pytest.raises(ValueError, match="no mesh"):
        sim.WeightedWordErrorRate(256)
    with pytest.raises(ValueError, match="no mesh"):
        stratified_wer(sim, [1, 2], 64)
    with pytest.raises(ValueError, match="no mesh"):
        _phenom(MESH2).WordErrorRate(3, 128, target_failures=2)
    with pytest.raises(ValueError, match="no mesh"):
        _phenom(MESH2).WeightedWordErrorRate(3, 128)
    with pytest.raises(TypeError, match="ShotMesh"):
        _data(mesh=["cpu", "cpu"])


def test_shot_mesh_is_hashable_and_refuses_a_missing_card():
    assert shot_mesh(["cpu", "cpu"]) == ShotMesh((torch.device("cpu"),) * 2)
    assert MESH2.size == 2 and hash(MESH2) == hash(shot_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="at least one"):
        shot_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shot_mesh(["cuda:0", "cuda:0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shot_mesh()
