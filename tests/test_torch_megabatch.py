"""The megabatch driver's host drain on the CPU (``parallel/shots.py``).

``MegabatchDriver.run_keys`` reads megabatch d's carry while d+1 computes
(on the card a replayed CUDA graph; here the eager loop): it must yield the
carries ``stream`` yields, in the same order, one host read each, and a
``target_failures`` run must stop at the megabatch where reading every
carry at once stops — for both engines, and for the fused engine where the
JAX package's own ``run_keys`` stops.  Tolerance: none (integer counts)."""
import numpy as np
import pytest
import torch

import jax

from qldpc_fault_tolerance_tpu import decoders as jdec
from qldpc_fault_tolerance_tpu.sim import data_error as jde
from qldpc_fault_tolerance_tpu_torch.codes import hgp, ring_code
from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder, BPOSD_Decoder
from qldpc_fault_tolerance_tpu_torch.ops.prng import key_words, split_key
from qldpc_fault_tolerance_tpu_torch.parallel import (
    GeneratorInput,
    KeyInput,
    count_min_driver,
)
from qldpc_fault_tolerance_tpu_torch.parallel.shots import drain_double_buffered
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)

torch.set_num_threads(1)


def _gen_stats(gen):
    u = torch.rand(64, generator=gen, device=gen.device)
    return (u.lt(0.3).sum(dtype=torch.int32),
            (u * 1000).to(torch.int32).min())


def _key_stats(key):
    k0, k1 = key
    return (torch.tensor(k0 % 7, dtype=torch.int32),
            torch.tensor(k1 % 1000, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["generator", "key"])
@pytest.mark.parametrize("k_inner,n_batches", [(1, 3), (2, 5), (4, 8)])
def test_run_keys_yields_the_carries_of_stream(kind, k_inner, n_batches):
    stats, inp = ((_gen_stats, GeneratorInput("cpu")) if kind == "generator"
                  else (_key_stats, KeyInput("cpu")))
    want = [(tuple(int(c) for c in carry), done) for carry, done in
            count_min_driver(stats, 1000, "cpu", k_inner, inp).stream(
                (1, 2), n_batches)]
    driver = count_min_driver(stats, 1000, "cpu", k_inner, inp)
    got = list(driver.run_keys((1, 2), n_batches))
    assert got == want
    assert driver.host_reads == driver.megabatches == len(want)
    assert want[-1][1] == -(-n_batches // k_inner) * k_inner


def test_drain_launches_the_next_item_before_reading_one():
    events = []

    def launch(i):
        events.append(("launch", i))
        return i

    def finish(i):
        events.append(("finish", i))
        return i * 10

    assert list(drain_double_buffered(launch, finish, range(3))) == [0, 10, 20]
    assert events == [("launch", 0), ("launch", 1), ("finish", 0),
                      ("launch", 2), ("finish", 1), ("finish", 2)]


def _eager_stop(driver, key, n_batches, target, *extra):
    """(failures, batches) where reading every megabatch's carry stops."""
    for carry, done in driver.stream(key, n_batches, *extra):
        failures = int(carry[0])
        if failures >= target:
            break
    return failures, done


@pytest.fixture(scope="module")
def code():
    return hgp(ring_code(5), ring_code(5))


def _data_sim(code, fused=False, kind=BPDecoder, **kw):
    probs = np.full(code.N, 0.04)
    return CodeSimulator_DataError(
        code=code, decoder_x=kind(code.hz, probs, 8, device="cpu"),
        decoder_z=kind(code.hx, probs, 8, device="cpu"),
        pauli_error_probs=[0.02] * 3, seed=4, batch_size=64, scan_chunk=2,
        fused_sampler=fused, device="cpu", **kw)


def _phenom_sim(code):
    ext = [np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])
           for h in (code.hz, code.hx)]
    d1 = [BPDecoder(h, np.full(h.shape[1], 0.02), 10, device="cpu")
          for h in ext]
    d2 = [BPOSD_Decoder(h, np.full(code.N, 0.02), 10, osd_order=2,
                        device="cpu") for h in (code.hz, code.hx)]
    return CodeSimulator_Phenon(
        code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
        decoder2_z=d2[1], pauli_error_probs=[0.01] * 3, q=0.02,
        batch_size=64, scan_chunk=2, device="cpu")


@pytest.mark.parametrize("engine", ["data", "data_fused", "phenom"])
def test_target_failures_stops_where_the_eager_loop_stops(code, engine):
    key, target, n_batches = (0, 11), 6, 40
    if engine == "phenom":
        sim = _phenom_sim(code)
        sim.WordErrorRate(3, n_batches * 64, key=key, target_failures=target)
        driver = sim._driver(2)
        extra = (3,)
    else:
        sim = _data_sim(code, fused=engine == "data_fused")
        sim.WordErrorRate(n_batches * 64, key=key, target_failures=target)
        driver = sim._driver(2)
        extra = ()
    failures, done = _eager_stop(driver, key_words(key), n_batches, target,
                                 *extra)
    assert failures >= target and done < n_batches
    assert (sim.last_failures, sim.last_shots) == (failures, done * 64)
    assert sim.last_host_reads == sim.last_megabatches == done // 2


def test_fused_target_failures_matches_jax_run_keys(code):
    """The fused engine draws the JAX engine's errors seed for seed, so a
    target_failures run stops at the JAX engine's megabatch with its
    counts (the WER and min weight of the shots run)."""
    probs = np.full(code.N, 0.04)
    jsim = jde.CodeSimulator_DataError(
        code=code, decoder_x=jdec.BPDecoder(code.hz, probs, 8),
        decoder_z=jdec.BPDecoder(code.hx, probs, 8),
        pauli_error_probs=[0.02] * 3, seed=4, batch_size=64, scan_chunk=2,
        fused_sampler=True)
    want = jsim.WordErrorRate(40 * 64, jax.random.PRNGKey(11), 6)
    sim = _data_sim(code, fused=True)
    got = sim.WordErrorRate(40 * 64, (0, 11), target_failures=6)
    assert sim.last_shots < 40 * 64 and sim.last_failures >= 6
    assert (got, sim.min_logical_weight) == (want, jsim.min_logical_weight)


def test_a_second_run_reuses_the_simulators_driver(code):
    sim = _data_sim(code)
    sim.WordErrorRate(4 * 64, key=(0, 1))
    first = sim._drivers.copy()
    sim.WordErrorRate(4 * 64, key=(0, 2))
    assert sim._drivers == first and len(first) == 1
    key = split_key((0, 5))[0]
    a = _data_sim(code)
    b = _data_sim(code)
    a.WordErrorRate(6 * 64, key=key)
    b.WordErrorRate(2 * 64, key=(9, 9))  # another run first changes nothing
    b.WordErrorRate(6 * 64, key=key)
    assert (a.last_failures, a.last_shots) == (b.last_failures, b.last_shots)
