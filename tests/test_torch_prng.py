"""The port's counter PRNG and key stream against the JAX package.

``threefry2x32``, ``counter_draws``, ``depolarizing_cuts`` and
``_errors_from_draws`` against ``qldpc_fault_tolerance_tpu.ops.gf2_pallas``;
``prng_key``/``split_key``/``fold_in`` against ``jax.random`` itself under
its default ``threefry_partitionable``, so a JAX that changed the rule would
fail here.  Tolerance: none — every word must be equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qldpc_fault_tolerance_tpu.ops import gf2_pallas as gp
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3]


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def test_threefry_matches_jax_on_tensors_and_ints():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64)
    c = rng.integers(0, 2 ** 32, size=(2, 500), dtype=np.uint64)
    want = [np.asarray(x) for x in gp.threefry2x32(
        jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(c[0], jnp.uint32),
        jnp.asarray(c[1], jnp.uint32))]
    got = gk.threefry2x32(int(k[0]), int(k[1]),
                          torch.from_numpy(c[0].astype(np.int64)),
                          torch.from_numpy(c[1].astype(np.int64)))
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(np.int64), g.numpy())
    for i in (0, 17, 499):
        host = gk.threefry2x32(int(k[0]), int(k[1]), int(c[0, i]), int(c[1, i]))
        assert host == (int(want[0][i]), int(want[1][i]))


@pytest.mark.parametrize("B,n", [(96, 13), (200, 225)])
def test_counter_draws_and_errors_match_jax(B, n):
    k0, k1 = 0x9E3779B9, 0x7F4A7C15
    want = np.asarray(gp.counter_draws(jnp.uint32(k0), jnp.uint32(k1), B, n))
    got = gk.counter_draws(k0, k1, B, n, "cpu")
    assert got.dtype == torch.int64
    assert np.array_equal(want.astype(np.int64), got.numpy())
    cuts = gp.depolarizing_cuts((0.1, 0.05, 0.2))
    jx, jz = gp._errors_from_draws(jnp.asarray(want), jnp.asarray(cuts))
    tx, tz = gk._errors_from_draws(got, gk.depolarizing_cuts((0.1, 0.05, 0.2)))
    assert np.array_equal(np.asarray(jx), tx.numpy())
    assert np.array_equal(np.asarray(jz), tz.numpy())
    assert 0 < tx.sum() < B * n and 0 < tz.sum() < B * n


@pytest.mark.parametrize("probs", [(0.01, 0.01, 0.01), (0.0, 0.0, 0.0),
                                   (0.5, 0.25, 0.25), (0.2, 0.3, 0.1)])
def test_depolarizing_cuts_match_jax(probs):
    assert np.array_equal(gp.depolarizing_cuts(probs),
                          gk.depolarizing_cuts(probs))
    assert gk.depolarizing_cuts(probs).dtype == np.uint32


def test_depolarizing_cuts_reject_probabilities_above_one():
    with pytest.raises(ValueError):
        gk.depolarizing_cuts((0.5, 0.5, 0.2))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_stream_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    assert gk.prng_key(seed) == _words(key)
    for num in (2, 3):
        want = np.asarray(jax.random.key_data(jax.random.split(key, num)))
        got = gk.split_key(gk.prng_key(seed), num)
        assert [tuple(int(w) for w in row) for row in want] == list(got)
    base, sub = jax.random.split(key)
    assert gk.split_key(gk.prng_key(seed)) == (_words(base), _words(sub))
    for d in (0, 1, 5, 2 ** 32 - 1):
        assert gk.fold_in(_words(sub), d) == _words(jax.random.fold_in(sub, d))


def test_key_words_accepts_arrays_and_rejects_other_shapes():
    key = jax.random.PRNGKey(3)
    assert gk.key_words(np.asarray(jax.random.key_data(key))) == (0, 3)
    assert gk.key_words(torch.tensor([1, 2])) == (1, 2)
    with pytest.raises(ValueError):
        gk.key_words((1, 2, 3))
    with pytest.raises(ValueError):
        gk.key_words((1, 2 ** 32))


def test_errors_at_the_cut_boundaries_match_jax():
    cuts = gk.depolarizing_cuts((0.1, 0.05, 0.2))
    r = np.unique(np.clip(np.add.outer(cuts.astype(np.int64), [-1, 0, 1]),
                          0, 2 ** 32 - 1)).astype(np.uint32)
    jx, jz = gp._errors_from_draws(jnp.asarray(r), jnp.asarray(cuts))
    tx, tz = gk._errors_from_draws(torch.from_numpy(r.astype(np.int64)), cuts)
    assert np.array_equal(np.asarray(jx), tx.numpy())
    assert np.array_equal(np.asarray(jz), tz.numpy())
