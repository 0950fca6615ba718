"""The port's decode sessions (``serve/session.py``) on the CPU, against its
own offline ``decode_device`` and against the JAX package's
``DecodeSession``.

  * A session pads each chunk to its bucket and chunks past the top one;
    every served row equals the offline ``decode_device`` of the same rows
    padded into the same bucket.  Tolerance: none.
  * Port session against JAX session on the same numpy syndromes
    (hgp_34_n225, BP-50 min-sum): corrections and ``converged`` identical
    except on near-tie shots (some JAX posterior |LLR| < 1e-3, where
    summation order may flip a hard decision), at most 1% of shots, as
    ``tests/test_torch_bp.py`` holds BP; BPOSD-E (order 10) the same rule,
    as ``tests/test_torch_slice.py`` holds OSD (its solutions may differ
    only through such ties).
  * ``FusedDecodeGroup`` rounds equal each member's own session, the
    session cache evicts and rebuilds, ``heal()`` swaps atomically while
    another thread decodes, a warm path builds no program, a sharded
    session equals the plain one.  Tolerance: none.
"""
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_fault_tolerance_tpu.decoders import BP_Decoder_Class as JBP
from qldpc_fault_tolerance_tpu.decoders import BPOSD_Decoder_Class as JBPOSD
from qldpc_fault_tolerance_tpu.decoders.bp_decoders import \
    decode_device as jax_decode_device
from qldpc_fault_tolerance_tpu.serve import DecodeSession as JaxSession
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPDecoder,
    BPOSD_Decoder_Class,
    decode_device,
)
from qldpc_fault_tolerance_tpu_torch.parallel import shot_mesh
from qldpc_fault_tolerance_tpu_torch.serve import (
    DecodeSession,
    FusedDecodeGroup,
    SessionCache,
    StreamProtocolError,
    StreamSession,
    bucket_family,
)
from qldpc_fault_tolerance_tpu_torch.utils import progcache, telemetry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (32, 64, 128)
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def hx():
    return load_code(os.path.join(REPO, "codes_lib_tpu",
                                  "hgp_34_n225.npz")).hx


def _classes(hx):
    n = hx.shape[1]
    return (BP_Decoder_Class(n / 50, "minimum_sum", 0.625, device="cpu"),
            BPOSD_Decoder_Class(n / 50, "minimum_sum", 0.625, "osd_e", 10,
                                device="cpu"))


def _session(hx, p, name="s", osd=False, **kw):
    cls = _classes(hx)[1 if osd else 0]
    return DecodeSession(name, decoder_class=cls,
                         params={"h": hx, "p_data": p},
                         buckets=kw.pop("buckets", BUCKETS), **kw)


def _synd(hx, k, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((k, hx.shape[1])) < p).astype(np.uint8)
    return (err @ hx.T % 2).astype(np.uint8)


def _offline(sess, synd):
    """The offline decode of ``synd`` chunk by chunk, each chunk padded
    into the bucket the session gives it."""
    top = sess.buckets[-1]
    out = []
    for lo in range(0, synd.shape[0], top):
        chunk = synd[lo:lo + top]
        pad = np.zeros((sess.bucket_for(chunk.shape[0]), synd.shape[1]),
                       np.uint8)
        pad[:chunk.shape[0]] = chunk
        cor, _aux = decode_device(sess.static, sess.state,
                                  torch.from_numpy(pad))
        out.append(cor.numpy()[:chunk.shape[0]])
    return np.concatenate(out)


def test_session_equals_offline_padded_and_chunked(hx):
    sess = _session(hx, 0.03)
    synd = _synd(hx, 300, 0.03, 0)
    for k in (1, 31, 40, 128, 300):
        out = sess.decode(synd[:k])
        assert out.shots == k and out.corrections.shape == (k, hx.shape[1])
        assert out.padded_shots == sum(out.buckets)
        assert np.array_equal(out.corrections, _offline(sess, synd[:k]))
    assert sess.decode(synd).buckets == (128, 128, 64)
    assert set(sess.bucket_variants.values()) == {"xla_twin"}


def test_session_rejects_bad_input(hx):
    sess = _session(hx, 0.03)
    with pytest.raises(ValueError):
        sess.decode(np.zeros((0, hx.shape[0]), np.uint8))
    with pytest.raises(ValueError):
        sess.decode(np.zeros((4, hx.shape[0] + 1), np.uint8))
    with pytest.raises(ValueError):
        DecodeSession("x", buckets=BUCKETS)
    with pytest.raises(ValueError):
        _session(hx, 0.03, buckets=())


def _jax_posterior(jsess, synd, bucket):
    pad = np.zeros((bucket, synd.shape[1]), np.uint8)
    pad[:synd.shape[0]] = synd
    _cor, aux = jax_decode_device(jsess.static, jsess.state,
                                  jnp.asarray(pad))
    return np.asarray(aux["posterior_llr"])[:synd.shape[0]]


@pytest.mark.parametrize("osd,p", [(False, 0.03), (True, 0.05)],
                         ids=["bp", "bposd_e"])
def test_session_matches_jax_session(hx, osd, p):
    n = hx.shape[1]
    jcls = (JBPOSD(n / 50, "minimum_sum", 0.625, "osd_e", 10) if osd
            else JBP(n / 50, "minimum_sum", 0.625))
    params = {"h": hx, "p_data": p}
    jsess = JaxSession("s", decoder_class=jcls, params=params,
                       buckets=(128,))
    sess = _session(hx, p, osd=osd, buckets=(128,))
    assert sess.syndrome_width == jsess.syndrome_width
    assert sess.kernel_variant == jsess.kernel_variant == "xla_twin"
    assert sess.osd_backend == jsess.osd_backend
    synd = _synd(hx, 200, p, 5)
    got, want = sess.decode(synd), jsess.decode(synd)
    assert got.buckets == want.buckets == (128, 128)
    tie = np.concatenate([
        (np.abs(_jax_posterior(jsess, synd[lo:lo + 128], 128)) < 1e-3)
        .any(axis=1) for lo in (0, 128)])
    assert tie.mean() <= 0.01
    ok = ~tie
    assert np.array_equal(got.corrections[ok], want.corrections[ok])
    assert np.array_equal(got.converged[ok], want.converged[ok])
    if osd:
        # every served correction reproduces its syndrome
        assert np.array_equal(got.corrections @ hx.T % 2, synd)


def test_fused_group_equals_member_sessions(hx):
    members = [_session(hx, p, name=f"m{i}")
               for i, p in enumerate((0.01, 0.02, 0.03))]
    assert len({bucket_family(s) for s in members}) == 1
    group = FusedDecodeGroup(members)
    assert group.warm(64) == 2 * 2  # lanes 2-3 x buckets 32, 64
    parts = [(2, _synd(hx, 50, 0.03, 1)), (0, _synd(hx, 20, 0.01, 2))]
    outs = group.decode(parts)
    for (i, synd), out in zip(parts, outs):
        assert out.buckets == (64,)
        pad = np.zeros((64, synd.shape[1]), np.uint8)
        pad[:synd.shape[0]] = synd
        own = members[i].decode(pad)
        assert np.array_equal(out.corrections,
                              own.corrections[:synd.shape[0]])
        assert np.array_equal(out.converged, own.converged[:synd.shape[0]])
    with pytest.raises(ValueError):
        group.decode([(0, parts[0][1]), (0, parts[1][1])])
    # a member's heal restacks into the same buffers: no new program
    compiles = group.compiles
    members[2].heal("test")
    assert group.ensure_fresh() is True
    assert group.compiles == compiles
    again = group.decode(parts)
    for a, b in zip(outs, again):
        assert np.array_equal(a.corrections, b.corrections)


def test_fused_group_needs_one_family(hx):
    a = _session(hx, 0.01, name="a")
    b = _session(hx, 0.01, name="b", buckets=(32, 64))
    with pytest.raises(ValueError):
        FusedDecodeGroup([a, b])
    with pytest.raises(ValueError):
        FusedDecodeGroup([a])


def test_session_cache_eviction_and_rebuild(hx):
    cache = SessionCache(max_sessions=2)
    built = []

    def factory(name, p):
        def make():
            built.append(name)
            return _session(hx, p, name=name)
        return make

    a = cache.get_or_create("a", factory("a", 0.01))
    cache.get_or_create("b", factory("b", 0.02))
    assert cache.get_or_create("a", factory("a", 0.01)) is a
    cache.get_or_create("c", factory("c", 0.03))  # evicts b
    assert sorted(cache.names()) == ["a", "c"] and "b" not in cache
    with pytest.raises(KeyError):
        cache.get("b")
    b2 = cache.get_or_create("b", factory("b", 0.02))
    assert built == ["a", "b", "c", "b"] and len(cache) == 2
    synd = _synd(hx, 20, 0.02, 3)
    assert np.array_equal(b2.decode(synd).corrections, _offline(b2, synd))


def test_heal_swaps_atomically_while_another_thread_decodes(hx):
    sess = _session(hx, 0.02)
    sess.warm()
    synd = _synd(hx, 60, 0.02, 4)
    want = sess.decode(synd).corrections
    stop = threading.Event()
    errors, rounds = [], [0]

    def decode_loop():
        try:
            while not stop.is_set():
                if not np.array_equal(sess.decode(synd).corrections, want):
                    errors.append("differs")
                rounds[0] += 1
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    th = threading.Thread(target=decode_loop)
    th.start()
    try:
        gen = sess.generation
        progcache.clear_memory()  # the heal rebuilds every program
        compiles = sess.compiles
        assert sess.heal("test") == len(BUCKETS)
        assert sess.heal("again") == len(BUCKETS)  # from the cache now
    finally:
        stop.set()
        th.join(timeout=TIMEOUT)
    assert not th.is_alive() and not errors and rounds[0] > 0
    assert sess.generation == gen + 2 and sess.heals == 2
    assert sess.compiles == compiles + len(BUCKETS)
    assert sess.loads >= len(BUCKETS)
    assert np.array_equal(sess.decode(synd).corrections, want)


def test_warm_path_builds_no_program(hx):
    telemetry.enable()
    try:
        sess = _session(hx, 0.02, name="warm")
        assert sess.warm(40) == [32, 64]
        compiles, stats = sess.compiles, progcache.stats()
        for k in (1, 30, 64, 50):
            sess.decode(_synd(hx, k, 0.02, k))
        assert sess.compiles == compiles
        assert progcache.stats()["misses"] == stats["misses"]
        snap = telemetry.snapshot()
        assert snap["serve.session.hits"]["value"] >= 4
    finally:
        telemetry.disable()
        telemetry.reset()


def test_invalidate_rebuilds_state_from_decoder_snapshot(hx):
    n = hx.shape[1]
    dec = BPDecoder(hx, np.full(n, 0.02), 50, device="cpu")
    sess = DecodeSession("d", decoder=dec, buckets=BUCKETS)
    synd = _synd(hx, 40, 0.02, 6)
    want = sess.decode(synd).corrections
    old = sess.state["llr0"]
    sess.invalidate(stale_artifact=True)
    assert sess.state["llr0"] is not old and sess.generation == 1
    assert torch.equal(sess.state["llr0"], old)
    assert np.array_equal(sess.decode(synd).corrections, want)


def test_sharded_session_equals_plain(hx):
    sess = _session(hx, 0.03, mesh=shot_mesh(["cpu", "cpu"]),
                    buckets=(32, 64, 96))
    sess.warm()
    synd = _synd(hx, 90, 0.03, 8)
    plain = sess.decode(synd[:50]).corrections
    telemetry.enable()
    try:
        assert sess.shard() is True and sess.sharded
        assert sess.decode(synd[:50]).corrections.tolist() == plain.tolist()
        sess.decode(synd)  # bucket 96: the mesh divides it
        sess.decode(synd[:20])  # bucket 32 too
        assert sess.unshard() is True and not sess.sharded
    finally:
        telemetry.disable()
        telemetry.reset()
    keys = sess.warm_keys()
    assert [64, True] in keys and [96, True] in keys
    assert np.array_equal(sess.decode(synd).corrections, _offline(sess, synd))


def test_stream_session_protocol(hx):
    sess = _session(hx, 0.02)
    stream = StreamSession("st", sess, lanes=4)
    synd = _synd(hx, 4, 0.02, 9)
    kind, chunk = stream.prepare(1, synd)
    assert kind == "decode"
    with pytest.raises(StreamProtocolError) as busy:
        stream.prepare(1, synd)
    assert busy.value.code == "busy"
    out = sess.decode(chunk)
    payload = stream.commit(1, out.corrections, out.converged)
    assert payload["committed"] == 1
    assert stream.prepare(1, synd)[0] == "replay"
    with pytest.raises(StreamProtocolError) as gap:
        stream.prepare(3, synd)
    assert gap.value.code == "gap"
    assert np.array_equal(stream.frame(), out.corrections)
    state = stream.export_state()
    other = StreamSession("st", sess, lanes=4)
    assert other.import_state(state) and other.committed == 1
    assert stream.close()["committed"] == 1
