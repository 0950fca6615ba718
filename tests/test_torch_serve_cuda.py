"""The port's serve stack on the card: a session's captured CUDA graph per
bucket against the eager decode, served shots against the offline
``decode_device`` at their bucket (and after a row permutation), fused
rounds against each member's program, a capture while another thread
replays, and a ``device_restart`` chaos enactment that ends in a recapture
with every request answered once.

These tests need an NVIDIA GPU (the graphs and the kernels have no CPU
mode) and skip without one; run them on a machine with a card:
``python -m pytest tests/test_torch_serve_cuda.py --noconftest``.
Tolerance: none — every comparison is bit for bit.
"""
import os
import threading

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPOSD_Decoder_Class,
    decode_device,
)
from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
from qldpc_fault_tolerance_tpu_torch.serve import (
    ContinuousBatcher,
    DecodeSession,
    FusedDecodeGroup,
    HealthProbe,
)
from qldpc_fault_tolerance_tpu_torch.utils import (
    faultinject,
    progcache,
    resilience,
    telemetry,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda
BUCKETS = (32, 64, 128, 256, 512)
TIMEOUT = 120.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: captured graphs and the CUDA "
                    "kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def hx():
    return load_code(os.path.join(REPO, "codes_lib_tpu",
                                  "hgp_34_n625.npz")).hx


def _bp(dev, n):
    return BP_Decoder_Class(n / 50, "minimum_sum", 0.625, device=dev)


def _session(name, dev, hx, p, osd=False):
    n = hx.shape[1]
    cls = (BPOSD_Decoder_Class(n / 50, "minimum_sum", 0.625, "osd_e", 10,
                               device=dev) if osd else _bp(dev, n))
    return DecodeSession(name, decoder_class=cls,
                         params={"h": hx, "p_data": p}, buckets=BUCKETS)


def _synd(hx, k, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((k, hx.shape[1])) < p).astype(np.uint8)
    return (err @ hx.T % 2).astype(np.uint8)


def _offline(sess, synd, bucket):
    """decode_device of ``synd`` padded into ``bucket``, eagerly."""
    pad = np.zeros((bucket, synd.shape[1]), np.uint8)
    pad[:synd.shape[0]] = synd
    cor, aux = decode_device(sess.static, sess.state,
                             torch.from_numpy(pad).to(sess.device))
    return (cor.cpu().numpy()[:synd.shape[0]],
            aux["converged"].cpu().numpy()[:synd.shape[0]])


@pytest.mark.parametrize("osd", [False, True])
def test_each_bucket_graph_equals_eager_decode(cuda, hx, osd):
    sess = _session("s", cuda, hx, 0.05 if osd else 0.01, osd=osd)
    sess.warm()
    built = sess.compiles + sess.loads  # loads: an equal state's programs
    assert built == len(BUCKETS)
    for bucket in BUCKETS:
        synd = _synd(hx, bucket, 0.05 if osd else 0.01, bucket)
        out = sess.decode(synd)
        assert out.buckets == (bucket,)
        cor, conv = _offline(sess, synd, bucket)
        assert np.array_equal(out.corrections, cor)
        assert np.array_equal(out.converged, conv)
        want = "sparse_gather" if bucket % 256 == 0 else "xla_twin"
        assert sess.bucket_variants[bucket] == want
    assert sess.compiles + sess.loads == built  # the warm path built nothing


@pytest.mark.parametrize("osd,p,k", [
    (False, 0.02, 300),  # bucket 512: the bf16 head
    (True, 0.05, 100),   # bucket 128: float32 kernel 1, then OSD-E
    (True, 0.05, 300),   # bucket 512: the bf16 head, then OSD-E
])
def test_served_shots_equal_offline_at_bucket_and_under_permutation(
        cuda, hx, osd, p, k):
    sess = _session("s", cuda, hx, p, osd=osd)
    synd = _synd(hx, k, p, 1)
    bucket = 512 if k > 256 else 128
    out = sess.decode(synd)
    assert out.buckets == (bucket,)
    cor, conv = _offline(sess, synd, bucket)
    assert np.array_equal(out.corrections, cor)
    assert np.array_equal(out.converged, conv)
    elim = tod.osd_elim.launches
    perm = np.random.default_rng(2).permutation(k)
    permuted = sess.decode(synd[perm])
    assert np.array_equal(permuted.corrections, out.corrections[perm])
    assert np.array_equal(permuted.converged, out.converged[perm])
    if osd:  # BP failed somewhere, so OSD-E decided those shots
        assert not out.converged.all()
        assert tod.osd_elim.launches > elim
    head = bk.bp_head_bf16.launches
    sess.decode(synd)
    assert (bk.bp_head_bf16.launches > head) == (bucket >= 256)


def test_fused_round_equals_member_programs(cuda, hx):
    params = [{"h": hx, "p_data": p} for p in (0.01, 0.013, 0.016)]
    members = [DecodeSession(f"m{i}", decoder_class=_bp(cuda, hx.shape[1]),
                             params=pm, buckets=BUCKETS)
               for i, pm in enumerate(params)]
    group = FusedDecodeGroup(members)
    group.warm(512)
    parts = [(i, _synd(hx, k, 0.013, 10 + i))
             for i, k in ((0, 200), (1, 64))]

    def own(sess, synd):
        return sess.decode(np.concatenate(
            [synd, np.zeros((256 - synd.shape[0], synd.shape[1]),
                            np.uint8)])).corrections[:synd.shape[0]]

    outs = group.decode(parts)
    for (i, synd), out in zip(parts, outs):
        assert np.array_equal(out.corrections, own(members[i], synd))
    # a member's heal to other per-lane values (a non-uniform channel) is
    # copied into the stacked buffers: the same graphs, the new values
    before = own(members[1], parts[1][1])
    params[1]["p_data"] = np.random.default_rng(5).uniform(
        0.001, 0.1, hx.shape[1])
    compiles = group.compiles
    members[1].heal("test")
    assert group.ensure_fresh()
    outs2 = group.decode(parts)
    assert group.compiles == compiles
    fresh = DecodeSession("fresh", decoder_class=_bp(cuda, hx.shape[1]),
                          params=dict(params[1]), buckets=BUCKETS)
    want = own(fresh, parts[1][1])
    assert not np.array_equal(want, before)  # the heal changed answers
    assert np.array_equal(outs2[1].corrections, want)
    assert np.array_equal(outs2[0].corrections, outs[0].corrections)


def test_capture_while_another_thread_replays(cuda, hx):
    sess = _session("s", cuda, hx, 0.01)
    sess.warm(64)
    synd = _synd(hx, 64, 0.01, 3)
    want = sess.decode(synd).corrections
    stop = threading.Event()
    errors, rounds = [], [0]

    def replay():
        try:
            while not stop.is_set():
                if not np.array_equal(sess.decode(synd).corrections, want):
                    errors.append("replay differs")
                rounds[0] += 1
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    th = threading.Thread(target=replay)
    th.start()
    try:
        other = _session("t", cuda, hx, 0.02)
        other.warm(512)  # captures while the first session replays
        progcache.clear_memory()
        sess.heal("test")  # and a heal's recapture, too
    finally:
        stop.set()
        th.join(timeout=TIMEOUT)
    assert not th.is_alive()
    assert not errors, errors
    assert rounds[0] > 0
    assert np.array_equal(sess.decode(synd).corrections, want)


def test_device_restart_chaos_recaptures_and_answers_every_request(
        cuda, hx):
    sess = _session("s", cuda, hx, 0.01)
    bat = ContinuousBatcher({"s": sess}, max_batch_shots=256,
                            max_wait_s=0.002)
    bat.warm()
    prev = resilience.current_policy()
    resilience.set_default_policy(resilience.RetryPolicy(
        max_attempts=4, base_delay=0.01, max_delay=0.05, reset_caches=False))
    plan = faultinject.FaultPlan([faultinject.Fault(
        site="serve_dispatch", kind="device_restart", after=1)])
    captures = telemetry.compile_stats()["cuda.graph_captures"]
    epoch = resilience.device_epoch()
    synds = [_synd(hx, 40, 0.01, 100 + i) for i in range(12)]
    probe = HealthProbe(bat, start=False)
    try:
        with plan.active():
            futs = [bat.submit("s", s) for s in synds]
            results = [f.result(timeout=TIMEOUT) for f in futs]
        assert probe.probe_once() == ["s"]
    finally:
        resilience.set_default_policy(prev)
        bat.drain(timeout=TIMEOUT)
    assert plan.hits("serve_dispatch") >= 2
    assert resilience.device_epoch() > epoch
    assert telemetry.compile_stats()["cuda.graph_captures"] > captures
    assert bat.completed == len(synds) and bat.failed == 0
    for synd, res in zip(synds, results):
        assert np.array_equal(res.corrections, sess.decode(synd).corrections)


def test_launches_fold_into_the_wrappers(cuda, hx):
    sess = _session("s", cuda, hx, 0.01)
    sess.warm(256)
    synd = _synd(hx, 256, 0.01, 7)
    _kernels.fold_launch_counts(cuda, _kernels.launch_counts(cuda).tolist())
    k1, head = bk.bp_minsum.launches, bk.bp_head_bf16.launches
    reads = sess.host_reads  # programs of equal state are shared
    sess.decode(synd[:100])   # bucket 128: float32 kernel 1
    sess.decode(synd)         # bucket 256: the bf16 head
    assert bk.bp_minsum.launches > k1
    assert bk.bp_head_bf16.launches > head
    assert sess.host_reads == reads + 2
