"""The disk half of the port's program cache (``utils/progcache.py``) and
the serve sessions on it, on the CPU, mirroring the JAX package's
``tests/test_progcache.py``.

  * Inactive by default: a build stays in process and nothing is stored.
  * Keys are stable across calls, differ by kind and parts, and change
    with ``QLDPC_PROGCACHE_SALT``.
  * A warm restart (memory cleared, new sessions: what a fresh process
    sees) loads each session's decoder state and every bucket's program
    from disk: no state is rebuilt, no program is built, one recapture a
    bucket, and the served corrections equal the cold run's and the JAX
    package's decode of the same rows bit for bit.
  * A truncated artifact is counted as a load error, rebuilt and replaced;
    an artifact recorded under another fingerprint is a miss, not a crash;
    ``invalidate(stale_artifact=True)`` evicts the disk entries.
  * A concurrent cold start builds once.
  * A fleet's handoff under ``host_kill`` warm-pushes the dying family's
    programs to the successor, which loads them; every request is answered
    exactly once, equal to the JAX package's decode.
"""
import threading

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep
from qldpc_fault_tolerance_tpu.decoders import BP_Decoder_Class as JBP
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPOSD_Decoder_Class,
)
from qldpc_fault_tolerance_tpu_torch.serve import (
    DecodeClient,
    DecodeSession,
    LocalFleet,
)
from qldpc_fault_tolerance_tpu_torch.utils import (
    faultinject,
    progcache,
    resilience,
    telemetry,
)

torch.set_num_threads(1)

CODE = hgp(rep_code(3), rep_code(3), name="hgp_rep3")
JCODE = jhgp(jrep(3), jrep(3))
P = 0.05
BP_CLS = BP_Decoder_Class(4, "minimum_sum", 0.625, device="cpu")
BPOSD_CLS = BPOSD_Decoder_Class(4, "minimum_sum", 0.625, "osd_e", 3,
                                device="cpu")
JBP_CLS = JBP(4, "minimum_sum", 0.625)
FAST_POLICY = resilience.RetryPolicy(
    max_attempts=2, base_delay=0.01, backoff=1.0, jitter=0.0,
    reset_caches=False, degrade_after=1)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("QLDPC_PROGCACHE_DIR", raising=False)
    monkeypatch.delenv("QLDPC_PROGCACHE_SALT", raising=False)
    progcache.reset(purge_stats=True)
    telemetry.disable()
    telemetry.reset()
    faultinject.deactivate()
    prev = resilience.current_policy()
    yield
    resilience.set_default_policy(prev)
    faultinject.deactivate()
    telemetry.disable()
    telemetry.reset()
    progcache.reset(purge_stats=True)


def _params():
    return {"h": CODE.hx, "p_data": P}


def _session(cls=BP_CLS, buckets=(8, 32), name="hgp_rep3"):
    return DecodeSession(name, decoder_class=cls, params=_params(),
                         buckets=buckets)


def _synd(k, rng):
    err = (rng.random((k, CODE.N)) < P).astype(np.uint8)
    return (err @ np.asarray(CODE.hx, np.uint8).T % 2).astype(np.uint8)


def _artifacts(root):
    return sorted(root.rglob("*" + progcache.ARTIFACT_SUFFIX))


def _counter(name):
    return telemetry.snapshot().get(name, {}).get("value", 0)


def test_inactive_by_default_builds_in_process():
    assert not progcache.active() and progcache.cache_dir() is None
    prog, source = progcache.compile_cached(
        lambda: "p", kind="t", parts={"b": 1}, save=lambda p: {"b": 1},
        load=lambda payload: "never")
    assert (prog, source) == ("p", "compile")
    stats = progcache.stats()
    assert stats["stores"] == 0 and stats["disk_hits"] == 0
    assert progcache.load_artifact("t", {"b": 1}) is None


def test_cache_key_stable_and_salted(monkeypatch):
    parts = {"static": ("bp", 4), "bucket": 32}
    k1 = progcache.cache_key("serve.session", parts)
    assert k1 == progcache.cache_key("serve.session", dict(parts))
    assert progcache.cache_key("sweep.fused", parts) != k1
    assert progcache.cache_key("serve.session",
                               dict(parts, bucket=64)) != k1
    fp = progcache.fingerprint()
    assert {"torch", "cuda", "device", "capability", "kernels",
            "salt"} <= set(fp)
    assert set(fp["kernels"]) >= {"bp_minsum", "osd_elim", "fused_decode"}
    monkeypatch.setenv("QLDPC_PROGCACHE_SALT", "bump")
    assert progcache.fingerprint(refresh=True)["salt"] == "bump"
    assert progcache.cache_key("serve.session", parts) != k1


@pytest.mark.parametrize("cls", [BP_CLS, BPOSD_CLS], ids=["bp", "bposd_dev"])
def test_warm_restart_loads_state_and_programs_bitexact(cls, tmp_path):
    progcache.configure(str(tmp_path))
    telemetry.enable()
    synd = _synd(20, np.random.default_rng(0))

    cold = _session(cls)
    assert cold.state_source == "build"
    cold.warm()
    out_cold = cold.decode(synd)
    n = len(cold.buckets)
    assert cold.compiles == n
    stats = progcache.stats()
    assert (stats["misses"], stats["stores"]) == (n, n + 1)  # + the state
    assert len(_artifacts(tmp_path)) == n + 1

    # a fresh process: nothing in memory, new session objects
    progcache.clear_memory()
    telemetry.reset()
    warm = _session(cls)
    warm.warm()
    out_warm = warm.decode(synd)
    assert warm.state_source == "disk" and _counter(
        "serve.session.builds") == 0
    assert warm.compiles == 0 and warm.loads == n
    stats = progcache.stats()
    assert stats["recaptures"] == n
    assert stats["disk_hits"] == n + 1
    assert np.array_equal(out_warm.corrections, out_cold.corrections)
    if cls is BP_CLS:
        offline = JBP_CLS.GetDecoder({"h": JCODE.hx,
                                      "p_data": P}).decode_batch(synd)
        assert np.array_equal(out_warm.corrections, offline)
    assert progcache.hit_rate() >= 0.5


def test_artifact_format(tmp_path):
    progcache.configure(str(tmp_path))
    sess = _session(buckets=(8,))
    sess.warm()
    docs = [torch.load(p, weights_only=False) for p in _artifacts(tmp_path)]
    assert len(docs) == 2
    for doc in docs:
        assert doc["schema"] == 1
        assert doc["meta"]["fingerprint"] == progcache.fingerprint()
        assert doc["key"] + progcache.ARTIFACT_SUFFIX in [
            p.name for p in _artifacts(tmp_path)]
    payloads = {("state" in d["payload"]): d["payload"] for d in docs}
    assert payloads[False]["bucket"] == 8
    assert payloads[False]["kernel_variant"] == sess.bucket_variants[8]
    state = payloads[True]["state"]
    assert all(x.device.type == "cpu" for x in
               torch.utils._pytree.tree_leaves(state)
               if isinstance(x, torch.Tensor))


def test_corrupt_artifact_rebuilds_and_replaces(tmp_path):
    progcache.configure(str(tmp_path))
    synd = _synd(5, np.random.default_rng(1))
    cold = _session(buckets=(8,))
    want = cold.decode(synd).corrections
    prog_art = [p for p in _artifacts(tmp_path)
                if "state" not in torch.load(p, weights_only=False)[
                    "payload"]][0]
    prog_art.write_bytes(prog_art.read_bytes()[:40])  # truncated
    stats0 = progcache.stats()
    progcache.clear_memory()
    again = _session(buckets=(8,))
    out = again.decode(synd)
    assert np.array_equal(out.corrections, want)
    stats = progcache.stats()
    assert stats["load_errors"] == stats0["load_errors"] + 1
    assert stats["stores"] == stats0["stores"] + 1  # replaced
    assert again.compiles == 1
    assert torch.load(prog_art, weights_only=False)["schema"] == 1


def test_fingerprint_mismatch_is_a_miss(tmp_path):
    progcache.configure(str(tmp_path))
    sess = _session(buckets=(8,))
    sess.warm()
    for art in _artifacts(tmp_path):
        doc = torch.load(art, weights_only=False)
        doc["meta"]["fingerprint"] = {"torch": "0.0.1"}  # foreign toolchain
        torch.save(doc, art)
    stats0 = progcache.stats()
    progcache.clear_memory()
    again = _session(buckets=(8,))
    again.warm()
    assert again.state_source == "build" and again.compiles == 1
    stats = progcache.stats()
    assert stats["fingerprint_rejects"] == stats0["fingerprint_rejects"] + 2
    assert stats["load_errors"] == stats0["load_errors"]


def test_stale_artifact_invalidation_evicts_disk(tmp_path):
    progcache.configure(str(tmp_path))
    sess = _session(buckets=(8,))
    sess.warm()
    assert len(_artifacts(tmp_path)) == 2
    sess.invalidate()  # dead buffers: the artifacts stay
    assert len(_artifacts(tmp_path)) == 2
    sess.warm()
    sess.invalidate(stale_artifact=True)
    # the re-resolve after the eviction stores the state again
    assert len(_artifacts(tmp_path)) == 1


def test_concurrent_cold_start_single_flight(tmp_path):
    progcache.configure(str(tmp_path))
    builds, results, errors = [], [], []
    lock = threading.Lock()
    barrier = threading.Barrier(6)

    def build():
        with lock:
            builds.append(1)
        return object()

    def racer():
        try:
            barrier.wait(timeout=30)
            results.append(progcache.compile_cached(
                build, kind="t.race", parts={"shape": (4,)},
                save=lambda p: {"shape": (4,)}, load=lambda payload: None))
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=racer) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert len(builds) == 1
    assert sorted(s for _p, s in results) == ["compile"] + ["mem"] * 5
    assert len({id(p) for p, _s in results}) == 1
    assert progcache.stats()["misses"] == 1


def test_fleet_handoff_warm_push_loads_from_disk(tmp_path):
    resilience.set_default_policy(FAST_POLICY)
    telemetry.enable()
    progcache.configure(str(tmp_path))
    reqs = 10
    fleet = LocalFleet(lambda: {"hgp_rep3": _session(buckets=(8, 32))},
                       n_hosts=2, warm=False)
    try:
        host, port = fleet.address
        plan = faultinject.FaultPlan([
            faultinject.Fault(site="fleet_host_tick", kind="host_kill",
                              after=reqs)], seed=20)
        rng = np.random.default_rng(20)
        answered = []
        with plan.active(), DecodeClient(host, port, reconnect=True,
                                         timeout=60.0) as cli:
            for _ in range(3 * reqs):
                synd = _synd(int(rng.integers(1, 8)), rng)
                res = cli.submit("hgp_rep3", synd).result(timeout=120)
                answered.append((synd, res.corrections))
                fleet.chaos_tick()
        assert _counter("serve.host_kills") == 1
        assert _counter("router.handoffs") >= 1
        assert _counter("router.program_pushes") >= 1
        assert _counter("serve.session.warm_loads") >= 1
        assert _counter("serve.session.warm_load_misses") == 0
        assert len(answered) == 3 * reqs  # exactly once
        synd = np.concatenate([s for s, _ in answered])
        served = np.concatenate([c for _, c in answered])
        offline = JBP_CLS.GetDecoder({"h": JCODE.hx,
                                      "p_data": P}).decode_batch(synd)
        assert np.array_equal(served, offline)
    finally:
        fleet.stop()
