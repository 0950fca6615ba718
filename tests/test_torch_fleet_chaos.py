"""The port's multi-host serving fabric under chaos (``serve/router.py``
``LocalFleet`` / ``FleetRouter``), the JAX package's fleet chaos tests
(``tests/test_chaos.py``) on the port's serve stack, on the CPU.

  * ``host_kill`` mid-storm: a seeded kill at ``fleet_host_tick`` against
    the owner of the stream's family (the rep3 batch family shares it).
    The handoff is driven by the gateway's deadman alone; every accepted
    request, batch and stream, is answered exactly once, each answer equal
    to the JAX package's decode of the same rows.
  * ``journal_lag``: the handoff blocks until the successor's journal has
    every answered entry, and a duplicate of a pre-kill request replays
    the imported answer without a second decode.
  * ``router_partition``: one frame forwarded with a stale epoch is
    refused by the owner's fence and re-forwarded, answered exactly, with
    no handoff.

Tolerance: none (BP on the CPU decodes each row alike at any batch size,
so an answer equals the JAX package's decode of its rows bit for bit).
Every client and future has its own timeout, and every fleet stops in a
``finally``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep
from qldpc_fault_tolerance_tpu.decoders import BP_Decoder_Class as JBP
from qldpc_fault_tolerance_tpu.decoders import ST_BP_Decoder_Class as JST
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    ST_BP_Decoder_Class,
)
from qldpc_fault_tolerance_tpu_torch.serve import (
    DecodeClient,
    DecodeSession,
    LocalFleet,
)
from qldpc_fault_tolerance_tpu_torch.serve.session import family_digest
from qldpc_fault_tolerance_tpu_torch.utils import (
    faultinject,
    resilience,
    telemetry,
)

torch.set_num_threads(1)

DEC_CLS = BP_Decoder_Class(4, "minimum_sum", 0.625, device="cpu")
JDEC_CLS = JBP(4, "minimum_sum", 0.625)
CODE3 = hgp(rep_code(3), rep_code(3), name="hgp_rep3")
CODE4 = hgp(rep_code(4), rep_code(4), name="hgp_rep4")
JCODES = {"hgp_rep3": jhgp(jrep(3), jrep(3)), "hgp_rep4": jhgp(jrep(4), jrep(4))}
P = 0.05
ST_W = 3
ST_CLS = ST_BP_Decoder_Class(2, "minimum_sum", 0.625, device="cpu")
JST_CLS = JST(2, "minimum_sum", 0.625)
FAST_POLICY = resilience.RetryPolicy(
    max_attempts=2, base_delay=0.01, backoff=1.0, jitter=0.0,
    reset_caches=False, degrade_after=1)
TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _clean_world():
    telemetry.disable()
    telemetry.reset()
    faultinject.deactivate()
    prev = resilience.current_policy()
    yield
    resilience.set_default_policy(prev)
    faultinject.deactivate()
    telemetry.disable()
    telemetry.reset()


def _params(code):
    return {"h": code.hx, "p_data": P}


def _session(code, name=None, buckets=(8, 32)):
    return DecodeSession(name or code.name, decoder_class=DEC_CLS,
                         params=_params(code), buckets=buckets)


def _st_params(h):
    return {"h": h, "p_data": P, "p_syndrome": True, "num_rep": ST_W}


def _st_stream_session(lanes=4):
    return DecodeSession("st3", decoder_class=ST_CLS,
                         params=_st_params(CODE3.hx),
                         buckets=(lanes, 4 * lanes))


def _synd(code, k, rng):
    err = (rng.random((k, code.N)) < P).astype(np.uint8)
    return (err @ np.asarray(code.hx, np.uint8).T % 2).astype(np.uint8)


def _jax_decode(name, synd):
    """The JAX package's decode of these rows (its ``decode_device``)."""
    return JDEC_CLS.GetDecoder({"h": JCODES[name].hx,
                                "p_data": P}).decode_batch(synd)


def _counter(name):
    return telemetry.snapshot().get(name, {}).get("value", 0)


def _fam(sess) -> str:
    return f"fam-{family_digest(sess.family)}"


def _fleet_storm(fleet, codes, n_per_tenant, tenants=2, seed=0):
    """Pipelined tenants through the router; each collected answer ticks
    the fleet's chaos site, so a seeded ``host_kill`` fires mid-storm."""
    host, port = fleet.address
    names = sorted(codes)
    results, errors = [], []

    def worker(idx):
        try:
            rng = np.random.default_rng(1000 * seed + idx)
            with DecodeClient(host, port, tenant=f"t{idx}", reconnect=True,
                              timeout=TIMEOUT) as cli:
                pending = []
                for i in range(n_per_tenant):
                    name = names[(i + idx) % len(names)]
                    synd = _synd(codes[name], int(rng.integers(1, 8)), rng)
                    pending.append((name, synd, cli.submit(name, synd)))
                for name, synd, fut in pending:
                    res = fut.result(timeout=2 * TIMEOUT)
                    results.append((name, synd, res.corrections))
                    fleet.chaos_tick()
        except Exception as exc:  # noqa: BLE001 — surfaced by the test
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5 * TIMEOUT)
    assert not errors, errors
    return results


def _wait_for_handoff(router, fam, timeout=30.0):
    deadline = time.monotonic() + timeout
    while fam not in router.handoff_report():
        assert time.monotonic() < deadline, f"no handoff for {fam}"
        resilience.sleep_for(0.02)


def test_fleet_host_kill_mid_storm_exactly_once_via_deadman():
    resilience.set_default_policy(FAST_POLICY)
    telemetry.enable()
    codes = {"hgp_rep3": CODE3, "hgp_rep4": CODE4}

    def factory():
        return {"hgp_rep3": _session(CODE3, name="hgp_rep3",
                                     buckets=(8, 64)),
                "hgp_rep4": _session(CODE4, name="hgp_rep4",
                                     buckets=(8, 32, 64)),
                "st3": _st_stream_session(4)}

    fleet = LocalFleet(factory, n_hosts=2)
    try:
        st_fam = _fam(fleet.sessions["h0"]["st3"])
        b3_fam = _fam(fleet.sessions["h0"]["hgp_rep3"])
        placement = fleet.router.placement()
        victim = placement[st_fam]["owner"]
        survivor = placement[st_fam]["successor"]
        # the bucket ladders co-locate the stream and the rep3 family on
        # one host (the port's family digests, not the JAX package's), so
        # the kill disrupts both planes
        assert placement[b3_fam]["owner"] == victim, placement
        plan = faultinject.FaultPlan(
            [faultinject.Fault(site="fleet_host_tick", kind="host_kill",
                               after=5, target=st_fam)], seed=18)
        host, port = fleet.address
        offline_st = JST_CLS.GetDecoder(_st_params(JCODES["hgp_rep3"].hx))
        rng = np.random.default_rng(18)
        with DecodeClient(host, port, reconnect=True,
                          timeout=TIMEOUT) as st_cli:
            ack = st_cli.stream_open("st3", lanes=4)
            assert ack.get("ok"), ack
            sid, width = ack["stream"], ack["width"]
            chunks = [(rng.random((4, width)) < P).astype(np.uint8)
                      for _ in range(6)]

            def step(seq):
                res = st_cli.stream_step(sid, seq, chunks[seq - 1])
                assert res.get("ok"), res
                assert res["committed"] == seq
                ref = offline_st.decode_batch(
                    chunks[seq - 1].reshape(4, ST_W, -1))
                assert np.array_equal(
                    np.asarray(res["corrections"], np.uint8),
                    np.asarray(ref, np.uint8)), f"seq {seq}"

            for seq in (1, 2, 3):
                step(seq)
            with plan.active():
                results = _fleet_storm(fleet, codes, n_per_tenant=8,
                                       tenants=2, seed=18)
                for seq in (4, 5, 6):
                    step(seq)
            assert st_cli.stream_commit(sid)["committed"] == 6
            st_cli.stream_commit(sid, close=True)
        assert _counter("serve.host_kills") == 1
        assert _counter("faultinject.host_kill") == 1
        assert f"host_down:{victim}" in fleet.gateway.alerts.firing()
        assert fleet.router.down == {victim}
        place2 = fleet.router.placement()
        assert place2[st_fam]["owner"] == survivor
        assert place2[b3_fam]["owner"] == survivor
        assert place2[st_fam]["epoch"] == 2
        report = fleet.router.handoff_report()
        assert report[st_fam]["reason"] == f"host_down:{victim}"
        assert _counter("router.handoffs") >= 2
        assert _counter("router.handoff_drops") == 0
        assert len(results) == 16
        for name in codes:
            rows = [(s, c) for n, s, c in results if n == name]
            synd = np.concatenate([s for s, _ in rows])
            served = np.concatenate([c for _, c in rows])
            assert np.array_equal(served, _jax_decode(name, synd)), name
        assert _counter("stream.commits") == 6
        # the dead host's sessions hold no program any more
        assert fleet.released[victim] > 0
        assert all(not s.programs() for s in fleet.sessions[victim].values())
    finally:
        fleet.stop()


def test_fleet_journal_lag_handoff_blocks_on_watermark_catch_up():
    resilience.set_default_policy(FAST_POLICY)
    telemetry.enable()
    fleet = LocalFleet(lambda: {"hgp_rep3": _session(CODE3)}, n_hosts=2)
    try:
        fam = _fam(fleet.sessions["h0"]["hgp_rep3"])
        victim = fleet.router.placement()[fam]["owner"]
        host, port = fleet.address
        rng = np.random.default_rng(19)
        answered = []

        def ask(cli):
            synd = _synd(CODE3, int(rng.integers(1, 8)), rng)
            res = cli.submit("hgp_rep3", synd).result(timeout=2 * TIMEOUT)
            answered.append((synd, res.corrections))

        with DecodeClient(host, port, reconnect=True,
                          timeout=TIMEOUT) as cli:
            for _ in range(6):
                ask(cli)
            plan = faultinject.FaultPlan([
                faultinject.Fault(site="router_replicate",
                                  kind="journal_lag", after=0, count=150),
                faultinject.Fault(site="fleet_host_tick",
                                  kind="host_kill", after=0, target=fam),
            ], seed=19)
            with plan.active():
                for _ in range(4):
                    ask(cli)
                resilience.sleep_for(0.1)
                fleet.chaos_tick()
                _wait_for_handoff(fleet.router, fam)
            ask(cli)
        assert _counter("faultinject.journal_lag") >= 1
        assert _counter("router.replication_errors") >= 1
        assert _counter("router.handoff_drops") == 0
        report = fleet.router.handoff_report()
        assert report[fam]["epoch"] == 2
        new_owner = fleet.router.placement()[fam]["owner"]
        assert new_owner != victim
        snap = fleet.batchers[new_owner].export_journal(0)
        assert len(snap["entries"]) >= 10
        for synd, corrections in answered:
            assert np.array_equal(corrections, _jax_decode("hgp_rep3", synd))
        entry = snap["entries"][0]
        tenant, sess_name, idem = entry["key"]
        width = fleet.sessions[new_owner]["hgp_rep3"].syndrome_width
        before = _counter("serve.dedup.replayed")
        fut = fleet.batchers[new_owner].submit(
            sess_name, np.zeros((1, width), np.uint8), tenant=tenant,
            idem=idem)
        replay = fut.result(timeout=TIMEOUT)
        assert np.array_equal(replay.corrections,
                              np.asarray(entry["corrections"], np.uint8))
        assert _counter("serve.dedup.replayed") == before + 1
    finally:
        fleet.stop()


def test_fleet_router_partition_fence_refuses_and_reforwards():
    resilience.set_default_policy(FAST_POLICY)
    telemetry.enable()
    fleet = LocalFleet(lambda: {"hgp_rep3": _session(CODE3)}, n_hosts=2)
    try:
        host, port = fleet.address
        rng = np.random.default_rng(20)
        plan = faultinject.FaultPlan(
            [faultinject.Fault(site="router_route",
                               kind="router_partition", after=2, count=1)],
            seed=20)
        with plan.active():
            with DecodeClient(host, port, reconnect=True,
                              timeout=TIMEOUT) as cli:
                for _ in range(6):
                    synd = _synd(CODE3, int(rng.integers(1, 8)), rng)
                    res = cli.submit("hgp_rep3", synd).result(
                        timeout=2 * TIMEOUT)
                    assert np.array_equal(res.corrections,
                                          _jax_decode("hgp_rep3", synd))
        assert _counter("router.partition_injected") == 1
        assert _counter("serve.route_stale") >= 1
        assert _counter("router.stale_reforwards") >= 1
        assert _counter("router.handoffs") == 0
    finally:
        fleet.stop()


def test_decoder_state_memo_is_safe_across_threads():
    """A fleet's hosts (and a heal beside them) build decoder states at
    once: the per-H memo's lookups, builds, evictions and a device reset
    from four threads never lose an entry under another's hit."""
    from qldpc_fault_tolerance_tpu_torch import reset_device_state
    from qldpc_fault_tolerance_tpu_torch.decoders import bp_decoders

    errors = []

    def hammer(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in range(20000):
                key = ("test", int(rng.integers(0, 24)))
                assert bp_decoders._memo(key, lambda key=key: key) == key
                if seed == 0 and i % 2000 == 0:
                    reset_device_state()
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors, errors[:3]
    reset_device_state()
