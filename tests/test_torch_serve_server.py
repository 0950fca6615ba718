"""The port's batcher, TCP server and client (``serve/scheduler.py``,
``server.py``, ``client.py``, ``ops.py``) on the CPU, and the wire as one
protocol between the port and the JAX package.

  * ``assemble_round_robin`` takes what the JAX package's takes from the
    same queue; the batcher coalesces requests across tenants and codes,
    each answer bit-exact with the offline decode of its rows; a graceful
    drain answers every request; an abandoning shutdown answers each with
    an error.
  * A JAX ``DecodeClient`` served by the port's server and the port's
    client served by the JAX server round-trip in both codecs: the answers
    equal the serving side's offline decode, bit for bit.
  * Ping, structured error frames, a non-object JSON frame, a mid-frame
    disconnect, and the ops plane's /metrics and /healthz.

Tolerance: none.  Every wait is bounded (futures, joins, sockets), and
every server stops in a ``finally``.
"""
import json
import socket
import struct
import time
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep
from qldpc_fault_tolerance_tpu.decoders import BP_Decoder_Class as JBP
from qldpc_fault_tolerance_tpu import serve as jserve
from qldpc_fault_tolerance_tpu.serve import scheduler as jsched
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class
from qldpc_fault_tolerance_tpu_torch.serve import (
    ContinuousBatcher,
    DecodeClient,
    DecodeSession,
    HealthProbe,
    SessionCache,
    assemble_round_robin,
    start_ops_thread,
    start_server_thread,
)
from qldpc_fault_tolerance_tpu_torch.serve import scheduler as tsched
from qldpc_fault_tolerance_tpu_torch.serve.wire import HEADER
from qldpc_fault_tolerance_tpu_torch.utils import telemetry

torch.set_num_threads(1)

DEC = BP_Decoder_Class(4, "minimum_sum", 0.625, device="cpu")
JDEC = JBP(4, "minimum_sum", 0.625)
CODE3 = hgp(rep_code(3), rep_code(3), name="hgp_rep3")
CODE4 = hgp(rep_code(4), rep_code(4), name="hgp_rep4")
P = 0.05
TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _params(code):
    return {"h": code.hx, "p_data": P}


def _session(code, name=None, buckets=(8, 32, 128)):
    return DecodeSession(name or code.name, decoder_class=DEC,
                         params=_params(code), buckets=buckets)


def _synd(code, k, rng):
    err = (rng.random((k, code.N)) < P).astype(np.uint8)
    return (err @ np.asarray(code.hx, np.uint8).T % 2).astype(np.uint8)


def _offline(code, synd):
    return DEC.GetDecoder(_params(code)).decode_batch(synd)


def _mk_req(mod, tenant, shots, t0):
    return mod._Request(request_id=None, tenant=tenant, session="s",
                        syndromes=np.zeros((shots, 4), np.uint8),
                        future=Future(), t0=t0)


@pytest.mark.parametrize("max_shots,force", [(16, False), (9, False),
                                             (100, False), (16, True)])
def test_assemble_round_robin_equals_jax(max_shots, force):
    plan = [("A", 4)] * 6 + [("B", 3), ("C", 5), ("B", 2), ("A", 1)]
    takes = []
    for mod, assemble in ((jsched, jsched.assemble_round_robin),
                          (tsched, assemble_round_robin)):
        q = mod._SessionQueue()
        for i, (tenant, shots) in enumerate(plan):
            q.add(_mk_req(mod, tenant, shots, float(i)))
        first = assemble(q, max_shots=max_shots, force=force)
        second = assemble(q, max_shots=max_shots, force=force)
        takes.append(([(r.tenant, r.shots, r.t0) for r in first],
                      [(r.tenant, r.shots, r.t0) for r in second],
                      q.shots, q.empty()))
    assert takes[0] == takes[1]


def test_batcher_coalesces_across_tenants_and_codes_bitexact():
    telemetry.enable()
    sessions = {"hgp_rep3": _session(CODE3), "hgp_rep4": _session(CODE4)}
    for s in sessions.values():
        s.warm()
    bat = ContinuousBatcher(sessions, max_batch_shots=128, max_wait_s=0.2)
    try:
        rng = np.random.default_rng(3)
        subs = []
        for i in range(12):
            code = CODE3 if i % 2 == 0 else CODE4
            synd = _synd(code, int(rng.integers(1, 9)), rng)
            subs.append((code, synd, bat.submit(
                code.name, synd, tenant=f"t{i % 3}", request_id=str(i))))
        for code, synd, fut in subs:
            res = fut.result(timeout=TIMEOUT)
            assert np.array_equal(res.corrections, _offline(code, synd))
    finally:
        bat.drain(timeout=TIMEOUT)
    snap = telemetry.snapshot()
    assert snap["serve.requests"]["value"] == 12
    assert 2 <= snap["serve.batches"]["value"] < 12
    assert snap["serve.tenant.t0.requests"]["value"] == 4


def test_fused_dispatch_across_one_family_bitexact():
    ps = {"s0": 0.03, "s1": 0.05, "s2": 0.08}
    sessions = {name: DecodeSession(
        name, decoder_class=DEC, params={"h": CODE3.hx, "p_data": p},
        buckets=(8, 32)) for name, p in ps.items()}
    bat = ContinuousBatcher(sessions, max_batch_shots=32, max_wait_s=0.5)
    bat.warm()
    try:
        rng = np.random.default_rng(21)
        subs = [(name, s := _synd(CODE3, 5, rng), bat.submit(name, s))
                for name in sessions for _ in range(2)]
        for name, synd, fut in subs:
            res = fut.result(timeout=TIMEOUT)
            want = DEC.GetDecoder({"h": CODE3.hx, "p_data": ps[name]}
                                  ).decode_batch(synd)
            assert np.array_equal(res.corrections, want)
    finally:
        bat.drain(timeout=TIMEOUT)
    health = bat.health()
    assert bat.fused_dispatches >= 1 and health["fused"]["fallbacks"] == 0


def test_graceful_drain_drops_no_request():
    bat = ContinuousBatcher({"hgp_rep3": _session(CODE3)},
                            max_batch_shots=10_000, max_wait_s=60.0)
    rng = np.random.default_rng(4)
    subs = [(s := _synd(CODE3, 3, rng),
             bat.submit("hgp_rep3", s, tenant=f"t{i % 2}"))
            for i in range(25)]
    assert not any(fut.done() for _, fut in subs)
    bat.drain(timeout=TIMEOUT)
    for synd, fut in subs:
        assert np.array_equal(fut.result(timeout=1).corrections,
                              _offline(CODE3, synd))
    with pytest.raises(RuntimeError):
        bat.submit("hgp_rep3", _synd(CODE3, 1, rng))
    assert bat.completed == 25 and bat.failed == 0


def test_evicted_session_fails_its_batch_and_the_dispatcher_survives():
    cache = SessionCache(max_sessions=1)
    cache.get_or_create("a", lambda: _session(CODE3, name="a"))
    bat = ContinuousBatcher(cache, max_batch_shots=10_000, max_wait_s=60.0)
    rng = np.random.default_rng(8)
    fut = bat.submit("a", _synd(CODE3, 2, rng))
    cache.get_or_create("b", lambda: _session(CODE4, name="b"))
    fut_b = bat.submit("b", _synd(CODE4, 2, rng))
    bat.drain(timeout=TIMEOUT)
    with pytest.raises(KeyError):
        fut.result(timeout=1)
    assert fut_b.result(timeout=1).corrections.shape[0] == 2
    assert bat.failed == 1 and bat.completed == 1


def _roundtrip(handle, client_cls, codec, offline):
    rng = np.random.default_rng(30 + codec)
    cli = client_cls(*handle.address, tenant="x", codec=codec,
                     timeout=TIMEOUT)
    try:
        pong = cli.ping()
        assert pong["ok"]
        subs = []
        for i in range(6):
            code = CODE3 if i % 2 else CODE4
            synd = _synd(code, int(rng.integers(1, 40)), rng)
            subs.append((code, synd, cli.submit(code.name, synd)))
        for code, synd, fut in subs:
            res = fut.result(timeout=TIMEOUT)
            assert np.array_equal(res.corrections, offline(code, synd))
        with pytest.raises(RuntimeError, match="unknown session"):
            cli.decode("nope", np.zeros((1, 6), np.uint8))
    finally:
        cli.close()


@pytest.mark.parametrize("codec", [1, 2])
def test_jax_client_against_port_server(codec):
    sessions = {"hgp_rep3": _session(CODE3), "hgp_rep4": _session(CODE4)}
    bat = ContinuousBatcher(sessions, max_batch_shots=64, max_wait_s=0.01)
    handle = start_server_thread(bat)
    try:
        _roundtrip(handle, jserve.DecodeClient, codec, _offline)
    finally:
        handle.stop(drain=True, timeout=TIMEOUT)


@pytest.mark.parametrize("codec", [1, 2])
def test_port_client_against_jax_server(codec):
    jcodes = {c.name: jhgp(jrep(k), jrep(k), name=c.name)
              for c, k in ((CODE3, 3), (CODE4, 4))}
    sessions = {name: jserve.DecodeSession(
        name, decoder_class=JDEC, params={"h": c.hx, "p_data": P},
        buckets=(8, 32, 128)) for name, c in jcodes.items()}
    bat = jserve.ContinuousBatcher(sessions, max_batch_shots=64,
                                   max_wait_s=0.01)
    handle = jserve.start_server_thread(bat)

    def offline(code, synd):
        return JDEC.GetDecoder({"h": jcodes[code.name].hx,
                                "p_data": P}).decode_batch(synd)

    try:
        _roundtrip(handle, DecodeClient, codec, offline)
    finally:
        handle.stop(drain=True, timeout=TIMEOUT)


def test_server_graceful_drain_answers_in_flight_requests():
    bat = ContinuousBatcher({"hgp_rep3": _session(CODE3)},
                            max_batch_shots=64, max_wait_s=0.01)
    handle = start_server_thread(bat)
    cli = DecodeClient(*handle.address, timeout=TIMEOUT)
    try:
        synd = _synd(CODE3, 3, np.random.default_rng(5))
        pending = [cli.submit("hgp_rep3", synd) for _ in range(8)]
        handle.stop(drain=True, timeout=TIMEOUT)
        for fut in pending:
            res = fut.result(timeout=TIMEOUT)
            assert np.array_equal(res.corrections, _offline(CODE3, synd))
    finally:
        cli.close()


def test_server_abandon_shutdown_answers_with_errors():
    bat = ContinuousBatcher({"hgp_rep3": _session(CODE3)},
                            max_batch_shots=10_000, max_wait_s=60.0)
    handle = start_server_thread(bat)
    cli = DecodeClient(*handle.address, timeout=TIMEOUT)
    try:
        rng = np.random.default_rng(10)
        futs = [cli.submit("hgp_rep3", _synd(CODE3, 2, rng))
                for _ in range(4)]
        deadline = time.monotonic() + TIMEOUT
        while bat.health()["queue_depth"] < 4:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        t0 = time.perf_counter()
        handle.stop(drain=False, timeout=TIMEOUT)
        assert time.perf_counter() - t0 < 30  # not the 60 s deadline
        for f in futs:
            with pytest.raises((RuntimeError, ConnectionError)):
                f.result(timeout=TIMEOUT)
        assert not bat._thread.is_alive()
    finally:
        cli.close()


def _read_frame(raw):
    head = b""
    while len(head) < HEADER.size:
        chunk = raw.recv(HEADER.size - len(head))
        assert chunk
        head += chunk
    (length,) = HEADER.unpack(head)
    body = b""
    while len(body) < length:
        chunk = raw.recv(length - len(body))
        assert chunk
        body += chunk
    return body


def test_server_answers_non_object_json_and_survives_midframe_disconnect():
    bat = ContinuousBatcher({"hgp_rep3": _session(CODE3)},
                            max_batch_shots=64, max_wait_s=0.01)
    handle = start_server_thread(bat)
    try:
        with socket.create_connection(handle.address, timeout=TIMEOUT) \
                as raw:
            body = b"[1,2,3]"
            raw.sendall(HEADER.pack(len(body)) + body)
            msg = json.loads(_read_frame(raw))
            assert msg["ok"] is False and "JSON object" in msg["error"]
        with socket.create_connection(handle.address, timeout=TIMEOUT) \
                as raw:
            raw.sendall(struct.pack(">I", 100) + b"partial")
        cli = DecodeClient(*handle.address, timeout=TIMEOUT)
        try:
            res = cli.decode("hgp_rep3",
                             _synd(CODE3, 2, np.random.default_rng(12)))
            assert res.corrections.shape[0] == 2
        finally:
            cli.close()
    finally:
        handle.stop(drain=True, timeout=TIMEOUT)


def test_ops_plane_metrics_and_healthz():
    telemetry.enable()
    bat = ContinuousBatcher({"hgp_rep3": _session(CODE3)},
                            max_batch_shots=64, max_wait_s=0.01)
    probe = HealthProbe(bat, start=False)
    ops = start_ops_thread(bat, probe=probe)
    try:
        fut = bat.submit("hgp_rep3", _synd(CODE3, 3,
                                           np.random.default_rng(2)))
        fut.result(timeout=TIMEOUT)
        base = f"http://{ops.address[0]}:{ops.address[1]}"
        with urllib.request.urlopen(base + "/metrics",
                                    timeout=TIMEOUT) as resp:
            text = resp.read().decode()
        assert "qldpc_serve_requests 1" in text
        with urllib.request.urlopen(base + "/healthz",
                                    timeout=TIMEOUT) as resp:
            health = json.loads(resp.read())
            assert resp.status == 200
        assert health["completed"] == 1 and health["probe"]["heals"] == 0
        with urllib.request.urlopen(base + "/varz", timeout=TIMEOUT) as resp:
            varz = json.loads(resp.read())
        assert varz["compile"]["source"] == "cuda_graph"
    finally:
        ops.stop()
        bat.drain(timeout=TIMEOUT)
