"""Blocking decode-service client with pipelined submits, reconnect and
hedged resubmit.

A thin stdlib-socket counterpart to serve/server.py's protocol: ``submit``
sends a decode frame and returns a future immediately (responses stream
back in completion order and are matched by id on a background reader
thread), so a load generator keeps a window of requests in flight without
one connection per request.  ``decode`` is the submit+wait convenience.

Latency is measured CLIENT-side (submit to response-parsed), which is the
number a tail-latency SLO is actually about — it includes the wire, the
queue wait, the batch fill and the dispatch.

Tracing: construct with ``traced=True`` (or pass ``trace=`` per
submit) and every request mints a ``utils.tracing.TraceContext`` that
rides the optional wire field — the server records the full stage-span
tree under it and echoes the trace id back on ``ClientResult.trace_id``,
the key for the JSONL stream and ``/tracez``.

Self-healing transport:

  * a broken pipe is a PER-REQUEST transient error, never fatal to the
    client: a submit that hits a dead socket resolves ITS future with a
    ``ConnectionError`` (classified transient by utils.resilience) and
    the client stays usable — or, with ``reconnect=True``, the request
    simply rides the resubmit below;
  * ``reconnect=True`` — when the connection dies, the reader thread
    redials (bounded attempts, jittered backoff via the sanctioned
    ``resilience.sleep_for``) and RESUBMITS every unanswered request on
    the new connection with a fresh wire id and the SAME idempotency key
    (serve/wire.py ``IDEM_FIELD``), which the server's journal dedupes —
    a request whose response died on the wire is replayed from the
    answered cache, never decoded twice;
  * ``hedge_s=<seconds>`` — a request unanswered for that long is
    resubmitted on the live connection (same idempotency key, bounded
    ``max_hedges``); the server attaches the duplicate to the in-flight
    decode, so hedging bounds tail latency without duplicating work.

Idempotency keys are minted automatically whenever ``reconnect`` or
``hedge_s`` is enabled (or explicitly via ``idempotent=True``); a plain
client sends frames byte-identical to clients without them.

Wire codec: ``codec="auto"`` (the default) negotiates the
packed binary codec via a ``hello`` at connect — syndromes ship as
gf2_packed lane words instead of JSON int matrices, corrections and
convergence come back the same way — and falls back to JSON against an
old server.  ``codec=1`` forces JSON (no hello, frames byte-identical to
pre-v2 builds); ``codec=2`` requires the packed codec.  Reconnects
renegotiate on the fresh socket.  ``serve.client.bytes_rx/tx`` count
framed bytes both ways.

Streaming decode: ``stream_open`` opens an overlap-commit
stream on the server, ``stream_step`` sends one window's detector
increment and blocks for its committed corrections, ``stream_commit``
queries the commit watermark (the resume handshake) or closes the
stream.  Stream responses resolve as RAW dicts (they are not decode
results), and a stream request is never auto-resubmitted: the step
helper retries the SAME seq itself — the server's commit-before-respond
ledger replays an already-committed seq from cache, so a retry can
never double-commit a window.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import socket
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future

import numpy as np

from ..utils import resilience, telemetry, tracing
from .wire import (
    HEADER,
    IDEM_FIELD,
    MAX_FRAME_BYTES,
    TRACE_FIELD,
    WIRE_CODEC_JSON,
    WIRE_CODEC_PACKED,
    WireCodecError,
    decode_payload,
    encode_frame,
    encode_request_frame,
    encode_stream_chunk_frame,
)

__all__ = ["ClientResult", "DecodeClient"]


@dataclasses.dataclass
class ClientResult:
    corrections: np.ndarray          # (k, n) uint8
    converged: list | None
    latency_s: float                 # client-side: submit -> response parsed
    server_latency_ms: float | None  # scheduler-side, from the response
    request_id: str
    trace_id: str | None = None      # echoed by the server when traced


class _Inflight:
    """One logical request across its transmissions: the base frame (all
    fields but the wire id; None for clients that can never resend — no
    point retaining the payload), the future, and every wire id it has
    been sent under (reconnect resubmits and hedges mint fresh ones; the
    server matches responses to whichever transmission answered)."""

    __slots__ = ("future", "t0", "base", "rids", "last_tx", "hedges",
                 "resubmits", "raw")

    def __init__(self, base: dict, t0: float, raw: bool = False):
        self.future: Future = Future()
        self.t0 = t0
        self.base = base
        self.rids: set[str] = set()
        self.last_tx = t0
        self.hedges = 0
        self.resubmits = 0
        # raw requests (stream ops) resolve with the response DICT, not a
        # ClientResult, and are never auto-resubmitted or hedged (base is
        # None): stream seqs must only ever be retried by their caller
        self.raw = raw


class DecodeClient:
    def __init__(self, host: str, port: int, *, tenant: str = "default",
                 timeout: float = 60.0, traced: bool = False,
                 reconnect: bool = False,
                 max_reconnects: "int | None" = None,
                 reconnect_backoff_s: "float | None" = None,
                 hedge_s: float | None = None, max_hedges: int = 1,
                 idempotent: bool | None = None,
                 codec: "int | str" = "auto"):
        self.host, self.port = host, int(port)
        self.tenant = str(tenant)
        self.traced = bool(traced)
        self.timeout = float(timeout)
        # wire codec: "auto" negotiates the packed binary codec
        # via the hello op at connect and falls back to JSON against an
        # old server; 1 forces JSON (no hello — frames byte-identical to
        # pre-v2 builds); 2 requires the packed codec (raises when the
        # server can't speak it).  Renegotiated on every reconnect.
        if codec not in ("auto", WIRE_CODEC_JSON, WIRE_CODEC_PACKED):
            raise ValueError(f"codec must be 'auto', 1 or 2, got {codec!r}")
        self._codec_req = codec
        self.wire_codec = WIRE_CODEC_JSON
        self.reconnect = bool(reconnect)
        # dial/redial policy: env-tunable defaults
        # (an operator retunes a fleet's reconnect storm behavior without
        # touching code), explicit arguments win.  The delay schedule
        # itself comes from utils.resilience.RetryPolicy — the ONE backoff
        # implementation — capped at 2 s like the historical inline dial
        # loop, with no jitter so chaos tests stay deterministic.
        if max_reconnects is None:
            max_reconnects = int(os.environ.get(
                "QLDPC_CLIENT_RETRY_ATTEMPTS", "8"))
        if reconnect_backoff_s is None:
            reconnect_backoff_s = float(os.environ.get(
                "QLDPC_CLIENT_RETRY_BASE_S", "0.05"))
        self.max_reconnects = max(1, int(max_reconnects))
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        self._dial_policy = resilience.RetryPolicy(
            max_attempts=self.max_reconnects,
            base_delay=self.reconnect_backoff_s, backoff=2.0,
            max_delay=2.0, jitter=0.0, reset_caches=False)
        self.hedge_s = None if hedge_s is None else float(hedge_s)
        self.max_hedges = max(0, int(max_hedges))
        # resubmits and hedges only dedupe server-side when requests carry
        # idempotency keys, so those modes imply them; a plain client
        # keeps its frames byte-identical to older builds
        self.idempotent = (bool(reconnect or hedge_s is not None)
                           if idempotent is None else bool(idempotent))
        self.reconnects = 0
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        # negotiate BEFORE the reader thread starts: the hello reply is
        # read synchronously off the fresh socket, so the pump never has
        # to disambiguate negotiation frames from responses
        self.wire_codec = self._negotiate(self._sock)
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        # wire id -> logical request (several ids may map to one request)
        self._reqs: dict[str, _Inflight] = {}
        # ping waiters queue FIFO (pongs come back in order): concurrent
        # pings from threads sharing one client each get their own future
        self._pongs: deque = deque()
        self._closed = False
        # set (under _plock, atomically with failing the outstanding
        # requests) when the transport is permanently gone — a submit
        # after that point must fail ITS future immediately instead of
        # registering work no reader will ever resolve
        self._dead = False
        self._stop = threading.Event()
        self._ids = itertools.count()
        self._prefix = uuid.uuid4().hex[:8]
        # idempotency keys key SERVER-side dedupe (scoped per tenant +
        # session there, but key collisions between a fleet's clients of
        # one tenant would still cross requests): full 128-bit uuid, not
        # the short wire-id prefix whose 32 bits birthday-collide at
        # fleet scale
        self._idem_prefix = uuid.uuid4().hex
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="qldpc-serve-client")
        self._reader.start()
        self._hedger = None
        if self.hedge_s is not None and self.max_hedges > 0:
            self._hedger = threading.Thread(
                target=self._hedge_loop, daemon=True,
                name="qldpc-serve-client-hedge")
            self._hedger.start()

    # ------------------------------------------------------------------
    # wire codec negotiation
    # ------------------------------------------------------------------
    @staticmethod
    def _read_exact_sync(sock, n: int) -> bytes:
        """Exactly ``n`` bytes off a blocking socket (negotiation only —
        the socket's timeout bounds the wait; EOF raises)."""
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed during codec "
                                      "negotiation")
            buf += chunk
        return buf

    def _negotiate(self, sock) -> int:
        """Hello handshake on a FRESH socket (constructor / reconnect,
        before the reader pumps it).  Returns the codec to send with.
        ``codec=1`` skips the handshake entirely; ``codec=2`` raises when
        the server can't speak the packed codec; ``"auto"`` falls back to
        JSON against an old server (which answers "unknown op")."""
        if self._codec_req == WIRE_CODEC_JSON:
            return WIRE_CODEC_JSON
        negotiated = WIRE_CODEC_JSON
        try:
            hello = encode_frame(
                {"op": "hello",
                 "codecs": [WIRE_CODEC_PACKED, WIRE_CODEC_JSON]})
            telemetry.count("serve.client.bytes_tx", len(hello))
            sock.sendall(hello)
            head = self._read_exact_sync(sock, HEADER.size)
            (length,) = HEADER.unpack(head)
            if length > MAX_FRAME_BYTES:
                raise ConnectionError(f"oversize hello reply ({length}B)")
            telemetry.count("serve.client.bytes_rx",
                            length + HEADER.size)
            msg = decode_payload(self._read_exact_sync(sock, length))
            if isinstance(msg, dict) and msg.get("hello") \
                    and int(msg.get("codec", WIRE_CODEC_JSON)) \
                    == WIRE_CODEC_PACKED:
                negotiated = WIRE_CODEC_PACKED
        except (OSError, ValueError, KeyError, json.JSONDecodeError,
                UnicodeDecodeError):
            # old server (unknown-op reply), torn wire or a socket that
            # died under the handshake: stay on JSON — a dead transport
            # must keep surfacing per-REQUEST (or via reconnect), exactly
            # as it did before v2, never as a constructor failure
            negotiated = WIRE_CODEC_JSON
        if self._codec_req == WIRE_CODEC_PACKED \
                and negotiated != WIRE_CODEC_PACKED:
            raise ValueError(
                "server does not speak wire codec 2 (packed binary); "
                "construct the client with codec='auto' or 1")
        telemetry.count(f"serve.client.codec.v{negotiated}_conns")
        telemetry.set_gauge("wire.codec_version", negotiated)
        return negotiated

    # ------------------------------------------------------------------
    def _send(self, obj) -> None:
        # encode under the SAME _wlock hold that sends: _reconnect swaps
        # (socket, wire_codec) atomically under it, and a frame encoded
        # with a stale codec must never land on a freshly renegotiated
        # connection (a packed frame on a JSON-only server kills the
        # whole pipelined connection)
        with self._wlock:
            op = obj.get("op")
            if op == "decode":
                frame = encode_request_frame(obj, self.wire_codec)
            elif op == "stream_chunk":
                frame = encode_stream_chunk_frame(obj, self.wire_codec)
            else:
                frame = encode_frame(obj)
            telemetry.count("serve.client.bytes_tx", len(frame))
            self._sock.sendall(frame)

    def _recv_exact(self, sock, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except socket.timeout:
                # idle is NOT disconnect: a low-traffic client must keep
                # its reader alive past the socket timeout (close() breaks
                # the loop via shutdown -> OSError below)
                if self._closed:
                    return None
                continue
            except (OSError, ValueError):
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _pump(self, sock) -> None:
        """Read frames off ONE socket until it dies."""
        while True:
            head = self._recv_exact(sock, HEADER.size)
            if head is None:
                return
            (length,) = HEADER.unpack(head)
            if length > MAX_FRAME_BYTES:
                return  # protocol corruption — reconnect or fail pending
            body = self._recv_exact(sock, length)
            if body is None:
                return
            telemetry.count("serve.client.bytes_rx",
                            len(body) + HEADER.size)
            try:
                msg = decode_payload(body)
            except WireCodecError as exc:
                # a malformed binary response fails ITS request (when the
                # header named one) — the reader and the rest of the
                # pipeline survive, like the malformed-JSON path below
                telemetry.count("serve.client.wire_errors")
                rid = exc.request_id
                if rid is not None:
                    with self._plock:
                        req = self._reqs.get(rid)
                    if req is not None:
                        self._fail_request(req, RuntimeError(
                            f"malformed decode response: {exc}"))
                continue
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if not isinstance(msg, dict):
                continue
            if msg.get("pong"):
                with self._plock:
                    pong = self._pongs.popleft() if self._pongs else None
                if pong is not None:
                    pong.set_result(msg)
                continue
            rid = msg.get("id")
            with self._plock:
                req = self._reqs.get(rid)
                if req is not None:
                    # one answer resolves the LOGICAL request: retire
                    # every wire id it was transmitted under (a hedge's
                    # late second answer finds nothing and is dropped)
                    for r in req.rids:
                        self._reqs.pop(r, None)
            if req is None:
                continue
            fut, t0 = req.future, req.t0
            if fut.done():
                continue
            if req.raw:
                # stream ops resolve with the raw response dict — ok and
                # structured-error alike; the caller owns interpretation
                # (retry on "busy", resume on shed, fold corrections)
                fut.set_result(dict(msg))
                continue
            if msg.get("ok"):
                try:
                    result = ClientResult(
                        corrections=np.asarray(msg["corrections"],
                                               np.uint8),
                        converged=msg.get("converged"),
                        latency_s=time.perf_counter() - t0,
                        server_latency_ms=msg.get("latency_ms"),
                        request_id=str(rid),
                        trace_id=msg.get("trace_id"))
                except Exception as exc:  # noqa: BLE001 — reader survives
                    # a parseable-but-malformed response (version skew,
                    # corruption) fails ITS request; killing the reader
                    # here would skip the reconnect path AND the final
                    # drain, hanging every other outstanding future
                    fut.set_exception(RuntimeError(
                        f"malformed decode response: "
                        f"{type(exc).__name__}: {exc}"))
                    continue
                fut.set_result(result)
            else:
                fut.set_exception(
                    RuntimeError(msg.get("error", "decode failed")))

    def _logical_reqs(self) -> list:
        """Unique in-flight logical requests (several wire ids may map to
        one ``_Inflight``).  Call under ``_plock``."""
        return list({id(r): r for r in self._reqs.values()}.values())

    def _read_loop(self) -> None:
        while True:
            t_conn = time.perf_counter()
            try:
                self._pump(self._sock)
            except Exception:  # noqa: BLE001 — epilogue must always run
                # whatever killed the pump, the drain below (or the
                # reconnect) must still happen: a dead reader that never
                # set _dead would hang every outstanding future
                telemetry.count("serve.client.reader_errors")
            lifetime = time.perf_counter() - t_conn
            if self._closed or not self.reconnect:
                break
            # a connection that died almost immediately signals a
            # crash-looping server: back off BEFORE the first redial too,
            # or accept->die->redial->resubmit becomes a zero-sleep spin
            if not self._reconnect(fast_death=lifetime < 1.0):
                break
        # transport permanently gone: fail whatever is still outstanding.
        # _dead flips under the SAME lock hold that drains the table, so
        # a racing submit either lands in the drain or sees the flag
        with self._plock:
            self._dead = True
            reqs, self._reqs = self._reqs, {}
            pongs, self._pongs = list(self._pongs), deque()
        err = ConnectionError("decode-service connection closed")
        for req in {id(r): r for r in reqs.values()}.values():
            if not req.future.done():
                req.future.set_exception(err)
        for pong in pongs:
            if not pong.done():
                pong.set_exception(err)

    def _fail_request(self, req, exc: Exception) -> None:
        """Retire one logical request with an error: unregister every
        wire id and fail its future (used for unsendable frames — e.g. a
        payload over the frame cap, which no resend can ever fix)."""
        with self._plock:
            for r in list(req.rids):
                self._reqs.pop(r, None)
        if not req.future.done():
            req.future.set_exception(exc)

    # ------------------------------------------------------------------
    # reconnect + resubmit (the self-healing transport)
    # ------------------------------------------------------------------
    def _reconnect(self, fast_death: bool = False) -> bool:
        """Redial (bounded attempts, backoff) and resubmit every
        unanswered request on the fresh connection.  Returns True when a
        new connection is live.  ``fast_death`` (the previous connection
        died near-instantly) makes even the first dial back off."""
        # a reconnect dial is transport recovery, not device-work retry:
        # the loop shape stays bespoke (swap-under-lock, renegotiate) but
        # the attempt budget and delay schedule come from the client's
        # RetryPolicy dial policy (env-tunable), and attempts still sleep
        # via the sanctioned resilience.sleep_for
        for attempt in range(self.max_reconnects):  # qldpc: ignore[R102]
            if self._closed:
                return False
            if attempt or fast_death:
                resilience.sleep_for(self._dial_policy.delay(attempt))
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout)
            except OSError:
                continue
            try:
                # renegotiate the wire codec on the FRESH socket before
                # the reader pumps it (the server may have been replaced
                # by one speaking a different codec set)
                codec = self._negotiate(sock)
            except (OSError, ValueError):
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            # swap + pong drain under ONE _wlock hold (nested _plock,
            # same _wlock->_plock order ping uses): a ping sent on the
            # NEW connection can only run before the swap (old-socket
            # pong, correctly failed below) or after the drain (new
            # pong, correctly kept) — never be spuriously failed
            with self._wlock:
                old, self._sock = self._sock, sock
                self.wire_codec = codec
                with self._plock:
                    closed = self._closed
                    pongs, self._pongs = list(self._pongs), deque()
            try:
                old.close()
            except OSError:
                pass
            for pong in pongs:
                if not pong.done():
                    pong.set_exception(
                        ConnectionError("connection replaced"))
            if closed:
                # close() ran mid-dial: it shut down the PREVIOUS socket,
                # so the fresh one must not strand the reader (and leak a
                # live TCP connection) — tear it down and exit
                try:
                    sock.close()
                except OSError:
                    pass
                return False
            self.reconnects += 1
            telemetry.count("serve.client.reconnects")
            self._resubmit_unanswered()
            return True
        return False

    def _resubmit_unanswered(self) -> None:
        """Send every unanswered logical request again with a fresh wire
        id and its original idempotency key — the server's journal
        attaches duplicates to in-flight decodes and replays
        already-answered ones, so a resubmit is always safe."""
        with self._plock:
            reqs = self._logical_reqs()
            sends = []
            fails = []
            for req in reqs:
                if req.future.done():
                    continue
                if req.base is None:
                    # unanswered requests with no retained frame (raw
                    # stream ops) cannot ride the resubmit: fail them NOW
                    # so their caller retries the same seq itself instead
                    # of hanging until the client timeout — the server
                    # replays committed seqs, so the retry is exact-once
                    for r in list(req.rids):
                        self._reqs.pop(r, None)
                    fails.append(req)
                    continue
                rid = f"{self._prefix}-{next(self._ids)}"
                req.rids.add(rid)
                req.resubmits += 1
                req.last_tx = time.perf_counter()
                self._reqs[rid] = req
                sends.append((req, {**req.base, "id": rid}))
        err = ConnectionError("connection replaced")
        for req in fails:
            if not req.future.done():
                req.future.set_exception(err)
        for req, msg in sends:
            try:
                self._send(msg)
                telemetry.count("serve.client.resubmits")
            except ValueError as exc:
                # unencodable frame (over the cap): resending can never
                # fix it — fail THIS request, keep resubmitting the rest
                self._fail_request(req, exc)
            except OSError:
                return  # socket died again; the reader loop redials

    def _hedge_loop(self) -> None:
        """Resubmit requests unanswered past the hedge deadline (same
        idempotency key — the server dedupes, so a hedge can only help)."""
        interval = max(0.001, self.hedge_s / 2.0)
        while not self._stop.wait(interval):
            now = time.perf_counter()
            with self._plock:
                sends = []
                for req in self._logical_reqs():
                    if req.future.done() or req.base is None \
                            or req.hedges >= self.max_hedges \
                            or now - req.last_tx < self.hedge_s:
                        continue
                    rid = f"{self._prefix}-{next(self._ids)}"
                    req.rids.add(rid)
                    req.hedges += 1
                    req.last_tx = now
                    self._reqs[rid] = req
                    sends.append((req, {**req.base, "id": rid}))
            for req, msg in sends:
                try:
                    self._send(msg)
                    telemetry.count("serve.client.hedges")
                except ValueError as exc:
                    self._fail_request(req, exc)  # unencodable: see above
                except OSError:
                    break  # dead socket: the reader owns recovery

    # ------------------------------------------------------------------
    def submit(self, session: str, syndromes, *,
               tenant: str | None = None,
               trace: "tracing.TraceContext | None" = None) -> Future:
        """Send one decode request; returns its future.  ``trace``
        attaches an explicit trace context; ``traced=True`` clients mint
        one per request when none is given.

        A send that hits a dead socket is a PER-REQUEST transient error:
        without ``reconnect`` the returned future carries a
        ``ConnectionError`` (the client object stays usable); with it,
        the request stays registered and rides the reconnect resubmit."""
        arr = np.atleast_2d(np.asarray(syndromes))
        n = next(self._ids)
        rid = f"{self._prefix}-{n}"
        if trace is None and self.traced:
            trace = tracing.TraceContext()
        # syndromes stay an ndarray in the base message: the packed codec
        # encodes them directly and the JSON path .tolist()s at encode
        # time — resubmittable clients retain ~8 bytes/shot-bit less than
        # the old pre-serialized int lists did
        base = {"op": "decode", "session": str(session),
                "tenant": tenant or self.tenant,
                "syndromes": np.asarray(arr, np.uint8)}
        if self.idempotent:
            base[IDEM_FIELD] = f"{self._idem_prefix}-i{n}"
        if trace is not None:
            base[TRACE_FIELD] = trace.to_wire()
        # only clients that can ever RESEND (reconnect resubmit / hedging)
        # need the frame retained until the answer; a plain client holding
        # the tolist() payload per in-flight request would pay ~10x the
        # syndrome bytes across its whole pipeline window for nothing
        resubmittable = self.reconnect or self._hedger is not None
        req = _Inflight(base if resubmittable else None,
                        time.perf_counter())
        with self._plock:
            if self._closed:
                raise RuntimeError("client closed")
            if self._dead:
                # the reader already declared the transport gone (and
                # drained the request table): registering now would leave
                # this future unresolved forever — and a send into the
                # dead socket can "succeed" into the buffer, so the error
                # must come from here, not from sendall
                req.future.set_exception(ConnectionError(
                    "decode-service connection closed"))
                return req.future
            req.rids.add(rid)
            self._reqs[rid] = req
        try:
            self._send({**base, "id": rid})
        except ValueError as exc:
            # over the frame cap: no reconnect or resend can ever fix
            # this payload, and leaving it registered would leak it (and
            # crash the resubmit/hedge threads re-encoding it) — fail
            # THIS request, the client stays healthy
            self._fail_request(req, exc)
        except OSError as exc:
            if not self.reconnect:
                # surface on THIS request only — a broken pipe must not
                # poison the client object (regression-tested with a torn
                # raw socket)
                with self._plock:
                    self._reqs.pop(rid, None)
                if not req.future.done():
                    req.future.set_exception(ConnectionError(
                        f"decode submit hit a dead connection: {exc}"))
            # with reconnect: leave it registered — the reader notices
            # the dead socket and resubmits on the fresh connection
        return req.future

    def decode(self, session: str, syndromes, *,
               tenant: str | None = None,
               trace: "tracing.TraceContext | None" = None) -> ClientResult:
        return self.submit(session, syndromes, tenant=tenant,
                           trace=trace).result(timeout=self.timeout)

    # ------------------------------------------------------------------
    # streaming decode
    # ------------------------------------------------------------------
    def _submit_raw(self, msg: dict) -> Future:
        """Send one raw (stream) op; the future resolves with the raw
        response dict.  Never retained for resubmit or hedging — a raw
        request that loses its transport fails with ``ConnectionError``
        and its CALLER retries (the server's per-seq replay cache makes
        that exactly-once)."""
        rid = f"{self._prefix}-{next(self._ids)}"
        req = _Inflight(None, time.perf_counter(), raw=True)
        with self._plock:
            if self._closed:
                raise RuntimeError("client closed")
            if self._dead:
                req.future.set_exception(ConnectionError(
                    "decode-service connection closed"))
                return req.future
            req.rids.add(rid)
            self._reqs[rid] = req
        try:
            self._send({**msg, "id": rid})
        except ValueError as exc:
            self._fail_request(req, exc)
        except OSError as exc:
            # even with reconnect enabled a raw request does NOT ride the
            # resubmit (base is None): fail it here so the caller's retry
            # loop owns the resend
            self._fail_request(req, ConnectionError(
                f"stream op hit a dead connection: {exc}"))
        return req.future

    def _stream_rpc(self, msg: dict, *, retries: int = 8) -> dict:
        """Raw op + retry-on-transport-death loop.  Safe for every stream
        op: ``stream_open`` before any reply is idempotent-by-reopen-cost
        only at the caller's discretion (retried opens may mint an orphan
        stream server-side; harmless — shed/shutdown reaps it), and
        chunk/commit retries are deduplicated by the server's seq
        ledger."""
        last: Exception | None = None
        for attempt in range(max(1, int(retries))):  # qldpc: ignore[R102]
            if attempt:
                resilience.sleep_for(self._dial_policy.delay(attempt))
            try:
                return self._submit_raw(msg).result(timeout=self.timeout)
            except ConnectionError as exc:
                last = exc
                continue
        raise ConnectionError(
            f"stream op failed after {retries} attempts: {last}")

    def stream_open(self, profile: str, *, lanes: int = 1,
                    tenant: str | None = None, retries: int = 8) -> dict:
        """Open an overlap-commit stream on ``profile`` (a registered
        stream profile, or a bare session name for a frame-mode stream).
        Returns the server's open ack (``stream`` id, ``width``,
        ``cycles_per_window``); raises on a structured error."""
        res = self._stream_rpc({"op": "stream_open", "profile": str(profile),
                                "lanes": int(lanes),
                                "tenant": tenant or self.tenant},
                               retries=retries)
        if not res.get("ok"):
            raise RuntimeError(res.get("error", "stream_open failed"))
        return res

    def stream_chunk(self, stream: str, seq: int, chunk) -> Future:
        """Send one window's detector increment; the future resolves with
        the raw response dict (commit payload, replay, or structured
        error).  Most callers want ``stream_step``."""
        arr = np.atleast_2d(np.asarray(chunk, np.uint8))
        return self._submit_raw({"op": "stream_chunk", "stream": str(stream),
                                 "seq": int(seq), "chunk": arr})

    def stream_step(self, stream: str, seq: int, chunk, *,
                    retries: int = 8) -> dict:
        """One committed window: send ``(stream, seq, chunk)`` and block
        for the commit payload.  A transport death or a transient "busy"
        retries the SAME seq — the server's commit-before-respond ledger
        either decodes it (never committed) or replays the cached commit
        (response lost on the wire), so the window lands exactly once.
        Terminal structured errors (shed, unknown stream, gap/stale)
        return the raw dict for the caller's resume logic."""
        arr = np.atleast_2d(np.asarray(chunk, np.uint8))
        msg = {"op": "stream_chunk", "stream": str(stream),
               "seq": int(seq), "chunk": arr}
        last: Exception | None = None
        for attempt in range(max(1, int(retries))):  # qldpc: ignore[R102]
            if attempt:
                resilience.sleep_for(self._dial_policy.delay(attempt))
            try:
                res = self._submit_raw(msg).result(timeout=self.timeout)
            except ConnectionError as exc:
                last = exc
                continue
            if res.get("stream_error") == "busy":
                # the previous transmission of this seq is still decoding
                # server-side (our response died on the wire): wait for
                # its commit, then the retry replays from cache
                last = RuntimeError(res.get("error", "stream busy"))
                continue
            return res
        raise ConnectionError(
            f"stream step seq={seq} failed after {retries} attempts: {last}")

    def stream_commit(self, stream: str, *, close: bool = False,
                      retries: int = 8) -> dict:
        """Commit-watermark query (the resume handshake after a kill) or,
        with ``close=True``, retire the stream."""
        msg = {"op": "stream_commit", "stream": str(stream)}
        if close:
            msg["close"] = True
        return self._stream_rpc(msg, retries=retries)

    def ping(self) -> dict:
        fut: Future = Future()
        # register + send atomically under the WRITE lock: pongs match
        # waiters FIFO, so the waiter-queue order must equal the on-wire
        # send order (two threads racing between the two steps would
        # receive each other's pong).  Lock order is _wlock -> _plock;
        # no other path nests them, so no inversion.
        with self._wlock:
            with self._plock:
                if self._closed:
                    raise RuntimeError("client closed")
                if self._dead:
                    # no reader is alive to match a pong: a send could
                    # still "succeed" into the dead socket's buffer and
                    # the caller would block the full timeout
                    raise ConnectionError(
                        "decode-service connection closed")
                self._pongs.append(fut)
            frame = encode_frame({"op": "ping"})
            telemetry.count("serve.client.bytes_tx", len(frame))
            self._sock.sendall(frame)
        return fut.result(timeout=self.timeout)

    def close(self) -> None:
        with self._plock:
            self._closed = True
        self._stop.set()
        # the CURRENT socket, atomically with any in-flight reconnect
        # swap (the swap's own post-swap _closed check covers the other
        # interleaving: a socket swapped in after this closes itself)
        with self._wlock:
            sock = self._sock
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        sock.close()
        self._reader.join(timeout=10.0)
        if self._hedger is not None:
            self._hedger.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
