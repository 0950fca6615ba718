"""Asyncio front-end for the decode service: stdlib TCP, length-prefixed
frames (JSON v1 or packed-binary v2), streamed per-request responses,
graceful drain.

Wire protocol (no dependencies beyond the stdlib; serve/wire.py owns the
codec):

    frame    := uint32 big-endian payload length | payload
    payload  := one UTF-8 JSON object (v1) | packed binary (v2, )

Requests (client -> server; v2 ships the same fields with the syndromes as
a packed gf2_packed body instead of a JSON matrix):
    {"op": "decode", "id": <str>, "session": <name>, "tenant": <str>,
     "syndromes": [[0,1,...], ...],
     "trace": {"trace_id": ..., "span_id": ...}}   # OPTIONAL
    {"op": "ping"}
    {"op": "hello", "codecs": [2, 1]}              # codec negotiation

Responses (server -> client; decode responses stream back in COMPLETION
order, matched by "id" — a slow megabatch never head-of-line-blocks a fast
one — and each response is encoded in the codec its request arrived in):
    {"id": ..., "ok": true, "corrections": [[...], ...],
     "converged": [true, ...] | null, "latency_ms": <float>,
     "trace_id": "..."}                            # echoed when traced
    {"id": ..., "ok": false, "error": "...", "shed": true?}
    {"ok": true, "pong": true, "sessions": [...], "draining": false}
    {"ok": true, "hello": true, "codec": 2, "codecs": [1, 2], ...}

A traced request (optional "trace" field, utils.tracing.TraceContext wire
shape) gets a ``serve.request`` root span covering submit -> response
serialized, parented to the client's span; the batcher records the stage
spans (queue_wait / batch_assemble / pad / device_decode / slice) under
it and the server adds the ``respond`` span.  A tenant shed by the SLO
admission signal (serve.ops) is answered with ``"shed": true`` — refused
loudly and cheaply, never queued and timed out.

Codec handling: JSON keeps the protocol inspectable; v2 (negotiated via
"hello" at connect, self-describing per frame through the magic) ships the
bitplanes in the gf2_packed device layout — mixed v1/v2 clients coexist on
one server.  A malformed BINARY payload is answered with a structured
error and the connection keeps serving (the outer frame boundary is
intact); malformed JSON keeps its pre-v2 semantics (answer, then close —
v1 framing errors are indistinguishable from stream corruption).
``serve.bytes_rx`` / ``serve.bytes_tx`` count every framed byte both ways
and the ``wire.codec_version`` gauge records the last negotiated codec.

``shutdown(drain=True)`` is the graceful path: stop accepting connections,
reject NEW decode ops with an error response, drain the batcher (every
accepted request completes and its response is written) and only then close
— no accepted request is ever dropped (tests/test_serve.py pins this).
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
import uuid

import numpy as np

from ..utils import faultinject, telemetry, tracing
from .ops import AdmissionError, spawn_server_loop
from .scheduler import ContinuousBatcher
from .session import StreamProfile, StreamProtocolError, StreamSession
from .wire import (
    HEADER,
    IDEM_FIELD,
    MAX_FRAME_BYTES,
    ROUTE_FIELD,
    TRACE_FIELD,
    WIRE_CODEC_JSON,
    WIRE_CODEC_PACKED,
    WIRE_CODECS,
    WireCodecError,
    decode_payload,
    encode_frame,
    encode_response_frame,
)

__all__ = ["DecodeServer", "ServerHandle", "start_server_thread",
           "MAX_FRAME_BYTES", "encode_frame"]


# idempotency keys are wire-controlled strings that key the scheduler's
# journal — bound them like trace ids; an oversize key is treated as
# absent (counted), never an error that kills the request
_MAX_IDEM_CHARS = 128


def _wire_idem(msg) -> str | None:
    idem = msg.get(IDEM_FIELD)
    if not isinstance(idem, str) or not idem:
        return None
    if len(idem) > _MAX_IDEM_CHARS:
        telemetry.count("serve.idem_oversize")
        return None
    return idem


async def read_frame(reader: asyncio.StreamReader):
    """One length-prefixed payload's RAW bytes, or None on EOF /
    disconnect — including a client dropping MID-frame (after the header,
    before the full body), which must take the clean-disconnect path, not
    kill the connection task with an unretrieved exception.  Decoding
    (JSON v1 / packed v2) is the caller's ``wire.decode_payload``."""
    try:
        head = await reader.readexactly(HEADER.size)
        (length,) = HEADER.unpack(head)
        if length > MAX_FRAME_BYTES:
            raise ValueError(f"frame of {length} bytes exceeds the "
                             f"{MAX_FRAME_BYTES}-byte cap")
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    return body


class DecodeServer:
    """The asyncio service: accepts connections, feeds decode ops to the
    ContinuousBatcher, streams responses back per request."""

    def __init__(self, batcher: ContinuousBatcher, host: str = "127.0.0.1",
                 port: int = 0, stream_profiles: dict | None = None):
        self.batcher = batcher
        self.host = host
        self.port = int(port)
        self._server: asyncio.AbstractServer | None = None
        self._tasks: set[asyncio.Task] = set()
        self._conns: set[asyncio.Task] = set()
        self._draining = False
        # streaming decode: named open recipes + the live
        # per-stream overlap-commit sessions.  A registered session name
        # doubles as an implicit frame-mode profile, so phenom-style
        # streams need no registration.
        self.stream_profiles: dict[str, StreamProfile] = dict(
            stream_profiles or {})
        self._streams: dict[str, StreamSession] = {}
        self._stream_counter = 0
        # stream ids carry a per-server random prefix: a fleet
        # re-homes streams ACROSS hosts by id, and two hosts both minting
        # "st-0001" would collide in the successor's ledger on handoff
        self._stream_prefix = uuid.uuid4().hex[:6]
        # routing-epoch fence: family -> (epoch, own).  Set by
        # the fleet router's ``family_adopt`` broadcasts; a routed frame
        # whose (family, epoch) this host does not currently own is
        # refused with ``route_stale`` so a partitioned router's stale
        # placement can never cause a double decode on the old owner.
        # Direct (un-routed) frames bypass the fence entirely — single-
        # host deployments never see it.
        self._family_epochs: dict[str, tuple[int, bool]] = {}

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    # ------------------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)
        wlock = asyncio.Lock()
        try:
            while True:
                try:
                    payload = await read_frame(reader)
                except ValueError as exc:
                    await self._write(writer, wlock,
                                      {"ok": False,
                                       "error": f"bad frame: {exc}"})
                    break
                if payload is None:
                    break
                telemetry.count("serve.bytes_rx",
                                len(payload) + HEADER.size)
                # network chaos: under a fault plan this frame
                # may be answered with a torn frame and/or the connection
                # hard-dropped — the client's reconnect + resubmit path
                # (deduped by the scheduler journal) must recover
                if await self._consume_conn_fault(
                        lambda on: faultinject.site(
                            "serve_conn_rx",
                            actions={"conn_drop": on, "torn_frame": on,
                                     "stall": on}),
                        writer, wlock):
                    break
                try:
                    msg = decode_payload(payload)
                except WireCodecError as exc:
                    # malformed v2 payload: the OUTER frame boundary is
                    # intact (the length prefix framed it), so only THIS
                    # request is lost — answer a structured error and
                    # keep serving everything pipelined on the connection
                    telemetry.count("serve.wire_errors")
                    await self._write(writer, wlock, {
                        "id": exc.request_id, "ok": False,
                        "error": f"bad frame: {exc}"})
                    continue
                except (json.JSONDecodeError, UnicodeDecodeError) as exc:
                    await self._write(writer, wlock,
                                      {"ok": False,
                                       "error": f"bad frame: {exc}"})
                    break
                if not isinstance(msg, dict):
                    # valid JSON but not an object: a structured reply,
                    # not a dead connection for everything pipelined on it
                    await self._write(writer, wlock, {
                        "ok": False,
                        "error": f"frame must be a JSON object, got "
                                 f"{type(msg).__name__}"})
                    continue
                op = msg.get("op")
                route = msg.pop(ROUTE_FIELD, None)
                if route is not None and not self._route_ok(route):
                    # the epoch fence: this host does not (or no longer)
                    # own(s) the frame's family at the router's epoch —
                    # refuse loudly so the router re-resolves placement
                    # and re-forwards; dispatching here could double-
                    # decode against the family's real owner
                    telemetry.count("serve.route_stale")
                    cur = self._family_epochs.get(str(route.get("family")))
                    await self._write(writer, wlock, {
                        "id": msg.get("id"), "ok": False,
                        "route_stale": True,
                        "family": route.get("family"),
                        "epoch": 0 if cur is None else int(cur[0]),
                        "error": "routed frame fenced: host does not own "
                                 "this family at that epoch"})
                    continue
                if op == "ping":
                    await self._write(writer, wlock, {
                        "ok": True, "pong": True,
                        "sessions": self.batcher.sessions.names(),
                        "draining": self._draining})
                elif op == "decode":
                    await self._handle_decode(msg, writer, wlock)
                elif op == "hello":
                    await self._write(writer, wlock, self._hello(msg))
                elif op == "stream_open":
                    await self._write(writer, wlock, self._stream_open(msg))
                elif op == "stream_chunk":
                    if await self._handle_stream_chunk(msg, writer, wlock):
                        break  # chaos killed the connection mid-window
                elif op == "stream_commit":
                    await self._write(writer, wlock,
                                      self._stream_commit(msg))
                elif op == "family_adopt":
                    await self._write(writer, wlock,
                                      self._family_adopt(msg))
                elif op == "journal_export":
                    await self._write(writer, wlock,
                                      self._journal_export(msg))
                elif op == "journal_import":
                    await self._write(writer, wlock,
                                      self._journal_import(msg))
                else:
                    await self._write(writer, wlock, {
                        "id": msg.get("id"), "ok": False,
                        "error": f"unknown op {op!r}"})
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _consume_conn_fault(self, consult, writer, wlock) -> bool:
        """Consult one wire chaos site and enact the result: ``consult``
        performs the literal ``faultinject.site`` call (the literal stays
        at the call site — R008 pins one plant per site name) with a
        shared on-hit callback for the kinds that site enacts.  A
        stall-kind fault sleeps ASYNC so it stalls only this connection,
        never the event loop; drop kinds (and any raise-kind fault at the
        site) kill the connection.  Returns True when the connection is
        dead and the caller must stop using it."""
        hit = []
        try:
            consult(hit.append)
        except Exception:  # noqa: BLE001 — raise kinds drop the conn too
            hit.append(None)
        if not hit:
            return False
        fault = hit[0]
        if fault is not None and fault.kind == "stall":
            await asyncio.sleep(fault.stall_s)
            return False
        await self._enact_conn_fault(writer, wlock, fault)
        return True

    @staticmethod
    async def _enact_conn_fault(writer, wlock, fault) -> None:
        """Enact one network chaos fault: ``torn_frame`` writes a length
        header promising more bytes than follow (the torn wire a dying
        peer leaves) and then drops; ``conn_drop`` (and any raise-kind
        fault at the site, passed as None) hard-aborts the transport
        without flushing.  After this the connection is dead and the
        caller must stop serving it."""
        if fault is not None and fault.kind == "torn_frame":
            try:
                async with wlock:
                    # header claims a full frame; only a prefix follows
                    writer.write(HEADER.pack(1 << 16) + b'{"torn":')
                    await writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        telemetry.count("serve.chaos.conn_drops")
        try:
            writer.transport.abort()
        except Exception:  # noqa: BLE001 — already dead is fine
            pass

    def _hello(self, msg) -> dict:
        """Codec negotiation: pick the highest wire codec both
        ends speak.  The reply tells the client what to SEND; responses
        always mirror each request's arrival codec, so the negotiation
        never needs per-connection state server-side."""
        offered = msg.get("codecs")
        if not isinstance(offered, (list, tuple)):
            offered = [WIRE_CODEC_JSON]
        usable = [int(c) for c in offered
                  if isinstance(c, (int, float)) and int(c) in WIRE_CODECS]
        codec = max(usable, default=WIRE_CODEC_JSON)
        telemetry.count(f"serve.codec.v{codec}_hellos")
        telemetry.set_gauge("wire.codec_version", codec)
        return {"ok": True, "hello": True, "codec": codec,
                "codecs": list(WIRE_CODECS),
                "streams": True,
                "sessions": self.batcher.sessions.names(),
                "draining": self._draining}

    # ------------------------------------------------------------------
    # fleet handoff plane: epoch fence + journal replication
    # ------------------------------------------------------------------
    def _route_ok(self, route) -> bool:
        """May a routed frame dispatch here?  Only when this host has been
        told (via ``family_adopt``) that it OWNS the frame's family, at an
        epoch no newer than the frame's — an un-adopted family or a frame
        carrying an older epoch than our fence means the router's
        placement view and ours disagree, and the router must re-resolve."""
        if not isinstance(route, dict):
            return False
        cur = self._family_epochs.get(str(route.get("family")))
        if cur is None or not cur[1]:
            return False
        try:
            return int(route.get("epoch", -1)) >= int(cur[0])
        except (TypeError, ValueError):
            return False

    def _family_adopt(self, msg) -> dict:
        """The router's placement assertion: ``own=True`` makes this host
        the family's dispatching owner at ``epoch``; ``own=False`` fences
        it off (the old owner after a handoff, or every non-owner on a
        placement broadcast).  Monotone in epoch — an older assertion
        (a partitioned router's late broadcast) never rolls the fence
        back.  Idempotent, so the router re-asserts freely."""
        rid = msg.get("id")
        family = str(msg.get("family", ""))
        if not family:
            return {"id": rid, "ok": False, "error": "family_adopt misses "
                                                     "its family"}
        try:
            epoch = int(msg.get("epoch", 0))
        except (TypeError, ValueError):
            return {"id": rid, "ok": False,
                    "error": f"bad epoch {msg.get('epoch')!r}"}
        own = bool(msg.get("own", True))
        cur = self._family_epochs.get(family)
        if cur is not None and epoch < cur[0]:
            return {"id": rid, "ok": False, "stale_epoch": True,
                    "family": family, "epoch": int(cur[0]),
                    "error": f"adopt epoch {epoch} is behind fence "
                             f"{cur[0]}"}
        missing = [s for s in (msg.get("sessions") or ())
                   if s not in self.batcher.sessions]
        if own and missing:
            return {"id": rid, "ok": False, "family": family,
                    "missing_sessions": missing,
                    "error": f"cannot adopt {family}: sessions {missing} "
                             "not resident on this host"}
        changed = cur != (epoch, own)
        self._family_epochs[family] = (epoch, own)
        if changed:
            # the router re-asserts placement periodically (idempotent
            # broadcasts) — only a real transition is worth an event
            telemetry.count("serve.family_adopts")
            telemetry.event("scale_event", action="family_adopt",
                            target=family, to_value=epoch,
                            reason=("own" if own else "fence"))
        return {"id": rid, "ok": True, "family": family, "epoch": epoch,
                "own": own}

    def _journal_export(self, msg) -> dict:
        """One replication pull: the scheduler's answered-LRU delta after
        the caller's watermark, plus every open stream's committed state
        (small: a carry plane + the cached replay response per stream).
        The fleet router feeds these to the family's successor so a
        handoff replays instead of re-decoding."""
        rid = msg.get("id")
        try:
            since = int(msg.get("since", 0))
        except (TypeError, ValueError):
            return {"id": rid, "ok": False,
                    "error": f"bad since {msg.get('since')!r}"}
        snap = self.batcher.export_journal(since=since)
        snap["streams"] = [s.export_state()
                           for s in list(self._streams.values())]
        # warm-program manifest: which (bucket, sharded)
        # programs each resident session is serving warm.  The router
        # forwards it to the family's ring successor, which pre-LOADS the
        # same programs from the persistent cache — adoption then answers
        # its first frame without a compile stall.
        programs = {}
        for name in self.batcher.sessions.names():
            try:
                sess = self.batcher.sessions.get(name)
                keys = getattr(sess, "warm_keys", None)
                if callable(keys):
                    warm = keys()
                    if warm:
                        programs[name] = warm
            except Exception:  # noqa: BLE001 — eviction race: skip
                continue
        snap["programs"] = programs
        return {"id": rid, "ok": True, **snap}

    def _journal_import(self, msg) -> dict:
        """One replication push: merge a peer host's ``journal_export``
        delta.  Answered entries join the local answered-LRU (idempotent
        by key); stream states rebuild or advance local ``StreamSession``
        ledgers under their ORIGINAL ids, so after adoption the client's
        same-seq retries replay or resume exactly-once."""
        rid = msg.get("id")
        snap = msg.get("snapshot")
        if not isinstance(snap, dict):
            return {"id": rid, "ok": False,
                    "error": "journal_import misses its snapshot"}
        imported = self.batcher.import_journal(snap)
        streams = 0
        for state in snap.get("streams", ()):
            sid = state.get("stream")
            if not sid:
                continue
            stream = self._streams.get(sid)
            if stream is None:
                stream = self._rebuild_stream(state)
                if stream is None:
                    telemetry.count("serve.stream_import_failures")
                    continue
                self._streams[sid] = stream
                telemetry.set_gauge("stream.open_streams",
                                    len(self._streams))
            if stream.import_state(state):
                streams += 1
        # warm-start pre-load: LOAD the pushed manifest's
        # programs from the persistent cache — strictly load-only
        # (``adopt_program`` never compiles; a miss is a no-op), because
        # this runs on the control plane of a host that is still serving
        # its own families and a compile here would stall live traffic.
        loaded = 0
        for name, keys in (snap.get("programs") or {}).items():
            try:
                sess = self.batcher.sessions.get(str(name))
            except KeyError:
                continue
            adopt = getattr(sess, "adopt_program", None)
            if not callable(adopt):
                continue
            for entry in keys or ():
                try:
                    bucket, sharded = entry
                    if adopt(int(bucket), bool(sharded)):
                        loaded += 1
                        telemetry.count("serve.progcache_warm_loaded")
                    else:
                        telemetry.count("serve.progcache_warm_skipped")
                except Exception:  # noqa: BLE001 — warm-start best effort
                    telemetry.count("serve.progcache_warm_skipped")
        return {"id": rid, "ok": True, "imported": int(imported),
                "streams": int(streams), "programs_loaded": int(loaded),
                "watermark": int(snap.get("watermark", 0))}

    def _rebuild_stream(self, state) -> "StreamSession | None":
        """Reconstruct a replicated stream's ledger from its exported
        state: the profile (or bare session, frame mode) must be resident
        here — the router only pairs hosts serving the same session set."""
        name = str(state.get("profile") or "")
        profile = self.stream_profiles.get(name)
        if profile is None:
            if name not in self.batcher.sessions:
                return None
            profile = StreamProfile(session=name)
        try:
            session = self.batcher.sessions.get(profile.session)
            stream = StreamSession(
                str(state["stream"]), session,
                lanes=int(state.get("lanes", 1)),
                space_cor=profile.space_cor, log_mat=profile.log_mat,
                cycles_per_window=profile.cycles_per_window,
                tenant=str(state.get("tenant", "default")))
        except (KeyError, ValueError, TypeError):
            return None
        stream.profile_name = name
        return stream

    # ------------------------------------------------------------------
    # streaming decode
    # ------------------------------------------------------------------
    def _stream_open(self, msg) -> dict:
        """Open one stream: mint an id, build the per-stream overlap-
        commit ledger over the profile's DecodeSession.  A registered
        session name with no profile opens a frame-mode stream on it."""
        rid = msg.get("id")
        if self._draining:
            return {"id": rid, "ok": False, "error": "server is draining"}
        name = str(msg.get("profile") or msg.get("session") or "")
        profile = self.stream_profiles.get(name)
        if profile is None:
            try:
                self.batcher.sessions.get(name)
            except KeyError:
                return {"id": rid, "ok": False,
                        "error": f"unknown stream profile or session "
                                 f"{name!r}"}
            profile = StreamProfile(session=name)
        try:
            session = self.batcher.sessions.get(profile.session)
        except KeyError:
            return {"id": rid, "ok": False,
                    "error": f"stream profile {name!r} names unknown "
                             f"session {profile.session!r}"}
        tenant = str(msg.get("tenant", "default"))
        try:
            lanes = int(msg.get("lanes", 1))
        except (TypeError, ValueError):
            return {"id": rid, "ok": False,
                    "error": f"lanes must be an int, got "
                             f"{msg.get('lanes')!r}"}
        self._stream_counter += 1
        sid = f"st-{self._stream_prefix}-{self._stream_counter:04d}"
        try:
            stream = StreamSession(
                sid, session, lanes=lanes, space_cor=profile.space_cor,
                log_mat=profile.log_mat,
                cycles_per_window=profile.cycles_per_window, tenant=tenant)
        except ValueError as exc:
            return {"id": rid, "ok": False, "error": str(exc)}
        # the opening profile name travels with the stream's exported
        # state so a successor host can rebuild the ledger on handoff
        stream.profile_name = name
        self._streams[sid] = stream
        telemetry.count("stream.opens")
        telemetry.set_gauge("stream.open_streams", len(self._streams))
        telemetry.event("stream_open", stream=sid, session=profile.session,
                        tenant=tenant, lanes=stream.lanes,
                        width=stream.width,
                        cycles_per_window=stream.cycles_per_window)
        return {"id": rid, "ok": True, "stream": sid, "committed": 0,
                "lanes": stream.lanes, "width": stream.width,
                "cycles_per_window": stream.cycles_per_window}

    def _stream_commit(self, msg) -> dict:
        """Watermark query / close: the resume handshake.  After a kill
        mid-window the client asks where to continue; ``close`` retires
        the stream."""
        rid = msg.get("id")
        sid = msg.get("stream")
        stream = self._streams.get(sid)
        if stream is None:
            return {"id": rid, "ok": False, "stream": sid,
                    "stream_unknown": True,
                    "error": f"unknown stream {sid!r} (shed, closed, or "
                             "never opened)"}
        snap = stream.snapshot()
        if msg.get("close"):
            self._streams.pop(sid, None)
            info = stream.close()
            telemetry.set_gauge("stream.open_streams", len(self._streams))
            telemetry.event("stream_close", stream=str(sid),
                            committed=info["committed"],
                            committed_cycles=info["committed_cycles"],
                            reason="client")
            snap["closed"] = True
        return {"id": rid, "ok": True, **snap}

    async def _handle_stream_chunk(self, msg, writer, wlock) -> bool:
        """One window's detector increment.  Returns True when chaos
        killed the connection (the caller stops serving it).

        Commit protocol: the chunk decodes through the batcher (journaled
        ``stream:<id>:<seq>`` idempotency key, co-family fusion for free),
        then the StreamSession folds the corrections into the carry and
        advances the watermark atomically — replays of a committed seq get
        the cached response without re-decoding, so a kill anywhere in
        this path loses at most uncommitted work, never doubles a commit."""
        rid = msg.get("id")
        codec = int(msg.get("_codec", WIRE_CODEC_JSON))
        sid = msg.get("stream")
        stream = self._streams.get(sid)
        if stream is None:
            await self._write(writer, wlock, {
                "id": rid, "ok": False, "stream": sid,
                "stream_unknown": True,
                "error": f"unknown stream {sid!r} (shed, closed, or "
                         "never opened)"})
            return False
        # stream chaos: the step dies mid-window — after the chunk was
        # read, before decode/commit.  Nothing was committed, so the
        # client's resume path (stream_commit watermark query + resend)
        # must land the window exactly once.
        if await self._consume_conn_fault(
                lambda on: faultinject.site(
                    "serve_stream_step",
                    actions={"stream_kill": on, "conn_drop": on,
                             "stall": on}),
                writer, wlock):
            return True
        seq = msg.get("seq")
        chunk = msg.get("chunk")
        if chunk is None:
            await self._write(writer, wlock, {
                "id": rid, "ok": False, "stream": stream.stream_id,
                "error": "stream chunk misses its chunk plane"})
            return False
        try:
            action, staged = stream.prepare(seq, chunk)
        except StreamProtocolError as exc:
            telemetry.count("stream.protocol_errors")
            await self._write(writer, wlock, {
                "id": rid, "ok": False, "stream": stream.stream_id,
                "stream_error": exc.code, "committed": stream.committed,
                "error": str(exc)})
            return False
        if action == "replay":
            payload = dict(staged, id=rid, replayed=True)
            await self._write_stream_response(writer, wlock, payload, codec)
            return False
        try:
            fut = self.batcher.submit(
                stream.session.name, staged, tenant=stream.tenant,
                request_id=None if rid is None else str(rid),
                idem=f"stream:{stream.stream_id}:{int(seq)}")
        except AdmissionError as exc:
            # the streaming SLO rung: burn-rate pressure sheds the WHOLE
            # stream, not one chunk — its state is dropped, the client is
            # told loudly, and subsequent chunks answer "unknown stream"
            # (reopen when the burn subsides)
            stream.abort(int(seq))
            self._streams.pop(stream.stream_id, None)
            stream.close()
            telemetry.count("stream.shed")
            telemetry.set_gauge("stream.open_streams", len(self._streams))
            telemetry.event("stream_shed", stream=stream.stream_id,
                            tenant=exc.tenant, committed=stream.committed,
                            burn_rate=float(exc.burn_rate),
                            signal=str(exc.signal))
            await self._write(writer, wlock, {
                "id": rid, "ok": False, "stream": stream.stream_id,
                "shed": True, "stream_shed": True,
                "committed": stream.committed,
                "error": f"{type(exc).__name__}: {exc}"})
            return False
        except Exception as exc:  # noqa: BLE001 — answered, not dropped
            stream.abort(int(seq))
            await self._write(writer, wlock, {
                "id": rid, "ok": False, "stream": stream.stream_id,
                "committed": stream.committed,
                "error": f"{type(exc).__name__}: {exc}"})
            return False
        task = asyncio.ensure_future(self._stream_respond(
            rid, stream, int(seq), fut, writer, wlock, codec))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return False

    async def _stream_respond(self, rid, stream, seq, fut, writer, wlock,
                              codec) -> None:
        try:
            res = await asyncio.wrap_future(fut)
        except Exception as exc:  # noqa: BLE001
            stream.abort(seq)
            try:
                await self._write(writer, wlock, {
                    "id": rid, "ok": False, "stream": stream.stream_id,
                    "committed": stream.committed,
                    "error": f"{type(exc).__name__}: {exc}"})
            except (ConnectionError, RuntimeError):
                pass
            return
        try:
            payload = stream.commit(seq, res.corrections,
                                    converged=res.converged)
        except StreamProtocolError as exc:
            # the stream was shed/closed while its decode was in flight
            try:
                await self._write(writer, wlock, {
                    "id": rid, "ok": False, "stream": stream.stream_id,
                    "stream_error": exc.code,
                    "committed": stream.committed, "error": str(exc)})
            except (ConnectionError, RuntimeError):
                pass
            return
        payload["id"] = rid
        payload["latency_ms"] = round(res.latency_s * 1e3, 3)
        try:
            await self._write_stream_response(writer, wlock, payload, codec)
        except (ConnectionError, RuntimeError):
            # the commit stands; a reconnecting client replays this seq
            # and gets the cached response
            pass

    async def _write_stream_response(self, writer, wlock, payload,
                                     codec) -> None:
        if codec != WIRE_CODEC_PACKED:
            payload = dict(payload,
                           corrections=np.asarray(
                               payload["corrections"]).tolist())
        await self._write(writer, wlock, payload, codec=codec)

    async def _handle_decode(self, msg, writer, wlock) -> None:
        rid = msg.get("id")
        codec = int(msg.get("_codec", WIRE_CODEC_JSON))
        # trace propagation: the optional wire field becomes a
        # request context whose span id IS the serve.request root span —
        # pre-minted here so the batcher's stage spans parent to it, and
        # recorded at respond time with the client's span as ITS parent
        client_ctx = tracing.TraceContext.from_wire(msg.get(TRACE_FIELD))
        req_ctx = None if client_ctx is None else client_ctx.child()
        t_accept = time.perf_counter()
        if self._draining:
            # refused like every other rejection: a traced request still
            # gets its serve.request span and echoed trace id
            await self._write(writer, wlock, self._rejection(
                rid, RuntimeError("server is draining"),
                req_ctx, client_ctx, t_accept))
            return
        try:
            fut = self.batcher.submit(
                msg["session"],
                np.asarray(msg["syndromes"], dtype=np.uint8),
                tenant=str(msg.get("tenant", "default")),
                request_id=None if rid is None else str(rid),
                trace=req_ctx,
                idem=_wire_idem(msg))
        except AdmissionError as exc:
            # the SLO gate: shed traffic is answered with a structured
            # flag so load generators can tell backpressure from bugs
            await self._write(writer, wlock, self._rejection(
                rid, exc, req_ctx, client_ctx, t_accept,
                shed=True, tenant=exc.tenant, burn_rate=exc.burn_rate))
            return
        except Exception as exc:  # noqa: BLE001 — answered, not dropped
            await self._write(writer, wlock, self._rejection(
                rid, exc, req_ctx, client_ctx, t_accept))
            return
        task = asyncio.ensure_future(
            self._respond(rid, fut, writer, wlock,
                          client_ctx=client_ctx, req_ctx=req_ctx,
                          t_accept=t_accept, codec=codec))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    @staticmethod
    def _rejection(rid, exc, req_ctx, client_ctx, t_accept,
                   **extra) -> dict:
        """Error payload for a request refused at submit.  A TRACED
        rejection still gets its serve.request root span (ok=False) and
        the echoed trace id — the requests an operator most wants to
        find in /tracez are the ones being refused."""
        error = f"{type(exc).__name__}: {exc}"
        payload = {"id": rid, "ok": False, "error": error, **extra}
        if req_ctx is not None:
            payload["trace_id"] = req_ctx.trace_id
            tracing.record_span(
                "serve.request", req_ctx, span_id=req_ctx.span_id,
                parent_id=client_ctx.span_id,
                dur_s=time.perf_counter() - t_accept, ok=False,
                error=error,
                **({} if rid is None else {"request_id": str(rid)}))
        return payload

    async def _respond(self, rid, fut, writer, wlock, *, client_ctx=None,
                       req_ctx=None, t_accept=0.0,
                       codec=WIRE_CODEC_JSON) -> None:
        ok = True
        error = None
        packed = codec == WIRE_CODEC_PACKED
        try:
            res = await asyncio.wrap_future(fut)
            payload = {
                "id": rid, "ok": True,
                # v1 serializes via .tolist() at encode time (native ints,
                # no int64 copy); v2 packs the np planes directly — the
                # response codec mirrors the request's
                "corrections": (res.corrections if packed
                                else res.corrections.tolist()),
                "converged": (None if res.converged is None
                              else [bool(x) for x in res.converged]),
                "latency_ms": round(res.latency_s * 1e3, 3),
            }
        except Exception as exc:  # noqa: BLE001
            ok, error = False, f"{type(exc).__name__}: {exc}"
            packed = False  # errors are structured JSON in every codec
            payload = {"id": rid, "ok": False, "error": error}
        if req_ctx is not None:
            payload["trace_id"] = req_ctx.trace_id
        t_write = time.perf_counter()
        # response-path chaos: the connection dies with the answer already
        # computed but unwritten — the client resubmits on its new
        # connection and the scheduler's answered-LRU replays the result
        # instead of decoding twice (the exactly-once window this site
        # exists to pin)
        if await self._consume_conn_fault(
                lambda on: faultinject.site(
                    "serve_respond",
                    actions={"conn_drop": on, "stall": on}),
                writer, wlock):
            return
        try:
            await self._write(writer, wlock, payload,
                              codec=(WIRE_CODEC_PACKED if packed
                                     else WIRE_CODEC_JSON))
        except (ConnectionError, RuntimeError):
            pass  # client went away; the decode itself completed
        if req_ctx is not None:
            now = time.perf_counter()
            tracing.record_span(
                "respond", req_ctx, dur_s=now - t_write,
                **({} if rid is None else {"request_id": str(rid)}))
            # the request's root span: accept -> response written, with
            # the pre-minted span id the stage spans already parent to,
            # itself parented to the CLIENT's span
            tracing.record_span(
                "serve.request", req_ctx, span_id=req_ctx.span_id,
                parent_id=client_ctx.span_id, dur_s=now - t_accept,
                ok=ok, **({} if error is None else {"error": error}),
                **({} if rid is None else {"request_id": str(rid)}))

    # drain (await transport backpressure) only past this much buffered
    # response data: draining per frame costs an event-loop round-trip
    # per response, which measured as a real serving tax under pipelined
    # windows — the transport buffers small frames and TCP flow control
    # still bounds the total via the high-water mark
    _DRAIN_THRESHOLD = 256 * 1024

    @classmethod
    async def _write(cls, writer, wlock, obj,
                     codec=WIRE_CODEC_JSON) -> None:
        try:
            frame = (encode_response_frame(obj, codec)
                     if codec == WIRE_CODEC_PACKED else encode_frame(obj))
        except ValueError as exc:
            # a response too large for one frame (huge decode batch):
            # answer the request with a structured error instead of
            # killing the connection mid-pipeline
            frame = encode_frame({"id": obj.get("id"), "ok": False,
                                  "error": str(exc)})
        telemetry.count("serve.bytes_tx", len(frame))
        async with wlock:
            writer.write(frame)
            if (writer.transport.get_write_buffer_size()
                    > cls._DRAIN_THRESHOLD):
                await writer.drain()

    # ------------------------------------------------------------------
    async def shutdown(self, drain: bool = True, grace_s: float = 0.25,
                       drain_timeout: float = 60.0) -> None:
        """Stop accepting connections; with ``drain``, serve for a short
        grace window (so request bytes already on the wire still reach the
        batcher), then flush the batcher so every accepted request's
        response is written, and only then close the remaining
        connections.  Requests arriving after the grace window get a
        structured "draining" error response — answered, never silently
        dropped."""
        if self._server is not None:
            # close() stops accepting immediately; wait_closed() is
            # deferred to the END — on Python >= 3.12.1 it also waits for
            # every live connection handler, which are only cancelled
            # below (awaiting it here would deadlock the graceful path
            # while pipelined clients stay connected)
            self._server.close()
        if drain and grace_s:
            await asyncio.sleep(grace_s)
        self._draining = True
        # both paths block (join the dispatcher thread): run off-loop so
        # in-flight response tasks keep streaming.  drain flushes every
        # queued request; the abandon path (drain=False) fails queued
        # futures IMMEDIATELY and stops the worker — without it the
        # response-task gather below would sit out the scheduler's
        # max_wait deadline and the dispatcher thread would leak
        await asyncio.get_running_loop().run_in_executor(
            None, ((lambda: self.batcher.drain(timeout=drain_timeout))
                   if drain else self.batcher.close))
        # retire surviving streams loudly: their watermarks are the last
        # committed cycles, so the accounting trail ends with a close
        for sid, stream in list(self._streams.items()):
            self._streams.pop(sid, None)
            info = stream.close()
            telemetry.event("stream_close", stream=str(sid),
                            committed=info["committed"],
                            committed_cycles=info["committed_cycles"],
                            reason="shutdown")
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        for conn in list(self._conns):
            conn.cancel()
        if self._conns:
            await asyncio.gather(*list(self._conns), return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
        if not drain:
            # the drained path already emitted its serve_drain from
            # batcher.drain() (with the real pending/completed counts) —
            # a second event here would double-count shutdowns downstream
            telemetry.event("serve_drain", pending_requests=-1,
                            completed=int(self.batcher.completed))

    async def abort_hard(self) -> None:
        """Die like a killed host: stop
        accepting, cancel every response/connection task BEFORE the
        batcher closes — so in-flight requests vanish as TRANSPORT death,
        never as structured error frames (a real power loss writes
        nothing) — and only then tear the batcher down.  Clients must
        recover purely through reconnect + idempotent resubmit against
        the family's successor host."""
        if self._server is not None:
            self._server.close()
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        for conn in list(self._conns):
            conn.cancel()
        if self._conns:
            await asyncio.gather(*list(self._conns), return_exceptions=True)
        # the draining flag only flips AFTER every connection is gone: a
        # conn task processing its last frame between our cancel and its
        # next await point must die silently, not answer a structured
        # "draining" refusal — the client would take that as a permanent
        # per-request failure instead of resubmitting to the successor
        self._draining = True
        await asyncio.get_running_loop().run_in_executor(
            None, self.batcher.close)
        # streams die with the host — NO stream_close events: the ledger
        # state survives only through what replication already exported
        self._streams.clear()
        if self._server is not None:
            await self._server.wait_closed()
        telemetry.count("serve.host_kills")


class ServerHandle:
    """A DecodeServer running on its own event-loop thread (what the bench
    and tests use — the caller's thread stays free to drive clients)."""

    def __init__(self, server: DecodeServer, loop: asyncio.AbstractEventLoop,
                 thread: threading.Thread):
        self.server = server
        self._loop = loop
        self._thread = thread

    @property
    def address(self) -> tuple[str, int]:
        return (self.server.host, self.server.port)

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        try:
            # the batcher's drain deadline is the binding one (it raises
            # the informative TimeoutError); the outer wait gets headroom
            # so it cannot fire first and kill a near-deadline drain
            asyncio.run_coroutine_threadsafe(
                self.server.shutdown(drain=drain, drain_timeout=timeout),
                self._loop).result(timeout + 15.0)
        finally:
            # even a failed/timed-out drain must tear the loop thread down
            # — leaving it running would leak the thread and keep client
            # connections open with no one serving them
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=timeout)

    def kill(self, timeout: float = 15.0) -> None:
        """Hard host death (``host_kill`` chaos): no drain, no error
        frames — connections just die.  See ``DecodeServer.abort_hard``."""
        try:
            asyncio.run_coroutine_threadsafe(
                self.server.abort_hard(), self._loop).result(timeout)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=timeout)


def start_server_thread(batcher: ContinuousBatcher, host: str = "127.0.0.1",
                        port: int = 0,
                        stream_profiles: dict | None = None) -> ServerHandle:
    """Start a DecodeServer on a daemon thread; returns once it accepts."""
    server = DecodeServer(batcher, host=host, port=port,
                          stream_profiles=stream_profiles)
    loop, thread = spawn_server_loop(server.start, "qldpc-serve-server",
                                     "decode server")
    return ServerHandle(server, loop, thread)
