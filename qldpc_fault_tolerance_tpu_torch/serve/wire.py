"""The decode service's wire format, defined ONCE for both ends.

    frame   := uint32 big-endian payload length | payload
    payload := one UTF-8 JSON object            (codec v1)
             | binary payload (below)           (codec v2, )

serve/server.py (asyncio) and serve/client.py (blocking sockets) both
import from here, so a protocol change cannot drift one-sided and silently
break the wire.

Packed binary codec (v2, ): JSON frames ship a syndrome bit as
~2 chars and a correction bit the same way — at serving rates the wire and
the JSON encode/decode dominate the request cost.  Codec v2 keeps the
OUTER frame layer (length prefix, caps, the chaos sites) untouched and
replaces the payload:

    payload := magic "QW" | version u8 | kind u8 | header_len u32 BE
             | header (one small UTF-8 JSON object: id / session / tenant
               / idem / trace / shots / width ... — everything but the
               bitplanes)
             | body (the packed bitplanes)

The body is the ``ops/gf2_packed`` device layout verbatim: 32 shots per
uint32 lane word, shot ``32*w + j`` in bit ``j`` (LSB-first) of word ``w``,
words little-endian on the wire — so the server unpacks straight onto the
layout the device programs consume and packs corrections straight back.
``pack_plane`` / ``unpack_plane`` run a numpy ``packbits(bitorder=
"little")`` fast path (a torch call per request would contend with
the decode programs for the host), but the FIRST call of every process
round-trips a deterministic sample through the port's gf2_packed bodies on CPU
tensors (``pack_shots`` / ``unpack_shots`` / ``num_words``) and refuses to serve
on any mismatch, because a drifted reimplementation would corrupt every served correction while small round-trip tests still
pass.

Negotiation happens at connect: a client that wants v2 sends
``{"op": "hello", "codecs": [2, 1]}``; a v2 server answers ``{"ok": true,
"hello": true, "codec": 2, ...}`` and the client switches.  An old server
answers "unknown op" and the client stays on JSON — v1 clients and servers
keep working unchanged.  Every frame is self-describing (a JSON object can
never start with the magic), so a server answers each request in the codec
it arrived in and mixed v1/v2 clients coexist on one server.

Trace context: a decode request MAY carry an OPTIONAL
``"trace"`` field (``TRACE_FIELD``) holding ``{"trace_id": <hex str>,
"span_id": <hex str>}`` — the ``utils.tracing.TraceContext`` wire shape.
Old clients simply omit it and old servers ignore it, so the field is
backward compatible in both directions; a malformed annotation is dropped
server-side (``TraceContext.from_wire``), never an error — a bad trace
must not fail the decode it rides on.  Traced responses echo the trace id
back as ``"trace_id"`` so a client can join its result to the span tree.
On v2 frames the trace rides in the binary header, unchanged.

Idempotency: a decode request MAY carry an OPTIONAL ``"idem"``
field (``IDEM_FIELD``) — a client-minted idempotency key that stays the
SAME across reconnect resubmits and hedged duplicates of one logical
request, while the wire ``"id"`` is fresh per transmission.  The server's
``ContinuousBatcher`` journals accepted-but-unanswered keys and dedupes:
a duplicate submit attaches to the in-flight decode (or replays the
recently-answered result) instead of decoding twice — the exactly-once
half of the no-drop/no-duplicate serving guarantee.  Old clients omit the
field and old servers ignore it, so it is backward compatible both ways.
"""
from __future__ import annotations

import json
import struct
import threading

import numpy as np

import torch

from ..ops.gf2_packed import LANE, num_words, pack_shots, unpack_shots

__all__ = ["HEADER", "IDEM_FIELD", "MAX_FRAME_BYTES", "ROUTE_FIELD",
           "TRACE_FIELD", "WIRE_CODEC_JSON", "WIRE_CODEC_PACKED",
           "WIRE_CODECS", "WIRE_MAGIC", "WireCodecError", "encode_frame",
           "encode_request_frame", "encode_response_frame",
           "encode_routed_payload", "encode_stream_chunk_frame",
           "decode_payload", "pack_plane", "peek_response_id",
           "unpack_plane"]

HEADER = struct.Struct(">I")
MAX_FRAME_BYTES = 64 * 1024 * 1024  # a malformed length must not OOM us

# a wire-supplied shots*width product is bounded so a tiny packed frame
# cannot claim a dense plane that OOMs the server when unpacked
MAX_DENSE_BYTES = 256 * 1024 * 1024

# the optional trace-context field of a decode request (and the echoed
# trace id key of its response) — named here so neither end hard-codes it
TRACE_FIELD = "trace"

# the optional idempotency-key field of a decode request: constant across
# resubmits of one logical request, the dedupe key of the server journal
IDEM_FIELD = "idem"

# wire codec versions (negotiated via the "hello" op; every frame is also
# self-describing through the magic, so mixed clients coexist)
WIRE_CODEC_JSON = 1
WIRE_CODEC_PACKED = 2
WIRE_CODECS = (WIRE_CODEC_JSON, WIRE_CODEC_PACKED)

# a JSON payload always starts with "{" (both ends only ever frame
# objects), so this two-byte magic can never collide with codec v1
WIRE_MAGIC = b"QW"
_BIN_HEAD = struct.Struct(">2sBBI")  # magic | version | kind | header_len
BIN_KIND_REQUEST = 1
BIN_KIND_RESPONSE = 2
# streaming decode: one window's detector increment for an open
# stream — the body is one gf2_packed plane of lane words, exactly like a
# batch request, plus stream/seq bookkeeping in the header
BIN_KIND_STREAM = 3
# routed frame: the fleet router wraps a client payload in a
# one-level envelope naming the bucket family and the router's placement
# epoch; the body is the ORIGINAL payload verbatim (any codec), so the
# router never re-encodes bitplanes.  The owning host's epoch fence checks
# (family, epoch) before dispatch and answers ``route_stale`` on mismatch —
# a partitioned router can never double-decode through a stale placement.
BIN_KIND_ROUTED = 4

# the parsed routing envelope, attached by ``decode_payload`` to the inner
# message as ``msg[ROUTE_FIELD] = {"family": ..., "epoch": ...}``
ROUTE_FIELD = "_route"


class WireCodecError(ValueError):
    """A malformed v2 binary payload.  The OUTER frame boundary is intact
    (the length prefix framed it), so the server answers a structured
    error for THIS request and keeps serving the connection.
    ``request_id`` carries the offending request's id when the header
    parsed far enough to know it."""

    def __init__(self, message: str, request_id=None):
        super().__init__(message)
        self.request_id = request_id


def encode_frame(obj) -> bytes:
    """Encode one JSON (codec v1) frame, enforcing the cap on the SEND
    side too: an oversize payload raises here, per-request, instead of
    reaching the peer's read cap — which answers with "bad frame" and then
    closes the connection, collateral-failing every other request
    pipelined on it."""
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame of {len(body)} bytes exceeds the {MAX_FRAME_BYTES}-byte "
            "cap; split the request batch")
    return HEADER.pack(len(body)) + body


# ---------------------------------------------------------------------------
# packed bitplanes (the gf2_packed device layout, on the wire)
# ---------------------------------------------------------------------------
# The hot path is numpy ``packbits``/``unpackbits`` (bitorder="little"):
# a torch call per request would contend with the decode programs for
# the host's threads.  The layout contract — wire words ARE ``ops/gf2_packed.pack_shots`` words —
# is enforced by ``_verify_layout_once``: the FIRST pack/unpack of the
# process round-trips a deterministic sample through the gf2_packed
# bodies and through the numpy path and requires bit equality, so a
# drifted reimplementation fails the first request of every process (and
# the tests), not much later.
_LAYOUT_LOCK = threading.Lock()
_LAYOUT_VERIFIED = False


def _pack_words_np(arr: np.ndarray) -> np.ndarray:
    """(W*LANE, cols) uint8 {0,1} -> (W, cols) uint32 lane words, shot
    ``32*w + j`` in bit ``j`` (LSB-first) — numpy fast path."""
    b, cols = arr.shape
    # packbits little: byte k of a column packs shots 8k..8k+7, LSB-first
    # — exactly a '<u4' word's byte/bit order when 4 bytes are viewed
    packed = np.ascontiguousarray(
        np.packbits(arr.T, axis=1, bitorder="little"))   # (cols, B/8)
    return np.ascontiguousarray(packed.view("<u4").T).astype(
        np.uint32, copy=False)


def _unpack_words_np(words: np.ndarray, batch: int) -> np.ndarray:
    """(W, cols) uint32 lane words -> (batch, cols) uint8 — inverse."""
    w, cols = words.shape
    as_bytes = np.ascontiguousarray(
        words.T.astype("<u4", copy=False)).view(np.uint8)
    bits = np.unpackbits(as_bytes, axis=1, bitorder="little")  # (cols, W*32)
    return np.ascontiguousarray(bits[:, :batch].T)


def _verify_layout_once() -> None:
    """One-time per process: the numpy wire path must be bit-identical
    with the gf2_packed device bodies on a deterministic sample covering
    ragged tails and multi-word planes.  Cheap (runs once), loud (raises
    on any drift) — the codec contract, executed."""
    global _LAYOUT_VERIFIED
    if _LAYOUT_VERIFIED:
        return
    with _LAYOUT_LOCK:
        if _LAYOUT_VERIFIED:
            return
        rng = np.random.default_rng(0xC0DEC)
        for b, cols in ((1, 3), (37, 5), (64, 2), (96, 1)):
            full = num_words(b) * LANE
            dense = np.zeros((full, cols), np.uint8)
            dense[:b] = (rng.random((b, cols)) < 0.5).astype(np.uint8)
            ref_words = pack_shots(torch.from_numpy(dense)).numpy().view(
                np.uint32)
            ours = _pack_words_np(dense)
            if not np.array_equal(ours, ref_words):
                raise WireCodecError(
                    "wire codec layout drifted from ops/gf2_packed."
                    "pack_shots — refusing to serve corrupt planes")
            ref_dense = unpack_shots(torch.from_numpy(ref_words.view(np.int32)),
                                     full).numpy()
            if not np.array_equal(_unpack_words_np(ref_words, full),
                                  ref_dense):
                raise WireCodecError(
                    "wire codec layout drifted from ops/gf2_packed."
                    "unpack_shots — refusing to serve corrupt planes")
        _LAYOUT_VERIFIED = True


def pack_plane(plane) -> bytes:
    """One (B, cols) {0,1} plane -> packed lane-word bytes.

    The layout is ``ops/gf2_packed.pack_shots`` verbatim (32 shots per
    uint32 word, LSB-first), words little-endian on the wire; the shot
    axis pads to full lane words with zeros.  The first call verifies the
    numpy fast path against the gf2_packed bodies (see module note)."""
    _verify_layout_once()
    arr = np.atleast_2d(np.ascontiguousarray(plane, np.uint8))
    b = int(arr.shape[0])
    full = num_words(b) * LANE
    if b != full:
        padded = np.zeros((full, arr.shape[1]), np.uint8)
        padded[:b] = arr
        arr = padded
    return _pack_words_np(arr).astype("<u4", copy=False).tobytes()


def unpack_plane(data: bytes, shots: int, cols: int) -> np.ndarray:
    """Inverse of ``pack_plane``: packed bytes -> (shots, cols) uint8.

    Validates the payload length against the claimed ``(shots, cols)``
    EXACTLY and bounds the dense size, so a hostile header cannot claim a
    plane that overruns (or under-runs) its body."""
    _verify_layout_once()
    shots, cols = int(shots), int(cols)
    if shots < 1 or cols < 1:
        raise WireCodecError(f"invalid packed plane shape ({shots}, {cols})")
    if shots * cols > MAX_DENSE_BYTES:
        raise WireCodecError(
            f"packed plane of {shots} x {cols} bits exceeds the "
            f"{MAX_DENSE_BYTES}-byte dense cap; split the request batch")
    w = num_words(shots)
    expect = w * cols * 4
    if len(data) != expect:
        raise WireCodecError(
            f"packed payload is {len(data)} bytes, expected {expect} for "
            f"shots={shots} width={cols}")
    words = np.frombuffer(data, dtype="<u4").astype(np.uint32, copy=False)
    return _unpack_words_np(words.reshape(w, cols), shots)


# ---------------------------------------------------------------------------
# v2 frames
# ---------------------------------------------------------------------------
def _binary_frame(header: dict, body: bytes, kind: int) -> bytes:
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    payload_len = _BIN_HEAD.size + len(head) + len(body)
    if payload_len > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame of {payload_len} bytes exceeds the {MAX_FRAME_BYTES}-"
            "byte cap; split the request batch")
    return (HEADER.pack(payload_len)
            + _BIN_HEAD.pack(WIRE_MAGIC, WIRE_CODEC_PACKED, kind, len(head))
            + head + body)


def encode_request_frame(msg: dict, codec: int = WIRE_CODEC_JSON) -> bytes:
    """One decode-request frame in the given codec.  ``msg`` carries
    ``"syndromes"`` as an array-like; v1 ships it as a JSON int matrix
    (byte-identical to pre-v2 builds), v2 as a packed body with
    ``shots``/``width`` in the binary header."""
    if codec == WIRE_CODEC_JSON:
        obj = {k: (np.asarray(v).tolist() if k == "syndromes" else v)
               for k, v in msg.items()}
        return encode_frame(obj)
    arr = np.atleast_2d(np.asarray(msg["syndromes"], np.uint8))
    header = {k: v for k, v in msg.items() if k != "syndromes"}
    header["shots"] = int(arr.shape[0])
    header["width"] = int(arr.shape[1])
    return _binary_frame(header, pack_plane(arr), BIN_KIND_REQUEST)


def encode_response_frame(payload: dict,
                          codec: int = WIRE_CODEC_JSON) -> bytes:
    """One decode-response frame.  ``payload`` carries ``"corrections"``
    as an array-like and ``"converged"`` as a bool list or None; v2 packs
    BOTH planes into the body (converged is a one-column plane) so a
    response costs ~1 bit per correction bit on the wire."""
    if codec == WIRE_CODEC_JSON:
        obj = {k: (np.asarray(v).tolist() if k == "corrections" else v)
               for k, v in payload.items()}
        return encode_frame(obj)
    cor = np.atleast_2d(np.asarray(payload["corrections"], np.uint8))
    header = {k: v for k, v in payload.items()
              if k not in ("corrections", "converged")}
    conv = payload.get("converged")
    header["shots"] = int(cor.shape[0])
    header["n"] = int(cor.shape[1])
    header["conv"] = conv is not None
    body = pack_plane(cor)
    if conv is not None:
        body += pack_plane(np.asarray(conv, np.uint8).reshape(-1, 1))
    return _binary_frame(header, body, BIN_KIND_RESPONSE)


def encode_stream_chunk_frame(msg: dict,
                              codec: int = WIRE_CODEC_JSON) -> bytes:
    """One ``stream_chunk`` frame: an increment of detector data for an
    open stream.  ``msg`` carries ``"chunk"`` as a (lanes, window_width)
    array-like plus ``stream``/``seq`` bookkeeping; v1 ships the chunk as
    a JSON int matrix, v2 as a ``BIN_KIND_STREAM`` binary frame whose body
    is one gf2_packed plane (the same lane-word layout batch requests use)."""
    if codec == WIRE_CODEC_JSON:
        obj = {k: (np.asarray(v).tolist() if k == "chunk" else v)
               for k, v in msg.items()}
        return encode_frame(obj)
    arr = np.atleast_2d(np.asarray(msg["chunk"], np.uint8))
    header = {k: v for k, v in msg.items() if k != "chunk"}
    header["shots"] = int(arr.shape[0])
    header["width"] = int(arr.shape[1])
    return _binary_frame(header, pack_plane(arr), BIN_KIND_STREAM)


def _decode_stream_chunk(header: dict, body: bytes) -> np.ndarray:
    """Validate a ``BIN_KIND_STREAM`` frame's header and unpack its chunk
    plane.  Raises ``WireCodecError`` on any malformation — the frame
    boundary is intact, so the server answers a structured error for this
    chunk and keeps both the connection and the stream alive."""
    for field in ("stream", "seq", "shots", "width"):
        if field not in header:
            raise WireCodecError(f"binary stream chunk misses {field!r}")
    seq = header["seq"]
    if not isinstance(seq, int) or isinstance(seq, bool) or seq < 1:
        raise WireCodecError(f"stream chunk seq must be a positive int, "
                             f"got {seq!r}")
    return unpack_plane(body, header["shots"], header["width"])


def encode_routed_payload(family: str, epoch: int, inner: bytes) -> bytes:
    """Wrap one already-encoded payload (any codec, WITHOUT its length
    prefix) in the fleet router's routing envelope and frame it.  The
    inner payload ships verbatim as the body — wrapping is O(header), the
    router never touches the bitplanes."""
    return _binary_frame({"family": str(family), "epoch": int(epoch)},
                         inner, BIN_KIND_ROUTED)


def peek_response_id(payload: bytes) -> "str | None":
    """The wire ``"id"`` of one response payload, parsed as cheaply as the
    codec allows: v2 frames decode only the small JSON header (the packed
    planes stay packed), v1 falls back to a full JSON parse.  Returns None
    when the payload is malformed or carries no id — the router pump uses
    this to match relayed responses to their pending client frames without
    ever unpacking a correction plane."""
    try:
        if payload[:2] == WIRE_MAGIC:
            _, _, _, hlen = _BIN_HEAD.unpack_from(payload)
            header = json.loads(
                payload[_BIN_HEAD.size:_BIN_HEAD.size + hlen]
                .decode("utf-8"))
        else:
            header = json.loads(payload.decode("utf-8"))
        rid = header.get("id") if isinstance(header, dict) else None
        return rid if isinstance(rid, str) else None
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError,
            IndexError):
        return None


def _decode_binary(payload: bytes) -> dict:
    if len(payload) < _BIN_HEAD.size:
        raise WireCodecError("binary payload shorter than its fixed header")
    magic, version, kind, hlen = _BIN_HEAD.unpack_from(payload)
    if version != WIRE_CODEC_PACKED:
        raise WireCodecError(f"unsupported wire codec version {version}")
    if kind not in (BIN_KIND_REQUEST, BIN_KIND_RESPONSE, BIN_KIND_STREAM,
                    BIN_KIND_ROUTED):
        raise WireCodecError(f"unknown binary frame kind {kind}")
    if _BIN_HEAD.size + hlen > len(payload):
        raise WireCodecError(
            f"binary header of {hlen} bytes overruns the frame")
    try:
        header = json.loads(
            payload[_BIN_HEAD.size:_BIN_HEAD.size + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise WireCodecError(f"unparseable binary header: {exc}") from None
    if not isinstance(header, dict):
        raise WireCodecError(
            f"binary header must be a JSON object, got "
            f"{type(header).__name__}")
    body = payload[_BIN_HEAD.size + hlen:]
    if kind == BIN_KIND_ROUTED:
        # one-level envelope: the body IS the client's original payload.
        # A nested routed body is refused (a router must never wrap an
        # already-wrapped frame) so a routing bug cannot recurse.
        if "family" not in header or "epoch" not in header:
            raise WireCodecError("routed frame misses family/epoch")
        if len(body) >= _BIN_HEAD.size and body[:2] == WIRE_MAGIC and \
                _BIN_HEAD.unpack_from(body)[2] == BIN_KIND_ROUTED:
            raise WireCodecError("nested routed frame refused")
        try:
            inner = decode_payload(body)
            route = {"family": str(header["family"]),
                     "epoch": int(header["epoch"])}
        except (UnicodeDecodeError, json.JSONDecodeError, TypeError,
                ValueError) as exc:
            if isinstance(exc, WireCodecError):
                raise
            raise WireCodecError(
                f"unparseable routed body: {exc}") from None
        if not isinstance(inner, dict):
            raise WireCodecError("routed body must be a message object")
        inner[ROUTE_FIELD] = route
        return inner
    msg = dict(header)
    msg["_codec"] = WIRE_CODEC_PACKED
    rid = header.get("id")
    try:
        if kind == BIN_KIND_REQUEST:
            if "shots" not in header or "width" not in header:
                raise WireCodecError(
                    "binary decode request misses shots/width")
            msg["syndromes"] = unpack_plane(
                body, header["shots"], header["width"])
        elif kind == BIN_KIND_STREAM:
            msg["chunk"] = _decode_stream_chunk(header, body)
        elif header.get("ok") and "shots" in header:
            shots, n = int(header["shots"]), int(header["n"])
            clen = num_words(shots) * n * 4
            msg["corrections"] = unpack_plane(body[:clen], shots, n)
            if header.get("conv"):
                msg["converged"] = [
                    bool(x) for x in
                    unpack_plane(body[clen:], shots, 1).ravel()]
            else:
                msg["converged"] = None
    except (KeyError, TypeError, ValueError) as exc:
        if isinstance(exc, WireCodecError):
            exc.request_id = rid
            raise
        raise WireCodecError(
            f"{type(exc).__name__}: {exc}", request_id=rid) from None
    return msg


def decode_payload(payload: bytes) -> dict:
    """One framed payload -> its message dict, codec sniffed off the
    magic.  v2 messages come back with ``"_codec": 2`` and their bitplanes
    already dense ((B, m) uint8 ``syndromes`` on requests, ``corrections``
    + ``converged`` on ok-responses).  Malformed binary payloads raise
    ``WireCodecError`` (recoverable per-request — the frame boundary is
    intact); malformed JSON raises as ``json.JSONDecodeError`` /
    ``UnicodeDecodeError`` exactly as before v2."""
    if payload[:2] == WIRE_MAGIC:
        return _decode_binary(payload)
    return json.loads(payload.decode("utf-8"))
