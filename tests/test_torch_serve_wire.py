"""The port's wire codec (``serve/wire.py``) against the JAX package's, on
the CPU: one protocol.  For the same messages, request, response, stream
chunk and routed frames are byte-identical in both codecs (JSON v1 and the
packed binary v2), each side decodes the other's frames to the same
message, and the port's one-time layout check runs against the port's
``pack_shots`` on CPU tensors.  Tolerance: none."""
import numpy as np
import pytest

from qldpc_fault_tolerance_tpu.serve import wire as jw
from qldpc_fault_tolerance_tpu_torch.serve import wire as tw

CODECS = [1, 2]


def _plane(b, cols, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((b, cols)) < 0.3).astype(np.uint8)


def _eq(a, b):
    """Decoded messages equal, arrays compared by value."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        elif isinstance(a[k], dict):
            _eq(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_constants_equal_jax():
    for name in ("MAX_FRAME_BYTES", "MAX_DENSE_BYTES", "TRACE_FIELD",
                 "IDEM_FIELD", "WIRE_CODEC_JSON", "WIRE_CODEC_PACKED",
                 "WIRE_CODECS", "WIRE_MAGIC", "BIN_KIND_REQUEST",
                 "BIN_KIND_RESPONSE", "BIN_KIND_STREAM", "BIN_KIND_ROUTED",
                 "ROUTE_FIELD"):
        assert getattr(tw, name) == getattr(jw, name), name
    tw._verify_layout_once()
    assert tw._LAYOUT_VERIFIED


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("b,cols", [(1, 3), (31, 300), (32, 108), (77, 7)])
def test_request_frames_byte_identical(codec, b, cols):
    msg = {"op": "decode", "id": f"c-{b}", "session": "n625_a",
           "tenant": "alice", "syndromes": _plane(b, cols, b + cols),
           "idem": "k1", "trace": {"trace_id": "ab", "span_id": "cd"}}
    frame = tw.encode_request_frame(msg, codec)
    assert frame == jw.encode_request_frame(msg, codec)
    payload = frame[tw.HEADER.size:]
    _eq(tw.decode_payload(payload), jw.decode_payload(payload))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("conv", [True, False])
def test_response_frames_byte_identical(codec, conv):
    cor = _plane(45, 625, 3)
    payload = {"id": "c-9", "ok": True, "corrections": cor,
               "converged": ([bool(x) for x in _plane(45, 1, 4)[:, 0]]
                             if conv else None),
               "latency_ms": 1.25, "trace_id": "ab"}
    frame = tw.encode_response_frame(payload, codec)
    assert frame == jw.encode_response_frame(payload, codec)
    body = frame[tw.HEADER.size:]
    _eq(tw.decode_payload(body), jw.decode_payload(body))
    assert tw.peek_response_id(body) == jw.peek_response_id(body) == "c-9"


@pytest.mark.parametrize("codec", CODECS)
def test_stream_chunk_frames_byte_identical(codec):
    msg = {"op": "stream_chunk", "id": "s-1", "stream": "st", "seq": 3,
           "chunk": _plane(4, 900, 5)}
    frame = tw.encode_stream_chunk_frame(msg, codec)
    assert frame == jw.encode_stream_chunk_frame(msg, codec)
    payload = frame[tw.HEADER.size:]
    _eq(tw.decode_payload(payload), jw.decode_payload(payload))


@pytest.mark.parametrize("codec", CODECS)
def test_routed_payloads_byte_identical(codec):
    inner = tw.encode_request_frame(
        {"op": "decode", "id": "r-1", "session": "s",
         "syndromes": _plane(40, 12, 6)}, codec)[tw.HEADER.size:]
    frame = tw.encode_routed_payload("bp.w300.abc123", 7, inner)
    assert frame == jw.encode_routed_payload("bp.w300.abc123", 7, inner)
    payload = frame[tw.HEADER.size:]
    _eq(tw.decode_payload(payload), jw.decode_payload(payload))


@pytest.mark.parametrize("obj", [
    {"op": "ping", "id": 1}, {"op": "hello", "codecs": [2, 1]},
    {"ok": False, "id": "x", "error": "unknown session 'q'",
     "code": "unknown_session"}, [1, 2, 3], "text"])
def test_json_frames_byte_identical(obj):
    assert tw.encode_frame(obj) == jw.encode_frame(obj)


@pytest.mark.parametrize("bad", [
    b"QW\x09\x01\x00\x00\x00\x02{}",          # unsupported version
    b"QW\x02\x09\x00\x00\x00\x02{}",          # unknown kind
    b"QW\x02\x01\x00\x00\x00\x40{}",          # header overruns the frame
    b"QW\x02\x01\x00\x00\x00\x02[]",          # header not an object
    b"QW\x02",                                # shorter than the head
])
def test_malformed_binary_frames_refused_alike(bad):
    with pytest.raises(jw.WireCodecError) as jerr:
        jw.decode_payload(bad)
    with pytest.raises(tw.WireCodecError) as terr:
        tw.decode_payload(bad)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("b,cols", [(1, 1), (33, 4), (64, 2), (100, 9)])
def test_planes_round_trip_across_sides(b, cols):
    plane = _plane(b, cols, 7 * b + cols)
    data = tw.pack_plane(plane)
    assert data == jw.pack_plane(plane)
    assert np.array_equal(jw.unpack_plane(data, b, cols), plane)
    assert np.array_equal(tw.unpack_plane(data, b, cols), plane)
