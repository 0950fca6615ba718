"""Decode-as-a-service on the card: persistent sessions, continuous
batching, a TCP front end and an ops plane — the port's counterpart of the
JAX package's ``serve/``, speaking the same wire protocol.

  session.py    DecodeSession / SessionCache: one captured CUDA graph per
                (H, shape bucket) on the card, the eager decode on the
                CPU; warm requests capture nothing; ``heal()`` rebuilds
                and recaptures off the serving thread and swaps
                atomically.  FusedDecodeGroup: one graph per (lanes,
                bucket) decodes a bucket family's round, session = lane;
                hot sessions split their decode over a shot mesh
                (``DecodeSession(mesh=)`` + shard()/unshard()).
  wire.py       the wire codec: JSON v1 and the packed binary v2
                (bitplanes in the ``ops/gf2_packed`` layout), frames
                byte-identical to the JAX package's.
  scheduler.py  ContinuousBatcher: coalesces requests across tenants into
                padded batches with deadline-aware flush and round-robin
                fairness, fused dispatch across sessions of one family,
                exactly-once re-dispatch (idempotency journal, bounded
                attempts), graceful drain, the recovery rungs (unshard,
                then recapture).
  server.py     asyncio TCP front end (length-prefixed frames, both
                codecs), responses matched by id, drain on shutdown.
  client.py     blocking pipelined client with codec negotiation,
                reconnect + resubmit and hedged resubmits.
  ops.py        the ops plane: SLO burn-rate admission, autoscaler,
                health probe (background heals on incidents and device
                resets), alert rules, and the /metrics /healthz /varz
                /tracez /alertz HTTP sidecar.

The multi-host fabric (the JAX package's ``fleet.py`` and ``router.py``)
is not ported yet.
"""
from .session import (
    DEFAULT_BUCKETS,
    DecodeOutput,
    DecodeSession,
    FusedDecodeGroup,
    SessionCache,
    StreamProfile,
    StreamProtocolError,
    StreamSession,
    bucket_family,
)
from .scheduler import ContinuousBatcher, DecodeResult, assemble_round_robin
from .ops import (
    AdmissionError,
    AlertEngine,
    AlertRule,
    AutoScaler,
    HealthProbe,
    OpsHandle,
    OpsServer,
    ScalePolicy,
    SLOEngine,
    SLOPolicy,
    default_alert_rules,
    spawn_server_loop,
    start_ops_thread,
)
from .server import DecodeServer, ServerHandle, start_server_thread
from .client import ClientResult, DecodeClient

__all__ = [
    "DEFAULT_BUCKETS",
    "DecodeOutput",
    "DecodeSession",
    "FusedDecodeGroup",
    "SessionCache",
    "StreamProfile",
    "StreamProtocolError",
    "StreamSession",
    "bucket_family",
    "ContinuousBatcher",
    "DecodeResult",
    "assemble_round_robin",
    "AdmissionError",
    "AlertEngine",
    "AlertRule",
    "AutoScaler",
    "ScalePolicy",
    "HealthProbe",
    "OpsHandle",
    "OpsServer",
    "SLOEngine",
    "SLOPolicy",
    "default_alert_rules",
    "spawn_server_loop",
    "start_ops_thread",
    "DecodeServer",
    "ServerHandle",
    "start_server_thread",
    "ClientResult",
    "DecodeClient",
]
