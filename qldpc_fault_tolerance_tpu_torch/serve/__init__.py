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

  fleet.py      FleetGateway / FleetServer: scrape N hosts' ops planes,
                merge their counters and histograms (bit-exact integer
                sums), serve the fleet /metrics /healthz /varz /alertz; the
                host-down deadman is an ordinary alert rule.
  router.py     the multi-host fabric: HashRing (family-sticky
                placement), FleetRouter (data plane, epoch fence, journal
                replication, the deadman-driven handoff, move_family),
                FleetScaler, and LocalFleet, N hosts in one process (on
                one card their captures and replays serialize on
                ``session.DEVICE_LOCK``; a killed host's programs are
                released).
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
from .fleet import FleetGateway, FleetHandle, FleetServer, start_fleet_thread
from .router import (
    FleetRouter,
    FleetScaler,
    HashRing,
    LocalFleet,
    RouterFleetServer,
    RouterHandle,
    start_router_ops_thread,
    start_router_thread,
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
    "FleetGateway",
    "FleetHandle",
    "FleetServer",
    "start_fleet_thread",
    "FleetRouter",
    "FleetScaler",
    "HashRing",
    "LocalFleet",
    "RouterFleetServer",
    "RouterHandle",
    "start_router_ops_thread",
    "start_router_thread",
    "DecodeServer",
    "ServerHandle",
    "start_server_thread",
    "ClientResult",
    "DecodeClient",
]
