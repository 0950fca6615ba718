"""Multi-host serving fabric (the JAX package's ``serve/router.py`` on the
port's serve stack): family-sticky routing,
exactly-once handoff, fleet-level scaling.

One serving host is a DecodeServer + ContinuousBatcher; a fleet is N of
them behind this router.  The placement unit is the bucket FAMILY (see
``session.bucket_family``), never the session or the request: co-family
sessions ride ONE cell-fused dispatch, so scattering a family
across hosts would silently de-fuse it back into per-session rounds.
The router therefore consistent-hashes family keys onto host labels and
keeps every session of a family on its owner host.

  HashRing      sha1 vnode ring over host labels; ``order(key)`` yields
                the distinct labels in ring order — [owner, successor,
                ...] — so a host loss promotes the standing replication
                target, and placements move minimally when hosts change.
  FleetRouter   the data plane + control plane in one object:
                  * data plane — an asyncio TCP front speaking the exact
                    client wire protocol.  hello/ping answer locally;
                    decode / stream_* frames are wrapped in the
                    ``BIN_KIND_ROUTED`` envelope (family + placement
                    epoch, payload verbatim — bitplanes never re-encoded)
                    and forwarded to the family's owner over a per-client
                    backend link; responses relay back matched by wire
                    id.  A ``route_stale`` refusal from the owner's epoch
                    fence re-resolves placement and re-forwards — a
                    partitioned router cannot double-decode.
                  * control plane — a daemon loop that (a) re-asserts
                    placement epochs to every live host (``family_adopt``
                    own/fence broadcasts, idempotent), (b) incrementally
                    replicates each host's answered journal + stream
                    ledgers to the family successors (``journal_export``
                    watermark pulls -> ``journal_import`` pushes), and
                    (c) watches the federation gateway's ``host_down:*``
                    deadman alerts: when one fires, the dead host's
                    families gate, the buffered journal delta is flushed
                    to the successor (BLOCKING until the watermark
                    catches up — never serving stale answers), ownership
                    re-adopts at epoch+1, and the gates open.  Clients
                    ride through purely on their existing reconnect +
                    idempotent-resubmit machinery.
  FleetScaler   drives each host's AutoScaler and, off the gateway's
                merged load signal, live-moves the smallest family from
                the hottest host to the coldest (same fence/replicate/
                adopt machinery, with a live source).
  LocalFleet    an N-host in-process fleet (per-host batcher + server +
                ops plane, one FleetGateway, one FleetRouter) — the
                harness behind ``chip_smoke.py``'s fleet phase and the fleet chaos
                acceptance tests, including the ``host_kill`` /
                ``journal_lag`` / ``router_partition`` chaos kinds.

Chaos sites (registered in utils.faultinject.SITES):
``router_route`` fires per forwarded frame (``router_partition`` makes
ONE frame carry a deliberately stale epoch, proving the fence end to
end); ``router_replicate`` fires per journal push (``journal_lag`` fails
the push so the successor falls behind and the handoff must block);
``fleet_host_tick`` fires per LocalFleet chaos tick (``host_kill`` kills
the current owner of the first family mid-storm).
"""
from __future__ import annotations

import asyncio
import bisect
import hashlib
import json
import socket
import struct
import threading
import time

from ..utils import faultinject, resilience, telemetry
from . import fleet as fleet_mod
from . import ops
from .server import read_frame
from .wire import (
    HEADER,
    MAX_FRAME_BYTES,
    WIRE_CODEC_JSON,
    WIRE_CODECS,
    WIRE_MAGIC,
    _BIN_HEAD,
    encode_frame,
    encode_routed_payload,
    peek_response_id,
)

__all__ = [
    "HashRing", "ControlClient", "FleetRouter", "RouterHandle",
    "RouterFleetServer", "FleetScaler", "LocalFleet",
    "start_router_thread", "start_router_ops_thread",
]

# a frame refused by the owner's epoch fence is re-resolved and
# re-forwarded at most this many times before the refusal relays to the
# client (whose resubmit machinery then owns the retry)
MAX_STALE_REFORWARDS = 5


class HashRing:
    """Consistent hash over host labels, keyed by bucket-family strings.

    sha1-based (process-stable — builtin ``hash`` is salted per process,
    which would reshuffle every placement on restart) with ``vnodes``
    points per host so family load spreads evenly."""

    def __init__(self, labels, vnodes: int = 64):
        self.labels = sorted(str(lb) for lb in labels)
        if not self.labels:
            raise ValueError("HashRing needs at least one host label")
        points = []
        for label in self.labels:
            for v in range(int(vnodes)):
                points.append((self._hash(f"{label}#{v}"), label))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    @staticmethod
    def _hash(text: str) -> int:
        return int.from_bytes(
            hashlib.sha1(text.encode("utf-8")).digest()[:8], "big")

    def order(self, key, exclude=()) -> list:
        """Distinct host labels in ring order from ``key``'s point,
        skipping ``exclude`` — ``[owner, successor, ...]``."""
        start = bisect.bisect_left(self._keys, self._hash(str(key)))
        seen: set = set()
        out: list = []
        n = len(self._points)
        for i in range(n):
            label = self._points[(start + i) % n][1]
            if label in seen or label in exclude:
                continue
            seen.add(label)
            out.append(label)
        return out


class ControlClient:
    """One-shot synchronous control-op client (``family_adopt`` /
    ``journal_export`` / ``journal_import``): a fresh socket per call, so
    a dead host fails THIS call and never poisons a pool.  Control ops
    are JSON v1 both ways (responses mirror the request codec)."""

    def __init__(self, address, timeout_s: float = 5.0):
        self.address = (str(address[0]), int(address[1]))
        self.timeout_s = float(timeout_s)

    def call(self, msg: dict) -> dict:
        with socket.create_connection(self.address,
                                      timeout=self.timeout_s) as sock:
            sock.settimeout(self.timeout_s)
            sock.sendall(encode_frame(msg))
            (length,) = HEADER.unpack(self._read_exact(sock, HEADER.size))
            if length > MAX_FRAME_BYTES:
                raise ValueError(f"control reply of {length} bytes exceeds "
                                 f"the {MAX_FRAME_BYTES}-byte cap")
            return json.loads(self._read_exact(sock, length)
                              .decode("utf-8"))

    @staticmethod
    def _read_exact(sock, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("control peer closed mid-frame")
            buf += chunk
        return buf


def _peek_header(payload: bytes) -> "dict | None":
    """Routing peek: the JSON header of one CLIENT payload (op / id /
    session / stream / profile) without unpacking any bitplane — v2
    decodes only the binary header's JSON, v1 costs a full JSON parse.
    None when malformed (the caller answers a structured error)."""
    try:
        if payload[:2] == WIRE_MAGIC:
            _, _, _, hlen = _BIN_HEAD.unpack_from(payload)
            obj = json.loads(
                payload[_BIN_HEAD.size:_BIN_HEAD.size + hlen]
                .decode("utf-8"))
        else:
            obj = json.loads(payload.decode("utf-8"))
        return obj if isinstance(obj, dict) else None
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError,
            IndexError):
        return None


def _new_bucket() -> dict:
    return {"entries": [], "streams": {}, "programs": {}, "watermark": 0}


class _BackendLink:
    """One router->host connection, scoped to ONE client connection: wire
    ids are client-connection-scoped, so sharing a backend link across
    clients would collide response matching."""

    def __init__(self, conn: "_RouterConn", label: str, address):
        self.conn = conn
        self.label = label
        self.address = (str(address[0]), int(address[1]))
        self.reader = None
        self.writer = None
        self._pump: "asyncio.Task | None" = None
        self._wlock = asyncio.Lock()
        self.dead = False
        self._closing = False

    async def open(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            *self.address)
        self._pump = asyncio.get_running_loop().create_task(
            self._pump_loop())

    async def send(self, frame: bytes) -> None:
        async with self._wlock:
            self.writer.write(frame)
            await self.writer.drain()
        telemetry.count("router.bytes_forwarded", len(frame))

    async def _pump_loop(self) -> None:
        try:
            while True:
                payload = await read_frame(self.reader)
                if payload is None:
                    break
                await self.conn.on_backend_payload(self.label, payload)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — pump death is a transport event
            telemetry.count("router.pump_errors")
        finally:
            self.dead = True
            if not self._closing:
                # backend died while the client lives: abort the client
                # transport so its reconnect + idempotent-resubmit
                # machinery takes over (exactly a dead host's signature)
                self.conn.abort()

    async def close(self) -> None:
        self._closing = True
        self.dead = True
        if self._pump is not None:
            self._pump.cancel()
            try:
                await self._pump
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        if self.writer is not None:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass


class _RouterConn:
    """Per-client-connection state: the client writer, the lazy backend
    links, and the pending table matching relayed responses (and
    ``route_stale`` refusals) back to forwarded frames."""

    def __init__(self, router: "FleetRouter", writer, wlock):
        self.router = router
        self.writer = writer
        self.wlock = wlock
        self.links: dict = {}
        self.pending: dict = {}

    async def link(self, label: str) -> _BackendLink:
        lk = self.links.get(label)
        if lk is not None and not lk.dead:
            return lk
        lk = _BackendLink(self, label, self.router.hosts[label])
        try:
            await lk.open()
        except OSError:
            telemetry.count("router.backend_connect_errors")
            raise ConnectionError(
                f"backend host {label!r} is unreachable")
        self.links[label] = lk
        return lk

    async def write_local(self, obj: dict) -> None:
        frame = encode_frame(obj)
        async with self.wlock:
            self.writer.write(frame)
            await self.writer.drain()
        telemetry.count("router.bytes_tx", len(frame))

    async def relay(self, payload: bytes) -> None:
        async with self.wlock:
            self.writer.write(HEADER.pack(len(payload)) + payload)
            await self.writer.drain()
        telemetry.count("router.bytes_relayed",
                        len(payload) + HEADER.size)

    def abort(self) -> None:
        try:
            self.writer.transport.abort()
        except Exception:  # noqa: BLE001
            pass

    async def on_backend_payload(self, label: str, payload: bytes) -> None:
        rid = peek_response_id(payload)
        entry = self.pending.get(rid) if rid else None
        if payload[:1] == b"{":
            try:
                obj = json.loads(payload.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                obj = None
            if isinstance(obj, dict):
                if obj.get("route_stale") and entry is not None:
                    # the owner's epoch fence refused the frame: our
                    # placement (or the frame's epoch) was stale —
                    # re-resolve and re-forward the ORIGINAL payload;
                    # bounded, then the refusal relays and the client's
                    # resubmit machinery owns the retry
                    entry["attempts"] += 1
                    telemetry.count("router.stale_reforwards")
                    if entry["attempts"] <= MAX_STALE_REFORWARDS:
                        await asyncio.sleep(0.02 * entry["attempts"])
                        await self.router._forward(
                            self, entry["family"], rid, entry["raw"],
                            entry["op"])
                        return
                elif (entry is not None and entry["op"] == "stream_open"
                        and obj.get("ok") and obj.get("stream")):
                    # learn the minted stream id's family so chunk /
                    # commit frames for it route sticky
                    self.router._learn_stream(str(obj["stream"]),
                                              entry["family"])
        if entry is not None:
            self.pending.pop(rid, None)
        await self.relay(payload)


class _GateTimeout(RuntimeError):
    pass


class FleetRouter:
    """See the module docstring.  ``hosts`` maps a label to a serving
    (host, port); ``families`` maps a family key to its session names
    (every host must serve the same session set — the router only ever
    re-homes families between identically-provisioned hosts);
    ``profiles`` maps stream-profile names to session names (a bare
    session name needs no entry).  ``gateway`` is the federation gateway
    whose ``host_down:*`` deadman alerts drive handoff."""

    def __init__(self, hosts: dict, families: dict, *,
                 profiles: dict | None = None,
                 gateway: "fleet_mod.FleetGateway | None" = None,
                 host: str = "127.0.0.1", port: int = 0,
                 control_interval_s: float = 0.05,
                 reassert_interval_s: float = 1.0,
                 gate_timeout_s: float = 30.0,
                 control_timeout_s: float = 5.0,
                 handoff_push_attempts: int = 1000):
        self.hosts = {str(lb): (str(a[0]), int(a[1]))
                      for lb, a in dict(hosts).items()}
        if not self.hosts:
            raise ValueError("FleetRouter needs at least one host")
        self.families = {str(f): sorted(str(s) for s in names)
                         for f, names in dict(families).items()}
        self.profiles = {str(k): str(v)
                         for k, v in dict(profiles or {}).items()}
        self.gateway = gateway
        self.host = host
        self.port = int(port)
        self.control_interval_s = float(control_interval_s)
        self.reassert_interval_s = float(reassert_interval_s)
        self.gate_timeout_s = float(gate_timeout_s)
        self.control_timeout_s = float(control_timeout_s)
        self.handoff_push_attempts = int(handoff_push_attempts)

        self._ring = HashRing(self.hosts)
        self._lock = threading.Lock()
        self._placement: dict = {}
        for fam in sorted(self.families):
            order = self._ring.order(fam)
            self._placement[fam] = {
                "owner": order[0],
                "successor": order[1] if len(order) > 1 else None,
                "epoch": 1}
        self._session_family: dict = {}
        for fam, names in self.families.items():
            for name in names:
                self._session_family[name] = fam
        self._sid_family: dict = {}
        self._down: set = set()
        # per-family admission gate: set = open; the control thread
        # closes it for the duration of a handoff so in-flight frames
        # wait instead of racing the ownership change
        self._gates = {fam: asyncio.Event() for fam in self.families}
        for ev in self._gates.values():
            ev.set()
        # per-source replication state: the export watermark already
        # fetched, and per-target buffered deltas not yet pushed
        self._repl = {label: {"since": 0, "pending": {}}
                      for label in self.hosts}
        self._handoffs: dict = {}
        self._handoff_durs: list = []
        self._loop: "asyncio.AbstractEventLoop | None" = None
        self._server: "asyncio.AbstractServer | None" = None
        self._conns: set = set()
        self._stop = threading.Event()
        self._control_thread: "threading.Thread | None" = None
        self._last_reassert = 0.0

    # ------------------------------------------------------------------
    # data plane (asyncio)
    # ------------------------------------------------------------------
    async def _start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _handle_client(self, reader, writer) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)
        conn = _RouterConn(self, writer, asyncio.Lock())
        try:
            while True:
                try:
                    payload = await read_frame(reader)
                except ValueError as exc:
                    await conn.write_local({"ok": False,
                                            "error": f"bad frame: {exc}"})
                    break
                if payload is None:
                    break
                telemetry.count("router.bytes_rx",
                                len(payload) + HEADER.size)
                hdr = _peek_header(payload)
                if hdr is None:
                    await conn.write_local({
                        "ok": False,
                        "error": "bad frame: the router could not parse "
                                 "the payload header"})
                    continue
                op = hdr.get("op")
                if op == "hello":
                    await conn.write_local(self._hello(hdr))
                    continue
                if op == "ping":
                    await conn.write_local({
                        "ok": True, "pong": True, "router": True,
                        "sessions": self._all_sessions(),
                        "draining": False})
                    continue
                fam = self._route_family(hdr)
                if fam is None:
                    await conn.write_local(self._unroutable(hdr))
                    continue
                rid = hdr.get("id")
                if not isinstance(rid, str) or not rid:
                    await conn.write_local({
                        "ok": False,
                        "error": f"the router needs a request id on op "
                                 f"{op!r} to match its response"})
                    continue
                try:
                    await self._forward(conn, fam, rid, payload, op)
                except _GateTimeout:
                    telemetry.count("router.gate_timeouts")
                    await conn.write_local({
                        "id": rid, "ok": False,
                        "error": f"family {fam} unavailable: its handoff "
                                 "did not complete in time"})
                except (ConnectionError, faultinject.InjectedFault):
                    # backend unreachable (or injected routing death):
                    # die like a transport — the client reconnects and
                    # resubmits, deduped by the scheduler journal
                    break
        finally:
            for lk in list(conn.links.values()):
                await lk.close()
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    def _hello(self, hdr: dict) -> dict:
        offered = hdr.get("codecs")
        if not isinstance(offered, (list, tuple)):
            offered = [WIRE_CODEC_JSON]
        usable = [int(c) for c in offered
                  if isinstance(c, (int, float)) and int(c) in WIRE_CODECS]
        codec = max(usable, default=WIRE_CODEC_JSON)
        return {"ok": True, "hello": True, "router": True, "codec": codec,
                "codecs": list(WIRE_CODECS), "streams": True,
                "sessions": self._all_sessions(), "draining": False}

    def _all_sessions(self) -> list:
        return sorted(self._session_family)

    def _route_family(self, hdr: dict) -> "str | None":
        op = hdr.get("op")
        if op == "decode":
            return self._session_family.get(str(hdr.get("session")))
        if op == "stream_open":
            name = str(hdr.get("profile") or hdr.get("session") or "")
            return self._session_family.get(self.profiles.get(name, name))
        if op in ("stream_chunk", "stream_commit"):
            return self._sid_family.get(str(hdr.get("stream")))
        return None

    def _unroutable(self, hdr: dict) -> dict:
        op = hdr.get("op")
        if op in ("stream_chunk", "stream_commit"):
            sid = hdr.get("stream")
            return {"id": hdr.get("id"), "ok": False, "stream": sid,
                    "stream_unknown": True,
                    "error": f"unknown stream {sid!r} (shed, closed, or "
                             "never opened through this router)"}
        return {"id": hdr.get("id"), "ok": False,
                "error": f"the router cannot place op {op!r}: no "
                         "configured family serves it"}

    async def _forward(self, conn: _RouterConn, fam: str, rid: str,
                       payload: bytes, op) -> None:
        gate = self._gates.get(fam)
        if gate is not None and not gate.is_set():
            telemetry.count("router.gate_waits")
            try:
                await asyncio.wait_for(gate.wait(),
                                       timeout=self.gate_timeout_s)
            except asyncio.TimeoutError:
                raise _GateTimeout(fam) from None
        with self._lock:
            place = dict(self._placement[fam])
        epoch = int(place["epoch"])
        # routing chaos: under a ``router_partition`` fault
        # THIS frame forwards with a deliberately stale epoch, as a
        # partitioned router would — the owner's fence must refuse it
        # (``route_stale``) and the re-forward path must recover
        stale_marks: list = []
        faultinject.site("router_route",
                         actions={"router_partition": stale_marks.append})
        if stale_marks:
            epoch = max(0, epoch - 1)
            telemetry.count("router.partition_injected")
        link = await conn.link(place["owner"])
        conn.pending[rid] = {"raw": payload, "family": fam, "op": op,
                             "attempts": conn.pending.get(rid, {})
                             .get("attempts", 0)}
        await link.send(encode_routed_payload(fam, epoch, payload))
        telemetry.count("router.requests_routed")

    def _learn_stream(self, sid: str, fam: str) -> None:
        with self._lock:
            self._sid_family[sid] = fam

    # ------------------------------------------------------------------
    # control plane (daemon thread)
    # ------------------------------------------------------------------
    def _control(self, label: str) -> ControlClient:
        return ControlClient(self.hosts[label],
                             timeout_s=self.control_timeout_s)

    def start_control(self) -> None:
        if self._control_thread is not None:
            return
        # broadcast the initial placement BEFORE serving control ticks:
        # un-adopted families are refused by every host's fence
        self._assert_placement()
        self._stop.clear()
        t = threading.Thread(target=self._control_loop,
                             name="qldpc-fleet-router-ctl", daemon=True)
        self._control_thread = t
        t.start()

    def _control_loop(self) -> None:
        while not self._stop.wait(self.control_interval_s):
            try:
                self.control_once()
            except Exception:  # noqa: BLE001 — the loop never dies
                telemetry.count("router.control_errors")

    def control_once(self, now=None) -> None:
        """One control tick: deadman-driven handoffs, replication
        fetch/push over live hosts, periodic placement re-assert."""
        now = time.monotonic() if now is None else now
        if self.gateway is not None:
            for name in self.gateway.alerts.firing():
                if not name.startswith("host_down:"):
                    continue
                label = name.split(":", 1)[1]
                if label in self.hosts and label not in self._down:
                    self._handle_host_down(label)
        for label in sorted(self.hosts):
            if label in self._down:
                continue
            self._fetch_delta(label)
            self._push_pending(label)
        if now - self._last_reassert >= self.reassert_interval_s:
            self._last_reassert = now
            self._assert_placement()

    def _assert_placement(self) -> None:
        """Idempotent epoch broadcast: the owner adopts (own=True), every
        other live host is fenced (own=False).  Re-asserted periodically
        so a host returning from a partition re-learns the current fence
        before any stale frame could dispatch on it."""
        with self._lock:
            placement = {f: dict(p) for f, p in self._placement.items()}
            down = set(self._down)
        for fam in sorted(placement):
            place = placement[fam]
            for label in sorted(self.hosts):
                if label in down:
                    continue
                own = label == place["owner"]
                try:
                    self._control(label).call({
                        "op": "family_adopt",
                        "id": f"adopt-{fam}-{place['epoch']}-{label}",
                        "family": fam, "epoch": int(place["epoch"]),
                        "own": own,
                        "sessions": (self.families.get(fam, [])
                                     if own else [])})
                except Exception:  # noqa: BLE001 — re-asserted next round
                    telemetry.count("router.adopt_errors")

    def _fetch_delta(self, label: str) -> bool:
        """Eagerly pull ``label``'s journal delta past our watermark and
        buffer it per successor host.  Fetch is separate from push on
        purpose: a ``journal_lag`` fault fails only the PUSH, so fetched
        entries survive the source host's death in our buffer."""
        st = self._repl[label]
        try:
            rep = self._control(label).call({
                "op": "journal_export",
                "id": f"exp-{label}-{st['since']}",
                "since": int(st["since"])})
        except Exception:  # noqa: BLE001 — the host may simply be gone
            telemetry.count("router.replication_fetch_errors")
            return False
        if not rep.get("ok"):
            telemetry.count("router.replication_fetch_errors")
            return False
        st["since"] = max(int(st["since"]), int(rep.get("watermark", 0)))
        with self._lock:
            placement = {f: dict(p) for f, p in self._placement.items()}
        for entry in rep.get("entries", ()):
            key = entry.get("key") or ()
            fam = (self._session_family.get(str(key[1]))
                   if len(key) == 3 else None)
            target = (placement.get(fam, {}).get("successor")
                      if fam else None)
            if target is None or target in self._down:
                continue
            bucket = st["pending"].setdefault(target, _new_bucket())
            bucket["entries"].append(entry)
            bucket["watermark"] = max(bucket["watermark"],
                                      int(entry.get("seq", 0)))
        for state in rep.get("streams", ()):
            sid = state.get("stream")
            name = str(state.get("profile") or "")
            fam = self._session_family.get(self.profiles.get(name, name))
            target = (placement.get(fam, {}).get("successor")
                      if fam else None)
            if sid is None or fam is None:
                continue
            self._learn_stream(str(sid), fam)
            if target is None or target in self._down:
                continue
            bucket = st["pending"].setdefault(target, _new_bucket())
            # full state each export: the newest snapshot wins
            bucket["streams"][str(sid)] = state
        # warm-program manifests: forward each session's warm
        # (bucket, sharded) set to the family's successor so it pre-loads
        # the programs from the persistent cache BEFORE any handoff.
        # Deduped per (target, session, manifest) — the steady-state loop
        # re-exports every tick, but an unchanged manifest is not news.
        pushed = st.setdefault("prog_pushed", {})
        for name, keys in (rep.get("programs") or {}).items():
            fam = self._session_family.get(str(name))
            target = (placement.get(fam, {}).get("successor")
                      if fam else None)
            if target is None or target in self._down:
                continue
            sig = repr(keys)
            if pushed.get((target, str(name))) == sig:
                continue
            bucket = st["pending"].setdefault(target, _new_bucket())
            bucket["programs"][str(name)] = list(keys)
        return True

    def _push_pending(self, label: str) -> None:
        st = self._repl[label]
        for target in sorted(st["pending"]):
            bucket = st["pending"][target]
            if (not bucket["entries"] and not bucket["streams"]
                    and not bucket.get("programs")):
                continue
            if target in self._down:
                bucket["entries"].clear()
                bucket["streams"].clear()
                bucket.get("programs", {}).clear()
                continue
            try:
                self._push_delta(label, target, bucket)
            except Exception:  # noqa: BLE001 — buffered, retried next tick
                telemetry.count("router.replication_errors")

    def _push_delta(self, source: str, target: str, bucket: dict) -> None:
        """One replication push: the buffered delta from ``source``'s
        journal into ``target``.  Chaos (``journal_lag``) fails exactly
        here — the fetched delta stays buffered and the successor's
        watermark lags, which a handoff must then catch up on."""
        faultinject.site("router_replicate")
        programs = {n: list(k)
                    for n, k in bucket.get("programs", {}).items()}
        snapshot = {"watermark": int(bucket["watermark"]),
                    "entries": list(bucket["entries"]),
                    "streams": [dict(s)
                                for s in bucket["streams"].values()],
                    "programs": programs}
        rep = self._control(target).call({
            "op": "journal_import",
            "id": f"imp-{source}-{target}-{bucket['watermark']}",
            "snapshot": snapshot})
        if not rep.get("ok"):
            raise RuntimeError(
                f"journal_import on {target!r} refused: {rep.get('error')}")
        bucket["entries"].clear()
        bucket["streams"].clear()
        bucket.get("programs", {}).clear()
        if programs:
            # remember what landed so the steady-state re-export doesn't
            # re-push an unchanged manifest every tick
            pushed = self._repl[source].setdefault("prog_pushed", {})
            for n, k in programs.items():
                pushed[(target, n)] = repr(k)
            telemetry.count("router.program_pushes")
        telemetry.count("router.replication_pushes")

    # ------------------------------------------------------------------
    # handoff
    # ------------------------------------------------------------------
    def _set_gate(self, fam: str, open_: bool) -> None:
        ev = self._gates.get(fam)
        if ev is None:
            return
        loop = self._loop
        if loop is None or loop.is_closed():
            (ev.set if open_ else ev.clear)()
            return
        loop.call_soon_threadsafe(ev.set if open_ else ev.clear)

    def _handle_host_down(self, label: str) -> None:
        """The deadman fired for ``label``: gate its families, flush the
        buffered journal delta to each successor (BLOCKING until the
        watermark catches up — a lagging journal must never hand off
        stale), promote ownership at epoch+1, re-open the gates."""
        t0 = time.monotonic()
        with self._lock:
            self._down.add(label)
            fams = sorted(f for f, p in self._placement.items()
                          if p["owner"] == label)
        for fam in fams:
            self._set_gate(fam, False)
        telemetry.count("router.hosts_down")
        telemetry.event("scale_event", action="fleet_host_down",
                        target=label, reason="deadman")
        # last best-effort pull (usually fails — the host is dead; what
        # matters is everything the steady-state loop already fetched)
        self._fetch_delta(label)
        st = self._repl[label]
        for target in sorted(st["pending"]):
            bucket = st["pending"][target]
            if target in self._down:
                bucket["entries"].clear()
                bucket["streams"].clear()
                bucket.get("programs", {}).clear()
                continue
            attempts = 0
            while (bucket["entries"] or bucket["streams"]
                   or bucket.get("programs")):
                try:
                    self._push_delta(label, target, bucket)
                except Exception:  # noqa: BLE001
                    telemetry.count("router.replication_errors")
                    attempts += 1
                    if attempts >= self.handoff_push_attempts:
                        # give up loudly: the successor serves without
                        # this delta (fresh decodes stay deterministic,
                        # but replay coverage is lost) — counted so the
                        # acceptance gate can refuse
                        telemetry.count("router.handoff_drops")
                        bucket["entries"].clear()
                        bucket["streams"].clear()
                        bucket.get("programs", {}).clear()
                        break
                    # blocking here IS the contract: the handoff must not
                    # open the successor past a lagging journal
                    resilience.sleep_for(0.01)
        for fam in fams:
            self._promote(fam, reason=f"host_down:{label}")
            self._set_gate(fam, True)
        dur = time.monotonic() - t0
        telemetry.observe("router.handoff_s", dur)
        with self._lock:
            self._handoff_durs.append(dur)

    def _promote(self, fam: str, reason: str) -> bool:
        """Move ``fam``'s ownership to its successor at epoch+1: adopt on
        the new owner (with the session manifest — the adopt fails if the
        host cannot actually serve the family), then fence everyone
        else."""
        with self._lock:
            place = self._placement[fam]
            new_epoch = int(place["epoch"]) + 1
            old_owner = place["owner"]
            order = self._ring.order(fam, exclude=self._down)
            if not order:
                telemetry.count("router.no_successor")
                return False
            succ = place["successor"]
            new_owner = (succ if succ is not None
                         and succ not in self._down else order[0])
            rest = [lb for lb in order if lb != new_owner]
            new_successor = rest[0] if rest else None
        adopted = False
        # bounded adopt retry against a host that may still be binding
        for attempt in range(5):  # qldpc: ignore[R102]
            try:
                rep = self._control(new_owner).call({
                    "op": "family_adopt",
                    "id": f"promote-{fam}-{new_epoch}",
                    "family": fam, "epoch": new_epoch, "own": True,
                    "sessions": self.families.get(fam, [])})
                if rep.get("ok"):
                    adopted = True
                    break
            except Exception:  # noqa: BLE001
                pass
            telemetry.count("router.adopt_errors")
            resilience.sleep_for(0.05 * (attempt + 1))
        if not adopted:
            telemetry.count("router.promote_failures")
            return False
        with self._lock:
            self._placement[fam] = {"owner": new_owner,
                                    "successor": new_successor,
                                    "epoch": new_epoch}
            self._handoffs[fam] = {"t": time.time(), "epoch": new_epoch,
                                   "from": old_owner, "to": new_owner,
                                   "reason": reason}
        for label in sorted(self.hosts):
            if label == new_owner or label in self._down:
                continue
            try:
                self._control(label).call({
                    "op": "family_adopt",
                    "id": f"fence-{fam}-{new_epoch}-{label}",
                    "family": fam, "epoch": new_epoch, "own": False,
                    "sessions": []})
            except Exception:  # noqa: BLE001 — re-asserted next round
                telemetry.count("router.adopt_errors")
        telemetry.count("router.handoffs")
        telemetry.event("scale_event", action="fleet_handoff", target=fam,
                        to_value=new_epoch, reason=reason)
        return True

    def move_family(self, fam: str, target: str,
                    reason: str = "rebalance") -> bool:
        """Live rebalance: move ``fam`` from its (alive) owner to
        ``target`` — fence the source first (in-flight routed frames
        refuse with ``route_stale`` and re-forward after the move), ship
        a FULL journal snapshot, adopt, flip placement."""
        with self._lock:
            if fam not in self._placement or target not in self.hosts \
                    or target in self._down:
                return False
            place = dict(self._placement[fam])
        source = place["owner"]
        if source == target:
            return False
        new_epoch = int(place["epoch"]) + 1
        self._set_gate(fam, False)
        t0 = time.monotonic()
        try:
            try:
                self._control(source).call({
                    "op": "family_adopt",
                    "id": f"move-fence-{fam}-{new_epoch}",
                    "family": fam, "epoch": new_epoch, "own": False,
                    "sessions": []})
            except Exception:  # noqa: BLE001 — the fence re-asserts later
                telemetry.count("router.adopt_errors")
            # full snapshot (since=0): a move has a live source, so the
            # freshest state is one export away — no watermark dance
            try:
                rep = self._control(source).call({
                    "op": "journal_export",
                    "id": f"move-exp-{fam}-{new_epoch}", "since": 0})
            except Exception:  # noqa: BLE001
                rep = {"ok": False}
            if rep.get("ok"):
                names = set(self.families.get(fam, ()))
                entries = [e for e in rep.get("entries", ())
                           if len(e.get("key") or ()) == 3
                           and str(e["key"][1]) in names]
                streams = {}
                for state in rep.get("streams", ()):
                    pname = str(state.get("profile") or "")
                    if self.profiles.get(pname, pname) in names:
                        streams[str(state.get("stream"))] = state
                bucket = {"entries": entries, "streams": streams,
                          "watermark": max(
                              [int(e.get("seq", 0)) for e in entries],
                              default=0)}
                if bucket["entries"] or bucket["streams"]:
                    try:
                        self._push_delta(source, target, bucket)
                    except Exception:  # noqa: BLE001 — abort the move
                        telemetry.count("router.replication_errors")
                        try:
                            self._control(source).call({
                                "op": "family_adopt",
                                "id": f"move-abort-{fam}-{new_epoch}",
                                "family": fam, "epoch": new_epoch,
                                "own": True,
                                "sessions": self.families.get(fam, [])})
                        except Exception:  # noqa: BLE001
                            telemetry.count("router.adopt_errors")
                        return False
            try:
                rep = self._control(target).call({
                    "op": "family_adopt",
                    "id": f"move-adopt-{fam}-{new_epoch}",
                    "family": fam, "epoch": new_epoch, "own": True,
                    "sessions": self.families.get(fam, [])})
            except Exception:  # noqa: BLE001
                rep = {"ok": False}
            if not rep.get("ok"):
                telemetry.count("router.promote_failures")
                try:
                    self._control(source).call({
                        "op": "family_adopt",
                        "id": f"move-abort-{fam}-{new_epoch}",
                        "family": fam, "epoch": new_epoch, "own": True,
                        "sessions": self.families.get(fam, [])})
                except Exception:  # noqa: BLE001
                    telemetry.count("router.adopt_errors")
                return False
            with self._lock:
                order = self._ring.order(fam, exclude=self._down)
                rest = [lb for lb in order if lb != target]
                self._placement[fam] = {
                    "owner": target,
                    "successor": rest[0] if rest else None,
                    "epoch": new_epoch}
                self._handoffs[fam] = {"t": time.time(),
                                       "epoch": new_epoch,
                                       "from": source, "to": target,
                                       "reason": reason}
            dur = time.monotonic() - t0
            telemetry.observe("router.handoff_s", dur)
            with self._lock:
                self._handoff_durs.append(dur)
            telemetry.count("router.moves")
            telemetry.event("scale_event", action="fleet_move",
                            target=fam, to_value=new_epoch, reason=reason)
            return True
        finally:
            self._set_gate(fam, True)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def down(self) -> set:
        with self._lock:
            return set(self._down)

    def placement(self) -> dict:
        with self._lock:
            return {fam: dict(p) for fam, p in self._placement.items()}

    def handoff_report(self, now=None) -> dict:
        now = time.time() if now is None else now
        with self._lock:
            return {fam: {"age_s": round(now - h["t"], 3),
                          "epoch": h["epoch"], "from": h["from"],
                          "to": h["to"], "reason": h["reason"]}
                    for fam, h in self._handoffs.items()}

    def handoff_durations(self) -> list:
        with self._lock:
            return list(self._handoff_durs)

    # ------------------------------------------------------------------
    async def _shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
        for conn in list(self._conns):
            conn.cancel()
        if self._conns:
            await asyncio.gather(*list(self._conns),
                                 return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    def stop_control(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._control_thread
        if t is not None:
            t.join(timeout)
        self._control_thread = None


class RouterHandle:
    """A FleetRouter's data plane on its own event-loop thread, plus its
    control loop — stopped together."""

    def __init__(self, router: FleetRouter, loop, thread):
        self.router = router
        self._loop = loop
        self._thread = thread

    @property
    def address(self) -> tuple:
        return (self.router.host, self.router.port)

    def stop(self, timeout: float = 15.0) -> None:
        self.router.stop_control(timeout)
        try:
            asyncio.run_coroutine_threadsafe(
                self.router._shutdown(), self._loop).result(timeout)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=timeout)


def start_router_thread(router: FleetRouter, *,
                        control: bool = True) -> RouterHandle:
    """Start the router's data plane on a daemon thread (and, with
    ``control``, broadcast the initial placement and start the control
    loop); returns once it accepts."""
    loop, thread = ops.spawn_server_loop(router._start,
                                         "qldpc-fleet-router",
                                         "fleet router")
    if control:
        router.start_control()
    return RouterHandle(router, loop, thread)


class RouterFleetServer(fleet_mod.FleetServer):
    """The fleet ops face with the router's state folded into /varz:
    the placement table (family -> owner/successor/epoch) and the
    last-handoff ages — what ``telemetry_report.py --fleet`` renders."""

    def __init__(self, router: FleetRouter,
                 gateway: "fleet_mod.FleetGateway",
                 host: str = "127.0.0.1", port: int = 0):
        super().__init__(gateway, host=host, port=port)
        self.router = router

    def varz(self) -> dict:
        body = super().varz()
        body["placement"] = self.router.placement()
        body["handoffs"] = self.router.handoff_report()
        body["down_hosts"] = sorted(self.router.down)
        return body


def start_router_ops_thread(router: FleetRouter, gateway=None,
                            host: str = "127.0.0.1", port: int = 0, *,
                            scrape: bool = False) -> "fleet_mod.FleetHandle":
    """Serve the router-aware fleet ops view on a daemon thread."""
    gw = gateway if gateway is not None else router.gateway
    if gw is None:
        raise ValueError("start_router_ops_thread needs a FleetGateway")
    server = RouterFleetServer(router, gw, host=host, port=port)
    loop, thread = ops.spawn_server_loop(server.start, "qldpc-router-ops",
                                         "router ops")
    if scrape:
        gw.start()
    return fleet_mod.FleetHandle(server, loop, thread)


class FleetScaler:
    """Fleet-level scaling: drives each host's AutoScaler (batch-target
    resize, mesh shard/retire — the per-host control laws stay where they
    are), and rebalances placement off the gateway's merged load signal —
    when the hottest host's queue depth exceeds the coldest's by
    ``rebalance_gap`` and the cooldown passed, the smallest family moves
    (live, via :meth:`FleetRouter.move_family`)."""

    def __init__(self, router: FleetRouter, gateway=None,
                 scalers: dict | None = None, *,
                 rebalance_gap: int = 64, cooldown_s: float = 5.0):
        self.router = router
        self.gateway = gateway if gateway is not None else router.gateway
        self.scalers = dict(scalers or {})
        self.rebalance_gap = int(rebalance_gap)
        self.cooldown_s = float(cooldown_s)
        self._last_move: "float | None" = None

    def evaluate_once(self, now=None) -> list:
        now = time.monotonic() if now is None else now
        down = self.router.down
        actions: list = []
        for label in sorted(self.scalers):
            if label in down:
                continue
            for act in (self.scalers[label].evaluate_once() or ()):
                actions.append({"host": label, "action": act})
        if self.gateway is None:
            return actions
        loads = {label: depth
                 for label, depth in self.gateway.host_loads().items()
                 if depth is not None and label not in down
                 and label in self.router.hosts}
        if len(loads) < 2:
            return actions
        hot = max(sorted(loads), key=lambda lb: loads[lb])
        cold = min(sorted(loads), key=lambda lb: loads[lb])
        gap = loads[hot] - loads[cold]
        cooled = (self._last_move is None
                  or now - self._last_move >= self.cooldown_s)
        if hot != cold and gap >= self.rebalance_gap and cooled:
            placement = self.router.placement()
            owned = sorted(
                (fam for fam, p in placement.items()
                 if p["owner"] == hot),
                key=lambda f: (len(self.router.families.get(f, ())), f))
            if owned and self.router.move_family(
                    owned[0], cold, reason=f"rebalance:{hot}->{cold}"):
                self._last_move = now
                actions.append({"host": hot, "action": "fleet_move",
                                "family": owned[0], "to": cold,
                                "gap": int(gap)})
        return actions


class LocalFleet:
    """An N-host in-process serving fleet behind one router: per-host
    ContinuousBatcher + DecodeServer + ops plane, one FleetGateway (fast
    scrape/deadman intervals), one FleetRouter.  The harness for the
    fleet chaos tests and ``chip_smoke.py``'s fleet phase.

    ``session_factory()`` builds one host's ``{name: DecodeSession}``
    (called once per host — every host serves the same session set);
    ``stream_profiles_factory()`` likewise for stream profiles.  Family
    keys derive from each session's ``bucket_family`` digest, so co-fused
    sessions always land on one host."""

    def __init__(self, session_factory, *, n_hosts: int = 2,
                 stream_profiles_factory=None,
                 batcher_kwargs: dict | None = None,
                 interval_s: float = 0.05, down_after_s: float = 0.25,
                 control_interval_s: float = 0.02,
                 warm: bool = False):
        from .scheduler import ContinuousBatcher
        from .server import start_server_thread
        from .session import family_digest

        self.labels = [f"h{i}" for i in range(int(n_hosts))]
        bkw = dict(batcher_kwargs or {})
        bkw.setdefault("max_batch_shots", 64)
        bkw.setdefault("max_wait_s", 0.002)
        self.sessions: dict = {}
        self.batchers: dict = {}
        self.server_handles: dict = {}
        self.ops_handles: dict = {}
        self._killed: set = set()
        self._kill_lock = threading.Lock()
        # host label -> programs released at its kill
        self.released: dict = {}
        families: dict = {}
        profiles: dict = {}
        for label in self.labels:
            sessions = dict(session_factory())
            profs = (dict(stream_profiles_factory())
                     if stream_profiles_factory is not None else None)
            if warm:
                for sess in sessions.values():
                    sess.warm()
            self.sessions[label] = sessions
            bat = ContinuousBatcher(sessions, **bkw)
            self.batchers[label] = bat
            self.server_handles[label] = start_server_thread(
                bat, stream_profiles=profs)
            self.ops_handles[label] = ops.start_ops_thread(batcher=bat)
            if label == self.labels[0]:
                for name in sorted(sessions):
                    fam = f"fam-{family_digest(sessions[name].family)}"
                    families.setdefault(fam, []).append(name)
                if profs:
                    profiles = {pname: prof.session
                                for pname, prof in profs.items()}
        targets = {label: "http://{}:{}".format(*h.address)
                   for label, h in self.ops_handles.items()}
        self.gateway = fleet_mod.FleetGateway(
            targets, interval_s=interval_s, down_after_s=down_after_s)
        self.router = FleetRouter(
            hosts={lb: self.server_handles[lb].address
                   for lb in self.labels},
            families=families, profiles=profiles, gateway=self.gateway,
            control_interval_s=control_interval_s)
        self.router_handle = start_router_thread(self.router)
        self.ops_handle = start_router_ops_thread(
            self.router, self.gateway, scrape=True)

    @property
    def address(self) -> tuple:
        return self.router_handle.address

    # ------------------------------------------------------------------
    def chaos_tick(self) -> None:
        """Storm workers call this between requests; under a
        ``host_kill`` plan the matched hit kills the CURRENT owner of the
        first (sorted) family — deterministic given the seeded plan.  A
        fault carrying ``target`` aims instead: a host label kills that
        host, a family key kills its current owner."""
        faultinject.site("fleet_host_tick",
                         actions={"host_kill": self._enact_host_kill})

    def _enact_host_kill(self, fault) -> None:
        target = getattr(fault, "target", "") or ""
        if target in self.labels:
            self.kill(target)
            return
        placement = self.router.placement()
        fam = target if target in placement else sorted(placement)[0]
        self.kill(placement[fam]["owner"])

    def kill(self, label: str) -> bool:
        """Hard host death: the server's tasks are cancelled before the
        batcher closes (clients see pure transport death), then the ops
        plane stops so the gateway's scrapes fail and the ``host_down``
        deadman fires — the ONLY trigger for handoff."""
        with self._kill_lock:
            if label in self._killed:
                return False
            self._killed.add(label)
        self.server_handles[label].kill()
        self.ops_handles[label].stop()
        # one process holds every host: the dead host's captured graphs
        # and the buffers they read go with it (its batcher is closed, so
        # no replay of them is in flight)
        self.released[label] = self.batchers[label].release()
        return True

    def stop(self) -> None:
        try:
            self.router_handle.stop()
        finally:
            try:
                self.ops_handle.stop()
            finally:
                for label in self.labels:
                    with self._kill_lock:
                        if label in self._killed:
                            continue
                    try:
                        self.ops_handles[label].stop()
                    except Exception:  # noqa: BLE001
                        pass
                    try:
                        self.server_handles[label].stop(drain=True)
                    except Exception:  # noqa: BLE001
                        pass
