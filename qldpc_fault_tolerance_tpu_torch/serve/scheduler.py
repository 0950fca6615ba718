"""Continuous-batching scheduler: coalesce decode requests into padded
megabatches on persistent sessions.

The same shape LLM inference servers use: requests arrive whenever they
arrive, the dispatcher keeps one queue per (session, tenant) and flushes a
session's queue into ONE padded device batch when either the **batch-fill**
threshold (``max_batch_shots``) or the **deadline** (``max_wait_s`` since
the session's oldest queued request) is reached — small-request tenants pay
bounded latency, bursty tenants get amortized dispatches, and the chip sees
full buckets instead of per-request dribbles.

Fairness is round-robin across tenants at assembly time
(``assemble_round_robin``): a tenant flooding the queue cannot starve the
others — every flush takes at most its rotating share, and the other
tenants' requests ride the same batch.

Cross-session fused dispatch: when the flushed session shares
a bucket FAMILY with other pending sessions (equal program shape —
another code of the same dimensions, another p's priors), their rounds
ride ONE cell-fused device program (``session.FusedDecodeGroup``,
session = cell axis, lane membership traced) and per-session corrections
are sliced on host — many tenants, many codes, one dispatch.  Rounds
that don't co-bucket (oversize part, unstackable family) fall back to
the per-session path, COUNTED (``serve.fused.fallbacks`` + per-family
eligibility in ``health()``) so a shape drift that silently stops
co-bucketing is operator-visible instead of a quiet throughput loss.

Every dispatch runs under the active resilience policy
(utils.resilience.run_cell) with a one-rung degradation ladder that
invalidates + rebuilds the session's compiled programs — the recovery that
actually helps after a worker restart killed the uploaded graph buffers.

Exactly-once re-dispatch: a dispatch that still fails after
retries RE-QUEUES its batch's requests — each request carries a bounded
attempt budget (``max_dispatch_attempts``); only when the budget is
exhausted (or the error is deterministic, or the batcher is stopped) is
the future failed with a structured error.  Requests carrying an
idempotency key (serve/wire.py ``IDEM_FIELD``) are JOURNALED from accept
to answer: a duplicate submit with the same key — a client hedge or a
reconnect resubmit — attaches to the in-flight decode, and a duplicate
arriving just after the answer replays the cached result from a bounded
LRU.  No request dropped, none decoded twice.  ``drain()`` flushes
everything left before stopping, so shutdown loses nothing either.

Self-healing feed: every failed dispatch is recorded as an *incident*
(session, error classification) that ``serve.ops.HealthProbe`` drains to
drive background session recompiles — detection is push-based off the
dispatcher's failures, never a poll of device state.

SLO observability (utils.telemetry, free when disabled): ``serve.requests``
/ ``serve.shots`` / ``serve.batches`` / ``serve.errors`` counters (plus
per-tenant request counters), ``serve.queue_depth`` gauge,
``serve.latency_s`` / ``serve.batch_occupancy`` / ``serve.batch_wait_s``
histograms, and ``serve_request`` / ``serve_batch`` / ``serve_drain``
events in the versioned schema scripts/telemetry_report.py and
scripts/sweep_dashboard.py render.

Per-request observability: a request carrying a trace context
(utils.tracing, propagated from the wire frame by serve/server.py) records
queue_wait / batch_assemble / pad / device_decode / slice stage spans
(batch stages amortized, with the factor on the span); every accepted
request lands in the process flight-recorder ring, and a dispatch that
fails after retries ships a postmortem naming exactly the requests that
were in flight.  An attached ``serve.ops.SLOEngine`` turns the per-request
stream into admission signals: "shed" tenants are rejected at submit,
"defer" tenants ride batches' spare capacity only.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from ..utils import faultinject, resilience, telemetry, tracing
from .session import (
    OCCUPANCY_BUCKETS,
    DecodeSession,
    FusedDecodeGroup,
    SessionCache,
    family_digest,
)

__all__ = ["DecodeResult", "ContinuousBatcher", "assemble_round_robin"]


@dataclasses.dataclass
class DecodeResult:
    """What a request's future resolves to."""

    corrections: np.ndarray          # (k, n) uint8 — this request's rows
    converged: np.ndarray | None     # (k,) bool when the decoder reports it
    request_id: str | None
    latency_s: float                 # submit -> completion, scheduler-side


def _resolve(fut: Future, result=None,
             exc: "BaseException | None" = None) -> bool:
    """Resolve a request future, tolerating one that was already resolved
    or CANCELLED underneath us: a killed host's response waiters cancel
    their wrapped futures, and the dispatch
    completing a moment later must count the orphan, not die on it."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:
        telemetry.count("serve.futures_orphaned")
        return False


@dataclasses.dataclass
class _Request:
    request_id: str | None
    tenant: str
    session: str
    syndromes: np.ndarray
    future: Future
    t0: float
    trace: "tracing.TraceContext | None" = None
    # journal key for exactly-once dedupe: (tenant, session, idem) — the
    # wire-controlled idem string alone must never be the key, or a
    # collision (hostile or low-entropy client) would replay one tenant's
    # corrections to another
    idem: tuple | None = None
    attempts: int = 0             # failed dispatches this request rode

    @property
    def shots(self) -> int:
        return int(self.syndromes.shape[0])


class _SessionQueue:
    """Per-session pending state: one FIFO per tenant + a rotation order."""

    __slots__ = ("tenants", "order", "shots", "oldest_t")

    def __init__(self):
        self.tenants: "OrderedDict[str, deque[_Request]]" = OrderedDict()
        self.order: deque[str] = deque()
        self.shots = 0
        self.oldest_t: float | None = None

    def add(self, req: _Request) -> None:
        q = self.tenants.get(req.tenant)
        if q is None:
            q = self.tenants[req.tenant] = deque()
            self.order.append(req.tenant)
        q.append(req)
        self.shots += req.shots
        if self.oldest_t is None or req.t0 < self.oldest_t:
            self.oldest_t = req.t0

    def empty(self) -> bool:
        return not self.tenants


def assemble_round_robin(queue: _SessionQueue, max_shots: int,
                         force: bool = False,
                         deferred=frozenset()) -> list[_Request]:
    """Pop one flush's worth of requests, one request per tenant per
    rotation, until adding the next would exceed ``max_shots`` (the first
    request always goes in, so an oversize request still dispatches — the
    session chunks it).  ``force`` ignores the cap (drain).  Pure queue
    surgery, unit-tested directly for the fairness property: with tenants
    A(flood) and B(one request), B's request rides the FIRST batch.

    ``deferred`` tenants (the SLO engine's "defer" admission signal) are
    DEPRIORITIZED, not starved: they are skipped on the first pass and
    only ride the batch's spare capacity after every admitted tenant has
    taken its rotating share — or dispatch alone when nothing else is
    queued."""
    batch: list[_Request] = []
    taken = 0

    def _pass(include) -> bool:
        """One rotation pass over tenants matching ``include``; returns
        False once capacity is used up.  Terminates: every iteration pops
        a request, removes an exhausted tenant, or bumps ``skipped`` —
        which a full excluded-tenants rotation bounds."""
        nonlocal taken
        skipped = 0
        while queue.order and skipped < len(queue.order):
            tenant = queue.order[0]
            q = queue.tenants.get(tenant)
            if not q:
                queue.order.popleft()
                queue.tenants.pop(tenant, None)
                continue
            if not include(tenant):
                queue.order.rotate(-1)
                skipped += 1
                continue
            nxt = q[0]
            if batch and not force and taken + nxt.shots > max_shots:
                return False
            q.popleft()
            batch.append(nxt)
            taken += nxt.shots
            queue.order.rotate(-1)
            skipped = 0
            if not force and taken >= max_shots:
                return False
        return True

    if deferred:
        _pass(lambda t: t not in deferred)
        # spare capacity — not "the admitted pass ran dry" — decides
        # whether deferred tenants ride: the admitted pass may stop
        # because ITS next request is too big while a smaller deferred
        # one still fits, and skipping the pass then would starve defer
        # tenants outright under a sustained admitted flood
        if force or taken < max_shots:
            _pass(lambda t: t in deferred)
    else:
        _pass(lambda t: True)
    # trim exhausted tenants + refresh the aggregate bookkeeping
    for tenant in [t for t, q in queue.tenants.items() if not q]:
        queue.tenants.pop(tenant)
        try:
            queue.order.remove(tenant)
        except ValueError:
            pass
    queue.shots -= taken
    queue.oldest_t = min(
        (q[0].t0 for q in queue.tenants.values() if q), default=None)
    return batch


class ContinuousBatcher:
    """The dispatcher: one daemon worker thread draining per-session queues
    into padded megabatches on the persistent sessions.

    ``sessions``: a ``SessionCache``, or a dict name -> DecodeSession
    (wrapped).  ``submit`` returns a ``concurrent.futures.Future`` that
    resolves to a ``DecodeResult`` (asyncio callers wrap it with
    ``asyncio.wrap_future`` — that is exactly what serve/server.py does).

    ``slo``: an optional ``serve.ops.SLOEngine``.  When attached, every
    submit consults its admission signal (a "shed" tenant's submit raises
    ``AdmissionError`` — the server answers it as a structured error),
    "defer" tenants are deprioritized at assembly, and every completed or
    failed request feeds the engine's rolling window.
    """

    def __init__(self, sessions, *, max_batch_shots: int = 1024,
                 max_wait_s: float = 0.002, slo=None,
                 max_dispatch_attempts: int = 3,
                 answered_cache: int = 4096, fused: bool = True):
        if isinstance(sessions, dict):
            cache = SessionCache(max_sessions=max(8, len(sessions)))
            for s in sessions.values():
                cache.add(s)
            sessions = cache
        self.sessions: SessionCache = sessions
        self.slo = slo
        self.max_batch_shots = max(1, int(max_batch_shots))
        self.max_wait_s = float(max_wait_s)
        # cross-session fused dispatch: when the flushed
        # session shares a bucket family with other pending sessions,
        # their rounds ride ONE cell-fused device program (session = cell
        # axis).  Ineligible rounds (oversize part, unstackable state)
        # fall back per-session — counted, never silent.
        self.fused = bool(fused)
        self.fused_dispatches = 0
        self.fused_fallbacks = 0
        # family -> (member-object tuple, FusedDecodeGroup | None): the
        # group restacks itself on member heals; a member-set change
        # (eviction, new co-family session) builds a fresh group.  None
        # caches a family whose states don't stack (fallback, once).
        # Bounded LRU: a group pins its members' states + compiled
        # executables, and a long-lived host rotating through many code
        # families must not accumulate retired groups forever.
        self._group_cache: "OrderedDict" = OrderedDict()
        self.max_fused_groups = 8
        # per-family health block (touched by the dispatcher thread,
        # snapshotted by health() — guarded by _cv like the queues)
        self._fused_stats: dict = {}
        # exactly-once re-dispatch budget: how many failed dispatches one
        # request may ride before its future gets the structured error
        self.max_dispatch_attempts = max(1, int(max_dispatch_attempts))
        self.answered_cache = max(16, int(answered_cache))
        # the answered LRU is additionally bounded by BYTES: each entry
        # retains a full corrections array, and 4096 large-batch results
        # would otherwise pin GBs on a long-lived host
        self.answered_cache_bytes = 256 * 1024 * 1024
        self._answered_bytes = 0
        self._last_dispatch_t: float | None = None
        self._cv = threading.Condition()
        self._pending: dict[str, _SessionQueue] = {}
        self._queued_requests = 0
        self._draining = False
        self._stopped = False
        self.completed = 0
        self.failed = 0
        self.redispatched = 0
        self._drain_emitted = False
        # the idempotency journal: accepted-but-unanswered
        # requests by key, plus a bounded LRU of recently answered results
        # so a hedge arriving just after the answer replays instead of
        # re-decoding.  Both live under self._cv with the queues — journal
        # transitions must be atomic with queue/answer transitions or a
        # hedge threading the gap would decode twice.
        self._journal: dict[str, _Request] = {}
        self._answered: "OrderedDict[str, DecodeResult]" = OrderedDict()
        # replication bookkeeping: every answered entry gets a
        # monotone sequence number so the fleet router's incremental feed
        # can pull "everything after watermark w" instead of full
        # snapshots; seqs die with their entries on LRU eviction
        self._journal_seq = 0
        self._answered_seqs: dict = {}
        # dispatch-failure incidents for the self-healing probe
        # (serve.ops.HealthProbe.take via take_incidents)
        self._incidents: deque = deque(maxlen=256)
        # per-tenant counter labels are bounded: the tenant string arrives
        # from the wire, and a unique-tenant-per-request client would
        # otherwise grow the process-wide metrics registry without limit
        # in a long-lived service; overflow tenants fold into one label
        self._tenant_labels: set[str] = set()
        self.max_tenant_counters = 32
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="qldpc-serve-scheduler")
        self._thread.start()

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    @staticmethod
    def _result_nbytes(res: DecodeResult) -> int:
        """Retained size of one cached answer (the byte bound on the
        answered LRU)."""
        n = int(res.corrections.nbytes)
        if res.converged is not None:
            n += int(res.converged.nbytes)
        return n

    @staticmethod
    def _attach(src: Future) -> Future:
        """A fresh future mirroring ``src`` (result or exception) — what a
        deduped duplicate submit returns: one decode, several answers."""
        dst: Future = Future()

        def _copy(f):
            if dst.done() or f.cancelled():
                return
            exc = f.exception()
            if exc is not None:
                _resolve(dst, exc=exc)
            else:
                _resolve(dst, f.result())

        src.add_done_callback(_copy)
        return dst

    def submit(self, session: str, syndromes, *, tenant: str = "default",
               request_id: str | None = None, trace=None,
               idem: str | None = None) -> Future:
        """Enqueue one decode request; returns its future.  Validation
        (unknown session, wrong width, empty batch) raises HERE, on the
        caller's thread, so the queue only ever holds dispatchable work —
        and so does the SLO admission gate: a shed tenant's submit raises
        ``AdmissionError`` before anything is queued.  ``trace`` is an
        optional ``tracing.TraceContext`` the request's stage spans record
        under.

        ``idem`` is the optional idempotency key (constant across a
        client's resubmits of ONE logical request): a key already in the
        journal attaches to the in-flight decode, a key in the answered
        LRU replays the cached result — either way the duplicate is
        answered without decoding twice.  Dedupe is scoped per (tenant,
        session): the idem string is wire-controlled, and an unscoped
        collision would hand one tenant another tenant's corrections.
        The dedupe consult precedes the SLO gate deliberately: shedding a
        hedge of work already in flight would waste the decode the
        original is paying for."""
        sess = self.sessions.get(str(session))
        arr = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        if arr.ndim != 2 or arr.shape[0] == 0:
            raise ValueError(f"syndromes must be (B, m), got {arr.shape}")
        if arr.shape[1] != sess.syndrome_width:
            raise ValueError(
                f"session {session!r} decodes width {sess.syndrome_width}, "
                f"got {arr.shape[1]}")
        if idem is not None:
            idem = (str(tenant), str(session), str(idem))
            if self.slo is not None:
                # pre-gate dedupe consult, only needed when an SLO gate
                # exists to mis-fire: a shed tenant's hedge of work
                # already in flight should attach, not be refused (the
                # decode is happening either way).  Without an SLO the
                # single under-lock consult below handles dedupe and the
                # steady-state journal path pays one lock hold, not two.
                with self._cv:
                    done = self._answered.get(idem)
                    if done is not None:
                        self._answered.move_to_end(idem)
                        fut: Future = Future()
                        fut.set_result(done)
                        telemetry.count("serve.dedup.replayed")
                        return fut
                    inflight = self._journal.get(idem)
                    if inflight is not None:
                        telemetry.count("serve.dedup.attached")
                        return self._attach(inflight.future)
        if self.slo is not None:
            self.slo.check_admission(str(tenant))  # raises AdmissionError
        req = _Request(request_id=request_id, tenant=str(tenant),
                       session=str(session), syndromes=arr,
                       future=Future(), t0=time.perf_counter(), trace=trace,
                       idem=idem)
        with self._cv:
            if idem is not None:
                # the (re-)check under the same lock hold that enqueues:
                # a concurrent duplicate landing between any earlier
                # consult and here must still dedupe.  It runs BEFORE the
                # draining/stopped refusal: a reconnect resubmit of a
                # request that was accepted and decoded must replay (or
                # attach) even mid-drain — refusing it would surface a
                # logically-completed request as an error, and neither
                # dedupe path enqueues anything
                done = self._answered.get(idem)
                if done is not None:
                    self._answered.move_to_end(idem)
                    fut = Future()
                    fut.set_result(done)
                    telemetry.count("serve.dedup.replayed")
                    return fut
                inflight = self._journal.get(idem)
                if inflight is not None:
                    telemetry.count("serve.dedup.attached")
                    return self._attach(inflight.future)
            if self._stopped or self._draining:
                raise RuntimeError("scheduler is draining/stopped")
            if idem is not None:
                self._journal[idem] = req
            self._pending.setdefault(req.session, _SessionQueue()).add(req)
            self._queued_requests += 1
            depth = self._queued_requests
            if req.tenant not in self._tenant_labels:
                if len(self._tenant_labels) < self.max_tenant_counters:
                    self._tenant_labels.add(req.tenant)
            label = (req.tenant if req.tenant in self._tenant_labels
                     else "__other__")
            telemetry.set_gauge("serve.queue_depth", depth)
            self._cv.notify()
        if self.slo is not None:
            self.slo.observe_queue_depth(depth)
        # the flight recorder sees every accepted request (always on,
        # lock-free): a crashed dispatch's postmortem names exactly what
        # was in flight
        tracing.flight_record(
            "request", session=req.session, tenant=req.tenant,
            shots=req.shots,
            **({} if req.request_id is None else {"id": req.request_id}),
            **({} if trace is None else {"trace_id": trace.trace_id}))
        telemetry.count("serve.requests")
        telemetry.count("serve.shots", req.shots)
        telemetry.count(f"serve.tenant.{label}.requests")
        return req.future

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _pick_locked(self, now: float, force: bool):
        """Choose (primary session name, rounds) under the lock, or None.
        Flushable: batch-fill reached, deadline passed, or ``force``
        (drain).  Among flushable sessions the oldest queued request wins
        (FIFO across sessions).  ``rounds`` is ``[(session, batch)]``:
        with fused dispatch enabled, pending sessions sharing the
        primary's bucket family ride the SAME dispatch (their deadlines
        haven't expired — riding early only helps them)."""
        best, best_t = None, None
        for name, q in self._pending.items():
            if q.empty():
                continue
            due = (force or q.shots >= self.max_batch_shots
                   or (q.oldest_t is not None
                       and now - q.oldest_t >= self.max_wait_s))
            if due and (best_t is None or q.oldest_t < best_t):
                best, best_t = name, q.oldest_t
        if best is None:
            return None
        deferred = (self.slo.deferred_tenants()
                    if self.slo is not None else frozenset())

        def flush(name):
            q = self._pending[name]
            batch = assemble_round_robin(q, self.max_batch_shots,
                                         force=force, deferred=deferred)
            if q.empty():
                self._pending.pop(name, None)
            return batch

        rounds = [(best, flush(best))]
        if self.fused:
            fam = self._family_of(best)
            if fam is not None:
                for name in [n for n, q in self._pending.items()
                             if n != best and not q.empty()]:
                    if self._family_of(name) == fam:
                        batch = flush(name)
                        if batch:
                            rounds.append((name, batch))
        return best, rounds

    def _family_of(self, name: str):
        """A pending session's bucket family, or None when it vanished
        from the cache (its batch will fail inside the dispatch guard,
        exactly like the per-session path)."""
        try:
            return self.sessions.get(name).family
        except KeyError:
            return None

    def _next_deadline(self) -> float | None:
        ts = [q.oldest_t for q in self._pending.values()
              if q.oldest_t is not None]
        return (min(ts) + self.max_wait_s) if ts else None

    def _loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stopped:
                        return
                    now = time.perf_counter()
                    picked = self._pick_locked(now, force=self._draining)
                    if picked is not None:
                        self._queued_requests -= sum(
                            len(b) for _n, b in picked[1])
                        telemetry.set_gauge("serve.queue_depth",
                                            self._queued_requests)
                        break
                    if self._draining and not self._pending:
                        self._stopped = True
                        self._cv.notify_all()
                        return
                    deadline = self._next_deadline()
                    timeout = (None if deadline is None
                               else max(0.0, deadline - now))
                    self._cv.wait(timeout)
            self._dispatch(*picked)

    def _dispatch(self, primary: str, rounds) -> None:
        """Route one picked flush: a single round goes down the
        per-session path; multiple co-family rounds try the fused path,
        with ineligible rounds (oversize part, unstackable family) falling
        back per-session — counted, never silent."""
        if len(rounds) == 1:
            self._dispatch_one(*rounds[0])
            return
        group = self._fused_group(primary)
        solo, fusable = [], []
        for name, batch in rounds:
            shots = sum(r.shots for r in batch)
            if group is None:
                solo.append((name, batch))
            elif shots > group.buckets[-1]:
                # a force-drain (or oversize-request) round past the top
                # bucket chunks through the per-session path
                self._count_fallback(group, "oversize")
                solo.append((name, batch))
            else:
                fusable.append((name, batch))
        if group is not None and len(fusable) >= 2:
            self._dispatch_fused(group, fusable)
        else:
            solo = fusable + solo
        for name, batch in solo:
            self._dispatch_one(name, batch)

    # ------------------------------------------------------------------
    # fused-group bookkeeping
    # ------------------------------------------------------------------
    def _fused_group(self, primary: str) -> "FusedDecodeGroup|None":
        """The fused group serving the primary's bucket family, built over
        ALL cached sessions of that family (so any pending subset reuses
        the same lane programs) and rebuilt when the member set (or any
        member object) changed.  None when the family doesn't stack —
        negative-cached per member set, counted as a fallback per
        dispatch."""
        try:
            fam = self.sessions.get(primary).family
        except KeyError:
            return None
        members = []
        for name in self.sessions.names():
            try:
                sess = self.sessions.get(name)
            except KeyError:
                continue
            # strictly family-matched: a pending round whose session
            # drifted out of the family (config swap under the same
            # name) is NOT forced in — its round takes the transient
            # requeue path and flushes as its own primary next pick
            if sess.family == fam:
                members.append(sess)
        members.sort(key=lambda s: s.name)
        if len(members) < 2:
            # the family shrank under us (evictions/config swaps): not a
            # stacking failure, just nothing to fuse this pick
            return None
        objs = tuple(members)
        cached = self._group_cache.get(fam)
        if cached is not None and cached[0] == objs:
            self._group_cache.move_to_end(fam)
            if cached[1] is None:
                self._count_fallback(None, "unstackable", fam=fam)
            return cached[1]
        try:
            group = FusedDecodeGroup(members)
        except Exception as exc:  # noqa: BLE001 — fall back, loudly
            telemetry.event("fused_fallback",
                            reason=f"group_build: {type(exc).__name__}",
                            cells=len(members))
            self._store_group(fam, objs, None)
            self._count_fallback(None, "unstackable", fam=fam)
            return None
        self._store_group(fam, objs, group)
        with self._cv:
            # MERGE into an existing entry: a group rebuild (member
            # eviction/recreation) must not zero the cumulative per-family
            # history this block exists to expose
            st = self._fused_stats.setdefault(group.family_label(), {
                "sessions": [], "eligible": True,
                "dispatches": 0, "fallbacks": 0, "last_fallback": None})
            st["sessions"] = list(group.names)
            st["eligible"] = True
        return group

    def _store_group(self, fam, objs, group) -> None:
        """Insert/replace one family's group, LRU-bounded: a retired
        family's group pins member states + compiled executables, so a
        host rotating through many families evicts the least-recently
        picked one (a re-pick simply rebuilds + recompiles)."""
        self._group_cache[fam] = (objs, group)
        self._group_cache.move_to_end(fam)
        while len(self._group_cache) > self.max_fused_groups:
            self._group_cache.popitem(last=False)
            telemetry.count("serve.fused.group_evictions")

    def _count_fallback(self, group, reason: str, fam=None) -> None:
        self.fused_fallbacks += 1
        telemetry.count("serve.fused.fallbacks")
        telemetry.count(f"serve.fused.fallback.{reason}")
        label = (group.family_label() if group is not None
                 else f"unstackable.{family_digest(fam)}")
        with self._cv:
            st = self._fused_stats.setdefault(label, {
                "sessions": [], "eligible": group is not None,
                "dispatches": 0, "fallbacks": 0, "last_fallback": None})
            st["fallbacks"] += 1
            st["last_fallback"] = reason
            st["eligible"] = group is not None

    def _dispatch_fused(self, group: FusedDecodeGroup, rounds) -> None:
        """One cross-session fused dispatch: every round becomes one lane
        of the group's cell-fused program; per-session corrections are
        sliced on host and each round completes exactly like a per-session
        batch (journal, futures, telemetry)."""
        t_assembled = time.perf_counter()
        flat = [r for _n, b in rounds for r in b]
        traced = [r for r in flat if r.trace is not None]
        for r in traced:
            tracing.record_span(
                "queue_wait", r.trace, dur_s=t_assembled - r.t0,
                session=r.session, tenant=r.tenant,
                **({} if r.request_id is None
                   else {"request_id": r.request_id}))
        synds = [(name, (batch[0].syndromes if len(batch) == 1
                         else np.concatenate([r.syndromes for r in batch])))
                 for name, batch in rounds]
        total_shots = sum(int(s.shape[0]) for _n, s in synds)
        wait_s = time.perf_counter() - min(r.t0 for r in flat)
        t0 = time.perf_counter()
        for r in traced:
            tracing.record_span(
                "batch_assemble", r.trace, dur_s=t0 - t_assembled,
                requests=len(flat), shots=total_shots,
                amortized_over=len(flat))
        idx = {name: i for i, name in enumerate(group.names)}
        try:
            if any(name not in idx for name, _s in synds):
                # a member replaced/evicted between group build and now:
                # transient — the re-queue (or the next flush's rebuilt
                # group) serves it
                raise resilience.TransientFault(
                    "fused group membership changed under the dispatch")
            group.ensure_fresh()
            parts = [(idx[name], s) for name, s in synds]
            ladder = resilience.DegradationLadder(
                [("serve_fused_recompile", group.invalidate)])

            def _decode():
                faultinject.site("serve_fused_dispatch", actions={
                    "device_restart": self._chaos_device_restart,
                    "session_evict": lambda f: self._chaos_session_evict(
                        group, f),
                })
                return group.decode(parts)

            with telemetry.span("serve.dispatch"):
                outs = resilience.run_cell(
                    _decode, label="serve_fused_dispatch",
                    degrade=ladder.step)
        except Exception as exc:  # noqa: BLE001 — answered, not dropped
            synd_all = np.concatenate([s for _n, s in synds])
            self._dispatch_failed(group.name, flat, traced, synd_all, exc,
                                  t0, sessions=[n for n, _b in rounds])
            return
        dispatch_s = time.perf_counter() - t0
        self._last_dispatch_t = time.monotonic()
        self.fused_dispatches += 1
        telemetry.count("serve.fused.dispatches")
        telemetry.count("serve.fused.lanes", len(rounds))
        label = group.family_label()
        with self._cv:
            st = self._fused_stats.get(label)
            if st is not None:
                st["dispatches"] += 1
        for (name, batch), out in zip(rounds, outs):
            self._finish_batch(name, batch, out, wait_s, dispatch_s,
                               amortized_over=len(flat),
                               fused_lanes=len(rounds), family=label)

    def _dispatch_one(self, session_name: str,
                      batch: list[_Request]) -> None:
        t_assembled = time.perf_counter()
        traced = [r for r in batch if r.trace is not None]
        for r in traced:
            # queue_wait: submit -> assembled into this flush
            tracing.record_span(
                "queue_wait", r.trace, dur_s=t_assembled - r.t0,
                session=session_name, tenant=r.tenant,
                **({} if r.request_id is None
                   else {"request_id": r.request_id}))
        synd = (batch[0].syndromes if len(batch) == 1
                else np.concatenate([r.syndromes for r in batch]))
        wait_s = time.perf_counter() - min(r.t0 for r in batch)
        t0 = time.perf_counter()
        for r in traced:
            tracing.record_span(
                "batch_assemble", r.trace, dur_s=t0 - t_assembled,
                requests=len(batch), shots=int(synd.shape[0]),
                amortized_over=len(batch))
        try:
            # the lookup lives INSIDE the guard: a session evicted between
            # submit and flush must fail this batch's futures, not kill
            # the dispatcher thread (which would hang the whole service)
            sess: DecodeSession = self.sessions.get(session_name)
            # recovery rungs: a SHARDED session first retires its mesh
            # (a device loss makes the sharded program a guaranteed loss
            # while the single-device twin still serves — the elastic
            # degrade composing with the mesh_replan semantics),
            # then repeated transient faults invalidate the session
            # (programs recompile against freshly uploaded state — the
            # rung that matters after a worker restart)
            rungs = []
            if sess.sharded:
                rungs.append(("serve_mesh_unshard",
                              lambda: sess.unshard(reason="degrade")))
            rungs.append(("serve_session_recompile", sess.invalidate))
            ladder = resilience.DegradationLadder(rungs)

            def _decode():
                faultinject.site("serve_dispatch", actions={
                    # chaos enactments: a worker restart kills
                    # every uploaded buffer then the dispatch dies
                    # transiently; a session eviction drops the warm
                    # compiled state mid-flight.  Both recoveries — the
                    # in-dispatch recompile rung and the background heal —
                    # must serve the requests anyway.
                    "device_restart": self._chaos_device_restart,
                    "session_evict": lambda f: self._chaos_session_evict(
                        sess, f),
                })
                return sess.decode(synd)

            with telemetry.span("serve.dispatch"):
                out = resilience.run_cell(_decode, label="serve_dispatch",
                                          degrade=ladder.step)
        except Exception as exc:  # noqa: BLE001 — answered, not dropped
            self._dispatch_failed(session_name, batch, traced, synd, exc,
                                  t0)
            return
        dispatch_s = time.perf_counter() - t0
        self._last_dispatch_t = time.monotonic()
        self._finish_batch(session_name, batch, out, wait_s, dispatch_s,
                           amortized_over=len(batch))

    def _finish_batch(self, session_name: str, batch, out, wait_s: float,
                      dispatch_s: float, *, amortized_over: int,
                      fused_lanes: int = 0,
                      family: str | None = None) -> None:
        """Complete one session's decoded round: slice per-request
        results, journal transitions, resolve futures, record stage spans
        and telemetry.  Shared by the per-session and fused paths —
        ``fused_lanes``/``family`` annotate the serve_batch event, and
        ``amortized_over`` is the whole dispatch's request count (a fused
        dispatch's batch stages amortize across every lane's requests)."""
        traced = [r for r in batch if r.trace is not None]
        occupancy = out.shots / out.padded_shots if out.padded_shots else 0.0
        stage_s = out.timings or {}
        now = time.perf_counter()
        results = []
        lo = 0
        for r in batch:
            hi = lo + r.shots
            results.append(DecodeResult(
                corrections=out.corrections[lo:hi],
                converged=(None if out.converged is None
                           else out.converged[lo:hi]),
                request_id=r.request_id, latency_s=now - r.t0))
            lo = hi
        # journal transitions BEFORE the futures resolve: a hedge landing
        # between "answered" and "journal removed" must find the cached
        # result, or it would re-decode work that already completed
        with self._cv:
            for r, res in zip(batch, results):
                if r.idem is None:
                    continue
                self._journal.pop(r.idem, None)
                # cache a COPY: res.corrections is a slice VIEW of the
                # whole batch's array, and caching the view would pin the
                # full (batch_shots, n) base buffer per entry while the
                # byte accounting below counted only the slice — exactly
                # the retention blowup the byte bound exists to prevent.
                # An explicit .copy(): ascontiguousarray would hand the
                # axis-0 slice (already contiguous) straight back, base
                # and all.
                cached = DecodeResult(
                    corrections=res.corrections.copy(),
                    converged=(None if res.converged is None
                               else res.converged.copy()),
                    request_id=res.request_id, latency_s=res.latency_s)
                self._answered[r.idem] = cached
                self._answered_bytes += self._result_nbytes(cached)
                self._journal_seq += 1
                self._answered_seqs[r.idem] = self._journal_seq
            while self._answered and (
                    len(self._answered) > self.answered_cache
                    or self._answered_bytes > self.answered_cache_bytes):
                key, old = self._answered.popitem(last=False)
                self._answered_bytes -= self._result_nbytes(old)
                self._answered_seqs.pop(key, None)
        for r, res in zip(batch, results):
            lat = res.latency_s
            _resolve(r.future, res)
            self.completed += 1
            if self.slo is not None:
                self.slo.observe_request(r.tenant, lat, ok=True)
            if r.trace is not None:
                # pad / device_decode / slice are BATCH stages; each traced
                # request records them with the amortization factor so a
                # span tree stays honest about shared work (a fused
                # dispatch amortizes over EVERY lane's requests)
                for stage in ("pad", "device_decode", "slice"):
                    tracing.record_span(
                        stage, r.trace, dur_s=float(stage_s.get(stage, 0.0)),
                        amortized_over=amortized_over,
                        bucket=int(max(out.buckets)), shots=r.shots)
            telemetry.observe("serve.latency_s", lat)
            telemetry.event("serve_request", session=session_name,
                            tenant=r.tenant, shots=r.shots,
                            id=(None if r.request_id is None
                                else str(r.request_id)),
                            latency_s=round(lat, 6), ok=True)
        telemetry.count("serve.batches")
        telemetry.count("serve.padded_shots", out.padded_shots - out.shots)
        telemetry.observe("serve.batch_occupancy", occupancy,
                          buckets=OCCUPANCY_BUCKETS)
        telemetry.observe("serve.batch_wait_s", wait_s)
        telemetry.event("serve_batch", session=session_name,
                        requests=len(batch), shots=out.shots,
                        bucket=int(max(out.buckets)),
                        occupancy=round(occupancy, 4),
                        tenants=len({r.tenant for r in batch}),
                        wait_s=round(wait_s, 6),
                        dispatch_s=round(dispatch_s, 6), ok=True,
                        fused=bool(fused_lanes), lanes=int(fused_lanes),
                        **({} if family is None else {"family": family}))

    # ------------------------------------------------------------------
    # dispatch failure: bounded re-dispatch, then structured error
    # ------------------------------------------------------------------
    def _dispatch_failed(self, session_name: str, batch, traced, synd,
                         exc: Exception, t0: float,
                         sessions=None) -> None:
        """One dispatch died after the in-dispatch retries.  Re-queue every
        request with attempt budget left (transient faults only — the
        session may have been healed/recompiled under it, so the next
        flush rides the recovered program); answer the rest with the
        structured error.  Either way the incident feeds the self-healing
        probe and the postmortem names exactly what was in flight.
        ``sessions`` (fused dispatches) lists every member session the
        failure implicates — the probe heals each of them."""
        err = f"{type(exc).__name__}: {exc}"
        kind = resilience.classify_error(exc)
        retry, dead = [], []
        with self._cv:
            stopped = self._stopped
            for r in batch:
                r.attempts += 1
                if (kind != "deterministic" and not stopped
                        and r.attempts < self.max_dispatch_attempts):
                    retry.append(r)
                else:
                    dead.append(r)
                    if r.idem is not None:
                        # errors are not cached: a later duplicate retries
                        # the decode fresh, which is what a client wants
                        self._journal.pop(r.idem, None)
            for r in retry:
                self._pending.setdefault(r.session, _SessionQueue()).add(r)
            self._queued_requests += len(retry)
            if retry:
                telemetry.set_gauge("serve.queue_depth",
                                    self._queued_requests)
                self._cv.notify()
            for name in (sessions if sessions else [session_name]):
                self._incidents.append({
                    "session": name, "error": err, "kind": kind,
                    "ts": time.monotonic(), "requests": len(batch),
                    "requeued": len(retry)})
        self.redispatched += len(retry)
        self.failed += len(dead)
        telemetry.count("serve.incidents")
        if retry:
            telemetry.count("serve.redispatches", len(retry))
        if dead:
            telemetry.count("serve.errors", len(dead))
        telemetry.event("serve_batch", session=session_name,
                        requests=len(batch), shots=int(synd.shape[0]),
                        bucket=0, ok=False, error=err,
                        requeued=len(retry))
        for r in traced:
            tracing.record_span(
                "device_decode", r.trace,
                dur_s=time.perf_counter() - t0, ok=False, error=err,
                amortized_over=len(batch))
        # the black box: name EXACTLY the requests that were in flight
        # with this dispatch (re-queued ones included — they were hit),
        # then ship the ring as a postmortem (no-op unless a postmortem
        # dir is configured)
        tracing.note_failure(
            "serve_dispatch_failed", session=session_name, error=err,
            requests=len(batch), shots=int(synd.shape[0]),
            request_ids=[r.request_id for r in batch],
            requeued_ids=[r.request_id for r in retry],
            tenants=sorted({r.tenant for r in batch}))
        now = time.perf_counter()
        for r in dead:
            if self.slo is not None:
                self.slo.observe_request(r.tenant, now - r.t0, ok=False)
            _resolve(r.future, exc=exc)

    # ------------------------------------------------------------------
    # chaos enactments (utils.faultinject action kinds)
    # ------------------------------------------------------------------
    @staticmethod
    def _chaos_device_restart(fault) -> None:
        """``device_restart``: the worker restarts under the dispatch —
        every uploaded buffer conceptually dies (``reset_device_state``
        clears the memos and jit caches, bumping the device epoch the
        health probe watches) and the dispatch itself fails transiently."""
        from .. import reset_device_state

        reset_device_state()
        raise faultinject.InjectedFault(fault.message)

    @staticmethod
    def _chaos_session_evict(sess: "DecodeSession", fault) -> None:
        """``session_evict``: the serving session's warm compiled state is
        evicted mid-flight; the dispatch fails transiently and the retry
        must serve through the rebuild."""
        sess.invalidate()
        raise faultinject.InjectedFault(fault.message)

    # ------------------------------------------------------------------
    # warmup (the serve warmup discipline: timed/served paths never
    # compile)
    # ------------------------------------------------------------------
    def warm(self, max_shots: int | None = None) -> None:
        """Precompile every session's shape buckets AND every bucket
        family's fused lane programs up to ``max_shots`` (defaults:
        session ladders fully, fused groups to ``max_batch_shots``)."""
        fams: dict = {}
        for name in self.sessions.names():
            try:
                sess = self.sessions.get(name)
            except KeyError:
                continue
            sess.warm(max_shots)
            fams.setdefault(sess.family, []).append(name)
        if not self.fused:
            return
        for fam, names in fams.items():
            if len(names) < 2:
                continue
            group = self._fused_group(names[0])
            if group is not None:
                group.warm(self.max_batch_shots if max_shots is None
                           else max_shots)

    # ------------------------------------------------------------------
    # self-healing feed (serve.ops.HealthProbe)
    # ------------------------------------------------------------------
    def take_incidents(self) -> list:
        """Drain the recorded dispatch-failure incidents (newest last).
        Consumed by the health probe; each incident names the session and
        the error classification so the probe heals exactly the state the
        failure implicates."""
        with self._cv:
            out = list(self._incidents)
            self._incidents.clear()
        return out

    # ------------------------------------------------------------------
    # health (the ops plane's /healthz body)
    # ------------------------------------------------------------------
    def health(self) -> dict:
        """Liveness snapshot for ``serve.ops.OpsServer``: queue depth,
        session-cache occupancy, last-dispatch age, lifetime counters and
        the draining/stopped flags (which drive the 503)."""
        with self._cv:
            depth = self._queued_requests
            draining, stopped = self._draining, self._stopped
            completed, failed = self.completed, self.failed
            last_t = self._last_dispatch_t
            journal = len(self._journal)
            incidents = len(self._incidents)
            fused_stats = {k: dict(v) for k, v in self._fused_stats.items()}
        return {
            "queue_depth": int(depth),
            "sessions": len(self.sessions),
            "session_names": self.sessions.names(),
            "completed": int(completed),
            "failed": int(failed),
            "redispatched": int(self.redispatched),
            "journal_inflight": int(journal),
            "incidents_pending": int(incidents),
            "draining": bool(draining),
            "stopped": bool(stopped),
            "last_dispatch_age_s": (
                None if last_t is None
                else round(time.monotonic() - last_t, 3)),
            # cross-session fused dispatch: per-bucket-family
            # eligibility + the fallback counter, so an operator can SEE
            # when co-bucketing stopped (a shape drift used to just
            # degrade throughput silently)
            "fused": {
                "enabled": bool(self.fused),
                "dispatches": int(self.fused_dispatches),
                "fallbacks": int(self.fused_fallbacks),
                "families": fused_stats,
            },
        }

    def queue_stats(self) -> dict:
        """Per-session queued shots + total depth (the autoscaler's
        scaling signals, snapshotted under the lock)."""
        with self._cv:
            return {
                "queued_requests": int(self._queued_requests),
                "queued_shots": {name: int(q.shots)
                                 for name, q in self._pending.items()
                                 if not q.empty()},
            }

    # ------------------------------------------------------------------
    # journal replication
    # ------------------------------------------------------------------
    def export_journal(self, since: int = 0) -> dict:
        """Snapshot the answered-LRU entries sequenced AFTER ``since`` as a
        JSON-serializable delta: the fleet router pulls these incrementally
        (per-source watermark) and pushes them to the family's successor
        host, so a handoff replays every already-answered (tenant, session,
        idem) instead of re-decoding — the cross-host half of exactly-once.
        In-flight journal entries are deliberately NOT exported: an
        unanswered request's client resubmits after the host dies and the
        successor decodes it fresh (deterministically, so still bit-exact).
        """
        entries = []
        with self._cv:
            watermark = self._journal_seq
            for key, seq in self._answered_seqs.items():
                if seq <= since:
                    continue
                res = self._answered.get(key)
                if res is None:
                    continue
                entries.append({
                    "seq": int(seq),
                    "key": list(key) if isinstance(key, tuple) else key,
                    "corrections": res.corrections.tolist(),
                    "converged": (None if res.converged is None
                                  else res.converged.tolist()),
                    "request_id": res.request_id,
                    "latency_s": float(res.latency_s),
                })
        entries.sort(key=lambda e: e["seq"])
        return {"watermark": int(watermark), "entries": entries}

    def import_journal(self, snapshot: dict) -> int:
        """Merge one replication delta (an ``export_journal`` payload from
        another host) into the answered LRU, idempotent by key: an entry
        already present locally (this host answered or previously imported
        it) is skipped, everything else becomes a replayable cached answer
        under the normal count/byte LRU bounds.  Returns the number of
        entries actually imported."""
        imported = 0
        with self._cv:
            for entry in sorted(snapshot.get("entries", ()),
                                key=lambda e: e.get("seq", 0)):
                key = entry["key"]
                if isinstance(key, list):
                    key = tuple(key)
                if key in self._answered:
                    continue
                conv = entry.get("converged")
                cached = DecodeResult(
                    corrections=np.asarray(entry["corrections"], np.uint8),
                    converged=(None if conv is None
                               else np.asarray(conv, bool)),
                    request_id=entry.get("request_id"),
                    latency_s=float(entry.get("latency_s", 0.0)))
                self._answered[key] = cached
                self._answered_bytes += self._result_nbytes(cached)
                self._journal_seq += 1
                self._answered_seqs[key] = self._journal_seq
                imported += 1
            while self._answered and (
                    len(self._answered) > self.answered_cache
                    or self._answered_bytes > self.answered_cache_bytes):
                key, old = self._answered.popitem(last=False)
                self._answered_bytes -= self._result_nbytes(old)
                self._answered_seqs.pop(key, None)
        if imported:
            telemetry.count("serve.journal.imported", imported)
        return imported

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def drain(self, timeout: float | None = 60.0) -> None:
        """Graceful shutdown: stop accepting, flush EVERY queued request
        (partial batches included), resolve all futures, stop the worker.
        Idempotent.  A drain that cannot finish within ``timeout`` raises
        ``TimeoutError`` — returning normally would let the caller tear
        down connections while requests are still in flight, silently
        breaking the no-request-dropped guarantee."""
        with self._cv:
            self._draining = True
            if not self._pending and not self._stopped:
                self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            telemetry.count("serve.drain_timeouts")
            raise TimeoutError(
                f"scheduler drain did not complete within {timeout}s "
                f"({self._queued_requests} requests still queued/in flight)")
        # idempotent means ONE serve_drain event too: a cleanup-pattern
        # second drain() must not double-count shutdowns downstream
        if not self._drain_emitted:
            self._drain_emitted = True
            telemetry.event("serve_drain",
                            pending_requests=self._queued_requests,
                            completed=int(self.completed))

    def release(self) -> int:
        """Drop every program this batcher's sessions and fused groups hold
        (a dead host's): call after ``close``.  Returns how many."""
        groups = [g for _objs, g in self._group_cache.values()
                  if g is not None]
        self._group_cache.clear()
        return (sum(g.release() for g in groups)
                + sum(self.sessions.get(name).release()
                      for name in self.sessions.names()))

    def close(self) -> None:
        """Abandoning shutdown (tests/errors): fail queued futures instead
        of running them."""
        with self._cv:
            self._stopped = True
            pending = [r for q in self._pending.values()
                       for dq in q.tenants.values() for r in dq]
            self._pending.clear()
            # the abandoned requests are ANSWERED below, not pending: a
            # later snapshot / idempotent drain() must not report them —
            # and their journal entries go with them (the exception
            # propagates to attached duplicates via the future mirror)
            self._journal.clear()
            self._queued_requests = 0
            telemetry.set_gauge("serve.queue_depth", 0)
            self._cv.notify_all()
        for r in pending:
            _resolve(r.future, exc=RuntimeError("scheduler closed"))
        self._thread.join(timeout=10.0)
