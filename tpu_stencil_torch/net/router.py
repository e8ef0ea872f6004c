"""Request routing and admission control over the replica fleet (the
port's copy of the JAX package's ``net/router.py``).

Three admission layers, cheapest first, each mapped to a distinct HTTP
status by the frontend so clients can react correctly:

1. **drain gate** — once the tier is draining (SIGTERM) no new request
   enters (:class:`Draining` → 503); accepted requests keep completing.
2. **load shed** — the router tracks in-flight bytes (request +
   response buffers of every accepted-but-unresolved request); past the
   ``max_inflight_mb`` watermark a request is shed
   (:class:`Overloaded` → 503 + Retry-After) BEFORE touching any
   replica queue — host memory stays bounded even when every queue
   still has room for small requests.
3. **per-replica backpressure** — the existing bounded-queue contract:
   replicas are tried in least-outstanding order and a full queue moves
   to the next; only when EVERY replica rejects does
   :class:`~tpu_stencil_torch.serve.engine.QueueFull` escape (→ 429 +
   Retry-After, counted in ``rejected_total``). Never a hang, never an
   unbounded buffer.

Placement is **least outstanding requests** (ties break to the lowest
device index): outstanding per replica is tracked router-side via
future done-callbacks, so a replica stuck on a cold compile naturally
stops receiving traffic while its siblings absorb the load — and the
fleet's shared cache warming (:meth:`ReplicaFleet.prewarm_others`)
fires on first sight of a new program key, right after placement.

Coalesced groups enter a replica through
:meth:`~tpu_stencil_torch.serve.engine.StencilServer.submit_group`
(:class:`~tpu_stencil_torch.serve.engine.GroupItem` members): one batch,
one program, one copy to the card.

A replica that answers ``WorkerCrashed`` is restarted in place through
:meth:`ReplicaFleet.restart` (``worker_crash_reroutes_total``) and
the request retries on the fresh engine — one crashed worker costs one
rebuild, not an outage.

**Quarantine** (:mod:`tpu_stencil_torch.integrity.quarantine`): replicas
whose witness re-executions diverge are tracked on a
:class:`~tpu_stencil_torch.integrity.quarantine.QuarantineBoard` — K
mismatches within the window remove the replica from placement
exactly like a drain (``integrity_quarantines_total``,
``replica_quarantined_dev<i>``), background golden-checked probes
re-admit it after N consecutive clean verdicts, and
``POST /admin/quarantine?replica=i`` is the operator override. A
crash-restart does NOT clear quarantine: the engine is fresh but the
distrusted device is the same silicon.
"""

from __future__ import annotations

import concurrent.futures
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_stencil_torch.net.fleet import ReplicaFleet
from tpu_stencil_torch.obs import context as _obs_ctx
from tpu_stencil_torch.obs import ledger as _obs_ledger
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.resilience.errors import WorkerCrashed
from tpu_stencil_torch.serve import bucketing
from tpu_stencil_torch.serve.engine import GroupItem, QueueFull, ServerClosed
from tpu_stencil_torch.serve.metrics import Registry

# Retry-After floors (seconds): queue-full clears within a batch or
# two; a shed watermark needs the in-flight backlog to drain. The
# DERIVED hint (Router.retry_after_s) starts from these and adds what
# the router actually observes — coalescing window, measured queue
# delay, and the time the current backlog needs at the recent service
# rate — so a backpressured client is told a truthful wait, not a
# constant.
RETRY_AFTER_QUEUE_FULL = 1
RETRY_AFTER_SHED = 2
# Hint ceiling: past this the number stops being advice and starts
# being an outage announcement a load balancer should make instead.
RETRY_AFTER_CAP = 30


class Overloaded(RuntimeError):
    """Load shed: admitting this request would push tracked in-flight
    bytes past the watermark. Transient — retry after the backlog
    drains (the frontend answers 503 + Retry-After)."""


class Draining(RuntimeError):
    """Admission is stopped: the tier is draining (SIGTERM). Accepted
    requests keep completing; new ones go to another instance."""


class _Group:
    """One forming coalesced group: same-compatibility-key members
    accumulating until the window expires, the group fills, or a
    deadline forces an early dispatch."""

    __slots__ = ("key", "reps", "filter_name", "shape", "members",
                 "flush_at")

    def __init__(self, key: tuple, reps: int, filter_name: Optional[str],
                 shape: Tuple[int, ...], flush_at: float) -> None:
        self.key = key
        self.reps = reps
        self.filter_name = filter_name
        self.shape = shape  # a member's true shape (warm-key derivation)
        self.members: List[GroupItem] = []
        self.flush_at = flush_at


class _Coalescer:
    """Continuous batching at the router: admitted requests sharing a
    compatibility key — (filter, shape bucket, channels, reps) — are
    held up to ``window_s`` so concurrent arrivals stack onto ONE
    replica submit. Not fixed ticks: a group dispatches the moment it
    fills (``max_batch``) or its window expires, late joiners append to
    a forming group, and a member that could not survive the window
    (deadline inside it) dispatches its group immediately.

    Full/urgent groups dispatch INLINE on the joining handler thread
    (no hand-off latency on the hot path); expiring windows are flushed
    by one daemon timer thread."""

    def __init__(self, router: "Router", window_s: float,
                 max_batch: int) -> None:
        self._router = router
        self._window = float(window_s)
        self._max_batch = max(1, int(max_batch))
        self._groups: Dict[tuple, _Group] = {}
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="tpu-stencil-torch-net-coalesce",
            daemon=True,
        )
        self._thread.start()

    def offer(self, key: tuple, item: GroupItem, reps: int,
              filter_name: Optional[str],
              shape: Tuple[int, ...]) -> None:
        """Join (or open) the forming group for ``key``. May dispatch
        inline when the join completes the group or the member's
        deadline cannot afford the window."""
        now = time.perf_counter()
        dispatch_now: Optional[_Group] = None
        with self._cond:
            if self._closed or self._router.draining:
                # Post-shutdown stragglers — and the admit-vs-drain
                # race (admitted a beat before begin_drain flushed the
                # forming table) — degrade to a group of one: exactly
                # the uncoalesced behavior, never a lost future.
                g = _Group(key, reps, filter_name, shape, now)
                g.members.append(item)
                dispatch_now = g
            else:
                g = self._groups.get(key)
                if g is None:
                    g = self._groups[key] = _Group(
                        key, reps, filter_name, shape,
                        now + self._window,
                    )
                    self._cond.notify()  # timer re-evaluates its sleep
                g.members.append(item)
                urgent = (item.t_deadline is not None
                          and item.t_deadline <= now + self._window)
                if len(g.members) >= self._max_batch or urgent:
                    self._groups.pop(key, None)
                    dispatch_now = g
        if dispatch_now is not None:
            self._router._place_group(dispatch_now)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed:
                    now = time.perf_counter()
                    due = [k for k, g in self._groups.items()
                           if g.flush_at <= now]
                    if due:
                        break
                    nxt = min(
                        (g.flush_at for g in self._groups.values()),
                        default=None,
                    )
                    self._cond.wait(
                        None if nxt is None else max(0.0, nxt - now)
                    )
                if self._closed:
                    return
                groups = [self._groups.pop(k) for k in due]
            for g in groups:
                # Off-timer dispatch: _place_group can block seconds
                # inside a crashed-replica restart, and the timer must
                # keep flushing OTHER keys' expiring windows meanwhile
                # (head-of-line blocking here would silently stretch
                # their members past the window). Window expiry is the
                # cold path — full groups dispatch inline on handler
                # threads — so a short-lived thread per flush is cheap.
                threading.Thread(
                    target=self._router._place_group, args=(g,),
                    name="tpu-stencil-torch-net-coalesce-flush", daemon=True,
                ).start()

    def flush_all(self) -> None:
        """Dispatch every forming group NOW (drain begins: admitted
        members must complete, not wait out a window nobody will
        extend)."""
        with self._cond:
            groups = list(self._groups.values())
            self._groups.clear()
        for g in groups:
            self._router._place_group(g)

    def stop(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        self.flush_all()


class Router:
    """Least-outstanding placement + the three admission layers."""

    def __init__(self, fleet: ReplicaFleet, registry: Registry,
                 max_inflight_bytes: int = 0,
                 quarantine=None,
                 coalesce_window_s: float = 0.0,
                 max_batch: int = 8,
                 bucket_edges: Optional[Tuple[int, ...]] = None,
                 default_filter: str = "gaussian",
                 cache=None) -> None:
        self._fleet = fleet
        self.registry = registry
        self._lock = threading.Lock()
        self._outstanding: Dict[int, int] = {
            i: 0 for i in range(len(fleet))
        }
        # QuarantineBoard (integrity.quarantine) or None:
        # witness verdicts land here and quarantined replicas drop out
        # of placement. The fleet's per-replica on_witness hooks feed
        # record_witness.
        self._quarantine = quarantine
        # ResultCache (cache) or None: the store must never
        # outlive distrust in a replica, so the router — the one place
        # every verdict and quarantine transition passes through —
        # drops a replica's entries the moment either lands.
        self._cache = cache
        if quarantine is not None:
            fleet.set_witness_sink(self.record_witness)
        self._inflight_bytes = 0
        self._max_inflight = int(max_inflight_bytes)
        self._draining = False
        m = registry
        self._m_requests = m.counter("requests_total")
        self._m_rejected = m.counter("rejected_total")
        self._m_shed = m.counter("shed_total")
        self._m_crash = m.counter("worker_crash_reroutes_total")
        self._m_inflight = m.gauge("inflight_bytes")
        self._m_bytes = m.histogram("request_bytes")
        m.gauge("draining").set(0)
        for i in self._outstanding:
            m.gauge(f"replica_depth_dev{i}").set(0)
        # Continuous batching: pre-created so a scrape of a quiet
        # coalescing tier still carries the schema keys.
        self._window_s = float(coalesce_window_s)
        self._max_batch = max(1, int(max_batch))
        self._edges = bucket_edges or bucketing.DEFAULT_EDGES
        self._default_filter = default_filter
        self._m_coal_requests = m.counter("coalesced_requests_total")
        self._m_coal_batches = m.counter("coalesced_batches_total")
        self._m_coal_size = m.histogram("coalesce_group_size")
        self._m_coal_delay = m.histogram("coalesce_queue_delay_seconds")
        self._coalescer: Optional[_Coalescer] = (
            _Coalescer(self, self._window_s, self._max_batch)
            if self._window_s > 0 else None
        )

    # -- drain gate ----------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Flip the admission gate (idempotent): every subsequent
        submit raises :class:`Draining`; in-flight requests are
        untouched. The ``draining`` gauge makes the flip scrapeable,
        and the first flip emits a tier-transition event line."""
        with self._lock:
            was = self._draining
            self._draining = True
        self.registry.gauge("draining").set(1)
        if self._coalescer is not None:
            # Forming groups hold ADMITTED requests: dispatch them now —
            # the drain contract completes every accepted request, and
            # nobody will join a window once admission stopped.
            self._coalescer.flush_all()
        if not was:
            from tpu_stencil_torch.obs import events as _obs_events

            _obs_events.emit("net.drain_begin", tier="net",
                             verdict="draining")

    # -- quarantine ----------------------------------------------------

    @property
    def quarantine(self):
        return self._quarantine

    def record_witness(self, idx: int, ok: bool) -> None:
        """One witness verdict from replica ``idx``'s engine (the
        fleet's on_witness hook lands here, on the replica's worker
        thread). A mismatch SYNCHRONOUSLY invalidates every cached
        result the replica produced — before the verdict even reaches
        the board, so no later lookup can serve a poisoned hit from a
        source this verdict just discredited."""
        if not ok and self._cache is not None:
            self._cache.invalidate_replica(idx, "witness_mismatch")
        if self._quarantine is not None:
            self._quarantine.record_witness(idx, ok)

    def quarantine_replica(self, idx: int, reason: str) -> bool:
        """Operator path (``POST /admin/quarantine``): out of placement
        now; probes (or an explicit clear) bring it back. The replica's
        cached results go with it — quarantine is distrust, and the
        store never outlives distrust in its source."""
        if self._quarantine is None:
            return False
        if self._cache is not None:
            self._cache.invalidate_replica(idx, "quarantine")
        return self._quarantine.quarantine(idx, reason)

    def release_replica(self, idx: int) -> bool:
        """Operator clear: back into placement without waiting for the
        probe streak."""
        if self._quarantine is None:
            return False
        return self._quarantine.release(idx, "operator")

    # -- placement -----------------------------------------------------

    def outstanding(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._outstanding)

    def submit(self, image: np.ndarray, reps: int,
               filter_name: Optional[str] = None,
               deadline_s: Optional[float] = None,
               owned: bool = False,
               on_consumed=None) -> Tuple[object, Optional[int]]:
        """Admit + place one request; returns ``(future, replica_idx)``.
        Raises :class:`Draining` / :class:`Overloaded` /
        :class:`QueueFull` (all replicas full) / ``ValueError``
        (validation, from the replica) — each mapped to its own status
        code by the HTTP frontend.

        With coalescing armed (``coalesce_window_s > 0``) the request
        may instead join a forming same-key group: ``replica_idx``
        comes back None, placement errors arrive through the FUTURE
        (same types), and the placed index is stamped onto the future
        as ``replica_idx`` at dispatch. ``owned``/``on_consumed`` are
        the zero-copy ingest contract, forwarded to
        :meth:`StencilServer.submit`."""
        image = np.asarray(image)
        # Request + response buffers both live for the request's
        # lifetime — the honest in-flight footprint is 2x the frame.
        nbytes = 2 * int(image.nbytes)
        with _obs_span("net.route", "net", bytes=int(image.nbytes)):
            with self._lock:
                if self._draining:
                    raise Draining(
                        "draining: admission stopped; retry against "
                        "another instance"
                    )
                if (self._max_inflight
                        and self._inflight_bytes + nbytes
                        > self._max_inflight):
                    self._m_shed.inc()
                    raise Overloaded(
                        f"shedding: {self._inflight_bytes + nbytes} "
                        f"in-flight bytes would exceed the "
                        f"{self._max_inflight} watermark; retry later"
                    )
                # Reserve under the SAME lock as the watermark check:
                # concurrent admits each see the others' reservation, so
                # the bound holds under load. Released below if no
                # replica accepts the request.
                self._inflight_bytes += nbytes
                if self._coalescer is None:
                    # Placement order is only this path's concern: a
                    # coalesced request places at GROUP dispatch, and
                    # sorting per admit would just stretch the lock.
                    order = sorted(
                        self._outstanding,
                        key=lambda i: (self._outstanding[i], i),
                    )
            if self._coalescer is not None:
                return self._submit_coalesced(
                    image, reps, filter_name, deadline_s, nbytes,
                    owned, on_consumed,
                ), None
            admitted = False
            try:
                # Quarantined replicas are out of placement like a
                # draining host — earned distrust routes around them.
                if self._quarantine is not None:
                    routable = [i for i in order
                                if not self._quarantine.is_quarantined(i)]
                    if not routable:
                        self.registry.counter(
                            "quarantine_unroutable_total"
                        ).inc()
                        raise Overloaded(
                            f"every replica ({len(order)}) is "
                            f"quarantined pending re-verification; "
                            f"retry after the background probes "
                            f"re-admit one"
                        )
                    order = routable
                last_exc: Optional[BaseException] = None
                for idx in order:
                    rep = self._fleet.replicas[idx]
                    try:
                        fut = rep.submit(image, reps, filter_name,
                                         deadline_s=deadline_s,
                                         owned=owned,
                                         on_consumed=on_consumed)
                    except (QueueFull, ServerClosed) as e:
                        # ServerClosed: the replica is mid-restart
                        # (fleet.restart drains the old engine before
                        # swapping in the new one) — try a sibling.
                        last_exc = e
                        continue
                    except WorkerCrashed:
                        # Dead engine: rebuild it on the same device and
                        # retry THIS request on the fresh replica (its
                        # queue is empty — the best placement there is).
                        self._m_crash.inc()
                        try:
                            self._fleet.restart(idx, timeout_s=1.0,
                                                expect=rep)
                            fut = self._fleet.replicas[idx].submit(
                                image, reps, filter_name,
                                deadline_s=deadline_s,
                                owned=owned, on_consumed=on_consumed,
                            )
                        except Exception as e:
                            last_exc = e
                            continue
                    self._track(idx, fut, nbytes)
                    # Once tracked, the done callback owns the release
                    # — nothing below may fail the accepted request (or
                    # the finally would double-release the bytes).
                    admitted = True
                    try:
                        self._fleet.prewarm_others(
                            idx, image, reps, filter_name
                        )
                    except Exception:
                        pass  # warming is best-effort
                    return fut, idx
                self._m_rejected.inc()
                if isinstance(last_exc, QueueFull):
                    raise last_exc
                raise QueueFull(
                    f"all {len(self._fleet)} replica queues at capacity"
                ) from last_exc
            finally:
                if not admitted:
                    with self._lock:
                        self._inflight_bytes -= nbytes
                        inflight = self._inflight_bytes
                    self._m_inflight.set(inflight)

    # -- continuous batching --------------------------------------------

    def _submit_coalesced(self, image: np.ndarray, reps: int,
                          filter_name: Optional[str],
                          deadline_s: Optional[float], nbytes: int,
                          owned: bool, on_consumed):
        """Admitted (bytes reserved) — join the forming group for this
        request's compatibility key. The in-flight reservation is tied
        to the FUTURE (released whenever it resolves, placed or not),
        so the watermark stays honest across the window."""
        h, w = image.shape[:2]
        channels = image.shape[2] if image.ndim == 3 else 1
        fname = filter_name or self._default_filter
        key = (fname, bucketing.bucket_shape(h, w, self._edges),
               channels, int(reps))
        fut: concurrent.futures.Future = concurrent.futures.Future()
        fut.add_done_callback(self._bytes_releaser(nbytes))
        now = time.perf_counter()
        ctx = _obs_ctx.current()
        if not owned:
            # The coalescer holds the frame across the window; an
            # unowned caller may reuse its buffer the moment we return.
            image = np.array(image, copy=True)
            if on_consumed is not None:
                on_consumed()
                on_consumed = None
        item = GroupItem(
            image=image, future=fut, t_submit=now,
            t_deadline=(now + deadline_s) if deadline_s else None,
            trace_id=ctx.trace_id if ctx is not None else "",
            span_id=ctx.span_id if ctx is not None else "",
            on_consumed=on_consumed,
            ledger=_obs_ledger.current(),
        )
        self._coalescer.offer(key, item, int(reps), fname,
                              tuple(image.shape))
        return fut

    def _bytes_releaser(self, nbytes: int):
        def _done(_fut) -> None:
            with self._lock:
                self._inflight_bytes -= nbytes
                inflight = self._inflight_bytes
            self._m_inflight.set(inflight)
        return _done

    def _place_group(self, group: _Group) -> None:
        """Place one formed group onto ONE replica (least outstanding,
        same order/quarantine/crash-recovery discipline as the
        uncoalesced path) via :meth:`StencilServer.submit_group` — one
        stacked launch for the whole group. Placement failures resolve
        every member's future typed (QueueFull / Overloaded /
        WorkerCrashed), never an exception out of the timer thread."""
        members = group.members
        if not members:
            return
        with _obs_span("net.coalesce_dispatch", "net",
                       group=len(members)):
            now = time.perf_counter()
            for m in members:
                self._m_coal_delay.observe(now - m.t_submit)
                if m.ledger is not None:
                    m.ledger.add_coalesce(now - m.t_submit)
            self._m_coal_size.observe(len(members))
            with self._lock:
                order = sorted(
                    self._outstanding,
                    key=lambda i: (self._outstanding[i], i),
                )
            try:
                if self._quarantine is not None:
                    routable = [i for i in order
                                if not self._quarantine.is_quarantined(i)]
                    if not routable:
                        self.registry.counter(
                            "quarantine_unroutable_total"
                        ).inc()
                        raise Overloaded(
                            f"every replica ({len(order)}) is "
                            f"quarantined pending re-verification; "
                            f"retry after the background probes "
                            f"re-admit one"
                        )
                    order = routable
                last_exc: Optional[BaseException] = None
                for idx in order:
                    rep = self._fleet.replicas[idx]
                    # Stamp the candidate index BEFORE the enqueue: the
                    # worker can resolve a fast group before this thread
                    # runs another statement, and the frontend reads
                    # replica_idx the moment fut.result() returns
                    # (X-Replica). A failed offer just re-stamps on the
                    # next candidate.
                    for m in members:
                        m.future.replica_idx = idx
                    try:
                        rep.submit_group(members, group.reps,
                                         group.filter_name)
                    except (QueueFull, ServerClosed) as e:
                        last_exc = e
                        continue
                    except WorkerCrashed:
                        self._m_crash.inc()
                        try:
                            self._fleet.restart(idx, timeout_s=1.0,
                                                expect=rep)
                            self._fleet.replicas[idx].submit_group(
                                members, group.reps, group.filter_name
                            )
                        except Exception as e:
                            last_exc = e
                            continue
                    self._m_coal_requests.inc(len(members))
                    self._m_coal_batches.inc()
                    for m in members:
                        self._track_member(idx, m.future, m.image)
                    try:
                        self._fleet.prewarm_others(
                            idx, np.zeros(group.shape, np.uint8),
                            group.reps, group.filter_name,
                        )
                    except Exception:
                        pass  # warming is best-effort
                    return
                self._m_rejected.inc(len(members))
                if not isinstance(last_exc, QueueFull):
                    last_exc = QueueFull(
                        f"all {len(self._fleet)} replica queues at "
                        f"capacity"
                    )
                raise last_exc
            except BaseException as e:
                for m in members:
                    if not m.future.done():
                        try:
                            m.future.set_exception(e)
                        except concurrent.futures.InvalidStateError:
                            pass  # client cancelled mid-placement

    def _track_member(self, idx: int, fut, image) -> None:
        """Placement accounting for one coalesced member: the bytes
        reservation already rides the future's admission callback, so
        only per-replica depth is tracked here."""
        self._m_requests.inc()
        self._m_bytes.observe(int(image.nbytes) if image is not None
                              else 0)
        with self._lock:
            self._outstanding[idx] += 1
            depth = self._outstanding[idx]
        self.registry.gauge(f"replica_depth_dev{idx}").set(depth)

        def _done(_fut) -> None:
            with self._lock:
                self._outstanding[idx] -= 1
                depth = self._outstanding[idx]
            self.registry.gauge(f"replica_depth_dev{idx}").set(depth)

        fut.add_done_callback(_done)

    def shutdown(self) -> None:
        """Stop the coalescer timer (flushing any forming groups) —
        called by the frontend's close."""
        if self._coalescer is not None:
            self._coalescer.stop()

    # -- backpressure hints --------------------------------------------

    def retry_terms(self) -> dict:
        """The Retry-After derivation's intermediate terms, named — the
        auditable form behind both :meth:`retry_after_s` and the
        ``/statusz`` ``retry_after`` block (an operator can check the
        opaque integer against the state that produced it), and the raw
        material ``/debug/capacity`` inverts into headroom."""
        with self._lock:
            depth = sum(self._outstanding.values())
        lat = self.registry.histogram("request_latency_seconds").snapshot()
        delay = self._m_coal_delay.snapshot()
        slots = max(1, len(self._fleet) * self._max_batch)
        mean = lat["mean"]
        return {
            "backlog": depth,
            "slots": slots,
            "coalesce_window_s": self._window_s,
            "coalesce_delay_p50_s": delay["p50"],
            "mean_request_latency_s": mean,
            "service_rate_rps": (slots / mean) if mean > 0 else None,
            "cap_s": RETRY_AFTER_CAP,
        }

    def retry_after_s(self, queue_full: bool = False) -> int:
        """The derived ``Retry-After`` hint: floor +
        coalescing window + the median observed coalesce queue delay +
        the time the current outstanding backlog needs to drain at the
        recently observed per-request service rate. A backpressured
        client is told a truthful wait for THIS tier's current state
        instead of a config constant; capped so the hint stays advice,
        not an outage banner."""
        base = RETRY_AFTER_QUEUE_FULL if queue_full else RETRY_AFTER_SHED
        try:
            t = self.retry_terms()
            wait = (t["coalesce_window_s"] + t["coalesce_delay_p50_s"]
                    + t["backlog"] * t["mean_request_latency_s"]
                    / t["slots"])
            return max(base, min(RETRY_AFTER_CAP, math.ceil(wait)))
        except Exception:
            return base  # a hint must never fail the error response

    def _track(self, idx: int, fut, nbytes: int) -> None:
        # nbytes was already reserved into _inflight_bytes at admission
        # (under the watermark-check lock); this only tracks placement.
        self._m_requests.inc()
        self._m_bytes.observe(nbytes // 2)  # the true request bytes
        with self._lock:
            self._outstanding[idx] += 1
            depth = self._outstanding[idx]
            inflight = self._inflight_bytes
        self.registry.gauge(f"replica_depth_dev{idx}").set(depth)
        self._m_inflight.set(inflight)

        def _done(_fut) -> None:
            with self._lock:
                self._outstanding[idx] -= 1
                self._inflight_bytes -= nbytes
                depth = self._outstanding[idx]
                inflight = self._inflight_bytes
            self.registry.gauge(f"replica_depth_dev{idx}").set(depth)
            self._m_inflight.set(inflight)

        fut.add_done_callback(_done)
