"""Synthetic load generator for the serving engine.

The port's counterpart of the JAX package's ``serve/loadgen.py``: the same
load models, report schema and verify modes.

Two standard load models, so throughput AND tail latency are measurable
(closed loops hide queueing delay, open loops hide service capacity —
you need both):

* **closed-loop**: ``concurrency`` workers, each submit-and-wait; offered
  load self-throttles to service rate. Measures capacity (throughput at
  full pipe) and in-service latency.
* **open-loop**: submissions arrive at a fixed ``rate`` regardless of
  completions — the "millions of users" shape. Overload surfaces as
  :class:`~tpu_stencil_torch.serve.engine.QueueFull` rejections (counted, never
  buffered), exercising the backpressure contract. ``rate_fps`` is the
  fixed-frame-rate spelling of the same loop (``--rate-fps``): the
  arrival law of a live video feed, reporting achieved vs requested
  frame rate — one loadgen drives stream and serve benchmarks alike.

The report pulls latency percentiles and rejection counts from the
server's metrics registry — the loadgen measures the server with the
server's own instruments, so the numbers in a report are the numbers an
operator would scrape in production.

Deterministic: shapes and pixels come from a seeded generator, so a run
is reproducible on the CPU and on the card.
"""

from __future__ import annotations

import concurrent.futures
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.obs import context as _obs_ctx
from tpu_stencil_torch.serve.engine import (
    QueueFull,
    ServerClosed,
    StencilServer,
)

DEFAULT_SHAPES: Tuple[Tuple[int, int], ...] = ((48, 36), (64, 48), (30, 50))

#: --verify golden only checks frames up to this many true pixels: the
#: independent NumPy golden runs per-pixel Python loops, so it is a
#: *small-frame* referee (the default loadgen shapes all qualify);
#: larger frames silently skip golden verification (crc still covers
#: the wire).
GOLDEN_MAX_PIXELS = 1 << 12

VERIFY_MODES = (None, "crc", "golden")


def _verify_failure_counter():
    from tpu_stencil_torch import obs

    return obs.registry().counter("integrity_verify_failures_total")


def _golden_for(image: np.ndarray, reps: int,
                filter_name: str) -> Optional[np.ndarray]:
    if image.shape[0] * image.shape[1] > GOLDEN_MAX_PIXELS:
        return None
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.ops import stencil

    return stencil.reference_stencil_numpy(
        image, filters.get_filter(filter_name), reps
    )


class HttpTarget:
    """Duck-typed :class:`StencilServer` stand-in that drives the
    network tier (:mod:`tpu_stencil_torch.net`, or the JAX package's)
    over ``POST /v1/blur`` — the same closed/open loops, ``--rate-fps``
    arrival law, and report schema measure a remote fleet instead of an in-process
    engine (``--http URL`` on the serve CLI).

    The status-code mapping inverts the frontend's: 429 (and a
    shedding 503) raise :class:`QueueFull` — transient backpressure
    the loops already know how to retry or shed, carrying the
    response's ``Retry-After`` hint as ``retry_after_s`` so the shared
    retry loop honors it as the backoff floor
    (``retry_after_honored_total`` in the report) — a draining 503
    raises :class:`ServerClosed` (permanent for that process: the
    drain gate never reopens, so re-offering is futile), and 504
    raises a typed ``DeadlineExceeded``. ``stats()`` scrapes
    ``/statusz`` and returns the tier's net-registry snapshot, whose
    ``rejected_total`` counter and ``request_latency_seconds``
    histogram are exactly the keys the report reads — so an HTTP
    report, like an in-process one, shows what an operator would
    scrape, not client-side guesses."""

    def __init__(self, url: str, max_workers: int = 32,
                 timeout_s: float = 300.0,
                 verify: Optional[str] = None,
                 tenant: Optional[str] = None) -> None:
        if verify not in VERIFY_MODES:
            raise ValueError(
                f"verify must be one of {VERIFY_MODES}, got {verify!r}"
            )
        self.url = url.rstrip("/")
        self._timeout = timeout_s
        # --tenant: stamp X-Tenant on every request so the tier's cost
        # ledger meters this run under one name; every 200's X-Cost-*
        # headers roll up into cost_snapshot() (the report's "cost"
        # key) — metering is drivable and assertable from the client.
        self.tenant = tenant
        self._cost_lock = threading.Lock()
        self._cost: Dict = {
            "responses": 0, "device_us": 0, "queue_us": 0,
            "by_source": {},
        }
        # --verify (docs/RESILIENCE.md "Integrity model"): any non-None
        # mode stamps each request with X-Content-Crc32c (exercising
        # the tier's ingest validation); "crc" additionally checks each
        # 200 body against its X-Result-Crc32c stamp — a mismatch (or a
        # missing stamp) counts integrity_verify_failures_total and
        # raises typed. "golden" is checked in run() (it needs the
        # request's pixels, which outlive this target).
        self.verify = verify
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="tpu-stencil-torch-httpgen",
        )

    def _post(self, image: np.ndarray, reps: int,
              filter_name: Optional[str],
              deadline_s: Optional[float]) -> np.ndarray:
        import urllib.error
        import urllib.request

        from tpu_stencil_torch.resilience.errors import DeadlineExceeded

        h, w = image.shape[:2]
        channels = image.shape[2] if image.ndim == 3 else 1
        payload = image.tobytes()
        # The CLIENT is the outermost tracing edge here: the bound
        # context (loadgen's per-request mint, or an embedder's) rides
        # the wire, so every hop of this request — and its flight-
        # recorder dump, if an anomaly fires — greps to one id.
        ctx = _obs_ctx.current() or _obs_ctx.fresh()
        headers = {
            "X-Width": str(w), "X-Height": str(h),
            "X-Reps": str(reps), "X-Channels": str(channels),
            "Content-Type": "application/octet-stream",
            **_obs_ctx.headers_for(ctx),
        }
        if self.verify is not None:
            headers[_checksum.CRC_HEADER] = str(_checksum.crc32c(payload))
        if self.tenant:
            headers["X-Tenant"] = self.tenant
        if filter_name:
            headers["X-Filter"] = filter_name
        if deadline_s:
            headers["X-Request-Timeout"] = repr(float(deadline_s))
        req = urllib.request.Request(
            self.url + "/v1/blur", data=payload,
            headers=headers, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                body = r.read()
                self._tally_cost(r.headers)
                if self.verify == "crc":
                    stamp = r.headers.get(_checksum.RESULT_HEADER)
                    # stamp_matches treats a missing OR malformed stamp
                    # as a failure (wire corruption hits header bytes
                    # as easily as the body) — counted, then typed.
                    if not _checksum.stamp_matches(stamp, body):
                        _verify_failure_counter().inc()
                        raise _checksum.ChecksumMismatch(
                            f"loadgen --verify crc (stamp {stamp!r})",
                            -1, _checksum.crc32c(body),
                        )
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace").strip()
            if e.code == 503 and "draining" in detail:
                # The drain gate is one-way for that process: re-offering
                # is futile, unlike a shed 503 that clears with the
                # backlog. ServerClosed classifies PERMANENT — fail fast,
                # same as the in-process spelling.
                raise ServerClosed(f"HTTP 503: {detail}") from None
            if e.code in (429, 503):
                exc = QueueFull(f"HTTP {e.code}: {detail}")
                # The shed/queue-full responses carry a Retry-After
                # hint; attach it so the shared retry loop honors it
                # as the backoff FLOOR (retry_call) instead of pure
                # exp-jitter — re-offering sooner than the server
                # asked just burns its admission path.
                ra = e.headers.get("Retry-After")
                if ra:
                    try:
                        exc.retry_after_s = float(ra)
                    except ValueError:
                        pass  # an unparseable hint is no hint
                raise exc from None
            if e.code == 504:
                raise DeadlineExceeded(f"HTTP 504: {detail}") from None
            # Anything else (400/404/413/500...) is deterministic: the
            # same request fails the same way, so raise the type the
            # retry classifier treats as PERMANENT — the closed loop
            # must fail fast, not re-offer for the give-up budget.
            raise ValueError(f"HTTP {e.code}: {detail}") from None
        return np.frombuffer(body, np.uint8).reshape(image.shape)

    def submit(self, image: np.ndarray, reps: int,
               filter_name: Optional[str] = None,
               deadline_s: Optional[float] = None,
               ) -> "concurrent.futures.Future":
        """Async POST. Unlike the in-process engine, backpressure
        cannot raise synchronously (the 429 arrives with the response),
        so :class:`QueueFull` surfaces from ``future.result()`` — the
        open loop treats both spellings as a shed."""
        img = np.array(image, copy=True)  # same buffer-reuse contract
        # Contextvars do not cross into the pool thread: capture the
        # caller's trace context here and re-bind it around the POST.
        ctx = _obs_ctx.current()

        def task() -> np.ndarray:
            with _obs_ctx.bind(ctx):
                return self._post(img, reps, filter_name, deadline_s)

        return self._pool.submit(task)

    def submit_retrying(self, image: np.ndarray, reps: int,
                        filter_name: Optional[str] = None,
                        deadline_s: Optional[float] = None,
                        policy=None,
                        give_up_after_s: Optional[float] = 300.0,
                        ) -> "concurrent.futures.Future":
        """:meth:`submit` re-offering on backpressure under the shared
        resilience retry policy — the closed-loop client shape, same
        contract as :meth:`StencilServer.submit_retrying` (same
        ``reoffer_call`` scaffolding; only the delays differ — an HTTP
        round-trip per offer deserves a longer backoff)."""
        from tpu_stencil_torch.resilience import retry as _retry

        img = np.array(image, copy=True)
        ctx = _obs_ctx.current()  # re-bound on the pool thread

        def task() -> np.ndarray:
            with _obs_ctx.bind(ctx):
                return _retry.reoffer_call(
                    lambda: self._post(img, reps, filter_name,
                                       deadline_s),
                    policy=policy, give_up_after_s=give_up_after_s,
                    base_delay=0.005, max_delay=0.1,
                    label="net.submit",
                )

        return self._pool.submit(task)

    def _tally_cost(self, rh) -> None:
        """Roll one 200's X-Cost-* headers into the run's cost tally
        (absent headers — an older tier — tally nothing)."""
        dev = rh.get("X-Cost-Device-Us")
        if dev is None:
            return
        try:
            d = int(dev)
            q = int(rh.get("X-Cost-Queue-Us") or 0)
        except ValueError:
            return  # a malformed header is no measurement
        src = rh.get("X-Cost-Source") or "unknown"
        with self._cost_lock:
            c = self._cost
            c["responses"] += 1
            c["device_us"] += d
            c["queue_us"] += q
            c["by_source"][src] = c["by_source"].get(src, 0) + 1

    def cost_snapshot(self) -> Dict:
        """The per-tenant cost rollup for the report: what this run's
        responses said they cost, in the server's own X-Cost-*
        vocabulary."""
        with self._cost_lock:
            return {
                "tenant": self.tenant or "anon",
                "responses": self._cost["responses"],
                "device_us": self._cost["device_us"],
                "device_seconds": self._cost["device_us"] / 1e6,
                "queue_us": self._cost["queue_us"],
                "by_source": dict(self._cost["by_source"]),
            }

    def stats(self) -> dict:
        """The tier's net-registry snapshot, scraped from /statusz."""
        import json as _json
        import urllib.request

        with urllib.request.urlopen(self.url + "/statusz",
                                    timeout=self._timeout) as r:
            return _json.loads(r.read())["net"]

    def close(self) -> None:
        self._pool.shutdown(wait=False)


def synth_requests(
    n: int, shapes: Sequence[Tuple[int, int]], channels: Sequence[int],
    seed: int, group: int = 1,
) -> List[np.ndarray]:
    """n seeded random uint8 images cycling over shapes x channels.
    ``group`` > 1 cycles per GROUP of that many consecutive requests
    instead of per request — the bursty arrival mode's guarantee that
    every request of one tick shares a shape (and so a coalescing
    compatibility key); pixels stay distinct per request."""
    rng = np.random.default_rng(seed)
    group = max(1, int(group))
    out = []
    for i in range(n):
        h, w = shapes[(i // group) % len(shapes)]
        ch = channels[(i // group) % len(channels)]
        shape = (h, w) if ch == 1 else (h, w, ch)
        out.append(rng.integers(0, 256, size=shape, dtype=np.uint8))
    return out


def zipf_requests(
    n: int, shapes: Sequence[Tuple[int, int]], channels: Sequence[int],
    seed: int, s: float, keys: int = 16,
) -> Tuple[List[np.ndarray], List[int]]:
    """``n`` requests drawn from a seeded pool of ``keys`` DISTINCT
    frames under a Zipf(``s``) popularity law — the repeat-heavy
    keyspace the result cache (``--result-cache-mb``) exists for. Key
    rank ``k`` (1-based) is drawn with probability ``k^-s / H``: at
    ``s=0`` every key is uniform (worst case for a cache), at ``s≈1``
    a handful of keys dominate (the web-traffic shape).

    The draw is a normalized power-law ``rng.choice`` over the finite
    pool, NOT ``numpy.random.zipf`` (which is unbounded and whose
    support would leak keys past the pool) — and it is fully seeded:
    the same ``(n, shapes, channels, seed, s, keys)`` replays the
    identical request sequence byte-for-byte, so a cache-hit-ratio
    measurement is reproducible.

    Returns ``(images, key_indices)``: the per-request frames (entries
    are shared references into the pool — callers copy on submit) and
    the drawn pool index per request, for hit-ratio accounting."""
    if not s >= 0:
        raise ValueError(f"zipf exponent must be >= 0, got {s!r}")
    if keys < 1:
        raise ValueError(f"zipf pool needs >= 1 key, got {keys}")
    pool = synth_requests(keys, shapes, channels, seed)
    ranks = np.arange(1, keys + 1, dtype=np.float64)
    weights = ranks ** -float(s)
    weights /= weights.sum()
    # A distinct stream from the pool's pixels: reseeding with the
    # same constant everywhere keeps the draw independent of pool
    # size (growing `keys` must not reshuffle which request slots
    # repeat).
    drng = np.random.default_rng(seed ^ 0x21BF)
    idx = drng.choice(keys, size=n, p=weights)
    return [pool[j] for j in idx], [int(j) for j in idx]


def run(
    server: StencilServer,
    mode: str = "closed",
    requests: int = 64,
    concurrency: int = 4,
    rate: float = 200.0,
    reps: int = 5,
    shapes: Sequence[Tuple[int, int]] = DEFAULT_SHAPES,
    channels: Sequence[int] = (3,),
    seed: int = 0,
    timeout: float = 300.0,
    rate_fps: Optional[float] = None,
    verify: Optional[str] = None,
    verify_filter: str = "gaussian",
    per_request: bool = False,
    burst: int = 1,
    zipf: Optional[float] = None,
    zipf_keys: int = 16,
    ramp: Optional[Tuple[float, float, float]] = None,
    ramp_phases: int = 4,
) -> Dict:
    """Drive ``server`` with synthetic load; return the report dict.

    ``server`` is a :class:`StencilServer` or any duck-typed stand-in
    with ``submit``/``submit_retrying``/``stats`` — in particular
    :class:`HttpTarget`, which points the same loops at the network
    tier (``--http URL``) with the same report schema.

    Report keys: ``mode``, ``requests``, ``completed``, ``rejected``,
    ``wall_seconds``, ``throughput_rps``, ``p50_s``, ``p99_s`` (request
    latency from the registry), plus the full ``stats`` snapshot.

    ``verify`` (``--verify {crc,golden}``, docs/RESILIENCE.md
    "Integrity model"): every request is stamped with its
    ``X-Content-Crc32c`` (HTTP targets), and each completed response is
    checked — ``crc`` against the tier's ``X-Result-Crc32c`` stamp
    (inside :class:`HttpTarget`), ``golden`` against the independent
    NumPy golden for frames up to :data:`GOLDEN_MAX_PIXELS`. Failures
    count ``verify_failures_total`` in the report; closed loops fail
    fast on the first one (zero tolerance), open loops count and keep
    offering.

    Every request is minted its own ``X-Trace-Id``
    (:mod:`tpu_stencil_torch.obs.context` — loadgen is the outermost tracing
    edge), so the report names the SLOWEST request's trace id
    (``slowest_trace_id`` / ``slowest_latency_s``): a p99 straggler
    greps straight to its ``/debug/trace`` tree and flight-recorder
    dump. ``per_request=True`` additionally returns one
    ``{i, trace_id, latency_s, ok}`` record per completed request
    (the ``--per-request`` CLI table).

    ``rate_fps``: the open-loop fixed-frame-rate mode (``--rate-fps``)
    — one frame is *due* every ``1/rate_fps`` seconds regardless of
    completions, the arrival law of a live video feed, so the same
    loadgen drives stream benchmarks and serve benchmarks. Forces
    ``mode='open'`` at that rate and adds ``requested_fps`` /
    ``offered_fps`` (submissions over the offered window, rejects
    included) / ``achieved_fps`` (completions over the wall) to the
    report — achieved < requested means the pipe, not the source, is
    the bottleneck.

    ``burst`` (``--burst N``): the bursty open-loop arrival mode — N
    simultaneous SAME-shape requests per tick (distinct payloads), tick
    gaps drawn from a seeded exponential (a Poisson arrival process at
    the same mean rate) instead of a metronome. This is the client-side
    shape that actually exercises cross-request coalescing at the
    network edge: a metronome at modest rates never offers two
    compatible requests inside one window. The report's p50/p99 sit
    next to achieved fps as always. ``burst=1`` (default) is exactly
    the pre-existing fixed-period open loop; burst > 1 requires an open
    loop (``mode='open'`` or ``rate_fps``).

    ``zipf`` (``--zipf S``): draw the request stream from a seeded pool
    of ``zipf_keys`` distinct frames under a Zipf(S) popularity law
    (:func:`zipf_requests`) instead of all-distinct frames — the
    repeat-heavy keyspace the network tier's result cache serves. The
    report gains ``zipf`` / ``zipf_keys`` / ``distinct_keys_offered``
    and ``cache_hit_ratio`` (``result_cache_hits_total`` over hits +
    misses from the target's own registry; ``None`` when the target
    has no result cache). Deterministic: the same seed replays the
    identical key sequence.

    ``ramp`` (``--ramp START_FPS:END_FPS:SECONDS``): the ramped
    open-loop profile — the total window is split into ``ramp_phases``
    equal phases, each a metronome at a frame rate stepped linearly
    from START to END, arrivals due on schedule regardless of
    completions (the same non-negotiable arrival law as ``rate_fps``,
    swept instead of held).  Forces ``mode='open'`` and overrides
    ``requests`` with the schedule's own count (≈ mean fps × seconds);
    the report gains ``ramp.phases`` — one ``{fps, seconds, requests,
    completed, achieved_fps, p99_s}`` row per phase, achieved fps and
    nearest-rank p99 both from the client-side per-request records so
    a resize mid-ramp shows up in exactly the phase it happened.
    Seeded like every other profile: the same ``(ramp, seed, shapes,
    channels)`` replays the identical request stream.  Mutually
    exclusive with ``rate_fps`` and ``burst > 1``.
    """
    ramp_plan: Optional[List[Tuple[float, float, int]]] = None
    if ramp is not None:
        start_fps, end_fps, ramp_secs = (float(v) for v in ramp)
        if not (start_fps > 0 and end_fps > 0 and ramp_secs > 0):
            raise ValueError(
                f"ramp needs positive START_FPS, END_FPS and SECONDS, "
                f"got {ramp!r}"
            )
        if rate_fps is not None:
            raise ValueError("ramp and rate_fps are exclusive arrival "
                             "laws (ramp sweeps the rate)")
        if burst > 1:
            raise ValueError("ramp is a metronome profile; burst > 1 "
                             "is not supported with it")
        if ramp_phases < 1:
            raise ValueError(
                f"ramp_phases must be >= 1, got {ramp_phases}"
            )
        mode = "open"
        nphase = int(ramp_phases)
        ramp_plan = []
        for p in range(nphase):
            frac = p / (nphase - 1) if nphase > 1 else 0.0
            fps_p = start_fps + (end_fps - start_fps) * frac
            dur_p = ramp_secs / nphase
            ramp_plan.append((fps_p, dur_p,
                              max(1, int(round(fps_p * dur_p)))))
        requests = sum(n for _, _, n in ramp_plan)
    if rate_fps is not None:
        if not rate_fps > 0:
            raise ValueError(f"rate_fps must be > 0, got {rate_fps!r}")
        mode, rate = "open", float(rate_fps)
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    if burst > 1 and mode != "open":
        raise ValueError(
            "burst is an open-loop arrival mode (use mode='open' or "
            "rate_fps)"
        )
    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be closed|open, got {mode!r}")
    if verify not in VERIFY_MODES:
        raise ValueError(
            f"verify must be one of {VERIFY_MODES}, got {verify!r}"
        )
    from tpu_stencil_torch import obs

    # Client-side counter delta: how many re-offers this run slept to
    # a server-provided Retry-After floor (retry_call honors the hint
    # the shed 503 / queue-full 429 responses carry).
    honored0 = obs.registry().counter(
        "resilience_retry_after_honored_total"
    ).value
    zipf_idx: Optional[List[int]] = None
    if zipf is not None:
        images, zipf_idx = zipf_requests(requests, shapes, channels,
                                         seed, zipf, zipf_keys)
    else:
        images = synth_requests(requests, shapes, channels, seed,
                                group=burst)
    completed = 0
    completed_lock = threading.Lock()
    # Per-request trace records ({i, trace_id, latency_s, ok}), always
    # collected (bounded by `requests`): the report names the slowest
    # trace even when the caller skipped the per-request table.
    records: List[Dict] = []
    records_lock = threading.Lock()

    def _record(i: int, trace_id: str, latency_s: float,
                ok: bool) -> None:
        with records_lock:
            records.append({"i": i, "trace_id": trace_id,
                            "latency_s": latency_s, "ok": ok})
    verify0 = _verify_failure_counter().value
    goldens: Dict[int, Optional[np.ndarray]] = {}
    goldens_lock = threading.Lock()

    def _check_golden(i: int, got) -> bool:
        """--verify golden: compare a completed result against the
        independent NumPy golden (memoized per request index; frames
        past GOLDEN_MAX_PIXELS skip). Returns False + counts on a
        mismatch."""
        if verify != "golden":
            return True
        # Zipf streams repeat pool keys: memoize the golden per POOL
        # key, not per request slot — K computations, not N.
        gi = zipf_idx[i] if zipf_idx is not None else i
        with goldens_lock:
            if gi not in goldens:
                goldens[gi] = _golden_for(images[i], reps,
                                          verify_filter)
            want = goldens[gi]
        if want is None or np.array_equal(np.asarray(got), want):
            return True
        _verify_failure_counter().inc()
        return False

    t_start = time.perf_counter()

    if mode == "closed":
        next_i = [0]
        errors: List[BaseException] = []

        def worker():
            nonlocal completed
            while True:
                with completed_lock:
                    if errors:
                        return  # a sibling failed; stop offering load
                    i = next_i[0]
                    if i >= requests:
                        return
                    next_i[0] = i + 1
                try:
                    # Closed loops retry backpressure (the client is
                    # synchronous): the shared resilience.retry policy
                    # classifies QueueFull transient and backs off with
                    # jitter, but never past the run deadline — a wedged
                    # server must not spin these workers forever while
                    # run() returns a plausible-looking partial report.
                    ctx = _obs_ctx.fresh()
                    t_req = time.perf_counter()
                    with _obs_ctx.bind(ctx):
                        fut = server.submit_retrying(
                            images[i], reps,
                            give_up_after_s=max(
                                0.001,
                                t_start + timeout - time.perf_counter()
                            ),
                        )
                    got = fut.result(timeout=timeout)
                    _record(i, ctx.trace_id,
                            time.perf_counter() - t_req, True)
                    if not _check_golden(i, got):
                        # Zero tolerance in the closed loop: one wrong
                        # result fails the run typed.
                        raise _checksum.WitnessMismatch(
                            f"loadgen --verify golden (request {i})"
                        )
                except BaseException as e:  # propagate via run(), never die silently
                    with completed_lock:
                        errors.append(e)
                    return
                with completed_lock:
                    completed += 1

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(max(1, concurrency))
        ]
        for t in threads:
            t.start()
        # One shared deadline across all joins — not timeout per thread.
        deadline = t_start + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        if errors:
            raise errors[0]
    else:  # open loop
        period = 1.0 / rate if rate > 0 else 0.0
        futures = []
        offered = 0

        def _offer(i: int) -> None:
            nonlocal offered
            offered += 1
            try:
                # The request index rides with the future: a shed
                # submission must not shift later results onto the
                # wrong golden.
                ctx = _obs_ctx.fresh()
                t_req = time.perf_counter()
                with _obs_ctx.bind(ctx):
                    f = server.submit(images[i], reps)
                f.add_done_callback(
                    # Completion time captured AT completion (the
                    # drain loop below reads results in submission
                    # order, so its clock would inflate latencies).
                    lambda fut, i=i, c=ctx, t=t_req: _record(
                        i, c.trace_id, time.perf_counter() - t,
                        fut.cancelled() is False
                        and fut.exception() is None,
                    )
                )
                futures.append((i, f))
            except QueueFull:
                pass  # counted by the server; open loops shed, not wait

        if ramp_plan is not None:
            # Ramp profile: each phase is its own metronome at the
            # stepped rate, due times anchored to the PHASE start so a
            # slow server never compresses the later (faster) phases.
            phase_bounds: List[Tuple[int, int]] = []
            phase_walls: List[float] = []
            i = 0
            for fps_p, _dur_p, n_p in ramp_plan:
                t_phase = time.perf_counter()
                period_p = 1.0 / fps_p
                for k in range(n_p):
                    delay = t_phase + k * period_p - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    _offer(i)
                    i += 1
                phase_walls.append(time.perf_counter() - t_phase)
                phase_bounds.append((i - n_p, i))
        else:
            # Bursty mode: ticks of `burst` back-to-back submissions,
            # the NEXT tick due an exponentially distributed gap later
            # (seeded: a run replays exactly). The mean inter-REQUEST
            # period is unchanged — a tick of N requests earns an
            # N-period mean gap — so `rate` keeps meaning
            # requests/second across modes.
            jrng = (np.random.default_rng(seed ^ 0xB5457)
                    if burst > 1 else None)
            t_due = t_start
            for i in range(requests):
                if i % burst == 0:
                    if i > 0:
                        t_due += (
                            jrng.exponential(period * burst)
                            if jrng is not None else period * burst
                        )
                    delay = t_due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                _offer(i)
        offer_wall = time.perf_counter() - t_start
        deadline = time.perf_counter() + timeout
        shed_in_flight = 0
        for i, f in futures:
            try:
                got = f.result(
                    timeout=max(0.0, deadline - time.perf_counter())
                )
                _check_golden(i, got)  # open loop: count, keep draining
            except _checksum.ChecksumMismatch:
                # HttpTarget's --verify crc failure, already counted:
                # the open loop measures corruption, it does not abort.
                pass
            except (QueueFull, ServerClosed):
                # The HTTP target's backpressure arrives WITH the
                # response (a 429/503 resolved into the future), not
                # synchronously at submit — same shed, later spelling.
                # ServerClosed is the draining tier's 503: the open
                # loop measures the rejection, it does not abort.
                # In-process futures never resolve to either, so this
                # is a no-op for the classic path.
                shed_in_flight += 1
        completed = len(futures) - shed_in_flight

    wall = time.perf_counter() - t_start
    stats = server.stats()
    # Absent only against a tier that served zero requests (every one
    # shed/rejected): report zeros, don't crash the overload report.
    rlat = stats["histograms"].get(
        "request_latency_seconds", {"p50": 0.0, "p99": 0.0}
    )
    report = {
        "mode": mode,
        "requests": requests,
        "completed": completed,
        "rejected": stats["counters"]["rejected_total"],
        "wall_seconds": wall,
        "throughput_rps": completed / wall if wall > 0 else 0.0,
        "p50_s": rlat["p50"],
        "p99_s": rlat["p99"],
        "retry_after_honored_total": obs.registry().counter(
            "resilience_retry_after_honored_total"
        ).value - honored0,
        "stats": stats,
    }
    with records_lock:
        done_recs = sorted(records, key=lambda r: r["i"])
    ok_recs = [r for r in done_recs if r["ok"]] or done_recs
    if ok_recs:
        # Name the straggler: its trace id greps straight to the
        # /debug/trace tree and any flight-recorder dump it triggered.
        slowest = max(ok_recs, key=lambda r: r["latency_s"])
        report["slowest_trace_id"] = slowest["trace_id"]
        report["slowest_latency_s"] = slowest["latency_s"]
    if burst > 1:
        report["burst"] = burst
    if zipf is not None:
        report["zipf"] = float(zipf)
        report["zipf_keys"] = int(zipf_keys)
        report["distinct_keys_offered"] = len(set(zipf_idx))
        # Hit ratio from the TARGET's own instruments, like every
        # other report number — None means the target runs no result
        # cache (the counters don't exist in its registry).
        hits = stats["counters"].get("result_cache_hits_total")
        misses = stats["counters"].get("result_cache_misses_total")
        if hits is None or misses is None:
            report["cache_hit_ratio"] = None
        else:
            total = hits + misses
            report["cache_hit_ratio"] = (
                hits / total if total > 0 else 0.0
            )
    cost_fn = getattr(server, "cost_snapshot", None)
    if cost_fn is not None:
        # HTTP targets: the run's cost rollup from the tier's X-Cost-*
        # response headers, keyed by the stamped tenant.
        report["cost"] = cost_fn()
    if per_request:
        report["per_request"] = done_recs
    if verify is not None:
        report["verify"] = verify
        report["verify_failures_total"] = (
            _verify_failure_counter().value - verify0
        )
    if rate_fps is not None:
        # Achieved-vs-requested: offered over the submission window
        # (could the source keep its schedule?) and achieved over the
        # whole wall (did the pipe keep up, drain included?). The n
        # offers span (n-1) inter-arrival periods, so the window gets
        # one period added back — n offers over a bare (n-1)-period
        # wall would read ~n/(n-1) above requested on perfect pacing.
        report["requested_fps"] = float(rate_fps)
        # (Bursty runs: the n offers span n/burst ticks, so one whole
        # tick gap is added back — same reasoning, coarser grain.)
        offer_window = offer_wall + period * burst
        report["offered_fps"] = (
            offered / offer_window if offer_window > 0 else 0.0
        )
        report["achieved_fps"] = completed / wall if wall > 0 else 0.0
    if ramp_plan is not None:
        # Per-phase achieved fps + p99 from the CLIENT-side records —
        # the phase a completion belongs to is the phase its request
        # was offered in, so a mid-ramp resize (the elastic acceptance
        # run) shows its cost in exactly the right row.
        phases_rep = []
        for (fps_p, dur_p, n_p), (lo, hi), wall_p in zip(
            ramp_plan, phase_bounds, phase_walls
        ):
            lats = sorted(
                r["latency_s"] for r in done_recs
                if lo <= r["i"] < hi and r["ok"]
            )
            p99 = (lats[max(0, math.ceil(0.99 * len(lats)) - 1)]
                   if lats else 0.0)
            phases_rep.append({
                "fps": fps_p, "seconds": dur_p, "requests": n_p,
                "completed": len(lats),
                "achieved_fps": len(lats) / wall_p if wall_p > 0
                else 0.0,
                "p99_s": p99,
            })
        report["ramp"] = {
            "start_fps": float(ramp[0]), "end_fps": float(ramp[1]),
            "seconds": float(ramp[2]), "phases": phases_rep,
        }
    return report
