"""In-process async micro-batching serving engine.

The port's counterpart of the JAX package's ``serve/engine.py``: the same
request-level contract, names, metric and span names.

* a **bounded request queue** with backpressure: ``submit`` on a full
  queue raises :class:`QueueFull` at once; it never buffers unboundedly,
  so peak memory is ``O(max_queue + pipeline_depth * max_batch)`` frames;
* a **micro-batching scheduler**: pending requests group by program key
  (filter, shape bucket, channels, dtype, backend, reps), so every batch
  reuses one cached bucket program (:mod:`.bucketing` pads H/W onto a
  ladder and the batch axis to a power of two);
* a **double-buffered worker loop**: the copies and the launches are
  asynchronous on the card, so the worker keeps up to ``pipeline_depth``
  batches in flight, and batch i+1's canvas assembly and H2D overlap
  batch i's compute.

The bucket route on the card. A batch lands once, in K1's frames layout
(each ``bucket_h``-row frame followed by ``halo`` zero gap rows,
:func:`~tpu_stencil_torch.ops.cuda_stencil.frames_stride`), from a pinned
host canvas, on a copy stream. Every rep is one single-rep K1 launch
(``cuda_stencil.stencil_fused``, ``fuse=1``) over two ping-pong buffers
on the server's compute stream, then the pad of each frame (rows at or
past its true height, columns at or past its true width) is set to 0 by
a multiply with a uint8 mask built once per batch on the device: the
JAX package's vmapped ``padded_step`` followed by its ``jnp.where``. Reps
are not fused through K1's ``fuse``: K1 re-zeroes only the rows outside
the image and the gap rows, never the pad columns inside a frame, which
a fused launch would leak into the image from its second rep on. Plans
the kernels do not take, and the ``xla``/``reference`` backends, run the
same loop with :func:`~tpu_stencil_torch.ops.lowering.padded_step` in
place of K1 (reported as ``xla``). The result goes back on a D2H stream
into the slot's pinned output, read only after that copy's event.

Requests of at least ``shard_min_pixels`` under a non-``off`` overlap run
the sharded runner (K3) at their true shape, through the process-shared
runner cache; a geometry the mesh refuses falls back to the bucket route.

Exactness: a request's cropped output is byte-identical to
``driver.run_job`` on the same (image, filter, reps).

The server runs on the card unless it is given the CPU (``device=``):
``device`` wins, else ``cfg.device_index`` (``cuda:<i>``), else
:func:`~tpu_stencil_torch.devices.resolve_device`. On the CPU the kernels'
plain versions run, because the tensors lie on the CPU.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpu_stencil_torch.config import ServeConfig
from tpu_stencil_torch.devices import resolve_device, resolve_devices
from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.integrity import witness as _witness_mod
from tpu_stencil_torch.obs import context as _obs_ctx
from tpu_stencil_torch.obs import flight as _obs_flight
from tpu_stencil_torch.obs import introspect as _introspect
from tpu_stencil_torch.obs import ledger as _obs_ledger
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.obs import tracing as _obs_tracing
from tpu_stencil_torch.ops import cuda_stencil as _cs
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.resilience import faults as _faults
from tpu_stencil_torch.resilience import retry as _retry
from tpu_stencil_torch.resilience.errors import DeadlineExceeded, WorkerCrashed
from tpu_stencil_torch.serve import bucketing
from tpu_stencil_torch.serve.metrics import Registry


def _resolve(fut: "concurrent.futures.Future", value=None,
             exc: Optional[BaseException] = None) -> bool:
    """Resolve ``fut`` with a result (or exception), tolerating a client
    cancel that lands between a ``done()`` check and the set (futures are
    never moved to RUNNING, so ``cancel()`` can win at any moment, and an
    unguarded set would spread InvalidStateError onto the whole batch).
    Returns True when the future took the value."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
        return True
    except concurrent.futures.InvalidStateError:
        return False  # cancelled (or already resolved); drop silently


def _batch_trace_ids(batch) -> tuple:
    """The distinct trace ids riding in a batch (span-arg form)."""
    return tuple(sorted({r.trace_id for r in batch if r.trace_id}))


class QueueFull(RuntimeError):
    """Backpressure signal: the bounded request queue is at capacity.
    Callers retry later or shed load; the server never buffers more."""


class ServerClosed(RuntimeError):
    """The server is shutting down (or closed); no new work is accepted."""


@dataclasses.dataclass
class Request:
    """One queued inference request (internal)."""

    req_id: int
    image: Optional[np.ndarray]  # uint8 (H, W) or (H, W, C); None once
    #                              consumed into a batch canvas
    reps: int
    filter_name: str
    key: tuple                 # program-cache key (sans batch bucket)
    bucket_hw: Tuple[int, int]
    future: concurrent.futures.Future
    t_submit: float
    # Absolute perf_counter deadline (None = none): expired requests fail
    # typed (DeadlineExceeded) at batch formation.
    t_deadline: Optional[float] = None
    # Routed through the sharded runner (overlap != "off" and at least
    # shard_min_pixels); the key carries a "sharded" marker.
    sharded: bool = False
    # The trace context bound on the submitting thread.
    trace_id: str = ""
    span_id: str = ""
    # The true frame shape, kept past consumption (retire crops by it).
    shape: Tuple[int, ...] = ()
    # Zero-copy ownership: called once, on the worker thread, the moment
    # the engine is done reading ``image``.
    on_consumed: Optional[object] = None
    # Witness input snapshot, picked at dispatch.
    witness_src: Optional[np.ndarray] = None
    # The RequestLedger bound on the submitting thread (cost attribution).
    ledger: Optional[_obs_ledger.RequestLedger] = None


@dataclasses.dataclass
class GroupItem:
    """One member of a router-coalesced group
    (:meth:`StencilServer.submit_group`): its future, deadline and trace
    identity were fixed at admission; the engine only wraps it into a
    :class:`Request`. ``t_deadline`` is an absolute ``perf_counter``
    instant."""

    image: np.ndarray
    future: concurrent.futures.Future
    t_submit: float
    t_deadline: Optional[float] = None
    trace_id: str = ""
    span_id: str = ""
    on_consumed: Optional[object] = None
    ledger: Optional[_obs_ledger.RequestLedger] = None


def pad_mask(valid_hw: torch.Tensor, stride: int, bucket_w: int,
             channels: int) -> torch.Tensor:
    """The (nb * stride, bucket_w * channels) uint8 mask of a batch canvas
    in the frames layout: 1 inside frame i's true (valid_h[i], valid_w[i])
    region, 0 in its pad and in the gap rows. ``valid_hw`` is the (2, nb)
    int32 tensor of true heights and widths, on the canvas's device."""
    nb = valid_hw.shape[1]
    dev = valid_hw.device
    rows = torch.arange(stride, device=dev, dtype=torch.int32).view(1, -1, 1)
    cols = torch.arange(bucket_w * channels, device=dev,
                        dtype=torch.int32).view(1, 1, -1)
    cols = torch.div(cols, channels, rounding_mode="floor")
    keep = ((rows < valid_hw[0].view(-1, 1, 1))
            & (cols < valid_hw[1].view(-1, 1, 1)))
    return keep.to(torch.uint8).view(nb * stride, bucket_w * channels)


class BucketProgram:
    """One program-cache entry: the rep loop of one key, over a batch
    canvas of ``nb`` frames of ``bucket_hw`` in the frames layout
    (``rows`` = nb * stride, ``wc`` = bucket_w * channels).

    ``run(x2, mask)`` applies ``reps`` steps: each one single-rep K1 launch
    (``backend == "pallas"``) or one torch-ops ``padded_step`` of the tall
    canvas, then the pad mask. ``x2`` is not written; reps 0 returns it."""

    def __init__(self, plan, backend: str, reps: int, nb: int,
                 bucket_hw: Tuple[int, int], channels: int) -> None:
        bh, bw = bucket_hw
        self.plan = plan
        self.backend = backend
        self.reps = int(reps)
        self.nb = nb
        self.bucket_hw = (bh, bw)
        self.channels = channels
        self.stride = _cs.frames_stride(plan, bh)
        self.rows = nb * self.stride
        self.wc = bw * channels
        # The tail gap doubles as bottom pad, as in iterate_frames.
        self.rows_real = self.rows - plan.halo
        self.frame = (self.stride, bh) if plan.halo else None

    def run(self, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.reps == 0:
            return x2
        if self.backend == "pallas":
            bufs = (torch.empty_like(x2), torch.empty_like(x2))
            cur = x2
            for i in range(self.reps):
                cur = _cs.stencil_fused(cur, self.plan, self.channels, 1,
                                        self.rows_real, self.frame,
                                        out=bufs[i % 2])
                cur.mul_(mask)
            return cur
        bw = self.bucket_hw[1]
        shape = ((self.rows, bw, self.channels) if self.channels > 1
                 else (self.rows, bw))
        cur = x2
        for _ in range(self.reps):
            cur = _lowering.padded_step(cur.view(shape), self.plan)
            cur = cur.reshape(self.rows, self.wc).mul_(mask)
        return cur

    def describe(self, filter_name: str, device: torch.device) -> dict:
        """What ``obs.introspect.capture`` records for this entry: the K1
        instance each rep launches (none on the torch-ops route), its
        library's build seconds, and the modelled bytes and operations of
        one rep of the batch."""
        from tpu_stencil_torch.ops import _build
        from tpu_stencil_torch.runtime import roofline

        bh, bw = self.bucket_hw
        n_elems = self.nb * bh * bw * self.channels
        kernels = []
        build_s = None
        if self.backend == "pallas" and self.reps:
            kernels = [_cs.describe_launch(
                "stencil_fused", self.plan, self.rows, self.wc,
                self.channels, fuse=1, device=device)]
            build_s = _build.build_seconds("stencil_fused")
        iops, fops = roofline.plan_ops(self.plan)
        return {
            "kernels": kernels,
            "build_seconds": build_s,
            "model_bytes_per_rep": roofline.analytic_bytes_per_rep(
                n_elems, self.backend, filter_name, bh, fuse=1),
            "model_ops_per_rep": n_elems * (iops + fops),
        }


class _ExecutableCache:
    """Program cache keyed on (filter, shape bucket incl. batch bucket,
    channels, dtype, backend, reps). A hit reuses a built
    :class:`BucketProgram`; a miss builds one.

    LRU-bounded: the key space is client-controlled (reps, and oversized
    shapes pad to ever-larger top-edge multiples)."""

    def __init__(self, registry: Registry, cap: int) -> None:
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._cap = cap
        # The worker owns the hot path; the lock exists for the warm-start
        # plane (keys/peek/seed from other threads).
        self._lock = threading.Lock()
        self._hits = registry.counter("cache_hits_total")
        self._misses = registry.counter("cache_misses_total")
        self._evictions = registry.counter("cache_evictions_total")

    def get(self, key, builder):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._hits.inc()
                self._entries.move_to_end(key)
        if entry is not None:
            with _obs_span("serve.cache_hit", "serve"):
                pass  # zero-duration marker: this dispatch reused a program
            return entry
        self._misses.inc()
        with _obs_span("serve.cache_miss", "serve"):
            entry = builder()
        with self._lock:
            self._entries[key] = entry
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)
                self._evictions.inc()
        return entry

    def keys(self) -> list:
        with self._lock:
            return list(self._entries.keys())

    def peek(self, key):
        """Read an entry without hit/miss accounting or LRU movement."""
        with self._lock:
            return self._entries.get(key)

    def seed(self, key, entry) -> bool:
        """Insert a pre-built entry without touching the hit/miss
        counters; an existing key is left alone; the LRU cap holds."""
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = entry
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)
                self._evictions.inc()
        return True

    def __len__(self) -> int:
        return len(self._entries)


class _Slot:
    """One arena slot: the host batch canvas in the frames layout
    (``canvas``: (nb, stride, bucket_w[, C]) numpy view), the true
    heights and widths (``valid``: (2, nb) int32 view), the host output
    the D2H lands in (``out``), and on a card the events of the slot's
    last H2D and last D2H. The host tensors are pinned on a card."""

    def __init__(self, shape: Tuple[int, ...], cuda: bool) -> None:
        nb = shape[0]
        n = int(np.prod(shape))
        self.canvas_t = torch.zeros(n, dtype=torch.uint8, pin_memory=cuda)
        self.valid_t = torch.zeros((2, nb), dtype=torch.int32,
                                   pin_memory=cuda)
        self.out_t = torch.empty(n, dtype=torch.uint8, pin_memory=cuda)
        self.nbytes = self.size(shape)
        self.canvas = self.canvas_t.numpy().reshape(shape)
        self.valid = self.valid_t.numpy()
        self.out = self.out_t.numpy().reshape(shape)
        self.h2d_event = torch.cuda.Event() if cuda else None
        self.d2h_event = torch.cuda.Event() if cuda else None

    @staticmethod
    def size(shape: Tuple[int, ...]) -> int:
        """Host bytes of a slot with canvas ``shape``: the canvas, the
        output and the (2, nb) int32 extents."""
        return 2 * int(np.prod(shape)) + 8 * shape[0]


def _host_ram_bytes() -> int:
    """The host's physical memory in bytes (64 GiB where the system does
    not say)."""
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (AttributeError, OSError, ValueError):
        return 64 << 30


class _CanvasArena:
    """Persistent per-bucket host canvases: the batch canvas of one
    (batch bucket, frames-layout geometry, channels) key is a small ring
    of reusable :class:`_Slot` s instead of a fresh allocation per
    dispatch, so steady-state serving makes no host canvas allocation.

    The ring holds ``pipeline_depth + 1`` slots per key: at most
    ``pipeline_depth`` batches are dispatched but not retired at any
    moment, so a slot cycles back only after its batch retired; on a card
    the dispatch also waits for the slot's last H2D event before it
    rewrites the canvas (the copy from pinned memory is asynchronous).

    Keys are LRU-bounded in number (``_KEY_CAP``) and in bytes
    (``byte_cap``, default a ``_RAM_SHARE``-th of the host's memory: on a
    card every slot is page-locked, and a request above the ladder's top
    edge makes a key as large as the request). A new slot that would pass
    the cap first evicts the least recently used other keys; a key whose
    ring alone passes it is still served. An evicted slot still in flight
    lives on until its batch retires. Only the worker thread acquires."""

    _KEY_CAP = 32
    _RAM_SHARE = 8

    def __init__(self, registry: Registry, ring: int, cuda: bool,
                 byte_cap: Optional[int] = None) -> None:
        self._rings: "collections.OrderedDict" = collections.OrderedDict()
        self._ring = max(2, int(ring))
        self._cuda = cuda
        self.byte_cap = (_host_ram_bytes() // self._RAM_SHARE
                         if byte_cap is None else int(byte_cap))
        self.bytes = 0  # held by the slots of the keys in the arena
        self._reuse = registry.counter("arena_canvas_reuse_total")
        self._alloc = registry.counter("arena_canvas_alloc_total")
        self._evict = registry.counter("arena_canvas_evictions_total")

    def _evict_lru(self) -> None:
        _key, entry = self._rings.popitem(last=False)
        self.bytes -= sum(s.nbytes for s in entry["slots"])
        self._evict.inc()

    def acquire(self, key: tuple, shape: Tuple[int, ...]) -> _Slot:
        """The next slot for ``key`` (canvas ``shape`` = (nb, stride,
        bucket_w[, C])). A fresh slot is zeroed; a reused one is dirty
        except for its gap rows, which no dispatch writes."""
        entry = self._rings.get(key)
        if entry is None:
            entry = self._rings[key] = {"slots": [], "next": 0}
            while len(self._rings) > self._KEY_CAP:
                self._evict_lru()
        else:
            self._rings.move_to_end(key)
        slots = entry["slots"]
        if len(slots) < self._ring:
            # ``key`` is the most recent: the LRU end holds other keys.
            need = _Slot.size(shape)
            while self.bytes + need > self.byte_cap and len(self._rings) > 1:
                self._evict_lru()
            slot = _Slot(shape, self._cuda)
            slots.append(slot)
            self.bytes += slot.nbytes
            self._alloc.inc()
            return slot
        slot = slots[entry["next"]]
        entry["next"] = (entry["next"] + 1) % len(slots)
        self._reuse.inc()
        if slot.h2d_event is not None:
            slot.h2d_event.synchronize()
        return slot


class _MemorySampler:
    """Background device-memory telemetry: a daemon thread samples the
    CUDA allocator every ``interval_s`` into the server registry as
    ``device_*`` gauges. On the CPU the first probe returns None and no
    thread starts. Started from the worker thread."""

    def __init__(self, registry: Registry, interval_s: float,
                 device: Optional[torch.device] = None) -> None:
        self._registry = registry
        self._interval = interval_s
        self._device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> bool:
        if self._interval <= 0 or self._thread is not None:
            return False
        if _introspect.record_memory_gauges(self._registry,
                                            self._device) is None:
            return False
        self._thread = threading.Thread(
            target=self._loop, name="tpu-stencil-torch-memsample",
            daemon=True,
        )
        self._thread.start()
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            _introspect.record_memory_gauges(self._registry, self._device)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


# Per-server bound on introspected cache keys (the key space is
# client-controlled); past it, new keys go uncaptured.
_INTROSPECT_KEY_CAP = 512

_server_serials = itertools.count()

_last_server_ref = None  # weakref to the most recently constructed server


def _as_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class StencilServer:
    """The serving engine. Construct, ``submit`` from any thread, read
    ``stats()``, ``close()`` when done (also a context manager).

    >>> server = StencilServer(ServeConfig(max_queue=64, max_batch=8))
    >>> out = server.submit(img_u8, reps=40).result()   # on the card

    ``device``: where the bucket route runs (see the module docstring for
    the default). ``devices``: the devices of the sharded route's mesh
    (default: the CPU once for a CPU server, else every visible card); a
    list may name one device several times, as the sharded runner's
    mesh may."""

    def __init__(self, cfg: Optional[ServeConfig] = None,
                 start: bool = True,
                 device: Optional[Union[str, torch.device]] = None,
                 devices: Optional[Sequence] = None) -> None:
        self.cfg = cfg or ServeConfig()
        if self.cfg.boundary != "zero":
            # Bucket padding re-zeroes the pad every rep, which keeps ZERO
            # semantics at the true edge; periodic would wrap at the
            # canvas edge and silently return wrong pixels.
            raise NotImplementedError(
                "serve supports boundary='zero' only; periodic requests "
                "would wrap at the padded bucket edge, not the image edge"
            )
        if device is not None:
            self.device = _as_device(device)
        elif self.cfg.device_index is not None:
            self.device = torch.device("cuda", self.cfg.device_index)
        else:
            self.device = resolve_device()
        self._cuda = self.device.type == "cuda"
        self._mesh_devices = (None if devices is None
                              else [torch.device(d) for d in devices])
        self.registry = Registry()
        self._cache = _ExecutableCache(self.registry,
                                       self.cfg.max_executables)
        self._arena = _CanvasArena(self.registry,
                                   self.cfg.pipeline_depth + 1, self._cuda)
        self._models: Dict[str, object] = {}
        self._edges = self.cfg.bucket_edges or bucketing.DEFAULT_EDGES
        self._pending: "collections.deque[Request]" = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closing = False
        self._ids = itertools.count()
        self._worker: Optional[threading.Thread] = None
        # Worker-death propagation: the exception that killed the worker;
        # every queued and in-flight future then fails with WorkerCrashed.
        self._crashed: Optional[BaseException] = None
        self._inflight_batches: "collections.deque" = collections.deque()
        self._current_batch: List[Request] = []
        # Work the worker thread runs between batches, on its streams
        # (the warm-start plane's warm runs): (callable, future) pairs.
        self._control: "collections.deque" = collections.deque()
        # The card's streams, made on the worker thread at its start.
        self._stream = self._copy_stream = self._d2h_stream = None
        # Fault-injection sites resolved once (with no fault armed, every
        # per-batch check is a branch on a captured None).
        self._fault_h2d = _faults.site("h2d")
        self._fault_d2h = _faults.site("d2h")
        self._fault_compute = _faults.site("compute")
        self._fault_compile = _faults.site("compile")
        self._fault_corrupt_result = _faults.site("integrity.corrupt_result")
        self._witness = (
            _witness_mod.WitnessSampler(self.cfg.witness_rate,
                                        seed=self.cfg.witness_seed)
            if self.cfg.witness_rate > 0 else None
        )
        self.on_witness = None  # callable(ok: bool), set by a fleet
        self._serial = next(_server_serials)
        self._introspected: set = set()
        self._memsampler = _MemorySampler(
            self.registry, self.cfg.mem_sample_interval_s, self.device
        )
        m = self.registry
        self._m_requests = m.counter("requests_total")
        self._m_rejected = m.counter("rejected_total")
        self._m_completed = m.counter("completed_total")
        self._m_failed = m.counter("failed_total")
        self._m_batches = m.counter("batches_total")
        self._m_padded = m.counter("padded_pixels_total")
        self._m_real = m.counter("image_pixels_total")
        self._m_depth = m.gauge("queue_depth")
        self._m_inflight = m.gauge("inflight_batches")
        self._m_deadline = m.counter("deadline_expired_total")
        self._m_crashes = m.counter("resilience_worker_crashes_total")
        self._m_witness_total = m.counter("integrity_witness_total")
        self._m_witness_bad = m.counter("integrity_witness_mismatch_total")
        self._m_sharded = m.counter("sharded_requests_total")
        self._m_sharded_batches = m.counter("sharded_batches_total")
        # Cost attribution: every retired batch's dispatch wall splits
        # into goodput (request-kind work) or overhead (warm submits);
        # witness re-executions add overhead, sub-counted.
        self._m_goodput = m.counter("goodput_device_seconds_total")
        self._m_overhead = m.counter("overhead_device_seconds_total")
        self._m_witness_s = m.counter("witness_device_seconds_total")
        self._m_h2d_bytes = m.counter("h2d_bytes_total")
        self._m_d2h_bytes = m.counter("d2h_bytes_total")
        self._m_qwait = m.histogram("queue_wait_seconds")
        self._m_blat = m.histogram("batch_latency_seconds")
        self._m_rlat = m.histogram("request_latency_seconds")
        self._m_bsize = m.histogram("batch_size")
        self._m_gbps = m.histogram("batch_hbm_gbps")
        # The configured overlap schedule, the sharded runner's coding
        # (off=0, split=1, fused-split=2, edge=3) plus AUTO_CODE for auto.
        from tpu_stencil_torch.parallel import overlap as _overlap_mod

        m.gauge("overlap_mode").set(
            _overlap_mod.MODE_CODES.get(self.cfg.overlap,
                                        _overlap_mod.AUTO_CODE))
        global _last_server_ref
        _last_server_ref = weakref.ref(self)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        """Start the worker loop (idempotent). A pinned ``device_index``
        is range-checked here, so a bad index is an immediate ValueError
        instead of a WorkerCrashed on the first batch."""
        if self.cfg.device_index is not None:
            n = torch.cuda.device_count()
            if self.cfg.device_index >= n:
                raise ValueError(
                    f"device_index {self.cfg.device_index} out of "
                    f"range: {n} CUDA device(s)"
                )
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name="tpu-stencil-torch-serve",
                daemon=True,
            )
            self._worker.start()

    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting work, drain the queue, join the worker.

        True when the server drained (the worker joined, or there was no
        live worker); False when the join timed out and the worker was
        abandoned still running, counted in
        ``serve_close_abandoned_total``."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        drained = True
        if self._worker is not None and self._worker.is_alive():
            self._worker.join(timeout)
            if self._worker.is_alive():
                drained = False
                self.registry.counter("serve_close_abandoned_total").inc()
        self._memsampler.stop()
        # No live worker to drain: a queued future must never hang. An
        # abandoned worker keeps ownership of its queue.
        if drained:
            with self._lock:
                leftovers = list(self._pending)
                self._pending.clear()
                self._m_depth.set(0)
            for r in leftovers:
                if not r.future.done():
                    _resolve(r.future, exc=ServerClosed("server closed"))
        return drained

    def __enter__(self) -> "StencilServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ----------------------------------------------------

    def _route(self, h: int, w: int, channels: int, fname: str,
               reps: int) -> Tuple[bool, Tuple[int, int], tuple]:
        """(sharded, bucket_hw, key) of one request."""
        sharded = (self.cfg.overlap != "off"
                   and h * w >= self.cfg.shard_min_pixels)
        if sharded:
            return True, (h, w), (fname, (h, w), channels, "uint8",
                                  self.cfg.backend, int(reps), "sharded")
        bucket_hw = bucketing.bucket_shape(h, w, self._edges)
        return False, bucket_hw, (fname, bucket_hw, channels, "uint8",
                                  self.cfg.backend, int(reps))

    def submit(self, image: np.ndarray, reps: int,
               filter_name: Optional[str] = None,
               deadline_s: Optional[float] = None,
               owned: bool = False,
               on_consumed=None,
               ) -> "concurrent.futures.Future":
        """Enqueue one request; returns a Future resolving to the blurred
        uint8 array (same shape as ``image``). Raises :class:`QueueFull`
        when the queue is at capacity, :class:`ServerClosed` after
        ``close()``, and ``WorkerCrashed`` when the worker thread died.
        ``deadline_s`` (default ``cfg.request_timeout_s``; 0/None = none)
        bounds the wait in the queue.

        ``owned=True`` is the zero-copy ingest contract: the caller leaves
        the buffer alone until ``on_consumed`` fires (once, on the worker
        thread, after the pixels were copied into the batch canvas), so
        the defensive copy is skipped. With ``owned=False`` the engine
        copies and fires ``on_consumed``, if any, right after the copy."""
        image = np.asarray(image)  # no copy yet: validate + gate first
        if image.dtype != np.uint8:
            raise ValueError(f"image must be uint8, got {image.dtype}")
        if image.ndim not in (2, 3):
            raise ValueError(
                f"image must be (H, W) or (H, W, C), got shape {image.shape}"
            )
        if reps < 0:
            raise ValueError(f"reps must be >= 0, got {reps}")
        # Fast-path reject before the defensive copy: a shed request must
        # not pay an O(H*W*C) copy. Repeated under the lock at append.
        with self._cond:
            self._gate_locked()
        h, w = image.shape[:2]
        fname = filter_name or self.cfg.filter_name
        channels = image.shape[2] if image.ndim == 3 else 1
        sharded, bucket_hw, key = self._route(h, w, channels, fname, reps)
        # The sharded route stages through the runner's own put: keep an
        # engine copy there, as for unowned buffers.
        if not owned or sharded:
            image = np.array(image, copy=True)
            if on_consumed is not None:
                on_consumed()  # the caller's buffer is free after the copy
                on_consumed = None
        if deadline_s is None:
            deadline_s = self.cfg.request_timeout_s
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        now = time.perf_counter()
        ctx = _obs_ctx.current()
        req = Request(
            req_id=next(self._ids), image=image, reps=int(reps),
            filter_name=fname, key=key, bucket_hw=bucket_hw, future=fut,
            t_submit=now,
            t_deadline=(now + deadline_s) if deadline_s else None,
            sharded=sharded,
            trace_id=ctx.trace_id if ctx is not None else "",
            span_id=ctx.span_id if ctx is not None else "",
            shape=tuple(image.shape),
            on_consumed=on_consumed,
            ledger=_obs_ledger.current(),
        )
        with _obs_span("serve.enqueue", "serve", req_id=req.req_id):
            with self._cond:
                self._gate_locked()  # authoritative: at append time
                self._pending.append(req)
                self._m_requests.inc()
                self._m_depth.set(len(self._pending))
                self._cond.notify()
        return fut

    def submit_retrying(
        self, image: np.ndarray, reps: int,
        filter_name: Optional[str] = None,
        deadline_s: Optional[float] = None,
        policy: Optional["_retry.RetryPolicy"] = None,
        give_up_after_s: Optional[float] = 300.0,
    ) -> "concurrent.futures.Future":
        """:meth:`submit` under the shared re-offer policy
        (:func:`~tpu_stencil_torch.resilience.retry.reoffer_call`):
        :class:`QueueFull` backs off and re-offers; ``ServerClosed``,
        ``WorkerCrashed`` and validation errors raise at once.
        ``give_up_after_s`` bounds the whole retry window."""
        return _retry.reoffer_call(
            lambda: self.submit(image, reps, filter_name,
                                deadline_s=deadline_s),
            policy=policy, give_up_after_s=give_up_after_s,
            label="serve.submit",
        )

    def submit_group(self, items: List[GroupItem], reps: int,
                     filter_name: Optional[str] = None) -> None:
        """Enqueue a coalesced group under one lock acquisition: all
        members enter the queue atomically, so a same-key group of
        K <= max_batch rides one batch, one program, one H2D.

        Admission is all-or-nothing: if the queue cannot take the whole
        group, :class:`QueueFull` raises and no member entered. Member
        images are owned (no defensive copies, the ``submit(owned=True)``
        contract)."""
        if reps < 0:
            raise ValueError(f"reps must be >= 0, got {reps}")
        fname = filter_name or self.cfg.filter_name
        with self._cond:
            self._gate_locked()
        reqs: List[Request] = []
        for it in items:
            image = np.asarray(it.image)
            if image.dtype != np.uint8 or image.ndim not in (2, 3):
                raise ValueError(
                    f"group member must be a uint8 (H, W[, C]) frame, "
                    f"got {image.dtype} {image.shape}"
                )
            h, w = image.shape[:2]
            channels = image.shape[2] if image.ndim == 3 else 1
            on_consumed = it.on_consumed
            sharded, bucket_hw, key = self._route(h, w, channels, fname,
                                                  reps)
            if sharded:
                image = np.array(image, copy=True)
                if on_consumed is not None:
                    on_consumed()
                    on_consumed = None
            reqs.append(Request(
                req_id=-1, image=image, reps=int(reps),
                filter_name=fname, key=key, bucket_hw=bucket_hw,
                future=it.future, t_submit=it.t_submit,
                t_deadline=it.t_deadline, sharded=sharded,
                trace_id=it.trace_id, span_id=it.span_id,
                shape=tuple(image.shape), on_consumed=on_consumed,
                ledger=it.ledger,
            ))
        with _obs_span("serve.enqueue_group", "serve", group=len(reqs)):
            with self._cond:
                self._gate_locked()  # authoritative: at append time
                if len(self._pending) + len(reqs) > self.cfg.max_queue:
                    self._m_rejected.inc(len(reqs))
                    raise QueueFull(
                        f"queue cannot take a group of {len(reqs)} "
                        f"({len(self._pending)}/{self.cfg.max_queue} "
                        f"pending); retry later"
                    )
                for r in reqs:
                    r.req_id = next(self._ids)
                    self._pending.append(r)
                self._m_requests.inc(len(reqs))
                self._m_depth.set(len(self._pending))
                self._cond.notify()

    def _gate_locked(self) -> None:
        """Admission gate (caller holds the lock): raises
        ``WorkerCrashed`` / :class:`ServerClosed` / :class:`QueueFull`
        (counted) when the request must not enter."""
        if self._crashed is not None:
            raise WorkerCrashed(
                f"serve worker thread died "
                f"({type(self._crashed).__name__}: {self._crashed}); "
                "construct a new server"
            )
        if self._closing:
            raise ServerClosed("server is closed")
        if len(self._pending) >= self.cfg.max_queue:
            self._m_rejected.inc()
            raise QueueFull(
                f"queue full ({self.cfg.max_queue} pending); retry later"
            )

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        """Snapshot of the metrics registry (the JAX package's schema)."""
        from tpu_stencil_torch.parallel import sharded as _sharded

        snap = self.registry.snapshot()
        snap["executables_cached"] = len(self._cache)
        snap["introspected_executables"] = len(self._introspected)
        snap["sharded_runners_cached"] = _sharded.runner_cache_len()
        return snap

    def introspection(self) -> List[dict]:
        """This server's per-cache-entry records (the ``serve.bucket``
        site's captures), filtered by the server's serial."""
        return [r for r in _introspect.records()
                if r.get("site") == "serve.bucket"
                and r.get("meta", {}).get("server") == self._serial]

    # -- warm-start plane ----------------------------------------------

    def warm_keys(self) -> list:
        """This server's program-cache keys, for an exporter."""
        return self._cache.keys()

    def warm_entry(self, key):
        """One cached program, without hit/miss/LRU side effects."""
        return self._cache.peek(key)

    def warm_seed(self, key, entry) -> bool:
        """Seed one pre-built program (counter-silent)."""
        return self._cache.seed(key, entry)

    def warm_run(self, key) -> BucketProgram:
        """Build the program of ``key`` (a shippable program-cache key,
        :func:`~tpu_stencil_torch.ctrl.warmstart._key_geometry`), take its
        arena slot and run one batch of zeros through it on this server's
        device, on the worker thread's streams when the worker runs; the
        program-cache and request counters do not move. Returns the
        program, for :meth:`warm_seed`. A kernel that cannot build raises
        (``KernelBuildError``)."""
        fname, bucket_hw, channels, _dtype, _backend, reps, nb = key

        def run() -> BucketProgram:
            prog = self._build_program(fname, tuple(bucket_hw), channels,
                                       reps, nb)
            slot = self._slot_for(prog)
            slot.canvas_t.zero_()
            slot.valid_t.zero_()
            self._launch(prog, slot)
            if slot.d2h_event is not None:
                slot.d2h_event.synchronize()
            return prog

        return self._on_worker(run)

    def export_warm_state(self) -> dict:
        """This server's warm-state envelope for a joining host: its
        program-cache keys (:mod:`tpu_stencil_torch.ctrl.warmstart`)."""
        from tpu_stencil_torch.ctrl import warmstart as _warmstart

        return _warmstart.export_server(self)

    def import_warm_state(self, payload) -> dict:
        """Import a warm-state envelope: each entry is rebuilt from this
        checkout's kernel sources and run once before it is seeded; every
        unusable entry degrades to a cold build, typed and counted
        (``ctrl_warmstart_fallbacks_total``), never an error."""
        from tpu_stencil_torch.ctrl import warmstart as _warmstart

        return _warmstart.import_server(self, payload)

    def _on_worker(self, fn):
        """``fn()`` run on the worker thread between batches (its device
        streams), its result or exception returned here; run on this
        thread when no worker runs."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        with self._cond:
            worker = self._worker
            queued = (worker is not None and worker.is_alive()
                      and worker is not threading.current_thread())
            if queued:
                if self._crashed is not None or self._closing:
                    raise ServerClosed("server is closed or crashed")
                self._control.append((fn, fut))
                self._cond.notify_all()
        if not queued:
            if self._cuda and self._stream is None:
                self._setup_streams(make_current=False)
            return fn()
        return fut.result()

    # -- scheduler / worker --------------------------------------------

    def _take_batch_locked(self) -> Tuple[List[Request], List[Request]]:
        """Pop the next micro-batch: the oldest request's key (FIFO
        fairness), joined by up to ``max_batch - 1`` same-key followers.
        Returns ``(batch, expired)``; expired requests are failed by the
        caller outside the lock."""
        if not self._pending:
            return [], []
        expired: List[Request] = []
        with _obs_span("serve.batch_form", "serve"):
            now = time.perf_counter()
            key = None
            batch: List[Request] = []
            kept: "collections.deque[Request]" = collections.deque()
            while self._pending:
                r = self._pending.popleft()
                if r.t_deadline is not None and now > r.t_deadline:
                    expired.append(r)
                    continue
                if key is None:
                    key = r.key
                if r.key == key and len(batch) < self.cfg.max_batch:
                    batch.append(r)
                else:
                    kept.append(r)
            self._pending = kept
            self._m_depth.set(len(self._pending))
        return batch, expired

    def _model_for(self, filter_name: str):
        from tpu_stencil_torch.models.blur import IteratedConv2D

        model = self._models.get(filter_name)
        if model is None:
            model = self._models[filter_name] = IteratedConv2D(
                filter_name, backend=self.cfg.backend,
                boundary=self.cfg.boundary, device=self.device,
            )
        return model

    def _sharded_devices(self) -> List[torch.device]:
        if self._mesh_devices is not None:
            return self._mesh_devices
        return [self.device] if not self._cuda else resolve_devices()

    def _sharded_runner_for(self, filter_name: str, hw: Tuple[int, int],
                            channels: int):
        """The cached sharded runner for one true (filter, H, W,
        channels), keyed without reps, from the process-shared runner
        cache (serve and the sharded stream share one population). None
        when the mesh cannot serve the geometry (the caller falls back to
        the bucket route; the refusal is cached)."""
        from tpu_stencil_torch.parallel import sharded as _sharded

        def wrapper(build):
            with _obs_span("serve.sharded_runner_build", "serve",
                           shape=hw, channels=channels):
                # The compile fault site covers a mesh build too.
                if self._fault_compile is not None:
                    self._fault_compile()
                return build()

        return _sharded.shared_runner(
            self._model_for(filter_name), hw, channels,
            devices=self._sharded_devices(), overlap=self.cfg.overlap,
            registry=self.registry, build_wrapper=wrapper,
        )

    def _account_devices(self, n_devices: int, total_bytes: int,
                         n_requests: int, first: int = 0) -> None:
        """Per-device admission accounting: ``device_requests_total_dev<i>``
        and ``device_bytes_dispatched_total_dev<i>`` for every device a
        dispatch lands on (a sharded request: every mesh position; a
        bucket batch: the server's device)."""
        per = total_bytes // max(1, n_devices)
        for i in range(first, first + n_devices):
            self.registry.counter(
                f"device_requests_total_dev{i}"
            ).inc(n_requests)
            self.registry.counter(
                f"device_bytes_dispatched_total_dev{i}"
            ).inc(per)

    def _dispatch(self, batch: List[Request]):
        """Assemble and launch one batch (asynchronous on a card); returns
        the retire state (batch, result, meta, t_start)."""
        with _obs_span("serve.execute", "serve", batch=len(batch),
                       reps=batch[0].reps,
                       sharded=batch[0].sharded,
                       trace_ids=_batch_trace_ids(batch)):
            if batch[0].sharded:
                return self._dispatch_sharded(batch)
            return self._dispatch_inner(batch)

    def _consume(self, r: Request) -> None:
        """The engine is done reading ``r.image``: snapshot the witness
        input if the sampler picks this request, release the buffer to
        its owner, drop the reference. Worker thread only."""
        if self._witness is not None and self._witness.pick():
            r.witness_src = np.array(r.image, copy=True)
        cb = r.on_consumed
        r.image = None
        r.on_consumed = None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass  # a broken release hook must not kill the batch

    def _dispatch_sharded(self, batch: List[Request]):
        """The oversized-request route: each request runs the sharded
        runner (K3) at its true shape; the retire fetches them in order."""
        h, w = batch[0].image.shape[:2]
        channels = (
            batch[0].image.shape[2] if batch[0].image.ndim == 3 else 1
        )
        runner = self._sharded_runner_for(
            batch[0].filter_name, (h, w), channels
        )
        if runner is None:
            # The mesh cannot serve this geometry: the bucket route serves
            # every shape. The key keeps its "sharded" marker.
            for r in batch:
                r.sharded = False
                r.bucket_hw = bucketing.bucket_shape(h, w, self._edges)
            return self._dispatch_inner(batch)
        n_dev = runner.mesh_shape[0] * runner.mesh_shape[1]
        t0 = time.perf_counter()
        if self._fault_h2d is not None:
            self._fault_h2d()
        if self._fault_compute is not None:
            self._fault_compute()
        outs = []
        for r in batch:
            tiles = runner.put(r.image)
            outs.append(runner.run(tiles, r.reps))
            self._consume(r)  # sharded images are engine-owned copies
        self._m_sharded.inc(len(batch))
        self._m_sharded_batches.inc()
        self._m_real.inc(len(batch) * h * w)
        ph, pw = runner.padded_shape
        self._m_padded.inc(len(batch) * (ph * pw - h * w))
        self._account_devices(
            n_dev, len(batch) * ph * pw * channels, len(batch)
        )
        for r in batch:
            self._m_qwait.observe(t0 - r.t_submit)
            if r.ledger is not None:
                r.ledger.add_queue(t0 - r.t_submit)
        self._m_bsize.observe(len(batch))
        meta = {"sharded": True, "runner": runner,
                "backend": runner.backend, "n_devices": n_dev}
        return batch, outs, meta, t0

    def _build_program(self, filter_name: str, bucket_hw: Tuple[int, int],
                       channels: int, reps: int, nb: int) -> BucketProgram:
        """The bucket program of one key, on the backend the filter's model
        resolves for the bucket."""
        model = self._model_for(filter_name)
        backend, _sched = model.resolved_config(bucket_hw, channels)
        return BucketProgram(model.plan, backend, reps, nb, bucket_hw,
                             channels)

    def _slot_for(self, prog: BucketProgram) -> _Slot:
        """The next arena slot of a program's canvas geometry."""
        (bh, bw), channels, nb = prog.bucket_hw, prog.channels, prog.nb
        shape = (nb, prog.stride, bw) + ((channels,) if channels > 1 else ())
        return self._arena.acquire((nb, bh, bw, channels, prog.stride),
                                   shape)

    def _launch(self, prog: BucketProgram, slot: _Slot) -> None:
        """Copy the slot's canvas to the device, run the program over it
        under the pad mask of the slot's true extents, and copy the result
        into the slot's output (asynchronous on a card: the D2H lands at
        ``slot.d2h_event``)."""
        rows, wc = prog.rows, prog.wc
        if self._cuda:
            # H2D on the copy stream; the compute stream waits for it.
            with torch.cuda.stream(self._copy_stream):
                x2 = torch.empty((rows, wc), dtype=torch.uint8,
                                 device=self.device)
                x2.copy_(slot.canvas_t.view(rows, wc), non_blocking=True)
                valid_dev = slot.valid_t.to(self.device, non_blocking=True)
                slot.h2d_event.record(self._copy_stream)
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(slot.h2d_event)
                x2.record_stream(self._stream)
                valid_dev.record_stream(self._stream)
                out = prog.run(x2, pad_mask(valid_dev, prog.stride,
                                            prog.bucket_hw[1],
                                            prog.channels))
                # D2H on its own stream after the compute; the caller
                # reads the slot's output only after this copy's event.
                done = torch.cuda.Event()
                done.record(self._stream)
            with torch.cuda.stream(self._d2h_stream):
                self._d2h_stream.wait_event(done)
                slot.out_t.copy_(out.view(-1), non_blocking=True)
                slot.d2h_event.record(self._d2h_stream)
            out.record_stream(self._d2h_stream)
        else:
            x2 = slot.canvas_t.view(rows, wc).clone()
            valid_dev = slot.valid_t.clone()
            out = prog.run(x2, pad_mask(valid_dev, prog.stride,
                                        prog.bucket_hw[1], prog.channels))
            slot.out_t.copy_(out.view(-1))

    def _dispatch_inner(self, batch: List[Request]):
        bh, bw = batch[0].bucket_hw
        channels = (
            batch[0].image.shape[2] if batch[0].image.ndim == 3 else 1
        )
        nb = bucketing.batch_bucket(len(batch), self.cfg.max_batch)
        reps = batch[0].reps

        def builder():
            if self._fault_compile is not None:
                self._fault_compile()
            return self._build_program(batch[0].filter_name, (bh, bw),
                                       channels, reps, nb)

        exe_key = batch[0].key + (nb,)
        prog = self._cache.get(exe_key, builder)
        backend = prog.backend
        # A reused slot is dirty: every real frame writes its pixels and
        # zeroes its own pad (the pad must be zero at rep 1; the mask
        # zeroes it from the first rep's end on). Unused batch-pad frames
        # only need valid 0 x 0. Gap rows are never written, so stay 0.
        slot = self._slot_for(prog)
        canvas, valid = slot.canvas, slot.valid
        for i, r in enumerate(batch):
            h, w = r.image.shape[:2]
            canvas[i, :h, :w] = r.image
            if h < bh:
                canvas[i, h:bh] = 0
            if w < bw:
                canvas[i, :h, w:] = 0
            valid[0, i], valid[1, i] = h, w
            self._consume(r)
        valid[:, len(batch):] = 0
        true_shapes = [r.shape[:2] for r in batch]
        self._m_padded.inc(bucketing.waste_pixels(true_shapes, (bh, bw), nb))
        self._m_real.inc(sum(h * w for h, w in true_shapes))
        h2d_bytes = int(slot.canvas_t.numel())
        self._account_devices(1, h2d_bytes, len(batch),
                              first=self.device.index or 0)
        t0 = time.perf_counter()
        if self._fault_h2d is not None:
            self._fault_h2d()
        if self._fault_compute is not None:
            self._fault_compute()
        if (_introspect.enabled() and exe_key not in self._introspected
                and len(self._introspected) < _INTROSPECT_KEY_CAP):
            self._introspected.add(exe_key)
            _introspect.capture(
                "serve.bucket",
                lambda: prog.describe(batch[0].filter_name, self.device),
                meta={"server": self._serial,
                      "filter": batch[0].filter_name,
                      "bucket_hw": (bh, bw), "channels": channels,
                      "batch_bucket": nb, "reps": reps,
                      "backend": backend},
                registry=self.registry,
            )
        self._launch(prog, slot)
        for r in batch:
            self._m_qwait.observe(t0 - r.t_submit)
            if r.ledger is not None:
                r.ledger.add_queue(t0 - r.t_submit)
        self._m_bsize.observe(len(batch))
        return (batch, slot, (bh, bw, channels, nb, backend, h2d_bytes), t0)

    def _credit_batch(self, batch, wall: float, h2d_bytes: int,
                      d2h_bytes: int) -> None:
        """Split one retired batch's wall across its members by pixel
        share, into each member's ledger and into exactly one of the
        goodput/overhead counters (warm submits, ledger ``kind !=
        "request"``, are overhead; a ledger-less request is goodput)."""
        self._m_h2d_bytes.inc(int(h2d_bytes))
        self._m_d2h_bytes.inc(int(d2h_bytes))
        px = [max(1, int(np.prod(r.shape))) for r in batch]
        total = sum(px)
        goodput = overhead = 0.0
        for r, p in zip(batch, px):
            frac = p / total
            share = wall * frac
            led = r.ledger
            if led is not None:
                led.add_device(share, h2d_bytes=int(h2d_bytes * frac),
                               d2h_bytes=int(d2h_bytes * frac))
            if led is not None and led.kind != "request":
                overhead += share
            else:
                goodput += share
        if goodput > 0:
            self._m_goodput.inc(goodput)
        if overhead > 0:
            self._m_overhead.inc(overhead)

    def _retire(self, batch, result, meta, t0) -> None:
        """Wait for one in-flight batch, crop per-request outputs, resolve
        futures, record latency and achieved-bandwidth metrics."""
        with _obs_span("serve.drain", "serve", batch=len(batch),
                       trace_ids=_batch_trace_ids(batch)):
            if isinstance(meta, dict) and meta.get("sharded"):
                self._retire_sharded(batch, result, meta, t0)
            else:
                self._retire_inner(batch, result, meta, t0)

    def _retire_sharded(self, batch, outs, meta, t0) -> None:
        """Fetch each sharded launch in dispatch order (each fetch waits
        for its tiles), crop the mesh pad off and resolve futures. No
        roofline sample: the model is per device."""
        runner = meta["runner"]
        if self._fault_d2h is not None:
            self._fault_d2h()
        results = [runner.fetch(o) for o in outs]
        t1 = time.perf_counter()
        self._m_batches.inc()
        self._m_blat.observe(t1 - t0)
        ph, pw = runner.padded_shape
        ch = batch[0].shape[2] if len(batch[0].shape) == 3 else 1
        self._credit_batch(
            batch, t1 - t0, len(batch) * ph * pw * ch,
            sum(int(np.asarray(o).nbytes) for o in results),
        )
        self._finish(batch, [np.ascontiguousarray(o) for o in results], t1)

    def _retire_inner(self, batch, slot, meta, t0) -> None:
        bh, bw, channels, nb, backend, h2d_bytes = meta
        if self._fault_d2h is not None:
            self._fault_d2h()
        if slot.d2h_event is not None:
            slot.d2h_event.synchronize()  # the batch's D2H landed
        t1 = time.perf_counter()
        self._m_batches.inc()
        self._m_blat.observe(t1 - t0)
        self._credit_batch(batch, t1 - t0, h2d_bytes,
                           int(slot.out_t.numel()))
        reps = batch[0].reps
        if reps > 0:
            from tpu_stencil_torch.runtime import roofline

            # fuse=1: the bucket route launches one rep at a time, so it
            # pays device memory every rep.
            gbps, _pct = roofline.achieved_frames(
                bh * bw * channels, nb, (t1 - t0) / reps, backend,
                batch[0].filter_name, bh, fuse=1,
            )
            self._m_gbps.observe(gbps)
        # Crop inside each request's true pixels (the copy frees the slot).
        results = [slot.out[i, :r.shape[0], :r.shape[1]].copy()
                   for i, r in enumerate(batch)]
        self._finish(batch, results, t1)

    def _finish(self, batch, results, t1: float) -> None:
        """Resolve every member's future with its result (corrupted first
        where the ``integrity.corrupt_result`` site fires), then run the
        sampled witnesses, after every future resolved."""
        witness_queue = []
        for r, res in zip(batch, results):
            if self._fault_corrupt_result is not None and _checksum.fired(
                    self._fault_corrupt_result, r.req_id):
                res = _checksum.corrupt_array(res)
            self._record_request_span(r, t1)
            # A cancelled future just drops its result: one cancellation
            # must never poison its batch-mates.
            if not r.future.done() and _resolve(r.future, res):
                self._m_completed.inc()
                self._m_rlat.observe(t1 - r.t_submit)
            if r.witness_src is not None:
                witness_queue.append((r, res))
        for r, res in witness_queue:
            self._witness_one(r, res)

    def _record_request_span(self, r: Request, t1: float) -> None:
        """File the per-request ``serve.request`` record (submit to
        retire) with the request's own trace id, before its future
        resolves. No-op when no span sink is installed."""
        if r.trace_id and _obs_tracing.sinks_active():
            _obs_tracing.emit_span(
                "serve.request", "serve", r.t_submit, t1,
                trace_id=r.trace_id, span_id=r.span_id,
                req_id=r.req_id, reps=r.reps,
            )

    def _witness_one(self, r: Request, got: np.ndarray) -> None:
        """Re-execute one sampled request through torch ops on the
        server's device (:func:`~tpu_stencil_torch.integrity.witness.
        device_witness`, no hand-written kernel) and compare byte for
        byte. The verdict is counted and handed to ``on_witness``; a
        witness that itself errors is no verdict."""
        if r.reps > _witness_mod.WITNESS_MAX_REPS:
            return  # verification must stay cheap
        t_w0 = time.perf_counter()
        try:
            with _obs_span("integrity.witness", "integrity",
                           req_id=r.req_id, reps=r.reps):
                want = _witness_mod.device_witness(
                    r.witness_src, r.filter_name, r.reps,
                    self.cfg.boundary, device=self.device,
                )
                ok = bool(np.array_equal(want, np.asarray(got)))
        except Exception:
            self.registry.counter("integrity_witness_errors_total").inc()
            return
        # Paid-for device time that produced no client byte: overhead,
        # with its own sub-counter (witness is part of overhead).
        wit_s = time.perf_counter() - t_w0
        self._m_witness_s.inc(wit_s)
        self._m_overhead.inc(wit_s)
        self._m_witness_total.inc()
        if not ok:
            self._m_witness_bad.inc()
            _obs_flight.trigger(
                "witness_mismatch", trace_id=r.trace_id, tier="serve",
                req_id=r.req_id, reps=r.reps,
            )
        cb = self.on_witness
        if cb is not None:
            try:
                cb(ok)
            except Exception:
                pass  # a broken verdict sink must not crash the worker

    def _worker_loop(self) -> None:
        try:
            self._worker_loop_inner()
        except BaseException as e:
            # An unhandled escape is a worker death: fail every pending
            # and in-flight future typed and reject later submits.
            self._on_worker_death(e)

    def _on_worker_death(self, exc: BaseException) -> None:
        with self._cond:
            self._crashed = exc
            control = list(self._control)
            self._control.clear()
            victims = list(self._current_batch)
            self._current_batch = []
            victims.extend(self._pending)
            self._pending.clear()
            while self._inflight_batches:
                victims.extend(self._inflight_batches.popleft()[0])
            self._m_depth.set(0)
            self._m_inflight.set(0)
            self._cond.notify_all()
        self._m_crashes.inc()
        err = WorkerCrashed(
            f"serve worker thread died ({type(exc).__name__}: {exc})"
        )
        err.__cause__ = exc
        for r in victims:
            if not r.future.done() and _resolve(r.future, exc=err):
                self._m_failed.inc()
        for _fn, fut in control:
            _resolve(fut, exc=err)

    def _setup_streams(self, make_current: bool = True) -> None:
        """On a card: the worker's compute stream (made current on this
        thread, so K1, K3 and the torch ops all issue on it) and the copy
        and D2H streams."""
        if not self._cuda:
            return
        if make_current:
            torch.cuda.set_device(self.device)
        self._stream = torch.cuda.Stream(self.device)
        self._copy_stream = torch.cuda.Stream(self.device)
        self._d2h_stream = torch.cuda.Stream(self.device)
        if make_current:
            torch.cuda.set_stream(self._stream)

    def _worker_loop_inner(self) -> None:
        self._setup_streams()
        try:
            self._memsampler.start()
        except Exception:
            pass  # telemetry must never take down the serving loop
        inflight = self._inflight_batches
        while True:
            with self._cond:
                while (not self._pending and not self._closing
                       and not inflight and not self._control):
                    self._cond.wait()
                control = list(self._control)
                self._control.clear()
                batch, expired = self._take_batch_locked()
                closing = self._closing
            for fn, fut in control:
                try:
                    fut.set_result(fn())
                except Exception as e:  # the caller's, typed
                    fut.set_exception(e)
            for r in expired:
                # Typed, outside the lock.
                self._m_deadline.inc()
                waited = time.perf_counter() - r.t_submit
                _obs_flight.trigger(
                    "deadline_exceeded", trace_id=r.trace_id,
                    tier="serve", duration_s=waited, req_id=r.req_id,
                )
                if not r.future.done() and _resolve(
                    r.future,
                    exc=DeadlineExceeded(
                        f"request {r.req_id} expired after waiting "
                        f"{waited:.3f}s"
                    ),
                ):
                    self._m_failed.inc()
            if batch:
                self._current_batch = batch  # death-handler visibility
                try:
                    inflight.append(self._dispatch(batch))
                    self._m_inflight.set(len(inflight))
                except Exception as e:  # resolve, don't kill the loop
                    for r in batch:
                        if not r.future.done() and _resolve(r.future, exc=e):
                            self._m_failed.inc()
                self._current_batch = []
            # Retire when the pipeline is full (keeps depth bounded) or
            # when there is nothing new to overlap with.
            while inflight and (
                len(inflight) >= self.cfg.pipeline_depth or not batch
            ):
                done_batch, result, meta, t0 = inflight.popleft()
                self._current_batch = done_batch
                try:
                    self._retire(done_batch, result, meta, t0)
                except Exception as e:
                    for r in done_batch:
                        if not r.future.done() and _resolve(r.future, exc=e):
                            self._m_failed.inc()
                self._current_batch = []
                self._m_inflight.set(len(inflight))
                if batch:
                    break  # go assemble the next batch for overlap
            with self._lock:
                drained = not self._pending
            if closing and drained and not inflight and not batch:
                # Reject anything that raced in after the closing flag.
                with self._lock:
                    leftovers = list(self._pending)
                    self._pending.clear()
                for r in leftovers:
                    _resolve(r.future, exc=ServerClosed("server closed"))
                return


def get_last_server() -> Optional[StencilServer]:
    """The most recently constructed server, if still alive (backs the
    module-level :func:`tpu_stencil_torch.serve.stats`)."""
    ref = _last_server_ref
    return ref() if ref is not None else None
