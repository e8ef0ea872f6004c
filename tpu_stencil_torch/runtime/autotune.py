"""Backend/schedule/geometry autotuner: a measured grid search over
``(backend, schedule, block_h, fuse)`` once per (card, filter, shape),
pruned by the shared-memory model and cached on disk.

The port's counterpart of the JAX package's ``runtime/autotune.py``
(``best_full_config`` and its cache, the overlap verdict
``best_overlap``, and the stream verdicts ``cached_stream_verdict``,
``store_stream_verdict`` and the modelled ``choose_stream_topology``). The candidates are the port's: backends ``xla`` (torch
ops) and ``pallas`` (the hand-written kernels); schedules ``fused`` (K1)
and ``deep`` (K2 when the image fits the L2 budget, else K1 at the deep
depth); then a geometry stage over :data:`_GEOMETRY_GRID` at the winning
schedule, where a candidate must beat the default geometry by more
than :data:`GEOMETRY_MARGIN`. ``--backend autotune`` (and the default ``auto``) measures the
grid ONCE on a card, persists the verdict in a versioned JSON cache
(``~/.cache/tpu_stencil_torch/autotune.json``, override with
``TPU_STENCIL_TORCH_AUTOTUNE_CACHE``), and every later run with the same
key pays nothing: a warm cache performs ZERO probes (:data:`probe_count`
counts them). Off a card, and for ``direct_f32`` plans, it answers ``xla``
without measuring.

The cache is the port's own file: the JAX package's loader drops every key
whose version segment is not its ``jax.__version__`` and its next store
rewrites the file without them, so the two must never share one. A key
carries the card's name, the torch and CUDA versions and the hash of the
kernel libraries' sources and flags (:func:`_build.fingerprint`), so a
verdict never outlives the stack or the kernel it timed; keys of another
stack are evicted at load. Each entry carries a CRC32C: an entry whose
digits flipped on disk drops alone, with a warning. A truncated, empty or
non-object file loads as a cold miss with a ``RuntimeWarning``.

A candidate the shared-memory model admits and the card refuses is a
fault: its error propagates. Nothing here catches a build or launch error
to try the next candidate.

Measurements use steady-state two-point differencing
(:func:`_steady_state_per_rep`): ``(t(2n) - t(n)) / n`` cancels launch and
fence overhead.
"""

from __future__ import annotations

import inspect
import json
import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops.lowering import StencilPlan

_CANDIDATES = ("xla", "pallas")
_SCHEDULES = (cs.FUSED, cs.DEEP)

SCHEMA_VERSION = 1
ENV_CACHE = "TPU_STENCIL_TORCH_AUTOTUNE_CACHE"

# Measurements made by best_full_config in this process (a warm cache
# leaves it unchanged).
probe_count = 0
# Probe bundles measured by best_overlap in this process (likewise).
overlap_probe_count = 0


def _cache_path() -> str:
    return os.environ.get(
        ENV_CACHE,
        os.path.join(os.path.expanduser("~"), ".cache", "tpu_stencil_torch",
                     "autotune.json"),
    )


def _on_card(device) -> bool:
    """Whether ``device`` is a CUDA card: the one seam tests patch to
    tune with an injected ``measure`` where there is none."""
    return torch.device(device).type == "cuda"


def _card_name(device) -> str:
    """The card's name as the cache keys carry it."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(device)
    return device.type


def _stack_version() -> str:
    """The stack a verdict was measured on: torch, CUDA and the kernel
    libraries' source hash. An upgrade of any of them can flip which
    point wins."""
    return (f"torch{torch.__version__}+cuda{torch.version.cuda}"
            f"+k{_build.fingerprint()}")


def _key(plan: StencilPlan, shape: Tuple[int, int], channels: int,
         device="cuda") -> str:
    taps = ";".join(",".join(str(v) for v in row) for row in plan.taps)
    return "|".join(
        [_card_name(device), _stack_version(), plan.kind, str(plan.divisor),
         taps, f"{shape[0]}x{shape[1]}x{channels}"]
    )


def _entry_stack_version(key: str) -> Optional[str]:
    """The stack version embedded in a cache key (``_key`` puts it
    second). None for unparseable keys, which get evicted."""
    parts = key.split("|")
    return parts[1] if len(parts) > 1 else None


def _corrupt_cache_warning(path: str, why: str) -> None:
    warnings.warn(
        f"autotune cache at {path} is unreadable ({why}); treating it "
        "as cold: verdicts re-measure and the next store rewrites it",
        RuntimeWarning,
        stacklevel=3,
    )


def _entry_crc(value) -> int:
    return _checksum.crc32c(json.dumps(value, sort_keys=True).encode())


def _load_cache() -> dict:
    """The cache's entries dict, filtered to keys whose embedded stack
    version matches the running one and whose CRC32C still matches.
    Garbage, empty or partial files load as a cold miss with a warning,
    never an exception: a corrupted cache costs a re-measure, not the
    job."""
    path = _cache_path()
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {}  # cold cache: the normal first-run state, no warning
    except (OSError, ValueError) as e:
        _corrupt_cache_warning(path, f"{type(e).__name__}: {e}")
        return {}
    if not isinstance(raw, dict):
        _corrupt_cache_warning(path, f"top-level {type(raw).__name__}, "
                               "expected object")
        return {}
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        _corrupt_cache_warning(path, "entries is not an object")
        return {}
    cur = _stack_version()
    entries = {
        k: v for k, v in entries.items()
        if isinstance(k, str) and _entry_stack_version(k) == cur
    }
    crcs = raw.get("entry_crcs")
    if isinstance(crcs, dict):
        good = {}
        for k, v in entries.items():
            want = crcs.get(k)
            if want is not None and _entry_crc(v) != want:
                warnings.warn(
                    f"autotune cache entry {k!r} in {path} fails its "
                    "embedded crc32c (changed on disk); dropping it: that "
                    "verdict re-measures and the next store rewrites it",
                    RuntimeWarning,
                    stacklevel=3,
                )
                continue
            good[k] = v
        entries = good
    return entries


def _store_cache(cache: dict) -> None:
    """Persist the entries dict (evicted keys, dropped by
    :func:`_load_cache`, are gone for good on the next store): written to
    a temporary file, synced, then renamed over the cache."""
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({
                "schema_version": SCHEMA_VERSION,
                "stack_version": _stack_version(),
                "entries": cache,
                "entry_crcs": {k: _entry_crc(v) for k, v in cache.items()},
            }, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        pass  # read-only home: tuning still works, it just re-measures


def measure_backend(
    plan: StencilPlan, shape: Tuple[int, int], channels: int, backend: str,
    reps: int = 400, schedule: Optional[str] = None,
    block_h: Optional[int] = None, fuse: Optional[int] = None,
    device="cuda",
) -> float:
    """Steady-state seconds per repetition of ``backend`` on this shape
    (``schedule`` selects the kernel schedule, ``block_h``/``fuse`` the
    kernel geometry; None = defaults), on ``device``. Each timed run is
    fenced with a synchronize at both ends."""
    from tpu_stencil_torch.ops import lowering
    from tpu_stencil_torch.utils.timing import fence

    device = torch.device(device)
    rng = np.random.default_rng(0)
    full = shape if channels == 1 else shape + (channels,)
    img = torch.from_numpy(
        rng.integers(0, 256, size=full, dtype=np.uint8)).to(device)

    def run(n: int) -> float:
        fence(device)
        t0 = time.perf_counter()
        if backend == "pallas":
            cs.iterate(img, n, plan, block_h=block_h, fuse=fuse,
                       schedule=schedule)
        else:
            lowering.iterate(img, n, plan)
        fence(device)
        return time.perf_counter() - t0

    run(2)  # first-launch fence (module load, shared-memory attribute)
    return _steady_state_per_rep(run, reps)


def _steady_state_per_rep(run, reps: int) -> float:
    """Two-point differencing of ``run(n) -> seconds``: (t(2n) - t(n)) / n
    cancels the constant dispatch/fence overhead. Re-measures up to 3 times
    when timing noise inverts the pair; a clamped ~0 difference must never
    decide (and get cached as) the winner. The fallback differences the
    long run against a 2-rep run instead: it still cancels the constant
    overhead, so its numbers stay comparable with the clean path, just
    with worse noise rejection. Only a degenerate clock (t(2n) <= t(2))
    yields the raw rate."""
    for _ in range(3):
        lo = min(run(reps) for _ in range(2))
        hi = min(run(2 * reps) for _ in range(2))
        if hi > lo:
            return (hi - lo) / reps
    base = min(run(2) for _ in range(2))
    if hi > base:
        return (hi - base) / (2 * reps - 2)
    return hi / (2 * reps)


# Geometry candidates the unforced tune tries on top of the module default
# (32 x 8), at the winning schedule only. Chosen for this card: a block may
# use 227 KB of shared memory and a tile takes 3 to 5 bytes per element
# (by the plan's tile body: swar 4, acc16 3, int32 5) of
# (block_h + 2*fuse*halo) x (256 + 2*fuse*halo*C), so tiles are tens of
# rows, not hundreds; candidates past the limit in the plan's body are
# pruned before any measurement (cuda_stencil.tile_smem_bytes) and
# candidates that launch as an earlier one does are skipped
# (effective_geometry). fuse 4/5/10/20/40:
# `reps % fuse` runs as single-rep launches, which taxes fuses that do not
# divide the reference's 40-rep jobs, so every divisor of 40 that a tile
# can hold is in the grid; 16 and 32 are there for rep counts that are
# powers of two.
_GEOMETRY_GRID = (
    (16, 4), (16, 8), (32, 4), (32, 5), (32, 10), (32, 16), (64, 4),
    (64, 8), (64, 10), (64, 16), (64, 20), (64, 32), (128, 8), (128, 20),
    (128, 40),
)


# A grid candidate replaces the default geometry only when it is faster by
# more than this share. Kernel times on one H100 moved by ~12% between two
# calls with unchanged sources, and a verdict stays on disk until the
# kernels change: a smaller margin would freeze that noise, and a shallower
# fuse picked on it doubles a job's launches for nothing.
GEOMETRY_MARGIN = 0.12


def _grid_fingerprint():
    """The geometry grid as stored in cache entries (JSON round-trips
    tuples to lists). An entry tuned under a different grid must
    re-measure, or a changed grid would be inert for every cached shape."""
    return [list(g) for g in _GEOMETRY_GRID]


def _measure_takes_geometry(measure) -> bool:
    """Whether the measure callable accepts block_h/fuse kwargs; one that
    does not skips the geometry stage."""
    try:
        params = inspect.signature(measure).parameters
    except (TypeError, ValueError):
        return False
    return "block_h" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


def _geometry_candidates(plan: StencilPlan, n_rows: int, channels: int,
                         schedule: Optional[str]):
    """The grid's candidates worth a measurement, as (requested,
    effective) pairs: inside shared memory as requested, and launching
    differently from the default and from each other."""
    seen = {cs.effective_geometry(plan, n_rows, channels, schedule=schedule)}
    out = []
    for gbh, gfz in _GEOMETRY_GRID:
        if cs.tile_smem_bytes(plan, gbh, gfz, channels) > cs.SMEM_LIMIT:
            continue
        eff = cs.effective_geometry(plan, n_rows, channels, gbh, gfz)
        if eff in seen:
            continue
        seen.add(eff)
        out.append(((gbh, gfz), eff))
    return out


def best_full_config(
    plan: StencilPlan,
    shape: Tuple[int, int],
    channels: int,
    cache: bool = True,
    measure=None,
    force_schedule: Optional[str] = None,
    block_h: Optional[int] = None,
    fuse: Optional[int] = None,
    device="cuda",
) -> Tuple[str, Optional[str], Optional[int], Optional[int]]:
    """The fastest (backend, schedule, block_h, fuse) for this (card,
    filter, shape), from the disk cache when available, measured (and
    cached) otherwise. The schedule is None for ``xla``; the geometry is
    None where the module defaults won (no candidate beat them by more
    than :data:`GEOMETRY_MARGIN`), where K2 runs (no static
    geometry) and for ``xla``. ``force_schedule`` (the --schedule flag)
    restricts the kernel side to what that name runs (``deep`` or
    ``fused``), cached under its own key. ``block_h``/``fuse`` (the
    --block-h/--fuse flags) force the geometry: kernel candidates are
    measured at it (no geometry stage runs) and the verdict is cached
    under a geometry-suffixed key. Off a card, for ``direct_f32`` plans
    and for plans the kernels do not take, the answer is ``xla`` without
    a measurement."""
    if not _on_card(device):
        return "xla", None, None, None
    if plan.kind == "direct_f32" or not cs.plan_supported(plan, channels):
        return "xla", None, None, None
    if measure is None:
        measure = measure_backend  # late-bound: patchable, testable
    takes_device = "device" in inspect.signature(measure).parameters

    def probe(backend, **kw):
        global probe_count
        probe_count += 1
        if takes_device:
            kw["device"] = device
        return measure(plan, shape, channels, backend, **kw)

    key = _key(plan, shape, channels, device)
    if force_schedule is not None:
        force_schedule = cs.effective_schedule(force_schedule)
        key += f"|forced={force_schedule}"
    # Key and measure at the EFFECTIVE geometry, so requested values that
    # launch identically share one entry and one sweep.
    geo_kw = {}
    if block_h is not None or fuse is not None:
        eff_bh, eff_fz = cs.effective_geometry(
            plan, shape[0], channels, block_h, fuse, schedule=force_schedule)
        key += f"|bh={eff_bh}|fz={eff_fz}"
        geo_kw = {"block_h": eff_bh, "fuse": eff_fz}
    store = _load_cache() if cache else {}
    hit = store.get(key)
    if (
        isinstance(hit, dict)
        and hit.get("backend") in _CANDIDATES
        and (hit.get("schedule") is None or hit["schedule"] in _SCHEDULES)
        and "block_h" in hit
        # An entry tuned under another grid re-measures; forced-geometry
        # lookups never run the grid, so they are grid-independent.
        and (bool(geo_kw) or hit.get("geometry_grid") == _grid_fingerprint())
    ):
        return (hit["backend"], hit.get("schedule"),
                hit.get("block_h"), hit.get("fuse"))
    scheds = ([force_schedule] if force_schedule is not None
              else list(_SCHEDULES))
    timings = {("xla", None): probe("xla", schedule=None)}
    for s in scheds:
        timings[("pallas", s)] = probe("pallas", schedule=s, **geo_kw)
    winner, win_sched = min(timings, key=timings.get)

    # Geometry stage: an unforced kernel winner tries the grid at the
    # winning schedule. A deep winner that runs K2 skips it: the resident
    # kernel has no static (block_h, fuse).
    win_bh = win_fuse = None
    geo_us = {}
    deep_resident = (
        win_sched == cs.DEEP
        and cs.resident_feasible(plan, shape[0], shape[1] * channels,
                                 channels, device)
    )
    if (winner == "pallas" and not geo_kw and not deep_resident
            and _measure_takes_geometry(measure)):
        geo_timings = {(None, None): timings[(winner, win_sched)]}
        for (gbh, gfz), _eff in _geometry_candidates(
                plan, shape[0], channels, win_sched):
            geo_timings[(gbh, gfz)] = probe(
                winner, schedule=win_sched, block_h=gbh, fuse=gfz)
        best = min(geo_timings, key=geo_timings.get)
        if (geo_timings[best]
                < (1.0 - GEOMETRY_MARGIN) * geo_timings[(None, None)]):
            win_bh, win_fuse = best
        geo_us = {
            ("default" if g == (None, None) else f"{g[0]}x{g[1]}"):
                round(t * 1e6, 2)
            for g, t in geo_timings.items()
        }
    elif geo_kw and winner == "pallas":
        win_bh, win_fuse = geo_kw["block_h"], geo_kw["fuse"]
    if cache:
        store[key] = {
            "backend": winner,
            "schedule": win_sched,
            "block_h": win_bh,
            "fuse": win_fuse,
            "geometry_grid": _grid_fingerprint(),
            "us_per_rep": {
                (b if s is None else f"{b}[{s}]"): round(t * 1e6, 2)
                for (b, s), t in timings.items()
            },
            **({"geometry_us_per_rep": geo_us} if geo_us else {}),
        }
        _store_cache(store)
    return winner, win_sched, win_bh, win_fuse


def cached_entry(plan: StencilPlan, shape: Tuple[int, int], channels: int,
                 device="cuda") -> Optional[dict]:
    """The unforced cache entry for this (card, filter, shape), with the
    µs per rep of every candidate it measured, or None."""
    return _load_cache().get(_key(plan, shape, channels, device))


def best_config(
    plan: StencilPlan, shape: Tuple[int, int], channels: int,
    cache: bool = True, measure=None, force_schedule: Optional[str] = None,
    block_h: Optional[int] = None, fuse: Optional[int] = None,
    device="cuda",
) -> Tuple[str, Optional[str]]:
    """The (backend, schedule) half of :func:`best_full_config`."""
    return best_full_config(
        plan, shape, channels, cache=cache, measure=measure,
        force_schedule=force_schedule, block_h=block_h, fuse=fuse,
        device=device,
    )[:2]


def best_backend(
    plan: StencilPlan, shape: Tuple[int, int], channels: int,
    cache: bool = True, measure=None, device="cuda",
) -> str:
    """The backend half of :func:`best_config`."""
    return best_config(plan, shape, channels, cache=cache, measure=measure,
                       device=device)[0]


# --- interior/border overlap schedule ("--overlap auto") ---------------
#
# The split (tpu_stencil_torch.parallel.overlap) pays more launches and a
# side stream's synchronization to run the ghost-free interior while the
# ghosts are copied. It can only win where the exchange is a real share of
# a chunk: below OVERLAP_MIN_RATIO there is nothing to hide. Above it the
# measured candidates decide, and no mode is taken that did not measure
# strictly faster than the one it displaces.
OVERLAP_MIN_RATIO = 0.05  # exchange below 5% of interior: overlap is moot

_OVERLAP_MODES = ("off", "split", "fused-split", "edge")


def overlap_from_ratio(ratio: float, backend: str) -> str:
    """Map a measured exchange/interior time ratio to an overlap mode:
    ``off`` below :data:`OVERLAP_MIN_RATIO`, else the chunked
    ``fused-split`` on the kernels and the per-rep ``split`` elsewhere.
    Never ``edge``: it has no candidate A/B to justify it with."""
    if not ratio > OVERLAP_MIN_RATIO:
        return "off"
    return "fused-split" if backend == "pallas" else "split"


def _probe_bundle(measured) -> dict:
    """Normalize a ``measure()`` result: the ``(exchange_s, interior_s)``
    pair or the bundle dict (``exchange_s``/``interior_s``/``edges``/
    ``candidates``) the runner produces."""
    if isinstance(measured, dict):
        return measured
    exchange_s, interior_s = measured
    return {"exchange_s": exchange_s, "interior_s": interior_s}


def overlap_verdict(bundle: dict, backend: str) -> str:
    """The measured verdict ``--overlap auto`` resolves to.

    ``off`` when the exchange/interior ratio is at most
    :data:`OVERLAP_MIN_RATIO`. Otherwise the candidates decide: ``edge``
    only when the per-edge pipeline measured strictly faster than the
    split, else the split flavour (``fused-split`` on the kernels); and
    where the bundle also timed ``off`` (the port's runner does), the
    flavour chosen must be strictly faster than ``off`` too, else ``off``:
    never enable a measured loss. A bundle without candidates falls back to
    :func:`overlap_from_ratio`."""
    exchange_s = bundle["exchange_s"]
    interior_s = bundle["interior_s"]
    ratio = exchange_s / interior_s if interior_s > 0 else float("inf")
    if not ratio > OVERLAP_MIN_RATIO:
        return "off"
    split_mode = "fused-split" if backend == "pallas" else "split"
    cand = bundle.get("candidates") or {}
    if "split" not in cand or "edge" not in cand:
        return split_mode
    key = "edge" if cand["edge"] < cand["split"] else "split"
    if "off" in cand and not cand[key] < cand["off"]:
        return "off"
    return "edge" if key == "edge" else split_mode


def _overlap_key(plan: StencilPlan, tile: Tuple[int, int], channels: int,
                 mesh_shape: Tuple[int, int], backend: str,
                 device="cuda") -> str:
    # _key's identity (card, stack, plan, shape), then the mesh (the ratio
    # depends on how many neighbours exchange) and the backend (the split
    # flavour and the interior's cost differ). The stack stays the key's
    # second segment, which the loader reads.
    return "|".join([_key(plan, tuple(tile), channels, device), "overlap",
                     f"mesh{mesh_shape[0]}x{mesh_shape[1]}", backend])


def cached_overlap(plan: StencilPlan, tile: Tuple[int, int], channels: int,
                   mesh_shape: Tuple[int, int], backend: str,
                   device="cuda") -> Optional[str]:
    """The cached overlap verdict for this key, or None (a miss, or a mode
    name it does not know)."""
    hit = _load_cache().get(
        _overlap_key(plan, tile, channels, mesh_shape, backend, device))
    if isinstance(hit, dict) and hit.get("overlap") in _OVERLAP_MODES:
        return hit["overlap"]
    return None


def best_overlap(plan: StencilPlan, tile: Tuple[int, int], channels: int,
                 mesh_shape: Tuple[int, int], backend: str, measure,
                 cache: bool = True, device="cuda") -> str:
    """The overlap mode for this (card, filter, tile, mesh, backend): from
    the cache when it holds one (a warm cache measures nothing), else
    measured once by ``measure()`` (the runner's probe bundle,
    :meth:`ShardedRunner._measure_overlap_probes`, or an
    ``(exchange_s, interior_s)`` pair), decided by
    :func:`overlap_verdict` and cached with the probe times beside the
    verdict. The runner passes its probes, so this module owns only the
    decision and its persistence. Counts each measurement in
    :data:`overlap_probe_count`."""
    global overlap_probe_count
    if cache:
        hit = cached_overlap(plan, tile, channels, mesh_shape, backend,
                             device)
        if hit is not None:
            return hit
    overlap_probe_count += 1
    bundle = _probe_bundle(measure())
    mode = overlap_verdict(bundle, backend)
    if cache:
        exchange_s, interior_s = bundle["exchange_s"], bundle["interior_s"]
        ratio = exchange_s / interior_s if interior_s > 0 else float("inf")
        entry = {
            "overlap": mode,
            "ratio": round(ratio, 4),
            "exchange_us": round(exchange_s * 1e6, 2),
            "interior_us": round(interior_s * 1e6, 2),
        }
        if bundle.get("edges"):
            entry["edge_us"] = {k: round(v * 1e6, 2)
                                for k, v in bundle["edges"].items()}
        if bundle.get("candidates"):
            entry["candidate_us"] = {k: round(v * 1e6, 2)
                                     for k, v in bundle["candidates"].items()}
        store = _load_cache()
        store[_overlap_key(plan, tile, channels, mesh_shape, backend,
                           device)] = entry
        _store_cache(store)
    return mode


# --- stream composition verdicts (--mesh-frames 0) -----------------------
#
# The stream's auto knob decides by a measured A/B (one device against the
# fan; a loss is never enabled). The A/B streams real frames through the
# real engines, so its verdict persists here like the overlap verdict,
# keyed on the card, the stack, the frame geometry, reps, depth and the
# topology decided over: a warm cache pays zero probe frames.

def stream_cfg_token(cfg) -> str:
    """The compute identity of a stream verdict's key: everything that
    changes the timed step (filter, backend request, forced schedule and
    geometry, boundary, overlap) splits the key, so a verdict measured
    under one filter or backend never answers for another."""
    return "|".join([
        cfg.filter_name, cfg.backend, str(cfg.schedule),
        str(cfg.block_h), str(cfg.fuse), cfg.boundary,
        getattr(cfg, "overlap", "off"),
    ])


def _stream_verdict_key(kind: str, geometry: Tuple[int, int, int],
                        reps: int, depth: int, topo: str,
                        cfg_token: str = "", device="cuda") -> str:
    # The card's name, then the stack (the loader reads the second
    # segment), then what the A/B decided over.
    h, w, channels = geometry
    return "|".join([
        _card_name(device), _stack_version(), "stream", kind,
        f"{h}x{w}x{channels}", f"reps{reps}", f"depth{depth}", topo,
        cfg_token,
    ])


def cached_stream_verdict(kind: str, geometry: Tuple[int, int, int],
                          reps: int, depth: int, topo: str,
                          cfg_token: str = "",
                          device="cuda") -> Optional[dict]:
    """The cached auto verdict of one stream composition, or None (a miss,
    or an entry without a ``pick``). ``kind`` is ``"fanout"``
    (``--mesh-frames 0``); ``topo`` pins the device population decided
    over (``ndev4``); ``cfg_token`` (:func:`stream_cfg_token`) the compute
    identity."""
    hit = _load_cache().get(_stream_verdict_key(
        kind, geometry, reps, depth, topo, cfg_token, device))
    if isinstance(hit, dict) and "pick" in hit:
        return hit
    return None


def store_stream_verdict(kind: str, geometry: Tuple[int, int, int],
                         reps: int, depth: int, topo: str, entry: dict,
                         cfg_token: str = "", device="cuda") -> None:
    """Persist one measured stream verdict (``entry`` carries ``pick`` and
    the measured arms beside it)."""
    store = _load_cache()
    store[_stream_verdict_key(kind, geometry, reps, depth, topo, cfg_token,
                              device)] = entry
    _store_cache(store)


def choose_stream_topology(geometry: Tuple[int, int, int], reps: int,
                           depth: int, n_devices: int,
                           backend: str = "xla",
                           filter_name: str = "gaussian",
                           frames: Optional[int] = None,
                           halo: int = 1) -> str:
    """The modelled best stream topology for one (geometry, reps, depth)
    on ``n_devices``, ranked by the roofline's steady-state frames/s
    (:mod:`tpu_stencil_torch.runtime.roofline`): ``"single"`` or
    ``"fanout"``. A fan is chosen only when its modelled bound strictly
    beats one device's (a tie stays single). The JAX package also ranks
    a spatial shard and a temporal pipeline here; those arms come with
    the sharded-stream and pipeline engines, whose models are not ported
    yet, so ``frames`` and ``halo`` (their inputs) are accepted and
    unused."""
    from tpu_stencil_torch.runtime import roofline

    h, w, channels = geometry
    frame_bytes = h * w * channels
    single = roofline.stream_frames_per_second(
        frame_bytes, reps, backend, filter_name, h, pipeline_depth=depth,
        w_img=w, channels=channels)
    if n_devices >= 2:
        fan = roofline.mesh_stream_frames_per_second(
            frame_bytes, reps, backend, filter_name, h,
            pipeline_depth=depth, n_devices=n_devices, w_img=w,
            channels=channels)
        if fan > single:
            return "fanout"
    return "single"
