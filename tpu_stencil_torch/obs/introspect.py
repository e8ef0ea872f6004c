"""Kernel-instance introspection and device-memory telemetry.

The port's counterpart of the JAX package's ``obs/introspect.py``. There
is no compiler between the port and the card to ask what it built (no
XLA, no HLO): the kernels are hand-written CUDA, built by ``nvcc`` into
libraries. So the two instruments read:

* **Kernel introspection** (:func:`capture`): for one site (the driver's
  warm-up, the sharded runner's), the kernel instances the warm-up just
  launched: name, tile body, tile, grid, threads per block, dynamic
  shared memory, registers (the build's ``-Xptxas -v`` lines) and
  resident blocks per SM (the library's occupancy query); the library's
  build time; and the modelled bytes and operations per rep
  (:mod:`tpu_stencil_torch.runtime.roofline`). A compiler's own count of
  bytes accessed does not exist here, so that column reads
  "unavailable", the JAX module's documented degradation, and
  :func:`cross_check` compares only where both counts exist (it records
  the model's bytes either way). Every probe degrades; none raises into
  a compute path.
* **Device-memory telemetry** (:func:`device_memory_stats`,
  :func:`record_memory_gauges`): ``torch.cuda.memory_stats`` and
  ``torch.cuda.mem_get_info`` as ``device_<key>`` gauges (bytes in use,
  allocator peak, reserved, free, total as ``bytes_limit``). Without a
  CUDA device nothing is recorded, never an error.

``--hlo-dump DIR`` arms capture as in the JAX package; a hand-written
kernel has no HLO, so no file is written there.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

# The device-memory gauges, in the JAX package's vocabulary where it has
# the same meaning: bytes_in_use / peak_bytes_in_use (the caching
# allocator's live bytes and their peak), bytes_limit (the card's total
# memory); bytes_reserved and bytes_free are the allocator's reserved
# segments and the card's free memory.
_DEVICE_MEMORY_KEYS = (
    "bytes_in_use",
    "peak_bytes_in_use",
    "bytes_reserved",
    "bytes_free",
    "bytes_limit",
)

# Model-vs-compiler traffic agreement band (as the JAX package's).
DRIFT_BAND_PCT = (50.0, 200.0)

# Record-list bound: past the cap the oldest records drop.
MAX_RECORDS = 1024

_lock = threading.Lock()
_enabled = False
_hlo_dir: Optional[str] = None
_records: List[dict] = []


def enable(hlo_dir: Optional[str] = None) -> None:
    """Arm introspection (the CLI does for ``--trace``/``--breakdown``/
    ``--hlo-dump`` runs); capture sites then call :func:`capture`.
    ``hlo_dir`` is kept only to be reported: nothing is written there."""
    global _enabled, _hlo_dir
    _enabled = True
    _hlo_dir = hlo_dir


def disable() -> None:
    global _enabled, _hlo_dir
    _enabled = False
    _hlo_dir = None


def enabled() -> bool:
    return _enabled


def records() -> List[dict]:
    """Snapshot of every capture so far, in capture order."""
    with _lock:
        return list(_records)


def reset() -> None:
    """Disarm and drop accumulated records (tests; ``obs.reset``)."""
    global _records
    disable()
    with _lock:
        _records = []


def hlo_note(hlo_dir: str) -> str:
    """What ``--hlo-dump DIR`` reports in the port."""
    return (f"hlo-dump: nothing written to {hlo_dir}: the port's kernels "
            "are hand-written CUDA built by nvcc, so there is no HLO "
            "(their instances are in the --breakdown introspection table)")


def capture(site: str, describe: Callable[[], dict],
            meta: Optional[dict] = None, registry=None) -> Optional[dict]:
    """Introspect one site: ``describe()`` returns ``{"kernels": [...],
    "build_seconds": s, "model_bytes_per_rep": b, "model_ops_per_rep":
    n}`` (the kernel instances the warm-up launched, each a
    :func:`tpu_stencil_torch.ops.cuda_stencil.describe_launch` dict; an
    empty list on the torch-ops path). The record adds the site, ``meta``,
    the compiler counts (None: unavailable) and ``available`` (every
    instance's registers and blocks per SM were read, i.e. on a card).
    Headline numbers are mirrored as ``introspect_<site>_*`` gauges.
    Returns None when disarmed, and on every rank but 0 of a job of
    several processes (each would record the same instances); never
    raises."""
    if not _enabled:
        return None
    from tpu_stencil_torch.parallel import distributed

    if distributed.process_index() != 0:
        return None
    rec = {
        "site": site,
        "meta": dict(meta or {}),
        "available": False,
        "kernels": [],
        "compile_seconds": None,
        "model_bytes_per_rep": None,
        "model_ops_per_rep": None,
        "bytes_accessed": None,
        "flops": None,
        "hlo_path": None,
        "error": None,
    }
    try:
        got = describe()
        rec["kernels"] = list(got.get("kernels", []))
        rec["compile_seconds"] = got.get("build_seconds")
        rec["model_bytes_per_rep"] = got.get("model_bytes_per_rep")
        rec["model_ops_per_rep"] = got.get("model_ops_per_rep")
        rec["available"] = bool(rec["kernels"]) and all(
            k.get("registers") is not None
            and k.get("blocks_per_sm") is not None for k in rec["kernels"])
        if not rec["kernels"]:
            rec["error"] = "no hand-written kernel on this path (torch ops)"
        elif not rec["available"]:
            rec["error"] = "registers and occupancy are read on a card"
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    with _lock:
        _records.append(rec)
        if len(_records) > MAX_RECORDS:
            del _records[: len(_records) - MAX_RECORDS]
    _count_capture(site, registry)
    _set_gauges(site, rec, registry)
    return rec


def _count_capture(site: str, registry=None) -> None:
    try:
        if registry is None:
            from tpu_stencil_torch.obs import tracing

            registry = tracing.registry()
        registry.counter(f"introspect_{_slug(site)}_captures_total").inc()
    except Exception:
        pass


def _slug(site: str) -> str:
    return site.replace(".", "_").replace("-", "_")


def _set_gauges(site: str, rec: dict, registry=None) -> None:
    """Mirror a record's headline numbers as gauges (per-site names; the
    last capture of a site wins)."""
    try:
        if registry is None:
            from tpu_stencil_torch.obs import tracing

            registry = tracing.registry()
        slug = _slug(site)
        scalars = {
            "compile_seconds": rec.get("compile_seconds"),
            "model_bytes_per_rep": rec.get("model_bytes_per_rep"),
            "model_ops_per_rep": rec.get("model_ops_per_rep"),
            "model_vs_xla_pct": rec.get("model_vs_xla_pct"),
        }
        kernels = rec.get("kernels") or []
        if kernels:
            first = kernels[0]
            for field in ("registers", "smem_bytes", "blocks_per_sm",
                          "threads"):
                scalars[field] = first.get(field)
        for name, v in scalars.items():
            if v is not None:
                registry.gauge(f"introspect_{slug}_{name}").set(v)
    except Exception:
        pass  # telemetry must never take down the instrumented path


def cross_check(rec: dict, model_bytes_per_rep: float,
                registry=None) -> dict:
    """Annotate ``rec`` with ``model_bytes_per_rep``, and, where the
    compiler's bytes-accessed exist, ``model_vs_xla_pct`` (100 * model /
    compiler) and ``drift`` (outside :data:`DRIFT_BAND_PCT`); both None
    here, where no compiler count exists. Refreshes the site gauges.
    Never raises."""
    try:
        rec["model_bytes_per_rep"] = float(model_bytes_per_rep)
        xla_bytes = rec.get("bytes_accessed")
        if xla_bytes:
            pct = 100.0 * float(model_bytes_per_rep) / float(xla_bytes)
            rec["model_vs_xla_pct"] = pct
            lo, hi = DRIFT_BAND_PCT
            rec["drift"] = not (lo <= pct <= hi)
        else:
            rec["model_vs_xla_pct"] = None
            rec["drift"] = None
        _set_gauges(rec.get("site", "unknown"), rec, registry)
    except Exception:
        pass
    return rec


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The allocator and card memory of a CUDA device (default: the
    current one) in :data:`_DEVICE_MEMORY_KEYS`, from
    ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``; None
    without a CUDA device. Never raises."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        free, total = torch.cuda.mem_get_info(device)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_free": int(free),
            "bytes_limit": int(total),
        }
    except Exception:
        return None


def record_memory_gauges(registry=None, device=None) -> Optional[dict]:
    """Set ``device_<key>`` gauges from :func:`device_memory_stats` into
    ``registry`` (default: the driver-side ``obs.registry()``). Without a
    CUDA device this sets nothing and returns None. Never raises."""
    stats = device_memory_stats(device)
    if stats is None:
        return None
    try:
        if registry is None:
            from tpu_stencil_torch.obs import tracing

            registry = tracing.registry()
        for key in _DEVICE_MEMORY_KEYS:
            if key in stats:
                registry.gauge(f"device_{key}").set(stats[key])
    except Exception:
        return None
    return stats
