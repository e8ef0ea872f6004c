"""On-demand profiler: bounded ``torch.profiler`` captures (the port's
counterpart of the JAX package's ``obs/prof.py``, which wraps
``jax.profiler``).

``POST /debug/prof?seconds=N`` on a serving tier runs one bounded capture
of the live process and spools its trace for ``GET /debug/prof/<path>``.
The capture records CPU activity, plus CUDA activity when a card is
present (CUPTI sees every kernel of the process, so the replicas' worker
threads' K1 launches show as ``stencil_fused_*`` kernels), and writes one
Chrome trace (``trace.json``) per capture, with the program's own spans
of the capture's window in it (:func:`~tpu_stencil_torch.obs.export.
add_profiled_spans`). The contract is the JAX
package's:

* **404-clean when unavailable**: :func:`available` is import-only; the
  HTTP layer asks it first and answers a typed 404, never a 500.
* **bounded**: the duration clamps to [0.05 s, 30 s]; one capture at a
  time (a second gets ``RuntimeError("busy")``, HTTP 409); the spool keeps
  at most :data:`SPOOL_CAP` capture directories, oldest pruned first.
* **path-safe**: :func:`spool_read` refuses any path that escapes the
  spool root.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import List, Optional, Tuple

#: Max capture directories kept in the spool.
SPOOL_CAP = 8

#: Capture duration clamp (seconds).
MIN_SECONDS = 0.05
MAX_SECONDS = 30.0

#: The trace file each capture writes.
TRACE_FILE = "trace.json"

_capture_lock = threading.Lock()


def available() -> Tuple[bool, str]:
    """(usable, reason): whether ``torch.profiler`` imports with its
    ``profile`` API. Import-only, no side effects."""
    try:
        import torch.profiler as _p
    except Exception as e:  # ImportError or any init-time failure
        return False, f"torch profiler unavailable: {type(e).__name__}"
    if not hasattr(_p, "profile") or not hasattr(_p, "ProfilerActivity"):
        return False, "torch.profiler lacks profile/ProfilerActivity"
    return True, ""


def _prune_spool(spool_dir: str) -> None:
    try:
        names = sorted(
            n for n in os.listdir(spool_dir)
            if os.path.isdir(os.path.join(spool_dir, n))
        )
    except OSError:
        return
    for n in names[:-SPOOL_CAP] if len(names) > SPOOL_CAP else ():
        shutil.rmtree(os.path.join(spool_dir, n), ignore_errors=True)


def _walk_files(root: str) -> List[dict]:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            try:
                size = os.path.getsize(p)
            except OSError:
                size = 0
            out.append({
                "path": os.path.relpath(p, os.path.dirname(root)),
                "bytes": size,
            })
    return out


def capture(seconds: float, spool_dir: str) -> dict:
    """Run one bounded capture into a fresh spool subdirectory.

    Returns ``{"run": name, "seconds": s, "files": [{path, bytes}]}``.
    Raises ``RuntimeError("busy")`` while a capture runs and
    ``RuntimeError(reason)`` when the profiler is unavailable; the HTTP
    layer maps those to 409 and 404."""
    ok, reason = available()
    if not ok:
        raise RuntimeError(reason)
    seconds = min(MAX_SECONDS, max(MIN_SECONDS, float(seconds)))
    if not _capture_lock.acquire(blocking=False):
        raise RuntimeError("busy")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from tpu_stencil_torch.obs import export

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        run = f"prof-{int(time.time() * 1e3)}"
        run_dir = os.path.join(spool_dir, run)
        os.makedirs(run_dir, exist_ok=True)
        t0_ns = time.time_ns()
        with profile(activities=activities) as prof:
            time.sleep(seconds)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        path = os.path.join(run_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        export.add_profiled_spans(path, t0_ns, time.time_ns())
        _prune_spool(spool_dir)
        return {
            "run": run,
            "seconds": seconds,
            "files": _walk_files(run_dir),
        }
    finally:
        _capture_lock.release()


def spool_list(spool_dir: Optional[str]) -> dict:
    """The ``GET /debug/prof`` index payload."""
    ok, reason = available()
    runs = []
    if spool_dir and os.path.isdir(spool_dir):
        for n in sorted(os.listdir(spool_dir)):
            d = os.path.join(spool_dir, n)
            if os.path.isdir(d):
                runs.append({"run": n, "files": _walk_files(d)})
    return {
        "schema_version": 1,
        "available": ok,
        "reason": reason,
        "spool_cap": SPOOL_CAP,
        "runs": runs,
    }


def spool_read(spool_dir: Optional[str], rel: str) -> Optional[bytes]:
    """One spooled file by its index-relative path; ``None`` on a miss or
    on any path that escapes the spool root."""
    if not spool_dir:
        return None
    root = os.path.realpath(spool_dir)
    path = os.path.realpath(os.path.join(root, rel))
    if path != root and not path.startswith(root + os.sep):
        return None
    if not os.path.isfile(path):
        return None
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError:
        return None
