"""Perf-regression sentry: persistent capture history + gate.

The port's counterpart of the JAX package's ``obs/sentry.py``: the same
record format, key fields, baseline and gate, so a history line written
by either package is read and gated by the other. It keeps a versioned
JSONL history of comparable runs and gates new ones against it:

* **Record**: one JSON line per run, ``schema_version``-ed, keyed on the
  capture's identity (metric, filter, shape, dtype, backend, platform,
  block_h, fuse). Two runs compare iff every key field matches: a
  geometry A/B or a backend flip is a different series, never a false
  regression.
* **Baseline**: the median of the last K same-key runs, requiring
  ``MIN_SAMPLES`` prior runs; a short history degrades to a
  "no-baseline" verdict, it never raises and never gates.
* **Gate**: ``check`` compares the new run's seconds against the
  baseline; slower by more than ``threshold`` (fractional) is a
  regression, and ``python -m tpu_stencil_torch perf check`` exits 1.

``serve --perf-log`` appends the loadgen p50. The history file defaults
to ``docs/PERF_HISTORY.jsonl`` at the repo root (override: ``--history``
or ``TPU_STENCIL_TORCH_PERF_HISTORY``). Bench captures are read by the
inline last-headline scan (``--from-bench``).

Torch-free: ``perf`` invocations parse and exit without touching a
device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time
from typing import List, Optional, Tuple

SCHEMA_VERSION = 1
# A record's identity: runs compare only within one exact key.
KEY_FIELDS = ("metric", "filter", "shape", "dtype", "backend", "platform",
              "block_h", "fuse")
DEFAULT_K = 5           # baseline window: median of the last K same-key runs
MIN_SAMPLES = 2         # fewer prior runs than this -> "no-baseline"
DEFAULT_THRESHOLD = 0.20  # fractional slowdown that counts as a regression

_CAPTURE_SHAPE_RE = re.compile(r"^(\d+x\d+)")
_CAPTURE_REPS_RE = re.compile(r"_(\d+)reps?_")


ENV_HISTORY = "TPU_STENCIL_TORCH_PERF_HISTORY"


def history_path(path: Optional[str] = None) -> str:
    """Resolve the history file: explicit arg, then the
    ``TPU_STENCIL_TORCH_PERF_HISTORY`` env override, then
    ``docs/PERF_HISTORY.jsonl`` at the repo root."""
    if path:
        return path
    env = os.environ.get(ENV_HISTORY)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "docs", "PERF_HISTORY.jsonl")


def make_record(metric: str, value: float, *, filter_name: str,
                shape: str, dtype: str = "uint8", backend: str,
                platform: str, block_h: Optional[int] = None,
                fuse: Optional[int] = None,
                per_rep_s: Optional[float] = None,
                source: str = "manual",
                extra: Optional[dict] = None) -> dict:
    """Build one history record. ``value`` is the headline seconds;
    ``per_rep_s``, when given, is what same-key comparisons use (bench
    records carry both; manual/serve records usually just ``value``)."""
    value = float(value)
    if not value > 0:
        raise ValueError(f"value must be positive seconds, got {value!r}")
    if per_rep_s is not None and not float(per_rep_s) > 0:
        raise ValueError(f"per_rep_s must be positive, got {per_rep_s!r}")
    rec = {
        "schema_version": SCHEMA_VERSION,
        "ts_unix": round(time.time(), 3),
        "metric": str(metric),
        "filter": str(filter_name),
        "shape": str(shape).lower(),
        "dtype": str(dtype),
        "backend": str(backend),
        "platform": str(platform),
        "block_h": None if block_h is None else int(block_h),
        "fuse": None if fuse is None else int(fuse),
        "value": value,
        "unit": "s",
        "source": str(source),
    }
    if per_rep_s is not None:
        rec["per_rep_s"] = float(per_rep_s)
    if extra:
        rec["extra"] = dict(extra)
    return rec


def record_from_capture(obj: dict, source: str = "bench") -> dict:
    """Convert a bench capture line (the stdout contract object) into a
    history record. Newer captures carry explicit ``shape`` /
    ``reps`` fields; older files fall back to parsing the metric name
    (``1920x2520_rgb_40reps_...``). Raises ValueError on a non-capture."""
    if not isinstance(obj, dict) or not isinstance(
            obj.get("value"), (int, float)):
        raise ValueError("not a capture object (no numeric 'value')")
    metric = str(obj.get("metric", "bench.compute_wall_clock"))
    shape = obj.get("shape")
    if not shape:
        m = _CAPTURE_SHAPE_RE.match(metric)
        shape = m.group(1) if m else "unknown"
    reps = obj.get("reps")
    if not reps:
        m = _CAPTURE_REPS_RE.search(metric)
        reps = int(m.group(1)) if m else None
    value = float(obj["value"])
    backend = str(obj.get("backend", "unknown"))
    block_h = fuse = None
    if backend == "pallas":
        block_h = obj.get("pallas_block_h")
        fuse = obj.get("pallas_fuse")
    # Multichip captures carry mesh/n_devices/overlap, mesh-fan stream and
    # serve captures the throughput and per-device riders. The mesh/fan
    # width and the resolved overlap mode are already folded into the
    # metric name (a key field: each combination is its own series), so
    # here they ride along as provenance only.
    extra = {
        k: obj[k]
        for k in ("hbm_gbps", "mesh", "n_devices", "overlap",
                  "frames_per_second", "per_device_frames_per_second",
                  "per_device_frames", "pipeline_depth",
                  "requests_per_second") if k in obj
    }
    return make_record(
        metric=metric, value=value,
        per_rep_s=(value / reps) if reps else None,
        filter_name=str(obj.get("filter", "gaussian")), shape=str(shape),
        dtype=str(obj.get("dtype", "uint8")), backend=backend,
        platform=str(obj.get("platform", "unknown")),
        block_h=block_h, fuse=fuse, source=source,
        extra=extra or None,
    )


def record_key(rec: dict) -> Tuple:
    return tuple(rec.get(f) for f in KEY_FIELDS)


def metric_value(rec: dict) -> Optional[float]:
    """The number same-key runs compare on: ``per_rep_s`` when present
    (bench records), else the headline ``value``."""
    for field in ("per_rep_s", "value"):
        v = rec.get(field)
        if isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0:
            return float(v)
    return None


def append(rec: dict, path: Optional[str] = None) -> str:
    """Append one record as a JSONL line; returns the resolved path."""
    path = history_path(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec, sort_keys=True) + "\n")
    return path


def load(path: Optional[str] = None) -> List[dict]:
    """All parseable records, in file order. A missing file is an empty
    history; a corrupt line is skipped (one bad write must not poison
    the whole trajectory)."""
    path = history_path(path)
    out: List[dict] = []
    try:
        fh = open(path)
    except OSError:
        return out
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and metric_value(obj) is not None:
                out.append(obj)
    return out


def baseline(history: List[dict], key: Tuple, k: int = DEFAULT_K,
             min_samples: int = MIN_SAMPLES) -> Optional[float]:
    """Median of the last ``k`` same-key runs' comparison values, or
    None when fewer than ``min_samples`` exist (short history degrades
    to "no baseline", it never gates on noise)."""
    vals = [metric_value(r) for r in history if record_key(r) == key]
    vals = [v for v in vals if v is not None]
    if len(vals) < max(1, min_samples):
        return None
    return statistics.median(vals[-k:])


def check(rec: dict, history: Optional[List[dict]] = None,
          path: Optional[str] = None, threshold: float = DEFAULT_THRESHOLD,
          k: int = DEFAULT_K, min_samples: int = MIN_SAMPLES) -> dict:
    """Verdict for one new run against the same-key baseline:
    ``status`` is ``no-baseline`` | ``ok`` | ``improvement`` |
    ``regression`` (current > baseline * (1 + threshold)). The new run
    is NOT appended here — log after checking, so a run never dilutes
    its own baseline."""
    if history is None:
        history = load(path)
    key = record_key(rec)
    n = sum(1 for r in history if record_key(r) == key)
    cur = metric_value(rec)
    base = baseline(history, key, k=k, min_samples=min_samples)
    verdict = {
        "key": {f: rec.get(f) for f in KEY_FIELDS},
        "n_history": n,
        "k": k,
        "current": cur,
        "baseline": base,
        "ratio": (cur / base) if (base and cur) else None,
        "threshold": threshold,
    }
    if base is None or cur is None:
        verdict["status"] = "no-baseline"
    elif cur > base * (1.0 + threshold):
        verdict["status"] = "regression"
    elif cur < base * (1.0 - threshold):
        verdict["status"] = "improvement"
    else:
        verdict["status"] = "ok"
    return verdict


def render_verdict(verdict: dict) -> str:
    k = verdict["key"]
    ident = (f"{k['metric']} [{k['filter']} {k['shape']} {k['dtype']} "
             f"{k['backend']}/{k['platform']}"
             + (f" bh={k['block_h']} fz={k['fuse']}"
                if k.get("block_h") is not None or k.get("fuse") is not None
                else "") + "]")
    if verdict["status"] == "no-baseline":
        return (f"perf {ident}: no baseline "
                f"({verdict['n_history']} prior same-key run(s); "
                f"need {MIN_SAMPLES}) — not gated")
    pct = 100.0 * (verdict["ratio"] - 1.0)
    k = verdict.get("k", DEFAULT_K)
    return (f"perf {ident}: {verdict['status'].upper()} "
            f"current={verdict['current']:.6g}s "
            f"baseline={verdict['baseline']:.6g}s "
            f"({pct:+.1f}% vs median of last {min(verdict['n_history'], k)}, "
            f"threshold {verdict['threshold'] * 100:.0f}%)")


def render_report(history: List[dict], k: int = DEFAULT_K) -> str:
    """Per-key trajectory table: run count, latest, baseline median,
    best, latest-vs-baseline."""
    if not history:
        return "(empty perf history)\n"
    by_key: dict = {}
    for r in history:
        by_key.setdefault(record_key(r), []).append(r)
    lines = [f"{'series':<58} {'runs':>4} {'latest':>11} "
             f"{'median':>11} {'best':>11} {'vs med':>8}"]
    lines.append("-" * len(lines[0]))
    for key, recs in sorted(by_key.items(), key=lambda kv: str(kv[0])):
        vals = [v for v in (metric_value(r) for r in recs) if v is not None]
        if not vals:
            continue
        kd = dict(zip(KEY_FIELDS, key))
        geo = ("" if kd["block_h"] is None and kd["fuse"] is None
               else f" {kd['block_h']}x{kd['fuse']}")
        ident = (f"{kd['metric']}|{kd['filter']}|{kd['shape']}|"
                 f"{kd['backend']}/{kd['platform']}{geo}")
        med = statistics.median(vals[-k:])
        latest = vals[-1]
        lines.append(
            f"{ident:<58} {len(vals):>4} {latest:>11.6g} {med:>11.6g} "
            f"{min(vals):>11.6g} {100 * (latest / med - 1):>+7.1f}%"
        )
    return "\n".join(lines) + "\n"


# -- CLI: python -m tpu_stencil_torch perf {log,check,report} ----------


def _load_capture_file(path: str) -> dict:
    """The last parseable headline capture in a bench stdout / preview
    file: the last JSON object with a numeric ``value`` that is not a
    phase rider."""
    best = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if (isinstance(obj, dict)
                    and isinstance(obj.get("value"), (int, float))
                    and "phase" not in obj):
                best = obj
    if best is None:
        raise ValueError(f"no parseable capture line in {path}")
    return best


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_stencil_torch perf",
        description="Perf-regression sentry over a persistent JSONL "
                    "capture history.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("--history", default=None, metavar="PATH",
                        help="history file (default: env "
                             f"{ENV_HISTORY} or docs/PERF_HISTORY.jsonl)")

    def add_record_flags(sp):
        sp.add_argument("--from-bench", default=None, metavar="FILE",
                        help="build the record from a bench stdout / "
                             "preview JSON file instead of flags")
        sp.add_argument("--metric", default="compute_seconds",
                        help="metric name (key field; default "
                             "compute_seconds)")
        sp.add_argument("--value", type=float, default=None,
                        help="headline seconds of the new run")
        sp.add_argument("--per-rep-s", dest="per_rep_s", type=float,
                        default=None,
                        help="per-repetition seconds (preferred for "
                             "comparison when given)")
        sp.add_argument("--filter", dest="filter_name", default="gaussian")
        sp.add_argument("--shape", default=None, help="WxH (key field)")
        sp.add_argument("--dtype", default="uint8")
        sp.add_argument("--backend", default="xla")
        sp.add_argument("--platform", default="cpu")
        sp.add_argument("--block-h", dest="block_h", type=int, default=None)
        sp.add_argument("--fuse", type=int, default=None)
        sp.add_argument("--source", default="manual")

    lg = sub.add_parser("log", help="append one run to the history")
    add_common(lg)
    add_record_flags(lg)

    ck = sub.add_parser(
        "check",
        help="gate one run against the same-key baseline "
             "(exit 1 on regression)")
    add_common(ck)
    add_record_flags(ck)
    ck.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help=f"fractional slowdown that fails "
                         f"(default {DEFAULT_THRESHOLD})")
    ck.add_argument("--k", type=int, default=DEFAULT_K,
                    help=f"baseline = median of last K same-key runs "
                         f"(default {DEFAULT_K})")
    ck.add_argument("--min-samples", type=int, default=MIN_SAMPLES,
                    help=f"prior runs required before gating "
                         f"(default {MIN_SAMPLES})")
    ck.add_argument("--log", action="store_true",
                    help="also append this run to the history (after "
                         "the verdict is computed)")
    ck.add_argument("--json", action="store_true",
                    help="print the verdict as JSON instead of text")

    rp = sub.add_parser("report", help="print the per-key trajectory")
    add_common(rp)
    rp.add_argument("--k", type=int, default=DEFAULT_K)
    return p


def _record_from_ns(parser, ns) -> dict:
    if ns.from_bench:
        try:
            return record_from_capture(_load_capture_file(ns.from_bench))
        except (OSError, ValueError) as e:
            parser.error(f"--from-bench: {e}")
    if ns.value is None or ns.shape is None:
        parser.error("need --value and --shape (or --from-bench FILE)")
    try:
        return make_record(
            metric=ns.metric, value=ns.value, per_rep_s=ns.per_rep_s,
            filter_name=ns.filter_name, shape=ns.shape, dtype=ns.dtype,
            backend=ns.backend, platform=ns.platform,
            block_h=ns.block_h, fuse=ns.fuse, source=ns.source,
        )
    except ValueError as e:
        parser.error(str(e))


def main(argv=None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    if ns.cmd == "report":
        print(render_report(load(ns.history), k=ns.k), end="")
        return 0
    rec = _record_from_ns(parser, ns)
    if ns.cmd == "log":
        path = append(rec, ns.history)
        print(f"perf history += {rec['metric']} "
              f"{metric_value(rec):.6g}s -> {path}")
        return 0
    # check
    verdict = check(rec, path=ns.history, threshold=ns.threshold,
                    k=ns.k, min_samples=ns.min_samples)
    if ns.log:
        append(rec, ns.history)
    if ns.json:
        print(json.dumps(verdict, sort_keys=True))
    else:
        print(render_verdict(verdict))
    return 1 if verdict["status"] == "regression" else 0


if __name__ == "__main__":
    sys.exit(main())
