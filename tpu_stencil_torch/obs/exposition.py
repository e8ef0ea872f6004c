"""Prometheus-style text exposition for metric registry snapshots.

The port's copy of the JAX package's ``obs/exposition.py``, semantics
unchanged, so one scraper and one parser read both packages.

One render path for every registry in the repo: the serve engine's
(``StencilServer.stats()``) and the driver-side obs registry
(``obs.snapshot()``) both produce the same
``{counters, gauges, histograms, <scalars>}`` dict shape, and
:func:`render_text` turns it into the text format scrapers ingest:

* counters  -> ``<prefix>_<name> <int>``
* gauges    -> value plus the high-water mark as ``{stat="peak"}``
* histograms-> OpenMetrics-style ``_bucket{le="..."}`` cumulative
  series (with a ``# {trace_id="..."} <value>`` exemplar suffix on
  buckets that have one), ``{quantile="0.5"|"0.99"}`` reservoir
  samples, plus ``_count``/``_sum``/``_mean``/``_max`` series
* bare scalars (e.g. ``executables_cached``) -> an untyped gauge

:func:`parse_text` is the exact inverse — ``parse_text(render_text(s))
== s`` for any snapshot (floats are emitted with ``repr``, which
round-trips exactly in Python; bucket label strings pass through
verbatim) — so tests can assert no metric is dropped, and downstream
tooling (the federation's member-scrape fold) has a reference parser.
"""

from __future__ import annotations

import re
from typing import Dict

_QUANTILES = (("0.5", "p50"), ("0.99", "p99"))
_HIST_FIELDS = ("count", "sum", "mean", "max")
_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$'
)
# The exemplar suffix of a bucket line (OpenMetrics shape, trace_id
# label only): `... # {trace_id="<hex>"} <value>`.
_EXEMPLAR_RE = re.compile(
    r'^\{trace_id="(?P<tid>[^"]*)"\}\s+(?P<value>\S+)$'
)


def _le_sort_key(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def _num(v) -> str:
    # repr() round-trips floats exactly; ints print as ints.
    return repr(float(v)) if isinstance(v, float) else repr(int(v))


def render_text(snapshot: dict, prefix: str = "tpu_stencil",
                notes=()) -> str:
    """Render a registry snapshot dict as Prometheus-style text.

    ``notes``: informational comment lines (``# NOTE ...``) emitted at
    the top — used to state *why* an expected metric family is absent
    (e.g. device-memory gauges on a backend without allocator stats),
    so "unavailable" is visible in the scrape, not just missing.
    Comments are ignored by :func:`parse_text`, preserving the exact
    round-trip."""
    out = [f"# NOTE {n}" for n in notes]

    def emit(kind, name, lines):
        out.append(f"# TYPE {prefix}_{name} {kind}")
        out.extend(lines)

    for name, v in sorted(snapshot.get("counters", {}).items()):
        emit("counter", name, [f"{prefix}_{name} {_num(v)}"])
    for name, g in sorted(snapshot.get("gauges", {}).items()):
        emit("gauge", name, [
            f"{prefix}_{name} {_num(g['value'])}",
            f'{prefix}_{name}{{stat="peak"}} {_num(g["peak"])}',
        ])
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        buckets = h.get("buckets")
        exemplars = h.get("exemplars", {})
        lines = []
        if buckets is not None:
            for le in sorted(buckets, key=_le_sort_key):
                line = (f'{prefix}_{name}_bucket{{le="{le}"}} '
                        f'{_num(buckets[le])}')
                ex = exemplars.get(le)
                if ex:
                    line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                             f'{_num(ex["value"])}')
                lines.append(line)
        lines += [
            f'{prefix}_{name}{{quantile="{q}"}} {_num(h[key])}'
            for q, key in _QUANTILES
        ]
        lines += [
            f"{prefix}_{name}_{field} {_num(h[field])}"
            for field in _HIST_FIELDS
        ]
        # Bucketed histograms (every Registry histogram since the
        # fixed-bucket change) expose the OpenMetrics `histogram` kind;
        # bucketless dicts (older member payloads crossing the fed
        # fold) stay `summary`.
        emit("histogram" if buckets is not None else "summary",
             name, lines)
    for name, v in sorted(snapshot.items()):
        if name in ("counters", "gauges", "histograms"):
            continue
        # Bare scalar riders on the snapshot (executables_cached).
        emit("untyped", name, [f"{prefix}_{name} {_num(v)}"])
    return "\n".join(out) + "\n"


def write_text(path: str, snapshot: dict,
               prefix: str = "tpu_stencil", notes=()) -> None:
    """Render ``snapshot`` and write it to ``path`` (``'-'`` = stdout,
    with no trailing "wrote" line). The one place the CLIs' shared
    '-'-vs-file contract lives."""
    text = render_text(snapshot, prefix, notes=notes)
    if path == "-":
        print(text, end="")
    else:
        with open(path, "w") as fh:
            fh.write(text)
        print(f"wrote {path}")


def parse_text(text: str, prefix: str = "tpu_stencil") -> dict:
    """Inverse of :func:`render_text`: rebuild the snapshot dict."""
    types: Dict[str, str] = {}
    snap: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    strip = prefix + "_"

    def short(name: str) -> str:
        if not name.startswith(strip):
            raise ValueError(f"metric {name!r} lacks prefix {prefix!r}")
        return name[len(strip):]

    def value(s: str):
        f = float(s)
        return int(f) if f.is_integer() and "." not in s else f

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.rpartition(" ")
            types[short(name)] = kind
            continue
        if line.startswith("#"):
            continue
        # Peel a bucket exemplar suffix off before the full-line sample
        # match (OpenMetrics: `<sample> # {trace_id="..."} <value>`).
        exemplar = None
        if " # " in line:
            line, _, ex_part = line.partition(" # ")
            em = _EXEMPLAR_RE.match(ex_part.strip())
            if not em:
                raise ValueError(f"unparseable exemplar: {ex_part!r}")
            exemplar = {"trace_id": em["tid"], "value": value(em["value"])}
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labels, val = short(m["name"]), m["labels"], value(m["value"])
        # A sample's base metric: the longest registered TYPE that is the
        # name or a _field suffix of it.
        if name in types:
            base, field = name, None
        else:
            base, _, field = name.rpartition("_")
            if base not in types:
                raise ValueError(f"sample {name!r} has no TYPE line")
        kind = types[base]
        if kind == "counter":
            snap["counters"][base] = value(m["value"])
        elif kind == "gauge":
            g = snap["gauges"].setdefault(base, {})
            g["peak" if labels and "peak" in labels else "value"] = val
        elif kind in ("summary", "histogram"):
            h = snap["histograms"].setdefault(base, {})
            labmap = dict(
                (kv.split("=")[0], kv.split("=")[1].strip('"'))
                for kv in labels.split(",")
            ) if labels else {}
            if field == "bucket" and "le" in labmap:
                le = labmap["le"]
                h.setdefault("buckets", {})[le] = val
                if exemplar is not None:
                    h.setdefault("exemplars", {})[le] = exemplar
            elif labels:
                q = labmap["quantile"]
                h[{"0.5": "p50", "0.99": "p99"}[q]] = val
            else:
                h[field] = val
        else:  # untyped scalar rider
            snap[base] = val
    return snap
