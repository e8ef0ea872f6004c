"""Where the network tier's time goes: one closed-loop load through
``python -m tpu_stencil_torch net`` (its own process, real sockets) under
a few variants, beside the same load on an in-process ``StencilServer``,
all in one call on one card.

Variants (each a fresh ``net`` process, ``--backend pallas``):

* ``in_process``: the load on a ``StencilServer`` in this process;
* ``http``: the ``net`` defaults, the client checking each result's CRC
  stamp (``HttpTarget(verify="crc")``, which also sends a claim);
* ``http_noverify``: the same with no client-side CRC;
* ``http_reps0``: the same requests at 0 reps (transport and host copies
  only: no kernel runs);
* ``http_nointegrity``: ``--no-integrity`` (no claim check, no stamp, no
  witness);
* ``http_nointegrity_nocoalesce``: also ``--coalesce-window-us 0``;
* ``http_backlog128``: the defaults with the listening socket's backlog
  raised from socketserver's 5 to 128 (the server class attribute
  ``request_queue_size``, set in the ``net`` process before it starts):
  with more clients than the backlog opening a connection a request,
  a refused connect is retried by the client's TCP after about a second.

Each variant runs its load ``--runs`` times after one warm-up run (which
builds the programs and allocates the pinned slots), and reports each
run's requests/s, the client-side p50 and p99 (nearest rank over the
run's own requests) and how many requests took a second or more.

Usage:  python -m tpu_stencil_torch.tools.http_tax [--platform cpu]
            [--requests N] [--concurrency C] [--shape HxW] [--channels C]
            [--reps R] [--runs K] [--variants NAME,...] [--json PATH]
Output: one line per variant, then one JSON object with every run. On
the CPU (``--platform cpu``) it is a rehearsal: its numbers mean nothing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional

from tpu_stencil_torch.tools import _harness

# name -> (net flags, the client's verify mode, reps override, backlog)
VARIANTS = {
    "in_process": None,
    "http": ([], "crc", None, None),
    "http_noverify": ([], None, None, None),
    "http_reps0": ([], None, 0, None),
    "http_nointegrity": (["--no-integrity"], None, None, None),
    "http_nointegrity_nocoalesce": (
        ["--no-integrity", "--coalesce-window-us", "0"], None, None, None),
    "http_backlog128": ([], "crc", None, 128),
}

# Starts ``net`` with the listening socket's backlog set first.
_BACKLOG_MAIN = (
    "import sys; from tpu_stencil_torch.net import http; "
    "http._NetHTTPServer.request_queue_size = int(sys.argv[1]); "
    "from tpu_stencil_torch import cli; sys.exit(cli.main(sys.argv[2:]))"
)


def _nearest_rank(vals, p: float) -> float:
    vals = sorted(vals)
    k = min(len(vals) - 1, max(0, int(round(p / 100.0 * (len(vals) - 1)))))
    return vals[k]


def _runs(target, load: dict, runs: int) -> List[dict]:
    from tpu_stencil_torch.serve import loadgen

    out = []
    for i in range(runs + 1):  # run 0 warms the programs and the slots
        r = loadgen.run(target, per_request=True, **load)
        if i:
            lat = [q["latency_s"] for q in r["per_request"]]
            out.append({"throughput_rps": r["throughput_rps"],
                        "p50_s": _nearest_rank(lat, 50),
                        "p99_s": _nearest_rank(lat, 99),
                        "over_1s": sum(t >= 1.0 for t in lat),
                        "completed": r["completed"]})
    return out


def _http(flags, verify, load: dict, runs: int, platform,
          backlog: Optional[int]) -> List[dict]:
    from tpu_stencil_torch.serve import loadgen

    start = ([sys.executable, "-m", "tpu_stencil_torch"] if backlog is None
             else [sys.executable, "-c", _BACKLOG_MAIN, str(backlog)])
    argv = start + ["net", "--port", "0", "--backend", "pallas",
                    "--flightrec-dir", "none", "--prof-dir", "none"] + flags
    if platform == "cpu":
        argv += ["--platform", "cpu"]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        if "net: serving on http://" not in line:
            raise RuntimeError(f"net did not start: {line!r}")
        target = loadgen.HttpTarget(line.split()[3], verify=verify)
        try:
            return _runs(target, load, runs)
        finally:
            target.close()
    finally:
        proc.terminate()
        proc.wait(timeout=120)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpu_stencil_torch.tools.http_tax",
                                description=__doc__.splitlines()[0])
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--shape", default="1920x2520", help="H x W")
    p.add_argument("--channels", type=int, default=3, choices=[1, 3])
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--json", default=None, metavar="PATH")
    ns = p.parse_args(argv)
    names = ns.variants.split(",")
    bad = [n for n in names if n not in VARIANTS]
    if bad:
        p.error(f"unknown variant(s) {bad}; expected some of "
                f"{','.join(VARIANTS)}")
    try:
        shape = _harness.parse_shape(ns.shape)
    except ValueError as e:
        p.error(str(e))
    dev = _harness.device_for(ns.platform, p.prog)
    if dev is None:
        return 2
    print(f"http_tax on {_harness.describe(dev)}", flush=True)
    base = dict(mode="closed", requests=ns.requests,
                concurrency=ns.concurrency, shapes=[shape],
                channels=[ns.channels], seed=0)
    out = {}
    for name in names:
        if VARIANTS[name] is None:
            from tpu_stencil_torch.config import ServeConfig
            from tpu_stencil_torch.serve.engine import StencilServer

            with StencilServer(ServeConfig(backend="pallas"),
                               device=dev) as server:
                out[name] = _runs(server, dict(base, reps=ns.reps), ns.runs)
        else:
            flags, verify, reps, backlog = VARIANTS[name]
            load = dict(base, reps=ns.reps if reps is None else reps)
            out[name] = _http(flags, verify, load, ns.runs, ns.platform,
                              backlog)
        print(name, " ".join(
            f"{r['throughput_rps']:.2f}rps/p50={r['p50_s'] * 1e3:.1f}ms/"
            f"p99={r['p99_s'] * 1e3:.1f}ms/over1s={r['over_1s']}"
            for r in out[name]), flush=True)
    doc = {"device": _harness.describe(dev), "shape": list(shape),
           "channels": ns.channels, "reps": ns.reps,
           "requests": ns.requests, "concurrency": ns.concurrency,
           "variants": out}
    if ns.json:
        with open(ns.json, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
