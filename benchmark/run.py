"""Run one cell of the benchmark once, on the cards of this machine.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown`` of the traced window, and last ``checks``:
each number the correctness check compared, beside its limit (also the
last lines of standard error). Exits 2, printing no result, without CUDA
or with fewer cards than the cell asks for; 3 when a JAX module was
loaded.

Every cache of the program lives inside the checkout, under
``build/``: the kernels in ``build/kernels/`` (built by ``nvcc`` on a
checkout's first run), the rest in ``build/benchmark/``.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        boot_s = time.clock_gettime(time.CLOCK_BOOTTIME)
        return max(0.0, boot_s - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def _environment() -> None:
    """Point the program's caches inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "benchmark"
    os.environ["TPU_STENCIL_TORCH_AUTOTUNE_CACHE"] = str(
        cache / "autotune.json")
    os.environ["TPU_STENCIL_TORCH_FLIGHTREC_DIR"] = str(cache / "flightrec")


def main(argv=None) -> int:
    t_start = _T_IMPORT - _process_age_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    sys.path[0] = str(ROOT)
    _environment()
    from benchmark.harness import cell as cell_mod
    from benchmark.harness import spec

    bench = spec.load()
    chips = spec.cell(bench, a.workload)["chips"]
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    out = cell_mod.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                            devices, t_start)
    loaded = cell_mod.forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    line = cell_mod.result_line(out, chips, torch.cuda.get_device_name(0))
    for name, c in out.checks.items():
        print(f"check {name} {c['value']} (limit {c['op']} {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
