"""Nothing the benchmark runs loads JAX, the JAX package or the repo's
``tools/``, by whole top-level name: the port's name begins with the JAX
package's, so a prefix test would be wrong."""

import subprocess
import sys

from benchmark.harness import cell, spec

PROBE = r"""
import sys, time
sys.path.insert(0, {root!r})
t0 = time.perf_counter()
import benchmark.run, benchmark.control
from benchmark.harness import arrivals, cell, spec
from benchmark.tests.conftest import SMALL
bench = spec.load()
for w in bench["workloads"]:
    for trace in (False, True):
        out = cell.run_cell(w["name"], 5, 0.2, trace, ["cpu"] * w["chips"],
                            t0, config_override=SMALL)
        assert out.correct, (w["name"], out.checks)
for m in bench["per_layer"]:
    spec.reader(m["name"])
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def test_whole_name_comparison():
    assert "tpu_stencil_torch".split(".")[0] not in cell.FORBIDDEN
    assert "tpu_stencil.ops".split(".")[0] in cell.FORBIDDEN


def test_a_run_of_every_cell_loads_no_forbidden_module():
    r = subprocess.run([sys.executable, "-c",
                        PROBE.format(root=str(spec.ROOT))],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    tops = set(r.stdout.split())
    assert "tpu_stencil_torch" in tops and "benchmark" in tops
    for bad in ("jax", "jaxlib", "flax", "tpu_stencil", "tools"):
        assert bad not in tops
