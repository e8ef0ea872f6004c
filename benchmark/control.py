"""The check's control, at a cell's own size: the reference put in the
program's place, computed in a precision below the configuration's exact
integer arithmetic (the taps summed in float16 or bfloat16), judged by the
same check as a run's outputs.

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 \\
        [--accumulate float16] [--device cuda]

One line of JSON a seed: the numbers the check compares. The control has
to come out not correct (``mismatched_bytes`` above its limit of 0) on
every seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def control_checks(workload: str, seed: int, accumulate: str, device: str,
                   config_override=None, root=None, bench=None) -> dict:
    """The check's numbers when the control's outputs stand in for the
    program's: as many outputs as a run compares, of the same inputs."""
    import torch

    from benchmark.harness import cell, inputs, spec
    from benchmark.harness.trace import Tracer
    from benchmark.reference import stencil as reference

    if bench is None:
        bench = spec.load(root)
    w = spec.cell(bench, workload)
    config = dict(spec.config(bench, w["config"], root))
    config.update(config_override or {})
    traffic = spec.traffic(w["traffic"], root)
    seed = seed % (1 << 64)
    ring = inputs.ring(config, seed, traffic["ring"])
    env = cell.Env(config, traffic, seed, 0.0, [torch.device(device)],
                   Tracer(False, False), ring,
                   cell.Sampler(seed, traffic["ring"], traffic["samples"]))
    filt = config["filter"]
    outs = {}
    for i in range(traffic["ring"] + traffic["samples"]):
        slot = i % len(ring)
        if slot not in outs:
            outs[slot] = reference.iterate(
                ring[slot], filt["taps"], filt["divisor"], traffic["reps"],
                device, accumulate=getattr(torch, accumulate))
        env.sampler.offer(i, outs[slot])
    return cell.check(env, traffic["reps"], device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--accumulate", default="float16")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    for s in a.seeds.split(","):
        checks = control_checks(a.workload, int(s), a.accumulate, a.device)
        print(json.dumps({"workload": a.workload, "seed": int(s),
                          "accumulate": a.accumulate, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
