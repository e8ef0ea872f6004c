"""Command-line entry point.

Reference-compatible invocation (``mpi/mpi_convolution.c:328-348``):

    python -m tpu_stencil_torch image.raw 1920 2520 40 rgb

prints the compute-window wall-clock (the reference's headline metric) and
writes ``blur_<input>``. It runs on the GPU; ``--platform cpu`` runs on the
CPU instead, and with no GPU and no ``--platform cpu`` it exits non-zero
with a message rather than running on the CPU.
"""

from __future__ import annotations

import sys

from tpu_stencil_torch import driver
from tpu_stencil_torch.config import parse_args
from tpu_stencil_torch.devices import NoDeviceError, resolve_devices


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    cfg, ns = parse_args(argv)
    try:
        devices = resolve_devices(ns.platform)
    except NoDeviceError as e:
        print(f"tpu_stencil_torch: error: {e}", file=sys.stderr)
        return 2
    result = driver.run_job(cfg, devices=devices)
    # Reference-format output line (mpi/mpi_convolution.c:274 prints seconds).
    print(f"Execution time: {result.compute_seconds:.3f} sec")
    if ns.time:
        sched = (
            f" schedule={result.schedule or 'default'}"
            if result.backend == "pallas" else ""
        )
        if result.block_h is not None:
            # Effective launched geometry (post align/clamp).
            sched += f" block_h={result.block_h} fuse={result.fuse}"
        launches = ",".join(f"{k}:{v}" for k, v in result.launches.items())
        if cfg.backend in ("auto", "autotune"):
            # Measurements the autotuner made before the compute window
            # (0 on a warm cache and off a card).
            launches += f" tune_probes={result.tune_probes}"
        print(
            f"total (incl. I/O): {result.total_seconds:.3f} sec; "
            f"backend={result.backend}{sched} mesh={result.mesh_shape} "
            f"launches={launches}"
        )
    print(f"wrote {result.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
