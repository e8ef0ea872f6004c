"""Kind ``mesh``: one client, back to back, over an R x C mesh of cards.

The configuration's ``mesh`` gives the grid. Set-up builds the model and
the port's ``ShardedRunner`` over the grid's devices, taken in turn from
the cards the run is given (on the card, one each; a run given fewer
devices, as the CPU tests are, names them several times), splits each
ring image into a page-locked host tile grid, and runs one job through
the window's own calls. The runner takes the overlap schedule the port's
CLI gives ``--mesh`` by default (``JobConfig.overlap``), so a change of
that default is measured here.

Each job of the window hands a ring slot's tile grid to
``ShardedRunner.run_host``, which places every tile on its card behind a
non-blocking copy and runs ``reps`` reps with the halo exchange, then
fetches the tiles into a page-locked host tile grid. It is done when its
bytes are in host memory inside the window. The tiles are not stitched
in the window: each rank of the upstream program, and the port's
``distributed.write_sharded``, writes its own tile. The check keeps a
host tile grid (:class:`Tiles`) and stitches it only when it compares,
after the window.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark.harness import inputs
from benchmark.harness.cell import Window
from benchmark.kinds import job


class Tiles:
    """A host tile grid kept for the check; ``np.asarray`` stitches it
    and crops the pad."""

    def __init__(self, tiles, shape) -> None:
        self.tiles = tiles
        self.shape = shape   # the image's (H, W[, C])

    def __array__(self, dtype=None, copy=None):
        rows = [np.concatenate([t.numpy() for t in row], axis=1)
                for row in self.tiles]
        img = np.concatenate(rows, axis=0)[:self.shape[0], :self.shape[1]]
        return img if dtype is None else img.astype(dtype)


def overlap_default() -> str:
    """The overlap schedule a ``--mesh`` job runs unless told otherwise."""
    from tpu_stencil_torch.config import JobConfig

    return next(f.default for f in dataclasses.fields(JobConfig)
                if f.name == "overlap")


def setup(env):
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    cfg = env.config
    grid = tuple(cfg["mesh"])
    devices = [env.devices[k % len(env.devices)]
               for k in range(grid[0] * grid[1])]
    runner = ShardedRunner(job.model(env, devices[0]),
                           (cfg["height"], cfg["width"]), cfg["channels"],
                           mesh_shape=grid, devices=devices,
                           overlap=overlap_default())
    pin = devices[0].type == "cuda"
    shape = inputs.image_shape(cfg)
    ins = [runner.host_tiles(im, pin=pin) for im in env.ring]
    ring = len(ins)
    outs = [Tiles(runner.host_tiles(pin=pin), shape)
            for _ in range(2 * ring + env.sampler.k)]
    outs, env.sampler.spares = outs[:ring], outs[ring:]
    runner.prepare()
    runner.fetch_into(runner.run_host(ins[0], env.traffic["reps"]),
                      outs[0].tiles)
    return {"runner": runner, "ins": ins, "outs": outs}


def window(env, state) -> Window:
    runner = state["runner"]
    ins, outs = state["ins"], state["outs"]
    reps = env.traffic["reps"]
    t_end = time.perf_counter() + env.seconds
    done = i = 0
    while time.perf_counter() < t_end:
        slot = i % len(ins)
        with env.tracer.span("step"):
            y = runner.run_host(ins[slot], reps)
        with env.tracer.span("fetch"):
            runner.fetch_into(y, outs[slot].tiles)
        if time.perf_counter() <= t_end:
            done += 1
        outs[slot] = env.sampler.offer(i, outs[slot])
        i += 1
    return Window(attempted=i, failed=0, done=done, end_to_end={
        "mpx_per_s": done * inputs.megapixels(env.config) / env.seconds})


def close(env, state) -> None:
    state.clear()
