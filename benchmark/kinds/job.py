"""Kind ``job``: one client, back to back, on one card.

Set-up builds the model and ``driver.prepare_engine`` (the kernels built
and warmed for the window's one call of ``reps`` reps), then runs one job
through the window's own calls. Each job of the window hands a ring image
in pinned host memory to ``Engine.step_fn``, which places it on the card
and runs ``reps`` reps, and copies the result into a pinned host buffer.
File I/O is left out, as the upstream program's "Execution time" leaves it
out. Pinned buffers on both sides: ``Engine.fetch`` and the placement of a
numpy image go through pageable memory, whose copies run 15-20% apart
from one process to the next on the card's host, more than a bound can
hold (PERF.md). The check keeps an output by taking its pinned buffer
(:class:`~benchmark.harness.cell.Sampler`), so it copies nothing in the
window.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import inputs
from benchmark.harness.cell import Window


def model(env, device):
    """The port's model on the hand-written kernels: ``pallas`` (the
    CLI's ``--backend cuda``), not ``auto``, whose verdict is a
    measurement that could differ from one checkout to the next."""
    from tpu_stencil_torch.models.blur import IteratedConv2D

    return IteratedConv2D(env.config["filter"]["name"], backend="pallas",
                          boundary=env.config["boundary"], device=device)


def host_buffers(images, device, n_out):
    """Page-locked host copies of ``images`` when ``device`` is a card,
    and ``n_out`` page-locked outputs of their shape."""
    import torch

    pin = device.type == "cuda"
    ins = [torch.from_numpy(np.ascontiguousarray(im)) for im in images]
    if pin:
        ins = [t.pin_memory() for t in ins]
    outs = [torch.empty(ins[0].shape, dtype=torch.uint8, pin_memory=pin)
            for _ in range(n_out)]
    return ins, outs


def fetch_into(out, y) -> None:
    """The result ``y`` into the host buffer ``out``, waited for."""
    import torch

    out.copy_(y, non_blocking=True)
    if y.is_cuda:
        torch.cuda.current_stream(y.device).synchronize()


def setup(env):
    from tpu_stencil_torch import driver

    reps = env.traffic["reps"]
    ring = len(env.ring)
    ins, outs = host_buffers(env.ring, env.devices[0],
                             2 * ring + env.sampler.k)
    outs, env.sampler.spares = outs[:ring], outs[ring:]
    engine = driver.prepare_engine(model(env, env.devices[0]), env.ring[0],
                                   calls=[reps])
    fetch_into(outs[0], engine.step_fn(ins[0], reps))
    return {"engine": engine, "ins": ins, "outs": outs}


def window(env, state) -> Window:
    engine = state["engine"]
    ins, outs = state["ins"], state["outs"]
    reps = env.traffic["reps"]
    t_end = time.perf_counter() + env.seconds
    done = i = 0
    while time.perf_counter() < t_end:
        slot = i % len(ins)
        with env.tracer.span("step"):
            y = engine.step_fn(ins[slot], reps)
        with env.tracer.span("fetch"):
            fetch_into(outs[slot], y)
        if time.perf_counter() <= t_end:
            done += 1
        outs[slot] = env.sampler.offer(i, outs[slot])
        i += 1
    return Window(attempted=i, failed=0, done=done, end_to_end={
        "mpx_per_s": done * inputs.megapixels(env.config) / env.seconds})


def close(env, state) -> None:
    state.clear()
