"""tpu_stencil_torch.ctrl — the elastic control plane (the JAX package's
``ctrl``).

The tiers below this one only *measure*: the net edge derives its
Retry-After from live queue state, ``/debug/capacity`` reports headroom
and time-to-saturation, and the federation survives host loss — but
capacity itself stays static and hand-operated. This package closes the
measure→decide→act loop:

- :mod:`tpu_stencil_torch.ctrl.planner` — hysteresis capacity planner: fed
  scrape signals in, typed scale-out / scale-in / replace decisions
  out, never flapping on one sample.
- :mod:`tpu_stencil_torch.ctrl.actuator` — the act half: a pluggable
  :class:`~tpu_stencil_torch.ctrl.actuator.HostProvider` (subprocess
  provider for CI/bench) starting and stopping ``net`` member hosts
  against the fed's ``/admin/register`` and sticky-drain machinery.
  Scale-in always drains before stop; a preemption notice is a
  *planned* drain with the replacement started before the victim
  exits. Members run on the card unless the CPU is asked for.
- :mod:`tpu_stencil_torch.ctrl.warmstart` — warm start: warm members ship
  their program-cache *keys*; a joining host rebuilds each entry from its
  own kernel sources and runs it once on its device before flipping
  ready, so its first real request is a program-cache hit. No binary
  crosses the wire.
- :mod:`tpu_stencil_torch.ctrl.cli` — ``python -m tpu_stencil_torch
  ctrl``.

The controller process never touches a device; its members do.
"""

from tpu_stencil_torch.ctrl.planner import (  # noqa: F401
    HOLD,
    REPLACE,
    SCALE_IN,
    SCALE_OUT,
    CapacityPlanner,
    CapacitySignal,
    Decision,
)
