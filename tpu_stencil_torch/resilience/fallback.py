"""Graceful degradation ladder: demote the schedule/backend instead of
dying on a resource failure.

The port's counterpart of the JAX package's ``resilience/fallback.py``,
with its rungs and labels:

    pallas[deep]  ->  pallas  ->  xla   (-> xla@cpu with
                                          ``--fallback-backend cpu``)

``pallas[deep]`` is K2 (or K1 at the deep depth), ``pallas`` K1 at its
default geometry, ``xla`` the torch-ops lowering on the same device and
``xla@cpu`` the torch ops on the CPU. Every rung writes the same bytes, so
a demoted run is a slower correct run. Each demotion increments
``resilience_fallbacks_total``, records a ``resilience.demote`` span and
prints one stderr line.

:func:`ladder` gives the JAX package's rungs. A job walks
:func:`job_ladder`'s: on a CUDA card only the kernel-to-kernel step
(``pallas[deep]`` -> ``pallas``, K2 -> K1), so a kernel that fails on the
card fails the job, typed, and never becomes a torch-ops or CPU run; the
whole ladder only for a job that already runs on the CPU, where every
rung runs the plain versions.

:func:`demotable` decides which failures step the ladder, in the port's
own vocabulary of resource failures: the card ran out of memory
(``torch.cuda.OutOfMemoryError``), a launch asked for more than the card
has (a :class:`~tpu_stencil_torch.ops.cuda_stencil.KernelLaunchError`
whose CUDA code is :data:`RESOURCE_CODES`), and injected faults as in
the JAX package. A kernel that does not build (``KernelBuildError``), a
launch refused for any other reason, and a missing device
(``NoDeviceError``) never demote: they fail the job, and never become a
quiet torch-ops run.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

from tpu_stencil_torch.resilience.errors import InjectedFault

# cudaError_t codes of a launch that asked for more than the card has:
# cudaErrorMemoryAllocation (2), cudaErrorLaunchOutOfResources (701),
# cudaErrorCooperativeLaunchTooLarge (720).
RESOURCE_CODES = frozenset({2, 701, 720})


@dataclasses.dataclass(frozen=True)
class Rung:
    """One ladder step: the (backend, schedule) to try, optionally on a
    different platform (the CPU completion rung)."""

    backend: str
    schedule: Optional[str] = None
    platform: Optional[str] = None

    @property
    def label(self) -> str:
        name = self.backend
        if self.schedule:
            name += f"[{self.schedule}]"
        if self.platform:
            name += f"@{self.platform}"
        return name


def ladder(backend: str, schedule: Optional[str] = None,
           fallback_backend: Optional[str] = None) -> Tuple[Rung, ...]:
    """The demotion sequence for a requested configuration, most capable
    first: a forced schedule drops first (deep -> K1's default), then the
    backend drops to torch ops. ``fallback_backend='cpu'`` appends the
    opt-in CPU rung. The port's backend spellings ``cuda``/``torch`` name
    ``pallas``/``xla``."""
    from tpu_stencil_torch.config import canonical_backend

    backend = canonical_backend(backend)
    rungs = [Rung(backend, schedule)]
    if backend in ("auto", "autotune", "pallas"):
        if schedule is not None:
            # Same backend, default schedule: the failure may be the
            # schedule's (K2's cooperative grid), not the kernel's.
            rungs.append(Rung(backend, None))
        rungs.append(Rung("xla", None))
    if fallback_backend == "cpu":
        rungs.append(Rung("xla", None, platform="cpu"))
    # Dedupe consecutive equal rungs (e.g. backend='xla' with a cpu rung).
    out = [rungs[0]]
    for r in rungs[1:]:
        if r != out[-1]:
            out.append(r)
    return tuple(out)


def job_ladder(backend: str, schedule: Optional[str],
               fallback_backend: Optional[str],
               device) -> Tuple[Rung, ...]:
    """The rungs a job on ``device`` walks: :func:`ladder`'s on the CPU;
    on a card the requested rung and the kernel rungs under it, never
    ``xla`` nor ``xla@cpu``. ``fallback_backend='cpu'`` on a card raises
    ``ValueError``: the port never moves a card job's work to the CPU."""
    import torch

    rungs = ladder(backend, schedule, fallback_backend)
    if torch.device(device).type == "cpu":
        return rungs
    if fallback_backend == "cpu":
        raise ValueError(
            "--fallback-backend cpu would move the job's work off the card "
            f"({device}); a card job demotes only from K2 to K1 and "
            "otherwise fails typed. Run the whole job with --platform cpu "
            "instead")
    return rungs[:1] + tuple(r for r in rungs[1:] if r.backend != "xla")


def demotable(exc: BaseException) -> bool:
    """Whether a cheaper rung might survive this failure (see the module
    docstring). Matches CUDA launch failures on their code, never on the
    message."""
    if isinstance(exc, InjectedFault):
        # Injected resource exhaustion (raise=oom) demotes wherever it
        # fires; a plain injected fault demotes only at the compile
        # boundary (the warm-up): an injected h2d/read blip surfaces
        # typed, not as a silent backend change.
        return (str(exc).startswith("RESOURCE_EXHAUSTED")
                or exc.point in (None, "compile"))
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    if type(exc).__name__ == "KernelLaunchError":
        return getattr(exc, "code", None) in RESOURCE_CODES
    return False


def record_demotion(frm: Rung, to: Rung, exc: BaseException) -> None:
    """One demotion: counter + span + a stderr line an operator can
    grep. Called once per ladder step taken."""
    from tpu_stencil_torch import obs

    obs.registry().counter("resilience_fallbacks_total").inc()
    with obs.span("resilience.demote", "resilience",
                  frm=frm.label, to=to.label, error=type(exc).__name__):
        pass  # zero-duration marker: the ladder stepped here
    print(
        f"resilience: demoting {frm.label} -> {to.label} after "
        f"{type(exc).__name__}: {exc}",
        file=sys.stderr, flush=True,
    )
