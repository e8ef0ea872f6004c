"""Fault-injection harness: named injection points at stage boundaries.

The port's counterpart of the JAX package's ``resilience/faults.py``: the
same spec grammar, the same point names and the same firing rules, so one
spec reproduces one failure in both packages. Its environment variables
carry the port's prefix. The job path of the port has sites at ``read``,
``h2d``, ``compile`` (the warm-up), ``compute`` (every rep index),
``d2h``, ``write``, ``checkpoint`` (every commit) and ``collective``
(every sharded launch); the net, fed and integrity points are accepted
for the slices that bring their sites.

Every engine (driver, serve, stream, sharded) passes through the same
pipeline stages — raw I/O read/write, H2D/D2H transfer, compile,
compute dispatch, collective exchange, checkpoint write — and each
stage boundary is a named injection point here. A spec string (the
``TPU_STENCIL_TORCH_FAULTS`` env var, the ``--faults`` CLI flag, or
:func:`configure` from tests) arms faults at those points, so chaos
tests AND operators reproduce a production failure deterministically:

    TPU_STENCIL_TORCH_FAULTS="compute:frame=3:raise=RuntimeError,h2d:p=0.1"

Spec grammar (comma-separated rules, colon-separated fields)::

    point[:frame=N|rep=N|at=N][:p=0.x][:times=K][:raise=NAME]

* ``point`` — one of :data:`POINTS`.
* ``frame=N`` / ``rep=N`` / ``at=N`` (synonyms) — fire when the site's
  call index equals N (the engine passes its frame/rep/batch index;
  sites called without an index count their own invocations). Without
  an index or ``p``, the rule fires on the first call.
* ``p=0.x`` — fire each call with probability x (seeded RNG,
  ``TPU_STENCIL_TORCH_FAULTS_SEED``, so even "probabilistic" soaks replay).
* ``times=K`` — stop after K firings. Defaults: 1 for deterministic
  rules (so the production retry/fallback path can recover and the run
  can be asserted bit-exact), unlimited (0) for ``p=`` rules.
* ``raise=NAME`` — the exception class, from :data:`EXCEPTIONS`:
  builtins (``RuntimeError``, ``OSError``, ``TimeoutError``, ...),
  ``oom`` (:class:`~.errors.InjectedOOM`, carries RESOURCE_EXHAUSTED so
  the demotion ladder engages), or ``fatal``
  (:class:`~.errors.FatalInjectedFault`, escapes ``except Exception`` —
  the thread-death simulator). Default :class:`~.errors.InjectedFault`.

Hot-path contract (asserted by a tier-1 test): engines resolve their
sites ONCE at prepare/construction time via :func:`site`, which returns
``None`` when no rule names the point — so with ``TPU_STENCIL_TORCH_FAULTS``
unset the per-rep/per-frame cost is a local ``is not None`` check on a
``None`` captured before the loop, i.e. nothing.

Every firing increments ``resilience_faults_injected_total`` in the
driver registry and (under tracing) records a ``resilience.fault`` span.
"""

from __future__ import annotations

import dataclasses
import os
import random
import sys
from typing import Dict, List, Optional

from tpu_stencil_torch.resilience.errors import (
    FatalInjectedFault,
    InjectedFault,
    InjectedOOM,
)

ENV_VAR = "TPU_STENCIL_TORCH_FAULTS"
SEED_VAR = "TPU_STENCIL_TORCH_FAULTS_SEED"

#: The injection-point vocabulary — one name per stage boundary, shared
#: by every engine (the module docstring names the port's call sites).
POINTS = (
    "read",        # raw/frame input I/O
    "write",       # raw/frame output I/O
    "h2d",         # host->device placement/transfer
    "d2h",         # device->host fetch
    "compile",     # warm-up compile / executable build
    "compute",     # per-rep / per-frame / per-batch compute dispatch
    "collective",  # sharded halo-exchange launch
    "checkpoint",  # checkpoint sidecar/data write
    # Socket-level sites in the HTTP tier (net/http.py): `net.accept`
    # drops (or, with raise=TimeoutError, stalls) a connection before
    # any response; `net.body` truncates (or stalls) a 200 response
    # mid-body — the chaos stand-ins for a host dying mid-request, so
    # the federation's connect/mid-body-EOF/timeout verdicts are
    # testable against a real socket, not just unit mocks.
    "net.accept",  # HTTP request handling entry (drop/stall connection)
    "net.body",    # HTTP response body write (mid-body EOF / stall)
    # Federation-hop sites (fed/): each boundary of the front router.
    "fed.heartbeat",  # membership /healthz probe (injected = a miss)
    "fed.forward",    # one member forward attempt launch
    "fed.hedge",      # hedge-request launch decision
    # Corruption sites (the integrity layer): unlike every point
    # above, an armed rule here does not RAISE into the engine — the
    # firing is caught and converted into a deterministic bit flip
    # (integrity.checksum.fired/corrupt_*), so the checksum/witness
    # detection paths are chaos-tested against genuinely wrong bytes
    # under the same point[:p=][:times=] grammar, never mocks.
    "integrity.corrupt_ingest",  # flip bits in an ingested frame/body
    "integrity.corrupt_result",  # flip bits in a computed result
    "net.corrupt_body",          # flip bits in a 200 payload on the wire
)

#: Resolvable ``raise=`` names. A short allow-list, not arbitrary eval:
#: the spec comes from the environment.
EXCEPTIONS = {
    "InjectedFault": InjectedFault,
    "oom": InjectedOOM,
    "fatal": FatalInjectedFault,
    "RuntimeError": RuntimeError,
    "IOError": IOError,
    "OSError": OSError,
    "ValueError": ValueError,
    "MemoryError": MemoryError,
    "NotImplementedError": NotImplementedError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
}


@dataclasses.dataclass
class FaultRule:
    """One armed rule; carries its own firing state so every site
    resolved against the same plan shares one budget."""

    point: str
    index: Optional[int] = None  # fire when call index == index
    p: float = 0.0               # else fire with probability p
    times: int = 1               # max firings (0 = unlimited)
    exc: type = InjectedFault
    _fired: int = 0
    _calls: int = 0
    _rng: random.Random = dataclasses.field(
        default_factory=lambda: random.Random(
            int(os.environ.get(SEED_VAR, "0"))
        )
    )

    def check(self, index: Optional[int] = None) -> None:
        """Raise the rule's exception if it fires at this call."""
        n = self._calls
        self._calls += 1
        if self.times > 0 and self._fired >= self.times:
            return
        i = index if index is not None else n
        if self.index is not None:
            if i != self.index:
                return
        elif self.p > 0.0:
            if self._rng.random() >= self.p:
                return
        self._fired += 1
        self._record(i)
        e = self.exc(
            f"injected fault at {self.point}[{i}] "
            f"(firing {self._fired}"
            f"{'/' + str(self.times) if self.times > 0 else ''})"
        )
        if isinstance(e, (InjectedFault, FatalInjectedFault)):
            e.point, e.index = self.point, i
        raise e

    def _record(self, index: int) -> None:
        from tpu_stencil_torch import obs

        obs.registry().counter("resilience_faults_injected_total").inc()
        with obs.span("resilience.fault", "resilience",
                      point=self.point, index=index):
            pass  # zero-duration marker: a fault fired here
        print(f"resilience: injected {self.exc.__name__} at "
              f"{self.point}[{index}]", file=sys.stderr, flush=True)


class Site:
    """The resolved checker for one injection point: call it at the
    stage boundary (optionally with the engine's frame/rep/batch index).
    Only ever constructed when at least one rule names the point —
    :func:`site` returns ``None`` otherwise."""

    __slots__ = ("point", "_rules")

    def __init__(self, point: str, rules: List[FaultRule]) -> None:
        self.point = point
        self._rules = rules

    def __call__(self, index: Optional[int] = None) -> None:
        for rule in self._rules:
            rule.check(index)


def parse_spec(spec: str) -> Dict[str, List[FaultRule]]:
    """Parse a spec string into ``{point: [rules]}``. Raises
    ``ValueError`` on unknown points/keys/exception names — a mistyped
    chaos spec must fail loudly, not silently inject nothing."""
    plan: Dict[str, List[FaultRule]] = {}
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        fields = raw.split(":")
        point = fields[0].strip()
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; expected one of "
                f"{'|'.join(POINTS)}"
            )
        rule = FaultRule(point=point)
        explicit_times = False
        for field in fields[1:]:
            key, sep, value = field.partition("=")
            key = key.strip()
            value = value.strip()
            if not sep:
                raise ValueError(f"fault field {field!r} is not key=value")
            if key in ("frame", "rep", "at", "req"):
                rule.index = int(value)
            elif key == "p":
                rule.p = float(value)
                if not 0.0 < rule.p <= 1.0:
                    raise ValueError(f"fault p={value} outside (0, 1]")
            elif key == "times":
                rule.times = int(value)
                explicit_times = True
            elif key == "raise":
                if value not in EXCEPTIONS:
                    raise ValueError(
                        f"unknown fault exception {value!r}; expected one "
                        f"of {'|'.join(sorted(EXCEPTIONS))}"
                    )
                rule.exc = EXCEPTIONS[value]
            else:
                raise ValueError(f"unknown fault field {key!r} in {raw!r}")
        if rule.p > 0.0 and not explicit_times:
            rule.times = 0  # probabilistic rules keep firing by default
        plan.setdefault(point, []).append(rule)
    return plan


_UNSET = object()
_plan = _UNSET  # lazily resolved from the env on first use


def _get_plan() -> Dict[str, List[FaultRule]]:
    global _plan
    if _plan is _UNSET:
        spec = os.environ.get(ENV_VAR)
        _plan = parse_spec(spec) if spec else {}
    return _plan


def configure(spec: Optional[str]) -> None:
    """Install a fault plan from ``spec`` (None/'' = no faults). Wins
    over the env var; firing state resets (each configure is a fresh
    chaos scenario)."""
    global _plan
    _plan = parse_spec(spec) if spec else {}


def clear() -> None:
    """Disarm everything AND forget any env-derived plan (tests)."""
    global _plan
    _plan = {}


def reset() -> None:
    """Back to the lazy env-derived default (process start state)."""
    global _plan
    _plan = _UNSET


def active() -> bool:
    """Whether any rule is armed (cheap; used by docs/REPL, not hot paths)."""
    return bool(_get_plan())


def site(point: str) -> Optional[Site]:
    """The resolved injection checker for ``point``, or ``None`` when no
    armed rule names it. Engines call this ONCE at prepare/construction
    time and keep the result — the no-faults hot path is a branch on a
    captured ``None``."""
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r}")
    rules = _get_plan().get(point)
    if not rules:
        return None
    return Site(point, rules)
