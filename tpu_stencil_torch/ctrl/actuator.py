"""Actuator: the act half of the control loop (the port's copy of the JAX
package's ``ctrl/actuator.py``).

A :class:`HostProvider` owns the mechanics of starting and stopping
one ``net`` member host; the :class:`Actuator` owns the fleet-level
discipline on top of it:

- **scale-out** launches a host that registers itself with the fed
  (``net --register``) and, when warm-start is configured, rebuilds
  the fleet's program-cache entries from its own kernel sources before
  flipping ready (``net --warm-from``).
- **scale-in always drains before stop**: the fed's rolling
  member-drain path (``POST /admin/drain?host=``) bleeds routing and
  drives the member's own SIGTERM-equivalent drain; the provider then
  merely waits for the clean exit.  Zero accepted-request loss by
  construction.
- **preemption is a planned drain**: on a notice (``POST
  /admin/preempt?host=`` or a SIGTERM forwarded to the controller)
  the replacement is launched FIRST; only once it serves does the
  victim drain and stop.  ``Member.pinned_draining`` carries the
  state — never the eviction path.
- **reconcile** detects owned hosts whose process died without a
  drain (the kill -9 case) and reports them for the planner's
  REPLACE decision.

## Provider interface (real fleets)

A production provider (a node pool, a VM API) implements three
methods::

    class HostProvider:
        def launch(self) -> HostHandle:
            '''Start one member host; block until it serves; return a
            handle whose .url answers /healthz.  Raise on timeout.'''
        def stop(self, handle, timeout_s) -> bool:
            '''Stop the host (it has already been drained), bounded
            by timeout_s; True = clean exit.'''
        def alive(self, handle) -> bool:
            '''Is the host's process/VM still up?'''

The host must self-register (``--register FED_URL``) — the actuator
never writes the member table directly, so membership stays
single-writer through the fed's existing ``/admin/register`` path.

The controller process never touches a device. The subprocess provider's
members run on the card unless ``platform="cpu"`` asks for the CPU: a
member with no card exits 2 (``NoDeviceError``) and its launch counts as
failed; it never carries on on the CPU.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from tpu_stencil_torch.config import CtrlConfig
from tpu_stencil_torch.fed.membership import host_id_for
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.serve.metrics import Registry


@dataclasses.dataclass
class HostHandle:
    """One launched member host: its fed-visible identity plus the
    provider's opaque process object."""

    host_id: str
    url: str
    proc: object = None
    log_path: Optional[str] = None


class HostProvider:
    """The provider contract (see module docstring)."""

    def launch(self) -> HostHandle:
        raise NotImplementedError

    def stop(self, handle: HostHandle, timeout_s: float) -> bool:
        raise NotImplementedError

    def alive(self, handle: HostHandle) -> bool:
        raise NotImplementedError


class SubprocessProvider(HostProvider):
    """CI/bench provider: each member host is a real ``python -m
    tpu_stencil_torch net`` subprocess on this machine (the same
    fake-a-host discipline the federation chaos tests already use).
    Output goes to an unlinked temp file, never a PIPE — a chatty member
    past the pipe buffer would block on write and stall its own requests.

    ``platform`` None (the default) runs the member on the card: no
    ``--platform`` is passed. ``"cpu"`` (or ``"gpu"``) is passed on as
    the member's ``--platform``."""

    def __init__(self, fed_url: Optional[str] = None,
                 platform: Optional[str] = None, replicas: int = 1,
                 warm_from: Optional[str] = None,
                 launch_timeout_s: float = 120.0,
                 drain_timeout_s: float = 60.0,
                 extra_args: Tuple[str, ...] = ()) -> None:
        self.fed_url = fed_url
        self.platform = platform
        self.replicas = replicas
        self.warm_from = warm_from
        self.launch_timeout_s = launch_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.extra_args = tuple(extra_args)

    def argv(self) -> List[str]:
        """The member's command line."""
        argv = [sys.executable, "-m", "tpu_stencil_torch", "net",
                "--port", "0", "--replicas", str(self.replicas),
                "--drain-timeout", f"{self.drain_timeout_s:g}",
                "--flightrec-dir", "none", "--prof-dir", "none"]
        if self.platform:
            argv += ["--platform", self.platform]
        if self.fed_url:
            argv += ["--register", self.fed_url]
        if self.warm_from:
            argv += ["--warm-from", self.warm_from]
        return argv + list(self.extra_args)

    def launch(self) -> HostHandle:
        logf = tempfile.NamedTemporaryFile(
            mode="w", prefix="tpu-stencil-torch-ctrl-host-", suffix=".log",
            delete=False,
        )
        proc = subprocess.Popen(self.argv(), stdout=logf,
                                stderr=subprocess.STDOUT, text=True)
        logf.close()  # the child holds its own dup
        deadline = time.perf_counter() + self.launch_timeout_s
        url = None
        while url is None and time.perf_counter() < deadline:
            # A separate open per poll: seeking a shared handle would
            # move the child's write offset too.
            with open(logf.name) as reader:
                for line in reader:
                    if "net: serving on http://" in line:
                        url = line.split()[3]
                        break
            if url is None:
                if proc.poll() is not None:
                    break
                time.sleep(0.2)
        if url is None:
            proc.kill()
            with open(logf.name) as reader:
                tail = reader.read()[-500:]
            raise RuntimeError(
                f"member host failed to start within "
                f"{self.launch_timeout_s:g}s (rc={proc.poll()}): "
                f"{tail!r}"
            )
        return HostHandle(host_id=host_id_for(url), url=url, proc=proc,
                          log_path=logf.name)

    def stop(self, handle: HostHandle, timeout_s: float) -> bool:
        import os
        import signal as _signal

        proc = handle.proc
        clean = False
        try:
            if proc.poll() is None:
                # The host is already drained (fed-driven); a SIGTERM
                # is the belt-and-braces second ask.
                proc.send_signal(_signal.SIGTERM)
            try:
                clean = proc.wait(timeout=timeout_s) == 0
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        finally:
            if handle.log_path:
                try:
                    os.unlink(handle.log_path)
                except OSError:
                    pass
                handle.log_path = None
        return clean

    def alive(self, handle: HostHandle) -> bool:
        return handle.proc is not None and handle.proc.poll() is None

    def kill(self, handle: HostHandle) -> None:
        """SIGKILL, for chaos tests — the host is GONE, no drain."""
        if handle.proc is not None and handle.proc.poll() is None:
            handle.proc.kill()


class Actuator:
    """Owned-host bookkeeping + the drain-before-stop discipline."""

    def __init__(self, cfg: CtrlConfig, provider: HostProvider,
                 registry: Optional[Registry] = None) -> None:
        self.cfg = cfg
        self.provider = provider
        self.registry = registry or Registry()
        self.hosts: Dict[str, HostHandle] = {}
        self._lock = threading.Lock()
        m = self.registry
        self._g_hosts = m.gauge("ctrl_hosts")
        self._m_launches = m.counter("ctrl_launches_total")
        self._m_launch_failures = m.counter("ctrl_launch_failures_total")
        self._m_stops = m.counter("ctrl_stops_total")
        self._m_dirty_stops = m.counter("ctrl_dirty_stops_total")
        self._m_preempt_replacements = m.counter(
            "ctrl_preempt_replacements_total"
        )
        self._g_hosts.set(0)

    def _note_hosts(self) -> None:
        self._g_hosts.set(len(self.hosts))

    # -- grow ----------------------------------------------------------

    def scale_out(self, n: int = 1) -> List[HostHandle]:
        """Launch ``n`` member hosts (each self-registers with the
        fed, warm-starting when configured).  A failed launch is
        counted and skipped — the planner sees the deficit next poll
        and decides again."""
        out: List[HostHandle] = []
        for _ in range(max(0, n)):
            with _obs_span("ctrl.scale_out", "ctrl"):
                try:
                    h = self.provider.launch()
                except Exception:  # noqa: BLE001 - counted, retried by loop
                    self._m_launch_failures.inc()
                    continue
            with self._lock:
                self.hosts[h.host_id] = h
            self._m_launches.inc()
            out.append(h)
        self._note_hosts()
        return out

    # -- shrink --------------------------------------------------------

    def _pick_victim(self) -> Optional[str]:
        """Newest owned host first (LIFO): the longest-lived hosts
        carry the warmest caches."""
        with self._lock:
            if not self.hosts:
                return None
            return next(reversed(self.hosts))

    def scale_in(self, host_id: Optional[str] = None) -> bool:
        """Drain, THEN stop — zero accepted-request loss.  The fed's
        rolling member-drain path bleeds routing and drives the
        member's own drain sequence; the provider only waits for the
        clean exit."""
        hid = host_id or self._pick_victim()
        if hid is None:
            return False
        with self._lock:
            handle = self.hosts.pop(hid, None)
        if handle is None:
            return False
        with _obs_span("ctrl.scale_in", "ctrl", host=hid):
            self._fed_post(f"/admin/drain?host={hid}")
            clean = self.provider.stop(handle, self.cfg.drain_timeout_s)
        self._m_stops.inc()
        if not clean:
            self._m_dirty_stops.inc()
        self._note_hosts()
        return clean

    # -- preemption ----------------------------------------------------

    def preempt(self, host_id: str) -> Tuple[List[HostHandle], bool]:
        """The planned-drain choreography: notice → replacement FIRST
        → victim drains and stops.  Returns (replacements, victim
        stopped clean).  Works for hosts this actuator does not own
        too (the stop half is then skipped — the owner stops it)."""
        with _obs_span("ctrl.preempt", "ctrl", host=host_id):
            # 1. The notice: pinned drain, victim leaves routing now.
            self._fed_post(f"/admin/preempt?host={host_id}")
            # 2. Replacement before the victim exits.
            replacements = self.scale_out(1)
            if replacements:
                self._m_preempt_replacements.inc()
            # 3. Only now bleed and stop the victim.
            clean = self.scale_in(host_id) if host_id in self.hosts \
                else True
        return replacements, clean

    # -- host-loss detection -------------------------------------------

    def reconcile(self) -> List[str]:
        """Owned hosts whose process died WITHOUT a drain (kill -9, a
        real preemption landing before its notice).  The dead handles
        are forgotten here; replacing them is the planner's REPLACE
        decision, not an actuator reflex."""
        dead: List[str] = []
        with self._lock:
            for hid, h in list(self.hosts.items()):
                if not self.provider.alive(h):
                    dead.append(hid)
                    del self.hosts[hid]
        if dead:
            self._note_hosts()
        return dead

    # -- teardown ------------------------------------------------------

    def close(self) -> bool:
        """Drain-and-stop every owned host; True when all exited
        clean (the CLI's rc discipline)."""
        ok = True
        while True:
            hid = self._pick_victim()
            if hid is None:
                return ok
            ok = self.scale_in(hid) and ok

    # -- fed plumbing --------------------------------------------------

    def _fed_post(self, path: str) -> Optional[dict]:
        import json
        import urllib.request

        try:
            req = urllib.request.Request(
                self.cfg.fed_url.rstrip("/") + path, data=b"",
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=30.0) as r:
                return json.loads(r.read())
        except Exception:  # noqa: BLE001 - the fed may be mid-restart;
            return None    # the drain-before-stop still holds via SIGTERM
