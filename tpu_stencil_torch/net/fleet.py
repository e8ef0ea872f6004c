"""The replica fleet: one serving engine per device (the port's counterpart
of the JAX package's ``net/fleet.py``).

Each replica is a stock :class:`~tpu_stencil_torch.serve.engine.
StencilServer` (bounded queue, micro-batching, program cache, deadlines)
built from ``NetConfig.serve_config(i)`` and given its device through
``device=``, so a CPU replica never turns into ``cuda:<i>``.

**Devices.** The fleet runs on the devices it is given (``devices=``, a
list that may name one device several times: ``[cuda:0] * 2`` puts two
replicas on one card, ``[cpu, cpu]`` two on the CPU), else on every
visible card (:func:`~tpu_stencil_torch.devices.resolve_devices`, raising
``NoDeviceError`` when there is none). ``replicas`` above the device
count is refused, as in the JAX package.

**Shared program-cache warming.** The first time a (filter, bucket,
channels, reps) key is routed, one discarded zero-frame warm request goes
to every other replica (``warm_submits_total``), so their program builds
overlap the first real request.

**Drain and restart.** :meth:`drain` closes every replica concurrently
under one deadline and reports per replica whether it drained or was
abandoned; :meth:`restart` drains one replica, builds a fresh engine on
the same device and swaps it in while the rest serve on (the router's
recovery of a ``WorkerCrashed`` replica).

**Warm state.** :meth:`warmstate_export` is this host's warm-state
envelope (:mod:`~tpu_stencil_torch.ctrl.warmstart`: program-cache keys,
never binaries) and :meth:`warmstate_import` rebuilds and warm-runs an
envelope's entries in every replica, each from this checkout's kernel
sources.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_stencil_torch.config import NetConfig
from tpu_stencil_torch.devices import resolve_devices
from tpu_stencil_torch.obs import ledger as _obs_ledger
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.serve import bucketing
from tpu_stencil_torch.serve.engine import StencilServer
from tpu_stencil_torch.serve.metrics import Registry

# Warm-key dedup bound: the key space is client-controlled, so past the
# cap the oldest keys age out (and would simply warm again).
_WARM_KEY_CAP = 4096

# Warm-cost bound: a warm request runs the full rep count on its zero
# frame (reps is part of the program key). Past this many reps the
# sibling compute a warm burns outweighs the build it saves, so big-rep
# keys warm on their own first request per replica.
_WARM_MAX_REPS = 1024


class ReplicaFleet:
    """N serving engines plus the warming, drain and restart lifecycle.
    Construct, :meth:`start` (resolves the devices), route submits at
    ``fleet.replicas[i]``, :meth:`drain` when done."""

    def __init__(self, cfg: NetConfig, registry: Optional[Registry] = None,
                 start_workers: bool = True,
                 devices: Optional[Sequence] = None) -> None:
        self.cfg = cfg
        self.registry = registry if registry is not None else Registry()
        self.replicas: List[StencilServer] = []
        self.devices: List[torch.device] = []
        self._devices_arg = (None if devices is None
                             else [torch.device(d) for d in devices])
        self._lock = threading.Lock()
        # Serializes whole restarts (close -> build -> swap): a concurrent
        # /admin/restart and a WorkerCrashed reroute of one replica must
        # not each build an engine and leak the loser.
        self._restart_lock = threading.Lock()
        self._warmed: "collections.OrderedDict" = collections.OrderedDict()
        # Witness verdict sink: callable(replica_index, ok), installed by
        # the router (the quarantine board's feed); wired per replica in
        # _build, so a restarted engine re-wires itself.
        self._witness_sink = None
        # Tests park the fleet (start_workers=False) to pin queues, then
        # release it with start_workers().
        self._start_workers = start_workers
        self._m_warm = self.registry.counter("warm_submits_total")
        self._m_restarts = self.registry.counter("replica_restarts_total")
        self._m_abandoned = self.registry.counter(
            "drain_abandoned_replicas_total"
        )

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ReplicaFleet":
        """Build the replicas (idempotent). The devices resolve here,
        never at construction."""
        if self.replicas:
            return self
        devices = self._devices_arg or resolve_devices()
        n = self.cfg.replicas or len(devices)
        if n > len(devices):
            raise ValueError(
                f"replicas={n} exceeds {len(devices)} device(s); the fleet "
                f"runs one engine per device (0 = all)"
            )
        self.devices = devices[:n]
        self.replicas = [self._build(i) for i in range(n)]
        return self

    def _build(self, i: int) -> StencilServer:
        dev = self.devices[i]
        scfg = dataclasses.replace(
            self.cfg.serve_config(i),
            device_index=dev.index if dev.type == "cuda" else None,
        )
        srv = StencilServer(scfg, start=self._start_workers, device=dev)
        srv.on_witness = lambda ok, i=i: self._emit_witness(i, ok)
        return srv

    def set_witness_sink(self, sink) -> None:
        """Install the verdict sink (``callable(replica_index, ok)``); the
        router points it at the quarantine board."""
        self._witness_sink = sink

    def _emit_witness(self, i: int, ok: bool) -> None:
        sink = self._witness_sink
        if sink is not None:
            sink(i, ok)

    def start_workers(self) -> None:
        """Release a parked fleet: start every replica's worker."""
        self._start_workers = True
        for rep in self.replicas:
            rep.start()

    def __len__(self) -> int:
        return len(self.replicas)

    # -- shared cache warming ------------------------------------------

    @staticmethod
    def _warm_key(cfg: NetConfig, image: np.ndarray, reps: int,
                  filter_name: str) -> Tuple:
        h, w = image.shape[:2]
        channels = image.shape[2] if image.ndim == 3 else 1
        edges = cfg.bucket_edges or bucketing.DEFAULT_EDGES
        return (filter_name, bucketing.bucket_shape(h, w, edges),
                channels, int(reps))

    def prewarm_others(self, chosen: int, image: np.ndarray, reps: int,
                       filter_name: Optional[str] = None) -> int:
        """Fire one discarded zero-frame warm request at every replica but
        ``chosen`` the first time this program key is seen. Returns how
        many warm submits were offered; best-effort (a full or closed
        sibling is skipped)."""
        if not self.cfg.warm_fleet or len(self.replicas) < 2:
            return 0
        if int(reps) > _WARM_MAX_REPS:
            return 0
        fname = filter_name or self.cfg.filter_name
        key = self._warm_key(self.cfg, image, reps, fname)
        with self._lock:
            if key in self._warmed:
                return 0
            self._warmed[key] = True
            while len(self._warmed) > _WARM_KEY_CAP:
                self._warmed.popitem(last=False)
        zeros = np.zeros(image.shape, np.uint8)
        n = 0
        # Warm submits fire on the HTTP handler thread, where the client's
        # cost ledger is bound: a warm-kind ledger takes the sibling's
        # device share as overhead instead.
        with _obs_ledger.bind(
                _obs_ledger.RequestLedger(tenant="_warm", kind="warm")):
            for j, rep in enumerate(list(self.replicas)):
                if j == chosen:
                    continue
                try:
                    # owned=True: the zeros frame is never written after
                    # this loop, so every sibling reads the one buffer.
                    rep.submit(zeros, reps, fname, owned=True)
                except Exception:
                    continue  # full, closed or crashed sibling: skip
                self._m_warm.inc()
                n += 1
        return n

    # -- drain / restart -----------------------------------------------

    def drain(self, timeout_s: Optional[float] = None) -> Dict[int, bool]:
        """Close every replica concurrently under one deadline; returns
        ``{replica_index: drained}``, False naming a replica whose worker
        did not join in time (counted in its ``serve_close_abandoned_total``
        and the fleet's ``drain_abandoned_replicas_total``). Every accepted
        request completes during the drain or fails typed."""
        budget = (
            timeout_s if timeout_s is not None else self.cfg.drain_timeout_s
        )
        results: Dict[int, bool] = {}
        with _obs_span("net.drain", "net", replicas=len(self.replicas)):
            threads = []

            def _close(i: int, rep: StencilServer) -> None:
                results[i] = bool(rep.close(timeout=budget))

            for i, rep in enumerate(self.replicas):
                t = threading.Thread(
                    target=_close, args=(i, rep),
                    name=f"tpu-stencil-torch-drain-{i}", daemon=True,
                )
                t.start()
                threads.append(t)
            deadline = time.perf_counter() + budget + 5.0
            for t in threads:
                t.join(max(0.0, deadline - time.perf_counter()))
            for i in range(len(self.replicas)):
                if results.get(i) is None:
                    results[i] = False  # the close itself overran
            for i, ok in sorted(results.items()):
                if not ok:
                    self._m_abandoned.inc()
        from tpu_stencil_torch.obs import events as _obs_events

        abandoned = sorted(i for i, ok in results.items() if not ok)
        _obs_events.emit(
            "net.drain_report", tier="net",
            verdict="abandoned" if abandoned else "clean",
            replicas=len(results), abandoned=abandoned,
        )
        return results

    def restart(self, i: int, timeout_s: Optional[float] = None,
                expect: Optional[StencilServer] = None) -> bool:
        """Rolling single-replica restart: drain replica ``i``, build a
        fresh engine on the same device, swap it in. Returns the old
        replica's drained bool. With ``expect``, a slot that no longer
        holds that engine (a concurrent restart swapped it) returns True
        without restarting the replacement."""
        with self._restart_lock:
            with self._lock:
                old = self.replicas[i]
                if expect is not None and old is not expect:
                    return True
            drained = bool(old.close(
                timeout=timeout_s if timeout_s is not None
                else self.cfg.drain_timeout_s
            ))
            new = self._build(i)
            if self._start_workers:
                new.start()
            with self._lock:
                self.replicas[i] = new
            self._m_restarts.inc()
            return drained

    # -- introspection -------------------------------------------------

    def merged_counters(self) -> Dict[str, int]:
        """Counters summed over every replica's registry (the ``/metrics``
        exposition folds them in as ``fleet_<name>``)."""
        out: Dict[str, int] = {}
        for rep in list(self.replicas):
            for k, v in rep.stats()["counters"].items():
                out[k] = out.get(k, 0) + v
        return out

    def stats(self) -> List[dict]:
        """Per-replica ``StencilServer.stats()`` snapshots, in replica
        order (the ``/statusz`` payload)."""
        return [rep.stats() for rep in list(self.replicas)]

    # -- warm-start plane ------------------------------------------------

    def warmstate_export(self) -> dict:
        """This host's warm-state envelope: replica 0's plus any keys only
        later replicas hold (first writer wins)."""
        envelope = None
        seen = set()
        for rep in list(self.replicas):
            doc = rep.export_warm_state()
            if envelope is None:
                envelope = doc
                seen = {json.dumps(e["key"])
                        for e in doc.get("entries", [])}
                continue
            for e in doc.get("entries", []):
                k = json.dumps(e["key"])
                if k not in seen:
                    seen.add(k)
                    envelope["entries"].append(e)
        if envelope is None:
            envelope = {"schema_version": 1, "entries": []}
        return envelope

    def warmstate_import(self, payload) -> dict:
        """Import one envelope into every replica (each rebuilds and
        warm-runs the entries on its own device). The summary is summed
        over the replicas; an unusable entry degrades to a cold build
        inside each replica, typed and counted, never raised."""
        out: dict = {"imported": 0, "fallbacks": 0, "replicas": []}
        for rep in list(self.replicas):
            r = rep.import_warm_state(payload)
            out["imported"] += r["imported"]
            out["fallbacks"] += r["fallbacks"]
            out["replicas"].append(r)
        return out
