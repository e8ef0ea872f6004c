"""``python -m tpu_stencil_torch ctrl`` — run the elastic control plane
(the JAX package's ``ctrl`` command line, flag for flag).

The loop that closes measure→decide→act over a running federation:
each poll it (1) reconciles owned hosts against reality (a process
gone without a drain is a dead host), (2) spots preemption notices
(owned members sitting in a pinned drain) and runs the planned-drain
choreography — replacement first, victim drains after, (3) scrapes
``/debug/capacity`` + ``/statusz`` into one
:class:`~tpu_stencil_torch.ctrl.planner.CapacitySignal`, (4) asks the
hysteresis planner for exactly one typed decision and actuates it.

On SIGTERM/SIGINT every owned host is drained-then-stopped; rc 0 when
all exited clean (1 otherwise) — the same rc discipline as the net
and fed CLIs, one tier up.

``--iterations N`` bounds the loop for CI smoke; 0 (the default)
serves until a signal. The controller touches no device; the members it
launches run on the card unless ``--member-platform cpu`` is given (with
no card, every launch fails, counted, and nothing runs on the CPU).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from typing import Optional

from tpu_stencil_torch.config import CtrlConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_stencil_torch ctrl",
        description="Elastic control plane: hysteresis autoscaling, "
                    "preemption-aware drain and warm-start member "
                    "launches over a `tpu_stencil_torch fed` "
                    "federation.",
    )
    p.add_argument("--fed", dest="fed_url", required=True, metavar="URL",
                   help="the federation front router this plane "
                        "controls (its /debug/capacity and /statusz "
                        "are the planner's signal source)")
    p.add_argument("--min-hosts", type=int, default=1, metavar="N",
                   help="owned-host floor; deficits are repaired "
                        "immediately, no hysteresis (default 1)")
    p.add_argument("--max-hosts", type=int, default=4, metavar="N",
                   help="owned-host ceiling for scale-out (default 4)")
    p.add_argument("--poll-interval", dest="poll_interval_s",
                   type=float, default=1.0, metavar="SECONDS",
                   help="control-loop period; the hysteresis windows "
                        "are counted in these polls (default 1)")
    p.add_argument("--capacity-window", dest="capacity_window_s",
                   type=float, default=10.0, metavar="SECONDS",
                   help="window= passed to /debug/capacity (default 10)")
    p.add_argument("--fast-samples", type=int, default=3, metavar="N",
                   help="fast hysteresis window: scale-out needs EVERY "
                        "one of the last N polls pressured (default 3)")
    p.add_argument("--slow-samples", type=int, default=9, metavar="N",
                   help="slow hysteresis window: scale-out also needs "
                        "a majority of the last N polls pressured; "
                        "scale-in needs ALL N idle (default 9)")
    p.add_argument("--scale-out-utilization", type=float, default=0.85,
                   metavar="FRACTION",
                   help="a poll is pressured past this hottest-member "
                        "slot fraction (default 0.85)")
    p.add_argument("--hold-utilization", type=float, default=0.70,
                   metavar="FRACTION",
                   help="entered pressure holds until the fast "
                        "window's mean utilization drops below this "
                        "(default 0.70)")
    p.add_argument("--scale-in-utilization", type=float, default=0.30,
                   metavar="FRACTION",
                   help="a poll is idle under this utilization "
                        "(default 0.30)")
    p.add_argument("--saturation-horizon", dest="saturation_horizon_s",
                   type=float, default=30.0, metavar="SECONDS",
                   help="a poll is also pressured when the merged "
                        "time-to-saturation forecast falls inside "
                        "this horizon (0 = ignore it; default 30)")
    p.add_argument("--cooldown-samples", type=int, default=5,
                   metavar="N",
                   help="polls to hold after a resize before the next "
                        "one (replacement bypasses this; default 5)")
    p.add_argument("--launch-timeout", dest="launch_timeout_s",
                   type=float, default=120.0, metavar="SECONDS",
                   help="budget for one member host to print its "
                        "bound URL (default 120)")
    p.add_argument("--drain-timeout", dest="drain_timeout_s",
                   type=float, default=60.0, metavar="SECONDS",
                   help="per-host drain-then-stop budget on scale-in "
                        "and shutdown (default 60)")
    p.add_argument("--member-platform", default=None,
                   choices=["cpu", "gpu"],
                   help="where launched members run (subprocess "
                        "provider): the card by default; 'cpu' runs "
                        "them on the CPU. A member with no card fails "
                        "its launch, counted")
    p.add_argument("--replicas-per-host", type=int, default=1,
                   metavar="N",
                   help="replicas per launched member host (default 1)")
    p.add_argument("--cold", action="store_true",
                   help="launch members cold (default: members pull "
                        "--warm-from the fed and rebuild its program-"
                        "cache keys from their own kernel sources, so "
                        "a joiner's first request is a cache hit; "
                        "unusable entries degrade to cold typed either "
                        "way)")
    p.add_argument("--iterations", type=int, default=0, metavar="N",
                   help="stop after N control polls (CI smoke); 0 = "
                        "serve until SIGTERM/SIGINT (default 0)")
    p.add_argument("--metrics-text", default=None, metavar="PATH",
                   help="after shutdown, write the ctrl metrics "
                        "exposition to PATH ('-' = stdout)")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="after shutdown, dump the ctrl status payload "
                        "as JSON to PATH ('-' = stdout)")
    return p


def _fed_get(fed_url: str, path: str,
             timeout_s: float = 10.0) -> Optional[dict]:
    import urllib.request

    try:
        with urllib.request.urlopen(fed_url.rstrip("/") + path,
                                    timeout=timeout_s) as r:
            doc = json.loads(r.read())
    except Exception:  # noqa: BLE001 - a missed scrape is a None signal
        return None
    return doc if isinstance(doc, dict) else None


def build_signal(cap: Optional[dict], stz: Optional[dict],
                 dead_hosts: int, preempted_hosts: int):
    """Fold one poll's scrapes into a CapacitySignal (None scrapes
    contribute unknowns — never pressure, never idleness)."""
    from tpu_stencil_torch.ctrl.planner import CapacitySignal

    utilization = headroom = tts = None
    routable = 0
    if cap is not None:
        headroom = cap.get("headroom_rps")
        tts = cap.get("time_to_saturation_s")
        utilization = (cap.get("utilization") or {}).get(
            "max_member_slot_fraction"
        )
    if stz is not None:
        routable = sum(
            1 for m in stz.get("members", [])
            if m.get("state") in ("healthy", "suspect")
        )
    return CapacitySignal(
        utilization=utilization, headroom_rps=headroom,
        time_to_saturation_s=tts, routable_hosts=routable,
        dead_hosts=dead_hosts, preempted_hosts=preempted_hosts,
    )


def main(argv=None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    try:
        cfg = CtrlConfig(
            fed_url=ns.fed_url,
            poll_interval_s=ns.poll_interval_s,
            capacity_window_s=ns.capacity_window_s,
            min_hosts=ns.min_hosts, max_hosts=ns.max_hosts,
            fast_samples=ns.fast_samples, slow_samples=ns.slow_samples,
            scale_out_utilization=ns.scale_out_utilization,
            hold_utilization=ns.hold_utilization,
            scale_in_utilization=ns.scale_in_utilization,
            saturation_horizon_s=ns.saturation_horizon_s,
            cooldown_samples=ns.cooldown_samples,
            launch_timeout_s=ns.launch_timeout_s,
            drain_timeout_s=ns.drain_timeout_s,
            member_platform=ns.member_platform,
            replicas_per_host=ns.replicas_per_host,
            warm_from=None if ns.cold else ns.fed_url,
        )
    except ValueError as e:
        parser.error(str(e))

    from tpu_stencil_torch.ctrl.actuator import Actuator, SubprocessProvider
    from tpu_stencil_torch.ctrl.planner import REPLACE, SCALE_IN, SCALE_OUT, \
        CapacityPlanner
    from tpu_stencil_torch.serve.metrics import Registry

    registry = Registry()
    provider = SubprocessProvider(
        fed_url=cfg.fed_url, platform=cfg.member_platform,
        replicas=cfg.replicas_per_host, warm_from=cfg.warm_from,
        launch_timeout_s=cfg.launch_timeout_s,
        drain_timeout_s=cfg.drain_timeout_s,
    )
    act = Actuator(cfg, provider, registry)
    planner = CapacityPlanner(cfg, registry)
    stop = threading.Event()

    def _on_signal(signum, _frame) -> None:
        print(f"ctrl: received {signal.Signals(signum).name}, "
              f"draining owned hosts", flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(
        f"ctrl: controlling federation {cfg.fed_url} "
        f"(hosts {cfg.min_hosts}..{cfg.max_hosts}, poll "
        f"{cfg.poll_interval_s:g}s, fast/slow windows "
        f"{cfg.fast_samples}/{cfg.slow_samples} samples, out/hold/in "
        f"utilization {cfg.scale_out_utilization:g}/"
        f"{cfg.hold_utilization:g}/{cfg.scale_in_utilization:g}, "
        f"warm-start {'off' if cfg.warm_from is None else 'on'}); "
        f"SIGTERM drains the owned fleet",
        flush=True,
    )
    polls = 0
    while not stop.is_set():
        # 1. Reality check: owned processes gone without a drain.
        dead = act.reconcile()
        if dead:
            print(f"ctrl: owned host(s) {dead} died without a drain",
                  flush=True)
        # 2. Preemption notices: owned members in a pinned drain.
        stz = _fed_get(cfg.fed_url, "/statusz")
        preempted = []
        if stz is not None:
            owned = set(act.hosts)
            preempted = [
                m["host_id"] for m in stz.get("members", [])
                if m.get("host_id") in owned
                and m.get("pinned_draining")
                and m.get("state") == "draining"
            ]
        for hid in preempted:
            # Planned-drain choreography: replacement FIRST, then the
            # victim bleeds and stops.
            print(f"ctrl: preemption notice for {hid}; starting the "
                  f"replacement before the victim exits", flush=True)
            started = act.scale_out(1)
            clean = act.scale_in(hid)
            registry.counter("ctrl_preempt_replacements_total").inc(
                len(started)
            )
            print(f"ctrl: preempted {hid} drained "
                  f"{'clean' if clean else 'DIRTY'}, "
                  f"{len(started)} replacement(s) up", flush=True)
        # 3. Signal + decision (preempted hosts were already replaced
        #    above, so they do not ride the REPLACE path too).
        cap = _fed_get(
            cfg.fed_url,
            f"/debug/capacity?window={cfg.capacity_window_s:g}",
        )
        sig = build_signal(cap, stz, dead_hosts=len(dead),
                           preempted_hosts=0)
        decision = planner.observe(sig, len(act.hosts))
        if decision.action == REPLACE:
            started = act.scale_out(decision.count)
            print(f"ctrl: replace x{decision.count} "
                  f"({decision.reason}): {len(started)} up", flush=True)
        elif decision.action == SCALE_OUT:
            started = act.scale_out(decision.count)
            print(f"ctrl: scale-out x{decision.count} "
                  f"({decision.reason}): {len(started)} up", flush=True)
        elif decision.action == SCALE_IN:
            clean = act.scale_in()
            print(f"ctrl: scale-in ({decision.reason}): drained "
                  f"{'clean' if clean else 'DIRTY'}", flush=True)
        polls += 1
        if ns.iterations and polls >= ns.iterations:
            print(f"ctrl: {polls} poll(s) done (--iterations), "
                  f"draining owned hosts", flush=True)
            break
        stop.wait(cfg.poll_interval_s)
    t0 = time.perf_counter()
    n_owned = len(act.hosts)
    all_clean = act.close()
    if all_clean:
        print(f"ctrl: drained {n_owned} owned host(s) cleanly in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    else:
        print(f"ctrl: drain left at least one owned host DIRTY "
              f"({time.perf_counter() - t0:.2f}s elapsed)", flush=True)
    if ns.metrics_text:
        from tpu_stencil_torch.obs import exposition

        exposition.write_text(ns.metrics_text, registry.snapshot(),
                              prefix="tpu_stencil_ctrl")
    if ns.stats_json:
        payload = json.dumps({
            "schema_version": 1,
            "polls": polls,
            "owned_hosts": sorted(act.hosts),
            "counters": registry.snapshot()["counters"],
        }, indent=2, sort_keys=True)
        if ns.stats_json == "-":
            print(payload)
        else:
            with open(ns.stats_json, "w") as fh:
                fh.write(payload + "\n")
            print(f"wrote {ns.stats_json}")
    return 0 if all_clean else 1


if __name__ == "__main__":
    sys.exit(main())
