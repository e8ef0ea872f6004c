"""The port's elastic control plane (``tpu_stencil_torch.ctrl``) against the
JAX package's contract, on the CPU.

Mirrors ``tests/test_ctrl.py`` test for test, with the port's warm start in
place of ``jax.export``:

* the planner never resizes on one sample; pressure enters only when the
  fast window is unanimous AND the slow window agrees by majority, every
  voluntary resize arms a cooldown, and replacement (a dead or preempted
  owned host) bypasses both;
* scale-in always drains before stop, and preemption launches the
  replacement FIRST;
* warm start ships program-cache *keys* and the importer rebuilds each
  from its own kernel sources. Degradation is typed and counted
  (``ctrl_warmstart_fallbacks_total``): an exporter whose kernel sources
  cannot be fingerprinted (``exporter_unsupported``), another ``torch``
  version or kernel fingerprint (``version_skew``), another platform
  (``platform_skew``), an unknown filter in a key (``malformed_key``), a
  warm run that raises (``deserialize_failed``); after each, the cold path
  is still bit-exact against the JAX package's golden model;
* a warm-started joiner's first request is a program-cache HIT:
  ``cache_misses_total`` stays 0, counter-asserted;
* members run on the card unless the CPU is asked for: the subprocess
  provider passes no ``--platform`` by default, and without a card such a
  launch fails, counted, and nothing runs on the CPU.

Every subprocess a test starts is stopped or killed in a ``finally``
block with a timeout; nothing here asserts on elapsed time.
"""

import copy
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_stencil import filters as jfilters
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil_torch.config import (
    CtrlConfig,
    FedConfig,
    NetConfig,
    ServeConfig,
)
from tpu_stencil_torch.ctrl import (
    HOLD,
    REPLACE,
    SCALE_IN,
    SCALE_OUT,
    CapacityPlanner,
    CapacitySignal,
)
from tpu_stencil_torch.ctrl import warmstart
from tpu_stencil_torch.ctrl.actuator import (
    Actuator,
    HostHandle,
    HostProvider,
    SubprocessProvider,
)
from tpu_stencil_torch.serve.engine import StencilServer

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _pythonpath(monkeypatch):
    # Member subprocesses import the package from this checkout.
    monkeypatch.setenv("PYTHONPATH", REPO)


def _golden(img, reps, name="gaussian"):
    return jstencil.reference_stencil_numpy(img, jfilters.get_filter(name),
                                            reps)


def _post(url, img, reps, http_timeout=300.0):
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    headers = {"X-Width": str(w), "X-Height": str(h),
               "X-Reps": str(reps), "X-Channels": str(channels)}
    req = urllib.request.Request(url + "/v1/blur", data=img.tobytes(),
                                 headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=http_timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url, path, http_timeout=60.0):
    with urllib.request.urlopen(url + path, timeout=http_timeout) as r:
        return r.status, r.read()


# -- config validation --------------------------------------------------


def test_ctrlconfig_validation():
    with pytest.raises(ValueError, match="fed_url"):
        CtrlConfig(fed_url="localhost:8090")
    with pytest.raises(ValueError, match="poll_interval_s"):
        CtrlConfig(poll_interval_s=0)
    with pytest.raises(ValueError, match="max_hosts"):
        CtrlConfig(min_hosts=4, max_hosts=2)
    with pytest.raises(ValueError, match="slow_samples"):
        CtrlConfig(fast_samples=5, slow_samples=3)
    # The threshold ordering contract: 0 < in < hold <= out <= 1.
    with pytest.raises(ValueError):
        CtrlConfig(scale_in_utilization=0.8, hold_utilization=0.7)
    with pytest.raises(ValueError):
        CtrlConfig(hold_utilization=0.9, scale_out_utilization=0.85)
    # The port's own: members on the card by default, never a TPU.
    assert CtrlConfig().member_platform is None
    with pytest.raises(ValueError, match="member_platform"):
        CtrlConfig(member_platform="tpu")


def test_ctrl_cli_flags_and_member_platform_default():
    from tpu_stencil.ctrl import cli as jcli
    from tpu_stencil_torch.ctrl import cli as pcli

    def flags(parser):
        return sorted(o for a in parser._actions for o in a.option_strings)

    parser = pcli.build_parser()
    assert flags(parser) == flags(jcli.build_parser())
    ns = parser.parse_args(["--fed", "http://127.0.0.1:1"])
    assert ns.member_platform is None
    for argv in (["--fed", "localhost:1"],
                 ["--fed", "http://127.0.0.1:1", "--member-platform",
                  "tpu"],
                 ["--fed", "http://127.0.0.1:1", "--min-hosts", "3",
                  "--max-hosts", "2"]):
        with pytest.raises(SystemExit) as exc:
            pcli.main(argv)
        assert exc.value.code == 2, argv


# -- planner hysteresis -------------------------------------------------


def _planner(**overrides):
    kw = dict(fed_url="http://127.0.0.1:1", min_hosts=1, max_hosts=4,
              fast_samples=2, slow_samples=3, cooldown_samples=2,
              scale_out_utilization=0.8, hold_utilization=0.5,
              scale_in_utilization=0.2, saturation_horizon_s=0.0)
    kw.update(overrides)
    return CapacityPlanner(CtrlConfig(**kw))


def _sig(util, **kw):
    return CapacitySignal(utilization=util, **kw)


def test_planner_never_flaps_on_one_sample():
    p = _planner()
    d = p.observe(_sig(0.99), owned_hosts=1)
    assert d.action == HOLD


def test_planner_scale_out_enter_then_cooldown():
    p = _planner()
    # Windows fill: fast=2 unanimous + slow=3 majority → entry on the
    # 3rd pressured sample, not before.
    assert p.observe(_sig(0.95), 1).action == HOLD
    assert p.observe(_sig(0.95), 1).action == HOLD
    d = p.observe(_sig(0.95), 1)
    assert d.action == SCALE_OUT and d.count == 1
    # Cooldown (2 samples) gates the next voluntary resize.
    assert p.observe(_sig(0.95), 2).action == HOLD
    assert p.observe(_sig(0.95), 2).action == HOLD
    # Pressure still held past the cooldown → grow again.
    assert p.observe(_sig(0.95), 2).action == SCALE_OUT
    snap = p.registry.snapshot()["counters"]
    assert snap["ctrl_scale_out_total"] == 2
    assert snap["ctrl_decisions_total"] == 6


def test_planner_pressure_holds_until_below_hold_threshold():
    p = _planner()
    for _ in range(3):
        p.observe(_sig(0.95), 1)
    # 0.6 is below the 0.8 enter threshold but above the 0.5 hold
    # threshold: pressure HOLDS (asymmetric exit).
    p.observe(_sig(0.6), 2)   # cooldown 2 → 1
    p.observe(_sig(0.6), 2)   # cooldown 1 → 0
    assert p.observe(_sig(0.6), 2).action == SCALE_OUT
    # Fast-window mean falling under 0.5 releases the pressure latch.
    p.observe(_sig(0.3), 3)   # cooldown (armed again) 2 → 1
    p.observe(_sig(0.3), 3)   # cooldown 1 → 0; fast mean 0.3 < 0.5
    assert p.observe(_sig(0.3), 3).action == HOLD


def test_planner_scale_in_needs_full_slow_window_and_floor():
    p = _planner()
    assert p.observe(_sig(0.05), 2).action == HOLD
    assert p.observe(_sig(0.05), 2).action == HOLD
    d = p.observe(_sig(0.05), 2)
    assert d.action == SCALE_IN and d.count == 1
    # Cooldown after the shrink too.
    assert p.observe(_sig(0.05), 1).action == HOLD
    assert p.observe(_sig(0.05), 1).action == HOLD
    # At the min_hosts floor the planner never shrinks further.
    assert p.observe(_sig(0.05), 1).action == HOLD


def test_planner_replace_bypasses_windows_and_cooldown():
    p = _planner()
    for _ in range(3):
        p.observe(_sig(0.95), 1)  # arms the cooldown via SCALE_OUT
    d = p.observe(_sig(0.95, dead_hosts=1, preempted_hosts=1), 2)
    assert d.action == REPLACE and d.count == 2
    assert "dead" in d.reason and "preempted" in d.reason
    assert p.registry.snapshot()["counters"]["ctrl_replace_total"] == 2


def test_planner_floor_repair_is_immediate():
    p = _planner(min_hosts=2)
    d = p.observe(_sig(None), owned_hosts=0)
    assert d.action == SCALE_OUT and d.count == 2
    assert "min_hosts" in d.reason


def test_planner_holds_at_max_hosts():
    p = _planner()
    for _ in range(2):
        p.observe(_sig(0.95), 4)
    d = p.observe(_sig(0.95), 4)
    assert d.action == HOLD and "max_hosts" in d.reason


def test_planner_unknown_samples_are_no_evidence():
    p = _planner()
    for _ in range(6):
        assert p.observe(_sig(None), 2).action == HOLD


def test_planner_saturation_forecast_counts_as_pressure():
    p = _planner(saturation_horizon_s=30.0)
    for _ in range(2):
        p.observe(_sig(0.1, time_to_saturation_s=5.0), 1)
    d = p.observe(_sig(0.1, time_to_saturation_s=5.0), 1)
    assert d.action == SCALE_OUT


# -- warm-start wire format ---------------------------------------------


def test_warmstart_key_wire_roundtrip_and_geometry():
    key = ("gaussian", (32, 32), 3, "uint8", "xla", 5, 2)
    assert warmstart._key_from_wire(warmstart._key_to_wire(key)) == key
    assert warmstart._key_geometry(key) == (2, 32, 32, 3)
    gray = ("gaussian", (16, 16), 1, "uint8", "xla", 5, 1)
    assert warmstart._key_geometry(gray) == (1, 16, 16)
    # Sharded and non-uint8 entries are never shipped.
    assert warmstart._key_geometry(key + ("sharded",)) is None
    assert warmstart._key_geometry(
        ("gaussian", (32, 32), 3, "float32", "xla", 5, 1)) is None
    assert warmstart.loads(b"not json {") is None
    assert warmstart.loads(b"[1, 2]") is None
    # The port rebuilds a key, so it must name a filter it knows.
    warmstart._check_key(key)
    with pytest.raises(ValueError, match="bogus"):
        warmstart._check_key(("bogus",) + key[1:])
    with pytest.raises(ValueError):
        warmstart._check_key(("gaussian", (32, 32), 2, "uint8", "xla", 5,
                              1))
    assert "no_jax_export" in warmstart.FALLBACK_REASONS


# -- warm-start round trip + degradation --------------------------------

_IMG = np.arange(24 * 32 * 3, dtype=np.uint8).reshape(24, 32, 3)
_REPS = 2


def _fresh_server():
    return StencilServer(ServeConfig(backend="pallas", max_queue=64),
                         device=CPU)


@pytest.fixture(scope="module")
def warm_state():
    """(envelope, golden) from a warm exporter server."""
    with _fresh_server() as a:
        out = a.submit(_IMG, reps=_REPS).result(timeout=300)
        env = a.export_warm_state()
    golden = _golden(_IMG, _REPS)
    np.testing.assert_array_equal(out, golden)
    assert not env.get("unsupported") and len(env["entries"]) == 1
    assert set(env) == {"schema_version", "torch", "platform", "kernels",
                        "entries"}
    assert env["platform"] == "cpu" and env["torch"] == torch.__version__
    # Keys, never binaries.
    assert env["entries"] == [{"key": ["gaussian", [24, 32], 3, "uint8",
                                       "pallas", _REPS, 1]}]
    return env, golden


def test_warmstart_roundtrip_zero_miss_bitexact(warm_state):
    env, golden = warm_state
    with _fresh_server() as b:
        summary = b.import_warm_state(copy.deepcopy(env))
        assert summary["imported"] >= 1
        assert summary["fallbacks"] == 0
        mid = b.registry.snapshot()["counters"]
        out = b.submit(_IMG, reps=_REPS).result(timeout=300)
        np.testing.assert_array_equal(out, golden)
        snap = b.registry.snapshot()["counters"]
    # The warm run itself counted no request, batch, hit or miss.
    assert mid.get("requests_total", 0) == 0
    assert mid.get("batches_total", 0) == 0
    assert mid.get("cache_hits_total", 0) == 0
    # The joiner's first request is a HIT: zero misses, counter-exact.
    assert snap.get("cache_misses_total", 0) == 0
    assert snap.get("cache_hits_total", 0) >= 1
    assert snap["ctrl_warmstart_imported_total"] == summary["imported"]
    assert snap.get("ctrl_warmstart_fallbacks_total", 0) == 0


def test_warmstart_degrades_without_kernel_sources(warm_state, monkeypatch):
    env, golden = warm_state
    n = len(env["entries"])
    with _fresh_server() as b:
        monkeypatch.setattr(warmstart, "_kernel_fingerprint", lambda: None)
        # Import side: a host that cannot fingerprint its own sources
        # cannot promise the exporter's kernels.
        summary = b.import_warm_state(copy.deepcopy(env))
        assert summary["imported"] == 0
        assert summary["reasons"] == {"version_skew": n}
        # Export side: the envelope itself is typed unsupported…
        unsup = warmstart.export_server(b)
        assert unsup["unsupported"] and unsup["entries"] == []
        monkeypatch.undo()
        # …and a supported importer degrades it typed too.
        summary2 = b.import_warm_state(unsup)
        assert summary2["reasons"] == {"exporter_unsupported": 1}
        snap = b.registry.snapshot()["counters"]
        assert snap["ctrl_warmstart_fallbacks_total"] == n + 1
        # The cold path is exactly as it was: bit-exact, just a miss.
        out = b.submit(_IMG, reps=_REPS).result(timeout=300)
        np.testing.assert_array_equal(out, golden)
        assert b.registry.snapshot()["counters"]["cache_misses_total"] >= 1


@pytest.mark.parametrize("field,value,reason", [
    ("torch", "0.0.0-skew", "version_skew"),
    ("kernels", "000000000000", "version_skew"),
    ("platform", "cuda", "platform_skew"),
])
def test_warmstart_degrades_on_version_skew(warm_state, field, value,
                                            reason):
    env, golden = warm_state
    n = len(env["entries"])
    skewed = copy.deepcopy(env)
    skewed[field] = value
    with _fresh_server() as b:
        summary = b.import_warm_state(skewed)
        assert summary["imported"] == 0
        assert summary["reasons"] == {reason: n}
        snap = b.registry.snapshot()["counters"]
        assert snap["ctrl_warmstart_fallbacks_total"] == n
        out = b.submit(_IMG, reps=_REPS).result(timeout=300)
        np.testing.assert_array_equal(out, golden)
        assert b.registry.snapshot()["counters"]["cache_misses_total"] == 1


def test_warmstart_degrades_when_the_warm_run_raises(warm_state,
                                                     monkeypatch):
    # The port's deserialize_failed: the rebuild or the warm run raised
    # (a kernel that cannot build); the entry is not seeded, the request
    # after the repair builds cold and is bit-exact.
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs

    env, golden = warm_state
    broken = copy.deepcopy(env)
    broken["entries"].append(copy.deepcopy(broken["entries"][0]))

    def refuse(*_a, **_k):
        raise _build.KernelBuildError("forced build failure")

    with _fresh_server() as b:
        monkeypatch.setattr(cs, "stencil_fused", refuse)
        summary = b.import_warm_state(broken)
        assert summary["reasons"] == {"deserialize_failed": 2}
        assert b.warm_keys() == []
        monkeypatch.undo()
        out = b.submit(_IMG, reps=_REPS).result(timeout=300)
        np.testing.assert_array_equal(out, golden)
        assert b.registry.snapshot()["counters"]["cache_misses_total"] == 1


def test_warmstart_degrades_on_bad_envelope(warm_state):
    env, golden = warm_state
    with _fresh_server() as b:
        assert b.import_warm_state(None)["reasons"] == {
            "payload_unavailable": 1
        }
        assert b.import_warm_state({"schema_version": 99})["reasons"] == {
            "schema_mismatch": 1
        }
        bad_key = copy.deepcopy(env)
        bad_key["entries"] = [
            {"key": ["x"]},
            {"key": ["bogus", [32, 32], 3, "uint8", "pallas", 2, 1]},
            {},
        ]
        assert b.import_warm_state(bad_key)["reasons"] == {
            "malformed_key": 3
        }
        # A cold exporter (no entries) is NOT a degradation.
        empty = {k: v for k, v in env.items()}
        empty["entries"] = []
        summary = b.import_warm_state(empty)
        assert summary == {"imported": 0, "fallbacks": 0, "reasons": {}}
        out = b.submit(_IMG, reps=_REPS).result(timeout=300)
        np.testing.assert_array_equal(out, golden)


# -- actuator (fake provider) -------------------------------------------


class _FakeProvider(HostProvider):
    def __init__(self, fail_launches=0):
        self.events = []
        self.n = 0
        self.fail_launches = fail_launches
        self.dead = set()
        self.dirty = set()

    def launch(self):
        if self.fail_launches > 0:
            self.fail_launches -= 1
            raise RuntimeError("no capacity")
        self.n += 1
        hid = f"fake_{self.n}"
        self.events.append(f"launch {hid}")
        return HostHandle(host_id=hid, url=f"http://fake-{self.n}:1")

    def stop(self, handle, timeout_s):
        self.events.append(f"stop {handle.host_id}")
        return handle.host_id not in self.dirty

    def alive(self, handle):
        return handle.host_id not in self.dead


def _fake_actuator(**overrides):
    prov = _FakeProvider()
    cfg = CtrlConfig(fed_url="http://127.0.0.1:1", **overrides)
    act = Actuator(cfg, prov)
    # Record the fed-admin calls in the same event stream so ordering
    # assertions see drains and notices interleaved with stops.
    act._fed_post = lambda path: prov.events.append(f"post {path}") or {}
    return act, prov


def test_actuator_lifecycle_and_reconcile():
    act, prov = _fake_actuator()
    handles = act.scale_out(2)
    assert [h.host_id for h in handles] == ["fake_1", "fake_2"]
    assert len(act.hosts) == 2
    # Victim pick is LIFO: the newest host carries the coldest cache.
    assert act._pick_victim() == "fake_2"
    assert act.scale_in() is True
    assert prov.events[-2:] == ["post /admin/drain?host=fake_2",
                                "stop fake_2"]
    # kill -9: reconcile reports and forgets; replacing is the planner's
    # decision, not an actuator reflex.
    prov.dead.add("fake_1")
    assert act.reconcile() == ["fake_1"]
    assert act.hosts == {}
    assert act.reconcile() == []
    snap = act.registry.snapshot()
    assert snap["counters"]["ctrl_launches_total"] == 2
    assert snap["counters"]["ctrl_stops_total"] == 1
    assert snap["gauges"]["ctrl_hosts"]["value"] == 0
    assert snap["gauges"]["ctrl_hosts"]["peak"] == 2


def test_actuator_launch_failures_are_counted_not_fatal():
    act, prov = _fake_actuator()
    prov.fail_launches = 1
    handles = act.scale_out(2)
    assert len(handles) == 1
    snap = act.registry.snapshot()["counters"]
    assert snap["ctrl_launch_failures_total"] == 1
    assert snap["ctrl_launches_total"] == 1


def test_actuator_preempt_launches_replacement_first():
    act, prov = _fake_actuator()
    act.scale_out(1)
    prov.events.clear()
    replacements, clean = act.preempt("fake_1")
    assert [h.host_id for h in replacements] == ["fake_2"]
    assert clean is True
    # The choreography: notice → replacement up → only then drain and
    # stop the victim.
    assert prov.events == [
        "post /admin/preempt?host=fake_1",
        "launch fake_2",
        "post /admin/drain?host=fake_1",
        "stop fake_1",
    ]
    snap = act.registry.snapshot()["counters"]
    assert snap["ctrl_preempt_replacements_total"] == 1


def test_actuator_close_reports_dirty_exits():
    act, prov = _fake_actuator()
    act.scale_out(2)
    prov.dirty.add("fake_1")
    assert act.close() is False
    assert act.hosts == {}
    snap = act.registry.snapshot()["counters"]
    assert snap["ctrl_stops_total"] == 2
    assert snap["ctrl_dirty_stops_total"] == 1

    act2, _ = _fake_actuator()
    act2.scale_out(2)
    assert act2.close() is True


# -- members on the card by default --------------------------------------


def test_subprocess_provider_defaults_to_the_card():
    argv = SubprocessProvider(fed_url="http://127.0.0.1:1").argv()
    assert argv[1:4] == ["-m", "tpu_stencil_torch", "net"]
    assert "--platform" not in argv
    assert "tpu_stencil" not in argv
    cpu = SubprocessProvider(platform="cpu", warm_from="http://w:1").argv()
    assert cpu[cpu.index("--platform") + 1] == "cpu"
    assert cpu[cpu.index("--warm-from") + 1] == "http://w:1"


def test_member_without_a_card_fails_its_launch_counted(monkeypatch):
    # No card in the member (CUDA hidden), no platform asked: the member
    # exits 2 with NoDeviceError, the launch counts as failed, and
    # nothing serves on the CPU.
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    cfg = CtrlConfig(fed_url="http://127.0.0.1:1", launch_timeout_s=120.0)
    prov = SubprocessProvider(launch_timeout_s=120.0)
    act = Actuator(cfg, prov)
    with pytest.raises(RuntimeError, match="NoDeviceError") as exc:
        prov.launch()
    assert "rc=2" in str(exc.value)
    assert act.scale_out(1) == []
    snap = act.registry.snapshot()["counters"]
    assert snap["ctrl_launch_failures_total"] == 1
    assert snap["ctrl_launches_total"] == 0
    assert act.hosts == {}


# -- subprocess end-to-end ----------------------------------------------


def _wait(pred, timeout=60.0, interval=0.05, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def test_ctrl_elastic_end_to_end():
    """Launch through the real SubprocessProvider against a real fed:
    serve → kill -9 → reconcile → planner REPLACE → replacement serves →
    drain-clean teardown."""
    from tpu_stencil_torch.fed import FedFrontend

    fed = FedFrontend(FedConfig(
        port=0, heartbeat_interval_s=0.1, suspect_after=2, evict_after=3,
        breaker_threshold=2, reoffer_s=0.2, flightrec_dir=None,
    )).start()
    cfg = CtrlConfig(fed_url=fed.url, min_hosts=1, max_hosts=3,
                     launch_timeout_s=300.0, drain_timeout_s=120.0,
                     member_platform="cpu")
    prov = SubprocessProvider(fed_url=fed.url, platform="cpu",
                              launch_timeout_s=300.0,
                              drain_timeout_s=120.0)
    act = Actuator(cfg, prov)
    planner = CapacityPlanner(cfg)
    img = np.arange(16 * 16 * 3, dtype=np.uint8).reshape(16, 16, 3)
    try:
        (h1,) = act.scale_out(1)
        _wait(lambda: any(m.host_id == h1.host_id and m.state == "healthy"
                          for m in fed.membership.members()),
              what="first host to register")
        status, body = _post(fed.url, img, 3)
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 3))

        # kill -9: the host is GONE, no drain.
        prov.kill(act.hosts[h1.host_id])
        _wait(lambda: act.reconcile() == [h1.host_id] or not act.hosts,
              what="reconcile to report the dead host")
        d = planner.observe(
            CapacitySignal(utilization=None, dead_hosts=1), len(act.hosts)
        )
        assert d.action == REPLACE and d.count == 1
        (h2,) = act.scale_out(d.count)
        _wait(lambda: any(m.host_id == h2.host_id and m.state == "healthy"
                          for m in fed.membership.members()),
              what="replacement to register")
        # The corpse must leave routing before we assert on the
        # replacement, so the forward cannot race an evicting member.
        _wait(lambda: all(m.state in ("evicted", "draining")
                          for m in fed.membership.members()
                          if m.host_id == h1.host_id),
              what="dead host to leave routing")
        status, body = _post(fed.url, img, 3)
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 3))

        assert act.close() is True  # drain-before-stop, rc 0
        snap = act.registry.snapshot()["counters"]
        assert snap["ctrl_launches_total"] == 2
        assert snap["ctrl_stops_total"] == 1
        assert snap["ctrl_dirty_stops_total"] == 0
    finally:
        for h in list(act.hosts.values()):
            prov.kill(h)
        act.close()
        fed.close()


def test_ctrl_warmstart_ships_over_http():
    """A joiner launched with --warm-from pulls the warm member's envelope
    (keys only), rebuilds each entry from its own kernel sources and
    answers its first request with ZERO program-cache misses,
    counter-asserted through the joiner's own /metrics."""
    from tpu_stencil_torch.net import NetFrontend

    img = np.arange(24 * 32 * 3, dtype=np.uint8).reshape(24, 32, 3)
    warm = NetFrontend(NetConfig(port=0, replicas=1, max_queue=64,
                                 prof_dir=None, flightrec_dir=None),
                       devices=[CPU]).start()
    prov = SubprocessProvider(fed_url=None, platform="cpu",
                              warm_from=warm.url,
                              launch_timeout_s=300.0, drain_timeout_s=120.0)
    handle = None
    try:
        status, body = _post(warm.url, img, _REPS)
        assert status == 200
        env = warmstart.loads(_get(warm.url, "/admin/warmstate")[1])
        assert not env.get("unsupported") and env["entries"]
        assert all(set(e) == {"key"} for e in env["entries"])

        handle = prov.launch()
        status, joiner_body = _post(handle.url, img, _REPS)
        assert status == 200
        assert joiner_body == body  # bit-exact across the ship
        metrics = _get(handle.url, "/metrics")[1].decode()

        def scrape(name):
            m = re.search(rf"{name}(?:{{[^}}]*}})?\s+(\d+)", metrics)
            return int(m.group(1)) if m else None

        assert scrape("fleet_ctrl_warmstart_imported_total") >= 1
        assert scrape("fleet_ctrl_warmstart_fallbacks_total") in (0, None)
        assert scrape("fleet_cache_misses_total") == 0
        assert scrape("fleet_cache_hits_total") >= 1
        assert prov.stop(handle, 120.0) is True  # SIGTERM drain, rc 0
        handle = None
    finally:
        if handle is not None:
            prov.kill(handle)
            handle.proc.wait(timeout=30)
        warm.close()


def test_ctrl_cli_runs_members_and_drains_them(tmp_path):
    """``python -m tpu_stencil_torch ctrl`` against a live fed: the floor
    repair launches one CPU member that registers and serves, and at the
    end of --iterations every owned member drains clean (rc 0)."""
    from tpu_stencil_torch.fed import FedFrontend

    fed = FedFrontend(FedConfig(port=0, heartbeat_interval_s=0.2,
                                flightrec_dir=None)).start()
    stats = tmp_path / "ctrl.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_stencil_torch", "ctrl", "--fed",
         fed.url, "--member-platform", "cpu", "--min-hosts", "1",
         "--max-hosts", "2", "--poll-interval", "0.2", "--iterations",
         "3", "--cold", "--stats-json", str(stats)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    try:
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out
        assert "drained 1 owned host(s) cleanly" in out, out
        import json

        doc = json.loads(stats.read_text())
        assert doc["counters"]["ctrl_launches_total"] == 1
        assert doc["counters"]["ctrl_stops_total"] == 1
        assert doc["counters"].get("ctrl_launch_failures_total", 0) == 0
        # The member registered with the fed before it was drained away.
        assert fed.registry.counter("registrations_total").value == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        fed.close()
