"""The port's request ledger and tenant meter against the JAX package's,
and the in-process engine's cost conservation.

Mirrors the engine half of ``tests/test_ledger.py``: tenant-name
sanitizing, the ledger's accumulators and its contextvar binding, the
tenant meter's rows, cap and registry fold, and the loadgen's cost
rollup of ``X-Cost-*`` headers; each on the same inputs through both
packages. Then the engine's attribution on the CPU: every retired
batch's wall lands once, in goodput (requests) or overhead (warm
submits and witness re-executions), and the members' ledgers add up to
it.
"""

import numpy as np
import pytest
import torch

from tpu_stencil.obs import ledger as jledger
from tpu_stencil.serve.loadgen import HttpTarget as JHttpTarget
from tpu_stencil.serve.metrics import Registry as JRegistry
from tpu_stencil_torch import obs
from tpu_stencil_torch.config import ServeConfig
from tpu_stencil_torch.obs import ledger as oledger
from tpu_stencil_torch.serve.engine import StencilServer
from tpu_stencil_torch.serve.loadgen import HttpTarget
from tpu_stencil_torch.serve.metrics import Registry

torch.set_num_threads(1)

CPU = torch.device("cpu")
EDGES = (8, 16, 32, 64)


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    yield
    obs.reset()


@pytest.mark.parametrize("raw", [
    "team-a", "a.b.c", "ok_123", "two words", "", None, 42, "x" * 64,
    "x" * 65, "a/b{c}",
])
def test_sanitize_tenant_guards_the_wire(raw):
    assert oledger.sanitize_tenant(raw) == jledger.sanitize_tenant(raw)


def test_sanitize_tenant_values():
    assert oledger.sanitize_tenant("team-a") == "team_a"
    assert oledger.sanitize_tenant("two words") == oledger.DEFAULT_TENANT
    assert (oledger.TENANT_HEADER, oledger.DEFAULT_TENANT,
            oledger.TENANT_CAP, oledger.OVERFLOW_TENANT) == (
        jledger.TENANT_HEADER, jledger.DEFAULT_TENANT, jledger.TENANT_CAP,
        jledger.OVERFLOW_TENANT)


@pytest.mark.parametrize("mod", [oledger, jledger], ids=["port", "jax"])
def test_ledger_accumulates_and_reads_back_us(mod):
    led = mod.RequestLedger("t1")
    led.add_queue(0.010)
    led.add_coalesce(0.002)
    led.add_ingest(0.001)
    led.add_device(0.5, h2d_bytes=1000, d2h_bytes=2000)
    led.add_device(0.25, h2d_bytes=500)
    led.add_device(-1.0)  # negative spend never subtracts
    snap = led.snapshot()
    assert snap["device_s"] == pytest.approx(0.75)
    assert snap["h2d_bytes"] == 1500 and snap["d2h_bytes"] == 2000
    assert led.device_us == 750000
    assert led.queue_us == 12000
    assert snap["source"] == "compute" and snap["kind"] == "request"


def test_ledger_snapshots_agree():
    a, b = oledger.RequestLedger("t", kind="warm"), jledger.RequestLedger(
        "t", kind="warm")
    for led in (a, b):
        led.add_queue(0.25)
        led.add_device(0.125, h2d_bytes=7, d2h_bytes=9)
        led.set_source("coalesced")
        led.saved_device_s = 0.5
    assert a.snapshot() == b.snapshot()


def test_ledger_contextvar_binding_and_explicit_clear():
    assert oledger.current() is None
    led = oledger.RequestLedger("t")
    with oledger.bind(led):
        assert oledger.current() is led
        with oledger.bind(None):
            assert oledger.current() is None
        assert oledger.current() is led
        # The two packages keep separate bindings.
        assert jledger.current() is None
    assert oledger.current() is None
    tok = oledger.push(led)
    assert oledger.current() is led
    oledger.pop(tok)
    assert oledger.current() is None


def _meter_run(mod, registry_cls):
    reg = registry_cls()
    meter = mod.TenantMeter(reg)
    led = mod.RequestLedger("alpha")
    led.add_device(0.5)
    led.add_queue(0.1)
    meter.record(led, bytes_in=100, bytes_out=300)
    hit = mod.RequestLedger("alpha")
    hit.set_source("cache")
    hit.saved_device_s = 0.5
    meter.record(hit, bytes_in=100, bytes_out=300)
    meter.reject("alpha", 429)
    meter.reject("alpha", 503)
    return meter.snapshot(), reg.snapshot()["counters"]


def test_tenant_meter_records_rejects_and_ratios():
    rows, c = _meter_run(oledger, Registry)
    jrows, jc = _meter_run(jledger, JRegistry)
    assert rows == jrows and c == jc
    row = rows["alpha"]
    assert row["requests"] == 2 and row["offered"] == 4
    assert row["device_seconds"] == pytest.approx(0.5)
    assert row["cache_hits"] == 1 and row["cache_hit_ratio"] == 0.5
    assert row["rejected_429"] == 1 and row["shed_503"] == 1
    assert c["tenant_alpha_requests_total"] == 2


def _cap_run(mod, registry_cls):
    reg = registry_cls()
    meter = mod.TenantMeter(reg)
    for i in range(mod.TENANT_CAP + 5):
        led = mod.RequestLedger(f"t{i:03d}")
        led.add_device(0.001)
        meter.record(led, bytes_in=1, bytes_out=1)
    return meter.snapshot(), reg.snapshot()["counters"]


def test_tenant_meter_cardinality_caps_into_overflow():
    rows, c = _cap_run(oledger, Registry)
    jrows, jc = _cap_run(jledger, JRegistry)
    assert rows == jrows and c == jc
    assert len(rows) == oledger.TENANT_CAP + 1
    assert rows[oledger.OVERFLOW_TENANT]["requests"] == 5
    assert c[f"tenant_{oledger.OVERFLOW_TENANT}_requests_total"] == 5


def test_loadgen_cost_rollup_reads_cost_headers():
    snaps = []
    for cls in (HttpTarget, JHttpTarget):
        t = cls("http://127.0.0.1:1", tenant="smoke")
        t._tally_cost({"X-Cost-Device-Us": "1500",
                       "X-Cost-Queue-Us": "250",
                       "X-Cost-Source": "compute"})
        t._tally_cost({"X-Cost-Device-Us": "0", "X-Cost-Source": "cache"})
        t._tally_cost({})
        t._tally_cost({"X-Cost-Device-Us": "bogus"})
        snaps.append(t.cost_snapshot())
        t.close()
    snap, jsnap = snaps
    assert snap == jsnap
    assert snap["tenant"] == "smoke" and snap["responses"] == 2
    assert snap["device_us"] == 1500 and snap["queue_us"] == 250
    assert snap["by_source"] == {"compute": 1, "cache": 1}


# -- the in-process engine's attribution --------------------------------


def _submit_bound(server, img, reps, ledger):
    with oledger.bind(ledger):
        return server.submit(img, reps)


def test_engine_conservation_goodput_overhead_and_ledgers():
    """Every retired batch's wall is attributed once: the request
    ledgers' device seconds equal goodput, the warm ledgers' (plus the
    witness re-executions) equal overhead, and their sum equals the sum of
    the batch latencies (the dispatch-to-fence wall)."""
    rng = np.random.default_rng(4)
    reqs = [oledger.RequestLedger("alpha") for _ in range(6)]
    warms = [oledger.RequestLedger("fleet", kind="warm") for _ in range(2)]
    with StencilServer(ServeConfig(max_queue=32, max_batch=4,
                                   bucket_edges=EDGES, witness_rate=0.5),
                       start=False, device=CPU) as server:
        futs = []
        for i, led in enumerate(reqs + warms):
            shape = (12, 10, 3) if i % 2 else (9, 14)
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            futs.append(_submit_bound(server, img, 2, led))
        futs.append(server.submit(                      # no ledger: goodput
            rng.integers(0, 256, (7, 7), dtype=np.uint8), 1))
        server.start()
        for f in futs:
            f.result(timeout=120)
    stats = server.stats()
    c = stats["counters"]
    batch_wall = stats["histograms"]["batch_latency_seconds"]["sum"]
    req_s = sum(led.device_s for led in reqs)
    warm_s = sum(led.device_s for led in warms)
    assert all(led.device_s > 0 and led.queue_s >= 0 for led in reqs + warms)
    assert c["goodput_device_seconds_total"] >= req_s * (1 - 1e-9)
    assert c["overhead_device_seconds_total"] == pytest.approx(
        warm_s + c["witness_device_seconds_total"], rel=1e-9)
    assert (c["goodput_device_seconds_total"]
            + c["overhead_device_seconds_total"]
            - c["witness_device_seconds_total"]) == pytest.approx(
        batch_wall, rel=1e-9)
    # Bytes: the members' shares add up to at most the batch's bytes.
    assert sum(led.h2d_bytes for led in reqs + warms) <= c["h2d_bytes_total"]
    assert sum(led.d2h_bytes for led in reqs + warms) <= c["d2h_bytes_total"]
    assert c["h2d_bytes_total"] > 0 and c["d2h_bytes_total"] > 0


def test_engine_credits_by_pixel_share():
    # Two members of one batch, 8x8 and 4x4 grey: a 4:1 pixel split.
    big, small = oledger.RequestLedger("a"), oledger.RequestLedger("b")
    rng = np.random.default_rng(5)
    with StencilServer(ServeConfig(max_queue=8, max_batch=4,
                                   bucket_edges=(8,)), start=False,
                       device=CPU) as server:
        f1 = _submit_bound(server, rng.integers(0, 256, (8, 8), np.uint8),
                           1, big)
        f2 = _submit_bound(server, rng.integers(0, 256, (4, 4), np.uint8),
                           1, small)
        server.start()
        f1.result(timeout=60)
        f2.result(timeout=60)
    assert server.stats()["counters"]["batches_total"] == 1
    assert big.device_s == pytest.approx(4 * small.device_s, rel=1e-9)
