"""The port's replica quarantine against the JAX package's, on the CPU.

Mirrors the board and prober cases of ``tests/test_integrity.py``: K
mismatches within the window trip a replica, old mismatches age out, clean
verdicts never trip, re-admission takes N consecutive clean probes, the
operator releases; and the prober (a seeded 24x32 grey probe at 2 reps,
held against the NumPy golden) re-admits a healthy replica and keeps a
corrupting one out. The same verdict sequences drive the JAX package's
board beside the port's, which must agree transition for transition.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from tpu_stencil import filters as jfilters
from tpu_stencil.integrity import quarantine as jquarantine
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil.serve.metrics import Registry as JRegistry
from tpu_stencil_torch import obs
from tpu_stencil_torch.config import ServeConfig
from tpu_stencil_torch.integrity import quarantine
from tpu_stencil_torch.resilience import faults
from tpu_stencil_torch.serve.engine import StencilServer
from tpu_stencil_torch.serve.metrics import Registry

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_STENCIL_TORCH_FLIGHTREC_DIR",
                       str(tmp_path / "flightrec"))
    faults.clear()
    obs.reset()
    yield
    faults.clear()
    obs.reset()


def _board(**kw):
    reg = Registry()
    kw.setdefault("quarantine_after", 3)
    kw.setdefault("window_s", 60.0)
    kw.setdefault("readmit_after", 2)
    return quarantine.QuarantineBoard(reg, **kw), reg


def test_board_trips_after_k_mismatches():
    board, reg = _board()
    assert not board.record_witness(0, False)
    assert not board.record_witness(0, False)
    assert not board.is_quarantined(0)
    assert board.record_witness(0, False)  # K=3 trips
    assert board.is_quarantined(0)
    assert reg.counter("integrity_quarantines_total").value == 1
    assert reg.gauge("replica_quarantined_dev0").value == 1
    assert not board.record_witness(0, False)
    assert reg.counter("integrity_quarantines_total").value == 1


def test_board_window_expires_old_mismatches():
    board, _ = _board(window_s=0.05)
    board.record_witness(0, False)
    board.record_witness(0, False)
    time.sleep(0.08)
    assert not board.record_witness(0, False)  # the first two aged out
    assert not board.is_quarantined(0)


def test_board_ok_verdicts_never_trip():
    board, _ = _board()
    for _ in range(10):
        board.record_witness(1, True)
    assert not board.is_quarantined(1)


def test_board_readmits_after_consecutive_clean_probes():
    board, reg = _board(readmit_after=2)
    board.quarantine(0, "test")
    assert not board.record_probe(0, True)
    assert not board.record_probe(0, False)  # dirty: streak resets
    assert not board.record_probe(0, True)
    assert board.record_probe(0, True)       # 2 consecutive clean
    assert not board.is_quarantined(0)
    assert reg.counter("integrity_readmits_total").value == 1
    assert not board.record_probe(0, True)


def test_board_operator_release():
    board, _ = _board()
    board.quarantine(2, "operator")
    assert board.release(2, "operator")
    assert not board.is_quarantined(2)
    assert not board.release(2, "operator")  # idempotent
    assert "quarantine_after" in board.statusz()


@pytest.mark.parametrize("kw", [dict(quarantine_after=0),
                                dict(readmit_after=0), dict(window_s=0.0)])
def test_board_refuses_bad_knobs_as_the_jax_package(kw):
    with pytest.raises(ValueError) as port_err:
        quarantine.QuarantineBoard(Registry(), **kw)
    with pytest.raises(ValueError) as jax_err:
        jquarantine.QuarantineBoard(JRegistry(), **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_board_transitions_equal_the_jax_package():
    # One seeded stream of witness verdicts, probes and operator actions
    # over three replicas, through both boards: every return value, the
    # statusz view and the registry counters and gauges agree.
    rng = np.random.default_rng(5)
    port, preg = _board(quarantine_after=2, readmit_after=2)
    jreg = JRegistry()
    jax = jquarantine.QuarantineBoard(jreg, quarantine_after=2,
                                      window_s=60.0, readmit_after=2)
    for step in range(300):
        idx = int(rng.integers(0, 3))
        kind = rng.random()
        ok = bool(rng.random() < 0.6)
        if kind < 0.5:
            got = (port.record_witness(idx, ok), jax.record_witness(idx, ok))
        elif kind < 0.9:
            got = (port.record_probe(idx, ok), jax.record_probe(idx, ok))
        elif kind < 0.95:
            got = (port.quarantine(idx, "op"), jax.quarantine(idx, "op"))
        else:
            got = (port.release(idx, "operator"),
                   jax.release(idx, "operator"))
        assert got[0] == got[1], step
        assert port.statusz() == jax.statusz(), step
    snap, jsnap = preg.snapshot(), jreg.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert ({k: v["value"] for k, v in snap["gauges"].items()}
            == {k: v["value"] for k, v in jsnap["gauges"].items()})


class _Fleet:
    """A fleet stand-in: the prober only reads ``replicas``."""

    def __init__(self, replicas):
        self.replicas = replicas


def test_prober_probe_image_and_golden_equal_the_jax_package():
    reg = Registry()
    board, _ = _board()
    prober = quarantine.QuarantineProber(_Fleet([]), board, "gaussian",
                                         0.0, reg)
    jprober = jquarantine.QuarantineProber(_Fleet([]), None, "gaussian",
                                           0.0, JRegistry())
    assert (quarantine.QuarantineProber.PROBE_SHAPE
            == jquarantine.QuarantineProber.PROBE_SHAPE)
    assert (quarantine.QuarantineProber.PROBE_REPS
            == jquarantine.QuarantineProber.PROBE_REPS)
    assert np.array_equal(prober._img, jprober._img)
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.ops import stencil

    want = stencil.reference_stencil_numpy(
        prober._img, filters.get_filter("box"), 2)
    jwant = jstencil.reference_stencil_numpy(
        jprober._img, jfilters.get_filter("box"), 2)
    assert np.array_equal(want, jwant)


def test_prober_readmits_a_clean_replica_and_keeps_a_corrupting_one_out():
    # Replica 0 answers its probes exactly (K1's plain version on the
    # CPU); replica 1 corrupts every result. Only replica 0 comes back.
    reg = Registry()
    board, breg = _board(readmit_after=2)
    faults.configure("integrity.corrupt_result:times=0:p=1.0")
    bad = StencilServer(ServeConfig(backend="pallas"), device=CPU)
    faults.clear()
    good = StencilServer(ServeConfig(backend="pallas"), device=CPU)
    try:
        prober = quarantine.QuarantineProber(
            _Fleet([good, bad]), board, "gaussian", 0.0, reg)
        board.quarantine(0, "test")
        board.quarantine(1, "test")
        assert not prober.probe_once(0)
        assert prober.probe_once(0)           # two clean: re-admitted
        for _ in range(3):
            assert not prober.probe_once(1)   # dirty every time
        assert not board.is_quarantined(0) and board.is_quarantined(1)
        c = reg.snapshot()["counters"]
        assert c["integrity_probes_total"] == 5
        assert c["integrity_probe_failures_total"] == 3
        assert breg.counter("integrity_readmits_total").value == 1
        # Every probe was one batch of the probe image at 2 reps.
        assert good.stats()["counters"]["batches_total"] == 2
        assert bad.stats()["counters"]["batches_total"] == 3
    finally:
        good.close(timeout=30)
        bad.close(timeout=30)


def test_prober_counts_an_erroring_replica_dirty():
    class Broken:
        def submit(self, *a, **k):
            raise RuntimeError("replica gone")

    reg = Registry()
    board, _ = _board(readmit_after=1)
    board.quarantine(0, "test")
    prober = quarantine.QuarantineProber(_Fleet([Broken()]), board,
                                         "gaussian", 0.0, reg)
    assert not prober.probe_once(0)
    assert board.is_quarantined(0)
    assert reg.snapshot()["counters"]["integrity_probe_failures_total"] == 1


def test_prober_thread_readmits_in_the_background():
    reg = Registry()
    board, _ = _board(readmit_after=2)
    server = StencilServer(ServeConfig(backend="pallas"), device=CPU)
    prober = quarantine.QuarantineProber(_Fleet([server]), board,
                                         "gaussian", 0.02, reg).start()
    try:
        board.quarantine(0, "test")
        deadline = time.monotonic() + 60
        while board.is_quarantined(0) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not board.is_quarantined(0)
    finally:
        prober.stop()
        server.close(timeout=30)
    assert prober._thread is None
