"""A run whose timed path is broken underneath comes out not correct.

Each cell runs on the CPU at a small size (the program's plain versions
of its kernels), the harness's look for a card skipped, with one fault
planted in the program for the run, each that a job cell can have: a
step that returns its state unchanged, an answer altered where it is
produced. (A job is one image on one card: it has no batch to halve and
no exchange to leave out.) The same run unbroken comes out correct.
"""

import time

import pytest
import torch

from benchmark.harness import cell, spec
from benchmark.tests.conftest import SMALL

CELLS = [w["name"] for w in spec.load()["workloads"]]


def _run(workload):
    return cell.run_cell(workload, 2 ** 31 + 99, 0.4, False, ["cpu"],
                         time.perf_counter(), config_override=SMALL)


def _flip(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    flat = t.view(-1)
    flat[flat.numel() // 2] ^= 1
    return t


def _unchanged_step(mp):
    from tpu_stencil_torch.ops import cuda_stencil

    mp.setattr(cuda_stencil, "iterate", lambda x, *a, **k: x.clone())


def _altered_step(mp):
    from tpu_stencil_torch.ops import cuda_stencil

    real = cuda_stencil.iterate
    mp.setattr(cuda_stencil, "iterate", lambda *a, **k: _flip(real(*a, **k)))


FAULTS = [
    ("rgb2520.job.r100", _unchanged_step),
    ("rgb2520.job.r100", _altered_step),
    ("grey5040.job.r100", _unchanged_step),
    ("grey5040.job.r100", _altered_step),
]


@pytest.mark.parametrize("workload", CELLS)
def test_an_unbroken_run_is_correct(workload):
    out = _run(workload)
    assert out.correct, out.checks
    assert out.checks["mismatched_bytes"]["value"] == 0


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_run_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(workload)
    assert not out.correct
    assert out.checks["mismatched_bytes"]["value"] > 0
