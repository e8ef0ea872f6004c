"""The benchmark sweep and the geometry A/B tool, rehearsed on the CPU
(torch ops and the kernels' plain versions at a tiny size), beside the JAX
package's sweep on the same grid."""

import csv

import pytest
import torch

from tpu_stencil.runtime import bench_sweep as jax_sweep

from tpu_stencil_torch import filters
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering
from tpu_stencil_torch.runtime import autotune, bench_sweep
from tpu_stencil_torch.tools import bh_fuse_ab

# The tensors here are tiny: one thread each, and the cores stay with the
# other test workers (their wall-clock assertions starve otherwise).
torch.set_num_threads(1)

ROW_KEYS = {"filter", "mode", "size", "backend", "us_per_rep", "reps",
            "total_s", "hbm_gbps", "pct_hbm_peak", "gtx970_40reps_s",
            "speedup_vs_gtx970"}


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))


def test_reference_table_is_the_jax_packages():
    assert bench_sweep._CUDA_40REPS == jax_sweep._CUDA_40REPS
    assert bench_sweep.SIZES == jax_sweep.SIZES
    assert bench_sweep.WIDTH == jax_sweep.WIDTH


def test_quick_sweep_rows(tmp_path):
    path = tmp_path / "s.csv"
    rows = bench_sweep.run_sweep(
        quick=True, filters=["gaussian", "gaussian5"], csv_path=str(path),
        backends=["xla", "pallas", "auto"], frames=2, device="cpu",
        sizes=[16, 24], width=20)
    # sizes x {grey, rgb} x filters x backends, then one frames row each
    assert len(rows) == 2 * 2 * 2 * 3 + 3
    assert all(ROW_KEYS <= set(r) for r in rows)  # the JAX sweep's columns
    assert all(r["exact"] is True for r in rows)
    assert all(r["us_per_rep"] > 0 and r["bound_by"] == "operations"
               for r in rows)
    labels = {r["backend"] for r in rows}
    assert labels == {"xla", "pallas[fused]", "auto:xla"}
    assert [r["size"] for r in rows[:4]] == ["20x16", "20x24"] * 2
    assert rows[-1]["size"] == "20x24 x2 frames"
    assert all(r["gtx970_40reps_s"] is None for r in rows)  # not 1920 wide
    with open(path) as f:
        got = list(csv.DictReader(f))
    assert len(got) == len(rows) and got[0]["backend"] == "xla"
    md = bench_sweep.emit_markdown(rows)
    assert md.count("\n") == len(rows) + 1 and "% of bound" in md


def test_reference_column_and_bound_share():
    measured = (40e-6, "pallas", "fused", None, None, True)
    row = bench_sweep._make_row("gaussian", "rgb", "1920x2520", "auto",
                                measured, 2520 * 1920 * 3, 2520 * 1920 * 3,
                                2520, 1920, 3, 40, 1.017)
    assert row["backend"] == "auto:pallas[fused]"
    assert row["bound_us_per_rep"] == pytest.approx(4.333, abs=1e-3)
    assert row["pct_of_bound"] == pytest.approx(10.8, abs=0.1)
    assert row["speedup_vs_gtx970"] == pytest.approx(1.017 / (40e-6 * 40),
                                                     rel=1e-3)
    assert row["hbm_gbps"] == pytest.approx(2 * 2520 * 1920 * 3 / 8 / 40e-6
                                            / 1e9, rel=1e-3)
    tuned = bench_sweep._label("auto", "pallas", "fused", 32, 4)
    assert tuned == "auto:pallas[fused]@32x4"
    assert bench_sweep._label("pallas", "pallas", "deep", None, None) == (
        "pallas[deep]")
    assert bench_sweep._label("xla", "xla", None, None, None) == "xla"


def test_an_auto_row_times_the_tuned_configuration(monkeypatch):
    monkeypatch.setattr(autotune, "_on_card", lambda device: True)

    def measure(plan, shape, channels, backend, reps=0, schedule=None,
                block_h=None, fuse=None, device=None):
        if backend == "xla":
            return 9e-6
        return 1e-6 if (schedule, block_h, fuse) == ("fused", 16, 4) else 3e-6

    monkeypatch.setattr(autotune, "measure_backend", measure)
    seen = []
    real = cs.iterate

    def spy(x, reps, plan, block_h=None, fuse=None, schedule=None):
        seen.append((block_h, fuse, schedule))
        return real(x, reps, plan, block_h=block_h, fuse=fuse,
                    schedule=schedule)

    monkeypatch.setattr(cs, "iterate", spy)
    (row,) = [r for r in bench_sweep.run_sweep(
        quick=True, backends=["auto"], device="cpu", sizes=[24], width=20)
        if r["mode"] == "rgb"]
    assert row["backend"] == "auto:pallas[fused]@16x4" and row["exact"]
    assert seen and set(seen) == {(16, 4, "fused")}


def test_measurements_run_under_the_retry_policy(monkeypatch):
    from tpu_stencil_torch.resilience import retry

    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA out of memory")
        return "row"

    assert bench_sweep._with_retries(flaky, "x") == "row" and len(calls) == 2
    calls.clear()

    def broken():
        calls.append(1)
        raise _build.KernelBuildError("nvcc not found")

    with pytest.raises(_build.KernelBuildError):
        bench_sweep._with_retries(broken, "x")
    assert calls == [1]  # a kernel that does not build is never retried


def test_sweep_main_on_the_cpu_and_without_a_card(capsys):
    rc = bench_sweep.main(["--quick", "--platform", "cpu", "--sizes", "16",
                           "--width", "20", "--backends", "xla,pallas"])
    out = capsys.readouterr().out
    assert rc == 0 and out.count("| gaussian |") == 4
    if not torch.cuda.is_available():
        assert bench_sweep.main(["--quick"]) == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_bh_fuse_ab_lines_and_usage_errors(capsys):
    rc = bh_fuse_ab.main(["8x2", "16x4", "16x8", "--platform", "cpu",
                          "--shape", "40x24", "--reps", "8", "--rounds", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert out[0].startswith("platform=cpu") and "shipped=(32,8)" in out[0]
    assert [ln.split()[:2] for ln in out[1:]] == [
        ["bh=", "8"], ["bh=", "16"], ["bh=", "16"]]
    for ln in out[1:]:
        assert "us/rep" in ln and "forty=" in ln and ln.endswith("exact=True")
    # a tile past shared memory is named before anything runs
    plan = lowering.plan_filter(filters.get_filter("gaussian"))
    with pytest.raises(ValueError, match="bytes of shared"):
        bh_fuse_ab.parse_candidates(["128x40"], plan, 3)
    for bad in ("12x4", "32", "32x0", "ax4"):
        with pytest.raises(ValueError):
            bh_fuse_ab.parse_candidates([bad], plan, 3)
    with pytest.raises(SystemExit) as e:
        bh_fuse_ab.main(["128x40", "--platform", "cpu"])
    assert e.value.code == 2
    # the default grid is the autotuner's grid plus the shipped default
    grid = {f"{bh}x{fz}" for bh, fz in autotune._GEOMETRY_GRID
            if cs.tile_smem_bytes(plan, bh, fz, 3) <= cs.SMEM_LIMIT}
    assert set(bh_fuse_ab.DEFAULT_GRID) == grid | {"32x8"}


def test_library_variants_hash_their_defines():
    base = _build.library_path("stencil_lab")
    a = _build.library_path("stencil_lab", ("LAB_BODY=3",))
    b = _build.library_path("stencil_lab", ("LAB_BODY=3", "LAB_NO_MASK=1"))
    assert len({base, a, b}) == 3
    assert a == _build.library_path("stencil_lab", ("LAB_BODY=3",))
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith(
        "libstencil_lab-") for p in (base, a, b))
    assert _build.SOURCES["stencil_lab"] == ("stencil_lab.cu",
                                             "stencil_tile.cuh")
    assert _build.SOURCES["op_chain"] == ("op_chain.cu",)
    with pytest.raises(KeyError):
        _build.library_path("stencil_nope", ("X=1",))
    if _build.shutil.which("nvcc") is None and not any(
            (r and __import__("os").access(f"{r}/bin/nvcc", 1))
            for r in (__import__("os").environ.get("CUDA_HOME"),
                      "/usr/local/cuda")):
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.build([("stencil_lab", ("LAB_BODY=1",))])
