"""Kernel-instance introspection and device-memory telemetry of the port.

The port has no compiler to ask (its kernels are hand-written CUDA), so
``capture`` records the kernel instances the warm-up launched from the
host's models and, on a card, the library's own queries; the compiler's
byte count reads "unavailable", the JAX module's documented degradation,
and ``cross_check`` matches the JAX one wherever both counts exist. On the
CPU the device-memory instruments record nothing, as the JAX package's do
on its CPU backend. Inputs: seeded 64x48 images; exact comparisons.
"""

import os

import numpy as np
import pytest
import torch

from tpu_stencil import obs as jobs
from tpu_stencil.obs import introspect as jintrospect
from tpu_stencil_torch import cli as tcli
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import filters, obs
from tpu_stencil_torch.obs import introspect
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering
from tpu_stencil_torch.runtime import roofline
from tpu_stencil_torch.serve.metrics import Registry

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 48, 64
GAUSS = lowering.plan_filter(filters.get_filter("gaussian"))


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _src(tmp_path, channels=3):
    shape = (H, W) + ((3,) if channels == 3 else ())
    img = np.random.default_rng(9).integers(0, 256, shape, np.uint8)
    path = tmp_path / "in.raw"
    img.tofile(path)
    return str(path)


def _run(tmp_path, extra, reps=11, mesh=False):
    argv = [_src(tmp_path), str(W), str(H), str(reps), "rgb", *extra,
            "--output", str(tmp_path / "o.raw")]
    cfg, _ = tconfig.parse_args(argv)
    return cfg, tdriver.run_job(cfg, devices=[CPU] * (4 if mesh else 1))


def test_capture_disabled_returns_none():
    assert introspect.capture("x", lambda: {"kernels": []}) is None
    assert introspect.records() == []


def test_capture_never_raises_on_a_broken_describe():
    introspect.enable()

    def broken():
        raise RuntimeError("boom")

    rec = introspect.capture("driver.warmup", broken)
    assert rec["available"] is False and "RuntimeError: boom" in rec["error"]
    assert obs.snapshot()["counters"][
        "introspect_driver_warmup_captures_total"] == 1


def test_reset_clears_records_and_disarms():
    introspect.enable(hlo_dir="/nonexistent")
    introspect.capture("a", lambda: {"kernels": []})
    assert introspect.records() and introspect.enabled()
    introspect.reset()
    assert introspect.records() == [] and not introspect.enabled()


@pytest.mark.parametrize("ok_bytes,model,pct,drift", [
    (1000.0, 900.0, 90.0, False), (1000.0, 100.0, 10.0, True),
    (None, 100.0, None, None),
])
def test_cross_check_matches_jax(ok_bytes, model, pct, drift):
    rec = {"site": "s", "bytes_accessed": ok_bytes}
    jrec = dict(rec)
    introspect.cross_check(rec, model, registry=Registry())
    jintrospect.cross_check(jrec, model, registry=Registry())
    assert rec == jrec
    assert rec["drift"] is drift and (
        pct is None or rec["model_vs_xla_pct"] == pytest.approx(pct))


def test_driver_warmup_capture_records_the_warm_instances(tmp_path):
    introspect.enable()
    cfg, res = _run(tmp_path, ["--backend", "pallas"])
    (rec,) = introspect.records()
    assert rec["site"] == "driver.warmup"
    assert rec["meta"]["warm_reps"] == [8, 1]
    assert [k["fuse"] for k in rec["kernels"]] == [8, 1]
    k8 = rec["kernels"][0]
    # K1 runs gaussian in its register body, at that body's own tile.
    assert k8["kernel"] == "stencil_fused" and k8["body"] == "regs"
    th, tw, warps = cs.regs_geometry(GAUSS, 3, 8)
    assert k8["block_h"] == th and k8["tile_w"] == tw
    assert k8["grid"] == [-(-W * 3 // tw), -(-H // th)]
    assert k8["threads"] == 32 * warps
    assert k8["smem_bytes"] == cs.regs_smem_bytes()
    # Its single-rep remainder on this 48x64 image would leave most SMs
    # idle in regs: the shared tile runs it.
    k1 = rec["kernels"][1]
    assert (k1["body"], k1["block_h"], k1["tile_w"]) == ("swar", 32,
                                                         cs.TILE_W)
    # Registers and occupancy are the card's; the compiler count does not
    # exist for a hand-written kernel.
    assert k8["registers"] is None and k8["blocks_per_sm"] is None
    assert rec["available"] is False and rec["bytes_accessed"] is None
    assert rec["model_bytes_per_rep"] == roofline.analytic_bytes_per_rep(
        cfg.nbytes, "pallas", "gaussian", H, w_img=W, channels=3, reps=11)
    assert rec["model_ops_per_rep"] == cfg.nbytes * 5
    gauges = obs.snapshot()["gauges"]
    assert gauges["introspect_driver_warmup_smem_bytes"]["value"] == k8[
        "smem_bytes"]


def test_resident_and_torch_ops_captures(tmp_path):
    introspect.enable()
    _run(tmp_path, ["--backend", "pallas", "--schedule", "deep"])
    (rec,) = introspect.records()
    (k2,) = rec["kernels"]
    bh, fz = cs.resident_geometry(GAUSS, H, W * 3, 3)
    assert (k2["kernel"], k2["block_h"], k2["fuse"]) == (
        "stencil_resident", bh, fz)
    assert k2["grid"] is None  # the co-resident grid is the card's
    introspect.reset()
    introspect.enable()
    _run(tmp_path, ["--backend", "xla"])
    (rec,) = introspect.records()
    assert rec["kernels"] == [] and "torch ops" in rec["error"]


def test_sharded_capture_names_k3_per_tile(tmp_path):
    introspect.enable()
    _run(tmp_path, ["--backend", "pallas", "--mesh", "2x2"], mesh=True)
    (rec,) = introspect.records()
    assert rec["site"] == "sharded.iterate"
    assert [(k["kernel"], k["fuse"], k["launches"]) for k in
            rec["kernels"]] == [("stencil_valid", 8, 4),
                                ("stencil_valid", 1, 4)]
    assert rec["kernels"][0]["grid"] == [-(-(W // 2) * 3 // cs.TILE_W),
                                         -(-(H // 2) // 32)]


def test_device_memory_unavailable_on_cpu():
    assert introspect.device_memory_stats() is None or torch.cuda.is_available()
    assert introspect.device_memory_stats(CPU) is None
    reg = Registry()
    assert introspect.record_memory_gauges(reg, device=CPU) is None
    assert reg.snapshot()["gauges"] == {}
    assert "unavailable" in obs.breakdown.render_memory(None)
    line = obs.breakdown.render_memory({"bytes_in_use": 2e6,
                                        "bytes_limit": 8e10})
    assert line == "device memory: bytes_in_use=2.00MB bytes_limit=80000.00MB\n"


def test_cli_breakdown_shows_instances_and_hlo_dump_writes_nothing(
        tmp_path, capsys):
    hlo = tmp_path / "hlo"
    rc = tcli.main([_src(tmp_path), str(W), str(H), "11", "rgb",
                    "--platform", "cpu", "--backend", "pallas",
                    "--breakdown", "--hlo-dump", str(hlo),
                    "--metrics-text", str(tmp_path / "m.txt"),
                    "--output", str(tmp_path / "o.raw")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "kernel instances (introspection)" in out
    # Traced, the window launches one rep at a time: that is the instance
    # the warm-up launched, in the shared tile on this small image.
    assert "stencil_fused body=swar tile=32x256 fuse=1 " in out
    assert "compiler MB/rep" in out and "unavailable" in out
    assert "device memory: unavailable" in out
    assert f"hlo-dump: nothing written to {hlo}" in out
    assert not hlo.exists()
    text = (tmp_path / "m.txt").read_text()
    assert text.startswith("# NOTE device memory gauges unavailable")
    snap = obs.exposition.parse_text(text, prefix="tpu_stencil_driver")
    assert any(k.startswith("introspect_") for k in snap["gauges"])


def test_hlo_dump_alone_arms_capture_without_tracing(tmp_path, capsys):
    rc = tcli.main([_src(tmp_path), str(W), str(H), "2", "rgb",
                    "--platform", "cpu", "--hlo-dump", str(tmp_path / "h"),
                    "--output", str(tmp_path / "o.raw")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "hlo-dump: nothing written" in out and "phase " not in out


def test_metrics_text_notes_roundtrip():
    reg = Registry()
    reg.gauge("device_bytes_in_use").set(123456789)
    reg.gauge("device_bytes_limit").set(85520809984)
    snap = reg.snapshot()
    text = obs.exposition.render_text(snap, prefix="tpu_stencil_driver",
                                      notes=("a note the parser ignores",))
    assert text.startswith("# NOTE a note")
    assert obs.exposition.parse_text(text, prefix="tpu_stencil_driver") == snap


PTXAS = """ptxas info    : Compiling entry function '_Z20stencil_fused_kernelILi3ELi2EEvPKhPh14StencilParams' for 'sm_90a'
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z20stencil_fused_kernelILi0ELi0EEvPKhPh14StencilParams' for 'sm_90a'
ptxas info    : Used 56 registers
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z25stencil_fused_regs_kernelILi3ELi3EEvPKhPh13StencilParams15StencilGeometryiii' for 'sm_90a'
ptxas info    : Used 127 registers, used 1 barriers
# build_seconds 12.500
"""


def test_ptxas_instances_and_build_seconds(tmp_path, monkeypatch):
    got = _build.ptxas_instances(PTXAS)
    assert got[(3, 2)] == {"registers": 40}
    assert got[(3, cs.K1_BODIES.index("regs"), 3)] == {"registers": 127}
    assert got[(0, 0)]["registers"] == 56 and "spill" in got[(0, 0)]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    path = _build.library_path("stencil_fused")
    path.with_name(path.name + ".log").write_text(PTXAS)
    assert _build.build_seconds("stencil_fused") == 12.5
    assert cs._instance_registers("stencil_fused", GAUSS, "swar",
                                  3) == {"registers": 40}
    assert cs._instance_registers("stencil_fused", GAUSS, "regs", 3) == {
        "registers": 127}
    assert cs._instance_registers("stencil_fused", GAUSS, "regs", 1) is None
    edge = lowering.plan_filter(filters.get_filter("edge"))
    assert cs.tile_body(edge) == "int32"
    assert cs._instance_registers("stencil_fused", edge, "int32",
                                  3)["registers"] == 56
    assert _build.build_seconds("stencil_valid") is None
    assert os.path.exists(str(path) + ".log")
