"""The fallback ladder of the port against the JAX package's.

The rungs and their labels must be the JAX ones for every backend,
schedule and ``fallback_backend``; an injected ``compile`` OOM must demote
the same way in both packages, with the same bytes and the same
``resilience_fallbacks_total``; and a kernel that does not build must fail
the job undemoted, whatever the ladder offers. Tolerance: exact bytes.
"""

import numpy as np
import pytest
import torch

import jax

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil import obs as jobs
from tpu_stencil.resilience import fallback as jfallback
from tpu_stencil.resilience import faults as jfaults
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import obs
from tpu_stencil_torch.devices import NoDeviceError
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.resilience import errors as terrors
from tpu_stencil_torch.resilience import fallback as tfallback
from tpu_stencil_torch.resilience import faults as tfaults

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 48, 64
JAX_BACKENDS = ("auto", "xla", "pallas", "reference", "autotune")


@pytest.fixture(autouse=True)
def _clean():
    for m in (tfaults, jfaults):
        m.clear()
    obs.reset()
    jobs.reset()
    yield
    for m in (tfaults, jfaults):
        m.reset()
    obs.reset()
    jobs.reset()


@pytest.mark.parametrize("fallback", [None, "cpu"])
@pytest.mark.parametrize("schedule", [None, "deep", "pack", "strips"])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_ladder_labels_match_jax(backend, schedule, fallback):
    want = [r.label for r in jfallback.ladder(backend, schedule, fallback)]
    assert [r.label for r in tfallback.ladder(backend, schedule,
                                              fallback)] == want


def test_ladder_reads_the_port_spellings():
    assert tfallback.ladder("cuda", "deep") == tfallback.ladder("pallas",
                                                                "deep")
    assert [r.label for r in tfallback.ladder("torch", None, "cpu")] == [
        "xla", "xla@cpu"]


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory")


@pytest.mark.parametrize("exc,want", [
    (_oom(), True),
    (cs.KernelLaunchError("stencil_fused launch failed", 2), True),
    (cs.KernelLaunchError("stencil_fused launch failed", 701), True),
    (cs.KernelLaunchError("stencil_resident launch failed", 720), True),
    (cs.KernelLaunchError("invalid argument, out of memory", 1), False),
    (cs.KernelLaunchError("no code"), False),
    (_build.KernelBuildError("kernel build failed: out of memory"), False),
    (NoDeviceError("no CUDA device"), False),
    (terrors.InjectedOOM(), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), False),
    (ValueError("bad shape"), False),
])
def test_demotable_vocabulary(exc, want):
    assert tfallback.demotable(exc) is want


def test_injected_fault_demotes_only_at_compile():
    for point, want in (("compile", True), (None, True), ("h2d", False),
                        ("compute", False)):
        e = terrors.InjectedFault("x")
        e.point = point
        assert tfallback.demotable(e) is want


def _cfgs(tmp_path, extra, reps=7, channels=3):
    shape = (H, W) + ((3,) if channels == 3 else ())
    img = np.random.default_rng(23).integers(0, 256, shape, np.uint8)
    src = tmp_path / "in.raw"
    img.tofile(src)
    argv = [str(src), str(W), str(H), str(reps),
            "rgb" if channels == 3 else "grey", *extra]
    t, _ = tconfig.parse_args(argv + ["--output", str(tmp_path / "t.raw")])
    j, _ = jconfig.parse_args(argv + ["--output", str(tmp_path / "j.raw")])
    return t, j


@pytest.mark.parametrize("spec,want_backend,want_count", [
    ("compile:raise=oom", "pallas", 1),
    ("compile:raise=oom:times=2", "xla", 2),
])
@pytest.mark.parametrize("channels", [1, 3])
def test_compile_oom_demotes_like_jax(tmp_path, capsys, spec, want_backend,
                                      want_count, channels):
    extra = ["--backend", "pallas", "--schedule", "deep"]
    tcfg, jcfg = _cfgs(tmp_path, extra, channels=channels)
    jfaults.configure(spec)
    jres = jdriver.run_job(jcfg, devices=jax.devices("cpu")[:1])
    tfaults.configure(spec)
    tres = tdriver.run_job(tcfg, devices=[CPU])
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()
    assert tres.backend == jres.backend == want_backend
    # Off the deep schedule: K1's default in the port, the TPU's default
    # per-rep schedule in the JAX package.
    assert tres.schedule != "deep" and jres.schedule != "deep"
    j_count = jobs.snapshot()["counters"]["resilience_fallbacks_total"]
    t_count = obs.snapshot()["counters"]["resilience_fallbacks_total"]
    assert t_count == j_count == want_count
    err = capsys.readouterr().err
    assert err.count("resilience: demoting pallas[deep] -> pallas") == 2


def test_demotion_records_a_span(tmp_path):
    tcfg, _ = _cfgs(tmp_path, ["--backend", "pallas", "--schedule", "deep"])
    obs.enable()
    tfaults.configure("compile:raise=oom")
    tdriver.run_job(tcfg, devices=[CPU])
    demotes = [s for s in obs.get_tracer().spans()
               if s.name == "resilience.demote"]
    assert [(s.args["frm"], s.args["to"]) for s in demotes] == [
        ("pallas[deep]", "pallas")]


def test_fallback_backend_cpu_completes_degraded(tmp_path):
    tcfg, jcfg = _cfgs(tmp_path, ["--backend", "pallas",
                                  "--fallback-backend", "cpu"])
    spec = "compile:raise=oom:times=2"
    tfaults.configure(spec)
    tres = tdriver.run_job(tcfg, devices=[CPU])
    jfaults.configure(spec)
    jdriver.run_job(jcfg, devices=jax.devices("cpu")[:1])
    assert tres.backend == "xla"
    assert obs.snapshot()["counters"]["resilience_fallbacks_total"] == 2
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()


@pytest.mark.parametrize("fallback", [None, "cpu"])
@pytest.mark.parametrize("schedule", [None, "deep"])
def test_kernel_build_error_is_never_demoted(tmp_path, monkeypatch,
                                             capsys, fallback, schedule):
    def broken(*a, **k):
        raise _build.KernelBuildError("kernel build failed (forced)")

    broken.launches = 0
    monkeypatch.setattr(cs, "stencil_fused", broken)
    monkeypatch.setattr(cs, "stencil_resident", broken)
    extra = ["--backend", "pallas"]
    if schedule:
        extra += ["--schedule", schedule]
    if fallback:
        extra += ["--fallback-backend", fallback]
    tcfg, _ = _cfgs(tmp_path, extra)
    with pytest.raises(_build.KernelBuildError):
        tdriver.run_job(tcfg, devices=[CPU])
    counters = obs.snapshot()["counters"]
    assert counters.get("resilience_fallbacks_total", 0) == 0
    assert "demoting" not in capsys.readouterr().err
    assert not (tmp_path / "t.raw").exists()


def test_other_launch_errors_are_never_demoted(tmp_path, monkeypatch):
    def refused(*a, **k):
        raise cs.KernelLaunchError("stencil_fused launch failed", 1)

    refused.launches = 0
    monkeypatch.setattr(cs, "stencil_fused", refused)
    tcfg, _ = _cfgs(tmp_path, ["--backend", "pallas",
                               "--fallback-backend", "cpu"])
    with pytest.raises(cs.KernelLaunchError):
        tdriver.run_job(tcfg, devices=[CPU])
    assert obs.snapshot()["counters"].get("resilience_fallbacks_total",
                                          0) == 0


def test_resource_launch_error_demotes_to_torch_ops(tmp_path, monkeypatch):
    def too_large(*a, **k):
        raise cs.KernelLaunchError("stencil_resident launch failed", 720)

    too_large.launches = 0
    monkeypatch.setattr(cs, "stencil_resident", too_large)
    tcfg, jcfg = _cfgs(tmp_path, ["--backend", "pallas", "--schedule",
                                  "deep"])
    tres = tdriver.run_job(tcfg, devices=[CPU])
    assert tres.backend == "pallas" and tres.schedule == "fused"
    assert obs.snapshot()["counters"]["resilience_fallbacks_total"] == 1
    jdriver.run_job(jcfg, devices=jax.devices("cpu")[:1])
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()


CARD = torch.device("cuda", 0)


@pytest.mark.parametrize("schedule", [None, "deep", "pack", "strips"])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_job_ladder_on_the_card_keeps_the_kernel_rungs(backend, schedule):
    full = tfallback.ladder(backend, schedule)
    rungs = tfallback.job_ladder(backend, schedule, None, CARD)
    assert rungs[0] == full[0]
    assert [r for r in rungs[1:]] == [r for r in full[1:]
                                      if r.backend != "xla"]
    assert all(r.backend != "xla" and r.platform is None
               for r in rungs[1:])
    assert tfallback.job_ladder(backend, schedule, None, CPU) == full
    assert tfallback.job_ladder(backend, schedule, "cpu", CPU) == (
        tfallback.ladder(backend, schedule, "cpu"))


@pytest.mark.parametrize("backend", ["pallas", "auto", "xla"])
def test_fallback_backend_cpu_is_refused_on_the_card(tmp_path, backend):
    with pytest.raises(ValueError, match="off the card"):
        tfallback.job_ladder(backend, "deep", "cpu", CARD)
    tcfg, _ = _cfgs(tmp_path, ["--backend", backend,
                               "--fallback-backend", "cpu"])
    with pytest.raises(ValueError, match="off the card"):
        tdriver.run_job(tcfg, devices=[CARD])
    assert not (tmp_path / "t.raw").exists()


@pytest.mark.parametrize("schedule,demotions", [(None, 0), ("deep", 1)])
def test_card_resource_launch_error_fails_typed(tmp_path, monkeypatch,
                                                capsys, schedule, demotions):
    """A launch that asks for more than the card has (cudaError_t 701)
    fails a card job typed: the ladder may step K2 -> K1, never to the
    torch ops, so ``lowering.iterate`` is never called."""
    tried, plain = [], []

    def launch_fails(model, img, **k):
        tried.append((model.backend, model.schedule, model.device))
        raise cs.KernelLaunchError(
            "stencil_fused launch failed: cudaError_t 701 (too many "
            "resources requested for launch)", 701)

    from tpu_stencil_torch.ops import lowering

    monkeypatch.setattr(tdriver, "prepare_engine", launch_fails)
    monkeypatch.setattr(lowering, "iterate",
                        lambda *a, **k: plain.append(a))
    extra = ["--backend", "pallas"] + (["--schedule", schedule]
                                       if schedule else [])
    tcfg, _ = _cfgs(tmp_path, extra)
    with pytest.raises(cs.KernelLaunchError) as ei:
        tdriver.run_job(tcfg, devices=[CARD])
    assert ei.value.code == 701
    assert not plain
    assert [t[0] for t in tried] == ["pallas"] * (demotions + 1)
    assert all(t[2] == CARD for t in tried)
    assert tried[-1][1] is None
    assert obs.snapshot()["counters"].get("resilience_fallbacks_total",
                                          0) == demotions
    err = capsys.readouterr().err
    assert err.count("resilience: demoting") == demotions
    assert "-> xla" not in err
    assert not (tmp_path / "t.raw").exists()
