"""The port's job path as a whole against the JAX package's, on the CPU.

The same seeded raw file goes through ``tpu_stencil_torch`` and
``tpu_stencil`` (``--platform cpu``); the written bytes must be identical.
Tolerance: exact byte equality — integer plans are exact and the one
float32 divide is correctly rounded in both packages.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil_torch import cli as tcli
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch.models.blur import IteratedConv2D

# The tensors here are tiny: one thread each, and the cores stay with the
# other test workers (their wall-clock assertions starve otherwise).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_LINE = re.compile(r"^Execution time: \d+\.\d{3} sec$", re.M)
W, H = 23, 19


def _raw(tmp_path, channels, frames=1, seed=41):
    shape = (frames * H, W) + ((3,) if channels == 3 else ())
    img = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / f"in_{channels}_{frames}.raw"
    img.tofile(path)
    return str(path)


def _jax_bytes(argv, out):
    cfg, _ = jconfig.parse_args(argv + ["--output", out])
    jdriver.run_job(cfg, devices=jax.devices("cpu")[:1])
    return open(out, "rb").read()


def _port_bytes(argv, out, capsys):
    assert tcli.main(argv + ["--platform", "cpu", "--output", out]) == 0
    stdout = capsys.readouterr().out
    assert TIME_LINE.search(stdout), stdout
    assert f"wrote {out}" in stdout
    return open(out, "rb").read()


@pytest.mark.parametrize("reps", [0, 1, 9])
@pytest.mark.parametrize("image_type", ["grey", "rgb"])
@pytest.mark.parametrize("name", ["gaussian", "box", "edge"])
def test_cli_bytes_match_jax(tmp_path, capsys, name, image_type, reps):
    src = _raw(tmp_path, 3 if image_type == "rgb" else 1)
    argv = [src, str(W), str(H), str(reps), image_type, "--filter", name]
    want = _jax_bytes(argv, str(tmp_path / "jax.raw"))
    got = _port_bytes(argv, str(tmp_path / "port.raw"), capsys)
    assert len(got) == W * H * (3 if image_type == "rgb" else 1)
    assert got == want
    if reps == 0:
        assert got == open(src, "rb").read()


@pytest.mark.parametrize("extra", [
    [], ["--backend", "pallas"], ["--backend", "cuda", "--schedule", "deep"],
    ["--backend", "pallas", "--block-h", "8", "--fuse", "3"],
    ["--backend", "reference"], ["--backend", "torch"],
    ["--boundary", "periodic"],
])
@pytest.mark.parametrize("image_type", ["grey", "rgb"])
def test_cli_frames_and_backends_match_jax(tmp_path, capsys, image_type,
                                           extra):
    ch = 3 if image_type == "rgb" else 1
    frames = "3" if not extra or "pallas" in extra else "1"
    src = _raw(tmp_path, ch, frames=int(frames))
    argv = [src, str(W), str(H), "9", image_type, "--frames", frames]
    jax_extra = [{"cuda": "pallas", "torch": "xla"}.get(a, a) for a in extra]
    want = _jax_bytes(argv + jax_extra, str(tmp_path / "jax.raw"))
    got = _port_bytes(argv + extra, str(tmp_path / "port.raw"), capsys)
    assert got == want


def test_time_line_reports_what_ran(tmp_path, capsys):
    src = _raw(tmp_path, 3)
    base = [src, str(W), str(H), "9", "rgb", "--platform", "cpu", "--time",
            "--output", str(tmp_path / "o.raw")]
    assert tcli.main(base + ["--backend", "pallas", "--block-h", "8",
                             "--fuse", "3"]) == 0
    out = capsys.readouterr().out
    assert ("backend=pallas schedule=fused block_h=8 fuse=3 mesh=None "
            "launches=stencil_fused:0,stencil_resident:0") in out
    assert tcli.main(base + ["--backend", "pallas", "--schedule", "deep"]) == 0
    assert "backend=pallas schedule=deep mesh=None" in capsys.readouterr().out
    # periodic runs torch ops, and says so
    assert tcli.main(base + ["--backend", "pallas", "--boundary",
                             "periodic"]) == 0
    assert "backend=xla mesh=None" in capsys.readouterr().out


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)  # one CPU device: the single-device path
    return env


@pytest.mark.parametrize("image_type,extra", [
    ("rgb", ["--time"]), ("grey", ["--frames", "3", "--filter", "box"])])
def test_python_m_both_packages(tmp_path, image_type, extra):
    ch = 3 if image_type == "rgb" else 1
    frames = 3 if "--frames" in extra else 1
    src = _raw(tmp_path, ch, frames=frames)
    outs = {}
    for pkg in ("tpu_stencil", "tpu_stencil_torch"):
        out = str(tmp_path / f"{pkg}.raw")
        r = subprocess.run(
            [sys.executable, "-m", pkg, src, str(W), str(H), "9", image_type,
             "--platform", "cpu", "--output", out] + extra,
            capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
        )
        assert r.returncode == 0, r.stderr
        assert TIME_LINE.search(r.stdout), r.stdout
        outs[pkg] = open(out, "rb").read()
    assert outs["tpu_stencil_torch"] == outs["tpu_stencil"]


def test_no_gpu_without_platform_cpu_exits_nonzero(tmp_path):
    src = _raw(tmp_path, 3)
    out = tmp_path / "never.raw"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_stencil_torch", src, str(W), str(H), "1",
         "rgb", "--output", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(_env(), CUDA_VISIBLE_DEVICES=""),
    )
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--platform cpu" in r.stderr
    assert "Execution time" not in r.stdout and not out.exists()


def test_no_gpu_in_process(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _raw(tmp_path, 1)
    assert tcli.main([src, str(W), str(H), "1", "grey"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IteratedConv2D("gaussian")


@pytest.mark.parametrize("argv", [
    ["i.raw", "1920", "2520", "40", "rgb"],
    ["i.raw", "8", "6", "3", "grey", "--filter", "gaussian5", "--backend",
     "pallas", "--schedule", "deep", "--block-h", "16", "--fuse", "4",
     "--frames", "2", "--boundary", "periodic", "--output", "o.raw"],
])
def test_parse_args_matches_jax(argv):
    t, _ = tconfig.parse_args(argv)
    j, _ = jconfig.parse_args(argv)
    for field in ("width", "height", "repetitions", "channels", "filter_name",
                  "backend", "frames", "schedule", "boundary", "block_h",
                  "fuse", "output_path"):
        assert getattr(t, field) == getattr(j, field), field


@pytest.mark.parametrize("argv,msg", [
    (["--block-h", "12"], "block_h must be a positive multiple of 8"),
    (["--fuse", "0"], "fuse must be a positive rep count"),
    (["--frames", "0"], "frames must be >= 1"),
])
def test_validation_messages_match_jax(argv, msg, capsys):
    full = ["i.raw", "8", "8", "1", "grey"] + argv
    for parse in (tconfig.parse_args, jconfig.parse_args):
        with pytest.raises(SystemExit):
            parse(full)
        assert msg in capsys.readouterr().err


def test_model_resolves_like_jax():
    cpu = dict(device="cpu")
    assert IteratedConv2D(**cpu).resolved_config((8, 8), 3) == ("xla", None)
    assert IteratedConv2D(backend="cuda", **cpu).resolved_config(
        (8, 8), 3) == ("pallas", "fused")
    assert IteratedConv2D(backend="pallas", schedule="deep", **cpu
                          ).resolved_config((8, 8), 3) == ("pallas", "deep")
    assert IteratedConv2D(backend="pallas", boundary="periodic", **cpu
                          ).resolved_config((8, 8), 3) == ("xla", None)
    assert IteratedConv2D(backend="torch", **cpu).backend == "xla"
    ref = IteratedConv2D("box", backend="reference", **cpu)
    assert ref.plan.kind == "direct_f32"
    f32 = IteratedConv2D(np.full((3, 3), 0.1, np.float32), backend="pallas",
                         **cpu)
    assert f32.resolved_config((8, 8), 1) == ("xla", None)
    with pytest.raises(ValueError):
        IteratedConv2D(backend="tpu", **cpu)


def test_model_matches_jax_model():
    from tpu_stencil.models.blur import IteratedConv2D as JaxModel

    img = np.random.default_rng(42).integers(0, 256, (21, 17, 3), np.uint8)
    want = np.asarray(JaxModel("edge", backend="xla")(img, 7))
    for backend in ("auto", "pallas"):
        got = IteratedConv2D("edge", backend=backend, device="cpu")(img, 7)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    clip = np.stack([img, img[::-1]])
    for backend in ("xla", "pallas"):
        got = IteratedConv2D("edge", backend=backend, device="cpu").batch(
            clip, 7)
        np.testing.assert_array_equal(got[0].numpy(), want)


# -- the tuning path: --backend autotune / auto -----------------------------


@pytest.mark.parametrize("backend", ["autotune", "auto"])
@pytest.mark.parametrize("image_type", ["grey", "rgb"])
def test_autotune_on_the_cpu_writes_jax_bytes_and_reports_xla(
        tmp_path, capsys, monkeypatch, image_type, backend):
    from tpu_stencil_torch.runtime import autotune

    cache = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.ENV_CACHE, str(cache))
    src = _raw(tmp_path, 3 if image_type == "rgb" else 1)
    argv = [src, str(W), str(H), "9", image_type, "--backend", backend]
    want = _jax_bytes(argv, str(tmp_path / "jax.raw"))
    out = str(tmp_path / "port.raw")
    before = autotune.probe_count
    assert tcli.main(argv + ["--platform", "cpu", "--time", "--output",
                             out]) == 0
    stdout = capsys.readouterr().out
    assert open(out, "rb").read() == want
    assert "backend=xla mesh=None" in stdout
    assert stdout.rstrip().splitlines()[1].endswith("tune_probes=0")
    # off a card nothing is measured and nothing is written
    assert autotune.probe_count == before and not cache.exists()


def _tuned_measure(win):
    """A measure under which ``pallas`` wins at schedule/geometry ``win``
    = (schedule, block_h, fuse)."""
    def measure(plan, shape, channels, backend, reps=0, schedule=None,
                block_h=None, fuse=None, device=None):
        if backend == "xla":
            return 9e-6
        if schedule != win[0]:
            return 5e-6
        return 1e-6 if (block_h, fuse) == win[1:] else 3e-6
    return measure


@pytest.mark.parametrize("win,report,launches", [
    # gaussian's K1 runs regs: the tuner varies only its fuse, and the
    # line names regs' tile height at that depth
    (("fused", None, 4), "schedule=fused block_h=120 fuse=4",
     "stencil_fused:0"),
    (("fused", None, None), "schedule=fused mesh=None", "stencil_fused:0"),
    (("deep", None, None), "schedule=deep mesh=None", "stencil_resident:0"),
])
def test_time_line_names_the_tuned_verdict(tmp_path, capsys, monkeypatch,
                                           win, report, launches):
    """A verdict given through the injected measure (the port pretends to
    be on a card) is what runs and what ``--time`` names; the bytes stay
    the JAX package's. A second job finds it on disk: zero probes."""
    from tpu_stencil_torch.runtime import autotune

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "_on_card", lambda device: True)
    monkeypatch.setattr(autotune, "measure_backend", _tuned_measure(win))
    src = _raw(tmp_path, 3)
    argv = [src, str(W), str(H), "9", "rgb"]
    want = _jax_bytes(argv + ["--backend", "xla"], str(tmp_path / "jax.raw"))
    for run, probes in (("cold", None), ("warm", 0)):
        out = str(tmp_path / f"{run}.raw")
        assert tcli.main(argv + ["--backend", "autotune", "--platform", "cpu",
                                 "--time", "--output", out]) == 0
        line = capsys.readouterr().out.rstrip().splitlines()[1]
        assert f"backend=pallas {report}" in line, line
        assert launches in line
        n = int(line.rsplit("tune_probes=", 1)[1])
        assert (n > 0) if probes is None else (n == probes), line
        assert open(out, "rb").read() == want


def test_forced_knobs_win_over_the_verdict(tmp_path, capsys, monkeypatch):
    from tpu_stencil_torch.runtime import autotune

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "_on_card", lambda device: True)
    monkeypatch.setattr(autotune, "measure_backend",
                        _tuned_measure(("deep", None, None)))
    src = _raw(tmp_path, 3)
    out = str(tmp_path / "o.raw")
    assert tcli.main([src, str(W), str(H), "9", "rgb", "--platform", "cpu",
                      "--schedule", "pack", "--block-h", "8", "--fuse", "3",
                      "--time", "--output", out]) == 0
    line = capsys.readouterr().out.rstrip().splitlines()[1]
    assert "backend=pallas schedule=fused block_h=8 fuse=3 mesh=None" in line
    raw = __import__("json").load(open(tmp_path / "autotune.json"))
    (key,) = raw["entries"]
    assert "|forced=fused|bh=8|fz=3" in key
