"""The fault-injection harness of the port against the JAX package's.

One spec string must arm the same rules in both packages (the same
grammar, points, defaults and errors), probabilistic rules must fire at
the same call indices under the same seed, and the port's job must fail
typed at every fault point it has, as the JAX job does. Tolerance: exact
(rules compare field by field, outputs byte for byte).
"""

import numpy as np
import pytest
import torch

import jax

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil.resilience import errors as jerrors
from tpu_stencil.resilience import faults as jfaults
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import obs
from tpu_stencil_torch.resilience import errors as terrors
from tpu_stencil_torch.resilience import faults as tfaults

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 48, 64

SPECS = [
    "compute:frame=3:raise=RuntimeError,h2d:p=0.1",
    "compile:raise=oom:times=2",
    "read",
    " write:at=2:raise=OSError , ",
    "compute:rep=5:p=0.5",
    "checkpoint:req=1:raise=TimeoutError",
    "collective:raise=fatal",
    "d2h:times=0,d2h:rep=1",
    "net.accept:p=1.0:times=3",
]
BAD = [
    "bogus", "compute:rep", "compute:zzz=1", "compute:raise=KeyError",
    "h2d:p=0", "h2d:p=1.5", "compute:rep=x", "read:p=abc",
]


@pytest.fixture(autouse=True)
def _clean():
    tfaults.clear()
    jfaults.clear()
    obs.reset()
    yield
    tfaults.reset()
    jfaults.reset()
    obs.reset()


def _fields(plan):
    return {point: [(r.point, r.index, r.p, r.times, r.exc.__name__)
                    for r in rules] for point, rules in plan.items()}


def test_points_and_exception_names_match():
    assert tfaults.POINTS == jfaults.POINTS
    assert sorted(tfaults.EXCEPTIONS) == sorted(jfaults.EXCEPTIONS)
    assert tfaults.ENV_VAR == "TPU_STENCIL_TORCH_FAULTS"
    assert tfaults.SEED_VAR == "TPU_STENCIL_TORCH_FAULTS_SEED"


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_gives_equal_rules(spec):
    assert _fields(tfaults.parse_spec(spec)) == _fields(jfaults.parse_spec(spec))


@pytest.mark.parametrize("spec", BAD)
def test_parse_spec_errors_match(spec):
    with pytest.raises(ValueError) as jerr:
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError) as terr:
        tfaults.parse_spec(spec)
    assert str(terr.value) == str(jerr.value)


def _fired(module, errors, spec, n=200):
    rule = module.parse_spec(spec)["h2d"][0]
    out = []
    for i in range(n):
        try:
            rule.check(i)
        except errors.InjectedFault:
            out.append(i)
    return out


@pytest.mark.parametrize("seed", ["0", "7"])
def test_probabilistic_rules_fire_at_the_same_indices(monkeypatch, seed):
    monkeypatch.setenv(jfaults.SEED_VAR, seed)
    monkeypatch.setenv(tfaults.SEED_VAR, seed)
    spec = "h2d:p=0.3:times=0"
    want = _fired(jfaults, jerrors, spec)
    assert want and _fired(tfaults, terrors, spec) == want


def test_rule_fires_once_then_passes_and_counts():
    tfaults.configure("compute:rep=2")
    s = tfaults.site("compute")
    s(0)
    s(1)
    with pytest.raises(terrors.InjectedFault) as e:
        s(2)
    assert (e.value.point, e.value.index) == ("compute", 2)
    s(2)  # times=1: spent
    assert obs.snapshot()["counters"]["resilience_faults_injected_total"] == 1


def test_unarmed_sites_resolve_to_none_and_env_arms(monkeypatch):
    for point in tfaults.POINTS:
        assert tfaults.site(point) is None
    with pytest.raises(ValueError):
        tfaults.site("nope")
    monkeypatch.setenv(tfaults.ENV_VAR, "write")
    tfaults.reset()
    assert tfaults.site("write") is not None and tfaults.site("read") is None


def _cfgs(tmp_path, extra=(), reps=6, channels=3):
    shape = (H, W) + ((3,) if channels == 3 else ())
    img = np.random.default_rng(11).integers(0, 256, shape, np.uint8)
    src = tmp_path / "in.raw"
    img.tofile(src)
    argv = [str(src), str(W), str(H), str(reps),
            "rgb" if channels == 3 else "grey", *extra]
    t, _ = tconfig.parse_args(argv + ["--output", str(tmp_path / "t.raw")])
    j, _ = jconfig.parse_args(argv + ["--output", str(tmp_path / "j.raw")])
    return t, j


@pytest.mark.parametrize("point", ["read", "h2d", "compute", "d2h", "write"])
def test_run_job_fault_fails_typed_like_jax(tmp_path, point):
    tcfg, jcfg = _cfgs(tmp_path, ["--backend", "xla"])
    jfaults.configure(point)
    with pytest.raises(jerrors.InjectedFault):
        jdriver.run_job(jcfg, devices=jax.devices("cpu")[:1])
    tfaults.configure(point)
    with pytest.raises(terrors.InjectedFault) as e:
        tdriver.run_job(tcfg, devices=[CPU])
    assert e.value.point == point


@pytest.mark.parametrize("mesh", [None, "2x2"])
def test_compute_rep_index_fires_inside_a_fused_call(tmp_path, mesh):
    extra = ["--backend", "pallas"] + (["--mesh", mesh] if mesh else [])
    tcfg, _ = _cfgs(tmp_path, extra, reps=11)
    tfaults.configure("compute:rep=9")
    devices = [CPU] * (4 if mesh else 1)
    with pytest.raises(terrors.InjectedFault) as e:
        tdriver.run_job(tcfg, devices=devices)
    assert (e.value.point, e.value.index) == ("compute", 9)
    assert not (tmp_path / "t.raw").exists()


def test_collective_and_checkpoint_points(tmp_path):
    tcfg, _ = _cfgs(tmp_path, ["--mesh", "2x2", "--backend", "pallas"])
    tfaults.configure("collective")
    with pytest.raises(terrors.InjectedFault) as e:
        tdriver.run_job(tcfg, devices=[CPU] * 4)
    assert e.value.point == "collective"
    tcfg, _ = _cfgs(tmp_path, ["--backend", "xla"])
    tfaults.configure("checkpoint:rep=4")
    with pytest.raises(terrors.InjectedFault) as e:
        tdriver.run_job(tcfg, devices=[CPU], checkpoint_every=2)
    assert (e.value.point, e.value.index) == ("checkpoint", 4)


def test_cli_faults_flag_validates_at_parse_time(tmp_path, capsys):
    tcfg, _ = _cfgs(tmp_path)
    with pytest.raises(SystemExit):
        tconfig.parse_args([tcfg.image, str(W), str(H), "1", "rgb",
                            "--faults", "compute:raise=KeyError"])
    assert "unknown fault exception" in capsys.readouterr().err
