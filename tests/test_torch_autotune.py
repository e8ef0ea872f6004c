"""The port's autotuner against the JAX package's, case for case, with an
injected ``measure``: the JAX side pretends to be on a TPU
(``jax.default_backend``), the port pretends to be on a card through its
one seam (``autotune._on_card``). Where the two differ on purpose (the
port's candidates and grid; a candidate's error propagates), the test says
so."""

import json
import warnings

import numpy as np
import pytest
import torch

import jax

from tpu_stencil import filters as jax_filters
from tpu_stencil.integrity import checksum as jax_checksum
from tpu_stencil.ops import lowering as jax_lowering
from tpu_stencil.runtime import autotune as jax_autotune

from tpu_stencil_torch import filters
from tpu_stencil_torch.integrity import checksum
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering
from tpu_stencil_torch.parallel.sharded import ShardedRunner
from tpu_stencil_torch.runtime import autotune

# The tensors here are tiny: one thread each, and the cores stay with the
# other test workers (their wall-clock assertions starve otherwise).
torch.set_num_threads(1)


@pytest.fixture
def plan():
    return lowering.plan_filter(filters.get_filter("gaussian"))


@pytest.fixture
def jplan():
    return jax_lowering.plan_filter(jax_filters.get_filter("gaussian"))


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Both packages' caches in files of their own; both 'on the chip'."""
    path = tmp_path / "torch.json"
    monkeypatch.setenv(autotune.ENV_CACHE, str(path))
    monkeypatch.setenv("TPU_STENCIL_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setattr(autotune, "_on_card", lambda device: True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return path


def boom(*a, **k):
    raise AssertionError("measured, but the answer was known")


CPU = dict(device="cpu")


def test_off_a_card_the_answer_is_xla_without_measuring(plan, jplan, tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "c.json"))
    monkeypatch.setenv("TPU_STENCIL_AUTOTUNE_CACHE", str(tmp_path / "j.json"))
    assert jax_autotune.best_backend(jplan, (64, 64), 3, measure=boom) == "xla"
    assert autotune.best_backend(plan, (64, 64), 3, measure=boom,
                                 **CPU) == "xla"
    assert autotune.best_full_config(plan, (64, 64), 3, measure=boom,
                                     **CPU) == ("xla", None, None, None)
    assert not (tmp_path / "c.json").exists()


def test_steady_state_is_the_same_arithmetic():
    scripts = [
        lambda n: 0.050 + n * 1e-4,                        # linear
        lambda n: {2: 0.004, 100: 0.010, 200: 0.009}[n],    # inverted pair
        lambda n: 0.008,                                    # degenerate clock
    ]
    for run in scripts:
        a = jax_autotune._steady_state_per_rep(run, 100)
        b = autotune._steady_state_per_rep(run, 100)
        assert a == b
    assert autotune._steady_state_per_rep(scripts[0], 100) == pytest.approx(1e-4)
    assert autotune._steady_state_per_rep(scripts[1], 100) == pytest.approx(
        (0.009 - 0.004) / 198)
    assert autotune._steady_state_per_rep(scripts[2], 100) == pytest.approx(
        0.008 / 200)


def test_crc32c_equals_the_jax_packages():
    assert checksum.crc32c(b"123456789") == 0xE3069283
    assert checksum._crc32c_py(b"123456789") == 0xE3069283
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        want = jax_checksum.crc32c(data.tobytes())
        assert checksum.crc32c(data.tobytes()) == want
        assert checksum.crc32c(data) == want
        assert checksum._crc32c_py(data.tobytes()) == want
    half = checksum.crc32c(b"1234")
    assert checksum.crc32c(b"56789", half) == 0xE3069283


def test_the_winner_is_the_minimum_and_is_cached(plan, jplan, cache):
    calls = []

    def fake(plan, shape, channels, backend, reps=0, schedule=None):
        calls.append((backend, schedule))
        if backend != "pallas":
            return 2e-6
        return 1e-6 if schedule in ("deep", "pack") else 1.5e-6

    assert jax_autotune.best_config(jplan, (128, 96), 3, measure=fake) == (
        "pallas", "pack")
    calls.clear()
    before = autotune.probe_count
    got = autotune.best_config(plan, (128, 96), 3, measure=fake, **CPU)
    assert got == ("pallas", "deep")
    # one xla measurement and one per schedule of the port
    assert calls == [("xla", None), ("pallas", "fused"), ("pallas", "deep")]
    assert autotune.probe_count == before + 3
    # a warm cache makes zero probes
    assert autotune.best_config(plan, (128, 96), 3, measure=boom,
                                **CPU) == got
    assert autotune.best_backend(plan, (128, 96), 3, measure=boom,
                                 **CPU) == "pallas"
    assert autotune.probe_count == before + 3
    raw = json.load(open(cache))
    assert raw["schema_version"] == autotune.SCHEMA_VERSION
    assert raw["stack_version"] == autotune._stack_version()
    (entry,) = raw["entries"].values()
    assert entry["backend"] == "pallas" and entry["schedule"] == "deep"
    assert entry["us_per_rep"] == {"xla": 2.0, "pallas[fused]": 1.5,
                                   "pallas[deep]": 1.0}
    assert set(raw["entry_crcs"]) == set(raw["entries"])


def test_cache_roundtrips_with_the_real_measurement(plan, cache):
    # The real measure_backend on the CPU (tiny shape): torch ops and the
    # kernels' plain versions are genuinely timed; the verdict lands in the
    # file and the second resolution is a pure disk hit.
    got = autotune.best_full_config(plan, (32, 24), 1, **CPU)
    assert got[0] in ("xla", "pallas")
    (entry,) = json.load(open(cache))["entries"].values()
    assert entry["backend"] == got[0]
    assert all(v > 0 for v in entry["us_per_rep"].values())
    assert set(entry["us_per_rep"]) == {"xla", "pallas[fused]", "pallas[deep]"}
    assert autotune.best_full_config(plan, (32, 24), 1, measure=boom,
                                     **CPU) == got


def test_distinct_shapes_get_distinct_keys(plan, jplan, cache):
    def fake(plan, shape, channels, backend, reps=0, schedule=None):
        if backend == "pallas":
            return 1e-6 if shape[0] > 1000 else 3e-6
        return 2e-6

    for mod, p, kw in ((jax_autotune, jplan, {}), (autotune, plan, CPU)):
        assert mod.best_backend(p, (5040, 1920), 3, measure=fake,
                                **kw) == "pallas"
        assert mod.best_backend(p, (630, 1920), 3, measure=fake, **kw) == "xla"
    assert len(json.load(open(cache))["entries"]) == 2


def test_plans_the_kernels_do_not_take_never_tune(cache):
    f32 = lowering.plan_filter(filters.as_filter(
        np.full((3, 3), 0.1, np.float32)))
    assert f32.kind == "direct_f32"
    assert autotune.best_config(f32, (64, 64), 3, measure=boom, **CPU) == (
        "xla", None)
    jf32 = jax_lowering.plan_filter(jax_filters.as_filter(
        np.full((3, 3), 0.1, np.float32)))
    assert jax_autotune.best_config(jf32, (64, 64), 3, measure=boom) == (
        "xla", None)


def test_the_key_names_card_stack_and_kernel_sources(plan):
    key = autotune._key(plan, (64, 48), 3, "cpu")
    parts = key.split("|")
    assert parts[0] == "cpu" and parts[-1] == "64x48x3"
    assert parts[1] == autotune._stack_version()
    assert torch.__version__ in parts[1]
    assert _build.fingerprint() in parts[1]
    assert autotune._entry_stack_version(key) == parts[1]
    assert autotune._entry_stack_version("garbage") is None
    # the fingerprint follows the job kernels' library names
    assert _build.fingerprint() == _build.fingerprint(_build.JOB_KERNELS)
    assert _build.fingerprint(("stencil_fused",)) != _build.fingerprint()


def test_the_two_caches_never_share_a_file(monkeypatch):
    monkeypatch.delenv(autotune.ENV_CACHE, raising=False)
    monkeypatch.delenv("TPU_STENCIL_AUTOTUNE_CACHE", raising=False)
    assert autotune._cache_path() != jax_autotune._cache_path()
    assert autotune._cache_path().endswith(
        "/.cache/tpu_stencil_torch/autotune.json")
    # the JAX package's override does not move the port's file
    monkeypatch.setenv("TPU_STENCIL_AUTOTUNE_CACHE", "/tmp/elsewhere.json")
    assert autotune._cache_path().endswith("tpu_stencil_torch/autotune.json")


def test_stale_schedule_name_remeasures(plan, cache):
    def fake(plan, shape, channels, backend, reps=0, schedule=None):
        return 1e-6 if backend == "pallas" else 2e-6

    key = autotune._key(plan, (64, 64), 1, "cpu")
    autotune._store_cache({key: {
        "backend": "pallas", "schedule": "swar-gone", "block_h": None,
        "fuse": None, "geometry_grid": autotune._grid_fingerprint()}})
    got = autotune.best_config(plan, (64, 64), 1, measure=fake, **CPU)
    assert got[0] == "pallas" and got[1] in autotune._SCHEDULES


def test_an_entry_tuned_under_another_grid_remeasures(plan, jplan, cache):
    calls = []

    def fake(plan, shape, channels, backend, reps=0, schedule=None,
             block_h=None, fuse=None):
        calls.append((backend, schedule, block_h, fuse))
        if backend == "xla":
            return 2e-6
        return 1e-6 if schedule in ("fused", "pack") else 1.5e-6

    key = autotune._key(plan, (640, 640), 1, "cpu")
    autotune._store_cache({key: {
        "backend": "pallas", "schedule": "fused", "block_h": None,
        "fuse": None, "geometry_grid": [[256, 8]]}})
    autotune.best_config(plan, (640, 640), 1, measure=fake, **CPU)
    assert calls, "an entry of another grid must re-measure"
    assert any(c[2:] == (64, 16) for c in calls)  # this grid's candidates
    calls.clear()
    got = autotune.best_config(plan, (640, 640), 1, measure=fake, **CPU)
    assert not calls and got[0] == "pallas"
    # the JAX package does the same with its own grid
    jkey = jax_autotune._key(jplan, (640, 640), 1)
    jax_autotune._store_cache({jkey: {
        "backend": "pallas", "schedule": "pack", "block_h": None,
        "fuse": None, "geometry_grid": [[256, 8]]}})
    jax_autotune.best_config(jplan, (640, 640), 1, measure=fake)
    assert any(c[2:] == (512, 16) for c in calls)


def test_a_candidates_error_propagates(plan, jplan, cache):
    # The JAX package swallows a candidate's error (a Mosaic compile may
    # refuse a tile). On the card the shared-memory model knows beforehand,
    # so a candidate the model admits and the card refuses is a fault.
    def fake(plan, shape, channels, backend, reps=0, schedule=None):
        if schedule in ("deep", "pack_strips"):
            raise cs.KernelLaunchError("the card says no")
        return 1e-6 if backend == "pallas" else 2e-6

    assert jax_autotune.best_config(jplan, (128, 96), 3, measure=fake)[0] == (
        "pallas")
    with pytest.raises(cs.KernelLaunchError, match="the card says no"):
        autotune.best_config(plan, (128, 96), 3, measure=fake, **CPU)
    assert not cache.exists()  # nothing was cached from a failed tune


def test_forced_schedule_restricts_the_space_and_keys_apart(plan, jplan,
                                                            cache):
    calls = []

    def fake(plan, shape, channels, backend, reps=0, schedule=None):
        calls.append((backend, schedule))
        if backend == "xla":
            return 2e-6
        return 1e-6 if schedule in ("deep", "pack") else 3e-6

    assert jax_autotune.best_config(jplan, (128, 96), 3, measure=fake,
                                    force_schedule="pad") == ("xla", None)
    calls.clear()
    # every name but 'deep' runs K1: the forced side is measured as 'fused'
    got = autotune.best_config(plan, (128, 96), 3, measure=fake,
                               force_schedule="pad", **CPU)
    assert got == ("xla", None)  # pallas[fused] (3us) loses to xla (2us)
    assert calls == [("xla", None), ("pallas", "fused")]
    # the unforced resolution is a separate entry and still finds deep
    assert autotune.best_config(plan, (128, 96), 3, measure=fake,
                                **CPU) == ("pallas", "deep")
    keys = list(json.load(open(cache))["entries"])
    assert len(keys) == 2 and sum("|forced=fused" in k for k in keys) == 1


def test_forced_geometry_keys_and_measures_at_the_effective_one(plan, jplan,
                                                                cache):
    geo_calls = []

    def geo(plan, shape, channels, backend, reps=0, schedule=None,
            block_h=None, fuse=None):
        geo_calls.append((backend, schedule, block_h, fuse))
        return 1e-6 if backend == "pallas" else 2e-6

    got = autotune.best_full_config(plan, (128, 96), 3, measure=geo,
                                    block_h=256, fuse=16, **CPU)
    # 256 clamps to the 128-row image, fuse 16 to what shared memory holds
    eff = cs.effective_geometry(plan, 128, 3, 256, 16)
    assert got == ("pallas", "fused") + eff
    assert ("xla", None, None, None) in geo_calls  # xla never gets geometry
    assert all((bh, fz) == eff for b, s, bh, fz in geo_calls if b == "pallas")
    jgot = jax_autotune.best_config(jplan, (128, 96), 3, measure=geo,
                                    block_h=256, fuse=16)
    assert jgot[0] == "pallas"
    # requested geometries that launch alike share one entry
    geo_calls.clear()
    a = autotune.best_config(plan, (128, 96), 3, measure=geo, block_h=100,
                             **CPU)
    n_mid = len(geo_calls)
    b = autotune.best_config(plan, (128, 96), 3, measure=geo, block_h=104,
                             **CPU)
    assert a == b and n_mid > 0 and len(geo_calls) == n_mid
    # the default geometry is another entry (measured with a signature that
    # takes no geometry)
    legacy_calls = []

    def legacy(plan, shape, channels, backend, reps=0, schedule=None):
        legacy_calls.append((backend, schedule))
        return 1e-6

    autotune.best_config(plan, (128, 96), 3, measure=legacy, **CPU)
    assert legacy_calls


def test_unforced_geometry_stage_tunes_and_caches(plan, jplan, cache):
    seen = []

    def geo(plan, shape, channels, backend, reps=0, schedule=None,
            block_h=None, fuse=None):
        if backend == "xla":
            return 9e-6
        seen.append((schedule, block_h, fuse))
        if (block_h, fuse) in ((64, 16), (256, 16)):
            return 1e-6  # the geometry winner of each package's grid
        return 3e-6 if schedule != "deep" else 4e-6

    got = autotune.best_full_config(plan, (512, 128), 3, measure=geo, **CPU)
    assert got == ("pallas", "fused", 64, 16)
    # the stage ran at the winning schedule only, one probe per candidate
    staged = [(s, bh, fz) for s, bh, fz in seen if bh is not None]
    assert all(s == "fused" for s, _, _ in staged)
    assert len(staged) == len(set(staged))
    assert autotune.best_full_config(plan, (512, 128), 3, measure=boom,
                                     **CPU) == got
    entry = autotune.cached_entry(plan, (512, 128), 3, "cpu")
    assert entry["geometry_us_per_rep"]["64x16"] == 1.0
    assert entry["geometry_us_per_rep"]["default"] == 3.0
    jgot = jax_autotune.best_full_config(jplan, (512, 128), 3, measure=geo)
    assert jgot[0] == "pallas" and jgot[2:] == (256, 16)


def test_a_geometry_inside_the_margin_keeps_the_default(plan, cache):
    """A candidate must beat the default geometry by more than the
    call-to-call spread: a verdict stays on disk, so a win inside the
    noise must not change what every later job launches."""
    def geo(edge):
        def measure(plan, shape, channels, backend, reps=0, schedule=None,
                    block_h=None, fuse=None):
            if backend == "xla":
                return 9e-6
            if schedule == "deep":
                return 4e-6
            return 3e-6 * edge if (block_h, fuse) == (32, 4) else 3e-6
        return measure

    just_inside = 1.0 - autotune.GEOMETRY_MARGIN + 0.01
    got = autotune.best_full_config(plan, (512, 128), 3,
                                    measure=geo(just_inside), **CPU)
    assert got == ("pallas", "fused", None, None)
    entry = autotune.cached_entry(plan, (512, 128), 3, "cpu")
    assert entry["block_h"] is None and entry["fuse"] is None
    assert entry["geometry_us_per_rep"]["32x4"] < \
        entry["geometry_us_per_rep"]["default"]  # the readings are kept
    just_outside = 1.0 - autotune.GEOMETRY_MARGIN - 0.01
    got = autotune.best_full_config(plan, (512, 128), 3, cache=False,
                                    measure=geo(just_outside), **CPU)
    assert got == ("pallas", "fused", 32, 4)


def test_a_measure_without_geometry_skips_the_stage(plan, jplan, cache):
    def legacy(plan, shape, channels, backend, reps=0, schedule=None):
        if backend != "pallas":
            return 2e-6
        return 1e-6 if schedule in ("fused", "pack") else 1.5e-6

    for mod, p, kw in ((jax_autotune, jplan, {}), (autotune, plan, CPU)):
        got = mod.best_full_config(p, (512, 128), 3, measure=legacy, **kw)
        assert got[0] == "pallas" and got[2:] == (None, None)


def test_the_grid_is_pruned_by_shared_memory_and_deduplicated(plan, cache):
    seen = []

    def fake(plan, shape, channels, backend, reps=0, schedule=None,
             block_h=None, fuse=None):
        if block_h is not None:
            seen.append((block_h, fuse))
        if backend == "xla":
            return 2e-6
        return 1e-6 if schedule == "fused" else 1.5e-6

    autotune.best_full_config(plan, (2520, 1920), 3, measure=fake, **CPU)
    assert seen, "the geometry stage must run"
    for bh, fz in seen:
        assert cs.tile_smem_bytes(plan, bh, fz, 3) <= cs.SMEM_LIMIT, (bh, fz)
    assert (128, 40) not in seen and (64, 32) not in seen  # past 227 KB
    effs = [cs.effective_geometry(plan, 2520, 3, bh, fz) for bh, fz in seen]
    assert len(effs) == len(set(effs))
    assert cs.effective_geometry(plan, 2520, 3) not in effs  # the default
    # every divisor of 40 a tile can hold is in the grid
    fuses = {fz for _, fz in autotune._GEOMETRY_GRID}
    assert {4, 5, 8, 10, 20, 40} - {cs.DEFAULT_FUSE} <= fuses
    # a short image clamps tall candidates onto each other: measured once
    seen.clear()
    autotune.best_full_config(plan, (16, 64), 1, measure=fake, **CPU)
    effs = [cs.effective_geometry(plan, 16, 1, bh, fz) for bh, fz in seen]
    assert len(effs) == len(set(effs)) and len(effs) < len(
        autotune._GEOMETRY_GRID)


def test_a_deep_winner_that_runs_k2_skips_the_geometry_stage(plan, jplan,
                                                             cache):
    geo_calls = []

    def fake(plan, shape, channels, backend, reps=0, schedule=None,
             block_h=None, fuse=None):
        if block_h is not None:
            geo_calls.append((block_h, fuse))
        if backend == "xla":
            return 5e-6
        return 1e-6 if schedule == "deep" else 3e-6

    assert jax_autotune.best_full_config(jplan, (64, 48), 1, measure=fake) == (
        "pallas", "deep", None, None)
    assert autotune.best_full_config(plan, (2520, 1920), 3, measure=fake,
                                     **CPU) == ("pallas", "deep", None, None)
    assert geo_calls == []
    # past the L2 budget 'deep' runs K1, which has a geometry to tune
    assert not cs.resident_feasible(plan, 4320, 7680 * 3, 3)
    got = autotune.best_full_config(plan, (4320, 7680), 3, measure=fake,
                                    **CPU)
    assert got[:2] == ("pallas", "deep") and geo_calls


def test_unreadable_cache_files_are_cold_misses_with_a_warning(plan, cache):
    def fake(plan, shape, channels, backend, reps=0, schedule=None):
        return 1e-6 if backend == "xla" else 2e-6

    good = {autotune._key(plan, (64, 64), 1, "cpu"): {
        "backend": "xla", "schedule": None, "block_h": None, "fuse": None,
        "geometry_grid": autotune._grid_fingerprint()}}
    autotune._store_cache(good)
    whole = cache.read_text()
    for text in (whole[: len(whole) // 2], "", "[1, 2, 3]", '"a string"',
                 '{"schema_version": 1, "entries": [1]}'):
        cache.write_text(text)
        with pytest.warns(RuntimeWarning, match="unreadable"):
            assert autotune._load_cache() == {}
        with pytest.warns(RuntimeWarning, match="unreadable"):
            got = autotune.best_config(plan, (64, 64), 1, measure=fake, **CPU)
        assert got == ("xla", None)
        # the store rewrote a good file: now a silent warm hit
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert autotune.best_config(plan, (64, 64), 1, measure=boom,
                                        **CPU) == got
    # a missing file is the normal first run: no warning
    cache.unlink()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert autotune._load_cache() == {}


def test_a_flipped_digit_drops_that_entry_alone(cache):
    v = autotune._stack_version()
    good_key = f"cpu|{v}|exact|16|t|64x48x3"
    sibling = f"cpu|{v}|exact|16|u|32x32x1"
    autotune._store_cache({
        good_key: {"backend": "pallas", "fuse": 8},
        sibling: {"backend": "xla", "fuse": None},
    })
    raw = json.load(open(cache))
    assert set(raw["entry_crcs"]) == {good_key, sibling}
    raw["entries"][good_key]["fuse"] = 9  # still valid JSON
    json.dump(raw, open(cache, "w"))
    with pytest.warns(RuntimeWarning, match="crc32c"):
        got = autotune._load_cache()
    assert good_key not in got
    assert got[sibling] == {"backend": "xla", "fuse": None}
    # the CRCs are the JAX package's function of the same canonical JSON
    assert raw["entry_crcs"][sibling] == jax_checksum.crc32c(json.dumps(
        {"backend": "xla", "fuse": None}, sort_keys=True).encode())


def test_keys_of_another_stack_are_evicted(plan, cache, monkeypatch):
    cur = autotune._key(plan, (64, 64), 1, "cpu")
    entry = {"backend": "xla", "schedule": None, "block_h": None,
             "fuse": None, "geometry_grid": autotune._grid_fingerprint()}
    other_torch = cur.replace(f"torch{torch.__version__}", "torch0.0.0-stale")
    other_kernels = cur.replace(f"+k{_build.fingerprint()}", "+k000000000000")
    assert len({cur, other_torch, other_kernels}) == 3
    cache.write_text(json.dumps({
        "schema_version": autotune.SCHEMA_VERSION,
        "entries": {cur: entry, other_torch: dict(entry),
                    other_kernels: dict(entry), "garbage": dict(entry)},
    }))
    assert set(autotune._load_cache()) == {cur}
    # a changed kernel source changes the running stack: the old key goes
    monkeypatch.setattr(_build, "fingerprint", lambda *a: "feedfacecafe")
    assert autotune._load_cache() == {}
    calls = []

    def fake(plan, shape, channels, backend, reps=0, schedule=None):
        calls.append(backend)
        return 1e-6

    autotune.best_full_config(plan, (64, 64), 1, measure=fake, **CPU)
    assert calls, "a verdict must not outlive the kernel it timed"
    raw = json.load(open(cache))
    assert cur not in raw["entries"] and len(raw["entries"]) == 1


def test_model_runs_the_tuned_verdict_unless_forced(monkeypatch, cache):
    monkeypatch.setattr(autotune, "best_full_config",
                        lambda *a, **k: ("pallas", "deep", 64, 16))
    m = IteratedConv2D("gaussian", backend="auto", device="cpu")
    assert m.resolved_config((512, 128), 3) == ("pallas", "deep")
    assert m.resolved_geometry((512, 128), 3) == (64, 16)
    assert m.resolved_geometry((64, 64), 3) == (None, None)  # not resolved
    forced = IteratedConv2D("gaussian", backend="auto", block_h=16, fuse=2,
                            schedule="pack", device="cpu")
    assert forced.resolved_config((512, 128), 3) == ("pallas", "fused")
    assert forced.resolved_geometry((512, 128), 3) == (16, 2)
    # periodic never consults the tuner; explicit backends pass through
    monkeypatch.setattr(autotune, "best_full_config", boom)
    per = IteratedConv2D("gaussian", backend="autotune", boundary="periodic",
                         device="cpu")
    assert per.resolved_config((64, 64), 1) == ("xla", None)
    assert IteratedConv2D("gaussian", backend="pallas", device="cpu"
                          ).resolved_config((64, 64), 1) == ("pallas", "fused")


def test_model_memoizes_and_launches_the_verdict(plan, cache):
    calls = []

    def fake(plan, shape, channels, backend, reps=0, schedule=None,
             block_h=None, fuse=None, device=None):
        calls.append((backend, schedule, block_h, fuse, str(device)))
        if backend == "xla":
            return 9e-6
        return 1e-6 if (block_h, fuse) == (16, 4) else 3e-6

    orig = autotune.measure_backend
    autotune.measure_backend = fake
    try:
        m = IteratedConv2D("gaussian", backend="autotune", device="cpu")
        img = np.random.default_rng(3).integers(0, 256, (40, 24, 3), np.uint8)
        m.prepare((40, 24), 3)
        n = len(calls)
        assert n > 3 and all(c[4] == "cpu" for c in calls)
        assert m.resolved_config((40, 24), 3) == ("pallas", "fused")
        assert m.resolved_geometry((40, 24), 3) == (16, 4)
        seen = {}
        real = cs.iterate

        def spy(x, reps, plan, block_h=None, fuse=None, schedule=None):
            seen.update(block_h=block_h, fuse=fuse, schedule=schedule)
            return real(x, reps, plan, block_h=block_h, fuse=fuse,
                        schedule=schedule)

        cs.iterate = spy
        try:
            out = m(img, 9)
        finally:
            cs.iterate = real
        assert seen == dict(block_h=16, fuse=4, schedule="fused")
        assert len(calls) == n  # forward measured nothing more
        want = lowering.iterate(torch.from_numpy(img), 9, plan)
        assert torch.equal(out, want)
        # a second model finds the verdict on disk: zero probes
        m2 = IteratedConv2D("gaussian", backend="auto", device="cpu")
        assert m2.resolved_config((40, 24), 3) == ("pallas", "fused")
        assert m2.resolved_geometry((40, 24), 3) == (16, 4)
        assert len(calls) == n
    finally:
        autotune.measure_backend = orig


def test_sharded_runner_resolves_against_the_tile(monkeypatch, cache):
    asked = []

    def verdict(plan, shape, channels, **kw):
        asked.append((shape, channels))
        return ("pallas", "fused", 16, 16)

    monkeypatch.setattr(autotune, "best_full_config", verdict)
    model = IteratedConv2D("gaussian", backend="auto", device="cpu")
    runner = ShardedRunner(model, (64, 64), 1, mesh_shape=(2, 2),
                           devices=[torch.device("cpu")] * 4)
    assert asked == [((32, 32), 1)]  # the per-device tile, once
    assert runner.backend == "pallas" and runner.schedule == "fused"
    assert runner.geo_applied and runner.block_h_eff == 16
    assert runner.fuse == 16
    img = np.random.default_rng(5).integers(0, 256, (64, 64), dtype=np.uint8)
    out = runner.fetch(runner.run(runner.put(img), 9))
    want = lowering.iterate(torch.from_numpy(img), 9, model.plan).numpy()
    np.testing.assert_array_equal(out, want)
    # forced knobs win over the verdict
    forced = IteratedConv2D("gaussian", backend="auto", fuse=2, device="cpu")
    r2 = ShardedRunner(forced, (64, 64), 1, mesh_shape=(2, 2),
                       devices=[torch.device("cpu")] * 4)
    assert r2.fuse == 2 and r2.block_h_eff is None and r2.geo_applied
    # a verdict shallower than the default fuse is not taken: the probe
    # timed K1 without the exchange that every chunk costs here
    monkeypatch.setattr(autotune, "best_full_config",
                        lambda *a, **k: ("pallas", "fused", 16, 4))
    shallow = ShardedRunner(IteratedConv2D("gaussian", backend="auto",
                                           device="cpu"),
                            (64, 64), 1, mesh_shape=(2, 2),
                            devices=[torch.device("cpu")] * 4)
    assert shallow.backend == "pallas" and not shallow.geo_applied
    assert shallow.fuse == cs.DEFAULT_FUSE and shallow.block_h_eff is None
    # a deep verdict deepens the exchange chunk (K3 has no resident form)
    monkeypatch.setattr(autotune, "best_full_config",
                        lambda *a, **k: ("pallas", "deep", None, None))
    deep = ShardedRunner(IteratedConv2D("gaussian", backend="auto",
                                        device="cpu"),
                         (64, 64), 1, mesh_shape=(2, 2),
                         devices=[torch.device("cpu")] * 4)
    assert deep.schedule == "fused"
    assert deep.fuse == min(cs.deep_fuse_for(model.plan, 32, 1), 32)
    # an xla verdict runs torch ops
    monkeypatch.setattr(autotune, "best_full_config",
                        lambda *a, **k: ("xla", None, None, None))
    x = ShardedRunner(IteratedConv2D("gaussian", backend="auto",
                                     device="cpu"),
                      (64, 64), 1, mesh_shape=(2, 2),
                      devices=[torch.device("cpu")] * 4)
    assert x.backend == "xla" and x.fuse == 1
