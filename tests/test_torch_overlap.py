"""The port's interior/border overlap schedules (``--overlap``) against the
JAX package's, on the CPU: the torch-ops path, the per-edge exchange, the
persistent slab, ``auto`` and its cache, the gauge, the probe spans, the
overlap table, the ghost-bytes model and the flag end to end. The K3 path
(``pallas``, K3's plain version on the CPU) and K3 on windows are in
``test_torch_overlap_k3.py``.

The same numpy-seeded images go through the JAX ``ShardedRunner`` (on the
8 fake CPU devices of ``conftest.py``) and the port's runner on
``[cpu] * n``. Tolerance: exact bytes. Every plan here is integer or, for
the ``reference`` backend's ``direct_f32`` plan, has integer taps, so every
float32 product and partial sum is exact and the one divide is correctly
rounded: the tolerance of ``tpu_stencil/ops/stencil.py:88-155`` for exact
filters is bit for bit.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil import filters as jfilters
from tpu_stencil import obs as jobs
from tpu_stencil.models.blur import IteratedConv2D as JaxModel
from tpu_stencil.ops import lowering as jlowering
from tpu_stencil.parallel import overlap as joverlap
from tpu_stencil.parallel.sharded import ShardedRunner as JaxRunner
from tpu_stencil.runtime import autotune as jautotune
from tpu_stencil.runtime import roofline as jroofline
from tpu_stencil_torch import cli as tcli
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch import obs
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.ops import lowering as tlowering
from tpu_stencil_torch.parallel import overlap
from tpu_stencil_torch.parallel.sharded import ShardedRunner
from tpu_stencil_torch.runtime import autotune, roofline

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPLITS = ("split", "fused-split", "edge")


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    # Each test's own autotune caches, and a fresh obs registry.
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "port.json"))
    monkeypatch.setenv("TPU_STENCIL_AUTOTUNE_CACHE", str(tmp_path / "j.json"))
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _img(shape, seed=71):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _channels(shape):
    return shape[2] if len(shape) == 3 else 1


def _port(img, name, reps, mesh, backend, mode, boundary="zero", fuse=None):
    model = IteratedConv2D(name, backend=backend, boundary=boundary,
                           fuse=fuse, device=CPU)
    r = ShardedRunner(model, img.shape[:2], _channels(img.shape),
                      mesh_shape=mesh, devices=[CPU] * (mesh[0] * mesh[1]),
                      overlap=mode)
    return r.fetch(r.run(r.put(img), reps)), r


def _jax(img, name, reps, mesh, backend, mode, boundary="zero", fuse=None):
    model = JaxModel(name, backend=backend, boundary=boundary, fuse=fuse)
    r = JaxRunner(model, img.shape[:2], _channels(img.shape),
                  mesh_shape=mesh, devices=jax.devices()[:mesh[0] * mesh[1]],
                  overlap=mode)
    return r.fetch(r.run(r.put(img), reps)), r


# -- every mode on the torch-ops path, against the JAX package's ------------

TORCH_OPS_CASES = {
    "rgb": ("gaussian", (32, 40, 3), (2, 4), "zero", "xla"),
    "grey_periodic": ("gaussian", (32, 40), (2, 4), "periodic", "xla"),
    "masked": ("gaussian", (33, 41), (2, 4), "zero", "xla"),
    "direct_int": ("edge", (24, 16, 3), (2, 2), "zero", "xla"),
    "direct_f32": ("gaussian", (24, 16, 3), (2, 2), "zero", "reference"),
    "wide_halo": ("gaussian5", (24, 40), (2, 2), "periodic", "xla"),
    # Tiles of 4 rows == 2*halo and of 2 rows == 2*halo: no ghost-free
    # interior, resolved and reported as off.
    "degenerate_halo2": ("gaussian5", (16, 40), (4, 2), "zero", "xla"),
    "degenerate_halo1": ("gaussian", (16, 24, 3), (8, 1), "zero", "xla"),
}


@pytest.mark.parametrize("mode", SPLITS)
@pytest.mark.parametrize("case", sorted(TORCH_OPS_CASES))
def test_torch_ops_modes_match_jax_and_off(case, mode):
    name, shape, mesh, boundary, backend = TORCH_OPS_CASES[case]
    img = _img(shape)
    got, r = _port(img, name, 5, mesh, backend, mode, boundary)
    want, jr = _jax(img, name, 5, mesh, backend, mode, boundary)
    off, _ = _port(img, name, 5, mesh, backend, "off", boundary)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, off)
    assert (r.overlap, r.fuse, r.backend) == (jr.overlap, jr.fuse,
                                              jr.backend)
    assert r.overlap_requested == mode
    if case.startswith("degenerate"):
        assert r.overlap == "off"
    else:
        assert r.overlap == ("split" if mode == "fused-split" else mode)


@pytest.mark.parametrize("name", ["gaussian", "gaussian5", "edge"])
def test_valid_window_matches_jax(name):
    jplan = jlowering.plan_filter(jfilters.get_filter(name))
    tplan = tlowering.plan_filter(tfilters.get_filter(name))
    h = tplan.halo
    ext = _img((20 + 2 * h, 24 + 2 * h, 3), seed=72)
    full = tlowering.valid_step(torch.from_numpy(ext), tplan).numpy()
    for (r0, nr, c0, nc) in [(0, 3, 0, 24), (5, 4, 7, 9), (17, 3, 20, 4)]:
        want = np.asarray(jlowering.valid_window(jnp.asarray(ext), jplan,
                                                 r0, nr, c0, nc))
        got = tlowering.valid_window(torch.from_numpy(ext), tplan, r0, nr,
                                     c0, nc).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full[r0:r0 + nr, c0:c0 + nc])


# -- the per-edge exchange and the slab --------------------------------------


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("grid", [(2, 2), (1, 3), (3, 1), (2, 4)], ids=str)
def test_slab_exchange_is_the_padded_image(grid, boundary):
    # After the per-edge exchange (edges, then the corner hop) every
    # tile's window is its block of the zero- or wrap-padded image: the
    # corners arrive through the packed second hop, not by diagonal copies.
    d, th, tw = 2, 4, 5
    img = _img((grid[0] * th, grid[1] * tw, 3), seed=73)
    tiles = [[torch.from_numpy(np.ascontiguousarray(
        img[i * th:(i + 1) * th, j * tw:(j + 1) * tw]))
        for j in range(grid[1])] for i in range(grid[0])]
    slab = overlap.Slab(tiles, d)
    overlap.exchange_edge_slab(slab, d, boundary)
    mode = "constant" if boundary == "zero" else "wrap"
    padded = np.pad(img, ((d, d), (d, d), (0, 0)), mode=mode)
    for i in range(grid[0]):
        for j in range(grid[1]):
            want = padded[i * th:(i + 1) * th + 2 * d,
                          j * tw:(j + 1) * tw + 2 * d].reshape(th + 2 * d, -1)
            np.testing.assert_array_equal(slab.ext(i, j, d).numpy(), want)


def test_edge_slab_is_persistent_across_chunks():
    # The slab is allocated once per run: every chunk refills the same
    # buffers in place (data_ptrs unchanged), and the tiles a chunk writes
    # are views of them, no stitched copy.
    plan = tlowering.plan_filter(tfilters.get_filter("gaussian"))
    img = _img((24, 32, 3), seed=74)
    tiles = [[torch.from_numpy(np.ascontiguousarray(
        img[i * 12:(i + 1) * 12, j * 16:(j + 1) * 16])) for j in range(2)]
        for i in range(2)]
    slab = overlap.Slab(tiles, 2 * plan.halo)
    ptrs = [b.data_ptr() for b in slab.buffers]
    assert len(ptrs) == 8 and len(set(ptrs)) == 8
    want = tlowering.iterate(torch.from_numpy(img), 7, plan).numpy()
    for n in (2, 2, 2, 1):
        overlap.fused_edge_chunk(slab, plan, n, (24, 32 * 3))
        assert [b.data_ptr() for b in slab.buffers] == ptrs
    out = slab.tiles()
    for i in range(2):
        for j in range(2):
            buf = slab.bufs[i][j][slab.cur]
            assert out[i][j].untyped_storage().data_ptr() == (
                buf.untyped_storage().data_ptr())
            np.testing.assert_array_equal(
                out[i][j].numpy(),
                want[i * 12:(i + 1) * 12, j * 16:(j + 1) * 16])


@pytest.mark.parametrize("name", ["gaussian", "gaussian5", "edge", "box"])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_one_tile_steps_match_padded_step(name, boundary):
    # A grid of one tile: the split and the per-edge pipeline, step by
    # step, against the JAX package's monolithic padded step, every plan
    # kind, grey and RGB and odd shapes; edge_step_from on a slab the
    # caller exchanged equals edge_step.
    jplan = jlowering.plan_filter(jfilters.get_filter(name))
    tplan = tlowering.plan_filter(tfilters.get_filter(name))
    for shape in [(16, 20), (16, 20, 3), (9, 13, 3)]:
        img = _img(shape, seed=78)
        want = np.asarray(jlowering.padded_step(jnp.asarray(img), jplan,
                                                boundary))
        for step in ("split", "edge", "edge_from"):
            slab = overlap.Slab([[torch.from_numpy(img)]], tplan.halo)
            if step == "split":
                overlap.split_step(slab, tplan, boundary=boundary)
            elif step == "edge":
                overlap.edge_step(slab, tplan, boundary=boundary)
            else:
                overlap.exchange_edge_slab(slab, tplan.halo, boundary)
                overlap.edge_step_from(slab, tplan)
            np.testing.assert_array_equal(slab.tiles()[0][0].numpy(), want)


@pytest.mark.parametrize("mode,pieces", [("split", 5), ("fused-split", 5),
                                         ("edge", 9), ("off", 1)])
def test_piece_geometry_tiles_the_output(mode, pieces):
    # The pieces' rectangles cover the tile exactly once; a degenerate
    # tile is one whole-tile piece.
    th, tw, c, d = 20, 12, 3, 2
    rects = overlap.piece_rects(mode, th, tw, d, c)
    cover = np.zeros((th, tw * c), int)
    for r0, r1, l0, l1 in rects.values():
        cover[r0:r1, l0:l1] += 1
    assert (cover == 1).all()
    if mode != "off":
        assert len(rects) == pieces
    assert overlap.launches_per_chunk(mode, th, tw, d) == pieces
    assert overlap.launches_per_chunk(mode, th, 4, 2) == 1
    assert list(overlap.piece_rects("edge", th, 4, 2, c)) == ["whole"]


def test_mode_vocabulary_matches_jax():
    assert overlap.MODE_CODES == joverlap.MODE_CODES
    assert overlap.AUTO_CODE == joverlap.AUTO_CODE
    assert overlap.AUTO_CODE not in overlap.MODE_CODES.values()
    assert overlap.EDGE_NAMES == joverlap.EDGE_NAMES
    assert overlap.CORNER_NAMES == joverlap.CORNER_NAMES
    assert tconfig.OVERLAP_MODES == jconfig.OVERLAP_MODES
    with pytest.raises(ValueError, match="overlap"):
        overlap.check_mode("diagonal")
    with pytest.raises(ValueError, match="overlap"):
        ShardedRunner(IteratedConv2D("gaussian", backend="xla", device=CPU),
                      (16, 16), 1, mesh_shape=(1, 1), devices=[CPU],
                      overlap="diagonal")


# -- the gauge, the probes and the overlap table -----------------------------


@pytest.mark.parametrize("mode,shape,mesh,want", [
    ("split", (32, 40, 3), (2, 4), "split"),
    ("fused-split", (32, 40, 3), (2, 4), "split"),
    ("edge", (32, 40, 3), (2, 4), "edge"),
    ("off", (32, 40, 3), (2, 4), "off"),
    ("edge", (16, 24, 3), (8, 1), "off"),
])
def test_overlap_mode_gauge_names_what_runs(mode, shape, mesh, want):
    _, r = _port(_img(shape), "gaussian", 2, mesh, "xla", mode)
    _, jr = _jax(_img(shape), "gaussian", 2, mesh, "xla", mode)
    assert r.overlap == jr.overlap == want
    gauge = obs.snapshot()["gauges"]["overlap_mode"]["value"]
    assert gauge == jobs.snapshot()["gauges"]["overlap_mode"]["value"]
    assert gauge == overlap.MODE_CODES[want]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["split", "edge"])
def test_probe_spans_match_jax(backend, mode):
    # One sharded.exchange_edge[x] span per edge (four distinct fences),
    # and the split's interior and border halves, in the JAX order.
    img = _img((32, 40, 3), seed=75)
    obs.enable()
    jobs.enable()
    r = ShardedRunner(IteratedConv2D("gaussian", backend=backend,
                                     device=CPU), (32, 40), 3,
                      mesh_shape=(2, 4), devices=[CPU] * 8, overlap=mode)
    r.trace_phase_probes(r.put(img))
    jr = JaxRunner(JaxModel("gaussian", backend="xla"), (32, 40), 3,
                   mesh_shape=(2, 4), devices=jax.devices()[:8],
                   overlap=mode)
    jr.trace_phase_probes(jr.run(jr.put(img), 0))
    names = [s.name for s in obs.get_tracer().spans()]
    assert names == [s.name for s in jobs.get_tracer().spans()]
    assert {f"sharded.exchange_edge[{x}]" for x in "nswe"} <= set(names)
    assert {"sharded.interior_overlap", "sharded.border_compute"} <= set(
        names)


def test_edge_probes_omit_an_axis_of_one_tile():
    r = ShardedRunner(IteratedConv2D("gaussian", backend="xla", device=CPU),
                      (32, 24), 1, mesh_shape=(1, 4), devices=[CPU] * 4)
    jr = JaxRunner(JaxModel("gaussian", backend="xla"), (32, 24), 1,
                   mesh_shape=(1, 4), devices=jax.devices()[:4])
    assert set(r.edge_probes()) == set(jr.edge_probes()) == {"w", "e"}


def test_render_overlap_table_without_a_tpu_ceiling():
    obs.enable()
    r = ShardedRunner(IteratedConv2D("gaussian", backend="xla", device=CPU),
                      (32, 40), 3, mesh_shape=(2, 4), devices=[CPU] * 8,
                      overlap="edge")
    r.trace_phase_probes(r.put(_img((32, 40, 3))))
    info = {"overlap": r.overlap, "tile": r.tile, "channels": 3, "halo": 1,
            "mesh_shape": r.mesh_shape, "fuse": 1, "elem_bytes": 1}
    table = obs.breakdown.render_overlap(obs.get_tracer(), info)
    assert "overlap schedule: edge" in table
    assert "sharded.border_compute" in table
    assert "probe ratio exchange/interior" in table
    for x in "nswe":
        assert f"\n{x}     " in table  # one row per edge
    # No TPU figure: no interconnect ceiling, no share of one.
    assert "%" not in table and "peak" not in table
    assert "ICI" not in table and "v5e" not in table.lower()
    assert str(int(jroofline.V5E_ICI_GBPS)) not in table
    obs.reset()
    obs.enable()
    assert obs.breakdown.render_overlap(obs.get_tracer(), info) == ""


# -- the ghost-bytes model ----------------------------------------------------


@pytest.mark.parametrize("mode", ["phased", "edge"])
@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("mesh", [(2, 4), (1, 1), (8, 1), (1, 8), (3, 3)],
                         ids=str)
def test_ghost_bytes_model_matches_jax(mesh, fuse, mode):
    for tile, ch, halo, eb in [((32, 12), 3, 1, 1), ((960, 1260), 3, 1, 1),
                               ((20, 7), 1, 2, 4)]:
        kw = dict(fuse=fuse, elem_bytes=eb, mode=mode)
        assert roofline.ici_ghost_bytes_per_edge(tile, ch, halo, mesh, **kw) \
            == jroofline.ici_ghost_bytes_per_edge(tile, ch, halo, mesh, **kw)
        assert roofline.ici_ghost_bytes_per_rep(tile, ch, halo, mesh, **kw) \
            == jroofline.ici_ghost_bytes_per_rep(tile, ch, halo, mesh, **kw)


# -- auto: the verdict and its cache ------------------------------------------

BUNDLES = [
    {"exchange_s": 1e-7, "interior_s": 2e-4,
     "candidates": {"split": 1e-4, "edge": 5e-5}},
    {"exchange_s": 1e-4, "interior_s": 2e-4,
     "candidates": {"split": 1e-4, "edge": 5e-5}},
    {"exchange_s": 1e-4, "interior_s": 2e-4,
     "candidates": {"split": 1e-4, "edge": 1e-4}},
    {"exchange_s": 1e-4, "interior_s": 2e-4},
    {"exchange_s": 1e-4, "interior_s": 0.0},
]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("i", range(len(BUNDLES)))
def test_overlap_verdict_matches_jax(i, backend):
    assert autotune.overlap_verdict(BUNDLES[i], backend) == \
        jautotune.overlap_verdict(BUNDLES[i], backend)
    for ratio in (0.0, 0.05, 0.5, 50.0):
        assert autotune.overlap_from_ratio(ratio, backend) == \
            jautotune.overlap_from_ratio(ratio, backend)
    assert autotune.OVERLAP_MIN_RATIO == jautotune.OVERLAP_MIN_RATIO


@pytest.mark.parametrize("cands,want", [
    ({"off": 1.0, "split": 1.2, "edge": 1.5}, "off"),    # a measured loss
    ({"off": 1.0, "split": 1.0, "edge": 1.5}, "off"),    # a tie: no change
    ({"off": 1.0, "split": 0.8, "edge": 0.9}, "fused-split"),
    ({"off": 1.0, "split": 0.8, "edge": 0.7}, "edge"),
    ({"off": 0.5, "split": 0.8, "edge": 0.7}, "off"),
])
def test_overlap_verdict_never_takes_a_measured_loss_over_off(cands, want):
    bundle = {"exchange_s": 1e-4, "interior_s": 2e-4, "candidates": cands}
    assert autotune.overlap_verdict(bundle, "pallas") == want


def test_best_overlap_measures_once_and_caches(tmp_path):
    plan = tlowering.plan_filter(tfilters.get_filter("gaussian"))
    calls = []

    def measure():
        calls.append(1)
        return {"exchange_s": 1e-4, "interior_s": 2e-4,
                "edges": {"n": 3e-5, "s": 3e-5, "w": 2e-5, "e": 2e-5},
                "candidates": {"off": 2e-4, "split": 1e-4, "edge": 6e-5}}

    before = autotune.overlap_probe_count
    args = (plan, (32, 40), 3, (2, 4), "xla")
    assert autotune.best_overlap(*args, measure, device=CPU) == "edge"
    assert autotune.best_overlap(*args, measure, device=CPU) == "edge"
    assert len(calls) == 1 and autotune.overlap_probe_count == before + 1
    assert autotune.cached_overlap(*args, device=CPU) == "edge"
    assert autotune.cached_overlap(plan, (32, 40), 3, (4, 2), "xla",
                                   device=CPU) is None
    entries = json.load(open(tmp_path / "port.json"))["entries"]
    [entry] = entries.values()
    assert entry["candidate_us"] == {"off": 200.0, "split": 100.0,
                                     "edge": 60.0}
    assert set(entry["edge_us"]) == {"n", "s", "w", "e"}
    # A pair (exchange, interior) still decides the ratio's verdict.
    assert autotune.best_overlap(plan, (8, 8), 1, (2, 2), "xla",
                                 lambda: (1e-4, 2e-4), device=CPU) == "split"


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_auto_resolves_once_then_from_the_cache(monkeypatch, backend):
    calls = []
    orig = ShardedRunner._measure_overlap_probes

    def spy(self):
        calls.append(1)
        bundle = orig(self)
        assert set(bundle["candidates"]) == {"off", "split", "edge"}
        assert set(bundle["edges"]) == {"n", "s", "w", "e"}
        return bundle

    monkeypatch.setattr(ShardedRunner, "_measure_overlap_probes", spy)
    img = _img((32, 40, 3), seed=76)
    got, r1 = _port(img, "gaussian", 3, (2, 2), backend, "auto")
    assert r1.overlap in overlap.MODE_CODES and len(calls) == 1
    got2, r2 = _port(img, "gaussian", 3, (2, 2), backend, "auto")
    assert r2.overlap == r1.overlap and len(calls) == 1  # warm: no probe
    want = tlowering.iterate(torch.from_numpy(img), 3, r1.model.plan)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got2, want.numpy())


# -- the flag end to end -------------------------------------------------------

W, H = 40, 32


def _raw(tmp_path, seed=77):
    path = tmp_path / "in.raw"
    _img((H, W, 3), seed).tofile(path)
    return str(path)


@pytest.mark.parametrize("mode", ["split", "fused-split", "edge", "auto"])
def test_run_job_overlap_matches_jax(tmp_path, mode):
    src = _raw(tmp_path)
    argv = [src, str(W), str(H), "5", "rgb", "--mesh", "2x2", "--overlap",
            mode]
    tcfg, _ = tconfig.parse_args(argv + ["--output", str(tmp_path / "t.raw")])
    jcfg, _ = jconfig.parse_args(argv + ["--output", str(tmp_path / "j.raw")])
    assert tcfg.overlap == jcfg.overlap == mode
    res = tdriver.run_job(tcfg, devices=[CPU] * 4)
    jres = jdriver.run_job(jcfg, devices=jax.devices()[:4])
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()
    assert res.overlap in overlap.MODE_CODES
    if mode != "auto":
        assert res.overlap == jres.overlap
    assert obs.snapshot()["gauges"]["overlap_mode"]["value"] == (
        overlap.MODE_CODES[res.overlap])
    # One device and no mesh: nothing to overlap.
    one = tconfig.JobConfig(src, W, H, 2, tconfig.ImageType.RGB,
                            overlap=mode, output=str(tmp_path / "o.raw"))
    assert tdriver.run_job(one, devices=[CPU]).overlap is None


def test_checkpointed_edge_job_resumes_exactly(tmp_path):
    # Each call of a checkpointed window starts its own slab, exchanged
    # from the tiles it is given (the restored ones after --resume).
    src = _raw(tmp_path)
    out = str(tmp_path / "c.raw")
    cfg = tconfig.JobConfig(src, W, H, 9, tconfig.ImageType.RGB,
                            mesh_shape=(2, 2), backend="pallas",
                            overlap="edge", output=out)
    res = tdriver.run_job(cfg, devices=[CPU] * 4, checkpoint_every=4)
    assert res.overlap == "edge"
    jcfg, _ = jconfig.parse_args([src, str(W), str(H), "9", "rgb", "--output",
                                  str(tmp_path / "j.raw")])
    jdriver.run_job(jcfg, devices=jax.devices("cpu")[:1])
    assert open(out, "rb").read() == (tmp_path / "j.raw").read_bytes()


def test_cli_time_line_and_breakdown_name_the_mode(tmp_path, capsys):
    src = _raw(tmp_path)
    rc = tcli.main([src, str(W), str(H), "3", "rgb", "--platform", "cpu",
                    "--mesh", "1x1", "--overlap", "fused-split", "--backend",
                    "xla", "--time", "--breakdown", "--output",
                    str(tmp_path / "o.raw")])
    out = capsys.readouterr().out
    assert rc == 0
    assert " overlap=split mesh=(1, 1)" in out  # fused-split off the kernels
    assert "overlap schedule: split" in out
    rc = tcli.main([src, str(W), str(H), "3", "rgb", "--platform", "cpu",
                    "--time", "--output", str(tmp_path / "p.raw")])
    assert rc == 0 and "overlap=" not in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tconfig.parse_args([src, str(W), str(H), "3", "rgb", "--overlap",
                            "diagonal"])
    with pytest.raises(ValueError, match="overlap"):
        tconfig.JobConfig(src, W, H, 3, tconfig.ImageType.RGB,
                          overlap="diagonal")
