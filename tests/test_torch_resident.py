"""K2 ``stencil_resident``: the host model of its launch and a CPU emulation
of its decomposition.

K2 runs only on the card (``chip_smoke.py`` phase ``k2`` holds it against
its plain version byte for byte, and its shared memory against the host
model). Here the host side is checked: the feasibility line, the tile and
the reps per grid sync, and the shared-memory model. And K2's
decomposition is emulated in torch step by step as the kernel runs it: the
grid strides over K1's tiles, each step runs ``fuse`` reps of every tile as
a trapezoid over ``fuse*halo`` ghost rows and lanes from one buffer into
the other, the buffers swap once per sync (the last step writing the
output buffer), and ``reps % fuse`` single-rep steps end the loop. Each rep
is ``lowering.padded_step`` (the arithmetic of ``stencil_fused_plain``) on
the tile's window with the re-zero in image coordinates. The emulation must
equal ``stencil_resident_plain`` and the JAX package's ``deep`` schedule
(its resident Pallas kernel in interpret mode, as ``tests/test_deep.py``
runs it).

The kernel lab's ``band`` variant (K2's job with the image held in shared
memory, the form that measured slower) is emulated the same way: one band
of rows per block, each band walked in tiles whose output is written back
into the band with the last ``fuse*halo*C`` lanes held back until the next
tile has loaded, each band's first and last ``fuse*halo`` rows published
to an edge buffer by sync parity and read by its neighbours after the
sync. Its host model (band partition, shared memory) is checked too.
Tolerance: 0, byte-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_stencil import filters as jfilters
from tpu_stencil.ops import lowering as jlowering
from tpu_stencil.ops import pallas_stencil
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lab
from tpu_stencil_torch.ops import lowering as tlowering
from tpu_stencil_torch.runtime import roofline

torch.set_num_threads(1)

FILTERS = ("gaussian", "gaussian5", "gaussian7", "box", "edge", "identity")
# Rep counts around K2's reps per sync F (F - 1 = 0 counts as 1).
REPS = ("1", "F-1", "F", "F+1", "9", "40")


def _plans(name):
    return (jlowering.plan_filter(jfilters.get_filter(name)),
            tlowering.plan_filter(tfilters.get_filter(name)))


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _reps(label, fuse):
    return max(1, {"1": 1, "F-1": fuse - 1, "F": fuse, "F+1": fuse + 1,
                   "9": 9, "40": 40}[label])


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------


def _kept_rows(rows: torch.Tensor, rows_real: int, frame) -> torch.Tensor:
    keep = (rows >= 0) & (rows < rows_real)
    if frame is not None:
        stride, frame_h = frame
        keep &= (rows % stride) < frame_h
    return keep


def _window_reps(win, plan, channels, depth, row0, lane0, rows_real, frame,
                 wc):
    """``depth`` reps of the window ``win`` whose row 0, lane 0 is image
    (row0, lane0): each one padded_step on the window, then the re-zero of
    rows outside the image (and frame gaps) and lanes outside [0, wc). What
    lies within depth*halo of the window's edge is not trusted."""
    nr, nl = win.shape
    pad = (-nl) % channels  # whole pixels for the (rows, W, C) view
    cur = torch.nn.functional.pad(win, (0, pad))
    lanes = torch.arange(nl + pad) + lane0
    keep = (_kept_rows(torch.arange(nr) + row0, rows_real, frame)[:, None]
            & ((lanes >= 0) & (lanes < wc))[None, :])
    cur = torch.where(keep, cur, 0)
    shape = (nr, -1, channels) if channels > 1 else (nr, -1)
    for _ in range(depth):
        cur = tlowering.padded_step(cur.reshape(shape), plan).reshape(nr, -1)
        cur = torch.where(keep, cur, 0)
    return cur[:, :nl]


def emulate_k2(x2, plan, channels, reps, rows_real=None, frame=None,
               block_h=None, tile_w=cs.TILE_W, fuse=None):
    """K2 on the flat (rows, W*C) uint8 image as the kernel runs it, at
    :func:`cuda_stencil.resident_geometry`'s tile and reps per sync unless
    forced (see the module docstring). The two buffers start filled with
    bytes no rep writes, so a pixel no tile stores shows."""
    rows, wc = x2.shape
    rows_real = rows if rows_real is None else rows_real
    bh0, fz0 = cs.resident_geometry(plan, rows, wc, channels)
    bh = bh0 if block_h is None else block_h
    fz = fz0 if fuse is None else fuse
    h = plan.halo
    full = reps // fz
    steps = full + reps % fz
    out = torch.full_like(x2, 0xA5)
    work = torch.full_like(x2, 0x5A)
    src = x2
    for s in range(steps):
        dst = work if (steps - 1 - s) & 1 else out
        depth = fz if s < full else 1
        g = depth * h
        gl = g * channels
        padded = torch.nn.functional.pad(src, (gl, gl + tile_w, g, g + bh))
        for r0 in range(0, rows, bh):
            for c0 in range(0, wc, tile_w):
                win = padded[r0:r0 + bh + 2 * g, c0:c0 + tile_w + 2 * gl]
                res = _window_reps(win, plan, channels, depth, r0 - g,
                                   c0 - gl, rows_real, frame, wc)
                r1, c1 = min(r0 + bh, rows), min(c0 + tile_w, wc)
                dst[r0:r1, c0:c1] = res[g:g + r1 - r0, gl:gl + c1 - c0]
        src = dst
    assert src is out  # the last step writes the output buffer
    return out


def emulate_band(x2, plan, channels, reps, geo, rows_real=None, frame=None):
    """The lab's band variant on the flat (rows, W*C) uint8 image, as its
    kernel runs it (see the module docstring)."""
    rows, wc = x2.shape
    rows_real = rows if rows_real is None else rows_real
    h, br, tw, fuse = plan.halo, geo.band_h, geo.tile_w, geo.fuse
    e = fuse * h
    n_bands = -(-rows // br)
    tiles_x = -(-wc // tw)
    src = x2.clone()
    bands = []
    for b in range(n_bands):
        band = torch.zeros((br, wc), dtype=torch.uint8)
        n_own = min(br, rows - b * br)
        band[:n_own] = src[b * br:b * br + n_own]
        bands.append(band)
    edges = {}
    steps = reps // fuse + reps % fuse
    for s in range(steps):
        depth = fuse if s < reps // fuse else 1
        g = depth * h
        gl = g * channels
        published = []
        for b, band in enumerate(bands):
            r_lo, r_hi = b * br, (b + 1) * br

            def row_of(r):
                if not bool(_kept_rows(torch.tensor(r), rows_real, frame)):
                    return torch.zeros(wc, dtype=torch.uint8)
                if r_lo <= r < r_hi:
                    return band[r - r_lo]
                if s == 0:
                    return src[r]
                if r < r_lo:  # the upper neighbour's last e rows
                    return edges[s & 1][b - 1][1][r - (r_lo - e)]
                return edges[s & 1][b + 1][0][r - r_hi]  # its first e rows

            held = None
            for j in range(tiles_x):
                col0 = j * tw
                last = j + 1 == tiles_x
                # load: rows [r_lo - g, r_hi + g), lanes [col0 - gl,
                # col0 + tw + gl), zero outside the image's lanes
                full = torch.stack([row_of(r)
                                    for r in range(r_lo - g, r_hi + g)])
                full = torch.nn.functional.pad(full, (gl, tw + gl))
                win = full[:, col0:col0 + tw + 2 * gl].clone()
                # the lanes the last tile held back go into the band now
                if held is not None:
                    band[:, col0 - held.shape[1]:col0] = held
                res = _window_reps(win, plan, channels, depth, r_lo - g,
                                   col0 - gl, rows_real, frame, wc)
                res = res[g:g + br, gl:gl + tw]  # the trusted interior
                stop = wc if last else col0 + tw - gl
                band[:, col0:stop] = res[:, :stop - col0]
                held = None if last or gl == 0 else res[:, tw - gl:].clone()
            published.append((band[:e].clone(), band[br - e:].clone()))
        edges[(s + 1) & 1] = published
    return torch.cat(bands)[:rows]


def _deep_jax(img, reps, jplan, frames=False):
    fn = pallas_stencil.iterate_frames if frames else pallas_stencil.iterate
    return np.asarray(fn(jnp.asarray(img), jnp.int32(reps), jplan,
                         interpret=True, schedule="deep"))


def _flat(img):
    return torch.from_numpy(img.reshape(img.shape[0], -1))


def _frames_layout(frames, plan):
    """The tall frames layout iterate_frames launches: (x2, rows_real,
    frame)."""
    n, hh, w, c = frames.shape
    stride = cs.frames_stride(plan, hh)
    x = torch.from_numpy(frames.reshape(n, hh, w * c))
    x = torch.cat([x, torch.zeros((n, stride - hh, w * c), dtype=x.dtype)],
                  1)
    frame = (stride, hh) if plan.halo else None
    return x.reshape(n * stride, w * c), n * stride - plan.halo, frame


# ---------------------------------------------------------------------------
# The emulations against the plain version and the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", FILTERS)
def test_k2_emulation_matches_plain_and_jax(name, channels, reps):
    # 30 rows: K2's own geometry is one tile row of 32 (a short one); the
    # forced one is tiles of 8 rows by 16 lanes (the last of each ragged)
    # at the same reps per sync.
    jplan, tplan = _plans(name)
    shape = (30, 23, 3) if channels == 3 else (30, 37)
    img = _img(shape, 100 + len(reps) + channels)
    fuse = cs.resident_geometry(tplan, 30, shape[1] * channels, channels)[1]
    n = _reps(reps, fuse)
    want = cs.stencil_resident_plain(_flat(img), tplan, channels, n)
    for kw in ({}, {"block_h": 8, "tile_w": 16}):
        got = emulate_k2(_flat(img), tplan, channels, n, **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=f"{kw}")
    np.testing.assert_array_equal(
        want.numpy().reshape(shape), _deep_jax(img, n, jplan))


@pytest.mark.parametrize("reps", ["F+1", "9"])
@pytest.mark.parametrize("name", FILTERS)
def test_k2_emulation_frames(name, reps):
    # 3 frames of 9 rows: tiles of 8 rows, so the gap rows after each
    # frame fall inside a tile, at its edge or across two.
    jplan, tplan = _plans(name)
    frames = _img((3, 9, 13, 3), 200 + len(reps))
    x2, rows_real, frame = _frames_layout(frames, tplan)
    fuse = cs.resident_geometry(tplan, *x2.shape, 3)[1]
    n = _reps(reps, fuse)
    want = cs.stencil_resident_plain(x2, tplan, 3, n, rows_real, frame)
    for kw in ({}, {"block_h": 8, "tile_w": 16}):
        got = emulate_k2(x2, tplan, 3, n, rows_real, frame, **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=f"{kw}")
    stride = x2.shape[0] // 3
    out = want.reshape(3, stride, 39)[:, :9].reshape(frames.shape)
    np.testing.assert_array_equal(out.numpy(),
                                  _deep_jax(frames, n, jplan, frames=True))


@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", FILTERS)
def test_band_emulation_matches_plain(name, channels, reps):
    # 30 rows over 4 SMs: bands of 8 rows, the last one short (6 rows);
    # its own tile, and tiles of 16 lanes (the held-back lanes of
    # gaussian7, 3*fuse*C, span a tile of their own width).
    _, tplan = _plans(name)
    shape = (30, 23, 3) if channels == 3 else (30, 37)
    img = _img(shape, 300 + len(reps) + channels)
    n = _reps(reps, 2)
    want = cs.stencil_resident_plain(_flat(img), tplan, channels, n)
    geo = lab.band_geometry(tplan, 30, shape[1] * channels, channels, sms=4,
                            fuse=2)
    assert geo is not None and geo.band_h == 8
    small = lab.BandGeometry(8, max(16, 2 * tplan.halo * channels), 2, 0, 0)
    for g in (geo, small):
        got = emulate_band(_flat(img), tplan, channels, n, g)
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=f"{g}")


@pytest.mark.parametrize("name", FILTERS)
def test_band_emulation_frames(name):
    # bands of 6 rows over 3 frames of 9 rows: the gap rows fall inside a
    # band, at its edge or across two.
    _, tplan = _plans(name)
    frames = _img((3, 9, 13, 3), 400)
    x2, rows_real, frame = _frames_layout(frames, tplan)
    want = cs.stencil_resident_plain(x2, tplan, 3, 9, rows_real, frame)
    geo = lab.BandGeometry(6, 16 if tplan.halo < 3 else 32, 2, 0, 0)
    got = emulate_band(x2, tplan, 3, 9, geo, rows_real, frame)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_stencil_resident_on_the_cpu_is_its_plain_version():
    _, g = _plans("gaussian")
    x2 = _flat(_img((21, 17, 3), 5))
    got = cs.stencil_resident(x2, g, 3, 9, rows_real=19)
    np.testing.assert_array_equal(
        got.numpy(), cs.stencil_resident_plain(x2, g, 3, 9, 19).numpy())
    assert torch.equal(lab.stencil_lab_band(x2, g, 3, 9, 19), got)
    with pytest.raises(ValueError):
        cs.stencil_resident(x2, g, 3, 0)


# ---------------------------------------------------------------------------
# The host model
# ---------------------------------------------------------------------------


def test_feasibility_line():
    _, g = _plans("gaussian")
    assert cs.resident_feasible(g, 2520, 1920 * 3, 3)
    assert cs.resident_feasible(g, 2520, 1920, 1)
    assert not cs.resident_feasible(g, 4320, 7680 * 3, 3)
    # the line: both uint8 buffers within the L2 share
    rows = int(cs.RESIDENT_L2_SHARE * cs.H100_L2_BYTES) // (2 * 5760)
    assert cs.resident_feasible(g, rows, 5760, 3)
    assert not cs.resident_feasible(g, rows + 1, 5760, 3)
    assert cs.rep_loop(g, rows, 5760, 3, None, None, "deep",
                       None).kernel == "stencil_resident"
    past = cs.rep_loop(g, rows + 1, 5760, 3, None, None, "deep", None)
    assert past == cs.k1_loop(g, rows + 1, 5760, 3, None, None, "deep")


RESIDENT_GEOMETRY = {  # (block_h, fuse) at 1920x2520, RGB and grey
    "gaussian": ((56, 8), (56, 8)), "gaussian5": ((48, 8), (40, 8)),
    "gaussian7": ((32, 5), (32, 5)), "box": ((40, 8), (40, 8)),
    "edge": ((56, 8), (48, 8)), "identity": ((56, 8), (56, 8))}


@pytest.mark.parametrize("name", FILTERS)
def test_tile_and_reps_per_sync(name):
    # K1's tile at fuse 8 (clamped as K1 clamps it), at the height whose
    # modeled grid sync is shortest among those leaving two blocks per SM
    _, p = _plans(name)
    for (c, wc), want in zip(((3, 5760), (1, 1920)), RESIDENT_GEOMETRY[name]):
        bh, fz = cs.resident_geometry(p, 2520, wc, c)
        assert (bh, fz) == want, c
        assert bh in cs.RESIDENT_BLOCK_HS
        assert (bh, fz) == cs.effective_geometry(p, 2520, c, bh,
                                                 cs.DEFAULT_FUSE)
        smem = cs.tile_smem_bytes(p, bh, fz, c)
        assert 2 * (smem + cs.SMEM_PER_BLOCK_RESERVED) <= cs.SM_SMEM
    # a short image clamps the tile to its padded height
    assert cs.resident_geometry(p, 20, 60, 3)[0] == 24


def test_tile_height_fills_the_last_round():
    # gaussian RGB at 1920x2520 on 132 SMs, two blocks each: 64-row tiles
    # are 920 (3.48 rounds of 264, the last half empty), 56-row tiles 1035
    # (3.92 rounds): the same four rounds of smaller tiles
    _, g = _plans("gaussian")
    assert cs.resident_geometry(g, 2520, 5760, 3) == (56, 8)
    assert -(-2520 // 64) * 23 == 920 and -(-2520 // 56) * 23 == 1035
    # on a card of a quarter the SMs 64 rows fill their rounds better
    # (920 tiles = 6.97 rounds of 132, 1035 = 7.84) and win
    assert cs.resident_geometry(g, 2520, 5760, 3, sms=66) == (64, 8)


def test_traffic_model_counts_grid_syncs():
    # K2 makes one round trip of the image per grid sync: 40 reps at 8 per
    # sync are 5 trips; 9 reps are one sync of 8 and one of 1.
    frame = 2520 * 1920 * 3
    kw = dict(schedule="deep", w_img=1920, channels=3)
    assert roofline.effective_fuse("gaussian", 2520, reps=40, **kw) == 8
    assert roofline.effective_fuse("gaussian", 2520, reps=9, **kw) == 4.5
    assert roofline.effective_fuse("gaussian", 2520, **kw) == 8
    assert roofline.analytic_bytes_per_rep(
        frame, "pallas", "gaussian", 2520, reps=40, **kw) == 2 * frame / 8


@pytest.mark.parametrize("rows,w,c", [(2520, 1920, 3), (2520, 1920, 1),
                                      (963, 256, 3), (30, 23, 3), (7, 5, 1)])
@pytest.mark.parametrize("name", ["gaussian", "gaussian7", "edge"])
def test_band_partition(name, rows, w, c):
    # Even band heights that hold a neighbour's edge rows, every row in
    # exactly one band, at most one band per SM, the block within shared
    # memory, and the model's parts adding up.
    _, p = _plans(name)
    geo = lab.band_geometry(p, rows, w * c, c)
    assert geo is not None
    e = geo.fuse * p.halo
    assert geo.band_h % 2 == 0 and geo.band_h >= e
    n_bands = -(-rows // geo.band_h)
    assert n_bands <= cs.H100_SMS
    owned = [r for b in range(n_bands)
             for r in range(b * geo.band_h, min((b + 1) * geo.band_h, rows))]
    assert owned == list(range(rows))
    assert geo.smem <= cs.SMEM_LIMIT
    assert geo.smem == lab.band_smem_bytes(p, geo.band_h, geo.tile_w,
                                           geo.fuse, c, w * c)
    tile = cs.tile_smem_bytes(p, geo.band_h, geo.fuse, c, geo.tile_w)
    assert geo.smem >= tile + geo.band_h * w * c
    assert geo.edge_bytes == 4 * e * w * c * n_bands
    # the tiles cover the band's lanes, each split one wider than the last
    assert geo.tile_w >= e * c or geo.tile_w >= w * c
    if geo.tile_w < w * c:
        wider = lab._round16(-(-(w * c) // (-(-(w * c) // geo.tile_w) - 1)))
        assert lab.band_smem_bytes(p, geo.band_h, wider, geo.fuse, c,
                                   w * c) > cs.SMEM_LIMIT


def test_band_past_shared_memory():
    _, g = _plans("gaussian")
    assert lab.band_geometry(g, 4320, 7680 * 3, 3) is None
    geo = lab.band_geometry(g, 2520, 1920 * 3, 3)
    assert (geo.band_h, geo.fuse) == (20, lab.BAND_FUSE)


# ---------------------------------------------------------------------------
# The kernel lab's K2 forms
# ---------------------------------------------------------------------------


def test_kernel_lab_times_k2_forms_on_the_cpu(capsys):
    from tpu_stencil_torch.tools import kernel_lab

    names = ["deep", "deep_b32_f8", "deep_f4_b16", "band", "band_f2"]
    rc = kernel_lab.main(names + ["--platform", "cpu", "--shape", "24x16",
                                  "--reps", "8", "--rounds", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert [ln.split()[0] for ln in lines[1:]] == names
    assert all(ln.endswith("exact=True") for ln in lines[1:])
    assert kernel_lab._k2_form("deep_b32_f8") == ("deep", {"b": 32, "f": 8})
    assert kernel_lab._k2_form("band_f4") == ("band", {"f": 4})


@pytest.mark.parametrize("name", ["band_b32", "deep_b8_b16", "deeper",
                                  "band_f2_x"])
def test_kernel_lab_rejects_other_k2_names(name, capsys):
    from tpu_stencil_torch.tools import kernel_lab

    with pytest.raises(SystemExit) as e:
        kernel_lab.main([name, "--platform", "cpu"])
    assert e.value.code == 2
    assert "band[_f<fuse>]" in capsys.readouterr().err
