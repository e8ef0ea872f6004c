"""The op cost cases (L1): each case's plain version, on the CPU, against
the JAX tool's ``make_case`` kernel in interpret mode on the same seeded
tile, byte for byte (float32 cases within 1 after the uint8 store)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tools import op_cost as jax_op_cost

from tpu_stencil_torch.ops import lab
from tpu_stencil_torch.tools import op_cost

# The tensors here are tiny: one thread each, and the cores stay with the
# other test workers (their wall-clock assertions starve otherwise).
torch.set_num_threads(1)

# The JAX tool's tile, shrunk (its sizes are module globals).
WC, BLOCK, GRID, EXTRA = 256, 16, 2, 160
IN_BLOCK = BLOCK + EXTRA

i16, i32 = jnp.int16, jnp.int32


def _shrink_add(x, i):
    n = x.shape[0] - 1
    return x[0:n] + x[1:n + 1]


def _aligned_shrink_add(x, i):
    n = x.shape[0] - 8
    return x[0:n] + x[8:n + 8]


def _a_band(dtype):
    """The tool's banded 144x144 matrix (1, 2, 1 on the central diagonals),
    built inside the kernel: this JAX refuses a kernel that captures an
    array constant, which is how the tool itself holds it."""
    r = jax.lax.broadcasted_iota(jnp.int32, (144, 144), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (144, 144), 1)
    d = jnp.abs(r - c)
    return jnp.where(d == 0, 2, jnp.where(d == 1, 1, 0)).astype(dtype)


def _mxu_bf16(x, i):
    y = jnp.dot(_a_band(jnp.bfloat16), x[:144].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32)
    return jnp.pad(y.astype(x.dtype), ((0, x.shape[0] - 144), (0, 0)))


def _mxu_i8(x, i):
    y = jax.lax.dot(_a_band(jnp.int8), x[:144].astype(jnp.int8),
                    preferred_element_type=jnp.int32)
    return jnp.pad(y.astype(x.dtype), ((0, x.shape[0] - 144), (0, 0)))


# The JAX tool's cases (tools/op_cost.py, the closures of main()), restated:
# name -> (body, dtype[, strip]), and the port's case that answers each.
JAX_CASES = {
    "mxu_rows_bf16": (_mxu_bf16, i32),
    "mxu_rows_i8": (_mxu_i8, i32),
    "strip_add_i32": (lambda x, i: x + x, i32, 256),
    "strip128_add_i32": (lambda x, i: x + x, i32, 128),
    "subroll1_add_i32": (lambda x, i: x + pltpu.roll(x, 1, 0), i32),
    "subroll1_add_u8": (lambda x, i: x + pltpu.roll(x, 1, 0), jnp.uint8),
    "cvt_u8_i32_rt": (
        lambda x, i: x.astype(jnp.int32).astype(jnp.uint8), jnp.uint8),
    "add_u8": (lambda x, i: x + x, jnp.uint8),
    "add_i32": (lambda x, i: x + x, i32),
    "add_i16": (lambda x, i: x + x, i16),
    "mis_slice_add_i32": (_shrink_add, i32),
    "mis_slice_add_i16": (_shrink_add, i16),
    "al_slice_add_i16": (_aligned_shrink_add, i16),
    "roll3_i32": (lambda x, i: pltpu.roll(x, 3, 1), i32),
    "roll3_add_i32": (lambda x, i: x + pltpu.roll(x, 3, 1), i32),
    "roll1_add_i32": (lambda x, i: x + pltpu.roll(x, 1, 1), i32),
    "roll128_add_i32": (lambda x, i: x + pltpu.roll(x, 128, 1), i32),
    "add_f32": (lambda x, i: x + x, jnp.float32),
    "mul_add_f32": (lambda x, i: x * np.float32(0.998) + x, jnp.float32),
    "mul_add_i32": (lambda x, i: x * 3 + x, i32),
    "shift_i32": (lambda x, i: x >> 1, i32),
    "where_i32": (lambda x, i: jnp.where(x > 0, x, 0), i32),
    "cvt_i16_i32_rt": (lambda x, i: x.astype(i32).astype(i16), i16),
    "mul_i32": (lambda x, i: x * 3, i32),
    "clip_i32": (lambda x, i: jnp.clip(x, 0, 255), i32),
}
PORT_CASE = {name: name for name in JAX_CASES}
PORT_CASE["strip128_add_i32"] = "strip_add_i32"
FLOAT_CASES = ("add_f32", "mul_add_f32", "mxu_rows_bf16")
# The tool's chains (8 and 16) and its check chain (3). At 8 and 16 a
# doubled or shifted byte is 0 whatever ran; at 3 no case's output is
# constant, which the test asserts. A chain of 16 band products passes 2^31:
# the float32 -> int32 convert is then implementation-defined in XLA, so
# that case is held at 3 and 8 only.
CHECK = lab.CHECK_N_OPS
CHAINS = {name: ((CHECK, 8) if name == "mxu_rows_bf16" else (CHECK, 8, 16))
          for name in JAX_CASES}


def _tile(seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(GRID * IN_BLOCK, WC), dtype=np.uint8)


def _jax_case(monkeypatch, name, n_ops, img):
    monkeypatch.setattr(jax_op_cost.pl, "pallas_call", functools.partial(
        jax_op_cost.pl.pallas_call, interpret=True))
    for key, val in (("WC", WC), ("BLOCK", BLOCK), ("GRID", GRID),
                     ("EXTRA", EXTRA), ("IN_BLOCK", IN_BLOCK)):
        monkeypatch.setattr(jax_op_cost, key, val)
    case = JAX_CASES[name]
    it = jax_op_cost.make_case(case[0], n_ops, case[1],
                               strip=case[2] if len(case) > 2 else None)
    out = np.asarray(it(jnp.asarray(img), 1))
    return out[:GRID * BLOCK]


def test_the_restated_cases_are_the_jax_tools():
    import inspect

    src = inspect.getsource(jax_op_cost.main)
    for name in JAX_CASES:
        assert f'"{name}"' in src, name
    assert src.count("i32)") + src.count("i16)") + src.count("uint8)") \
        + src.count("float32)") >= len(JAX_CASES) - 2
    assert set(PORT_CASE.values()) <= set(lab.CASES)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_plain_case_equals_jax_kernel(monkeypatch, name):
    img = _tile()
    x = torch.from_numpy(img)
    for n_ops in CHAINS[name]:
        want = _jax_case(monkeypatch, name, n_ops, img)
        before = lab.op_chain.launches
        got = lab.op_chain(x, PORT_CASE[name], n_ops, IN_BLOCK, BLOCK).numpy()
        assert lab.op_chain.launches == before  # a CPU tensor: no launch
        assert got.shape == want.shape == (GRID * BLOCK, WC)
        diff = np.abs(got.astype(int) - want.astype(int)).max()
        # float32: one rounding apart at most, seen through the uint8 store
        assert diff <= (1 if name in FLOAT_CASES else 0), (name, n_ops, diff)
        if n_ops == CHECK:  # a comparison that can tell a wrong kernel
            assert len(np.unique(want)) > 2 and len(np.unique(got)) > 2, name


def test_packed_cases_are_the_unpacked_functions():
    x = torch.from_numpy(_tile(1))
    for packed, plain in (("vadd4_u8", "add_u8"), ("vadd2_i16", "add_i16")):
        for n in lab.BUILT_N_OPS:
            got = lab.op_chain(x, packed, n, IN_BLOCK, BLOCK)
            assert torch.equal(got, lab.op_chain(x, plain, n, IN_BLOCK,
                                                 BLOCK))
            assert (len(got.unique()) > 2) == (n == CHECK), (packed, n)


@pytest.mark.parametrize("s", [1, 3])
def test_shuffle_cases_roll_within_32_lanes(s):
    img = _tile(2)
    x = img.reshape(GRID, IN_BLOCK, WC // 32, 32).astype(np.int64)
    for n in range(1, 9):
        x = x + np.roll(x, s, axis=3)
        x = ((x + 2 ** 31) % 2 ** 32) - 2 ** 31  # int32 wrap
        if n not in (CHECK, 8):
            continue
        want = (x.reshape(GRID, IN_BLOCK, WC)[:, :BLOCK] % 256).astype(
            np.uint8)
        got = lab.op_chain(torch.from_numpy(img), f"shfl{s}_add_i32", n,
                           IN_BLOCK, BLOCK).numpy()
        assert np.array_equal(got, want.reshape(GRID * BLOCK, WC))


def test_tile_checks():
    x = torch.zeros((2 * 48, 320), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown op_chain case"):
        lab.op_chain(x, "add_i64", 8, 48, 32)
    with pytest.raises(ValueError, match="needs in_block >= 160"):
        lab.op_chain(x, "al_slice_add_i16", 16, 48, 32)
    with pytest.raises(ValueError, match="needs in_block >= 144"):
        lab.op_chain(x, "mxu_rows_i8", 8, 48, 32)
    with pytest.raises(ValueError, match="whole"):
        lab.op_chain(x[:50], "add_i32", 8, 48, 32)
    with pytest.raises(ValueError, match="32-lane"):
        lab.op_chain(torch.zeros((48, 48), dtype=torch.uint8),
                     "shfl1_add_i32", 8, 48, 32)
    # the tool's own tiles are defined for every case and fit shared memory
    from tpu_stencil_torch.ops import cuda_stencil as cs

    for case in lab.CASES:
        ib, b, wc, grid = op_cost.tile_for(case)
        for n in lab.BUILT_N_OPS:
            lab.check_op_tile(case, n, ib, b, wc)
            assert lab.op_chain_smem_bytes(case, n, ib, b,
                                           wc) <= cs.SMEM_LIMIT, case
    # the pinned values: the register forms take none, the shared forms
    # what their rows need (al_slice_add_i16 at a chain of 16: 160 rows of
    # int16), the band products A and a 64-lane strip
    assert lab.op_chain_smem_bytes("add_i32", 16, 48, 32, 320) == 0
    assert lab.op_chain_smem_bytes("subroll1_add_i32", 16, 48, 32, 320) == 0
    assert lab.op_chain_smem_bytes("al_slice_add_i16", 16, 160, 32,
                                   320) == 160 * 320 * 2
    assert lab.op_chain_smem_bytes("roll3_add_i32", 8, 48, 32,
                                   320) == 2 * 8 * 320 * 4
    assert lab.op_chain_smem_bytes("mxu_rows_bf16", 8, 160, 32,
                                   128) == (144 + 64) * 152 * 2
    assert lab.op_chain_smem_bytes("mxu_rows_i8", 8, 160, 32,
                                   128) == (144 + 64) * 176


def test_tool_runs_on_the_cpu(capsys):
    rc = op_cost.main(["add_i32", "roll3_add_i32", "vadd4_u8", "--platform",
                       "cpu", "--grid", "2", "--reps", "1", "--rounds", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert out[0].startswith("platform=cpu")
    assert [ln.split()[0] for ln in out[1:]] == ["add_i32", "roll3_add_i32",
                                                 "vadd4_u8"]
    assert all("us/op-pass" in ln and ln.endswith("exact=True")
               for ln in out[1:])
    with pytest.raises(SystemExit) as e:
        op_cost.main(["add_i64", "--platform", "cpu"])
    assert e.value.code == 2


def test_tool_docstring_answers_every_jax_case():
    for name in JAX_CASES:
        assert name in op_cost.__doc__, name
    for name in lab.CASES:
        assert name in op_cost.__doc__, name


# ---------------------------------------------------------------------------
# The kernel's decompositions (csrc/op_chain.cu), emulated in torch on the
# CPU and held against the plain version, and through it the JAX tool.
# ---------------------------------------------------------------------------

def _wrap32(v):
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def _lanes_emulated(x, case, n_ops, in_block, block):
    """FORM_LANES: a thread per lane of a row (the row padded to whole
    warps with lanes holding anything); every valid lane writes its value
    to the shared buffer and, after the barrier, reads its source lane's
    there (warps exchange their boundary lanes, and the end-around, with
    the rest); two buffers in turn, each holding whatever it held
    before."""
    s, add = lab.LANE_ROLL[case], case != "roll3_i32"
    wc = x.shape[1]
    t = x.reshape(-1, in_block, wc)[:, :block].to(torch.int64)
    lanes = -(-wc // 32) * 32
    g = torch.Generator().manual_seed(11)

    def junk():
        return torch.randint(-2 ** 31, 2 ** 31, (t.shape[0], block, lanes),
                             generator=g, dtype=torch.int64)

    v = junk()
    v[..., :wc] = t
    c = torch.arange(lanes)
    src = c - s % wc
    src = torch.where(src < 0, src + wc, src)
    bufs = [junk(), junk()]
    for i in range(n_ops):
        b = bufs[i & 1]
        b[..., :wc] = v[..., :wc]
        got = b[..., src]
        v = _wrap32(v + got) if add else got
    return (v[..., :wc] & 0xFF).to(torch.uint8).reshape(-1, wc)


@pytest.mark.parametrize("wc", [320, 64, 318, 20])
@pytest.mark.parametrize("case", list(lab.LANE_ROLL))
def test_lane_roll_as_shuffle_plus_boundary_exchange(case, wc):
    x = torch.from_numpy(np.random.default_rng(wc).integers(
        0, 256, size=(GRID * 40, wc), dtype=np.uint8))
    for n in lab.BUILT_N_OPS:
        want = lab.op_chain_plain(x, case, n, 40, BLOCK)
        assert torch.equal(_lanes_emulated(x, case, n, 40, BLOCK), want), n


def _band_emulated(x, case, n_ops, in_block, block):
    """FORM_BAND: y = A @ x[:144] summed as the tensor cores do, in
    m16 x n8 output tiles accumulated over k16 (bf16 -> float32) or k32
    (int8 -> int32) tiles in order, K zero-padded to 160 for int8, lanes in
    64-lane strips padded with zeros; the int32 result is the next
    operation's operand (bf16 of float32 of it, or its low byte)."""
    bf = case == "mxu_rows_bf16"
    wc = x.shape[1]
    grid = x.shape[0] // in_block
    cols = -(-wc // lab.OP_MMA_COLS) * lab.OP_MMA_COLS
    kdim, kt = (lab.BAND, 16) if bf else (lab.OP_I8_K, 32)
    t = torch.zeros((grid, kdim, cols), dtype=torch.int64)
    t[:, :lab.BAND, :wc] = x.reshape(grid, in_block, wc)[:, :lab.BAND]
    a = torch.zeros((lab.BAND, kdim), dtype=torch.float32)
    a[:, :lab.BAND] = lab.band_matrix()

    def operand(y):
        if bf:
            return y.to(torch.float32).to(torch.bfloat16).to(torch.float32)
        return (((y + 128) % 256) - 128).to(torch.float32)

    op = operand(t)
    a4 = a.reshape(lab.BAND // 16, 16, kdim // kt, kt)
    for _ in range(n_ops):
        b5 = op.reshape(grid, kdim // kt, kt, cols // 8, 8)
        acc = torch.zeros((grid, lab.BAND // 16, 16, cols // 8, 8),
                          dtype=torch.float32 if bf else torch.int64)
        for k in range(kdim // kt):  # one mma per (m, n, k) tile, k in order
            prod = torch.einsum("mik,gknj->gminj", a4[:, :, k], b5[:, k])
            acc = acc + (prod if bf else prod.round().to(torch.int64))
        y = acc.reshape(grid, lab.BAND, cols)
        y = y.to(torch.int32).to(torch.int64) if bf else _wrap32(y)
        op = torch.zeros((grid, kdim, cols), dtype=torch.float32)
        op[:, :lab.BAND] = operand(y)
    out = torch.zeros((grid, block, wc), dtype=torch.int64)
    out[:, :min(block, lab.BAND)] = y[:, :block, :wc]
    return (out & 0xFF).to(torch.uint8).reshape(-1, wc)


@pytest.mark.parametrize("wc", [WC, 100])
@pytest.mark.parametrize("case", ["mxu_rows_bf16", "mxu_rows_i8"])
def test_band_product_in_tensor_core_tiles(case, wc):
    x = torch.from_numpy(np.random.default_rng(wc).integers(
        0, 256, size=(GRID * IN_BLOCK, wc), dtype=np.uint8))
    for n in CHAINS[case]:
        want = lab.op_chain_plain(x, case, n, IN_BLOCK, BLOCK)
        got = _band_emulated(x, case, n, IN_BLOCK, BLOCK)
        assert torch.equal(got, want), (case, n)
        if n == CHECK:
            assert len(want.unique()) > 2


@pytest.mark.parametrize("case", list(lab.CASES))
def test_reading_only_the_rows_read_is_sound(case):
    """Rows of a tile past ``op_chain_rows_read`` never reach the stored
    rows: scrambling them leaves the output as it was."""
    wc = 64
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, size=(GRID * IN_BLOCK, wc),
                                      dtype=np.uint8))
    for n in lab.BUILT_N_OPS:
        rows = lab.op_chain_rows_read(case, n, IN_BLOCK, BLOCK)
        assert BLOCK <= rows <= IN_BLOCK, (case, n, rows)
        y = x.clone().reshape(GRID, IN_BLOCK, wc)
        y[:, rows:] = torch.from_numpy(rng.integers(
            0, 256, size=(GRID, IN_BLOCK - rows, wc), dtype=np.uint8))
        y = y.reshape(-1, wc)
        assert not torch.equal(x, y) or rows == IN_BLOCK
        assert torch.equal(lab.op_chain_plain(y, case, n, IN_BLOCK, BLOCK),
                           lab.op_chain_plain(x, case, n, IN_BLOCK, BLOCK)), n


def _stored_counts(case, n_ops, in_block, block, wc, grid):
    """How many times each stored element (tile, row, lane) is written by
    the launch ``lab.op_chain_shape`` gives, with each form's index math
    as the kernel's."""
    sh = lab.op_chain_shape(case, n_ops, in_block, block, wc, grid)
    nb, nt = sh["blocks"], sh["threads"]
    cnt = np.zeros((grid, block, wc), np.int64)
    strips = -(-block // lab.OP_STRIP)
    bx, by = sh["grid_xy"]
    assert bx * by == nb
    if sh["form"] == "flat":  # block (tile, y), thread x: 16 bytes
        n = block * wc
        assert bx == grid and (by - 1) * nt * 16 < n <= by * nt * 16
        flat = cnt.reshape(grid, n)
        for tile in range(bx):
            for y in range(by):
                for th in range(nt):
                    e0 = (y * nt + th) * 16
                    flat[tile, e0:e0 + 16] += 1
    elif sh["form"] == "cols":  # block (tile, y), lane y * nt + x
        rows = lab.OP_REG_ROWS if case in lab.ROW_ROLL else (
            lab.OP_REG_BLOCK + n_ops)
        assert rows >= block and bx == grid and by * nt >= wc
        for tile in range(bx):
            for c in range(wc):
                cnt[tile, :block, c] += 1
    elif sh["form"] == "strips":  # block (tile * strips + strip, y)
        assert bx == grid * strips and by * nt >= wc and wc % 32 == 0
        for x in range(bx):
            tile, strip = divmod(x, strips)
            r0 = strip * lab.OP_STRIP
            for c in range(min(by * nt, wc)):
                cnt[tile, r0:min(r0 + lab.OP_STRIP, block), c] += 1
    elif sh["form"] == "lanes":  # block (tile * strips + strip), lane x
        assert nt >= wc > nt - 32 and nt % 32 == 0
        for b in range(nb):
            tile, strip = divmod(b, strips)
            r0 = strip * lab.OP_STRIP
            cnt[tile, r0:min(r0 + lab.OP_STRIP, block), :wc] += 1
    else:  # a column strip of `cols` lanes a block
        cw = sh["cols"]
        per = -(-wc // cw)
        for b in range(nb):
            tile, k = divmod(b, per)
            cnt[tile, :block, k * cw:min(k * cw + cw, wc)] += 1
    return cnt


@pytest.mark.parametrize("layout", ["tool", "ragged"])
@pytest.mark.parametrize("case", list(lab.CASES))
def test_launch_shape_covers_every_element_once(case, layout):
    ib, b, wc, _ = op_cost.tile_for(case)
    if layout == "ragged":
        wc = {"vadd4_u8": 316, "shfl1_add_i32": 288,
              "shfl3_add_i32": 288}.get(case, 318)
    for n in lab.BUILT_N_OPS:
        lab.check_op_tile(case, n, ib, b, wc)
        cnt = _stored_counts(case, n, ib, b, wc, 3)
        assert (cnt == 1).all(), (case, n, int(cnt.min()), int(cnt.max()))


@pytest.mark.parametrize("case", list(lab.CASES))
def test_shared_memory_allows_two_blocks_per_sm(case):
    from tpu_stencil_torch.ops import cuda_stencil as cs

    ib, b, wc, grid = op_cost.tile_for(case)
    for n in lab.BUILT_N_OPS:
        sh = lab.op_chain_shape(case, n, ib, b, wc, grid)
        assert sh["smem_bytes"] <= cs.SMEM_LIMIT
        assert sh["threads"] <= (lab.OP_LANES_MAX if case in lab.LANE_ROLL
                                 else lab.OP_SMEM_THREADS)
        if sh["smem_bytes"]:
            assert 2 * (sh["smem_bytes"] + cs.SMEM_PER_BLOCK_RESERVED) \
                <= cs.SM_SMEM, (case, n, sh)
            assert 2 * sh["threads"] <= cs.SM_THREADS
    # the forms the tool's tiles take
    # the forms the tool's tiles take: all but the row roll's shared form
    assert {lab.op_chain_form(c, *op_cost.tile_for(c)[:2])
            for c in lab.CASES} == set(lab.OP_FORMS) - {"roll_smem"}


def test_the_kernel_source_mirrors_the_host_model():
    import re
    from pathlib import Path

    src = (Path(lab.__file__).parent / "csrc" / "op_chain.cu").read_text()
    defines = dict(re.findall(r"^#define (OP_\w+) \(?([0-9 *]+)\)?", src,
                              re.M))
    for name in ("OP_FLAT_THREADS", "OP_COL_THREADS", "OP_SMEM_THREADS",
                 "OP_LANES_MAX",
                 "OP_REG_BLOCK", "OP_REG_ROWS", "OP_STRIP", "OP_SMEM_TARGET",
                 "OP_MMA_COLS", "OP_MMA_THREADS", "OP_BF16_PITCH", "OP_I8_K",
                 "OP_I8_PITCH"):
        assert eval(defines[name]) == getattr(lab, name), name
    assert eval(defines["OP_BAND"]) == lab.BAND

    def enum(name):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        return [w.split("=")[0].strip() for w in body.split(",")
                if w.strip()]

    assert [f[len("FORM_"):].lower() for f in enum("OpForm")] == list(
        lab.OP_FORMS)
    assert [c.lower() for c in enum("OpCase")][:-1] == list(lab.CASES)
