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
        assert lab.op_chain_smem_bytes(case, ib, wc) <= cs.SMEM_LIMIT, case


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
