"""The port's torch-ops lowering against the JAX package's ``ops.lowering``
and ``ops.stencil``, on the same seeded numpy inputs.

Tolerance: exact byte equality. Integer plans are exact; the one float32
divide is correctly rounded on both sides; the ``direct_f32`` filter
used here has dyadic-fraction taps, so every product and partial sum is
exact in float32 whatever the order of the adds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_stencil import filters as jfilters
from tpu_stencil.ops import lowering as jlowering
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch.ops import lowering as tlowering
from tpu_stencil_torch.ops import stencil as tstencil

# One filter per plan kind (and finish): sep_int shift, sep_int divide,
# direct_int divide, direct_int shift with a clip that binds, direct_f32,
# and a wide separable shift plan.
FILTERS = {
    "gaussian": None, "box": None, "edge": None, "gaussian5": None,
    "laplacian": (np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]]), 1.0),
    "float": (np.array([[0.125, 0.25, 0.125], [0.25, 0.5, 0.25],
                        [0.125, 0.25, 0.125]]), 2.0),
}
SHAPES = [(37, 29), (16, 12, 3)]


def _filters(name):
    if FILTERS[name] is None:
        return jfilters.get_filter(name), tfilters.get_filter(name)
    taps, div = FILTERS[name]
    return jfilters.Filter(taps, div), tfilters.from_numpy(taps, div)


def _plans(name):
    jf, tf = _filters(name)
    return jlowering.plan_filter(jf), tlowering.plan_filter(tf)


def test_filter_set_covers_every_plan_kind():
    kinds = {(_plans(n)[1].kind, _plans(n)[1].shift is None) for n in FILTERS}
    assert {k for k, _ in kinds} == {"sep_int", "direct_int", "direct_f32"}
    assert ("sep_int", True) in kinds and ("direct_int", False) in kinds


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_padded_step_matches_jax(name, shape, boundary):
    jplan, tplan = _plans(name)
    img = np.random.default_rng(11).integers(0, 256, shape, dtype=np.uint8)
    want, got = jnp.asarray(img), torch.from_numpy(img)
    for _ in range(3):
        want = jlowering.padded_step(want, jplan, boundary)
        got = tlowering.padded_step(got, tplan, boundary)
        assert got.dtype == torch.uint8 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_valid_step_matches_jax(name):
    jplan, tplan = _plans(name)
    h = tplan.halo
    ext = np.random.default_rng(12).integers(
        0, 256, (20 + 2 * h, 13 + 2 * h, 3), dtype=np.uint8)
    want = np.asarray(jlowering.valid_step(jnp.asarray(ext), jplan))
    got = tlowering.valid_step(torch.from_numpy(ext), tplan).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["gaussian", "box", "edge"])
def test_reference_backend_plan_matches_jax(name):
    # The 'reference' backend: every plan demoted to f32 MACs (integer
    # taps below 2^24, so exact) and one divide.
    jplan, tplan = _plans(name)
    jf32, tf32 = jlowering.force_f32_plan(jplan), tlowering.force_f32_plan(tplan)
    img = np.random.default_rng(13).integers(0, 256, (19, 23, 3), np.uint8)
    want = np.asarray(jlowering.padded_step(jnp.asarray(img), jf32))
    got = tlowering.padded_step(torch.from_numpy(img), tf32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["gaussian", "box", "edge", "gaussian5"])
def test_stencil_step_matches_jax(name):
    jf, tf = _filters(name)
    img = np.random.default_rng(14).integers(0, 256, (17, 15, 3), np.uint8)
    want = np.asarray(jstencil.stencil_step(
        jnp.asarray(img), jnp.asarray(jf.taps), jnp.float32(jf.divisor)))
    got = tstencil.stencil_step(torch.from_numpy(img),
                                torch.from_numpy(tf.taps), tf.divisor)
    np.testing.assert_array_equal(got.numpy(), want)


def test_truncate_u8_clips_before_the_cast():
    x = np.array([-3.5, 0.0, 0.99, 254.7, 255.0, 300.0], np.float32)
    want = np.asarray(jstencil.truncate_u8(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tstencil.truncate_u8(torch.from_numpy(x)).numpy(), want)


def test_divide_is_correctly_rounded_over_the_whole_range():
    # Every accumulator the box (/9) and edge (/28) plans can produce.
    for div in (9.0, 28.0):
        acc = np.arange(0, 255 * int(div) + 1, dtype=np.int32)
        got = tlowering.divide_f32(torch.from_numpy(acc).float(), div).numpy()
        np.testing.assert_array_equal(got, acc.astype(np.float32)
                                      / np.float32(div))


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("name", ["gaussian", "box", "edge", "float"])
def test_golden_models_agree(name, boundary):
    jf, tf = _filters(name)
    img = np.random.default_rng(15).integers(0, 256, (7, 6, 3), np.uint8)
    want = jstencil.reference_stencil_numpy(img, jf, 2, boundary)
    got = tstencil.reference_stencil_numpy(img, tf, 2, boundary)
    np.testing.assert_array_equal(got, want)
    # ... and the torch-ops lowering reproduces the golden model
    out = torch.from_numpy(img)
    for _ in range(2):
        out = tlowering.padded_step(out, tlowering.plan_filter(tf), boundary)
    np.testing.assert_array_equal(out.numpy(), got)


def test_periodic_pad_wider_than_the_image():
    x = torch.arange(3, dtype=torch.int32)
    got = tlowering.pad_dim(x, 0, 4, "periodic")
    np.testing.assert_array_equal(got.numpy(), np.pad(np.arange(3), 4, "wrap"))
    with pytest.raises(ValueError):
        tlowering.pad_dim(x, 0, 1, "mirror")
