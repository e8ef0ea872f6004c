"""The port's filter bank and plan choice against the JAX package's.

Tolerance: exact. Taps, divisors and flags are compared as values, and
the plans of both packages must be equal field for field.
"""

import dataclasses

import numpy as np
import pytest

from tpu_stencil import filters as jfilters
from tpu_stencil.ops import lowering as jlowering
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch.ops import lowering as tlowering

NAMES = sorted(jfilters.FILTERS.keys()) + ["gaussian5", "gaussian7", "gaussian9"]

# Custom filters, one per plan kind the registry does not reach:
# float taps (direct_f32), a non-separable dyadic integer filter
# (direct_int + shift), negative taps (a clip that binds).
CUSTOM = {
    "float": (np.array([[0.125, 0.25, 0.125], [0.25, 0.5, 0.25],
                        [0.125, 0.25, 0.125]]), 2.0),
    "dyadic_direct": (np.array([[1, 2, 1], [2, 4, 3], [1, 1, 1]]), 16.0),
    "laplacian": (np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]]), 1.0),
    "wide_box": (np.ones((5, 5)), 25.0),
}


def test_registry_names_match():
    assert sorted(tfilters.FILTERS.keys()) == sorted(jfilters.FILTERS.keys())


@pytest.mark.parametrize("name", NAMES)
def test_filter_matches(name):
    j, t = jfilters.get_filter(name), tfilters.get_filter(name)
    assert t.taps.dtype == np.float32
    np.testing.assert_array_equal(t.taps, j.taps)
    assert t.divisor == j.divisor
    assert (t.k, t.halo) == (j.k, j.halo)
    assert t.is_exact == j.is_exact
    assert t.is_dyadic == j.is_dyadic


@pytest.mark.parametrize("name", NAMES + sorted(CUSTOM))
def test_plan_filter_matches_through_plan_from_fields(name):
    if name in CUSTOM:
        taps, div = CUSTOM[name]
        jf, tf = jfilters.Filter(taps, div), tfilters.from_numpy(taps, div)
    else:
        jf, tf = jfilters.get_filter(name), tfilters.get_filter(name)
    jplan = jlowering.plan_filter(jf)
    tplan = tlowering.plan_filter(tf)
    assert tlowering.plan_from_fields(dataclasses.asdict(jplan)) == tplan
    assert tplan.halo == jplan.halo
    # the reference backend's forced f32 plan agrees too
    assert tlowering.plan_from_fields(
        dataclasses.asdict(jlowering.force_f32_plan(jplan))
    ) == tlowering.force_f32_plan(tplan)


def test_plan_kinds_cover_every_kind():
    kinds = {
        tlowering.plan_filter(tfilters.from_numpy(*CUSTOM[n])).kind
        for n in CUSTOM
    } | {tlowering.plan_filter(tfilters.get_filter(n)).kind for n in NAMES}
    assert kinds == {"sep_int", "direct_int", "direct_f32"}


def test_from_numpy_and_as_filter():
    f = tfilters.from_numpy([[0, 0, 0], [0, 1, 0], [0, 0, 0]])
    assert f.divisor == 1.0 and f.k == 3
    raw = np.full((3, 3), 1.0 / 9, np.float32)
    np.testing.assert_array_equal(tfilters.as_filter(raw).taps,
                                  jfilters.as_filter(raw).taps)


@pytest.mark.parametrize("bad", [np.ones((2, 2)), np.ones((3, 5))])
def test_bad_taps_rejected_like_jax(bad):
    with pytest.raises(ValueError):
        jfilters.Filter(bad, 1.0)
    with pytest.raises(ValueError):
        tfilters.Filter(bad, 1.0)


def test_unknown_and_invalid_names():
    with pytest.raises(KeyError):
        tfilters.get_filter("nope")
    with pytest.raises(ValueError):
        tfilters.binomial_blur(4)
    with pytest.raises(ValueError):
        tfilters.Filter(np.ones((3, 3)), 0.0)
