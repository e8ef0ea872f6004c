"""The port's witness re-execution (``integrity/witness.py``) against the
JAX package's, on the CPU: the same seed picks the same sequence, the rate
edges, ``device_witness`` byte-equal to the JAX ``device_witness`` and to
the NumPy golden, ``golden_witness`` catching a flipped byte, and the
witness running torch ops only (no hand-written kernel launch). Inputs are
numpy-seeded; tolerance: exact bytes (integer plans; the one float32
divide is correctly rounded on both sides).
"""

import numpy as np
import pytest
import torch

from tpu_stencil.integrity import witness as jwitness
from tpu_stencil_torch.integrity import witness
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _img(shape=(24, 32, 3), seed=91):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("rate", [0.3, 1 / 256, 0.9])
@pytest.mark.parametrize("seed", [0, 5, 6])
def test_sampler_picks_the_jax_sequence(rate, seed):
    a = witness.WitnessSampler(rate, seed=seed)
    b = jwitness.WitnessSampler(rate, seed=seed)
    seq = [a.pick() for _ in range(2000)]
    assert seq == [b.pick() for _ in range(2000)]
    assert any(seq) and not all(seq)
    c = witness.WitnessSampler(rate, seed=seed + 100)
    assert seq != [c.pick() for _ in range(2000)]


def test_sampler_rate_edges_and_refusals():
    assert witness.DEFAULT_RATE == jwitness.DEFAULT_RATE
    assert witness.WITNESS_MAX_REPS == jwitness.WITNESS_MAX_REPS
    assert not any(witness.WitnessSampler(0.0).pick() for _ in range(50))
    assert all(witness.WitnessSampler(1.0).pick() for _ in range(50))
    for bad in (1.5, -0.01):
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            witness.WitnessSampler(bad)
        with pytest.raises(ValueError):
            jwitness.WitnessSampler(bad)


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("name,shape,reps", [
    ("gaussian", (24, 32, 3), 5), ("gaussian", (17, 23), 2),
    ("edge", (16, 20, 3), 3), ("box", (19, 13), 4), ("gaussian5", (20, 18), 2),
])
def test_device_witness_matches_jax_and_golden(name, shape, reps, boundary):
    img = _img(shape)
    got = witness.device_witness(img, name, reps, boundary, device=CPU)
    assert got.dtype == np.uint8 and got.shape == shape
    want = np.asarray(jwitness.device_witness(img, name, reps, boundary))
    np.testing.assert_array_equal(got, want)
    assert witness.golden_witness(img, name, reps, got, boundary)
    assert jwitness.golden_witness(img, name, reps, got, boundary)


def test_golden_witness_catches_a_flipped_byte():
    img = _img((12, 10, 3))
    good = witness.device_witness(img, "gaussian", 3, device=CPU)
    assert witness.golden_witness(img, "gaussian", 3, good)
    bad = good.copy()
    bad[5, 4, 1] ^= 0x10
    assert not witness.golden_witness(img, "gaussian", 3, bad)
    assert not jwitness.golden_witness(img, "gaussian", 3, bad)


def test_device_witness_runs_torch_ops_only(monkeypatch):
    # The witness is a different program from the one it checks: one
    # torch-ops padded_step per rep, no K1, K2 or K3 launch (nor their
    # plain versions), on the device it is given; a tensor input works.
    steps = []
    orig = lowering.padded_step
    monkeypatch.setattr(lowering, "padded_step",
                        lambda *a, **k: steps.append(1) or orig(*a, **k))
    for fn in ("_fused_lib", "_resident_lib", "_valid_lib",
               "stencil_fused_plain", "stencil_valid_plain"):
        monkeypatch.setattr(cs, fn, lambda *a, _n=fn, **k: pytest.fail(_n))
    before = cs.launch_counts()
    img = _img()
    got = witness.device_witness(torch.from_numpy(img), "gaussian", 4,
                                 device="cpu")
    assert len(steps) == 4
    assert cs.launch_counts() == before
    np.testing.assert_array_equal(
        got, np.asarray(jwitness.device_witness(img, "gaussian", 4)))
