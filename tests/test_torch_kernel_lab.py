"""The kernel lab's variants (L2): each exact variant's plain version, on
the CPU, against the JAX tool's kernel in interpret mode and against the
JAX package's ``padded_step`` chain, byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tools import kernel_lab as jax_lab
from tpu_stencil import filters as jax_filters
from tpu_stencil.ops import lowering as jax_lowering

from tpu_stencil_torch import filters
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lab
from tpu_stencil_torch.ops import lowering
from tpu_stencil_torch.tools import kernel_lab

# The tensors here are tiny: one thread each, and the cores stay with the
# other test workers (their wall-clock assertions starve otherwise).
torch.set_num_threads(1)

# The port's variant -> the JAX tool's options for the same rep body.
JAX_OPTS = {
    "current": dict(),
    "pair": dict(shrink=True, pair_add=True),   # shrink_pair
    "acc16": dict(shrink=True),                 # shrink
    "swar": dict(swar=True),                    # swar
}


def _plans(name):
    jp = jax_lowering.plan_filter(jax_filters.get_filter(name))
    tp = lowering.plan_filter(filters.get_filter(name))
    assert lowering.plan_from_fields(dataclasses.asdict(jp)) == tp
    return jp, tp


def _image(shape, channels, seed=0):
    full = shape + ((channels,) if channels > 1 else ())
    return np.random.default_rng(seed).integers(0, 256, full, dtype=np.uint8)


def _jax_chain(img, plan, reps):
    x = jnp.asarray(img)
    for _ in range(reps):
        x = jax_lowering.padded_step(x, plan)
    return np.asarray(x)


@pytest.mark.parametrize("fuse", [1, 4, 8])
@pytest.mark.parametrize("filter_name", ["gaussian", "gaussian5"])
@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "rgb"])
@pytest.mark.parametrize("shape", [(64, 48), (37, 29)],
                         ids=["64x48", "37x29"])
@pytest.mark.parametrize("name", list(JAX_OPTS))
def test_plain_variant_equals_jax_lab_kernel(monkeypatch, name, shape,
                                             channels, filter_name, fuse):
    monkeypatch.setenv("TPU_LAB_INTERPRET", "1")
    jp, tp = _plans(filter_name)
    img = _image(shape, channels)
    variant = lab.parse_variant(name)
    assert lab.variant_supported(variant, tp)
    it, jfuse = jax_lab.build_variant(jp, shape, channels, block_h=128,
                                      fuse=fuse, **JAX_OPTS[name])
    want_kernel = np.asarray(it(jnp.asarray(img), jfuse))
    want_chain = _jax_chain(img, jp, jfuse)
    x2 = torch.from_numpy(img).reshape(shape[0], -1)
    got = lab.stencil_lab_plain(x2, tp, channels, jfuse, variant)
    got = got.numpy().reshape(img.shape)
    assert np.array_equal(want_kernel, want_chain)
    assert np.array_equal(got, want_chain)
    # the wrapper on a CPU tensor runs the plain version and counts nothing
    before = lab.stencil_lab.launches
    out = lab.stencil_lab(x2, tp, channels, jfuse, variant)
    assert torch.equal(out, torch.from_numpy(got).reshape(x2.shape))
    assert lab.stencil_lab.launches == before


@pytest.mark.parametrize("name", list(JAX_OPTS))
def test_lab_iterate_runs_remainders_like_k1(name):
    _, tp = _plans("gaussian")
    img = torch.from_numpy(_image((40, 24), 3, seed=3))
    variant = lab.parse_variant(name + "_f4")
    got = lab.lab_iterate(img, 11, tp, variant)  # 2 fused + 3 single
    assert torch.equal(got, lowering.iterate(img, 11, tp))
    assert torch.equal(got, cs.iterate(img, 11, tp))
    assert torch.equal(lab.lab_iterate(img, 0, tp, variant), img)


def test_frames_layout_and_rows_real():
    _, tp = _plans("gaussian")
    x2 = torch.from_numpy(_image((30, 20), 3, seed=5)).reshape(30, -1)
    for kw in (dict(rows_real=27), dict(rows_real=29, frame=(10, 9))):
        want = cs.stencil_fused_plain(x2, tp, 3, 3, **kw)
        for name in JAX_OPTS:
            got = lab.stencil_lab_plain(x2, tp, 3, 3,
                                        lab.parse_variant(name), **kw)
            assert torch.equal(got, want), (name, kw)


def test_variant_names_and_defines():
    v = lab.parse_variant("swar_f16_b64")
    assert (v.body, v.block_h, v.fuse, v.exact) == ("swar", 64, 16, True)
    assert v.defines == ("LAB_BODY=3",)
    assert lab.parse_variant("swar_b64_f16").defines == v.defines
    a = lab.parse_variant("abl_swar_no_mask")
    assert (a.body, a.no_mask, a.exact) == ("swar", True, False)
    assert a.defines == ("LAB_BODY=3", "LAB_NO_MASK=1")
    assert lab.parse_variant("abl_load_store_only").defines == (
        "LAB_BODY=0", "LAB_LOAD_STORE_ONLY=1")
    # variants that differ only in geometry share one library
    targets = lab.lab_targets([lab.parse_variant(n) for n in
                               ("pair", "pair_b64", "pair_f16_b64", "swar")])
    assert targets == (("stencil_lab", ("LAB_BODY=1",)),
                       ("stencil_lab", ("LAB_BODY=3",)))


@pytest.mark.parametrize("name", ["hoist", "shrink_pair", "shrink_strips",
                                  "swar_cols_ilp", "abl_dma_only", "swar_b",
                                  "abl_swar", "current_b8_b16"])
def test_unknown_variant_is_a_usage_error(name, capsys):
    with pytest.raises(ValueError):
        lab.parse_variant(name)
    with pytest.raises(SystemExit) as e:
        kernel_lab.main([name, "--platform", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "the variants are" in err and "swar" in err


def test_gates():
    g3 = _plans("gaussian")[1]
    g7 = _plans("gaussian7")[1]
    box = _plans("box")[1]
    edge = _plans("edge")[1]
    assert lab.swar_ok(g3) and lab.acc16_ok(g3)
    assert not lab.swar_ok(g7)            # shift 12 > 8
    assert lab.acc16_ok(g7)
    assert not lab.swar_ok(box)           # divides, does not shift
    assert lab.variant_supported(lab.parse_variant("current"), box)
    assert not lab.variant_supported(lab.parse_variant("pair"), box)
    assert not lab.variant_supported(lab.parse_variant("current"), edge)
    with pytest.raises(ValueError, match="does not run this plan"):
        lab.stencil_lab(torch.zeros((8, 8), dtype=torch.uint8), g7, 1, 1,
                        lab.parse_variant("swar"))
    assert lab.binomial_chain((1, 4, 6, 4, 1)) == 4
    assert lab.binomial_chain((1, 1, 1)) is None


def test_shared_memory_model():
    g3 = _plans("gaussian")[1]
    cur, a16, sw = (lab.parse_variant(n) for n in ("current", "acc16", "swar"))
    k1 = cs.tile_smem_bytes(g3, 32, 8, 3)
    assert lab.lab_smem_bytes(cur, g3, 32, 8, 3) == k1 == 48 * 304 * 5
    assert lab.lab_smem_bytes(a16, g3, 32, 8, 3) == 48 * 304 * 3
    assert lab.lab_smem_bytes(sw, g3, 32, 8, 3) == (26 + 24) * 304 * 4
    # every body's tile fits wherever K1's does
    for bh, fz in ((8, 1), (32, 8), (64, 16), (128, 8)):
        for v in (cur, a16, sw):
            assert lab.lab_smem_bytes(v, g3, bh, fz, 3) <= cs.tile_smem_bytes(
                g3, bh, fz, 3)


def test_ablations_drop_what_they_say():
    _, tp = _plans("gaussian")
    x2 = torch.from_numpy(_image((24, 16), 3, seed=7)).reshape(24, -1)
    ident = lab.stencil_lab_plain(x2, tp, 3, 4,
                                  lab.parse_variant("abl_load_store_only"))
    assert torch.equal(ident, x2)
    for flag in ("no_rows", "no_cols", "no_mask"):
        a = lab.stencil_lab_plain(x2, tp, 3, 4, lab.parse_variant("abl_" + flag))
        b = lab.stencil_lab_plain(x2, tp, 3, 4,
                                  lab.parse_variant("abl_swar_" + flag))
        assert torch.equal(a, b), flag
        assert not torch.equal(a, cs.stencil_fused_plain(x2, tp, 3, 4)), flag


def test_tool_runs_on_the_cpu_and_reports_exact(capsys):
    rc = kernel_lab.main(["shipped", "current", "swar", "abl_no_rows",
                          "--platform", "cpu", "--shape", "24x16", "--reps",
                          "4", "--rounds", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = out.strip().splitlines()
    assert lines[0].startswith("platform=cpu")
    assert [ln.split()[0] for ln in lines[1:5]] == [
        "shipped", "current", "swar", "abl_no_rows"]
    assert all("us/rep" in ln for ln in lines[1:5])
    assert lines[1].endswith("exact=True") and lines[4].endswith("exact=-")
    assert lines[5].startswith("current / shipped = ")


def test_tool_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert kernel_lab.main(["current"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_tool_docstring_answers_every_jax_variant():
    doc = kernel_lab.__doc__
    for name in ["shipped"] + list(jax_lab.VARIANTS) + ["xla", "xla_pair"]:
        assert name in doc, name
