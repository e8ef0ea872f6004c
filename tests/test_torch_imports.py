"""The port imports nothing of JAX and nothing of the JAX package.

``tpu_stencil_torch`` shares its prefix with ``tpu_stencil``, so every check
is against the exact module name ``tpu_stencil`` and its submodules
``tpu_stencil.*``.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import tpu_stencil_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(os.path.abspath(tpu_stencil_torch.__file__))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "tpu_stencil"


def test_forbidden_name_check():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("tpu_stencil") and _forbidden("tpu_stencil.ops.lowering")
    assert not _forbidden("tpu_stencil_torch")
    assert not _forbidden("tpu_stencil_torch.ops.cuda_stencil")
    assert not _forbidden("jaxtyping")


def _modules():
    names = ["tpu_stencil_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], "tpu_stencil_torch."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return names


def test_every_module_is_found():
    mods = _modules()
    for m in ("tpu_stencil_torch.ops.cuda_stencil", "tpu_stencil_torch.cli",
              "tpu_stencil_torch.io.native", "tpu_stencil_torch.driver",
              "tpu_stencil_torch.ops.lab",
              "tpu_stencil_torch.integrity.checksum",
              "tpu_stencil_torch.resilience.errors",
              "tpu_stencil_torch.resilience.retry",
              "tpu_stencil_torch.resilience.deadline",
              "tpu_stencil_torch.runtime.roofline",
              "tpu_stencil_torch.runtime.autotune",
              "tpu_stencil_torch.runtime.bench_sweep",
              "tpu_stencil_torch.tools.kernel_lab",
              "tpu_stencil_torch.tools.op_cost",
              "tpu_stencil_torch.tools.bh_fuse_ab",
              "tpu_stencil_torch.obs",
              "tpu_stencil_torch.obs.context",
              "tpu_stencil_torch.obs.tracing",
              "tpu_stencil_torch.obs.events",
              "tpu_stencil_torch.obs.flight",
              "tpu_stencil_torch.obs.export",
              "tpu_stencil_torch.obs.exposition",
              "tpu_stencil_torch.obs.breakdown",
              "tpu_stencil_torch.obs.introspect",
              "tpu_stencil_torch.serve",
              "tpu_stencil_torch.serve.metrics",
              "tpu_stencil_torch.resilience.faults",
              "tpu_stencil_torch.resilience.fallback",
              "tpu_stencil_torch.runtime.checkpoint",
              "tpu_stencil_torch.integrity.witness",
              "tpu_stencil_torch.parallel.overlap"):
        assert m in mods


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = json.loads(r.stdout.strip().splitlines()[-1])
    assert "tpu_stencil_torch.ops.cuda_stencil" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert bad == [], f"{path} imports {bad}"
