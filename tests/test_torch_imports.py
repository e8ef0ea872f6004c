"""The port imports nothing of JAX and nothing of the JAX package.

``tpu_stencil_torch`` shares its prefix with ``tpu_stencil``, so every check
is against the exact module name ``tpu_stencil`` and its submodules
``tpu_stencil.*``.
"""

import ast
import json
import os
import pkgutil
import socket
import subprocess
import sys
import time

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
              "tpu_stencil_torch.parallel.overlap",
              "tpu_stencil_torch.parallel.distributed",
              "tpu_stencil_torch.parallel.transport",
              "tpu_stencil_torch.parallel.mesh",
              "tpu_stencil_torch.parallel.fanout",
              "tpu_stencil_torch.parallel.pipeline",
              "tpu_stencil_torch.parallel.sharded",
              "tpu_stencil_torch.stream",
              "tpu_stencil_torch.stream.sharded",
              "tpu_stencil_torch.stream.pipelined",
              "tpu_stencil_torch.stream.frames",
              "tpu_stencil_torch.stream.engine",
              "tpu_stencil_torch.stream.cli",
              "tpu_stencil_torch.utils.timing"):
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


def test_the_crc_loader_and_the_stream_load_no_jax_module(tmp_path):
    # Build and load the crc32c library, checksum a frame and run a
    # two-lane stream on the CPU in a fresh process: still no JAX module.
    import numpy as np

    clip = tmp_path / "clip.raw"
    np.random.default_rng(0).integers(0, 256, (3, 40, 40, 3),
                                      np.uint8).tofile(clip)
    code = (
        "import json, sys, torch\n"
        "from tpu_stencil_torch.integrity import checksum\n"
        "from tpu_stencil_torch.config import ImageType, StreamConfig\n"
        "from tpu_stencil_torch.stream import run_stream\n"
        "checksum.native_library()\n"
        f"cfg = StreamConfig({str(clip)!r}, 40, 40, 2, ImageType.RGB,\n"
        "                   output='null', frames=3, mesh_frames=2)\n"
        "r = run_stream(cfg, devices=[torch.device('cpu')] * 2)\n"
        "assert r.frames == 3\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = json.loads(r.stdout.strip().splitlines()[-1])
    assert "tpu_stencil_torch.parallel.fanout" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_the_sharded_and_pipelined_streams_load_no_jax_module(tmp_path):
    # A sharded stream and a composed pipeline on the CPU in a fresh
    # process: every module they load is the port's.
    import numpy as np

    clip = tmp_path / "clip.raw"
    np.random.default_rng(1).integers(0, 256, (3, 24, 20, 3),
                                      np.uint8).tofile(clip)
    code = (
        "import json, sys, torch\n"
        "from tpu_stencil_torch.config import ImageType, StreamConfig\n"
        "from tpu_stencil_torch.stream import run_stream\n"
        "cpu = [torch.device('cpu')] * 8\n"
        f"base = dict(input={str(clip)!r}, width=20, height=24,\n"
        "            repetitions=2, image_type=ImageType.RGB,\n"
        "            output='null', frames=3, shard_min_pixels=1)\n"
        "r = run_stream(StreamConfig(**base, shard_frames=(2, 2)), cpu)\n"
        "assert r.shard_frames == (2, 2)\n"
        "r = run_stream(StreamConfig(**base, mesh_frames=2, pipe_stages=2,\n"
        "                            shard_frames=(2, 1)), cpu)\n"
        "assert r.pipe_stages == 2 and r.n_devices == 8\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = json.loads(r.stdout.strip().splitlines()[-1])
    assert "tpu_stencil_torch.stream.pipelined" in loaded
    assert "tpu_stencil_torch.stream.sharded" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("rank", ["0", "1"])
def test_initialize_raises_when_the_rendezvous_is_unreachable(rank):
    # WORLD_SIZE=2 and no peer at the rendezvous: initialize() raises
    # within its timeout; it never goes on as a process of its own.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = (
        "from tpu_stencil_torch.parallel import distributed as d\n"
        "try:\n"
        "    d.initialize(timeout_s=3)\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__)\n"
        "else:\n"
        "    print('ALONE', d.process_count())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE="2", RANK=rank,
               LOCAL_RANK=rank, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert "RAISED" in r.stdout, (r.stdout, r.stderr[-2000:])
    assert time.perf_counter() - t0 < 60
