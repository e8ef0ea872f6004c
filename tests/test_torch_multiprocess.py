"""The port across several processes: 2 (or 3) gloo processes on the CPU.

The port's mirror of ``tests/test_multiprocess.py``: real OS processes
join one ``torch.distributed`` gloo group on localhost and run the whole
stack (initialize -> rank 0's config -> per-process read -> the exchange
across processes with K3's plain version or torch ops on each rank's
tiles -> per-process writes into one output file). Every output is held,
byte for byte, against the JAX package's ``reference_stencil_numpy`` and
against the port's one-process ``--mesh`` run; these are integer plans,
so the tolerance is exact.

The worker is this file: ``python tests/test_torch_multiprocess.py worker
RANK NPROCS PORT MODE SPEC`` (``SPEC`` a JSON object), started by
:func:`_launch`; each rank prints one ``RESULT {...}`` line.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _job_cfg(spec):
    from tpu_stencil_torch import config

    return config.JobConfig(
        image=spec["src"], width=spec["w"], height=spec["h"],
        repetitions=spec.get("reps", 3),
        image_type=config.ImageType(spec.get("type", "rgb")),
        filter_name=spec.get("filter", "gaussian"),
        backend=spec.get("backend", "xla"),
        mesh_shape=tuple(spec["mesh"]) if spec.get("mesh") else None,
        output=spec["dst"], frames=spec.get("frames", 1),
        boundary=spec.get("boundary", "zero"),
        overlap=spec.get("overlap", "off"),
        dispatch_timeout_s=spec.get("timeout", 0.0))


def _result(res) -> dict:
    return {"backend": res.backend, "overlap": res.overlap,
            "fuse": res.fuse, "mesh": res.mesh_shape,
            "launches": res.launches,
            "compute_seconds": res.compute_seconds}


def _stall_rank(seconds: float) -> None:
    """Make this rank's first exchange of the timed window (after the
    warm-up) sleep ``seconds`` before it sends anything."""
    from tpu_stencil_torch.parallel import sharded

    real_warm, real_run = (sharded.ShardedRunner.warmup,
                           sharded.ShardedRunner.run)
    armed = []

    def warmup(self, *a):
        out = real_warm(self, *a)
        armed.append(True)
        return out

    def run(self, *a):
        if armed:
            time.sleep(seconds)
        return real_run(self, *a)

    sharded.ShardedRunner.warmup = warmup
    sharded.ShardedRunner.run = run


def _worker(rank: int, n: int, port: str, mode: str, spec: dict) -> dict:
    import torch

    from tpu_stencil_torch import driver
    from tpu_stencil_torch.parallel import distributed

    if mode == "cli":
        # As python -m torch.distributed.run sets it up: env:// rendezvous.
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=port)
        from tpu_stencil_torch import cli

        rc = cli.main(spec["argv"][rank])
        return {"rc": rc}
    distributed.initialize(f"127.0.0.1:{port}", num_processes=n,
                           process_id=rank,
                           timeout_s=spec.get("timeout", 0.0))
    assert distributed.process_count() == n
    assert distributed.process_index() == rank
    devices = [torch.device("cpu")] * spec.get("tiles", 2)
    if mode == "config":
        # Every field crosses: rank 1 passes a config of its own, which
        # must be ignored.
        import dataclasses

        from tpu_stencil_torch import config

        mine = config.JobConfig(
            f"img{rank}.raw", 10 + rank, 20 + rank, 3 + rank,
            config.ImageType("grey" if rank else "rgb"),
            filter_name=("box", "edge")[rank],
            backend=("pallas", "xla")[rank], mesh_shape=((2, 3), None)[rank],
            output=(f"out{rank}.raw", None)[rank], frames=4 - rank,
            schedule=("deep", None)[rank],
            boundary=("periodic", "zero")[rank], block_h=(16, None)[rank],
            fuse=(5, None)[rank], dispatch_timeout_s=(2.5, 0.0)[rank],
            fallback_backend=("cpu", None)[rank],
            overlap=("edge", "off")[rank])
        got = distributed.broadcast_config(mine)
        return {k: (v.value if isinstance(v, config.ImageType) else v)
                for k, v in dataclasses.asdict(got).items()}
    if mode == "mesh":
        from tpu_stencil_torch.parallel import mesh as mesh_mod
        from tpu_stencil_torch.parallel import partition

        assert partition.grid_shape(4, 6, 100) == (1, 4)  # unconstrained
        m = mesh_mod.make_mesh(devices=devices, image_shape=(6, 100))
        try:  # an explicit mesh spans every device of every process
            mesh_mod.make_mesh((1, 2), devices)
            refused = ""
        except ValueError as e:
            refused = str(e)
        return {"grid": list(m.grid), "owners": [list(r) for r in m.owners],
                "local": sum(m.is_local(i, j) for i in range(m.grid[0])
                             for j in range(m.grid[1])),
                "refused": refused}
    if mode == "geom":
        # Each rank fakes a different kernel verdict; both must run rank
        # 0's (its fuse sets the exchange width).
        from tpu_stencil_torch.runtime import autotune

        verdicts = {0: ("pallas", "pack", 32, 12),
                    1: ("pallas", "shrink", 16, 10)}
        autotune.best_full_config = lambda *a, **k: verdicts[rank]
    if mode == "framesresume":
        # Seed a rep-1 checkpoint of ANOTHER clip; the resumed run must
        # continue from it, not from the input file.
        from tpu_stencil_torch import filters
        from tpu_stencil_torch.runtime import checkpoint as ckpt

        cfg = _job_cfg(spec)
        per = -(-cfg.frames // n)
        f0 = min(cfg.frames, rank * per)
        n_local = min(cfg.frames, f0 + per) - f0
        clip = np.random.default_rng(99).integers(
            0, 256, (cfg.frames, cfg.height, cfg.width, 3), np.uint8)
        g = filters.get_filter("gaussian")
        seed = (np.stack([_numpy_golden(clip[k], g, 1)
                          for k in range(f0, f0 + n_local)])
                if n_local else None)
        ckpt.save_frames_sharded(cfg, 1, seed, f0)
        distributed.barrier()  # rank 0's sidecar is out before any reads
        return _result(driver.run_job(cfg, devices=devices, resume=True))
    if spec.get("stall") and rank == 1:
        _stall_rank(spec["stall"])
    # Rank 0 owns the config; the others receive it.
    cfg = distributed.broadcast_config(_job_cfg(spec) if rank == 0 else None)
    assert cfg.output == spec["dst"]
    kw = {"checkpoint_every": spec.get("ckpt", 0),
          "resume": spec.get("resume", False)}
    if spec.get("faults"):
        from tpu_stencil_torch.resilience import faults

        faults.configure(spec["faults"])
    if spec.get("stall") and rank == 0:
        from tpu_stencil_torch.resilience.errors import CollectiveTimeout

        t0 = time.perf_counter()
        try:
            driver.run_job(cfg, devices=devices, **kw)
        except CollectiveTimeout as e:
            return {"timeout": type(e).__name__, "label": e.label,
                    "seconds": e.seconds, "edges": e.edges,
                    "elapsed": time.perf_counter() - t0}
        return {"timeout": None}
    if spec.get("faults"):
        from tpu_stencil_torch.resilience.errors import InjectedFault

        try:
            driver.run_job(cfg, devices=devices, **kw)
        except InjectedFault:
            return {"killed": True}
        return {"killed": False}
    return _result(driver.run_job(cfg, devices=devices, **kw))


def _numpy_golden(img, filt, reps):
    from tpu_stencil_torch.ops import stencil

    return stencil.reference_stencil_numpy(img, filt, reps)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode: str, spec: dict, n: int = 2, tmp_path=None,
            timeout: float = 240, expect_rc=0) -> list:
    """Run ``n`` workers of ``mode`` on one gloo group; returns each
    rank's RESULT object. ``expect_rc=None``: wait for rank 0 alone, kill
    the others, and return rank 0's whole output."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        OMP_NUM_THREADS="1")
    if tmp_path is not None:
        env["TPU_STENCIL_TORCH_AUTOTUNE_CACHE"] = str(tmp_path / "at.json")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), str(n),
         port, mode, json.dumps(spec)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs[:1] if expect_rc is None else procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if expect_rc is None:
        return outs[0]
    res = []
    for p, out in zip(procs, outs):
        assert p.returncode == expect_rc, f"worker exited {p.returncode}:\n{out}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        res.append(json.loads(line[-1][len("RESULT "):]))
    return res


def _image(tmp_path, rng, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    src = str(tmp_path / "in.raw")
    img.tofile(src)
    return img, src


def _golden(img, reps, name="gaussian", boundary="zero"):
    """The JAX package's NumPy golden model (zero boundary), or its
    periodic reference through the JAX package's torch-free lowering."""
    from tpu_stencil import filters
    from tpu_stencil.ops import stencil

    if boundary == "zero":
        return stencil.reference_stencil_numpy(img, filters.get_filter(name),
                                               reps)
    import jax.numpy as jnp

    from tpu_stencil.ops import lowering

    plan = lowering.plan_filter(filters.get_filter(name))
    x = jnp.asarray(img)
    for _ in range(reps):
        x = lowering.padded_step(x, plan, boundary)
    return np.asarray(x)


def _one_process(tmp_path, src, w, h, reps, mesh, **kw) -> np.ndarray:
    """The port's one-process ``--mesh`` run of the same job."""
    import torch

    from tpu_stencil_torch import config, driver

    dst = str(tmp_path / "one.raw")
    cfg = config.JobConfig(
        image=src, width=w, height=h, repetitions=reps,
        image_type=config.ImageType(kw.pop("type", "rgb")),
        mesh_shape=mesh, output=dst, **kw)
    driver.run_job(cfg, devices=[torch.device("cpu")] * (mesh[0] * mesh[1]))
    return np.fromfile(dst, np.uint8)


def _spec(src, dst, w, h, **kw) -> dict:
    return dict(src=src, dst=dst, w=w, h=h, **kw)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_two_process_end_to_end(tmp_path, rng, mesh):
    img, src = _image(tmp_path, rng, (12, 20, 3))
    dst = str(tmp_path / "out.raw")
    res = _launch("job", _spec(src, dst, 20, 12, mesh=list(mesh)))
    assert [r["mesh"] for r in res] == [list(mesh)] * 2
    got = np.fromfile(dst, np.uint8)
    np.testing.assert_array_equal(got.reshape(img.shape), _golden(img, 3))
    np.testing.assert_array_equal(
        got, _one_process(tmp_path, src, 20, 12, 3, mesh, backend="xla"))


def test_two_process_cli_divergent_argv_runs_rank0_job(tmp_path, rng):
    # Rank 1 asks for 99 reps and another output; both must run rank 0's
    # 3-rep job into rank 0's file (the job shear MPI_Bcast prevents).
    img, src = _image(tmp_path, rng, (12, 20, 3))
    dst = str(tmp_path / "out.raw")
    # The CLI gives each process one CPU device: a 1x2 mesh.
    base = [src, "20", "12"]
    argv = [base + ["3", "rgb", "--mesh", "1x2", "--output", dst,
                    "--platform", "cpu", "--backend", "xla"],
            base + ["99", "rgb", "--mesh", "1x2", "--output", dst + ".wrong",
                    "--platform", "cpu", "--backend", "xla"]]
    res = _launch("cli", {"argv": argv})
    assert res == [{"rc": 0}, {"rc": 0}]
    assert not os.path.exists(dst + ".wrong")
    np.testing.assert_array_equal(
        np.fromfile(dst, np.uint8).reshape(img.shape), _golden(img, 3))


def test_two_process_broadcast_config_carries_every_field():
    res = _launch("config", {})
    assert res[0] == res[1]
    assert res[0]["image"] == "img0.raw" and res[0]["mesh_shape"] == [2, 3]
    assert (res[0]["dispatch_timeout_s"], res[0]["fallback_backend"],
            res[0]["overlap"], res[0]["fuse"]) == (2.5, "cpu", "edge", 5)


def test_two_process_mesh_layout_keeps_rows_within_a_process(tmp_path):
    # A wide image whose unconstrained optimum is (1, 4) must get a grid
    # whose rows are each one process's tiles, so only the strips between
    # mesh rows cross processes.
    res = _launch("mesh", {})
    for r in res:
        assert r["grid"] == [2, 2] and r["local"] == 2
        assert all(len(set(row)) == 1 for row in r["owners"]), r
        assert "1x2 != 4 devices" in r["refused"], r
    assert res[0]["owners"] == res[1]["owners"] == [[0, 0], [1, 1]]


def test_two_process_checkpointed_run(tmp_path, rng):
    img, src = _image(tmp_path, rng, (12, 20, 3))
    dst = str(tmp_path / "out.raw")
    _launch("job", _spec(src, dst, 20, 12, mesh=[2, 2], ckpt=1))
    np.testing.assert_array_equal(
        np.fromfile(dst, np.uint8).reshape(img.shape), _golden(img, 3))
    assert not os.path.exists(dst + ".ckpt.json")  # cleared after success


def test_two_process_checkpoint_kill_and_resume(tmp_path, rng):
    # Killed at rep 5 on both ranks (the K3 path, 2x2 over 2 processes),
    # then resumed: the bytes equal the uninterrupted run's.
    img, src = _image(tmp_path, rng, (24, 32, 3))
    dst = str(tmp_path / "out.raw")
    spec = _spec(src, dst, 32, 24, mesh=[2, 2], reps=9, backend="pallas",
                 ckpt=2)
    killed = _launch("job", dict(spec, faults="compute:rep=5"))
    assert killed == [{"killed": True}] * 2
    meta = json.load(open(dst + ".ckpt.json"))
    assert meta["rep"] == 4, meta
    _launch("job", dict(spec, resume=True))
    got = np.fromfile(dst, np.uint8)
    np.testing.assert_array_equal(got.reshape(img.shape), _golden(img, 9))
    np.testing.assert_array_equal(got, _one_process(
        tmp_path, src, 32, 24, 9, (2, 2), backend="pallas"))
    assert [f for f in os.listdir(tmp_path) if ".ckpt" in f] == []


def test_two_process_autotune_backend_agreement(tmp_path, rng):
    img, src = _image(tmp_path, rng, (12, 20, 3))
    dst = str(tmp_path / "out.raw")
    res = _launch("job", _spec(src, dst, 20, 12, mesh=[2, 2],
                               backend="autotune"), tmp_path=tmp_path)
    assert res[0]["backend"] == res[1]["backend"] == "xla"
    np.testing.assert_array_equal(
        np.fromfile(dst, np.uint8).reshape(img.shape), _golden(img, 3))


def test_two_process_geometry_agreement(tmp_path, rng):
    # Divergent faked kernel verdicts: both ranks run rank 0's fuse (12),
    # not their own (10), and the bytes stay exact under it.
    img, src = _image(tmp_path, rng, (40, 48, 3))
    dst = str(tmp_path / "out.raw")
    res = _launch("geom", _spec(src, dst, 48, 40, mesh=[2, 2], reps=13,
                                backend="auto"), tmp_path=tmp_path)
    assert [(r["backend"], r["fuse"]) for r in res] == [("pallas", 12)] * 2
    np.testing.assert_array_equal(
        np.fromfile(dst, np.uint8).reshape(img.shape), _golden(img, 13))


@pytest.mark.parametrize("n_frames", [3, 5])
def test_two_process_frames_ranges(tmp_path, rng, n_frames):
    # Each process its contiguous frame range (2 + 1, or 3 + 2), written
    # into its byte range of one shared output.
    frames, src = _image(tmp_path, rng, (n_frames, 10, 8, 3))
    dst = str(tmp_path / "out.raw")
    _launch("job", _spec(src, dst, 8, 10, reps=2, frames=n_frames,
                         tiles=1))
    got = np.fromfile(dst, np.uint8).reshape(frames.shape)
    for k in range(n_frames):
        np.testing.assert_array_equal(got[k], _golden(frames[k], 2),
                                      err_msg=f"frame {k}")


@pytest.mark.parametrize("mode,n_frames,n_procs", [
    ("job", 5, 2),
    # 2 frames over 3 processes: process 2 has none and must still join
    # every commit barrier (else every checkpoint deadlocks).
    ("job", 2, 3),
    ("framesresume", 5, 2),
])
def test_two_process_frames_checkpointing(tmp_path, rng, mode, n_frames,
                                          n_procs):
    frames, src = _image(tmp_path, rng, (n_frames, 10, 8, 3))
    dst = str(tmp_path / "out.raw")
    spec = _spec(src, dst, 8, 10, frames=n_frames, tiles=1,
                 ckpt=0 if mode == "framesresume" else 1)
    _launch(mode, spec, n=n_procs)
    want = frames
    if mode == "framesresume":
        want = np.random.default_rng(99).integers(
            0, 256, (n_frames, 10, 8, 3), np.uint8)
    got = np.fromfile(dst, np.uint8).reshape(frames.shape)
    for k in range(n_frames):
        np.testing.assert_array_equal(got[k], _golden(want[k], 3),
                                      err_msg=f"frame {k}")
    assert [f for f in os.listdir(tmp_path) if ".ckpt" in f] == []


@pytest.mark.parametrize("overlap", ["off", "split", "fused-split", "edge",
                                     "auto"])
def test_two_process_overlap_modes(tmp_path, rng, overlap):
    # 2x2 over 2 processes on the kernels' path (K3's plain version here):
    # every mode byte-equal to the golden and to one process's run; both
    # ranks report one resolved mode, and K3 ran on both.
    img, src = _image(tmp_path, rng, (40, 48, 3))
    dst = str(tmp_path / "out.raw")
    res = _launch("job", _spec(src, dst, 48, 40, mesh=[2, 2], reps=10,
                               backend="pallas", overlap=overlap),
                  tmp_path=tmp_path)
    assert res[0]["overlap"] == res[1]["overlap"]
    if overlap != "auto":
        assert res[0]["overlap"] == overlap
    assert [r["backend"] for r in res] == ["pallas"] * 2
    got = np.fromfile(dst, np.uint8)
    np.testing.assert_array_equal(got.reshape(img.shape), _golden(img, 10))
    np.testing.assert_array_equal(got, _one_process(
        tmp_path, src, 48, 40, 10, (2, 2), backend="pallas",
        overlap="off"))


@pytest.mark.parametrize("case", ["grey", "masked", "periodic"])
def test_two_process_grey_masked_and_periodic(tmp_path, rng, case):
    # grey under K3; an indivisible (padded, masked) shape under K3 and
    # the edge pipeline; a periodic run (torch ops: W and E neighbours on
    # one peer, told apart by their tags).
    shape = {"grey": (24, 32), "masked": (23, 31, 3),
             "periodic": (24, 32, 3)}[case]
    img, src = _image(tmp_path, rng, shape)
    dst = str(tmp_path / "out.raw")
    kw = {"grey": dict(type="grey", backend="pallas"),
          "masked": dict(backend="pallas", overlap="edge"),
          "periodic": dict(backend="xla", boundary="periodic")}[case]
    _launch("job", _spec(src, dst, shape[1], shape[0], mesh=[2, 2], reps=5,
                         **kw))
    got = np.fromfile(dst, np.uint8)
    np.testing.assert_array_equal(
        got.reshape(img.shape),
        _golden(img, 5, boundary=kw.get("boundary", "zero")))
    np.testing.assert_array_equal(got, _one_process(
        tmp_path, src, shape[1], shape[0], 5, (2, 2), **kw))


def test_two_process_stalled_peer_raises_collective_timeout(tmp_path, rng):
    # Rank 1 stalls before its first send of the window; rank 0 must raise
    # CollectiveTimeout within the dispatch timeout, not hang.
    img, src = _image(tmp_path, rng, (24, 32, 3))
    dst = str(tmp_path / "out.raw")
    out = _launch("job", _spec(src, dst, 32, 24, mesh=[2, 2], reps=4,
                               backend="pallas", timeout=3.0, stall=60),
                  expect_rc=None, timeout=120)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert line, out
    r = json.loads(line[-1][len("RESULT "):])
    assert r["timeout"] == "CollectiveTimeout", r
    assert r["seconds"] == 3.0 and r["edges"] == {}
    assert 2.5 < r["elapsed"] < 30, r


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _rank, _n, _port, _mode = (int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4], sys.argv[5])
    _out = _worker(_rank, _n, _port, _mode, json.loads(sys.argv[6]))
    print("RESULT " + json.dumps(_out), flush=True)
    # A rank that raised CollectiveTimeout still has a receive posted; it
    # leaves without waiting for it.
    os._exit(0)
