"""Checkpoint / resume for long iterated-stencil runs: the job half.

The port's counterpart of the JAX package's ``runtime/checkpoint.py``
(``save``, ``restore``, ``save_sharded``, ``restore_sharded``, ``clear``,
``CorruptCheckpoint``), in the same on-disk format: the iteration state
is the current uint8 frame, so a checkpoint is the frame's raw bytes plus
a JSON sidecar recording the reps it already contains and the job's
fingerprint, stamped with a crc32c of its canonical JSON. Data and sidecar
are committed by tmp-then-rename (fsynced first), and a restore refuses a
corrupt sidecar (:class:`CorruptCheckpoint`, naming the file) or one
written for another job. A checkpoint written by either package resumes
in the other.

The sharded format writes every tile's rectangle into one versioned data
file ``<base>.ckpt.r<rep>`` (:func:`tpu_stencil_torch.parallel.
distributed.write_sharded`), then commits a sidecar naming it and sweeps
older versions. With several processes every process writes its own
tiles (or, for ``--frames``, its own frame range: the frames half) into
the one shared data file, and after a barrier of all of them rank 0
alone publishes the sidecar (:func:`_commit_meta`); a process with no
frames still joins every commit. Only rank 0 clears.

The stream half (:func:`save_stream_progress`,
:func:`restore_stream_progress`, :func:`clear_stream_progress`,
:class:`MeshCursorMismatch`) records a stream's progress beside its sink:
frames [0, n) are durably written, plus the job's fingerprint and the
topology that wrote them (the fan width with its per-device cursors, a
spatial shard, the pipeline stages), in the JAX package's sidecar format.
A resume under another topology fails typed.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from tpu_stencil_torch.config import JobConfig
from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.io import native
from tpu_stencil_torch.io.raw import fsync_path


class CorruptCheckpoint(ValueError):
    """A checkpoint sidecar failed its embedded CRC (or no longer
    parses): refuse to resume, naming the file. A ``ValueError`` so every
    resume path classifies it permanent."""

    def __init__(self, path: str, why: str) -> None:
        super().__init__(
            f"checkpoint sidecar {path} is corrupt ({why}); refusing "
            f"to resume from it — delete the file to start over, or "
            f"restore it from a good copy"
        )
        self.path = path


def _canonical_body(meta: dict) -> bytes:
    """The bytes the sidecar CRC covers: canonical JSON of every field
    except the stamp itself (one serialization for writer and
    verifier)."""
    return json.dumps(
        {k: meta[k] for k in sorted(meta) if k != "crc32c"},
        sort_keys=True,
    ).encode()


def _stamp_crc(meta: dict) -> dict:
    return dict(meta, crc32c=_checksum.crc32c(_canonical_body(meta)))


def _load_meta(path: str) -> dict:
    """Parse and integrity-check a sidecar. Unparseable JSON or a CRC
    mismatch raises :class:`CorruptCheckpoint`; a sidecar without a
    ``crc32c`` key (written before the stamp existed) loads unchecked."""
    with open(path) as f:
        raw = f.read()
    try:
        meta = json.loads(raw)
    except ValueError as e:
        raise CorruptCheckpoint(path, f"unparseable JSON: {e}") from None
    if not isinstance(meta, dict):
        raise CorruptCheckpoint(
            path, f"top-level {type(meta).__name__}, expected object"
        )
    if "crc32c" in meta:
        got = _checksum.crc32c(_canonical_body(meta))
        if got != meta["crc32c"]:
            raise CorruptCheckpoint(
                path, f"embedded crc32c {meta['crc32c']} != computed {got}"
            )
    return meta


def _write_meta(path: str, meta: dict) -> None:
    """The one sidecar commit path: CRC-stamped, fsynced, atomically
    renamed."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_stamp_crc(meta), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _paths(cfg: JobConfig) -> Tuple[str, str]:
    base = cfg.output_path + ".ckpt"
    return base, base + ".json"


def _fingerprint(cfg: JobConfig) -> dict:
    return {
        "image": os.path.abspath(cfg.image),
        "width": cfg.width,
        "height": cfg.height,
        "channels": cfg.channels,
        "filter": cfg.filter_name,
        "repetitions": cfg.repetitions,
        "frames": cfg.frames,
        "boundary": cfg.boundary,
    }


def _check_meta(meta: dict, cfg: JobConfig, where: str) -> None:
    """Refuse a checkpoint written for a different job. Sidecars without
    a boundary key were all written under zero-boundary semantics."""
    want = _fingerprint(cfg)
    if {k: meta.get(k, "zero" if k == "boundary" else None)
            for k in want} != want:
        raise ValueError(
            f"checkpoint at {where} was written for a different job "
            f"({meta} != {want}); delete it or change --output"
        )


def _checkpoint_fault(index: int) -> None:
    """The ``checkpoint`` injection point, checked at every commit."""
    from tpu_stencil_torch.resilience import faults as _faults

    site = _faults.site("checkpoint")
    if site is not None:
        site(index)


def _frame_shape(cfg: JobConfig) -> tuple:
    shape = (cfg.height, cfg.width)
    if cfg.channels != 1:
        shape += (cfg.channels,)
    return ((cfg.frames,) + shape) if cfg.frames > 1 else shape


def save(cfg: JobConfig, rep: int, frame: np.ndarray) -> None:
    """Atomically persist the frame as the state after ``rep``
    repetitions."""
    _checkpoint_fault(rep)
    data_path, meta_path = _paths(cfg)
    tmp = data_path + ".tmp"
    arr = np.ascontiguousarray(np.asarray(frame, np.uint8))
    native.pwrite_full(tmp, 0, arr.tobytes(), truncate=True)
    fsync_path(tmp)  # the data must be stable before its name is
    os.replace(tmp, data_path)
    _write_meta(meta_path, dict(_fingerprint(cfg), rep=rep))


def _data_file(data_path: str, meta: dict) -> str:
    """The data file a sidecar names: its versioned file (sharded
    format), else the single-file checkpoint."""
    if meta.get("data"):
        return os.path.join(os.path.dirname(data_path) or ".", meta["data"])
    return data_path


def restore(cfg: JobConfig) -> Optional[Tuple[int, np.ndarray]]:
    """Return (completed reps, frame) from a matching checkpoint, or
    None."""
    data_path, meta_path = _paths(cfg)
    if not os.path.exists(meta_path):
        return None
    meta = _load_meta(meta_path)
    _check_meta(meta, cfg, data_path)
    path = _data_file(data_path, meta)
    if not os.path.exists(path):
        return None
    buf = native.pread_full(path, 0, cfg.nbytes)
    return int(meta["rep"]), np.frombuffer(buf, np.uint8).reshape(
        _frame_shape(cfg))


def _stale_versions(data_path: str, before_rep: Optional[int] = None):
    """Versioned data files older than ``before_rep`` (all of them when
    None), selected by their parsed rep number."""
    d = os.path.dirname(data_path) or "."
    prefix = os.path.basename(data_path) + ".r"
    for name in os.listdir(d):
        if not name.startswith(prefix):
            continue
        try:
            r = int(name[len(prefix):])
        except ValueError:
            continue
        if before_rep is None or r < before_rep:
            yield os.path.join(d, name)


def _commit_meta(cfg: JobConfig, rep: int, versioned: str) -> None:
    """Sharded-format commit: after a barrier of every process (each
    writer's data is durable), rank 0 publishes the sidecar naming the
    versioned data file, then sweeps older versions."""
    from tpu_stencil_torch.parallel import distributed

    data_path, meta_path = _paths(cfg)
    distributed.barrier()
    if distributed.process_index() == 0:
        _write_meta(meta_path, dict(_fingerprint(cfg), rep=rep,
                                    data=os.path.basename(versioned)))
        for name in _stale_versions(data_path, before_rep=rep):
            os.remove(name)


def save_sharded(cfg: JobConfig, rep: int, tiles) -> None:
    """Sharded checkpoint of a tile grid: every tile this process holds,
    its in-bounds rectangle, into the versioned data file
    ``<base>.ckpt.r<rep>``, fsynced, then the commit (:func:`_commit_meta`).
    An in-flight write never touches the last committed checkpoint."""
    from tpu_stencil_torch.parallel import distributed

    _checkpoint_fault(rep)
    data_path, _ = _paths(cfg)
    versioned = f"{data_path}.r{rep}"
    distributed.write_sharded(versioned, tiles, cfg.height, cfg.width,
                              cfg.channels)
    fsync_path(versioned)
    _commit_meta(cfg, rep, versioned)


def save_frames_sharded(cfg: JobConfig, rep: int,
                        frames_local: Optional[np.ndarray], f0: int) -> None:
    """``--frames`` checkpoint of several processes: this process's
    contiguous frame range [f0, f0 + n) into the shared versioned data
    file at its offset in the clip's byte layout, fsynced, then the
    commit. A process with no frames passes ``frames_local=None``: it
    writes nothing but must call this every chunk (the commit barrier
    counts every process)."""
    _checkpoint_fault(rep)
    data_path, _ = _paths(cfg)
    versioned = f"{data_path}.r{rep}"
    frame_bytes = cfg.height * cfg.width * cfg.channels
    if frames_local is not None and len(frames_local):
        arr = np.ascontiguousarray(np.asarray(frames_local, np.uint8))
        native.ensure_size(versioned, cfg.frames * frame_bytes)
        native.pwrite_full(versioned, f0 * frame_bytes, arr.tobytes())
        fsync_path(versioned)
    _commit_meta(cfg, rep, versioned)


def restore_frames_sharded(cfg: JobConfig, f0: int, n_local: int
                           ) -> Optional[Tuple[int, np.ndarray]]:
    """(completed reps, this process's frames [f0, f0 + n_local)) from a
    matching checkpoint, or None. Sharded-format data is read by byte
    range (each process touches only its frames); a single-file clip
    checkpoint is read whole and sliced, so progress survives a switch to
    several processes."""
    data_path, meta_path = _paths(cfg)
    if not os.path.exists(meta_path):
        return None
    meta = _load_meta(meta_path)
    _check_meta(meta, cfg, meta_path)
    frame_bytes = cfg.height * cfg.width * cfg.channels
    shape = (n_local,) + _frame_shape(cfg)[1:]
    if meta.get("data"):
        versioned = _data_file(data_path, meta)
        if not os.path.exists(versioned):
            return None
        buf = native.pread_full(versioned, f0 * frame_bytes,
                                n_local * frame_bytes)
        return int(meta["rep"]), np.frombuffer(buf, np.uint8).reshape(shape)
    legacy = restore(cfg)
    if legacy is None:
        return None
    rep, clip = legacy
    return rep, clip[f0:f0 + n_local]


def restore_sharded(cfg: JobConfig, runner) -> Optional[Tuple[int, list]]:
    """Return (completed reps, tile grid on ``runner``'s mesh) from a
    matching checkpoint, or None. A sharded-format checkpoint is read per
    mesh row band (:func:`distributed.read_sharded`); a single-file one
    (written by a run on one device, in either package) is read whole and
    cut into the runner's tiles, so progress survives a change of
    layout."""
    from tpu_stencil_torch.parallel import distributed

    data_path, meta_path = _paths(cfg)
    if not os.path.exists(meta_path):
        return None
    meta = _load_meta(meta_path)
    _check_meta(meta, cfg, meta_path)
    if meta.get("data"):
        versioned = _data_file(data_path, meta)
        if not os.path.exists(versioned):
            return None
        return int(meta["rep"]), distributed.read_sharded(
            versioned, cfg.height, cfg.width, cfg.channels, runner.mesh)
    legacy = restore(cfg)
    if legacy is None:
        return None
    rep, frame = legacy
    return rep, runner.put(frame)


def clear(cfg: JobConfig) -> None:
    """Remove the checkpoint artifacts (after a successful finish). With
    several processes only rank 0 removes them (every writer is done by
    then)."""
    from tpu_stencil_torch.parallel import distributed

    if distributed.process_index() != 0:
        return
    data_path, meta_path = _paths(cfg)
    for p in (data_path, meta_path):
        if os.path.exists(p):
            os.remove(p)
    for p in _stale_versions(data_path):
        os.remove(p)


class MeshCursorMismatch(ValueError):
    """A ``--resume`` of a mesh-composed stream run under a different
    mesh topology than the one that wrote the checkpoint — the fan
    width (``--mesh-frames`` device count), the spatial shard topology
    (``--shard-frames RxC``), or the temporal stage count
    (``--pipe-stages K``). The recorded cursor/scatter/fill layout is
    aligned to the writing run's topology, so silently adopting it
    under another one would misattribute frames to devices (fan),
    mis-scatter tiles (shard) or mis-weave the deal (pipeline); the
    resume must fail typed, naming both topologies (the recorded one
    and the requested one).

    ``recorded``/``requested`` are device counts (ints) for the fan
    guard, descriptive topology strings for the spatial-shard and
    pipeline guards."""

    def __init__(self, recorded, requested, path: str) -> None:
        if isinstance(recorded, str) or isinstance(requested, str):
            super().__init__(
                f"stream checkpoint at {path} records topology "
                f"{recorded} but --resume is running {requested}; "
                f"re-run at the recorded topology (or delete the "
                f"checkpoint to start over)"
            )
        else:
            super().__init__(
                f"stream checkpoint at {path} was written by a "
                f"{recorded}-device mesh-fan run but --resume is running "
                f"on {requested} device(s); re-run with --mesh-frames "
                f"{recorded} (or delete the checkpoint to start over)"
            )
        self.recorded = recorded
        self.requested = requested


def _stream_paths(cfg) -> str:
    """The stream progress sidecar lives beside the sink (the artifact
    it describes), like the frame checkpoints beside the job output.
    Normalized: ``outdir`` and ``outdir/`` are the same sink and must
    resolve to the same sidecar, or a resume spelled the other way
    silently finds no checkpoint."""
    return cfg.output_path.rstrip(os.sep) + ".stream.ckpt.json"


def _stream_fingerprint(cfg) -> dict:
    """Identity of a streaming job (:class:`~tpu_stencil_torch.config
    .StreamConfig`): a progress record from a different geometry,
    filter, rep count or boundary must be refused, not resumed —
    the same discipline as :func:`_fingerprint`. The input spec is
    deliberately EXCLUDED: a resumed pipe has a different fd/path each
    run, and the sink identity (where the sidecar lives) already pins
    the artifact being continued."""
    return {
        "width": cfg.width,
        "height": cfg.height,
        "channels": cfg.channels,
        "filter": cfg.filter_name,
        "repetitions": cfg.repetitions,
        "boundary": cfg.boundary,
        "frames": cfg.frames,
    }


def save_stream_progress(cfg, frames_done: int,
                         mesh_devices: int = 1,
                         cursors: Optional[list] = None,
                         shard_frames: Optional[Tuple[int, int]] = None,
                         pipe_stages: int = 1
                         ) -> None:
    """Atomically record that frames [0, frames_done) are durably in
    the sink. No frame payload — unlike the rep checkpoints, a stream's
    completed frames already live in the output; progress is one
    integer plus the fingerprint.

    Mesh-fan runs (``mesh_devices > 1``) additionally record the device
    count and the per-device frame cursors (the next frame index each
    of the WRITING run's round-robin lanes would have received) —
    ``cursors[d]``, one per device. The in-order drain means
    ``frames_done`` alone pins global progress, and a resume re-deals
    the remaining frames from there (it does not re-adopt the recorded
    cursors — they are the diagnostic record of where the interrupted
    fan stood); what the resume contract enforces is the device count,
    which a different-count resume must refuse
    (:class:`MeshCursorMismatch`).

    Spatially-sharded runs (``--shard-frames``) record the RxC shard
    topology instead — the scatter layout every staged tile of the
    writing run followed. A resume under a different topology (or
    under no topology at all) must refuse typed rather than silently
    mis-scatter, the same contract as the fan's device count.

    Temporal-pipeline runs (``pipe_stages > 1``) record the stage
    count too — the three axes together pin the writing run's full
    placement, and a resume under any different axis value refuses
    typed (the recorded deal/scatter/fill discipline is only
    meaningful at the recorded topology)."""
    _checkpoint_fault(int(frames_done))
    path = _stream_paths(cfg)
    meta = dict(_stream_fingerprint(cfg), frames_done=int(frames_done))
    if mesh_devices > 1:
        meta["mesh_devices"] = int(mesh_devices)
        if cursors is not None:
            meta["device_cursors"] = [int(c) for c in cursors]
    if shard_frames is not None:
        meta["shard_frames"] = [int(d) for d in shard_frames]
    if pipe_stages > 1:
        meta["pipe_stages"] = int(pipe_stages)
    _write_meta(path, meta)


def _topology_str(shard) -> str:
    return "single-device" if shard is None else f"{shard[0]}x{shard[1]}"


def restore_stream_progress(cfg, mesh_devices: int = 1,
                            shard_frames: Optional[Tuple[int, int]] = None,
                            pipe_stages: int = 1
                            ) -> Optional[int]:
    """Frames already completed by a matching prior run, or None. A
    fingerprint mismatch raises (resuming a different job's sink would
    silently mix outputs); a device-count mismatch against a mesh-fan
    checkpoint — or a spatial-shard-topology mismatch against a
    ``--shard-frames`` checkpoint — raises typed
    (:class:`MeshCursorMismatch`: the recorded cursor/scatter layout is
    aligned to the writing run's topology, so a different one must
    never silently adopt it); a sidecar that fails its embedded CRC (or
    no longer parses) raises typed (:class:`CorruptCheckpoint` naming
    the file) — a flipped bit in ``frames_done`` would otherwise
    silently skip or rewrite frames."""
    path = _stream_paths(cfg)
    if not os.path.exists(path):
        return None
    meta = _load_meta(path)
    want = _stream_fingerprint(cfg)
    if {k: meta.get(k) for k in want} != want:
        raise ValueError(
            f"stream checkpoint at {path} was written for a different "
            f"job ({meta} != {want}); delete it or change --output"
        )
    recorded = int(meta.get("mesh_devices", 1))
    if recorded != int(mesh_devices):
        raise MeshCursorMismatch(recorded, int(mesh_devices), path)
    rec_shard = meta.get("shard_frames")
    rec_shard = tuple(int(d) for d in rec_shard) if rec_shard else None
    req_shard = tuple(int(d) for d in shard_frames) if shard_frames else None
    if rec_shard != req_shard:
        raise MeshCursorMismatch(
            f"spatial shard {_topology_str(rec_shard)} (--shard-frames)",
            (f"--shard-frames {_topology_str(req_shard)}"
             if req_shard else "single-device"),
            path,
        )
    rec_pipe = int(meta.get("pipe_stages", 1))
    if rec_pipe != int(pipe_stages):
        # The temporal-axis guard, same contract as the other two.
        raise MeshCursorMismatch(
            f"{rec_pipe} pipeline stage(s) (--pipe-stages)",
            f"--pipe-stages {int(pipe_stages)}",
            path,
        )
    return int(meta["frames_done"])


def clear_stream_progress(cfg) -> None:
    path = _stream_paths(cfg)
    if os.path.exists(path):
        os.remove(path)
