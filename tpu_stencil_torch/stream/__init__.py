"""The streaming engine: a stream of frames through read -> H2D -> compute
-> D2H -> write.

The port's counterpart of the JAX package's ``stream`` package: instead
of one image per invocation (``run_job``), a frame stream flows through a
pipeline with ``pipeline_depth`` frames in flight, so host I/O, the copies
over the host link and the kernels overlap and throughput is bound by the
slowest stage. Three pieces:

* :mod:`~tpu_stencil_torch.stream.frames`: sources and sinks over
  concatenated headerless ``.raw`` streams (files, FIFOs, stdin/stdout),
  sorted frame directories, and a null sink.
* :mod:`~tpu_stencil_torch.stream.engine`: the pinned host ring, the copy,
  compute and D2H streams with their events, the in-order writer, resume
  and engine restarts.
* :mod:`~tpu_stencil_torch.stream.cli`: ``python -m tpu_stencil_torch
  stream``.

>>> from tpu_stencil_torch.config import ImageType, StreamConfig
>>> from tpu_stencil_torch.stream import run_stream
>>> cfg = StreamConfig("clip.raw", 640, 480, 10, ImageType.RGB,
...                    output="null", frames=None)
>>> result = run_stream(cfg)
"""

from tpu_stencil_torch.stream.engine import (StreamFailure, StreamResult,
                                             run_stream)
from tpu_stencil_torch.stream.frames import (
    FrameSink,
    FrameSource,
    NullSink,
    RawDirectorySink,
    RawDirectorySource,
    RawStreamSink,
    RawStreamSource,
    open_sink,
    open_source,
)

__all__ = [
    "FrameSink",
    "FrameSource",
    "NullSink",
    "RawDirectorySink",
    "RawDirectorySource",
    "RawStreamSink",
    "RawStreamSource",
    "StreamFailure",
    "StreamResult",
    "open_sink",
    "open_source",
    "run_stream",
]
