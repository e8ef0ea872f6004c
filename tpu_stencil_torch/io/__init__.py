"""Raw-image I/O (headerless .raw) and standard image formats."""

from tpu_stencil_torch.io.raw import read_raw, read_raw_rows, write_raw

__all__ = ["read_raw", "read_raw_rows", "write_raw"]
