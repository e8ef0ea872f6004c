"""Integrity of the port: content checksums (its own copy of the CRC32C)
and witness re-execution (:mod:`~tpu_stencil_torch.integrity.witness`)."""
