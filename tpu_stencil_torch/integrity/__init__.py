"""Integrity of the port: content checksums (its own copy of the CRC32C),
witness re-execution (:mod:`~tpu_stencil_torch.integrity.witness`) and
replica quarantine (:mod:`~tpu_stencil_torch.integrity.quarantine`)."""
