"""Content checksums of the port (its own copy of the CRC32C)."""
