"""Spatial sharding: the grid factorization, the mesh of devices, the halo
exchange between tiles, and the sharded runner that drives the valid-ghost
kernel (K3) or the torch-ops step per tile."""
