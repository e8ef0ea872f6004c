"""Spatial sharding: the grid factorization, the mesh of devices, the halo
exchange between tiles, the interior/border overlap schedules, and the
sharded runner that drives the valid-ghost kernel (K3) or the torch-ops
step per tile."""
