"""Distributed bundle adjustment over `torch.distributed` (port of
`multicol_slam_tpu/parallel/`): `ba` (the row-sharded and point-sharded
layouts) and `distributed` (the process group, the mesh, the multi-process
solve and the large-map problem)."""
