"""Horizon and arm sharding (counterpart of mpcgpu_tpu/parallel).

``mesh`` holds a 1-D mesh of shards, in this process or over a
``torch.distributed`` group, and its two collectives; ``pcg_sharded`` the
CG with the knot axis sharded and the plain per-shard SpMV;
``pcg_sharded_cuda`` the same CG with the SpMV as the kernel K11;
``sharded`` the entry points (the SQP solve and the closed loops over a
mesh).
"""
