"""A 1-D mesh of shards and its two collectives (the counterpart of what
``jax.sharding.Mesh``, ``ppermute`` and ``psum`` give the JAX package's
parallel modules).

A mesh cuts one axis ("knots" or "arms") into ``size`` equal shards and
holds them in one of two ways:

* in-process: every shard in this process, on one device -- the
  counterpart of the JAX tests' virtual 8-device CPU mesh; it is how one
  card runs an 8-shard program;
* over a ``torch.distributed`` process group that the caller has
  initialized: one shard per rank (NCCL with one GPU per rank, gloo on the
  CPU or with CUDA tensors).

Shard bodies are written for all shards at once: lists of the local shard
tensors, a list of one in a rank.  So both forms run the same code, and no
shard waits in a collective that another shard of its process has not
reached.  Both collectives go through ``all_reduce`` alone, over buffers in
which each rank fills its own slots and leaves the others zero (gloo takes
CUDA tensors in ``all_reduce`` but not in ``all_gather`` or ``send``, and
NCCL cannot put two ranks on one GPU):

* ``halos``: each shard's neighbours' edge rows, zero at the global edges;
  ``outer_halos`` only the two rows outside the local shards, which need
  no collective in-process (zeros there: the local shards are the whole
  axis);
* ``psum``: the sum of per-shard partials, taken by every shard from the
  same (size,) vector of slots, so the in-process and the distributed form
  give the same bits (the rule of the cluster CG's rank-ordered dot
  partials, ``csrc/pcg_common.cuh``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist


@functools.lru_cache(maxsize=None)
def _zero_row(device: torch.device, s: int, dtype) -> torch.Tensor:
    """A zero row of s entries on device, made once: the halo rows at the
    global edges, read and never written."""
    return torch.zeros(s, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``size`` shards of one axis; ``local`` are the shard indices this
    process holds; ``group`` is None in-process, else the process group
    (one shard per rank)."""

    axis: str
    size: int
    local: tuple
    device: torch.device
    group: object = None

    @staticmethod
    def in_process(size: int, device, axis: str) -> "Mesh":
        if size < 1:
            raise ValueError(f"a mesh needs at least one shard, got {size}")
        return Mesh(axis, int(size), tuple(range(size)), torch.device(device))

    @staticmethod
    def distributed(axis: str, device="cuda", group=None) -> "Mesh":
        """One shard per rank of group (the default group if None), which
        the caller has initialized; a CUDA device without an index is the
        current CUDA device."""
        if not dist.is_initialized():
            raise RuntimeError("a distributed mesh needs an initialized "
                               "torch.distributed process group")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        group = group if group is not None else dist.group.WORLD
        return Mesh(axis, dist.get_world_size(group),
                    (dist.get_rank(group),), device, group)

    def _all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            dist.all_reduce(buf, group=self.group)
        return buf

    def shard(self, t: torch.Tensor) -> list:
        """The local shards of t's leading axis (contiguous views)."""
        n = t.shape[0]
        if n % self.size:
            raise ValueError(f"a leading axis of {n} does not divide into "
                             f"{self.size} shards")
        nl = n // self.size
        return [t[i * nl:(i + 1) * nl] for i in self.local]

    def gather(self, shards: list) -> torch.Tensor:
        """The whole axis from every shard's rows (on every rank)."""
        if self.group is None:
            return torch.cat(shards)
        nl, dtype = shards[0].shape[0], shards[0].dtype
        # all_reduce sums no bools: carry them as int32
        wire = torch.int32 if dtype == torch.bool else dtype
        buf = shards[0].new_zeros((self.size * nl,) + shards[0].shape[1:],
                                  dtype=wire)
        for i, t in zip(self.local, shards):
            buf[i * nl:(i + 1) * nl] = t
        return self._all_reduce(buf).to(dtype)

    def halos(self, xs: list) -> tuple:
        """(left, right) lists: each local shard's x_{-1}, the previous
        shard's last row, and x_{nl}, the next shard's first row, zero at
        the global edges; xs are (nl, s) shards."""
        ends = torch.stack([x[0] for x in xs] + [x[-1] for x in xs])
        ends = ends.view(2, len(xs), -1)         # (first | last, shard, s)
        if self.group is not None:
            buf = ends.new_zeros((2, self.size, ends.shape[-1]))
            buf[:, self.local[0]] = ends[:, 0]
            ends = self._all_reduce(buf)
        zero = ends.new_zeros(ends.shape[-1])
        left = [ends[1, i - 1] if i > 0 else zero for i in self.local]
        right = [ends[0, i + 1] if i < self.size - 1 else zero
                 for i in self.local]
        return left, right

    def outer_halos(self, xs: list) -> tuple:
        """(x_{-1} of the first local shard, x_{nl} of the last): the rows
        outside the local shards, zero at the global edges.  In-process the
        local shards are the whole axis, so both are zeros and nothing is
        launched; over a group, halos' all_reduce."""
        if self.group is None:
            zero = _zero_row(xs[0].device, xs[0].shape[-1], xs[0].dtype)
            return zero, zero
        left, right = self.halos(xs)
        return left[0], right[-1]

    def psum(self, parts: list) -> torch.Tensor:
        """The sum over every shard of the 0-d per-shard partials, the same
        bits on every shard and in both forms."""
        slots = torch.stack(parts)
        if self.group is not None:
            buf = slots.new_zeros(self.size)
            buf[self.local[0]] = slots[0]
            slots = self._all_reduce(buf)
        return slots.sum()
