"""Rank mesh for sharded serving (PyTorch port of tpuserve/parallel/mesh.py).

In PyTorch every rank is a process with its own piece of every sharded
tensor, so a mesh here is a rank's view of the ranks around it: its
coordinates and one process group per axis. The axes are the JAX package's
("dp", "sp", "tp") in its order, tp minor, sp between, dp outermost: rank r
of a tp x dp x sp mesh has coordinates

    dp = r // (sp * tp),  sp = (r // tp) % sp,  tp = r % tp,

which is the device a JAX mesh of the same sizes puts at those coordinates
(`make_mesh` reshapes the device list to (dp, sp, tp)). An axis group holds
the ranks that differ only along that axis, in index order.

Collectives along an axis (`psum`, `pmax`, `gather`) run through
torch.distributed on the axis's group. `gather` is an all_reduce of a
zero-padded buffer, so it needs only what gloo offers for CUDA tensors
(`broadcast` and `all_reduce`): float tensors cross as the integer view of
their f32 bits, so the gather is exact. `psum` sums in f32 and casts back.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import torch

AXES = ("dp", "sp", "tp")


def rank_coords(rank: int, tp: int = 1, dp: int = 1, sp: int = 1) -> Dict[str, int]:
    """The mesh coordinates of `rank` (tp minor, then sp, dp outermost)."""
    n = tp * dp * sp
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n} ranks")
    return {"dp": rank // (sp * tp), "sp": (rank // tp) % sp, "tp": rank % tp}


def coords_rank(coords: Dict[str, int], tp: int = 1, dp: int = 1, sp: int = 1) -> int:
    del dp
    return (coords["dp"] * sp + coords["sp"]) * tp + coords["tp"]


def axis_groups(axis: str, tp: int = 1, dp: int = 1, sp: int = 1) -> List[Tuple[int, ...]]:
    """Every group of `axis`: the ranks that differ only along it, each group
    in index order, the groups in rank order of their first member."""
    sizes = {"dp": dp, "sp": sp, "tp": tp}
    if axis not in sizes:
        raise ValueError(f"unknown mesh axis {axis!r}")
    others = [a for a in AXES if a != axis]
    groups = []
    for fixed in itertools.product(*(range(sizes[a]) for a in others)):
        base = dict(zip(others, fixed))
        groups.append(tuple(coords_rank(dict(base, **{axis: i}), tp, dp, sp)
                            for i in range(sizes[axis])))
    return sorted(groups)


class DistComm:
    """Collectives through torch.distributed, one process group per axis
    group (built by `make_mesh`; every rank builds all of them, in one
    order, as new_group requires)."""

    def __init__(self, groups: Dict[Tuple[int, ...], object]):
        self.groups = groups

    def all_reduce(self, t: torch.Tensor, op: str, ranks: Tuple[int, ...]) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.groups[ranks])
        return t

    def destroy(self) -> None:
        import torch.distributed as dist

        for g in self.groups.values():
            try:
                dist.destroy_process_group(g)
            except Exception:  # already torn down with the default group
                pass
        self.groups = {}


class Mesh:
    """One rank's view of a tp x dp x sp mesh; `comm` runs its collectives
    (`DistComm` across processes; the tests give an in-process one)."""

    def __init__(self, tp: int, dp: int, sp: int, rank: int, comm=None,
                 backend: str = "none"):
        self.tp, self.dp, self.sp = int(tp), int(dp), int(sp)
        self.rank = int(rank)
        self.coords = rank_coords(self.rank, self.tp, self.dp, self.sp)
        self.comm = comm
        self.backend = backend

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """As the JAX mesh names its axes: "sp" only when sp > 1."""
        return AXES if self.sp > 1 else ("dp", "tp")

    @property
    def size(self) -> int:
        return self.tp * self.dp * self.sp

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        return tuple(coords_rank(dict(self.coords, **{axis: i}), self.tp, self.dp, self.sp)
                     for i in range(self.shape[axis]))

    def _reduce(self, t: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        return self.comm.all_reduce(t.contiguous(), op, self.axis_ranks(axis))

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over the axis, in f32 (cast back to x's dtype)."""
        if self.shape[axis] == 1:
            return x
        return self._reduce(x.to(torch.float32).clone(), "sum", axis).to(x.dtype)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.shape[axis] == 1:
            return x
        return self._reduce(x.to(torch.float32).clone(), "max", axis).to(x.dtype)

    def gather(self, x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
        """The axis's pieces of x concatenated along `dim` in index order,
        bit for bit (an all_reduce of a zero-padded buffer)."""
        n = self.shape[axis]
        if n == 1:
            return x
        dtype = x.dtype
        if dtype.is_floating_point:
            bits = x.to(torch.float32).contiguous().view(torch.int32)
        elif dtype == torch.bool:
            bits = x.to(torch.uint8)
        else:
            bits = x
        buf = torch.zeros((n,) + tuple(bits.shape), dtype=bits.dtype, device=bits.device)
        buf[self.coords[axis]] = bits
        buf = self._reduce(buf, "sum", axis)
        if dtype.is_floating_point:
            buf = buf.view(torch.float32)
        out = torch.cat(list(buf.unbind(0)), dim=dim if dim >= 0 else bits.dim() + dim)
        return out.to(dtype)


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, *, rank: Optional[int] = None,
              comm=None, backend: Optional[str] = None) -> Mesh:
    """This rank's mesh. With no `comm`, the torch.distributed default group
    must hold exactly tp * dp * sp ranks (the JAX make_mesh's "need N
    devices" error otherwise), and every rank of it must call make_mesh
    with the same sizes: the axis groups are built collectively."""
    n = tp * dp * sp
    if min(tp, dp, sp) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got dp={dp} sp={sp} tp={tp}")
    if comm is not None:
        return Mesh(tp, dp, sp, 0 if rank is None else rank, comm, backend or "none")
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"need {n} ranks for dp={dp} sp={sp} tp={tp}, have {world}")
    if n == 1:
        return Mesh(1, 1, 1, 0, None, "none")
    from tpuserve_torch.parallel.distributed import timeout

    groups = {}
    for axis in AXES:
        for ranks in axis_groups(axis, tp, dp, sp):
            if len(ranks) > 1:
                groups[ranks] = dist.new_group(list(ranks), timeout=timeout())
    be = backend or dist.get_backend()
    return Mesh(tp, dp, sp, dist.get_rank(), DistComm(groups), be)


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device a rank runs on: its own card where there are enough,
    cuda:(rank % count) otherwise (ranks then share a card); the CPU for
    "cpu"."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))

