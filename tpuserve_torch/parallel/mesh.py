"""Rank mesh for sharded serving (PyTorch port of tpuserve/parallel/mesh.py).

In PyTorch every rank is a process with its own piece of every sharded
tensor, so a mesh here is a rank's view of the ranks around it: its
coordinates and one process group per axis. The axes are the JAX package's
("dp", "pp", "sp", "tp") in its order, tp minor, dp outermost: rank r of a
tp x dp x sp mesh (pp = 1) has coordinates

    dp = r // (sp * tp),  sp = (r // tp) % sp,  tp = r % tp,

which is the device a JAX mesh of the same sizes puts at those coordinates
(`make_mesh` reshapes the device list to (dp, sp, tp)). A pipeline mesh
(`make_pipeline_mesh`) puts "pp" between dp and the minor axis, as the JAX
package's ("pp",), ("pp", "tp"), ("dp", "pp"[, "tp"]) and ([dp,] "pp",
"sp") meshes do (sp and tp never both exceed 1 there). An axis group holds
the ranks that differ only along that axis, in index order.

Collectives along an axis (`psum`, `pmax`, `gather`, `ppermute`) run
through torch.distributed on the axis's group. `gather` is an all_reduce of
a zero-padded buffer, so it needs only what gloo offers for CUDA tensors
(`broadcast` and `all_reduce`): float tensors cross as the integer view of
their f32 bits, so the gather is exact. `ppermute` (the pipeline's rotation
i -> i+1 mod pp) is built the same way, one exact all_reduce, except where
NCCL runs the group (every rank on a card of its own): there it is one
send and one receive a rank. `psum` sums in f32 and casts back.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import torch

AXES = ("dp", "pp", "sp", "tp")


def rank_coords(rank: int, tp: int = 1, dp: int = 1, sp: int = 1,
                pp: int = 1) -> Dict[str, int]:
    """The mesh coordinates of `rank` (tp minor, then sp, pp, dp outermost)."""
    n = tp * dp * sp * pp
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n} ranks")
    return {"dp": rank // (pp * sp * tp), "pp": (rank // (sp * tp)) % pp,
            "sp": (rank // tp) % sp, "tp": rank % tp}


def coords_rank(coords: Dict[str, int], tp: int = 1, dp: int = 1, sp: int = 1,
                pp: int = 1) -> int:
    del dp
    return ((coords["dp"] * pp + coords.get("pp", 0)) * sp + coords["sp"]) * tp + coords["tp"]


def axis_groups(axis: str, tp: int = 1, dp: int = 1, sp: int = 1,
                pp: int = 1) -> List[Tuple[int, ...]]:
    """Every group of `axis`: the ranks that differ only along it, each group
    in index order, the groups in rank order of their first member."""
    sizes = {"dp": dp, "pp": pp, "sp": sp, "tp": tp}
    if axis not in sizes:
        raise ValueError(f"unknown mesh axis {axis!r}")
    others = [a for a in AXES if a != axis]
    groups = []
    for fixed in itertools.product(*(range(sizes[a]) for a in others)):
        base = dict(zip(others, fixed))
        groups.append(tuple(coords_rank(dict(base, **{axis: i}), tp, dp, sp, pp)
                            for i in range(sizes[axis])))
    return sorted(groups)


class DistComm:
    """Collectives through torch.distributed, one process group per axis
    group (built by `make_mesh`; every rank builds all of them, in one
    order, as new_group requires). `p2p` when the groups run on NCCL, whose
    send/recv `ppermute` takes; gloo's on CUDA tensors is not usable."""

    def __init__(self, groups: Dict[Tuple[int, ...], object], p2p: bool = False):
        self.groups = groups
        self.p2p = p2p

    def all_reduce(self, t: torch.Tensor, op: str, ranks: Tuple[int, ...]) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.groups[ranks])
        return t

    def ppermute(self, t: torch.Tensor, ranks: Tuple[int, ...]) -> torch.Tensor:
        """Member i's t arrives at member i+1 (mod n); returns what this rank
        received."""
        import torch.distributed as dist

        me = ranks.index(dist.get_rank())
        out = torch.empty_like(t)
        group = self.groups[ranks]
        ops = [dist.P2POp(dist.isend, t, ranks[(me + 1) % len(ranks)], group),
               dist.P2POp(dist.irecv, out, ranks[(me - 1) % len(ranks)], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def destroy(self) -> None:
        import torch.distributed as dist

        for g in self.groups.values():
            try:
                dist.destroy_process_group(g)
            except Exception:  # already torn down with the default group
                pass
        self.groups = {}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """x as integers that an all_reduce sum carries exactly (f32 bits for a
    float tensor)."""
    if x.dtype.is_floating_point:
        return x.to(torch.float32).contiguous().view(torch.int32)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def _from_bits(buf: torch.Tensor, dtype) -> torch.Tensor:
    if dtype.is_floating_point:
        buf = buf.view(torch.float32)
    return buf.to(dtype)


class Mesh:
    """One rank's view of a tp x dp x sp (x pp) mesh; `comm` runs its
    collectives (`DistComm` across processes; the tests give an in-process
    one)."""

    def __init__(self, tp: int, dp: int, sp: int, rank: int, comm=None,
                 backend: str = "none", pp: int = 1):
        self.tp, self.dp, self.sp, self.pp = int(tp), int(dp), int(sp), int(pp)
        self.rank = int(rank)
        self.coords = rank_coords(self.rank, self.tp, self.dp, self.sp, self.pp)
        self.comm = comm
        self.backend = backend

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "sp": self.sp, "tp": self.tp}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """As the JAX mesh names its axes: "sp" only when sp > 1; a pipeline
        mesh as make_pipeline_mesh names it."""
        if self.pp > 1:
            if self.sp > 1:
                return (("dp",) if self.dp > 1 else ()) + ("pp", "sp")
            if self.dp > 1:
                return ("dp", "pp") + (("tp",) if self.tp > 1 else ())
            return ("pp", "tp") if self.tp > 1 else ("pp",)
        return ("dp", "sp", "tp") if self.sp > 1 else ("dp", "tp")

    @property
    def size(self) -> int:
        return self.tp * self.dp * self.sp * self.pp

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        return tuple(coords_rank(dict(self.coords, **{axis: i}), self.tp, self.dp, self.sp,
                                 self.pp)
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
        bits = _bits(x)
        buf = torch.zeros((n,) + tuple(bits.shape), dtype=bits.dtype, device=bits.device)
        buf[self.coords[axis]] = bits
        buf = _from_bits(self._reduce(buf, "sum", axis), x.dtype)
        return torch.cat(list(buf.unbind(0)), dim=dim if dim >= 0 else bits.dim() + dim)

    def ppermute(self, x: torch.Tensor, axis: str = "pp") -> torch.Tensor:
        """The rotation i -> i+1 (mod n) over the axis, as the JAX
        package's ppermute with pairs [(i, (i + 1) % n)]: returns the piece
        of the axis's previous member, bit for bit. Every member of the
        group must call it. One send and one receive where the comm offers
        them (NCCL), else one all_reduce of a zero-padded buffer holding
        each member's bits at its own index."""
        n = self.shape[axis]
        if n == 1:
            return x
        if getattr(self.comm, "p2p", False):
            return self.comm.ppermute(x.contiguous(), self.axis_ranks(axis))
        bits = _bits(x)
        buf = torch.zeros((n,) + tuple(bits.shape), dtype=bits.dtype, device=bits.device)
        i = self.coords[axis]
        buf[i] = bits
        buf = self._reduce(buf, "sum", axis)
        return _from_bits(buf[(i - 1) % n], x.dtype)


def _build_mesh(tp: int, dp: int, sp: int, pp: int, rank, comm, backend) -> Mesh:
    n = tp * dp * sp * pp
    if comm is not None:
        return Mesh(tp, dp, sp, 0 if rank is None else rank, comm, backend or "none", pp=pp)
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        what = f"dp={dp} sp={sp} tp={tp}" + (f" pp={pp}" if pp > 1 else "")
        raise ValueError(f"need {n} ranks for {what}, have {world}")
    if n == 1:
        return Mesh(1, 1, 1, 0, None, "none")
    from tpuserve_torch.parallel.distributed import timeout

    groups = {}
    for axis in AXES:
        for ranks in axis_groups(axis, tp, dp, sp, pp):
            if len(ranks) > 1:
                groups[ranks] = dist.new_group(list(ranks), timeout=timeout())
    be = backend or dist.get_backend()
    return Mesh(tp, dp, sp, dist.get_rank(), DistComm(groups, p2p=be == "nccl"), be, pp=pp)


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, *, rank: Optional[int] = None,
              comm=None, backend: Optional[str] = None) -> Mesh:
    """This rank's mesh. With no `comm`, the torch.distributed default group
    must hold exactly tp * dp * sp ranks (the JAX make_mesh's "need N
    devices" error otherwise), and every rank of it must call make_mesh
    with the same sizes: the axis groups are built collectively."""
    if min(tp, dp, sp) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got dp={dp} sp={sp} tp={tp}")
    return _build_mesh(tp, dp, sp, 1, rank, comm, backend)


def make_pipeline_mesh(pp: int, tp: int = 1, dp: int = 1, sp: int = 1, *,
                       rank: Optional[int] = None, comm=None,
                       backend: Optional[str] = None) -> Mesh:
    """This rank's pipeline mesh (the JAX make_pipeline_mesh): layers stage
    over "pp", each stage's weights and heads over "tp", whole pipeline
    replicas over "dp", each stage's KV length over "sp". Ranks sit at the
    JAX package's device order of ("pp",), ("pp", "tp"), ("dp", "pp"[,
    "tp"]) or ([dp,] "pp", "sp"). sp x tp is refused, as there."""
    if sp > 1 and tp > 1:
        raise ValueError("pipeline sp x tp is not composed yet (v1)")
    if min(pp, tp, dp, sp) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got pp={pp} dp={dp} sp={sp} tp={tp}")
    return _build_mesh(tp, dp, sp, pp, rank, comm, backend)


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device a rank runs on: its own card where there are enough,
    cuda:(rank % count) otherwise (ranks then share a card); the CPU for
    "cpu"."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))

