"""DTensor helpers shared by the kernels' placement rules
(``kernels/sharded.py``), the step on a mesh (``core/fl_step.py``) and the
population plane (``core/population.py``).

The collectives here are ``torch.distributed._functional_collectives``
calls on local tensors, made where the caller stands (not inside a
DTensor operator's dispatch), so the dry run's census sees each one as the
``_c10d_functional`` operator it is. An all-reduce over several mesh dims
is one all-reduce a dim, as DTensor reduces a 2-D ``Partial``; a mesh dim
of one rank takes none.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch


def is_dtensor(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor (a plain tensor's type is
    checked first, so the kernels' launch path pays one comparison)."""
    for t in ts:
        if type(t) is not torch.Tensor and t is not None:
            from torch.distributed.tensor import DTensor
            if isinstance(t, DTensor):
                return True
    return False


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def all_reduce(t: torch.Tensor, mesh, mesh_dims: Iterable[int],
               op: str = "sum") -> torch.Tensor:
    """The sum (or ``op``: "max") of ``t`` over the ranks of ``mesh_dims``
    (one all-reduce a mesh dim, in order)."""
    funcol = _funcol()
    for d in mesh_dims:
        if mesh.size(d) > 1:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
    return t


class _SumOfReplicas(torch.autograd.Function):
    """The sum over mesh dims of a per-rank part of a value that every
    rank then uses alike: the gradient of each part is the (replicated)
    gradient of the sum, no collective."""

    @staticmethod
    def forward(ctx, t, mesh, mesh_dims):
        return all_reduce(t, mesh, mesh_dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_parts(t: torch.Tensor, mesh, mesh_dims) -> torch.Tensor:
    """``all_reduce`` of ``t``'s parts, differentiable for a sum whose
    every later use is replicated over ``mesh_dims``."""
    return _SumOfReplicas.apply(t, mesh, tuple(mesh_dims))


def all_gather(t: torch.Tensor, mesh, mesh_dim: int,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of mesh dim ``mesh_dim`` concatenated along
    ``dim`` in rank order."""
    if mesh.size(mesh_dim) == 1:
        return t
    funcol = _funcol()
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    return funcol.wait_tensor(gather(t.contiguous(), dim, (mesh, mesh_dim)))


def reduce_scatter(t: torch.Tensor, mesh, mesh_dim: int,
                   dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of mesh dim ``mesh_dim`` summed, this rank's chunk
    of ``dim`` kept (rank order, as ``all_gather`` concatenates)."""
    if mesh.size(mesh_dim) == 1:
        return t
    funcol = _funcol()
    return funcol.wait_tensor(funcol.reduce_scatter_tensor(
        t.contiguous(), "sum", dim % t.dim(), (mesh, mesh_dim)))


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dim; the gradient reduce-scattered back
    (every rank's use of the gathered tensor contributes to its piece)."""

    @staticmethod
    def forward(ctx, t, mesh, mesh_dim):
        ctx.group = (mesh, mesh_dim)
        return all_gather(t, mesh, mesh_dim, dim=t.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        mesh, mesh_dim = ctx.group
        return reduce_scatter(g, mesh, mesh_dim, dim=g.dim() - 1), None, None


def gather_last(t: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """Local ``t`` concatenated along its last dim over the ranks of mesh
    dim ``mesh_dim`` (differentiable; none on a dim of one rank)."""
    if mesh.size(mesh_dim) == 1:
        return t
    return _GatherLast.apply(t, mesh, mesh_dim)


_SPLIT_MESHES: Dict[tuple, object] = {}


def split_dim(mesh, mesh_dim: int, inner: int):
    """``mesh`` with mesh dim ``mesh_dim`` of n ranks split into (n /
    inner, inner): the new last-but-one dims, so that a collective over
    the inner dim runs within each block of ``inner`` consecutive ranks of
    the old dim. Made once a mesh and split (a new mesh creates its
    groups, a collective call of every rank)."""
    names = tuple(mesh.mesh_dim_names)
    key = (names, tuple(mesh.mesh.flatten().tolist()), mesh_dim, inner)
    if key not in _SPLIT_MESHES:
        from torch.distributed.device_mesh import DeviceMesh
        shape = list(mesh.mesh.shape)
        n = shape[mesh_dim]
        shape[mesh_dim:mesh_dim + 1] = [n // inner, inner]
        new = (names[:mesh_dim] + (names[mesh_dim] + "_outer",
                                   names[mesh_dim] + "_inner")
               + names[mesh_dim + 1:])
        _SPLIT_MESHES[key] = DeviceMesh(mesh.device_type,
                                        mesh.mesh.reshape(shape),
                                        mesh_dim_names=new)
    return _SPLIT_MESHES[key]


def split_meshes() -> list:
    """The meshes ``split_dim`` has made (the census names their groups)."""
    return list(_SPLIT_MESHES.values())


def shard_dims(t, tensor_dim: int) -> list:
    """The mesh dims over which DTensor ``t`` shards ``tensor_dim``."""
    return [i for i, p in enumerate(t.placements)
            if p.is_shard() and p.dim % t.dim() == tensor_dim % t.dim()]


def placements(mesh, shards: Dict[int, int]) -> tuple:
    """One placement a mesh dim: ``Shard(shards[d])`` for the mesh dims in
    ``shards``, ``Replicate()`` for the rest."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(shards[d]) if d in shards else Replicate()
                 for d in range(mesh.ndim))


def require(t, mesh, shards: Dict[int, int]):
    """DTensor (or plain, replicated) ``t`` laid out as ``placements(mesh,
    shards)``: what DTensor's ``redistribute`` must move to get there (an
    all-gather for a dim sharded elsewhere, an all-reduce for a partial
    sum; a replicated dim is split without one)."""
    from torch.distributed.tensor import DTensor
    want = placements(mesh, shards)
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, placements(mesh, {}),
                               run_check=False)
    if tuple(t.placements) == want:
        return t
    return t.redistribute(mesh, want)


def keep_shards(t, allowed: Sequence[int]):
    """DTensor ``t`` with every mesh dim that shards a tensor dim outside
    ``allowed`` (or holds a partial sum) replicated."""
    keep = {i: p.dim % t.dim() for i, p in enumerate(t.placements)
            if p.is_shard() and p.dim % t.dim() in
            [a % t.dim() for a in allowed]}
    return require(t, t.device_mesh, keep)


def local_offset(length: int, mesh, mesh_dims: Sequence[int]) -> tuple:
    """(offset, local length) of this rank's slice of a dim of ``length``
    sharded over ``mesh_dims`` in order, chunked as ``torch.chunk`` does
    (DTensor's ``Shard``)."""
    offset = 0
    for d in mesh_dims:
        n, r = mesh.size(d), mesh.get_local_rank(d)
        per = -(-length // n)
        start = min(r * per, length)
        offset += start
        length = max(0, min(per, length - start))
    return offset, length


def from_local(local: torch.Tensor, mesh, shards: Dict[int, int],
               shape) -> torch.Tensor:
    """A DTensor of global ``shape`` from this rank's ``local`` piece,
    ``Shard(shards[d])`` over mesh dim d and replicated elsewhere."""
    return wrap(local, mesh, placements(mesh, shards), shape)


def wrap(local: torch.Tensor, mesh, placement, shape) -> torch.Tensor:
    """A contiguous DTensor of global ``shape`` from this rank's ``local``
    piece laid out by ``placement`` (differentiable, no collective)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(int(s) for s in shape)
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return DTensor.from_local(local, mesh, tuple(placement),
                              run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))
