"""Device meshes: the JAX package's ``launch/mesh.py`` as
``torch.distributed`` ``DeviceMesh``es with the same axis names.

Functions, never module-level meshes: importing this module starts no
process group. The caller that asks for a mesh starts one first: the dry
run starts a fake world (``start_fake_world``, the counterpart of the JAX
dry run's forced 512 host devices), a test's subprocess or
``chip_smoke.py`` a real one (``start_world``: gloo on the CPU, NCCL on the
card, with a ``file://`` rendezvous, so no network is used).

A mesh's device type follows the default group's backend: ``"cuda"`` under
NCCL, ``"cpu"`` otherwise (gloo, and the fake world, whose tensors are on
the meta device and whose collectives move nothing). DTensor runs a
reshard between two dims on one mesh axis of a ``"cpu"`` mesh as an
all-gather and a chunk, since gloo has no all-to-all; the dry run's census
counts it as the all-gather it is.

The TPU's peak constants of the JAX module are not carried over; the
H100's are in ``roofline/analysis.py``. ``DeviceMesh.shape`` is a tuple,
so ``axis_size(mesh, name)`` stands for JAX's ``mesh.shape[name]``: 1 for
an axis the mesh does not have, as the JAX sharding rules' ``_axis_size``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


# --------------------------------------------------------------------------
# worlds
# --------------------------------------------------------------------------

def start_fake_world(n: int) -> None:
    """A process group of ``n`` ranks in this one process, on torch's
    ``"fake"`` backend (this process is rank 0; every collective returns at
    once and moves no data): the dry run's world, where every tensor lies
    on the meta device. The backend and its store live in
    ``torch.testing._internal.distributed.fake_pg``, a torch-internal
    module (present in torch 2.11 and 2.13). Refuses when a process group
    is already up: a fake world beside a real one would answer the real
    one's collectives with nothing."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group ({dist.get_backend()}, world "
            f"{dist.get_world_size()}) is already up; the fake world of "
            f"{n} ranks starts only in a process without one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))


def start_world(backend: str, rank: int, world_size: int,
                init_file: str) -> None:
    """A real process group (``"gloo"`` or ``"nccl"``) of ``world_size``
    ranks meeting through ``init_file`` (a ``file://`` rendezvous: no
    network). Under NCCL rank r uses card r."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=int(rank), world_size=int(world_size))


def world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one first "
                           "(start_world, or start_fake_world for a dry run)")
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes) -> DeviceMesh:
    """The first prod(shape) ranks of the world as a mesh."""
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------

def fold_mesh_shape(n: int, *, multi_pod: bool = False) -> tuple:
    """Fold ``n`` devices into the largest valid mesh shape.

    "model" takes the largest power-of-two divisor of ``n`` up to the
    canonical 16 (tensor parallelism wants a power of two; anything
    wider than 16 splits head dims); "data" absorbs the rest. multi_pod
    peels a leading pod=2, so it needs an even device count.
    """
    n = int(n)
    if n < 1:
        raise RuntimeError(f"cannot build a mesh from {n} devices")
    shape = ()
    if multi_pod:
        if n % 2:
            raise RuntimeError(
                f"multi_pod mesh needs an even device count, have {n} "
                f"devices — drop multi_pod or launch via "
                f"repro_torch.launch.dryrun (a fake world of 512 ranks)")
        shape, n = (2,), n // 2
        if n < 1:
            raise RuntimeError(
                "multi_pod mesh needs >= 2 devices, have 2·0")
    model = 1
    while model * 2 <= min(16, n) and n % (model * 2) == 0:
        model *= 2
    return shape + (n // model, model)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 × 16 ("data", "model"), or 2 × 16 × 16 ("pod", "data", "model"),
    over the first ranks of the world; a smaller world is folded
    (``fold_mesh_shape``)."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n, have = math.prod(shape), world_size()
    if have >= n:
        return _mesh(shape, axes)
    return _mesh(fold_mesh_shape(have, multi_pod=multi_pod), axes)


def make_population_mesh(world: int = None) -> DeviceMesh:
    """1-D population mesh: every rank (or the first ``world``) on the
    "data" axis, "model" of size 1. The population plane has no model axis
    to fill, so any rank count is a valid shape."""
    n = world_size() if world is None else int(world)
    return _mesh((n, 1), ("data", "model"))


def make_debug_mesh(shape=(1, 1), axes=("data", "model")) -> DeviceMesh:
    """A mesh of the first ``prod(shape)`` ranks (one, by default) for
    smoke tests of the sharded code path."""
    return _mesh(tuple(shape), tuple(axes))


class AbstractMesh:
    """A mesh's axis names and sizes without ranks: what the sharding
    rules read (the counterpart of ``jax.sharding.AbstractMesh``), so a
    spec can be asked for without a process group."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"{len(shape)} sizes for axes {axes}")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``; 1 when the mesh has no such axis."""
    names = axis_names(mesh)
    return int(mesh.shape[names.index(name)]) if name in names else 1


def topology_pspec(mesh, min_pods: int = None):
    """Spec for a topology accumulator plane ``(pods, rows, lane)``: the
    leading pod axis over "data" when the plane is tall enough to split
    evenly-ish (``min_pods`` defaults to the data-axis size), replicated
    otherwise."""
    from repro_torch.launch.sharding import P
    if "data" not in axis_names(mesh):
        return P()
    if min_pods is not None and min_pods < axis_size(mesh, "data"):
        return P()
    return P("data")


def client_axes_in_mesh(cfg, mesh) -> tuple:
    """The subset of cfg.client_axes present in this mesh."""
    return tuple(a for a in cfg.client_axes if a in axis_names(mesh))


def num_clients(cfg, mesh) -> int:
    n = 1
    for a in client_axes_in_mesh(cfg, mesh):
        n *= axis_size(mesh, a)
    return max(n, 1)
