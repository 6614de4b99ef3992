"""Loop-aware census of what a step dispatches, on the meta device: the
counterpart of the JAX package's ``roofline/hlo_census.py``.

The port has no HLO. What a step does on the card is the sequence of
operators it dispatches, so ``Census`` is a ``TorchDispatchMode``: run the
step on meta tensors under it (``launch/dryrun.py``) and every operator is
seen once, with its arguments' and results' shapes and no data. It counts:

  * FLOPs: 2·|result|·K for every matrix product (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, and ``mv``, ``addmv``, ``dot``; ``linear``,
    ``matmul`` and ``einsum`` reach the dispatcher as these), as
    ``torch.profiler``'s ``with_flops`` counts the first four, plus each
    hand-written kernel's reckoned operations (``kernels/meta.py::work``);
  * traffic: 2 × the result bytes of every operator that materialises one
    (write and re-read, the JAX census's heuristic) plus the step's
    argument bytes once (``hold``); views, aliases and allocations without
    a write are skipped, as ``_SKIP_TRAFFIC_OPS`` skips them there; a
    hand-written kernel counts its reckoned bytes (each input read once,
    each output written once);
  * a peak of live tensor bytes: each new storage an operator returns (not
    a view, not an input written in place) is live until it is freed, the
    held arguments all along: the counterpart
    of ``compiled.memory_analysis()``'s ``peak_memory_in_bytes``;
  * collective bytes: the result bytes of every collective
    (``_c10d_functional``'s ``all_reduce``, ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_to_all_single``, ``broadcast`` and
    DTensor's ``shard_dim_alltoall``), by the JAX census's kinds in
    ``per_op_bytes`` and summed in ``collective_bytes``; with the mesh
    given, each call's group is named by the mesh dims it spans
    (``collectives``: kind, dims, group size, calls, bytes; a group of no
    mesh dim by its name); none on one device;
  * launches of the hand-written kernels: each shape-only call of
    ``kernels/meta.py`` is one launch of that kernel.

On a mesh the step runs on DTensors, and every count is per device, of
the local shards: the census answers a DTensor operator with
``NotImplemented``, so DTensor's own dispatch runs it and the operators
it issues on the local tensors, the redistributions' collectives among
them, come back to the census one by one. A matrix product's FLOPs are
therefore those of the local product (a partial sum over a sharded
contraction counts its local K), and the peak is one device's.

A time loop is counted as its body times its trip count, as the JAX census
counts a ``while``: ``Census.loop(name, trips)`` multiplies what is
dispatched inside it and records ``while_trips[name]``. An entered census
registers with ``repro_torch.loops``, whose ``loop`` the models reach
through ``models.layers.meta_scan``: a recurrence's step run once on the
meta device, forward and backward (the ssm and hybrid families' scans over
time).
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from collections import defaultdict

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import loops
from repro_torch import tree as tree_mod
from repro_torch.kernels import meta as meta_kernels

MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
              "aten::mv", "aten::addmv", "aten::dot")
# operators that write nothing, beside the views their schemas name
_SKIP_TRAFFIC_OPS = {"aten::empty", "aten::empty_like", "aten::new_empty",
                     "aten::empty_strided", "aten::new_empty_strided",
                     "aten::_unsafe_view"}
_KERNELS = "repro_torch::"
# collective operators by the JAX census's kinds
COLLECTIVES = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "_c10d_functional::broadcast": "collective-permute",
    "_c10d_functional::broadcast_": "collective-permute",
}


def _matmul_flops(name: str, args, out) -> float:
    """2·|result|·K of a matrix product: K the contracted length."""
    if name in ("aten::mm", "aten::bmm", "aten::mv", "aten::dot"):
        a = args[0]
    else:                                  # addmm, baddbmm, addmv: bias first
        a = args[1]
    return 2.0 * out.numel() * a.shape[-1]


def _product(name: str, args) -> str:
    """A matrix product's name and its factors' shapes (the bias left
    out): what ``flops_by_product`` groups by."""
    a, b = (args[0], args[1]) if name in ("aten::mm", "aten::bmm",
                                          "aten::mv", "aten::dot") \
        else (args[1], args[2])
    return f"{name} {tuple(a.shape)} @ {tuple(b.shape)}"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _nodes(group) -> int:
    """The nodes of ``analysis.NODE_CARDS`` consecutive ranks that a
    process group's ranks lie in."""
    import torch.distributed as tdist
    from repro_torch.roofline.analysis import NODE_CARDS
    ranks = tdist.get_process_group_ranks(group)
    return len({r // NODE_CARDS for r in ranks})


def _in_fake_mode() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


@functools.lru_cache(maxsize=None)
def _aliases(func) -> tuple:
    """(returns a view of an input, returns an input written in place)."""
    infos = [r.alias_info for r in func._schema.returns
             if r.alias_info is not None]
    return (any(not a.is_write for a in infos),
            any(a.is_write for a in infos))


class Census(TorchDispatchMode):
    """Counts what runs under it; ``analyze()`` returns the JAX census's
    keys, plus ``flops_by_op``, ``flops_by_product`` (the matrix products'
    FLOPs by their local factors' shapes: on a mesh, the layout DTensor
    chose), ``kernel_launches`` and ``peak_bytes``."""

    def __init__(self, mesh=None):
        super().__init__()
        # a group's name -> (the mesh dims it spans, its ranks, the nodes
        # of NODE_CARDS consecutive ranks they lie in)
        self._groups = {}
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            for d in range(mesh.ndim):
                group = mesh.get_group(d)
                self._groups[group.group_name] = (
                    (names[d],), mesh.size(d), _nodes(group))
        self.collective_bytes = defaultdict(float)
        self.collectives = {}
        self.flops = 0.0
        self.traffic = 0.0
        self.flops_by_op = defaultdict(float)
        self.flops_by_product = defaultdict(float)
        self.op_counts = defaultdict(float)
        self.kernel_launches = defaultdict(float)
        self.dispatched = 0.0
        self.while_trips = {}
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._scale = 1.0

    def __enter__(self):
        # under a dispatch mode, torch.utils.checkpoint's early stop ends
        # a layer's recompute before its last matrix product, which a run
        # without the mode (the card's) recomputes: off, the census
        # dispatches what the card does
        self._no_early_stop = torch.utils.checkpoint.set_checkpoint_early_stop(
            False)
        self._no_early_stop.__enter__()
        # the models' time loops (``loops.loop``) count here while entered
        self._counting = loops.counting(self)
        self._counting.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._counting.__exit__(*exc)
            self._no_early_stop.__exit__(*exc)

    # -- live bytes ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._storages:
            return
        nbytes = storage.nbytes()
        self._storages[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def hold(self, *trees) -> None:
        """The step's arguments: read once (traffic) and live all along
        (a DTensor's local shard)."""
        for tree in trees:
            for t in tree_mod.leaves(tree):
                if isinstance(t, torch.Tensor):
                    t = getattr(t, "_local_tensor", t)
                    before = len(self._storages)
                    self._track(t)
                    if len(self._storages) > before:
                        self.traffic += t.untyped_storage().nbytes()

    # -- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor and issubclass(t, _dtensor_type())
               for t in types):
            # DTensor runs it; its local operators come back here
            return NotImplemented
        kwargs = kwargs or {}
        if _in_fake_mode():
            # DTensor derives an operator's global shape by running it on
            # fake tensors: no work of the step
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in COLLECTIVES:
            self._collective(COLLECTIVES[name], args, out)
        s = self._scale
        self.op_counts[name] += s
        self.dispatched += s
        if name.startswith(_KERNELS):
            kernel = name[len(_KERNELS):]
            nbytes, ops = meta_kernels.work(kernel, args)
            self.kernel_launches[kernel] += s
            self.flops_by_op[name] += s * ops
            self.flops += s * ops
            self.traffic += s * nbytes
        else:
            if name in MATMUL_OPS:
                f = s * _matmul_flops(name, args, out)
                self.flops_by_op[name] += f
                self.flops_by_product[_product(name, args)] += f
                self.flops += f
            view, in_place = _aliases(func)
            if not (view or name in _SKIP_TRAFFIC_OPS):
                self.traffic += s * 2.0 * sum(
                    t.numel() * t.element_size() for t in _tensors(out))
            if view or in_place:        # no new storage
                return out
        for t in _tensors(out):
            self._track(t)
        return out

    def _collective(self, kind: str, args, out) -> None:
        nbytes = self._scale * sum(t.numel() * t.element_size()
                                   for t in _tensors(out))
        group = next((a for a in reversed(args) if isinstance(a, str)), "")
        dims, size, nodes = self._groups.get(group) or ((group,), None,
                                                        None)
        if size == 1:                   # one rank: nothing moves
            return
        self.collective_bytes[kind] += nbytes
        row = self.collectives.setdefault(
            (kind, dims), {"kind": kind, "dims": list(dims),
                           "group_size": size, "nodes": nodes, "calls": 0.0,
                           "bytes": 0.0})
        row["calls"] += self._scale
        row["bytes"] += nbytes

    @contextlib.contextmanager
    def loop(self, name: str, trips: int):
        """What runs inside counts ``trips`` times (nested loops multiply)."""
        self.while_trips[name] = trips
        outer = self._scale
        self._scale = outer * trips
        try:
            yield
        finally:
            self._scale = outer

    def analyze(self) -> dict:
        return {
            "flops": self.flops,
            "traffic_bytes": self.traffic,
            "collective_bytes": float(sum(self.collective_bytes.values())),
            "per_op_bytes": dict(self.collective_bytes),
            "collectives": list(self.collectives.values()),
            "op_counts": dict(self.op_counts),
            "total_instructions": self.dispatched,
            "while_trips": dict(self.while_trips),
            "flops_by_op": dict(self.flops_by_op),
            "flops_by_product": dict(self.flops_by_product),
            "kernel_launches": dict(self.kernel_launches),
            "peak_bytes": self.peak,
        }
