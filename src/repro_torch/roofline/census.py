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
  * collective bytes: none on one device (the mesh half of ROADMAP item
    14g fills them in);
  * launches of the hand-written kernels: each shape-only call of
    ``kernels/meta.py`` is one launch of that kernel.

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


def _matmul_flops(name: str, args, out) -> float:
    """2·|result|·K of a matrix product: K the contracted length."""
    if name in ("aten::mm", "aten::bmm", "aten::mv", "aten::dot"):
        a = args[0]
    else:                                  # addmm, baddbmm, addmv: bias first
        a = args[1]
    return 2.0 * out.numel() * a.shape[-1]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _aliases(func) -> tuple:
    """(returns a view of an input, returns an input written in place)."""
    infos = [r.alias_info for r in func._schema.returns
             if r.alias_info is not None]
    return (any(not a.is_write for a in infos),
            any(a.is_write for a in infos))


class Census(TorchDispatchMode):
    """Counts what runs under it; ``analyze()`` returns the JAX census's
    keys, plus ``flops_by_op``, ``kernel_launches`` and ``peak_bytes``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.flops_by_op = defaultdict(float)
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
        """The step's arguments: read once (traffic) and live all along."""
        for tree in trees:
            for t in tree_mod.leaves(tree):
                if isinstance(t, torch.Tensor):
                    before = len(self._storages)
                    self._track(t)
                    if len(self._storages) > before:
                        self.traffic += t.untyped_storage().nbytes()

    # -- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
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
            "collective_bytes": 0.0,
            "per_op_bytes": {},
            "op_counts": dict(self.op_counts),
            "total_instructions": self.dispatched,
            "while_trips": dict(self.while_trips),
            "flops_by_op": dict(self.flops_by_op),
            "kernel_launches": dict(self.kernel_launches),
            "peak_bytes": self.peak,
        }
