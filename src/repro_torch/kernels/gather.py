"""Cohort gather of per-client arena slabs: the scanned control plane's
error-feedback fetch (core/megastep.py, ``build_scanned_rounds``).

This is the JAX package's ``onehot_gather`` (``src/repro/kernels/
gather.py``), under the name of what it does here: the JAX function takes
a one-hot (K, N) matrix and sums onehot·src, a workaround for the TPU's
matrix unit, where ``cohort_gather`` takes the ids themselves.

``cohort_gather(src, idx)`` takes src (N, R, LANE) f32 and the cohort's
client ids idx (K,) int64 on the same device and returns
out[k] = src[idx[k]] as (K, R, LANE) f32. The tensor's device decides the
implementation: on the CPU the plain version in ``kernels/ref.py``, on a
CUDA device the hand-written kernel in ``csrc/gather.cu``, launched
through ``csrc/tensor_call.cpp`` (the checks, the output, the stream and
the launch in one C++ call), or an exception; on the meta device a
shape-only call (``kernels/meta.py``) for the dry run; a DTensor takes
its placement rule (``kernels/sharded.py``). The kernel reads the indices
on the device, so a call never waits for the card. ``launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.kernels import _launch
from repro_torch.kernels import meta
from repro_torch.kernels import ref

LANE = 1024
MAX_K = 65535                 # the grid's y extent

launches = 0


def check_args(src: torch.Tensor, idx: torch.Tensor) -> int:
    """Refuse what neither version takes; ``_launch.device_index``'s
    answer for the tensors' device."""
    shape = src.shape
    if len(shape) != 3 or shape[2] != LANE or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"src must be (N >= 1, R >= 1, {LANE}); got "
                         f"{tuple(shape)}")
    if idx.dim() != 1 or not 1 <= idx.shape[0] <= MAX_K:
        raise ValueError(f"idx must be (K,) with 1 <= K <= {MAX_K}; got "
                         f"{tuple(idx.shape)}")
    if src.dtype != torch.float32 or idx.dtype != torch.int64:
        raise TypeError(f"expected src float32 and idx int64; got "
                        f"{src.dtype}, {idx.dtype}")
    return _launch.device_index("cohort_gather", src, idx)


def cohort_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global launches
    if dist.is_dtensor(src, idx):
        from repro_torch.kernels import sharded
        return sharded.cohort_gather(src, idx)
    if _launch.on_card(src):
        # checks, output, stream and launch in one C++ call
        out = _launch.tensor_entries["cohort_gather"](src, idx)
        launches += 1
        return out
    if check_args(src, idx) == _launch.META:
        return meta.cohort_gather(src, idx)
    return ref.cohort_gather(src, idx)
