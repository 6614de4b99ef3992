"""Cohort gather of per-client arena slabs: the scanned control plane's
error-feedback fetch (core/megastep.py, ``build_scanned_rounds``).

``cohort_gather(src, idx)`` takes src (N, R, LANE) f32 and the cohort's
client ids idx (K,) int64 on the same device and returns
out[k] = src[idx[k]] as (K, R, LANE) f32. The tensor's device decides the
implementation: on the CPU the plain version in ``kernels/ref.py``, on a
CUDA device the hand-written kernel in ``csrc/gather.cu`` or an
exception. The kernel reads the indices on the device, so a call never
waits for the card. ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LANE = 1024
MAX_K = 65535                 # the grid's y extent

launches = 0


def _lib():
    fn = _build.load("gather").cohort_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_args(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 3 or src.shape[2] != LANE or src.shape[0] < 1 \
            or src.shape[1] < 1:
        raise ValueError(f"src must be (N >= 1, R >= 1, {LANE}); got "
                         f"{tuple(src.shape)}")
    if idx.dim() != 1 or not 1 <= idx.shape[0] <= MAX_K:
        raise ValueError(f"idx must be (K,) with 1 <= K <= {MAX_K}; got "
                         f"{tuple(idx.shape)}")
    if src.dtype != torch.float32 or idx.dtype != torch.int64:
        raise TypeError(f"expected src float32 and idx int64; got "
                        f"{src.dtype}, {idx.dtype}")
    if src.device != idx.device:
        raise ValueError(f"src on {src.device} but idx on {idx.device}")


def cohort_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    check_args(src, idx)
    if src.device.type == "cpu":
        return ref.cohort_gather(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"no cohort_gather kernel for device {src.device}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the cohort_gather kernel takes contiguous src and "
                         "idx")
    if src.data_ptr() % 16:
        raise ValueError("the cohort_gather kernel takes a 16-byte aligned "
                         "src")
    global launches
    N, R, _ = src.shape
    K = idx.shape[0]
    out = torch.empty((K, R, LANE), dtype=torch.float32, device=src.device)
    err = _lib()(src.data_ptr(), idx.data_ptr(), out.data_ptr(), N, R, K,
                 torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"cohort_gather kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
