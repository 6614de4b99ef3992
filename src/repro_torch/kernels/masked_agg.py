"""Weighted aggregation over the client axis: the server's hot spot
(paper §IV-C, w_g ← w_anchor + Σ_i w_i·Δ_i).

``masked_agg(u, w)`` takes the cohort's packed updates u (C, R, LANE) f32
and host-chosen weights w (C,) f32 (zero for filtered and padding
clients) and returns Σ_c w[c]·u[c] as (R, LANE) f32. The tensor's device
decides the implementation: on the CPU the plain version in
``kernels/ref.py``, on a CUDA device the hand-written kernel in
``csrc/masked_agg.cu`` or an exception. ``launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LANE = 1024

launches = 0


def _lib():
    lib = _build.load("masked_agg")
    fn = lib.masked_agg
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_args(u: torch.Tensor, w: torch.Tensor) -> None:
    if u.dim() != 3 or u.shape[2] != LANE or u.shape[0] < 1:
        raise ValueError(f"u must be (C >= 1, R, {LANE}); got {tuple(u.shape)}")
    if tuple(w.shape) != (u.shape[0],):
        raise ValueError(f"w must be ({u.shape[0]},); got {tuple(w.shape)}")
    if u.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"expected float32 u and w; got {u.dtype}, {w.dtype}")
    if u.device != w.device:
        raise ValueError(f"u on {u.device} but w on {w.device}")


def masked_agg(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    check_args(u, w)
    if u.device.type == "cpu":
        return ref.masked_agg(u, w)
    if u.device.type != "cuda":
        raise ValueError(f"no masked-agg kernel for device {u.device}")
    if not (u.is_contiguous() and w.is_contiguous()):
        raise ValueError("the masked-agg kernel takes contiguous u and w")
    if u.data_ptr() % 16:
        raise ValueError("the masked-agg kernel takes a 16-byte aligned u")
    global launches
    out = torch.empty(u.shape[1:], dtype=torch.float32, device=u.device)
    err = _lib()(u.data_ptr(), w.data_ptr(), out.data_ptr(), u.shape[0],
                 out.numel(), torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"masked-agg kernel launch failed: CUDA error {err}")
    launches += 1
    return out
