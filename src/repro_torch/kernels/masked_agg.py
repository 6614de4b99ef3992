"""Weighted aggregation over the client axis: the server's hot spot
(paper §IV-C, w_g ← w_anchor + Σ_i w_i·Δ_i).

``masked_agg(u, w)`` takes the cohort's packed updates u (C, R, LANE) f32
and host-chosen weights w (C,) f32 (zero for filtered and padding
clients) and returns Σ_c w[c]·u[c] as (R, LANE) f32.
``fused_update(p, u, w_lr)`` subtracts the same sum, weighted by
w_lr = lr·mask·weight, from the parameters p (R, LANE), f32 or bf16, in
one pass, and returns a new tensor in p's dtype. The tensor's device
decides the implementation: on the CPU the plain versions in
``kernels/ref.py``, on a CUDA device the hand-written kernels in
``csrc/masked_agg.cu`` or an exception. ``launches`` counts each kernel's
launches, by function name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LANE = 1024

launches = {"masked_agg": 0, "fused_update": 0}

_ARGTYPES = {
    "masked_agg": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    "fused_update": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_void_p],
}


def _lib(name: str):
    fn = getattr(_build.load("masked_agg"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
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
    out = torch.empty(u.shape[1:], dtype=torch.float32, device=u.device)
    err = _lib("masked_agg")(u.data_ptr(), w.data_ptr(), out.data_ptr(),
                             u.shape[0], out.numel(),
                             torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"masked-agg kernel launch failed: CUDA error {err}")
    launches["masked_agg"] += 1
    return out


def check_fused_args(p: torch.Tensor, u: torch.Tensor,
                     w_lr: torch.Tensor) -> None:
    check_args(u, w_lr)
    if tuple(p.shape) != tuple(u.shape[1:]):
        raise ValueError(f"p must be {tuple(u.shape[1:])}; got "
                         f"{tuple(p.shape)}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected p float32 or bfloat16; got {p.dtype}")
    if p.device != u.device:
        raise ValueError(f"p on {p.device} but u on {u.device}")


def fused_update(p: torch.Tensor, u: torch.Tensor,
                 w_lr: torch.Tensor) -> torch.Tensor:
    check_fused_args(p, u, w_lr)
    if p.device.type == "cpu":
        return ref.fused_update(p, u, w_lr)
    if p.device.type != "cuda":
        raise ValueError(f"no fused_update kernel for device {p.device}")
    if not (p.is_contiguous() and u.is_contiguous() and w_lr.is_contiguous()):
        raise ValueError("the fused_update kernel takes contiguous p, u and "
                         "w_lr")
    if p.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("the fused_update kernel takes 16-byte aligned p "
                         "and u")
    out = torch.empty_like(p)
    err = _lib("fused_update")(
        p.data_ptr(), int(p.dtype == torch.bfloat16), u.data_ptr(),
        w_lr.data_ptr(), out.data_ptr(), u.shape[0], p.numel(),
        torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error "
                           f"{err}")
    launches["fused_update"] += 1
    return out
