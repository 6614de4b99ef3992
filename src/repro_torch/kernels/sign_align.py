"""Per-client sign-alignment counts: the θ filter's hot spot (paper Alg. 1,
CALCULATE-RELEVANCE).

``per_client_sign_align(u, r)`` takes the cohort's packed updates
u (C, R, LANE) f32 and the reference signs r (R, LANE) int8 (-2 on
padding) and returns the (C,) f32 counts of slots where sign(u[c]) == r.
The tensor's device decides the implementation: on the CPU the plain
version in ``kernels/ref.py``, on a CUDA device the hand-written kernel
in ``csrc/sign_align.cu`` or an exception. ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LANE = 1024

launches = 0


def _lib():
    lib = _build.load("sign_align")
    fn = lib.per_client_sign_align
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_args(u: torch.Tensor, r: torch.Tensor) -> None:
    if u.dim() != 3 or u.shape[2] != LANE or u.shape[0] < 1:
        raise ValueError(f"u must be (C >= 1, R, {LANE}); got {tuple(u.shape)}")
    if tuple(r.shape) != tuple(u.shape[1:]):
        raise ValueError(f"r must be {tuple(u.shape[1:])}; got {tuple(r.shape)}")
    if u.dtype != torch.float32 or r.dtype != torch.int8:
        raise TypeError(f"expected u float32 and r int8; got {u.dtype}, "
                        f"{r.dtype}")
    if u.device != r.device:
        raise ValueError(f"u on {u.device} but r on {r.device}")


def per_client_sign_align(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    check_args(u, r)
    if u.device.type == "cpu":
        return ref.per_client_sign_align(u, r)
    if u.device.type != "cuda":
        raise ValueError(f"no sign-align kernel for device {u.device}")
    if not (u.is_contiguous() and r.is_contiguous()):
        raise ValueError("the sign-align kernel takes contiguous u and r")
    if u.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("the sign-align kernel takes 16-byte aligned u and r")
    global launches
    counts = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    err = _lib()(u.data_ptr(), r.data_ptr(), counts.data_ptr(), u.shape[0],
                 r.numel(), torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"sign-align kernel launch failed: CUDA error {err}")
    launches += 1
    return counts.to(torch.float32)
