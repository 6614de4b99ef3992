"""Sign-alignment counts: the θ filter's hot spot (paper Alg. 1,
CALCULATE-RELEVANCE).

``per_client_sign_align(u, r)`` takes the cohort's packed updates
u (C, R, LANE) f32 and the reference signs r (R, LANE) int8 (-2 on
padding) and returns the (C,) f32 counts of slots where sign(u[c]) == r.
``sign_align_counts(g, r)`` counts the same for one update g (R, LANE),
f32 or bf16, and returns a 0-dim f32 tensor on g's device (the kernel
path reads nothing back). The tensor's device decides the
implementation: on the CPU the plain versions in ``kernels/ref.py``, on a
CUDA device the hand-written kernels in ``csrc/sign_align.cu`` or an
exception. ``launches`` counts each kernel's launches, by function name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LANE = 1024

launches = {"per_client_sign_align": 0, "sign_align_counts": 0}

_ARGTYPES = {
    "per_client_sign_align": [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_void_p],
    "sign_align_counts": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p],
}


def _lib(name: str):
    fn = getattr(_build.load("sign_align"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_card(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {name} kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {name} kernel takes 16-byte aligned tensors")


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
    _check_card("sign-align", u, r)
    counts = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    err = _lib("per_client_sign_align")(
        u.data_ptr(), r.data_ptr(), counts.data_ptr(), u.shape[0], r.numel(),
        torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"sign-align kernel launch failed: CUDA error {err}")
    launches["per_client_sign_align"] += 1
    return counts.to(torch.float32)


def check_count_args(g: torch.Tensor, r: torch.Tensor) -> None:
    if g.dim() != 2 or g.shape[1] != LANE or g.shape[0] < 1:
        raise ValueError(f"g must be (R >= 1, {LANE}); got {tuple(g.shape)}")
    if tuple(r.shape) != tuple(g.shape):
        raise ValueError(f"r must be {tuple(g.shape)}; got {tuple(r.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16) or r.dtype != torch.int8:
        raise TypeError(f"expected g float32 or bfloat16 and r int8; got "
                        f"{g.dtype}, {r.dtype}")
    if g.device != r.device:
        raise ValueError(f"g on {g.device} but r on {r.device}")


def sign_align_counts(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    check_count_args(g, r)
    if g.device.type == "cpu":
        return ref.sign_align_counts(g, r)
    if g.device.type != "cuda":
        raise ValueError(f"no sign_align_counts kernel for device {g.device}")
    _check_card("sign_align_counts", g, r)
    count = torch.zeros((), dtype=torch.int32, device=g.device)
    err = _lib("sign_align_counts")(
        g.data_ptr(), int(g.dtype == torch.bfloat16), r.data_ptr(),
        count.data_ptr(), g.numel(),
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"sign_align_counts kernel launch failed: CUDA "
                           f"error {err}")
    launches["sign_align_counts"] += 1
    return count.to(torch.float32)
