"""Per-row symmetric int8 quantization: the wire format of int8 compression
with error feedback (core/compression.py).

``quantize_q8(x)`` takes x (R, LANE) f32 and returns the codes q (R, LANE)
int8 and the row scales (R, 1) f32, scale = max(max|x|, 1e-12) / 127 and
q = clip(round_half_even(x / scale), ±127); ``dequantize_q8(q, scale)``
returns q·scale (R, LANE) f32. The tensor's device decides the
implementation: on the CPU the plain versions in ``kernels/ref.py``, on a
CUDA device the hand-written kernels in ``csrc/quantize.cu`` or an
exception. ``launches`` counts each kernel's launches, by function name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LANE = 1024

launches = {"quantize_q8": 0, "dequantize_q8": 0}


def _lib(name: str):
    fn = getattr(_build.load("quantize"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dim() != 2 or t.shape[1] != LANE or t.shape[0] < 1:
        raise ValueError(f"{name} must be (R >= 1, {LANE}); got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"expected {name} {dtype}; got {t.dtype}")


def _check_kernel_args(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {name} kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {name} kernel takes 16-byte aligned tensors")


def _launch(name: str, *tensors: torch.Tensor) -> None:
    err = _lib(name)(*(t.data_ptr() for t in tensors), tensors[0].shape[0],
                     torch.cuda.current_stream(tensors[0].device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def quantize_q8(x: torch.Tensor):
    _check_rows("x", x, torch.float32)
    if x.device.type == "cpu":
        return ref.quantize_q8(x)
    _check_kernel_args("quantize_q8", x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    _launch("quantize_q8", x, q, scale)
    return q, scale


def dequantize_q8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    _check_rows("q", q, torch.int8)
    if tuple(scale.shape) != (q.shape[0], 1):
        raise ValueError(f"scale must be ({q.shape[0]}, 1); got "
                         f"{tuple(scale.shape)}")
    if scale.dtype != torch.float32:
        raise TypeError(f"expected scale float32; got {scale.dtype}")
    if q.device != scale.device:
        raise ValueError(f"q on {q.device} but scale on {scale.device}")
    if q.device.type == "cpu":
        return ref.dequantize_q8(q, scale)
    _check_kernel_args("dequantize_q8", q, scale)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("dequantize_q8", q, scale, out)
    return out
