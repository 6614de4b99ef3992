"""Per-row symmetric int8 quantization: the wire format of int8 compression
with error feedback (core/compression.py).

``quantize_q8(x)`` takes x (R, LANE) f32 and returns the codes q (R, LANE)
int8 and the row scales (R, 1) f32, scale = max(max|x|, 1e-12) / 127 and
q = clip(round_half_even(x / scale), ±127); ``dequantize_q8(q, scale)``
returns q·scale (R, LANE) f32. ``ef_round_trip(d, e)`` is the error-
feedback round trip of the int8 main paths in one pass: with c = d + e it
returns (restored, residual) = (dequantize_q8(*quantize_q8(c)),
c − restored), each (M, LANE) f32. The tensor's device decides the
implementation: on the CPU the plain versions in ``kernels/ref.py``, on a
CUDA device the hand-written kernels in ``csrc/quantize.cu`` or an
exception (``dequantize_q8`` launches through ``csrc/tensor_call.cpp``,
which checks its tensors, allocates the output and launches in one C++
call); on the meta device a shape-only call (``kernels/meta.py``) for
the dry run; a DTensor takes its placement rule (``kernels/sharded.py``).
``launches`` counts each kernel's launches, by function name.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.kernels import _launch
from repro_torch.kernels import meta
from repro_torch.kernels import ref

LANE = 1024

launches = {"quantize_q8": 0, "dequantize_q8": 0, "ef_round_trip": 0}


def _check_rows(name: str, t: torch.Tensor) -> None:
    shape = t.shape
    if len(shape) != 2 or shape[1] != LANE or shape[0] < 1:
        raise ValueError(f"{name} must be (R >= 1, {LANE}); got "
                         f"{tuple(shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"expected {name} float32; got {t.dtype}")


def check_quantize(x: torch.Tensor) -> int:
    """Refuse what neither version of ``quantize_q8`` takes;
    ``_launch.device_index``'s answer for the tensor's device."""
    _check_rows("x", x)
    return _launch.device_index("quantize_q8", x)


def check_round_trip(d: torch.Tensor, e: torch.Tensor) -> int:
    """Refuse what neither version of ``ef_round_trip`` takes;
    ``_launch.device_index``'s answer for the tensors' device."""
    _check_rows("d", d)
    _check_rows("e", e)
    if e.shape != d.shape:
        raise ValueError(f"e must have d's shape {tuple(d.shape)}; got "
                         f"{tuple(e.shape)}")
    return _launch.device_index("ef_round_trip", d, e)


def check_dequantize(q: torch.Tensor, scale: torch.Tensor) -> int:
    """Refuse what neither version of ``dequantize_q8`` takes;
    ``_launch.device_index``'s answer for the tensors' device."""
    shape = q.shape
    if len(shape) != 2 or shape[1] != LANE or shape[0] < 1:
        raise ValueError(f"q must be (R >= 1, {LANE}); got {tuple(shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"expected q int8; got {q.dtype}")
    if scale.shape != (shape[0], 1):
        raise ValueError(f"scale must be ({shape[0]}, 1); got "
                         f"{tuple(scale.shape)}")
    if scale.dtype != torch.float32:
        raise TypeError(f"expected scale float32; got {scale.dtype}")
    return _launch.device_index("dequantize_q8", q, scale)


def quantize_q8(x: torch.Tensor):
    if dist.is_dtensor(x):
        from repro_torch.kernels import sharded
        return sharded.quantize_q8(x)
    device = check_quantize(x)
    if device == _launch.CPU:
        return ref.quantize_q8(x)
    if device == _launch.META:
        return meta.quantize_q8(x)
    px = _launch.aligned_pointer("quantize_q8", x)
    R = x.shape[0]
    q = torch.empty_like(x, dtype=torch.int8)
    scale = x.new_empty(R, 1)
    _launch.entries["quantize_q8"](px, q.data_ptr(), scale.data_ptr(), R,
                                 _launch.stream(device))
    launches["quantize_q8"] += 1
    return q, scale


def dequantize_q8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if dist.is_dtensor(q, scale):
        from repro_torch.kernels import sharded
        return sharded.dequantize_q8(q, scale)
    if _launch.on_card(q):
        # checks, output, stream and launch in one C++ call
        out = _launch.tensor_entries["dequantize_q8"](q, scale)
        launches["dequantize_q8"] += 1
        return out
    if check_dequantize(q, scale) == _launch.META:
        return meta.dequantize_q8(q, scale)
    return ref.dequantize_q8(q, scale)


def ef_round_trip(d: torch.Tensor, e: torch.Tensor):
    if dist.is_dtensor(d, e):
        from repro_torch.kernels import sharded
        return sharded.ef_round_trip(d, e)
    device = check_round_trip(d, e)
    if device == _launch.CPU:
        return ref.ef_round_trip(d, e)
    if device == _launch.META:
        return meta.ef_round_trip(d, e)
    pd = _launch.aligned_pointer("ef_round_trip", d)
    pe = _launch.aligned_pointer("ef_round_trip", e)
    restored = torch.empty_like(d)
    residual = torch.empty_like(d)
    _launch.entries["ef_round_trip"](pd, pe, restored.data_ptr(),
                                     residual.data_ptr(), d.shape[0],
                                     _launch.stream(device))
    launches["ef_round_trip"] += 1
    return restored, residual
