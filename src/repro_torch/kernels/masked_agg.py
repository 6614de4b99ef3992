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
``csrc/masked_agg.cu`` or an exception; on the meta device a shape-only
call (``kernels/meta.py``) for the dry run; a DTensor takes its placement
rule (``kernels/sharded.py``). ``launches`` counts each kernel's
launches, by function name.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.kernels import _launch
from repro_torch.kernels import meta
from repro_torch.kernels import ref

LANE = 1024

launches = {"masked_agg": 0, "fused_update": 0}


def check_args(u: torch.Tensor, w: torch.Tensor) -> int:
    """Refuse what neither version of ``masked_agg`` takes;
    ``_launch.device_index``'s answer for the tensors' device."""
    if u.dim() != 3 or u.shape[2] != LANE or u.shape[0] < 1:
        raise ValueError(f"u must be (C >= 1, R, {LANE}); got {tuple(u.shape)}")
    if tuple(w.shape) != (u.shape[0],):
        raise ValueError(f"w must be ({u.shape[0]},); got {tuple(w.shape)}")
    if u.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"expected float32 u and w; got {u.dtype}, {w.dtype}")
    return _launch.device_index("masked_agg", u, w)


def masked_agg(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if dist.is_dtensor(u, w):
        from repro_torch.kernels import sharded
        return sharded.masked_agg(u, w)
    device = check_args(u, w)
    if device == _launch.CPU:
        return ref.masked_agg(u, w)
    if device == _launch.META:
        return meta.masked_agg(u, w)
    pu = _launch.aligned_pointer("masked_agg", u)
    if not w.is_contiguous():
        raise ValueError("the masked_agg kernel takes a contiguous w")
    out = u.new_empty(u.shape[1:])
    _launch.entries["masked_agg"](pu, w.data_ptr(), out.data_ptr(),
                                  u.shape[0], out.numel(),
                                  _launch.stream(device))
    launches["masked_agg"] += 1
    return out


def check_fused_args(p: torch.Tensor, u: torch.Tensor,
                     w_lr: torch.Tensor) -> int:
    """Refuse what neither version of ``fused_update`` takes;
    ``_launch.device_index``'s answer for the tensors' device."""
    check_args(u, w_lr)
    if tuple(p.shape) != tuple(u.shape[1:]):
        raise ValueError(f"p must be {tuple(u.shape[1:])}; got "
                         f"{tuple(p.shape)}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected p float32 or bfloat16; got {p.dtype}")
    return _launch.device_index("fused_update", p, u, w_lr)


def fused_update(p: torch.Tensor, u: torch.Tensor,
                 w_lr: torch.Tensor) -> torch.Tensor:
    if dist.is_dtensor(p, u, w_lr):
        from repro_torch.kernels import sharded
        return sharded.fused_update(p, u, w_lr)
    device = check_fused_args(p, u, w_lr)
    if device == _launch.CPU:
        return ref.fused_update(p, u, w_lr)
    if device == _launch.META:
        return meta.fused_update(p, u, w_lr)
    pp = _launch.aligned_pointer("fused_update", p)
    pu = _launch.aligned_pointer("fused_update", u)
    if not w_lr.is_contiguous():
        raise ValueError("the fused_update kernel takes a contiguous w_lr")
    out = torch.empty_like(p)
    _launch.entries["fused_update"](
        pp, int(p.dtype == torch.bfloat16), pu, w_lr.data_ptr(),
        out.data_ptr(), u.shape[0], p.numel(), _launch.stream(device))
    launches["fused_update"] += 1
    return out
