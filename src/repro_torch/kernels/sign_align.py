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
exception. On the card a call is one device operation: the kernel writes
the f32 counts into the ``torch.empty`` output that the wrapper returns.
Both versions count exactly and refuse n = R·1024 ≥ 2^31 slots, where
the kernel's int32 count would wrap. ``launches`` counts each kernel's
launches, by function name.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels import ref

LANE = 1024
MAX_SLOTS = 2 ** 31 - 1     # the kernel counts in int32

launches = {"per_client_sign_align": 0, "sign_align_counts": 0}


def check_slots(n: int) -> None:
    """Refuse more slots a count than the kernel's int32 count holds."""
    if n > MAX_SLOTS:
        raise ValueError(f"at most {MAX_SLOTS} slots a count; got {n}")


def check_args(u: torch.Tensor, r: torch.Tensor) -> int:
    """Refuse what neither version of ``per_client_sign_align`` takes; -1
    for CPU tensors, else the index of their card."""
    if u.dim() != 3 or u.shape[2] != LANE or u.shape[0] < 1:
        raise ValueError(f"u must be (C >= 1, R, {LANE}); got {tuple(u.shape)}")
    if tuple(r.shape) != tuple(u.shape[1:]):
        raise ValueError(f"r must be {tuple(u.shape[1:])}; got {tuple(r.shape)}")
    if u.dtype != torch.float32 or r.dtype != torch.int8:
        raise TypeError(f"expected u float32 and r int8; got {u.dtype}, "
                        f"{r.dtype}")
    check_slots(r.numel())
    return _launch.device_index("per_client_sign_align", u, r)


def per_client_sign_align(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    device = check_args(u, r)
    if device < 0:
        return ref.per_client_sign_align(u, r)
    pu = _launch.aligned_pointer("per_client_sign_align", u)
    pr = _launch.aligned_pointer("per_client_sign_align", r)
    counts = u.new_empty(u.shape[0])
    _launch.entries["per_client_sign_align"](
        pu, pr, counts.data_ptr(), u.shape[0], r.numel(),
        _launch.stream(device))
    launches["per_client_sign_align"] += 1
    return counts


def check_count_args(g: torch.Tensor, r: torch.Tensor) -> int:
    """Refuse what neither version of ``sign_align_counts`` takes; -1 for
    CPU tensors, else the index of their card."""
    if g.dim() != 2 or g.shape[1] != LANE or g.shape[0] < 1:
        raise ValueError(f"g must be (R >= 1, {LANE}); got {tuple(g.shape)}")
    if tuple(r.shape) != tuple(g.shape):
        raise ValueError(f"r must be {tuple(g.shape)}; got {tuple(r.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16) or r.dtype != torch.int8:
        raise TypeError(f"expected g float32 or bfloat16 and r int8; got "
                        f"{g.dtype}, {r.dtype}")
    check_slots(r.numel())
    return _launch.device_index("sign_align_counts", g, r)


def sign_align_counts(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    device = check_count_args(g, r)
    if device < 0:
        return ref.sign_align_counts(g, r)
    pg = _launch.aligned_pointer("sign_align_counts", g)
    pr = _launch.aligned_pointer("sign_align_counts", r)
    count = g.new_empty((), dtype=torch.float32)
    _launch.entries["sign_align_counts"](
        pg, int(g.dtype == torch.bfloat16), pr, count.data_ptr(), g.numel(),
        _launch.stream(device))
    launches["sign_align_counts"] += 1
    return count
