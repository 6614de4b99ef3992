"""Plain PyTorch versions of the kernels (the correctness reference).

Shapes follow the kernels' layout: the flat parameter vector is a
(R, LANE) matrix with LANE = 1024, and the cohort's updates are
(C, R, LANE); the int8 wire codec works row by row on (R, LANE), and the
cohort gather takes (K,) slabs of an (N, R, LANE) arena; attention takes
heads flattened into the leading axis, (BH, S, hd). These run whenever
the tensors lie on the CPU, and ``chip_smoke.py`` holds the CUDA kernels
to them on the card.
"""
from __future__ import annotations

import math

import torch


def sign(x: torch.Tensor) -> torch.Tensor:
    """int8 sign with ±0 -> 0, as ``(x > 0) - (x < 0)``."""
    return ((x > 0).to(torch.int8) - (x < 0).to(torch.int8))


COUNT_SLOTS = 2 ** 28      # the most slots the counts compare at once


def _rows_a_chunk(clients: int, lane: int) -> int:
    """Rows of ``clients`` updates that hold at most ``COUNT_SLOTS``
    slots together (at least one)."""
    return max(1, COUNT_SLOTS // (clients * lane))


def _sign_into(x: torch.Tensor) -> torch.Tensor:
    """``sign(x)`` as a new contiguous int8 tensor: the two comparisons'
    bools read as int8 (0 or 1), one subtraction."""
    return torch.gt(x, 0).view(torch.int8) - torch.lt(x, 0).view(torch.int8)


def sign_align_counts(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """g: (R, LANE) f32 or bf16; r: (R, LANE) int8 -> 0-dim f32 count of
    the slots where sign(g) == r, taken in int64 over chunks of rows (so
    the temporaries stay bounded at any size) and converted once."""
    return sign_align_counts_int64(g, r).to(torch.float32)


def sign_align_counts_int64(g: torch.Tensor, r: torch.Tensor
                            ) -> torch.Tensor:
    """``sign_align_counts`` before its one conversion: the 0-dim int64
    count."""
    total = torch.zeros((), dtype=torch.int64, device=g.device)
    step = _rows_a_chunk(1, g.shape[1])
    for r0 in range(0, g.shape[0], step):
        total += torch.count_nonzero(
            _sign_into(g[r0:r0 + step]).eq_(r[r0:r0 + step]))
    return total


def per_client_sign_align(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """u: (C, R, LANE) f32; r: (R, LANE) int8, or (P, R, LANE) with P
    dividing C, client c counted against r[c // (C / P)] -> (C,) f32
    aligned counts.

    Counts are taken in int64 over chunks of rows (the temporaries hold
    at most ``COUNT_SLOTS`` slots) and converted once, so they are exact
    at any arena size (the -2 padding sentinel never matches a sign)."""
    return per_client_sign_align_int64(u, r).to(torch.float32)


def per_client_sign_align_int64(u: torch.Tensor, r: torch.Tensor
                                ) -> torch.Tensor:
    """``per_client_sign_align`` before its one conversion: (C,) int64."""
    refs = r[None] if r.dim() == 2 else r
    C, R, lane = u.shape
    P = refs.shape[0]
    total = torch.zeros(C, dtype=torch.int64, device=u.device)
    step = _rows_a_chunk(C, lane)
    for r0 in range(0, R, step):
        s = _sign_into(u[:, r0:r0 + step])
        rows = s.shape[1]
        s.view(P, C // P, rows, lane).eq_(refs[:, None, r0:r0 + step])
        # one count a client: count_nonzero over a whole row is the fast
        # reduction (its dim= form and sum(dim=) are an order slower)
        total += torch.stack([torch.count_nonzero(row) for row in s])
    return total


def masked_agg(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (C, R, LANE) f32; w: (C,) f32 weights -> Σ_c w[c]·u[c], (R, LANE).

    Accumulates client by client in order c = 0..C-1, the order the CUDA
    kernel uses."""
    acc = torch.zeros(u.shape[1:], dtype=torch.float32, device=u.device)
    for c in range(u.shape[0]):
        acc = acc + w[c] * u[c]
    return acc


def fused_update(p: torch.Tensor, u: torch.Tensor,
                 w_lr: torch.Tensor) -> torch.Tensor:
    """p: (R, LANE) f32 or bf16; u: (C, R, LANE) f32; w_lr: (C,) f32 ->
    p − Σ_c w_lr[c]·u[c] in p's dtype: the sum in f32 in the order of
    ``masked_agg``, the difference in f32, rounded once to p's dtype
    (round to nearest even, as ``.astype`` does)."""
    return (p.to(torch.float32) - masked_agg(u, w_lr)).to(p.dtype)


def quantize_q8(x: torch.Tensor):
    """Per-row symmetric int8. x: (R, LANE) f32 -> (q int8 (R, LANE),
    scale f32 (R, 1)), scale = max(amax, 1e-12) / 127 by true division and
    q = clip(round(x / scale), ±127), rounding half to even as
    ``jnp.round`` does. The 127 is a tensor on x's device, not a Python
    number: PyTorch's CUDA division by a CPU scalar multiplies by its
    reciprocal, one ulp off the quotient in some rows."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_q8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q (R, LANE) int8, scale (R, 1) f32 -> q·scale (R, LANE) f32."""
    return q.to(torch.float32) * scale


def ef_round_trip(d: torch.Tensor, e: torch.Tensor):
    """d, e (M, LANE) f32 -> (restored, residual), each (M, LANE) f32: the
    error-feedback round trip as four operations, c = d + e, the codec's
    two halves on c, and residual = c − restored."""
    corrected = d + e
    q, s = quantize_q8(corrected)
    restored = dequantize_q8(q, s)
    return restored, corrected - restored


def cohort_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (N, R, LANE) f32, idx (K,) int64 -> src[idx], (K, R, LANE): the
    rows copied as they are, as ``jnp.take`` does."""
    return src.index_select(0, idx)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, sliding_window=None, kv_groups: int = 1,
                    out_dtype=None) -> torch.Tensor:
    """Dense masked softmax attention in f32, the function of the flash
    kernel. q: (BH, S, hd); k, v: (BH / kv_groups, Sk, hd); query row i
    reads KV row i // kv_groups (with heads flattened as b·H + h, that is
    KV head h // G). q is scaled by 1/√hd in f32, masked scores are −1e30
    (causal: k_pos <= q_pos; window: q_pos − k_pos < window; positions
    from 0 on both axes), and the output is P·V / max(l, 1e-30), rounded
    once to ``out_dtype`` (q's dtype by default)."""
    S, Sk, hd = q.shape[1], k.shape[1], q.shape[2]
    qf = q.to(torch.float32) * (1.0 / math.sqrt(hd))
    kf = k.to(torch.float32).repeat_interleave(kv_groups, dim=0)
    vf = v.to(torch.float32).repeat_interleave(kv_groups, dim=0)
    s = qf @ kf.transpose(1, 2)                       # (BH, S, Sk)
    if causal or sliding_window is not None:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= j <= i
        if sliding_window is not None:
            mask &= (i - j) < sliding_window
        s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vf) / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype if out_dtype is None else out_dtype)
