"""Flash attention: causal or full online-softmax attention with f32
running max, sum and accumulator, the output rounded once.

``flash_attention(q, k, v, causal=)`` has the TPU kernel's signature and
layout: q (BH, S, hd), k/v (BH, Sk, hd), heads flattened, output in q's
dtype. ``flash_attention_gqa(q, k, v, causal=, sliding_window=,
out_dtype=)`` has ``blockwise_attention``'s: q (B, S, H, hd), k/v
(B, Sk, K, hd), query head h reading KV head h // G (G = H / K), KV heads
never expanded, output (B, S, H, hd). Both reach one kernel, driven by
strides.

The tensor's device decides the implementation: on the CPU the plain
version ``kernels/ref.py::flash_attention``, on a CUDA device a
hand-written kernel or an exception, on the meta device a shape-only call
(``kernels/meta.py``) for the dry run; DTensors take their placement
rule (``kernels/sharded.py``). Which kernel is ``route(dtype, hd)``,
a pure function decided before any launch: bf16 with hd 64, 96 or 128
takes the tensor-core kernel ``csrc/flash_attn_wgmma.cu`` ("wgmma"); f32,
and bf16 at any other hd, the SIMT kernel ``csrc/flash_attn.cu``
("simt"). A failed build or launch raises; no route gives way to another.
``launches`` counts the launches of both, ``launches_by_route`` each.

Contract, checked on either device: q, k and v f32 or bf16, one dtype,
contiguous along hd; S and Sk multiples of 128; hd a multiple of 8, at
most 256; S <= Sk when causal or windowed (every row keeps its diagonal).

Under grad, ``flash_attention_gqa`` is a ``torch.autograd.Function``: its
forward is the call above (the kernel of ``route`` on the card), saving
q, k, v and the output; its backward is ``flash_backward``, plain torch
on every device (the JAX package differentiates its ``lax.scan`` of
``blockwise_attention`` and has no backward kernel). It recomputes the
scores one query block at a time, so no (B, H, S, Sk) tensor is held:
with P = softmax(s) from the block's recomputed row log-sum-exp,
dV = Pᵀ·dO, dS = P ∘ (dO·Vᵀ − rowsum(dO ∘ O)), dQ = dS·K/√hd,
dK = dSᵀ·Q/√hd, in f32, the KV gradients summed over each KV head's
query group and the masks the forward's. A hand-written backward kernel
is ROADMAP.md queue 2 item 5.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch import dist
from repro_torch.kernels import _launch
from repro_torch.kernels import meta
from repro_torch.kernels import ref

TILE = 128                 # S and Sk must be multiples (the TPU contract)
MAX_HD = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

WGMMA_HD = (64, 96, 128)

launches = 0
launches_by_route = {"wgmma": 0, "simt": 0}


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call of this input dtype and head dim takes."""
    return ("wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HD
            else "simt")


ENTRY = {"simt": "flash_attention", "wgmma": "flash_attention_wgmma"}


def wgmma_smem_bytes(hd: int) -> int:
    """The wgmma kernel's dynamic shared memory a block at head dim hd."""
    return _launch.query("flash_attention_wgmma_smem_bytes", hd)


def _check(q, k, v, causal, sliding_window, out_dtype) -> int:
    """Refuse what neither version takes; ``_launch.device_index``'s
    answer for the tensors' device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (B, S, H, hd) and k, v (B, Sk, K, hd)")
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, K, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"expected q, k, v of one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16; got "
                        f"{out_dtype}")
    if S % TILE or Sk % TILE or S == 0 or Sk == 0:
        raise ValueError(f"S = {S} and Sk = {Sk} must be positive multiples "
                         f"of {TILE}")
    if hd % 8 or not 0 < hd <= MAX_HD:
        raise ValueError(f"hd = {hd} must be a multiple of 8 up to {MAX_HD}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1; got {sliding_window}")
    if (causal or sliding_window is not None) and S > Sk:
        raise ValueError(f"a causal or windowed call needs S <= Sk (every "
                         f"row keeps its diagonal); got S = {S}, Sk = {Sk}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous along hd")
    return _launch.device_index("flash_attention", q, k, v)


def _enqueue(q, k, v, out, causal: bool, window: Optional[int],
             which: Optional[str] = None) -> None:
    """Launch the kernel of ``route`` (or of ``which``, for measurements
    that hold the two kernels side by side) on q's current stream."""
    device = _launch.device_index("flash_attention", q, k, v, out)
    if device < 0:
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    B, S, H, hd = q.shape
    which = which or route(q.dtype, hd)
    if which == "simt" and B * H > 65535:
        raise ValueError(f"B·H = {B * H} exceeds the kernel's grid (65535)")
    if which == "wgmma" and S // 128 > 65535:
        raise ValueError(f"S / 128 = {S // 128} exceeds the kernel's grid "
                         f"(65535)")
    fn = _launch.entries[ENTRY[which]]
    # TMA reads from 16-byte aligned addresses in steps of 16 bytes
    if which == "wgmma" and any(
            t.data_ptr() % 16 or any(st % 8 for st, n in zip(
                t.stride()[:3], t.shape[:3]) if n > 1) for t in (q, k, v)):
        raise ValueError("the wgmma kernel needs q, k and v 16-byte aligned, "
                         "with strides in multiples of 8 elements")
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    dtypes = ((_DTYPES[q.dtype],) if which == "simt" else ()) + (
        _DTYPES[out.dtype],)
    fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dtypes, B,
       H, k.shape[2], S, k.shape[1], hd, ctypes.addressof(strides),
       int(causal), window or 0, 1.0 / math.sqrt(hd), _launch.stream(device))
    global launches
    launches += 1
    launches_by_route[which] += 1


def _forward(q, k, v, causal, sliding_window, out_dtype) -> torch.Tensor:
    device = _check(q, k, v, causal, sliding_window, out_dtype)
    if device == _launch.META:
        return meta.flash_attention(q, k, v, causal, sliding_window,
                                    out_dtype)
    if device == _launch.CPU:
        B, S, H, hd = q.shape
        Sk, K = k.shape[1], k.shape[2]
        flat = ref.flash_attention(
            q.transpose(1, 2).reshape(B * H, S, hd),
            k.transpose(1, 2).reshape(B * K, Sk, hd),
            v.transpose(1, 2).reshape(B * K, Sk, hd), causal,
            sliding_window, kv_groups=H // K, out_dtype=out_dtype)
        return flat.reshape(B, H, S, hd).transpose(1, 2)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    _enqueue(q, k, v, out, causal, sliding_window)
    return out


BACKWARD_BLOCK = 512       # query rows a step of flash_backward


def flash_backward(q, k, v, out, dout, *, causal: bool,
                   sliding_window: Optional[int] = None):
    """(dq, dk, dv) of ``flash_attention_gqa`` at q (B, S, H, hd), k, v
    (B, Sk, K, hd), its output ``out`` and the output's gradient ``dout``
    (B, S, H, hd); each gradient in its input's dtype. Plain torch, one
    block of ``BACKWARD_BLOCK`` query rows at a time against the keys its
    masks reach."""
    block = BACKWARD_BLOCK
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qf = q.to(f32).reshape(B, S, K, G, hd)
    kf, vf = k.to(f32), v.to(f32)
    dof = dout.to(f32).reshape(B, S, K, G, hd)
    # rowsum(dO ∘ O): (B, K, G, S)
    dsum = (dof * out.to(f32).reshape(B, S, K, G, hd)).sum(-1).permute(
        0, 2, 3, 1)
    dq = torch.empty((B, S, K, G, hd), dtype=f32, device=q.device)
    dk = torch.zeros((B, Sk, K, hd), dtype=f32, device=q.device)
    dv = torch.zeros((B, Sk, K, hd), dtype=f32, device=q.device)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        lo, hi = 0, Sk
        if causal:
            hi = min(Sk, i1)
        if sliding_window is not None:
            lo = max(0, i0 - sliding_window + 1)
        qb, dob = qf[:, i0:i1], dof[:, i0:i1]
        kb, vb = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
        if causal or sliding_window is not None:
            i = torch.arange(i0, i1, device=q.device)[:, None]
            j = torch.arange(lo, hi, device=q.device)[None, :]
            mask = torch.ones((i1 - i0, hi - lo), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= j <= i
            if sliding_window is not None:
                mask &= (i - j) < sliding_window
            s = torch.where(mask, s, -1e30)
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        dv[:, lo:hi] += torch.einsum("bkgqs,bqkgd->bskd", p, dob)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dob, vb)
        ds = p * (dp - dsum[..., i0:i1, None])
        dq[:, i0:i1] = torch.einsum("bkgqs,bskd->bqkgd", ds, kb) * scale
        dk[:, lo:hi] += torch.einsum("bkgqs,bqkgd->bskd", ds, qb) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, out_dtype):
        out = _forward(q, k, v, causal, sliding_window, out_dtype)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, dout, causal=ctx.causal,
                                    sliding_window=ctx.sliding_window)
        return dq, dk, dv, None, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, sliding_window: Optional[int] = None,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, Sk, K, hd) -> (B, S, H, hd) in
    ``out_dtype`` (q's dtype by default); differentiable in q, k, v."""
    if dist.is_dtensor(q, k, v):
        from repro_torch.kernels import sharded
        return sharded.flash_attention_gqa(q, k, v, causal=causal,
                                           sliding_window=sliding_window,
                                           out_dtype=out_dtype)
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, sliding_window,
                                     out_dtype)
    return _forward(q, k, v, causal, sliding_window, out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (BH, S, hd), k/v (BH, Sk, hd) -> (BH, S, hd) in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or k.shape[0] != q.shape[0]:
        raise ValueError(f"expected q (BH, S, hd) and k, v (BH, Sk, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    return flash_attention_gqa(q.unsqueeze(2), k.unsqueeze(2),
                               v.unsqueeze(2), causal=causal)[:, :, 0]
