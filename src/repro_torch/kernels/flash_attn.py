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
hand-written kernel or an exception. Which kernel is ``route(dtype, hd)``,
a pure function decided before any launch: bf16 with hd 64, 96 or 128
takes the tensor-core kernel ``csrc/flash_attn_wgmma.cu`` ("wgmma"); f32,
and bf16 at any other hd, the SIMT kernel ``csrc/flash_attn.cu``
("simt"). A failed build or launch raises; no route gives way to another.
``launches`` counts the launches of both, ``launches_by_route`` each.

Contract, checked on either device: q, k and v f32 or bf16, one dtype,
contiguous along hd; S and Sk multiples of 128; hd a multiple of 8, at
most 256; S <= Sk when causal or windowed (every row keeps its diagonal);
no input that requires grad (the kernel has no backward yet).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _launch
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
    """Refuse what neither version takes; -1 for CPU tensors, else the
    index of their card."""
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
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention has no backward yet (LM training "
                           "comes with ROADMAP.md queue 1 item 14); call it "
                           "under torch.no_grad() or on detached tensors")
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


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, sliding_window: Optional[int] = None,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, Sk, K, hd) -> (B, S, H, hd) in
    ``out_dtype`` (q's dtype by default)."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if _check(q, k, v, causal, sliding_window, out_dtype) < 0:
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (BH, S, hd), k/v (BH, Sk, hd) -> (BH, S, hd) in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or k.shape[0] != q.shape[0]:
        raise ValueError(f"expected q (BH, S, hd) and k, v (BH, Sk, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    return flash_attention_gqa(q.unsqueeze(2), k.unsqueeze(2),
                               v.unsqueeze(2), causal=causal)[:, :, 0]
