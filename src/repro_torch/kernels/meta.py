"""The hand-written kernels on the meta device: shape-only calls for the
dry run (``launch/dryrun.py``), the counterpart of a ``pallas_call``'s
abstract evaluation.

Each kernel wrapper of ``repro_torch.kernels`` takes the plain version for
CPU tensors, its CUDA kernel for CUDA tensors and, for meta tensors, the
operator of the same name here: ``torch.ops.repro_torch.<name>``, a
``torch.library`` operator whose one implementation (its fake, for the
meta device) returns ``empty`` outputs of the kernel's shapes and dtypes.
It reads no data and invents none. A dispatch mode sees each call as one
operator, so the dry run's census (``roofline/census.py``) counts it as
one launch of that kernel, with the bytes and operations of ``work``.

``work(name, args)`` reckons a call's bytes and operations as ``PERF.md``
section 6's bound column does: each input read once, each output written
once; two operations a slot for the sign counts and the weighted sums
(and one more a slot for ``fused_update``'s difference), five a value for
the codec, eight for the error-feedback round trip, none for the gather,
and 4·hd a kept score for flash attention.
"""
from __future__ import annotations

import torch

LANE = 1024

_LIB = torch.library.Library("repro_torch", "DEF")


def _operator(schema: str, fake):
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, fake, "Meta")
    return getattr(torch.ops.repro_torch, name).default


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


per_client_sign_align = _operator(
    "per_client_sign_align(Tensor u, Tensor r) -> Tensor",
    lambda u, r: _empty((u.shape[0],), torch.float32, u))
sign_align_counts = _operator(
    "sign_align_counts(Tensor g, Tensor r) -> Tensor",
    lambda g, r: _empty((), torch.float32, g))
masked_agg = _operator(
    "masked_agg(Tensor u, Tensor w) -> Tensor",
    lambda u, w: _empty(u.shape[1:], torch.float32, u))
fused_update = _operator(
    "fused_update(Tensor p, Tensor u, Tensor w_lr) -> Tensor",
    lambda p, u, w_lr: _empty(p.shape, p.dtype, p))
quantize_q8 = _operator(
    "quantize_q8(Tensor x) -> (Tensor, Tensor)",
    lambda x: (_empty(x.shape, torch.int8, x),
               _empty((x.shape[0], 1), torch.float32, x)))
dequantize_q8 = _operator(
    "dequantize_q8(Tensor q, Tensor scale) -> Tensor",
    lambda q, scale: _empty(q.shape, torch.float32, q))
ef_round_trip = _operator(
    "ef_round_trip(Tensor d, Tensor e) -> (Tensor, Tensor)",
    lambda d, e: (_empty(d.shape, torch.float32, d),
                  _empty(d.shape, torch.float32, d)))
cohort_gather = _operator(
    "cohort_gather(Tensor src, Tensor idx) -> Tensor",
    lambda src, idx: _empty((idx.shape[0],) + tuple(src.shape[1:]),
                            torch.float32, src))
flash_attention = _operator(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
    "int? sliding_window, ScalarType out_dtype) -> Tensor",
    lambda q, k, v, causal, sliding_window, out_dtype: _empty(
        q.shape, out_dtype, q))


def kept_pairs(S: int, Sk: int, causal: bool, window) -> int:
    """The (query, key) pairs a flash call keeps, positions from 0 on both
    axes: causal keeps k <= q, a window keeps q − k < window (the kernel's
    contract has S <= Sk whenever either masks)."""
    if not causal and window is None:
        return S * Sk
    if causal:
        w = S if window is None else min(window, S)
        return w * (w + 1) // 2 + (S - w) * w
    over = max(0, S - window)                 # rows that lose keys on the left
    return S * Sk - over * (over + 1) // 2


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def work(name: str, args) -> tuple:
    """(bytes, operations) of one kernel call on these arguments."""
    if name == "per_client_sign_align":
        u, r = args
        C, n = u.shape[0], u.shape[1] * u.shape[2]
        return _bytes(u, r) + 4 * C, 2 * C * n
    if name == "sign_align_counts":
        g, r = args
        return _bytes(g, r) + 4, 2 * g.numel()
    if name == "masked_agg":
        u, w = args
        return _bytes(u, w) + 4 * u[0].numel(), 2 * u.numel()
    if name == "fused_update":
        p, u, w_lr = args
        return 2 * _bytes(p) + _bytes(u, w_lr), 2 * u.numel() + p.numel()
    if name == "quantize_q8":
        (x,) = args
        return 5 * x.numel() + 4 * x.shape[0], 5 * x.numel()
    if name == "dequantize_q8":
        q, scale = args
        return 5 * q.numel() + _bytes(scale), q.numel()
    if name == "ef_round_trip":
        d, _e = args
        return 16 * d.numel(), 8 * d.numel()
    if name == "cohort_gather":
        src, idx = args
        return 2 * idx.shape[0] * src[0].numel() * 4 + _bytes(idx), 0
    if name == "flash_attention":
        q, k, v, causal, window, _out_dtype = args
        B, S, H, hd = q.shape
        Sk, K = k.shape[1], k.shape[2]
        nbytes = (2 * B * S * H + 2 * B * Sk * K) * hd * q.element_size()
        return nbytes, 4 * hd * B * H * kept_pairs(S, Sk, causal, window)
    raise KeyError(f"no kernel named {name!r}")
