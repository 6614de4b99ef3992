"""One client's update in the (R, LANE) layout, and the int8 wire codec
over it (the part of the JAX package's ``kernels/ops.py`` that the
per-client loop uses).

Parameter dicts are flattened in sorted key order, the JAX package's leaf
order, into a zero-padded (R, LANE) f32 matrix; the codec calls go to
``kernels/quantize.py``, where the tensor's device picks kernel or plain
version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import quantize as _qz

LANE = _qz.LANE


def flatten_to_lanes(tree: Dict[str, torch.Tensor], lane: int = LANE):
    """dict -> ((R, lane) f32 matrix, zero-padded; true element count)."""
    flat = torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in sorted(tree)])
    n = flat.numel()
    rows = max(-(-n // lane), 1)
    flat = torch.nn.functional.pad(flat, (0, rows * lane - n))
    return flat.reshape(rows, lane), n


def unflatten_from_lanes(mat: torch.Tensor, like: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of ``flatten_to_lanes`` into the shapes and dtypes of
    ``like``."""
    flat = mat.reshape(-1)
    out, off = {}, 0
    for k in sorted(like):
        ref = like[k]
        out[k] = flat[off:off + ref.numel()].reshape(ref.shape).to(ref.dtype)
        off += ref.numel()
    return out


def quantize_tree(tree: Dict[str, torch.Tensor]):
    """dict -> (q int8 (R, LANE), scales f32 (R, 1), true element count)."""
    mat, n = flatten_to_lanes(tree)
    q, s = _qz.quantize_q8(mat)
    return q, s, n


def dequantize_tree(q: torch.Tensor, s: torch.Tensor,
                    like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return unflatten_from_lanes(_qz.dequantize_q8(q, s), like)
