"""Public wrappers over the kernels for parameter dicts: the (R, LANE)
layout, its padding, and ratio / aggregation conveniences (the JAX
package's ``kernels/ops.py``).

Parameter dicts (nests of dicts for the language models) are flattened
with their keys sorted at every level, the JAX package's leaf order, into
a zero-padded (R, LANE) f32 matrix; reference signs pad with the -2
sentinel, which no sign matches. Every call goes to the kernel
modules, where the tensor's device picks the CUDA kernel or the plain
version; the JAX wrappers' ``interpret`` argument has no counterpart. The
dicts are cast to f32 on the way in, so these calls send f32 to the
kernels; the kernels' bf16 inputs are reached by calling them directly.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import tree as _tree
from repro_torch.kernels import masked_agg as _agg
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import sign_align as _sa

LANE = _qz.LANE


def flatten_to_lanes(tree: Dict[str, torch.Tensor], lane: int = LANE):
    """dict (or nest of dicts) -> ((R, lane) f32 matrix, zero-padded; true
    element count)."""
    flat = torch.cat([v.reshape(-1).to(torch.float32)
                      for v in _tree.leaves(tree)])
    n = flat.numel()
    rows = max(-(-n // lane), 1)
    flat = torch.nn.functional.pad(flat, (0, rows * lane - n))
    return flat.reshape(rows, lane), n


def unflatten_from_lanes(mat: torch.Tensor, like: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of ``flatten_to_lanes`` into the nest, shapes and dtypes
    of ``like``."""
    flat = mat.reshape(-1)
    paths, out, off = [], [], 0
    for path, ref in _tree.named_leaves(like):
        paths.append(path)
        out.append(flat[off:off + ref.numel()].reshape(ref.shape).to(ref.dtype))
        off += ref.numel()
    return _tree.from_paths(paths, out)


def ref_sign_lanes(ref_sign_tree: Dict[str, torch.Tensor],
                   lane: int = LANE) -> torch.Tensor:
    """int8 sign dict (or nest) -> (R, lane) int8 with the -2 padding
    sentinel."""
    flat = torch.cat([v.reshape(-1).to(torch.int8)
                      for v in _tree.leaves(ref_sign_tree)])
    n = flat.numel()
    rows = max(-(-n // lane), 1)
    flat = torch.nn.functional.pad(flat, (0, rows * lane - n), value=-2)
    return flat.reshape(rows, lane)


def _client(stacked: Dict[str, torch.Tensor], i: int):
    return {k: v[i] for k, v in stacked.items()}


def _num_clients(stacked: Dict[str, torch.Tensor]) -> int:
    return next(iter(stacked.values())).shape[0]


def _ratio(count: torch.Tensor, n: int) -> torch.Tensor:
    """count / max(n, 1) in f32, divided by a tensor on count's device
    (a division by a Python number multiplies by its reciprocal on the
    card)."""
    return count / count.new_full((), float(max(n, 1)))


def sign_align_ratio(update_tree: Dict[str, torch.Tensor],
                     ref_sign_tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Kernel-backed Algorithm-1 relevance of one client's update: a 0-dim
    f32 tensor."""
    g, n = flatten_to_lanes(update_tree)
    r = ref_sign_lanes(ref_sign_tree)
    return _ratio(_sa.sign_align_counts(g, r), n)


def per_client_sign_align_ratio(stacked_updates: Dict[str, torch.Tensor],
                                ref_sign_tree: Dict[str, torch.Tensor]
                                ) -> torch.Tensor:
    """stacked_updates: dict with leading client dim C -> (C,) ratios."""
    mats = [flatten_to_lanes(_client(stacked_updates, i))
            for i in range(_num_clients(stacked_updates))]
    u = torch.stack([m for m, _ in mats])                # (C, R, LANE)
    r = ref_sign_lanes(ref_sign_tree)
    return _ratio(_sa.per_client_sign_align(u, r), mats[0][1])


def _weights(mask: torch.Tensor, weights: Optional[torch.Tensor]):
    w = mask if weights is None else mask * weights
    return w, torch.clamp_min(w.sum(), 1e-9)


def masked_aggregate(stacked_updates: Dict[str, torch.Tensor],
                     mask: torch.Tensor,
                     weights: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Kernel-backed masked mean over the client axis: a dict shaped like
    one client's update, leaves cast back to the input dtypes."""
    w, total = _weights(mask, weights)
    C = _num_clients(stacked_updates)
    u = torch.stack([flatten_to_lanes(_client(stacked_updates, i))[0]
                     for i in range(C)])
    out = _agg.masked_agg(u, (w / total).to(torch.float32))
    return unflatten_from_lanes(out, _client(stacked_updates, 0))


def fused_selective_update(params: Dict[str, torch.Tensor],
                           stacked_updates: Dict[str, torch.Tensor],
                           mask: torch.Tensor, lr,
                           weights: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
    """params − lr · masked_mean(updates), aggregation and apply in one
    kernel pass; w_lr = lr·w / max(Σw, 1e-9), left to right."""
    w, total = _weights(mask, weights)
    w_lr = (lr * w / total).to(torch.float32)
    p_mat, _ = flatten_to_lanes(params)
    C = _num_clients(stacked_updates)
    u = torch.stack([flatten_to_lanes(_client(stacked_updates, i))[0]
                     for i in range(C)])
    return unflatten_from_lanes(_agg.fused_update(p_mat, u, w_lr), params)


def quantize_tree(tree: Dict[str, torch.Tensor]):
    """dict -> (q int8 (R, LANE), scales f32 (R, 1), true element count)."""
    mat, n = flatten_to_lanes(tree)
    q, s = _qz.quantize_q8(mat)
    return q, s, n


def dequantize_tree(q: torch.Tensor, s: torch.Tensor,
                    like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return unflatten_from_lanes(_qz.dequantize_q8(q, s), like)
