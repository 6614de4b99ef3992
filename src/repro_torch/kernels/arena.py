"""Flat parameter arena: the (rows, LANE) f32 layout that the cohort step
and the two arena kernels share.

``ParamArena`` packs a parameter nest ONCE into a lane-aligned matrix,
in the JAX package's leaf order (dict keys sorted at every level), so
that every hot reduction runs over one buffer:

  * per-client sign-alignment counts    (kernels/sign_align.py)
  * weighted cohort aggregation, and the same sum applied to the
    parameters in one pass              (kernels/masked_agg.py)
  * per-row int8 quantization and its inverse, the wire codec of error
    feedback                            (kernels/quantize.py)
  * the cohort gather of per-client slabs (the scanned path's
    error-feedback fetch)               (kernels/gather.py)

Values pad with 0; reference signs pad with the -2 sentinel, so padded
slots never count as aligned (a sign is -1, 0 or 1).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch import dist as _dist
from repro_torch.kernels import gather as _gather
from repro_torch.kernels import masked_agg as _agg
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sign_align as _sa

LANE = _sa.LANE


class ParamArena:
    """Static layout of one parameter nest in the (rows, LANE) arena.

    Built from a template nest of dicts of tensors or arrays (flat for the
    mlp, nested for the language models); only paths, shapes and dtypes
    are read. Leaves are laid out in the JAX package's order (keys sorted
    at every level); ``names`` are their paths joined by "/" (a flat
    dict's keys as they are)."""

    def __init__(self, template: Dict[str, object], lane: int = LANE):
        named = _tree.named_leaves(template)
        self.paths = tuple(p for p, _ in named)
        self.names = tuple("/".join(map(str, p)) for p in self.paths)
        self.shapes = tuple(tuple(l.shape) for _, l in named)
        self.dtypes = tuple(_torch_dtype(l.dtype) for _, l in named)
        self.sizes = tuple(math.prod(s) for s in self.shapes)
        self.n = int(sum(self.sizes))
        self.lane = int(lane)
        self.rows = max(-(-self.n // self.lane), 1)
        self.pad = self.rows * self.lane - self.n

    def leaves(self, tree) -> list:
        """The nest's leaves in the arena's order."""
        return [_tree.get(tree, p) for p in self.paths]

    # ------------------------------------------------------------------
    # pack / unpack
    # ------------------------------------------------------------------
    def pack(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """nest -> (rows, lane) f32, zero-padded."""
        return self.pack_cohort(_tree.tree_map(lambda v: v[None], params))[0]

    def pack_cohort(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """nest with leading client dim C -> (C, rows, lane) f32."""
        leaves = self.leaves(params)
        C = leaves[0].shape[0]
        flat = [v.reshape(C, -1).to(torch.float32) for v in leaves]
        flat.append(torch.zeros((C, self.pad), dtype=torch.float32,
                                device=leaves[0].device))
        return torch.cat(flat, dim=1).reshape(C, self.rows, self.lane)

    def pack_into(self, out: torch.Tensor, params) -> None:
        """Write one nest (no client dim) into ``out``, a (rows, lane) f32
        slab (e.g. one client's row of a cohort arena), leaf by leaf in
        place: each leaf converted to f32 as ``pack`` converts it, the
        padding zeroed. Nothing of the arena's size is allocated."""
        flat = out.view(-1)
        off = 0
        for v, size in zip(self.leaves(params), self.sizes):
            flat[off:off + size].copy_(v.reshape(-1))
            off += size
        flat[off:].zero_()

    def unpack(self, mat: torch.Tensor, dtype=None) -> Dict[str, torch.Tensor]:
        """(rows, lane) -> nest; leaves cast to the template dtypes, or to
        one override ``dtype`` (f32 for gradient math). A leaf whose dtype
        is already the target is a view into ``mat``."""
        flat = mat.reshape(-1)
        out, off = [], 0
        for shape, dt, size in zip(self.shapes, self.dtypes, self.sizes):
            out.append(flat[off:off + size].reshape(shape).to(dtype or dt))
            off += size
        return _tree.from_paths(self.paths, out)

    def unpack_cohort(self, mat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(C, rows, lane) -> nest with leading client dim C."""
        C = mat.shape[0]
        flat = mat.reshape(C, -1)
        out, off = [], 0
        for shape, size in zip(self.shapes, self.sizes):
            out.append(flat[:, off:off + size].reshape((C,) + shape))
            off += size
        return _tree.from_paths(self.paths, out)

    # ------------------------------------------------------------------
    # reference-sign helpers
    # ------------------------------------------------------------------
    def valid_mask(self) -> np.ndarray:
        """(rows, lane) bool host constant; True on real (unpadded) slots."""
        idx = np.arange(self.rows * self.lane)
        return (idx < self.n).reshape(self.rows, self.lane)

    def sign_ref(self, new_mat: torch.Tensor,
                 old_mat: torch.Tensor) -> torch.Tensor:
        """int8 sign of the global movement, -2 sentinel on padding."""
        sign = _ref.sign(new_mat - old_mat).reshape(-1)
        sign[self.n:] = -2
        return sign.reshape(self.rows, self.lane)

    def pack_signs(self, signs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """int8 sign nest -> (rows, lane) with the -2 padding sentinel."""
        leaves = self.leaves(signs)
        flat = [v.reshape(-1).to(torch.int8) for v in leaves]
        flat.append(torch.full((self.pad,), -2, dtype=torch.int8,
                               device=leaves[0].device))
        return torch.cat(flat).reshape(self.rows, self.lane)


def _torch_dtype(dtype) -> torch.dtype:
    """A tensor's or an array's dtype as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if np.dtype(dtype).name == "bfloat16":       # ml_dtypes' bfloat16
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


# ---------------------------------------------------------------------------
# cohort ops over the arena (the tensor's device picks kernel or plain)
# ---------------------------------------------------------------------------

def cohort_sign_align(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """u: (C, rows, lane) f32 updates; r: (rows, lane) int8 reference.
    Returns (C,) aligned counts (divide by the arena's true n for ratios)."""
    return _sa.per_client_sign_align(u, r)


def weighted_sum(u: torch.Tensor, w: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Σ_c w[c]·u[c] over the client axis -> (rows, lane) f32.

    ``compute_dtype`` is the reduction precision of the plain version on
    the CPU: bf16 is one einsum over bf16-rounded inputs, rounded to bf16
    once (what the JAX package's oracle computes, bit for bit). The CUDA
    kernel reduces in f32 whatever it is asked, as the Pallas kernels do.
    DTensors take ``kernels/sharded.py``'s rule (a local sum, then one
    all-reduce over the clients' mesh dims).
    """
    if _dist.is_dtensor(u, w):
        from repro_torch.kernels import sharded
        return sharded.weighted_sum(u, w, compute_dtype)
    if u.device.type == "cpu" and compute_dtype != torch.float32:
        return torch.einsum("crl,c->rl", u.to(compute_dtype),
                            w.to(compute_dtype)).to(torch.float32)
    return _agg.masked_agg(u, w)


def fused_apply(p: torch.Tensor, u: torch.Tensor,
                w_lr: torch.Tensor) -> torch.Tensor:
    """p − Σ_c w_lr[c]·u[c] (aggregation and apply in one pass, p's dtype
    kept)."""
    return _agg.fused_update(p, u, w_lr)


def cohort_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src: (N, rows, lane) f32 per-client slabs, idx: (K,) int64 client
    ids -> (K, rows, lane), row k the slab of client idx[k].

    The JAX package's ``onehot_gather`` (``src/repro/kernels/gather.py``):
    it takes a one-hot (K, N) matrix where this takes the ids."""
    return _gather.cohort_gather(src, idx)
