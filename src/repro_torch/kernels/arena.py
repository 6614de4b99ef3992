"""Flat parameter arena: the (rows, LANE) f32 layout that the cohort step
and the two arena kernels share.

``ParamArena`` packs a parameter dict ONCE into a lane-aligned matrix,
in the JAX package's leaf order (dict keys sorted), so that every hot
reduction runs over one buffer:

  * per-client sign-alignment counts    (kernels/sign_align.py)
  * weighted cohort aggregation         (kernels/masked_agg.py)

Values pad with 0; reference signs pad with the -2 sentinel, so padded
slots never count as aligned (a sign is -1, 0 or 1).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import masked_agg as _agg
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sign_align as _sa

LANE = _sa.LANE


class ParamArena:
    """Static layout of one parameter dict in the (rows, LANE) arena.

    Built from a template dict of tensors or arrays; only names, shapes
    and dtypes are read."""

    def __init__(self, template: Dict[str, object], lane: int = LANE):
        self.names = tuple(sorted(template))
        self.shapes = tuple(tuple(template[k].shape) for k in self.names)
        self.sizes = tuple(math.prod(s) for s in self.shapes)
        self.n = int(sum(self.sizes))
        self.lane = int(lane)
        self.rows = max(-(-self.n // self.lane), 1)
        self.pad = self.rows * self.lane - self.n

    # ------------------------------------------------------------------
    # pack / unpack
    # ------------------------------------------------------------------
    def pack(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """dict -> (rows, lane) f32, zero-padded."""
        return self.pack_cohort({k: v[None] for k, v in params.items()})[0]

    def pack_cohort(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """dict with leading client dim C -> (C, rows, lane) f32."""
        first = params[self.names[0]]
        C = first.shape[0]
        flat = [params[k].reshape(C, -1).to(torch.float32) for k in self.names]
        flat.append(torch.zeros((C, self.pad), dtype=torch.float32,
                                device=first.device))
        return torch.cat(flat, dim=1).reshape(C, self.rows, self.lane)

    def unpack(self, mat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(rows, lane) -> dict of views into ``mat``."""
        flat = mat.reshape(-1)
        out, off = {}, 0
        for k, shape, size in zip(self.names, self.shapes, self.sizes):
            out[k] = flat[off:off + size].reshape(shape)
            off += size
        return out

    def unpack_cohort(self, mat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(C, rows, lane) -> dict with leading client dim C."""
        C = mat.shape[0]
        flat = mat.reshape(C, -1)
        out, off = {}, 0
        for k, shape, size in zip(self.names, self.shapes, self.sizes):
            out[k] = flat[:, off:off + size].reshape((C,) + shape)
            off += size
        return out

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


# ---------------------------------------------------------------------------
# cohort ops over the arena (the tensor's device picks kernel or plain)
# ---------------------------------------------------------------------------

def cohort_sign_align(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """u: (C, rows, lane) f32 updates; r: (rows, lane) int8 reference.
    Returns (C,) aligned counts (divide by the arena's true n for ratios)."""
    return _sa.per_client_sign_align(u, r)


def weighted_sum(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_c w[c]·u[c] over the client axis -> (rows, lane) f32."""
    return _agg.masked_agg(u, w)
