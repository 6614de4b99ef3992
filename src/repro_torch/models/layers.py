"""Layer primitives the mlp family uses: initialiser and loss."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale: float = 1.0) -> torch.Tensor:
    """normal · scale/√fan_in, drawn on the CPU from ``generator`` (the
    distribution of the JAX package's ``dense_init``; the bits differ)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    return (torch.randn(shape, generator=generator, dtype=torch.float32)
            * std).to(dtype)


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy; logits (..., V), labels int64
    (...). The loss is computed in f32. The gold logit is a masked sum,
    as in the JAX package, not a gather: a gather's backward on the card
    scatters with atomics, in an order that changes from run to run."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    idx = torch.arange(lf.shape[-1], device=lf.device)
    gold = torch.where(idx == labels.unsqueeze(-1), lf, 0.0).sum(dim=-1)
    return lse - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every example."""
    return nll(logits, labels).mean()
