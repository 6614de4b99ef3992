"""The paper's own anomaly-detection model: 3-layer MLP (256, 128, 64).

ReLU activations and a softmax over the attack classes (UNSW-NB15: 10
classes; ROAD binary). Parameters are a dict ``{"w0", "b0", ...}`` with
the JAX package's names and layouts (``w{i}`` is (in, out)). Every
function also takes a cohort of parameter sets with a leading client
axis C (``w{i}`` (C, in, out), ``b{i}`` (C, out)) and inputs (C, B, F);
the products are then batched matrix products over the cohort.

The config's dropout (p = 0.3) is not applied: the federated training
path calls the loss without a random key, so it trains without dropout
in both packages.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import layers as L


def init_params(generator: torch.Generator, cfg,
                device="cpu") -> Dict[str, torch.Tensor]:
    dims = (cfg.num_features,) + tuple(cfg.mlp_hidden) + (cfg.num_classes,)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = L.dense_init(generator, (a, b)).to(device)
        params[f"b{i}"] = torch.zeros((b,), dtype=torch.float32, device=device)
    return params


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg) -> torch.Tensor:
    n = len(cfg.mlp_hidden) + 1
    for i in range(n):
        w, b = params[f"w{i}"], params[f"b{i}"]
        x = torch.matmul(x, w) + (b.unsqueeze(-2) if b.dim() == 2 else b)
        if i < n - 1:
            x = torch.relu(x)
    return x


def loss_fn(params, batch, cfg) -> torch.Tensor:
    """Mean cross-entropy over the batch axis: a scalar for one parameter
    set, (C,) for a cohort."""
    logits = forward(params, batch["x"], cfg)
    return L.nll(logits, batch["y"]).mean(dim=-1)


def accuracy(params, batch, cfg) -> torch.Tensor:
    logits = forward(params, batch["x"], cfg)
    return (torch.argmax(logits, dim=-1) == batch["y"]).to(
        torch.float32).mean(dim=-1)


def predict(params, x: torch.Tensor, cfg) -> torch.Tensor:
    return torch.softmax(forward(params, x, cfg), dim=-1)


def auc_roc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary AUC via the Mann-Whitney identity (rank statistic).

    scores: (N,) anomaly score; labels: (N,) in {0, 1}. Ranks are ordinal,
    from a stable sort, as the JAX package's code computes them (its
    ``jnp.argsort`` is stable): tied scores take consecutive ranks in index
    order, not their average."""
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(scores)
    ranks[order] = torch.arange(1, scores.shape[0] + 1, dtype=scores.dtype,
                                device=scores.device)
    pos = labels.to(scores.dtype)
    n_pos = pos.sum()
    n_neg = pos.shape[0] - n_pos
    u = ranks @ pos - n_pos * (n_pos + 1) / 2.0
    return u / torch.clamp_min(n_pos * n_neg, 1.0)
