"""Optimizers: (init, update) pairs of plain functions over parameter
nests, as the JAX package's ``optim.adamw`` has them.

``adamw``     — f32 moments and, with ``keep_master``, f32 master weights
                in the state (the parameters may be bf16).
``adafactor`` — factored second moments (row and column means for every
                leaf of rank ≥ 2), no first moment, no master copy.
``sgd``       — momentum SGD, the paper's local-training optimizer.

``init(params) -> state`` and ``update(grads, state, params, lr_now=None)
-> (new_params, new_state)``; parameters are dicts (nested for the
language models), all arithmetic is f32 in the JAX package's order, and
the returned parameters are cast back to their dtypes. ``lr_now`` (a
number or a 0-dim tensor, e.g. an LR schedule's value) replaces ``lr``
for that step. The dicts may carry a leading client axis: every
operation but adafactor's means is elementwise. ``momentum=0.0`` still
computes 0·m + g, as the JAX package does, so a NaN or Inf in the state
propagates the same way. A step counter or bias correction is computed on
the counter's device: an update reads nothing back to the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map, unzip

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def f32_pow(base, expo):
    """``base ** expo`` in f32, correctly rounded: the power taken in f64
    and rounded once (XLA's f32 power, which the JAX package takes, is
    correctly rounded but for rare one-ulp cases; torch's f32 power is
    not everywhere). Either side may be a number or a tensor."""
    if torch.is_tensor(base):
        base = base.double()
    else:
        base = float(np.float32(base))
    if torch.is_tensor(expo):
        expo = expo.double()
    else:
        expo = float(np.float32(expo))
    return torch.pow(base, expo).to(F32)


def _counter(params) -> torch.Tensor:
    dev = next(iter(leaves(params))).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _cast_like(new, old):
    return tree_map(lambda n, o: n.to(o.dtype), new, old)


# --------------------------------------------------------------------------
# AdamW (with master weights)
# --------------------------------------------------------------------------

def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          keep_master=True) -> Optimizer:
    def init(params):
        f32 = lambda p: torch.zeros_like(p, dtype=F32)
        state = {"m": tree_map(f32, params), "v": tree_map(f32, params),
                 "count": _counter(params)}
        if keep_master:
            state["master"] = tree_map(
                lambda p: p.detach().to(F32, copy=True), params)
        return state

    def update(grads, state, params, lr_now=None):
        step_lr = lr if lr_now is None else lr_now
        c = state["count"] + 1
        bc1 = 1.0 - f32_pow(b1, c)
        bc2 = 1.0 - f32_pow(b2, c)
        ref = state.get("master", params)

        def upd(g, m, v, p):
            g = g.to(F32)
            pf = p.to(F32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = step_lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = pf - step - step_lr * weight_decay * pf
            return m, v, pf

        m, v, pf = unzip(tree_map(upd, grads, state["m"], state["v"], ref),
                         3)
        new_state = {"m": m, "v": v, "count": c}
        if keep_master:
            new_state["master"] = pf
        return _cast_like(pf, params), new_state

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moment)
# --------------------------------------------------------------------------

def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_threshold=1.0
              ) -> Optimizer:
    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def per_leaf(p):
            if _factored(p.shape):
                return {"r": torch.zeros(p.shape[:-1], dtype=F32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=F32, device=p.device)}
            return {"v": torch.zeros_like(p, dtype=F32)}
        return {"stats": tree_map(per_leaf, params),
                "count": _counter(params)}

    def update(grads, state, params, lr_now=None):
        step_lr = lr if lr_now is None else lr_now
        c = state["count"] + 1
        beta = 1.0 - f32_pow(c.to(F32), -decay)

        def upd(g, st, p):
            g = g.to(F32)
            g2 = g * g + eps
            if _factored(p.shape):
                r = beta * st["r"] + (1 - beta) * g2.mean(-1)
                cc = beta * st["c"] + (1 - beta) * g2.mean(-2)
                denom = (r[..., None] * cc[..., None, :]
                         / torch.clamp_min(r.mean(-1)[..., None, None], eps))
                u = g * torch.rsqrt(torch.clamp_min(denom, eps))
                new_st = {"r": r, "c": cc}
            else:
                v = beta * st["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp_min(v, eps))
                new_st = {"v": v}
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            pf = p.to(F32) - step_lr * u
            return new_st, pf

        stats, pf = unzip(tree_map(upd, grads, state["stats"], params), 2)
        return _cast_like(pf, params), {"stats": stats, "count": c}

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# SGD (momentum)
# --------------------------------------------------------------------------

def sgd(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mom": tree_map(lambda p: torch.zeros_like(p, dtype=F32),
                                params)}

    def update(grads, state, params, lr_now=None):
        step_lr = lr if lr_now is None else lr_now

        def upd(g, m, p):
            m = momentum * m + g.to(F32)
            return m, (p.to(F32) - step_lr * m).to(p.dtype)

        mom, new = unzip(tree_map(upd, grads, state["mom"], params), 2)
        return new, {"mom": mom}

    return Optimizer(init, update)


def for_config(cfg, lr=1e-3) -> Optimizer:
    """The config's optimizer: adafactor where it names it (the large
    archs), else adamw with f32 master weights unless the weights are
    f32 already."""
    if cfg.optimizer == "adafactor":
        return adafactor(lr)
    return adamw(lr, keep_master=(cfg.dtype != "float32"))
