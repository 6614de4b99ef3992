"""Momentum SGD: the paper's local-training optimizer.

``sgd(lr, momentum)`` returns an ``Optimizer`` pair of plain functions
over parameter dicts, as the JAX package's ``optim.adamw.sgd`` does:
``init(params) -> state`` and ``update(grads, state, params, lr_now=None)
-> (new_params, new_state)``, all arithmetic in f32; ``lr_now`` (a number
or a 0-dim tensor, e.g. an LR schedule's value) replaces ``lr`` for that
step. The dicts may carry a leading client axis; every operation is
elementwise. ``momentum=0.0`` still computes 0·m + g, as the JAX package
does, so a NaN or Inf in the state propagates the same way.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def sgd(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mom": {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()}}

    def update(grads, state, params, lr_now=None):
        step_lr = lr if lr_now is None else lr_now
        mom, new = {}, {}
        for k, p in params.items():
            m = momentum * state["mom"][k] + grads[k].to(torch.float32)
            mom[k] = m
            new[k] = (p.to(torch.float32) - step_lr * m).to(p.dtype)
        return new, {"mom": mom}

    return Optimizer(init, update)
