"""Momentum SGD: the paper's local-training optimizer.

``sgd(lr, momentum)`` returns an ``Optimizer`` pair of plain functions
over parameter dicts, as the JAX package's ``optim.adamw.sgd`` does:
``init(params) -> state`` and ``update(grads, state, params) ->
(new_params, new_state)``, all arithmetic in f32. The dicts may carry a
leading client axis; every operation is elementwise.
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

    def update(grads, state, params):
        mom, new = {}, {}
        for k, p in params.items():
            m = momentum * state["mom"][k] + grads[k].to(torch.float32)
            mom[k] = m
            new[k] = (p.to(torch.float32) - lr * m).to(p.dtype)
        return new, {"mom": mom}

    return Optimizer(init, update)
