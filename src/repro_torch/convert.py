"""Carry parameters across from the JAX package.

JAX's threefry bits cannot be reproduced in torch, so a run that must
match the JAX package starts from the JAX simulation's own initial
parameters: ``params_from_jax`` turns its parameter dict, as numpy
arrays, into the port's dict of f32 tensors (same names, same layouts).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(tree: Dict[str, object], device=None
                    ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
            for k, v in tree.items()}
