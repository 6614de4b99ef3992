"""Carry state across from the JAX package.

JAX's threefry bits cannot be reproduced in torch, so a run that must
match the JAX package starts from the JAX simulation's own initial
parameters: ``params_from_jax`` turns its parameter dict, as numpy
arrays, into the port's dict of f32 tensors (same names, same layouts).
``control_from_jax`` does the same for a scanned run's ``ControlState``,
so both packages can step one round from the same mid-run state.
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


def control_from_jax(fields: Dict[str, object], device=None):
    """A ``ControlState`` from the JAX package's, given as a dict of its
    fields as numpy arrays (``state._asdict()``), with the port's dtypes:
    f32 statistics, i32 batch and staleness, bool has_ckpt."""
    from repro_torch.core.control import ControlState
    dev = resolve_device(device)
    dtypes = {"batch": torch.int32, "staleness": torch.int32,
              "has_ckpt": torch.bool}
    return ControlState(**{
        name: torch.tensor(np.asarray(fields[name]),
                           dtype=dtypes.get(name, torch.float32), device=dev)
        for name in ControlState._fields})
