"""Carry state across from the JAX package.

JAX's threefry bits cannot be reproduced in torch, so a run that must
match the JAX package starts from the JAX simulation's own initial
parameters: ``params_from_jax`` turns its parameter dict, as numpy
arrays, into the port's dict of f32 tensors (same names, same layouts).
``control_from_jax`` does the same for a scanned run's ``ControlState``,
so both packages can step one round from the same mid-run state, and
``fl_state_from_jax`` for the spmd step's whole ``FLState`` (parameters,
optimizer state, reference sign, control state, step and counters), and
``lm_params_from_jax`` for a language model's nested parameter tree.
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


def lm_params_from_jax(tree, device=None):
    """A language model's parameters from the JAX package's nested dict of
    numpy arrays, in the same nest and the same dtype: f32 stays f32 and
    bf16 (ml_dtypes' ``bfloat16``) becomes ``torch.bfloat16`` by way of
    f32, which is exact."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, dev) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    if a.dtype != np.float32:
        raise TypeError(f"expected f32 or bf16 parameters; got {a.dtype}")
    return torch.tensor(a, device=dev)


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


def _tensors(tree, device, dtype=None):
    """Nested dict of arrays -> the same dict of tensors: floats as f32,
    integers as int32, unless ``dtype`` names one."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    dt = dtype or (torch.float32 if np.issubdtype(a.dtype, np.floating)
                   else torch.int32)
    return torch.tensor(a, dtype=dt, device=device)


def fl_state_from_jax(state, device=None):
    """The spmd step's ``FLState`` from the JAX package's (its fields as
    numpy arrays, e.g. ``jax.device_get(state)``); the JAX state's
    ``world`` and ``topology`` must be None (not ported)."""
    from repro_torch.core.fl_step import FLState
    if getattr(state, "world", None) is not None or \
            getattr(state, "topology", None) is not None:
        raise NotImplementedError("scenario worlds and topologies are not "
                                  "ported yet; they come with ROADMAP.md "
                                  "queue 1 item 10")
    dev = resolve_device(device)
    control = (None if state.control is None
               else control_from_jax(state.control._asdict(), dev))
    return FLState(params=params_from_jax(state.params, dev),
                   opt_state=_tensors(state.opt_state, dev),
                   ref_sign=_tensors(state.ref_sign, dev, torch.int8),
                   step=_tensors(state.step, dev, torch.int32),
                   metrics=_tensors(state.metrics, dev, torch.float32),
                   control=control)
