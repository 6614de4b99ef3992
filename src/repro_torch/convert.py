"""Carry state across from the JAX package.

JAX's threefry bits cannot be reproduced in torch, so a run that must
match the JAX package starts from the JAX simulation's own initial
parameters: ``params_from_jax`` turns its parameter dict, as numpy
arrays, into the port's dict of f32 tensors (same names, same layouts).
``control_from_jax`` does the same for a scanned run's ``ControlState``,
so both packages can step one round from the same mid-run state, and
``fl_state_from_jax`` for the spmd step's whole ``FLState`` (parameters,
optimizer state, reference sign, control state, step, counters, scenario
world and topology state; ``topology_from_jax`` for the last alone), ``lm_params_from_jax`` for a
language model's nested parameter tree and ``opt_state_from_jax`` for an
optimizer's state (adamw, adafactor or sgd), so both packages can train
on from one mid-run state.

A JAX run's mid-run state continues in the port: ``sim_state_from_jax``
turns the JAX ``FederatedSimulation.state_dict()`` of the loop or the
megastep path into the port's ``load_state_dict`` input, and
``spmd_state_from_jax`` the JAX ``SpmdDriver.state_dict()``. The numpy
Generator positions carry over as they are, so selection, dropout and
batch draws go on as in the JAX run.
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


def opt_state_from_jax(state, device=None):
    """An optimizer's state from the JAX package's (a nested dict of numpy
    arrays): adamw's ``m``, ``v``, ``master`` and adafactor's ``stats``
    (``r``, ``c`` or ``v`` a leaf) as f32 tensors, sgd's ``mom`` too, and
    the step counter ``count`` as a 0-dim int32."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, dtype=torch.int32, device=dev)
        if a.dtype != np.float32:
            raise TypeError(f"expected f32 optimizer state; got {a.dtype}")
        return torch.tensor(a, device=dev)

    if isinstance(state, dict):
        return {k: opt_state_from_jax(v, dev) for k, v in state.items()}
    return leaf(state)


def _is_nested(tree) -> bool:
    return any(isinstance(v, dict) for v in tree.values())


def topology_from_jax(state, device=None):
    """A ``TopologyState`` from the JAX package's (its fields as numpy
    arrays): f32 accumulators and accounting, int8 reference signs, bool
    ``has_ref``, int32 sync counts."""
    from repro_torch.topology.engine import TopologyState
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return TopologyState(
        accum=tuple(t(a, torch.float32) for a in state.accum),
        ref=tuple(t(a, torch.int8) for a in state.ref),
        has_ref=tuple(t(a, torch.bool) for a in state.has_ref),
        tier_bytes=t(state.tier_bytes, torch.float32),
        tier_time=t(state.tier_time, torch.float32),
        syncs=t(state.syncs, torch.int32),
        accepts=t(state.accepts, torch.float32),
        vetoes=t(state.vetoes, torch.float32))


def fl_state_from_jax(state, device=None):
    """The spmd step's ``FLState`` from the JAX package's (its fields as
    numpy arrays, e.g. ``jax.device_get(state)``), its scenario ``world``
    and ``topology`` included; a language model's nested weights keep
    their dtypes."""
    from repro_torch.core.fl_step import FLState
    from repro_torch.core.scenario import WorldState
    dev = resolve_device(device)
    topology = getattr(state, "topology", None)
    if topology is not None:
        topology = topology_from_jax(topology, dev)
    control = (None if state.control is None
               else control_from_jax(state.control._asdict(), dev))
    world = getattr(state, "world", None)
    if world is not None:
        world = WorldState(**{
            f: torch.tensor(np.asarray(v), device=dev,
                            dtype=torch.bool if f == "live" else torch.float32)
            for f, v in world._asdict().items()})
    params = (lm_params_from_jax(state.params, dev)
              if _is_nested(state.params)
              else params_from_jax(state.params, dev))
    return FLState(params=params,
                   opt_state=opt_state_from_jax(state.opt_state, dev),
                   ref_sign=_tensors(state.ref_sign, dev, torch.int8),
                   step=_tensors(state.step, dev, torch.int32),
                   metrics=_tensors(state.metrics, dev, torch.float32),
                   control=control, world=world, topology=topology)


def _scalar(x):
    """A numpy or JAX scalar as the Python number it holds."""
    return x.item() if hasattr(x, "item") else x


def _world_view(ws) -> dict:
    """The JAX package's ``WorldState`` (numpy fields) as the port's host
    view of it (``scenario.host_view``'s dict)."""
    return {"live": np.asarray(ws.live, bool),
            "bw_scale": np.asarray(ws.bw_scale, np.float32),
            "lat_scale": np.asarray(ws.lat_scale, np.float32),
            "drift_amp": float(ws.drift_amp),
            "dropout_scale": float(ws.dropout_scale),
            "byz_factor": np.asarray(ws.byz_factor, np.float32)}


def sim_state_from_jax(state: dict, device=None) -> dict:
    """The port's ``FederatedSimulation.load_state_dict`` input from the JAX
    package's ``state_dict()`` of a loop or megastep run (its arrays as
    numpy, as ``jax.device_get`` gives them).

    The scanned path cannot carry over: the JAX package draws its rounds
    from a PRNG key the port cannot replay (core/draws.py), so a state with
    a scanned ``ctl`` is refused and the key is dropped. A scanned run's
    control state crosses with ``control_from_jax`` and
    ``FederatedSimulation.load_scan_carry`` instead. The port's own θ-test
    log and cohort list start empty."""
    dev = resolve_device(device)
    scan = state.get("scan") or {}
    if scan.get("ctl") is not None:
        raise ValueError(
            "the JAX state comes from the scanned path (its scan carry has "
            "a ControlState); its draws come from a PRNG key the port cannot "
            "replay. Carry the control state with control_from_jax and "
            "FederatedSimulation.load_scan_carry instead")

    def t(a, dtype):
        return None if a is None else torch.tensor(np.asarray(a),
                                                   dtype=dtype, device=dev)

    def tree(d, dtype):
        return None if d is None else {k: t(v, dtype) for k, v in d.items()}

    wire = state["wire_bytes"]
    return {
        **{k: state[k] for k in (
            "round_idx", "rng", "loaders", "selector", "batch_assignment",
            "failure_log", "checkpoints", "ckpt_interval", "sim_time",
            "comm_time", "idle_time", "bytes_sent", "server_step",
            "dispatches", "history")},
        "client_lr_scale": np.array(state["client_lr_scale"]),
        "grad_norms": np.array(state["grad_norms"]),
        "ef_state": {int(cid): tree(e, torch.float32)
                     for cid, e in state["ef_state"].items()},
        "ef_arena": t(state["ef_arena"], torch.float32),
        "wire_bytes": None if wire is None else int(_scalar(wire)),
        "params_mat": t(state["params_mat"], torch.float32),
        "params_tree": tree(state["params_tree"], torch.float32),
        "ref_mat": t(state["ref_mat"], torch.int8),
        "ref_sign": tree(state["ref_sign"], torch.int8),
        "world_state": (None if state.get("world_state") is None
                        else _world_view(state["world_state"])),
        "topology": (None if state.get("topology") is None
                     else topology_from_jax(state["topology"], dev)),
        "scan": None,
        "theta_ratios": [],
        "cohorts": [],
    }


def spmd_state_from_jax(state: dict, device=None) -> dict:
    """The port's ``SpmdDriver.load_state_dict`` input from the JAX
    package's ``SpmdDriver.state_dict()`` (its ``FLState`` as numpy, through
    ``fl_state_from_jax``; the loaders' Generator positions as they are).
    The port's own θ-test log starts empty."""
    return {"round_idx": int(state["round_idx"]),
            "fl_state": fl_state_from_jax(state["fl_state"], device),
            "loaders": list(state["loaders"]),
            "acc": dict(state["acc"]),
            "last_accuracy": float(state["last_accuracy"]),
            "theta_ratios": []}
