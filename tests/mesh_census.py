"""One side of ``test_torch_mesh_census.py``, run in a subprocess:
``python tests/mesh_census.py jax|torch <out.json>``.

Both sides trace smoke qwen2-1.5b's training step (smoke ``train_4k``) and
prefill (smoke ``prefill_32k``) on a 2 × 4 ("data", "model") mesh and
write, for each shape, the matrix-product FLOPs a device, the collective
bytes a device by kind, and the largest products' local shapes:

  * ``jax``: the JAX package's step under ``jax.jit`` with its sharding
    rules, compiled on 8 forced host devices (``XLA_FLAGS``, set by the
    caller: JAX reads it once, at import), counted by ``hlo_census``;
  * ``torch``: the port's ``launch/dryrun.trace_step`` on meta tensors in a
    fake world of 8 ranks (which cannot be torn down in a test worker),
    counted by ``roofline/census.py``.
"""
from __future__ import annotations

import json
import sys

ARCH = "qwen2-1.5b"
SHAPES = ("train_4k", "prefill_32k")
MESH = (2, 4)
AXES = ("data", "model")


def _jax() -> dict:
    import jax
    from repro.configs import registry
    from repro.configs.shapes import SMOKE_SHAPES
    from repro.core import fl_step
    from repro.launch import mesh as mesh_mod
    from repro.launch import sharding
    from repro.models import api
    from repro.optim import adamw as optim_mod
    from repro.roofline import hlo_census
    mesh = mesh_mod._make_mesh(MESH, AXES,
                               devices=jax.devices()[:MESH[0] * MESH[1]])
    named = sharding.to_named
    out = {}
    for name in SHAPES:
        cfg = registry.config_for_shape(ARCH, name, smoke=True)
        shape = SMOKE_SHAPES[name]
        if shape.kind == "train":
            opt = optim_mod.for_config(cfg)
            specs = api.input_specs(
                cfg, shape, num_clients=mesh_mod.num_clients(cfg, mesh))
            state = jax.eval_shape(lambda: fl_step.init_state(
                jax.random.PRNGKey(0), cfg, opt))
            sspec = named(mesh, sharding.state_pspecs(cfg, mesh, opt))
            step = jax.jit(fl_step.make_raw_step(cfg, opt, theta=0.65),
                           in_shardings=(sspec, named(
                               mesh, sharding.train_batch_pspecs(
                                   cfg, mesh, specs["batch"]))),
                           out_shardings=(sspec, None))
            lowered = step.lower(state, specs["batch"])
        else:
            specs = api.input_specs(cfg, shape)
            params = jax.eval_shape(lambda: api.init_params(
                jax.random.PRNGKey(0), cfg))
            step = jax.jit(fl_step.build_prefill_step(cfg), in_shardings=(
                named(mesh, sharding.param_pspecs(cfg, mesh, mode="serve")),
                named(mesh, sharding.infer_batch_pspecs(mesh,
                                                        specs["batch"]))))
            lowered = step.lower(params, specs["batch"])
        st = hlo_census.analyze(lowered.compile().as_text())
        out[name] = {"flops": st["flops"],
                     "collective_bytes": st["collective_bytes"],
                     "per_op_bytes": st["per_op_bytes"]}
    return out


def _torch() -> dict:
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.start_fake_world(MESH[0] * MESH[1])
    mesh = mesh_mod.make_debug_mesh(MESH, AXES)
    out = {}
    for name in SHAPES:
        _, census, _ = dryrun.trace_step(ARCH, name, mesh, smoke=True)
        st = census.analyze()
        out[name] = {"flops": st["flops"],
                     "collective_bytes": st["collective_bytes"],
                     "per_op_bytes": st["per_op_bytes"],
                     "products": sorted(st["flops_by_product"])}
    return out


if __name__ == "__main__":
    side, path = sys.argv[1], sys.argv[2]
    with open(path, "w") as f:
        json.dump(_jax() if side == "jax" else _torch(), f)
