"""Dry run of every (architecture × input shape) on one device or on the
production meshes: the counterpart of the JAX package's
``launch/dryrun.py``.

Each combo builds its weights or training state on the meta device (no
allocation), runs the port's own step on meta inputs (``make_raw_step``
for a training shape, ``build_prefill_step`` for a prefill,
``build_serve_step`` for a decode) under the census
(``roofline/census.py``), prints its memory and cost lines and its
roofline on the H100 (``roofline/analysis.py``) with its largest matrix
products (the census's ``flops_by_product``: on a mesh, the local
products of the layout DTensor chose), and appends the row to a JSONL
results file. The hand-written kernels take their shape-only calls
(``kernels/meta.py``), the ssm and hybrid families' time loops run one
step counted T times.

``--mesh 1x1`` (the default) is one device, as the JAX package's
``make_debug_mesh()``: one chip, one client (C = 1), plain meta tensors.
``--mesh single`` is the 16 × 16 ("data", "model") production mesh,
``multi`` the 2 × 16 × 16 ("pod", "data", "model") one, ``both`` the two,
as in the JAX package; a combo on them runs in a fake world of 512 ranks
(``launch/mesh.py``'s ``start_fake_world``, the counterpart of its forced
512 host devices) on DTensors distributed by ``launch/sharding.py``'s
specs, each count per device (``roofline/census.py``) with the
collectives' bytes by kind and mesh dims. A training combo takes C =
``num_clients(cfg, mesh)``: 16 on single, 32 on multi (arctic: 1 and 2).
A combo that fails is printed among the failures and the run returns 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all, 1x1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single                             # one combo
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both  # meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list     # plan only
"""
from __future__ import annotations

import argparse
import gc
import os
import sys
import time
import traceback

from repro_torch import tree as tree_mod
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import fl_step
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding
from repro_torch.models import api
from repro_torch.optim import adamw as optim_mod
from repro_torch.roofline import analysis
from repro_torch.roofline.census import Census

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch_results.jsonl")
MESH, CHIPS, CLIENTS = "1x1", 1, 1
TOP_PRODUCTS = 8                # the largest matrix products printed a combo
FAKE_WORLD = 512                 # the JAX dry run's forced host devices
MESH_NAMES = {MESH: MESH, "single": "16x16", "multi": "2x16x16"}


def plan(args):
    """(arch, shape, mesh, multi_pod) for every combo asked for; mesh
    ``"1x1"``, or ``"single"`` / ``"multi"`` as the JAX plan names them."""
    combos = []
    archs = [args.arch] if args.arch else registry.ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    which = getattr(args, "mesh", MESH)
    meshes = {MESH: {MESH: False}, "single": {"single": False},
              "multi": {"multi": True},
              "both": {"single": False, "multi": True}}[which]
    for a in archs:
        for s in shapes:
            if s == "long_500k" and a in registry.LONG_CTX_SKIP:
                continue
            for mname, mp in meshes.items():
                combos.append((a, s, mname, mp))
    return combos


def production_mesh(multi_pod: bool):
    """The 16 × 16 or 2 × 16 × 16 mesh in this process's fake world of
    512 ranks, started on first use."""
    import torch.distributed as tdist
    if not tdist.is_initialized():
        mesh_mod.start_fake_world(FAKE_WORLD)
    return mesh_mod.make_production_mesh(multi_pod=multi_pod)


def _completed(path):
    done = set()
    if os.path.exists(path):
        for r in analysis.load_jsonl(path):
            done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def _bytes(tree) -> int:
    """Bytes of a nest's storages on one device (a DTensor's local
    shard)."""
    seen, total = set(), 0
    for t in tree_mod.leaves(tree):
        t = getattr(t, "_local_tensor", t)
        if hasattr(t, "untyped_storage"):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


def trace_step(arch: str, shape_name: str, mesh=None):
    """(the step's outputs, its census, its arguments' bytes a device) for
    one combo, traced on the meta device: on one device, or on ``mesh``
    with every argument distributed by the sharding rules."""
    cfg = registry.config_for_shape(arch, shape_name)
    shape = SHAPES[shape_name]
    census = Census(mesh)

    def put(tree, specs):
        return tree if mesh is None else sharding.distribute(tree, mesh,
                                                             specs)

    if shape.kind == "train":
        optimizer = optim_mod.for_config(cfg)
        C = CLIENTS if mesh is None else mesh_mod.num_clients(cfg, mesh)
        specs = api.input_specs(cfg, shape, num_clients=C)
        state = fl_step.init_state(None, cfg, optimizer, device="meta")
        step = fl_step.make_raw_step(cfg, optimizer, theta=0.65)
        args = (put(state, mesh and sharding.state_pspecs(cfg, mesh,
                                                          optimizer)),
                put(specs["batch"], mesh and sharding.train_batch_pspecs(
                    cfg, mesh, specs["batch"])))
    else:
        specs = api.input_specs(cfg, shape)
        params = put(api.init_params(None, cfg, "meta"),
                     mesh and sharding.param_pspecs(cfg, mesh, "serve"))
        batch = put(specs["batch"],
                    mesh and sharding.infer_batch_pspecs(mesh, specs["batch"]))
        if shape.kind == "prefill":
            step = fl_step.build_prefill_step(cfg)
            args = (params, batch)
        else:  # decode
            step = fl_step.build_serve_step(cfg)
            args = (params, put(specs["cache"], mesh and sharding.cache_pspecs(
                cfg, mesh, specs["cache"])), batch)
    census.hold(*args)
    with census:
        out = step(*args)
    return out, census, _bytes(args)


def lower_one(arch: str, shape_name: str, mesh_key: str = MESH,
              verbose: bool = True):
    """Dry-run one combo on mesh ``"1x1"``, ``"single"`` or ``"multi"``;
    (its roofline row (per-device terms), the row's collective fields:
    ``analysis.collective_fields``)."""
    cfg = registry.config_for_shape(arch, shape_name)
    shape = SHAPES[shape_name]
    mesh = None if mesh_key == MESH else production_mesh(mesh_key == "multi")
    name = MESH_NAMES[mesh_key]
    chips = CHIPS if mesh is None else mesh.size()
    t0 = time.time()
    out, census, arg_bytes = trace_step(arch, shape_name, mesh)
    trace_s = time.time() - t0
    stats = census.analyze()
    mem_stats = {"argument_bytes": arg_bytes, "output_bytes": _bytes(out),
                 "temp_bytes": stats["peak_bytes"] - arg_bytes,
                 "peak_bytes": stats["peak_bytes"]}
    roof = analysis.analyze(arch, shape, name, chips, stats, cfg,
                            memory_stats=mem_stats)
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {name}: traced on meta in "
              f"{trace_s:.1f}s ({chips} chips)")
        print(f"  memory_analysis: {mem_stats}")
        print(f"  cost_analysis: flops={stats['flops']} "
              f"bytes={stats['traffic_bytes']} (a device)")
        print(f"  collectives: {stats['per_op_bytes']}")
        for row in stats["collectives"]:
            print(f"    {row['kind']} over {'x'.join(row['dims'])} "
                  f"({row['group_size']} ranks): {row['calls']:.0f} calls, "
                  f"{row['bytes']:.6g} bytes")
        top = sorted(stats["flops_by_product"].items(),
                     key=lambda kv: -kv[1])[:TOP_PRODUCTS]
        for product, flops in top:
            print(f"    {flops / max(stats['flops'], 1.0):6.1%} of the "
                  f"FLOPs: {product}")
        print("  " + roof.as_row())
    return roof, analysis.collective_fields(stats)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    choices=registry.ASSIGNED_ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default=MESH,
                    choices=[MESH, "single", "multi", "both"])
    ap.add_argument("--results", default=os.path.abspath(RESULTS))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="re-run combos already in the results file")
    args = ap.parse_args(argv)

    combos = plan(args)
    if args.list:
        for c in combos:
            print(*c[:3])
        return 0
    os.makedirs(os.path.dirname(args.results), exist_ok=True)
    done = set() if args.force else _completed(args.results)
    failures = []
    for arch, shape_name, mesh_key, _multi in combos:
        mesh_name = MESH_NAMES[mesh_key]
        key = (arch, shape_name, mesh_name)
        if key in done:
            print(f"[dryrun] skip (cached): {key}")
            continue
        try:
            roof, extra = lower_one(arch, shape_name, mesh_key)
            analysis.save_jsonl(args.results, [roof], [extra])
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape_name, mesh_name, repr(e)))
        finally:
            gc.collect()        # keep a long sweep's memory bounded
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        return 1
    print("\n[dryrun] all combos traced on meta successfully")
    return 0


if __name__ == "__main__":
    sys.exit(main())
