"""Dry run of every (architecture × input shape) on one device: the
counterpart of the JAX package's ``launch/dryrun.py``.

Each combo builds its weights or training state on the meta device (no
allocation), runs the port's own step on meta inputs (``make_raw_step``
for a training shape, ``build_prefill_step`` for a prefill,
``build_serve_step`` for a decode) under the census
(``roofline/census.py``), prints its memory and cost lines and its
roofline on the H100 (``roofline/analysis.py``), and appends the row to a
JSONL results file. The hand-written kernels take their shape-only calls
(``kernels/meta.py``), the ssm and hybrid families' time loops run one
step counted T times.

The mesh is one device, as the JAX package's ``make_debug_mesh()``
(1 × 1): mesh ``"1x1"``, one chip, one client (C = 1). The production
meshes (``--mesh single|multi``) come with sharding, ROADMAP item 14g.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k                                           # one combo
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
from repro_torch.models import api
from repro_torch.optim import adamw as optim_mod
from repro_torch.roofline import analysis
from repro_torch.roofline.census import Census

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch_results.jsonl")
MESH, CHIPS, CLIENTS = "1x1", 1, 1


def plan(args):
    """(arch, shape, mesh, multi_pod) for every combo asked for."""
    combos = []
    archs = [args.arch] if args.arch else registry.ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    for a in archs:
        for s in shapes:
            if s == "long_500k" and a in registry.LONG_CTX_SKIP:
                continue
            combos.append((a, s, MESH, False))
    return combos


def _completed(path):
    done = set()
    if os.path.exists(path):
        for r in analysis.load_jsonl(path):
            done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def _bytes(tree) -> int:
    seen, total = set(), 0
    for t in tree_mod.leaves(tree):
        if hasattr(t, "untyped_storage"):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


def trace_step(arch: str, shape_name: str):
    """(the step's outputs, its census, its arguments' bytes) for one
    combo, traced on the meta device."""
    cfg = registry.config_for_shape(arch, shape_name)
    shape = SHAPES[shape_name]
    census = Census()
    if shape.kind == "train":
        optimizer = optim_mod.for_config(cfg)
        specs = api.input_specs(cfg, shape, num_clients=CLIENTS)
        state = fl_step.init_state(None, cfg, optimizer, device="meta")
        step = fl_step.make_raw_step(cfg, optimizer, theta=0.65)
        args = (state, specs["batch"])
    elif shape.kind == "prefill":
        specs = api.input_specs(cfg, shape)
        step = fl_step.build_prefill_step(cfg)
        args = (api.init_params(None, cfg, "meta"), specs["batch"])
    else:  # decode
        specs = api.input_specs(cfg, shape)
        step = fl_step.build_serve_step(cfg)
        args = (api.init_params(None, cfg, "meta"), specs["cache"],
                specs["batch"])
    census.hold(*args)
    with census:
        out = step(*args)
    return out, census, _bytes(args)


def lower_one(arch: str, shape_name: str, verbose: bool = True):
    """Dry-run one combo; its roofline row."""
    cfg = registry.config_for_shape(arch, shape_name)
    shape = SHAPES[shape_name]
    t0 = time.time()
    out, census, arg_bytes = trace_step(arch, shape_name)
    trace_s = time.time() - t0
    stats = census.analyze()
    mem_stats = {"argument_bytes": arg_bytes, "output_bytes": _bytes(out),
                 "temp_bytes": stats["peak_bytes"] - arg_bytes,
                 "peak_bytes": stats["peak_bytes"]}
    roof = analysis.analyze(arch, shape, MESH, CHIPS, stats, cfg,
                            memory_stats=mem_stats)
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {MESH}: traced on meta in "
              f"{trace_s:.1f}s")
        print(f"  memory_analysis: {mem_stats}")
        print(f"  cost_analysis: flops={stats['flops']} "
              f"bytes={stats['traffic_bytes']}")
        print(f"  collectives: {stats['per_op_bytes']}")
        print("  " + roof.as_row())
    return roof


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
    if args.mesh != MESH:
        ap.error(f"--mesh {args.mesh}: the production meshes come with "
                 f"sharding (ROADMAP item 14g); this dry run has one "
                 f"device, mesh {MESH}")

    combos = plan(args)
    if args.list:
        for c in combos:
            print(*c[:3])
        return 0
    os.makedirs(os.path.dirname(args.results), exist_ok=True)
    done = set() if args.force else _completed(args.results)
    failures = []
    for arch, shape_name, mesh_name, _multi in combos:
        key = (arch, shape_name, mesh_name)
        if key in done:
            print(f"[dryrun] skip (cached): {key}")
            continue
        try:
            roof = lower_one(arch, shape_name)
            analysis.save_jsonl(args.results, [roof])
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
