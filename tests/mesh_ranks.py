"""Process-group work of the port's mesh tests, run outside the test
process: ``python tests/mesh_ranks.py <task> <dir>`` spawns the task's
ranks (gloo, meeting through a file in ``dir``, so no network is used),
reads its inputs from ``dir/inputs.npz`` and writes rank 0's results to
``dir/<task>.npz``; ``run(task, dir)`` does that from a test.

A default process group cannot be torn down and started again cheaply in
a test worker, so each test module starts one set of ranks (or one fake
world) through here, once. Tasks:

  * ``population`` (4 ranks, "data" mesh): ``round_update_sharded`` over
    the rounds in the inputs, ``sharded_candidates``, and
    ``build_population_round(mesh=...)`` beside the same round with
    ``candidate_shards=4``;
  * ``kernels`` (4 ranks, a 2 × 2 ("data", "model") mesh): every kernel
    wrapper on DTensors laid out by the inputs' cases, gathered whole,
    then smoke qwen2's step on the same mesh beside the unsharded step;
  * ``step`` (1 rank, the debug mesh): smoke qwen2's step on DTensors
    beside the unsharded step, three steps and one in which θ filters
    one of the two clients;
  * ``fake`` (one process, a fake world): meshes, the census of a smoke
    layer on a 1 × 4 "model" mesh, and the refusal of a second world.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = {"population": 4, "kernels": 4, "step": 1, "fake": 0}
BEACON = 1024.0                 # a skip beacon's bytes in the θ-split step


def run(task: str, workdir: str, timeout: int = 600) -> dict:
    """Run ``task`` in a subprocess; its results as a dict of arrays."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE,
         env.get("PYTHONPATH", "")])
    env.setdefault("OMP_NUM_THREADS", "1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), task,
                           workdir], capture_output=True, text=True,
                          timeout=timeout, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"{task} ranks failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-8000:]}")
    with np.load(os.path.join(workdir, f"{task}.npz"),
                 allow_pickle=False) as f:
        return dict(f)


def _save(workdir: str, task: str, out: dict) -> None:
    np.savez(os.path.join(workdir, f"{task}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


def _np(t):
    import torch
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    t = t.detach().cpu()
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


# --------------------------------------------------------------------------
# population (4 ranks)
# --------------------------------------------------------------------------

def _population(rank, workdir, inputs, mesh):
    import torch
    from repro_torch.core import control as tctl
    from repro_torch.core import population as tpop
    out = {}
    for n in (int(x) for x in inputs["pop_sizes"]):
        fields = {f: torch.from_numpy(inputs[f"pop{n}_{f}"])
                  for f in tpop._FIELDS}
        state = tctl.init_control(n)._replace(**fields)
        for r in range(int(inputs["pop_rounds"])):
            obs = {k: torch.from_numpy(inputs[f"pop{n}_r{r}_{k}"])
                   for k in ("failed", "active", "passed", "round_time",
                             "sent", "norms")}
            cohort = torch.from_numpy(inputs[f"pop{n}_r{r}_cohort"])
            state = tpop.round_update_sharded(state, cohort, mesh=mesh,
                                              **obs)
            for f in tpop._FIELDS:
                out[f"pop{n}_r{r}_{f}"] = _np(getattr(state, f))
            out[f"pop{n}_r{r}_local"] = np.int64(
                getattr(state, "avail").to_local().shape[0])
        scores = torch.from_numpy(inputs[f"pop{n}_scores"])
        for i, (k, frac) in enumerate(inputs["cand_cases"]):
            v, gid = tpop.sharded_candidates(scores, int(k), float(frac),
                                             mesh=mesh)
            out[f"cand{n}_{i}_v"], out[f"cand{n}_{i}_i"] = _np(v), _np(gid)
        # the round over the mesh against the same round on one device
        for frac in (0.25, 1.0):
            fn = tpop.build_population_round(n, 8, candidate_frac=frac,
                                             mesh=mesh, seed=3)
            one = tpop.build_population_round(n, 8, candidate_frac=frac,
                                              candidate_shards=4, seed=3)
            a = b = tctl.init_control(n)._replace(**fields)
            for r in range(3):
                a, ca = fn(a, r)
                b, cb = one(b, r)
                out[f"round{n}_{frac}_r{r}_cohorts_equal"] = np.bool_(
                    torch.equal(ca, cb))
                out[f"round{n}_{frac}_r{r}_state_equal"] = np.bool_(all(
                    torch.equal(getattr(a, f).full_tensor(), getattr(b, f))
                    for f in tpop._FIELDS))
    return out


# --------------------------------------------------------------------------
# kernels on a 2 x 2 mesh (4 ranks)
# --------------------------------------------------------------------------

def _kernels(rank, workdir, inputs, mesh):
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import arena, flash_attn, gather, masked_agg
    from repro_torch.kernels import quantize, sign_align
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    R, S0, S1 = Replicate(), Shard(0), Shard(1)

    def put(x, *placements):
        return distribute_tensor(x, mesh, list(placements))

    out = {}
    layouts = {"clients": (S0, R), "rows": (R, S1), "both": (S0, S1),
               "replicated": (R, R)}
    for name, pl in layouts.items():
        u = put(t["u"], *pl)
        out[f"count_{name}"] = _np(sign_align.per_client_sign_align(
            u, put(t["ref"], R, R)))
        out[f"agg_{name}"] = _np(masked_agg.masked_agg(u, put(t["w"], R, R)))
        out[f"fused_{name}"] = _np(masked_agg.fused_update(
            put(t["p"], R, R), u, put(t["w"], R, R)))
        out[f"wsum_{name}"] = _np(arena.weighted_sum(
            u, put(t["w"], R, R), torch.float32))
    out["count_grouped"] = _np(sign_align.per_client_sign_align(
        put(t["u"], S0, S1), put(t["refs2"], R, R)))
    for name, pl in {"rows": (S0, R), "rows2": (S0, S0)}.items():
        x = put(t["x"], *pl)
        q, s = quantize.quantize_q8(x)
        out[f"q_{name}"], out[f"s_{name}"] = _np(q), _np(s)
        out[f"deq_{name}"] = _np(quantize.dequantize_q8(q, s))
        rest, res = quantize.ef_round_trip(x, put(t["e"], *pl))
        out[f"rt_{name}"], out[f"res_{name}"] = _np(rest), _np(res)
        out[f"count1_{name}"] = _np(sign_align.sign_align_counts(
            x, put(t["ref"], *pl)))
    out["gather"] = _np(gather.cohort_gather(put(t["src"], R, S1),
                                             put(t["idx"], R, R)))
    # flash: batch over "data", heads over "model"; and a sharded sequence
    for name, pl in {"bh": (S0, Shard(2)), "seq": (S1, R)}.items():
        q, k, v = (put(t[n], *pl) for n in ("q", "k", "v"))
        out[f"flash_{name}"] = _np(flash_attn.flash_attention_gqa(
            q, k, v, causal=True))
    # past 2^24 matches over two row shards: 2^24 + 1 in the first, 1 in
    # the second; f32 partials would add to f32(2^24 + 1) + 1 = 2^24, the
    # int64 all-reduce gives 2^24 + 2
    rows = int(inputs["big_rows"])
    half = rows // 2 * 1024
    big = torch.ones((rows, 1024), dtype=torch.float32)
    ref = torch.ones((rows, 1024), dtype=torch.int8)
    ref.view(-1)[2 ** 24 + 1:half] = -2
    ref.view(-1)[half + 1:] = -2
    out["big"] = _np(sign_align.sign_align_counts(put(big, S0, R),
                                                  put(ref, S0, R)))
    out["big_clients"] = _np(sign_align.per_client_sign_align(
        put(big[None], R, S1), put(ref, R, S0)))
    out.update(_step_2x2(inputs, mesh))
    return out


def _step_2x2(inputs, mesh):
    """Smoke qwen2's step (f32 weights, sgd with momentum) on the 2 x 2
    mesh beside the unsharded step from the same state, ``step2_steps``
    steps: each rank packs its two of the four clients ("data"), the
    weights tensor-parallel over "model". Returns both sides' metrics
    and, for each state leaf, the largest difference and its scale (the
    step's own update for a weight, the leaf's largest magnitude for the
    momentum) with one f32 ulp of the leaf's largest magnitude, or, for
    an integer leaf, the elements that differ."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core import fl_step
    from repro_torch.launch import sharding
    from repro_torch.optim import adamw
    cfg = registry.get_config("qwen2-1.5b", smoke=True).replace(
        dtype="float32")
    opt = adamw.sgd()
    state = fl_step.init_state(torch.Generator().manual_seed(0), cfg, opt,
                               device="cpu")
    batch = {"tokens": torch.from_numpy(inputs["step2_tokens"]),
             "labels": torch.from_numpy(inputs["step2_labels"])}
    dstate = sharding.distribute(state, mesh,
                                 sharding.state_pspecs(cfg, mesh, opt))
    dbatch = sharding.distribute(
        batch, mesh, sharding.train_batch_pspecs(cfg, mesh, batch))
    plain = fl_step.make_raw_step(cfg, opt, theta=0.65,
                                  agg_dtype=torch.float32)
    on_mesh = fl_step.make_raw_step(cfg, opt, theta=0.65,
                                    agg_dtype=torch.float32)
    out = {"step2_local_clients": np.int64(
               dbatch["tokens"].to_local().shape[0]),
           "step2_sharded_weights": np.int64(sum(
               any(p.is_shard() for p in x.placements)
               for x in tree.leaves(dstate.params)))}
    for s in range(int(inputs["step2_steps"])):
        before = tree.tree_map(torch.clone, state.params)
        state, m = plain(state, batch)
        dstate, dm = on_mesh(dstate, dbatch)
        for k in sorted(m):
            out[f"step2_s{s}_{k}_plain"] = _np(m[k])
            out[f"step2_s{s}_{k}_mesh"] = _np(dm[k])
        err, scale, ulp, names = [], [], [], []
        for (path, a), (_, b) in zip(tree.named_leaves(state),
                                     tree.named_leaves(dstate)):
            b = b.full_tensor() if hasattr(b, "full_tensor") else b
            names.append("/".join(str(x) for x in path))
            if not a.is_floating_point():
                err.append(float((a != b).sum()))
                scale.append(float(a.numel()))
                ulp.append(0.0)
                continue
            a64, b64 = a.to(torch.float64), b.to(torch.float64)
            err.append(float((a64 - b64).abs().max()))
            big = float(a64.abs().max())
            ulp.append(big * 2.0 ** -23)
            if path[0] == 0:                # a weight: this step's update
                old = tree.get(before, path[1:]).to(torch.float64)
                scale.append(float((a64 - old).abs().max()))
            else:
                scale.append(big)
        out[f"step2_s{s}_err"] = np.array(err)
        out[f"step2_s{s}_scale"] = np.array(scale)
        out[f"step2_s{s}_ulp"] = np.array(ulp)
        out["step2_leaves"] = np.array(names)
    return out


# --------------------------------------------------------------------------
# the step on the debug mesh (1 rank)
# --------------------------------------------------------------------------

def _step(rank, workdir, inputs, mesh):
    import torch
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core import fl_step
    from repro_torch.launch import sharding
    from repro_torch.optim import adamw
    from repro_torch.kernels import ref
    calls = {"per_client_sign_align": 0, "masked_agg": 0}

    def counted(name):
        fn = getattr(ref, name)

        def call(*a):
            calls[name] += 1
            return fn(*a)
        setattr(ref, name, call)

    for name in calls:
        counted(name)
    out = {}
    # full attention with the default bf16 aggregation; blockwise with
    # f32, whose plain version is the aggregation kernel's
    for attn, agg in (("full", torch.bfloat16), ("blockwise", torch.float32)):
        cfg = registry.get_config("qwen2-1.5b", smoke=True).replace(
            attention_impl=attn)
        opt = adamw.for_config(cfg)
        state = fl_step.init_state(torch.Generator().manual_seed(0), cfg,
                                   opt, device="cpu")
        batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens",
                                                          "labels")}
        plain = fl_step.make_raw_step(cfg, opt, theta=0.65, agg_dtype=agg)
        on_mesh = fl_step.make_raw_step(cfg, opt, theta=0.65, agg_dtype=agg)
        dstate = sharding.distribute(
            state, mesh, sharding.state_pspecs(cfg, mesh, opt))
        dbatch = sharding.distribute(
            batch, mesh, sharding.train_batch_pspecs(cfg, mesh, batch))
        for s in range(3):
            before = dict(calls)
            state, m = plain(state, batch)
            mid = dict(calls)
            dstate, dm = on_mesh(dstate, dbatch)
            out[f"{attn}_s{s}_calls"] = np.array(
                [[mid[k] - before[k], calls[k] - mid[k]] for k in calls])
            out[f"{attn}_s{s}_state_equal"] = np.bool_(all(
                torch.equal(a, b.full_tensor() if hasattr(b, "full_tensor")
                            else b)
                for a, b in zip(tree.leaves(state), tree.leaves(dstate))))
            out[f"{attn}_s{s}_metrics_equal"] = np.bool_(all(
                torch.equal(m[k], dm[k]) for k in m))
            out[f"{attn}_s{s}_dtensor_leaves"] = np.int64(sum(
                hasattr(x, "full_tensor") for x in tree.leaves(dstate)))
        # one more step, with θ between the two clients' ratios at this
        # state (read by a θ = 0 step on a copy), so that θ filters one
        # client and its skip beacon is charged; the beacon is priced
        # high enough to show beside the update bytes in f32
        probe = fl_step.make_raw_step(cfg, opt, theta=0.0, agg_dtype=agg)
        _, pm = probe(tree.tree_map(torch.clone, state), batch)
        theta = float((pm["ratios"].max() + pm["ratios"].min()) / 2)
        plain = fl_step.make_raw_step(cfg, opt, theta=theta, agg_dtype=agg,
                                      beacon_bytes=BEACON)
        on_mesh = fl_step.make_raw_step(cfg, opt, theta=theta,
                                        agg_dtype=agg, beacon_bytes=BEACON)
        state, m = plain(state, batch)
        dstate, dm = on_mesh(dstate, dbatch)
        out[f"{attn}_split_state_equal"] = np.bool_(all(
            torch.equal(a, b.full_tensor() if hasattr(b, "full_tensor")
                        else b)
            for a, b in zip(tree.leaves(state), tree.leaves(dstate))))
        out[f"{attn}_split_metrics_equal"] = np.array(
            [torch.equal(m[k], dm[k]) for k in sorted(m)])
        out[f"{attn}_split_metric_names"] = np.array(sorted(m))
        out[f"{attn}_split_mask"] = _np(dm["mask"])
        out[f"{attn}_split_bytes_sent"] = _np(dm["bytes_sent"])
        out[f"{attn}_split_update_bytes"] = np.float64(
            fl_step._update_bytes(state.params))
    return out


# --------------------------------------------------------------------------
# a fake world (one process)
# --------------------------------------------------------------------------

def _fake(workdir, inputs):
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import api, layers, transformer
    from repro_torch.roofline.census import Census
    out = {}
    M.start_fake_world(512)
    try:
        M.start_fake_world(8)
    except RuntimeError as e:
        out["refused"] = np.bool_("already up" in str(e))
    for key, multi in (("single", False), ("multi", True)):
        m = M.make_production_mesh(multi_pod=multi)
        out[f"{key}_shape"] = np.array(m.shape)
        out[f"{key}_names"] = np.array(m.mesh_dim_names)
        out[f"{key}_type"] = np.array(m.device_type)
    pm = M.make_population_mesh(16)
    out["population_shape"] = np.array(pm.shape)
    out["debug_shape"] = np.array(M.make_debug_mesh().shape)
    # one smoke layer (the attention and FFN of qwen2) on a 1 x 4 "model"
    # mesh: its all-reduce bytes against the rules' reckoning
    mesh = M.make_debug_mesh((1, 4))
    cfg = registry.get_config("qwen2-1.5b", smoke=True).replace(
        num_layers=1, remat=False)
    params = sharding.distribute(api.init_params(None, cfg, "meta"), mesh,
                                 sharding.param_pspecs(cfg, mesh, "serve"))
    B, S = int(inputs["layer_b"]), int(inputs["layer_s"])
    x = torch.empty((B, S, cfg.d_model), dtype=cfg.compute_dtype,
                    device="meta")
    x = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    lp = transformer._layer(params["layers"], 0)
    census = Census(mesh)
    with census, implicit_replication():
        a, _ = layers.full_attention(cfg, lp["attn"], x, causal=True)
        f = layers.ffn(cfg, lp["ffn"], x)
        a.full_tensor()
        f.full_tensor()
    st = census.analyze()
    out["layer_d"] = np.int64(cfg.d_model)
    out["layer_elem_bytes"] = np.int64(x.element_size())
    rows = [r for r in st["collectives"] if r["kind"] == "all-reduce"]
    out["layer_allreduce_bytes"] = np.float64(sum(r["bytes"] for r in rows))
    out["layer_allreduce_calls"] = np.float64(sum(r["calls"] for r in rows))
    out["layer_allreduce_dims"] = np.array(sorted({d for r in rows
                                                   for d in r["dims"]}))
    out["layer_nodes"] = np.array([r["nodes"] for r in rows])
    out["layer_mm_flops"] = np.float64(sum(
        v for k, v in st["flops_by_op"].items() if k.startswith("aten::")))
    out["layer_product_flops"] = np.float64(sum(
        st["flops_by_product"].values()))
    out["layer_products"] = np.array(sorted(st["flops_by_product"]))
    # qwen2's training step (full size, on meta), plain and on the 1 x 1
    # mesh, after one untraced step: the first trace of a process also
    # holds the rotary frequencies it caches on meta (256 bytes)
    from repro_torch.launch import dryrun
    dryrun.trace_step("qwen2-1.5b", "train_4k", None)
    for key, m in (("plain", None), ("mesh1", M.make_debug_mesh())):
        _, census, _ = dryrun.trace_step("qwen2-1.5b", "train_4k", m)
        st = census.analyze()
        out[f"step_{key}_flops"] = np.float64(st["flops"])
        out[f"step_{key}_peak"] = np.int64(st["peak_bytes"])
        out[f"step_{key}_collective"] = np.float64(st["collective_bytes"])
        out[f"step_{key}_launches"] = np.array(sorted(
            st["kernel_launches"].items()), dtype=object).astype(str)
        out[f"step_{key}_mm"] = np.array(sorted(
            (k, v) for k, v in st["flops_by_op"].items()),
            dtype=object).astype(str)
    return out


# --------------------------------------------------------------------------

def _rank_main(rank, task, workdir, world):
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M
    M.start_world("gloo", rank, world, os.path.join(workdir, "rendezvous"))
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        inputs = dict(f)
    if task == "population":
        out = _population(rank, workdir, inputs, M.make_population_mesh())
    elif task == "kernels":
        out = _kernels(rank, workdir, inputs, M.make_debug_mesh((2, 2)))
    else:
        out = _step(rank, workdir, inputs, M.make_debug_mesh())
    if rank == 0:
        _save(workdir, task, out)
    import torch.distributed as tdist
    tdist.barrier()
    tdist.destroy_process_group()


def main(task: str, workdir: str) -> None:
    if task == "fake":
        import torch
        torch.set_num_threads(1)
        with np.load(os.path.join(workdir, "inputs.npz")) as f:
            inputs = dict(f)
        _save(workdir, task, _fake(workdir, inputs))
        return
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(task, workdir, WORLD[task]),
             nprocs=WORLD[task])


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
