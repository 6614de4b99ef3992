"""Run an ``ExperimentSpec`` on the port.

``run_experiment(spec)``  — build the simulation, run ``spec.rounds``,
    return the normalized result. The JAX package drives this through an
    ``ExperimentSession``; sessions are not ported yet (ROADMAP.md queue 1
    item 11), so the port drives the simulation directly, with the same
    rule for the final round: it is always evaluated.

``build_simulation(spec)`` — the event-driven ``FederatedSimulation`` a
    spec describes.

``run_scanned_seed_batch(spec, seeds)`` — the scanned path at several
    seeds with fused eval and one readback at the end.

Both run on the card unless ``device`` names another device, and start
from ``params`` (a parameter dict, e.g. the JAX simulation's initial
parameters as numpy arrays) when given.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import torch

from repro_torch.api.result import ExperimentResult, RoundRecord
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import async_engine as ae


def build_simulation(spec: ExperimentSpec, *, device=None,
                     params=None, draws=None) -> "ae.FederatedSimulation":
    """The event-driven simulation an ``engine='sim'`` spec describes
    (``draws``: the scanned path's draw source, core/draws.py; None for the
    port's own)."""
    spec.validate()
    world = spec.build_world()
    return ae.FederatedSimulation(spec.resolve_model(), world.client_arrays,
                                  world.eval_arrays, spec.resolve_strategy(),
                                  world.profiles, comm=spec.resolve_comm(),
                                  seed=spec.seed, eval_every=spec.eval_every,
                                  schedule=spec.resolve_schedule(),
                                  device=device, params=params,
                                  eval_fn=spec.eval_fn,
                                  megastep=spec.megastep,
                                  rounds_per_dispatch=spec.rounds_per_dispatch,
                                  fused_eval=spec.fused_eval, draws=draws)


def record_from_metrics(m: "ae.RoundMetrics") -> RoundRecord:
    return RoundRecord(round=m.round, sim_time=m.sim_time,
                       comm_time=m.comm_time, idle_time=m.idle_time,
                       bytes_sent=m.bytes_sent,
                       updates_applied=m.updates_applied,
                       accept_rate=m.accept_rate, accuracy=m.accuracy,
                       loss=m.loss)


def result_from_simulation(spec: ExperimentSpec, sim, wall_time: float = 0.0
                           ) -> ExperimentResult:
    records = [record_from_metrics(m) for m in sim.history]
    return ExperimentResult(
        engine="sim", strategy=spec.strategy_name(), rounds=len(records),
        seed=spec.seed, records=records, cfg=sim.cfg, params=sim.params,
        eval_arrays=sim.eval_arrays, num_clients=sim.num_clients,
        param_bytes=sim.param_bytes, wall_time=wall_time)


def run_experiment(spec: ExperimentSpec, *, device=None,
                   params=None) -> ExperimentResult:
    t0 = time.time()
    sim = build_simulation(spec, device=device, params=params)
    sim.run(spec.rounds, eval_final=True)
    return result_from_simulation(spec, sim, wall_time=time.time() - t0)


def run_scanned_seed_batch(spec: ExperimentSpec, seeds: Sequence[int], *,
                           device=None) -> List[ExperimentResult]:
    """Run the scanned path at every seed, with fused eval forced on, and
    read every seed's metrics back once, at the end.

    Each seed's records equal that seed's solo scanned run
    (``run_experiment(replace(spec, seed=s, fused_eval=True))``): each
    seed is its own simulation, with its own world, weights, control state
    and draws. The seeds run one after another inside each dispatch
    window; batching the seed axis into one launch stream is later work.
    Every seed must resolve the same scanned shapes (select_k, steps_phys,
    batch_phys), as the JAX package requires for its vmapped batch.
    """
    t0 = time.time()
    if spec.engine != "sim" or not spec.rounds_per_dispatch:
        raise ValueError(
            "run_scanned_seed_batch runs the scanned sim engine — the spec "
            "needs engine='sim' and rounds_per_dispatch")
    specs = [dataclasses.replace(spec, seed=int(s),
                                 fused_eval=True).validate() for s in seeds]
    sims = [build_simulation(s, device=device) for s in specs]
    shapes = {sim._scan_shapes() for sim in sims}
    if len(shapes) > 1:
        raise ValueError(
            f"seeds resolve different scanned trace shapes {sorted(shapes)} "
            "(select_k, steps_phys, batch_phys must agree); equalize data "
            "sizes across seeds or run serially")
    R = spec.rounds_per_dispatch
    per_seed = [[] for _ in sims]     # device metrics, read back at the end
    round0 = 0
    while round0 < spec.rounds:
        Rg = min(R, spec.rounds - round0)
        mark = spec.rounds - 1 if round0 + Rg == spec.rounds else -1
        for ms, sim in zip(per_seed, sims):
            ms.append(sim._scan_dispatch(Rg, mark))
        round0 += Rg
    stacked = {k: torch.cat([ms[k] for seed_ms in per_seed for ms in seed_ms])
               for k in per_seed[0][0]}
    host = ae.FederatedSimulation.scan_readback(stacked)
    elapsed = time.time() - t0
    out, off = [], 0
    for s, sim, seed_ms in zip(specs, sims, per_seed):
        for ms in seed_ms:
            Rg = ms["loss"].shape[0]
            sim._record_scanned({k: v[off:off + Rg] for k, v in host.items()})
            off += Rg
        out.append(result_from_simulation(s, sim, wall_time=elapsed))
    return out
