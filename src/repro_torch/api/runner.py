"""Run an ``ExperimentSpec`` on the port.

``run_experiment(spec)``  — build the simulation, run ``spec.rounds``,
    return the normalized result. The JAX package drives this through an
    ``ExperimentSession``; sessions are not ported yet (ROADMAP.md queue 1
    item 11), so the port drives the simulation directly, with the same
    rule for the final round: it is always evaluated.

``build_simulation(spec)`` — the event-driven ``FederatedSimulation`` a
    spec describes.

Both run on the card unless ``device`` names another device, and start
from ``params`` (a parameter dict, e.g. the JAX simulation's initial
parameters as numpy arrays) when given.
"""
from __future__ import annotations

import time

from repro_torch.api.result import ExperimentResult, RoundRecord
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import async_engine as ae


def build_simulation(spec: ExperimentSpec, *, device=None,
                     params=None) -> "ae.FederatedSimulation":
    """The event-driven simulation an ``engine='sim'`` spec describes."""
    spec.validate()
    world = spec.build_world()
    return ae.FederatedSimulation(spec.resolve_model(), world.client_arrays,
                                  world.eval_arrays, spec.resolve_strategy(),
                                  world.profiles, comm=spec.resolve_comm(),
                                  seed=spec.seed, eval_every=spec.eval_every,
                                  schedule=spec.resolve_schedule(),
                                  device=device, params=params,
                                  eval_fn=spec.eval_fn,
                                  megastep=spec.megastep)


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
