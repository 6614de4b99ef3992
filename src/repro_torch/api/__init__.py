"""Public experiment API of the port: declarative specs, pluggable
strategies, one facade over both engines, plus sessions, schedules and
sweeps.

    from repro_torch.api import ExperimentSpec, run_experiment

    result = run_experiment(ExperimentSpec(strategy="ours", rounds=8))
    print(result.final.accuracy, result.final.bytes_sent)

Resumable driving and multi-seed statistics:

    from repro_torch.api import ExperimentSession, run_sweep

    session = ExperimentSession.open(spec)
    for record in session.stream(8):
        ...
    session.checkpoint("run.ckpt")

    sweep = run_sweep(spec, axes={"strategy": ["ours", "fedavg"],
                                  "seed": range(5)})
    print(sweep.mann_whitney_u("strategy", "ours", "fedavg").p_value)
"""
from repro_torch.api.result import ROUND_FIELDS, ExperimentResult, RoundRecord
from repro_torch.api.runner import (SpmdDriver, build_simulation,
                                    build_spmd_components,
                                    record_from_metrics,
                                    result_from_simulation, run_experiment,
                                    run_scanned_seed_batch,
                                    run_spmd_seed_batch, seed_vectorizable)
from repro_torch.api.session import (CheckpointMismatchError,
                                     ExperimentSession)
from repro_torch.api.spec import (DataSpec, ExperimentSpec, SpecError,
                                  SpecIssue, WorldSpec)
from repro_torch.api.stats import (MannWhitneyResult, mann_whitney_u,
                                   median_iqr)
from repro_torch.api.strategies import (PRESETS, STRATEGY_REGISTRY, Strategy,
                                        get_strategy, list_strategies,
                                        register_strategy, resolve_strategy)
from repro_torch.api.sweep import SweepPoint, SweepResult, run_sweep
from repro_torch.api.world import World, build_world
from repro_torch.core.async_engine import (ClientProfile, CommModel,
                                           StrategyConfig)
from repro_torch.core.scenario import (SCENARIO_PRESETS, ByzantineSpec,
                                       ChurnSpec, DriftSpec, DropoutSchedule,
                                       LinkSpec, ScenarioSpec, WorldState,
                                       resolve_scenario)
from repro_torch.core.schedule import ScheduleSpec
from repro_torch.topology.spec import (TOPOLOGY_PRESETS, TierSpec,
                                       TopologySpec, resolve_topology)

__all__ = [
    "ByzantineSpec", "CheckpointMismatchError", "ChurnSpec",
    "ClientProfile", "CommModel", "DataSpec", "DriftSpec",
    "DropoutSchedule", "ExperimentResult", "ExperimentSession",
    "ExperimentSpec", "LinkSpec", "MannWhitneyResult", "PRESETS",
    "ROUND_FIELDS", "RoundRecord", "SCENARIO_PRESETS", "STRATEGY_REGISTRY",
    "ScenarioSpec", "ScheduleSpec", "SpecError", "SpecIssue", "SpmdDriver",
    "Strategy", "StrategyConfig", "SweepPoint", "SweepResult",
    "TOPOLOGY_PRESETS", "TierSpec", "TopologySpec", "World", "WorldSpec",
    "WorldState", "build_simulation", "build_spmd_components",
    "build_world", "get_strategy", "list_strategies", "mann_whitney_u",
    "median_iqr", "record_from_metrics", "register_strategy",
    "resolve_scenario", "resolve_strategy", "resolve_topology",
    "result_from_simulation", "run_experiment", "run_scanned_seed_batch",
    "run_spmd_seed_batch", "run_sweep", "seed_vectorizable",
]
