"""Public experiment API of the port: declarative specs, pluggable
strategies, one call to run them.

    from repro_torch.api import ExperimentSpec, run_experiment

    result = run_experiment(ExperimentSpec(strategy="ours", rounds=8))
    print(result.final.accuracy, result.final.bytes_sent)
"""
from repro_torch.api.result import ROUND_FIELDS, ExperimentResult, RoundRecord
from repro_torch.api.runner import (SpmdDriver, build_simulation,
                                    build_spmd_components,
                                    record_from_metrics,
                                    result_from_simulation, run_experiment,
                                    run_scanned_seed_batch,
                                    run_spmd_seed_batch, seed_vectorizable)
from repro_torch.api.spec import (DataSpec, ExperimentSpec, SpecError,
                                  SpecIssue, WorldSpec)
from repro_torch.api.strategies import (STRATEGY_REGISTRY, Strategy,
                                        get_strategy, list_strategies,
                                        register_strategy, resolve_strategy)
from repro_torch.api.world import World, build_world
from repro_torch.core.async_engine import (ClientProfile, CommModel,
                                           StrategyConfig)
from repro_torch.core.scenario import (SCENARIO_PRESETS, ByzantineSpec,
                                       ChurnSpec, DriftSpec, DropoutSchedule,
                                       LinkSpec, ScenarioSpec)
from repro_torch.core.schedule import ScheduleSpec
from repro_torch.topology.spec import (TOPOLOGY_PRESETS, TierSpec,
                                       TopologySpec, resolve_topology)

__all__ = [
    "ByzantineSpec", "ChurnSpec", "ClientProfile", "CommModel", "DataSpec",
    "DriftSpec", "DropoutSchedule", "ExperimentResult", "ExperimentSpec",
    "LinkSpec", "ROUND_FIELDS", "RoundRecord", "SCENARIO_PRESETS",
    "STRATEGY_REGISTRY", "ScenarioSpec", "ScheduleSpec", "SpecError",
    "SpecIssue", "SpmdDriver", "Strategy", "StrategyConfig",
    "TOPOLOGY_PRESETS", "TierSpec", "TopologySpec", "World", "WorldSpec",
    "build_simulation", "build_spmd_components", "build_world",
    "get_strategy", "list_strategies", "record_from_metrics",
    "register_strategy", "resolve_strategy", "resolve_topology",
    "result_from_simulation", "run_experiment", "run_scanned_seed_batch",
    "run_spmd_seed_batch", "seed_vectorizable",
]
