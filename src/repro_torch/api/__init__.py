"""Public experiment API of the port: declarative specs, pluggable
strategies, one call to run them.

    from repro_torch.api import ExperimentSpec, run_experiment

    result = run_experiment(ExperimentSpec(strategy="ours", rounds=8))
    print(result.final.accuracy, result.final.bytes_sent)
"""
from repro_torch.api.result import ROUND_FIELDS, ExperimentResult, RoundRecord
from repro_torch.api.runner import (build_simulation, record_from_metrics,
                                    result_from_simulation, run_experiment)
from repro_torch.api.spec import (DataSpec, ExperimentSpec, SpecError,
                                  SpecIssue, WorldSpec)
from repro_torch.api.strategies import (STRATEGY_REGISTRY, Strategy,
                                        get_strategy, list_strategies,
                                        register_strategy, resolve_strategy)
from repro_torch.api.world import World, build_world
from repro_torch.core.async_engine import (ClientProfile, CommModel,
                                           StrategyConfig)
from repro_torch.core.schedule import ScheduleSpec

__all__ = [
    "ClientProfile", "CommModel", "DataSpec", "ExperimentResult",
    "ExperimentSpec", "ROUND_FIELDS", "RoundRecord", "STRATEGY_REGISTRY",
    "ScheduleSpec", "SpecError", "SpecIssue", "Strategy", "StrategyConfig",
    "World", "WorldSpec", "build_simulation", "build_world", "get_strategy",
    "list_strategies", "record_from_metrics", "register_strategy",
    "resolve_strategy", "result_from_simulation", "run_experiment",
]
