"""Declarative experiment specification — the port's public entry point.

An ``ExperimentSpec`` names everything a paper experiment varies (model,
data/partition, client world, communication model, strategy, schedule,
rounds, seed), with the JAX package's field names, and
``run_experiment(spec)`` runs it on the event-driven simulator's
megastep path.

The spec has every field of the JAX package's spec, and ``validate()``
refuses each option the port does not run yet, naming the ROADMAP.md
item that brings it — nothing is quietly ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

from repro_torch.api import strategies as strategies_mod
from repro_torch.api import world as world_mod
from repro_torch.core.async_engine import CommModel, StrategyConfig
from repro_torch.core.schedule import ScheduleSpec, resolve_schedule

DATASETS = ("auto", "unsw", "road")
PARTITIONS = ("dirichlet", "iid")
PROFILES = ("heterogeneous", "uniform")
MODELS = ("anomaly-mlp", "anomaly-mlp-road", "anomaly-mlp-smoke")


@dataclasses.dataclass(frozen=True)
class SpecIssue:
    """One validation violation: the field, its offending value, a hint."""
    field: str
    value: Any
    hint: str

    def __str__(self):
        return f"{self.field}={self.value!r}: {self.hint}"


class SpecError(ValueError):
    """Raised by ``ExperimentSpec.validate()`` with EVERY violation at
    once (``.issues``), not just the first."""

    def __init__(self, issues: List[SpecIssue]):
        self.issues = list(issues)
        detail = "; ".join(str(i) for i in self.issues)
        super().__init__(
            f"invalid ExperimentSpec — {len(self.issues)} problem"
            f"{'s' if len(self.issues) != 1 else ''}: {detail}")


@dataclasses.dataclass
class DataSpec:
    dataset: str = "auto"             # auto | unsw | road (auto infers
                                      # from the model config)
    n_samples: int = 20000
    eval_samples: int = 4000
    partition: str = "dirichlet"
    alpha: float = 0.5                # Dirichlet concentration (lower=skewed)
    seq_len: int = 128                # lm datasets only (not ported)
    factory: Optional[Callable[[int, int], Any]] = None
    # factory(seed, n) -> (X, y) or {"x": ..., "y": ...} overrides `dataset`
    samples_per_client: Optional[int] = None   # non-resident worlds only


@dataclasses.dataclass
class WorldSpec:
    num_clients: int = 10
    profile: str = "heterogeneous"    # heterogeneous | uniform
    dropout_p: float = 0.0
    speed_sigma: float = 0.6          # lognormal speed spread (stragglers)
    profile_seed_offset: int = 1      # profiles seeded at seed + offset
    resident: bool = True             # False (lazy worlds) is not ported


# option -> (the value the port runs, the ROADMAP.md queue 1 item that
# brings the others)
_NOT_PORTED = {
    "engine": ("sim", 9, "the compiled spmd engine"),
    "scenario": (None, 10, "dynamic-world scenarios"),
    "topology": (None, 10, "hierarchical topologies"),
    "candidate_frac": (None, 10, "two-stage candidate selection"),
    "rounds_per_dispatch": (None, 8, "the scanned device control plane"),
    "fused_eval": (False, 8, "evaluation fused into the scanned rounds"),
    "megastep": (True, 6, "the per-client reference loop "
                          "(_run_round_loop)"),
    "eval_fn": (None, 6, "a custom evaluation callable"),
    "lr_schedule": (None, 9, "an LR schedule of the spmd engine"),
    "optimizer": (None, 9, "an optimizer choice of the spmd engine"),
}


@dataclasses.dataclass
class ExperimentSpec:
    model: Union[str, Any] = "anomaly-mlp"     # config name or ArchConfig
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    world: WorldSpec = dataclasses.field(default_factory=WorldSpec)
    comm: Optional[CommModel] = None           # None -> CommModel() defaults
    strategy: Union[str, StrategyConfig, Any] = "ours"
    strategy_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schedule: Union[str, ScheduleSpec, None] = None
    # the server-coordination axis: None derives the schedule from the
    # strategy's legacy ``mode`` field; "sync" | "async" | "semi-async" or
    # a full ScheduleSpec overrides it
    scenario: Any = None
    topology: Any = None
    engine: str = "sim"
    rounds: int = 5
    seed: int = 0
    eval_every: int = 1                        # evaluate every k-th round
                                               # (+ the final round)
    megastep: bool = True
    rounds_per_dispatch: Optional[int] = None
    fused_eval: bool = False
    eval_fn: Optional[Callable] = None
    lr_schedule: Optional[Callable] = None
    candidate_frac: Optional[float] = None
    candidate_shards: int = 8
    optimizer: Union[str, Any, None] = None

    # ------------------------------------------------------------------
    # resolution helpers
    # ------------------------------------------------------------------
    def resolve_model(self):
        if not isinstance(self.model, str):
            return self.model                  # already an ArchConfig
        from repro_torch.configs import anomaly_mlp
        named = dict(zip(MODELS, (anomaly_mlp.CONFIG, anomaly_mlp.ROAD_CONFIG,
                                  anomaly_mlp.SMOKE)))
        if self.model in named:
            return named[self.model]
        raise ValueError(f"model {self.model!r} is not ported yet; the port "
                         f"runs {MODELS}, and the other architectures come "
                         "with ROADMAP.md queue 1 item 14")

    def resolve_strategy(self) -> StrategyConfig:
        return strategies_mod.resolve_strategy(self.strategy,
                                               **self.strategy_kwargs)

    def resolve_schedule(self) -> ScheduleSpec:
        return resolve_schedule(self.schedule, self.resolve_strategy())

    def resolve_comm(self) -> CommModel:
        return self.comm or CommModel()

    def strategy_name(self) -> str:
        if isinstance(self.strategy, str):
            return self.strategy
        return getattr(self.strategy, "name", "<custom>")

    def build_world(self) -> world_mod.World:
        return world_mod.build_world(self)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validate(self) -> "ExperimentSpec":
        """Raise :class:`SpecError` listing EVERY violation (field name,
        offending value, hint) — not just the first one found."""
        issues: List[SpecIssue] = []
        for name, (ported, item, what) in _NOT_PORTED.items():
            value = getattr(self, name)
            if value != ported:
                issues.append(SpecIssue(
                    name, value, f"{what} is not ported yet; it comes with "
                                 f"ROADMAP.md queue 1 item {item}"))
        if not self.world.resident:
            issues.append(SpecIssue(
                "world.resident", self.world.resident,
                "non-resident (lazy) worlds are not ported yet; they come "
                "with ROADMAP.md queue 1 item 10"))
        if self.data.samples_per_client is not None:
            issues.append(SpecIssue(
                "data.samples_per_client", self.data.samples_per_client,
                "only non-resident worlds read it; they come with "
                "ROADMAP.md queue 1 item 10"))
        if self.rounds < 1:
            issues.append(SpecIssue("rounds", self.rounds,
                                    "rounds must be >= 1"))
        if self.eval_every < 1:
            issues.append(SpecIssue("eval_every", self.eval_every,
                                    "eval_every must be >= 1"))
        if self.world.num_clients < 1:
            issues.append(SpecIssue("world.num_clients",
                                    self.world.num_clients,
                                    "world.num_clients must be >= 1"))
        try:
            self.resolve_model()
        except ValueError as e:
            issues.append(SpecIssue("model", self.model, str(e)))
        if self.data.dataset not in DATASETS and self.data.factory is None:
            issues.append(SpecIssue(
                "data.dataset", self.data.dataset,
                f"expected one of {DATASETS} or a factory (token datasets "
                "come with ROADMAP.md queue 1 item 14)"))
        if self.data.partition not in PARTITIONS:
            issues.append(SpecIssue(
                "data.partition", self.data.partition,
                f"unknown partition; expected one of {PARTITIONS}"))
        if self.world.profile not in PROFILES:
            issues.append(SpecIssue(
                "world.profile", self.world.profile,
                f"unknown profile; expected one of {PROFILES}"))
        strategy = schedule = None
        try:
            strategy = self.resolve_strategy()
        except (ValueError, TypeError) as e:
            issues.append(SpecIssue("strategy", self.strategy_name(),
                                    str(e)))
        if strategy is not None:
            if strategy.quantize_updates:
                issues.append(SpecIssue(
                    "strategy.quantize_updates", True,
                    "int8 wire compression is not ported yet; it comes "
                    "with ROADMAP.md queue 1 item 7"))
            try:
                schedule = self.resolve_schedule()
            except TypeError as e:
                issues.append(SpecIssue("schedule", self.schedule, str(e)))
        if schedule is not None:
            issues.extend(SpecIssue(f, v, h) for f, v, h
                          in schedule.issues())
        if issues:
            raise SpecError(issues)
        return self
