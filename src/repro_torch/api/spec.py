"""Declarative experiment specification — the port's public entry point.

An ``ExperimentSpec`` names everything a paper experiment varies (model,
data/partition, client world, communication model, strategy, schedule,
engine, rounds, seed), with the JAX package's field names, and
``run_experiment(spec)`` runs it on either engine:

  engine="sim"   — the event-driven simulator: the cohort megastep path,
                   the per-client reference loop with ``megastep=False``,
                   or the scanned device control plane with
                   ``rounds_per_dispatch`` (and ``fused_eval``);
  engine="spmd"  — one synchronous round per step (core/fl_step.py), the
                   path of the paper's synchronous baselines, with an
                   optional ``lr_schedule`` and ``optimizer="sgd"``;

each with or without int8 wire compression (``strategy.quantize_updates``)
and a custom ``eval_fn``.

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

ENGINES = ("sim", "spmd")
OPTIMIZERS = ("sgd",)                 # strings the port runs
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
    "scenario": (None, 10, "dynamic-world scenarios"),
    "topology": (None, 10, "hierarchical topologies"),
    "candidate_frac": (None, 10, "two-stage candidate selection"),
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
    lr_schedule: Optional[Callable] = None     # spmd engine only: step -> lr
    candidate_frac: Optional[float] = None
    candidate_shards: int = 8
    optimizer: Union[str, Any, None] = None
    # spmd engine only: None or "sgd" (momentum 0), or an Optimizer pair

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
        if self.engine not in ENGINES:
            issues.append(SpecIssue(
                "engine", self.engine,
                f"unknown engine; expected one of {ENGINES}"))
        issues.extend(self._validate_optimizer())
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
        if self.rounds_per_dispatch is not None:
            if self.rounds_per_dispatch < 1:
                issues.append(SpecIssue(
                    "rounds_per_dispatch", self.rounds_per_dispatch,
                    "rounds_per_dispatch must be >= 1"))
            if self.engine != "sim":
                issues.append(SpecIssue(
                    "rounds_per_dispatch", self.rounds_per_dispatch,
                    "rounds_per_dispatch is a sim-engine knob (the spmd "
                    "step is already one round per call)"))
            if not self.megastep:
                issues.append(SpecIssue(
                    "megastep", self.megastep,
                    "rounds_per_dispatch requires megastep=True (the "
                    "scanned path runs on the parameter arena)"))
        if self.fused_eval:
            if self.rounds_per_dispatch is None:
                issues.append(SpecIssue(
                    "fused_eval", self.fused_eval,
                    "fused_eval evaluates inside the scanned dispatch — "
                    "set rounds_per_dispatch"))
            if self.engine != "sim":
                issues.append(SpecIssue(
                    "fused_eval", self.fused_eval,
                    "fused_eval is a sim-engine knob (the scanned control "
                    "plane)"))
            if self.eval_fn is not None:
                issues.append(SpecIssue(
                    "fused_eval", self.fused_eval,
                    "fused_eval keeps the accuracy on the device inside the "
                    "dispatch; a custom eval_fn returns a host float — drop "
                    "one of the two"))
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
            try:
                schedule = self.resolve_schedule()
            except TypeError as e:
                issues.append(SpecIssue("schedule", self.schedule, str(e)))
        if schedule is not None:
            issues.extend(SpecIssue(f, v, h) for f, v, h
                          in schedule.issues())
            if self.engine == "spmd":
                issues.extend(self._validate_spmd(strategy, schedule))
        if issues:
            raise SpecError(issues)
        return self

    def _validate_optimizer(self) -> List[SpecIssue]:
        opt = self.optimizer
        if opt is None or opt in OPTIMIZERS:
            return []
        if opt in ("adamw", "adafactor"):
            return [SpecIssue("optimizer", opt,
                              f"{opt} is not ported yet; it comes with "
                              "ROADMAP.md queue 1 item 14")]
        if isinstance(opt, str):
            return [SpecIssue("optimizer", opt,
                              "unknown optimizer; expected 'sgd', 'adamw', "
                              "'adafactor' or an Optimizer")]
        if not (callable(getattr(opt, "init", None))
                and callable(getattr(opt, "update", None))):
            return [SpecIssue("optimizer", opt,
                              "expected an Optimizer (init, update)")]
        return []

    def _validate_spmd(self, st: StrategyConfig,
                       schedule: ScheduleSpec) -> List[SpecIssue]:
        """The spmd step is a synchronous cohort step. Selection, dropout,
        per-client LR scaling and quantized updates run on the device
        control plane as cohort masking, so only knobs that need the
        event-driven simulator are refused."""
        issues = []
        if not schedule.is_sync:
            issues.append(SpecIssue(
                "schedule.kind", schedule.kind,
                "engine='spmd' does not support asynchronous schedules — "
                "the quorum clock is event-driven (use engine='sim')"))
        if st.dynamic_batch:
            issues.append(SpecIssue(
                "strategy.dynamic_batch", st.dynamic_batch,
                "engine='spmd' does not support dynamic_batch (the cohort "
                "batch has one shape for every round)"))
        return issues
