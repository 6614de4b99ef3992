"""First-class, pluggable FL strategies (the algorithm-object idiom).

A *strategy* is a named object that knows how to build the engine-level
``StrategyConfig`` for a run. Strategies live in a string-keyed registry
so experiment specs can reference them declaratively::

    spec = ExperimentSpec(strategy="ours",
                          strategy_kwargs={"batch_size": 128})

and user code can add its own without touching this package::

    @register_strategy("fedavg-big")
    def fedavg_big(batch_size=1024, **kw):
        return STRATEGY_REGISTRY["fedavg"].build(batch_size=batch_size, **kw)

The five paper baselines (Table II, Fig. 4) are registered here; their
faithfulness notes live with each factory. A copy of the JAX package's
``api/strategies.py`` over the port's ``StrategyConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Union

from repro_torch.core.async_engine import StrategyConfig


def _finish(cfg: StrategyConfig, overrides: Dict) -> StrategyConfig:
    """Apply remaining StrategyConfig field overrides (lets callers pass
    any engine knob — quorum, max_samples_per_round, ... — through a
    preset without the preset enumerating every field)."""
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


class Strategy:
    """Base class for pluggable strategies.

    Subclasses override :meth:`build` to return the ``StrategyConfig``
    the engines consume; ``defaults`` are merged under call-site kwargs.
    """

    name: str = "strategy"
    description: str = ""
    defaults: Dict = {}

    def build(self, **overrides) -> StrategyConfig:
        kwargs = {**self.defaults, **overrides}
        return StrategyConfig(**kwargs)

    def __repr__(self):
        return f"<Strategy {self.name!r}>"


class _FunctionStrategy(Strategy):
    """Wraps a plain factory function ``f(**kw) -> StrategyConfig``."""

    def __init__(self, name: str, fn: Callable[..., StrategyConfig],
                 description: str = ""):
        self.name = name
        self.fn = fn
        self.description = description or (fn.__doc__ or "").strip()

    def build(self, **overrides) -> StrategyConfig:
        return self.fn(**overrides)


STRATEGY_REGISTRY: Dict[str, Strategy] = {}


def register_strategy(name: str, description: str = ""):
    """Decorator registering a strategy under ``name``.

    Accepts a ``Strategy`` subclass, a ``Strategy`` instance, or a plain
    factory function returning a ``StrategyConfig``. Returns the
    decorated object unchanged so it stays importable.
    """

    def deco(obj):
        if isinstance(obj, type) and issubclass(obj, Strategy):
            strat = obj()
            strat.name = name
        elif isinstance(obj, Strategy):
            strat = obj
            strat.name = name
        elif callable(obj):
            strat = _FunctionStrategy(name, obj, description)
        else:
            raise TypeError(
                f"register_strategy({name!r}): expected a Strategy class, "
                f"Strategy instance or factory function, got {type(obj)}")
        if description:
            strat.description = description
        STRATEGY_REGISTRY[name] = strat
        return obj

    return deco


def get_strategy(name: str) -> Strategy:
    try:
        return STRATEGY_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered: "
            f"{sorted(STRATEGY_REGISTRY)}") from None


def list_strategies() -> List[str]:
    return sorted(STRATEGY_REGISTRY)


def resolve_strategy(strategy: Union[str, Strategy, StrategyConfig,
                                     Callable[..., StrategyConfig]],
                     **overrides) -> StrategyConfig:
    """Normalize any accepted strategy form to a ``StrategyConfig``."""
    if isinstance(strategy, StrategyConfig):
        return (dataclasses.replace(strategy, **overrides)
                if overrides else strategy)
    if isinstance(strategy, str):
        return get_strategy(strategy).build(**overrides)
    if isinstance(strategy, Strategy):
        return strategy.build(**overrides)
    if callable(strategy):                    # bare factory function
        return strategy(**overrides)
    raise TypeError(f"cannot resolve strategy from {type(strategy)}")


# ---------------------------------------------------------------------------
# The paper's baselines (Table II, Fig. 4) — faithfulness notes inline.
# ---------------------------------------------------------------------------

@register_strategy("fedavg", "McMahan et al. [10]: synchronous, full "
                   "participation, no filtering — the paper's Sync baseline")
def fedavg(batch_size=64, lr=5e-3, local_epochs=1,
           **overrides) -> StrategyConfig:
    return _finish(StrategyConfig(mode="sync", theta=None, selection=False,
                                  dynamic_batch=False, checkpointing=False,
                                  batch_size=batch_size, lr=lr,
                                  local_epochs=local_epochs), overrides)


@register_strategy("cmfl", "Luping et al. [5]: upload only updates whose "
                   "sign agrees with the previous global update — "
                   "synchronous, same alignment test, no async/selection")
def cmfl(batch_size=64, lr=5e-3, theta=0.65, local_epochs=1,
         **overrides) -> StrategyConfig:
    return _finish(StrategyConfig(mode="sync", theta=theta, selection=False,
                                  dynamic_batch=False, checkpointing=False,
                                  batch_size=batch_size, lr=lr,
                                  local_epochs=local_epochs), overrides)


@register_strategy("acfl", "Yan et al. [11] CriticalFL: selection favours "
                   "large early-training gradient norms; synchronous")
def acfl(batch_size=64, lr=5e-3, select_fraction=0.7, local_epochs=1,
         **overrides) -> StrategyConfig:
    return _finish(StrategyConfig(mode="sync", theta=None, selection=True,
                                  select_fraction=select_fraction,
                                  grad_norm_selection=True,
                                  dynamic_batch=False, checkpointing=False,
                                  batch_size=batch_size, lr=lr,
                                  local_epochs=local_epochs), overrides)


@register_strategy("fedl2p", "Lee et al. [4]: per-client learned LR scaling "
                   "(simplified meta-rule); synchronous, no filtering")
def fedl2p(batch_size=64, lr=5e-3, local_epochs=1,
           **overrides) -> StrategyConfig:
    return _finish(StrategyConfig(mode="sync", theta=None, selection=False,
                                  dynamic_batch=False, checkpointing=False,
                                  per_client_lr=True, batch_size=batch_size,
                                  lr=lr, local_epochs=local_epochs),
                   overrides)


@register_strategy("ours", "the paper's framework: async + θ-filter + "
                   "adaptive selection + dynamic batch + Weibull ckpt")
def ours(batch_size=64, lr=5e-3, theta=0.65, local_epochs=1,
         dynamic_batch=True, select_fraction=1.0,
         **overrides) -> StrategyConfig:
    return _finish(StrategyConfig(mode="async", theta=theta, selection=True,
                                  select_fraction=select_fraction,
                                  dynamic_batch=dynamic_batch,
                                  checkpointing=True, batch_size=batch_size,
                                  lr=lr, local_epochs=local_epochs),
                   overrides)


# legacy name -> factory mapping (core/baselines.py re-exports it)
PRESETS = {"fedavg": fedavg, "cmfl": cmfl, "acfl": acfl,
           "fedl2p": fedl2p, "ours": ours}
