"""Deprecated shim: the baseline strategies live in
``repro_torch.api.strategies``.

The five paper baselines (Table II, Fig. 4) are registry entries; prefer::

    from repro_torch.api import get_strategy
    strategy = get_strategy("ours").build(batch_size=128)

or, declaratively, ``ExperimentSpec(strategy="ours", ...)``. This module
re-exports the factory functions and the ``PRESETS`` mapping, as the JAX
package's ``core/baselines.py`` does.
"""
from __future__ import annotations

from repro_torch.api.strategies import (PRESETS, acfl, cmfl, fedavg, fedl2p,
                                        ours)

__all__ = ["PRESETS", "acfl", "cmfl", "fedavg", "fedl2p", "ours"]
