"""Architecture configuration: the fields the mlp family reads.

The JAX package's ``ArchConfig`` describes every family it supports; the
port carries only what the anomaly-detection MLP reads, under the same
names, so a config reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # only "mlp" in the port so far
    source: str = ""                 # citation for the config
    mlp_hidden: Tuple[int, ...] = ()
    num_features: int = 0
    num_classes: int = 0
    dropout: float = 0.0             # the paper's; training applies none

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        dims = (self.num_features,) + tuple(self.mlp_hidden) + (self.num_classes,)
        return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
