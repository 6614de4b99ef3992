"""Normalized result schema.

Every experiment returns one ``ExperimentResult`` holding per-round
``RoundRecord``s:

  sim_time    simulated end-to-end seconds so far (CommModel units)
  comm_time   cumulative transfer seconds
  idle_time   cumulative barrier-idle seconds (sync semantics)
  bytes_sent  cumulative client->server bytes, 1-bit skip beacons included
  accept_rate fraction of selected clients whose update passed the filter

The port's records have the JAX package's fields and meaning, so the
two packages' results compare field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from repro_torch.models import mlp_detector


@dataclasses.dataclass
class RoundRecord:
    round: int
    sim_time: float
    comm_time: float
    idle_time: float
    bytes_sent: float
    updates_applied: int
    accept_rate: float
    accuracy: float
    loss: float


ROUND_FIELDS = tuple(f.name for f in dataclasses.fields(RoundRecord))


@dataclasses.dataclass
class ExperimentResult:
    engine: str
    strategy: str                     # registry name, or "<custom>"
    rounds: int
    seed: int
    records: List[RoundRecord]
    cfg: Any = None                   # resolved ArchConfig
    params: Any = None                # final global parameters
    eval_arrays: Any = None           # held-out eval split
    num_clients: int = 0
    param_bytes: int = 0              # one full update's wire size
    wall_time: float = 0.0            # real container seconds

    @property
    def final(self) -> Optional[RoundRecord]:
        return self.records[-1] if self.records else None

    def series(self, field: str) -> List[float]:
        return [getattr(r, field) for r in self.records]

    def to_rows(self):
        """Per-round rows in ROUND_FIELDS order (CSV-friendly)."""
        return [[getattr(r, f) for f in ROUND_FIELDS] for r in self.records]

    @property
    def bytes_baseline(self) -> float:
        """Full-participation upload volume for the same world/rounds."""
        return float(self.num_clients) * self.param_bytes * self.rounds

    def auc_roc(self) -> float:
        """Binary AUC-ROC on the eval split (attack against Normal), on the
        parameters' device. Only meaningful for the mlp detector family."""
        dev = next(iter(self.params.values())).device
        x = torch.as_tensor(self.eval_arrays["x"], device=dev)
        y = torch.as_tensor(self.eval_arrays["y"], device=dev)
        probs = mlp_detector.predict(self.params, x, self.cfg)
        scores = 1.0 - probs[:, 0]                 # P(not Normal)
        labels = (y != 0).to(torch.float32)
        return float(mlp_detector.auc_roc(scores, labels))
