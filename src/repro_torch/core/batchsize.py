"""Dynamic batch-size optimization (paper §IV-A).

Clients report local metrics (compute capacity, memory headroom, network
latency); the server assigns a batch size proportional to available
resources — "a high-capacity client might train with 512 samples per
batch ... a lower-capacity client uses 64 to prevent straggler delays".

The controller also adapts across rounds from observed round times
(straggler feedback): clients that finish far after the round median get
their batch lowered a power-of-two step; fast clients are promoted.

A copy of the JAX package's ``core/batchsize.py``, kept identical in output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

_POW2 = (64, 128, 256, 512, 1024)


@dataclasses.dataclass
class ClientMetrics:
    compute: float       # relative throughput, 1.0 = reference
    memory: float        # free-memory fraction in [0,1]
    latency: float       # network RTT seconds


def capacity_score(m: ClientMetrics) -> float:
    """Scalar capacity in (0, ~2]: throughput-dominant, latency-penalized."""
    lat_penalty = 1.0 / (1.0 + 10.0 * max(m.latency, 0.0))
    return max(m.compute, 1e-3) * (0.5 + 0.5 * min(max(m.memory, 0.0), 1.0)) \
        * lat_penalty


def assign_batch_size(m: ClientMetrics, b_min: int = 64,
                      b_max: int = 1024) -> int:
    """Map capacity to the nearest power-of-two batch in [b_min, b_max]."""
    score = capacity_score(m)
    # score 1.0 (reference client) -> geometric middle of the range
    mid = math.sqrt(b_min * b_max)
    raw = mid * score
    best = min(_POW2, key=lambda b: abs(math.log(b) - math.log(max(raw, 1))))
    return int(min(max(best, b_min), b_max))


class BatchSizeController:
    """Cross-round adaptation from straggler feedback (§IV-A)."""

    def __init__(self, b_min: int = 64, b_max: int = 1024,
                 straggler_factor: float = 1.5):
        self.b_min, self.b_max = b_min, b_max
        self.straggler_factor = straggler_factor
        self.assignment: Dict[int, int] = {}

    def initial(self, cid: int, metrics: ClientMetrics) -> int:
        b = assign_batch_size(metrics, self.b_min, self.b_max)
        self.assignment[cid] = b
        return b

    def feedback(self, round_times: Dict[int, float]) -> Dict[int, int]:
        if not round_times:
            return dict(self.assignment)
        med = sorted(round_times.values())[len(round_times) // 2]
        for cid, t in round_times.items():
            b = self.assignment.get(cid, self.b_min)
            if t > self.straggler_factor * med and b > self.b_min:
                self.assignment[cid] = b // 2      # demote straggler
            elif t < med / self.straggler_factor and b < self.b_max:
                self.assignment[cid] = b * 2      # promote fast client
        return dict(self.assignment)
