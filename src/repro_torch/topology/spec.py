"""Declarative tier trees: `TierSpec` / `TopologySpec`.

Follows the `core/scenario.py` spec idiom: frozen dataclasses whose
`issues(prefix)` return (field, value, hint) triples that
`ExperimentSpec.validate()` folds into one `SpecError`, plus a
`resolve_topology` normalizer that maps presets by name and collapses
inactive (single-tier) topologies to None so a flat topology is the
no-topology path by construction.

Tier semantics: `tiers[0]` is the leaf tier whose pods hold
`tiers[0].fanout` clients each; `tiers[t].fanout` (t > 0, non-root) is
the number of tier-(t-1) pods per tier-t pod; the root tier absorbs
every pod below it regardless of fanout.  `tiers[t].sync_every` is the
round cadence at which tier-(t-1) accumulators sync up into tier t
(the leaf tier accumulates every round, so its cadence must be 1), and
`theta` is the per-tier sign-alignment veto threshold (None = accept
every child on each sync).
"""
import dataclasses
from typing import Optional, Tuple, Union

__all__ = ["TOPOLOGY_PRESETS", "TierSpec", "TopologySpec",
           "resolve_topology"]


@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    fanout: Optional[int] = None
    sync_every: int = 1
    theta: Optional[float] = None
    lat_scale: float = 1.0
    bw_scale: float = 1.0

    def issues(self, prefix=""):
        out = []
        if not self.name:
            out.append((prefix + "name", self.name, "tier needs a name"))
        if self.fanout is not None and self.fanout < 1:
            out.append((prefix + "fanout", self.fanout, "must be >= 1"))
        if self.sync_every < 1:
            out.append((prefix + "sync_every", self.sync_every,
                        "must be >= 1"))
        if self.theta is not None and not 0.0 <= self.theta <= 1.0:
            out.append((prefix + "theta", self.theta,
                        "must be in [0, 1] or None"))
        if self.lat_scale <= 0.0:
            out.append((prefix + "lat_scale", self.lat_scale,
                        "must be > 0"))
        if self.bw_scale <= 0.0:
            out.append((prefix + "bw_scale", self.bw_scale, "must be > 0"))
        return out


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    tiers: Tuple[TierSpec, ...] = ()
    assignment_seed: int = 0

    def __post_init__(self):
        if isinstance(self.tiers, list):
            object.__setattr__(self, "tiers", tuple(self.tiers))

    def active(self):
        """A topology with fewer than two tiers has no boundary to sync
        across: it is the flat star and resolves to None."""
        return len(self.tiers) >= 2

    def issues(self, prefix="topology."):
        out = []
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            out.append((prefix + "tiers", tuple(names),
                        "tier names must be unique"))
        for i, tier in enumerate(self.tiers):
            out.extend(tier.issues(f"{prefix}tiers[{i}]."))
        if self.active():
            if self.tiers[0].sync_every != 1:
                out.append((prefix + "tiers[0].sync_every",
                            self.tiers[0].sync_every,
                            "leaf tier accumulates every round"))
            for i, tier in enumerate(self.tiers[:-1]):
                if tier.fanout is None:
                    out.append((f"{prefix}tiers[{i}].fanout", None,
                                "non-root tiers need a fanout"))
            for i in range(1, len(self.tiers)):
                lo = self.tiers[i - 1].sync_every
                hi = self.tiers[i].sync_every
                if lo and hi % lo != 0:
                    out.append((f"{prefix}tiers[{i}].sync_every", hi,
                                f"must be a multiple of tier {i - 1}'s "
                                f"sync_every={lo} (nested cadence)"))
        return out


TOPOLOGY_PRESETS = {
    # the ISSUE / paper Fig. 2 shape: frequent edge-pod accumulation,
    # selective regional syncs, rare global syncs
    "edge-region-global": TopologySpec(tiers=(
        TierSpec("edge", fanout=8, sync_every=1),
        TierSpec("region", fanout=4, sync_every=4, theta=0.65),
        TierSpec("global", sync_every=16),
    )),
    # the core/hierarchy.py 2-tier special case as a preset
    "two-tier-pods": TopologySpec(tiers=(
        TierSpec("pod", fanout=8, sync_every=1),
        TierSpec("global", sync_every=4, theta=0.65),
    )),
}


def resolve_topology(value: Union[None, str, TopologySpec]):
    """Normalize a topology knob to an *active* TopologySpec or None.

    Accepts None, a preset name, or a TopologySpec; single-tier (or
    empty) topologies normalize to None so that a flat topology is
    bit-exact with today's path because it IS today's path.
    """
    if value is None:
        return None
    if isinstance(value, str):
        if value not in TOPOLOGY_PRESETS:
            raise ValueError(
                f"unknown topology preset {value!r}; "
                f"known: {sorted(TOPOLOGY_PRESETS)}")
        value = TOPOLOGY_PRESETS[value]
    if not isinstance(value, TopologySpec):
        raise TypeError(f"topology must be None, a preset name or a "
                        f"TopologySpec, got {type(value).__name__}")
    return value if value.active() else None
