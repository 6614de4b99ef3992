"""Per-tier link pricing for inter-tier syncs.

Edge uplinks (client -> leaf pod) are already priced by the flat
engine's `CommModel` / `LinkSpec` walks as `bytes_sent`; this module
prices only the NEW traffic hierarchy introduces — pod payloads crossing
tier boundaries when a sync fires.  Accepted (sign-alignment-passing)
children ship a full payload; vetoed children ship only a beacon, the
same beacon-byte convention the flat selective-update path uses.  The
flat-star equivalent (every client's payload crossing the WAN to one
server every round) is the baseline hierarchy is measured against.
"""
import dataclasses
from typing import Tuple

from repro_torch.topology.spec import TopologySpec

__all__ = ["PARAM_BYTES", "TierLink", "boundary_links", "flat_star_bytes"]

# wire width of one aggregated parameter on an inter-tier link (f32)
PARAM_BYTES = 4.0


@dataclasses.dataclass(frozen=True)
class TierLink:
    """Resolved link pricing for one boundary (tier b -> tier b+1)."""
    payload_bytes: float
    beacon_bytes: float
    latency: float
    bandwidth: float

    def sync_bytes(self, accepted, vetoed):
        return accepted * self.payload_bytes + vetoed * self.beacon_bytes

    def sync_time(self):
        """One sync wave: per-tier links are homogeneous and transfer in
        parallel, so the wave costs one latency + one payload transfer."""
        return self.latency + self.payload_bytes / self.bandwidth


def boundary_links(spec: TopologySpec, comm, n_params: int
                   ) -> Tuple[TierLink, ...]:
    """One `TierLink` per boundary, scaled off the experiment's
    `CommModel` (duck-typed: latency / bandwidth / beacon_bytes) by the
    parent tier's lat_scale / bw_scale."""
    latency = getattr(comm, "latency", 0.05) if comm is not None else 0.05
    bandwidth = (getattr(comm, "bandwidth", 1e9)
                 if comm is not None else 1e9)
    beacon = (getattr(comm, "beacon_bytes", 0.125)
              if comm is not None else 0.125)
    payload = float(n_params) * PARAM_BYTES
    return tuple(
        TierLink(payload_bytes=payload, beacon_bytes=float(beacon),
                 latency=float(latency) * tier.lat_scale,
                 bandwidth=float(bandwidth) * tier.bw_scale)
        for tier in spec.tiers[1:])


def flat_star_bytes(num_clients: int, n_params: int, rounds: int) -> float:
    """Inter-tier bytes of the flat-star equivalent: every client's
    payload crosses the single WAN aggregation point every round."""
    return float(num_clients) * float(n_params) * PARAM_BYTES * float(rounds)
