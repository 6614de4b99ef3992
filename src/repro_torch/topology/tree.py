"""Static tier tree + seeded client->leaf-pod assignment.

The assignment is a seeded affine bijection on client ids,
``perm(c) = (c * mult + offset) % N`` with ``gcd(mult, N) == 1`` checked
on the host at build time, so it is pointwise-computable: a non-resident
million-client world gets pod structure without materializing an (N,)
array — `leaf_pods` works on scalars, numpy arrays and jnp arrays alike
(host math is done in int64 to dodge int32 overflow at N ~ 1e6).
"""
import dataclasses
import math
from typing import Tuple

import numpy as np

from repro_torch.topology.spec import TopologySpec

__all__ = ["TopologyTree", "build_tree", "child_valid", "leaf_pods"]


@dataclasses.dataclass(frozen=True)
class TopologyTree:
    """Resolved node counts + assignment constants for one topology.

    pods[t] is the node count of tier t (pods[-1] == 1, the root);
    groups[b] is the child-slot count per parent at boundary b (tier b
    children -> tier b+1 parents), i.e. the reshape factor for syncs.
    """
    num_clients: int
    leaf_fanout: int
    pods: Tuple[int, ...]
    groups: Tuple[int, ...]
    mult: int
    offset: int

    @property
    def num_boundaries(self):
        return len(self.pods) - 1


def build_tree(spec: TopologySpec, num_clients: int) -> TopologyTree:
    if not spec.active():
        raise ValueError("build_tree needs an active (>= 2 tier) topology")
    if num_clients < 1:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    tiers = spec.tiers
    pods = [max(1, -(-num_clients // tiers[0].fanout))]
    for t in range(1, len(tiers) - 1):
        pods.append(max(1, -(-pods[-1] // tiers[t].fanout)))
    pods.append(1)
    groups = []
    for b in range(len(pods) - 1):
        if b + 1 < len(pods) - 1:
            groups.append(tiers[b + 1].fanout)
        else:
            groups.append(pods[b])          # the root absorbs everything
    rng = np.random.default_rng(spec.assignment_seed)
    offset = int(rng.integers(0, num_clients))
    mult = 1
    if num_clients > 1:
        for _ in range(256):
            cand = int(rng.integers(1, num_clients))
            if math.gcd(cand, num_clients) == 1:
                mult = cand
                break
    return TopologyTree(num_clients=num_clients,
                        leaf_fanout=tiers[0].fanout,
                        pods=tuple(pods), groups=tuple(groups),
                        mult=mult, offset=offset)


def leaf_pods(tree: TopologyTree, ids):
    """Leaf pod id for each client id; pointwise, no (N,) table."""
    ids = np.asarray(ids, dtype=np.int64)
    perm = (ids * tree.mult + tree.offset) % tree.num_clients
    return (perm // tree.leaf_fanout).astype(np.int32)


def child_valid(tree: TopologyTree, b: int) -> np.ndarray:
    """Static (parents, group) bool mask: which child slots at boundary
    b are real tier-b pods (the tail slots of the last parent are arena
    padding introduced by the ceil-division fanout)."""
    parents, group = tree.pods[b + 1], tree.groups[b]
    idx = np.arange(parents * group).reshape(parents, group)
    return idx < tree.pods[b]
