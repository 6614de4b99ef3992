"""Hierarchical federation as a declarative axis, in PyTorch.

A ``TopologySpec`` declares a tier tree (edge pod -> region -> global);
clients map to leaf pods by a seeded static assignment, and the engine
runs ``TopologyRuntime.step`` on every execution path (loop, megastep,
scanned dispatch, spmd step). The flat training trajectory is untouched:
topology is an accumulate-and-sync measurement layer whose per-tier sync
cadence, sign-alignment vetoes and link pricing quantify what hierarchy
saves over a flat star.

    from repro_torch.api import ExperimentSpec, TierSpec, TopologySpec

    spec = ExperimentSpec(topology=TopologySpec(tiers=(
        TierSpec("edge", fanout=8, sync_every=1),
        TierSpec("region", fanout=4, sync_every=4, theta=0.65),
        TierSpec("global", sync_every=16),
    )), rounds=32)

``spec``, ``tree`` and ``comm`` are numpy-only copies of the JAX
package's modules; ``engine`` is the port's (torch, one grouped
sign-align launch a θ sync).
"""
from repro_torch.topology.comm import (PARAM_BYTES, TierLink,
                                       boundary_links, flat_star_bytes)
from repro_torch.topology.engine import (TopologyRuntime, TopologyState,
                                         empty_topology, init_topology)
from repro_torch.topology.spec import (TOPOLOGY_PRESETS, TierSpec,
                                       TopologySpec, resolve_topology)
from repro_torch.topology.tree import (TopologyTree, build_tree,
                                       child_valid, leaf_pods)

__all__ = [
    "PARAM_BYTES", "TOPOLOGY_PRESETS", "TierLink", "TierSpec",
    "TopologyRuntime", "TopologySpec", "TopologyState", "TopologyTree",
    "boundary_links", "build_tree", "child_valid", "empty_topology",
    "flat_star_bytes", "init_topology", "leaf_pods", "resolve_topology",
]
