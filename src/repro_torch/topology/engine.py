"""The multi-tier sync engine: ``TopologyState`` + ``TopologyRuntime.step``.

Topology rides ON TOP of the flat round as an accumulate-and-sync
measurement layer, as in the JAX package: the flat training trajectory is
unchanged (a run's records with a topology equal those without one, bit
for bit). Each round every leaf pod accumulates its clients' weighted
delta contributions (the pod accumulators sum to the round's weighted
sum). A boundary b (tier b children -> tier b+1 parents) syncs when
``(r + 1) % tiers[b+1].sync_every == 0``, a closed form on the ABSOLUTE
round index, so ``rounds_per_dispatch=R`` gives the state of ``R=1``. On
a sync each parent judges its children's accumulators against its
reference signs, vetoes misaligned pods (θ), with the bootstrap
``has_ref`` and the all-vetoed fallback of ``core/hierarchy.py``;
accepted children are mean-aggregated up, every child accumulator is
reset, and the links charge payloads for accepted pods and beacons for
vetoed ones.

What the port does its own way:

  * The leaf accumulation is a segmented sum in a fixed order, not a
    scatter-add: CUDA's ``index_add_`` adds repeated pod ids with
    atomics, whose order (and so the accumulator's last bits and a
    near-zero reference sign) would change from run to run. The cohort
    is sorted by pod (stably), an inclusive segmented scan adds each
    pod's rows in log2(C) doubling steps, and each pod takes its last
    row: O(C·log C·rows·lane), no atomics, no host read, so two runs,
    and R = 4 against R = 1, give equal bits. It agrees with the JAX
    package's scatter-add to f32 rounding of Σ_c |w_c·u_c|.
  * A θ sync scores every parent's children in ONE launch of the grouped
    ``per_client_sign_align`` (P references, ``kernels/sign_align.py``),
    the port's form of the JAX package's ``jax.vmap`` of the Pallas
    kernel over parents. A boundary without θ launches no count.
  * Each θ boundary keeps on the device its closest θ test (distance to
    θ, round, child slot, ratio) and its count of tests, a fixed five
    floats whatever the run's length: all a parity check needs to see
    how near a veto came to θ (``closest_theta_tests``).
  * ``step`` reads nothing back. With ``r`` a Python int (the loop,
    megastep and scanned paths) a due sync runs and another does not;
    with ``r`` a tensor (the spmd step's ``state.step``) both branches
    are computed and selected by ``torch.where``, as ``lax.cond`` does.
  * The accounting (bytes, seconds, accepts, vetoes) is f32 on the
    device, adding the f32 roundings of the same values the JAX package
    adds, so ``summary()`` equals its summary.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import arena as arena_ops
from repro_torch.kernels import ref as _ref
from repro_torch.topology import comm as comm_mod
from repro_torch.topology import tree as tree_mod
from repro_torch.topology.spec import TopologySpec

__all__ = ["TopologyRuntime", "TopologyState", "empty_topology",
           "init_topology"]


class TopologyState(NamedTuple):
    """Per-tier sync state; every leaf is a tensor on the run's device.

    accum[b]:   (pods[b], rows, lane) f32 — child-side accumulators at
                boundary b (accum[0] is the leaf-pod plane).
    ref[b]:     (pods[b+1], rows, lane) int8 — parent reference signs
                (-2 on arena padding, which no sign matches).
    has_ref[b]: (pods[b+1],) bool — parents that have synced at least once.
    tier_bytes / tier_time / accepts / vetoes: (B,) f32, syncs: (B,) int32
                — cumulative per-boundary accounting.
    """
    accum: Tuple
    ref: Tuple
    has_ref: Tuple
    tier_bytes: torch.Tensor
    tier_time: torch.Tensor
    syncs: torch.Tensor
    accepts: torch.Tensor
    vetoes: torch.Tensor


def empty_topology(device=None) -> TopologyState:
    """Zero-width placeholder state of a run without a topology."""
    dev = resolve_device(device)
    zf = torch.zeros((0,), dtype=torch.float32, device=dev)
    return TopologyState(accum=(), ref=(), has_ref=(), tier_bytes=zf,
                         tier_time=zf.clone(),
                         syncs=torch.zeros((0,), dtype=torch.int32,
                                           device=dev),
                         accepts=zf.clone(), vetoes=zf.clone())


def init_topology(tree: tree_mod.TopologyTree, arena,
                  device=None) -> TopologyState:
    dev = resolve_device(device)
    base_ref = torch.from_numpy(np.where(arena.valid_mask(), 0, -2)
                                .astype(np.int8)).to(dev)
    accum, ref, has_ref = [], [], []
    for b in range(tree.num_boundaries):
        parents = tree.pods[b + 1]
        accum.append(torch.zeros((tree.pods[b], arena.rows, arena.lane),
                                 dtype=torch.float32, device=dev))
        ref.append(base_ref[None].repeat(parents, 1, 1))
        has_ref.append(torch.zeros((parents,), dtype=torch.bool,
                                   device=dev))
    nb = tree.num_boundaries

    def zeros(dtype=torch.float32):
        return torch.zeros((nb,), dtype=dtype, device=dev)

    return TopologyState(accum=tuple(accum), ref=tuple(ref),
                         has_ref=tuple(has_ref), tier_bytes=zeros(),
                         tier_time=zeros(), syncs=zeros(torch.int32),
                         accepts=zeros(), vetoes=zeros())


def _select(due: torch.Tensor, new, old):
    """``new`` where the 0-dim bool ``due`` holds, else ``old``, leaf by
    leaf over the state's tensors and tuples of tensors."""
    if isinstance(old, tuple):
        return type(old)(*(_select(due, n, o) for n, o in zip(new, old))) \
            if hasattr(old, "_fields") else tuple(
                _select(due, n, o) for n, o in zip(new, old))
    return torch.where(due, new, old)


class TopologyRuntime:
    """Prepared engine for a fixed (spec, num_clients, arena, comm) on one
    device.

    ``step(state, r, deltas, w, pods)``: deltas (C, rows, lane) and
    weights (C,) are the SAME cohort-packed deltas and weights the flat
    aggregation consumed that round (w == 0 for non-participants),
    ``pods`` the (C,) int64 leaf pod of each cohort row (default: the
    full 0..N-1 assignment ``pod_of``), and ``r`` the absolute round
    index. Call it every round on every path: the cadence must advance
    on empty rounds too.
    """

    def __init__(self, spec: TopologySpec, num_clients: int, arena,
                 comm=None, device=None):
        self.spec = spec
        self.arena = arena
        self.device = resolve_device(device)
        self.tree = tree_mod.build_tree(spec, num_clients)
        self.links = comm_mod.boundary_links(spec, comm, arena.n)
        dev = self.device
        self.pod_of = torch.from_numpy(tree_mod.leaf_pods(
            self.tree, np.arange(num_clients, dtype=np.int64))).to(
                dev, torch.int64)
        self._pod_ids = torch.arange(self.tree.pods[0], device=dev)
        self._valid = tuple(
            torch.from_numpy(tree_mod.child_valid(self.tree, b)).to(dev)
            for b in range(self.tree.num_boundaries))
        self._vmask = torch.from_numpy(arena.valid_mask()).to(dev)
        # f32 constants on the device: the values the JAX package adds,
        # each rounded once to f32 as its weakly typed Python floats are
        self._n = torch.tensor(max(float(arena.n), 1.0),
                               dtype=torch.float32, device=dev)
        self._zero = torch.zeros((1,), dtype=torch.float32, device=dev)
        # each boundary's closest θ test, on the device: (distance to θ,
        # round, child slot, ratio, tests so far); distance inf before one
        self._closest = [torch.tensor([np.inf, -1.0, -1.0, np.nan, 0.0],
                                      dtype=torch.float32, device=dev)
                         for _ in range(self.tree.num_boundaries)]
        self._syncs = tuple(self._make_sync(b)
                            for b in range(self.tree.num_boundaries))

    def init(self) -> TopologyState:
        return init_topology(self.tree, self.arena, self.device)

    def accumulate(self, acc0: torch.Tensor, deltas: torch.Tensor,
                   w: torch.Tensor, pods: torch.Tensor) -> torch.Tensor:
        """acc0 + Σ_c w_c·deltas_c into pod pods[c], in a fixed order (no
        atomics): the rows sorted by pod, a Hillis-Steele inclusive scan
        within each pod's run of rows, and each pod's last row added."""
        C = deltas.shape[0]
        order = torch.sort(pods, stable=True).indices
        sp = pods[order]
        run = (w.to(torch.float32)[order, None, None]
               * deltas.to(torch.float32)[order]).reshape(C, -1)
        zero = run.new_zeros(())
        s = 1
        while s < C:
            same = (sp[s:] == sp[:-s])[:, None]
            run[s:] += torch.where(same, run[:-s], zero)
            s *= 2
        last = torch.searchsorted(sp, self._pod_ids, right=True) - 1
        has = (last >= 0) & (sp[last.clamp_min(0)] == self._pod_ids)
        total = torch.where(has[:, None], run[last.clamp_min(0)], zero)
        return acc0 + total.reshape(acc0.shape)

    def step(self, state: TopologyState, r, deltas: torch.Tensor,
             w: torch.Tensor, pods=None) -> TopologyState:
        if pods is None:
            pods = self.pod_of
        acc0 = self.accumulate(state.accum[0], deltas, w, pods)
        state = state._replace(accum=(acc0,) + state.accum[1:])
        for b in range(self.tree.num_boundaries):
            cadence = self.spec.tiers[b + 1].sync_every
            if torch.is_tensor(r):
                due = ((r + 1) % cadence) == 0
                state = _select(due, self._syncs[b](state, r, due), state)
            elif (int(r) + 1) % cadence == 0:
                state = self._syncs[b](state, int(r), True)
        return state

    def closest_theta_tests(self) -> list:
        """(boundary, round, child slot, ratio) of each θ boundary's
        closest test to θ so far (bootstrap parents and padding slots
        are not tested), read back in one copy: what a parity check reads
        to see how near a veto came to θ. A boundary without a test has
        no entry."""
        if not self._closest:
            return []
        host = torch.stack(self._closest).cpu().numpy()
        return [(b, int(r), int(j), float(x))
                for b, (d, r, j, x, _n) in enumerate(host) if np.isfinite(d)]

    def theta_test_counts(self) -> list:
        """Each boundary's number of θ tests so far."""
        return [int(c[4]) for c in torch.stack(self._closest).cpu()] \
            if self._closest else []

    def _make_sync(self, b: int):
        tree, spec, dev = self.tree, self.spec, self.device
        children, parents = tree.pods[b], tree.pods[b + 1]
        group = tree.groups[b]
        theta = spec.tiers[b + 1].theta
        valid = self._valid[b]                       # (parents, group)
        vmask = self._vmask                          # (rows, lane)
        link = self.links[b]
        last = b == tree.num_boundaries - 1
        f32 = dict(dtype=torch.float32, device=dev)
        c_children = torch.tensor(float(children), **f32)
        c_payload = torch.tensor(link.payload_bytes, **f32)
        c_beacon = torch.tensor(link.beacon_bytes, **f32)
        c_time = torch.tensor(link.sync_time(), **f32)
        at_b = torch.arange(tree.num_boundaries, device=dev) == b
        c_padding = torch.full((), -2, dtype=torch.int8, device=dev)
        zero = torch.zeros((), **f32)

        def sync(state: TopologyState, r, due) -> TopologyState:
            kids = state.accum[b]                    # (children, r, l)
            pad = parents * group - children
            kids_p = (torch.cat([kids, kids.new_zeros((pad,)
                                                      + kids.shape[1:])])
                      if pad else kids)
            grouped = kids_p.reshape((parents, group) + kids.shape[1:])
            if theta is None:
                passed = valid
            else:
                # one launch: child c against its parent's signs
                ratios = arena_ops.cohort_sign_align(
                    kids_p, state.ref[b]) / self._n
                passed = (ratios.reshape(parents, group) >= theta) & valid
                self._note_tests(b, r, due, ratios, (
                    state.has_ref[b][:, None] & valid).reshape(-1))
            # bootstrap: a parent with no reference yet accepts every real
            # child; then the all-vetoed fallback keeps liveness
            passed = torch.where(~state.has_ref[b][:, None], valid, passed)
            none_passed = passed.sum(dim=1) == 0
            passed = torch.where(none_passed[:, None], valid, passed)
            wf = passed.to(torch.float32)
            denom = torch.clamp_min(wf.sum(dim=1), 1e-9)
            agg = (torch.einsum("pg,pgrl->prl", wf, grouped)
                   / denom[:, None, None])
            new_ref = torch.where(vmask[None], _ref.sign(agg), c_padding)
            accepted = wf.sum()
            vetoed = c_children - accepted
            accum = list(state.accum)
            accum[b] = torch.zeros_like(kids)
            if not last:
                accum[b + 1] = state.accum[b + 1] + agg
            refs = list(state.ref)
            refs[b] = new_ref
            hrs = list(state.has_ref)
            hrs[b] = torch.ones_like(state.has_ref[b])
            return state._replace(
                accum=tuple(accum), ref=tuple(refs), has_ref=tuple(hrs),
                tier_bytes=state.tier_bytes + torch.where(
                    at_b, accepted * c_payload + vetoed * c_beacon, zero),
                tier_time=state.tier_time + torch.where(at_b, c_time, zero),
                syncs=state.syncs + at_b.to(torch.int32),
                accepts=state.accepts + torch.where(at_b, accepted, zero),
                vetoes=state.vetoes + torch.where(at_b, vetoed, zero))

        return sync

    def _note_tests(self, b: int, r, due, ratios, tested) -> None:
        """Fold a sync's θ tests into boundary b's closest test and count,
        on the device; nothing when ``due`` (a bool or 0-dim tensor) is
        false."""
        theta = self.spec.tiers[b + 1].theta
        old = self._closest[b]
        dist = torch.where(tested, (ratios - theta).abs(), torch.inf)
        d, j = dist.min(dim=0, keepdim=True)
        cand = torch.cat([d, self._zero + r, j.to(torch.float32),
                          ratios.gather(0, j)])
        n = tested.sum()
        closer = (d < old[0]) & due
        count = old[4:] + (torch.where(due, n, 0) if torch.is_tensor(due)
                           else n)
        self._closest[b] = torch.cat([torch.where(closer, cand, old[:4]),
                                      count])

    def summary(self, state: TopologyState, rounds=None) -> dict:
        """Host-side per-tier accounting + the flat-star comparison."""
        host = {f: getattr(state, f).cpu().numpy()
                for f in ("tier_bytes", "tier_time", "syncs", "accepts",
                          "vetoes")}
        out = {
            "tiers": [t.name for t in self.spec.tiers],
            "pods": list(self.tree.pods),
            "boundaries": [f"{self.spec.tiers[b].name}->"
                           f"{self.spec.tiers[b + 1].name}"
                           for b in range(self.tree.num_boundaries)],
            "tier_bytes": [float(x) for x in host["tier_bytes"]],
            "tier_time": [float(x) for x in host["tier_time"]],
            "syncs": [int(x) for x in host["syncs"]],
            "accepts": [float(x) for x in host["accepts"]],
            "vetoes": [float(x) for x in host["vetoes"]],
            "total_bytes": float(np.sum(host["tier_bytes"])),
            "payload_bytes": self.links[0].payload_bytes,
        }
        if rounds:
            flat = comm_mod.flat_star_bytes(self.tree.num_clients,
                                            self.arena.n, rounds)
            out["rounds"] = int(rounds)
            out["bytes_per_round"] = out["total_bytes"] / rounds
            out["flat_star_bytes"] = flat
            out["flat_star_bytes_per_round"] = flat / rounds
            out["reduction"] = 1.0 - out["total_bytes"] / max(flat, 1e-9)
        return out
