"""The random draws of the scanned rounds, as an input.

The JAX package draws inside its ``lax.scan`` from a PRNG key folded with
the absolute round index, which torch cannot replay. The port's scanned
round body (core/megastep.py, ``build_scanned_rounds``) takes its
randomness from a draw source instead, with three calls:

  ``prepare(round0, rounds)``  — once per dispatch, before its rounds;
  ``round_draws(r)``           — (eps_u, pick_u, drop_u), each (K,) f32 in
                                 [0, 1): ε-greedy exploration, pool picks
                                 and dropout for round r;
  ``batch_index(r, sz)``       — (K, steps, batch) int64 sample indices for
                                 the selected cohort, whose shard sizes
                                 ``sz`` (K,) are known only after selection.

``HostDraws`` is the port's own source. A test can hand the engine another
with the same calls, such as one that repeats the JAX package's key
calls, to hold the port to the reference round by round.

The spmd step (core/fl_step.py) takes its draws the same way, one call a
step: ``SpmdDraws.round_draws(step)`` gives (eps_u (k,), pick_u (k,),
drop_u (C,)), the uniforms of ε-greedy exploration, pool picks and
dropout that the JAX package draws from ``fold_in(PRNGKey(seed), step)``.

The population plane's round (core/population.py,
``build_population_round``) observes synthetic cohort outcomes, which the
JAX package draws from ``fold_in(PRNGKey(seed), r)`` split in four:
failed ~ Bernoulli(0.05), passed ~ Bernoulli(0.9), round time ~ U(0.5,
1.5) and update norm ~ U(0.1, 2.0), K each. ``PopulationDraws(seed, k,
device).round(r)`` is the port's source of them; a test feeds the
reference's through any object with the same ``round``.

A scenario's link walks (core/scenario.py) take one standard normal a
client a round for bandwidth and one for latency, which the JAX package
draws from ``fold_in(PRNGKey(links.seed), r)`` split in two.
``LinkNormals(seed, n)(r)`` is the port's source of them;
``scenario.WorldSource`` takes any callable of the same form, so a test can
give an engine the reference's normals (or its whole world trajectory).
"""
from __future__ import annotations

import numpy as np
import torch


class HostDraws:
    """Uniforms from a numpy Generator seeded with (seed, absolute round),
    so a round's draws do not depend on how the rounds are grouped into
    dispatches (``rounds_per_dispatch=R`` gives the same run as ``=1``).

    ``prepare`` draws every uniform of the dispatch's rounds on the host
    and copies them to the device in one copy, from pinned memory and
    without blocking when the device is a card. Sample indices are
    ``min(floor(u · sz), sz − 1)``, computed on the device, so the same
    draws give the same batches on the card and on the CPU."""

    def __init__(self, seed: int, k: int, steps: int, batch: int, device):
        self.seed = int(seed)
        self.k, self.steps, self.batch = int(k), int(steps), int(batch)
        self.device = torch.device(device)
        self._round0 = 0
        self._buf = None            # (rounds, 3K + K·steps·batch) f32

    def prepare(self, round0: int, rounds: int) -> None:
        # one f32 row a round: eps | pick | drop | data
        width = 3 * self.k + self.k * self.steps * self.batch
        rows = np.stack([
            np.random.default_rng([self.seed, round0 + j]).random(
                width, dtype=np.float32) for j in range(rounds)])
        self._buf = _to_device(torch.from_numpy(rows), self.device)
        self._round0 = int(round0)

    def _row(self, r: int) -> torch.Tensor:
        return self._buf[int(r) - self._round0]

    def round_draws(self, r: int):
        row, k = self._row(r), self.k
        return row[:k], row[k:2 * k], row[2 * k:3 * k]

    def batch_index(self, r: int, sz: torch.Tensor) -> torch.Tensor:
        u = self._row(r)[3 * self.k:].reshape(self.k, self.steps, self.batch)
        n = sz.to(torch.float32).reshape(-1, 1, 1)
        idx = torch.floor(u * n).to(torch.int64)
        return torch.minimum(idx, (sz.to(torch.int64) - 1).reshape(-1, 1, 1))


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; to a card from pinned memory, without
    blocking."""
    if device.type == "cuda":
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        host = pinned
    return host.to(device, non_blocking=True)


class SpmdDraws:
    """The spmd step's uniforms from a numpy Generator seeded with
    (seed, absolute step): a step's draws do not depend on what ran
    before it. ``k`` is the selection width, ``num_clients`` the cohort."""

    def __init__(self, seed: int, num_clients: int, k: int, device):
        self.seed = int(seed)
        self.num_clients, self.k = int(num_clients), int(k)
        self.device = torch.device(device)

    def round_draws(self, step: int):
        k, c = self.k, self.num_clients
        row = np.random.default_rng([self.seed, int(step)]).random(
            2 * k + c, dtype=np.float32)
        dev = _to_device(torch.from_numpy(row), self.device)
        return dev[:k], dev[k:2 * k], dev[2 * k:]


class LinkNormals:
    """The link walks' standard normals of round r, ``(bw (n,), lat (n,))``
    f32 numpy, from a numpy Generator seeded with (seed, absolute round):
    a round's normals do not depend on the rounds before it."""

    def __init__(self, seed: int, n: int):
        self.seed, self.n = int(seed), int(n)

    def __call__(self, r: int):
        z = np.random.default_rng([self.seed, int(r)]).standard_normal(
            2 * self.n, dtype=np.float32)
        return z[:self.n], z[self.n:]


class PopulationDraws:
    """The population round's synthetic observations of round r, (failed,
    passed, round_time, norms) of the K slots on the device, from a numpy
    Generator seeded with (seed, absolute round): bool, bool, f32 in [0.5,
    1.5) and f32 in [0.1, 2.0), copied in one pinned, non-blocking copy."""

    def __init__(self, seed: int, k: int, device):
        self.seed, self.k = int(seed), int(k)
        self.device = torch.device(device)

    def round(self, r: int):
        k = self.k
        u = np.random.default_rng([self.seed, int(r)]).random(
            4 * k, dtype=np.float32)
        row = np.concatenate([u[:k] < 0.05, u[k:2 * k] < 0.9]).astype(
            np.float32)
        vals = np.concatenate([row, np.float32(0.5) + u[2 * k:3 * k],
                               np.float32(0.1) + np.float32(1.9)
                               * u[3 * k:]])
        dev = _to_device(torch.from_numpy(vals), self.device)
        return (dev[:k] != 0, dev[k:2 * k] != 0, dev[2 * k:3 * k],
                dev[3 * k:])
