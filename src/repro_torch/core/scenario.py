"""Dynamic-world scenarios (paper §V, "varying client conditions"), in
PyTorch: the non-stationary world the control plane was built for.

A :class:`ScenarioSpec` composes per-round world transitions:

  drift      — label-conditional feature shift x ← x + amp(t)·dir[y], the
               amplitude on a linear or sinusoidal schedule;
  churn      — a rotating block of clients is offline each membership
               phase (deterministic: every path sees the same roster);
  links      — per-client multiplicative lognormal walks on bandwidth and
               latency, re-pricing every transfer;
  dropout    — a piecewise-constant multiplier on every profile's dropout
               probability;
  byzantine  — the first ``n_byz`` clients scale and/or sign-flip their
               updates before transmission: the updates the θ filter
               exists to reject.

The spec classes, presets and validation are the JAX package's, with the
same field names and hints. The world is a :class:`WorldState` of tensors
and :func:`world_step` its transition, in the JAX package's f32
operations. The world never depends on the training state: churn,
amplitude and regime are functions of the round index, and the link walks
of their normals (core/draws.py, ``LinkNormals``; the JAX package folds a
PRNG key with the round, which torch cannot replay). So every path takes
its world from a :class:`WorldSource`, which computes the trajectory on
the host, once, with the same function for every path: the card and the
CPU see the same bits, a scanned dispatch copies its rounds' worlds to the
device in one copy, and R rounds a dispatch replay R = 1 exactly. A test
hands an engine the JAX package's own trajectory through the same class.

``DriftStats`` and its functions measure drift on served traffic (the
serving monitor's side, ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.draws import LinkNormals, _to_device

DRIFT_MODES = ("linear", "sine")


# ---------------------------------------------------------------------------
# component specs (all pure data, all frozen)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Label-conditional concept drift: x ← x + amp(round)·dir[y].

    ``dir`` is a fixed (num_classes, num_features) matrix drawn once
    from ``seed`` (unit-ish rows), so the drift moves each class's
    feature cloud along its own direction — the class-conditional shift
    that degrades a frozen detector but not an adapting one. ``linear``
    grows amp by ``rate`` per round up to ``max_amp``; ``sine`` cycles
    0 → max_amp → 0 with the given ``period``. Round 0 has amp 0, so a
    drift world is indistinguishable from a static one at round 0.
    Training batches drift; the eval split stays at the round-0
    distribution (accuracy measures the original task).
    """
    rate: float = 0.05
    max_amp: float = 1.0
    mode: str = "linear"          # linear | sine
    period: int = 16              # sine mode: rounds per full cycle
    seed: int = 0

    def issues(self, prefix="scenario.drift") -> List[Tuple[str, object, str]]:
        out = []
        if self.mode not in DRIFT_MODES:
            out.append((f"{prefix}.mode", self.mode,
                        f"expected one of {DRIFT_MODES}"))
        if self.rate < 0:
            out.append((f"{prefix}.rate", self.rate, "rate must be >= 0"))
        if self.max_amp <= 0:
            out.append((f"{prefix}.max_amp", self.max_amp,
                        "max_amp must be > 0"))
        if self.period < 1:
            out.append((f"{prefix}.period", self.period,
                        "period must be >= 1"))
        return out


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """Join/leave membership: every ``period`` rounds the offline block
    of ``round(leave_frac·N)`` clients rotates to the next position, so
    clients keep joining and leaving but the live count stays constant
    (the mask-conservation invariant the differential harness checks).
    Deterministic by construction — no draws — so the host loop, the
    scanned control plane and the spmd path agree on the roster bit-
    for-bit. ``seed`` offsets the rotation start."""
    period: int = 4
    leave_frac: float = 0.25
    seed: int = 0

    def issues(self, prefix="scenario.churn") -> List[Tuple[str, object, str]]:
        out = []
        if self.period < 1:
            out.append((f"{prefix}.period", self.period,
                        "period must be >= 1"))
        if not (0.0 <= self.leave_frac < 1.0):
            out.append((f"{prefix}.leave_frac", self.leave_frac,
                        "leave_frac must be in [0, 1) — at least one "
                        "client must stay live"))
        return out


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Per-client link-quality walks: bandwidth and latency scales take
    multiplicative lognormal steps each round, clipped to
    [1/clip, clip]. Transfer time is re-priced every round as
    ``latency·lat_scale + bytes/(bandwidth·bw_scale)`` — the flaky-link
    regime that makes reliability-scored selection earn its keep. The
    steps draw from a key folded with the absolute round index, so the
    walk is identical on every execution path and at any
    rounds_per_dispatch grouping."""
    bw_sigma: float = 0.25
    lat_sigma: float = 0.25
    clip: float = 4.0
    seed: int = 0

    def issues(self, prefix="scenario.links") -> List[Tuple[str, object, str]]:
        out = []
        if self.bw_sigma < 0:
            out.append((f"{prefix}.bw_sigma", self.bw_sigma,
                        "bw_sigma must be >= 0"))
        if self.lat_sigma < 0:
            out.append((f"{prefix}.lat_sigma", self.lat_sigma,
                        "lat_sigma must be >= 0"))
        if self.clip <= 1.0:
            out.append((f"{prefix}.clip", self.clip, "clip must be > 1"))
        return out


@dataclasses.dataclass(frozen=True)
class DropoutSchedule:
    """Failure-rate regime switches: a piecewise-constant multiplier on
    every profile's dropout_p. ``scales[i]`` applies from round
    ``boundaries[i-1]`` (inclusive) to ``boundaries[i]`` (exclusive);
    ``scales[0]`` applies before the first boundary."""
    boundaries: Tuple[int, ...] = (8,)
    scales: Tuple[float, ...] = (1.0, 3.0)

    def issues(self, prefix="scenario.dropout") -> List[Tuple[str, object, str]]:
        out = []
        if len(self.scales) != len(self.boundaries) + 1:
            out.append((f"{prefix}.scales", self.scales,
                        f"need len(boundaries)+1 = "
                        f"{len(self.boundaries) + 1} scales"))
        if any(b2 <= b1 for b1, b2 in zip(self.boundaries,
                                          self.boundaries[1:])):
            out.append((f"{prefix}.boundaries", self.boundaries,
                        "boundaries must be strictly increasing"))
        if any(s < 0 for s in self.scales):
            out.append((f"{prefix}.scales", self.scales,
                        "scales must be >= 0"))
        return out


@dataclasses.dataclass(frozen=True)
class ByzantineSpec:
    """Adversarial clients: the FIRST ``n_byz`` client ids transmit
    updates multiplied by ``-scale`` (sign_flip) or ``+scale``. A
    sign-flipped update's alignment ratio against the reference
    direction collapses, so the θ-filter (§IV-C) rejects it at the
    source — the property the differential harness asserts."""
    n_byz: int = 1
    scale: float = 2.0
    sign_flip: bool = True

    def issues(self, prefix="scenario.byzantine") -> List[Tuple[str, object, str]]:
        out = []
        if self.n_byz < 0:
            out.append((f"{prefix}.n_byz", self.n_byz,
                        "n_byz must be >= 0"))
        if self.scale <= 0:
            out.append((f"{prefix}.scale", self.scale,
                        "scale must be > 0 (sign_flip controls direction)"))
        return out


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Composition of per-round world transitions; all-None == static."""
    drift: Optional[DriftSpec] = None
    churn: Optional[ChurnSpec] = None
    links: Optional[LinkSpec] = None
    dropout: Optional[DropoutSchedule] = None
    byzantine: Optional[ByzantineSpec] = None

    def active(self) -> bool:
        return any((self.drift, self.churn, self.links, self.dropout,
                    self.byzantine))

    def issues(self) -> List[Tuple[str, object, str]]:
        out: List[Tuple[str, object, str]] = []
        for comp in (self.drift, self.churn, self.links, self.dropout,
                     self.byzantine):
            if comp is not None:
                out.extend(comp.issues())
        return out

    def validate(self) -> "ScenarioSpec":
        issues = self.issues()
        if issues:
            raise ValueError(
                "invalid ScenarioSpec: "
                + "; ".join(f"{f}={v!r}: {h}" for f, v, h in issues))
        return self


# ---------------------------------------------------------------------------
# presets (the differential-harness matrix columns)
# ---------------------------------------------------------------------------

SCENARIO_PRESETS = {
    "static": ScenarioSpec(),
    "drift": ScenarioSpec(drift=DriftSpec(rate=0.08, max_amp=1.2)),
    "churn": ScenarioSpec(churn=ChurnSpec(period=2, leave_frac=0.25)),
    "flaky-links": ScenarioSpec(
        links=LinkSpec(bw_sigma=0.35, lat_sigma=0.35),
        dropout=DropoutSchedule(boundaries=(4,), scales=(1.0, 2.5))),
    "byzantine": ScenarioSpec(
        byzantine=ByzantineSpec(n_byz=1, scale=2.0, sign_flip=True)),
    "churn+flaky-links": ScenarioSpec(
        churn=ChurnSpec(period=2, leave_frac=0.25),
        links=LinkSpec(bw_sigma=0.35, lat_sigma=0.35),
        dropout=DropoutSchedule(boundaries=(4,), scales=(1.0, 2.5))),
    "dynamic": ScenarioSpec(
        drift=DriftSpec(rate=0.05, max_amp=1.0),
        churn=ChurnSpec(period=3, leave_frac=0.25),
        links=LinkSpec(bw_sigma=0.25, lat_sigma=0.25),
        dropout=DropoutSchedule(boundaries=(8,), scales=(1.0, 2.0))),
}


def resolve_scenario(scenario) -> Optional[ScenarioSpec]:
    """None | preset name | ScenarioSpec -> validated ScenarioSpec or
    None (inactive scenarios normalize to None)."""
    if scenario is None:
        return None
    if isinstance(scenario, str):
        if scenario not in SCENARIO_PRESETS:
            raise ValueError(
                f"unknown scenario preset {scenario!r}; expected one of "
                f"{sorted(SCENARIO_PRESETS)} or a ScenarioSpec")
        scenario = SCENARIO_PRESETS[scenario]
    if not isinstance(scenario, ScenarioSpec):
        raise ValueError(f"cannot resolve scenario from {type(scenario)}; "
                         "expected None, a preset name or a ScenarioSpec")
    return scenario if scenario.active() else None


def is_active(scenario) -> bool:
    return scenario is not None and scenario.active()


# ---------------------------------------------------------------------------
# WorldState and its transition
# ---------------------------------------------------------------------------

class WorldState(NamedTuple):
    """One round's world: ``(N,)`` per-client fields and two 0-dim f32
    scalars."""
    live: torch.Tensor           # (N,) bool — churn membership
    bw_scale: torch.Tensor       # (N,) f32 — bandwidth multiplier walk
    lat_scale: torch.Tensor      # (N,) f32 — latency multiplier walk
    drift_amp: torch.Tensor      # 0-dim f32 — drift amplitude
    dropout_scale: torch.Tensor  # 0-dim f32 — failure-regime multiplier
    byz_factor: torch.Tensor     # (N,) f32 — update multiplier (1 honest)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _byz_factor(scn: ScenarioSpec, n: int) -> torch.Tensor:
    if scn.byzantine is None or scn.byzantine.n_byz == 0:
        return torch.ones((n,), dtype=torch.float32)
    b = scn.byzantine
    f = _f32((-b.scale) if b.sign_flip else b.scale)
    return torch.where(torch.arange(n) < b.n_byz, f, _f32(1.0))


def init_world(scn: ScenarioSpec, num_clients: int) -> WorldState:
    """The world before round 0 of an active scenario: everyone live,
    neutral scales, amp 0."""
    n = int(num_clients)
    ones = torch.ones((n,), dtype=torch.float32)
    scale0 = scn.dropout.scales[0] if scn.dropout is not None else 1.0
    return WorldState(live=torch.ones((n,), dtype=torch.bool),
                      bw_scale=ones, lat_scale=ones.clone(),
                      drift_amp=_f32(0.0), dropout_scale=_f32(scale0),
                      byz_factor=_byz_factor(scn, n))


def world_step(ws: WorldState, round_idx: int, scn: ScenarioSpec,
               num_clients: int, normals=None) -> WorldState:
    """The world round ``round_idx`` (absolute) runs under, from the one
    before it, in the JAX package's f32 operations. ``normals`` are the
    link walks' standard normals of this round, ``(bw (N,), lat (N,))``
    f32 (needed when the scenario has links)."""
    n = int(num_clients)
    r = int(round_idx)

    live = ws.live
    if scn.churn is not None:
        c = scn.churn
        leave = min(int(round(c.leave_frac * n)), n - 1)
        if leave > 0:
            offset = ((r // c.period) * leave + c.seed) % n
            live = ((torch.arange(n) - offset) % n) >= leave

    bw, lat = ws.bw_scale, ws.lat_scale
    if scn.links is not None:
        lk = scn.links
        if normals is None:
            raise ValueError("a scenario with links needs the round's link "
                             "normals (core/draws.py, LinkNormals)")
        z_bw, z_lat = (torch.from_numpy(np.array(z, np.float32))
                       for z in normals)
        lo, hi = _f32(1.0 / lk.clip), _f32(lk.clip)
        bw = torch.clamp(bw * torch.exp(_f32(lk.bw_sigma) * z_bw), lo, hi)
        lat = torch.clamp(lat * torch.exp(_f32(lk.lat_sigma) * z_lat),
                          lo, hi)

    amp = ws.drift_amp
    if scn.drift is not None:
        d = scn.drift
        r32 = _f32(r)
        if d.mode == "sine":
            # the JAX package's 2.0 * jnp.pi is one Python float, rounded
            # to f32 when it meets the f32 round index
            angle = _f32(2.0 * math.pi) * r32 / _f32(d.period)
            amp = (_f32(d.max_amp) * _f32(0.5)) * (_f32(1.0)
                                                    - torch.cos(angle))
        else:
            amp = torch.minimum(_f32(d.rate) * r32, _f32(d.max_amp))

    scale = ws.dropout_scale
    if scn.dropout is not None and scn.dropout.boundaries:
        dp = scn.dropout
        regime = sum(r >= b for b in dp.boundaries)
        scale = _f32(dp.scales)[regime]

    return WorldState(live=live, bw_scale=bw, lat_scale=lat, drift_amp=amp,
                      dropout_scale=scale, byz_factor=ws.byz_factor)


# ---------------------------------------------------------------------------
# drift (every path)
# ---------------------------------------------------------------------------

def drift_directions(drift: DriftSpec, num_classes: int,
                     num_features: int) -> np.ndarray:
    """Fixed (num_classes, num_features) f32 per-class drift directions,
    unit-ish scale (||dir_c|| ≈ 1), drawn once from ``drift.seed``."""
    rng = np.random.default_rng(drift.seed)
    dirs = rng.normal(size=(num_classes, num_features))
    dirs /= np.sqrt(num_features)
    return dirs.astype(np.float32)


def apply_drift(batch: dict, amp, dirs: torch.Tensor,
                label_key: str = "y") -> dict:
    """x ← x + amp·dir[y], elementwise over any leading batch dims: the
    same bits whether the batch is (B, F), (steps, B, F) or a stacked
    cohort (C, steps, B, F). ``amp`` is a 0-dim f32 tensor (or a number,
    taken as f32); ``dirs`` a tensor on the batch's device."""
    if "x" not in batch or label_key not in batch:
        raise ValueError("drift needs feature/label batches "
                         f"('x' + {label_key!r}); token datasets do not "
                         "support label-conditional feature drift")
    x = batch["x"]
    amp = torch.as_tensor(amp, dtype=torch.float32, device=x.device)
    return {**batch, "x": x + amp * dirs[batch[label_key]]}


# ---------------------------------------------------------------------------
# where every path takes its world from
# ---------------------------------------------------------------------------

class WorldSource:
    """The world trajectory of one run, round by round: ``view(r)`` is
    round r's world on the host (``host_view``'s dict); ``prepare(round0,
    rounds)`` copies the worlds of those rounds (a scanned dispatch's, or
    one spmd round's) to the device in one copy, pinned and without
    blocking when the device is a card, and ``world(r)`` is then round r's
    ``WorldState`` there.

    The trajectory is computed on the host by ``world_step`` from the
    normals of ``normals`` (a ``LinkNormals`` of the scenario's link seed
    unless given), extended as rounds are asked for; ``views`` (host
    views, e.g. the JAX package's ``replay``) replaces it.
    """

    def __init__(self, scn: ScenarioSpec, num_clients: int, device,
                 normals: Optional[Callable] = None,
                 views: Optional[Sequence[dict]] = None):
        self.scn, self.n = scn, int(num_clients)
        self.device = torch.device(device)
        if normals is None and scn.links is not None:
            normals = LinkNormals(scn.links.seed, self.n)
        self._normals = normals
        self._fixed = views is not None
        self._views: List[dict] = list(views or [])
        self._ws = init_world(scn, self.n)
        self._round0, self._buf = 0, None

    def view(self, r: int) -> dict:
        while len(self._views) <= r:
            if self._fixed:
                raise IndexError(f"the given world trajectory has "
                                 f"{len(self._views)} rounds, not {r + 1}")
            j = len(self._views)
            self._ws = world_step(
                self._ws, j, self.scn, self.n,
                self._normals(j) if self.scn.links is not None else None)
            self._views.append(host_view(self._ws))
        return self._views[r]

    def prepare(self, round0: int, rounds: int) -> None:
        # one f32 row a round: live | bw | lat | byz | amp, scale
        rows = np.empty((rounds, 4 * self.n + 2), np.float32)
        for j in range(rounds):
            v, n = self.view(round0 + j), self.n
            rows[j, :n] = v["live"]
            rows[j, n:2 * n] = v["bw_scale"]
            rows[j, 2 * n:3 * n] = v["lat_scale"]
            rows[j, 3 * n:4 * n] = v["byz_factor"]
            rows[j, 4 * n:] = (v["drift_amp"], v["dropout_scale"])
        self._buf = _to_device(torch.from_numpy(rows), self.device)
        self._round0 = int(round0)

    def reset(self) -> None:
        """Drop the prepared rounds' device buffer (a restored run
        prepares its own); the host trajectory stays."""
        self._buf = None

    def world(self, r: int) -> WorldState:
        row, n = self._buf[int(r) - self._round0], self.n
        return WorldState(live=row[:n] > 0, bw_scale=row[n:2 * n],
                          lat_scale=row[2 * n:3 * n],
                          byz_factor=row[3 * n:4 * n],
                          drift_amp=row[4 * n], dropout_scale=row[4 * n + 1])


# ---------------------------------------------------------------------------
# drift detection (serving side): per-feature and score moments
# ---------------------------------------------------------------------------

class DriftStats(NamedTuple):
    """Feature moments and anomaly-score moments of a sample or a stream.
    ``count`` is the number of samples absorbed; a fresh state (count 0)
    snaps to the first batch it sees, later ones move an EMA."""
    feat_mean: torch.Tensor   # (F,) f32
    feat_var: torch.Tensor    # (F,) f32
    score_mean: torch.Tensor  # 0-dim f32
    score_var: torch.Tensor   # 0-dim f32
    count: torch.Tensor       # 0-dim f32 — samples absorbed


def init_drift_stats(num_features: int, device="cpu") -> DriftStats:
    z = torch.zeros((num_features,), dtype=torch.float32, device=device)
    s = torch.zeros((), dtype=torch.float32, device=device)
    return DriftStats(feat_mean=z, feat_var=torch.ones_like(z), score_mean=s,
                      score_var=torch.ones_like(s), count=s.clone())


def reference_snapshot(x, scores) -> DriftStats:
    """Exact moments of a reference sample: ``x`` (N, F) features and
    ``scores`` (N,) anomaly scores of the same samples."""
    x = torch.as_tensor(x, dtype=torch.float32)
    s = torch.as_tensor(scores, dtype=torch.float32, device=x.device)
    return DriftStats(
        feat_mean=x.mean(0), feat_var=x.var(0, correction=0),
        score_mean=s.mean(), score_var=s.var(correction=0),
        count=torch.tensor(float(x.shape[0]), device=x.device))


def drift_stats_update(stats: DriftStats, x, scores, mask=None,
                       decay: float = 0.98) -> DriftStats:
    """One window's masked EMA update. ``mask`` flags the real rows of a
    padded batch (None: all real). A batch of ``m`` real samples moves the
    EMA by ``1 - decay**m`` toward its moments, so the trajectory does not
    depend on how a stream is chunked; an all-padding batch changes
    nothing and the first real batch sets the state."""
    x = torch.as_tensor(x, dtype=torch.float32)
    s = torch.as_tensor(scores, dtype=torch.float32, device=x.device)
    if mask is None:
        mask = torch.ones(x.shape[:1], dtype=torch.float32, device=x.device)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
    m = mask.sum()
    denom = torch.clamp_min(m, 1.0)
    bm = (x * mask[:, None]).sum(0) / denom
    bv = (((x - bm) ** 2) * mask[:, None]).sum(0) / denom
    sm = (s * mask).sum() / denom
    sv = (((s - sm) ** 2) * mask).sum() / denom
    w = 1.0 - torch.pow(torch.tensor(decay, dtype=torch.float32,
                                     device=x.device), m)
    w = torch.where(m > 0, torch.where(stats.count > 0, w, 1.0), 0.0)
    return DriftStats(
        feat_mean=stats.feat_mean + w * (bm - stats.feat_mean),
        feat_var=stats.feat_var + w * (bv - stats.feat_var),
        score_mean=stats.score_mean + w * (sm - stats.score_mean),
        score_var=stats.score_var + w * (sv - stats.score_var),
        count=stats.count + m)


def drift_statistic(stats: DriftStats, ref: DriftStats,
                    eps: float = 1e-6) -> torch.Tensor:
    """Normalized shift of ``stats`` from ``ref``: the larger of
    mean_f |mu_f - mu_ref,f| / sqrt(var_ref,f + eps) and
    |s - s_ref| / sqrt(svar_ref + eps). 0 when the moments match."""
    feat = torch.mean(torch.abs(stats.feat_mean - ref.feat_mean)
                      / torch.sqrt(ref.feat_var + eps))
    score = (torch.abs(stats.score_mean - ref.score_mean)
             / torch.sqrt(ref.score_var + eps))
    return torch.maximum(feat, score)


# ---------------------------------------------------------------------------
# host views
# ---------------------------------------------------------------------------

def host_view(ws: WorldState) -> dict:
    """The whole state as numpy, in one copy per field."""
    return {"live": ws.live.cpu().numpy(),
            "bw_scale": ws.bw_scale.cpu().numpy(),
            "lat_scale": ws.lat_scale.cpu().numpy(),
            "drift_amp": float(ws.drift_amp),
            "dropout_scale": float(ws.dropout_scale),
            "byz_factor": ws.byz_factor.cpu().numpy()}


def view_differences(got: dict, want: dict) -> List[str]:
    """The fields in which two host views differ, by dtype or bits."""
    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want
                  or np.asarray(got[k]).dtype != np.asarray(want[k]).dtype
                  or np.asarray(got[k]).tobytes()
                  != np.asarray(want[k]).tobytes())


def replay(scn: Optional[ScenarioSpec], num_clients: int, rounds: int,
           normals: Optional[Callable] = None) -> List[Optional[dict]]:
    """The first ``rounds`` world states as host views (None each when the
    scenario is inactive), from ``normals`` (a ``LinkNormals`` of the link
    seed unless given)."""
    if not is_active(scn):
        return [None] * rounds
    src = WorldSource(scn, num_clients, "cpu", normals=normals)
    return [src.view(r) for r in range(rounds)]
