"""``run_sweep`` — declarative cross-products over experiment axes.

The paper's tables are sweeps: seeds × strategies (Table II/VII),
thresholds (Table IV), schedules (Fig. 2). Instead of hand-rolled host
loops, declare the axes and let the driver execute the cross-product::

    sweep = run_sweep(base_spec,
                      axes={"strategy": ["ours", "fedavg"],
                            "seed": range(5)})
    cmp = sweep.compare("strategy", "ours", "fedavg",
                        metric="accuracy", alternative="greater")
    print(sweep.report("accuracy"), cmp.p_value)

Axis names are ExperimentSpec fields, dotted sub-spec fields
(``data.alpha``, ``world.num_clients``, ``strategy_kwargs.batch_size``)
or ``schedule`` / ``seed`` / ``strategy``. Values go through
``dataclasses.replace`` so every point is a full, validated spec.

Seed groups: points that differ only by seed and describe a
seed-vectorizable spmd spec (``runner.seed_vectorizable``) run as one
seed-stacked state (``runner.run_spmd_seed_batch``: one state, every
metric read back once at the end; the seeds step one after another inside
each round). Everything else runs one point after another through the
session-backed ``run_experiment``. Every run goes to ``device`` (the card
unless named).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np

from repro_torch.api import runner as runner_mod
from repro_torch.api import stats
from repro_torch.api.result import ExperimentResult
from repro_torch.api.spec import ExperimentSpec


def _apply_axis(spec: ExperimentSpec, name: str,
                value: Any) -> ExperimentSpec:
    if "." in name:
        parent, leaf = name.split(".", 1)
        sub = getattr(spec, parent)
        if isinstance(sub, dict):
            sub = {**sub, leaf: value}
        else:
            sub = dataclasses.replace(sub, **{leaf: value})
        return dataclasses.replace(spec, **{parent: sub})
    return dataclasses.replace(spec, **{name: value})


def build_point_spec(spec: ExperimentSpec,
                     overrides: Dict[str, Any]) -> ExperimentSpec:
    for name, value in overrides.items():
        spec = _apply_axis(spec, name, value)
    return spec


@dataclasses.dataclass
class SweepPoint:
    overrides: Dict[str, Any]          # this point's axis assignment
    spec: ExperimentSpec
    result: Optional[ExperimentResult] = None
    vectorized: bool = False           # ran inside a seed batch

    def value(self, metric) -> float:
        return _metric_value(self.result, metric)


def _metric_value(result: ExperimentResult,
                  metric: Union[str, Callable]) -> float:
    """Resolve a metric spec against a result: a RoundRecord field name
    (read off the FINAL record), "auc" (AUC-ROC on the eval split), or
    a callable ``f(result) -> float``."""
    if callable(metric):
        return float(metric(result))
    if metric == "auc":
        return float(result.auc_roc())
    return float(getattr(result.final, metric))


@dataclasses.dataclass
class SweepResult:
    base_spec: ExperimentSpec
    axes: Dict[str, List[Any]]
    points: List[SweepPoint]
    wall_time: float = 0.0
    vectorized_groups: int = 0         # seed groups run as one batch

    # ------------------------------------------------------------------
    def filter(self, **where) -> List[SweepPoint]:
        """Points whose overrides match every ``axis=value`` given."""
        out = []
        for p in self.points:
            if all(p.overrides.get(k) == v for k, v in where.items()):
                out.append(p)
        return out

    def values(self, metric="accuracy", **where) -> np.ndarray:
        """Metric samples over the matching points (seed order)."""
        return np.array([p.value(metric) for p in self.filter(**where)])

    # ------------------------------------------------------------------
    # the paper's statistics
    # ------------------------------------------------------------------
    def mann_whitney_u(self, axis: str, a: Any, b: Any,
                       metric="accuracy", alternative: str = "greater",
                       **where) -> stats.MannWhitneyResult:
        """U test of ``axis=a`` vs ``axis=b`` samples (per remaining
        axes' cross-product, usually seeds). ``alternative='greater'``
        is the paper's H1: a stochastically larger than b."""
        va = self.values(metric, **{axis: a}, **where)
        vb = self.values(metric, **{axis: b}, **where)
        return stats.mann_whitney_u(va, vb, alternative=alternative)

    # alias mirroring the SweepResult.compare spelling in docs
    compare = mann_whitney_u

    def _grouped_points(self) -> List[tuple]:
        """(label, non-seed overrides dict, points) per group, in first-
        seen order. The overrides dict carries the REAL axis values —
        labels are display-only, never parsed back."""
        out: List[tuple] = []
        index: Dict[str, int] = {}
        for p in self.points:
            over = {k: v for k, v in p.overrides.items() if k != "seed"}
            label = ", ".join(f"{k}={v}"
                              for k, v in sorted(over.items(),
                                                 key=lambda kv: kv[0])
                              ) or "<base>"
            if label not in index:
                index[label] = len(out)
                out.append((label, over, []))
            out[index[label]][2].append(p)
        return out

    def groups(self, metric="accuracy") -> Dict[str, np.ndarray]:
        """Samples keyed by the non-seed override assignment (display
        labels; use ``filter``/``values`` for programmatic access)."""
        return {label: np.array([p.value(metric) for p in pts])
                for label, _over, pts in self._grouped_points()}

    def summary(self, metric="accuracy") -> List[List]:
        """[group, n, median, q1, q3] rows over the non-seed groups."""
        return stats.summarize(self.groups(metric))

    def report(self, metric="accuracy", baseline: Any = None,
               axis: str = "strategy") -> str:
        """Table II/VII-style comparison report: per-group median [IQR],
        plus Mann-Whitney p vs ``baseline`` along ``axis`` when given."""
        lines = [f"# sweep over {', '.join(self.axes)} — metric={metric}"
                 f" ({len(self.points)} runs, "
                 f"{self.vectorized_groups} batched seed group(s))"]
        header = f"{'group':40s} {'n':>3s} {'median':>10s} {'IQR':>21s}"
        pcol = baseline is not None and axis in self.axes
        if pcol:
            header += f" {'p_vs_' + str(baseline):>12s}"
        lines.append(header)
        for label, over, pts in self._grouped_points():
            med, q1, q3 = stats.median_iqr([p.value(metric) for p in pts])
            line = f"{label:40s} {len(pts):>3d} {med:>10.4f} " \
                   f"[{q1:>9.4f},{q3:>9.4f}]"
            if pcol:
                val = over.get(axis)
                if val is None or val == baseline:
                    line += f" {'-':>12s}"
                else:
                    other = {k: v for k, v in over.items() if k != axis}
                    r = self.mann_whitney_u(axis, val, baseline,
                                            metric=metric, **other)
                    line += f" {r.p_value:>12.4g}"
            lines.append(line)
        return "\n".join(lines)


def run_sweep(spec: ExperimentSpec, axes: Dict[str, Iterable[Any]],
              vectorize: Union[bool, str] = "auto",
              progress: Optional[Callable[[SweepPoint], Any]] = None, *,
              device=None) -> SweepResult:
    """Execute the cross-product of ``axes`` over ``spec`` on ``device``.

    vectorize: "auto" (default) runs every group of points differing
    only by seed as one seed-stacked spmd state when the spec allows it;
    False forces serial execution; True raises if a group that should
    vectorize cannot.
    ``progress(point)`` is called as each point finishes.
    """
    axes = {k: list(v) for k, v in axes.items()}
    if not axes:
        raise ValueError("axes must name at least one sweep dimension")
    names = list(axes)
    points = [SweepPoint(overrides=dict(zip(names, combo)),
                         spec=build_point_spec(spec,
                                               dict(zip(names, combo))))
              for combo in itertools.product(*axes.values())]
    for p in points:
        p.spec.validate()             # surface ALL bad points up front

    t0 = time.time()
    vectorized_groups = 0
    # group points by their non-seed assignment; each group's seeds can
    # share one seed-stacked state
    groups: Dict[str, List[SweepPoint]] = {}
    for p in points:
        key = repr(sorted((k, repr(v)) for k, v in p.overrides.items()
                          if k != "seed"))
        groups.setdefault(key, []).append(p)

    for group in groups.values():
        seeds = [p.spec.seed for p in group]
        can_batch = (len(group) > 1
                    and len(set(seeds)) == len(seeds)
                    and "seed" in axes
                    and runner_mod.seed_vectorizable(group[0].spec))
        if vectorize is True and not can_batch and len(group) > 1:
            raise ValueError(
                "vectorize=True but a sweep group cannot run as a seed "
                "batch "
                f"(overrides {group[0].overrides}); use vectorize='auto'")
        if can_batch and vectorize in (True, "auto"):
            results = runner_mod.run_spmd_seed_batch(group[0].spec, seeds,
                                                     device=device)
            vectorized_groups += 1
            for p, r in zip(group, results):
                p.result, p.vectorized = r, True
                if progress is not None:
                    progress(p)
        else:
            for p in group:
                p.result = runner_mod.run_experiment(p.spec, device=device)
                if progress is not None:
                    progress(p)

    return SweepResult(base_spec=spec, axes=axes, points=points,
                       wall_time=time.time() - t0,
                       vectorized_groups=vectorized_groups)
