"""Online drift monitor: the scenario engine's drift machinery as a
DETECTOR over live serving traffic.

``core/scenario.py`` holds the shared statistics (``DriftStats`` /
``reference_snapshot`` / ``drift_stats_update`` / ``drift_statistic``);
this module wraps them in the serving-side policy: a streaming EMA of
per-feature moments and score-distribution moments is compared against a
training-time reference snapshot every micro-batch, and when the
normalized shift exceeds ``threshold`` for ``patience`` CONSECUTIVE
windows the monitor raises a re-federation trigger (``triggered``).

The state and the reference live on the scoring device (the card unless
named). The update is tensor operations on the scoring batch
(:meth:`step`), so ``serve.engine`` runs it on the padded batch right
after the scorer, masked for the padded rows. Only the trigger logic
(threshold + consecutive-window counting) runs host-side, on the scalar
statistic each batch returns (:meth:`observe`: one ``float()``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import scenario as scenario_mod
from repro_torch.core.scenario import DriftStats
from repro_torch.device import resolve_device


class DriftMonitor:
    """Streaming shift detector against a reference snapshot.

    Parameters
    ----------
    reference     : training-time :class:`DriftStats`
                    (``scenario.reference_snapshot``), moved to ``device``
    threshold     : normalized-shift trigger level (1.0 ~= feature means
                    one reference std away on average; see
                    ``scenario.drift_statistic``)
    patience      : consecutive over-threshold windows required — a
                    single anomalous burst does not re-federate
    decay         : per-sample EMA decay of the streaming stats
    device        : where the state and the reference live: the scoring
                    device (the card unless named)
    """

    def __init__(self, reference: DriftStats, *, threshold: float = 0.5,
                 patience: int = 3, decay: float = 0.98, device=None):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.device = resolve_device(device)
        self.reference = DriftStats(*(t.to(self.device) for t in reference))
        self.threshold = float(threshold)
        self.patience = int(patience)
        self.decay = float(decay)
        self.state = scenario_mod.init_drift_stats(
            int(reference.feat_mean.shape[0]), device=self.device)
        self.history: List[float] = []       # one statistic per window
        self.triggered = False
        self.trigger_count = 0               # lifetime triggers raised
        self._over = 0                       # consecutive windows over

    # ------------------------------------------------------------------
    # device path: tensor operations on the scoring batch
    # ------------------------------------------------------------------
    def step(self, state: DriftStats, reference: DriftStats, x, scores,
             mask=None):
        """(state, reference, x, scores, mask) -> (new_state, statistic),
        a 0-dim tensor. Pure: the monitor's own state is adopted only by
        :meth:`observe`. ``reference`` is an argument, so a post-swap
        :meth:`rearm` takes effect in the next batch."""
        new = scenario_mod.drift_stats_update(state, x, scores, mask=mask,
                                              decay=self.decay)
        return new, scenario_mod.drift_statistic(new, reference)

    # ------------------------------------------------------------------
    # host path: trigger policy on the per-window scalar
    # ------------------------------------------------------------------
    def observe(self, state: DriftStats, statistic) -> bool:
        """Adopt the post-batch state + statistic (host side). Returns
        True the moment the trigger FIRES (edge, not level — it stays
        ``triggered`` until :meth:`rearm`, but observe only returns True
        once per arming so the federator fires once)."""
        self.state = state
        stat = float(statistic)
        self.history.append(stat)
        self._over = self._over + 1 if stat > self.threshold else 0
        if self._over >= self.patience and not self.triggered:
            self.triggered = True
            self.trigger_count += 1
            return True
        return False

    @property
    def statistic(self) -> float:
        return self.history[-1] if self.history else 0.0

    def rearm(self, reference: Optional[DriftStats] = None,
              adopt_current: bool = False) -> None:
        """Clear the trigger after a re-federation hot-swap.

        ``reference=...`` installs a fresh snapshot (e.g. recomputed on
        the re-trained model); ``adopt_current=True`` promotes the
        monitor's OWN streaming state to be the new reference — the
        shifted serving distribution the model was just re-trained on
        becomes the new normal. The streaming EMA restarts either way so
        post-swap windows are judged on their own."""
        if adopt_current:
            if reference is not None:
                raise ValueError("pass reference= or adopt_current=True, "
                                 "not both")
            if float(self.state.count) <= 0:
                raise ValueError("adopt_current=True needs at least one "
                                 "observed window")
            self.reference = self.state
        elif reference is not None:
            self.reference = DriftStats(*(t.to(self.device)
                                          for t in reference))
        self.state = scenario_mod.init_drift_stats(
            int(self.reference.feat_mean.shape[0]), device=self.device)
        self.triggered = False
        self._over = 0

    # ------------------------------------------------------------------
    @classmethod
    def from_sample(cls, x, scores, device=None, **kw) -> "DriftMonitor":
        """Monitor whose reference is the exact moments of ``(x,
        scores)`` (numpy arrays or tensors), computed on ``device`` — the
        usual construction right after training, with ``scores``
        produced by the model about to be served."""
        dev = resolve_device(device)
        return cls(scenario_mod.reference_snapshot(
            torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(scores, dtype=torch.float32, device=dev)),
            device=dev, **kw)
