"""How closely two runs of the same experiment must agree.

Two runs of one spec from the same initial parameters — the port on the
card against the port on the CPU, or the port against the JAX package —
draw selection, dropout and batches from the same numpy Generators. So:

  * ``EXACT_FIELDS`` (simulated times, bytes, update counts, accept
    rates) are equal, as long as every θ decision is the same;
  * accuracy agrees within ``ACC_TOL`` and loss within ``LOSS_RTOL``
    (relative): the parameters agree to f32 rounding after one local
    step, and those differences compound over the 64 local steps of
    every round (observed on the CPU against the JAX package after 8
    rounds of the quickstart spec: loss 2e-4 relative, accuracy equal);
  * a θ decision is reproducible only if its ratio lies farther than
    ``THETA_BAND`` from θ: float noise moves a few of the 54,602 sign
    counts, about 1e-4 of the ratio.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

ACC_TOL = 2.5e-3          # 10 of the quickstart's 4,000 eval samples
LOSS_RTOL = 1e-3
THETA_BAND = 1e-3
EXACT_FIELDS = ("round", "sim_time", "comm_time", "idle_time", "bytes_sent",
                "updates_applied", "accept_rate")


def record_mismatches(got: Sequence, want: Sequence) -> List[str]:
    """Every way the records ``got`` fall outside the tolerances of
    ``want``; empty when they agree."""
    if len(got) != len(want):
        return [f"{len(got)} records against {len(want)}"]
    out = []
    for g, w in zip(got, want):
        for f in EXACT_FIELDS:
            if getattr(g, f) != getattr(w, f):
                out.append(f"round {w.round}: {f} {getattr(g, f)!r} != "
                           f"{getattr(w, f)!r}")
        if not abs(g.accuracy - w.accuracy) <= ACC_TOL:
            out.append(f"round {w.round}: accuracy {g.accuracy} vs "
                       f"{w.accuracy} (tolerance {ACC_TOL})")
        if not abs(g.loss - w.loss) <= LOSS_RTOL * abs(w.loss):
            out.append(f"round {w.round}: loss {g.loss} vs {w.loss} "
                       f"(relative tolerance {LOSS_RTOL})")
    return out


def theta_band_violations(theta_ratios: Iterable[tuple],
                          theta: float) -> List[str]:
    """The (round, client, ratio) θ tests that lie within THETA_BAND of θ,
    where the accept decision is not reproducible."""
    return [f"round {rnd}, client {cid}: ratio {ratio} within {THETA_BAND} "
            f"of θ={theta}" for rnd, cid, ratio in theta_ratios
            if abs(ratio - theta) <= THETA_BAND]
