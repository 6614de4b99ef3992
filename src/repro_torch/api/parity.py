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

With int8 wire compression one more thing can part: an element whose
x/scale lies within float noise of a .5 tie takes the neighbouring code in
the other run. Its dequantized value moves by one code step (the row's
amax/127), and so does its error-feedback residual. After ONE round from
the same state, two error-feedback states agree to ``EF_RTOL`` of each
row's largest residual (float noise) except at such flipped elements,
which are at most ``EF_FLIP_FRAC`` of all (``ef_mismatches``). Over more
rounds the flips feed back, through the global model into every later
delta, and the states part element by element: a run from weights one
ulp apart does the same (``chip_smoke.py`` prints both, round by round).
So the error feedback is compared after round 0, and the whole run by
its records: a flipped sign moves a θ ratio by 1/54,602, well inside
``THETA_BAND``, and the record tolerances stay as they are.

The megastep and the per-client loop of ONE package compute the same
round with other reduction orders. ``path_mismatches`` holds them to the
JAX package's own tolerances for that pair (tests/test_megastep.py):
equal update counts, accept rates and bytes, times to ``PATH_TIME_RTOL``
(idle time with an absolute floor of 1e-12 s),
accuracy within ``PATH_ACC_TOL`` and loss within ``PATH_LOSS_RTOL``.

The scanned path (``rounds_per_dispatch``) keeps the control plane and
the accounting on the device, in f32, and is held to other rules
(``scanned_mismatches``, ``control_mismatches``). Runs compared there draw
the same uniforms (the port fed the JAX package's own draws, or the card
and the CPU fed the port's), so the round labels, update counts, accept
rates, selections and the integer ``ControlState`` fields (batch,
staleness, has_ckpt) are equal. What is not:

  * the f32 accumulators (sim, comm and idle time, bytes) add the
    cohort's K terms in another order (XLA's fused reduction, torch's
    CPU and CUDA sums), and XLA contracts products into FMAs; every add
    rounds, so the last bits differ from round 0 (against the JAX
    package on the CPU the comm time does; ``chip_smoke.py`` prints the
    card's gaps against the CPU).
    Each round adds at most K + 1 roundings of 2^-24 relative, so 16
    rounds of 10 clients stay within ``SCAN_RTOL`` = 1e-5. Idle time is
    a sum of (barrier − arrival) terms whose error scales with the
    clock, so its tolerance is relative to the round's sim time. Bytes
    are sums of integers and 1/8-byte beacons: exact while the total
    stays below 2^21 (beacons) or 2^24 (payloads), rounded beyond (the
    quickstart's ``fedavg`` reaches 15.5 M in 8 rounds, so a longer run
    passes 2^24); they take the same ``SCAN_RTOL``;
  * the EMAs (availability, pass rate, round time) and the LR scales are
    the same f32 arithmetic up to FMA contraction: a few ulps, which the
    EMA's factor 0.8 keeps from growing, within ``EMA_RTOL`` = 1e-6; the update-norm EMA is driven by update norms of
    several SGD steps, which agree to 1e-4 (tests/test_torch_megastep.py),
    so ``NORM_RTOL`` = 1e-4;
  * accuracy and loss as above (``ACC_TOL``, ``LOSS_RTOL``); NaN (no
    evaluation yet) must be NaN in both;
  * the error-feedback arena is chaotic over rounds as above: it is
    compared after one round from the same state (``ef_mismatches``).

The spmd engine (``engine="spmd"``, core/fl_step.py) takes ONE gradient
step a round at the shared weights, and its accounting is host f64
arithmetic on the round's masks. Runs compared there start from the same
``FLState`` and draw the same uniforms (the JAX package's draws fed to the
port, or the port's on card and CPU), so:

  * masks, selections, deliveries and reference signs are equal, and
    with them the records' ``EXACT_FIELDS``: times from the masks, bytes
    as whole payloads and 1/8-byte beacons summed in f32 (exact at these
    sizes), accept rates as ratios of small integers;
  * the parameters agree to ``SPMD_PARAM_RTOL`` of each leaf's largest
    |value| per step taken: the per-client gradients differ in their last
    bits (another reduction order in the backward's matrix products), and
    the f32 aggregation adds the C terms in another order; a few ulps a
    step, well inside 1e-6;
  * the JAX package aggregates in bf16 by default (``agg_dtype``), and
    where an update's f32 last bits straddle a bf16 rounding boundary the
    two packages round it to neighbouring bf16 values: one bf16 ulp,
    ``SPMD_BF16_MOVE_RTOL`` = 2^-8 of the largest movement of the leaf,
    per step. The CUDA kernel reduces in f32 whatever ``agg_dtype`` says
    (as the Pallas kernels do), so the card is compared with an f32
    aggregation on the CPU; against the bf16 CPU run it moves by up to
    that much per step, and ``chip_smoke.py`` prints the gap;
  * loss and accuracy as above (``LOSS_RTOL``, ``ACC_TOL``); the control
    state within ``control_mismatches``; θ decisions reproducible only
    outside ``THETA_BAND``, as everywhere.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

ACC_TOL = 2.5e-3          # 10 of the quickstart's 4,000 eval samples
LOSS_RTOL = 1e-3
THETA_BAND = 1e-3
EXACT_FIELDS = ("round", "sim_time", "comm_time", "idle_time", "bytes_sent",
                "updates_applied", "accept_rate")
EF_RTOL = 0.05            # of the row's largest |residual|
EF_FLIP_FRAC = 1e-4       # of all elements: codes that took a neighbour
PATH_TIME_RTOL = 1e-9
PATH_ACC_TOL = 2e-3
PATH_LOSS_RTOL = 1e-3
SCAN_RTOL = 1e-5
SCAN_EXACT_FIELDS = ("round", "updates_applied", "accept_rate")
EMA_RTOL = 1e-6
NORM_RTOL = 1e-4
CONTROL_EXACT = ("batch", "staleness", "has_ckpt")
SPMD_PARAM_RTOL = 1e-6
SPMD_BF16_MOVE_RTOL = 2.0 ** -8
CONTROL_RTOL = {"avail": EMA_RTOL, "pass_rate": EMA_RTOL,
                "round_time": EMA_RTOL, "lr_scale": EMA_RTOL,
                "grad_norm": NORM_RTOL}


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


def ef_flips(got, want, lane: int = 1024) -> int:
    """Elements of two error-feedback states (arrays of one shape, a
    multiple of ``lane`` long: the arena's row layout) that differ by more
    than EF_RTOL of their row's largest residual in ``want``."""
    got = np.asarray(got, np.float32).reshape(-1, lane)
    want = np.asarray(want, np.float32).reshape(-1, lane)
    row_max = np.abs(want).max(axis=1, keepdims=True)
    return int((np.abs(got - want) > EF_RTOL * row_max).sum())


def ef_mismatches(got, want, lane: int = 1024) -> List[str]:
    """Two error-feedback states after one round from the same state,
    against EF_RTOL and EF_FLIP_FRAC; empty when they agree."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return [f"error feedback of shape {got.shape} against {want.shape}"]
    flips = ef_flips(got, want, lane)
    if flips > EF_FLIP_FRAC * want.size:
        return [f"error feedback: {flips} of {want.size} elements differ by "
                f"more than {EF_RTOL} of their row's largest residual "
                f"(at most {EF_FLIP_FRAC} of them may)"]
    return []


def path_mismatches(got: Sequence, want: Sequence) -> List[str]:
    """Records of one package's two execution paths (loop ``got``,
    megastep ``want``) against the PATH_* tolerances."""
    if len(got) != len(want):
        return [f"{len(got)} records against {len(want)}"]
    out = []
    for g, w in zip(got, want):
        for f in ("round", "updates_applied", "accept_rate", "bytes_sent"):
            if getattr(g, f) != getattr(w, f):
                out.append(f"round {w.round}: {f} {getattr(g, f)!r} != "
                           f"{getattr(w, f)!r}")
        for f, atol in (("sim_time", 0.0), ("comm_time", 0.0),
                        ("idle_time", 1e-12)):
            a, b = getattr(g, f), getattr(w, f)
            if not abs(a - b) <= PATH_TIME_RTOL * abs(b) + atol:
                out.append(f"round {w.round}: {f} {a!r} vs {b!r} (relative "
                           f"tolerance {PATH_TIME_RTOL})")
        if not abs(g.accuracy - w.accuracy) <= PATH_ACC_TOL:
            out.append(f"round {w.round}: accuracy {g.accuracy} vs "
                       f"{w.accuracy} (tolerance {PATH_ACC_TOL})")
        if not abs(g.loss - w.loss) <= PATH_LOSS_RTOL * abs(w.loss):
            out.append(f"round {w.round}: loss {g.loss} vs {w.loss} "
                       f"(relative tolerance {PATH_LOSS_RTOL})")
    return out


def _nan_aware_gap(a: float, b: float) -> float:
    if np.isnan(a) and np.isnan(b):
        return 0.0
    return abs(a - b) if not (np.isnan(a) or np.isnan(b)) else np.inf


def scanned_mismatches(got: Sequence, want: Sequence) -> List[str]:
    """Records of two scanned runs against the SCAN_* tolerances; empty
    when they agree."""
    if len(got) != len(want):
        return [f"{len(got)} records against {len(want)}"]
    out = []
    for g, w in zip(got, want):
        for f in SCAN_EXACT_FIELDS:
            if getattr(g, f) != getattr(w, f):
                out.append(f"round {w.round}: {f} {getattr(g, f)!r} != "
                           f"{getattr(w, f)!r}")
        for f in ("sim_time", "comm_time", "idle_time", "bytes_sent"):
            a, b = getattr(g, f), getattr(w, f)
            scale = abs(b) if f != "idle_time" else max(abs(b), w.sim_time)
            if not abs(a - b) <= SCAN_RTOL * scale:
                out.append(f"round {w.round}: {f} {a!r} vs {b!r} (relative "
                           f"tolerance {SCAN_RTOL})")
        if not _nan_aware_gap(g.accuracy, w.accuracy) <= ACC_TOL:
            out.append(f"round {w.round}: accuracy {g.accuracy} vs "
                       f"{w.accuracy} (tolerance {ACC_TOL})")
        if not _nan_aware_gap(g.loss, w.loss) <= LOSS_RTOL * abs(w.loss):
            out.append(f"round {w.round}: loss {g.loss} vs {w.loss} "
                       f"(relative tolerance {LOSS_RTOL})")
    return out


def control_mismatches(got, want) -> List[str]:
    """Two ``ControlState``s (dicts or objects of numpy-convertible
    fields): integer fields equal, f32 statistics within CONTROL_RTOL; the
    error-feedback arena is left to ``ef_mismatches``."""
    def get(state, f):
        return np.asarray(state[f] if isinstance(state, dict)
                          else getattr(state, f))
    out = []
    for f in CONTROL_EXACT + tuple(CONTROL_RTOL):
        a, b = get(got, f), get(want, f)
        if a.shape != b.shape:
            out.append(f"{f}: shape {a.shape} against {b.shape}")
        elif f in CONTROL_EXACT:
            if not np.array_equal(a, b):
                out.append(f"{f}: {a.tolist()} != {b.tolist()}")
        elif not np.all(np.abs(a.astype(np.float64) - b)
                        <= CONTROL_RTOL[f] * np.abs(b)):
            out.append(f"{f}: {a.tolist()} vs {b.tolist()} (relative "
                       f"tolerance {CONTROL_RTOL[f]})")
    return out


def spmd_param_mismatches(got, want, start, steps: int,
                          bf16_agg: bool = False) -> List[str]:
    """Parameter dicts (numpy-convertible leaves) after ``steps`` spmd
    steps from the same ``start``: each leaf within ``steps`` ×
    (SPMD_PARAM_RTOL of its largest |value|, plus with a bf16 aggregation
    SPMD_BF16_MOVE_RTOL of its largest movement from ``start``)."""
    out = []
    for k in sorted(want):
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        tol = SPMD_PARAM_RTOL * np.abs(w).max()
        if bf16_agg:
            tol += SPMD_BF16_MOVE_RTOL * np.abs(
                w - np.asarray(start[k], np.float64)).max()
        gap = np.abs(g - w).max()
        if not gap <= steps * tol:
            out.append(f"{k}: largest gap {gap} beyond {steps} x {tol}")
    return out
