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

Even round 0 can part by more than a code flip: the local training itself
is chaotic where a ReLU pre-activation lies within float noise of 0. Its
two runs then take the kink on different sides for one sample, and one
hidden unit's gradient (its incoming and outgoing weights, its bias) moves
by a whole term of the batch mean. (Seed 2 of the anomaly-mlp parity case:
client 2's last local step, sample 0, unit 48 of the second hidden layer,
-6.3e-8 in the JAX package and +4.5e-9 in the port from the same
parameters; ~90 of 55,296 error-feedback elements then sit beyond
``EF_RTOL``, with some threading and instruction sets and not others.) So
an int8 run's round 0 is held in its two parts:

  * the codec, by bits: the port's error-feedback state is the reference
    codec's residual of the port's own pre-codec deltas;
  * the local training, step by step from the reference's state (each
    step's inputs the same in both packages, so nothing compounds): each
    leaf within ``STEP_RTOL`` of the step's largest movement of that leaf
    (``step_mismatches``), where the reference step takes the port's side
    of every ReLU whose pre-activation lies within the rounding band of 0
    (``relu_kinks``). A weight's gradient sums B products that can cancel
    to far below their size, so one step from the same state parts by up
    to 5.1e-5 of the largest movement (observed on the CPU: w0, step 0);
    a ReLU taken on the other side moves that unit's weights by 8.9e-4 of
    it (the kink above). STEP_RTOL = 5e-4 lies between. The band is
    ``PREACT_RTOL`` of Σ|h_i·w_ij| + |b_j|: an f32 sum of n terms in any
    order is within n·2^-24 of that, so the two packages' values of a fan-
    in of up to 256 terms are within 2^-15 of each other. A pre-activation
    that the two put on different sides outside the band is a different
    function, and ``relu_kinks`` names its client, step, layer, sample
    and unit.

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

A scenario's world (core/scenario.py) is computed on the host by one
function for every path and copied to the device, so the card and the CPU
run the same world bit for bit, and every path of one run takes the same
trajectory. Against the JAX package, given its link normals
(``world_mismatches``): the churn masks, the linear drift amplitude, the
dropout regime's scale and the byzantine factors are equal; the link
walks are a recurrent product of ``exp(σ·z)`` factors, and torch's f32
``exp`` and XLA's may differ by an ulp, which the walk carries on, so
round r's walks are within ``WALK_ULPS`` ulps per round walked
(observed: 4 ulps after 12 rounds); the sine amplitude takes one ``cos``,
within ``SINE_ULPS`` ulps (observed: equal). The engines are held to the
reference with its own trajectory fed in (``WorldSource(views=...)``), so
their records stay under the tolerances above.

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

A hierarchical topology (repro_torch/topology) is measurement only: a
run's records with it equal the same run's without it, bit for bit. Two
runs' topology summaries (``topology_problems``) are equal: the sync
counts follow the absolute round index; the link accounting adds the
same f32 values in the same order; and the accepts and vetoes are the
same as long as no θ test of a sync lies within ``THETA_BAND`` of its
boundary's θ (the margin is asserted, naming boundary, round and child
slot). Two topology states from the same inputs: each accumulator within
``TOPO_ACCUM_RTOL`` of Σ_c |w_c·u_c| (the ROADMAP's rule for a reduction
over clients: the JAX package scatter-adds client by client, the port
takes one product of a one-hot matrix, and f32 sums of up to a few dozen
terms in any order lie within a few 2^-24 of that scale), the reference
signs equal except where |agg| lies within that band of 0, where a sign
taken of rounding noise may differ.
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
STEP_RTOL = 5e-4          # of a local step's largest movement of the leaf
PREACT_RTOL = 2.0 ** -15  # of Σ|h_i·w_ij| + |b_j|: the ReLU's rounding band
PATH_TIME_RTOL = 1e-9
PATH_ACC_TOL = 2e-3
PATH_LOSS_RTOL = 1e-3
SCAN_RTOL = 1e-5
SCAN_EXACT_FIELDS = ("round", "updates_applied", "accept_rate")
EMA_RTOL = 1e-6
NORM_RTOL = 1e-4
CONTROL_EXACT = ("batch", "staleness", "has_ckpt")
SPMD_PARAM_RTOL = 1e-6
WALK_ULPS = 2             # per round walked: exp's ulp, carried on
SINE_ULPS = 2
SPMD_BF16_MOVE_RTOL = 2.0 ** -8
TOPO_ACCUM_RTOL = 1e-6    # of Σ_c |w_c·u_c|: a reduction over clients
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


def step_mismatches(got, want, start, where: str = "") -> List[str]:
    """Parameter dicts after one local step from the same ``start``: each
    leaf of ``got`` within STEP_RTOL of the largest movement of that leaf
    in ``want``; empty when they agree."""
    out = []
    for k in sorted(want):
        w = np.asarray(want[k], np.float64)
        tol = STEP_RTOL * np.abs(w - np.asarray(start[k], np.float64)).max()
        gap = np.abs(np.asarray(got[k], np.float64) - w).max()
        if not gap <= tol:
            out.append(f"{where}{k}: largest gap {gap} beyond {tol}")
    return out


def relu_kinks(z_got, z_want, zabs, where: str = ""):
    """Pre-activations (arrays (B, H) of one shape) that two runs put on
    different sides of the ReLU's kink: ``(kinks, faults)``, each a list
    of messages. ``kinks`` lie within PREACT_RTOL·``zabs`` (Σ|h_i·w_ij| +
    |b_j|, the rounding band) of 0 in ``z_want``; ``faults`` beyond it,
    where the two runs compute different functions."""
    z_got, z_want = np.asarray(z_got), np.asarray(z_want)
    band = PREACT_RTOL * np.asarray(zabs, np.float64)
    kinks, faults = [], []
    for b, j in np.argwhere((z_got > 0) != (z_want > 0)):
        msg = (f"{where}sample {b}, unit {j}: pre-activation "
               f"{z_got[b, j]:.3e} against {z_want[b, j]:.3e} (band "
               f"{band[b, j]:.3e})")
        (kinks if abs(z_want[b, j]) <= band[b, j] else faults).append(msg)
    return kinks, faults


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


def _ulps(got, want) -> np.ndarray:
    want = np.asarray(want, np.float32)
    gap = np.abs(np.asarray(got, np.float64) - want.astype(np.float64))
    return gap / np.spacing(np.abs(want)).astype(np.float64)


def world_mismatches(got: Sequence[dict], want: Sequence[dict],
                     sine: bool = False) -> List[str]:
    """Two world trajectories (host views, round 0 first) against the rules
    above: masks, regime scales, byzantine factors and a linear amplitude
    equal; the walks of round r within WALK_ULPS·(r + 1) ulps; a sine
    amplitude (``sine``) within SINE_ULPS ulps."""
    if len(got) != len(want):
        return [f"{len(got)} rounds against {len(want)}"]
    out = []
    for r, (g, w) in enumerate(zip(got, want)):
        for f in ("live", "dropout_scale", "byz_factor") + (
                () if sine else ("drift_amp",)):
            if not np.array_equal(np.asarray(g[f]), np.asarray(w[f])):
                out.append(f"round {r}: {f} {g[f]!r} != {w[f]!r}")
        bounds = {"bw_scale": WALK_ULPS * (r + 1),
                  "lat_scale": WALK_ULPS * (r + 1)}
        if sine:
            bounds["drift_amp"] = SINE_ULPS
        for f, bound in bounds.items():
            ulps = _ulps(g[f], w[f]).max(initial=0.0)
            if not ulps <= bound:
                out.append(f"round {r}: {f} {ulps} ulps apart (at most "
                           f"{bound})")
    return out


def topology_problems(got: dict, want: dict, theta_tests=(), thetas=(),
                      states=None, scale=None, ref_band=None) -> List[str]:
    """Two topology summaries (``topology_summary()``) against the rules
    above; empty when they agree.

    theta_tests: (boundary, round, child slot, ratio) of θ tests of either
    run (``TopologyRuntime.closest_theta_tests()``: each boundary's
    closest, which is within the band if any test is), thetas: each
    boundary's θ (None: no veto); a test within THETA_BAND of its θ is a
    problem, since the two runs' accepts may then part. With ``states``
    (got, want ``TopologyState``s, fields numpy-convertible) also: each
    accumulator ``accum[b]`` within TOPO_ACCUM_RTOL of ``scale[b]`` (an
    array of accum[b]'s shape: Σ_c |w_c·u_c| accumulated into it), the
    reference signs equal except where ``ref_band[b]`` (bool, ref[b]'s
    shape, or None) marks |agg| within that band of 0, ``has_ref`` equal.
    """
    out = [f"boundary {b}, round {r}, child {j}: ratio {x} within "
           f"{THETA_BAND} of θ={thetas[b]}" for b, r, j, x in theta_tests
           if thetas[b] is not None and abs(x - thetas[b]) <= THETA_BAND]
    for k in sorted(set(got) | set(want)):
        if got.get(k) != want.get(k):
            out.append(f"{k}: {got.get(k)!r} != {want.get(k)!r}")
    if states is None:
        return out
    g, w = states
    for b in range(len(w.accum)):
        a, e = np.asarray(g.accum[b], np.float64), np.asarray(w.accum[b],
                                                              np.float64)
        beyond = np.abs(a - e) > TOPO_ACCUM_RTOL * np.asarray(scale[b])
        if beyond.any():
            out.append(f"accum[{b}]: {int(beyond.sum())} elements beyond "
                       f"{TOPO_ACCUM_RTOL} of Σ|w·u| (largest gap "
                       f"{np.abs(a - e).max()})")
        differ = np.asarray(g.ref[b]) != np.asarray(w.ref[b])
        if ref_band is not None and ref_band[b] is not None:
            differ &= ~np.asarray(ref_band[b])
        if differ.any():
            out.append(f"ref[{b}]: {int(differ.sum())} signs differ outside "
                       f"the rounding band")
        if not np.array_equal(np.asarray(g.has_ref[b]),
                              np.asarray(w.has_ref[b])):
            out.append(f"has_ref[{b}]: {np.asarray(g.has_ref[b]).tolist()} "
                       f"!= {np.asarray(w.has_ref[b]).tolist()}")
    return out
