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
    EMA's factor 0.8 keeps from growing, within ``EMA_RTOL`` = 1e-6;
  * the update-norm EMA (``grad_norm``) takes the norms of each round's
    updates, several SGD steps each. From ONE state (the same parameters,
    control state, error feedback, reference sign and draws) one round's
    norms agree to 1e-4 (tests/test_torch_megastep.py), so after one
    round from one state the EMA is within ``NORM_RTOL`` = 1e-4
    (``norm_mismatches``). That is the check that holds it:
    ``chip_smoke.py`` replays every round of a scanned card run on the
    CPU from the card's carry before it, so no gap compounds. Over a run
    the two trajectories part, and round r's norms come from parameters
    the rounds before have moved apart; the local training amplifies
    that, as it does the error feedback below. On an H100 the fused
    quickstart's 8 rounds read a run gap of 1.1e-4 where its replayed
    rounds read at most 2.7e-6 each, ten times their sum: the gaps do not
    merely add, and no run bound follows from NORM_RTOL. The whole run's
    EMA is held, as the loss is (``LOSS_RTOL``), within an empirical
    limit, ``NORM_RUN_RTOL`` = 5e-4 whatever the number of rounds
    (``control_mismatches(..., norm_rtol=NORM_RUN_RTOL)``): about 4.5
    times the largest card-against-CPU reading of a sound run (1.1e-4,
    above; every scanned ``card_vs_cpu`` line of ``chip_smoke.py`` prints
    its ``grad_norm_gap``), and half of a fault it must see, a norm moved
    by 1e-3 relative in one client (tests/test_torch_scanned.py);
  * the population plane (core/population.py) updates each client's
    fields elementwise in f32, the same operations on both sides, so two
    population states from the same inputs have equal integer and bool
    fields and floats within ``EMA_RTOL`` (``population_mismatches``;
    the card and the CPU are found equal by bits);
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

Serving the detector (repro_torch/serve). Two engines fed the same
requests in the same order, with the same weights, queue limit, deadlines
and clock, admit, shed, expire and batch the same requests, so request
ids, model versions, the expired flags and the shed, expired and error
counts are equal (``serve_mismatches``). The probabilities are a softmax
of three matrix products whose sums another library adds in another
order: they agree within ``PROBS_RTOL`` relative and ``PROBS_ATOL``
absolute, the JAX package's own tolerance between a padded and a tight
batch (tests/test_serve.py), and the anomaly score 1 − p_0 within
``PROBS_RTOL + PROBS_ATOL`` (p_0 ≤ 1). The drift statistic
(``core/scenario.drift_statistic``) is a ratio of differences of f32
means, and ``drift_stat_bound`` derives its gap from the reductions: an
f32 sum of m terms in any order lies within m·2^-24·Σ|terms| of the exact
sum, so two packages' means of m rows lie within 2m·2^-24 of the largest
|value|; the window's means sum the whole bucket (padded rows masked to
exact zeros), the reference's its N rows, each EMA step adds a few
roundings (and XLA's and torch's f32 ``pow`` in the step's weight an ulp
or two); the scores carry the probabilities' tolerance into the score
moments. Those numerator gaps over the reference's standard deviations,
plus the statistic times the variances' relative gap (2(N + 3)·2^-24 and
the scores' share), bound each window's gap. A trigger decision is
reproducible only where no window's statistic lies within its bound of
the threshold: ``drift_problems`` asserts that and names the window.

Mixture-of-experts routing (models/moe.py). Two runs of one layer from
inputs equal to float rounding choose each token's k experts from their
own f32 router logits z (T, E). Within a row the gates are a softmax of
the logits, exp(z_e − max_t)/Σ, so two gates compare as their logits do,
except where the roundings of one run tie or swap them. Each rounding
moves a gate by a relative amount, which is a shift of its logit by the
same amount: the subtraction z_e − max_t by up to half an ulp of
|z_e − max_t|, at most ulp(R_t)/2 with R_t = max_e |z_t,e − max_t| the
row's range; exp by up to one ulp of the gate (2^-23 relative) and the
division by half of one (2^-24). Two gates compared in one run: ulp(R_t)
+ ``ROUTER_GATE_ULPS``·2^-24, ROUTER_GATE_ULPS = 6; ulp(R_t) is taken
twice, since the runs' ranges may fall in neighbouring binades. So the
set of token t's k experts can differ between the runs only where its
k-th and (k + 1)-th logits lie within 2·δ_t + 2·ulp(R_t) + 6·2^-24 of
each other, δ_t = max_e |z_t,e − z'_t,e| the largest gap between the two
runs' logits of that token (each of the two logits moves by at most
δ_t) and R_t the larger of their ranges. The margin is taken from the
runs' own logits, not chosen. Where every token's k-th and
(k + 1)-th logits lie beyond it, the chosen sets are equal, and with them
each choice's capacity position (its expert's choices before it in the
flat token-major order), kept flag and slot: ``routing_problems`` holds
them equal, each token's choices taken in expert order. The order of the
k choices within a token is not a routing decision: it moves no position
(a token names each expert once), only the order in which the combine
adds the k outputs; ``top_k``'s tie order is held to ``jax.lax.top_k`` on
its own (tests/test_torch_moe.py). A token within its margin is a case
whose routing is not reproducible, and ``routing_problems`` names it by
call and token, as the θ rule names a ratio within ``THETA_BAND``. Over
whole runs the layers' inputs part by the earlier layers' rounding, and δ
with them: granite-moe at full width, 2 layers in f32, an H100 against
the CPU, met a token 9.3e-6 apart against a margin of 1.1e-5 (without the
subtraction's term; about one
run in ten at that δ, 1,032 routed token-layers and a k-th gap density
near 10). So a layer's routing is held on one input, the
card's replayed on the CPU (the replay-from-one-state rule), where δ is
the router product's rounding alone; the two runs' routing is printed.

Language-model training (the spmd step with adamw; core/fl_step.py). Two
packages' per-client gradients of one state part by f32 rounding. Each
element of the gradient arena is a mean over the client's T token
positions of products back-propagated through reductions of width at
most K (the widest contraction: the model width, the FFN width, the
padded vocabulary, the sequence). An f32 sum of n terms in any order is
within n·2^-24 of the sum of their magnitudes, so one package's element
is within (K + T)·2^-24 of the terms' scale, and two packages' within
twice that: ``grad_bound`` is GRAD_RUNS·(K + T)·2^-24·M, with M the
leaf's largest |g| standing for the scale of its terms (a scale, not a
proof: a sum that cancels far below its terms can exceed it, and
``grad_problems`` names such an element). AdamW's first step moves a
weight by lr·g/(|g| + ε): an element whose sign the rounding decides
moves by 2·lr in one package against the other. So ``adamw_weight_
problems`` holds the weights elementwise only where every step's
aggregated |g| exceeds its bound (the sign is the same in both runs), as
``ref_sign_problems`` holds a step's reference signs.
There a step's ratio m̂/(√v̂ + ε) is a quotient of two averages of the
step's gradients, each moved by at most bound/|g| relative, so the two
packages' steps differ by at most 2·lr·(bound/|g|)·R, R = √(Σ_k a_k²/b_k)
the Cauchy–Schwarz bound of |m̂|/√v̂ (a_k, b_k the bias-corrected EMA
weights of step k in m̂ and v̂; R = 1 after one step, 1.0014 after two),
plus the f32 rounding of the update and of the weight (4 ulps of the
larger of the weight and the step). Elsewhere a weight is within its
steps' 2·lr·R of the reference.

An attention without rotary (whisper's) adds its key bias b_k to every
key, so every score of a query's row moves by the same q·b_k, which the
softmax ignores: the bias's gradient, Σ over positions of the keys'
gradients, is zero in exact arithmetic, and each package's value is the
rounding of that cancelling sum, far above its own tiny max|g|. Its terms
are the keys' gradients, whose scale the key weight's gradient Σ_pos
x_pos·dk_pos carries (x the normed input, of order one): such a leaf is
held to ``grad_bound`` of its key weight's gradient (``null_bias_scales``;
the bias of the values and queries is not shift-invariant and keeps its
own).

Adafactor keeps no first moment, so a step's aggregated gradient cannot
be read back from its state: it is read where the optimizer receives it,
held by ``grad_problems``, and the weights are held by a replay from one
state (``adafactor_replay_problems``): the reference's optimizer applied
to the run's own gradient from the state both runs started from. The two
then differ by the optimizer's roundings alone. Its row and column means
sum n positive terms in another order, within n·2^-24 relative; the
factored denominator multiplies two such means and divides by a third,
and the update takes its rsqrt: 4·n·2^-24 + 4 ulps relative of the
update, n the leaf's widest mean (``tests/test_torch_optim.py``'s
``FACTOR_RTOL``). The RMS clip divides by κ = max(rms(u), 1), a mean of
the leaf's N squares, within (N/2 + 2)·2^-24 of itself for any order of
summation, and |u|/κ ≤ √N. So a weight is within 4 ulps of its size plus
lr·√N·(4·n·2^-24 + 4·2^-23 + (N/2 + 2)·2^-24) of the replay: a worst
case that above 2^24 elements exceeds a step, so there a weight is held
to its step's size only. Where a factored leaf's gradient lies at
rounding level (a null direction's, as the key bias above), r_i·c_j can
fall below f32's least normal 2^-126: the product is subnormal, which
XLA's CPU code flushes to zero and torch keeps, and the relative rounding
above no longer holds. Such a leaf is held to its two steps' size,
2·lr·√N (each run moves a weight by at most lr·√N from the same start).

Language models on the sim engines (the loop, the megastep and the
scanned path; core/megastep.py's ``lm_local_sgd``). Each client takes S
steps of momentum SGD from the round's globals: step t's gradient enters
the client's delta with the weight lr·c_t, c_t = Σ_{u=t}^{S-1} μ^(u-t), so
two packages' deltas from one start part by at most lr·Σ_t c_t·
``grad_bound``(g_t) per leaf (``sgd_delta_bounds``; a later step's
gradient is taken at weights the earlier steps moved apart by that much,
which moves it by the Hessian times the gap, left out as lr·|H| ≪ 1 for a
stable step: a scale, as ``grad_bound`` is). A round's aggregation weights
sum to at most α₀ (α(τ) ≤ α₀ over the count applied; 1/|S| under sync), so
the new globals part by at most α₀ times the largest client's bound, plus
S + 3 f32 roundings of the leaf's scale (one per local step, the delta's
subtraction, the weighted sum and its addition to the globals):
``sim_round_bounds`` and ``sim_weight_problems`` hold the globals after
one round from a shared start, ``ref_sign_problems`` the reference signs
where the movement exceeds the same bound. This holds for f32 weights.
With bf16 weights the two packages round the model's intermediate values
at different points (XLA keeps f32 inside a fused loop, torch rounds each
operation's output to bf16), and no bound on those roundings is derived
here: a bf16 run's
records are held by the fields that depend on its θ decisions alone
(``exact_field_mismatches``: times, bytes — with bf16 leaves counted at 2
bytes, as the JAX package counts them — update counts, accept rates) and
its θ tests by ``THETA_BAND``; its loss and accuracy are printed, not held
(observed on the CPU after 2 rounds of the smoke configs: granite-moe and
rwkv6 at 2.0e-3 and 2.3e-3 of the loss, qwen2 and hymba within 1e-3).

The recurrent states (models/rwkv6.py's ``S`` and its token shifts
``tshift``, ``cshift``; models/hybrid.py's ``h`` and its conv window
``conv``) are sums over the T steps taken. rwkv6 updates S ← w·S + k⊗v
with w = exp(−exp(·)) in (0, 1), hymba h ← exp(dt·A)·h + dt·x·B with dt
> 0 and A < 0: the carried state is multiplied by a factor at most 1, so
a gap made at one step never grows, and the T steps' gaps add. Each
step's new term is a product of inputs that come from reductions of
width at most K (the model and FFN widths), within K·2^-24 of their
terms' scale in each run, and the update adds one rounding; over T steps
one run is within (K + T)·2^-24 of the scale of the summed terms, and
two runs within twice that: ``state_problems`` holds each leaf to
GRAD_RUNS·(K + T)·2^-24·max|s|, with max|s| standing for the scale as
``grad_bound`` does (a scale, not a proof), T the steps the state has
taken (the prompt, then each decode step). The token shifts and the conv
window are the last tokens' normed inputs, which read the earlier
layers' states, and take the same rule.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

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
NORM_RUN_RTOL = 5e-4      # a run's update-norm EMA: empirical (docstring)
CONTROL_EXACT = ("batch", "staleness", "has_ckpt")
SPMD_PARAM_RTOL = 1e-6
WALK_ULPS = 2             # per round walked: exp's ulp, carried on
SINE_ULPS = 2
SPMD_BF16_MOVE_RTOL = 2.0 ** -8
TOPO_ACCUM_RTOL = 1e-6    # of Σ_c |w_c·u_c|: a reduction over clients
PROBS_RTOL = 1e-5         # served probabilities (tests/test_serve.py's own)
PROBS_ATOL = 1e-6
F32_U = 2.0 ** -24        # f32 unit roundoff
GRAD_RUNS = 2             # two packages' roundings of one gradient
ROUTER_GATE_ULPS = 6      # two gates' exp (1 ulp) and division (1/2 ulp)
CONTROL_RTOL = {"avail": EMA_RTOL, "pass_rate": EMA_RTOL,
                "round_time": EMA_RTOL, "lr_scale": EMA_RTOL,
                "grad_norm": NORM_RTOL}


def record_mismatches(got: Sequence, want: Sequence) -> List[str]:
    """Every way the records ``got`` fall outside the tolerances of
    ``want``; empty when they agree."""
    out = exact_field_mismatches(got, want)
    if len(got) != len(want):
        return out
    for g, w in zip(got, want):
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


def control_mismatches(got, want, norm_rtol: float = NORM_RTOL) -> List[str]:
    """Two ``ControlState``s (dicts or objects of numpy-convertible
    fields): integer fields equal, f32 statistics within CONTROL_RTOL, the
    update-norm EMA within ``norm_rtol`` (NORM_RTOL: one round from one
    state; NORM_RUN_RTOL: a card and a CPU run of several rounds); the
    error-feedback arena is left to ``ef_mismatches``."""
    def get(state, f):
        return np.asarray(state[f] if isinstance(state, dict)
                          else getattr(state, f))
    out = []
    for f in CONTROL_EXACT + tuple(CONTROL_RTOL):
        a, b = get(got, f), get(want, f)
        rtol = norm_rtol if f == "grad_norm" else CONTROL_RTOL.get(f)
        if a.shape != b.shape:
            out.append(f"{f}: shape {a.shape} against {b.shape}")
        elif f in CONTROL_EXACT:
            if not np.array_equal(a, b):
                out.append(f"{f}: {a.tolist()} != {b.tolist()}")
        elif not np.all(np.abs(a.astype(np.float64) - b)
                        <= rtol * np.abs(b)):
            out.append(f"{f}: {a.tolist()} vs {b.tolist()} (relative "
                       f"tolerance {rtol})")
    return out


def norm_mismatches(got, want, where: str = "") -> List[str]:
    """Two update-norm EMAs ((N,) arrays) one round from one state: within
    NORM_RTOL relative, client by client; empty when they agree."""
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    if a.shape != b.shape:
        return [f"{where}grad_norm: shape {a.shape} against {b.shape}"]
    off = np.flatnonzero(~(np.abs(a - b) <= NORM_RTOL * np.abs(b)))
    return [f"{where}grad_norm of client {c}: {a[c]!r} vs {b[c]!r} "
            f"(relative tolerance {NORM_RTOL})" for c in off]


def population_mismatches(got, want, fields: Sequence[str]) -> List[str]:
    """Two population states (dicts of numpy-convertible (N,) fields):
    ``CONTROL_EXACT`` fields and bools equal, the other floats within
    EMA_RTOL relative."""
    out = []
    for f in fields:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if a.shape != b.shape:
            out.append(f"{f}: shape {a.shape} against {b.shape}")
        elif f in CONTROL_EXACT or a.dtype == bool:
            if not np.array_equal(a, b):
                out.append(f"{f}: {np.count_nonzero(a != b)} clients differ")
        elif not np.all(np.abs(a.astype(np.float64) - b)
                        <= EMA_RTOL * np.abs(b)):
            out.append(f"{f}: beyond the relative tolerance {EMA_RTOL}")
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


def serve_mismatches(got: Sequence, want: Sequence) -> List[str]:
    """Two engines' responses (``serve.Response``, in the order each
    engine returned them) against the serving rules above: ids, versions
    and expired flags equal, probabilities within PROBS_RTOL / PROBS_ATOL
    (NaN where expired, in both), scores within PROBS_RTOL + PROBS_ATOL;
    empty when they agree."""
    if len(got) != len(want):
        return [f"{len(got)} responses against {len(want)}"]
    out = []
    for g, w in zip(got, want):
        key = (g.request_id, g.model_version, g.expired)
        if key != (w.request_id, w.model_version, w.expired):
            out.append(f"response (id, version, expired) {key} != "
                       f"{(w.request_id, w.model_version, w.expired)}")
            continue
        gp = np.asarray(g.probs, np.float64)
        wp = np.asarray(w.probs, np.float64)
        if not np.array_equal(np.isnan(gp), np.isnan(wp)):
            out.append(f"request {w.request_id}: NaN probabilities differ")
            continue
        gap = np.abs(gp - wp)[~np.isnan(wp)]
        lim = (PROBS_RTOL * np.abs(wp) + PROBS_ATOL)[~np.isnan(wp)]
        if (gap > lim).any():
            out.append(f"request {w.request_id}: probabilities "
                       f"{gp.tolist()} vs {wp.tolist()}")
        if not (math.isnan(g.score) and math.isnan(w.score)) and not abs(
                g.score - w.score) <= PROBS_RTOL + PROBS_ATOL:
            out.append(f"request {w.request_id}: score {g.score} vs "
                       f"{w.score}")
    return out


def drift_stat_bound(stream_x, ref_x, ref_scores, bucket: int,
                     windows: int, stat: float, eps: float = 1e-6) -> float:
    """Largest gap between two packages' drift statistics after
    ``windows`` masked EMA updates over buckets of at most ``bucket``
    rows, where ``stream_x`` holds the real rows of every window so far,
    and the references were taken of ``ref_x`` (N, F) with scores
    ``ref_scores`` (N,), each package's own (within the probabilities'
    tolerance of each other). ``stat`` is the statistic (either
    package's). The derivation is in the module docstring."""
    u = F32_U
    xs = np.abs(np.asarray(stream_x, np.float64)).max(axis=0)
    xr = np.asarray(ref_x, np.float64)
    s = np.asarray(ref_scores, np.float64)
    n = xr.shape[0]
    sigma = np.sqrt(xr.var(axis=0) + eps)
    sig_s = math.sqrt(s.var() + eps)
    ema = 2 * u * (bucket + 6 * windows)       # window means + EMA steps
    var_rel = 2 * (n + 3) * u                  # a variance of N rows
    # the features' term: mean over F of |mu - mu_ref| / sigma_ref
    e_mu = ema * xs + 2 * u * n * np.abs(xr).max(axis=0)
    feat = float(np.mean(e_mu / sigma)) + stat * (var_rel / 2 + (
        xr.shape[1] + 4) * u)
    # the scores' term: |s - s_ref| / sigma_s, the scores in [0, 1] and
    # each package's within PROBS_RTOL + PROBS_ATOL of the other's
    d = PROBS_RTOL + PROBS_ATOL
    e_s = 2 * d + ema + 2 * u * n
    svar_rel = (2 * d * float(np.abs(s - s.mean()).max()) + d * d) / (
        s.var() + eps) + var_rel
    score = e_s / sig_s + stat * (svar_rel / 2 + 4 * u)
    return max(feat, score)


def drift_problems(got: Sequence[float], want: Sequence[float],
                   bounds: Sequence[float], threshold: float) -> List[str]:
    """Two monitors' per-window statistics (``DriftMonitor.history``)
    against their ``drift_stat_bound``s, and every window's margin to the
    threshold: a statistic within its bound of the threshold is a
    problem (the two monitors may then count that window differently),
    named by its window; empty when the trigger decisions are sure to be
    the same."""
    if len(got) != len(want):
        return [f"{len(got)} windows against {len(want)}"]
    out = []
    for w, (a, b, lim) in enumerate(zip(got, want, bounds)):
        if not abs(a - b) <= lim:
            out.append(f"window {w}: statistic {a} vs {b} (bound {lim})")
        if abs(b - threshold) <= lim:
            out.append(f"window {w}: statistic {b} within {lim} of the "
                       f"threshold {threshold}")
    return out


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array, as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def routing_problems(got: Sequence, want: Sequence) -> List[str]:
    """Two runs' routing, call by call (``moe.Routing`` or any records
    with its ``logits``, ``topi``, ``keep`` and ``slot``; the layers of a
    prefill, then of each decode step, in order), against the routing
    rule above: every token's k-th and (k + 1)-th logits (in ``want``)
    farther apart than its margin, and where they are, each token's
    experts, kept flags and slots equal in expert order; empty when they
    agree."""
    if len(got) != len(want):
        return [f"{len(got)} routed calls against {len(want)}"]
    out = []
    for n, (g, w) in enumerate(zip(got, want)):
        zg = _host(g.logits).astype(np.float64)
        zw = _host(w.logits).astype(np.float64)
        if zg.shape != zw.shape:
            out.append(f"call {n}: logits {zg.shape} against {zw.shape}")
            continue
        T, k = _host(w.topi).shape
        span = np.maximum(zg.max(axis=1) - zg.min(axis=1),
                          zw.max(axis=1) - zw.min(axis=1))
        margin = (2 * np.abs(zg - zw).max(axis=1)
                  + 2 * np.spacing(span.astype(np.float32)).astype(np.float64)
                  + ROUTER_GATE_ULPS * F32_U)
        ranked = -np.sort(-zw, axis=1)
        gap = ranked[:, k - 1] - ranked[:, k] if k < zw.shape[1] else \
            np.full(T, np.inf)
        close = np.nonzero(gap <= margin)[0]
        for t in close[:5]:
            out.append(f"call {n} token {t}: logits {k} and {k + 1} lie "
                       f"{gap[t]} apart, within the margin {margin[t]}: "
                       f"its routing is not reproducible")
        if len(close):
            continue
        for name in ("topi", "keep", "slot"):
            a, b = (np.take_along_axis(
                _host(getattr(r, name)).reshape(T, k),
                np.argsort(_host(r.topi), axis=1, kind="stable"), axis=1)
                for r in (g, w))
            if not np.array_equal(a, b):
                rows = np.nonzero((a != b).any(axis=1))[0][:5].tolist()
                out.append(f"call {n}: {name} differs at tokens {rows}")
    return out


# ---------------------------------------------------------------------------
# language-model training
# ---------------------------------------------------------------------------

def _f64(x, device=None) -> torch.Tensor:
    """A numpy array or a tensor as an f64 tensor (on ``device``, else
    where it lies): the LM rules below run in torch, on the card when the
    caller's tensors are there (an LM leaf has hundreds of millions of
    elements)."""
    t = x.detach() if torch.is_tensor(x) else torch.tensor(np.asarray(x))
    return t.to(device=device if device is not None else t.device,
                dtype=torch.float64)


def grad_bound(g, width: int, rows: int) -> float:
    """The largest gap two packages' f32 gradients of one leaf ``g`` may
    show: GRAD_RUNS·(width + rows)·2^-24·max|g| (module docstring)."""
    g = _f64(g)
    top = float(g.abs().max()) if g.numel() else 0.0
    return GRAD_RUNS * (width + rows) * 2.0 ** -24 * top


def null_bias_scales(grads: Dict[str, object], leaves) -> Dict[str, object]:
    """For each key-bias leaf name in ``leaves`` (an attention without
    rotary: whisper's), its key weight's gradient (the name's ``bk``
    replaced by ``wk``) to stand for its scale (module docstring)."""
    return {k: grads[k[:-2] + "wk"] for k in leaves}


def _bound_problems(got, want, width: int, rows: int, where: str,
                    what: str, scales=None) -> List[str]:
    """Leaves (name -> array or tensor) of two runs that part by more than
    ``grad_bound`` of the reference leaf (or of ``scales[name]``), each
    named with its gap."""
    out = []
    scales = scales or {}
    for k in sorted(want):
        w = _f64(want[k])
        gap = (_f64(got[k], w.device) - w).abs()
        gap = float(gap.max()) if gap.numel() else 0.0
        bound = grad_bound(scales.get(k, w), width, rows)
        if not gap <= bound:
            out.append(f"{where}{k}: {what} gap {gap} beyond {bound}")
    return out


def grad_problems(got: Dict[str, object], want: Dict[str, object],
                  width: int, rows: int, where: str = "",
                  scales: Dict[str, object] = None) -> List[str]:
    """Leaves of two gradients (name -> array or tensor) that part by more
    than ``grad_bound`` of the reference leaf (or of ``scales[name]``,
    where given), each named with its gap."""
    return _bound_problems(got, want, width, rows, where, "gradient", scales)


def ref_sign_problems(got: Dict[str, object], want: Dict[str, object],
                      grads: Dict[str, object], bounds: Dict[str, float],
                      where: str = "") -> List[str]:
    """A step's reference signs (name -> int8 array or tensor) equal
    wherever the reference's aggregated |g| exceeds its bound; elsewhere
    the rounding may decide the sign (module docstring)."""
    out = []
    for k in sorted(want):
        w = _f64(want[k])
        decided = _f64(grads[k], w.device).abs() > bounds[k]
        bad = (decided & (_f64(got[k], w.device) != w)).reshape(-1)
        if bool(bad.any()):
            out.append(f"{where}{k}: {int(bad.sum())} decided signs differ, "
                       f"first flat {int(torch.nonzero(bad)[0])}")
    return out


def lm_grad_width(cfg, seq: int) -> int:
    """K of a language model's gradient element: the widest contraction
    behind it (the model and FFN widths, the padded vocabulary, the
    sequence, and for audio the encoder frames)."""
    return max(cfg.d_model, cfg.d_ff, cfg.padded_vocab, seq,
               cfg.encoder_seq if cfg.family == "audio" else 0)


def sgd_delta_bounds(grads: Sequence[Dict[str, object]], lr: float,
                     momentum: float, width: int, rows: int
                     ) -> Dict[str, float]:
    """The largest gap two packages' deltas of one client's local momentum
    SGD from a shared start may show, per leaf: lr·Σ_t c_t·grad_bound(g_t)
    with c_t = Σ_{u=t}^{S-1} μ^(u-t) (module docstring). ``grads``: the S
    steps' gradients as the client's optimizer received them (name ->
    array or tensor)."""
    S = len(grads)
    c = [sum(momentum ** (u - t) for u in range(t, S)) for t in range(S)]
    return {k: lr * sum(c[t] * grad_bound(grads[t][k], width, rows)
                        for t in range(S)) for k in grads[0]}


def sim_round_bounds(want: Dict[str, object], start: Dict[str, object],
                     client_bounds: Sequence[Dict[str, float]], steps: int,
                     weight_sum: float) -> Dict[str, float]:
    """The largest gap two runs' f32 globals after one sim round from the
    shared ``start`` may show, per leaf (name -> array or tensor): the
    round's ``weight_sum`` times the largest of its clients'
    ``sgd_delta_bounds``, plus S + 3 f32 roundings of the leaf's scale
    (module docstring). ``want``: the reference's globals after it."""
    out = {}
    for k in want:
        w = _f64(want[k])
        s0 = _f64(start[k], w.device)
        scale = float(s0.abs().max()) + float((w - s0).abs().max())
        out[k] = (weight_sum * max(b[k] for b in client_bounds)
                  + (steps + 3) * 2.0 ** -23 * scale)
    return out


def sim_weight_problems(got: Dict[str, object], want: Dict[str, object],
                        bounds: Dict[str, float], where: str = ""
                        ) -> List[str]:
    """Globals after one sim round (name -> array or tensor), each leaf
    within its ``sim_round_bounds`` of the reference's."""
    out = []
    for k in sorted(want):
        w = _f64(want[k])
        gap = float((_f64(got[k], w.device) - w).abs().max())
        if not gap <= bounds[k]:
            out.append(f"{where}{k}: weight gap {gap} beyond {bounds[k]}")
    return out


def exact_field_mismatches(got: Sequence, want: Sequence) -> List[str]:
    """``record_mismatches`` without loss and accuracy: the records of a
    bf16 run (module docstring)."""
    if len(got) != len(want):
        return [f"{len(got)} records against {len(want)}"]
    return [f"round {w.round}: {f} {getattr(g, f)!r} != {getattr(w, f)!r}"
            for g, w in zip(got, want) for f in EXACT_FIELDS
            if getattr(g, f) != getattr(w, f)]


def adam_ratio_bound(steps: int, b1: float = 0.9, b2: float = 0.999
                     ) -> float:
    """R = √(Σ_k a_k²/b_k): the largest |m̂|/√v̂ after ``steps`` steps."""
    a = [(1 - b1) * b1 ** (steps - 1 - k) / (1 - b1 ** steps)
         for k in range(steps)]
    b = [(1 - b2) * b2 ** (steps - 1 - k) / (1 - b2 ** steps)
         for k in range(steps)]
    return math.sqrt(sum(x * x / y for x, y in zip(a, b)))


def adamw_weight_problems(got: Dict[str, object], want: Dict[str, object],
                          grads: Sequence[Dict[str, object]],
                          bounds: Sequence[Dict[str, float]],
                          lrs: Sequence[float], count0: int = 0,
                          where: str = "") -> List[str]:
    """Weights after len(grads) adamw steps (name -> f32 array or tensor),
    held by the rule of the module docstring: ``grads`` the reference's
    aggregated gradient of each step, ``bounds`` each step's bound of
    each leaf, ``lrs`` each step's learning rate; ``count0`` the
    optimizer's step count before the first of them."""
    out = []
    steps = len(grads)
    reach = sum(2 * lr * adam_ratio_bound(count0 + t + 1)
                for t, lr in enumerate(lrs))
    for k in sorted(want):
        w = _f64(want[k])
        gap = (_f64(got[k], w.device) - w).abs().reshape(-1)
        decided = torch.ones_like(gap, dtype=torch.bool)
        allowed = torch.zeros_like(gap)
        for t in range(steps):
            g = _f64(grads[t][k], w.device).abs().reshape(-1)
            decided &= g > bounds[t][k]
            rel = torch.where(g > 0, bounds[t][k] / g, math.inf)
            allowed += 2 * lrs[t] * rel * adam_ratio_bound(count0 + t + 1)
        rounding = 4 * 2.0 ** -23 * (w.abs().reshape(-1) + sum(lrs))
        allowed += rounding
        bad = decided & ~(gap <= allowed)
        if bool(bad.any()):
            i = int(torch.nonzero(bad)[0])
            out.append(f"{where}{k}: {int(bad.sum())} decided weights "
                       f"beyond the rule, first flat {i}: gap "
                       f"{float(gap[i])} beyond {float(allowed[i])}")
        wild = ~decided & ~(gap <= reach + rounding)
        if bool(wild.any()):
            i = int(torch.nonzero(wild)[0])
            out.append(f"{where}{k}: undecided weight flat {i} moved "
                       f"{float(gap[i])} from the reference, beyond {reach}")
    return out


def state_problems(got: Dict[str, object], want: Dict[str, object],
                   width: int, steps: int, where: str = "") -> List[str]:
    """Recurrent-state leaves (name -> array or tensor) of two runs that
    part by more than GRAD_RUNS·(width + steps)·2^-24·max|s| of the
    reference leaf (module docstring), each named with its gap."""
    return _bound_problems(got, want, width, steps, where, "state")


def adafactor_replay_problems(got: Dict[str, object],
                              want: Dict[str, object], lr: float,
                              stats: Dict[str, dict], where: str = ""
                              ) -> List[str]:
    """Weights after one adafactor step (name -> f32 array or tensor)
    against the reference optimizer's replay of that step on the run's own
    gradient from the same state, by the rule of the module docstring;
    ``stats`` the replay's new statistics of each leaf (``r`` and ``c``,
    or ``v``)."""
    out = []
    for k in sorted(want):
        w = _f64(want[k])
        n = max(w.shape[-2:]) if w.dim() >= 2 else 1
        N = max(w.numel(), 1)
        rel = 4 * n * F32_U + 4 * 2.0 ** -23
        allowed = 4 * 2.0 ** -23 * w.abs() + lr * math.sqrt(N) * (
            rel + (N / 2 + 2) * F32_U)
        st = stats[k]
        if "r" in st and float(_f64(st["r"]).min()) * float(
                _f64(st["c"]).min()) < 2.0 ** -126:
            allowed = torch.full_like(w, 2 * lr * math.sqrt(N))
        gap = (_f64(got[k], w.device) - w).abs()
        bad = ~(gap <= allowed)
        if bool(bad.any()):
            i = int(torch.nonzero(bad.reshape(-1))[0])
            out.append(f"{where}{k}: {int(bad.sum())} weights beyond the "
                       f"adafactor replay, first flat {i}: gap "
                       f"{float(gap.reshape(-1)[i])} beyond "
                       f"{float(allowed.reshape(-1)[i])}")
    return out


def recording(optimizer):
    """(optimizer, grads): ``optimizer`` whose update first appends the
    gradient nest it receives (a step's aggregated gradient) to the list
    ``grads``, for the rules above that read it."""
    from repro_torch.optim.adamw import Optimizer
    grads = []

    def update(g, state, params, lr_now=None):
        grads.append(g)
        return optimizer.update(g, state, params, lr_now=lr_now)

    return Optimizer(optimizer.init, update), grads
