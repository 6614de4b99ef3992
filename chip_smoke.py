#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

  1. device  — the card's name and power limit (nvidia-smi), torch and
               CUDA versions; TF32 matmuls must be off.
  2. build   — compile every ``csrc/*.cu`` with nvcc, all at once; the
               wgmma flash source's ptxas report per instantiation
               (registers, spill bytes, which must be 0, shared memory).
  3. kernels — each hand-written kernel against its plain PyTorch version on
               the card. Sign-align and masked-agg at the main path's shape (C
               = 16 clients, R = 54 arena rows) and a ragged one (C = 5, R =
               7), with ±0 updates and -2 sentinel padding; the int8 codec at
               864 rows (the cohort folded), 54 (one client), 35, and 432 and
               433 (either side of its switch from 512 to 256 threads a row),
               with zero, ±0, exact-tie, 1e30 and subnormal rows, codes,
               scales and values equal; the fused error-feedback round trip
               ``ef_round_trip`` at the same rows with a zero and a random e,
               restored values and residuals equal by bits to its plain
               version (the add, the codec's two halves and the subtract);
               ``quantize_q8`` and ``ef_round_trip`` timed at every row count
               the main paths give them (54 to 864), the round trip beside
               that four-op path on the kernels (``today_ms``,
               ``today_device_ms``); the
               cohort gather at the error-feedback arena's shape (11 slabs of
               54 rows) for 10 and 5 clients and at a ragged (7, 3) with -0.0,
               NaN, Inf and subnormal slabs, equal by bits; ``fused_update`` at
               (C, R) = (10, 54), (16, 864), (1, 35) with f32 p and at (10, 54)
               with bf16 p (within 1e-6 of Σ_c|w_c·u_c| plus one f32 ulp of the
               larger of |p| and |result|, and for bf16 one bf16 ulp more);
               ``masked_agg``, and ``fused_update`` in f32 and bf16 (bf16 also
               equal by bits to p − masked_agg rounded once), also at every C
               in {1, 7, 8, 9, 16, 17, 40} by R in {1, 54, 257}, at C 4 × R
               4096 and at C in {257, 300} by R in {1, 54} (the chunks of 16
               clients, their tails, many blocks and more than one tile of
               weights), with ±Inf in a zero-weight client's row, which must
               give NaN at the same positions as the plain version (0·Inf), the
               rest within the tolerances above, and at R = 0 (an empty result,
               no fault); ``per_client_sign_align`` also at every C in {1, 7,
               8, 9, 16, 17, 20, 24, 27, 40, 44, 66, 132, 257} by R in {0, 1,
               7, 54} and at C 16 × R 864 (every cluster size from 8 blocks a
               client down to 1; R = 0 gives C zeros), and both sign kernels on
               an input with every sign case (±0, NaN, ±Inf, f32 and bf16
               subnormals, the -2 padding), counts equal, also to the plain
               version on the CPU; ``sign_align_counts`` at 54, 864, 35, 1 and
               7 rows, f32 and bf16, counts equal. The timed rows of the
               aggregation, sign and quantize kernels carry ``design``: threads
               a block, blocks, registers a thread, the cluster's dimensions if
               the trace has them and clients a chunk where the kernel's name
               has them, read from a ``torch.profiler`` trace of three calls at
               the timed shape, which must hold exactly one device operation
               (kernel, memset or memcpy) a call. Times with CUDA events: eager
               (back to back calls) and device (a CUDA graph), each kernel's
               and, where one PyTorch call computes the same function, that
               call's (``library_ms``, ``library_device_ms``). Every wrapper
               launches through ``kernels/_launch.py``; for ``quantize_q8``,
               ``dequantize_q8`` and ``cohort_gather`` the split of one call's
               host time by piece (``host_us``: checks, lookup, stream, alloc,
               the C call, the whole call) and its eager ms beside its library
               call's, in turns. Then (``"phase": "launch"``) the launch path's
               stream must be PyTorch's current one on the default stream,
               under ``torch.cuda.stream(side)`` and during a graph's capture,
               and ten non-contiguous or misaligned inputs to the wrappers must
               be refused with ``ValueError``.
  4. slice   — the paper's quickstart experiment (anomaly-mlp, 10 clients,
               20,000 samples, 8 rounds) through ``repro_torch.run_experiment``
               on the card, from random weights made from a seed: ``fedavg``,
               ``ours``, and ``ours`` with int8 wire compression on the
               megastep path and on the per-client loop
               (``megastep=False``); then the scanned path, 4 rounds per
               dispatch: ``ours`` + int8 with fused eval, ``ours`` + int8
               selecting half the clients, and ``fedavg``. Every kernel of
               each path must launch, the gather once a round in the int8
               scanned runs; on every path each ``compress_cohort`` call
               launches ``ef_round_trip`` once, the int8 cohort paths
               (megastep, scanned, spmd) launch no codec kernel, and the
               per-client loop launches the codec pair; each run's line
               counts the round trip's and ``quantize_q8``'s calls by rows
               (``rows_per_call``). One dispatch of 4 rounds runs under
               ``torch.cuda.set_sync_debug_mode("error")``: any host
               synchronisation inside it raises. Then ``torch.profiler``
               traces one warm scanned dispatch and one warm megastep
               round (``"phase": "trace"``): kernels a round, device busy
               time and the device's idle share of the wall time.
  5. card vs CPU — ``ours`` and compressed ``ours`` (megastep) on the card
               and on the CPU from the same weights: selection, dropout,
               bytes, update counts and times equal, accuracy and loss
               within ``repro_torch.api.parity``, the error-feedback arenas
               after round 0 within its EF tolerances; in round 0 every
               round trip's restored values and residuals on the card must
               equal by bits the plain round trip of the same inputs, the
               int8 codes of the two runs' inputs that differ (the card's
               d + e against the CPU's, each coded by the plain version) are
               counted, and per round the
               error-feedback elements beyond its EF_RTOL, card against CPU
               and card against a card run from weights one ulp apart. The
               card's compressed loop is held to its compressed megastep
               within the loop-vs-megastep tolerances. The scanned
               half-selection run on the card and on the CPU from the same
               weights and draws: selections, integer control state, update
               counts and accept rates equal, the f32 accumulators, EMAs,
               accuracy and loss within ``parity``'s scanned tolerances (the
               update-norm EMA over the run within NORM_RUN_RTOL, and each
               round of the card's run replayed on the CPU from the card's
               carry before it within NORM_RTOL: ``grad_norm_gap``; every
               scanned card-vs-CPU line below does the same), the
               error feedback after round 0 within its EF tolerances; and the
               card's fused scanned run at 4 rounds per dispatch against 1,
               which must be equal.
  6. ops and spmd — the kernel-ops API (``sign_align_ratio``,
               ``per_client_sign_align_ratio``, ``masked_aggregate``,
               ``fused_selective_update``) on the anomaly-mlp parameter dict
               with 10 clients, card against CPU, each kernel launched once
               (``"phase": "ops"``); the quickstart spec on the spmd engine
               (``engine="spmd"``: ``fedavg``, ``cmfl``, ``acfl``, ``fedl2p``,
               ``cmfl`` + int8; ``"phase": "slice"``), the two ``cmfl`` runs
               against the CPU with an f32 aggregation (the card's kernel
               reduces in f32; the gap to the default bf16 CPU run is printed
               beside it; ``"phase": "card_vs_cpu"``), ``run_spmd_seed_batch``
               of ``fedavg`` without dropout at three seeds against solo runs
               (``"phase": "seed_batch"``), a trace of a warm ``cmfl`` + int8
               and ``fedavg`` spmd round and the host-time split of a warm
               ``cmfl`` + int8 round (``"phase": "round_breakdown"``).
  6b. scenario — the quickstart spec under the ``dynamic`` and the
               ``byzantine`` worlds (core/scenario.py) on four paths: ``ours``
               + int8 on the megastep, the per-client loop and the scanned
               path (4 rounds a dispatch, fused eval), and ``cmfl`` + int8 on
               the spmd engine, each beside the same run without a scenario
               (``"phase": "slice"``, wall s a round with and without beside
               the card's name and power limit, ``"phase":
               "scenario_overhead"``). Each scenario run against the CPU from
               the same weights (``"phase": "card_vs_cpu"``, by the rules of
               its path above, problems ``[]``); sign-align, masked-agg and
               the round trip (and the gather on the scanned path; the codec
               pair on the loop) launched at least as often as the run has
               rounds (sign-align once fewer on the megastep, which tests no
               θ in round 0; there masked-agg runs once a shape group in the
               rounds that apply an update), each run's launches a round
               printed;
               the byzantine client 0's every θ test below θ; the dynamic
               scanned run at 4 rounds per dispatch equal to 1
               (``"phase": "r4_vs_r1"``) and one of its dispatches under
               ``set_sync_debug_mode("error")``.
  6c. topology — hierarchical topologies (repro_torch/topology). The
               grouped ``per_client_sign_align`` (P references, client c
               against reference c // (C / P), one launch) against its
               plain version, counts equal, at P in {1, 2, 8} by clients a
               reference in {1, 2, 4, 8} by R in {54, 864}, each case's last
               group all zeros, and on every sign case; at P = 1 (C 16 × R
               54) the reference as (R, 1024) and as (1, R, 1024), counts
               equal, eager and device ms of each in five alternating turns;
               and the full-width sync's shape (8 pods into 2 regions, R 54)
               timed beside its bound and plain version (``"phase":
               "kernels"``). Then
               examples/hierarchical_federation.py's spec at full width
               (``anomaly-mlp``, 64 clients, pods [8, 2, 1], ``drift``, 16
               rounds, scanned R = 4): records equal by bits to the same run
               without the topology, the topology state equal by bits to a
               second run and to R = 1, one grouped sign-align launch a θ
               sync, its ``topology_summary()`` and wall s a round with and
               without beside nvidia-smi's name and power limit (``"phase":
               "topology_overhead"``), one of its dispatches under
               ``set_sync_debug_mode("error")``. Then the quickstart under
               ``two-tier-pods`` and ``edge-region-global`` on the paths of
               6b: records equal by bits to the run without a topology, and
               card against CPU (``"phase": "card_vs_cpu"``, the records by
               the rules of their path, the summaries by
               ``parity.topology_problems`` from each boundary's closest θ
               test, problems ``[]``; the control state after the run held
               as in 6b, on the scanned path also equal by bits to the card's
               run without the topology), and the phase's own seconds
               (``"phase": "topology_phase"``).
  6d. world scale — (a) benchmarks/fig3_scaling.py --population's cells:
               population-only rounds (``core/population.py``,
               ``build_population_round``: score, selection, synthetic
               observations, the control round update) at 1,000, 10,000,
               100,000 and 1,000,000 clients, cohort 64, ``candidate_frac``
               0.02 over 8 logical shards, from fig3_scaling's seeded state;
               ms a round single- and two-stage (CUDA events over 20 rounds
               after a warm-up), ``round_update_logical`` equal to
               ``round_update`` by bits over 3 rounds, the ``frac = 1.0``
               cohorts and state equal to single-stage by bits, a round of
               each under ``set_sync_debug_mode("error")``; at 1M card
               against CPU over 3 rounds with the same draws (cohorts and
               integer fields equal, f32 fields within ``parity.EMA_RTOL``,
               and whether equal by bits) (``"phase": "population"``).
               (b) Sign-align and masked-agg at C 64 × R 54 and the
               error-feedback round trip at 3,456 rows against their plain
               versions, timed (``"phase": "kernels"``); then a non-resident
               world at full width: ``ours`` + int8 on the megastep,
               100,000 clients of 256 samples, K 64, ``candidate_frac`` 0.02
               over 8 shards, 4 rounds (``"run": "ours+int8 lazy 100k"``:
               wall s a round, each kernel's launches a round, at least one
               of each from round 1 on, loaders resident within the pool's
               256, peak device memory, and the same spec at ``frac`` 1.0
               and None equal by bits). (c) Card against CPU, problems
               ``[]``: a 200-client lazy world (K 16, 256 samples,
               ``candidate_frac`` 0.5 over 4) on the megastep and the loop,
               two-stage selection (0.5 over 2) on the quickstart's
               half-selection scanned R = 4 and on a synchronous selecting
               spmd spec; the phase's seconds (``"phase":
               "population_phase"``).
  6e. sessions — ``ExperimentSession`` (api/session.py) on the card at
               the quickstart's full width, on four paths: ``ours`` + int8
               on the megastep (6 rounds, checkpointed after 3), fused on
               the scanned path at R = 4 (8 rounds, checkpointed after 2,
               inside a dispatch), ``cmfl`` + int8 on the spmd engine (6,
               after 3) and on the per-client loop (3, after 1). Each path
               checkpoints to a temporary directory, restores into a new
               session on the card and runs the rest: records, θ tests and
               final parameters equal by bits to one uninterrupted session;
               each kernel of the path launched at least once a resumed
               round (counted from 0 just before the restore; the gather
               once a round); the payload's bytes, its CUDA tensors (must
               be 0), and ms to checkpoint and to restore (the restore
               builds the world) (``"phase": "session"``). The megastep's
               and the spmd engine's card checkpoints restored with
               ``device="cpu"`` (spmd aggregating in f32) run one round,
               held to the card's same round by ``parity.record_mismatches``
               (``"phase": "card_vs_cpu"``, problems ``[]``). Whether
               ``msgpack`` is installed (if so, the checkpoint I/O's round
               trip of the weights on the card, equal by bits);
               ``run_experiment`` equal by bits to the simulation driven
               directly; a ``run_sweep`` of ``ours`` (its synchronous form)
               against ``fedavg`` on the spmd engine, 3 seeds of 4 rounds,
               with its ``report()``, the Mann-Whitney U and p and its wall
               seconds; the phase's seconds with the checkpoint costs
               beside nvidia-smi's name and power limit (``"phase":
               "session_phase"``).
  7. LM serving — ``flash_attention`` against its plain version on the card
               (``"phase": "kernels"``), each case through the kernel that
               ``route(dtype, hd)`` names and launched there once: qwen2-1.5b's
               prefill flattened (48, 2048, 128) and in its own layout (B 4,
               S 2048, H 12, K 2, hd 128) and with K = H = 12, bf16 causal; S
               512 against Sk 1024; hd 64 and 96; a window of 256 at S 1024
               (all bf16 at hd 64/96/128, so the wgmma kernel); f32 at (12,
               512, 32) causal and not, bf16 at hd 32 and the 2-layer f32
               run's (1, 512, 12, 2, 128) (the SIMT kernel); f32 within 1e-5,
               bf16 within one bf16 ulp plus 1e-5, each timed beside its
               bound, its plain version and ``scaled_dot_product_attention``,
               and at qwen2's prefill the SIMT kernel on the same inputs
               (``simt_ms``, ``simt_device_ms``), which the wgmma kernel must
               beat. Then ``serve_lm`` at
               qwen2-1.5b's full width (28 layers, random weights drawn on
               the card from seed 0) with ``attention_impl="blockwise"``,
               batch 4, a 2048-token prompt and 16 greedy tokens: exactly one
               wgmma kernel launch per layer in the prefill and none in the
               decode (``"phase": "slice"``); the same with ``"full"`` attention (no
               launch), its gap to the blockwise run printed; a 2-layer f32
               qwen2-1.5b, card (kernel) against CPU (plain), prefill and
               four teacher-forced decode steps within 1e-4 of max|logit|,
               its two launches on the SIMT kernel (``"phase":
               "card_vs_cpu"``); and a traced warm blockwise prefill
               (``"phase": "trace"``, with the wgmma kernel's share).

Then the ``kernels`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It needs a CUDA device and the repository
around it.

    python3 chip_smoke.py --sign-eager

times only the sign-align wrappers' eager calls (``sign_eager``), and

    python3 chip_smoke.py --lazy-world

only the 100,000-client non-resident world's four timed rounds of 6d (b)
with its peak device memory (``"phase": "lazy_world"``): run a copy of the
script from another checkout's root to compare that checkout with this one
in the same call; and

    python3 chip_smoke.py --session

only the session phase (6e), after the build.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
import pickle
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet) for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # non-tensor-core f32 (and int32 ALU) rate
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core rate

MAIN_SHAPE = (16, 54)          # 10 clients padded to 16; 54,602 params
RAGGED_SHAPE = (5, 7)
QUANT_ROWS = (16 * 54, 54, 35)  # cohort folded, one client, ragged
# and the last row count of the codec's 512-thread launch and the first of
# its 256-thread one (csrc/quantize.cu, kWideRows)
CODEC_CHECK_ROWS = QUANT_ROWS + (432, 433)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def quickstart_spec(T, strategy: str, quantize: bool = False,
                    megastep: bool = True, **strategy_kwargs):
    """examples/quickstart.py's spec, at full width."""
    return T.ExperimentSpec(
        model="anomaly-mlp",
        data=T.DataSpec(n_samples=20000, eval_samples=4000, alpha=0.5),
        world=T.WorldSpec(num_clients=10, dropout_p=0.1),
        comm=T.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                         t_launch=0.25),
        strategy=strategy,
        strategy_kwargs=dict(batch_size=64, lr=3e-2, local_epochs=2,
                             quantize_updates=quantize, **strategy_kwargs),
        rounds=8, seed=0, megastep=megastep)


def kernel_inputs(C: int, R: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((C, R, 1024), generator=g, device="cuda")
    u[:, :, :16] = 0.0
    u[:, :, 16:32] = -0.0
    r = torch.randint(-1, 2, (R, 1024), generator=g, device="cuda",
                      dtype=torch.int8)
    r[-1, -200:] = -2                  # padding sentinel
    u[:, -1, -200:] = 0.0
    w = torch.randn((C,), generator=g, device="cuda")
    return u, r, w


def quant_inputs(R: int, seed: int = 0) -> torch.Tensor:
    """(R, 1024) f32 rows of widely spread magnitudes, then the special
    rows: all zero, ±0, exact ties (amax 127, so the scale is exactly 1,
    and ±(k + 0.5)), magnitudes near 1e30 and a subnormal row. Made on
    the CPU, where nothing flushes subnormals, then moved to the card."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((R, 1024), generator=g)
         * torch.exp(3.0 * torch.randn((R, 1), generator=g)))
    x[0] = 0.0
    x[1, ::2], x[1, 1::2] = 0.0, -0.0
    x[2] = torch.arange(1024) % 254 - 126.5
    x[2, 0], x[2, 1] = 127.0, -127.0
    x[3] = torch.randn(1024, generator=g) * 1e30
    x[4] = torch.randn(1024, generator=g) * 1e-40
    return x.cuda()


def gather_inputs(N: int, R: int, seed: int = 0,
                  special: bool = False) -> torch.Tensor:
    """(N, R, 1024) f32 slabs with -0.0 lanes; ``special`` adds NaN (one
    with a payload), +-Inf and subnormal values. Made on the CPU, where
    nothing flushes subnormals, then moved to the card."""
    g = torch.Generator().manual_seed(seed)
    src = torch.randn((N, R, 1024), generator=g)
    src[:, :, :8] = -0.0
    if special:
        src[1, 0, 8] = math.nan
        src.view(torch.int32)[1, 0, 9] = 0x7FC01234
        src[2, -1, 10], src[2, -1, 11] = math.inf, -math.inf
        src[3, 0, 12], src[3, 0, 13] = 1e-45, -1e-40
    return src.cuda()


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call over back-to-back calls, by CUDA events: what a
    caller on the stream pays per call, enqueue included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, per_graph: int = 50, replays: int = 20) -> float:
    """Mean ms per call with the calls captured in a CUDA graph: device
    time, without the host's enqueue cost."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def host_us(pieces: dict, n: int = 1000, warmup: int = 100) -> dict:
    """Host microseconds per call of each piece of one wrapper call, and
    of the whole call (``"call"``): each timed alone by
    ``time.perf_counter_ns`` over ``n`` calls after ``warmup``, with the
    card idle before each."""
    out = {}
    for name, fn in pieces.items():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter_ns() - t0) / n / 1e3
        torch.cuda.synchronize()
    return out


def split_inputs():
    """The inputs at which a wrapper call's host time is split: 864 rows
    of the codec (the cohort folded) and 10 of 11 slabs of 54 rows."""
    x = quant_inputs(QUANT_ROWS[0], seed=1)
    q = torch.randint(-127, 128, x.shape, dtype=torch.int8, device="cuda")
    s = torch.rand((x.shape[0], 1), device="cuda")
    return x, q, s, gather_inputs(11, 54, seed=1), torch.arange(
        10, device="cuda")


def launch_pieces(quantize, gather, launch, x, q, s, src, idx) -> dict:
    """The pieces of each wrapper call on the shared launch path
    (``kernels/_launch.py``), as the wrappers take them, for ``host_us``."""
    dev, R = x.get_device(), x.shape[0]
    N, Rg, _ = src.shape
    K = idx.shape[0]
    fns = {k: launch.entries[k] for k in launch.ENTRY_POINTS}
    stream = launch.stream(dev)
    ptr = launch.aligned_pointer
    px, pq, ps, psrc, pidx = (t.data_ptr() for t in (x, q, s, src, idx))
    q_out, s_out = torch.empty_like(q), torch.empty_like(s)
    d_out, g_out = torch.empty_like(x), src.new_empty((K, Rg, 1024))

    def g_checks():
        gather.check_args(src, idx)
        ptr("cohort_gather", src)
        idx.is_contiguous()

    def g_alloc():
        N, R, _ = src.shape
        K = idx.numel()
        return src.new_empty(K, R, 1024)

    def lookup(name):
        return lambda: launch.entries[name]

    return {
        "quantize_q8": dict(
            checks=lambda: (quantize.check_quantize(x),
                            ptr("quantize_q8", x)),
            lookup=lookup("quantize_q8"), stream=lambda: launch.stream(dev),
            alloc=lambda: (torch.empty_like(x, dtype=torch.int8),
                           x.new_empty(x.shape[0], 1)),
            c_call=lambda: fns["quantize_q8"](
                px, q_out.data_ptr(), s_out.data_ptr(), R, stream),
            call=lambda: quantize.quantize_q8(x)),
        "dequantize_q8": dict(
            checks=lambda: (quantize.check_dequantize(q, s),
                            ptr("dequantize_q8", q), ptr("dequantize_q8", s)),
            lookup=lookup("dequantize_q8"), stream=lambda: launch.stream(dev),
            alloc=lambda: torch.empty_like(q, dtype=torch.float32),
            c_call=lambda: fns["dequantize_q8"](
                pq, ps, d_out.data_ptr(), R, stream),
            call=lambda: quantize.dequantize_q8(q, s)),
        "cohort_gather": dict(
            checks=g_checks, lookup=lookup("cohort_gather"),
            stream=lambda: launch.stream(dev), alloc=g_alloc,
            c_call=lambda: fns["cohort_gather"](
                psrc, pidx, g_out.data_ptr(), N, Rg, K, stream),
            call=lambda: gather.cohort_gather(src, idx)),
    }


def library_calls(x, q, s, src, idx) -> dict:
    """The one PyTorch call that computes each launch-path wrapper's
    function, where there is one, at ``split_inputs()``."""
    return {"dequantize_q8": lambda: torch.mul(q, s),
            "cohort_gather": lambda: torch.index_select(src, 0, idx)}


def turns(name: str, pieces: dict, library: dict, order) -> dict:
    """Time one wrapper in turns: for each entry of ``order``, a key of
    ``pieces`` (a version of the wrapper, its pieces as ``launch_pieces``
    gives them) or ``"library"``, the split of one call's host time
    (``host_us``) and the call's eager ms. The host's speed drifts by
    tens of percent within a run, so versions are compared only over
    turns that alternate. Returns {version: {"host_us": [...], "ms":
    [...]}}, one entry a turn."""
    out = {}
    for who in order:
        if who == "library":
            if name not in library:
                continue
            fns = {"call": library[name]}
        else:
            fns = pieces[who][name]
        runs = out.setdefault(who, {"host_us": [], "ms": []})
        runs["host_us"].append(host_us(fns))
        runs["ms"].append(time_ms(fns["call"]))
    return out


def host_split(names, launch, quantize, gather, **shape) -> None:
    """One ``kernels`` line per named wrapper: the split of one call's
    host time by piece (``host_us``, µs, the median over five turns;
    ``call`` is the whole wrapper call, timed the same way) at
    ``split_inputs()``, and the call's eager ms beside its library
    call's, each turn's and their medians, in turns of this wrapper,
    library, library, this wrapper."""
    inputs = split_inputs()
    pieces = {"this": launch_pieces(quantize, gather, launch, *inputs)}
    library = library_calls(*inputs)
    for name in names:
        runs = turns(name, pieces, library, ["this", "library", "library",
                                             "this"] * 5)
        this, lib = runs["this"], runs.get("library")
        emit("kernels", name=name, wrapper="this", **shape,
             host_us={k: float(np.median([r[k] for r in this["host_us"]]))
                      for k in this["host_us"][0]},
             ms=this["ms"], ms_median=float(np.median(this["ms"])),
             library_ms=lib and lib["ms"],
             library_ms_median=lib and float(np.median(lib["ms"])))


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


AGG_GRID = ([(C, R) for C in (1, 7, 8, 9, 16, 17, 40)
             for R in (1, 54, 257)] + [(4, 4096)]
            + [(C, R) for C in (257, 300) for R in (1, 54)])   # (C, R)


DEVICE_OPS = ("kernel", "gpu_memset", "gpu_memcpy")   # trace categories


def launch_design(fn, kernel: str, calls: int = 3, sessions: int = 3,
                  template_arg: str = "clients_per_chunk") -> dict:
    """``torch.profiler`` over ``calls`` calls of ``fn``: the launches of
    the kernel whose name holds ``kernel``, as the trace records them:
    threads a block, blocks, registers a thread, the cluster's dimensions
    where the trace carries them (else None), and the kernel's first
    template argument, where its name carries one, under ``template_arg``
    (the clients a chunk; the codec kernels' values a thread).
    A session whose trace holds none of them, or fewer device operations
    than calls (the profiler can drop an event), is tried again, up to
    ``sessions`` times; the launches must agree, and each call of ``fn``
    must be exactly one device operation (kernel, memset or memcpy)."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        mine = [e for e in events
                if e.get("cat") == "kernel" and kernel in e.get("name", "")]
        ops = [e for e in events if e.get("cat") in DEVICE_OPS]
        if mine and len(ops) >= calls:
            break
        seen.append((len(ops), sorted({(e.get("cat"), e.get("name", "")[:60])
                                       for e in events
                                       if e.get("ph") == "X"})[:8]))
    else:
        raise AssertionError(f"no trace of {calls} calls holding a launch "
                             f"of {kernel} and a device operation a call "
                             f"in {sessions} sessions; they held (device "
                             f"operations, events) {seen}")
    if len(ops) != calls:
        raise AssertionError(
            f"{calls} calls around {kernel} made {len(ops)} device "
            f"operations, not one each: "
            f"{sorted({(e['cat'], e['name'][:60]) for e in ops})}")
    found = {(e["name"], tuple(e["args"]["grid"]), tuple(e["args"]["block"]),
              e["args"].get("registers per thread"),
              tuple(sorted((k, str(v)) for k, v in e["args"].items()
                           if "cluster" in k.lower()))) for e in mine}
    if len(found) != 1:
        raise AssertionError(f"launches of {kernel} differ: {found}")
    (name, grid, block, regs, cluster), = found
    chunk = re.search(re.escape(kernel) + r"<(\d+)", name)
    design = dict(kernel=name[:120], threads_per_block=math.prod(block),
                  blocks=math.prod(grid), registers_per_thread=regs,
                  cluster=dict(cluster) or None,
                  device_ops_per_call=len(ops) / calls,
                  traced_launches=len(mine), sessions=len(seen) + 1)
    if chunk:
        design[template_arg] = int(chunk.group(1))
    return design


def off_finite_agree(got, want) -> bool:
    """``got`` and ``want`` are NaN at the same positions, and ±Inf at the
    same positions with the same signs."""
    g, w = got.float(), want.float()
    return torch.equal(torch.isnan(g), torch.isnan(w)) and torch.equal(
        torch.where(torch.isinf(g), g, 0.0),
        torch.where(torch.isinf(w), w, 0.0))


def finite_max(gap, got, want) -> float:
    """The largest ``gap`` where ``want`` is finite; +inf unless ``got`` and
    ``want`` agree off the finite positions (``off_finite_agree``)."""
    if not off_finite_agree(got, want):
        return math.inf
    return float(torch.where(torch.isfinite(want.float()), gap,
                             -math.inf).max())


def agg_excess(got, want, u, w) -> float:
    """Largest excess of |got − want| over 1e-6 of Σ_c|w_c·u_c| (≤ 0
    passes), over the positions where the plain version is finite."""
    scale = (u * w[:, None, None]).abs().sum(dim=0)
    return finite_max((got - want).abs() - 1e-6 * scale, got, want)


def with_inf(u, w):
    """Inf and -Inf in the row of a client whose weight is 0: its terms
    0·Inf are NaN in the kernel and in the plain version alike."""
    u, w = u.clone(), w.clone()
    w[1] = 0.0
    u[1, 0, 5] = math.inf
    u[1, -1, 700] = -math.inf
    return u, w


def held_agg(masked_agg, ref, u, w, where: str) -> tuple:
    """masked_agg and its plain version on (u, w); raises when they differ
    beyond ``agg_excess``'s tolerance. Returns (kernel, plain, excess)."""
    got, want = masked_agg.masked_agg(u, w), ref.masked_agg(u, w)
    torch.cuda.synchronize()
    excess = agg_excess(got, want, u, w)
    if not excess <= 0.0:
        raise AssertionError(f"masked_agg differs from its plain version "
                             f"beyond rtol 1e-6 of sum|w*u| at {where} "
                             f"(excess {excess})")
    return got, want, excess


def has_nans(where: str, want) -> int:
    """The count of NaNs in the plain version's output, which must hold
    some (the NaN masks themselves are compared by ``finite_max``)."""
    nans = int(torch.isnan(want.float()).sum())
    if nans == 0:
        raise AssertionError(f"{where}: the plain version gave no NaN")
    return nans


def empty_rows(fn, want_shape, want_dtype) -> list:
    """``fn`` at R = 0 rows on the card: an empty result of the expected
    shape and dtype, and no fault (the synchronisation would raise it)."""
    got = fn()
    torch.cuda.synchronize()
    if tuple(got.shape) != want_shape or got.dtype != want_dtype:
        raise AssertionError(f"R = 0 gave {tuple(got.shape)} {got.dtype}")
    return list(got.shape)


def agg_grid(masked_agg, ref) -> float:
    """Hold masked_agg to its plain version at every (C, R) of AGG_GRID,
    within 1e-6 of Σ_c|w_c·u_c|, on the main shape with Inf in a
    zero-weight client's row (NaN at the same positions), and at R = 0;
    returns the largest |kernel − plain| over the finite outputs."""
    err, worst = 0.0, -math.inf
    for C, R in AGG_GRID:
        u, _, w = kernel_inputs(C, R, seed=C * 1000 + R)
        got, want, excess = held_agg(masked_agg, ref, u, w, f"C={C}, R={R}")
        err, worst = max(err, float((got - want).abs().max())), max(worst,
                                                                     excess)
    u, w = with_inf(*kernel_inputs(*MAIN_SHAPE, seed=7)[::2])
    got, want, excess = held_agg(masked_agg, ref, u, w,
                                 "Inf in a zero-weight row")
    nans = has_nans("masked_agg with Inf in a zero-weight row", want)
    empty = empty_rows(lambda: masked_agg.masked_agg(
        torch.zeros((16, 0, 1024), device="cuda"),
        torch.ones(16, device="cuda")), (0, 1024), torch.float32)
    emit("kernels", name="masked_agg", grid=[list(s) for s in AGG_GRID],
         worst_excess=worst, max_abs_err=err, non_finite=dict(
             shape=list(MAIN_SHAPE), nan_positions=nans, same_nans=True,
             excess=excess), empty=dict(shape=[16, 0], out_shape=empty))
    return err


# (C, R) at which per_client_sign_align is held to its plain version: the
# kernel takes clusters of k blocks a client, k = min(8, ceil(132 / C), R)
# (R·256 float4s, 256 threads a block, at least 1), so these C reach every
# k from 8 down to 1 at R = 54 (16 and 17: 8, 20: 7, 24: 6, 27: 5, 40: 4,
# 44: 3, 66: 2, 132 and 257: 1), R = 7 caps k at 7, R = 1 at 1, and R = 0
# writes C zeros and loads nothing
SIGN_GRID = ([(C, R) for C in (1, 7, 8, 9, 16, 17, 20, 24, 27, 40, 44, 66,
                               132, 257) for R in (0, 1, 7, 54)]
             + [(16, 864)])
# every sign case as f32 bits: ±0, NaN (and negative ones with payloads),
# ±Inf, ±1, the smallest and largest f32 subnormals, and the smallest and
# largest bf16 subnormals; those whose low 16 bits are 0 are bf16 values
SIGN_CASES_F32 = (0x00000000, 0x80000000, 0x7FC00000, 0xFFC01234, 0xFFC10000,
                  0x7F800000, 0xFF800000, 0x3F800000, 0xBF800000, 0x00000001,
                  0x80000001, 0x007FFFFF, 0x807FFFFF, 0x00010000, 0x80010000,
                  0x007F0000, 0x807F0000)


def sign_cases(dtype, rows: int = 3, seed: int = 0):
    """(x, r) on the CPU: x (rows, 1024) in ``dtype`` whose first row puts
    every value of SIGN_CASES_F32 (for bf16 those that are bf16 values,
    bit for bit) against every reference sign -2, -1, 0 and 1; the other
    rows random, the last row's tail 0 against the -2 padding. Made on
    the CPU, where nothing flushes subnormals."""
    g = torch.Generator().manual_seed(seed)
    bits = torch.tensor(SIGN_CASES_F32, dtype=torch.int64).to(torch.int32)
    if dtype == torch.bfloat16:
        values = (bits[(bits & 0xFFFF) == 0] >> 16).to(torch.int16).view(dtype)
    else:
        values = bits.view(torch.float32)
    x = torch.randn((rows, 1024), generator=g).to(dtype)
    r = torch.randint(-1, 2, (rows, 1024), generator=g, dtype=torch.int8)
    lanes = torch.arange(1024)
    x[0] = values[lanes % len(values)]
    r[0] = torch.tensor([-2, -1, 0, 1], dtype=torch.int8)[
        (lanes // len(values)) % 4]
    x[-1, -200:], r[-1, -200:] = 0.0, -2
    return x, r


def held_counts(fn, plain, x, r, where: str) -> tuple:
    """A sign-count kernel ``fn`` and its plain version on (x, r): f32
    counts of the plain version's shape on x's device, equal. Returns
    the kernel's counts and the largest |kernel − plain|."""
    got, want = fn(x, r), plain(x, r)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != want.shape or \
            got.device != x.device or not torch.equal(got, want):
        raise AssertionError(f"sign counts differ from the plain version at "
                             f"{where}: {got} vs {want}")
    return got, float((got - want).abs().max())


def sign_grid(sign_align, ref) -> float:
    """Hold per_client_sign_align to its plain version, equal, at every
    (C, R) of SIGN_GRID (at R = 0 the plain version's C zeros) and on
    every sign case (``sign_cases``, each client's first row rolled by its
    index), where the plain version on the CPU copy must agree too (the
    card's could flush subnormals as a kernel might); returns the largest
    |kernel − plain|."""
    err = 0.0
    for C, R in SIGN_GRID:
        if R == 0:
            u = torch.zeros((C, 0, 1024), device="cuda")
            r = torch.zeros((0, 1024), dtype=torch.int8, device="cuda")
        else:
            u, r, _ = kernel_inputs(C, R, seed=C * 1000 + R)
        _, e = held_counts(sign_align.per_client_sign_align,
                           ref.per_client_sign_align, u, r, f"C={C}, R={R}")
        err = max(err, e)
    x, r = sign_cases(torch.float32)
    u = torch.stack([x.roll(c, dims=1) for c in range(3)])
    got, e = held_counts(sign_align.per_client_sign_align,
                         ref.per_client_sign_align, u.cuda(), r.cuda(),
                         "every sign case")
    if not torch.equal(got.cpu(), ref.per_client_sign_align(u, r)):
        raise AssertionError("the plain version on the card and on the CPU "
                             "differ on the sign cases")
    emit("kernels", name="per_client_sign_align",
         grid=[list(s) for s in SIGN_GRID], equal=True,
         sign_cases=dict(values=len(SIGN_CASES_F32), counts=got.tolist()))
    return max(err, e)


def phase_kernels(sign_align, masked_agg, ref) -> dict:
    """Hold each kernel to its plain version; time both at the main shape."""
    sa_err = ma_err = 0.0
    for C, R in (RAGGED_SHAPE, MAIN_SHAPE):
        u, r, w = kernel_inputs(C, R)
        _, e = held_counts(sign_align.per_client_sign_align,
                           ref.per_client_sign_align, u, r, f"C={C}, R={R}")
        sa_err = max(sa_err, e)
        got, want, _ = held_agg(masked_agg, ref, u, w, f"C={C}, R={R}")
        ma_err = max(ma_err, float((got - want).abs().max()))
        emit("kernels", shape=[C, R], sign_align="equal",
             masked_agg_max_abs_err=float((got - want).abs().max()))

    sa_err = max(sa_err, sign_grid(sign_align, ref))
    ma_err = max(ma_err, agg_grid(masked_agg, ref))

    C, R = MAIN_SHAPE
    u, r, w = kernel_inputs(C, R, seed=1)
    n = R * 1024
    sa_bound = bound_ms(C * n * 4 + n + C * 4, 2 * C * n)
    ma_bound = bound_ms(C * n * 4 + C * 4 + n * 4, 2 * C * n)
    rows = {
        "per_client_sign_align": dict(
            route="cuda", source="src/repro_torch/csrc/sign_align.cu",
            replaces="src/repro/kernels/sign_align.py:64",
            max_abs_err=sa_err,
            ms=time_ms(lambda: sign_align.per_client_sign_align(u, r)),
            device_ms=graph_ms(lambda: sign_align.per_client_sign_align(u, r)),
            plain_ms=time_ms(lambda: ref.per_client_sign_align(u, r)),
            bound_ms=sa_bound[0], bound_by=sa_bound[1], library_ms=None,
            library_device_ms=None,
            design=launch_design(
                lambda: sign_align.per_client_sign_align(u, r),
                "sign_align_kernel")),
        "masked_agg": dict(
            route="cuda", source="src/repro_torch/csrc/masked_agg.cu",
            replaces="src/repro/kernels/masked_agg.py:37",
            max_abs_err=ma_err,
            ms=time_ms(lambda: masked_agg.masked_agg(u, w)),
            device_ms=graph_ms(lambda: masked_agg.masked_agg(u, w)),
            plain_ms=time_ms(lambda: ref.masked_agg(u, w)),
            bound_ms=ma_bound[0], bound_by=ma_bound[1],
            library_ms=time_ms(lambda: torch.einsum("crl,c->rl", u, w)),
            library_device_ms=graph_ms(
                lambda: torch.einsum("crl,c->rl", u, w)),
            design=launch_design(lambda: masked_agg.masked_agg(u, w),
                                 "masked_agg_kernel")),
    }
    for name, row in rows.items():
        emit("kernels", name=name, shape=[C, R],
             **{k: v for k, v in row.items()
                if k.endswith("ms") or k == "design"})
    return rows


def phase_quantize(quantize, gather, launch, ref) -> dict:
    """Hold the int8 codec kernels and the error-feedback round trip to
    their plain versions, bit for bit, on both sides of the round trip's
    and ``quantize_q8``'s switch of launch shape; time the two at every
    row count the main paths give them (``CODEC_SIZES``), ``dequantize_q8``
    at the cohort-folded 864."""
    q_err = d_err = 0.0
    for R in CODEC_CHECK_ROWS:
        x = quant_inputs(R, seed=R)
        q, s = quantize.quantize_q8(x)
        q_ref, s_ref = ref.quantize_q8(x)
        d = quantize.dequantize_q8(q, s)
        d_ref = ref.dequantize_q8(q, s)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
            raise AssertionError(
                f"quantize_q8 differs from its plain version at R={R}: "
                f"{int((q != q_ref).sum())} codes, "
                f"{int((s != s_ref).sum())} scales")
        if not torch.equal(d, d_ref):
            raise AssertionError(f"dequantize_q8 differs from its plain "
                                 f"version at R={R}")
        q_err = max(q_err, float((q.float() - q_ref.float()).abs().max()),
                    float((s - s_ref).abs().max()))
        d_err = max(d_err, float((d - d_ref).abs().max()))
        if q[:2].any() or q[4].any() or s[2, 0] != 1.0 or not torch.equal(
                q[2].float(), torch.round(x[2])):
            raise AssertionError(f"special rows coded wrongly at R={R}")
        emit("kernels", rows=R, quantize_q8="equal", dequantize_q8="equal")

    ef_err = round_trip_cases(quantize, ref)

    R = QUANT_ROWS[0]
    x = quant_inputs(R, seed=1)
    q, s = quantize.quantize_q8(x)
    # why the plain version divides by a tensor: PyTorch's CUDA division
    # by a Python number multiplies by its reciprocal
    amax = x.abs().amax(dim=-1, keepdim=True)
    emit("kernels", rows=R, scales_off_when_divided_by_a_number=int(
        (amax / 127.0 != amax / amax.new_full((), 127.0)).sum()))
    sized = {R_: codec_rows(quantize, ref, R_) for R_ in CODEC_SIZES}
    for R_, pair in sized.items():
        for name, row in pair.items():
            emit("kernels", name=name, rows=R_,
                 **{k: v for k, v in row.items()
                    if k.endswith("ms") or k == "design"})
    # each kernel at its main path's shape: the per-client loop codes and
    # restores one client at a time (54 rows); 25 of the int8 megastep's 44
    # round trips fold a one-client group (54 rows), the rest 108 to 432
    R = QUANT_ROWS[1]
    q, s = quantize.quantize_q8(quant_inputs(R, seed=1))
    n = R * 1024
    d_bound = bound_ms(5 * n + 4 * R, n)
    rows = {
        "quantize_q8": dict(
            route="cuda", source="src/repro_torch/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:34", max_abs_err=q_err,
            rows=R, **sized[R]["quantize_q8"],
            # torch.quantize_per_channel takes the scales as an input and
            # codes to -128..127: no one-call equivalent
            library_ms=None, library_device_ms=None),
        "ef_round_trip": dict(
            route="cuda", source="src/repro_torch/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:34", max_abs_err=ef_err,
            rows=R, **sized[R]["ef_round_trip"],
            # no one PyTorch call quantizes and restores; the yardstick is
            # the four operations the main paths ran before, on the kernels
            library_ms=None, library_device_ms=None),
        "dequantize_q8": dict(
            route="cuda", source="src/repro_torch/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:58", max_abs_err=d_err,
            rows=R, ms=time_ms(lambda: quantize.dequantize_q8(q, s)),
            device_ms=graph_ms(lambda: quantize.dequantize_q8(q, s)),
            plain_ms=time_ms(lambda: ref.dequantize_q8(q, s)),
            bound_ms=d_bound[0], bound_by=d_bound[1],
            library_ms=time_ms(lambda: torch.mul(q, s)),
            library_device_ms=graph_ms(lambda: torch.mul(q, s))),
    }
    emit("kernels", name="dequantize_q8", rows=R,
         **{k: v for k, v in rows["dequantize_q8"].items()
            if k.endswith("ms")})
    host_split(["quantize_q8", "dequantize_q8"], launch, quantize, gather,
               rows=QUANT_ROWS[0])
    return rows


# the rows the quickstart's int8 paths give the codec kernels (54 rows a
# client, 10 clients): the loop's 54, the megastep's groups padded to 1, 2,
# 4 or 8 clients, the scanned and spmd cohorts of 5 or 10 folded; and a
# 16-client cohort, the shape earlier measurements used. Both launch shapes
# of csrc/quantize.cu (512 threads a row up to 432 rows, 256 beyond)
CODEC_SIZES = (54, 108, 216, 270, 432, 540, 864)


def codec_rows(quantize, ref, R: int) -> dict:
    """``quantize_q8`` and ``ef_round_trip`` timed at R rows: eager and
    device ms, the plain version's ms, the bound, the launch as the trace
    records it, and for the round trip the four operations it replaces
    (``today_ms``, ``today_device_ms``)."""
    x = quant_inputs(R, seed=1)
    d, e = ef_inputs(R, seed=1, e_kind="random")
    n = R * 1024
    # bytes: f32 in and int8 out plus one f32 scale per row; operations:
    # |x|, max, divide, round, clamp. The round trip: d and e read,
    # restored and residual written (f32); an add, the five of quantize,
    # a multiply and a subtract
    q_bound = bound_ms(5 * n + 4 * R, 5 * n)
    ef_bound = bound_ms(16 * n, 8 * n)

    def four_ops():
        c = d + e
        restored = quantize.dequantize_q8(*quantize.quantize_q8(c))
        return restored, c - restored

    return {
        "quantize_q8": dict(
            ms=time_ms(lambda: quantize.quantize_q8(x)),
            device_ms=graph_ms(lambda: quantize.quantize_q8(x)),
            plain_ms=time_ms(lambda: ref.quantize_q8(x)),
            bound_ms=q_bound[0], bound_by=q_bound[1],
            design=launch_design(lambda: quantize.quantize_q8(x),
                                 "quantize_q8_kernel",
                                 template_arg="values_per_thread")),
        "ef_round_trip": dict(
            ms=time_ms(lambda: quantize.ef_round_trip(d, e)),
            device_ms=graph_ms(lambda: quantize.ef_round_trip(d, e)),
            plain_ms=time_ms(lambda: ref.ef_round_trip(d, e)),
            bound_ms=ef_bound[0], bound_by=ef_bound[1],
            today_ms=time_ms(four_ops), today_device_ms=graph_ms(four_ops),
            design=launch_design(lambda: quantize.ef_round_trip(d, e),
                                 "ef_round_trip_kernel",
                                 template_arg="values_per_thread")),
    }


def ef_inputs(R: int, seed: int, e_kind: str):
    """(d, e) (R, 1024) f32 on the card: d from ``quant_inputs`` (its
    special rows included), e zero or random at a thousandth of each
    row's largest |d| (subnormal on the subnormal row). Made on the CPU."""
    d = quant_inputs(R, seed=seed)
    if e_kind == "zero":
        return d, torch.zeros_like(d)
    g = torch.Generator().manual_seed(seed + 7)
    e = (torch.randn((R, 1024), generator=g)
         * d.cpu().abs().amax(dim=-1, keepdim=True) * 1e-3)
    return d, e.cuda()


def round_trip_cases(quantize, ref) -> float:
    """Hold ef_round_trip to its plain version (the add, the codec's two
    halves and the subtract) at every CODEC_CHECK_ROWS with a zero and a
    random e, ``restored`` and ``residual`` equal by bits; returns the
    largest |kernel − plain| (0)."""
    err = 0.0
    for R in CODEC_CHECK_ROWS:
        for e_kind in ("zero", "random"):
            d, e = ef_inputs(R, seed=R, e_kind=e_kind)
            got = quantize.ef_round_trip(d, e)
            want = ref.ef_round_trip(d, e)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("restored", "residual")):
                if g.shape != w.shape or not torch.equal(
                        g.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(
                        f"ef_round_trip {what} differs from its plain "
                        f"version at R={R}, e {e_kind}: "
                        f"{int((g != w).sum())} elements")
                err = max(err, float((g - w).abs().max()))
            emit("kernels", rows=R, e=e_kind, ef_round_trip="equal by bits")
    return err


def phase_gather(quantize, gather, launch, ref) -> dict:
    """Hold the cohort gather to its plain version, bit for bit; time both
    at the error-feedback arena's shape with all ten clients."""
    cases = ((11, 54, list(range(10))), (11, 54, [10, 3, 7, 0, 5]),
             (7, 3, [6, 1, 2, 3, 1]))
    for N, R, ids in cases:
        src = gather_inputs(N, R, seed=N * R, special=N == 7)
        idx = torch.tensor(ids, dtype=torch.int64, device="cuda")
        got = gather.cohort_gather(src, idx)
        want = ref.cohort_gather(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(
                f"cohort_gather differs from its plain version at N={N}, "
                f"R={R}, idx={ids}: {bad} elements")
        emit("kernels", slabs=[N, R], idx=ids, cohort_gather="equal by bits")

    N, R, ids = cases[0]
    src = gather_inputs(N, R, seed=1)
    idx = torch.tensor(ids, dtype=torch.int64, device="cuda")
    K = len(ids)
    # bytes: each gathered slab read once and written once, the indices
    # read once; no arithmetic
    bound = bound_ms(2 * K * R * 4096 + 8 * K, 0)
    row = dict(
        route="cuda", source="src/repro_torch/csrc/gather.cu",
        replaces="src/repro/kernels/gather.py:45", max_abs_err=0.0,
        ms=time_ms(lambda: gather.cohort_gather(src, idx)),
        device_ms=graph_ms(lambda: gather.cohort_gather(src, idx)),
        plain_ms=time_ms(lambda: ref.cohort_gather(src, idx)),
        bound_ms=bound[0], bound_by=bound[1],
        library_ms=time_ms(lambda: torch.index_select(src, 0, idx)),
        library_device_ms=graph_ms(lambda: torch.index_select(src, 0, idx)))
    emit("kernels", name="cohort_gather", slabs=[N, R], k=K,
         **{k: v for k, v in row.items() if k.endswith("ms")})
    host_split(["cohort_gather"], launch, quantize, gather, slabs=[N, R],
               k=K)
    return {"cohort_gather": row}


def phase_launch(quantize, gather, masked_agg, sign_align, launch) -> None:
    """The shared launch path on the card: the stream it launches on is
    PyTorch's current one, on the default stream, under
    ``torch.cuda.stream(side)`` and during a graph's capture; and the
    codec and gather wrappers each refuse a non-contiguous and a
    misaligned input with ``ValueError``, the aggregation and sign-count
    wrappers one of the two each, launching nothing."""
    dev = torch.cuda.current_device()
    streams = {"default": (launch.stream(dev),
                           torch.cuda.current_stream().cuda_stream)}
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        streams["side"] = (launch.stream(dev),
                           torch.cuda.current_stream().cuda_stream)
    if streams["side"][1] != side.cuda_stream:
        raise AssertionError("torch.cuda.stream(side) did not make side "
                             "current")
    x = torch.zeros((4, 1024), device="cuda")
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            streams["capture"] = (launch.stream(dev),
                                  torch.cuda.current_stream().cuda_stream)
            quantize.quantize_q8(x)
    torch.cuda.current_stream().wait_stream(side)
    wrong = {k: v for k, v in streams.items() if v[0] != v[1]}
    if wrong:
        raise AssertionError(f"the launch path's stream is not the current "
                             f"one: {wrong}")

    def misaligned(shape, dtype):
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        buf = torch.empty(nbytes + 16, dtype=torch.uint8, device="cuda")
        return buf[4:4 + nbytes].view(dtype).view(shape)

    R = 54
    x = torch.randn((R, 1024), device="cuda")
    q, s = quantize.quantize_q8(x)
    src = torch.randn((11, R, 1024), device="cuda")
    idx = torch.arange(10, device="cuda")
    cases = {
        "quantize_q8 non-contiguous": lambda: quantize.quantize_q8(
            torch.zeros((R, 2048), device="cuda")[:, ::2]),
        "quantize_q8 misaligned": lambda: quantize.quantize_q8(
            misaligned((R, 1024), torch.float32)),
        "dequantize_q8 non-contiguous": lambda: quantize.dequantize_q8(
            torch.zeros((R, 2048), dtype=torch.int8, device="cuda")[:, ::2],
            s),
        "dequantize_q8 misaligned": lambda: quantize.dequantize_q8(
            misaligned((R, 1024), torch.int8), s),
        "cohort_gather non-contiguous": lambda: gather.cohort_gather(
            torch.zeros((11, R, 2048), device="cuda")[..., ::2], idx),
        "cohort_gather misaligned": lambda: gather.cohort_gather(
            misaligned((11, R, 1024), torch.float32), idx),
        "masked_agg misaligned": lambda: masked_agg.masked_agg(
            misaligned((10, R, 1024), torch.float32), idx.float()),
        "fused_update non-contiguous": lambda: masked_agg.fused_update(
            x.t().contiguous().t(), src[:10], idx.float()),
        "per_client_sign_align misaligned": lambda:
            sign_align.per_client_sign_align(
                src[:10], misaligned((R, 1024), torch.int8)),
        "sign_align_counts non-contiguous": lambda:
            sign_align.sign_align_counts(x.t().contiguous().t(), q),
    }

    def counts():
        return (dict(quantize.launches), gather.launches,
                dict(masked_agg.launches), dict(sign_align.launches))

    before = counts()
    refused = {}
    for case, call in cases.items():
        try:
            call()
        except ValueError as e:
            refused[case] = str(e)
        else:
            raise AssertionError(f"{case}: not refused")
    torch.cuda.synchronize()
    if counts() != before:
        raise AssertionError("a refused call launched a kernel")
    emit("launch", stream={k: v[0] == v[1] for k, v in streams.items()},
         refused=refused)


FUSED_SHAPES = ((10, 54), (16, 864), (1, 35))   # (C, R)
COUNT_ROWS = (54, 864, 35, 1, 7)


def fused_inputs(C: int, R: int, dtype, seed: int = 0):
    """p (R, 1024) in ``dtype``, u (C, R, 1024) f32 with ±0 lanes, and
    w_lr (C,) = lr·mask·weight with one filtered client."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn((R, 1024), generator=g, device="cuda").to(dtype)
    u = torch.randn((C, R, 1024), generator=g, device="cuda")
    u[:, :, :16] = 0.0
    u[:, :, 16:32] = -0.0
    w = torch.rand((C,), generator=g, device="cuda") * 0.03
    if C > 1:
        w[1] = 0.0
    return p, u, w


def count_inputs(R: int, dtype, seed: int = 0):
    """g (R, 1024) in ``dtype`` with ±0 lanes and zero padding; r int8
    with zeros and the -2 sentinel on the padding."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((R, 1024), generator=g, device="cuda")
    x[:, :16] = 0.0
    x[:, 16:32] = -0.0
    x[-1, -200:] = 0.0
    r = torch.randint(-1, 2, (R, 1024), generator=g, device="cuda",
                      dtype=torch.int8)
    r[-1, -200:] = -2
    return x.to(dtype), r


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), in f32."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def fused_excess(got, want, p, u, w) -> float:
    """Largest excess of |got − want| over the tolerance: 1e-6 of
    Σ_c|w_c·u_c| (the kernel adds the products by fmaf, the plain version
    by a product and a sum) plus one f32 ulp of the larger of |p| and
    |want| (the subtraction rounds once on each side); for bf16 that plus
    one bf16 ulp of ``want`` (each side rounds once more, to bf16). Over
    the positions where ``want`` is finite, and +inf unless ``got`` is NaN
    and ±Inf where ``want`` is (``finite_max``)."""
    gap = (got.float() - want.float()).abs()
    scale = (u * w[:, None, None]).abs().sum(dim=0)
    big = torch.maximum(p.float().abs(), want.float().abs())
    ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    tol = 1e-6 * scale + ulp
    if p.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(want)
    return finite_max(gap - tol, got, want)


def beyond_one_bf16_ulp(got, want) -> int:
    """How many finite outputs differ by more than one bf16 ulp of
    ``want``: where two f32 sums that differ in their last bits round to
    bf16 values further apart (a result near 0, a binade's edge)."""
    gap = (got.float() - want.float()).abs()
    return int(((gap > bf16_ulp(want)) & torch.isfinite(want.float())).sum())


def held_fused(masked_agg, ref, p, u, w, where: str) -> tuple:
    """fused_update and its plain version on (p, u, w); raises unless the
    kernel keeps p's dtype and agrees within ``fused_excess``'s tolerance.
    Returns (kernel, plain, excess)."""
    got, want = masked_agg.fused_update(p, u, w), ref.fused_update(p, u, w)
    torch.cuda.synchronize()
    excess = fused_excess(got, want, p, u, w)
    if got.dtype != p.dtype or not excess <= 0.0:
        raise AssertionError(f"fused_update differs from its plain version "
                             f"at {where}, {p.dtype} (excess {excess}, "
                             f"dtype {got.dtype})")
    return got, want, excess


def fused_grid(masked_agg, ref) -> float:
    """Hold fused_update to its plain version at every (C, R) of AGG_GRID
    with p in f32 and in bf16 (``fused_excess``; in bf16 also equal by bits
    to p − masked_agg rounded once), at (10, 54) in both with Inf in a
    zero-weight client's row (NaN at the same positions), and at R = 0;
    returns the largest |kernel − plain| over the finite outputs."""
    err, worst = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        beyond = 0
        for C, R in AGG_GRID:
            p, u, w = fused_inputs(C, R, dtype, seed=C * 1000 + R)
            got, want, excess = held_fused(masked_agg, ref, p, u, w,
                                           f"C={C}, R={R}")
            err = max(err, float((got.float() - want.float()).abs().max()))
            worst[name] = max(worst.get(name, -math.inf), excess)
            if dtype == torch.bfloat16:
                # the kernel's own sum (masked_agg's fmaf chain), subtracted
                # and rounded once: equal by bits
                once = (p.float() - masked_agg.masked_agg(u, w)).to(dtype)
                if not torch.equal(got.view(torch.int16),
                                   once.view(torch.int16)):
                    raise AssertionError(f"fused_update (bf16) is not p − "
                                         f"masked_agg rounded once at "
                                         f"C={C}, R={R}")
                beyond += beyond_one_bf16_ulp(got, want)
        p, u, w = fused_inputs(10, 54, dtype, seed=7)
        u, w = with_inf(u, w)
        got, want, excess = held_fused(masked_agg, ref, p, u, w,
                                       "Inf in a zero-weight row")
        nans = has_nans(f"fused_update ({name}) with Inf in a zero-weight "
                        f"row", want)
        empty = empty_rows(lambda: masked_agg.fused_update(
            torch.zeros((0, 1024), dtype=dtype, device="cuda"),
            torch.zeros((10, 0, 1024), device="cuda"),
            torch.ones(10, device="cuda")), (0, 1024), dtype)
        extra = dict(equal_to_agg_rounded_once=True,
                     elements_beyond_one_bf16_ulp=beyond) \
            if dtype == torch.bfloat16 else {}
        emit("kernels", name="fused_update", dtype=name,
             grid=[list(s) for s in AGG_GRID], worst_excess=worst[name],
             non_finite=dict(shape=[10, 54], nan_positions=nans,
                             same_nans=True, excess=excess),
             empty=dict(shape=[10, 0], out_shape=empty), **extra)
    return err


def phase_spmd_kernels(sign_align, masked_agg, ref) -> dict:
    """Hold fused_update and sign_align_counts to their plain versions at
    every listed shape and dtype; time both at the anomaly-mlp arena."""
    fu_err = sc_err = 0.0
    cases = [(C, R, torch.float32) for C, R in FUSED_SHAPES]
    cases.append((10, 54, torch.bfloat16))
    for C, R, dtype in cases:
        p, u, w = fused_inputs(C, R, dtype, seed=C * R)
        got, want, _ = held_fused(masked_agg, ref, p, u, w, f"C={C}, R={R}")
        err = float((got.float() - want.float()).abs().max())
        fu_err = max(fu_err, err)
        emit("kernels", shape=[C, R], dtype=str(dtype).split(".")[-1],
             fused_update_max_abs_err=err,
             elements_differing=int((got != want).sum()))
    fu_err = max(fu_err, fused_grid(masked_agg, ref))
    for R in COUNT_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            g, r = count_inputs(R, dtype, seed=R)
            got, e = held_counts(sign_align.sign_align_counts,
                                 ref.sign_align_counts, g, r,
                                 f"R={R}, {dtype}")
            sc_err = max(sc_err, e)
            emit("kernels", rows=R, dtype=str(dtype).split(".")[-1],
                 sign_align_counts="equal", count=float(got))
    for dtype in (torch.float32, torch.bfloat16):
        x, r = sign_cases(dtype)
        got, e = held_counts(sign_align.sign_align_counts,
                             ref.sign_align_counts, x.cuda(), r.cuda(),
                             f"every sign case, {dtype}")
        sc_err = max(sc_err, e)
        if not torch.equal(got.cpu(), ref.sign_align_counts(x, r)):
            raise AssertionError(f"the plain version on the card and on the "
                                 f"CPU differ on the sign cases, {dtype}")
        emit("kernels", name="sign_align_counts", sign_cases=dict(
            dtype=str(dtype).split(".")[-1], count=float(got)))

    C, R = FUSED_SHAPES[0]
    n = R * 1024
    p, u, w = fused_inputs(C, R, torch.float32, seed=1)
    g, r = count_inputs(R, torch.float32, seed=1)
    # fused_update: u read once, p read once, out written once (f32), w_lr
    # read once; a multiply-add per update and a subtract per output.
    # sign_align_counts: g (f32) and r read once, one int32 written; a
    # compare and an add per slot
    fu_bound = bound_ms((C + 2) * n * 4 + 4 * C, 2 * C * n + n)
    sc_bound = bound_ms(5 * n + 4, 2 * n)
    uf = u.view(C, -1)
    rows = {
        "fused_update": dict(
            route="cuda", source="src/repro_torch/csrc/masked_agg.cu",
            replaces="src/repro/kernels/masked_agg.py:64", max_abs_err=fu_err,
            ms=time_ms(lambda: masked_agg.fused_update(p, u, w)),
            device_ms=graph_ms(lambda: masked_agg.fused_update(p, u, w)),
            plain_ms=time_ms(lambda: ref.fused_update(p, u, w)),
            bound_ms=fu_bound[0], bound_by=fu_bound[1],
            library_ms=time_ms(lambda: torch.addmv(
                p.view(-1), uf.t(), w, alpha=-1)),
            library_device_ms=graph_ms(lambda: torch.addmv(
                p.view(-1), uf.t(), w, alpha=-1)),
            design=launch_design(lambda: masked_agg.fused_update(p, u, w),
                                 "fused_update_kernel")),
        "sign_align_counts": dict(
            route="cuda", source="src/repro_torch/csrc/sign_align.cu",
            replaces="src/repro/kernels/sign_align.py:38",
            max_abs_err=sc_err,
            ms=time_ms(lambda: sign_align.sign_align_counts(g, r)),
            device_ms=graph_ms(lambda: sign_align.sign_align_counts(g, r)),
            plain_ms=time_ms(lambda: ref.sign_align_counts(g, r)),
            bound_ms=sc_bound[0], bound_by=sc_bound[1],
            # no single PyTorch call counts sign matches against int8
            # reference signs
            library_ms=None, library_device_ms=None,
            design=launch_design(lambda: sign_align.sign_align_counts(g, r),
                                 "sign_align_kernel")),
    }
    emit("kernels", name="fused_update", shape=[C, R], dtype="float32",
         **{k: v for k, v in rows["fused_update"].items()
            if k.endswith("ms") or k == "design"})
    emit("kernels", name="sign_align_counts", rows=R, dtype="float32",
         **{k: v for k, v in rows["sign_align_counts"].items()
            if k.endswith("ms") or k == "design"})
    return rows


def phase_ops(T, ops, params, mods) -> dict:
    """The kernel-ops API on the anomaly-mlp parameter dict (54,602 f32
    values) with 10 clients, card against CPU; returns the launches of the
    card's calls, counted from 0."""
    g = torch.Generator().manual_seed(5)
    C = 10
    stacked = {k: torch.randn((C,) + v.shape, generator=g) * 0.01
               for k, v in params.items()}
    ref_sign = {k: torch.randint(-1, 2, v.shape, generator=g,
                                 dtype=torch.int8)
                for k, v in params.items()}
    mask = (torch.rand((C,), generator=g) > 0.3).to(torch.float32)
    mask[0] = 1.0
    weights = torch.rand((C,), generator=g)
    lr = 3e-2
    cpu = dict(params=params, stacked=stacked, ref_sign=ref_sign, mask=mask,
               weights=weights)
    card = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
                else v.cuda()) for k, v in cpu.items()}
    out = {}
    torch.cuda.synchronize()
    reset_launches(mods)
    for dev, a in (("cuda", card), ("cpu", cpu)):
        one = {k: v[0] for k, v in a["stacked"].items()}
        out[dev] = dict(
            ratio=ops.sign_align_ratio(one, a["ref_sign"]),
            ratios=ops.per_client_sign_align_ratio(a["stacked"],
                                                   a["ref_sign"]),
            agg=ops.masked_aggregate(a["stacked"], a["mask"], a["weights"]),
            fused=ops.fused_selective_update(a["params"], a["stacked"],
                                             a["mask"], lr, a["weights"]))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_launches(mods)
    w = mask * weights
    w = w / w.sum()
    scale = {k: (v * w.reshape((C,) + (1,) * (v.dim() - 1))).abs().sum(0)
             for k, v in stacked.items()}
    problems = []
    if float(out["cuda"]["ratio"]) != float(out["cpu"]["ratio"]):
        problems.append("sign_align_ratio differs")
    if not torch.equal(out["cuda"]["ratios"].cpu(), out["cpu"]["ratios"]):
        problems.append("per_client_sign_align_ratio differs")
    gaps = {}
    for name, factor in (("agg", 1.0), ("fused", lr)):
        gap = 0.0
        for k in params:
            got, want = out["cuda"][name][k].cpu(), out["cpu"][name][k]
            big = torch.maximum(want.abs(), params[k].abs()) if \
                name == "fused" else torch.zeros_like(want)
            ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
            excess = float(((got - want).abs() - 1e-6 * factor * scale[k]
                            - (ulp if name == "fused" else 0.0)).max())
            if not excess <= 0.0:
                problems.append(f"{name} leaf {k}: excess {excess}")
            gap = max(gap, float((got - want).abs().max()))
        gaps[name] = gap
    for name in ("sign_align_counts", "per_client_sign_align",
                 "masked_agg", "fused_update"):
        if launches[name] != 1:
            problems.append(f"{name} launched {launches[name]} times")
    emit("ops", values=sum(v.numel() for v in params.values()), clients=C,
         problems=problems, ratio=float(out["cuda"]["ratio"]),
         max_abs_gap={"masked_aggregate": gaps["agg"],
                      "fused_selective_update": gaps["fused"]},
         launches=launches)
    if problems:
        raise AssertionError("ops card vs CPU: " + "; ".join(problems))
    return launches


SPMD_RUNS = {  # name -> (strategy, int8, kernels that must launch)
    "fedavg spmd": ("fedavg", False, ("masked_agg",)),
    "cmfl spmd": ("cmfl", False, ("per_client_sign_align", "masked_agg")),
    "acfl spmd": ("acfl", False, ("masked_agg",)),
    "fedl2p spmd": ("fedl2p", False, ("masked_agg",)),
    "cmfl+int8 spmd": ("cmfl", True, ("per_client_sign_align", "masked_agg",
                                      "ef_round_trip")),
}


def spmd_spec(T, strategy: str, quantize: bool = False):
    """The quickstart spec on the spmd engine."""
    return dataclasses.replace(quickstart_spec(T, strategy, quantize),
                               engine="spmd")


def run_spmd_card(T, spec, params, mods) -> tuple:
    """``spec`` through ``SpmdDriver`` on the card, every launch count set
    to 0 just before; returns (driver, records, wall seconds, launches,
    the codec's calls by rows from ``rows_per_call``)."""
    torch.cuda.synchronize()
    with rows_per_call(mods) as rows:
        reset_launches(mods)
        t0 = time.perf_counter()
        driver = T.SpmdDriver(spec, device="cuda", params=params)
        records = driver.run_rounds(spec.rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(mods)
    return driver, records, wall, launches, rows


def round_breakdown(driver, rounds: int = 4) -> dict:
    """Host milliseconds of the parts of a warm spmd round, averaged over
    ``rounds``: the driver's own ``run_rounds`` body, cut by a
    synchronisation between the parts (batch and draws to the card; the
    step's enqueue; waiting for the card; the one metric readback; the
    accounting with its evaluation)."""
    from repro_torch.api import runner
    parts = dict.fromkeys(("batch", "step_enqueue", "step_wait", "readback",
                           "account_eval"), 0.0)
    for _ in range(rounds):
        rnd = driver.round_idx
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        batch = driver._draw_batch()
        draws = driver.draws.round_draws(rnd) if driver.draws else None
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        driver.state, m = driver.step(driver.state, batch, draws)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        host = runner._readback(m)
        t.append(time.perf_counter())
        driver._account(rnd, host, evaluate=True)
        t.append(time.perf_counter())
        driver.round_idx += 1
        for name, a, b in zip(parts, t, t[1:]):
            parts[name] += (b - a) * 1e3 / rounds
    return dict(ms=parts, total_ms=sum(parts.values()), rounds=rounds)


SCENARIOS = ("dynamic", "byzantine")


def scenario_runs(T) -> dict:
    """The scenario phase's paths: name -> (spec without a scenario, the
    kernels that must launch)."""
    mega = quickstart_spec(T, "ours", quantize=True)
    cohort_int8 = ("per_client_sign_align", "masked_agg", "ef_round_trip")
    return {
        "ours+int8": (mega, cohort_int8),
        "ours+int8 loop": (quickstart_spec(T, "ours", quantize=True,
                                           megastep=False), CODEC),
        "ours+int8 scanned fused": (dataclasses.replace(
            mega, fused_eval=True, rounds_per_dispatch=4),
            cohort_int8 + ("cohort_gather",)),
        "cmfl+int8 spmd": (spmd_spec(T, "cmfl", True), cohort_int8),
    }


def run_path_card(T, spec, params, mods) -> tuple:
    """``spec`` on the card through its engine, every launch count set to 0
    just before: (simulation or driver, records, wall s, launches, the
    codec's calls by rows)."""
    if spec.engine == "spmd":
        return run_spmd_card(T, spec, params, mods)
    sim, wall, launches, rows = run_card(T, spec, params, mods)
    return (sim, T.result_from_simulation(spec, sim).records, wall,
            launches, rows)


def held_per_round(run: str, spec, launches: dict, needed) -> dict:
    """Each kernel of ``needed`` launched at least as often as the run has
    rounds (the megastep's sign-align once fewer: round 0 has no reference
    to test against); returns the launches a round."""
    per_round = {k: launches[k] / spec.rounds for k in needed}
    for k in needed:
        rounds = spec.rounds - (k == "per_client_sign_align"
                                and spec.engine == "sim"
                                and not spec.rounds_per_dispatch)
        if launches[k] < rounds:
            raise AssertionError(f"{run}: {k} launched {launches[k]} times "
                                 f"in {spec.rounds} rounds")
    return per_round


def scenario_card_cpu(T, parity, spec, params, card, card_recs) -> tuple:
    """(the problems of the card's run ``card`` against the same spec on
    the CPU from the same weights, by its path's rules; the CPU run; the
    comparison line's other fields: a scanned run's ``grad_norm_gap``)."""
    if spec.rounds_per_dispatch:
        line, cpu = scanned_card_cpu(T, parity, spec, params, card)
        return line["problems"], cpu, dict(
            grad_norm_gap=line["grad_norm_gap"])
    if spec.engine == "spmd":
        cpu = T.SpmdDriver(spec, device="cpu", params=params,
                           agg_dtype=torch.float32)
        problems = parity.record_mismatches(card_recs,
                                            cpu.run_rounds(spec.rounds))
        problems += parity.control_mismatches(
            {f: v.cpu().numpy() for f, v in card.state.control._asdict().items()},
            {f: v.numpy() for f, v in cpu.state.control._asdict().items()})
    else:
        cpu = T.build_simulation(spec, device="cpu", params=params)
        cpu.run(spec.rounds)
        problems = parity.record_mismatches(
            card_recs, T.result_from_simulation(spec, cpu).records)
        if {c: dataclasses.asdict(r) for c, r in card.selector.records.items()} \
                != {c: dataclasses.asdict(r)
                    for c, r in cpu.selector.records.items()}:
            problems.append("selector records differ")
        if card.failure_log != cpu.failure_log:
            problems.append("dropout draws differ")
    return problems + (parity.theta_band_violations(card.theta_ratios, 0.65)
                       + parity.theta_band_violations(cpu.theta_ratios,
                                                      0.65)), cpu, {}


def byzantine_tests(spec, theta_ratios) -> tuple:
    """(θ tests of the byzantine clients, those at or above θ)."""
    n_byz = spec.resolve_scenario().byzantine.n_byz
    theta = spec.resolve_strategy().theta
    tests = [t for t in theta_ratios if t[1] < n_byz]
    return tests, [t for t in tests if t[2] >= theta]


def phase_scenario(T, parity, params, mods, smi: str) -> dict:
    """The scenario phase (module docstring, 6b). Returns each scenario
    run's launches."""
    launches, problems, cards = {}, [], {}
    for run, (base, needed) in scenario_runs(T).items():
        walls = {}
        for scn in (None,) + SCENARIOS:
            spec = dataclasses.replace(base, scenario=scn)
            name = f"{run} {scn}" if scn else run
            card, recs, wall, got, rows = run_path_card(T, spec, params,
                                                         mods)
            walls[scn or "static"] = wall / spec.rounds
            if scn is None:
                continue
            for rec in recs:
                emit("slice", run=name, **dataclasses.asdict(rec))
            if not all(math.isfinite(r.loss) and math.isfinite(r.accuracy)
                       for r in recs):
                raise AssertionError(f"{name}: accuracy or loss not finite")
            held_launches(name, got, needed, rows)
            line = dict(run=name, scenario=scn, rounds=len(recs),
                        wall_s=wall, wall_s_per_round=wall / len(recs),
                        launches=got, launches_per_round=held_per_round(
                            name, spec, got, needed),
                        rows_per_call=rows_line(rows),
                        updates_applied=[r.updates_applied for r in recs])
            if scn == "byzantine":
                tests, passed = byzantine_tests(spec, card.theta_ratios)
                line.update(byzantine_theta_tests=len(tests),
                            byzantine_accepted=passed,
                            byzantine_max_ratio=max(t[2] for t in tests)
                            if tests else None)
                if not tests or passed:
                    problems.append(f"{name}: the byzantine client passed θ "
                                    f"in {passed} of {len(tests)} tests")
            emit("slice", **line)
            found, _cpu, extra = scenario_card_cpu(T, parity, spec, params,
                                                   card, recs)
            emit("card_vs_cpu", run=name, problems=found,
                 theta_tests=len(card.theta_ratios), **extra)
            problems += [f"{name}: {p}" for p in found]
            launches[name], cards[name] = got, card
        emit("scenario_overhead", run=run, nvidia_smi=smi,
             wall_s_per_round=walls,
             note="host clock around building the run and its 8 rounds, "
                  "ending in a synchronisation")

    run = "ours+int8 scanned fused dynamic"
    spec = dataclasses.replace(scenario_runs(T)["ours+int8 scanned fused"][0],
                               scenario="dynamic")
    single, _wall, _l, _r = run_card(
        T, dataclasses.replace(spec, rounds_per_dispatch=1), params, mods)
    grouping = [] if single.history == cards[run].history else [
        f"round {a.round}: {a} != {b}"
        for a, b in zip(cards[run].history, single.history) if a != b]
    if single.cohorts != cards[run].cohorts:
        grouping.append("selections differ")
    emit("r4_vs_r1", run=run, equal=not grouping, problems=grouping)
    problems += [f"{run} R=4 vs R=1: {p}" for p in grouping]
    emit("slice", run=run, sync_free_dispatch=sync_free_dispatch(
        T, spec, params))
    if problems:
        raise AssertionError("scenario runs disagree: " + "; ".join(problems))
    return launches


# (P references, clients a reference, R rows) at which the grouped
# per_client_sign_align is held to its plain version: one reference (the
# flat θ filter), the full-width hierarchical sync's 2 of 4, and 8 of up to
# 8; the last group of every case all zeros (a parent's padding slots)
GROUPED_GRID = [(P, g, R) for P in (1, 2, 8) for g in (1, 2, 4, 8)
                for R in (54, 864)]


def grouped_inputs(P: int, g: int, R: int, seed: int = 0):
    """u (P·g, R, 1024) f32 with ±0 columns and its last group all zero,
    r (P, R, 1024) int8 with -2 padding, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((P * g, R, 1024), generator=gen, device="cuda")
    u[:, :, :16] = 0.0
    u[:, :, 16:32] = -0.0
    u[-g:] = 0.0
    r = torch.randint(-1, 2, (P, R, 1024), generator=gen, device="cuda",
                      dtype=torch.int8)
    r[:, -1, -200:] = -2
    u[:, -1, -200:] = 0.0
    return u, r


def grouped_sign_kernel(sign_align, ref, smi: str) -> None:
    """The grouped per_client_sign_align against its plain version, counts
    equal, over GROUPED_GRID and every sign case; at P = 1 (C 16 × R 54)
    the reference given as (R, 1024) and as (1, R, 1024), counts equal,
    each timed eager and on the device in five alternating turns; and its
    times at the full-width sync's shape."""
    for P, g, R in GROUPED_GRID:
        u, r = grouped_inputs(P, g, R, seed=P * 1000 + g * 10 + R)
        held_counts(sign_align.per_client_sign_align,
                    ref.per_client_sign_align, u, r, f"P={P}, g={g}, R={R}")
    x, r = sign_cases(torch.float32)
    u = torch.stack([x.roll(c, dims=1) for c in range(8)])
    refs = torch.stack([r.roll(p, dims=1) for p in range(2)])
    got, _ = held_counts(sign_align.per_client_sign_align,
                         ref.per_client_sign_align, u.cuda(), refs.cuda(),
                         "every sign case, P=2, g=4")
    if not torch.equal(got.cpu(), ref.per_client_sign_align(u, refs)):
        raise AssertionError("grouped sign cases: the card's plain version "
                             "and the CPU's differ")
    u, r, _ = kernel_inputs(*MAIN_SHAPE, seed=1)
    r1 = r[None].contiguous()
    if not torch.equal(sign_align.per_client_sign_align(u, r),
                       sign_align.per_client_sign_align(u, r1)):
        raise AssertionError("P = 1 as (R, 1024) and (1, R, 1024) differ")
    p1 = {"r (R, 1024)": lambda: sign_align.per_client_sign_align(u, r),
          "r (1, R, 1024)": lambda: sign_align.per_client_sign_align(u, r1)}
    turns = {k: dict(ms=[], device_ms=[]) for k in p1}
    for turn in range(5):
        for k in (list(p1) if turn % 2 == 0 else list(p1)[::-1]):
            turns[k]["ms"].append(time_ms(p1[k]))
            turns[k]["device_ms"].append(graph_ms(p1[k]))
    C, P, R = 8, 2, 54                  # edge -> region, 64 clients
    ug, rg = grouped_inputs(P, C // P, R, seed=5)
    n = R * 1024
    bound = bound_ms(C * n * 4 + P * n + C * 4, 2 * C * n)
    emit("kernels", name="per_client_sign_align", grouped=dict(
        grid=[list(c) for c in GROUPED_GRID], equal=True,
        sign_cases=got.tolist(), all_zero_group=True),
        p1_shape=list(MAIN_SHAPE), p1_turns=turns,
        p1_median={k: {m: sorted(v)[2] for m, v in t.items()}
                   for k, t in turns.items()},
        full_width_sync=dict(
            clients=C, references=P, rows=R,
            ms=time_ms(lambda: sign_align.per_client_sign_align(ug, rg)),
            device_ms=graph_ms(lambda: sign_align.per_client_sign_align(
                ug, rg)),
            plain_ms=time_ms(lambda: ref.per_client_sign_align(ug, rg)),
            bound_ms=bound[0], bound_by=bound[1]),
        nvidia_smi=smi)


def sign_eager(sign_align, smi: str, turns: int = 7) -> None:
    """``python3 chip_smoke.py --sign-eager``: the eager ms (back-to-back
    calls, by CUDA events: the wrapper's host path) of
    per_client_sign_align at C 16 × R 54 with one (R, 1024) reference, and
    of sign_align_counts at R 54 beside it, in alternating turns. A copy
    of this script in another checkout's root times that checkout's
    wrappers, so two checkouts compare within one call."""
    u, r, _ = kernel_inputs(*MAIN_SHAPE, seed=1)
    g, rg = count_inputs(MAIN_SHAPE[1], torch.float32, seed=1)
    calls = {"per_client_sign_align": lambda: sign_align.per_client_sign_align(
        u, r), "sign_align_counts": lambda: sign_align.sign_align_counts(
            g, rg)}
    ms = {k: [] for k in calls}
    for turn in range(turns):
        for k in (list(calls) if turn % 2 == 0 else list(calls)[::-1]):
            ms[k].append(time_ms(calls[k]))
    emit("sign_eager", root=str(ROOT), shape=list(MAIN_SHAPE), ms=ms,
         median={k: sorted(v)[turns // 2] for k, v in ms.items()},
         nvidia_smi=smi)


def hierarchical_spec(T, R: int = 4, topology=True):
    """examples/hierarchical_federation.py's spec at full width: 64 clients
    in edge pods of 8, regions of 4 pods syncing every 2 rounds under θ
    0.5, the global tier every 4; drift; scanned, R rounds a dispatch."""
    tree = T.TopologySpec(tiers=(
        T.TierSpec("edge", fanout=8),
        T.TierSpec("region", fanout=4, sync_every=2, theta=0.5),
        T.TierSpec("global", sync_every=4)))
    return T.ExperimentSpec(
        model="anomaly-mlp",
        data=T.DataSpec(n_samples=12000, eval_samples=2000),
        world=T.WorldSpec(num_clients=64), strategy="ours",
        strategy_kwargs=dict(batch_size=64, dynamic_batch=False),
        scenario="drift", rounds=16, rounds_per_dispatch=R,
        topology=tree if topology else None, seed=0)


def theta_syncs(spec) -> int:
    """The θ syncs of ``spec``'s run: one grouped count each on the host
    round index paths."""
    tiers = spec.resolve_topology().tiers
    return sum(spec.rounds // t.sync_every for t in tiers[1:]
               if t.theta is not None)


def topology_view(run) -> tuple:
    """(summary, closest θ tests, θ tests a boundary) of a simulation's or
    a ``SpmdDriver``'s topology."""
    if hasattr(run, "topology_summary"):
        rt, summary = run._topo, run.topology_summary()
    else:
        (rt,) = run.step.topology_runtimes.values()
        summary = rt.summary(run.state.topology, rounds=run.round_idx)
    return summary, rt.closest_theta_tests(), rt.theta_test_counts()


def same_records(a, b) -> bool:
    """Two runs' records (RoundMetrics or RoundRecords) equal by bits, NaN
    (a round not evaluated) equal to NaN."""
    return [repr(dataclasses.astuple(x)) for x in a] == \
        [repr(dataclasses.astuple(x)) for x in b]


def state_bits_equal(a, b) -> bool:
    """Two TopologyStates equal by bits, leaf by leaf."""
    return all(torch.equal(x, y) for x, y in zip(_state_leaves(a),
                                                 _state_leaves(b)))


def _state_leaves(state):
    for f in state:
        yield from (f if isinstance(f, tuple) else (f,))


def full_width_topology(T, params, mods, smi: str) -> dict:
    """The hierarchical example's spec on the card (module docstring, 6c).
    Returns its launches."""
    spec = hierarchical_spec(T)
    flat = hierarchical_spec(T, topology=False)
    runs = {}
    for name, s in (("flat", flat), ("topology", spec),
                    ("topology again", spec),
                    ("topology R=1", dataclasses.replace(
                        spec, rounds_per_dispatch=1))):
        runs[name] = run_card(T, s, params, mods)
    problems = []
    sim, wall, launches, _rows = runs["topology"]
    equal_to_flat = same_records(sim.history, runs["flat"][0].history)
    if not equal_to_flat:
        problems.append("records differ from the run without the topology")
    for other in ("topology again", "topology R=1"):
        if not state_bits_equal(sim._topo_state, runs[other][0]._topo_state):
            problems.append(f"topology state differs from '{other}'")
    extra = (launches["per_client_sign_align"]
             - runs["flat"][2]["per_client_sign_align"])
    predicted = theta_syncs(spec)
    if extra != predicted:
        problems.append(f"{extra} grouped sign-align launches, not one a "
                        f"θ sync ({predicted})")
    summary = sim.topology_summary()
    emit("slice", run="hierarchical scanned R=4", clients=64, rounds=16,
         pods=summary["pods"], equal_to_flat=equal_to_flat,
         r4_equal_r1=state_bits_equal(
             sim._topo_state, runs["topology R=1"][0]._topo_state),
         two_runs_equal=state_bits_equal(
             sim._topo_state, runs["topology again"][0]._topo_state),
         sign_align_launches=dict(flat=runs["flat"][2][
             "per_client_sign_align"], topology=launches[
             "per_client_sign_align"], per_theta_sync=extra / predicted,
             theta_syncs=predicted),
         launches=launches, topology_summary=summary,
         final_accuracy=sim.history[-1].accuracy)
    emit("topology_overhead", run="hierarchical scanned R=4",
         nvidia_smi=smi, wall_s_per_round=dict(
             flat=runs["flat"][1] / 16, topology=wall / 16,
             topology_again=runs["topology again"][1] / 16),
         note="host clock around building the run and its 16 rounds, "
              "ending in a synchronisation")
    emit("slice", run="hierarchical scanned R=4",
         sync_free_dispatch=sync_free_dispatch(T, spec, params))
    if problems:
        raise AssertionError("hierarchical run: " + "; ".join(problems))
    return launches


TOPOLOGY_PRESETS_RUN = ("two-tier-pods", "edge-region-global")


def same_control(a, b) -> bool:
    """Two ControlStates equal by bits, field by field."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_topology(T, parity, sign_align, ref, params, mods,
                   smi: str) -> dict:
    """The topology phase (module docstring, 6c). Returns each run's
    launches."""
    t0 = time.perf_counter()
    grouped_sign_kernel(sign_align, ref, smi)
    launches = {"hierarchical": full_width_topology(T, params, mods, smi)}
    problems = []
    for run, (base, needed) in scenario_runs(T).items():
        flat, flat_recs, flat_wall, flat_launches, _ = run_path_card(
            T, base, params, mods)
        for preset in TOPOLOGY_PRESETS_RUN:
            spec = dataclasses.replace(base, topology=preset)
            name = f"{run} {preset}"
            card, recs, wall, got, rows = run_path_card(T, spec, params,
                                                         mods)
            held_launches(name, got, needed, rows)
            equal_to_flat = same_records(recs, flat_recs)
            found = [] if equal_to_flat else [
                "records differ from the run without the topology"]
            control_equal = None
            if spec.rounds_per_dispatch:
                control_equal = same_control(card._scan_ctl, flat._scan_ctl)
                if not control_equal:
                    found.append("control state differs from the run "
                                 "without the topology")
            problems_cpu, cpu, norm_gap = scenario_card_cpu(
                T, parity, spec, params, card, recs)
            found += problems_cpu
            summary, tests, n_tests = topology_view(card)
            cpu_summary, cpu_tests, _n = topology_view(cpu)
            thetas = [t.theta for t in spec.resolve_topology().tiers[1:]]
            found += parity.topology_problems(summary, cpu_summary,
                                              tests + cpu_tests, thetas)
            extra = (got["per_client_sign_align"]
                     - flat_launches["per_client_sign_align"])
            emit("card_vs_cpu", run=name, problems=found,
                 equal_to_flat=equal_to_flat, theta_tests=n_tests,
                 min_theta_distance=min((abs(x - thetas[b])
                                         for b, _r, _j, x in tests),
                                        default=None),
                 topology_summary=summary, grouped_launches=extra,
                 control_equal_to_flat=control_equal, **norm_gap,
                 wall_s_per_round=dict(flat=flat_wall / spec.rounds,
                                       topology=wall / spec.rounds),
                 nvidia_smi=smi)
            problems += [f"{name}: {p}" for p in found]
            launches[name] = got
    emit("topology_phase", seconds=time.perf_counter() - t0)
    if problems:
        raise AssertionError("topology runs disagree: " + "; ".join(problems))
    return launches


# benchmarks/fig3_scaling.py --population's cells: populations, cohort,
# candidate_frac, logical shards, rounds
POP_CLIENTS = (1_000, 10_000, 100_000, 1_000_000)
POP_K, POP_FRAC, POP_SHARDS, POP_ROUNDS = 64, 0.02, 8, 20


def seeded_state(control, n: int, device):
    """fig3_scaling._seeded_state on ``device``: numpy rng 7, uniform
    availability, pass rate and round time (a fresh state scores every
    client the same)."""
    rng = np.random.default_rng(7)
    arrays = dict(avail=rng.uniform(0.2, 1.0, n),
                  pass_rate=rng.uniform(0.5, 1.0, n),
                  round_time=rng.uniform(0.5, 2.0, n))
    return control.init_control(n, device=device)._replace(**{
        f: torch.from_numpy(a.astype(np.float32)).to(device)
        for f, a in arrays.items()})


def pop_observations(draws, r: int) -> dict:
    """A population round's observations (build_population_round's)."""
    failed, passed, rt, norms = draws.round(r)
    active = ~failed
    return dict(failed=failed, active=active, passed=passed & active,
                round_time=rt, sent=active, norms=norms)


def pop_rounds(fn, state, rounds: int, first: int = 0):
    """``rounds`` population rounds from ``state``; (state, cohorts)."""
    cohorts = []
    for r in range(first, first + rounds):
        state, cohort = fn(state, r)
        cohorts.append(cohort)
    return state, cohorts


def pop_ms(fn, state, rounds: int) -> float:
    """ms a round over ``rounds`` rounds after a warm-up, by CUDA events
    (the host's draws and launches included)."""
    pop_rounds(fn, state, 2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    pop_rounds(fn, state, rounds)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / rounds


def population_sweep(T, parity, smi: str) -> None:
    """Population-only rounds at fig3_scaling's cells (module docstring,
    6d a)."""
    from repro_torch.core import control, population, selection
    from repro_torch.core.draws import PopulationDraws
    problems = []
    for n in POP_CLIENTS:
        fns = {name: population.build_population_round(
            n, POP_K, candidate_frac=frac, candidate_shards=POP_SHARDS,
            device="cuda") for name, frac in (
                ("single", None), ("two_stage", POP_FRAC), ("frac1", 1.0))}
        state = seeded_state(control, n, "cuda")
        ms = {name: pop_ms(fns[name], state, POP_ROUNDS)
              for name in ("single", "two_stage")}
        # no host synchronisation inside a round, single- or two-stage
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for name in ("single", "two_stage"):
                fns[name](state, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # round_update_logical against round_update, 3 rounds, by bits
        draws = PopulationDraws(0, POP_K, "cuda")
        glob = logi = state
        for r in range(3):
            cohort = fns["two_stage"](glob, r)[1]
            obs = pop_observations(draws, r)
            glob = population.round_update(glob, cohort, **obs)
            logi = population.round_update_logical(
                logi, cohort, shards=POP_SHARDS, **obs)
        logical_equal = same_control(glob, logi)
        # candidate_frac = 1.0 against single-stage, 3 rounds, by bits
        a, ca = pop_rounds(fns["single"], state, 3)
        b, cb = pop_rounds(fns["frac1"], state, 3)
        frac1_equal = (all(torch.equal(x, y) for x, y in zip(ca, cb))
                       and same_control(a, b))
        line = dict(clients=n, cohort=POP_K, candidate_frac=POP_FRAC,
                    shards=POP_SHARDS, rounds=POP_ROUNDS,
                    quota=selection.candidate_quota(n, POP_K, POP_FRAC,
                                                    POP_SHARDS),
                    per=-(-n // POP_SHARDS), ms_per_round=ms,
                    logical_equal_global=logical_equal,
                    frac1_equal_single=frac1_equal, sync_free=True,
                    nvidia_smi=smi)
        if n == POP_CLIENTS[-1]:
            line["card_vs_cpu"] = population_card_cpu(T, parity, n)
            problems += line["card_vs_cpu"]["problems"]
        emit("population", **line)
        if not (logical_equal and frac1_equal):
            problems.append(f"{n} clients: logical equal to global "
                            f"{logical_equal}, frac 1.0 equal to "
                            f"single-stage {frac1_equal}")
        del fns, state, glob, logi, a, b
    if problems:
        raise AssertionError("population rounds: " + "; ".join(problems))


def population_card_cpu(T, parity, n: int) -> dict:
    """Three population rounds at ``n`` clients on the card and on the CPU
    from the same state with the same draws, single- and two-stage:
    cohorts equal, batch, staleness and has_ckpt equal, the f32 fields
    within ``parity.EMA_RTOL`` (and whether they are equal by bits)."""
    from repro_torch.core import control, population
    problems, by_bits = [], {}
    for name, frac in (("single", None), ("two_stage", POP_FRAC)):
        runs = {}
        for dev in ("cuda", "cpu"):
            fn = population.build_population_round(
                n, POP_K, candidate_frac=frac, candidate_shards=POP_SHARDS,
                device=dev)
            runs[dev] = pop_rounds(fn, seeded_state(control, n, dev), 3)
        (card, c_card), (cpu, c_cpu) = runs["cuda"], runs["cpu"]
        if [c.tolist() for c in c_card] != [c.tolist() for c in c_cpu]:
            problems.append(f"{name}: cohorts differ")
        state = {f: getattr(card, f).cpu().numpy()
                 for f in population._FIELDS}
        want = {f: getattr(cpu, f).numpy() for f in population._FIELDS}
        problems += [f"{name}: {p}" for p in parity.population_mismatches(
            state, want, population._FIELDS)]
        by_bits[name] = all(np.array_equal(state[f], want[f])
                            for f in population._FIELDS)
    return dict(rounds=3, problems=problems, equal_by_bits=by_bits)


def lazy_spec(T, clients: int, k: int, frac: float, shards: int,
              rounds: int, **strategy_kwargs):
    """The quickstart's model, links and int8 ``ours`` on a non-resident
    world of ``clients`` clients, 256 samples each, selecting ``k``."""
    return dataclasses.replace(
        quickstart_spec(T, "ours", quantize=True,
                        select_fraction=k / clients, **strategy_kwargs),
        data=T.DataSpec(samples_per_client=256, eval_samples=4000),
        world=T.WorldSpec(num_clients=clients, dropout_p=0.1,
                          resident=False),
        rounds=rounds, candidate_frac=frac, candidate_shards=shards)


def free_card() -> None:
    """Return a finished run's memory to the card (its tensors die with
    the last reference to the run)."""
    torch.cuda.empty_cache()


def lazy_timed(T, params, mods, smi: str) -> tuple:
    """The 100,000-client non-resident world on the int8 megastep, 4 rounds
    timed one by one: (its ``slice`` line, its launches, its spec)."""
    spec = lazy_spec(T, 100_000, 64, 0.02, 8, 4, dynamic_batch=False)
    needed = ("per_client_sign_align", "masked_agg", "ef_round_trip")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = T.build_simulation(spec, device="cuda", params=params)
    build_s = time.perf_counter() - t0
    per_round, walls, total = [], [], collections.Counter()
    with rows_per_call(mods) as rows:
        for r in range(spec.rounds):
            torch.cuda.synchronize()
            reset_launches(mods)
            t0 = time.perf_counter()
            sim.run(1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = read_launches(mods)
            per_round.append({k: got[k] for k in needed})
            total.update(got)
            for k in needed:
                if got[k] < 1 and (r or k != "per_client_sign_align"):
                    raise AssertionError(f"lazy world, round {r}: {k} "
                                         f"launched {got[k]} times")
    held_launches("lazy 100k", dict(total), needed, rows)
    recs = T.result_from_simulation(spec, sim).records
    if not all(math.isfinite(r.loss) and math.isfinite(r.accuracy)
               for r in recs):
        raise AssertionError("lazy world: accuracy or loss not finite")
    resident, capacity = sim.loaders.resident, sim.loaders.capacity
    if not (sim.loaders.lazy and resident <= capacity == 256):
        raise AssertionError(f"lazy world: {resident} loaders resident, "
                             f"capacity {capacity}")
    line = dict(run="ours+int8 lazy 100k", clients=100_000, cohort=64,
                samples_per_client=256, candidate_frac=0.02, shards=8,
                rounds=spec.rounds, build_s=build_s, wall_s_per_round=walls,
                launches_per_round=per_round, rows_per_call=rows_line(rows),
                loaders_resident=resident, loaders_capacity=capacity,
                ef_arena_gb=sim._ef_arena.numel() * 4 / 1e9,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9,
                updates_applied=[r.updates_applied for r in recs],
                accuracy=[r.accuracy for r in recs], nvidia_smi=smi)
    return line, dict(total), spec


def lazy_full_width(T, params, mods, smi: str) -> dict:
    """The 100,000-client non-resident world on the int8 megastep (module
    docstring, 6d b); returns its launches."""
    line, total, spec = lazy_timed(T, params, mods, smi)
    # each run holds a 22.1 GB arena: free one before the next
    free_card()
    # candidate_frac = 1.0 against single-stage on the same world
    same = {}
    for frac in (1.0, None):
        one = dataclasses.replace(spec, candidate_frac=frac)
        run = T.build_simulation(one, device="cuda", params=params)
        run.run(one.rounds)
        same[frac] = (T.result_from_simulation(one, run).records,
                      run.failure_log)
        del run
        free_card()
    line["frac1_equal_single"] = same[1.0] == same[None]
    emit("slice", **line)
    if not line["frac1_equal_single"]:
        raise AssertionError("lazy world: candidate_frac=1.0 records differ "
                             "from single-stage")
    return total


def scale_kernels(sign_align, masked_agg, quantize, ref) -> None:
    """The kernels at the lazy world's shapes, against their plain versions
    by the rules of phase 3: sign-align and masked-agg at C 64 × R 54, the
    error-feedback round trip at 64 × 54 = 3,456 rows; timed beside their
    bounds, plain versions and library calls."""
    C, R = 64, 54
    u, r, w = kernel_inputs(C, R, seed=64)
    _, sa_err = held_counts(sign_align.per_client_sign_align,
                            ref.per_client_sign_align, u, r,
                            f"C={C}, R={R}")
    got, want, _ = held_agg(masked_agg, ref, u, w, f"C={C}, R={R}")
    n = R * 1024
    sa_bound = bound_ms(C * n * 4 + n + C * 4, 2 * C * n)
    ma_bound = bound_ms(C * n * 4 + C * 4 + n * 4, 2 * C * n)
    emit("kernels", name="per_client_sign_align", shape=[C, R],
         equal=True, max_abs_err=sa_err,
         ms=time_ms(lambda: sign_align.per_client_sign_align(u, r)),
         device_ms=graph_ms(lambda: sign_align.per_client_sign_align(u, r)),
         plain_ms=time_ms(lambda: ref.per_client_sign_align(u, r)),
         bound_ms=sa_bound[0], bound_by=sa_bound[1], library_ms=None)
    emit("kernels", name="masked_agg", shape=[C, R],
         max_abs_err=float((got - want).abs().max()),
         ms=time_ms(lambda: masked_agg.masked_agg(u, w)),
         device_ms=graph_ms(lambda: masked_agg.masked_agg(u, w)),
         plain_ms=time_ms(lambda: ref.masked_agg(u, w)),
         bound_ms=ma_bound[0], bound_by=ma_bound[1],
         library_ms=time_ms(lambda: torch.einsum("crl,c->rl", u, w)),
         library_device_ms=graph_ms(lambda: torch.einsum("crl,c->rl", u,
                                                         w)))
    rows = C * R
    for e_kind in ("zero", "random"):
        d, e = ef_inputs(rows, seed=rows, e_kind=e_kind)
        for g, wnt in zip(quantize.ef_round_trip(d, e),
                          ref.ef_round_trip(d, e)):
            if not torch.equal(g.view(torch.int32), wnt.view(torch.int32)):
                raise AssertionError(f"ef_round_trip differs from its plain "
                                     f"version at {rows} rows, e {e_kind}")
    # d and e read, restored and residual written; an add, the five
    # operations of quantize, a multiply and a subtract (codec_rows)
    ef_bound = bound_ms(16 * rows * 1024, 8 * rows * 1024)
    emit("kernels", name="ef_round_trip", rows=rows,
         ef_round_trip="equal by bits",
         ms=time_ms(lambda: quantize.ef_round_trip(d, e)),
         device_ms=graph_ms(lambda: quantize.ef_round_trip(d, e)),
         plain_ms=time_ms(lambda: ref.ef_round_trip(d, e)),
         bound_ms=ef_bound[0], bound_by=ef_bound[1], library_ms=None)


def phase_population(T, parity, sign_align, masked_agg, quantize, ref,
                     params, mods, smi: str) -> dict:
    """World scale (module docstring, 6d). Returns each run's launches."""
    t0 = time.perf_counter()
    population_sweep(T, parity, smi)
    scale_kernels(sign_align, masked_agg, quantize, ref)
    launches = {"ours+int8 lazy 100k": lazy_full_width(T, params, mods,
                                                      smi)}
    problems = []
    small = lazy_spec(T, 200, 16, 0.5, 4, 4)
    half = quickstart_spec(T, "ours", quantize=True, select_fraction=0.5)
    cells = {
        "lazy megastep": (small, ("per_client_sign_align", "masked_agg",
                                  "ef_round_trip")),
        "lazy loop": (dataclasses.replace(small, megastep=False), CODEC),
        "two-stage scanned": (dataclasses.replace(
            half, rounds_per_dispatch=4, candidate_frac=0.5,
            candidate_shards=2), ("per_client_sign_align", "masked_agg",
                                  "ef_round_trip", "cohort_gather")),
        "two-stage spmd": (dataclasses.replace(
            quickstart_spec(T, "ours", quantize=True, select_fraction=0.5,
                            mode="sync", dynamic_batch=False),
            engine="spmd", candidate_frac=0.5, candidate_shards=2),
            ("per_client_sign_align", "masked_agg", "ef_round_trip")),
    }
    for run, (spec, needed) in cells.items():
        card, recs, wall, got, rows = run_path_card(T, spec, params, mods)
        held_launches(run, got, needed, rows)
        found, cpu, extra = scenario_card_cpu(T, parity, spec, params, card,
                                              recs)
        line = dict(run=run, rounds=len(recs), problems=found, **extra,
                    wall_s_per_round=wall / len(recs), launches=got,
                    updates_applied=[r.updates_applied for r in recs])
        if not spec.world.resident:
            line.update(loaders_resident=card.loaders.resident,
                        loaders_capacity=card.loaders.capacity)
            if card.loaders.state_dict() != cpu.loaders.state_dict():
                found.append("loader streams differ")
        if spec.rounds_per_dispatch:
            line["cohorts"] = card.cohorts
        emit("card_vs_cpu", **line)
        problems += [f"{run}: {p}" for p in found]
        launches[run] = got
    emit("population_phase", seconds=time.perf_counter() - t0)
    if problems:
        raise AssertionError("world-scale runs disagree: "
                             + "; ".join(problems))
    return launches


def phase_spmd(T, parity, params, mods) -> dict:
    """The five spmd runs on the card, card against CPU for the two cmfl
    runs, the seed batch against solo runs, and a trace of a warm round.
    Returns each run's launches."""
    launches, drivers, records = {}, {}, {}
    for run, (strategy, int8, needed) in SPMD_RUNS.items():
        spec = spmd_spec(T, strategy, int8)
        driver, recs, wall, launches[run], rows = run_spmd_card(
            T, spec, params, mods)
        for rec in recs:
            emit("slice", run=run, **dataclasses.asdict(rec))
        emit("slice", run=run, engine="spmd", rounds=len(recs), wall_s=wall,
             wall_s_per_round=wall / len(recs), launches=launches[run],
             rows_per_call=rows_line(rows),
             updates_applied=[r.updates_applied for r in recs])
        if not all(math.isfinite(r.loss) and math.isfinite(r.accuracy)
                   for r in recs):
            raise AssertionError(f"{run}: accuracy or loss not finite")
        held_launches(run, launches[run], needed, rows)
        drivers[run], records[run] = driver, recs

    problems = []
    for run in ("cmfl spmd", "cmfl+int8 spmd"):
        strategy, int8, _ = SPMD_RUNS[run]
        spec = spmd_spec(T, strategy, int8)
        cpu = {}
        for name, agg in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            d = T.SpmdDriver(spec, device="cpu", params=params, agg_dtype=agg)
            cpu[name] = (d, d.run_rounds(spec.rounds))
        card = drivers[run]
        f32, f32_recs = cpu["f32"]
        line = parity.record_mismatches(records[run], f32_recs)
        line += (parity.theta_band_violations(card.theta_ratios, 0.65)
                 + parity.theta_band_violations(f32.theta_ratios, 0.65))
        line += parity.control_mismatches(
            {f: v.cpu().numpy() for f, v in card.state.control._asdict().items()},
            {f: v.numpy() for f, v in f32.state.control._asdict().items()})
        bf16_recs = cpu["bf16"][1]
        ref_flips = sum(int((card.state.ref_sign[k].cpu()
                             != f32.state.ref_sign[k]).sum())
                        for k in params)
        emit("card_vs_cpu", run=run, cpu_agg_dtype="float32", problems=line,
             theta_tests=len(card.theta_ratios),
             max_ratio_gap=max((abs(a[2] - b[2]) for a, b in zip(
                 card.theta_ratios, f32.theta_ratios)), default=0.0),
             max_loss_rel_gap=max(abs(a.loss - b.loss) / abs(b.loss)
                                  for a, b in zip(records[run], f32_recs)),
             max_acc_gap=max(abs(a.accuracy - b.accuracy)
                             for a, b in zip(records[run], f32_recs)),
             ref_signs_differing=ref_flips,
             gap_to_bf16_cpu=dict(
                 record_mismatches=parity.record_mismatches(records[run],
                                                            bf16_recs),
                 max_loss_rel_gap=max(abs(a.loss - b.loss) / abs(b.loss)
                                      for a, b in zip(records[run],
                                                      bf16_recs)),
                 max_acc_gap=max(abs(a.accuracy - b.accuracy)
                                 for a, b in zip(records[run], bf16_recs)),
                 max_param_gap=max(float((card.params[k].cpu()
                                          - cpu["bf16"][0].params[k])
                                         .abs().max()) for k in params)))
        problems += [f"{run}: {p}" for p in line]

    # the seed batch: quickstart fedavg without dropout (seed-vectorizable)
    # at seeds whose smallest shard takes the same 32 local steps (seed 2's
    # takes 16, and the batch refuses to mix cohort shapes)
    seeds = (0, 1, 3)
    spec = dataclasses.replace(spmd_spec(T, "fedavg"),
                               world=T.WorldSpec(num_clients=10))
    torch.cuda.synchronize()
    reset_launches(mods)
    t0 = time.perf_counter()
    batch = T.run_spmd_seed_batch(spec, seeds, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batch_launches = read_launches(mods)
    unequal = []
    for s, res in zip(seeds, batch):
        solo = T.run_experiment(dataclasses.replace(spec, seed=s),
                                device="cuda")
        if res.records != solo.records:
            unequal.append(f"seed {s}: records differ")
        if any(not torch.equal(v, solo.params[k])
               for k, v in res.params.items()):
            unequal.append(f"seed {s}: params differ")
    emit("seed_batch", run="fedavg spmd", seeds=list(seeds),
         rounds=spec.rounds, wall_s=wall, launches=batch_launches,
         equal_to_solo=not unequal, problems=unequal,
         final_accuracy=[res.final.accuracy for res in batch])
    problems += unequal

    for run, (strategy, int8, _) in (("cmfl+int8 spmd",
                                      SPMD_RUNS["cmfl+int8 spmd"]),
                                     ("fedavg spmd", SPMD_RUNS["fedavg spmd"])):
        driver = T.SpmdDriver(spmd_spec(T, strategy, int8), device="cuda",
                              params=params)
        driver.run_rounds(1)
        line = trace(lambda: driver.run_rounds(1))
        emit("trace", run=run, rounds=1,
             device_events_per_round=line["device_events"], **line)
        if int8:
            emit("round_breakdown", run=run, **round_breakdown(driver))
    if problems:
        raise AssertionError("spmd runs disagree: " + "; ".join(problems))
    return launches


def reset_launches(mods) -> None:
    for name in ("sign_align", "masked_agg", "quantize"):
        mods[name].launches.update(dict.fromkeys(mods[name].launches, 0))
    mods["gather"].launches = 0
    mods["flash_attn"].launches = 0
    fa = mods["flash_attn"].launches_by_route
    fa.update(dict.fromkeys(fa, 0))


def read_launches(mods) -> dict:
    """Each kernel's launches; flash attention's by its two kernels (the
    wgmma one under the function's name)."""
    fa = mods["flash_attn"].launches_by_route
    return {**mods["sign_align"].launches, **mods["masked_agg"].launches,
            **mods["quantize"].launches,
            "cohort_gather": mods["gather"].launches,
            "flash_attention": fa["wgmma"],
            "flash_attention_simt": fa["simt"]}


@contextlib.contextmanager
def rows_per_call(mods):
    """Within the block, count the calls of ``compression.compress_cohort``
    (by the rows of its folded (C·rows, 1024) view, what it hands to
    ``ef_round_trip``) and of ``quantize.quantize_q8`` (by its rows) in the
    yielded dict of {rows: calls}; the engines look both up on their
    modules at call time. Both are restored on exit."""
    compression, quantize = mods["compression"], mods["quantize"]
    cohort, codec = compression.compress_cohort, quantize.quantize_q8
    rows = {"compress_cohort": collections.Counter(),
            "quantize_q8": collections.Counter()}

    def compress_cohort(deltas, err):
        rows["compress_cohort"][deltas.shape[0] * deltas.shape[1]] += 1
        return cohort(deltas, err)

    def quantize_q8(x):
        rows["quantize_q8"][x.shape[0]] += 1
        return codec(x)

    compression.compress_cohort = compress_cohort
    quantize.quantize_q8 = quantize_q8
    try:
        yield rows
    finally:
        compression.compress_cohort = cohort
        quantize.quantize_q8 = codec


def rows_line(rows) -> dict:
    """``rows_per_call``'s counts as JSON: {name: {rows: calls}}."""
    return {name: {str(k): v for k, v in sorted(c.items())}
            for name, c in rows.items()}


CODEC = ("quantize_q8", "dequantize_q8")


def held_launches(run: str, launches: dict, needed, rows) -> None:
    """Every kernel in ``needed`` launched on the path of ``run``;
    ``ef_round_trip`` launched exactly as often as ``compress_cohort`` was
    called (``rows``, from ``rows_per_call``; 0 where nothing compresses);
    and a run that needs the round trip launched no codec kernel, the
    per-client loop being the one int8 path that runs the codec pair."""
    for kname in needed:
        if launches[kname] < 1:
            raise AssertionError(f"{kname} was never launched on the path "
                                 f"of '{run}'")
    calls = sum(rows["compress_cohort"].values())
    if launches["ef_round_trip"] != calls:
        raise AssertionError(
            f"{run}: ef_round_trip launched {launches['ef_round_trip']} "
            f"times in {calls} compress calls")
    if "ef_round_trip" in needed and any(launches[k] for k in CODEC):
        raise AssertionError(f"{run}: the cohort path launched the codec "
                             f"pair: {[launches[k] for k in CODEC]}")


def run_card(T, spec, params, mods) -> tuple:
    """Run ``spec`` on the card with every launch count set to 0 just
    before; returns (simulation, wall seconds, launches, the codec's calls
    by rows from ``rows_per_call``)."""
    torch.cuda.synchronize()
    with rows_per_call(mods) as rows:
        reset_launches(mods)
        t0 = time.perf_counter()
        sim = T.build_simulation(spec, device="cuda", params=params)
        sim.run(spec.rounds, eval_final=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(mods)
    return sim, wall, launches, rows


def sync_free_dispatch(T, spec, params) -> dict:
    """One dispatch of 4 scanned rounds, called directly under
    ``set_sync_debug_mode("error")``: a host synchronisation inside it
    (``.item()``, a blocking copy, a mask index) raises. The mode is off
    again before anything is read back."""
    sim = T.build_simulation(spec, device="cuda", params=params)
    fn = sim._scan_fn(4)
    args = sim._scan_args()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _carry, ms = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host = sim.scan_readback(ms)
    if not (np.isfinite(host["loss"]).all() and len(host["loss"]) == 4):
        raise AssertionError(f"sync-free dispatch: bad metrics {host}")
    return {"rounds": 4, "sync_debug_mode": "error", "raised": False,
            "updates_applied": [int(x) for x in host["updates_applied"]]}


def trace(run_once, share_of: str = None) -> dict:
    """``torch.profiler`` over one call of ``run_once`` (warm, ending in a
    synchronisation): the kernels the card ran, their device time, and
    the share of the call's wall time in which no kernel ran; with
    ``share_of``, the device time of the kernels whose name holds it and
    their share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:                  # length of the union of the spans
        if b > end:
            busy += b - max(a, end)
            end = b
    by_key = sorted(((e.key, e.count, e.device_time_total)
                     for e in prof.key_averages()
                     if e.device_time_total > 0), key=lambda x: -x[2])
    line = dict(device_events=len(spans), device_busy_us=busy,
                wall_us=wall_us,
                device_idle_share=(1.0 - busy / wall_us) if spans else None,
                top_by_device_time=[dict(name=n[:60], count=c, us=t)
                                    for n, c, t in by_key[:6]])
    if share_of is not None:
        mine = [(c, t) for n, c, t in by_key if share_of in n]
        us = sum(t for _, t in mine)
        line.update(kernel=share_of, kernel_count=sum(c for c, _ in mine),
                    kernel_us=us, kernel_share_of_busy=us / busy if busy
                    else None)
    return line


def phase_trace(T, spec_scanned, spec_mega, params) -> None:
    """One warm scanned dispatch of 4 rounds and one warm megastep round,
    each traced."""
    sim = T.build_simulation(spec_scanned, device="cuda", params=params)
    sim._scan_dispatch(4)
    line = trace(lambda: sim.scan_readback(sim._scan_dispatch(4)))
    emit("trace", run="ours+int8 scanned fused", rounds=4,
         device_events_per_round=line["device_events"] / 4, **line)
    mega = T.build_simulation(spec_mega, device="cuda", params=params)
    mega.run(1)
    line = trace(lambda: mega.run(1))
    emit("trace", run="ours+int8", rounds=1,
         device_events_per_round=line["device_events"], **line)


def norm_replay(T, parity, spec, params, card_sim) -> tuple:
    """Each round of ``spec`` (scanned) run on the card one round a
    dispatch, and replayed on the CPU from the card's carry before it
    (parameters, control state, error feedback, reference sign, the same
    draws): the card's update-norm EMA after the round within
    ``parity.NORM_RTOL`` of the CPU's (one round from one state). The
    card's one-round-a-dispatch run must equal ``card_sim`` by bits.
    Returns (problems, the largest relative gap of each round)."""
    one = dataclasses.replace(spec, rounds_per_dispatch=1)
    card = T.build_simulation(one, device="cuda", params=params)
    cpu = T.build_simulation(one, device="cpu", params=params)
    problems, gaps = [], []
    for r in range(spec.rounds):
        carry = card.scan_carry()
        card.run(1)
        cpu.load_scan_carry(carry)
        cpu._scan_dispatch(1)
        got = card._scan_ctl.grad_norm.cpu().numpy()
        want = cpu._scan_ctl.grad_norm.numpy()
        problems += parity.norm_mismatches(got, want, where=f"round {r}: ")
        gaps.append(float(np.max(np.abs(got.astype(np.float64) - want)
                                 / np.abs(want))))
    if not (same_control(card._scan_ctl, card_sim._scan_ctl)
            and torch.equal(card._params_mat, card_sim._params_mat)
            and card.cohorts == card_sim.cohorts):
        problems.append("the card's run at one round a dispatch differs "
                        "from its run at "
                        f"{spec.rounds_per_dispatch}")
    return problems, gaps


def scanned_card_cpu(T, parity, spec, params, card_sim) -> tuple:
    """``spec`` (scanned) on the CPU from the same weights and draws as the
    card's run ``card_sim``: the control state after the run (the
    update-norm EMA within ``parity.NORM_RUN_RTOL``), each
    round's update-norm EMA replayed from the card's carry
    (``norm_replay``); then both for one round again, for the error
    feedback after round 0. Returns the comparison line's fields and the
    CPU run."""
    cpu = T.build_simulation(spec, device="cpu", params=params)
    cpu.run(spec.rounds)
    card_recs = T.result_from_simulation(spec, card_sim).records
    cpu_recs = T.result_from_simulation(spec, cpu).records
    problems = parity.scanned_mismatches(card_recs, cpu_recs)
    if card_sim.cohorts != cpu.cohorts:
        problems.append(f"selections differ: {card_sim.cohorts} vs "
                        f"{cpu.cohorts}")
    card_ctl = card_sim._scan_ctl._asdict()
    problems += parity.control_mismatches(
        {f: v.cpu().numpy() for f, v in card_ctl.items()},
        {f: v.numpy() for f, v in cpu._scan_ctl._asdict().items()},
        norm_rtol=parity.NORM_RUN_RTOL)
    replay, replay_gaps = norm_replay(T, parity, spec, params, card_sim)
    problems += replay
    problems += (parity.theta_band_violations(card_sim.theta_ratios, 0.65)
                 + parity.theta_band_violations(cpu.theta_ratios, 0.65))
    one = dataclasses.replace(spec, rounds=1)
    ef = {}
    for dev in ("cuda", "cpu"):
        sim = T.build_simulation(one, device=dev, params=params)
        sim.run(1)
        ef[dev] = sim._scan_ctl.ef[:-1].cpu().numpy()
    problems += parity.ef_mismatches(ef["cuda"], ef["cpu"])
    gaps = {f: max(abs(getattr(a, f) - getattr(b, f))
                   / max(abs(getattr(b, f)), 1e-30)
                   for a, b in zip(card_recs, cpu_recs))
            for f in ("sim_time", "comm_time", "idle_time", "bytes_sent",
                      "loss")}
    run_gap = float(np.max(np.abs(
        card_ctl["grad_norm"].cpu().numpy().astype(np.float64)
        - cpu._scan_ctl.grad_norm.numpy()) / cpu._scan_ctl.grad_norm.numpy()))
    return dict(problems=problems, cohorts=card_sim.cohorts,
                grad_norm_gap=dict(
                    run=run_gap, run_bound=parity.NORM_RUN_RTOL,
                    replay_per_round=replay_gaps,
                    replay_bound=parity.NORM_RTOL),
                theta_tests=len(card_sim.theta_ratios),
                max_ratio_gap=max((abs(a[2] - b[2]) for a, b in zip(
                    card_sim.theta_ratios, cpu.theta_ratios)), default=0.0),
                max_rel_gap=gaps,
                max_acc_gap=max((abs(a.accuracy - b.accuracy)
                                 for a, b in zip(card_recs, cpu_recs)
                                 if math.isfinite(b.accuracy)), default=0.0),
                ef_round0_elements_beyond_rtol=parity.ef_flips(ef["cuda"],
                                                               ef["cpu"])), cpu


def run_round0_codes(sim, quantize, ref) -> tuple:
    """Run round 0 of ``sim``; return, on the CPU, the int8 codes of the
    d + e of every error-feedback round trip (padding rows included), coded
    by the plain version, and how many elements of the round trips'
    restored values and residuals differ by bits from the plain round trip
    of the same d and e (0 by construction where ``sim`` runs on the CPU;
    on the card, the kernel's elements off the plain version)."""
    seen, off = [], 0
    wrapped = quantize.ef_round_trip

    def recording(d, e):
        nonlocal off
        got = wrapped(d, e)
        d, e = d.cpu(), e.cpu()
        want = ref.ef_round_trip(d, e)
        off += sum(int((g.cpu().view(torch.int32)
                        != w.view(torch.int32)).sum())
                   for g, w in zip(got, want))
        seen.append(ref.quantize_q8(d + e)[0])
        return got

    quantize.ef_round_trip = recording
    try:
        sim.run(1)
    finally:
        quantize.ef_round_trip = wrapped
    return torch.cat(seen), off


def nudged(params: dict) -> dict:
    """``params`` with one ulp added to the first 64 weights of w1."""
    out = {k: v.clone() for k, v in params.items()}
    w = out["w1"].reshape(-1)[:64]
    w.copy_(torch.nextafter(w, torch.full_like(w, math.inf)))
    return out


def ef_rows(sim):
    """The error-feedback arena's client rows, on the CPU; row N is the
    padding rows' dummy, which no result reads."""
    return sim._ef_arena[:-1].cpu().numpy()


def compare_card_cpu(T, parity, spec, params, card_records, quantize,
                     ref):
    """``spec`` on the card and on the CPU from the same weights; returns
    the comparison line's fields. With compression the runs go round by
    round: the error feedback is held to ``parity.ef_mismatches`` after
    round 0, and each round prints how many of its elements lie beyond
    ``parity.EF_RTOL``, card against CPU and card against a card run from
    weights one ulp apart (``nudged``)."""
    sims = {dev: T.build_simulation(spec, device=dev, params=params)
            for dev in ("cuda", "cpu")}
    card, cpu = sims["cuda"], sims["cpu"]
    problems, out = [], {}
    if spec.resolve_strategy().quantize_updates:
        codes, off = {}, {}
        for dev, sim in sims.items():
            codes[dev], off[dev] = run_round0_codes(sim, quantize, ref)
        if off["cuda"]:
            problems.append(f"round 0: {off['cuda']} elements of the card's "
                            f"round trips differ by bits from the plain "
                            f"version on the same inputs")
        problems += parity.ef_mismatches(ef_rows(card), ef_rows(cpu))
        twin = T.build_simulation(spec, device="cuda", params=nudged(params))
        twin.run(1)
        flips = {"card_vs_cpu": [], "card_vs_nudged_card": []}
        for rnd in range(spec.rounds):
            if rnd:
                for sim in (card, cpu, twin):
                    sim.run(1)
            flips["card_vs_cpu"].append(parity.ef_flips(ef_rows(card),
                                                        ef_rows(cpu)))
            flips["card_vs_nudged_card"].append(
                parity.ef_flips(ef_rows(twin), ef_rows(card)))
        out = dict(round0_codes=codes["cpu"].numel(),
                   round0_codes_differing=int((codes["cuda"]
                                               != codes["cpu"]).sum()),
                   round0_kernel_elements_off_plain=off["cuda"],
                   ef_elements=ef_rows(cpu).size,
                   ef_elements_beyond_rtol_per_round=flips)
    else:
        for sim in sims.values():
            sim.run(spec.rounds)
    problems += (parity.theta_band_violations(card.theta_ratios, 0.65)
                 + parity.theta_band_violations(cpu.theta_ratios, 0.65))
    card_recs = T.result_from_simulation(spec, card).records
    cpu_recs = T.result_from_simulation(spec, cpu).records
    problems += parity.record_mismatches(card_recs, cpu_recs)
    problems += parity.record_mismatches(card_records, cpu_recs)
    if {c: dataclasses.asdict(r) for c, r in card.selector.records.items()} \
            != {c: dataclasses.asdict(r)
                for c, r in cpu.selector.records.items()}:
        problems.append("selector records differ")
    if card.failure_log != cpu.failure_log:
        problems.append("dropout draws differ")
    if [l.batch_size for l in card.loaders] != \
            [l.batch_size for l in cpu.loaders]:
        problems.append("batch sizes differ")
    ratio_gap = max((abs(a[2] - b[2]) for a, b in
                     zip(card.theta_ratios, cpu.theta_ratios)), default=0.0)
    out.update(problems=problems, theta_tests=len(card.theta_ratios),
               max_ratio_gap=ratio_gap,
               min_ratio_distance_to_theta=min(
                   (abs(x[2] - 0.65) for x in card.theta_ratios),
                   default=None),
               max_loss_rel_gap=max(abs(a.loss - b.loss) / abs(b.loss)
                                    for a, b in zip(card_recs, cpu_recs)),
               max_acc_gap=max(abs(a.accuracy - b.accuracy)
                               for a, b in zip(card_recs, cpu_recs)))
    return out


# (name, layout, shape, dtype, causal, window, Sk): "flat" is (BH, S, hd)
# through flash_attention, "gqa" (B, S, H, K, hd) through flash_attention_gqa
FLASH_CASES = (
    ("qwen2 prefill flat", "flat", (48, 2048, 128), "bfloat16", True, None,
     None),
    ("qwen2 prefill", "gqa", (4, 2048, 12, 2, 128), "bfloat16", True, None,
     None),
    ("qwen2 prefill K=H", "gqa", (4, 2048, 12, 12, 128), "bfloat16", True,
     None, None),
    ("f32 causal", "flat", (12, 512, 32), "float32", True, None, None),
    ("f32 full", "flat", (12, 512, 32), "float32", False, None, None),
    ("S 512 Sk 1024", "flat", (8, 512, 128), "bfloat16", False, None, 1024),
    ("hd 64", "gqa", (2, 1024, 8, 2, 64), "bfloat16", True, None, None),
    ("hd 96", "gqa", (2, 1024, 8, 2, 96), "bfloat16", True, None, None),
    ("window 256", "gqa", (2, 1024, 12, 2, 128), "bfloat16", True, 256,
     None),
    ("hd 32 bf16", "gqa", (2, 1024, 8, 2, 32), "bfloat16", True, None, None),
    ("qwen2 2-layer f32", "gqa", (1, 512, 12, 2, 128), "float32", True, None,
     None),
)
# the main path's case of each kernel: the blockwise bf16 serve runs the
# wgmma kernel, the 2-layer f32 card-vs-CPU run the SIMT one
FLASH_MAIN = {"wgmma": "qwen2 prefill", "simt": "qwen2 2-layer f32"}
FLASH_SOURCES = {"wgmma": "src/repro_torch/csrc/flash_attn_wgmma.cu",
                 "simt": "src/repro_torch/csrc/flash_attn.cu"}


def flash_inputs(layout, shape, dtype, Sk=None, seed=0):
    """N(0, 1) q, k, v on the card, made in f32 and rounded to ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "flat":
        BH, S, hd = shape
        qs, ks = (BH, S, hd), (BH, Sk or S, hd)
    else:
        B, S, H, K, hd = shape
        qs, ks = (B, S, H, hd), (B, Sk or S, K, hd)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(sh, generator=g, device="cuda").to(dt)
                 for sh in (qs, ks, ks))


def plain_gqa(ref, q, k, v, causal, window):
    """The plain version in the (B, S, H, hd) layout, as the wrapper takes
    it on the CPU (heads flattened, query row b·H + h reading KV row
    b·K + h // G)."""
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    flat = ref.flash_attention(
        q.transpose(1, 2).reshape(B * H, S, hd),
        k.transpose(1, 2).reshape(B * K, Sk, hd),
        v.transpose(1, 2).reshape(B * K, Sk, hd), causal, window,
        kv_groups=H // K)
    return flat.reshape(B, H, S, hd).transpose(1, 2)


def flash_excess(got, want) -> float:
    """Largest excess of |got − want| over the tolerance: f32 1e-5; bf16
    one bf16 ulp of the larger magnitude plus 1e-5 (both round once from
    f32 values up to 1e-5 apart)."""
    gap = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        big = torch.maximum(got.float().abs(), want.float().abs())
        return float((gap - bf16_ulp(big) - 1e-5).max())
    return float((gap - 1e-5).max())


def flash_work(layout, shape, causal, window, Sk, itemsize):
    """(bytes, FLOPs) this call's data needs: q, k, v read once and o
    written once; 4·hd FLOPs (two products) for every unmasked score."""
    if layout == "flat":
        (BH, S, hd), H, K, B = shape, 1, 1, shape[0]
    else:
        B, S, H, K, hd = shape
    Sk = Sk or S
    i = torch.arange(S, dtype=torch.int64)[:, None]
    j = torch.arange(Sk, dtype=torch.int64)[None, :]
    keep = torch.ones((S, Sk), dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= (i - j) < window
    pairs = int(keep.sum()) * B * H
    nbytes = (2 * B * S * H + 2 * B * Sk * K) * hd * itemsize
    return nbytes, 4 * hd * pairs


def wgmma_ptxas(log: str, flash_attn) -> list:
    """``-Xptxas -v`` of csrc/flash_attn_wgmma.cu, one entry per
    instantiation (hd, output type): registers at launch (the consumers
    take 240 after setmaxnreg), spill bytes, dynamic shared memory."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and "flash_wgmma_kernel" in m.group(1):
            t = re.search(r"ILi(\d+)E(\w+?)EEv", m.group(1))
            hd = int(t.group(1))
            cur = dict(hd=hd, out="bf16" if "bfloat16" in t.group(2) else
                       "f32", smem_bytes=flash_attn.wgmma_smem_bytes(hd))
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            cur.update(spill_stores=int(st), spill_loads=int(ld))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            cur = None
    return out


def phase_flash(flash_attn, ref) -> dict:
    """Hold flash_attention to its plain version at every listed shape,
    each through the kernel its route names (bf16 at hd 64/96/128 must be
    "wgmma"); time each beside its bound, its plain version and SDPA, and
    at the wgmma kernel's main case the SIMT kernel on the same inputs."""
    F = torch.nn.functional
    rows, err = {}, dict.fromkeys(FLASH_MAIN, 0.0)
    for name, layout, shape, dtype, causal, window, Sk in FLASH_CASES:
        q, k, v = flash_inputs(layout, shape, dtype, Sk)
        which = flash_attn.route(q.dtype, shape[-1])
        if dtype == "bfloat16" and shape[-1] in (64, 96, 128) and \
                which != "wgmma":
            raise AssertionError(f"{name}: bf16 hd {shape[-1]} routes to "
                                 f"{which}, not wgmma")
        if layout == "flat":
            call = functools.partial(flash_attn.flash_attention, q, k, v,
                                     causal=causal)
            plain = functools.partial(ref.flash_attention, q, k, v, causal)
            sdpa = functools.partial(F.scaled_dot_product_attention,
                                     q[None], k[None], v[None],
                                     is_causal=causal)
        else:
            call = functools.partial(flash_attn.flash_attention_gqa, q, k, v,
                                     causal=causal, sliding_window=window)
            plain = functools.partial(plain_gqa, ref, q, k, v, causal, window)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None
            if window is not None:
                S = q.shape[1]
                i = torch.arange(S, device="cuda")[:, None]
                j = torch.arange(S, device="cuda")[None, :]
                mask = (j <= i) & ((i - j) < window)
            sdpa = functools.partial(
                F.scaled_dot_product_attention, qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
        before = dict(flash_attn.launches_by_route)
        got, want = call(), plain()
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in
                flash_attn.launches_by_route.items()}
        if took != {r: int(r == which) for r in took}:
            raise AssertionError(f"{name}: route {which}, launches {took}")
        excess = flash_excess(got, want)
        gap = float((got.float() - want.float()).abs().max())
        if got.dtype != q.dtype or got.shape != want.shape or \
                not excess <= 0.0:
            raise AssertionError(f"flash_attention differs from its plain "
                                 f"version at {name} {shape} {dtype}: excess "
                                 f"{excess}, max gap {gap}")
        err[which] = max(err[which], gap)
        nbytes, flops = flash_work(layout, shape, causal, window, Sk,
                                   q.element_size())
        rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / rate * 1e3
        line = dict(name="flash_attention", case=name, route=which,
                    layout=layout, shape=list(shape), dtype=dtype,
                    causal=causal,
                    window=window, sk=Sk, max_abs_err=gap,
                    elements_differing=int((got != want).sum()),
                    ms=time_ms(call, iters=10, warmup=2),
                    device_ms=graph_ms(call, per_graph=3, replays=3),
                    plain_ms=time_ms(plain, iters=3, warmup=1),
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=time_ms(sdpa, iters=10, warmup=2),
                    library_device_ms=graph_ms(sdpa, per_graph=3,
                                               replays=3))
        if name == FLASH_MAIN["wgmma"]:
            # the SIMT kernel on the same bf16 inputs, for the old time
            # beside the new one on one card
            out = torch.empty(q.shape, dtype=q.dtype, device="cuda")
            simt = functools.partial(flash_attn._enqueue, q, k, v, out,
                                     causal, window, "simt")
            line.update(simt_ms=time_ms(simt, iters=5, warmup=1),
                        simt_device_ms=graph_ms(simt, per_graph=2,
                                                replays=2))
            if not line["device_ms"] < line["simt_device_ms"]:
                raise AssertionError(
                    f"{name}: the wgmma kernel ({line['device_ms']} ms) is "
                    f"not faster than the SIMT one ({line['simt_device_ms']})")
            del out
        emit("kernels", **line)
        for r, case in FLASH_MAIN.items():
            if name == case:
                rows[r] = {k: line[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "simt_ms",
                    "simt_device_ms") if k in line}
        del q, k, v, got, want
    return {("flash_attention" if r == "wgmma" else "flash_attention_simt"):
            dict(route="cuda", kernel=r, source=FLASH_SOURCES[r],
                 replaces="src/repro/kernels/flash_attn.py:71",
                 max_abs_err=err[r], **rows[r]) for r in FLASH_MAIN}


class ServeRecorder:
    """Wraps the transformer's ``prefill`` and ``decode_step`` for one
    ``serve_lm`` call: the prefill's logits, the kernel launches when the
    prefill ends and the times at its end and at the first decode step,
    each after a synchronisation."""

    def __init__(self, transformer, flash_attn):
        self.tf, self.fa = transformer, flash_attn

    def __enter__(self):
        self.prefill, self.decode = self.tf.prefill, self.tf.decode_step
        self.logits, self.t_decode = None, None

        def prefill(*a, **k):
            out = self.prefill(*a, **k)
            torch.cuda.synchronize()
            self.t_prefill = time.perf_counter()
            self.prefill_routes = dict(self.fa.launches_by_route)
            self.logits = out[0]
            return out

        def decode_step(*a, **k):
            if self.t_decode is None:
                torch.cuda.synchronize()
                self.t_decode = time.perf_counter()
            return self.decode(*a, **k)

        self.tf.prefill, self.tf.decode_step = prefill, decode_step
        return self

    def __exit__(self, *exc):
        self.tf.prefill, self.tf.decode_step = self.prefill, self.decode


def serve_run(serve, transformer, mods, cfg, params, batch, prompt_len,
              steps) -> dict:
    """``serve_lm`` on the card with every launch count set to 0 just
    before; returns its tokens, prefill logits, times, launches and peak
    memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    with ServeRecorder(transformer, mods["flash_attn"]) as rec:
        t0 = time.perf_counter()
        toks = serve.serve_lm(cfg, batch, prompt_len, steps, device="cuda",
                              params=params)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    launches = read_launches(mods)
    prefill = sum(rec.prefill_routes.values())
    return dict(tokens=toks, logits=rec.logits,
                prefill_s=rec.t_prefill - t0, decode_s=t_end - rec.t_decode,
                decode_tokens_per_s=batch * steps / (t_end - rec.t_decode),
                launches=launches, prefill_launches=prefill,
                prefill_routes=rec.prefill_routes,
                decode_launches=mods["flash_attn"].launches - prefill,
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def teacher_forced(model_api, cfg, params, prompt, feed, device) -> list:
    """Prefill ``prompt`` on ``device``, graft the cache, then decode the
    tokens ``feed`` (B, n) one by one; returns the logits of the prefill
    and of each step, on the CPU in f32."""
    B, S = prompt.shape
    logits, cache = model_api.prefill(params, {"tokens": prompt.to(device)},
                                      cfg)
    full = model_api.init_cache(cfg, B, S + feed.shape[1], device=device)
    for name in ("k", "v"):
        full[name][:, :, :S] = cache[name]
    full["step"] = S
    out = [logits.float().cpu()]
    for i in range(feed.shape[1]):
        logits, full = model_api.decode_step(
            params, full, {"tokens": feed[:, i:i + 1].to(device)}, cfg)
        out.append(logits.float().cpu())
    return out


def phase_lm(mods) -> dict:
    """qwen2-1.5b serving at full width, blockwise and full attention; the
    2-layer f32 card-vs-CPU check; a traced warm prefill. Returns the
    launches of the blockwise run and of the 2-layer f32 card run."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    base = registry.get_config("qwen2-1.5b")
    blockwise = base.replace(attention_impl="blockwise")
    batch, prompt_len, steps = 4, 2048, 16
    t0 = time.perf_counter()
    params = model_api.init_params(torch.Generator(device="cuda").manual_seed(0),
                                   blockwise, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit("slice", run="qwen2-1.5b weights", params=n_params,
         param_count=blockwise.param_count(),
         bytes=sum(t.numel() * t.element_size() for t in _leaves(params)),
         draw_s=time.perf_counter() - t0)
    serve.serve_lm(blockwise, 1, 512, 1, device="cuda", params=params)  # warm

    runs = {}
    for run, cfg in (("qwen2-1.5b serve blockwise", blockwise),
                     ("qwen2-1.5b serve full", base)):
        r = serve_run(serve, transformer, mods, cfg, params, batch,
                      prompt_len, steps)
        toks, logits = r["tokens"], r["logits"]
        # greedy argmax runs over the padded vocabulary, as in JAX
        ok = (tuple(toks.shape) == (batch, 1 + steps)
              and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all())
              and bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == (batch, prompt_len,
                                          cfg.padded_vocab))
        emit("slice", run=run, arch=cfg.name, layers=cfg.num_layers,
             attention_impl=cfg.attention_impl, batch=batch,
             prompt_len=prompt_len, decode_steps=steps,
             prefill_s=r["prefill_s"], decode_s=r["decode_s"],
             decode_tokens_per_s=r["decode_tokens_per_s"],
             peak_memory_bytes=r["peak_memory_bytes"],
             launches=r["launches"],
             flash_launches_prefill=r["prefill_launches"],
             flash_routes_prefill=r["prefill_routes"],
             flash_launches_decode=r["decode_launches"],
             tokens_row0=toks[0].tolist(), well_formed=ok)
        if not ok:
            raise AssertionError(f"{run}: tokens or logits malformed")
        want = cfg.num_layers if cfg.attention_impl == "blockwise" else 0
        if r["prefill_routes"] != {"wgmma": want, "simt": 0} or \
                r["decode_launches"] != 0:
            raise AssertionError(
                f"{run}: flash_attention launched {r['prefill_routes']} "
                f"times in the prefill (want {want}, all wgmma) and "
                f"{r['decode_launches']} in the decode (want 0)")
        runs[run] = r
    a, b = (runs[k] for k in ("qwen2-1.5b serve blockwise",
                              "qwen2-1.5b serve full"))
    emit("slice", run="qwen2-1.5b serve blockwise vs full",
         prefill_logit_gap_rel=float((a["logits"].float() - b["logits"].float())
                                     .abs().max()
                                     / b["logits"].float().abs().max()),
         argmax_agreement=float((a["logits"].argmax(-1)
                                 == b["logits"].argmax(-1)).float().mean()),
         tokens_equal=int((a["tokens"] == b["tokens"]).sum()),
         tokens=a["tokens"].numel())
    launches = runs["qwen2-1.5b serve blockwise"]["launches"]
    del runs, a, b

    # a warm blockwise prefill, traced
    prompt = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, base.vocab_size, size=(batch, prompt_len)), device="cuda")}
    with torch.no_grad():
        model_api.prefill(params, prompt, blockwise)
        line = trace(lambda: model_api.prefill(params, prompt, blockwise),
                     share_of="flash_wgmma_kernel")
    emit("trace", run="qwen2-1.5b prefill blockwise", batch=batch,
         prompt_len=prompt_len, **line)
    del params, prompt

    # two layers in f32, card (kernel) against CPU (plain), same weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = blockwise.replace(num_layers=2, dtype="float32")
    cpu_params = model_api.init_params(torch.Generator().manual_seed(0), small,
                                       "cpu")
    card_params = transformer.tree_to(cpu_params, "cuda")
    # the CPU's greedy tokens after serve_lm's prompt (seed 0) are fed to
    # both devices' decode steps
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, small.vocab_size, size=(1, 512)))
    feed = serve.serve_lm(small, 1, 512, 4, device="cpu",
                          params=cpu_params)[:, :4]
    with torch.no_grad():
        cpu_logits = teacher_forced(model_api, small, cpu_params, prompt,
                                    feed, "cpu")
        torch.cuda.synchronize()
        reset_launches(mods)
        card_logits = teacher_forced(model_api, small, card_params, prompt,
                                     feed, "cuda")
        torch.cuda.synchronize()
        card_launches = mods["flash_attn"].launches
        f32_launches = read_launches(mods)
    problems, gaps = [], []
    for i, (c, g) in enumerate(zip(card_logits, cpu_logits)):
        gap = float((c - g).abs().max() / g.abs().max())
        gaps.append(gap)
        if not gap <= 1e-4:
            problems.append(f"{'prefill' if i == 0 else f'decode {i}'}: "
                            f"logit gap {gap} of max|logit|")
    if f32_launches["flash_attention_simt"] != small.num_layers or \
            card_launches != small.num_layers:
        problems.append(f"flash_attention launched {card_launches} times, "
                        f"{f32_launches['flash_attention_simt']} on the SIMT "
                        f"kernel, not {small.num_layers} (f32 takes it)")
    emit("card_vs_cpu", run="qwen2-1.5b 2-layer f32", layers=2, batch=1,
         prompt_len=512, decode_steps=4,
         allow_tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                         cudnn=torch.backends.cudnn.allow_tf32),
         logit_gap_rel=gaps, flash_launches=card_launches, problems=problems)
    if problems:
        raise AssertionError("qwen2 card vs CPU: " + "; ".join(problems))
    return {"qwen2-1.5b serve blockwise": launches,
            "qwen2-1.5b 2-layer f32": f32_launches}


SESSION_PATHS = {  # name -> (spec maker, rounds, checkpoint after, kernels)
    "ours+int8 megastep": (
        lambda T: dataclasses.replace(
            quickstart_spec(T, "ours", quantize=True), rounds=6),
        6, 3, ("per_client_sign_align", "masked_agg", "ef_round_trip")),
    "ours+int8 scanned fused R=4": (
        lambda T: dataclasses.replace(
            quickstart_spec(T, "ours", quantize=True), fused_eval=True,
            rounds_per_dispatch=4),
        8, 2, ("per_client_sign_align", "masked_agg", "ef_round_trip",
               "cohort_gather")),
    "cmfl+int8 spmd": (
        lambda T: dataclasses.replace(spmd_spec(T, "cmfl", True), rounds=6),
        6, 3, ("per_client_sign_align", "masked_agg", "ef_round_trip")),
    "ours+int8 loop": (
        lambda T: dataclasses.replace(
            quickstart_spec(T, "ours", quantize=True, megastep=False),
            rounds=3),
        3, 1, CODEC),
}


def cuda_tensors(tree) -> int:
    """How many tensors of a nested state (dicts, lists, tuples,
    NamedTuples) live on a CUDA device."""
    if torch.is_tensor(tree):
        return int(tree.is_cuda)
    if isinstance(tree, dict):
        return sum(cuda_tensors(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(cuda_tensors(v) for v in tree)
    return 0


def same_params(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def resumed_launches(run: str, spec, launches: dict, needed,
                     rounds: int) -> dict:
    """Each kernel of ``needed`` launched at least once a resumed round
    (the scanned gather exactly once a round); returns launches a round."""
    for k in needed:
        if launches[k] < rounds:
            raise AssertionError(f"{run}: {k} launched {launches[k]} times "
                                 f"in {rounds} resumed rounds")
    if spec.rounds_per_dispatch and launches["cohort_gather"] != rounds:
        raise AssertionError(f"{run}: cohort_gather launched "
                             f"{launches['cohort_gather']} times in "
                             f"{rounds} resumed rounds")
    return {k: launches[k] / rounds for k in needed}


def session_path(T, parity, run: str, params, mods, tmp: str) -> dict:
    """One path of the session phase (module docstring, 6e): an
    uninterrupted session against one checkpointed after k rounds and
    restored on the card, equal by bits; the kernels' launches in the
    resumed rounds; the checkpoint's bytes and ms; on the megastep and
    spmd paths the card's checkpoint restored on the CPU for one round,
    held to the card's same round by ``parity.record_mismatches``."""
    make, rounds, k, needed = SESSION_PATHS[run]
    spec = make(T)
    S = T.ExperimentSession
    full = S.open(spec, device="cuda", params=params)
    full.run(rounds)
    part = S.open(spec, device="cuda", params=params)
    part.run(k)
    path = f"{tmp}/{run.replace(' ', '_')}.ckpt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part.checkpoint(path)
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    payload = pickle.loads(open(path, "rb").read())
    torch.cuda.synchronize()
    with rows_per_call(mods):
        reset_launches(mods)
        t0 = time.perf_counter()
        resumed = S.restore(path, device="cuda")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        resumed.run(rounds - k)
        torch.cuda.synchronize()
        launches = read_launches(mods)
    problems = []
    if not same_records(full.records, resumed.records):
        problems.append("records differ: " + "; ".join(
            f"{a} != {b}" for a, b in zip(full.records, resumed.records)
            if repr(dataclasses.astuple(a)) != repr(dataclasses.astuple(b))))
    if not same_params(full.result().params, resumed.result().params):
        problems.append("final parameters differ")
    if resumed.engine.theta_ratios != full.engine.theta_ratios:
        problems.append("θ tests differ")
    line = dict(run=run, rounds=rounds, checkpoint_after=k,
                equal_by_bits=not problems, problems=problems,
                payload_bytes=os.path.getsize(path),
                cuda_tensors_in_payload=cuda_tensors(payload),
                checkpoint_ms=ckpt_ms, restore_ms=restore_ms,
                resumed_launches=launches,
                launches_per_resumed_round=resumed_launches(
                    run, spec, launches, needed, rounds - k))
    if not all(math.isfinite(r.loss) and math.isfinite(r.accuracy)
               for r in resumed.records):
        problems.append("accuracy or loss not finite")
    if line["cuda_tensors_in_payload"]:
        problems.append("the payload holds CUDA tensors")
    if run in ("ours+int8 megastep", "cmfl+int8 spmd"):
        kw = ({"agg_dtype": torch.float32} if spec.engine == "spmd"
              else {})
        cpu = S.restore(path, device="cpu", **kw)
        got = cpu.run(1)
        cpu_problems = parity.record_mismatches(
            got, full.records[k:k + 1]) + parity.theta_band_violations(
                [t for t in full.engine.theta_ratios if t[0] == k]
                + [t for t in cpu.engine.theta_ratios if t[0] == k], 0.65)
        emit("card_vs_cpu", run=f"{run} restored on the CPU", round=k,
             problems=cpu_problems)
        problems += [f"card to CPU: {p}" for p in cpu_problems]
    emit("session", **line)
    if problems:
        raise AssertionError(f"session {run}: " + "; ".join(problems))
    return dict(payload_bytes=line["payload_bytes"], checkpoint_ms=ckpt_ms,
                restore_ms=restore_ms)


def phase_session(T, parity, params, mods, smi: str) -> None:
    """The session phase (module docstring, 6e)."""
    import importlib.util
    t_phase = time.perf_counter()
    cost = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in SESSION_PATHS:
            cost[run] = session_path(T, parity, run, params, mods, tmp)
        has_msgpack = importlib.util.find_spec("msgpack") is not None
        io_line = dict(msgpack_installed=has_msgpack)
        if has_msgpack:
            from repro_torch.checkpoint import io as ckpt_io
            on_card = {k: v.to("cuda") for k, v in params.items()}
            ckpt_io.save(f"{tmp}/params.msgpack", on_card)
            back = ckpt_io.restore(f"{tmp}/params.msgpack", on_card)
            io_line["io_round_trip_equal"] = same_params(back, on_card)
            if not io_line["io_round_trip_equal"]:
                raise AssertionError("checkpoint io round trip differs")
        emit("session", **io_line)

    # run_experiment goes through a session: equal by bits to the engine
    # driven directly
    spec = dataclasses.replace(quickstart_spec(T, "ours", quantize=True),
                               rounds=4)
    res = T.run_experiment(spec, device="cuda", params=params)
    sim = T.build_simulation(spec, device="cuda", params=params)
    sim.run(spec.rounds, eval_final=True)
    direct = T.result_from_simulation(spec, sim)
    equal = (same_records(res.records, direct.records)
             and same_params(res.params, direct.params))
    emit("session", run="run_experiment vs direct drive", rounds=4,
         equal_by_bits=equal)
    if not equal:
        raise AssertionError("run_experiment differs from the direct drive")

    # a small sweep on the spmd engine: ours (its synchronous form, as the
    # spmd engine runs no quorum clock) against fedavg, 3 seeds each
    base = dataclasses.replace(
        spmd_spec(T, "ours"), rounds=4,
        strategy_kwargs=dict(batch_size=64, lr=3e-2, local_epochs=2,
                             mode="sync", dynamic_batch=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = T.run_sweep(base, axes={"strategy": ["ours", "fedavg"],
                                    "seed": range(3)}, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cmp = sweep.mann_whitney_u("strategy", "ours", "fedavg",
                               metric="accuracy", alternative="greater")
    report = sweep.report("accuracy", baseline="fedavg")
    print(report, flush=True)
    emit("session", run="run_sweep spmd ours vs fedavg", seeds=3, rounds=4,
         wall_s=wall, u=cmp.u, p_value=cmp.p_value, n=[cmp.n_a, cmp.n_b],
         accuracy={g: v.tolist() for g, v in sweep.groups().items()})
    if not (0.0 <= cmp.p_value <= 1.0 and cmp.n_a == cmp.n_b == 3):
        raise AssertionError(f"sweep: {cmp}")
    emit("session_phase", seconds=time.perf_counter() - t_phase,
         checkpoint_cost=cost, nvidia_smi=smi)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import repro_torch as T
    from repro_torch.api import parity
    from repro_torch.core import compression
    from repro_torch.kernels import (_build, _launch, flash_attn, gather,
                                     masked_agg, ops, quantize, ref,
                                     sign_align)
    from repro_torch.models import api as model_api

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    mods = {"sign_align": sign_align, "masked_agg": masked_agg,
            "quantize": quantize, "gather": gather, "flash_attn": flash_attn,
            "compression": compression}
    if sys.argv[1:] == ["--sign-eager"]:
        sign_eager(sign_align, smi)
        return 0
    if sys.argv[1:] == ["--session"]:
        _build.build_all()
        cfg = quickstart_spec(T, "ours").resolve_model()
        params = model_api.init_params(torch.Generator().manual_seed(0), cfg)
        phase_session(T, parity, params, mods, smi)
        return 0
    if sys.argv[1:] == ["--lazy-world"]:
        _build.build_all()
        cfg = quickstart_spec(T, "ours").resolve_model()
        params = model_api.init_params(torch.Generator().manual_seed(0), cfg)
        emit("lazy_world", **lazy_timed(T, params, mods, smi)[0])
        return 0
    emit("device", nvidia_smi=smi, kind=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; they would move the θ "
                             "ratios")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         ptxas={k: [l for l in v.splitlines() if "registers" in l]
                for k, v in logs.items()})
    if "flash_attn_wgmma" in logs:
        report = wgmma_ptxas(logs["flash_attn_wgmma"], flash_attn)
        emit("build", source="src/repro_torch/csrc/flash_attn_wgmma.cu",
             ptxas=report)
        spills = [r for r in report if r["spill_stores"] or r["spill_loads"]]
        if spills:
            raise AssertionError(f"flash_attn_wgmma spills: {spills}")

    # 3. kernels
    rows = phase_kernels(sign_align, masked_agg, ref)
    rows.update(phase_quantize(quantize, gather, _launch, ref))
    rows.update(phase_gather(quantize, gather, _launch, ref))
    phase_launch(quantize, gather, masked_agg, sign_align, _launch)
    rows.update(phase_spmd_kernels(sign_align, masked_agg, ref))
    rows.update(phase_flash(flash_attn, ref))

    # 4. slice: the quickstart spec on the card. Each run sets every launch
    # count to 0 just before it and reads them just after.
    cfg = quickstart_spec(T, "ours").resolve_model()
    params = model_api.init_params(torch.Generator().manual_seed(0), cfg)
    scanned = dict(rounds_per_dispatch=4)
    # the int8 cohort paths (megastep, scanned, spmd) run the error-feedback
    # round trip in one kernel; the per-client loop runs the codec pair
    cohort_int8 = ("per_client_sign_align", "masked_agg", "ef_round_trip")
    engine_kernels = cohort_int8 + ("cohort_gather",)
    runs = {  # name -> (spec, kernels that must launch)
        "fedavg": (quickstart_spec(T, "fedavg"), ("masked_agg",)),
        "ours": (quickstart_spec(T, "ours"),
                 ("per_client_sign_align", "masked_agg")),
        "ours+int8": (quickstart_spec(T, "ours", quantize=True),
                      cohort_int8),
        "ours+int8 loop": (quickstart_spec(T, "ours", quantize=True,
                                           megastep=False), CODEC),
        "ours+int8 scanned fused": (dataclasses.replace(
            quickstart_spec(T, "ours", quantize=True), fused_eval=True,
            **scanned), engine_kernels),
        "ours+int8 scanned half": (dataclasses.replace(
            quickstart_spec(T, "ours", quantize=True, select_fraction=0.5),
            **scanned), engine_kernels),
        "fedavg scanned": (dataclasses.replace(
            quickstart_spec(T, "fedavg"), **scanned), ("masked_agg",)),
    }
    finals, sims, launches = {}, {}, {}
    for run, (spec, needed) in runs.items():
        sim, wall, launches[run], by_rows = run_card(T, spec, params,
                                                     mods)
        res = T.result_from_simulation(spec, sim, wall_time=wall)
        for rec in res.records:
            emit("slice", run=run, **dataclasses.asdict(rec))
        emit("slice", run=run, megastep=spec.megastep,
             rounds_per_dispatch=spec.rounds_per_dispatch,
             fused_eval=spec.fused_eval, rounds=len(res.records),
             wall_s=wall, wall_s_per_round=wall / len(res.records),
             dispatches=sim.dispatches, launches=launches[run],
             rows_per_call=rows_line(by_rows), cohorts=sim.cohorts or None)
        # the scanned path without fused eval evaluates at the end of each
        # dispatch, so its first rounds carry NaN
        first_eval = (spec.rounds_per_dispatch - 1 if
                      spec.rounds_per_dispatch and not spec.fused_eval else 0)
        if not (all(math.isfinite(r.loss) for r in res.records) and all(
                math.isfinite(r.accuracy) for r in res.records[first_eval:])):
            raise AssertionError(f"{run}: accuracy or loss not finite")
        held_launches(run, launches[run], needed, by_rows)
        if "int8 scanned" in run and launches[run]["cohort_gather"] != \
                spec.rounds:
            raise AssertionError(f"{run}: cohort_gather launched "
                                 f"{launches[run]['cohort_gather']} times, "
                                 f"not once a round")
        finals[run], sims[run] = res, sim
    emit("slice", run="ours+int8 scanned half",
         sync_free_dispatch=sync_free_dispatch(
             T, runs["ours+int8 scanned half"][0], params))
    phase_trace(T, runs["ours+int8 scanned fused"][0], runs["ours+int8"][0],
                params)
    base = finals["fedavg"].final
    for run in ("ours", "ours+int8"):
        final = finals[run].final
        emit("slice", run=run, headline=dict(
            time_reduction_pct=100 * (1 - final.sim_time / base.sim_time),
            bytes_saving_pct=100 * (1 - final.bytes_sent
                                    / max(base.bytes_sent, 1)),
            accuracy_delta_pts=100 * (final.accuracy - base.accuracy)),
            note="simulated seconds and bytes of the experiment against "
                 "fedavg, not card speed")

    # 5. card vs CPU, from the same weights; the card's loop against its
    # megastep
    problems = []
    for run in ("ours", "ours+int8"):
        line = compare_card_cpu(T, parity, runs[run][0], params,
                                finals[run].records, quantize, ref)
        emit("card_vs_cpu", run=run, **line)
        problems += [f"{run}: {p}" for p in line["problems"]]
    loop_vs_mega = parity.path_mismatches(finals["ours+int8 loop"].records,
                                          finals["ours+int8"].records)
    emit("loop_vs_megastep", run="ours+int8", problems=loop_vs_mega)
    problems += [f"loop vs megastep: {p}" for p in loop_vs_mega]
    run = "ours+int8 scanned half"
    line, _cpu = scanned_card_cpu(T, parity, runs[run][0], params,
                                  sims[run])
    emit("card_vs_cpu", run=run, **line)
    problems += [f"{run}: {p}" for p in line["problems"]]
    run = "ours+int8 scanned fused"
    single, _wall, _l, _r = run_card(T, dataclasses.replace(
        runs[run][0], rounds_per_dispatch=1), params, mods)
    grouping = [] if single.history == sims[run].history else [
        f"round {a.round}: {a} != {b}"
        for a, b in zip(sims[run].history, single.history) if a != b]
    if single.cohorts != sims[run].cohorts:
        grouping.append("selections differ")
    emit("r4_vs_r1", run=run, equal=not grouping, problems=grouping,
         dispatches=[sims[run].dispatches, single.dispatches])
    problems += [f"{run} R=4 vs R=1: {p}" for p in grouping]
    if problems:
        raise AssertionError("runs disagree: " + "; ".join(problems))

    # 6. the kernel-ops API and the spmd engine
    launches["ops"] = phase_ops(T, ops, params, mods)
    launches.update(phase_spmd(T, parity, params, mods))

    # 6b. dynamic worlds on the four ported paths
    launches.update(phase_scenario(T, parity, params, mods, smi))

    # 6c. hierarchical topologies on the four ported paths
    launches.update(phase_topology(T, parity, sign_align, ref, params, mods,
                                   smi))

    # 6d. world scale: the population plane, two-stage selection and
    # non-resident worlds
    launches.update(phase_population(T, parity, sign_align, masked_agg,
                                     quantize, ref, params, mods, smi))

    # 6e. sessions: checkpoint, restore and resume on the four paths
    phase_session(T, parity, params, mods, smi)

    # 7. LM serving at qwen2-1.5b's full width
    launches.update(phase_lm(mods))

    # launches on each kernel's main path: the megastep int8 run for the
    # three kernels it runs, the per-client int8 loop for the codec pair,
    # the fused scanned int8 run for the gather, the ops phase for the two
    # kernels that only the ops API reaches, the blockwise qwen2-1.5b
    # serving run for the wgmma flash kernel and the 2-layer f32 card run
    # for the SIMT one
    main_run = dict.fromkeys(rows, "ours+int8")
    main_run.update(dict.fromkeys(CODEC, "ours+int8 loop"))
    main_run["cohort_gather"] = "ours+int8 scanned fused"
    main_run["fused_update"] = main_run["sign_align_counts"] = "ops"
    main_run["flash_attention"] = "qwen2-1.5b serve blockwise"
    main_run["flash_attention_simt"] = "qwen2-1.5b 2-layer f32"
    print(json.dumps({"kernels": [
        {"name": k, **row, "launches": launches[main_run[k]][k]}
        for k, row in rows.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
