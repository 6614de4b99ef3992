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
               7 rows, f32 and bf16, counts equal. Past 2^31 slots
               (``sign_past_int32``): both sign counts at C 1 × R 2,200,000
               f32 against reference signs sign(u) (n = 2,252,800,000
               matches, exact in f32) and with one slot padded (n − 1,
               which rounds), and the grouped form at C 2 × P 2 at the same
               R, equal by bits to the plain version and to the exact
               counts in f32, each with its chunks and blocks, timed beside
               its bound by bytes; every chunked launch's int32 partials,
               read back, equal to the plain count of each chunk
               (``held_partials``), there and where f32 counts are exact
               and the chunks' edges uneven (``sign_chunk_edges``: C 1 × R
               8,192, 16,383 and 12,289, grouped C 2 and 4 × P 2 × R
               16,383, random reference signs; both wrappers, f32 and bf16
               counts, equal by bits). The timed rows of the
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
  6f. serving — the detector behind ``repro_torch.serve`` on the card,
               after examples/continuous_federation.py at full width
               (``anomaly-mlp``; 8 heterogeneous clients, 12,000 samples,
               ``ours`` at batch 64, lr 3e-2, 2 local epochs, 6 rounds;
               windows of 256 flows, ``max_batch`` 256; masquerade drift
               at amplitude 0.7 along make_unsw_like(2024, 8192)'s class
               means; a monitor at threshold 0.25, patience 2). The
               initial detector federated by a session on the card (its
               launches a round: sign-align from round 1, masked-agg in
               every round that applies an update). A 4,096-flow stream
               through a card engine and a CPU engine holding the same
               weights, each with its monitor, on one step clock (expired
               and shed flows included): probabilities, ids, versions and
               counts by ``parity.serve_mismatches``, each pump's drift
               statistic within ``parity.drift_stat_bound``, the same
               trigger pump (``"phase": "card_vs_cpu"``). p50 / p99 ms and
               flows/s overall and a bucket (1 to 256 rows) after a warm
               pass and ``reset_stats()``, with and without the monitor,
               beside nvidia-smi's name and power limit, and a traced warm
               256-row pump (``"phase": "trace"``: device operations, busy
               µs, idle share). A thread publishing a card checkpoint three
               times while the main thread pumps: nothing dropped, one
               version a batch, versions monotone. The example's loop under
               its fault schedule (a scorer fault, a failed first
               re-federation attempt, a ×16 burst against a queue limit of
               2,048): clean windows, the burst, drifted windows until the
               background ``Refederator`` (a 6-round session on the card on
               drifted data) publishes, recovery windows; at least one
               trigger, retry, completed re-federation and swap, the
               breaker closed, dropped 0, deadline misses 0, exactly one
               absorbed scorer error; the AUC of the clean, drifted-stale
               and recovered windows (printed, not gated), p99 during the
               overlap with the background session, the health snapshot,
               and the re-federation's launches a round (counted from 0
               just before the loop; held as the initial federation's).
               The re-federated card checkpoint published into a CPU slot
               and a card slot, their scores by ``parity.serve_mismatches``;
               ``python -m repro_torch.launch.serve --arch anomaly-mlp
               --batch 256 --requests 2048`` in a subprocess (exit 0, its
               two lines); the phase's seconds (``"phase":
               "serve_phase"``).
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
               (``"phase": "trace"``, with the wgmma kernel's share). The
               flash cases include granite-moe's prefill (4, 2048, 16, 8,
               64), internvl2's (4, 2048, 16, 8, 128) and arctic's (4, 2048,
               56, 8, 128) and (1, 512, 56, 8, 128), seven query heads a KV
               head. Then the moe and
               vlm families, each freeing the card before its weights are
               drawn on it from seed 0 (bf16, blockwise): (a) ``serve_lm``
               at granite-moe-1b-a400m's full width (24 layers, 32 experts
               top-8), batch 4, 2048 tokens, 16 greedy: 24 wgmma launches
               in the prefill, none in the decode, each prefill layer's
               share of (token, choice) pairs dropped by capacity; (b) the
               same for internvl2-2b, 256 zero patch embeddings and 1,792
               tokens; (c) arctic-480b at full width cut to 1 of its 35
               layers (128 experts of ff 4864, top-2, the dense residual),
               batch 4, 2048 tokens, 16 greedy, its cut and the weights'
               peak memory printed: 1 wgmma launch; each serve is warmed
               at its timed shape, and the routing is read in that warm
               run; (d) granite-moe and
               internvl2 at full width, 2 layers, f32 (TF32 off), B 1 × S
               512, card (SIMT kernel) against CPU (plain): prefill and
               four teacher-forced decode steps within 1e-4 of
               max|logit|, each routed call of the card held by
               ``parity.routing_problems`` to the CPU's routing of the
               card's own layer input, the two runs' routing and the aux
               gap printed (``"phase": "card_vs_cpu"``); (e) a traced warm
               granite-moe prefill (``"phase": "trace"``: device time and
               share of busy time of the flash kernel, the expert
               ``bmm``s, the router's product and softmax, the top-k
               sort, the cumsum and the gathers and scatters); (f) ``python
               -m repro_torch.launch.serve --arch granite-moe-1b-a400m``
               and ``--arch internvl2-2b`` (blockwise, batch 4, 2048, 16)
               in subprocesses, exit 0 and their line; the part's seconds
               (``"phase": "moe_phase"``).

  8. training — the language models through the spmd step (core/fl_step.py,
               the config's optimizer: adamw with f32 master weights, remat),
               TF32 off: (a) qwen2-1.5b at full width, C 2 clients × 1 ×
               4,096 tokens, θ 0.65, weights drawn on the card from seed 0,
               with ``attention_impl`` ``full`` and then ``blockwise`` (1
               warm step, 3 timed): wall s a step, tokens/s, model TFLOP/s
               (the formula printed), peak memory beside the reckoning, and
               the launches of the timed steps, which must be one count and
               one aggregation a step and, blockwise, 112 wgmma flash
               launches a step (28 layers × the forward and remat's recompute
               × 2 clients; 0 with full); (f) the blockwise run traced for a
               warm step (``"phase": "trace"``: kernel time by class, the
               idle share) and its phases timed by CUDA events; (b)
               ``per_client_sign_align`` and ``masked_agg`` at C 2 × R
               1,735,822 (qwen2's arena) against their plain versions (counts
               equal, sums within 1e-6 of Σ|w·u|), timed beside their bounds;
               the count in ``sign_align.chunks`` chunks (9 of 8 blocks);
               (c) the flash forward and backward at (1, 4,096, 12, 2, 128)
               bf16 (wgmma), granite-moe's (1, 4,096, 16, 8, 64) bf16
               (wgmma) and (1, 512, 12, 2, 128) f32 (SIMT) against the
               plain forward's autograd (``flash_grad_excess``'s tolerance),
               timed beside SDPA's; (d) granite-moe-1b-a400m's cell at full
               width, blockwise, 2 timed steps (96 flash launches a step);
               (e) qwen2-1.5b, granite-moe and internvl2-2b at full width cut
               to 2 layers, f32, C 2 × 1 × 256 tokens (internvl2's 256
               patches before them), 2 steps on the CPU, each replayed on the
               card from the CPU's state before it (``"phase":
               "card_vs_cpu"``, problems ``[]``: records equal, no θ ratio
               within the band, the card's aggregated gradient within
               ``grad_bound`` of the CPU's (each leaf's gap printed beside
               its bound), reference signs and weights by
               ``api/parity.py``'s adamw rule; all three cut to 2 layers
               for the CPU's half, internvl2-2b's arena of 1,849,442 rows
               being under the count's old 2^31 slots, no bar to its full
               depth on the card: phase 11 reckons its step); (g) ``python
               -m repro_torch.launch.train
               --arch qwen2-1.5b`` (C 2 × 1 × 2,048, 2 steps) and ``--arch
               anomaly-mlp`` in subprocesses, each exiting 0 with a
               checkpoint written; the phase's
               seconds (``"phase": "train_phase"``).

  9. families — the ssm, hybrid and audio families (models/rwkv6.py,
               hybrid.py, whisper.py), weights drawn on the card from seed
               0 (bf16), each arch's real parameter count printed beside
               ``param_count``'s formula (rwkv6 and hymba, served cut to
               8 layers for the script's time, also at full depth): (a)
               ``serve_lm`` at rwkv6-7b's full width cut to 8 layers, B
               4 × 2,048 tokens, 16 greedy (no flash launch;
               the prompt cut to 1,024 if the prefill passes 30 s), the
               WKV loop's share of a warm prefill timed by CUDA events,
               peak memory beside a reckoning; (b) hymba-1.5b the same,
               ``blockwise`` (8 wgmma flash launches in the prefill, none
               in the decode) and ``full``, the selective scan's share,
               blockwise against full printed, and ``flash_attention`` at
               its prefill layer (4, 2,048, 25, 5, 64) bf16 causal (and
               whisper's decoder's (4, 512, 6, 6, 64)) against its plain
               version, timed beside its bound and SDPA (``"phase":
               "kernels"``); (c) whisper-tiny at B 4 × 512 decoder tokens
               beside its 1,500 stub frames, both impls (4 flash launches
               a blockwise prefill, none for the encoder, the cross
               attention or the decode); (d) hymba-1.5b at full width cut to
               8 layers (C 2 × 1 × 512 tokens, one timed step) and
               whisper-tiny (C 4 × 1 × 512 and the frames, 1 warm and 2
               timed steps) trained through the spmd step, blockwise,
               remat, θ 0.65: one count, one aggregation and 32 flash
               launches a step, s a step,
               tokens/s, peak memory, the scan's share of a step; the
               count and the aggregation at hymba's full arena against their
               plain versions; rwkv6-7b's reason for not training at full
               width; (e) card against CPU in f32, TF32 off, blockwise:
               whisper-tiny at full width, rwkv6-7b and hymba-1.5b at
               full width cut to 2 layers; B 1 × 512 prefill and four
               teacher-forced decode steps within 1e-4 of max|logit|,
               every cache leaf by ``parity.state_problems``, greedy
               tokens equal where the top-2 margin is at least 1e-3;
               then 1 (rwkv6) or 2 steps of C 2 × 1 × 256 tokens on the
               CPU with the config's optimizer (adafactor for rwkv6),
               each replayed on the card from the CPU's state: records equal, no θ ratio
               within the band, gradients by ``parity.grad_problems``,
               reference signs, weights by the adamw rule or the
               adafactor replay (``"phase": "card_vs_cpu"``, problems
               ``[]``); (f) ``python -m repro_torch.launch.serve --arch
               rwkv6-7b --smoke`` and ``python -m repro_torch.launch.train
               --arch whisper-tiny`` in subprocesses, exit 0; the phase's
               seconds (``"phase": "families_phase"``).
  10. sim-lm — the language models on the sim engines under ``ours``
               (async quorum and staleness weights, θ 0.65, no dynamic
               batch), N 4 clients selecting K 2, 2 local steps of B 1
               a client, iid token data: (a) qwen2-1.5b at full width
               and depth (bf16, blockwise, remat) on the megastep at
               512 tokens, weights drawn on the card, 1 warm-up and 3
               timed rounds, each round's launches counted from 0 and
               held (the flash kernel 56 a client step, 28 for the eval,
               one sign count a round once a reference exists, one
               aggregation a round that applies an update), wall s a
               round, training tokens/s, peak memory beside the
               reckoning (``"phase": "slice"`` ``qwen2-1.5b sim
               megastep``); (b) the same at full width cut to 2 layers on
               the loop, the megastep, the int8 megastep and the int8
               scanned path at 2 rounds a dispatch with fused eval: wall
               s a round, each run's kernels launched, the int8 payload
               against the uncompressed one; ``ef_round_trip``, the
               cohort gather (by bits) and the flash kernel at the path's
               shapes against their plain versions (``"phase":
               "kernels"``); (c) card against CPU in f32, TF32 off, at
               full width cut to 2 layers, B 1 × 128 tokens, 2 rounds:
               qwen2-1.5b and granite-moe-1b-a400m on the megastep,
               rwkv6-7b on the loop; after round 0 each client's first
               gradient by ``parity.grad_problems``, the globals by
               ``parity.sim_weight_problems`` and the reference signs by
               ``ref_sign_problems`` (bounds from the CPU's gradients);
               after round 1 the records by ``record_mismatches`` and no
               θ ratio within the band (``"phase": "card_vs_cpu"``,
               problems ``[]``); (d) the phase's seconds (``"phase":
               "sim_lm_phase"``).
  11. dry run — the dry run's census (``roofline/census.py``, the steps
               traced on meta tensors) against the card, TF32 off: (a)
               qwen2-1.5b's blockwise prefill at B 4 × 2,048 (phase 7's
               serve), weights from seed 0; (b) its training step at C 2
               × 1 × 4,096 (blockwise, remat, adamw, θ 0.65), the card's
               second step profiled and its third timed; each ``"phase":
               "dryrun"`` line holds the census's matrix-product FLOPs by
               operator, which must equal ``torch.profiler``'s
               ``with_flops`` by name and in total, and the hand-written
               kernels' launches, which must equal the card's and the
               path's (flash 28 a prefill; 112, one count and one
               aggregation a step); printed beside them, not gated: the
               census's peak beside ``max_memory_allocated``, the
               roofline's terms on the H100's peaks beside the measured
               time, the operators the census dispatched beside the
               profiler's aten operators and the CUDA runtime's launch
               and copy calls (the paper's Tables V-VI metric); (c) the
               peaks the census reckons for internvl2-2b (24 layers) and
               phi3-mini-3.8b (32) at that training cell, on meta only,
               beside the card's memory; (d) ``python -m
               repro_torch.launch.dryrun --arch qwen2-1.5b`` (4 rows); the
               phase's seconds (``"phase": "dryrun_phase"``).
  12. mesh   — the port on a mesh (``launch/mesh.py``, ``launch/
               sharding.py``) over a real one-rank NCCL process group
               (``file://`` rendezvous, no network): (a) qwen2-1.5b at full
               width cut to ``MESH_STEP_LAYERS`` layers (blockwise, remat,
               adamw, θ 0.65), C 2 × 1 × 4,096, through ``make_raw_step``
               on the 1 × 1 debug mesh, its state and batches DTensors
               laid out by the sharding rules, beside the unsharded step
               from the same state and batches: weights, optimizer state,
               reference signs, counters and metrics equal by bits every
               step, and each path's launches held (one count, one
               aggregation and 2·L·C flash calls a step) (``"phase":
               "mesh"`` ``run`` ``qwen2-1.5b sharded step``), then the
               int64 counts that a row-sharded count all-reduces, the
               kernel's (its adding launch left out) equal by bits to the
               plain version's, one launch each (``run`` ``int64
               counts``); (b) the
               population plane at 1,000,000 clients, cohort 64, frac
               0.02 and single-stage, on the one-rank "data" mesh against
               the single-device round (``candidate_shards=1``, the same
               rows in one shard) over 3 rounds, cohorts and state equal
               by bits, ms a round of both beside nvidia-smi's name and
               power limit (``run`` ``population 1M``); (c) ``python -m
               repro_torch.launch.dryrun --arch qwen2-1.5b --shape
               train_4k --mesh both`` in the CLI wave (a fake world of 512
               ranks on meta): each row's per-device FLOPs, collective
               bytes by kind and mesh dims, and its three terms; the 16 ×
               16 row held to the JAX package's compiled step on the same
               mesh (``JAX_QWEN2_TRAIN_16X16``, constants from ``python -m
               repro.launch.dryrun`` on the CPU): FLOPs a device within 5%,
               none of the largest products spanning the whole d_ff, the
               collective bytes by kind and the peak a device printed
               beside JAX's (``"phase": "mesh"`` ``run`` ``qwen2-1.5b
               train_4k 16x16 census vs jax``); the phase's seconds
               (``"phase": "mesh_phase"``).

Every CLI check of phases 6f-12 (the serve, train and dry-run launchers in
subprocesses, each exiting 0 with its output held) runs after phase 12,
all at once in two waves (the two full-width serves, then the rest, the
one full-width trainer among them), each line with its seconds from its
wave's start (``"phase": "cli_phase"`` the waves' seconds); a phase run
alone by its flag runs its own at its end.

The CPU halves of the card-vs-CPU checks of phases 7-10 (7's three 2-layer
f32 serves, 8 (e), 9 (e), 10 (c): each CPU run, and the states, logits,
routings and gradients its card half replays and holds) run in one
spawned worker process (``CpuHalves``), started after the build with all
but two of the host's cores, while the main process drives the card: the
worker is stopped while phases 3, 4, 6, 6d and 6f run and while 6b and 6c
run a timed scenario or topology (their host µs, turns, s a round,
population ms and serving latencies are timed on the host), and starts no
half while the results it sent and the main process has not taken hold
more than ``CPU_HALF_BUDGET`` bytes of host memory (each result's tensors
move into shared memory once). Between phases the main process runs the
card halves of the CPU halves done so far, and after the CLI waves the
rest, in order, each waiting for its CPU half. Each card half prints its
check's lines as before and a ``"phase": "cpu_half"`` line (the CPU
half's ``start_s``, ``end_s`` and ``stopped_s``, the card half's
``card_half_s``, ``waited_s``, its host bytes); ``"phase": "cpu_halves"``
at the end has the whole schedule. An exception in a CPU half, or the
worker's death, fails the script when its card half takes it. A phase run
alone by its flag runs its halves in line.

Every ``"phase"`` line carries ``at_s``, its seconds since the script
started. Then the ``kernels`` summary line, the nvidia-smi line, and last
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

only the session phase (6e), after the build; and

    python3 chip_smoke.py --serve

only the serving phase (6f), after the build; and

    python3 chip_smoke.py --lm

only phase 7 (the flash cases, qwen2-1.5b, the moe and vlm families),
after the build; and

    python3 chip_smoke.py --train

only phase 8 (training the language models), after the build; and

    python3 chip_smoke.py --families

only phase 9 (the ssm, hybrid and audio families), after the build; and

    python3 chip_smoke.py --sim-lm

only phase 10 (the language models on the sim engines), after the build;
and

    python3 chip_smoke.py --dryrun

only phase 11 (the dry run's census against the card), after the build;
and

    python3 chip_smoke.py --mesh

only phase 12 (the port on a mesh), after the build.
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
# the LM training step allocates a 13 GiB arena every step beside a 25 GiB
# state that its optimizer reallocates leaf by leaf: fixed-size cache
# segments fragment until the arena finds no room in one piece (phase 8),
# so the allocator maps growable segments, as the trainer does
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

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


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``at_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - T_START}), flush=True)


# ---------------------------------------------------------------------------
# the CPU halves of the card-vs-CPU checks, in a worker process beside the card
# ---------------------------------------------------------------------------

class CpuHalves:
    """The CPU halves of phases 7-10's card-vs-CPU checks, computed in a
    spawned worker process while the main process drives the card.

    Each check is split in two: a CPU half, which needs nothing from the
    card (its weights drawn on the CPU, or, phase 10's, drawn on the card
    and copied to the host before the worker starts), and a card half,
    which replays the card from the CPU half's states and holds the two by
    ``api/parity.py``. The worker (``_cpu_worker``) runs the CPU halves in
    the order added, on ``threads`` of the host's cores, and sends each
    result as it finishes: its tensors move into shared memory once, and
    the main process maps them, no copy through a pipe or a file. The
    worker starts no half while the results sent and not yet taken hold
    more than ``budget`` bytes. The main process runs a card half where it
    drains (``drain``: the halves that are done, between phases) and the
    rest at the end (``finish``). A process, not a thread: a thread's
    every operator waits for the interpreter lock that the main thread's
    Python holds (on the card's host the CPU halves ran 2-4x slower on a
    thread, with the lock handed over every 5 ms or every 0.1 ms alike,
    and the main thread's phases up to 2x slower).

    Timed host work (phase 3's host µs and turns, the quickstart's s a
    round, serving's latencies) runs inside ``quiet()``: the worker is
    stopped (SIGSTOP) for the block and continued after it. An exception
    in a CPU half is raised in the main process when its card half takes
    it, as is the worker's death; the worker then runs no more."""

    def __init__(self, threads: int, budget: int):
        self.threads, self.budget = threads, budget
        self.jobs, self.order = {}, []
        self._proc = None
        self._depth = 0             # quiet blocks entered
        self._stopped_at = None
        self._stops = []            # (start, end) of each quiet block
        self.started_at = None

    def add(self, name: str, cpu, card) -> None:
        """``cpu()`` in the worker (picklable: a module-level function or a
        partial of one, with picklable arguments); ``card(result)`` ->
        launches in the main process."""
        self.jobs[name] = dict(card=card, result=None, error=None,
                               done=False, taken=False, bytes=0,
                               start_s=None, end_s=None)
        self.order.append((name, cpu))

    def start(self) -> None:
        """The worker starts, and the main process keeps the host's other
        cores until ``finish``."""
        import atexit
        import torch.multiprocessing as tmp
        ctx = tmp.get_context("spawn")
        self._results, self._acks = ctx.Queue(), ctx.Queue()
        self._proc = ctx.Process(
            target=_cpu_worker, daemon=True, name="cpu-halves",
            args=(self.order, self._results, self._acks, self.threads,
                  self.budget))
        self._proc.start()
        atexit.register(self._kill)
        self.started_at = time.perf_counter() - T_START
        torch.set_num_threads(max(1, HOST_CORES - self.threads))

    def _kill(self) -> None:
        """At exit: a stopped worker never handles SIGTERM."""
        if self._proc is not None and self._proc.is_alive():
            import signal
            os.kill(self._proc.pid, signal.SIGKILL)

    # -- main process ------------------------------------------------------
    @contextlib.contextmanager
    def quiet(self):
        """The block runs with the worker stopped, and the main process on
        all of the host's cores."""
        import signal
        alive = self._proc is not None and self._proc.is_alive()
        if alive and self._depth == 0:
            os.kill(self._proc.pid, signal.SIGSTOP)
            self._stopped_at = time.perf_counter()
        self._depth += 1
        threads = torch.get_num_threads()
        torch.set_num_threads(HOST_CORES)
        try:
            yield
        finally:
            torch.set_num_threads(threads)
            self._depth -= 1
            if self._depth == 0 and self._stopped_at is not None:
                os.kill(self._proc.pid, signal.SIGCONT)
                self._stops.append((self._stopped_at, time.perf_counter()))
                self._stopped_at = None

    def _receive(self, block: bool) -> bool:
        """One result from the worker into its job; False if none came.
        Blocking, it fails when the worker dies or sends nothing for
        ``CPU_HALF_STALL_S`` (the longest half took 215 s, stops included,
        on the slowest host seen)."""
        import queue
        since = time.perf_counter()
        while True:
            try:
                msg = self._results.get(timeout=1.0 if block else 0.0)
                break
            except queue.Empty:
                if not block:
                    return False
                if not self._proc.is_alive():
                    raise RuntimeError(
                        f"the CPU halves' worker died (exit code "
                        f"{self._proc.exitcode})")
                if time.perf_counter() - since > CPU_HALF_STALL_S:
                    raise RuntimeError(
                        f"no result from the CPU halves' worker in "
                        f"{CPU_HALF_STALL_S} s")
        kind, name, payload, t0, t1, nbytes = msg
        job = self.jobs[name]
        job["start_s"], job["end_s"] = t0 - T_START, t1 - T_START
        job["bytes"] = nbytes
        if kind == "ok":
            from multiprocessing.reduction import ForkingPickler
            job["result"] = ForkingPickler.loads(payload)
        else:
            job["error"] = RuntimeError(payload)
        job["done"] = True
        return True

    def _stopped_within(self, t0: float, t1: float) -> float:
        return sum(max(0.0, min(b, t1) - max(a, t0))
                   for a, b in self._stops)

    def _take(self, name: str):
        job = self.jobs[name]
        while not job["done"]:
            self._receive(block=True)
        taken_s = time.perf_counter() - T_START
        result, error = job["result"], job["error"]
        job["result"], job["taken"] = None, True
        self._acks.put(job["bytes"])
        emit("cpu_half", run=name, start_s=job["start_s"],
             end_s=job["end_s"], seconds=job["end_s"] - job["start_s"],
             stopped_s=self._stopped_within(job["start_s"] + T_START,
                                            job["end_s"] + T_START),
             card_half_s=taken_s, waited_s=max(0.0, job["end_s"] - taken_s),
             host_bytes=job["bytes"], threads=self.threads,
             failed=error is not None)
        if error is not None:
            raise RuntimeError(f"the CPU half of {name!r} failed") from error
        # a card half turns TF32 off (the phase around it keeps its own)
        # and has the host's cores for its CPU work (an optimizer replay)
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        threads = torch.get_num_threads()
        torch.set_num_threads(HOST_CORES)
        try:
            return job["card"](result)
        finally:
            torch.set_num_threads(threads)
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def drain(self, launches: dict) -> None:
        """The card halves of every CPU half done so far, in order."""
        while self._receive(block=False):
            pass
        for name, _cpu in self.order:
            job = self.jobs[name]
            if job["done"] and not job["taken"]:
                launches.update(self._take(name))
                free_card()

    def finish(self, launches: dict) -> None:
        """The remaining card halves, each once its CPU half is done."""
        for name, _cpu in self.order:
            if not self.jobs[name]["taken"]:
                launches.update(self._take(name))
                free_card()
        self._proc.join(timeout=60)
        torch.set_num_threads(HOST_CORES)
        import resource
        emit("cpu_halves", started_s=self.started_at, threads=self.threads,
             budget_bytes=self.budget, worker_exitcode=self._proc.exitcode,
             host_max_rss_bytes=resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss * 1024,
             worker_max_rss_bytes=resource.getrusage(
                 resource.RUSAGE_CHILDREN).ru_maxrss * 1024,
             stopped=[[a - T_START, b - T_START] for a, b in self._stops],
             schedule=[dict(run=n, start_s=self.jobs[n]["start_s"],
                            end_s=self.jobs[n]["end_s"],
                            host_bytes=self.jobs[n]["bytes"])
                       for n, _cpu in self.order])


def _cpu_worker(order, results, acks, threads: int, budget: int) -> None:
    """The CPU halves' worker process: each half in order, its result (or
    its error) sent with its start and end on the shared monotonic clock
    and its bytes; no half starts while the results sent and not taken
    (``acks`` brings each taken result's bytes) exceed ``budget``. After a
    failure it runs no more. It stays until every result sent is taken:
    the main process receives a result's shared memory through this
    process's file descriptors."""
    import queue
    import traceback
    from multiprocessing.reduction import ForkingPickler
    import torch.multiprocessing  # noqa: F401  (tensors into shared memory)
    # the halves' own prints (serve_lm's) go to stderr a line at a time:
    # the main process's JSON lines alone make up stdout
    sys.stdout = sys.stderr
    torch.set_num_threads(threads)
    held, sent, taken = 0, 0, 0

    def ack(block: bool) -> bool:
        nonlocal held, taken
        try:
            held -= acks.get() if block else acks.get_nowait()
        except queue.Empty:
            return False
        taken += 1
        return True

    for name, cpu in order:
        while held > budget:
            ack(True)
        while ack(False):
            pass
        t0 = time.perf_counter()
        try:
            result = cpu()
        except BaseException:
            results.put(("error", name, traceback.format_exc(), t0,
                         time.perf_counter(), 0))
            break
        nbytes = host_bytes(result)
        try:
            # pickled here, not by the queue's feeder thread, whose
            # failures would be printed and the result lost
            result = detached(result)
            to_shared_memory(result)
            payload = ForkingPickler.dumps(result)
        except BaseException:
            results.put(("error", name, traceback.format_exc(), t0,
                         time.perf_counter(), 0))
            break
        held += nbytes
        sent += 1
        results.put(("ok", name, bytes(payload), t0, time.perf_counter(),
                     nbytes))
        del result, payload
    while taken < sent:
        ack(True)


def _tensors(tree):
    """The tensors in a nest of dicts, lists, tuples and named tuples."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "_asdict"):
            stack.extend(x._asdict().values())


def detached(tree):
    """A nest of dicts, lists, tuples and named tuples with every tensor
    detached (the routing a training step records is part of its graph,
    and a tensor in a graph does not cross processes)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return type(tree)(*(detached(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(detached(v) for v in tree)
    return tree


SHM_TRIES = 20


def to_shared_memory(tree) -> None:
    """Each tensor of a CPU half's result moved into shared memory here,
    in the worker's main thread, before the queue's feeder thread pickles
    it (a failure there would be printed and the result lost). A stop and
    continue of the worker (``quiet``) can interrupt the allocation of a
    large segment (the allocation then returns an error): each tensor is
    tried again, ``SHM_TRIES`` times."""
    for t in _tensors(tree):
        for attempt in range(SHM_TRIES):
            try:
                t.share_memory_()
                break
            except RuntimeError:
                if attempt == SHM_TRIES - 1:
                    raise
                time.sleep(0.05)


def host_bytes(tree) -> int:
    """Bytes of the distinct tensor storages in a nest (``_tensors``: a
    CPU half's result)."""
    seen, total = set(), 0
    for x in _tensors(tree):
        key = x.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += x.untyped_storage().nbytes()
    return total


# the whole script's CPU halves (``main``); None when a phase runs alone by
# its flag, which then runs its checks' halves in line (``run_halves``)
CPU_HALVES = None
HOST_CORES = len(os.sched_getaffinity(0))
CPU_HALF_THREADS = max(1, HOST_CORES - 2)  # the main process keeps two
CPU_HALF_BUDGET = 28 * 2 ** 30   # finished CPU halves' bytes held at once
CPU_HALF_STALL_S = 400.0


@contextlib.contextmanager
def quiet():
    """Timed host work: the CPU halves' worker stopped while it runs."""
    if CPU_HALVES is None:
        yield
    else:
        with CPU_HALVES.quiet():
            yield


def drain(launches: dict) -> None:
    """Between phases: the card halves of the CPU halves done so far."""
    if CPU_HALVES is not None:
        CPU_HALVES.drain(launches)


def run_halves(halves, launches: dict) -> None:
    """Each (name, cpu, card) check of a phase run alone: its CPU half,
    then its card half, in line."""
    for _name, cpu, card in halves:
        launches.update(card(cpu()))
        free_card()


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


# rows of the counts past the old int32 limit: n = R·1024 = 2,252,800,000
# slots, above 2^31 = 2,147,483,648; n = 2^15·68,750 is exact in f32 and
# n − 1 (odd, above 2^24) rounds
PAST_INT32_ROWS = 2_200_000


def exact_counts(ref, u, refs) -> list:
    """Each client's matches of u (C, R, 1024) against refs (P, R, 1024),
    client c against refs[c // (C / P)], as Python ints: ``ref.sign``
    compared and summed on the card a block of rows at a time."""
    C, R, _ = u.shape
    group = C // refs.shape[0]
    step = 1 << 17
    return [sum(int((ref.sign(u[c, a:a + step])
                     == refs[c // group, a:a + step]).sum())
                for a in range(0, R, step)) for c in range(C)]


def plain_chunk_counts(ref, x, refs, chunks: int) -> list:
    """Each count's matches in each chunk the kernel takes (chunk z: the
    float4s [z·chunk4, (z + 1)·chunk4) of n / 4, chunk4 = ⌈n / 4 /
    chunks⌉, as ``launch`` in csrc/sign_align.cu splits them), x (C, R,
    1024) against refs (P, R, 1024), client c against refs[c // (C / P)],
    counted with ``ref.sign`` on the card: (C, chunks) Python ints."""
    C, P = x.shape[0], refs.shape[0]
    n = x[0].numel()
    xf, rf = x.reshape(C, n), refs.reshape(P, n)
    chunk = 4 * -(-(n // 4) // chunks)
    return [[int((ref.sign(xf[c, a:a + chunk])
                  == rf[c // (C // P), a:a + chunk]).sum())
              if a < n else 0 for a in range(0, chunk * chunks, chunk)]
            for c in range(C)]


def read_partials(sign_align, launch, name: str, x, r) -> tuple:
    """(counts, partials) of one chunked launch of the entry point
    ``name`` on (x, r) with an int32 workspace allocated here: the f32
    counts as floats and the workspace read back as (C, chunks) ints. The
    wrapper allocates the same workspace, and never reads it back."""
    C = x.shape[0] if name == "per_client_sign_align" else 1
    n = x[0].numel() if name == "per_client_sign_align" else x.numel()
    k = sign_align.chunks(C, n)
    if k < 2:
        raise AssertionError(f"{name} at {tuple(x.shape)}: one chunk")
    partials = torch.full((C * k,), -1, dtype=torch.int32, device="cuda")
    counts = torch.empty(C if name == "per_client_sign_align" else (),
                         dtype=torch.float32, device="cuda")
    stream = launch.stream(torch.cuda.current_device())
    if name == "per_client_sign_align":
        group = C if r.dim() == 2 else C // r.shape[0]
        launch.entries[name](x.data_ptr(), r.data_ptr(), counts.data_ptr(),
                             partials.data_ptr(), C, group, n, k, stream)
    else:
        launch.entries[name](x.data_ptr(), int(x.dtype == torch.bfloat16),
                             r.data_ptr(), counts.data_ptr(),
                             partials.data_ptr(), n, k, stream)
    torch.cuda.synchronize()
    return (counts.reshape(-1).tolist(),
            partials.reshape(C, k).tolist())


def held_partials(sign_align, launch, ref, name: str, x, r, where: str):
    """A chunked launch's int32 partials equal, chunk by chunk, to the
    plain count of that chunk's slots, and its counts to their int64 sums
    converted once to f32: a slot dropped or counted twice at a chunk's
    edge shows here even where the f32 count cannot hold it. Returns the
    chunks and the exact counts."""
    counts, partials = read_partials(sign_align, launch, name, x, r)
    xs = x if name == "per_client_sign_align" else x[None]
    refs = r[None] if r.dim() == 2 else r
    want = plain_chunk_counts(ref, xs, refs, len(partials[0]))
    if partials != want:
        raise AssertionError(f"{name} {where}: chunk partials {partials} "
                             f"vs the plain chunks' counts {want}")
    exact = [sum(p) for p in want]
    if counts != [float(np.float32(c)) for c in exact]:
        raise AssertionError(f"{name} {where}: counts {counts} vs the "
                             f"partials' sums {exact} in f32")
    return len(partials[0]), exact


# (C, P, R) of the chunked count below 2^24 slots a count, where an f32
# count is exact and the chunks' edges fall unevenly: 2 chunks; 3 chunks
# of 1,398,016 float4s each; 3 chunks whose last is 2 float4s short; the
# grouped form, one client and two clients a reference, 3 chunks
CHUNK_EDGES = ((1, 1, 8_192), (1, 1, 16_383), (1, 1, 12_289),
               (2, 2, 16_383), (4, 2, 16_383))


def sign_chunk_edges(sign_align, launch, ref) -> None:
    """The chunked count where an f32 count is exact (``CHUNK_EDGES``), u
    random and random reference signs in {-1, 0, 1} (about a third of the
    slots match, and the count moves with every slot): both wrappers
    (``sign_align_counts`` on client 0's update, f32 and bf16, where P =
    1) equal by bits to their plain versions and to the exact counts, and
    every launch's chunk partials to the plain chunks' counts."""
    g = torch.Generator(device="cuda").manual_seed(13)
    for C, P, R in CHUNK_EDGES:
        u = torch.randn((C, R, 1024), generator=g, device="cuda")
        refs = torch.randint(-1, 2, (P, R, 1024), generator=g, device="cuda",
                             dtype=torch.int8)
        r = refs[0] if P == 1 else refs
        where = f"C {C} x P {P} x R {R}"
        got, _ = held_counts(sign_align.per_client_sign_align,
                             ref.per_client_sign_align, u, r, where)
        chunks, exact = held_partials(sign_align, launch, ref,
                                      "per_client_sign_align", u, r, where)
        if got.tolist() != [float(c) for c in exact] or \
                max(exact) >= 2 ** 24:
            raise AssertionError(f"{where}: {got.tolist()} vs the exact "
                                 f"counts {exact}")
        line = dict(name="per_client_sign_align", case="chunk edges",
                    shape=[C, R], references=P, chunks=chunks,
                    counts=exact, equal_by_bits=True, partials_equal=True)
        if P == 1:
            for dtype in (torch.float32, torch.bfloat16):
                x = u[0].to(dtype)
                one, _ = held_counts(sign_align.sign_align_counts,
                                     ref.sign_align_counts, x, r,
                                     f"{where} {dtype}")
                held_partials(sign_align, launch, ref, "sign_align_counts",
                              x, r, f"{where} {dtype}")
                line[f"sign_align_counts_{str(dtype)[6:]}"] = float(one)
        emit("kernels", **line)
        del u, refs, r


def sign_past_int32(sign_align, launch, ref, smi: str) -> None:
    """Both sign counts past 2^31 slots against their plain versions, by
    bits: ``per_client_sign_align`` at C 1 × R ``PAST_INT32_ROWS`` and
    ``sign_align_counts`` on the same f32 update, the reference signs
    sign(u) (every slot matches: n, exact in f32) and then with the first
    slot set to the -2 padding (n − 1, which rounds); the grouped form at
    C 2 × P 2 at the same R, client 0 against sign(u[0]) and client 1
    against sign(u[1]) with its first slot padded. Counts also equal to
    ``exact_counts`` converted once to f32 (numpy, nearest even), and each
    case's chunk partials, read back from a launch of the entry point, to
    the plain count of each chunk (``held_partials``: the f32 count past
    2^31 cannot tell a slot more or less). Each case timed beside its
    bound by bytes (each input read once), with its chunks and its
    launches traced."""
    R = PAST_INT32_ROWS
    n = R * 1024
    g = torch.Generator(device="cuda").manual_seed(11)

    def f32(count: int) -> float:
        return float(np.float32(count))

    def check(what, got, want_ints):
        torch.cuda.synchronize()
        want = torch.tensor([f32(c) for c in want_ints], device="cuda")
        if got.reshape(-1).tolist() != want.tolist():
            raise AssertionError(f"{what}: {got.tolist()} vs the exact "
                                 f"counts {want_ints} in f32")

    u = torch.randn((1, R, 1024), generator=g, device="cuda")
    r = ref.sign(u[0])
    lines = []
    for case, pad in (("exact", False), ("rounds", True)):
        if pad:
            r[0, 0] = -2
        want_ints = exact_counts(ref, u, r[None])
        if want_ints != [n - pad]:
            raise AssertionError(f"{case}: counted {want_ints}, built "
                                 f"{n - pad}")
        if (f32(n - pad) == n - pad) != (not pad):
            raise AssertionError(f"{case}: {n - pad} in f32")
        for name, fn, plain, args in (
                ("per_client_sign_align", sign_align.per_client_sign_align,
                 ref.per_client_sign_align, (u, r)),
                ("sign_align_counts", sign_align.sign_align_counts,
                 ref.sign_align_counts, (u[0], r))):
            got, _ = held_counts(fn, plain, *args, f"{name} {case}")
            check(f"{name} {case}", got, want_ints)
            held_partials(sign_align, launch, ref, name, *args,
                          f"{case} past 2^31")
            bound = bound_ms(5 * n + 4, 2 * n)
            lines.append(dict(
                name=name, case=case, shape=[1, R], slots=n,
                count=float(got.reshape(-1)[0]), exact_count=n - pad,
                equal_by_bits=True, partials_equal=True,
                chunks=sign_align.chunks(1, n),
                ms=time_ms(lambda: fn(*args), iters=5, warmup=1),
                plain_ms=time_ms(lambda: plain(*args), iters=1, warmup=1),
                bound_ms=bound[0], bound_by=bound[1],
                design=traced_grid(lambda: fn(*args), "sign_align")))
    del u, r
    free_card()
    u = torch.randn((2, R, 1024), generator=g, device="cuda")
    refs = ref.sign(u)
    refs[1, 0, 0] = -2
    want_ints = exact_counts(ref, u, refs)
    if want_ints != [n, n - 1]:
        raise AssertionError(f"grouped: counted {want_ints}")
    got, _ = held_counts(sign_align.per_client_sign_align,
                         ref.per_client_sign_align, u, refs, "grouped")
    check("grouped", got, want_ints)
    held_partials(sign_align, launch, ref, "per_client_sign_align", u, refs,
                  "grouped past 2^31")
    bound = bound_ms(2 * n * 4 + 2 * n + 8, 4 * n)
    lines.append(dict(
        name="per_client_sign_align", case="grouped C 2 x P 2",
        shape=[2, R], references=2, slots=n, counts=got.tolist(),
        exact_counts=want_ints, equal_by_bits=True, partials_equal=True,
        chunks=sign_align.chunks(2, n),
        ms=time_ms(lambda: sign_align.per_client_sign_align(u, refs),
                   iters=5, warmup=1),
        plain_ms=time_ms(lambda: ref.per_client_sign_align(u, refs),
                         iters=1, warmup=1),
        bound_ms=bound[0], bound_by=bound[1],
        design=traced_grid(lambda: sign_align.per_client_sign_align(u, refs),
                           "sign_align")))
    del u, refs
    free_card()
    for line in lines:
        emit("kernels", past_int32=True, **line, nvidia_smi=smi)


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
            with quiet():       # its s a round is timed on the host
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
    # the kernels' eager turns and every run's s a round are timed on the
    # host: the CPU halves' worker stopped
    with quiet():
        grouped_sign_kernel(sign_align, ref, smi)
        launches = {"hierarchical": full_width_topology(T, params, mods,
                                                        smi)}
    problems = []
    for run, (base, needed) in scenario_runs(T).items():
        with quiet():
            flat, flat_recs, flat_wall, flat_launches, _ = run_path_card(
                T, base, params, mods)
        for preset in TOPOLOGY_PRESETS_RUN:
            spec = dataclasses.replace(base, topology=preset)
            name = f"{run} {preset}"
            with quiet():
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


def device_busy(prof) -> tuple:
    """A profile's device events: how many, and the µs in which at least
    one ran (the length of the union of their spans)."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), busy


def port_env() -> dict:
    """The environment of a subprocess that imports the port."""
    return dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def trace(run_once, share_of: str = None) -> dict:
    """``torch.profiler`` over one call of ``run_once`` (warm, ending in a
    synchronisation): the kernels the card ran, their device time, and
    the share of the call's wall time in which no kernel ran; with
    ``share_of``, the device time of the kernels whose name holds it and
    their share of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_events, busy = device_busy(prof)
    by_key = sorted(((e.key, e.count, e.device_time_total)
                     for e in prof.key_averages()
                     if e.device_time_total > 0), key=lambda x: -x[2])
    line = dict(device_events=n_events, device_busy_us=busy,
                wall_us=wall_us,
                device_idle_share=(1.0 - busy / wall_us) if n_events else None,
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
    ("granite-moe prefill", "gqa", (4, 2048, 16, 8, 64), "bfloat16", True,
     None, None),
    ("internvl2 prefill", "gqa", (4, 2048, 16, 8, 128), "bfloat16", True,
     None, None),
    ("arctic prefill", "gqa", (1, 512, 56, 8, 128), "bfloat16", True, None,
     None),
    ("arctic prefill B 4 x 2048", "gqa", (4, 2048, 56, 8, 128), "bfloat16",
     True, None, None),
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


def flash_case(flash_attn, ref, case) -> tuple:
    """One case of FLASH_CASES' form held to its plain version through
    the kernel its route names (bf16 at hd 64/96/128 must be "wgmma") and
    timed beside its bound, its plain version and SDPA. Returns (line,
    route, q, k, v, window)."""
    F = torch.nn.functional
    name, layout, shape, dtype, causal, window, Sk = case
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
    return line, which, q, k, v, window


def phase_flash(flash_attn, ref) -> dict:
    """Hold flash_attention to its plain version at every listed shape
    (``flash_case``), and at the wgmma kernel's main case time the SIMT
    kernel on the same inputs."""
    rows, err = {}, dict.fromkeys(FLASH_MAIN, 0.0)
    for case in FLASH_CASES:
        line, which, q, k, v, window = flash_case(flash_attn, ref, case)
        name, causal = case[0], case[4]
        err[which] = max(err[which], line["max_abs_err"])
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
        for r, main_case in FLASH_MAIN.items():
            if name == main_case:
                rows[r] = {k: line[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "simt_ms",
                    "simt_device_ms") if k in line}
        del q, k, v
    return {("flash_attention" if r == "wgmma" else "flash_attention_simt"):
            dict(route="cuda", kernel=r, source=FLASH_SOURCES[r],
                 replaces="src/repro/kernels/flash_attn.py:71",
                 max_abs_err=err[r], **rows[r]) for r in FLASH_MAIN}


class ServeRecorder:
    """Wraps a model module's ``prefill`` and ``decode_step`` (the
    transformer's, or another family's) for one ``serve_lm`` call: the
    prefill's logits, the kernel launches when the prefill ends and the
    times at its end and at the first decode step, each after a
    synchronisation."""

    def __init__(self, module, flash_attn):
        self.tf, self.fa = module, flash_attn

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


def serve_run(serve, module, mods, cfg, params, batch, prompt_len,
              steps) -> dict:
    """``serve_lm`` on the card with every launch count set to 0 just
    before (``module`` the config's model module); returns its tokens,
    prefill logits, times, launches and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    with ServeRecorder(module, mods["flash_attn"]) as rec:
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


def teacher_forced(model_api, serve, cfg, params, prompt, feed,
                   device) -> tuple:
    """Prefill ``prompt`` (CPU tensors) on ``device``, graft the cache
    (``serve.graft_cache``), decode ``feed`` (B, n) one token at a time;
    returns (logits of the prefill and each step, the prefill's cache, the
    last cache), on the CPU in f32."""
    logits, cache = model_api.prefill(
        params, {k: v.to(device) for k, v in prompt.items()}, cfg)
    S = cache["step"]
    host = {k: (v.float().cpu() if torch.is_tensor(v) else v)
            for k, v in cache.items()}
    full = serve.graft_cache(model_api.init_cache(
        cfg, feed.shape[0], S + feed.shape[1], device=device), cache)
    full["step"] = S
    out = [logits.float().cpu()]
    for i in range(feed.shape[1]):
        logits, full = model_api.decode_step(
            params, full, {"tokens": feed[:, i:i + 1].to(device)}, cfg)
        out.append(logits.float().cpu())
    return out, host, {k: (v.float().cpu() if torch.is_tensor(v) else v)
                       for k, v in full.items()}


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

    out = {"qwen2-1.5b serve blockwise": launches}
    if CPU_HALVES is None:      # else the worker and ``drain`` run them
        run_halves(lm_halves(mods), out)
    return out


def lm_f32_cpu() -> dict:
    """The CPU half of phase 7's 2-layer f32 qwen2-1.5b check: weights from
    seed 0 on the CPU, serve_lm's prompt (seed 0), the CPU's greedy tokens
    after it (fed to both devices' decode steps) and the CPU's logits of
    the prefill and four teacher-forced decode steps."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import api as model_api
    small = registry.get_config("qwen2-1.5b").replace(
        attention_impl="blockwise", num_layers=2, dtype="float32")
    params = model_api.init_params(torch.Generator().manual_seed(0), small,
                                   "cpu")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, small.vocab_size, size=(1, 512)))
    feed = serve.serve_lm(small, 1, 512, 4, device="cpu",
                          params=params)[:, :4]
    with torch.no_grad():
        logits = teacher_forced(model_api, serve, small, params,
                                {"tokens": prompt}, feed, "cpu")[0]
    return dict(cfg=small, params=params, prompt=prompt, feed=feed,
                logits=logits)


def lm_f32_card(mods, cpu: dict) -> dict:
    """Its card half: the same weights on the card (kernel) against the
    CPU (plain), TF32 off, within 1e-4 of max|logit|, two SIMT launches."""
    from repro_torch.launch import serve
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small, cpu_logits = cpu["cfg"], cpu["logits"]
    card_params = transformer.tree_to(cpu["params"], "cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches(mods)
        card_logits = teacher_forced(model_api, serve, small, card_params,
                                     {"tokens": cpu["prompt"]}, cpu["feed"],
                                     "cuda")[0]
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
    return {"qwen2-1.5b 2-layer f32": f32_launches}


def lm_halves(mods) -> list:
    """Phase 7's qwen2 check as (name, CPU half, card half)."""
    return [("qwen2-1.5b 2-layer f32", lm_f32_cpu,
             functools.partial(lm_f32_card, mods))]


# phase 7's moe and vlm serves: run -> (arch, layers (None: all), batch,
# prompt positions, decode steps); arctic is cut in depth alone
MOE_SERVES = {
    "granite-moe-1b-a400m serve blockwise": ("granite-moe-1b-a400m", None, 4,
                                             2048, 16),
    "internvl2-2b serve blockwise": ("internvl2-2b", None, 4, 2048, 16),
    "arctic-480b 1-layer serve blockwise": ("arctic-480b", 1, 4, 2048, 16),
}
# the traced prefill's shares: name -> aten operations whose own device
# time it sums (the router's product is told from the other matrix
# products by its input shapes, the flash kernel by its name)
MOE_OPS = {
    "expert_bmm": ("aten::bmm",),
    "router_softmax": ("aten::_softmax",),
    "top_k_sort": ("aten::sort",),
    "cumsum": ("aten::cumsum",),
    "gather_scatter": ("aten::index", "aten::index_put_",
                       "aten::_index_put_impl_", "aten::gather"),
}


class RoutingRecorder:
    """Wraps ``moe.route`` for one run: each call's ``Routing``, in order
    (the prefill's layers, then each decode step's), and with ``inputs``
    each call's arguments (cfg, router, xt)."""

    def __init__(self, moe, inputs: bool = False):
        self.moe, self.calls, self.inputs = moe, [], [] if inputs else None

    def __enter__(self):
        self.route = self.moe.route

        def route(*a, **k):
            r = self.route(*a, **k)
            self.calls.append(r)
            if self.inputs is not None:
                self.inputs.append(a)
            return r

        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def routing_line(cfg, calls) -> dict:
    """The prefill's capacity and, layer by layer, the share of its
    (token, choice) pairs that capacity dropped; the decode's drops."""
    pre = calls[:cfg.num_layers]
    return dict(capacity=pre[0].capacity, tokens=int(pre[0].topi.shape[0]),
                dropped_share_by_layer=[1.0 - float(r.keep.float().mean())
                                        for r in pre],
                decode_dropped=sum(int((~r.keep).sum())
                                   for r in calls[cfg.num_layers:]))


def moe_serve(mods, run: str, spec) -> tuple:
    """``serve_lm`` of one moe or vlm arch at full width (bf16, blockwise,
    random weights drawn on the card from seed 0), the card freed before
    the weights are drawn; gated: one wgmma flash launch a prefill layer,
    none in the decode. Returns (cfg, params, launches)."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import api as model_api
    from repro_torch.models import moe, transformer
    arch, layers, batch, prompt_len, steps = spec
    cfg = registry.get_config(arch).replace(attention_impl="blockwise")
    cuts = None
    if layers is not None:
        cuts = dict(layers=[cfg.num_layers, layers])
        cfg = cfg.replace(num_layers=layers)
    free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_api.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    torch.cuda.synchronize()
    emit("slice", run=f"{arch} weights", layers=cfg.num_layers,
         params=sum(t.numel() for t in _leaves(params)),
         param_count=cfg.param_count(),
         bytes=sum(t.numel() * t.element_size() for t in _leaves(params)),
         draw_s=time.perf_counter() - t0,
         init_peak_memory_bytes=torch.cuda.max_memory_allocated())
    # warm at the timed shape; the routing is recorded here, so that the
    # timed run below carries no recorder
    with RoutingRecorder(moe) as rec:
        serve.serve_lm(cfg, batch, prompt_len, steps, device="cuda",
                       params=params)
    r = serve_run(serve, transformer, mods, cfg, params, batch, prompt_len,
                  steps)
    toks, logits = r["tokens"], r["logits"]
    ok = (tuple(toks.shape) == (batch, 1 + steps)
          and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all())
          and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (batch, prompt_len, cfg.padded_vocab))
    line = dict(run=run, arch=arch, layers=cfg.num_layers,
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
    if cuts:
        line["cuts"] = cuts
    if cfg.family == "vlm":
        line["patches"] = cfg.num_patches
    if cfg.num_experts:
        line["routing"] = routing_line(cfg, rec.calls)
    emit("slice", **line)
    if not ok:
        raise AssertionError(f"{run}: tokens or logits malformed")
    if r["prefill_routes"] != {"wgmma": cfg.num_layers, "simt": 0} or \
            r["decode_launches"] != 0:
        raise AssertionError(
            f"{run}: flash_attention launched {r['prefill_routes']} times "
            f"in the prefill (want {cfg.num_layers}, all wgmma) and "
            f"{r['decode_launches']} in the decode (want 0)")
    return cfg, params, r["launches"]


def moe_trace(run_once, router_shapes) -> dict:
    """``torch.profiler`` (CPU and CUDA, with input shapes) over one warm
    call: device busy time and idle share, the flash kernel's device time,
    and the own device time of the operations of ``MOE_OPS`` and of the
    router's product, each with its share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_events, busy = device_busy(prof)

    def own(e):
        return getattr(e, "self_device_time_total", None) or 0.0

    ops = [(e.key, [list(x) for x in (e.input_shapes or [])[:2]], own(e),
            e.count)
           for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and own(e) > 0]
    us = {name: sum(t for k, _, t, _ in ops if k in keys)
          for name, keys in MOE_OPS.items()}
    us["router_matmul"] = sum(t for k, sh, t, _ in ops
                              if k == "aten::mm" and sh == router_shapes)
    us["flash_kernel"] = sum(e.device_time_total
                             for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA
                             and "flash_wgmma_kernel" in e.key)
    return dict(device_events=n_events, device_busy_us=busy,
                wall_us=wall_us,
                device_idle_share=(1.0 - busy / wall_us) if n_events else None,
                device_us=us,
                share_of_busy={k: v / busy if busy else None
                               for k, v in us.items()},
                top_ops_by_own_device_us=[
                    dict(name=k, shapes=sh, count=c, us=t) for k, sh, t, c in
                    sorted(ops, key=lambda o: -o[2])[:8]])


def moe_f32_cpu(arch: str) -> dict:
    """The CPU half of phase 7's 2-layer f32 check of a moe or vlm arch:
    weights from seed 0, serve_lm's prompt (seed 0) and the CPU's greedy
    tokens after it, the CPU's logits of the prefill and four
    teacher-forced decode steps with its routing, and its aux."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import api as model_api
    from repro_torch.models import moe, transformer
    cfg = registry.get_config(arch).replace(
        num_layers=2, dtype="float32", attention_impl="blockwise")
    params = model_api.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    patches = cfg.num_patches if cfg.family == "vlm" else 0
    prompt = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 512 - patches)))}
    if patches:
        prompt["patch_embeds"] = torch.zeros((1, patches, cfg.d_model))
    feed = serve.serve_lm(cfg, 1, 512, 4, device="cpu",
                          params=params)[:, :4]
    with torch.no_grad():
        with RoutingRecorder(moe) as rec:
            logits = teacher_forced(model_api, serve, cfg, params, prompt,
                                    feed, "cpu")[0]
        aux = (float(transformer.forward(params, prompt, cfg)[2])
               if cfg.num_experts else 0.0)
    return dict(cfg=cfg, params=params, prompt=prompt, feed=feed,
                logits=logits, calls=rec.calls, aux=aux, patches=patches)


def moe_f32_card(mods, parity, cpu: dict) -> dict:
    """Its card half, one arch at full width, 2 layers deep, f32 (TF32
    off): the card (SIMT flash kernel) against the CPU (plain) from the
    same weights, prefill and four teacher-forced decode steps within 1e-4
    of max|logit|; every routed call of the card held by
    ``parity.routing_problems`` to the CPU's routing of the same layer
    input (the card's, replayed), the two runs' routing against each
    other printed (their layer inputs part by the earlier layers'
    rounding: ``api/parity.py``); the aux gap printed. Returns the card
    run's launches."""
    from repro_torch.launch import serve
    from repro_torch.models import api as model_api
    from repro_torch.models import moe, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, prompt, cpu_logits = cpu["cfg"], cpu["prompt"], cpu["logits"]
    arch, patches = cfg.name, cpu["patches"]
    card_params = transformer.tree_to(cpu["params"], "cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches(mods)
        with RoutingRecorder(moe, inputs=True) as card_rec:
            card_logits = teacher_forced(model_api, serve, cfg, card_params,
                                         prompt, cpu["feed"], "cuda")[0]
        torch.cuda.synchronize()
        launches = read_launches(mods)
        replayed = [moe.route(c, router.cpu(), xt.cpu())
                    for c, router, xt in card_rec.inputs]
        aux = [float(transformer.forward(
            card_params, {k: v.to("cuda") for k, v in prompt.items()},
            cfg)[2]), cpu["aux"]] if cfg.num_experts else [0.0, 0.0]
    cpu_calls = cpu["calls"]
    problems, gaps = [], []
    for i, (c, g) in enumerate(zip(card_logits, cpu_logits)):
        gap = float((c - g).abs().max() / g.abs().max())
        gaps.append(gap)
        if not gap <= 1e-4:
            problems.append(f"{'prefill' if i == 0 else f'decode {i}'}: "
                            f"logit gap {gap} of max|logit|")
    problems += parity.routing_problems(card_rec.calls, replayed)
    if (launches["flash_attention_simt"], launches["flash_attention"]) != \
            (cfg.num_layers, 0):
        problems.append(f"flash_attention launched {launches['flash_attention']}"
                        f" (wgmma) and {launches['flash_attention_simt']} "
                        f"(SIMT) times, not 0 and {cfg.num_layers}")
    line = dict(run=f"{arch} 2-layer f32", layers=cfg.num_layers, batch=1,
                prompt_len=512, decode_steps=4, patches=patches,
                allow_tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                                cudnn=torch.backends.cudnn.allow_tf32),
                logit_gap_rel=gaps, flash_launches=launches["flash_attention"]
                + launches["flash_attention_simt"],
                aux_card_cpu=aux, aux_gap=abs(aux[0] - aux[1]))
    if cfg.num_experts:
        k = cfg.top_k
        kth = [torch.sort(r.logits, dim=1, descending=True).values
               for r in cpu_calls]

        def gap_max(a, b):
            return max(float((x.logits.cpu() - y.logits).abs().max())
                       for x, y in zip(a, b))

        line.update(
            routed_calls=len(card_rec.calls),
            router_logit_gap_max_replayed=gap_max(card_rec.calls, replayed),
            router_logit_gap_max_run=gap_max(card_rec.calls, cpu_calls),
            kth_logit_gap_min=min(float((z[:, k - 1] - z[:, k]).min())
                                  for z in kth),
            routing_run_vs_run=parity.routing_problems(card_rec.calls,
                                                       cpu_calls),
            routing=routing_line(cfg, cpu_calls))
    emit("card_vs_cpu", **line, problems=problems)
    if problems:
        raise AssertionError(f"{arch} card vs CPU: " + "; ".join(problems))
    return {f"{arch} 2-layer f32": launches}


MOE_CARD_CPU = ("granite-moe-1b-a400m", "internvl2-2b")


def moe_halves(mods, parity) -> list:
    """Phase 7's moe and vlm checks as (name, CPU half, card half)."""
    return [(f"{arch} 2-layer f32", functools.partial(moe_f32_cpu, arch),
             functools.partial(moe_f32_card, mods, parity))
            for arch in MOE_CARD_CPU]


# The CLI checks: each runs ``python -m <module> ...`` in a subprocess on
# the card and holds its exit code and output. In the whole script they
# are gathered here and run together after phase 11 (``run_clis``); a phase
# run alone by its flag runs its own at its end. None: run at once.
DEFERRED_CLIS = None


def cli_check(phase: str, run: str, args: list, ok, wave: int = 1,
              keep=None, **fields) -> None:
    """A CLI check: ``args`` after ``python -m`` (``{ckpt}`` becomes a
    fresh directory), ``ok(stdout lines)`` must hold and the exit code be
    0; its line is emitted under ``phase`` with ``fields`` and the last
    ``keep`` lines of its output (all: None). Run now, or gathered into
    ``DEFERRED_CLIS``."""
    job = dict(phase=phase, run=run, args=args, ok=ok, wave=wave,
               keep=keep, fields=fields)
    if DEFERRED_CLIS is None:
        run_clis([job])
    else:
        DEFERRED_CLIS.append(job)


def run_clis(jobs, timeout: float = 600.0) -> None:
    """Run the CLI checks ``jobs``, wave after wave (wave 0: the
    full-width LM serves; wave 1: the rest, the one full-width trainer
    among them, as the card's memory holds each wave), the jobs of a wave
    started together and waited for together, each with its own output
    files and checkpoint directory; every process is stopped before this
    returns. Emits each job's line (its ``seconds`` from its wave's start
    to its own end) and raises if any failed."""
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for wave in sorted({j["wave"] for j in jobs}):
            running = []
            t0 = time.perf_counter()
            try:
                for i, job in enumerate(j for j in jobs if j["wave"] == wave):
                    args = [a.replace("{ckpt}", os.path.join(
                        tmp, f"w{wave}j{i}")) for a in job["args"]]
                    out = open(os.path.join(tmp, f"w{wave}j{i}.out"), "w+")
                    err = open(os.path.join(tmp, f"w{wave}j{i}.err"), "w+")
                    proc = subprocess.Popen([sys.executable, "-m", *args],
                                            env=port_env(), stdout=out,
                                            stderr=err, text=True)
                    running.append([job, args, proc, out, err, None])
                while any(r[5] is None for r in running):
                    for r in running:
                        if r[5] is None and r[2].poll() is not None:
                            r[5] = time.perf_counter() - t0
                    if time.perf_counter() - t0 > timeout:
                        break
                    time.sleep(0.1)
            finally:
                for r in running:
                    if r[2].poll() is None:
                        r[2].kill()
                        r[2].wait()
            for job, args, proc, out, err, seconds in running:
                out.seek(0)
                err.seek(0)
                stdout, stderr = out.read(), err.read()
                out.close()
                err.close()
                lines = stdout.strip().splitlines()
                emit(job["phase"], run=job["run"], argv=args,
                     returncode=proc.returncode,
                     stdout=lines if job["keep"] is None
                     else lines[-job["keep"]:], seconds=seconds,
                     wave=wave, **job["fields"])
                if proc.returncode != 0 or not lines or not job["ok"](lines):
                    failures.append(f"{job['run']}: {proc.returncode}\n"
                                    f"{stdout[-2000:]}\n{stderr[-2000:]}")
    if failures:
        raise AssertionError("CLI checks failed: " + "\n".join(failures))


def lm_cli(arch: str) -> None:
    """``python -m repro_torch.launch.serve --arch <arch> --attention-impl
    blockwise --batch 4 --prompt-len 2048 --decode-steps 16`` on the card:
    exit 0 and its line."""
    cli_check("slice", f"{arch} cli", [
        "repro_torch.launch.serve", "--arch", arch, "--attention-impl",
        "blockwise", "--batch", "4", "--prompt-len", "2048",
        "--decode-steps", "16"],
        lambda lines: re.match(r"prefill: 4x2048 in .*decode: 16 steps",
                               lines[-1]), wave=0)


def phase_moe(mods, parity, smi: str) -> dict:
    """Phase 7's moe and vlm part (module docstring, 7 (a) to (f)).
    Returns the launches of each run."""
    from repro_torch.models import api as model_api
    t_phase = time.perf_counter()
    launches = {}
    for run, spec in MOE_SERVES.items():
        cfg, params, launches[run] = moe_serve(mods, run, spec)
        if cfg.name == "granite-moe-1b-a400m":
            batch, prompt_len = spec[2], spec[3]
            prompt = {"tokens": torch.as_tensor(
                np.random.default_rng(0).integers(
                    0, cfg.vocab_size, size=(batch, prompt_len)),
                device="cuda")}
            T = batch * prompt_len
            with torch.no_grad():
                model_api.prefill(params, prompt, cfg)
                line = moe_trace(
                    lambda: model_api.prefill(params, prompt, cfg),
                    [[T, cfg.d_model], [cfg.d_model, cfg.num_experts]])
            emit("trace", run=f"{cfg.name} prefill blockwise", batch=batch,
                 prompt_len=prompt_len, **line)
            del prompt
        del params
        free_card()
    if CPU_HALVES is None:
        run_halves(moe_halves(mods, parity), launches)
    free_card()
    for arch in MOE_CARD_CPU:
        lm_cli(arch)
    emit("moe_phase", seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    return launches


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


# 6f. serving the detector: examples/continuous_federation.py at full width
SERVE_WINDOW = 256              # flows a window, and the engine's max_batch
SERVE_AMP = 0.7                 # the masquerade drift's amplitude
SERVE_ROUNDS = 6                # the initial federation's and each re-run's
SERVE_MONITOR = dict(threshold=0.25, patience=2)


class StepClock:
    """An injectable clock that moves only when told: two engines on it
    expire the same requests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def serve_dirs(cfg) -> np.ndarray:
    """The masquerade field: each attack class's cloud moves toward the
    Normal class's mean (class means of make_unsw_like(2024, 8192))."""
    from repro_torch.data import synthetic
    X, y = synthetic.make_unsw_like(2024, 8192, cfg.num_features,
                                    cfg.num_classes)
    mu = np.stack([X[y == c].mean(0) for c in range(cfg.num_classes)])
    dirs = mu[0][None, :] - mu
    dirs[0] = 0.0
    return dirs.astype(np.float32)


def serve_traffic(cfg, dirs, seed: int, n: int, amp: float) -> tuple:
    """One window of live flows, drifted by ``amp`` along ``dirs``
    (``core/scenario.apply_drift`` on the host)."""
    from repro_torch.core import scenario
    from repro_torch.data import synthetic
    X, y = synthetic.make_unsw_like(seed, n, cfg.num_features,
                                    cfg.num_classes)
    if amp:
        X = scenario.apply_drift(
            {"x": torch.from_numpy(X), "y": torch.from_numpy(y).long()},
            amp, torch.from_numpy(dirs))["x"].numpy()
    return X, y


def serve_spec(T, cfg, dirs, amp: float, seed: int):
    """The example's federation spec at full width: 8 heterogeneous
    clients, 12,000 samples drawn from the traffic at ``amp``, ``ours``,
    batch 64, lr 3e-2, 2 local epochs, SERVE_ROUNDS rounds."""
    return T.ExperimentSpec(
        model="anomaly-mlp",
        data=T.DataSpec(n_samples=12000, eval_samples=2400,
                        factory=lambda s, n: serve_traffic(cfg, dirs, s, n,
                                                           amp)),
        world=T.WorldSpec(num_clients=8, profile="heterogeneous"),
        strategy="ours",
        strategy_kwargs=dict(batch_size=64, lr=3e-2, local_epochs=2),
        rounds=SERVE_ROUNDS, seed=seed)


def served_scores(mlp, params, X, cfg) -> np.ndarray:
    """1 - P(Normal) of ``X`` under ``params``, on the params' device."""
    dev = next(iter(params.values())).device
    with torch.no_grad():
        return (1.0 - mlp.predict(params, torch.from_numpy(X).to(dev),
                                  cfg)[:, 0]).cpu().numpy()


def held_refederation(run: str, launches: dict, records) -> dict:
    """The megastep session's kernels: sign-align at least once a round
    from round 1 (round 0 has no reference to test against) and
    masked-agg at least once a round that applied an update; returns the
    launches a round."""
    rounds = len(records)
    applied = sum(r["updates_applied"] > 0 for r in records)
    need = {"per_client_sign_align": rounds - 1, "masked_agg": applied}
    for k, n in need.items():
        if launches[k] < n:
            raise AssertionError(f"{run}: {k} launched {launches[k]} times "
                                 f"in {rounds} rounds ({n} needed)")
    return {k: launches[k] / rounds for k in need}


def drive_serve(engine, monitor, clock, arrivals) -> tuple:
    """Feed ``arrivals`` ((flows, deadline_ms, seconds the clock moves
    after the submit), each drained before the next) to ``engine``: the
    responses, each monitored pump's statistic and the flows it fed."""
    out, stats, rows, flows = [], [], [], {}
    for X, deadline, advance in arrivals:
        ids = engine.submit_many(X, best_effort=True, deadline_ms=deadline)
        flows.update(zip(ids, X))       # a full queue sheds the tail
        clock.t += advance
        while engine.pending:
            before = len(monitor.history)
            got = engine.pump()
            out.extend(got)
            if len(monitor.history) > before:
                stats.append(monitor.history[-1])
                rows.append([flows[r.request_id] for r in got
                             if not r.expired])
        clock.t += 1e-3
    return out, stats, rows


def serve_card_cpu(parity, serve, mlp, cfg, dirs, params) -> dict:
    """A 4,096-flow stream (8 clean windows, then 8 drifted; window 2's
    flows expire in the queue; windows 4-8 arrive as one burst of 1,280
    against a queue limit of 1,024) through a card engine and a CPU
    engine holding the same weights, each with its own monitor, on one
    step clock: ``parity.serve_mismatches``, equal counts, each pump's
    statistic within ``parity.drift_stat_bound`` and the same trigger
    window."""
    Xref, _ = serve_traffic(cfg, dirs, 123, 1024, 0.0)
    wins = [serve_traffic(cfg, dirs, 2000 + w, SERVE_WINDOW,
                          0.0 if w < 8 else SERVE_AMP)[0] for w in range(16)]
    arrivals = ([(wins[0], None, 0.0), (wins[1], None, 0.0),
                 (wins[2], 5.0, 0.01), (wins[3], None, 0.0),
                 (np.concatenate(wins[4:9]), None, 0.0)]
                + [(w, None, 0.0) for w in wins[9:]])
    runs, ref_scores = {}, {}
    for dev in ("cuda", "cpu"):
        slot = serve.ModelSlot(params, model=cfg.name, round_idx=SERVE_ROUNDS,
                               device=dev)
        ref_scores[dev] = served_scores(mlp, slot.acquire()[0], Xref, cfg)
        mon = serve.DriftMonitor.from_sample(Xref, ref_scores[dev],
                                             device=dev, **SERVE_MONITOR)
        clock = StepClock()
        eng = serve.ServeEngine(slot, cfg, max_batch=SERVE_WINDOW,
                                monitor=mon, now=clock, queue_limit=1024)
        fired = []
        eng.on_trigger = lambda f=fired, m=mon: f.append(len(m.history) - 1)
        out, stats, rows = drive_serve(eng, mon, clock, arrivals)
        runs[dev] = (out, stats, rows, eng.shutdown(), fired)
    (out, stats, rows, st, fired), (c_out, c_stats, c_rows, c_st, c_fired) \
        = runs["cuda"], runs["cpu"]
    problems = parity.serve_mismatches(out, c_out)
    for f in ("submitted", "served", "shed", "deadline_miss", "errors",
              "dropped"):
        if getattr(st, f) != getattr(c_st, f):
            problems.append(f"{f} {getattr(st, f)} != {getattr(c_st, f)}")
    if [len(r) for r in rows] != [len(r) for r in c_rows]:
        problems.append("the monitored pumps differ")
    seen, bounds = [], []
    for w, pumped in enumerate(c_rows):
        seen.extend(pumped)
        bounds.append(parity.drift_stat_bound(
            np.stack(seen), Xref, ref_scores["cpu"],
            1 << (len(pumped) - 1).bit_length(), w + 1, c_stats[w]))
    problems += parity.drift_problems(stats, c_stats, bounds,
                                      SERVE_MONITOR["threshold"])
    if fired != c_fired or not fired:
        problems.append(f"trigger pumps {fired} (card) and {c_fired} (CPU)")
    scored = [(a, b) for a, b in zip(out, c_out) if not a.expired]
    line = dict(
        run="serve 4096 flows", flows=4096, pumps=len(stats),
        problems=problems, shed=st.shed, deadline_miss=st.deadline_miss,
        served=st.served, trigger_pump=fired,
        max_prob_gap=max(float(np.abs(a.probs - b.probs).max())
                         for a, b in scored),
        max_score_gap=max(abs(a.score - b.score) for a, b in scored),
        max_stat_gap=max(abs(a - b) for a, b in zip(stats, c_stats)),
        min_stat_bound=min(bounds), max_stat_bound=max(bounds),
        statistics=stats)
    emit("card_vs_cpu", **line)
    if problems:
        raise AssertionError("serve card vs CPU: " + "; ".join(problems))
    return line


def serve_latency(serve, mlp, cfg, dirs, params, smi: str,
                  reps: int = 50) -> dict:
    """p50 / p99 ms and flows/s overall and a bucket (1 to 256 rows, each
    bucket ``reps`` pumps in turns) on the card, with and without the
    monitor, after a warm pass and ``reset_stats()``; then one traced
    warm 256-row pump with the monitor."""
    Xref, _ = serve_traffic(cfg, dirs, 123, 1024, 0.0)
    X, _ = serve_traffic(cfg, dirs, 4242, SERVE_WINDOW, 0.0)
    buckets = [1 << k for k in range(SERVE_WINDOW.bit_length())]
    lines = {}
    for monitored in (True, False):
        slot = serve.ModelSlot(params, model=cfg.name, device="cuda")
        mon = serve.DriftMonitor.from_sample(
            Xref, served_scores(mlp, slot.acquire()[0], Xref, cfg),
            device="cuda", **SERVE_MONITOR) if monitored else None
        eng = serve.ServeEngine(slot, cfg, max_batch=SERVE_WINDOW,
                                monitor=mon)
        for b in buckets:
            eng.submit_many(X[:b])
            eng.pump()
        torch.cuda.synchronize()
        eng.reset_stats()
        for _ in range(reps):
            for b in buckets:
                eng.submit_many(X[:b])
                eng.pump()
        st = eng.stats()
        lines[monitored] = dict(p50_ms=st.p50_ms, p99_ms=st.p99_ms,
                                flows_per_sec=st.flows_per_sec,
                                by_bucket=st.by_bucket)
        emit("serve", run="latency", monitor=monitored, pumps_a_bucket=reps,
             **lines[monitored], nvidia_smi=smi)
        if monitored:
            def pump_256(eng=eng):
                eng.submit_many(X)
                eng.pump()
            emit("trace", run="serve pump 256 monitored",
                 **trace(pump_256))
    return lines


def serve_hot_swap(serve, cfg, dirs, params, ckpt: str, spec) -> dict:
    """A thread publishes the card checkpoint ``ckpt`` three times
    (``round_base`` 0, 6, 12) into a card slot while the main thread
    pumps 256-flow windows: nothing dropped, one version a batch,
    versions monotone over request ids."""
    import threading
    slot = serve.ModelSlot(params, model=cfg.name, device="cuda")
    eng = serve.ServeEngine(slot, cfg, max_batch=SERVE_WINDOW)
    wins = [serve_traffic(cfg, dirs, 3000 + w, SERVE_WINDOW, 0.0)[0]
            for w in range(8)]
    errors, published = [], []

    def publisher():
        try:
            for k in range(3):
                published.append(slot.publish_checkpoint(
                    ckpt, spec=spec, round_base=SERVE_ROUNDS * k).version)
        except Exception as e:          # reported below, then raised
            errors.append(e)

    t = threading.Thread(target=publisher, daemon=True, name="publisher")
    batches = []
    t0 = time.perf_counter()
    t.start()
    w = 0
    while (t.is_alive() or w < 8) and w < 4000:
        eng.submit_many(wins[w % len(wins)])
        while eng.pending:
            batches.append(eng.pump())
        w += 1
    t.join(120)
    eng.submit_many(wins[0])            # flips in the last publish
    batches.append(eng.pump())
    wall = time.perf_counter() - t0
    stats = eng.shutdown()
    if t.is_alive() or errors:
        raise AssertionError(f"hot swap: publisher alive={t.is_alive()} "
                             f"errors={errors!r}")
    mixed = [sorted({r.model_version for r in b}) for b in batches
             if len({r.model_version for r in b}) > 1]
    by_id = [r.model_version for b in batches
             for r in sorted(b, key=lambda r: r.request_id)]
    line = dict(run="hot swap under load", windows=w + 1,
                published=published, swaps=slot.swaps,
                versions=eng.versions_served, served=stats.served,
                submitted=stats.submitted, dropped=stats.dropped,
                mixed_batches=mixed, monotone=by_id == sorted(by_id),
                wall_s=wall, p50_ms=stats.p50_ms, p99_ms=stats.p99_ms)
    emit("serve", **line)
    if (stats.dropped or stats.served != stats.submitted or mixed
            or by_id != sorted(by_id) or slot.swaps < 1
            or eng.versions_served[-1] != 3):
        raise AssertionError(f"hot swap: {line}")
    return line


def serve_chaos(T, serve, faults, mlp, cfg, dirs, session, mods,
                tmp: str) -> tuple:
    """examples/continuous_federation.py's loop at full width on the
    card, under its fault schedule (a scorer fault at call 1, a
    refederate fault at attempt 0, a ×16 burst against a queue limit of
    2,048): clean windows, the burst, drifted windows until the
    background re-federation (6 rounds on the card) publishes, recovery
    windows; the example's assertions. Launch counts are set to 0 just
    before the loop and read after it: the re-federation's session is
    the only thing in it that launches a hand-written kernel."""
    params = session.result().params
    slot = serve.ModelSlot(params, model=cfg.name, round_idx=SERVE_ROUNDS,
                           device="cuda")
    Xref, _ = serve_traffic(cfg, dirs, 123, 1024, 0.0)
    monitor = serve.DriftMonitor.from_sample(
        Xref, served_scores(mlp, slot.acquire()[0], Xref, cfg),
        device="cuda", **SERVE_MONITOR)
    spec = faults.FaultSpec(seed=7, at={"scorer": (1,), "refederate": (0,)},
                            burst=faults.BurstSpec(period=1, mult=16)
                            ).validate()
    injector = faults.FaultInjector(spec)
    refed = serve.Refederator(
        slot, lambda k: serve_spec(T, cfg, dirs, SERVE_AMP, 100 + k),
        ckpt_dir=tmp, monitor=monitor, background=True, max_retries=2,
        backoff_base=0.05, seed=spec.seed, injector=injector,
        device="cuda")
    engine = serve.ServeEngine(slot, cfg, max_batch=SERVE_WINDOW,
                               monitor=monitor, queue_limit=8 * SERVE_WINDOW,
                               deadline_ms=60_000.0, injector=injector)
    engine.on_trigger = refed.fire
    overlap_lat = []

    def stream(w, amp):
        X, y = serve_traffic(cfg, dirs, 1000 + w, SERVE_WINDOW, amp)
        busy = refed.busy
        engine.submit_many(X)
        responses = engine.drain()
        if busy:
            overlap_lat.extend(r.latency for r in responses)
        auc = float(mlp.auc_roc(torch.tensor([r.score for r in responses]),
                                torch.from_numpy((y != 0).astype(
                                    np.float32))))
        return auc, responses[-1].model_version

    torch.cuda.synchronize()
    reset_launches(mods)
    t0 = time.perf_counter()
    w, clean = 0, []
    for _ in range(3):
        clean.append(stream(w, 0.0)[0])
        w += 1
    if monitor.triggered:
        raise AssertionError("the monitor fired on clean traffic")
    offered = spec.burst.size(0, SERVE_WINDOW)
    Xb, _ = serve_traffic(cfg, dirs, 555, offered, 0.0)
    accepted = engine.submit_many(Xb, best_effort=True)
    answered = engine.drain()
    burst = dict(offered=offered, accepted=len(accepted),
                 answered=len(answered), shed=engine.stats().shed)
    if not (len(answered) == len(accepted) == 8 * SERVE_WINDOW
            and burst["shed"] == offered - 8 * SERVE_WINDOW):
        raise AssertionError(f"burst: {burst}")
    drifted, recovered, overlap_windows = [], [], 0
    for _ in range(40):
        auc, v = stream(w, SERVE_AMP)
        w += 1
        if v > 0:
            recovered = [auc]
            break
        drifted.append(auc)
        if refed.last_outcome == "failed":
            raise refed.last_error
        if refed.busy:
            overlap_windows += 1
        if refed.fired and refed.busy and len(drifted) >= 4:
            refed.join(timeout=600)
    else:
        raise AssertionError(
            f"no hot swap after {len(drifted)} drifted windows (triggers "
            f"{monitor.trigger_count}, completed {refed.completed})")
    # re-reference the monitor under the new model's own scores
    Xr2, _ = serve_traffic(cfg, dirs, 777, 1024, SERVE_AMP)
    p_new, _meta = slot.acquire()
    from repro_torch.core import scenario
    monitor.rearm(reference=scenario.reference_snapshot(
        torch.from_numpy(Xr2).cuda(),
        torch.from_numpy(served_scores(mlp, p_new, Xr2, cfg)).cuda()))
    for _ in range(4):
        recovered.append(stream(w, SERVE_AMP)[0])
        w += 1
    refed.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(mods)
    health = serve.health_snapshot(engine, refederator=refed)
    stats = engine.shutdown()
    path = refed.last_checkpoint
    records = pickle.loads(open(path, "rb").read())["records"]
    line = dict(
        run="continuous federation under chaos", windows=w,
        wall_s=wall, burst=burst,
        auc_clean=float(np.mean(clean)), auc_drifted=float(np.mean(drifted)),
        auc_recovered=float(np.mean(recovered)),
        recovered_above_drifted=float(np.mean(recovered))
        > float(np.mean(drifted)),
        drift_statistics=monitor.history, triggers=monitor.trigger_count,
        fired=refed.fired, completed=refed.completed,
        retries=refed.retries, breaker=refed.breaker_state,
        swaps=slot.swaps, versions=engine.versions_served,
        served=stats.served, submitted=stats.submitted,
        dropped=stats.dropped, deadline_miss=stats.deadline_miss,
        errors=stats.errors, overlap_windows=overlap_windows,
        p99_overlap_ms=float(np.percentile(overlap_lat, 99) * 1e3)
        if overlap_lat else None,
        p50_ms=stats.p50_ms, p99_ms=stats.p99_ms,
        refederation_rounds=len(records), launches=launches,
        launches_per_round=held_refederation(
            "re-federation", launches, records),
        health=health.to_dict())
    emit("serve", **line)
    if not (monitor.trigger_count >= 1 and refed.completed >= 1
            and refed.last_error is None and refed.retries >= 1
            and refed.breaker_state == "closed" and slot.swaps >= 1
            and max(engine.versions_served) >= 1 and stats.dropped == 0
            and stats.deadline_miss == 0 and stats.errors == 1
            and stats.served == stats.submitted):
        raise AssertionError(f"continuous federation: {line}")
    return path, int(path[-8:-5]), line


def serve_across_devices(parity, serve, cfg, dirs, params, path: str,
                         spec) -> None:
    """The re-federated card checkpoint published into a CPU slot and
    into a card slot (each restoring on its own device): the two engines'
    scores of a drifted 512-flow window by ``parity.serve_mismatches``."""
    X, _ = serve_traffic(cfg, dirs, 4321, 2 * SERVE_WINDOW, SERVE_AMP)
    out = {}
    for dev in ("cuda", "cpu"):
        slot = serve.ModelSlot(params, model=cfg.name, round_idx=SERVE_ROUNDS,
                               device=dev)
        slot.publish_checkpoint(path, spec=spec, round_base=SERVE_ROUNDS)
        eng = serve.ServeEngine(slot, cfg, max_batch=SERVE_WINDOW)
        eng.submit_many(X)
        out[dev] = eng.drain()
    problems = parity.serve_mismatches(out["cuda"], out["cpu"])
    if {r.model_version for r in out["cpu"]} != {1}:
        problems.append("the CPU slot did not flip to the checkpoint")
    emit("card_vs_cpu", run="serve card checkpoint in a CPU slot",
         checkpoint=os.path.basename(path), flows=len(X), problems=problems,
         max_prob_gap=max(float(np.abs(a.probs - b.probs).max())
                          for a, b in zip(out["cuda"], out["cpu"])))
    if problems:
        raise AssertionError("serve across devices: " + "; ".join(problems))


def serve_cli() -> None:
    """``python -m repro_torch.launch.serve --arch anomaly-mlp --batch 256
    --requests 2048`` on the card: exit 0, two lines."""
    cli_check("serve", "cli", [
        "repro_torch.launch.serve", "--arch", "anomaly-mlp", "--batch",
        "256", "--requests", "2048"],
        lambda lines: len(lines) == 2
        and lines[0].startswith("scored 2048 flows"))


def phase_serve(T, parity, mods, smi: str) -> None:
    """The serving phase (module docstring, 6f)."""
    from repro_torch import faults, serve
    from repro_torch.models import mlp_detector as mlp
    t_phase = time.perf_counter()
    cfg = quickstart_spec(T, "ours").resolve_model()
    dirs = serve_dirs(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        spec = serve_spec(T, cfg, dirs, 0.0, 0)
        torch.cuda.synchronize()
        reset_launches(mods)
        t0 = time.perf_counter()
        session = T.ExperimentSession.open(spec, device="cuda")
        session.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(mods)
        ckpt = f"{tmp}/initial.ckpt"
        session.checkpoint(ckpt)
        res = session.result()
        records = [dataclasses.asdict(r) for r in res.records]
        emit("serve", run="initial federation", rounds=len(records),
             wall_s=wall, accuracy=res.final.accuracy, launches=launches,
             launches_per_round=held_refederation("initial federation",
                                                  launches, records))
        params = {k: v.clone() for k, v in res.params.items()}
        serve_card_cpu(parity, serve, mlp, cfg, dirs, params)
        serve_latency(serve, mlp, cfg, dirs, params, smi)
        serve_hot_swap(serve, cfg, dirs, params, ckpt, spec)
        path, k, _line = serve_chaos(T, serve, faults, mlp, cfg, dirs,
                                     session, mods, tmp)
        serve_across_devices(parity, serve, cfg, dirs, params, path,
                             serve_spec(T, cfg, dirs, SERVE_AMP, 100 + k))
    serve_cli()
    emit("serve_phase", seconds=time.perf_counter() - t_phase,
         nvidia_smi=smi)


# ---------------------------------------------------------------------------
# 8. training the language models: the spmd step at full width
# ---------------------------------------------------------------------------

TRAIN_CELL = dict(clients=2, per_client=1, seq=4096, theta=0.65)
TRAIN_LAUNCHES = ("per_client_sign_align", "masked_agg", "flash_attention",
                  "flash_attention_simt")
TRAIN_KERNEL_CLASSES = {   # trace share name -> substrings of kernel names
    "count": ("sign_align",),
    "aggregation": ("masked_agg",),
    "attention_flash": ("flash",),
    "gemm": ("gemm", "Gemm", "sm90_xmma", "nvjet", "cutlass", "cublas"),
}


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one step: 6·N'·T + 6·L·S·H·hd·T (causal attention,
    half of 12·L·S·H·hd·T), N' the parameters a token's matrix products
    read (less the input embedding; the top-k experts of an MoE layer),
    T the step's tokens; remat's recompute is not counted."""
    n = cfg.param_count(active_only=bool(cfg.num_experts))
    n -= cfg.vocab_size * cfg.d_model
    return (6.0 * n * tokens
            + 6.0 * cfg.num_layers * seq * cfg.num_heads * cfg.hd * tokens)


def train_reckoning(cfg, n_params: int, rows: int, clients: int,
                    seq: int) -> dict:
    """The step's device memory, item by item (bytes), reckoned from the
    shapes before the run."""
    V = cfg.padded_vocab
    items = {
        "weights_bf16": 2 * n_params,
        "adamw_m_v_master_f32": 12 * n_params,
        "arena_f32": clients * rows * 1024 * 4,
        "aggregate_f32": rows * 1024 * 4,
        "reference_signs_int8": n_params,
        "one_client_gradients_bf16": 2 * n_params,
        "logits_bf16_f32_and_gradient": seq * V * (2 + 4 + 4),
        "one_layer_scores_f32_x3": (3 * 4 * cfg.num_heads * seq * seq
                                    if cfg.attention_impl == "full" else 0),
    }
    items["total"] = sum(items.values())
    return items


def stepped(step, box: list, batch) -> dict:
    """One step of the state held in ``box`` (a one-element list), which
    takes the new state; returns the metrics. No caller's frame keeps the
    old state alive: a step's peak already holds the state twice (the
    input and the optimizer's new one)."""
    state, m = step(box.pop(), batch)
    box.append(state)
    return m


def train_run(mods, step, box: list, batches, warm: int = 1) -> dict:
    """``warm`` steps, then one step per remaining batch, timed on the
    host's clock (each ending in a synchronisation), every launch count
    set to 0 just before the timed steps and read just after; the peak
    device memory of the timed steps. ``box`` holds the state."""
    for b in batches[:warm]:
        stepped(step, box, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    losses, ratios, masks, walls = [], [], [], []
    for b in batches[warm:]:
        t0 = time.perf_counter()
        m = stepped(step, box, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        ratios.append(m["ratios"].tolist())
        masks.append(m["mask"].tolist())
    launches = read_launches(mods)
    return dict(step_s=walls, losses=losses, ratios=ratios, masks=masks,
                launches=launches,
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def held_train_launches(run: str, launches: dict, steps: int,
                        flash: int) -> None:
    """One count and one aggregation a step (θ on), ``flash`` flash
    launches a step (all wgmma: bf16, hd 128), no other kernel."""
    want = dict.fromkeys(launches, 0)
    want.update(per_client_sign_align=steps, masked_agg=steps,
                flash_attention=flash * steps)
    if launches != want:
        raise AssertionError(f"{run}: launches {launches}, not {want}")


def train_trace(step, box: list, batch) -> dict:
    """A warm step under ``torch.profiler``: busy time by kernel class
    (matrix products, the flash kernel, the count, the aggregation, the
    rest: the optimizer's and the loss's elementwise kernels, the
    backward's attention), the idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stepped(step, box, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_events, busy = device_busy(prof)
    by_class = dict.fromkeys(list(TRAIN_KERNEL_CLASSES) + ["other"], 0.0)
    top = sorted(((e.key, e.count, e.device_time_total)
                  for e in prof.key_averages() if e.device_time_total > 0),
                 key=lambda x: -x[2])[:12]
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        for name, keys in TRAIN_KERNEL_CLASSES.items():
            if any(k in e.key for k in keys):
                by_class[name] += e.device_time_total
                break
        else:
            by_class["other"] += e.device_time_total
    total = sum(by_class.values())
    return dict(
        device_events=n_events, device_busy_us=busy, wall_us=wall_us,
        device_idle_share=1.0 - busy / wall_us,
        share_of_kernel_time={k: v / total for k, v in by_class.items()},
        kernel_us=by_class,
        top_by_device_time=[dict(name=n[:70], count=c, us=t)
                            for n, c, t in top])


def train_spans(mods, step, box: list, batch) -> dict:
    """A warm step with CUDA events around its phases: the per-client
    gradients, the count, the aggregation and the optimizer (each the
    device time between its events, idle gaps included)."""
    from repro_torch.core import alignment, fl_step
    from repro_torch.kernels import arena as arena_mod
    events, saved = [], {}

    def timed(name, fn):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events.append((name, start, end))
            return out
        return call

    targets = ((fl_step, "_lm_client_grads", "gradients"),
               (alignment, "cohort_alignment", "count"),
               (arena_mod, "weighted_sum", "aggregation"))
    for mod, attr, name in targets:
        saved[(mod, attr)] = getattr(mod, attr)
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stepped(step, box, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    spans = {name: s.elapsed_time(e) for name, s, e in events}
    spans["rest_optimizer_and_update"] = wall * 1e3 - sum(spans.values())
    return dict(wall_ms=wall * 1e3, span_ms=spans)


def train_cell(mods, run: str, cfg, steps: int = 3, cell=None,
               warm: int = 1) -> tuple:
    """The training cell of one config at full width (``cell``, else
    TRAIN_CELL): weights drawn on the card from seed 0, the config's
    optimizer, ``warm`` warm steps and ``steps`` timed ones; returns (box, step,
    batches, line), ``box`` a one-element list holding the state
    (``stepped``). Model FLOPs are not reckoned for the audio family (its
    encoder frames are no tokens of the formula)."""
    from repro_torch.core import fl_step
    from repro_torch.launch import train as train_mod
    cell = cell or TRAIN_CELL
    C, B, S = (cell[k] for k in ("clients", "per_client", "seq"))
    t0 = time.perf_counter()
    box = [fl_step.init_state(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = fl_step.build_fl_train_step(cfg, theta=cell["theta"])
    draw = train_mod.make_batch_fn(cfg, C, B, S, seed=0, device="cuda")
    batches = [draw() for _ in range(steps + warm)]
    r = train_run(mods, step, box, batches, warm=warm)
    n = sum(t.numel() for t in _leaves(box[0].params))
    rows = -(-n // 1024)
    tokens = C * B * (S - (cfg.num_patches if cfg.family == "vlm" else 0))
    flops = (None if cfg.family == "audio"
             else train_flops(cfg, C * B * S, S))
    step_s = sum(r["step_s"]) / len(r["step_s"])
    finite = all(math.isfinite(x) for x in r["losses"])
    line = dict(run=run, arch=cfg.name, layers=cfg.num_layers,
                attention_impl=cfg.attention_impl, remat=cfg.remat,
                dtype=cfg.dtype, clients=C, per_client_batch=B, seq=S,
                theta=cell["theta"],
                optimizer=sorted(box[0].opt_state), params=n,
                arena_rows=rows,
                init_s=init_s, step_s=r["step_s"], step_s_mean=step_s,
                tokens_per_s=tokens / step_s,
                model_tflops_per_step=None if flops is None else flops / 1e12,
                model_tflop_per_s=(None if flops is None
                                   else flops / step_s / 1e12),
                flops_formula="6*N'*T + 6*L*S*H*hd*T (N' = parameters less "
                              "the input embedding, active experts only; T "
                              "tokens a step; remat's recompute not counted)",
                losses=r["losses"], ratios=r["ratios"], masks=r["masks"],
                peak_memory_bytes=r["peak_memory_bytes"],
                reckoned_bytes=train_reckoning(cfg, n, rows, C, S),
                launches=r["launches"], finite=finite)
    if not finite:
        raise AssertionError(f"{run}: losses {r['losses']}")
    return box, step, batches, line


def phase_train_qwen2(mods, smi: str) -> tuple:
    """8 (a) and (f): the qwen2-1.5b cell, full attention then blockwise
    (the flash kernel: 28 layers × 2 (the forward, remat's recompute) × 2
    clients a step), the blockwise run traced and its phases timed.
    Returns the launches of each run and the arena's rows."""
    from repro_torch.configs import registry
    base = registry.get_config("qwen2-1.5b")
    launches = {}
    for impl in ("full", "blockwise"):
        cfg = base.replace(attention_impl=impl)
        run = f"qwen2-1.5b train {impl}"
        box, step, batches, line = train_cell(mods, run, cfg)
        flash = (2 * cfg.num_layers * TRAIN_CELL["clients"]
                 if impl == "blockwise" else 0)
        held_train_launches(run, line["launches"], len(batches) - 1, flash)
        line["flash_launches_per_step_expected"] = flash
        emit("slice", **line, nvidia_smi=smi)
        launches[run] = line["launches"]
        if impl == "blockwise":
            emit("trace", run=f"{run} warm step",
                 **train_trace(step, box, batches[0]))
            emit("trace", run=f"{run} phases",
                 **train_spans(mods, step, box, batches[1]))
        rows = line["arena_rows"]
        del box, step, batches
        free_card()
    return launches, rows


def traced_grid(fn, kernel: str, calls: int = 2) -> dict:
    """The launches of the kernel whose name holds ``kernel`` in a
    ``torch.profiler`` trace of ``calls`` calls of ``fn`` and a small
    kernel after them (a trace of milliseconds-long kernels can lose its
    last event): blocks, threads a block, registers a thread."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    mine = {(tuple(e["args"]["grid"]), tuple(e["args"]["block"]),
             e["args"].get("registers per thread")) for e in events
            if e.get("cat") == "kernel" and kernel in e.get("name", "")}
    return dict(traced=[dict(blocks=math.prod(g), threads_per_block=
                             math.prod(b), registers_per_thread=r)
                        for g, b, r in sorted(mine)])


def phase_train_kernels(sign_align, masked_agg, ref, R: int,
                        smi: str, arena: str = "qwen2-1.5b") -> None:
    """8 (b): the count and the aggregation at C 2 × R, the rows of
    ``arena``'s arena (qwen2-1.5b's; hymba-1.5b's in phase 9), against
    their plain versions, timed beside their bounds."""
    C = TRAIN_CELL["clients"]
    u, r, w = kernel_inputs(C, R, seed=3)
    counts, _ = held_counts(sign_align.per_client_sign_align,
                            ref.per_client_sign_align, u, r,
                            f"C={C}, R={R}")
    got, want, excess = held_agg(masked_agg, ref, u, w, f"C={C}, R={R}")
    err = float((got - want).abs().max())
    del got, want
    free_card()
    m = R * 1024
    sa_bound = bound_ms(C * m * 4 + m + C * 4, 2 * C * m)
    ma_bound = bound_ms(C * m * 4 + C * 4 + m * 4, 2 * C * m)
    emit("kernels", name="per_client_sign_align", shape=[C, R],
         arena=arena, counts=counts.tolist(), sign_align="equal",
         ms=time_ms(lambda: sign_align.per_client_sign_align(u, r),
                    iters=20, warmup=3),
         plain_ms=time_ms(lambda: ref.per_client_sign_align(u, r),
                          iters=3, warmup=1),
         bound_ms=sa_bound[0], bound_by=sa_bound[1], library_ms=None,
         design=traced_grid(lambda: sign_align.per_client_sign_align(u, r),
                            "sign_align"), nvidia_smi=smi)
    emit("kernels", name="masked_agg", shape=[C, R], arena=arena,
         max_abs_err=err, excess=excess,
         ms=time_ms(lambda: masked_agg.masked_agg(u, w), iters=20, warmup=3),
         plain_ms=time_ms(lambda: ref.masked_agg(u, w), iters=3, warmup=1),
         bound_ms=ma_bound[0], bound_by=ma_bound[1],
         library_ms=time_ms(lambda: torch.einsum("crl,c->rl", u, w),
                            iters=5, warmup=1),
         design=traced_grid(lambda: masked_agg.masked_agg(u, w),
                            "masked_agg_kernel"), nvidia_smi=smi)


FLASH_TRAIN_CASES = {   # name -> ((B, S, H, K, hd), dtype, route)
    "qwen2 train (1, 4096, 12, 2, 128) bf16": ((1, 4096, 12, 2, 128),
                                               torch.bfloat16, "wgmma"),
    "granite-moe train (1, 4096, 16, 8, 64) bf16": ((1, 4096, 16, 8, 64),
                                                    torch.bfloat16, "wgmma"),
    "qwen2 2-layer f32 (1, 512, 12, 2, 128)": ((1, 512, 12, 2, 128),
                                               torch.float32, "simt"),
}


def flash_grad_excess(got, want, dtype) -> float:
    """Largest excess of |got − want| over the tolerance (≤ 0 passes).
    f32: 1e-5 of max|want| (sums over keys and queries in another
    order). bf16: two bf16 ulps of the element (each side rounds its f32
    gradient once) plus 2^-8 of max|want|: the backward's rowsum(dO ∘ O)
    reads the forward's output rounded to bf16 (2^-9 relative an
    element), which moves dS by up to that share of the row's scale."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    if dtype == torch.float32:
        return float((g - w).abs().max()) - 1e-5 * scale
    ulp = 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
    return float(((g - w).abs() - 2 * ulp).max()) - 2.0 ** -8 * scale


def phase_train_flash(flash_attn, ref) -> None:
    """8 (c): the flash forward and backward against the plain forward's
    autograd, on the same inputs and output gradient, causal; timed (one
    forward and backward) beside SDPA's."""
    import torch.nn.functional as F
    for name, ((B, S, H, K, hd), dtype, route) in FLASH_TRAIN_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(5)
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device="cuda"
                               ).to(dtype) for n in (H, K, K))
        dout = torch.randn((B, S, H, hd), generator=g, device="cuda").to(
            dtype)

        def kernel_grads():
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            flash_attn.flash_attention_gqa(qq, kk, vv, causal=True).backward(
                dout)
            return qq.grad, kk.grad, vv.grad

        def plain_grads():
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = ref.flash_attention(
                qq.transpose(1, 2).reshape(B * H, S, hd),
                kk.transpose(1, 2).reshape(B * K, S, hd),
                vv.transpose(1, 2).reshape(B * K, S, hd), True,
                kv_groups=H // K).reshape(B, H, S, hd).transpose(1, 2)
            out.backward(dout)
            return qq.grad, kk.grad, vv.grad

        def sdpa_grads():
            qq, kk, vv = (t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v))
            F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                           enable_gqa=True).backward(
                dout.transpose(1, 2))
            return qq.grad, kk.grad, vv.grad

        before = dict(flash_attn.launches_by_route)
        got = kernel_grads()
        torch.cuda.synchronize()
        routes = {r_: flash_attn.launches_by_route[r_] - before[r_]
                  for r_ in before}
        want = plain_grads()
        excess = [flash_grad_excess(a, b, dtype) for a, b in zip(got, want)]
        line = dict(name="flash_attention backward", case=name,
                    shape=[B, S, H, K, hd], dtype=str(dtype), route=route,
                    routes_launched=routes,
                    max_abs_err=[float((a.float() - b.float()).abs().max())
                                 for a, b in zip(got, want)],
                    excess=excess,
                    ms=time_ms(kernel_grads, iters=5, warmup=2),
                    plain_ms=time_ms(plain_grads, iters=3, warmup=1),
                    library_ms=time_ms(sdpa_grads, iters=5, warmup=2))
        emit("kernels", **line)
        if routes != {route: 1, ("simt" if route == "wgmma" else "wgmma"): 0}:
            raise AssertionError(f"flash backward {name}: routes {routes}")
        if not all(e <= 0.0 for e in excess):
            raise AssertionError(f"flash backward {name}: excess {excess}")


def phase_train_moe(mods, smi: str) -> dict:
    """8 (d): granite-moe-1b-a400m's cell at full width (blockwise, the
    MoE VJPs and the flash kernel), 1 warm and 2 timed steps."""
    from repro_torch.configs import registry
    cfg = registry.get_config("granite-moe-1b-a400m").replace(
        attention_impl="blockwise")
    run = "granite-moe-1b-a400m train blockwise"
    box, step, batches, line = train_cell(mods, run, cfg, steps=2)
    flash = 2 * cfg.num_layers * TRAIN_CELL["clients"]
    held_train_launches(run, line["launches"], len(batches) - 1, flash)
    emit("slice", **line, nvidia_smi=smi)
    del box, step, batches
    free_card()
    return {run: line["launches"]}


def train_f32_cpu(arch: str) -> dict:
    """The CPU half of 8 (e): ``arch`` at full width, 2 layers deep, f32,
    C 2 × B 1 × 256 tokens (a vlm's 256 patch embeddings before them),
    θ 0.65, the config's optimizer (adamw without master weights in f32),
    2 steps on the CPU from seed 0's weights: each step's batch, the state
    before and after it, its metrics and its routing."""
    from repro_torch.configs import registry
    from repro_torch.core import fl_step
    from repro_torch.launch import train as train_mod
    from repro_torch.models import moe
    cfg = registry.get_config(arch).replace(num_layers=2, dtype="float32")
    seq = 256 + (cfg.num_patches if cfg.family == "vlm" else 0)
    step = fl_step.make_raw_step(cfg, theta=TRAIN_CELL["theta"],
                                 agg_dtype=torch.float32)
    cpu = fl_step.init_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    draw = train_mod.make_batch_fn(cfg, TRAIN_CELL["clients"], 1, seq,
                                   seed=1, device="cpu")
    steps = []
    for _ in range(2):
        batch = draw()
        t0 = time.perf_counter()
        with RoutingRecorder(moe) as rec:
            after, metrics = step(cpu, batch)
        steps.append(dict(batch=batch, before=cpu, after=after,
                          metrics=metrics, calls=rec.calls,
                          cpu_step_s=time.perf_counter() - t0))
        cpu = after
    return dict(cfg=cfg, seq=seq, steps=steps)


def train_f32_card(mods, parity, cpu: dict) -> dict:
    """Its card half: each step replayed on the card from the CPU's state
    before it, TF32 off. Records equal, loss within LOSS_RTOL, no θ ratio
    within THETA_BAND; the card's aggregated gradient (from its moments)
    within ``parity.grad_problems`` of the CPU's, each leaf's largest gap
    printed beside its bound; reference signs and weights by the adamw
    rule of ``api/parity.py``. An MoE step's routing is held on the
    card's layer inputs replayed on the CPU; where the two runs' routing
    parts (a token within its margin), the step's gradients and weights
    are not comparable: the step says ``weights_held: false``, and its
    gaps are printed, not held."""
    from repro_torch.core import fl_step
    from repro_torch.models import moe
    from repro_torch.tree import named_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, seq = cpu["cfg"], cpu["seq"]
    arch = cfg.name
    patches = cfg.num_patches if cfg.family == "vlm" else 0
    step = fl_step.make_raw_step(cfg, theta=TRAIN_CELL["theta"],
                                 agg_dtype=torch.float32)
    width = max(cfg.d_model, cfg.d_ff, cfg.padded_vocab, seq)

    def flat(tree):
        """name -> leaf on the card (the rules run there, in f64)."""
        return {"/".join(map(str, p)): v.detach().to("cuda")
                for p, v in named_leaves(tree)}

    problems, launches, lines = [], None, []
    for i, rec in enumerate(cpu["steps"]):
        batch, before, after, cm = (rec["batch"], rec["before"],
                                    rec["after"], rec["metrics"])
        card = tree_map(lambda t: t.to("cuda") if torch.is_tensor(t) else t,
                        before)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        reset_launches(mods)
        with RoutingRecorder(moe, inputs=True) as card_rec:
            card, km = step(card, {k: v.to("cuda") for k, v in batch.items()})
        torch.cuda.synchronize()
        launches = read_launches(mods)
        t2 = time.perf_counter()
        where = f"{arch} step {i}: "
        for k in ("mask", "selected", "delivered"):
            if not torch.equal(km[k].cpu(), cm[k]):
                problems.append(f"{where}{k} {km[k].tolist()} vs "
                                f"{cm[k].tolist()}")
        for k in ("accept_rate", "bytes_sent", "bytes_baseline"):
            if float(km[k]) != float(cm[k]):
                problems.append(f"{where}{k} {float(km[k])} vs "
                                f"{float(cm[k])}")
        loss_gap = abs(float(km["loss"]) - float(cm["loss"]))
        if not loss_gap <= parity.LOSS_RTOL * abs(float(cm["loss"])):
            problems.append(f"{where}loss {float(km['loss'])} vs "
                            f"{float(cm['loss'])}")
        if i > 0:
            problems += [where + p for p in parity.theta_band_violations(
                [(i, c, float(x)) for c, x in enumerate(km["ratios"])],
                TRAIN_CELL["theta"])]
        run_vs_run = replayed = []
        if cfg.num_experts:
            with torch.no_grad():
                replayed = parity.routing_problems(card_rec.calls, [
                    moe.route(c, router.cpu(), xt.cpu())
                    for c, router, xt in card_rec.inputs])
            run_vs_run = parity.routing_problems(card_rec.calls,
                                                 rec["calls"])
            problems += [where + "replayed routing: " + p for p in replayed]
        # each run's aggregated gradient from its first moments, both
        # from the same m0: g = (m1 − 0.9·m0) / 0.1 (the recovery's own
        # rounding, a few f32 ulps of m, lies far inside grad_bound)
        m0 = flat(before.opt_state["m"])

        def grads_of(state):
            m1 = flat(state.opt_state["m"])
            return {k: (m1[k].double() - 0.9 * m0[k].double()) / 0.1
                    for k in m1}
        g, g_card = grads_of(after), grads_of(card)
        bounds = {k: parity.grad_bound(v, width, seq) for k, v in g.items()}
        grad_gaps = {k: [float((g_card[k] - g[k]).abs().max()), bounds[k]]
                     for k in sorted(g)}
        weights = signs = []
        if not run_vs_run:
            problems += parity.grad_problems(g_card, g, width, seq, where)
            signs = parity.ref_sign_problems(flat(card.ref_sign),
                                             flat(after.ref_sign), g, bounds,
                                             where)
            weights = parity.adamw_weight_problems(
                flat(card.params), flat(after.params), [g], [bounds],
                [1e-3], count0=i, where=where)
            problems += signs + weights
        lines.append(dict(step=i, loss_card_cpu=[float(km["loss"]),
                                                 float(cm["loss"])],
                          ratios=km["ratios"].tolist(),
                          routing_run_vs_run=run_vs_run,
                          weights_held=not run_vs_run,
                          grad_gap_and_bound=grad_gaps,
                          grad_gap_over_bound=max(
                              (a / b for a, b in grad_gaps.values() if b > 0),
                              default=0.0),
                          cpu_step_s=rec["cpu_step_s"],
                          card_step_s=t2 - t1,
                          check_s=time.perf_counter() - t2))
        del card, g, g_card, m0
    line = dict(run=f"{arch} 2-layer f32 train", layers=2, clients=2,
                batch=1, tokens=256, patches=patches, steps=lines,
                allow_tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                                cudnn=torch.backends.cudnn.allow_tf32),
                launches=launches, problems=problems)
    emit("card_vs_cpu", **line)
    if launches["per_client_sign_align"] != 1 or launches["masked_agg"] != 1:
        raise AssertionError(f"{arch} card step launches {launches}")
    if problems:
        raise AssertionError(f"{arch} train card vs CPU: "
                             + "; ".join(problems))
    return {f"{arch} 2-layer f32 train": launches}


TRAIN_CARD_CPU = ("qwen2-1.5b", "granite-moe-1b-a400m", "internvl2-2b")


def train_halves(mods, parity) -> list:
    """Phase 8 (e) as (name, CPU half, card half) a arch."""
    return [(f"{arch} 2-layer f32 train",
             functools.partial(train_f32_cpu, arch),
             functools.partial(train_f32_card, mods, parity))
            for arch in TRAIN_CARD_CPU]


def train_cli(argv, run: str) -> None:
    """``python -m repro_torch.launch.train`` on the card: exit 0, its log
    lines, and a checkpoint written (the first step's) into ``{ckpt}``."""
    def ok(lines):
        saved = re.search(r"checkpoints=(\d+)$", lines[-1])
        return (lines[-1].startswith("done:") and saved is not None
                and int(saved.group(1)) >= 1)
    cli_check("slice", run, ["repro_torch.launch.train", *argv,
                             "--ckpt-dir", "{ckpt}"], ok, keep=4)


def phase_train(mods, parity, ref, smi: str) -> dict:
    """Phase 8 (module docstring, 8 (a) to (g)). Returns the launches of
    each full-width run."""
    t_phase = time.perf_counter()
    parts = {}

    def mark(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches, rows = phase_train_qwen2(mods, smi)
    mark("a_f_qwen2")
    phase_train_kernels(mods["sign_align"], mods["masked_agg"], ref, rows,
                        smi)
    free_card()
    mark("b_kernels")
    phase_train_flash(mods["flash_attn"], ref)
    free_card()
    mark("c_flash")
    launches.update(phase_train_moe(mods, smi))
    mark("d_moe")
    if CPU_HALVES is None:
        run_halves(train_halves(mods, parity), launches)
    mark("e_card_vs_cpu")
    train_cli(["--arch", "qwen2-1.5b", "--clients", "2",
               "--per-client-batch", "1", "--seq", "2048", "--steps", "2",
               "--log-every", "1"], "qwen2-1.5b train cli")
    train_cli(["--arch", "anomaly-mlp", "--steps", "5"],
              "anomaly-mlp train cli")
    mark("g_cli")
    emit("train_phase", seconds=time.perf_counter() - t_phase,
         seconds_by_part=parts, nvidia_smi=smi)
    return launches


# ---------------------------------------------------------------------------
# 9. the ssm, hybrid and audio families: served and trained at full width
# ---------------------------------------------------------------------------

# run -> (arch, attention_impl, batch, prompt positions, decode steps,
# flash launches of the prefill); whisper's prompt is its decoder's tokens
# (beside its 1,500 stub frames), 512 the least that reaches the kernel
FAMILY_SERVES = {
    "rwkv6-7b serve": ("rwkv6-7b", "full", 4, 2048, 16, 0),
    "hymba-1.5b serve blockwise": ("hymba-1.5b", "blockwise", 4, 2048, 16,
                                   8),
    "hymba-1.5b serve full": ("hymba-1.5b", "full", 4, 2048, 16, 0),
    "whisper-tiny serve blockwise": ("whisper-tiny", "blockwise", 4, 512, 16,
                                     4),
    "whisper-tiny serve full": ("whisper-tiny", "full", 4, 512, 16, 0),
}
RWKV_PREFILL_CUT_S = 30.0      # above it the rwkv6 prompt is cut to 1,024
# rwkv6-7b and hymba-1.5b are served at full width cut to 8 layers: their
# prefills are a loop over time a layer (6.5-11 s at 32 layers), and the
# script must leave room for phase 10
FAMILY_SERVE_LAYERS = {"rwkv6-7b": 8, "hymba-1.5b": 8}
# arch -> (cell, flash launches a step, warm steps, timed steps, layers
# (None: all)): hymba's step is its selective scan's launches (forward,
# remat's recompute and backward: 42-75 s of host time at its 32 layers),
# so its one timed step is its first, at full width cut to 8 layers to
# keep the script inside its time with phase 10; the count and the
# aggregation are held at its full arena all the same
FAMILY_TRAIN = {
    "hymba-1.5b": (dict(clients=2, per_client=1, seq=512, theta=0.65),
                   2 * 8 * 2, 0, 1, 8),
    "whisper-tiny": (dict(clients=4, per_client=1, seq=512, theta=0.65),
                     2 * 4 * 4, 1, 2, None),
}
# card against CPU, f32: arch -> (layers (None: all), training steps);
# rwkv6's CPU step at d 4,096 takes half a minute, so it takes one
FAMILY_CARD_CPU = {"whisper-tiny": (None, 2), "rwkv6-7b": (2, 1),
                   "hymba-1.5b": (2, 2)}
# the recurrent loops (plain torch, a loop over time) whose share of a
# prefill and of a training step is timed: module -> function
SCAN_LOOPS = {"rwkv6": "_wkv_scan", "hybrid": "_ssm_scan"}


class ScanTimer:
    """Wraps the family's recurrent loop (``SCAN_LOOPS``) with CUDA events
    around each call (no synchronisation); ``ms()`` sums their spans, the
    device time from a call's first launch to its last, gaps included."""

    def __init__(self, module):
        self.mod = module
        self.name = SCAN_LOOPS.get(module.__name__.rsplit(".", 1)[-1])
        self.events = []

    def __enter__(self):
        if self.name:
            fn = getattr(self.mod, self.name)

            def timed(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                self.events.append((start, end))
                return out
            self.fn = fn
            setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        if self.name:
            setattr(self.mod, self.name, self.fn)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def family_weights(cfg) -> tuple:
    """The config's weights drawn on the card from seed 0 (the card freed
    first): (params, line) with the real count beside ``param_count``'s
    formula (approximate for ssm and hybrid, as in the JAX package)."""
    from repro_torch.models import api as model_api
    free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_api.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    return params, dict(
        run=f"{cfg.name} weights", layers=cfg.num_layers, params=n,
        param_count_formula=cfg.param_count(),
        bytes=sum(t.numel() * t.element_size() for t in _leaves(params)),
        f32_leaves=sorted({".".join(map(str, p)) for p, t in
                           _named(params) if t.dtype == torch.float32}),
        draw_s=time.perf_counter() - t0,
        init_peak_memory_bytes=torch.cuda.max_memory_allocated())


def _named(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, prefix + (k,))
    else:
        yield prefix, tree


def serve_reckoning(cfg, n: int, batch: int, prompt_len: int,
                    steps: int) -> dict:
    """A serve's device memory, item by item (bytes), from the shapes: the
    ``n`` weights, the cache at the decode length, the prefill's logits,
    and the init's largest f32 draw (the stacked channel-mix or FFN up
    matrix)."""
    from repro_torch.models import api as model_api
    cache = model_api.init_cache(cfg, 1, prompt_len + steps, device="meta")
    items = {
        "weights_bf16": 2 * n,
        "cache": batch * sum(t.numel() * t.element_size()
                             for k, t in cache.items() if k != "step"),
        "logits_bf16": batch * prompt_len * cfg.padded_vocab * 2,
        "init_largest_draw_f32": 4 * cfg.num_layers * cfg.d_model * cfg.d_ff,
    }
    items["total_weights_cache_logits"] = (items["weights_bf16"]
                                           + items["cache"]
                                           + items["logits_bf16"])
    return items


def family_serve(mods, run: str, cfg, params, n_params: int, batch,
                 prompt_len, steps, flash: int) -> dict:
    """``serve_lm`` at full width (warmed at B 1 × 512), gated: the
    prefill's flash launches all wgmma and ``flash`` of them, none in the
    decode, tokens and logits well formed; the recurrent loop's CUDA-event
    span in the timed prefill against its wall time."""
    from repro_torch.launch import serve
    from repro_torch.models import api as model_api
    module = model_api.module_for(cfg)
    serve.serve_lm(cfg, 1, 512, 1, device="cuda", params=params)   # warm
    with ScanTimer(module) as timer:
        r = serve_run(serve, module, mods, cfg, params, batch, prompt_len,
                      steps)
    toks, logits = r["tokens"], r["logits"]
    ok = (tuple(toks.shape) == (batch, 1 + steps)
          and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all())
          and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (batch, prompt_len, cfg.padded_vocab))
    line = dict(run=run, arch=cfg.name, layers=cfg.num_layers,
                attention_impl=cfg.attention_impl, batch=batch,
                prompt_len=prompt_len, decode_steps=steps,
                prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                decode_tokens_per_s=r["decode_tokens_per_s"],
                peak_memory_bytes=r["peak_memory_bytes"],
                reckoned_bytes=serve_reckoning(cfg, n_params, batch,
                                               prompt_len, steps),
                launches=r["launches"],
                flash_launches_prefill=r["prefill_launches"],
                flash_routes_prefill=r["prefill_routes"],
                flash_launches_decode=r["decode_launches"],
                tokens_row0=toks[0].tolist(), well_formed=ok)
    if cfg.family == "audio":
        line.update(encoder_frames=cfg.encoder_seq, note=(
            "512 decoder tokens pass Whisper's own 448-token text context; "
            "the JAX package enforces no limit, and 512 is the least "
            "length that reaches the flash kernel"))
    if timer.name:
        # the prefill runs the loop once a layer, before any decode step
        torch.cuda.synchronize()
        pre = sum(a.elapsed_time(b) for a, b in
                  timer.events[:cfg.num_layers])
        line.update(scan_loop=timer.name, scan_prefill_ms=pre,
                    scan_share_of_prefill=pre / 1e3 / r["prefill_s"])
    if not ok:
        emit("slice", **line)
        raise AssertionError(f"{run}: tokens or logits malformed")
    if r["prefill_routes"] != {"wgmma": flash, "simt": 0} or \
            r["decode_launches"] != 0:
        emit("slice", **line)
        raise AssertionError(
            f"{run}: flash_attention launched {r['prefill_routes']} times in "
            f"the prefill (want {flash}, all wgmma) and "
            f"{r['decode_launches']} in the decode (want 0)")
    line["logits"] = logits
    line["tokens"] = toks
    return line


def family_serves(mods, smi: str) -> tuple:
    """9 (a)-(c): each arch's weights drawn once, its serves run in turn;
    blockwise against full printed; rwkv6's prompt cut to 1,024 if its
    prefill passes RWKV_PREFILL_CUT_S; rwkv6 and hymba at the depth of
    FAMILY_SERVE_LAYERS. Returns each run's launches and each arch's real
    parameter count at full depth (the stacked layer leaves' count scaled
    from the depth served)."""
    from repro_torch.configs import registry
    launches, by_arch, counts = {}, {}, {}
    for run, (arch, impl, batch, plen, steps, flash) in \
            FAMILY_SERVES.items():
        by_arch.setdefault(arch, []).append(
            (run, impl, batch, plen, steps, flash))
    for arch, runs in by_arch.items():
        full = registry.get_config(arch)
        cfg = full.replace(num_layers=FAMILY_SERVE_LAYERS.get(
            arch, full.num_layers))
        params, wline = family_weights(cfg)
        served = counts[arch] = wline["params"]
        if cfg.num_layers != full.num_layers:
            # the layers' leaves are stacked on a leading axis of depth
            layer_params = sum(t.numel() for t in _leaves(params["layers"]))
            counts[arch] = (served - layer_params + layer_params
                            // cfg.num_layers * full.num_layers)
            wline.update(params_full_depth=counts[arch],
                         cuts=[f"depth: {full.num_layers} -> "
                               f"{cfg.num_layers} layers (the script's "
                               f"time)"])
        emit("slice", **wline, nvidia_smi=smi)
        lines = {}
        for run, impl, batch, plen, steps, flash in runs:
            c = cfg.replace(attention_impl=impl)
            line = family_serve(mods, run, c, params, served, batch,
                                plen, steps, flash)
            if arch == "rwkv6-7b" and line["prefill_s"] > RWKV_PREFILL_CUT_S:
                emit("slice", **{k: v for k, v in line.items()
                                 if k not in ("logits", "tokens")})
                line = family_serve(mods, run, c, params, served,
                                    batch, 1024, steps, flash)
                line["cuts"] = dict(prompt_len=[plen, 1024])
            lines[run] = line
            emit("slice", **{k: v for k, v in line.items()
                             if k not in ("logits", "tokens")},
                 nvidia_smi=smi)
            launches[run] = line["launches"]
        if len(lines) == 2:
            a, b = lines.values()
            emit("slice", run=f"{arch} serve blockwise vs full",
                 prefill_logit_gap_rel=float(
                     (a["logits"].float() - b["logits"].float()).abs().max()
                     / b["logits"].float().abs().max()),
                 argmax_agreement=float((a["logits"].argmax(-1)
                                         == b["logits"].argmax(-1)
                                         ).float().mean()),
                 tokens_equal=int((a["tokens"] == b["tokens"]).sum()),
                 tokens=a["tokens"].numel(),
                 prefill_s=[a["prefill_s"], b["prefill_s"]])
        del params, lines
        free_card()
    return launches, counts


FAMILY_FLASH_CASES = (   # the families' prefill layer, each as in phase 3
    ("hymba prefill", "gqa", (4, 2048, 25, 5, 64), "bfloat16", True, None,
     None),
    ("whisper decoder prefill", "gqa", (4, 512, 6, 6, 64), "bfloat16", True,
     None, None),
)


def family_flash(flash_attn, ref, smi: str) -> None:
    """9 (b): flash_attention at hymba's (and whisper's) prefill layer
    against its plain version, timed beside its bound and SDPA."""
    for case in FAMILY_FLASH_CASES:
        line, *_ = flash_case(flash_attn, ref, case)
        emit("kernels", **line, nvidia_smi=smi)
    free_card()


def family_train(mods, ref, smi: str, counts: dict) -> dict:
    """9 (d): hymba-1.5b (cut to 8 layers) and whisper-tiny trained at full
    width through the spmd step (bf16, remat, blockwise, the config's
    optimizer), the listed warm and timed steps; one count, one
    aggregation and the listed flash launches a step; the recurrent
    loop's share of a step; the count and the aggregation at hymba's full
    arena (its rows from ``counts``, the real parameter counts of (a))
    against their plain versions. rwkv6-7b is not trained at full width:
    the reason is printed."""
    from repro_torch.configs import registry
    from repro_torch.models import api as model_api
    launches = {}
    rwkv = registry.get_config("rwkv6-7b")
    n = counts["rwkv6-7b"]
    emit("slice", run="rwkv6-7b train", trained=False, params=n,
         reason=(f"a 2-client f32 arena of its {n} parameters alone is "
                 f"{2 * 4 * n / 1e9:.1f} GB of the card's 80 (the count "
                 f"takes its 2^31 slots and more)"),
         optimizer=rwkv.optimizer)
    for arch, (cell, flash, warm, steps, layers) in FAMILY_TRAIN.items():
        cfg = registry.get_config(arch).replace(attention_impl="blockwise")
        run = f"{arch} train blockwise"
        if layers:
            cfg = cfg.replace(num_layers=layers)
            run = f"{arch} {layers}-layer train blockwise"
        free_card()
        with ScanTimer(model_api.module_for(cfg)) as timer:
            box, step, batches, line = train_cell(mods, run, cfg,
                                                  steps=steps, cell=cell,
                                                  warm=warm)
        held_train_launches(run, line["launches"], steps, flash)
        line.update(flash_launches_per_step_expected=flash, warm_steps=warm)
        if layers:
            line.update(cuts=[f"depth: {registry.get_config(arch).num_layers}"
                              f" -> {layers} layers (the script's time)"])
        if timer.name:
            line.update(scan_loop=timer.name,
                        scan_forward_and_recompute_ms=timer.ms(),
                        scan_share_of_steps=timer.ms() / 1e3
                        / sum(line["step_s"]) if not warm else None,
                        scan_note="the loop's forward and remat's "
                                  "recompute, CUDA-event spans; its "
                                  "backward is not timed apart")
        emit("slice", **line, nvidia_smi=smi)
        launches[run] = line["launches"]
        rows = -(-counts[arch] // 1024) if arch in counts else None
        del box, step, batches
        free_card()
        if arch == "hymba-1.5b":
            phase_train_kernels(mods["sign_align"], mods["masked_agg"], ref,
                                rows, smi, arena=arch)
            free_card()
    return launches


def family_f32_cfg(arch: str, layers):
    from repro_torch.configs import registry
    cfg = registry.get_config(arch).replace(dtype="float32",
                                            attention_impl="blockwise")
    return cfg.replace(num_layers=layers) if layers else cfg


def family_f32_cpu(arch: str, layers, train_steps) -> dict:
    """The CPU half of 9 (e): one arch at full width (``layers`` deep where
    given), f32, blockwise, weights from seed 0. Serving: B 1 × 512
    tokens (whisper with its 1,500 frames), the CPU's greedy tokens, then
    its prefill and four teacher-forced decode steps (logits and caches).
    Training: C 2 × B 1 × 256 tokens, θ 0.65, the config's optimizer
    (adafactor for rwkv6, adamw without masters otherwise) recording its
    gradient, ``train_steps`` steps: each step's batch, the state before
    and after it, its metrics and its gradient."""
    from repro_torch.core import fl_step
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.models import api as model_api
    from repro_torch.optim import adamw as optim_mod
    from repro_torch.api import parity
    cfg = family_f32_cfg(arch, layers)
    params = model_api.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    rng = np.random.default_rng(0)
    prompt = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                     size=(1, 512)))}
    if cfg.family == "audio":
        prompt["enc_embeds"] = torch.as_tensor(rng.normal(
            size=(1, cfg.encoder_seq, cfg.d_model))).float()
    t0 = time.perf_counter()
    feed = serve.serve_lm(cfg, 1, 512, 4, device="cpu",
                          params=params)[:, :4]
    with torch.no_grad():
        logits, pre, last = teacher_forced(model_api, serve, cfg, params,
                                           prompt, feed, "cpu")
    serve_s = time.perf_counter() - t0
    opt, seen = parity.recording(optim_mod.for_config(cfg))
    step = fl_step.make_raw_step(cfg, opt, theta=0.65,
                                 agg_dtype=torch.float32)
    state = fl_step.init_state(None, cfg, opt, params=params, device="cpu")
    draw = train_mod.make_batch_fn(cfg, 2, 1, 256, seed=1, device="cpu")
    steps = []
    for _ in range(train_steps):
        batch = draw()
        t1 = time.perf_counter()
        after, metrics = step(state, batch)
        steps.append(dict(batch=batch, before=state, after=after,
                          metrics=metrics, grads=seen[-1],
                          cpu_step_s=time.perf_counter() - t1))
        seen.clear()
        state = after
    return dict(cfg=cfg, params=params, prompt=prompt, feed=feed,
                logits=logits, pre=pre, last=last, serve_s=serve_s,
                steps=steps)


def family_f32_card(mods, parity, cpu: dict) -> dict:
    """Its card half, TF32 off, card against CPU from the same weights (the
    SIMT flash kernel where a length reaches it). Serving: the prefill and
    four teacher-forced decode steps within 1e-4 of max|logit|, every
    cache leaf after the prefill and after the steps by
    ``parity.state_problems``, greedy tokens equal where the CPU's top-2
    margin is at least 1e-3. Training: each step replayed on the card from
    the CPU's state before it, its optimizer recording the gradient:
    records equal, loss within LOSS_RTOL, no θ ratio within THETA_BAND
    (the second step; the first accepts every client), the gradients by
    ``parity.grad_problems``, reference signs by ``ref_sign_problems`` and
    weights by the adamw rule or the adafactor replay. Returns the card
    runs' launches."""
    from repro_torch.core import fl_step
    from repro_torch.launch import serve
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    from repro_torch.optim import adamw as optim_mod
    from repro_torch.tree import named_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, prompt, feed = cpu["cfg"], cpu["prompt"], cpu["feed"]
    cpu_logits, cpu_pre, cpu_last = cpu["logits"], cpu["pre"], cpu["last"]
    arch = cfg.name
    problems = []
    card_params = transformer.tree_to(cpu["params"], "cuda")
    t1 = time.perf_counter()
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches(mods)
        card_logits, card_pre, card_last = teacher_forced(
            model_api, serve, cfg, card_params, prompt, feed, "cuda")
        torch.cuda.synchronize()
        serve_launches = read_launches(mods)
    t2 = time.perf_counter()
    gaps, tokens_held, tokens_near = [], 0, 0
    for i, (c, g) in enumerate(zip(card_logits, cpu_logits)):
        gap = float((c - g).abs().max() / g.abs().max())
        gaps.append(gap)
        if not gap <= 1e-4:
            problems.append(f"{'prefill' if i == 0 else f'decode {i}'}: "
                            f"logit gap {gap} of max|logit|")
        top2 = torch.topk(g[:, -1], 2, dim=-1).values
        held = (top2[:, 0] - top2[:, 1]) >= 1e-3
        tokens_held += int(held.sum())
        tokens_near += int((~held).sum())
        if bool((held & (c[:, -1].argmax(-1) != g[:, -1].argmax(-1))).any()):
            problems.append(f"step {i}: a greedy token differs where the "
                            f"top-2 margin is at least 1e-3")
    width = max(cfg.d_model, cfg.d_ff,
                cfg.encoder_seq if cfg.family == "audio" else 0)
    state_gaps = {}
    for tag, got, want, steps in (("prefill", card_pre, cpu_pre, 512),
                                  ("decode 4", card_last, cpu_last, 516)):
        names = [k for k in want if k != "step"]
        problems += parity.state_problems(
            {k: got[k] for k in names}, {k: want[k] for k in names}, width,
            steps, where=f"{tag} ")
        state_gaps[tag] = {k: [float((got[k] - want[k]).abs().max()),
                               parity.grad_bound(want[k], width, steps)]
                           for k in names}
    want_flash = {"rwkv6-7b": 0, "hymba-1.5b": cfg.num_layers,
                  "whisper-tiny": cfg.num_layers}[arch]
    if (serve_launches["flash_attention_simt"],
            serve_launches["flash_attention"]) != (want_flash, 0):
        problems.append(f"flash launched {serve_launches}, want "
                        f"{want_flash} on the SIMT kernel")
    serve_line = dict(logit_gap_rel=gaps, state_gap_and_bound=state_gaps,
                      tokens_held=tokens_held, tokens_near_tie=tokens_near,
                      cpu_serve_s=cpu["serve_s"], card_serve_s=t2 - t1,
                      launches=serve_launches)
    del card_params, card_pre, card_last

    # training: each CPU step replayed on the card
    seq, C = 256, 2
    tcard = time.perf_counter()
    card_opt, card_seen = parity.recording(optim_mod.for_config(cfg))
    card_step = fl_step.make_raw_step(cfg, card_opt, theta=0.65,
                                      agg_dtype=torch.float32)
    gwidth = max(width, cfg.padded_vocab, seq)

    def flat(tree, device="cuda"):
        return {"/".join(map(str, p)): (v.detach().to(device)
                                        if torch.is_tensor(v) else v)
                for p, v in named_leaves(tree)}

    steps_lines, train_launches = [], None
    for i, rec in enumerate(cpu["steps"]):
        batch, before, after, cm = (rec["batch"], rec["before"],
                                    rec["after"], rec["metrics"])
        card = tree_map(lambda t: t.to("cuda") if torch.is_tensor(t) else t,
                        before)
        tb = time.perf_counter()
        torch.cuda.synchronize()
        reset_launches(mods)
        card, km = card_step(card, {k: v.to("cuda") for k, v in
                                    batch.items()})
        torch.cuda.synchronize()
        train_launches = read_launches(mods)
        tc_ = time.perf_counter()
        where = f"{arch} train step {i}: "
        for k in ("mask", "selected", "delivered"):
            if not torch.equal(km[k].cpu(), cm[k]):
                problems.append(f"{where}{k} {km[k].tolist()} vs "
                                f"{cm[k].tolist()}")
        for k in ("accept_rate", "bytes_sent", "bytes_baseline"):
            if float(km[k]) != float(cm[k]):
                problems.append(f"{where}{k} {float(km[k])} vs "
                                f"{float(cm[k])}")
        if not abs(float(km["loss"]) - float(cm["loss"])) <= \
                parity.LOSS_RTOL * abs(float(cm["loss"])):
            problems.append(f"{where}loss {float(km['loss'])} vs "
                            f"{float(cm['loss'])}")
        if i > 0:
            problems += [where + p for p in parity.theta_band_violations(
                [(i, c, float(x)) for c, x in enumerate(km["ratios"])],
                0.65)]
        g, g_card = flat(rec["grads"]), flat(card_seen[-1])
        scales = (parity.null_bias_scales(g, [k for k in g
                                              if k.endswith("attn/bk")])
                  if cfg.family == "audio" else {})
        bounds = {k: parity.grad_bound(scales.get(k, v), gwidth, seq)
                  for k, v in g.items()}
        problems += parity.grad_problems(g_card, g, gwidth, seq, where,
                                         scales=scales)
        problems += parity.ref_sign_problems(flat(card.ref_sign),
                                             flat(after.ref_sign), g,
                                             bounds, where)
        if cfg.optimizer == "adafactor":
            replay, rstate = optim_mod.for_config(cfg).update(
                tree_map(lambda t: t.cpu(), card_seen[-1]),
                before.opt_state, before.params)
            stats = {}
            for k, v in flat(rstate["stats"]).items():
                leaf, stat = k.rsplit("/", 1)
                stats.setdefault(leaf, {})[stat] = v
            problems += parity.adafactor_replay_problems(
                flat(card.params), flat(replay), 1e-3, stats, where)
            del replay, rstate
        else:
            problems += parity.adamw_weight_problems(
                flat(card.params), flat(after.params), [g], [bounds],
                [1e-3], count0=i, where=where)
        gg = {k: [float((g_card[k].double() - g[k].double()).abs().max()),
                  bounds[k]] for k in sorted(g)}
        steps_lines.append(dict(
            step=i, loss_card_cpu=[float(km["loss"]), float(cm["loss"])],
            ratios=km["ratios"].tolist(), mask=km["mask"].tolist(),
            grad_gap_over_bound=max((a / b for a, b in gg.values() if b > 0),
                                    default=0.0),
            grad_gap_and_bound_top3=sorted(
                ([k, a, b] for k, (a, b) in gg.items() if b > 0),
                key=lambda x: -x[1] / x[2])[:3],
            cpu_step_s=rec["cpu_step_s"], card_step_s=tc_ - tb,
            check_s=time.perf_counter() - tc_))
        del card, g, g_card
        card_seen.clear()
    line = dict(run=f"{arch} f32 card vs cpu", layers=cfg.num_layers,
                encoder_layers=cfg.encoder_layers or None,
                optimizer=cfg.optimizer, serve=serve_line,
                train=dict(clients=C, batch=1, tokens=seq, steps=steps_lines,
                           launches=train_launches,
                           seconds=time.perf_counter() - tcard),
                allow_tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                                cudnn=torch.backends.cudnn.allow_tf32),
                problems=problems)
    emit("card_vs_cpu", **line)
    if train_launches["per_client_sign_align"] != 1 or \
            train_launches["masked_agg"] != 1:
        raise AssertionError(f"{arch} card step launches {train_launches}")
    if problems:
        raise AssertionError(f"{arch} card vs CPU: " + "; ".join(problems))
    return {f"{arch} f32 serve": serve_launches,
            f"{arch} f32 train": train_launches}


def family_halves(mods, parity) -> list:
    """Phase 9 (e) as (name, CPU half, card half) an arch."""
    return [(f"{arch} f32 card vs cpu",
             functools.partial(family_f32_cpu, arch, layers, steps),
             functools.partial(family_f32_card, mods, parity))
            for arch, (layers, steps) in FAMILY_CARD_CPU.items()]


def family_clis() -> None:
    """9 (f): ``python -m repro_torch.launch.serve --arch rwkv6-7b
    --smoke`` and ``python -m repro_torch.launch.train --arch
    whisper-tiny`` (full width) on the card, exit 0."""
    cli_check("slice", "rwkv6-7b serve cli", [
        "repro_torch.launch.serve", "--arch", "rwkv6-7b", "--smoke",
        "--prompt-len", "32", "--decode-steps", "4"],
        lambda lines: re.match(r"prefill: 4x32 in .*decode: 4 steps",
                               lines[-1]))
    train_cli(["--arch", "whisper-tiny", "--clients", "2",
               "--per-client-batch", "1", "--seq", "64", "--steps", "2",
               "--log-every", "1"], "whisper-tiny train cli")


def phase_families(mods, parity, ref, smi: str) -> dict:
    """Phase 9 (module docstring, 9 (a) to (f)). Returns the launches of
    each run."""
    t_phase = time.perf_counter()
    parts = {}

    def mark(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches, counts = family_serves(mods, smi)
    mark("a_c_serve")
    family_flash(mods["flash_attn"], ref, smi)
    mark("b_flash")
    launches.update(family_train(mods, ref, smi, counts))
    mark("d_train")
    if CPU_HALVES is None:
        run_halves(family_halves(mods, parity), launches)
    mark("e_card_vs_cpu")
    family_clis()
    mark("f_cli")
    emit("families_phase", seconds=time.perf_counter() - t_phase,
         seconds_by_part=parts, nvidia_smi=smi)
    return launches


# ---------------------------------------------------------------------------
# 10. language models on the sim engines (the loop, the megastep, the
# scanned control plane) under ``ours``
# ---------------------------------------------------------------------------

# the cell: N clients, K = N·fraction selected, batches of B × S tokens,
# ``steps`` local momentum-SGD steps a client, ``eval`` sequences evaluated
# a round, ``warm`` warm-up rounds and ``timed`` timed ones
SIM_LM = dict(arch="qwen2-1.5b", clients=4, select_fraction=0.5, batch=1,
              seq=512, steps=2, eval=4, theta=0.65, warm=1, timed=3)
SIM_LM_CUT = 2            # layers of the 2-layer runs of (b) and (c)
# (c): arch -> sim path, card against CPU in f32 at B 1 × 128 tokens (no
# flash: 128 is no multiple of 512), 1 local step a client (the CPU's
# steps over up to 0.97 G f32 weights set the phase's time), 2 rounds, 2
# sequences evaluated
SIM_LM_CARD_CPU = {"qwen2-1.5b": "megastep",
                   "granite-moe-1b-a400m": "megastep", "rwkv6-7b": "loop"}
SIM_LM_CPU_SEQ = 128
SIM_LM_CPU_STEPS = 1
SIM_LM_MOMENTUM = 0.9     # the engine's optim.sgd default


def sim_lm_spec(T, cfg, *, rounds: int, path: str = "megastep",
                quantize: bool = False, seq: int = SIM_LM["seq"],
                eval_samples: int = SIM_LM["eval"],
                steps: int = SIM_LM["steps"]):
    """The phase's ``ours`` spec (async quorum and staleness weights, θ
    0.65, no dynamic batch) over iid token data, 4 sequences a client,
    ``steps`` local steps a client."""
    c = SIM_LM
    kw = {"loop": dict(megastep=False), "megastep": {},
          "scanned": dict(rounds_per_dispatch=2, fused_eval=True)}[path]
    return T.ExperimentSpec(
        model=cfg,
        data=T.DataSpec(dataset="lm", partition="iid", seq_len=seq,
                        n_samples=4 * c["clients"],
                        eval_samples=eval_samples),
        world=T.WorldSpec(num_clients=c["clients"]),
        strategy="ours",
        strategy_kwargs=dict(batch_size=c["batch"],
                             select_fraction=c["select_fraction"],
                             theta=c["theta"], dynamic_batch=False,
                             max_samples_per_round=c["batch"] * steps,
                             quantize_updates=quantize),
        rounds=rounds, seed=0, **kw)


def sim_lm_reckoning(sim, C: int) -> dict:
    """The megastep's device memory while a client trains, item by item
    (bytes), from the arena's shape and the weights' bytes."""
    slots = sim._arena.rows * sim._arena.lane
    w = sim.param_bytes                 # the weights in their dtypes
    n = sim._arena.n
    items = {
        "arena_f32": 4 * slots,
        "unpacked_globals": w,
        "client_weights_and_their_update": 2 * w,
        "momentum_f32_and_its_update": 2 * 4 * n,
        "gradient_f32": 4 * n,
        "deltas_arena_f32": 4 * C * slots,
        "reference_signs_int8": slots,
    }
    items["total"] = sum(items.values())
    return items


def sim_lm_expected(cfg, launches: list, records) -> list:
    """The launches each round must show, derived from the code: the flash
    kernel 2·L a client step (each layer's forward and remat's recompute;
    the backward is plain torch) and L for the round's eval; one
    ``per_client_sign_align`` a shape group once a reference exists (it
    exists from the first round that applied an update); one
    ``masked_agg`` a shape group in a round that applied one. Returns the
    problems."""
    c = SIM_LM
    L = cfg.num_layers
    K = max(1, int(c["select_fraction"] * c["clients"]))
    out, has_ref = [], False
    for r, (got, rec) in enumerate(zip(launches, records)):
        want = {"flash_attention": K * c["steps"] * 2 * L + L,
                "per_client_sign_align": int(has_ref),
                "masked_agg": int(rec.updates_applied > 0)}
        for k, v in want.items():
            if got[k] != v:
                out.append(f"round {r}: {k} launched {got[k]} times, "
                           f"not {v}")
        has_ref = has_ref or rec.updates_applied > 0
    return out


def sim_lm_full_width(T, mods, smi: str) -> dict:
    """10 (a): qwen2-1.5b at full width and depth (bf16, blockwise, remat)
    trained through the async megastep: weights drawn on the card from
    seed 0, 1 warm-up and 3 timed rounds, each round's launches counted
    from 0 and held (``sim_lm_expected``), wall s a round, training
    tokens/s, peak memory beside the reckoning. Returns the launches of
    the timed rounds, summed."""
    from repro_torch.configs import registry
    from repro_torch.models import api as model_api
    c = SIM_LM
    cfg = registry.get_config(c["arch"]).replace(attention_impl="blockwise")
    rounds = c["warm"] + c["timed"]
    spec = sim_lm_spec(T, cfg, rounds=rounds)
    free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_api.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    sim = T.build_simulation(spec, device="cuda", params=params)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    walls, per_round = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        reset_launches(mods)
        t = time.perf_counter()
        sim.run(1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        per_round.append(read_launches(mods))
    peak = torch.cuda.max_memory_allocated()
    records = [T.record_from_metrics(m) for m in sim.history]
    problems = sim_lm_expected(cfg, per_round, records)
    if not all(math.isfinite(r.loss) and math.isfinite(r.accuracy)
               for r in records):
        problems.append("loss or accuracy not finite")
    K = max(1, int(c["select_fraction"] * c["clients"]))
    timed = walls[c["warm"]:]
    tokens = K * c["steps"] * c["batch"] * c["seq"]
    line = dict(
        run=f"{cfg.name} sim megastep", arch=cfg.name,
        layers=cfg.num_layers, dtype=cfg.dtype,
        attention_impl=cfg.attention_impl, remat=cfg.remat,
        strategy="ours", mode="async", theta=c["theta"],
        clients=c["clients"], cohort=K, batch=c["batch"], seq=c["seq"],
        local_steps=c["steps"], eval_sequences=c["eval"],
        params=sim._arena.n, arena_rows=sim._arena.rows,
        param_bytes=sim.param_bytes, init_s=init_s, wall_s=walls,
        warm_rounds=c["warm"],
        wall_s_per_round=sum(timed) / len(timed),
        training_tokens_per_round=tokens,
        tokens_per_s=tokens * len(timed) / sum(timed),
        peak_memory_bytes=peak,
        reckoned_bytes=sim_lm_reckoning(sim, C=K),
        launches_per_round=per_round,
        records=[dataclasses.asdict(r) for r in records],
        theta_ratios=sim.theta_ratios, problems=problems, nvidia_smi=smi)
    emit("slice", **line)
    if problems:
        raise AssertionError(f"{line['run']}: {problems}")
    del sim
    free_card()
    return {k: sum(p[k] for p in per_round[c["warm"]:])
            for k in per_round[0]}


# (b): run -> (path, int8, kernels that must launch); 2 rounds each
SIM_LM_CUT_RUNS = {
    "loop": ("loop", False, ("flash_attention",)),
    "megastep": ("megastep", False, ("flash_attention", "masked_agg")),
    "int8 megastep": ("megastep", True, ("flash_attention", "masked_agg",
                                         "ef_round_trip")),
    "int8 scanned fused R=2": ("scanned", True, (
        "flash_attention", "per_client_sign_align", "masked_agg",
        "ef_round_trip", "cohort_gather")),
}


def sim_lm_cut(T, mods, ref, smi: str) -> dict:
    """10 (b): qwen2-1.5b at full width cut to 2 layers (bf16, blockwise,
    remat) on the loop, the megastep, the int8 megastep and the int8
    scanned path at 2 rounds a dispatch with fused eval: wall s a round,
    launches (each run's kernels at least once, the codec's calls held
    by ``held_launches``), the int8 runs' wire bytes against the
    uncompressed ones; then the kernels at this path's shapes against
    their plain versions (``sim_lm_kernels``). Returns each run's
    launches."""
    from repro_torch.configs import registry
    from repro_torch.models import api as model_api
    cfg = registry.get_config(SIM_LM["arch"]).replace(
        attention_impl="blockwise", num_layers=SIM_LM_CUT)
    params = model_api.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    launches, payload, finals = {}, {}, {}
    for name, (path, int8, needed) in SIM_LM_CUT_RUNS.items():
        run = f"{cfg.name} {SIM_LM_CUT}-layer sim {name}"
        spec = sim_lm_spec(T, cfg, rounds=2, path=path, quantize=int8)
        sim, wall, launches[run], rows = run_card(T, spec, params, mods)
        held_launches(run, launches[run], needed, rows)
        records = [T.record_from_metrics(m) for m in sim.history]
        if not all(math.isfinite(r.loss) and math.isfinite(r.accuracy)
                   for r in records):
            raise AssertionError(f"{run}: loss or accuracy not finite")
        payload[name] = sim._payload_bytes()
        finals[name] = records[-1]
        emit("slice", run=run, layers=SIM_LM_CUT, path=path, int8=int8,
             cuts=["depth: 28 -> 2 layers (the int8 error feedback, "
                   "(N + 1) f32 arenas, does not fit one card beside the "
                   "28-layer megastep)"],
             rounds=len(records), wall_s=wall,
             wall_s_per_round=wall / len(records),
             dispatches=sim.dispatches, launches=launches[run],
             rows_per_call=rows_line(rows), payload_bytes=payload[name],
             records=[dataclasses.asdict(r) for r in records],
             nvidia_smi=smi)
        slots = sim._arena.rows
        del sim
        free_card()
    emit("slice", run=f"{cfg.name} {SIM_LM_CUT}-layer sim int8 wire",
         payload_bytes={k: payload[k] for k in ("megastep", "int8 megastep")},
         payload_ratio=payload["megastep"] / payload["int8 megastep"],
         bytes_sent={k: finals[k].bytes_sent
                     for k in ("megastep", "int8 megastep")},
         note="the uncompressed payload counts the weights' bf16 bytes, as "
              "the JAX package does: int8 with a scale a row halves it")
    del params
    free_card()
    sim_lm_kernels(mods, ref, slots, smi)
    return launches


def sim_lm_kernels(mods, ref, rows: int, smi: str) -> None:
    """10 (b): the kernels at this path's shapes against their plain
    versions, timed beside their bounds: ``ef_round_trip`` on the cohort's
    C 2 × ``rows`` folded rows and ``cohort_gather`` of K 2 slabs from the
    (N + 1, rows, 1024) error-feedback arena (both by bits), and the
    flash kernel at a client step's layer, (1, 512, 12, 2, 128) bf16
    causal. ``per_client_sign_align`` and ``masked_agg`` at the 28-layer
    arena's C 2 × 1,735,822 rows are phase 8 (b)'s lines."""
    quantize, gather = mods["quantize"], mods["gather"]
    g = torch.Generator(device="cuda").manual_seed(10)
    K, N = 2, SIM_LM["clients"]
    M = K * rows
    d = torch.randn((M, 1024), generator=g, device="cuda")
    e = torch.randn((M, 1024), generator=g, device="cuda") * 1e-3
    got, want = quantize.ef_round_trip(d, e), ref.ef_round_trip(d, e)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("restored", "residual")):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"ef_round_trip {what} differs from its "
                                 f"plain version at {M} rows")
    del got, want
    n = M * 1024
    bound = bound_ms(16 * n, 8 * n)
    emit("kernels", name="ef_round_trip", rows=M, shape="sim cohort C 2",
         ef_round_trip="equal by bits",
         ms=time_ms(lambda: quantize.ef_round_trip(d, e), iters=10,
                    warmup=2),
         plain_ms=time_ms(lambda: ref.ef_round_trip(d, e), iters=3,
                          warmup=1),
         bound_ms=bound[0], bound_by=bound[1], library_ms=None,
         nvidia_smi=smi)
    del d, e
    free_card()
    src = torch.randn((N + 1, rows, 1024), generator=g, device="cuda")
    idx = torch.tensor([2, 0], dtype=torch.int64, device="cuda")
    got, want = gather.cohort_gather(src, idx), ref.cohort_gather(src, idx)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("cohort_gather differs from its plain version "
                             f"at ({N + 1}, {rows}, 1024)")
    del got, want
    bound = bound_ms(2 * K * rows * 4096 + 8 * K, 0)
    emit("kernels", name="cohort_gather", slabs=[N + 1, rows], k=K,
         cohort_gather="equal by bits",
         ms=time_ms(lambda: gather.cohort_gather(src, idx), iters=10,
                    warmup=2),
         plain_ms=time_ms(lambda: ref.cohort_gather(src, idx), iters=10,
                          warmup=2),
         bound_ms=bound[0], bound_by=bound[1],
         library_ms=time_ms(lambda: torch.index_select(src, 0, idx),
                            iters=10, warmup=2), nvidia_smi=smi)
    del src
    free_card()
    line, *_ = flash_case(mods["flash_attn"], ref, (
        "qwen2 sim client step", "gqa", (1, 512, 12, 2, 128), "bfloat16",
        True, None, None))
    emit("kernels", **line, nvidia_smi=smi)


@contextlib.contextmanager
def recording_sgd(parity):
    """Within the block, each simulation built gets ``optim.sgd`` wrapped
    by ``parity.recording``: the yielded list gets one list a simulation,
    the gradients its optimizer receives, in call order."""
    from repro_torch.optim import adamw as optim_mod
    plain = optim_mod.sgd
    seen = []

    def sgd(lr=1e-2, momentum=SIM_LM_MOMENTUM):
        opt, grads = parity.recording(plain(lr=lr, momentum=momentum))
        seen.append(grads)
        return opt

    optim_mod.sgd = sgd
    try:
        yield seen
    finally:
        optim_mod.sgd = plain


def _card_named(tree) -> dict:
    """name -> a card copy of each leaf (the parity rules then run in f64
    on the card: a 2-layer leaf set is up to 0.97 G elements)."""
    from repro_torch.tree import named_leaves
    return {"/".join(map(str, p)): v.detach().to("cuda")
            for p, v in named_leaves(tree)}


def _host_named(tree) -> dict:
    """name -> a host copy of each leaf (a later round may write the
    simulation's own tensors in place)."""
    from repro_torch.tree import named_leaves
    return {"/".join(map(str, p)): v.detach().clone()
            for p, v in named_leaves(tree)}


def sim_globals(sim, named=_card_named) -> tuple:
    """(globals, reference signs) of a simulation as name -> tensor (card
    copies, or ``named``'s): the megastep's arena and its signs unpacked,
    the loop's dicts."""
    if sim.megastep:
        arena = sim._arena
        dev = "cuda" if named is _card_named else sim._params_mat.device
        return (named(arena.unpack(sim._params_mat.to(dev), torch.float32)),
                named(arena.unpack(sim._ref_mat.to(dev), torch.int8)))
    return named(sim.params), named(sim.ref_sign)


def sim_f32_cfg(arch: str):
    from repro_torch.configs import registry
    return registry.get_config(arch).replace(
        dtype="float32", num_layers=SIM_LM_CUT, attention_impl="blockwise")


def sim_f32_weights(arch: str) -> dict:
    """10 (c)'s weights, drawn on the card from seed 0 and copied to the
    host (the CPU half's; its card half draws them again, the same bits)."""
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    card = model_api.init_params(
        torch.Generator(device="cuda").manual_seed(0), sim_f32_cfg(arch),
        "cuda")
    host = transformer.tree_to(card, "cpu")
    del card
    free_card()
    return host


def sim_f32_cpu(arch: str, path: str, params) -> dict:
    """The CPU half of 10 (c): ``arch`` at full width cut to 2 layers,
    f32, on the sim ``path`` from ``params`` (``sim_f32_weights``) at B 1
    × 128 tokens and one local step a client, its SGD recording its
    gradients, 2 rounds: round 0's gradients, globals and reference signs
    (host copies), then the records and θ ratios."""
    import repro_torch as T
    from repro_torch.api import parity
    cfg = sim_f32_cfg(arch)
    spec = sim_lm_spec(T, cfg, rounds=2, path=path, seq=SIM_LM_CPU_SEQ,
                       eval_samples=2, steps=SIM_LM_CPU_STEPS)
    with recording_sgd(parity) as seen:
        cpu = T.build_simulation(spec, device="cpu", params=params)
    grads = seen[0]
    t0 = time.perf_counter()
    cpu.run(1)
    t_cpu = time.perf_counter() - t0
    round0 = list(grads)
    grads.clear()
    globals0, ref0 = sim_globals(cpu, named=_host_named)
    t1 = time.perf_counter()
    cpu.run(1)
    t_cpu += time.perf_counter() - t1
    grads.clear()
    return dict(arch=arch, path=path, cfg=cfg, spec=spec, params=params,
                grads=round0, globals=globals0, ref=ref0,
                lr=cpu.strategy.lr, alpha0=cpu.schedule.alpha0,
                records=[T.record_from_metrics(m) for m in cpu.history],
                theta_ratios=cpu.theta_ratios, cpu_rounds_s=t_cpu)


def sim_f32_card(T, parity, mods, cpu: dict) -> dict:
    """Its card half: the same spec on the card from the same weights (drawn
    on the card from seed 0), TF32 off, its SGD recording. After round 0:
    each client's first gradient (both from the shared start) by
    ``parity.grad_problems``; the globals by ``sim_weight_problems`` and
    the reference signs by ``ref_sign_problems``, both against
    ``sim_round_bounds`` of the CPU's gradients. After round 1: the
    records by ``record_mismatches``, and no θ ratio of either run within
    ``THETA_BAND``. Returns the card's launches in round 0."""
    from repro_torch.models import api as model_api
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = SIM_LM
    arch, path, cfg, spec = cpu["arch"], cpu["path"], cpu["cfg"], cpu["spec"]
    seq, S = SIM_LM_CPU_SEQ, SIM_LM_CPU_STEPS
    card_params = model_api.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    with recording_sgd(parity) as seen:
        card = T.build_simulation(spec, device="cuda", params=card_params)
    del card_params
    card_grads, cpu_grads = seen[0], cpu["grads"]
    torch.cuda.synchronize()
    reset_launches(mods)
    card.run(1)
    torch.cuda.synchronize()
    launches = read_launches(mods)
    t_check = time.perf_counter()
    width, rows = parity.lm_grad_width(cfg, seq), c["batch"] * seq
    problems = []
    if len(card_grads) != len(cpu_grads) or not cpu_grads:
        problems.append(f"{len(card_grads)} gradients on the card, "
                        f"{len(cpu_grads)} on the CPU")
    grad_gap = {}
    for i in range(0, len(cpu_grads), S):
        want = _card_named(cpu_grads[i])
        got = _card_named(card_grads[i])
        problems += parity.grad_problems(got, want, width, rows,
                                         where=f"client slot {i // S} "
                                               f"step 0: ")
        for k in want:
            gap = float((got[k] - want[k]).abs().max())
            b = parity.grad_bound(want[k], width, rows)
            grad_gap[k] = max(grad_gap.get(k, 0.0), gap / b if b else 0.0)
        del want, got
    per_client = [parity.sgd_delta_bounds(
        [_card_named(g) for g in cpu_grads[i:i + S]], cpu["lr"],
        SIM_LM_MOMENTUM, width, rows) for i in range(0, len(cpu_grads), S)]
    card_grads.clear()
    start = _card_named(cpu["params"])
    want = {k: v.to("cuda") for k, v in cpu["globals"].items()}
    want_ref = {k: v.to("cuda") for k, v in cpu["ref"].items()}
    got, got_ref = sim_globals(card)
    bounds = parity.sim_round_bounds(want, start, per_client, S,
                                     cpu["alpha0"])
    problems += parity.sim_weight_problems(got, want, bounds,
                                           where="round 0 globals: ")
    moved = {k: want[k] - start[k] for k in want}
    problems += parity.ref_sign_problems(got_ref, want_ref, moved, bounds,
                                         where="round 0 signs: ")
    weight_gap = {k: float((got[k] - want[k]).abs().max()) / bounds[k]
                  for k in want if bounds[k]}
    del got, want, moved, start, got_ref, want_ref
    free_card()
    t_check = time.perf_counter() - t_check
    card.run(1)
    torch.cuda.synchronize()
    card_grads.clear()
    got_r = [T.record_from_metrics(m) for m in card.history]
    want_r = cpu["records"]
    problems += parity.record_mismatches(got_r, want_r)
    for who, ratios in (("card", card.theta_ratios),
                        ("cpu", cpu["theta_ratios"])):
        problems += [f"{who}: {p}" for p in parity.theta_band_violations(
            ratios, c["theta"])]
    run = f"{arch} {SIM_LM_CUT}-layer f32 sim {path}"
    line = dict(
        run=run, layers=SIM_LM_CUT,
        seq=seq, path=path, rounds=2, problems=problems,
        records_card=[dataclasses.asdict(r) for r in got_r],
        records_cpu=[dataclasses.asdict(r) for r in want_r],
        theta_ratios_card=card.theta_ratios,
        theta_ratios_cpu=cpu["theta_ratios"],
        step0_grad_gap_over_bound_max=max(grad_gap.values(), default=None),
        round0_weight_gap_over_bound=weight_gap,
        local_steps=S, launches_round0=launches,
        cpu_rounds_s=cpu["cpu_rounds_s"], check_s=t_check)
    emit("card_vs_cpu", **line)
    del card
    free_card()
    if problems:
        raise AssertionError(f"card and CPU disagree: {run}: "
                             + "; ".join(problems))
    return {run: launches}


def sim_halves(T, parity, mods) -> list:
    """Phase 10 (c) as (name, CPU half, card half) an arch; the weights are
    drawn on the card here, once, and copied to the host."""
    return [(f"{arch} {SIM_LM_CUT}-layer f32 sim {path}",
             functools.partial(sim_f32_cpu, arch, path,
                               sim_f32_weights(arch)),
             functools.partial(sim_f32_card, T, parity, mods))
            for arch, path in SIM_LM_CARD_CPU.items()]


def phase_sim_lm(T, parity, mods, ref, smi: str) -> dict:
    """Phase 10 (module docstring, 10 (a) to (d)). Returns the launches of
    each run."""
    t_phase = time.perf_counter()
    parts = {}

    def mark(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    launches = {f"{SIM_LM['arch']} sim megastep": sim_lm_full_width(
        T, mods, smi)}
    mark("a_full_width")
    launches.update(sim_lm_cut(T, mods, ref, smi))
    mark("b_cut")
    if CPU_HALVES is None:
        run_halves(sim_halves(T, parity, mods), launches)
    mark("c_card_vs_cpu")
    emit("sim_lm_phase", seconds=time.perf_counter() - t_phase,
         seconds_by_part=parts, nvidia_smi=smi)
    return launches


# ---------------------------------------------------------------------------
# 11. the dry run (launch/dryrun.py, roofline/) held against the card
# ---------------------------------------------------------------------------

# the matrix products torch.profiler's with_flops counts, as the census does
PROFILED_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
DRYRUN_PREFILL = dict(batch=4, prompt_len=2048)      # phase 7's serve
DRYRUN_PEAKS = ("internvl2-2b", "phi3-mini-3.8b")    # reckoned, not run


def census_of(step, *args):
    """The census of ``step(*args)`` on meta copies of the arguments
    (weights, state and batch leaves become meta tensors of their shapes
    and dtypes)."""
    from repro_torch.roofline.census import Census
    from repro_torch.tree import tree_map
    meta = tree_map(lambda t: torch.empty_like(t, device="meta")
                    if torch.is_tensor(t) else t, args)
    census = Census()
    census.hold(*meta)
    with census:
        step(*meta)
    return census.analyze()


def profiled(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` with FLOPs: the
    profiler's FLOPs by matrix-product name, the aten operators it
    recorded (nested ones included) and the CUDA runtime's launch and copy
    calls, by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return dict(
        flops_by_op={e.key: float(e.flops) for e in events
                     if e.key in PROFILED_MATMULS and e.flops},
        aten_ops=sum(e.count for e in events if e.key.startswith("aten::")),
        runtime={e.key: e.count for e in events
                 if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                      "cudaMemcpy"))})


def held_census(run: str, census: dict, card: dict, launches: dict,
                want_launches: dict) -> list:
    """Problems of a census against the card: matrix-product FLOPs equal
    by name and in total (and none under a name the profiler does not
    count), the hand-written kernels' launches equal to the card's and to
    what the path makes."""
    problems = []
    ours = {k: v for k, v in census["flops_by_op"].items()
            if k.startswith("aten::")}
    if ours != card["flops_by_op"]:
        problems.append(f"{run}: matrix-product FLOPs {ours} on meta, "
                        f"{card['flops_by_op']} on the card")
    if sum(ours.values()) != sum(card["flops_by_op"].values()):
        problems.append(f"{run}: total FLOPs differ")
    counted = {k: int(v) for k, v in census["kernel_launches"].items()}
    card_launches = {k: v for k, v in launches.items() if v}
    if counted != card_launches or counted != want_launches:
        problems.append(f"{run}: kernel launches {counted} on meta, "
                        f"{card_launches} on the card, {want_launches} "
                        f"made by the path")
    return problems


def dryrun_line(run: str, cfg, shape, census: dict, card: dict,
                launches: dict, wall_s: list, peak: int, smi: str) -> dict:
    from repro_torch.roofline import analysis
    roof = analysis.analyze(cfg.name, shape, "1x1", 1, census, cfg)
    return dict(
        run=run, census_flops_by_op=census["flops_by_op"],
        card_flops_by_op=card["flops_by_op"],
        census_kernel_launches=census["kernel_launches"],
        card_kernel_launches={k: v for k, v in launches.items() if v},
        census_peak_bytes=census["peak_bytes"],
        max_memory_allocated=peak,
        roofline=dict(t_compute_s=roof.t_compute, t_memory_s=roof.t_memory,
                      t_collective_s=roof.t_collective,
                      dominant=roof.dominant,
                      useful_ratio=roof.useful_ratio),
        measured_s=wall_s,
        census_ops_dispatched=census["total_instructions"],
        card_aten_ops_recorded=card["aten_ops"],
        card_runtime_calls=card["runtime"],
        nvidia_smi=smi)


def dryrun_prefill(mods, smi: str) -> list:
    """11 (a): qwen2-1.5b's blockwise prefill at B 4 × 2,048 on the card
    (weights from seed 0) against its census on meta."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import fl_step
    from repro_torch.models import api as model_api
    cfg = registry.get_config("qwen2-1.5b").replace(
        attention_impl="blockwise")
    B, S = DRYRUN_PREFILL["batch"], DRYRUN_PREFILL["prompt_len"]
    params = model_api.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    step = fl_step.build_prefill_step(cfg)
    census = census_of(step, params, {"tokens": tokens})
    with torch.no_grad():
        step(params, {"tokens": tokens})                       # warm
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, {"tokens": tokens})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        card = profiled(lambda: step(params, {"tokens": tokens}))
        launches = read_launches(mods)
    peak = torch.cuda.max_memory_allocated()
    run = f"qwen2-1.5b prefill blockwise {B}x{S}"
    emit("dryrun", **dryrun_line(run, cfg, InputShape(run, S, B, "prefill"),
                                 census, card, launches, walls, peak, smi))
    del params, tokens
    free_card()
    return held_census(run, census, card, launches,
                       {"flash_attention": cfg.num_layers})


def dryrun_train(mods, smi: str) -> list:
    """11 (b): qwen2-1.5b's training step at C 2 × 1 × 4,096 (blockwise,
    remat, adamw, θ 0.65; weights from seed 0) on the card against its
    census on meta: the census of one step, the card's second step
    profiled and its third timed."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import fl_step
    from repro_torch.launch import train as train_mod
    cfg = registry.get_config("qwen2-1.5b").replace(
        attention_impl="blockwise")
    C, B, S = (TRAIN_CELL[k] for k in ("clients", "per_client", "seq"))
    draw = train_mod.make_batch_fn(cfg, C, B, S, seed=0, device="cuda")
    batches = [draw() for _ in range(3)]
    census = census_of(fl_step.build_fl_train_step(
        cfg, theta=TRAIN_CELL["theta"]), fl_step.init_state(
            None, cfg, device="meta"), batches[0])
    step = fl_step.build_fl_train_step(cfg, theta=TRAIN_CELL["theta"])
    box = [fl_step.init_state(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")]
    stepped(step, box, batches[0])                              # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    card = profiled(lambda: stepped(step, box, batches[1]))
    launches = read_launches(mods)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepped(step, box, batches[2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = f"qwen2-1.5b train blockwise C {C} x {B} x {S}"
    emit("dryrun", **dryrun_line(run, cfg, InputShape(run, S, C * B, "train"),
                                 census, card, launches, [wall], peak, smi))
    del box, batches
    free_card()
    return held_census(run, census, card, launches, {
        "flash_attention": 2 * cfg.num_layers * C,
        "per_client_sign_align": 1, "masked_agg": 1})


def dryrun_peaks(smi: str) -> None:
    """11 (c): the census's peak of one training step at the card's cell
    (C 2 × 1 × 4,096, blockwise, remat, the config's optimizer) for the
    configs not trained at full depth on the card, with their arena
    rows; reckoned on meta, not run."""
    from repro_torch.configs import registry
    from repro_torch.core import fl_step
    from repro_torch.kernels import arena as arena_mod
    C, B, S = (TRAIN_CELL[k] for k in ("clients", "per_client", "seq"))
    for arch in DRYRUN_PEAKS:
        cfg = registry.get_config(arch).replace(attention_impl="blockwise")
        state = fl_step.init_state(None, cfg, device="meta")
        step = fl_step.build_fl_train_step(cfg, theta=TRAIN_CELL["theta"])
        toks = S - (cfg.num_patches if cfg.family == "vlm" else 0)
        batch = {"tokens": torch.empty((C, B, toks), dtype=torch.int64,
                                       device="meta")}
        batch["labels"] = torch.empty_like(batch["tokens"])
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.empty(
                (C, B, cfg.num_patches, cfg.d_model),
                dtype=cfg.compute_dtype, device="meta")
        census = census_of(step, state, batch)
        emit("dryrun", run=f"{arch} train blockwise C {C} x {B} x {S}",
             reckoned_only=True, layers=cfg.num_layers,
             arena_rows=arena_mod.ParamArena(state.params).rows,
             census_peak_bytes=census["peak_bytes"],
             census_flops=census["flops"],
             census_kernel_launches=census["kernel_launches"],
             card_bytes=torch.cuda.get_device_properties(0).total_memory,
             nvidia_smi=smi)


def phase_dryrun(mods, smi: str) -> dict:
    """Phase 11: the dry run's census held against the card (module
    docstring, 11 (a) to (d))."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    problems = dryrun_prefill(mods, smi) + dryrun_train(mods, smi)
    dryrun_peaks(smi)
    cli_check("dryrun", "cli --arch qwen2-1.5b", [
        "repro_torch.launch.dryrun", "--arch", "qwen2-1.5b", "--results",
        "{ckpt}/dry.jsonl"],
        lambda lines: lines[-1] == "[dryrun] all combos traced on meta "
        "successfully" and sum(line.startswith("[dryrun] qwen2-1.5b × ")
                                for line in lines) == 4, keep=6)
    emit("dryrun_phase", seconds=time.perf_counter() - t_phase,
         problems=problems, nvidia_smi=smi)
    if problems:
        raise AssertionError("dry run vs card: " + "; ".join(problems))
    return {}


# ---------------------------------------------------------------------------
# 12. the port on a mesh: one-rank NCCL, the sharded step and population,
# the production meshes' dry run
# ---------------------------------------------------------------------------

MESH_STEP_LAYERS = 4          # qwen2-1.5b's 28 cut in depth, full width
MESH_STEP_STEPS = 3


def start_nccl_world(tmp: str) -> None:
    """A one-rank NCCL process group meeting through a file (no network;
    NCCL's own bootstrap kept on the loopback interface)."""
    from repro_torch.launch import mesh as mesh_mod
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh_mod.start_world("nccl", 0, 1, os.path.join(tmp, "rendezvous"))


def mesh_step(mods, smi: str) -> dict:
    """12 (a): the step on DTensors against the unsharded step, by bits."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core import fl_step
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    cfg = registry.get_config("qwen2-1.5b").replace(
        attention_impl="blockwise", num_layers=MESH_STEP_LAYERS)
    C, B, S = (TRAIN_CELL[k] for k in ("clients", "per_client", "seq"))
    opt = adamw.for_config(cfg)
    mesh = mesh_mod.make_debug_mesh()
    state = fl_step.init_state(torch.Generator(device="cuda").manual_seed(0),
                               cfg, opt, device="cuda")
    dstate = sharding.distribute(tree.tree_map(torch.clone, state), mesh,
                                 sharding.state_pspecs(cfg, mesh, opt))
    plain = fl_step.make_raw_step(cfg, opt, theta=TRAIN_CELL["theta"])
    on_mesh = fl_step.make_raw_step(cfg, opt, theta=TRAIN_CELL["theta"])
    draw = train_mod.make_batch_fn(cfg, C, B, S, seed=0, device="cuda")
    flash = 2 * cfg.num_layers * C          # the forward, remat's recompute
    problems, steps = [], []
    for s in range(MESH_STEP_STEPS):
        batch = draw()
        dbatch = sharding.distribute(batch, mesh, sharding.train_batch_pspecs(
            cfg, mesh, batch))
        row = {}
        for name, fn, args in (("plain", plain, (state, batch)),
                               ("mesh", on_mesh, (dstate, dbatch))):
            torch.cuda.synchronize()
            reset_launches(mods)
            t0 = time.perf_counter()
            out, metrics = fn(*args)
            torch.cuda.synchronize()
            row[name] = dict(step_s=time.perf_counter() - t0,
                             launches=read_launches(mods),
                             loss=float(metrics["loss"]),
                             ratios=metrics["ratios"].tolist())
            if name == "plain":
                state, m_plain = out, metrics
            else:
                dstate, m_mesh = out, metrics
            want = dict.fromkeys(row[name]["launches"], 0)
            want.update(per_client_sign_align=1, masked_agg=1,
                        flash_attention=flash)
            if row[name]["launches"] != want:
                problems.append(f"step {s} {name}: launches "
                                f"{row[name]['launches']}, not {want}")
        pairs = list(zip(tree.leaves(state), tree.leaves(dstate)))
        state_equal = all(torch.equal(a, b.full_tensor()) for a, b in pairs)
        metrics_equal = all(torch.equal(m_plain[k], m_mesh[k])
                            for k in m_plain)
        dtensors = sum(hasattr(b, "full_tensor") for _, b in pairs)
        if not (state_equal and metrics_equal and dtensors == len(pairs)):
            problems.append(f"step {s}: state equal {state_equal}, metrics "
                            f"equal {metrics_equal}, {dtensors} of "
                            f"{len(pairs)} leaves DTensors")
        steps.append(dict(step=s, state_equal_by_bits=state_equal,
                          metrics_equal_by_bits=metrics_equal, **row))
    line = dict(run="qwen2-1.5b sharded step", arch=cfg.name,
                layers=cfg.num_layers, full_depth=28,
                cuts=["depth: 28 -> 4 layers (full width)"],
                mesh=mesh_name(mesh), backend="nccl", clients=C,
                per_client_batch=B, seq=S, steps=steps,
                flash_launches_per_step_expected=flash, problems=problems,
                nvidia_smi=smi)
    emit("mesh", **line)
    return line


def mesh_int64_counts(smi: str) -> dict:
    """12 (a): the int64 counts that the row-sharded placement rules
    all-reduce (kernels/sharded.py), the kernel's (two chunks at the
    least, its adding launch left out) against the plain version's by
    bits, one launch each."""
    from repro_torch.kernels import ref, sharded, sign_align
    g = torch.Generator(device="cuda").manual_seed(7)
    u = torch.randn((3, 40, 1024), generator=g, device="cuda")
    u[u.abs() < 0.05] = 0.0
    r = torch.randint(-1, 2, (40, 1024), generator=g, device="cuda",
                      dtype=torch.int8)
    r.view(-1)[-100:] = -2                          # padding sentinel
    before = dict(sign_align.launches)
    got = sharded._counts_int64(u, r)
    got1 = sharded._count_int64(u[0].to(torch.bfloat16), r)
    torch.cuda.synchronize()
    launched = {k: sign_align.launches[k] - before[k] for k in before}
    want = ref.per_client_sign_align_int64(u.cpu(), r.cpu())
    want1 = ref.sign_align_counts_int64(u[0].to(torch.bfloat16).cpu(),
                                        r.cpu())
    equal = (got.dtype == torch.int64 and torch.equal(got.cpu(), want)
             and got1.dtype == torch.int64 and torch.equal(got1.cpu(),
                                                           want1))
    problems = []
    if not equal:
        problems.append(f"int64 counts {got.tolist()} / {got1.item()}, "
                        f"plain {want.tolist()} / {want1.item()}")
    if launched != {"per_client_sign_align": 1, "sign_align_counts": 1}:
        problems.append(f"int64 counts launched {launched}")
    line = dict(run="int64 counts", equal_by_bits=equal, launches=launched,
                counts=got.tolist(), count_bf16=int(got1), problems=problems,
                nvidia_smi=smi)
    emit("mesh", **line)
    return line


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def mesh_population(smi: str) -> dict:
    """12 (b): the 1,000,000-client population round on the one-rank
    "data" mesh against the single-device round, by bits; ms a round."""
    from repro_torch.core import control, population
    from repro_torch.launch import mesh as mesh_mod
    n = POP_CLIENTS[-1]
    mesh = mesh_mod.make_population_mesh()
    problems, runs = [], {}
    for name, frac in (("two_stage", POP_FRAC), ("single", None)):
        on_mesh = population.build_population_round(
            n, POP_K, candidate_frac=frac, mesh=mesh, device="cuda")
        one = population.build_population_round(
            n, POP_K, candidate_frac=frac, candidate_shards=1,
            device="cuda")
        a, ca = pop_rounds(on_mesh, seeded_state(control, n, "cuda"), 3)
        b, cb = pop_rounds(one, seeded_state(control, n, "cuda"), 3)
        cohorts = all(torch.equal(x, y) for x, y in zip(ca, cb))
        fields = all(torch.equal(getattr(a, f).full_tensor(), getattr(b, f))
                     for f in population._FIELDS)
        state = seeded_state(control, n, "cuda")
        ms_mesh, ms_one = [], []
        for _turn in range(2):                      # mesh, one, one, mesh
            ms_mesh.append(pop_ms(on_mesh, state, POP_ROUNDS))
            ms_one.append(pop_ms(one, state, POP_ROUNDS))
        runs[name] = dict(cohorts_equal_by_bits=cohorts,
                          state_equal_by_bits=fields,
                          ms_per_round_mesh=ms_mesh,
                          ms_per_round_single_device=ms_one)
        if not (cohorts and fields):
            problems.append(f"{name}: cohorts equal {cohorts}, state equal "
                            f"{fields}")
    line = dict(run="population 1M", clients=n, cohort=POP_K,
                candidate_frac=POP_FRAC, rounds_held=3,
                rounds_timed=POP_ROUNDS, mesh=mesh_name(mesh),
                backend="nccl", runs=runs, problems=problems,
                nvidia_smi=smi)
    emit("mesh", **line)
    return line


# qwen2-1.5b × train_4k on the 16 × 16 mesh as the JAX package compiles it:
# ``python -m repro.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh
# single`` (jax 0.9.0 on 512 forced host devices, CPU), a device's
# ``hlo_census`` FLOPs and collective bytes by kind and its
# ``memory_analysis`` (whose peak on the CPU backend is its arguments';
# ``temp_bytes`` beside it)
JAX_QWEN2_TRAIN_16X16 = dict(
    flops=91695404285952.0,
    per_op_bytes={"all-reduce": 97955377000.0,
                  "all-gather": 120390286848.0,
                  "collective-permute": 3554964608.0,
                  "all-to-all": 116785152.0},
    collective_bytes=222017413608.0,
    memory_analysis=dict(argument_bytes=1668144144, output_bytes=1667620704,
                         temp_bytes=18954558712, peak_bytes=1668158626))
MESH_FLOPS_RTOL = 0.05     # the port's per-device FLOPs against JAX's
QWEN2_D_FF = 8960


def mesh_census_held(lines, smi: str) -> bool:
    """The dry-run CLI's 16 × 16 training row of qwen2-1.5b against the JAX
    package's compiled step on the same mesh (``JAX_QWEN2_TRAIN_16X16``):
    the census's matrix-product FLOPs a device within ``MESH_FLOPS_RTOL``
    of JAX's, and none of its largest products (the dry run prints them by
    local shape) spans the whole d_ff, i.e. contracts over it or makes it
    on a "model" rank; collective bytes by kind and the peak a device
    printed beside JAX's (``"phase": "mesh"``)."""
    import ast
    block = "\n".join(lines).split("train_4k × 16x16:")[1].split(
        "[dryrun]")[0]
    flops = float(re.search(r"flops=([0-9.e+]+)", block).group(1))
    memory = ast.literal_eval(re.search(r"memory_analysis: (\{.*\})",
                                        block).group(1))
    per_op = ast.literal_eval(re.search(r"collectives: (\{.*\})",
                                        block).group(1))
    products = re.findall(r"of the FLOPs: (.*)", block)
    whole = [p for p in products if str(QWEN2_D_FF) in re.split(r"\W+", p)]
    jax = JAX_QWEN2_TRAIN_16X16
    held = (abs(flops / jax["flops"] - 1.0) <= MESH_FLOPS_RTOL
            and not whole)
    emit("mesh", run="qwen2-1.5b train_4k 16x16 census vs jax",
         torch=torch.__version__, flops=flops, jax_flops=jax["flops"],
         flops_ratio=flops / jax["flops"], rtol=MESH_FLOPS_RTOL,
         per_op_bytes=per_op, collective_bytes=sum(per_op.values()),
         jax_per_op_bytes=jax["per_op_bytes"],
         jax_collective_bytes=jax["collective_bytes"],
         peak_bytes=memory["peak_bytes"], memory_analysis=memory,
         jax_memory_analysis=jax["memory_analysis"],
         card_bytes=torch.cuda.get_device_properties(0).total_memory,
         largest_products=products, whole_d_ff_products=whole,
         held=held, nvidia_smi=smi)
    return held


def phase_mesh(mods, smi: str) -> dict:
    """Phase 12 (module docstring, (a) to (c))."""
    import torch.distributed as tdist
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        start_nccl_world(tmp)
        seconds["start_world"] = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            lines = [mesh_step(mods, smi), mesh_int64_counts(smi)]
            seconds["step"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            lines.append(mesh_population(smi))
            seconds["population"] = time.perf_counter() - t0
        finally:
            tdist.destroy_process_group()
    free_card()
    cli_check("mesh", "dryrun --mesh both qwen2-1.5b train_4k", [
        "repro_torch.launch.dryrun", "--arch", "qwen2-1.5b", "--shape",
        "train_4k", "--mesh", "both", "--results", "{ckpt}/dry.jsonl"],
        lambda lines: lines[-1] == "[dryrun] all combos traced on meta "
        "successfully" and sum(line.startswith(
            "[dryrun] qwen2-1.5b × train_4k × ") for line in lines) == 2
        and mesh_census_held(lines, smi))
    problems = [p for line in lines for p in line["problems"]]
    emit("mesh_phase", seconds=time.perf_counter() - t_phase,
         seconds_by_part=seconds, problems=problems, nvidia_smi=smi)
    if problems:
        raise AssertionError("mesh: " + "; ".join(problems))
    return {}


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
    if sys.argv[1:] == ["--serve"]:
        _build.build_all()
        phase_serve(T, parity, mods, smi)
        return 0
    if sys.argv[1:] == ["--lm"]:
        _build.build_all()
        phase_flash(flash_attn, ref)
        phase_lm(mods)
        phase_moe(mods, parity, smi)
        return 0
    if sys.argv[1:] == ["--train"]:
        _build.build_all()
        phase_train(mods, parity, ref, smi)
        return 0
    if sys.argv[1:] == ["--families"]:
        _build.build_all()
        phase_families(mods, parity, ref, smi)
        return 0
    if sys.argv[1:] == ["--sim-lm"]:
        _build.build_all()
        phase_sim_lm(T, parity, mods, ref, smi)
        return 0
    if sys.argv[1:] == ["--dryrun"]:
        _build.build_all()
        phase_dryrun(mods, smi)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        _build.build_all()
        phase_mesh(mods, smi)
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

    # every CLI check runs at the end, after phase 11, together
    global DEFERRED_CLIS
    DEFERRED_CLIS = []

    # the CPU halves of phases 7-10's card-vs-CPU checks start on a worker
    # thread now; it parks while host work is timed (``quiet``) and the
    # card halves run between phases (``drain``) and at the end
    global CPU_HALVES
    CPU_HALVES = CpuHalves(CPU_HALF_THREADS, CPU_HALF_BUDGET)
    for half in (lm_halves(mods) + moe_halves(mods, parity)
                 + train_halves(mods, parity) + family_halves(mods, parity)
                 + sim_halves(T, parity, mods)):
        CPU_HALVES.add(*half)
    CPU_HALVES.start()
    launches = {}

    # 3. kernels
    with quiet():
        rows = phase_kernels(sign_align, masked_agg, ref)
        sign_chunk_edges(sign_align, _launch, ref)
        sign_past_int32(sign_align, _launch, ref, smi)
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
    finals, sims = {}, {}
    # the quickstart's s a round and the traces: the worker parked
    with quiet():
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
            # the scanned path without fused eval evaluates at the end of
            # each dispatch, so its first rounds carry NaN
            first_eval = (spec.rounds_per_dispatch - 1
                          if spec.rounds_per_dispatch and not spec.fused_eval
                          else 0)
            if not (all(math.isfinite(r.loss) for r in res.records) and all(
                    math.isfinite(r.accuracy)
                    for r in res.records[first_eval:])):
                raise AssertionError(f"{run}: accuracy or loss not finite")
            held_launches(run, launches[run], needed, by_rows)
            if "int8 scanned" in run and launches[run]["cohort_gather"] != \
                    spec.rounds:
                raise AssertionError(
                    f"{run}: cohort_gather launched "
                    f"{launches[run]['cohort_gather']} times, not once a "
                    f"round")
            finals[run], sims[run] = res, sim
        emit("slice", run="ours+int8 scanned half",
             sync_free_dispatch=sync_free_dispatch(
                 T, runs["ours+int8 scanned half"][0], params))
        phase_trace(T, runs["ours+int8 scanned fused"][0],
                    runs["ours+int8"][0], params)
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
    drain(launches)
    launches["ops"] = phase_ops(T, ops, params, mods)
    with quiet():
        launches.update(phase_spmd(T, parity, params, mods))

    # 6b. dynamic worlds on the four ported paths (each timed run quiet)
    launches.update(phase_scenario(T, parity, params, mods, smi))

    # 6c. hierarchical topologies on the four ported paths (each timed run
    # quiet)
    launches.update(phase_topology(T, parity, sign_align, ref, params,
                                   mods, smi))

    # 6d. world scale: the population plane, two-stage selection and
    # non-resident worlds
    with quiet():
        launches.update(phase_population(T, parity, sign_align, masked_agg,
                                         quantize, ref, params, mods, smi))

    # 6e. sessions: checkpoint, restore and resume on the four paths
    drain(launches)
    phase_session(T, parity, params, mods, smi)

    # 6f. serving the detector, with drift-triggered re-federation
    drain(launches)
    with quiet():
        phase_serve(T, parity, mods, smi)

    # 7. LM serving at qwen2-1.5b's full width, then the moe and vlm
    # families (granite-moe, internvl2, arctic cut to one layer)
    drain(launches)
    launches.update(phase_lm(mods))
    drain(launches)
    launches.update(phase_moe(mods, parity, smi))

    # 8. training the language models: qwen2-1.5b and granite-moe at full
    # width through the spmd step, the kernels at the LM arena, the flash
    # backward, card against CPU at 2 layers, the trainer's CLI
    drain(launches)
    launches.update(phase_train(mods, parity, ref, smi))

    # 9. the ssm, hybrid and audio families: rwkv6-7b, hymba-1.5b and
    # whisper-tiny served at full width, hymba and whisper trained, card
    # against CPU in f32, their CLIs
    drain(launches)
    launches.update(phase_families(mods, parity, ref, smi))

    # 10. the language models on the sim engines under ours: qwen2-1.5b at
    # full width through the async megastep, the loop, the int8 megastep
    # and the int8 scanned path at 2 layers, card against CPU in f32
    drain(launches)
    launches.update(phase_sim_lm(T, parity, mods, ref, smi))

    # 11. the dry run's census against the card: qwen2-1.5b's prefill and
    # training step
    drain(launches)
    phase_dryrun(mods, smi)

    # 12. the port on a mesh: the sharded step and population over a
    # one-rank NCCL group, the production meshes' dry run; then every CLI
    # check of phases 6f-12, together, and the card halves not yet run
    drain(launches)
    phase_mesh(mods, smi)
    drain(launches)
    t0 = time.perf_counter()
    run_clis(DEFERRED_CLIS)
    emit("cli_phase", seconds=time.perf_counter() - t0, nvidia_smi=smi)
    CPU_HALVES.finish(launches)

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
