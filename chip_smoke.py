#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

  1. device  — the card's name and power limit (nvidia-smi), torch and
               CUDA versions; TF32 matmuls must be off.
  2. build   — compile every ``csrc/*.cu`` with nvcc, all at once.
  3. kernels — each hand-written kernel against its plain PyTorch version
               on the card, at the main path's shape (C = 16 clients,
               R = 54 arena rows) and a ragged one (C = 5, R = 7), with ±0
               updates and -2 sentinel padding; times with CUDA events.
  4. slice   — the paper's quickstart experiment (anomaly-mlp, 10 clients,
               20,000 samples, 8 rounds) through ``repro_torch.run_experiment``
               on the card, for ``fedavg`` and ``ours``, from random weights
               made from a seed; every kernel of the path must launch.
  5. card vs CPU — ``ours`` on the card and on the CPU from the same
               weights: selection, dropout, bytes, update counts and times
               equal, accuracy and loss within ``repro_torch.api.parity``.

Then the ``kernels`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It needs a CUDA device and the repository
around it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet) for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # non-tensor-core f32 (and int32 ALU) rate

MAIN_SHAPE = (16, 54)          # 10 clients padded to 16; 54,602 params
RAGGED_SHAPE = (5, 7)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def quickstart_spec(T, strategy: str):
    """examples/quickstart.py's spec, at full width."""
    return T.ExperimentSpec(
        model="anomaly-mlp",
        data=T.DataSpec(n_samples=20000, eval_samples=4000, alpha=0.5),
        world=T.WorldSpec(num_clients=10, dropout_p=0.1),
        comm=T.CommModel(bandwidth=5e6, latency=0.5, t_sample=2e-3,
                         t_launch=0.25),
        strategy=strategy,
        strategy_kwargs=dict(batch_size=64, lr=3e-2, local_epochs=2),
        rounds=8, seed=0)


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


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(sign_align, masked_agg, ref) -> dict:
    """Hold each kernel to its plain version; time both at the main shape."""
    sa_err = ma_err = 0.0
    for C, R in (RAGGED_SHAPE, MAIN_SHAPE):
        u, r, w = kernel_inputs(C, R)
        got = sign_align.per_client_sign_align(u, r)
        want = ref.per_client_sign_align(u, r)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"sign-align counts differ at C={C}, R={R}: "
                                 f"{got.tolist()} vs {want.tolist()}")
        sa_err = max(sa_err, float((got - want).abs().max()))
        got = masked_agg.masked_agg(u, w)
        want = ref.masked_agg(u, w)
        scale = (u * w[:, None, None]).abs().sum(dim=0)
        torch.cuda.synchronize()
        excess = float(((got - want).abs() - 1e-6 * scale).max())
        if not excess <= 0.0:
            raise AssertionError(f"masked_agg differs from its plain version "
                                 f"beyond rtol 1e-6 of sum|w*u| at C={C}, "
                                 f"R={R} (excess {excess})")
        ma_err = max(ma_err, float((got - want).abs().max()))
        emit("kernels", shape=[C, R], sign_align="equal",
             masked_agg_max_abs_err=float((got - want).abs().max()))

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
            bound_ms=sa_bound[0], bound_by=sa_bound[1], library_ms=None),
        "masked_agg": dict(
            route="cuda", source="src/repro_torch/csrc/masked_agg.cu",
            replaces="src/repro/kernels/masked_agg.py:37",
            max_abs_err=ma_err,
            ms=time_ms(lambda: masked_agg.masked_agg(u, w)),
            device_ms=graph_ms(lambda: masked_agg.masked_agg(u, w)),
            plain_ms=time_ms(lambda: ref.masked_agg(u, w)),
            bound_ms=ma_bound[0], bound_by=ma_bound[1],
            library_ms=time_ms(lambda: torch.einsum("crl,c->rl", u, w))),
    }
    for name, row in rows.items():
        emit("kernels", name=name, shape=[C, R],
             **{k: v for k, v in row.items() if k.endswith("ms")})
    return rows


def run_card(T, strategy: str, params) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = T.run_experiment(quickstart_spec(T, strategy), device="cuda",
                           params=params)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main() -> int:
    import repro_torch as T
    from repro_torch.api import parity
    from repro_torch.kernels import _build, masked_agg, ref, sign_align
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

    # 3. kernels
    rows = phase_kernels(sign_align, masked_agg, ref)

    # 4. slice: the quickstart spec on the card
    cfg = quickstart_spec(T, "ours").resolve_model()
    params = model_api.init_params(torch.Generator().manual_seed(0), cfg)
    finals, launches = {}, {}
    for strategy in ("fedavg", "ours"):
        sign_align.launches = masked_agg.launches = 0
        res, wall = run_card(T, strategy, params)
        launches[strategy] = {"per_client_sign_align": sign_align.launches,
                              "masked_agg": masked_agg.launches}
        for rec in res.records:
            emit("slice", strategy=strategy, **dataclasses.asdict(rec))
        emit("slice", strategy=strategy, rounds=len(res.records),
             wall_s=wall, wall_s_per_round=wall / len(res.records),
             launches=launches[strategy])
        if not all(math.isfinite(r.accuracy) and math.isfinite(r.loss)
                   for r in res.records):
            raise AssertionError(f"{strategy}: accuracy or loss not finite")
        finals[strategy] = res
    for kname, count in launches["ours"].items():
        if count < 1:
            raise AssertionError(f"{kname} was never launched on the main "
                                 "path of 'ours'")
    base, ours = finals["fedavg"].final, finals["ours"].final
    emit("slice", headline=dict(
        time_reduction_pct=100 * (1 - ours.sim_time / base.sim_time),
        bytes_saving_pct=100 * (1 - ours.bytes_sent / max(base.bytes_sent, 1)),
        accuracy_delta_pts=100 * (ours.accuracy - base.accuracy)),
        note="simulated seconds and bytes of the experiment, not card speed")

    # 5. card vs CPU, from the same weights
    spec = quickstart_spec(T, "ours")
    sims = {}
    for dev in ("cuda", "cpu"):
        sim = T.build_simulation(spec, device=dev, params=params)
        sim.run(spec.rounds)
        sims[dev] = sim
    card, cpu = sims["cuda"], sims["cpu"]
    problems = (parity.theta_band_violations(card.theta_ratios, 0.65)
                + parity.theta_band_violations(cpu.theta_ratios, 0.65))
    card_recs = T.result_from_simulation(spec, card).records
    cpu_recs = T.result_from_simulation(spec, cpu).records
    problems += parity.record_mismatches(card_recs, cpu_recs)
    problems += parity.record_mismatches(finals["ours"].records, cpu_recs)
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
    emit("card_vs_cpu", problems=problems, theta_tests=len(card.theta_ratios),
         max_ratio_gap=ratio_gap,
         min_ratio_distance_to_theta=min(
             (abs(x[2] - 0.65) for x in card.theta_ratios), default=None),
         max_loss_rel_gap=max(abs(a.loss - b.loss) / abs(b.loss)
                              for a, b in zip(card_recs, cpu_recs)),
         max_acc_gap=max(abs(a.accuracy - b.accuracy)
                         for a, b in zip(card_recs, cpu_recs)))
    if problems:
        raise AssertionError("card and CPU disagree: " + "; ".join(problems))

    print(json.dumps({"kernels": [
        {"name": k, **row, "launches": launches["ours"][k]}
        for k, row in rows.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
