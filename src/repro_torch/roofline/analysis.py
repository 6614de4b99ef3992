"""Three-term roofline of a dry-run step on one NVIDIA H100: the
counterpart of the JAX package's ``roofline/analysis.py``, on the card's
peaks instead of the TPU's.

  compute term    = FLOPs / (989 TFLOP/s, bf16 dense tensor cores)
  memory term     = traffic bytes / (3.35 TB/s HBM)
  collective term = collective bytes / (450 GB/s NVLink each way)

All three are NVIDIA's data-sheet figures for the H100 SXM at its 700 W
limit (the NVLink figure is the data sheet's 900 GB/s to the host's other
cards, 450 each way); a card set below 700 W runs slower. FLOPs, traffic
and collective bytes come from the dry run's census
(``roofline/census.py``), per device. MODEL_FLOPS = 6·N·D for training
(N the active parameters, D the tokens), 2·N·D for a prefill and 2·N a
sequence for a decode step: the ratio MODEL_FLOPS / FLOPs flags remat and
redundancy. The dominant term is the bottleneck the step would hit at the
card's peaks.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_FLOPS_BF16 = 989e12       # FLOP/s a card, tensor cores, bf16
HBM_BW = 3.35e12               # bytes/s a card
NVLINK_BW = 450e9              # bytes/s a card, each way (data sheet: 900)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    useful_ratio: float          # MODEL_FLOPS / FLOPs
    bytes_per_device: Optional[dict] = None
    op_counts: Optional[dict] = None

    def as_row(self) -> str:
        return (f"{self.arch:22s} {self.shape:11s} {self.mesh:9s} "
                f"c={self.t_compute:.3e}s m={self.t_memory:.3e}s "
                f"x={self.t_collective:.3e}s -> {self.dominant:10s} "
                f"useful={self.useful_ratio:.2f}")


def model_flops(cfg, shape) -> float:
    """6·N·D with N = active params, D = processed tokens (or samples)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch      # decode: one token each


def analyze(arch: str, shape, mesh_name: str, chips: int, census: dict,
            cfg, memory_stats=None) -> Roofline:
    """The roofline of one step from its census (per device)."""
    flops_dev = float(census.get("flops", 0.0) or 0.0)
    bytes_dev = float(census.get("traffic_bytes", 0.0) or 0.0)
    coll_dev = float(census.get("collective_bytes", 0.0) or 0.0)
    t_c = flops_dev / PEAK_FLOPS_BF16
    t_m = bytes_dev / HBM_BW
    t_x = coll_dev / NVLINK_BW
    mf = model_flops(cfg, shape)
    dominant = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
                   key=lambda kv: kv[1])[0]
    total_flops = flops_dev * chips
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=total_flops, hlo_bytes=bytes_dev * chips,
        collective_bytes=coll_dev * chips,
        model_flops=mf, t_compute=t_c, t_memory=t_m, t_collective=t_x,
        dominant=dominant,
        useful_ratio=(mf / total_flops) if total_flops else 0.0,
        bytes_per_device=memory_stats,
        op_counts=census.get("op_counts"))


def save_jsonl(path: str, rows) -> None:
    with open(path, "a") as f:
        for r in rows:
            f.write(json.dumps(dataclasses.asdict(r)) + "\n")


def load_jsonl(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    return rows
