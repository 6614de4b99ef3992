"""Three-term roofline of a dry-run step on one NVIDIA H100: the
counterpart of the JAX package's ``roofline/analysis.py``, on the card's
peaks instead of the TPU's.

  compute term    = FLOPs / (989 TFLOP/s, bf16 dense tensor cores)
  memory term     = traffic bytes / (3.35 TB/s HBM)
  collective term = bytes of collectives within one node / (450 GB/s
                    NVLink each way) + bytes of collectives across nodes /
                    (50 GB/s InfiniBand a card)

The first three figures are NVIDIA's data sheet for the H100 SXM at its
700 W limit (the NVLink figure is the data sheet's 900 GB/s to the host's
other cards, 450 each way); a card set below 700 W runs slower. An HGX
H100 node joins 8 cards by NVLink; a collective whose group spans more
than one node of 8 consecutive ranks (any group over a mesh dim of 16,
and the "pod" and "data" axes of the production meshes) runs over the
node's InfiniBand, NDR 400 Gb/s, 50 GB/s a card (the ConnectX-7 data
sheet, one port a card). FLOPs, traffic
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
IB_BW = 50e9                   # bytes/s a card: NDR InfiniBand, 400 Gb/s
NODE_CARDS = 8                 # cards an HGX H100 node joins by NVLink


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


def link(row: dict) -> str:
    """``"nvlink"`` for a collective whose group lies in one node of
    ``NODE_CARDS`` consecutive ranks (``row["nodes"]`` == 1, or, where the
    census did not record the nodes, a group of at most ``NODE_CARDS``
    ranks), ``"infiniband"`` otherwise."""
    nodes = row.get("nodes")
    if nodes is None:
        return "nvlink" if (row.get("group_size") or 1) <= NODE_CARDS \
            else "infiniband"
    return "nvlink" if nodes <= 1 else "infiniband"


def collective_times(census: dict) -> tuple:
    """(seconds over NVLink, seconds over InfiniBand) of a census's
    collectives, per device; bytes the census could not name a group for
    are charged to NVLink."""
    rows = census.get("collectives") or []
    by_link = {"nvlink": 0.0, "infiniband": 0.0}
    for row in rows:
        by_link[link(row)] += float(row["bytes"])
    unnamed = float(census.get("collective_bytes", 0.0) or 0.0) - \
        sum(by_link.values())
    by_link["nvlink"] += max(unnamed, 0.0)
    return by_link["nvlink"] / NVLINK_BW, by_link["infiniband"] / IB_BW


def analyze(arch: str, shape, mesh_name: str, chips: int, census: dict,
            cfg, memory_stats=None) -> Roofline:
    """The roofline of one step from its census (per device)."""
    flops_dev = float(census.get("flops", 0.0) or 0.0)
    bytes_dev = float(census.get("traffic_bytes", 0.0) or 0.0)
    coll_dev = float(census.get("collective_bytes", 0.0) or 0.0)
    t_c = flops_dev / PEAK_FLOPS_BF16
    t_m = bytes_dev / HBM_BW
    t_nv, t_ib = collective_times(census)
    t_x = t_nv + t_ib
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


def collective_fields(census: dict) -> dict:
    """What a dry-run row adds to the JAX package's ``Roofline`` fields:
    per device, the collective bytes by kind, the census's collective
    rows (kind, mesh dims, ranks, nodes, calls, bytes) and the collective
    term's two links (seconds)."""
    t_nv, t_ib = collective_times(census)
    return {"per_op_bytes": dict(census.get("per_op_bytes") or {}),
            "collectives": list(census.get("collectives") or []),
            "t_collective_nvlink": t_nv, "t_collective_ib": t_ib}


def save_jsonl(path: str, rows, extras=None) -> None:
    """Append each ``Roofline`` as a JSON line, with the keys of its
    ``extras`` dict (one a row) beside its fields."""
    extras = extras or [{}] * len(rows)
    with open(path, "a") as f:
        for r, extra in zip(rows, extras):
            f.write(json.dumps({**dataclasses.asdict(r), **extra}) + "\n")


def load_jsonl(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    return rows
