"""Assigned input shapes (a copy of the JAX package's data).

  train_4k     — training step (fl_train_step: per-client grads + masked agg)
  prefill_32k  — inference prefill (logits + cache build)
  decode_32k   — ONE new token against a 32k KV/state cache
  long_500k    — ONE new token against a 512k context; sub-quadratic archs
                 run natively, dense archs run the sliding-window variant
                 (window 4096).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# smoke-scale counterparts (same kind, tiny dims) used by CPU tests
SMOKE_SHAPES = {
    "train_4k": InputShape("train_4k", 64, 8, "train"),
    "prefill_32k": InputShape("prefill_32k", 96, 2, "prefill"),
    "decode_32k": InputShape("decode_32k", 96, 4, "decode"),
    "long_500k": InputShape("long_500k", 256, 1, "decode"),
}
