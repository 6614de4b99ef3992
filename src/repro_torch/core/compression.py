"""Int8 wire compression with error feedback (the paper's §VI names
gradient compression as the complementary lever for bandwidth-constrained
links).

Client→server updates are quantized per row to int8 (kernels/quantize.py,
about 4× fewer bytes on the wire, on top of the θ filter's savings). The
quantization residual is carried in per-client error-feedback buffers, so
the compression bias vanishes over rounds:

    q_t = Q(g_t + e_{t-1})
    e_t = (g_t + e_{t-1}) − deQ(q_t)

The server aggregates the dequantized updates. On the cohort paths the
add, the codec's two halves and the subtract are one kernel,
``ef_round_trip`` (kernels/quantize.py), whose plain version on the CPU
is those four operations; the per-client loop runs them one by one
around the codec kernels, as the JAX loop does.
"""
from __future__ import annotations


import torch

from repro_torch.kernels import ops
from repro_torch.kernels import quantize
from repro_torch.tree import leaves, tree_map


def init_error_state(params):
    """One client's error-feedback buffers (f32, zero), a nest like
    ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# ---------------------------------------------------------------------------
# the cohort megastep path: every client's buffer in one arena
# ---------------------------------------------------------------------------

def init_error_arena(num_clients: int, arena, device) -> torch.Tensor:
    """All clients' error-feedback buffers as one (N, rows, lane) f32
    tensor, gathered and scattered by cohort index in the megastep."""
    return torch.zeros((num_clients, arena.rows, arena.lane),
                       dtype=torch.float32, device=device)


def compress_cohort(deltas: torch.Tensor, err: torch.Tensor):
    """Error-corrected int8 round trip for a whole cohort in arena space.

    deltas, err: (C, rows, lane) f32. Returns (restored, new_err):
    ``restored`` is the dequantized wire payload (what the server sees),
    ``new_err`` the residual to carry. Quantization is row by row, so the
    cohort folds into one (C·rows, lane) call, with the same scales as the
    per-client path.
    """
    C, R, L = deltas.shape
    restored, residual = quantize.ef_round_trip(deltas.reshape(C * R, L),
                                                err.reshape(C * R, L))
    return restored.reshape(C, R, L), residual.reshape(C, R, L)


def arena_wire_bytes(arena) -> int:
    """Wire bytes of one client's compressed update in the arena layout
    (int8 payload and one f32 scale per row); equals ``transport_bytes``
    of the same flattened dict."""
    return arena.rows * arena.lane + 4 * arena.rows


# ---------------------------------------------------------------------------
# the per-client loop: one parameter nest at a time
# ---------------------------------------------------------------------------

def compress_update(update, error):
    """(update, error) nests -> (q, scales, n_true, new_error); q and
    scales are the payload, n_lanes + 4·rows bytes against 4·n in f32."""
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, update, error)
    q, s, n = ops.quantize_tree(corrected)
    restored = ops.dequantize_tree(q, s, corrected)
    new_error = tree_map(lambda c, r: c - r.to(torch.float32), corrected,
                         restored)
    return q, s, n, new_error


def decompress_update(q: torch.Tensor, s: torch.Tensor, like):
    return ops.dequantize_tree(q, s, like)


def transport_bytes(q: torch.Tensor, s: torch.Tensor) -> int:
    """Wire bytes of a compressed update."""
    return int(q.numel() * q.element_size() + s.numel() * s.element_size())


def compression_ratio(params) -> float:
    """f32 update bytes / compressed bytes (about 4 for int8 and row
    scales)."""
    n = sum(p.numel() for p in leaves(params))
    rows = (n + ops.LANE - 1) // ops.LANE
    return (4.0 * n) / (rows * ops.LANE + 4.0 * rows)
