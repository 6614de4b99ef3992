"""Sign-alignment counts: the θ filter's hot spot (paper Alg. 1,
CALCULATE-RELEVANCE).

``per_client_sign_align(u, r)`` takes the cohort's packed updates
u (C, R, LANE) f32 and the reference signs r (R, LANE) int8 (-2 on
padding) and returns the (C,) f32 counts of slots where sign(u[c]) == r.
It also takes P references r (P, R, LANE) with C % P == 0: client c is
then counted against r[c // (C / P)], in the same one launch (a topology
sync scores every parent's children against that parent's signs).
``sign_align_counts(g, r)`` counts the same for one update g (R, LANE),
f32 or bf16, and returns a 0-dim f32 tensor on g's device (the kernel
path reads nothing back). The tensor's device decides the
implementation: on the CPU the plain versions in ``kernels/ref.py``, on a
CUDA device the hand-written kernels in ``csrc/sign_align.cu`` or an
exception; on the meta device a shape-only call (``kernels/meta.py``) for
the dry run. Below 2^23 slots a count (every count of the anomaly-detection
paths) a call on the card is one device operation: the kernel writes the
f32 counts into the ``torch.empty`` output that the wrapper returns. A
longer count is taken in ``chunks(C, n)`` chunks of fewer than 2^31 slots
each (enough to bring about 132 blocks to it), each counted in int32 into a
workspace and added in int64 by a second launch. Both versions count
exactly at any size and convert to f32 once. A DTensor argument takes its
placement rule in ``kernels/sharded.py``; where that rule splits a count
over row shards, it asks ``_count_clients`` / ``_count_one`` for the
int64 count before the conversion (the kernel counts in two chunks at the
least, leaves the adding launch out and the wrapper adds the int32
partials), all-reduces it in int64 and converts once. ``launches`` counts
each kernel's calls, by function name.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.kernels import _launch
from repro_torch.kernels import meta
from repro_torch.kernels import ref

LANE = 1024
CHUNK_SLOTS = 2 ** 30       # the most slots one cluster counts in int32
SPREAD_SLOTS = 2 ** 22      # the least slots of a chunk split off to fill
#                             the card
# The kernel's launch picks a chunk's cluster of blocks from the same two
# numbers (``cluster_size`` in csrc/sign_align.cu): the chunks are chosen
# here because the workspace is allocated here, and
# tests/test_torch_launch.py holds these two to the source's kBusyBlocks
# and kMaxCluster.
BUSY_BLOCKS = 132           # the H100's SMs
MAX_CLUSTER = 8             # the portable limit of a cluster's blocks

launches = {"per_client_sign_align": 0, "sign_align_counts": 0}


def chunks(clients: int, n: int) -> int:
    """The chunks the kernel takes each of ``clients`` counts of ``n``
    slots in: enough that none holds 2^31 slots, and, where a count's
    cluster of 8 blocks leaves most of the card idle, enough to bring
    about ``BUSY_BLOCKS`` blocks to the call, each chunk of at least
    ``SPREAD_SLOTS`` slots. One below 2^23 slots a count."""
    need = -(-n // CHUNK_SLOTS)
    spread = min(-(-BUSY_BLOCKS // (MAX_CLUSTER * clients)),
                 n // SPREAD_SLOTS)
    return max(need, spread, 1)


def _workspace(like: torch.Tensor, clients: int, n: int,
               least_chunks: int = 1):
    """(chunks, the data pointer of an int32 (clients, chunks) workspace
    on ``like``'s card or 0 for one chunk, the workspace), which the
    caller holds until its launch is enqueued."""
    k = max(chunks(clients, n), least_chunks)
    if k == 1:
        return 1, 0, None
    partials = torch.empty(clients * k, dtype=torch.int32, device=like.device)
    return k, partials.data_ptr(), partials


def check_args(u: torch.Tensor, r: torch.Tensor) -> int:
    """Refuse what neither version of ``per_client_sign_align`` takes;
    ``_launch.device_index``'s answer for the tensors' device."""
    shape = u.shape
    if len(shape) != 3 or shape[2] != LANE or shape[0] < 1:
        raise ValueError(f"u must be (C >= 1, R, {LANE}); got {tuple(shape)}")
    if r.shape != shape[1:] and not (
            r.dim() == 3 and r.shape[1:] == shape[1:] and r.shape[0] >= 1
            and shape[0] % r.shape[0] == 0):
        raise ValueError(f"r must be {tuple(shape[1:])} or (P, "
                         f"*{tuple(shape[1:])}) with P dividing C = "
                         f"{shape[0]}; got {tuple(r.shape)}")
    if u.dtype != torch.float32 or r.dtype != torch.int8:
        raise TypeError(f"expected u float32 and r int8; got {u.dtype}, "
                        f"{r.dtype}")
    return _launch.device_index("per_client_sign_align", u, r)


def per_client_sign_align(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    if dist.is_dtensor(u, r):
        from repro_torch.kernels import sharded
        return sharded.per_client_sign_align(u, r)
    device = check_args(u, r)
    if device == _launch.CPU:
        return ref.per_client_sign_align(u, r)
    if device == _launch.META:
        return meta.per_client_sign_align(u, r)
    return _count_clients(device, u, r)


def _count_clients(device: int, u: torch.Tensor, r: torch.Tensor,
                   int64: bool = False) -> torch.Tensor:
    """One launch of the count: the (C,) f32 counts or, with ``int64``,
    the (C,) int64 counts before their one conversion (the kernel then
    counts in two chunks at the least and leaves the int32 partials,
    which are added here)."""
    pu = _launch.aligned_pointer("per_client_sign_align", u)
    pr = _launch.aligned_pointer("per_client_sign_align", r)
    C, R, _ = u.shape
    counts = None if int64 else u.new_empty(C)
    k, pp, partials = _workspace(u, C, R * LANE, 2 if int64 else 1)
    _launch.entries["per_client_sign_align"](
        pu, pr, 0 if int64 else counts.data_ptr(), pp, C,
        C if r.dim() == 2 else C // r.shape[0], R * LANE, k,
        _launch.stream(device))
    launches["per_client_sign_align"] += 1
    if int64:
        return partials.view(C, k).sum(dim=1, dtype=torch.int64)
    return counts


def check_count_args(g: torch.Tensor, r: torch.Tensor) -> int:
    """Refuse what neither version of ``sign_align_counts`` takes;
    ``_launch.device_index``'s answer for the tensors' device."""
    if g.dim() != 2 or g.shape[1] != LANE or g.shape[0] < 1:
        raise ValueError(f"g must be (R >= 1, {LANE}); got {tuple(g.shape)}")
    if tuple(r.shape) != tuple(g.shape):
        raise ValueError(f"r must be {tuple(g.shape)}; got {tuple(r.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16) or r.dtype != torch.int8:
        raise TypeError(f"expected g float32 or bfloat16 and r int8; got "
                        f"{g.dtype}, {r.dtype}")
    return _launch.device_index("sign_align_counts", g, r)


def sign_align_counts(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    if dist.is_dtensor(g, r):
        from repro_torch.kernels import sharded
        return sharded.sign_align_counts(g, r)
    device = check_count_args(g, r)
    if device == _launch.CPU:
        return ref.sign_align_counts(g, r)
    if device == _launch.META:
        return meta.sign_align_counts(g, r)
    return _count_one(device, g, r)


def _count_one(device: int, g: torch.Tensor, r: torch.Tensor,
               int64: bool = False) -> torch.Tensor:
    """One launch of the count: the 0-dim f32 count or, with ``int64``,
    the 0-dim int64 count before its conversion (as ``_count_clients``)."""
    pg = _launch.aligned_pointer("sign_align_counts", g)
    pr = _launch.aligned_pointer("sign_align_counts", r)
    count = None if int64 else g.new_empty((), dtype=torch.float32)
    k, pp, partials = _workspace(g, 1, g.numel(), 2 if int64 else 1)
    _launch.entries["sign_align_counts"](
        pg, int(g.dtype == torch.bfloat16), pr,
        0 if int64 else count.data_ptr(), pp, g.numel(), k,
        _launch.stream(device))
    launches["sign_align_counts"] += 1
    if int64:
        return partials.sum(dtype=torch.int64)
    return count
