"""Tree checkpoint I/O: msgpack with raw little-endian buffers, format v2.

The file is the JAX package's (``repro/checkpoint/io.py``), field for
field: an envelope ``{"format": 2, "sha256": ..., "body": ...}`` whose
body packs ``{"treedef": ..., "leaves": [{"dtype", "shape", "data"}]}``.
So a file written by either package restores into the other:

  * Leaves go in the JAX package's leaf order: dict keys sorted,
    NamedTuples by field, lists and tuples in order, ``None`` holding no
    leaf. ``restore`` rebuilds ``like``'s structure; the ``treedef``
    string is informational only, as in the JAX package.
  * ``bfloat16`` leaves need no ``ml_dtypes``: a bf16 tensor is written
    as its raw 16-bit words under the dtype name ``"bfloat16"``, and such
    a leaf is read back as those words viewed as ``torch.bfloat16``.
  * ``msgpack`` is imported inside ``save`` / ``restore`` / ``verify``,
    never when the package is imported, so sessions (which pickle) run
    where msgpack is not installed.

Integrity: the envelope carries a SHA-256 digest of the packed body;
``restore`` checks it before decoding the body, so a truncated file, a
flipped bit or msgpack garbage raises :class:`CheckpointCorruptError`
naming the path. ``verify`` is the non-raising probe behind
``CheckpointManager.latest_good()``. A legacy v1 file (a bare body,
no digest) still restores.

Fault injection: ``save`` / ``restore`` consult the port's ambient
``repro_torch.faults`` injector (sites ``ckpt_write`` / ``ckpt_read``).
An injected write fault fires before the atomic rename, so the
checkpoint already at ``path`` is never damaged by a failed save.
"""
from __future__ import annotations

import hashlib
import os
from typing import Iterator, List

import numpy as np
import torch

from repro_torch import faults

IO_FORMAT = 2


class CheckpointCorruptError(OSError):
    """A checkpoint that cannot be trusted: truncated, bit-flipped,
    unparseable, or failing its content digest. ``.path`` names the
    offending artifact."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"corrupt checkpoint {path!r}: {reason}")


def _children(node) -> list:
    """A container's children in the JAX package's leaf order."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def _is_container(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def flatten(tree) -> List[object]:
    """The leaves of ``tree`` in the JAX package's order (``None`` holds
    none)."""
    if tree is None:
        return []
    if _is_container(tree):
        return [leaf for c in _children(tree) for leaf in flatten(c)]
    return [tree]


def _unflatten(like, leaves: Iterator):
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(c, leaves) for c in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(c, leaves) for c in like)
    return next(leaves)


def _treedef(tree) -> str:
    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return f"{type(node).__name__}(" + ", ".join(
                f"{f}={walk(c)}" for f, c in zip(node._fields, node)) + ")"
        if isinstance(node, list):
            return "[" + ", ".join(walk(c) for c in node) + "]"
        if isinstance(node, tuple):
            return "(" + ", ".join(walk(c) for c in node) + ")"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _leaf_record(leaf) -> dict:
    """dtype name, shape and raw bytes of one leaf (a tensor on any device,
    a numpy array or a scalar)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": np.ascontiguousarray(a).tobytes()}


def _leaf_tensor(blob: dict) -> torch.Tensor:
    """One leaf record as a CPU tensor of its saved dtype."""
    if blob["dtype"] == "bfloat16":
        words = np.frombuffer(blob["data"], dtype=np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16).reshape(
            blob["shape"])
    arr = np.frombuffer(blob["data"], dtype=np.dtype(blob["dtype"]))
    return torch.from_numpy(arr.reshape(blob["shape"]).copy())


def _pack_body(tree) -> bytes:
    import msgpack
    return msgpack.packb({"treedef": _treedef(tree),
                          "leaves": [_leaf_record(l) for l in flatten(tree)]},
                         use_bin_type=True)


def save(path: str, tree) -> None:
    import msgpack
    body = _pack_body(tree)
    envelope = msgpack.packb({
        "format": IO_FORMAT,
        "sha256": hashlib.sha256(body).hexdigest(),
        "body": body,
    }, use_bin_type=True)
    faults.check_active("ckpt_write")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(envelope)
    os.replace(tmp, path)  # atomic: a crash never corrupts the checkpoint


def _read_payload(path: str) -> dict:
    """Read and digest-verify ``path`` down to the body's payload dict."""
    import msgpack
    faults.check_active("ckpt_read")
    with open(path, "rb") as f:
        raw = f.read()
    try:
        outer = msgpack.unpackb(raw, raw=False)
    except Exception as e:
        raise CheckpointCorruptError(
            path, f"unparseable msgpack ({type(e).__name__}: {e})") from e
    if isinstance(outer, dict) and "body" in outer:        # format v2
        body = outer["body"]
        want = outer.get("sha256")
        got = hashlib.sha256(body).hexdigest()
        if want != got:
            raise CheckpointCorruptError(
                path, f"content digest mismatch (sidecar sha256 {want!r} "
                      f"!= computed {got!r})")
        try:
            payload = msgpack.unpackb(body, raw=False)
        except Exception as e:
            raise CheckpointCorruptError(
                path, f"digest ok but body unparseable "
                      f"({type(e).__name__}: {e})") from e
    elif isinstance(outer, dict) and "leaves" in outer:    # legacy v1
        payload = outer
    else:
        raise CheckpointCorruptError(
            path, "not a checkpoint envelope (no body/leaves)")
    return payload


def verify(path: str) -> bool:
    """True iff ``path`` exists and its content digest checks out (or, for
    a legacy pre-digest checkpoint, it parses cleanly). Never raises."""
    if not os.path.exists(path):
        return False
    try:
        _read_payload(path)
        return True
    except (CheckpointCorruptError, OSError, faults.InjectedFault):
        return False


def restore(path: str, like):
    """Restore into the structure of ``like`` (shapes must match). Each
    leaf comes back as a tensor of its saved dtype, on the device of
    ``like``'s leaf where that is a tensor, else on the CPU. Raises
    :class:`CheckpointCorruptError` on any untrusted artifact."""
    payload = _read_payload(path)
    refs = flatten(like)
    blobs = payload["leaves"]
    if len(blobs) != len(refs):
        raise ValueError(f"checkpoint has {len(blobs)} leaves, "
                         f"expected {len(refs)}")
    leaves = []
    for blob, ref in zip(blobs, refs):
        t = _leaf_tensor(blob)
        want = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(t.shape) != want:
            raise ValueError(f"shape mismatch {tuple(t.shape)} vs {want}")
        leaves.append(t.to(ref.device) if torch.is_tensor(ref) else t)
    return _unflatten(like, iter(leaves))
