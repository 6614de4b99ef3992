"""Model hot-swap: double-buffered parameters with an atomic flip.

The serving engine must never score a half-written model and never drop
a request because a new global model arrived. A :class:`ModelSlot` holds
the ACTIVE parameters (what every in-flight batch scores against) and at
most one STAGED set published by a background re-federation; the engine
calls :meth:`acquire` at each micro-batch boundary, which atomically
flips staged -> active under a lock and returns a consistent
(params, version) pair. Requests queued across a publish are simply
scored by whichever model is active when their batch runs — none are
dropped, and every response is stamped with the model version that
scored it.

Copy on publish: torch tensors are mutable, and the megastep path's
``sim.params`` are views into its arena, which a later round updates in
place. So the slot never holds a caller's tensor: :class:`ModelSlot` and
:meth:`ModelSlot.publish` copy every leaf (``detach``, then a copy onto
the slot's device) before they take the lock. The copy is enqueued on the
publishing thread's current stream, PyTorch's default stream unless the
caller chose another, so it is ordered before any later scoring launch on
that stream.

Checkpoint provenance: :meth:`publish_checkpoint` ingests an
``ExperimentSession.checkpoint()`` artifact, validating its JSON sidecar
(``api/session.py: sidecar_path``) BEFORE paying for the restore —
a checkpoint of another package (the JAX package's) raises ValueError, a
checkpoint trained for a different model raises :class:`ServeModelError`
and one whose round counter has not advanced past the active model
raises :class:`StaleCheckpointError`, instead of silently serving a
wrong or outdated detector.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.api import session as session_mod
from repro_torch.checkpoint.io import CheckpointCorruptError
from repro_torch.device import resolve_device


class ServeModelError(ValueError):
    """A checkpoint that must not be served: wrong model architecture /
    fingerprint for this slot."""


class StaleCheckpointError(ValueError):
    """A checkpoint whose round counter has not advanced beyond the
    model already being served — publishing it would roll the detector
    back. Pass ``allow_stale=True`` to force (e.g. explicit rollback)."""


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """Provenance stamped on every response that a model scores."""
    version: int                  # monotone flip counter (0 = initial)
    round_idx: int                # federation rounds behind the params
    model: Optional[str] = None   # config name from the sidecar
    source: str = "init"          # "init" | "publish" | checkpoint path


def _copy_to(params: Any, device: torch.device) -> Any:
    """A copy of a parameter tree (dicts of tensors or numpy arrays) on
    ``device`` that shares no storage with ``params``; f64 leaves become
    f32, as the JAX package's ``jnp.asarray`` makes them."""
    if isinstance(params, dict):
        return {k: _copy_to(v, device) for k, v in params.items()}
    t = params if torch.is_tensor(params) else torch.as_tensor(
        np.asarray(params))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.detach().to(device, copy=True)


class ModelSlot:
    """Double-buffered (active, staged) parameter holder on ``device``
    (the card unless named).

    Thread-safe: ``publish*`` may be called from a background
    re-federation thread while the serving thread calls ``acquire``
    between batches. The flip is a pointer swap under a lock — O(1),
    no copies — so swap churn never stalls the scoring loop.
    """

    def __init__(self, params: Any, *, model: Optional[str] = None,
                 round_idx: int = 0, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._active = _copy_to(params, self.device)
        self._meta = ModelVersion(version=0, round_idx=int(round_idx),
                                  model=model, source="init")
        self._staged: Optional[tuple] = None
        self.swaps = 0                   # completed flips (not publishes)

    # ------------------------------------------------------------------
    @property
    def version(self) -> int:
        with self._lock:
            return self._meta.version

    @property
    def meta(self) -> ModelVersion:
        with self._lock:
            return self._meta

    @property
    def staged_version(self) -> Optional[int]:
        with self._lock:
            return self._staged[1].version if self._staged else None

    def acquire(self) -> tuple:
        """(params, ModelVersion) for the NEXT micro-batch, flipping in
        any staged model first. Called at batch boundaries only, so a
        batch never mixes two models."""
        with self._lock:
            if self._staged is not None:
                self._active, self._meta = self._staged
                self._staged = None
                self.swaps += 1
            return self._active, self._meta

    # ------------------------------------------------------------------
    def publish(self, params: Any, *, round_idx: Optional[int] = None,
                model: Optional[str] = None,
                source: str = "publish") -> ModelVersion:
        """Stage a copy of ``params`` for the next batch boundary. The
        copy onto the slot's device happens OUTSIDE the lock; only the
        pointer swap is serialized. Re-publishing before a flip replaces
        the staged model (last writer wins — the flip always installs
        the newest publish)."""
        dev = _copy_to(params, self.device)
        with self._lock:
            meta = ModelVersion(
                version=max(self._meta.version,
                            self._staged[1].version if self._staged
                            else self._meta.version) + 1,
                round_idx=int(self._meta.round_idx
                              if round_idx is None else round_idx),
                model=model if model is not None else self._meta.model,
                source=source)
            self._staged = (dev, meta)
        return meta

    def publish_checkpoint(self, ckpt_path: str,
                           spec=None, *, expect_model: Optional[str] = None,
                           allow_stale: bool = False,
                           round_base: int = 0,
                           fallback: bool = False,
                           device=None) -> ModelVersion:
        """Validate + load an ``ExperimentSession.checkpoint()`` artifact
        and stage its global parameters.

        Validation order matters: the sidecar is read FIRST (cheap JSON)
        so a foreign, mismatched or stale checkpoint is rejected before
        the full restore pays to rebuild the world. ``expect_model``
        defaults to the slot's current model name (when it has one);
        ``spec`` is forwarded to :meth:`ExperimentSession.restore` for
        checkpoints whose spec held unpicklable callables (e.g. a
        drifted-data factory). ``round_base`` offsets the sidecar's round
        counter — re-federation sessions count rounds from zero, so the
        federator passes the served model's counter to keep versions
        monotone. The restore runs on ``device`` (the slot's unless
        named); a checkpoint written on the card publishes into a CPU
        slot and the reverse.

        ``fallback=True`` recovers from a corrupt or sidecar-less
        artifact by publishing the newest digest-verified ``*.ckpt`` in
        the same directory instead
        (``api/session.py: latest_good_checkpoint``) — the model/
        staleness gates still apply to whatever actually publishes."""
        kw = dict(expect_model=expect_model, allow_stale=allow_stale,
                  round_base=round_base, device=device)
        try:
            return self._publish_checkpoint(ckpt_path, spec, **kw)
        except (CheckpointCorruptError, FileNotFoundError):
            if not fallback:
                raise
            good = session_mod.latest_good_checkpoint(
                os.path.dirname(ckpt_path), exclude=(ckpt_path,))
            if good is None:
                raise
            return self._publish_checkpoint(good, spec, **kw)

    def _publish_checkpoint(self, ckpt_path: str, spec=None, *,
                            expect_model: Optional[str] = None,
                            allow_stale: bool = False,
                            round_base: int = 0,
                            device=None) -> ModelVersion:
        meta = session_mod.read_sidecar(ckpt_path)
        session_mod._refuse_foreign(ckpt_path, meta)
        model = meta.get("model")
        expect = expect_model if expect_model is not None \
            else self.meta.model
        if expect is not None and model != expect:
            raise ServeModelError(
                f"checkpoint {ckpt_path!r} holds model {model!r} but this "
                f"slot serves {expect!r} — refusing to hot-swap a "
                "different architecture")
        rounds_done = int(round_base) + int(meta.get("rounds_done", 0))
        with self._lock:
            newest = self._meta.round_idx
            if self._staged is not None:
                newest = max(newest, self._staged[1].round_idx)
        if rounds_done <= newest and not allow_stale:
            raise StaleCheckpointError(
                f"checkpoint {ckpt_path!r} is at round {rounds_done}, not "
                f"ahead of the served model (round {newest}) — refusing "
                "to roll the detector back (allow_stale=True overrides)")
        session = session_mod.ExperimentSession.restore(
            ckpt_path, spec=spec,
            device=self.device if device is None else device)
        params = session.result().params
        return self.publish(params, round_idx=rounds_done, model=model,
                            source=ckpt_path)
