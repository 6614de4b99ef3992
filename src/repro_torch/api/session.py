"""ExperimentSession — the resumable, streaming experiment driver.

``run_experiment`` is a one-shot call; repeated runs, the Mann-Whitney
validation of the paper and any long-lived deployment need a driver: open
an experiment, advance it round by round, observe records as they
happen, checkpoint mid-flight, resume.

    session = ExperimentSession.open(spec)          # on the card
    for record in session.stream(spec.rounds):      # RoundRecord stream
        print(record.round, record.accuracy)
    session.checkpoint("run.ckpt")                  # full engine state
    ...
    session = ExperimentSession.restore("run.ckpt")
    session.run(10)                                 # continues exactly

``open`` and ``restore`` take the port's keyword arguments and hand them
to the engine: ``device`` (the card unless named), ``params``, ``draws``,
``world_source`` and, on the spmd engine, ``agg_dtype``.

Resume equal by bits: a checkpoint holds the whole state of the engine
(``FederatedSimulation.state_dict`` / ``SpmdDriver.state_dict``):
parameters, optimizer state, the control state, every numpy Generator
position and the scanned path's carry, all as CPU tensors. A restored
session's later records and final parameters equal an uninterrupted run's
by bits, on every path, ``rounds_per_dispatch > 1`` included. The device
is not part of the trajectory's identity: a checkpoint written on the
card restores with ``device="cpu"`` (its rounds then agree to the card's
by ``api/parity.py``'s rules, not by bits). Checkpoints do not store
training data; worlds rebuild from the spec's seed. Restoring onto a spec
whose trajectory fields differ raises :class:`CheckpointMismatchError`
naming them. Under ``eval_every > 1`` each ``run()`` evaluates its own
final round (so ``result.final`` is always measured): a checkpoint
boundary adds one accuracy sample at the boundary round, and nothing else
changes; ``stream()`` adds none.

Checkpoints are pickles with a JSON sidecar (``<ckpt>.meta.json``) that
carries the payload's SHA-256, checked before anything is unpickled, and
the mark ``"package": "repro_torch"``. A JAX package's session checkpoint
lacks the mark and is refused before unpickling (its pickle would import
``repro``, and with it JAX): carry its engine state across with
``repro_torch.convert.sim_state_from_jax`` or ``spmd_state_from_jax``.

Callbacks: ``session.add_callback(fn)`` registers ``fn(record)``; return
``False`` (or call ``session.request_stop()``) to stop the run early.
``run(n)`` computes its rounds as one engine batch (callbacks observe the
records afterwards, an early stop takes effect at the batch's end), while
``stream(n)`` computes dispatch-sized chunks and reacts between them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from repro_torch import faults
from repro_torch.api import runner as runner_mod
from repro_torch.api.result import ExperimentResult, RoundRecord
from repro_torch.api.spec import ExperimentSpec
from repro_torch.checkpoint.io import CheckpointCorruptError

CHECKPOINT_FORMAT = 1
PACKAGE = "repro_torch"       # the sidecar's mark of a port checkpoint

# spec fields that identify a trajectory: a checkpoint refuses to restore
# onto a spec that changes any of these (see _spec_fingerprint). ``rounds``
# is not one of them: the round budget is a session argument, and
# extending a restored run is what sessions are for. Nor is the device.
_FINGERPRINT_DOC = ("engine", "model", "strategy", "schedule", "scenario",
                    "topology", "data", "world", "comm", "seed",
                    "eval_every", "megastep", "rounds_per_dispatch",
                    "fused_eval", "optimizer", "lr_schedule", "eval_fn")


def sidecar_path(ckpt_path: str) -> str:
    """The JSON metadata file written next to every session checkpoint
    (``<ckpt>.meta.json``): fingerprint, round counter, wall time,
    digest, package mark, readable without unpickling the checkpoint."""
    return ckpt_path + ".meta.json"


def read_sidecar(ckpt_path: str) -> Dict[str, Any]:
    """The checkpoint's sidecar metadata dict. Raises FileNotFoundError
    when the checkpoint has none (re-write it with ``checkpoint()``)."""
    path = sidecar_path(ckpt_path)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no sidecar metadata at {path}: the checkpoint was moved "
            "without it; re-write it via ExperimentSession.checkpoint(), "
            "which emits both files")
    with open(path) as f:
        return json.load(f)


def _refuse_foreign(path: str, meta: Dict[str, Any]) -> None:
    if meta.get("package") != PACKAGE:
        raise ValueError(
            f"{path!r} is not a repro_torch session checkpoint (its sidecar "
            f"has package={meta.get('package')!r}, not {PACKAGE!r}); a JAX "
            "package checkpoint would import repro and JAX when unpickled. "
            "Carry its engine state across with "
            "repro_torch.convert.sim_state_from_jax (or "
            "spmd_state_from_jax) and load_state_dict instead")


def _read_verified_payload(path: str) -> Dict[str, Any]:
    """Read a session checkpoint, checking its sidecar's package mark and
    content digest before unpickling: a truncated file, a flipped bit, a
    stripped sidecar or a stale digest raises
    :class:`~repro_torch.checkpoint.io.CheckpointCorruptError` naming the
    path, and a checkpoint of another package raises ValueError; pickle
    never sees untrusted bytes."""
    faults.check_active("ckpt_read")
    with open(path, "rb") as f:
        blob = f.read()
    sc = sidecar_path(path)
    if not os.path.exists(sc):
        raise CheckpointCorruptError(
            path, f"missing sidecar {sc!r}: cannot verify integrity "
                  "(re-write via ExperimentSession.checkpoint(), which "
                  "emits both files)")
    try:
        with open(sc) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            path, f"unreadable sidecar {sc!r} "
                  f"({type(e).__name__}: {e})") from e
    _refuse_foreign(path, meta)
    want = meta.get("sha256")
    got = hashlib.sha256(blob).hexdigest()
    if got != want:
        raise CheckpointCorruptError(
            path, f"content digest mismatch (sidecar sha256 {want!r} "
                  f"!= computed {got!r})")
    try:
        payload = pickle.loads(blob)
    except Exception as e:
        raise CheckpointCorruptError(
            path, f"undecodable payload ({type(e).__name__}: {e})") from e
    if not isinstance(payload, dict):
        raise CheckpointCorruptError(
            path, f"payload decodes to {type(payload).__name__}, "
                  "not a checkpoint dict")
    return payload


def latest_good_checkpoint(directory: str,
                           exclude=()) -> Optional[str]:
    """Newest digest-verified port session checkpoint in ``directory``:
    ``*.ckpt`` files ranked by their sidecar's ``written_at`` (newest
    first), skipping ``exclude``, other packages' checkpoints and anything
    whose digest (or unpickling) fails. The recovery source behind
    ``ExperimentSession.restore(..., fallback=True)``."""
    excl = {os.path.abspath(p) for p in exclude}
    cands = []
    try:
        names = os.listdir(directory or ".")
    except OSError:
        return None
    for name in names:
        if not name.endswith(".ckpt"):
            continue
        p = os.path.join(directory or ".", name)
        if os.path.abspath(p) in excl:
            continue
        try:
            meta = read_sidecar(p)
        except (OSError, ValueError):
            continue
        if meta.get("package") != PACKAGE:
            continue
        cands.append((float(meta.get("written_at", 0.0)), p))
    for _t, p in sorted(cands, reverse=True):
        try:
            _read_verified_payload(p)
            return p
        except (CheckpointCorruptError, OSError, faults.InjectedFault):
            continue
    return None


class CheckpointMismatchError(ValueError):
    """Restoring a checkpoint onto a spec describing a different
    trajectory. ``.mismatches`` maps field -> (checkpoint, requested)."""

    def __init__(self, mismatches: Dict[str, tuple]):
        self.mismatches = dict(mismatches)
        detail = "; ".join(f"{k}: checkpoint={a!r} vs spec={b!r}"
                           for k, (a, b) in self.mismatches.items())
        super().__init__(
            "checkpoint does not match the spec it is being restored "
            f"onto — differing fields: {detail}")


def _spec_fingerprint(spec: ExperimentSpec) -> Dict[str, Any]:
    """Plain-data identity of the trajectory a spec describes, with the
    JAX package's fields.

    Callables (data factory, eval_fn, lr_schedule, optimizer objects)
    cannot be compared across processes: they contribute a presence or
    type marker only, never a repr with a memory address."""
    def _marker(obj):
        if obj is None or isinstance(obj, str):
            return obj
        return type(obj).__name__        # stable across processes

    cfg = spec.resolve_model()
    data = dataclasses.asdict(spec.data)
    data["factory"] = spec.data.factory is not None   # presence only
    scenario = spec.resolve_scenario()
    topology = spec.resolve_topology()
    return {
        "engine": spec.engine,
        "model": getattr(cfg, "name", str(spec.model)),
        "strategy": dataclasses.asdict(spec.resolve_strategy()),
        "schedule": dataclasses.asdict(spec.resolve_schedule()),
        "scenario": (None if scenario is None
                     else dataclasses.asdict(scenario)),
        "topology": (None if topology is None
                     else dataclasses.asdict(topology)),
        "data": data,
        "world": dataclasses.asdict(spec.world),
        "comm": dataclasses.asdict(spec.resolve_comm()),
        "seed": spec.seed,
        "eval_every": spec.eval_every,
        "megastep": spec.megastep,
        "rounds_per_dispatch": spec.rounds_per_dispatch,
        "fused_eval": spec.fused_eval,
        "optimizer": _marker(spec.optimizer),
        "lr_schedule": spec.lr_schedule is not None,
        "eval_fn": spec.eval_fn is not None,
    }


class _SimDriver:
    """Session driver of engine='sim': wraps ``FederatedSimulation``."""

    engine = "sim"

    def __init__(self, spec: ExperimentSpec, **engine_kw):
        self.spec = spec
        self.sim = runner_mod.build_simulation(spec, **engine_kw)

    def run_rounds(self, n: int, eval_final: bool = True
                   ) -> List[RoundRecord]:
        prev = len(self.sim.history)
        self.sim.run(n, eval_final=eval_final)
        return [runner_mod.record_from_metrics(m)
                for m in self.sim.history[prev:]]

    def state_dict(self) -> dict:
        return self.sim.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.sim.load_state_dict(state)

    def client_pass_rates(self):
        return self.sim.client_pass_rates()

    def result(self, records, wall_time: float = 0.0) -> ExperimentResult:
        return ExperimentResult(
            engine="sim", strategy=self.spec.strategy_name(),
            rounds=len(records), seed=self.spec.seed,
            records=list(records), cfg=self.sim.cfg,
            params=self.sim.params, eval_arrays=self.sim.eval_arrays,
            num_clients=self.sim.num_clients,
            param_bytes=self.sim.param_bytes, wall_time=wall_time)


def _build_driver(spec: ExperimentSpec, agg_dtype, engine_kw):
    if spec.engine == "sim":
        if agg_dtype is not None:
            raise ValueError("agg_dtype is the spmd engine's plain "
                             "aggregation precision; engine='sim' has none")
        return _SimDriver(spec, **engine_kw)
    if agg_dtype is not None:
        engine_kw = dict(engine_kw, agg_dtype=agg_dtype)
    return runner_mod.SpmdDriver(spec, **engine_kw)


class ExperimentSession:
    """Open with :meth:`open` or :meth:`restore`, not the constructor."""

    def __init__(self, spec: ExperimentSpec, driver):
        self.spec = spec
        self._driver = driver
        self.records: List[RoundRecord] = []
        self.callbacks: List[Callable[[RoundRecord], Any]] = []
        self._stopped = False
        self._wall = 0.0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def open(cls, spec: ExperimentSpec, *, device=None, params=None,
             draws=None, world_source=None,
             agg_dtype=None) -> "ExperimentSession":
        """A new session of ``spec``; the keywords go to the engine
        (``runner.build_simulation`` / ``runner.SpmdDriver``)."""
        spec.validate()
        t0 = time.time()
        driver = _build_driver(spec, agg_dtype, dict(
            device=device, params=params, draws=draws,
            world_source=world_source))
        session = cls(spec, driver)
        session._wall += time.time() - t0
        return session

    @classmethod
    def restore(cls, path: str,
                spec: Optional[ExperimentSpec] = None, *,
                fallback: bool = False, device=None, params=None,
                draws=None, world_source=None,
                agg_dtype=None) -> "ExperimentSession":
        """Rebuild a session from :meth:`checkpoint` output, on ``device``
        (the card unless named), and continue from it. ``spec`` is needed
        only when the checkpointed spec held unpicklable callables
        (eval_fn, data factory, lr_schedule); when given, it must describe
        the same trajectory.

        The payload's content digest (sidecar ``sha256``) is checked
        before unpickling: a corrupt artifact raises
        :class:`~repro_torch.checkpoint.io.CheckpointCorruptError`.
        ``fallback=True`` degrades to the newest digest-verified ``*.ckpt``
        in the same directory (:func:`latest_good_checkpoint`); only when
        none survives does the original error surface. A checkpoint of
        the JAX package raises ValueError before unpickling."""
        try:
            payload = _read_verified_payload(path)
        except (CheckpointCorruptError, OSError, faults.InjectedFault):
            if not fallback:
                raise
            good = latest_good_checkpoint(os.path.dirname(path),
                                          exclude=(path,))
            if good is None:
                raise
            payload = _read_verified_payload(good)
        if payload.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(
                f"unknown session checkpoint format "
                f"{payload.get('format')!r} (expected {CHECKPOINT_FORMAT})")
        if spec is None:
            spec = payload["spec"]
            if spec is None:
                raise ValueError(
                    "this checkpoint does not embed its spec (it held "
                    "unpicklable callables); pass the original spec: "
                    "ExperimentSession.restore(path, spec=...)")
        theirs, ours = payload["fingerprint"], _spec_fingerprint(spec)
        mismatches = {k: (theirs.get(k), ours.get(k))
                      for k in sorted(set(theirs) | set(ours))
                      if theirs.get(k) != ours.get(k)}
        if mismatches:
            raise CheckpointMismatchError(mismatches)
        session = cls.open(spec, device=device, params=params, draws=draws,
                           world_source=world_source, agg_dtype=agg_dtype)
        session._driver.load_state_dict(payload["driver"])
        session.records = [RoundRecord(**r) for r in payload["records"]]
        session._wall = payload["wall_time"]
        return session

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    @property
    def rounds_done(self) -> int:
        return len(self.records)

    @property
    def stopped(self) -> bool:
        return self._stopped

    @property
    def engine(self):
        """The engine under the session: the ``FederatedSimulation``
        (engine='sim') or the ``SpmdDriver``."""
        return getattr(self._driver, "sim", self._driver)

    def request_stop(self) -> None:
        """Ask the session to stop after the current round or chunk;
        callable from inside a callback (the early-stop hook)."""
        self._stopped = True

    def add_callback(self, fn: Callable[[RoundRecord], Any]) -> None:
        """Register ``fn(record)``, fired for every new RoundRecord in
        order; returning ``False`` requests an early stop."""
        self.callbacks.append(fn)

    def _fire(self, records: List[RoundRecord]) -> None:
        for rec in records:
            for cb in self.callbacks:
                if cb(rec) is False:
                    self._stopped = True

    def _remaining(self, rounds: Optional[int]) -> int:
        if rounds is not None:
            return max(0, int(rounds))
        return max(0, self.spec.rounds - self.rounds_done)

    def run(self, rounds: Optional[int] = None) -> List[RoundRecord]:
        """Advance ``rounds`` more rounds (default: the spec's remaining
        budget) as one engine batch and return their records."""
        n = self._remaining(rounds)
        if n == 0 or self._stopped:
            return []
        t0 = time.time()
        new = self._driver.run_rounds(n)
        self._wall += time.time() - t0
        self.records.extend(new)
        self._fire(new)
        return new

    def stream(self, rounds: Optional[int] = None) -> Iterator[RoundRecord]:
        """Yield records as they are produced. The chunk is the engine's
        dispatch (``rounds_per_dispatch`` on the scanned path, else one
        round); an early stop takes effect between chunks. The
        ``eval_every`` cadence is absolute, and only the last round of the
        whole stream gets the end-of-run evaluation: the accuracy series
        equals a single ``run(n)``'s."""
        n = self._remaining(rounds)
        chunk = self.spec.rounds_per_dispatch or 1
        done = 0
        while done < n and not self._stopped:
            step = min(chunk, n - done)
            t0 = time.time()
            new = self._driver.run_rounds(step,
                                          eval_final=(done + step >= n))
            self._wall += time.time() - t0
            self.records.extend(new)
            done += len(new)
            self._fire(new)
            yield from new

    def __iter__(self) -> Iterator[RoundRecord]:
        return self.stream()

    def result(self) -> ExperimentResult:
        """The normalized ExperimentResult over everything run so far."""
        return self._driver.result(self.records, wall_time=self._wall)

    def client_pass_rates(self):
        """(num_clients,) θ pass-rate EMAs the server's control plane has
        learned so far (raises on the spmd engine when its control plane
        is inactive)."""
        return self._driver.client_pass_rates()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def checkpoint(self, path: str) -> str:
        """Serialize the whole session to ``path`` (an atomic write) and
        its sidecar (:func:`sidecar_path`: fingerprint, absolute round
        counter, wall time, digest, package mark). The training data is
        not stored: worlds rebuild from the seed. Every tensor in the
        payload is a CPU tensor."""
        fingerprint = _spec_fingerprint(self.spec)
        try:
            pickle.dumps(self.spec)
            spec_blob = self.spec
        except (pickle.PicklingError, AttributeError, TypeError):
            spec_blob = None          # unpicklable callables in the spec
        payload = {
            "format": CHECKPOINT_FORMAT,
            "fingerprint": fingerprint,
            "spec": spec_blob,
            "records": [dataclasses.asdict(r) for r in self.records],
            "wall_time": self._wall,
            "driver": self._driver.state_dict(),
        }
        blob = pickle.dumps(payload)
        # checked before any byte lands: an injected write error never
        # damages the artifact (or sidecar) already at ``path``
        faults.check_active("ckpt_write")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)   # a crash never corrupts the checkpoint
        meta = {
            "format": CHECKPOINT_FORMAT,
            "package": PACKAGE,
            "model": fingerprint["model"],
            "engine": fingerprint["engine"],
            "seed": fingerprint["seed"],
            "rounds_done": self.rounds_done,
            "wall_time": self._wall,
            "written_at": time.time(),
            # restore() checks this digest of the payload's bytes before
            # unpickling (CheckpointCorruptError otherwise)
            "sha256": hashlib.sha256(blob).hexdigest(),
            "payload_bytes": len(blob),
            # provenance, not an equality oracle (tuples become lists):
            # restore() compares the payload's own fingerprint
            "fingerprint": fingerprint,
        }
        mtmp = sidecar_path(path) + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f, indent=2, default=str)
            f.write("\n")
        os.replace(mtmp, sidecar_path(path))
        return path
