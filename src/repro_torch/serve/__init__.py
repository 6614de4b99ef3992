"""repro_torch.serve — continuous-federation serving for the global
detector, on the card unless the caller names another device.

The serving layer that closes the paper's loop: train a global model
(``repro_torch.api``), serve it as a batched streaming scorer
(:class:`ServeEngine`), watch live traffic for distribution shift
(:class:`DriftMonitor`, reusing ``core/scenario.py``'s drift machinery
as the detector), and when shift persists, re-federate and hot-swap the
refreshed checkpoint in without dropping a request (:class:`Refederator`
+ :class:`ModelSlot`). The slot's device is where the engine scores:

    slot = ModelSlot(params, model="anomaly-mlp", device="cpu")
    engine = ServeEngine(slot, cfg, max_batch=256)
    engine.submit_many(flows)
    responses = engine.drain()
"""
from repro_torch.serve.engine import (QueueFullError, Response, ServeEngine,
                                      ServeStats)
from repro_torch.serve.federate import (BREAKER_CLOSED, BREAKER_HALF_OPEN,
                                        BREAKER_OPEN, Refederator)
from repro_torch.serve.health import HealthSnapshot
from repro_torch.serve.health import snapshot as health_snapshot
from repro_torch.serve.monitor import DriftMonitor
from repro_torch.serve.swap import (ModelSlot, ModelVersion, ServeModelError,
                                    StaleCheckpointError)

__all__ = [
    "ServeEngine", "Response", "ServeStats", "QueueFullError",
    "ModelSlot", "ModelVersion", "ServeModelError", "StaleCheckpointError",
    "DriftMonitor", "Refederator",
    "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN",
    "HealthSnapshot", "health_snapshot",
]
