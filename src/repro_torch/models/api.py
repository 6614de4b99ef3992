"""Model API: family dispatch.

Every family exposes ``init_params(generator, cfg, device)`` and
``loss_fn(params, batch, cfg)``; the language models (the transformer's
dense, moe and vlm families, rwkv6's ssm, hymba's hybrid and whisper's
audio) also ``prefill(params, batch, cfg) -> (logits, cache)``,
``decode_step(params, cache, batch, cfg) -> (logits, cache)`` and
``init_cache(cfg, batch, seq)``.

``input_specs`` builds meta tensors, the port's ``ShapeDtypeStruct``, for
every input of a (config × shape × step kind): the JAX package's keys,
shapes and dtypes, no allocation; the dry run (``launch/dryrun.py``)
traces the steps on them.
"""
from __future__ import annotations

import torch

from repro_torch.models import (hybrid, layers, mlp_detector, rwkv6,
                                transformer, whisper)

_FAMILY = {"mlp": mlp_detector, "dense": transformer, "moe": transformer,
           "vlm": transformer, "ssm": rwkv6, "hybrid": hybrid,
           "audio": whisper}


def module_for(cfg):
    return _FAMILY[cfg.family]


def init_params(generator, cfg, device="cpu"):
    """The family's random weights from ``generator``; on the meta device
    their shapes and dtypes only (``layers.MetaDraws``), whatever the
    generator."""
    if torch.device(device).type == "meta":
        generator = layers.MetaDraws()
    return module_for(cfg).init_params(generator, cfg, device)


def loss_fn(params, batch, cfg):
    return module_for(cfg).loss_fn(params, batch, cfg)


def _lm(cfg):
    mod = module_for(cfg)
    if cfg.family == "mlp":
        raise NotImplementedError(
            "the anomaly-mlp family has no prefill or decode (in either "
            "package); it is served by repro_torch.serve (ServeEngine)")
    return mod


def prefill(params, batch, cfg):
    return _lm(cfg).prefill(params, batch, cfg)


def decode_step(params, cache, batch, cfg):
    return _lm(cfg).decode_step(params, cache, batch, cfg)


def init_cache(cfg, batch_size: int, seq_len: int, device=None):
    return _lm(cfg).init_cache(cfg, batch_size, seq_len, device=device)


def build_default_eval(cfg):
    """ev(params, batch) -> scalar quality metric: classification accuracy
    for the mlp detector family, the negative loss (a quality proxy) for
    the language models, as in the JAX package."""
    mod = module_for(cfg)

    @torch.no_grad()
    def ev(params, batch):
        if cfg.family == "mlp":
            return mod.accuracy(params, batch, cfg)
        return -mod.loss_fn(params, batch, cfg)

    return ev


# ---------------------------------------------------------------------------
# input specs: meta tensors, the port's ShapeDtypeStruct (no allocation)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch(cfg, lead: tuple, seq: int) -> dict:
    """Token and label specs with the modality's extras; ``lead`` the
    leading dims (the JAX package's ``models/api.py::_token_batch``)."""
    toks = seq
    batch = {}
    if cfg.family == "vlm":
        toks = max(seq - cfg.num_patches, 1)
        batch["patch_embeds"] = _spec(lead + (cfg.num_patches, cfg.d_model),
                                      cfg.compute_dtype)
    if cfg.family == "audio":
        batch["enc_embeds"] = _spec(lead + (cfg.encoder_seq, cfg.d_model),
                                    cfg.compute_dtype)
    batch["tokens"] = _spec(lead + (toks,), torch.int32)
    batch["labels"] = _spec(lead + (toks,), torch.int32)
    return batch


def train_input_specs(cfg, shape, num_clients: int) -> dict:
    """Per-client-batched training inputs: leading dim ``num_clients``."""
    per_client = max(shape.global_batch // num_clients, 1)
    if cfg.family == "mlp":
        return {"x": _spec((num_clients, per_client, cfg.num_features),
                           torch.float32),
                "y": _spec((num_clients, per_client), torch.int32)}
    return _token_batch(cfg, (num_clients, per_client), shape.seq_len)


def prefill_input_specs(cfg, shape) -> dict:
    if cfg.family == "mlp":
        return {"x": _spec((shape.global_batch, cfg.num_features),
                           torch.float32)}
    batch = _token_batch(cfg, (shape.global_batch,), shape.seq_len)
    batch.pop("labels")
    return batch


def decode_input_specs(cfg, shape) -> tuple:
    """(batch, cache) specs for a single-token serve step; the cache is
    ``init_cache`` on the meta device."""
    batch = {"tokens": _spec((shape.global_batch, 1), torch.int32)}
    return batch, init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")


def input_specs(cfg, shape, num_clients: int = 1) -> dict:
    """The step's inputs for ``shape.kind`` as meta tensors, with the JAX
    package's keys, shapes and dtypes (``models/api.py::input_specs``)."""
    if shape.kind == "train":
        return {"batch": train_input_specs(cfg, shape, num_clients)}
    if shape.kind == "prefill":
        return {"batch": prefill_input_specs(cfg, shape)}
    batch, cache = decode_input_specs(cfg, shape)
    return {"batch": batch, "cache": cache}
