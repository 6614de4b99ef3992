"""Serving driver, on the card unless the caller names another device:
batched anomaly scoring through the ``repro_torch.serve`` engine (the
paper's detector), or a batched prefill + greedy decode loop for the
language models (every family but the mlp).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch anomaly-mlp \\
      --batch 256 --requests 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch anomaly-mlp \\
      --from-checkpoint run.ckpt
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 2048 --decode-steps 16 --attention-impl blockwise
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --smoke --prompt-len 32 --decode-steps 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --batch 4 --prompt-len 2048 \\
      --decode-steps 16 --attention-impl blockwise
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \\
      --smoke --prompt-len 512 --decode-steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --smoke --prompt-len 32 --decode-steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --batch 4 --prompt-len 512 --decode-steps 16 --attention-impl blockwise

The weights are random, drawn from a ``torch.Generator`` seeded ``seed``
on the serving device (the JAX package serves random weights too); the
prompt comes from ``np.random.default_rng(seed)`` and the flows from
``data.synthetic.make_unsw_like(seed, ...)``, so they are the JAX
package's. A vlm prompt of ``prompt_len`` positions is ``num_patches``
zero patch embeddings followed by ``prompt_len − num_patches`` tokens,
and an audio prompt's ``enc_embeds`` (the stubbed frontend's frames) are
normal draws from the same Generator after the tokens, as the JAX package
builds them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import api


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def graft_cache(full: dict, cache: dict) -> dict:
    """The prefill's ``cache`` carried into ``full`` (an ``init_cache`` of
    the whole decode length), by the JAX package's rule: a leaf of the
    same rank and another shape (a KV cache) is copied into the leading
    slice of ``full``'s, any other (a recurrent state, the encoder's k and
    v, the step) is carried over as it is. Returns ``full``."""
    for name, src in cache.items():
        dst = full.get(name)
        if (torch.is_tensor(src) and torch.is_tensor(dst)
                and dst.dim() == src.dim() and dst.shape != src.shape):
            dst[tuple(slice(0, n) for n in src.shape)] = src.to(dst.dtype)
        else:
            full[name] = src
    return full


@torch.no_grad()
def serve_lm(cfg, batch: int, prompt_len: int, decode_steps: int, seed=0, *,
             device=None, params=None):
    """Prefill a (batch, prompt_len) random prompt, then ``decode_steps``
    greedy tokens; returns the (batch, 1 + decode_steps) tokens (the
    prefill's argmax first). ``params`` replaces the random weights. A
    vlm prompt's ``prompt_len`` counts its patches."""
    dev = resolve_device(device)
    patches = cfg.num_patches if cfg.family == "vlm" else 0
    rng = np.random.default_rng(seed)
    if params is None:
        params = api.init_params(torch.Generator(device=dev).manual_seed(seed),
                                 cfg, dev)
    prompt = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(batch, prompt_len - patches)),
        device=dev)}
    if patches:
        prompt["patch_embeds"] = torch.zeros(
            (batch, patches, cfg.d_model), dtype=cfg.compute_dtype,
            device=dev)
    if cfg.family == "audio":
        prompt["enc_embeds"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)),
            device=dev).to(cfg.compute_dtype)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prompt, cfg)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # pad the cache to prompt_len + decode_steps for the decode loop
    cache = graft_cache(api.init_cache(cfg, batch, prompt_len + decode_steps,
                                       device=dev), cache)
    cache["step"] = prompt_len

    tok = logits[:, -1:].argmax(dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        logits, cache = api.decode_step(params, cache, {"tokens": tok}, cfg)
        tok = logits[:, -1:].argmax(dim=-1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    print(f"prefill: {batch}x{prompt_len} in {t_prefill:.2f}s; "
          f"decode: {decode_steps} steps in {t_decode:.2f}s "
          f"({batch*decode_steps/max(t_decode,1e-9):.1f} tok/s)")
    return torch.cat(out, dim=1)


def serve_anomaly(cfg, batch: int, seed=0, requests: int = 0,
                  checkpoint: str = None, queue_limit: int = None,
                  deadline_ms: float = None, *, device=None):
    """Batched flow scoring via ``repro_torch.serve.ServeEngine`` —
    request queue, power-of-two batch buckets, hot-swappable model slot,
    p50/p99 latency accounting. ``checkpoint`` serves a trained global
    model from an ``ExperimentSession.checkpoint()`` artifact (sidecar-
    validated); otherwise parameters initialize fresh. ``queue_limit``
    and ``deadline_ms`` turn on the engine's admission control; shed /
    expired requests show up in the health line."""
    from repro_torch.data import synthetic
    from repro_torch.serve import ModelSlot, ServeEngine, health_snapshot

    dev = resolve_device(device)
    max_batch = 1 << max(0, int(batch) - 1).bit_length()   # next pow2
    slot = ModelSlot(api.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg, dev),
        model=cfg.name, device=dev)
    if checkpoint:
        slot.publish_checkpoint(checkpoint)
    engine = ServeEngine(slot, cfg, max_batch=max_batch,
                         queue_limit=queue_limit, deadline_ms=deadline_ms)
    n = requests or max_batch * 4
    X, _y = synthetic.make_unsw_like(seed, n, cfg.num_features,
                                     cfg.num_classes)
    responses = []
    for i in range(0, n, max_batch):
        engine.submit_many(X[i:i + max_batch], best_effort=True)
        responses.extend(engine.pump())
    health = health_snapshot(engine)
    stats = engine.shutdown()
    anomaly_rate = float(np.mean(
        [np.argmax(r.probs) != 0 for r in responses])) if responses else 0.0
    version = responses[-1].model_version if responses else 0
    print(f"scored {stats.served} flows in {stats.busy_seconds*1e3:.1f} ms "
          f"({stats.flows_per_sec:.0f} flows/s, p50 {stats.p50_ms:.2f} ms, "
          f"p99 {stats.p99_ms:.2f} ms, model v{version}); "
          f"flagged {anomaly_rate:.1%} as attack classes")
    print(f"health: {health.status} (shed {health.shed}, "
          f"deadline_miss {health.deadline_miss}, "
          f"dispatch_errors {health.dispatch_errors}, "
          f"degraded_mode {health.degraded_mode})")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="anomaly-mlp",
                    choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--attention-impl", choices=("full", "blockwise"),
                    default=None,
                    help="blockwise: the flash kernel on each prefill layer "
                         "(prompt lengths that are multiples of 512)")
    ap.add_argument("--requests", type=int, default=0,
                    help="anomaly serving: total flows to score "
                         "(default 4 batches)")
    ap.add_argument("--from-checkpoint", default=None, metavar="PATH",
                    help="anomaly serving: hot-load the global model "
                         "from an ExperimentSession checkpoint "
                         "(validated against its sidecar metadata)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="anomaly serving: bound the request queue; "
                         "overflow is shed at admission")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="anomaly serving: per-request deadline; expired "
                         "requests answer NaN and count deadline_miss")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    if args.attention_impl:
        cfg = cfg.replace(attention_impl=args.attention_impl)
    if cfg.family == "mlp":
        serve_anomaly(cfg, args.batch, requests=args.requests,
                      checkpoint=args.from_checkpoint,
                      queue_limit=args.queue_limit,
                      deadline_ms=args.deadline_ms, device=args.device)
    else:
        serve_lm(cfg, args.batch, args.prompt_len, args.decode_steps,
                 device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
