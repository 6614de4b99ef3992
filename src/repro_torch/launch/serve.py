"""LM serving: a batched prefill + greedy decode loop for the dense
language models, on the card unless the caller names another device.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 2048 --decode-steps 16 --attention-impl blockwise
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --smoke --prompt-len 32 --decode-steps 16 --device cpu

The weights are random, drawn from a ``torch.Generator`` seeded ``seed``
on the serving device (the JAX package serves random weights too); the
prompt comes from ``np.random.default_rng(seed)``, so it is the JAX
package's prompt. The anomaly detector's serving engine comes with
ROADMAP.md queue 1 item 12.
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


@torch.no_grad()
def serve_lm(cfg, batch: int, prompt_len: int, decode_steps: int, seed=0, *,
             device=None, params=None):
    """Prefill a (batch, prompt_len) random prompt, then ``decode_steps``
    greedy tokens; returns the (batch, 1 + decode_steps) tokens (the
    prefill's argmax first). ``params`` replaces the random weights."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if params is None:
        params = api.init_params(torch.Generator(device=dev).manual_seed(seed),
                                 cfg, dev)
    prompt = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(batch, prompt_len)),
        device=dev)}

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prompt, cfg)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # pad the cache to prompt_len + decode_steps for the decode loop
    full = api.init_cache(cfg, batch, prompt_len + decode_steps, device=dev)
    for name in ("k", "v"):
        src = cache[name]
        full[name][:, :, :src.shape[2]] = src.to(full[name].dtype)
    full["step"] = prompt_len
    cache = full

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
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    if args.attention_impl:
        cfg = cfg.replace(attention_impl=args.attention_impl)
    if cfg.family == "mlp":
        raise NotImplementedError(
            "serving the anomaly detector (repro.serve's engine) is not "
            "ported yet; it comes with ROADMAP.md queue 1 item 12")
    serve_lm(cfg, args.batch, args.prompt_len, args.decode_steps,
             device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
