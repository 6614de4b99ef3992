"""Federated trainer: the spmd train step (per-client gradients and
the θ-masked selective aggregation, core/fl_step.py) on synthetic data,
the counterpart of the JAX package's ``launch/train.py``, with its flags
and its log line. Runs on the card unless ``--device cpu``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 20 --clients 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch anomaly-mlp \\
      --steps 50 --clients 8 --theta 0.65
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
      --steps 2 --clients 2 --per-client-batch 1 --seq 512
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import fl_step
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.optim import adamw as optim_mod
from repro_torch.optim import schedule


def make_batch_fn(cfg, clients: int, per_client: int, seq: int, seed=0,
                  device=None):
    """next() -> one (C, per_client, ...) batch on ``device`` (the card
    unless named): flow records for the mlp, token streams (and zero patch
    embeddings for vlm, normal frame embeddings ``enc_embeds`` for audio)
    for the language models, drawn as the JAX package's are."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if cfg.family == "mlp":
        X, y = synthetic.make_unsw_like(seed, 8192, cfg.num_features,
                                        cfg.num_classes)

        def nxt():
            idx = rng.integers(0, len(X), size=(clients, per_client))
            return {"x": torch.from_numpy(X[idx]).to(device),
                    "y": torch.from_numpy(y[idx]).to(torch.int64).to(device)}
        return nxt
    toks = seq - (cfg.num_patches if cfg.family == "vlm" else 0)

    def nxt():
        t, l = synthetic.make_lm_tokens(int(rng.integers(1 << 30)),
                                        clients * per_client, toks,
                                        cfg.vocab_size)
        batch = {
            "tokens": torch.from_numpy(t.reshape(clients, per_client, toks)
                                       ).to(torch.int64).to(device),
            "labels": torch.from_numpy(l.reshape(clients, per_client, toks)
                                       ).to(torch.int64).to(device),
        }
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (clients, per_client, cfg.num_patches, cfg.d_model),
                dtype=cfg.compute_dtype, device=device)
        if cfg.family == "audio":
            batch["enc_embeds"] = torch.as_tensor(rng.normal(size=(
                clients, per_client, cfg.encoder_seq, cfg.d_model)),
                device=device).to(cfg.compute_dtype)
        return batch
    return nxt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="anomaly-mlp",
                    choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--per-client-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--theta", type=float, default=0.65)
    ap.add_argument("--no-filter", action="store_true",
                    help="synchronous FedAvg baseline")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    # a language model's step allocates its cohort arena (gigabytes) anew
    # every step beside a state that the optimizer reallocates leaf by
    # leaf; growable cache segments keep that from fragmenting the card
    # (read when the first CUDA allocation is made, so set here)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    optimizer = optim_mod.for_config(cfg, lr=args.lr)
    sched = schedule.cosine(args.lr, warmup_steps=5, total_steps=args.steps)
    theta = None if args.no_filter else args.theta

    # a language model's weights are drawn on the device itself
    gen = torch.Generator(device=dev if cfg.family != "mlp" else "cpu")
    state = fl_step.init_state(gen.manual_seed(0), cfg, optimizer,
                               device=dev)
    step = fl_step.build_fl_train_step(cfg, optimizer, theta=theta,
                                       lr_schedule=sched)
    next_batch = make_batch_fn(cfg, args.clients, args.per_client_batch,
                               args.seq, device=dev)
    ckpt = CheckpointManager(args.ckpt_dir, total_time=600.0)

    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step(state, next_batch())
        if i % args.log_every == 0 or i == args.steps - 1:
            # per-client leaves (e.g. the (C,) transmit mask) aren't scalars
            m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
            print(f"step {i:4d} loss={m['loss']:.4f} "
                  f"accept={m['accept_rate']:.2f} "
                  f"align={m['alignment_mean']:.3f} "
                  f"sent={m['bytes_sent']/1e6:.2f}MB "
                  f"(baseline {m['bytes_baseline']/1e6:.2f}MB) "
                  f"[{time.time()-t0:.1f}s]")
        ckpt.maybe_save(state.params, now=time.time() - t0)
    print(f"done: {args.steps} rounds in {time.time()-t0:.1f}s; "
          f"checkpoints={ckpt.saves}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
