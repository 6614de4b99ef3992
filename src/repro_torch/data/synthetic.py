"""Synthetic dataset surrogates (offline container — see DESIGN.md §10).

``make_unsw_like``  — 49-feature network-flow records, 10 classes
   (class 0 = Normal majority, 9 imbalanced attack categories), built as a
   class-conditional Gaussian mixture over correlated continuous features
   plus one-hot-ish categorical blocks — statistically analogous to
   UNSW-NB15 after the paper's feature scaling + one-hot encoding.

``make_road_like``  — automotive CAN wheel-speed windows: normal traffic is
   smooth correlated sinusoids + sensor noise; the "correlated signal
   masquerade" attack injects a constant/offset wheel-speed segment that
   breaks cross-wheel correlation (the ROAD scenario the paper evaluates).

A copy of the JAX package's ``data/synthetic.py`` (the mlp datasets),
kept byte-identical in output; the token streams of the language models
come with them (ROADMAP.md queue 1 item 14).
"""
from __future__ import annotations

import numpy as np

# class priors loosely matching UNSW-NB15's imbalance (Normal-heavy)
_UNSW_PRIORS = np.array(
    [0.55, 0.12, 0.09, 0.07, 0.05, 0.04, 0.03, 0.025, 0.02, 0.015])


def make_unsw_like(seed: int, n: int, num_features: int = 49,
                   num_classes: int = 10, universe_seed: int = 1234):
    """seed draws the SAMPLES; universe_seed fixes the class-conditional
    distribution (basis + means), so different seeds give train/eval splits
    of the SAME population — not different populations."""
    rng = np.random.default_rng(seed)
    rng_u = np.random.default_rng(universe_seed)
    priors = _UNSW_PRIORS[:num_classes] / _UNSW_PRIORS[:num_classes].sum()
    y = rng.choice(num_classes, size=n, p=priors)
    # shared correlated basis + class-specific means (harder than iid blobs)
    basis = rng_u.normal(size=(num_features, num_features)) / np.sqrt(num_features)
    means = rng_u.normal(scale=0.9, size=(num_classes, num_features))
    z = rng.normal(size=(n, num_features))
    x = (z @ basis) + means[y]
    # categorical-ish block: quantize last 9 features (proto/service/state)
    x[:, -9:] = np.sign(x[:, -9:])
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)   # paper's feature scaling
    # ~5% label noise caps attainable accuracy near the paper's ~95% regime
    flip = rng.random(n) < 0.05
    y = np.where(flip, rng.choice(num_classes, size=n, p=priors), y)
    return x.astype(np.float32), y.astype(np.int32)


def make_road_like(seed: int, n: int, window: int = 32,
                   attack_frac: float = 0.25):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < attack_frac).astype(np.int32)
    t = np.arange(window) / window
    base_speed = rng.uniform(0.2, 1.0, size=(n, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1))
    sig = base_speed * (1.0 + 0.1 * np.sin(2 * np.pi * t[None] * 2 + phase))
    sig += rng.normal(scale=0.01, size=(n, window))
    # masquerade: overwrite a segment with a flat injected wheel speed
    inj_start = rng.integers(4, window - 8, size=n)
    inj_val = rng.uniform(0.0, 1.2, size=n)
    for i in np.nonzero(y)[0]:
        sig[i, inj_start[i]:inj_start[i] + 8] = inj_val[i]
    x = (sig - sig.mean(0)) / (sig.std(0) + 1e-6)
    return x.astype(np.float32), y
