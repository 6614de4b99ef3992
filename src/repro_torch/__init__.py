"""repro_torch — the PyTorch/CUDA port of ``repro``.

Federated network-anomaly detection with adaptive client selection
(async quorum aggregation, the θ sign-alignment filter, adaptive
selection, dynamic batch sizes, Weibull checkpointing), running on an
NVIDIA H100. The JAX package ``repro`` stays the reference; the port
keeps its module layout and public names, imports neither JAX nor
``repro``, and runs on the card unless the caller passes another
``device``.

    import repro_torch
    res = repro_torch.run_experiment(repro_torch.ExperimentSpec(
        model="anomaly-mlp", strategy="ours", rounds=8))
    base = repro_torch.run_experiment(repro_torch.ExperimentSpec(
        model="anomaly-mlp", strategy="fedavg", engine="spmd", rounds=8))

``run_experiment`` opens an ``ExperimentSession``, which also streams,
checkpoints and resumes a run; ``run_sweep`` runs seeds × strategies and
gives the paper's Mann-Whitney U test.

It also serves the language models (``repro_torch.launch.serve``:
prefill and greedy decode, with the flash-attention kernel on the
blockwise attention path) and trains them federatedly on the spmd step
(``repro_torch.launch.train``; ``engine="spmd"`` with ``dataset="lm"``).
"""
from repro_torch.api import *  # noqa: F401,F403
from repro_torch.api import __all__ as _api_all
from repro_torch.convert import (control_from_jax, fl_state_from_jax,
                                 lm_params_from_jax, opt_state_from_jax,
                                 params_from_jax, sim_state_from_jax,
                                 spmd_state_from_jax)

__all__ = list(_api_all) + ["control_from_jax", "fl_state_from_jax",
                            "lm_params_from_jax", "opt_state_from_jax",
                            "params_from_jax", "sim_state_from_jax",
                            "spmd_state_from_jax"]
