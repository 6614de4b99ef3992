"""Architecture registry: ``--arch <id>`` resolution for launchers, over
the JAX package's architectures (``repro/configs/registry.py``)."""
from __future__ import annotations

from repro_torch.configs import (anomaly_mlp, arctic_480b, granite_34b,
                                 granite_moe_1b, hymba_1_5b, internvl2_2b,
                                 phi3_mini_3_8b, qwen2_1_5b, rwkv6_7b,
                                 stablelm_1_6b, whisper_tiny)
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "rwkv6-7b": rwkv6_7b,
    "hymba-1.5b": hymba_1_5b,
    "granite-34b": granite_34b,
    "whisper-tiny": whisper_tiny,
    "granite-moe-1b-a400m": granite_moe_1b,
    "internvl2-2b": internvl2_2b,
    "qwen2-1.5b": qwen2_1_5b,
    "stablelm-1.6b": stablelm_1_6b,
    "arctic-480b": arctic_480b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "anomaly-mlp": anomaly_mlp,
}


# every architecture but the detector: the dry run's plan
ASSIGNED_ARCHS = [k for k in _MODULES if k != "anomaly-mlp"]


def list_archs():
    """Sorted list of the ``--arch`` ids the port runs."""
    return sorted(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False):
    """{arch: config} over ``ASSIGNED_ARCHS``."""
    return {name: get_config(name, smoke) for name in ASSIGNED_ARCHS}


# long_500k applicability, as in the JAX package: the ssm and hybrid archs
# run natively (hybrid's attention heads on a sliding window), dense, moe,
# vlm and mlp run the sliding-window variant, and whisper (an audio
# encoder-decoder) skips the shape
LONG_CTX_NATIVE = {"rwkv6-7b", "hymba-1.5b"}
LONG_CTX_SKIP = {"whisper-tiny"}
SLIDING_WINDOW = 4096


def config_for_shape(name: str, shape_name: str, smoke: bool = False) -> ArchConfig:
    """Resolve the (possibly sliding-window) config variant for a shape."""
    cfg = get_config(name, smoke)
    if shape_name == "long_500k":
        if name in LONG_CTX_SKIP:
            raise ValueError(f"{name} skips long_500k")
        w = 256 if smoke else SLIDING_WINDOW
        if name not in LONG_CTX_NATIVE and cfg.family != "ssm":
            cfg = cfg.replace(sliding_window=w)
        if cfg.family == "hybrid":
            cfg = cfg.replace(sliding_window=w)
    return cfg
