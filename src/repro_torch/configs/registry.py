"""Architecture registry: ``--arch <id>`` resolution for launchers, over
the architectures the port runs (``anomaly-mlp`` and the dense, moe and
vlm families). The JAX package's other ids raise ``KeyError`` naming the
roadmap item that brings them."""
from __future__ import annotations

from repro_torch.configs import (anomaly_mlp, arctic_480b, granite_34b,
                                 granite_moe_1b, internvl2_2b,
                                 phi3_mini_3_8b, qwen2_1_5b, stablelm_1_6b)
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "granite-34b": granite_34b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "internvl2-2b": internvl2_2b,
    "qwen2-1.5b": qwen2_1_5b,
    "stablelm-1.6b": stablelm_1_6b,
    "arctic-480b": arctic_480b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "anomaly-mlp": anomaly_mlp,
}

# the JAX package's other archs (ssm, hybrid, audio)
NOT_PORTED = ("rwkv6-7b", "hymba-1.5b", "whisper-tiny")

def list_archs():
    """Sorted list of the ``--arch`` ids the port runs."""
    return sorted(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        hint = ("; it is not ported yet and comes with ROADMAP.md queue 1 "
                "item 14" if name in NOT_PORTED else "")
        raise KeyError(f"unknown arch {name!r}{hint}; known: "
                       f"{sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


# long_500k: every ported arch (dense, moe, vlm, mlp) runs the
# sliding-window variant, as in the JAX package; its natively long-context
# archs (ssm, hybrid) and its skipped one (audio) are unported
SLIDING_WINDOW = 4096


def config_for_shape(name: str, shape_name: str, smoke: bool = False) -> ArchConfig:
    """Resolve the (possibly sliding-window) config variant for a shape."""
    cfg = get_config(name, smoke)
    if shape_name == "long_500k":
        cfg = cfg.replace(sliding_window=256 if smoke else SLIDING_WINDOW)
    return cfg
