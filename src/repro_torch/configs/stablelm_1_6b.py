"""stablelm-1.6b — dense MHA [hf:stabilityai/stablelm-2-1_6b].
24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352.
StableLM-2 details kept: LayerNorm + 25% partial rotary."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense", source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352, norm="layernorm", rope_fraction=0.25,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512, remat=False)
