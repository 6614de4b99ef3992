"""phi3-mini-3.8b — dense RoPE SwiGLU [arXiv:2404.14219].
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense", source="arXiv:2404.14219",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512, remat=False)
