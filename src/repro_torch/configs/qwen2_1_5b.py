"""qwen2-1.5b — dense GQA with QKV bias [arXiv:2407.10671].
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense", source="arXiv:2407.10671",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=192, num_heads=6, num_kv_heads=2,
    d_ff=384, vocab_size=512, remat=False)
