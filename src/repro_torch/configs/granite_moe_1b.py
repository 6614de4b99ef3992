"""granite-moe-1b-a400m — MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].
24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, num_experts=32, top_k=8,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, num_experts=4, top_k=2, remat=False)
