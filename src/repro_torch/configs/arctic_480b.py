"""arctic-480b — MoE 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base].
35L d_model=7168 56H (GQA kv=8) d_ff=4864/expert vocab=32000.

The JAX config's ``expert_parallel`` and ``client_axes`` come with
sharding, which reads them (ROADMAP.md queue 1 item 14g)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe", source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, num_experts=128, top_k=2,
    moe_dense_residual=True, optimizer="adafactor",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, num_experts=4, top_k=2,
    remat=False, optimizer="adamw")
