"""arctic-480b — MoE 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base].
35L d_model=7168 56H (GQA kv=8) d_ff=4864/expert vocab=32000.

Distribution: expert_parallel=True — the 468B expert pool cannot be
replicated per FL client; expert tensors shard over ("data","model")
jointly and FL clients live on the "pod" axis only."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe", source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, num_experts=128, top_k=2,
    moe_dense_residual=True, expert_parallel=True,
    client_axes=("pod",), optimizer="adafactor",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, num_experts=4, top_k=2,
    expert_parallel=False, client_axes=("pod", "data"),
    remat=False, optimizer="adamw")
