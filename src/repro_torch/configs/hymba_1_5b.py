"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer
[arXiv:2411.13676]. 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid", source="arXiv:2411.13676",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001, ssm_state=16,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=320, num_heads=5, num_kv_heads=1, head_dim=64,
    d_ff=512, vocab_size=512, ssm_state=8, remat=False)
