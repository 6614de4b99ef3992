"""rwkv6-7b — Finch, attention-free SSM with data-dependent decay
[arXiv:2404.05892]. 32L d_model=4096 d_ff=14336 vocab=65536."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm", source="arXiv:2404.05892",
    num_layers=32, d_model=4096, d_ff=14336, vocab_size=65536,
    norm="layernorm", rwkv_head_dim=64, rwkv_lora_dim=32,
    optimizer="adafactor",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=256, d_ff=512, vocab_size=512,
    rwkv_head_dim=64, rwkv_lora_dim=8, remat=False, optimizer="adamw")
